"""deepspeed_tpu_torch — the PyTorch and CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, with the same module paths, config
surfaces and param-tree layout, so one set of weights loads into both. Plain
tensor code is PyTorch; every kernel that the JAX package wrote in Pallas for
the TPU is a kernel written by hand for Hopper (``ops/csrc/*.cu``), built with
``nvcc`` at first use. The package never imports ``jax`` or ``deepspeed_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA and no explicit device they raise instead of dropping to the CPU.

``initialize`` creates the training engine::

    engine, optimizer, loader, scheduler = deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg), config={...}, training_data=data)
    loss = engine.train_batch()

``init_inference`` creates the v1 inference engine::

    engine = deepspeed_tpu_torch.init_inference(
        "mistral-7b", config={"dtype": "bf16", "quant": {"enabled": True,
                                                          "bits": 8}},
        params=params)
    out = engine.generate([[1, 2, 3], [4, 5]], max_new_tokens=32)
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` as given, else
    ``cuda``. Never the CPU unless the caller asked for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def not_ported(feature: str, roadmap_item: str) -> NotImplementedError:
    """The error every not-yet-ported option raises (never ignored)."""
    return NotImplementedError(
        f"{feature} is not ported to deepspeed_tpu_torch yet "
        f"(ROADMAP.md {roadmap_item})")


def initialize(args=None,
               model=None,
               optimizer=None,
               model_parameters=None,
               training_data=None,
               lr_scheduler=None,
               distributed_port=29500,
               mesh=None,
               dist_init_required=None,
               collate_fn=None,
               config=None,
               config_params=None,
               rng=None,
               device: DeviceLike = None):
    """Create the training engine; the counterpart of
    ``deepspeed_tpu.initialize``.

    ``model`` is a ``models.transformer.CausalLM`` or any object with
    ``init(generator, device=...) -> params`` and ``loss(params, batch, rng)
    -> scalar``. ``model_parameters`` hands over a starting param tree
    (nested dicts of numpy arrays or tensors, copied into fp32 master
    weights); with none the engine calls ``model.init`` with a
    ``torch.Generator`` seeded from ``config.seed`` (or ``rng``, an int).
    Returns ``(engine, optimizer, dataloader, lr_scheduler)``; the engine
    owns all four. Runs on ``cuda`` unless ``device="cpu"`` is passed.
    """
    from .runtime.config import OffloadDeviceEnum, load_config
    from .runtime.engine import DeepSpeedTpuEngine

    config = config if config is not None else config_params
    cfg_obj = load_config(config)
    op = cfg_obj.zero_optimization.offload_param
    if op is not None and op.device != OffloadDeviceEnum.none:
        raise not_ported("offload_param (ZeRO-Infinity parameter streaming)",
                         "queue 1 item 15")
    if cfg_obj.hybrid_engine.enabled:
        raise not_ported("hybrid_engine", "queue 1 item 17")
    engine = DeepSpeedTpuEngine(args=args,
                                model=model,
                                optimizer=optimizer,
                                model_parameters=model_parameters,
                                training_data=training_data,
                                lr_scheduler=lr_scheduler,
                                mesh=mesh,
                                collate_fn=collate_fn,
                                config=cfg_obj if config is not None
                                else None,
                                rng=rng,
                                device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def init_inference(model=None, config=None, **kwargs):
    """Create the v1 inference engine; the counterpart of
    ``deepspeed_tpu.init_inference``. ``kwargs`` are config keys, and
    ``params=``, ``mesh=`` and ``device=`` (``cuda`` unless ``"cpu"`` is
    passed) as ``inference.InferenceEngine`` takes them."""
    from .inference.engine import InferenceEngine

    return InferenceEngine(model, config=config, **kwargs)


__all__ = ["initialize", "init_inference", "resolve_device", "not_ported",
           "__version__"]
