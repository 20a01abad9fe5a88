"""deepspeed_tpu_torch — the PyTorch and CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, with the same module paths, config
surfaces and param-tree layout, so one set of weights loads into both. Plain
tensor code is PyTorch; every kernel that the JAX package wrote in Pallas for
the TPU is a kernel written by hand for Hopper (``ops/csrc/*.cu``), built with
``nvcc`` at first use. The package never imports ``jax`` or ``deepspeed_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA and no explicit device they raise instead of dropping to the CPU.
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


__all__ = ["resolve_device", "not_ported", "__version__"]
