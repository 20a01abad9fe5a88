"""Activation checkpointing API.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing.py``, which
keeps the reference's call surface over ``jax.checkpoint``. Here the
mechanism is ``torch.utils.checkpoint`` (``use_reentrant=False``): the
function's forward runs once without saving its intermediates, and the
backward runs it again to recompute what the chosen policy did not keep.

- ``policy=None`` and ``"nothing_saveable"`` recompute the whole function.
- ``"dots_saveable"`` keeps the outputs of the matrix products (``aten.mm``,
  ``addmm``, ``bmm``, ``baddbmm``), as ``jax.checkpoint_policies.
  dots_saveable`` keeps those of ``dot_general``, and recomputes the rest,
  through ``create_selective_checkpoint_contexts``. The policy sees the
  operations PyTorch dispatches; a hand-written kernel launched through
  ``ctypes`` (the flash attention kernels) is invisible to it and is
  recomputed under every policy.
- Any other name raises ``ValueError``, as in the JAX package.

Dropout masks replay under recomputation because the checkpoint restores
the RNG state it saw (``preserve_rng_state``), which is the job of the
reference's ``CudaRNGStatesTracker``: :func:`get_rng_tracker` returns None
and :func:`model_parallel_cuda_manual_seed` has nothing to seed, as in the
JAX package. ``configure`` records the options and the probes answer from
them.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..utils.logging import logger

_config = {
    "partition_activations": False,
    "contiguous_memory_optimization": False,
    "cpu_checkpointing": False,
    "num_checkpoints": None,
    "synchronize_checkpoint_boundary": False,
    "profile": False,
}

POLICIES = (None, "dots_saveable", "nothing_saveable")


def _dots_saveable():
    import torch
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    aten = torch.ops.aten
    dots = {aten.mm.default, aten.addmm.default, aten.bmm.default,
            aten.baddbmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in dots \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def checkpoint_kwargs(policy: Optional[str]) -> dict:
    """The keyword arguments of ``torch.utils.checkpoint.checkpoint`` for a
    ``jax.checkpoint`` policy name; an unknown name raises ValueError."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {"use_reentrant": False}
    if policy == "dots_saveable":
        kw["context_fn"] = _dots_saveable
    return kw


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Record the checkpointing options (the reference's ``configure``);
    they change no recomputation here."""
    if deepspeed_config is not None:
        ac = getattr(deepspeed_config, "activation_checkpointing", None)
        if ac is not None:
            _config["partition_activations"] = ac.partition_activations
            _config["contiguous_memory_optimization"] = \
                ac.contiguous_memory_optimization
            _config["cpu_checkpointing"] = ac.cpu_checkpointing
            _config["num_checkpoints"] = ac.number_checkpoints
            _config["profile"] = ac.profile
    for key, val in (("partition_activations", partition_activations),
                     ("contiguous_memory_optimization",
                      contiguous_checkpointing),
                     ("num_checkpoints", num_checkpoints),
                     ("cpu_checkpointing", checkpoint_in_cpu),
                     ("synchronize_checkpoint_boundary", synchronize),
                     ("profile", profile)):
        if val is not None:
            _config[key] = val
    if _config["cpu_checkpointing"]:
        logger.warning(
            "cpu_checkpointing: the port keeps saved activations on the "
            "device; the model config's remat_policy chooses what is kept")


def is_configured() -> bool:
    return True     # torch.utils.checkpoint needs no global setup


def partition_activations_in_checkpoint(partition: bool) -> None:
    _config["partition_activations"] = bool(partition)


def checkpoint(function: Callable, *args, policy: Optional[str] = None
               ) -> Any:
    """Run ``function(*args)`` keeping only its inputs (and what
    ``policy`` saves); the backward recomputes the rest."""
    from torch.utils.checkpoint import checkpoint as _checkpoint

    return _checkpoint(function, *args, **checkpoint_kwargs(policy))


class CheckpointFunction:
    """The reference's ``CheckpointFunction.apply`` call surface."""

    @staticmethod
    def apply(function, *args):
        return checkpoint(function, *args)


def get_rng_tracker():
    """None: the checkpoint replays the RNG state, so dropout needs no
    tracker (module docstring)."""
    return None


def model_parallel_cuda_manual_seed(seed: int) -> None:
    """The reference's seeding hook: nothing to seed (module docstring)."""
