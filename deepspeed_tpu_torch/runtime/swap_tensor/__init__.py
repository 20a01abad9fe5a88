"""Host-memory and file swapping of tensors (counterpart of
``deepspeed_tpu/runtime/swap_tensor``)."""

from .async_swapper import AsyncTensorSwapper, OptimizerStateSwapper  # noqa: F401
