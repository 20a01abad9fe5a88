"""``deepspeed_tpu_torch.comm`` — the module-level collective API, on
``torch.distributed`` (the port of ``deepspeed_tpu.comm``)."""

from .comm import (
    ReduceOp,
    all_gather,
    all_gather_into_tensor,
    all_reduce,
    all_to_all_single,
    axis_index,
    barrier,
    broadcast,
    comms_logger,
    destroy_distributed,
    get_local_rank,
    get_rank,
    get_world_size,
    has_all_gather_into_tensor,
    has_coalescing_manager,
    has_reduce_scatter_tensor,
    inference_all_reduce,
    init_distributed,
    is_initialized,
    log_summary,
    ppermute,
    recv,
    reduce,
    reduce_scatter_tensor,
    send,
)

__all__ = [n for n in dir() if not n.startswith("_")]
