"""Mesh topology, ZeRO sharding plans and ZeRO++ collectives (the port of
``deepspeed_tpu.parallel``)."""

from .topology import (
    ALL_AXES,
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    PIPE_AXIS,
    SEQUENCE_AXIS,
    TENSOR_AXIS,
    MeshTopology,
    get_topology,
    has_topology,
    reset_topology,
    set_topology,
)

__all__ = [n for n in dir() if not n.startswith("_")]
