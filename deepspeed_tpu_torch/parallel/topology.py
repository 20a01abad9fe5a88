"""Device-mesh topology: the process-group registry, on torch.distributed.

Counterpart of ``deepspeed_tpu/parallel/topology.py``. Every parallelism
form is a named axis of one grid of ranks, and every "process group" is an
axis (or a tuple of axes). The axis constants, the sizes' ``-1`` wildcard,
``axis_order`` and the errors are the JAX package's.

Where the JAX package reshapes ``jax.devices()`` into its mesh, the port
reshapes the process ranks: ``np.arange(world).reshape(sizes in
axis_order)``, so rank ``r`` holds the blocks JAX device ``r`` holds. The
grid and a rank's coordinates are pure (``rank_grid``, ``coords``), so
layouts can be compared without processes. Once a process group is up,
:meth:`MeshTopology.device_mesh` wraps the grid in a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
``axis_order``; ``comm`` takes each axis's process group from it.

Axes (outermost to innermost by default):

- ``pipe``     pipeline-parallel stages
- ``data``     pure data parallel (params replicated)
- ``fsdp``     the ZeRO parameter/optimizer sharding axis
- ``sequence`` Ulysses sequence parallelism
- ``expert``   MoE expert parallelism
- ``tensor``   megatron-style tensor parallelism
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SEQUENCE_AXIS = "sequence"
EXPERT_AXIS = "expert"
TENSOR_AXIS = "tensor"

ALL_AXES = (PIPE_AXIS, DATA_AXIS, FSDP_AXIS, SEQUENCE_AXIS, EXPERT_AXIS,
            TENSOR_AXIS)

# Axes over which gradients are averaged (data parallel replicas).
GRAD_REDUCE_AXES = (DATA_AXIS, FSDP_AXIS)
# Axes over which a batch is split.
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)


def _process_world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class MeshTopology:
    """A grid of ranks with named axes, and the accessors of the
    reference's groups API."""

    def __init__(self, shape: Dict[str, int], axis_order: Tuple[str, ...]):
        self.axis_order = tuple(axis_order)
        self.shape = {a: int(shape[a]) for a in self.axis_order}
        self._device_mesh = None

    # -- factory ----------------------------------------------------------
    @classmethod
    def build(cls, mesh_config=None, world_size: Optional[int] = None,
              **axis_sizes) -> "MeshTopology":
        """Build from a MeshConfig (``runtime/config.py``) or explicit axis
        sizes over ``world_size`` ranks (default: the process group's
        world, 1 without one).

        One axis may be -1 ("all remaining ranks"); by default that is the
        data axis.
        """
        n = _process_world() if world_size is None else int(world_size)
        sizes = {a: 1 for a in ALL_AXES}
        sizes[DATA_AXIS] = -1  # default: data axis soaks up all ranks
        order = list(ALL_AXES)
        if mesh_config is not None:
            for a in ALL_AXES:
                sizes[a] = getattr(mesh_config, a)
            order = list(mesh_config.axis_order)
        sizes.update(axis_sizes)

        wildcard = [a for a in ALL_AXES if sizes[a] == -1]
        if len(wildcard) > 1:
            raise ValueError(f"Only one mesh axis may be -1, got {wildcard}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcard:
            if n % fixed != 0:
                raise ValueError(
                    f"Cannot infer {wildcard[0]} axis: {n} devices not "
                    f"divisible by {fixed}")
            sizes[wildcard[0]] = n // fixed
        elif fixed != n:
            raise ValueError(
                f"Mesh sizes {sizes} product {fixed} != device count {n}")
        return cls({a: sizes[a] for a in order}, tuple(order))

    # -- the grid ---------------------------------------------------------
    def rank_grid(self) -> np.ndarray:
        """Ranks laid out as JAX lays out its devices: ``arange(world)``
        reshaped to the axis sizes in ``axis_order``."""
        return np.arange(self.world_size).reshape(
            [self.shape[a] for a in self.axis_order])

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index along every axis."""
        idx = np.unravel_index(int(rank),
                               [self.shape[a] for a in self.axis_order])
        return {a: int(i) for a, i in zip(self.axis_order, idx)}

    def flat_index(self, rank: int, axes) -> int:
        """Rank ``rank``'s index in the group of ``axes`` (the first axis
        major, as a PartitionSpec entry orders a tuple of axes)."""
        c = self.coords(rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def group_ranks(self, axes) -> list:
        """Every group of ``axes``: lists of ranks that differ only along
        ``axes``, each ordered by :meth:`flat_index`."""
        axes = tuple(axes)
        others = [a for a in self.axis_order if a not in axes]
        grid = self.rank_grid().transpose(
            [self.axis_order.index(a) for a in others + list(axes)])
        return [list(map(int, g))
                for g in grid.reshape(-1, self.axis_size_of(axes))]

    def axis_size_of(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def device_mesh(self, device_type: str = "cpu"):
        """The grid as a ``DeviceMesh`` with ``mesh_dim_names`` =
        ``axis_order`` (built once, when a process group is up; every rank
        must make the first call at the same point)."""
        if self._device_mesh is None:
            import torch
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(
                device_type, torch.from_numpy(self.rank_grid().copy()),
                mesh_dim_names=self.axis_order)
        return self._device_mesh

    # -- axis info --------------------------------------------------------
    @property
    def axis_names(self) -> tuple:
        return self.axis_order

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def world_size(self) -> int:
        return math.prod(self.shape.values())

    # -- reference-compatible accessors ----------------------------------
    def get_data_parallel_world_size(self) -> int:
        """The DP world includes the fsdp (ZeRO) axis: a batch is split
        over both."""
        return self.axis_size(DATA_AXIS) * self.axis_size(FSDP_AXIS)

    def get_model_parallel_world_size(self) -> int:
        return self.axis_size(TENSOR_AXIS)

    def get_pipe_parallel_world_size(self) -> int:
        return self.axis_size(PIPE_AXIS)

    def get_expert_parallel_world_size(self) -> int:
        return self.axis_size(EXPERT_AXIS)

    def get_sequence_parallel_world_size(self) -> int:
        return self.axis_size(SEQUENCE_AXIS)

    def get_sequence_data_parallel_world_size(self) -> int:
        return (self.get_sequence_parallel_world_size()
                * self.get_data_parallel_world_size())

    def __repr__(self) -> str:
        return f"MeshTopology({self.shape})"


def mesh_topology(mesh) -> MeshTopology:
    """An engine's ``mesh`` argument as a topology over the process world:
    a ``MeshTopology`` as it is, a mesh config (``runtime/config.py``
    ``MeshConfig``) or a dict of its axis sizes built over the world;
    another type raises ``NotImplementedError``, and a grid of another size
    than the world ``ValueError``."""
    from .. import not_ported
    from ..runtime.config import MeshConfig

    if isinstance(mesh, MeshTopology):
        t = mesh
    elif isinstance(mesh, (MeshConfig, dict)):
        t = MeshTopology.build(
            mesh if isinstance(mesh, MeshConfig) else MeshConfig(**mesh))
    else:
        raise not_ported(f"a mesh given as {type(mesh).__name__} (the port "
                         "takes a MeshTopology, a mesh config or a dict of "
                         "axis sizes)", "queue 1 item 14")
    world = _process_world()
    if t.world_size != world:
        raise ValueError(f"Mesh sizes {t.shape} product {t.world_size} != "
                         f"device count {world}")
    return t


# ------------------------------------------------------------------ registry
_topology: Optional[MeshTopology] = None


def set_topology(topo: MeshTopology) -> None:
    global _topology
    _topology = topo


def get_topology() -> MeshTopology:
    global _topology
    if _topology is None:
        _topology = MeshTopology.build()
    return _topology


def has_topology() -> bool:
    return _topology is not None


def reset_topology() -> None:
    global _topology
    _topology = None
