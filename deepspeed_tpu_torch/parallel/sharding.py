"""ZeRO + tensor-parallel sharding rules: logical param axes → mesh axes.

The port's copy of ``deepspeed_tpu/parallel/sharding.py``. Each ZeRO stage
is a sharding rule applied to the param, gradient and optimizer-state
trees:

- stage 1: optimizer state sharded over the ``fsdp`` axis (the update runs
  on a rank's block and the new params are all-gathered back);
- stage 2: + gradients reduce-scattered onto the ``fsdp`` axis;
- stage 3: + parameters stored sharded, gathered a layer at a time at use.

Model code annotates each param with *logical* axis names; a rules table
maps them to mesh axes, and ZeRO-3 shards one remaining dim over ``fsdp``,
preferring the ``embed`` dim (``_FSDP_PREFERRED``), else the largest.

A spec here is a plain tuple with one entry per dim: ``None``, an axis
name, or a tuple of names (the first major), equal entry for entry to the
JAX ``PartitionSpec``. Where the JAX package hands XLA a ``NamedSharding``,
the engine cuts each rank's block with :func:`local_slice`: rank ``r``
holds exactly the block of JAX device ``r``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

from . import topology as topo

# ---------------------------------------------------------------- logical axes
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "vocab": None,
    "embed": None,
    "mlp": topo.TENSOR_AXIS,
    "heads": topo.TENSOR_AXIS,
    "kv_heads": topo.TENSOR_AXIS,
    "head_dim": None,
    "layers": topo.PIPE_AXIS,
    "expert": topo.EXPERT_AXIS,
    "seq": topo.SEQUENCE_AXIS,
    "batch": topo.DATA_AXIS,
}


# A serving engine runs every layer of every row on each rank of a pipe or
# sequence axis (the JAX serving engines do nothing axis-specific there):
# it cuts its blocks over the other axes only
SERVING_RULES: Dict[str, Optional[str]] = dict(DEFAULT_RULES, layers=None,
                                               seq=None)


class ParamSpec(tuple):
    """A tuple of logical axis names (or None) — one per array dim."""
    __slots__ = ()


def spec(*names) -> ParamSpec:
    return ParamSpec(names)


def logical_to_mesh_axes(logical: Sequence[Optional[str]],
                         rules: Optional[Dict[str, Optional[str]]] = None
                         ) -> list:
    rules = rules or DEFAULT_RULES
    return [rules.get(name) if name is not None else None for name in logical]


# Logical dims preferred for the fsdp shard, in order (MaxText's choice:
# embed → fsdp, vocab → tensor).
_FSDP_PREFERRED = ("embed",)


def _assign_fsdp(mesh_axes: list, shape: Tuple[int, ...], mesh,
                 logical: Optional[Sequence[Optional[str]]] = None,
                 fsdp_axes: Tuple[str, ...] = (topo.FSDP_AXIS,)) -> list:
    """Shard one not-yet-sharded dim over the fsdp axis group (must
    divide): a dim whose logical name is in ``_FSDP_PREFERRED``, else the
    largest eligible dim. ``fsdp_axes`` longer than one (``('fsdp',
    'data')``) shards the dim over the product: hpZ's primary partition."""
    axes = tuple(a for a in fsdp_axes if mesh.shape.get(a, 1) > 1)
    size = math.prod(mesh.shape.get(a, 1) for a in axes)
    if size <= 1:
        return mesh_axes
    entry = axes if len(axes) > 1 else axes[0]
    logical = logical or [None] * len(shape)
    for name in _FSDP_PREFERRED:
        for i, (ax, dim, lname) in enumerate(zip(mesh_axes, shape, logical)):
            if ax is None and lname == name and dim % size == 0:
                mesh_axes[i] = entry
                return mesh_axes
    best, best_size = None, 0
    for i, (ax, dim) in enumerate(zip(mesh_axes, shape)):
        if ax is None and dim % size == 0 and dim > best_size:
            best, best_size = i, dim
    if best is not None:
        mesh_axes[best] = entry
    return mesh_axes


def shard_spec_for(shape: Tuple[int, ...],
                   logical: Optional[Sequence[Optional[str]]],
                   mesh: topo.MeshTopology,
                   zero_stage: int = 0,
                   rules: Optional[Dict[str, Optional[str]]] = None,
                   force_fsdp: bool = False,
                   fsdp_axes: Tuple[str, ...] = (topo.FSDP_AXIS,)) -> tuple:
    """The spec of one parameter. ``force_fsdp`` is for optimizer state
    and gradients under stages 1-2, where the param stays replicated."""
    if logical is None:
        logical = [None] * len(shape)
    mesh_axes = logical_to_mesh_axes(logical, rules)
    for i, ax in enumerate(mesh_axes):
        if ax is not None:
            n = mesh.shape.get(ax, 1)
            if n <= 1 or shape[i] % n != 0:
                mesh_axes[i] = None
    if zero_stage >= 3 or force_fsdp:
        mesh_axes = _assign_fsdp(mesh_axes, shape, mesh, logical, fsdp_axes)
    return tuple(mesh_axes)


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _map(fn, tree, spec_tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v, None if spec_tree is None else spec_tree[k])
                for k, v in tree.items()}
    return fn(tree, spec_tree)


def tree_shardings(params_or_shapes, spec_tree, mesh: topo.MeshTopology,
                   zero_stage: int = 0, rules=None, force_fsdp: bool = False,
                   fsdp_axes: Tuple[str, ...] = (topo.FSDP_AXIS,)):
    """The tree of specs of a param (or shape) tree; ``spec_tree``
    mirrors it with ParamSpec leaves (or is None)."""
    return _map(lambda leaf, lspec: shard_spec_for(
        _shape_of(leaf), lspec, mesh, zero_stage, rules, force_fsdp,
        fsdp_axes), params_or_shapes, spec_tree)


class ZeroShardingPlan:
    """The sharding plan of a train state under a ZeRO stage: specs for
    params, grads (the accumulator), optimizer moments and the batch."""

    def __init__(self, topology: topo.MeshTopology, zero_stage: int,
                 spec_tree=None, rules=None, hpz: bool = False):
        self.topo = topology
        self.mesh = topology
        self.stage = zero_stage
        self.spec_tree = spec_tree
        self.rules = rules
        # ZeRO++ hpZ: moments over fsdp×data, params and grads over fsdp
        self.hpz = hpz

    def params(self, shapes):
        return tree_shardings(shapes, self.spec_tree, self.mesh, self.stage,
                              self.rules)

    def grads(self, shapes):
        return tree_shardings(shapes, self.spec_tree, self.mesh, self.stage,
                              self.rules, force_fsdp=self.stage >= 2)

    def opt_state(self, moment_shapes):
        """``moment_shapes``: {"m": param-shaped tree, ...}."""
        spec_tree = (None if self.spec_tree is None
                     else {k: self.spec_tree for k in moment_shapes})
        axes = ((topo.FSDP_AXIS, topo.DATA_AXIS) if self.hpz
                else (topo.FSDP_AXIS,))
        return tree_shardings(moment_shapes, spec_tree, self.mesh, self.stage,
                              self.rules, force_fsdp=self.stage >= 1,
                              fsdp_axes=axes)

    def batch(self):
        return (topo.BATCH_AXES,)

    def replicated(self):
        return ()


# ---------------------------------------------------------- a rank's block

def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry's axes: () for None, one name, or the tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec_: tuple) -> Tuple[str, ...]:
    """Every axis a spec shards over, in dim order."""
    return tuple(a for e in spec_ for a in entry_axes(e))


def local_slice(shape, spec_: tuple, topology: topo.MeshTopology,
                rank: int) -> Tuple[slice, ...]:
    """The block of a ``shape`` leaf laid out by ``spec_`` that rank
    ``rank`` holds (JAX device ``rank``'s ``addressable_shards`` index)."""
    out = []
    for d, dim in enumerate(shape):
        axes = entry_axes(spec_[d]) if d < len(spec_) else ()
        n = topology.axis_size_of(axes)
        size = dim // n
        i = topology.flat_index(rank, axes)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def rank_block(leaf, sl: Tuple[slice, ...], device):
    """``leaf[sl]`` as a contiguous tensor on ``device``: the kernels'
    stride contracts refuse a strided view. Only the block is copied."""
    return leaf[sl].to(device).contiguous()


def place_blocks(tree, specs, topology: topo.MeshTopology, rank: int,
                 device, cut=rank_block):
    """Rank ``rank``'s blocks of a whole param tree (tensors on the host or
    on ``device``) laid out by the spec tree ``specs``:
    ``cut(leaf, local_slice(...), device)`` for each leaf, by default the
    block itself (:func:`rank_block`). The whole tree is never copied to
    ``device``."""
    if isinstance(tree, dict):
        return {k: place_blocks(v, specs[k], topology, rank, device, cut)
                for k, v in tree.items()}
    return cut(tree, local_slice(tuple(tree.shape), specs, topology, rank),
               device)


def block_shape(shape, spec_: tuple, topology: topo.MeshTopology):
    """The shape of every rank's block."""
    return tuple(dim // topology.axis_size_of(
        entry_axes(spec_[d]) if d < len(spec_) else ())
        for d, dim in enumerate(shape))


def is_sharded(spec_: tuple, topology: topo.MeshTopology) -> bool:
    return any(topology.axis_size(a) > 1 for a in spec_axes(spec_))


def is_replica_zero(spec_: tuple, topology: topo.MeshTopology,
                    rank: int) -> bool:
    """Whether ``rank`` is the first holder of its block: index 0 along
    every axis the spec does not shard over (JAX's ``replica_id == 0``)."""
    used = set(spec_axes(spec_))
    c = topology.coords(rank)
    return all(c[a] == 0 for a in topology.axis_order if a not in used)
