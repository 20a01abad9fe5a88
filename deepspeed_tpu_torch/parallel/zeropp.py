"""ZeRO-3's parameter gather and ZeRO++'s quantized collectives (qwZ, qgZ).

The port of ``deepspeed_tpu/parallel/zeropp.py``:

- qwZ: the stage-3 weight all-gather carries int8 (or packed int4) codes
  and fp32 block scales: ``quantize_blockwise`` (the quantize kernel on the
  card), all-gather of codes and scales, ``dequantize_blockwise`` (the
  dequantize kernel);
- qgZ: the backward's gradient reduce-scatter becomes quantize, all-to-all,
  dequantize and sum (the all_to_all_quant_reduce pattern);
- hpZ rides the sharding plan (``ZeroShardingPlan.opt_state``).

Under XLA the stage-3 gather is implicit and this module only quantizes it.
In the port every stage-3 gather is explicit: :func:`quantized_all_gather`
with ``qw_bits=None`` is the plain all-gather whose backward reduce-scatters,
and the engine installs :func:`make_quantized_gather_transform` as the
model's ``layer_transform``/``global_transform`` for plain stage 3 as for
ZeRO++.

A gathered weight is freed after its use: inside :func:`free_gathered`
(the engine's micro step at stage 3) a tensor that autograd saves for the
backward and that is, or views, a gathered weight is saved as a recipe,
and the backward gathers it again (the reference's re-fetch of released
parameters). So the forward holds one layer's gathered weights at a time.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, Optional

import torch

from .. import comm as dist
from ..ops.quantizer import (choose_block, dequantize_blockwise, pack_int4,
                             quantize_blockwise, unpack_int4)
from . import topology as topo
from .sharding import entry_axes


def _gather_dim(spec: tuple, axis: str) -> Optional[int]:
    """Index of the dim sharded over ``axis`` in a spec (None if the leaf
    is not sharded over it)."""
    for i, entry in enumerate(spec):
        if axis in entry_axes(entry):
            return i
    return None


def _gather(x, axis_name, gdim, qw_bits):
    """All-gather ``x`` along ``gdim`` over ``axis_name``, int-quantized on
    the wire when ``qw_bits`` is set; fp32 out for a quantized gather."""
    if qw_bits is None:
        return dist.all_gather_into_tensor(None, x, axis_name, axis=gdim)
    block = choose_block(x.shape[-1])
    q, s = quantize_blockwise(x.contiguous(), bits=qw_bits, block=block)
    if qw_bits == 4 and q.shape[-1] % 2 == 0:
        payload = dist.all_gather_into_tensor(None, pack_int4(q), axis_name,
                                              axis=gdim)
        q_full = unpack_int4(payload)
    else:
        q_full = dist.all_gather_into_tensor(None, q, axis_name, axis=gdim)
    # s has x's rank (last dim = n_blocks), so the gather dim carries over
    s_full = dist.all_gather_into_tensor(None, s, axis_name, axis=gdim)
    return dequantize_blockwise(q_full, s_full, block=block,
                                dtype=torch.float32)


def _reduce(g, axis_name, gdim, qg_bits):
    """The gradient of the gather: this rank's block of the sum of every
    rank's ``g``; quantize → all-to-all → dequantize → sum under qgZ."""
    if qg_bits is None:
        return dist.reduce_scatter_tensor(None, g, dist.ReduceOp.SUM,
                                          axis_name, scatter_dim=gdim)
    world = dist.get_world_size(axis_name)
    # one chunk per owner, stacked [world, ...]: slice j goes to rank j,
    # the received slices stack back on dim 0 (one partial a peer)
    chunks = torch.stack(torch.chunk(g, world, dim=gdim), dim=0).contiguous()
    block = choose_block(chunks.shape[-1])
    q, s = quantize_blockwise(chunks, bits=qg_bits, block=block)
    if qg_bits == 4 and q.shape[-1] % 2 == 0:
        q = unpack_int4(dist.all_to_all_single(None, pack_int4(q),
                                               axis_name))
    else:
        q = dist.all_to_all_single(None, q, axis_name)
    s = dist.all_to_all_single(None, s, axis_name)
    parts = dequantize_blockwise(q, s, block=block, dtype=torch.float32)
    return torch.sum(parts, dim=0).to(g.dtype)


class _QuantizedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, gdim, qw_bits, qg_bits, out_dtype):
        ctx.meta = (axis_name, gdim, qg_bits, x.dtype)
        return _gather(x, axis_name, gdim, qw_bits).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        axis_name, gdim, qg_bits, dtype = ctx.meta
        grad = _reduce(g.to(dtype).contiguous(), axis_name, gdim, qg_bits)
        return grad, None, None, None, None, None


def quantized_all_gather(x, axis_name: str, gdim: int, *,
                         qw_bits: Optional[int], qg_bits: Optional[int],
                         out_dtype=None):
    """All-gather ``x`` (this rank's block) over ``axis_name`` along dim
    ``gdim``, int-quantized on the wire when ``qw_bits`` is set, as
    ``out_dtype`` (default ``x``'s). The backward is the (optionally
    quantized) gradient reduce-scatter, in ``x``'s dtype."""
    return _QuantizedGather.apply(x, axis_name, gdim, qw_bits, qg_bits,
                                  out_dtype or x.dtype)


# ------------------------------------------------- freeing gathered weights

_SCOPE = threading.local()


class _Recipe:
    """How to rebuild a saved tensor that views a gathered weight."""
    __slots__ = ("regather", "shape", "stride", "offset")

    def __init__(self, regather, t):
        self.regather = regather
        self.shape, self.stride = t.shape, t.stride()
        self.offset = t.storage_offset()


@contextlib.contextmanager
def free_gathered():
    """Within this block, gathered weights are not kept for the backward:
    a saved tensor that shares a live gathered weight's storage is saved as
    a :class:`_Recipe`, and unpacking it gathers the weight again. The
    registry holds weak references only, so a freed weight's storage can
    never be mistaken for another's."""
    registry: Dict[int, Any] = {}
    prev = getattr(_SCOPE, "registry", None)
    _SCOPE.registry = registry

    def pack(t):
        if registry and t.numel():
            entry = registry.get(t.untyped_storage().data_ptr())
            if entry is not None:
                ref, regather = entry
                full = ref()
                if full is not None and full.dtype == t.dtype:
                    return _Recipe(regather, t)
        return t

    def unpack(x):
        if isinstance(x, _Recipe):
            return x.regather().as_strided(x.shape, x.stride, x.offset)
        return x

    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        _SCOPE.registry = prev


def _register(full, regather) -> None:
    registry = getattr(_SCOPE, "registry", None)
    if registry is not None and full.numel():
        registry[full.untyped_storage().data_ptr()] = (weakref.ref(full),
                                                       regather)


class GatherTransform:
    """``transform(dict of blocks) -> dict of gathered leaves``: each leaf
    sharded over ``axis`` is gathered with :func:`quantized_all_gather`;
    the rest pass through. ``gathers`` and ``regathers`` count the leaves
    gathered in forwards and again in backwards."""

    def __init__(self, gathered: Dict[str, int], axis: str,
                 qw_bits: Optional[int], qg_bits: Optional[int],
                 out_dtypes: Dict[str, Any]):
        self.gathered = gathered
        self.axis = axis
        self.qw_bits, self.qg_bits = qw_bits, qg_bits
        self.out_dtypes = out_dtypes
        self.gathers = 0
        self.regathers = 0

    def __call__(self, lp: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for name, w in lp.items():
            gdim = self.gathered.get(name)
            if gdim is None:
                out[name] = w
                continue
            dt = self.out_dtypes.get(name, w.dtype)
            full = quantized_all_gather(w, self.axis, gdim,
                                        qw_bits=self.qw_bits,
                                        qg_bits=self.qg_bits, out_dtype=dt)
            self.gathers += 1
            _register(full, self._regather(w.detach(), gdim, dt))
            out[name] = full
        return out

    def _regather(self, block, gdim, dt):
        def regather():
            self.regathers += 1
            with torch.no_grad():
                return _gather(block, self.axis, gdim, self.qw_bits).to(dt)
        return regather


def make_quantized_gather_transform(mesh: topo.MeshTopology,
                                    leaf_specs: Dict[str, Any], *,
                                    qw_bits: Optional[int] = 8,
                                    qg_bits: Optional[int] = None,
                                    out_dtypes: Optional[Dict[str, Any]]
                                    = None,
                                    axis: str = topo.FSDP_AXIS):
    """A :class:`GatherTransform` over every leaf of ``leaf_specs`` (leaf
    name → spec of that leaf, per layer: without the stacked-layers dim)
    that has a dim sharded over ``axis``; None when there is none or the
    axis has one rank. ``out_dtypes`` names the dtype a leaf is gathered
    into (the compute dtype of a matrix; default the leaf's own)."""
    if mesh.axis_size(axis) <= 1:
        return None
    gathered = {}
    for name, spec in leaf_specs.items():
        gd = _gather_dim(spec, axis)
        if gd is not None:
            if any(a != axis for a in entry_axes(spec[gd])):
                raise ValueError(f"leaf {name}: spec {spec} shards its "
                                 f"gather dim over more than {axis!r}")
            gathered[name] = gd
    if not gathered:
        return None
    return GatherTransform(gathered, axis, qw_bits, qg_bits,
                           dict(out_dtypes or {}))
