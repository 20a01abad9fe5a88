"""Ulysses sequence parallelism — all-to-all head scatter / sequence gather.

Counterpart of ``deepspeed_tpu/sequence/layer.py`` (the reference's
``DistributedAttention`` wrapping any local attention between two
``_SeqAllToAll`` ops). Activations arrive sharded over the sequence dim;
the first all-to-all re-shards them to the full sequence and a rank's share
of the heads, the local attention runs dense (on the card, the flash
kernels), and the second all-to-all inverts.

Each rank is a process and passes its own sequence shard (the JAX
functions run inside ``shard_map``, or under GSPMD for
:class:`DistributedAttention`). The all-to-alls run over
``comm.all_to_all_single`` inside an autograd Function whose backward is the
opposite all-to-all. q, k and v cross in one all-to-all: each one's head
dim is cut into the group's pieces and the three pieces bound for one rank
travel together.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import comm
from ..parallel import topology as topo


class _SeqAllToAll(torch.autograd.Function):
    """``comm.all_to_all_single`` splitting ``scatter_dim`` and
    concatenating ``gather_dim``; the backward is the opposite one."""

    @staticmethod
    def forward(ctx, x, group, scatter_dim, gather_dim):
        ctx.args = (group, scatter_dim, gather_dim)
        return comm.all_to_all_single(None, x, group, split_axis=scatter_dim,
                                      concat_axis=gather_dim)

    @staticmethod
    def backward(ctx, g):
        group, scatter_dim, gather_dim = ctx.args
        return (comm.all_to_all_single(None, g.contiguous(), group,
                                       split_axis=gather_dim,
                                       concat_axis=scatter_dim),
                None, None, None)


def seq_all_to_all(x, group, scatter_dim: int, gather_dim: int):
    """The differentiable all-to-all of ``x`` over ``group``."""
    return _SeqAllToAll.apply(x, group, scatter_dim, gather_dim)


def ulysses_attention(local_attn: Callable, q, k, v, *args,
                      seq_axis: str = topo.SEQUENCE_AXIS,
                      scatter_dim: int = 2, gather_dim: int = 1, **kwargs):
    """q/k/v: this rank's sequence shard [B, T/P, H, D] (k, v [B, T/P, KH,
    D]). Scatters heads, gathers the sequence, runs ``local_attn`` on [B, T,
    H/P, D] (k, v KH/P heads), inverts. Heads must divide by the group
    size, as the JAX ``all_to_all`` needs."""
    P = comm.get_world_size(seq_axis)
    if P <= 1:
        return local_attn(q, k, v, *args, **kwargs)
    heads = [t.shape[scatter_dim] for t in (q, k, v)]
    if any(h % P for h in heads):
        raise ValueError(f"Ulysses attention needs head counts {heads} "
                         f"divisible by the {seq_axis} axis ({P})")
    # each tensor's scatter dim as [P, h/P]; the pieces bound for one rank
    # side by side, so one all-to-all carries all three
    parts = [t.unflatten(scatter_dim, (P, h // P))
             for t, h in zip((q, k, v), heads)]
    packed = torch.cat(parts, dim=scatter_dim + 1).flatten(
        scatter_dim, scatter_dim + 1)
    got = seq_all_to_all(packed, seq_axis, scatter_dim, gather_dim)
    ql, kl, vl = torch.split(got, [h // P for h in heads], dim=scatter_dim)
    out = local_attn(ql, kl, vl, *args, **kwargs)
    return seq_all_to_all(out, seq_axis, gather_dim, scatter_dim)


class DistributedAttention:
    """Ulysses with the reference's call surface.

    ``local_attn(q, k, v, *args, **kwargs) -> out`` with [B, T, H, D]
    layouts. Over a mesh whose ``sequence`` axis is larger than one, each
    rank passes its sequence shard [B, T/P, H, D] and gets its shard of the
    output back (the JAX class takes global arrays under GSPMD, whose
    sharding constraints lower to the same all-to-alls).
    """

    def __init__(self, local_attn: Callable,
                 sequence_axis: str = topo.SEQUENCE_AXIS,
                 batch_axes=topo.BATCH_AXES):
        self.local_attn = local_attn
        self.seq_axis = sequence_axis
        self.batch_axes = batch_axes

    def __call__(self, q, k, v, *args, **kwargs):
        t = topo.get_topology()
        if t.get_sequence_parallel_world_size() <= 1:
            return self.local_attn(q, k, v, *args, **kwargs)
        return ulysses_attention(self.local_attn, q, k, v, *args,
                                 seq_axis=self.seq_axis, **kwargs)
