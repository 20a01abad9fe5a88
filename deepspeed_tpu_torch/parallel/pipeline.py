"""Pipeline parallelism over the ``pipe`` axis: GPipe, one process a stage.

Counterpart of ``deepspeed_tpu/parallel/pipeline.py``. The JAX package
runs the whole schedule as one program under ``shard_map``: the stacked
layer dim is sharded over the ``pipe`` axis (each device holds L/P
contiguous layers), micro-batch activations rotate stage to stage through
``lax.ppermute`` inside a ``lax.scan`` over schedule ticks, and autodiff of
the scan is the backward pipeline. Here each stage is a process that holds
its L/P layers (the engine cuts them by the sharding plan, where
``layers`` maps to ``pipe``), the ticks are a Python loop, and the
activations move through :func:`ppermute`, an autograd Function whose
backward is the inverse permutation.

Eager differences from the JAX program, each keeping its numbers:

- A stage computes only its live ticks (micro-batch ``t - stage`` in
  range); the fill and drain ticks, on which the JAX program computes
  garbage and masks it, run no layer. A tick's permutation carries only the
  pairs whose sender computed, so every rank sends and receives the same
  pairs in the same order, forward and backward.
- Every rank's ticks form one chain (a skipped tick passes its carry on,
  stage 0 joins each injected micro-batch to the carry it replaces, and the
  final output is joined to the last tick's carry), so the backward on
  every rank reaches every permutation, in reverse tick order.
- The last stage's output reaches every stage through an all-reduce whose
  backward is the identity (``parallel/tensor_parallel._ReduceFromRegion``;
  ``torch.distributed.nn``'s all-reduce would reduce the gradient again).

The bubble is (P-1)/(M+P-1) of the ticks, as in GPipe and the JAX program.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .. import comm
from . import topology as topo
from .tensor_parallel import _ReduceFromRegion


class _PPermute(torch.autograd.Function):
    """``comm.ppermute`` of ``x`` over ``group``; the backward sends each
    received gradient back along the inverse permutation."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return comm.ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return comm.ppermute(g.contiguous(), inv, ctx.group), None, None


def ppermute(x: torch.Tensor, perm, group) -> torch.Tensor:
    """What this rank receives under ``perm`` (pairs of group indices;
    zeros where it receives nothing), differentiable: the gradient goes back
    along the inverse permutation."""
    return _PPermute.apply(x, list(perm), group)


class _Tie(torch.autograd.Function):
    """``a`` as it is, with an edge to ``b`` that carries a zero gradient:
    it keeps ``b``'s producers (a permutation, whose backward talks to
    another rank) in this rank's backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.b_meta = (b.shape, b.dtype, b.device)
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.b_meta
        return g, torch.zeros(shape, dtype=dtype, device=device)


def tie(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a``, keeping ``b`` in the backward graph with a zero gradient."""
    if not (torch.is_grad_enabled() and b.requires_grad):
        return a
    return _Tie.apply(a, b)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, with the identity
    backward: each rank's gradient stays its own."""
    if comm.get_world_size(group) <= 1:
        return x
    return _ReduceFromRegion.apply(x, group)


def spmd_pipeline(layer_fn: Callable, local_layers: Sequence, x, num_micro: int,
                  axis_name: str = topo.PIPE_AXIS):
    """Run a pipelined loop over this stage's layers on every rank of
    ``axis_name``.

    ``layer_fn(carry, layer_slice, micro_idx) -> (carry, aux)`` — one
    block; ``micro_idx`` is the micro-batch id and ``aux`` a 0-d auxiliary
    loss (MoE load balancing) or None. ``local_layers``: this stage's layer
    slices in order (L/P of them); ``x`` [B, ...] the whole input on every
    stage (only stage 0 reads it); ``num_micro`` M micro-batches (B % M ==
    0).

    Returns ``(out [B, ...], aux)`` on every stage: the last stage's output,
    and the aux losses summed over layers and stages and averaged over
    micro-batches (comparable to the unpipelined full-batch value).
    """
    P = comm.get_world_size(axis_name)
    stage = comm.axis_index(axis_name) if P > 1 else 0
    B = x.shape[0]
    M = num_micro
    assert B % M == 0, f"batch {B} not divisible by pipeline microbatches {M}"
    mb = B // M
    x_m = x.reshape(M, mb, *x.shape[1:])
    n_ticks = M + P - 1

    def run_local_layers(carry, micro_idx):
        aux = None
        for lp in local_layers:
            carry, a = layer_fn(carry, lp, micro_idx)
            if a is not None:
                aux = a if aux is None else aux + a
        return carry, aux

    # the carry before the first tick: under autograd a leaf, so that every
    # rank's first permutation is in its graph (a stage that receives its
    # first activation later still sends that tick's gradient back)
    cur = x.new_zeros((mb,) + tuple(x.shape[1:]))
    cur.requires_grad_(torch.is_grad_enabled())
    outs, aux_acc = [], torch.zeros((), dtype=torch.float32, device=x.device)
    y = cur
    for t in range(n_ticks):
        m_here = t - stage
        live = 0 <= m_here < M
        if stage == 0 and live:
            cur = tie(x_m[m_here], cur)
        if live:
            y, aux = run_local_layers(cur, m_here)
            if aux is not None:
                aux_acc = aux_acc + aux
            if stage == P - 1:
                outs.append(y)
        else:
            y = cur
        if t < n_ticks - 1:
            # the pairs whose sender computed this tick
            perm = [(s, s + 1) for s in range(P - 1) if 0 <= t - s < M]
            cur = ppermute(y, perm, axis_name)
    if stage == P - 1:
        out = torch.stack(outs).reshape(x.shape)
    else:
        out = torch.zeros_like(x)
    out = tie(out, y)
    out = sum_over(out, axis_name)
    aux = sum_over(aux_acc, axis_name) / M
    return out, aux


def pipelined_layer_apply(layer_fn: Callable, stacked_layers, x,
                          num_micro: int, axis_name: str = topo.PIPE_AXIS):
    """Host-level form: ``stacked_layers`` (a tensor or a dict tree of
    tensors with leading dim L, divisible by the axis size) is the whole
    stack on every rank; this stage runs its contiguous L/P layers (the
    JAX wrapper's ``shard_map`` in_specs ``P('pipe')``). ``x`` [B, ...].
    Returns ``(out, aux)``."""
    P = comm.get_world_size(axis_name)
    stage = comm.axis_index(axis_name) if P > 1 else 0

    def leaves(tree):
        if isinstance(tree, dict):
            return [v for k in sorted(tree) for v in leaves(tree[k])]
        return [tree]

    L = leaves(stacked_layers)[0].shape[0]
    if L % P:
        raise ValueError(f"{L} layers do not divide over {P} pipeline stages")
    n = L // P

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[stage * n + i]

    local = [take(stacked_layers, i) for i in range(n)]
    return spmd_pipeline(layer_fn, local, x, num_micro, axis_name=axis_name)
