"""Ring attention — blockwise context parallelism over the sequence axis.

Counterpart of ``deepspeed_tpu/sequence/ring_attention.py``. Ring attention
removes Ulysses' head-count ceiling (Ulysses needs heads >= sequence
ranks): K/V blocks rotate around the ``sequence`` group while each rank
keeps its query block, merging online-softmax partial results in fp32.

Causal masking and the sliding window are by *global* position: rank i
holds positions [i·T_loc, (i+1)·T_loc), and at ring step s it holds the K/V
of rank (i - s) mod P. A block wholly in the future or wholly before the
window is skipped (:func:`_window_live`, the port's copy of the flash
kernels' band test), and a causal, windowed ring stops after the steps that
cover the band.

The JAX ring is an XLA formulation with no Pallas kernel, so the port runs
it in torch ops. Each rank is a process passing its own shard; K and V
rotate together, stacked, through ``parallel/pipeline.ppermute``, whose
backward is the inverse rotation. A skipped block keeps its K/V in the
backward graph with a zero gradient, so every rank's backward runs every
rotation, in reverse order.
"""

from __future__ import annotations

import math

import torch

from .. import comm
from ..parallel import topology as topo
from ..parallel.pipeline import ppermute, tie

NEG_INF = -1e30


def _window_live(causal, window, i, j, block_q, block_kv, offs):
    """Is block (i, j) inside the causal / sliding-window band? Row r (global
    q position ``i·bq + r + offs``) attends to col c iff ``r >= c`` (causal)
    and ``r - c < window`` (Mistral's window, self included). A KV block is
    dead when every (row, col) pair violates either bound. (The port's copy
    of ``deepspeed_tpu/ops/flash_attention.py::_window_live``.)"""
    live = True
    if causal:
        row_max = i * block_q + block_q - 1 + offs
        live = row_max >= j * block_kv
    if window:
        row_min = i * block_q + offs
        live = live and (j * block_kv + block_kv - 1 > row_min - window)
    return live


def _block_attn(q, k, v, q_off, k_off, causal: bool, window: int = 0):
    """Partial attention of local q against one K/V block: (unnormalized
    out, row max m, row sum l) for the online-softmax merge.

    q [B, Tq, H, D], k/v [B, Tk, KH, D]; offsets are global positions.
    ``window`` > 0: query p attends keys in (p - window, p].
    """
    B, Tq, H, D = q.shape
    KH = k.shape[2]
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(D)
    if causal:
        rows = q_off + torch.arange(Tq, device=q.device)[:, None]
        cols = k_off + torch.arange(k.shape[1], device=q.device)[None, :]
        keep = rows >= cols
        if window:
            keep = keep & (rows - cols < window)
        s = torch.where(keep[None, None], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)                                 # [B,H,Tq]
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)                                  # [B,H,Tq]
    out = torch.einsum("bhts,bshd->bthd", p.to(q.dtype), v)   # unnormalized
    return out, m, l


def ring_attention(q, k, v, causal: bool = True,
                   axis_name: str = topo.SEQUENCE_AXIS, window: int = 0):
    """Blockwise ring attention on this rank's sequence shard.

    q/k/v: local shards [B, T_loc, H|KH, D]. Returns [B, T_loc, H, D].
    ``window``: sliding-window attention by global position.
    """
    if window and not causal:
        raise ValueError("sliding window requires causal attention")
    P = comm.get_world_size(axis_name)
    my = comm.axis_index(axis_name) if P > 1 else 0
    B, Tq, H, D = q.shape
    T_loc = k.shape[1]
    perm = [(i, (i + 1) % P) for i in range(P)]

    # causal + window: ring step s delivers the s-th predecessor block and
    # no query attends further than window - 1 positions back, so the ring
    # needs only the steps that cover the band
    n_steps = P
    if causal and window:
        n_steps = min(P, -(-(window - 1) // T_loc) + 1) if T_loc else P

    acc = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m_acc = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for s in range(n_steps):
        src = (my - s) % P                  # whose K/V block this rank holds
        if _window_live(causal, window, my, src, Tq, T_loc, 0):
            out, m, l = _block_attn(q, kv[0], kv[1], q_off=my * Tq,
                                    k_off=src * T_loc, causal=causal,
                                    window=window)
            # online softmax merge
            m_new = torch.maximum(m_acc, m)
            a_old = torch.exp(m_acc - m_new)
            a_cur = torch.exp(m - m_new)
            acc = acc * a_old.transpose(1, 2)[..., None] \
                + out * a_cur.transpose(1, 2)[..., None]
            l_acc = l_acc * a_old + l * a_cur
            m_acc = m_new
        else:
            # a dead block: the JAX merge of (0, -inf, 0) leaves the
            # carries as they are; the K/V stays in the backward graph
            acc = tie(acc, kv)
        if s < n_steps - 1:
            # rotate K/V to the next rank (not after the last block)
            kv = ppermute(kv, perm, axis_name)
    denom = torch.clamp(l_acc, min=1e-30).transpose(1, 2)[..., None]
    return (acc / denom).to(q.dtype)


class _GatherSeq(torch.autograd.Function):
    """Every rank's shard concatenated on dim 1; the backward keeps this
    rank's slice of the gradient (every rank computes the same whole
    output, so its own slice is its shard's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[1]
        return comm.all_gather_into_tensor(None, x, group, axis=1)

    @staticmethod
    def backward(ctx, g):
        i = comm.axis_index(ctx.group)
        return g[:, i * ctx.n:(i + 1) * ctx.n], None


def ring_attention_sharded(q, k, v, causal: bool = True,
                           axis_name: str = topo.SEQUENCE_AXIS,
                           batch_axes=None, window: int = 0):
    """Host-callable form: q/k/v the whole [B, T, H, D] on every rank of the
    group; each rank runs the ring on its sequence slice, and the slices are
    gathered back into the whole output. ``batch_axes`` is accepted for the
    JAX signature; a rank keeps every row."""
    P = comm.get_world_size(axis_name)
    if P <= 1:
        return ring_attention(q, k, v, causal=causal, axis_name=axis_name,
                              window=window)
    my = comm.axis_index(axis_name)
    n = q.shape[1] // P
    sl = slice(my * n, (my + 1) * n)
    out = ring_attention(q[:, sl], k[:, sl], v[:, sl], causal=causal,
                         axis_name=axis_name, window=window)
    return _GatherSeq.apply(out, axis_name)
