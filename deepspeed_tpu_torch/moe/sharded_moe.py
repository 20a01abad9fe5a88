"""Sharded MoE: top-k gating and capacity-based dispatch/combine, on PyTorch.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` (``_capacity``,
``top1gating``, ``top2gating``, ``TopKGate``, ``expert_mlp``,
``moe_dispatch_combine``): the GShard formulation, where dispatch and
combine are einsums against a [tokens, experts, capacity] one-hot. The JAX
package computes them in XLA, outside any Pallas kernel, so here they are
``torch.einsum`` and batched products.

Gumbel noise (top-1 under ``noisy_gate_policy="RSample"``, the second
expert of top-2) is a tensor argument, ``noise``, drawn by the caller
(``gumbel(shape, generator)`` from an explicit ``torch.Generator``), so a
test can hand both packages the same draw.

Routing over a batch group (``group``: the ``data`` x ``fsdp`` axes whose
ranks each hold some rows of one global batch): the statistics are the
global batch's, as the JAX engine computes them under GSPMD. The capacity
is that of the global token count, each token's queue position counts the
tokens of lower-indexed ranks (an exclusive prefix of the per-rank expert
counts, one all-gather of ``[k, E]`` counts), and ``me``/``ce`` are global
means (``me``'s sum through an all-reduce whose backward all-reduces too:
every rank's loss carries the same aux term, and the engine averages the
ranks' gradients).

Expert parallelism (``ep`` > 1 in :func:`moe_dispatch_combine`): the rank
holds experts ``[first, first + E/ep)`` and every token row (activations
are replicated over the ``expert`` axis); it dispatches to its own experts
only, and the combine is a sum over the expert group
(``parallel/tensor_parallel``'s region operators over ``expert``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import comm
from ..parallel import topology as topo
from ..parallel.tensor_parallel import (copy_to_tensor_region,
                                        reduce_from_tensor_region)


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    cap = int(math.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


def _one_hot(idx, n: int) -> torch.Tensor:
    """fp32 one-hot; an index outside [0, n) gives a row of zeros, as
    ``jax.nn.one_hot`` does."""
    return (idx.long()[..., None]
            == torch.arange(n, device=idx.device)).to(torch.float32)


def gumbel(shape, generator: Optional[torch.Generator] = None,
           device=None) -> torch.Tensor:
    """Standard Gumbel noise (``-log(-log(U))``) of ``shape`` in fp32."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def _as(w, dtype) -> torch.Tensor:
    """A weight in ``dtype``: a tensor cast, a ``QuantTensor`` dequantized."""
    return w.to(dtype) if torch.is_tensor(w) else w.dequantize(dtype)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``, with a backward that sums the gradients over the
    group too (each rank's loss reads the same reduced value)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_reduce(x.contiguous().clone(), comm.ReduceOp.SUM,
                               group)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.contiguous().clone(), comm.ReduceOp.SUM,
                               ctx.group), None


def group_size(group) -> int:
    return 1 if group is None else comm.get_world_size(group)


def _global_sum(x, group):
    """``x`` summed over ``group`` (autograd-aware); ``x`` itself alone."""
    if group_size(group) <= 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return comm.all_reduce(x.contiguous().clone(), comm.ReduceOp.SUM, group)


def _count_stats(counts, group):
    """``(prefix, total)`` of per-rank ``counts`` [k, E] over ``group``:
    the counts of the lower-indexed ranks and of all ranks."""
    if group_size(group) <= 1:
        return torch.zeros_like(counts), counts
    every = comm.all_gather(None, counts.contiguous(), group)   # [n, k, E]
    i = comm.axis_index(group)
    return every[:i].sum(0), every.sum(0)


def _aux(gates, mask1, total1, s_global, num_experts, group):
    """The GShard load-balancing loss ``E * sum(me * ce)`` over the global
    batch (reference sharded_moe.py:249)."""
    me = _global_sum(gates.sum(0), group) / s_global
    ce = total1 / s_global
    return torch.sum(me * ce) * num_experts


def top1gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               noise: Optional[torch.Tensor] = None,
               noisy_gate_policy: Optional[str] = None,
               drop_tokens: bool = True, group=None):
    """Top-1 gating (JAX :37). logits [S, E] -> (l_aux, combine [S, E, C],
    dispatch [S, E, C] bool, exp_counts [E]). ``noise`` (Gumbel, [S, E])
    is added to the argmax's input under ``noisy_gate_policy="RSample"``."""
    S, E = logits.shape
    n = group_size(group)
    sg = S * n
    if noisy_gate_policy == "RSample" and noise is not None:
        logits_w_noise = logits + noise
    else:
        logits_w_noise = logits
    gates = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(logits_w_noise, dim=-1)
    mask1 = _one_hot(idx1, E)
    C = _capacity(sg, E, capacity_factor, min_capacity) if drop_tokens \
        else sg
    prefix, total = _count_stats(mask1.sum(0, keepdim=True), group)

    # position of each token within its expert's queue (global order)
    locations1 = torch.cumsum(mask1, dim=0) - mask1 + prefix
    loc1 = torch.sum(locations1 * mask1, dim=-1)

    l_aux = _aux(gates, mask1, total[0], sg, E, group)

    keep = (loc1 < C) & (mask1.sum(-1) > 0)
    gate1 = torch.sum(gates * mask1, dim=-1)
    combine = ((gate1 * keep)[:, None, None] * mask1[:, :, None]
               * _one_hot(loc1, C)[:, None, :])
    dispatch = combine > 0
    exp_counts = torch.sum(mask1, dim=0)
    return l_aux, combine, dispatch, exp_counts


def top2gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               noise: Optional[torch.Tensor] = None, group=None):
    """Top-2 gating (JAX :73): the first expert by argmax of the gates, the
    second from the logits with the first masked out (plus ``noise``, the
    reference's Gumbel sampling); the pair's gates renormalized."""
    S, E = logits.shape
    n = group_size(group)
    sg = S * n
    gates = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(idx1, E)
    logits_no1 = torch.where(mask1 > 0,
                             torch.full_like(logits, -math.inf), logits)
    if noise is not None:
        logits_no1 = logits_no1 + noise
    idx2 = torch.argmax(logits_no1, dim=-1)
    mask2 = _one_hot(idx2, E)

    C = _capacity(sg, E, capacity_factor * 2, min_capacity)

    prefix, total = _count_stats(
        torch.stack([mask1.sum(0), mask2.sum(0)]), group)
    locations1 = torch.cumsum(mask1, dim=0) - mask1 + prefix[0]
    locations2 = (torch.cumsum(mask2, dim=0) - mask2 + total[0]
                  + prefix[1])
    loc1 = torch.sum(locations1 * mask1, dim=-1)
    loc2 = torch.sum(locations2 * mask2, dim=-1)

    l_aux = _aux(gates, mask1, total[0], sg, E, group)

    keep1 = loc1 < C
    keep2 = loc2 < C
    g1 = torch.sum(gates * mask1, dim=-1) * keep1
    g2 = torch.sum(gates * mask2, dim=-1) * keep2
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    combine = (g1[:, None, None] * mask1[:, :, None]
               * _one_hot(loc1, C)[:, None, :]
               + g2[:, None, None] * mask2[:, :, None]
               * _one_hot(loc2, C)[:, None, :])
    dispatch = combine > 0
    exp_counts = torch.sum(mask1 + mask2, dim=0)
    return l_aux, combine, dispatch, exp_counts


class TopKGate:
    """Gate module (JAX :113): a linear router and top-k gating."""

    def __init__(self, hidden_size: int, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True):
        if k not in (1, 2):
            raise ValueError("Only top-1 and top-2 gating supported "
                             "(reference parity)")
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        scale = 1.0 / math.sqrt(self.hidden_size)
        return {"wg": scale * torch.randn(
            (self.hidden_size, self.num_experts), generator=generator,
            device=device, dtype=torch.float32)}

    def __call__(self, params, x, noise: Optional[torch.Tensor] = None,
                 train: bool = True, group=None):
        """x [S, M] -> (l_aux, combine [S, E, C], dispatch, exp_counts).
        ``noise``: the Gumbel draw [S, E], read in training only (the JAX
        gate gets its rng then)."""
        logits = x.float() @ params["wg"].float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        noise = noise if train else None
        if self.k == 1:
            return top1gating(logits, cf, self.min_capacity, noise,
                              self.noisy_gate_policy if train else None,
                              self.drop_tokens, group=group)
        return top2gating(logits, cf, self.min_capacity, noise, group=group)


def expert_mlp(expert_in, w_in, w_out, w_gate=None, activation: str = "gelu",
               dtype=None):
    """Per-expert FFN over dispatched tokens [E, C, M] -> [E, C, M] (JAX
    :141): SwiGLU for ``silu``, the tanh GELU otherwise. The weights are
    the rank's experts [E, M, F] / [E, F, M] (tensors or QuantTensors)."""
    if dtype is None:
        dtype = expert_in.dtype
    h = torch.bmm(expert_in, _as(w_in, dtype))
    if activation == "silu":
        g = torch.bmm(expert_in, _as(w_gate, dtype))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, _as(w_out, dtype))


def moe_dispatch_combine(x, combine, dispatch, expert_fn, ep: int = 1,
                         first_expert: int = 0,
                         expert_group=topo.EXPERT_AXIS):
    """The GShard einsum pair (JAX :160). x [S, M]; combine/dispatch
    [S, E, C]; ``expert_fn``: [E', C, M] -> [E', C, M] over the rank's
    experts. With ``ep`` > 1 the rank dispatches to its experts
    ``[first_expert, first_expert + E/ep)`` only, and the combine sums the
    partial outputs over ``expert_group`` (the all-to-all pair of the
    reference, with activations replicated over the expert axis). The
    partial outputs are summed in fp32 and rounded once, as the one
    einsum over every expert rounds its fp32 sum."""
    if ep <= 1:
        expert_in = torch.einsum("sec,sm->ecm", dispatch.to(x.dtype), x)
        expert_out = expert_fn(expert_in)
        return torch.einsum("sec,ecm->sm", combine.to(x.dtype), expert_out)
    el = combine.shape[1] // ep
    x = copy_to_tensor_region(x, ep, expert_group)
    combine = copy_to_tensor_region(combine, ep, expert_group)
    sl = slice(first_expert, first_expert + el)
    expert_in = torch.einsum("sec,sm->ecm", dispatch[:, sl].to(x.dtype), x)
    expert_out = expert_fn(expert_in)
    y = torch.einsum("sec,ecm->sm", combine[:, sl].to(x.dtype).float(),
                     expert_out.float())
    return reduce_from_tensor_region(y, ep, expert_group).to(x.dtype)
