"""Dropless MoE: top-1 routing without capacity, on PyTorch.

Counterpart of ``deepspeed_tpu/moe/grouped.py``. The tokens are sorted by
their routed expert (a stable sort, as ``jnp.argsort``) and each expert's
contiguous rows are multiplied by its weights: ``lax.ragged_dot`` becomes
a loop of products over the row slices, whose sizes are read on the host
once a layer (``group_sizes.tolist()``, a device sync on the card). No
padding rows, no dropped tokens.

- :func:`dropless_moe_mlp`: one rank holds every expert;
- :func:`dropless_moe_mlp_ep`: the rank holds ``E/ep`` experts of the
  ``expert`` group and every token row (activations are replicated over
  the expert axis). It runs the tokens routed to its experts; every other
  row is the JAX package's zero-weight dummy group, whose output is exactly
  zero, so it is left at zero without a product. The combine is a sum over
  the expert group, as the ``psum`` at JAX :150.

The aux loss is the GShard load-balancing loss over the global batch (see
``sharded_moe``'s ``group``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import topology as topo
from ..parallel.tensor_parallel import (copy_to_tensor_region,
                                        reduce_from_tensor_region)
from .sharded_moe import _as, _count_stats, _global_sum, _one_hot, group_size


def _route(router_logits, group):
    """(expert [N], gate [N], l_aux) of top-1 routing over the global
    batch of ``group``."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    E = probs.shape[-1]
    expert = torch.argmax(router_logits, dim=-1)
    gate = torch.gather(probs, -1, expert[:, None])[:, 0]
    sg = probs.shape[0] * group_size(group)
    _, total = _count_stats(_one_hot(expert, E).sum(0), group)
    me = _global_sum(probs.sum(0), group) / sg
    l_aux = torch.sum(me * (total / sg)) * E
    return expert, gate, l_aux


def _host_sizes(gs) -> list:
    """The group sizes on the host: the loop's trip counts (on the card,
    the one device sync of a layer)."""
    return gs.tolist()


def _ragged_expert_ffn(st, gs, w_in, w_out, w_gate, activation, dtype):
    """Grouped FFN over expert-sorted rows ``st`` [N, H] with group sizes
    ``gs`` [E] (JAX :87): group ``e`` is rows ``[sum(gs[:e]),
    sum(gs[:e+1]))``. Rows past the last group stay zero (the dummy group
    of zero weights)."""
    w_in, w_out = _as(w_in, dtype), _as(w_out, dtype)
    silu = w_gate is not None and activation == "silu"
    if silu:
        w_gate = _as(w_gate, dtype)
    outs, start = [], 0
    for e, n in enumerate(_host_sizes(gs)):
        if n == 0:
            continue
        x = st[start:start + n]
        h = x @ w_in[e]
        if silu:
            h = F.silu(x @ w_gate[e]) * h
        elif activation == "relu":
            h = F.relu(h)
        else:
            h = F.gelu(h, approximate="none" if activation == "gelu_exact"
                       else "tanh")
        outs.append(h @ w_out[e])
        start += n
    rest = st.shape[0] - start
    if rest or not outs:
        outs.append(st.new_zeros((rest, w_out.shape[-1])))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _unsort(out_sorted, order):
    """Rows back in token order: ``out[order[i]] = out_sorted[i]``."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return out_sorted[inv]


def dropless_moe_mlp(tokens, router_logits, w_in, w_out, w_gate=None,
                     activation: str = "gelu", dtype=None,
                     group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 dropless MoE FFN (JAX :44). tokens [N, H]; router_logits
    [N, E] (fp32); w_in [E, H, M]; w_out [E, M, H]; w_gate [E, H, M] for
    SwiGLU. Returns (out [N, H], aux_loss)."""
    dtype = dtype or tokens.dtype
    E = router_logits.shape[-1]
    expert, gate, l_aux = _route(router_logits, group)
    order = torch.argsort(expert, stable=True)
    sorted_tokens = tokens[order].to(dtype)
    group_sizes = torch.bincount(expert, minlength=E)
    out_sorted = _ragged_expert_ffn(sorted_tokens, group_sizes, w_in, w_out,
                                    w_gate, activation, dtype)
    out = _unsort(out_sorted, order)
    return out * gate[:, None].to(dtype), l_aux


def dropless_moe_mlp_ep(tokens, router_logits, w_in, w_out,
                        w_gate: Optional[torch.Tensor] = None, *, ep: int,
                        expert_index: int, axis_name: str = topo.EXPERT_AXIS,
                        activation: str = "gelu", dtype=None,
                        group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel top-1 dropless MoE FFN (JAX :102): ``w_in``/
    ``w_out``/``w_gate`` are this rank's ``E/ep`` experts, the rank's index
    in the ``axis_name`` group is ``expert_index``. Returns (out [N, H],
    aux_loss), the same on every rank of the group."""
    dtype = dtype or tokens.dtype
    expert, gate, l_aux = _route(router_logits, group)
    el = w_in.shape[0]
    e0 = expert_index * el
    local = (expert >= e0) & (expert < e0 + el)
    key = torch.where(local, expert - e0, torch.full_like(expert, el))
    order = torch.argsort(key, stable=True)
    tok = copy_to_tensor_region(tokens, ep, axis_name)
    st = tok[order].to(dtype)
    gs = torch.bincount(key, minlength=el + 1)[:el]
    o = _ragged_expert_ffn(st, gs, w_in, w_out, w_gate, activation, dtype)
    full = reduce_from_tensor_region(_unsort(o, order), ep, axis_name)
    return full * gate[:, None].to(dtype), l_aux
