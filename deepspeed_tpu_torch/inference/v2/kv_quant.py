"""int8/fp8 KV-cache quantization for the paged ragged engine, on PyTorch.

Counterpart of ``deepspeed_tpu/inference/v2/kv_quant.py``. Pools
``[L, NB, KH, bs, D]`` are stored as symmetric int8 (or float8_e4m3fn) with
one f32 scale per (layer, block, KV head) in planes ``[L, NB, KH]`` beside
them; a block costs half its bf16 bytes, so a fixed byte budget buys about
twice the blocks.

Write path (``paged_model.py``): a ragged chunk's KV lands in at most
``TB = (C-1)//bs + 2`` pool blocks per sequence, so the write is a
read-modify-write of the touched blocks only: gather and dequantize them,
zero the stale slots (positions at or past the context length), put the new
K/V in, and re-quantize each touched block at the monotone scale
``max(amax/qmax, previous scale)`` (a freshly allocated block ignores the
stale scale of its previous tenant). The arithmetic is the JAX package's
step for step, so codes and scales are bit-identical to it on the same
inputs. Unlike the JAX write, which returns new arrays and sends untouched
rows to an out-of-range sentinel that ``mode="drop"`` drops, this one
writes the layer's pool view in place and selects the touched rows
(``index_put_`` has no drop mode), as the unquantized write does.

Read path: ``ops/paged_attention.py`` takes the layer's scale planes
``[NB, KH]``; the kernel dequantizes each staged K/V tile on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...ops.quantizer import FP8_MAX, true_div

# Symmetric int8: values in [-127, 127] with scale = amax / 127.
Q_MAX = 127.0
# Floor for scales so an all-zero block cannot divide by zero.
SCALE_EPS = 1e-8

SUPPORTED_DTYPES = ("int8", "fp8_e4m3")
SUPPORTED_GRANULARITIES = ("block",)


def pool_dtype(dtype: str) -> torch.dtype:
    """The torch dtype of the KV pools for a representation name."""
    if dtype == "fp8_e4m3":
        return torch.float8_e4m3fn
    return torch.int8


def qmax_of(dtype) -> float:
    """The range limit the per-block scale maps amax onto, from a
    representation name or a pool dtype."""
    if "float8" in str(dtype) or str(dtype) == "fp8_e4m3":
        return FP8_MAX
    return Q_MAX


def validate_kv_quant(dtype: str, scale_granularity: str) -> None:
    """Reject configurations this implementation does not encode."""
    if dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"kv_quant.dtype {dtype!r} not supported "
                         f"(implemented: {SUPPORTED_DTYPES})")
    if scale_granularity not in SUPPORTED_GRANULARITIES:
        raise ValueError(
            f"kv_quant.scale_granularity {scale_granularity!r} not "
            f"supported (implemented: {SUPPORTED_GRANULARITIES})")


def kv_bytes_per_block(model_cfg, block_size: int, quant: bool = False,
                       dtype: Optional[torch.dtype] = None) -> int:
    """Device bytes one KV pool block costs across all layers: K and V slabs
    ``[L, KH, bs, D]`` at the pool dtype, plus (quantized) two f32 scale
    entries per (layer, KV head)."""
    slab = (model_cfg.num_layers * model_cfg.kv_heads * block_size
            * model_cfg.head_dim)
    if quant:
        return 2 * slab * 1 + 2 * model_cfg.num_layers * model_cfg.kv_heads * 4
    itemsize = torch.empty((), dtype=dtype or model_cfg.dtype).element_size()
    return 2 * slab * itemsize


def blocks_for_budget(budget_bytes: int, model_cfg, block_size: int,
                      quant: bool, dtype: Optional[torch.dtype] = None) -> int:
    """How many pool blocks a KV byte budget buys (at least 1)."""
    return max(1, int(budget_bytes)
               // kv_bytes_per_block(model_cfg, block_size, quant, dtype))


def touched_block_plan(block_tables, start_pos, n_tokens, chunk: int,
                       block_size: int,
                       num_blocks: int) -> Dict[str, torch.Tensor]:
    """The pool blocks this step's KV writes touch, as the JAX plan (:125):
    at most ``TB = (C-1)//bs + 2`` per row, the same for every layer, so the
    forward computes it once. ``touched`` [N, TB] marks the rows the
    in-place write stores (the JAX plan's ``scatter_ids < NB``). The masks
    are turned into index lists here, once per forward (each costs the host
    one wait for the card), so that the per-layer writes never wait:
    ``sel_rows``/``sel_ids`` are the touched (row·TB + t) and their block
    ids, ``tok``/``tok_n``/``tok_t``/``tok_slot`` the valid tokens and their
    coordinates."""
    N, MB = block_tables.shape
    bs = block_size
    dev = block_tables.device
    TB = (chunk - 1) // bs + 2
    tables = block_tables.long()
    start_pos = start_pos.long()
    n_tokens = n_tokens.long()
    ctx_len = start_pos + n_tokens                                   # [N]
    first_blk = torch.div(start_pos, bs, rounding_mode="floor")      # [N]
    tidx = first_blk[:, None] + torch.arange(TB, device=dev)[None, :]
    ids = torch.gather(tables, 1, tidx.clamp(0, MB - 1))             # [N, TB]
    touched = (tidx * bs < ctx_len[:, None]) & (tidx < MB) & (ids >= 0)
    gather_ids = torch.where(touched, ids.clamp(0, num_blocks - 1),
                             torch.zeros_like(ids))
    slot_pos = (tidx[:, :, None] * bs
                + torch.arange(bs, device=dev)[None, None, :])
    live_slots = (slot_pos < ctx_len[:, None, None]) & touched[:, :, None]
    positions = start_pos[:, None] + torch.arange(chunk, device=dev)[None, :]
    valid = torch.arange(chunk, device=dev)[None, :] < n_tokens[:, None]
    t_tok = torch.div(positions, bs, rounding_mode="floor") - first_blk[:, None]
    n_flat = torch.arange(N, device=dev).repeat_interleave(chunk)
    t_flat = torch.where(valid, t_tok, torch.full_like(t_tok, TB)).reshape(-1)
    slot_flat = (positions % bs).reshape(-1)
    has_prior = (tidx * bs < start_pos[:, None]) & touched
    sel_rows = touched.reshape(-1).nonzero()[:, 0]
    tok = (t_flat < TB).nonzero()[:, 0]
    return {"gather_ids": gather_ids, "touched": touched, "live_slots": live_slots,
            "has_prior": has_prior, "n_flat": n_flat, "t_flat": t_flat,
            "slot_flat": slot_flat, "sel_rows": sel_rows,
            "sel_ids": ids.reshape(-1)[sel_rows], "tok": tok,
            "tok_n": n_flat[tok], "tok_t": t_flat[tok],
            "tok_slot": slot_flat[tok]}


def quantized_block_write(pool, scale, new_vals, plan) -> None:
    """Merge new K or V rows into a quantized pool, in place.

    ``pool`` [NB, KH, bs, D] int8 or float8_e4m3fn (the representation
    follows ``pool.dtype``); ``scale`` [NB, KH] f32; ``new_vals``
    [N*C, KH, D] in the row order of ``plan``'s flattened token
    coordinates. The monotone-scale rule keeps steady-state decode exact:
    while a block's scale is unchanged, dequantize→requantize gives back
    its stored codes."""
    qmax = qmax_of(pool.dtype)
    gid = plan["gather_ids"]
    deq = pool[gid].float() * scale[gid][:, :, :, None, None]  # [N,TB,KH,bs,D]
    deq = torch.where(plan["live_slots"][:, :, None, :, None], deq,
                      torch.zeros((), dtype=deq.dtype, device=deq.device))
    deq[plan["tok_n"], plan["tok_t"], :, plan["tok_slot"], :] = \
        new_vals[plan["tok"]].float()
    amax = deq.abs().amax(dim=(3, 4))                             # [N,TB,KH]
    prior = torch.where(plan["has_prior"][:, :, None], scale[gid],
                        torch.zeros((), dtype=scale.dtype,
                                    device=scale.device))
    new_scale = torch.clamp(torch.maximum(true_div(amax, qmax), prior),
                            min=SCALE_EPS)
    scaled = deq / new_scale[:, :, :, None, None]
    if pool.dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(scaled, -qmax, qmax).to(pool.dtype)
    N, TB = gid.shape
    rows, ids = plan["sel_rows"], plan["sel_ids"]
    pool[ids] = q.reshape(N * TB, *q.shape[2:])[rows]
    scale[ids] = new_scale.reshape(N * TB, -1)[rows]
