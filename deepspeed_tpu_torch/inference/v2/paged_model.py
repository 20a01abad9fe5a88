"""Paged ragged-batch forward over a CausalLM, on PyTorch.

Counterpart of ``deepspeed_tpu/inference/v2/paged_model.py``
(``PagedCausalLM._forward`` :132-281). One call processes a mixed
prefill/decode ragged batch:

- tokens [N, C] padded chunks, per-seq ``start_pos`` (tokens already
  cached) and ``n_tokens`` (valid width) — Dynamic SplitFuse feeds both
  prompt chunks and single decode tokens through this same path;
- paged KV pools [L, NB, KH, bs, D] with per-seq block tables; each layer
  writes its new K/V at (block, slot), then attends through
  ``ops/paged_attention.py`` (the hand-written kernel on the card), which
  walks each sequence's block table itself;
- returns logits only at each sequence's last valid token, or, with
  ``verify_width`` W, at each row's last W positions right-aligned.

With ``k_scale``/``v_scale`` planes in the cache the pools are int8 or
float8_e4m3fn: each layer's K/V write is the read-modify-write of
``kv_quant.quantized_block_write`` over the blocks the step touches (one
plan per forward, as the JAX ``_forward`` :186-231), and the attention
dequantizes with the layer's scale planes. Linear weights may be dense or
``{"qw", "qs"}`` nodes (``weight_quant.py``); ``_linear`` dispatches.

Unlike the JAX forward, which returns new pools (XLA aliases them, so
nothing is copied on the TPU), this one writes ``kv_cache["k"][layer]``
and ``kv_cache["v"][layer]`` (and the scale planes) in place: a copy of a
multi-GB pool per layer would dominate the step.

Over a ``tensor`` group (the model built with ``tp > 1``; the engine does
that for a mesh with a tensor axis) each rank holds its kv heads of the
pools, ``[L, NB, KH/tp, bs, D]`` (and scale planes ``[L, NB, KH/tp]``), and
its blocks of the weights: the projections give ``H/tp`` query and
``KH/tp`` kv heads, the paged kernel runs on those local heads (the JAX
package's ``shard_map`` over the tensor axis, :84-129), and ``wo`` and
``w_out`` reduce their partial products over the group before their
biases. The logits come out whole and equal on every rank.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...models.transformer import (CausalLM, _linear, _norm, apply_rope,
                                   rope_table)
from ...ops.paged_attention import paged_attention
from .kv_quant import quantized_block_write, touched_block_plan


class PagedCausalLM:
    """Wraps a CausalLM's weights with a paged ragged forward."""

    def __init__(self, model: CausalLM, block_size: int):
        self.model = model
        self.cfg = model.cfg
        self.block_size = block_size
        self._tables: Dict[torch.device, tuple] = {}

    def _rope(self, device):
        """cos/sin over ``max_seq_len``, built once per device."""
        if device not in self._tables:
            cfg = self.cfg
            self._tables[device] = rope_table(cfg.max_seq_len, cfg.rot_dim,
                                              cfg.rope_theta, device=device)
        return self._tables[device]

    def forward(self, params, kv_cache, tokens, start_pos, n_tokens,
                block_tables, verify_width: int = 0):
        """tokens [N, C]; start_pos/n_tokens [N] int32; block_tables
        [N, MB] int32; kv_cache {k, v}: [L, NB, KH, bs, D] — plus
        {k_scale, v_scale} [L, NB, KH] for int8/fp8 pools — updated in
        place.

        Returns last_logits [N, V] — or, with ``verify_width`` W > 0,
        logits [N, W, V] holding each row's last W valid positions
        right-aligned (position W-1 is the row's last valid token; rows
        shorter than W repeat their first position in the left padding).
        """
        cfg = self.cfg
        model = self.model
        N, C = tokens.shape
        bs = self.block_size
        MB = block_tables.shape[1]
        dt = cfg.dtype
        dev = tokens.device
        start_pos = start_pos.to(torch.int32)
        n_tokens = n_tokens.to(torch.int32)
        block_tables = block_tables.to(torch.int32)

        x = params["embed"]["wte"][tokens.long()].to(dt)         # [N, C, H]
        if cfg.embedding_layernorm:
            x = _norm(x, params["embed"]["ln_w"],
                      params["embed"].get("ln_b"), cfg.norm, cfg.norm_eps)
        positions = (start_pos.long()[:, None]
                     + torch.arange(C, device=dev)[None, :])      # [N, C]
        # padded columns can pass max_seq_len - 1: clamp the table reads, as
        # the JAX gather clamps out-of-range indices
        pos_read = positions.clamp(max=cfg.max_seq_len - 1)
        slopes = cos = sin = None
        if cfg.position == "rope":
            cos_full, sin_full = self._rope(dev)
            cos, sin = cos_full[pos_read], sin_full[pos_read]   # [N, C, R/2]
        elif cfg.position == "alibi":
            slopes = model.head_slopes(dev)
        else:
            x = x + params["embed"]["wpe"][pos_read].to(dt)

        quant = "k_scale" in kv_cache
        if quant:
            # quantized pools: the touched-block plan is the same for every
            # layer, so it is computed once here
            kv_plan = touched_block_plan(block_tables, start_pos, n_tokens, C,
                                         bs, kv_cache["k"].shape[1])
        else:
            # KV write coordinates (pool block, slot) of the valid tokens
            # only: index_put_ has no drop mode, so invalid rows are
            # selected out instead of being sent to an out-of-range
            # sentinel block
            valid = (torch.arange(C, device=dev)[None, :]
                     < n_tokens.long()[:, None])                  # [N, C]
            blk_ids = torch.gather(block_tables.long(), 1,
                                   (positions // bs).clamp(0, MB - 1))
            write = (valid & (blk_ids >= 0)).reshape(-1)
            write_blk = blk_ids.reshape(-1)[write]
            write_off = (positions % bs).reshape(-1)[write]

        nh, kvh, hd = model.local_heads, model.local_kv_heads, cfg.head_dim

        def rope_q(t):
            if cfg.position != "rope":
                return t
            return apply_rope(t, cos, sin, cfg.rope_interleaved)

        def block_for(window):
            def block(x, lp, layer):
                h1 = _norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"),
                           cfg.norm, cfg.norm_eps)
                q = rope_q(_linear(h1, lp["wq"], lp.get("wq_b"),
                                   dt).reshape(N, C, nh, hd))
                k = rope_q(_linear(h1, lp["wk"], lp.get("wk_b"),
                                   dt).reshape(N, C, kvh, hd))
                v = _linear(h1, lp["wv"], lp.get("wv_b"),
                            dt).reshape(N, C, kvh, hd)
                kc, vc = kv_cache["k"][layer], kv_cache["v"][layer]
                ks = vs = None
                if quant:
                    # read-modify-write of the touched blocks at the
                    # monotone per-block scale
                    ks = kv_cache["k_scale"][layer]
                    vs = kv_cache["v_scale"][layer]
                    quantized_block_write(kc, ks, k.reshape(-1, kvh, hd),
                                          kv_plan)
                    quantized_block_write(vc, vs, v.reshape(-1, kvh, hd),
                                          kv_plan)
                else:
                    # paged KV write: token t lands at
                    # kc[block(t), :, slot(t), :]
                    kc[write_blk, :, write_off, :] = \
                        k.reshape(-1, kvh, hd)[write].to(kc.dtype)
                    vc[write_blk, :, write_off, :] = \
                        v.reshape(-1, kvh, hd)[write].to(vc.dtype)
                attn = paged_attention(q, kc, vc, block_tables, start_pos,
                                       n_tokens, alibi_slopes=slopes,
                                       window=window, sm_scale=cfg.attn_scale,
                                       k_scale=ks, v_scale=vs)
                attn_out = model._row_linear(attn.reshape(N, C, nh * hd),
                                             lp["wo"], lp.get("wo_b"), dt,
                                             model.tp)
                return model._attn_mlp_merge(x, attn_out, lp, h1)[0]
            return block

        x = model._scan_layers(block_for, x, params["layers"])
        x = _norm(x, params["final_norm"]["w"], params["final_norm"].get("b"),
                  cfg.norm, cfg.norm_eps)
        if verify_width:
            W = int(verify_width)
            idx = (n_tokens.long()[:, None] - W
                   + torch.arange(W, device=dev)[None, :]).clamp(0, C - 1)
            x_v = torch.gather(x, 1, idx[:, :, None].expand(N, W, x.shape[-1]))
            return model._unembed(params, x_v)
        last_idx = (n_tokens.long() - 1).clamp(0, C - 1)
        x_last = x[torch.arange(N, device=dev), last_idx]          # [N, H]
        return model._unembed(params, x_last[:, None, :])[:, 0]
