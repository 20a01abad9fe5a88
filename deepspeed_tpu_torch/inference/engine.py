"""Inference engine v1: ``generate`` with a paged KV cache, on PyTorch.

Counterpart of ``deepspeed_tpu/inference/engine.py`` (``InferenceEngine``,
what ``init_inference`` returns). The JAX package compiles one program of
prefill and a ``lax.scan`` of decode steps; here ``generate`` is the same
loop run eagerly: one ``prefill_paged`` over the right-padded prompts, then
``max_new`` ``decode_step_paged`` calls (the last one's logits unused, as
the scan computes them), over a pool-layout cache of ``DECODE_BLOCK``-slot
blocks in which each sequence owns a contiguous block range. On the card
prefill attends through the flash forward kernel, decode through the paged
attention kernel, and a weight-quantized tree (``quant.enabled``)
dequantizes each leaf at its use through the dequantize kernel.

Sampling: greedy (``temperature <= 0``) is ``argmax``, token for token the
JAX package's stream on the same weights. Sampled streams draw from a
``torch.Generator``, which cannot give ``jax.random``'s numbers: each token
lies in the top-k set, and one generator seed gives one stream.

Not ported (they raise): encoder models (``encode``/``mlm``/``classify``),
a device mesh and tensor parallelism, HF and universal checkpoints
(``config.checkpoint``, ``load_checkpoint``), ``profile_model_time``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .. import not_ported, resolve_device
from ..models.weights import params_from_numpy
from ..utils.logging import logger
from .config import InferenceConfig
from .quantization import QuantTensor, quantize_param_tree

_DTYPES = {"fp32": torch.float32, "fp16": torch.float16,
           "bf16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "bfloat16": torch.bfloat16}


def _on_device(tree, device):
    """A param tree on ``device``: tensors and QuantTensors moved (no copy
    when already there), anything else (numpy, a JAX QuantTensor's numpy
    children) converted by ``params_from_numpy``."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if torch.is_tensor(tree) or isinstance(tree, QuantTensor) \
            and torch.is_tensor(tree.q):
        return tree.to(device)
    return params_from_numpy(tree, device)


class InferenceEngine:
    """``deepspeed_tpu_torch.init_inference(model, config)`` product.

    ``model``: a ``CausalLM`` or a registered model name
    (``models.MODEL_CONFIGS``). ``params``: a param tree (tensors, numpy
    arrays, or either package's QuantTensors), kept as given (the JAX
    package keeps fp32 params and casts at each use); with ``None`` the
    engine draws fp32 weights with ``model.init`` from a ``torch.Generator``
    seeded 0 — not the JAX package's weights for its ``PRNGKey(0)``. The
    config's ``dtype`` (default bf16) is the compute dtype. Runs on
    ``cuda`` unless ``device="cpu"`` is passed."""

    # Paged-cache block size for the decode loop (the JAX package's choice;
    # the CUDA paged kernel takes any block size).
    DECODE_BLOCK = 128

    def __init__(self, model, config=None, params=None, mesh=None,
                 device=None, **kwargs):
        merged: Dict[str, Any] = {}
        if isinstance(config, dict):
            merged.update(config)
        merged.update(kwargs)
        self.config = config if isinstance(config, InferenceConfig) \
            else InferenceConfig(**merged)
        self.config.raise_if_not_ported()
        if mesh is not None:
            raise not_ported("a device mesh for inference", "queue 1 item 14")
        self.device = resolve_device(device)

        if isinstance(model, str):
            from ..models import build_model

            model = build_model(model)
        if model is None:
            raise not_ported("a model inferred from an HF checkpoint "
                             "(models/convert.py)", "queue 1 item 16")
        if not hasattr(model, "decode_step_paged"):
            raise not_ported("encoder models (models/encoder.py: encode, mlm, "
                             "classify)", "queue 1 item 16")
        dtype = _DTYPES.get(str(self.config.dtype), torch.bfloat16)
        if model.cfg.dtype != dtype:
            model = type(model)(dataclasses.replace(model.cfg, dtype=dtype))
        self.module = model

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = model.init(gen, device=self.device)
        else:
            params = _on_device(params, self.device)
        if self.config.quant.enabled:
            # ZeRO-Inference weight-only quantization: the quantize kernel on
            # the card, one launch a quantized leaf
            params = quantize_param_tree(params, bits=self.config.quant.bits)
        self.params = params

    # ------------------------------------------------------------------ API
    def forward(self, tokens, *args, **kwargs):
        """Plain forward: tokens [B, T] -> logits [B, T, V] in the compute
        dtype."""
        tokens = (tokens.to(self.device) if torch.is_tensor(tokens)
                  else torch.as_tensor(np.asarray(tokens), device=self.device))
        with torch.no_grad():
            return self.module.apply(self.params, tokens)

    __call__ = forward

    def encode(self, *args, **kwargs):
        raise not_ported("encoder serving (encode/mlm/classify)",
                         "queue 1 item 16")

    mlm = classify = encode

    @staticmethod
    def _sample(logits, generator, temperature: float, top_k: int):
        """Greedy when ``temperature`` <= 0, else top-k / temperature
        sampling with ``generator``."""
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        scaled = logits.float() / max(float(temperature), 1e-6)
        if top_k > 0:
            kth = torch.sort(scaled, dim=-1).values[..., -top_k][..., None]
            scaled = torch.where(scaled < kth,
                                 torch.full_like(scaled, -1e30), scaled)
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, rng=None,
                 prompt_len=None, eos_token_id=None, pad_token_id: int = 0,
                 **kwargs):
        """HF-style generate with ragged prompts.

        ``input_ids``: [B, T] tokens, or a list of per-sequence token lists
        (ragged: right-padded with ``pad_token_id`` here). ``prompt_len``
        [B] marks the real length of each row of a padded [B, T] array.
        ``eos_token_id`` (an int or a list): a sequence that emits it
        produces ``pad_token_id`` for the remaining steps. ``rng``: a
        ``torch.Generator`` or an int seed for sampling (default seed 0).
        Returns int32 [B, T + n] on the engine's device, each sequence's new
        tokens placed right after its prompt and ``pad_token_id`` beyond
        ``prompt_len[b] + n``."""
        dev = self.device
        if isinstance(input_ids, (list, tuple)) and input_ids \
                and isinstance(input_ids[0], (list, tuple, np.ndarray)):
            lens = [len(p) for p in input_ids]
            T = max(lens)
            padded = np.full((len(input_ids), T), pad_token_id, np.int32)
            for i, p in enumerate(input_ids):
                padded[i, :len(p)] = p
            tokens = torch.as_tensor(padded, device=dev)
            pl = np.asarray(lens, np.int32)
        else:
            if torch.is_tensor(input_ids):
                input_ids = input_ids.cpu()
            tokens = torch.as_tensor(np.asarray(input_ids, np.int32),
                                     device=dev)
            B, T = tokens.shape
            if prompt_len is None:
                pl = np.full((B,), T, np.int32)
            else:
                if torch.is_tensor(prompt_len):
                    prompt_len = prompt_len.cpu()
                pl = np.asarray(prompt_len).astype(np.int32)
                if pl.shape != (B,) or (pl < 1).any() or (pl > T).any():
                    raise ValueError(
                        f"prompt_len must be [B]={B} values in [1, {T}]; got "
                        f"shape {pl.shape}, range [{pl.min()}, {pl.max()}]")
                # re-pad past each prompt so that what lies beyond
                # prompt_len + n does not depend on the caller's padding
                keep = torch.arange(T, device=dev)[None, :] \
                    < torch.as_tensor(pl, device=dev)[:, None]
                tokens = torch.where(keep, tokens,
                                     torch.full_like(tokens, pad_token_id))
        B, T = tokens.shape
        ctx = self.module.cfg.max_seq_len
        if T >= ctx:
            raise ValueError(f"prompt length {T} >= max_seq_len {ctx}")
        max_new = min(max_new_tokens, ctx - T)
        if max_new < max_new_tokens:
            logger.warning(f"max_new_tokens clamped {max_new_tokens} → "
                           f"{max_new} (context window {ctx}, prompt {T})")
        if isinstance(rng, torch.Generator):
            gen = rng
        else:
            gen = torch.Generator(device=dev).manual_seed(
                0 if rng is None else int(rng))
        eos = None
        if eos_token_id is not None:
            ids = ([int(eos_token_id)] if isinstance(eos_token_id, int)
                   else [int(e) for e in eos_token_id])
            eos = torch.tensor(ids, dtype=torch.int32, device=dev)
        prompt_len = torch.as_tensor(pl, device=dev)
        with torch.no_grad():
            return self._generate(tokens, prompt_len, max_new, gen,
                                  float(temperature), int(top_k), eos,
                                  int(pad_token_id))

    def _generate(self, tokens, prompt_len, max_new, gen, temperature, top_k,
                  eos, pad_token_id):
        """One prefill, then ``max_new`` decode steps (as the JAX package's
        ``lax.scan`` runs them)."""
        module, params, dev = self.module, self.params, self.device
        B, T = tokens.shape
        cache, tables = module.init_paged_cache(B, T + max_new,
                                                self.DECODE_BLOCK, device=dev)
        logits, cache = module.prefill_paged(params, tokens, prompt_len, cache,
                                             tables)
        # logits at the last real prompt token of each sequence
        cur = logits[torch.arange(B, device=dev), prompt_len.long() - 1]
        del logits
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        out_tokens = []
        for i in range(max_new):
            nxt = self._sample(cur, gen, temperature, top_k)
            if eos is not None:
                # the EOS itself is emitted; every later token is pad
                nxt = torch.where(done, torch.full_like(nxt, pad_token_id),
                                  nxt)
                done = done | torch.isin(nxt, eos)
            cur, cache = module.decode_step_paged(params, cache, tables, nxt,
                                                  prompt_len + i)
            out_tokens.append(nxt)
        out = torch.full((B, T + max_new), pad_token_id, dtype=torch.int32,
                         device=dev)
        out[:, :T] = tokens
        if max_new:
            idx = prompt_len.long()[:, None] \
                + torch.arange(max_new, device=dev)[None, :]
            out.scatter_(1, idx, torch.stack(out_tokens, dim=1))
        return out

    # parity helpers ----------------------------------------------------------
    def profile_model_time(self, use_cuda_events: bool = False):
        raise not_ported("profile_model_time", "queue 1 item 17")

    def load_checkpoint(self, path):
        raise not_ported("InferenceEngine.load_checkpoint", "queue 1 item 13")
