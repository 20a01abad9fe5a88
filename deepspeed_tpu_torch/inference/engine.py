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

``config.checkpoint`` loads an HF checkpoint directory
(``models/convert.py``; with no model the model is built from its
``config.json``), its leaves read straight onto the device at the serving
dtype, as the JAX engine stores them; or a universal checkpoint
(``runtime/checkpointing.py``): a tag directory (with ``manifest.json``) or
a save directory with ``latest`` through ``load_params_for_model``, any
other directory read as the leaves' own directory, as the JAX engine reads
it (its ``inference/engine.py:99-104``). ``load_checkpoint(path)`` reads
the leaves' own directory into a built engine's params, as the JAX
engine's does.

Encoder models (``models/encoder.EncoderLM``: BERT, RoBERTa, DistilBERT)
serve through ``encode`` (``forward`` is ``encode`` for them), ``mlm`` and
``classify`` on one device; ``generate`` refuses them.

Tensor parallelism: ``tensor_parallel.tp_size`` maps onto the ``tensor``
axis of a mesh over the process world (``data`` takes the rest), as the
JAX ``inference/engine.py:62-70`` maps it; a ``mesh`` (a ``MeshTopology``,
a mesh config or a dict of axis sizes) is taken as it is. Every rank
builds the engine from the same whole tree and calls ``generate`` with the
same arguments (SPMD, as DeepSpeed's AutoTP ranks run); a rank keeps its
blocks of the params (quantized as the whole leaves would be,
``quantization.quantize_param_blocks``) and its kv heads of the cache, and
prefill and decode run on its heads. The logits come out whole and equal
on every rank, so a sampled stream draws the same tokens from one seed on
every rank.

Not ported (they raise): encoder serving over a tensor mesh (ROADMAP queue 1
item 16b-ii), ``profile_model_time``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import numpy as np
import torch

from .. import not_ported, resolve_device
from ..models.convert import (is_hf_checkpoint, load_hf_checkpoint,
                              model_from_checkpoint)
from ..models.weights import params_from_numpy
from ..parallel import topology as topo
from ..parallel.sharding import (SERVING_RULES, ZeroShardingPlan,
                                 place_blocks)
from ..utils.logging import logger
from .config import InferenceConfig
from .quantization import (QuantTensor, _leaves, quantize_param_blocks,
                           quantize_param_tree, quantized_cut)

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


def _tensor_size(mesh, tp_size: int) -> int:
    """The tensor axis a mesh argument (or, without one, ``tp_size``)
    asks for, read before the mesh is built over the process world."""
    if mesh is None:
        return tp_size
    if isinstance(mesh, topo.MeshTopology):
        return mesh.axis_size(topo.TENSOR_AXIS)
    if isinstance(mesh, dict):
        return int(mesh.get(topo.TENSOR_AXIS, 1))
    return int(getattr(mesh, topo.TENSOR_AXIS, 1) or 1)


class InferenceEngine:
    """``deepspeed_tpu_torch.init_inference(model, config)`` product.

    ``model``: a ``CausalLM``, an ``EncoderLM``, a registered model name
    (``models.MODEL_CONFIGS``), or None with ``config.checkpoint`` naming
    an HF checkpoint directory. ``params``: a param tree (tensors, numpy
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
        self.device = resolve_device(device)
        if isinstance(model, str):
            from ..models import build_model

            model = build_model(model)
        ckpt = self.config.checkpoint
        hf = ckpt is not None and is_hf_checkpoint(str(ckpt))
        if model is None:
            # the model described by an HF checkpoint's config.json
            if not hf:
                raise ValueError("init_inference needs a model or an HF "
                                 "checkpoint dir in config.checkpoint")
            model = model_from_checkpoint(str(ckpt))
        self._is_encoder = not hasattr(model, "decode_step_paged")
        tp_size = int(self.config.tensor_parallel.tp_size)
        if self._is_encoder and _tensor_size(mesh, tp_size) > 1:
            raise not_ported("encoder serving over a tensor mesh",
                             "queue 1 item 16b-ii")
        if mesh is None and tp_size > 1:
            mesh = {"tensor": tp_size, "data": -1}
        self.topology = None if mesh is None else topo.mesh_topology(mesh)
        self.tp = 1 if self.topology is None \
            else self.topology.axis_size(topo.TENSOR_AXIS)
        if self.topology is not None \
                and getattr(model.cfg, "moe_num_experts", 0) > 0 \
                and self.topology.axis_size(topo.EXPERT_AXIS) > 1:
            raise not_ported("expert-parallel serving (a MoE model over an "
                             "expert mesh axis)", "queue 1 item 14d-ii")
        dtype = _DTYPES.get(str(self.config.dtype), torch.bfloat16)
        if model.cfg.dtype != dtype:
            # CausalLM and EncoderLM alike (the same constructor contract)
            model = type(model)(dataclasses.replace(model.cfg, dtype=dtype))
        if self.tp > 1:
            topo.set_topology(self.topology)
            model = model.tensor_parallel(self.tp)
        self.module = model

        # under tensor parallelism the whole tree stays where it was read or
        # drawn and each rank's blocks are cut from it; an HF checkpoint is
        # read a rank's blocks at a time
        where = "cpu" if self.tp > 1 else self.device
        placed = False
        if params is None and hf:
            params = self._load_hf(model, str(ckpt), dtype)
            placed = self.tp > 1
        elif params is None and ckpt is not None:
            params = self._load_universal(model, str(ckpt), where)
        elif params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = model.init(gen, device=self.device)
        elif self.tp == 1:
            params = _on_device(params, self.device)
        elif not all(torch.is_tensor(leaf) for leaf in _leaves(params)):
            if any(isinstance(leaf, QuantTensor) for leaf in _leaves(params)):
                raise ValueError("a tensor-parallel engine cuts its blocks "
                                 "from dense whole leaves: pass a dense tree "
                                 "and set quant.enabled")
            params = params_from_numpy(params, "cpu")
        if self.tp > 1 and not placed:
            specs = ZeroShardingPlan(self.topology, 0, model.param_specs(),
                                     rules=SERVING_RULES).params(params)
            rank = torch.distributed.get_rank()
            if self.config.quant.enabled:
                params = quantize_param_blocks(
                    params, specs, self.topology, rank, self.device,
                    bits=self.config.quant.bits)
            else:
                params = place_blocks(params, specs, self.topology, rank,
                                      self.device)
        elif self.config.quant.enabled and not placed:
            # ZeRO-Inference weight-only quantization: the quantize kernel on
            # the card, one launch a quantized leaf
            params = quantize_param_tree(params, bits=self.config.quant.bits)
        self.params = params

    def _load_hf(self, model, ckpt: str, dtype):
        """Params from an HF checkpoint directory at the serving dtype (the
        JAX engine's ``param_dtype=dtype``), each leaf read straight onto
        the device. Under tensor parallelism a rank reads only its blocks,
        quantized as ``quantize_param_blocks`` cuts them when
        ``quant.enabled``."""
        if self.tp == 1:
            return load_hf_checkpoint(ckpt, model=model, param_dtype=dtype,
                                      device=self.device)[1]
        cut = None
        if self.config.quant.enabled:
            bits = self.config.quant.bits

            def cut(read, shape, sl):
                return quantized_cut(read, shape, sl, bits=bits)
        return load_hf_checkpoint(ckpt, model=model, param_dtype=dtype,
                                  device=self.device, topology=self.topology,
                                  rank=torch.distributed.get_rank(),
                                  cut=cut, rules=SERVING_RULES)[1]

    def _load_universal(self, model, ckpt: str, device):
        """fp32 params (as the JAX engine keeps them) from a universal
        checkpoint on ``device``."""
        from ..runtime.checkpointing import (_load_tree, load_params_for_model,
                                             param_template)

        if (os.path.exists(os.path.join(ckpt, "manifest.json"))
                or os.path.exists(os.path.join(ckpt, "latest"))):
            return load_params_for_model(model, ckpt, device=device)
        return _load_tree(param_template(model), ckpt, device)

    # ------------------------------------------------------------------ API
    def forward(self, tokens, *args, **kwargs):
        """Plain forward: tokens [B, T] -> logits [B, T, V] in the compute
        dtype. For an encoder this is :meth:`encode`."""
        if self._is_encoder:
            return self.encode(tokens, *args, **kwargs)
        tokens = (tokens.to(self.device) if torch.is_tensor(tokens)
                  else torch.as_tensor(np.asarray(tokens), device=self.device))
        with torch.no_grad():
            return self.module.apply(self.params, tokens)

    __call__ = forward

    def _ids(self, a):
        if a is None:
            return None
        if torch.is_tensor(a):
            return a.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=self.device)

    def encode(self, input_ids, attention_mask=None, token_type_ids=None):
        """Encoder forward: ``(hidden [B,T,H], pooled [B,H] | None)``, the
        BertModel serving surface."""
        if not self._is_encoder:
            raise ValueError("encode() is for encoder models; use forward()")
        with torch.no_grad():
            return self.module.apply(self.params, self._ids(input_ids),
                                     self._ids(attention_mask),
                                     self._ids(token_type_ids))

    def mlm(self, input_ids, attention_mask=None, token_type_ids=None):
        """Masked-LM logits [B, T, V] (BertForMaskedLM serving surface)."""
        if not self._is_encoder or not self.module.cfg.with_mlm_head:
            raise ValueError("model has no MLM head (not an encoder, or "
                             "with_mlm_head=False)")
        hidden, _ = self.encode(input_ids, attention_mask, token_type_ids)
        with torch.no_grad():
            return self.module.mlm_logits(self.params, hidden)

    def classify(self, input_ids, attention_mask=None, token_type_ids=None):
        """Classification logits: sequence heads (Bert/Roberta/DistilBert
        ForSequenceClassification) [B, num_labels]; token heads
        (ForTokenClassification) [B, T, num_labels]; QA span heads
        (ForQuestionAnswering) [B, T, 2] (start/end on the last dim)."""
        if not self._is_encoder or not self.module.cfg.num_labels:
            raise ValueError("model has no classification head (not an "
                             "encoder, or num_labels=0)")
        hidden, pooled = self.encode(input_ids, attention_mask,
                                     token_type_ids)
        if self.module.cfg.cls_head not in ("token", "qa"):
            hidden = hidden[:, :1]      # sequence heads read [CLS] only
        with torch.no_grad():
            return self.module._classifier_head(self.params, hidden, pooled)

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
        if self._is_encoder:
            raise ValueError("generate() needs a causal LM; encoder models "
                             "serve via encode()/mlm()")
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
        """Replace the params with the leaves in ``path`` (one ``.npy`` or
        shard files a leaf, named by their dotted path, as a universal
        checkpoint's ``params`` directory holds them), each read into its
        current leaf's shape and dtype on this engine's device. Returns
        ``path``. A weight-quantized tree has no dense leaves to read into:
        build such an engine with ``config.checkpoint`` instead."""
        from ..runtime.checkpointing import _flatten, _load_tree

        if self.tp > 1:
            raise ValueError(
                "load_checkpoint reads whole leaves, and a tensor-parallel "
                "engine holds blocks; build the engine with "
                "config={'checkpoint': ...} instead")
        if any(isinstance(leaf, QuantTensor)
               for _, leaf in _flatten(self.params)):
            raise ValueError(
                "load_checkpoint reads dense leaves and this engine's "
                "weights are quantized; build the engine with "
                "config={'checkpoint': ...} instead")
        self.params = _load_tree(self.params, path, self.device)
        return path
