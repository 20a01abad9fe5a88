"""Bidirectional encoder (BERT family) on PyTorch.

Counterpart of ``deepspeed_tpu/models/encoder.py``: the same config, the
same param tree leaf for leaf (stacked ``[L, ...]`` layer leaves, ``[in,
out]`` linear weights), the same forward. ``lax.scan`` over the layers
becomes a Python loop.

Architecture notes against ``transformer.CausalLM``:

- **post-LN** residual wiring (``h = LN(x + sub(x))``): the residual stream
  is normalized after each sublayer.
- **bidirectional** attention with a key-padding mask (HF
  ``attention_mask`` semantics: 1 = attend) through the plain
  ``attention_reference(causal=False, mask=...)``, as the JAX model calls
  it; no kernel sits there in either package.
- learned positions + token-type embeddings + embedding LayerNorm.
- heads: the tanh pooler over [CLS], the masked-LM transform head with the
  decoder tied to the word embeddings (or its own), and the classifier
  heads of the HF task models.

A param leaf may be a v1 ``QuantTensor``: linear weights, biases and norm
weights dequantize at their use (``transformer._weight``), embedding rows
through a row gather.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..parallel.sharding import spec
from .transformer import _linear, _norm, _weight, attention_reference


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    type_vocab_size: int = 2             # 0 = no token types (DistilBERT)
    norm_eps: float = 1e-12
    activation: str = "gelu_exact"  # gelu_exact | gelu_new | relu | silu
    with_pooler: bool = True
    with_mlm_head: bool = False
    tie_mlm_decoder: bool = True         # False: distinct decoder weight
    num_labels: int = 0                  # >0: classification head
    # head anatomy: "pooled" = linear on the tanh pooler output (BERT);
    # "roberta" = dense+tanh+out_proj on hidden[:, 0] (no pooler);
    # "distilbert" = pre_classifier+ReLU+classifier on hidden[:, 0];
    # "token" = per-token linear (ForTokenClassification, [B, T, L]);
    # "qa" = per-token span linear (ForQuestionAnswering, L=2 start/end)
    cls_head: str = "pooled"
    # RoBERTa offsets positions by pad_token_id+1 (fairseq legacy)
    position_offset: int = 0
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        h, m, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = 4 * h * h + 4 * h + 2 * h * m + m + h + 4 * h
        emb = (v + self.max_seq_len + self.position_offset
               + self.type_vocab_size) * h + 2 * h
        pool = (h * h + h) if self.with_pooler else 0
        mlm = (h * h + h + 2 * h + v) if self.with_mlm_head else 0
        if self.with_mlm_head and not self.tie_mlm_decoder:
            mlm += h * v
        cls = (h * self.num_labels + self.num_labels) if self.num_labels \
            else 0
        if self.num_labels and self.cls_head in ("roberta", "distilbert"):
            cls += h * h + h                 # the extra dense layer
        return self.num_layers * per_layer + emb + pool + mlm + cls


BERT_BASE = EncoderConfig()
BERT_LARGE = EncoderConfig(hidden_size=1024, intermediate_size=4096,
                           num_layers=24, num_heads=16)

_ACTIVATIONS = {
    "gelu_exact": lambda y: F.gelu(y, approximate="none"),
    "gelu_new": lambda y: F.gelu(y, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


class EncoderLM:
    """Functional bidirectional encoder. ``init(generator) -> params``;
    ``apply(params, tokens, attention_mask, token_type_ids) ->
    (hidden [B,T,H], pooled [B,H] | None)``; ``mlm_logits(params, hidden)
    -> [B,T,V]`` when the MLM head is configured."""

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg

    # -- init ---------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None, device=None,
             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """Random weights with the layout of the JAX ``init`` (normal, std
        0.02; the output projections 0.02/sqrt(2L); norms at 1, biases at
        0), stored in ``dtype`` (default fp32). ``generator`` must live on
        ``device`` (a CPU generator draws meta tensors)."""
        cfg = self.cfg
        device = resolve_device(device)
        dtype = dtype or torch.float32
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        h, m, v, L = (cfg.hidden_size, cfg.intermediate_size,
                      cfg.vocab_size, cfg.num_layers)
        std = 0.02

        def normal(shape, scale=std):
            return (scale * torch.randn(shape, generator=generator,
                                        device=device,
                                        dtype=torch.float32)).to(dtype)

        def const(shape, value):
            return torch.full(shape, value, dtype=dtype, device=device)

        layers = {
            "wq": normal((L, h, h)),
            "wk": normal((L, h, h)),
            "wv": normal((L, h, h)),
            "wo": normal((L, h, h), scale=std / math.sqrt(2 * L)),
            "w_in": normal((L, h, m)),
            "w_out": normal((L, m, h), scale=std / math.sqrt(2 * L)),
            "attn_ln_w": const((L, h), 1.0),
            "attn_ln_b": const((L, h), 0.0),
            "mlp_ln_w": const((L, h), 1.0),
            "mlp_ln_b": const((L, h), 0.0),
        }
        for name, dim in (("wq_b", h), ("wk_b", h), ("wv_b", h),
                          ("wo_b", h), ("w_in_b", m), ("w_out_b", h)):
            layers[name] = const((L, dim), 0.0)
        params = {
            "embed": {
                "wte": normal((v, h)),
                "wpe": normal((cfg.max_seq_len + cfg.position_offset, h)),
                "ln_w": const((h,), 1.0),
                "ln_b": const((h,), 0.0),
            },
            "layers": layers,
        }
        if cfg.type_vocab_size > 0:
            params["embed"]["tte"] = normal((cfg.type_vocab_size, h))
        if cfg.with_pooler:
            params["pooler"] = {"w": normal((h, h)), "b": const((h,), 0.0)}
        if cfg.with_mlm_head:
            params["mlm"] = {"w": normal((h, h)), "b": const((h,), 0.0),
                             "ln_w": const((h,), 1.0),
                             "ln_b": const((h,), 0.0),
                             "bias": const((v,), 0.0)}
            if not cfg.tie_mlm_decoder:
                params["mlm"]["decoder"] = normal((h, v))
        if cfg.num_labels:
            params["classifier"] = {"w": normal((h, cfg.num_labels)),
                                    "b": const((cfg.num_labels,), 0.0)}
            if cfg.cls_head in ("roberta", "distilbert"):
                params["classifier"]["dense_w"] = normal((h, h))
                params["classifier"]["dense_b"] = const((h,), 0.0)
        return params

    # -- sharding specs -----------------------------------------------------
    def param_specs(self) -> Dict[str, Any]:
        """Logical-axis spec tree mirroring ``init`` (the causal family's
        TP rules: column QKV/MLP-in, row proj/MLP-out)."""
        cfg = self.cfg
        layers = {
            "wq": spec("layers", "embed", "heads"),
            "wk": spec("layers", "embed", "heads"),
            "wv": spec("layers", "embed", "heads"),
            "wo": spec("layers", "heads", "embed"),
            "w_in": spec("layers", "embed", "mlp"),
            "w_out": spec("layers", "mlp", "embed"),
            "attn_ln_w": spec("layers", "embed"),
            "attn_ln_b": spec("layers", "embed"),
            "mlp_ln_w": spec("layers", "embed"),
            "mlp_ln_b": spec("layers", "embed"),
            "wq_b": spec("layers", "heads"),
            "wk_b": spec("layers", "heads"),
            "wv_b": spec("layers", "heads"),
            "wo_b": spec("layers", "embed"),
            "w_in_b": spec("layers", "mlp"),
            "w_out_b": spec("layers", "embed"),
        }
        specs = {
            "embed": {"wte": spec("vocab", "embed"),
                      "wpe": spec(None, "embed"),
                      "ln_w": spec("embed"), "ln_b": spec("embed")},
            "layers": layers,
        }
        if cfg.type_vocab_size > 0:
            specs["embed"]["tte"] = spec(None, "embed")
        if cfg.with_pooler:
            specs["pooler"] = {"w": spec("embed", "embed"),
                               "b": spec("embed")}
        if cfg.with_mlm_head:
            specs["mlm"] = {"w": spec("embed", "embed"), "b": spec("embed"),
                            "ln_w": spec("embed"), "ln_b": spec("embed"),
                            "bias": spec("vocab")}
            if not cfg.tie_mlm_decoder:
                specs["mlm"]["decoder"] = spec("embed", "vocab")
        if cfg.num_labels:
            specs["classifier"] = {"w": spec("embed", None),
                                   "b": spec(None)}
            if cfg.cls_head in ("roberta", "distilbert"):
                specs["classifier"]["dense_w"] = spec("embed", "embed")
                specs["classifier"]["dense_b"] = spec("embed")
        return specs

    # -- forward ------------------------------------------------------------
    def _act(self, y):
        act = self.cfg.activation
        if act not in _ACTIVATIONS:
            raise ValueError(f"unknown encoder activation {act!r}")
        return _ACTIVATIONS[act](y)

    def apply(self, params, tokens, attention_mask=None, token_type_ids=None):
        """tokens [B, T] int; ``attention_mask`` [B, T] (1 = attend, HF
        semantics; None = all live); ``token_type_ids`` [B, T] (None = 0).
        Returns ``(hidden [B, T, H], pooled [B, H] or None)``."""
        cfg = self.cfg
        B, T = tokens.shape
        if T > cfg.max_seq_len:
            raise ValueError(f"sequence length {T} > max_seq_len "
                             f"{cfg.max_seq_len} (JAX would silently clamp "
                             "the position gather)")
        dt = cfg.dtype
        nh, hd = cfg.num_heads, cfg.head_dim
        dev = tokens.device
        tokens = tokens.long()
        emb = params["embed"]

        if cfg.position_offset:
            # RoBERTa (fairseq legacy): live token i gets position (number
            # of live tokens up to i) + padding_idx, pads get padding_idx
            live = (attention_mask if attention_mask is not None
                    else torch.ones((B, T), dtype=torch.int32, device=dev)
                    ).to(torch.int32)
            pad_idx = cfg.position_offset - 1
            pos = torch.cumsum(live, dim=1) * live + pad_idx     # [B, T]
            pe = emb["wpe"][pos.long()]
        else:
            pe = emb["wpe"][torch.arange(T, device=dev)][None]
        x = emb["wte"][tokens] + pe
        if cfg.type_vocab_size > 0:
            tt = (token_type_ids.long() if token_type_ids is not None
                  else torch.zeros((B, T), dtype=torch.long, device=dev))
            x = x + emb["tte"][tt]
        elif token_type_ids is not None:
            raise ValueError("model has no token-type embeddings "
                             "(type_vocab_size=0)")
        x = _norm(x.to(dt), emb["ln_w"], emb["ln_b"], "layernorm",
                  cfg.norm_eps)

        # key-padding mask [B, 1, 1, T], broadcast over (head, q)
        mask = None
        if attention_mask is not None:
            mask = attention_mask.to(torch.bool)[:, None, None, :]

        layers = {k: v.unbind(0) for k, v in params["layers"].items()}
        for i in range(cfg.num_layers):
            lp = {k: v[i] for k, v in layers.items()}
            q = _linear(x, lp["wq"], lp["wq_b"], dt).reshape(B, T, nh, hd)
            k = _linear(x, lp["wk"], lp["wk_b"], dt).reshape(B, T, nh, hd)
            v = _linear(x, lp["wv"], lp["wv_b"], dt).reshape(B, T, nh, hd)
            attn = attention_reference(q, k, v, causal=False, mask=mask)
            attn = _linear(attn.reshape(B, T, nh * hd), lp["wo"],
                           lp["wo_b"], dt)
            h = _norm(x + attn, lp["attn_ln_w"], lp["attn_ln_b"],
                      "layernorm", cfg.norm_eps)
            y = self._act(_linear(h, lp["w_in"], lp["w_in_b"], dt))
            y = _linear(y, lp["w_out"], lp["w_out_b"], dt)
            x = _norm(h + y, lp["mlp_ln_w"], lp["mlp_ln_b"], "layernorm",
                      cfg.norm_eps)

        pooled = None
        if cfg.with_pooler and "pooler" in params:
            pooled = torch.tanh(_linear(x[:, 0], params["pooler"]["w"],
                                        params["pooler"]["b"], dt))
        return x, pooled

    def mlm_logits(self, params, hidden):
        """Masked-LM head on encoder output (``cls.predictions``): dense ->
        activation -> LayerNorm -> decoder tied to wte (+ output bias)."""
        cfg = self.cfg
        if "mlm" not in params:
            raise ValueError("model built without with_mlm_head=True")
        mp = params["mlm"]
        h = self._act(_linear(hidden, mp["w"], mp["b"], cfg.dtype))
        h = _norm(h, mp["ln_w"], mp["ln_b"], "layernorm", cfg.norm_eps)
        dec = (_weight(params["embed"]["wte"]).t() if "decoder" not in mp
               else _weight(mp["decoder"]))
        return h @ dec.to(cfg.dtype) + _weight(mp["bias"], cfg.dtype)

    def _classifier_head(self, params, hidden, pooled):
        """-> logits (dropout is eval-off). Sequence styles ("pooled"/
        "roberta"/"distilbert") -> [B, num_labels]; per-token styles
        ("token"/"qa") -> [B, T, num_labels]."""
        cp = params["classifier"]
        style = self.cfg.cls_head
        dt = self.cfg.dtype
        if style in ("token", "qa"):
            return _linear(hidden, cp["w"], cp["b"], dt)
        if style == "roberta":
            x = torch.tanh(_linear(hidden[:, 0], cp["dense_w"],
                                   cp["dense_b"], dt))
        elif style == "distilbert":
            x = F.relu(_linear(hidden[:, 0], cp["dense_w"], cp["dense_b"],
                               dt))
        else:
            if pooled is None:
                raise ValueError("classification head needs the pooler")
            x = pooled
        return _linear(x, cp["w"], cp["b"], dt)

    def classify(self, params, tokens, attention_mask=None,
                 token_type_ids=None):
        """Classification logits (``[B, num_labels]``, or ``[B, T,
        num_labels]`` for the token and QA heads)."""
        cfg = self.cfg
        if not cfg.num_labels or "classifier" not in params:
            raise ValueError("model built without num_labels")
        hidden, pooled = self.apply(params, tokens, attention_mask,
                                    token_type_ids)
        return self._classifier_head(params, hidden, pooled)

    def num_params(self) -> int:
        return self.cfg.num_params()
