"""Causal transformer LM on PyTorch (GPT-2 / Llama / Mistral families).

Counterpart of ``deepspeed_tpu/models/transformer.py``. The config and the
param tree are the JAX package's, leaf for leaf: every ``params["layers"]``
leaf is stacked ``[L, ...]`` and linear weights are ``[in, out]`` used as
``x @ w``, so one set of weights converts one to one
(``models/weights.py``). The primitives are plain functions on tensors;
``CausalLM`` holds the config and the pieces the paged serving forward
(``inference/v2/paged_model.py``) is built from. ``lax.scan`` over layers
becomes a Python loop that hands each layer its static window.

``CausalLM.apply`` and ``CausalLM.loss`` (training and v1 prefill) run
attention through ``ops/flash_attention.py``: on CUDA tensors the
hand-written forward kernel, and under autograd its two backward kernels.

The v1 inference paths (``init_cache``/``prefill``/``decode_step`` over a
contiguous cache, ``init_paged_cache``/``prefill_paged``/
``decode_step_paged`` over a pool-layout cache; ``inference/engine.py``
runs the paged pair) write each layer's K/V into the cache in place and
return it. Prefill attends through ``_attention`` (the flash forward kernel
on the card), paged decode through ``ops/paged_attention.py``.

A param leaf may be a ``inference/quantization.QuantTensor`` (ZeRO-Inference
weight-only quantization). The model reaches one in three ways only:
``_weight(w, dtype)`` dequantizes a whole leaf (linear weights and biases,
norm weights, the unembedding), ``w[idx]`` gathers embedding rows and
dequantizes only them, and ``_scan_layers`` slices one QuantTensor a layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import not_ported, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_attention
from ..ops.quantizer import quantized_matmul


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None   # GQA; None => MHA
    max_seq_len: int = 1024
    # one global window (int) or a per-layer tuple (None/0 = full attention)
    sliding_window: Optional[Any] = None
    norm: str = "layernorm"              # "layernorm" | "rmsnorm"
    activation: str = "gelu"             # "gelu" | "gelu_exact" | "silu" | "relu"
    position: str = "learned"            # "learned" | "rope" | "alibi"
    rope_theta: float = 10000.0
    rope_pct: float = 1.0                # partial rotary (GPT-NeoX rotary_pct)
    rope_interleaved: bool = False       # GPT-J rotate_every_two pair layout
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    use_bias: bool = False
    qkv_bias: bool = False
    o_bias: Optional[bool] = None
    attn_scale: Optional[float] = None   # softmax scale; None → 1/√head_dim
    mlp_bias: Optional[bool] = None
    lm_head_bias: bool = False
    parallel_residual: bool = False
    shared_layernorm: bool = False
    embedding_layernorm: bool = False
    dropout: float = 0.0
    dtype: Any = torch.float32           # compute dtype
    remat: bool = False
    remat_policy: Optional[str] = None
    use_flash_attention: bool = True
    flash_block_q: int = 1024
    flash_block_kv: int = 1024
    attention_impl: str = "flash"
    sparse_pattern: str = "fixed"
    sparse_block: int = 64
    sparse_num_local_blocks: int = 4
    sparse_num_global_blocks: int = 1
    sparse_num_random_blocks: int = 1
    sparse_num_sliding_window_blocks: int = 3
    pipeline_microbatches: int = 0
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_min_capacity: int = 4
    moe_aux_loss_coef: float = 0.01
    moe_dropless: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def resolved_o_bias(self) -> bool:
        return self.use_bias if self.o_bias is None else self.o_bias

    @property
    def rot_dim(self) -> int:
        """Rotary dims per head (even; < head_dim for partial rotary)."""
        return int(self.head_dim * self.rope_pct) // 2 * 2

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer sliding windows, length num_layers; 0 = full."""
        sw = self.sliding_window
        if sw is None or isinstance(sw, int):
            return (int(sw or 0),) * self.num_layers
        if len(sw) != self.num_layers:
            raise ValueError(
                f"sliding_window tuple has {len(sw)} entries for "
                f"{self.num_layers} layers")
        return tuple(int(w or 0) for w in sw)

    def window_segments(self) -> Tuple[Tuple[int, int, int], ...]:
        """Contiguous (start, length, window) runs of equal window."""
        ws = self.layer_windows()
        segs = []
        start = 0
        for i in range(1, len(ws) + 1):
            if i == len(ws) or ws[i] != ws[start]:
                segs.append((start, i - start, ws[start]))
                start = i
        return tuple(segs)

    def num_params(self) -> int:
        h, m, v, L = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_layers)
        kvh = self.kv_heads * self.head_dim
        attn = h * h + 2 * h * kvh + h * h
        mlp = (3 if self.activation == "silu" else 2) * h * m
        if self.moe_num_experts > 0:
            mlp = mlp * self.moe_num_experts + h * self.moe_num_experts
        norms = (2 if self.norm == "rmsnorm" else 4) * h
        emb = v * h + (self.max_seq_len * h if self.position == "learned" else 0)
        head = 0 if self.tie_embeddings else v * h
        return L * (attn + mlp + norms) + emb + head + h


# Registered configurations (sizes follow the public model cards).
GPT2_125M = TransformerConfig()
LLAMA2_7B = TransformerConfig(vocab_size=32000, hidden_size=4096,
                              intermediate_size=11008, num_layers=32,
                              num_heads=32, num_kv_heads=32, max_seq_len=4096,
                              norm="rmsnorm", activation="silu",
                              position="rope", tie_embeddings=False,
                              norm_eps=1e-5, dtype=torch.bfloat16)
LLAMA2_70B = TransformerConfig(vocab_size=32000, hidden_size=8192,
                               intermediate_size=28672, num_layers=80,
                               num_heads=64, num_kv_heads=8, max_seq_len=4096,
                               norm="rmsnorm", activation="silu",
                               position="rope", tie_embeddings=False,
                               dtype=torch.bfloat16)
MISTRAL_7B = TransformerConfig(vocab_size=32000, hidden_size=4096,
                               intermediate_size=14336, num_layers=32,
                               num_heads=32, num_kv_heads=8, max_seq_len=8192,
                               norm="rmsnorm", activation="silu",
                               position="rope", tie_embeddings=False,
                               rope_theta=10000.0, sliding_window=4096,
                               dtype=torch.bfloat16)
QWEN2_7B = TransformerConfig(vocab_size=152064, hidden_size=3584,
                             intermediate_size=18944, num_layers=28,
                             num_heads=28, num_kv_heads=4, max_seq_len=32768,
                             norm="rmsnorm", activation="silu",
                             position="rope", rope_theta=1e6,
                             tie_embeddings=False, qkv_bias=True,
                             norm_eps=1e-6, dtype=torch.bfloat16)
OPT_1B3 = TransformerConfig(vocab_size=50272, hidden_size=2048,
                            intermediate_size=8192, num_layers=24,
                            num_heads=32, max_seq_len=2048,
                            norm="layernorm", activation="relu",
                            position="learned", tie_embeddings=True,
                            use_bias=True, dtype=torch.bfloat16)
GPTJ_6B = TransformerConfig(vocab_size=50400, hidden_size=4096,
                            intermediate_size=16384, num_layers=28,
                            num_heads=16, max_seq_len=2048,
                            norm="layernorm", activation="gelu",
                            position="rope", rope_pct=0.25,
                            rope_interleaved=True, parallel_residual=True,
                            shared_layernorm=True, tie_embeddings=False,
                            mlp_bias=True, lm_head_bias=True,
                            dtype=torch.bfloat16)
PHI_2 = TransformerConfig(vocab_size=51200, hidden_size=2560,
                          intermediate_size=10240, num_layers=32,
                          num_heads=32, max_seq_len=2048,
                          norm="layernorm", activation="gelu",
                          position="rope", rope_pct=0.4,
                          parallel_residual=True, shared_layernorm=True,
                          tie_embeddings=False, use_bias=True,
                          mlp_bias=True, lm_head_bias=True,
                          dtype=torch.bfloat16)
PYTHIA_1B4 = TransformerConfig(vocab_size=50304, hidden_size=2048,
                               intermediate_size=8192, num_layers=24,
                               num_heads=16, max_seq_len=2048,
                               norm="layernorm", activation="gelu_exact",
                               position="rope", rope_pct=0.25,
                               parallel_residual=True, tie_embeddings=False,
                               use_bias=True, dtype=torch.bfloat16)
BLOOM_560M = TransformerConfig(vocab_size=250880, hidden_size=1024,
                               intermediate_size=4096, num_layers=24,
                               num_heads=16, max_seq_len=2048,
                               norm="layernorm", activation="gelu",
                               position="alibi", embedding_layernorm=True,
                               tie_embeddings=True, use_bias=True,
                               dtype=torch.bfloat16)
FALCON_7B = TransformerConfig(vocab_size=65024, hidden_size=4544,
                              intermediate_size=18176, num_layers=32,
                              num_heads=71, num_kv_heads=1, max_seq_len=2048,
                              norm="layernorm", activation="gelu_exact",
                              position="rope", parallel_residual=True,
                              tie_embeddings=True, dtype=torch.bfloat16)
TINY_TEST = TransformerConfig(vocab_size=256, hidden_size=64,
                              intermediate_size=128, num_layers=2,
                              num_heads=4, num_kv_heads=2, max_seq_len=128,
                              norm="rmsnorm", activation="silu",
                              position="rope", tie_embeddings=True)


# ------------------------------------------------------------------ primitives

def _weight(w, dtype=None) -> torch.Tensor:
    """A param leaf as a tensor in ``dtype`` (``None``: its own dtype) — the
    JAX package's ``w.astype(dtype)``. A tensor is cast; a ``QuantTensor``
    (v1 weight-only quantization) is dequantized, which on the card is one
    launch of the dequantize kernel."""
    if torch.is_tensor(w):
        return w if dtype is None else w.to(dtype)
    return w.dequantize(dtype)


def _linear(x, w, b, dt):
    """x @ w (+ b) in compute dtype; b may be None. ``w`` may be a
    blockwise-quantized ``{"qw", "qs"}`` node (``weight_quant.py``): the
    product then runs from the quantized weight through
    ``ops/quantizer.quantized_matmul`` (the kernel on the card). A v1
    ``QuantTensor`` weight or bias is dequantized to ``dt`` first and then
    multiplied (or added), as in the JAX package."""
    if isinstance(w, dict):
        y = quantized_matmul(x, w["qw"], w["qs"], out_dtype=dt)
    else:
        y = x @ _weight(w, dt)
    return y if b is None else y + _weight(b, dt)


def _norm(x, w, b, kind: str, eps: float):
    dt = x.dtype
    x32 = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps) * _weight(w, torch.float32)
    else:
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
        y = ((x32 - mu) * torch.rsqrt(var + eps) * _weight(w, torch.float32)
             + _weight(b, torch.float32))
    return y.to(dt)


def rope_table(max_len: int, head_dim: int, theta: float,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [max_len, head_dim/2] in fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin, interleaved: bool = False):
    """x: [B, T, H, D]; cos/sin: [T, R/2] or [B, T, R/2] (per-sequence
    positions), R ≤ D (partial rotary leaves the trailing D−R dims as they
    are). ``interleaved``: GPT-J's rotate_every_two pairs (0,1),(2,3),…
    instead of the rotate_half (i, i+R/2) split."""
    rot = cos.shape[-1] * 2
    xr, x_pass = x[..., :rot], x[..., rot:]
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
    else:
        x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
    if cos.dim() == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    if interleaved:
        out = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    else:
        out = torch.cat([r1, r2], dim=-1)
    if x_pass.shape[-1]:
        out = torch.cat([out.to(x_pass.dtype), x_pass], dim=-1)
    return out.to(x.dtype)


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes (Press et al.)."""
    m = 2 ** math.floor(math.log2(num_heads))
    base = [2.0 ** (-8.0 * (i + 1) / m) for i in range(m)]
    if m < num_heads:
        base += [2.0 ** (-4.0 * (2 * i + 1) / m)
                 for i in range(num_heads - m)]
    return torch.tensor(base, dtype=torch.float32, device=device)


def attention_reference(q, k, v, causal: bool = True, mask=None, bias=None,
                        window: int = 0, scale=None):
    """Plain attention: q [B,T,H,D], k/v [B,S,KH,D].

    GQA is an einsum over the [KH, group] head factorization (no KV
    repeat). ``bias``: optional additive [H, S] logit bias (ALiBi: terms
    constant along a row cancel in the softmax, so slopes·key_position is
    enough). ``mask``: anything that broadcasts to [B, H, T, S]. ``window``
    > 0: sliding window (query p attends keys in (p − window, p]).
    """
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    group = H // KH
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    qg = q.reshape(B, T, KH, group, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scale
    if bias is not None:
        logits = logits + bias.reshape(KH, group, 1, S)[None]
    if window and not causal:
        raise ValueError("sliding window requires causal attention")
    if causal:
        qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
        kpos = torch.arange(S, device=q.device)[None, :]
        cmask = qpos >= kpos
        if window:
            cmask = cmask & (qpos - kpos < window)
        logits = torch.where(cmask, logits, torch.full_like(logits, -1e30))
    if mask is not None:
        m = torch.broadcast_to(torch.as_tensor(mask, device=q.device),
                               (B, H, T, S)).reshape(B, KH, group, T, S)
        logits = torch.where(m, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return o.reshape(B, T, H, D)


def _local_attention(q, k, v, cfg: "TransformerConfig", causal=True,
                     window=0):
    """Dense attention on one device. With ``use_flash_attention`` on and
    ``attention_impl`` other than "reference" it is ``flash_attention``:
    the kernels on a CUDA tensor, where an error is an error (the JAX
    package's ``try``/``except`` around its kernel is not carried over)."""
    if cfg.attention_impl == "sparse":
        raise not_ported("attention_impl='sparse' (ops/sparse_attention.py)",
                         "queue 1 item 17")
    if cfg.attention_impl == "ring":
        raise not_ported("attention_impl='ring' (sequence/ring_attention.py)",
                         "queue 1 item 14")
    if cfg.use_flash_attention and cfg.attention_impl != "reference" \
            and q.shape[1] == k.shape[1]:
        return flash_attention(q, k, v, causal=causal,
                               block_q=cfg.flash_block_q,
                               block_kv=cfg.flash_block_kv, window=window,
                               sm_scale=cfg.attn_scale)
    return attention_reference(q, k, v, causal=causal, window=window,
                               scale=cfg.attn_scale)


def _attention(q, k, v, cfg: "TransformerConfig", causal=True, window=0):
    """Dispatch by configuration, as the JAX ``_attention`` (:458) on one
    device: ALiBi models take the plain attention with the slopes·position
    bias (no kernel takes a bias there either, and the window is not passed,
    as at :480); everything else is ``_local_attention``. The sequence-mesh
    paths (Ulysses, ring) come with the distributed slice."""
    if cfg.position == "alibi":
        if cfg.attention_impl == "sparse":
            raise NotImplementedError(
                "attention_impl='sparse' does not support ALiBi models yet "
                "(the block-sparse op takes no logit bias)")
        S = k.shape[1]
        bias = alibi_slopes(cfg.num_heads, device=q.device)[:, None] \
            * torch.arange(S, device=q.device)[None, :]
        return attention_reference(q, k, v, causal=causal, bias=bias,
                                   scale=cfg.attn_scale)
    return _local_attention(q, k, v, cfg, causal, window=window)


_ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu,
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


# ------------------------------------------------------------------- the model

class CausalLM:
    """Causal LM over a plain dict of stacked tensors.

    Params layout (the JAX package's)::

        {"embed": {"wte": [V,H], ("wpe": [P,H]), ("ln_w", "ln_b")},
         "layers": {...stacked leaves, leading dim = num_layers...},
         "final_norm": {"w": [H], ("b": [H])},
         ("lm_head": {"w": [H,V], ("b": [V])})}
    """

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    # -- init ---------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None, device=None,
             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """Random weights with the layout of the JAX ``init`` (normal, std
        0.02; the output projections 0.02/√(2L); norms at 1, biases at 0).
        ``dtype`` is the storage type (default fp32, as the JAX package
        keeps params); ``_linear`` casts to ``cfg.dtype`` either way, so
        storing a bf16 model in bf16 halves its bytes. Each layer is drawn
        on its own, so no fp32 copy of a whole stacked leaf is ever made.
        ``generator`` must live on ``device``."""
        cfg = self.cfg
        if cfg.moe_num_experts > 0:
            raise not_ported("MoE layers", "queue 1 item 14")
        device = resolve_device(device)
        dtype = dtype or torch.float32
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        hd, nh, kvh, L = cfg.head_dim, cfg.num_heads, cfg.kv_heads, cfg.num_layers
        std = 0.02

        def normal(shape, scale=std):
            out = torch.empty(shape, dtype=dtype, device=device)
            rows = shape[0]
            step = max(1, (1 << 26) // max(1, math.prod(shape[1:])))
            for i in range(0, rows, step):
                n = min(step, rows - i)
                out[i:i + n] = (scale * torch.randn(
                    (n,) + tuple(shape[1:]), generator=generator,
                    device=device, dtype=torch.float32)).to(dtype)
            return out

        def layer_stack(shape, scale=std):
            out = torch.empty((L,) + shape, dtype=dtype, device=device)
            for i in range(L):
                out[i] = normal(shape, scale)
            return out

        def const(shape, value):
            return torch.full(shape, value, dtype=dtype, device=device)

        layers = {
            "attn_norm_w": const((L, h), 1.0),
            "wq": layer_stack((h, nh * hd)),
            "wk": layer_stack((h, kvh * hd)),
            "wv": layer_stack((h, kvh * hd)),
            "wo": layer_stack((nh * hd, h), scale=std / math.sqrt(2 * L)),
        }
        if not cfg.shared_layernorm:
            layers["mlp_norm_w"] = const((L, h), 1.0)
        layers["w_in"] = layer_stack((h, m))
        layers["w_out"] = layer_stack((m, h), scale=std / math.sqrt(2 * L))
        if cfg.activation == "silu":
            layers["w_gate"] = layer_stack((h, m))
        mlp_bias = cfg.use_bias if cfg.mlp_bias is None else cfg.mlp_bias
        if cfg.norm == "layernorm":
            layers["attn_norm_b"] = const((L, h), 0.0)
            if not cfg.shared_layernorm:
                layers["mlp_norm_b"] = const((L, h), 0.0)
        if cfg.use_bias or cfg.qkv_bias:
            layers["wq_b"] = const((L, nh * hd), 0.0)
            layers["wk_b"] = const((L, kvh * hd), 0.0)
            layers["wv_b"] = const((L, kvh * hd), 0.0)
        if cfg.resolved_o_bias:
            layers["wo_b"] = const((L, h), 0.0)
        if mlp_bias:
            layers["w_in_b"] = const((L, m), 0.0)
            layers["w_out_b"] = const((L, h), 0.0)
            if cfg.activation == "silu":
                layers["w_gate_b"] = const((L, m), 0.0)

        params = {"embed": {"wte": normal((v, h))}, "layers": layers,
                  "final_norm": {"w": const((h,), 1.0)}}
        if cfg.position == "learned":
            params["embed"]["wpe"] = normal((cfg.max_seq_len, h))
        if cfg.embedding_layernorm:
            params["embed"]["ln_w"] = const((h,), 1.0)
            if cfg.norm == "layernorm":
                params["embed"]["ln_b"] = const((h,), 0.0)
        if cfg.norm == "layernorm":
            params["final_norm"]["b"] = const((h,), 0.0)
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": normal((h, v))}
            if cfg.lm_head_bias:
                params["lm_head"]["b"] = const((v,), 0.0)
        return params

    # -- one transformer block ---------------------------------------------
    def _qkv(self, h1, lp, cos, sin, B, T):
        cfg = self.cfg
        nh, kvh, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        dt = cfg.dtype
        q = _linear(h1, lp["wq"], lp.get("wq_b"), dt).reshape(B, T, nh, hd)
        k = _linear(h1, lp["wk"], lp.get("wk_b"), dt).reshape(B, T, kvh, hd)
        v = _linear(h1, lp["wv"], lp.get("wv_b"), dt).reshape(B, T, kvh, hd)
        if cfg.position == "rope":
            q = apply_rope(q, cos, sin, cfg.rope_interleaved)
            k = apply_rope(k, cos, sin, cfg.rope_interleaved)
        return q, k, v

    def _block(self, x, lp, cos, sin, window=0):
        return self._block_kv(x, lp, cos, sin, window)[0]

    def _block_kv(self, x, lp, cos, sin, window=0):
        """Forward block that also returns this layer's K/V (for prefill)."""
        cfg = self.cfg
        B, T, _ = x.shape
        h1 = _norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"), cfg.norm,
                   cfg.norm_eps)
        q, k, v = self._qkv(h1, lp, cos, sin, B, T)
        attn = _attention(q, k, v, cfg, causal=True, window=window)
        attn = _linear(attn.reshape(B, T, -1), lp["wo"], lp.get("wo_b"),
                       cfg.dtype)
        return self._attn_mlp_merge(x, attn, lp, h1), k, v

    # -- forward ------------------------------------------------------------
    def apply(self, params, tokens, rng=None, deterministic: bool = True,
              positions=None, return_aux: bool = False):
        """tokens [B, T] integers → logits [B, T, V] (in compute dtype).
        With ``return_aux``, returns (logits, moe_aux_loss); the aux loss is
        0 for the dense models the port runs. ``cfg.remat`` recomputes each
        block in the backward (``torch.utils.checkpoint``; the
        ``remat_policy`` names of ``jax.checkpoint`` have no counterpart and
        every policy recomputes the whole block). Differentiable in the
        param tree's leaves."""
        cfg = self.cfg
        if cfg.moe_num_experts > 0:
            raise not_ported("MoE layers", "queue 1 item 14")
        if cfg.dropout > 0 and not deterministic:
            raise not_ported("dropout in CausalLM.apply (the masks would "
                             "have to equal jax.random's)",
                             "queue 1 item 17")
        if cfg.pipeline_microbatches:
            raise not_ported("pipeline parallelism", "queue 1 item 14")
        B, T = tokens.shape
        dev = tokens.device
        x = self._embed(params, tokens)
        cos = sin = None
        if cfg.position == "rope":
            cos_full, sin_full = rope_table(cfg.max_seq_len, cfg.rot_dim,
                                            cfg.rope_theta, device=dev)
            if positions is not None:
                positions = positions.long()
                cos, sin = cos_full[positions], sin_full[positions]
            else:
                cos, sin = cos_full[:T], sin_full[:T]
        elif cfg.position == "learned":
            pos = positions.long() if positions is not None \
                else torch.arange(T, device=dev)
            x = x + params["embed"]["wpe"][pos].to(cfg.dtype)

        def block_for(window):
            def block(x, lp, layer):
                if cfg.remat and torch.is_grad_enabled():
                    from torch.utils.checkpoint import checkpoint

                    return checkpoint(self._block, x, lp, cos, sin, window,
                                      use_reentrant=False)
                return self._block(x, lp, cos, sin, window)
            return block

        x = self._scan_layers(block_for, x, params["layers"])
        x = _norm(x, params["final_norm"]["w"], params["final_norm"].get("b"),
                  cfg.norm, cfg.norm_eps)
        logits = self._unembed(params, x)
        if return_aux:
            return logits, torch.zeros((), dtype=torch.float32, device=dev)
        return logits

    # -- loss ---------------------------------------------------------------
    def loss(self, params, batch, rng=None):
        """batch: {"input_ids": [B,T]} (labels = shifted inputs) or
        {"input_ids", "labels"(, "loss_mask")}. Returns the mean token NLL
        (fp32 scalar)."""
        tokens = batch["input_ids"]
        labels = batch.get("labels")
        if labels is None:
            labels = tokens[:, 1:]
            tokens = tokens[:, :-1]
        mask = batch.get("loss_mask")
        logits, _ = self.apply(params, tokens, rng=rng,
                               deterministic=rng is None, return_aux=True)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = logz - gold
        if mask is not None:
            mask = mask.to(nll.dtype)
            return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
        return torch.mean(nll)

    def num_params(self) -> int:
        return self.cfg.num_params()

    def _mlp_body(self, h2, lp):
        """Dense FFN on normed input (SwiGLU for silu; gelu is the tanh
        approximation, gelu_exact the erf form)."""
        cfg = self.cfg
        dt = cfg.dtype
        if cfg.activation == "silu":
            y = F.silu(_linear(h2, lp["w_gate"], lp.get("w_gate_b"), dt)) \
                * _linear(h2, lp["w_in"], lp.get("w_in_b"), dt)
        else:
            act = _ACTIVATIONS.get(cfg.activation, _ACTIVATIONS["gelu"])
            y = act(_linear(h2, lp["w_in"], lp.get("w_in_b"), dt))
        return _linear(y, lp["w_out"], lp.get("w_out_b"), dt)

    def _scan_layers(self, body_for_window: Callable, carry,
                     layer_params: Dict[str, torch.Tensor]):
        """The counterpart of ``lax.scan`` over the stacked layer dim: a loop
        that hands layer ``i`` its params ``{k: v[i]}`` (both members of a
        quantized ``{"qw", "qs"}`` node sliced; a ``QuantTensor`` sliced
        into one QuantTensor a layer, with the same block, bits, packing and
        ``out_dtype``), its index, and the body built for its static window.
        Returns the final carry. Each stacked leaf is unbound once (views,
        no copies), so that under autograd its gradient is assembled by one
        ``stack`` instead of one full-size scatter per layer."""
        def unbound(v):
            return {k: t.unbind(0) for k, t in v.items()} \
                if isinstance(v, dict) else v.unbind(0)

        def at(v, i):
            return {k: t[i] for k, t in v.items()} if isinstance(v, dict) \
                else v[i]

        layers = {k: unbound(v) for k, v in layer_params.items()}
        for i, win in enumerate(self.cfg.layer_windows()):
            lp = {k: at(v, i) for k, v in layers.items()}
            carry = body_for_window(win)(carry, lp, i)
        return carry

    def _unembed(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            # a QuantTensor table dequantizes to its own dtype, then casts
            # (JAX: ``wte.T.astype(dtype)``)
            return x @ _weight(params["embed"]["wte"]).t().to(cfg.dtype)
        w = params["lm_head"]["w"]
        if isinstance(w, dict):         # quantized lm_head: as _linear
            y = quantized_matmul(x, w["qw"], w["qs"], out_dtype=cfg.dtype)
        else:
            y = x @ _weight(w, cfg.dtype)
        if "b" in params.get("lm_head", {}):
            y = y + _weight(params["lm_head"]["b"], cfg.dtype)
        return y

    def _attn_mlp_merge(self, x, attn_out, lp, h1=None):
        """Residual wiring: sequential (mlp reads post-attention), parallel
        (both branches read x), or shared-layernorm parallel (GPT-J: the
        mlp reads the same normed h1 the attention read)."""
        cfg = self.cfg
        if cfg.shared_layernorm:
            return x + attn_out + self._mlp_body(h1, lp)
        mlp_in = x if cfg.parallel_residual else x + attn_out
        h2 = _norm(mlp_in, lp["mlp_norm_w"], lp.get("mlp_norm_b"), cfg.norm,
                   cfg.norm_eps)
        return x + attn_out + self._mlp_body(h2, lp)

    # -- KV-cache inference (v1): the cache is written in place ---------------
    def _pos_tables(self, T, positions, device):
        """RoPE cos/sin for positions ``0..T-1`` (``positions`` None) or for
        ``positions``; None for models without RoPE."""
        cfg = self.cfg
        if cfg.position != "rope":
            return None, None
        cos_full, sin_full = rope_table(cfg.max_seq_len, cfg.rot_dim,
                                        cfg.rope_theta, device=device)
        if positions is not None:
            positions = positions.long()
            return cos_full[positions], sin_full[positions]
        return cos_full[:T], sin_full[:T]

    def _embed(self, params, tokens):
        """Token embeddings in the compute dtype, with the embedding
        LayerNorm where the model has one. A QuantTensor table dequantizes
        only the gathered rows (to its own dtype, then cast)."""
        cfg = self.cfg
        x = params["embed"]["wte"][tokens.long()].to(cfg.dtype)
        if cfg.embedding_layernorm:
            x = _norm(x, params["embed"]["ln_w"], params["embed"].get("ln_b"),
                      cfg.norm, cfg.norm_eps)
        return x

    def init_cache(self, batch_size: int, max_len: int, device=None):
        """Contiguous KV cache ``{"k", "v"}``, each [L, B, max_len, KH, D] in
        the compute dtype."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, max_len, cfg.kv_heads,
                 cfg.head_dim)
        device = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

    def _prefill_impl(self, params, tokens, cache, write_kv):
        """Shared prompt processing: embed, the layer loop (each layer hands
        its K/V to ``write_kv(layer, k, v)``, which writes them into
        ``cache`` in place), final norm, logits. The contiguous and paged
        caches differ only in the write."""
        cfg = self.cfg
        B, T = tokens.shape
        dev = tokens.device
        x = self._embed(params, tokens)
        cos, sin = self._pos_tables(T, None, dev)
        if cfg.position == "learned":
            x = x + params["embed"]["wpe"][torch.arange(T, device=dev)].to(
                cfg.dtype)

        def body_for(win):
            def body(x, lp, layer):
                x, k, v = self._block_kv(x, lp, cos, sin, window=win)
                write_kv(layer, k, v)
                return x
            return body

        x = self._scan_layers(body_for, x, params["layers"])
        x = _norm(x, params["final_norm"]["w"], params["final_norm"].get("b"),
                  cfg.norm, cfg.norm_eps)
        return self._unembed(params, x), cache

    def prefill(self, params, tokens, cache):
        """Process a full prompt [B, T], filling ``cache[:, :, :T]``.
        Returns (logits [B, T, V], cache)."""
        def write(layer, k, v):
            T = k.shape[1]
            cache["k"][layer, :, :T] = k
            cache["v"][layer, :, :T] = v

        return self._prefill_impl(params, tokens, cache, write)

    def decode_step(self, params, cache, tokens, pos: int):
        """One decode step: tokens [B] at position ``pos`` (an int). Returns
        (logits [B, V], cache)."""
        cfg = self.cfg
        S = cache["k"].shape[2]
        dev = tokens.device
        pos = int(pos)
        x = self._embed(params, tokens)[:, None, :]                 # [B,1,H]
        at = torch.tensor([pos], device=dev)
        cos, sin = self._pos_tables(1, at, dev)
        if cfg.position == "learned":
            x = x + params["embed"]["wpe"][at].to(cfg.dtype)

        def body_for(win):
            def body(x, lp, layer):
                return self._block_decode(x, lp, cache["k"][layer],
                                          cache["v"][layer], cos, sin, pos, S,
                                          window=win)
            return body

        x = self._scan_layers(body_for, x, params["layers"])
        x = _norm(x, params["final_norm"]["w"], params["final_norm"].get("b"),
                  cfg.norm, cfg.norm_eps)
        return self._unembed(params, x)[:, 0], cache

    def _block_decode(self, x, lp, kc, vc, cos, sin, pos, S, window=0):
        """Decode block: one token attends over the contiguous cache ``kc``,
        ``vc`` [B, S, KH, D] of its layer, after writing its own K/V at
        ``pos`` (clamped into the cache, as ``dynamic_update_slice``
        does)."""
        cfg = self.cfg
        B = x.shape[0]
        h1 = _norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"), cfg.norm,
                   cfg.norm_eps)
        q, k, v = self._qkv(h1, lp, cos, sin, B, 1)
        at = min(max(pos, 0), S - 1)
        kc[:, at] = k[:, 0]
        vc[:, at] = v[:, 0]
        kpos = torch.arange(S, device=x.device)
        keep = kpos <= pos
        if window:
            keep = keep & (pos - kpos < window)
        bias = None
        if cfg.position == "alibi":
            bias = alibi_slopes(cfg.num_heads, device=x.device)[:, None] \
                * kpos[None, :]
        attn = attention_reference(q, kc, vc, causal=False,
                                   mask=keep[None, None, None, :], bias=bias,
                                   scale=cfg.attn_scale)
        attn = _linear(attn.reshape(B, 1, -1), lp["wo"], lp.get("wo_b"),
                       cfg.dtype)
        return self._attn_mlp_merge(x, attn, lp, h1)

    # -- paged KV-cache inference (v1 decode through the paged kernel) --------
    def init_paged_cache(self, batch_size: int, max_len: int,
                         block_size: int = 128, device=None):
        """Pool-layout KV cache ``{"k", "v"}``, each [L, B·NB, KH, bs, D],
        with sequence b owning the contiguous block range [b·NB, (b+1)·NB).
        Returns (cache, tables [B, NB] int32)."""
        cfg = self.cfg
        device = resolve_device(device)
        nb = -(-max_len // block_size)
        shape = (cfg.num_layers, batch_size * nb, cfg.kv_heads, block_size,
                 cfg.head_dim)
        tables = torch.arange(batch_size * nb, dtype=torch.int32,
                              device=device).reshape(batch_size, nb)
        return ({"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                 "v": torch.zeros(shape, dtype=cfg.dtype, device=device)},
                tables)

    def prefill_paged(self, params, tokens, prompt_len, cache, tables):
        """Ragged prefill: ``tokens`` [B, T] right-padded, ``prompt_len``
        [B]. Causal attention over the padded batch: pad positions write
        K/V that decode overwrites before any query attends them (the paged
        kernel's per-sequence context keeps them dead). Returns (logits
        [B, T, V], cache)."""
        cfg = self.cfg
        B, T = tokens.shape
        bs = cache["k"].shape[3]
        pos = torch.arange(T, device=tokens.device)
        blk = tables.long()[:, pos // bs]                            # [B, T]
        write_blk = blk.reshape(-1)
        write_off = (pos % bs).repeat(B)

        def write(layer, k, v):
            cache["k"][layer][write_blk, :, write_off, :] = k.reshape(
                B * T, cfg.kv_heads, cfg.head_dim)
            cache["v"][layer][write_blk, :, write_off, :] = v.reshape(
                B * T, cfg.kv_heads, cfg.head_dim)

        return self._prefill_impl(params, tokens, cache, write)

    def decode_step_paged(self, params, cache, tables, tokens, pos):
        """One ragged decode step: ``tokens`` [B] at per-sequence positions
        ``pos`` [B]. Attention runs through ``ops/paged_attention`` (the
        hand-written kernel on the card), over each sequence's live context
        only. Returns (logits [B, V], cache)."""
        cfg = self.cfg
        B = tokens.shape[0]
        bs = cache["k"].shape[3]
        dev = tokens.device
        x = self._embed(params, tokens)[:, None, :]
        pos = torch.as_tensor(pos, device=dev).to(torch.int32)
        cos, sin = self._pos_tables(1, pos, dev)
        if cfg.position == "rope":
            cos, sin = cos[:, None, :], sin[:, None, :]    # per-seq [B,1,R/2]
        if cfg.position == "learned":
            x = x + params["embed"]["wpe"][pos.long()][:, None, :].to(
                cfg.dtype)
        slopes = (alibi_slopes(cfg.num_heads, device=dev)
                  if cfg.position == "alibi" else None)
        write_blk = torch.gather(tables.long(), 1,
                                 (pos.long() // bs)[:, None])[:, 0]    # [B]
        write_off = pos.long() % bs
        n_tok = torch.ones((B,), dtype=torch.int32, device=dev)

        def body_for(win):
            def body(x, lp, layer):
                kc, vc = cache["k"][layer], cache["v"][layer]
                h1 = _norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"),
                           cfg.norm, cfg.norm_eps)
                q, k, v = self._qkv(h1, lp, cos, sin, B, 1)
                kc[write_blk, :, write_off, :] = k[:, 0]
                vc[write_blk, :, write_off, :] = v[:, 0]
                attn = paged_attention(q, kc, vc, tables, pos, n_tok,
                                       alibi_slopes=slopes, window=win,
                                       sm_scale=cfg.attn_scale)
                attn = _linear(attn.reshape(B, 1, -1), lp["wo"],
                               lp.get("wo_b"), cfg.dtype)
                return self._attn_mlp_merge(x, attn, lp, h1)
            return body

        x = self._scan_layers(body_for, x, params["layers"])
        x = _norm(x, params["final_norm"]["w"], params["final_norm"].get("b"),
                  cfg.norm, cfg.norm_eps)
        return self._unembed(params, x)[:, 0], cache
