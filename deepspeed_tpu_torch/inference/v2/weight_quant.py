"""int8/fp8 weight serving for the v2 ragged engine, on PyTorch.

Counterpart of ``deepspeed_tpu/inference/v2/weight_quant.py``. Each
quantized matmul weight ``w[..., in, out]`` becomes a two-leaf node
``{"qw": int8/float8_e4m3fn [..., in, out], "qs": f32 [..., in, out/B]}``
(blockwise scales along the output dim, ``ops/quantizer.py`` format).
``models/transformer._linear`` and ``_unembed`` dispatch on the node: a dict
weight runs through ``quantized_matmul`` (the hand-written kernel on the
card), a tensor weight takes ``x @ w``.

Only the dense matmul whitelist quantizes: ``wq``/``wk``/``wv``/``wo``,
``w_in``/``w_out``/``w_gate`` and the untied ``lm_head``. Embeddings, norms
and biases never do; ``skip`` prunes the whitelist by name. The engine
quantizes once, at build, on the engine's device: a stacked ``[L, in, out]``
leaf is one ``quantize_blockwise`` call (one kernel launch on the card).

Tensor parallelism (``tp > 1`` and ``expand_spec_tree``) waits for the
distributed slice (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from ... import not_ported
from ...ops.quantizer import choose_block, quantize_blockwise

WEIGHT_SUPPORTED_DTYPES = ("int8", "fp8_e4m3")

QUANTIZABLE_LAYER_LEAVES = ("wq", "wk", "wv", "wo",
                            "w_in", "w_out", "w_gate")

# listed for the config's self-documentation: both are also structurally
# not quantizable here
DEFAULT_SKIP = ("embed", "final_norm")


def validate_weight_quant(dtype: str, block: int) -> None:
    """Reject configurations this implementation does not encode."""
    if dtype not in WEIGHT_SUPPORTED_DTYPES:
        raise ValueError(f"weight_quant.dtype {dtype!r} not supported "
                         f"(implemented: {WEIGHT_SUPPORTED_DTYPES})")
    if int(block) < 1:
        raise ValueError(f"weight_quant.block must be >= 1, got {block}")


def is_quantized(leaf) -> bool:
    """True for the two-leaf quantized-weight node this module emits."""
    return isinstance(leaf, dict) and set(leaf) == {"qw", "qs"}


def _eff_block(out_dim: int, want: int, tp: int) -> int:
    """Block size for one leaf: the largest divisor of the output width
    that is <= ``want``, so the scale groups tile the dim."""
    if tp > 1:
        raise not_ported("weight quantization under tensor parallelism",
                         "queue 1 item 14")
    return choose_block(out_dim, want)


def quantize_weights(model_cfg, params, dtype: str = "int8",
                     block: int = 128, skip: Sequence[str] = (),
                     tp: int = 1) -> Tuple[dict, Dict[str, int]]:
    """Quantize a CausalLM param tree once (the engine-build path).

    Returns ``(new_params, stats)``: quantized leaves are ``{"qw", "qs"}``
    nodes, everything else is the original tensor (the same object)."""
    validate_weight_quant(dtype, block)
    skip = set(skip) | set(DEFAULT_SKIP)
    moe = getattr(model_cfg, "moe_num_experts", 0) > 0

    def quant_leaf(w):
        eff = _eff_block(int(w.shape[-1]), int(block), int(tp))
        q, s = quantize_blockwise(w, block=eff, dtype=dtype)
        return {"qw": q, "qs": s}

    out = dict(params)
    layers = dict(params["layers"])
    for name in QUANTIZABLE_LAYER_LEAVES:
        if name not in layers or name in skip:
            continue
        if moe and name in ("w_in", "w_out", "w_gate"):
            continue
        layers[name] = quant_leaf(layers[name])
    out["layers"] = layers
    if "lm_head" in params and "lm_head" not in skip:
        head = dict(params["lm_head"])
        head["w"] = quant_leaf(head["w"])
        out["lm_head"] = head
    return out, param_stats(out, dtype=dtype, block=int(block))


def _leaves(tree):
    """Leaves of a param tree, a quantized node counted as one leaf."""
    if isinstance(tree, dict) and not is_quantized(tree):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _leaf_bytes(t) -> int:
    return t.numel() * t.element_size()


def param_stats(params, dtype: str = "", block: int = 0) -> Dict[str, int]:
    """Byte accounting of a (possibly quantized) param tree:
    ``param_bytes_total`` (every leaf, scale planes included),
    ``param_bytes_quantized`` (payload + scales of the quantized nodes) and
    ``params_quantized`` (the node count)."""
    total = quantized = nodes = 0
    for leaf in _leaves(params):
        if is_quantized(leaf):
            b = _leaf_bytes(leaf["qw"]) + _leaf_bytes(leaf["qs"])
            quantized += b
            total += b
            nodes += 1
        else:
            total += _leaf_bytes(leaf)
    return {"param_bytes_total": total,
            "param_bytes_quantized": quantized,
            "params_quantized": nodes,
            "weight_quant_dtype": dtype,
            "weight_quant_block": block}
