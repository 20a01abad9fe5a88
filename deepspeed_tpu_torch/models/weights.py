"""Weight exchange with the JAX package.

``params_from_numpy`` turns the JAX package's param tree, as numpy arrays
(for example ``jax.tree.map(np.asarray, CausalLM.init(key))``), into the
port's tensors leaf for leaf: same nesting, same stacked ``[L, ...]`` layer
leaves, same ``[in, out]`` linear weights. PyTorch cannot reproduce
``jax.random``, so this is how both packages come to compute the same thing.
A quantized tree (``{"qw", "qs"}`` nodes of ``weight_quant.py``) crosses bit
for bit: fp8 payloads keep their bytes and no member of a node is cast. So
does a v1 weight-only quantized tree: a ``QuantTensor`` node of either
package (the JAX one after ``jax.tree.map(np.asarray, tree)``, whose
children are then numpy) becomes the port's ``QuantTensor`` with the same
codes, scales, block, bits, packing and ``out_dtype``; ``params_to_numpy``
gives the port's ``QuantTensor`` back with numpy children and ``out_dtype``
as its name (``"float32"``, ``"bfloat16"``), from which the JAX one is
``QuantTensor(jnp.asarray(t.q), jnp.asarray(t.scales), t.block, t.bits,
t.packed, jnp.dtype(t.out_dtype))``.

``params_to_numpy`` is the way back (trained params, for comparisons), and
``train_state_to_numpy``/``train_state_from_numpy`` carry an engine's
optimizer state and loss-scale state across as numpy, both directions: the
JAX ``OptimizerState`` (``step``, ``moments``) and ``ScaleState`` (``scale``,
``good_steps``, ``hysteresis``) have the same fields in both packages.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    if torch.is_tensor(a):              # a caller's tensor: always a copy
        t = a.detach()
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device, copy=True)
    a = np.asarray(a)
    # ml_dtypes types, which torch.from_numpy refuses
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":       # bit for bit, via the bytes
        t = torch.from_numpy(np.array(a.view(np.uint8), copy=True)).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


_QUANT_FIELDS = ("q", "scales", "block", "bits", "packed", "out_dtype")


def _is_quant(node) -> bool:
    """A QuantTensor of either package (duck-typed: the JAX class is not
    imported here)."""
    return not isinstance(node, dict) and all(hasattr(node, f)
                                              for f in _QUANT_FIELDS)


def _dtype_name(dt) -> str:
    """The name of a torch, numpy or JAX dtype (or a dtype's name)."""
    if isinstance(dt, torch.dtype):
        return str(dt).split(".")[-1]
    if isinstance(dt, type):                # a scalar type, as jnp.float32
        dt = np.dtype(dt)
    return getattr(dt, "name", None) or str(dt)


def params_from_numpy(tree: Any, device=None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of arrays → the same nesting of tensors on ``device``
    (CUDA unless ``device="cpu"``). ``dtype`` casts floating leaves;
    integer leaves, both members of a quantized ``{"qw", "qs"}`` node and
    a ``QuantTensor`` node (and its ``out_dtype``) keep their type."""
    from ..inference.quantization import QuantTensor

    device = resolve_device(device)
    if _is_quant(tree):
        return QuantTensor(_leaf(tree.q, device, None),
                           _leaf(tree.scales, device, None), tree.block,
                           tree.bits, tree.packed,
                           getattr(torch, _dtype_name(tree.out_dtype)))
    if isinstance(tree, dict):
        if set(tree) == {"qw", "qs"}:
            dtype = None
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # numpy has no bfloat16: widen
        t = t.float()
    elif t.dtype == torch.float8_e4m3fn:    # the bytes, as uint8
        t = t.view(torch.uint8)
    return t.numpy().copy()


def params_to_numpy(tree: Any) -> Any:
    """Nested dicts of tensors → the same nesting of numpy arrays on the
    host (bf16 leaves widened to fp32, fp8 leaves as their bytes; a
    ``QuantTensor`` as a QuantTensor of numpy codes and scales with its
    ``out_dtype`` by name)."""
    from ..inference.quantization import QuantTensor

    if _is_quant(tree):
        return QuantTensor(_to_numpy(tree.q), _to_numpy(tree.scales),
                           tree.block, tree.bits, tree.packed,
                           _dtype_name(tree.out_dtype))
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _to_numpy(tree)


def train_state_to_numpy(opt_state, scale_state) -> dict:
    """An ``OptimizerState`` and a ``ScaleState`` (of either package, once
    its arrays are numpy-convertible) as one dict of numpy arrays."""
    def conv(x):
        return _to_numpy(x) if torch.is_tensor(x) else np.asarray(x)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return conv(tree)

    return {"opt_state": {"step": conv(opt_state.step),
                          "moments": walk(opt_state.moments)},
            "scale_state": {"scale": conv(scale_state.scale),
                            "good_steps": conv(scale_state.good_steps),
                            "hysteresis": conv(scale_state.hysteresis)}}


def train_state_from_numpy(state: dict, device=None):
    """The inverse of :func:`train_state_to_numpy` for the port: returns
    ``(OptimizerState, ScaleState)`` of tensors on ``device`` (fp32 moments,
    int32 counters, as the engine keeps them)."""
    from ..ops.optimizers import OptimizerState
    from ..runtime.engine import ScaleState

    device = resolve_device(device)

    def scalar(x, dtype):
        return torch.tensor(np.asarray(x).reshape(()).item(), dtype=dtype,
                            device=device)

    os_, ss = state["opt_state"], state["scale_state"]
    opt_state = OptimizerState(
        step=scalar(os_["step"], torch.int32),
        moments=params_from_numpy(os_["moments"], device, torch.float32))
    scale_state = ScaleState(
        scale=scalar(ss["scale"], torch.float32),
        good_steps=scalar(ss["good_steps"], torch.int32),
        hysteresis=scalar(ss["hysteresis"], torch.int32))
    return opt_state, scale_state
