"""Weight exchange with the JAX package.

``params_from_numpy`` turns the JAX package's param tree, as numpy arrays
(for example ``jax.tree.map(np.asarray, CausalLM.init(key))``), into the
port's tensors leaf for leaf: same nesting, same stacked ``[L, ...]`` layer
leaves, same ``[in, out]`` linear weights. PyTorch cannot reproduce
``jax.random``, so this is how both packages come to compute the same thing.
A quantized tree (``{"qw", "qs"}`` nodes of ``weight_quant.py``) crosses bit
for bit: fp8 payloads keep their bytes and no member of a node is cast.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
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


def params_from_numpy(tree: Any, device=None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of arrays → the same nesting of tensors on ``device``
    (CUDA unless ``device="cpu"``). ``dtype`` casts floating leaves;
    integer leaves and both members of a quantized ``{"qw", "qs"}`` node
    keep their type."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        if set(tree) == {"qw", "qs"}:
            dtype = None
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)
