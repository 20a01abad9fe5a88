"""ZeRO-Inference weight-only quantization: int8/int4 params, dequantized at
their point of use.

Counterpart of ``deepspeed_tpu/inference/quantization.py``. A param leaf
becomes a :class:`QuantTensor`: int8 codes (int4 codes nibble-packed into
uint8 when ``packed``) and float32 block scales ``[..., ceil(N/block)]``,
so device memory holds a quarter (int8) or an eighth (int4) of the fp32
bytes. The model code (``models/transformer.py``) reaches a QuantTensor
through ``_weight(w, dtype)`` (the whole leaf dequantized: linear weights,
biases, norm weights, the untied or tied unembedding), through a row
gather ``w[idx]`` (the embedding lookup: only the gathered rows are
dequantized) and through ``unbind(0)`` (one QuantTensor a layer, for the
loop over the stacked layer dim). Each dequantization is one
``ops/quantizer.dequantize_blockwise`` call: the hand-written kernel on a
CUDA tensor. int4 codes are unpacked by plain torch first, as the JAX
package unpacks before it dequantizes; the kernel takes int8 codes only.

There is no fused dequantize-and-multiply here: a quantized linear
dequantizes its weight to the compute dtype, then multiplies, as the JAX
package does.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..ops.quantizer import (choose_block, dequantize_blockwise, pack_int4,
                             quantize_blockwise, unpack_int4)

__all__ = ["QuantTensor", "quantize_array", "quantize_param_tree",
           "tree_nbytes", "pack_int4", "unpack_int4"]


class QuantTensor:
    """Blockwise-quantized param leaf. ``q`` int8 (or nibble-packed uint8
    when ``packed``), ``scales`` float32 ``[..., ceil(N/block)]``;
    ``out_dtype`` is the dtype of the array it was quantized from, the
    default of :meth:`dequantize` and of a row gather."""

    __slots__ = ("q", "scales", "block", "bits", "packed", "out_dtype")

    def __init__(self, q, scales, block: int, bits: int, packed: bool,
                 out_dtype):
        self.q = q
        self.scales = scales
        self.block = int(block)
        self.bits = int(bits)
        self.packed = bool(packed)
        self.out_dtype = out_dtype

    def __repr__(self):
        return (f"QuantTensor(shape={self.shape}, bits={self.bits}, "
                f"block={self.block}, packed={self.packed}, "
                f"out_dtype={self.out_dtype})")

    @property
    def shape(self) -> Tuple[int, ...]:
        s = tuple(self.q.shape)
        return s[:-1] + (s[-1] * 2,) if self.packed else s

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return self.out_dtype

    def _like(self, q, scales) -> "QuantTensor":
        return QuantTensor(q, scales, self.block, self.bits, self.packed,
                           self.out_dtype)

    def _codes(self, q):
        return unpack_int4(q) if self.packed else q

    def dequantize(self, dtype=None) -> torch.Tensor:
        """The whole leaf in ``dtype`` (default ``out_dtype``)."""
        return dequantize_blockwise(self._codes(self.q), self.scales,
                                    block=self.block,
                                    dtype=dtype or self.out_dtype)

    def __getitem__(self, idx) -> torch.Tensor:
        """Row gather (the embedding lookup): the rows' codes and scales are
        gathered first (packed int4 rows as they are stored) and only they
        are dequantized, to ``out_dtype``. Indexing the last dim is not
        supported."""
        return dequantize_blockwise(self._codes(self.q[idx]),
                                    self.scales[idx], block=self.block,
                                    dtype=self.out_dtype)

    def unbind(self, dim: int = 0):
        """One QuantTensor per index of a leading dim (the per-layer slices
        ``lax.scan`` gives the JAX package), views of the codes and
        scales."""
        if dim != 0:
            raise ValueError("QuantTensor.unbind slices the leading dim only")
        return [self._like(q, s)
                for q, s in zip(self.q.unbind(0), self.scales.unbind(0))]

    def to(self, device) -> "QuantTensor":
        return self._like(self.q.to(device), self.scales.to(device))

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scales.numel() * self.scales.element_size())


def quantize_array(x: torch.Tensor, bits: int = 8, block: Optional[int] = None,
                   pack: bool = True) -> QuantTensor:
    """One leaf quantized along its last dim (``quantize_blockwise``: the
    hand-written kernel on a CUDA tensor); int4 codes nibble-packed when the
    last dim is even and ``pack``."""
    block = block or choose_block(x.shape[-1])
    q, s = quantize_blockwise(x, bits=bits, block=block)
    packed = bits == 4 and pack and q.shape[-1] % 2 == 0
    if packed:
        q = pack_int4(q)
    return QuantTensor(q=q, scales=s, block=block, bits=bits, packed=packed,
                       out_dtype=x.dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def quantize_param_tree(params, bits: int = 8, min_dims: int = 2,
                        min_size: int = 4096):
    """Weight-only quantization of a param tree: every leaf with at least
    ``min_dims`` dims and ``min_size`` elements becomes a QuantTensor, the
    others stay as they are. The rule is the JAX package's, and so is what
    it does at full width: the docstring there says norms stay fp, but a
    stacked norm leaf ``[L, H]`` passes both limits once L * H >= 4096
    (MISTRAL_7B's ``[32, 4096]`` attention and MLP norm stacks are
    quantized; ``final_norm.w``, 1-D, is not)."""
    def one(leaf):
        if leaf.dim() < min_dims or leaf.numel() < min_size:
            return leaf
        return quantize_array(leaf, bits=bits)

    return _map(one, params)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def tree_nbytes(params: Any) -> int:
    """Bytes a param tree holds (codes and scales for a QuantTensor)."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QuantTensor):
            total += leaf.nbytes
        else:
            total += leaf.numel() * leaf.element_size()
    return total
