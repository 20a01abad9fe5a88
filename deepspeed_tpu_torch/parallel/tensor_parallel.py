"""Megatron tensor parallelism's two region operators, over ``comm``.

The JAX package keeps no code of its own for tensor parallelism: it has the
spec tree (``models/transformer.py`` ``param_specs``) and GSPMD inserts the
collectives. In the port every rank of a ``tensor`` group is a process that
holds its blocks of the column-parallel (``wq``/``wk``/``wv``, ``w_in``/
``w_gate``) and row-parallel (``wo``, ``w_out``) weights, and the model
marks the two places where the group must talk:

- :func:`copy_to_tensor_region` before a column-parallel product: the
  identity forward, an all-reduce of the input's gradient in the backward
  (each rank's partial gradient covers its own output columns only);
- :func:`reduce_from_tensor_region` after a row-parallel product: an
  all-reduce of the partial products forward, the identity backward.

``torch.distributed.nn.functional.all_reduce`` is not used for the second:
its backward all-reduces again, which would multiply the gradients of
every replicated leaf by the group size. With one rank in the group both
operators return their input and launch nothing.
"""

from __future__ import annotations

import torch

from .. import comm
from . import topology as topo


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.contiguous().clone(), comm.ReduceOp.SUM,
                               ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x.contiguous().clone(), comm.ReduceOp.SUM,
                               group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor_region(x: torch.Tensor, tp: int,
                          group=topo.TENSOR_AXIS) -> torch.Tensor:
    """``x`` as the input of a column-parallel product over ``group``."""
    if tp <= 1:
        return x
    return _CopyToRegion.apply(x, group)


def reduce_from_tensor_region(x: torch.Tensor, tp: int,
                              group=topo.TENSOR_AXIS) -> torch.Tensor:
    """The sum over ``group`` of each rank's row-parallel partial ``x``."""
    if tp <= 1:
        return x
    if not torch.is_grad_enabled():
        # serving: the product is a fresh tensor, reduced in place
        return comm.all_reduce(x.contiguous(), comm.ReduceOp.SUM, group)
    return _ReduceFromRegion.apply(x, group)

