"""Functional optimizers over the param tree, on PyTorch.

Counterpart of ``deepspeed_tpu/ops/optimizers.py``: ``FusedAdam`` (Adam and
AdamW), ``Lamb``, ``Lion``, ``SGD`` and ``Adagrad`` with the same
constructor arguments, the same formulas in the same order of operations,
and the same state layout::

    state  = opt.init(params)                       # fp32 moments
    params, state = opt.step(params, grads, state, lr)

``params``, ``grads`` and the moments are nested dicts of fp32 tensors with
one structure; ``lr`` is a Python float or a 0-d tensor (the engine hands
the schedule's value over without a host round trip). ``step`` returns new
trees and leaves its inputs untouched, as the JAX functions do; the engine
decides what to keep. The update of each leaf is a handful of elementwise
PyTorch ops; the step count is a 0-d int32 tensor so that the bias
correction ``b ** float(t)`` is computed in fp32 on the device, as in JAX.

The 1-bit optimizers (``ops/onebit.py``) own a compressed gradient
collective and come with the distributed slice: their keys raise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from .. import not_ported


def _tmap(f: Callable, *trees):
    """Map ``f`` over the leaves of nested dicts of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tmap(f, *(t[k] for t in trees)) for k in first}
    return f(*trees)


def _unzip(out, n):
    """Split a tree of n-tuples into n trees."""
    if isinstance(out, dict):
        parts = {k: _unzip(v, n) for k, v in out.items()}
        return tuple({k: parts[k][i] for k in out} for i in range(n))
    return tuple(out[i] for i in range(n))


def tree_leaves(tree):
    """The leaves of a nested dict, in sorted-key order (the order
    ``jax.tree.leaves`` gives the same tree)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


class OptimizerState(NamedTuple):
    step: torch.Tensor         # 0-d int32
    moments: Dict[str, Any]    # optimizer-specific trees


class Optimizer:
    """Base: stateless strategy object; all state is in OptimizerState."""

    name = "base"

    def init(self, params) -> OptimizerState:
        raise NotImplementedError

    def step(self, params, grads, state: OptimizerState, lr):
        raise NotImplementedError


def _zero_step(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros(params):
    return _tmap(torch.zeros_like, params)


class FusedAdam(Optimizer):
    """Adam/AdamW; ``adam_w_mode`` selects decoupled weight decay."""

    name = "adam"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, bias_correction=True,
                 amsgrad=False, **_):
        if amsgrad:
            raise ValueError("amsgrad is not supported")
        self.lr, self.betas, self.eps = lr, tuple(betas), eps
        self.weight_decay, self.adam_w_mode = weight_decay, adam_w_mode
        self.bias_correction = bias_correction

    def init(self, params) -> OptimizerState:
        return OptimizerState(step=_zero_step(params),
                              moments={"m": _zeros(params),
                                       "v": _zeros(params)})

    def step(self, params, grads, state, lr):
        b1, b2 = self.betas
        t = state.step + 1
        tf = t.to(torch.float32)
        if self.bias_correction:
            c1 = 1.0 - b1 ** tf
            c2 = 1.0 - b2 ** tf
        else:
            c1 = c2 = 1.0
        wd = self.weight_decay

        def upd(p, g, m, v):
            if wd and not self.adam_w_mode:   # classic Adam: L2 into grad
                g = g + wd * p
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * torch.square(g)
            update = (m2 / c1) / (torch.sqrt(v2 / c2) + self.eps)
            if wd and self.adam_w_mode:       # AdamW: decoupled decay
                update = update + wd * p
            return p - lr * update, m2, v2

        out = _tmap(upd, params, grads, state.moments["m"], state.moments["v"])
        new_p, new_m, new_v = _unzip(out, 3)
        return new_p, OptimizerState(step=t, moments={"m": new_m, "v": new_v})


class Lamb(Optimizer):
    """LAMB: the Adam update scaled per tensor by the trust ratio
    ||p|| / ||update||, clipped to [min_coeff, max_coeff]."""

    name = "lamb"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=0.0, max_coeff=10.0, min_coeff=0.01, **_):
        self.lr, self.betas, self.eps = lr, tuple(betas), eps
        self.weight_decay = weight_decay
        self.max_coeff, self.min_coeff = max_coeff, min_coeff

    def init(self, params):
        return OptimizerState(step=_zero_step(params),
                              moments={"m": _zeros(params),
                                       "v": _zeros(params)})

    def step(self, params, grads, state, lr):
        b1, b2 = self.betas
        t = state.step + 1
        tf = t.to(torch.float32)
        c1, c2 = 1.0 - b1 ** tf, 1.0 - b2 ** tf

        def upd(p, g, m, v):
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * torch.square(g)
            u = (m2 / c1) / (torch.sqrt(v2 / c2) + self.eps) \
                + self.weight_decay * p
            p_norm = torch.linalg.vector_norm(p.reshape(-1))
            u_norm = torch.linalg.vector_norm(u.reshape(-1))
            one = torch.ones_like(p_norm)
            trust = torch.where(
                u_norm > 0, torch.where(p_norm > 0, p_norm / u_norm, one),
                one)
            trust = torch.clamp(trust, self.min_coeff, self.max_coeff)
            return p - lr * trust * u, m2, v2

        out = _tmap(upd, params, grads, state.moments["m"], state.moments["v"])
        new_p, new_m, new_v = _unzip(out, 3)
        return new_p, OptimizerState(step=t, moments={"m": new_m, "v": new_v})


class Lion(Optimizer):
    """Lion: sign of the interpolated momentum, decoupled weight decay."""

    name = "lion"

    def __init__(self, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0, **_):
        self.lr, self.betas, self.weight_decay = lr, tuple(betas), weight_decay

    def init(self, params):
        return OptimizerState(step=_zero_step(params),
                              moments={"m": _zeros(params)})

    def step(self, params, grads, state, lr):
        b1, b2 = self.betas

        def upd(p, g, m):
            update = torch.sign(b1 * m + (1 - b1) * g) + self.weight_decay * p
            return p - lr * update, b2 * m + (1 - b2) * g

        out = _tmap(upd, params, grads, state.moments["m"])
        new_p, new_m = _unzip(out, 2)
        return new_p, OptimizerState(step=state.step + 1,
                                     moments={"m": new_m})


class SGD(Optimizer):
    name = "sgd"

    def __init__(self, lr=1e-3, momentum=0.0, weight_decay=0.0,
                 nesterov=False, **_):
        self.lr, self.momentum = lr, momentum
        self.weight_decay, self.nesterov = weight_decay, nesterov

    def init(self, params):
        moments = {}
        if self.momentum:
            moments["m"] = _zeros(params)
        return OptimizerState(step=_zero_step(params), moments=moments)

    def step(self, params, grads, state, lr):
        wd = self.weight_decay
        if not self.momentum:
            new_p = _tmap(lambda p, g: p - lr * (g + wd * p), params, grads)
            return new_p, OptimizerState(step=state.step + 1, moments={})

        def upd(p, g, m):
            g = g + wd * p
            m2 = self.momentum * m + g
            d = g + self.momentum * m2 if self.nesterov else m2
            return p - lr * d, m2

        out = _tmap(upd, params, grads, state.moments["m"])
        new_p, new_m = _unzip(out, 2)
        return new_p, OptimizerState(step=state.step + 1,
                                     moments={"m": new_m})


class Adagrad(Optimizer):
    name = "adagrad"

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0, **_):
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay

    def init(self, params):
        return OptimizerState(step=_zero_step(params),
                              moments={"v": _zeros(params)})

    def step(self, params, grads, state, lr):
        def upd(p, g, v):
            g = g + self.weight_decay * p
            v2 = v + torch.square(g)
            return p - lr * g / (torch.sqrt(v2) + self.eps), v2

        out = _tmap(upd, params, grads, state.moments["v"])
        new_p, new_v = _unzip(out, 2)
        return new_p, OptimizerState(step=state.step + 1,
                                     moments={"v": new_v})


# Registry: the keys are the accepted ``optimizer.type`` strings.
OPTIMIZERS = {
    "adam": FusedAdam,
    "adamw": lambda **kw: FusedAdam(adam_w_mode=True, **kw),
    "fusedadam": FusedAdam,
    "lamb": Lamb,
    "fusedlamb": Lamb,
    "lion": Lion,
    "sgd": SGD,
    "adagrad": Adagrad,
}

_ONEBIT_KEYS = ("onebitadam", "zerooneadam", "onebitlamb")


def build_optimizer(type_name: str, params: Optional[dict] = None) -> Optimizer:
    key = type_name.lower().replace("_", "")
    kwargs = dict(params or {})
    kwargs.pop("torch_adam", None)
    if key == "adamw":
        kwargs.pop("adam_w_mode", None)
    if key in _ONEBIT_KEYS:
        raise not_ported(f"the 1-bit optimizer {type_name!r} (ops/onebit.py)",
                         "queue 1 item 14")
    if key not in OPTIMIZERS:
        raise ValueError(
            f"Unknown optimizer {type_name!r}; "
            f"known: {sorted(OPTIMIZERS) + sorted(_ONEBIT_KEYS)}")
    return OPTIMIZERS[key](**kwargs)
