"""Host-memory optimizers for ZeRO-Offload.

Counterpart of ``deepspeed_tpu/ops/cpu_adam.py`` (reference
``ops/adam/cpu_adam.py:13`` ``DeepSpeedCPUAdam``, ``ops/adagrad``,
``ops/lion``): the same constructor keywords, ``init_state`` and an in-place
``step`` over flat fp32 arrays in host RAM. The update runs in the port's
``csrc/cpu_adam.cpp`` (``ops/op_builder.CPUAdamBuilder``, g++ with
``-march=native -fopenmp``), which is the JAX package's source byte for
byte, so both packages produce the same bits. Where g++ or the source is
absent the numpy fallback runs the same formulas; ``has_native`` says which.

The arrays are numpy arrays or CPU torch tensors (read through their
memory, never copied); each must be C-contiguous float32, since the C code
walks raw memory.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .op_builder import CPUAdamBuilder

_FP = ctypes.POINTER(ctypes.c_float)


def _host_f32(x, what: str) -> np.ndarray:
    """``x`` as a numpy array sharing its memory: C-contiguous float32 on
    the host, or ``ValueError``."""
    if torch.is_tensor(x):
        if x.device.type != "cpu":
            raise ValueError(f"{what} must be on the host, not {x.device}")
        x = x.detach().numpy()
    if x.dtype != np.float32 or not x.flags.c_contiguous:
        raise ValueError(f"{what} must be C-contiguous float32, got "
                         f"{x.dtype} (contiguous: {x.flags.c_contiguous})")
    return x


def _state_f32(state: dict) -> dict:
    return {k: _host_f32(v, f"state[{k!r}]") for k, v in state.items()}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_FP)


class DeepSpeedCPUAdam:
    """Adam / AdamW (``adamw_mode``: decoupled weight decay)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adamw_mode=True, bias_correction=True,
                 fp32_optimizer_states=True, **_):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self._lib = CPUAdamBuilder().load()

    @property
    def has_native(self) -> bool:
        return self._lib is not None

    def init_state(self, flat_params):
        # a step counter a leaf: one optimizer serves many leaves, and the
        # bias correction must advance once a leaf step, not once a call
        flat = _host_f32(flat_params, "params")
        return {"m": np.zeros_like(flat), "v": np.zeros_like(flat),
                "step": np.zeros((1,), np.float32)}

    def step(self, params, grads, state: dict, lr: float = None) -> None:
        """In-place update of ``params`` and ``state``."""
        params = _host_f32(params, "params")
        grads = _host_f32(grads, "grads")
        st = _state_f32(state)
        lr = self.lr if lr is None else float(lr)
        st["step"][0] += 1
        step_count = int(st["step"][0])
        b1, b2 = self.betas
        if self._lib is not None:
            self._lib.ds_adam_step(
                _ptr(params), _ptr(grads), _ptr(st["m"]), _ptr(st["v"]),
                params.size, lr, b1, b2, self.eps, self.weight_decay,
                int(self.adamw_mode), int(self.bias_correction), step_count)
            return
        # numpy fallback (the same formulas)
        g = grads
        if self.weight_decay and not self.adamw_mode:
            g = g + self.weight_decay * params
        st["m"] *= b1
        st["m"] += (1 - b1) * g
        st["v"] *= b2
        st["v"] += (1 - b2) * np.square(g)
        if self.bias_correction:
            c1 = 1 - b1 ** step_count
            c2 = 1 - b2 ** step_count
        else:
            c1 = c2 = 1.0
        update = (st["m"] / c1) / (np.sqrt(st["v"] / c2) + self.eps)
        if self.weight_decay and self.adamw_mode:
            update = update + self.weight_decay * params
        params -= lr * update


class DeepSpeedCPUAdagrad:
    """reference ops/adagrad/cpu_adagrad.py."""

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0, **_):
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay
        self._lib = CPUAdamBuilder().load()

    @property
    def has_native(self) -> bool:
        return self._lib is not None

    def init_state(self, flat_params):
        return {"v": np.zeros_like(_host_f32(flat_params, "params"))}

    def step(self, params, grads, state, lr=None):
        params = _host_f32(params, "params")
        grads = _host_f32(grads, "grads")
        st = _state_f32(state)
        lr = self.lr if lr is None else float(lr)
        if self._lib is not None:
            self._lib.ds_adagrad_step(_ptr(params), _ptr(grads),
                                      _ptr(st["v"]), params.size, lr,
                                      self.eps, self.weight_decay)
            return
        g = grads + self.weight_decay * params
        st["v"] += np.square(g)
        params -= lr * g / (np.sqrt(st["v"]) + self.eps)


class DeepSpeedCPULion:
    """reference ops/lion/cpu_lion.py."""

    def __init__(self, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0, **_):
        self.lr, self.betas, self.weight_decay = lr, tuple(betas), weight_decay
        self._lib = CPUAdamBuilder().load()

    @property
    def has_native(self) -> bool:
        return self._lib is not None

    def init_state(self, flat_params):
        return {"m": np.zeros_like(_host_f32(flat_params, "params"))}

    def step(self, params, grads, state, lr=None):
        params = _host_f32(params, "params")
        grads = _host_f32(grads, "grads")
        st = _state_f32(state)
        lr = self.lr if lr is None else float(lr)
        b1, b2 = self.betas
        if self._lib is not None:
            self._lib.ds_lion_step(_ptr(params), _ptr(grads), _ptr(st["m"]),
                                   params.size, lr, b1, b2, self.weight_decay)
            return
        update = np.sign(b1 * st["m"] + (1 - b1) * grads) \
            + self.weight_decay * params
        params -= lr * update
        st["m"] *= b2
        st["m"] += (1 - b2) * grads
