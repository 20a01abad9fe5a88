"""MoE layer: gate, experts and dispatch, on PyTorch.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (reference ``moe/layer.py:16``
``MoE`` and ``moe/experts.py:10``): the experts are a stacked param tree
with the expert dim first, which the ``expert`` mesh axis shards
(``parallel/sharding.py``'s logical axis ``"expert"``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.sharding import spec
from .sharded_moe import TopKGate, expert_mlp, moe_dispatch_combine


class MoE:
    """Functional MoE FFN block: ``init(generator) -> params``;
    ``apply(params, x, noise, train) -> (y, l_aux, exp_counts)`` with x
    [..., M] (the leading dims flattened into the token dim)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, activation: str = "gelu",
                 dtype=torch.float32):
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.activation = activation
        self.dtype = dtype
        self.gate = TopKGate(hidden_size, num_experts, k, capacity_factor,
                             eval_capacity_factor, min_capacity,
                             noisy_gate_policy, drop_tokens)

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        E, M, F = self.num_experts, self.hidden_size, self.intermediate_size
        std = 0.02

        def normal(shape):
            return std * torch.randn(shape, generator=generator,
                                     device=device, dtype=torch.float32)

        p = {"w_in": normal((E, M, F)), "w_out": normal((E, F, M))}
        if self.activation == "silu":
            p["w_gate"] = normal((E, M, F))
        p["gate"] = self.gate.init(generator, device)
        return p

    def param_specs(self):
        s = {
            "gate": {"wg": spec("embed", None)},
            "w_in": spec("expert", "embed", "mlp"),
            "w_out": spec("expert", "mlp", "embed"),
        }
        if self.activation == "silu":
            s["w_gate"] = spec("expert", "embed", "mlp")
        return s

    def apply(self, params, x, noise: Optional[torch.Tensor] = None,
              train: bool = True):
        orig_shape = x.shape
        tokens = x.reshape(-1, orig_shape[-1])
        l_aux, combine, dispatch, exp_counts = self.gate(
            params["gate"], tokens, noise, train)

        def expert_fn(expert_in):  # [E, C, M]
            return expert_mlp(expert_in, params["w_in"], params["w_out"],
                              params.get("w_gate"), self.activation,
                              self.dtype)

        y = moe_dispatch_combine(tokens.to(self.dtype), combine, dispatch,
                                 expert_fn)
        return y.reshape(orig_shape), l_aux, exp_counts
