"""Pipeline module: layer specs and stage partitioning.

The port's own copy of ``deepspeed_tpu/runtime/pipe/module.py``:
``LayerSpec``, ``TiedLayerSpec``, ``partition_balanced`` and
``PipelineModule`` with uniform / parameter-count / regex partitioning.
With the stacked-layer ``CausalLM`` the partition is implicit (contiguous
L/P slices, ``parallel/pipeline.py``); arbitrary layer lists with uneven
costs go through the balanced-partition solver here.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence


class LayerSpec:
    """Deferred layer construction (reference pipe/module.py:30)."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs

    def build(self):
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        return f"LayerSpec({getattr(self.typename, '__name__', self.typename)})"


class TiedLayerSpec(LayerSpec):
    """Layer whose params are shared across stages (reference :77 — e.g.
    tied embedding/unembedding). ``key`` names the tie group."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="weight", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """Balanced contiguous partition minimizing the max part weight
    (reference deepspeed/runtime/utils.py partition_balanced — solved here
    by binary search over the bottleneck + greedy fill)."""
    n = len(weights)
    if num_parts >= n:
        return list(range(n + 1)) + [n] * (num_parts - n)

    def parts_needed(limit: float) -> Optional[List[int]]:
        bounds = [0]
        acc = 0.0
        for i, w in enumerate(weights):
            if w > limit:
                return None
            if acc + w > limit:
                bounds.append(i)
                acc = w
            else:
                acc += w
        bounds.append(n)
        return bounds if len(bounds) - 1 <= num_parts else None

    lo, hi = max(weights), sum(weights)
    for _ in range(60):
        mid = (lo + hi) / 2
        if parts_needed(mid) is not None:
            hi = mid
        else:
            lo = mid
    bounds = parts_needed(hi)
    # pad to exactly num_parts by splitting trailing empty parts
    while len(bounds) - 1 < num_parts:
        bounds.append(n)
    return bounds


class PipelineModule:
    """Partitions a layer list across pipeline stages.

    ``layers``: list of LayerSpec / callables. ``partition_method``:
    "uniform" | "parameters" | "type:regex" (reference pipe/module.py:382
    ``_partition_layers``).
    """

    def __init__(self, layers, num_stages: int,
                 partition_method: str = "parameters",
                 loss_fn: Optional[Callable] = None,
                 activation_checkpoint_interval: int = 0,
                 param_count_fn: Optional[Callable] = None):
        self.layer_specs = list(layers)
        self.num_stages = num_stages
        self.partition_method = partition_method
        self.loss_fn = loss_fn
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self._param_count_fn = param_count_fn or self._default_param_count
        self.parts = self._partition_layers()

    @staticmethod
    def _default_param_count(spec) -> int:
        if isinstance(spec, LayerSpec):
            cnt = spec.module_kwargs.get("num_params")
            if cnt is not None:
                return int(cnt)
            built = None
            try:
                built = spec.build()
            except Exception:
                return 1
            spec = built
        if hasattr(spec, "num_params"):
            try:
                return int(spec.num_params())
            except Exception:
                return 1
        return 1

    def _partition_layers(self) -> List[int]:
        n = len(self.layer_specs)
        method = self.partition_method.lower()
        if method == "uniform":
            weights = [1.0] * n
        elif method == "parameters":
            weights = [float(self._param_count_fn(s)) for s in self.layer_specs]
        elif method.startswith("type:"):
            pattern = method.split(":", 1)[1]
            weights = [1.0 if re.search(
                pattern, getattr(getattr(s, "typename", s), "__name__",
                                 str(s)), re.IGNORECASE) else 0.0
                for s in self.layer_specs]
            if sum(weights) == 0:
                raise ValueError(f"no layers matched type regex {pattern!r}")
        else:
            raise ValueError(f"unknown partition_method {self.partition_method!r}")
        return partition_balanced(weights, self.num_stages)

    def stage_layers(self, stage_id: int) -> List:
        lo, hi = self.parts[stage_id], self.parts[stage_id + 1]
        return self.layer_specs[lo:hi]

    def stage_owner(self, layer_idx: int) -> int:
        for s in range(self.num_stages):
            if self.parts[s] <= layer_idx < self.parts[s + 1]:
                return s
        raise ValueError(f"layer {layer_idx} out of range")

    @property
    def tied_keys(self):
        return sorted({s.key for s in self.layer_specs
                       if isinstance(s, TiedLayerSpec)})
