"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``).

The same keys and defaults as the JAX package's pydantic models, as
dataclasses over ``runtime/config_utils.DSConfigModel``:
``tensor_parallel`` is also accepted as ``tp``, unknown keys are kept.
``replace_with_kernel_inject`` and ``enable_cuda_graph`` are accepted and
have no effect, as in the JAX package (the model is one plain
implementation with its kernels already in it; no graph capture).
``raise_if_not_ported`` raises for the keys whose feature the port does
not run yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .. import not_ported
from ..runtime.config_utils import DSConfigModel


@dataclass(init=False, eq=False, repr=False)
class DeepSpeedTPConfig(DSConfigModel):
    enabled: bool = True
    tp_size: int = 1


@dataclass(init=False, eq=False, repr=False)
class QuantizationConfig(DSConfigModel):
    enabled: bool = False
    bits: int = 8


@dataclass(init=False, eq=False, repr=False)
class InferenceConfig(DSConfigModel):
    dtype: str = "bf16"
    tensor_parallel: DeepSpeedTPConfig = field(
        default_factory=DeepSpeedTPConfig, metadata={"alias": "tp"})
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_tokens: int = 1024
    replace_with_kernel_inject: bool = False    # accepted; no effect
    replace_method: str = "auto"
    quant: QuantizationConfig = field(default_factory=QuantizationConfig)
    checkpoint: Optional[str] = None
    zero_allow_untested_optimizer: bool = True
    enable_cuda_graph: bool = False             # accepted; no effect
    set_empty_params: bool = False
    save_mp_checkpoint_path: Optional[str] = None
    ep_size: int = 1
    moe: Dict[str, Any] = field(default_factory=dict)

    def raise_if_not_ported(self) -> None:
        """Raise ``NotImplementedError`` for the first key that asks for a
        feature the port does not run yet."""
        checks = [
            (self.tensor_parallel.tp_size > 1,
             f"tensor_parallel.tp_size={self.tensor_parallel.tp_size} "
             "(tensor parallelism over a device mesh)", "queue 1 item 14"),
            (self.checkpoint is not None,
             "inference checkpoint loading (config.checkpoint: HF or "
             "universal checkpoints)", "queue 1 items 2 and 16"),
            (self.ep_size > 1, f"ep_size={self.ep_size} (expert parallelism)",
             "queue 1 item 14"),
            (bool(self.moe), "the moe block (MoE inference)",
             "queue 1 item 14"),
            (self.save_mp_checkpoint_path is not None,
             "save_mp_checkpoint_path (sharded checkpoint save)",
             "queue 1 item 13"),
        ]
        for on, feature, item in checks:
            if on:
                raise not_ported(feature, item)
