"""Inference engines (counterpart of ``deepspeed_tpu/inference``): v1
(``InferenceEngine``, what ``init_inference`` returns) here, the ragged v2
engine under ``v2``."""

from .config import InferenceConfig  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
