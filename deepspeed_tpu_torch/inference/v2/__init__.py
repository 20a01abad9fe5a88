"""FastGen-style ragged serving (counterpart of
``deepspeed_tpu/inference/v2``)."""

from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, Request  # noqa: F401
from .scheduling_utils import SchedulingError, SchedulingResult  # noqa: F401
