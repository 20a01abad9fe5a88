"""Scheduling result codes (reference inference/v2/scheduling_utils.py)."""

from __future__ import annotations

from enum import Enum


class SchedulingResult(Enum):
    Success = 0
    EngineSequenceLimitExceeded = 1
    BatchSequenceLimitExceeded = 2
    BatchTokenLimitExceeded = 3
    KVCacheLimitExceeded = 4
    SequenceTokenLimitExceeded = 5


class SchedulingError(RuntimeError):
    def __init__(self, result: SchedulingResult):
        self.status = result
        super().__init__(f"Scheduling failed: {result.name}")
