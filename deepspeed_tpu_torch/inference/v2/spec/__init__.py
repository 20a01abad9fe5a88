"""Speculative decoding for the v2 ragged engine (counterpart of
``deepspeed_tpu/inference/v2/spec``).

Greedy-lossless: a :class:`DraftProposer` guesses the next K tokens, the
scheduler packs them into one ragged step (structurally a K+1-token chunk),
the target model's per-position argmax verifies them, and the longest
agreeing prefix is accepted; rejected tokens are rolled back with
``DSStateManager.trim_sequence``. With bf16 or fp32 pools the emitted
stream is the one of plain greedy decoding.
"""

from .proposer import (DraftModelProposer, DraftProposer,  # noqa: F401
                       NGramProposer)
from .verify import verify_greedy  # noqa: F401

__all__ = ["DraftProposer", "NGramProposer", "DraftModelProposer",
           "verify_greedy"]
