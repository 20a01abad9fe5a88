"""Greedy-lossless verification of a speculative chunk (counterpart of
``deepspeed_tpu/inference/v2/spec/verify.py``).

The scheduler feeds ``chunk = [t0, d1, ..., dK]``: ``t0`` is the target's
own greedy token from the previous step, ``d1..dK`` the drafts. Row ``j``
of the target's logits is its greedy choice for the token after
``chunk[j]``; a draft is accepted iff it equals that choice, and acceptance
stops at the first disagreement.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def verify_greedy(chunk: Sequence[int],
                  logits_rows: np.ndarray) -> Tuple[List[int], int]:
    """``chunk``: the 1 + K tokens fed this step; ``logits_rows``:
    ``[>= len(chunk), vocab]`` per-position logits (extra rows ignored).

    Returns ``(emitted, last_idx)``: ``chunk[0]`` plus the longest agreeing
    draft prefix, and the row that holds the distribution after the last
    emitted token (the scheduler keeps it as ``last_logits``)."""
    n = len(chunk)
    emitted = [int(chunk[0])]
    greedy = np.argmax(np.asarray(logits_rows[:n]), axis=-1)
    for j in range(1, n):
        if int(chunk[j]) != int(greedy[j - 1]):
            break
        emitted.append(int(chunk[j]))
    return emitted, len(emitted) - 1
