"""Shared restart discipline for the self-healing supervisors.

Both supervisors — serving (``serving/supervisor.py``, per replica slot)
and training (``runtime/resilience.py``, per run) — restart failed work
under the same policy: failures are counted in a sliding window,
restarts back off exponentially with deterministic seeded jitter (so a
fleet doesn't restart in lockstep), and a circuit breaker parks anything
that keeps dying instead of rebuilding it forever. This class is
that policy, in one place, so a fix to the window/backoff/breaker
semantics cannot silently diverge between the two supervisors.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Optional, Tuple


class RestartPolicy:
    """Sliding-window failure accounting + capped exponential backoff
    with seeded jitter + circuit breaker.

    Not thread-safe by itself — callers serialize access (the serving
    supervisor under its slot lock, the training supervisor from its
    single control thread)."""

    def __init__(self, backoff_s: float, backoff_max_s: float,
                 jitter: float, max_failures_in_window: int,
                 window_s: float, rng: random.Random,
                 full_jitter: bool = False):
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.max_failures_in_window = int(max_failures_in_window)
        self.window_s = float(window_s)
        self.rng = rng
        # full_jitter: backoff = uniform(0, capped_exponential) — the
        # AWS "full jitter" scheme. Proportional jitter (the default)
        # only perturbs the backoff by ±jitter; N peers that failed at
        # the same instant still re-dial in a tight band and hammer a
        # restarted frontend in lockstep. Full jitter spreads them over
        # the WHOLE interval — reconnect storms become a trickle.
        self.full_jitter = bool(full_jitter)
        self.failure_times: "deque[float]" = deque()

    def record_failure(self, now: float) -> Tuple[int, Optional[float]]:
        """Count a failure at monotonic time ``now``. Returns
        ``(n_failures_in_window, backoff_s)``; a ``None`` backoff means
        the breaker tripped — park, don't restart."""
        self.failure_times.append(now)
        while self.failure_times and \
                now - self.failure_times[0] > self.window_s:
            self.failure_times.popleft()
        n = len(self.failure_times)
        if n >= max(1, self.max_failures_in_window):
            return n, None
        raw = min(self.backoff_s * (2 ** (n - 1)), self.backoff_max_s)
        # rng.random() is drawn even at jitter 0 so the seeded stream is
        # identical whether or not jitter is configured
        u = self.rng.random()
        backoff = raw * u if self.full_jitter else raw * (1.0 + self.jitter * u)
        return n, backoff

    def count(self) -> int:
        """Failures currently inside the window (as of the last record)."""
        return len(self.failure_times)

    def last_failure_time(self) -> Optional[float]:
        return self.failure_times[-1] if self.failure_times else None
