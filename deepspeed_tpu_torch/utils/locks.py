"""Ranked locks: one declaration for static and runtime lock discipline.

Counterpart of ``deepspeed_tpu/utils/locks.py``, with the same rank table,
so the port's serving and telemetry modules take the same locks in the same
order. Every coarse lock of those layers is a :class:`RankedLock` (or
:class:`RankedCondition`) named in :data:`LOCK_RANKS`; the JAX package's
concurrency lint parses that table and proves the order over the source,
and the debug runtime here asserts it on live threads.

Rank discipline: a thread may only acquire a lock of strictly greater rank
than the highest-ranked lock it already holds (re-acquiring the same
reentrant lock is allowed). Code paths that obey it cannot deadlock on these
locks: the rank order is a global topological order of every nesting.

Debug mode is off by default and allocation-free when off (one module-global
load and ``is not None`` test per acquire and release).
:func:`enable_lock_debug` turns on, per acquisition:

- the rank-order assertion against the thread's held-lock stack (a
  violation is recorded, dumped to the flight recorder if one is attached,
  and by default raised as :class:`LockOrderError`);
- self-deadlock detection (re-acquiring a held non-reentrant lock);
- hold-time measurement into a ``lock_hold_s`` histogram (when a metrics
  registry is attached), with holds over ``hold_threshold_s`` recorded.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

#: The lock-rank table, the JAX package's unchanged. Lower rank = acquired
#: first (outermost). A thread holding rank r may only acquire ranks
#: strictly greater than r. Ranks are gapped so new locks slot in.
LOCK_RANKS = {
    # -------------------------------------------------- outermost (admin)
    "serving.frontend.fleet": 20,  # frontend membership mutations
    "serving.supervisor": 30,      # replica restart slots
    "serving.router.membership": 40,   # fleet list rebinds (reentrant)
    "serving.autoscaler": 50,      # controller counters/ledger
    "serving.affinity": 55,        # fleet prefix-digest table + share window
    # ------------------------------------------------- request flow
    "serving.queue": 60,           # admission heap (condition)
    "serving.tenancy": 65,         # tenant ledger (quota/fair-share)
    "serving.replica": 70,         # per-replica delivery/accounting
    "serving.fabric.remote": 72,   # remote-handle mirror/accounting
    "serving.fabric.federation": 73,   # federation-server peer/export tables
    "serving.fabric.server": 74,   # replica-server request table
    "serving.fabric.transport": 76,    # RPC pending-call table
    "serving.fabric.chaos": 78,    # network fault-injection fired ledger
    "serving.handoff": 80,         # KV staging budget
    "serving.faults": 90,          # serving fault-injection schedule
    "serving.request.seq": 100,    # uid allocation
    "train.faults": 105,           # train fault-injection schedule
    "train.watchdog.durations": 110,   # step-duration ring
    # ------------------------------------------------- observability
    "telemetry.slo": 120,          # alert state machines
    "telemetry.windowed": 130,     # snapshot ring
    "telemetry.fleet": 135,        # fleet journal per-source rings
    "telemetry.journal": 140,      # ops event ring + sink
    "telemetry.recorder": 150,     # flight-recorder snapshots
    "telemetry.tracer": 160,       # span rings
    # leaves: metric series (plain locks, ranked via _LOCK_RANKS hints)
    "serving.metrics.registry": 170,
    "serving.metrics.series": 180,
}


class LockOrderError(RuntimeError):
    """A ranked acquisition violated the declared order (potential
    deadlock) — raised only in debug mode."""


class _LockDebug:
    """Process-wide debug state: per-thread held stacks + violation and
    over-hold records. Built by :func:`enable_lock_debug`."""

    def __init__(self, metrics=None, recorder=None,
                 hold_threshold_s: float = 1.0,
                 raise_on_violation: bool = True,
                 clock=time.monotonic):
        self.metrics = metrics          # MetricsRegistry (lock_hold_s) or None
        self.recorder = recorder        # FlightRecorder or None
        self.hold_threshold_s = float(hold_threshold_s)
        self.raise_on_violation = bool(raise_on_violation)
        self.clock = clock
        # guarded-by: _mu (the records below are appended from every
        # instrumented thread; the ranked locks themselves must never be
        # touched from here — this is the machinery under them)
        self.violations: list = []
        self.over_holds: list = []
        self._mu = threading.Lock()
        self._tls = threading.local()

    _GUARDED_BY = {"violations": "_mu", "over_holds": "_mu"}

    # ------------------------------------------------------------ held stack
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _busy(self) -> bool:
        """True while THIS thread is inside a debug handler (recording a
        violation / over-hold, possibly dumping the flight recorder) —
        the handler's own lock acquisitions are not subject to checks,
        or a dump taken while holding a high-ranked lock would recurse
        into fresh violations."""
        return getattr(self._tls, "busy", False)

    def held_names(self) -> list:
        return [rl.name for rl, _ in self._stack()]

    # ------------------------------------------------------------- acquire
    def on_acquire(self, rl: "RankedLock") -> None:
        """Rank check BEFORE the real acquire (catch the inversion while
        the thread can still report it, not after it deadlocked)."""
        if self._busy():
            return
        st = self._stack()
        if not st:
            return
        for held, _ in st:
            if held is rl:
                if rl.reentrant:
                    return          # legal RLock re-entry
                self._violate(rl, st, "self-deadlock: non-reentrant "
                              f"lock {rl.name!r} re-acquired by its owner")
                return
        top = st[-1][0]
        if rl.rank <= top.rank:
            self._violate(
                rl, st,
                f"rank inversion: acquiring {rl.name!r} (rank {rl.rank}) "
                f"while holding {top.name!r} (rank {top.rank})")

    def note_acquired(self, rl: "RankedLock") -> None:
        if self._busy():
            return
        self._stack().append((rl, self.clock()))

    def pop_held(self, rl: "RankedLock") -> Optional[float]:
        """Pop the hold entry and return its duration — WITHOUT side
        effects. The caller releases the real lock first and then calls
        :meth:`observe_hold`: recording (metrics, over-hold dumps —
        which take the recorder's own ranked lock and do file I/O) must
        never run while the lock being released is still held, or an
        over-threshold hold of the recorder's own lock would
        self-deadlock and every dump would extend the hold it reports."""
        if self._busy():
            return None
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] is rl:
                _, t0 = st.pop(i)
                return self.clock() - t0
        return None

    # ------------------------------------------------------------- records
    def _violate(self, rl, st, detail: str) -> None:
        rec = {"t": self.clock(), "thread": threading.current_thread().name,
               "lock": rl.name, "holding": [h.name for h, _ in st],
               "detail": detail}
        self._tls.busy = True
        try:
            with self._mu:
                self.violations.append(rec)
            if self.recorder is not None:
                try:
                    self.recorder.on_event(f"lock_order_{rl.name}")
                except Exception:  # diagnostics must not add failure modes
                    pass
        finally:
            self._tls.busy = False
        if self.raise_on_violation:
            raise LockOrderError(detail)

    def observe_hold(self, rl, dt: float) -> None:
        self._tls.busy = True
        try:
            if self.metrics is not None:
                try:
                    self.metrics.histogram("lock_hold_s").observe(dt)
                except Exception:
                    pass
            if dt > self.hold_threshold_s:
                rec = {"t": self.clock(), "lock": rl.name, "hold_s": dt,
                       "thread": threading.current_thread().name}
                with self._mu:
                    self.over_holds.append(rec)
                if self.recorder is not None:
                    try:
                        self.recorder.on_event(f"lock_hold_{rl.name}")
                    except Exception:
                        pass
        finally:
            self._tls.busy = False


#: None = debug off (the zero-cost default). RankedLock reads this ONCE
#: per operation; enable/disable swap the whole state object atomically.
_DEBUG: Optional[_LockDebug] = None


def enable_lock_debug(metrics=None, recorder=None,
                      hold_threshold_s: float = 1.0,
                      raise_on_violation: bool = True,
                      clock=time.monotonic) -> _LockDebug:
    """Turn on runtime lock-order/hold instrumentation process-wide and
    return the state object (``.violations`` / ``.over_holds`` are the
    assertion surface for chaos tests). Enable BEFORE building the stack
    under test — locks acquired while disabled are simply not tracked."""
    global _DEBUG
    _DEBUG = _LockDebug(metrics=metrics, recorder=recorder,
                        hold_threshold_s=hold_threshold_s,
                        raise_on_violation=raise_on_violation,
                        clock=clock)
    return _DEBUG


def disable_lock_debug() -> None:
    global _DEBUG
    _DEBUG = None


def lock_debug() -> Optional[_LockDebug]:
    return _DEBUG


class RankedLock:
    """A named, ranked mutex. Drop-in for ``threading.Lock()`` (or
    ``RLock()`` with ``reentrant=True``) in the serving/telemetry
    layers; the name must exist in :data:`LOCK_RANKS` — an undeclared
    lock fails at construction, not in a 3 a.m. deadlock."""

    __slots__ = ("name", "rank", "reentrant", "_lock")

    def __init__(self, name: str, lock=None, reentrant: bool = False):
        if name not in LOCK_RANKS:
            raise KeyError(f"lock name {name!r} not declared in "
                           "deepspeed_tpu_torch.utils.locks.LOCK_RANKS")
        self.name = name
        self.rank = LOCK_RANKS[name]
        self.reentrant = bool(reentrant)
        if lock is None:
            lock = threading.RLock() if reentrant else threading.Lock()
        self._lock = lock

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        dbg = _DEBUG
        if dbg is not None:
            dbg.on_acquire(self)
        ok = self._lock.acquire(blocking, timeout)
        if ok and dbg is not None:
            dbg.note_acquired(self)
        return ok

    def release(self) -> None:
        dbg = _DEBUG
        held_s = dbg.pop_held(self) if dbg is not None else None
        self._lock.release()
        # side effects strictly AFTER the real release: the over-hold
        # dump takes the recorder's own ranked lock (self-deadlock if
        # the lock being released IS that one) and must not extend the
        # hold it is reporting
        if held_s is not None:
            dbg.observe_hold(self, held_s)

    def __enter__(self) -> "RankedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        fn = getattr(self._lock, "locked", None)
        return fn() if fn is not None else False

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        return f"RankedLock({self.name!r}, rank={self.rank})"


class RankedCondition(RankedLock):
    """A ranked ``threading.Condition``: acquire/release carry the rank
    bookkeeping; ``wait`` pops the hold (the condition releases the lock
    while waiting — hold-time samples split around the wait, which is
    the honest accounting) and re-notes it on wake without re-running
    the order check (the stack below the waiter is unchanged, so the
    original admissibility still holds)."""

    __slots__ = ()

    def __init__(self, name: str):
        super().__init__(name, lock=threading.Condition())

    def wait(self, timeout: Optional[float] = None) -> bool:
        dbg = _DEBUG
        held_s = dbg.pop_held(self) if dbg is not None else None
        try:
            return self._lock.wait(timeout)
        finally:
            if dbg is not None:
                dbg.note_acquired(self)
                if held_s is not None:
                    # observed after the wake re-acquire: the hold that
                    # ended when wait released the lock (recording here
                    # is rank-safe — the recorder ranks above every
                    # condition user — and cannot run while releasing)
                    dbg.observe_hold(self, held_s)

    def notify(self, n: int = 1) -> None:
        self._lock.notify(n)

    def notify_all(self) -> None:
        self._lock.notify_all()
