"""Host-RAM staging buffer for prefill→decode KV handoff.

Disaggregated serving (docs/SERVING.md "Disaggregated serving") moves a
finished prompt's KV blocks from a prefill-role replica's engine to a
decode-role replica's. The transfer is staged through host RAM — the
ZeRO-Infinity idiom of overlapped device↔host tier copies (PAPERS.md:
arxiv 2104.07857): the export starts the device→host copy of every slab
asynchronously before any is materialized
(``DSStateManager.export_sequence``), the payload rides on the
:class:`~deepspeed_tpu_torch.serving.request.ServingRequest` while it re-queues
for a decode-role replica, and the import scatters it into the
destination pool. This module owns only the *budget*: a bounded count of
payloads staged at once, so a decode-pool stall cannot balloon host RAM
— a full buffer degrades that handoff to the recompute fallback (the
request re-prefills on a decode-capable replica) instead of blocking the
prefill replica's serving loop.

Slot release is idempotent and terminal-safe: the slot frees when the
payload is consumed (``ServingRequest.take_staged``) **or** when the
request reaches any terminal state first (cancel / deadline / shed /
shutdown — ``ServingRequest.finish`` drops the payload), so an abandoned
request can never pin the buffer.

Payloads may arrive in the block-granularity streamed form
(``handoff.chunk_blocks`` > 0, docs/SERVING.md "Multi-host serving"):
the ``"chunks"`` list holds per-chunk host slab groups whose
device→host copies were all dispatched before any materialized
(overlapped), in units the wire codec and the import scatter stream one
at a time — a long-context handoff overlaps its transfer with ongoing
decode. The budget is per payload either way; both local and remote
handles stage through the same slots.
"""

from __future__ import annotations

from ..utils.locks import RankedLock


class HandoffStager:
    # lock discipline (docs/CONCURRENCY.md): the staged-uid set is hit
    # from prefill workers (stage), decode workers (consume) and every
    # terminal path (release via ServingRequest.finish).
    _GUARDED_BY = {"_staged": "_lock"}

    def __init__(self, max_staged: int, metrics=None):
        self.max_staged = max(1, int(max_staged))
        self.metrics = metrics
        self._lock = RankedLock("serving.handoff")
        self._staged: set = set()        # uids holding a staged payload

    def __len__(self) -> int:
        with self._lock:
            return len(self._staged)

    def try_stage(self, req, payload: dict) -> bool:
        """Attach ``payload`` to ``req`` under the staging budget. False
        when the buffer is full — the caller takes the recompute
        fallback (and the request is NOT marked staged)."""
        with self._lock:
            if len(self._staged) >= self.max_staged:
                return False
            self._staged.add(req.uid)
        req.staged_kv = payload
        req._staged_release = lambda uid=req.uid: self.release(uid)
        self._gauge()
        return True

    def release(self, uid: int) -> None:
        """Free a staging slot (idempotent — consume and terminal paths
        can race; whoever runs second no-ops)."""
        with self._lock:
            self._staged.discard(uid)
        self._gauge()

    def _gauge(self) -> None:
        if self.metrics is not None:
            with self._lock:
                n = len(self._staged)
            self.metrics.gauge("handoff_staged").set(n)
