"""EngineHandle — the one surface everything above the engine speaks.

The router, supervisor, autoscaler and frontend never touch an engine
directly; they talk to a *handle* (docs/SERVING.md "Multi-host
serving"). Two implementations exist:

- :class:`LocalHandle` — today's in-process worker
  (:class:`~deepspeed_tpu_torch.serving.replica.Replica`), byte for byte: the
  subclass adds **nothing** (no overrides, no state — asserted by
  tests/test_fabric.py), it only *names* the fact that Replica satisfies
  the protocol. With ``fabric.enabled=false`` the frontend keeps
  constructing plain Replicas, so the disabled path is the in-process
  stack to the byte.
- :class:`~deepspeed_tpu_torch.serving.fabric.remote.RemoteHandle` — the same
  surface over the RPC transport, driving a replica server process
  (fabric/server.py) that may host a TP-sharded engine spanning chips.

``HANDLE_SURFACE`` is the contract, spelled out and test-audited: every
name a component above the engine may touch on a handle. Anything not
listed here is an implementation detail of one handle kind and must not
be reached for (``getattr(..., None)`` probes for optional extensions —
``scheduler``, ``notify_cancel`` — stay legal and degrade to no-ops).
"""

from __future__ import annotations

from ..replica import Replica

#: the handle protocol: attributes/methods the serving stack may use on
#: any replica handle. Audited both ways by tests/test_fabric.py —
#: Replica and RemoteHandle must provide every name.
HANDLE_SURFACE = (
    # identity / shape
    "replica_id", "role", "model_id", "state", "engine", "thread",
    # router selection
    "accepting", "has_capacity", "active_count",
    "outstanding_tokens", "outstanding_prefill_tokens",
    "outstanding_decode_tokens",
    # lifecycle
    "start", "assign", "drain", "request_evacuation", "stop",
    "check_health",
)


class LocalHandle(Replica):
    """The in-process handle: a Replica under its protocol name. MUST
    stay an empty subclass — any override here would fork local-handle
    behavior from the plain-Replica disabled path, and the whole point
    is that there is exactly one in-process implementation."""

    __slots__ = ()
