"""Cross-process serving fabric (docs/SERVING.md "Multi-host serving").

Everything above the engine speaks to an :data:`~deepspeed_tpu_torch.serving.
fabric.handle.HANDLE_SURFACE`-shaped handle: :class:`LocalHandle` (the
in-process Replica, byte for byte) or :class:`RemoteHandle` (the same
surface over a length-prefixed socket RPC, driving a replica server
process — ``fabric/server.py`` + ``python -m
deepspeed_tpu_torch.scripts.serve_replica``).

Light names import eagerly; the handle/server classes load lazily (they
pull in the engine stack, torch, through serving.replica).
"""

from .codec import (CODEC_VERSION, CodecError, FrameTooLarge,  # noqa: F401
                    VersionMismatch, decode_frame, encode_frame,
                    payload_chunks, payload_from_chunks,
                    request_from_wire, request_to_wire)
from .transport import (Connection, ConnectionLost,  # noqa: F401
                        FabricError, RPCTimeout, advertised_address,
                        dial, parse_address)

_LAZY = {
    "HANDLE_SURFACE": ("deepspeed_tpu_torch.serving.fabric.handle",
                       "HANDLE_SURFACE"),
    "LocalHandle": ("deepspeed_tpu_torch.serving.fabric.handle", "LocalHandle"),
    "RemoteHandle": ("deepspeed_tpu_torch.serving.fabric.remote", "RemoteHandle"),
    "ReplicaServer": ("deepspeed_tpu_torch.serving.fabric.server",
                      "ReplicaServer"),
    "FederatedHandle": ("deepspeed_tpu_torch.serving.fabric.federation",
                        "FederatedHandle"),
    "FederationPeer": ("deepspeed_tpu_torch.serving.fabric.federation",
                       "FederationPeer"),
    "FederationServer": ("deepspeed_tpu_torch.serving.fabric.federation",
                         "FederationServer"),
    "FederationRefused": ("deepspeed_tpu_torch.serving.fabric.federation",
                          "FederationRefused"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["CODEC_VERSION", "CodecError", "FrameTooLarge",
           "VersionMismatch", "decode_frame", "encode_frame",
           "payload_chunks", "payload_from_chunks", "request_from_wire",
           "request_to_wire", "Connection", "ConnectionLost", "FabricError",
           "RPCTimeout", "advertised_address", "dial", "parse_address",
           "HANDLE_SURFACE", "LocalHandle", "RemoteHandle", "ReplicaServer",
           "FederatedHandle", "FederationPeer", "FederationServer",
           "FederationRefused"]
