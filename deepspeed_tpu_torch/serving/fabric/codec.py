"""Versioned wire codec for the serving fabric (docs/SERVING.md
"Multi-host serving").

Everything that crosses a replica-process boundary — RPC envelopes,
:class:`~deepspeed_tpu_torch.serving.request.ServingRequest` state, KV export
payloads (pool slabs + scale planes + dtype stamps, whole or in
per-block chunks), ``last_logits`` — is encoded by this module into one
self-describing binary frame::

    u32 header_len | header JSON (utf-8) | buf_0 | buf_1 | ...

The header carries the codec version, a JSON tree in which every array
was replaced by a ``{"__buf__": i}`` placeholder, and per-buffer
``(dtype name, shape, nbytes)`` descriptors. Arrays are shipped as raw
row-major bytes, so int8/fp8/bf16/fp32 slabs round-trip **byte-exactly**
— the hinge of cross-process KV handoff parity.

Counterpart of ``deepspeed_tpu/serving/fabric/codec.py``, and wire-equal to
it: the same content gives the same frame bytes in both packages, so a
port process and a JAX process talk to each other. Values may be numpy
arrays or torch tensors (a device tensor is copied to the host). The dtypes
numpy lacks (``bfloat16``, ``float8_e4m3fn``, ``float8_e5m2``) cross under
those names as raw bytes and decode into host torch tensors of that dtype,
the form the port's ``export_sequence``/``import_sequence`` use; every
other buffer decodes into a numpy array. Nothing here needs ``ml_dtypes``.
Decoded buffers are views over the frame when it is a ``bytearray`` (what
the transport reads into), else over one writable copy of it.

Failure surface is typed, never a crash: a frame from a different codec
generation raises :class:`VersionMismatch`, a frame over the configured
byte bound raises :class:`FrameTooLarge` (on encode AND decode — the
receiver refuses before allocating), and anything malformed raises
:class:`CodecError`. Callers degrade (drop a payload to the re-prefill
fallback, kill a connection) instead of propagating garbage.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: the newest frame generation this process SPEAKS; carried in the hello
#: exchange. v2 adds an optional CRC32 trailer (sealed frames) — layout
#: v1 is unchanged, and encode emits it by default, so old peers still
#: decode everything a new process sends until BOTH ends negotiated
#: sealing in the hello (``crc_frames``).
CODEC_VERSION = 2

#: hello-acceptable peer generations: v1 peers speak the base layout
#: (never sealed — they did not advertise), v2 peers may seal
COMPAT_CODEC_VERSIONS = frozenset({1, 2})

#: per-frame layout versions. _BASE is byte-for-byte the historical
#: frame; _SEALED appends ``u32 crc32(frame)`` and is only ever sent to
#: a peer that advertised ``crc_frames`` in the hello.
_BASE_FRAME_V = 1
_SEALED_FRAME_V = 2

_HEADER_FMT = ">I"
_HEADER_LEN = struct.calcsize(_HEADER_FMT)


class CodecError(Exception):
    """Malformed or unencodable fabric frame."""


class VersionMismatch(CodecError):
    """Frame written by a different codec generation — the peer must be
    upgraded/downgraded, not guessed at. ``detail`` carries a remote
    peer's own refusal text verbatim (it names BOTH versions — the one
    diagnostic the operator needs)."""

    def __init__(self, got=None, want: int = CODEC_VERSION,
                 detail: Optional[str] = None):
        self.got, self.want = got, want
        super().__init__(detail or
                         f"fabric codec version mismatch: frame v={got!r}, "
                         f"this process speaks v={want}")


class ModelMismatch(CodecError):
    """Hello exchange found the peer hosting a different model than the
    pool adopting it expects (docs/SERVING.md "Multi-model &
    multi-tenant serving") — a config error, permanent for this pairing:
    retrying cannot fix it, and adopting anyway would misroute every
    request of the pool."""


class FrameTooLarge(CodecError):
    """Frame over the configured ``max_frame_bytes`` bound."""

    def __init__(self, size: int, limit: int):
        self.size, self.limit = int(size), int(limit)
        super().__init__(f"fabric frame of {size} bytes exceeds the "
                         f"{limit}-byte max_frame_bytes bound")


class FrameCorrupt(CodecError):
    """A sealed (v2) frame failed its CRC32 trailer check: the payload
    was damaged in flight. Deliberately a SINGLE-FRAME refusal — the
    transport drops the frame and keeps the connection (the caller's
    timeout/failover machinery owns the lost frame), where every other
    CodecError still kills the link (framing itself is suspect)."""

    def __init__(self, want: int, got: int):
        self.want, self.got = int(want), int(got)
        super().__init__(f"fabric frame CRC mismatch: trailer "
                         f"{want:#010x}, payload {got:#010x}")


#: torch dtypes and their wire names (numpy's ``dtype.name`` for the same
#: bytes, ``ml_dtypes``' names for the types numpy lacks)
_TORCH_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.float8_e4m3fn: "float8_e4m3fn", torch.float8_e5m2: "float8_e5m2",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}

#: wire names numpy cannot resolve: these decode into torch tensors
_TORCH_ONLY = {name: dt for dt, name in _TORCH_NAMES.items()
               if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2")}


def _np_dtype(name: str) -> np.dtype:
    """Resolve a numpy-native dtype name (the :data:`_TORCH_ONLY` names
    are handled by the caller)."""
    try:
        dt = np.dtype(name)
    except TypeError:
        raise CodecError(f"unknown array dtype {name!r} in fabric frame")
    if dt.hasobject:
        raise CodecError(f"unknown array dtype {name!r} in fabric frame")
    return dt


class _TensorBuf:
    """A torch tensor's wire image: its dtype name, shape and raw bytes."""

    __slots__ = ("name", "shape", "nbytes", "data")

    def __init__(self, t: torch.Tensor):
        if t.dtype not in _TORCH_NAMES:
            raise CodecError(f"unencodable tensor dtype {t.dtype} in "
                             "fabric frame")
        t = t.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        self.name = _TORCH_NAMES[t.dtype]
        self.shape = list(t.shape)
        flat = t.contiguous().reshape(-1)
        if t.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        self.data = flat.view(torch.uint8).numpy()
        self.nbytes = int(self.data.nbytes)

    def tobytes(self) -> bytes:
        return self.data.tobytes()


def _encode_tree(obj: Any, bufs: List[Any]) -> Any:
    """JSON-safe mirror of ``obj`` with arrays hoisted into ``bufs``."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise CodecError(f"fabric frames need string dict keys, "
                                 f"got {type(k).__name__}")
            out[k] = _encode_tree(v, bufs)
        return out
    if isinstance(obj, (list, tuple)):
        return [_encode_tree(v, bufs) for v in obj]
    if isinstance(obj, np.generic):            # numpy scalar -> python
        return obj.item()
    if isinstance(obj, torch.Tensor):
        bufs.append(_TensorBuf(obj))
        return {"__buf__": len(bufs) - 1}
    try:
        arr = np.ascontiguousarray(np.asarray(obj))
    except Exception:
        raise CodecError(f"unencodable value of type "
                         f"{type(obj).__name__} in fabric frame")
    if arr.dtype == object or arr.dtype.hasobject:
        # np.asarray boxes arbitrary python objects into 0-d object
        # arrays instead of failing — refuse them explicitly
        raise CodecError(f"unencodable value of type "
                         f"{type(obj).__name__} in fabric frame")
    bufs.append(arr)
    return {"__buf__": len(bufs) - 1}


def _decode_tree(obj: Any, arrays: List[np.ndarray]) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {"__buf__"}:
            i = obj["__buf__"]
            if not isinstance(i, int) or not 0 <= i < len(arrays):
                raise CodecError(f"fabric frame references buffer {i!r} "
                                 f"of {len(arrays)}")
            return arrays[i]
        return {k: _decode_tree(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode_tree(v, arrays) for v in obj]
    return obj


def encode_frame(obj: Any, max_frame_bytes: int = 0,
                 crc: bool = False) -> bytes:
    """One self-describing frame for ``obj`` (raises the typed errors
    above; ``max_frame_bytes`` 0 = unbounded). ``crc=False`` (the
    default) emits the v1 layout byte-for-byte; ``crc=True`` emits a
    SEALED v2 frame — same layout plus a ``u32 crc32`` trailer — and is
    only valid against peers that advertised ``crc_frames`` in the
    hello. The trailer counts toward the frame bound."""
    bufs: List[Any] = []
    meta = _encode_tree(obj, bufs)
    descs = [[a.name, a.shape, a.nbytes] if isinstance(a, _TensorBuf)
             else [a.dtype.name, list(a.shape), int(a.nbytes)]
             for a in bufs]
    try:
        header = json.dumps({"v": _SEALED_FRAME_V if crc else _BASE_FRAME_V,
                             "meta": meta,
                             "bufs": descs}).encode("utf-8")
    except (TypeError, ValueError) as e:
        raise CodecError(f"fabric frame header not JSON-serializable: {e}")
    total = _HEADER_LEN + len(header) + sum(d[2] for d in descs) \
        + (4 if crc else 0)
    if max_frame_bytes and total > max_frame_bytes:
        raise FrameTooLarge(total, max_frame_bytes)
    parts = [struct.pack(_HEADER_FMT, len(header)), header]
    parts.extend(a.tobytes() for a in bufs)
    out = b"".join(parts)
    if crc:
        out += struct.pack(">I", zlib.crc32(out) & 0xFFFFFFFF)
    return out


def decode_frame(data: bytes, max_frame_bytes: int = 0) -> Any:
    """Inverse of :func:`encode_frame`. Buffers come back as writable
    views over the frame (zero-copy for a ``bytearray``; immutable
    ``bytes`` are copied once): numpy arrays, or host torch tensors for
    the :data:`_TORCH_ONLY` dtypes."""
    if max_frame_bytes and len(data) > max_frame_bytes:
        raise FrameTooLarge(len(data), max_frame_bytes)
    if len(data) < _HEADER_LEN:
        raise CodecError(f"fabric frame truncated ({len(data)} bytes)")
    (hlen,) = struct.unpack_from(_HEADER_FMT, data, 0)
    if _HEADER_LEN + hlen > len(data):
        raise CodecError("fabric frame truncated inside its header")
    try:
        header = json.loads(data[_HEADER_LEN:_HEADER_LEN + hlen]
                            .decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CodecError(f"fabric frame header unparsable: {e}")
    if not isinstance(header, dict):
        raise CodecError("fabric frame header is not an object")
    v = header.get("v")
    if v not in (_BASE_FRAME_V, _SEALED_FRAME_V):
        raise VersionMismatch(v)
    limit = len(data)
    if v == _SEALED_FRAME_V:
        # sealed frame: verify-then-strip the CRC32 trailer BEFORE
        # trusting the buffer descriptors — damage anywhere past the
        # (already-parsed) header surfaces as the typed single-frame
        # FrameCorrupt refusal, not as garbage KV bytes
        if len(data) < _HEADER_LEN + hlen + 4:
            raise CodecError("fabric frame truncated inside its trailer")
        (want,) = struct.unpack(">I", data[-4:])
        got = zlib.crc32(data[:-4]) & 0xFFFFFFFF
        if want != got:
            raise FrameCorrupt(want, got)
        limit = len(data) - 4
    if not isinstance(data, bytearray):
        data = bytearray(data)
    arrays: List[Any] = []
    off = _HEADER_LEN + hlen
    for desc in header.get("bufs", ()):
        try:
            name, shape, nbytes = desc
        except (TypeError, ValueError):
            raise CodecError(f"malformed buffer descriptor {desc!r}")
        tdt = _TORCH_ONLY.get(name) if isinstance(name, str) else None
        dtype = _np_dtype(name) if tdt is None else None
        try:
            if off + nbytes > limit:
                raise CodecError("fabric frame truncated inside a buffer")
            if tdt is not None:
                # torch.frombuffer on a bytearray aliases it writably
                size = tdt.itemsize
                if nbytes % size:
                    raise ValueError(f"{nbytes} bytes is not a whole "
                                     f"number of {name} items")
                if nbytes:
                    arr = torch.frombuffer(data, dtype=tdt,
                                           count=nbytes // size,
                                           offset=off).reshape(shape)
                else:
                    arr = torch.empty(shape, dtype=tdt)
                    if arr.numel():
                        raise ValueError("shape holds items, nbytes is 0")
            else:
                arr = np.frombuffer(data, dtype=dtype,
                                    count=nbytes // dtype.itemsize,
                                    offset=off).reshape(shape)
            off += nbytes
        except CodecError:
            raise
        except Exception as e:
            # inconsistent descriptors (nbytes vs shape/itemsize, bogus
            # shapes) raise ValueError/TypeError/RuntimeError — the contract is
            # a TYPED refusal, so the transport can kill the connection
            # cleanly instead of losing its reader thread
            raise CodecError(f"inconsistent buffer descriptor "
                             f"{desc!r}: {e}")
        arrays.append(arr)
    return _decode_tree(header.get("meta"), arrays)


# ------------------------------------------------------- request wiring
def request_to_wire(req) -> Dict[str, Any]:
    """The resumable cross-process image of a ServingRequest: identity,
    contract (budget/deadline/class), and delivery state — everything a
    replica server needs to continue the stream byte-losslessly, nothing
    process-local (events queue, spans, staging slot)."""
    import time

    remaining = (None if req.deadline_t is None
                 else max(0.0, req.deadline_t - time.monotonic()))
    return {
        "uid": int(req.uid),
        "prompt_tokens": [int(t) for t in req.prompt_tokens],
        "max_new_tokens": int(req.max_new_tokens),
        "priority": int(req.priority),
        "deadline_remaining_s": remaining,
        "eos_token_id": (int(req.eos_token_id)
                         if req.eos_token_id is not None else None),
        "request_class": req.request_class,
        "shed_rank": int(req.shed_rank),
        # tenancy labels (docs/SERVING.md "Multi-model & multi-tenant
        # serving"): extra dict fields are backward-compatible — an
        # older peer ignores them, an older sender's frame decodes with
        # the "default" fallbacks below — so CODEC_VERSION stays put
        "tenant": req.tenant,
        "model_id": req.model_id,
        "generated_tokens": [int(t) for t in req.generated_tokens],
        "attempts": int(req.attempts),
        "no_prefill": bool(req.no_prefill),
        # trace context (docs/OBSERVABILITY.md "Fleet observability"):
        # the chain name the server's spans must join — another
        # optional field, same compat story as the tenancy labels
        "trace_id": req.trace_id,
    }


def request_from_wire(d: Dict[str, Any]):
    """Rebuild a server-side ServingRequest from its wire image. The uid
    is adopted verbatim (the frontend owns uid allocation; the server
    only ever sees wire requests, so collisions are impossible)."""
    from ..request import ServingRequest

    req = ServingRequest(
        list(d["prompt_tokens"]), int(d["max_new_tokens"]),
        int(d["priority"]), d.get("deadline_remaining_s"),
        d.get("eos_token_id"),
        request_class=d.get("request_class", "interactive"),
        shed_rank=int(d.get("shed_rank", 0)),
        tenant=d.get("tenant", "default"),
        model_id=d.get("model_id", "default"))
    req.uid = int(d["uid"])
    for t in d.get("generated_tokens", ()):
        # replay through push_token so n_generated / first_token_t stay
        # internally consistent (the timestamps are server-local and
        # only feed server-private metrics)
        req.push_token(int(t))
    # drain the replayed events: they were already delivered to the real
    # stream by a previous replica; the pump must not re-send them
    while not req._events.empty():
        req._events.get_nowait()
    req.attempts = int(d.get("attempts", 1))
    req.no_prefill = bool(d.get("no_prefill", False))
    req.trace_id = d.get("trace_id")
    return req


def payload_chunks(payload: Optional[dict]) -> Tuple[Optional[dict],
                                                     List[dict]]:
    """Split a KV export payload into (metadata, chunk list) for chunked
    wire transfer. Whole-slab payloads yield one chunk; chunked exports
    (``DSStateManager.export_sequence(chunk_blocks=...)``) yield one per
    chunk. ``(None, [])`` for a missing payload."""
    if payload is None:
        return None, []
    meta = {k: v for k, v in payload.items()
            if k not in ("slabs", "chunks")}
    if "chunks" in payload:
        return meta, [{"slabs": c} for c in payload["chunks"]]
    return meta, [{"slabs": payload["slabs"]}]


def payload_from_chunks(meta: Optional[dict],
                        chunks: List[dict]) -> Optional[dict]:
    """Reassemble what :func:`payload_chunks` split. A single chunk
    restores the whole-slab form; several restore the chunked form —
    ``import_sequence`` accepts both."""
    if meta is None:
        return None
    payload = dict(meta)
    if len(chunks) == 1 and not meta.get("chunk_blocks"):
        payload["slabs"] = chunks[0]["slabs"]
    else:
        payload["chunks"] = [c["slabs"] for c in chunks]
    return payload
