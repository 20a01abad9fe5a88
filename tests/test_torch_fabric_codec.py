"""Port parity: the fabric wire codec of ``deepspeed_tpu_torch`` against the
JAX package's ``serving/fabric/codec.py``.

The same content gives the same frame bytes in both packages: numpy arrays
(``ml_dtypes`` for bf16/fp8) on the JAX side, host torch tensors on the
port side. A JAX frame decodes in the port and re-encodes to the same
bytes, and a port frame does the same through the JAX codec. Cases:
request wire images, fp32/bf16/int8/fp8 KV slabs with their scale planes,
``last_logits``, whole and chunked payloads, and sealed (CRC) frames. The
typed refusals match class for class, and decoding needs no ``ml_dtypes``
(a subprocess with the module made unimportable also checks that the
fabric modules and the launch scripts import neither JAX nor the JAX
package).
"""

import json
import os
import struct
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.serving import ServingRequest as JRequest
from deepspeed_tpu.serving.fabric import codec as jcodec
from deepspeed_tpu_torch.serving import ServingRequest as TRequest
from deepspeed_tpu_torch.serving.fabric import codec as tcodec
import torch_cpu  # noqa: F401  (one torch thread: see the module)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NP = {"float32": np.float32, "int8": np.int8,
       "bfloat16": ml_dtypes.bfloat16,
       "float8_e4m3fn": ml_dtypes.float8_e4m3fn}
_TORCH = {"float32": torch.float32, "int8": torch.int8,
          "bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}


def _pair(rng, shape, dtype):
    """The same bytes as a JAX-side numpy array and a port-side tensor."""
    if dtype == "int8":
        a = rng.integers(-128, 128, size=shape).astype(np.int8)
    else:
        a = (rng.normal(size=shape) * 3).astype(np.float32) \
            .astype(_NP[dtype])
    raw = np.frombuffer(a.tobytes(), np.uint8).copy()
    t = torch.from_numpy(raw).view(_TORCH[dtype]).reshape(shape)
    return a, t


def _slabs(rng, kv, n_blocks=3):
    """A pool's slabs ``[L, blocks, bs, KH, D]`` (+ ``[L, blocks, KH]``
    scale planes for a quantized pool): (numpy, torch) dicts."""
    shape = (2, n_blocks, 8, 2, 4)
    out_j, out_t = {}, {}
    for name in ("k", "v"):
        out_j[name], out_t[name] = _pair(rng, shape, kv)
    if kv in ("int8", "float8_e4m3fn"):
        for name in ("k_scale", "v_scale"):
            out_j[name], out_t[name] = _pair(rng, (2, n_blocks, 2),
                                             "float32")
    return out_j, out_t


def _payload(kv, chunk_blocks=0, seed=0):
    rng = np.random.default_rng(seed)
    meta = {"seen_tokens": 21, "block_size": 8,
            "kv_quant": kv != "bfloat16" and kv != "float32",
            "kv_quant_dtype": {"int8": "int8",
                               "float8_e4m3fn": "fp8_e4m3"}.get(kv, "int8"),
            "n_blocks": 3}
    pj, pt = dict(meta), dict(meta)
    if chunk_blocks:
        pj["chunk_blocks"] = pt["chunk_blocks"] = chunk_blocks
        pj["chunks"], pt["chunks"] = [], []
        for i, n in enumerate((2, 1)):
            j, t = _slabs(np.random.default_rng(seed + i + 1), kv, n)
            pj["chunks"].append(j)
            pt["chunks"].append(t)
    else:
        pj["slabs"], pt["slabs"] = _slabs(rng, kv)
    logits = rng.normal(size=128).astype(np.float32)
    pj["last_logits"] = logits
    pt["last_logits"] = logits.copy()       # the port's scheduler: numpy
    return pj, pt


def _request(mod_req):
    req = mod_req([5, 6, 7, 8], 16, 1, None, 3, request_class="batch",
                  shed_rank=2, tenant="t1", model_id="m")
    req.uid = 41
    req.push_token(9)
    req.push_token(10)
    req.attempts = 2
    req.no_prefill = True
    req.trace_id = "req-41"
    return req


def _content(case):
    """(JAX-side object, port-side object, encode kwargs) for one case."""
    if case == "request":
        return ({"t": "call", "id": 3, "m": "assign",
                 "p": {"req": jcodec.request_to_wire(_request(JRequest)),
                       "staged_meta": None}},
                {"t": "call", "id": 3, "m": "assign",
                 "p": {"req": tcodec.request_to_wire(_request(TRequest)),
                       "staged_meta": None}}, {})
    kv, _, form = case.partition("-")
    pj, pt = _payload(kv, chunk_blocks=1 if form == "chunked" else 0)
    if form == "meta":
        # what the handoff event carries after its chunk frames
        mj, _ = jcodec.payload_chunks(pj)
        mt, _ = tcodec.payload_chunks(pt)
        return ({"t": "ev", "ev": "handoff", "uid": 7, "meta": mj},
                {"t": "ev", "ev": "handoff", "uid": 7, "meta": mt}, {})
    if form in ("whole", "chunked"):
        # each chunk frame of the wire transfer
        _, cj = jcodec.payload_chunks(pj)
        _, ct = tcodec.payload_chunks(pt)
        return ([{"t": "ev", "ev": "payload_chunk", "uid": 7,
                  "slabs": c["slabs"]} for c in cj],
                [{"t": "ev", "ev": "payload_chunk", "uid": 7,
                  "slabs": c["slabs"]} for c in ct], {})
    if form == "sealed":
        return pj, pt, {"crc": True}
    return pj, pt, {}


CASES = ["request", "float32", "bfloat16", "int8", "float8_e4m3fn",
         "float32-meta", "bfloat16-whole", "int8-chunked",
         "float8_e4m3fn-chunked", "bfloat16-sealed", "int8-sealed"]


def _frames(obj, mod, **kw):
    objs = obj if isinstance(obj, list) else [obj]
    return [mod.encode_frame(o, **kw) for o in objs]


@pytest.mark.parametrize("case", CASES)
def test_frames_byte_identical_both_ways(case):
    """The port encodes the port-side content to the JAX codec's bytes; a
    JAX frame decodes in the port and re-encodes to the same bytes, and a
    port frame decodes in the JAX codec and re-encodes to the same bytes.
    bf16/fp8 buffers decode into torch tensors of that dtype."""
    cj, ct, kw = _content(case)
    jf = _frames(cj, jcodec, **kw)
    tf = _frames(ct, tcodec, **kw)
    assert tf == jf, f"{case}: port frame bytes differ from the JAX codec's"
    for frame in jf:
        back = tcodec.decode_frame(frame)
        assert tcodec.encode_frame(back, **kw) == frame
        assert jcodec.encode_frame(jcodec.decode_frame(frame), **kw) == frame

        def walk(o):
            if isinstance(o, dict):
                for v in o.values():
                    walk(v)
            elif isinstance(o, list):
                for v in o:
                    walk(v)
            elif isinstance(o, torch.Tensor):
                assert o.dtype in (torch.bfloat16, torch.float8_e4m3fn), \
                    o.dtype
                assert o.device.type == "cpu"
            elif isinstance(o, np.ndarray):
                assert o.dtype.name not in ("bfloat16", "float8_e4m3fn")
                assert o.flags.writeable

        walk(back)
    if case == "request":
        back = tcodec.request_from_wire(tcodec.decode_frame(jf[0])["p"]["req"])
        assert (back.uid, back.prompt_tokens, back.generated_tokens,
                back.attempts, back.no_prefill, back.tenant, back.model_id,
                back.trace_id, back.request_class, back.shed_rank) == \
            (41, [5, 6, 7, 8], [9, 10], 2, True, "t1", "m", "req-41",
             "batch", 2)
        assert back._events.empty()


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8",
                                "float8_e4m3fn"])
def test_payload_reassembles_to_port_tensors(kv):
    """Chunk frames of a JAX payload reassemble in the port into the
    chunked form ``import_sequence`` takes, with each slab's bytes and
    dtype intact."""
    pj, pt = _payload(kv, chunk_blocks=1, seed=3)
    meta, chunks = jcodec.payload_chunks(pj)
    got = tcodec.payload_from_chunks(
        tcodec.decode_frame(jcodec.encode_frame(meta)),
        [{"slabs": tcodec.decode_frame(jcodec.encode_frame(c["slabs"]))}
         for c in chunks])
    assert len(got["chunks"]) == 2 and got["chunk_blocks"] == 1
    for want, have in zip(pt["chunks"], got["chunks"]):
        assert set(want) == set(have)
        for name in want:
            h = have[name]
            h = h if isinstance(h, torch.Tensor) else torch.from_numpy(h)
            assert h.dtype == want[name].dtype
            assert torch.equal(h.view(torch.uint8),
                               want[name].view(torch.uint8))


def _doctor(frame, **header_over):
    (hlen,) = struct.unpack(">I", frame[:4])
    header = json.loads(frame[4:4 + hlen].decode())
    for k, v in header_over.items():
        if k == "nbytes":
            header["bufs"][0][2] = v
        elif k == "dtype":
            header["bufs"][0][0] = v
        else:
            header[k] = v
    bad = json.dumps(header).encode()
    return struct.pack(">I", len(bad)) + bad + frame[4 + hlen:]


def _flip_last_payload_byte(frame):
    b = bytearray(frame)
    b[-5] ^= 0x10
    return bytes(b)


_A = np.arange(9, dtype=np.int8).reshape(3, 3)
REFUSALS = {
    "version": lambda m: m.decode_frame(
        _doctor(m.encode_frame({"x": 1}), v=99)),
    "truncated": lambda m: m.decode_frame(b"\x00"),
    "garbage": lambda m: m.decode_frame(b"\x00\x00\x00\xffgarbage"),
    "nbytes-lie": lambda m: m.decode_frame(
        _doctor(m.encode_frame({"a": _A}), nbytes=4)),
    "unknown-dtype": lambda m: m.decode_frame(
        _doctor(m.encode_frame({"a": _A}), dtype="float7_weird")),
    "truncated-buffer": lambda m: m.decode_frame(
        m.encode_frame({"a": _A})[:-3]),
    "crc": lambda m: m.decode_frame(_flip_last_payload_byte(
        m.encode_frame({"a": _A}, crc=True))),
    "oversized-encode": lambda m: m.encode_frame(
        {"big": np.zeros(1 << 12)}, max_frame_bytes=1024),
    "oversized-decode": lambda m: m.decode_frame(
        m.encode_frame({"big": np.zeros(1 << 12)}), max_frame_bytes=1024),
    "unencodable": lambda m: m.encode_frame({"fn": lambda: 1}),
    "int-key": lambda m: m.encode_frame({1: 2}),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_typed_refusals_match(name):
    """Every malformed or oversized frame is refused by the same typed
    error in both packages (same class name, same message for the errors
    that carry numbers)."""
    errs = []
    for mod in (jcodec, tcodec):
        with pytest.raises(mod.CodecError) as ei:
            REFUSALS[name](mod)
        errs.append(ei.value)
    assert type(errs[0]).__name__ == type(errs[1]).__name__
    if isinstance(errs[0], (jcodec.VersionMismatch, jcodec.FrameTooLarge,
                            jcodec.FrameCorrupt)):
        assert str(errs[0]) == str(errs[1])
    assert (tcodec.CODEC_VERSION, tcodec.COMPAT_CODEC_VERSIONS) == \
        (jcodec.CODEC_VERSION, jcodec.COMPAT_CODEC_VERSIONS)


def test_decodes_without_ml_dtypes(tmp_path):
    """In a process where ``ml_dtypes`` cannot be imported, the port
    decodes JAX-written bf16/fp8 frames into torch tensors of those dtypes
    with the same bytes, and the fabric modules and launch scripts load
    neither JAX, ``ml_dtypes`` nor the JAX package."""
    pj, pt = _payload("float8_e4m3fn", seed=5)
    pj["bf16"] = _pair(np.random.default_rng(9), (4, 3), "bfloat16")[0]
    path = tmp_path / "frame.bin"
    path.write_bytes(jcodec.encode_frame(pj, crc=True))
    want = {name: pt["slabs"][name].view(torch.uint8).numpy().tobytes()
            for name in ("k", "v")}
    code = (
        "import sys, json\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "import deepspeed_tpu_torch.serving.fabric as fab\n"
        "from deepspeed_tpu_torch.serving.fabric import (codec, chaos,\n"
        "    federation, remote, server, transport, handle)\n"
        "from deepspeed_tpu_torch.scripts import (serve_replica,\n"
        "    serve_frontend, fleetctl)\n"
        f"d = codec.decode_frame(open({str(path)!r}, 'rb').read())\n"
        "assert d['slabs']['k'].dtype == torch.float8_e4m3fn\n"
        "assert d['bf16'].dtype == torch.bfloat16\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'ml_dtypes', 'deepspeed_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(json.dumps({n: d['slabs'][n].view(torch.uint8).numpy()\n"
        "                  .tobytes().hex() for n in ('k', 'v')}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=_REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert {n: bytes.fromhex(h) for n, h in got.items()} == want
