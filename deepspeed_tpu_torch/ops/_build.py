"""Build and load the port's hand-written CUDA kernels.

Counterpart of ``deepspeed_tpu/ops/pallas_utils.py`` (where the JAX package
decides whether a Pallas kernel can run) and ``ops/op_builder.py`` (where it
builds its host C++). Here every ``csrc/<name>.cu`` is compiled at first use
by ``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface under ``build/kernels/``, and loaded with ``ctypes``. Pointers and
the stream cross as ``c_void_p``; each C entry point returns
``cudaGetLastError()`` after its launch and :func:`check` raises on anything
but 0.

Nothing here falls back: a CUDA machine without ``nvcc`` is an error, and a
failed build raises with the compiler's output. A library's file name carries
a digest of its source and flags, so an edited source is rebuilt and a stale
build is never loaded. :func:`build` starts one ``nvcc`` per source, all at
once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(os.environ.get(
    "DSTORCH_BUILD_DIR",
    Path(__file__).resolve().parents[2] / "build" / "kernels"))
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}        # name -> nvcc's output (ptxas -v)


def sources() -> Dict[str, Path]:
    """Every kernel source of the port, by name (file stem)."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def find_nvcc() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (NVCC, PATH, CUDA_HOME, /usr/local/cuda): the "
        "port's CUDA kernels are built from source at first use")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernel sources (default: all) that are not built
    yet, one ``nvcc`` each, all started together. Returns the seconds each
    compile took (empty when everything was already built)."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    for n in names:
        if n not in srcs:
            raise KeyError(f"no kernel source {n}.cu in {CSRC}")
    todo = {n: _lib_path(srcs[n]) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-o",
               str(tmp), str(srcs[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    done: Dict[str, float] = {}
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = log
        done[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(sources()[name])))
            lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ds_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.ds_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

