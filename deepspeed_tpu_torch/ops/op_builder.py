"""Host-code op builder: compiles the port's C++ host modules with g++ and
loads them through ctypes.

Counterpart of ``deepspeed_tpu/ops/op_builder.py`` (``OpBuilder``,
``CPUAdamBuilder``, ``AsyncIOBuilder``). The sources are the port's own
(``csrc/*.cpp`` beside this package's ``ops/``; the CUDA kernels under
``ops/csrc/`` are ``_build.py``'s). A library is built at first use into
``build/host_ops/`` under the repository root, beside ``_build.BUILD_DIR``,
and its file name carries a digest of its sources and flags (``CXX_FLAGS``
and the builder's ``extra_flags``), so an edited source or a changed flag
is rebuilt.

``load()`` returns ``None`` only when g++ or a source is absent: the caller
then takes its numpy fallback. A build that fails raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..utils.logging import logger

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_ops"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


class OpBuilder:
    name = "base"
    sources: List[str] = []
    extra_flags: Tuple[str, ...] = ()

    _lib_cache: Dict[str, Optional[ctypes.CDLL]] = {}

    def compiler(self) -> Optional[str]:
        return shutil.which("g++")

    def source_paths(self) -> List[Path]:
        return [CSRC / s for s in self.sources]

    def available(self) -> bool:
        return self.compiler() is not None and all(
            p.exists() for p in self.source_paths())

    def so_path(self) -> Path:
        h = hashlib.sha256()
        for p in self.source_paths():
            h.update(p.read_bytes())
        h.update(" ".join(CXX_FLAGS + self.extra_flags).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile (once per source digest) and return the library's path.
        Concurrent builders each write their own temporary file and the
        last rename wins, so a half-written library is never loaded."""
        so = self.so_path()
        if so.exists():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ([self.compiler(), *CXX_FLAGS, *self.extra_flags]
               + [str(p) for p in self.source_paths()] + ["-o", str(tmp)])
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ build of {self.name} failed "
                               f"({' '.join(cmd)}):\n{out.stderr}")
        os.replace(tmp, so)
        logger.info(f"built host op {self.name} -> {so}")
        return so

    def load(self) -> Optional[ctypes.CDLL]:
        """Build (cached) and dlopen; ``None`` when g++ or a source is
        absent."""
        if self.name in OpBuilder._lib_cache:
            return OpBuilder._lib_cache[self.name]
        lib = ctypes.CDLL(str(self.build())) if self.available() else None
        if lib is not None:
            self.bind(lib)
        OpBuilder._lib_cache[self.name] = lib
        return lib

    def bind(self, lib: ctypes.CDLL) -> None:
        """Declare the C entry points' argument and result types."""


class CPUAdamBuilder(OpBuilder):
    """reference op_builder/cpu_adam.py (CPUAdamBuilder): the host Adam,
    Adagrad and Lion of ZeRO-Offload, vectorized by the compiler for the
    host's own SIMD width and split over its cores by OpenMP."""
    name = "cpu_adam"
    sources = ["cpu_adam.cpp"]
    extra_flags = ("-march=native", "-fopenmp", "-fno-math-errno")

    def bind(self, lib: ctypes.CDLL) -> None:
        i64, f32 = ctypes.c_int64, ctypes.c_float
        fp = ctypes.POINTER(ctypes.c_float)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.ds_adam_step.argtypes = [fp, fp, fp, fp, i64, f32, f32, f32, f32,
                                     f32, ctypes.c_int, ctypes.c_int, i64]
        lib.ds_adagrad_step.argtypes = [fp, fp, fp, i64, f32, f32, f32]
        lib.ds_lion_step.argtypes = [fp, fp, fp, i64, f32, f32, f32, f32]
        lib.ds_fp32_to_bf16.argtypes = [fp, u16p, i64]
        lib.ds_bf16_to_fp32.argtypes = [u16p, fp, i64]


class AsyncIOBuilder(OpBuilder):
    """reference op_builder/async_io.py (AsyncIOBuilder over libaio)."""
    name = "aio"
    sources = ["aio.cpp"]

    def bind(self, lib: ctypes.CDLL) -> None:
        i64 = ctypes.c_int64
        vp = ctypes.c_void_p
        charp = ctypes.POINTER(ctypes.c_char)
        lib.ds_aio_new.restype = vp
        lib.ds_aio_new.argtypes = [i64, ctypes.c_int]
        lib.ds_aio_free.argtypes = [vp]
        lib.ds_aio_pread.argtypes = [vp, ctypes.c_char_p, charp, i64, i64]
        lib.ds_aio_pwrite.argtypes = [vp, ctypes.c_char_p, charp, i64, i64]
        lib.ds_aio_wait.restype = i64
        lib.ds_aio_wait.argtypes = [vp]
        lib.ds_aio_inflight.restype = i64
        lib.ds_aio_inflight.argtypes = [vp]
