"""Async tensor swapper over the native aio engine.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/async_swapper.py``
(reference ``runtime/swap_tensor/async_swapper.py`` and
``partitioned_optimizer_swapper.py`` over ``csrc/aio``): moves flat numpy
arrays between host memory and files with overlapped background I/O,
through the port's ``csrc/aio.cpp`` (built with g++ by
``ops/op_builder.AsyncIOBuilder`` at first use). Where g++ or the source is
absent it falls back to synchronous numpy file I/O; ``has_native`` says
which path a swapper took.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict

import numpy as np

from ...ops.op_builder import AsyncIOBuilder


class AsyncTensorSwapper:
    def __init__(self, swap_dir: str, block_size: int = 1 << 20,
                 n_threads: int = 2):
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self._lib = AsyncIOBuilder().load()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.ds_aio_new(block_size, n_threads)

    @property
    def has_native(self) -> bool:
        return self._handle is not None

    def _path(self, key: str) -> str:
        return os.path.join(self.swap_dir, f"{key}.swp")

    @staticmethod
    def _pointer(array: np.ndarray):
        """The address the native library reads or writes ``array.nbytes``
        bytes at: only a C-contiguous array is one such range."""
        if not array.flags.c_contiguous:
            raise ValueError("AsyncTensorSwapper needs a C-contiguous array")
        return array.ctypes.data_as(ctypes.POINTER(ctypes.c_char))

    def swap_out(self, key: str, array: np.ndarray) -> None:
        """Write ``array`` (C-contiguous) to its file, in the background
        when native: it must stay alive and unchanged until :meth:`wait`
        returns."""
        if self._handle is not None:
            self._lib.ds_aio_pwrite(self._handle, self._path(key).encode(),
                                    self._pointer(array), array.nbytes, 0)
            return
        # synchronous fallback: temp file, flush and fsync, atomic rename —
        # a crash mid-write leaves the old complete file or none, never a
        # torn one
        path = self._path(key)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as fh:
                array.tofile(fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def swap_in(self, key: str, array: np.ndarray) -> None:
        """Read the file into ``array`` (in the background when native)."""
        if self._handle is not None:
            self._lib.ds_aio_pread(self._handle, self._path(key).encode(),
                                   self._pointer(array), array.nbytes, 0)
        else:
            array[...] = np.fromfile(self._path(key),
                                     dtype=array.dtype).reshape(array.shape)

    def wait(self) -> None:
        """Block until every queued read and write has finished; raises
        ``IOError`` if any failed (a short read included)."""
        if self._handle is not None:
            errors = self._lib.ds_aio_wait(self._handle)
            if errors:
                raise IOError(f"{errors} async I/O operations failed "
                              f"in {self.swap_dir}")

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def close(self):
        if self._handle is not None:
            self._lib.ds_aio_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class OptimizerStateSwapper:
    """File-resident optimizer moments (the ZeRO-Infinity tier, reference
    partitioned_optimizer_swapper.py): keeps them on disk and pages them
    into reusable host buffers around each optimizer step."""

    def __init__(self, swap_dir: str, n_threads: int = 2):
        self.swapper = AsyncTensorSwapper(swap_dir, n_threads=n_threads)
        self._shapes: Dict[str, tuple] = {}
        self._buffers: Dict[str, np.ndarray] = {}

    def register(self, key: str, shape: tuple, dtype=np.float32) -> None:
        self._shapes[key] = (tuple(shape), np.dtype(dtype))
        init = np.zeros(shape, dtype)
        self.swapper.swap_out(key, init)
        self.swapper.wait()

    def _buffer(self, key: str) -> np.ndarray:
        shape, dtype = self._shapes[key]
        if key not in self._buffers or self._buffers[key].shape != shape:
            self._buffers[key] = np.empty(shape, dtype)
        return self._buffers[key]

    def load(self, key: str, out: np.ndarray = None) -> np.ndarray:
        """The file's array, read into ``out`` when given (a buffer the
        caller reuses across keys, so host RAM holds no copy a key), else
        into this swapper's own buffer for ``key``."""
        if out is None:
            buf = self._buffer(key)
        else:
            shape, dtype = self._shapes[key]
            if out.shape != shape or out.dtype != dtype:
                raise ValueError(f"{key}: buffer {out.shape} {out.dtype}, "
                                 f"file {shape} {dtype}")
            buf = out
        self.swapper.swap_in(key, buf)
        self.swapper.wait()
        return buf

    def store(self, key: str, array: np.ndarray, wait: bool = True) -> None:
        self.swapper.swap_out(key, array)
        if wait:
            self.swapper.wait()

    def close(self):
        self.swapper.close()
