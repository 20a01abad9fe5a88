"""N CPU ranks over gloo for the port's multi-rank tests.

``RankPool(4)`` spawns four processes, each a rank of one
``torch.distributed`` gloo world (``comm.init_distributed`` with a
``file://`` rendezvous, so parallel test workers never race for a port).
``pool.run(fn, *args)`` runs ``fn(*args)`` in every rank and returns the
ranks' results in rank order; ``fn`` is a module-level function of a module
the ranks can import (this one, or one beside it) and must not import JAX.
A rank that raises fails the call with its traceback, and the pool is
closed (its other ranks may be stuck in a collective).

Outside pytest::

    from torch_ranks import RankPool   # with tests/ on sys.path
    with RankPool(4) as pool:
        print(pool.run(some_module_level_fn, arg))
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import tempfile
import traceback


def _worker(rank, world, init_file, tasks, results):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm

    comm.init_distributed(dist_backend="gloo", device="cpu",
                          init_method=f"file://{init_file}", rank=rank,
                          world_size=world, verbose=False)
    while True:
        item = tasks.get()
        if item is None:
            break
        mod, name, args, kwargs = item
        try:
            fn = getattr(importlib.import_module(mod), name)
            results.put((rank, True, fn(*args, **kwargs)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    comm.destroy_distributed()


class RankPool:
    def __init__(self, world: int = 4):
        ctx = mp.get_context("spawn")
        self.world = world
        fd, self._init_file = tempfile.mkstemp(prefix="gloo_init_")
        os.close(fd)
        os.unlink(self._init_file)
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, world, self._init_file,
                                         self._tasks[r], self._results))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, timeout: float = 300.0, **kwargs):
        """``fn(*args, **kwargs)`` in every rank; the results by rank."""
        if self._procs is None:
            raise RuntimeError("the rank pool was closed after a failure")
        for q in self._tasks:
            q.put((fn.__module__, fn.__name__, args, kwargs))
        out, errors = [None] * self.world, []
        for _ in range(self.world):
            try:
                rank, ok, value = self._results.get(timeout=timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"{fn.__name__}: a rank took over "
                                   f"{timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                if len(errors) == 1:
                    # the other ranks may wait in a collective forever
                    self.close()
                    break
        if errors:
            raise RuntimeError(f"{fn.__name__} failed in "
                               + "\n".join(errors))
        return out

    def close(self):
        if self._procs is None:
            return
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = None
        if os.path.exists(self._init_file):
            os.unlink(self._init_file)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
