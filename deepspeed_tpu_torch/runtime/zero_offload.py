"""ZeRO-Offload, ZeRO-Offload++ (Twin-Flow) and NVMe optimizer moments.

Counterpart of ``deepspeed_tpu/runtime/zero_offload.py`` (reference
``stage_1_and_2.py:1096`` with ``csrc/adam/cpu_adam_impl.cpp``; Twin-Flow
``ratio``, engine.py:703; ``partitioned_optimizer_swapper.py`` over
``csrc/aio``). The engine's step with a plan (``runtime/engine.py``):

1. on the device: unscale and clip; the kept leaves (Twin-Flow: the fraction
   ``1 - ratio`` of the bytes that the largest-first pick leaves over) take
   the overflow-gated device update;
2. the offloaded leaves' gradients go to the host a piece at a time into
   staging buffers allocated once (page-locked when ``pin_memory``, as are
   the masters), and the C++ SIMD optimizer (``ops/cpu_adam.py``) updates
   each piece's fp32 masters and moments while the next piece transfers;
   the moments live in host RAM, or in files through the aio swapper when
   ``device == "nvme"``;
3. the updated masters are copied back into the device's fp32 params, in
   place.

Leaves are numbered in the JAX flatten order of the param tree (sorted
keys, ``ops/optimizers.tree_leaves``), the order the checkpoint's
``offload/master_{i}.npy`` names use.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops.cpu_adam import (DeepSpeedCPUAdagrad, DeepSpeedCPUAdam,
                            DeepSpeedCPULion)
from ..ops.optimizers import tree_leaves
from ..utils.logging import logger
from .swap_tensor.async_swapper import OptimizerStateSwapper

_CPU_OPTS = {
    "adam": DeepSpeedCPUAdam,
    "adamw": lambda **kw: DeepSpeedCPUAdam(adamw_mode=True, **kw),
    "fusedadam": DeepSpeedCPUAdam,
    "adagrad": DeepSpeedCPUAdagrad,
    "lion": DeepSpeedCPULion,
}


class OffloadOptimizerPlan:
    """Splits the param tree into offloaded (host or NVMe) and
    device-resident leaves and owns the host update."""

    def __init__(self, params, opt_type: str, opt_params: dict,
                 device: str = "cpu", ratio: float = 1.0,
                 nvme_path: Optional[str] = None, aio_threads: int = 2,
                 pin_memory: bool = False):
        key = opt_type.lower().replace("_", "")
        if key not in _CPU_OPTS:
            raise ValueError(
                f"optimizer {opt_type!r} has no CPU-offload implementation "
                f"(reference zero_force_ds_cpu_optimizer); "
                f"known: {sorted(_CPU_OPTS)}")
        kwargs = dict(opt_params or {})
        kwargs.pop("torch_adam", None)
        self.cpu_opt = _CPU_OPTS[key](**kwargs)
        self.device = device

        leaves = tree_leaves(params)
        sizes = [leaf.numel() * 4 for leaf in leaves]
        total = sum(sizes)
        # Twin-Flow: the largest leaves until `ratio` of the bytes; the
        # stable sort breaks ties by index, as the JAX plan's does
        order = sorted(range(len(leaves)), key=lambda i: -sizes[i])
        self.offloaded: List[int] = []
        acc = 0
        for i in order:
            if acc >= ratio * total:
                break
            self.offloaded.append(i)
            acc += sizes[i]
        self.offloaded_set = set(self.offloaded)
        self.kept: List[int] = [i for i in range(len(leaves))
                                if i not in self.offloaded_set]

        # host fp32 masters: numpy arrays (torch views for the copies),
        # page-locked in place with cudaHostRegister when asked and the
        # params are on a card; torch's pinned allocator would round each
        # leaf up to a power of two, 36 GB for Mistral-7B's 29
        pin = pin_memory and leaves[0].device.type == "cuda"
        self.pinned = pin
        self._registered: List[np.ndarray] = []
        self.master_tensors: Dict[int, torch.Tensor] = {}
        self.masters: Dict[int, np.ndarray] = {}
        for i in self.offloaded:
            host = np.empty(tuple(leaves[i].shape), np.float32)
            if pin:
                self._register(host)
            self.master_tensors[i] = torch.from_numpy(host)
            self.master_tensors[i].copy_(leaves[i].detach())
            self.masters[i] = host
        # moments: host RAM, or files through the swapper (``states`` then
        # holds each moment's element count)
        self.swapper: Optional[OptimizerStateSwapper] = None
        self.states: Dict[int, dict] = {}
        self._buffers: Dict[str, np.ndarray] = {}
        if device == "nvme":
            if not nvme_path:
                raise ValueError("offload_optimizer.nvme_path required for "
                                 "NVMe")
            self.swapper = OptimizerStateSwapper(nvme_path,
                                                 n_threads=aio_threads)
            sizes_by_kind: Dict[str, int] = {}
            for i in self.offloaded:
                st = self.cpu_opt.init_state(self.masters[i].reshape(-1))
                for mk, arr in st.items():
                    self.swapper.register(f"leaf{i}_{mk}", arr.shape)
                    sizes_by_kind[mk] = max(sizes_by_kind.get(mk, 0),
                                            arr.size)
                self.states[i] = {mk: arr.size for mk, arr in st.items()}
                del st
            # one buffer a moment kind, reused by every leaf in turn
            self._buffers = {mk: np.empty(n, np.float32)
                             for mk, n in sizes_by_kind.items()}
        else:
            for i in self.offloaded:
                self.states[i] = self.cpu_opt.init_state(
                    self.masters[i].reshape(-1))
        logger.info(
            f"offload plan: {len(self.offloaded)}/{len(leaves)} leaves "
            f"({acc / max(total, 1):.0%} of bytes) -> {device}")

    def _register(self, host: np.ndarray) -> None:
        err = int(torch.cuda.cudart().cudaHostRegister(
            host.ctypes.data, host.nbytes, 0))
        if err != 0:
            raise RuntimeError(f"cudaHostRegister of {host.nbytes} bytes "
                               f"failed with cudaError {err}")
        self._registered.append(host)

    # ------------------------------------------------------------ moments
    def leaf_state(self, i: int) -> dict:
        """Leaf ``i``'s optimizer state: the host arrays, or under NVMe
        the files paged into the shared buffers (valid until the next
        leaf's call)."""
        if self.swapper is None:
            return self.states[i]
        return {mk: self.swapper.load(f"leaf{i}_{mk}",
                                      out=self._buffers[mk][:n])
                for mk, n in self.states[i].items()}

    def store_leaf_state(self, i: int, state: dict) -> None:
        """Write a leaf's state back to its files (NVMe); a no-op for host
        RAM, whose arrays were updated in place."""
        if self.swapper is not None:
            for mk, arr in state.items():
                self.swapper.store(f"leaf{i}_{mk}", arr)

    # ------------------------------------------------------------- update
    def pieces(self, i: int, max_elems: int) -> Iterator[Tuple[int, int]]:
        """``(lo, hi)`` ranges of leaf ``i``'s flat elements, each at most
        ``max_elems`` long."""
        n = self.masters[i].size
        for lo in range(0, n, max_elems):
            yield lo, min(lo + max_elems, n)

    def update_piece(self, i: int, state: dict, lo: int, grad, lr: float):
        """The C++ host optimizer on elements ``lo:lo + grad.size`` of leaf
        ``i``. Elementwise, so pieces give the bits of one whole-leaf
        call; each piece sees the leaf's step counter as the whole call
        would, and :meth:`finish_leaf` advances it once."""
        hi = lo + grad.size
        piece = {mk: (arr.copy() if mk == "step" else arr[lo:hi])
                 for mk, arr in state.items()}
        self.cpu_opt.step(self.masters[i].reshape(-1)[lo:hi], grad, piece,
                          lr=lr)

    def finish_leaf(self, i: int, state: dict) -> None:
        if "step" in state:
            state["step"][0] += 1
        self.store_leaf_state(i, state)

    def host_update_leaf(self, i: int, grad, lr: float) -> None:
        """C++ host optimizer step for one offloaded leaf."""
        g = np.ascontiguousarray(np.asarray(grad).reshape(-1), np.float32)
        state = self.leaf_state(i)
        self.update_piece(i, state, 0, g, lr)
        self.finish_leaf(i, state)

    def host_update(self, off_grads: Dict[int, np.ndarray],
                    lr: float) -> Dict[int, np.ndarray]:
        """The host optimizer on every offloaded leaf, one after another;
        the engine runs the pipelined form."""
        for i in self.offloaded:
            self.host_update_leaf(i, off_grads[i], lr)
        return self.masters

    def close(self):
        """Unregister the page-locked masters and close the swapper."""
        while self._registered:
            torch.cuda.cudart().cudaHostUnregister(
                self._registered.pop().ctypes.data)
        if self.swapper is not None:
            self.swapper.close()
            self.swapper = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
