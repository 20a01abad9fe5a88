"""Tiered KV memory: host-RAM and disk spill of the prefix cache.

Counterpart of ``deepspeed_tpu/inference/v2/kv_tier.py``. When the prefix
cache evicts a cold indexed block (``DSStateManager._evict``), its pool
slabs — K and V ``[L, KH, bs, D]``, and the ``k_scale``/``v_scale`` plane
entries ``[L, KH]`` under kv_quant — are copied to a bounded host-RAM tier
under the block's index key ``(parent_hash, tokens)``. Past the host bound,
the least recently used entries demote to an optional disk tier through
:class:`~deepspeed_tpu_torch.runtime.swap_tensor.AsyncTensorSwapper` (one
file an entry, CRC-checked: a corrupt or torn file reads back as a miss);
past the disk bound they are dropped. ``match_prefix`` restores a spilled
run on a device miss and the scheduler prefills only the tail. Only
unreferenced full blocks are evicted, so only those are ever spilled.

Entries are dicts of host torch tensors of the pool's dtype. Each slab is
copied into storage of its own when the store takes it (a view into a spill
batch's pinned buffer would keep the whole batch alive while ``host_bytes``
counts only the view). A disk entry is the slabs' bytes, concatenated in
slab-name order; its ``parts`` record each slab's torch dtype, and a read
views the bytes back as that dtype, so bf16 and fp8 need no ``ml_dtypes``.
The CRC is taken over the very bytes written.
"""

from __future__ import annotations

import itertools
import os
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...utils.logging import logger

#: per-process store counter: disk files are ``kvtier_<pid>_<store>_<n>.swp``
#: so engines sharing one ``disk_path`` never touch each other's entries
_STORE_IDS = itertools.count()

#: stat keys every ``TieredKVStore.stats`` dict carries
TIER_STAT_KEYS = ("spilled", "restored", "dropped", "demoted",
                  "hits", "misses", "corrupt")
#: occupancy keys (``DSStateManager.occupancy()`` reports them as
#: ``kv_blocks_host_tier`` etc.)
TIER_OCC_KEYS = ("host_blocks", "host_bytes", "disk_blocks", "disk_bytes")


def empty_tier_stats() -> Dict[str, int]:
    """The all-zero stats and occupancy dict of a manager with no tier."""
    out = {k: 0 for k in TIER_STAT_KEYS}
    out.update({k: 0 for k in TIER_OCC_KEYS})
    return out


def _own_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host tensor with storage of its own."""
    return torch.clone(t, memory_format=torch.contiguous_format)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TieredKVStore:
    """Bounded host-RAM (and optional disk) store of spilled KV blocks.

    Both tiers are LRU OrderedDicts bounded in bytes: host overflow demotes
    to disk (when configured), disk overflow drops. ``get`` pops (the
    device pool is the authority again; a later eviction spills anew),
    serving host hits from memory and disk hits through the swapper with a
    CRC check — a corrupt entry is counted and treated as a miss."""

    def __init__(self, host_max_bytes: int,
                 disk_path: Optional[str] = None,
                 disk_max_bytes: int = 0):
        self.host_max_bytes = int(host_max_bytes)
        self.disk_max_bytes = int(disk_max_bytes)
        self._host: "OrderedDict[tuple, dict]" = OrderedDict()
        self._disk: "OrderedDict[tuple, dict]" = OrderedDict()
        self.host_bytes = 0
        self.disk_bytes = 0
        self._swapper = None
        self._disk_dir = None
        if disk_path and self.disk_max_bytes > 0:
            from ...runtime.swap_tensor.async_swapper import \
                AsyncTensorSwapper

            self._swapper = AsyncTensorSwapper(disk_path)
            self._disk_dir = disk_path
        self._file_prefix = f"kvtier_{os.getpid()}_{next(_STORE_IDS)}"
        self._next_file = 0
        self.stats: Dict[str, int] = {k: 0 for k in TIER_STAT_KEYS}
        if self._disk_dir is not None:
            self._sweep_stale_files()

    @property
    def has_native(self) -> bool:
        """Whether the disk tier writes through the native aio library."""
        return self._swapper is not None and self._swapper.has_native

    def _sweep_stale_files(self) -> None:
        """Remove spill files whose owning process is gone (a restarted
        server must not grow a shared ``disk_path`` without bound). Files
        of live processes, and files whose owner cannot be told, stay."""
        try:
            names = os.listdir(self._disk_dir)
        except OSError:
            return
        for f in names:
            if not (f.startswith("kvtier_") and f.endswith(".swp")):
                continue
            try:
                pid = int(f.split("_")[1])
            except (IndexError, ValueError):
                continue
            if pid == os.getpid():
                continue
            try:
                os.kill(pid, 0)
                continue                    # owner alive
            except ProcessLookupError:
                pass                        # owner dead: stale
            except OSError:
                continue                    # cannot tell: leave it
            try:
                os.remove(os.path.join(self._disk_dir, f))
            except OSError:
                pass

    def __del__(self):
        # a replaced engine's store must not orphan its spill files
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------ occupancy
    def occupancy(self) -> Dict[str, int]:
        return {"host_blocks": len(self._host),
                "host_bytes": int(self.host_bytes),
                "disk_blocks": len(self._disk),
                "disk_bytes": int(self.disk_bytes)}

    def __len__(self) -> int:
        return len(self._host) + len(self._disk)

    def __contains__(self, key) -> bool:
        return key in self._host or key in self._disk

    # --------------------------------------------------------------- spill
    def put(self, key: tuple, slabs: Dict[str, torch.Tensor], *,
            _count_spill: bool = True) -> bool:
        """Admit one evicted block's slabs under its index key, replacing
        any entry of that key. Returns False (counted ``dropped``) when the
        entry fits neither the host bound nor a disk tier; otherwise True,
        demoting or dropping LRU entries as the byte bounds require.
        ``_count_spill=False`` is :meth:`readmit`'s path and the preemption
        store's: the ``spilled`` counter stays monotonic."""
        entry = {name: _own_copy(a) for name, a in slabs.items()}
        nbytes = sum(_nbytes(a) for a in entry.values())
        if nbytes > self.host_max_bytes:
            # an entry the host tier can never hold goes straight to disk
            self._forget(key)
            if self._swapper is not None and self._demote(
                    key, {"slabs": entry, "nbytes": nbytes}):
                if _count_spill:
                    self.stats["spilled"] += 1
                return True
            self.stats["dropped"] += 1
            return False
        self._forget(key)
        self._host[key] = {"slabs": entry, "nbytes": nbytes}
        self.host_bytes += nbytes
        if _count_spill:
            self.stats["spilled"] += 1
        while self.host_bytes > self.host_max_bytes:
            old_key, old = self._host.popitem(last=False)
            self.host_bytes -= old["nbytes"]
            if not self._demote(old_key, old):
                self.stats["dropped"] += 1
        return True

    def _forget(self, key: tuple) -> None:
        """Remove any entry of ``key`` from both tiers (not a drop)."""
        old = self._host.pop(key, None)
        if old is not None:
            self.host_bytes -= old["nbytes"]
        meta = self._disk.pop(key, None)
        if meta is not None:
            self.disk_bytes -= meta["nbytes"]
            self._remove_file(meta["fkey"])

    # -------------------------------------------------------------- demote
    def _demote(self, key: tuple, entry: dict) -> bool:
        """Write one host entry to the disk tier; False = no disk tier or
        the write failed (the caller counts the block dropped)."""
        if self._swapper is None:
            return False
        names = sorted(entry["slabs"])
        parts = [entry["slabs"][n] for n in names]
        buf = torch.cat([p.reshape(-1).view(torch.uint8)
                         for p in parts]).numpy()
        fkey = f"{self._file_prefix}_{self._next_file}"
        self._next_file += 1
        try:
            self._swapper.swap_out(fkey, buf)
            self._swapper.wait()
        except Exception as e:
            logger.warning(f"KV tier: disk demotion failed ({e!r}); "
                           "dropping the block")
            # a partial file is outside disk_bytes and no sweep of a live
            # process touches it
            self._remove_file(fkey)
            return False
        self._disk[key] = {
            "fkey": fkey, "nbytes": buf.nbytes, "crc": zlib.crc32(buf),
            "parts": [(n, tuple(p.shape), p.dtype, _nbytes(p))
                      for n, p in zip(names, parts)]}
        self.disk_bytes += buf.nbytes
        self.stats["demoted"] += 1
        while self.disk_bytes > self.disk_max_bytes:
            _, m2 = self._disk.popitem(last=False)
            self.disk_bytes -= m2["nbytes"]
            self._remove_file(m2["fkey"])
            self.stats["dropped"] += 1
        return True

    def _remove_file(self, fkey: str) -> None:
        if self._disk_dir is None:
            return
        try:
            os.remove(os.path.join(self._disk_dir, f"{fkey}.swp"))
        except OSError:
            pass

    # -------------------------------------------------------------- restore
    def get(self, key: tuple) -> Optional[Dict[str, torch.Tensor]]:
        """Pop one entry's slabs (host first, then disk). ``None`` is a
        miss — a disk entry whose file is torn, truncated or fails its CRC
        included (counted ``corrupt``): corruption costs a re-prefill,
        never an exception on the serving path."""
        entry = self._host.pop(key, None)
        if entry is not None:
            self.host_bytes -= entry["nbytes"]
            self.stats["hits"] += 1
            return entry["slabs"]
        meta = self._disk.pop(key, None)
        if meta is None:
            self.stats["misses"] += 1
            return None
        self.disk_bytes -= meta["nbytes"]
        buf = np.empty(meta["nbytes"], np.uint8)
        try:
            self._swapper.swap_in(meta["fkey"], buf)
            self._swapper.wait()
        except Exception as e:
            logger.warning(f"KV tier: disk read for spilled block failed "
                           f"({e!r}); treating as a miss")
            self.stats["corrupt"] += 1
            self._remove_file(meta["fkey"])
            return None
        if zlib.crc32(buf) != meta["crc"]:
            logger.warning("KV tier: spilled block failed its CRC check; "
                           "treating as a miss")
            self.stats["corrupt"] += 1
            self._remove_file(meta["fkey"])
            return None
        raw = torch.from_numpy(buf)
        slabs: Dict[str, torch.Tensor] = {}
        off = 0
        for name, shape, dt, nb in meta["parts"]:
            slabs[name] = raw[off:off + nb].view(dt).reshape(shape)
            off += nb
        self.stats["hits"] += 1
        self._remove_file(meta["fkey"])
        return slabs

    def discard(self, key: tuple) -> None:
        """Drop an entry from both tiers (and its file) without touching the
        hit and miss counters: the cancel path of a parked preemption
        payload, not a lookup."""
        self._forget(key)

    def readmit(self, key: tuple, slabs: Dict[str, torch.Tensor]) -> None:
        """Put back an entry whose restore found no room: the ``get`` that
        fetched it becomes a miss, and the re-insert is not a new spill."""
        self.stats["hits"] -= 1
        self.stats["misses"] += 1
        self.put(key, slabs, _count_spill=False)

    # ------------------------------------------------------------ lifecycle
    def lru_keys(self) -> Tuple[List[tuple], List[tuple]]:
        """(host keys, disk keys), oldest first."""
        return list(self._host), list(self._disk)

    def clear(self) -> None:
        for meta in self._disk.values():
            self._remove_file(meta["fkey"])
        self._host.clear()
        self._disk.clear()
        self.host_bytes = 0
        self.disk_bytes = 0

    def close(self) -> None:
        self.clear()
        if self._swapper is not None:
            self._swapper.close()
            self._swapper = None
