"""Ragged sequence state: descriptors, block tables, paged KV pools.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/manager.py``: a registry
of per-sequence descriptors (seen-token count and KV block ownership),
on-demand block allocation, and the device-side paged pools
``[L, NB, KH, bs, D]`` (the per-(block, kv-head) slab is the trailing
``[bs, D]``, the layout ``ops/csrc/paged_attention.cu`` reads). The pools
are torch tensors on the engine's device and ``PagedCausalLM`` writes them
in place. With ``kv_quant`` the pools are int8 or float8_e4m3fn
(``kv_quant_dtype``) with f32 scale planes ``k_scale``/``v_scale``
``[L, NB, KH]`` beside them (``kv_quant.py``).

Prefix cache: every *full* KV block a sequence fills is registered in an
index keyed by ``(parent_chain_hash, block_tokens)`` with the chain
``h_i = hash((h_{i-1}, tokens_i))`` starting at 0 — the JAX package's keys
exactly, so the two packages give the same ``prefix_digest`` for the same
traffic. A later sequence whose prompt starts with the same tokens shares
those blocks (:meth:`DSStateManager.match_prefix`); shared blocks are never
written (a sequence writes only at positions past its matched length, and
the last token of a prompt is never served from the cache). The cache holds
a reference of its own on each indexed block; blocks held only by it are
evicted in LRU order when an allocation would otherwise fail.

KV tier (``configure_kv_tier``, ``kv_tier.py``): with one configured, an
evicted block's slabs are copied to a bounded host-RAM (and disk) store under
its index key before the block is reused, and ``match_prefix`` restores a
spilled run into fresh blocks on a device miss. The gather of the evicted
blocks is enqueued on the pools' stream inside ``_evict``, before any write
could reuse them (torch pools change in place); a restore writes through
``_scatter`` from pageable host memory, a copy that has consumed its source
when it returns. A preempted sequence's payload is parked in the tier too.

Also here: ``trim_sequence`` (speculative-decoding rollback), KV
``export_sequence``/``import_sequence`` (whole or chunked, scale planes
included), the reservation ledger and the host-RAM preemption store.
Device-to-host copies are non-blocking copies into pinned host tensors,
all started before the first is read. A payload's slabs are host tensors
of the pool's dtype (bf16 and fp8 stay torch tensors; nothing needs
``ml_dtypes``).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .... import comm, resolve_device
from ....parallel.topology import TENSOR_AXIS
from ..kv_quant import kv_bytes_per_block, pool_dtype
from ..kv_tier import TieredKVStore, empty_tier_stats
from .blocked_allocator import BlockedAllocator


@dataclass
class DSSequenceDescriptor:
    uid: int
    seen_tokens: int = 0                   # tokens already in the KV cache
    kv_blocks: List[int] = field(default_factory=list)
    # prefix-cache chain state: hash through the last full block, how many
    # leading blocks have been hashed, and the tokens of the partial block
    chain_hash: int = 0
    hashed_blocks: int = 0
    pending_tokens: List[int] = field(default_factory=list)

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self.kv_blocks)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A byte view of a float8 tensor (gathers and scatters move bytes, and
    not every index op takes float8); any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _to_host(arrs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device tensors to host tensors: every copy is started (non-blocking,
    into pinned memory) before the stream is waited on once. CPU tensors
    are already host copies (``index_select`` made them)."""
    out, stream = {}, None
    for name, a in arrs.items():
        if a.is_cuda:
            h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            h.copy_(a, non_blocking=True)
            stream = torch.cuda.current_stream(a.device)
            out[name] = h
        else:
            out[name] = a
    if stream is not None:
        stream.synchronize()
    return out


class DSStateManager:
    """Sequence registry + paged KV pools (reference ragged_manager.py:204)."""

    def __init__(self, model_cfg, max_tracked_sequences: int = 256,
                 num_blocks: int = 256, block_size: int = 16,
                 dtype: Optional[torch.dtype] = None, device=None,
                 tp: int = 1,
                 enable_prefix_cache: bool = False,
                 prefix_cache_max_blocks: Optional[int] = None,
                 kv_quant: bool = False, kv_quant_dtype: str = "int8",
                 kv_tier_enabled: bool = False,
                 kv_tier_host_bytes: int = 64 * 1024 * 1024,
                 kv_tier_disk_path: Optional[str] = None,
                 kv_tier_disk_bytes: int = 0):
        self.cfg = model_cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_tracked_sequences = max_tracked_sequences
        self.device = resolve_device(device)
        # tensor parallelism: this rank holds kv heads [r·KH/tp, (r+1)·KH/tp)
        # of every pool and scale plane
        self.tp = int(tp)
        self.kv_quant = bool(kv_quant)
        self.kv_quant_dtype = str(kv_quant_dtype)
        dt = dtype or model_cfg.dtype
        self.allocator = BlockedAllocator(
            num_blocks, bytes_per_block=kv_bytes_per_block(
                model_cfg, block_size, self.kv_quant, dt))
        self._seqs: Dict[int, DSSequenceDescriptor] = {}
        # reservation ledger: per-sequence TOTAL projected block need,
        # recorded at admission (empty = passive)
        self._reserved: Dict[int, int] = {}
        # preemption store: whole-sequence exports parked in the KV tier
        # when one is configured, else in host RAM here
        self._preempt_store: Dict[int, dict] = {}
        # prefix cache: index key (parent_chain_hash, block_tokens) -> block
        self.prefix_cache_enabled = bool(enable_prefix_cache)
        self.prefix_cache_max_blocks = prefix_cache_max_blocks or 0
        self._index: "OrderedDict[tuple, int]" = OrderedDict()
        self._block_hash: Dict[int, tuple] = {}
        self._evictable = 0      # indexed blocks held by the cache alone
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "tokens_saved": 0, "queries": 0}
        # KV tier: None is the drop-on-evict prefix cache
        self._tier = None
        self._restore_times: List[float] = []
        if kv_tier_enabled:
            self.configure_kv_tier(True, host_bytes=kv_tier_host_bytes,
                                   disk_path=kv_tier_disk_path,
                                   disk_bytes=kv_tier_disk_bytes)
        shape = (model_cfg.num_layers, num_blocks,
                 model_cfg.kv_heads // self.tp, block_size,
                 model_cfg.head_dim)
        pool_dt = pool_dtype(self.kv_quant_dtype) if self.kv_quant else dt

        # distinct buffers: they are written in place
        def zeros(shp, adt):
            return torch.zeros(shp, dtype=adt, device=self.device)

        self.kv_cache = {"k": zeros(shape, pool_dt), "v": zeros(shape, pool_dt)}
        if self.kv_quant:
            # a freed block's stale scale is ignored (not reset) by the
            # fresh-block rule of kv_quant.quantized_block_write
            self.kv_cache["k_scale"] = zeros(shape[:3], torch.float32)
            self.kv_cache["v_scale"] = zeros(shape[:3], torch.float32)

    # -- sequence registry -------------------------------------------------
    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        if uid not in self._seqs:
            if len(self._seqs) >= self.max_tracked_sequences:
                raise RuntimeError("max tracked sequences exceeded")
            self._seqs[uid] = DSSequenceDescriptor(uid=uid)
        return self._seqs[uid]

    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def flush_sequence(self, uid: int) -> None:
        """Release a finished sequence's blocks and its reservation. Blocks
        the prefix cache also holds stay resident and become evictable once
        no sequence refers to them."""
        seq = self._seqs.pop(uid, None)
        self._reserved.pop(uid, None)
        if seq is not None and seq.kv_blocks:
            self._release_blocks(seq.kv_blocks)

    def _release_blocks(self, blocks: List[int]) -> None:
        """Drop one reference per block, counting the indexed blocks whose
        only remaining reference is the cache's (flush and trim)."""
        self.allocator.release(blocks)
        if self.prefix_cache_enabled:
            for b in blocks:
                if (b in self._block_hash
                        and self.allocator.ref_count(b) == 1):
                    self._evictable += 1

    def trim_sequence(self, uid: int, n_tokens: int) -> int:
        """KV rollback: drop the trailing ``n_tokens`` of a sequence (the
        rejected drafts of a speculative step). Trailing blocks that become
        empty are released; blocks below the new length are untouched.
        Trimming into prefix-indexed blocks, or dropping a block shared
        outside the index, raises ``ValueError``. Returns the number of
        blocks released."""
        seq = self._seqs.get(uid)
        if seq is None or n_tokens <= 0:
            return 0
        if n_tokens > seq.seen_tokens:
            raise ValueError(
                f"cannot trim {n_tokens} tokens from sequence {uid} "
                f"({seq.seen_tokens} seen)")
        new_seen = seq.seen_tokens - n_tokens
        if new_seen < seq.hashed_blocks * self.block_size:
            raise ValueError(
                f"cannot trim sequence {uid} into prefix-indexed blocks "
                f"({seq.hashed_blocks} blocks hashed, want "
                f"{new_seen} tokens)")
        keep = -(-new_seen // self.block_size)       # ceil; 0 when new_seen=0
        dropped = seq.kv_blocks[keep:]
        for b in dropped:
            if self.allocator.is_shared(b) and b not in self._block_hash:
                raise ValueError(
                    f"cannot trim block {b} of sequence {uid}: shared "
                    "outside the prefix index (sharing invariant violated)")
        del seq.kv_blocks[keep:]
        seq.seen_tokens = new_seen
        # chain state: pending (un-blocked) tokens past the new end go
        over = (seq.hashed_blocks * self.block_size
                + len(seq.pending_tokens)) - new_seen
        if over > 0:
            del seq.pending_tokens[len(seq.pending_tokens) - over:]
        if dropped:
            self._release_blocks(dropped)
        return len(dropped)

    # -- KV handoff ----------------------------------------------------------
    def _gather(self, blocks: Sequence[int]) -> Dict[str, torch.Tensor]:
        """Every pool's slabs at ``blocks`` (dim 1), as device tensors, with
        every kv head (dim 2): under tensor parallelism the ranks' heads
        are all-gathered, so every rank must make the call."""
        ids = torch.as_tensor(list(blocks), dtype=torch.long,
                              device=self.device)
        out = {name: _raw(pool).index_select(1, ids)
               for name, pool in self.kv_cache.items()}
        if self.tp > 1:
            out = {name: comm.all_gather_into_tensor(None, a, TENSOR_AXIS,
                                                     axis=2)
                   for name, a in out.items()}
        return out

    def _typed(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Host byte views back to each pool's dtype."""
        return {name: (t.view(self.kv_cache[name].dtype)
                       if t.dtype != self.kv_cache[name].dtype else t)
                for name, t in host.items()}

    def _scatter(self, blocks: Sequence[int],
                 slabs: Dict[str, object]) -> None:
        """Write host slabs (tensors, or numpy arrays of the pool's bytes)
        into every pool at ``blocks``."""
        ids = torch.as_tensor(list(blocks), dtype=torch.long,
                              device=self.device)
        for name, pool in self.kv_cache.items():
            src = slabs[name]
            if isinstance(src, np.ndarray):
                src = torch.from_numpy(np.ascontiguousarray(src))
            raw, src = _raw(pool), _raw(src)
            if src.dtype != raw.dtype:        # e.g. bf16 widened to fp32
                src = _raw(src.to(pool.dtype))
            if self.tp > 1:                   # this rank's kv heads
                n = raw.shape[2]
                src = src.narrow(2, comm.axis_index(TENSOR_AXIS) * n, n)
            raw.index_copy_(1, ids, src.to(self.device))

    def export_sequence(self, uid: int,
                        chunk_blocks: int = 0) -> Optional[Dict[str, object]]:
        """Host-RAM snapshot of a sequence's KV for cross-engine handoff:
        every pool slab its block table references — K and V, and the
        ``k_scale``/``v_scale`` planes under kv_quant — copied whole
        (stale slots past ``seen_tokens`` included), with the metadata
        :meth:`import_sequence` checks. ``None`` for unknown or empty
        sequences; the sequence keeps its state.

        ``chunk_blocks`` > 0 gives the streamed form: ``"chunks"``, a list
        of slab dicts of at most ``chunk_blocks`` blocks each, every
        chunk's copy started before any is read; the bytes are those of
        the whole form."""
        seq = self._seqs.get(uid)
        if seq is None or not seq.kv_blocks:
            return None
        meta = {"seen_tokens": seq.seen_tokens,
                "block_size": self.block_size,
                "kv_quant": self.kv_quant,
                "kv_quant_dtype": self.kv_quant_dtype,
                "n_blocks": len(seq.kv_blocks)}
        if chunk_blocks and chunk_blocks > 0:
            step = int(chunk_blocks)
            parts = [self._gather(seq.kv_blocks[s:s + step])
                     for s in range(0, len(seq.kv_blocks), step)]
            flat = _to_host({f"{i}/{name}": a for i, c in enumerate(parts)
                             for name, a in c.items()})
            meta["chunk_blocks"] = step
            meta["chunks"] = [self._typed({name: flat[f"{i}/{name}"]
                                           for name in c})
                              for i, c in enumerate(parts)]
            return meta
        meta["slabs"] = self._typed(_to_host(self._gather(seq.kv_blocks)))
        return meta

    def import_sequence(self, uid: int, payload: Dict[str, object],
                        tokens: Sequence[int]) -> None:
        """Adopt an exported sequence: allocate fresh blocks, write the
        payload's slabs (and scale planes) at the new ids, and seed the
        descriptor at the source's ``seen_tokens``. ``tokens`` (as many as
        ``seen_tokens``) replay ``record_tokens`` so the prefix index covers
        the imported blocks. Raises on a representation mismatch (block
        size, kv_quant and its dtype, slab keys), on a uid with state and on
        too few blocks; a failure leaves the manager untouched. Takes the
        whole (``"slabs"``) and the chunked (``"chunks"``) form.

        A fresh block keeps its previous tenant's scale-plane entry until
        the payload's scales overwrite it; the next write of a partly
        filled last block then keeps the payload's scale (the monotone
        rule), as it would have in the source engine."""
        chunks = payload.get("chunks")
        slabs = (payload["slabs"] if chunks is None
                 else {k: None for k in chunks[0]} if chunks
                 else {k: None for k in self.kv_cache})
        if int(payload["block_size"]) != self.block_size:
            raise ValueError(
                f"KV import block_size mismatch: payload "
                f"{payload['block_size']} vs pool {self.block_size}")
        if bool(payload["kv_quant"]) != self.kv_quant:
            raise ValueError(
                f"KV import representation mismatch: payload kv_quant="
                f"{payload['kv_quant']} vs pool kv_quant={self.kv_quant}")
        pay_dt = str(payload.get("kv_quant_dtype", "int8"))
        if self.kv_quant and pay_dt != self.kv_quant_dtype:
            raise ValueError(
                f"KV import representation mismatch: payload "
                f"kv_quant_dtype={pay_dt!r} vs pool "
                f"{self.kv_quant_dtype!r}")
        if set(slabs) != set(self.kv_cache):
            raise ValueError(f"KV import slab keys {sorted(slabs)} != "
                             f"pool keys {sorted(self.kv_cache)}")
        seen = int(payload["seen_tokens"])
        if len(tokens) != seen:
            raise ValueError(f"KV import needs the {seen} tokens the KV "
                             f"encodes, got {len(tokens)}")
        existing = self._seqs.get(uid)
        if existing is not None and (existing.seen_tokens
                                     or existing.kv_blocks):
            raise ValueError(f"cannot import into sequence {uid}: it "
                             "already has KV state")
        n = int(payload["n_blocks"])
        if chunks is not None:
            got = sum(int(next(iter(c.values())).shape[1]) for c in chunks)
            if got != n:
                raise ValueError(f"KV import chunks cover {got} blocks, "
                                 f"payload claims {n}")
        short = n - self.allocator.free_blocks
        if short > 0 and self.prefix_cache_enabled:
            self._evict(short)
        if n > self.allocator.free_blocks:
            raise RuntimeError(
                f"cannot import {n} KV blocks "
                f"({self.allocator.free_blocks} free)")
        seq = self.get_or_create_sequence(uid)
        blocks = self.allocator.allocate(n)
        try:
            if chunks is not None:
                # glue the chunks per slab and write each pool once
                slabs = {name: torch.cat([_raw(torch.as_tensor(c[name]))
                                          for c in chunks], dim=1)
                         for name in self.kv_cache}
            self._scatter(blocks, slabs)
            seq.kv_blocks.extend(blocks)
            seq.seen_tokens = seen
            self.record_tokens(seq, tokens)
        except Exception:
            self._seqs.pop(uid, None)
            self.allocator.release(blocks)
            raise

    @property
    def tracked_sequences(self) -> List[int]:
        return list(self._seqs)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    # -- block math ---------------------------------------------------------
    def blocks_needed(self, seq: DSSequenceDescriptor, new_tokens: int) -> int:
        total = seq.seen_tokens + new_tokens
        need = -(-total // self.block_size)   # ceil
        return max(0, need - len(seq.kv_blocks))

    def maybe_allocate_kv(self, seq: DSSequenceDescriptor, new_tokens: int):
        need = self.blocks_needed(seq, new_tokens)
        if need > 0:
            short = need - self.allocator.free_blocks
            if short > 0 and self.prefix_cache_enabled:
                self._evict(short)           # LRU unreferenced cached blocks
            seq.kv_blocks.extend(self.allocator.allocate(need))

    # -- reservation ledger -------------------------------------------------
    def _unfilled(self, uid: int, total: int) -> int:
        seq = self._seqs.get(uid)
        have = len(seq.kv_blocks) if seq is not None else 0
        return max(0, total - have)

    def reserved_unfilled(self) -> int:
        """Blocks the reserved sequences may still allocate."""
        return sum(self._unfilled(uid, total)
                   for uid, total in self._reserved.items())

    def freeable_blocks_of(self, uid: int) -> int:
        """Blocks a flush of this sequence would return to
        ``available_blocks``: private ones, and indexed ones whose only
        other reference is the cache's. Prefix blocks other sequences share
        free nothing."""
        seq = self._seqs.get(uid)
        if seq is None:
            return 0
        n = 0
        for b in seq.kv_blocks:
            rc = self.allocator.ref_count(b)
            if rc == 1 or (rc == 2 and b in self._block_hash):
                n += 1
        return n

    def reservation_headroom(self) -> int:
        """``available_blocks`` minus the outstanding claims: what a new
        reservation or a resume may take. Negative only after a
        ``force_reserve`` over-commitment."""
        return self.available_blocks - self.reserved_unfilled()

    def try_reserve(self, uid: int, total_blocks: int) -> bool:
        """Reserve a sequence's total projected block need (the blocks it
        holds, prefix hits included, credited). False = shortfall."""
        prior = self._reserved.pop(uid, None)
        need = self._unfilled(uid, int(total_blocks))
        if need > self.reservation_headroom():
            if prior is not None:
                self._reserved[uid] = prior
            return False
        self._reserved[uid] = int(total_blocks)
        return True

    def force_reserve(self, uid: int, total_blocks: int) -> None:
        """Record a reservation unconditionally (an import whose blocks are
        already resident); may push the headroom negative."""
        self._reserved[uid] = int(total_blocks)

    def release_reservation(self, uid: int) -> None:
        self._reserved.pop(uid, None)

    def reserved_total_blocks(self) -> int:
        return sum(self._reserved.values())

    @property
    def reserved_sequences(self) -> int:
        return len(self._reserved)

    # -- preemption store (host RAM) ------------------------------------------
    def preempt_stash(self, uid: int, payload: Dict[str, object]) -> None:
        """Park an ``export_sequence`` payload for a later resume. Its slabs
        (scale planes included) go into the KV tier under ``("__preempt__",
        uid)`` when one is configured — where they may demote to disk or be
        dropped — else they stay in host RAM here."""
        meta = {k: payload[k] for k in ("seen_tokens", "block_size",
                                        "kv_quant", "n_blocks")}
        meta["kv_quant_dtype"] = payload.get("kv_quant_dtype", "int8")
        if self._tier is not None:
            # not a prefix-cache spill: the tier's spill counter skips it
            self._tier.put(("__preempt__", uid), payload["slabs"],
                           _count_spill=False)
            meta["in_tier"] = True
        else:
            meta["slabs"] = payload["slabs"]
        self._preempt_store[uid] = meta

    def preempt_restore_payload(self, uid: int) -> Optional[Dict[str, object]]:
        """Take a parked payload back (one-shot); ``None`` if nothing is
        parked, or the tier dropped or failed to read it — the caller
        re-prefills."""
        meta = self._preempt_store.pop(uid, None)
        if meta is None:
            return None
        meta = dict(meta)
        if meta.pop("in_tier", False):
            slabs = (self._tier.get(("__preempt__", uid))
                     if self._tier is not None else None)
            if slabs is None:
                return None
            meta["slabs"] = slabs
        return meta

    def preempt_discard(self, uid: int) -> None:
        """Drop a parked payload (cancel of a preempted sequence)."""
        meta = self._preempt_store.pop(uid, None)
        if meta is not None and meta.get("in_tier") and self._tier is not None:
            self._tier.discard(("__preempt__", uid))

    @property
    def preempted_parked(self) -> int:
        return len(self._preempt_store)

    # -- prefix cache --------------------------------------------------------
    @property
    def evictable_blocks(self) -> int:
        """Cached blocks whose only reference is the cache's own."""
        if not self.prefix_cache_enabled:
            return 0
        return self._evictable

    @property
    def available_blocks(self) -> int:
        """Blocks an allocate can obtain: free + evictable."""
        return self.allocator.free_blocks + self.evictable_blocks

    def occupancy(self) -> Dict[str, int]:
        """The allocator's block and byte counts, the prefix-cache view and
        the tier's residency (zeros with no tier: one schema either way)."""
        occ = self.allocator.occupancy()
        occ["evictable_blocks"] = self.evictable_blocks
        occ["available_blocks"] = occ["free_blocks"] + occ["evictable_blocks"]
        tier = (self._tier.occupancy() if self._tier is not None
                else empty_tier_stats())
        occ["kv_blocks_host_tier"] = tier["host_blocks"]
        occ["kv_bytes_host_tier"] = tier["host_bytes"]
        occ["kv_blocks_disk_tier"] = tier["disk_blocks"]
        occ["kv_bytes_disk_tier"] = tier["disk_bytes"]
        return occ

    def prefix_stats(self) -> Dict[str, int]:
        return dict(self._stats)

    def match_prefix(self, uid: int, prompt_tokens: Sequence[int]) -> int:
        """Share every leading full block of ``prompt_tokens`` the index
        holds, seed the sequence at the matched length and return it. The
        walk stops at ``len(prompt) - 1``, so at least one token is left to
        prefill. Returns 0 and creates nothing with the cache off; returns
        the seen count of a sequence that already has state. With a KV tier,
        a device miss restores the spilled run that starts there and the
        walk goes on."""
        if not self.prefix_cache_enabled:
            return 0
        seq = self.get_or_create_sequence(uid)
        if seq.seen_tokens > 0 or seq.kv_blocks:
            return seq.seen_tokens
        self._stats["queries"] += 1
        limit = len(prompt_tokens) - 1
        matched: List[int] = []
        h = 0
        n = 0
        while n + self.block_size <= limit:
            key = (h, tuple(int(t) for t in
                            prompt_tokens[n:n + self.block_size]))
            b = self._index.get(key)
            if b is None and self._tier is not None:
                if self._restore_chain(key, prompt_tokens, n, limit):
                    b = self._index.get(key)
            if b is None:
                self._stats["misses"] += 1
                break
            self._index.move_to_end(key)     # LRU touch
            if self.allocator.ref_count(b) == 1:
                self._evictable -= 1         # about to gain a sequence ref
            # share now: a restore later in this walk may evict, and the
            # sequence's reference pins what it already matched
            self.allocator.share([b])
            matched.append(b)
            h = hash(key)
            n += self.block_size
            self._stats["hits"] += 1
        if matched:
            seq.kv_blocks.extend(matched)
            seq.seen_tokens = n
            seq.chain_hash = h
            seq.hashed_blocks = len(matched)
            self._stats["tokens_saved"] += n
        return n

    def record_tokens(self, seq: DSSequenceDescriptor,
                      tokens: Sequence[int]) -> None:
        """Advance the sequence's hash chain with tokens just written to its
        blocks; each block that becomes full is registered in the index. A
        sequence whose chain does not cover it from position 0 (mid-flight
        when the cache was turned on) is skipped."""
        if not self.prefix_cache_enabled:
            return
        if (seq.hashed_blocks * self.block_size + len(seq.pending_tokens)
                != seq.seen_tokens - len(tokens)):
            return
        seq.pending_tokens.extend(int(t) for t in tokens)
        while len(seq.pending_tokens) >= self.block_size:
            chunk = tuple(seq.pending_tokens[:self.block_size])
            del seq.pending_tokens[:self.block_size]
            key = (seq.chain_hash, chunk)
            seq.chain_hash = hash(key)
            block = seq.kv_blocks[seq.hashed_blocks]
            seq.hashed_blocks += 1
            self._register(key, block)

    def _register(self, key: tuple, block: int) -> None:
        if key in self._index or block in self._block_hash:
            return          # content already cached / block already indexed
        if (self.prefix_cache_max_blocks
                and len(self._index) >= self.prefix_cache_max_blocks
                and not self._evict(1)):
            return          # cache full of in-use blocks: skip registration
        self.allocator.share([block])        # the cache's own reference
        self._index[key] = block
        self._block_hash[block] = key

    def _evict(self, n: int) -> int:
        """Drop up to ``n`` LRU cached blocks held by the cache alone (their
        cache reference released, so they go free); returns how many. With
        a KV tier their slabs are gathered and copied to the host before
        this returns, so no later write into a reused block can reach the
        copy. Only unreferenced full indexed blocks get here."""
        evicted = 0
        spill: List[tuple] = []          # (index key, block id)
        for key in list(self._index):
            if evicted >= n:
                break
            b = self._index[key]
            if self.allocator.ref_count(b) == 1:
                del self._index[key]
                del self._block_hash[b]
                if self._tier is not None:
                    spill.append((key, b))
                self.allocator.release([b])
                self._evictable -= 1
                self._stats["evictions"] += 1
                evicted += 1
        if spill:
            self._spill_blocks(spill)
        return evicted

    # -- KV tier -------------------------------------------------------------
    def configure_kv_tier(self, enabled: bool, host_bytes: int = 64 << 20,
                          disk_path: Optional[str] = None,
                          disk_bytes: int = 0) -> None:
        """Build (or tear down) the host-RAM and disk tier behind the prefix
        cache. Enabling needs the prefix cache (spill and restore happen at
        its eviction and match); disabling drops every spilled entry and its
        files; re-enabling starts empty."""
        if self._tier is not None:
            self._tier.close()
            self._tier = None
        self._restore_times.clear()
        if not enabled:
            return
        if not self.prefix_cache_enabled:
            raise ValueError(
                "kv_tier requires the prefix cache: spill/restore happen "
                "at prefix-cache eviction/match (enable prefix_cache "
                "first)")
        self._tier = TieredKVStore(host_bytes, disk_path=disk_path,
                                   disk_max_bytes=disk_bytes)

    @property
    def kv_tier_enabled(self) -> bool:
        return self._tier is not None

    def _spill_blocks(self, spill: List[tuple]) -> None:
        """Copy evicted blocks' slabs into the tier: one gather per pool,
        every host copy started before the one wait, then one tier entry
        per block (the store copies each slab out of the batch)."""
        host = self._typed(_to_host(self._gather([b for _, b in spill])))
        for i, (key, _) in enumerate(spill):
            self._tier.put(key, {name: t[:, i] for name, t in host.items()})

    def _restore_chain(self, first_key: tuple, prompt_tokens: Sequence[int],
                       n: int, limit: int) -> int:
        """Restore the contiguous spilled run that starts at ``first_key``:
        each next key is computable from the prompt, so every consecutive
        tier entry is popped (at most as many as the pool could take) and
        written back in one scatter per pool. Each restored block is
        indexed under its original key, held by the cache alone; entries
        the pool has no room for go back to the tier and the match stops
        there, as without a tier. Returns how many blocks were restored."""
        bs = self.block_size
        h, pos = first_key[0], n
        # cap the lookahead at what the pool could hold before popping
        # anything: a longer chain would be read, checked and written back
        budget = self.allocator.free_blocks + self.evictable_blocks
        if self.prefix_cache_max_blocks:
            budget = min(budget,
                         max(0, self.prefix_cache_max_blocks
                             - len(self._index)) + self.evictable_blocks)
        if budget <= 0:
            if first_key in self._tier:
                self._tier.stats["misses"] += 1
            return 0
        keys: List[tuple] = []
        entries: List[Dict[str, torch.Tensor]] = []
        while pos + bs <= limit and len(entries) < budget:
            key = (h, tuple(int(t) for t in prompt_tokens[pos:pos + bs]))
            if key in self._index:
                break               # back on the device: the walk goes on
            entry = self._tier.get(key)
            if entry is None:
                break
            keys.append(key)
            entries.append(entry)
            h = hash(key)
            pos += bs
        if not entries:
            return 0
        t0 = time.perf_counter()
        m = len(entries)
        short = m - self.allocator.free_blocks
        if short > 0:
            self._evict(short)      # colder residents spill to make room
        m = min(m, self.allocator.free_blocks)
        if self.prefix_cache_max_blocks:
            allowed = self.prefix_cache_max_blocks - len(self._index)
            if allowed < m:
                self._evict(m - allowed)
                allowed = self.prefix_cache_max_blocks - len(self._index)
            m = min(m, max(0, allowed), self.allocator.free_blocks)
        for key, entry in zip(keys[m:], entries[m:]):
            self._tier.readmit(key, entry)
        if m <= 0:
            return 0
        blocks = self.allocator.allocate(m)
        self._scatter(blocks, {
            name: torch.stack([_raw(entries[i][name]) for i in range(m)],
                              dim=1)
            for name in self.kv_cache})
        for key, b in zip(keys[:m], blocks):
            self._index[key] = b
            self._block_hash[b] = key
            self._evictable += 1    # only the cache's reference so far
        self._tier.stats["restored"] += m
        self._restore_times.append(time.perf_counter() - t0)
        if len(self._restore_times) > 4096:     # bounded when undrained
            del self._restore_times[:2048]
        return m

    def tier_stats(self) -> Dict[str, int]:
        """Monotonic spill, restore and drop counters plus the host and disk
        residency; all zeros (the same keys) with no tier."""
        if self._tier is None:
            return empty_tier_stats()
        out = dict(self._tier.stats)
        out.update(self._tier.occupancy())
        return out

    def drain_restore_times(self) -> List[float]:
        """Host seconds of each restored run since the last drain (the
        gather from the tier and the scatter into the pools)."""
        out, self._restore_times = self._restore_times, []
        return out

    # -- fleet KV locality ---------------------------------------------------
    def prefix_digest(self, max_entries: int = 512) -> List[int]:
        """The chain hashes of the cached prefix content, most recently used
        first, then the tier's keys (host, then disk, newest first; parked
        preemption payloads skipped), at most ``max_entries``; empty with
        the cache off."""
        if not self.prefix_cache_enabled or max_entries <= 0:
            return []
        out = [hash(key) for key in reversed(list(self._index))]
        if self._tier is not None:
            for keys in self._tier.lru_keys():
                out.extend(hash(key) for key in reversed(keys)
                           if not (key and key[0] == "__preempt__"))
        return out[:max_entries]

    def export_prefix_blocks(self, max_blocks: int = 64) -> List[tuple]:
        """Host copies of the hottest cached blocks, most recently used
        first, as ``(index_key, {pool_name: per-block slab})`` pairs; the
        index is untouched."""
        if not self.prefix_cache_enabled or max_blocks <= 0:
            return []
        pairs = list(reversed(list(self._index.items())))[:max_blocks]
        if not pairs:
            return []
        host = self._typed(_to_host(self._gather([b for _, b in pairs])))
        return [(key, {name: host[name][:, i] for name in host})
                for i, (key, _) in enumerate(pairs)]

    def import_prefix_blocks(self, entries: List[tuple]) -> int:
        """Seed the cache with exported blocks: allocate, write every slab
        in one scatter per pool, and index each block under its key held by
        the cache alone (evictable). Entries already indexed or past the
        free-block / ``prefix_cache_max_blocks`` budget are skipped.
        Returns how many landed."""
        if not self.prefix_cache_enabled or not entries:
            return 0
        budget = self.allocator.free_blocks
        if self.prefix_cache_max_blocks:
            budget = min(budget, max(0, self.prefix_cache_max_blocks
                                     - len(self._index)))
        take: List[tuple] = []
        for key, entry in entries:
            if len(take) >= budget:
                break
            if key in self._index:
                continue
            take.append((key, entry))
        if not take:
            return 0
        blocks = self.allocator.allocate(len(take))
        self._scatter(blocks, {
            name: torch.stack([_raw(torch.as_tensor(e[name]))
                               for _, e in take], dim=1)
            for name in self.kv_cache})
        for (key, _), b in zip(take, blocks):
            self._index[key] = b
            self._block_hash[b] = key
            self._evictable += 1
        return len(take)

    def clear_prefix_cache(self) -> None:
        """Drop every index entry, releasing the cache's references; blocks
        live sequences still share stay until those sequences flush. A KV
        tier is emptied too."""
        for b in list(self._index.values()):
            self.allocator.release([b])
        self._index.clear()
        self._block_hash.clear()
        self._evictable = 0
        if self._tier is not None:
            self._tier.clear()
