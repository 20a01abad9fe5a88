"""Ragged sequence state: descriptors, block tables, paged KV pools.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/manager.py`` — the core:
a registry of per-sequence descriptors (seen-token count and KV block
ownership), on-demand block allocation, and the device-side paged pools
``[L, NB, KH, bs, D]`` (the per-(block, kv-head) slab is the trailing
``[bs, D]``, the layout ``ops/csrc/paged_attention.cu`` reads). The pools
are torch tensors on the engine's device and ``PagedCausalLM`` writes them
in place. With ``kv_quant`` the pools are int8 or float8_e4m3fn
(``kv_quant_dtype``) with f32 scale planes ``k_scale``/``v_scale``
``[L, NB, KH]`` beside them (``kv_quant.py``).

Not ported yet: the prefix cache, the KV tier, KV export/import, trim, and
the reservation ledger (ROADMAP queue 1 item 9). With the prefix cache off
``record_tokens`` is the no-op it is in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from .... import resolve_device
from ..kv_quant import kv_bytes_per_block, pool_dtype
from .blocked_allocator import BlockedAllocator


@dataclass
class DSSequenceDescriptor:
    uid: int
    seen_tokens: int = 0                   # tokens already in the KV cache
    kv_blocks: List[int] = field(default_factory=list)

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self.kv_blocks)


class DSStateManager:
    """Sequence registry + paged KV pools (reference ragged_manager.py:204)."""

    def __init__(self, model_cfg, max_tracked_sequences: int = 256,
                 num_blocks: int = 256, block_size: int = 16,
                 dtype: Optional[torch.dtype] = None, device=None,
                 kv_quant: bool = False, kv_quant_dtype: str = "int8"):
        self.cfg = model_cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_tracked_sequences = max_tracked_sequences
        self.device = resolve_device(device)
        self.kv_quant = bool(kv_quant)
        self.kv_quant_dtype = str(kv_quant_dtype)
        dt = dtype or model_cfg.dtype
        self.allocator = BlockedAllocator(
            num_blocks, bytes_per_block=kv_bytes_per_block(
                model_cfg, block_size, self.kv_quant, dt))
        self._seqs: Dict[int, DSSequenceDescriptor] = {}
        shape = (model_cfg.num_layers, num_blocks, model_cfg.kv_heads,
                 block_size, model_cfg.head_dim)
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
        """Release a finished sequence's blocks (reference engine_v2.flush)."""
        seq = self._seqs.pop(uid, None)
        if seq is not None and seq.kv_blocks:
            self.allocator.release(seq.kv_blocks)

    @property
    def tracked_sequences(self) -> List[int]:
        return list(self._seqs)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    @property
    def available_blocks(self) -> int:
        """Blocks an allocate can obtain (free; nothing is evictable with
        the prefix cache off)."""
        return self.allocator.free_blocks

    def occupancy(self) -> Dict[str, int]:
        occ = self.allocator.occupancy()
        occ["evictable_blocks"] = 0
        occ["available_blocks"] = occ["free_blocks"]
        return occ

    # -- block math ---------------------------------------------------------
    def blocks_needed(self, seq: DSSequenceDescriptor, new_tokens: int) -> int:
        total = seq.seen_tokens + new_tokens
        need = -(-total // self.block_size)   # ceil
        return max(0, need - len(seq.kv_blocks))

    def maybe_allocate_kv(self, seq: DSSequenceDescriptor, new_tokens: int):
        need = self.blocks_needed(seq, new_tokens)
        if need > 0:
            seq.kv_blocks.extend(self.allocator.allocate(need))

    def record_tokens(self, seq: DSSequenceDescriptor,
                      tokens: Sequence[int]) -> None:
        """Advance the prefix-cache hash chain — a no-op with the cache
        off, which is the only state this slice has."""
