"""InferenceEngineV2 — FastGen-style ragged continuous-batching engine.

Counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py`` (reference
``inference/v2/engine_v2.py:26``): ``put`` runs one forward over a ragged
batch, ``query``/``can_schedule`` serve admission control, ``flush`` frees
a sequence's KV blocks. The Dynamic SplitFuse loop on top lives in
``scheduler.py``.

The config keeps every field of the JAX ``RaggedInferenceEngineConfig``.
A feature the port has not ported yet raises ``NotImplementedError``
naming its ROADMAP item when it is turned on; none is ignored. Weight
quantization (``weight_quant_*``: the params are quantized once at build,
on the engine's device) and KV quantization (``kv_quant_*``: int8/fp8
pools with scale planes) are ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import not_ported, resolve_device
from ...models.transformer import CausalLM
from .kv_quant import validate_kv_quant
from .paged_model import PagedCausalLM
from .ragged import DSStateManager, RaggedBatchWrapper
from .scheduling_utils import SchedulingError, SchedulingResult
from .weight_quant import param_stats, quantize_weights


class RaggedInferenceEngineConfig:
    def __init__(self, max_ragged_batch_size: int = 768,
                 max_ragged_sequence_count: int = 32,
                 max_chunk_tokens: int = 256,
                 kv_blocks: int = 512, kv_block_size: int = 16,
                 max_tracked_sequences: int = 256,
                 enable_prefix_cache: bool = False,
                 prefix_cache_max_blocks: Optional[int] = None,
                 kv_quant_enabled: bool = False,
                 kv_quant_dtype: str = "int8",
                 kv_quant_scale_granularity: str = "block",
                 weight_quant_enabled: bool = False,
                 weight_quant_dtype: str = "int8",
                 weight_quant_block: int = 128,
                 weight_quant_skip: Optional[Sequence[str]] = None,
                 kv_tier_enabled: bool = False,
                 kv_tier_host_bytes: int = 64 * 1024 * 1024,
                 kv_tier_disk_path: Optional[str] = None,
                 kv_tier_disk_bytes: int = 0,
                 admission_reservation: bool = False,
                 admission_oversubscription_factor: float = 1.0,
                 admission_preemption_enabled: bool = False,
                 admission_victim_policy: str = "lowest_class",
                 admission_max_preemptions_per_seq: int = 2):
        self.max_ragged_batch_size = max_ragged_batch_size
        self.max_ragged_sequence_count = max_ragged_sequence_count
        self.max_chunk_tokens = max_chunk_tokens
        self.kv_blocks = kv_blocks
        self.kv_block_size = kv_block_size
        self.max_tracked_sequences = max_tracked_sequences
        self.enable_prefix_cache = enable_prefix_cache
        self.prefix_cache_max_blocks = prefix_cache_max_blocks
        self.kv_quant_enabled = kv_quant_enabled
        self.kv_quant_dtype = kv_quant_dtype
        self.kv_quant_scale_granularity = kv_quant_scale_granularity
        self.weight_quant_enabled = weight_quant_enabled
        self.weight_quant_dtype = weight_quant_dtype
        self.weight_quant_block = weight_quant_block
        self.weight_quant_skip = (list(weight_quant_skip)
                                  if weight_quant_skip is not None else [])
        self.kv_tier_enabled = kv_tier_enabled
        self.kv_tier_host_bytes = kv_tier_host_bytes
        self.kv_tier_disk_path = kv_tier_disk_path
        self.kv_tier_disk_bytes = kv_tier_disk_bytes
        self.admission_reservation = admission_reservation
        self.admission_oversubscription_factor = \
            admission_oversubscription_factor
        self.admission_preemption_enabled = admission_preemption_enabled
        self.admission_victim_policy = admission_victim_policy
        self.admission_max_preemptions_per_seq = \
            admission_max_preemptions_per_seq

    def check_ported(self) -> None:
        """Raise for every feature that is on but not ported yet."""
        unported = [
            (self.enable_prefix_cache, "enable_prefix_cache", "queue 1 item 9"),
            (self.kv_tier_enabled, "kv_tier_enabled", "queue 1 item 9"),
            (self.admission_reservation, "admission_reservation",
             "queue 1 item 9"),
            (self.admission_preemption_enabled,
             "admission_preemption_enabled", "queue 1 item 9"),
        ]
        for on, name, item in unported:
            if on:
                raise not_ported(f"RaggedInferenceEngineConfig.{name}", item)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class InferenceEngineV2:
    def __init__(self, model: Optional[CausalLM] = None, params=None,
                 config: Optional[RaggedInferenceEngineConfig] = None,
                 checkpoint_path: Optional[str] = None, mesh=None,
                 device=None):
        self.config = config or RaggedInferenceEngineConfig()
        self.config.check_ported()
        if checkpoint_path is not None:
            raise not_ported("checkpoint loading (models/convert.py)",
                             "queue 1 item 16")
        if mesh is not None:
            raise not_ported("tensor-parallel serving (mesh)",
                             "queue 1 item 14")
        if model is None:
            raise ValueError("InferenceEngineV2 needs a model")
        self.device = resolve_device(device)
        self.model = model
        if params is None:
            params = model.init(
                torch.Generator(device=self.device).manual_seed(0),
                device=self.device)
        params = _to_device(params, self.device)
        # weight serving: quantize the tree once, on the engine's device
        # (on the card each stacked leaf is one quantize-kernel launch)
        self._weight_quant_stats = None
        if self.config.weight_quant_enabled:
            params, self._weight_quant_stats = quantize_weights(
                model.cfg, params, dtype=self.config.weight_quant_dtype,
                block=self.config.weight_quant_block,
                skip=self.config.weight_quant_skip)
        self.params = params

        cfg = model.cfg
        max_blocks_per_seq = -(-cfg.max_seq_len // self.config.kv_block_size)
        self.state_manager = self._build_state_manager()
        self.paged = PagedCausalLM(model, self.config.kv_block_size)
        self.batch = RaggedBatchWrapper(self.config.max_ragged_sequence_count,
                                        self.config.max_chunk_tokens,
                                        max_blocks_per_seq)

    def _build_state_manager(self) -> DSStateManager:
        """Fresh sequence registry and KV pools from the current config —
        the constructor's path and ``configure_kv_quant``'s rebuild."""
        if self.config.kv_quant_enabled:
            validate_kv_quant(self.config.kv_quant_dtype,
                              self.config.kv_quant_scale_granularity)
        return DSStateManager(
            self.model.cfg, self.config.max_tracked_sequences,
            self.config.kv_blocks, self.config.kv_block_size,
            device=self.device, kv_quant=self.config.kv_quant_enabled,
            kv_quant_dtype=self.config.kv_quant_dtype)

    # ----------------------------------------------------------- admission
    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> SchedulingResult:
        """Reference engine_v2.py:161: can this (uids, lengths) batch run?"""
        if len(uids) > self.config.max_ragged_sequence_count:
            return SchedulingResult.BatchSequenceLimitExceeded
        if sum(lengths) > self.config.max_ragged_batch_size:
            return SchedulingResult.BatchTokenLimitExceeded
        blocks_needed = 0
        for uid, n in zip(uids, lengths):
            if n > self.config.max_chunk_tokens:
                return SchedulingResult.SequenceTokenLimitExceeded
            seq = self.state_manager.get_sequence(uid)
            total = (seq.seen_tokens if seq else 0) + n
            if total > self.model.cfg.max_seq_len:
                return SchedulingResult.SequenceTokenLimitExceeded
            have = seq.cur_allocated_blocks if seq else 0
            need = -(-total // self.config.kv_block_size)
            blocks_needed += max(0, need - have)
        if blocks_needed > self.state_manager.available_blocks:
            return SchedulingResult.KVCacheLimitExceeded
        return SchedulingResult.Success

    def query(self, uid: int) -> Tuple[int, int]:
        """(seen_tokens, allocated_blocks) for a sequence (reference query)."""
        seq = self.state_manager.get_sequence(uid)
        if seq is None:
            return (0, 0)
        return (seq.seen_tokens, seq.cur_allocated_blocks)

    # -------------------------------------------------------------- serving
    def put(self, uids: Sequence[int],
            tokens_list: Sequence[Sequence[int]], *,
            verify_width: int = 0) -> torch.Tensor:
        """Run one forward over the ragged batch; returns next-token logits
        [len(uids), vocab] as a tensor on the engine's device (reference
        engine_v2.py:89). ``verify_width`` W > 0 returns each row's last W
        positions right-aligned, [len(uids), W, vocab]."""
        status = self.can_schedule(uids, [len(t) for t in tokens_list])
        if status != SchedulingResult.Success:
            raise SchedulingError(status)

        self.batch.clear()
        staged = []
        for uid, toks in zip(uids, tokens_list):
            seq = self.state_manager.get_or_create_sequence(uid)
            self.state_manager.maybe_allocate_kv(seq, len(toks))
            self.batch.insert_sequence(uid, list(toks), seq.seen_tokens,
                                       seq.kv_blocks)
            staged.append((seq, toks))

        arrays = self.batch.finalize()
        dev = self.device

        def upload(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        logits = self.paged.forward(
            self.params, self.state_manager.kv_cache,
            upload(arrays["tokens"]), upload(arrays["start_pos"]),
            upload(arrays["n_tokens"]), upload(arrays["block_tables"]),
            verify_width=int(verify_width))
        # commit sequence state only after the forward was dispatched: a
        # failed forward leaves seen_tokens unchanged. (The pools are
        # written in place during the forward; a retried step rewrites the
        # same slots with the same tokens.)
        for seq, toks in staged:
            seq.seen_tokens += len(toks)
            self.state_manager.record_tokens(seq, toks)
        return logits[:len(uids)]

    def flush(self, uid: int) -> None:
        self.state_manager.flush_sequence(uid)

    def occupancy(self) -> Dict[str, int]:
        """KV-pool occupancy snapshot (blocks + bytes)."""
        return self.state_manager.occupancy()

    def configure_kv_quant(self, enabled: bool, dtype: str = "int8",
                           scale_granularity: str = "block") -> None:
        """Turn KV quantization on or off on a built engine. It
        re-allocates the pools (the representation changes), so it is
        legal only while no sequence is tracked."""
        if (bool(enabled) == self.state_manager.kv_quant
                and dtype == self.config.kv_quant_dtype
                and scale_granularity == self.config.kv_quant_scale_granularity):
            return
        if self.state_manager.tracked_sequences:
            raise RuntimeError(
                "cannot reconfigure kv_quant with "
                f"{len(self.state_manager.tracked_sequences)} sequences "
                "tracked — their KV blocks hold the old representation")
        if enabled:
            # validate before touching the config
            validate_kv_quant(dtype, scale_granularity)
        self.config.kv_quant_enabled = bool(enabled)
        self.config.kv_quant_dtype = dtype
        self.config.kv_quant_scale_granularity = scale_granularity
        self.state_manager = self._build_state_manager()

    def configure_weight_quant(self, enabled: bool, dtype: str = "int8",
                               block: int = 128,
                               skip: Optional[Sequence[str]] = None) -> None:
        """Quantize this engine's weights in place, before traffic (no
        tracked sequences). Quantization is lossy, so disabling or
        re-coding an already-quantized engine raises; re-applying the same
        representation is a no-op."""
        skip_list = list(skip) if skip is not None else []
        already = self.config.weight_quant_enabled
        if already and enabled and dtype == self.config.weight_quant_dtype:
            return
        if already:
            raise RuntimeError(
                "weights are already quantized "
                f"({self.config.weight_quant_dtype}) — quantization is "
                "lossy and cannot be reconfigured in place; rebuild the "
                "engine")
        if not enabled:
            return
        if self.state_manager.tracked_sequences:
            raise RuntimeError(
                "cannot quantize weights with "
                f"{len(self.state_manager.tracked_sequences)} sequences "
                "tracked — mid-stream logits would shift")
        self.params, self._weight_quant_stats = quantize_weights(
            self.model.cfg, self.params, dtype=dtype, block=int(block),
            skip=skip_list)
        self.config.weight_quant_enabled = True
        self.config.weight_quant_dtype = dtype
        self.config.weight_quant_block = int(block)
        self.config.weight_quant_skip = skip_list

    def param_stats(self) -> Dict[str, object]:
        """Resident param bytes, total and quantized share (shape and
        dtype metadata only)."""
        if self._weight_quant_stats is None:
            on = self.config.weight_quant_enabled
            self._weight_quant_stats = param_stats(
                self.params,
                dtype=self.config.weight_quant_dtype if on else "",
                block=self.config.weight_quant_block if on else 0)
        return dict(self._weight_quant_stats)

    @property
    def free_blocks(self) -> int:
        return self.state_manager.free_blocks
