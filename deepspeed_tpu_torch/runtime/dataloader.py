"""Data loading: host batches for the engine.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py``
(``DeepSpeedTpuDataLoader`` :60 and ``RepeatingLoader`` :19). The loader
yields numpy host batches and the engine moves them to its device. The
shuffle order for a given ``seed`` is the JAX package's: it is drawn from
``np.random.default_rng(seed + epoch)`` there too, so both engines see the
same batches. With a ``torch.distributed`` process group up, each rank reads
a disjoint strided shard of that order.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class RepeatingLoader:
    """Wraps a loader to restart it when it runs out."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    # resume pass-through: the
    # wrapped loader owns the position; loading state drops the live
    # iterator so the next __next__ starts at the restored point.
    # Loaders without state raise NotImplementedError — the contract the
    # supervisor catches — not AttributeError from blind delegation.
    def state_dict(self):
        if not hasattr(self.loader, "state_dict"):
            raise NotImplementedError(
                f"wrapped loader {type(self.loader).__name__} has no "
                "state_dict — its position is not resumable")
        return self.loader.state_dict()

    def load_state_dict(self, sd):
        if not hasattr(self.loader, "load_state_dict"):
            raise NotImplementedError(
                f"wrapped loader {type(self.loader).__name__} has no "
                "load_state_dict — its position is not resumable")
        self.loader.load_state_dict(sd)
        self.data_iter = iter(self.loader)


class DeepSpeedTpuDataLoader:
    """Batches an indexable or iterable dataset.

    ``dataset`` may be: a dict of equal-length arrays, an array/sequence of
    examples (dict or array each), a torch Dataset (indexable), or an
    iterable of ready-made batches (then ``batch_size`` is ignored).
    Under a process group each rank reads ``order[rank::world_size]``.
    """

    def __init__(self, dataset, batch_size: int, topology=None,
                 collate_fn: Optional[Callable] = None, seed: int = 1234,
                 shuffle: bool = True, drop_last: bool = True,
                 data_sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        # resume bookkeeping (state_dict/load_state_dict): batches yielded
        # in the CURRENT epoch, and a one-shot fast-forward count consumed
        # by the next __iter__ after load_state_dict — plain re-iteration
        # (no load) restarts the epoch exactly as before
        self._batches_yielded = 0
        self._resume_batches = 0
        # optional index-batch source (an iterable of global-batch index
        # arrays, e.g. a curriculum sampler)
        self.data_sampler = data_sampler
        import torch.distributed as dist

        up = dist.is_available() and dist.is_initialized()
        self.num_shards = dist.get_world_size() if up else 1
        self.shard_id = dist.get_rank() if up else 0

    # -- helpers -----------------------------------------------------------
    def _len_dataset(self):
        if isinstance(self.dataset, dict):
            return len(next(iter(self.dataset.values())))
        try:
            return len(self.dataset)
        except TypeError:
            return None

    def __len__(self):
        if self.data_sampler is not None:
            # sampler length is in samples; the loader re-slices sampler
            # yields into global micro batches (__iter__), so the count is
            # samples / global-micro
            try:
                return len(self.data_sampler) // self.batch_size
            except TypeError:
                raise TypeError(
                    "data_sampler has no length (pass the sampler object, "
                    "not an iterator, when len() is needed)")
        n = self._len_dataset()
        if n is None:
            raise TypeError("iterable dataset has no length")
        per_shard = n // self.num_shards
        return per_shard // self.batch_size if self.drop_last else -(-per_shard // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    # -- resume ------------------------------------------------------------
    def state_dict(self):
        """Mid-epoch-resumable position: epoch + step-in-epoch. The
        shuffle RNG needs no extra state — the permutation is
        ``default_rng(seed + epoch)``, recreated per epoch, so the epoch
        number fully determines it. ``seed``/``batch_size``/``shuffle``
        travel along as a consistency stamp checked on load."""
        if self.data_sampler is not None or self._len_dataset() is None:
            raise NotImplementedError(
                "dataloader state_dict needs an indexable dataset without "
                "a data_sampler (sampler/iterable sources own their own "
                "position)")
        return {"epoch": int(self.epoch),
                "batches_yielded": int(self._batches_yielded),
                "seed": int(self.seed), "shuffle": bool(self.shuffle),
                "batch_size": int(self.batch_size),
                "drop_last": bool(self.drop_last),
                # stream identity: a position counted over the shuffled
                # order of N examples sliced order[shard_id::num_shards]
                # is meaningless for any other N or slicing — resuming
                # across a changed process count or a grown/shrunk
                # dataset must fail loudly, not silently fork the stream
                "num_shards": int(self.num_shards),
                "shard_id": int(self.shard_id),
                "dataset_len": int(self._len_dataset())}

    def load_state_dict(self, sd):
        if self.data_sampler is not None or self._len_dataset() is None:
            # same guard as state_dict: a sampler/iterable loader would
            # silently DISCARD the position (__iter__'s sampler branch
            # never consults _resume_batches) — fail loudly instead
            raise NotImplementedError(
                "dataloader load_state_dict needs an indexable dataset "
                "without a data_sampler (sampler/iterable sources own "
                "their own position)")
        checks = {key: getattr(self, key)
                  for key in ("seed", "batch_size", "shuffle", "drop_last",
                              "num_shards", "shard_id")}
        checks["dataset_len"] = self._len_dataset()
        for key, have in checks.items():
            if key in sd and sd[key] != have:
                raise ValueError(
                    f"dataloader state mismatch on {key}: checkpoint has "
                    f"{sd[key]!r}, this loader has {have!r} — "
                    "resume determinism would silently break")
        self.epoch = int(sd["epoch"])
        self._batches_yielded = int(sd.get("batches_yielded", 0))
        # consumed once by the next __iter__: skip the already-seen
        # batches of this epoch without gathering them
        self._resume_batches = self._batches_yielded

    def _gather(self, indices):
        if isinstance(self.dataset, dict):
            return {k: np.asarray(v)[indices] for k, v in self.dataset.items()}
        examples = [self.dataset[int(i)] for i in indices]
        if self.collate_fn is not None:
            return self.collate_fn(examples)
        first = examples[0]
        if isinstance(first, dict):
            return {k: np.stack([np.asarray(e[k]) for e in examples]) for k in first}
        if isinstance(first, (tuple, list)):
            return tuple(np.stack([np.asarray(e[j]) for e in examples])
                         for j in range(len(first)))
        return np.stack([np.asarray(e) for e in examples])

    def __iter__(self):
        if self.data_sampler is not None:
            # sampler yields GLOBAL-batch index arrays (micro × dp × gas,
            # difficulty-gated under curriculum learning); the loader
            # contract is one global MICRO batch per yield, so each sampler
            # yield is re-sliced into its gas micro batches — the engine's
            # train_batch then consumes exactly one sampler yield (and one
            # curriculum step) per optimizer step
            for indices in self.data_sampler:
                indices = np.asarray(indices)
                for lo in range(0, len(indices), self.batch_size):
                    yield self._gather(indices[lo:lo + self.batch_size])
            return
        n = self._len_dataset()
        if n is None:
            # iterable of prepared batches
            for batch in self.dataset:
                yield batch
            return
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        order = order[self.shard_id::self.num_shards]
        nb = len(order) // self.batch_size
        skip, self._resume_batches = self._resume_batches, 0
        self._batches_yielded = min(skip, nb + 1)
        for b in range(nb):
            if b < skip:        # resume fast-forward: no gather, no yield
                continue
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            # count BEFORE the yield: the statement after a yield only
            # runs when the consumer pulls the NEXT item, so counting
            # afterwards would understate the position by one whenever a
            # checkpoint lands right after a consumed batch
            self._batches_yielded = b + 1
            yield self._gather(idx)
        if not self.drop_last and len(order) % self.batch_size and skip <= nb:
            self._batches_yielded = nb + 1
            yield self._gather(order[nb * self.batch_size:])
        self.epoch += 1
        self._batches_yielded = 0
