"""Shared correctness helpers for the v2 ragged engine.

Counterpart of ``deepspeed_tpu/inference/v2/testing.py``: the single
definition of "run these prompts greedily and give me the streams", and the
byte-identical-stream check that holds the port to the JAX engine.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .scheduler import ContinuousBatchingScheduler


def greedy_generate(engine=None, prompts: Sequence[Sequence[int]] = (),
                    uid_base: int = 0, max_new_tokens: int = 8,
                    eos_token_id: Optional[int] = None,
                    scheduler: Optional[ContinuousBatchingScheduler] = None,
                    sequential: bool = True,
                    **scheduler_kwargs) -> List[List[int]]:
    """Greedy-decode ``prompts`` through a ContinuousBatchingScheduler and
    return one generated-token list per prompt.

    ``sequential=True`` (default) runs each prompt to completion before
    submitting the next — the deterministic reference order parity checks
    compare against. ``sequential=False`` submits everything up front and lets
    continuous batching interleave — same tokens, concurrent schedule.

    Pass ``scheduler`` to reuse one (e.g. to keep its engine's caches warm
    across passes), or ``scheduler_kwargs`` (``proposer=``,
    ``max_draft_tokens=``, ``sample_fn=``...) to build one on ``engine``.
    """
    if scheduler is None:
        if engine is None:
            raise ValueError("greedy_generate needs an engine or scheduler")
        scheduler = ContinuousBatchingScheduler(engine, **scheduler_kwargs)
    uids = []
    for i, p in enumerate(prompts):
        uid = uid_base + i
        uids.append(uid)
        scheduler.submit(uid, list(p), max_new_tokens=max_new_tokens,
                         eos_token_id=eos_token_id)
        if sequential:
            scheduler.run_to_completion()
    if not sequential:
        scheduler.run_to_completion()
    return [scheduler.finished[uid].generated for uid in uids]


def assert_greedy_parity(reference: Sequence[List[int]],
                         candidate: Sequence[List[int]],
                         label: str = "feature") -> None:
    """Byte-identical-stream check with a diagnostic that names the first
    diverging request and position (raw list comparison buries both)."""
    assert len(reference) == len(candidate), (
        f"{label}: {len(candidate)} streams vs {len(reference)} expected")
    for r, (ref, got) in enumerate(zip(reference, candidate)):
        if list(ref) == list(got):
            continue
        pos = next((j for j, (a, b) in enumerate(zip(ref, got)) if a != b),
                   min(len(ref), len(got)))
        raise AssertionError(
            f"greedy parity broken by {label}: request {r} diverges at "
            f"token {pos}: expected {list(ref)[max(0, pos - 2):pos + 3]}, "
            f"got {list(got)[max(0, pos - 2):pos + 3]} "
            f"(lens {len(ref)} vs {len(got)})")



def spec_summary(stats: Dict[str, int]) -> Dict[str, float]:
    """Derived speculative-decoding numbers from
    ``ContinuousBatchingScheduler.spec_stats()`` counters."""
    proposed = stats.get("proposed", 0)
    rows = stats.get("decode_rows", 0)
    return {
        "acceptance_rate": (stats.get("accepted", 0) / proposed
                            if proposed else 0.0),
        "tokens_per_forward": (stats.get("emitted", 0) / rows
                               if rows else 0.0),
    }
