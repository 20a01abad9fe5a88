"""Port parity: the prefix cache of ``deepspeed_tpu_torch``'s v2 engine
against the JAX package's on the CPU.

- Greedy streams on ``TINY_TEST`` (the JAX ``init(PRNGKey(0))`` weights x4)
  for prompts that share a system prefix: the port with the cache on equals
  the JAX engine with the cache on, over a cold and a warm pass, with fp32
  pools and with int8 and fp8 KV; with fp32 pools the port's cache-on
  streams also equal its cache-off streams. The hit counters and
  ``prefix_digest`` (the chain hashes ``hash((parent, block_tokens))``)
  equal the JAX engine's for the same traffic, and every block comes back.
- Manager-level cases of ``tests/test_prefix_cache.py`` run on both
  packages' ``DSStateManager`` with the same calls, and must observe the
  same (LRU eviction, referenced blocks never evicted, the last token never
  served from the cache, full blocks only, the ``max_cached_blocks`` cap,
  a disabled cache inert).
- ``export_prefix_blocks``/``import_prefix_blocks`` move cached blocks
  between two port engines bit for bit, and the warmed engine then hits.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.ragged import DSStateManager as JManager
from deepspeed_tpu.inference.v2.testing import greedy_generate as j_greedy
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.ragged import DSStateManager
from deepspeed_tpu_torch.inference.v2.testing import (assert_greedy_parity,
                                                      greedy_generate)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
import torch_cpu  # noqa: F401  (one torch thread: see the module)

BS = 8
ENGINE_KW = dict(kv_blocks=64, kv_block_size=BS, max_chunk_tokens=16,
                 max_ragged_batch_size=48, max_ragged_sequence_count=4)
KV = {"fp32": {}, "int8": dict(kv_quant_enabled=True),
      "fp8": dict(kv_quant_enabled=True, kv_quant_dtype="fp8_e4m3")}
NEW_TOKENS = 8


@pytest.fixture(scope="module")
def weights():
    jp = jtf.CausalLM(jtf.TINY_TEST).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a) * (4 if a.ndim >= 2 else 1),
                        jp)


def _prompts(seed=0, n=4):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, 256, 37).tolist()     # 4 full blocks + 5
    return [sys_p + rng.integers(0, 256, int(k)).tolist()
            for k in rng.integers(2, 12, n)]


def _port(weights, **kw):
    return InferenceEngineV2(ttf.CausalLM(ttf.TINY_TEST),
                             params_from_numpy(weights, device="cpu"),
                             RaggedInferenceEngineConfig(**ENGINE_KW, **kw),
                             device="cpu")


def _jax(weights, **kw):
    return JEngine(jtf.CausalLM(jtf.TINY_TEST),
                   jax.tree.map(jax.numpy.asarray, weights),
                   JConfig(**ENGINE_KW, **kw))


@pytest.mark.parametrize("kv", sorted(KV))
def test_cache_on_streams_match_jax_cold_and_warm(weights, kv):
    prompts = _prompts()
    jeng = _jax(weights, enable_prefix_cache=True, **KV[kv])
    eng = _port(weights, enable_prefix_cache=True, **KV[kv])
    for uid_base in (0, 100):                     # cold pass, warm pass
        ref = j_greedy(jeng, prompts, uid_base=uid_base,
                       max_new_tokens=NEW_TOKENS)
        got = greedy_generate(eng, prompts, uid_base=uid_base,
                              max_new_tokens=NEW_TOKENS)
        assert_greedy_parity(ref, got, f"prefix cache ({kv} KV)")
        assert eng.prefix_stats() == jeng.prefix_stats()
        assert eng.prefix_digest() == jeng.prefix_digest()
    st = eng.prefix_stats()
    # the warm pass serves every request's 4 system blocks from the cache
    assert st["tokens_saved"] >= (3 + 4) * 4 * BS, st
    assert len({tuple(s) for s in got}) > 1      # not degenerate
    occ = eng.occupancy()
    assert occ["available_blocks"] == ENGINE_KW["kv_blocks"]
    assert occ["in_use_blocks"] == occ["evictable_blocks"] > 0
    eng.configure_prefix_cache(False)
    assert eng.free_blocks == ENGINE_KW["kv_blocks"]
    if kv == "fp32":
        off = greedy_generate(_port(weights), prompts,
                              max_new_tokens=NEW_TOKENS)
        assert_greedy_parity(off, got, "prefix cache on vs off")


def test_concurrent_sharers_match_jax(weights):
    """All requests in flight at once: later ones share blocks the first
    registers mid-run (they match only what is indexed when they are
    admitted), as the JAX scheduler does."""
    prompts = _prompts(seed=1, n=6)
    jeng = _jax(weights, enable_prefix_cache=True)
    eng = _port(weights, enable_prefix_cache=True)
    for uid_base in (0, 50):
        ref = j_greedy(jeng, prompts, uid_base=uid_base,
                       max_new_tokens=NEW_TOKENS, sequential=False)
        got = greedy_generate(eng, prompts, uid_base=uid_base,
                              max_new_tokens=NEW_TOKENS, sequential=False)
        assert_greedy_parity(ref, got, "prefix cache, concurrent")
        assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.prefix_stats()["tokens_saved"] > 0


# ---------------------------------------------- manager cases, both packages
def _cfg(mod):
    return mod.TransformerConfig(vocab_size=128, hidden_size=16,
                                 intermediate_size=32, num_layers=1,
                                 num_heads=2, max_seq_len=256, norm="rmsnorm",
                                 activation="silu", position="rope")


def _jax_manager(enabled=True, num_blocks=16, max_cached=None):
    return JManager(_cfg(jtf), 32, num_blocks, BS,
                    enable_prefix_cache=enabled,
                    prefix_cache_max_blocks=max_cached)


def _port_manager(enabled=True, num_blocks=16, max_cached=None):
    return DSStateManager(_cfg(ttf), 32, num_blocks, BS, device="cpu",
                          enable_prefix_cache=enabled,
                          prefix_cache_max_blocks=max_cached)


def _fill(mgr, uid, tokens):
    seq = mgr.get_or_create_sequence(uid)
    mgr.maybe_allocate_kv(seq, len(tokens))
    seq.seen_tokens += len(tokens)
    mgr.record_tokens(seq, tokens)
    return seq


def case_full_blocks_only(mk):
    mgr = mk()
    toks = list(range(20))                  # 2 full blocks + partial
    donor = list(_fill(mgr, 1, toks).kv_blocks[:2])
    mgr.flush_sequence(1)
    obs = {"free": mgr.free_blocks, "avail": mgr.available_blocks,
           "matched": mgr.match_prefix(2, toks + [7, 7])}
    seq2 = mgr.get_sequence(2)
    obs.update(shares_donor=seq2.kv_blocks == donor, seen=seq2.seen_tokens,
               refs=[mgr.allocator.ref_count(b) for b in donor],
               stats=mgr.prefix_stats())
    assert obs["free"] == 14 and obs["avail"] == 16
    assert obs["matched"] == 16 and obs["shares_donor"]
    assert obs["refs"] == [2, 2]
    return obs


def case_last_token_never_served(mk):
    mgr = mk()
    toks = list(range(16))                  # exactly 2 blocks
    _fill(mgr, 1, toks)
    obs = {"matched": mgr.match_prefix(2, toks)}
    assert obs["matched"] == BS             # only the first block
    return obs


def case_disabled_is_inert(mk):
    mgr = mk(enabled=False)
    obs = {"matched": mgr.match_prefix(5, list(range(40))),
           "created": mgr.get_sequence(5) is not None,
           "hashed": _fill(mgr, 1, list(range(20))).hashed_blocks}
    mgr.flush_sequence(1)
    obs.update(free=mgr.free_blocks, avail=mgr.available_blocks)
    assert obs == {"matched": 0, "created": False, "hashed": 0,
                   "free": 16, "avail": 16}
    return obs


def case_lru_eviction(mk):
    mgr = mk(num_blocks=8)
    _fill(mgr, 1, list(range(16)))
    mgr.flush_sequence(1)
    _fill(mgr, 2, list(range(100, 116)))            # newer
    mgr.flush_sequence(2)
    obs = {"free": mgr.free_blocks, "avail": mgr.available_blocks}
    seq = mgr.get_or_create_sequence(3)
    mgr.maybe_allocate_kv(seq, 6 * BS)               # evicts 2 LRU blocks
    obs.update(got=len(seq.kv_blocks),
               evictions=mgr.prefix_stats()["evictions"],
               newer=mgr.match_prefix(4, list(range(100, 116)) + [0]),
               older=mgr.match_prefix(5, list(range(16)) + [0]))
    assert obs == {"free": 4, "avail": 8, "got": 6, "evictions": 2,
                   "newer": 16, "older": 0}
    return obs


def case_max_cached_blocks_cap(mk):
    mgr = mk(num_blocks=16, max_cached=2)
    _fill(mgr, 1, list(range(32)))                   # 4 full blocks
    obs = {"indexed": len(mgr._index),
           "evictions": mgr.prefix_stats()["evictions"]}
    mgr.flush_sequence(1)
    obs["avail"] = mgr.available_blocks
    assert obs["indexed"] <= 2 and obs["evictions"] == 0
    assert obs["avail"] == 16
    return obs


def case_referenced_never_evicted(mk):
    mgr = mk(num_blocks=4)
    seq = _fill(mgr, 1, list(range(16)))
    obs = {"matched": mgr.match_prefix(2, list(range(16)) + [9])}
    try:
        mgr.maybe_allocate_kv(mgr.get_or_create_sequence(3), 3 * BS)
        obs["raised"] = None
    except ValueError as e:
        obs["raised"] = type(e).__name__
    obs["refs"] = [mgr.allocator.ref_count(b) for b in seq.kv_blocks[:2]]
    assert obs == {"matched": 16, "raised": "ValueError", "refs": [3, 3]}
    return obs


MANAGER_CASES = {f.__name__[5:]: f for f in (
    case_full_blocks_only, case_last_token_never_served,
    case_disabled_is_inert, case_lru_eviction, case_max_cached_blocks_cap,
    case_referenced_never_evicted)}


@pytest.mark.parametrize("case", sorted(MANAGER_CASES))
def test_manager_case_matches_jax(case):
    run = MANAGER_CASES[case]
    assert run(_port_manager) == run(_jax_manager)


def test_digest_and_chain_keys_match_jax():
    """The same fills give the same index keys, in the same LRU order, so
    the digests (hashes of those keys) agree."""
    pm, jm = _port_manager(num_blocks=32), _jax_manager(num_blocks=32)
    rng = np.random.default_rng(5)
    runs = [rng.integers(0, 128, int(n)).tolist() for n in (40, 17, 33)]
    for mgr in (pm, jm):
        for uid, toks in enumerate(runs):
            _fill(mgr, uid, toks)
        mgr.match_prefix(9, runs[0] + [1])
    assert list(pm._index) == list(jm._index)
    assert pm.prefix_digest() == jm.prefix_digest()
    assert pm.prefix_digest(3) == jm.prefix_digest(3)
    assert len(pm.prefix_digest()) == 5 + 2 + 4


# -------------------------------------------------------- replica warm-up
@pytest.mark.parametrize("kv", sorted(KV))
def test_export_import_prefix_blocks_roundtrip(weights, kv):
    prompts = _prompts(seed=2, n=2)
    donor = _port(weights, enable_prefix_cache=True, **KV[kv])
    ref = greedy_generate(donor, prompts, max_new_tokens=4)
    entries = donor.export_prefix_blocks(max_blocks=64)
    assert len(entries) == len(donor.state_manager._index) > 0
    grown = _port(weights, enable_prefix_cache=True, **KV[kv])
    assert grown.import_prefix_blocks(entries) == len(entries)
    # the same keys with the same bytes (the import indexes them in the
    # order given, so the recency order is reversed)
    back = dict(grown.export_prefix_blocks(max_blocks=64))
    assert set(back) == {k for k, _ in entries}

    def raw(t):
        return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
    for key, entry in entries:
        for name in entry:
            assert torch.equal(raw(entry[name]), raw(back[key][name]))
    # the warmed engine serves the system prompt from the imported blocks
    got = greedy_generate(grown, prompts, max_new_tokens=4)
    assert grown.prefix_stats()["tokens_saved"] >= 2 * 4 * BS
    if kv == "fp32":
        assert_greedy_parity(ref, got, "imported prefix blocks")
