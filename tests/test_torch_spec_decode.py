"""Port parity: speculative decoding in ``deepspeed_tpu_torch``'s v2 engine
against the JAX package's on the CPU.

- ``verify_greedy`` and ``NGramProposer`` give the JAX functions' outputs on
  the same seeded inputs.
- The trim cases of ``tests/test_spec_decode.py:126-203`` and ``:351`` run on
  both packages' ``DSStateManager`` with the same calls and must observe the
  same; a speculative ``put(defer_commit=True)`` + trim + commit leaves the
  same prefix index in both engines.
- Greedy streams on ``TINY_TEST`` (the JAX ``init(PRNGKey(0))`` weights x3:
  streams that vary, and that fall into short loops the n-gram proposer
  drafts right and wrong) with the n-gram and the draft-model proposer,
  each at K = 3 and 4 and with fp32 pools and int8 and fp8 KV
  (``SPEC_CASES``): the port's spec-on streams and counters equal the JAX
  engine's spec-on ones; with fp32 pools they also equal the port's
  spec-off streams. (Under kv_quant a rolled-back block keeps the scale its
  drafts raised, so spec-on may differ from spec-off in both packages alike.)
- ``put(verify_width=W)`` logits of rows with different draft counts, one
  starting mid-context, against the JAX engine's, to atol = rtol = 1e-4 (the
  same fp32 tolerance as ``test_torch_paged_model.py``: matmul chains summed
  in different orders by two BLAS libraries).
"""

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.ragged import DSStateManager as JManager
from deepspeed_tpu.inference.v2.scheduler import \
    ContinuousBatchingScheduler as JScheduler
from deepspeed_tpu.inference.v2.spec import DraftModelProposer as JDraft
from deepspeed_tpu.inference.v2.spec import NGramProposer as JNGram
from deepspeed_tpu.inference.v2.spec import verify_greedy as j_verify
from deepspeed_tpu.inference.v2.testing import greedy_generate as j_greedy
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import (ContinuousBatchingScheduler,
                                              InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.ragged import DSStateManager
from deepspeed_tpu_torch.inference.v2.spec import (DraftModelProposer,
                                                   NGramProposer,
                                                   verify_greedy)
from deepspeed_tpu_torch.inference.v2.testing import (assert_greedy_parity,
                                                      greedy_generate,
                                                      spec_summary)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
import torch_cpu  # noqa: F401  (one torch thread: see the module)

BS = 8
ENGINE_KW = dict(kv_blocks=64, kv_block_size=BS, max_chunk_tokens=16,
                 max_ragged_batch_size=48, max_ragged_sequence_count=4)
KV = {"fp32": {}, "int8": dict(kv_quant_enabled=True),
      "fp8": dict(kv_quant_enabled=True, kv_quant_dtype="fp8_e4m3")}
NEW_TOKENS = 24


@pytest.fixture(scope="module")
def weights():
    jp = jtf.CausalLM(jtf.TINY_TEST).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a) * (3 if a.ndim >= 2 else 1),
                        jp)


def _port(weights, **kw):
    return InferenceEngineV2(ttf.CausalLM(ttf.TINY_TEST),
                             params_from_numpy(weights, device="cpu"),
                             RaggedInferenceEngineConfig(**ENGINE_KW, **kw),
                             device="cpu")


def _jax(weights, **kw):
    return JEngine(jtf.CausalLM(jtf.TINY_TEST),
                   jax.tree.map(jax.numpy.asarray, weights),
                   JConfig(**ENGINE_KW, **kw))


@pytest.fixture(scope="module")
def jax_engines(weights):
    """One JAX target engine per KV representation, built once (each
    compiles its forward per batch shape); every run flushes its
    sequences."""
    return {kv: _jax(weights, **kw) for kv, kw in KV.items()}


def _prompts():
    """Repeated motifs and low-entropy prompts: suffix matches (right and
    wrong) abound, so the n-gram proposer drafts often."""
    rng = np.random.default_rng(7)
    motif = rng.integers(0, 256, 5).tolist()
    return [motif * 4 + rng.integers(0, 256, 3).tolist(),
            rng.integers(0, 6, 20).tolist(),
            rng.integers(0, 6, 13).tolist(), motif * 3,
            rng.integers(0, 256, 10).tolist()]


# ------------------------------------------------------------ unit parity
def test_verify_greedy_matches_jax():
    rng = np.random.default_rng(0)
    for n in range(1, 7):
        for _ in range(20):
            logits = rng.standard_normal((8, 12)).astype(np.float32)
            greedy = logits.argmax(-1)
            # drafts that follow the argmax for a random number of steps
            chunk = [int(rng.integers(0, 12))]
            cut = int(rng.integers(0, n))
            for j in range(1, n):
                chunk.append(int(greedy[j - 1]) if j <= cut
                             else int(rng.integers(0, 12)))
            assert verify_greedy(chunk, logits) == j_verify(chunk, logits)


@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1)])
def test_ngram_proposer_matches_jax(ngram):
    hi, lo = ngram
    rng = np.random.default_rng(hi * 10 + lo)
    ours, theirs = NGramProposer(hi, lo, 64), JNGram(hi, lo, 64)
    for _ in range(200):
        ctx = rng.integers(0, 4, int(rng.integers(1, 100))).tolist()
        k = int(rng.integers(0, 6))
        assert ours.propose(0, ctx, k) == theirs.propose(0, ctx, k)


# ------------------------------------------------- trim cases, both packages
def _cfg(mod):
    return mod.TransformerConfig(vocab_size=128, hidden_size=16,
                                 intermediate_size=32, num_layers=1,
                                 num_heads=2, max_seq_len=256, norm="rmsnorm",
                                 activation="silu", position="rope")


def _jax_manager(enabled=False, num_blocks=16):
    return JManager(_cfg(jtf), 32, num_blocks, BS,
                    enable_prefix_cache=enabled)


def _port_manager(enabled=False, num_blocks=16):
    return DSStateManager(_cfg(ttf), 32, num_blocks, BS, device="cpu",
                          enable_prefix_cache=enabled)


def _fill(mgr, uid, tokens):
    seq = mgr.get_or_create_sequence(uid)
    mgr.maybe_allocate_kv(seq, len(tokens))
    seq.seen_tokens += len(tokens)
    mgr.record_tokens(seq, tokens)
    return seq


def _raises(fn, *a):
    try:
        return fn(*a)
    except ValueError as e:
        return ("ValueError", str(e).split(":")[0][:40])


def case_across_block_boundary(mk):
    mgr = mk()
    seq = _fill(mgr, 1, list(range(20)))        # 2 full blocks + 4 in third
    obs = [len(seq.kv_blocks), mgr.trim_sequence(1, 6), seq.seen_tokens,
           len(seq.kv_blocks), mgr.free_blocks]
    assert obs == [3, 1, 14, 2, 14]
    return obs


def case_exact_block_edge(mk):
    mgr = mk()
    seq = _fill(mgr, 1, list(range(20)))
    obs = [mgr.trim_sequence(1, 4), seq.seen_tokens, len(seq.kv_blocks),
           mgr.trim_sequence(1, 0)]
    mgr.maybe_allocate_kv(seq, 1)
    obs.append(len(seq.kv_blocks))
    assert obs == [1, 16, 2, 0, 3]
    return obs


def case_entire_sequence_and_overtrim(mk):
    mgr = mk()
    seq = _fill(mgr, 1, list(range(12)))
    obs = [mgr.trim_sequence(1, 12), seq.seen_tokens, seq.kv_blocks,
           mgr.free_blocks, _raises(mgr.trim_sequence, 1, 1),
           mgr.trim_sequence(99, 3)]
    assert obs[:4] == [2, 0, [], 16] and obs[4][0] == "ValueError"
    assert obs[5] == 0
    return obs


def case_spares_prefix_shared_blocks(mk):
    mgr = mk(enabled=True)
    toks = list(range(16))
    _fill(mgr, 1, toks)                        # donor indexes 2 blocks
    obs = [mgr.match_prefix(2, toks + [7, 7, 7])]
    seq2 = mgr.get_sequence(2)
    shared = list(seq2.kv_blocks)
    mgr.maybe_allocate_kv(seq2, 6)
    seq2.seen_tokens += 6                      # 1 certain + 5 drafts
    private = seq2.kv_blocks[2]
    obs += [len(seq2.kv_blocks), mgr.trim_sequence(2, 5),
            mgr.trim_sequence(2, 1), seq2.kv_blocks == shared,
            [mgr.allocator.ref_count(b) for b in shared],
            mgr.allocator.ref_count(private),
            _raises(mgr.trim_sequence, 2, 1)]
    assert obs[:7] == [16, 3, 0, 1, True, [3, 3], 0]
    assert obs[7][0] == "ValueError"
    return obs


def case_drops_pending_chain_tokens(mk):
    mgr = mk(enabled=True)
    seq = _fill(mgr, 1, list(range(12)))       # 1 full block + 4 pending
    obs = [list(seq.pending_tokens)]
    mgr.trim_sequence(1, 2)                    # 12 -> 10
    obs.append(list(seq.pending_tokens))
    mgr.record_tokens(seq, [])
    seq.seen_tokens += 6
    mgr.record_tokens(seq, [10, 11, 12, 13, 14, 15])
    obs.append(seq.hashed_blocks)
    mgr.flush_sequence(1)
    obs.append(mgr.match_prefix(3, list(range(10))
                                + [10, 11, 12, 13, 14, 15, 0]))
    assert obs == [[8, 9, 10, 11], [8, 9], 2, 16]
    return obs


def case_refuses_shared_unindexed_block(mk):
    mgr = mk()
    seq = _fill(mgr, 1, list(range(12)))
    mgr.allocator.share([seq.kv_blocks[1]])     # rogue out-of-index share
    obs = [_raises(mgr.trim_sequence, 1, 6), seq.seen_tokens]
    assert obs[0][0] == "ValueError" and obs[1] == 12
    return obs


TRIM_CASES = {f.__name__[5:]: f for f in (
    case_across_block_boundary, case_exact_block_edge,
    case_entire_sequence_and_overtrim, case_spares_prefix_shared_blocks,
    case_drops_pending_chain_tokens, case_refuses_shared_unindexed_block)}


@pytest.mark.parametrize("case", sorted(TRIM_CASES))
def test_trim_case_matches_jax(case):
    run = TRIM_CASES[case]
    assert run(_port_manager) == run(_jax_manager)


def test_trim_never_registers_draft_tokens(weights, jax_engines):
    base = list(range(10, 24))                  # 14 accepted context tokens
    seen = {}
    jeng = jax_engines["fp32"]
    jeng.configure_prefix_cache(True)
    for name, eng in (("port", _port(weights, enable_prefix_cache=True)),
                      ("jax", jeng)):
        eng.put([1], [base], verify_width=4, defer_commit=True)
        eng.put([1], [[30, 31, 32, 33]], verify_width=4, defer_commit=True)
        eng.trim_sequence(1, 3)
        eng.commit_tokens(1, base + [30])
        seq = eng.state_manager.get_sequence(1)
        obs = [seq.seen_tokens, seq.hashed_blocks]
        eng.flush(1)
        obs += [eng.state_manager.match_prefix(2, base[:8] + [99]),
                eng.state_manager.match_prefix(3, base + [30, 31, 32, 33, 99]),
                eng.prefix_digest()]
        for uid in (2, 3):
            eng.flush(uid)
        seen[name] = obs
    jeng.configure_prefix_cache(False)
    assert seen["port"] == seen["jax"]
    assert seen["port"][:4] == [15, 1, 8, 8]


# ----------------------------------------------------- streams vs the JAX
# each proposer at K = 3 and 4 and over fp32, int8 and fp8 KV, the axes
# covered pairwise (the cross product costs twice the CPU time)
SPEC_CASES = [("ngram", 3, "fp32"), ("ngram", 4, "int8"), ("ngram", 3, "fp8"),
              ("draft", 4, "fp32"), ("draft", 3, "int8"), ("draft", 4, "fp8")]


@pytest.mark.parametrize("proposer,k,kv", SPEC_CASES)
def test_spec_streams_match_jax(weights, jax_engines, proposer, k, kv):
    prompts = _prompts()
    jeng = jax_engines[kv]
    if proposer == "ngram":
        jp, tp = JNGram(ngram_max=3), NGramProposer(ngram_max=3)
    else:
        jp = JDraft(_jax(weights, **KV[kv]))
        tp = DraftModelProposer(_port(weights, **KV[kv]))
    jsched = JScheduler(jeng, proposer=jp, max_draft_tokens=k)
    ref = j_greedy(prompts=prompts, max_new_tokens=NEW_TOKENS,
                   scheduler=jsched)
    eng = _port(weights, **KV[kv])
    sched = ContinuousBatchingScheduler(eng, proposer=tp, max_draft_tokens=k)
    got = greedy_generate(prompts=prompts, max_new_tokens=NEW_TOKENS,
                          scheduler=sched)
    assert_greedy_parity(ref, got, f"{proposer} speculation K={k} ({kv})")
    stats = sched.spec_stats()
    assert stats == jsched.spec_stats()
    assert stats["accepted"] > 0, stats
    if proposer == "draft":
        assert tp.engine.free_blocks == ENGINE_KW["kv_blocks"]
    if proposer == "draft" and kv == "fp32":
        assert stats["accepted"] == stats["proposed"]   # the same model
        assert spec_summary(stats)["tokens_per_forward"] > 2.0
    else:
        assert stats["accepted"] < stats["proposed"], stats  # rollbacks ran
    assert eng.free_blocks == ENGINE_KW["kv_blocks"]
    if kv == "fp32":
        off = greedy_generate(_port(weights), prompts,
                              max_new_tokens=NEW_TOKENS)
        assert_greedy_parity(off, got, f"{proposer} speculation on vs off")


def test_verify_width_logits_match_jax(weights, jax_engines):
    """A verify put whose rows carry 1, 3 and 4 drafts (chunks of 2, 4 and
    5 tokens), one of them a first chunk that starts mid-context."""
    eng, jeng = _port(weights), jax_engines["fp32"]
    rng = np.random.default_rng(11)
    ctx = [rng.integers(0, 256, n).tolist() for n in (9, 16, 13)]
    rows = [rng.integers(0, 256, n).tolist() for n in (2, 4, 5)]
    outs = []
    for e in (eng, jeng):
        for uid, c in enumerate(ctx):
            e.put([uid], [c])
        out = e.put([0, 1, 2], rows, verify_width=8, defer_commit=True)
        outs.append(np.asarray(out.float().numpy() if hasattr(out, "float")
                               else out))
        for uid in range(3):
            e.flush(uid)
    assert outs[0].shape == (3, 8, 256)
    for i, r in enumerate(rows):       # the valid, right-aligned positions
        np.testing.assert_allclose(outs[0][i, 8 - len(r):],
                                   outs[1][i, 8 - len(r):],
                                   atol=1e-4, rtol=1e-4)
