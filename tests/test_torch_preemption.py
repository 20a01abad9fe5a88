"""Port parity: reservation admission, preemption and KV export/import in
``deepspeed_tpu_torch``'s v2 engine against the JAX package's on the CPU.

The model and pools of ``tests/test_preemption.py`` (vocab 128, hidden 64,
2 layers, blocks of 8, ``kv_blocks`` = 14), with the JAX
``init(PRNGKey(0))`` weights x3 so that greedy streams vary:

- the ledger arithmetic, the prefix-hit credit and the release on cancel
  (``tests/test_preemption.py:122-196``) observe the same numbers in both
  packages;
- the victim order of every policy (:204) is the same;
- admission preempts only strictly less urgent work (:226), with the same
  counters and streams as the JAX scheduler;
- a preempted sequence's KV round-trips the host store bit for bit, slabs
  and int8/fp8 scale planes alike, and its stream equals the JAX engine's
  under the same pool and an uncontended run's (:259);
- a dropped payload falls back to a re-prefill with the same stream (:320),
  and a parked sequence can be cancelled (:347);
- the chunked-admission wedge (:85) happens on the old path and not under
  reservation, whose streams equal the JAX engine's;
- ``export_sequence``/``import_sequence`` in mid-decode, whole and chunked:
  a re-export of the imported sequence is byte-identical to the payload,
  and the resumed stream equals the uninterrupted one and the JAX engine's
  after the same handoff.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.scheduler import \
    ContinuousBatchingScheduler as JScheduler
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import (ContinuousBatchingScheduler,
                                              InferenceEngineV2,
                                              RaggedInferenceEngineConfig,
                                              Request)
from deepspeed_tpu_torch.inference.v2.testing import assert_greedy_parity
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
import torch_cpu  # noqa: F401  (one torch thread: see the module)

VOCAB = 128
BS = 8
KV = {"fp32": {}, "int8": dict(kv_quant_enabled=True),
      "fp8": dict(kv_quant_enabled=True, kv_quant_dtype="fp8_e4m3")}


def _cfg(mod):
    return mod.TransformerConfig(vocab_size=VOCAB, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=2, max_seq_len=128, norm="rmsnorm",
                                 activation="silu", position="rope")


@pytest.fixture(scope="module")
def weights():
    jp = jtf.CausalLM(_cfg(jtf)).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a) * (3 if a.ndim >= 2 else 1),
                        jp)


def _ecfg(config_cls, kv_blocks=14, max_seqs=8, prefix=False, kv="fp32",
          reservation=False, preempt=False, factor=1.0,
          policy="lowest_class", max_preempts=2):
    return config_cls(
        max_ragged_batch_size=256, max_ragged_sequence_count=max_seqs,
        max_chunk_tokens=32, kv_blocks=kv_blocks, kv_block_size=BS,
        max_tracked_sequences=64, enable_prefix_cache=prefix,
        admission_reservation=reservation,
        admission_oversubscription_factor=factor,
        admission_preemption_enabled=preempt,
        admission_victim_policy=policy,
        admission_max_preemptions_per_seq=max_preempts, **KV[kv])


def _port(weights, **kw):
    return InferenceEngineV2(ttf.CausalLM(_cfg(ttf)),
                             params_from_numpy(weights, device="cpu"),
                             _ecfg(RaggedInferenceEngineConfig, **kw),
                             device="cpu")


def _jax(weights, **kw):
    return JEngine(jtf.CausalLM(_cfg(jtf)),
                   jax.tree.map(jax.numpy.asarray, weights),
                   _ecfg(JConfig, **kw))


def _both(weights, jeng=None, **kw):
    """(port engine, port scheduler class), (JAX engine, its class). A
    given ``jeng`` (the shared fp32 14-block JAX engine, which compiles
    its forwards once for the tests that take it) gets this test's
    admission settings; those tests leave it with nothing tracked."""
    if jeng is None:
        jeng = _jax(weights, **kw)
    else:
        jeng.configure_admission(kw.get("reservation", False),
                                 kw.get("factor", 1.0),
                                 kw.get("preempt", False))
    return ((_port(weights, **kw), ContinuousBatchingScheduler),
            (jeng, JScheduler))


@pytest.fixture(scope="module")
def jax14(weights):
    return _jax(weights)


def rand_prompt(rng, n):
    return rng.integers(0, VOCAB, size=n).tolist()


def reference_streams(weights, jobs, kv="fp32"):
    """Uncontended sequential greedy streams of the port (a big pool, the
    old admission) at the same KV representation."""
    sched = ContinuousBatchingScheduler(_port(weights, kv_blocks=256, kv=kv))
    out = []
    for i, (p, mn) in enumerate(jobs):
        sched.submit(90_000 + i, p, max_new_tokens=mn)
        sched.run_to_completion()
        out.append(sched.finished[90_000 + i].generated)
    return out


# -------------------------------------------------------- ledger arithmetic
def test_ledger_reserve_release_and_headroom(weights):
    seen = []
    for eng, _ in _both(weights):
        obs = [eng.reservation_headroom(), eng.try_reserve(1, 10),
               eng.reservation_headroom(), eng.try_reserve(2, 5),
               eng.try_reserve(2, 4), eng.reservation_headroom(),
               eng.try_reserve(2, 4),
               eng.state_manager.reserved_sequences]
        eng.flush(1)
        obs.append(eng.reservation_headroom())
        eng.release_reservation(2)
        obs.append(eng.reservation_headroom())
        eng.force_reserve(3, 20)
        obs.append(eng.reservation_headroom())
        seen.append(obs)
    assert seen[0] == seen[1] == [14, True, 4, False, True, 0, True, 2, 10,
                                  14, -6]


def test_ledger_unfilled_tracks_allocation(weights, jax14):
    seen = []
    for eng, _ in _both(weights, jax14):
        rng = np.random.default_rng(1)
        obs = [eng.try_reserve(700, 6), eng.reservation_headroom()]
        eng.put([700], [rand_prompt(rng, 24)])   # 3 blocks allocated
        obs += [eng.reservation_headroom(), eng.free_blocks]
        eng.flush(700)
        seen.append(obs)
    assert seen[0] == seen[1] == [True, 8, 8, 11]


def test_prefix_hit_credits_reservation(weights):
    seen = []
    for eng, sched_cls in _both(weights, prefix=True, reservation=True):
        rng = np.random.default_rng(2)
        sys_prompt = rand_prompt(rng, 32)         # 4 full blocks
        sched = sched_cls(eng)
        sched.submit(300, sys_prompt + rand_prompt(rng, 6), max_new_tokens=2)
        sched.run_to_completion()
        eng.try_reserve(998, eng.reservation_headroom())   # squeeze the pool
        matched = eng.match_prefix(301, sys_prompt + rand_prompt(rng, 6))
        eng.release_reservation(998)
        eng.try_reserve(998, eng.reservation_headroom() - 2)
        seen.append([matched, eng.try_reserve(301, 6),
                     sched.finished[300].generated])
    assert seen[0] == seen[1]
    assert seen[0][:2] == [32, True]


def test_reservation_released_on_cancel(weights, jax14):
    seen = []
    for eng, sched_cls in _both(weights, jax14, reservation=True):
        rng = np.random.default_rng(3)
        sched = sched_cls(eng)
        sched.submit(310, rand_prompt(rng, 60), max_new_tokens=20)
        for _ in range(2):
            sched.step()
        obs = [eng.state_manager.reserved_sequences, sched.cancel(310)]
        obs += [eng.state_manager.reserved_sequences, eng.free_blocks]
        seen.append(obs)
    assert seen[0] == seen[1] == [1, True, 0, 14]


# ----------------------------------------------------------- victim order
@pytest.mark.parametrize("policy", ["lowest_class", "most_blocks",
                                    "least_progress"])
def test_victim_policy_ordering(weights, policy):
    from deepspeed_tpu.inference.v2.scheduler import Request as JRequest

    orders = []
    for (eng, sched_cls), req_cls in zip(_both(weights, preempt=True),
                                         (Request, JRequest)):
        sched = sched_cls(eng)
        sched.victim_policy = policy
        reqs = []
        for uid, rank, gen, blocks in ((1, 0, 4, 4), (2, 1, 1, 2),
                                       (3, 1, 6, 6)):
            r = req_cls(uid, [0] * 10, 8, shed_rank=rank)
            r.prompt_fed, r.generated = 10, [0] * gen
            reqs.append((r, blocks))
        order = sorted(reqs, key=lambda t: sched._victim_order(*t),
                       reverse=True)
        orders.append([r.uid for r, _ in order])
    want = {"lowest_class": [3, 2, 1], "most_blocks": [3, 1, 2],
            "least_progress": [2, 1, 3]}[policy]
    assert orders[0] == orders[1] == want


# ------------------------------------------------------------- preemption
def test_admission_preempts_only_lower_urgency(weights, jax14):
    seen = []
    for eng, sched_cls in _both(weights, jax14, reservation=True,
                                preempt=True, factor=3.0):
        rng = np.random.default_rng(4)
        sched = sched_cls(eng)
        sched.submit(400, rand_prompt(rng, 60), max_new_tokens=20,
                     shed_rank=1)
        for _ in range(4):
            sched.step()
        obs = [400 in sched.running]
        # same class: no preemption, the newcomer waits
        sched.submit(401, rand_prompt(rng, 60), max_new_tokens=4,
                     shed_rank=1)
        sched.step()
        obs += [sched.preempt_stats()["preempted"], sched.pending[0].uid,
                sched.reserve_shortfall_blocks() > 0]
        # higher urgency: the batch resident is spilled
        sched.submit(402, rand_prompt(rng, 60), max_new_tokens=4,
                     shed_rank=0)
        sched.step()
        obs += [sched.preempt_stats()["preempted"], 400 in sched.preempted]
        fin = sched.run_to_completion(max_steps=2000)
        obs += [sorted(fin), sched.preempt_stats()["resumed"],
                [fin[u].generated for u in (400, 401, 402)], eng.free_blocks]
        seen.append(obs)
    assert seen[0] == seen[1]
    assert seen[0][:6] == [True, 0, 401, True, 1, True]
    assert seen[0][6:8] == [[400, 401, 402], 1] and seen[0][-1] == 14


def _slabs(eng, blocks, n_full):
    """The pools' slabs at ``blocks`` (their first ``n_full``), as bytes."""
    ids = torch.as_tensor(blocks[:n_full])
    out = {}
    for name, pool in eng.state_manager.kv_cache.items():
        t = pool.index_select(1, ids) if pool.dtype != torch.float8_e4m3fn \
            else pool.view(torch.uint8).index_select(1, ids)
        out[name] = t.clone()
    return out


@pytest.mark.parametrize("kv", sorted(KV))
def test_preempt_spill_resume_byte_roundtrip(weights, kv):
    rng = np.random.default_rng(5)
    prompts = [rand_prompt(rng, 60), rand_prompt(rng, 60)]
    streams = []
    for eng, sched_cls in _both(weights, prefix=True, kv=kv,
                                reservation=True, preempt=True, factor=3.0):
        sched = sched_cls(eng)
        sched.submit(500, prompts[0], max_new_tokens=16, shed_rank=1)
        for _ in range(4):
            sched.step()
        seq = eng.state_manager.get_sequence(500)
        seen_before = seq.seen_tokens
        n_full = seen_before // BS
        if sched_cls is ContinuousBatchingScheduler:
            before = _slabs(eng, list(seq.kv_blocks), n_full)
        sched.submit(501, prompts[1], max_new_tokens=4, shed_rank=0)
        sched.step()
        assert 500 in sched.preempted
        assert eng.state_manager.get_sequence(500) is None   # blocks freed
        for _ in range(2000):
            sched.step()
            if 500 in sched.running:
                break
        assert 500 in sched.running, "preempted sequence never resumed"
        seq2 = eng.state_manager.get_sequence(500)
        assert seq2.seen_tokens in (seen_before, seen_before + 1)
        if sched_cls is ContinuousBatchingScheduler:
            assert n_full >= 7
            after = _slabs(eng, list(seq2.kv_blocks), n_full)
            assert set(after) == set(before) and (
                kv == "fp32" or {"k_scale", "v_scale"} <= set(after))
            for name in before:
                assert torch.equal(before[name], after[name]), name
        fin = sched.run_to_completion(max_steps=2000)
        assert sched.preempt_stats() == {"preempted": 1, "resumed": 1}
        assert eng.free_blocks + eng.state_manager.evictable_blocks == 14
        streams.append([fin[500].generated, fin[501].generated])
    assert_greedy_parity(streams[1], streams[0], f"preemption ({kv})")
    ref = reference_streams(weights, [(prompts[0], 16), (prompts[1], 4)],
                            kv=kv)
    assert_greedy_parity(ref, streams[0], f"preempt round trip ({kv})")


def test_resume_falls_back_to_reprefill_when_payload_dropped(weights,
                                                            jax14):
    rng = np.random.default_rng(6)
    prompts = [rand_prompt(rng, 60), rand_prompt(rng, 60)]
    streams = []
    for eng, sched_cls in _both(weights, jax14, reservation=True,
                                preempt=True, factor=3.0):
        sched = sched_cls(eng)
        sched.submit(510, prompts[0], max_new_tokens=16, shed_rank=1)
        for _ in range(4):
            sched.step()
        sched.submit(511, prompts[1], max_new_tokens=4, shed_rank=0)
        sched.step()
        assert 510 in sched.preempted
        eng.preempt_discard(510)                 # the payload is gone
        fin = sched.run_to_completion(max_steps=2000)
        streams.append([fin[510].generated, fin[511].generated])
    assert_greedy_parity(streams[1], streams[0], "dropped-payload re-prefill")
    ref = reference_streams(weights, [(prompts[0], 16), (prompts[1], 4)])
    assert_greedy_parity(ref, streams[0], "dropped-payload re-prefill")


def test_preempt_vs_cancel_race(weights):
    rng = np.random.default_rng(7)
    eng = _port(weights, prefix=True, reservation=True, preempt=True,
                factor=3.0)
    sched = ContinuousBatchingScheduler(eng)
    finished = []
    sched.submit(520, rand_prompt(rng, 60), max_new_tokens=16, shed_rank=1,
                 on_finish=lambda r, why: finished.append((r.uid, why)))
    for _ in range(4):
        sched.step()
    sched.submit(521, rand_prompt(rng, 60), max_new_tokens=4, shed_rank=0)
    sched.step()
    assert 520 in sched.preempted
    assert sched.cancel(520)
    assert (520, "cancelled") in finished
    assert 520 not in sched.preempted
    assert eng.state_manager.preempted_parked == 0
    fin = sched.run_to_completion(max_steps=2000)
    assert 520 not in sched.running and 521 in fin
    assert sched.preempt_stats()["resumed"] == 0


def test_chunked_admission_wedge_and_reservation_streams(weights, jax14):
    rng = np.random.default_rng(0)
    prompts = [rand_prompt(rng, 76) for _ in range(8)]
    eng = _port(weights)
    sched = ContinuousBatchingScheduler(eng)
    for i, p in enumerate(prompts):
        sched.submit(100 + i, p, max_new_tokens=4)
    for _ in range(40):
        sched.step()
    assert not sched.finished and sched.has_work    # the historical wedge
    assert eng.free_blocks < 4
    streams = []
    for eng, sched_cls in _both(weights, jax14, reservation=True):
        sched = sched_cls(eng)
        for i, p in enumerate(prompts):
            sched.submit(200 + i, p, max_new_tokens=4)
        fin = sched.run_to_completion(max_steps=2000)
        assert len(fin) == 8 and eng.free_blocks == 14
        streams.append([fin[200 + i].generated for i in range(8)])
    assert_greedy_parity(streams[1], streams[0], "reservation admission")
    ref = reference_streams(weights, [(p, 4) for p in prompts])
    assert_greedy_parity(ref, streams[0], "reservation admission")


# ---------------------------------------------------------- KV export/import
def _raw(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _handoff(eng, sched_cls, prompt):
    """Decode 5 tokens, evacuate the sequence with its KV, import it under a
    new uid at other block ids, and finish it from the imported KV. Returns
    (the stream, the payload, the re-export of the imported sequence)."""
    sched = sched_cls(eng)
    sched.submit(1, prompt, max_new_tokens=12)
    while len(sched.running.get(1, Request(1, [])).generated) < 5:
        sched.step()
    done = list(sched.running[1].generated)
    payload = sched.evacuate(1)
    assert payload is not None and eng.state_manager.get_sequence(1) is None
    hold = eng.state_manager.allocator.allocate(3)    # new ids for the import
    eng.import_sequence(2, payload, prompt + done)
    again = eng.export_sequence(2)
    sched.submit_prefilled(2, prompt + done, payload["last_logits"],
                           max_new_tokens=12 - len(done))
    fin = sched.run_to_completion()
    eng.state_manager.allocator.release(hold)
    return done + fin[2].generated, payload, again


@pytest.mark.parametrize("kv", sorted(KV))
def test_export_import_mid_decode_roundtrip(weights, kv):
    rng = np.random.default_rng(8)
    prompt = rand_prompt(rng, 45)
    ref = reference_streams(weights, [(prompt, 12)], kv=kv)[0]
    port, jax_eng = _both(weights, kv_blocks=32, kv=kv)
    got, payload, again = _handoff(*port, prompt)
    jgot, _, _ = _handoff(*jax_eng, prompt)
    assert_greedy_parity([ref], [got], f"KV handoff ({kv})")
    assert_greedy_parity([jgot], [got], f"KV handoff vs JAX ({kv})")
    assert set(payload["slabs"]) == set(again["slabs"])
    assert payload["kv_quant"] == (kv != "fp32")
    for name, t in payload["slabs"].items():
        assert t.device.type == "cpu"
        assert torch.equal(_raw(t), _raw(again["slabs"][name])), name


@pytest.mark.parametrize("kv", ["fp32", "fp8"])
def test_chunked_export_import_is_byte_identical(weights, kv):
    eng = _port(weights, kv_blocks=32, kv=kv)
    rng = np.random.default_rng(9)
    toks = rand_prompt(rng, 29)
    eng.put([1], [toks])
    whole = eng.export_sequence(1)
    chunked = eng.export_sequence(1, chunk_blocks=2)
    assert [c["k"].shape[1] for c in chunked["chunks"]] == [2, 2]
    for name, t in whole["slabs"].items():
        glued = torch.cat([_raw(c[name]) for c in chunked["chunks"]], dim=1)
        assert torch.equal(_raw(t), glued)
    eng.import_sequence(2, chunked, toks)
    back = eng.export_sequence(2)
    for name, t in whole["slabs"].items():
        assert torch.equal(_raw(t), _raw(back["slabs"][name]))
    assert eng.state_manager.get_sequence(2).kv_blocks != \
        eng.state_manager.get_sequence(1).kv_blocks
    # representation checks leave the manager untouched
    bad = dict(whole, block_size=16)
    with pytest.raises(ValueError, match="block_size"):
        eng.import_sequence(3, bad, toks)
    bad = dict(whole, kv_quant=not whole["kv_quant"])
    with pytest.raises(ValueError, match="representation"):
        eng.import_sequence(3, bad, toks)
    with pytest.raises(ValueError, match="already has KV"):
        eng.import_sequence(2, whole, toks)
    assert eng.state_manager.get_sequence(3) is None


def _evacuate_failing_export(eng, sched_cls, prompts):
    """Three requests in flight (one parked by preemption), then evacuate
    the running, fully prefilled one while its export raises, the parked
    one, and an unknown uid: the scheduler's and engine's state after."""
    sched = sched_cls(eng)
    sched.submit(1, prompts[0], max_new_tokens=16, shed_rank=1)
    for _ in range(4):
        sched.step()
    sched.submit(2, prompts[1], max_new_tokens=12, shed_rank=0)
    sched.step()
    assert 1 in sched.preempted
    while not sched.running.get(2, Request(2, [])).generated:
        sched.step()
    sched.submit(3, prompts[2], max_new_tokens=4, shed_rank=1)

    def broken_export(uid, chunk_blocks=0):
        raise RuntimeError("export failed")

    eng.export_sequence = broken_export
    out = [sched.evacuate(2), sched.evacuate(1), sched.evacuate(99)]
    del eng.export_sequence
    state = {"returned": out, "running": sorted(sched.running),
             "preempted": sorted(sched.preempted),
             "pending": [r.uid for r in sched.pending],
             "finished": sorted(sched.finished),
             "free_blocks": eng.free_blocks,
             "tracked": sorted(eng.state_manager.tracked_sequences),
             "parked": eng.state_manager.preempted_parked,
             "reserved": eng.reserved_total_blocks()}
    fin = sched.run_to_completion(max_steps=2000)
    state["after"] = (fin[3].generated, eng.free_blocks)
    return state


def test_evacuate_with_failing_export_matches_jax(weights):
    """A failing export during evacuation is logged and dropped: the
    sequence still leaves ``running`` and frees its blocks, and both
    schedulers end in the same state."""
    rng = np.random.default_rng(12)
    prompts = [rand_prompt(rng, 60), rand_prompt(rng, 60),
               rand_prompt(rng, 10)]
    got = []
    for eng, sched_cls in _both(weights, prefix=True, reservation=True,
                                preempt=True, factor=3.0):
        got.append(_evacuate_failing_export(eng, sched_cls, prompts))
    port, ref = got
    assert port == ref
    assert port["returned"] == [None, None, None]
    assert port["running"] == [] and port["preempted"] == []
    assert port["tracked"] == [] and port["parked"] == 0
    assert port["reserved"] == 0
