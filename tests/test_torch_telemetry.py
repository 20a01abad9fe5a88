"""Port parity: the tracer (``telemetry/tracer.py``), the scheduler's spans
and the ranked locks (``utils/locks.py``) of ``deepspeed_tpu_torch`` against
the JAX package's on the CPU.

- The tracer cases of ``tests/test_telemetry.py:39-165``: nesting, a span
  ended on another thread, the ring, open spans and their cap, the no-op
  singleton, the allocation-free disabled path, the Chrome schema, its
  validation and coverage; the same calls give the JAX tracer's export
  (times and thread ids left out). With ``xla_annotations=True`` a span is
  also a ``torch.profiler`` range.
- The v2 scheduler with a tracer: greedy streams are the same traced or not
  (prefix cache and n-gram speculation on), and on the same traffic (prefix
  cache, speculation, KV tier, a cancel and an evacuation) its exported
  spans — names, trace ids, ids, parents and attributes — equal the JAX
  scheduler's; a traced request's span chain covers its TTFT.
- ``RankedLock``/``RankedCondition``: order enforcement, self-deadlock,
  reentrancy, condition wait and notify, hold-time records and the
  allocation-free disabled path, each recording what the JAX package's
  locks record (``tests/test_concurrency_lint.py:775-925``).
"""

import json
import threading
import time
import tracemalloc

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.scheduler import \
    ContinuousBatchingScheduler as JScheduler
from deepspeed_tpu.inference.v2.spec import NGramProposer as JNGram
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.utils import locks as jlocks
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference.v2 import (ContinuousBatchingScheduler,
                                              InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.spec import NGramProposer
from deepspeed_tpu_torch.inference.v2.testing import (assert_greedy_parity,
                                                      greedy_generate)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
from deepspeed_tpu_torch.telemetry import (NOOP_SPAN, NOOP_TRACER, Tracer,
                                           chrome_trace, trace_coverage,
                                           validate_chrome_trace)
from deepspeed_tpu_torch.utils import locks as tlocks
from deepspeed_tpu_torch.utils.locks import (LockOrderError, RankedCondition,
                                             RankedLock, disable_lock_debug,
                                             enable_lock_debug, lock_debug)
import torch_cpu  # noqa: F401  (one torch thread: see the module)

VOCAB = 128
PKGS = {"jax": (jtel, jlocks), "port": (ttel, tlocks)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny CPU ops run on one thread here: beside other test
    workers, torch's default of a thread per core oversubscribes the
    machine and every small op waits on the others."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _timeless(spans):
    return [{k: v for k, v in s.items() if k not in ("t_start", "t_end",
                                                      "tid")}
            for s in spans]


def _script(tel):
    """One fixed sequence of tracer calls: nesting, a cross-thread end, an
    open span, attributes."""
    tr = tel.Tracer(max_spans=16)
    with tr.span("outer", trace_id="t", attrs={"x": 1}) as outer:
        with tr.span("inner") as inner:
            inner.set("k", "v")
        assert tr.current() is outer
    sp = tr.begin("xthread", trace_id="req-1", parent=outer)
    t = threading.Thread(target=sp.end)
    t.start()
    t.join()
    sp.end()                                   # idempotent
    tr.begin("inflight", trace_id="req-2")
    return tr.export()


def test_tracer_export_matches_jax():
    port, ref = _script(ttel), _script(jtel)
    assert _timeless(port) == _timeless(ref)
    by = {s["name"]: s for s in port}
    assert by["inner"]["parent_id"] == by["outer"]["span_id"]
    assert by["inner"]["trace_id"] == "t"      # inherited from the parent
    assert by["xthread"]["parent_id"] == by["outer"]["span_id"]
    assert by["inflight"]["t_end"] is None and by["inflight"]["attrs"]["open"]


def test_span_nesting_and_ordering():
    tr = Tracer()
    with tr.span("outer", trace_id="t") as outer:
        time.sleep(0.001)
        with tr.span("inner") as inner:
            assert tr.current() is inner
            time.sleep(0.001)
        assert tr.current() is outer
    assert tr.current() is None
    spans = tr.export()
    by_name = {s["name"]: s for s in spans}
    assert spans[0]["name"] == "inner"         # inner completes first
    assert by_name["outer"]["t_start"] <= by_name["inner"]["t_start"]
    assert by_name["inner"]["t_end"] <= by_name["outer"]["t_end"]


def test_begin_end_cross_thread():
    tr = Tracer()
    sp = tr.begin("xthread", trace_id="req-1", attrs={"k": 1})
    t = threading.Thread(target=sp.end)
    t.start()
    t.join()
    (d,) = tr.export()
    assert d["name"] == "xthread" and d["t_end"] is not None
    assert d["attrs"]["k"] == 1
    sp.end()
    assert len(tr.export()) == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ring_and_open_span_cap(pkg):
    tel = PKGS[pkg][0]
    tr = tel.Tracer(max_spans=4)
    for i in range(10):
        tr.begin(f"s{i}").end()
    assert [s["name"] for s in tr.export()] == ["s6", "s7", "s8", "s9"]
    assert tr.completed_total == 10
    got, cursor = tr.drain_completed(7, limit=2)
    assert [s["name"] for s in got] == ["s7", "s8"] and cursor == 9
    tr.clear()
    spans = [tr.begin(f"open{i}") for i in range(6)]
    ex = tr.export(include_open=True)
    assert all(s["t_end"] is None and s["attrs"]["open"] for s in ex)
    assert len(ex) == 4                        # leak cap at max_spans
    assert tr.export(include_open=False) == []
    for sp in spans:
        sp.end()


def test_disabled_is_noop_singleton():
    tr = Tracer(enabled=False)
    assert tr.span("a") is NOOP_SPAN
    assert tr.begin("b") is NOOP_SPAN
    with tr.span("c") as sp:
        assert sp.set("k", 1) is sp
    assert tr.export() == []
    assert NOOP_TRACER.span("d") is NOOP_SPAN
    assert not NOOP_TRACER.enabled


def test_disabled_hot_path_allocation_free():
    tr = Tracer(enabled=False)
    with tr.span("warm"):
        pass
    here = __file__
    tracer_file = Tracer.__init__.__code__.co_filename
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with tr.span("hot"):
                pass
            tr.begin("hot2").set("k", 1).end()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    leaked = sum(st.count_diff for st in after.compare_to(before, "lineno")
                 if st.traceback and st.traceback[0].filename in (
                     here, tracer_file) and st.count_diff > 0)
    assert leaked <= 8, f"disabled tracer leaked {leaked} objects"
    assert tr.export() == []


def test_chrome_trace_schema_valid():
    tr = Tracer()
    with tr.span("a", trace_id="req-1", attrs={"x": 3}):
        with tr.span("b"):
            pass
    tr.begin("other", trace_id="replica-0").end()
    open_span = tr.begin("inflight", trace_id="req-1")
    obj = chrome_trace(tr.export(), meta={"reason": "test"})
    assert validate_chrome_trace(obj) == []
    assert validate_chrome_trace(json.dumps(obj)) == []
    events = obj["traceEvents"]
    assert {"req-1", "replica-0"} <= {e["args"]["name"] for e in events
                                      if e["ph"] == "M"}
    assert any(e["ph"] == "B" and e["name"] == "inflight" for e in events)
    xs = [e for e in events if e["ph"] == "X"]
    assert xs and all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    ref = jtel.chrome_trace(tr.export(), meta={"reason": "test"})
    assert obj == ref                          # the JAX renderer's output
    open_span.end()


def test_validate_chrome_trace_catches_garbage():
    cases = ["not json{", {"no_events": 1},
             {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1,
                               "ts": 0.0}]},
             {"traceEvents": [{"name": "", "ph": "Z", "pid": "a", "tid": 1,
                               "ts": 0}]}]
    for c in cases:
        got = validate_chrome_trace(c)
        assert got and got == jtel.validate_chrome_trace(c)
    assert any("dur" in p for p in validate_chrome_trace(cases[2]))


def test_trace_coverage():
    mk = lambda a, b: {"t_start": a, "t_end": b}  # noqa: E731
    cases = [([mk(0, 1)], 1.0), ([mk(0, 0.6), mk(0.4, 1.0)], 1.0),
             ([mk(0, 0.25), mk(0.75, 1.0)], 0.5),
             ([{"t_start": 0.5, "t_end": None}], 0.5), ([], 0.0)]
    for spans, want in cases:
        assert trace_coverage(spans, 0, 1) == pytest.approx(want)
        assert trace_coverage(spans, 0, 1) == jtel.trace_coverage(spans, 0, 1)


def test_xla_annotations_open_torch_profiler_ranges():
    """``xla_annotations`` (the JAX keyword) mirrors context-manager spans
    into ``torch.profiler.record_function``."""
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer(xla_annotations=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("tier_restore_span"):
            with tr.span("inner_put_span"):
                torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"tier_restore_span", "inner_put_span"} <= names
    assert [s["name"] for s in tr.export()] == ["inner_put_span",
                                                "tier_restore_span"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with Tracer().span("not_annotated_span"):
            torch.ones(8).sum()
    assert "not_annotated_span" not in {e.key for e in prof.key_averages()}


# --------------------------------------------------------- scheduler spans
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


ENGINE_KW = dict(max_ragged_batch_size=128, max_ragged_sequence_count=4,
                 max_chunk_tokens=32, kv_blocks=14, kv_block_size=8,
                 max_tracked_sequences=64, enable_prefix_cache=True)


def _port(weights, **kw):
    return InferenceEngineV2(ttf.CausalLM(_cfg(ttf)),
                             params_from_numpy(weights, device="cpu"),
                             RaggedInferenceEngineConfig(**ENGINE_KW, **kw),
                             device="cpu")


def _prompts(seed=2, n=4):
    """``n`` system prompts of 4 blocks each (together more than the pool
    holds), each followed by a repeated motif and a random tail."""
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, VOCAB, 6).tolist()
    return [rng.integers(0, VOCAB, 32).tolist() + motif * 2
            + rng.integers(0, VOCAB, 4).tolist() for _ in range(n)]


def test_greedy_parity_telemetry_on_vs_off(weights):
    prompts = _prompts()

    def run(tracer):
        sched = ContinuousBatchingScheduler(
            _port(weights, kv_tier_enabled=True),
            proposer=NGramProposer(ngram_max=3), max_draft_tokens=3,
            tracer=tracer, trace_label="parity")
        return greedy_generate(prompts=prompts, uid_base=500,
                               max_new_tokens=8, scheduler=sched)

    ref = run(None)
    tr = Tracer()
    assert_greedy_parity(ref, run(tr), label="telemetry")
    names = {s["name"] for s in tr.export()}
    assert names == {"forward", "spec_verify"}   # no trace ids were given


def _traced_run(sched_cls, eng, proposer, tracer):
    """Two passes of 4 requests with trace ids over a 14-block pool (the
    tier spills and restores), then a pass in which one request is
    cancelled in mid-decode and another evacuated."""
    sched = sched_cls(eng, proposer=proposer, max_draft_tokens=3,
                      tracer=tracer, trace_label="replica-0")
    prompts = _prompts()
    for p in range(2):
        for i, pr in enumerate(prompts):
            uid = 100 * p + i
            sched.submit(uid, pr, max_new_tokens=6, trace_id=f"req-{uid}")
            sched.run_to_completion()
    for i, pr in enumerate(prompts[:3]):
        sched.submit(300 + i, pr[:20], max_new_tokens=12,
                     trace_id=f"req-{300 + i}")
    for _ in range(40):
        sched.step()
        if all(300 + i in sched.running and sched.running[300 + i].generated
               for i in range(2)):
            break
    assert sched.cancel(300)
    payload = sched.evacuate(301)
    assert payload is not None and "last_logits" in payload
    sched.run_to_completion()
    return {u: r.generated for u, r in sched.finished.items()}, tracer.export()


def test_scheduler_spans_match_jax(weights):
    """Prefix cache, n-gram speculation, the KV tier, a cancel and an
    evacuation: the port's spans are the JAX scheduler's, times left
    out."""
    jeng = JEngine(jtf.CausalLM(_cfg(jtf)),
                   jax.tree.map(jax.numpy.asarray, weights),
                   JConfig(**ENGINE_KW, kv_tier_enabled=True))
    ref_streams, ref = _traced_run(JScheduler, jeng, JNGram(ngram_max=3),
                                   jtel.Tracer())
    streams, got = _traced_run(ContinuousBatchingScheduler,
                               _port(weights, kv_tier_enabled=True),
                               NGramProposer(ngram_max=3), Tracer())
    assert streams == ref_streams
    assert _timeless(got) == _timeless(ref)
    names = [s["name"] for s in got]
    assert {"prefill", "decode", "forward", "spec_verify"} <= set(names)
    ends = {s["attrs"].get("finish_reason") for s in got
            if s["name"] == "decode"}
    assert {"length", "cancelled", "evacuated"} <= ends
    restored = [s["attrs"].get("kv_tier_restored_blocks", 0) for s in got
                if s["name"] == "prefill"]
    assert sum(restored) > 0                   # the tier served prefixes
    assert any(s["attrs"].get("verify_width") for s in got
               if s["name"] == "forward")
    assert validate_chrome_trace(chrome_trace(got)) == []
    # each request's chain (prefill, then decode from its first token)
    # covers its life but for the clock reads between the two spans
    by_trace = {}
    for s in got:
        by_trace.setdefault(s["trace_id"], []).append(s)
    for tid, spans in by_trace.items():
        if tid == "replica-0":
            continue
        t0 = min(s["t_start"] for s in spans)
        t1 = max(s["t_end"] for s in spans)
        assert trace_coverage(spans, t0, t1) >= 0.95


# ------------------------------------------------------------ ranked locks
@pytest.fixture
def both_debug():
    states = {pkg: locks.enable_lock_debug(hold_threshold_s=60.0)
              for pkg, (_, locks) in PKGS.items()}
    try:
        yield states
    finally:
        for _, locks in PKGS.values():
            locks.disable_lock_debug()


def _records(state):
    return [{k: v for k, v in r.items() if k not in ("t", "thread")}
            for r in state.violations]


def test_rank_table_is_the_jax_table():
    assert tlocks.LOCK_RANKS == jlocks.LOCK_RANKS
    with pytest.raises(KeyError):
        RankedLock("no.such.lock")


def test_order_enforced_in_debug_mode(both_debug):
    for pkg, (_, locks) in PKGS.items():
        outer = locks.RankedLock("serving.queue")        # 60
        inner = locks.RankedLock("telemetry.tracer")     # 160
        with outer:
            with inner:                                  # ascending: fine
                pass
        with pytest.raises(locks.LockOrderError):
            with inner:
                with outer:                              # descending
                    pass
        lock = locks.RankedLock("serving.replica")
        with lock:
            with pytest.raises(locks.LockOrderError, match="self-deadlock"):
                lock.acquire()
        rl = locks.RankedLock("serving.router.membership", reentrant=True)
        with rl:
            with rl:
                pass
    port, ref = both_debug["port"], both_debug["jax"]
    assert _records(port) == _records(ref)
    assert [v["lock"] for v in port.violations] == ["serving.queue",
                                                    "serving.replica"]
    assert port.violations[0]["holding"] == ["telemetry.tracer"]


def test_condition_wait_and_notify(both_debug):
    cond = RankedCondition("serving.queue")
    hits = []

    def waiter():
        with cond:
            while not hits:
                if not cond.wait(2.0):
                    return
        hits.append("woke")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        hits.append("set")
        cond.notify_all()
    t.join(3)
    assert hits == ["set", "woke"]
    assert both_debug["port"].violations == []


class _Histograms:
    def __init__(self):
        self.seen = []

    def histogram(self, name):
        owner = self

        class _H:
            def observe(self, v):
                owner.seen.append((name, v))
        return _H()


class _Recorder:
    def __init__(self):
        self.events = []

    def on_event(self, name):
        self.events.append(name)


def test_hold_histogram_and_over_threshold():
    out = {}
    for pkg, (_, locks) in PKGS.items():
        reg, rec = _Histograms(), _Recorder()
        state = locks.enable_lock_debug(metrics=reg, recorder=rec,
                                        hold_threshold_s=0.02)
        try:
            lock = locks.RankedLock("serving.handoff")
            with lock:
                pass
            with lock:
                time.sleep(0.05)                 # over the 20 ms threshold
            outer = locks.RankedLock("telemetry.tracer")
            with outer:
                with pytest.raises(locks.LockOrderError):
                    lock.acquire()
        finally:
            locks.disable_lock_debug()
        out[pkg] = ([n for n, _ in reg.seen], rec.events,
                    [r["lock"] for r in state.over_holds])
        assert state.over_holds[0]["hold_s"] >= 0.02
    assert out["port"] == out["jax"]
    names, events, over = out["port"]
    assert names.count("lock_hold_s") >= 2 and over == ["serving.handoff"]
    assert events == ["lock_hold_serving.handoff",
                      "lock_order_serving.handoff"]


def test_disabled_path_allocation_free():
    assert lock_debug() is None
    lock = RankedLock("serving.replica")
    with lock:
        pass
    here = __file__
    locks_file = RankedLock.acquire.__code__.co_filename
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with lock:
                pass
            lock.acquire()
            lock.release()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    leaked = sum(st.count_diff for st in after.compare_to(before, "lineno")
                 if st.traceback and st.traceback[0].filename in (
                     here, locks_file) and st.count_diff > 0)
    assert leaked <= 8, f"disabled RankedLock leaked {leaked} objects"
    state = enable_lock_debug()
    disable_lock_debug()
    assert lock_debug() is None and state.violations == []
    assert issubclass(LockOrderError, RuntimeError)
