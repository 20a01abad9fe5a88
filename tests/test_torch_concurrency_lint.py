"""Port parity: the concurrency lint (``deepspeed_tpu_torch/analysis``)
against the JAX package's ``deepspeed_tpu/analysis``.

The port keeps its own copy of the pure-stdlib analyzer with the analyzed
package as a parameter. Held here:

- run over the JAX package's threaded modules, with the JAX rank table,
  declared names and baseline, it reports exactly the JAX analyzer's
  findings (raw, declared-name, active and suppressed, rendered line for
  line);
- run over the port's own threaded modules (its default), it is clean
  against the port's ``baseline.toml``, each of whose entries is the
  counterpart of a JAX baseline entry with the same justification;
- on fixture sources (guarded fields, rank order, cycles, blocking while
  locked) and a fixture package (declared names) both analyzers give the
  same findings;
- the baseline rules (suppression, stale and unjustified entries, scoped
  runs) and the CLI, ``python -m deepspeed_tpu_torch.analysis``.
"""

import os
import subprocess
import sys

import pytest

import deepspeed_tpu.analysis as J
import deepspeed_tpu.utils.locks as j_locks
import deepspeed_tpu_torch.analysis as T
import deepspeed_tpu_torch.utils.locks as t_locks
from deepspeed_tpu.analysis.declared import \
    check_declared_names as j_check_declared
from deepspeed_tpu_torch.analysis.__main__ import main as cli_main
from deepspeed_tpu_torch.analysis.declared import \
    check_declared_names as t_check_declared
import torch_cpu  # noqa: F401  (one torch thread: see the module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def renders(findings):
    return sorted(f.render() for f in findings)


# -------------------------------------------------- the JAX package's code
def test_jax_sources_give_the_jax_findings():
    raw = T.analyze(REPO, J.DEFAULT_PATHS, package="deepspeed_tpu")
    j_raw = J.analyze(REPO, J.DEFAULT_PATHS)
    assert renders(raw) == renders(j_raw)
    declared = t_check_declared(REPO, "deepspeed_tpu")
    j_declared = j_check_declared(REPO)
    assert renders(declared) == renders(j_declared)
    j_entries, j_problems = J.load_baseline(REPO)
    entries, problems = T.load_baseline(REPO, J.DEFAULT_BASELINE)
    assert j_problems == problems == []
    # run_repo is analyze + check_declared_names + apply_baseline (the
    # port's run_repo over a package is held on the port below)
    j_active, j_suppressed = J.apply_baseline(j_raw + j_declared, j_entries,
                                              J.DEFAULT_BASELINE)
    active, suppressed = T.apply_baseline(raw + declared, entries,
                                          J.DEFAULT_BASELINE)
    assert renders(active) == renders(j_active) == []
    assert renders(suppressed) == renders(j_suppressed)
    assert {f.baseline_id for f in suppressed} == {e.id for e in j_entries}
    scoped, _ = T.run_repo(REPO, paths=["deepspeed_tpu/telemetry"],
                           baseline_path=J.DEFAULT_BASELINE,
                           package="deepspeed_tpu")
    j_scoped, _ = J.apply_baseline(
        J.analyze(REPO, ["deepspeed_tpu/telemetry"]) + j_declared,
        j_entries, J.DEFAULT_BASELINE, report_stale=False)
    assert renders(scoped) == renders(j_scoped)


# ---------------------------------------------------------- the port's code
def test_port_sources_clean_against_port_baseline():
    active, suppressed = T.run_repo(REPO)
    assert active == [], "\n".join(f.render() for f in active)
    entries, problems = T.load_baseline(REPO)
    assert problems == []
    j_entries, _ = J.load_baseline(REPO)
    counterpart = {e.id.replace("deepspeed_tpu/", "deepspeed_tpu_torch/"):
                   e.justification for e in j_entries}
    for e in entries:
        assert counterpart.get(e.id) == e.justification, e.id
    assert {f.baseline_id for f in suppressed} == {e.id for e in entries}
    # the JAX package's scope, the training supervisor included
    assert T.DEFAULT_PATHS == tuple(
        path.replace("deepspeed_tpu/", "deepspeed_tpu_torch/")
        for path in J.DEFAULT_PATHS)
    assert "deepspeed_tpu_torch/runtime/resilience.py" in T.DEFAULT_PATHS


def test_rank_tables_and_lock_names_agree():
    """The port's rank table is the JAX one, and every RankedLock the
    port's threaded modules construct is named in it."""
    assert t_locks.LOCK_RANKS == j_locks.LOCK_RANKS
    assert T.parse_lock_ranks(REPO) == dict(t_locks.LOCK_RANKS)
    model = T.build_model(REPO)
    named = {d.rank_name for cm in model.classes
             for d in cm.locks.values() if d.rank_name}
    assert named and named <= set(t_locks.LOCK_RANKS)
    for name in ("serving.tenancy", "serving.affinity",
                 "serving.autoscaler", "serving.frontend.fleet"):
        assert name in named, name


def test_fabric_modules_linted_and_clean():
    """The serving fabric's threaded modules lie under the lint's default
    roots, their locks are named in the rank table, and their raw findings
    are the JAX fabric's (none) or baselined like them."""
    from deepspeed_tpu_torch.analysis.concurrency import iter_py_files

    files = iter_py_files(REPO, T.DEFAULT_PATHS)
    fabric = [f for f in files
              if f.startswith("deepspeed_tpu_torch/serving/fabric/")]
    assert sorted(os.path.basename(f) for f in fabric) == [
        "__init__.py", "chaos.py", "codec.py", "federation.py",
        "handle.py", "remote.py", "server.py", "transport.py"]
    model = T.build_model(REPO)
    named = {d.rank_name for cm in model.classes
             for d in cm.locks.values() if d.rank_name}
    for name in ("serving.fabric.remote", "serving.fabric.federation",
                 "serving.fabric.server", "serving.fabric.transport",
                 "serving.fabric.chaos"):
        assert name in named, name
    raw = [f for f in T.analyze(REPO)
           if f.path.startswith("deepspeed_tpu_torch/serving/fabric/")]
    j_raw = [f for f in J.analyze(REPO)
             if f.path.startswith("deepspeed_tpu/serving/fabric/")]
    assert renders(raw) == sorted(
        r.replace("deepspeed_tpu/", "deepspeed_tpu_torch/")
        for r in renders(j_raw))
    active, _ = T.run_repo(REPO, paths=["deepspeed_tpu_torch/serving/fabric"])
    assert active == [], "\n".join(f.render() for f in active)


# ---------------------------------------------------------------- fixtures
FIXTURES = {
    "guarded": '''
import threading
class C:
    _GUARDED_BY = {"_x": "_lock", "_y": "_lock:writes"}
    def __init__(self):
        self._lock = threading.Lock()
        self._x = 0
        self._y = 0
    def bad_read(self):
        return self._x
    def bad_write(self):
        self._y = 1
    def ok(self):
        with self._lock:
            self._x += 1
            self._y = 2
        return self._y
    def _helper_locked(self):
        self._x += 1
    def caller(self):
        with self._lock:
            self._helper_locked()
    def leaky(self):
        self._helper_locked()
''',
    "rank-order": '''
from deepspeed_tpu_torch.utils.locks import RankedLock
class C:
    def __init__(self):
        self._a = RankedLock("serving.router")
        self._b = RankedLock("serving.queue")
    def inverted(self):
        with self._b:
            with self._a:
                pass
    def fine(self):
        with self._a:
            with self._b:
                pass
''',
    "cycle": '''
import threading
class A:
    def __init__(self, b: "B"):
        self._lock = threading.Lock()
        self.b = b
    def go(self):
        with self._lock:
            self.b.poke()
    def poke(self):
        with self._lock:
            pass
class B:
    def __init__(self, a: A):
        self._lock = threading.Lock()
        self.a = a
    def go(self):
        with self._lock:
            self.a.poke()
    def poke(self):
        with self._lock:
            pass
''',
    "blocking": '''
import threading, time
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.thread = threading.Thread(target=lambda: None)
    def sleeps(self):
        with self._lock:
            time.sleep(0.1)
    def joins(self):
        with self._lock:
            self.thread.join()
    def _io(self):
        with open("x") as fh:
            fh.write("y")
    def indirect(self):
        with self._lock:
            self._io()
    def waits_ok(self):
        with self._cv:
            self._cv.wait(0.1)
''',
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_findings_equal_jax(name):
    src = FIXTURES[name]
    ranks = dict(j_locks.LOCK_RANKS)
    got = T.analyze_source(src, path="fixture.py", lock_ranks=ranks)
    ref = J.analyze_source(src.replace("deepspeed_tpu_torch",
                                       "deepspeed_tpu"),
                           path="fixture.py", lock_ranks=ranks)
    assert got, name
    assert renders(got) == renders(ref)
    assert renders(T.analyze_source(src, path="fixture.py")) \
        == renders(got)


def mini_package(root, package, app_src):
    pkg = os.path.join(root, package)
    for sub in ("utils", "serving", "telemetry"):
        os.makedirs(os.path.join(pkg, sub))
    files = {
        "utils/locks.py": 'LOCK_RANKS = {"a.outer": 10, "a.inner": 20}\n',
        "serving/metrics.py": (
            "def serving_metrics(classes=(\"interactive\",)):\n"
            "    reg = object()\n"
            "    for c in (\"requests_total\", \"tokens_total\"):\n"
            "        reg.counter(c)\n"
            "    reg.gauge(\"depth\")\n"
            "    for cls in classes:\n"
            "        reg.histogram(f\"lat_s_class_{cls}\")\n"),
        "telemetry/journal.py":
            "EVENT_SCHEMAS = {\"thing_happened\": frozenset({\"x\"})}\n",
        "telemetry/slo.py":
            "class AlertEngine:\n    def __init__(self):\n        pass\n",
        "serving/app.py": app_src,
    }
    for rel, text in files.items():
        with open(os.path.join(pkg, rel), "w") as fh:
            fh.write(text)


APP = ("REG = object()\n"
       "REG.counter(\"module_scope_bogus\").inc()\n"
       "class App:\n"
       "    def ok(self, m, cls):\n"
       "        m.counter(\"requests_total\").inc()\n"
       "        m.histogram(f\"lat_s_class_{cls}\")\n"
       "        self.journal.emit(\"thing_happened\", x=1)\n"
       "    def bad(self, m):\n"
       "        m.counter(\"bogus_counter\").inc()\n"
       "        m.gauge(f\"depth_of_{self.x}\")\n"
       "        self.journal.emit(\"unknown_kind\", x=1)\n"
       "    def _record(self, action):\n"
       "        self.journal.emit(action, x=1)\n"
       "    def go(self):\n"
       "        self._record(\"thing_happened\")\n"
       "        self._record(\"nope\")\n")


def test_declared_names_equal_jax_on_a_fixture_package(tmp_path):
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    mini_package(jroot, "deepspeed_tpu", APP)
    mini_package(troot, "deepspeed_tpu_torch", APP)
    ref = j_check_declared(jroot)
    got = t_check_declared(troot)
    assert len(got) == 5
    assert renders(got) == renders(ref).__class__(
        r.replace("deepspeed_tpu/", "deepspeed_tpu_torch/")
        for r in renders(ref))
    assert renders(t_check_declared(jroot, "deepspeed_tpu")) \
        == renders(ref)


# ---------------------------------------------------------------- baseline
GOOD = ("[[finding]]\n"
        'id = "guarded-field:a.py:C.m:_x"\n'
        'justification = "audited: single-writer by construction"\n')


@pytest.mark.parametrize("case", ["suppress", "stale", "unjustified",
                                  "render"])
def test_baseline_rules_equal_jax(case):
    def run(mod):
        finding = mod.Finding("guarded-field", "a.py", 3, "C.m", "_x",
                              "read")
        entries, problems = mod.parse_baseline(GOOD)
        if case == "suppress":
            a, s = mod.apply_baseline([finding], entries)
            return renders(a), renders(s), problems
        if case == "stale":
            a, s = mod.apply_baseline([], entries)
            scoped = mod.apply_baseline([], entries, report_stale=False)
            return [f.check for f in a], s, scoped
        if case == "unjustified":
            _, probs = mod.parse_baseline(GOOD.replace(
                "audited: single-writer by construction", ""))
            _, bad = mod.parse_baseline("[[finding]]\nnot toml\n")
            return [p.check for p in probs], [p.check for p in bad]
        new = mod.Finding("lock-order", "b.py", 1, "D.n", "x->y", "inv")
        return mod.render_baseline([finding, new], entries)
    assert run(T) == run(J)


def test_cli_gate_and_scoped_update_refused(capsys):
    assert cli_main(["--quiet"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    before = open(os.path.join(REPO, T.DEFAULT_BASELINE)).read()
    assert cli_main(["--update-baseline",
                     "deepspeed_tpu_torch/telemetry"]) == 2
    assert open(os.path.join(REPO, T.DEFAULT_BASELINE)).read() == before
    out = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.analysis"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout
