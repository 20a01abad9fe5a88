"""Port parity: the mesh topology, the communication layer and the comms
logger of ``deepspeed_tpu_torch`` against the JAX package.

Without processes: rank grids against ``MeshTopology.build(devices=...)``
(JAX device r holds what rank r holds), the same ``ValueError`` messages,
the launch-environment discovery and its loud MPI failure, and
``CommsLogger``/``calc_bw_log`` number for number.

In one 4-rank gloo world (``torch_ranks.RankPool``): every collective over
the whole world, ``data``, ``fsdp`` and (``fsdp``, ``data``) on a
(data 2, fsdp 2) mesh, rank r passing its own tensor, against the JAX
collectives on the stacked inputs over a (2, 2) mesh of four CPU devices:
the in-jit functions under ``shard_map`` for every group, and the
``eager_*`` functions for the single axes. Sums compare to 1e-6 (the same
fp32 additions in another order); gathers, maxima, broadcasts and moves
exactly.
"""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.compat import shard_map
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.runtime.config import MeshConfig as JMeshConfig
from deepspeed_tpu.utils import comms_logging as jlog
from deepspeed_tpu_torch import comm as tcomm
from deepspeed_tpu_torch.comm import comm as tcomm_mod
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.runtime.config import MeshConfig as TMeshConfig
from deepspeed_tpu_torch.utils import comms_logging as tlog

import torch_rank_cases as cases
from torch_ranks import RankPool
import torch_cpu  # noqa: F401  (one torch thread: see the module)

TOPOLOGIES = [
    ({"data": 2, "fsdp": 2}, None, 4),
    ({"fsdp": 4}, None, 4),
    ({"data": -1, "fsdp": 2}, None, 8),
    ({"fsdp": 2, "tensor": 2}, ["pipe", "data", "tensor", "fsdp",
                                 "sequence", "expert"], 8),
    ({}, None, 3),
]


def _jax_grid(t):
    return np.vectorize(lambda d: d.id)(t.mesh.devices)


@pytest.mark.parametrize("sizes,order,n", TOPOLOGIES)
def test_rank_grid_matches_jax_device_grid(sizes, order, n):
    kw = {} if order is None else {"axis_order": order}
    jt = jtopo.MeshTopology.build(JMeshConfig(**kw) if kw else None,
                                  devices=jax.devices()[:n], **sizes)
    tt = ttopo.MeshTopology.build(TMeshConfig(**kw) if kw else None,
                                  world_size=n, **sizes)
    assert tt.axis_names == jt.axis_names
    assert tt.shape == dict(jt.mesh.shape)
    np.testing.assert_array_equal(tt.rank_grid(), _jax_grid(jt))
    for name in ("world_size",):
        assert getattr(tt, name) == getattr(jt, name)
    for name in ("get_data_parallel_world_size",
                 "get_model_parallel_world_size",
                 "get_pipe_parallel_world_size",
                 "get_expert_parallel_world_size",
                 "get_sequence_parallel_world_size",
                 "get_sequence_data_parallel_world_size"):
        assert getattr(tt, name)() == getattr(jt, name)()
    grid = tt.rank_grid()
    for r in range(n):
        c = tt.coords(r)
        assert grid[tuple(c[a] for a in tt.axis_order)] == r
    # every group of an axis tuple: ranks differing only along it, first
    # axis major
    groups = tt.group_ranks(("fsdp", "data"))
    assert sorted(r for g in groups for r in g) == list(range(n))
    for g in groups:
        assert [tt.flat_index(r, ("fsdp", "data")) for r in g] == \
            list(range(len(g)))


@pytest.mark.parametrize("sizes,n", [({"data": -1, "fsdp": -1}, 4),
                                     ({"fsdp": 3}, 4),
                                     ({"data": 2, "fsdp": 3}, 4),
                                     ({"fsdp": 2}, 1)])
def test_topology_errors_match_jax(sizes, n):
    with pytest.raises(ValueError) as je:
        jtopo.MeshTopology.build(devices=jax.devices()[:n], **sizes)
    with pytest.raises(ValueError) as te:
        ttopo.MeshTopology.build(world_size=n, **sizes)
    assert str(te.value) == str(je.value)


def test_topology_registry():
    ttopo.reset_topology()
    assert not ttopo.has_topology()
    t = ttopo.get_topology()            # one process: a one-rank mesh
    assert t.world_size == 1 and ttopo.has_topology()
    other = ttopo.MeshTopology.build(world_size=4, fsdp=4)
    ttopo.set_topology(other)
    assert ttopo.get_topology() is other
    ttopo.reset_topology()
    assert not ttopo.has_topology()


ENVS = [
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "RANK": "3",
      "WORLD_SIZE": "4"}, ("10.0.0.1:1234", 3, 4)),
    ({"COORDINATOR_ADDRESS": "h:9", "PROCESS_ID": "1",
      "NUM_PROCESSES": "2"}, ("h:9", 1, 2)),
    ({"MASTER_ADDR": "a", "OMPI_COMM_WORLD_RANK": "2",
      "OMPI_COMM_WORLD_SIZE": "8"}, ("a:29500", 2, 8)),
    ({"MASTER_ADDR": "a", "PMI_RANK": "1", "PMI_SIZE": "2"},
     ("a:29500", 1, 2)),
    ({}, (None, 0, 1)),
]
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
            "COORDINATOR_ADDRESS", "PROCESS_ID", "NUM_PROCESSES",
            "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "PMI_RANK",
            "PMI_SIZE")


@pytest.mark.parametrize("env,want", ENVS)
def test_launch_environment_discovery(env, want, monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tcomm_mod._discover(-1, -1, True, 29500) == want


def test_mpi_launch_without_coordinator_fails_like_jax(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    monkeypatch.setattr(jcomm.comm, "_initialized", False)
    with pytest.raises(ValueError) as je:
        jcomm.init_distributed(verbose=False)
    with pytest.raises(ValueError) as te:
        tcomm.init_distributed(verbose=False)
    assert str(te.value) == str(je.value)
    assert "MASTER_ADDR" in str(te.value)
    # nccl refuses two ranks on one card: named up front, before any CUDA
    monkeypatch.delenv("OMPI_COMM_WORLD_RANK")
    monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")
    with pytest.raises(ValueError, match="gloo"):
        tcomm.init_distributed(dist_backend="nccl", rank=0, world_size=2,
                               init_method="file:///nonexistent/x",
                               verbose=False)
    assert not tcomm.is_initialized()


BW_CASES = [(op, size, dt, n) for op in
            ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single", "broadcast", "send")
            for size, dt, n in ((4096, 1e-3, 4), (1 << 20, 0.5, 2),
                                (7, 0.0, 8))]


def test_comms_logger_matches_jax():
    for op, size, dt, n in BW_CASES:
        assert tlog.calc_bw_log(op, size, dt, n) == \
            jlog.calc_bw_log(op, size, dt, n)
    arr = np.zeros((3, 5), np.float32)
    assert tlog.get_msg_size_from_args(1, arr) == \
        jlog.get_msg_size_from_args(1, arr) == 60
    import torch
    assert tlog.get_msg_size_from_args(torch.zeros(3, 5)) == 60
    loggers = [tlog.CommsLogger(enabled=True, prof_ops=["all_reduce"]),
               jlog.CommsLogger(enabled=True, prof_ops=["all_reduce"])]
    for lg in loggers:
        for op, size, dt, n in BW_CASES:
            lg.append(op, op, dt, size, n)
    assert loggers[0].should_profile("all_reduce")
    assert not loggers[0].should_profile("broadcast")
    assert loggers[0].log_all(print_log=False) == \
        loggers[1].log_all(print_log=False)
    loggers[0].reset()
    assert loggers[0].log_all(print_log=False) == {}
    assert loggers[0].host_staged_bytes == 0


# ------------------------------------------------------ 4 ranks over gloo

@pytest.fixture(scope="module")
def pool():
    with RankPool(4) as p:
        yield p


X = np.random.default_rng(0).standard_normal((4, 4, 8)).astype(np.float32)


def _jax_per_rank(fn):
    t = jtopo.get_topology()
    body = shard_map(lambda x: fn(x[0, 0])[None, None], mesh=t.mesh,
                     in_specs=P("data", "fsdp"), out_specs=P("data", "fsdp"),
                     check_vma=False)
    out = np.asarray(jax.jit(body)(X.reshape((2, 2) + X.shape[1:])))
    return out.reshape((4,) + out.shape[2:])


EXACT = ("all_gather_into_tensor", "all_gather", "broadcast",
         "all_to_all_single", "ppermute", "send", "recv", "axis_index")


def _close(got, want, name, op):
    if name in EXACT or op in ("MAX", "MIN"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_collectives_match_jax(pool):
    res = pool.run(cases.comm_cases, X)
    jtopo.set_topology(jtopo.MeshTopology.build(
        devices=jax.devices()[:4], data=2, fsdp=2))
    R = jcomm.ReduceOp
    for g in cases.GROUPS:
        gk = repr(g)
        want = {}
        for op in cases.REDUCE_OPS:
            want[("all_reduce", op)] = _jax_per_rank(
                lambda x, op=op: jcomm.all_reduce(x, R[op], g))
        want[("inference_all_reduce", "")] = _jax_per_rank(
            lambda x: jcomm.inference_all_reduce(x, group=g))
        for axis in (0, 1):
            want[("all_gather_into_tensor", axis)] = _jax_per_rank(
                lambda x, a=axis: jcomm.all_gather_into_tensor(None, x, g,
                                                               axis=a))
            for op in ("SUM", "AVG"):
                want[("reduce_scatter_tensor", f"{op}{axis}")] = \
                    _jax_per_rank(lambda x, a=axis, op=op:
                                  jcomm.reduce_scatter_tensor(
                                      None, x, R[op], g, scatter_dim=a))
        want[("all_gather", "")] = _jax_per_rank(
            lambda x: jcomm.all_gather(None, x, g))
        want[("broadcast", "")] = _jax_per_rank(
            lambda x: jcomm.broadcast(x, 1, g))
        want[("reduce", "")] = _jax_per_rank(
            lambda x: jcomm.reduce(x, 1, R.SUM, g))
        want[("axis_index", "")] = _jax_per_rank(
            lambda x: jcomm.axis_index(g) + 0 * x[0, 0])
        if isinstance(g, str):
            want[("all_to_all_single", "00")] = _jax_per_rank(
                lambda x: jcomm.all_to_all_single(None, x, g))
            want[("all_to_all_single", "01")] = _jax_per_rank(
                lambda x: jcomm.all_to_all_single(None, x, g, split_axis=0,
                                                  concat_axis=1))
            want[("ppermute", "")] = _jax_per_rank(
                lambda x: jcomm.ppermute(x, [(0, 1), (1, 0)], g))
            want[("send", "")] = _jax_per_rank(
                lambda x: jcomm.send(x, 1, 0, g))
            want[("recv", "")] = _jax_per_rank(
                lambda x: jcomm.recv(x, 0, 1, g))
        else:
            for name in ("all_to_all_single", "ppermute"):
                with pytest.raises(ValueError) as je:
                    jcomm.all_to_all_single(None, X[0], g) \
                        if name == "all_to_all_single" \
                        else jcomm.ppermute(X[0], [(0, 1)], g)
                assert all(res[r][(gk, name, "raises")] == str(je.value)
                           for r in range(4))
        for (name, op), w in want.items():
            for r in range(4):
                got = res[r][(gk, name, op)]
                _close(np.asarray(got, np.float32).reshape(w[r].shape),
                       w[r], name, op)
        assert all(res[r][(gk, "world", "")] == jcomm.get_world_size(g)
                   for r in range(4))

    # the eager_* functions: per-rank inputs stacked along the one axis
    # (the other axis replicated)
    for axis, fn, kw, key in (
            ("data", jcomm.eager_all_reduce, {}, ("all_reduce", "SUM")),
            ("fsdp", jcomm.eager_all_reduce, {"op": R.MAX},
             ("all_reduce", "MAX")),
            ("data", jcomm.eager_all_gather, {},
             ("all_gather_into_tensor", 0)),
            ("fsdp", jcomm.eager_reduce_scatter, {},
             ("reduce_scatter_tensor", "SUM0")),
            ("data", jcomm.eager_all_to_all, {}, ("all_to_all_single", "00")),
            ("fsdp", jcomm.eager_broadcast, {"src": 1}, ("broadcast", ""))):
        t = jtopo.get_topology()
        ranks = [r for r in range(4)
                 if all(v == 0 for a, v in _coords(r).items() if a != axis)]
        stacked = np.stack([X[r] for r in ranks])
        out = np.asarray(fn(stacked, group=axis, **kw))
        for i, r in enumerate(ranks):
            # the rank's group-mates share its other coordinates, so the
            # rank's result is the eager result at its index
            got = np.asarray(res[r][(repr(axis),) + key], np.float32)
            _close(got.reshape(out[i].shape), out[i], *key)
        assert t.axis_size(axis) == len(ranks)


def _coords(r):
    return ttopo.MeshTopology.build(world_size=4, data=2, fsdp=2).coords(r)


def test_spine_and_rank_helpers_import_no_jax():
    """The port's distributed modules, and the helpers the tests spawn as
    ranks, import neither JAX nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import deepspeed_tpu_torch.comm\n"
            "import deepspeed_tpu_torch.parallel.sharding\n"
            "import deepspeed_tpu_torch.parallel.zeropp\n"
            "import deepspeed_tpu_torch.utils.comms_logging\n"
            "import torch_ranks, torch_rank_cases\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepspeed_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
