"""Port parity: the host optimizers of ZeRO-Offload (``ops/cpu_adam.py``
over ``csrc/cpu_adam.cpp``) against the JAX package's, on the CPU.

The port's C++ source is the JAX package's byte for byte and is built with
the same flags, so every update must be bit-identical on the same seeded
inputs (odd sizes, so that the vector loops' tails run). The numpy fallback
runs the same formulas with its constants in float64 (``1 - beta2`` is
0.001 there, ``1.0f - 0.999f`` = 0.00099998713 in the C code): it agrees
to 2e-5 relative, 1e-7 absolute, the second moment's gap. The builder puts
its flags into the library's digest, raises with g++'s output when a build
fails, and falls back only when g++ is absent.
"""

import subprocess

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import cpu_adam as jcpu
from deepspeed_tpu_torch.ops import cpu_adam as tcpu
from deepspeed_tpu_torch.ops import op_builder
import torch_cpu  # noqa: F401  (one torch thread: see the module)

# (optimizer, constructor keywords, size): each keyword variant meets two
# sizes across the cases, and every optimizer an odd size
CASES = {
    "adamw-1023": ("DeepSpeedCPUAdam", dict(lr=1e-2, weight_decay=0.1,
                                            adamw_mode=True), 1023),
    "adam-l2-4099": ("DeepSpeedCPUAdam", dict(lr=1e-3, weight_decay=0.05,
                                              adamw_mode=False), 4099),
    "adam-nobias-17": ("DeepSpeedCPUAdam", dict(lr=3e-3, betas=(0.8, 0.95),
                                                bias_correction=False), 17),
    "adagrad-1023": ("DeepSpeedCPUAdagrad", dict(lr=1e-2, weight_decay=0.01),
                     1023),
    "lion-4099": ("DeepSpeedCPULion", dict(lr=1e-3, weight_decay=0.1), 4099),
    "lion-1": ("DeepSpeedCPULion", dict(lr=1e-4), 1),
}


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32),
            [rng.normal(size=n).astype(np.float32) for _ in range(4)])


def _run(opt, p, grads, as_torch=False):
    params = torch.tensor(p) if as_torch else p.copy()
    state = opt.init_state(params)
    if as_torch:
        state = {k: torch.from_numpy(v) for k, v in state.items()}
    for g in grads:
        opt.step(params, torch.from_numpy(g) if as_torch else g, state)
    out = params.numpy() if as_torch else params
    return out, {k: np.asarray(v) for k, v in state.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_host_optimizer_bit_identical_to_jax(name):
    cls, kw, n = CASES[name]
    p, grads = _inputs(n, seed=len(name))
    ref = getattr(jcpu, cls)(**kw)
    port = getattr(tcpu, cls)(**kw)
    assert port.has_native and ref._lib is not None
    want_p, want_s = _run(ref, p, grads)
    # numpy arrays, and CPU torch tensors read through their memory
    for as_torch in (False, True):
        got_p, got_s = _run(port, p, grads, as_torch=as_torch)
        np.testing.assert_array_equal(got_p, want_p)
        assert got_s.keys() == want_s.keys()
        for k in want_s:
            np.testing.assert_array_equal(got_s[k], want_s[k])
    # the plain fallback: the same formulas in numpy
    port._lib = None
    assert not port.has_native
    fb_p, fb_s = _run(port, p, grads)
    np.testing.assert_allclose(fb_p, want_p, rtol=2e-5, atol=1e-7)
    for k in want_s:
        np.testing.assert_allclose(fb_s[k], want_s[k], rtol=2e-5, atol=1e-7)


def test_host_optimizer_refuses_what_it_cannot_walk():
    opt = tcpu.DeepSpeedCPUAdam()
    p = np.zeros(8, np.float32)
    state = opt.init_state(p)
    with pytest.raises(ValueError, match="float32"):
        opt.step(p, np.zeros(8, np.float64), state)
    with pytest.raises(ValueError, match="contiguous"):
        opt.step(np.zeros(16, np.float32)[::2], np.zeros(8, np.float32),
                 state)
    with pytest.raises(ValueError, match="host"):
        opt.step(torch.zeros(8, device="meta"), np.zeros(8, np.float32),
                 state)


def test_builder_digest_flags_failure_and_absent_compiler(tmp_path,
                                                          monkeypatch):
    b = op_builder.CPUAdamBuilder()
    assert "-march=native" in b.extra_flags and "-fopenmp" in b.extra_flags
    path = b.so_path()
    assert path.parent == op_builder.BUILD_DIR
    assert path.name.startswith("cpu_adam-")
    monkeypatch.setattr(op_builder.CPUAdamBuilder, "extra_flags",
                        ("-march=native",))
    assert b.so_path() != path                  # a flag change rebuilds
    monkeypatch.undo()
    # a failed build raises with g++'s output, never a silent retry
    (tmp_path / "cpu_adam.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(op_builder, "CSRC", tmp_path)
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ build of cpu_adam "
                       "failed(.|\n)*error"):
        b.build()
    assert not list((tmp_path / "out").glob("*.so"))
    # no g++: the numpy fallback, and has_native says so
    monkeypatch.setattr(op_builder.OpBuilder, "_lib_cache", {})
    monkeypatch.setattr(op_builder.OpBuilder, "compiler", lambda self: None)
    assert not tcpu.DeepSpeedCPUAdam().has_native


def test_cpu_adam_library_carries_openmp():
    """The built library is linked against OpenMP (the ``parallel for``
    over host cores is compiled in, not dropped)."""
    so = op_builder.CPUAdamBuilder().build()
    out = subprocess.run(["ldd", str(so)], capture_output=True, text=True)
    assert "gomp" in out.stdout, out.stdout
