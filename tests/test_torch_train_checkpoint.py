"""Port parity: universal checkpoint save and resume of the training
engine (``runtime/checkpointing.py``), ``utils/zero_to_fp32.py`` and
``save_16bit_model``, against the JAX package. Twin of
``tests/test_checkpoint_sharded.py`` and ``test_engine.py``'s round trip.

``TINY_TEST`` on both sides, fp32 unless a case says otherwise. The JAX
engines run on a one-device mesh (one on an ``fsdp = 2`` mesh, which writes
shard files); the port's start from the JAX engine's params through
``model_parameters``, and both loaders draw the same batches. A checkpoint
written by one package resumes in the other and continues the writer's
unbroken loss curve within 1e-5 (the same fp32 program through two BLAS
libraries); a resume inside the port is bit for bit. The file names,
indexes and manifest keys are the JAX package's, and ``save_16bit_model``'s
npz members are byte-equal to the JAX package's in fp32, fp16 and bf16.
"""

import io
import json
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import topology as topo
from deepspeed_tpu.utils import zero_to_fp32 as jz2f
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_to_numpy
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.utils import zero_to_fp32 as tz2f
import torch_cpu  # noqa: F401  (one torch thread: see the module)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3,
                                              "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                 "warmup_max_lr": 1e-3}},
    "steps_per_print": 1000,
}
DATA = {"input_ids": np.random.default_rng(0).integers(
    0, 256, (24, 33)).astype(np.int32)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: beside other test workers the default of a thread
    a core oversubscribes the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(**over):
    return json.loads(json.dumps({**BASE, **over}))


def jax_engine(config=None, devices=1, **mesh):
    topo.reset_topology()
    je, *_ = deepspeed_tpu.initialize(
        model=jtf.CausalLM(jtf.TINY_TEST), config=config or _cfg(),
        training_data=DATA,
        mesh=topo.MeshTopology.build(devices=jax.devices()[:devices],
                                     **mesh))
    return je


_START = {}


def start_params():
    """The JAX engine's initial params (seed 1234) as numpy."""
    if "p" not in _START:
        _START["p"] = jax.tree.map(np.asarray, jax_engine().state.params)
    return _START["p"]


def port_engine(config=None, **kw):
    return deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(ttf.TINY_TEST), config=config or _cfg(),
        training_data=DATA, model_parameters=start_params(), device="cpu",
        **kw)[0]


def dl_state(engine):
    return {"dataloader": engine.training_dataloader.state_dict()}


def resume_loader(engine, cs):
    engine.training_dataloader.load_state_dict(cs["dataloader"])
    engine.reset_data_iterator()


def steps(engine, n):
    return [float(engine.train_batch()) for _ in range(n)]


def port_state(engine):
    """Every tensor of the port's train state that a checkpoint carries."""
    s = engine.state
    return (tree_leaves(s.params) + tree_leaves(s.opt_state.moments)
            + [s.opt_state.step, s.global_step, s.skipped_steps,
               *s.scale_state])


def assert_bits_equal(a, b):
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)


def max_param_diff(jax_params, port_params):
    pj = jax.tree.leaves(jax.tree.map(np.asarray, jax_params))
    pt = jax.tree.leaves(params_to_numpy(port_params))
    return max(float(np.abs(a - b).max()) for a, b in zip(pj, pt, strict=True))


def files_under(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX engine's 4 steps with a save after step 2 (tag "t2", the
    loader's position in client_state): the losses, the final params and
    the save directory."""
    d = str(tmp_path_factory.mktemp("jax_run"))
    je = jax_engine()
    losses = steps(je, 2)
    je.save_checkpoint(d, tag="t2", client_state=dl_state(je))
    losses += steps(je, 2)
    return {"dir": d, "losses": losses, "params": je.state.params}


# ---------------------------------------------------------------- round trip

def test_roundtrip_with_client_state_is_bit_exact(tmp_path):
    a = port_engine()
    unbroken = steps(a, 4)
    b = port_engine()
    first = steps(b, 2)
    path = b.save_checkpoint(str(tmp_path), client_state={
        "note": "x", **dl_state(b)})
    assert path == os.path.join(str(tmp_path), "global_step2")
    assert (tmp_path / "latest").read_text() == "global_step2"
    c = port_engine()
    got_path, cs = c.load_checkpoint(str(tmp_path))
    assert got_path == path and cs["note"] == "x"
    assert_bits_equal(port_state(b), port_state(c))
    assert (c.global_steps, c.micro_steps) == (2, 4)
    assert c.get_lr() == b.get_lr()
    resume_loader(c, cs)
    assert first + steps(c, 2) == unbroken
    assert_bits_equal(tree_leaves(a.state.params), tree_leaves(c.state.params))
    # the masters are still the autograd leaves whose .grad accumulates
    for p, g in zip(tree_leaves(c.state.params), tree_leaves(c.state.grad_acc)):
        assert p.requires_grad and p.grad is g
    assert port_engine().load_checkpoint(str(tmp_path / "empty")) == (None, {})


# ------------------------------------------------------------ cross package

def test_jax_checkpoint_resumes_in_port(jax_run):
    te = port_engine()
    path, cs = te.load_checkpoint(jax_run["dir"])
    assert path == os.path.join(jax_run["dir"], "t2")
    assert te.global_steps == 2 and int(te.state.opt_state.step) == 2
    resume_loader(te, cs)
    np.testing.assert_allclose(steps(te, 2), jax_run["losses"][2:],
                               atol=1e-5, rtol=1e-5)
    assert max_param_diff(jax_run["params"], te.state.params) <= 1e-5


def test_port_checkpoint_resumes_in_jax(tmp_path):
    te = port_engine()
    losses = steps(te, 2)
    te.save_checkpoint(str(tmp_path), client_state=dl_state(te))
    losses += steps(te, 2)
    je = jax_engine()
    path, cs = je.load_checkpoint(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "global_step2")
    assert je.global_steps == 2 and int(je.state.opt_state.step) == 2
    je.training_dataloader.load_state_dict(cs["dataloader"])
    je.reset_data_iterator()
    np.testing.assert_allclose(steps(je, 2), losses[2:], atol=1e-5,
                               rtol=1e-5)
    assert max_param_diff(je.state.params, te.state.params) <= 1e-5


def test_layout_and_manifest_equal_the_jax_package(jax_run, tmp_path):
    te = port_engine()
    steps(te, 2)
    te.save_checkpoint(str(tmp_path), tag="t2", client_state=dl_state(te))
    assert files_under(str(tmp_path)) == files_under(jax_run["dir"])
    with open(os.path.join(jax_run["dir"], "t2", "manifest.json")) as fh:
        jm = json.load(fh)
    tm = json.loads((tmp_path / "t2" / "manifest.json").read_text())
    assert list(tm) == list(jm)
    for key in ("tag", "global_step", "host_global_steps", "skipped_steps",
                "micro_steps", "opt_step", "loss_scale", "good_steps",
                "hysteresis", "lr_scheduler", "client_state", "params_index",
                "opt_index", "format_version"):
        assert tm[key] == jm[key], key
    assert tm["format_version"] == 1
    assert set(tm["config"]) == set(jm["config"])
    for key in jm["params_index"]:
        a = np.load(os.path.join(jax_run["dir"], "t2", "params", key + ".npy"))
        b = np.load(str(tmp_path / "t2" / "params" / (key + ".npy")))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape


def test_jax_fsdp_shards_resume_in_port(tmp_path):
    """Shard files from an fsdp = 2 mesh: the port reassembles every leaf
    and moment bit for bit, and continues as a one-device JAX engine that
    loads the same checkpoint."""
    cfg = _cfg(zero_optimization={"stage": 3})
    js = jax_engine(cfg, devices=2, fsdp=2)
    steps(js, 2)
    js.save_checkpoint(str(tmp_path))
    tag = tmp_path / "global_step2"
    shards = sorted(os.listdir(tag / "params"))
    assert any(".shard_" in f for f in shards)
    assert ckpt._shard_fname("embed.wte", (0, 0)) in shards
    te = port_engine()
    te.load_checkpoint(str(tmp_path))
    want = jax.tree.leaves(jax.tree.map(np.asarray, js.state.params))
    for a, b in zip(want, tree_leaves(te.state.params), strict=True):
        np.testing.assert_array_equal(a, b.detach().numpy())
    jm = jax.tree.leaves(jax.tree.map(np.asarray, js.state.opt_state.moments))
    for a, b in zip(jm, tree_leaves(te.state.opt_state.moments), strict=True):
        np.testing.assert_array_equal(a, b.numpy())
    j1 = jax_engine()
    j1.load_checkpoint(str(tmp_path))
    batches = [{"input_ids": DATA["input_ids"][i:i + 2]} for i in (0, 2)]
    np.testing.assert_allclose(float(te.train_batch(iter(batches))),
                               float(j1.train_batch(iter(batches))),
                               atol=1e-5, rtol=1e-5)
    # zero_to_fp32: the port's module gives the JAX module's arrays
    ours = tz2f.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    theirs = jz2f.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    assert list(ours) == list(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k])


# ------------------------------------------------------------- save safety

def test_async_save_commits_only_after_the_wait(tmp_path):
    te = port_engine()
    steps(te, 2)
    snap = [t.clone() for t in port_state(te)]
    te.save_checkpoint(str(tmp_path), async_save=True)
    assert not (tmp_path / "latest").exists()
    assert not (tmp_path / "global_step2" / "manifest.json").exists()
    steps(te, 2)             # the snapshot was taken before the save returned
    te.wait_pending_checkpoint()
    assert (tmp_path / "latest").read_text() == "global_step2"
    other = port_engine()
    other.load_checkpoint(str(tmp_path))
    assert_bits_equal(snap, port_state(other))


def _exploding(fname, arr, *a, **kw):
    raise IOError(f"disk full writing {fname}")


def test_failed_saves_leave_the_previous_latest(tmp_path, monkeypatch):
    """A sync save that fails mid-write raises and leaves 'latest' at the
    previous tag; a failed async save raises at the wait and never
    commits, not even through a later save's join."""
    te = port_engine()
    steps(te, 2)
    te.save_checkpoint(str(tmp_path), tag="good")
    snap = [t.clone() for t in tree_leaves(te.state.params)]
    real_save = np.save
    monkeypatch.setattr(np, "save", _exploding)
    steps(te, 1)
    with pytest.raises(IOError):
        te.save_checkpoint(str(tmp_path), tag="torn")
    te.save_checkpoint(str(tmp_path), tag="torn_async", async_save=True)
    with pytest.raises(IOError):
        te.wait_pending_checkpoint()
    monkeypatch.setattr(np, "save", real_save)
    assert (tmp_path / "latest").read_text().strip() == "good"
    assert not list(tmp_path.glob("latest.tmp*"))
    assert not (tmp_path / "torn_async" / "manifest.json").exists()
    other = port_engine()
    other.load_checkpoint(str(tmp_path))
    assert_bits_equal(snap, tree_leaves(other.state.params))
    te.save_checkpoint(str(tmp_path), tag="good2")
    assert (tmp_path / "latest").read_text().strip() == "good2"


def test_checkpoint_writer_surfaces_ioerror_on_finalize():
    w = ckpt.CheckpointWriter()
    w.submit("/nonexistent-dir-xyz/leaf.npy", np.zeros(3))
    with pytest.raises(IOError, match="checkpoint writes failed"):
        w.finalize()
    assert not w._thread.is_alive()
    w2 = ckpt.CheckpointWriter()
    w2.finalize()
    assert not w2._thread.is_alive()


@pytest.mark.parametrize("async_fails", [False, True])
def test_urgent_save_joins_an_async_save(tmp_path, monkeypatch, async_fails):
    """The urgent save joins an in-flight async save and commits its own
    tag as 'latest', and survives that save's failure (whose tag then
    never commits)."""
    te = port_engine()
    steps(te, 2)
    if async_fails:
        real_save = np.save

        def torn_only(fname, arr, *a, **kw):
            if "async_tag" in str(fname):
                raise IOError(f"injected write failure: {fname}")
            return real_save(fname, arr, *a, **kw)

        monkeypatch.setattr(np, "save", torn_only)
    te.save_checkpoint(str(tmp_path), tag="async_tag", async_save=True)
    te.save_checkpoint(str(tmp_path), tag="urgent_tag", urgent=True)
    assert te.last_urgent_save_s > 0
    assert (tmp_path / "latest").read_text().strip() == "urgent_tag"
    assert (tmp_path / "async_tag" / "manifest.json").exists() \
        != async_fails
    other = port_engine()
    other.load_checkpoint(str(tmp_path))
    assert_bits_equal(port_state(te), port_state(other))


# --------------------------------------------------------- partial loads

@pytest.mark.parametrize("how", ["no_optimizer_states", "module_only"])
def test_partial_loads_take_params_only(tmp_path, how):
    src = port_engine()
    steps(src, 3)
    src.save_checkpoint(str(tmp_path))
    dst = port_engine()
    steps(dst, 1)
    keep = [t.clone() for t in port_state(dst)[len(tree_leaves(
        dst.state.params)):]]
    kw = ({"load_optimizer_states": False} if how == "no_optimizer_states"
          else {"load_module_only": True})
    dst.load_checkpoint(str(tmp_path), **kw)
    assert_bits_equal(tree_leaves(src.state.params),
                      tree_leaves(dst.state.params))
    assert_bits_equal(keep, port_state(dst)[len(tree_leaves(
        dst.state.params)):])
    assert dst.global_steps == 1 and dst.micro_steps == 2


def test_load_refuses_another_model_before_changing_anything(tmp_path):
    src = port_engine()
    src.save_checkpoint(str(tmp_path))
    wide = deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(ttf.TransformerConfig(
            **{**ttf.TINY_TEST.__dict__, "vocab_size": 300})),
        config=_cfg(), device="cpu")[0]
    before = [t.clone() for t in tree_leaves(wide.state.params)]
    with pytest.raises(ValueError, match="shape mismatch for embed.wte"):
        wide.load_checkpoint(str(tmp_path))
    assert_bits_equal(before, tree_leaves(wide.state.params))


def test_fp16_scale_state_and_warmup_lr_continue(tmp_path):
    """The loss-scale state and the warm-up lr resume where they were: no
    reset to the initial scale, no re-warm-up."""
    cfg = _cfg(gradient_accumulation_steps=1,
               fp16={"enabled": True, "initial_scale_power": 8,
                     "loss_scale_window": 4},
               scheduler={"type": "WarmupLR", "params": {
                   "warmup_num_steps": 20, "warmup_max_lr": 1e-3}})
    a = port_engine(cfg)
    steps(a, 6)
    a.save_checkpoint(str(tmp_path), client_state=dl_state(a))
    b = port_engine(cfg)
    _, cs = b.load_checkpoint(str(tmp_path))
    resume_loader(b, cs)
    want = [float(a.state.scale_state.scale),
            int(a.state.scale_state.good_steps),
            int(a.state.scale_state.hysteresis)]
    assert want[0] != 2.0 ** 8 or want[1] != 0
    assert want == [float(b.state.scale_state.scale),
                    int(b.state.scale_state.good_steps),
                    int(b.state.scale_state.hysteresis)]
    assert b.get_lr() == a.get_lr() and b.get_lr()[0] < 1e-3
    assert steps(a, 2) == steps(b, 2)
    assert a.loss_scale == b.loss_scale and a.get_lr() == b.get_lr()


# -------------------------------------------------------- offline readers

def test_zero_to_fp32_cli_reads_a_port_checkpoint(tmp_path):
    te = port_engine()
    steps(te, 1)
    te.save_checkpoint(str(tmp_path))
    state = tz2f.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    assert state.keys() == jz2f.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path)).keys()
    flat = dict(ckpt._flatten(te.state.params))
    assert list(state) == list(flat)
    for k, t in flat.items():
        np.testing.assert_array_equal(state[k], t.detach().numpy())
    out = tmp_path / "consolidated.npz"
    r = subprocess.run([sys.executable, "-m",
                        "deepspeed_tpu_torch.utils.zero_to_fp32",
                        str(tmp_path), str(out)],
                       capture_output=True, text=True, cwd=_REPO)
    assert r.returncode == 0, r.stderr
    with np.load(out) as z:
        for k, t in flat.items():
            np.testing.assert_array_equal(z[k], t.detach().numpy())


@pytest.mark.parametrize("precision", ["fp32", "fp16", "bf16"])
def test_save_16bit_model_members_equal_the_jax_package(tmp_path, precision):
    over = {} if precision == "fp32" else {precision: {"enabled": True}}
    je = jax_engine(_cfg(**over))
    te = port_engine(_cfg(**over))
    jp = je.save_16bit_model(str(tmp_path / "jax"))
    tp = te.save_16bit_model(str(tmp_path / "port"))
    assert os.path.basename(tp) == "pytorch_model.bin"
    with zipfile.ZipFile(jp) as zj, zipfile.ZipFile(tp) as zt:
        assert zt.namelist() == zj.namelist()
        for name in zj.namelist():
            assert zt.read(name) == zj.read(name), name
        if precision == "bf16":
            member = zt.read(zt.namelist()[0])
            assert b"'descr': '<V2'" in member
            arr = np.load(io.BytesIO(member))
            leaf = tree_leaves(te.state.params)[0]
            bits = leaf.detach().to(torch.bfloat16).view(torch.int16).numpy()
            assert arr.tobytes() == bits.tobytes()


def test_save_mp_checkpoint_path_is_refused_as_a_divergence():
    """The JAX package declares ``save_mp_checkpoint_path`` and writes
    nothing there; the port refuses the key rather than drop a requested
    save (ROADMAP.md queue 3)."""
    from deepspeed_tpu.inference.config import InferenceConfig as JInfConfig

    assert JInfConfig(save_mp_checkpoint_path="/x").save_mp_checkpoint_path \
        == "/x"
    with pytest.raises(NotImplementedError,
                       match="JAX package declares this key") as e:
        deepspeed_tpu_torch.init_inference(
            "tiny", config={"save_mp_checkpoint_path": "/x"}, device="cpu")
    assert "item 13" not in str(e.value)
