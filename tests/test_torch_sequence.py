"""Port parity: sequence parallelism (Ulysses all-to-all attention and ring
attention) of ``deepspeed_tpu_torch`` over 4 gloo ranks, against the JAX
package on a mesh of CPU devices (the twin of ``tests/test_sequence.py``).

One module-scoped 4-rank world of its own (``torch_ranks.RankPool``). The
JAX references run in this process on the conftest's 8 host devices. Inputs
are numpy draws from fixed seeds; weights cross from the JAX
``CausalLM.init`` as ``.npz`` files. Models are ``TINY_TEST`` with
``num_kv_heads=4`` in fp32. Tolerances are ``test_sequence.py``'s own:
outputs 2e-5, gradients rtol 2e-4 / atol 2e-5, losses rtol 1e-4 (the
engine's losses 1e-5, as ``test_torch_zero.py``'s fp32 engines).

- ring attention against the dense reference (as the JAX ring is held),
  with GQA, windows 5 and 12 (blocks wholly outside the band skipped) and
  the gradients of q, k and v against ``jax.grad`` (window 0 and 6);
- Ulysses ``DistributedAttention`` against dense, in two all-to-alls;
- ``CausalLM.loss`` over sequence = 2 and 4, ring and Ulysses (flash impl),
  windowed too, equal to the one-device JAX loss (and ring at 4 and
  Ulysses at 2 to the JAX loss on the same mesh); the gradients summed
  over the sequence ranks equal ``jax.grad``;
- the engine's losses over 3 steps at (data 2, sequence 2), ZeRO 2, ring
  and Ulysses, equal to the JAX engine's on that mesh, with its param
  blocks;
- the refusals kept from the JAX package (ALiBi, sparse, ring with
  ``attn_scale``) with its messages.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.sequence.layer import DistributedAttention as JDist

import torch_seq_pipe_cases as cases
from torch_ranks import RankPool
import torch_cpu  # noqa: F401  (one torch thread: see the module)

CFG = dataclasses.replace(jtf.TINY_TEST, num_kv_heads=4)
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4) as p:
        yield p


def _mesh(**axes):
    jtopo.reset_topology()
    n = int(np.prod(list(axes.values())))
    t = jtopo.MeshTopology.build(devices=jax.devices()[:n], **axes)
    jtopo.set_topology(t)
    return t


def _qkv(B=2, T=32, H=4, D=16, KH=None, seed=0):
    rng = np.random.default_rng(seed)
    KH = KH or H
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, T, H, D), (B, T, KH, D), (B, T, KH, D)))


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        key = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], key + "."))
        else:
            out[key] = np.asarray(tree[k])
    return out


# ------------------------------------------------------- ring attention

# name: (sp, qkv kwargs, window, grads)
RING = {"dense-sp4": (4, {"T": 32}, 0, False),
        "gqa-sp2": (2, {"T": 16, "H": 8, "KH": 2}, 0, False),
        "window5-sp4": (4, {"T": 32}, 5, False),
        "window12-sp4": (4, {"T": 32}, 12, False),
        "grads-sp2": (2, {"T": 16}, 0, True),
        "window6-grads-sp2": (2, {"T": 16}, 6, True)}


@pytest.fixture(scope="module")
def ring(pool):
    args = [(name, sp, *_qkv(**kw), w, g)
            for name, (sp, kw, w, g) in RING.items()]
    return pool.run(cases.ring_cases, args)


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_dense_and_jax(name, ring):
    sp, kw, window, grads = RING[name]
    q, k, v = map(jnp.asarray, _qkv(**kw))
    ref = jtf.attention_reference(q, k, v, causal=True, window=window)
    for r, res in enumerate(ring):
        np.testing.assert_allclose(res[name]["out"], np.asarray(ref),
                                   **OUT_TOL, err_msg=f"rank {r}")
    if grads:
        g_ref = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
            jtf.attention_reference(q, k, v, causal=True, window=window)),
            argnums=(0, 1, 2)))(q, k, v)
        for i, n in enumerate(("dq", "dk", "dv")):
            for res in ring:
                np.testing.assert_allclose(res[name][n], np.asarray(g_ref[i]),
                                           **GRAD_TOL, err_msg=n)


def test_distributed_attention_ulysses_matches_dense(pool):
    q, k, v = _qkv(T=32, H=4)
    res = pool.run(cases.ulysses_case, q, k, v)
    ref = jtf.attention_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    _mesh(sequence=4, data=1)
    jout = jax.jit(JDist(lambda q, k, v: jtf.attention_reference(
        q, k, v, causal=True)))(*map(jnp.asarray, (q, k, v)))
    for r in res:
        np.testing.assert_allclose(r["out"], np.asarray(ref), **OUT_TOL)
        np.testing.assert_allclose(r["out"], np.asarray(jout), **OUT_TOL)
        assert r["a2a"] == 2       # q, k and v in one; the output in one


# ------------------------------------------------------------ the model

@pytest.fixture(scope="module")
def model_inputs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("seq_model"))
    params = jtf.CausalLM(CFG).init(jax.random.PRNGKey(0))
    path = os.path.join(tmp, "params.npz")
    np.savez(path, **_flat(jax.tree.map(np.asarray, params)))
    batch = np.random.default_rng(0).integers(
        0, CFG.vocab_size, size=(4, 33)).astype(np.int64)
    _INPUTS["model"] = (params, path, batch)
    return params, path, batch


# name: (sp, overrides): ring and Ulysses (the flash impl) at sequence 2
# and 4, and a sliding-window model on each path
LOSS = {"ring-sp2": (2, {"attention_impl": "ring"}),
        "ring-sp4": (4, {"attention_impl": "ring"}),
        "flash-sp2": (2, {"attention_impl": "flash"}),
        "flash-sp4": (4, {"attention_impl": "flash"}),
        "ring-window8-sp4": (4, {"attention_impl": "ring",
                                 "sliding_window": 8}),
        "flash-window8-sp2": (2, {"attention_impl": "flash",
                                  "sliding_window": 8})}


@pytest.fixture(scope="module")
def seq_losses(pool, model_inputs):
    _, path, batch = model_inputs
    return pool.run(cases.seq_loss_cases, path, batch,
                    [(n, sp, dict(over, num_kv_heads=4))
                     for n, (sp, over) in LOSS.items()])


_DENSE = {}


def _dense_loss_and_grads(window, model_inputs=None):
    """``jax.value_and_grad`` of the one-device loss (the plain attention:
    on one device every impl is the same function), once a window."""
    if window not in _DENSE:
        params, _, batch = _INPUTS["model"]
        model = jtf.CausalLM(dataclasses.replace(
            CFG, attention_impl="reference", sliding_window=window))
        _mesh(data=1)
        _DENSE[window] = jax.jit(jax.value_and_grad(model.loss))(
            params, {"input_ids": jnp.asarray(batch)})
    return _DENSE[window]


_INPUTS = {}


@pytest.mark.parametrize("name", list(LOSS))
def test_seq_parallel_loss_and_grads_match_jax(name, seq_losses,
                                               model_inputs):
    """The port's loss on every rank equals the one-device JAX loss (and
    the JAX loss on the same mesh where it is computed); the gradients
    summed over the sequence ranks equal ``jax.grad`` of the one-device
    loss."""
    sp, over = LOSS[name]
    params, _, batch = model_inputs
    model = jtf.CausalLM(dataclasses.replace(CFG, **over))
    jb = {"input_ids": jnp.asarray(batch)}
    dense, grads = _dense_loss_and_grads(over.get("sliding_window"))
    on_mesh = None
    if name in ("ring-sp4", "flash-sp2"):
        # the JAX loss on the mesh (ring at 4 is the JAX test's own case);
        # the others hold to the one-device loss, as the JAX tests do
        _mesh(sequence=sp, data=4 // sp)
        on_mesh = float(jax.jit(model.loss)(params, jb))
        jtopo.reset_topology()
        np.testing.assert_allclose(on_mesh, float(dense), rtol=1e-4)
    want = _flat(jax.tree.map(np.asarray, grads))
    for r, res in enumerate(seq_losses):
        got = res[name]
        if on_mesh is not None:
            np.testing.assert_allclose(got["loss"], on_mesh, rtol=1e-4,
                                       err_msg=f"rank {r}")
        np.testing.assert_allclose(got["loss"], float(dense), rtol=1e-4)
        assert set(got["grads"]) == set(want)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want[k], **GRAD_TOL,
                                       err_msg=f"rank {r} {k}")


def test_refusals_keep_the_jax_messages(pool, model_inputs):
    """ALiBi, sparse and ring with ``attn_scale`` under a sequence axis
    raise ``NotImplementedError`` with the JAX package's messages."""
    params, path, _ = model_inputs
    got = pool.run(cases.seq_refusals, path)
    tokens = jnp.zeros((2, 8), jnp.int32)
    _mesh(sequence=2, data=2)
    want = {}
    for name, over in (("alibi", {"position": "alibi"}),
                       ("sparse", {"attention_impl": "sparse"}),
                       ("ring-scale", {"attention_impl": "ring",
                                       "attn_scale": 0.5})):
        model = jtf.CausalLM(dataclasses.replace(CFG, **over))
        # traced abstractly: the JAX refusals are raised while tracing
        with pytest.raises(NotImplementedError) as e:
            jax.eval_shape(lambda p: model.apply(p, tokens), params)
        want[name] = str(e.value)
    jtopo.reset_topology()
    for r in got:
        assert r == want


# ------------------------------------------------------------ the engine

ENGINE = {"train_micro_batch_size_per_gpu": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 2e-3,
                                                    "weight_decay": 0.01}},
          "zero_optimization": {"stage": 2}, "gradient_clipping": 0.05,
          "steps_per_print": 1000}


@pytest.fixture(scope="module")
def jax_seq_engine(tmp_path_factory):
    """The JAX engine's three steps over (data 2, sequence 2) at ZeRO 2,
    its attention the plain one under the Ulysses all-to-alls (one
    program for both of the port's impls: in fp32 ring, Ulysses over the
    kernels' plain versions and the plain attention are one function)."""
    tmp = str(tmp_path_factory.mktemp("seq_engine"))
    mesh = _mesh(data=2, sequence=2)
    je, *_ = deepspeed_tpu.initialize(
        model=jtf.CausalLM(dataclasses.replace(CFG,
                                               attention_impl="reference")),
        config=ENGINE, mesh=mesh)
    params = os.path.join(tmp, "params.npz")
    np.savez(params, **_flat(jax.tree.map(np.asarray, je.state.params)))
    # one global batch three times, as the JAX test trains: the loss falls
    batches = np.repeat(np.random.default_rng(1).integers(
        0, CFG.vocab_size, (1, 4, 17)).astype(np.int32), 3, axis=0)
    bpath = os.path.join(tmp, "batches.npy")
    np.save(bpath, batches)
    jl = [float(je.train_batch(iter([{"input_ids": b}]))) for b in batches]
    jp = _flat(jax.tree.map(np.asarray, je.state.params))
    jtopo.reset_topology()
    return params, bpath, jl, jp


@pytest.mark.parametrize("impl", ["ring", "flash"])
def test_engine_matches_jax_engine_on_sequence_mesh(impl, pool,
                                                     jax_seq_engine):
    """Three steps over (data 2, sequence 2) at ZeRO 2: every rank's losses
    equal the JAX engine's on the same mesh, and so do its param blocks
    (a sequence rank holds the whole leaves, as a JAX device does)."""
    params, bpath, jl, jp = jax_seq_engine
    cfg = dict(ENGINE, _model={"num_kv_heads": 4, "attention_impl": impl})
    res = pool.run(cases.engine_run, json.dumps(cfg),
                   {"data": 2, "sequence": 2}, params, bpath, 3)
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["losses"], jl, rtol=1e-5,
                                   err_msg=f"rank {r}")
        for k, v in out["params"].items():
            np.testing.assert_allclose(v, jp[k], rtol=0, atol=1e-4,
                                       err_msg=f"rank {r} {k}")
    assert jl[-1] < jl[0]
