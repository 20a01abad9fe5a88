"""Port parity: the universal checkpoint reader of ``deepspeed_tpu_torch``
(``runtime/checkpointing.py``) on checkpoints the JAX package writes.

- A JAX ZeRO-3 training engine over the conftest's 8 virtual CPU devices
  saves ``TINY_TEST`` with ``save_checkpoint`` (per-shard files,
  ``manifest.json``, ``latest``): ``load_params_for_model`` gives every leaf
  exactly, from the save directory (``latest`` resolved) and from the tag.
- ``_save_tree`` of the ``init(PRNGKey(0))`` weights x4, each leaf sharded
  over the 8 devices: the v2 engine built from the loaded tree gives the JAX
  engine's greedy streams (fp32 pools, int8 and fp8 KV), and the v1 engine
  built with ``config={"checkpoint": ...}`` gives the JAX v1 engine's
  ``generate`` output, both byte for byte.
- A missing shard raises ``IOError``, a model that does not match raises
  ``ValueError`` naming the leaves, a directory without a checkpoint raises
  ``FileNotFoundError`` naming the manifest, and an HF directory still
  raises ``NotImplementedError``; a training engine's load from a directory
  without ``latest`` loads nothing.
"""

import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
import deepspeed_tpu.parallel.topology as topo
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.testing import greedy_generate as j_greedy
from deepspeed_tpu.models import build_model
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.runtime.checkpointing import _save_tree
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.testing import (assert_greedy_parity,
                                                      greedy_generate)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_to_numpy
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
import torch_cpu  # noqa: F401  (one torch thread: see the module)

ENGINE_KW = dict(kv_blocks=48, kv_block_size=16, max_chunk_tokens=16,
                 max_ragged_batch_size=40, max_ragged_sequence_count=4)
KV = {"fp32": {}, "int8": dict(kv_quant_enabled=True),
      "fp8": dict(kv_quant_enabled=True, kv_quant_dtype="fp8_e4m3")}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A JAX ZeRO-3 engine's ``save_checkpoint`` (its params sharded over
    the 8 devices; no step is taken, which would only cost a compile)."""
    topo.reset_topology()
    engine, *_ = deepspeed_tpu.initialize(model=build_model("tiny"), config={
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 1,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
        "zero_optimization": {"stage": 3},
        "mesh": {"data": -1, "fsdp": 2}, "steps_per_print": 10**9})
    save_dir = str(tmp_path_factory.mktemp("trained"))
    tag_dir = engine.save_checkpoint(save_dir)
    params = _flat(jax.tree.map(np.asarray, engine.state.params))
    topo.reset_topology()
    return save_dir, tag_dir, params


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """``_save_tree`` of the x4 weights, each leaf sharded over the 8
    virtual devices along its last dim, with a manifest and ``latest``."""
    jp = jtf.CausalLM(jtf.TINY_TEST).init(jax.random.PRNGKey(0))
    w = jax.tree.map(lambda a: np.asarray(a) * (4 if a.ndim >= 2 else 1), jp)
    mesh = Mesh(np.array(jax.devices()), ("x",))

    def place(a):
        spec = P(*([None] * (a.ndim - 1) + ["x"]))
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

    save_dir = str(tmp_path_factory.mktemp("sharded"))
    tag_dir = os.path.join(save_dir, "serve0")
    index = _save_tree(jax.tree.map(place, w), os.path.join(tag_dir, "params"))
    with open(os.path.join(tag_dir, "manifest.json"), "w") as fh:
        json.dump({"tag": "serve0", "params_index": index}, fh)
    with open(os.path.join(save_dir, "latest"), "w") as fh:
        fh.write("serve0")
    return save_dir, tag_dir, w


def test_trained_checkpoint_loads_leaf_for_leaf(trained):
    save_dir, tag_dir, want = trained
    shards = glob.glob(os.path.join(tag_dir, "params", "*.shard_*.npy"))
    assert shards, "the ZeRO-3 save wrote no shard files"
    model = ttf.CausalLM(ttf.TINY_TEST)
    for where in (save_dir, tag_dir):            # 'latest' and the tag
        got = _flat(params_to_numpy(
            ckpt.load_params_for_model(model, where, device="cpu")))
        assert set(got) == set(want)
        for key, arr in want.items():
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], arr, err_msg=key)


@pytest.mark.parametrize("kv", sorted(KV))
def test_v2_engine_from_checkpoint_matches_jax(sharded, kv):
    save_dir, _, w = sharded
    assert glob.glob(os.path.join(save_dir, "serve0", "params",
                                  "layers.wq.shard_*.npy"))
    model = ttf.CausalLM(ttf.TINY_TEST)
    params = ckpt.load_params_for_model(model, save_dir, device="cpu")
    got_leaves = _flat(params_to_numpy(params))
    for key, arr in _flat(w).items():
        np.testing.assert_array_equal(got_leaves[key], arr, err_msg=key)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 40, 17)]
    eng = InferenceEngineV2(model, params,
                            RaggedInferenceEngineConfig(**ENGINE_KW, **KV[kv]),
                            device="cpu")
    got = greedy_generate(eng, prompts, max_new_tokens=8)
    jeng = JEngine(jtf.CausalLM(jtf.TINY_TEST),
                   jax.tree.map(jnp.asarray, w), JConfig(**ENGINE_KW,
                                                         **KV[kv]))
    ref = j_greedy(jeng, prompts, max_new_tokens=8)
    assert len({tuple(s) for s in ref}) == len(ref)   # not degenerate
    assert_greedy_parity(ref, got, f"checkpoint-loaded engine ({kv} KV)")


def test_v1_engine_from_checkpoint_matches_jax(sharded):
    save_dir, tag_dir, _ = sharded
    params_dir = os.path.join(tag_dir, "params")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, n).tolist() for n in (3, 11, 6)]
    topo.reset_topology()
    je = deepspeed_tpu.init_inference(
        jtf.CausalLM(jtf.TINY_TEST),
        config={"dtype": "fp32", "checkpoint": params_dir})
    ref = np.asarray(je.generate(prompts, max_new_tokens=8))
    # a save directory, a tag directory, and the leaves' own directory
    for where in (save_dir, tag_dir, params_dir):
        te = deepspeed_tpu_torch.init_inference(
            ttf.CausalLM(ttf.TINY_TEST),
            config={"dtype": "fp32", "checkpoint": where}, device="cpu")
        assert te.params["layers"]["wq"].dtype == torch.float32
        np.testing.assert_array_equal(
            te.generate(prompts, max_new_tokens=8).numpy(), ref)


def test_missing_shard_raises_ioerror(sharded, tmp_path):
    save_dir, _, _ = sharded
    broken = str(tmp_path / "broken")
    shutil.copytree(save_dir, broken)
    victim = sorted(glob.glob(os.path.join(broken, "serve0", "params",
                                           "layers.w_in.shard_*.npy")))[3]
    os.remove(victim)
    with pytest.raises(IOError, match="layers.w_in: shard files cover"):
        ckpt.load_params_for_model(ttf.CausalLM(ttf.TINY_TEST), broken,
                                   device="cpu")


def test_model_mismatch_raises(sharded, tmp_path):
    """Leaves the model lacks or has extra: ``ValueError`` naming them. A
    leaf of another shape: ``ValueError`` from a whole file, and the
    coverage ``IOError`` from shard files (they cannot tile it)."""
    import dataclasses

    save_dir, _, w = sharded
    untied = dataclasses.replace(ttf.TINY_TEST, tie_embeddings=False)
    with pytest.raises(ValueError, match="lm_head.w"):
        ckpt.load_params_for_model(ttf.CausalLM(untied), save_dir,
                                   device="cpu")
    wider = ttf.CausalLM(dataclasses.replace(ttf.TINY_TEST, vocab_size=300))
    with pytest.raises(IOError, match="embed.wte: shard files cover"):
        ckpt.load_params_for_model(wider, save_dir, device="cpu")
    whole = str(tmp_path / "whole")
    shutil.copytree(save_dir, whole)
    params = os.path.join(whole, "serve0", "params")
    for f in glob.glob(os.path.join(params, "embed.wte.shard_*.npy")):
        os.remove(f)
    np.save(os.path.join(params, "embed.wte.npy"), w["embed"]["wte"])
    with pytest.raises(ValueError, match="shape mismatch for embed.wte"):
        ckpt.load_params_for_model(wider, whole, device="cpu")


def test_missing_checkpoint_and_unported_paths_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        ckpt.load_params_for_model(ttf.CausalLM(ttf.TINY_TEST),
                                   str(tmp_path), device="cpu")
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text("{}")
    (hf / "model.safetensors").write_bytes(b"")
    # HF directories load (tests/test_torch_convert.py); one whose
    # config.json names no model_type raises the JAX loader's ValueError
    with pytest.raises(ValueError, match="pass model_type="):
        deepspeed_tpu_torch.init_inference(
            "tiny", config={"checkpoint": str(hf)}, device="cpu")
    # saving is ported (tests/test_torch_train_checkpoint.py): an engine's
    # load from a directory without 'latest' loads nothing
    eng = deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(ttf.TINY_TEST), config={"train_batch_size": 2},
        device="cpu")[0]
    assert ckpt.load_checkpoint(eng, str(tmp_path)) == (None, {})


def test_v1_load_checkpoint_matches_config_checkpoint(sharded):
    """``load_checkpoint`` of the JAX-written leaves into a built v1 engine
    gives the logits of an engine built with ``config={"checkpoint":
    ...}`` and the JAX v1 engine's ``load_checkpoint`` output; it returns
    its path. A weight-quantized engine has no dense leaves and refuses."""
    _, tag_dir, _ = sharded
    params_dir = os.path.join(tag_dir, "params")
    toks = np.random.default_rng(2).integers(1, 256, (2, 9))
    te = deepspeed_tpu_torch.init_inference(
        ttf.CausalLM(ttf.TINY_TEST), config={"dtype": "fp32"}, device="cpu")
    before = te.forward(toks)
    assert te.load_checkpoint(params_dir) == params_dir
    assert te.params["layers"]["wq"].dtype == torch.float32
    got = te.forward(toks)
    assert not torch.equal(got, before)
    built = deepspeed_tpu_torch.init_inference(
        ttf.CausalLM(ttf.TINY_TEST),
        config={"dtype": "fp32", "checkpoint": params_dir}, device="cpu")
    assert torch.equal(got, built.forward(toks))
    topo.reset_topology()
    je = deepspeed_tpu.init_inference(jtf.CausalLM(jtf.TINY_TEST),
                                      config={"dtype": "fp32"})
    assert je.load_checkpoint(params_dir) == params_dir
    prompts = [t.tolist() for t in toks]
    np.testing.assert_array_equal(
        te.generate(prompts, max_new_tokens=6).numpy(),
        np.asarray(je.generate(prompts, max_new_tokens=6)))
    quant = deepspeed_tpu_torch.init_inference(
        ttf.CausalLM(ttf.TINY_TEST), config={
            "dtype": "fp32", "quant": {"enabled": True, "bits": 8}},
        device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        quant.load_checkpoint(params_dir)
