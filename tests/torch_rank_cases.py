"""Rank-side cases of the port's multi-rank tests (run through
``torch_ranks.RankPool``). Each function runs in every rank of a gloo
world, takes plain arguments and returns plain values (numpy arrays, dicts,
floats); none imports JAX."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

GROUPS = (None, "data", "fsdp", ("fsdp", "data"))
REDUCE_OPS = ("SUM", "MAX", "MIN", "AVG", "PRODUCT")


def _set_mesh(data, fsdp):
    from deepspeed_tpu_torch.parallel import topology as topo

    topo.set_topology(topo.MeshTopology.build(data=data, fsdp=fsdp))


def comm_cases(x_all):
    """Every collective over every group of a (data 2, fsdp 2) mesh on
    rank r's input ``x_all[r]``: {(group, op, variant): numpy result}."""
    import torch

    from deepspeed_tpu_torch import comm

    _set_mesh(2, 2)
    r = comm.get_rank()
    x = torch.from_numpy(np.ascontiguousarray(x_all[r]))
    out = {}
    for g in GROUPS:
        gk = repr(g)
        for op in REDUCE_OPS:
            out[(gk, "all_reduce", op)] = comm.all_reduce(
                x.clone(), comm.ReduceOp[op], g).numpy()
        out[(gk, "inference_all_reduce", "")] = comm.inference_all_reduce(
            x.clone(), group=g).numpy()
        for axis in (0, 1):
            out[(gk, "all_gather_into_tensor", axis)] = \
                comm.all_gather_into_tensor(None, x, g, axis=axis).numpy()
            for op in ("SUM", "AVG"):
                out[(gk, "reduce_scatter_tensor", f"{op}{axis}")] = \
                    comm.reduce_scatter_tensor(None, x, comm.ReduceOp[op], g,
                                               scatter_dim=axis).numpy()
        out[(gk, "all_gather", "")] = comm.all_gather(None, x, g).numpy()
        out[(gk, "broadcast", "")] = comm.broadcast(x.clone(), 1, g).numpy()
        out[(gk, "reduce", "")] = comm.reduce(x, 1, comm.ReduceOp.SUM,
                                              g).numpy()
        out[(gk, "axis_index", "")] = comm.axis_index(g)
        out[(gk, "world", "")] = comm.get_world_size(g)
        comm.barrier(g)
        if isinstance(g, str):
            out[(gk, "all_to_all_single", "00")] = comm.all_to_all_single(
                None, x, g).numpy()
            out[(gk, "all_to_all_single", "01")] = comm.all_to_all_single(
                None, x, g, split_axis=0, concat_axis=1).numpy()
            out[(gk, "ppermute", "")] = comm.ppermute(
                x, [(0, 1), (1, 0)], g).numpy()
            out[(gk, "send", "")] = comm.send(x, 1, 0, g).numpy()
            out[(gk, "recv", "")] = comm.recv(x, 0, 1, g).numpy()
        else:
            for name, call in (
                    ("all_to_all_single",
                     lambda: comm.all_to_all_single(None, x, g)),
                    ("ppermute", lambda: comm.ppermute(x, [(0, 1)], g))):
                try:
                    call()
                    out[(gk, name, "raises")] = ""
                except ValueError as e:
                    out[(gk, name, "raises")] = str(e)
    return out


# ------------------------------------------------------------ the engine

def _tree(npz_path):
    """A nested param tree from an ``.npz`` of dotted keys."""
    tree = {}
    with np.load(npz_path) as z:
        for key in z.files:
            node = tree
            parts = key.split(".")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = z[key]
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v.detach().cpu().numpy().copy()
    return out


def _rank_batches(batches, dp_rank, dp):
    """The rows of each global micro batch of data-parallel index
    ``dp_rank``: the rows the JAX engine's batch sharding gives its
    devices (tensor peers share them)."""
    mb = batches.shape[1] // dp
    return batches[:, dp_rank * mb:(dp_rank + 1) * mb]


def _engine(cfg_json, mesh, params_path):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as ttf

    cfg = json.loads(cfg_json)
    model = ttf.CausalLM(dataclasses.replace(
        getattr(ttf, cfg.pop("_model", "TINY_TEST")), **cfg.pop("_moe", {})))
    kw = {} if mesh is None else {"mesh": dict(mesh)}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, model_parameters=_tree(params_path),
        device="cpu", **kw)
    return engine


def _train(engine, batches, steps, first=0):
    gas = engine.gradient_accumulation_steps()
    mine = _rank_batches(batches, engine.dp_rank, engine.dp_world_size)
    losses = []
    for s in range(first, first + steps):
        it = iter({"input_ids": mine[s * gas + i]} for i in range(gas))
        losses.append(float(engine.train_batch(it)))
    return losses


def zero_run(cfg_json, mesh, params_path, batches_path, steps,
             save_dir=None, save_after=None, load_dir=None, first=0):
    """Build the port engine on ``mesh`` from the params in
    ``params_path``, optionally load ``load_dir``, train ``steps`` global
    steps on the batches of ``batches_path`` from step ``first`` (saving to
    ``save_dir`` after ``save_after`` of them, counting the all-gathers the
    save makes), and return the losses, the rank's param and moment blocks
    and the gather transforms' counters."""
    from deepspeed_tpu_torch import comm

    engine = _engine(cfg_json, mesh, params_path)
    batches = np.load(batches_path)
    if load_dir is not None:
        engine.load_checkpoint(load_dir)
    losses = []
    save_gathers = None
    if save_after is not None:
        losses += _train(engine, batches, save_after, first)
        gathers = []
        real = comm.all_gather_into_tensor

        def counting(*a, **kw):
            gathers.append(1)
            return real(*a, **kw)

        comm.all_gather_into_tensor = counting
        try:
            engine.save_checkpoint(save_dir, tag="ckpt")
        finally:
            comm.all_gather_into_tensor = real
        save_gathers = len(gathers)
        first += save_after
        steps -= save_after
    losses += _train(engine, batches, steps, first)
    return {
        "losses": losses,
        "params": _flat(engine.state.params),
        "moments": _flat(engine.state.opt_state.moments),
        "gathers": [(t.gathers, t.regathers)
                    for t in engine._gather_transforms],
        "save_gathers": save_gathers,
        "files": sorted(os.listdir(os.path.join(save_dir, "ckpt", "params")))
        if save_dir else None,
    }


def refusals():
    """What a 4-rank (data 1, fsdp 4) world still refuses: ZeRO-Offload and
    LAMB over sharded moments; the messages."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as ttf

    out = {}
    for name, block in (
            ("offload", {"zero_optimization": {
                "stage": 2, "offload_optimizer": {"device": "cpu"}}}),
            ("lamb", {"zero_optimization": {"stage": 1},
                      "optimizer": {"type": "Lamb", "params": {}}})):
        try:
            deepspeed_tpu_torch.initialize(
                model=ttf.CausalLM(ttf.TINY_TEST), device="cpu",
                config={"train_micro_batch_size_per_gpu": 1, **block},
                mesh={"data": 1, "fsdp": 4})
            out[name] = ""
        except NotImplementedError as e:
            out[name] = str(e)
    return out


# ------------------------------------------------- tensor parallelism

def _raw(t):
    """A tensor's values as numpy (float8 as its bytes: the ranks have no
    numpy float8 type to return)."""
    import torch

    t = t.detach().contiguous()
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _tiny(**overrides):
    import dataclasses

    from deepspeed_tpu_torch.models import transformer as ttf

    return ttf.CausalLM(dataclasses.replace(ttf.TINY_TEST, **overrides))


def tp_v2_run(params_path, overrides, config_kw, prompts, decode_tokens,
              mesh=None):
    """The v2 engine over ``mesh`` (default tensor 2) on the params of
    ``params_path``: each prompt prefilled alone, then a put of every
    sequence a decode step; the logits of every put, the rank's quantized
    blocks, and the export of the first sequence, imported again under a
    new uid and held to the original by one more put."""
    import torch

    from deepspeed_tpu_torch.inference.v2.engine_v2 import (
        InferenceEngineV2, RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models.weights import params_from_numpy

    engine = InferenceEngineV2(
        _tiny(**overrides), params=params_from_numpy(_tree(params_path),
                                                     "cpu"),
        config=RaggedInferenceEngineConfig(**config_kw),
        mesh=mesh or {"tensor": 2}, device="cpu")
    out = {"prefill": [], "decode": [], "quant": {},
           "pool": tuple(engine.state_manager.kv_cache["k"].shape)}
    uids = list(prompts)
    with torch.no_grad():
        for uid in uids:
            out["prefill"].append(engine.put([uid], [prompts[uid]]).numpy())
        for step in decode_tokens:
            out["decode"].append(engine.put(uids, step).numpy())
        for name, node in engine.params["layers"].items():
            if isinstance(node, dict):
                out["quant"][name] = (_raw(node["qw"]), _raw(node["qs"]))
        payload = engine.export_sequence(uids[0])
        out["payload"] = {k: _raw(v) for k, v in payload["slabs"].items()}
        ctx = list(prompts[uids[0]]) + [s[0][0] for s in decode_tokens]
        engine.import_sequence(999, payload, ctx)
        nxt = [decode_tokens[-1][0]]
        a = engine.put([uids[0]], nxt).numpy()
        b = engine.put([999], nxt).numpy()
    out["import_equal"] = bool(np.array_equal(a, b))
    return out


def tp_v2_refusals():
    """What a tensor-parallel v2 engine refuses: the KV tier and a draft
    model, each naming item 14b-ii; a mesh of another type; MoE serving
    over a tensor or an expert axis (v2 and v1), naming 14d-ii."""
    import torch

    from deepspeed_tpu_torch.inference.v2.engine_v2 import (
        InferenceEngineV2, RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.scheduler import \
        ContinuousBatchingScheduler
    from deepspeed_tpu_torch.inference.v2.spec import DraftModelProposer

    import deepspeed_tpu_torch

    out = {}
    model = _tiny()
    moe = _tiny(moe_num_experts=2)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")

    def engine(**kw):
        return InferenceEngineV2(
            model, params=params, mesh={"tensor": 2}, device="cpu",
            config=RaggedInferenceEngineConfig(kv_blocks=16, **kw))

    calls = {
        "tier": lambda: engine(enable_prefix_cache=True,
                               kv_tier_enabled=True),
        "tier-later": lambda: engine(enable_prefix_cache=True)
        .configure_kv_tier(True),
        "draft": lambda: DraftModelProposer(engine()),
        "draft-target": lambda: ContinuousBatchingScheduler(
            engine(), proposer=DraftModelProposer(InferenceEngineV2(
                model, params=params, device="cpu",
                config=RaggedInferenceEngineConfig(kv_blocks=16)))),
        "mesh": lambda: InferenceEngineV2(model, params=params,
                                          mesh=object(), device="cpu"),
        # MoE serving over a tensor or an expert axis (item 14d-ii)
        "moe-tensor": lambda: InferenceEngineV2(
            moe, mesh={"tensor": 2}, device="cpu",
            config=RaggedInferenceEngineConfig(kv_blocks=16)),
        "moe-expert": lambda: InferenceEngineV2(
            moe, mesh={"expert": 2}, device="cpu",
            config=RaggedInferenceEngineConfig(kv_blocks=16)),
        "moe-v1-expert": lambda: deepspeed_tpu_torch.init_inference(
            moe, config={"dtype": "fp32"}, mesh={"expert": 2},
            device="cpu")}
    for name, call in calls.items():
        try:
            call()
            out[name] = ""
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def tp_v1_run(params_path, overrides, config, prompts, max_new):
    """``init_inference`` with ``config`` (its ``tensor_parallel``) on the
    params of ``params_path``: the greedy stream, a sampled stream, and
    the rank's quantized blocks (codes, scales, ``cols``)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.quantization import QuantTensor

    engine = deepspeed_tpu_torch.init_inference(
        _tiny(**overrides), config=dict(config), params=_tree(params_path),
        device="cpu")
    out = {"greedy": engine.generate(prompts, max_new_tokens=max_new).numpy(),
           "sampled": engine.generate(prompts, max_new_tokens=max_new,
                                      temperature=1.0, top_k=8,
                                      rng=3).numpy(),
           "quant": {}}
    for grp, sub in engine.params.items():
        for name, leaf in sub.items():
            if isinstance(leaf, QuantTensor):
                out["quant"][f"{grp}.{name}"] = (
                    _raw(leaf.q), _raw(leaf.scales), leaf.cols,
                    leaf.packed, tuple(leaf.shape))
            else:
                out["quant"][f"{grp}.{name}"] = tuple(leaf.shape)
    return out


def tp_train_loader(mesh):
    """The first two micro batches each rank's loader yields over
    ``mesh``."""
    import deepspeed_tpu_torch

    data = {"input_ids": np.arange(16 * 9, dtype=np.int32).reshape(16, 9)}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_tiny(), config={"train_micro_batch_size_per_gpu": 2},
        training_data=data, mesh=dict(mesh), device="cpu")
    it = iter(engine.training_dataloader)
    return [np.asarray(next(it)["input_ids"]) for _ in range(2)]


def tp_lamb_refused():
    import deepspeed_tpu_torch

    try:
        deepspeed_tpu_torch.initialize(
            model=_tiny(), device="cpu", mesh={"tensor": 2},
            config={"train_micro_batch_size_per_gpu": 1,
                    "optimizer": {"type": "Lamb", "params": {}}})
    except NotImplementedError as e:
        return str(e)
    return ""
