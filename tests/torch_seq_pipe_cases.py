"""Rank-side cases of the port's sequence- and pipeline-parallel tests (run
through ``torch_ranks.RankPool``; ``tests/test_torch_sequence.py`` and
``tests/test_torch_pipeline.py``). Each function runs in every rank of a
gloo world, takes plain arguments and returns plain values; none imports
JAX."""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from torch_rank_cases import _tree


def _mesh(**axes):
    from deepspeed_tpu_torch.parallel import topology as topo

    t = topo.MeshTopology.build(**axes)
    topo.set_topology(t)
    return t


def _t(x, grad=False):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


def _model(overrides, **axes):
    from deepspeed_tpu_torch.models import transformer as ttf

    return ttf.CausalLM(dataclasses.replace(ttf.TINY_TEST, **overrides),
                        **axes)


def _grads_over(tree, group):
    """{dotted key: the leaf's gradient summed over ``group``}."""
    from deepspeed_tpu_torch import comm

    out = {}
    for k, v in _flat_tensors(tree).items():
        out[k] = comm.all_reduce(v.grad.clone(), comm.ReduceOp.SUM,
                                 group).numpy()
    return out


def _flat_tensors(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_tensors(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _leaf_tree(tree):
    """A params tree of numpy arrays as fp32 autograd leaves."""
    import torch

    if isinstance(tree, dict):
        return {k: _leaf_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=torch.float32,
                        requires_grad=True)


# ------------------------------------------------------------- sequence

def ring_cases(cases):
    """For each ``(name, sp, q, k, v, window, grad)`` case: the whole
    ``ring_attention_sharded`` output over a (sequence sp, data 4/sp) mesh
    and, where ``grad``, the gradient of its sum with respect to q, k and v
    (summed over the sequence group)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.sequence.ring_attention import \
        ring_attention_sharded

    out = {}
    for name, sp, q, k, v, window, grad in cases:
        _mesh(sequence=sp, data=4 // sp)
        q, k, v = (_t(x, grad) for x in (q, k, v))
        o = ring_attention_sharded(q, k, v, causal=True, window=window)
        res = {"out": o.detach().numpy()}
        if grad:
            o.sum().backward()
            res.update({n: comm.all_reduce(t.grad.clone(), comm.ReduceOp.SUM,
                                           "sequence").numpy()
                        for n, t in (("dq", q), ("dk", k), ("dv", v))})
        out[name] = res
    return out


def ulysses_case(q, k, v):
    """``DistributedAttention`` over the plain attention on a (sequence 4)
    mesh: each rank passes its sequence shard; the shards gathered back,
    with the all-to-all count."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.transformer import attention_reference
    from deepspeed_tpu_torch.sequence import DistributedAttention

    _mesh(sequence=4)
    r = comm.axis_index("sequence")
    n = q.shape[1] // 4
    sl = slice(r * n, (r + 1) * n)
    da = DistributedAttention(
        lambda q, k, v: attention_reference(q, k, v, causal=True))
    logger = comm.comms_logger
    logger.enabled, logger.prof_all = True, True
    logger.reset()
    o = da(*(_t(x[:, sl]) for x in (q, k, v)))
    calls = logger.log_all(print_log=False)
    logger.enabled = False
    whole = comm.all_gather_into_tensor(None, o, "sequence", axis=1)
    return {"out": whole.numpy(),
            "a2a": sum(r_["count"] for r_ in
                       calls.get("all_to_all_single", {}).values())}


def seq_loss_cases(params_path, batch, cases):
    """For each ``(name, sp, overrides)``: ``CausalLM(cfg, sp=sp).loss`` on
    the whole batch over a (sequence sp, data 4/sp) mesh, its gradient
    summed over the sequence group."""
    out = {}
    tree = _tree(params_path)
    for name, sp, overrides in cases:
        _mesh(sequence=sp, data=4 // sp)
        params = _leaf_tree(tree)
        model = _model(overrides, sp=sp)
        loss = model.loss(params, {"input_ids": _t(batch).long()})
        loss.backward()
        out[name] = {"loss": float(loss),
                     "grads": _grads_over(params, "sequence")}
    return out


def seq_refusals(params_path):
    """The sequence paths' refusals: (name -> message)."""
    import torch

    _mesh(sequence=2, data=2)
    tree = _tree(params_path)
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    out = {}
    for name, over in (("alibi", {"position": "alibi"}),
                       ("sparse", {"attention_impl": "sparse"}),
                       ("ring-scale", {"attention_impl": "ring",
                                       "attn_scale": 0.5})):
        try:
            _model(dict(num_kv_heads=4, **over), sp=2).apply(
                _leaf_tree(tree), tokens)
            out[name] = ""
        except NotImplementedError as e:
            out[name] = str(e)
    return out


# ------------------------------------------------------------- pipeline

def pipelined_apply_cases(w, x, cases):
    """For each ``(name, pipe, num_micro, grad)``: the port's
    ``pipelined_layer_apply`` of tanh(x @ w[i]) layers over a (pipe, data
    4/pipe) mesh, and (with ``grad``) the gradient of sum(out ** 2) with
    respect to w summed over the pipe group."""
    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.pipeline import pipelined_layer_apply

    out = {}
    for name, pipe, num_micro, grad in cases:
        _mesh(pipe=pipe, data=4 // pipe)
        wt = _t(w, grad)

        def layer_fn(carry, wi, micro_idx):
            return torch.tanh(carry @ wi), None

        y, aux = pipelined_layer_apply(layer_fn, wt, _t(x), num_micro)
        res = {"out": y.detach().numpy(), "aux": float(aux)}
        if grad:
            (y ** 2).sum().backward()
            res["dw"] = comm.all_reduce(wt.grad.clone(), comm.ReduceOp.SUM,
                                        "pipe").numpy()
        out[name] = res
    return out


def _stage_block(tree, pp, rank):
    """This stage's block of a whole params tree: the stacked layers'
    contiguous L/pp range."""
    out = dict(tree)
    L = next(iter(tree["layers"].values())).shape[0]
    n = L // pp
    out["layers"] = {k: v[rank * n:(rank + 1) * n]
                     for k, v in tree["layers"].items()}
    return out


def pipe_loss_cases(params_path, batch, cases):
    """For each ``(name, overrides, fn)``: over a (pipe 2, data 2) mesh,
    ``CausalLM(cfg, pp=2)`` on this stage's block of the params: ``loss``
    (and its gradient: the layers' blocks gathered over the pipe group,
    the other leaves summed over it), or ``apply(return_aux=True)``'s aux
    and logits."""
    import torch

    from deepspeed_tpu_torch import comm

    out = {}
    tree = _tree(params_path)
    for name, overrides, fn in cases:
        _mesh(pipe=2, data=2)
        r = comm.axis_index("pipe")
        params = _leaf_tree(_stage_block(tree, 2, r))
        model = _model(overrides, pp=2)
        tokens = _t(batch).long()
        if fn == "aux":
            logits, aux = model.apply(params, tokens, return_aux=True)
            out[name] = {"aux": float(aux),
                         "logits": logits.detach().numpy()}
            continue
        loss = model.loss(params, {"input_ids": tokens})
        loss.backward()
        grads = {}
        for k, v in _flat_tensors(params).items():
            # a stage's head leaves have no gradient before the last stage,
            # nor its embedding after the first
            g = torch.zeros_like(v) if v.grad is None else v.grad.clone()
            if k.startswith("layers."):
                grads[k] = comm.all_gather_into_tensor(None, g, "pipe",
                                                       axis=0).numpy()
            else:
                grads[k] = comm.all_reduce(g, comm.ReduceOp.SUM,
                                           "pipe").numpy()
        out[name] = {"loss": float(loss), "grads": grads}
    return out


def pipe_refusals(params_path):
    """The pipeline's refusals kept from the JAX package: per-layer window
    segments (pipe 2) and dropless MoE with expert parallelism (pipe 2 x
    expert 2)."""
    import torch

    from deepspeed_tpu_torch import comm

    tree = _tree(params_path)
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    out = {}
    _mesh(pipe=2, data=2)
    try:
        _model({"num_kv_heads": 4, "sliding_window": (4, 0)}, pp=2).apply(
            _leaf_tree(_stage_block(tree, 2, comm.axis_index("pipe"))),
            tokens)
        out["windows"] = ""
    except NotImplementedError as e:
        out["windows"] = str(e)
    _mesh(pipe=2, expert=2, data=1)
    from deepspeed_tpu_torch.models import transformer as ttf

    cfg = dataclasses.replace(ttf.TINY_TEST, num_kv_heads=4,
                              moe_num_experts=2, moe_dropless=True)
    model = ttf.CausalLM(cfg, ep=2, pp=2)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    from deepspeed_tpu_torch.parallel.sharding import place_blocks
    from deepspeed_tpu_torch.parallel.topology import get_topology
    from deepspeed_tpu_torch.parallel.sharding import tree_shardings

    t = get_topology()
    specs = tree_shardings(params, model.param_specs(), t)
    params = place_blocks(params, specs, t, comm.get_rank(), "cpu")
    try:
        model.apply(params, tokens)
        out["dropless"] = ""
    except NotImplementedError as e:
        out["dropless"] = str(e)
    return out


# -------------------------------------------------------------- engines

def engine_run(cfg_json, mesh, params_path, batches_path, steps,
               save_dir=None, save_after=None, load_dir=None, first=0):
    """``torch_rank_cases.zero_run`` over a mesh with sequence or pipe
    axes, the model's config overrides in the config's ``_model`` key."""
    import torch_rank_cases as cases

    cfg = json.loads(cfg_json)
    cfg["_moe"] = cfg.pop("_model", {})
    return cases.zero_run(json.dumps(cfg), mesh, params_path, batches_path,
                          steps, save_dir=save_dir, save_after=save_after,
                          load_dir=load_dir, first=first)
