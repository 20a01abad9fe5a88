"""Rank-side cases of the port's multi-rank tests (run through
``torch_ranks.RankPool``). Each function runs in every rank of a gloo
world, takes plain arguments and returns plain values (numpy arrays, dicts,
floats); none imports JAX."""

from __future__ import annotations

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


def _rank_batches(batches, rank, dp):
    """Rank ``rank``'s rows of each global micro batch: the rows the JAX
    engine's batch sharding gives device ``rank``."""
    mb = batches.shape[1] // dp
    return batches[:, rank * mb:(rank + 1) * mb]


def _engine(cfg_json, mesh, params_path):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as ttf

    cfg = json.loads(cfg_json)
    model = ttf.CausalLM(getattr(ttf, cfg.pop("_model", "TINY_TEST")))
    kw = {} if mesh is None else {"mesh": dict(mesh)}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, model_parameters=_tree(params_path),
        device="cpu", **kw)
    return engine


def _train(engine, batches, steps, first=0):
    from deepspeed_tpu_torch import comm

    gas = engine.gradient_accumulation_steps()
    mine = _rank_batches(batches, comm.get_rank(), engine.dp_world_size)
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
