"""Pipeline instruction-schedule executor, on PyTorch.

Counterpart of ``deepspeed_tpu/runtime/pipe/engine.py``: the host-driven
executor for the classic ``PipelineModule``/``LayerSpec`` API. It
interprets the exact ``TrainSchedule``/``InferenceSchedule`` instruction
streams (``schedule.py``) clock step by clock step, in one process, with
real dataflow:

- ``ForwardPass`` runs the stage on a fresh leaf of its input and fresh
  leaves of its params under autograd and keeps the graph of the stage's
  output in the pipe buffer (where the JAX executor keeps ``jax.vjp``'s
  pullback);
- ``Send/RecvActivation`` and ``Send/RecvGrad`` move tensors through FIFO
  edge mailboxes;
- ``BackwardPass`` differentiates the kept graph against the received
  gradient (``torch.autograd.grad``) and sends the input's gradient
  upstream (1F1B order bounds the live activations, the schedule's point);
- ``ReduceTiedGrads`` sums the gradients of a ``TiedLayerSpec`` group
  contributed by every stage that uses it;
- ``OptimizerStep`` applies the port's functional optimizer
  (``ops/optimizers.build_optimizer``) stage by stage.

Layer protocol (functional, as in the JAX package): a built LayerSpec object
exposes ``init(rng, x) -> params`` (``rng`` a ``torch.Generator``) and
``apply(params, x) -> y``; params are dicts of tensors. ``params=`` starts
the engine from given per-stage params (numpy arrays or tensors, one list of
layer params a stage), e.g. the JAX executor's.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ... import resolve_device
from ...ops.optimizers import build_optimizer, tree_leaves
from .module import PipelineModule, TiedLayerSpec
from . import schedule as sched


def _tensor_tree(tree, device):
    """A params dict (nested) of numpy arrays or tensors as tensors on
    ``device``, fp32 where floating."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, device) for k, v in tree.items()}
    t = tree if torch.is_tensor(tree) else torch.tensor(np.asarray(tree))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device)


def _tmap(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _rebuild(tree, leaves):
    """``tree``'s nesting with ``leaves`` in ``tree_leaves``' order."""
    it = iter(leaves)

    def take(node):
        if isinstance(node, dict):
            return {k: take(node[k]) for k in sorted(node)}
        return next(it)
    return take(tree)


class PipelineEngine:
    """Host-driven schedule interpreter over a PipelineModule."""

    def __init__(self, module: PipelineModule, loss_fn: Callable,
                 num_micro_batches: int, optimizer: str = "sgd",
                 optimizer_params: Optional[dict] = None, seed: int = 0,
                 params: Optional[List[List[Any]]] = None, device=None):
        self.module = module
        self.loss_fn = loss_fn
        self.num_micro = num_micro_batches
        self.num_stages = module.num_stages
        self.device = resolve_device(device)
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._opt = build_optimizer(optimizer,
                                    optimizer_params or {"lr": 1e-2})
        self._given = params
        self._initialized = False
        self.global_steps = 0

        # built layers per stage + tie bookkeeping
        self._stage_layers: List[List[Any]] = []
        self._tie_key_of: List[List[Optional[str]]] = []
        for sid in range(self.num_stages):
            specs = module.stage_layers(sid)
            built, ties = [], []
            for spec in specs:
                built.append(spec.build() if hasattr(spec, "build") else spec)
                ties.append(spec.key if isinstance(spec, TiedLayerSpec)
                            else None)
            self._stage_layers.append(built)
            self._tie_key_of.append(ties)

    # ------------------------------------------------------------- params
    def _lazy_init(self, example_x):
        """Shape-propagating init: tied groups initialize once and share
        (with given params, a tie group's later sites take its first
        site's tensors)."""
        tied_params: Dict[str, Any] = {}
        self.params: List[List[Any]] = []
        x = self._put(example_x)
        with torch.no_grad():
            for sid in range(self.num_stages):
                stage_p = []
                for li, (layer, tie) in enumerate(zip(
                        self._stage_layers[sid], self._tie_key_of[sid])):
                    if tie is not None and tie in tied_params:
                        p = tied_params[tie]
                    elif self._given is not None:
                        p = _tensor_tree(self._given[sid][li], self.device)
                    else:
                        p = layer.init(self._rng, x)
                    if tie is not None:
                        tied_params.setdefault(tie, p)
                    stage_p.append(p)
                    x = layer.apply(p, x)
                self.params.append(stage_p)
        self.opt_state = [self._opt.init(self._as_dict(sp))
                          for sp in self.params]
        self._initialized = True

    @staticmethod
    def _as_dict(stage_params):
        """A stage's list of layer params as the optimizer's dict tree."""
        return {str(i): p for i, p in enumerate(stage_params)}

    @staticmethod
    def _as_list(tree):
        return [tree[str(i)] for i in range(len(tree))]

    def _put(self, x):
        return x.to(self.device) if torch.is_tensor(x) \
            else torch.as_tensor(np.asarray(x), device=self.device)

    def _stage_apply(self, sid: int, stage_params, x):
        for layer, p in zip(self._stage_layers[sid], stage_params):
            x = layer.apply(p, x)
        return x

    # ---------------------------------------------------------- execution
    def train_batch(self, data_iter) -> float:
        """Pull ``num_micro`` (x, y) micro-batches and execute the 1F1B
        TrainSchedule across all stages; returns the mean micro loss."""
        micros = [next(data_iter) for _ in range(self.num_micro)]
        xs = [self._put(m[0] if isinstance(m, (tuple, list)) else m["x"])
              for m in micros]
        ys = [self._put(m[1] if isinstance(m, (tuple, list)) else m["y"])
              for m in micros]
        if not self._initialized:
            self._lazy_init(xs[0])

        S, M = self.num_stages, self.num_micro
        schedules = [sched.TrainSchedule(M, S, sid).steps()
                     for sid in range(S)]
        total = len(schedules[0])
        assert all(len(s) == total for s in schedules)

        # per-stage machine state
        inputs = [dict() for _ in range(S)]     # buffer -> stage input
        outputs = [dict() for _ in range(S)]    # buffer -> stage output
        graphs = [dict() for _ in range(S)]     # buffer -> kept graph
        cotangents = [dict() for _ in range(S)]  # buffer -> received grad
        grad_out = [dict() for _ in range(S)]   # buffer -> grad to send up
        grads = [[_tmap(torch.zeros_like, p) for p in sp]
                 for sp in self.params]
        act_edges = [deque() for _ in range(S)]   # edge (s-1) -> s
        grad_edges = [deque() for _ in range(S)]  # edge (s+1) -> s
        load_ptr = [0]          # next micro to load at stage 0
        label_q = deque()       # labels consumed by last-stage forwards
        losses: List[torch.Tensor] = []

        def exec_cmd(sid, cmd):
            b = getattr(cmd, "buffer_id", None)
            if isinstance(cmd, sched.LoadMicroBatch):
                i = load_ptr[0]
                load_ptr[0] += 1
                inputs[sid][b] = xs[i]
                label_q.append(ys[i])
            elif isinstance(cmd, sched.RecvActivation):
                inputs[sid][b] = act_edges[sid].popleft()
            elif isinstance(cmd, sched.RecvGrad):
                cotangents[sid][b] = grad_edges[sid].popleft()
            elif isinstance(cmd, sched.ForwardPass):
                x = inputs[sid].pop(b)
                diff_x = sid > 0 and x.is_floating_point()
                xin = x.detach().requires_grad_(diff_x)
                tree = self._as_dict(self.params[sid])
                leaves = [t.detach().requires_grad_(True)
                          for t in tree_leaves(tree)]
                sp = self._as_list(_rebuild(tree, leaves))
                with torch.enable_grad():
                    out = self._stage_apply(sid, sp, xin)
                    if sid == S - 1:
                        out = self.loss_fn(out, label_q.popleft())
                        losses.append(out.detach())
                    else:
                        outputs[sid][b] = out.detach()
                graphs[sid][b] = (out, xin if diff_x else None, leaves)
            elif isinstance(cmd, sched.BackwardPass):
                out, xin, leaves = graphs[sid].pop(b)
                if sid == S - 1:
                    cot = torch.ones_like(out) / M
                else:
                    cot = cotangents[sid].pop(b)
                wrt = leaves + ([xin] if xin is not None else [])
                got = torch.autograd.grad(out, wrt, cot, allow_unused=True)
                got = [torch.zeros_like(t) if g is None else g
                       for t, g in zip(wrt, got)]
                gp = self._as_list(_rebuild(self._as_dict(self.params[sid]),
                                            got[:len(leaves)]))
                if sid > 0:
                    grad_out[sid][b] = got[len(leaves)]
                grads[sid] = [_tmap(torch.add, a, b)
                              for a, b in zip(grads[sid], gp)]
            elif isinstance(cmd, sched.SendActivation):
                act_edges[sid + 1].append(outputs[sid].pop(b))
            elif isinstance(cmd, sched.SendGrad):
                grad_edges[sid - 1].append(grad_out[sid].pop(b))
            elif isinstance(cmd, sched.ReduceTiedGrads):
                if sid == 0:
                    self._reduce_tied_grads(grads)
            elif isinstance(cmd, sched.ReduceGrads):
                pass    # data-parallel reduction: one process, no replicas
            elif isinstance(cmd, sched.OptimizerStep):
                if sid == 0:
                    self._optimizer_step(grads)
            else:   # pragma: no cover - unknown instruction
                raise TypeError(f"unknown pipe instruction {cmd!r}")

        # Blocking-p2p semantics: each stage walks its instruction stream in
        # order; a recv with an empty mailbox blocks that stage until the
        # producer's send lands. Round-robin until every stream drains — a
        # correct schedule cannot deadlock.
        streams = [[c for step in schedules[sid] for c in step]
                   for sid in range(S)]
        cursor = [0] * S
        while any(cursor[s] < len(streams[s]) for s in range(S)):
            progressed = False
            for sid in range(S):
                while cursor[sid] < len(streams[sid]):
                    cmd = streams[sid][cursor[sid]]
                    if isinstance(cmd, sched.RecvActivation) \
                            and not act_edges[sid]:
                        break
                    if isinstance(cmd, sched.RecvGrad) \
                            and not grad_edges[sid]:
                        break
                    exec_cmd(sid, cmd)
                    cursor[sid] += 1
                    progressed = True
            if not progressed:
                raise RuntimeError(
                    "pipeline schedule deadlock: every stage blocked on a "
                    "recv — instruction streams are inconsistent")

        self.global_steps += 1
        return float(torch.mean(torch.stack(losses)))

    def _reduce_tied_grads(self, grads):
        """Sum tie-group gradients across stages and give every site the
        sum."""
        groups: Dict[str, List] = {}
        for sid in range(self.num_stages):
            for li, tie in enumerate(self._tie_key_of[sid]):
                if tie is not None:
                    groups.setdefault(tie, []).append((sid, li))
        for sites in groups.values():
            if len(sites) < 2:
                continue
            total = None
            for sid, li in sites:
                g = grads[sid][li]
                total = g if total is None else _tmap(torch.add, total, g)
            for sid, li in sites:
                grads[sid][li] = total

    @torch.no_grad()
    def _optimizer_step(self, grads):
        tied_updated: Dict[str, Any] = {}
        lr = getattr(self._opt, "lr", 1e-2)
        for sid in range(self.num_stages):
            new_p, new_o = self._opt.step(
                self._as_dict(self.params[sid]), self._as_dict(grads[sid]),
                self.opt_state[sid], lr)
            self.params[sid] = self._as_list(new_p)
            self.opt_state[sid] = new_o
        # re-share tied params (each stage stepped its own copy with the
        # same summed grad and the same state, so the values are equal;
        # aliasing keeps later updates in lockstep)
        for sid in range(self.num_stages):
            for li, tie in enumerate(self._tie_key_of[sid]):
                if tie is None:
                    continue
                if tie in tied_updated:
                    self.params[sid][li] = tied_updated[tie]
                else:
                    tied_updated[tie] = self.params[sid][li]

    # ---------------------------------------------------------- inference
    @torch.no_grad()
    def eval_batch(self, x) -> torch.Tensor:
        """Forward-only fill-drain (InferenceSchedule): one micro."""
        out = self._put(x)
        if not self._initialized:
            self._lazy_init(out)
        S = self.num_stages
        streams = [[c for step in sched.InferenceSchedule(1, S, sid).steps()
                    for c in step] for sid in range(S)]
        act_edges = [deque() for _ in range(S)]
        vals = [None] * S
        cursor = [0] * S
        while any(cursor[s] < len(streams[s]) for s in range(S)):
            progressed = False
            for sid in range(S):
                while cursor[sid] < len(streams[sid]):
                    cmd = streams[sid][cursor[sid]]
                    if isinstance(cmd, sched.RecvActivation) \
                            and not act_edges[sid]:
                        break
                    if isinstance(cmd, sched.LoadMicroBatch):
                        vals[sid] = out
                    elif isinstance(cmd, sched.RecvActivation):
                        vals[sid] = act_edges[sid].popleft()
                    elif isinstance(cmd, sched.ForwardPass):
                        vals[sid] = self._stage_apply(
                            sid, self.params[sid], vals[sid])
                    elif isinstance(cmd, sched.SendActivation):
                        act_edges[sid + 1].append(vals[sid])
                    cursor[sid] += 1
                    progressed = True
            if not progressed:
                raise RuntimeError("inference schedule deadlock")
        return vals[S - 1]
