"""DeepSpeedTpuEngine — the core training runtime, on PyTorch.

Counterpart of ``deepspeed_tpu/runtime/engine.py``: the same lifecycle
(``forward`` / ``backward`` / ``step``, ``train_batch``, gradient
accumulation, global-norm clipping, dynamic fp16 loss scaling, throughput
and wall-clock timers) on one device:

- The train state (fp32 master params, fp32 optimizer moments, an fp32
  gradient accumulator, the loss-scale state, the counters) is one
  ``TrainState`` of tensors on the engine's device. The model casts each
  weight to the compute type inside the graph (``models/transformer._linear``),
  so under bf16 or fp16 the gradients still arrive in fp32 on the fp32
  leaves.
- ``forward`` runs forward, backward and accumulation for one micro batch
  (``backward(loss)`` is the API-parity call that advances the micro-step
  counter, as in the JAX engine, where one jitted program does all three).
  The accumulator *is* each master leaf's ``.grad``: autograd adds into it in
  place, so no second gradient tree exists.
- ``step`` runs the update at accumulation boundaries: unscale, global-norm
  clip, overflow-gated optimizer step, loss-scale update, schedule-computed
  lr. ``overflow``, the grad norm and the counters stay 0-d tensors and the
  gate is ``torch.where`` (the JAX program's ``lax.cond``), so a step costs
  no device-to-host sync; they are read on the host only every
  ``steps_per_print`` steps and in the getters.
- Unlike the JAX functions, which return a new state (XLA donates the
  buffers), the update writes the master params, moments and accumulator in
  place, leaf by leaf: at 16 bytes a parameter a second copy of the state
  would not fit beside the first. The optimizer is still called through
  ``opt.step(params, grads, state, lr)``, on one-leaf trees.

- The stacked layer leaves' gradients are added into the accumulator a
  layer slice at a time as the backward reaches each layer
  (``models/transformer.layer_grads_in_place``), so no second copy of the
  layer gradients waits for the whole backward.
- ZeRO-Offload (``zero_optimization.offload_optimizer`` on ``cpu`` or
  ``nvme``, ``runtime/zero_offload.py``): the plan's offloaded leaves keep
  their fp32 masters and moments in host RAM (the moments on NVMe under
  ``nvme``) and are updated there by the C++ optimizer; the device keeps
  every fp32 param and the accumulator, and moments only for the kept
  leaves (Twin-Flow ``ratio`` < 1), keyed by leaf index as in the JAX
  package.

Checkpoints are the JAX package's universal layout
(``save_checkpoint``/``load_checkpoint``, ``runtime/checkpointing.py``):
either package resumes the other's. ``runtime/resilience.py``'s
``TrainingSupervisor`` drives ``train_batch`` under crashes, preemption,
wedged steps and anomaly storms.

Over a ``data`` × ``fsdp`` mesh of ranks (one process a rank, a
``torch.distributed`` process group up; ``comm.init_distributed``) the
engine runs ZeRO stages 0-3 by hand on the functional param tree, with
the layouts of ``parallel/sharding.ZeroShardingPlan`` (so shard files and
blocks equal the JAX engine's): each rank keeps only the blocks the plan
gives it. Stage 0 averages the gradients over ``GRAD_REDUCE_AXES``; stage 1
updates a rank's moment block and all-gathers the params back; stage 2
also reduce-scatters each micro step's gradients onto the ``fsdp`` axis;
stage 3 stores the params sharded and gathers each layer at use through
``parallel/zeropp``'s autograd Function (its backward reduce-scatters),
installed as the model's ``layer_transform``/``global_transform``; a
gathered layer is freed after its use and gathered again for the backward.
MiCS reshapes the mesh to ``fsdp = k``, hpZ shards the moments over
(``fsdp``, ``data``), ZeRO++ quantizes the stage-3 gather (qwZ) and
gradient reduce (qgZ). The grad norm is one all-reduce of the sum of
squares, so overflow, clipping and the loss scale agree on every rank.
Each rank reads its own micro batch (DeepSpeed's convention; the JAX engine
is fed one global batch), and ``train_batch`` returns the loss averaged
over the ranks.

A ``tensor`` axis (Megatron tensor parallelism, SPMD as DeepSpeed runs
it): the model is built over the tensor group (``CausalLM(cfg, tp=...)``)
and runs on the rank's blocks of the heads and MLP columns, reducing the
row-parallel products over the group (``parallel/tensor_parallel.py``).
The ranks of one tensor group read the same micro batch (the loader's
share and the rows go by the data-parallel index over ``data`` x
``fsdp``); gradients are averaged over ``GRAD_REDUCE_AXES`` only, the
stage-2 reduce-scatter and the stage-3 gather run over ``fsdp`` and leave
the tensor blocks in place, and the norm counts a replicated leaf once and
each tensor block of a sharded one once.

An ``expert`` axis (MoE expert parallelism): each rank holds its experts'
slice of the ``[L, E, ...]`` expert leaves and every token row of its
micro batch (activations are replicated over ``expert``; the ranks of one
expert group read the same rows), and the model (``CausalLM(cfg, ep=...,
dp=...)``) sums each layer's partial MoE output over the group. Expert
gradients reduce over the batch axes only. A MoE model over ``data`` x
``fsdp`` routes over the global batch, as the JAX engine does.

A ``sequence`` axis (Ulysses or ring attention, ``attention_impl``):
the ranks of one sequence group read the same rows, each runs its T/P
slice (``CausalLM(cfg, sp=...)``), and each rank's loss is the group's
global mean. A ``pipe`` axis: each rank holds its L/P layers (the plan
maps the stacked ``layers`` dim to ``pipe``) and the ranks of one pipe
group read the same micro batch, which the model runs as a GPipe pipeline
of ``pipeline.micro_batches`` micro-batches (``CausalLM(cfg, pp=...)``,
``parallel/pipeline.py``). Gradients of blocks not sharded over them are
summed over both axes (``SUM_AXES``), and averaged over the data-parallel
ranks only.

ZeRO stages on a one-rank world shard nothing, as in the JAX package.
MoE over a tensor axis, 1-bit optimizers,
offload on a mesh, curriculum, compression, elasticity, monitors and the flops profiler
raise ``NotImplementedError`` naming their ROADMAP item.
ZeRO-Infinity's parameter streaming is its own engine
(``runtime/zero_infinity.py``), which ``initialize`` builds for an
``offload_param`` block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import comm as dist
from .. import not_ported, resolve_device
from ..models.transformer import CausalLM, layer_grads_in_place
from ..models.weights import params_from_numpy
from ..ops.optimizers import Lamb, OptimizerState, build_optimizer, tree_leaves
from ..parallel import topology as topo
from ..parallel import zeropp
from ..parallel.sharding import (ZeroShardingPlan, block_shape, entry_axes,
                                 is_replica_zero, local_slice)
from ..utils.logging import log_dist
from ..utils.timer import (FORWARD_MICRO_TIMER, STEP_GLOBAL_TIMER,
                           SynchronizedWallClockTimer, ThroughputTimer)
from .config import (DeepSpeedTpuConfig, DtypeEnum, OffloadDeviceEnum,
                     load_config)
from .dataloader import DeepSpeedTpuDataLoader, RepeatingLoader
from .lr_schedules import LRSchedulerShim, build_schedule
from .zero_offload import OffloadOptimizerPlan

# the largest piece of a leaf that the gradient norm squares at once and
# that one offload staging buffer holds (256 MB of fp32)
PIECE_ELEMS = 1 << 26

# the axes a gradient block not sharded over them is summed over: the
# data-parallel replicas (whose mean the update takes), the sequence ranks
# (each holds its tokens' share of the gradient of one loss) and the pipe
# stages (a pipe-replicated leaf's gradient arises on stage 0, the
# embedding, or on the last stage, the head; the model sees to that)
SUM_AXES = topo.GRAD_REDUCE_AXES + (topo.SEQUENCE_AXIS, topo.PIPE_AXIS)


class ScaleState(NamedTuple):
    """Dynamic loss scale state."""
    scale: torch.Tensor        # 0-d float32
    good_steps: torch.Tensor   # 0-d int32
    hysteresis: torch.Tensor   # 0-d int32


class TrainState(NamedTuple):
    params: Any                # fp32 master weights (autograd leaves)
    opt_state: OptimizerState
    grad_acc: Any              # fp32 accumulator: each leaf's ``.grad``
    scale_state: ScaleState
    global_step: torch.Tensor  # 0-d int32
    skipped_steps: torch.Tensor  # 0-d int32


def _paths(tree, prefix=()):
    """(path, leaf) pairs of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _unflatten(leaves, like):
    """``like``'s nesting with ``leaves[path]`` at each leaf."""
    out = {}
    for path, _ in _paths(like):
        _put(out, path, leaves[path])
    return out


class DeepSpeedTpuEngine:
    """See the module docstring. Construct via
    ``deepspeed_tpu_torch.initialize``."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None, lr_scheduler=None,
                 mesh=None, collate_fn=None, config=None, rng=None,
                 device=None):
        self.config: DeepSpeedTpuConfig = load_config(
            getattr(args, "deepspeed_config", None) if config is None
            else config)
        self.device = resolve_device(device)
        dist.init_distributed(config=self.config, device=self.device.type)
        self.config.raise_if_not_ported(mesh=True)
        self.zero_stage = self.config.zero_optimization.stage
        self.topology = self._build_topology(mesh)
        topo.set_topology(self.topology)
        self.rank = dist.get_rank()
        # the mesh branch: every rank a process, blocks and collectives
        self._mesh = self.topology.world_size > 1
        self.tp = self.topology.axis_size(topo.TENSOR_AXIS)
        self.ep = self.topology.axis_size(topo.EXPERT_AXIS)
        self.dp_world_size = self.topology.get_data_parallel_world_size()
        # this rank's index among the data-parallel replicas: which rows of
        # a global batch it reads (its tensor peers read the same)
        self.dp_rank = self.topology.flat_index(self.rank, topo.BATCH_AXES)
        self.config.resolve_batch_sizes(self.dp_world_size)

        # -- model ---------------------------------------------------------
        self.module = self._resolve_model(model)
        spec_tree = (self.module.param_specs()
                     if hasattr(self.module, "param_specs") else None)
        hpz_size = self.config.zero_optimization.zero_hpz_partition_size
        if hpz_size > 1:
            # hpZ's secondary (weight-shard) group is the fsdp axis; any
            # other size would need another mesh
            fsdp_size = self.topology.axis_size(topo.FSDP_AXIS)
            if hpz_size != fsdp_size:
                raise ValueError(
                    f"zero_hpz_partition_size={hpz_size} must equal the mesh "
                    f"fsdp axis size ({fsdp_size}); size the mesh's fsdp axis "
                    "to the intended secondary-partition group")
        self.plan = ZeroShardingPlan(self.topology, self.zero_stage,
                                     spec_tree, hpz=hpz_size > 1)

        # -- precision -----------------------------------------------------
        self.precision = self.config.precision
        self.compute_dtype = self.precision.to_torch()
        self.fp16_enabled = self.precision == DtypeEnum.fp16
        self.bf16_enabled = self.precision == DtypeEnum.bf16
        self.dynamic_loss_scale = (self.fp16_enabled
                                   and self.config.fp16.loss_scale == 0)
        self._static_scale = (
            self.config.fp16.loss_scale
            if self.fp16_enabled and not self.dynamic_loss_scale else 1.0)

        # -- optimizer + schedule -----------------------------------------
        oc = self.config.optimizer
        self.client_optimizer = optimizer
        if optimizer is not None and not isinstance(optimizer, str):
            self.opt = optimizer  # duck-typed: init/step, leaf-wise
        else:
            self.opt = build_optimizer(oc.type if oc else "Adam",
                                       oc.params if oc else {"lr": 1e-3})
        base_lr = getattr(self.opt, "lr", 1e-3)
        sc = self.config.scheduler
        if lr_scheduler is not None:
            self.schedule = lr_scheduler  # callable step -> lr
        else:
            self.schedule = build_schedule(sc.type if sc else None,
                                           sc.params if sc else None,
                                           fallback_lr=base_lr)
        self.lr_scheduler = LRSchedulerShim(
            self.schedule,
            step_source=lambda: int(self.state.global_step)
            if getattr(self, "state", None) is not None else 0)

        if self._mesh:
            if self._offload_config() is not None:
                raise not_ported("ZeRO-Offload over a mesh (per-rank host "
                                 "shards)", "queue 1 item 14")
            if isinstance(self.opt, Lamb) and (self.zero_stage >= 1
                                               or self.tp > 1):
                raise not_ported("LAMB over sharded moments or tensor-"
                                 "sharded leaves (its trust ratio takes "
                                 "whole-leaf norms)", "queue 1 item 14")

        # -- state ---------------------------------------------------------
        self._seed = int(self.config.seed if rng is None else rng)
        self.state = self._init_state(model_parameters)
        self._setup_zeropp()

        # -- data ----------------------------------------------------------
        self.training_dataloader = None
        self._data_iter = None  # the persistent train_batch iterator
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)

        # -- counters ------------------------------------------------------
        self.micro_steps = 0          # micro steps since engine start
        self.global_steps = 0         # host mirror: optimizer boundaries
        self._pending_loss = None
        self._last_metrics: Optional[Dict[str, torch.Tensor]] = None
        self.timers = SynchronizedWallClockTimer(sync_fn=self._sync)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            steps_per_output=self.config.steps_per_print,
            monitor_memory=self.config.memory_breakdown)
        self.tput_timer.flops_per_sample = 0.0   # the flops profiler's job
        # step profiling (docs/OBSERVABILITY.md "Step profiling"):
        # wall_clock_breakdown or an enabled telemetry block brackets
        # fwd+bwd and the optimizer step with synchronized timers (a device
        # sync per bracket, so real device time is measured) and records
        # matching spans on the tracer ("train" trace)
        self.tracer = self.config.telemetry.build_tracer()
        self._profile_steps = bool(self.config.wall_clock_breakdown
                                   or self.config.telemetry.enabled)

        log_dist(
            f"DeepSpeedTpuEngine ready: device={self.device} "
            f"mesh={self.topology.shape} "
            f"zero_stage={self.zero_stage} precision={self.precision.value} "
            f"micro_batch={self.train_micro_batch_size_per_gpu()} "
            f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------ setup
    def _build_topology(self, mesh) -> topo.MeshTopology:
        """The rank grid: ``mesh`` (a ``MeshTopology``, a mesh config or a
        dict of axis sizes) or the config's ``mesh`` block, over the process
        group's world (the registry is not consulted: a config's mesh is
        always its own). MiCS then reshapes it as the JAX engine does."""
        t = topo.mesh_topology(self.config.mesh if mesh is None else mesh)
        zc = self.config.zero_optimization
        if zc.mics_shard_size and zc.mics_shard_size > 0:
            k = int(zc.mics_shard_size)
            if zc.stage != 3:
                raise ValueError(
                    f"mics_shard_size={k} requires zero_optimization.stage=3 "
                    "(MiCS is a ZeRO-3 variant, reference mics.py:55)")
            fsdp_size = t.axis_size(topo.FSDP_AXIS)
            if fsdp_size != k:
                if mesh is None and fsdp_size == 1 and t.world_size % k == 0:
                    # the engine's own mesh: fsdp becomes the shard group,
                    # data soaks up the replication factor
                    t = topo.MeshTopology.build(self.config.mesh, fsdp=k,
                                                data=-1)
                else:
                    raise ValueError(
                        f"mics_shard_size={k} conflicts with the mesh fsdp "
                        f"axis ({fsdp_size}); size the fsdp axis to the MiCS "
                        "shard group (params shard over fsdp, replicate over "
                        "data)")
            log_dist(f"MiCS: shard group={k} (fsdp axis), replication="
                     f"{t.axis_size(topo.DATA_AXIS)} (data axis)", ranks=[0])
        return t

    def _resolve_model(self, model):
        if model is None:
            raise ValueError("model is required")
        if isinstance(model, str):
            from ..models import build_model

            model = build_model(model)
        cfg = getattr(model, "cfg", None)
        if cfg is not None and getattr(cfg, "dropout", 0.0) > 0:
            raise not_ported("training with dropout > 0 (the masks would "
                             "have to equal jax.random's)", "queue 1 item 17")
        return model

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _model_dtype_override(self):
        """Push the engine's precision and ``pipeline.micro_batches`` into
        the model config when the model is a framework CausalLM."""
        if not isinstance(self.module, CausalLM):
            return
        over = {}
        if self.module.cfg.dtype != self.compute_dtype:
            over["dtype"] = self.compute_dtype
        pmb = self.config.pipeline.micro_batches
        if pmb and self.module.cfg.pipeline_microbatches != pmb:
            over["pipeline_microbatches"] = pmb
        if over:
            self.module = CausalLM(dataclasses.replace(self.module.cfg,
                                                       **over))

    def _scalar(self, value, dtype):
        return torch.tensor(value, dtype=dtype, device=self.device)

    def _offload_config(self):
        oc = self.config.zero_optimization.offload_optimizer
        if oc is None or oc.device == OffloadDeviceEnum.none:
            return None
        return oc

    def _init_opt_state(self, tree) -> OptimizerState:
        """The device optimizer's state of ``tree``; for a tree with no
        leaves (everything offloaded) a step counter and empty moment
        trees, the kinds read off a one-element probe."""
        if tree_leaves(tree):
            return self.opt.init(tree)
        probe = self.opt.init({"_": torch.zeros(1, device=self.device)})
        return OptimizerState(step=probe.step,
                              moments={mk: {} for mk in probe.moments})

    def _init_state(self, model_parameters=None) -> TrainState:
        self._model_dtype_override()
        if self.tp > 1:
            if not isinstance(self.module, CausalLM):
                raise ValueError("a tensor axis needs a framework CausalLM "
                                 "(its column- and row-parallel blocks)")
            self.module = self.module.tensor_parallel(self.tp)
        if isinstance(self.module, CausalLM) \
                and self.module.cfg.moe_num_experts > 0 \
                and (self.ep > 1 or self.dp_world_size > 1):
            # MoE over the mesh: this rank's experts, and routing over the
            # global batch of the data-parallel ranks
            self.module = self.module.expert_parallel(self.ep,
                                                      self.dp_world_size)
        sp = self.topology.axis_size(topo.SEQUENCE_AXIS)
        pp = self.topology.axis_size(topo.PIPE_AXIS)
        if sp > 1 or pp > 1:
            if not isinstance(self.module, CausalLM):
                raise ValueError("a sequence or pipe axis needs a framework "
                                 "CausalLM (its sequence slices and "
                                 "pipeline stages)")
            # the sequence ranks run their slices of the same rows; the
            # pipe ranks their layer blocks of the same micro batch
            self.module = self.module.sequence_parallel(sp) \
                .pipeline_parallel(pp)
        self._scattered = set()
        if self._mesh:
            return self._init_mesh_state(model_parameters)
        if model_parameters is not None:
            # the caller's starting tree (numpy arrays or tensors): copied
            # into fp32 master weights on the engine's device
            params = params_from_numpy(model_parameters, self.device,
                                       dtype=torch.float32)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self._seed)
            params = self.module.init(gen, device=self.device)
        grad_acc = {}
        for path, p in _paths(params):
            if p.dtype != torch.float32:
                raise TypeError(f"master param {'.'.join(path)} is {p.dtype};"
                                " the engine keeps fp32 master weights")
            p.requires_grad_(True)
            p.grad = torch.zeros_like(p)
            node = grad_acc
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = p.grad
        # ZeRO-Offload: the host owns the offloaded leaves' update, and the
        # device optimizer covers the kept ones under the keys str(i)
        oc = self._offload_config()
        self._offload_plan = None
        kept = params
        if oc is not None:
            opt_cfg = self.config.optimizer
            self._offload_plan = plan = OffloadOptimizerPlan(
                params, opt_cfg.type if opt_cfg else "Adam",
                opt_cfg.params if opt_cfg else {},
                device=oc.device.value, ratio=oc.ratio,
                nvme_path=oc.nvme_path,
                aio_threads=self.config.aio.thread_count,
                pin_memory=oc.pin_memory)
            leaves = tree_leaves(params)
            kept = {str(i): leaves[i] for i in plan.kept}
            # two staging buffers, allocated once: the gradient piece the
            # host optimizer reads while the next piece transfers
            n = min(PIECE_ELEMS, max((leaves[i].numel()
                                      for i in plan.offloaded), default=1))
            self._stages = [torch.empty(n, dtype=torch.float32,
                                        pin_memory=plan.pinned)
                            for _ in range(2)]
            self._offload_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="offload-host-step")
            self.offload_timings: Dict[str, float] = {}
        with torch.no_grad():
            opt_state = self._init_opt_state(kept)
        return self._fresh_state(params, opt_state, grad_acc)

    def _fresh_state(self, params, opt_state, grad_acc) -> TrainState:
        """A train state at step 0 around these trees."""
        scale0 = (2.0 ** self.config.fp16.initial_scale_power
                  if self.dynamic_loss_scale else self._static_scale)
        scale_state = ScaleState(
            scale=self._scalar(scale0, torch.float32),
            good_steps=self._scalar(0, torch.int32),
            hysteresis=self._scalar(self.config.fp16.hysteresis, torch.int32))
        return TrainState(params=params, opt_state=opt_state,
                          grad_acc=grad_acc, scale_state=scale_state,
                          global_step=self._scalar(0, torch.int32),
                          skipped_steps=self._scalar(0, torch.int32))

    def _init_mesh_state(self, model_parameters) -> TrainState:
        """The rank's blocks of the train state. The whole starting tree
        (``model_parameters``, or ``module.init`` from the seed, the same
        on every rank) is cut to the plan's param blocks; each block is an
        fp32 autograd leaf whose ``.grad`` is the micro step's gradient
        buffer. The accumulator is that buffer where the grads' layout is
        the params' (stages 0, 1, 3), else (stage 2) a block of its own;
        the moments are blocks of the plan's optimizer layout."""
        if model_parameters is not None:
            full = params_from_numpy(model_parameters, "cpu",
                                     dtype=torch.float32)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self._seed)
            full = self.module.init(gen, device=self.device)
        plan, t, r = self.plan, self.topology, self.rank
        self._full_shapes = {path: tuple(p.shape) for path, p in _paths(full)}
        shapes = _unflatten(self._full_shapes, full)
        self._p_specs = plan.params(shapes)
        self._g_specs = plan.grads(shapes)
        kinds = list(self.opt.init(
            {"_": torch.zeros(1, device=self.device)}).moments)
        self._o_specs = plan.opt_state({mk: shapes for mk in kinds})
        params, grad_acc, blocks = {}, {}, {}
        self._scattered = set()     # leaves with an accumulator of their own
        for path, p in _paths(full):
            shape, ps = self._full_shapes[path], _at(self._p_specs, path)
            blk = p.detach()[local_slice(shape, ps, t, r)].to(
                self.device, torch.float32).clone()
            blk.requires_grad_(True)
            blk.grad = torch.zeros_like(blk)
            gs = _at(self._g_specs, path)
            acc = blk.grad
            if gs != ps:
                acc = torch.zeros(block_shape(shape, gs, t), device=self.device)
                self._scattered.add(path)
            os_ = _at(self._o_specs[kinds[0]], path) if kinds else ps
            _put(params, path, blk)
            _put(grad_acc, path, acc)
            _put(blocks, path, torch.zeros(block_shape(shape, os_, t),
                                           device=self.device))
        del full
        self._offload_plan = None
        with torch.no_grad():
            opt_state = self._init_opt_state(blocks)
        return self._fresh_state(params, opt_state, grad_acc)

    def _setup_zeropp(self):
        """Stage 3 over a mesh gathers each sharded weight at use: the
        model gets ``parallel/zeropp``'s gather transforms (plain, or with
        ZeRO++'s qwZ/qgZ quantized payloads). ZeRO++ needs stage 3, as in
        the JAX engine."""
        zc = self.config.zero_optimization
        quant = zc.zero_quantized_weights or zc.zero_quantized_gradients
        if quant and self.zero_stage < 3:
            raise ValueError(
                "zero_quantized_weights/gradients (ZeRO++) require "
                f"zero_optimization.stage=3, got stage={self.zero_stage}")
        self._gather_transforms = []
        if not self._mesh or self.zero_stage < 3:
            return
        if not isinstance(self.module, CausalLM):
            raise ValueError("stage 3 over a mesh needs a framework CausalLM "
                             "(its layer_transform/global_transform hooks)")
        qw = 8 if zc.zero_quantized_weights else None
        qg = 8 if zc.zero_quantized_gradients else None
        dt = self.compute_dtype
        layer_specs, l_dtypes = {}, {}
        fp32 = self.module.fp32_layer_leaves()
        for k, spec in self._p_specs["layers"].items():
            if spec and set(entry_axes(spec[0])) - {topo.PIPE_AXIS}:
                raise not_ported(f"a stage-3 plan that shards the stacked "
                                 f"layer dim of layers.{k}", "queue 1 item 14")
            layer_specs[k] = spec[1:]
            # matrices are gathered into the compute dtype (the model casts
            # them so at use); norms, biases and the matrices the model
            # reads in fp32 stay fp32
            if len(self._full_shapes[("layers", k)]) > 2 and k not in fp32:
                l_dtypes[k] = dt
        g_specs = {f"{grp}.{k}": spec
                   for grp in ("embed", "final_norm", "lm_head")
                   for k, spec in self._p_specs.get(grp, {}).items()}
        # the embedding tables stay fp32: their row gradients are summed
        # over repeated tokens (and, tied, with the unembedding's) in fp32
        g_dtypes = {"lm_head.w": dt}
        self.module.layer_transform = zeropp.make_quantized_gather_transform(
            self.topology, layer_specs, qw_bits=qw, qg_bits=qg,
            out_dtypes=l_dtypes)
        self.module.global_transform = \
            zeropp.make_quantized_gather_transform(
                self.topology, g_specs, qw_bits=qw, qg_bits=qg,
                out_dtypes=g_dtypes)
        self._gather_transforms = [x for x in (self.module.layer_transform,
                                               self.module.global_transform)
                                   if x is not None]
        if quant:
            log_dist(f"ZeRO++ enabled: qwZ={bool(qw)} qgZ={bool(qg)}",
                     ranks=[0])

    # ----------------------------------------------------------- step programs
    def _predivide(self) -> float:
        return float(self.dp_world_size) \
            if self.config.prescale_gradients else 1.0

    def _micro(self, batch):
        """Forward, backward and accumulate for one micro batch; the loss is
        scaled by ``scale / (dp_size if predivide else 1)`` before the
        gradient. At stage 3 the gathered weights are freed after use
        (``zeropp.free_gathered``); at stage 2 each leaf's gradient is
        reduce-scattered onto its grads block and the buffer cleared."""
        state = self.state
        free = (zeropp.free_gathered() if self._gather_transforms
                else contextlib.nullcontext())
        with free, layer_grads_in_place():
            loss = self.module.loss(state.params, batch, None)
        scaled = (loss * state.scale_state.scale
                  / self._predivide()).to(torch.float32)
        scaled.backward()
        for path, p in _paths(state.params):
            acc = _at(state.grad_acc, path)
            if path in self._scattered:
                with torch.no_grad():
                    acc.add_(self._scatter(p.grad, path))
                    p.grad.zero_()
            elif p.grad.data_ptr() != acc.data_ptr():
                raise RuntimeError(
                    f"autograd replaced the accumulator of {'.'.join(path)} "
                    "instead of adding into it")
        return loss.detach()

    # ------------------------------------------------------- mesh layouts
    def _slice_of(self, t, path, src, dst):
        """This rank's ``dst`` block of a leaf, from its ``src`` block
        ``t``: a view where the ``dst`` block lies inside the ``src`` one,
        else through the whole leaf."""
        shape = self._full_shapes[path]
        have = local_slice(shape, src, self.topology, self.rank)
        want = local_slice(shape, dst, self.topology, self.rank)
        if all(w.start >= h.start and w.stop <= h.stop
               for h, w in zip(have, want)):
            return t[tuple(slice(w.start - h.start, w.stop - h.start)
                           for h, w in zip(have, want))]
        return self._gather_from(t, src, ())[want]

    def _gather_from(self, t, src, dst):
        """The ``dst`` block from the ``src`` blocks of every rank, for a
        ``dst`` that each dim shards over a leading part of ``src``'s axes
        (all-gather over the rest); else through the whole leaf."""
        dst = tuple(dst) + (None,) * (len(src) - len(dst))
        if all(entry_axes(s)[:len(entry_axes(d))] == entry_axes(d)
               for s, d in zip(src, dst)):
            for dim, (s, d) in enumerate(zip(src, dst)):
                extra = entry_axes(s)[len(entry_axes(d)):]
                if extra:
                    t = dist.all_gather_into_tensor(None, t, extra, axis=dim)
            return t
        full = self._gather_from(t, src, ())
        shape = tuple(full.shape)
        return full[local_slice(shape, dst, self.topology, self.rank)]

    def _scatter(self, blk, path):
        """This rank's grads block of the sum of every rank's gradient of
        its param block ``blk`` (reduce-scatter, dim by dim, over the axes
        the grads block shards and the param block does not: a tensor block
        stays in place)."""
        out = blk
        ps = _at(self._p_specs, path)
        for dim, entry in enumerate(_at(self._g_specs, path)):
            have = entry_axes(ps[dim]) if dim < len(ps) else ()
            axes = tuple(a for a in entry_axes(entry) if a not in have)
            if axes:
                out = dist.reduce_scatter_tensor(
                    None, out, dist.ReduceOp.SUM, axes, scatter_dim=dim)
        return out

    def _ckpt_layout(self):
        """For a sharded checkpoint: {dotted key: (whole shape, spec)} of
        the params and of the moments (keys ``<kind>.<leaf>``), or None in
        one process."""
        if not self._mesh:
            return None
        p_lay, o_lay = {}, {}
        for path, shape in self._full_shapes.items():
            key = ".".join(path)
            p_lay[key] = (shape, _at(self._p_specs, path))
            for mk, specs in self._o_specs.items():
                o_lay[f"{mk}.{key}"] = (shape, _at(specs, path))
        return p_lay, o_lay

    @torch.no_grad()
    def _update_mesh(self):
        """The update over a mesh. Each accumulator holds its grads block
        summed over the axes the block is sharded on; one all-reduce a leaf
        over the other ``GRAD_REDUCE_AXES`` completes the sum, whose mean
        over the DP ranks is the JAX engine's gradient. The norm is one
        all-reduce of the sums of squares of every block's first holder.
        Each leaf's optimizer moments are its moment block, the update runs
        on the matching param and grad blocks, and the new params are
        all-gathered back to the param layout."""
        state = self.state
        t, r = self.topology, self.rank
        gas = self.gradient_accumulation_steps()
        clip = self.config.gradient_clipping
        scale = state.scale_state.scale
        denom = scale * gas * self.dp_world_size / self._predivide()
        sumsq = torch.zeros((), dtype=torch.float32, device=self.device)
        for path, acc in _paths(state.grad_acc):
            gs = _at(self._g_specs, path)
            sharded = {a for e in gs for a in entry_axes(e)}
            rest = tuple(a for a in SUM_AXES
                         if t.axis_size(a) > 1 and a not in sharded)
            if rest:
                dist.all_reduce(acc, dist.ReduceOp.SUM, rest)
            if is_replica_zero(gs, t, r):
                sumsq = sumsq + torch.sum(torch.square(acc / denom))
        dist.all_reduce(sumsq, dist.ReduceOp.SUM, None)
        gnorm = torch.sqrt(sumsq)
        overflow = ~torch.isfinite(gnorm)
        coeff = (torch.clamp(clip / (gnorm + 1e-6), max=1.0)
                 if clip > 0 else None)
        lr = self.schedule(state.global_step)
        opt_state = state.opt_state
        new_step = opt_state.step + 1
        for path, p in _paths(state.params):
            ps, gs = _at(self._p_specs, path), _at(self._g_specs, path)
            os_ = _at(next(iter(self._o_specs.values())), path) \
                if self._o_specs else ps
            acc = _at(state.grad_acc, path)
            grad = self._slice_of(acc, path, gs, os_) / denom
            if coeff is not None:
                grad = grad * coeff
            p_blk = self._slice_of(p.detach(), path, ps, os_)
            moments = {mk: {"p": _at(tree, path)}
                       for mk, tree in opt_state.moments.items()}
            new_p, new_os = self.opt.step(
                {"p": p_blk}, {"p": grad},
                OptimizerState(step=opt_state.step, moments=moments), lr)
            kept = torch.where(overflow, p_blk, new_p["p"])
            p.copy_(self._gather_from(kept, os_, ps))
            for mk, sub in new_os.moments.items():
                old = moments[mk]["p"]
                old.copy_(torch.where(overflow, old, sub["p"]))
            acc.zero_()
            new_step = new_os.step
        one = torch.ones_like(state.global_step)
        zero = torch.zeros_like(state.global_step)
        self.state = state._replace(
            opt_state=OptimizerState(
                step=torch.where(overflow, opt_state.step, new_step),
                moments=opt_state.moments),
            scale_state=self._next_scale_state(state.scale_state, overflow),
            global_step=state.global_step + torch.where(overflow, zero, one),
            skipped_steps=state.skipped_steps
            + torch.where(overflow, one, zero))
        return {"grad_norm": gnorm, "lr": lr, "overflow": overflow,
                "loss_scale": scale}

    def _grad_norm(self, denom):
        """Global norm of the unscaled accumulated gradients (before
        clipping), and whether it is non-finite."""
        sumsq = 0
        for acc in tree_leaves(self.state.grad_acc):
            # a large leaf a piece at a time: its temporaries stay small
            pieces = (acc.view(-1).split(PIECE_ELEMS)
                      if acc.numel() > PIECE_ELEMS else (acc,))
            for piece in pieces:
                sumsq = sumsq + torch.sum(torch.square(piece / denom))
        gnorm = torch.sqrt(sumsq)
        return gnorm, ~torch.isfinite(gnorm)

    def _next_scale_state(self, ss: ScaleState, overflow) -> ScaleState:
        """The dynamic loss scale automaton with hysteresis; runs only for
        fp16 with ``loss_scale == 0``."""
        if not (self.fp16_enabled and self.dynamic_loss_scale):
            return ss
        fpc = self.config.fp16
        zero = torch.zeros_like(ss.good_steps)
        # on overflow
        new_h = torch.clamp(ss.hysteresis - 1, min=0)
        shrink = new_h <= 0
        o_scale = torch.where(
            shrink, torch.clamp(ss.scale / 2.0, min=fpc.min_loss_scale),
            ss.scale)
        o_hyst = torch.where(shrink, torch.full_like(new_h, fpc.hysteresis),
                             new_h)
        # on a good step
        grown = ss.good_steps + 1 >= fpc.loss_scale_window
        g_scale = torch.where(grown, ss.scale * 2.0, ss.scale)
        g_good = torch.where(grown, zero, ss.good_steps + 1)
        return ScaleState(
            scale=torch.where(overflow, o_scale, g_scale),
            good_steps=torch.where(overflow, zero, g_good),
            hysteresis=torch.where(overflow, o_hyst, ss.hysteresis))

    @torch.no_grad()
    def _update(self):
        """unscale → clip → (overflow-gated) optimizer step → new scale."""
        if self._mesh:
            return self._update_mesh()
        state = self.state
        gas = self.gradient_accumulation_steps()
        clip = self.config.gradient_clipping
        scale = state.scale_state.scale
        denom = scale * gas / self._predivide()
        gnorm, overflow = self._grad_norm(denom)
        coeff = None
        if clip > 0:
            coeff = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
        lr = self.schedule(state.global_step)
        plan = self._offload_plan
        # the host lr follows the device counter, which an overflow-skipped
        # step does not advance (the host mirror does)
        lr_host = (float(self.schedule(int(state.global_step)))
                   if plan is not None else None)
        opt_state = state.opt_state
        new_step = opt_state.step + 1
        for p, acc, leaf_moments in self._device_leaves():
            moments = {mk: {"p": m} for mk, m in leaf_moments.items()}
            grad = acc / denom
            if coeff is not None:
                grad = grad * coeff
            new_p, new_os = self.opt.step(
                {"p": p}, {"p": grad},
                OptimizerState(step=opt_state.step, moments=moments), lr)
            # an overflow skips the step: keep the old values
            p.copy_(torch.where(overflow, p, new_p["p"]))
            for mk, sub in new_os.moments.items():
                old = moments[mk]["p"]
                old.copy_(torch.where(overflow, old, sub["p"]))
            acc.zero_()
            new_step = new_os.step
        if plan is not None:
            if not bool(overflow):
                self._offload_update(denom, coeff, lr_host)
            accs = tree_leaves(state.grad_acc)
            for i in plan.offloaded:
                accs[i].zero_()
        one = torch.ones_like(state.global_step)
        zero = torch.zeros_like(state.global_step)
        self.state = state._replace(
            opt_state=OptimizerState(
                step=torch.where(overflow, opt_state.step, new_step),
                moments=opt_state.moments),
            scale_state=self._next_scale_state(state.scale_state, overflow),
            global_step=state.global_step + torch.where(overflow, zero, one),
            skipped_steps=state.skipped_steps
            + torch.where(overflow, one, zero))
        return {"grad_norm": gnorm, "lr": lr, "overflow": overflow,
                "loss_scale": scale}

    def _device_leaves(self):
        """(param, accumulator, {moment kind: moment}) for each leaf that
        the device optimizer updates: every leaf, or under offload the
        plan's kept leaves."""
        st = self.state
        moments = st.opt_state.moments
        plan = self._offload_plan
        if plan is None:
            return [(p, _at(st.grad_acc, path),
                     {mk: _at(tree, path) for mk, tree in moments.items()})
                    for path, p in _paths(st.params)]
        params, accs = tree_leaves(st.params), tree_leaves(st.grad_acc)
        return [(params[i], accs[i],
                 {mk: tree[str(i)] for mk, tree in moments.items()})
                for i in plan.kept]

    @torch.no_grad()
    def _offload_update(self, denom, coeff, lr: float):
        """The host step of the offloaded leaves, a piece of at most
        ``PIECE_ELEMS`` elements at a time: the piece's unscaled, clipped
        gradient goes to a staging buffer, the C++ optimizer updates the
        piece's masters and moments on the one worker thread while the
        next piece transfers, and each updated piece of masters is copied
        back into the device's param leaf in place. ``offload_timings``
        keeps the step's seconds in each part (the transfers on this
        thread; the optimizer, and under NVMe the moments' file reads and
        writes, on the worker) and its element count."""
        plan = self._offload_plan
        params = tree_leaves(self.state.params)
        units = [(i, lo, hi) for i in plan.offloaded
                 for lo, hi in plan.pieces(i, self._stages[0].numel())]
        states: Dict[int, dict] = {}
        times = {"d2h_s": 0.0, "adam_s": 0.0, "swap_s": 0.0, "h2d_s": 0.0,
                 "elements": sum(plan.masters[i].size
                                 for i in plan.offloaded)}
        cuda = self.device.type == "cuda"

        def host_step(i, lo, hi, grad):
            t0 = time.perf_counter()
            if lo == 0:
                states[i] = plan.leaf_state(i)
            t1 = time.perf_counter()
            plan.update_piece(i, states[i], lo, grad, lr)
            t2 = time.perf_counter()
            if hi == plan.masters[i].size:
                plan.finish_leaf(i, states.pop(i))
            times["adam_s"] += t2 - t1
            times["swap_s"] += t1 - t0 + time.perf_counter() - t2

        def copy_back(i, lo, hi):
            t = time.perf_counter()
            params[i].view(-1)[lo:hi].copy_(
                plan.master_tensors[i].view(-1)[lo:hi])
            times["h2d_s"] += time.perf_counter() - t

        t_all = time.perf_counter()
        futures = []
        for u, (i, lo, hi) in enumerate(units):
            if u >= 2:      # the piece that last used this staging buffer
                futures[u - 2].result()
                copy_back(*units[u - 2])
            t = time.perf_counter()
            grad = params[i].grad.view(-1)[lo:hi] / denom
            if coeff is not None:
                grad = grad * coeff
            stage = self._stages[u % 2][:hi - lo]
            stage.copy_(grad, non_blocking=plan.pinned)
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
            times["d2h_s"] += time.perf_counter() - t
            futures.append(self._offload_pool.submit(
                host_step, i, lo, hi, stage.numpy()))
        for u in range(max(0, len(units) - 2), len(units)):
            futures[u].result()
            copy_back(*units[u])
        times["wall_s"] = time.perf_counter() - t_all
        self.offload_timings = times

    # ------------------------------------------------------------- data plumbing
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None,
                     num_local_io_workers=None, data_sampler=None,
                     route=None):
        """A loader over ``dataset``, shuffled from the config's seed: of
        global micro batches (micro × DP world) in one process, of this
        rank's micro batches over a mesh (the loader reads the strided
        share of the rank's data-parallel index, which its tensor peers
        share)."""
        global_micro = self.train_micro_batch_size_per_gpu() * (
            1 if self._mesh else self.dp_world_size)
        return DeepSpeedTpuDataLoader(
            dataset, batch_size=batch_size or global_micro,
            topology=self.topology if self._mesh else None,
            collate_fn=collate_fn, seed=self.config.seed,
            data_sampler=data_sampler)

    def _device_batch(self, batch):
        """A host batch (dict, tuple or array) as a dict of tensors on the
        engine's device."""
        def put(x):
            if not torch.is_tensor(x):
                x = torch.as_tensor(np.asarray(x))
            return x.to(self.device)

        if isinstance(batch, dict):
            return {k: put(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return {"input_ids": put(batch[0]), "labels": put(batch[1])} \
                if len(batch) == 2 else {"input_ids": put(batch[0])}
        return {"input_ids": put(batch)}

    # ----------------------------------------------------------------- API
    def __call__(self, batch, *args, **kwargs):
        return self.forward(batch, *args, **kwargs)

    def forward(self, batch, *args, **kwargs):
        """Run forward, backward and accumulation for one micro batch;
        returns the (unscaled) loss as a 0-d tensor."""
        self.tput_timer.start()
        batch = self._device_batch(batch)
        if self._profile_steps:
            fwd_timer = self.timers(FORWARD_MICRO_TIMER)
            fwd_timer.start()
            span = self.tracer.begin("fwd_bwd", trace_id="train",
                                     attrs={"micro_step": self.micro_steps})
            loss = self._micro(batch)
            fwd_timer.stop(record=True)
            span.end()
        else:
            loss = self._micro(batch)
        self._pending_loss = loss
        if self.config.check_numerics and not self.fp16_enabled \
                and not np.isfinite(float(loss)):
            raise FloatingPointError(
                f"check_numerics: non-finite loss {float(loss)} at micro "
                f"step {self.micro_steps}; offending state leaves: "
                f"{self._numerics_scan()}")
        return loss

    def _numerics_scan(self):
        """The paths of non-finite leaves among params and accumulated
        grads."""
        tree = {"params": self.state.params, "grad_acc": self.state.grad_acc}
        return sorted(".".join(path) for path, leaf in _paths(tree)
                      if not bool(torch.isfinite(leaf.detach()).all()))

    def backward(self, loss=None, retain_graph=False):
        """API parity: the gradients were produced in ``forward``; this
        advances the micro-step counter."""
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self):
        """The optimizer step, at an accumulation boundary."""
        if not self.is_gradient_accumulation_boundary():
            return
        pre_scan = (self._numerics_scan()
                    if self.config.check_numerics and not self.fp16_enabled
                    else None)
        if self._profile_steps:
            step_timer = self.timers(STEP_GLOBAL_TIMER)
            step_timer.start()
            opt_span = self.tracer.begin(
                "optimizer_step", trace_id="train",
                attrs={"global_step": self.global_steps})
        metrics = self._update()
        if self._profile_steps:
            step_timer.stop(record=True)   # synced: real update duration
            opt_span.set("skipped",
                         bool(metrics.get("overflow", False))).end()
        if pre_scan is not None \
                and not np.isfinite(float(metrics["grad_norm"])):
            raise FloatingPointError(
                f"check_numerics: non-finite grad norm at step "
                f"{self.global_steps}; offending state leaves: {pre_scan}")
        self.global_steps += 1
        self.lr_scheduler.step()
        self._last_metrics = metrics
        report = self.global_steps % self.config.steps_per_print == 0
        self.tput_timer.stop(report_speed=report)
        if report:
            m = {k: float(v) for k, v in metrics.items()}
            log_dist(
                f"step={self.global_steps} "
                f"loss={float(self._pending_loss):.4f} "
                f"lr={m['lr']:.3e} grad_norm={m['grad_norm']:.3f} "
                f"loss_scale={m['loss_scale']:.0f}", ranks=[0])
            if self._profile_steps:
                names = [n for n in (FORWARD_MICRO_TIMER, STEP_GLOBAL_TIMER)
                         if self.timers.has(n)]
                self.timers.log(names,
                                normalizer=self.config.steps_per_print)
        return metrics

    def train_batch(self, data_iter=None):
        """A full effective batch: GAS micro steps and the update; returns
        the mean of the micro losses.

        The no-argument form keeps one persistent iterator across calls, so
        that successive calls walk the dataset instead of restarting it; the
        loader repeats across epochs via ``RepeatingLoader``.
        """
        if data_iter is not None:
            it = data_iter
        else:
            if self._data_iter is None:
                loader = self.training_dataloader
                if loader is None:
                    raise ValueError("train_batch() without a data_iter "
                                     "needs training_data at initialize()")
                if not isinstance(loader, RepeatingLoader):
                    loader = RepeatingLoader(loader)
                self._data_iter = iter(loader)
            it = self._data_iter
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            losses.append(self.forward(next(it)))
            self.backward()
        self.step()
        loss = torch.mean(torch.stack(losses))
        if self._mesh:    # the mean over the DP ranks: the global batch's
            loss = dist.all_reduce(loss, dist.ReduceOp.AVG, None)
        return loss

    def reset_data_iterator(self):
        """Drop the persistent no-argument ``train_batch`` iterator, so that
        the next call rebuilds it from the loader's current position."""
        self._data_iter = None

    @torch.no_grad()
    def eval_batch(self, batch):
        return self.module.loss(self.state.params, self._device_batch(batch),
                                None)

    # ------------------------------------------------------------- accessors
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    @property
    def optimizer(self):
        return self.opt

    def get_lr(self):
        # the device counter is authoritative: it does not count
        # overflow-skipped steps, which the host mirror does
        return [float(self.schedule(int(self.state.global_step)))]

    def get_global_grad_norm(self) -> Optional[float]:
        m = self._last_metrics
        return float(m["grad_norm"]) if m else None

    @property
    def loss_scale(self) -> float:
        return float(self.state.scale_state.scale)

    @property
    def skipped_steps(self) -> int:
        """Overflow-skipped steps, read from the device counter."""
        return int(self.state.skipped_steps)

    def zero_optimization(self) -> bool:
        return self.zero_stage > 0

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def close(self):
        """Release ZeRO-Offload's host resources (the host-step thread, the
        page-locked masters, the moment files' handles); the engine takes
        no step after it. A no-op without offload."""
        if self._offload_plan is not None:
            self._offload_pool.shutdown(wait=True)
            self._offload_plan.close()

    # ---------------------------------------------------------- checkpointing
    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, exclude_frozen_parameters=False,
                        async_save=False, urgent=False):
        """Write the train state as a universal checkpoint (the JAX
        package's layout; ``runtime/checkpointing.py``); returns the tag
        directory."""
        from .checkpointing import save_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state or {},
                     save_latest=save_latest, async_save=async_save,
                     urgent=urgent)

    def wait_pending_checkpoint(self):
        """Join an ``async_save``'s background writes and commit it."""
        from .checkpointing import wait_pending_save

        wait_pending_save(self)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Load a universal checkpoint in place; returns ``(path,
        client_state)``, or ``(None, {})`` when ``load_dir`` has no
        ``latest``."""
        from .checkpointing import load_checkpoint as _load

        return _load(self, load_dir, tag=tag,
                     load_optimizer_states=load_optimizer_states,
                     load_module_only=load_module_only)

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin",
                         exclude_frozen_parameters=False):
        """The params in the compute precision as one ``.npz``."""
        from .checkpointing import save_16bit_model as _save16

        return _save16(self, save_dir, save_filename)
