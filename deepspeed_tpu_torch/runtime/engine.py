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

Single device only: a mesh, ZeRO stage > 0, MiCS, hpZ, ZeRO++, offload,
1-bit optimizers, pipeline and sequence parallelism, MoE, curriculum,
compression, elasticity, monitors, the flops profiler, telemetry and
checkpoint save/load raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import not_ported, resolve_device
from ..models.transformer import CausalLM
from ..models.weights import params_from_numpy
from ..ops.optimizers import OptimizerState, build_optimizer, tree_leaves
from ..utils.logging import log_dist
from ..utils.timer import (FORWARD_MICRO_TIMER, STEP_GLOBAL_TIMER,
                           SynchronizedWallClockTimer, ThroughputTimer)
from .config import DeepSpeedTpuConfig, DtypeEnum, load_config
from .dataloader import DeepSpeedTpuDataLoader, RepeatingLoader
from .lr_schedules import LRSchedulerShim, build_schedule


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
        if mesh is not None:
            raise not_ported("a device mesh (the engine runs on one device)",
                             "queue 1 item 14")
        self.config.raise_if_not_ported()
        self.dp_world_size = 1
        self.config.resolve_batch_sizes(self.dp_world_size)

        # -- model ---------------------------------------------------------
        self.module = self._resolve_model(model)
        self.zero_stage = self.config.zero_optimization.stage

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

        # -- state ---------------------------------------------------------
        self._seed = int(self.config.seed if rng is None else rng)
        self.state = self._init_state(model_parameters)

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
            f"zero_stage={self.zero_stage} precision={self.precision.value} "
            f"micro_batch={self.train_micro_batch_size_per_gpu()} "
            f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------ setup
    def _resolve_model(self, model):
        if model is None:
            raise ValueError("model is required")
        if isinstance(model, str):
            raise not_ported("a model given by name (models.build_model)",
                             "queue 1 item 16")
        cfg = getattr(model, "cfg", None)
        if cfg is not None and getattr(cfg, "dropout", 0.0) > 0:
            raise not_ported("training with dropout > 0 (the masks would "
                             "have to equal jax.random's)", "queue 1 item 17")
        return model

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _model_dtype_override(self):
        """Push the engine's precision into the model config when the model
        is a framework CausalLM."""
        if not isinstance(self.module, CausalLM):
            return
        if self.module.cfg.dtype != self.compute_dtype:
            self.module = CausalLM(dataclasses.replace(
                self.module.cfg, dtype=self.compute_dtype))

    def _scalar(self, value, dtype):
        return torch.tensor(value, dtype=dtype, device=self.device)

    def _init_state(self, model_parameters=None) -> TrainState:
        self._model_dtype_override()
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
        with torch.no_grad():
            opt_state = self.opt.init(params)
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

    # ----------------------------------------------------------- step programs
    def _predivide(self) -> float:
        return float(self.dp_world_size) \
            if self.config.prescale_gradients else 1.0

    def _micro(self, batch):
        """Forward, backward and accumulate for one micro batch; the loss is
        scaled by ``scale / (dp_size if predivide else 1)`` before the
        gradient."""
        state = self.state
        loss = self.module.loss(state.params, batch, None)
        scaled = (loss * state.scale_state.scale
                  / self._predivide()).to(torch.float32)
        scaled.backward()
        for path, p in _paths(state.params):
            if p.grad.data_ptr() != _at(state.grad_acc, path).data_ptr():
                raise RuntimeError(
                    f"autograd replaced the accumulator of {'.'.join(path)} "
                    "instead of adding into it")
        return loss.detach()

    def _grad_norm(self, denom):
        """Global norm of the unscaled accumulated gradients (before
        clipping), and whether it is non-finite."""
        sumsq = 0
        for acc in tree_leaves(self.state.grad_acc):
            sumsq = sumsq + torch.sum(torch.square(acc / denom))
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
        opt_state = state.opt_state
        new_step = opt_state.step
        for path, p in _paths(state.params):
            acc = _at(state.grad_acc, path)
            moments = {mk: {"p": _at(tree, path)}
                       for mk, tree in opt_state.moments.items()}
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

    # ------------------------------------------------------------- data plumbing
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None,
                     num_local_io_workers=None, data_sampler=None,
                     route=None):
        """A loader of global micro batches (micro × DP world) over
        ``dataset``, shuffled from the config's seed."""
        global_micro = (self.train_micro_batch_size_per_gpu()
                        * self.dp_world_size)
        return DeepSpeedTpuDataLoader(
            dataset, batch_size=batch_size or global_micro,
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
        return torch.mean(torch.stack(losses))

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

    # ---------------------------------------------------------- checkpointing
    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        **kwargs):
        raise not_ported("save_checkpoint (runtime/checkpointing.py)",
                         "queue 1 item 13")

    def load_checkpoint(self, load_dir, tag=None, **kwargs):
        raise not_ported("load_checkpoint (runtime/checkpointing.py)",
                         "queue 1 item 13")
