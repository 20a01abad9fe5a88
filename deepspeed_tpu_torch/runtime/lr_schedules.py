"""LR schedules: WarmupLR / WarmupDecayLR / WarmupCosineLR / OneCycle /
LRRangeTest / constant.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``: each schedule is a
pure function ``step -> lr`` in fp32, built from the same operations in the
same order. ``step`` may be a Python number or a 0-d tensor; a tensor gives a
0-d fp32 tensor on its device (the engine feeds the device's step counter
and hands the result to the optimizer with no host round trip), a number
gives a 0-d fp32 CPU tensor. ``float()`` of either is the lr.
``LRSchedulerShim`` is the host-side ``get_lr``/``step``/``state_dict`` API.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Schedule = Callable[[object], torch.Tensor]


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def warmup_lr(warmup_min_lr=0.0, warmup_max_lr=0.001, warmup_num_steps=1000,
              warmup_type="log", **_) -> Schedule:
    """WarmupLR: warm up (log or linear ramp), then hold."""
    warmup_num_steps = max(2, warmup_num_steps)

    def sched(step):
        s = _f32(step)
        frac = torch.clamp(s / warmup_num_steps, 0.0, 1.0)
        if warmup_type == "log":
            gamma = torch.log1p(s) / math.log(1 + warmup_num_steps)
            gamma = torch.clamp(gamma, 0.0, 1.0)
        else:
            gamma = frac
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return sched


def warmup_decay_lr(total_num_steps, warmup_min_lr=0.0, warmup_max_lr=0.001,
                    warmup_num_steps=1000, warmup_type="log", **_) -> Schedule:
    """WarmupLR, then linear decay to ``warmup_min_lr`` at
    ``total_num_steps``."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def sched(step):
        s = _f32(step)
        decay = torch.clamp(
            (total_num_steps - s)
            / max(1.0, total_num_steps - warmup_num_steps), 0.0, 1.0)
        decayed = warmup_min_lr + (warmup_max_lr - warmup_min_lr) * decay
        return torch.where(s < warmup_num_steps, base(step), decayed)

    return sched


def warmup_cosine_lr(total_num_steps, warmup_min_ratio=0.0,
                     warmup_num_steps=1000, cos_min_ratio=0.0001, lr=0.001,
                     **_) -> Schedule:
    """Linear warmup from ``warmup_min_ratio * lr``, cosine to
    ``cos_min_ratio * lr``."""

    def sched(step):
        s = _f32(step)
        warm = warmup_min_ratio + (1 - warmup_min_ratio) * torch.clamp(
            s / max(1, warmup_num_steps), 0.0, 1.0)
        progress = torch.clamp(
            (s - warmup_num_steps)
            / max(1.0, total_num_steps - warmup_num_steps), 0.0, 1.0)
        cos = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * progress))
        ratio = torch.where(s < warmup_num_steps, warm, cos)
        return lr * ratio

    return sched


def one_cycle(cycle_min_lr, cycle_max_lr, cycle_first_step_size=2000,
              cycle_second_step_size=None, decay_step_size=0,
              decay_lr_rate=0.0, **_) -> Schedule:
    """OneCycle, the lr part: ramp min→max over the first phase, max→min
    over the second, then decay."""
    second = cycle_second_step_size if cycle_second_step_size is not None \
        else cycle_first_step_size
    total = cycle_first_step_size + second

    def sched(step):
        s = _f32(step)
        up = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * torch.clamp(
            s / cycle_first_step_size, 0.0, 1.0)
        down = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * torch.clamp(
            (s - cycle_first_step_size) / max(1, second), 0.0, 1.0)
        in_cycle = torch.where(s < cycle_first_step_size, up, down)
        if decay_step_size > 0:
            decay_steps = torch.clamp(s - total, min=0.0) / decay_step_size
            post = cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
        else:
            post = torch.full_like(s, cycle_min_lr)
        return torch.where(s <= total, in_cycle, post)

    return sched


def lr_range_test(lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                  lr_range_test_step_rate=1.0, lr_range_test_staircase=False,
                  **_) -> Schedule:
    """LRRangeTest: an lr sweep for tuning."""

    def sched(step):
        s = _f32(step)
        interval = torch.floor(s / lr_range_test_step_size) \
            if lr_range_test_staircase else s / lr_range_test_step_size
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return sched


def constant_lr(lr=0.001, **_) -> Schedule:
    def sched(step):
        return torch.full_like(_f32(step), lr)

    return sched


SCHEDULES = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "onecycle": one_cycle,
    "lrrangetest": lr_range_test,
    "constant": constant_lr,
}


def build_schedule(type_name: Optional[str], params: Optional[dict] = None,
                   fallback_lr: float = 1e-3) -> Schedule:
    if type_name is None:
        return constant_lr(lr=fallback_lr)
    key = type_name.lower().replace("_", "")
    if key not in SCHEDULES:
        raise ValueError(f"Unknown scheduler {type_name!r}; "
                         f"known: {sorted(SCHEDULES)}")
    return SCHEDULES[key](**(params or {}))


class LRSchedulerShim:
    """Host-side wrapper giving the scheduler API (``get_lr``/
    ``get_last_lr``/``step``/``state_dict``) over a pure schedule.

    With a ``step_source`` callable (the engine wires the device train
    state's ``global_step``, which does not advance on overflow-skipped
    steps), ``get_lr``/``state_dict`` can never drift from the lr the update
    applied. The host ``last_step`` mirror is the fallback for standalone
    use."""

    def __init__(self, schedule: Schedule, start_step: int = 0,
                 step_source=None):
        self.schedule = schedule
        self.last_step = start_step
        self.step_source = step_source

    def _current_step(self) -> int:
        if self.step_source is not None:
            return int(self.step_source())
        return self.last_step

    def step(self, increment: int = 1):
        self.last_step += increment

    def get_lr(self):
        return [float(self.schedule(self._current_step()))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_step": self._current_step()}

    def load_state_dict(self, sd):
        self.last_step = sd["last_step"]
