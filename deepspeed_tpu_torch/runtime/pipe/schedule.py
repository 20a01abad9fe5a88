"""Pipeline instruction schedules (1F1B and inference).

The port's own copy of ``deepspeed_tpu/runtime/pipe/schedule.py``, whose
instruction streams it keeps element for element: ``TrainSchedule`` (1F1B),
``InferenceSchedule`` and the instruction classes. The model's pipeline
(``parallel/pipeline.py``) does not interpret them; they drive the
host-level executor (``runtime/pipe/engine.py`` ``PipelineEngine``), which
runs the streams with real dataflow for the classic
``PipelineModule``/``LayerSpec`` API.
"""

from __future__ import annotations


class PipeInstruction:
    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        if self.kwargs:
            inner = ", ".join(f"{k}={v}" for k, v in self.kwargs.items())
            return f"{self.name}({inner})"
        return self.name

    def __eq__(self, other):
        return repr(self) == repr(other)


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class BufferOpInstruction(PipeInstruction):
    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    pass


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass


def _is_even(x):
    return x % 2 == 0


class PipeSchedule:
    """Base generator (reference schedule.py:13): yields per-step lists of
    instructions for one stage."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    @property
    def num_pipe_buffers(self):
        return self.micro_batches

    def steps(self):
        raise NotImplementedError

    def __iter__(self):
        return iter(self.steps())

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _valid_micro_batch(self, micro_batch_id):
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id):
        return 0 <= stage_id < self.stages

    def _buffer_idx(self, micro_batch_id):
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers


class InferenceSchedule(PipeSchedule):
    """Forward-only fill-drain (reference schedule.py:135)."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        out = []
        for step_id in range(total_steps):
            cmds = []
            micro_batch_id = step_id - self.stage_id
            if self._valid_micro_batch(micro_batch_id):
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(self._buffer_idx(micro_batch_id)))
                if self._valid_stage(self.prev_stage) and not self.is_first_stage:
                    cmds.append(RecvActivation(self._buffer_idx(micro_batch_id)))
                cmds.append(ForwardPass(self._buffer_idx(micro_batch_id)))
                if self._valid_stage(self.next_stage) and not self.is_last_stage:
                    cmds.append(SendActivation(self._buffer_idx(micro_batch_id)))
            out.append(cmds)
        return out


class TrainSchedule(PipeSchedule):
    """1F1B (reference schedule.py:189): alternate forward/backward per step
    with warm-up and cool-down; grad reduction + optimizer step at the end."""

    @property
    def num_pipe_buffers(self):
        buffers = min(self.stages - self.stage_id, self.micro_batches)
        return max(2, buffers)

    def _step_to_micro_batch(self, step_id):
        """Map step to (micro_batch, is_forward) — reference :252."""
        if _is_even(step_id) and _is_even(self.stage_id):
            micro_batch_id = self._even_step_forward_id(step_id)
            is_forward = True
        elif not _is_even(step_id) and not _is_even(self.stage_id):
            micro_batch_id = self._odd_step_forward_id(step_id)
            is_forward = True
        elif _is_even(step_id) and not _is_even(self.stage_id):
            micro_batch_id = self._even_step_backward_id(step_id)
            is_forward = False
        else:
            micro_batch_id = self._odd_step_backward_id(step_id)
            is_forward = False
        return micro_batch_id, is_forward

    def _even_step_forward_id(self, step_id):
        return step_id // 2 - self.stage_id // 2

    def _odd_step_forward_id(self, step_id):
        return (step_id - 1) // 2 - self.stage_id // 2

    def _even_step_backward_id(self, step_id):
        # only reached for odd stages (even step + odd stage → backward)
        return step_id // 2 - self.stages + (self.stage_id + 1) // 2

    def _odd_step_backward_id(self, step_id):
        # only reached for even stages
        return (step_id - 1) // 2 - self.stages + 1 + self.stage_id // 2

    def steps(self):
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        out = []
        prev_micro_batch_id = -1
        for step_id in range(total_steps):
            micro_batch_id, is_forward = self._step_to_micro_batch(step_id)
            cmds = []
            if self._valid_micro_batch(prev_micro_batch_id):
                prev_buffer = self._buffer_idx(prev_micro_batch_id)
                if is_forward:
                    # previous step was a backward → its grad goes upstream
                    if self._valid_stage(self.prev_stage):
                        cmds.append(SendGrad(prev_buffer))
                else:
                    # previous step was a forward → activations go downstream
                    if self._valid_stage(self.next_stage):
                        cmds.append(SendActivation(prev_buffer))
            if self._valid_micro_batch(micro_batch_id):
                curr_buffer = self._buffer_idx(micro_batch_id)
                if is_forward:
                    if self.is_first_stage:
                        cmds.append(LoadMicroBatch(curr_buffer))
                    elif self._valid_stage(self.prev_stage):
                        cmds.append(RecvActivation(curr_buffer))
                    cmds.append(ForwardPass(curr_buffer))
                else:
                    if self._valid_stage(self.next_stage):
                        cmds.append(RecvGrad(curr_buffer))
                    cmds.append(BackwardPass(curr_buffer))
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())
            prev_micro_batch_id = micro_batch_id
            out.append(cmds)
        return out
