"""Pipeline parallelism's host-level API (the port of
``deepspeed_tpu.runtime.pipe``): topology, instruction schedules, layer
specs and the host-driven ``PipelineEngine``."""

from .topology import (ProcessTopology, PipeModelDataParallelTopology,  # noqa: F401
                       PipeDataParallelTopology)
from .schedule import (  # noqa: F401
    TrainSchedule, InferenceSchedule, PipeSchedule,
    ForwardPass, BackwardPass, SendActivation, RecvActivation,
    SendGrad, RecvGrad, LoadMicroBatch, ReduceGrads, ReduceTiedGrads,
    OptimizerStep)
from .module import LayerSpec, TiedLayerSpec, PipelineModule  # noqa: F401
from .engine import PipelineEngine  # noqa: F401
