"""The framework's JSON config system.

Counterpart of ``deepspeed_tpu/runtime/config.py``: the same key names,
defaults and unknown-key behaviour (``train_batch_size``,
``zero_optimization``, ``fp16``/``bf16``, ``optimizer``/``scheduler``,
``activation_checkpointing``, monitors, ``flops_profiler``, ``mesh``, ...),
as dataclasses over ``config_utils.DSConfigModel`` instead of pydantic
models. Every block is parsed. The blocks whose feature the port does not
run yet stay in the config, and ``DeepSpeedTpuConfig.raise_if_not_ported``
(called by the engine) raises ``NotImplementedError`` naming the ROADMAP
item when one of them is switched on: nothing is silently ignored. The
serving blocks (``serving`` and its flat aliases ``prefix_cache``,
``speculative``, ``kv_quant``, ``weight_quant``, ``kv_tier``,
``admission``) are the typed blocks of ``serving/config.py``, and
``telemetry`` is ``telemetry/config.py``'s ``TelemetryConfig``: the
training engine builds its tracer from it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Union

import torch

from .. import not_ported
from ..utils.logging import logger
from ..serving.config import (AdmissionConfig, KVQuantConfig, KVTierConfig,
                              PrefixCacheConfig, ServingConfig,
                              SpeculativeConfig, WeightQuantConfig)
from ..telemetry.config import TelemetryConfig
from .config_utils import (AUTO, DSConfigModel,  # noqa: F401
                           dict_raise_error_on_duplicate_keys)

TRAIN_BATCH_SIZE_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None
STEPS_PER_PRINT_DEFAULT = 10


class DtypeEnum(str, Enum):
    fp32 = "fp32"
    fp16 = "fp16"
    bf16 = "bf16"

    def to_torch(self) -> torch.dtype:
        return {"fp32": torch.float32, "fp16": torch.float16,
                "bf16": torch.bfloat16}[self.value]


class OffloadDeviceEnum(str, Enum):
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


@dataclass(init=False, eq=False, repr=False)
class FP16Config(DSConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


@dataclass(init=False, eq=False, repr=False)
class BF16Config(DSConfigModel):
    enabled: bool = False
    immediate_grad_update: bool = False


@dataclass(init=False, eq=False, repr=False)
class OptimizerConfig(DSConfigModel):
    """{"type": "Adam"|"AdamW"|"Lamb"|"Lion"|"SGD"|..., "params": {...}}"""
    type: str = "Adam"
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass(init=False, eq=False, repr=False)
class SchedulerConfig(DSConfigModel):
    """{"type": "WarmupLR"|"WarmupDecayLR"|"WarmupCosineLR"|"OneCycle"|
    "LRRangeTest", "params": {...}}"""
    type: str = "WarmupLR"
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass(init=False, eq=False, repr=False)
class OffloadParamConfig(DSConfigModel):
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = int(1e8)
    max_in_cpu: int = int(1e9)
    pin_memory: bool = False


@dataclass(init=False, eq=False, repr=False)
class OffloadOptimizerConfig(DSConfigModel):
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0


@dataclass(init=False, eq=False, repr=False)
class ZeroConfig(DSConfigModel):
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[OffloadParamConfig] = None
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    sub_group_size: int = int(1e9)
    cpu_offload_param: Optional[bool] = None
    cpu_offload_use_pin_memory: Optional[bool] = None
    cpu_offload: Optional[bool] = None
    prefetch_bucket_size: int = int(5e7)
    param_persistence_threshold: int = int(1e5)
    model_persistence_threshold: int = int(1e9)
    max_live_parameters: int = int(1e9)
    max_reuse_distance: int = int(1e9)
    gather_16bit_weights_on_model_save: bool = False
    stage3_gather_fp16_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    memory_efficient_linear: bool = True
    pipeline_loading_checkpoint: bool = False
    override_module_apply: bool = True

    @classmethod
    def _before(cls, values):
        if values.get("cpu_offload") and not values.get("offload_optimizer"):
            values["offload_optimizer"] = {"device": "cpu"}
        if values.get("cpu_offload_param") and not values.get("offload_param"):
            values["offload_param"] = {"device": "cpu"}
        return values


@dataclass(init=False, eq=False, repr=False)
class ActivationCheckpointingConfig(DSConfigModel):
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclass(init=False, eq=False, repr=False)
class CommsLoggerConfig(DSConfigModel):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


@dataclass(init=False, eq=False, repr=False)
class MonitorBackendConfig(DSConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass(init=False, eq=False, repr=False)
class WandbConfig(DSConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed_tpu"


@dataclass(init=False, eq=False, repr=False)
class CSVConfig(DSConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass(init=False, eq=False, repr=False)
class FlopsProfilerConfig(DSConfigModel):
    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 3
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclass(init=False, eq=False, repr=False)
class AioConfig(DSConfigModel):
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


@dataclass(init=False, eq=False, repr=False)
class PipelineConfig(DSConfigModel):
    stages: int = 1
    partition_method: str = "parameters"
    seed_layers: bool = False
    activation_checkpoint_interval: int = 0
    pipe_partitioned: bool = True
    grad_partitioned: bool = True
    micro_batches: Optional[int] = None


@dataclass(init=False, eq=False, repr=False)
class MeshConfig(DSConfigModel):
    """Sizes of the named mesh axes; -1 on the data axis means "all
    remaining devices"."""
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    pipe: int = 1
    sequence: int = 1
    expert: int = 1
    axis_order: List[str] = field(
        default_factory=lambda: ["pipe", "data", "fsdp", "sequence", "expert",
                                 "tensor"])


@dataclass(init=False, eq=False, repr=False)
class CheckpointConfig(DSConfigModel):
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = field(default_factory=dict)
    async_save: bool = False


@dataclass(init=False, eq=False, repr=False)
class DataTypesConfig(DSConfigModel):
    grad_accum_dtype: Optional[str] = None


@dataclass(init=False, eq=False, repr=False)
class ElasticityConfig(DSConfigModel):
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    version: float = 0.2
    ignore_non_elastic_batch_info: bool = False
    prefer_larger_batch: bool = True
    model_parallel_size: int = 1
    num_gpus_per_node: int = 1


@dataclass(init=False, eq=False, repr=False)
class HybridEngineConfig(DSConfigModel):
    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8


@dataclass(init=False, eq=False, repr=False)
class AutotuningConfig(DSConfigModel):
    enabled: bool = False
    fast: bool = True
    results_dir: str = "autotuning_results"
    exps_dir: str = "autotuning_exps"
    overwrite: bool = False
    metric: str = "throughput"
    start_profile_step: int = 3
    end_profile_step: int = 5
    num_tuning_micro_batch_sizes: int = 3
    tuner_type: str = "gridsearch"
    tuner_early_stopping: int = 5
    tuner_num_trials: int = 50
    arg_mappings: Dict[str, str] = field(default_factory=dict)


class DeepSpeedConfigError(Exception):
    pass


def _dict_block_on(block: Dict[str, Any]) -> bool:
    """Is a block kept as a plain dict switched on (itself or a
    sub-block)?"""
    if not isinstance(block, dict):
        return bool(block)
    if block.get("enabled"):
        return True
    return any(_dict_block_on(v) for v in block.values()
               if isinstance(v, dict))


@dataclass(init=False, eq=False, repr=False)
class DeepSpeedTpuConfig(DSConfigModel):
    """Top-level config, including the batch-size triple resolution:
    train_batch_size = micro_batch_per_device × gradient_accumulation_steps
    × data-parallel world size."""

    train_batch_size: Optional[Union[int, str]] = None
    train_micro_batch_size_per_gpu: Optional[Union[int, str]] = None
    gradient_accumulation_steps: Optional[Union[int, str]] = None
    steps_per_print: int = STEPS_PER_PRINT_DEFAULT
    dump_state: bool = False
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    sparse_gradients: bool = False
    gradient_clipping: float = 0.0
    # raise with the offending leaf paths on a non-finite loss or grad norm
    # (debug mode: forces a host sync per micro step)
    check_numerics: bool = False
    communication_data_type: Optional[str] = None
    seq_parallel_communication_data_type: str = "fp32"
    disable_allgather: bool = False

    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig)
    comms_logger: CommsLoggerConfig = field(default_factory=CommsLoggerConfig)
    tensorboard: MonitorBackendConfig = field(
        default_factory=MonitorBackendConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = field(default_factory=CSVConfig)
    flops_profiler: FlopsProfilerConfig = field(
        default_factory=FlopsProfilerConfig)
    aio: AioConfig = field(default_factory=AioConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    data_types: DataTypesConfig = field(default_factory=DataTypesConfig)
    elasticity: ElasticityConfig = field(default_factory=ElasticityConfig)
    autotuning: AutotuningConfig = field(default_factory=AutotuningConfig)
    hybrid_engine: HybridEngineConfig = field(
        default_factory=HybridEngineConfig)
    # request-serving layer (serving/, docs/SERVING.md)
    serving: ServingConfig = field(default_factory=ServingConfig)
    # the engine-level serving blocks, also reachable under ``serving``
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    speculative: SpeculativeConfig = field(default_factory=SpeculativeConfig)
    kv_quant: KVQuantConfig = field(default_factory=KVQuantConfig)
    weight_quant: WeightQuantConfig = field(default_factory=WeightQuantConfig)
    kv_tier: KVTierConfig = field(default_factory=KVTierConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    # unified telemetry (docs/OBSERVABILITY.md): training step spans here;
    # serving request tracing via ``serving.telemetry``
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    # the training supervisor: parsed as a plain dict until ported
    resilience: Dict[str, Any] = field(default_factory=dict)
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    seed: int = 1234
    zero_allow_untested_optimizer: bool = True
    zero_force_ds_cpu_optimizer: bool = True
    compression_training: Dict[str, Any] = field(default_factory=dict)
    data_efficiency: Dict[str, Any] = field(default_factory=dict)
    curriculum_learning: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------ dtype helpers
    @property
    def precision(self) -> DtypeEnum:
        if self.bf16.enabled:
            return DtypeEnum.bf16
        if self.fp16.enabled:
            return DtypeEnum.fp16
        return DtypeEnum.fp32

    @property
    def zero_enabled(self) -> bool:
        return self.zero_optimization.stage > 0

    # ------------------------------------------------------- batch resolution
    def resolve_batch_sizes(self, dp_world_size: int) -> None:
        """Any two of (train_batch, micro_batch, gas) determine the third."""
        train = self.train_batch_size \
            if isinstance(self.train_batch_size, int) else None
        micro = (self.train_micro_batch_size_per_gpu
                 if isinstance(self.train_micro_batch_size_per_gpu, int)
                 else None)
        gas = (self.gradient_accumulation_steps
               if isinstance(self.gradient_accumulation_steps, int) else None)

        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp_world_size)
        elif train is not None and gas is not None:
            micro = train // (gas * dp_world_size)
        elif micro is not None and gas is not None:
            train = micro * gas * dp_world_size
        elif micro is not None:
            gas = 1
            train = micro * dp_world_size
        elif train is not None:
            gas = 1
            micro = train // dp_world_size
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "must be set")

        if train != micro * gas * dp_world_size:
            raise DeepSpeedConfigError(
                f"Inconsistent batch config: train_batch_size={train} != "
                f"micro({micro}) * gas({gas}) * "
                f"dp_world_size({dp_world_size})")
        if train <= 0 or micro <= 0 or gas <= 0:
            raise DeepSpeedConfigError(
                f"Batch sizes must be positive: train={train} micro={micro} "
                f"gas={gas}")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    # ------------------------------------------------------------ not ported
    def raise_if_not_ported(self) -> None:
        """Raise ``NotImplementedError`` for the first block that is switched
        on and whose feature the port does not run yet."""
        z = self.zero_optimization
        mesh = self.mesh
        ac = self.activation_checkpointing
        offload = [o for o in (z.offload_optimizer, z.offload_param)
                   if o is not None and o.device != OffloadDeviceEnum.none]
        checks = [
            (z.stage > 0, f"zero_optimization.stage={z.stage} (ZeRO sharding "
             "over a device mesh)", "queue 1 item 14"),
            (bool(offload), "zero_optimization offload_optimizer/"
             "offload_param (ZeRO-Offload, ZeRO-Infinity)", "queue 1 item 15"),
            (z.mics_shard_size > 0, "zero_optimization.mics_shard_size "
             "(MiCS)", "queue 1 item 14"),
            (z.zero_hpz_partition_size > 1,
             "zero_optimization.zero_hpz_partition_size (hpZ)",
             "queue 1 item 14"),
            (z.zero_quantized_weights or z.zero_quantized_gradients
             or z.zero_quantized_nontrainable_weights,
             "zero_optimization.zero_quantized_weights/gradients (ZeRO++)",
             "queue 1 item 14"),
            (any(getattr(mesh, a) > 1 for a in
                 ("data", "fsdp", "tensor", "pipe", "sequence", "expert")),
             "a mesh with more than one device", "queue 1 item 14"),
            (self.pipeline.stages > 1 or bool(self.pipeline.micro_batches),
             "pipeline parallelism", "queue 1 item 14"),
            (ac.partition_activations or ac.cpu_checkpointing
             or ac.contiguous_memory_optimization
             or ac.number_checkpoints is not None
             or ac.synchronize_checkpoint_boundary or ac.profile,
             "the activation_checkpointing block (use the model config's "
             "remat for whole-block recomputation)", "queue 1 item 13"),
            (self.comms_logger.enabled, "comms_logger", "queue 1 item 14"),
            (self.sparse_gradients, "sparse_gradients", "queue 1 item 14"),
            (self.communication_data_type is not None,
             "communication_data_type", "queue 1 item 14"),
            (self.tensorboard.enabled or self.wandb.enabled
             or self.csv_monitor.enabled,
             "monitors (tensorboard, wandb, csv_monitor)", "queue 1 item 17"),
            (self.flops_profiler.enabled, "flops_profiler",
             "queue 1 item 17"),
            (self.elasticity.enabled, "elasticity", "queue 1 item 17"),
            (self.autotuning.enabled, "autotuning", "queue 1 item 17"),
            (self.hybrid_engine.enabled, "hybrid_engine", "queue 1 item 17"),
            (bool(self.compression_training), "compression_training",
             "queue 1 item 17"),
            (_dict_block_on(self.curriculum_learning), "curriculum_learning",
             "queue 1 item 17"),
            (_dict_block_on(self.data_efficiency), "data_efficiency",
             "queue 1 item 17"),
            (_dict_block_on(self.resilience) or bool(
                self.resilience.get("faults")), "resilience",
             "queue 1 item 13"),
        ]
        for on, what, item in checks:
            if on:
                raise not_ported(what, item)

    def print_config(self, name: str = "DeepSpeedTpuConfig") -> None:
        logger.info(f"{name}:\n"
                    f"{json.dumps(self.to_dict(), indent=2, default=str)}")


def load_config(config: Union[str, dict, DeepSpeedTpuConfig, None]
                ) -> DeepSpeedTpuConfig:
    """Accepts a path to a JSON file, a dict, an existing config object, or
    None (all defaults)."""
    if config is None:
        return DeepSpeedTpuConfig()
    if isinstance(config, DeepSpeedTpuConfig):
        return config
    if isinstance(config, str):
        with open(config) as fh:
            config = json.load(
                fh, object_pairs_hook=dict_raise_error_on_duplicate_keys)
    if not isinstance(config, dict):
        raise DeepSpeedConfigError(
            f"Unsupported config type: {type(config)}")
    return DeepSpeedTpuConfig(**config)

