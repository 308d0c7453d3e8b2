"""The single-JSON config, cut to what ``train_batch`` reads.

Port of ``deepspeed_tpu/config/config.py``: the same keys, defaults,
batch-size triple reconciliation and validation errors, written as
dataclasses (the card's machine has no pydantic). Unknown keys inside a
group are ignored, as the reference's models ignore them.

Options the port does not carry yet raise ``NotImplementedError`` naming
their ROADMAP Queue 1 item instead of being parsed and ignored: any
top-level group the training path does not read, and inside the read
groups a mesh with ``pipe`` above 1 (item 7) or with ``dcn_axes`` (item 2
"distribution and memory tiers"), a ``tensor`` axis above 1 with MiCS,
hpZ or qwZ (item 2) or with a ``sequence`` axis above 1 (item 3
"sequence parallel": JAX's Ulysses divides the heads by the tensor
axis), qgZ, ``comm_compression`` or ``sparse_gradients`` over a
``sequence`` axis above 1 (item 3), and an ``expert`` axis above 1 at
ZeRO stages 2-3 or with a memory tier (item 4 "MoE"'s remainder; the
expert axis runs at stages 0-1). A ``tensor`` axis runs at stages 0-3
(``models/llama.py``'s Megatron layout, ``module_inject/``). A comms-logger op filter (``prof_all`` false, ``prof_ops``) is
refused too: no logger applies it. ZeRO stages 0-3 are read, with the
hierarchical world (MiCS ``mics_shard_size``, ZeRO++ hpZ
``zero_hpz_partition_size`` and qwZ ``zero_quantized_weights``, a mesh
``fsdp_outer``), ``comm_compression`` (``comm/compress.py``'s
``CommCompressionConfig``) and ``sparse_gradients``; the memory tiers,
``offload_optimizer`` and ``offload_param`` with ``cpu`` or ``nvme``, run
over the ``data``, ``fsdp`` and ``tensor`` axes. A tier with a
``sequence`` axis above 1 (item 3) and ``offload_optimizer`` with MiCS,
hpZ or qwZ (item 2) are refused. ``async_pipeline`` (``runtime/sched.py``,
the engine's deferred readback and staged prefetch) and ``csv_monitor``
(the engine's training events, ``monitor/monitor.py``) are read; the other
monitor backends' groups (``tensorboard``, ``wandb``, ``comet``) stay
refused (item 7).
"""

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import torch

from deepspeed_tpu_torch.config import constants as C

# top-level keys the port reads; any other group raises
_READ_KEYS = frozenset({
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    C.GRADIENT_ACCUMULATION_STEPS, C.OPTIMIZER, C.SCHEDULER, C.FP16, C.BF16,
    C.BF16_LEGACY, C.ZERO_OPTIMIZATION, C.GRADIENT_CLIPPING, C.STEPS_PER_PRINT,
    C.WALL_CLOCK_BREAKDOWN, C.DATA_TYPES, C.MESH, C.COMMS_LOGGER,
    C.COMM_COMPRESSION, C.SPARSE_GRADIENTS, C.ASYNC_PIPELINE, C.MONITOR_CSV,
    C.CHECKPOINT,
})

# the Queue 1 items refusals name (ROADMAP.md)
ITEM_DIST = "ROADMAP Queue 1 item 2: distribution and memory tiers"
ITEM_MOE = "ROADMAP Queue 1 item 4: MoE"
ITEM_SEQ = "ROADMAP Queue 1 item 3: sequence parallel"


def _from_dict(cls, raw: Optional[Dict[str, Any]]):
    """Build dataclass ``cls`` from ``raw``, ignoring unknown keys."""
    raw = dict(raw or {})
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in names})


@dataclasses.dataclass
class FP16Config:
    """reference: runtime/fp16/loss_scaler.py + config keys under "fp16"."""
    enabled: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == 0.0


@dataclasses.dataclass
class BF16Config:
    enabled: bool = False


@dataclasses.dataclass
class OffloadConfig:
    """reference: runtime/zero/offload_config.py. device: none|cpu (host
    DRAM)|nvme."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = True
    pipeline_read: bool = True
    pipeline_write: bool = True
    ratio: float = 1.0  # Twin-Flow partial offload (engine.py:757 zero_partial_offload)
    # offload_param streaming granularity: transformer blocks per streamed
    # group (larger = fewer, bigger H2D transfers but more HBM per group)
    layers_per_group: int = 1
    # nvme tier: swap the fp32 MASTERS too (full ZeRO-Infinity); False
    # keeps masters in host RAM (moments-only swap)
    swap_masters: bool = True


@dataclasses.dataclass
class ZeroConfig:
    """reference: runtime/zero/config.py. Stages 0-3 over the mesh's
    ``fsdp`` axis (``runtime/zero/partition.py``, the engine's
    data-parallel step), the memory tiers (``offload_optimizer``,
    ``offload_param``) over the data, fsdp and tensor axes, and
    ``zero_quantized_gradients`` (qgZ:
    int8 on the wire over replica axes, else the int8 round trip of every
    micro-batch gradient), and the hierarchical world the engine builds
    from ``mics_shard_size`` (MiCS), ``zero_hpz_partition_size`` (hpZ)
    and ``zero_quantized_weights`` (qwZ). ``sub_group_size`` is parsed with the reference's default; as in
    the JAX package, the host optimizer's sub-groups are 4 leaves
    (``runtime/offload.py``)."""
    stage: int = 0
    offload_param: Any = None
    offload_optimizer: Any = None
    sub_group_size: int = int(1e9)
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = -1

    def __post_init__(self):
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(f"zero stage must be 0-3, got {self.stage}")
        self.offload_param = _from_dict(OffloadConfig, self.offload_param)
        self.offload_optimizer = _from_dict(OffloadConfig,
                                            self.offload_optimizer)


@dataclasses.dataclass
class DataTypesConfig:
    """reference: "data_types" group — the dtype gradients are accumulated
    in across micro-batches (None: fp32)."""
    grad_accum_dtype: Optional[str] = None

    def __post_init__(self):
        if self.grad_accum_dtype not in (None, "fp32", "bf16", "fp16"):
            raise ValueError(
                f"{C.GRAD_ACCUM_DTYPE} must be fp32|bf16|fp16, "
                f"got {self.grad_accum_dtype}")


@dataclasses.dataclass
class MeshConfig:
    """The ``mesh`` group: named-axis process mesh (data, fsdp, tensor,
    sequence, expert, pipe). -1 on at most one axis fills it with the
    remaining ranks."""
    data: int = -1
    fsdp: int = 1
    # hierarchical-sharding replica factor (MiCS / ZeRO++ hpZ)
    fsdp_outer: int = 1
    tensor: int = 1
    sequence: int = 1
    expert: int = 1
    pipe: int = 1
    # axes that ride the slow wire, outermost first: the port lays ranks
    # out row-major only, so a non-empty list is refused
    dcn_axes: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CommsLoggerConfig:
    """The ``comms_logger`` group (``comm/comms_logging.py``)."""
    enabled: bool = False
    verbose: bool = False
    # the logger records every op, as the JAX package's does: a filter
    # (prof_all false, or prof_ops named) is refused, not ignored
    prof_all: bool = True
    prof_ops: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "adamw"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AsyncPipelineConfig:
    """The ``async_pipeline`` group (reference ``config.py:289-320``).

    With ``enabled``, ``train_batch`` returns without reading its outputs
    back: they wait on the engine's ring and are drained in one transfer
    every ``sync_every`` steps (and at ``engine.flush_metrics()``). Host
    consumers (monitor events, ``take_drained_metrics``) see steps up to
    ``sync_every`` steps late; the numbers are the synchronous run's.
    ``prefetch`` stages batches one step ahead on a background thread,
    ``prefetch_depth`` of them. Off by default."""
    enabled: bool = False
    sync_every: int = 8
    prefetch: bool = False
    prefetch_depth: int = 2

    def __post_init__(self):
        if self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {self.sync_every}")
        if self.prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {self.prefetch_depth}")


@dataclasses.dataclass
class CheckpointConfig:
    """The ``checkpoint`` group's key that ``checkpoint/engine.py`` reads
    (JAX ``config.py`` ``CheckpointConfig``). The reference's multi-node
    storage keys (``tag_validation``, ``load_universal``,
    ``use_node_local_storage``, ``parallel_write_pipeline``) are accepted
    and ignored: the port writes one logical checkpoint whatever they
    say."""
    async_save: bool = False


@dataclasses.dataclass
class CSVConfig:
    """The ``csv_monitor`` group that ``monitor.CSVMonitor`` takes."""
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJob"


class DeepSpeedTPUConfig:
    """Parses the single JSON/dict config (reference: DeepSpeedConfig).
    Performs the batch-size triple reconciliation with ``dp_world_size``."""

    def __init__(self, config: Union[str, Dict[str, Any], None],
                 dp_world_size: Optional[int] = None):
        if config is None:
            config = {}
        if isinstance(config, str):
            if not os.path.exists(config):
                raise FileNotFoundError(f"DeepSpeed-TPU config not found: {config}")
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise TypeError(f"config must be dict or path, got {type(config)}")
        self._raw = dict(config)

        self.fp16 = _from_dict(FP16Config, self._raw.get(C.FP16))
        self.bf16 = _from_dict(BF16Config, self._raw.get(
            C.BF16, self._raw.get(C.BF16_LEGACY)))
        self.zero_config = _from_dict(ZeroConfig,
                                      self._raw.get(C.ZERO_OPTIMIZATION))
        self.optimizer = _from_dict(OptimizerConfig, self._raw[C.OPTIMIZER]) \
            if C.OPTIMIZER in self._raw else None
        self.scheduler = _from_dict(SchedulerConfig, self._raw[C.SCHEDULER]) \
            if C.SCHEDULER in self._raw else None
        self.data_types = _from_dict(DataTypesConfig,
                                     self._raw.get(C.DATA_TYPES))
        self.mesh = _from_dict(MeshConfig, self._raw.get(C.MESH))
        self.comms_logger = _from_dict(CommsLoggerConfig,
                                       self._raw.get(C.COMMS_LOGGER))
        # reference: get_sparse_gradients_enabled (runtime/config.py:247)
        self.sparse_gradients_enabled: bool = bool(
            self._raw.get(C.SPARSE_GRADIENTS, False))
        from deepspeed_tpu_torch.comm.compress import CommCompressionConfig
        self.comm_compression = CommCompressionConfig.from_dict(
            self._raw.get(C.COMM_COMPRESSION))
        self.async_pipeline = _from_dict(AsyncPipelineConfig,
                                         self._raw.get(C.ASYNC_PIPELINE))
        self.csv_monitor = _from_dict(CSVConfig, self._raw.get(C.MONITOR_CSV))
        self.checkpoint_config = _from_dict(CheckpointConfig,
                                            self._raw.get(C.CHECKPOINT))
        self.gradient_clipping: float = float(
            self._raw.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT))
        self.steps_per_print: int = int(
            self._raw.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT))
        self.wall_clock_breakdown: bool = bool(
            self._raw.get(C.WALL_CLOCK_BREAKDOWN, False))

        self.train_batch_size: Optional[int] = self._raw.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu: Optional[int] = self._raw.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps: Optional[int] = self._raw.get(
            C.GRADIENT_ACCUMULATION_STEPS)
        if dp_world_size is not None:
            self.resolve_batch_sizes(dp_world_size)
        self._refuse_unported()

    def _refuse_unported(self) -> None:
        zc, mesh = self.zero_config, self.mesh
        tiers = [t for t in ("offload_optimizer", "offload_param")
                 if getattr(zc, t).device != "none"]
        if tiers and mesh.sequence != 1:
            raise NotImplementedError(
                f"{tiers[0]} at mesh.sequence={mesh.sequence} is not ported "
                f"yet ({ITEM_SEQ}: the memory tiers over sequence ranks)")
        if zc.offload_optimizer.device != "none":
            for on, what in ((zc.mics_shard_size is not None
                              and zc.mics_shard_size > 0, "MiCS"),
                             ((zc.zero_hpz_partition_size or 1) > 1, "hpZ"),
                             (zc.zero_quantized_weights, "qwZ")):
                if on:
                    raise NotImplementedError(
                        f"offload_optimizer with {what} is not ported yet "
                        f"({ITEM_DIST}: the memory tiers with the "
                        "hierarchical ZeRO world)")
        if mesh.pipe != 1:
            raise NotImplementedError(
                f"mesh.pipe={mesh.pipe} is not ported yet (ROADMAP Queue 1 "
                "item 7: the pipeline engine)")
        if mesh.tensor != 1:
            if mesh.sequence != 1:
                raise NotImplementedError(
                    f"mesh.tensor={mesh.tensor} with mesh.sequence="
                    f"{mesh.sequence} is not ported yet ({ITEM_SEQ}: "
                    "tensor-parallel heads under Ulysses, which divides the "
                    "heads by the tensor axis)")
            for on, what in ((zc.mics_shard_size is not None
                              and zc.mics_shard_size > 0, "MiCS"),
                             ((zc.zero_hpz_partition_size or 1) > 1, "hpZ"),
                             (zc.zero_quantized_weights, "qwZ")):
                if on:
                    raise NotImplementedError(
                        f"mesh.tensor={mesh.tensor} with {what} is not "
                        f"ported yet ({ITEM_DIST}: the hierarchical ZeRO "
                        "world on tensor-parallel blocks)")
        if mesh.sequence != 1:
            for on, what in ((zc.zero_quantized_gradients,
                              "zero_quantized_gradients"),
                             (self.comm_compression.enabled,
                              "comm_compression"),
                             (self.sparse_gradients_enabled,
                              "sparse_gradients")):
                if on:
                    raise NotImplementedError(
                        f"{what} at mesh.sequence={mesh.sequence} is not "
                        f"ported yet ({ITEM_SEQ}: the replica-axis wire over "
                        "sequence ranks, whose gradients are sums, not "
                        "means)")
        if mesh.expert != 1:
            if zc.stage >= 2:
                raise NotImplementedError(
                    f"mesh.expert={mesh.expert} at ZeRO stage {zc.stage} is "
                    f"not ported yet ({ITEM_MOE}: the expert axis at stages "
                    "2-3); the expert axis runs at stages 0-1")
            for tier in ("offload_optimizer", "offload_param"):
                if getattr(zc, tier).device != "none":
                    raise NotImplementedError(
                        f"mesh.expert={mesh.expert} with {tier} is not ported "
                        f"yet ({ITEM_MOE}: the expert axis with the memory "
                        "tiers)")
        if mesh.dcn_axes:
            raise NotImplementedError(
                f"mesh.dcn_axes={mesh.dcn_axes} (the multi-slice layout) is "
                f"not ported yet ({ITEM_DIST})")
        cl = self.comms_logger
        if not cl.prof_all or cl.prof_ops:
            raise NotImplementedError(
                "comms_logger.prof_all=false / prof_ops: the comms logger "
                "records every op and filters none (the JAX package's "
                "logger stores the filter and never reads it)")
        unported = sorted(set(self._raw) - _READ_KEYS)
        if unported:
            raise NotImplementedError(
                f"config groups {unported} are not ported yet (ROADMAP "
                "Queue 1); the training path reads only "
                f"{sorted(_READ_KEYS)}")

    def resolve_batch_sizes(self, dp_world_size: int) -> None:
        """train_batch = micro_batch * gas * dp_world. Given any two, derive
        the third; given one, assume the others."""
        tb, mb, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise ValueError(
                    f"train_batch_size {tb} != micro_batch {mb} * gas {gas} * dp {dp_world_size}")
        elif tb is not None and mb is not None:
            gas = tb // (mb * dp_world_size)
            if gas == 0 or tb % (mb * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by micro_batch {mb} * dp {dp_world_size}")
        elif tb is not None and gas is not None:
            if tb % (gas * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by gas {gas} * dp {dp_world_size}")
            mb = tb // (gas * dp_world_size)
        elif mb is not None and gas is not None:
            tb = mb * gas * dp_world_size
        elif tb is not None:
            gas = C.GRADIENT_ACCUMULATION_STEPS_DEFAULT
            if tb % (gas * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by "
                    f"gas {gas} * dp {dp_world_size}")
            mb = tb // (gas * dp_world_size)
        elif mb is not None:
            gas = C.GRADIENT_ACCUMULATION_STEPS_DEFAULT
            tb = mb * gas * dp_world_size
        elif gas is not None:
            mb = 1
            tb = gas * dp_world_size
        else:
            mb, gas = 1, C.GRADIENT_ACCUMULATION_STEPS_DEFAULT
            tb = mb * gas * dp_world_size
        self.train_batch_size, self.train_micro_batch_size_per_gpu, \
            self.gradient_accumulation_steps = int(tb), int(mb), int(gas)

    @property
    def precision_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    @property
    def grad_accum_dtype(self) -> torch.dtype:
        """The dtype gradients are accumulated in over the micro-batches
        (fp32 unless data_types.grad_accum_dtype overrides)."""
        return {None: torch.float32, "fp32": torch.float32,
                "bf16": torch.bfloat16,
                "fp16": torch.float16}[self.data_types.grad_accum_dtype]

    # --- convenience accessors (the reference's subset) ---
    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    @property
    def loss_scale(self) -> float:
        return self.fp16.loss_scale if self.fp16.enabled else 1.0

    def raw(self) -> Dict[str, Any]:
        return dict(self._raw)

    def __repr__(self) -> str:
        return (f"DeepSpeedTPUConfig(train_batch_size={self.train_batch_size}, "
                f"micro_batch={self.train_micro_batch_size_per_gpu}, "
                f"gas={self.gradient_accumulation_steps}, zero_stage={self.zero_config.stage}, "
                f"dtype={'bf16' if self.bf16.enabled else 'fp16' if self.fp16.enabled else 'fp32'})")
