"""The single-JSON config, cut to what ``train_batch`` reads.

Port of ``deepspeed_tpu/config/config.py``: the same keys, defaults,
batch-size triple reconciliation and validation errors, written as
dataclasses (the card's machine has no pydantic). Unknown keys inside a
group are ignored, as the reference's models ignore them.

Groups the port does not carry yet raise ``NotImplementedError`` instead
of being parsed and ignored: ZeRO stages above 0 and every ``offload_*``
tier (ROADMAP Queue 1, "Distribution and memory tiers"), and any other
top-level group that the training path does not read.
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
    C.WALL_CLOCK_BREAKDOWN, C.DATA_TYPES,
})


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
    """reference: runtime/zero/offload_config.py. device: none|cpu|nvme;
    only "none" is ported."""
    device: str = "none"


@dataclasses.dataclass
class ZeroConfig:
    """reference: runtime/zero/config.py. The port runs stage 0 (plain data
    parallel, one card); stages 1-3 and the offload tiers come with
    ROADMAP Queue 1, "Distribution and memory tiers".
    ``zero_quantized_gradients`` (qgZ) is read at
    stage 0: on one card it is the int8 round trip of every micro-batch
    gradient (``runtime/engine.py``)."""
    stage: int = 0
    offload_param: Any = None
    offload_optimizer: Any = None
    zero_quantized_gradients: bool = False

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
class OptimizerConfig:
    type: str = "adamw"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


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
        zc = self.zero_config
        if zc.stage > 0:
            raise NotImplementedError(
                f"ZeRO stage {zc.stage} is not ported yet (ROADMAP Queue 1: "
                "distribution and memory tiers); use stage 0")
        for name in ("offload_param", "offload_optimizer"):
            if getattr(zc, name).device != "none":
                raise NotImplementedError(
                    f"zero_optimization.{name} is not ported yet (ROADMAP "
                    "Queue 1: distribution and memory tiers)")
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

    def __repr__(self) -> str:
        return (f"DeepSpeedTPUConfig(train_batch_size={self.train_batch_size}, "
                f"micro_batch={self.train_micro_batch_size_per_gpu}, "
                f"gas={self.gradient_accumulation_steps}, zero_stage={self.zero_config.stage}, "
                f"dtype={'bf16' if self.bf16.enabled else 'fp16' if self.fp16.enabled else 'fp32'})")
