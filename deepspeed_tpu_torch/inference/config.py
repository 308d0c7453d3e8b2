"""Inference config.

Port of ``deepspeed_tpu/inference/config.py`` (reference
``deepspeed/inference/config.py``, ``DeepSpeedInferenceConfig``), as
dataclasses: the card's machine has no pydantic. The same keys and
defaults; unknown keys are ignored, as the reference's models ignore
them. The TP degree maps to the mesh ``tensor`` axis; ``dtype`` to the
dtype the weights are cast to.
"""

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class QuantizationConfig:
    enabled: bool = False
    bits: int = 8


DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float16": torch.float16, "fp16": torch.float16,
          "float32": torch.float32, "fp32": torch.float32}


@dataclasses.dataclass
class InferenceConfig:
    dtype: str = "bfloat16"
    tensor_parallel: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"tp_size": 1})
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    replace_with_kernel_inject: bool = True   # accepted for parity
    quant: QuantizationConfig = dataclasses.field(
        default_factory=QuantizationConfig)
    checkpoint: Optional[str] = None
    enable_cuda_graph: bool = False            # accepted for parity

    def __post_init__(self):
        if isinstance(self.quant, dict):
            names = {f.name for f in dataclasses.fields(QuantizationConfig)}
            self.quant = QuantizationConfig(
                **{k: v for k, v in self.quant.items() if k in names})

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]] = None, **kwargs):
        """From a config dict and keyword overrides; unknown keys ignored."""
        raw = dict(raw or {}, **kwargs)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})

    @property
    def tp_size(self) -> int:
        return int(self.tensor_parallel.get("tp_size", 1))
