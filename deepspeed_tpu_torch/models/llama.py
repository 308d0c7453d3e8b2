"""Llama-family configuration and the numeric helpers serving needs.

Port of ``deepspeed_tpu/models/llama.py``, cut down to what the serving path
reads: ``LlamaConfig`` (with a torch ``dtype``), the public presets,
``rope_freqs`` and ``softcap_logits``. The flax training model comes with the
training slice.
"""

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    logits_soft_cap: Optional[float] = None
    # llama-family arch knobs (mistral/qwen2/phi3 are llama variants):
    attention_bias: bool = False          # qwen2: bias on q/k/v projections
    sliding_window: Optional[int] = None  # mistral: attend to last W tokens only
    # gemma-family knobs (gemma/gemma2 are llama variants too):
    hidden_act: str = "silu"              # gemma: "gelu_tanh" gated MLP
    rms_scale_offset: bool = False        # gemma norm: y * (1 + scale)
    scale_embeddings: bool = False        # gemma: embed output * sqrt(hidden)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


# Model presets (public architecture configs)
LLAMA3_8B = LlamaConfig(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                        num_layers=32, num_heads=32, num_kv_heads=8)
LLAMA2_7B = LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                        num_layers=32, num_heads=32, num_kv_heads=32, rope_theta=10000.0)
TINY_LLAMA = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                         num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256)


@lru_cache(maxsize=32)
def rope_freqs(head_dim: int, max_len: int, theta: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables [max_len, head_dim // 2] in float32, computed in numpy
    float64 exactly as the reference does, so the tables are bit-identical."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def softcap_logits(x, cap):
    """tanh soft-capping (gemma2): identity when cap is falsy."""
    return cap * torch.tanh(x / cap) if cap else x
