"""The fixture model of the engine's tests.

Port of ``deepspeed_tpu/models/simple.py`` (reference
``tests/unit/simple_model.py``): ``SimpleModel``, an MLP over dict batches
``{"x": [B, D], "y": [B]}`` returning the mean cross-entropy, and the
seeded ``random_dataset`` / ``random_batch`` (numpy, the same draws as the
JAX package's). The layers carry flax ``nn.Dense``'s names and layout
(``Dense_{i}.kernel`` [in, out], ``Dense_{i}.bias``), so the JAX model's
parameter tree loads by ``models.convert.load_flax_params`` or
``simple_params_from_jax``. ``SimpleCNN`` is not ported (ROADMAP Queue 1
item 7).
"""

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.utils.device import resolve_device


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, kernel [in, out]."""

    def __init__(self, d_in: int, d_out: int, device: torch.device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x, compute_dtype=None):
        k, b = self.kernel, self.bias
        if compute_dtype is not None:
            k, b = k.to(compute_dtype), b.to(compute_dtype)
        return x @ k + b


class SimpleModel(nn.Module):
    """``num_layers`` Dense + relu of ``hidden_dim`` over ``input_dim``
    features, then a Dense to ``num_classes`` logits: the mean
    cross-entropy against ``batch["y"]``. Parameters are made on ``device``
    (the card unless the caller asks for the CPU) and drawn from ``seed``:
    normal kernels of std ``1/sqrt(fan_in)``, zero biases."""

    def __init__(self, hidden_dim: int = 64, num_layers: int = 2,
                 num_classes: int = 10, input_dim: int = 32, device=None,
                 seed: int = 0):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.num_classes, self.input_dim = num_classes, input_dim
        dev = resolve_device(device)
        dims = [input_dim] + [hidden_dim] * num_layers + [num_classes]
        for i in range(num_layers + 1):
            setattr(self, f"Dense_{i}", Dense(dims[i], dims[i + 1], dev))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        with torch.no_grad():
            for i in range(num_layers + 1):
                k = getattr(self, f"Dense_{i}").kernel
                k.normal_(0.0, 1.0 / math.sqrt(k.shape[0]), generator=gen)

    def logits(self, batch, compute_dtype=None):
        x = batch["x"]
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        elif x.dtype == torch.float64:
            x = x.float()
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"Dense_{i}")(x, compute_dtype))
        return getattr(self, f"Dense_{self.num_layers}")(x, compute_dtype)

    def forward(self, batch, compute_dtype=None):
        logits = self.logits(batch, compute_dtype)
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(-1, batch["y"].long().unsqueeze(-1))[..., 0]
        return -picked.mean()


def random_dataset(n: int, input_dim: int = 32, num_classes: int = 10,
                   seed: int = 0) -> Sequence[Any]:
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, input_dim)).astype(np.float32)
    ys = rng.integers(0, num_classes, size=(n,)).astype(np.int32)
    return [{"x": xs[i], "y": ys[i]} for i in range(n)]


def random_batch(batch_size: int, input_dim: int = 32, num_classes: int = 10,
                 seed: int = 0, gas: Optional[int] = None):
    rng = np.random.default_rng(seed)
    shape = (gas, batch_size) if gas else (batch_size,)
    return {
        "x": rng.normal(size=shape + (input_dim,)).astype(np.float32),
        "y": rng.integers(0, num_classes, size=shape).astype(np.int32),
    }
