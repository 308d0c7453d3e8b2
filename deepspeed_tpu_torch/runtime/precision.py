"""Mixed precision: fp32 master weights, bf16/fp16 compute, dynamic loss
scaling.

Port of ``deepspeed_tpu/runtime/precision.py`` (reference
``runtime/fp16/loss_scaler.py:91`` ``DynamicLossScaler``). The loss-scale
state lives on the host: in eager PyTorch the engine reads the overflow
flag once per step under fp16 (or the non-finite guard) anyway, so the
transition is plain Python instead of the reference's ``jnp.where``.
Gradient helpers take lists of tensors. The reference's
``cast_to_compute`` has no counterpart here: the model casts each master
at its use (``models/llama.py``), so a remat recompute casts again from
the master.
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.config.config import FP16Config


@dataclasses.dataclass
class LossScaleState:
    """Dynamic loss-scale state."""
    scale: float                # current loss scale
    good_steps: int             # consecutive overflow-free steps
    hysteresis: int             # remaining overflow tolerance


def init_loss_scale(cfg: FP16Config) -> LossScaleState:
    if not cfg.enabled:
        return LossScaleState(1.0, 0, 1)
    scale = cfg.loss_scale if cfg.loss_scale > 0 else float(2 ** cfg.initial_scale_power)
    return LossScaleState(float(scale), 0, int(cfg.hysteresis))


def update_loss_scale(state: LossScaleState, overflow: bool,
                      cfg: FP16Config) -> LossScaleState:
    """One dynamic-loss-scale transition (reference: loss_scaler.py:171
    update_scale). A static scale (cfg.loss_scale > 0) passes through."""
    if not cfg.enabled or not cfg.dynamic:
        return state
    scale, good, hyst = state.scale, state.good_steps, state.hysteresis
    if overflow:
        new_hyst = hyst - 1
        if new_hyst <= 0:
            return LossScaleState(max(scale / 2.0, cfg.min_loss_scale), 0,
                                  int(cfg.hysteresis))
        return LossScaleState(scale, 0, new_hyst)
    grown = good + 1 >= cfg.loss_scale_window
    # consecutive_hysteresis=True refills the tolerance on every
    # overflow-free step; False only when the scale grows
    if cfg.consecutive_hysteresis or grown:
        hyst = int(cfg.hysteresis)
    return LossScaleState(scale * 2.0 if grown else scale,
                          0 if grown else good + 1, hyst)


def has_inf_or_nan(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Device bool: any non-finite value in any gradient."""
    if not grads:
        return torch.zeros((), dtype=torch.bool)
    flags = [torch.logical_not(torch.isfinite(g).all()) for g in grads]
    return torch.stack(flags).any()


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all gradients, summed in fp32: sqrt(sum_i sum(g_i^2))."""
    if not grads:
        return torch.zeros(())
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Returns (clipped grads, pre-clip global norm); the factor is
    ``min(1, max_norm / (norm + 1e-6))``. Clipping writes into ``grads``
    (the engine owns them). ``norm`` is the global norm when the caller
    took it (over shards held by several ranks)."""
    if norm is None:
        norm = global_grad_norm(grads)
    if max_norm <= 0:
        return list(grads), norm
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.copy_(g.float() * factor)
    return list(grads), norm
