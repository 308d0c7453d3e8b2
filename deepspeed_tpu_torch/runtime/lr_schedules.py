"""Learning-rate schedules as plain functions ``step -> float``.

Port of ``deepspeed_tpu/runtime/lr_schedules.py`` (reference
``deepspeed/runtime/lr_schedules.py``: ``LRRangeTest`` :273, ``OneCycle``
:371, ``WarmupLR`` :633, ``WarmupDecayLR`` :723, ``WarmupCosineLR`` :774),
selected by the same ``scheduler.type`` strings. The JAX versions compute
in float32 on the device; these compute in Python floats on the host.
"""

import math
from typing import Any, Callable, Dict, Optional

Schedule = Callable[[int], float]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def _warmup(step, warmup_min_lr, warmup_max_lr, warmup_num_steps,
            warmup_type="log"):
    warmup_num_steps = max(warmup_num_steps, 1)
    frac = _clip(step / warmup_num_steps, 0.0, 1.0)
    if warmup_type == "log":
        # reference WarmupLR: inverse_log_warm_up * log(step + 1)
        frac = math.log1p(frac * (math.e - 1.0))
    return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_) -> Schedule:
    """reference: WarmupLR — warmup then hold."""
    def fn(step):
        if step < warmup_num_steps:
            return _warmup(step, warmup_min_lr, warmup_max_lr,
                           warmup_num_steps, warmup_type)
        return float(warmup_max_lr)
    return fn


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> Schedule:
    """reference: WarmupDecayLR — warmup then linear decay to 0."""
    def fn(step):
        if step < warmup_num_steps:
            return _warmup(step, warmup_min_lr, warmup_max_lr,
                           warmup_num_steps, warmup_type)
        return warmup_max_lr * _clip(
            (total_num_steps - step)
            / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
    return fn


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     lr: float = 0.001, **_) -> Schedule:
    """reference: WarmupCosineLR (ratio-based)."""
    def fn(step):
        if step < warmup_num_steps:
            return lr * (warmup_min_ratio + (1 - warmup_min_ratio) * _clip(
                step / max(warmup_num_steps, 1), 0.0, 1.0))
        progress = _clip((step - warmup_num_steps)
                         / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        return lr * (cos_min_ratio + (1 - cos_min_ratio) * 0.5
                     * (1 + math.cos(math.pi * progress)))
    return fn


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_) -> Schedule:
    """reference: OneCycle (lr triangle then decay)."""
    second = cycle_second_step_size if cycle_second_step_size is not None \
        else cycle_first_step_size
    end_of_cycle = cycle_first_step_size + second

    def fn(step):
        if step <= cycle_first_step_size:
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * _clip(
                step / max(cycle_first_step_size, 1), 0.0, 1.0)
        if step <= end_of_cycle:
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * _clip(
                (step - cycle_first_step_size) / max(second, 1), 0.0, 1.0)
        if decay_step_size > 0:
            decay_steps = max(step - end_of_cycle, 0) / decay_step_size
            return cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
        return float(cycle_min_lr)
    return fn


def lr_range_test(lr_range_test_min_lr: float = 0.001,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:
    """reference: LRRangeTest (continuous/staircase lr sweep)."""
    def fn(step):
        interval = step / max(lr_range_test_step_size, 1)
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)
    return fn


def constant_lr(lr: float = 0.001, **_) -> Schedule:
    return lambda step: float(lr)


SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
    "OneCycle": one_cycle,
    "LRRangeTest": lr_range_test,
    "Constant": constant_lr,
}


def build_schedule(sched_type: str, params: Dict[str, Any]) -> Schedule:
    if sched_type not in SCHEDULES:
        raise ValueError(f"unknown scheduler '{sched_type}'; known: {list(SCHEDULES)}")
    return SCHEDULES[sched_type](**params)
