"""Host fused optimizers over the native C++ kernels of ``csrc/cpu_adam.cpp``.

Port of ``deepspeed_tpu/ops/cpu_adam.py`` (reference
``deepspeed/ops/adam/cpu_adam.py``, ``ops/adagrad/cpu_adagrad.py``,
``ops/lion/cpu_lion.py``): ``CPUAdam`` (Adam/AdamW), ``CPUAdagrad``,
``CPULion`` and ``to_bf16``, the memory tiers' update of the fp32 masters
and moments in host memory and the bf16 shadow that goes back to the card.

They take flat, contiguous fp32 CPU tensors and update them in place. The
library is ``csrc/cpu_adam.cpp``, a copy of the JAX package's source, built
by ``g++ -O3 -march=native -fopenmp`` on first use (``ops/build.py``). A
missing compiler or a failed build raises: unlike the JAX wrapper, nothing
falls back to a Python version. ``adam_step_plain``, ``adagrad_step_plain``,
``lion_step_plain`` and ``to_bf16_plain`` repeat each kernel's arithmetic
in torch ops for the tests; the compiler may contract the kernels' products
and sums into FMAs, so the two agree to float32 rounding, not bit for bit.
"""

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import build

_P = ctypes.c_void_p
_SIGNATURES = {
    "cpu_adam_step": [_P] * 4 + [ctypes.c_int64] + [ctypes.c_float] * 5
    + [ctypes.c_int, ctypes.c_int64],
    "cpu_adagrad_step": [_P] * 3 + [ctypes.c_int64] + [ctypes.c_float] * 3,
    "cpu_lion_step": [_P] * 3 + [ctypes.c_int64] + [ctypes.c_float] * 4,
    "fp32_to_bf16": [_P, _P, ctypes.c_int64],
}


def _fn(name: str):
    """The native entry ``name``, its ctypes signature set."""
    fn = getattr(build.load("cpu_adam"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = None
    return fn


def host_threads() -> int:
    """The OpenMP threads the host kernels run on: the ``libgomp`` that
    ``g++ -fopenmp`` linked them to (PyTorch's wheel carries its own)."""
    build.load("cpu_adam")
    return int(ctypes.CDLL("libgomp.so.1").omp_get_max_threads())


def _check(*tensors: torch.Tensor) -> int:
    n = tensors[0].numel()
    for t in tensors:
        if t.device.type != "cpu" or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError(
                "host optimizer kernels take contiguous float32 CPU tensors "
                f"of one size; got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}) beside {n} elements")
    return n


def to_bf16(src: torch.Tensor, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Round-to-nearest-even bf16 copy of a float32 CPU tensor (the
    shadow sent to the card), into ``out`` when given."""
    n = _check(src)
    if out is None:
        out = torch.empty(src.shape, dtype=torch.bfloat16)
    if out.dtype != torch.bfloat16 or out.device.type != "cpu" \
            or not out.is_contiguous() or out.numel() != n:
        raise ValueError(f"to_bf16: out must be a contiguous bf16 CPU tensor "
                         f"of {n} elements")
    _fn("fp32_to_bf16")(src.data_ptr(), out.data_ptr(), n)
    return out


class CPUAdam:
    """Fused AdamW/Adam over flat fp32 CPU tensors (host memory)."""

    num_states = 2  # exp_avg, exp_avg_sq

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True, **_ignored):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0
        self._fn = _fn("cpu_adam_step")

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
             lr: Optional[float] = None) -> None:
        """One fused update in place."""
        n = _check(params, grads, exp_avg, exp_avg_sq)
        self.step_count += 1
        lr = self.lr if lr is None else lr
        self._fn(params.data_ptr(), grads.data_ptr(), exp_avg.data_ptr(),
                 exp_avg_sq.data_ptr(), n, lr, self.beta1, self.beta2,
                 self.eps, self.weight_decay, int(self.adamw_mode),
                 self.step_count)


class CPUAdagrad:
    """Fused Adagrad over flat fp32 CPU tensors (reference
    ``csrc/adagrad/cpu_adagrad.cpp``)."""

    num_states = 1  # state_sum

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, **_ignored):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.step_count = 0
        self._fn = _fn("cpu_adagrad_step")

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             state_sum: torch.Tensor, lr: Optional[float] = None) -> None:
        n = _check(params, grads, state_sum)
        self.step_count += 1
        lr = self.lr if lr is None else lr
        self._fn(params.data_ptr(), grads.data_ptr(), state_sum.data_ptr(), n,
                 lr, self.eps, self.weight_decay)


class CPULion:
    """Fused Lion over flat fp32 CPU tensors (reference
    ``csrc/lion/cpu_lion_impl.cpp``)."""

    num_states = 1  # exp_avg

    def __init__(self, lr: float = 1e-4, betas=(0.9, 0.99),
                 weight_decay: float = 0.0, **_ignored):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.weight_decay = weight_decay
        self.step_count = 0
        self._fn = _fn("cpu_lion_step")

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             exp_avg: torch.Tensor, lr: Optional[float] = None) -> None:
        n = _check(params, grads, exp_avg)
        self.step_count += 1
        lr = self.lr if lr is None else lr
        self._fn(params.data_ptr(), grads.data_ptr(), exp_avg.data_ptr(), n,
                 lr, self.beta1, self.beta2, self.weight_decay)


# ---------------------------------------------------------------------------
# plain versions (the tests hold the kernels against them)
# ---------------------------------------------------------------------------
def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@torch.no_grad()
def adam_step_plain(params, grads, exp_avg, exp_avg_sq, lr, beta1, beta2,
                    eps, weight_decay, adamw, step) -> None:
    """``cpu_adam_step`` in torch ops, float32 throughout, in place."""
    b1, b2, lr32 = _f32(beta1), _f32(beta2), _f32(lr)
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    step_size = lr32 / bc1
    inv_sqrt_bc2 = 1.0 / torch.sqrt(bc2)
    g = grads
    if not adamw and weight_decay:
        g = g + _f32(weight_decay) * params
    exp_avg.copy_(b1 * exp_avg + (1.0 - b1) * g)
    exp_avg_sq.copy_(b2 * exp_avg_sq + (1.0 - b2) * g * g)
    denom = torch.sqrt(exp_avg_sq) * inv_sqrt_bc2 + _f32(eps)
    new = params - step_size * (exp_avg / denom)
    if adamw and weight_decay:
        new = new - lr32 * _f32(weight_decay) * params
    params.copy_(new)


@torch.no_grad()
def adagrad_step_plain(params, grads, state_sum, lr, eps, weight_decay) -> None:
    """``cpu_adagrad_step`` in torch ops, in place."""
    g = grads
    if weight_decay:
        g = g + _f32(weight_decay) * params
    state_sum.add_(g * g)
    params.sub_(_f32(lr) * g / (torch.sqrt(state_sum) + _f32(eps)))


@torch.no_grad()
def lion_step_plain(params, grads, exp_avg, lr, beta1, beta2,
                    weight_decay) -> None:
    """``cpu_lion_step`` in torch ops, in place."""
    b1, b2 = _f32(beta1), _f32(beta2)
    c = b1 * exp_avg + (1.0 - b1) * grads
    params.copy_(params - _f32(lr) * (torch.sign(c)
                                      + _f32(weight_decay) * params))
    exp_avg.copy_(b2 * exp_avg + (1.0 - b2) * grads)


def to_bf16_plain(src: torch.Tensor) -> torch.Tensor:
    """torch's float32 -> bf16 conversion (round to nearest even)."""
    return src.to(torch.bfloat16)
