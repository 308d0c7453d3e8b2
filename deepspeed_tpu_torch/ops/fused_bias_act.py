"""Fused bias + activation (+ dropout): plain versions, the CUDA kernels'
wrappers and the autograd functions.

Port of ``deepspeed_tpu/ops/pallas/fused_bias_act.py``. Its four TPU kernels,
``_bias_act_kernel``, ``_bias_act_bwd_kernel``, ``_bias_act_dropout_kernel``
and ``_bias_act_dropout_bwd_kernel``, become the hand-written CUDA kernels of
``csrc/fused_bias_act.cu`` (design notes there), counted as ``bias_act``,
``bias_act_bwd``, ``bias_act_dropout`` and ``bias_act_dropout_bwd``.

Function, over the last axis of x ``[..., D]`` with a bias ``[D]``, in fp32:
``act(x + b)`` for gelu (the tanh form, ``jax.nn.gelu``'s default), relu,
silu and identity; the backward gives ``dx = act'(x + b) * g`` in x's dtype
and ``db``, the fp32 column sums of that dx, in the bias's dtype. The
derivatives are written out, in the plain versions as in the kernels, and
both take the same fp32 operations in the same order.

Dropout: element ``e`` of the flat ``[N, D]`` index is kept when
``(bits >> 8) * 2^-24 >= rate`` in fp32, which is ``(bits >> 8) >= thr``
with ``thr = ceil(float32(rate) * 2^24)`` (``keep_threshold``; kernels and
plain versions test the integer), with ``bits`` word ``e % 4`` of
Philox4x32-10 at counter ``(lo32(e // 4), hi32(e // 4), 0, 0)`` and key
``(uint32(seed), 0)``; a kept value is ``act(x + b) * (1 / (1 - rate))``
(the fp32 reciprocal), the others 0. The backward draws the same bits again,
so no mask is stored, and the plain version (``philox4x32``, in int64 torch
ops) draws the same bits as the kernels. The TPU draws its mask with its own
PRNG, which no other device reproduces: the reference's contract holds per
platform (forward and backward masks identical, the keep rate, the same mask
for the same seed).

CPU tensors run the plain versions; CUDA tensors launch the kernels or
raise. Nothing catches a build or launch failure to run a plain version
instead. The Pallas ``block_rows`` and ``interpret`` arguments are TPU
tiling knobs and have no counterpart.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.quant import on_card

KERNEL = "fused_bias_act"
LAUNCH_NAMES = ("bias_act", "bias_act_bwd", "bias_act_dropout",
                "bias_act_dropout_bwd")
ACTS = ("gelu", "relu", "silu", "identity")      # codes 0..3 of the source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256
PLAN_FIELDS = ("cols", "vec", "tpr", "grid_x", "grid_y")
SQRT_2_OVER_PI = float(np.float32(0.7978845608028654))
GELU_COEF = float(np.float32(0.044715))
GELU_COEF3 = float(np.float32(3.0) * np.float32(0.044715))
# Philox4x32-10 (Random123): multipliers and Weyl key increments
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF
_lib: Optional[ctypes.CDLL] = None


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------
def _check_act(act: str) -> int:
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; one of {ACTS}")
    return ACTS.index(act)


def _gelu_t(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(SQRT_2_OVER_PI * (x + GELU_COEF * (x * x * x)))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(1.0 + torch.exp(-x))


def act_fwd_plain(act: str, x: torch.Tensor) -> torch.Tensor:
    """act(x) of fp32 x, in the kernels' operations."""
    _check_act(act)
    if act == "gelu":
        return x * (0.5 * (1.0 + _gelu_t(x)))
    if act == "relu":
        return torch.where(x > 0, x, 0.0)
    if act == "silu":
        return x * _sigmoid(x)
    return x


def act_grad_plain(act: str, x: torch.Tensor) -> torch.Tensor:
    """act'(x) of fp32 x, written out: gelu ``0.5 (1 + t) + 0.5 x (1 - t^2)
    sqrt(2/pi) (1 + 3 c x^2)``, silu ``s (1 + x (1 - s))``, relu 1 where
    x > 0 (0 at 0, as JAX's and torch's), identity 1."""
    _check_act(act)
    if act == "gelu":
        t = _gelu_t(x)
        du = SQRT_2_OVER_PI * (1.0 + GELU_COEF3 * (x * x))
        return 0.5 * (1.0 + t) + (0.5 * x) * ((1.0 - t * t) * du)
    if act == "relu":
        return (x > 0).float()
    if act == "silu":
        s = _sigmoid(x)
        return s * (1.0 + x * (1.0 - s))
    return torch.ones_like(x)


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the constant ``a`` times each uint32 in the
    int64 tensor ``b``, from 16-bit limbs of b (a 32 x 32-bit product
    overflows int64)."""
    p1 = a * (b & 0xFFFF)                        # < 2^48
    p2 = a * (b >> 16)                           # < 2^48
    t = ((p2 & 0xFFFF) << 16) + p1               # low 48 bits of the product
    return ((p2 >> 16) + (t >> 32)) & _U32, t & _U32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int = 0):
    """Philox4x32-10 on int64 tensors holding uint32 counter words; returns
    the four output words (int64 tensors in [0, 2^32))."""
    for rnd in range(10):
        if rnd:
            k0 = (k0 + PHILOX_W[0]) & _U32
            k1 = (k1 + PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: Union[int, torch.Tensor, np.ndarray]) -> int:
    """uint32 of an int32 seed (an int or a one-element tensor or array)."""
    if isinstance(seed, int):
        return seed & _U32
    if isinstance(seed, torch.Tensor):
        return int(seed.reshape(-1)[0]) & _U32
    return int(np.asarray(seed).reshape(-1)[0]) & _U32


def dropout_bits(numel: int, seed, device="cpu") -> torch.Tensor:
    """The uint32 words (as int64) of flat elements 0..numel-1."""
    groups = -(-numel // 4)
    q = torch.arange(groups, dtype=torch.int64, device=device)
    zero = torch.zeros_like(q)
    words = philox4x32(q & _U32, q >> 32, zero, zero, seed_key(seed))
    return torch.stack(words, dim=1).reshape(-1)[:numel]


@functools.lru_cache(maxsize=None)
def keep_threshold(rate: float) -> int:
    """The integer ``thr`` of the keep test ``(bits >> 8) >= thr``:
    ``ceil(float32(rate) * 2^24)``. The TPU kernel's test, ``(bits >> 8) *
    2^-24 >= rate`` in fp32, compares an exact fp32 multiple of 2^-24 with
    float32(rate), whose product by 2^24 is exact: the two agree for every
    32-bit word. A rate whose fp32 rounds to 1.0 gives 2^24 and keeps
    nothing."""
    return math.ceil(float(np.float32(rate)) * (1 << 24))


@functools.lru_cache(maxsize=None)
def keep_scale(rate: float) -> float:
    """The fp32 ``1 / (1 - rate)`` a kept value is multiplied by."""
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_keep(n: int, d: int, seed, rate: float,
                 device="cpu") -> torch.Tensor:
    """Bool keep mask [n, d] of the kernels for this seed and rate."""
    bits = dropout_bits(n * d, seed, device)
    return ((bits >> 8) >= keep_threshold(rate)).reshape(n, d)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def bias_act_plain(x, bias, act="gelu", keep=None, rate=0.0):
    """What ``_bias_act_kernel`` computes, or with ``keep`` ([N, D] bool)
    ``_bias_act_dropout_kernel``."""
    y = act_fwd_plain(act, _rows(x).float() + bias.float())
    if keep is not None:
        y = torch.where(keep, y * keep_scale(rate), 0.0)
    return y.to(x.dtype).reshape(x.shape)


def bias_act_bwd_plain(x, bias, g, act="gelu", keep=None, rate=0.0):
    """What the backward kernels compute, with the partials summed: (dx in
    x's dtype, db in bias's dtype)."""
    d = act_grad_plain(act, _rows(x).float() + bias.float())
    if keep is not None:
        d = torch.where(keep, d * keep_scale(rate), 0.0)
    dx = d * _rows(g).float()
    return dx.to(x.dtype).reshape(x.shape), dx.sum(0).to(bias.dtype)


def _keep_of(x, seed, rate):
    n = _rows(x).shape[0]
    return dropout_keep(n, x.shape[-1], seed, rate, x.device)


def bias_act_dropout_plain(x, bias, seed, act="gelu", rate=0.1):
    return bias_act_plain(x, bias, act, _keep_of(x, seed, rate), rate)


def bias_act_dropout_bwd_plain(x, bias, g, seed, act="gelu", rate=0.1):
    return bias_act_bwd_plain(x, bias, g, act, _keep_of(x, seed, rate), rate)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL)
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
        lib.dstt_bias_act.argtypes = [i, p, p, p, p, p, ctypes.c_longlong, i,
                                      i, i, u, f, u, i, i, p]
        lib.dstt_bias_act.restype = ctypes.c_int
        lib.dstt_bias_act_plan.argtypes = [i, i, ctypes.c_longlong, i, i,
                                           ctypes.c_ulonglong, i,
                                           ctypes.POINTER(i)]
        lib.dstt_bias_act_plan.restype = ctypes.c_int
        _lib = lib
    return _lib


def rows_per_pass(kind: int, act: int) -> int:
    """Rows a thread's pass of kernel ``kind`` (its index in LAUNCH_NAMES)
    with activation code ``act`` takes; the mirror of the source's."""
    return 1 if kind == 3 or (kind == 2 and act != ACTS.index("silu")) else 2


def blocks_per_sm(kind: int, act: int) -> int:
    """Blocks an SM holds of that kernel (a grid is one wave of them; more
    rows loop); the mirror of the source's: the dropout forward 6 (silu,
    whose division needs more registers, 4), the plain forward 4, the
    backward kernels 3."""
    if kind == 2:
        return 4 if act == ACTS.index("silu") else 6
    return 4 if kind == 0 else 3


def launch_layout(n: int, d: int, sms: int, cols: int = 4,
                  blocks_per_sm: int = 4) -> Tuple[int, int]:
    """(threads per row, grid rows) of a launch over [n, d]: each thread
    takes ``cols`` columns (4 or 8), ``tpr`` threads a tile of cols * tpr
    columns, a block THREADS / tpr rows at a time; the grid holds about
    ``blocks_per_sm`` blocks per SM and its rows loop over the rest. The
    backward writes one row of db partials per grid row. With 4 columns
    ``tpr`` is the fewest threads (a power of two up to THREADS) that cover
    the row; with 8, of the powers of two from 32 to that one, the one that
    leaves the fewest idle threads in the row's tiles (the largest of
    equals): 128 at BERT-base's 3072, where 256 would idle a quarter."""
    chunks = -(-d // cols)
    tpr = 1
    while tpr < THREADS and tpr < chunks:
        tpr *= 2
    if cols == 8:
        def idle(t):
            return -(-chunks // t) * t - chunks
        t = tpr // 2
        while t >= 32:
            if idle(t) < idle(tpr):
                tpr = t
            t //= 2
    gx = -(-d // (cols * tpr))
    groups = -(-n // (THREADS // tpr))
    return tpr, max(1, min(groups, max(1, sms * blocks_per_sm // gx), 65535))


@functools.lru_cache(maxsize=4096)
def launch_plan(kind: int, act: int, n: int, d: int, dtype: torch.dtype,
                addr: int, sms: int) -> Tuple[int, int, int, int, int]:
    """(cols, vec, tpr, grid_x, grid_y) of kernel ``kind`` with activation
    code ``act`` over [n, d] of ``dtype`` whose operands' addresses (x, g,
    the output) OR to ``addr``;
    the mirror of ``plan`` in csrc/fused_bias_act.cu, which refuses a launch
    whose grid rows differ. 8 bf16 columns a thread (16-byte accesses)
    where D % 8 == 0 and ``addr`` is 16-byte aligned; else 4, in whole-word
    accesses (``vec``) where D % 4 == 0 and the 4 elements' bytes align,
    one element at a time otherwise."""
    bf16 = dtype == torch.bfloat16
    cols = 8 if bf16 and d % 8 == 0 and addr % 16 == 0 else 4
    esize = 2 if bf16 else 4
    vec = int(cols == 8 or (d % 4 == 0 and addr % (4 * esize) == 0))
    tpr, gy = launch_layout(n, d, sms, cols, blocks_per_sm(kind, act))
    return cols, vec, tpr, -(-d // (cols * tpr)), gy


def launch_plan_of_library(kind: int, act: int, n: int, d: int,
                           dtype: torch.dtype, addr: int,
                           sms: int) -> Tuple[int, ...]:
    """The built library's plan for the same arguments (what
    ``launch_plan`` mirrors); launches nothing."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    err = _library().dstt_bias_act_plan(kind, act, n, d, _DTYPES[dtype], addr,
                                        sms, out)
    if err != 0:
        raise RuntimeError(f"dstt_bias_act_plan failed: CUDA error {err}")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_bias_act kernel: {msg}")


def _launch(kind: int, x, bias, g, act, seed=0, rate=0.0):
    """Launch kernel ``kind`` (its index in LAUNCH_NAMES) on x [..., D];
    returns the output (forward) or (dx, db) (backward)."""
    name = LAUNCH_NAMES[kind]
    _check(x.device.type == "cuda" and bias.device == x.device,
           f"x on {x.device}, bias on {bias.device}")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} (float32, bfloat16)")
    _check(bias.dtype.is_floating_point, f"bias dtype {bias.dtype}")
    _check(x.dim() >= 1 and x.shape[-1] > 0, "x needs a last axis of D > 0")
    d = x.shape[-1]
    _check(bias.shape == (d,), f"bias {tuple(bias.shape)} for rows of {d}")
    bwd = kind in (1, 3)
    if bwd:
        _check(g.shape == x.shape and g.dtype == x.dtype and g.device == x.device,
               f"g {tuple(g.shape)} {g.dtype} for x {tuple(x.shape)} {x.dtype}")
    x2 = _rows(x).contiguous()
    n = x2.shape[0]
    out = torch.empty_like(x2)
    if n == 0:
        return (out.reshape(x.shape), torch.zeros_like(bias)) if bwd \
            else out.reshape(x.shape)
    g2 = _rows(g).contiguous() if bwd else None
    b32 = bias.float().contiguous()
    addr = x2.data_ptr() | out.data_ptr() | (g2.data_ptr() if bwd else 0)
    dev = x.device.index
    sms = _sm_count(dev)
    code = _check_act(act)
    gy = launch_plan(kind, code, n, d, x.dtype, addr & 15, sms)[-1]
    parts = torch.empty(gy, d, dtype=torch.float32, device=x.device) if bwd \
        else None
    drop = kind >= 2
    args = (kind, x2.data_ptr(), b32.data_ptr(), g2.data_ptr() if bwd else None,
            out.data_ptr(), parts.data_ptr() if bwd else None, n, d,
            _DTYPES[x.dtype], code, keep_threshold(rate) if drop else 0,
            keep_scale(rate) if drop else 1.0, seed_key(seed), sms, gy,
            torch.cuda.current_stream(x.device).cuda_stream)
    lib = _library()
    if torch.cuda.current_device() == dev:
        err = lib.dstt_bias_act(*args)
    else:                        # the launch goes to the current device
        with torch.cuda.device(dev):
            err = lib.dstt_bias_act(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    build.count_launch(name)
    if bwd:                      # the second, ordered pass over the partials
        return out.reshape(x.shape), parts.sum(0).to(bias.dtype)
    return out.reshape(x.shape)


def bias_act_fwd(x, bias, act="gelu"):
    """act(x + bias): the kernel on CUDA tensors, the plain version on CPU."""
    if on_card(x, "fused_bias_act"):
        return _launch(0, x, bias, None, act)
    return bias_act_plain(x, bias, act)


def bias_act_bwd(x, bias, g, act="gelu"):
    """(dx, db) of act(x + bias) for the output gradient g."""
    if on_card(x, "fused_bias_act"):
        return _launch(1, x, bias, g, act)
    return bias_act_bwd_plain(x, bias, g, act)


def bias_act_dropout_fwd(x, bias, seed, act="gelu", rate=0.1):
    if on_card(x, "fused_bias_act_dropout"):
        return _launch(2, x, bias, None, act, seed, rate)
    return bias_act_dropout_plain(x, bias, seed, act, rate)


def bias_act_dropout_bwd(x, bias, g, seed, act="gelu", rate=0.1):
    if on_card(x, "fused_bias_act_dropout"):
        return _launch(3, x, bias, g, act, seed, rate)
    return bias_act_dropout_bwd_plain(x, bias, g, seed, act, rate)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
class FusedBiasActFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, act):
        ctx.save_for_backward(x, bias)
        ctx.act = act
        return bias_act_fwd(x, bias, act)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx, db = bias_act_bwd(x, bias, g.contiguous(), ctx.act)
        return dx, db, None


class FusedBiasActDropoutFunction(torch.autograd.Function):
    """The backward draws the forward's mask again from the seed."""

    @staticmethod
    def forward(ctx, x, bias, seed, act, rate):
        ctx.save_for_backward(x, bias)
        ctx.seed, ctx.act, ctx.rate = seed, act, rate
        return bias_act_dropout_fwd(x, bias, seed, act, rate)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx, db = bias_act_dropout_bwd(x, bias, g.contiguous(), ctx.seed,
                                      ctx.act, ctx.rate)
        return dx, db, None, None, None


def fused_bias_act(x: torch.Tensor, bias: torch.Tensor,
                   act: str = "gelu") -> torch.Tensor:
    """act(x + bias) in one pass; x [..., D], bias [D]; differentiable in
    both."""
    _check_act(act)
    return FusedBiasActFunction.apply(x, bias, act)


def fused_bias_act_dropout(x: torch.Tensor, bias: torch.Tensor, seed,
                           act: str = "gelu", rate: float = 0.1) -> torch.Tensor:
    """dropout(act(x + bias)) with the mask drawn in the kernel from
    ``seed`` (an int32 value) and drawn again in the backward; ``rate == 0``
    is ``fused_bias_act``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    _check_act(act)
    if rate == 0.0:
        return fused_bias_act(x, bias, act)
    return FusedBiasActDropoutFunction.apply(x, bias, seed_key(seed), act, rate)
