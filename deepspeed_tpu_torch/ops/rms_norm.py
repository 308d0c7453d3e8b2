"""Fused RMSNorm: the plain version, the CUDA kernel's wrapper and the
autograd function with the reference's analytic backward.

Port of ``deepspeed_tpu/ops/pallas/rms_norm.py``. Its TPU kernel
``_rms_fwd_kernel`` becomes the hand-written CUDA kernel of
``csrc/rms_norm.cu`` (design notes there), launched by ``rms_norm_cuda`` and
counted as ``rms_norm``. The backward is the reference's ``_bwd`` in eager
torch, as it is ``jnp`` there, not a kernel.

``rms_norm(x, scale, eps)`` computes ``x * rsqrt(mean(x^2) + eps) * scale``
over the last axis, with the mean in fp32 and the output in x's dtype. CPU
tensors run the plain version; CUDA tensors launch the kernel or raise.
Nothing catches a build or launch failure to run the plain version
instead. The Pallas ``block_rows`` and ``interpret`` arguments are TPU
tiling knobs and have no counterpart.
"""

import ctypes
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.quant import on_card

KERNEL = "rms_norm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------
def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """The reference's ``rms_norm_reference``, which is also what
    ``_rms_fwd_kernel`` computes: fp32 mean of squares, ``rsqrt``, then
    ``(x * inv) * scale`` rounded once to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


rms_norm_plain = rms_norm_reference


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                 eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's analytic ``_bwd``: (dx in x's dtype, dscale in
    scale's dtype), with ``inv = (mean(x^2) + eps)^-1/2`` and ``xhat = x *
    inv``: ``dx = inv * (g*s - xhat * mean(g*s*xhat))``, ``dscale =
    sum over rows of g * xhat``."""
    x32, g32, s32 = x.float(), g.float(), scale.float()
    inv = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    xhat = x32 * inv
    gs = g32 * s32
    dx = inv * (gs - xhat * (gs * xhat).mean(-1, keepdim=True))
    dscale = (g32 * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dstt_rms_norm.argtypes = [p, p, p, ll, i, ctypes.c_float, i, i, i, p]
        lib.dstt_rms_norm.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rms_norm kernel: {msg}")


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on x [..., D] and scale [D] (float32 or bfloat16
    each, on one card, any D); counted as ``rms_norm``."""
    _check(x.device.type == "cuda" and scale.device == x.device,
           f"x on {x.device}, scale on {scale.device}")
    _check(x.dtype in _DTYPES, f"x dtype {x.dtype} (float32, bfloat16)")
    _check(scale.dtype in _DTYPES, f"scale dtype {scale.dtype} (float32, "
           "bfloat16)")
    _check(x.dim() >= 1 and x.shape[-1] > 0, "x needs a last axis of D > 0")
    d = x.shape[-1]
    _check(scale.shape == (d,), f"scale {tuple(scale.shape)} for rows of {d}")
    x2d = x.reshape(-1, d).contiguous()
    s = scale.contiguous()
    out = torch.empty_like(x2d)
    n = x2d.shape[0]
    if n == 0:
        return out.reshape(x.shape)
    vec = int(d * x.element_size() % 16 == 0 and x2d.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dstt_rms_norm(x2d.data_ptr(), s.data_ptr(), out.data_ptr(),
                                n, d, float(eps), _DTYPES[x.dtype],
                                _DTYPES[scale.dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    build.count_launch("rms_norm")
    return out.reshape(x.shape)


def rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """The forward alone: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if on_card(x, "rms_norm"):
        return rms_norm_cuda(x, scale, eps)
    return rms_norm_plain(x, scale, eps)


class RMSNormFunction(torch.autograd.Function):
    """``pallas_rms_norm``'s custom vjp: the kernel forward, the analytic
    backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of x [..., D] with scale [D]; differentiable in both."""
    return RMSNormFunction.apply(x, scale, eps)
