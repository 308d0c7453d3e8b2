"""FP6 / FP12 software minifloat formats with dense bit packing.

Port of ``deepspeed_tpu/ops/fp_formats.py``: the same formats, encode and
decode arithmetic, byte packing and per-row scaling, as torch integer and
float ops (the reference's are jnp; neither has a kernel of its own).

- **fp6**  = 1 sign + 3 exponent + 2 mantissa (e3m2, bias 3, no inf/nan,
  max normal 28.0)
- **fp12** = 1 sign + 5 exponent + 6 mantissa (e5m6, bias 15)

Codes pack densely into ``uint8`` (4 x 6-bit codes -> 3 bytes, 2 x 12-bit
codes -> 3 bytes); codes are held in int32 while they are built (torch's
uint32 has no bitwise ops). Scaling is per row (last axis), symmetric
fp32: the row absmax maps onto the format's max normal. ``FPQuantizer``
sends 8 bits to the fp8 kernels (``ops/fp_quant.py``).
"""

from typing import Tuple

import torch

from deepspeed_tpu_torch.ops.quant import row_scales

# fmt -> (e_bits, m_bits)
FP_FORMATS = {"fp6": (3, 2), "fp12": (5, 6)}


def format_max(fmt: str) -> float:
    e_bits, m_bits = FP_FORMATS[fmt]
    bias = 2 ** (e_bits - 1) - 1
    emax = 2 ** e_bits - 1 - bias
    return float(2.0 ** emax * (2.0 - 2.0 ** -m_bits))


# ---------------------------------------------------------------------------
# scalar-format encode/decode (vectorized over tensors of fp32)
# ---------------------------------------------------------------------------
def _encode(x: torch.Tensor, e_bits: int, m_bits: int) -> torch.Tensor:
    """fp32 -> int32 codes (1+e_bits+m_bits bits, ieee-like layout with
    subnormals, round-to-nearest, saturation, no inf/nan)."""
    bias = 2 ** (e_bits - 1) - 1
    emax = 2 ** e_bits - 1 - bias
    mscale = 2 ** m_bits
    x = x.float()
    sign = (x < 0).to(torch.int32)
    ax = x.abs()
    # everything below the subnormal range clamps to the e = 1-bias bucket,
    # whose step also covers subnormals (ieee property)
    e = torch.floor(torch.log2(torch.clamp_min(ax, 2.0 ** (1 - bias))))
    e = torch.clamp(e, 1 - bias, emax)
    q = torch.round(ax * torch.exp2(m_bits - e)).to(torch.int32)
    of = q >= 2 * mscale                       # rounded up into next exponent
    e = torch.where(of, e + 1, e)
    q = torch.where(of, mscale, q)
    sat = e > emax                             # saturate at max finite
    e = torch.where(sat, float(emax), e)
    q = torch.where(sat, 2 * mscale - 1, q)
    subnormal = q < mscale                     # only possible at e == 1-bias
    e_idx = torch.where(subnormal, 0, (e + bias).to(torch.int32))
    mant = torch.where(subnormal, q, q - mscale)
    return (sign << (e_bits + m_bits)) | (e_idx << m_bits) | mant


def _decode(code: torch.Tensor, e_bits: int, m_bits: int) -> torch.Tensor:
    """integer codes -> fp32 values."""
    bias = 2 ** (e_bits - 1) - 1
    mscale = 2 ** m_bits
    code = code.to(torch.int32)
    sign = (code >> (e_bits + m_bits)) & 1
    e_idx = (code >> m_bits) & (2 ** e_bits - 1)
    mant = code & (mscale - 1)
    normal = e_idx > 0
    e = torch.where(normal, e_idx - bias, 1 - bias)
    frac = torch.where(normal, mant + mscale, mant).float()
    val = frac * torch.exp2((e - m_bits).float())
    return torch.where(sign == 1, -val, val)


# ---------------------------------------------------------------------------
# dense packing: 6-bit codes 4->3 bytes, 12-bit codes 2->3 bytes
# ---------------------------------------------------------------------------
def _pack6(codes: torch.Tensor) -> torch.Tensor:   # [..., D] int, D % 4 == 0
    c = codes.to(torch.int32).reshape(*codes.shape[:-1], -1, 4)
    b0 = (c[..., 0] | (c[..., 1] << 6)) & 0xFF
    b1 = ((c[..., 1] >> 2) | (c[..., 2] << 4)) & 0xFF
    b2 = ((c[..., 2] >> 4) | (c[..., 3] << 2)) & 0xFF
    return torch.stack([b0, b1, b2], dim=-1).reshape(
        *codes.shape[:-1], -1).to(torch.uint8)


def _unpack6(packed: torch.Tensor, d: int) -> torch.Tensor:   # [..., D*3/4]
    b = packed.to(torch.int32).reshape(*packed.shape[:-1], -1, 3)
    c0 = b[..., 0] & 0x3F
    c1 = ((b[..., 0] >> 6) | (b[..., 1] << 2)) & 0x3F
    c2 = ((b[..., 1] >> 4) | (b[..., 2] << 4)) & 0x3F
    c3 = (b[..., 2] >> 2) & 0x3F
    return torch.stack([c0, c1, c2, c3], dim=-1).reshape(*packed.shape[:-1], d)


def _pack12(codes: torch.Tensor) -> torch.Tensor:  # [..., D] int, D % 2 == 0
    c = codes.to(torch.int32).reshape(*codes.shape[:-1], -1, 2)
    b0 = c[..., 0] & 0xFF
    b1 = ((c[..., 0] >> 8) | (c[..., 1] << 4)) & 0xFF
    b2 = (c[..., 1] >> 4) & 0xFF
    return torch.stack([b0, b1, b2], dim=-1).reshape(
        *codes.shape[:-1], -1).to(torch.uint8)


def _unpack12(packed: torch.Tensor, d: int) -> torch.Tensor:
    b = packed.to(torch.int32).reshape(*packed.shape[:-1], -1, 3)
    c0 = b[..., 0] | ((b[..., 1] & 0xF) << 8)
    c1 = (b[..., 1] >> 4) | (b[..., 2] << 4)
    return torch.stack([c0, c1], dim=-1).reshape(*packed.shape[:-1], d)


_PACK = {"fp6": (_pack6, _unpack6, 4), "fp12": (_pack12, _unpack12, 2)}


# ---------------------------------------------------------------------------
# group-scaled quantize / dequantize (the FP_Quantize-equivalent surface)
# ---------------------------------------------------------------------------
def quantize_fp(x: torch.Tensor, fmt: str = "fp6"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., D] -> (packed uint8 [..., D*bits/8], fp32 scales [..., 1]).
    D must be divisible by the packing group (4 for fp6, 2 for fp12)."""
    e_bits, m_bits = FP_FORMATS[fmt]
    pack, _, group = _PACK[fmt]
    if x.shape[-1] % group:
        raise ValueError(f"{fmt}: last dim {x.shape[-1]} not divisible "
                         f"by the packing group {group}")
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).float()
    scale = row_scales(x2d, format_max(fmt))
    codes = _encode(x2d / scale, e_bits, m_bits)
    packed = pack(codes)
    return packed.reshape(*shape[:-1], -1), scale.reshape(*shape[:-1], 1)


def dequantize_fp(packed: torch.Tensor, scales: torch.Tensor, fmt: str,
                  d: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_fp`; ``d`` is the unpacked last dim."""
    e_bits, m_bits = FP_FORMATS[fmt]
    _, unpack, _ = _PACK[fmt]
    vals = _decode(unpack(packed, d), e_bits, m_bits)
    return (vals * scales.float()).to(dtype)


def selective_dequantize_fp(packed: torch.Tensor, scales: torch.Tensor,
                            rows: torch.Tensor, fmt: str, d: int,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """Gather a row subset of a packed tensor and dequantize only those.
    packed: [N, Dp]; scales: [N, 1]; rows: [K] int -> [K, d]."""
    rows = rows.long()
    return dequantize_fp(packed[rows], scales[rows], fmt, d, dtype)


class FPQuantizer:
    """The reference ``FP_Quantize`` surface (q_bits 6/8/12): 8 bits go to
    the fp8 kernels, 6 and 12 to the packed software formats here."""

    def __init__(self, q_bits: int = 8, fp8_fmt: str = "e4m3"):
        if q_bits not in (6, 8, 12):
            raise ValueError(f"q_bits must be 6, 8 or 12, got {q_bits}")
        self.q_bits = q_bits
        self.fp8_fmt = fp8_fmt

    def quantize(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.q_bits == 8:
            from deepspeed_tpu_torch.ops.fp_quant import quantize_fp8
            return quantize_fp8(x, fmt=self.fp8_fmt)
        return quantize_fp(x, fmt=f"fp{self.q_bits}")

    def dequantize(self, q: torch.Tensor, scales: torch.Tensor, d: int = None,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        if self.q_bits == 8:
            from deepspeed_tpu_torch.ops.fp_quant import dequantize_fp8
            return dequantize_fp8(q, scales, dtype=dtype)
        if d is None:
            raise ValueError("packed formats need the unpacked dim d")
        return dequantize_fp(q, scales, f"fp{self.q_bits}", d, dtype)
