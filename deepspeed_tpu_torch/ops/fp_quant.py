"""Per-row fp8 (e4m3 / e5m2) quantization: plain versions, the CUDA
kernels' wrappers and launch counts.

Port of ``deepspeed_tpu/ops/pallas/fp_quant.py``. The TPU kernels
``_fp8_quant_kernel`` and ``_fp8_dequant_kernel`` become the hand-written
CUDA kernels of ``csrc/quant.cu``, launched by ``quantize_fp8`` and
``dequantize_fp8`` and counted under those names. The plain versions divide
(``x / scale``) and convert to ``torch.float8_*`` with round-to-nearest-even
as the reference does, so kernel and plain version agree bit for bit.
CPU tensors run the plain versions; CUDA tensors launch the kernels or
raise.

``quantized_all_gather_fp8`` is the fp8 all-gather over the comm facade.
Not ported yet (ROADMAP Queue 2): ``fp8_matmul`` and the ``fp8_gemm`` pair
(a Hopper fp8 GEMM is a kernel of its own).
"""

from typing import Tuple

import torch

from deepspeed_tpu_torch.ops.quant import (CODE_E4M3, CODE_E5M2,
                                           dequantize_plain,
                                           dequantize_rows_cuda, on_card,
                                           quantize_rows_cuda, row_scales)

# max finite magnitude per format
FP8_FORMATS = {
    "e4m3": (torch.float8_e4m3fn, 448.0),
    "e5m2": (torch.float8_e5m2, 57344.0),
}
_CODES = {"e4m3": CODE_E4M3, "e5m2": CODE_E5M2}
_FMT_OF = {torch.float8_e4m3fn: "e4m3", torch.float8_e5m2: "e5m2"}


def quantize_fp8_plain(x: torch.Tensor, fmt: str = "e4m3"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_fp8_quant_kernel`` computes: x [..., D] -> (fp8 codes
    [..., D], fp32 scales [..., 1])."""
    dtype, fmax = FP8_FORMATS[fmt]
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).float()
    scale = row_scales(x2d, fmax)
    return (x2d / scale).to(dtype).reshape(shape), \
        scale.reshape(*shape[:-1], 1)


dequantize_fp8_plain = dequantize_plain


def quantize_fp8(x: torch.Tensor, fmt: str = "e4m3"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (fp8 values [..., D], fp32 scales [..., 1]) per row:
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if fmt not in FP8_FORMATS:
        raise ValueError(f"unknown fp8 format {fmt!r}; one of "
                         f"{sorted(FP8_FORMATS)}")
    if on_card(x, "quantize_fp8"):
        return quantize_rows_cuda(x, _CODES[fmt], "quantize_fp8")
    return quantize_fp8_plain(x, fmt)


def dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_fp8`` (the format is q's dtype)."""
    if q.dtype not in _FMT_OF:
        raise ValueError(f"dequantize_fp8: codes {q.dtype} are not fp8")
    if on_card(q, "dequantize_fp8"):
        return dequantize_rows_cuda(q, scales, _CODES[_FMT_OF[q.dtype]],
                                    dtype, "dequantize_fp8")
    return dequantize_fp8_plain(q, scales, dtype)


def selective_dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                             rows: torch.Tensor,
                             dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """Gather a subset of quantized rows and dequantize only those. q:
    [N, D]; scales: [N, 1]; rows: [K] int -> [K, D] in ``dtype``."""
    rows = rows.long()
    return dequantize_fp8(q[rows], scales[rows], dtype=dtype)


def _unported(name: str):
    raise NotImplementedError(
        f"{name} is not ported yet (ROADMAP Queue 2: an fp8 GEMM kernel for "
        "Hopper)")


def quantized_all_gather_fp8(x: torch.Tensor, axis_name,
                             fmt: str = "e4m3") -> torch.Tensor:
    """qwZ-style collective with an fp8 wire: quantize per row, all-gather
    the codes + scales along dim 0 over the comm facade, dequantize to x's
    dtype."""
    from deepspeed_tpu_torch.comm import comm
    q, s = quantize_fp8(x, fmt=fmt)
    qg = comm.all_gather(q, axis_name, axis=0, tiled=True)
    sg = comm.all_gather(s, axis_name, axis=0, tiled=True)
    return dequantize_fp8(qg, sg, dtype=x.dtype)


def fp8_matmul(a, b_q, b_scales, preferred=torch.float32):
    _unported("fp8_matmul")


def fp8_gemm_quantize(a, b, fmt: str = "e4m3"):
    _unported("fp8_gemm_quantize")


def fp8_gemm(a_q, s_m, b_q, s_n, out_dtype=torch.bfloat16):
    _unported("fp8_gemm")
