"""Per-row symmetric int8 quantization: plain versions, the CUDA kernels'
wrappers and launch counts.

Port of ``deepspeed_tpu/ops/pallas/quant.py``. The TPU kernels
``_quant_kernel`` and ``_dequant_kernel`` (run through
``rowwise_pallas_op``) become the hand-written CUDA kernels of
``csrc/quant.cu`` (design notes there), launched by ``quantize_int8`` and
``dequantize_int8`` and counted under those names. The same source holds
the fp8 kernels that ``ops/fp_quant.py`` wraps; ``quantize_rows_cuda`` and
``dequantize_rows_cuda`` launch either. ``dequant_plan`` and
``dequant_chunks`` mirror how the fp8 dequantize kernel splits a call into
16-code chunks and scalar codes, from the shape and the pointers'
alignment.

``quant_plan`` and ``quant_elements`` mirror how the int8 quantize kernel
splits a call into 16-byte chunks and scalar elements and which instance
(a warp, a block or a thread-block cluster per row) runs it, from the
shape and the pointers' alignment (``quant_plan`` in csrc/quant.cu).

``quantize_int8_scaled`` (csrc/quant.cu's ``quantize_int8_scaled``) makes
the codes of rows whose fp32 scales are given: qwZ's rows of a leaf cut
along its last axis, whose scale is the whole row's (``runtime/zero/
partition.py::qwz_codes``); it is the ``_quant_kernel``'s encode step,
``clip(round(x / scale))``, and counted under its own name.

``quantize_int8_plain`` and ``dequantize_int8_plain`` compute the
reference's function with the reference's rounding points (the scale as
``absmax`` times the fp32 reciprocal of 127, which is what XLA makes of
``absmax / 127.0``; then the true division ``x / scale``, round half to
even, one fp32 product and one cast), so a kernel and its plain version
agree bit for bit. CPU tensors run the plain
versions; CUDA tensors launch the kernels or raise. Nothing catches a build
or launch failure to run a plain version instead.

Rows are the last axis: ``x [..., D]`` gives codes ``[..., D]`` and fp32
scales ``[..., 1]``. The TPU's ``block_rows`` padding has no counterpart.
The collectives built on these kernels (``quantized_all_gather``,
``quantized_psum_scatter``, ``all_to_all_quant_reduce``,
``quantized_psum``, ``quantized_all_to_all``) run over the comm facade
(``comm/comm.py``) on the global mesh's process groups.
"""

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import build

KERNEL = "quant"
INT8_MAX = 127.0
SCALE_FLOOR = 1e-12
# codes of csrc/quant.cu
CODE_INT8, CODE_E4M3, CODE_E5M2 = 0, 1, 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_CODE_DTYPES = {CODE_INT8: torch.int8, CODE_E4M3: torch.float8_e4m3fn,
                CODE_E5M2: torch.float8_e5m2}
_lib: Optional[ctypes.CDLL] = None


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------
def reciprocal(qmax: float) -> float:
    """The fp32 reciprocal of ``qmax``, rounded once, as XLA folds it."""
    return float(np.float32(1.0) / np.float32(qmax))


def row_scales(x2d: torch.Tensor, qmax: float) -> torch.Tensor:
    """[N, D] -> fp32 [N, 1]: the reference's ``max(absmax / qmax,
    1e-12)`` per row as XLA computes it: a division by a constant becomes a
    product with the constant's fp32 reciprocal (``x / scale``, a division
    by a tensor, stays a division)."""
    absmax = x2d.float().abs().amax(dim=-1, keepdim=True)
    return torch.clamp_min(absmax * reciprocal(qmax), SCALE_FLOOR)


def quantize_int8_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_quant_kernel`` computes: x [..., D] -> (int8 codes [..., D],
    fp32 scales [..., 1])."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).float()
    scale = row_scales(x2d, INT8_MAX)
    q = torch.clamp(torch.round(x2d / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8).reshape(shape), scale.reshape(*shape[:-1], 1)


def quantize_int8_scaled_plain(x: torch.Tensor, scales: torch.Tensor
                               ) -> torch.Tensor:
    """What ``quantize_int8_scaled`` computes: x [..., D] and fp32 scales
    [..., 1] -> int8 codes ``clip(round(x / scale), -127, 127)``."""
    d = x.shape[-1]
    q = torch.clamp(torch.round(x.reshape(-1, d).float()
                                / scales.reshape(-1, 1).float()),
                    -INT8_MAX, INT8_MAX)
    return q.to(torch.int8).reshape(x.shape)


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """What ``_dequant_kernel`` and ``_fp8_dequant_kernel`` compute:
    ``(float(q) * scale)`` cast to ``dtype``, q [..., D], scales [..., 1]."""
    d = q.shape[-1]
    out = q.reshape(-1, d).float() * scales.reshape(-1, 1).float()
    return out.to(dtype).reshape(q.shape)


dequantize_int8_plain = dequantize_plain


# ---------------------------------------------------------------------------
# how the fp8 dequantize kernel splits a call (``deq_plan`` and
# ``dequantize_fp8`` in csrc/quant.cu)
# ---------------------------------------------------------------------------
DEQ_CHUNK = 16             # codes one 16-byte load of the kernel brings


def dequant_plan(n: int, d: int, q_offset: int, out_offset: int,
                 out_itemsize: int) -> Tuple[int, int, int]:
    """(head0, chunks, rest) of a call on codes [n, d] whose first code
    lies ``q_offset`` bytes past a 16-byte boundary and whose first output
    ``out_offset`` bytes past one. Row r's first 16-byte code boundary lies
    ``(head0 - r * d) % 16`` codes in; ``chunks`` whole 16-code chunks
    follow it in every row, and each row's other ``rest = d - 16 *
    chunks`` codes take the scalar path. No chunks unless a code on a
    16-byte boundary has its output on one too."""
    if (out_offset - q_offset * out_itemsize) % 16:
        return 0, 0, d
    head0 = -q_offset % 16
    hmax = max((head0 - r * d) % 16 for r in range(min(n, 16)))
    if d < hmax + DEQ_CHUNK:
        return head0, 0, d
    chunks = (d - hmax) // DEQ_CHUNK
    return head0, chunks, d - DEQ_CHUNK * chunks


def dequant_chunks(n: int, d: int, q_offset: int, out_offset: int,
                   out_itemsize: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's split of a call as flat code indices: (the first code
    of each 16-code chunk, each code of the scalar path), as
    ``dequant_plan`` says."""
    head0, chunks, rest = dequant_plan(n, d, q_offset, out_offset,
                                       out_itemsize)
    rows = np.arange(n, dtype=np.int64)[:, None]
    head = (head0 - rows * d) % 16 if chunks else np.zeros_like(rows)
    starts = rows * d + head + DEQ_CHUNK * np.arange(chunks)
    k = np.arange(rest)
    scalars = rows * d + np.where(k < head, k, k + DEQ_CHUNK * chunks)
    return starts.reshape(-1), scalars.reshape(-1)


# ---------------------------------------------------------------------------
# how the int8 quantize kernel splits a call (``quant_plan`` and
# ``quantize_int8_{warp,block,cluster}`` in csrc/quant.cu)
# ---------------------------------------------------------------------------
QUANT_CLUSTER = 16         # CTAs of the cluster that holds one wide row
# the plan's fields, in the order ``dstt_quant_plan`` writes them
QUANT_PLAN_FIELDS = ("head0", "dmod", "vec", "chunks", "rest", "wide", "path",
                     "threads", "per", "rows", "cluster", "seg")


def quant_plan(n: int, d: int, x_offset: int, q_offset: int,
               itemsize: int) -> dict:
    """The int8 quantize kernel's plan of x [n, d] (elements of
    ``itemsize`` bytes, the first ``x_offset`` bytes past a 16-byte
    boundary; codes ``q_offset`` bytes past one). A chunk is the ``vec`` =
    16 / itemsize elements of one 16-byte load; row r's first chunk starts
    ``(head0 - r * d) % vec`` elements in, ``chunks`` whole chunks follow
    in every row and its other ``rest`` elements take the scalar path;
    ``wide``: a chunk's codes go out in one store. ``path`` (0 warp, 1
    block, 2 cluster, -1 none fits), ``threads`` and ``per`` (chunks a lane
    or thread holds) name the instance, ``rows`` the rows a warp takes;
    ``cluster`` CTAs hold one row in segments of ``seg`` chunks. Fields as
    ``QUANT_PLAN_FIELDS``."""
    vec = 16 // itemsize
    pl = dict(head0=0, dmod=d % vec, vec=vec, chunks=0, rest=d, wide=0,
              path=0, threads=32, per=1, rows=1, cluster=1, seg=0)
    if x_offset % itemsize == 0:
        pl["head0"] = (-x_offset % 16) // itemsize
        hmax = max((pl["head0"] - r * d) % vec for r in range(min(n, vec)))
        if d >= hmax + vec:
            pl["chunks"] = (d - hmax) // vec
            pl["rest"] = d - vec * pl["chunks"]
        pl["wide"] = int((q_offset - x_offset // itemsize) % vec == 0)
    c = pl["chunks"]
    pl["seg"] = c
    if c <= 128:
        pl["per"] = 1 if c <= 32 else 2 if c <= 64 else 4
        pl["rows"] = 4 // pl["per"]
    elif c <= 4096:
        pl["path"] = 1
        if c <= 1024:
            pl["threads"] = 256
            pl["per"] = 1 if c <= 256 else 2 if c <= 512 else 4
        else:
            pl["threads"] = 512
            pl["per"] = 4 if c <= 2048 else 7 if c <= 3584 else 8
    else:
        pl["path"], pl["cluster"] = 2, QUANT_CLUSTER
        seg = pl["seg"] = -(-c // QUANT_CLUSTER)
        pl["threads"] = 512
        pl["per"] = 2 if seg <= 1024 else 4 if seg <= 2048 else 8
        if seg > 4096:
            pl["path"] = -1
    if pl["rest"] > 32:
        pl["path"] = -1
    return pl


def quant_elements(n: int, d: int, x_offset: int, q_offset: int,
                   itemsize: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's split of a call as flat element indices: (the first
    element of each chunk, the CTA of its row's cluster that holds it (0
    off the cluster path), each element of the scalar path), as
    ``quant_plan`` says."""
    pl = quant_plan(n, d, x_offset, q_offset, itemsize)
    vec, chunks, rest = pl["vec"], pl["chunks"], pl["rest"]
    rows = np.arange(n, dtype=np.int64)[:, None]
    head = (pl["head0"] - rows * d) % vec if chunks else np.zeros_like(rows)
    cols = np.arange(chunks)
    starts = rows * d + head + vec * cols
    ctas = np.broadcast_to(cols // max(pl["seg"], 1), starts.shape)
    k = np.arange(rest)
    scalars = rows * d + np.where(k < head, k, k + vec * chunks)
    return starts.reshape(-1), ctas.reshape(-1), scalars.reshape(-1)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dstt_quantize_rows.argtypes = [p, p, p, ll, i, i, i, p]
        lib.dstt_dequantize_rows.argtypes = [p, p, p, ll, i, i, i, p]
        lib.dstt_quantize_rows.restype = ctypes.c_int
        lib.dstt_dequantize_rows.restype = ctypes.c_int
        lib.dstt_quant_plan.argtypes = [p, p, ll, i, i, p]
        lib.dstt_quant_plan.restype = ctypes.c_int
        lib.dstt_quantize_int8_scaled.argtypes = [p, p, p, ll, i, i, p]
        lib.dstt_quantize_int8_scaled.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"quant kernel: {msg}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def quantize_rows_cuda(x: torch.Tensor, code: int, name: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the quantize kernel of ``code`` on x [..., D] (fp32, bf16 or
    fp16 on the card); counted as ``name``."""
    _check(x.device.type == "cuda", f"tensor on {x.device}")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} (float32, bfloat16, float16)")
    _check(x.dim() >= 1 and x.shape[-1] > 0, "x needs a last axis of D > 0")
    shape = x.shape
    d = shape[-1]
    x2d = x.reshape(-1, d).contiguous()
    n = x2d.shape[0]
    q = torch.empty(shape, dtype=_CODE_DTYPES[code], device=x.device)
    s = torch.empty(*shape[:-1], 1, dtype=torch.float32, device=x.device)
    if n == 0:
        return q, s
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dstt_quantize_rows(x2d.data_ptr(), q.data_ptr(), s.data_ptr(),
                                     n, d, _DTYPES[x.dtype], code, stream)
    _raise_on(err, name)
    build.count_launch(name)
    return q, s


def quantize_int8_scaled_cuda(x: torch.Tensor, scales: torch.Tensor
                              ) -> torch.Tensor:
    """Launch ``quantize_int8_scaled`` on x [..., D] (fp32, bf16 or fp16)
    with fp32 scales [..., 1]; counted as ``quantize_int8_scaled``."""
    _check(x.device.type == "cuda" and scales.device == x.device,
           f"x on {x.device}, scales on {scales.device}")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} (float32, bfloat16, float16)")
    _check(scales.dtype == torch.float32, f"scales {scales.dtype} (float32)")
    _check(x.dim() >= 1 and x.shape[-1] > 0, "x needs a last axis of D > 0")
    d = x.shape[-1]
    x2d = x.reshape(-1, d).contiguous()
    s = scales.reshape(-1).contiguous()
    n = x2d.shape[0]
    _check(s.numel() == n, f"{s.numel()} scales for {n} rows")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if n == 0:
        return q
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dstt_quantize_int8_scaled(x2d.data_ptr(), s.data_ptr(),
                                            q.data_ptr(), n, d,
                                            _DTYPES[x.dtype], stream)
    _raise_on(err, "quantize_int8_scaled")
    build.count_launch("quantize_int8_scaled")
    return q


def quant_plan_of_library(x_ptr: int, q_ptr: int, n: int, d: int,
                          dtype: torch.dtype) -> dict:
    """The built library's int8 quantize plan for x [n, d] of ``dtype`` at
    address ``x_ptr`` with codes at ``q_ptr`` (what ``quant_plan``
    mirrors); reads no memory."""
    out = (ctypes.c_int * len(QUANT_PLAN_FIELDS))()
    err = _library().dstt_quant_plan(x_ptr, q_ptr, n, d, _DTYPES[dtype], out)
    _raise_on(err, "quant_plan")
    return dict(zip(QUANT_PLAN_FIELDS, out))


def dequantize_rows_cuda(q: torch.Tensor, scales: torch.Tensor, code: int,
                         dtype: torch.dtype, name: str) -> torch.Tensor:
    """Launch the dequantize kernel of ``code``: q [..., D], scales
    [..., 1] fp32 -> [..., D] in ``dtype``; counted as ``name``."""
    _check(q.device.type == "cuda" and scales.device == q.device,
           f"q on {q.device}, scales on {scales.device}")
    _check(q.dtype == _CODE_DTYPES[code], f"codes {q.dtype}, expected "
           f"{_CODE_DTYPES[code]}")
    _check(scales.dtype == torch.float32, f"scales {scales.dtype} (float32)")
    _check(dtype in _DTYPES, f"output dtype {dtype}")
    _check(q.dim() >= 1 and q.shape[-1] > 0, "q needs a last axis of D > 0")
    d = q.shape[-1]
    q2d = q.reshape(-1, d).contiguous()
    s = scales.reshape(-1).contiguous()
    n = q2d.shape[0]
    _check(s.numel() == n, f"{s.numel()} scales for {n} rows")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dstt_dequantize_rows(q2d.data_ptr(), s.data_ptr(),
                                       out.data_ptr(), n, d, code,
                                       _DTYPES[dtype], stream)
    _raise_on(err, name)
    build.count_launch(name)
    return out


def on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); anything else raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (int8 codes [..., D], fp32 scales [..., 1]) per row:
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_card(x, "quantize_int8"):
        return quantize_rows_cuda(x, CODE_INT8, "quantize_int8")
    return quantize_int8_plain(x)


def quantize_int8_scaled(x: torch.Tensor, scales: torch.Tensor
                         ) -> torch.Tensor:
    """x [..., D] and fp32 scales [..., 1] -> int8 codes per row: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_card(x, "quantize_int8_scaled"):
        return quantize_int8_scaled_cuda(x, scales)
    return quantize_int8_scaled_plain(x, scales)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_int8``: ``(float(q) * scale)`` in ``dtype``."""
    if on_card(q, "dequantize_int8"):
        return dequantize_rows_cuda(q, scales, CODE_INT8, dtype,
                                    "dequantize_int8")
    return dequantize_int8_plain(q, scales, dtype)


# ---------------------------------------------------------------------------
# the quantized collectives over the comm facade (reference
# ``ops/pallas/quant.py:87-230``): ``axis_name`` is an axis (or a tuple)
# of the global mesh, and each op runs eagerly on its process group
# ---------------------------------------------------------------------------
def quantized_all_gather(x: torch.Tensor, axis_name) -> torch.Tensor:
    """qwZ-style collective: quantize locally, all-gather the int8 codes +
    scales along dim 0, dequantize to x's dtype (reference quantized weights
    allgather, ``partition_parameters.py:1664``)."""
    from deepspeed_tpu_torch.comm import comm
    q, s = quantize_int8(x)
    qg = comm.all_gather(q, axis_name, axis=0, tiled=True)
    sg = comm.all_gather(s, axis_name, axis=0, tiled=True)
    return dequantize_int8(qg, sg, dtype=x.dtype)


def quantized_psum_scatter(x: torch.Tensor, axis_name,
                           mean: bool = False) -> torch.Tensor:
    """qgZ building block: reduce-scatter with int8 on the wire. x [N, D]
    per-member partial values; returns this member's [N/W, D] block of the
    sum (reference ``all_to_all_quant_reduce``, ``quant_reduce.cu``:
    quantize, all-to-all the codes + scales, dequantize and sum on the
    receiver). N not divisible by W is zero-padded; the pad rows end up as
    trailing zero rows of the last members' blocks."""
    from deepspeed_tpu_torch.comm import comm, compress
    _, w = comm.group_of(axis_name)
    n, d = x.shape
    pad = (-n) % w
    if pad:
        x = torch.cat([x, x.new_zeros(pad, d)])
    q, s = quantize_int8(x)
    out = compress.exchange_and_sum(
        q.reshape(w, -1, d), s.reshape(w, -1, 1),
        lambda t: comm.all_to_all(t, axis_name, 0, 0, tiled=False),
        lambda c, sc: dequantize_int8(c.reshape(-1, d), sc.reshape(-1, 1),
                                      dtype=torch.float32).reshape(w, -1, d))
    if mean:
        out = out / w
    return out.to(x.dtype)


def all_to_all_quant_reduce(x: torch.Tensor, axis_name,
                            outer_axis_name=None,
                            mean: bool = False) -> torch.Tensor:
    """qgZ: hierarchical quantized gradient reduce-scatter (reference
    ``coalesced_collectives.py:31``: int8 all-to-all within the inner
    group, dequant-reduce, a second quantized hop across the outer one)."""
    y = quantized_psum_scatter(x, axis_name, mean=mean)
    if outer_axis_name is not None:
        y = quantized_psum_scatter(y, outer_axis_name, mean=mean)
    return y


def _quantized_psum_core(x, axes, mean):
    rows = []
    for ax in reversed(tuple(axes)):
        rows.append(x.shape[0])
        x = quantized_psum_scatter(x, ax, mean=mean)
    for ax, r in zip(tuple(axes), reversed(rows)):
        x = quantized_all_gather(x, ax)[:r]
    return x


class _QuantizedPsum(torch.autograd.Function):
    """The straight-through backward (reference ``quantized_psum``'s
    custom vjp, ``quant.py:164-190``): a sum whose output every member
    holds has the identity (÷W for the mean) as its exact vjp, so the
    backward moves no bytes and only the int8 rounding is passed
    through."""

    @staticmethod
    def forward(ctx, x, axes, mean):
        from deepspeed_tpu_torch.comm import comm
        ctx.mean = mean
        ctx.world = comm.group_of(axes)[1]
        return _quantized_psum_core(x, axes, mean)

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.world if ctx.mean else g), None, None


def quantized_psum(x: torch.Tensor, axes, mean: bool = False) -> torch.Tensor:
    """All-reduce with int8 on the wire: hierarchical quantized
    reduce-scatter (innermost axis first) + int8 regather over ``axes``
    (outermost first). x [N, D]; every member gets the result.
    Differentiable with the straight-through backward."""
    from deepspeed_tpu_torch.comm.mesh import axes_tuple
    return _QuantizedPsum.apply(x, axes_tuple(axes), mean)


def quantized_all_to_all(x: torch.Tensor, axis_name, split_axis: int = 0,
                         concat_axis: int = 0) -> torch.Tensor:
    """MoE-dispatch collective with an int8 wire (cf. EQuARX): quantize
    per row (the last axis), all-to-all the codes + scales, dequantize on
    the receiver. The split axis must not be the last one."""
    from deepspeed_tpu_torch.comm import comm
    q, s = quantize_int8(x)
    qx = comm.all_to_all(q, axis_name, split_axis, concat_axis, tiled=True)
    sx = comm.all_to_all(s, axis_name, split_axis, concat_axis, tiled=True)
    return dequantize_int8(qx, sx, dtype=x.dtype)
