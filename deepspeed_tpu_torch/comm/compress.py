"""comm/compress, first part: the quantized error-feedback collectives.

Port of ``deepspeed_tpu/comm/compress.py:56-300``: EQuARX-style quantized
all-reduce / reduce-scatter (arxiv 2506.17615: int8/fp8 codes with
per-chunk fp32 scales and error feedback) over any axis set of the global
mesh. The qgZ gradient sync (``runtime/zero/qgz.py``) and the facade's
``quantized_all_reduce`` / ``quantized_reduce_scatter`` are adapters over
it. ``CommCompressionConfig``, the gradient buckets, ``GradCompressor``
and ``compressed.py`` are not ported yet (ROADMAP Queue 1 item 2).

The codec is the ported kernels. ``quantize_wire`` runs on a ``[n/chunk,
chunk]`` view: int8 is ``absmax/127`` floored at 1e-12, then
``round(x/scale)`` clipped (``compress.py:153-166``), exactly the Pallas
``_quant_kernel``'s arithmetic, so on CUDA tensors it is ``quantize_int8``
(and ``dequantize_int8``), on CPU tensors their plain versions; fp8 (e4m3)
is ``quantize_fp8`` / ``dequantize_fp8`` the same way. The reference clips
``x/scale`` to +-448 before the e4m3 cast and the kernel does not: the
quotient of a row's values by ``absmax * fp32(1/448)`` never leaves
[-448 (1 + 2^-22), 448 (1 + 2^-22)], which the cast rounds to +-448 as the
clip does, so the two agree bit for bit.

Accounting (shared with the facade): ``bytes`` is one phase's logical
payload; ``wire_bytes`` the same payload in the wire dtype plus the fp32
per-chunk scales: ``wire_payload_bytes(n) = n * itemsize + 4 *
ceil(n / chunk)``.

Error feedback: each participant keeps a worker residual (its local
compression error, [n_pad]) and a server residual (the error of
re-quantizing its reduced shard for the regather, [n_pad / W]); both are
added before quantizing and replaced by the fresh error, ``comp - codes *
scale`` with one rounding (the fused multiply-add XLA makes of the
reference's expression).

Multi-axis groups reduce hierarchically, innermost axis first (``axes``
come outermost first): the full payload rides only the innermost hop.
"""

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

#: elements per fp32 scale group ("per-chunk scales")
DEFAULT_CHUNK = 256

#: wire dtype name -> (torch dtype, clip max, itemsize)
WIRE_DTYPES: Dict[str, Tuple[torch.dtype, float, int]] = {
    "int8": (torch.int8, 127.0, 1),
    "fp8": (torch.float8_e4m3fn, 448.0, 1),
}


# ---------------------------------------------------------------------------
# analytic wire-byte accounting
# ---------------------------------------------------------------------------
def wire_itemsize(wire_dtype: str) -> int:
    return WIRE_DTYPES[wire_dtype][2]


def padded_elems(n: int, world: int, chunk: int = DEFAULT_CHUNK) -> int:
    """Flat element count padded so every participant's shard is whole
    chunks: the smallest multiple of ``world * chunk`` >= n."""
    align = world * chunk
    return ((n + align - 1) // align) * align


def wire_payload_bytes(n_elems: int, wire_dtype: str = "int8",
                       chunk: int = DEFAULT_CHUNK) -> int:
    """Bytes on the wire for one phase moving ``n_elems``: codes plus the
    fp32 per-chunk scales."""
    return n_elems * wire_itemsize(wire_dtype) + 4 * math.ceil(n_elems / chunk)


def all_reduce_wire_bytes(n: int, world: int, wire_dtype: str = "int8",
                          chunk: int = DEFAULT_CHUNK) -> int:
    return wire_payload_bytes(padded_elems(n, world, chunk), wire_dtype, chunk)


def reduce_scatter_wire_bytes(n: int, world: int, wire_dtype: str = "int8",
                              chunk: int = DEFAULT_CHUNK) -> int:
    return wire_payload_bytes(padded_elems(n, world, chunk), wire_dtype, chunk)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------
def quantize_wire(x: torch.Tensor, wire_dtype: str = "int8",
                  chunk: int = DEFAULT_CHUNK):
    """Flat fp tensor [n] (n divisible by chunk) -> (codes [n] in the wire
    dtype, fp32 scales [n/chunk]): symmetric per-chunk absmax scaling."""
    from deepspeed_tpu_torch.ops import fp_quant, quant
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype must be one of {sorted(WIRE_DTYPES)}, "
                         f"got {wire_dtype!r}")
    rows = x.float().reshape(-1, chunk)
    if wire_dtype == "int8":
        codes, scales = quant.quantize_int8(rows)
    else:
        codes, scales = fp_quant.quantize_fp8(rows, "e4m3")
    return codes.reshape(-1), scales.reshape(-1)


def dequantize_wire(codes: torch.Tensor, scales: torch.Tensor,
                    chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Inverse of ``quantize_wire`` -> flat fp32 [n]."""
    from deepspeed_tpu_torch.ops import fp_quant, quant
    rows = codes.reshape(-1, chunk)
    s = scales.reshape(-1, 1)
    if codes.dtype == torch.int8:
        return quant.dequantize_int8(rows, s, dtype=torch.float32).reshape(-1)
    return fp_quant.dequantize_fp8(rows, s, dtype=torch.float32).reshape(-1)


def ef_step(x: torch.Tensor, error: Optional[torch.Tensor],
            wire_dtype: str = "int8", chunk: int = DEFAULT_CHUNK):
    """One error-feedback compression step: compensate with the residual,
    quantize, record the fresh error. Returns ``(codes, scales,
    new_error)`` with ``new_error == (x + error) - dequantize(codes,
    scales)``; ``error=None`` is a zero residual and gives None."""
    comp = x if error is None else x + error
    codes, scales = quantize_wire(comp, wire_dtype, chunk)
    new_error = None if error is None \
        else _residual(comp, codes, scales, chunk)
    return codes, scales, new_error


def _residual(comp: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              chunk: int) -> torch.Tensor:
    """``comp - codes * scale`` rounded once, as XLA compiles the
    reference's ``comp - dequantize(codes, scales)`` (a fused multiply-add).
    In float64 both the product (an 8-bit code times a 24-bit scale) and
    the difference (the two lie within a few binades of each other, or the
    code is 0) are exact, so the one rounding is the cast back."""
    deq = (codes.reshape(-1, chunk).double()
           * scales.reshape(-1, 1).double()).reshape(-1)
    return (comp.double() - deq).float()


# ---------------------------------------------------------------------------
# the collective impls over the global mesh
# ---------------------------------------------------------------------------
def axis_world(axes: Sequence[str]) -> int:
    """Participant count of the axis group."""
    from deepspeed_tpu_torch.comm.comm import _mesh
    return _mesh().axis_world(tuple(axes))


def _axis(ax: str):
    from deepspeed_tpu_torch.comm.comm import group_of
    return group_of(ax)


def exchange_and_sum(codes: torch.Tensor, scales: torch.Tensor, all_to_all,
                     dequantize) -> torch.Tensor:
    """The receiving side of every quantized reduce-scatter: send member
    j's block of ``codes`` / ``scales`` (dim 0 is the member) to member j
    with ``all_to_all``, ``dequantize`` what arrives to ``[w, ...]`` fp32,
    and add the members' blocks in order (the reference's ``jnp.sum`` over
    the member axis)."""
    deq = dequantize(all_to_all(codes), all_to_all(scales))
    out = deq[0]
    for j in range(1, deq.shape[0]):
        out = out + deq[j]
    return out


def reduce_scatter_impl(x: torch.Tensor, axes: Sequence[str],
                        wire_dtype: str = "int8",
                        chunk: int = DEFAULT_CHUNK, worker_error=None,
                        mean: bool = True):
    """Quantized reduce-scatter of a flat [n] payload over ``axes``:
    error-feedback compress, exchange the codes + scales, dequantize and
    sum on the receiver (the reference ``all_to_all_quant_reduce`` /
    ``quant_reduce.cu`` scheme), innermost axis first; outer hops
    re-quantize their shard without a residual.

    Returns ``(local_sum_or_mean [n_pad / W], new_worker_error [n_pad])``.
    """
    from deepspeed_tpu_torch.comm.comm import raw_all_to_all
    w = axis_world(axes)
    n = x.numel()
    n_pad = padded_elems(n, w, chunk)
    # one fp32 buffer, the padding zeroed (the payload's largest copy)
    flat = torch.zeros(n_pad, dtype=torch.float32, device=x.device)
    flat[:n].copy_(x.reshape(-1))
    shard = flat
    del flat
    new_worker_error = None
    for i, ax in enumerate(reversed(tuple(axes))):   # innermost first
        codes, scales, err = ef_step(shard, worker_error if i == 0 else None,
                                     wire_dtype, chunk)
        if i == 0:
            new_worker_error = err
        group, wk = _axis(ax)
        shard = exchange_and_sum(
            codes.reshape(wk, -1), scales.reshape(wk, -1),
            lambda t: raw_all_to_all(t, group, wk),
            lambda c, s: dequantize_wire(c.reshape(-1), s.reshape(-1),
                                         chunk).reshape(wk, -1))
    if mean:
        shard = shard / w
    return shard, new_worker_error


def all_reduce_impl(x: torch.Tensor, axes: Sequence[str],
                    wire_dtype: str = "int8", chunk: int = DEFAULT_CHUNK,
                    worker_error=None, server_error=None, mean: bool = True):
    """Quantized all-reduce over ``axes``: the hierarchical reduce-scatter
    (worker error feedback on the first hop), one re-quantization of the
    reduced shard (server error feedback), and the codes + scales
    regathered axis by axis in LIFO order, so every hop stays in the wire
    dtype. Returns ``(full [n_pad], new_worker_error, new_server_error)``."""
    from deepspeed_tpu_torch.comm.comm import raw_all_gather
    shard, new_worker_error = reduce_scatter_impl(
        x, axes, wire_dtype, chunk, worker_error=worker_error, mean=mean)
    codes, scales, new_server_error = ef_step(shard, server_error,
                                              wire_dtype, chunk)
    for ax in tuple(axes):     # inverts the reversed-order scatter (LIFO)
        group, wk = _axis(ax)
        codes = raw_all_gather(codes, group, wk).reshape(-1)
        scales = raw_all_gather(scales, group, wk).reshape(-1)
    out = dequantize_wire(codes, scales, chunk)
    return out, new_worker_error, new_server_error


class TensorEF(NamedTuple):
    """One participant's error-feedback residuals: ``worker`` [n_pad], its
    local compression error; ``server`` [n_pad / W], the regather
    re-quantization error. (The JAX package holds every participant's row
    in one [W, ...] array sharded over the axes; a rank holds its own.)"""
    worker: Any
    server: Any
