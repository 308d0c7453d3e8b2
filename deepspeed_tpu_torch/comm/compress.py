"""comm/compress: quantized error-feedback collectives and gradient buckets.

Port of ``deepspeed_tpu/comm/compress.py``: EQuARX-style quantized
all-reduce / reduce-scatter (arxiv 2506.17615: int8/fp8 codes with
per-chunk fp32 scales and error feedback) over any axis set of the global
mesh, the ``comm_compression`` config group, and the gradient-bucket
scheduler the engine's ``comm_compression`` runs (``plan_buckets``,
``GradCompressor``). The qgZ gradient sync (``runtime/zero/qgz.py``), the
facade's ``quantized_all_reduce`` / ``quantized_reduce_scatter`` and the
bucket sync are adapters over the one codec here. ``compressed.py`` is not
ported yet (ROADMAP Queue 1 item 2).

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
reference's expression). The engine keeps a bucket's residuals in its
optimizer (``with_error_feedback``: ``engine.optimizer.state
.error_feedback``, beside the moments), where a checkpoint will find them.

Multi-axis groups reduce hierarchically, innermost axis first (``axes``
come outermost first): the full payload rides only the innermost hop.

**Where the port's buckets differ.** The reference's gradient phase is
manual over the replica axes only, so its ``GradCompressor`` plans and
quantizes each leaf at its full ``fsdp`` extent. A port rank holds the
block it reduces (a stage-3 or stage-2 leaf's block over ``fsdp``), so the
port plans its buckets on the blocks, in the reference's tree-flatten
order; which leaves are quantized is decided on the full leaf as there.
The buckets' ``n``, ``n_pad``, their bytes and the residuals' shapes are
therefore the reference's on the block shapes (ROADMAP Queue 3,
divergence 39). ``ef_partition_specs`` and ``error_feedback_shardings``
lay the reference's ``[W, ...]`` residual arrays out for ``shard_map``; a
rank here holds its own row, so they have no counterpart.
"""

import dataclasses
import math
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

#: elements per fp32 scale group ("per-chunk scales")
DEFAULT_CHUNK = 256

#: wire dtype name -> (torch dtype, clip max, itemsize)
WIRE_DTYPES: Dict[str, Tuple[torch.dtype, float, int]] = {
    "int8": (torch.int8, 127.0, 1),
    "fp8": (torch.float8_e4m3fn, 448.0, 1),
}


@dataclasses.dataclass
class CommCompressionConfig:
    """The ``"comm_compression"`` config group (``compress.py:69-110``;
    default off: no extra state, no new collectives)."""
    enabled: bool = False
    # int8 | fp8 (e4m3) codes on the wire; scales are always fp32 per chunk
    wire_dtype: str = "int8"
    # elements per scale group
    chunk: int = DEFAULT_CHUNK
    # per-bucket worker and server residuals; off drops the state
    error_feedback: bool = True
    # gradient bytes per bucket (accumulation dtype)
    bucket_bytes: int = 4 << 20
    # False collapses the plan to one fused bucket
    overlap: bool = True
    # leaves below this many elements reduce in full precision
    min_size: int = 2048

    def __post_init__(self):
        self.enabled = bool(self.enabled)
        self.error_feedback = bool(self.error_feedback)
        self.overlap = bool(self.overlap)
        self.chunk, self.bucket_bytes, self.min_size = (
            int(self.chunk), int(self.bucket_bytes), int(self.min_size))
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"comm_compression.wire_dtype must be one of "
                             f"{sorted(WIRE_DTYPES)}, got {self.wire_dtype!r}")
        if self.chunk < 8:
            raise ValueError(f"comm_compression.chunk must be >= 8, "
                             f"got {self.chunk}")
        if self.bucket_bytes < 1:
            raise ValueError(f"comm_compression.bucket_bytes must be >= 1, "
                             f"got {self.bucket_bytes}")
        if self.min_size < 0:
            raise ValueError(f"comm_compression.min_size must be >= 0, "
                             f"got {self.min_size}")

    @classmethod
    def from_dict(cls, raw: Optional[Mapping[str, Any]]
                  ) -> "CommCompressionConfig":
        """The group from its JSON dict; unknown keys are ignored, as the
        reference's config models ignore them."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(raw or {}).items()
                      if k in names})


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


#: chunks of one float64 pass of ``_residual`` (bounds its temporaries at
#: 32 bytes an element of one pass, whatever the bucket's size)
RESIDUAL_PASS_CHUNKS = 1 << 14


def _residual(comp: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              chunk: int) -> torch.Tensor:
    """``comp - codes * scale`` rounded once, as XLA compiles the
    reference's ``comp - dequantize(codes, scales)`` (a fused multiply-add).
    In float64 both the product (an 8-bit code times a 24-bit scale) and
    the difference (the two lie within a few binades of each other, or the
    code is 0) are exact, so the one rounding is the cast back. Computed
    ``RESIDUAL_PASS_CHUNKS`` chunks at a time."""
    out = torch.empty(comp.shape, dtype=torch.float32, device=comp.device)
    rows = codes.reshape(-1, chunk)
    sc = scales.reshape(-1, 1)
    cv, ov = comp.reshape(-1, chunk), out.view(-1, chunk)
    for a in range(0, rows.shape[0], RESIDUAL_PASS_CHUNKS):
        b = a + RESIDUAL_PASS_CHUNKS
        deq = rows[a:b].double() * sc[a:b].double()
        ov[a:b] = (cv[a:b].double() - deq).float()
    return out


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
    in one [W, ...] array sharded over the axes; a rank holds its own.
    ``reshard_error_feedback`` takes the [W, ...] layout, a checkpoint's
    view of every rank's row.)"""
    worker: Any
    server: Any


# ---------------------------------------------------------------------------
# error-feedback state (kept in the engine's optimizer)
# ---------------------------------------------------------------------------
class CommCompressState(NamedTuple):
    """The optimizer state beside the error-feedback residuals
    (``compress.py:300-313``): ``inner`` is the wrapped optimizer (its
    moments and count), ``error_feedback`` a tuple of per-bucket
    ``TensorEF``, this rank's rows."""
    inner: Any
    error_feedback: Tuple[TensorEF, ...]


class ErrorFeedbackOptimizer:
    """An optimizer whose ``state`` is a ``CommCompressState``: ``init``
    and ``step`` are the wrapped optimizer's; the residuals pass through
    untouched (the engine swaps fresh ones in after the gradient sync, and
    keeps the old ones when a step overflows, as the moments are kept).
    Other attributes (``mu``, ``nu``, ``count``) are the wrapped
    optimizer's."""

    def __init__(self, inner, ef_init_fn: Callable[[], Tuple[TensorEF, ...]]):
        self.inner = inner
        self._ef_init_fn = ef_init_fn
        self.state = CommCompressState(inner=inner, error_feedback=())

    def init(self, params) -> None:
        self.inner.init(params)
        self.state = CommCompressState(inner=self.inner,
                                       error_feedback=self._ef_init_fn())

    def step(self, params, grads) -> None:
        self.inner.step(params, grads)

    def __getattr__(self, name):
        if name == "inner":                # not set yet
            raise AttributeError(name)
        return getattr(self.inner, name)


def with_error_feedback(opt, ef_init_fn) -> ErrorFeedbackOptimizer:
    """Wrap an optimizer so its state carries the residuals
    (``compress.py:316-333``)."""
    return ErrorFeedbackOptimizer(opt, ef_init_fn)


def reshard_error_feedback(ef: TensorEF, new_world: int,
                           surviving: Optional[int] = None,
                           xp=None) -> TensorEF:
    """The mesh-portable residual reshard rule (``compress.py:336-361``)
    on the [W, n_pad] layout: every new participant's worker residual is
    the mean over the surviving old participants' rows (the leading
    ``surviving`` rows, default all), which preserves the correction mass
    the next reduction repays; the server residual restarts at zero
    ([new_world, n_pad / new_world], or [new_world, 0] when the world does
    not divide n_pad). ``xp`` is ``numpy`` for host arrays; torch tensors
    by default."""
    worker = ef.worker
    rows = int(worker.shape[0]) if surviving is None else int(surviving)
    n_pad = int(worker.shape[1])
    width = n_pad // new_world if n_pad % new_world == 0 else 0
    if xp is np or isinstance(worker, np.ndarray):
        mean = np.mean(worker[:max(rows, 1)], axis=0, keepdims=True)
        return TensorEF(worker=np.repeat(mean.astype(np.float32), new_world,
                                         axis=0),
                        server=np.zeros((new_world, width), np.float32))
    mean = worker[:max(rows, 1)].float().mean(dim=0, keepdim=True)
    return TensorEF(worker=mean.repeat(new_world, 1),
                    server=torch.zeros((new_world, width),
                                       dtype=torch.float32,
                                       device=worker.device))


def adopt_error_feedback(saved, current: Sequence[TensorEF], world: int,
                         index: int) -> Optional[Tuple[TensorEF, ...]]:
    """This rank's residuals from a checkpoint's (JAX ``checkpoint/
    engine.py:569-675``): ``saved`` holds per bucket the rows of this
    rank's replica group at save time (numpy ``worker`` [W_old, n_old],
    ``server`` [W_old, m_old]), ``current`` this rank's live residuals,
    ``world`` the replica world now and ``index`` this rank's place in it.
    A worker row is fitted to the current ``n_pad`` by zero pad or
    truncation (the pad tail carries exactly zero residual, so this is
    lossless). The same replica world restores both rows bit for bit; a
    changed one takes the mean-preserving reshard
    (``reshard_error_feedback``: every new member gets the mean of the old
    rows, the server residuals restart at zero). None when the bucket
    count differs (another model or plan): the caller keeps the fresh
    zeros."""
    if len(saved) != len(current):
        return None
    out = []
    for (worker, server), cur in zip(saved, current):
        n_pad = int(cur.worker.shape[0])
        fit = np.zeros((worker.shape[0], n_pad), np.float32)
        m = min(int(worker.shape[1]), n_pad)
        fit[:, :m] = worker[:, :m]
        if fit.shape[0] == world and server is not None \
                and server.shape[1] == cur.server.shape[0]:
            w_row, s_row = fit[index], server[index]
        else:
            ef = reshard_error_feedback(TensorEF(worker=fit, server=None),
                                        world, xp=np)
            w_row, s_row = ef.worker[index], ef.server[index]
        out.append(TensorEF(
            worker=torch.from_numpy(np.array(w_row, np.float32)).to(
                cur.worker.device),
            server=torch.from_numpy(np.array(s_row, np.float32)).to(
                cur.server.device)))
    return tuple(out)


# ---------------------------------------------------------------------------
# gradient-bucket scheduler
# ---------------------------------------------------------------------------
class Bucket(NamedTuple):
    index: int
    paths: Tuple[str, ...]
    sizes: Tuple[int, ...]          # flat element count per leaf
    shapes: Tuple[Tuple[int, ...], ...]
    n: int                          # total elements (unpadded)
    n_pad: int                      # padded to world * chunk
    logical_bytes: int              # unpadded accumulation-dtype payload
    wire_bytes: int                 # codes + scales payload (padded)


def plan_buckets(leaves: List[Tuple[str, Tuple[int, ...]]], world: int,
                 cfg: CommCompressionConfig,
                 itemsize: int = 4) -> List[Bucket]:
    """The reference's deterministic bucket partition
    (``compress.py:380-415``) of the quantized leaves, in the order given:
    a greedy fill that closes a bucket once it holds ``bucket_bytes``;
    ``overlap=False`` gives one fused bucket."""
    buckets: List[Bucket] = []
    cur: List[Tuple[str, Tuple[int, ...]]] = []
    cur_bytes = 0

    def close():
        if not cur:
            return
        sizes = tuple(int(math.prod(s)) if s else 1 for _, s in cur)
        n = sum(sizes)
        n_pad = padded_elems(n, world, cfg.chunk)
        buckets.append(Bucket(
            index=len(buckets), paths=tuple(p for p, _ in cur), sizes=sizes,
            shapes=tuple(tuple(s) for _, s in cur), n=n, n_pad=n_pad,
            logical_bytes=n * itemsize,
            wire_bytes=wire_payload_bytes(n_pad, cfg.wire_dtype, cfg.chunk)))
        cur.clear()

    for path, shape in leaves:
        size = int(math.prod(shape)) if shape else 1
        cur.append((path, tuple(shape)))
        cur_bytes += size * itemsize
        if cfg.overlap and cur_bytes >= cfg.bucket_bytes:
            close()
            cur_bytes = 0
    close()
    return buckets


def flatten_order(path: str) -> Tuple[str, ...]:
    """The sort key of the reference's tree-flatten order for a
    ``/``-separated path: dict keys sorted at every level (``layer_10``
    before ``layer_2``)."""
    return tuple(path.split("/"))


class GradCompressor:
    """The engine-facing half (``compress.py:418-576``): the bucket plan,
    the residuals' layout and the sync function."""

    def __init__(self, cfg: CommCompressionConfig, axes: Sequence[str],
                 mesh):
        self.cfg = cfg
        self.axes = tuple(axes)
        self.world = 1
        for ax in self.axes:
            self.world *= int(mesh.shape[ax])
        self.buckets: List[Bucket] = []
        self._skipped: Tuple[str, ...] = ()

    def build(self, leaves: Sequence[Tuple[str, Tuple[int, ...], Any]],
              itemsize: int = 4, exclude_paths: Sequence[str] = (),
              full_sizes: Optional[Mapping[str, int]] = None
              ) -> "GradCompressor":
        """Plan the buckets of ``leaves`` (``(path, shape, dtype)`` of the
        tensors a rank reduces, ``/``-separated paths), taken in the
        reference's tree-flatten order. A leaf is skipped (reduced in full
        precision) when excluded, not floating, or under ``min_size``
        elements as a whole leaf (``full_sizes[path]``, by default its
        shape's size)."""
        excluded = set(exclude_paths)
        full_sizes = dict(full_sizes or {})
        quantized, skipped = [], []
        for path, shape, dtype in sorted(leaves,
                                         key=lambda l: flatten_order(l[0])):
            size = full_sizes.get(path, int(math.prod(shape)) if shape else 1)
            floating = dtype.is_floating_point if isinstance(
                dtype, torch.dtype) else np.issubdtype(np.dtype(dtype),
                                                       np.floating)
            if path in excluded or size < self.cfg.min_size or not floating:
                skipped.append(path)
                continue
            quantized.append((path, tuple(shape)))
        self.buckets = plan_buckets(quantized, self.world, self.cfg,
                                    itemsize=itemsize)
        self._skipped = tuple(skipped)
        logger.info(
            "comm_compression: %d bucket(s) over axes %s (world %d, "
            "wire=%s chunk=%d, %d leaves quantized / %d full-precision); "
            "logical %.2f MB -> wire %.2f MB per reduction",
            len(self.buckets), self.axes, self.world, self.cfg.wire_dtype,
            self.cfg.chunk, sum(len(b.paths) for b in self.buckets),
            len(skipped), sum(b.logical_bytes for b in self.buckets) / 1e6,
            sum(b.wire_bytes for b in self.buckets) / 1e6)
        return self

    def bucket_summaries(self) -> List[Dict[str, Any]]:
        """Per-bucket metadata for the ``comm/overlap`` spans and tests."""
        return [{"index": b.index, "leaves": len(b.paths), "n": b.n,
                 "n_pad": b.n_pad, "bytes": b.logical_bytes,
                 "wire_bytes": b.wire_bytes} for b in self.buckets]

    def ef_enabled(self) -> bool:
        return bool(self.cfg.error_feedback and self.buckets)

    def zero_error_feedback(self, device=None) -> Tuple[TensorEF, ...]:
        """This rank's fresh residuals: per bucket, worker [n_pad] and
        server [n_pad / W] zeros (fp32)."""
        if not self.ef_enabled():
            return ()
        return tuple(
            TensorEF(worker=torch.zeros(b.n_pad, dtype=torch.float32,
                                        device=device),
                     server=torch.zeros(b.n_pad // self.world,
                                        dtype=torch.float32, device=device))
            for b in self.buckets)

    def make_sync_fn(self, fallback_leaf_sync=None):
        """``sync_fn(grads, batch, ef) -> (reduced, new_ef)``: ``grads``
        maps a path to its accumulated gradient (a rank's block); per
        bucket the member leaves are concatenated flat in their dtype
        (the logical bytes are what the dense reduction would move), one
        facade-recorded ``quantized_all_reduce`` (mean over the axes, the
        bucket's residuals threaded) runs, and the result is split back
        into each leaf's shape and dtype. Leaves outside every bucket take
        ``fallback_leaf_sync(path, grad, batch)`` (default: a full-precision
        mean). ``ef`` is () with error feedback off."""
        from deepspeed_tpu_torch.comm.comm import (ReduceOp, all_reduce,
                                                   quantized_all_reduce)
        cfg, axes, buckets = self.cfg, self.axes, self.buckets

        def default_fallback(path, g, batch):
            return all_reduce(g, axes, ReduceOp.AVG)

        fallback = fallback_leaf_sync or default_fallback

        def sync_fn(grads: Dict[str, torch.Tensor], batch, ef):
            reduced: Dict[str, torch.Tensor] = {}
            new_ef: List[Optional[TensorEF]] = [None] * len(buckets)
            for b in buckets:
                parts = [grads[p] for p in b.paths]
                dt = parts[0].dtype
                for x in parts[1:]:
                    dt = torch.promote_types(dt, x.dtype)
                payload = torch.cat([x.to(dt).reshape(-1) for x in parts])
                err = ef[b.index] if ef else None
                out, err_out = quantized_all_reduce(
                    payload, axes, wire_dtype=cfg.wire_dtype,
                    chunk=cfg.chunk, error=err)
                del payload
                new_ef[b.index] = err_out
                off = 0
                for p, size, shape in zip(b.paths, b.sizes, b.shapes):
                    reduced[p] = out[off:off + size].reshape(shape) \
                        .to(grads[p].dtype)
                    off += size
                del out
            for p, g in grads.items():
                if p not in reduced:
                    reduced[p] = fallback(p, g, batch)
            return reduced, (tuple(new_ef) if ef else ())

        return sync_fn
