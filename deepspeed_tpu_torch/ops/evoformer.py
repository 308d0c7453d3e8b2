"""Evoformer (DS4Science) attention: plain versions, the CUDA kernels'
wrappers and the autograd function.

Port of ``deepspeed_tpu/ops/pallas/evoformer.py``. Its five TPU kernels,
``_evo_fwd_kernel``, ``_evo_dq_kernel``, ``_evo_dkv_kernel``,
``_evo_dbias2_kernel`` and ``_evo_dbias1_kernel``, become the hand-written
CUDA kernels of ``csrc/evoformer.cu`` (design notes there), launched by
``evo_fwd`` and ``evo_bwd`` and counted as ``evo_fwd``, ``evo_dq``,
``evo_dkv``, ``evo_dbias2`` and ``evo_dbias1``. In bf16 the forward, dQ,
dK/dV, dbias2 and dbias1 run on the tensor cores (``evo_fwd_kernel_mma``,
``evo_dq_kernel_mma``, ``evo_dkv_kernel_mma``, ``evo_dbias2_kernel_mma``
and ``evo_dbias1_kernel_mma``, tiled as ``evo_fwd_plan`` and
``evo_bwd_plan`` say; dbias2 splits the N rows as ``dbias2_splits`` says
and sums the splits' partials in order with
``evo_dbias2_combine_kernel``); every fp32 kernel on the CUDA cores.

Function: ``softmax(q k^T / sqrt(D) + bias1 + bias2) v`` on q/k/v
``[B, N, L, H, D]``, with ``bias1 [B, N, Lk]`` a per-key bias of each row
(OpenFold's mask) and ``bias2 [B, H, Lq, Lk]`` a pair bias shared by the N
rows of a batch entry. The kernels read that one ``[B, H, Lq, Lk]`` panel
for every row; it is never materialized over N.

``evo_fwd_plain`` and ``evo_bwd_plain`` compute what the kernels compute,
with the same rounding points: fp32 scores are the dot times ``1/sqrt(D)``,
then ``+ bias1``, then ``+ bias2``; an online softmax over 64-key tiles
rounds p to v's dtype against the running max before P.V, and l is clamped
at 1e-30; ``delta = rowsum(dO.O)`` is taken from the rounded
output; the raw ``dS = p (dP - delta)`` feeds both bias gradients, ``dS *
scale`` is rounded to k's dtype for dq and to q's dtype for dk, and p to
dO's dtype for dv. They work in chunks of rows over N, so a full-size
problem never holds one score tensor over all rows. CPU tensors run them;
CUDA tensors launch the kernels or raise. Nothing catches a build or launch
failure to run a plain version instead.
"""

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.ops import build

KERNEL = "evoformer"
LAUNCH_NAMES = ("evo_fwd", "evo_dq", "evo_dkv", "evo_dbias2", "evo_dbias1")
HEAD_DIMS = (8, 16, 32, 64, 128)
KEY_TILE = 64              # keys of the forward kernel's tile
MMA_ROWS = 64              # query rows (keys for dK/dV) of a bf16 tensor-core tile
DKV_GROUP = 2              # MSA rows a bf16 dK/dV block walks with a pair bias
DQ_GROUP = 2               # MSA rows a bf16 dQ block walks with a pair bias
DB1_GROUP = 1              # MSA rows a bf16 dbias1 block walks (D < 128)
NEG_INF = -1e30            # the reference's NEG_INF: the running max's start
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# score elements one plain chunk may hold (1 GiB of fp32)
PLAIN_CHUNK_ELEMS = 1 << 28
_lib: Optional[ctypes.CDLL] = None


class UnsupportedBiasLayout(ValueError):
    """Bias shape outside the kernels' contract; ``DS4Sci_EvoformerAttention``
    then takes the blockwise path, which takes any broadcastable bias."""


# ---------------------------------------------------------------------------
# canonical layout (the reference's ``_canon``)
# ---------------------------------------------------------------------------
def _bcast(bias, target):
    """fp32 ``bias`` broadcast to ``target`` as a view: autograd sums its
    gradient back to the caller's shape."""
    if bias.dim() > len(target):
        raise UnsupportedBiasLayout(
            f"bias of shape {tuple(bias.shape)} has more dims than {target}")
    try:
        return bias.float().expand(target)
    except RuntimeError as e:       # folded lead dims the bias can't match
        raise UnsupportedBiasLayout(str(e)) from e


def canonicalize(q, k, v, biases):
    """[*, L, H, D] -> (q, k, v [B, N, L, H, D], bias1 [B, N, Lk] | None,
    bias2 [B, H, Lq, Lk] | None). Leading dims beyond two fold into B; a
    0-d or 1-d bias, or one whose [-2] and [-3] axes are both 1, is bias1;
    any other is bias2, whose head axis is 1 or H and which may not vary
    over N."""
    if q.dim() < 4:
        raise UnsupportedBiasLayout(
            f"evoformer q must be [*, L, H, D], got {tuple(q.shape)}")
    lead = q.shape[:-3]
    if len(lead) == 1:
        b, n = lead[0], 1
    else:
        b, n = math.prod(lead[:-1]), lead[-1]
    l_q, h, d = q.shape[-3:]
    l_k = k.shape[-3]
    q5 = q.reshape(b, n, l_q, h, d)
    k5 = k.reshape(b, n, l_k, h, d)
    v5 = v.reshape(b, n, l_k, h, d)

    b1 = b2 = None
    for bias in biases:
        if bias is None:
            continue
        shape = bias.shape
        if bias.dim() >= 1 and shape[-1] not in (l_k, 1):
            raise UnsupportedBiasLayout(
                f"bias last dim {shape[-1]} != key length {l_k}")
        if bias.dim() < 2 or (shape[-2] == 1
                              and (bias.dim() < 3 or shape[-3] == 1)):
            if b1 is not None:
                raise UnsupportedBiasLayout("two mask-like biases given")
            b1 = _bcast(bias, (b, n, 1, 1, l_k)).reshape(b, n, l_k)
        else:
            if b2 is not None:
                raise UnsupportedBiasLayout("two pair-like biases given")
            if bias.dim() >= 3 and shape[-3] not in (1, h):
                raise UnsupportedBiasLayout(
                    f"bias head dim {shape[-3]} != heads {h}")
            if bias.dim() >= 4 and shape[-4] != 1 and n > 1:
                raise UnsupportedBiasLayout(
                    "pair bias varying over the row (N) dim is unsupported "
                    f"(got row dim {shape[-4]} with N={n})")
            b2 = _bcast(bias, (b, 1, h, l_q, l_k)).reshape(b, h, l_q, l_k)
    return q5, k5, v5, b1, b2


# ---------------------------------------------------------------------------
# plain versions of the five kernels
# ---------------------------------------------------------------------------
def _chunk_rows(q, k):
    b, _, l_q, h, _ = q.shape
    return max(1, PLAIN_CHUNK_ELEMS // (b * h * l_q * k.shape[2]))


def _scores(q, k, b1, b2, scale):
    """fp32 [B, n, H, Lq, Lk]: dot * scale, + bias1, + bias2."""
    s = torch.einsum("bnqhd,bnkhd->bnhqk", q.float(), k.float()) * scale
    if b1 is not None:
        s = s + b1[:, :, None, None, :]
    if b2 is not None:
        s = s + b2[:, None]
    return s


def evo_fwd_plain(q, k, v, b1=None, b2=None):
    """What ``_evo_fwd_kernel`` computes: (out [B, N, Lq, H, D] in q's
    dtype, lse [B, N, H, Lq] fp32). Like the kernel, an online softmax over
    KEY_TILE-key tiles: p is rounded to v's dtype against the running max
    of its tile, and the sums are rescaled as the max grows. Rows of N in
    chunks of at most PLAIN_CHUNK_ELEMS scores."""
    b, n, l_q, h, d = q.shape
    l_k = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    step = _chunk_rows(q, k)
    out = torch.empty_like(q)
    lse = torch.empty(b, n, h, l_q, dtype=torch.float32, device=q.device)
    for n0 in range(0, n, step):
        rows = slice(n0, min(n, n0 + step))
        s = _scores(q[:, rows], k[:, rows],
                    None if b1 is None else b1[:, rows], b2, scale)
        vc = v[:, rows]
        m = torch.full(s.shape[:-1], NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(*s.shape[:-1], d, device=q.device)   # [B,n,H,Lq,D]
        for k0 in range(0, l_k, KEY_TILE):
            s_t = s[..., k0:k0 + KEY_TILE]
            m_new = torch.maximum(m, s_t.amax(-1))
            p = torch.exp(s_t - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bnhqk,bnkhd->bnhqd", p.to(v.dtype).float(),
                vc[:, :, k0:k0 + KEY_TILE].float())
            m = m_new
        l = l.clamp_min(1e-30)
        out[:, rows] = (acc / l[..., None]).transpose(2, 3).to(q.dtype)
        lse[:, rows] = m + torch.log(l)
    return out, lse


def _bwd_delta(out, do):
    """delta = rowsum(dO . O) in fp32 from the rounded output, [B, N, H,
    Lq] (taken outside the kernels, as the reference does)."""
    return (do.float() * out.float()).sum(-1).transpose(2, 3).contiguous()


def evo_bwd_plain(q, k, v, b1, b2, out, lse, do, need_db1: bool = True,
                  need_db2: bool = True, delta=None):
    """What the dq, dkv, dbias2 and dbias1 kernels compute: (dq, dk, dv in
    q's/k's/v's dtypes, db1 [B, N, Lk] fp32 or None, db2 [B, H, Lq, Lk] fp32
    or None); a bias gradient is None when that bias is absent or not
    asked for. ``delta`` [B, N, H, Lq] defaults to rowsum(dO.O), what the
    wrapper hands the kernels."""
    b, n, l_q, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    step = _chunk_rows(q, k)
    if delta is None:
        delta = _bwd_delta(out, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    want_db1 = b1 is not None and need_db1
    want_db2 = b2 is not None and need_db2
    db1 = torch.empty(b, n, k.shape[2], dtype=torch.float32,
                      device=q.device) if want_db1 else None
    db2 = torch.zeros_like(b2, dtype=torch.float32) if want_db2 else None
    for n0 in range(0, n, step):
        rows = slice(n0, min(n, n0 + step))
        qc, kc, vc, doc = q[:, rows], k[:, rows], v[:, rows], do[:, rows]
        s = _scores(qc, kc, None if b1 is None else b1[:, rows], b2, scale)
        p = torch.exp(s - lse[:, rows, ..., None])
        dp = torch.einsum("bnqhd,bnkhd->bnhqk", doc.float(), vc.float())
        ds = p * (dp - delta[:, rows, ..., None])      # raw dS: bias units
        dq[:, rows] = torch.einsum(
            "bnhqk,bnkhd->bnqhd", (ds * scale).to(k.dtype).float(),
            kc.float()).to(q.dtype)
        dk[:, rows] = torch.einsum(
            "bnhqk,bnqhd->bnkhd", (ds * scale).to(q.dtype).float(),
            qc.float()).to(k.dtype)
        dv[:, rows] = torch.einsum(
            "bnhqk,bnqhd->bnkhd", p.to(do.dtype).float(),
            doc.float()).to(v.dtype)
        if want_db2:
            db2 += ds.sum(1)
        if want_db1:
            db1[:, rows] = ds.sum((2, 3))
    return dq, dk, dv, db1, db2


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # which, q k v dO b1 b2 lse delta out0 out1, B N Lq Lk H D, scale,
        # dtype, stream
        lib.dstt_evo_launch.argtypes = [i] + [p] * 10 + [i] * 6 + [f, i, p]
        lib.dstt_evo_launch.restype = ctypes.c_int
        lib.dstt_evo_smem_bytes.argtypes = [i, i]
        lib.dstt_evo_smem_bytes.restype = ctypes.c_int
        # q k v dO b1 b2 lse delta db2 ws, B N Lq Lk H D, scale, dtype,
        # splits, stream
        lib.dstt_evo_dbias2.argtypes = [p] * 10 + [i] * 6 + [f, i, i, p]
        lib.dstt_evo_dbias2.restype = ctypes.c_int
        lib.dstt_evo_dbias2_blocks_per_sm.argtypes = [i]
        lib.dstt_evo_dbias2_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def evo_fwd_plan(head_dim: int, has_bias2: bool) -> dict:
    """The bf16 forward kernel's tiling (``FwdMma`` in csrc/evoformer.cu):
    ``group`` G, the MSA rows one block walks together, one warp group of
    4 warps each, sharing each pair-bias tile (2, so that two blocks fit an
    SM at D <= 32; 1 at D = 128, whose accumulators fill the registers,
    and without a pair bias, when nothing else is shared across rows);
    ``threads``; ``stages`` of the ring; ``smem_bytes``: the G resident Q
    tiles ([64][max(D, 16) + 8] bf16) and per stage G K and V tiles, the
    fp32 [64][72] pair-bias tile and G fp32 bias1 segments of 64 keys.
    Every tile is 64 keys wide, so nothing here depends on the key
    length."""
    d = head_dim
    if d not in HEAD_DIMS:
        raise ValueError(f"evoformer attention kernel: head dim {d} (one of "
                         f"{HEAD_DIMS})")
    group = 2 if has_bias2 and d < 128 else 1
    stages = 2
    tile = MMA_ROWS * (max(d, 16) + 8) * 2
    bias2 = MMA_ROWS * (KEY_TILE + 8) * 4 if has_bias2 else 0
    stage = 2 * group * tile + bias2 + group * KEY_TILE * 4
    return {"group": group, "threads": 128 * group, "stages": stages,
            "rows": MMA_ROWS, "smem_bytes": group * tile + stages * stage}


def evo_bwd_plan(head_dim: int, has_bias2: bool) -> dict:
    """The bf16 backward's tensor-core tilings (``DqMma``, ``DkvMma``,
    ``Db2Mma`` and ``Db1Mma`` in csrc/evoformer.cu): ``dq``, one block per 64-row query
    tile of ``group`` MSA rows, a warp group of 4 warps x 16 queries each
    (with a pair bias DQ_GROUP rows sharing each fp32 [64][72] pair-bias
    tile; 1 at D = 128 and without one), Q and dO resident, a ring of
    ``stages`` key tiles (G K and V tiles, the pair tile, G bias1
    segments); ``dkv``, one block per 64-key tile of ``group``
    MSA rows, a warp group of 4 warps x 16 keys each (with a pair bias
    DKV_GROUP rows sharing each fp32 [64 queries][68] pair-bias tile, read
    transposed; 1 at D = 128, whose accumulators fill the registers, and
    without one), K and V resident, a ring of ``stages`` query tiles (G Q
    and dO tiles, the pair tile, G rows of lse and delta); ``dbias2`` (None
    without a pair bias), one block of 4 warps x 16 queries per 64 x 64
    panel tile and split, a ring of ``stages`` MSA rows (Q, dO, K, V tiles,
    bias1, lse, delta); ``dbias1``, one block per 64-key tile of ``group``
    MSA rows of one batch entry (DB1_GROUP, with or without a pair bias:
    the mask has no head axis; 1, three blocks an SM at D <= 32, beat 2 on
    the card), a warp group of 4 warps x 16 keys each, one head's K and V
    tiles, a ring of ``stages`` (head, query tile) steps (G Q and dO tiles,
    the fp32 [64 queries][68] pair tile the G rows share where there is a
    pair bias, G rows of lse and delta).
    Tiles are [64][max(D, 16) + 8] bf16; nothing here depends on the
    lengths."""
    d = head_dim
    if d not in HEAD_DIMS:
        raise ValueError(f"evoformer attention kernel: head dim {d} (one of "
                         f"{HEAD_DIMS})")
    tile = MMA_ROWS * (max(d, 16) + 8) * 2
    group = DQ_GROUP if has_bias2 and d < 128 else 1
    bias2 = MMA_ROWS * (KEY_TILE + 8) * 4 if has_bias2 else 0
    stage = 2 * group * tile + bias2 + group * KEY_TILE * 4
    dq = {"group": group, "threads": 128 * group, "stages": 2,
          "rows": MMA_ROWS, "smem_bytes": 2 * group * tile + 2 * stage}
    group = DKV_GROUP if has_bias2 and d < 128 else 1
    bias2 = MMA_ROWS * (KEY_TILE + 4) * 4 if has_bias2 else 0
    stage = 2 * group * tile + bias2 + 2 * group * MMA_ROWS * 4
    dkv = {"group": group, "threads": 128 * group, "stages": 2,
           "keys": MMA_ROWS, "smem_bytes": 2 * group * tile + 2 * stage}
    dbias2 = None
    if has_bias2:
        stages = 3 if d <= 32 else 2
        dbias2 = {"threads": 128, "stages": stages, "rows": MMA_ROWS,
                  "keys": KEY_TILE,
                  "smem_bytes": stages * (4 * tile + 3 * MMA_ROWS * 4)}
    group = DB1_GROUP if d < 128 else 1                # bias2: dK/dV's [64][68] tile
    stage = 2 * group * tile + bias2 + 2 * group * MMA_ROWS * 4
    dbias1 = {"group": group, "threads": 128 * group, "stages": 2,
              "keys": MMA_ROWS, "smem_bytes": 2 * group * tile + 2 * stage}
    return {"dq": dq, "dkv": dkv, "dbias2": dbias2, "dbias1": dbias1}


MAX_DB2_SPLITS = 16        # the dbias2 workspace holds at most 16 panels' partials
DB2_SPLIT_SLACK = 0.05     # fewer splits win within 5% of the best modelled time


@functools.lru_cache(maxsize=None)
def dbias2_splits(batch: int, heads: int, n: int, l_q: int, l_k: int,
                  sm_count: int, blocks_per_sm: int) -> Tuple[int, int]:
    """(splits, rows_per_split): split s of the bf16 dbias2 sums the MSA
    rows [s * rows_per_split, min(n, (s + 1) * rows_per_split)), none
    empty. Every block of a split walks rows_per_split rows in turn, and
    the ``batch * heads * splits`` panels of 64 x 64 tiles run in waves of
    ``blocks_per_sm * sm_count`` resident blocks, so a call takes about
    (waves x rows_per_split) row steps. Splits are taken only as far as
    they shorten that: the fewest (up to MAX_DB2_SPLITS) within
    DB2_SPLIT_SLACK of the best, so a grid that already fills its waves
    keeps one. Depends on the shapes and the card alone, never on
    values."""
    blocks = batch * heads * -(-l_q // MMA_ROWS) * -(-l_k // KEY_TILE)
    wave = sm_count * blocks_per_sm
    plans = []
    for want in range(1, min(n, MAX_DB2_SPLITS) + 1):
        per = -(-n // want)
        splits = -(-n // per)
        plans.append((-(-blocks * splits // wave) * per, splits, per))
    best = min(cost for cost, _, _ in plans)
    return next((splits, per) for cost, splits, per in plans
                if cost <= best * (1 + DB2_SPLIT_SLACK))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def dbias2_blocks_per_sm(device: torch.device, head_dim: int) -> int:
    """bf16 dbias2 blocks at ``head_dim`` that fit on one SM of ``device``
    at once, by the CUDA occupancy calculator."""
    with torch.cuda.device(device):
        n = _library().dstt_evo_dbias2_blocks_per_sm(head_dim)
    if n <= 0:
        raise RuntimeError(f"evoformer dbias2 kernel: no resident block at "
                           f"head dim {head_dim} (code {n})")
    return n


def dbias2_split_for(device, b, h, n, l_q, l_k, head_dim, dtype
                     ) -> Tuple[int, int]:
    """(splits, rows_per_split) the wrapper launches dbias2 with on
    ``device``: bf16 as ``dbias2_splits`` says for that card; fp32 one."""
    if dtype != torch.bfloat16:
        return 1, n
    return dbias2_splits(b, h, n, l_q, l_k, _sm_count(device),
                         dbias2_blocks_per_sm(device, head_dim))


def dynamic_smem_bytes(head_dim: int) -> dict:
    """Dynamic shared memory (bytes) of each kernel at ``head_dim``, as the
    built library reports it: the CUDA-core kernels by launch name (the
    forward's, dQ's, dK/dV's, dbias2's and dbias1's are fp32's), the bf16
    forward, dK/dV, dQ and dbias1 with and without a pair bias, the bf16
    dbias2."""
    lib = _library()
    out = {name: lib.dstt_evo_smem_bytes(i, head_dim)
           for i, name in enumerate(LAUNCH_NAMES)}
    for i, name in enumerate(("evo_fwd_mma_pair", "evo_fwd_mma",
                              "evo_dkv_mma_pair", "evo_dkv_mma",
                              "evo_dbias2_mma", "evo_dq_mma_pair",
                              "evo_dq_mma", "evo_dbias1_mma_pair",
                              "evo_dbias1_mma"), start=5):
        out[name] = lib.dstt_evo_smem_bytes(i, head_dim)
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"evoformer attention kernel: {msg}")


def _cuda_check(q, k, v, b1, b2, extra=()):
    """Validate the operands; return the launch's integer arguments."""
    _check(q.dim() == 5 and k.dim() == 5 and v.dim() == 5,
           "q [B,N,Lq,H,D], k/v [B,N,Lk,H,D]")
    b, n, l_q, h, d = q.shape
    l_k = k.shape[2]
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(d in HEAD_DIMS, f"head dim {d} (one of {HEAD_DIMS})")
    _check(k.shape == (b, n, l_k, h, d) and v.shape == k.shape,
           f"k/v {tuple(k.shape)}/{tuple(v.shape)} against q {tuple(q.shape)}")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           f"{k.dtype}/{v.dtype} mixed with {q.dtype}")
    if b1 is not None:
        _check(b1.dtype == torch.float32 and b1.shape == (b, n, l_k),
               f"bias1 float32 [B,N,Lk], got {b1.dtype} {tuple(b1.shape)}")
    if b2 is not None:
        _check(b2.dtype == torch.float32 and b2.shape == (b, h, l_q, l_k),
               f"bias2 float32 [B,H,Lq,Lk], got {b2.dtype} {tuple(b2.shape)}")
    for x in (q, k, v, b1, b2) + tuple(extra):
        if x is None:
            continue
        _check(x.device == q.device, f"tensor on {x.device}, q on {q.device}")
        _check(x.is_contiguous(), "operands must be contiguous")
        _check(x.data_ptr() % 16 == 0, "operands must be 16-byte aligned")
    return b, n, l_q, l_k, h, d


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(name, ints, q, k, v, b1, b2, do=None, lse=None, delta=None,
            out0=None, out1=None):
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dstt_evo_launch(
            LAUNCH_NAMES.index(name), _ptr(q), _ptr(k), _ptr(v), _ptr(do),
            _ptr(b1), _ptr(b2), _ptr(lse), _ptr(delta), _ptr(out0),
            _ptr(out1), *ints, 1.0 / math.sqrt(ints[-1]), _DTYPES[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    build.count_launch(name)


# the dbias2 splits' fp32 workspace of each (device, stream), grown on
# demand: launches on one stream run in order, so one buffer serves them
_workspaces = {}


def _workspace(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    ws = _workspaces.get((device, stream))
    if ws is None or ws.numel() < numel:
        ws = torch.empty(numel, dtype=torch.float32, device=device)
        _workspaces[(device, stream)] = ws
    return ws


def _launch_dbias2(ints, q, k, v, b1, b2, do, lse, delta, db2, splits=None):
    """The dbias2 kernel into ``db2``, over ``splits`` splits of the N rows
    (bf16 only; default: as ``dbias2_split_for`` says)."""
    b, n, l_q, l_k, h, d = ints
    if splits is None:
        splits = dbias2_split_for(q.device, b, h, n, l_q, l_k, d, q.dtype)[0]
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ws = (_workspace(q.device, stream, splits * b * h * l_q * l_k)
              if splits > 1 else None)
        err = lib.dstt_evo_dbias2(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(b1), _ptr(b2),
            _ptr(lse), _ptr(delta), _ptr(db2), _ptr(ws), *ints,
            1.0 / math.sqrt(d), _DTYPES[q.dtype], splits, stream)
    if err != 0:
        raise RuntimeError(f"evo_dbias2 kernel launch failed ({splits} "
                           f"splits): CUDA error {err}")
    build.count_launch("evo_dbias2")


def _evo_fwd_cuda(q, k, v, b1, b2):
    ints = _cuda_check(q, k, v, b1, b2)
    b, n, l_q, _, h, _ = ints
    out = torch.empty_like(q)
    lse = torch.empty(b, n, h, l_q, dtype=torch.float32, device=q.device)
    _launch("evo_fwd", ints, q, k, v, b1, b2, out0=out, out1=lse)
    return out, lse


def _evo_bwd_cuda(q, k, v, b1, b2, out, lse, do, need_db1, need_db2):
    ints = _cuda_check(q, k, v, b1, b2, extra=(out, lse, do))
    b, n, l_q, l_k, h, _ = ints
    _check(out.shape == q.shape and do.shape == q.shape
           and out.dtype == q.dtype and do.dtype == q.dtype,
           "out and dO like q")
    _check(lse.dtype == torch.float32 and lse.shape == (b, n, h, l_q),
           "lse float32 [B, N, H, Lq]")
    delta = _bwd_delta(out, do)
    args = (ints, q, k, v, b1, b2, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("evo_dq", *args, out0=dq)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("evo_dkv", *args, out0=dk, out1=dv)
    db1 = db2 = None
    if b2 is not None and need_db2:
        db2 = torch.empty(b, h, l_q, l_k, dtype=torch.float32, device=q.device)
        _launch_dbias2(*args, db2)
    if b1 is not None and need_db1:
        db1 = torch.empty(b, n, l_k, dtype=torch.float32, device=q.device)
        _launch("evo_dbias1", *args, out0=db1)
    return dq, dk, dv, db1, db2


def _on_cuda(x, what: str) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


def evo_fwd(q, k, v, b1=None, b2=None):
    """The forward kernel (arguments as ``evo_fwd_plain``, canonical
    layout): CUDA tensors launch it and raise on anything it does not take;
    CPU tensors run the plain version. Returns (out, lse)."""
    if _on_cuda(q, "evo_fwd"):
        return _evo_fwd_cuda(q, k, v, b1, b2)
    return evo_fwd_plain(q, k, v, b1, b2)


def evo_bwd(q, k, v, b1, b2, out, lse, do, need_db1: bool = True,
            need_db2: bool = True):
    """The dq and dkv kernels, and each bias-gradient kernel whose bias is
    present and asked for (arguments as ``evo_bwd_plain``): CUDA tensors
    launch them, CPU tensors run the plain version. Returns (dq, dk, dv,
    db1, db2)."""
    if _on_cuda(q, "evo_bwd"):
        return _evo_bwd_cuda(q, k, v, b1, b2, out, lse, do, need_db1,
                             need_db2)
    return evo_bwd_plain(q, k, v, b1, b2, out, lse, do, need_db1, need_db2)


class EvoformerAttentionFunction(torch.autograd.Function):
    """Evoformer attention on the canonical layout with the kernels'
    forward and backward (the reference's ``_evo_core`` ``custom_vjp``):
    the forward saves (q, k, v, biases, out, lse); the backward launches a
    bias-gradient kernel only for a bias whose gradient autograd asks for
    (OpenFold's mask bias takes none)."""

    @staticmethod
    def forward(ctx, q, k, v, b1, b2):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        b1 = None if b1 is None else b1.contiguous()
        b2 = None if b2 is None else b2.contiguous()
        out, lse = evo_fwd(q, k, v, b1, b2)
        ctx.save_for_backward(q, k, v, b1, b2, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, b1, b2, out, lse = ctx.saved_tensors
        need = ctx.needs_input_grad
        return evo_bwd(q, k, v, b1, b2, out, lse, do.contiguous(),
                       need_db1=need[3], need_db2=need[4])


def fused_evoformer_attention(q, k, v, biases: Sequence = ()):
    """Fused evoformer attention (the counterpart of
    ``pallas_evoformer_attention``; the TPU's block sizes and ``interpret``
    flag have no meaning here): q/k/v ``[*, L, H, D]``, biases as in
    ``canonicalize``. Differentiable in q, k, v and both biases; a
    broadcast bias's gradient sums back to its own shape. Raises
    ``UnsupportedBiasLayout`` for a layout outside the kernels' contract."""
    lead = q.shape[:-3]
    q5, k5, v5, b1, b2 = canonicalize(q, k, v, biases)
    out = EvoformerAttentionFunction.apply(q5, k5, v5, b1, b2)
    return out.reshape(*lead, *out.shape[-3:])
