"""Paged (blocked) attention over the serving KV cache.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py``. The TPU kernel
``_paged_kernel`` becomes the hand-written CUDA kernel in
``csrc/paged_attention.cu`` (design notes there); ``paged_attention`` is its
wrapper, and ``paged_attention_plain`` is the plain PyTorch version with the
semantics of the reference's ``paged_attention_reference``.

The wrapper dispatches on where the tensors lie: CUDA tensors launch the
kernel or raise; CPU tensors run the plain version. Nothing catches a build
or launch failure to run the plain version instead.

On the card the kernel splits the table's key span over several blocks when
one block per (row tile, KV head, sequence) would leave SMs idle
(``split_plan``, a pure function of the grid, the key span, the SM count
and the blocks of the instantiation that fit on an SM, which the built
library reports); the splits' partials go to an fp32 workspace that the
wrapper keeps for each stream, and a second kernel of the same library call
merges them in a fixed order. A call counts one launch either way.

Cache layout is head-major ``[Hkv, num_blocks, block_size, d]`` per layer
and K/V, as in the reference.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.models.llama import softcap_logits
from deepspeed_tpu_torch.ops import build

NEG_INF = -1e30
KERNEL = "paged_attention"
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)   # 32: the tiny serving model (TINY_LLAMA)
KEYS_PER_TILE = 64         # the kernel's key tile
_lib: Optional[ctypes.CDLL] = None


def rows_per_block(fold: int) -> int:
    """Query rows of one block for a fold of ``fold`` = T * H / Hkv rows:
    the kernel's instantiations are 4, 8 and 32 rows."""
    return 4 if fold <= 4 else 8 if fold <= 8 else 32


@functools.lru_cache(maxsize=None)
def split_plan(batch: int, kv_heads: int, fold: int, key_span: int,
               sm_count: int, blocks_per_sm: int) -> Tuple[int, int]:
    """(n_split, tiles_per_split): split s of every row tile walks the key
    tiles [s * tiles_per_split, (s + 1) * tiles_per_split) of the
    ``key_span`` = max_blocks * block_size keys the block table names. A
    grid of ``batch * kv_heads * row tiles`` blocks that already fills
    ``sm_count`` SMs keeps one split; a smaller one takes as many splits as
    one wave of ``blocks_per_sm`` resident blocks an SM holds, and no split
    is empty by span."""
    n_tiles = -(-key_span // KEYS_PER_TILE)
    blocks = batch * kv_heads * -(-fold // rows_per_block(fold))
    if blocks >= sm_count or n_tiles <= 1:
        return 1, n_tiles
    want = max(1, min(n_tiles, blocks_per_sm * sm_count // blocks))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def blocks_per_sm(device: torch.device, head_dim: int, rows: int, q_dtype,
                  kv_dtype) -> int:
    """Blocks of the kernel's instantiation for (``head_dim``, ``rows``,
    q's dtype, the pages' dtype) that fit on one SM of ``device`` at once,
    by the CUDA occupancy calculator."""
    with torch.cuda.device(device):
        n = _library().dstt_paged_attention_blocks_per_sm(
            head_dim, rows, _Q_DTYPES[q_dtype],
            int(kv_dtype == torch.float8_e4m3fn))
    if n <= 0:
        raise RuntimeError(f"paged_attention kernel: no resident block for "
                           f"head_dim {head_dim}, {rows} rows, q {q_dtype}, "
                           f"pages {kv_dtype} (code {n})")
    return n


def paged_attention_plain(q, k_pages, v_pages, block_tables, start_pos,
                          window=None, softcap=None, k_scales=None,
                          v_scales=None):
    """Gather-based reference: q [B,T,H,d]; pages [Hkv,NB,bs,d] (model
    dtype, or fp8 with ``k_scales``/``v_scales`` [Hkv,NB] fp32);
    block_tables [B,MB] int; start_pos [B] int (row t attends
    ``kpos <= start_pos + t``). Returns [B,T,H,d] in q's dtype."""
    b, t, h, d = q.shape
    hkv, _, bs, _ = k_pages.shape
    rep = h // hkv
    mb = block_tables.shape[1]
    tables = block_tables.long()
    # [Hkv, B, MB, bs, d] -> [B, MB*bs, Hkv, d]
    gk = k_pages[:, tables]
    gv = v_pages[:, tables]
    if k_scales is not None:               # dequant before the dtype fold
        gk = gk.float() * k_scales[:, tables][..., None, None]
        gv = gv.float() * v_scales[:, tables][..., None, None]
    ctx_k = gk.permute(1, 2, 3, 0, 4).reshape(b, mb * bs, hkv, d)
    ctx_v = gv.permute(1, 2, 3, 0, 4).reshape(b, mb * bs, hkv, d)
    if rep > 1:
        ctx_k = ctx_k.repeat_interleave(rep, dim=2)
        ctx_v = ctx_v.repeat_interleave(rep, dim=2)
    ctx_k = ctx_k.to(q.dtype)              # fp8 pages dequantize on load
    ctx_v = ctx_v.to(q.dtype)
    s = torch.einsum("bthd,bkhd->bhtk", q.float(), ctx_k.float()) / math.sqrt(d)
    s = softcap_logits(s, softcap)
    qpos = start_pos.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    kpos = torch.arange(mb * bs, device=q.device)[None, None, :]
    mask = kpos <= qpos[..., None]
    if window is not None:
        mask = mask & (kpos > qpos[..., None] - window)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(ctx_v.dtype)
    return torch.einsum("bhtk,bkhd->bthd", p, ctx_v)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL)
        fn = lib.dstt_paged_attention
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.dstt_paged_attention_smem_bytes
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_int
        occ = lib.dstt_paged_attention_blocks_per_sm
        occ.argtypes = [ctypes.c_int] * 4
        occ.restype = ctypes.c_int
        _lib = lib
    return _lib


def dynamic_smem_bytes(head_dim: int, rows: int, kv_dtype) -> int:
    """Dynamic shared memory (bytes) the kernel requests for ``head_dim``
    with ``rows`` query rows per block over pages of ``kv_dtype``, as the
    built library reports it."""
    n = _library().dstt_paged_attention_smem_bytes(
        head_dim, rows, torch.empty((), dtype=kv_dtype).element_size())
    if n < 0:
        raise ValueError(f"paged_attention kernel: no instantiation for "
                         f"head_dim {head_dim}, {rows} rows, {kv_dtype}")
    return n


# the splits' fp32 workspace of each (device, stream), grown on demand: the
# calls on one stream run in order, so each may reuse the previous one's
_workspaces = {}


def _workspace(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    ws = _workspaces.get((device, stream))
    if ws is None or ws.numel() < numel:
        ws = torch.empty(numel, dtype=torch.float32, device=device)
        _workspaces[(device, stream)] = ws
    return ws


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def _paged_attention_cuda(q, k_pages, v_pages, block_tables, start_pos,
                          window, softcap, k_scales, v_scales):
    dev = q.device
    tensors = [k_pages, v_pages, block_tables, start_pos]
    if k_scales is not None or v_scales is not None:
        _check(k_scales is not None and v_scales is not None,
               "k_scales and v_scales come together")
        tensors += [k_scales, v_scales]
    for x in tensors:
        _check(x.device == dev, f"tensor on {x.device}, q on {dev}")
    for x in [q] + tensors:
        _check(x.is_contiguous(), "inputs must be contiguous")
    _check(q.dim() == 4 and k_pages.dim() == 4, "q [B,T,H,d], pages [Hkv,NB,bs,d]")
    b, t, h, d = q.shape
    hkv, nb, bs, dk = k_pages.shape
    mb = block_tables.shape[1] if block_tables.dim() == 2 else -1
    _check(q.dtype in _Q_DTYPES, f"q dtype {q.dtype} (float32 or bfloat16)")
    _check(d in _HEAD_DIMS, f"head_dim {d} (one of {_HEAD_DIMS})")
    _check(v_pages.shape == k_pages.shape and dk == d, "page shapes")
    _check(v_pages.dtype == k_pages.dtype
           and k_pages.dtype in (q.dtype, torch.float8_e4m3fn),
           f"pages {k_pages.dtype} (q's dtype or float8_e4m3fn)")
    _check(hkv > 0 and h % hkv == 0, f"{h} query heads over {hkv} KV heads")
    _check(block_tables.dtype == torch.int32 and block_tables.shape == (b, mb)
           and mb > 0, "block_tables int32 [B, MB]")
    _check(start_pos.dtype == torch.int32 and start_pos.shape == (b,),
           "start_pos int32 [B]")
    if k_scales is not None:
        for s in (k_scales, v_scales):
            _check(s.dtype == torch.float32 and s.shape == (hkv, nb),
                   "scales float32 [Hkv, NB]")
    _check(window is None or int(window) > 0, "window must be None or > 0")
    _check(not softcap or float(softcap) > 0, "softcap must be None or > 0")
    for x in (q, k_pages, v_pages):
        _check(x.data_ptr() % 16 == 0, "q and pages must be 16-byte aligned")

    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    fold = t * (h // hkv)
    rows = rows_per_block(fold)
    n_split, per = split_plan(b, hkv, fold, mb * bs, _sm_count(dev),
                              blocks_per_sm(dev, d, rows, q.dtype,
                                            k_pages.dtype))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = None                      # the splits' (acc, m, l), fp32
        if n_split > 1:
            ws = _workspace(dev, stream, n_split * b * hkv * fold * (d + 2))
        err = lib.dstt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if k_scales is not None else None,
            v_scales.data_ptr() if v_scales is not None else None,
            block_tables.data_ptr(), start_pos.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            b, t, h, hkv, nb, bs, d, mb, int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(d), _Q_DTYPES[q.dtype],
            int(k_pages.dtype == torch.float8_e4m3fn), rows, n_split, per,
            stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(KERNEL)
    return out


def paged_attention(q, k_pages, v_pages, block_tables, start_pos,
                    window=None, softcap=None, k_scales=None, v_scales=None):
    """Paged attention (arguments as ``paged_attention_plain``). CUDA
    tensors launch the CUDA kernel and raise on anything it does not take;
    CPU tensors run the plain version."""
    if q.device.type == "cuda":
        return _paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                     start_pos, window, softcap, k_scales,
                                     v_scales)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     start_pos, window=window, softcap=softcap,
                                     k_scales=k_scales, v_scales=v_scales)
    raise ValueError(f"paged_attention: unsupported device {q.device}")
