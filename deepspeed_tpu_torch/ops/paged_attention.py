"""Paged (blocked) attention over the serving KV cache.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py``. The TPU kernel
``_paged_kernel`` becomes the hand-written CUDA kernel in
``csrc/paged_attention.cu`` (design notes there); ``paged_attention`` is its
wrapper, and ``paged_attention_plain`` is the plain PyTorch version with the
semantics of the reference's ``paged_attention_reference``.

The wrapper dispatches on where the tensors lie: CUDA tensors launch the
kernel or raise; CPU tensors run the plain version. Nothing catches a build
or launch failure to run the plain version instead.

Cache layout is head-major ``[Hkv, num_blocks, block_size, d]`` per layer
and K/V, as in the reference.
"""

import ctypes
import math
from typing import Optional

import torch

from deepspeed_tpu_torch.models.llama import softcap_logits
from deepspeed_tpu_torch.ops import build

NEG_INF = -1e30
KERNEL = "paged_attention"
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_lib: Optional[ctypes.CDLL] = None


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
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.dstt_paged_attention_smem_bytes
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_int
        _lib = lib
    return _lib


def dynamic_smem_bytes(head_dim: int, rows: int) -> int:
    """Dynamic shared memory (bytes) the kernel requests for ``head_dim``
    with ``rows`` query rows per block, as the built library reports it."""
    n = _library().dstt_paged_attention_smem_bytes(head_dim, rows)
    if n < 0:
        raise ValueError(f"paged_attention kernel: no instantiation for "
                         f"head_dim {head_dim}, {rows} rows")
    return n


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
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dstt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if k_scales is not None else None,
            v_scales.data_ptr() if v_scales is not None else None,
            block_tables.data_ptr(), start_pos.data_ptr(), out.data_ptr(),
            b, t, h, hkv, nb, bs, d, mb, int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(d), _Q_DTYPES[q.dtype],
            int(k_pages.dtype == torch.float8_e4m3fn), stream)
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
