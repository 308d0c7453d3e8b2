"""Flash attention for training: plain versions, the CUDA kernels' wrappers
and the autograd function.

Port of ``deepspeed_tpu/ops/flash_attention.py`` (its
``attention_reference``; the blockwise ``flash_attention`` has no caller in
the port and is not ported) and of
``deepspeed_tpu/ops/pallas/flash_attention.py``. The three TPU kernels,
``_flash_kernel``, ``_dq_kernel`` and ``_dkv_kernel``, become the
hand-written CUDA kernels of ``csrc/flash_attention.cu`` (design notes
there), launched by ``flash_fwd`` and ``flash_bwd`` and counted as
``flash_fwd``, ``flash_dq`` and ``flash_dkv``. The library picks by dtype:
bf16 runs all three on the tensor cores (``wgmma`` fed by TMA), fp32 on
the CUDA cores.

``flash_fwd_plain`` and ``flash_bwd_plain`` compute what the kernels
compute, with the same masks and the same rounding points (the causal mask
aligned at row 0, fp32 scores scaled after the dot, p rounded to v's dtype
before P.V, dS rounded to k's/q's dtype and p to dO's dtype in the
backward), so a kernel and its plain version differ only in summation
order. CPU tensors run them; CUDA tensors launch the kernels or raise.
Nothing catches a build or launch failure to run a plain version instead.

Layouts are the reference's: q ``[B, Sq, H, d]``, k/v ``[B, Sk, Hkv, d]``,
query head ``h`` reads KV head ``h // (H // Hkv)``. ``lse`` is
``[B, H, Sq]`` fp32 (the reference's ``[B*H, Sq_padded, 1]`` without the
TPU's padding and trailing unit axis).
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.models.llama import _xla_attention
from deepspeed_tpu_torch.ops import build

NEG_INF = -1e30
KERNEL = "flash_attention"
LAUNCH_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")
# the entries of dstt_flash_smem_bytes: the CUDA-core kernels, then the
# bf16 tensor-core forward, dK/dV and dQ
SMEM_ENTRIES = LAUNCH_NAMES + ("flash_fwd_wgmma", "flash_dkv_wgmma",
                               "flash_dq_wgmma")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_lib: Optional[ctypes.CDLL] = None


# ---------------------------------------------------------------------------
# the reference's plain attention
# ---------------------------------------------------------------------------
def attention_reference(q, k, v, causal: bool = True, window=None,
                        segment_ids=None):
    """O(S^2)-memory reference: the causal mask is offset by ``Sk - Sq``
    (the last query row sees the last key); ``window`` masks to the band
    (t-window, t]; ``segment_ids`` [B, S] confines attention within packed
    segments. The model's plain backend computes it."""
    return _xla_attention(q, k, v, causal, segment_ids, window=window)


# ---------------------------------------------------------------------------
# plain mirrors of the three kernels
# ---------------------------------------------------------------------------
def _seg_pair(segment_ids, sq: int, sk: int):
    """``segment_ids`` [B, S] (shared) or a ``(q_ids [B, Sq], k_ids
    [B, Sk])`` pair -> int32 (q_ids, k_ids), or (None, None)."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        q_ids, k_ids = segment_ids
    else:
        q_ids = k_ids = segment_ids
    q_ids = q_ids.to(torch.int32)
    k_ids = k_ids[:, :sk].to(torch.int32)
    if q_ids.shape[1] != sq or k_ids.shape[1] != sk:
        raise ValueError(f"segment ids {tuple(q_ids.shape)}/"
                         f"{tuple(k_ids.shape)} do not cover Sq={sq}, Sk={sk}")
    return q_ids, k_ids


def _kernel_mask(q, k, causal, window, causal_shift, segment_ids):
    """[B or 1, 1, Sq, Sk] bool: the kernels' mask (``_masked_scores``)."""
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal or window is not None:
        mask = qpos >= kpos + causal_shift
    if window is not None:
        mask = mask & (kpos > qpos - window)
    mask = mask[None, None]
    q_ids, k_ids = _seg_pair(segment_ids, sq, sk)
    if q_ids is not None:
        mask = mask & (q_ids[:, :, None] == k_ids[:, None, :])[:, None]
    return mask


def _kv_for_heads(x, num_heads: int):
    """[B, S, Hkv, d] -> [B, S, H, d]: query head h reads KV head h // rep."""
    return x.repeat_interleave(num_heads // x.shape[2], dim=2)


def flash_fwd_plain(q, k, v, causal: bool = True, window=None,
                    causal_shift: int = 0, segment_ids=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_flash_kernel`` computes: (out [B,Sq,H,d] in q's dtype,
    lse [B,H,Sq] fp32)."""
    b, sq, h, d = q.shape
    kh, vh = _kv_for_heads(k, h), _kv_for_heads(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh.float()) * (
        1.0 / math.sqrt(d))
    mask = _kernel_mask(q, k, causal, window, causal_shift, segment_ids)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vh.float())
    out = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
    return out, m[..., 0] + torch.log(l)


def _bwd_delta(out, do):
    """delta = rowsum(dO . O) in fp32, [B, H, Sq] (taken outside the
    kernels, as the reference does)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_plain(q, k, v, out, lse, do, causal: bool = True, window=None,
                    causal_shift: int = 0, segment_ids=None):
    """What ``_dq_kernel`` and ``_dkv_kernel`` compute: (dq, dk, dv) in
    q's/k's/v's dtypes."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = 1.0 / math.sqrt(d)
    kh, vh = _kv_for_heads(k, h), _kv_for_heads(v, h)
    mask = _kernel_mask(q, k, causal, window, causal_shift, segment_ids)
    delta = _bwd_delta(out, do)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh.float()) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vh.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kh.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = dk.reshape(b, -1, hkv, rep, d).sum(3)
    dv = dv.reshape(b, -1, hkv, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i] * 9 + [f, i, p]      # B Sq Sk H Hkv d causal window shift, scale, dtype, stream
        lib.dstt_flash_fwd.argtypes = [p] * 7 + tail
        lib.dstt_flash_dq.argtypes = [p] * 9 + tail
        lib.dstt_flash_dkv.argtypes = [p] * 10 + tail
        for fn in (lib.dstt_flash_fwd, lib.dstt_flash_dq, lib.dstt_flash_dkv):
            fn.restype = ctypes.c_int
        lib.dstt_flash_smem_bytes.argtypes = [i, i]
        lib.dstt_flash_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def dynamic_smem_bytes(head_dim: int) -> dict:
    """Dynamic shared memory (bytes) of each kernel at ``head_dim``, as the
    built library reports it."""
    lib = _library()
    return {name: lib.dstt_flash_smem_bytes(i, head_dim)
            for i, name in enumerate(SMEM_ENTRIES)}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _cuda_args(q, k, v, causal, window, causal_shift, segment_ids,
               extra=()):
    """Validate the operands and return the launch's common arguments."""
    dev = q.device
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "q [B,Sq,H,d], k/v [B,Sk,Hkv,d]")
    b, sq, h, d = q.shape
    _, sk, hkv, dk = k.shape
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(d in _HEAD_DIMS, f"head_dim {d} (one of {_HEAD_DIMS})")
    _check(k.shape[0] == b and dk == d and v.shape == k.shape, "shapes")
    _check(hkv > 0 and h % hkv == 0, f"{h} query heads over {hkv} KV heads")
    for x in (q, k, v) + tuple(extra):
        _check(x.device == dev, f"tensor on {x.device}, q on {dev}")
        _check(x.is_contiguous(), "inputs must be contiguous")
    for x in (k, v) + tuple(t for t in extra if t.dim() == 4):
        _check(x.dtype == q.dtype, f"{x.dtype} mixed with {q.dtype}")
    for x in (q, k, v):
        _check(x.data_ptr() % 16 == 0, "q, k, v must be 16-byte aligned")
    _check(causal_shift in (0, 1), "causal_shift must be 0 or 1")
    _check(window is None or int(window) > 0, "window must be None or > 0")
    q_ids, k_ids = _seg_pair(segment_ids, sq, sk)
    if q_ids is not None:
        _check(q_ids.device == dev and k_ids.device == dev,
               "segment ids on another device")
        q_ids, k_ids = q_ids.contiguous(), k_ids.contiguous()
    causal = bool(causal or window is not None)
    ints = (b, sq, sk, h, hkv, d, int(causal), int(window or 0),
            int(causal_shift))
    return q_ids, k_ids, ints


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _flash_fwd_cuda(q, k, v, causal, window, causal_shift, segment_ids):
    q_ids, k_ids, ints = _cuda_args(q, k, v, causal, window, causal_shift,
                                    segment_ids)
    b, sq, _, h = ints[:4]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dstt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_ids.data_ptr() if q_ids is not None else None,
            k_ids.data_ptr() if k_ids is not None else None,
            out.data_ptr(), lse.data_ptr(), *ints, 1.0 / math.sqrt(q.shape[-1]),
            _DTYPES[q.dtype], stream)
    _raise_on(err, "flash_fwd")
    build.count_launch("flash_fwd")
    return out, lse


def _flash_bwd_cuda(q, k, v, out, lse, do, causal, window, causal_shift,
                    segment_ids):
    q_ids, k_ids, ints = _cuda_args(q, k, v, causal, window, causal_shift,
                                    segment_ids, extra=(out, lse, do))
    b, sq, _, h = ints[:4]
    _check(out.shape == q.shape and do.shape == q.shape, "out/dO shapes")
    _check(lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, sq),
           "lse float32 [B, H, Sq]")
    delta = _bwd_delta(out, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    seg = (q_ids.data_ptr() if q_ids is not None else None,
           k_ids.data_ptr() if k_ids is not None else None)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr()) + seg
    tail = ints + (1.0 / math.sqrt(q.shape[-1]), _DTYPES[q.dtype])
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dstt_flash_dq(*common, dq.data_ptr(), *tail, stream)
        _raise_on(err, "flash_dq")
        build.count_launch("flash_dq")
        err = lib.dstt_flash_dkv(*common, dk.data_ptr(), dv.data_ptr(), *tail,
                                 stream)
        _raise_on(err, "flash_dkv")
        build.count_launch("flash_dkv")
    return dq, dk, dv


def _dispatch(x, what: str):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


def flash_fwd(q, k, v, causal: bool = True, window=None, causal_shift: int = 0,
              segment_ids=None):
    """The forward kernel (arguments as ``flash_fwd_plain``): CUDA tensors
    launch it and raise on anything it does not take; CPU tensors run the
    plain version. Returns (out, lse)."""
    if _dispatch(q, "flash_fwd"):
        return _flash_fwd_cuda(q, k, v, causal, window, causal_shift,
                               segment_ids)
    return flash_fwd_plain(q, k, v, causal, window, causal_shift, segment_ids)


def flash_bwd(q, k, v, out, lse, do, causal: bool = True, window=None,
              causal_shift: int = 0, segment_ids=None):
    """The dQ and dK/dV kernels (arguments as ``flash_bwd_plain``): CUDA
    tensors launch them, CPU tensors run the plain version. Returns
    (dq, dk, dv)."""
    if _dispatch(q, "flash_bwd"):
        return _flash_bwd_cuda(q, k, v, out, lse, do, causal, window,
                               causal_shift, segment_ids)
    return flash_bwd_plain(q, k, v, out, lse, do, causal, window,
                           causal_shift, segment_ids)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with the kernels' forward and backward (the
    reference's ``custom_vjp``): the forward saves (q, k, v, out, lse), as
    ``_fwd`` does; the backward recomputes the scores per tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, segment_ids):
        out, lse = flash_fwd(q, k, v, causal, window, 0, segment_ids)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, segment_ids)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, segment_ids = ctx.opts
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(), causal,
                               window, 0, segment_ids)
        return dq, dk, dv, None, None, None


def flash_attention_auto(q, k, v, causal: bool = True, window=None,
                         segment_ids=None):
    """The ``flash`` attention backend (the counterpart of
    ``pallas_flash_attention``/``flash_attention_auto``; the TPU's block
    sizes and ``interpret`` flag have no meaning here): the kernels on CUDA
    tensors, their plain mirrors on CPU tensors, differentiable on both."""
    return FlashAttentionFunction.apply(q, k, v, causal, window, segment_ids)
