"""Block-sparse attention over a sparsity layout: the dense oracle, the plain
blockwise version, the CUDA kernel's wrapper, the autograd function and
``SparseSelfAttention``.

Port of ``deepspeed_tpu/ops/sparse_attention/attention.py``. Its TPU kernel
``_sparse_kernel`` becomes the hand-written CUDA kernel of
``csrc/sparse_attention.cu`` (design notes there), launched by
``sparse_attention_cuda`` and counted as ``sparse_attention``. The reference
has no backward kernel: ``_sp_bwd`` recomputes through the blockwise ``lax``
path, and the port's backward recomputes through ``block_sparse_attention``
the same way, in chunks of query blocks so a full-size problem never holds
the whole graph.

Semantics (the reference's): q, k, v ``[B, S, H, D]``; a layout ``[H, nb,
nb]`` (nb = S // block); token (i, j) of head h may attend iff
``layout[h, i // block, j // block] == 1`` and, with ``causal``, i >= j.
``block_sparse_attention`` takes the kernel's rounding points: fp32 scores
(dot times ``1/sqrt(D)``), masked scores at ``NEG_INF`` and their p forced
to 0, an online softmax over key blocks in ascending order that rounds p to
v's dtype against the running max of each block, ``acc / max(l, 1e-30)``
(a row with no live key gives 0). CPU tensors run it; CUDA tensors launch
the kernel (block 16, 32, 64 or 128; D 32, 64 or 128; fp32 or bf16) or
raise. Nothing catches a build or launch failure to run the plain version
instead. bf16 runs on the tensor cores, 64 query rows a block of threads,
over the group CSR (``SparseLayout.group_csr``); fp32 on the CUDA cores over
the per-query-block CSR.
"""

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.quant import on_card

KERNEL = "sparse_attention"
NEG_INF = -1e30
BLOCKS = (16, 32, 64, 128)
HEAD_DIMS = (32, 64, 128)
MMA_ROWS = 64              # query rows of a block of the bf16 kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# score elements (B * H * rows * S) of one query chunk of the backward's
# recompute: about 2 GB of saved fp32 tensors at the smoke's shapes
BWD_CHUNK_ELEMS = 1 << 27
_lib: Optional[ctypes.CDLL] = None


def group_size(block: int) -> int:
    """Query blocks of one group of the bf16 kernel: its 64 rows hold
    64 // block of them (one at block 64 and 128)."""
    return max(1, MMA_ROWS // block)


class SparseLayout:
    """A layout [H, nb, nb] with its CSR list of live key blocks per (head,
    query block) in ascending order, and the group CSR of the bf16 kernel,
    each built once per device (and group size) on first use."""

    def __init__(self, layout):
        lay = layout.layout if isinstance(layout, SparseLayout) else layout
        if isinstance(lay, torch.Tensor):
            lay = lay.detach().cpu().numpy()
        self.layout = np.asarray(lay)
        if self.layout.ndim != 3 or self.layout.shape[1] != self.layout.shape[2]:
            raise ValueError(f"layout must be [H, nb, nb], got {self.layout.shape}")
        self._csr: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._group_csr: Dict[Tuple[str, int], Tuple[torch.Tensor, ...]] = {}
        self._masks: Dict[str, torch.Tensor] = {}

    def csr(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(row_ptr int32 [H * nb + 1], cols int32 [live blocks]) on device."""
        key = str(torch.device(device))
        if key not in self._csr:
            h, nb, _ = self.layout.shape
            rows, cols = np.nonzero(self.layout.reshape(h * nb, nb))
            row_ptr = np.zeros(h * nb + 1, np.int64)
            np.cumsum(np.bincount(rows, minlength=h * nb), out=row_ptr[1:])
            self._csr[key] = (
                torch.as_tensor(row_ptr.astype(np.int32), device=device),
                torch.as_tensor(cols.astype(np.int32), device=device))
        return self._csr[key]

    def group_csr(self, device, block: int) -> Tuple[torch.Tensor, ...]:
        """The bf16 kernel's lists on device, all int32: (grp_ptr [H * ng +
        1], cols, masks, order). For each (head, group of g = group_size(
        block) consecutive query blocks; ng = ceil(nb / g)) the ascending
        union of the group's live key blocks; bit i of an entry's mask says
        that the group's query block i takes it (at g = 1 it is ``csr``
        with every mask 1). ``order`` [H * nx] lists the kernel's blocks of
        MMA_ROWS query rows (h * nx + x, nx = ceil(S / MMA_ROWS)) by the
        length of their group's list, longest first (stable)."""
        key = (str(torch.device(device)), block)
        if key not in self._group_csr:
            h, nb, _ = self.layout.shape
            g = group_size(block)
            ng = -(-nb // g)
            lay = np.zeros((h, ng * g, nb), bool)
            lay[:, :nb] = self.layout != 0
            lay = lay.reshape(h, ng, g, nb)
            bits = (lay.astype(np.int64)
                    << np.arange(g)[None, None, :, None]).sum(2)
            rows, cols = np.nonzero(bits.reshape(h * ng, nb))
            counts = np.bincount(rows, minlength=h * ng)
            ptr = np.zeros(h * ng + 1, np.int64)
            np.cumsum(counts, out=ptr[1:])
            masks = bits.reshape(h * ng, nb)[rows, cols]
            nx = -(-nb * block // MMA_ROWS)
            x = np.arange(nx)
            work = counts.reshape(h, ng)[:, x * MMA_ROWS // (block * g)]
            order = np.argsort(-work.reshape(-1), kind="stable")
            self._group_csr[key] = tuple(
                torch.as_tensor(a.astype(np.int32), device=device)
                for a in (ptr, cols, masks, order))
        return self._group_csr[key]

    def mask(self, device) -> torch.Tensor:
        """The layout as a bool tensor on device."""
        key = str(torch.device(device))
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(self.layout != 0, device=device)
        return self._masks[key]


def as_layout(layout) -> SparseLayout:
    return layout if isinstance(layout, SparseLayout) else SparseLayout(layout)


def dense_mask_from_layout(layout, block: int, seq_len: int) -> np.ndarray:
    """[H, nb, nb] {0,1} -> [H, S, S] boolean token mask (test oracle)."""
    lay = as_layout(layout).layout
    m = np.repeat(np.repeat(np.asarray(lay, bool), block, 1), block, 2)
    return m[:, :seq_len, :seq_len]


def _scale(d: int) -> float:
    """1/sqrt(D) as the fp32 the scores are multiplied by."""
    return float(np.float32(1.0 / np.sqrt(d)))


def sparse_attention_reference(q, k, v, layout, block: int,
                               causal: bool = False) -> torch.Tensor:
    """Naive masked softmax oracle over the dense [B, H, S, S] scores."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(q.shape[-1])
    sq = q.shape[1]
    mask = torch.as_tensor(dense_mask_from_layout(layout, block, sq),
                           device=q.device)
    if causal:
        pos = torch.arange(sq, device=q.device)
        mask = mask & (pos[:, None] >= pos[None, :])
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with no live key give 0, like the blocked implementations
    alive = mask.any(-1)[None, ..., None]
    return torch.einsum("bhqk,bkhd->bqhd",
                        torch.where(alive, p, 0.0).to(v.dtype), v)


def _blockwise(q, k, v, layout: SparseLayout, block: int, causal: bool,
               q0: int = 0, p_dtype: Optional[torch.dtype] = None):
    """Online softmax over key blocks for query rows q0 .. q0 + Sq - 1
    (Sq and q0 multiples of block; k, v hold all S keys), p rounded to
    ``p_dtype`` (v's dtype) before P.V. Key blocks dead for every head and
    query block of the chunk are skipped: they would leave m, l and acc
    exactly as they are (alpha = 1, p = 0)."""
    b, sq, h, d = q.shape
    s_all = k.shape[1]
    qb0, qb1 = q0 // block, (q0 + sq) // block
    lay = layout.layout[:, qb0:qb1]                       # numpy [H, nq, nb]
    live = layout.mask(q.device)[:, qb0:qb1]              # [H, nq, nb]
    p_dtype = p_dtype or v.dtype
    scale = _scale(d)
    qf = q.float()
    qpos = torch.arange(q0, q0 + sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    o = torch.zeros((b, h, sq, d), device=q.device)
    for ki in range(s_all // block):
        if not lay[:, :, ki].any():
            continue
        ks = slice(ki * block, (ki + 1) * block)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, ks].float()) * scale
        mask = live[:, :, ki].repeat_interleave(block, dim=1)[None, :, :, None]
        if causal:
            kpos = torch.arange(ki * block, (ki + 1) * block, device=q.device)
            mask = mask & (qpos[:, None] >= kpos[None, :])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(p_dtype).float(), v[:, ks].float())
        m = m_new
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _check_shapes(q, k, v, layout: SparseLayout, block: int) -> None:
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: one [B, S, H, D] shape")
    if s % block:
        raise ValueError(f"sequence length {s} must be divisible by block "
                         f"{block}")
    if layout.layout.shape != (h, s // block, s // block):
        raise ValueError(f"layout {layout.layout.shape} for H={h}, "
                         f"nb={s // block}")


def block_sparse_attention(q, k, v, layout, block: int,
                           causal: bool = False) -> torch.Tensor:
    """The plain blockwise version (differentiable through autograd): what
    the kernel computes, with its rounding points."""
    lay = as_layout(layout)
    _check_shapes(q, k, v, lay, block)
    return _blockwise(q, k, v, lay, block, causal)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dstt_sparse_attention.argtypes = [p] * 10 + [i] * 6 + [
            ctypes.c_float, i, p]
        lib.dstt_sparse_attention.restype = ctypes.c_int
        lib.dstt_sparse_smem_bytes.argtypes = [i, i, i]
        lib.dstt_sparse_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def dynamic_smem_bytes(head_dim: int, block: int,
                       dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one launch (builds the library)."""
    return _library().dstt_sparse_smem_bytes(head_dim, block, _DTYPES[dtype])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sparse_attention kernel: {msg}")


def sparse_attention_cuda(q, k, v, layout, block: int,
                          causal: bool = False) -> torch.Tensor:
    """Launch the kernel; counted as ``sparse_attention``."""
    lay = as_layout(layout)
    _check_shapes(q, k, v, lay, block)
    _check(q.device.type == "cuda" and k.device == q.device and
           v.device == q.device, f"q on {q.device}, k on {k.device}, v on "
           f"{v.device}")
    _check(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"dtypes {q.dtype}/{k.dtype}/{v.dtype} (one of float32, bfloat16)")
    _check(block in BLOCKS, f"block {block} (one of {BLOCKS})")
    b, s, h, d = q.shape
    _check(d in HEAD_DIMS, f"head dim {d} (one of {HEAD_DIMS})")
    _check(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)),
           "q, k and v must be contiguous and 16-byte aligned")
    if q.dtype == torch.bfloat16:        # the tensor-core kernel: group CSR
        lists = (None, None, *lay.group_csr(q.device, block))
    else:
        lists = (*lay.csr(q.device), None, None, None, None)
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dstt_sparse_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(None if x is None else x.data_ptr() for x in lists), b, s, h,
            d, block, int(causal), _scale(d), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"sparse_attention kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch("sparse_attention")
    return out


def sparse_attention_fwd(q, k, v, layout, block: int,
                         causal: bool = False) -> torch.Tensor:
    """The forward alone: the kernel on CUDA tensors, the plain blockwise
    version on CPU tensors."""
    if on_card(q, "sparse_attention"):
        return sparse_attention_cuda(q, k, v, layout, block, causal)
    return block_sparse_attention(q, k, v, layout, block, causal)


def bwd_chunk_rows(b: int, s: int, h: int, block: int) -> int:
    """Query rows per chunk of the backward's recompute: a multiple of
    block, at most BWD_CHUNK_ELEMS score elements."""
    rows = BWD_CHUNK_ELEMS // max(1, b * h * s) // block * block
    return min(s, max(block, rows))


def sparse_attention_bwd(q, k, v, layout, block: int, causal: bool,
                         g: torch.Tensor):
    """(dq, dk, dv) through the blockwise version's autograd, chunk by chunk
    of query blocks; dk and dv are summed over the chunks in fp32 and
    rounded once."""
    lay = as_layout(layout)
    b, s, h, _ = q.shape
    rows = bwd_chunk_rows(b, s, h, block)
    dq = torch.empty_like(q)
    kf = k.detach().float().requires_grad_(True)
    vf = v.detach().float().requires_grad_(True)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for r0 in range(0, s, rows):
        with torch.enable_grad():
            qc = q[:, r0:r0 + rows].detach().float().requires_grad_(True)
            out = _blockwise(qc, kf, vf, lay, block, causal, q0=r0,
                             p_dtype=v.dtype)
            gq, gk, gv = torch.autograd.grad(out, (qc, kf, vf),
                                             g[:, r0:r0 + rows].float())
        dq[:, r0:r0 + rows] = gq.to(q.dtype)
        dk += gk
        dv += gv
        del out, gq, gk, gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class SparseAttentionFunction(torch.autograd.Function):
    """``pallas_block_sparse_attention``'s custom vjp: the kernel forward
    (the plain version on CPU tensors), the recomputing backward."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block, causal):
        ctx.save_for_backward(q, k, v)
        ctx.layout, ctx.block, ctx.causal = layout, block, causal
        return sparse_attention_fwd(q, k, v, layout, block, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = sparse_attention_bwd(q, k, v, ctx.layout, ctx.block,
                                          ctx.causal, g)
        return dq, dk, dv, None, None, None


def sparse_attention(q, k, v, layout, block: int,
                     causal: bool = False) -> torch.Tensor:
    """Block-sparse attention, differentiable in q, k and v: the kernel's
    forward on CUDA tensors (dead blocks cost nothing), the recomputing
    backward. Counterpart of ``pallas_block_sparse_attention``."""
    lay = as_layout(layout)
    _check_shapes(q, k, v, lay, block)
    return SparseAttentionFunction.apply(q, k, v, lay, block, causal)


class SparseSelfAttention:
    """Config-driven entry point (reference ``sparse_self_attention.py``):
    holds a SparsityConfig, builds and caches the layout (with its CSR list)
    per sequence length, and runs ``sparse_attention``: the kernel on CUDA
    tensors, the plain version on CPU tensors. ``causal`` defaults to the
    config's ``attention == "unidirectional"``."""

    def __init__(self, sparsity_config, causal: Optional[bool] = None):
        self.config = sparsity_config
        self.causal = (sparsity_config.attention == "unidirectional"
                       if causal is None and
                       hasattr(sparsity_config, "attention") else bool(causal))
        self._layouts: Dict[int, SparseLayout] = {}

    def sparse_layout(self, seq_len: int) -> SparseLayout:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = SparseLayout(self.config.make_layout(seq_len))
        return self._layouts[seq_len]

    def layout(self, seq_len: int) -> np.ndarray:
        return self.sparse_layout(seq_len).layout

    def __call__(self, q, k, v):
        return sparse_attention(q, k, v, self.sparse_layout(q.shape[1]),
                                self.config.block, self.causal)

