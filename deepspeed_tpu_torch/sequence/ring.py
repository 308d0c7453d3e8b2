"""Ring attention: blockwise context parallelism over a ``ppermute`` ring.

Port of ``deepspeed_tpu/sequence/ring.py``. KV blocks rotate around the
mesh's ``sequence`` axis while each rank's queries stay put, with
flash-style online-softmax accumulation: O(S/P) activation memory.
Causality uses global positions: rank i holds queries [i*S_l, (i+1)*S_l);
at ring step t it holds the KV block of rank (i - t) mod P.

The JAX package runs one ``shard_map`` over the global arrays. Here every
function takes this rank's shard ``[B, S_l, H, D]`` (k/v ``[B, S_l, Hkv,
D]``) and returns this rank's output; the ring's hops are facade
``ppermute``s recorded as ``sequence/ring/ppermute`` and the layout's
reshards as ``sequence/stripe/all_to_all``.

- ``ring_attention_local``: the plain online-softmax body (the JAX
  package's ``"xla"`` impl), differentiated by autograd through the
  differentiable ``ppermute`` of ``sequence/collectives.py``.
- ``_RingCore``: the flash ring. Each step's block is the flash forward
  (``ops/flash_attention.py::flash_fwd``, the CUDA kernel on CUDA tensors)
  with the step's ``causal`` / ``causal_shift`` and the ``(q_ids,
  k_ids)`` pair whose key half rode the ring; the blocks' ``(o, lse)`` are
  stitched by ``_combine``. The backward re-rotates K/V and runs the flash
  backward per block against the FINAL lse, with the dK/dV accumulators
  riding the ring home. ``plain=True`` (the ``"interpret"`` impls) runs
  the kernels' plain mirrors instead, on any device.
- Striped layout (``_stripe`` / ``_unstripe``): causal runs striped when
  ``S_l % sp == 0``, so every step is one uniform shifted-causal block.

Two departures from the JAX scan, both exact:
- the forward skips the last K/V hop (JAX's scan rotates K/V on its final
  step and drops them; the backward skips it too, while the dK/dV
  accumulators take all ``sp`` hops home);
- a skipped block (a future block of the contiguous causal ring) is not
  combined: JAX combines a zero block at ``_SKIP_LSE``, which leaves
  ``(o, lse)`` unchanged bit for bit.

``impl=None`` picks the flash ring for CUDA tensors and ``"xla"`` for CPU
tensors, as the JAX package picks by backend; ``default_impl(...)``
overrides that choice for the calls made inside it (the model's ring
backend takes no impl).
"""

import contextlib
import math
from typing import Optional

import torch

from deepspeed_tpu_torch.comm.mesh import get_global_mesh
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.sequence import collectives as col

NEG_INF = -1e30
_SKIP_LSE = -1e30     # finite "no contribution" lse (a true -inf NaNs combine)
LABEL = "sequence/ring"
STRIPE_LABEL = "sequence/stripe"
IMPLS = ("flash", "flash_contiguous", "xla", "interpret",
         "interpret_contiguous")

_default_impl: Optional[str] = None


@contextlib.contextmanager
def default_impl(impl: Optional[str]):
    """Use ``impl`` for the ``ring_attention`` calls inside that name none."""
    global _default_impl
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"unknown ring impl {impl!r}; known: {IMPLS}")
    saved, _default_impl = _default_impl, impl
    try:
        yield
    finally:
        _default_impl = saved


def sequence_mesh(mesh=None):
    """The global mesh (``mesh``, when given, must be it: the facade's
    collectives run on the global mesh's groups)."""
    glob = get_global_mesh()
    if glob is None:
        raise RuntimeError("no global mesh: build one with comm.create_mesh "
                           "and install it with comm.set_global_mesh")
    if mesh is not None and mesh is not glob:
        raise ValueError("sequence parallelism runs on the global mesh; "
                         "install this mesh with comm.set_global_mesh")
    return glob


def ring_attention_local(q_l, k_l, v_l, sp: int, causal: bool = True,
                         axis_name: str = "sequence"):
    """The plain ring body (JAX's ``"xla"`` impl): q_l ``[B, S_l, H, D]``,
    k_l/v_l ``[B, S_l, Hkv, D]`` this rank's shards; returns ``[B, S_l, H,
    D]``. Scores and the P.V products in fp32 (JAX's
    ``preferred_element_type``), P rounded to v's dtype."""
    b, s_l, h, d = q_l.shape
    k_cur, v_cur = fa._kv_for_heads(k_l, h), fa._kv_for_heads(v_l, h)
    idx = sequence_mesh().axis_index(axis_name)
    dev = q_l.device
    qpos = idx * s_l + torch.arange(s_l, device=dev)
    scale = 1.0 / math.sqrt(d)
    perm = col.ring_perm(sp)
    m = torch.full((b, h, s_l), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s_l), dtype=torch.float32, device=dev)
    o = torch.zeros((b, h, s_l, d), dtype=torch.float32, device=dev)
    for t in range(sp):
        src = (idx - t) % sp
        kpos = src * s_l + torch.arange(s_l, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", q_l.float(), k_cur.float()) * scale
        if causal:
            mask = (qpos[:, None] >= kpos[None, :])[None, None]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v_cur.dtype).float(), v_cur.float())
        m = m_new
        if t < sp - 1:          # the last hop would only bring K/V home
            k_cur = col.ppermute(k_cur, perm, LABEL, axis_name)
            v_cur = col.ppermute(v_cur, perm, LABEL, axis_name)
    out = o / l.clamp_min(1e-30)[..., None]              # [B, H, S_l, D]
    return out.permute(0, 2, 1, 3).to(q_l.dtype)


# ---------------------------------------------------------------------------
# the flash ring: the per-step [S_l, S_l] score panel never materializes
# ---------------------------------------------------------------------------
def _combine(o1, lse1, o2, lse2):
    """Merge two normalized partial attentions (o ``[B, S, H, D]`` fp32,
    lse ``[B, H, S]``): the flash multi-block stitch."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    lse = m + torch.log(w1 + w2)
    w1q = w1.transpose(1, 2)[..., None]        # [B, S, H, 1]
    w2q = w2.transpose(1, 2)[..., None]
    o = (w1q * o1 + w2q * o2) / (w1q + w2q)
    return o, lse


# The per-step block policy of each layout (``mode``):
#   "causal":  contiguous layout: the diagonal step causal, earlier steps
#              full, later steps skipped (the skew the striped layout
#              removes)
#   "full":    non-causal: every step a full block
#   "striped": striped layout: every step causal, with a one-row shift on
#              strictly-future stripes (src > idx)


def step_block(mode: str, src: int, idx: int):
    """``(causal, causal_shift)`` of the block from rank ``src`` on rank
    ``idx``, or None when the block is skipped."""
    if mode == "full":
        return False, 0
    if mode == "striped":
        return True, (1 if src > idx else 0)
    if src == idx:
        return True, 0
    if src < idx:
        return False, 0
    return None


def _pair(seg, kseg):
    return None if seg is None else (seg, kseg)


class _RingCore(torch.autograd.Function):
    """The flash ring over this rank's q ``[B, S_l, H, D]`` and k/v ``[B,
    S_l, Hkv, D]`` (GQA inside the kernels); ``seg`` ``[B, S_l]`` int32
    packed-sequence ids or None (the KV block's ids ride the ring with it,
    the queries keep their own)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, sp, idx, mode, plain, axis):
        fwd = fa.flash_fwd_plain if plain else fa.flash_fwd
        b, s_l, h, d = q.shape
        o_acc = torch.zeros((b, s_l, h, d), dtype=torch.float32,
                            device=q.device)
        lse_acc = torch.full((b, h, s_l), _SKIP_LSE, dtype=torch.float32,
                             device=q.device)
        k_cur, v_cur, kseg = k, v, seg
        for t in range(sp):
            blk = step_block(mode, (idx - t) % sp, idx)
            if blk is not None:
                o_t, lse_t = fwd(q, k_cur, v_cur, blk[0], None, blk[1],
                                 _pair(seg, kseg))
                o_acc, lse_acc = _combine(o_acc, lse_acc, o_t.float(), lse_t)
            if t < sp - 1:      # the last hop would only bring K/V home
                k_cur = col.send_next(k_cur, sp, LABEL, axis)
                v_cur = col.send_next(v_cur, sp, LABEL, axis)
                if seg is not None:
                    kseg = col.send_next(kseg, sp, LABEL, axis)
        # the combine's broadcast over lse's [B, H, S] layout can leave o_acc
        # strided; the backward's kernels take contiguous operands
        out = o_acc.to(q.dtype).contiguous()
        ctx.save_for_backward(q, k, v, out, lse_acc)
        ctx.seg = seg
        ctx.opts = (sp, idx, mode, plain, axis)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        seg = ctx.seg
        sp, idx, mode, plain, axis = ctx.opts
        bwd = fa.flash_bwd_plain if plain else fa.flash_bwd
        g = g.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur, kseg = k, v, seg
        for t in range(sp):
            blk = step_block(mode, (idx - t) % sp, idx)
            if blk is not None:
                dq_c, dk_c, dv_c = bwd(q, k_cur, v_cur, out, lse, g, blk[0],
                                       None, blk[1], _pair(seg, kseg))
                dq += dq_c.float()
                dk += dk_c.float()
                dv += dv_c.float()
            # the dK/dV accumulators ride the ring WITH their block: after
            # sp hops every block's gradient is back on its home rank
            dk = col.send_next(dk, sp, LABEL, axis)
            dv = col.send_next(dv, sp, LABEL, axis)
            if t < sp - 1:
                k_cur = col.send_next(k_cur, sp, LABEL, axis)
                v_cur = col.send_next(v_cur, sp, LABEL, axis)
                if seg is not None:
                    kseg = col.send_next(kseg, sp, LABEL, axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)


def _ring_core(q, k, v, seg, sp: int, mode: str, axis: str, plain: bool):
    idx = sequence_mesh().axis_index(axis)
    if seg is not None:
        seg = seg.to(torch.int32).contiguous()
    return _RingCore.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           seg, sp, idx, mode, plain, axis)


def _stripe(x, sp: int, axis_name: str):
    """Contiguous sequence shard -> striped shard (local row i holds global
    position i * sp + idx)."""
    b, s_l = x.shape[:2]
    y = x.reshape(b, s_l // sp, sp, *x.shape[2:])
    y = col.all_to_all(y, 2, 2, STRIPE_LABEL, axis_name, tiled=False)
    return y.transpose(1, 2).reshape(x.shape)


def _unstripe(x, sp: int, axis_name: str):
    b, s_l = x.shape[:2]
    y = x.reshape(b, sp, s_l // sp, *x.shape[2:])
    y = col.all_to_all(y, 1, 1, STRIPE_LABEL, axis_name, tiled=False)
    return y.transpose(1, 2).reshape(x.shape)


def ring_attention_local_flash(q_l, k_l, v_l, sp: int, causal: bool,
                               axis_name: str = "sequence",
                               interpret: bool = False, seg_l=None):
    """Contiguous-layout flash ring (see ``_RingCore``); ``interpret`` runs
    the kernels' plain mirrors."""
    return _ring_core(q_l, k_l, v_l, seg_l, sp,
                      "causal" if causal else "full", axis_name, interpret)


def ring_attention_local_striped(q_l, k_l, v_l, sp: int,
                                 axis_name: str = "sequence",
                                 interpret: bool = False, seg_l=None):
    """Load-balanced causal ring: stripe q/k/v (and the segment ids), run
    the shifted-causal flash ring, unstripe the output. Requires
    ``S_l % sp == 0`` (checked by the caller)."""
    q_s = _stripe(q_l, sp, axis_name)
    k_s = _stripe(k_l, sp, axis_name)
    v_s = _stripe(v_l, sp, axis_name)
    seg_s = _stripe(seg_l, sp, axis_name) if seg_l is not None else None
    out = _ring_core(q_s, k_s, v_s, seg_s, sp, "striped", axis_name,
                     interpret)
    return _unstripe(out, sp, axis_name)


def ring_attention(q, k, v, causal: bool = True, mesh=None,
                   impl: Optional[str] = None, segment_ids=None):
    """q ``[B, S_l, H, D]``, k/v ``[B, S_l, Hkv, D]``: this rank's
    contiguous shards of the sequence; returns this rank's ``[B, S_l, H,
    D]``. ``segment_ids`` ``[B, S_l]`` this rank's packed-sequence ids.

    ``impl``: ``"flash"`` (the flash kernels per ring block; causal runs
    STRIPED when ``S_l % sp == 0``), ``"flash_contiguous"`` (the skewed
    causal ring, no resharding), ``"xla"`` (the plain online-softmax body),
    ``"interpret"`` / ``"interpret_contiguous"`` (the flash rings through
    the kernels' plain mirrors). None picks flash for CUDA tensors, xla
    for CPU tensors (or ``default_impl``'s choice). At a sequence axis of
    one rank it is the flash backend (the JAX package's blockwise
    reference there)."""
    mesh = sequence_mesh(mesh)
    sp = mesh.shape["sequence"]
    if sp == 1:
        return fa.flash_attention_auto(q, k, v, causal=causal,
                                       segment_ids=segment_ids)
    if impl is None:
        impl = _default_impl or ("flash" if q.is_cuda else "xla")
    if impl not in IMPLS:
        raise ValueError(f"unknown ring impl {impl!r}; known: {IMPLS}")
    if segment_ids is not None and impl == "xla":
        raise NotImplementedError(
            "packed-sequence segment_ids need the flash ring (the plain body "
            "does not carry segment ids) — impl='flash' or 'interpret'")
    s_l = q.shape[1]
    if impl == "xla":
        return ring_attention_local(q, k, v, sp, causal=causal)
    interpret = impl.startswith("interpret")
    if causal and s_l % sp == 0 and impl in ("flash", "interpret"):
        return ring_attention_local_striped(q, k, v, sp, "sequence",
                                            interpret, seg_l=segment_ids)
    return ring_attention_local_flash(q, k, v, sp, causal, "sequence",
                                      interpret, seg_l=segment_ids)
