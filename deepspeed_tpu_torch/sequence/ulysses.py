"""DeepSpeed-Ulysses sequence parallelism: head-scatter all-to-all attention.

Port of ``deepspeed_tpu/sequence/ulysses.py`` (reference
``deepspeed/sequence/layer.py:271``, ``DistributedAttention``): q/k/v
arrive sequence-sharded ``[B, S/P, H, D]``; an all-to-all scatters heads
and gathers sequence -> ``[B, S, H/P, D]``; local attention runs over the
full sequence with a slice of heads; an inverse all-to-all restores
sequence sharding. Four all-to-alls per attention (q, k, v and the
output), recorded as ``sequence/ulysses/all_to_all``; the segment ids'
all-gather as ``sequence/ulysses/all_gather``.

Each rank passes its shard and gets its shard back. GQA keeps its KV head
count through the scatter when ``Hkv % sp == 0``: rank r's query heads
``[r H/sp, (r+1) H/sp)`` read its KV heads ``[r Hkv/sp, (r+1) Hkv/sp)``.

Uneven heads (``H`` or ``Hkv`` not a multiple of ``sp``): with the built-in
attention the largest sp-divisible head group takes the all-to-all and the
``H mod sp`` remainder heads stay sequence-sharded and ride the ring
(``ring.py``), KV densified to the query head count first; with a custom
``attn_fn`` every head runs through it, zero-padded to the next multiple
of ``sp``.

``window`` (a port argument): the sliding window of the built-in
attention, run by the windowed flash kernels on the gathered sequence.
The JAX model sends a window off the flash path to plain attention over
the global array, which gives the same result; no rank holds that array
here.
"""

import torch

from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.sequence import collectives as col
from deepspeed_tpu_torch.sequence.ring import (ring_attention_local,
                                               ring_attention_local_flash,
                                               sequence_mesh)

LABEL = "sequence/ulysses"
SEG_WITH_FN = ("segment_ids with a custom local_attention is unsupported — "
               "mask inside your attn_fn instead")
SEG_UNEVEN = ("segment_ids with an sp-indivisible head count (uneven-heads "
              "ulysses) is unsupported — pad heads or use the flash/xla "
              "backend")


def ulysses_attention(q, k, v, causal: bool = True, mesh=None,
                      use_flash: bool = True, attn_fn=None, segment_ids=None,
                      ring_impl=None, window=None):
    """q ``[B, S_l, H, D]``, k/v ``[B, S_l, Hkv, D]``: this rank's shards
    of the sequence; returns this rank's ``[B, S_l, H, D]``.

    ``attn_fn(q, k, v)`` overrides the local attention computed on the
    gathered sequence; by default the flash kernels (their plain mirrors on
    CPU tensors; ``use_flash=False``: the reference attention).
    ``segment_ids`` ``[B, S_l]`` this rank's packed-sequence ids, gathered
    so the local attention masks the full sequence. ``ring_impl`` is the
    impl of the uneven remainder's ring (``"flash"``/``"interpret"``: the
    contiguous flash ring; else the plain body; None picks flash for CUDA
    tensors)."""
    mesh = sequence_mesh(mesh)
    sp = mesh.shape["sequence"]

    def local(qq, kk, vv, seg=None):
        if attn_fn is not None:
            if seg is not None:
                raise NotImplementedError(SEG_WITH_FN)
            return attn_fn(qq, kk, vv)
        if use_flash:
            return fa.flash_attention_auto(qq, kk, vv, causal=causal,
                                           window=window, segment_ids=seg)
        return fa.attention_reference(qq, kk, vv, causal=causal,
                                      window=window, segment_ids=seg)

    if sp == 1:
        return local(q, k, v, segment_ids)
    uneven = q.shape[2] % sp != 0 or k.shape[2] % sp != 0
    if segment_ids is not None and uneven:
        raise NotImplementedError(SEG_UNEVEN)
    if segment_ids is not None and attn_fn is not None:
        raise NotImplementedError(SEG_WITH_FN)    # before any collective
    if window is not None and uneven and attn_fn is None:
        raise NotImplementedError(
            "sliding_window with an sp-indivisible head count: the remainder "
            "heads ride the ring, which takes no window — pad heads")

    def a2a_attention(q_l, k_l, v_l, seg_l=None):
        # [B, S/sp, Hl, D] -> scatter heads / gather sequence -> [B, S, Hl/sp, D]
        qg = col.all_to_all(q_l, 2, 1, LABEL)
        kg = col.all_to_all(k_l, 2, 1, LABEL)
        vg = col.all_to_all(v_l, 2, 1, LABEL)
        seg = col.all_gather_ids(seg_l, LABEL) if seg_l is not None else None
        out = local(qg, kg, vg, seg)
        # inverse: scatter sequence / gather heads
        return col.all_to_all(out, 1, 2, LABEL)

    if not uneven:
        return a2a_attention(q, k, v, segment_ids)
    # uneven heads: densify GQA so q/kv share a head count
    h_local = q.shape[2]
    k = fa._kv_for_heads(k, h_local)
    v = fa._kv_for_heads(v, h_local)
    if attn_fn is not None:
        # a custom local_attention must see EVERY head, so pad heads to the
        # next sp multiple and run them all through the all-to-all; the
        # padded zero heads are sliced off after the inverse all-to-all
        pad = (-h_local) % sp

        def pz(x):
            z = torch.zeros((*x.shape[:2], pad, x.shape[3]), dtype=x.dtype,
                            device=x.device)
            return torch.cat([x, z], dim=2)
        out = a2a_attention(pz(q), pz(k), pz(v))
        return out[:, :, :h_local]
    # built-in attention: the sp-divisible head group takes the all-to-all,
    # the H mod sp remainder rides the ring — H/sp heads of work a rank
    h_even = (h_local // sp) * sp
    parts = []
    if h_even:
        parts.append(a2a_attention(q[:, :, :h_even], k[:, :, :h_even],
                                   v[:, :, :h_even]))
    if h_local - h_even:          # GQA-only unevenness leaves no remainder
        rem = (q[:, :, h_even:], k[:, :, h_even:], v[:, :, h_even:])
        impl = ring_impl or ("flash" if q.is_cuda else "xla")
        if impl in ("flash", "interpret"):
            parts.append(ring_attention_local_flash(
                *rem, sp, causal, "sequence", interpret=impl == "interpret"))
        else:
            parts.append(ring_attention_local(*rem, sp, causal=causal))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
