"""Evoformer (DS4Science) attention: the public entry point, the blockwise
path and the naive oracle.

Port of ``deepspeed_tpu/ops/evoformer_attn.py``. Semantics:
``softmax(q k^T / sqrt(d) + bias1 + bias2) v`` where q/k/v are
``[*, L, H, D]`` and each bias broadcasts to ``[*, H, Lq, Lk]`` (AlphaFold
usage: bias1 is the MSA mask ``[B, N, 1, 1, L]``, bias2 the pair bias
``[B, 1, H, L, L]``).

``DS4Sci_EvoformerAttention`` sends every layout within the kernels'
contract to ``fused_evoformer_attention`` (``ops/evoformer.py``: the CUDA
kernels on CUDA tensors, their plain versions on CPU tensors). Only a bias
layout outside that contract (``UnsupportedBiasLayout``) takes the blockwise
key-tile path ``evoformer_attention``, which takes any broadcastable bias
and differentiates through torch autograd; any other error propagates.
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.evoformer import (UnsupportedBiasLayout,
                                               fused_evoformer_attention)

NEG_INF = -1e30


def _pad_bias(bias, l_k, pad_k):
    """Pad a bias's last (key) dim in lockstep with k/v (broadcast dims of
    size 1 stay as they are; padded columns are masked by the key mask)."""
    if bias.shape[-1] == 1:
        return bias
    if bias.shape[-1] != l_k:
        raise ValueError(
            f"bias last dim {bias.shape[-1]} must be 1 or key length {l_k}")
    return F.pad(bias, (0, pad_k)) if pad_k else bias


def _slice_bias(bias, start, size):
    return bias if bias.shape[-1] == 1 else bias[..., start:start + size]


def evoformer_attention(q, k, v, biases: Sequence = (), block_k: int = 512):
    """q, k, v: [*, L, H, D]; biases: up to 2 tensors broadcastable to
    [*, H, Lq, Lk]. An online softmax over key tiles of ``block_k`` with
    fp32 scores; returns [*, Lq, H, D] in q's dtype."""
    *lead, l_q, h, d = q.shape
    l_k = k.shape[-3]
    scale = 1.0 / math.sqrt(d)
    block_k = min(block_k, l_k)
    pad_k = (-l_k) % block_k
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k)) if pad_k else k
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k)) if pad_k else v
    biases = tuple(_pad_bias(b, l_k, pad_k) for b in biases)
    nk = kp.shape[-3] // block_k

    m = torch.full((*lead, h, l_q), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((*lead, h, l_q), dtype=torch.float32, device=q.device)
    o = torch.zeros((*lead, h, l_q, d), dtype=torch.float32, device=q.device)
    for ki in range(nk):
        start = ki * block_k
        k_blk = kp[..., start:start + block_k, :, :]
        v_blk = vp[..., start:start + block_k, :, :]
        s = torch.einsum("...qhd,...khd->...hqk", q.float(),
                         k_blk.float()) * scale
        for b in biases:
            s = s + _slice_bias(b.float(), start, block_k)
        live = torch.arange(start, start + block_k, device=q.device) < l_k
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "...hqk,...khd->...hqd", p.to(v_blk.dtype).float(),
            v_blk.float())
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.movedim(-3, -2).to(q.dtype)


def DS4Sci_EvoformerAttention(q, k, v, biases: Sequence = ()):  # noqa: N802
    """The reference-named entry point (DeepSpeed's
    ``DS4Sci_EvoformerAttention``): q/k/v [*, L, H, D], a list of at most 2
    biases (None entries dropped). Layouts within the kernels' contract go
    to ``fused_evoformer_attention``; only ``UnsupportedBiasLayout`` routes
    to the blockwise path."""
    if len(biases) > 2:
        raise ValueError("DS4Sci_EvoformerAttention supports at most 2 biases")
    biases = tuple(b for b in biases if b is not None)
    try:
        return fused_evoformer_attention(q, k, v, biases)
    except UnsupportedBiasLayout:
        pass       # bias layout outside the kernels' contract
    return evoformer_attention(q, k, v, biases)


def evoformer_attention_reference(q, k, v, biases: Sequence = ()):
    """Naive oracle for tests."""
    d = q.shape[-1]
    s = torch.einsum("...qhd,...khd->...hqk", q, k).float() / math.sqrt(d)
    for b in biases:
        s = s + b.float()
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("...hqk,...khd->...hqd", p.to(v.dtype), v)
    return out.movedim(-3, -2)
