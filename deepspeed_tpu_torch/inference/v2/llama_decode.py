"""Llama pieces of the serving forward: the paged-attention dispatch and the
norm, QKV and MLP math.

Port of ``deepspeed_tpu/inference/v2/llama_decode.py``. Tensors keep the
reference's layouts (``wq [D,H,hd]``, ``w_gate [D,F]``), so the einsum
strings are the reference's.
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_plain)

ATTN_IMPLS = ("auto", "kernel", "gather")


def _paged_attn(q, cache_data, layer, block_tables, start_pos, window,
                attn_impl: str, softcap=None, scales=None):
    """q: [B, T, H, d] over the head-major pool [L, 2, Hkv, NB, bs, d].

    ``attn_impl``: ``auto`` runs the CUDA kernel on CUDA tensors and the
    plain version on CPU tensors; ``kernel`` insists on the kernel (CPU
    tensors raise); ``gather`` is the caller's explicit choice of the plain
    version (used to compare against the kernel). ``scales`` ([L, 2, Hkv,
    NB] fp32, fp8 pages) dequantize per (head, page) on load."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; one of {ATTN_IMPLS}")
    k_pages, v_pages = cache_data[layer, 0], cache_data[layer, 1]
    ks, vs = (scales[layer, 0], scales[layer, 1]) if scales is not None \
        else (None, None)
    if attn_impl == "gather":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     start_pos, window=window,
                                     softcap=softcap, k_scales=ks, v_scales=vs)
    if attn_impl == "kernel" and q.device.type != "cuda":
        raise ValueError("attn_impl='kernel' runs the CUDA kernel and needs "
                         f"CUDA tensors, got {q.device}")
    return paged_attention(q, k_pages, v_pages, block_tables, start_pos,
                           window=window, softcap=softcap, k_scales=ks,
                           v_scales=vs)


def _rms(x, scale, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _qkv(lp, x, dtype):
    """x: [T, D] -> q [T,H,d], k/v [T,Hkv,d] (+ bias when present —
    qwen2-style attention_bias); weights cast to ``dtype`` (the reference's
    ``.astype(dtype)``)."""
    a = lp["attn"]
    q = torch.einsum("td,dhk->thk", x, a["wq"]["kernel"].to(dtype))
    k = torch.einsum("td,dhk->thk", x, a["wk"]["kernel"].to(dtype))
    v = torch.einsum("td,dhk->thk", x, a["wv"]["kernel"].to(dtype))
    if "bias" in a["wq"]:
        q = q + a["wq"]["bias"].to(dtype)
        k = k + a["wk"]["bias"].to(dtype)
        v = v + a["wv"]["bias"].to(dtype)
    return q, k, v


def _mlp(lp, x, act: str, dtype):
    m = lp["mlp"]
    g = x @ m["w_gate"]["kernel"].to(dtype)
    u = x @ m["w_up"]["kernel"].to(dtype)
    if act == "silu":
        gated = F.silu(g)
    elif act == "gelu_tanh":
        gated = F.gelu(g, approximate="tanh")
    else:
        raise ValueError(f"unsupported hidden_act {act!r} (silu | gelu_tanh)")
    return (gated * u) @ m["w_down"]["kernel"].to(dtype)
