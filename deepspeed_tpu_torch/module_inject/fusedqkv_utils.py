"""Fused-QKV weight splitting for tensor parallelism.

Port of ``deepspeed_tpu/module_inject/fusedqkv_utils.py`` (reference
``deepspeed/module_inject/fusedqkv_utils.py``): fused QKV matrices can't
be naively chunked across TP ranks because q/k/v (and, under GQA,
differently sized k/v) interleave along the fused output dim; the
reference ships per-layout splitters (``_glm_type_transpose``,
``_bloom_type_transpose``, ``_qwen_type_transpose`` dispatched by
``prepare_tp_fused_qkvw``). Host-side numpy, as in the JAX package.

Layouts here:
- ``"concat"``  — [*, q_out | k_out | v_out] (llama-style qkv_proj, falcon new,
  qwen): split each of q/k/v into tp chunks and take chunk[rank] of each.
- ``"interleaved"`` — [*, heads x (q|k|v) x head_dim] (bloom/gpt2 c_attn style,
  per-head interleave): heads divide across ranks, so a plain chunk of the
  head-major dim is correct after viewing as [heads, 3*head_dim].
"""

from typing import Tuple

import numpy as np


def qkv_sizes(n_heads: int, n_kv_heads: int, head_dim: int) -> Tuple[int, int, int]:
    return n_heads * head_dim, n_kv_heads * head_dim, n_kv_heads * head_dim


def unfuse_qkv(w: np.ndarray, n_heads: int, n_kv_heads: int, head_dim: int,
               layout: str = "concat"):
    """Split a fused [in, q+k+v] (or [q+k+v] bias) into (q, k, v) arrays."""
    q_sz, k_sz, v_sz = qkv_sizes(n_heads, n_kv_heads, head_dim)
    if w.shape[-1] != q_sz + k_sz + v_sz:
        raise ValueError(f"fused dim {w.shape[-1]} != q+k+v = {q_sz + k_sz + v_sz} "
                         f"(heads={n_heads}, kv_heads={n_kv_heads}, hd={head_dim})")
    if layout == "concat":
        return (w[..., :q_sz], w[..., q_sz:q_sz + k_sz], w[..., q_sz + k_sz:])
    if layout == "interleaved":
        if n_kv_heads != n_heads:
            raise ValueError("interleaved layout requires MHA (kv_heads == heads)")
        per = w.reshape(*w.shape[:-1], n_heads, 3, head_dim)
        q, k, v = per[..., 0, :], per[..., 1, :], per[..., 2, :]
        flat = lambda t: t.reshape(*w.shape[:-1], n_heads * head_dim)  # noqa: E731
        return flat(q), flat(k), flat(v)
    raise ValueError(f"unknown fused-qkv layout {layout!r}")


def split_fused_qkv(w: np.ndarray, n_heads: int, n_kv_heads: int, head_dim: int,
                    tp_size: int, rank: int, layout: str = "concat") -> np.ndarray:
    """Return ``rank``'s shard of a fused QKV weight, still fused
    (reference: ``prepare_tp_fused_qkvw``). Output fused dim = (q+k+v)/tp.

    Under GQA, ``n_kv_heads`` must divide ``tp_size``-evenly; replicating kv heads
    across ranks (tp > kv_heads) is not supported — mirror of the reference's
    uneven-head constraint.
    """
    if n_heads % tp_size or n_kv_heads % tp_size:
        raise ValueError(f"heads ({n_heads}, kv={n_kv_heads}) must divide tp={tp_size}")
    if layout == "interleaved":
        # heads are the interleave-major unit: chunking the head dim preserves the
        # per-head (q|k|v) interleave within each shard
        if n_kv_heads != n_heads:
            raise ValueError("interleaved layout requires MHA (kv_heads == heads)")
        per = w.reshape(*w.shape[:-1], n_heads, 3 * head_dim)
        shard = np.split(per, tp_size, axis=-2)[rank]
        return shard.reshape(*w.shape[:-1], (n_heads // tp_size) * 3 * head_dim)
    q, k, v = unfuse_qkv(w, n_heads, n_kv_heads, head_dim, layout)
    qs = np.split(q, tp_size, axis=-1)
    ks = np.split(k, tp_size, axis=-1)
    vs = np.split(v, tp_size, axis=-1)
    return np.concatenate([qs[rank], ks[rank], vs[rank]], axis=-1)


def shard_qkv_param(w: np.ndarray, n_heads: int, n_kv_heads: int, head_dim: int,
                    tp_size: int, layout: str = "concat") -> np.ndarray:
    """All shards stacked on a new leading axis — convenient for
    ``jax.device_put`` with a per-shard sharding or for host-side scatter."""
    return np.stack([
        split_fused_qkv(w, n_heads, n_kv_heads, head_dim, tp_size, r, layout)
        for r in range(tp_size)])
