"""Generic paged serving loop: policy-parameterized prefill + decode.

Port of ``deepspeed_tpu/inference/v2/generic_decode.py``. The policy
(``modules.py``) contributes embed/block/unembed; the loop owns the KV
cache writes and the paged attention (``llama_decode._paged_attn``). The
reference jits these functions; PyTorch runs them eagerly.

``cache_data`` is the pool ``[L, 2, Hkv, NB, bs, d]`` or, for scaled fp8
pages, a ``(pool, scales)`` tuple. The pool is written in place and
returned, so callers may treat the functions as the reference's pure ones.
"""

import torch

from deepspeed_tpu_torch.inference.v2.kv_cache import (write_kv,
                                                       write_kv_scaled)
from deepspeed_tpu_torch.inference.v2.llama_decode import _paged_attn


def _chunk_states(params, cache_data, tokens, start, block_table, true_len,
                  policy, cfg, block_size: int, attn_impl: str):
    """Shared chunk forward: embeds a bucket-padded token chunk, writes each
    layer's K/V into the pages, attends over the paged context, and returns
    the per-row hidden states [Tb, D]. ``start`` and ``true_len`` are host
    ints; ``tokens`` [Tb] and ``block_table`` [MB] are device tensors."""
    spec = policy.cache_spec(cfg)
    dev = tokens.device
    tb = tokens.shape[0]
    mb = block_table.shape[0]
    scaled = isinstance(cache_data, tuple)
    pool, scales = cache_data if scaled else (cache_data, None)

    rows = torch.arange(tb, device=dev)
    safe_pos = torch.clamp(start + rows, max=spec.max_seq_len - 1)
    tok_block = torch.where(
        rows < true_len,
        block_table.long()[torch.clamp(safe_pos // block_size, max=mb - 1)],
        pool.shape[3] - 1)
    tok_off = safe_pos % block_size
    touched = None
    if scaled:
        # pages the chunk's valid tokens can land on: a contiguous table
        # slice (clamped duplicates repeat the same slot with identical
        # updates). Offsets start%bs .. start%bs+tb-1 span up to
        # (tb + bs - 2)//bs + 1 pages
        n_touch = (tb + block_size - 2) // block_size + 1
        touched = block_table[torch.clamp(
            start // block_size + torch.arange(n_touch, device=dev),
            max=mb - 1)]
    start_t = torch.full((1,), start, dtype=torch.int32, device=dev)
    table_2d = block_table[None]

    x = policy.embed(params, tokens.long(), safe_pos, cfg)
    for i in range(spec.num_layers):
        def attend(q, k, v, i=i, window="spec", softcap=None):
            win = spec.window if window == "spec" else window
            if scaled:
                write_kv_scaled(pool, scales, i, 0, k, tok_block, tok_off,
                                touched)
                write_kv_scaled(pool, scales, i, 1, v, tok_block, tok_off,
                                touched)
            else:
                write_kv(pool, i, 0, k, tok_block, tok_off)
                write_kv(pool, i, 1, v, tok_block, tok_off)
            return _paged_attn(q[None], pool, i, table_2d, start_t, win,
                               attn_impl, softcap=softcap, scales=scales)[0]
        x = policy.block(params, i, x, attend, safe_pos, cfg)
    return x


def prefill_chunk_g(params, cache_data, tokens, start, block_table, true_len,
                    policy, cfg, block_size: int, attn_impl: str = "auto"):
    """One sequence, one bucket-padded chunk; returns (last-token logits
    [V], cache_data). tokens: [Tb] (bucket-padded); start: chunk offset;
    block_table: [MB] block ids (trash-padded); true_len: real tokens."""
    x = _chunk_states(params, cache_data, tokens, start, block_table,
                      true_len, policy, cfg, block_size, attn_impl)
    last = x[max(true_len - 1, 0)]
    logits = policy.unembed(params, last[None], cfg)[0]
    return logits, cache_data


def verify_chunk_g(params, cache_data, tokens, start, block_table, true_len,
                   policy, cfg, block_size: int, attn_impl: str = "auto"):
    """Speculative-decoding verifier: the same cache-writing chunk forward
    as ``prefill_chunk_g`` but returns logits for EVERY row ([Tb, V]) — row
    i holds the prediction for position ``start + i + 1``. Rejected rows'
    K/V writes land beyond the accepted context and are invisible (causal
    masking doubles as the context-length mask) until a later step
    overwrites them."""
    x = _chunk_states(params, cache_data, tokens, start, block_table,
                      true_len, policy, cfg, block_size, attn_impl)
    return policy.unembed(params, x, cfg), cache_data


def decode_step_g(params, cache_data, tokens, positions, block_tables, valid,
                  policy, cfg, block_size: int, attn_impl: str = "auto"):
    """Batched single-token decode over [B] tokens/positions/valid and
    [B, MB] tables (device tensors); returns (logits [B, V], cache_data)."""
    spec = policy.cache_spec(cfg)
    mb = block_tables.shape[1]
    scaled = isinstance(cache_data, tuple)
    pool, scales = cache_data if scaled else (cache_data, None)

    safe_pos = torch.clamp(positions.long(), max=spec.max_seq_len - 1)
    page_idx = torch.clamp(safe_pos // block_size, max=mb - 1)
    blk = torch.where(
        valid, block_tables.long().gather(1, page_idx[:, None])[:, 0],
        pool.shape[3] - 1)
    off = safe_pos % block_size
    start = safe_pos.to(torch.int32)

    x = policy.embed(params, tokens.long(), safe_pos, cfg)
    for i in range(spec.num_layers):
        def attend(q, k, v, i=i, window="spec", softcap=None):
            win = spec.window if window == "spec" else window
            if scaled:
                # each token touches exactly its own page (invalid rows all
                # write the trash page with identical per-page updates)
                write_kv_scaled(pool, scales, i, 0, k, blk, off, blk)
                write_kv_scaled(pool, scales, i, 1, v, blk, off, blk)
            else:
                write_kv(pool, i, 0, k, blk, off)
                write_kv(pool, i, 1, v, blk, off)
            return _paged_attn(q[:, None], pool, i, block_tables, start, win,
                               attn_impl, softcap=softcap,
                               scales=scales)[:, 0]
        x = policy.block(params, i, x, attend, safe_pos, cfg)
    return policy.unembed(params, x, cfg), cache_data
