"""Inference v2 decode policies and their registry.

Port of ``deepspeed_tpu/inference/v2/modules.py``, with ``LlamaPolicy`` only
(llama / mistral / qwen2 / phi3 / gemma are ``LlamaConfig`` variants); the
other architectures' policies come with later slices.

A policy is a class of static methods over the parameter tree; the generic
paged serving loop (``generic_decode.py``) owns the KV cache, block tables
and the paged-attention call, and the policy contributes:

- ``embed(params, tokens, positions, cfg)``          -> [N, D] hidden states
- ``block(params, i, x, attend, positions, cfg)``    -> [N, D] (one layer;
  calls ``attend(q, k, v)`` for cache write + paged attention)
- ``unembed(params, x, cfg)``                        -> [N, V] fp32 logits
- ``cache_spec(cfg)`` so the engine can size the paged KV pool.
"""

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.inference.v2.llama_decode import _mlp, _qkv, _rms
from deepspeed_tpu_torch.models.llama import (LlamaConfig, rope_freqs,
                                              softcap_logits)

DECODE_POLICIES: Dict[str, type] = {}
_CONFIG_TO_POLICY: Dict[type, type] = {}


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    max_seq_len: int
    dtype: Any
    window: Optional[int] = None      # sliding-window width or None


def register_policy(name: str, config_type: type):
    """Register a decode policy under ``name`` and for ``config_type``."""
    def deco(cls):
        DECODE_POLICIES[name] = cls
        _CONFIG_TO_POLICY[config_type] = cls
        cls.arch = name
        return cls
    return deco


def policy_for(model_config) -> type:
    """Map a model config to its decode policy."""
    cls = _CONFIG_TO_POLICY.get(type(model_config))
    if cls is None:
        raise ValueError(
            f"no decode policy registered for {type(model_config).__name__}; "
            f"known: {sorted(DECODE_POLICIES)}")
    return cls


_ROPE_CACHE: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _rope_tables(head_dim: int, max_seq_len: int, theta: float,
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's float32 rope tables, uploaded once per device."""
    key = (head_dim, max_seq_len, theta, str(device))
    tables = _ROPE_CACHE.get(key)
    if tables is None:
        cos, sin = rope_freqs(head_dim, max_seq_len, theta)
        tables = (torch.from_numpy(cos).to(device),
                  torch.from_numpy(sin).to(device))
        _ROPE_CACHE[key] = tables
    return tables


def _rope_rows(x, cos, sin, positions):
    """x: [N, H, d]; positions: [N] — rotary on per-row absolute positions."""
    cos_p = cos[positions][:, None, :]
    sin_p = sin[positions][:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p], -1)
    return out.to(x.dtype)


@register_policy("llama", LlamaConfig)
class LlamaPolicy:
    """Llama family: llama / mistral (sliding_window) / qwen2
    (attention_bias) / phi3 / gemma (gelu_tanh, rms_scale_offset,
    scale_embeddings)."""

    @staticmethod
    def cache_spec(cfg: LlamaConfig) -> KVCacheSpec:
        return KVCacheSpec(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_,
                           cfg.max_seq_len, cfg.dtype, cfg.sliding_window)

    @staticmethod
    def _norm_scale(scale, cfg):
        # gemma stores norm weights as an offset from 1 (rms_scale_offset)
        return scale + 1.0 if cfg.rms_scale_offset else scale

    @staticmethod
    def embed(params, tokens, positions, cfg):
        x = params["model"]["embed"]["embedding"][tokens].to(cfg.dtype)
        if cfg.scale_embeddings:   # gemma normalizer
            x = x * torch.tensor(math.sqrt(cfg.hidden_size),
                                 dtype=torch.float32).to(x.dtype)
        return x

    @staticmethod
    def block(params, i, x, attend, positions, cfg):
        lp = params["model"][f"layer_{i}"]
        ns = LlamaPolicy._norm_scale
        cos, sin = _rope_tables(cfg.head_dim_, cfg.max_seq_len,
                                cfg.rope_theta, x.device)
        h = _rms(x, ns(lp["attn_norm"]["scale"], cfg), cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, cfg.dtype)
        q = _rope_rows(q, cos, sin, positions)
        k = _rope_rows(k, cos, sin, positions)
        attn = attend(q, k, v)
        x = x + torch.einsum("thk,hkd->td", attn,
                             lp["attn"]["wo"]["kernel"].to(cfg.dtype))
        h2 = _rms(x, ns(lp["mlp_norm"]["scale"], cfg), cfg.rms_norm_eps)
        return x + _mlp(lp, h2, act=cfg.hidden_act, dtype=cfg.dtype)

    @staticmethod
    def unembed(params, x, cfg):
        """[N, D] -> [N, V] float32 logits: the normalised hidden state
        widened to float32 times the float32 head, as the reference
        multiplies against its float32 master (``convert.py`` keeps the
        head in float32)."""
        x = _rms(x, LlamaPolicy._norm_scale(
            params["model"]["final_norm"]["scale"], cfg), cfg.rms_norm_eps)
        if cfg.tie_embeddings:
            w = params["model"]["embed"]["embedding"].T
        else:
            w = params["model"]["lm_head"]["kernel"]
        logits = x.float() @ w.float()
        return softcap_logits(logits, cfg.logits_soft_cap)
