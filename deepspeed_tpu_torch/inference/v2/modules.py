"""Inference v2 decode policies and their registry.

Port of ``deepspeed_tpu/inference/v2/modules.py``, with ``LlamaPolicy``
(llama / mistral / qwen2 / phi3 / gemma are ``LlamaConfig`` variants),
``MixtralPolicy`` and ``Qwen2MoEPolicy`` (their trees from
``models/convert.py``'s ``moe_params_from_jax`` / ``init_moe_params``);
the other architectures' policies (bloom, gpt_neox, gpt2, gemma2, ...)
wait for ROADMAP Queue 1 item 7.

Serving MoE is the reference's dense all-expert combine
(``_dense_moe_combine``): every expert runs on the step's tokens and each
token sums its top-k experts' outputs; the top-k is the training gate's
(``moe/sharded_moe.py``: float64 softmax rounded once, a stable sort).

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
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.llama_decode import _mlp, _qkv, _rms
from deepspeed_tpu_torch.models.llama import (LlamaConfig, rope_freqs,
                                              softcap_logits)
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoEConfig
from deepspeed_tpu_torch.moe.sharded_moe import gate_probs

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


def serve_route(logits, top_k: int, norm_topk_prob: bool = True):
    """fp32 router logits [T, E] -> (the top-k experts [T, K], their
    weights [T, K]): the training gate's probabilities and order."""
    probs = gate_probs(logits)
    topi = torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[:, :top_k]
    w = probs.gather(1, topi)
    if norm_topk_prob:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    return topi, w


def _dense_moe_combine(moe, h2, top_k, dtype, norm_topk_prob=True):
    """Dense all-expert compute + top-k combine (serving-side MoE, the
    training dispatch when no token drops). With ``norm_topk_prob`` the
    kept probs are renormalized to sum to 1 (GShard/Mixtral); HF Qwen2-MoE
    runs with it off."""
    topi, w = serve_route(h2.float() @ moe["gate"]["wg"]["kernel"].float(),
                          top_k, norm_topk_prob)
    ex = moe["experts"]
    g = torch.einsum("td,edf->etf", h2, ex["w_gate"].to(dtype))
    u = torch.einsum("td,edf->etf", h2, ex["w_up"].to(dtype))
    eo = torch.einsum("etf,efd->etd", F.silu(g) * u,
                      ex["w_down"].to(dtype))                  # [E, T, D]
    t_idx = torch.arange(h2.shape[0], device=h2.device)[:, None]
    picked = eo[topi, t_idx]                                   # [T, K, D]
    return torch.einsum("tk,tkd->td", w.to(dtype), picked)


class _MoEPolicy:
    """Llama attention over the MoE tree (``params["model"]["layer_{i}"]``)
    and the dense MoE combine; ``mlp`` adds a family's extra terms."""

    @staticmethod
    def cache_spec(cfg) -> KVCacheSpec:
        b = cfg.base
        return KVCacheSpec(b.num_layers, b.num_kv_heads, b.head_dim_,
                           b.max_seq_len, b.dtype, b.sliding_window)

    @staticmethod
    def embed(params, tokens, positions, cfg):
        return params["model"]["embed"]["embedding"].to(cfg.base.dtype)[tokens]

    @classmethod
    def block(cls, params, i, x, attend, positions, cfg):
        base = cfg.base
        dtype = base.dtype
        lp = params["model"][f"layer_{i}"]
        cos, sin = _rope_tables(base.head_dim_, base.max_seq_len,
                                base.rope_theta, x.device)
        h = _rms(x, lp["attn_norm"]["scale"], base.rms_norm_eps)
        q, k, v = _qkv(lp, h, dtype)
        q = _rope_rows(q, cos, sin, positions)
        k = _rope_rows(k, cos, sin, positions)
        attn = attend(q, k, v)
        x = x + torch.einsum("thk,hkd->td", attn,
                             lp["attn"]["wo"]["kernel"].to(dtype))
        h2 = _rms(x, lp["mlp_norm"]["scale"], base.rms_norm_eps)
        return cls.mlp(lp, x, h2, cfg)

    @staticmethod
    def mlp(lp, x, h2, cfg):
        return x + _dense_moe_combine(lp["moe"], h2, cfg.moe.top_k,
                                      cfg.base.dtype, cfg.moe.norm_topk_prob)

    @staticmethod
    def unembed(params, x, cfg):
        x = _rms(x, params["model"]["final_norm"]["scale"],
                 cfg.base.rms_norm_eps)
        return x.float() @ params["model"]["lm_head"]["kernel"].float()


@register_policy("mixtral", MixtralConfig)
class MixtralPolicy(_MoEPolicy):
    """reference: model_implementations/mixtral. Serving MoE runs every
    expert densely on the (small) token batch and combines the top-k gate
    weights: the training dispatch when no token is dropped."""


@register_policy("qwen2_moe", Qwen2MoEConfig)
class Qwen2MoEPolicy(_MoEPolicy):
    """reference: model_implementations/qwen_v2_moe — Mixtral serving plus
    a dense shared expert whose output is scaled by a per-token sigmoid
    gate."""

    @staticmethod
    def mlp(lp, x, h2, cfg):
        dtype = cfg.base.dtype
        moe_out = _dense_moe_combine(lp["moe"], h2, cfg.moe.top_k, dtype,
                                     cfg.moe.norm_topk_prob)
        se = lp["shared_expert"]
        g = F.silu(h2 @ se["w_gate"]["kernel"].to(dtype))
        u = h2 @ se["w_up"]["kernel"].to(dtype)
        shared = (g * u) @ se["w_down"]["kernel"].to(dtype)
        gate = torch.sigmoid((h2 @ se["gate"]["kernel"].to(dtype)).float())
        return x + moe_out + shared * gate.to(dtype)
