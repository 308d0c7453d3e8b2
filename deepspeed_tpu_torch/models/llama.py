"""Llama-family causal LM: configuration, presets and the training model.

Port of ``deepspeed_tpu/models/llama.py``: ``LlamaConfig`` (with a torch
``dtype``), the public presets, ``rope_freqs``, ``softcap_logits``, and the
training model as ``nn.Module``s — ``RMSNorm``, ``apply_rope``, the plain
attention backend ``_xla_attention``, ``_dispatch_attention`` (``flash``
runs the CUDA flash kernels), ``LlamaAttention``, ``LlamaMLP``,
``AttentionBlock`` (the attention half the MoE blocks share),
``LlamaBlock``, ``LMHead``, ``LlamaModel`` and ``LlamaForCausalLM`` with
the dense next-token loss, plus ``random_tokens``.

Parameters are fp32 masters named and laid out as the flax tree
(``model.layer_0.attn.wq.kernel [D, H, hd]``, ``...wo.kernel [H, hd, D]``,
``model.lm_head.kernel [D, V]``; ``models/convert.py`` maps the two).
``forward(..., compute_dtype=)`` casts every floating parameter to the
compute dtype at its use, as the reference engine's ``cast_to_compute``
does before ``apply``, so gradients reach the fp32 masters through the
cast. Remat is ``torch.utils.checkpoint`` (non-reentrant) per block.
``LlamaModel``'s ``table``, ``embed_tokens``, ``run_blocks`` and ``head``
and ``LlamaForCausalLM.loss_of`` are the pieces the whole forward is made
of, and the entry points of the parameter tier's layer-group stream.

Not ported yet: the ``ulysses`` and ``ring`` backends (ROADMAP Queue 1,
sequence parallel), the chunked loss (``loss_chunk_size``, with
``sequence/cross_entropy.py``) and the scanned-layer tree
(``scan_layers``).
"""

import dataclasses
import functools
import math
from functools import lru_cache
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deepspeed_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    attention_backend: str = "xla"     # xla | flash (ulysses | ring: later)
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    scan_layers: bool = False           # not ported: raises when set
    logits_soft_cap: Optional[float] = None
    loss_chunk_size: Optional[int] = None   # not ported: raises when set
    # llama-family arch knobs (mistral/qwen2/phi3 are llama variants):
    attention_bias: bool = False          # qwen2: bias on q/k/v projections
    sliding_window: Optional[int] = None  # mistral: attend to last W tokens only
    # gemma-family knobs (gemma/gemma2 are llama variants too):
    hidden_act: str = "silu"              # gemma: "gelu_tanh" gated MLP
    rms_scale_offset: bool = False        # gemma norm: y * (1 + scale)
    scale_embeddings: bool = False        # gemma: embed output * sqrt(hidden)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


# Model presets (public architecture configs)
LLAMA3_8B = LlamaConfig(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                        num_layers=32, num_heads=32, num_kv_heads=8)
LLAMA2_7B = LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                        num_layers=32, num_heads=32, num_kv_heads=32, rope_theta=10000.0)
TINY_LLAMA = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                         num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256)


@lru_cache(maxsize=32)
def rope_freqs(head_dim: int, max_len: int, theta: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables [max_len, head_dim // 2] in float32, computed in numpy
    float64 exactly as the reference does, so the tables are bit-identical."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def softcap_logits(x, cap):
    """tanh soft-capping (gemma2): identity when cap is falsy."""
    return cap * torch.tanh(x / cap) if cap else x


# ---------------------------------------------------------------------------
# the training model
# ---------------------------------------------------------------------------
def _cast(t: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A master at its use: cast to the compute dtype when one is given."""
    return t if compute_dtype is None else t.to(compute_dtype)


def _dense(x: torch.Tensor, kernel: torch.Tensor, n_in: int,
           dtype: torch.dtype, bias: Optional[torch.Tensor] = None):
    """flax ``DenseGeneral`` with ``dtype``: contract the last ``n_in`` dims
    of ``x`` with the first ``n_in`` of ``kernel``, both in ``dtype``, as
    one 2-D ``mm`` (the weight products the remat policy saves)."""
    k_in = math.prod(kernel.shape[:n_in])
    out_shape = kernel.shape[n_in:]
    y = x.reshape(-1, k_in).to(dtype) @ kernel.to(dtype).reshape(k_in, -1)
    y = y.reshape(*x.shape[:x.dim() - n_in], *out_shape)
    return y + bias.to(dtype) if bias is not None else y


class Dense(nn.Module):
    """A ``kernel`` (+ optional ``bias``) parameter, named as in flax."""

    def __init__(self, shape: Tuple[int, ...], n_out: int, bias: bool,
                 device: torch.device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape, device=device))
        self.bias = nn.Parameter(torch.empty(shape[-n_out:], device=device)) \
            if bias else None
        self.n_in = len(shape) - n_out

    def forward(self, x, dtype, compute_dtype=None):
        bias = _cast(self.bias, compute_dtype) if self.bias is not None else None
        return _dense(x, _cast(self.kernel, compute_dtype), self.n_in, dtype,
                      bias)


class RMSNorm(nn.Module):
    """RMS norm computed in fp32 and cast back to the input dtype
    (reference ``models/llama.py:120``)."""

    def __init__(self, dim: int, eps: float = 1e-5, scale_offset: bool = False,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale_offset = scale_offset      # gemma: y * (1 + scale)
        self.scale = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x, compute_dtype=None):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        scale = _cast(self.scale, compute_dtype)
        if self.scale_offset:
            scale = scale + 1.0
        return (y * scale).to(x.dtype)


def apply_rope(x, cos, sin, positions):
    """x: [B, S, H, D]; positions: [B, S]; computed in fp32, cast back."""
    cos_p = cos[positions][:, :, None, :]
    sin_p = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p], dim=-1)
    return out.to(x.dtype)


def _xla_attention(q, k, v, causal: bool = True, segment_ids=None,
                   window=None, scale=None, softcap=None):
    """Plain attention (the reference's ``xla`` backend): scores in q's
    dtype widened to fp32, mask offset by ``Sk - Sq``, fp32 softmax, P cast
    to q's dtype before P.V."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (
        scale if scale is not None else 1.0 / np.sqrt(d))
    scores = softcap_logits(scores, softcap)
    sk = k.shape[1]
    if causal or window is not None:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = qpos >= kpos
        if window is not None:
            mask = mask & (kpos > qpos - window)
        scores = torch.where(mask[None, None], scores, -1e30)
    if segment_ids is not None:
        seg_mask = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = torch.where(seg_mask[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _dispatch_attention(backend: str, q, k, v, causal=True, segment_ids=None,
                        window=None):
    if window is not None and backend != "flash":
        return _xla_attention(q, k, v, causal, segment_ids, window=window)
    if backend == "xla":
        return _xla_attention(q, k, v, causal, segment_ids)
    if backend == "flash":
        from deepspeed_tpu_torch.ops.flash_attention import flash_attention_auto
        return flash_attention_auto(q, k, v, causal=causal, window=window,
                                    segment_ids=segment_ids)
    if backend in ("ulysses", "ring"):
        raise NotImplementedError(
            f"attention backend '{backend}' is not ported yet (ROADMAP "
            "Queue 1: sequence parallel); use 'flash' or 'xla'")
    raise ValueError(f"unknown attention backend '{backend}'")


def _save_ops(*ops):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


# the weight products (``_dense``) are 2-D mm/addmm; attention's are not
_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# remat policy -> checkpoint context_fn (None: save only the block input)
REMAT_POLICIES: Dict[str, Any] = {
    "nothing_saveable": None,
    "dots_with_no_batch_dims_saveable": _save_ops(*_MM),
}


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim_
        h, hkv, bias = cfg.num_heads, cfg.num_kv_heads, cfg.attention_bias
        self.wq = Dense((d, h, hd), 2, bias, device)
        self.wk = Dense((d, hkv, hd), 2, bias, device)
        self.wv = Dense((d, hkv, hd), 2, bias, device)
        self.wo = Dense((h, hd, d), 1, False, device)

    def forward(self, x, positions, segment_ids, rope, compute_dtype=None):
        cfg, dt = self.cfg, self.cfg.dtype
        q = self.wq(x, dt, compute_dtype)
        k = self.wk(x, dt, compute_dtype)
        v = self.wv(x, dt, compute_dtype)
        q = apply_rope(q, *rope, positions)
        k = apply_rope(k, *rope, positions)
        out = _dispatch_attention(cfg.attention_backend, q, k, v, causal=True,
                                  segment_ids=segment_ids,
                                  window=cfg.sliding_window)
        return self.wo(out, dt, compute_dtype)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        if cfg.hidden_act not in ("silu", "gelu_tanh"):
            raise ValueError(f"unsupported hidden_act {cfg.hidden_act!r} "
                             "(silu | gelu_tanh)")
        self.cfg = cfg
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.w_gate = Dense((d, f), 1, False, device)
        self.w_up = Dense((d, f), 1, False, device)
        self.w_down = Dense((f, d), 1, False, device)

    def forward(self, x, compute_dtype=None):
        dt = self.cfg.dtype
        gate = self.w_gate(x, dt, compute_dtype)
        up = self.w_up(x, dt, compute_dtype)
        act = F.silu(gate) if self.cfg.hidden_act == "silu" else \
            F.gelu(gate, approximate="tanh")
        return self.w_down(act * up, dt, compute_dtype)


class AttentionBlock(nn.Module):
    """A block's attention half and its MLP norm: ``attend`` gives
    ``x + attn(attn_norm(x))``; the subclass adds its MLP (``LlamaMLP``
    here, the MoE layer in ``models/mixtral.py``)."""

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        norm = functools.partial(RMSNorm, cfg.hidden_size, cfg.rms_norm_eps,
                                 cfg.rms_scale_offset, device)
        self.attn_norm = norm()
        self.attn = LlamaAttention(cfg, device)
        self.mlp_norm = norm()

    def attend(self, x, positions, segment_ids, rope, compute_dtype=None):
        return x + self.attn(self.attn_norm(x, compute_dtype), positions,
                             segment_ids, rope, compute_dtype)


class LlamaBlock(AttentionBlock):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__(cfg, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, positions, segment_ids, rope, compute_dtype=None):
        h = self.attend(x, positions, segment_ids, rope, compute_dtype)
        return h + self.mlp(self.mlp_norm(h, compute_dtype), compute_dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, device):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim, device=device))


class LMHead(nn.Module):
    """Unembedding ``kernel [D, V]``: bf16 x bf16 in the model dtype, so
    the training logits are rounded to it before the caller widens them."""

    def __init__(self, hidden_size: int, vocab_size: int, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(hidden_size, vocab_size,
                                               device=device))

    def forward(self, x, dtype, compute_dtype=None):
        return _dense(x, _cast(self.kernel, compute_dtype), 1, dtype)


class LlamaModel(nn.Module):
    """embed -> N blocks -> final norm -> head: token ids [B, S] -> fp32
    logits [B, S, V]."""

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        if cfg.scan_layers:
            raise NotImplementedError(
                "scan_layers (the scanned-layer tree) is not ported yet "
                "(ROADMAP Queue 1)")
        if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported; known: "
                f"{sorted(REMAT_POLICIES)}")
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.hidden_size, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", LlamaBlock(cfg, device))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  cfg.rms_scale_offset, device)
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg.hidden_size, cfg.vocab_size, device)
        cos, sin = rope_freqs(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(device),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(device),
                             persistent=False)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    # -- the entry points of a layer-group stream (``runtime/param_offload.py``
    # runs them group by group; ``forward`` runs them over the whole model) --
    def table(self, compute_dtype=None) -> torch.Tensor:
        """The embedding as the lookup (and a tied head) reads it."""
        return _cast(self.embed.embedding, compute_dtype).to(self.cfg.dtype)

    @staticmethod
    def positions_of(input_ids, positions=None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(input_ids.shape[1],
                                     device=input_ids.device).expand_as(input_ids)
        return positions.long()

    def embed_tokens(self, input_ids, table) -> torch.Tensor:
        """token ids [B, S] -> x [B, S, D] (gemma's normalizer applied)."""
        x = table[input_ids.long()]
        if self.cfg.scale_embeddings:     # gemma: normalizer on the embed output
            x = x * torch.tensor(math.sqrt(self.cfg.hidden_size)).to(x.dtype)
        return x

    def run_blocks(self, blocks, x, positions, segment_ids=None,
                   compute_dtype=None) -> torch.Tensor:
        """``blocks`` in order, each under the config's remat."""
        cfg = self.cfg
        rope = (self.rope_cos, self.rope_sin)
        for block in blocks:
            if cfg.remat and torch.is_grad_enabled():
                ctx = REMAT_POLICIES[cfg.remat_policy]
                kw = {"context_fn": ctx} if ctx is not None else {}
                x = checkpoint(block, x, positions, segment_ids, rope,
                               compute_dtype, use_reentrant=False, **kw)
            else:
                x = block(x, positions, segment_ids, rope, compute_dtype)
        return x

    def head(self, x, table=None, compute_dtype=None) -> torch.Tensor:
        """final norm -> unembed (the tied ``table`` or ``lm_head``) -> fp32
        logits, soft-capped."""
        cfg, dt = self.cfg, self.cfg.dtype
        x = self.final_norm(x, compute_dtype)
        if cfg.tie_embeddings:
            logits = x.to(dt) @ table.T
        else:
            logits = self.lm_head(x, dt, compute_dtype)
        logits = logits.float()
        return softcap_logits(logits, cfg.logits_soft_cap)

    def forward(self, input_ids, positions=None, segment_ids=None,
                compute_dtype=None):
        positions = self.positions_of(input_ids, positions)
        table = self.table(compute_dtype)
        x = self.embed_tokens(input_ids, table)
        x = self.run_blocks(self.layers(), x, positions, segment_ids,
                            compute_dtype)
        return self.head(x, table, compute_dtype)


class LlamaForCausalLM(nn.Module):
    """Training entry: batch dict {"input_ids": [B, S]} (+ optional
    "labels", "segment_ids", "positions", "loss_mask") -> mean next-token
    cross-entropy (fp32). Parameters are made on ``device`` (the card
    unless the caller asks for the CPU) and drawn from ``seed``."""

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.loss_chunk_size:
            raise NotImplementedError(
                "loss_chunk_size (the chunked loss of "
                "sequence/cross_entropy.py) is not ported yet (ROADMAP "
                "Queue 1); use the dense loss")
        self.cfg = cfg
        self.model = LlamaModel(cfg, resolve_device(device))
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded weights made where they lie: kernels normal with std
        ``1/sqrt(fan_in)``, the embedding with std ``1/sqrt(hidden)``,
        biases zero, norm scales one (zero with gemma's scale offset). The
        same seed on the same device gives the same weights."""
        dev = self.model.embed.embedding.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm.scale"):
                p.fill_(0.0 if self.cfg.rms_scale_offset else 1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                fan_in = p.shape[-1] if name.endswith("embedding") else \
                    math.prod(p.shape[:2]) if name.endswith("wo.kernel") else \
                    p.shape[0]
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)

    def logits(self, batch, compute_dtype=None):
        return self.model(batch["input_ids"], positions=batch.get("positions"),
                          segment_ids=batch.get("segment_ids"),
                          compute_dtype=compute_dtype)

    def forward(self, batch, compute_dtype=None):
        return self.loss_of(self.logits(batch, compute_dtype), batch)

    @staticmethod
    def loss_of(logits, batch):
        """The dense next-token loss of fp32 ``logits`` [B, S, V]."""
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
        if labels is None:
            labels = input_ids[:, 1:]
            logits = logits[:, :-1]
            mask = batch.get("loss_mask")
            mask = mask[:, 1:] if mask is not None else torch.ones_like(labels)
        else:
            mask = batch.get("loss_mask", torch.ones_like(labels))
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, labels.long()[..., None])[..., 0]
        mask = mask.float()
        return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def random_tokens(batch_size: int, seq_len: int, vocab_size: int = 512,
                  seed: int = 0, gas: Optional[int] = None):
    """Seeded token batch {"input_ids": int32 numpy}, [gas, B, S] or [B, S]
    (the reference's draws: the same seed gives the same tokens)."""
    rng = np.random.default_rng(seed)
    shape = (gas, batch_size, seq_len) if gas else (batch_size, seq_len)
    return {"input_ids": rng.integers(0, vocab_size, size=shape).astype(np.int32)}
