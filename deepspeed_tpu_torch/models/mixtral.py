"""Mixtral-style MoE causal LM.

Port of ``deepspeed_tpu/models/mixtral.py``: ``MixtralConfig`` (a
``LlamaConfig`` base and a ``MoEConfig``), ``TINY_MIXTRAL``,
``MIXTRAL_8X7B`` (Mistral AI's published config), ``MixtralBlock`` (the
Llama attention half, ``AttentionBlock``, with an ``MOELayer`` for its MLP)
and ``MixtralForCausalLM``, whose ``forward(batch, compute_dtype=)`` is
the LM loss plus every layer's aux and z losses and whose ``logits(batch)``
runs the gating at eval capacity. The head is fp32, as the reference's
``lm_head`` (a ``Dense`` with ``dtype=float32``). Parameters are fp32
masters named as the flax tree (``layer_0.moe.experts.w_gate [E, D, F]``,
``lm_head.kernel``; no ``model`` level), so ``models/convert.py``'s
``load_flax_params`` fills them. ``cfg.base.remat`` checkpoints each block
as ``LlamaModel`` does (the reference's Mixtral keeps every activation;
the values are the same).

``mixtral_tensor_rules`` compose the expert rules with Llama's
(``llama_tensor_rules``): on a ``tensor`` axis the attention, the
embedding and the head run on this rank's blocks as ``models/llama.py``
says. The MoE layer's tokens are the same on every tensor rank, so every
tensor rank gates the same tokens and the expert exchange stays on
``expert`` alone. ``mixtral_config_from_hf`` and
``convert_hf_mixtral`` map an HF Mixtral config and state dict (the
latter to the flax-layout numpy tree).
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.llama import (REMAT_POLICIES, AttentionBlock,
                                              Embed, LlamaConfig,
                                              LlamaForCausalLM, LMHead,
                                              RMSNorm, _cast,
                                              llama_tensor_rules, rope_freqs,
                                              tensor_parallel_heads)
from deepspeed_tpu_torch.module_inject.layers import (block_of,
                                                    copy_to_tensor,
                                                    gather_from_tensor,
                                                    leaf_shape, tensor_world,
                                                    vocab_parallel_lookup)
from deepspeed_tpu_torch.moe.sharded_moe import (MOELayer, MoEConfig,
                                                 moe_tensor_rules,
                                                 rsample_noise)
from deepspeed_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    base: LlamaConfig = LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8)
    moe: MoEConfig = MoEConfig(num_experts=8, top_k=2)


TINY_MIXTRAL = MixtralConfig(
    base=LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                     num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128),
    moe=MoEConfig(num_experts=4, top_k=2, dtype=torch.bfloat16))

MIXTRAL_8X7B = MixtralConfig(
    base=LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                     num_layers=32, num_heads=32, num_kv_heads=8,
                     rope_theta=1000000.0),
    moe=MoEConfig(num_experts=8, top_k=2))


class MixtralBlock(AttentionBlock):
    def __init__(self, cfg: MixtralConfig, device):
        super().__init__(cfg.base, device)
        self.moe = MOELayer(cfg.moe, cfg.base.hidden_size,
                            self.moe_intermediate(cfg), device)

    @staticmethod
    def moe_intermediate(cfg) -> int:
        return cfg.base.intermediate_size

    def forward(self, x, positions, rope, compute_dtype=None,
                train: bool = True, noise=None):
        h = self.attend(x, positions, None, rope, compute_dtype)
        out, aux = self.moe(self.mlp_norm(h, compute_dtype), train,
                            compute_dtype, noise)
        return h + out, aux


class MoECausalLM(nn.Module):
    """embed -> MoE blocks -> final norm -> fp32 head; batch {"input_ids":
    [B, S]} -> LM loss + the layers' weighted aux losses. Parameters are
    made on ``device`` (the card unless the caller asks for the CPU) and
    drawn from ``seed``."""

    block_cls = MixtralBlock

    def __init__(self, cfg, device=None, seed: int = 0):
        super().__init__()
        base = cfg.base
        if base.scan_layers:
            raise NotImplementedError(
                "scan_layers (the scanned-layer tree) is not ported yet "
                "(ROADMAP Queue 1)")
        if base.remat and base.remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat_policy {base.remat_policy!r} is not ported; known: "
                f"{sorted(REMAT_POLICIES)}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = Embed(base.vocab_size, base.hidden_size, dev)
        for i in range(base.num_layers):
            self.add_module(f"layer_{i}", self.block_cls(cfg, dev))
        self.final_norm = RMSNorm(base.hidden_size, base.rms_norm_eps,
                                  False, dev)
        self.lm_head = LMHead(base.hidden_size, base.vocab_size, dev)
        cos, sin = rope_freqs(base.head_dim_, base.max_seq_len,
                              base.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(dev),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(dev),
                             persistent=False)
        self.reset_parameters(seed)

    @property
    def config(self):
        return self.cfg

    def check_tensor_parallel(self, tp: int) -> None:
        """Raises unless the attention splits over ``tp`` tensor ranks."""
        tensor_parallel_heads(self.cfg.base, tp)

    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.base.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded weights made where they lie: kernels normal with std
        ``1/sqrt(fan_in)`` (an expert stack's fan-in is its dim 1), the
        embedding with std ``1/sqrt(hidden)``, biases zero, norm scales
        one."""
        gen = torch.Generator(device=self.embed.embedding.device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm.scale"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                fan_in = p.shape[-1] if name.endswith("embedding") else \
                    math.prod(p.shape[:2]) if name.endswith("wo.kernel") else \
                    p.shape[1] if p.dim() == 3 and ".experts." in name else \
                    p.shape[0]
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)

    def _noise(self, tokens: int, train: bool, generator):
        moe = self.cfg.moe
        if not (train and moe.noisy_gate_policy == "RSample"
                and generator is not None):
            return [None] * self.cfg.base.num_layers
        dev = self.embed.embedding.device
        return [rsample_noise((tokens, moe.num_experts), generator, dev)
                for _ in range(self.cfg.base.num_layers)]

    # -- the entry points of a layer-group stream (``runtime/param_offload.py``
    # runs them group by group; ``backbone`` runs them over the whole model) --
    def table(self, compute_dtype=None) -> torch.Tensor:
        """The embedding as the lookup reads it."""
        return _cast(self.embed.embedding, compute_dtype).to(
            self.cfg.base.dtype)

    def embed_tokens(self, input_ids, table) -> torch.Tensor:
        """token ids [B, S] -> x [B, S, D]; vocab-parallel where ``table``
        is this rank's block."""
        return vocab_parallel_lookup(table, input_ids.long(),
                                     self.cfg.base.vocab_size)

    def run_blocks(self, blocks, x, positions, compute_dtype=None,
                   train: bool = True, noise=None):
        """``blocks`` in order, each under the config's remat: (x, the sum
        of their aux losses), which the stream carries a group at a time
        (the reference's ``_MoEBlockStack``)."""
        base = self.cfg.base
        rope = (self.rope_cos, self.rope_sin)
        aux_total = torch.zeros((), device=x.device)
        for block, nz in zip(blocks, noise or [None] * len(blocks)):
            if base.remat and torch.is_grad_enabled():
                ctx = REMAT_POLICIES[base.remat_policy]
                kw = {"context_fn": ctx} if ctx is not None else {}
                x, aux = checkpoint(block, x, positions, rope, compute_dtype,
                                    train, nz, use_reentrant=False, **kw)
            else:
                x, aux = block(x, positions, rope, compute_dtype, train, nz)
            aux_total = aux_total + aux
        return x, aux_total

    def head(self, x, compute_dtype=None) -> torch.Tensor:
        """final norm -> the fp32 head: this rank's block of the vocabulary
        where the head is vocab-parallel."""
        x = self.final_norm(x, compute_dtype)
        if self.vocab_sharded():
            x = copy_to_tensor(x)
        return self.lm_head(x, torch.float32, compute_dtype)

    def backbone(self, input_ids, train: bool = True, compute_dtype=None,
                 generator: Optional[torch.Generator] = None):
        """(fp32 logits [B, S, V], summed aux losses). RSample's noise is
        drawn here, before any block, so a remat recompute reuses it."""
        ids = input_ids.long()
        positions = torch.arange(ids.shape[1], device=ids.device).expand_as(ids)
        x = self.embed_tokens(ids, self.table(compute_dtype))
        noise = self._noise(ids.numel(), train, generator)
        x, aux_total = self.run_blocks(self.layers(), x, positions,
                                       compute_dtype, train, noise)
        return self.head(x, compute_dtype), aux_total

    def vocab_sharded(self) -> bool:
        """Whether the head holds this rank's block of the vocabulary."""
        return tensor_world() > 1 and block_of(
            self.cfg.base.vocab_size, leaf_shape(self.lm_head, "kernel")[-1],
            "the head")

    def logits(self, batch, compute_dtype=None):
        """fp32 logits [B, S, V], the vocabulary gathered over ``tensor``
        where the head is vocab-parallel."""
        logits = self.backbone(batch["input_ids"], train=False,
                               compute_dtype=compute_dtype)[0]
        return gather_from_tensor(logits, dim=-1) if self.vocab_sharded() \
            else logits

    def forward(self, batch, compute_dtype=None,
                generator: Optional[torch.Generator] = None):
        logits, aux_total = self.backbone(batch["input_ids"], True,
                                          compute_dtype, generator)
        return LlamaForCausalLM.loss_of(logits, batch,
                                        self.vocab_sharded()) + aux_total


def mixtral_tensor_rules(path, leaf):
    """Compose attention TP rules with expert-parallel rules (JAX
    ``mixtral_tensor_rules``): the expert rules, then Llama's."""
    spec = moe_tensor_rules(path, leaf)
    if spec is not None:
        return spec
    return llama_tensor_rules(path, leaf)


class MixtralForCausalLM(MoECausalLM):
    """batch {"input_ids": [B,S]} -> LM loss + weighted MoE aux losses."""
    block_cls = MixtralBlock
    #: the Megatron rules of this model
    tensor_rules = staticmethod(mixtral_tensor_rules)


# ---------------------------------------------------------------------------
# HF interop
# ---------------------------------------------------------------------------
def mixtral_config_from_hf(hf: dict) -> MixtralConfig:
    """A MixtralConfig from an HF ``MixtralConfig`` dict. HF Mixtral
    renormalizes the kept top-k routing weights (``norm_topk_prob=True``)
    and has no router z-loss."""
    mt = hf.get("model_type", "mixtral")
    if mt != "mixtral" or "num_local_experts" not in hf:
        raise ValueError(f"not a Mixtral config (model_type={mt!r}); dense "
                         "llama-family archs go through families."
                         "config_from_hf")
    base = LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads",
                            hf["num_attention_heads"]),
        max_seq_len=hf.get("max_position_embeddings", 4096),
        rope_theta=hf.get("rope_theta", 1e6),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        sliding_window=hf.get("sliding_window"),
        head_dim=hf.get("head_dim"),
    )
    moe = MoEConfig(
        num_experts=hf["num_local_experts"],
        top_k=hf.get("num_experts_per_tok", 2),
        aux_loss_weight=hf.get("router_aux_loss_coef", 0.001),
        router_z_loss_weight=0.0,
    )
    return MixtralConfig(base=base, moe=moe)


def convert_hf_mixtral(hf_state, cfg: MixtralConfig):
    """An HF Mixtral state dict -> the flax-layout tree (numpy). HF expert
    naming: ``block_sparse_moe.experts.{e}.w1`` (gate, [I, D]), ``w2``
    (down, [D, I]), ``w3`` (up, [I, D]); router ``block_sparse_moe.gate``
    [E, D]."""
    from deepspeed_tpu_torch.models.families import (_t,
                                                     attn_tree_from_weights,
                                                     hf_get)

    def get(name):
        return hf_get(hf_state, name)

    base = cfg.base
    d, h, hkv, dh = (base.hidden_size, base.num_heads, base.num_kv_heads,
                     base.head_dim_)
    e = cfg.moe.num_experts
    tree = {"embed": {"embedding": get("model.embed_tokens.weight")},
            "final_norm": {"scale": get("model.norm.weight")},
            "lm_head": {"kernel": _t(get("lm_head.weight"))}}
    for i in range(base.num_layers):
        p = f"model.layers.{i}."
        ep = p + "block_sparse_moe.experts."
        tree[f"layer_{i}"] = {
            "attn_norm": {"scale": get(p + "input_layernorm.weight")},
            "mlp_norm": {"scale": get(p + "post_attention_layernorm.weight")},
            "attn": attn_tree_from_weights(
                get(p + "self_attn.q_proj.weight"),
                get(p + "self_attn.k_proj.weight"),
                get(p + "self_attn.v_proj.weight"),
                get(p + "self_attn.o_proj.weight"), d, h, hkv, dh),
            "moe": {
                "gate": {"wg": {"kernel":
                                _t(get(p + "block_sparse_moe.gate.weight"))}},
                "experts": {
                    "w_gate": np.stack([_t(get(f"{ep}{j}.w1.weight"))
                                        for j in range(e)]),
                    "w_up": np.stack([_t(get(f"{ep}{j}.w3.weight"))
                                      for j in range(e)]),
                    "w_down": np.stack([_t(get(f"{ep}{j}.w2.weight"))
                                        for j in range(e)]),
                },
            },
        }
    return tree
