"""Qwen2-MoE causal LM (Mixtral-style experts + a gated shared expert).

Port of ``deepspeed_tpu/models/qwen2_moe.py``: ``Qwen2MoEConfig`` (its
defaults are Qwen1.5-MoE-A2.7B: 24 layers, 60 experts, top-4 without
renormalization, a shared expert of 5632), ``TINY_QWEN2_MOE``,
``_SharedExpert`` (a dense SwiGLU over every token scaled by a per-token
sigmoid gate), ``Qwen2MoEBlock`` (qwen2 attention with q/k/v biases, the
MoE layer at ``moe_intermediate_size`` and the shared expert, both on the
same normed input) and ``Qwen2MoEForCausalLM``; ``qwen2_moe_tensor_rules``
(on a ``tensor`` axis the shared expert is column/row-parallel, as
``models/llama.py``'s MLP), ``qwen2_moe_config_from_hf`` and
``convert_hf_qwen2_moe``.
"""

import dataclasses

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.models.llama import (Dense, LlamaConfig,
                                              llama_tensor_rules, parallel_mlp)
from deepspeed_tpu_torch.models.mixtral import MixtralBlock, MoECausalLM
from deepspeed_tpu_torch.moe.sharded_moe import MoEConfig, moe_tensor_rules


@dataclasses.dataclass(frozen=True)
class Qwen2MoEConfig:
    base: LlamaConfig = LlamaConfig(
        vocab_size=151936, hidden_size=2048, intermediate_size=5632,
        num_layers=24, num_heads=16, num_kv_heads=16, attention_bias=True,
        rope_theta=1000000.0)
    # norm_topk_prob=False: HF Qwen2MoeConfig defaults it off for
    # Qwen1.5-MoE — combine weights are the raw softmax top-k probs
    moe: MoEConfig = MoEConfig(num_experts=60, top_k=4, norm_topk_prob=False)
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632


TINY_QWEN2_MOE = Qwen2MoEConfig(
    base=LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                     num_layers=2, num_heads=4, num_kv_heads=4,
                     attention_bias=True, max_seq_len=128),
    moe=MoEConfig(num_experts=4, top_k=2, norm_topk_prob=False,
                  dtype=torch.bfloat16),
    moe_intermediate_size=32,
    shared_expert_intermediate_size=128,
)


class _SharedExpert(nn.Module):
    """Dense SwiGLU MLP over all tokens, its output scaled by a per-token
    sigmoid gate (HF Qwen2MoeSparseMoeBlock.shared_expert[_gate])."""

    def __init__(self, cfg: Qwen2MoEConfig, device):
        super().__init__()
        d, f = cfg.base.hidden_size, cfg.shared_expert_intermediate_size
        self.dtype = cfg.base.dtype
        self.w_gate = Dense((d, f), 1, False, device)
        self.w_up = Dense((d, f), 1, False, device)
        self.w_down = Dense((f, d), 1, False, device)
        self.gate = Dense((d, 1), 1, False, device)
        self.intermediate = f

    def forward(self, x, compute_dtype=None):
        dt = self.dtype
        out = parallel_mlp(self, x, dt, compute_dtype, "silu",
                           self.intermediate)
        gate = self.gate(x, dt, compute_dtype)
        return out * torch.sigmoid(gate.float()).to(out.dtype)


class Qwen2MoEBlock(MixtralBlock):
    def __init__(self, cfg: Qwen2MoEConfig, device):
        super().__init__(cfg, device)
        self.shared_expert = _SharedExpert(cfg, device)

    @staticmethod
    def moe_intermediate(cfg) -> int:
        return cfg.moe_intermediate_size

    def forward(self, x, positions, rope, compute_dtype=None,
                train: bool = True, noise=None):
        h = self.attend(x, positions, None, rope, compute_dtype)
        inp = self.mlp_norm(h, compute_dtype)
        moe_out, aux = self.moe(inp, train, compute_dtype, noise)
        return h + moe_out + self.shared_expert(inp, compute_dtype), aux


def qwen2_moe_tensor_rules(path, leaf):
    """Expert rules + qwen2 attention/MLP rules (JAX
    ``qwen2_moe_tensor_rules``). The shared expert's w_gate/w_up/w_down
    fall through to llama's MLP substring rules (column/column/row); its
    scalar sigmoid gate matches nothing and replicates."""
    spec = moe_tensor_rules(path, leaf)
    if spec is not None:
        return spec
    return llama_tensor_rules(path, leaf)


class Qwen2MoEForCausalLM(MoECausalLM):
    """batch {"input_ids": [B,S]} -> LM loss + weighted MoE aux losses."""
    block_cls = Qwen2MoEBlock
    #: the Megatron rules of this model
    tensor_rules = staticmethod(qwen2_moe_tensor_rules)


# ---------------------------------------------------------------------------
# HF interop
# ---------------------------------------------------------------------------
def qwen2_moe_config_from_hf(hf: dict) -> Qwen2MoEConfig:
    """A Qwen2MoEConfig from an HF ``Qwen2MoeConfig`` dict. Only the
    uniformly sparse layout (``decoder_sparse_step=1``, no
    ``mlp_only_layers``)."""
    if hf.get("decoder_sparse_step", 1) != 1 or hf.get("mlp_only_layers"):
        raise ValueError("only uniformly sparse Qwen2-MoE layouts are "
                         "supported (decoder_sparse_step=1, no "
                         "mlp_only_layers)")
    base = LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf.get("intermediate_size", 4 * hf["hidden_size"]),
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads",
                            hf["num_attention_heads"]),
        max_seq_len=hf.get("max_position_embeddings", 4096),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        attention_bias=True,
    )
    moe = MoEConfig(
        num_experts=hf["num_experts"],
        top_k=hf.get("num_experts_per_tok", 4),
        norm_topk_prob=hf.get("norm_topk_prob", False),
        aux_loss_weight=hf.get("router_aux_loss_coef", 0.001),
    )
    return Qwen2MoEConfig(
        base=base, moe=moe,
        moe_intermediate_size=hf.get("moe_intermediate_size", 1408),
        shared_expert_intermediate_size=hf.get(
            "shared_expert_intermediate_size", 5632))


def convert_hf_qwen2_moe(hf_state, cfg: Qwen2MoEConfig):
    """An HF Qwen2Moe state dict -> the flax-layout tree (numpy; stacked
    expert weights [E, ...])."""
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
        attn = attn_tree_from_weights(
            get(p + "self_attn.q_proj.weight"),
            get(p + "self_attn.k_proj.weight"),
            get(p + "self_attn.v_proj.weight"),
            get(p + "self_attn.o_proj.weight"),
            d, h, hkv, dh,
            bq=get(p + "self_attn.q_proj.bias"),
            bk=get(p + "self_attn.k_proj.bias"),
            bv=get(p + "self_attn.v_proj.bias"))
        experts = {
            name: np.stack([_t(get(p + f"mlp.experts.{j}.{hf}.weight"))
                            for j in range(e)])
            for name, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj"))}
        se = p + "mlp.shared_expert."
        tree[f"layer_{i}"] = {
            "attn_norm": {"scale": get(p + "input_layernorm.weight")},
            "mlp_norm": {"scale": get(p + "post_attention_layernorm.weight")},
            "attn": attn,
            "moe": {"gate": {"wg": {"kernel": _t(get(p + "mlp.gate.weight"))}},
                    "experts": experts},
            "shared_expert": {
                "w_gate": {"kernel": _t(get(se + "gate_proj.weight"))},
                "w_up": {"kernel": _t(get(se + "up_proj.weight"))},
                "w_down": {"kernel": _t(get(se + "down_proj.weight"))},
                "gate": {"kernel":
                         _t(get(p + "mlp.shared_expert_gate.weight"))},
            },
        }
    return tree
