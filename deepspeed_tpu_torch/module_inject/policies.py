"""Tensor-parallel injection policies.

Port of ``deepspeed_tpu/module_inject/policies.py`` (reference
``deepspeed/module_inject/replace_policy.py`` and the per-arch containers
``module_inject/containers/``): each policy says which sub-layers are
column-parallel (qkv/up projections), which are row-parallel
(output/down projections) and which hold a fused QKV. A policy compiles
to a ``tensor_rules(path, leaf) -> spec | None`` function, the contract
``runtime/zero/partition.py::build_param_specs``, the training engine
and ``inference/engine.py`` consume; the spec is the port's tuple (one
entry a dimension, ``None`` or an axis name).

``path`` is a parameter name, dotted as ``named_parameters`` gives it or
with slashes, or a sequence of keys (strings, or objects with a ``key``
or ``idx``, as a JAX tree path); it is matched as the ``/``-joined path,
so the patterns are the JAX package's. ``leaf`` is a tensor, an array or
a shape.
"""

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

TENSOR_AXIS = "tensor"


def path_name(path) -> str:
    """The ``/``-joined name of a parameter path (see the module)."""
    if isinstance(path, str):
        return path.replace(".", "/")
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def leaf_ndim(leaf) -> int:
    """The rank of a tensor, an array or a shape."""
    if isinstance(leaf, (tuple, list, torch.Size)):
        return len(leaf)
    if hasattr(leaf, "shape"):
        return len(leaf.shape)
    return int(np.ndim(leaf))


@dataclasses.dataclass(frozen=True)
class TPPolicy:
    """Name-pattern driven TP sharding policy for one model architecture.

    Patterns are substrings matched against the '/'-joined parameter path.
    ``column``: shard the output (last) dim; ``row``: shard the input (first) dim;
    ``vocab_in``: embedding tables [vocab, embed] sharded on dim 0;
    ``vocab_out``: lm-head kernels [embed, vocab] sharded on the last dim;
    ``fused_qkv``: column-parallel fused QKV weights — need
    ``fusedqkv_utils.split_fused_qkv`` at weight-load time when head counts differ
    (GQA), sharded on the last dim like any column layer.
    """

    arch: str
    column: Tuple[str, ...] = ()
    row: Tuple[str, ...] = ()
    vocab_in: Tuple[str, ...] = ("embed_tokens", "word_embeddings", "wte", "embed/embedding")
    vocab_out: Tuple[str, ...] = ("lm_head", "embed_out")
    fused_qkv: Tuple[str, ...] = ()

    def tensor_rules(self) -> Callable:
        """Compile to the ``tensor_rules(path, leaf)`` contract."""

        def rules(path, leaf) -> Optional[Tuple]:
            name = path_name(path)
            ndim = leaf_ndim(leaf)
            if ndim == 0:
                return None
            if any(p in name for p in self.fused_qkv) or \
                    any(p in name for p in self.column):
                if ndim == 1:  # bias of a column layer: sharded with the outputs
                    return (TENSOR_AXIS,)
                return (*([None] * (ndim - 1)), TENSOR_AXIS)
            if any(p in name for p in self.row):
                if ndim == 1:  # bias of a row layer: added post-reduce, replicated
                    return None
                return (TENSOR_AXIS, *([None] * (ndim - 1)))
            if any(p in name for p in self.vocab_in) and ndim >= 2:
                return (TENSOR_AXIS, *([None] * (ndim - 1)))
            if any(p in name for p in self.vocab_out) and ndim >= 2:
                return (*([None] * (ndim - 1)), TENSOR_AXIS)
            return None

        return rules


# ---------------------------------------------------------------------------
# Registry (reference: replace_policy.py replace_policies list + containers/)
# Patterns include both HF module names and our native model zoo's names.
# ---------------------------------------------------------------------------

_LLAMA_LIKE = dict(
    column=("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
            "wq/", "wk/", "wv/", "w_gate", "w_up"),
    row=("o_proj", "down_proj", "wo/", "w_down"),
)

POLICIES = {
    "llama": TPPolicy("llama", **_LLAMA_LIKE),
    "mistral": TPPolicy("mistral", **_LLAMA_LIKE),
    "internlm": TPPolicy("internlm", **_LLAMA_LIKE),
    "baichuan": TPPolicy("baichuan", fused_qkv=("W_pack",), **_LLAMA_LIKE),
    "qwen2": TPPolicy("qwen2", **_LLAMA_LIKE),
    "mixtral": TPPolicy(
        "mixtral",
        column=_LLAMA_LIKE["column"] + ("w1/", "w3/", "experts/wi"),
        row=_LLAMA_LIKE["row"] + ("w2/", "experts/wo")),
    "qwen2_moe": TPPolicy(
        "qwen2_moe",
        column=_LLAMA_LIKE["column"] + ("w1/", "w3/", "experts/wi", "shared_expert"),
        row=_LLAMA_LIKE["row"] + ("w2/", "experts/wo")),
    "phi": TPPolicy(
        "phi",
        column=("q_proj", "k_proj", "v_proj", "fc1"),
        row=("dense", "fc2")),
    "phi3": TPPolicy(
        "phi3",
        column=("gate_up_proj",),
        row=("o_proj", "down_proj"),
        fused_qkv=("qkv_proj",)),
    "falcon": TPPolicy(
        "falcon",
        column=("dense_h_to_4h",),
        row=("self_attention/dense", "dense_4h_to_h"),
        fused_qkv=("query_key_value",)),
    "gpt_neox": TPPolicy(
        "gpt_neox",
        column=("dense_h_to_4h",),
        row=("attention/dense", "dense_4h_to_h"),
        fused_qkv=("query_key_value",)),
    "bloom": TPPolicy(
        "bloom",
        column=("dense_h_to_4h",),
        row=("self_attention/dense", "dense_4h_to_h"),
        fused_qkv=("query_key_value",)),
    "gpt2": TPPolicy(
        "gpt2",
        column=("c_fc",),
        row=("attn/c_proj", "mlp/c_proj"),
        fused_qkv=("c_attn",)),
    "gptj": TPPolicy(
        "gptj",
        column=("q_proj", "k_proj", "v_proj", "fc_in"),
        row=("out_proj", "fc_out")),
    "opt": TPPolicy(
        "opt",
        column=("q_proj", "k_proj", "v_proj", "fc1"),
        row=("out_proj", "fc2")),
    "bert": TPPolicy(
        "bert",
        column=("query", "key", "value", "intermediate/dense"),
        row=("attention/output/dense", "output/dense")),
    "distilbert": TPPolicy(
        "distilbert",
        column=("q_lin", "k_lin", "v_lin", "lin1"),
        row=("out_lin", "lin2")),
    "gpt_neo": TPPolicy(
        "gpt_neo",
        column=("q_proj", "k_proj", "v_proj", "c_fc"),
        row=("out_proj", "c_proj")),
    "gpt_bigcode": TPPolicy(      # starcoder: MQA fused qkv
        "gpt_bigcode",
        column=("c_fc",),
        row=("attn/c_proj", "mlp/c_proj"),
        fused_qkv=("c_attn",)),
    "codegen": TPPolicy(
        "codegen",
        column=("fc_in",),
        row=("out_proj", "fc_out"),
        fused_qkv=("qkv_proj",)),
    "gemma": TPPolicy("gemma", **_LLAMA_LIKE),
    "stablelm": TPPolicy("stablelm", **_LLAMA_LIKE),
    "chatglm": TPPolicy(
        "chatglm",
        column=("dense_h_to_4h",),
        row=("self_attention/dense", "dense_4h_to_h"),
        fused_qkv=("query_key_value",)),
    "megatron_gpt": TPPolicy(
        "megatron_gpt",
        column=("dense_h_to_4h",),
        row=("attention/dense", "dense_4h_to_h"),
        fused_qkv=("query_key_value",)),
    "clip": TPPolicy(
        "clip",
        column=("q_proj", "k_proj", "v_proj", "fc1"),
        row=("out_proj", "fc2")),
    "t5": TPPolicy(
        "t5",
        # scoped patterns: bare "k/" would false-match "block/0"
        column=("SelfAttention/q", "SelfAttention/k", "SelfAttention/v",
                "EncDecAttention/q", "EncDecAttention/k", "EncDecAttention/v",
                "DenseReluDense/wi"),
        row=("SelfAttention/o", "EncDecAttention/o", "DenseReluDense/wo"),
        vocab_in=("shared/", "embed_tokens"),
        vocab_out=("lm_head",)),
    "whisper": TPPolicy(
        "whisper",
        column=("q_proj", "k_proj", "v_proj", "fc1"),
        row=("out_proj", "fc2")),
    # diffusers UNet2DConditionModel (reference containers/unet.py): only the
    # cross/self-attention projections and GEGLU net shard; convs replicate
    "unet": TPPolicy(
        "unet",
        column=("to_q", "to_k", "to_v", "ff/net_0/proj", "net/0/proj"),
        row=("to_out/0", "to_out_0", "ff/net_2", "net/2"),
        vocab_in=(), vocab_out=()),
    # diffusers AutoencoderKL (reference containers/vae.py): attention block
    # projections shard, conv encoder/decoder replicates
    "vae": TPPolicy(
        "vae",
        column=("to_q", "to_k", "to_v", "attention/query", "attention/key",
                "attention/value"),
        row=("to_out/0", "attention/proj_attn"),
        vocab_in=(), vocab_out=()),
}

# aliases: HF model_type / class-name spellings -> canonical key
_ALIASES = {
    "llamaforcausallm": "llama", "llamamodel": "llama",
    "mistralforcausallm": "mistral",
    "mixtralforcausallm": "mixtral",
    "qwen2forcausallm": "qwen2",
    "qwen2moeforcausallm": "qwen2_moe",
    "phiforcausallm": "phi", "phi3forcausallm": "phi3",
    "falconforcausallm": "falcon", "rwforcausallm": "falcon",
    "gptneoxforcausallm": "gpt_neox",
    "bloomforcausallm": "bloom",
    "gpt2lmheadmodel": "gpt2",
    "gptjforcausallm": "gptj",
    "optforcausallm": "opt",
    "bertmodel": "bert", "bertforsequenceclassification": "bert",
    "distilbertmodel": "distilbert",
    "gptneoforcausallm": "gpt_neo",
    "gptbigcodeforcausallm": "gpt_bigcode", "starcoder": "gpt_bigcode",
    "codegenforcausallm": "codegen",
    "gemmaforcausallm": "gemma", "gemma2forcausallm": "gemma",
    "stablelmforcausallm": "stablelm",
    "chatglmforconditionalgeneration": "chatglm", "glm": "chatglm",
    "megatrongptmodel": "megatron_gpt", "megatron": "megatron_gpt",
    "clipmodel": "clip", "cliptextmodel": "clip", "clipvisionmodel": "clip",
    "t5forconditionalgeneration": "t5", "mt5forconditionalgeneration": "t5",
    "whisperforconditionalgeneration": "whisper",
    "unet2dconditionmodel": "unet",
    "autoencoderkl": "vae",
}


def get_policy(arch: str) -> Optional[TPPolicy]:
    """Look up by canonical name, HF ``model_type``, or model class name."""
    key = arch.lower().replace("-", "_")
    if key in POLICIES:
        return POLICIES[key]
    return POLICIES.get(_ALIASES.get(key.replace("_", ""), ""))
