"""Automatic tensor parallelism.

Port of ``deepspeed_tpu/module_inject/auto_tp.py`` (reference
``deepspeed/module_inject/auto_tp.py:189``, ``AutoTP``): the classifier
runs over parameter names, as the JAX package's runs over its parameter
pytree. ``AutoTP.infer_rules`` resolves the per-arch policy from the
registry, else the generic name heuristics; anything unmatched stays
replicated.

A model of this package that carries its own Megatron rules (the
``tensor_rules`` of ``LlamaForCausalLM``, ``MixtralForCausalLM`` and
``Qwen2MoEForCausalLM``) resolves to them: the arch policy's column rule
cuts the last dimension of a ``[D, H, hd]`` projection, its head
dimension, which XLA reshards under the JAX package's GSPMD, while the
port's model runs whole heads on each rank (ROADMAP Queue 3).
"""

from typing import Any, Callable, Optional

from deepspeed_tpu_torch.module_inject.policies import (
    POLICIES,
    TENSOR_AXIS,
    TPPolicy,
    get_policy,
)
from deepspeed_tpu_torch.utils.logging import logger

# Generic fallback vocabulary (reference: auto_tp.py tp_parser's allreduce-name list,
# e.g. 'o_proj', 'out_proj', 'down_proj', 'dense_4h_to_h', 'attention.dense' ...)
GENERIC_POLICY = TPPolicy(
    "generic",
    column=("q_proj", "k_proj", "v_proj", "query", "key", "value",
            "gate_proj", "up_proj", "fc1", "fc_in", "dense_h_to_4h",
            "wq/", "wk/", "wv/", "w_gate", "w_up", "wi/", "col_"),
    row=("o_proj", "out_proj", "down_proj", "fc2", "fc_out", "dense_4h_to_h",
         "attention/dense", "self_attention/dense", "wo/", "w_down", "row_"),
    fused_qkv=("query_key_value", "qkv_proj", "c_attn", "W_pack"),
)


class AutoTP:
    """Policy resolution + generic fallback (reference: AutoTP auto_tp.py:189)."""

    @staticmethod
    def get_policy(model_or_arch) -> Optional[TPPolicy]:
        if isinstance(model_or_arch, str):
            return get_policy(model_or_arch)
        # a module / any object: try class name, then HF-style config.model_type
        pol = get_policy(type(model_or_arch).__name__)
        if pol is None:
            mt = getattr(getattr(model_or_arch, "config", None), "model_type", None)
            if isinstance(mt, str):
                pol = get_policy(mt)
        return pol

    @staticmethod
    def infer_rules(model_or_arch=None, params: Any = None) -> Callable:
        """Return a ``tensor_rules`` callable: the model's own Megatron
        rules when it carries them, else the arch policy when known, else
        the generic heuristic. With ``params`` given, logs how much matched
        (the reference prints the resolved policy list the same way)."""
        policy = None
        if model_or_arch is not None:
            policy = AutoTP.get_policy(model_or_arch)
        if policy is None:
            policy = GENERIC_POLICY
        own = getattr(model_or_arch, "tensor_rules", None)
        rules = own if callable(own) else policy.tensor_rules()
        if params is not None:
            from deepspeed_tpu_torch.models.convert import flat_params
            leaves = list(params.named_parameters()
                          if hasattr(params, "named_parameters")
                          else flat_params(params).items())
            matched = sum(1 for path, leaf in leaves
                          if rules(path, leaf) is not None)
            logger.info(f"AutoTP[{policy.arch}]: sharding {matched}/{len(leaves)} "
                        f"parameter tensors over the '{TENSOR_AXIS}' axis")
        return rules

    @staticmethod
    def supported_archs() -> list:
        return sorted(POLICIES)
