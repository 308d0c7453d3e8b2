"""HF weight helpers shared by the family converters.

A part of ``deepspeed_tpu/models/families.py`` (``:89-125``): ``_t``,
``hf_get`` and ``attn_tree_from_weights``, which the MoE converters
(``models/mixtral.py``, ``models/qwen2_moe.py``) need. The family mappers
(``config_from_hf``, ``convert_hf_state_dict`` for llama, mistral, qwen2,
phi3 and gemma) wait for ROADMAP Queue 1 item 7.
"""

import numpy as np


def _t(w) -> np.ndarray:
    return np.asarray(w).T


def hf_get(state, name) -> np.ndarray:
    """One tensor of an HF state dict as numpy (a torch tensor is detached
    and moved to the CPU; bf16 is widened to fp32 first, numpy having no
    bfloat16)."""
    v = state[name]
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        if str(v.dtype) == "torch.bfloat16":
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def attn_tree_from_weights(wq, wk, wv, wo, d, h, hkv, dh,
                           bq=None, bk=None, bv=None):
    """HF [out, in] projection weights -> the attention subtree in the flax
    layout (``wq/wk/wv`` kernels [D, heads, dh], ``wo`` [h, dh, D], biases
    [heads, dh])."""
    attn = {
        "wq": {"kernel": _t(wq).reshape(d, h, dh)},
        "wk": {"kernel": _t(wk).reshape(d, hkv, dh)},
        "wv": {"kernel": _t(wv).reshape(d, hkv, dh)},
        "wo": {"kernel": _t(wo).reshape(h, dh, d)},
    }
    if bq is not None:
        attn["wq"]["bias"] = np.asarray(bq).reshape(h, dh)
        attn["wk"]["bias"] = np.asarray(bk).reshape(hkv, dh)
        attn["wv"]["bias"] = np.asarray(bv).reshape(hkv, dh)
    return attn
