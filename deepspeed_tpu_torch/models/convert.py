"""Llama weights for the port: from a JAX parameter tree, or seeded random.

Serving: ``llama_params_from_jax`` and ``init_llama_params`` build the
serving engine's parameter tree: nested dicts with the flax tree's names
and tensor layouts (``wq [D,H,hd]``, ``wk/wv [D,Hkv,hd]``, ``wo [H,hd,D]``,
``w_gate/w_up [D,F]``, ``w_down [F,D]``, ``embedding [V,D]``,
``lm_head [D,V]``), so the serving code's einsum strings are the
reference's. The reference keeps fp32 masters and casts them at each use;
the port casts the layer weights once, to ``cfg.dtype``. What the
reference reads in fp32 stays fp32: the norm scales, and the head
(``lm_head`` or, when tied, the embedding, which the embed step casts to
``cfg.dtype`` at lookup), which the reference multiplies in fp32.

Training: ``load_flax_params`` fills the training ``LlamaForCausalLM``
(whose parameter names are the flax paths joined by dots; it draws its own
seeded weights on its device) from the flax tree as fp32 masters;
``to_flax_tree`` is its inverse, for parameters or gradients.
"""

from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.utils.device import resolve_device


def _to_tensor(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.array(arr)                         # own, writable, contiguous copy
    if a.dtype.name == "bfloat16":            # ml_dtypes bf16 leaves
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _layer_shapes(cfg: LlamaConfig) -> Dict[str, Dict[str, Any]]:
    d, hd, f = cfg.hidden_size, cfg.head_dim_, cfg.intermediate_size
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    attn = {"wq": (d, h, hd), "wk": (d, hkv, hd), "wv": (d, hkv, hd),
            "wo": (h, hd, d)}
    mlp = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return {"attn": attn, "mlp": mlp}


def llama_params_from_jax(tree: Mapping, cfg: LlamaConfig,
                          device=None) -> Dict[str, Any]:
    """The unscanned flax tree ``LlamaForCausalLM.init(...)["params"]``
    (leaves as numpy arrays) -> the port's tree on ``device``.

    Reads ``model/embed/embedding``, ``model/layer_{i}/attn/{wq,wk,wv,wo}/
    kernel`` (+ ``bias`` on wq/wk/wv when present), ``model/layer_{i}/mlp/
    {w_gate,w_up,w_down}/kernel``, ``model/layer_{i}/{attn,mlp}_norm/scale``,
    ``model/final_norm/scale`` and, unless embeddings are tied,
    ``model/lm_head/kernel``."""
    dev = resolve_device(device)
    src = tree["model"]
    if "layers" in src:
        raise ValueError("scanned layer trees (model/layers) are not "
                         "supported; initialise the JAX model with "
                         "scan_layers=False")
    shapes = _layer_shapes(cfg)

    def conv(arr, shape, dtype):
        if tuple(np.shape(arr)) != tuple(shape):
            raise ValueError(f"expected shape {shape}, got {np.shape(arr)}")
        return _to_tensor(arr, dtype, dev)

    dt, f32 = cfg.dtype, torch.float32
    d, v = cfg.hidden_size, cfg.vocab_size
    head_dt = f32 if cfg.tie_embeddings else dt     # the fp32 head
    model: Dict[str, Any] = {
        "embed": {"embedding": conv(src["embed"]["embedding"], (v, d),
                                    head_dt)},
        "final_norm": {"scale": conv(src["final_norm"]["scale"], (d,), f32)},
    }
    if not cfg.tie_embeddings:
        model["lm_head"] = {"kernel": conv(src["lm_head"]["kernel"], (d, v), f32)}
    for i in range(cfg.num_layers):
        lp = src[f"layer_{i}"]
        layer: Dict[str, Any] = {"attn": {}, "mlp": {}}
        for group, names in shapes.items():
            for name, shape in names.items():
                entry = {"kernel": conv(lp[group][name]["kernel"], shape, dt)}
                if "bias" in lp[group][name]:
                    entry["bias"] = conv(lp[group][name]["bias"], shape[1:], dt)
                layer[group][name] = entry
        for norm in ("attn_norm", "mlp_norm"):
            layer[norm] = {"scale": conv(lp[norm]["scale"], (d,), f32)}
        model[f"layer_{i}"] = layer
    return {"model": model}


def init_llama_params(cfg: LlamaConfig, seed: int = 0,
                      device=None) -> Dict[str, Any]:
    """Seeded random weights in the port's tree, made directly on ``device``
    in ``cfg.dtype`` (never a full fp32 copy on the host: Llama-3-8B is
    16 GB in bf16), the head in fp32 as ``llama_params_from_jax`` keeps it.
    Kernels are normal with std ``1/sqrt(fan_in)``, the embedding normal
    with std ``1/sqrt(hidden)``, norm scales one. Draws come from a
    ``torch.Generator`` on ``device``, so the same seed on the same device
    gives the same weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = cfg.dtype

    def normal(shape, fan_in, dtype=dt):
        t = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return t.mul_(1.0 / float(np.sqrt(fan_in)))

    def ones(n):
        return torch.ones(n, device=dev, dtype=torch.float32)

    d, v = cfg.hidden_size, cfg.vocab_size
    f32 = torch.float32
    model: Dict[str, Any] = {
        "embed": {"embedding": normal((v, d), d,
                                      f32 if cfg.tie_embeddings else dt)},
        "final_norm": {"scale": ones(d)}}
    if not cfg.tie_embeddings:
        model["lm_head"] = {"kernel": normal((d, v), d, f32)}
    shapes = _layer_shapes(cfg)
    for i in range(cfg.num_layers):
        layer: Dict[str, Any] = {"attn": {}, "mlp": {}}
        for group, names in shapes.items():
            for name, shape in names.items():
                fan_in = shape[0] if name != "wo" else shape[0] * shape[1]
                entry = {"kernel": normal(shape, fan_in)}
                if cfg.attention_bias and name in ("wq", "wk", "wv"):
                    entry["bias"] = torch.zeros(shape[1:], device=dev, dtype=dt)
                layer[group][name] = entry
        layer["attn_norm"] = {"scale": ones(d)}
        layer["mlp_norm"] = {"scale": ones(d)}
        model[f"layer_{i}"] = layer
    return {"model": model}


def params_device(params: Mapping) -> torch.device:
    return params["model"]["embed"]["embedding"].device


# ---------------------------------------------------------------------------
# the training module
# ---------------------------------------------------------------------------
def _flax_leaf(tree: Mapping, name: str):
    node = tree
    for key in name.split("."):
        if key not in node:
            raise KeyError(f"flax tree has no {'/'.join(name.split('.'))}")
        node = node[key]
    return node


@torch.no_grad()
def load_flax_params(module: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Copy the unscanned flax tree ``LlamaForCausalLM.init(...)["params"]``
    (numpy leaves) into ``module``'s parameters as fp32 masters; every
    parameter must be found with its shape."""
    if "layers" in tree.get("model", {}):
        raise ValueError("scanned layer trees (model/layers) are not "
                         "supported; initialise the JAX model with "
                         "scan_layers=False")
    for name, p in module.named_parameters():
        arr = _flax_leaf(tree, name)
        if tuple(np.shape(arr)) != tuple(p.shape):
            raise ValueError(f"{name}: expected shape {tuple(p.shape)}, got "
                             f"{np.shape(arr)}")
        p.copy_(_to_tensor(arr, torch.float32, p.device))
    return module


def to_flax_tree(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, Any]:
    """(dotted name, tensor) pairs -> the nested flax-layout dict of float32
    numpy arrays (parameters, or gradients named like them)."""
    out: Dict[str, Any] = {}
    for name, t in named:
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return out
