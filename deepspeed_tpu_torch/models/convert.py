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

MoE serving: ``moe_params_from_jax`` and ``init_moe_params`` build the
tree of ``MixtralPolicy`` and ``Qwen2MoEPolicy``: ``{"model": ...}`` over
the flax layout of the JAX package's ``MixtralForCausalLM`` /
``Qwen2MoEForCausalLM`` (no ``model`` level there: ``embed``,
``layer_{i}/{attn,attn_norm,mlp_norm,moe,shared_expert}``, ``final_norm``,
``lm_head``), the layer weights in ``cfg.base.dtype``, the norm scales,
the router ``wg`` and the head in fp32 (``moe_param_shapes``).

Training: ``load_flax_params`` fills the training ``LlamaForCausalLM``,
``MixtralForCausalLM`` or ``Qwen2MoEForCausalLM`` (whose parameter names
are the flax paths joined by dots; each draws its own seeded weights on its
device) from the flax tree as fp32 masters; ``to_flax_tree`` is its
inverse, for parameters or gradients. ``simple_params_from_jax`` gives
the state dict of the engine tests' ``models.simple.SimpleModel``.
"""

import warnings
from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.utils.device import resolve_device


def _to_tensor(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    if device.type == "cpu" or not (a.flags.writeable
                                    and a.flags.c_contiguous):
        a = np.array(a)                       # own, writable, contiguous copy
    if a.dtype.name == "bfloat16":            # ml_dtypes bf16 leaves
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device).to(dtype=dtype)    # cast on the device


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


# ---------------------------------------------------------------------------
# the MoE models' serving trees (Mixtral, Qwen2-MoE)
# ---------------------------------------------------------------------------
def moe_param_shapes(cfg) -> Dict[str, Tuple[Tuple[int, ...], str, int]]:
    """Every leaf of a ``MixtralConfig`` or ``Qwen2MoEConfig`` model's flax
    tree, by its ``/`` path: (shape, kind, fan-in). The kind says what the
    serving tree keeps it in: ``fp32`` (norm scales, the router, the head)
    or ``model`` (``cfg.base.dtype``: the embedding, which the embed step
    casts at lookup, and every layer weight, which the reference casts at
    each use)."""
    b = cfg.base
    d, hd, h, hkv = b.hidden_size, b.head_dim_, b.num_heads, b.num_kv_heads
    e = cfg.moe.num_experts
    f = getattr(cfg, "moe_intermediate_size", b.intermediate_size)
    shapes = {"embed/embedding": ((b.vocab_size, d), "model", d),
              "final_norm/scale": ((d,), "fp32", 0),
              "lm_head/kernel": ((d, b.vocab_size), "fp32", d)}
    for i in range(b.num_layers):
        p = f"layer_{i}/"
        for name, shape, fan in (("wq", (d, h, hd), d), ("wk", (d, hkv, hd), d),
                                 ("wv", (d, hkv, hd), d),
                                 ("wo", (h, hd, d), h * hd)):
            shapes[f"{p}attn/{name}/kernel"] = (shape, "model", fan)
            if b.attention_bias and name != "wo":
                shapes[f"{p}attn/{name}/bias"] = (shape[1:], "model", 0)
        shapes[f"{p}attn_norm/scale"] = ((d,), "fp32", 0)
        shapes[f"{p}mlp_norm/scale"] = ((d,), "fp32", 0)
        shapes[f"{p}moe/gate/wg/kernel"] = ((d, e), "fp32", d)
        shapes[f"{p}moe/experts/w_gate"] = ((e, d, f), "model", d)
        shapes[f"{p}moe/experts/w_up"] = ((e, d, f), "model", d)
        shapes[f"{p}moe/experts/w_down"] = ((e, f, d), "model", f)
        fs = getattr(cfg, "shared_expert_intermediate_size", None)
        if fs is not None:
            q = f"{p}shared_expert/"
            shapes[q + "w_gate/kernel"] = ((d, fs), "model", d)
            shapes[q + "w_up/kernel"] = ((d, fs), "model", d)
            shapes[q + "w_down/kernel"] = ((fs, d), "model", fs)
            shapes[q + "gate/kernel"] = ((d, 1), "model", d)
    return shapes


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        *keys, leaf = path.split("/")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def moe_params_from_jax(tree: Mapping, cfg, device=None) -> Dict[str, Any]:
    """The flax tree of the JAX package's ``MixtralForCausalLM`` or
    ``Qwen2MoEForCausalLM`` (``init(...)["params"]``, numpy leaves; or an
    ``convert_hf_*`` tree) -> the port's serving tree ``{"model": <the same
    layout>}`` on ``device``, each leaf in its ``moe_param_shapes`` kind."""
    dev = resolve_device(device)
    kinds = {"model": cfg.base.dtype, "fp32": torch.float32}
    flat = {}
    for path, (shape, kind, _) in moe_param_shapes(cfg).items():
        arr = _flax_leaf(tree, path.replace("/", "."))
        if tuple(np.shape(arr)) != tuple(shape):
            raise ValueError(f"{path}: expected shape {shape}, got "
                             f"{np.shape(arr)}")
        flat[path] = _to_tensor(arr, kinds[kind], dev)
    return {"model": _nest(flat)}


def init_moe_params(cfg, seed: int = 0, device=None) -> Dict[str, Any]:
    """Seeded random weights of an MoE model in the port's serving tree,
    made directly on ``device`` in their ``moe_param_shapes`` kinds (never
    a full fp32 copy on the host: Qwen1.5-MoE-A2.7B is 29 GB in bf16).
    Kernels are normal with std ``1/sqrt(fan_in)``, the embedding with std
    ``1/sqrt(hidden)``, biases zero, norm scales one; the draws come from a
    ``torch.Generator`` on ``device``, as ``init_llama_params``' do."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kinds = {"model": cfg.base.dtype, "fp32": torch.float32}
    flat = {}
    for path, (shape, kind, fan_in) in moe_param_shapes(cfg).items():
        dt = kinds[kind]
        if path.endswith("norm/scale"):
            flat[path] = torch.ones(shape, device=dev, dtype=dt)
        elif path.endswith("/bias"):
            flat[path] = torch.zeros(shape, device=dev, dtype=dt)
        else:
            t = torch.randn(shape, generator=gen, device=dev, dtype=dt)
            flat[path] = t.mul_(1.0 / float(np.sqrt(fan_in)))
    return {"model": _nest(flat)}


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


def simple_params_from_jax(tree: Mapping, device=None
                           ) -> Dict[str, torch.Tensor]:
    """``models.simple.SimpleModel``'s state dict from the JAX
    ``SimpleModel``'s parameter tree (``{"Dense_{i}": {"kernel": [in,
    out], "bias": [out]}}``, numpy or array leaves) as fp32 tensors on
    ``device`` (the CPU by default): the flax layout is the port's, so each
    leaf keeps its shape."""
    dev = torch.device(device or "cpu")
    out = {}
    for layer in sorted(tree, key=lambda k: int(k.split("_")[-1])):
        if not layer.startswith("Dense_"):
            raise KeyError(f"not a SimpleModel tree: {layer!r}")
        for leaf in ("kernel", "bias"):
            out[f"{layer}.{leaf}"] = _to_tensor(tree[layer][leaf],
                                                torch.float32, dev)
    return out


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


# ---------------------------------------------------------------------------
# tensor-parallel blocks
# ---------------------------------------------------------------------------
def tp_shard(params: Mapping, rules, rank: int, tp: int) -> Dict[str, Any]:
    """One tensor rank's blocks of a full parameter tree: ``params`` is a
    flat state dict (dotted names) or a nested tree (names joined by
    ``/`` for the rules), its leaves tensors or arrays; a leaf whose
    ``rules(name, leaf)`` spec names ``tensor`` on a dimension is cut to
    block ``rank`` of ``tp`` along it (an owned copy), the rest pass
    through. The result has the structure of ``params``. A dimension
    ``tp`` does not divide passes through whole, with one warning, as the
    JAX package's spec builder replicates it (``runtime/zero/
    partition.py``); the model runs such a leaf on its plain path."""
    from deepspeed_tpu_torch.runtime.zero.partition import sharded_dim
    if not 0 <= rank < tp:
        raise ValueError(f"tensor rank {rank} outside {tp} ranks")

    def cut(name, leaf):
        spec = rules(name, leaf) if rules is not None else None
        dim = sharded_dim(spec, ("tensor",)) if spec else None
        if dim is None or tp == 1:
            return leaf
        n = leaf.shape[dim]
        if n % tp:
            warnings.warn(f"{name}: dim {dim} of shape {tuple(leaf.shape)} "
                          f"not divisible by tensor={tp}; replicating that "
                          "dim", UserWarning, stacklevel=3)
            return leaf
        b = n // tp
        if isinstance(leaf, torch.Tensor):
            return leaf.narrow(dim, rank * b, b).clone()
        return np.ascontiguousarray(np.take(leaf, range(rank * b,
                                                        (rank + 1) * b),
                                            axis=dim))

    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            name = f"{prefix}{k}"
            out[k] = walk(v, name + "/") if isinstance(v, Mapping) \
                else cut(name, v)
        return out
    return walk(params, "")


def flat_params(params: Mapping) -> Dict[str, Any]:
    """A flat state dict (dotted names) of a flat or nested tree."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(v, name + ".")
            else:
                out[name] = v
    walk(params, "")
    return out
