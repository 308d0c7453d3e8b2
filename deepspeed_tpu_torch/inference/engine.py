"""Inference engine (v1).

Port of ``deepspeed_tpu/inference/engine.py`` (reference
``deepspeed/inference/engine.py:41``, ``InferenceEngine``): wraps a model,
builds the TP mesh, places the parameters by the tensor rules and serves
``forward``. Each rank is a process holding its blocks: the given full
parameters are cut to this rank's blocks of the ``tensor`` axis by the
rules (``models/convert.py::tp_shard``; the JAX engine's
``build_param_shardings`` at stage 0), then cast to the config's dtype.
The model (``LlamaForCausalLM``, ``MixtralForCausalLM``,
``Qwen2MoEForCausalLM``) runs on them through its flash or plain
attention, with the collectives of ``module_inject/layers.py``;
``forward`` returns the whole fp32 logits (gathered over ``tensor``). The
FastGen-style ragged engine is ``inference/v2``.
"""

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.comm import mesh as mesh_lib
from deepspeed_tpu_torch.config.config import MeshConfig
from deepspeed_tpu_torch.inference.config import DTYPES, InferenceConfig
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist


class InferenceEngine:
    """Single-batch inference wrapper (reference: inference/engine.py:41).

    ``model``: a module of this package with ``logits(batch)`` (its
    parameters are replaced by this rank's blocks), or a callable
    ``apply_fn(params, batch)`` given the blocks. ``params``: the full
    parameters as a flat state dict (dotted names) of tensors or arrays,
    or the flax tree (numpy leaves), on the host or the card; None keeps
    a module's own weights (cut by the rules). ``device``: the card
    unless the caller names the CPU.
    """

    def __init__(self, model, config: InferenceConfig, params: Optional[Any] = None,
                 mesh=None, tensor_rules: Optional[Callable] = None,
                 device=None):
        from deepspeed_tpu_torch.models.convert import flat_params, tp_shard
        self.module = model
        self.config = config
        self._validate_config(config)
        self.device = resolve_device(device)
        if mesh is None:
            mesh = mesh_lib.create_mesh(MeshConfig(data=-1,
                                                   tensor=config.tp_size),
                                        device=self.device)
        self.mesh = mesh
        mesh_lib.set_global_mesh(mesh)
        self.dtype = DTYPES[config.dtype]
        tp = mesh.shape["tensor"]
        is_module = isinstance(model, torch.nn.Module)
        if not is_module and not callable(model):
            raise TypeError(f"model must be a module or callable, got {type(model)}")
        # a port model checks that its heads split (before the cut)
        check_heads = getattr(model, "check_tensor_parallel", None)
        if tp > 1 and check_heads is not None:
            check_heads(tp)

        self.params = None
        full = None
        if params is not None:
            full = flat_params(params)
        elif is_module:
            full = {n: p.detach() for n, p in model.named_parameters()}
        if full is not None:
            rank = mesh.coords["tensor"]
            blocks = tp_shard(full, tensor_rules, rank, tp)
            del full
            self.params = {n: _to(v, self.device, self.dtype)
                           for n, v in blocks.items()}
            del blocks
            if is_module:
                self._bind(model)
        log_dist(f"inference engine: tp={config.tp_size} dtype={config.dtype}", ranks=[0])

    def _bind(self, model: torch.nn.Module) -> None:
        """Make this rank's blocks the module's parameters (no gradient),
        so the module holds them and no full leaf."""
        names = [n for n, _ in model.named_parameters()]
        missing = [n for n in names if n not in self.params]
        if missing:
            raise KeyError(f"params lack {missing[:4]}")
        for n in names:
            owner, attr = n.rsplit(".", 1)
            setattr(model.get_submodule(owner), attr,
                    torch.nn.Parameter(self.params[n], requires_grad=False))
        self.params = dict(model.named_parameters())

    @staticmethod
    def _validate_config(config: InferenceConfig):
        if config.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {config.tp_size}")

    def _batch(self, batch: Mapping) -> dict:
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(v))
                    ).to(self.device) for k, v in batch.items()}

    @torch.no_grad()
    def forward(self, batch, params: Optional[Any] = None):
        """reference: engine.forward:579. The whole fp32 logits."""
        mesh_lib.set_global_mesh(self.mesh)
        batch = self._batch(batch)
        if isinstance(self.module, torch.nn.Module):
            if params is not None:
                raise ValueError("a module serves its bound blocks; params= "
                                 "is for a callable model")
            if self.params is None:
                raise ValueError("no params bound")
            return self.module.logits(batch)
        p = params if params is not None else self.params
        if p is None:
            raise ValueError("no params bound; pass params= at init or to forward()")
        return self.module(p, batch)

    __call__ = forward


def _to(v, device, dtype) -> torch.Tensor:
    """A leaf (tensor or array) on ``device``, floating leaves in
    ``dtype`` (the reference's ``cast_to_compute``)."""
    if not isinstance(v, torch.Tensor):
        from deepspeed_tpu_torch.models.convert import _to_tensor
        a = np.asarray(v)
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            return _to_tensor(a, dtype, device)
        return torch.from_numpy(np.array(a)).to(device)
    v = v.to(device)
    return v.to(dtype) if v.is_floating_point() else v
