"""Rank bodies of the port's MoE distributed CPU tests.

``tests/test_torch_moe_dist.py`` spawns gloo ranks through
``deepspeed_tpu_torch.testing.run_distributed``; each rank imports this
module (torch only, never jax), runs one body and writes its results to
``$DSTPU_TEST_OUT`` (``.npz`` arrays, ``.json`` scalars), which the test
holds against the JAX package run in the pytest process.
"""

import dataclasses
import json
import os

import numpy as np
import torch

STEPS = 3
SEQ = 16
LAYER_SHAPE = (8, 16, 64)          # the quantized layer's input [B, S, D]
LAYER_FF = 128


def _out(name: str) -> str:
    return os.path.join(os.environ["DSTPU_TEST_OUT"], name)


def tiny_mixtral(quantized: bool = False):
    from deepspeed_tpu_torch.models.mixtral import TINY_MIXTRAL
    cfg = TINY_MIXTRAL
    return dataclasses.replace(
        cfg, base=dataclasses.replace(cfg.base, dtype=torch.float32),
        moe=dataclasses.replace(cfg.moe, dtype=torch.float32,
                                quantized_dispatch=quantized))


def engine_config(stage: int, mesh: dict, qgz: bool, rows: int) -> dict:
    """``tests/torch_dist_ranks.py``'s fp32 trajectory recipe (gas 2,
    AdamW with decay, clipping, WarmupLR) at ``rows`` sequences a
    micro-batch."""
    return {"train_batch_size": 2 * rows, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "gradient_clipping": 1.0,
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0,
                                     "warmup_max_lr": 1e-3,
                                     "warmup_num_steps": 3}},
            "zero_optimization": {"stage": stage,
                                  "zero_quantized_gradients": qgz},
            "mesh": mesh}


def batches(rows: int, steps: int = STEPS):
    from deepspeed_tpu_torch.models.llama import random_tokens
    return [random_tokens(rows, SEQ, vocab_size=512, seed=200 + i, gas=2)
            for i in range(steps)]


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def layer_inputs():
    rng = np.random.default_rng(7)
    return rng.normal(size=LAYER_SHAPE).astype(np.float32)


def engine_body():
    """The cases of ``$DSTPU_TEST_CASES`` (JSON list of [stage, mesh, qgz,
    quantized]): the tiny fp32 Mixtral from the saved flax parameters,
    ``STEPS`` steps; each rank writes its losses, norms, every master it
    holds (its block of an expert leaf) and the gathered masters."""
    import warnings

    import torch.distributed as dist

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.mixtral import MixtralForCausalLM
    r, w = dist.get_rank(), dist.get_world_size()
    params = _unflatten(dict(np.load(_out("params.npz"))))
    cases = json.loads(os.environ["DSTPU_TEST_CASES"])
    summary, arrays = [], {}
    for k, (stage, mesh, qgz, quantized) in enumerate(cases):
        rows = 2 * w
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            eng, *_ = deepspeed_tpu_torch.initialize(
                model=MixtralForCausalLM(tiny_mixtral(quantized),
                                         device="cpu"),
                config=engine_config(stage, mesh, qgz, rows),
                model_parameters=params, device="cpu")
        losses, norms = [], []
        for b in batches(rows):
            losses.append(float(eng.train_batch(batch=b, stacked=True)))
            norms.append(eng.get_global_grad_norm())
        held = {n: p.detach().numpy().copy()
                for n, p in zip(eng._param_names, eng._masters)}
        full = {n: p.detach().numpy().copy() for n, p in eng.named_masters()}
        summary.append({"losses": losses, "norms": norms,
                        "expert_dim": eng._expert_dim,
                        "qgz_axes": list(eng._qgz_axes),
                        "coords": eng.mesh.coords,
                        "held": sum(v.size for v in held.values()),
                        "moments": sum(m.numel() for m in eng.optimizer.mu)})
        for n, v in held.items():
            arrays[f"{k}/held/{n}"] = v
        for n, v in full.items():
            arrays[f"{k}/full/{n}"] = v
    np.savez(_out(f"moe{r}.npz"), **arrays)
    with open(_out(f"moe{r}.json"), "w") as f:
        json.dump({"cases": summary}, f)


def layer_body():
    """``MOELayer`` with ``quantized_dispatch`` (and without) on the
    ``$DSTPU_TEST_MESH`` mesh: this rank's rows of the global input
    ``layer_inputs()``, the layer's parameters from ``layer.npz``
    (experts cut to this rank's block), the output rows and the gradients
    of ``sum(out ** 2) + aux`` (summed over the ranks by the test: each
    rank's loss is its rows' share)."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm.mesh import (BATCH_AXES, create_mesh,
                                               set_global_mesh)
    from deepspeed_tpu_torch.config.config import MeshConfig
    from deepspeed_tpu_torch.moe.sharded_moe import MOELayer, MoEConfig
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.runtime.zero import partition
    r = dist.get_rank()
    mesh = create_mesh(MeshConfig(**json.loads(os.environ["DSTPU_TEST_MESH"])),
                       device=torch.device("cpu"))
    set_global_mesh(mesh)
    saved = dict(np.load(_out("layer.npz")))
    x_all = layer_inputs()
    dp = mesh.axis_world(BATCH_AXES)
    n = x_all.shape[0] // dp
    c = mesh.axis_index(BATCH_AXES)
    arrays = {}
    for quantized in (True, False):
        cfg = MoEConfig(num_experts=4, top_k=2, dtype=torch.float32,
                        quantized_dispatch=quantized)
        layer = MOELayer(cfg, LAYER_SHAPE[-1], LAYER_FF, device="cpu")
        with torch.no_grad():
            for name, p in layer.named_parameters():
                full = torch.from_numpy(saved[name])
                if ".experts." in name or name.startswith("experts."):
                    full = partition.shard_of(full, 0, mesh, ("expert",))
                p.data = full.clone()
        x = torch.from_numpy(x_all[c * n:(c + 1) * n]).requires_grad_(True)
        build.reset_launch_counts()
        out, aux = layer(x, train=False)
        loss = (out ** 2).sum() + aux / dp
        loss.backward()
        tag = "q" if quantized else "d"
        arrays[f"{tag}/out"] = out.detach().numpy()
        arrays[f"{tag}/x_grad"] = x.grad.numpy()
        for name, p in layer.named_parameters():
            arrays[f"{tag}/grad/{name}"] = p.grad.numpy()
    np.savez(_out(f"layer{r}.npz"), **arrays)
    with open(_out(f"layer{r}.json"), "w") as f:
        json.dump({"coords": mesh.coords}, f)
