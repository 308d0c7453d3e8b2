"""Rank bodies of the port's distributed CPU tests.

``tests/test_torch_comm.py`` and ``tests/test_torch_zero.py`` spawn gloo
ranks through ``deepspeed_tpu_torch.testing.run_distributed``; each rank
imports this module (torch only, never jax), runs one body and writes its
results to ``$DSTPU_TEST_OUT/rank<r>.npz`` (``.json`` for scalars), which
the test then holds against the JAX package run in the pytest process.
"""

import dataclasses
import json
import os

import numpy as np
import torch

AXES = ("data", "fsdp")
N_Q = 1000                  # flat payload of the quantized all-reduce
CHUNK = 256


def comm_inputs(rank: int, world: int) -> dict:
    """Rank ``rank``'s seeded inputs of the collective checks."""
    rng = np.random.default_rng(1000 + rank)
    f = np.float32
    n_pad = ((N_Q + world * CHUNK - 1) // (world * CHUNK)) * world * CHUNK
    return {
        "x": rng.standard_normal((8, 6)).astype(f),
        "y": rng.standard_normal((8, 8)).astype(f),
        "z": rng.standard_normal((8, 4)).astype(f),
        "u": rng.standard_normal((2, 3)).astype(f),
        "qx": (rng.standard_normal(N_Q) * rng.uniform(0.1, 3.0)).astype(f),
        "we": (rng.standard_normal(n_pad) * 0.01).astype(f),
        "se": (rng.standard_normal(n_pad // world) * 0.01).astype(f),
        "m": rng.standard_normal((16, 64)).astype(f),
        "m2": rng.standard_normal((10, 64)).astype(f),
    }


def _out(name: str) -> str:
    return os.path.join(os.environ["DSTPU_TEST_OUT"], name)


def _mesh(**sizes):
    from deepspeed_tpu_torch.comm.mesh import create_mesh, set_global_mesh
    from deepspeed_tpu_torch.config.config import MeshConfig
    mesh = create_mesh(MeshConfig(**sizes), device=torch.device("cpu"))
    set_global_mesh(mesh)
    return mesh


def comm_body():
    """Every facade collective and quantized collective on this rank's
    inputs, over a data=2 x fsdp=W/2 mesh."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.compress import TensorEF
    from deepspeed_tpu_torch.ops import fp_quant, quant
    w, r = dist.get_world_size(), dist.get_rank()
    mesh = _mesh(data=2, fsdp=w // 2)
    t = {k: torch.from_numpy(v) for k, v in comm_inputs(r, w).items()}
    R = comm.ReduceOp
    res = {
        "ar_sum": comm.all_reduce(t["x"], AXES, R.SUM),
        "ar_avg_fsdp": comm.all_reduce(t["x"], "fsdp", R.AVG),
        "ar_max_data": comm.all_reduce(t["x"], "data", R.MAX),
        "ag0": comm.all_gather(t["x"], AXES, axis=0),
        "ag1_untiled": comm.all_gather(t["x"], "data", axis=1, tiled=False),
        "rs0": comm.reduce_scatter(t["y"], AXES, 0),
        "rs1": comm.reduce_scatter(t["y"], "data", 1),
        "a2a": comm.all_to_all(t["z"], AXES, 0, 1),
        "a2a_untiled": comm.all_to_all(t["u"], "data", 0, 1, tiled=False),
        "pp_ring": comm.ppermute(t["x"], "data", [(0, 1), (1, 0)]),
        "pp_one": comm.ppermute(t["x"], AXES, [(0, w - 1)]),
        "bcast": comm.broadcast_one_to_all(t["x"], "data", root=1),
        "barrier": comm.barrier(AXES),
    }
    out, err = comm.quantized_all_reduce(
        t["qx"], AXES, R.AVG, "int8", error=TensorEF(t["we"], t["se"]))
    res.update(qar_int8_ef=out, qar_int8_ef_worker=err.worker,
               qar_int8_ef_server=err.server)
    res["qar_fp8"], _ = comm.quantized_all_reduce(t["qx"], AXES, R.SUM, "fp8")
    shard, werr = comm.quantized_reduce_scatter(t["qx"], AXES, R.AVG, "int8",
                                                error=t["we"])
    res.update(qrs_int8_ef=shard, qrs_int8_ef_worker=werr)
    res["qag"] = quant.quantized_all_gather(t["m"], "data")
    res["qpss"] = quant.quantized_psum_scatter(t["m2"], "data", mean=True)
    res["a2aqr"] = quant.all_to_all_quant_reduce(t["m"], "fsdp", "data")
    x = t["m2"].clone().requires_grad_(True)
    y = quant.quantized_psum(x, AXES)
    res["qpsum"] = y.detach()
    y.backward(torch.ones_like(y) * 3.0)          # straight through: g
    res["qpsum_grad"] = x.grad
    x = t["m2"].clone().requires_grad_(True)
    quant.quantized_psum(x, AXES, mean=True).backward(torch.ones(10, 64))
    res["qpsum_mean_grad"] = x.grad                # g / W
    res["qa2a"] = quant.quantized_all_to_all(t["m"], "data", 0, 0)
    res["qag_fp8"] = fp_quant.quantized_all_gather_fp8(t["m"], "data")
    res["coords"] = torch.tensor([mesh.coords["data"], mesh.coords["fsdp"]])
    np.savez(_out(f"rank{r}.npz"),
             **{k: v.detach().float().numpy() for k, v in res.items()})


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
ZERO_STEPS = 3


def zero_config(stage: int, mesh: dict, qgz: bool = False,
                rows: int = 4) -> dict:
    """The fp32 trajectory recipe of ``tests/test_torch_train.py`` (gas 2,
    AdamW with decay, clipping, WarmupLR) at a global batch of ``rows``
    sequences a micro-batch."""
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


def zero_batches(rows: int = 4, steps: int = ZERO_STEPS):
    from deepspeed_tpu_torch.models import llama as tllama
    return [tllama.random_tokens(rows, 16, vocab_size=512, seed=100 + i, gas=2)
            for i in range(steps)]


def tiny_fp32():
    from deepspeed_tpu_torch.models import llama as tllama
    return dataclasses.replace(tllama.TINY_LLAMA, dtype=torch.float32,
                               attention_backend="xla")


def run_engine(stage: int, mesh: dict, qgz: bool = False,
               params=None, rows: int = 4, steps: int = ZERO_STEPS):
    """``steps`` train_batch calls of the tiny fp32 Llama: (losses, grad
    norms, full fp32 masters by name, the engine)."""
    import warnings
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as tllama
    if params is None:
        params = dict(np.load(_out("params.npz")))
        params = _unflatten(params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # qgZ, no replica axis
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(tiny_fp32(), device="cpu"),
            config=zero_config(stage, mesh, qgz, rows),
            model_parameters=params,
            device="cpu")
    losses, norms = [], []
    for batch in zero_batches(rows, steps):
        losses.append(float(eng.train_batch(batch=batch, stacked=True)))
        norms.append(eng.get_global_grad_norm())
    masters = {n: p.detach().numpy().copy() for n, p in eng.named_masters()}
    return losses, norms, masters, eng


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def zero_body():
    """The cases of ``$DSTPU_TEST_CASES`` (JSON list of [stage, mesh,
    qgz]) one after another; each rank records its losses, norms, the
    full masters, and what it holds (blocks and moments)."""
    import torch.distributed as dist
    r, w = dist.get_rank(), dist.get_world_size()
    cases = json.loads(os.environ["DSTPU_TEST_CASES"])
    summary = []
    arrays = {}
    for k, (stage, mesh, qgz) in enumerate(cases):
        losses, norms, masters, eng = run_engine(stage, mesh, qgz,
                                                 rows=2 * w)
        held = sum(p.numel() for p in eng._masters)
        moments = sum(m.numel() for m in eng.optimizer.mu)
        summary.append({"losses": losses, "norms": norms, "held": held,
                        "moments": moments, "qgz_axes": list(eng._qgz_axes),
                        "opt_dim": eng._opt_dim, "param_dim": eng._param_dim})
        for n, v in masters.items():
            arrays[f"{k}/{n}"] = v
    np.savez(_out(f"zero{r}.npz"), **arrays)
    with open(_out(f"zero{r}.json"), "w") as f:
        json.dump({"cases": summary, "refusals": _tier_refusals()}, f)


# the memory tiers over ranks' combinations left out: (mesh, zero group)
TIER_REFUSALS = {
    "expert": ({"expert": 2, "data": -1},
               {"offload_optimizer": {"device": "cpu"}}),
    "sequence": ({"sequence": 2, "data": -1},
                 {"offload_param": {"device": "cpu"}}),
    "mics": ({"fsdp": 2, "data": -1},
             {"stage": 3, "mics_shard_size": 2,
              "offload_optimizer": {"device": "cpu"}}),
}


def _tier_refusals() -> dict:
    """What the memory tiers answer over more than one rank where they are
    not ported: with the ``expert`` axis, a ``sequence`` axis, MiCS."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as tllama
    out = {}
    for name, (mesh, zero) in TIER_REFUSALS.items():
        cfg = zero_config(0, mesh, rows=4)
        cfg["zero_optimization"].update(zero)
        try:
            deepspeed_tpu_torch.initialize(
                model=tllama.LlamaForCausalLM(tiny_fp32(), device="cpu"),
                config=cfg, device="cpu")
            out[name] = "accepted"
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def world1_stages(device: str) -> dict:
    """The tiny fp32 Llama at stages 0-3 on one rank of ``device``: each
    stage's losses, norms and masters (to be held bit for bit)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as tllama
    out = {}
    for stage in (0, 1, 2, 3):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(tiny_fp32(), device=device, seed=0),
            config=zero_config(stage, {}), device=device)
        losses = [float(eng.train_batch(batch=b, stacked=True))
                  for b in zero_batches()]
        out[stage] = (losses, eng.get_global_grad_norm(),
                      [m.detach().cpu() for _, m in eng.named_masters()])
    return out


def world1_stages_body():
    """``world1_stages`` on this rank's device under the started process
    group (NCCL at one rank on the card), saved for the test."""
    import torch.distributed as dist
    res = world1_stages(os.environ["DSTPU_TEST_DEVICE"])
    torch.save({"backend": dist.get_backend(), "world": dist.get_world_size(),
                "res": res}, _out("world1.pt"))
