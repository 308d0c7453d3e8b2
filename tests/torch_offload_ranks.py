"""Rank bodies of the port's memory-tier CPU tests over ranks.

``tests/test_torch_offload_ranks.py`` spawns two and four gloo ranks
through ``deepspeed_tpu_torch.testing.run_distributed``; each rank
imports this module (torch only, never jax), runs ``tiers_body`` over the
cases of ``$DSTPU_TEST_CASES`` and writes its results to
``$DSTPU_TEST_OUT`` (``tier{r}.json`` scalars, ``tier{r}.npz`` the full
masters of rank 0), which the test holds against the JAX engine on a
mesh of the same shape. Each optimizer-tier case also runs the in-HBM
engine of the same stage and mesh: what it holds and what its
collectives move are what the tier's must be. ``run_smoke_tier_ranks``
runs the smoke's two-rank tier body at TINY width, for the CPU test and
the card test.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch_dist_ranks as base  # noqa: E402

STEPS = 3
ROWS = 4                    # sequences a micro-batch over the batch ranks
# name -> (tier, stage, mesh, device, qgz); tier "optimizer" or "param"
CASES = {
    "opt_s0_data2": ("optimizer", 0, {"data": 2}, "cpu", False),
    "opt_s1_fsdp2": ("optimizer", 1, {"fsdp": 2, "data": 1}, "cpu", False),
    "opt_s2_fsdp2": ("optimizer", 2, {"fsdp": 2, "data": 1}, "cpu", False),
    "opt_s3_fsdp2": ("optimizer", 3, {"fsdp": 2, "data": 1}, "cpu", False),
    "opt_s2_data2": ("optimizer", 2, {"data": 2}, "cpu", False),
    "opt_s1_data2_nvme": ("optimizer", 1, {"data": 2}, "nvme", False),
    "opt_s3_fsdp2_nvme": ("optimizer", 3, {"fsdp": 2, "data": 1}, "nvme",
                          False),
    "opt_s1_data2_qgz": ("optimizer", 1, {"data": 2}, "cpu", True),
    "param_data2": ("param", 0, {"data": 2}, "cpu", False),
    "opt_s1_data2_tp2": ("optimizer", 1, {"data": 2, "tensor": 2}, "cpu",
                         False),
    "opt_s2_fsdp2_tp2": ("optimizer", 2, {"fsdp": 2, "tensor": 2,
                                          "data": 1}, "cpu", False),
    "opt_s2_fsdp2_tp2_nvme": ("optimizer", 2, {"fsdp": 2, "tensor": 2,
                                               "data": 1}, "nvme", False),
    "param_data2_tp2": ("param", 0, {"data": 2, "tensor": 2}, "cpu", False),
}
TWO = [k for k, v in CASES.items() if "tensor" not in v[2]]
FOUR = [k for k, v in CASES.items() if "tensor" in v[2]]


def _out(name: str) -> str:
    return os.path.join(os.environ["DSTPU_TEST_OUT"], name)


def tier_config(name: str, nvme_root: str) -> dict:
    """``torch_dist_ranks.zero_config``'s recipe with case ``name``'s tier
    (the parameter tier streams a layer a group)."""
    tier, stage, mesh, device, qgz = CASES[name]
    cfg = base.zero_config(stage, mesh, qgz, ROWS)
    off = {"device": device}
    if device == "nvme":
        off["nvme_path"] = nvme_root
    zc = cfg["zero_optimization"]
    if tier == "optimizer":
        zc["offload_optimizer"] = off
    else:
        zc["offload_param"] = {**off, "layers_per_group": 1}
        zc["offload_optimizer"] = {"device": "cpu"}
    return cfg


def _run(config, params, comms):
    """STEPS steps of the tiny fp32 Llama under ``config``: the engine,
    losses, norms, and the comms logger's totals over the steps."""
    import warnings
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as tllama
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(base.tiny_fp32(), device="cpu"),
            config=config, model_parameters=params, device="cpu")
    comms.reset()
    losses, norms = [], []
    for batch in base.zero_batches(ROWS, STEPS):
        losses.append(float(eng.train_batch(batch=batch, stacked=True)))
        norms.append(eng.get_global_grad_norm())
    totals = {op: {"count": int(v["count"]), "bytes": int(v["bytes"])}
              for op, v in comms.per_op_totals().items() if v["count"]}
    return eng, losses, norms, totals


def tier_case(name, params, comms, nvme_root):
    """Case ``name``: the tier's run and, for the optimizer tier, the
    in-HBM engine's of the same stage and mesh. Returns (row, masters)."""
    tier, stage, mesh, device, qgz = CASES[name]
    root = os.path.join(nvme_root, name)
    eng, losses, norms, totals = _run(tier_config(name, root), params, comms)
    row = {"losses": losses, "norms": norms, "comm": totals,
           "coords": dict(eng.mesh.coords),
           "phase_bytes": dict(eng.phase_bytes),
           "phases": sorted(eng.phase_seconds),
           "tensor_dims": eng._tensor_dim}
    if tier == "optimizer":
        opt = eng._offload
        row.update(host_numel=sum(leaf.size for leaf in opt.leaves),
                   state_bytes=opt.state_bytes(),
                   shadow_elem=eng._masters[0].element_size(),
                   gathered_numel=sum(opt.leaves[i].size
                                      for i in range(len(eng._masters))
                                      if eng._gathers(i)))
        if device == "nvme":
            r = eng.mesh.rank
            row["nvme_files"] = sorted(os.listdir(os.path.join(
                root, f"proc{r}")))
    else:
        po = eng._param_offload
        row.update(host_bytes=po.host_bytes(),
                   state_bytes=po.opt.state_bytes(),
                   bytes_streamed=po.bytes_streamed,
                   held_shapes=[list(s) for s in po._shapes],
                   names=list(po.names))
    masters = {n: m.detach().numpy().copy() for n, m in eng.named_masters()}
    if tier == "optimizer":
        plain = dict(CASES[name][2])
        cfg = base.zero_config(stage, plain, qgz, ROWS)
        heng, hl, _, htotals = _run(cfg, params, comms)
        row["in_hbm"] = {
            "losses": hl, "comm": htotals,
            "moments_numel": sum(m.numel() for m in heng.optimizer.mu)}
    return row, masters


def tiers_body():
    """Every case of ``$DSTPU_TEST_CASES`` (a JSON list of CASES names)
    on this rank: ``tier{r}.json`` (rows), ``tier{r}.npz`` (rank 0: the
    full masters of each case)."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    r = dist.get_rank()
    names = json.loads(os.environ["DSTPU_TEST_CASES"])
    params = base._unflatten(dict(np.load(_out("params.npz"))))
    comms = get_comms_logger()
    comms.configure(enabled=True)
    rows, arrays = {}, {}
    for name in names:
        row, masters = tier_case(name, params, comms,
                                 os.path.join(os.environ["DSTPU_TEST_OUT"],
                                              "nvme"))
        rows[name] = row
        if r == 0:
            arrays.update({f"{name}/{n}": v for n, v in masters.items()})
    comms.configure(enabled=False)
    np.savez(_out(f"tier{r}.npz"), **arrays)
    with open(_out(f"tier{r}.json"), "w") as f:
        json.dump({"rank": r, "cases": rows}, f)


def run_smoke_tier_ranks(out, device):
    """``chip_smoke.tier_ranks_body`` in two gloo ranks on ``device`` at
    ``TINY_LLAMA`` width in fp32 (``DSTPU_SMOKE_MODEL=tiny``), gated by
    ``chip_smoke.check_tier_ranks``: the rows and the gate's result."""
    import chip_smoke
    from deepspeed_tpu_torch.testing import run_distributed
    run_distributed("chip_smoke:tier_ranks_body", 2, timeout=300,
                    backend="gloo", device=device,
                    env={chip_smoke.RANK_OUT_ENV: str(out),
                         chip_smoke.RANK_MODEL_ENV: "tiny",
                         chip_smoke.RANK_DEVICE_ENV: device})
    rows = chip_smoke._read_ranks("tier_ranks", str(out))
    return rows, chip_smoke.check_tier_ranks(rows)


def tp_bf16_body():
    """Two gloo ranks, TINY_LLAMA in bf16 with the smoke's recipe: two
    steps of the one-rank in-HBM engine and parameter tier (rank 0 alone),
    then of both at ``tensor=2``; ``tp_bf16.json``: (loss, norm) a step."""
    import dataclasses
    import torch
    import torch.distributed as dist
    import chip_smoke
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import (TINY_LLAMA,
                                                  LlamaForCausalLM,
                                                  random_tokens)
    r = dist.get_rank()
    recipe, ds = chip_smoke.train_config()
    cfg = dataclasses.replace(TINY_LLAMA, dtype=torch.bfloat16,
                              attention_backend="xla", remat=True,
                              remat_policy=recipe.remat_policy)
    batch = random_tokens(2, 128, vocab_size=512, seed=0, gas=2)

    def run(zero, mesh):
        config = json.loads(json.dumps(ds))
        config["zero_optimization"].update(zero)
        config.update(train_batch_size=4, mesh=mesh or {})
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(cfg, device="cpu", seed=0),
            config=config, device="cpu",
            mesh=None if mesh else chip_smoke._world1_mesh())
        return [(eng.train_batch(batch=batch).item(),
                 eng.get_global_grad_norm()) for _ in range(2)]

    res = {}
    if r == 0:
        res["in_hbm"] = run({}, None)
        res["param"] = run(chip_smoke.PARAM_TIER, None)
    dist.barrier()
    tp = {"tensor": 2, "data": 1}
    res["in_hbm_tp"] = run({}, tp)
    res["param_tp"] = run(chip_smoke.PARAM_TIER, tp)
    if r == 0:
        with open(_out("tp_bf16.json"), "w") as f:
            json.dump(res, f)
