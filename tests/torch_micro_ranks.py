"""Rank bodies of the training carry-overs' CPU tests over ranks.

``tests/test_torch_micro_steps.py`` and ``tests/test_torch_optimizers.py``
spawn two gloo ranks through ``deepspeed_tpu_torch.testing.
run_distributed``; each rank imports this module (torch only, never jax),
runs ``cases_body`` over the cases named in ``$DSTPU_TEST_CASES`` and
writes its rows to ``$DSTPU_TEST_OUT`` (``micro{r}.json``; rank 0's full
masters in ``micro{r}.npz``), which the tests hold against the JAX engine
on a mesh of the same shape. A case is ``(loop, config)``: ``loop`` is
``"micro"`` (DeepSpeed's ``engine(batch)`` / ``backward`` / ``step``, a
micro-batch at a time) or ``"train_batch"``.
"""

import copy
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as base  # noqa: E402

STEPS = 3
ROWS = 4                    # sequences a global micro-batch
FSDP2 = {"fsdp": 2, "data": 1}
DATA2 = {"data": 2}
# a constant lr 3e-3 (no warm-up): the ranks' masters land within 2.2e-6
# of JAX's, and a trust ratio taken from a block alone moves 3.4% of the
# elements past the parity's 1e-5, up to 1.4e-3 (measured on the CPU)
LAMB = {"optimizer": {"type": "lamb", "params": {"lr": 3e-3,
                                                 "weight_decay": 0.1}},
        "scheduler": None}
# name -> (loop, stage, mesh, extra config); "zero" merges into
# zero_optimization, "optimizer" replaces the recipe's AdamW, a None
# "scheduler" drops its warm-up, "fault" is a planted fault the test must
# catch
CASES = {
    "micro_fsdp2_s2": ("micro", 2, FSDP2, {}),
    "micro_data2_qgz": ("micro", 1, DATA2,
                        {"zero": {"zero_quantized_gradients": True}}),
    "micro_data2_compress": ("micro", 0, DATA2,
                             {"comm_compression": {"enabled": True}}),
    "micro_fsdp2_offload_s1": ("micro", 1, FSDP2, {"zero": {
        "offload_optimizer": {"device": "cpu"}}}),
    "lamb_fsdp2_s1": ("train_batch", 1, FSDP2, LAMB),
    "lamb_fsdp2_s3": ("train_batch", 3, FSDP2, LAMB),
    "lamb_tp2": ("train_batch", 0, {"tensor": 2, "data": 1}, LAMB),
    # LAMB's trust ratio from each rank's block alone
    "lamb_fsdp2_s3_local_norms": ("train_batch", 3, FSDP2,
                                  {**LAMB, "fault": "local"}),
}
MICRO = [k for k in CASES if k.startswith("micro")]
LAMBS = [k for k in CASES if k.startswith("lamb")]


def _out(name: str) -> str:
    return os.path.join(os.environ["DSTPU_TEST_OUT"], name)


def case_config(name: str) -> dict:
    """``torch_dist_ranks.zero_config``'s fp32 recipe (gas 2, AdamW with
    decay, clipping, WarmupLR) with case ``name``'s stage, mesh and
    extras."""
    _, stage, mesh, extra = CASES[name]
    cfg = base.zero_config(stage, dict(mesh), False, ROWS)
    extra = copy.deepcopy(extra)
    extra.pop("fault", None)
    cfg["zero_optimization"].update(extra.pop("zero", {}))
    cfg.update(extra)
    return {k: v for k, v in cfg.items() if v is not None}


def micro_batches(batch: dict):
    """The global micro-batches of a stacked [gas, rows, ...] batch."""
    gas = next(iter(batch.values())).shape[0]
    return [{k: v[i] for k, v in batch.items()} for i in range(gas)]


def run_case(name: str, params):
    """Case ``name`` on this rank: its row and the full masters."""
    import warnings
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as tllama
    loop, _, _, extra = CASES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(base.tiny_fp32(), device="cpu"),
            config=case_config(name), model_parameters=params,
            device="cpu")
    if extra.get("fault") == "local":
        eng.optimizer.reduce_leaf_sums = None
    losses, norms, boundaries = [], [], []
    for batch in base.zero_batches(ROWS, STEPS):
        if loop == "micro":
            for micro in micro_batches(batch):
                loss = eng(micro)
                eng.backward(loss)
                boundaries.append(eng.is_gradient_accumulation_boundary())
                eng.step()
                losses.append(float(loss))
        else:
            losses.append(float(eng.train_batch(batch=batch, stacked=True)))
        norms.append(eng.get_global_grad_norm())
    row = {"losses": losses, "norms": norms, "boundaries": boundaries,
           "global_steps": eng.global_steps, "micro_steps": eng.micro_steps,
           "skipped": eng.skipped_steps,
           "wire_axes": list(eng._wire_axes),
           "opt_dim": eng._opt_dim, "param_dim": eng._param_dim,
           "tensor_dim": eng._tensor_dim}
    if eng._offload is None:
        opt = eng.optimizer
        row["state_numel"] = sum(t.numel() for n in opt.STATE
                                 for t in getattr(opt, n))
        ef = getattr(opt, "state", None)
        if ef is not None and ef.error_feedback:
            row["ef_untouched"] = all(
                not torch.any(e.worker).item() and not torch.any(e.server).item()
                for e in ef.error_feedback)
            row["ef_buckets"] = len(ef.error_feedback)
    else:
        row["host_numel"] = sum(leaf.size for leaf in eng._offload.leaves)
        row["host_steps"] = eng._offload.kernel.step_count
    masters = {n: m.detach().numpy().copy() for n, m in eng.named_masters()}
    return row, masters


def cases_body():
    """Every case of ``$DSTPU_TEST_CASES`` (a JSON list of CASES names):
    ``micro{r}.json`` (rows), ``micro{r}.npz`` (rank 0's masters)."""
    import torch.distributed as dist
    r = dist.get_rank()
    names = json.loads(os.environ["DSTPU_TEST_CASES"])
    params = base._unflatten(dict(np.load(_out("params.npz"))))
    rows, arrays = {}, {}
    for name in names:
        rows[name], masters = run_case(name, params)
        if r == 0:
            arrays.update({f"{name}/{n}": v for n, v in masters.items()})
    np.savez(_out(f"micro{r}.npz"), **arrays)
    with open(_out(f"micro{r}.json"), "w") as f:
        json.dump({"rank": r, "cases": rows}, f)
