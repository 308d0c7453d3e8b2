"""Rank bodies of the port's hierarchical-ZeRO and replica-wire CPU tests.

``tests/test_torch_zeropp.py`` and ``tests/test_torch_compress.py`` spawn
gloo ranks through ``deepspeed_tpu_torch.testing.run_distributed``; each
rank imports this module (torch only, never jax), runs the cases of
``$DSTPU_TEST_CASES`` one after another and writes its results to
``$DSTPU_TEST_OUT``, which the test then holds against the JAX package
run in the pytest process.

A case is a JSON object: ``stage``, ``zero`` (extra ``zero_optimization``
keys), ``mesh``, ``extra`` (other config groups), ``keep_copy`` (save the
first micro-batch's hpZ secondary blocks, ``capture_secondary``) and
``mutant`` (a fault planted in
this process for the case, then removed: ``local_row_scales``,
``mics_no_fsdp_out_sum``, ``hpz_no_second_hop``).
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as base  # noqa: E402

ROWS = 8                    # sequences a micro-batch over the four ranks


def _out(name: str) -> str:
    return os.path.join(os.environ["DSTPU_TEST_OUT"], name)


@contextlib.contextmanager
def mutant(name):
    """Plant the named fault for the duration of one case."""
    from deepspeed_tpu_torch.ops.quant import quantize_int8
    from deepspeed_tpu_torch.runtime import engine as eng_mod
    from deepspeed_tpu_torch.runtime.zero import partition
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "local_row_scales":
        # each block's own rows' scales, no max over the row's pieces
        patch(partition, "qwz_codes",
              lambda block, dim, row_axes: quantize_int8(block))
    elif name == "mics_no_fsdp_out_sum":
        orig = eng_mod.DeepSpeedTPUEngine._reduce_plan

        def plan(self):
            orig(self)
            self._micro_axes = tuple(a for a in self._micro_axes
                                     if a != "fsdp_out")
        patch(eng_mod.DeepSpeedTPUEngine, "_reduce_plan", plan)
    elif name == "hpz_no_second_hop":
        orig = partition.GatherParam.backward

        def backward(ctx, g):
            if ctx.label != partition.HPZ_LABEL:
                return orig(ctx, g)
            from deepspeed_tpu_torch.comm.comm import _mesh
            return (partition.shard_of(g, ctx.dim, _mesh(), ctx.axes)
                    .contiguous(), None, None, None)
        patch(partition.GatherParam, "backward", staticmethod(backward))
    elif name is not None:
        raise ValueError(f"unknown mutant {name!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


@contextlib.contextmanager
def capture_secondary(eng, keep: bool):
    """While active (and ``keep``), the secondary blocks the engine's hpZ
    hop makes for its first micro-batch, by leaf name: ``QwzHop.apply``
    and ``GatherParam.apply`` under the hop's label are wrapped, in the
    order of ``eng._hpz_leaves``."""
    from deepspeed_tpu_torch.runtime.zero import partition
    names = [eng._param_names[i] for i, _ in eng._hpz_leaves]
    got = {}
    if not keep or not names:
        yield got
        return
    hop, gather = partition.QwzHop.apply, partition.GatherParam.apply

    def keep_block(out):
        if len(got) < len(names):
            got[names[len(got)]] = out.detach().clone()
        return out

    def qwz(*args):
        return keep_block(hop(*args))

    def gather_param(block, dim, axes, label=None):
        out = gather(block, dim, axes, label)
        return keep_block(out) if label == partition.HPZ_LABEL else out

    partition.QwzHop.apply = staticmethod(qwz)
    partition.GatherParam.apply = staticmethod(gather_param)
    try:
        yield got
    finally:
        del partition.QwzHop.apply, partition.GatherParam.apply


def case_config(case: dict) -> dict:
    cfg = base.zero_config(case["stage"], case["mesh"], rows=ROWS)
    cfg["zero_optimization"].update(case.get("zero", {}))
    cfg.update(case.get("extra", {}))
    return cfg


def run_case(case: dict, params) -> dict:
    """Three ``train_batch`` steps of the tiny fp32 Llama under ``case``:
    losses, norms, full masters, the comms logger's totals, and on the
    first step the hpZ secondary blocks when asked."""
    import warnings
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.models import llama as tllama
    from deepspeed_tpu_torch.telemetry.tracer import get_tracer
    comms = get_comms_logger()
    comms.configure(enabled=True)
    comms.reset()
    tracer = get_tracer()
    tracer.configure(enabled=bool(case.get("trace")))
    tracer.clear()
    with warnings.catch_warnings(record=True) as caught, \
            mutant(case.get("mutant")):
        warnings.simplefilter("always")
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(base.tiny_fp32(), device="cpu"),
            config=case_config(case), model_parameters=params, device="cpu")
        losses, norms, per_step, copy = [], [], [], {}
        for k, batch in enumerate(base.zero_batches(ROWS)):
            before = comms.per_op_totals()
            with capture_secondary(eng, bool(case.get("keep_copy"))
                                   and k == 0) as got:
                losses.append(float(eng.train_batch(batch=batch,
                                                    stacked=True)))
            copy.update(got)
            norms.append(eng.get_global_grad_norm())
            after = comms.per_op_totals()
            per_step.append({op: {f: t[f] - before.get(op, {}).get(f, 0)
                                  for f in ("count", "bytes", "wire_bytes")}
                             for op, t in after.items()})
        masters = {n: p.detach().numpy().copy()
                   for n, p in eng.named_masters()}
    comms.configure(enabled=False)
    spans = [[ev[6], ev[7]["bucket"], ev[7]["wire_bytes"], ev[5]]
             for ev in tracer.events_snapshot() if ev[1] == "comm/overlap"]
    tracer.configure(enabled=False)
    tracer.clear()
    comp = eng._comm_compress
    row = {"losses": losses, "norms": norms, "per_step": per_step,
           "mesh": dict(eng.mesh.shape), "zero_axes": list(eng._zero_axes),
           "replica_axes": list(eng._replica_axes),
           "wire_axes": list(eng._wire_axes),
           "qgz_axes": list(eng._qgz_axes),
           "quantized_gradients": eng._quantized_gradients,
           "quantized_weights": eng._quantized_weights,
           "sparse_paths": list(eng._sparse_grad_paths),
           "buckets": comp.bucket_summaries() if comp else None,
           "plan": [[p, list(sh)] for b in comp.buckets
                    for p, sh in zip(b.paths, b.shapes)] if comp else None,
           "overlap_spans": spans,
           "ef_enabled": comp.ef_enabled() if comp else False,
           "held": sum(p.numel() for p in eng._masters),
           "warnings": [str(w.message) for w in caught]}
    if comp is not None and comp.ef_enabled():
        ef = eng.optimizer.state.error_feedback
        row["ef_shapes"] = [[list(e.worker.shape), list(e.server.shape)]
                            for e in ef]
    return {"row": row, "masters": masters,
            "copy": {n: t.numpy().copy() for n, t in copy.items()}}


def cases_body():
    """The cases of ``$DSTPU_TEST_CASES``; rank r writes
    ``cases{r}.json`` (every case's row) and ``cases{r}.npz`` (rank 0:
    every case's masters; every rank: its secondary blocks)."""
    import torch.distributed as dist
    r = dist.get_rank()
    params = base._unflatten(dict(np.load(_out("params.npz"))))
    rows, arrays = [], {}
    for k, case in enumerate(json.loads(os.environ["DSTPU_TEST_CASES"])):
        res = run_case(case, params)
        rows.append(res["row"])
        if r == 0:
            arrays.update({f"{k}/m/{n}": v for n, v in res["masters"].items()})
        arrays.update({f"{k}/c/{n}": v for n, v in res["copy"].items()})
    np.savez(_out(f"cases{r}.npz"), **arrays)
    answers = refusals()           # every rank: a mesh is built by all
    with open(_out(f"cases{r}.json"), "w") as f:
        json.dump({"rank": r, "cases": rows, "refusals": answers}, f)


def refusals() -> dict:
    """What the engine answers to the hierarchical options' misuse."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as tllama
    tries = {
        "mics_and_hpz": ({"mics_shard_size": 2,
                          "zero_hpz_partition_size": 2}, {"fsdp": 4}),
        "indivisible": ({"mics_shard_size": 3}, {"fsdp": 4}),
        "fsdp_fill": ({"mics_shard_size": 2}, {"fsdp": -1, "data": 1}),
        "offload_under_mics": ({"mics_shard_size": 2,
                                "offload_optimizer": {"device": "cpu"}},
                               {"fsdp": 4}),
    }
    out = {}
    for name, (zero, mesh) in tries.items():
        cfg = base.zero_config(3, mesh, rows=ROWS)
        cfg["zero_optimization"].update(zero)
        try:
            deepspeed_tpu_torch.initialize(
                model=tllama.LlamaForCausalLM(base.tiny_fp32(), device="cpu"),
                config=cfg, device="cpu")
            out[name] = "accepted"
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def sparse_inputs(rank: int, rows: int = 64, d: int = 16, touched: int = 5
                  ) -> np.ndarray:
    """Rank ``rank``'s embedding-style gradient: ``touched`` seeded rows of
    ``rows`` nonzero (two ranks share row 3), the rest zero."""
    rng = np.random.default_rng(500 + rank)
    g = np.zeros((rows, d), np.float32)
    idx = np.concatenate([[3], rng.choice(np.arange(4, rows), touched - 1,
                                          replace=False)])
    g[idx] = rng.standard_normal((touched, d)).astype(np.float32)
    return g


def sparse_body():
    """``sparse_grad_sync`` of this rank's ``sparse_inputs`` over ``data``
    (k = 8) and over ``data`` x ``fsdp`` (k = 5), with the comms logger's
    totals, into ``sparse{r}.npz`` / ``.json``."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.runtime.sparse_tensor import sparse_grad_sync
    r, w = dist.get_rank(), dist.get_world_size()
    base._mesh(data=2, fsdp=w // 2)
    g = torch.from_numpy(sparse_inputs(r))
    comms = get_comms_logger()
    comms.configure(enabled=True)
    comms.reset()
    out = {"data": sparse_grad_sync(g, ("data",), 8),
           "both": sparse_grad_sync(g, ("data", "fsdp"), 5)}
    totals = comms.per_op_totals()
    comms.configure(enabled=False)
    np.savez(_out(f"sparse{r}.npz"), **{k: v.numpy() for k, v in out.items()})
    with open(_out(f"sparse{r}.json"), "w") as f:
        json.dump(totals, f)
