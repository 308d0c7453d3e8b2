"""Rank bodies of the port's checkpoint CPU tests over ranks.

``tests/test_torch_checkpoint_ranks.py`` spawns gloo ranks through
``deepspeed_tpu_torch.testing.run_distributed``; each rank imports this
module (torch only, never jax) and runs one body. The checkpoints go to
``$DSTPU_TEST_OUT/<name>``, and global rank 0 writes the body's findings
to ``$DSTPU_TEST_OUT/<body>.json`` (``.npz`` for arrays):

- ``four_body`` (4 ranks): ZeRO-3 at data=2 x fsdp=2 trains two steps and
  saves ``s3``, then takes the third step (its loss); ``comm_compression``
  at data=4 trains two steps and saves ``cc4``; Mixtral at expert=2 x
  data=2 (stage 1) and Llama at fsdp=2 x tensor=2 (stage 3) save ``moe``
  and ``tp`` after a step, with their gathered masters and the next
  step's loss;
- ``two_body`` (2 ranks): ``s3`` loaded at ZeRO-1 over data=2, into the
  optimizer tier at ZeRO-2 over fsdp=2 and into the parameter tier over
  data=2: every whole leaf and moment must equal ``s3``'s files bit for
  bit, and the third step's loss follows; each saves again right after
  the load (``s1``, ``tier``, ``ptier``). ``cc4`` loaded at data=2: every
  rank's worker residual is the mean of the four saved rows, its server
  residual zero; a step, a save, and a fresh engine at the same world
  takes the rows back bit for bit;
- ``back_body`` (4 ranks): ``s1``, ``tier`` and ``ptier`` loaded back at
  ZeRO-3 over data=2 x fsdp=2: every leaf and moment bit for bit ``s3``'s,
  and the third step's loss bit for bit the first run's.
"""

import json
import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch_dist_ranks as base  # noqa: E402
import torch_moe_ranks as moe  # noqa: E402

ROWS = 4                    # sequences a global micro-batch
STEPS = 3
S3_MESH = {"data": 2, "fsdp": 2}
COMPRESS = {"enabled": True}


def _out(name: str) -> str:
    return os.path.join(os.environ["DSTPU_TEST_OUT"], name)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _write(name: str, obj) -> None:
    if _rank() == 0:
        with open(_out(f"{name}.json"), "w") as f:
            json.dump(obj, f)


def llama_engine(stage: int, mesh: dict, seed: int = 0, **zero):
    """The tiny fp32 Llama under ``torch_dist_ranks``' fp32 recipe, ZeRO
    ``stage`` over ``mesh`` (``zero`` adds to the ZeRO group; a
    ``comm_compression`` key is the group of that name)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as tllama
    config = base.zero_config(stage, mesh, False, ROWS)
    cc = zero.pop("comm_compression", None)
    if cc is not None:
        config["comm_compression"] = cc
    config["zero_optimization"].update(zero)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(base.tiny_fp32(), device="cpu",
                                          seed=seed),
            config=config, device="cpu")
    return eng


def moe_engine(mesh: dict, rows: int, seed: int = 0):
    """The tiny fp32 Mixtral at ZeRO-1 over ``mesh``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.mixtral import MixtralForCausalLM
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=MixtralForCausalLM(moe.tiny_mixtral(), device="cpu",
                                     seed=seed),
            config=moe.engine_config(1, mesh, False, rows), device="cpu")
    return eng


def batches():
    return base.zero_batches(ROWS, STEPS)


def whole_state(engine) -> dict:
    """Every leaf file of ``engine``'s checkpoint as its whole array (every
    rank takes part in the gathers)."""
    from deepspeed_tpu_torch.checkpoint import engine as ckpt
    return {rel: w.detach().numpy().copy() for rel, w, _ in
            ckpt._whole_leaves(engine, ckpt.state_names(engine), keep=True)}


def apart_from_files(engine, tag_dir: str) -> list:
    """The leaf files whose whole array in ``engine`` differs from the
    file under ``tag_dir`` (bit for bit)."""
    return [rel for rel, arr in whole_state(engine).items()
            if not np.array_equal(np.load(os.path.join(tag_dir, rel)), arr)]


def _ef_rows(engine) -> dict:
    ef = engine.optimizer.state.error_feedback
    return {f"{b}/{part}": getattr(e, part).numpy().copy()
            for b, e in enumerate(ef) for part in ("worker", "server")}


def four_body():
    b = batches()
    eng = llama_engine(3, S3_MESH)
    for batch in b[:2]:
        eng.train_batch(batch=batch, stacked=True)
    eng.save_checkpoint(_out("s3"))
    found = {"s3_next_loss": float(eng.train_batch(batch=b[2],
                                                   stacked=True))}
    del eng
    cc = llama_engine(0, {"data": 4}, comm_compression=COMPRESS)
    for batch in b[:2]:
        cc.train_batch(batch=batch, stacked=True)
    cc.save_checkpoint(_out("cc4"))
    found["cc4_buckets"] = len(cc.optimizer.state.error_feedback)
    del cc
    arrays = {}
    # Mixtral's expert blocks and a tensor=2 engine, saved whole
    for name, make, batch in (
            ("moe", lambda: moe_engine({"expert": 2, "data": 2}, 8),
             moe.batches(8, 2)),
            ("tp", lambda: llama_engine(3, {"fsdp": 2, "tensor": 2,
                                            "data": 1}), b)):
        e = make()
        e.train_batch(batch=batch[0], stacked=True)
        e.save_checkpoint(_out(name))
        arrays.update({f"{name}/{n}": p.detach().numpy().copy()
                       for n, p in e.named_masters()})
        found[f"{name}_next_loss"] = float(e.train_batch(batch=batch[1],
                                                         stacked=True))
        found[f"{name}_expert_dims"] = [d is not None for d in e._expert_dim]
        found[f"{name}_tensor_dims"] = [d is not None for d in e._tensor_dim]
        del e
    if _rank() == 0:
        np.savez(_out("four_masters.npz"), **arrays)
    _write("four", found)


def two_body():
    b = batches()
    s3 = os.path.join(_out("s3"), "global_step2")
    found = {}
    for name, make in (
            ("s1", lambda: llama_engine(1, {"data": 2}, seed=5)),
            ("tier", lambda: llama_engine(
                2, {"fsdp": 2, "data": 1}, seed=6,
                offload_optimizer={"device": "cpu"})),
            ("ptier", lambda: llama_engine(
                0, {"data": 2}, seed=7,
                offload_param={"device": "cpu", "layers_per_group": 1},
                offload_optimizer={"device": "cpu"}))):
        eng = make()
        eng.load_checkpoint(_out("s3"))
        found[f"{name}_apart"] = apart_from_files(eng, s3)
        found[f"{name}_steps"] = eng.global_steps
        eng.save_checkpoint(_out(name))
        found[f"{name}_next_loss"] = float(eng.train_batch(batch=b[2],
                                                           stacked=True))
        if eng._param_offload is not None:
            eng._param_offload.close()
        del eng
    # comm_compression: data=4's residuals re-spread over data=2
    cc = llama_engine(0, {"data": 2}, comm_compression=COMPRESS)
    cc.load_checkpoint(_out("cc4"))
    root = os.path.join(_out("cc4"), "global_step2", "opt_state",
                        "error_feedback")
    worst = 0.0
    for key, got in _ef_rows(cc).items():
        saved = np.load(os.path.join(root, f"{key}.npy"))
        if key.endswith("worker"):
            fit = np.zeros((saved.shape[0], got.shape[0]), np.float32)
            m = min(saved.shape[1], got.shape[0])
            fit[:, :m] = saved[:, :m]
            want = fit.mean(axis=0)
        else:
            want = np.zeros_like(got)
        worst = max(worst, float(np.abs(got - want).max()))
    found["cc_respread_max_abs"] = worst
    cc.train_batch(batch=b[2], stacked=True)
    cc.save_checkpoint(_out("cc2"))
    again = llama_engine(0, {"data": 2}, comm_compression=COMPRESS, seed=9)
    again.load_checkpoint(_out("cc2"))
    live, back = _ef_rows(cc), _ef_rows(again)
    found["cc_same_world_bitwise"] = all(
        np.array_equal(live[k], back[k]) for k in live)
    found["cc_nonzero"] = any(bool(np.any(v)) for v in live.values())
    _write("two", found)


def back_body():
    b = batches()
    s3 = os.path.join(_out("s3"), "global_step2")
    found = {}
    for name in ("s1", "tier", "ptier"):
        eng = llama_engine(3, S3_MESH, seed=11)
        eng.load_checkpoint(_out(name))
        found[f"{name}_apart"] = apart_from_files(eng, s3)
        found[f"{name}_next_loss"] = float(eng.train_batch(batch=b[2],
                                                           stacked=True))
        del eng
    _write("back", found)
