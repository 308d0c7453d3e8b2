"""Rank bodies of the port's tensor-parallel CPU tests.

``tests/test_torch_tp.py`` spawns four gloo ranks through
``deepspeed_tpu_torch.testing.run_distributed``; each rank imports this
module (torch only, never jax), runs ``tp_body`` and writes its results
to ``$DSTPU_TEST_OUT`` (``.npz`` arrays, ``.json`` scalars), which the
test holds against the JAX package run in the pytest process. The
planted faults are ``chip_smoke.tp_fault``'s and ``_swap_kv_blocks``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch_dist_ranks as base  # noqa: E402

STEPS = 3
ROWS = 4                    # sequences a micro-batch over the batch ranks
SEQ = 16
CHUNK = 12                  # the chunked loss's tokens a chunk (not a divisor)
LAYER = (16, 64, 16)        # ColumnParallelLinear in -> hidden -> RowParallelLinear out
# the training cases: name -> (model, stage, mesh, qgz, fault)
CASES = {
    "llama_s3_fsdp2_tp2": ("llama", 3, {"fsdp": 2, "tensor": 2, "data": 1},
                           False, None),
    "llama_s1_qgz_data2_tp2": ("llama", 1, {"data": 2, "tensor": 2}, True,
                               None),
    "qwen2_moe_s1_ep2_tp2": ("qwen2_moe", 1,
                             {"expert": 2, "tensor": 2, "data": 1}, False,
                             None),
    "fault_norm_all_tensor": ("llama", 3, {"fsdp": 2, "tensor": 2,
                                           "data": 1}, False,
                              "norm_all_tensor"),
    "fault_copy_dropped": ("llama", 3, {"fsdp": 2, "tensor": 2, "data": 1},
                           False, "copy_dropped"),
}


def _out(name: str) -> str:
    return os.path.join(os.environ["DSTPU_TEST_OUT"], name)


def tiny_llama(tie: bool = False):
    return dataclasses.replace(base.tiny_fp32(), tie_embeddings=tie)


def tiny_qwen2_moe():
    from deepspeed_tpu_torch.models.qwen2_moe import TINY_QWEN2_MOE
    cfg = TINY_QWEN2_MOE
    return dataclasses.replace(
        cfg, base=dataclasses.replace(cfg.base, dtype=torch.float32),
        moe=dataclasses.replace(cfg.moe, dtype=torch.float32))


def logits_batch():
    """Seeded ids whose first row opens at the vocabulary blocks' edges."""
    from deepspeed_tpu_torch.models.llama import random_tokens
    batch = random_tokens(2, SEQ, vocab_size=512, seed=11)
    batch["input_ids"][0, :4] = [0, 255, 256, 511]
    return batch


def layer_input():
    return np.random.default_rng(3).normal(size=(8, LAYER[0])).astype(
        np.float32)


def _blocks(model, full, t, tp=2):
    """Make this tensor rank's blocks of ``full`` (a flat state dict) the
    model's parameters."""
    from deepspeed_tpu_torch.models.convert import tp_shard
    blocks = tp_shard(full, type(model).tensor_rules, t, tp)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.data = torch.as_tensor(blocks[n]).clone()


def layers_case(t) -> dict:
    """``ColumnParallelLinear`` -> relu -> ``RowParallelLinear`` on this
    rank's blocks (cut by AutoTP's generic rules from ``layers.npz``):
    the output and the gradients of ``sum(out ** 2)``."""
    from deepspeed_tpu_torch.models.convert import tp_shard
    from deepspeed_tpu_torch.module_inject import (AutoTP,
                                                   ColumnParallelLinear,
                                                   RowParallelLinear)
    saved = dict(np.load(_out("layers.npz")))
    up = ColumnParallelLinear(LAYER[0], LAYER[1], device="cpu")
    down = RowParallelLinear(LAYER[1], LAYER[2], device="cpu")
    mods = {"up": up, "down": down}
    blocks = tp_shard({k: torch.from_numpy(v) for k, v in saved.items()},
                      AutoTP.infer_rules(), t, 2)
    with torch.no_grad():
        for name, v in blocks.items():
            mod, attr = name.split("/")
            getattr(mods[mod], attr).data = v.clone()
    x = torch.from_numpy(layer_input()).requires_grad_(True)
    out = down(torch.relu(up(x)))
    (out ** 2).sum().backward()
    res = {"layers/out": out.detach().numpy(), "layers/x_grad": x.grad.numpy()}
    for mod, m in mods.items():
        for attr, p in m.named_parameters():
            res[f"layers/grad/{mod}/{attr}"] = p.grad.numpy()
    return res


def logits_cases(t) -> dict:
    """The tiny fp32 Llama on this rank's blocks of the flax weights: the
    whole logits, the loss and each block's gradient, tied and untied,
    and with the chunked loss (untied); then the planted faults of the
    serving gate; the comms logger's bytes of the sound forward."""
    import chip_smoke
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.models.convert import flat_params
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    batch = {k: torch.from_numpy(v) for k, v in logits_batch().items()}
    res, meta = {}, {}
    comms = get_comms_logger()
    for tag, tie in (("untied", False), ("tied", True)):
        params = base._unflatten(dict(np.load(_out(f"params_{tag}.npz"))))
        full = {k: torch.from_numpy(np.asarray(v)) for k, v in
                flat_params(params).items()}
        for fault in (None, "kv_wrong_rank", "wo_reduce_dropped"):
            if tie and fault:
                continue
            m = LlamaForCausalLM(tiny_llama(tie), device="cpu")
            _blocks(m, chip_smoke._swap_kv_blocks(full)
                    if fault == "kv_wrong_rank" else full, t)
            comms.configure(enabled=fault is None and not tie)
            comms.reset()
            with chip_smoke.tp_fault(fault, m):
                with torch.no_grad():
                    logits = m.logits(batch)
            if fault is None and not tie:
                meta["comm"] = {op: int(v["bytes"]) for op, v in
                                comms.per_op_totals().items() if v["count"]}
            comms.configure(enabled=False)
            key = f"logits/{tag}/{fault or 'sound'}"
            res[key] = logits.numpy()
            if fault is None:
                loss = m(batch)
                loss.backward()
                res[f"loss/{tag}"] = loss.detach().numpy()
                for n, p in m.named_parameters():
                    res[f"grad/{tag}/{n}"] = p.grad.numpy()
        if not tie:                  # the chunked loss on the vocab blocks
            m = LlamaForCausalLM(dataclasses.replace(
                tiny_llama(), loss_chunk_size=CHUNK), device="cpu")
            _blocks(m, full, t)
            loss = m(batch)
            loss.backward()
            res["loss/chunked"] = loss.detach().numpy()
            for n, p in m.named_parameters():
                res[f"grad/chunked/{n}"] = p.grad.numpy()
    cfg = tiny_llama()
    meta["expected_comm"] = chip_smoke.expected_tp_infer_comm(
        cfg, 2, SEQ, 4)
    return res, meta


def infer_case() -> dict:
    """``init_inference`` at tp_size 2 (AutoTP resolves the rules) on the
    flax tree: the whole fp32 logits."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm.mesh import get_global_mesh
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    params = base._unflatten(dict(np.load(_out("params_untied.npz"))))
    eng = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(tiny_llama(), device="cpu"),
        config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
        params=params, mesh=get_global_mesh(), device="cpu")
    held = sum(p.numel() for p in eng.module.parameters())
    return {"infer/logits": eng.forward(logits_batch()).numpy()}, held


def train_case(name, params_llama, params_qwen) -> dict:
    """STEPS ``train_batch`` steps of case ``name``: losses, norms, the
    full masters, the digest of the replicated masters after each step,
    this rank's coordinates."""
    import warnings
    import chip_smoke
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoEForCausalLM
    model, stage, mesh, qgz, fault = CASES[name]
    if model == "llama":
        m = LlamaForCausalLM(tiny_llama(), device="cpu")
        params = params_llama
    else:
        m = Qwen2MoEForCausalLM(tiny_qwen2_moe(), device="cpu")
        params = params_qwen
    with warnings.catch_warnings(), chip_smoke.tp_fault(
            fault if fault == "copy_dropped" else None, m):
        warnings.simplefilter("ignore", UserWarning)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=m, config=base.zero_config(stage, mesh, qgz, ROWS),
            model_parameters=params, device="cpu")
        losses, norms, digests = [], [], []
        with chip_smoke.tp_fault(fault if fault == "norm_all_tensor"
                                 else None, engine=eng):
            for batch in base.zero_batches(ROWS, STEPS):
                losses.append(float(eng.train_batch(batch=batch,
                                                    stacked=True)))
                norms.append(eng.get_global_grad_norm())
                digests.append(chip_smoke._replicated_digest(eng))
    masters = {n: p.detach().numpy().copy() for n, p in eng.named_masters()}
    row = {"losses": losses, "norms": norms, "digests": digests,
           "coords": dict(eng.mesh.coords),
           "tensor_dims": eng._tensor_dim, "param_dims": eng._param_dim,
           "qgz_axes": list(eng._qgz_axes),
           "held": sum(p.numel() for p in eng._masters),
           "shapes": {n: list(p.shape) for n, p in
                      zip(eng._param_names, eng._masters)}}
    return row, masters


def tp_body():
    """Every case on this rank of four: the layers, the logits and their
    faults, ``init_inference`` (mesh data=2 x tensor=2), then the
    training cases of CASES; rank r writes ``tp{r}.json`` and
    ``tp{r}.npz`` (rank 0: the training cases' masters)."""
    import torch.distributed as dist
    r = dist.get_rank()
    mesh = base._mesh(data=2, tensor=2)
    t = mesh.coords["tensor"]
    arrays = layers_case(t)
    res, meta = logits_cases(t)
    arrays.update(res)
    res, held = infer_case()
    arrays.update(res)
    meta.update(rank=r, coords=dict(mesh.coords), infer_held=held, cases={})
    params_llama = base._unflatten(dict(np.load(_out("params_untied.npz"))))
    params_qwen = base._unflatten(dict(np.load(_out("params_qwen.npz"))))
    for name in CASES:
        row, masters = train_case(name, params_llama, params_qwen)
        meta["cases"][name] = row
        if r == 0:
            arrays.update({f"masters/{name}/{n}": v
                           for n, v in masters.items()})
    np.savez(_out(f"tp{r}.npz"), **arrays)
    with open(_out(f"tp{r}.json"), "w") as f:
        json.dump(meta, f)


# ---------------------------------------------------------------------------
# dimensions the tensor axis does not divide (ROADMAP Queue 3, fault B)
# ---------------------------------------------------------------------------
# tag -> the TINY_LLAMA fields changed: an odd vocabulary (the embedding
# and the head whole on each rank), an odd intermediate (the MLP whole)
INDIVISIBLE = {"vocab513": {"vocab_size": 513},
               "inter255": {"intermediate_size": 255}}


def indivisible_cfg(tag):
    return dataclasses.replace(tiny_llama(), **INDIVISIBLE[tag])


def indivisible_batch(vocab):
    """Seeded ids whose first row holds the vocabulary's edges and its
    last id (the one a block of 256 would leave out)."""
    from deepspeed_tpu_torch.models.llama import random_tokens
    batch = random_tokens(2, SEQ, vocab_size=vocab, seed=11)
    batch["input_ids"][0, :4] = [0, 255, 256, vocab - 1]
    return batch


def indivisible_body():
    """At ``tensor=2`` over two ranks, each INDIVISIBLE config on the flax
    tree ``params_{tag}.npz``: ``init_inference``'s whole logits (and the
    warnings of the cut), then STEPS ``train_batch`` steps at stage 0
    (losses, norms, rank 0's masters); ``indiv{r}.json`` / ``.npz``."""
    import warnings
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    r = dist.get_rank()
    mesh = base._mesh(tensor=2, data=1)
    arrays, meta = {}, {"rank": r}
    for tag in INDIVISIBLE:
        cfg = indivisible_cfg(tag)
        params = base._unflatten(dict(np.load(_out(f"params_{tag}.npz"))))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = deepspeed_tpu_torch.init_inference(
                LlamaForCausalLM(cfg, device="cpu"),
                config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
                params=params, mesh=mesh, device="cpu")
        arrays[f"{tag}/logits"] = eng.forward(
            indivisible_batch(cfg.vocab_size)).numpy()
        shapes = {n: list(p.shape) for n, p in eng.module.named_parameters()}
        del eng
        m = LlamaForCausalLM(cfg, device="cpu")
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=m, config=base.zero_config(0, {"tensor": 2, "data": 1},
                                             False, ROWS),
            model_parameters=params, device="cpu")
        losses, norms = [], []
        for batch in base.zero_batches(ROWS, STEPS):
            losses.append(float(eng.train_batch(batch=batch, stacked=True)))
            norms.append(eng.get_global_grad_norm())
        meta[tag] = {"warnings": sorted({str(w.message) for w in caught
                                         if "not divisible" in
                                         str(w.message)}),
                     "shapes": shapes, "losses": losses, "norms": norms,
                     "tensor_dims": eng._tensor_dim}
        masters = eng.named_masters()      # every rank: it gathers
        if r == 0:
            arrays.update({f"{tag}/masters/{n}": p.detach().numpy().copy()
                           for n, p in masters})
    np.savez(_out(f"indiv{r}.npz"), **arrays)
    with open(_out(f"indiv{r}.json"), "w") as f:
        json.dump(meta, f)
