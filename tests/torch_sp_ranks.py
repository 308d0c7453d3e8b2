"""Rank bodies of the port's sequence-parallel CPU tests.

``tests/test_torch_sequence.py`` spawns gloo ranks through
``deepspeed_tpu_torch.testing.run_distributed``; each rank imports this
module (torch only, never jax), runs one body over the cases in
``$DSTPU_TEST_CASES`` and writes its results to ``$DSTPU_TEST_OUT``, which
the test then holds against the JAX package run in the pytest process. The
inputs are global arrays made from a seed with numpy; each rank takes its
contiguous block of the sequence.
"""

import json
import os

import numpy as np
import torch

import torch_dist_ranks as dist_ranks

ENGINE_STEPS = 3
ENGINE_SEQ = 32
ENGINE_ROWS = 2          # sequences a micro-batch (one a data rank)
ENGINE_MESH = {"data": 2, "sequence": 2}
ENGINE_MESH_SP2 = {"data": 1, "sequence": 2}


def _out(name: str) -> str:
    return os.path.join(os.environ["DSTPU_TEST_OUT"], name)


def make_qkv(b=2, s=64, h=4, hkv=None, d=16, seed=0):
    """Seeded global q, k, v (fp32 numpy), as ``tests/test_attention.py``."""
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    return q, k, v


def make_segments(b: int, s: int) -> np.ndarray:
    """Packed-sequence ids ``[B, S]``: three segments a row, their bounds
    differing between rows and between the sequence ranks' blocks."""
    pos = np.arange(s)
    rows = []
    for r in range(b):
        cut1, cut2 = (s * (3 + r)) // 10, (s * (7 - r)) // 10
        rows.append((pos >= cut1).astype(np.int32) + (pos >= cut2))
    return np.stack(rows).astype(np.int32)


def reference_attention(q, k, v):
    """The custom ``local_attention`` of the DistributedAttention cases:
    the reference attention, causal."""
    from deepspeed_tpu_torch.ops.flash_attention import attention_reference
    return attention_reference(q, k, v, causal=True)


def _block(x: np.ndarray, r: int, w: int) -> np.ndarray:
    n = x.shape[1] // w
    return x[:, r * n:(r + 1) * n]


def _mesh(**sizes):
    from deepspeed_tpu_torch.comm.mesh import create_mesh, set_global_mesh
    from deepspeed_tpu_torch.config.config import MeshConfig
    mesh = create_mesh(MeshConfig(**sizes), device=torch.device("cpu"))
    set_global_mesh(mesh)
    return mesh


def run_case(case: dict, r: int, w: int):
    """One attention case on this rank: (out, dq, dk, dv) of its block, the
    gradients those of ``sum(out ** 2)`` over the whole sequence, and the
    shapes a custom local attention saw."""
    from deepspeed_tpu_torch.sequence import layer, ring, ulysses
    q, k, v = make_qkv(case["b"], case["s"], case["h"], case["hkv"],
                       seed=case["seed"])
    qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(_block(x, r, w)))
                  .requires_grad_(True) for x in (q, k, v))
    seg = None
    if case.get("seg"):
        seg = torch.from_numpy(np.ascontiguousarray(
            _block(make_segments(case["b"], case["s"]), r, w)))
    seen = []
    kind = case["kind"]
    if kind == "ring":
        out = ring.ring_attention(qt, kt, vt, causal=case["causal"],
                                  impl=case["impl"], segment_ids=seg)
    elif kind == "ulysses":
        out = ulysses.ulysses_attention(qt, kt, vt, causal=case["causal"],
                                        segment_ids=seg,
                                        ring_impl=case.get("ring_impl"),
                                        window=case.get("window"))
    else:                                   # DistributedAttention
        def fn(qq, kk, vv, note=None):
            seen.append([list(qq.shape), list(kk.shape), note])
            return reference_attention(qq, kk, vv)
        out = layer.DistributedAttention(fn)(qt, kt, vt, note="hi")
    (out ** 2).sum().backward()
    return [out.detach(), qt.grad, kt.grad, vt.grad], seen


def _refusals(w: int) -> dict:
    """The messages of the refused calls at a ``sequence`` = ``w`` mesh
    (the model's and the MoE layer's at ``w`` = 2 only)."""
    import dataclasses
    from deepspeed_tpu_torch.models import llama as tllama
    from deepspeed_tpu_torch.sequence import ring, ulysses
    q, k, v = (torch.zeros(1, 8, 5, 16) for _ in range(3))   # 5 heads: uneven
    seg = torch.zeros(1, 8, dtype=torch.int32)
    calls = {
        "ring_xla_segments": lambda: ring.ring_attention(
            q, k, v, impl="xla", segment_ids=seg),
        "ulysses_segments_uneven": lambda: ulysses.ulysses_attention(
            q, k, v, segment_ids=seg),
        "ulysses_segments_attn_fn": lambda: ulysses.ulysses_attention(
            q[:, :, :4], k[:, :, :4], v[:, :, :4], segment_ids=seg,
            attn_fn=reference_attention),
    }
    if w == 2:
        ids = torch.zeros(1, 16, dtype=torch.int32)
        batch = {"input_ids": ids, "labels": ids,
                 "loss_mask": torch.ones(1, 16)}

        def model_loss(batch=batch, **kw):
            cfg = dataclasses.replace(dist_ranks.tiny_fp32(), **kw)
            return tllama.LlamaForCausalLM(cfg, device="cpu")(batch)

        def moe(engine: bool):
            import deepspeed_tpu_torch
            from deepspeed_tpu_torch.models import mixtral
            cfg = mixtral.TINY_MIXTRAL
            cfg = dataclasses.replace(cfg, base=dataclasses.replace(
                cfg.base, attention_backend="ulysses"))
            model = mixtral.MixtralForCausalLM(cfg, device="cpu")
            if engine:
                deepspeed_tpu_torch.initialize(
                    model=model, config=engine_config(ENGINE_MESH_SP2),
                    device="cpu")
            else:
                model({"input_ids": ids, "labels": ids,
                       "loss_mask": torch.ones(1, 16)})
        calls.update({
            "model_flash_backend": lambda: model_loss(
                attention_backend="flash"),
            "model_xla_backend": lambda: model_loss(attention_backend="xla"),
            "model_ring_window": lambda: model_loss(attention_backend="ring",
                                                    sliding_window=4),
            "model_no_labels": lambda: model_loss(
                batch={"input_ids": ids}, attention_backend="ulysses"),
            "moe_layer": lambda: moe(False),
            "moe_engine": lambda: moe(True),
        })
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:            # noqa: BLE001 (recorded, checked)
            out[name] = f"{type(e).__name__}: {e}"
    return out


def attention_body():
    """Every case of ``$DSTPU_TEST_CASES`` at a mesh of ``sequence`` = the
    world; rank r writes ``attn{r}.npz`` (``{i}/out``, ``{i}/dq``, ...) and
    ``attn{r}.json`` (the shapes the custom attentions saw, the refusals,
    and the ``sequence/*`` comm ops counted by the comms logger)."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    r, w = dist.get_rank(), dist.get_world_size()
    _mesh(sequence=w)
    comms = get_comms_logger()
    comms.configure(enabled=True)
    arrays, seen, ops = {}, {}, {}
    for i, case in enumerate(json.loads(os.environ["DSTPU_TEST_CASES"])):
        comms.reset()
        outs, seen[i] = run_case(case, r, w)
        for name, t in zip(("out", "dq", "dk", "dv"), outs):
            arrays[f"{i}/{name}"] = t.numpy()
        ops[i] = {op: int(t["count"]) for op, t in
                  comms.per_op_totals().items()}
    comms.configure(enabled=False)
    extra = {"refusals": _refusals(w)}
    if w == 2:
        extra["launches"] = launch_counts()
        arrays.update(vocab_ce())
    np.savez(_out(f"attn{r}.npz"), **arrays)
    with open(_out(f"attn{r}.json"), "w") as f:
        json.dump({"seen": seen, "ops": ops, **extra}, f)


def vocab_ce_inputs(seed: int = 3, b: int = 2, s: int = 5, v: int = 40):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, s, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    return logits, labels


def vocab_ce() -> dict:
    """``vocab_parallel_cross_entropy`` at ``tensor`` = the world: this
    rank's block of the vocab; the per-token loss and the gradient of its
    sum with respect to the block."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.sequence.cross_entropy import (
        vocab_parallel_cross_entropy)
    r, w = dist.get_rank(), dist.get_world_size()
    mesh = _mesh(tensor=w)
    logits, labels = vocab_ce_inputs()
    vp = logits.shape[-1] // w
    x = torch.from_numpy(np.ascontiguousarray(
        logits[..., r * vp:(r + 1) * vp])).requires_grad_(True)
    loss = vocab_parallel_cross_entropy(x, torch.from_numpy(labels), mesh)
    loss.sum().backward()
    return {"vce/loss": loss.detach().numpy(), "vce/grad": x.grad.numpy()}


# ---------------------------------------------------------------------------
# the flash launches and sequence/* bytes of a train_sp step
# ---------------------------------------------------------------------------
LAUNCH_SEQ = 32
LAUNCH_CHUNK = 16
#: (name, attention backend, ring impl, loss_chunk_size): chip_smoke's
#: train_sp variants
SP_VARIANTS = (("ulysses", "ulysses", None, None),
               ("ring", "ring", "flash", None),
               ("ring_contiguous", "ring", "flash_contiguous", None),
               ("ring_chunked_loss", "ring", "flash", LAUNCH_CHUNK))


def launch_counts() -> dict:
    """One train_batch step of each train_sp variant at the tiny fp32
    model with the recipe's remat, on this rank's CPU: the calls of the
    flash wrappers (their plain versions run here) and the comms logger's
    ``sequence/*`` bytes."""
    import dataclasses
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.models import llama as tllama
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.sequence import ring
    calls = {"flash_fwd": 0, "flash_bwd": 0}
    saved = fa.flash_fwd, fa.flash_bwd

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    fa.flash_fwd = counted("flash_fwd", saved[0])
    fa.flash_bwd = counted("flash_bwd", saved[1])
    comms = get_comms_logger()
    out = {}
    try:
        for name, backend, impl, chunk in SP_VARIANTS:
            cfg = dataclasses.replace(
                dist_ranks.tiny_fp32(), attention_backend=backend,
                remat=True, remat_policy="dots_with_no_batch_dims_saveable",
                loss_chunk_size=chunk)
            eng, *_ = deepspeed_tpu_torch.initialize(
                model=tllama.LlamaForCausalLM(cfg, device="cpu"),
                config={"train_batch_size": 1,
                        "optimizer": {"type": "AdamW",
                                      "params": {"lr": 1e-3}},
                        "mesh": ENGINE_MESH_SP2},
                device="cpu")
            batch = tllama.random_tokens(1, LAUNCH_SEQ, vocab_size=512,
                                         seed=7)
            for key in calls:
                calls[key] = 0
            comms.configure(enabled=True)
            comms.reset()
            with ring.default_impl(impl):
                eng.train_batch(batch=batch)
            out[name] = {
                "calls": dict(calls),
                "bytes": {op: int(t["bytes"]) for op, t in
                          comms.per_op_totals().items()
                          if op.startswith("sequence/")}}
            comms.configure(enabled=False)
    finally:
        fa.flash_fwd, fa.flash_bwd = saved
    return out


# ---------------------------------------------------------------------------
# the engine over data x sequence ranks
# ---------------------------------------------------------------------------
def engine_batches(steps: int = ENGINE_STEPS, mask: bool = False):
    """Seeded global batches ``[gas 2, ENGINE_ROWS, ENGINE_SEQ]``; with
    ``mask``, a ``loss_mask`` that keeps the same 21 positions of every row
    (4 in the first sequence rank's block, 16 in the second after the
    next-token shift): the data ranks' counts are equal, the sequence
    ranks' are not."""
    from deepspeed_tpu_torch.models import llama as tllama
    out = []
    for i in range(steps):
        b = tllama.random_tokens(ENGINE_ROWS, ENGINE_SEQ, vocab_size=512,
                                 seed=200 + i, gas=2)
        if mask:
            m = np.zeros(b["input_ids"].shape, np.int32)
            m[..., 12:] = 1
            m[..., 5] = 0
            b["loss_mask"] = m
        out.append(b)
    return out


def engine_config(mesh=None) -> dict:
    """``torch_dist_ranks.zero_config``'s recipe (gas 2) at stage 0 over
    ``mesh``."""
    return dist_ranks.zero_config(0, mesh or ENGINE_MESH, rows=ENGINE_ROWS)


def engine_body():
    """The cases of ``$DSTPU_TEST_CASES`` (``[backend, mask,
    local_positions]``) on a ``data=2 x sequence=2`` mesh: the tiny fp32
    Llama from the flax weights in ``params.npz``, ENGINE_STEPS steps;
    ``local_positions`` is the planted fault: every rank rotates with
    ``arange(S_l)``. Each rank writes its losses, norms and full masters."""
    import dataclasses
    import warnings
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as tllama
    r = dist.get_rank()
    params = dist_ranks._unflatten(dict(np.load(_out("params.npz"))))
    summary, arrays = [], {}
    for k, (backend, mask, local_positions) in enumerate(
            json.loads(os.environ["DSTPU_TEST_CASES"])):
        cfg = dataclasses.replace(dist_ranks.tiny_fp32(),
                                  attention_backend=backend)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            eng, *_ = deepspeed_tpu_torch.initialize(
                model=tllama.LlamaForCausalLM(cfg, device="cpu"),
                config=engine_config(), model_parameters=params,
                device="cpu")
        losses, norms = [], []
        for batch in engine_batches(mask=mask):
            if local_positions:
                s_l = ENGINE_SEQ // ENGINE_MESH["sequence"]
                batch["positions"] = np.broadcast_to(
                    np.tile(np.arange(s_l, dtype=np.int32),
                            ENGINE_MESH["sequence"]),
                    batch["input_ids"].shape).copy()
            losses.append(float(eng.train_batch(batch=batch, stacked=True)))
            norms.append(eng.get_global_grad_norm())
        summary.append({"losses": losses, "norms": norms,
                        "coords": dict(eng.mesh.coords)})
        for n, p in eng.named_masters():
            arrays[f"{k}/{n}"] = p.detach().numpy().copy()
    np.savez(_out(f"engine{r}.npz"), **arrays)
    with open(_out(f"engine{r}.json"), "w") as f:
        json.dump({"cases": summary}, f)
