"""Port parity: the micro-step protocol against the JAX package's.

DeepSpeed's loop, ``loss = engine(batch); engine.backward(loss);
engine.step()``, on ``deepspeed_tpu_torch``'s engine against the JAX
engine's compat shim (``deepspeed_tpu/runtime/engine.py:1814-1959``) on
the same weights and batches, all on the CPU:

- ``SimpleModel`` with SGD at gas 2 (``tests/test_engine.py:71``): the
  three-call loop against JAX's and against the port's ``train_batch``
  (rtol 1e-5, atol 1e-6; at one rank the loop is ``train_batch`` bit for
  bit);
- ``TINY_LLAMA`` in fp32 with the AdamW trajectory recipe at ZeRO stages
  0-3 (one rank, one JAX device): losses and norms within rtol 1e-4,
  masters within 1e-5, and the port's loop equal to its ``train_batch``
  bit for bit; fp16 whose loss scale overflows at the start: the same
  skipped steps and scales, losses within rtol 2e-4, the applied steps'
  norms within 5e-4, masters within 2 lr an applied step with at most
  0.15% of elements beyond 1e-3 (each ~4x the CPU's reading);
- over two gloo ranks (``tests/torch_micro_ranks.py``) against the JAX
  engine on a two-device mesh of the same shape: ``fsdp=2`` at stage 2,
  qgZ's int8 wire over ``data=2`` a micro-batch at a time, ``comm_
  compression`` over ``data=2`` with its residuals left untouched, and the
  optimizer tier at stage 1 over ``fsdp=2``. Losses and norms within rtol
  1e-4; masters within 1e-5, the wires by their criteria of
  ``test_torch_zero.py`` (qgZ) and ``test_torch_zeropp.py`` (the
  compressed buckets, divergence 39);
- under ``offload_param`` ``forward`` and ``step`` raise the JAX engine's
  message, and ``backward`` without a forward raises as JAX's does.
"""

import dataclasses
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.comm import mesh as jmesh  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.models import simple as jsimple  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.models import simple as tsimple  # noqa: E402
from deepspeed_tpu_torch.models.convert import to_flax_tree  # noqa: E402
from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import torch_micro_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 300


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


def _jmesh(sizes):
    full = {a: sizes.get(a, 1) for a in jmesh.MESH_AXES}
    w = int(np.prod(list(full.values())))
    return Mesh(np.array(jax.devices()[:w]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)


def _jcfg():
    return dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               attention_backend="xla")


@pytest.fixture(scope="module")
def flax_params():
    params = jllama.LlamaForCausalLM(_jcfg()).init(
        jax.random.PRNGKey(0), jllama.random_tokens(1, 8, 512))["params"]
    return jax.tree.map(np.asarray, params)


def _loop(eng, batches):
    """The three-call loop over each stacked batch's micro-batches: every
    micro-batch's loss and each step's gradient norm, loss scale and
    skipped count."""
    losses, norms, scales, skipped = [], [], [], []
    for batch in batches:
        for micro in ranks.micro_batches(batch):
            loss = eng(micro)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        norms.append(eng.get_global_grad_norm())
        scales.append(eng.cur_scale())
        skipped.append(int(eng.skipped_steps))
    return losses, norms, scales, skipped


# ---------------------------------------------------------------------------
# SimpleModel, tests/test_engine.py:71
# ---------------------------------------------------------------------------
def test_simple_model_loop_matches_jax_and_train_batch(mesh_dp8):
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "SGD", "params": {"lr": 0.1}}}
    jeng, *_ = deepspeed_tpu.initialize(
        model=jsimple.SimpleModel(hidden_dim=32), config=dict(cfg),
        mesh=mesh_dp8, example_batch=jsimple.random_batch(4), seed=11)
    params = jax.tree.map(np.asarray, jax.device_get(jeng.state.params))

    def port():
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tsimple.SimpleModel(hidden_dim=32, device="cpu"),
            config=dict(cfg), model_parameters=params, device="cpu")
        return eng

    loop, fused = port(), port()
    batches = [jsimple.random_batch(8, seed=s, gas=2) for s in (0, 2)]
    jl = _loop(jeng, batches)[0]
    tl = _loop(loop, batches)[0]
    for b in batches:
        fused.train_batch(batch=b)
    assert loop.global_steps == fused.global_steps == jeng.global_steps == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = _flat(jax.device_get(jeng.state.params))
    got = _flat(loop.get_params())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for (n, a), (_, b) in zip(loop.named_masters(), fused.named_masters()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# TINY_LLAMA, one rank
# ---------------------------------------------------------------------------
def _pair(flax_params, config, dtype=jnp.float32):
    jcfg = dataclasses.replace(_jcfg(), dtype=dtype)
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tdtype = {jnp.float32: torch.float32, jnp.float16: torch.float16}[dtype]
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=tdtype)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jllama.LlamaForCausalLM(jcfg), config=dict(config),
        model_parameters=flax_params, mesh=_jmesh({"data": 1}))

    def port():
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(tcfg, device="cpu"),
            config=json.loads(json.dumps(config)),
            model_parameters=flax_params, device="cpu")
        return eng

    return jeng, port


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_tiny_llama_loop_matches_jax_at_each_stage(flax_params, stage):
    config = ranks.base.zero_config(stage, {}, rows=2)
    del config["mesh"]
    jeng, port = _pair(flax_params, config)
    loop, fused = port(), port()
    batches = ranks.base.zero_batches(2, 3)
    jl, jn, _, _ = _loop(jeng, batches)
    tl, tn, _, _ = _loop(loop, batches)
    fl = [float(fused.train_batch(batch=b, stacked=True)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)
    # the loop's mean micro-batch loss is train_batch's
    np.testing.assert_allclose(np.mean(np.reshape(tl, (3, 2)), 1), fl,
                               rtol=1e-6)
    want = _flat(jax.device_get(jeng.module_state_dict()))
    got = _flat(to_flax_tree(loop.named_masters()))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    for (n, a), (_, b) in zip(loop.named_masters(), fused.named_masters()):
        assert torch.equal(a, b), n
    assert loop.micro_steps == fused.micro_steps == 6


def test_fp16_loop_skips_as_jax_does(flax_params):
    config = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "fp16": {"enabled": True, "initial_scale_power": 20,
                       "hysteresis": 1}}
    jeng, port = _pair(flax_params, config, dtype=jnp.float16)
    loop = port()
    batches = [jllama.random_tokens(2, 16, vocab_size=512, seed=100 + i,
                                    gas=2) for i in range(6)]
    jl, jn, js, jskip = _loop(jeng, batches)
    tl, tn, ts, tskip = _loop(loop, batches)
    assert tskip == jskip and ts == js
    assert tskip[0] == 1 and tskip[-1] < len(batches)   # overflowed, recovered
    # limits ~4x the CPU's readings: losses 4.2e-5 relative, applied steps'
    # norms 1.1e-4, masters 4.4e-3 at most (under 2 lr an applied step, the
    # fp16 trajectory's bound) with 3.7e-4 of the elements beyond 1e-3
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    applied = [i for i in range(len(batches))
               if tskip[i] == (tskip[i - 1] if i else 0)]
    assert applied
    np.testing.assert_allclose([tn[i] for i in applied],
                               [jn[i] for i in applied], rtol=5e-4)
    want = _flat(jax.device_get(jeng.module_state_dict()))
    got = _flat(to_flax_tree(loop.named_masters()))
    assert got.keys() == want.keys()
    diffs = np.concatenate([np.abs(got[n] - w).ravel()
                            for n, w in want.items()])
    assert diffs.max() <= 2 * 1e-3 * len(applied) + 1e-6
    assert np.mean(diffs > 1e-3) <= 1.5e-3


def test_param_offload_refuses_as_jax_does(flax_params):
    config = {"train_batch_size": 2, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "zero_optimization": {"stage": 0,
                                    "offload_param": {"device": "cpu"}}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng, port = _pair(flax_params, config)
        eng = port()
    micro = jllama.random_tokens(2, 16, vocab_size=512, seed=1)
    for api in ("forward", "step"):
        call = (lambda e: e.forward(micro)) if api == "forward" \
            else (lambda e: e.step())
        with pytest.raises(NotImplementedError) as want:
            call(jeng)
        with pytest.raises(NotImplementedError) as got:
            call(eng)
        assert str(got.value) == str(want.value)
    for e in (jeng, eng):
        with pytest.raises(RuntimeError, match="without a preceding forward"):
            e.backward()
    eng._param_offload.close()


# ---------------------------------------------------------------------------
# two gloo ranks against the JAX engine on a mesh of the same shape
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spawned(flax_params, tmp_path_factory):
    out = tmp_path_factory.mktemp("micro")
    np.savez(out / "params.npz", **_flat(flax_params))
    run_distributed(ranks.cases_body, 2, timeout=SPAWN_TIMEOUT, device="cpu",
                    env={"DSTPU_TEST_OUT": str(out),
                         "DSTPU_TEST_CASES": json.dumps(ranks.MICRO)})
    per_rank = []
    for r in range(2):
        with open(out / f"micro{r}.json") as f:
            meta = json.load(f)
        per_rank.append((meta, dict(np.load(out / f"micro{r}.npz"))))
    return per_rank


def jax_case(name, flax_params):
    """Case ``name`` through the JAX engine on its mesh: (micro losses or
    step losses, norms, flat masters)."""
    loop, _, sizes, _ = ranks.CASES[name]
    mesh = _jmesh(sizes)
    rules = jllama.llama_tensor_rules if "tensor" in sizes else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng, *_ = deepspeed_tpu.initialize(
            model=jllama.LlamaForCausalLM(_jcfg()),
            config=ranks.case_config(name), model_parameters=flax_params,
            mesh=mesh, tensor_rules=rules)
    batches = ranks.base.zero_batches(ranks.ROWS, ranks.STEPS)
    if loop == "micro":
        losses, norms, _, _ = _loop(eng, batches)
    else:
        losses, norms = [], []
        for b in batches:
            losses.append(float(eng.train_batch(batch=b, stacked=True)))
            norms.append(eng.get_global_grad_norm())
    masters = _flat(jax.device_get(eng.module_state_dict()))
    jmesh.set_global_mesh(None)
    return losses, norms, masters


def case_masters(arrays, name):
    return {k.split("/", 1)[1].replace(".", "/"): v
            for k, v in arrays.items() if k.startswith(f"{name}/")}


def wire_close(got, want, share, lr=1e-3, steps=ranks.STEPS):
    """A quantized wire's masters: no element beyond 2 lr a step, at most
    ``share`` of them beyond ``1e-5`` (``test_torch_zero.py`` under qgZ:
    one int8 code a step apart where the two sides' gradients straddle a
    rounding boundary) or a tenth of lr (``test_torch_zeropp.py``'s
    ``block_wire_close``: JAX quantizes on other chunks)."""
    diffs = np.concatenate([np.abs(got[n] - w).ravel()
                            for n, w in want.items()])
    assert diffs.max() <= 2 * lr * steps + 1e-6
    assert np.mean(diffs > share[0]) <= share[1]


@pytest.mark.parametrize("name", ranks.MICRO)
def test_loop_over_ranks_matches_jax(spawned, flax_params, name):
    jl, jn, jm = jax_case(name, flax_params)
    row = spawned[0][0]["cases"][name]
    got = case_masters(spawned[0][1], name)
    assert got.keys() == jm.keys()
    np.testing.assert_allclose(row["losses"], jl, rtol=1e-4)
    np.testing.assert_allclose(row["norms"], jn, rtol=1e-4)
    assert row["boundaries"] == [False, True] * ranks.STEPS
    assert row["global_steps"] == ranks.STEPS
    assert row["micro_steps"] == 2 * ranks.STEPS
    if name.endswith("qgz"):
        assert row["wire_axes"] == ["data"]
        wire_close(got, jm, (1e-5, 1e-3))
    elif name.endswith("compress"):
        assert row["wire_axes"] == ["data"]
        # error feedback is defined at the accumulation boundary only: the
        # loop leaves the residuals as they started
        assert row["ef_buckets"] > 0 and row["ef_untouched"]
        wire_close(got, jm, (1e-4, 1e-2))
    else:
        for n, w in jm.items():
            np.testing.assert_allclose(got[n], w, atol=1e-5, rtol=1e-5,
                                       err_msg=n)
    if name.endswith("offload_s1"):
        # the host block of a rank: half of each sharded leaf's moments
        assert row["host_steps"] == ranks.STEPS
        full = sum(v.size for v in jm.values())
        assert row["host_numel"] < full
    if name.endswith("s2"):
        assert any(d is not None for d in row["opt_dim"])
    for meta, _ in spawned[1:]:          # every rank the same losses
        other = meta["cases"][name]
        assert other["losses"] == row["losses"]
        assert other["norms"] == row["norms"]
