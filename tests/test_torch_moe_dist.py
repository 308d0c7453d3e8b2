"""Port parity: MoE expert parallelism over ranks against the JAX engine.

The tiny Mixtral in fp32 with ``tests/torch_moe_ranks.py``'s trajectory
recipe (gas 2, AdamW with decay, clipping, WarmupLR), ``STEPS`` steps on
the same global batches, in gloo ranks spawned by
``deepspeed_tpu_torch.testing.run_distributed`` against
``deepspeed_tpu.initialize(..., tensor_rules=mixtral_tensor_rules)`` on an
explicit JAX mesh of the same shape over the first W of the 8 CPU
devices:

- ``expert=2`` (W=2), ``data=2, expert=2`` and ``fsdp=2, expert=2`` (the
  moments of every leaf, expert blocks included, sharded over fsdp) at
  ZeRO stage 1 (W=4): losses and gradient norms within rtol 1e-5, every
  master within 1e-5;
  each rank holds half of every expert leaf; the replicated masters bit
  for bit the same on every expert rank (no reduction over ``expert``
  makes them so); the same losses and norms on every rank.
- qgZ with ``data=2, expert=2``: the gating and the dispatch local to the
  replica shard, the int8 wire over ``data``; int8 codes may flip where
  the two sides' fp32 gradients straddle a rounding boundary, so at most
  0.1% of the elements beyond 1e-5, none beyond 2 lr a step.
- ``quantized_dispatch`` at ``data=2, expert=2``: ``MOELayer``'s output and
  every gradient against the JAX quantized layer's, within ``QUANT_TOL``
  of each tensor's largest magnitude, and the dense layer's within 1e-5;
  the JAX int8 layer's gradients are its dense layer's to the int8 error
  (the straight-through backward is the dense sum's transpose);
  the engine's trajectory with it beside the JAX engine's within the qgZ
  criterion.
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import deepspeed_tpu  # noqa: E402
from deepspeed_tpu.comm import mesh as jmesh  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.models import mixtral as jmix  # noqa: E402
from deepspeed_tpu.moe import sharded_moe as jmoe  # noqa: E402
from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import torch_moe_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 120
# [stage, mesh, qgz, quantized_dispatch]
W2_CASES = [[0, {"expert": 2, "data": 1}, False, False]]
W4_CASES = [[1, {"data": 2, "expert": 2}, False, False],
            [1, {"data": 2, "expert": 2}, True, False],
            [1, {"data": 2, "expert": 2}, False, True],
            [1, {"fsdp": 2, "expert": 2, "data": 1}, False, False]]
# the quantized layer against the JAX quantized layer: both quantize the
# same fp32 partials (equal to rounding) row by row, so the int8 codes are
# the same and the outputs and gradients agree to 1e-5 of each tensor's
# largest magnitude (a flipped code would move one by ~1/127 of it)
QUANT_TOL = 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict) else {name: v})
    return out


def _jcfg(quantized=False):
    import dataclasses
    cfg = jmix.TINY_MIXTRAL
    return dataclasses.replace(
        cfg, base=dataclasses.replace(cfg.base, dtype=jnp.float32),
        moe=dataclasses.replace(cfg.moe, dtype=jnp.float32,
                                quantized_dispatch=quantized))


def _jmesh(sizes):
    full = {a: sizes.get(a, 1) for a in jmesh.MESH_AXES}
    w = int(np.prod(list(full.values())))
    return Mesh(np.array(jax.devices()[:w]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)


@pytest.fixture(scope="module")
def flax_params():
    batch = jllama.random_tokens(1, 8, vocab_size=512)
    params = jmix.MixtralForCausalLM(_jcfg()).init(
        jax.random.PRNGKey(0), batch)["params"]
    return jax.tree.map(np.asarray, params)


def _jax_run(flax_params, stage, sizes, qgz, quantized):
    mesh = _jmesh(sizes)
    jmesh.set_global_mesh(mesh)
    w = mesh.size
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng, *_ = deepspeed_tpu.initialize(
            model=jmix.MixtralForCausalLM(_jcfg(quantized)),
            config=ranks.engine_config(stage, sizes, qgz, 2 * w),
            model_parameters=flax_params, mesh=mesh,
            tensor_rules=jmix.mixtral_tensor_rules)
    losses, norms = [], []
    for batch in ranks.batches(2 * w):
        losses.append(float(eng.train_batch(batch=batch, stacked=True)))
        norms.append(eng.get_global_grad_norm())
    return losses, norms, _flat(jax.tree.map(np.asarray,
                                             eng.module_state_dict()))


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def spawned(request, flax_params, tmp_path_factory):
    w = request.param
    cases = W2_CASES if w == 2 else W4_CASES
    out = tmp_path_factory.mktemp(f"moe{w}")
    np.savez(out / "params.npz", **_flat(flax_params))
    run_distributed(ranks.engine_body, w, timeout=SPAWN_TIMEOUT, device="cpu",
                    env={"DSTPU_TEST_OUT": str(out),
                         "DSTPU_TEST_CASES": json.dumps(cases)})
    per_rank = []
    for r in range(w):
        with open(out / f"moe{r}.json") as f:
            meta = json.load(f)
        per_rank.append((meta, dict(np.load(out / f"moe{r}.npz"))))
    return w, cases, per_rank


def _arrays(arrays, k, kind):
    pre = f"{k}/{kind}/"
    return {n[len(pre):].replace(".", "/"): v for n, v in arrays.items()
            if n.startswith(pre)}


def _close(got, want, loose):
    assert got.keys() == want.keys()
    if not loose:
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
        return
    diffs = np.concatenate([np.abs(got[n] - w).ravel()
                            for n, w in want.items()])
    assert diffs.max() <= 2 * 1e-3 * ranks.STEPS + 1e-6, diffs.max()
    assert np.mean(diffs > 1e-5) <= 1e-3, np.mean(diffs > 1e-5)


def test_expert_ranks_match_the_jax_engine(spawned, flax_params):
    w, cases, per_rank = spawned
    for k, (stage, sizes, qgz, quantized) in enumerate(cases):
        jl, jn, jm = _jax_run(flax_params, stage, sizes, qgz, quantized)
        meta0, arr0 = per_rank[0]
        row = meta0["cases"][k]
        loose = qgz or quantized
        rtol = 1e-3 if quantized else 1e-4 if qgz else 1e-5
        np.testing.assert_allclose(row["losses"], jl, rtol=rtol)
        np.testing.assert_allclose(row["norms"], jn, rtol=rtol)
        _close(_arrays(arr0, k, "full"), jm, loose)
        if qgz:
            assert row["qgz_axes"] == ["data"]
        for meta, arr in per_rank[1:]:      # every rank: the same result
            other = meta["cases"][k]
            assert other["losses"] == row["losses"]
            assert other["norms"] == row["norms"]
            full = _arrays(arr, k, "full")
            for name, v in _arrays(arr0, k, "full").items():
                np.testing.assert_array_equal(full[name], v, err_msg=name)


def test_replicated_masters_bit_identical_over_expert_ranks(spawned):
    """The leaves no rule shards are the same bytes on every expert rank of
    a batch shard, with no reduction over ``expert`` to make them so; each
    rank holds its half of every expert leaf and those halves differ."""
    w, cases, per_rank = spawned
    for k in range(len(cases)):
        by_data = {}
        for meta, arr in per_rank:
            c = meta["cases"][k]["coords"]
            by_data.setdefault((c["data"], c["fsdp"]), []).append(
                (c["expert"], meta["cases"][k], _arrays(arr, k, "held")))
        for group in by_data.values():
            assert sorted(e for e, _, _ in group) == [0, 1]
            (_, m0, h0), (_, m1, h1) = sorted(group, key=lambda g: g[0])
            expert = [n for n in h0 if "/experts/" in n]
            assert len(expert) == 3 * 2        # three stacks, two layers
            for name, v in h0.items():
                if name in expert:
                    assert v.shape[0] == 2     # 4 experts over 2 ranks
                    assert not np.array_equal(v, h1[name]), name
                else:
                    np.testing.assert_array_equal(v, h1[name], err_msg=name)
            assert m0["held"] == m1["held"]


def _layer_params(flax_layer):
    flat = _flat(flax_layer)
    return {n.replace("/", "."): v for n, v in flat.items()}


def _jax_layer(sizes, quantized):
    mesh = _jmesh(sizes)
    jmesh.set_global_mesh(mesh)
    cfg = jmoe.MoEConfig(num_experts=4, top_k=2, dtype=jnp.float32,
                         quantized_dispatch=quantized)
    x = jnp.asarray(ranks.layer_inputs())
    layer = jmoe.MOELayer(cfg, hidden_size=ranks.LAYER_SHAPE[-1],
                          intermediate_size=ranks.LAYER_FF)
    with mesh:
        params = jax.jit(lambda: layer.init(jax.random.PRNGKey(0), x,
                                            train=False))()

    def loss_fn(p, xx):
        out, aux = layer.apply(p, xx, train=False)
        return jnp.sum(out ** 2) + aux

    with mesh:
        out = jax.jit(lambda: layer.apply(params, x, train=False)[0])()
        gp, gx = jax.jit(lambda: jax.grad(loss_fn, argnums=(0, 1))(
            params, x))()
    return (jax.tree.map(np.asarray, params["params"]), np.asarray(out),
            np.asarray(gx), _layer_params(jax.tree.map(np.asarray,
                                                       gp["params"])))


def test_quantized_dispatch_matches_the_jax_quantized_layer(tmp_path):
    """``data=2, expert=2``: each rank's output rows and input-gradient
    rows, and the gradients summed over the data ranks (expert leaves: a
    rank's block), against the JAX layer with the int8 wire; the dense
    layer against the JAX dense layer within 1e-5."""
    sizes = {"data": 2, "expert": 2}
    params, *_ = _jax_layer(sizes, False)
    np.savez(tmp_path / "layer.npz", **_layer_params(params))
    run_distributed(ranks.layer_body, 4, timeout=SPAWN_TIMEOUT, device="cpu",
                    env={"DSTPU_TEST_OUT": str(tmp_path),
                         "DSTPU_TEST_MESH": json.dumps(sizes)})
    rows = []
    for r in range(4):
        with open(tmp_path / f"layer{r}.json") as f:
            rows.append((json.load(f)["coords"],
                         dict(np.load(tmp_path / f"layer{r}.npz"))))
    jax_runs = {q: _jax_layer(sizes, q) for q in (True, False)}
    # the reference's straight-through backward is the dense sum's
    # transpose: its int8 gradients are the dense ones to the int8 error
    for name, g in jax_runs[True][3].items():
        d = jax_runs[False][3][name]
        assert np.abs(g - d).max() <= 0.05 * np.abs(d).max(), name
        assert abs(float((g * d).sum() / (d * d).sum()) - 1) <= 5e-3, name
    for tag, quantized in (("q", True), ("d", False)):
        _, out, gx, gp = jax_runs[quantized]
        b = out.shape[0] // 2
        got_out = np.zeros_like(out)
        got_gx = np.zeros_like(gx)
        got_gp = {n: np.zeros_like(v) for n, v in gp.items()}
        for c, arr in rows:
            sl = slice(c["data"] * b, (c["data"] + 1) * b)
            if c["expert"] == 0:
                got_out[sl] = arr[f"{tag}/out"]
                got_gx[sl] = arr[f"{tag}/x_grad"]
            else:       # the expert ranks of a data shard agree exactly
                np.testing.assert_array_equal(got_out[sl], arr[f"{tag}/out"])
                np.testing.assert_array_equal(got_gx[sl],
                                              arr[f"{tag}/x_grad"])
            for n in gp:
                g = arr[f"{tag}/grad/{n}"]
                if n.startswith("experts."):
                    h = g.shape[0]
                    got_gp[n][c["expert"] * h:(c["expert"] + 1) * h] += g
                elif c["expert"] == 0:
                    got_gp[n] += g
        pairs = [("out", got_out, out), ("x_grad", got_gx, gx)] + \
            [(n, got_gp[n], gp[n]) for n in gp]
        for name, got, want in pairs:
            if quantized:
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err <= QUANT_TOL, (name, err)
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                           err_msg=name)
