"""Port parity: dimensions the tensor axis does not divide (ROADMAP Queue
3, fault B) against the JAX package.

The JAX package's spec builder drops an annotated axis that does not
divide its dimension, warns, and replicates that dimension
(``deepspeed_tpu/runtime/zero/partition.py:84-89``); its
``init_inference`` and engine then run the model with those leaves whole.
The port's ``models/convert.py::tp_shard`` passes such a leaf through
whole with one warning, and the model runs a whole embedding, head or MLP
on its plain path at any tensor size (no vocab-parallel lookup or loss,
no row sum). Two gloo ranks run ``tests/torch_tp_ranks.py::
indivisible_body`` at ``tensor=2``, ``TINY_LLAMA`` in fp32 with an odd
vocabulary (513) and, separately, an odd intermediate (255):

- ``init_inference`` at ``tp_size`` 2: the whole logits against JAX's
  ``init_inference`` on the same flax weights (2e-3,
  ``tests/test_module_inject.py``), the cut's warnings, each rank holding
  the whole leaves the axis does not divide and its blocks of the rest;
- ``train_batch`` at stage 0, 3 steps: losses and norms within rtol 1e-5
  of JAX's engine on a ``tensor=2`` mesh, the masters within 1e-5
  (divergence 26).

Heads the axis does not divide still raise (divergence 42,
``tests/test_torch_tp.py``).
"""

import dataclasses
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
from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import torch_tp_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 180
TAGS = list(ranks.INDIVISIBLE)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict) else {name: v})
    return out


def _jcfg(tag):
    return dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               attention_backend="xla",
                               **ranks.INDIVISIBLE[tag])


@pytest.fixture(scope="module")
def flax_params():
    return {tag: jax.tree.map(np.asarray, jllama.LlamaForCausalLM(
        _jcfg(tag)).init(jax.random.PRNGKey(0), jllama.random_tokens(
            1, 8, vocab_size=512))["params"]) for tag in TAGS}


@pytest.fixture(scope="module")
def spawned(flax_params, tmp_path_factory):
    out = tmp_path_factory.mktemp("indivisible")
    for tag, params in flax_params.items():
        np.savez(out / f"params_{tag}.npz", **_flat(params))
    run_distributed(ranks.indivisible_body, 2, timeout=SPAWN_TIMEOUT,
                    device="cpu", env={"DSTPU_TEST_OUT": str(out)})
    per_rank = []
    for r in range(2):
        with open(out / f"indiv{r}.json") as f:
            meta = json.load(f)
        per_rank.append((meta, dict(np.load(out / f"indiv{r}.npz"))))
    return per_rank


def _jmesh():
    full = {a: 1 for a in jmesh.MESH_AXES}
    full["tensor"] = 2
    return Mesh(np.array(jax.devices()[:2]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)


@pytest.mark.parametrize("tag", TAGS)
def test_init_inference_matches_jax(spawned, flax_params, tag):
    """JAX's ``init_inference`` at ``tp_size`` 2 replicates the leaves it
    cannot cut; the port's warns once a leaf, holds them whole, and both
    ranks return the same whole logits within 2e-3 of JAX's."""
    cfg = _jcfg(tag)
    model = jllama.LlamaForCausalLM(cfg)
    batch = ranks.indivisible_batch(cfg.vocab_size)
    mesh = _jmesh()
    jmesh.set_global_mesh(mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = deepspeed_tpu.init_inference(
            lambda p, b: model.apply({"params": p}, b,
                                     method=jllama.LlamaForCausalLM.logits),
            config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
            params=flax_params[tag], mesh=mesh,
            tensor_rules=jllama.llama_tensor_rules)
        want = np.asarray(eng.forward(batch))
    jmesh.set_global_mesh(None)
    whole = ("embed", "lm_head") if tag == "vocab513" else \
        ("w_gate", "w_up", "w_down")
    full = {k.replace("/", "."): v.shape
            for k, v in _flat(flax_params[tag]).items()}
    for meta, arr in spawned:
        np.testing.assert_allclose(arr[f"{tag}/logits"], want, rtol=2e-3,
                                   atol=2e-3)
        assert want.shape[-1] == cfg.vocab_size
        warned = meta[tag]["warnings"]
        assert warned and all("replicating that dim" in w for w in warned)
        assert all(any(k in w for k in whole) for w in warned)
        for name, shape in meta[tag]["shapes"].items():
            if any(f"{k}." in name for k in whole):
                assert tuple(shape) == full[name], name
            if ".wq." in name:
                assert shape[1] == cfg.num_heads // 2, name
    np.testing.assert_array_equal(spawned[0][1][f"{tag}/logits"],
                                  spawned[1][1][f"{tag}/logits"])


@pytest.mark.parametrize("tag", TAGS)
def test_training_matches_the_jax_engine(spawned, flax_params, tag):
    """Stage 0 at ``tensor=2``: the whole leaves take no tensor dim, the
    heads do; losses and norms within rtol 1e-5 of JAX's engine on a
    ``tensor=2`` mesh, every rank the same; the masters within 1e-5."""
    mesh = _jmesh()
    jmesh.set_global_mesh(mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng, *_ = deepspeed_tpu.initialize(
            model=jllama.LlamaForCausalLM(_jcfg(tag)),
            config=ranks.base.zero_config(0, {"tensor": 2, "data": 1},
                                          False, ranks.ROWS),
            model_parameters=flax_params[tag], mesh=mesh,
            tensor_rules=jllama.llama_tensor_rules)
        losses, norms = [], []
        for batch in ranks.base.zero_batches(ranks.ROWS, ranks.STEPS):
            losses.append(float(eng.train_batch(batch=batch, stacked=True)))
            norms.append(eng.get_global_grad_norm())
    jmesh.set_global_mesh(None)
    want = _flat(jax.tree.map(np.asarray, eng.module_state_dict()))
    meta0, arr0 = spawned[0]
    row = meta0[tag]
    np.testing.assert_allclose(row["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(row["norms"], norms, rtol=1e-5)
    assert spawned[1][0][tag]["losses"] == row["losses"]
    assert any(d is not None for d in row["tensor_dims"])
    pre = f"{tag}/masters/"
    got = {k[len(pre):].replace(".", "/"): v for k, v in arr0.items()
           if k.startswith(pre)}
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5, rtol=1e-5,
                                   err_msg=k)
