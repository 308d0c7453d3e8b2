"""Port parity: the optimizers other than Adam against optax and the JAX
engine.

- Each reference name (``deepspeed_tpu/ops/optimizers.py:56-72``: LAMB,
  Lion, Adagrad, SGD / momentum with and without Nesterov, RMSprop with
  and without momentum) built by the port and by the JAX package, 4 steps
  under a schedule on the same parameters and gradients, with weight
  decay where the optimizer takes it: parameters within rtol 1e-5 / atol
  1e-6 of optax's, the update count 4; LAMB with an all-zero leaf (its
  trust ratio is 1). ``state_dict`` / ``load_state_dict`` carry the state:
  a restored optimizer steps as the original does, bit for bit. The 1-bit
  names raise ``NotImplementedError`` naming ROADMAP Queue 1 item 7.
- Each optimizer through the engine on ``TINY_LLAMA`` in fp32 (one rank,
  one JAX device), 3 ``train_batch`` steps: losses within rtol 1e-4, the
  masters within 1e-5 of the JAX engine's; Lion's sign update by the
  criterion of ``masters_close``.
- LAMB over two gloo ranks (``tests/torch_micro_ranks.py``) at stage 1
  and stage 3 over ``fsdp=2`` and at ``tensor=2``, against the JAX engine
  on the same mesh (masters within 1e-5): the trust ratio takes the norm
  of each whole leaf, its blocks' squares summed over the ranks that cut
  it. A planted fault, the ratio from each rank's block alone at stage 3,
  must miss.
- The host tier (``offload_optimizer``) refuses SGD, LAMB and RMSprop as
  the JAX tier does (``tests/test_offload.py:115``); Lion and Adagrad run
  its host kernels and land on the JAX tier's masters (``masters_close``,
  both sign-like there).
"""

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
import optax  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.ops.optimizers import build_optimizer as jbuild  # noqa: E402
from deepspeed_tpu.runtime.offload import (  # noqa: E402
    UnsupportedOffloadOptimizer as JUnsupported)
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.models.convert import to_flax_tree  # noqa: E402
from deepspeed_tpu_torch.ops import optimizers as topt  # noqa: E402
from deepspeed_tpu_torch.runtime.offload import (  # noqa: E402
    UnsupportedOffloadOptimizer)
from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import torch_micro_ranks as ranks  # noqa: E402
from test_torch_micro_steps import (_flat, _jcfg, _jmesh,  # noqa: E402
                                    case_masters, jax_case)

SPAWN_TIMEOUT = 300

OPTAX_CASES = [
    ("lamb", {"lr": 1e-2, "weight_decay": 0.1}),
    ("fusedlamb", {"lr": 1e-2, "betas": (0.8, 0.99), "eps": 1e-5}),
    ("lion", {"lr": 1e-2, "weight_decay": 0.1}),
    ("fusedlion", {"lr": 1e-2}),
    ("cpulion", {"lr": 1e-2, "betas": (0.95, 0.98)}),
    ("adagrad", {"lr": 1e-2}),
    ("cpuadagrad", {"lr": 1e-2, "eps": 1e-6}),
    ("cpu_adagrad", {"lr": 1e-2}),
    ("sgd", {"lr": 1e-2}),
    ("sgd", {"lr": 1e-2, "momentum": 0.9}),
    ("momentum", {"lr": 1e-2, "momentum": 0.9, "nesterov": True}),
    ("rmsprop", {"lr": 1e-2}),
    ("rmsprop", {"lr": 1e-2, "alpha": 0.9, "eps": 1e-6, "momentum": 0.5}),
]


def _optax_run(name, params, steps=4, zero_leaf=False):
    """(port's params, optax's params, the port optimizer) after ``steps``
    updates under a decaying schedule on the same seeded gradients."""
    rng = np.random.default_rng(4)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((6, 4), (3,))]
    if zero_leaf:
        p0.append(np.zeros((5, 2), np.float32))
    sched = lambda step: 1e-2 / (1.0 + step)           # noqa: E731
    tx = jbuild(name, params, lr_schedule=sched)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    opt = topt.build_optimizer(name, params, lr_schedule=sched)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    opt.init(tp)
    for _ in range(steps):
        g = [rng.normal(size=p.shape).astype(np.float32) for p in p0]
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.from_numpy(x) for x in g])
    return tp, jp, opt


@pytest.mark.parametrize("name,params", OPTAX_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTAX_CASES)])
def test_optimizer_matches_optax(name, params):
    tp, jp, opt = _optax_run(name, params, zero_leaf="lamb" in name)
    assert opt.count == 4
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)
    if "lamb" in name:                 # the zero leaf took the plain update
        assert torch.any(tp[-1] != 0)


@pytest.mark.parametrize("name", ["lamb", "lion", "adagrad", "momentum",
                                  "rmsprop", "adamw"])
def test_state_dict_round_trip(name):
    """A fresh optimizer loaded from another's ``state_dict`` takes the
    next step to the same bits, count included."""
    params = {"lr": 1e-2, "momentum": 0.9, "weight_decay": 0.1}
    rng = np.random.default_rng(0)
    p0 = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for s in ((6, 4), (3,))]
    grads = [[torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
              for p in p0] for _ in range(3)]
    a = topt.build_optimizer(name, params)
    pa = [p.clone() for p in p0]
    a.init(pa)
    for g in grads[:2]:
        a.step(pa, [x.clone() for x in g])
    b = topt.build_optimizer(name, params)
    pb = [p.clone() for p in pa]
    b.init(pb)
    b.load_state_dict(a.state_dict())
    assert b.count == a.count == 2
    assert b.state_bytes() == a.state_bytes() > 0
    a.step(pa, [x.clone() for x in grads[2]])
    b.step(pb, [x.clone() for x in grads[2]])
    for x, y in zip(pa, pb):
        assert torch.equal(x, y)


def test_onebit_names_wait_for_item_7():
    for name in ("onebitadam", "zerooneadam", "onebitlamb"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            topt.build_optimizer(name, {})
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer("adafactor", {})


# ---------------------------------------------------------------------------
# through the engine
# ---------------------------------------------------------------------------
ENGINE_OPTIMIZERS = {
    "lamb": {"type": "lamb", "params": {"lr": 1e-3, "weight_decay": 0.1}},
    "lion": {"type": "lion", "params": {"lr": 1e-4, "weight_decay": 0.1}},
    "adagrad": {"type": "adagrad", "params": {"lr": 1e-3}},
    "sgd_nesterov": {"type": "sgd", "params": {"lr": 1e-2, "momentum": 0.9,
                                               "nesterov": True}},
    "rmsprop": {"type": "rmsprop", "params": {"lr": 1e-3, "momentum": 0.9}},
}


@pytest.fixture(scope="module")
def flax_params():
    params = jllama.LlamaForCausalLM(_jcfg()).init(
        jax.random.PRNGKey(0), jllama.random_tokens(1, 8, 512))["params"]
    return jax.tree.map(np.asarray, params)


def _engines(flax_params, config):
    tcfg = ranks.base.tiny_fp32()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng, *_ = deepspeed_tpu.initialize(
            model=jllama.LlamaForCausalLM(_jcfg()), config=dict(config),
            model_parameters=flax_params, mesh=_jmesh({"data": 1}))
        teng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(tcfg, device="cpu"),
            config=json.loads(json.dumps(config)),
            model_parameters=flax_params, device="cpu")
    return jeng, teng


def _steps(jeng, teng, steps=3):
    rows = []
    for b in ranks.base.zero_batches(2, steps):
        rows.append((float(teng.train_batch(batch=b, stacked=True)),
                     float(jeng.train_batch(batch=b, stacked=True))))
    want = _flat(jax.device_get(jeng.module_state_dict()))
    got = _flat(to_flax_tree(teng.named_masters()))
    assert got.keys() == want.keys()
    return rows, got, want


def masters_close(got, want, sign_like=False, lr=1e-3, steps=3):
    """Masters within 1e-5 of JAX's. A sign-like update (Lion's ``±lr``,
    the host Adagrad's first ``g / (|g| + eps)``) has the size of ``lr``
    whatever the gradient's: an element whose gradient is rounding noise
    in the two packages may step the other way, so there at most 1e-4 of
    the elements may be farther, none beyond 2 lr a step (measured: 1 of
    the 32,768 elements of one kernel, 2 lr apart)."""
    if not sign_like:
        for n, w in want.items():
            np.testing.assert_allclose(got[n], w, atol=1e-5, rtol=1e-5,
                                       err_msg=n)
        return
    diffs = np.concatenate([np.abs(got[n] - w).ravel()
                            for n, w in want.items()])
    assert diffs.max() <= 2 * lr * steps + 1e-6
    assert np.mean(diffs > 1e-5) <= 1e-4


@pytest.mark.parametrize("name", list(ENGINE_OPTIMIZERS))
def test_engine_matches_jax_engine(flax_params, name):
    config = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": ENGINE_OPTIMIZERS[name], "gradient_clipping": 1.0}
    jeng, teng = _engines(flax_params, config)
    rows, got, want = _steps(jeng, teng)
    for tl, jl in rows:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
    masters_close(got, want, sign_like=name == "lion",
                  lr=config["optimizer"]["params"]["lr"])
    assert teng.optimizer.count == 3
    assert type(teng.optimizer).__name__ == {
        "lamb": "Lamb", "lion": "Lion", "adagrad": "Adagrad",
        "sgd_nesterov": "SGD", "rmsprop": "RMSprop"}[name]


# ---------------------------------------------------------------------------
# LAMB over ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spawned(flax_params, tmp_path_factory):
    out = tmp_path_factory.mktemp("lamb")
    np.savez(out / "params.npz", **_flat(flax_params))
    run_distributed(ranks.cases_body, 2, timeout=SPAWN_TIMEOUT, device="cpu",
                    env={"DSTPU_TEST_OUT": str(out),
                         "DSTPU_TEST_CASES": json.dumps(ranks.LAMBS)})
    per_rank = []
    for r in range(2):
        with open(out / f"micro{r}.json") as f:
            meta = json.load(f)
        per_rank.append((meta, dict(np.load(out / f"micro{r}.npz"))))
    return per_rank


_JAX = {}


@pytest.mark.parametrize("name", [n for n in ranks.LAMBS
                                  if "local" not in n])
def test_lamb_over_ranks_matches_jax(spawned, flax_params, name):
    if name not in _JAX:
        _JAX[name] = jax_case(name, flax_params)
    jl, jn, jm = _JAX[name]
    row = spawned[0][0]["cases"][name]
    got = case_masters(spawned[0][1], name)
    np.testing.assert_allclose(row["losses"], jl, rtol=1e-4)
    np.testing.assert_allclose(row["norms"], jn, rtol=1e-4)
    for n, w in jm.items():
        np.testing.assert_allclose(got[n], w, atol=1e-5, rtol=1e-5,
                                   err_msg=n)
    # the blocks: sharded moments at stages 1 and 3, tensor blocks at tp=2
    if "tp2" in name:
        assert any(d is not None for d in row["tensor_dim"])
    else:
        assert any(d is not None for d in row["opt_dim"])
    assert row["state_numel"] < 2 * sum(v.size for v in jm.values())
    assert spawned[1][0]["cases"][name]["losses"] == row["losses"]


def test_lamb_local_norms_fault_is_caught(spawned, flax_params):
    """The trust ratio from a rank's block alone trains, but lands away
    from JAX's masters: the parity above would catch it."""
    name = "lamb_fsdp2_s3"
    if name not in _JAX:
        _JAX[name] = jax_case(name, flax_params)
    jm = _JAX[name][2]
    got = case_masters(spawned[0][1], "lamb_fsdp2_s3_local_norms")
    worst = max(float(np.max(np.abs(got[n] - w) / (1e-5 + 1e-5 * np.abs(w))))
                for n, w in jm.items())
    assert worst > 1.0, worst


# ---------------------------------------------------------------------------
# the host tier
# ---------------------------------------------------------------------------
def _tier_config(opt):
    return {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "optimizer": {"type": opt, "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 0,
                                  "offload_optimizer": {"device": "cpu"}}}


@pytest.mark.parametrize("opt", ["sgd", "lamb", "rmsprop"])
def test_host_tier_refuses_as_jax_does(flax_params, opt):
    with pytest.raises(JUnsupported):
        _engines(flax_params, _tier_config(opt))
    with pytest.raises(UnsupportedOffloadOptimizer):
        deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(ranks.base.tiny_fp32(),
                                          device="cpu"),
            config=_tier_config(opt), device="cpu")


@pytest.mark.parametrize("opt", ["lion", "adagrad"])
def test_host_tier_lion_and_adagrad_match_jax(flax_params, opt):
    jeng, teng = _engines(flax_params, _tier_config(opt))
    assert type(teng._offload.kernel).__name__ == \
        {"lion": "CPULion", "adagrad": "CPUAdagrad"}[opt]
    rows, got, want = _steps(jeng, teng)
    for tl, jl in rows:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
    # the host Adagrad's first step is g / (|g| + eps): sign-like
    masters_close(got, want, sign_like=True, lr=1e-3)
