"""Port parity: the PyTorch training path against the JAX package.

- The model: ``TINY_LLAMA`` in float32 on the same flax weights (loaded by
  ``load_flax_params``), with the ``xla`` and ``flash`` backends (the
  port's flash runs its kernels' plain mirrors on the CPU; the JAX flash
  backend runs its blockwise reference there): logits and loss within
  atol/rtol 1e-5, every parameter's gradient within atol 1e-5 / rtol 1e-4
  (whole forward and backward passes summed in other orders).
- The engine: ``deepspeed_tpu_torch.initialize`` against
  ``deepspeed_tpu.initialize`` on one JAX device, N ``train_batch`` steps on
  the same batches: fp32 (gas 2, AdamW with decay, clipping, WarmupLR)
  within rtol 1e-4 on loss, grad norm and lr and atol 1e-5 on the final
  parameters; bf16 with ``grad_accum_dtype: bf16`` within 2e-2 relative on
  loss and grad norm (two bf16 pipelines round at the same points but their
  matmuls sum in other orders; after 3 Adam steps of lr 1e-3 at most 0.5%
  of all parameter elements differ by more than 1e-3, none by more than
  2 lr per applied step, the most a noise-driven Adam element can drift);
  fp16
  with a loss scale that overflows at the start: the same skipped steps and
  scales, loss and grad norm within 2e-2 relative (the norm only on applied
  steps: on a skipped one it depends on which fp16 values overflowed), and
  parameters held as the bf16 case's; fp32 with qgZ
  (``zero_quantized_gradients``, the int8 round trip of every gradient of
  at least 2048 elements per micro-batch) within rtol 1e-4 on loss and grad
  norm and at most 0.1% of parameter elements beyond 1e-5 (an int8 code
  may differ by one step where the two sides' gradients straddle a rounding
  boundary).
- The config: the same validation errors as the JAX config.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.comm.mesh import create_mesh  # noqa: E402
from deepspeed_tpu.config.config import (DeepSpeedTPUConfig as JConfig,  # noqa: E402
                                         MeshConfig)
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.runtime import lr_schedules as jsched  # noqa: E402
from deepspeed_tpu.runtime import precision as jprec  # noqa: E402
from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.models.convert import (load_flax_params,  # noqa: E402
                                                to_flax_tree)
from deepspeed_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from deepspeed_tpu_torch.runtime import lr_schedules as tsched  # noqa: E402
from deepspeed_tpu_torch.runtime import precision as tprec  # noqa: E402

JDTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}
TDTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def _configs(dtype="fp32", **kw):
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=JDTYPES[dtype], **kw)
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=TDTYPES[dtype])
    return jcfg, tcfg


@pytest.fixture(scope="module")
def flax_params():
    jcfg, _ = _configs()
    batch = jllama.random_tokens(1, 8, vocab_size=jcfg.vocab_size)
    params = jllama.LlamaForCausalLM(jcfg).init(jax.random.PRNGKey(0),
                                               batch)["params"]
    return jax.tree.map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict) else {name: v})
    return out


def _port_model(tcfg, flax_params):
    return load_flax_params(tllama.LlamaForCausalLM(tcfg, device="cpu"),
                            flax_params)


MODEL_CASES = {
    "xla": dict(attention_backend="xla"),
    "flash": dict(attention_backend="flash"),
    "flash_remat": dict(attention_backend="flash", remat=True,
                        remat_policy="dots_with_no_batch_dims_saveable"),
    "flash_packed": dict(attention_backend="flash"),
    "xla_window": dict(attention_backend="xla", sliding_window=5),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_logits_loss_and_grads_match_jax(flax_params, case):
    jcfg, tcfg = _configs(**MODEL_CASES[case])
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    batch = {"input_ids": ids}
    if case == "flash_packed":
        batch["segment_ids"] = np.repeat(np.array([[0] * 10 + [1] * 14]), 2, 0
                                         ).astype(np.int32)
    jmodel = jllama.LlamaForCausalLM(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, flax_params)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jbatch))(jparams)
    jlogits = jmodel.apply({"params": jparams}, jbatch, method="logits")

    model = _port_model(tcfg, flax_params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model(tbatch)
    loss.backward()
    with torch.no_grad():
        logits = model.logits(tbatch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = _flat(to_flax_tree((n, p.grad) for n, p in model.named_parameters()))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert grads.keys() == want.keys()
    for name, g in want.items():
        np.testing.assert_allclose(grads[name], g, atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_remat_reruns_the_flash_forward_once_per_layer(flax_params,
                                                       monkeypatch):
    """With remat each layer's flash forward runs twice per micro-batch (the
    forward and the recompute) and its backward once; without remat once
    each — the counts the card smoke checks on the kernels' launches. The
    loss and gradients do not depend on the policy."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_fwd_plain, tfa.flash_bwd_plain

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfa, "flash_fwd_plain", counting("fwd", fwd))
    monkeypatch.setattr(tfa, "flash_bwd_plain", counting("bwd", bwd))
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, size=(1, 16)).astype(np.int32))
    results = {}
    for policy in (None, "nothing_saveable", "dots_with_no_batch_dims_saveable"):
        kw = dict(remat=True, remat_policy=policy) if policy else {}
        _, tcfg = _configs(attention_backend="flash", **kw)
        model = _port_model(tcfg, flax_params)
        calls.update(fwd=0, bwd=0)
        model({"input_ids": ids}).backward()
        layers = tcfg.num_layers
        assert calls == {"fwd": (2 if policy else 1) * layers, "bwd": layers}
        results[policy] = [p.grad for p in model.parameters()]
    for policy in results:
        for a, b in zip(results[None], results[policy]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_model_rejects_what_is_not_ported():
    _, tcfg = _configs()
    for bad, match in ((dict(scan_layers=True), "scanned"),):
        cfg = dataclasses.replace(tcfg, **bad)
        with pytest.raises(NotImplementedError, match=match):
            model = tllama.LlamaForCausalLM(cfg, device="cpu")
            model({"input_ids": torch.zeros(1, 4, dtype=torch.int32)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tllama.LlamaForCausalLM(tcfg)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _engines(flax_params, config, dtype):
    jcfg, tcfg = _configs(dtype, attention_backend="flash")
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(
        model=jllama.LlamaForCausalLM(jcfg), config=dict(config),
        model_parameters=flax_params, mesh=mesh)
    teng, topt, loader, tsch = deepspeed_tpu_torch.initialize(
        model=tllama.LlamaForCausalLM(tcfg, device="cpu"), config=dict(config),
        model_parameters=flax_params, device="cpu")
    assert topt is teng.optimizer and loader is None
    assert tsch is teng.lr_schedule
    return jeng, teng


def _run(jeng, teng, steps, gas, seq=16):
    rows = []
    for i in range(steps):
        batch = jllama.random_tokens(2, seq, vocab_size=512, seed=100 + i,
                                     gas=gas)
        jl = float(jeng.train_batch(batch=batch, stacked=True))
        tl = float(teng.train_batch(batch=batch, stacked=True))
        rows.append(dict(
            loss=(tl, jl),
            norm=(teng.get_global_grad_norm(), jeng.get_global_grad_norm()),
            lr=(teng.get_lr()[0], jeng.get_lr()[0]),
            scale=(teng.cur_scale(), jeng.cur_scale()),
            skipped=(teng.skipped_steps, jeng.skipped_steps)))
    want = _flat(jax.tree.map(np.asarray, jeng.module_state_dict()))
    got = _flat(to_flax_tree(teng.named_masters()))
    assert got.keys() == want.keys()
    return rows, got, want


TRAJECTORIES = {
    "fp32": ({"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.1}},
              "gradient_clipping": 1.0,
              "scheduler": {"type": "WarmupLR",
                            "params": {"warmup_min_lr": 0.0,
                                       "warmup_max_lr": 1e-3,
                                       "warmup_num_steps": 3}}},
             dict(loss=1e-4, norm=1e-4, params=1e-5)),
    "bf16": ({"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "bf16": {"enabled": True},
              "data_types": {"grad_accum_dtype": "bf16"}},
             dict(loss=2e-2, norm=2e-2, params=1e-3)),
    # qgZ on one device: every gradient of >= 2048 elements takes the int8
    # round trip per micro-batch on both sides
    "fp32_qgz": ({"train_batch_size": 4, "gradient_accumulation_steps": 2,
                  "optimizer": {"type": "AdamW",
                                "params": {"lr": 1e-3, "weight_decay": 0.1}},
                  "gradient_clipping": 1.0,
                  "zero_optimization": {"stage": 0,
                                        "zero_quantized_gradients": True}},
                 dict(loss=1e-4, norm=1e-4, params=1e-5, share=1e-3)),
    "fp16": ({"train_batch_size": 2, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "fp16": {"enabled": True, "initial_scale_power": 20,
                       "hysteresis": 1}},
             dict(loss=2e-2, norm=2e-2, params=1e-3)),
}


@pytest.mark.parametrize("case", list(TRAJECTORIES))
def test_train_batch_trajectory_matches_jax(flax_params, case):
    config, tol = TRAJECTORIES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # qgZ on one device
        jeng, teng = _engines(flax_params, config, case.split("_")[0])
    steps = 8 if case == "fp16" else 3
    rows, got, want = _run(jeng, teng, steps,
                           config["gradient_accumulation_steps"])
    skipped = 0
    for row in rows:
        np.testing.assert_allclose(*row["loss"], rtol=tol["loss"])
        if row["skipped"][1] == skipped:    # an applied step: the clean norm
            np.testing.assert_allclose(*row["norm"], rtol=tol["norm"])
        skipped = row["skipped"][1]
        np.testing.assert_allclose(*row["lr"], rtol=1e-6)
        assert row["scale"][0] == row["scale"][1]
        assert row["skipped"][0] == row["skipped"][1]
    if case == "fp16":               # the scale overflowed, then recovered
        assert rows[0]["skipped"][0] == 1 and rows[-1]["skipped"][0] < steps
    if case == "fp32":
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, atol=tol["params"],
                                       rtol=tol["params"], err_msg=name)
        return
    # half precision: an element whose gradient is rounding noise can take
    # Adam steps of +-lr in either direction, so it may end up to 2 lr per
    # applied step away; nearly every element is far closer. qgZ: where the
    # two sides' fp32 gradients straddle an int8 rounding boundary a code
    # differs by one step (measured on the CPU: 81 of 426,624 elements
    # beyond 1e-5 after 3 steps, the farthest 1.3e-4 away)
    applied = steps - rows[-1]["skipped"][1]
    diffs = np.concatenate([np.abs(got[n] - w).ravel() for n, w in want.items()])
    assert diffs.max() <= 2 * 1e-3 * applied + 1e-6
    assert np.mean(diffs > tol["params"]) <= tol.get("share", 5e-3)


def test_qgz_round_trips_large_gradients_only(flax_params):
    """zero_quantized_gradients on one device warns that no bytes are
    saved, leaves every gradient under MIN_QUANT_SIZE elements exactly as
    without it, and replaces the others by their int8 round trip (rows are
    the last axis)."""
    from deepspeed_tpu_torch.ops.quant import dequantize_int8, quantize_int8
    from deepspeed_tpu_torch.runtime.zero.qgz import MIN_QUANT_SIZE
    config = {"train_batch_size": 2, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    _, tcfg = _configs(attention_backend="xla")
    engines = {}
    for qgz in (False, True):
        cfg = dict(config, zero_optimization={
            "stage": 0, "zero_quantized_gradients": qgz})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            engines[qgz], *_ = deepspeed_tpu_torch.initialize(
                model=tllama.LlamaForCausalLM(tcfg, device="cpu"), config=cfg,
                model_parameters=flax_params, device="cpu")
        assert any("NO bytes are saved" in str(w.message)
                   for w in caught) == qgz
    micro = {"input_ids": torch.from_numpy(jllama.random_tokens(
        2, 16, vocab_size=512, seed=4)["input_ids"])}
    loss0, plain = engines[False]._grads_one_micro(micro, 1.0)
    loss1, quant = engines[True]._grads_one_micro(micro, 1.0)
    assert loss0.item() == loss1.item()
    small = 0
    for name, g, q in zip(engines[True]._param_names, plain, quant):
        if g.numel() < MIN_QUANT_SIZE:
            small += 1
            assert torch.equal(g, q), name
        else:
            assert torch.equal(q, dequantize_int8(*quantize_int8(g),
                                                  dtype=g.dtype)), name
            assert not torch.equal(g, q), name
    assert small == 2 * tcfg.num_layers + 1          # the norm scales
    # qgZ parses at every stage now, and so does its ZeRO++ sibling qwZ
    assert DeepSpeedTPUConfig({"zero_optimization": {
        "stage": 2, "zero_quantized_gradients": True}}).zero_optimization_stage == 2
    assert DeepSpeedTPUConfig({"zero_optimization": {
        "stage": 2, "zero_quantized_gradients": True,
        "zero_quantized_weights": True}}).zero_config.zero_quantized_weights


def test_engine_surface(flax_params):
    config = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    _, tcfg = _configs(attention_backend="xla")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.LlamaForCausalLM(tcfg, device="cpu"), config=dict(config),
        model_parameters=flax_params, device="cpu")
    micro = jllama.random_tokens(2, 16, vocab_size=512, seed=3)
    before = float(eng.eval_batch(micro))
    it = iter([micro, micro])
    loss = eng.train_batch(data_iter=it)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert eng.global_steps == 1 and eng.micro_steps == 2
    assert eng.global_samples == 4 and eng.skipped_steps == 0
    assert float(eng.eval_batch(micro)) != before
    state = eng.module_state_dict()
    assert all(t.dtype == torch.float32 for t in state.values())
    # the micro-step protocol: a step is gas forward/backward pairs
    with pytest.raises(RuntimeError, match="without a preceding forward"):
        eng.backward()
    for k in range(2):
        loss = eng(micro)
        assert loss.dtype == torch.float32 and loss.dim() == 0
        eng.backward(loss)
        assert eng.is_gradient_accumulation_boundary() == (k == 1)
        eng.step()
    assert eng.global_steps == 2 and eng.micro_steps == 4
    assert not eng.is_gradient_accumulation_boundary()
    with pytest.raises(ValueError, match="micro-batches"):
        eng.train_batch(batch={"input_ids": micro["input_ids"][:1]})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            deepspeed_tpu_torch.initialize(
                model=tllama.LlamaForCausalLM(tcfg, device="cpu"),
                config=dict(config))


def test_nonfinite_guard_and_loss_fn(flax_params):
    """A ``loss_fn`` replaces the model's loss; with the non-finite guard a
    NaN step is skipped in fp32 too (parameters, step and lr kept)."""
    config = {"train_batch_size": 2, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    _, tcfg = _configs(attention_backend="xla")
    poison = {"on": True}
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.LlamaForCausalLM(tcfg, device="cpu"), config=config,
        model_parameters=flax_params, device="cpu",
        loss_fn=lambda loss, batch: loss * float("nan") if poison["on"] else loss)
    eng.set_nonfinite_guard(True)
    micro = jllama.random_tokens(2, 16, vocab_size=512, seed=4)
    before = {n: p.clone() for n, p in eng.named_masters()}
    assert not np.isfinite(float(eng.train_batch(batch=micro)))
    assert eng.skipped_steps == 1 and eng.step_count == 0
    assert all(torch.equal(p, before[n]) for n, p in eng.named_masters())
    poison["on"] = False
    assert np.isfinite(float(eng.train_batch(batch=micro)))
    assert eng.skipped_steps == 1 and eng.step_count == 1
    assert not all(torch.equal(p, before[n]) for n, p in eng.named_masters())


def test_timers():
    from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                                 ThroughputTimer,
                                                 TRAIN_BATCH_TIMER)
    timers = SynchronizedWallClockTimer()
    t = timers(TRAIN_BATCH_TIMER)
    assert timers(TRAIN_BATCH_TIMER) is t and timers.has(TRAIN_BATCH_TIMER)
    for _ in range(3):
        t.start()
        t.stop()
    assert t.mean() >= 0.0 and len(t._records) == 3
    assert timers.get_mean([TRAIN_BATCH_TIMER]).keys() == {TRAIN_BATCH_TIMER}
    assert t.elapsed(reset=True) >= 0.0 and t.elapsed() == 0.0
    seen = []
    tput = ThroughputTimer(batch_size=8, steps_per_output=2,
                           logging_fn=seen.append)
    for _ in range(4):
        tput.start()
        tput.stop(global_step=True)
    assert len(seen) == 2 and tput.avg_samples_per_sec() > 0


CONFIG_ERRORS = [
    {"train_batch_size": 6, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 5, "gradient_accumulation_steps": 2},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 3},
    {"data_types": {"grad_accum_dtype": "int8"}},
    {"zero_optimization": {"stage": 7}},
]


@pytest.mark.parametrize("raw", CONFIG_ERRORS,
                         ids=["indivisible_micro", "indivisible_gas",
                              "triple_mismatch", "grad_accum_dtype",
                              "zero_stage"])
def test_config_errors_match_jax(raw):
    with pytest.raises(ValueError) as jerr:
        JConfig(dict(raw), dp_world_size=1)
    with pytest.raises(ValueError) as terr:
        DeepSpeedTPUConfig(dict(raw), dp_world_size=1)
    # pydantic wraps the message; the reference's text is inside it
    assert str(terr.value) in str(jerr.value)


def test_config_refuses_unported_groups():
    # stages 1-3 are read now, MiCS and hpZ too; a tensor axis still raises
    for raw, match in (({"zero_optimization": {"stage": 3, "mics_shard_size": 2},
                         "mesh": {"tensor": 2}},
                        "distribution and memory"),
                       ({"zero_optimization": {"stage": 1,
                                               "zero_hpz_partition_size": 2},
                         "mesh": {"dcn_axes": ["data"]}},
                        "distribution and memory"),
                       ({"tensorboard": {"enabled": True}}, "not ported")):
        with pytest.raises(NotImplementedError, match=match):
            DeepSpeedTPUConfig(raw)
    assert DeepSpeedTPUConfig({"zero_optimization": {
        "stage": 3, "mics_shard_size": 2}}).zero_config.mics_shard_size == 2
    # the memory tiers are read at stage 0, with the JAX package's defaults
    tiers = {"zero_optimization": {"stage": 0,
                                   "offload_optimizer": {"device": "cpu"},
                                   "offload_param": {"device": "nvme",
                                                     "nvme_path": "/x"}}}
    ours, ref = DeepSpeedTPUConfig(tiers).zero_config, JConfig(tiers).zero_config
    for name in ("offload_optimizer", "offload_param"):
        assert dataclasses.asdict(getattr(ours, name)) == \
            getattr(ref, name).model_dump()
    assert ours.sub_group_size == ref.sub_group_size
    cfg = DeepSpeedTPUConfig({"train_batch_size": 8,
                              "gradient_accumulation_steps": 2,
                              "bf16": {"enabled": True},
                              "data_types": {"grad_accum_dtype": "bf16"}},
                             dp_world_size=1)
    jcfg = JConfig({"train_batch_size": 8, "gradient_accumulation_steps": 2},
                   dp_world_size=1)
    assert (cfg.train_micro_batch_size_per_gpu, cfg.gradient_accumulation_steps) \
        == (jcfg.train_micro_batch_size_per_gpu, jcfg.gradient_accumulation_steps)
    assert cfg.precision_dtype == cfg.grad_accum_dtype == torch.bfloat16


SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=0.0, warmup_max_lr=0.01,
                      warmup_num_steps=10)),
    ("WarmupLR", dict(warmup_max_lr=0.01, warmup_num_steps=10,
                      warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=30, warmup_max_lr=0.01,
                           warmup_num_steps=10)),
    ("WarmupCosineLR", dict(total_num_steps=30, warmup_num_steps=10, lr=0.01)),
    ("OneCycle", dict(cycle_min_lr=0.001, cycle_max_lr=0.01,
                      cycle_first_step_size=8, decay_step_size=4,
                      decay_lr_rate=0.5)),
    ("LRRangeTest", dict(lr_range_test_step_size=5,
                         lr_range_test_staircase=True)),
    ("Constant", dict(lr=0.02)),
]


@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_lr_schedules_match_jax(name, params):
    ours = tsched.build_schedule(name, params)
    ref = jsched.build_schedule(name, params)
    for step in range(0, 40):
        np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="unknown scheduler"):
        tsched.build_schedule("Nope", {})


def test_loss_scale_and_clip_match_jax():
    from deepspeed_tpu.config.config import FP16Config as JFP16
    from deepspeed_tpu_torch.config.config import FP16Config
    for kw in (dict(enabled=True, hysteresis=2, loss_scale_window=3),
               dict(enabled=True, hysteresis=3, consecutive_hysteresis=True,
                    loss_scale_window=2, min_loss_scale=1024.0,
                    initial_scale_power=11)):
        jcfg, tcfg = JFP16(**kw), FP16Config(**kw)
        js, ts = jprec.init_loss_scale(jcfg), tprec.init_loss_scale(tcfg)
        for overflow in (True, False, False, False, True, True, True, False):
            js = jprec.update_loss_scale(js, jnp.bool_(overflow), jcfg)
            ts = tprec.update_loss_scale(ts, overflow, tcfg)
            assert (ts.scale, ts.good_steps, ts.hysteresis) == (
                float(js.scale), int(js.good_steps), int(js.hysteresis))
    rng = np.random.default_rng(0)
    gs = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    for max_norm in (0.0, 0.5, 100.0):
        jc, jn = jprec.clip_by_global_norm([jnp.asarray(g) for g in gs], max_norm)
        tc, tn = tprec.clip_by_global_norm([torch.from_numpy(g.copy())
                                            for g in gs], max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    bad = [torch.ones(2), torch.tensor([1.0, float("inf")])]
    assert bool(tprec.has_inf_or_nan(bad)) and not bool(tprec.has_inf_or_nan(bad[:1]))


@pytest.mark.parametrize("name,params", [
    ("adamw", {"lr": 1e-2}),
    ("adam", {"lr": 1e-2, "weight_decay": 0.1, "adam_w_mode": False}),
    ("fusedadam", {"lr": 1e-2, "weight_decay": 0.05, "betas": (0.8, 0.99),
                   "eps": 1e-6}),
    ("cpu_adam", {"lr": 1e-2}),
])
def test_optimizer_matches_optax(name, params):
    import optax
    from deepspeed_tpu.ops.optimizers import build_optimizer as jbuild
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer
    rng = np.random.default_rng(4)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((6, 4), (3,))]
    sched = lambda step: 1e-2 / (1.0 + step)           # noqa: E731
    tx = jbuild(name, params, lr_schedule=sched)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    opt = build_optimizer(name, params, lr_schedule=sched)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    opt.init(tp)
    for _ in range(4):
        g = [rng.normal(size=p.shape).astype(np.float32) for p in p0]
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.from_numpy(x) for x in g])
    assert opt.count == 4
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)
    from deepspeed_tpu_torch.ops.optimizers import Lamb
    assert isinstance(build_optimizer("lamb", {}), Lamb)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        build_optimizer("onebitadam", {})
