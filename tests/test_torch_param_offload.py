"""The port's parameter tier (ZeRO-Infinity's streamed weights,
``runtime/param_offload.py``) against the dense engine and the JAX package.

Mirrors the cases of ``tests/test_param_offload.py`` the port can run, on
a 4-layer ``TINY``-width Llama in float32, ``device="cpu"``:

- the streamed step matches the dense (in-HBM) engine: losses within rtol
  1e-5, masters within 5e-4 (CPU Adam's epsilon against the in-HBM
  AdamW's), and the module keeps no weights between steps; uneven groups
  and gas 1; NVMe with Twin-Flow (the ratio's groups in files, bit for bit
  the CPU store's result); tied embeddings, a gradient clip and a sliding
  window match dense; the bf16 loss falls; the JAX package's refusals,
  text included, and an MoE model of other blocks than MixtralBlock
  refused by name (the reference's stack builds MixtralBlock); the micro-step
  calls raise; the reported lr is the applied step's; the optimizer's
  state round trip resumes a run bit for bit;
- the cross-check: the same flax weights and batches through the JAX
  ``ParamOffloadTrainer`` (``deepspeed_tpu.initialize``) and the port's, on
  a 3-layer TINY Llama with ``layers_per_group`` 1 and 2: loss, gradient
  norm and lr within rtol 1e-4, final masters within atol 1e-5.

The mesh, tensor-parallel and Mixtral cases are
``tests/test_torch_offload_ranks.py``'s; the Gemma-flavour, HF-checkpoint
and ZeRO-3 interchange cases wait for their ROADMAP Queue 1 items.
``test_param_offload_matches_optimizer_tier_on_card`` (marked ``gpu``)
holds the stream against the optimizer tier on the card, where a missing
wait between the copy and compute streams would show.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              random_tokens)

VOCAB = 256
ADAMW = {"type": "AdamW", "params": {"lr": 1e-2, "betas": (0.9, 0.999),
                                     "eps": 1e-8, "weight_decay": 0.0}}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's many small CPU ops: PyTorch's
    OpenMP threads spin between regions, and with the suite's other workers
    on the same cores eight of them mostly wait for each other (4x slower
    here); restored for the files after this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny_cfg(**kw):
    base = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                num_layers=4, num_heads=4, num_kv_heads=2, max_seq_len=64,
                dtype=torch.float32, attention_backend="flash", remat=False)
    base.update(kw)
    return LlamaConfig(**base)


def make_engine(cfg=None, zero=None, gas=2, micro=2, seed=0, **cfg_kw):
    config = {"train_batch_size": micro * gas,
              "gradient_accumulation_steps": gas, "optimizer": ADAMW, **cfg_kw}
    if zero is not None:
        config["zero_optimization"] = {"stage": 0, **zero}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(cfg or tiny_cfg(), device="cpu", seed=seed),
        config=config, device="cpu")
    return engine


def run_steps(engine, steps=3, gas=2, seq=32):
    """Losses of ``steps`` steps on one fixed batch: random tokens carry no
    shared signal, so fresh batches leave the loss hovering near ln(VOCAB)
    while a fixed one is memorised and its loss falls."""
    n = engine.train_batch_size // gas
    batch = random_tokens(n, seq, vocab_size=VOCAB, seed=0, gas=gas)
    return [float(engine.train_batch(batch=batch, stacked=True))
            for _ in range(steps)]


def max_param_diff(a, b):
    return max(float((x.detach() - y.detach()).abs().max())
               for (_, x), (_, y) in zip(a.named_masters(), b.named_masters()))


def po(**kw):
    return {"offload_param": {"device": "cpu", **kw}}


def test_param_offload_cpu_matches_dense():
    e1 = make_engine()
    l1 = run_steps(e1)
    e2 = make_engine(zero=po(layers_per_group=2))
    l2 = run_steps(e2)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    assert l2[-1] < l2[0]
    assert max_param_diff(e1, e2) < 5e-4  # CPU Adam vs AdamW epsilon placement
    # no device-resident weights between steps
    assert all(p.numel() == 0 for p in e2.model.parameters())
    assert e2._param_offload.bytes_streamed > 0
    assert set(e2.phase_seconds) == {"stream_fwd_bwd", "h2d_copy_device",
                                     "grads_down", "host_optimizer",
                                     "store_refresh"}


def test_param_offload_uneven_groups_and_gas1():
    # 4 layers / 3 per group -> groups of 3 and 1
    e = make_engine(gas=1, zero=po(layers_per_group=3))
    losses = [float(e.train_batch(batch=random_tokens(2, 32, VOCAB, seed=0),
                                  stacked=False)) for _ in range(4)]
    assert losses[-1] < losses[0]
    assert e._param_offload._layer_groups == [[0, 1, 2], [3]]


def test_param_offload_nvme_trains_and_twin_flow(tmp_path):
    e = make_engine(zero=po(device="nvme", nvme_path=str(tmp_path),
                            layers_per_group=1, ratio=0.5))
    losses = run_steps(e, steps=4)
    assert losses[-1] < losses[0]
    # Twin-Flow ratio=0.5 over 4 groups: first 2 in RAM, last 2 on nvme
    assert e._param_offload._nvme_groups == [False, False, True, True]
    files = glob.glob(str(tmp_path / "params_proc0" / "group*.bin"))
    assert sorted(os.path.basename(f) for f in files) == \
        ["group2.bin", "group3.bin"]
    # nvme equals the cpu store exactly (same math, another tier)
    e2 = make_engine(zero=po(layers_per_group=1))
    assert run_steps(e2, steps=4) == losses
    assert max_param_diff(e, e2) == 0


@pytest.mark.parametrize("kw", [dict(tie_embeddings=True), dict(sliding_window=16)],
                         ids=["tied_embeddings", "sliding_window"])
def test_param_offload_model_flavours_match_dense(kw):
    e1 = make_engine(tiny_cfg(**kw))
    l1 = run_steps(e1)
    e2 = make_engine(tiny_cfg(**kw), zero=po())
    l2 = run_steps(e2)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    assert max_param_diff(e1, e2) < 5e-4


def test_param_offload_grad_clip_matches_dense():
    e1 = make_engine(gradient_clipping=0.01)
    l1 = run_steps(e1)
    e2 = make_engine(zero=po(), gradient_clipping=0.01)
    l2 = run_steps(e2)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    assert max_param_diff(e1, e2) < 5e-4


def test_param_offload_bf16_loss_decreases():
    e = make_engine(tiny_cfg(dtype=torch.bfloat16, remat=True), zero=po(),
                    bf16={"enabled": True})
    fixed = random_tokens(2, 32, VOCAB, seed=0, gas=2)
    losses = [float(e.train_batch(batch=fixed)) for _ in range(5)]
    assert losses[-1] < losses[0]
    store = e._param_offload._store
    assert all(s.tensor.dtype == torch.bfloat16 for s in store.values())


def test_param_offload_unsupported_configs_raise():
    with pytest.raises(NotImplementedError, match="scanned"):
        make_engine(tiny_cfg(scan_layers=True), zero=po())
    with pytest.raises(ValueError, match="fp16|bf16"):
        make_engine(zero=po(), fp16={"enabled": True})
    with pytest.raises(ValueError, match="nvme_path"):
        make_engine(zero=po(device="nvme"))
    with pytest.raises(ValueError, match="none|cpu|nvme"):
        make_engine(zero=po(device="disk"))
    with pytest.raises(ValueError, match="hpZ/MiCS/qwZ/qgZ"):
        make_engine(zero={**po(), "zero_quantized_gradients": True})
    with pytest.raises(ValueError, match="config-typed optimizer"):
        deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(tiny_cfg(), device="cpu"),
            optimizer=object(), device="cpu",
            config={"train_batch_size": 2, "zero_optimization": po()})
    from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
    from deepspeed_tpu_torch.runtime.param_offload import validate_param_offload
    config = DeepSpeedTPUConfig({"zero_optimization": po()})
    with pytest.raises(ValueError, match="layered model"):
        validate_param_offload(config, torch.nn.Linear(2, 2))

    class Scanned(torch.nn.Module):        # the model itself refuses first
        cfg = tiny_cfg(scan_layers=True)
    with pytest.raises(ValueError, match="scan_layers=False"):
        validate_param_offload(config, Scanned())

    class MoE(torch.nn.Module):            # a Mixtral-style config
        cfg = type("MixtralConfig", (), {"base": tiny_cfg(), "moe": object()})()
    # the stack streams MixtralBlock only (the reference's _MoEBlockStack):
    # an MoE model of other blocks raises, naming the model
    with pytest.raises(ValueError, match="MixtralBlock only; MoE's blocks"):
        validate_param_offload(config, MoE())


def test_param_offload_compat_apis_raise():
    e = make_engine(zero=po())
    batch = random_tokens(2, 32, vocab_size=VOCAB)
    for call in (lambda: e.forward(batch), e.step, lambda: e.eval_batch(batch)):
        with pytest.raises(NotImplementedError, match="train_batch"):
            call()


def test_param_offload_reports_applied_lr():
    """The lr metric is the schedule's value at the step the host optimizer
    applied (pre-increment), not the next step's."""
    e = make_engine(tiny_cfg(num_layers=2), zero=po(),
                    scheduler={"type": "WarmupLR",
                               "params": {"warmup_min_lr": 0.0,
                                          "warmup_max_lr": 1e-2,
                                          "warmup_num_steps": 10}})
    for applied_step in range(2):
        run_steps(e, steps=1)
        assert e._last_metrics["lr"] == pytest.approx(
            float(e.lr_schedule(applied_step)))


def test_param_offload_state_round_trip():
    """Masters, moments and the step count restored into an engine of other
    weights (``load_state_dict`` + ``sync_store``): its next step equals
    the original's next step bit for bit."""
    e1 = make_engine(zero=po(), seed=0)
    run_steps(e1, steps=2)
    sd = e1.optimizer.state_dict()
    cont = run_steps(e1, steps=1)
    e2 = make_engine(zero=po(), seed=7)
    e2.optimizer.load_state_dict(sd)
    e2._param_offload.sync_store()
    e2.step_count = e2.global_steps = 2
    assert max_param_diff(e1, e2) > 0          # e1 stepped on
    assert run_steps(e2, steps=1) == cont
    assert max_param_diff(e1, e2) == 0


# ---------------------------------------------------------------------------
# the cross-check with the JAX ParamOffloadTrainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per", [1, 2])
def test_param_offload_trajectory_matches_jax(per):
    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.comm.mesh import create_mesh
    from deepspeed_tpu.config.config import MeshConfig
    from deepspeed_tpu.models import llama as jllama
    from deepspeed_tpu_torch.models.convert import to_flax_tree
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               num_layers=3, attention_backend="flash")
    names = {f.name for f in dataclasses.fields(LlamaConfig)} - {"dtype"}
    tcfg = LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                       dtype=torch.float32)
    params = jax.tree.map(np.asarray, jllama.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jllama.random_tokens(1, 8, 512))["params"])
    config = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.1}},
              "gradient_clipping": 1.0,
              "scheduler": {"type": "WarmupLR",
                            "params": {"warmup_min_lr": 0.0,
                                       "warmup_max_lr": 1e-3,
                                       "warmup_num_steps": 3}},
              "zero_optimization": {"stage": 0, "offload_param": {
                  "device": "cpu", "layers_per_group": per}}}
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(
        model=jllama.LlamaForCausalLM(jcfg), config=dict(config),
        model_parameters=params, mesh=mesh)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(tcfg, device="cpu"), config=dict(config),
        model_parameters=params, device="cpu")
    assert jeng._param_offload is not None and teng._param_offload is not None
    assert teng._param_offload._layer_groups == \
        jeng._param_offload._layer_groups
    for i in range(3):
        batch = jllama.random_tokens(2, 16, vocab_size=512, seed=100 + i, gas=2)
        jl = float(jeng.train_batch(batch=batch, stacked=True))
        tl = float(teng.train_batch(batch=batch, stacked=True))
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   float(jeng._last_metrics["grad_norm"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(teng._last_metrics["lr"]),
                                   float(jeng._last_metrics["lr"]), rtol=1e-6)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {f"{prefix}{k}": np.asarray(v)})
        return out
    got = flat(to_flax_tree(teng.named_masters()))
    want = flat(jeng.get_params())
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_param_offload_matches_optimizer_tier_on_card():
    """The smoke's parity at TINY width on the card: the parameter tier
    (2 layers a group, the weights copied on a side stream) against the
    optimizer tier from the same seeded weights, 2 steps of bf16 flash with
    remat: the step-1 loss within rtol 1e-5 (the same bf16 weights through
    the same kernels; a missing wait between the streams would show here),
    the final masters within atol 2e-5 and rtol 2e-4, and the flash
    launches 3/1/1 per layer and micro-batch (the stream's forward, the
    group's forward, remat's recompute)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    from deepspeed_tpu_torch.ops import build
    cfg = dataclasses.replace(tiny_cfg(dtype=torch.bfloat16, remat=True,
                                       vocab_size=512, max_seq_len=256,
                                       hidden_size=128, num_heads=2,
                                       num_kv_heads=1),   # head_dim 64
                              remat_policy="dots_with_no_batch_dims_saveable")
    base = {"train_batch_size": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 3e-4}},
            "bf16": {"enabled": True},
            "data_types": {"grad_accum_dtype": "bf16"}}
    batch = random_tokens(1, 256, 512, seed=0, gas=2)

    def run(zero):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(cfg, device="cuda", seed=0),
            config={**base, "zero_optimization": {"stage": 0, **zero}})
        build.reset_launch_counts()
        losses = [float(eng.train_batch(batch=batch)) for _ in range(2)]
        return losses, [m.detach().float().cpu() for _, m in
                        eng.named_masters()], build.launch_counts()

    l1, m1, _ = run({"offload_optimizer": {"device": "cpu"}})
    l2, m2, launches = run({"offload_optimizer": {"device": "cpu"},
                            "offload_param": {"device": "cpu",
                                              "layers_per_group": 2}})
    np.testing.assert_allclose(l2[0], l1[0], rtol=1e-5)
    for a, b in zip(m2, m1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-4)
    per = 2 * cfg.num_layers * 2          # steps x layers x micro-batches
    assert {k: launches.get(k, 0) for k in ("flash_fwd", "flash_dq",
                                            "flash_dkv")} == \
        {"flash_fwd": 3 * per, "flash_dq": per, "flash_dkv": per}
