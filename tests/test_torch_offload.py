"""The port's optimizer-state tier (ZeRO-Offload, ZeRO-Infinity's NVMe
moments) against the JAX package.

Mirrors ``tests/test_offload.py`` on ``TINY_LLAMA`` (the JAX file's
``SimpleModel`` is not ported), ``device="cpu"``:

- the host kernels: ``CPUAdam``, ``CPUAdagrad``, ``CPULion`` and
  ``to_bf16``, built by ``g++`` from the port's copy of ``cpu_adam.cpp``,
  equal the JAX package's native wrappers bit for bit on the same numpy
  inputs (one source, one compiler, the same flags), and their plain torch
  versions within rtol 1e-6 (the compiler may fuse products and sums); the
  aio engine's round trip and many requests at once;
- the engine: the CPU and NVMe tiers train, an optimizer without a host
  kernel raises, Lion and Adagrad train, the module holds compute-dtype
  parameters and no optimizer state, fp16 overflow skips the host step,
  ``swap_masters`` true and false, the optimizer's ``state_dict`` round
  trip and the same state through ``save_checkpoint`` /
  ``load_checkpoint``, the micro-step calls run the tier's host update (``train_batch``'s
  masters bit for bit), the tier against the in-HBM engine
  (atol 2e-5, rtol 2e-4, the JAX file's tolerance), gradients brought down
  in small chunks equal to whole leaves, bit for bit;
- the cross-check: the same flax weights and batches through
  ``deepspeed_tpu.initialize`` and ``deepspeed_tpu_torch.initialize`` with
  ``offload_optimizer`` cpu: loss, gradient norm and lr within rtol 1e-4,
  the final masters within atol 1e-5 (the tolerances of
  ``test_torch_train.py::test_train_batch_trajectory_matches_jax``).

``test_offload_matches_in_hbm_on_card`` (marked ``gpu``) repeats the
in-HBM parity on the card, where the kernels run.
"""

import dataclasses
import glob
import math

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import (TINY_LLAMA, LlamaForCausalLM,
                                              random_tokens)
from deepspeed_tpu_torch.ops import cpu_adam as tcpu
from deepspeed_tpu_torch.ops.async_io import AsyncIOHandle
from deepspeed_tpu_torch.runtime import engine as engine_mod
from deepspeed_tpu_torch.runtime.offload import UnsupportedOffloadOptimizer

ADAMW = {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.0}}


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


def _jax_cpu_adam():
    pytest.importorskip("flax")
    pytest.importorskip("jax")
    from deepspeed_tpu.ops import cpu_adam as jcpu
    return jcpu


# ---------------------------------------------------------------------------
# the host kernels
# ---------------------------------------------------------------------------
def _inputs(n=4097, seed=0, states=2):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    s = [np.abs(rng.normal(size=n)).astype(np.float32) * 1e-2
         for _ in range(states)]
    grads = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    return p, s, grads


KERNELS = {
    "adam": (2, dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.01)),
    "adam_l2": (2, dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8,
                        weight_decay=0.01, adamw_mode=False)),
    "adagrad": (1, dict(lr=1e-2, eps=1e-10, weight_decay=0.01)),
    "lion": (1, dict(lr=1e-3, betas=(0.9, 0.99), weight_decay=0.01)),
}
CLASSES = {"adam": "CPUAdam", "adam_l2": "CPUAdam", "adagrad": "CPUAdagrad",
           "lion": "CPULion"}


def _plain(name, kw, p, g, states, step):
    if name.startswith("adam"):
        tcpu.adam_step_plain(p, g, *states, kw["lr"], *kw["betas"], kw["eps"],
                             kw["weight_decay"], kw.get("adamw_mode", True),
                             step)
    elif name == "adagrad":
        tcpu.adagrad_step_plain(p, g, *states, kw["lr"], kw["eps"],
                                kw["weight_decay"])
    else:
        tcpu.lion_step_plain(p, g, *states, kw["lr"], *kw["betas"],
                             kw["weight_decay"])


@pytest.mark.parametrize("name", list(KERNELS))
def test_host_kernels_equal_jax_bit_for_bit_and_plain(name):
    """Three steps of each kernel from the same numpy inputs: the port's
    library and the JAX package's (both native) give the same bits, and the
    plain torch version agrees within rtol 1e-6."""
    jcpu = _jax_cpu_adam()
    n_states, kw = KERNELS[name]
    p0, s0, grads = _inputs(states=n_states)
    ours = getattr(tcpu, CLASSES[name])(**kw)
    ref = getattr(jcpu, CLASSES[name])(**kw)
    assert ref._fn is not None, "the JAX package's native kernel did not build"
    p, s = torch.from_numpy(p0.copy()), [torch.from_numpy(x.copy()) for x in s0]
    jp, js = p0.copy(), [x.copy() for x in s0]
    pp, ps = p.clone(), [x.clone() for x in s]
    for step, g in enumerate(grads, 1):
        ours.step(p, torch.from_numpy(g), *s)
        ref.step(jp, g, *js)
        _plain(name, kw, pp, torch.from_numpy(g), ps, step)
    for a, b in zip([p, *s], [jp, *js]):
        assert np.array_equal(a.numpy().view(np.uint32), b.view(np.uint32))
    for a, b in zip([p, *s], [pp, *ps]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    assert ours.step_count == ref.step_count == 3


def test_to_bf16_equals_jax_and_plain():
    jcpu = _jax_cpu_adam()
    import ctypes
    jcpu._load_sym("fp32_to_bf16", [ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_uint16),
                                    ctypes.c_int64])   # native, or it raises
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=5001).astype(np.float32) * 10.0,
                        np.float32([0.0, -0.0, 1.0 + 2.0 ** -8,  # exact tie
                                    1.0 + 3 * 2.0 ** -8, 3.4e38, 1e-40])])
    ours = tcpu.to_bf16(torch.from_numpy(x))
    ref = jcpu.to_bf16(x)
    assert ours.dtype == torch.bfloat16
    assert np.array_equal(ours.view(torch.int16).numpy().view(np.uint16),
                          ref.view(np.uint16))
    assert torch.equal(ours.view(torch.int16),
                       tcpu.to_bf16_plain(torch.from_numpy(x)).view(torch.int16))
    out = torch.empty(len(x), dtype=torch.bfloat16)
    assert tcpu.to_bf16(torch.from_numpy(x), out=out) is out


def test_cpu_adam_matches_reference():
    """The JAX file's numpy AdamW reference, three steps (odd size)."""
    rng = np.random.default_rng(0)
    n = 4097
    p = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    p_ref = p.numpy().copy()
    m, v = torch.zeros(n), torch.zeros(n)
    m_ref, v_ref = np.zeros(n, np.float32), np.zeros(n, np.float32)
    opt = tcpu.CPUAdam(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.01)
    for step in range(1, 4):
        g = rng.normal(size=n).astype(np.float32)
        opt.step(p, torch.from_numpy(g), m, v)
        m_ref = 0.9 * m_ref + 0.1 * g
        v_ref = 0.99 * v_ref + 0.01 * g ** 2
        p_ref = p_ref - 1e-2 * ((m_ref / (1 - 0.9 ** step))
                                / (np.sqrt(v_ref / (1 - 0.99 ** step)) + 1e-8)
                                + 0.01 * p_ref)
    np.testing.assert_allclose(p.numpy(), p_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(m.numpy(), m_ref, atol=1e-6)


def test_host_kernels_refuse_what_they_do_not_take():
    opt = tcpu.CPUAdam()
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="float32"):
        opt.step(x.double(), x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        opt.step(torch.zeros(8, 2)[:, 0], x, x, x)
    with pytest.raises(ValueError, match="one size"):
        opt.step(x, torch.zeros(9), x, x)
    assert tcpu.host_threads() >= 1


def test_aio_roundtrip(tmp_path):
    h = AsyncIOHandle(num_threads=4)
    data = torch.from_numpy(np.random.default_rng(1).normal(
        size=1 << 16).astype(np.float32))
    path = str(tmp_path / "swap.bin")
    assert h.wait(h.async_pwrite(data, path)) == 0
    out = torch.empty_like(data)
    rid = h.async_pread(out, path)
    assert h.wait(rid) == 0
    assert torch.equal(out, data)
    assert h.wait(h.async_pread(out, str(tmp_path / "missing.bin"))) == 1
    h.close()


def test_aio_many_concurrent(tmp_path):
    h = AsyncIOHandle(num_threads=8)
    arrays = [torch.full((4096,), float(i)) for i in range(16)]
    for i, a in enumerate(arrays):
        h.async_pwrite(a, str(tmp_path / f"f{i}.bin"))
    assert h.drain() == 0
    outs = [torch.empty_like(a) for a in arrays]
    reqs = [h.async_pread(o, str(tmp_path / f"f{i}.bin"))
            for i, o in enumerate(outs)]
    assert all(h.is_done(r) or h.wait(r) == 0 for r in reqs)
    assert h.drain() == 0
    for o, a in zip(outs, arrays):
        assert torch.equal(o, a)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _cfg(**kw):
    base = dict(dtype=torch.float32, attention_backend="flash")
    base.update(kw)
    return dataclasses.replace(TINY_LLAMA, **base)


def _engine(zero=None, cfg=None, seed=0, gas=2, **extra):
    config = {"train_batch_size": 2 * gas, "gradient_accumulation_steps": gas,
              "optimizer": ADAMW, **extra}
    if zero is not None:
        config["zero_optimization"] = {"stage": 0, **zero}
    model = LlamaForCausalLM(cfg or _cfg(), device="cpu", seed=seed)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                device="cpu")
    return engine


def _train(engine, steps=4, gas=2, fixed=True):
    """Losses over ``steps``; one fixed batch, so the loss must fall."""
    return [float(engine.train_batch(batch=random_tokens(
        2, 32, 512, seed=0 if fixed else i, gas=gas))) for i in range(steps)]


def _max_diff(a, b):
    return max(float((x - y).abs().max())
               for (_, x), (_, y) in zip(a.named_masters(), b.named_masters()))


CPU = {"offload_optimizer": {"device": "cpu"}}


def test_zero_offload_cpu_training():
    engine = _engine(CPU)
    losses = _train(engine)
    assert losses[-1] < losses[0]
    assert engine._offload is not None and engine.optimizer is engine._offload
    assert set(engine.phase_seconds) == {"device_fwd_bwd", "d2h", "shadow",
                                         "h2d", "host_optimizer"}
    n = sum(math.prod(s) for s in engine._offload.leaf_shapes())
    assert engine.phase_bytes == {"d2h": 4 * n, "h2d": 4 * n}


def test_zero_infinity_nvme_training(tmp_path):
    engine = _engine({"offload_optimizer": {"device": "nvme",
                                            "nvme_path": str(tmp_path)}})
    losses = _train(engine)
    assert losses[-1] < losses[0]
    assert glob.glob(str(tmp_path / "proc0" / "state0_*.bin"))


def test_offload_unsupported_optimizer_raises():
    """sgd has no fused host kernel: fail loudly, never run Adam instead."""
    with pytest.raises(UnsupportedOffloadOptimizer):
        _engine(CPU, optimizer={"type": "sgd", "params": {"lr": 1e-2}})
    with pytest.raises(ValueError, match="none|cpu|nvme"):
        _engine({"offload_optimizer": {"device": "disk"}})
    with pytest.raises(ValueError, match="config-typed optimizer"):
        deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(_cfg(), device="cpu"), optimizer=object(),
            config={"train_batch_size": 2, "zero_optimization": CPU},
            device="cpu")


@pytest.mark.parametrize("opt", ["lion", "adagrad"])
def test_offload_lion_and_adagrad_train(opt):
    engine = _engine(CPU, optimizer={"type": opt, "params": {"lr": 1e-3}})
    assert type(engine._offload.kernel).__name__ == \
        {"lion": "CPULion", "adagrad": "CPUAdagrad"}[opt]
    losses = _train(engine)
    assert losses[-1] < losses[0], f"{opt} loss did not decrease: {losses}"


def test_offload_device_holds_no_optimizer_state():
    engine = _engine(CPU, cfg=_cfg(dtype=torch.bfloat16),
                     bf16={"enabled": True})
    _train(engine, steps=1)
    module = list(engine.model.parameters())
    assert all(p.dtype == torch.bfloat16 for p in module)
    masters = engine._offload.masters()
    assert all(m.dtype == torch.float32 for m in masters)
    assert not any(m.data_ptr() == p.data_ptr()
                   for m, p in zip(masters, module))
    for leaf in engine._offload.leaves:
        assert all(s.device.type == "cpu" for s in leaf.states)


def test_offload_bf16_shadows_on_device():
    """bf16 compute: the module holds the bf16 shadows of the fp32 masters,
    each the round-to-nearest-even of its master after every step."""
    engine = _engine(CPU, cfg=_cfg(dtype=torch.bfloat16),
                     bf16={"enabled": True})
    losses = _train(engine, steps=6)
    assert losses[-1] < losses[0]
    for p, (_, m) in zip(engine.model.parameters(), engine.named_masters()):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p.view(torch.int16),
                           m.to(torch.bfloat16).view(torch.int16))


def test_offload_fp16_overflow_skips_step():
    """A non-finite gradient skips the host update and shrinks the loss
    scale, never writing NaN into the masters or moments."""
    engine = _engine(CPU, cfg=_cfg(dtype=torch.float16), gas=1,
                     fp16={"enabled": True, "initial_scale_power": 4,
                           "hysteresis": 1})
    engine.loss_fn = lambda loss, batch: loss * float("inf")
    before = [m.clone() for m in engine._offload.masters()]
    scale = engine.cur_scale()
    engine.train_batch(batch=random_tokens(2, 16, 512, gas=1), stacked=True)
    assert engine.skipped_steps == 1 and engine.cur_scale() < scale
    assert engine._offload.kernel.step_count == 0
    for a, b in zip(before, engine._offload.masters()):
        assert torch.equal(a, b)
    for leaf in engine._offload.leaves:
        assert all(torch.isfinite(s).all() for s in leaf.states)


def test_offload_micro_step_protocol_raises():
    """The micro-step protocol under the optimizer tier: ``backward``
    without a ``forward`` raises as the reference's does; gas forward /
    backward pairs and ``step`` run the tier's host update and land on
    ``train_batch``'s masters bit for bit."""
    loop, fused = _engine(CPU), _engine(CPU)
    with pytest.raises(RuntimeError, match="without a preceding forward"):
        loop.backward()
    batch = random_tokens(2, 16, 512, gas=2)
    for i in range(2):
        loss = loop.forward({k: v[i] for k, v in batch.items()})
        loop.backward(loss)
        loop.step()
    fused.train_batch(batch=batch, stacked=True)
    assert loop.global_steps == fused.global_steps == 1
    assert loop._offload.kernel.step_count == 1
    for a, b in zip(loop._offload.masters(), fused._offload.masters()):
        assert torch.equal(a, b)


def test_offload_state_dict_round_trip(tmp_path):
    """The checkpoint round trip by the host optimizer's state: restoring
    masters, moments and the step count into an engine of other weights
    makes its next step equal the original's next step bit for bit; so
    does the same state through save_checkpoint / load_checkpoint."""
    e1 = _engine(CPU, seed=11)
    _train(e1, steps=3)
    sd = e1.optimizer.state_dict()
    e1.save_checkpoint(str(tmp_path))
    e2 = _engine(CPU, seed=99)
    assert _max_diff(e1, e2) > 0
    e2.optimizer.load_state_dict(sd)
    for p, m in zip(e2._masters, e2._offload.masters()):     # the shadows
        p.data.copy_(m)
    e2.step_count = e1.step_count
    assert e2._offload.kernel.step_count == e1._offload.kernel.step_count == 3
    assert _max_diff(e1, e2) == 0
    e3 = _engine(CPU, seed=7)
    e3.load_checkpoint(str(tmp_path))
    assert e3._offload.kernel.step_count == 3
    assert _max_diff(e1, e3) == 0
    _train(e1, steps=1)
    _train(e2, steps=1)
    _train(e3, steps=1)
    assert _max_diff(e1, e2) == 0
    assert _max_diff(e1, e3) == 0


def test_offload_matches_in_hbm_adamw():
    """Host CPU Adam == the in-HBM AdamW of the same config, at lr 1e-3
    (the trajectory test's): the two put Adam's epsilon at other rounding
    points, and at lr 1e-2 an element whose gradient is rounding noise
    (0.25% of the embedding here) takes steps of +-lr either way."""
    opt = {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.0}}
    e1 = _engine(None, seed=9, optimizer=opt)
    e2 = _engine(CPU, seed=9, optimizer=opt)
    l1, l2 = _train(e1, steps=5, fixed=False), _train(e2, steps=5, fixed=False)
    np.testing.assert_allclose(l1, l2, rtol=1e-4)
    for (n, a), (_, b) in zip(e1.named_masters(), e2.named_masters()):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-4, err_msg=n)


def test_staging_chunks_equal_whole_leaves(monkeypatch):
    """Gradients brought down and shadows sent up 10,007 elements at a
    time (chunks that cut leaves mid-row) give the same masters, bit for
    bit, as whole leaves; with a gradient clip, which scales each chunk by
    the same factor."""
    whole = _engine(CPU, gradient_clipping=0.5)
    monkeypatch.setattr(engine_mod, "STAGING_ELEMS", 10007)
    chunked = _engine(CPU, gradient_clipping=0.5)
    assert chunked._staging.elems == 10007
    assert _train(whole) == _train(chunked)
    assert _max_diff(whole, chunked) == 0
    for p, q in zip(whole._masters, chunked._masters):
        assert torch.equal(p, q)


def test_nvme_masters_swapped_full_infinity(tmp_path):
    """device=nvme: the fp32 masters live in files too, not in RAM between
    steps, and training equals the CPU tier's exactly."""
    nvme = {"offload_optimizer": {"device": "nvme", "nvme_path": str(tmp_path)}}
    e1 = _engine(nvme, seed=5)
    l1 = _train(e1)
    assert l1[-1] < l1[0]
    assert glob.glob(str(tmp_path / "proc0" / "master_*.bin"))
    assert all(leaf.master is None for leaf in e1._offload.leaves
               if leaf.master_path)
    e2 = _engine(CPU, seed=5)
    assert _train(e2) == l1
    assert _max_diff(e1, e2) == 0


def test_nvme_swap_masters_false_keeps_masters_in_ram(tmp_path):
    e = _engine({"offload_optimizer": {"device": "nvme",
                                       "nvme_path": str(tmp_path),
                                       "swap_masters": False}})
    losses = _train(e, steps=6)
    assert losses[-1] < losses[0]
    assert all(leaf.master is not None for leaf in e._offload.leaves)
    assert not glob.glob(str(tmp_path / "proc0" / "master_*.bin"))
    assert glob.glob(str(tmp_path / "proc0" / "state1_*.bin"))


def test_param_offload_nvme_with_master_swap(tmp_path):
    """offload_param nvme and masters on nvme compose: weights stream from
    files and the fp32 masters round-trip through files each step."""
    cfg = _cfg(vocab_size=128, hidden_size=32, intermediate_size=64,
               num_layers=2, num_heads=2, num_kv_heads=2, max_seq_len=32,
               attention_backend="xla")
    engine = _engine({"offload_param": {"device": "nvme",
                                        "nvme_path": str(tmp_path)},
                      "offload_optimizer": {"device": "nvme",
                                            "nvme_path": str(tmp_path)}},
                     cfg=cfg, gas=1)
    fixed = random_tokens(2, 16, 128, seed=0)
    losses = [float(engine.train_batch(batch=fixed)) for _ in range(4)]
    assert losses[-1] < losses[0], losses
    assert glob.glob(str(tmp_path / "proc0" / "master_*.bin"))
    assert glob.glob(str(tmp_path / "params_proc0" / "group*.bin"))


# ---------------------------------------------------------------------------
# the cross-check with the JAX engine
# ---------------------------------------------------------------------------
# the fp32 config of test_torch_train.py's trajectory test (AdamW with
# decay, clipping, WarmupLR), through either optimizer tier
TRAJECTORY = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.1}},
              "gradient_clipping": 1.0,
              "scheduler": {"type": "WarmupLR",
                            "params": {"warmup_min_lr": 0.0,
                                       "warmup_max_lr": 1e-3,
                                       "warmup_num_steps": 3}}}
CROSS = {"cpu": {"device": "cpu"}, "nvme": {"device": "nvme"}}


@pytest.mark.parametrize("case", list(CROSS))
def test_offload_trajectory_matches_jax(case, tmp_path):
    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    import deepspeed_tpu
    from deepspeed_tpu.comm.mesh import create_mesh
    from deepspeed_tpu.config.config import MeshConfig
    from deepspeed_tpu.models import llama as jllama
    from deepspeed_tpu_torch.models.convert import to_flax_tree
    offload = dict(CROSS[case])
    import jax.numpy as jnp
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               attention_backend="flash")
    params = jax.tree.map(np.asarray, jllama.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jllama.random_tokens(1, 8, 512))["params"])
    def config(side):                  # each engine its own state files
        path = {"nvme_path": str(tmp_path / side)} if case == "nvme" else {}
        return {**TRAJECTORY, "zero_optimization": {
            "stage": 0, "offload_optimizer": {**offload, **path}}}
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(
        model=jllama.LlamaForCausalLM(jcfg), config=config("jax"),
        model_parameters=params, mesh=mesh)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(_cfg(), device="cpu"), config=config("port"),
        model_parameters=params, device="cpu")
    assert jeng._offload is not None and teng._offload is not None
    for i in range(3):
        batch = jllama.random_tokens(2, 16, vocab_size=512, seed=100 + i, gas=2)
        jl = float(jeng.train_batch(batch=batch, stacked=True))
        tl = float(teng.train_batch(batch=batch, stacked=True))
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4)
        np.testing.assert_allclose(teng.get_lr()[0], jeng.get_lr()[0],
                                   rtol=1e-6)
    want = jax.tree_util.tree_unflatten(jeng._params_treedef,
                                        jeng._offload.masters())

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {f"{prefix}{k}": v})
        return out
    got, want = flat(to_flax_tree(teng.named_masters())), flat(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_offload_matches_in_hbm_on_card():
    """The smoke's parity at TINY width on the card: the optimizer tier
    (bf16 shadows on the card, the host AdamW) against the in-HBM engine
    from the same seeded weights (AdamW without decay: the in-HBM default
    decays, the host kernel's does not), 2 steps of the flash backend with
    remat: each loss within rtol 1e-3, the final masters within atol 2e-5 and
    rtol 2e-4; then the NVMe tier equal to the CPU tier bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    import tempfile
    cfg = dataclasses.replace(TINY_LLAMA, num_layers=4, num_heads=2,
                              num_kv_heads=1,    # head_dim 64, the kernel's
                              dtype=torch.bfloat16,
                              attention_backend="flash", remat=True,
                              remat_policy="dots_with_no_batch_dims_saveable")
    base = {"train_batch_size": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 3e-4, "weight_decay": 0.0}},
            "bf16": {"enabled": True},
            "data_types": {"grad_accum_dtype": "bf16"}}
    batch = random_tokens(1, 128, 512, seed=0, gas=2)

    def run(zero):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(cfg, device="cuda", seed=0),
            config={**base, "zero_optimization": {"stage": 0, **zero}})
        losses = [float(eng.train_batch(batch=batch)) for _ in range(2)]
        return losses, [m.detach().float().cpu() for _, m in eng.named_masters()]

    l0, m0 = run({})
    l1, m1 = run(CPU)
    np.testing.assert_allclose(l1, l0, rtol=1e-3)
    for a, b in zip(m1, m0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-4)
    with tempfile.TemporaryDirectory() as d:
        l2, m2 = run({"offload_optimizer": {"device": "nvme", "nvme_path": d}})
    assert l2 == l1
    assert all(torch.equal(a, b) for a, b in zip(m2, m1))


@pytest.mark.gpu
def test_offload_ranks_match_one_rank_on_card(tmp_path):
    """The smoke's ``train_offload_ranks`` at TINY width on the card: two
    gloo ranks, the optimizer tier at ZeRO stage 2 over fsdp=2 against
    the one-rank tier from the same seeded weights and global batch
    (``chip_smoke.tier_ranks_body`` in fp32 on the plain attention
    backend), within the one-rank tier's summation-order tolerance; with
    the parameter tier over data=2 and tensor=2 beside it, each rank's
    host bytes its block's and every op's bytes exact
    (``chip_smoke.check_tier_ranks``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from torch_offload_ranks import run_smoke_tier_ranks
    rows, res = run_smoke_tier_ranks(tmp_path, "cuda")
    gaps = res["gaps"]["offload_fsdp2"]
    assert gaps["masters_share"] <= gaps["tolerance"]["masters_share"]
    run = rows[0]["runs"]["offload_fsdp2"]
    assert 0.45 < run["host_numel"] / rows[0]["params"] < 0.55

