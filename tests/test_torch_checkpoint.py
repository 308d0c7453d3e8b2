"""The port's checkpoint engine (``deepspeed_tpu_torch/checkpoint/engine.py``)
at one rank, on the CPU.

Counterpart of ``tests/test_checkpoint.py`` and ``tests/test_elastic_shrink.py
:119-194``, on ``TINY_LLAMA`` in fp32 (the fp32 trajectory recipe of
``tests/test_torch_train.py``):

- the round trip at ZeRO stages 0-3 and with every optimizer: masters,
  each optimizer state, the update count, the scalars (step, loss scale,
  skipped steps), the counters, the client state and the torch generator
  state are bit-identical after a load into an engine built from another
  seed;
- a save at step 2 and a resume in a fresh engine: the third step's loss
  and the masters equal the uninterrupted run bit for bit, and the JAX
  engine's uninterrupted run on the same numpy-seeded weights and batches
  within the training tolerance of ``tests/test_torch_train.py`` (loss
  rtol 1e-4, masters atol/rtol 1e-5);
- the ``latest`` protocol, an async save committing after the wait, a
  corrupt or truncated file caught by the manifest, the provenance errors
  (another model; a changed ``train_batch_size``, a warning under
  ``strict_provenance=False``), ``load_optimizer_states=False``, the
  metric ring drained at the save (``tests/test_async_pipeline.py:225``),
  the memory tiers' state moving to the in-HBM optimizer and back;
- on the card (``-m gpu``): ``chip_smoke.py``'s ``train_resume`` check at
  Llama-3-8B width and one layer, bit for bit.
"""

import dataclasses
import json
import logging
import os
import zlib

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import engine as ckpt
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.runtime.precision import LossScaleState

RECIPE = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 1.0,
          "scheduler": {"type": "WarmupLR",
                        "params": {"warmup_min_lr": 0.0,
                                   "warmup_max_lr": 1e-3,
                                   "warmup_num_steps": 3}}}


def _cfg(**kw):
    return dataclasses.replace(tllama.TINY_LLAMA, dtype=torch.float32,
                               attention_backend="xla", **kw)


def _engine(seed=0, config=None, params=None, **cfg_kw):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.LlamaForCausalLM(_cfg(**cfg_kw), device="cpu",
                                      seed=seed),
        config=dict(config or RECIPE), model_parameters=params,
        device="cpu")
    return eng


def _batch(i):
    return tllama.random_tokens(2, 16, vocab_size=512, seed=100 + i, gas=2)


def _masters(eng):
    return {n: p.detach().clone() for n, p in eng.named_masters()}


def _states(eng):
    """Every optimizer state tensor by (name, leaf), and the count."""
    opt = getattr(eng.optimizer, "inner", eng.optimizer)
    return {(s, i): t.clone() for s in opt.STATE
            for i, t in enumerate(getattr(opt, s))}, opt.count


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the round trip
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_round_trip_bit_identical(tmp_path, stage):
    config = {**RECIPE, "zero_optimization": {"stage": stage}}
    e1 = _engine(seed=1, config=config)
    for i in range(2):
        e1.train_batch(batch=_batch(i))
    e1.loss_scale = LossScaleState(64.0, 3, 2)       # scalars off the default
    e1._skipped_steps = 1
    torch.manual_seed(1234)
    rng = torch.get_rng_state()
    e1.save_checkpoint(str(tmp_path), client_state={"epoch": 7})

    e2 = _engine(seed=99, config=config)
    torch.manual_seed(4321)
    path, client = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step2") and client == {"epoch": 7}
    _equal(_masters(e1), _masters(e2))
    (s1, c1), (s2, c2) = _states(e1), _states(e2)
    _equal(s1, s2)
    assert c1 == c2 == 2
    assert (e2.global_steps, e2.global_samples, e2.micro_steps,
            e2.step_count, e2.skipped_steps) == (2, 8, 4, 2, 1)
    assert e2.loss_scale == LossScaleState(64.0, 3, 2)
    assert torch.equal(torch.get_rng_state(), rng)


OPTIMIZERS = {"lamb": {"lr": 1e-3, "weight_decay": 0.1},
              "lion": {"lr": 1e-4}, "adagrad": {"lr": 1e-2},
              "sgd": {"lr": 1e-2, "momentum": 0.9},
              "rmsprop": {"lr": 1e-3, "momentum": 0.9}}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_every_optimizer_state_round_trips(tmp_path, name):
    config = {**RECIPE, "optimizer": {"type": name,
                                      "params": OPTIMIZERS[name]}}
    e1 = _engine(seed=1, config=config)
    e1.train_batch(batch=_batch(0))
    e1.save_checkpoint(str(tmp_path))
    saved = sorted(os.listdir(tmp_path / "global_step1" / "opt_state"))
    e2 = _engine(seed=2, config=config)
    e2.load_checkpoint(str(tmp_path))
    (s1, c1), (s2, c2) = _states(e1), _states(e2)
    assert saved == sorted({s for s, _ in s1}) and c1 == c2 == 1
    _equal(s1, s2)
    _equal(_masters(e1), _masters(e2))
    assert float(e1.train_batch(batch=_batch(1))) == \
        float(e2.train_batch(batch=_batch(1)))


def test_files_are_whole_leaves_by_flax_path(tmp_path):
    eng = _engine(seed=1)
    eng.train_batch(batch=_batch(0))
    eng.save_checkpoint(str(tmp_path), tag="t")
    d = tmp_path / "t"
    want = {n.replace(".", "/"): p for n, p in eng.named_masters()}
    for path, p in want.items():
        arr = np.load(d / "params" / f"{path}.npy")
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(arr, p.detach().numpy())
        assert (d / "opt_state" / "mu" / f"{path}.npy").exists()
    scalars = json.loads((d / "scalars.json").read_text())
    assert scalars["step"] == 1 and scalars["state_names"] == ["mu", "nu"]
    manifest = json.loads((d / "ds_manifest.json").read_text())
    rel = "params/model/embed/embedding.npy"
    data = (d / rel).read_bytes()
    assert manifest["files"][rel] == {"size": len(data),
                                      "crc32": zlib.crc32(data)}


@pytest.mark.parametrize("shape", [(), (0, 3), (7,), (33, 65)])
def test_leaf_writer_files_are_np_save_bytes(tmp_path, monkeypatch, shape):
    """Each file the writer makes is ``np.save``'s bytes, and the CRC32 it
    took while writing (pieces of 1 KiB, combined) is zlib's of the file,
    which the manifest then records without reading it back."""
    monkeypatch.setattr(ckpt, "CRC_CHUNK", 1024)
    monkeypatch.setattr(ckpt, "WRITE_INFLIGHT_BYTES", 2048)
    rng = np.random.default_rng(len(shape))
    arrays = {f"a/{i}.npy": rng.standard_normal(shape).astype(np.float32)
              for i in range(3)}
    with ckpt._LeafWriter(str(tmp_path)) as writer:
        for rel, a in arrays.items():
            writer.put(rel, torch.from_numpy(a))
    manifest = ckpt.write_manifest(str(tmp_path), sums=writer.sums)
    for rel, a in arrays.items():
        data = (tmp_path / rel).read_bytes()
        want = tmp_path / "want.npy"
        np.save(want, a)
        assert data == want.read_bytes()
        assert writer.sums[rel] == (len(data), zlib.crc32(data))
        assert manifest["files"][rel] == {"size": len(data),
                                          "crc32": zlib.crc32(data)}
        want.unlink()
    assert writer.bytes == sum(a.nbytes for a in arrays.values())
    assert ckpt.verify_manifest(str(tmp_path))


@pytest.mark.parametrize("n1,n2", [(0, 5), (3, 1), (1 << 16, 12345),
                                   (7, (1 << 20) + 3)])
def test_crc32_combine_is_zlibs(n1, n2):
    rng = np.random.default_rng(n1 + n2)
    a, b = rng.bytes(n1), rng.bytes(n2)
    assert ckpt.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == \
        zlib.crc32(a + b)


# ---------------------------------------------------------------------------
# resume against the uninterrupted runs
# ---------------------------------------------------------------------------
def test_resume_matches_uninterrupted_and_jax(tmp_path):
    """Weights from a numpy seed, three steps: uninterrupted, and two steps,
    a save, a fresh engine (another seed) resumed for the third. The port's
    two runs agree bit for bit; the JAX engine's uninterrupted run agrees
    within the training tolerance."""
    rng = np.random.default_rng(7)
    params = {n: (rng.standard_normal(tuple(p.shape)) * 0.05).astype(
        np.float32) for n, p in tllama.LlamaForCausalLM(
            _cfg(), device="cpu").named_parameters()}
    tree = {}
    for n, a in params.items():
        node = tree
        *keys, leaf = n.split(".")
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = a
    whole = _engine(seed=3, params=tree)
    straight = [float(whole.train_batch(batch=_batch(i))) for i in range(3)]
    first = _engine(seed=4, params=tree)
    resumed = [float(first.train_batch(batch=_batch(i))) for i in range(2)]
    first.save_checkpoint(str(tmp_path))
    second = _engine(seed=5)
    assert second.load_checkpoint(str(tmp_path))[0] is not None
    resumed.append(float(second.train_batch(batch=_batch(2))))
    assert resumed == straight
    _equal(_masters(whole), _masters(second))

    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    import deepspeed_tpu
    from deepspeed_tpu.comm.mesh import create_mesh
    from deepspeed_tpu.config.config import MeshConfig
    from deepspeed_tpu.models import llama as jllama
    import jax.numpy as jnp
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               attention_backend="xla")
    jeng, *_ = deepspeed_tpu.initialize(
        model=jllama.LlamaForCausalLM(jcfg), config=dict(RECIPE),
        model_parameters=tree,
        mesh=create_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    jloss = [float(jeng.train_batch(batch=_batch(i), stacked=True))
             for i in range(3)]
    np.testing.assert_allclose(resumed, jloss, rtol=1e-4)
    want = jax.tree.map(np.asarray, jeng.module_state_dict())
    for n, p in second.named_masters():
        node = want
        for k in n.split("."):
            node = node[k]
        np.testing.assert_allclose(p.detach().numpy(), node, atol=1e-5,
                                   rtol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# the latest protocol, async, integrity, provenance
# ---------------------------------------------------------------------------
def test_latest_tag_protocol(tmp_path):
    e = _engine(seed=1)
    assert e.load_checkpoint(str(tmp_path)) == (None, {})
    e.train_batch(batch=_batch(0))
    e.save_checkpoint(str(tmp_path), tag="step_a")
    e.train_batch(batch=_batch(1))
    e.save_checkpoint(str(tmp_path), tag="step_b")
    assert (tmp_path / "latest").read_text() == "step_b"
    assert ckpt.read_latest_tag(str(tmp_path)) == "step_b"
    assert not (tmp_path / "latest.tmp").exists()
    e2 = _engine(seed=3)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("step_b") and e2.global_steps == 2
    path, _ = e2.load_checkpoint(str(tmp_path), tag="step_a")
    assert path.endswith("step_a") and e2.global_steps == 1
    with pytest.raises(FileNotFoundError):
        e2.load_checkpoint(str(tmp_path), tag="step_c")


def test_async_save_commits_after_wait(tmp_path):
    config = {**RECIPE, "checkpoint": {"async_save": True}}
    e = _engine(seed=1, config=config)
    e.train_batch(batch=_batch(0))
    want = _masters(e)
    e.save_checkpoint(str(tmp_path))
    t = e._pending_ckpt
    assert t is not None and not t.daemon
    e.train_batch(batch=_batch(1))          # the snapshot is point-in-time
    ckpt.wait_pending_checkpoint(e)
    assert e._pending_ckpt is None and not t.is_alive()
    assert (tmp_path / "latest").read_text() == "global_step1"
    assert ckpt.is_committed(str(tmp_path), "global_step1")
    e2 = _engine(seed=2)
    e2.load_checkpoint(str(tmp_path))
    _equal(want, _masters(e2))
    assert e.ckpt_stats["async"] and e.ckpt_stats["snapshot"] == "host"


@pytest.mark.parametrize("fault", ["flip", "truncate", "remove"])
def test_corrupt_file_caught_by_the_manifest(tmp_path, fault):
    e = _engine(seed=1)
    e.train_batch(batch=_batch(0))
    e.save_checkpoint(str(tmp_path))
    d = tmp_path / "global_step1"
    assert ckpt.verify_manifest(str(d))
    victim = d / "opt_state" / "nu" / "model" / "final_norm" / "scale.npy"
    if fault == "flip":
        with open(victim, "r+b") as f:
            f.seek(200)
            f.write(b"\xde\xad\xbe\xef")
    elif fault == "truncate":
        os.truncate(victim, victim.stat().st_size - 4)
    else:
        victim.unlink()
    with pytest.raises(ckpt.CheckpointCorruptionError):
        ckpt.verify_manifest(str(d))
    assert not ckpt.is_committed(str(tmp_path), "global_step1")
    assert ckpt.is_committed(str(tmp_path), "global_step1", verify=False)
    e2 = _engine(seed=2)
    before = _masters(e2)
    with pytest.raises(ckpt.CheckpointCorruptionError):
        e2.load_checkpoint(str(tmp_path), tag="global_step1")
    _equal(before, _masters(e2))               # nothing was restored
    assert e2.global_steps == 0


def test_provenance_errors(tmp_path):
    e = _engine(seed=1)
    e.train_batch(batch=_batch(0))
    e.save_checkpoint(str(tmp_path))
    prov = json.loads((tmp_path / "global_step1" / "ds_meta.json")
                      .read_text())["provenance"]
    assert prov["zero"]["stage"] == 0 and prov["batch"][
        "train_batch_size"] == 4
    assert prov["sampler"]["consumed_samples"] == 4
    assert prov["params"]["count"] == sum(
        p.numel() for p in e.model.parameters())
    other = _engine(seed=2, hidden_size=64, intermediate_size=128)
    with pytest.raises(ckpt.CheckpointProvenanceError,
                       match="different model"):
        other.load_checkpoint(str(tmp_path))
    bigger = _engine(seed=3, config={**RECIPE, "train_batch_size": 8})
    with pytest.raises(ckpt.CheckpointProvenanceError,
                       match="sampler contract"):
        bigger.load_checkpoint(str(tmp_path))
    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    ckpt.logger.addHandler(handler)
    try:
        path, _ = bigger.load_checkpoint(str(tmp_path),
                                         strict_provenance=False)
    finally:
        ckpt.logger.removeHandler(handler)
    assert path is not None and bigger.global_steps == 1
    assert any("sampler contract" in m and "override active" in m
               for m in seen)
    # an optimizer whose state the checkpoint lacks (SGD's trace beside
    # Adam's mu and nu) is classified, as the JAX package classifies
    # moments it cannot mine
    sgd = _engine(seed=4, config={**RECIPE, "optimizer": {
        "type": "sgd", "params": {"lr": 1e-2, "momentum": 0.9}}})
    with pytest.raises(ckpt.CheckpointProvenanceError,
                       match="load_optimizer_states=False"):
        sgd.load_checkpoint(str(tmp_path))
    assert sgd.global_steps == 0


def test_weights_only_load_keeps_fresh_moments(tmp_path):
    e = _engine(seed=1)
    e.train_batch(batch=_batch(0))
    e.save_checkpoint(str(tmp_path))
    e2 = _engine(seed=2)
    fresh, count = _states(e2)
    e2.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    _equal(_masters(e), _masters(e2))
    _equal(fresh, _states(e2)[0])
    assert count == 0 and e2.global_steps == 1


def test_save_drains_the_metric_ring(tmp_path):
    config = {**RECIPE, "async_pipeline": {"enabled": True,
                                           "sync_every": 8}}
    e = _engine(seed=1, config=config)
    for i in range(3):
        e.train_batch(batch=_batch(i))
    assert len(e._metric_ring) == 3
    e.save_checkpoint(str(tmp_path / "ckpt"))
    assert e._metric_ring == []
    assert [m["step"] for m in e.take_drained_metrics()] == [1, 2, 3]


# ---------------------------------------------------------------------------
# the memory tiers at one rank
# ---------------------------------------------------------------------------
TIERS = {"offload_cpu": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
         "param_cpu": {"stage": 0, "offload_param": {"device": "cpu"}}}


@pytest.mark.parametrize("tier", list(TIERS))
def test_tier_state_moves_to_hbm_and_back(tmp_path, tier):
    """An in-HBM checkpoint restores into a tier engine (the moments become
    the host kernel's buffers) and the tier's checkpoint back into an
    in-HBM engine, every leaf and moment bit for bit."""
    hbm = {**RECIPE, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 3}}
    host = {**hbm, "zero_optimization": TIERS[tier]}
    if tier == "param_cpu":
        hbm["gradient_accumulation_steps"] = host[
            "gradient_accumulation_steps"] = 1
        hbm["train_batch_size"] = host["train_batch_size"] = 2
    e1 = _engine(seed=1, config=hbm)
    e1.train_batch(batch={k: v[:1] for k, v in _batch(0).items()}
                   if tier == "param_cpu" else _batch(0), stacked=True)
    e1.save_checkpoint(str(tmp_path / "hbm"))
    e2 = _engine(seed=2, config=host)
    e2.load_checkpoint(str(tmp_path / "hbm"))
    _equal(_masters(e1), _masters(e2))
    s1, _ = _states(e1)
    for i in range(len(e1._paths)):
        for k, name in enumerate(("mu", "nu")):
            assert torch.equal(s1[(name, i)], e2._offload.leaf_states(i)[k])
    assert e2._offload.kernel.step_count == 1
    if tier == "param_cpu":      # the streamed store follows the masters
        e2._param_offload.sync_store()
    e2.save_checkpoint(str(tmp_path / "host"))
    e3 = _engine(seed=3, config=hbm)
    e3.load_checkpoint(str(tmp_path / "host"))
    _equal(_masters(e1), _masters(e3))
    _equal(s1, _states(e3)[0])
    side = json.loads((tmp_path / "host" / "global_step1" /
                       "offload_state_proc0.json").read_text())
    assert side["step_count"] == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_train_resume_bit_for_bit_on_card(tmp_path):
    """``chip_smoke.py``'s ``train_resume`` at Llama-3-8B width and one
    layer: the reference run, then two steps, a sync save, a third step, an
    async save, the step-3 tag torn, a fresh process resuming from
    ``global_step2`` to the last step: losses and masters bit for bit,
    flash launches exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")
    import chip_smoke
    row = chip_smoke.run_train_resume(str(tmp_path), layers=1)
    assert row["bitwise_losses"] and row["bitwise_masters"]
    assert row["resumed_tag"] == "global_step2"
