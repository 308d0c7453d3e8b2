"""The async step pipeline and the data loader, against the JAX package's.

Mirrors ``tests/test_async_pipeline.py:54-222``, ``tests/test_sched.py:54-127``
and ``tests/test_engine.py:219`` case for case on the port
(``SimpleModel(hidden_dim=32)``, Adam lr 1e-2, 8 rows a step, the JAX
engine's initial weights carried over), all on the CPU:

- ``PrefetchLoader``: the source's order and end, a sticky end, ``stage_fn``
  applied and its error raised at ``__next__``;
- numerics: ``sync_every`` 1 and 8, with and without prefetch, give the
  same losses and masters bit for bit, and losses within 1e-6 of the JAX
  engine's;
- readback: ``steps / sync_every`` transfers (the ring's count), the
  drained entries ordered and complete, the monitor's rows at the drain,
  the runtime toggle, the pipeline refused on the host tier;
- ``DispatchRing`` / ``StagedPrefetcher`` units;
- the loader: ``drop_last``, ``len()``, the last partial batch and the
  ``seed + epoch`` shuffle equal to the JAX loader's batches, and
  ``initialize(training_data=)`` feeding ``train_batch`` through
  ``RepeatingLoader`` with prefetch as the stacked batches do.

The cases there that need checkpoints, the step guard or the runner
(``tests/test_async_pipeline.py:246-405``) wait for ROADMAP Queue 1 item 6b;
``flush_metrics`` at a save is held in ``tests/test_torch_checkpoint.py``.
``test_prefetch_matches_sync_on_card`` (marked ``gpu``) runs TINY_LLAMA
widths on the card, where the staged copies ride a side stream.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.simple import (SimpleModel, random_batch,
                                               random_dataset)
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedTPUDataLoader,
                                                    PrefetchLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.sched import DispatchRing, StagedPrefetcher

CFG = {
    "train_batch_size": 8,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
}


@pytest.fixture(scope="module")
def jax_engine_params():
    """The JAX engine's initial SimpleModel weights (seed 1) and that
    engine's synchronous losses over 8 seeded batches."""
    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    import deepspeed_tpu
    from deepspeed_tpu.models import simple as jsimple
    engine, *_ = deepspeed_tpu.initialize(
        model=jsimple.SimpleModel(hidden_dim=32), config=dict(CFG),
        example_batch=jsimple.random_batch(4), seed=1)
    params = jax.tree.map(np.asarray, jax.device_get(engine.state.params))
    losses = [float(engine.train_batch(batch=jsimple.random_batch(8, seed=i)))
              for i in range(8)]
    return params, losses


def _engine(params=None, extra=None):
    cfg = dict(CFG)
    if extra:
        cfg.update(extra)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=SimpleModel(hidden_dim=32, device="cpu", seed=1),
        config=cfg, model_parameters=params, device="cpu")
    return engine


def _params(engine):
    return [p.detach().cpu().clone() for _, p in engine.named_masters()]


def _async_cfg(sync_every, prefetch=False):
    return {"async_pipeline": {"enabled": True, "sync_every": sync_every,
                               "prefetch": prefetch}}


# ---------------------------------------------------------------------------
# PrefetchLoader
# ---------------------------------------------------------------------------
def test_prefetch_loader_preserves_order_and_ends():
    src = [{"x": np.full((2,), i)} for i in range(17)]
    out = list(PrefetchLoader(iter(src), depth=2))
    assert len(out) == 17
    for i, item in enumerate(out):
        assert item["x"][0] == i          # exact source order


def test_prefetch_loader_exhaustion_is_sticky():
    pl = PrefetchLoader(iter(range(2)), depth=2)
    assert list(pl) == [0, 1]
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(pl)
    pl2 = PrefetchLoader(iter(range(100)), depth=2)
    next(pl2)
    pl2.close()
    with pytest.raises(StopIteration):
        next(pl2)


def test_prefetch_loader_applies_stage_fn_and_propagates_errors():
    def bad_stage(item):
        if item == 3:
            raise ValueError("boom")
        return item * 10

    pl = PrefetchLoader(iter(range(5)), stage_fn=bad_stage, depth=2)
    assert next(pl) == 0
    assert next(pl) == 10
    assert next(pl) == 20
    with pytest.raises(ValueError, match="boom"):
        next(pl)
    pl.close()


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------
def test_bit_identical_params_and_losses_sync1_vs_sync8_vs_prefetch(
        jax_engine_params):
    params, jax_losses = jax_engine_params
    steps = 8
    batches = [random_batch(8, seed=i) for i in range(steps)]

    sync = _engine(params)
    sync_losses = [float(sync.train_batch(batch=b)) for b in batches]

    lagged = _engine(params, _async_cfg(8))
    lagged_losses = [lagged.train_batch(batch=b) for b in batches]
    lagged.flush_metrics()
    lagged_losses = [float(x) for x in lagged_losses]

    pre = _engine(params, _async_cfg(8, prefetch=True))
    it = iter(batches)
    pre_losses = [pre.train_batch(data_iter=it) for _ in range(steps)]
    pre.flush_metrics()
    pre_losses = [float(x) for x in pre_losses]

    assert sync_losses == lagged_losses == pre_losses
    for a, b, c in zip(_params(sync), _params(lagged), _params(pre)):
        assert torch.equal(a, b)
        assert torch.equal(a, c)          # bit-identical, not approx
    np.testing.assert_allclose(sync_losses, jax_losses, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# readback
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sync_every,want", [(1, 8), (8, 1), (3, 2)])
def test_deferred_readback_transfer_count(sync_every, want):
    """N steps cost ceil(N / sync_every) drains, each one transfer: the
    two the 8th step leaves pending under 3 wait for the next drain."""
    engine = _engine(extra=_async_cfg(sync_every))
    for i in range(8):
        engine.train_batch(batch=random_batch(8, seed=i))
    assert engine._sched.transfers == want
    assert len(engine._metric_ring) == 8 - want * sync_every
    engine.flush_metrics()
    assert engine._sched.transfers == -(-8 // sync_every)


def test_drained_entries_ordered_and_complete():
    engine = _engine(extra=_async_cfg(3))
    for i in range(7):
        engine.train_batch(batch=random_batch(8, seed=i))
    assert len(engine._metric_ring) == 1            # 7 = 2 drains * 3 + 1
    flushed = engine.flush_metrics()
    assert len(flushed) == 1
    entries = engine.take_drained_metrics()
    assert [e["step"] for e in entries] == list(range(1, 8))
    for e in entries:
        assert {"step", "samples", "loss", "grad_norm", "lr", "overflow",
                "loss_scale"} <= set(e)
        assert isinstance(e["loss"], float)
    assert engine.take_drained_metrics() == []
    assert isinstance(engine._last_metrics["loss"], float)
    # requeued entries come back first, in order
    engine.requeue_drained_metrics(entries[:2])
    assert [e["step"] for e in engine.take_drained_metrics()] == [1, 2]
    # the reconciled window was booked as step time, one record a step
    from deepspeed_tpu_torch.utils.timer import TRAIN_BATCH_TIMER
    assert len(engine.timers(TRAIN_BATCH_TIMER)._records) == 7


def test_monitor_events_land_at_drain(tmp_path):
    engine = _engine(extra={
        **_async_cfg(4),
        "steps_per_print": 2,
        "csv_monitor": {"enabled": True, "output_path": str(tmp_path),
                        "job_name": "async"}})
    for i in range(8):
        engine.train_batch(batch=random_batch(8, seed=i))
    engine.flush_metrics()
    d = tmp_path / "async"
    loss_rows = (d / "Train_Samples_train_loss.csv").read_text().strip()
    assert len(loss_rows.splitlines()) == 1 + 4     # header + steps 2,4,6,8
    assert (d / "Train_Samples_steps_per_sec.csv").exists()


def test_monitor_events_without_the_pipeline(tmp_path):
    """The synchronous path writes the same rows at the print boundary."""
    engine = _engine(extra={
        "steps_per_print": 2,
        "csv_monitor": {"enabled": True, "output_path": str(tmp_path),
                        "job_name": "sync"}})
    for i in range(4):
        engine.train_batch(batch=random_batch(8, seed=i))
    rows = (tmp_path / "sync" / "Train_Samples_lr.csv").read_text()
    assert len(rows.strip().splitlines()) == 1 + 2
    assert not (tmp_path / "sync" / "Train_Samples_steps_per_sec.csv").exists()


def test_configure_async_pipeline_runtime_toggle():
    engine = _engine()
    assert not engine._async_enabled
    engine.configure_async_pipeline(enabled=True, sync_every=4)
    for i in range(3):
        engine.train_batch(batch=random_batch(8, seed=i))
    assert len(engine._metric_ring) == 3
    engine.configure_async_pipeline(enabled=False)  # flushes first
    assert engine._metric_ring == []
    engine.train_batch(batch=random_batch(8, seed=9))
    assert engine._metric_ring == []                # back to per-step path
    with pytest.raises(ValueError, match="sync_every"):
        engine.configure_async_pipeline(sync_every=0)


def test_async_disabled_on_host_offload_engines():
    engine = _engine(extra={
        **_async_cfg(8),
        "zero_optimization": {"offload_optimizer": {"device": "cpu"}}})
    assert not engine._async_enabled                # forced off at init
    loss = engine.train_batch(batch=random_batch(8, seed=0))
    assert np.isfinite(float(loss))
    assert engine._metric_ring == []
    with pytest.raises(ValueError, match="host-offload"):
        engine.configure_async_pipeline(enabled=True)


def test_config_validates_the_group():
    from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
    cfg = DeepSpeedTPUConfig({"async_pipeline": {"enabled": True}})
    assert (cfg.async_pipeline.sync_every, cfg.async_pipeline.prefetch,
            cfg.async_pipeline.prefetch_depth) == (8, False, 2)
    for bad, match in (({"sync_every": 0}, "sync_every"),
                       ({"prefetch_depth": 0}, "prefetch_depth")):
        with pytest.raises(ValueError, match=match):
            DeepSpeedTPUConfig({"async_pipeline": bad})
    with pytest.raises(NotImplementedError, match="not ported"):
        DeepSpeedTPUConfig({"wandb": {"enabled": True}})


# ---------------------------------------------------------------------------
# DispatchRing / StagedPrefetcher (tests/test_sched.py:54-127)
# ---------------------------------------------------------------------------
def test_dispatch_ring_cadence_and_drain():
    ring = DispatchRing(sync_every=3)
    assert ring.drain() is None                      # nothing pending
    assert not ring.push({"x": torch.tensor(0.0)})
    assert not ring.push({"x": torch.tensor(1.0)})
    assert ring.push({"x": torch.tensor(2.0)})       # cadence reached
    assert len(ring) == 3
    res = ring.drain(extra=torch.tensor(7.0))
    assert len(ring) == 0 and ring.transfers == 1
    assert [float(p["x"]) for p in res.payloads] == [0.0, 1.0, 2.0]
    assert float(res.extra) == 7.0
    assert not res.anchored and res.window_s == 0.0  # never armed


def test_dispatch_ring_anchor_window():
    ring = DispatchRing()
    ring.rearm_if_idle()                 # empty -> anchors
    assert ring.anchor is not None
    anchor = ring.anchor
    ring.push({"x": torch.tensor(0.0)})
    ring.rearm_if_idle()                 # pending -> must NOT re-anchor
    assert ring.anchor == anchor
    res = ring.drain()
    assert res.anchored and res.window_s >= 0.0
    assert ring.anchor == anchor
    ring.reset_anchor()
    ring.push({"x": torch.tensor(1.0)})
    assert not ring.drain().anchored


def test_dispatch_ring_store_take_requeue_overflow(monkeypatch):
    monkeypatch.setattr(DispatchRing, "CAPACITY", 4)
    ring = DispatchRing()
    assert ring.store([{"i": i} for i in range(3)]) == 0
    assert ring.store([{"i": i} for i in range(3, 6)]) == 2
    taken = ring.take()
    assert [e["i"] for e in taken] == [2, 3, 4, 5]
    assert ring.take() == []
    ring.store([{"i": 9}])
    ring.requeue(taken[:2])
    assert [e["i"] for e in ring.take()] == [2, 3, 9]
    ring.store([{"i": 0}])
    ring.requeue([{"i": i} for i in range(10, 14)])
    assert [e["i"] for e in ring.take()] == [10, 11, 12, 0]


def test_dispatch_ring_host_values_cost_no_transfer():
    """A payload of host values only (the port's step, lr and overflow)
    crosses nothing: the drain counts no transfer."""
    ring = DispatchRing()
    ring.push({"step": 1, "lr": 0.5})
    res = ring.drain(extra=2.0)
    assert res.payloads == [{"step": 1, "lr": 0.5}] and res.extra == 2.0
    assert ring.transfers == 0


class _FakeLoader:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def test_staged_prefetcher_identity_keyed():
    staged = StagedPrefetcher(depth=2)
    src_a, src_b = object(), object()
    a = staged.ensure(src_a, _FakeLoader)
    assert staged.ensure(src_a, _FakeLoader) is a    # stable identity
    assert staged.switches == 0
    b = staged.ensure(src_b, _FakeLoader)            # churn: close + rebuild
    assert b is not a and a.closed and not b.closed
    assert staged.switches == 1
    staged.close()
    assert b.closed and staged.loader is None
    staged.close()                                   # idempotent


# ---------------------------------------------------------------------------
# the loader (tests/test_engine.py:219)
# ---------------------------------------------------------------------------
def test_dataloader_drop_last():
    ds = random_dataset(10)
    keep = DeepSpeedTPUDataLoader(ds, batch_size=4, drop_last=False)
    batches = list(iter(keep))
    assert len(batches) == len(keep) == 3
    assert batches[-1]["x"].shape[0] == 2
    drop = DeepSpeedTPUDataLoader(ds, batch_size=4, drop_last=True)
    assert len(list(iter(drop))) == len(drop) == 2


@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True),
                                               (True, False)])
def test_dataloader_batches_match_jax(shuffle, drop_last):
    pytest.importorskip("flax")
    from deepspeed_tpu.models import simple as jsimple
    from deepspeed_tpu.runtime.dataloader import DeepSpeedTPUDataLoader as J
    ds, jds = random_dataset(11, seed=3), jsimple.random_dataset(11, seed=3)
    ours = DeepSpeedTPUDataLoader(ds, 4, shuffle=shuffle, seed=5,
                                  drop_last=drop_last)
    ref = J(jds, 4, shuffle=shuffle, seed=5, drop_last=drop_last)
    assert len(ours) == len(ref)
    for _ in range(2):                               # two epochs
        got, want = list(ours), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for k in ("x", "y"):
                np.testing.assert_array_equal(a[k], b[k])


def test_initialize_loader_feeds_train_batch():
    """``initialize(training_data=)``: the loader of global micro-batches
    (micro x dp rows); through ``RepeatingLoader`` and the prefetcher the
    steps are those of the stacked batches."""
    ds = random_dataset(32, seed=7)
    config = dict(CFG, gradient_accumulation_steps=2,
                  **_async_cfg(4, prefetch=True))
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=SimpleModel(hidden_dim=32, device="cpu", seed=1),
        config=config, device="cpu", training_data=ds)
    assert loader.batch_size == eng.micro_batch_size * eng.dp_world_size == 4
    assert len(loader) == 8
    it = RepeatingLoader(loader)
    losses = [eng.train_batch(data_iter=it) for _ in range(5)]
    eng.flush_metrics()
    ref = _engine(extra={"gradient_accumulation_steps": 2})
    micro = list(iter(DeepSpeedTPUDataLoader(ds, 4)))
    micro = micro + micro                            # the loader repeats
    ref_losses = []
    for s in range(5):
        batch = {k: np.stack([micro[2 * s][k], micro[2 * s + 1][k]])
                 for k in ("x", "y")}
        ref_losses.append(float(ref.train_batch(batch=batch)))
    assert [float(x) for x in losses] == ref_losses
    for a, b in zip(_params(eng), _params(ref)):
        assert torch.equal(a, b)
    assert eng._staged.loader is not None and eng.staged_waits == 0  # CPU


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_prefetch_matches_sync_on_card():
    """TINY_LLAMA's depth in bf16 on the card, at head_dim 64 (the flash
    kernels take 64 and 128): ``sync_every=4`` with prefetch (the copies
    on a side stream, the compute stream waiting on each batch's event)
    against the synchronous run, bit for bit, with ceil(5 / 4)
    transfers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")
    import dataclasses
    from deepspeed_tpu_torch.models import llama as tllama
    cfg = dataclasses.replace(tllama.TINY_LLAMA, hidden_size=256,
                              intermediate_size=512, dtype=torch.bfloat16,
                              attention_backend="flash")
    config = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "bf16": {"enabled": True}}
    batches = [tllama.random_tokens(2, 64, vocab_size=512, seed=i, gas=2)
               for i in range(5)]

    def run(extra):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(cfg, device="cuda", seed=0),
            config={**config, **extra})
        micro = iter([{k: v[i] for k, v in b.items()}
                      for b in batches for i in range(2)])
        losses = [eng.train_batch(data_iter=micro) for _ in range(5)]
        eng.flush_metrics()
        return eng, [float(x) for x in losses]

    sync, sync_losses = run({})
    pre, pre_losses = run(_async_cfg(4, prefetch=True))
    assert pre_losses == sync_losses
    assert pre._sched.transfers == 2 and pre.staged_waits == 5
    for a, b in zip(_params(sync), _params(pre)):
        assert torch.equal(a, b)
