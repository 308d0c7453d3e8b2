"""Port parity: serving under siege — the host KV offload tier, the
degradation ladder, request-level fault isolation (poison quarantine), the
serve chaos knobs and the ``bench_serve`` harness of
``deepspeed_tpu_torch/serving/`` over the port's engine, against the JAX
package.

- The drills of ``tests/test_serve_siege.py``, each under its own name,
  against ``InferenceEngineV2(..., device="cpu")`` on TINY_LLAMA fp32 with
  the flax weights of the JAX tests. Unit pieces (planners, ladder, chaos
  parsing) run without an engine; fault-isolation and drift tests drive
  ``_serve_once`` on fake engines for exact tick control; the acceptance
  drills run the real serve loop.
- Cross-checks with the JAX package, inputs from a numpy seed: the
  ``DegradationLadder`` takes identical transitions on one pressure
  sequence; the ``kv_tier`` planners give equal outputs on equal inputs;
  ``classify_exception`` agrees on a list of exceptions; one seeded
  workload under the offload tier (pages demoted and promoted at full
  width) through the JAX server and the port's gives identical tokens,
  terminal states and tier counters.
- The CUDA mapping: ``torch.OutOfMemoryError`` from an engine step is
  TRANSIENT (a suspect is evicted and retried, no sticky 503), a sticky
  CUDA error ("an illegal memory access") is FATAL (the 503 latches).

Tolerance: tokens and counters exact; times are not compared. Tests that
read spans turn the port's tracer on and clear it; none resizes its ring.
"""

import dataclasses
import json
import time
import types

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deepspeed_tpu import serving as jserving  # noqa: E402
from deepspeed_tpu.comm import guard as jguard  # noqa: E402
from deepspeed_tpu.inference.v2 import engine_v2 as jengine  # noqa: E402
from deepspeed_tpu.inference.v2.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.serving import kv_tier as jkv_tier  # noqa: E402
from deepspeed_tpu_torch.comm.guard import (CommOutcome,  # noqa: E402
                                            classify_exception)
from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,  # noqa: E402
                                                        V2EngineConfig)
from deepspeed_tpu_torch.inference.v2.scheduler import SchedulerConfig  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.models.convert import llama_params_from_jax  # noqa: E402
from deepspeed_tpu_torch.resilience.chaos import (ChaosConfig,  # noqa: E402
                                                  ChaosInjectedPoisonError,
                                                  ChaosMonkey)
from deepspeed_tpu_torch.serving import (BackpressureError,  # noqa: E402
                                         DegradationLadder, InferenceServer,
                                         LadderConfig, RequestState,
                                         ServeLevel, ServingConfig)
from deepspeed_tpu_torch.serving import kv_tier  # noqa: E402
from deepspeed_tpu_torch.serving.kv_tier import (effective_usable_blocks,  # noqa: E402
                                                 plan_demotions,
                                                 plan_promotions,
                                                 tier_pressure)
from deepspeed_tpu_torch.serving.server import _EngineStepError  # noqa: E402
from deepspeed_tpu_torch.telemetry.tracer import get_tracer  # noqa: E402

pytestmark = pytest.mark.serve_load

KV_BLOCKS = 64  # the JAX serving tests' pool


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               max_seq_len=512)
    params = jllama.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)}
    )["params"]
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=torch.float32)
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return jcfg, params, tcfg, tparams


def _engine(models, kv_blocks=KV_BLOCKS):
    _, _, tcfg, tparams = models
    return InferenceEngineV2(tparams, tcfg, V2EngineConfig(
        kv_block_size=16, kv_num_blocks=kv_blocks,
        scheduler=SchedulerConfig(max_tokens_per_step=64,
                                  prefill_buckets=(16, 32, 64))),
        device="cpu")


def _jax_engine(models, kv_blocks=KV_BLOCKS):
    jcfg, params, _, _ = models
    return jengine.InferenceEngineV2(params, jcfg, jengine.V2EngineConfig(
        kv_block_size=16, kv_num_blocks=kv_blocks,
        scheduler=JSchedulerConfig(max_tokens_per_step=64,
                                   prefill_buckets=(16, 32, 64))))


def _tick(server):
    """One manual serve tick with the loop's fault-handling semantics."""
    try:
        return server._serve_once()
    except _EngineStepError as e:
        server._on_step_fault(e)
        return False


@pytest.fixture
def tracer():
    """The port's process tracer, on and empty (never resized)."""
    t = get_tracer()
    was = t.enabled
    t.configure(enabled=True)
    t.clear()
    yield t
    t.configure(enabled=was)


# ---------------------------------------------------------------------------
# tier planners (pure arithmetic)
# ---------------------------------------------------------------------------
def test_tier_planners():
    assert effective_usable_blocks(63, 0.0) == 63
    assert effective_usable_blocks(63, 0.85) == 9
    assert effective_usable_blocks(63, 0.999) == 1

    assert plan_demotions([2, 2, 2, 2], [2, 2, 2, 2], reserved_blocks=8,
                          capacity_blocks=100, demote_line_blocks=3,
                          min_active=1) == [3, 2, 1]
    assert plan_demotions([2, 2, 2, 2], [2, 2, 2, 2], reserved_blocks=8,
                          capacity_blocks=100, demote_line_blocks=3,
                          min_active=3) == [3]
    assert plan_demotions([4, 4], [1, 1], reserved_blocks=2,
                          capacity_blocks=5, demote_line_blocks=100,
                          min_active=1) == [1]
    assert plan_demotions([2, 2], [2, 2], reserved_blocks=4,
                          capacity_blocks=100, demote_line_blocks=10,
                          min_active=1) == []
    assert plan_demotions([2, 2, 2], [2, 0, 2], reserved_blocks=6,
                          capacity_blocks=100, demote_line_blocks=3,
                          min_active=1) == [2, 0]

    assert plan_promotions([2, 2], [2, 2], active_worst_sum=2,
                           capacity_blocks=10, free_blocks=10,
                           reserved_blocks=2, demote_line_blocks=8) == 2
    assert plan_promotions([2, 2], [2, 2], active_worst_sum=2,
                           capacity_blocks=10, free_blocks=10,
                           reserved_blocks=2, demote_line_blocks=3) == 0
    assert plan_promotions([2], [8], active_worst_sum=2,
                           capacity_blocks=10, free_blocks=4,
                           reserved_blocks=2, demote_line_blocks=100) == 0
    assert plan_promotions([20], [4], active_worst_sum=0,
                           capacity_blocks=10, free_blocks=4,
                           reserved_blocks=0, demote_line_blocks=1) == 1

    p, reason = tier_pressure(9, 10, 0, 8, 0, 0)
    assert p == pytest.approx(0.9) and reason == "device_kv"
    p, reason = tier_pressure(1, 10, 8, 8, 0, 0)
    assert p == pytest.approx(1.0) and reason == "queue"
    p, reason = tier_pressure(0, 10, 0, 8, 900, 1000)
    assert p == pytest.approx(0.9) and reason == "host_kv"


# ---------------------------------------------------------------------------
# degradation ladder (hysteresis, edges, sticky degraded)
# ---------------------------------------------------------------------------
def test_ladder_transitions_hysteresis_and_sticky():
    ladder = DegradationLadder(LadderConfig(
        brownout_pressure=0.5, shed_pressure=0.9, hysteresis=0.1,
        cooldown_ticks=3))
    assert ladder.level is ServeLevel.HEALTHY
    assert ladder.observe(0.4) is None
    assert ladder.observe(0.6) == (ServeLevel.HEALTHY, ServeLevel.BROWNOUT)
    assert ladder.observe(0.95) == (ServeLevel.BROWNOUT, ServeLevel.SHED)
    assert ladder.observe(0.85) is None
    assert ladder.observe(0.7) is None
    assert ladder.observe(0.85) is None
    assert ladder.observe(0.7) is None
    assert ladder.observe(0.7) is None
    assert ladder.observe(0.7) == (ServeLevel.SHED, ServeLevel.BROWNOUT)
    assert ladder.level is ServeLevel.BROWNOUT
    for _ in range(2):
        assert ladder.observe(0.1) is None
    assert ladder.observe(0.1) == (ServeLevel.BROWNOUT, ServeLevel.HEALTHY)
    assert ladder.entries["brownout"] == 2 and ladder.entries["shed"] == 1

    assert ladder.latch_degraded("engine fault") == (
        ServeLevel.HEALTHY, ServeLevel.DEGRADED)
    assert ladder.observe(0.0) is None
    assert ladder.level is ServeLevel.DEGRADED
    assert ladder.latch_degraded("again") is None

    with pytest.raises(ValueError):
        LadderConfig(brownout_pressure=0.9, shed_pressure=0.5).validate()


# ---------------------------------------------------------------------------
# chaos knobs: parsing + determinism contract
# ---------------------------------------------------------------------------
def test_chaos_serve_knobs():
    env = {"DSTPU_CHAOS_SERVE_SLOW_TICK": "4:0.01",
           "DSTPU_CHAOS_SERVE_KV_PRESSURE": "0.8:5:9",
           "DSTPU_CHAOS_SERVE_POISON_UID": "3"}
    cfg = ChaosConfig.from_env(env)
    assert cfg.active
    assert cfg.serve_slow_tick_every == 4 and cfg.serve_slow_tick_s == 0.01
    assert cfg.serve_kv_pressure_frac == 0.8
    assert (cfg.serve_kv_pressure_from, cfg.serve_kv_pressure_until) == (5, 9)
    assert cfg.serve_poison_uid == 3
    pcfg = ChaosConfig.from_env({"DSTPU_CHAOS_SERVE_SLOW_TICK": "p0.25:0.5"})
    assert pcfg.serve_slow_tick_prob == 0.25 and pcfg.serve_slow_tick_every == 0

    monkey = ChaosMonkey(cfg)
    assert monkey.serve_kv_pressure(4) == 0.0
    assert monkey.serve_kv_pressure(5) == 0.8
    assert monkey.serve_kv_pressure(8) == 0.8
    assert monkey.serve_kv_pressure(9) == 0.0
    assert monkey.injected["serve_kv_pressure"] == 1

    stalled = [monkey.serve_slow_tick(t) for t in range(1, 9)]
    assert [s > 0 for s in stalled] == [False, False, False, True,
                                        False, False, False, True]
    assert monkey.injected["serve_slow_tick"] == 2

    monkey.maybe_poison_serve([1, 2])
    with pytest.raises(ChaosInjectedPoisonError) as ei:
        monkey.maybe_poison_serve([2, 3])
    assert classify_exception(ei.value) is CommOutcome.TRANSIENT

    m1 = ChaosMonkey(ChaosConfig(seed=7, serve_slow_tick_prob=0.5,
                                 serve_slow_tick_s=0.0))
    m2 = ChaosMonkey(ChaosConfig(seed=7, serve_slow_tick_prob=0.5,
                                 serve_slow_tick_s=0.0))
    rolls1 = [m1._roll("serve_slow", t) for t in range(20)]
    rolls2 = [m2._roll("serve_slow", t) for t in range(20)]
    assert rolls1 == rolls2
    # the NaN-batch injection waits for the micro-step protocol
    with pytest.raises(NotImplementedError, match="micro-step protocol"):
        monkey.corrupt_batch({"input_ids": np.zeros((1, 4))}, step=0)


# ---------------------------------------------------------------------------
# serving config group
# ---------------------------------------------------------------------------
def test_serving_config_from_ds_config():
    cfg = ServingConfig.from_ds_config({
        "train_batch_size": 8,
        "serving": {"max_queue_depth": 4, "kv_offload_enabled": True,
                    "brownout_pressure": 0.5}})
    assert cfg.max_queue_depth == 4
    assert cfg.kv_offload_enabled and cfg.brownout_pressure == 0.5
    assert ServingConfig.from_ds_config({}).max_queue_depth == 64
    with pytest.raises(ValueError, match="unknown 'serving' config keys"):
        ServingConfig.from_ds_config({"serving": {"max_que_depth": 4}})


# ---------------------------------------------------------------------------
# engine-level KV offload: demote/promote round-trip is bit-identical
# ---------------------------------------------------------------------------
def test_kv_offload_demote_promote_parity(models):
    prompts = [list(range(1, 20)), list(range(3, 15))]
    ref = _engine(models)
    ref.put([1, 2], prompts)
    for _ in range(9):
        ref.step()
    ref_gen = {u: list(ref.state.get(u).generated) for u in (1, 2)}

    e = _engine(models)
    e.put([1, 2], prompts)
    for _ in range(3):
        e.step()
    free_before = e.kv.free_blocks
    nbytes = e.demote_kv(1)
    assert nbytes > 0 and e.kv.free_blocks > free_before
    assert e.state.get(1).paused and e.state.get(1).blocks == []
    assert e.demoted_uids() == [1] and e.host_kv_bytes() == nbytes
    assert e.demote_kv(1) == 0
    for _ in range(3):
        e.step()
    assert e.promote_kv(1) == nbytes
    assert not e.state.get(1).paused and e.host_kv_bytes() == 0
    while any(len(e.state.get(u).generated) < len(ref_gen[u])
              for u in (1, 2)):
        e.step()
    for u in (1, 2):
        assert e.state.get(u).generated[:len(ref_gen[u])] == ref_gen[u], \
            f"uid {u} diverged after demote/promote round-trip"
    e.demote_kv(2)
    e.flush(1), e.flush(2)
    ledger = e.kv_ledger()
    assert ledger["device_blocks_reserved"] == 0
    assert ledger["host_entries"] == 0 and ledger["host_bytes"] == 0
    assert ledger["demotions"] == 2 and ledger["promotions"] == 1


# ---------------------------------------------------------------------------
# fake engines for exact-tick fault isolation / drift tests
# ---------------------------------------------------------------------------
class _FakeSeq:
    def __init__(self):
        self.done = False


class _FakeEngine:
    """Functional minimal engine: one token per resident sequence per
    step; scriptable step failures by 1-based step-call index."""

    def __init__(self, fail_calls=(), fail_exc=None):
        self._seqs = {}
        self.step_calls = 0
        self.fail_calls = set(fail_calls)
        self.fail_exc = fail_exc or RuntimeError("connection reset by peer")
        self.state = types.SimpleNamespace(
            max_context_length=512,
            get=lambda uid: self._seqs.get(uid))
        self.kv = types.SimpleNamespace(
            blocks_needed=lambda total: (total + 15) // 16, free_blocks=63)

    def kv_usable_blocks(self):
        return 64

    def kv_occupancy(self):
        return len(self._seqs) / 64.0

    def can_schedule(self, uids, needs):
        return True

    def admit(self, uid, tokens):
        self._seqs[uid] = _FakeSeq()

    def has_work(self):
        return any(not s.done for s in self._seqs.values())

    def step(self):
        self.step_calls += 1
        if self.step_calls in self.fail_calls:
            raise self.fail_exc
        return {uid: 7 for uid, s in self._seqs.items() if not s.done}

    def finish(self, uid):
        if uid in self._seqs:
            self._seqs[uid].done = True

    def reap_finished(self):
        done = [u for u, s in self._seqs.items() if s.done]
        for u in done:
            self._seqs.pop(u)
        return {u: [] for u in done}


def _transient_fault_recovers(fail_exc):
    engine = _FakeEngine(fail_calls={1}, fail_exc=fail_exc)
    server = InferenceServer(engine, ServingConfig(
        recover_clean_steps=3, poison_retry_budget=1, idle_poll_s=0.001))
    req = server.submit([1, 2, 3], max_new_tokens=4)
    for _ in range(20):
        _tick(server)
        if req.state.terminal:
            break
    assert req.state == RequestState.FINISHED
    assert req.fault_count == 1
    assert server._degraded is None
    assert server.ladder.level is not ServeLevel.DEGRADED
    snap = server.metrics.snapshot()
    assert snap["engine_step_faults"] == 1
    assert snap["degraded_latches"] == 0
    assert snap["recomputed_tokens"] >= 3
    req2 = server.submit([4, 5], max_new_tokens=2)
    for _ in range(20):
        _tick(server)
        if req2.state.terminal:
            break
    assert req2.state == RequestState.FINISHED
    assert server.health()["fault_episode"] is False
    assert server.metrics.snapshot()["fault_recoveries"] == 1


def test_transient_step_fault_recovers_without_restart():
    _transient_fault_recovers(RuntimeError("connection reset by peer"))


def _fatal_fault_latches(fail_exc):
    engine = _FakeEngine(fail_calls={1, 2, 3, 4}, fail_exc=fail_exc)
    server = InferenceServer(engine, ServingConfig(idle_poll_s=0.001))
    req = server.submit([1, 2, 3], max_new_tokens=4)
    for _ in range(5):
        _tick(server)
        if req.state.terminal:
            break
    assert req.state == RequestState.FAILED
    assert server._degraded is not None
    assert server.ladder.level is ServeLevel.DEGRADED
    assert server.metrics.snapshot()["degraded_latches"] == 1


def test_fatal_step_fault_still_latches_degraded():
    _fatal_fault_latches(RuntimeError("kaboom: device went away"))


def test_cuda_oom_step_fault_evicts_without_latching():
    """The counterpart of the TPU's RESOURCE_EXHAUSTED: an allocation that
    failed leaves the context sound, so the suspect is evicted, retried and
    finishes, and the replica keeps serving (no sticky 503)."""
    _transient_fault_recovers(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.06 GiB is free."))


def test_sticky_cuda_error_latches_degraded():
    """A sticky CUDA error poisons the context: the 503 latches."""
    _fatal_fault_latches(RuntimeError(
        "CUDA error: an illegal memory access was encountered\nCUDA kernel "
        "errors might be asynchronously reported at some other API call"))


def test_repeated_unattributed_faults_latch_degraded():
    engine = _FakeEngine(fail_calls=set(range(1, 100)))
    server = InferenceServer(engine, ServingConfig(
        poison_retry_budget=0, max_consecutive_step_faults=1,
        idle_poll_s=0.001))
    reqs = [server.submit([i + 1], max_new_tokens=2) for i in range(6)]
    for _ in range(30):
        _tick(server)
        if server._degraded is not None:
            break
    assert server._degraded is not None
    assert server.ladder.level is ServeLevel.DEGRADED
    assert all(r.state == RequestState.FAILED for r in reqs)
    assert server.metrics.snapshot()["requests_quarantined"] >= 3


class _DriftEngine(_FakeEngine):
    """Fake engine whose observed KV reservation is test-controlled."""

    def __init__(self):
        super().__init__()
        self.reserved = 0

    def kv_block_bytes(self):
        return 1024

    def kv_reserved_blocks(self):
        return self.reserved


def test_kv_drift_recalibrates_projected_watermark(tracer):
    engine = _DriftEngine()
    server = InferenceServer(engine, ServingConfig(idle_poll_s=0.001))
    engine.reserved = 10
    _tick(server)
    assert server._kv_watermark_scale == 0.5
    snap = server.metrics.snapshot()
    assert snap["kv_drift_events"] == 1
    assert snap["kv_recalibrations"] == 1
    _tick(server)
    assert server.metrics.snapshot()["kv_drift_events"] == 1
    engine.reserved = 0
    _tick(server)
    assert server._kv_watermark_scale == 1.0
    snap = server.metrics.snapshot()
    assert snap["kv_recalibrations"] == 2
    counts = tracer.instant_counts(prefix="serve/kv_recalibrate")
    assert counts.get("serve/kv_recalibrate", 0) == 2


# ---------------------------------------------------------------------------
# brownout semantics: low-priority admits pause, budgets cap
# ---------------------------------------------------------------------------
def test_brownout_pauses_low_priority_and_caps_budget():
    engine = _FakeEngine()
    server = InferenceServer(engine, ServingConfig(
        brownout_max_new_tokens=3, idle_poll_s=0.001))
    low = server.submit([1, 2], max_new_tokens=5, priority=-1)
    server.ladder.observe(0.9)
    assert server.ladder.level is ServeLevel.BROWNOUT
    capped = server.submit([3, 4], max_new_tokens=50)
    assert capped.max_new_tokens == 3
    server._admit_from_queue()
    assert low.state == RequestState.QUEUED
    assert capped.state == RequestState.PREFILL
    for _ in range(100):
        if server.ladder.observe(0.0) is not None:
            break
    assert server.ladder.level is ServeLevel.HEALTHY
    server._admit_from_queue()
    assert low.state == RequestState.PREFILL
    with pytest.raises(ValueError, match="priority"):
        server.submit([1], max_new_tokens=2, priority="high")


# ---------------------------------------------------------------------------
# ACCEPTANCE: chaos KV-pressure drill
# ---------------------------------------------------------------------------
def test_chaos_kv_pressure_ladder_drill(models, monkeypatch, tracer):
    monkeypatch.setenv("DSTPU_CHAOS_SERVE_KV_PRESSURE", "0.85:0:1200")
    server = InferenceServer(_engine(models), ServingConfig(
        max_queue_depth=32, kv_offload_enabled=True,
        host_kv_budget_bytes=20 * 16384,
        brownout_pressure=0.5, shed_pressure=0.9, ladder_hysteresis=0.1,
        ladder_cooldown_ticks=6, kv_demote_watermark=0.8,
        kv_demote_watermark_brownout=0.4, idle_poll_s=0.001,
        retry_after_s=0.05)).start()
    try:
        warm = [server.submit(list(np.random.default_rng(100 + i)
                                   .integers(1, 99, 16)),
                              max_new_tokens=8) for i in range(4)]
        for w in warm:
            w.result(timeout=300)
        accepted, rejections = [], 0
        first_reject_eid = None
        for i in range(60):
            try:
                accepted.append(server.submit(
                    list(np.random.default_rng(i).integers(1, 99, 16)),
                    max_new_tokens=8))
            except BackpressureError as e:
                rejections += 1
                assert e.retry_after_s > 0
                if first_reject_eid is None:
                    evs = [ev for ev in tracer.events_snapshot()
                           if ev[1] == "serve/backpressure"]
                    first_reject_eid = evs[0][0] if evs else None
            time.sleep(0.005)
        assert rejections > 0, "pressure never pushed back"
        for r in accepted:
            r.result(timeout=300)
        assert all(r.state == RequestState.FINISHED for r in accepted)
        snap = server.metrics.snapshot()
        assert snap["brownout_entries"] >= 1
        assert snap["shed_entries"] >= 1, snap
        assert snap["kv_demotions"] > 0
        assert snap["degraded_latches"] == 0
        brownout_evs = [ev for ev in tracer.events_snapshot()
                        if ev[1] == "serve/ladder"
                        and ev[7] and ev[7].get("to") == "brownout"]
        assert brownout_evs, "no brownout edge on the trace"
        assert first_reject_eid is not None
        assert brownout_evs[0][0] < first_reject_eid, \
            "server rejected before visiting brownout"
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if server.ladder.level is ServeLevel.HEALTHY:
                break
            time.sleep(0.05)
        assert server.ladder.level is ServeLevel.HEALTHY
        assert server.health()["status"] == "serving"
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if tracer.instant_counts().get("chaos/serve_kv_pressure",
                                           0) >= 2:
                break
            time.sleep(0.1)
        counts = tracer.instant_counts()
        assert counts.get("chaos/serve_kv_pressure", 0) >= 2
        assert counts.get("serve/kv_demote", 0) == snap["kv_demotions"]
        assert counts.get("serve/ladder", 0) == snap["ladder_transitions"]
        ledger = server.engine.kv_ledger()
        assert ledger["device_blocks_reserved"] == 0
        assert ledger["host_entries"] == 0 and ledger["host_bytes"] == 0
    finally:
        server.stop(drain_timeout=30.0)


# ---------------------------------------------------------------------------
# ACCEPTANCE: poison-request drill
# ---------------------------------------------------------------------------
def test_poison_request_quarantine_drill(models, tracer):
    chaos = ChaosMonkey(ChaosConfig(serve_poison_uid=2))
    server = InferenceServer(_engine(models), ServingConfig(
        poison_retry_budget=1, recover_clean_steps=3,
        max_consecutive_step_faults=8, idle_poll_s=0.001),
        chaos=chaos).start()
    try:
        good_a = server.submit([5, 5, 5, 5], max_new_tokens=6)
        poison = server.submit([6, 6, 6, 6], max_new_tokens=6)   # uid 2
        good_b = server.submit([7, 7, 7, 7], max_new_tokens=6)
        assert poison.uid == 2
        for r in (good_a, poison, good_b):
            r.wait(timeout=300)
        assert poison.state == RequestState.FAILED
        assert poison.finish_reason == "quarantined"
        assert poison.fault_count == 2
        assert good_a.state == RequestState.FINISHED
        assert good_b.state == RequestState.FINISHED
        assert len(good_a.tokens) == 6 and len(good_b.tokens) == 6
        snap = server.metrics.snapshot()
        assert snap["requests_quarantined"] == 1
        assert snap["degraded_latches"] == 0
        assert snap["engine_step_faults"] >= 2
        assert chaos.injected["serve_poison"] >= 2
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            h = server.health()
            if h["ok"] and not h["fault_episode"]:
                break
            server.submit([8, 8], max_new_tokens=2).wait(timeout=60)
        h = server.health()
        assert h["ok"] and h["fault_episode"] is False
        assert server.metrics.snapshot()["fault_recoveries"] >= 1
        assert tracer.instant_counts().get("serve/quarantine", 0) >= 1
    finally:
        server.stop(drain_timeout=30.0)


# ---------------------------------------------------------------------------
# graceful drain under load
# ---------------------------------------------------------------------------
def test_graceful_drain_under_load_ledger_zero(models):
    server = InferenceServer(_engine(models, kv_blocks=16), ServingConfig(
        kv_offload_enabled=True, kv_demote_watermark=0.35,
        kv_demote_watermark_brownout=0.25, idle_poll_s=0.001)).start()
    try:
        rng = np.random.default_rng(3)
        reqs = [server.submit(list(rng.integers(1, 99, 16)),
                              max_new_tokens=6) for _ in range(8)]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if any(r.tokens for r in reqs):
                break
            time.sleep(0.005)
        assert server.drain(timeout=300), "drain timed out under load"
        assert all(r.state == RequestState.FINISHED for r in reqs)
        assert all(len(r.tokens) == 6 for r in reqs)
        for r in reqs:
            assert list(r.stream(timeout=1.0)) == r.tokens
        assert server.metrics.snapshot()["kv_demotions"] > 0
        ledger = server.engine.kv_ledger()
        assert ledger["device_blocks_reserved"] == 0
        assert ledger["host_entries"] == 0 and ledger["host_bytes"] == 0
        assert server.engine.kv_occupancy() == 0.0
    finally:
        server.stop(drain_timeout=10.0)


# ---------------------------------------------------------------------------
# bench_serve micro scenario: deterministic counter invariants
# ---------------------------------------------------------------------------
def test_bench_serve_micro_counter_invariants(models, tracer):
    from deepspeed_tpu_torch.serving.bench_serve import SCENARIOS, run_scenario

    scenario = dataclasses.replace(SCENARIOS["micro"], num_requests=100,
                                   prompt_len=(8, 24), max_new_tokens=(2, 5))
    server = InferenceServer(_engine(models, kv_blocks=16), ServingConfig(
        max_queue_depth=32, kv_offload_enabled=True,
        kv_demote_watermark=0.35, kv_demote_watermark_brownout=0.25,
        brownout_pressure=0.6, shed_pressure=0.95,
        ladder_cooldown_ticks=5, idle_poll_s=0.001,
        retry_after_s=0.01)).start()
    try:
        report = run_scenario(server, scenario)
    finally:
        server.stop(drain_timeout=30.0)
    m = report["metrics"]
    c = report["counters"]
    assert m["requests_submitted"] == 100
    assert (m["requests_completed"] + m["requests_failed"]
            + m["requests_cancelled"] + m["requests_timed_out"]) == 100
    assert m["requests_failed"] == 0
    assert report["requests"]["states"] == {"finished": 100}
    assert m["tokens_generated"] == report["requests"]["client_tokens"]
    assert m["tokens_generated"] >= 2 * 100
    assert c["demotions"] > 0
    assert c["demotions"] == c["promotions"]
    assert c["demoted_bytes"] == c["promoted_bytes"]
    assert report["kv_ledger"]["device_blocks_reserved"] == 0
    assert report["kv_ledger"]["host_entries"] == 0
    assert report["kv_ledger"]["host_bytes"] == 0
    assert c["sticky_503"] == 0
    assert c["quarantined"] == 0 and c["step_faults"] == 0
    assert report["drained"] is True
    assert report["ladder"]["level"] == "healthy"
    ttft = report["latency_from_trace"]["ttft_s"]
    assert ttft["count"] == 100 and ttft["p50_s"] > 0
    tpot = report["latency_from_trace"]["tpot_s"]
    assert tpot["count"] > 0 and tpot["p50_s"] > 0
    assert "compiles_during_measurement" not in c
    json.dumps(report, default=str)


# ---------------------------------------------------------------------------
# cross-checks with the JAX package
# ---------------------------------------------------------------------------
def test_ladder_transitions_match_jax():
    rng = np.random.default_rng(7)
    # a load that climbs, oscillates around both thresholds and lifts
    pressure = np.clip(np.concatenate([
        np.linspace(0.0, 1.0, 40), 0.85 + 0.15 * rng.standard_normal(200),
        np.linspace(1.0, 0.0, 60), 0.05 * rng.random(60)]), 0.0, 1.2)
    cfg = dict(brownout_pressure=0.6, shed_pressure=0.9, hysteresis=0.1,
               cooldown_ticks=4)
    t = DegradationLadder(LadderConfig(**cfg))
    j = jserving.DegradationLadder(jserving.LadderConfig(**cfg))
    edges = 0
    for i, p in enumerate(pressure.tolist()):
        te, je = t.observe(p, "device_kv"), j.observe(p, "device_kv")
        assert (te is None) == (je is None), i
        if te is not None:
            edges += 1
            assert [lv.name for lv in te] == [lv.name for lv in je], i
    assert edges >= 4
    assert t.transitions == j.transitions
    assert t.entries == j.entries
    assert t.level.name == j.level.name


def test_kv_tier_planners_match_jax():
    rng = np.random.default_rng(11)
    for _ in range(300):
        n = int(rng.integers(0, 9))
        worst = rng.integers(0, 12, n).tolist()
        held = [int(rng.integers(0, w + 1)) for w in worst]
        reserved = int(rng.integers(0, 60))
        cap = float(rng.integers(1, 80))
        line = float(rng.integers(0, 60))
        min_active = int(rng.integers(0, 4))
        assert plan_demotions(worst, held, reserved, cap, line, min_active) \
            == jkv_tier.plan_demotions(worst, held, reserved, cap, line,
                                       min_active)
        active_sum, free = int(rng.integers(0, 40)), int(rng.integers(0, 30))
        assert plan_promotions(worst, held, active_sum, cap, free, reserved,
                               line) == jkv_tier.plan_promotions(
            worst, held, active_sum, cap, free, reserved, line)
        ev, over = int(rng.integers(0, 20)), int(rng.integers(0, 10))
        assert kv_tier.plan_prefix_evictions(ev, over, reserved, line) \
            == jkv_tier.plan_prefix_evictions(ev, over, reserved, line)
        usable, frac = int(rng.integers(0, 200)), float(rng.random())
        assert effective_usable_blocks(usable, frac) \
            == jkv_tier.effective_usable_blocks(usable, frac)
        args = (reserved, int(rng.integers(0, 60)), int(rng.integers(0, 40)),
                int(rng.integers(0, 40)), int(rng.integers(0, 5000)),
                int(rng.integers(0, 5000)))
        assert tier_pressure(*args) == jkv_tier.tier_pressure(*args)


_EXCEPTIONS = [
    ConnectionRefusedError("connection refused"),
    TimeoutError("op timed out"),
    RuntimeError("UNAVAILABLE: socket closed"),
    RuntimeError("DEADLINE_EXCEEDED while waiting"),
    RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating 16.00G"),
    RuntimeError("connection reset by peer"),
    ChaosInjectedPoisonError("chaos: poisoned request 3 aborted the step"),
    RuntimeError("PERMISSION_DENIED: bad credential"),
    PermissionError("permission denied"),
    RuntimeError("kaboom: device went away"),
    ValueError("shape mismatch"),
    KeyError("uid"),
    OSError("temporarily unavailable, try again"),
]


def test_classify_exception_matches_jax():
    for exc in _EXCEPTIONS:
        assert classify_exception(exc).value == \
            jguard.classify_exception(exc).value, exc
    assert classify_exception(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 MiB")) \
        is CommOutcome.TRANSIENT
    for text in ("CUDA error: an illegal memory access was encountered",
                 "CUDA error: device-side assert triggered",
                 "CUDA error: unspecified launch failure",
                 "CUDA error: the launch timed out and was terminated"):
        assert classify_exception(RuntimeError(text)) is CommOutcome.FATAL


def _serve_tiered(server_cls, config, engine):
    """A seeded workload submitted before the loop starts (batching and
    demotion order depend on nothing but the workload), on a pool small
    enough that the offload tier moves pages."""
    rng = np.random.default_rng(99)
    lens = rng.integers(12, 40, 12)
    max_new = rng.integers(4, 12, 12)
    server = server_cls(engine, config)
    reqs = [server.submit(rng.integers(1, 500, int(n)).tolist(),
                          max_new_tokens=int(m))
            for n, m in zip(lens, max_new)]
    server.start()
    try:
        for r in reqs:
            assert r.wait(timeout=300)
    finally:
        server.stop(drain_timeout=30.0)
    snap = server.metrics.snapshot()
    counters = {k: snap[k] for k in ("kv_demotions", "kv_promotions",
                                     "kv_demoted_bytes", "kv_promoted_bytes",
                                     "requests_completed", "tokens_generated",
                                     "engine_steps", "ladder_transitions")}
    return ([(r.state.value, r.finish_reason, list(r.tokens)) for r in reqs],
            counters, engine.kv_ledger())


def test_tiered_workload_matches_jax_server(models):
    kw = dict(max_queue_depth=32, kv_offload_enabled=True,
              kv_demote_watermark=0.35, kv_demote_watermark_brownout=0.25,
              host_kv_quantize="none", idle_poll_s=0.001)
    ported = _serve_tiered(InferenceServer, ServingConfig(**kw),
                           _engine(models, kv_blocks=16))
    reference = _serve_tiered(jserving.InferenceServer,
                              jserving.ServingConfig(**kw),
                              _jax_engine(models, kv_blocks=16))
    assert ported[1]["kv_demotions"] > 0
    assert all(state == "finished" for state, _, _ in ported[0])
    assert ported[0] == reference[0]
    assert ported[1] == reference[1]
    assert ported[2] == reference[2]


def test_bench_serve_cli_on_cpu(capsys):
    from deepspeed_tpu_torch.serving import bench_serve
    assert bench_serve.main(["--device", "cpu", "--requests", "12",
                             "--concurrency", "4"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["requests"]["states"] == {"finished": 12}
    assert report["slo"]["conservation"]["ok"] is True
    assert report["provenance"]["builder"]["device"] == "cpu"
    with pytest.raises(NotImplementedError, match="serving-layer slice"):
        bench_serve.main(["--device", "cpu", "--replicas", "2"])
    with pytest.raises(NotImplementedError, match="serving-layer slice"):
        bench_serve.main(["--verify-plan", "plan.json"])
