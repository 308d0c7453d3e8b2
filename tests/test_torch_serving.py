"""Port parity: the serving layer (``deepspeed_tpu_torch/serving/``) over the
port's engine, against the JAX package.

- The drills of ``tests/test_serving.py``, each under its own name, against
  ``InferenceEngineV2(..., device="cpu")`` on TINY_LLAMA fp32 with the flax
  weights of the JAX tests (``llama_params_from_jax``): continuous batching
  with streaming and backpressure, queue-depth rejection, timeout and
  cancel, drain, an oversized request failing alone, the HTTP front door
  (``/generate`` sync and streamed, ``/metrics``, ``/healthz``, 400, 429,
  503), the CSV monitor export, and the sticky 503 after a fatal engine
  fault. Where the JAX drill holds the server against a solo run of its
  own engine, so does the port's.
- Cross-checks with the JAX package, inputs from a numpy seed: one seeded
  workload (prompts, ``ServingConfig``) through the JAX ``InferenceServer``
  and the port's gives identical greedy tokens and terminal states per
  request; their ``/metrics`` families and ``/healthz`` keys are the same;
  the engines' ``kv_ledger``/``sched_stats``/``prefix_stats`` keys are the
  same.
- The port's own contracts: the handoff methods raise "not ported" through
  the server and the front door; the serve loop runs with grad disabled
  whatever the caller's mode; every trace name the serving layer emits is
  registered in ``telemetry/names.py``; the CLI refuses a checkpoint and,
  with no card, a run that did not ask for the CPU.

Tolerance: tokens exact; times are not compared.
"""

import ast
import dataclasses
import http.client
import json
import pathlib
import pkgutil
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deepspeed_tpu.inference.v2 import engine_v2 as jengine  # noqa: E402
from deepspeed_tpu.inference.v2.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu import serving as jserving  # noqa: E402
from deepspeed_tpu.telemetry.tracer import get_tracer as jget_tracer  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,  # noqa: E402
                                                        V2EngineConfig)
from deepspeed_tpu_torch.inference.v2.scheduler import SchedulerConfig  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.models.convert import llama_params_from_jax  # noqa: E402
from deepspeed_tpu_torch.serving import (BackpressureError, InferenceServer,  # noqa: E402
                                         RequestState, ServerClosedError,
                                         ServingConfig, ServingFrontend)
from deepspeed_tpu_torch.telemetry.tracer import get_tracer  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
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


def _server(models, **kw):
    kw.setdefault("max_queue_depth", 32)
    return InferenceServer(_engine(models), ServingConfig(**kw))


def _prompts(rng, lengths, vocab):
    return [list(rng.integers(0, vocab, n)) for n in lengths]


def _http(method, host, port, path, body=None):
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# the drills of tests/test_serving.py
# ---------------------------------------------------------------------------
def test_concurrent_workload_interleaving_parity_backpressure(models):
    tcfg = models[2]
    rng = np.random.default_rng(0)
    # request 0 is long (prompt 48, 24 new); 1..7 are short and finish first
    lengths = [48, 8, 12, 16, 8, 20, 8, 12]
    max_new = [24, 4, 6, 4, 8, 4, 6, 4]
    prompts = _prompts(rng, lengths, tcfg.vocab_size)
    # worst-case blocks (16-token blocks): 15 of the 16 the 0.25 watermark
    # allows, so a burst of 1-block extras must start rejecting
    server = _server(models, kv_high_watermark=0.25).start()
    try:
        reqs = [server.submit(p, max_new_tokens=m)
                for p, m in zip(prompts, max_new)]
        streamed = []
        t = threading.Thread(
            target=lambda: streamed.extend(reqs[1].stream(timeout=120)))
        t.start()

        rejected, extras = 0, []
        for _ in range(15):
            try:
                extras.append(server.submit(
                    _prompts(rng, [8], tcfg.vocab_size)[0], max_new_tokens=4))
            except BackpressureError as e:
                rejected += 1
                assert e.retry_after_s > 0
        assert rejected > 0, "KV watermark never pushed back"

        for r in reqs + extras:
            r.result(timeout=300)
        t.join(timeout=10)
        assert not t.is_alive()
        assert all(r.state == RequestState.FINISHED for r in reqs + extras)
        assert all(r.finish_reason == "length" for r in reqs)
        assert any(r.finish_ts < reqs[0].finish_ts for r in reqs[1:]), \
            "no short request finished before the long one"

        assert streamed == reqs[1].tokens
        for p, m, r in zip(prompts, max_new, reqs):
            solo = _engine(models).generate(p, max_new_tokens=m)
            assert r.tokens == solo, f"uid {r.uid} diverged from solo run"

        assert all(r.queue_wait_s > 0 and r.ttft_s > 0 for r in reqs)
        snap = server.metrics.snapshot()
        assert snap["requests_completed"] == len(reqs) + len(extras)
        assert snap["requests_rejected"] == rejected
        assert snap["ttft_mean_s"] > 0 and snap["tpot_mean_s"] > 0
        assert snap["queue_wait_mean_s"] > 0
        assert snap["kv_occupancy_peak"] > 0
        assert snap["tokens_generated"] == sum(len(r.tokens)
                                               for r in reqs + extras)
    finally:
        server.stop(drain_timeout=5.0)


def test_queue_depth_backpressure(models):
    server = _server(models, max_queue_depth=3)
    for _ in range(3):
        server.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(BackpressureError) as ei:
        server.submit([1, 2, 3], max_new_tokens=2)
    assert ei.value.retry_after_s > 0
    assert server.metrics.snapshot()["requests_rejected"] == 1


def test_timeout_and_cancel(models):
    server = _server(models).start()
    try:
        timed = server.submit([3, 1, 4, 1, 5], max_new_tokens=500,
                              timeout_s=0.15)
        timed.wait(timeout=60)
        assert timed.state == RequestState.TIMED_OUT
        assert timed.finish_reason == "timeout"
        assert len(timed.tokens) < 500

        cancelled = server.submit([2, 7, 1, 8], max_new_tokens=500)
        it = cancelled.stream(timeout=60)
        first = next(it)
        cancelled.cancel()
        rest = list(it)
        cancelled.wait(timeout=60)
        assert cancelled.state == RequestState.CANCELLED
        assert cancelled.finish_reason == "cancelled"
        assert [first] + rest == cancelled.tokens

        deadline = time.monotonic() + 30
        while server.engine.kv_occupancy() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.engine.kv_occupancy() == 0.0
        snap = server.metrics.snapshot()
        assert snap["requests_timed_out"] == 1
        assert snap["requests_cancelled"] == 1
    finally:
        server.stop(drain_timeout=5.0)


def test_graceful_drain(models):
    server = _server(models).start()
    reqs = [server.submit([7, 7, 7, i + 1], max_new_tokens=6)
            for i in range(3)]
    assert server.drain(timeout=120), "drain timed out with work in flight"
    with pytest.raises(ServerClosedError):
        server.submit([1, 2, 3])
    for r in reqs:
        assert r.state == RequestState.FINISHED
        assert len(r.tokens) == 6
    server.stop(drain_timeout=5.0)
    assert not server.running


def test_oversized_request_fails_alone(models):
    server = _server(models).start()
    try:
        with pytest.raises(ValueError):
            server.submit(list(range(600)), max_new_tokens=4)
        ok = server.submit([5, 5, 5], max_new_tokens=3)
        assert ok.result(timeout=120) == ok.tokens and len(ok.tokens) == 3
    finally:
        server.stop(drain_timeout=5.0)


def test_frontend_generate_metrics_healthz(models):
    server = _server(models).start()
    fe = ServingFrontend(server, port=0).start()
    host, port = fe.host, fe.port
    try:
        status, _, body = _http("GET", host, port, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "serving"

        status, _, body = _http("POST", host, port, "/generate",
                                {"prompt_tokens": [9, 8, 7, 6],
                                 "max_new_tokens": 5})
        out = json.loads(body)
        assert status == 200 and len(out["tokens"]) == 5
        assert out["finish_reason"] == "length"
        solo = _engine(models).generate([9, 8, 7, 6], max_new_tokens=5)
        assert out["tokens"] == solo

        status, headers, body = _http("POST", host, port, "/generate",
                                      {"prompt_tokens": [9, 8, 7, 6],
                                       "max_new_tokens": 5, "stream": True})
        assert status == 200
        lines = [json.loads(ln) for ln in body.decode().splitlines() if ln]
        assert [ln["token"] for ln in lines[:-1]] == solo
        assert lines[-1]["done"] is True

        status, _, _ = _http("POST", host, port, "/generate", {"nope": 1})
        assert status == 400

        status, headers, body = _http("GET", host, port, "/metrics")
        assert status == 200
        metrics = {}
        for line in body.decode().splitlines():
            if line.startswith("#") or not line.strip():
                continue
            key, val = line.rsplit(" ", 1)
            metrics[key] = float(val)
        assert metrics["dstpu_serving_ttft_seconds_count"] > 0
        assert metrics["dstpu_serving_ttft_seconds_sum"] > 0
        assert metrics["dstpu_serving_tpot_seconds_sum"] > 0
        assert metrics["dstpu_serving_queue_wait_seconds_sum"] > 0
        assert metrics["dstpu_serving_kv_occupancy_peak"] > 0
        assert metrics["dstpu_serving_tokens_generated"] == 10
        assert metrics["dstpu_serving_requests_completed"] == 2

        tiny = InferenceServer(_engine(models), ServingConfig(max_queue_depth=0))
        fe2 = ServingFrontend(tiny, port=0).start()
        try:
            status, headers, _ = _http("POST", fe2.host, fe2.port,
                                       "/generate", {"prompt_tokens": [1, 2]})
            assert status == 429 and "Retry-After" in headers
        finally:
            fe2.stop()

        server.drain(timeout=60)
        status, _, body = _http("GET", host, port, "/healthz")
        assert status == 503 and json.loads(body)["status"] == "draining"
        status, _, _ = _http("POST", host, port, "/generate",
                             {"prompt_tokens": [1, 2, 3]})
        assert status == 503
    finally:
        fe.stop()
        server.stop(drain_timeout=5.0)


def test_monitor_export(models, tmp_path):
    from deepspeed_tpu_torch.config.config import CSVConfig
    from deepspeed_tpu_torch.monitor import CSVMonitor
    mon = CSVMonitor(CSVConfig(enabled=True, output_path=str(tmp_path),
                               job_name="serve"))
    server = _server(models).start()
    try:
        server.submit([4, 4, 4], max_new_tokens=3).result(timeout=120)
        server.metrics.export(mon, step=1)
    finally:
        server.stop(drain_timeout=5.0)
    names = {p.stem for p in (tmp_path / "serve").glob("*.csv")}
    assert "serving_tokens_generated" in names
    assert "serving_ttft_mean_s" in names


class _ExplodingEngine:
    """Minimal engine double whose step() always raises — the serve loop
    must fail the in-flight requests AND flip health to unhealthy."""

    def __init__(self):
        import types
        self.state = types.SimpleNamespace(max_context_length=512,
                                           get=lambda uid: None)
        self.kv = types.SimpleNamespace(blocks_needed=lambda total: 1)
        self._resident = set()

    def kv_usable_blocks(self):
        return 64

    def kv_occupancy(self):
        return 0.0

    def can_schedule(self, uids, needs):
        return True

    def admit(self, uid, tokens):
        self._resident.add(uid)

    def has_work(self):
        return bool(self._resident)

    def step(self):
        raise RuntimeError("kaboom: device went away")

    def finish(self, uid):
        self._resident.discard(uid)

    def reap_finished(self):
        return []


def test_health_degraded_after_engine_step_failure():
    server = InferenceServer(_ExplodingEngine(),
                             ServingConfig(idle_poll_s=0.001)).start()
    frontend = ServingFrontend(server).start()
    try:
        req = server.submit([1, 2, 3], max_new_tokens=4)
        assert req.wait(timeout=10.0)
        assert req.state == RequestState.FAILED
        h = server.health()
        assert h["status"] == "degraded"
        assert h["ok"] is False
        assert "engine step failed" in h["degraded_reason"]
        status, _, body = _http("GET", frontend.host, frontend.port,
                                "/healthz")
        assert status == 503
        assert json.loads(body)["status"] == "degraded"
        with pytest.raises(ServerClosedError):
            server.submit([1, 2, 3], max_new_tokens=4)
    finally:
        frontend.stop()
        server.stop(drain_timeout=2.0)


# ---------------------------------------------------------------------------
# cross-checks with the JAX package
# ---------------------------------------------------------------------------
_XCHECK_REQUESTS = 10


def _serve_seeded(server_cls, frontend_cls, engine, config):
    """Submit the seeded workload BEFORE the loop starts (so admission order
    and batching depend on nothing but the workload), serve it, then read
    ``/metrics`` and ``/healthz`` through the front door."""
    rng = np.random.default_rng(1234)
    lens = rng.integers(4, 41, _XCHECK_REQUESTS)
    max_new = rng.integers(2, 11, _XCHECK_REQUESTS)
    prompts = [rng.integers(1, 500, int(n)).tolist() for n in lens]
    server = server_cls(engine, config)
    reqs = [server.submit(p, max_new_tokens=int(m))
            for p, m in zip(prompts, max_new)]
    server.start()
    fe = frontend_cls(server, port=0).start()
    try:
        for r in reqs:
            assert r.wait(timeout=300)
        _, _, metrics = _http("GET", fe.host, fe.port, "/metrics")
        _, _, healthz = _http("GET", fe.host, fe.port, "/healthz")
    finally:
        fe.stop()
        server.stop(drain_timeout=30.0)
    return ([(r.state.value, r.finish_reason, list(r.tokens)) for r in reqs],
            metrics.decode(), json.loads(healthz))


@pytest.fixture(scope="module")
def served_pair(models):
    """The seeded workload through the JAX server and the port's, both
    tracers on (restored afterwards; neither ring is resized)."""
    kw = dict(max_queue_depth=32, kv_high_watermark=0.5, idle_poll_s=0.001)
    jtracer, ttracer = jget_tracer(), get_tracer()
    was = jtracer.enabled, ttracer.enabled
    jtracer.configure(enabled=True)
    ttracer.configure(enabled=True)
    try:
        ported = _serve_seeded(InferenceServer, ServingFrontend,
                               _engine(models), ServingConfig(**kw))
        reference = _serve_seeded(jserving.InferenceServer,
                                  jserving.ServingFrontend,
                                  _jax_engine(models),
                                  jserving.ServingConfig(**kw))
    finally:
        jtracer.configure(enabled=was[0])
        ttracer.configure(enabled=was[1])
    return ported, reference


def test_seeded_workload_tokens_and_states_match_jax_server(served_pair):
    (ported, _, _), (reference, _, _) = served_pair
    assert len(ported) == _XCHECK_REQUESTS
    assert all(state == "finished" for state, _, _ in reference)
    assert ported == reference


def _families(text):
    """Metric families (``# TYPE`` names) and sample names of a Prometheus
    text page."""
    typed, sampled = set(), set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
        elif line and not line.startswith("#"):
            sampled.add(line.split("{")[0].split(" ")[0])
    return typed, sampled


def test_metrics_families_and_healthz_keys_match_jax(served_pair):
    (_, tmetrics, thealth), (_, jmetrics, jhealth) = served_pair
    ttyped, tsampled = _families(tmetrics)
    jtyped, jsampled = _families(jmetrics)
    assert "dstpu_trace_span_seconds" in ttyped
    assert "dstpu_req_ttft_seconds" in ttyped
    assert ttyped == jtyped
    assert tsampled == jsampled
    assert set(thealth) == set(jhealth)
    assert thealth["status"] == jhealth["status"] == "serving"


def test_engine_stats_keys_match_jax(models):
    t, j = _engine(models), _jax_engine(models)
    for eng in (t, j):
        eng.enable_prefix_cache()
        eng.generate([3, 1, 4, 1, 5, 9, 2, 6], max_new_tokens=3, uid=1)
    assert set(t.kv_ledger()) == set(j.kv_ledger())
    assert set(t.sched_stats()) == set(j.sched_stats())
    assert set(t.prefix_stats()) == set(j.prefix_stats())
    assert t.kv_reserved_blocks() == j.kv_reserved_blocks()
    assert t.kv_held_blocks(1) == j.kv_held_blocks(1) == 0
    assert t.host_kv_bytes() == j.host_kv_bytes() == 0


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------
def test_handoff_methods_raise_not_ported_through_server_and_frontend(
        models, tmp_path):
    path = str(tmp_path / "handoff.npz")
    server = _server(models)
    with pytest.raises(NotImplementedError, match="not ported"):
        server.adopt_prefix_handoff(path)            # no loop: inline
    with pytest.raises(NotImplementedError, match="not ported"):
        server.export_prefix_handoff(path)           # stopped server
    server.start()
    fe = ServingFrontend(server, port=0).start()
    try:
        with pytest.raises(NotImplementedError, match="not ported"):
            server.adopt_prefix_handoff(path)        # through the loop
        status, _, body = _http("POST", fe.host, fe.port, "/admin/adopt",
                                {"handoff_path": path})
        assert status == 501 and "not ported" in json.loads(body)["error"]
        # the loop keeps serving after the refused adoption
        ok = server.submit([5, 6, 7], max_new_tokens=2)
        assert len(ok.result(timeout=120)) == 2
        assert server.health()["status"] == "serving"
    finally:
        fe.stop()
        server.stop(drain_timeout=5.0)


def test_adoption_queued_at_stop_fails_instead_of_hanging(models):
    """An adoption queued while the loop is mid-tick, with the server then
    stopped before the next tick, is settled by stop(): its caller gets
    ``ServerClosedError`` at once, and a later adoption is refused."""
    server = _server(models).start()
    armed, entered, release = (threading.Event() for _ in range(3))
    expire = server._expire_and_cancel

    def held_tick():
        if armed.is_set():
            armed.clear()
            entered.set()
            release.wait(timeout=60)
        expire()
    server._expire_and_cancel = held_tick
    armed.set()
    assert entered.wait(timeout=30)           # the loop is inside a tick
    errors = []

    def adopt():
        try:
            server.adopt_prefix_handoff("never-imported.npz")
        except Exception as e:
            errors.append(e)
    caller = threading.Thread(target=adopt)
    caller.start()
    while not server._handoff_paths:
        time.sleep(0.01)
    stopper = threading.Thread(target=server.stop, kwargs={
        "drain_timeout": 5.0})
    stopper.start()
    while not server._stopped:
        time.sleep(0.01)
    release.set()                             # the tick ends, the loop exits
    stopper.join(timeout=30)
    caller.join(timeout=30)
    assert not stopper.is_alive() and not caller.is_alive()
    assert len(errors) == 1 and isinstance(errors[0], ServerClosedError)
    assert server._handoff_paths == []
    with pytest.raises(NotImplementedError, match="not ported"):
        server.adopt_prefix_handoff("inline.npz")   # stopped: runs inline


def test_admin_adopt_answers_500_when_the_import_fails(models):
    server = _server(models).start()
    fe = ServingFrontend(server, port=0).start()

    def broken_import(path):
        raise OSError(f"cannot read {path}")
    server.engine.import_prefix_handoff = broken_import
    try:
        status, _, body = _http("POST", fe.host, fe.port, "/admin/adopt",
                                {"handoff_path": "missing.npz"})
        assert status == 500 and "cannot read" in json.loads(body)["error"]
        assert server.health()["status"] == "serving"
    finally:
        fe.stop()
        server.stop(drain_timeout=5.0)


def test_serve_loop_runs_without_grad(models):
    """Grad mode is per thread: the serve loop disables it for the engine
    whatever the caller's mode, so no tensor made on the serve path
    requires grad even with weights that do."""
    _, _, tcfg, tparams = models

    def trainable(node):
        if isinstance(node, dict):
            return {k: trainable(v) for k, v in node.items()}
        return node.detach().clone().requires_grad_(True)
    params = trainable(tparams)
    eng = InferenceEngineV2(params, tcfg, V2EngineConfig(
        kv_block_size=16, kv_num_blocks=KV_BLOCKS,
        scheduler=SchedulerConfig(max_tokens_per_step=64,
                                  prefill_buckets=(16, 32, 64))),
        device="cpu")
    seen = []
    sample = eng._sample_batch

    def recording_sample(logits):
        seen.append((torch.is_grad_enabled(), logits.requires_grad))
        return sample(logits)
    eng._sample_batch = recording_sample
    assert torch.is_grad_enabled()
    server = InferenceServer(eng, ServingConfig(idle_poll_s=0.001)).start()
    try:
        assert len(server.submit([1, 2, 3, 4], max_new_tokens=4)
                   .result(timeout=120)) == 4
    finally:
        server.stop(drain_timeout=5.0)
    assert seen and all(v == (False, False) for v in seen), seen
    assert not eng.kv.data.requires_grad


def _emitted_trace_names(path):
    """(name or f-string head, kind) of every tracer emission in a file."""
    kinds = {"span", "instant", "counter", "complete"}
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in kinds and node.args):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append((arg.value, node.func.attr, False))
        elif isinstance(arg, ast.JoinedStr):
            head = arg.values[0]
            out.append((head.value if isinstance(head, ast.Constant) else "",
                        node.func.attr, True))
    return out


def test_serving_trace_names_are_registered():
    from deepspeed_tpu_torch.telemetry.names import (DYNAMIC_PREFIXES,
                                                     TRACE_NAMES)
    files = sorted((REPO / "deepspeed_tpu_torch" / "serving").glob("*.py"))
    files += [REPO / "deepspeed_tpu_torch" / "resilience" / "chaos.py",
              REPO / "deepspeed_tpu_torch" / "inference" / "v2" / "engine_v2.py"]
    seen = 0
    for path in files:
        for name, kind, dynamic in _emitted_trace_names(path):
            seen += 1
            if dynamic:
                assert name.startswith(DYNAMIC_PREFIXES), (path, name)
            else:
                assert kind in TRACE_NAMES.get(name, ()), (path, name, kind)
    assert seen > 30


def test_port_scan_covers_the_serving_package():
    """``test_torch_engine.py::test_port_never_imports_jax_or_the_jax_package``
    walks every module of the package: the serving layer is among them."""
    mods = {m.name for m in pkgutil.walk_packages(
        deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")}
    for name in ("serving", "serving.server", "serving.frontend",
                 "serving.bench_serve", "serving.cli", "comm.guard",
                 "resilience.chaos", "monitor.monitor", "telemetry.hist",
                 "telemetry.names"):
        assert f"deepspeed_tpu_torch.{name}" in mods


def test_cli_refuses_checkpoint_and_an_unasked_cpu():
    from deepspeed_tpu_torch.serving import cli
    with pytest.raises(NotImplementedError, match="checkpoint and resilience"):
        cli.main(["--checkpoint", "params.npz", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["--preset", "NO_SUCH_MODEL", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--port", "0"])
