"""Port parity: the fleet router (``serving/fleet.py``), its worker process
(``serving/fleet_worker.py``), the shared HTTP client, the replica-kill
chaos knob, ``bench_serve``'s fleet lane and the request-trace stitcher
(``telemetry/reqtrace.py``) against the JAX package.

- The 19 cases of ``tests/test_fleet.py``, each under its own name, on the
  port: the pure routing helpers (``affinity_key``, ``pick_replica``,
  ``plan_scale``), each also held against the JAX helper on the same
  tables; ``http_util``'s backoff (equal to the JAX client's) and retry
  discipline; the replica-kill knob; the front door's slow-client guards;
  the router over scripted fake replicas (exact failover ledger, budget
  exhaustion, the spill counterfactual, ``/healthz`` and ``/metrics``, a
  dead replica marked lost); the status artifact, which the JAX package's
  ``env_report.fleet_report`` reads; ``FleetConfig.from_ds_config`` (the
  same fields as JAX's); then over real replicas (``build_tiny_server``,
  ``device="cpu"``): the prefix-handoff round trip, the fleet hit ratio and
  report gates, retirement shipping the handoff to the survivor, and the
  subprocess chaos drill with ``--device cpu`` workers (zero requests lost,
  the victim's flight dump stitched by the port's ``reqtrace`` and by the
  JAX package's to the same report).
- Wire compatibility: the port's router over a JAX replica and a port
  replica with the same weights returns the same greedy tokens from each.

Tolerance: counters, tokens and routing verdicts exact; times are not
compared.
"""

import dataclasses
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deepspeed_tpu import serving as jserving  # noqa: E402
from deepspeed_tpu.inference.v2 import engine_v2 as jengine  # noqa: E402
from deepspeed_tpu.inference.v2.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.serving import fleet as jfleet  # noqa: E402
from deepspeed_tpu.serving import http_util as jhttp_util  # noqa: E402
from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,  # noqa: E402
                                                        V2EngineConfig)
from deepspeed_tpu_torch.inference.v2.scheduler import SchedulerConfig  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.models.convert import llama_params_from_jax  # noqa: E402
from deepspeed_tpu_torch.resilience.chaos import (REPLICA_ID_ENV,  # noqa: E402
                                                  ChaosConfig, ChaosMonkey)
from deepspeed_tpu_torch.serving import bench_serve, http_util  # noqa: E402
from deepspeed_tpu_torch.serving import (InferenceServer, ServingConfig,  # noqa: E402
                                         ServingFrontend)
from deepspeed_tpu_torch.serving.fleet import (FleetConfig, FleetRouter,  # noqa: E402
                                               ReplicaHandle, affinity_key,
                                               pick_replica, plan_scale,
                                               subprocess_launcher)
from deepspeed_tpu_torch.telemetry.tracer import get_tracer  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clear_tracer_after_module():
    """Routers and in-process replicas emit fleet/serve instants into the
    port's global tracer ring; leave it as clean as we found it."""
    yield
    get_tracer().clear()


# ---------------------------------------------------------------------------
# pure routing decisions
# ---------------------------------------------------------------------------
def test_affinity_key_full_blocks_only():
    # same cap as PrefixCache.lookup: (len-1)//block full blocks — the
    # last prompt token is always computed, never part of a cached block
    assert affinity_key([1] * 16, 16) is None          # (16-1)//16 == 0
    assert affinity_key([1] * 17, 16) is not None      # one full block
    assert affinity_key([], 16) is None
    assert affinity_key([1, 2, 3], 0) is None
    # keyed by the HEAD block only: shared-system-prompt requests that
    # diverge after the head still land on the same replica
    a = affinity_key(list(range(40)), 16)
    b = affinity_key(list(range(16)) + [99] * 24, 16)
    assert a == b
    assert affinity_key(list(range(1, 41)), 16) != a
    assert affinity_key(tuple(range(40)), 16) == a
    # the JAX helper on a seeded table: the same keys
    rng = np.random.default_rng(0)
    for n, block in zip(rng.integers(0, 80, 64), rng.integers(0, 33, 64)):
        prompt = [int(t) for t in rng.integers(0, 512, int(n))]
        assert affinity_key(prompt, int(block)) == \
            jfleet.affinity_key(prompt, int(block))


def _snap(rid, level="healthy", queued=0, inflight=0, draining=False,
          in_rotation=True, **kw):
    return dict({"id": rid, "level": level, "queued": queued,
                 "inflight": inflight, "draining": draining,
                 "in_rotation": in_rotation}, **kw)


def test_pick_replica_matrix():
    healthy = [_snap(0), _snap(1, queued=2)]
    table = [
        ((healthy, None, True, frozenset()), (0, "least_loaded")),
        (([_snap(0, pending=1), _snap(1)], None, True, frozenset()),
         (1, "least_loaded")),
        ((healthy, 1, True, frozenset()), (1, "affinity")),
        ((healthy, 1, True, frozenset({1})), (0, "least_loaded")),
        (([_snap(0, level="shed"), _snap(1, queued=5)], None, True,
          frozenset()), (1, "spill")),
        (([_snap(0, level="shed"), _snap(1, queued=5)], None, False,
          frozenset()), (0, "pinned_shedding")),
        (([_snap(0, level="shed"), _snap(1, draining=True)], None, True,
          frozenset()), (None, "shed_all")),
        ((healthy, None, True, frozenset({0, 1})), (None, "no_replicas")),
        (([], None, True, frozenset()), (None, "no_replicas")),
        (([_snap(0, in_rotation=False), _snap(1)], 0, True, frozenset()),
         (1, "least_loaded")),
    ]
    for args, want in table:
        assert pick_replica(*args) == want
        assert jfleet.pick_replica(*args) == want
    # seeded random snapshots: the JAX helper's verdict every time
    rng = np.random.default_rng(1)
    levels = ("healthy", "brownout", "shed")
    for _ in range(200):
        snaps = [_snap(i, level=levels[int(rng.integers(3))],
                       queued=int(rng.integers(4)),
                       inflight=int(rng.integers(3)),
                       draining=bool(rng.random() < 0.2),
                       in_rotation=bool(rng.random() < 0.8),
                       pending=int(rng.integers(2)))
                 for i in range(int(rng.integers(0, 5)))]
        arid = int(rng.integers(-1, 5))
        args = (snaps, None if arid < 0 else arid, bool(rng.random() < 0.7),
                frozenset(int(x) for x in rng.integers(0, 5, 2)
                          if rng.random() < 0.3))
        assert pick_replica(*args) == jfleet.pick_replica(*args)


def test_plan_scale_streaks():
    kw = dict(scale_out_enabled=True, scale_out_pressure_polls=2,
              scale_out_queue_depth=4, retire_idle_polls=3,
              min_replicas=1, max_replicas=3)
    cfg, jcfg = FleetConfig(**kw), jfleet.FleetConfig(**kw)
    pressured = [_snap(0, queued=5), _snap(1, level="shed")]
    idle = [_snap(0), _snap(1)]
    busy = [_snap(0, inflight=1), _snap(1)]
    assert plan_scale(pressured, cfg, 0, 0) == (None, 1, 0)
    action, p, i = plan_scale(pressured, cfg, 1, 0)
    assert (action, p) == ("out", 0)
    action, p, i = plan_scale(idle, cfg, 0, 1)
    assert (action, i) == (None, 2)
    action, p, i = plan_scale(busy, cfg, 0, 2)
    assert (action, i) == (None, 0)
    action, p, i = plan_scale(idle, cfg, 0, 2)
    assert (action, i) == ("retire", 0)
    assert plan_scale([_snap(0)], cfg, 0, 99)[0] is None
    three = [_snap(0, queued=9), _snap(1, queued=9), _snap(2, queued=9)]
    assert plan_scale(three, cfg, 99, 0)[0] is None
    assert plan_scale(idle, FleetConfig(scale_out_enabled=False), 0,
                      999)[0] is None
    # the JAX helper over the same poll sequence: the same decisions
    rng = np.random.default_rng(2)
    p = i = jp = ji = 0
    for _ in range(300):
        snaps = [_snap(r, level=("healthy", "shed")[int(rng.random() < 0.2)],
                       queued=int(rng.integers(0, 6)) * int(rng.random() < .5),
                       inflight=int(rng.random() < 0.3),
                       retired=bool(rng.random() < 0.1))
                 for r in range(int(rng.integers(1, 4)))]
        a, p, i = plan_scale(snaps, cfg, p, i)
        ja, jp, ji = jfleet.plan_scale(snaps, jcfg, jp, ji)
        assert (a, p, i) == (ja, jp, ji)


# ---------------------------------------------------------------------------
# http_util: backoff + retry discipline
# ---------------------------------------------------------------------------
def test_backoff_delay_deterministic_and_floored():
    pol = http_util.RetryPolicy(backoff_s=0.05, backoff_max_s=0.4,
                                jitter_frac=0.25, seed=3)
    assert http_util.backoff_delay(pol, 2, salt=7) == \
        http_util.backoff_delay(pol, 2, salt=7)
    assert http_util.backoff_delay(pol, 2, salt=7) != \
        http_util.backoff_delay(pol, 2, salt=8)
    for attempt, base in ((1, 0.05), (2, 0.10), (3, 0.20), (4, 0.40),
                          (9, 0.40)):
        d = http_util.backoff_delay(pol, attempt)
        assert base <= d <= base * 1.25
    assert http_util.backoff_delay(pol, 1, retry_after_s=5.0) == 5.0
    assert http_util.backoff_delay(pol, 9, retry_after_s=0.001) >= 0.4
    # the same schedule as the JAX client's, draw for draw
    jpol = jhttp_util.RetryPolicy(backoff_s=0.05, backoff_max_s=0.4,
                                  jitter_frac=0.25, seed=3)
    for attempt in range(1, 8):
        for salt in range(5):
            assert http_util.backoff_delay(pol, attempt, salt=salt) == \
                jhttp_util.backoff_delay(jpol, attempt, salt=salt)


class _CountingHandler(BaseHTTPRequestHandler):
    """Scripted status sequence; counts hits per (method, path)."""

    def log_message(self, *a):
        pass

    def _serve(self):
        srv = self.server
        srv.hits.append((self.command, self.path))
        statuses = srv.script
        status = statuses[min(len(srv.hits) - 1, len(statuses) - 1)]
        body = json.dumps({"n": len(srv.hits)}).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if status == 429:
            self.send_header("Retry-After", "0")
        self.end_headers()
        self.wfile.write(body)

    do_GET = _serve
    do_POST = _serve


def _counting_server(script):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _CountingHandler)
    srv.daemon_threads = True
    srv.script = list(script)
    srv.hits = []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_request_json_retry_and_idempotency_clamp():
    pol = http_util.RetryPolicy(max_attempts=3, backoff_s=0.001,
                                backoff_max_s=0.002)
    srv, url = _counting_server([429, 429, 200])
    try:
        r = http_util.request_json("GET", url + "/healthz", retry=pol,
                                   retry_status=(429,))
        assert r.status == 200 and r.attempts == 3
        # a non-GET without an idempotency key: one attempt, whatever the
        # policy — a retried submit could double-admit
        srv.hits.clear()
        r = http_util.request_json("POST", url + "/generate", payload={},
                                   retry=pol, retry_status=(429,))
        assert r.status == 429 and len(srv.hits) == 1
        srv.hits.clear()
        r = http_util.request_json("POST", url + "/generate", payload={},
                                   retry=pol, retry_status=(429,),
                                   idempotency_key=17)
        assert r.status == 200 and len(srv.hits) == 3
    finally:
        srv.shutdown()
        srv.server_close()


def test_request_json_transport_classification(monkeypatch):
    pol = http_util.RetryPolicy(max_attempts=3, backoff_s=0.001)
    calls = {"n": 0}

    def fatal(*a, **k):
        calls["n"] += 1
        raise PermissionError("UNAUTHENTICATED: bad credentials")

    monkeypatch.setattr(http_util, "_one_request", fatal)
    with pytest.raises(PermissionError):
        http_util.request_json("GET", "http://127.0.0.1:1/x", retry=pol)
    assert calls["n"] == 1

    calls["n"] = 0

    def transient(*a, **k):
        calls["n"] += 1
        raise ConnectionRefusedError("connection refused")

    monkeypatch.setattr(http_util, "_one_request", transient)
    with pytest.raises(ConnectionRefusedError):
        http_util.request_json("GET", "http://127.0.0.1:1/x", retry=pol)
    assert calls["n"] == 3


# ---------------------------------------------------------------------------
# chaos: the replica-kill knob
# ---------------------------------------------------------------------------
def test_chaos_replica_kill_parsing_and_gating(monkeypatch):
    monkeypatch.setenv("DSTPU_CHAOS_REPLICA_KILL", "2:5")
    cfg = ChaosConfig.from_env()
    assert (cfg.replica_kill_id, cfg.replica_kill_tick) == (2, 5)
    assert cfg.replica_kill_once and cfg.active

    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append((pid,
                                                                   sig)))
    monkey = ChaosMonkey(cfg)
    monkeypatch.delenv("DSTPU_RESUME", raising=False)
    monkeypatch.setenv(REPLICA_ID_ENV, "0")
    monkey.maybe_kill_replica(99, mid_decode=True)
    monkeypatch.setenv(REPLICA_ID_ENV, "2")
    monkey.maybe_kill_replica(4, mid_decode=True)
    monkey.maybe_kill_replica(5, mid_decode=False)
    assert kills == [] and monkey.injected["replica_kill"] == 0
    monkeypatch.setenv("DSTPU_RESUME", "relaunch")
    monkey.maybe_kill_replica(5, mid_decode=True)
    assert kills == []
    monkeypatch.delenv("DSTPU_RESUME")
    monkey.maybe_kill_replica(5, mid_decode=True)
    assert kills == [(os.getpid(), __import__("signal").SIGKILL)]
    assert monkey.injected["replica_kill"] == 1
    monkeypatch.delenv("DSTPU_CHAOS_REPLICA_KILL")
    assert ChaosConfig.from_env().replica_kill_id == -1


# ---------------------------------------------------------------------------
# frontend hardening (no engine needed: the guards fire before submit)
# ---------------------------------------------------------------------------
def test_frontend_slow_and_oversized_clients():
    class _Stub:     # only the attributes the touched routes use
        def health(self):
            return {"ok": True, "status": "serving"}

    fe = ServingFrontend(_Stub(), max_body_bytes=128,
                         read_timeout_s=0.3).start()
    try:
        r = http_util.request_json(
            "POST", fe.url + "/generate",
            payload={"prompt_tokens": [1] * 4096})
        assert r.status == 413
        conn = socket.create_connection(("127.0.0.1", fe.port), timeout=5)
        try:
            conn.sendall(b"POST /generate HTTP/1.1\r\n"
                         b"Host: x\r\nContent-Length: 50\r\n\r\nshort")
            data = conn.recv(4096)
            assert b"408" in data.split(b"\r\n", 1)[0]
        finally:
            conn.close()
        conn = socket.create_connection(("127.0.0.1", fe.port), timeout=5)
        try:
            conn.sendall(b"POST /generate HTTP/1.1\r\n"
                         b"Host: x\r\nContent-Length: nope\r\n\r\n")
            data = conn.recv(4096)
            assert b"400" in data.split(b"\r\n", 1)[0]
        finally:
            conn.close()
    finally:
        fe.stop()


# ---------------------------------------------------------------------------
# fake replicas: scripted doors for exact router arithmetic
# ---------------------------------------------------------------------------
class _FakeReplica:
    """A stdlib HTTP server impersonating one serving replica: healthz
    reports a scripted ladder level; /generate streams ``max_new`` tokens
    — or 429s (shed door), or dies abruptly after ``die_after`` tokens
    (no final record: the router must treat it as a death)."""

    def __init__(self, rid, level="healthy", die_after=None):
        self.rid = rid
        self.level = level
        self.die_after = die_after
        self.generate_hits = 0
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code, payload, headers=()):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._json(200, {"status": "serving", "ok": True,
                                 "level": fake.level, "queued": 0,
                                 "inflight": 0, "draining": False,
                                 "replica_id": fake.rid,
                                 "prefix_cache_blocks": 0})

            def do_POST(self):
                raw = self.rfile.read(
                    int(self.headers.get("Content-Length", 0) or 0))
                fake.generate_hits += 1
                if fake.level == "shed":
                    self._json(429, {"error": "shedding",
                                     "retry_after_s": 0.01},
                               headers=[("Retry-After", "0")])
                    return
                body = json.loads(raw)
                max_new = int(body["max_new_tokens"])
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonlines")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode()
                                     + data + b"\r\n")
                    self.wfile.flush()

                for i in range(max_new):
                    if fake.die_after is not None and i == fake.die_after:
                        self.connection.close()
                        self.close_connection = True
                        return
                    chunk({"token": fake.rid * 1000 + i})
                chunk({"done": True, "state": "finished",
                       "finish_reason": "length", "uid": 7})
                self.wfile.write(b"0\r\n\r\n")
                self.close_connection = True

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _router_over(fakes, **cfg_kw):
    cfg = FleetConfig(replicas=len(fakes), poll_interval_s=0.05,
                      poll_timeout_s=2.0, retry_backoff_s=0.001,
                      retry_backoff_max_s=0.005, **cfg_kw)
    handles = [ReplicaHandle(f.rid, f.url) for f in fakes]
    return FleetRouter(cfg, handles=handles).start()


def test_failover_ledger_exact_arithmetic():
    dying = _FakeReplica(0, die_after=3)
    healthy = _FakeReplica(1)
    router = _router_over([dying, healthy], affinity_enabled=False)
    try:
        prompt = list(range(10))
        reply = http_util.request_json(
            "POST", router.url + "/generate",
            payload={"prompt_tokens": prompt, "max_new_tokens": 8},
            timeout_s=30.0)
        assert reply.status == 200
        out = reply.json()
        assert len(out["tokens"]) == 8
        assert out["tokens"][:3] == [0, 1, 2]
        assert out["tokens"][3:] == [1000, 1001, 1002, 1003, 1004]
        assert out["rerouted"] == 1
        assert out["recomputed_tokens"] == len(prompt) + 3
        assert out["replicas"] == [0, 1]
        assert out["state"] == "finished"
        c = router.counters_snapshot()
        assert c["submitted"] == c["completed"] == 1
        assert c["reroutes"] == 1 and c["requests_lost"] == 0
        assert c["recomputed_tokens"] == len(prompt) + 3
        ledger = router.ledger_snapshot()
        assert len(ledger) == 1
        entry = next(iter(ledger.values()))
        assert entry["rerouted"] == 1 and entry["tokens"] == 8
        assert entry["state"] == "finished"
    finally:
        router.stop(terminate_replicas=False)
        dying.close()
        healthy.close()


def test_failover_budget_exhaustion_is_counted_lost():
    a = _FakeReplica(0, die_after=1)
    b = _FakeReplica(1, die_after=1)
    router = _router_over([a, b], affinity_enabled=False, retry_budget=2,
                          request_timeout_s=10.0)
    try:
        reply = http_util.request_json(
            "POST", router.url + "/generate",
            payload={"prompt_tokens": [1, 2, 3], "max_new_tokens": 6},
            timeout_s=30.0)
        assert reply.status == 503
        c = router.counters_snapshot()
        assert c["requests_lost"] == 1 and c["completed"] == 0
        assert c["reroutes"] == 2
        entry = next(iter(router.ledger_snapshot().values()))
        assert entry["state"] == "lost"
    finally:
        router.stop(terminate_replicas=False)
        a.close()
        b.close()


def test_spill_counterfactual_counters():
    shedding = _FakeReplica(0, level="shed")
    healthy = _FakeReplica(1)
    K = 6

    def drive(router):
        for i in range(K):
            yield http_util.request_json(
                "POST", router.url + "/generate",
                payload={"prompt_tokens": [i, i + 1, i + 2],
                         "max_new_tokens": 2},
                timeout_s=30.0)

    with_spill = _router_over([shedding, healthy], spill_enabled=True,
                              affinity_enabled=False)
    try:
        assert all(r.status == 200 for r in drive(with_spill))
        c = with_spill.counters_snapshot()
        assert c["first_choice_sheds"] == K
        assert c["client_sheds"] == 0
        assert c["spills"] == K
        assert c["completed"] == K
    finally:
        with_spill.stop(terminate_replicas=False)

    no_spill = _router_over([shedding, healthy], spill_enabled=False,
                            affinity_enabled=False)
    try:
        replies = list(drive(no_spill))
        assert all(r.status == 429 for r in replies)
        assert all(r.retry_after_s() is not None for r in replies)
        c = no_spill.counters_snapshot()
        assert c["client_sheds"] == c["first_choice_sheds"] == K
        assert c["spills"] == 0 and c["completed"] == 0
    finally:
        no_spill.stop(terminate_replicas=False)
        shedding.close()
        healthy.close()


def test_router_health_and_metrics_endpoints():
    fake = _FakeReplica(0)
    router = _router_over([fake])
    try:
        h = http_util.request_json("GET", router.url + "/healthz").json()
        assert h["ok"] is True
        assert [s["id"] for s in h["replicas"]] == [0]
        assert h["replicas"][0]["in_rotation"] is True
        assert set(h["counters"]) == set(jfleet.COUNTER_KEYS)
        m = http_util.request_json("GET", router.url + "/metrics")
        text = m.body.decode()
        assert "# TYPE dstpu_fleet_submitted counter" in text
        assert "dstpu_fleet_replicas_in_rotation 1" in text
        families = {ln.split()[2] for ln in text.splitlines()
                    if ln.startswith("# TYPE dstpu_fleet_")}
        assert families == {f"dstpu_fleet_{k}" for k in jfleet.COUNTER_KEYS} \
            | {"dstpu_fleet_replicas_in_rotation",
               "dstpu_fleet_healthz_staleness"}
    finally:
        router.stop(terminate_replicas=False)
        fake.close()


def test_router_marks_dead_replica_lost_and_drops_affinity():
    fake0 = _FakeReplica(0)
    fake1 = _FakeReplica(1)
    router = _router_over([fake0, fake1], lost_after_s=0.15)
    try:
        with router._lock:
            router._affinity[1234] = 0
        fake0.close()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if router.counters_snapshot()["replicas_lost"] == 1:
                break
            time.sleep(0.05)
        c = router.counters_snapshot()
        assert c["replicas_lost"] == 1
        h = router.health()
        assert h["ok"] is True
        snap = {s["id"]: s for s in h["replicas"]}
        assert snap[0]["lost"] and not snap[0]["in_rotation"]
        assert snap[1]["in_rotation"]
        with router._lock:
            assert 1234 not in router._affinity
    finally:
        router.stop(terminate_replicas=False)
        fake1.close()


def test_fleet_status_artifact_and_env_report(tmp_path, monkeypatch):
    """The port's status artifact is the reference's: the JAX package's
    ``env_report.fleet_report`` renders it."""
    from deepspeed_tpu.env_report import fleet_report
    path = str(tmp_path / "fleet_status.json")
    fake = _FakeReplica(0)
    router = _router_over([fake], status_path=path)
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not os.path.exists(path):
            time.sleep(0.05)
        with open(path) as f:
            doc = json.load(f)
        assert doc["replicas"][0]["in_rotation"] is True
        assert set(doc["counters"]) == set(jfleet.COUNTER_KEYS)
    finally:
        router.stop(terminate_replicas=False)
        fake.close()
    monkeypatch.setenv("DSTPU_FLEET_STATUS", path)
    rows = dict(fleet_report())
    assert "1 in rotation" in rows["fleet replicas"]
    assert "fleet failover" in rows
    monkeypatch.delenv("DSTPU_FLEET_STATUS")
    rows = fleet_report()
    assert rows and rows[0][0] == "fleet"


def test_fleet_config_from_ds_config():
    cfg = FleetConfig.from_ds_config(
        {"fleet": {"replicas": 3, "spill_enabled": False,
                   "affinity_block_tokens": 16}})
    assert (cfg.replicas, cfg.spill_enabled,
            cfg.affinity_block_tokens) == (3, False, 16)
    with pytest.raises(ValueError, match="unknown 'fleet' config keys"):
        FleetConfig.from_ds_config({"fleet": {"replica_count": 3}})
    assert FleetConfig.from_ds_config({}).replicas == 2
    # the reference's fields and defaults, one for one
    assert dataclasses.asdict(FleetConfig()) == \
        dataclasses.asdict(jfleet.FleetConfig())


# ---------------------------------------------------------------------------
# real engines: prefix handoff + fleet hit ratio + retire lifecycle
# ---------------------------------------------------------------------------
def _tiny_server(**kw):
    return bench_serve.build_tiny_server(device="cpu", **kw)


def test_prefix_handoff_roundtrip(tmp_path):
    sc = dataclasses.replace(bench_serve.SCENARIOS["micro"],
                             num_requests=6, concurrency=2,
                             prompt_len=(34, 40), max_new_tokens=(2, 3),
                             shared_prefix_frac=0.5)
    donor = _tiny_server().start()
    path = str(tmp_path / "handoff.npz")
    try:
        bench_serve.run_scenario(donor, sc)
        donor.stop(drain_timeout=30.0)
        got = donor.export_prefix_handoff(path, quantize="int8")
        assert got["chains"] > 0 and got["blocks"] > 0
        assert os.path.exists(path)
        assert got["stored_bytes"] < got["raw_bytes"]
    finally:
        if donor.running:
            donor.stop(drain_timeout=5.0)

    heir = _tiny_server().start()
    fe = ServingFrontend(heir).start()
    try:
        r = http_util.request_json("POST", fe.url + "/admin/adopt",
                                   payload={"handoff_path": path},
                                   timeout_s=30.0)
        assert r.status == 200
        # the port's /admin/adopt answers after the import
        assert heir.handoff_stats["imported_chains"] == got["chains"]
        assert heir.handoff_stats["imported_blocks"] > 0
        h = http_util.request_json("GET", fe.url + "/healthz").json()
        assert h["prefix_cache_blocks"] > 0
        pre = heir.engine.prefix_stats()
        pool = bench_serve._shared_pool(sc)
        reply = http_util.request_json(
            "POST", fe.url + "/generate",
            payload={"prompt_tokens": pool[:34], "max_new_tokens": 2},
            timeout_s=60.0)
        assert reply.status == 200
        post = heir.engine.prefix_stats()
        assert post["prefix_hit_tokens"] > pre.get("prefix_hit_tokens", 0)
    finally:
        fe.stop()
        if heir.running:
            heir.stop(drain_timeout=30.0)


def test_fleet_hit_ratio_and_report_gates():
    sc = dataclasses.replace(bench_serve.SCENARIOS["micro"],
                             num_requests=16, concurrency=4,
                             prompt_len=(34, 48), max_new_tokens=(2, 4),
                             shared_prefix_frac=0.5)
    single = _tiny_server().start()
    try:
        solo = bench_serve.run_scenario(single, sc)
    finally:
        single.stop(drain_timeout=30.0)
    router = bench_serve.build_tiny_fleet(replicas=2, device="cpu")
    try:
        rep = bench_serve.run_fleet_scenario(router, sc)
    finally:
        bench_serve.stop_tiny_fleet(router)
    assert rep["requests"]["states"] == {"finished": 16}
    assert rep["routing_conservation_ok"]
    assert rep["prefix"]["conservation_ok"]
    assert rep["slo"]["conservation"]["ok"]
    c = rep["counters"]
    assert c["completed"] == 16 and c["requests_lost"] == 0
    assert c["affinity_hits"] > 0
    fleet_prov = rep["provenance"]["fleet"]
    assert len(fleet_prov["replicas"]) == 2
    assert fleet_prov["affinity_block_tokens"] == 16
    solo_ratio = solo["prefix"]["prefix_hit_ratio"]
    fleet_ratio = rep["prefix"]["prefix_hit_ratio"]
    assert fleet_ratio >= solo_ratio - 0.15, \
        f"fleet hit ratio {fleet_ratio:.3f} fell >0.15 below " \
        f"single-replica {solo_ratio:.3f}"


def test_retire_ships_prefix_handoff_to_survivor():
    sc = dataclasses.replace(bench_serve.SCENARIOS["micro"],
                             num_requests=8, concurrency=2,
                             prompt_len=(34, 40), max_new_tokens=(2, 3),
                             shared_prefix_frac=0.5)
    router = bench_serve.build_tiny_fleet(
        replicas=2, device="cpu",
        fleet_overrides={"scale_out_enabled": True, "min_replicas": 1,
                         "retire_idle_polls": 8, "poll_interval_s": 0.05,
                         "drain_deadline_s": 60.0})
    try:
        rep = bench_serve.run_fleet_scenario(router, sc)
        assert rep["counters"]["requests_lost"] == 0
        pool = bench_serve._shared_pool(sc)
        r = http_util.request_json(
            "POST", router._members[1][1].url + "/generate",
            payload={"prompt_tokens": pool[:34], "max_new_tokens": 2},
            timeout_s=60.0)
        assert r.status == 200
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            c = router.counters_snapshot()
            if c["retirements"] >= 1 and c["handoffs"] >= 1:
                break
            time.sleep(0.1)
        c = router.counters_snapshot()
        assert c["retirements"] == 1
        assert c["handoffs"] == 1
        snaps = {s["id"]: s for s in router.health()["replicas"]}
        assert snaps[1]["retired"] and not snaps[1]["in_rotation"]
        assert snaps[0]["in_rotation"]
        # the handoffs counter ticks once the survivor answered the adopt,
        # which the port's front door does after the import
        survivor = router._members[0][0]
        assert survivor.handoff_stats["imported_chains"] > 0
    finally:
        bench_serve.stop_tiny_fleet(router)


def test_router_over_a_jax_replica_and_a_port_replica():
    """Wire compatibility: the port's router in front of a JAX server and
    a port server on the same flax weights. One prompt routed to each
    (the router's own pending count steers the second) comes back with the
    same greedy tokens, and both final records carry the ledger."""
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
    shape = dict(kv_block_size=16, kv_num_blocks=64)
    jserver = jserving.InferenceServer(
        jengine.InferenceEngineV2(params, jcfg, jengine.V2EngineConfig(
            **shape, scheduler=JSchedulerConfig(
                max_tokens_per_step=64, prefill_buckets=(16, 32, 64)))),
        jserving.ServingConfig(idle_poll_s=0.001)).start()
    tserver = InferenceServer(
        InferenceEngineV2(tparams, tcfg, V2EngineConfig(
            **shape, scheduler=SchedulerConfig(
                max_tokens_per_step=64, prefill_buckets=(16, 32, 64))),
            device="cpu"),
        ServingConfig(idle_poll_s=0.001)).start()
    jfe = jserving.ServingFrontend(jserver).start()
    tfe = ServingFrontend(tserver).start()
    # one poll at start, none after: the handles' state stays what it is
    router = FleetRouter(FleetConfig(affinity_enabled=False,
                                     poll_interval_s=600.0),
                         handles=[ReplicaHandle(0, jfe.url),
                                  ReplicaHandle(1, tfe.url)]).start()
    try:
        prompt = [int(t) for t in np.random.default_rng(3).integers(0, 512,
                                                                    37)]
        body = {"prompt_tokens": prompt, "max_new_tokens": 6}
        first = http_util.request_json("POST", router.url + "/generate",
                                       payload=body, timeout_s=120.0).json()
        router._handles[0].pending += 100     # steer the next to replica 1
        second = http_util.request_json("POST", router.url + "/generate",
                                        payload=body, timeout_s=120.0).json()
        assert (first["replica_id"], second["replica_id"]) == (0, 1)
        assert len(first["tokens"]) == 6
        assert first["tokens"] == second["tokens"]
        for out in (first, second):
            assert out["state"] == "finished" and out["rerouted"] == 0
        c = router.counters_snapshot()
        assert c["completed"] == 2 and c["requests_lost"] == 0
    finally:
        router.stop(terminate_replicas=False)
        jfe.stop()
        tfe.stop()
        jserver.stop(drain_timeout=10.0)
        tserver.stop(drain_timeout=10.0)


# ---------------------------------------------------------------------------
# the acceptance drill: SIGKILL a real replica process mid-decode
# ---------------------------------------------------------------------------
def test_fleet_chaos_replica_kill_drill(tmp_path, monkeypatch):
    """2 ``fleet_worker`` processes (``--device cpu``), chaos SIGKILLs
    replica 1 mid-decode, concurrent streamed clients — judged by exact
    counters: zero requests lost (every client holds its full token
    count), replica 1 lost exactly once, rerouted streams recomputed on
    the survivor, and the ``DSTPU_RESUME`` relaunch back in rotation. The
    victim's flight dump and the router's ring stitch into per-request
    timelines whose tie-out holds; the JAX package's stitcher reads the
    same dumps to the same report."""
    from deepspeed_tpu.telemetry import reqtrace as jreqtrace
    from deepspeed_tpu_torch.telemetry import reqtrace
    tracer = get_tracer()
    was_enabled = tracer.enabled
    tracer.clear()
    tracer.configure(enabled=True)
    monkeypatch.setenv("DSTPU_CHAOS_REPLICA_KILL", "1:4")
    workdir = str(tmp_path)
    launcher = subprocess_launcher(
        workdir,
        worker_args=["--kv-num-blocks", "64", "--kv-block-size", "16",
                     "--device", "cpu",
                     "--serving-overrides", json.dumps(
                         {"idle_poll_s": 0.001, "max_queue_depth": 32})],
        start_timeout_s=300.0)
    cfg = FleetConfig(replicas=2, poll_interval_s=0.1, poll_timeout_s=2.0,
                      lost_after_s=0.5, retry_budget=3,
                      retry_backoff_s=0.01, retry_backoff_max_s=0.1,
                      relaunch_budget=1, affinity_enabled=False,
                      request_timeout_s=240.0, flight_dir=workdir)
    router = FleetRouter(cfg, launcher=launcher).start()
    N, MAX_NEW = 12, 6
    results = {}
    lock = threading.Lock()

    def client(i):
        tokens, final = [], {}
        try:
            reply = http_util.open_stream(
                router.url + "/generate",
                {"prompt_tokens": [(i * 7 + j) % 96 + 1
                                   for j in range(8 + i % 4)],
                 "max_new_tokens": MAX_NEW, "stream": True},
                timeout_s=240.0,
                headers={"X-Dstpu-Trace": f"drill-{i}"})
            if reply.status != 200:
                with lock:
                    results[i] = {"status": reply.status,
                                  "error": reply.error}
                return
            for rec in reply.records():
                if "token" in rec:
                    tokens.append(rec["token"])
                elif rec.get("done"):
                    final = rec
            with lock:
                results[i] = {"status": 200, "tokens": tokens,
                              "final": final}
        except Exception as e:
            with lock:
                results[i] = {"status": -1, "error": repr(e)}

    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        assert len(results) == N
        for i, rec in sorted(results.items()):
            assert rec["status"] == 200, f"client {i}: {rec}"
            assert len(rec["tokens"]) == MAX_NEW, f"client {i}: {rec}"
            assert rec["final"].get("state") == "finished"
        c = router.counters_snapshot()
        assert c["requests_lost"] == 0
        assert c["completed"] == N
        assert c["replicas_lost"] == 1
        assert c["reroutes"] >= 1
        assert c["recomputed_tokens"] > 0
        rerouted = [r for r in results.values()
                    if r["final"].get("rerouted", 0) > 0]
        assert len(rerouted) >= 1
        assert sum(r["final"]["recomputed_tokens"] for r in rerouted) \
            == c["recomputed_tokens"]
        deadline = time.monotonic() + 300.0
        rejoined = False
        while time.monotonic() < deadline:
            c = router.counters_snapshot()
            snaps = {s["id"]: s for s in router.health()["replicas"]}
            if (c["relaunches"] == 1 and snaps[1]["in_rotation"]
                    and snaps[1]["relaunches"] == 1):
                rejoined = True
                break
            time.sleep(0.25)
        assert rejoined, f"replica 1 never rejoined: {router.health()}"
        for i, rec in sorted(results.items()):
            assert rec["final"].get("trace_id") == f"drill-{i}", rec
        flight_dumps = router.discover_flight_dumps()
        assert any(os.path.basename(p).startswith("flight_replica1_")
                   for p in flight_dumps), flight_dumps
        router_dump = os.path.join(workdir, "router_ring.json")
        tracer.export_chrome(router_dump)
        report = reqtrace.stitch_requests([router_dump] + flight_dumps)
        assert report["alignment"] == "wall_anchor"
        assert report["flight_dumps"] >= 1
        for i in range(N):
            t = report["traces"].get(f"drill-{i}")
            assert t is not None, f"drill-{i} missing"
            assert t["wall"]["outcome"] == "finished", (i, t["wall"])
        assert report["tie_out_violations"] == [], report
        assert report["max_tie_out_error"] <= reqtrace.TIE_OUT_TOLERANCE
        recovered_ids = {e["trace_id"]
                         for t in report["traces"].values()
                         for e in t.get("recovered", [])}
        assert any(tid.startswith("drill-") for tid in recovered_ids), \
            report["recovered_requests"]
        rerouted_ids = {r["final"]["trace_id"] for r in rerouted}
        traced_reroutes = {tid for tid, t in report["traces"].items()
                           if t["reroutes"] >= 1}
        assert rerouted_ids <= traced_reroutes
        # the JAX package's stitcher over the same dumps: the same report
        assert jreqtrace.stitch_requests([router_dump] + flight_dumps) == \
            report
    finally:
        router.stop()
        tracer.configure(enabled=was_enabled)
