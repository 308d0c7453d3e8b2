"""dstpu fleet — multi-replica router/front tier (port of
``deepspeed_tpu/serving/fleet.py``; run it as
``python -m deepspeed_tpu_torch.serving.fleet``).

Reference analog: the MII/FastGen split — a thin front tier routing over
N independent engine processes — grown the properties one replica cannot
provide alone:

* **prefix-affinity routing** — the prompt's full-block prefix is hashed
  (``affinity_key``, same block-granular cap as ``PrefixCache.lookup``)
  and the request prefers the replica whose radix cache last served that
  prefix, so the fleet-wide hit ratio survives scale-out instead of
  degrading 1/N;
* **ladder-aware spill** — a replica publishing brownout/shed through
  ``/healthz`` sheds to healthy peers BEFORE any client sees a 429;
  sticky-503 (degraded) and lost replicas leave rotation immediately
  (healthz polling, the membership-heartbeat idiom);
* **zero-loss failover** — the router always streams from replicas
  internally, so it knows EXACTLY which tokens each client already has;
  on replica death it re-admits ``prompt + sent_tokens`` to a survivor
  (the prefix cache turns the re-prefill into a suffix), with bounded
  retry/backoff honoring Retry-After, and a per-request ``rerouted`` /
  ``recomputed_tokens`` ledger proving nothing was dropped;
* **elastic replica lifecycle** — the elasticity-agent idiom (restart
  budget + backoff + DSTPU_RESUME + status artifact) applied to serving:
  sustained queue pressure scales out, sustained idle drains + retires
  the newest replica, and a retiring replica ships its warm prefix cache
  to its successor as a quantized HostKVStore handoff file
  (``/admin/drain`` -> export -> ``/admin/adopt``).

Every routing decision is exact-counter accounted: ``first_choice_sheds``
(requests whose FIRST-choice replica was shedding — the would-be client
429s of a spill-blind router) vs ``client_sheds`` (requests actually
refused) is the within-run counterfactual the chaos drill asserts
``client_sheds < first_choice_sheds`` on, no wall-clock A/B needed.

The pure decision helpers (``affinity_key``, ``pick_replica``,
``plan_scale``) are stdlib int/dict work and must never grow a host sync
or a tensor. This module never imports torch — a router host needs no
accelerator runtime; replicas are processes (``fleet_worker``, one CUDA
context each, several may share a card) or in-process servers.

One difference from the reference: the port's ``/admin/adopt`` answers
once the successor's serve loop has imported the handoff file, so the
retirement waits for that answer up to ``drain_deadline_s``, not one poll
timeout.
"""

import argparse
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.resilience.chaos import REPLICA_ID_ENV
from deepspeed_tpu_torch.serving import http_util
from deepspeed_tpu_torch.telemetry.tracer import TRACE_ENV, get_tracer
from deepspeed_tpu_torch.utils.logging import logger

#: status-artifact env var (elasticity.agent STATUS_ENV idiom): when set,
#: the router keeps a JSON fleet summary at this path for env_report
FLEET_STATUS_ENV = "DSTPU_FLEET_STATUS"

#: flight-recorder directory (mirrors ``serving.server.FLIGHT_DIR_ENV``;
#: the string is duplicated here because the router must never import
#: the engine-owning module — a router host needs no accelerator runtime)
FLIGHT_DIR_ENV = "DSTPU_FLIGHT_DIR"


@dataclasses.dataclass
class FleetConfig:
    replicas: int = 2                    # initial fleet size
    # --- prefix-affinity routing ---
    affinity_enabled: bool = True
    affinity_block_tokens: int = 64      # MUST match the replicas'
    # kv_block_size: the affinity key hashes whole cache blocks
    affinity_max_keys: int = 4096        # LRU cap on the affinity memo
    # --- ladder-aware spill ---
    spill_enabled: bool = True
    # --- healthz polling (membership-heartbeat idiom) ---
    poll_interval_s: float = 0.25
    poll_timeout_s: float = 2.0
    lost_after_s: float = 2.0            # unreachable this long -> lost
    # --- zero-loss failover ---
    retry_budget: int = 3                # reroutes per request
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 1.0
    request_timeout_s: float = 120.0     # overall per client request
    stream_read_timeout_s: float = 30.0  # per-token socket deadline
    default_max_new_tokens: int = 64
    # --- replica lifecycle (elasticity-agent idiom) ---
    relaunch_budget: int = 1             # relaunches per lost replica
    scale_out_enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    scale_out_queue_depth: int = 4       # queued >= this counts as pressure
    scale_out_pressure_polls: int = 8    # sustained polls before scale-out
    retire_idle_polls: int = 40          # sustained idle polls before retire
    drain_deadline_s: float = 60.0       # retirement drain+export deadline
    handoff_dir: str = ""                # "" -> a private temp dir
    handoff_quantize: str = "int8"       # prefix-handoff page codec
    # --- observability ---
    status_path: str = ""                # "" -> $DSTPU_FLEET_STATUS if set
    flight_dir: str = ""                 # "" -> $DSTPU_FLIGHT_DIR if set
    seed: int = 0                        # retry-jitter stream

    @classmethod
    def from_ds_config(cls, ds_config: dict) -> "FleetConfig":
        """Build from a DeepSpeed-style config dict's ``"fleet"`` group
        (key constant ``config.constants.FLEET``; unknown keys are an
        error — config drift must not fail silently)."""
        group = dict(ds_config.get(C.FLEET, {}) or {})
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(group) - names)
        if unknown:
            raise ValueError(
                f"unknown '{C.FLEET}' config keys: {unknown}; "
                f"known: {sorted(names)}")
        return cls(**group)


# ----------------------------------------------------------------------
# pure routing decisions (stdlib bookkeeping only)
# ----------------------------------------------------------------------
def affinity_key(prompt_tokens: Sequence[int],
                 block_tokens: int) -> Optional[int]:
    """Hash of the prompt's HEAD block — the first ``block_tokens``
    tokens, the root of any radix-cache chain the prompt can share.
    Keying on the head (not every full block) is deliberate: a workload
    of shared-system-prompt requests diverges after the shared head, and
    hashing the divergent tail would scatter exactly the requests that
    could reuse each other's warm pages. None when the prompt has no
    full cacheable block (``(len - 1) // block == 0``, mirroring
    ``PrefixCache.lookup``: the last prompt token is always computed, so
    it can never be part of a cached block). Tuple-of-int hashing is
    deterministic within a process, which is all routing stability
    needs."""
    if block_tokens < 1:
        return None
    full = max(len(prompt_tokens) - 1, 0) // block_tokens
    if full <= 0:
        return None
    head = tuple(int(t) for t in prompt_tokens[:block_tokens])
    return hash(head) & 0xFFFFFFFFFFFF


def pick_replica(snaps: List[dict], affinity_rid: Optional[int],
                 spill: bool,
                 exclude: frozenset) -> Tuple[Optional[int], str]:
    """One pure routing decision over healthz snapshots.

    The FIRST CHOICE is the affinity target when it is in rotation, else
    the least-loaded replica (queued + inflight + pending, id
    tie-break; ``pending`` is the router's own optimistic in-flight
    count, so requests routed between two health polls spread across
    replicas instead of piling onto the stale-idlest one). Returns
    ``(replica_id, verdict)``:

      affinity / least_loaded  first choice, accepting
      spill                    first choice shedding/draining -> healthy
                               peer (only with ``spill``)
      pinned_shedding          spill disabled: route to the shedding
                               first choice anyway and relay its 429 —
                               the ladder-blind baseline the drill's
                               counterfactual counter measures
      shed_all                 nobody in rotation accepts (rid None)
      no_replicas              rotation empty after ``exclude`` (rid None)
    """
    rotation = [s for s in snaps
                if s.get("in_rotation") and s["id"] not in exclude]
    if not rotation:
        return None, "no_replicas"

    def load(s: dict) -> Tuple[int, int]:
        return (int(s.get("queued", 0)) + int(s.get("inflight", 0))
                + int(s.get("pending", 0)), s["id"])

    def accepting(s: dict) -> bool:
        return not s.get("draining") and s.get("level") != "shed"

    first = None
    verdict = "least_loaded"
    if affinity_rid is not None:
        for s in rotation:
            if s["id"] == affinity_rid:
                first = s
                verdict = "affinity"
                break
    if first is None:
        first = min(rotation, key=load)
    if accepting(first):
        return first["id"], verdict
    if not spill:
        return first["id"], "pinned_shedding"
    takers = [s for s in rotation if accepting(s) and s["id"] != first["id"]]
    if not takers:
        return None, "shed_all"
    return min(takers, key=load)["id"], "spill"


def plan_scale(snaps: List[dict], cfg: FleetConfig, pressure_polls: int,
               idle_polls: int) -> Tuple[Optional[str], int, int]:
    """Pure scale decision from one poll's snapshots + streak counters:
    ``("out" | "retire" | None, pressure_polls', idle_polls')``. Pressure
    = EVERY in-rotation replica is off-healthy or has a deep queue;
    idle = every in-rotation replica has nothing queued or in flight.
    Streaks (not instants) drive actions so one bursty poll can't thrash
    the fleet; both reset to 0 when an action fires."""
    rotation = [s for s in snaps if s.get("in_rotation")]
    n_live = len([s for s in snaps
                  if not s.get("retired") and not s.get("lost")])
    pressured = bool(rotation) and all(
        s.get("level") != "healthy"
        or int(s.get("queued", 0)) >= cfg.scale_out_queue_depth
        for s in rotation)
    idle = bool(rotation) and all(
        int(s.get("queued", 0)) == 0 and int(s.get("inflight", 0)) == 0
        for s in rotation)
    pressure_polls = pressure_polls + 1 if pressured else 0
    idle_polls = idle_polls + 1 if idle else 0
    if (cfg.scale_out_enabled
            and pressure_polls >= cfg.scale_out_pressure_polls
            and n_live < cfg.max_replicas):
        return "out", 0, idle_polls
    if (cfg.scale_out_enabled and idle_polls >= cfg.retire_idle_polls
            and n_live > cfg.min_replicas):
        return "retire", pressure_polls, 0
    return None, pressure_polls, idle_polls


# ----------------------------------------------------------------------
# replica handles
# ----------------------------------------------------------------------
class ReplicaHandle:
    """Router-side state for one replica endpoint. ``proc`` is whatever
    the launcher returned (anything with ``poll()``/``terminate()``/
    ``kill()``; None for externally-managed or in-process replicas)."""

    def __init__(self, rid: int, url: str, proc=None):
        self.id = rid
        self.url = url
        self.proc = proc
        self.alive = False              # >= 1 successful healthz poll
        self.status = "unknown"
        self.level = "unknown"
        self.draining = False
        self.queued = 0
        self.inflight = 0
        self.prefix_cache_blocks = 0
        # router-side optimistic in-flight count: requests this router
        # routed here whose proxy attempt hasn't returned yet. healthz
        # queued/inflight lag by up to one poll interval; without this
        # every request inside that window lands on the same
        # stale-idlest replica
        self.pending = 0
        self.lost = False
        self.retired = False
        self.consecutive_failures = 0
        self.relaunches = 0
        self.last_ok = 0.0

    @property
    def in_rotation(self) -> bool:
        """Eligible for NEW requests. Draining replicas finish their
        in-flight streams but take nothing new; degraded (sticky 503)
        and stopped replicas are out the moment a poll sees them."""
        return (self.alive and not self.lost and not self.retired
                and not self.draining
                and self.status not in ("degraded", "stopped"))

    def snapshot(self) -> dict:
        return {"id": self.id, "url": self.url, "alive": self.alive,
                "status": self.status, "level": self.level,
                "draining": self.draining, "queued": self.queued,
                "inflight": self.inflight, "pending": self.pending,
                "prefix_cache_blocks": self.prefix_cache_blocks,
                "lost": self.lost, "retired": self.retired,
                "relaunches": self.relaunches,
                "in_rotation": self.in_rotation}


#: counter keys the router maintains; also the /metrics + status-artifact
#: proof surface the chaos drill asserts against
COUNTER_KEYS = (
    "submitted", "completed", "client_errors", "refused", "routed",
    "affinity_hits", "spills", "first_choice_sheds", "client_sheds",
    "reroutes", "recomputed_tokens", "requests_lost", "replicas_lost",
    "relaunches", "scale_outs", "retirements", "handoffs",
)


class FleetRouter:
    """The front tier: a stdlib ThreadingHTTPServer proxying
    ``POST /generate`` across replicas plus a healthz-polling membership
    thread making rotation/scale decisions. Construct with pre-built
    handles (in-process fleets) and/or a ``launcher(rid, resume) ->
    ReplicaHandle`` for process-managed replicas (relaunch + scale-out
    need it)."""

    def __init__(self, config: Optional[FleetConfig] = None,
                 handles: Sequence[ReplicaHandle] = (),
                 launcher: Optional[Callable[[int, bool],
                                             ReplicaHandle]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.config = config or FleetConfig()
        self._launcher = launcher
        self._lock = threading.Lock()
        self._handles: Dict[int, ReplicaHandle] = {h.id: h for h in handles}
        self._affinity: "OrderedDict[int, int]" = OrderedDict()
        self.counters: Dict[str, int] = {k: 0 for k in COUNTER_KEYS}
        # fleet uid -> per-request ledger entry (bounded; the proof that
        # nothing was dropped rides these + the counters)
        self.ledger: "OrderedDict[int, dict]" = OrderedDict()
        self._ledger_cap = 4096
        self._fleet_uid = itertools.count(1)
        self._stop_evt = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self._pressure_polls = 0
        self._idle_polls = 0
        self._retiring = False
        self._handoff_dir = self.config.handoff_dir or None
        # flight-recorder dumps already folded into the stitched timeline
        # (each discovery announces itself exactly once)
        self._flight_seen: set = set()
        self._retry_policy = http_util.RetryPolicy(
            max_attempts=max(self.config.retry_budget, 1),
            backoff_s=self.config.retry_backoff_s,
            backoff_max_s=self.config.retry_backoff_max_s,
            seed=self.config.seed)
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = 65.0

            def log_message(self, fmt, *args):
                logger.debug("fleet: " + fmt % args)

            def handle_one_request(self):
                # a client hanging up mid-response (timeout, ctrl-C) is
                # its prerogative, not a router stack trace
                try:
                    super().handle_one_request()
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True

            def _json(self, code: int, payload: dict, headers=()):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    h = router.health()
                    self._json(200 if h["ok"] else 503, h)
                elif self.path == "/metrics":
                    body = router.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                raw = self.rfile.read(int(self.headers.get("Content-Length",
                                                           0) or 0))
                if self.path != "/generate":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise TypeError("payload must be a JSON object")
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": f"bad request: {e!r}"})
                    return
                # the propagation channel: a client-sent X-Dstpu-Trace
                # header becomes the request's fleet-wide trace id (body
                # field wins if both — it's the more deliberate one)
                hdr_trace = self.headers.get("X-Dstpu-Trace")
                if hdr_trace and not body.get("trace_id"):
                    body["trace_id"] = hdr_trace
                if body.get("stream"):
                    sink = _ChunkSink(self)
                    status, payload, headers = router.route_generate(
                        body, sink.start, sink.emit)
                    if sink.started:
                        sink.finish(payload)
                    else:
                        self._json(status, payload, headers=headers)
                else:
                    tokens: List[int] = []
                    status, payload, headers = router.route_generate(
                        body, lambda: None, tokens.append)
                    if status == 200:
                        payload = dict(payload, tokens=tokens)
                    self._json(status, payload, headers=headers)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._http_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "FleetRouter":
        if self._launcher is not None and not self._handles:
            self._launch_initial()
        self._poll_once()           # routing needs snapshots before traffic
        self._http_thread = threading.Thread(target=self.httpd.serve_forever,
                                             name="dstpu-fleet-http",
                                             daemon=True)
        self._http_thread.start()
        self._poll_thread = threading.Thread(target=self._poll_loop,
                                             name="dstpu-fleet-poll",
                                             daemon=True)
        self._poll_thread.start()
        return self

    def _launch_initial(self) -> None:
        """Launch the initial fleet in parallel (worker startup dominates
        fleet bring-up; serializing N of them would N-fold it)."""
        errs: List[BaseException] = []

        def one(rid: int) -> None:
            try:
                h = self._launcher(rid, False)
            except BaseException as e:   # noqa: BLE001 — surfaced below
                errs.append(e)
                return
            with self._lock:
                self._handles[h.id] = h

        threads = [threading.Thread(target=one, args=(rid,), daemon=True)
                   for rid in range(self.config.replicas)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise RuntimeError(f"fleet launch failed: {errs[0]!r}") from \
                errs[0]

    def stop(self, terminate_replicas: bool = True) -> None:
        self._stop_evt.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
        if terminate_replicas:
            for h in list(self._handles.values()):
                self._terminate(h)
        self._write_status()

    @staticmethod
    def _terminate(h: ReplicaHandle, grace_s: float = 5.0) -> None:
        proc = h.proc
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.terminate()
            deadline = time.monotonic() + grace_s
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if proc.poll() is None:
                proc.kill()
        except Exception:
            logger.exception(f"fleet: terminating replica {h.id} failed")

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def ledger_snapshot(self) -> Dict[int, dict]:
        with self._lock:
            return {uid: dict(e) for uid, e in self.ledger.items()}

    def health(self) -> dict:
        with self._lock:
            snaps = [h.snapshot() for h in self._handles.values()]
            counters = dict(self.counters)
            keys = len(self._affinity)
        return {"ok": any(s["in_rotation"] for s in snaps),
                "replicas": snaps, "counters": counters,
                "affinity_keys": keys}

    def prometheus_text(self) -> str:
        """Router counters + the fleet/ tracer tracks, one TYPE block per
        family (the metrics.py discipline)."""
        lines: List[str] = []
        now = time.monotonic()
        with self._lock:
            counters = dict(self.counters)
            snaps = [h.snapshot() for h in self._handles.values()]
            # healthz staleness: seconds since the OLDEST fresh poll over
            # live replicas — the router's worst-case blind window. A
            # climbing gauge means the poll loop is wedged or a replica
            # stopped answering before being marked lost.
            ages = [now - h.last_ok for h in self._handles.values()
                    if h.alive and not h.lost and not h.retired]
        # ONE emission site for every dstpu_fleet_* family: the row list
        # can't claim a family twice (the gauge used to be a second
        # hand-emitted TYPE block inside the counter loop's namespace —
        # one COUNTER_KEYS collision away from duplicate metadata, which
        # the Prometheus text parser rejects wholesale)
        rows = [(k, "counter", counters[k]) for k in COUNTER_KEYS]
        rows.append(("replicas_in_rotation", "gauge",
                     sum(1 for s in snaps if s["in_rotation"])))
        rows.append(("healthz_staleness", "gauge",
                     round(max(ages), 6) if ages else 0.0))
        for key, kind, val in rows:
            lines.append(f"# TYPE dstpu_fleet_{key} {kind}")
            lines.append(f"dstpu_fleet_{key} {val}")
        lines.extend(get_tracer().prometheus_lines(prefix=("fleet/",
                                                           "req/")))
        return "\n".join(lines) + "\n"

    def discover_flight_dumps(self) -> List[str]:
        """Scan the flight-recorder directory for dumps left behind by
        dying/shedding replicas (``serving.server.flight_dump`` writes
        ``flight_replica{rid}_{pid}.json`` atomically, so a file that
        exists is complete). Each newly seen dump is announced once with
        a ``fleet/flight_recovered`` instant — the router-side marker the
        offline stitcher uses to fold the dump's ring into the per-request
        timeline. Returns every dump currently on disk (sorted)."""
        dirpath = self.config.flight_dir or os.environ.get(FLIGHT_DIR_ENV)
        if not dirpath or not os.path.isdir(dirpath):
            return []
        try:
            names = sorted(n for n in os.listdir(dirpath)
                           if n.startswith("flight_replica")
                           and n.endswith(".json"))
        except OSError:
            return []
        paths = [os.path.join(dirpath, n) for n in names]
        for p in paths:
            if p not in self._flight_seen:
                self._flight_seen.add(p)
                get_tracer().instant("fleet/flight_recovered", cat="serve",
                                     path=p)
                logger.warning(f"fleet: recovered flight dump {p}")
        return paths

    def _write_status(self) -> None:
        flight_dumps = self.discover_flight_dumps()
        path = self.config.status_path or os.environ.get(FLEET_STATUS_ENV)
        if not path:
            return
        with self._lock:
            doc = {"replicas": [h.snapshot()
                                for h in self._handles.values()],
                   "counters": dict(self.counters),
                   "flight_dumps": flight_dumps,
                   "updated": time.time()}
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2)
            os.replace(tmp, path)
        except OSError:
            logger.exception(f"fleet: writing status artifact {path} failed")

    # ------------------------------------------------------------------
    # healthz polling (membership) + lifecycle decisions
    # ------------------------------------------------------------------
    def _poll_loop(self) -> None:
        while not self._stop_evt.wait(self.config.poll_interval_s):
            try:
                with get_tracer().span("fleet/poll_tick", cat="serve"):
                    self._poll_once()
            except Exception:
                logger.exception("fleet: poll tick failed")

    def _poll_once(self) -> None:
        for h in list(self._handles.values()):
            if h.retired or h.lost:
                continue
            self._poll_replica(h)
        with self._lock:
            snaps = [h.snapshot() for h in self._handles.values()]
        get_tracer().counter(
            "fleet/rotation", cat="serve",
            in_rotation=sum(1 for s in snaps if s["in_rotation"]),
            draining=sum(1 for s in snaps if s["draining"]),
            lost=sum(1 for s in snaps if s["lost"]))
        get_tracer().counter(
            "fleet/load", cat="serve",
            queued=sum(s["queued"] for s in snaps if s["in_rotation"]),
            inflight=sum(s["inflight"] for s in snaps if s["in_rotation"]))
        action, self._pressure_polls, self._idle_polls = plan_scale(
            snaps, self.config, self._pressure_polls, self._idle_polls)
        if action == "out" and self._launcher is not None:
            self._scale_out()
        elif action == "retire" and not self._retiring:
            self._retire_one()
        self._write_status()

    def _poll_replica(self, h: ReplicaHandle) -> None:
        try:
            reply = http_util.request_json(
                "GET", h.url + "/healthz",
                timeout_s=self.config.poll_timeout_s)
        except Exception:
            h.consecutive_failures += 1
            proc_dead = h.proc is not None and h.proc.poll() is not None
            window = (h.consecutive_failures
                      * max(self.config.poll_interval_s, 0.01))
            if proc_dead or window >= self.config.lost_after_s:
                self._mark_lost(h, "process exited" if proc_dead
                                else "healthz unreachable")
            return
        payload = reply.json()
        h.consecutive_failures = 0
        h.alive = True
        h.last_ok = time.monotonic()
        was_in = h.in_rotation
        h.status = str(payload.get("status", "unknown"))
        h.level = str(payload.get("level", "unknown"))
        h.draining = bool(payload.get("draining"))
        h.queued = int(payload.get("queued", 0) or 0)
        h.inflight = int(payload.get("inflight", 0) or 0)
        h.prefix_cache_blocks = int(payload.get("prefix_cache_blocks", 0)
                                    or 0)
        if was_in and not h.in_rotation:
            # sticky-503/degraded/draining: out of rotation the moment the
            # poll sees it — no request waits for a timeout to learn this
            get_tracer().instant("fleet/out_of_rotation", cat="serve",
                                 replica=h.id, status=h.status,
                                 level=h.level)
            logger.warning(f"fleet: replica {h.id} out of rotation "
                           f"(status={h.status} level={h.level})")

    def _mark_lost(self, h: ReplicaHandle, reason: str) -> None:
        if h.lost or h.retired:
            return
        h.lost = True
        h.alive = False
        with self._lock:
            self.counters["replicas_lost"] += 1
            # affinity entries pointing at a corpse would keep steering
            # requests into the failover path; drop them now
            dead_keys = [k for k, rid in self._affinity.items()
                         if rid == h.id]
            for k in dead_keys:
                del self._affinity[k]
        get_tracer().instant("fleet/replica_lost", cat="serve",
                             replica=h.id, reason=reason)
        logger.warning(f"fleet: replica {h.id} LOST ({reason})")
        if (self._launcher is not None and h.proc is not None
                and h.relaunches < self.config.relaunch_budget):
            threading.Thread(target=self._relaunch, args=(h,),
                             name=f"dstpu-fleet-relaunch-{h.id}",
                             daemon=True).start()

    def _relaunch(self, dead: ReplicaHandle) -> None:
        """Elastic-agent idiom: relaunch a lost replica under its id with
        DSTPU_RESUME set (the chaos die-once contract spares it), within
        the relaunch budget."""
        try:
            fresh = self._launcher(dead.id, True)
        except Exception:
            logger.exception(f"fleet: relaunch of replica {dead.id} failed")
            return
        fresh.relaunches = dead.relaunches + 1
        with self._lock:
            self.counters["relaunches"] += 1
            self._handles[dead.id] = fresh
        get_tracer().instant("fleet/replica_relaunched", cat="serve",
                             replica=dead.id,
                             relaunches=fresh.relaunches)
        logger.warning(f"fleet: replica {dead.id} relaunched "
                       f"({fresh.relaunches}/{self.config.relaunch_budget})")

    def _scale_out(self) -> None:
        with self._lock:
            rid = max(self._handles, default=-1) + 1
            self.counters["scale_outs"] += 1
        get_tracer().instant("fleet/scale_out", cat="serve", replica=rid)
        logger.warning(f"fleet: scaling out -> replica {rid}")

        def launch() -> None:
            try:
                fresh = self._launcher(rid, False)
            except Exception:
                logger.exception(f"fleet: scale-out launch of replica "
                                 f"{rid} failed")
                return
            with self._lock:
                self._handles[rid] = fresh

        threading.Thread(target=launch, name=f"dstpu-fleet-scale-{rid}",
                         daemon=True).start()

    def _retire_one(self) -> None:
        """Drain + retire the newest in-rotation replica (LIFO, the
        scale-out inverse), shipping its warm prefix cache to the least-
        loaded survivor via the handoff file."""
        with self._lock:
            rotation = [h for h in self._handles.values() if h.in_rotation]
            if len(rotation) <= self.config.min_replicas:
                return
            victim = max(rotation, key=lambda h: h.id)
            survivors = [h for h in rotation if h.id != victim.id]
            successor = min(survivors,
                            key=lambda h: (h.queued + h.inflight, h.id)) \
                if survivors else None
            victim.draining = True       # out of rotation immediately
            self.counters["retirements"] += 1
            self._retiring = True
        if self._handoff_dir is None:
            self._handoff_dir = tempfile.mkdtemp(prefix="dstpu-fleet-")
        path = os.path.join(self._handoff_dir,
                            f"handoff_replica_{victim.id}.npz")
        get_tracer().instant("fleet/retire", cat="serve", replica=victim.id,
                             successor=(successor.id if successor else -1))
        logger.warning(f"fleet: retiring replica {victim.id} "
                       f"(successor {successor.id if successor else None})")
        try:
            http_util.request_json(
                "POST", victim.url + "/admin/drain",
                payload={"handoff_path": path,
                         "quantize": self.config.handoff_quantize},
                timeout_s=self.config.poll_timeout_s)
        except Exception:
            logger.exception(f"fleet: drain request to replica "
                             f"{victim.id} failed")
        threading.Thread(target=self._finish_retirement,
                         args=(victim, successor, path),
                         name=f"dstpu-fleet-retire-{victim.id}",
                         daemon=True).start()

    def _finish_retirement(self, victim: ReplicaHandle,
                           successor: Optional[ReplicaHandle],
                           path: str) -> None:
        try:
            deadline = time.monotonic() + self.config.drain_deadline_s
            # the handoff file appears (atomic rename) when the victim's
            # drain -> stop -> export completed; a dead/cache-less victim
            # never writes one, so the deadline moves things along
            while time.monotonic() < deadline and not os.path.exists(path):
                proc_exited = (victim.proc is not None
                               and victim.proc.poll() is not None)
                if proc_exited:
                    break
                time.sleep(0.1)
            if os.path.exists(path) and successor is not None \
                    and not successor.lost:
                try:
                    # the successor answers once its serve loop imported
                    # the file (the port's /admin/adopt waits for it)
                    reply = http_util.request_json(
                        "POST", successor.url + "/admin/adopt",
                        payload={"handoff_path": path},
                        timeout_s=max(self.config.poll_timeout_s,
                                      self.config.drain_deadline_s))
                    if reply.status != 200:
                        raise RuntimeError(
                            f"/admin/adopt answered {reply.status}: "
                            f"{reply.json().get('error')}")
                    with self._lock:
                        self.counters["handoffs"] += 1
                    get_tracer().instant("fleet/handoff", cat="serve",
                                         replica=victim.id,
                                         successor=successor.id)
                except Exception:
                    logger.exception("fleet: handoff adopt failed")
            with self._lock:
                victim.retired = True
                dead_keys = [k for k, rid in self._affinity.items()
                             if rid == victim.id]
                for k in dead_keys:
                    del self._affinity[k]
            self._terminate(victim)
        finally:
            self._retiring = False

    # ------------------------------------------------------------------
    # the request path
    # ------------------------------------------------------------------
    def route_generate(self, body: dict, started: Callable[[], None],
                       emit: Callable[[int], None]
                       ) -> Tuple[int, dict, list]:
        """Route + proxy one client request with zero-loss failover.
        ``started()`` fires once, just before the first token can flow
        (streaming handlers send their 200 header there); ``emit(tok)``
        forwards each generated token. Returns ``(status, payload,
        headers)`` — the final record for streaming clients, the whole
        response for non-streaming ones."""
        cfg = self.config
        prompt = body.get("prompt_tokens")
        if not isinstance(prompt, list) or not all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in prompt):
            with self._lock:
                self.counters["submitted"] += 1
                self.counters["client_errors"] += 1
            return 400, {"error": "prompt_tokens must be a list of ints"}, []
        try:
            max_new = int(body.get("max_new_tokens")
                          or cfg.default_max_new_tokens)
        except (TypeError, ValueError):
            with self._lock:
                self.counters["submitted"] += 1
                self.counters["client_errors"] += 1
            return 400, {"error": "bad max_new_tokens"}, []
        uid = next(self._fleet_uid)
        # fleet-wide trace id: accepted from the client (X-Dstpu-Trace /
        # body), minted here otherwise. Propagated to every replica the
        # request touches; the router's req/wall span below is the
        # envelope the offline stitcher ties the replica phases against.
        trace_id = str(body.get("trace_id") or f"r{os.getpid()}-{uid}")
        wall_t0 = time.monotonic()
        key = (affinity_key(prompt, cfg.affinity_block_tokens)
               if cfg.affinity_enabled else None)
        entry = {"rerouted": 0, "recomputed_tokens": 0, "tokens": 0,
                 "replicas": [], "state": "routing", "trace_id": trace_id}
        with self._lock:
            self.counters["submitted"] += 1
            self.ledger[uid] = entry
            while len(self.ledger) > self._ledger_cap:
                self.ledger.popitem(last=False)
        sent: List[int] = []
        tried: set = set()
        first_attempt = True
        first_shed_counted = False
        reroutes_left = cfg.retry_budget
        deadline = time.monotonic() + (float(body.get("timeout_s"))
                                       if body.get("timeout_s")
                                       else cfg.request_timeout_s)

        def note_first_shed() -> None:
            nonlocal first_shed_counted
            if first_attempt and not first_shed_counted:
                first_shed_counted = True
                with self._lock:
                    self.counters["first_choice_sheds"] += 1

        def finish_wall(outcome: str) -> None:
            # the router-observed wall time for this request, start to
            # terminal — the tie-out denominator: replica span sums plus
            # router-attributed gaps (reroute backoffs) must account for
            # this envelope within reqtrace's tolerance
            get_tracer().complete("req/wall", time.monotonic() - wall_t0,
                                  cat="serve", trace_id=trace_id, uid=uid,
                                  outcome=outcome, tokens=len(sent),
                                  replicas=list(entry["replicas"]))

        while True:
            with self._lock:
                snaps = [h.snapshot() for h in self._handles.values()]
                arid = (self._affinity.get(key)
                        if key is not None else None)
            rid, verdict = pick_replica(snaps, arid, cfg.spill_enabled,
                                        frozenset(tried))
            if verdict in ("pinned_shedding", "spill", "shed_all"):
                note_first_shed()
            if verdict == "spill":
                with self._lock:
                    self.counters["spills"] += 1
                get_tracer().instant("fleet/spill", cat="serve", uid=uid,
                                     to=rid)
            if rid is None:
                if tried and time.monotonic() < deadline:
                    # everyone was tried this round: forget the round and
                    # re-pick after a backoff (replicas recover, relaunch)
                    tried.clear()
                    time.sleep(http_util.backoff_delay(
                        self._retry_policy, 1, salt=uid))
                    first_attempt = False
                    continue
                if verdict == "shed_all" and not sent:
                    with self._lock:
                        self.counters["client_sheds"] += 1
                    entry["state"] = "shed"
                    finish_wall("shed")
                    return (429, {"uid": uid, "error": "fleet shedding",
                                  "retry_after_s": 1.0},
                            [("Retry-After", "1")])
                finish_wall("lost")
                return self._lose(uid, entry, sent,
                                  "no replicas in rotation")
            handle = self._handles.get(rid)
            if handle is None:
                tried.add(rid)
                continue
            with self._lock:
                self.counters["routed"] += 1
                if verdict == "affinity":
                    self.counters["affinity_hits"] += 1
                entry["replicas"].append(rid)
            remaining = max_new - len(sent)
            if remaining <= 0:
                # the dying replica streamed the full budget but its final
                # record never arrived: the generation is complete
                entry["state"] = "finished"
                entry["tokens"] = len(sent)
                with self._lock:
                    self.counters["completed"] += 1
                finish_wall("finished")
                return 200, self._final(uid, entry, sent, rid,
                                        {"finish_reason": "length",
                                         "state": "finished"}), []
            with self._lock:
                handle.pending += 1
            try:
                kind, info = self._proxy_once(handle, prompt + sent,
                                              remaining, body, uid, sent,
                                              started, emit, deadline,
                                              trace_id)
            finally:
                with self._lock:
                    handle.pending = max(0, handle.pending - 1)
            if kind == "done":
                if key is not None:
                    with self._lock:
                        self._affinity[key] = rid
                        self._affinity.move_to_end(key)
                        while len(self._affinity) > cfg.affinity_max_keys:
                            self._affinity.popitem(last=False)
                entry["state"] = str(info.get("state", "finished"))
                entry["tokens"] = len(sent)
                with self._lock:
                    self.counters["completed"] += 1
                finish_wall("finished")
                return 200, self._final(uid, entry, sent, rid, info), []
            if kind == "client_error":
                with self._lock:
                    self.counters["client_errors"] += 1
                entry["state"] = "client_error"
                finish_wall("client_error")
                return 400, dict(info, uid=uid), []
            if kind == "shed":
                # the replica's door 429'd a request the poll snapshot
                # thought it would take — same shed, later signal
                note_first_shed()
                tried.add(rid)
                if not cfg.spill_enabled:
                    with self._lock:
                        self.counters["client_sheds"] += 1
                    entry["state"] = "shed"
                    finish_wall("shed")
                    ra = info if isinstance(info, (int, float)) else 1.0
                    return (429, {"uid": uid, "error": "replica shedding",
                                  "retry_after_s": ra},
                            [("Retry-After", f"{ra:.0f}")])
                first_attempt = False
                continue
            if kind == "refused":
                # 503 at the door (draining/degraded): not a shed, try a
                # peer; counted so conservation still closes
                tried.add(rid)
                with self._lock:
                    self.counters["refused"] += 1
                first_attempt = False
                continue
            # kind == "died": transport death / mid-stream abort — the
            # zero-loss failover path
            if reroutes_left <= 0 or time.monotonic() >= deadline:
                finish_wall("lost")
                return self._lose(uid, entry, sent,
                                  f"retry budget exhausted after {info!r}")
            attempt = cfg.retry_budget - reroutes_left + 1
            reroutes_left -= 1
            recompute = len(prompt) + len(sent)
            with self._lock:
                self.counters["reroutes"] += 1
                self.counters["recomputed_tokens"] += recompute
                entry["rerouted"] += 1
                entry["recomputed_tokens"] += recompute
            get_tracer().instant("fleet/reroute", cat="serve", uid=uid,
                                 from_replica=rid, sent=len(sent),
                                 recompute=recompute)
            logger.warning(f"fleet: rerouting request {uid} off replica "
                           f"{rid} with {len(sent)} tokens already "
                           f"streamed ({info!r})")
            tried.add(rid)
            delay = http_util.backoff_delay(self._retry_policy, attempt,
                                            salt=uid)
            time.sleep(delay)
            # the reroute backoff is router-attributed time: it links the
            # dying replica's spans to the survivor's in the stitched
            # timeline AND accounts for the gap between them (tie-out)
            get_tracer().complete("req/reroute", delay, cat="serve",
                                  trace_id=trace_id, uid=uid,
                                  from_replica=rid, sent=len(sent),
                                  recompute=recompute)
            first_attempt = False

    def _lose(self, uid: int, entry: dict, sent: List[int],
              reason: str) -> Tuple[int, dict, list]:
        with self._lock:
            self.counters["requests_lost"] += 1
        entry["state"] = "lost"
        entry["tokens"] = len(sent)
        get_tracer().instant("fleet/request_lost", cat="serve", uid=uid,
                             reason=reason)
        logger.error(f"fleet: request {uid} LOST ({reason})")
        return 503, {"uid": uid, "error": f"request lost: {reason}",
                     "tokens_streamed": len(sent)}, []

    def _final(self, uid: int, entry: dict, sent: List[int], rid: int,
               info: dict) -> dict:
        return {"uid": uid, "state": entry["state"],
                "finish_reason": info.get("finish_reason"),
                "trace_id": entry.get("trace_id"),
                "replica_id": rid, "replicas": list(entry["replicas"]),
                "rerouted": entry["rerouted"],
                "recomputed_tokens": entry["recomputed_tokens"],
                "tokens_streamed": len(sent)}

    def _proxy_once(self, handle: ReplicaHandle, prompt: List[int],
                    max_new: int, body: dict, uid: int, sent: List[int],
                    started: Callable[[], None],
                    emit: Callable[[int], None],
                    deadline: float, trace_id: str) -> Tuple[str, object]:
        """One streamed attempt against one replica. The router ALWAYS
        streams internally — even for non-streaming clients — because the
        exact sent-token count is what makes failover lossless. Tokens
        are appended to ``sent`` and forwarded through ``emit`` the
        moment they arrive, so whatever the failure mode, the ledger
        knows precisely what the client already holds.

        Returns ``(kind, info)``: ``done`` (final record), ``shed``
        (door 429, info=retry_after_s), ``refused`` (door 503),
        ``client_error`` (door 400), ``died`` (transport death / broken
        stream / server error — the failover trigger)."""
        payload = {"prompt_tokens": prompt, "max_new_tokens": max_new,
                   "stream": True, "priority": body.get("priority", 0),
                   # the dedupe uid: the submit may be retried because THIS
                   # id makes the retry safe to attribute
                   "client_uid": uid,
                   # trace propagation rides the body too, for transports
                   # that strip custom headers
                   "trace_id": trace_id}
        if body.get("timeout_s") is not None:
            payload["timeout_s"] = body["timeout_s"]
        io_timeout = min(self.config.stream_read_timeout_s,
                         max(deadline - time.monotonic(), 0.05))
        try:
            reply = http_util.open_stream(handle.url + "/generate", payload,
                                          timeout_s=io_timeout,
                                          headers={"X-Dstpu-Trace": trace_id})
        except Exception as e:
            return "died", repr(e)
        if reply.status == 429:
            return "shed", (reply.retry_after_s() or 1.0)
        if reply.status == 503:
            return "refused", (reply.error or {})
        if reply.status == 400:
            return "client_error", (reply.error or {})
        if reply.status != 200:
            return "died", f"status {reply.status}"
        started()
        try:
            for rec in reply.records():
                if "token" in rec:
                    tok = int(rec["token"])
                    sent.append(tok)
                    emit(tok)
                elif rec.get("done"):
                    state = str(rec.get("state", "finished"))
                    if rec.get("error") or state not in ("finished",):
                        # the replica aborted/failed the stream underneath
                        # us — same contract as a death: re-admit elsewhere
                        return "died", rec.get("error", state)
                    return "done", rec
        except Exception as e:
            return "died", repr(e)
        finally:
            reply.close()
        return "died", "stream ended without a final record"


class _ChunkSink:
    """Lazy chunked-response writer for the router's streaming path: the
    200 header goes out only once a replica actually accepted the request
    (``start``), so door-rejections can still be plain status replies."""

    def __init__(self, handler):
        self._h = handler
        self.started = False

    def start(self) -> None:
        if self.started:
            return
        self.started = True
        h = self._h
        h.send_response(200)
        h.send_header("Content-Type", "application/jsonlines")
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()

    def _chunk(self, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        self._h.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self._h.wfile.flush()

    def emit(self, tok: int) -> None:
        self.start()
        try:
            self._chunk({"token": tok})
        except OSError:
            # client went away; keep consuming the replica stream so the
            # ledger still closes, just stop forwarding
            pass

    def finish(self, payload: dict) -> None:
        try:
            self._chunk(dict(payload, done=True))
            self._h.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass
        self._h.close_connection = True


# ----------------------------------------------------------------------
# subprocess replicas (the fleet CLI + the chaos kill drill)
# ----------------------------------------------------------------------
def subprocess_launcher(workdir: str, worker_args: Sequence[str] = (),
                        start_timeout_s: float = 180.0
                        ) -> Callable[[int, bool], ReplicaHandle]:
    """A launcher over ``fleet_worker`` subprocesses. Each worker gets
    ``DSTPU_REPLICA_ID`` (the chaos replica-kill selector + healthz
    identity); relaunches set ``DSTPU_RESUME`` so die-once chaos spares
    them (elastic-agent contract). The worker publishes its URL through a
    ready file; stdout/stderr land in per-replica logs under
    ``workdir``."""

    def launch(rid: int, resume: bool) -> ReplicaHandle:
        ready = os.path.join(workdir, f"replica_{rid}.ready.json")
        if os.path.exists(ready):
            os.remove(ready)
        cmd = [sys.executable, "-m",
               "deepspeed_tpu_torch.serving.fleet_worker",
               "--replica-id", str(rid), "--ready-file", ready,
               *worker_args]
        env = dict(os.environ)
        env[REPLICA_ID_ENV] = str(rid)
        # flight recorder: workers dump their ring + in-flight ledgers
        # here on death/shed (an explicit $DSTPU_FLIGHT_DIR wins so
        # drills can point the whole fleet at one directory)
        env.setdefault(FLIGHT_DIR_ENV, workdir)
        # $DSTPU_TRACE on the router would be inherited verbatim: every
        # worker's atexit ring dump would clobber the same file (and the
        # router's own dump). Derive a per-replica path instead — the
        # survivor rings it produces are exactly what `dstpu reqtrace`
        # stitches next to the router ring and the flight dumps.
        trace_path = env.get(TRACE_ENV)
        if trace_path:
            base, ext = os.path.splitext(trace_path)
            env[TRACE_ENV] = f"{base}_replica{rid}{ext or '.json'}"
        if resume:
            env["DSTPU_RESUME"] = "fleet-relaunch"
        else:
            env.pop("DSTPU_RESUME", None)
        log_path = os.path.join(workdir, f"replica_{rid}.log")
        log_f = open(log_path, "ab")
        try:
            proc = subprocess.Popen(cmd, env=env, stdout=log_f,
                                    stderr=subprocess.STDOUT)
        finally:
            log_f.close()
        deadline = time.monotonic() + start_timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(ready):
                try:
                    with open(ready) as f:
                        info = json.load(f)
                    return ReplicaHandle(rid, info["url"], proc=proc)
                except (OSError, ValueError, KeyError):
                    pass    # mid-write; retry
            if proc.poll() is not None:
                raise RuntimeError(
                    f"replica {rid} exited with {proc.returncode} before "
                    f"ready (log: {log_path})")
            time.sleep(0.1)
        proc.kill()
        raise RuntimeError(f"replica {rid} not ready within "
                           f"{start_timeout_s:.0f}s (log: {log_path})")

    return launch


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the router over N tiny hermetic replicas (subprocess
    ``fleet_worker`` each, on the card unless ``--device cpu``) or over
    externally-managed replica URLs (``--replica-url``, repeatable — e.g. N
    ``deepspeed_tpu_torch.serving.cli`` processes)."""
    p = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.serving"
                                ".fleet", description=main.__doc__)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--replica-url", action="append", default=[],
                   help="route over these URLs instead of launching "
                        "workers (repeatable)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--no-affinity", action="store_true")
    p.add_argument("--no-spill", action="store_true")
    p.add_argument("--scale-out", action="store_true",
                   help="enable elastic scale-out/retire")
    p.add_argument("--max-replicas", type=int, default=4)
    p.add_argument("--kv-num-blocks", type=int, default=64)
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="the workers' device: cuda (the default) or cpu")
    p.add_argument("--workdir", default="",
                   help="ready files + replica logs (default: temp dir)")
    p.add_argument("--status-path", default="",
                   help="fleet status artifact (default: "
                        "$DSTPU_FLEET_STATUS if set)")
    args = p.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="dstpu-fleet-")
    cfg = FleetConfig(replicas=args.replicas,
                      affinity_enabled=not args.no_affinity,
                      affinity_block_tokens=args.kv_block_size,
                      spill_enabled=not args.no_spill,
                      scale_out_enabled=args.scale_out,
                      max_replicas=args.max_replicas,
                      handoff_dir=workdir,
                      # workers flight-dump into the workdir by default
                      # (subprocess_launcher's $DSTPU_FLIGHT_DIR
                      # setdefault) — look for recoveries there unless
                      # the operator pointed the fleet elsewhere
                      flight_dir=os.environ.get(FLIGHT_DIR_ENV, workdir),
                      status_path=args.status_path)
    if args.replica_url:
        handles = [ReplicaHandle(i, u)
                   for i, u in enumerate(args.replica_url)]
        router = FleetRouter(cfg, handles=handles, host=args.host,
                             port=args.port)
    else:
        worker_args = ["--kv-num-blocks", str(args.kv_num_blocks),
                       "--kv-block-size", str(args.kv_block_size)]
        if args.device:
            worker_args += ["--device", args.device]
        launcher = subprocess_launcher(workdir, worker_args=worker_args)
        router = FleetRouter(cfg, launcher=launcher, host=args.host,
                             port=args.port)
    router.start()
    print(f"fleet: routing on {router.url} "
          f"({len(router.health()['replicas'])} replicas; workdir "
          f"{workdir})")
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
