"""Continuous-batching serve loop over ``InferenceEngineV2`` (port of
``deepspeed_tpu/serving/server.py``; reference analog: DeepSpeed-MII's async
pipeline above the v2 ragged engine). Architecture:

  submit() threads --> bounded admission queue --> serve loop (ONE thread)
                                                     |-- engine.admit / step
                                                     |-- KV tier rebalance
                                                     |   (demote/promote)
                                                     |-- degradation ladder
                                                     |-- token fan-out to
                                                     |   per-request streams
                                                     `-- deadline / cancel /
                                                         reap / metrics

The engine is single-threaded by construction (eager launches on one
stream + host-side KV bookkeeping), so ONLY the serve loop touches it, under
``torch.no_grad()`` (grad mode is per thread, so the caller's mode does not
reach the loop); callers interact through thread-safe ``Request`` objects.
The loop's bookkeeping (gauges, ladder, tier planner, ``kv_ledger``,
``health()``) is host arithmetic: the only wait for the card per tick stays
the engine's sampled-id readback. Admission control is two-tier: a bounded
queue (depth) plus a projected KV watermark — with the host KV offload
tier enabled, the projection spans BOTH tiers (device watermark + host
budget), so overload degrades to *slower* (requests wait demoted in host
RAM) before it degrades to *429*.

Serving under siege (this file + ``degradation.py`` + ``kv_tier.py``):

* the **degradation ladder** (healthy -> brownout -> shed -> degraded)
  turns overload into explicit, hysteresis-damped, trace-instrumented
  states — see ``degradation.py``;
* **request-level fault isolation**: engine-step exceptions are classified
  through ``comm.guard.classify_exception``; only FATAL classes latch the
  sticky degraded 503. Transient faults evict a suspect request (retried
  with its KV recomputed, quarantined past its retry budget) and health
  auto-recovers after N clean steps;
* the serve tick is chaos-drillable (``DSTPU_CHAOS_SERVE_*``) and every
  transition is an edge-triggered dstrace instant, so a whole overload
  episode reconstructs from the trace + deterministic counters alone
  (``bench_serve``).
"""

import concurrent.futures
import dataclasses
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from deepspeed_tpu_torch.comm.guard import CommOutcome, classify_exception
from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.resilience.chaos import (REPLICA_ID_ENV,
                                                  monkey_from_env)
from deepspeed_tpu_torch.serving.degradation import (DegradationLadder,
                                                     LadderConfig, ServeLevel)
from deepspeed_tpu_torch.serving.kv_tier import (effective_usable_blocks,
                                                 plan_demotions,
                                                 plan_prefix_evictions,
                                                 plan_promotions,
                                                 tier_pressure)
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.request import Request, RequestState
from deepspeed_tpu_torch.telemetry.tracer import get_tracer, request_tid
from deepspeed_tpu_torch.utils.logging import logger


#: an un-trippable demote line for cache trims outside the offload tier
#: (module-level so the hot tick never calls float() itself)
_NO_DEMOTE_LINE = float("inf")

#: flight-recorder directory (set by the fleet launcher on every replica
#: worker): when present, a dying/shedding replica atomically dumps its
#: trace ring + live per-request ledgers here (write-then-rename), so the
#: router can fold the dump into the stitched request timeline post-mortem
FLIGHT_DIR_ENV = "DSTPU_FLIGHT_DIR"

#: throttle between shed-triggered flight dumps: a shedding replica 429s
#: many requests per second and one black box per episode is the point
FLIGHT_SHED_INTERVAL_S = 5.0

#: how long ``adopt_prefix_handoff`` waits for the serve loop to import a
#: queued handoff file before it gives up with a ``TimeoutError``
HANDOFF_WAIT_S = 60.0

#: the serving-tick stage clocks `dstpu plan --serve` attributes: the
#: server times admission/demote/promote/drain segments itself, the engine
#: reports prefill/decode from inside step() (``last_step_timing``), and
#: the remainder of the tick is residual
_TICK_STAGES = ("admission", "prefill", "decode", "demote", "promote",
                "drain")

#: stage -> retro-span name for the server-timed segments (prefill/decode
#: spans are emitted by the engine inside serve/engine_step)
_TICK_SPAN_NAMES = {"admission": "serve/admit", "demote": "serve/demote",
                    "promote": "serve/promote", "drain": "serve/drain"}


class BackpressureError(RuntimeError):
    """Admission rejected: queue full, projected KV occupancy over the
    watermark, or the degradation ladder is shedding. ``retry_after_s`` is
    the client backoff hint (HTTP 429 + Retry-After in the front-end)."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ServerClosedError(RuntimeError):
    """Submission refused: the server is draining, stopped, or degraded."""


#: the ``serving.scheduler`` sub-group (a nested dict so partial user
#: configs merge over these and ``from_ds_config`` passes the group
#: through verbatim): decode-first chunked prefill + the prefill/decode
#: role split. Every default = today's semantics (cap off, one engine).
SCHEDULER_DEFAULTS = {
    # per-tick prefill-token cap: chunked prefill interleaves with decode
    # so TPOT never spikes behind a long prompt. 0 = uncapped (pre-cap
    # planning, bit-identical). Must cover >= 1 KV block when set.
    "prefill_chunk_tokens": 0,
    # prefill-role/decode-role engine pair in one process with
    # block-granular KV handoff (serving/disagg.py); consumed by the
    # server builder, not the tick
    "role_split": False,
    # page codec for the in-process KV handoff ("none" | "int8" | "fp8");
    # "none" = full-width, bit-identical adoption
    "handoff_quantize": "none",
}


class _EngineStepError(RuntimeError):
    """Internal: ``engine.step`` raised. Carries the original exception as
    ``__cause__`` so the fault handler can classify it (fatal -> sticky
    degraded; transient -> evict a suspect request and keep serving)."""


@dataclass
class ServingConfig:
    max_queue_depth: int = 64            # bounded admission queue
    kv_high_watermark: float = 0.95      # projected KV-occupancy reject line
    default_max_new_tokens: int = 64
    default_timeout_s: Optional[float] = None   # per-request deadline
    retry_after_s: float = 1.0           # backoff hint on rejection
    idle_poll_s: float = 0.002           # loop sleep when no work
    monitor_export_every: int = 0        # engine steps between monitor
    # exports; 0 disables the fan-out even when a monitor is attached

    # --- degradation ladder (degradation.py) ---
    brownout_pressure: float = 0.85      # pressure >= this -> BROWNOUT
    shed_pressure: float = 0.97          # pressure >= this -> SHED (429s)
    ladder_hysteresis: float = 0.10      # descend below threshold - this
    ladder_cooldown_ticks: int = 20      # calm ticks before descending
    brownout_max_new_tokens: int = 16    # admission-time cap in brownout

    # --- host KV offload tier (kv_tier.py; default OFF = the pre-tier
    # admission semantics, same opt-in discipline as async_pipeline) ---
    kv_offload_enabled: bool = False
    host_kv_budget_bytes: int = 256 << 20   # host-RAM demotion budget
    kv_demote_watermark: float = 0.90       # demote above this device frac
    kv_demote_watermark_brownout: float = 0.60   # aggressive in brownout
    min_active_requests: int = 1            # never demote below this
    # host-tier page codec ("none" | "int8" | "fp8"): demoted pages are
    # stored narrow with per-page fp32 scales — ~2x (bf16->fp8) to ~4x
    # (fp32->int8) more effective blocks under the same host budget;
    # promotion dequantizes back to device width (tolerance-bounded).
    # Device-fp8 pages are never re-quantized (bit-identical round-trip
    # preserved)
    host_kv_quantize: str = "none"

    # --- radix prefix cache over KV pages (inference/v2/prefix_cache.py;
    # default OFF = every prompt prefills from scratch) ---
    prefix_cache_enabled: bool = False
    # soft cap on UNPINNED cached blocks trimmed every tick (0 = only
    # pressure evicts); pinned shared pages are never evicted
    prefix_cache_max_blocks: int = 0

    # --- request-level fault isolation ---
    poison_retry_budget: int = 1         # evict+retry this many times,
    # then quarantine (FAILED, reason "quarantined")
    recover_clean_steps: int = 8         # clean engine steps to declare a
    # fault episode over (serve/recovered instant + counter)
    max_consecutive_step_faults: int = 8  # latch degraded past this many
    # engine-step faults with no clean step in between

    # --- async serve scheduler (SCHEDULER_DEFAULTS above): decode-first
    # chunked prefill + the prefill/decode role split; a partial dict
    # merges over the defaults in __post_init__ ---
    scheduler: dict = dataclasses.field(
        default_factory=lambda: dict(SCHEDULER_DEFAULTS))

    def __post_init__(self):
        merged = dict(SCHEDULER_DEFAULTS)
        unknown = sorted(set(self.scheduler or {}) - set(merged))
        if unknown:
            raise ValueError(
                f"unknown 'serving.scheduler' keys: {unknown}; "
                f"known: {sorted(merged)}")
        merged.update(self.scheduler or {})
        self.scheduler = merged
        if int(merged["prefill_chunk_tokens"]) < 0:
            raise ValueError(
                f"serving.scheduler.prefill_chunk_tokens must be >= 0, "
                f"got {merged['prefill_chunk_tokens']}")
        from deepspeed_tpu_torch.inference.v2.kv_offload import KV_CODECS
        if merged["handoff_quantize"] not in KV_CODECS:
            raise ValueError(
                f"serving.scheduler.handoff_quantize must be one of "
                f"{KV_CODECS}, got {merged['handoff_quantize']!r}")

    @classmethod
    def from_ds_config(cls, ds_config: dict) -> "ServingConfig":
        """Build from a DeepSpeed-style config dict's ``"serving"`` group
        (key constant ``config.constants.SERVING``; unknown keys are an
        error — config drift must not fail silently)."""
        group = dict(ds_config.get(C.SERVING, {}) or {})
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(group) - names)
        if unknown:
            raise ValueError(
                f"unknown '{C.SERVING}' config keys: {unknown}; "
                f"known: {sorted(names)}")
        return cls(**group)


class InferenceServer:
    """Drives one ``InferenceEngineV2`` from a background thread with
    continuous batching, streaming fan-out, tiered admission control, a
    degradation ladder, request-level fault isolation, and graceful drain
    (the shutdown AND elastic-resize hook: drain, resize or recreate the
    engine, start a fresh server)."""

    def __init__(self, engine, config: Optional[ServingConfig] = None,
                 monitor=None, membership=None, chaos=None):
        if membership is not None:
            raise NotImplementedError(
                "membership= (resilience/membership.py, the lost-peer 503 "
                "latch) is not ported yet (ROADMAP Queue 1 item 6b: "
                "resilience)")
        self.engine = engine
        self.config = config or ServingConfig()
        # deterministic fault injection for the serve tick (chaos drills);
        # picked up from DSTPU_CHAOS_SERVE_* env when not passed explicitly
        self.chaos = chaos if chaos is not None else monkey_from_env()
        if not 0.0 < self.config.kv_high_watermark <= 1.0:
            # the watermark IS the no-mid-decode-exhaustion invariant: the
            # sum of accepted requests' worst-case blocks never exceeds
            # watermark * usable blocks, so lazy per-step reservation can't
            # run dry; above 1.0 that guarantee is gone (with the offload
            # tier enabled, the tier policy re-establishes it dynamically)
            raise ValueError(
                f"kv_high_watermark must be in (0, 1], got "
                f"{self.config.kv_high_watermark}")
        self.metrics = ServingMetrics()
        self.monitor = monitor
        self.ladder = DegradationLadder(LadderConfig(
            brownout_pressure=self.config.brownout_pressure,
            shed_pressure=self.config.shed_pressure,
            hysteresis=self.config.ladder_hysteresis,
            cooldown_ticks=self.config.ladder_cooldown_ticks))
        self._uid = itertools.count(1)
        self._lock = threading.Lock()          # queue + tables, never engine
        self._queue: List[Request] = []        # accepted, not yet in engine
        self._inflight: Dict[int, Request] = {}  # uid -> engine-resident
        self._demoted: List[int] = []          # uids in the host tier (FIFO)
        self._draining = False
        self._stopped = False
        self._degraded: Optional[str] = None   # sticky engine-failure reason
        self._kv_drifted = False   # edge detector for the kv_drift instant
        self._kv_watermark_scale = 1.0   # drift-recalibrated multiplier
        self._wake = threading.Event()         # submit() nudges the loop
        self._thread: Optional[threading.Thread] = None
        # the offload tier needs the engine-side hooks (real engines have
        # them; minimal doubles in tests may not)
        self._tier_capable = (self.config.kv_offload_enabled
                              and hasattr(engine, "demote_kv"))
        from deepspeed_tpu_torch.inference.v2.kv_offload import KV_CODECS
        if self.config.host_kv_quantize not in KV_CODECS:
            raise ValueError(
                f"host_kv_quantize must be one of {KV_CODECS}, got "
                f"{self.config.host_kv_quantize!r}")
        # radix prefix cache: the serving knob flips it on at the engine
        # (where admission lives); minimal test doubles without the hook
        # simply run uncached
        if self.config.prefix_cache_enabled and \
                hasattr(engine, "enable_prefix_cache"):
            engine.enable_prefix_cache(self.config.prefix_cache_max_blocks)
        self._prefix_capable = (self.config.prefix_cache_enabled
                                and getattr(engine, "prefix_cache", None)
                                is not None)
        # decode-first chunked prefill: wire the scheduler sub-group's cap
        # into the engine's SplitFuse planner (minimal test doubles without
        # the hook simply run uncapped); cap 0 touches nothing, so the
        # default config leaves planning bit-identical
        cap = int(self.config.scheduler.get("prefill_chunk_tokens", 0) or 0)
        if cap > 0 and hasattr(engine, "configure_chunked_prefill"):
            engine.configure_chunked_prefill(cap)
        self._block_bytes_cache: Optional[int] = None
        # serving-tick stage clocks (serve-loop-private): cumulative busy
        # seconds per stage + cumulative tick seconds, feeding the
        # serve/tick_stage_share counter track (/metrics + dstrace)
        self._tick_stage_cum = {s: 0.0 for s in _TICK_STAGES}
        self._tick_cum_s = 0.0
        # fleet identity: set by the fleet launcher on replica workers
        # (-1 standalone); reported on /healthz so the router can key
        # affinity/retirement by replica, and matched by the chaos
        # replica-kill knob
        try:
            self.replica_id = int(os.environ.get(REPLICA_ID_ENV, "-1")
                                  or "-1")
        except ValueError:
            self.replica_id = -1
        # predecessor prefix-handoff files queued for adoption, each with
        # the future its caller waits on; imported by the serve loop
        # between ticks (the thread that owns the engine)
        self._handoff_paths: List[tuple] = []
        self.handoff_stats = {"imported_chains": 0, "imported_blocks": 0,
                              "skipped_chains": 0}
        # fault-isolation state (serve-loop-private except the flag)
        self._tick = 0
        self._consecutive_faults = 0
        self._clean_steps = 0
        self._fault_episode = False            # read by health() under lock
        self._admitted_since_clean: List[int] = []
        # flight recorder: last dump's monotonic stamp (shed throttle)
        self._last_flight_dump: Optional[float] = None
        if self.chaos is not None:
            # SIGKILL is uncatchable, so the black box cannot be a signal
            # handler: the chaos monkey exposes a pre-kill hook and the
            # flight dump runs SYNCHRONOUSLY before os.kill fires
            self.chaos.on_replica_kill = self._flight_on_kill

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "InferenceServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="dstpu-serve", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting new requests; keep stepping until every accepted
        request reaches a terminal state. Returns True when fully drained
        (False on timeout, with requests still in flight)."""
        with self._lock:
            self._draining = True
        self._wake.set()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                live = len(self._queue) + len(self._inflight)
            if live == 0:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(self.config.idle_poll_s)

    def stop(self, drain_timeout: Optional[float] = 30.0):
        """Graceful shutdown: drain, then stop the loop. Requests still
        live after the drain timeout are force-cancelled."""
        if self._thread is None or not self._thread.is_alive():
            # no serve loop to honor cancellations: settle accepted
            # requests directly instead of polling a drain that can't
            # progress (callers blocked in result() would hang forever)
            with self._lock:
                self._draining = True
            self._fail_all("server stopped before the serve loop ran")
            with self._lock:
                self._stopped = True
            self._fail_handoffs()
            return
        drained = self.drain(timeout=drain_timeout)
        if not drained:
            with self._lock:
                leftovers = list(self._queue) + list(self._inflight.values())
            for req in leftovers:
                req.cancel()
            self.drain(timeout=5.0)
        with self._lock:
            self._stopped = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._fail_handoffs()

    # ------------------------------------------------------------------
    # fleet prefix handoff (retirement export / successor adoption)
    # ------------------------------------------------------------------
    def adopt_prefix_handoff(self, path: str) -> None:
        """Adopt a predecessor's prefix-handoff file. The serve loop — the
        only thread that owns the engine — imports it between ticks, so
        this is safe to call from the frontend's admin route while requests
        are in flight; the call waits for that import and raises what it
        raised, not in a log line. An engine without
        ``import_prefix_handoff`` raises ``NotImplementedError``. With no
        serve loop running (worker startup), the import runs inline."""
        if not hasattr(self.engine, "import_prefix_handoff"):
            raise NotImplementedError(
                f"{type(self.engine).__name__} cannot import a prefix "
                "handoff (no import_prefix_handoff)")
        if not self.running:
            self._import_handoff(path)
            return
        done: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self._stopped:
                raise ServerClosedError("server stopped: handoff not adopted")
            self._handoff_paths.append((path, done))
        self._wake.set()
        done.result(timeout=HANDOFF_WAIT_S)

    def _fail_handoffs(self) -> None:
        """Settle adoptions the serve loop never reached (it stopped first),
        so their callers get an error instead of waiting out the timeout."""
        with self._lock:
            pending, self._handoff_paths = self._handoff_paths, []
        for path, done in pending:
            done.set_exception(ServerClosedError(
                f"server stopped before adopting handoff {path}"))

    def _adopt_handoffs(self) -> None:
        with self._lock:
            pending, self._handoff_paths = self._handoff_paths, []
        for path, done in pending:
            try:
                self._import_handoff(path)
            except Exception as e:
                logger.exception(
                    f"serve: prefix handoff import failed ({path})")
                done.set_exception(e)
            else:
                done.set_result(None)

    def _import_handoff(self, path: str) -> None:
        got = self.engine.import_prefix_handoff(path)
        self.handoff_stats["imported_chains"] += got.get("chains", 0)
        self.handoff_stats["imported_blocks"] += got.get("blocks", 0)
        self.handoff_stats["skipped_chains"] += got.get("skipped", 0)
        get_tracer().instant("serve/prefix_handoff_adopt", cat="serve",
                             **{k: int(v) for k, v in got.items()})
        logger.info(f"serve: adopted prefix handoff {path}: {got}")

    def export_prefix_handoff(self, path: str,
                              quantize: Optional[str] = None) -> dict:
        """Drain-time export of the warm prefix cache for a successor
        (retirement: drain -> stop -> export -> successor adopts). Must
        run with the serve loop stopped — the export gathers device pages
        and may not race the tick."""
        if self.running:
            raise RuntimeError(
                "export_prefix_handoff requires a stopped server "
                "(drain + stop first)")
        if not hasattr(self.engine, "export_prefix_handoff"):
            return {"chains": 0, "blocks": 0}
        q = quantize if quantize is not None else self.config.host_kv_quantize
        got = self.engine.export_prefix_handoff(path, quantize=q)
        get_tracer().instant("serve/prefix_handoff_export", cat="serve",
                             **{k: int(v) for k, v in got.items()})
        logger.info(f"serve: exported prefix handoff {path}: {got}")
        return got

    @property
    def running(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._stopped)

    @property
    def draining(self) -> bool:
        return self._draining

    def health(self) -> dict:
        with self._lock:
            queued, inflight = len(self._queue), len(self._inflight)
            demoted = len(self._demoted)
            degraded = self._degraded
            fault_episode = self._fault_episode
        state = ("stopped" if self._stopped else
                 # a FATAL engine-step failure means the KV/sequence state
                 # is suspect: report unhealthy (503 at /healthz) so load
                 # balancers stop routing here — sticky until the engine is
                 # replaced (drain + recreate), not self-clearing.
                 # Transient step faults do NOT land here (they run the
                 # evict/retry/quarantine path and auto-recover).
                 "degraded" if degraded else
                 "draining" if self._draining else
                 "serving" if self.running else "not_started")
        level = self.ladder.level
        out = {"status": state, "ok": state == "serving",
               "level": level.name.lower(),
               "level_reason": self.ladder.reason,
               "queued": queued, "inflight": inflight,
               "demoted": demoted,
               "fault_episode": fault_episode,
               "step_faults": self.metrics.engine_step_faults,
               "kv_occupancy": self.engine.kv_occupancy(),
               # the fleet router's affinity + retirement signals
               "replica_id": self.replica_id,
               "draining": self._draining,
               "prefix_cache_blocks": (
                   self.engine.prefix_cache.cached_blocks()
                   if getattr(self.engine, "prefix_cache", None) is not None
                   else 0)}
        if degraded:
            out["degraded_reason"] = degraded
        if self._tier_capable:
            out["host_kv_bytes"] = self.engine.host_kv_bytes()
        return out

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _blocks_for(self, req: Request) -> int:
        # worst case AT COMPLETION: prompt + full budget. Invariant under
        # eviction/re-admission (generated tokens move from budget to
        # prompt, the total is unchanged)
        return self.engine.kv.blocks_needed(
            len(req.prompt_tokens) + req.max_new_tokens)

    def _block_bytes(self) -> int:
        if self._block_bytes_cache is None:
            fn = getattr(self.engine, "kv_block_bytes", None)
            self._block_bytes_cache = fn() if fn is not None else 0
        return self._block_bytes_cache

    def _host_budget_blocks(self) -> int:
        """The host tier's capacity expressed in device-block equivalents
        — what admission projects against beyond the device watermark."""
        if not self._tier_capable:
            return 0
        bb = self._block_bytes()
        if bb <= 0:
            return 0
        return self.config.host_kv_budget_bytes // bb

    def submit(self, prompt_tokens: Sequence[int],
               max_new_tokens: Optional[int] = None,
               timeout_s: Optional[float] = None,
               priority: int = 0,
               trace_id: Optional[str] = None) -> Request:
        """Accept a request (thread-safe) or reject synchronously.
        Raises ``ServerClosedError`` when draining/stopped/degraded and
        ``BackpressureError`` when the ladder sheds, the queue is full, or
        the projected KV occupancy (both tiers) is over its limit.
        ``priority < 0`` marks low-priority work whose engine admission is
        paused during brownout. ``trace_id`` (the router's X-Dstpu-Trace
        value) makes the request's lifecycle spans stitchable fleet-wide
        (``req/`` twins carrying the id)."""
        cfg = self.config
        if max_new_tokens is None:
            max_new_tokens = cfg.default_max_new_tokens
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if not isinstance(priority, int) or isinstance(priority, bool):
            # the serve loop compares priorities every admission scan — a
            # stringly-typed priority must be a 400 at the door, not a
            # TypeError on the loop thread
            raise ValueError(f"priority must be an int, got {priority!r}")
        level = self.ladder.level
        if level >= ServeLevel.BROWNOUT and level < ServeLevel.DEGRADED:
            # degrade-to-slower: cap the generation budget at the door (the
            # request still gets tokens, just fewer — 200, not 429)
            max_new_tokens = min(max_new_tokens, cfg.brownout_max_new_tokens)
        req = Request(uid=next(self._uid), prompt_tokens=prompt_tokens,
                      max_new_tokens=max_new_tokens,
                      timeout_s=(timeout_s if timeout_s is not None
                                 else cfg.default_timeout_s),
                      priority=priority)
        # the ladder level this request was accepted under rides on its
        # lifecycle retro-spans, so `dstpu plan --serve` can report
        # TTFT/TPOT per ladder level (healthy vs brownout tails)
        req.ladder_level = level.name.lower()
        if trace_id is not None:
            req.trace_id = str(trace_id)
        if not req.prompt_tokens:
            raise ValueError("empty prompt")
        max_ctx = self.engine.state.max_context_length
        if len(req.prompt_tokens) + req.max_new_tokens > max_ctx:
            # past max_seq_len the decode would silently clamp positions
            # (garbage RoPE rotations), so reject at the door
            raise ValueError(
                f"prompt ({len(req.prompt_tokens)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max context {max_ctx}")
        with self._lock:
            if self._draining or self._stopped:
                raise ServerClosedError("server is draining; not accepting "
                                        "new requests")
            if self._degraded:
                # new work on a suspect engine would fail anyway — refuse at
                # the door (503) until the replica is drained and replaced
                raise ServerClosedError(
                    f"server degraded ({self._degraded}); not accepting "
                    "new requests")
            if level is ServeLevel.SHED:
                # the ladder's explicit overload rung: reject with a
                # backoff hint (429 + Retry-After) BEFORE burning queue/
                # projection arithmetic on a request we can't take
                self.metrics.on_shed()
                get_tracer().instant("serve/backpressure", cat="serve",
                                     kind="shed")
                # shed-to-429 is a flight-recorder trigger: the black box
                # explains WHY clients got 429s (throttled — one dump per
                # episode, not one per refused request)
                self.flight_dump("shed",
                                 min_interval_s=FLIGHT_SHED_INTERVAL_S,
                                 _locked=True)
                raise BackpressureError(
                    f"shedding load (pressure "
                    f"{self.ladder.last_pressure:.2f}); retry after "
                    f"{cfg.retry_after_s:.1f}s", cfg.retry_after_s)
            if len(self._queue) >= cfg.max_queue_depth:
                self.metrics.on_reject()
                get_tracer().instant("serve/backpressure", cat="serve",
                                     kind="queue_full")
                raise BackpressureError(
                    f"admission queue full ({cfg.max_queue_depth}); retry "
                    f"after {cfg.retry_after_s:.1f}s", cfg.retry_after_s)
            # projected occupancy at completion: worst-case blocks of every
            # accepted request (queued AND in flight — an admitted request
            # keeps reserving blocks as it decodes) + this one, admitted
            # against BOTH tiers: the (drift-recalibrated) device watermark
            # plus the host tier's budget in block equivalents
            total_blocks = max(self.engine.kv_usable_blocks(), 1)
            projected = (sum(self._blocks_for(r) for r in self._queue)
                         + sum(self._blocks_for(r)
                               for r in self._inflight.values())
                         + self._blocks_for(req))
            watermark = cfg.kv_high_watermark * self._kv_watermark_scale
            capacity = watermark * total_blocks + self._host_budget_blocks()
            if projected > capacity:
                self.metrics.on_reject()
                get_tracer().instant("serve/backpressure", cat="serve",
                                     kind="kv_watermark")
                raise BackpressureError(
                    f"projected KV occupancy {projected} blocks over "
                    f"two-tier capacity {capacity:.0f} (watermark "
                    f"{watermark:.2f}); retry after "
                    f"{cfg.retry_after_s:.1f}s", cfg.retry_after_s)
            self._queue.append(req)
        self.metrics.on_submit()
        self._wake.set()
        return req

    def cancel(self, uid: int) -> bool:
        """Request cancellation by uid; True if the request was found live."""
        with self._lock:
            for r in self._queue:
                if r.uid == uid:
                    r.cancel()
                    return True
            req = self._inflight.get(uid)
        if req is not None:
            req.cancel()
            return True
        return False

    # ------------------------------------------------------------------
    # the serve loop (single thread; sole owner of the engine)
    # ------------------------------------------------------------------
    def _serve_loop(self):
        with torch.no_grad():
            self._serve_forever()

    def _serve_forever(self):
        while True:
            if self._stopped:
                return
            try:
                worked = self._serve_once()
            except _EngineStepError as e:
                self._on_step_fault(e)
                worked = False
            except Exception:
                # non-engine bookkeeping glitch: requests are still healthy,
                # log and keep serving
                logger.exception("serve loop: non-fatal tick error")
                worked = False
            if not worked:
                # nothing to do: block until a submit() nudge (bounded so
                # deadline expiry of QUEUED requests is still noticed)
                self._wake.wait(timeout=self.config.idle_poll_s * 10)
                self._wake.clear()

    def _serve_once(self) -> bool:
        t_tick0 = time.monotonic()
        self._tick += 1
        marks: List[tuple] = []     # the tick's stage timeline (see _mark)
        if self.chaos is not None:
            self.chaos.serve_slow_tick(self._tick)
            # fleet drill: SIGKILL this replica mid-decode when it is the
            # configured victim (has_work == live streams to fail over)
            self.chaos.maybe_kill_replica(self._tick, self.engine.has_work())
        if self._handoff_paths:
            # rare (successor adoption at retirement); one attr check per
            # tick otherwise
            self._adopt_handoffs()
        t0 = time.monotonic()
        self._expire_and_cancel()
        self._mark(marks, "drain", t0)
        stolen_frac = (self.chaos.serve_kv_pressure(self._tick)
                       if self.chaos is not None else 0.0)
        moved = 0
        if self._tier_capable:
            moved += self._rebalance_kv_tiers(stolen_frac, marks)
        elif self._prefix_capable:
            # no offload tier: the cache still honors its soft cap (the
            # demote line doesn't exist, so pass an un-trippable one)
            self._trim_prefix_cache(self.engine.kv_reserved_blocks(),
                                    _NO_DEMOTE_LINE)
        t0 = time.monotonic()
        moved += self._admit_from_queue(stolen_frac)
        self._mark(marks, "admission", t0)
        worked = False
        if self.engine.has_work():
            try:
                if self.chaos is not None:
                    self.chaos.maybe_poison_serve(self._active_uids())
                with get_tracer().span("serve/engine_step", cat="serve",
                                       tick=self._tick):
                    out = self.engine.step()
            except Exception as e:
                raise _EngineStepError(str(e)) from e
            self.metrics.on_step()
            # role-split engines time each prefill->decode KV handoff;
            # drain those stamps into the SLO histogram every tick (plain
            # float handover — no host sync, nothing when absent). Traced
            # requests also get a req/handoff span here: the engine knows
            # the uid, only the server knows the trace id.
            pop_handoff = getattr(self.engine, "pop_handoff_latencies", None)
            if pop_handoff is not None:
                for uid, lat_s in pop_handoff():
                    self.metrics.on_handoff_latency(lat_s)
                    with self._lock:
                        req = self._inflight.get(uid)
                    if req is not None and req.trace_id is not None:
                        get_tracer().complete(
                            "req/handoff", lat_s, cat="serve",
                            tid=request_tid(uid), trace_id=req.trace_id,
                            uid=uid)
            self._note_clean_step()
            worked = True
            t0 = time.monotonic()
            self._fan_out(out)
            self._mark(marks, "drain", t0)
        elif self._fault_episode:
            # an idle server is trivially clean: age the fault episode out
            # on empty ticks too, or a drained replica would advertise
            # "fault_episode" on /healthz forever (recovery must not
            # require traffic). The consecutive-fault streak is NOT reset
            # here — only a real clean step proves the engine healthy.
            with self._lock:
                idle = not self._queue and not self._inflight
            if idle:
                self._clean_steps += 1
                self._maybe_recover()
        t0 = time.monotonic()
        self._reap()
        self._mark(marks, "drain", t0)
        with self._lock:
            queued, inflight = len(self._queue), len(self._inflight)
            # the admission model's worst-case projection, re-derived at
            # tick time over everything still live (same sum submit()
            # admits against)
            projected_blocks = (sum(self._blocks_for(r) for r in self._queue)
                                + sum(self._blocks_for(r)
                                      for r in self._inflight.values()))
        self._reconcile_kv(projected_blocks)
        self._prefix_gauges()
        self._observe_ladder(queued, stolen_frac)
        self.metrics.set_gauges(queue_depth=queued, inflight=inflight,
                                kv_occupancy=self.engine.kv_occupancy())
        every = self.config.monitor_export_every
        if every and self.metrics.engine_steps % every == 0:
            try:
                self.metrics.export(self.monitor, self.metrics.engine_steps)
            except Exception:
                logger.exception("serve loop: monitor export failed")
        if worked or moved:
            # only ticks that did something land in the ring: an idle
            # server polling its queue must not flood the bounded trace
            self._emit_tick_spans(marks, t_tick0, worked, queued, inflight)
        return worked

    def _mark(self, marks: list, stage: str, t0: float, **args) -> None:
        """Record one tick-timeline segment ``(stage, t0, now, args)`` —
        pure host bookkeeping; the retro-spans are emitted in one batch by
        ``_emit_tick_spans`` at tick end (and only for working ticks)."""
        marks.append((stage, t0, time.monotonic(), args or None))

    def _emit_tick_spans(self, marks: list, t_tick0: float, worked: bool,
                         queued: int, inflight: int) -> None:
        """Emit the tick's stage timeline as dstrace retro-spans plus the
        ``serve/tick`` window span (the unit ``dstpu plan --serve``
        attributes: the stage ledger provably sums to this window), then
        fold the durations into the cumulative stage clocks."""
        stage_s = {s: 0.0 for s in _TICK_STAGES}
        timing = getattr(self.engine, "last_step_timing", None)
        if worked and timing:
            # the engine timed (and trace-spanned) its own step interior
            stage_s["prefill"] = timing.get("prefill_s", 0.0)
            stage_s["decode"] = timing.get("decode_s", 0.0)
        for stage, t0, t1, _args in marks:
            stage_s[stage] += t1 - t0
        t_end = time.monotonic()
        tracer = get_tracer()
        if tracer.enabled:
            for stage, t0, t1, args in marks:
                tracer.complete(_TICK_SPAN_NAMES[stage], t1 - t0,
                                cat="serve", end_ts=t1, tick=self._tick,
                                **(args or {}))
            tracer.complete("serve/tick", t_end - t_tick0, cat="serve",
                            end_ts=t_end, tick=self._tick, worked=worked,
                            queued=queued, inflight=inflight)
        self._tick_stage_gauges(stage_s, t_end - t_tick0, tracer)

    def _tick_stage_gauges(self, stage_s: dict, tick_s: float,
                           tracer) -> None:
        """Fold one tick's stage durations into the cumulative clocks and
        publish the tick-stage share gauges as ONE counter track
        (``serve/tick_stage_share``) — /metrics exposes it under the
        single ``dstpu_trace_counter`` TYPE block, Perfetto renders it as
        a stacked share series alongside the serve spans."""
        cum = self._tick_stage_cum
        for stage, dt in stage_s.items():
            cum[stage] += dt
        self._tick_cum_s += tick_s
        total = self._tick_cum_s
        if not tracer.enabled or total <= 0:
            return
        shares = {}
        attributed = 0.0
        for stage in _TICK_STAGES:
            attributed += cum[stage]
            shares[stage] = round(cum[stage] / total, 4)
        shares["residual"] = round(max(1.0 - attributed / total, 0.0), 4)
        tracer.counter("serve/tick_stage_share", cat="serve", **shares)

    def _active_uids(self) -> List[int]:
        """Engine-resident uids the next step will actually plan (demoted
        ones are paused)."""
        with self._lock:
            dem = set(self._demoted)
            return [u for u in self._inflight if u not in dem]

    # ------------------------------------------------------------------
    # host KV offload tier (policy in kv_tier.py; movement in the engine)
    # ------------------------------------------------------------------
    def _rebalance_kv_tiers(self, stolen_frac: float,
                            marks: Optional[list] = None) -> int:
        """Watermark-driven demotion (LIFO over admit order) and
        promotion-on-schedule (FIFO over demotion order). Bookkeeping is
        pure host arithmetic; the page copies happen
        inside the engine demote/promote calls this decides to issue —
        each timed onto the tick timeline (``marks``) so the serve plan
        can attribute demote/promote churn. Returns pages moved (demotions
        + promotions)."""
        cfg = self.config
        usable = max(self.engine.kv_usable_blocks(), 1)
        effective = effective_usable_blocks(usable, stolen_frac)
        watermark = cfg.kv_high_watermark * self._kv_watermark_scale
        capacity = watermark * effective
        demote_wm = (cfg.kv_demote_watermark_brownout
                     if self.ladder.level >= ServeLevel.BROWNOUT
                     else cfg.kv_demote_watermark)
        with self._lock:
            dem = set(self._demoted)
            snapshot = list(self._inflight.items())
        # demotion candidates: engine-resident, not already demoted, and
        # not done (a done sequence is reaped this tick — gathering its
        # pages would be a wasted copy that skews the demotion counters)
        active = []
        for u, r in snapshot:
            if u in dem:
                continue
            seq = self.engine.state.get(u)
            if seq is None or seq.done:
                continue
            active.append(r)
        worst = [self._blocks_for(r) for r in active]
        held = [self.engine.kv_held_blocks(r.uid) for r in active]
        reserved = self.engine.kv_reserved_blocks()
        # ---- prefix-cache eviction FIRST (the demotion-ordering
        # contract): unpinned cached blocks are capacity nobody reads —
        # reclaiming them costs no copies and pauses no request, so they
        # go before any sequence is demoted. Pinned shared prefixes are
        # untouchable here and therefore outlive every unshared page
        if self._prefix_capable and \
                self._trim_prefix_cache(reserved, demote_wm * effective):
            reserved = self.engine.kv_reserved_blocks()
        # ---- demotion (most recently admitted first), bounded by the
        # host budget: once the host tier is full, demotion stops and the
        # pressure has to SURFACE (ladder -> brownout/shed) instead of
        # silently overflowing host RAM
        plan = plan_demotions(worst, held, reserved, capacity,
                              demote_wm * effective,
                              cfg.min_active_requests)
        bb = self._block_bytes()
        demoted_now = 0
        promoted_now = 0
        executed = set()
        for i in plan:
            victim = active[i]
            if (self.engine.host_kv_bytes()
                    + self.engine.kv_held_blocks(victim.uid) * bb
                    > cfg.host_kv_budget_bytes):
                break
            t0 = time.monotonic()
            freed = self.engine.demote_kv(
                victim.uid, quantize=cfg.host_kv_quantize)
            if marks is not None:
                self._mark(marks, "demote", t0, uid=victim.uid, bytes=freed)
            with self._lock:
                self._demoted.append(victim.uid)
            executed.add(i)
            demoted_now += 1
            self.metrics.on_demote(freed)
            get_tracer().instant("serve/kv_demote", cat="serve",
                                 uid=victim.uid, bytes=freed,
                                 stolen_frac=round(stolen_frac, 3))
        active_worst_sum = 0
        for i, w in enumerate(worst):
            if i not in executed:
                active_worst_sum += w
        # ---- promotion (longest-demoted first; done sequences are
        # reaped this tick — restoring their pages would be a wasted
        # host->device copy that skews the promotion counters) ----
        with self._lock:
            demoted_pairs = [(u, self._inflight[u]) for u in self._demoted
                             if u in self._inflight]
        demoted_reqs = []
        for u, req in demoted_pairs:
            seq = self.engine.state.get(u)
            if seq is None or seq.done:
                continue
            demoted_reqs.append(req)
        if demoted_reqs:
            d_worst = [self._blocks_for(r) for r in demoted_reqs]
            d_held = [self.engine.demoted_blocks(r.uid)
                      for r in demoted_reqs]
            n_promote = plan_promotions(d_worst, d_held, active_worst_sum,
                                        capacity, self.engine.kv.free_blocks,
                                        self.engine.kv_reserved_blocks(),
                                        demote_wm * effective)
            for r in demoted_reqs[:n_promote]:
                t0 = time.monotonic()
                restored = self.engine.promote_kv(r.uid)
                if restored is None:
                    break
                if marks is not None:
                    self._mark(marks, "promote", t0, uid=r.uid,
                               bytes=restored)
                promoted_now += 1
                with self._lock:
                    if r.uid in self._demoted:
                        self._demoted.remove(r.uid)
                self.metrics.on_promote(restored)
                get_tracer().instant("serve/kv_promote", cat="serve",
                                     uid=r.uid, bytes=restored)
        if demoted_now or demoted_reqs:
            tracer = get_tracer()
            if tracer.enabled:
                # the dsmem counter-track idiom: tier state as a stacked
                # Perfetto counter time-aligned with the serve spans
                tracer.counter(
                    "serve/kv_tier", cat="mem",
                    device_reserved_blocks=self.engine.kv_reserved_blocks(),
                    host_bytes=self.engine.host_kv_bytes(),
                    demoted_requests=len(self._demoted))
        return demoted_now + promoted_now

    # ------------------------------------------------------------------
    # radix prefix cache (trie in inference/v2/prefix_cache.py; policy
    # planner in kv_tier.plan_prefix_evictions)
    # ------------------------------------------------------------------
    def _trim_prefix_cache(self, reserved: int, demote_line: float) -> int:
        """Reclaim unpinned cached prefix blocks per the pure planner:
        down to the demote line under pressure, down to the soft cap
        always. Returns blocks freed. The planner is host-int
        arithmetic; the engine call it decides to issue releases blocks
        (a deliberate off-path device op, same contract as demote)."""
        if not self._prefix_capable:
            return 0
        cache = self.engine.prefix_cache
        want = plan_prefix_evictions(cache.evictable_blocks(),
                                     cache.over_cap_blocks(),
                                     reserved, demote_line)
        if want <= 0:
            return 0
        freed = self.engine.evict_prefix_blocks(want)
        if freed:
            self.metrics.on_prefix_evict(freed)
            get_tracer().instant("serve/prefix_evict", cat="serve",
                                 blocks=freed)
        return freed

    def _cache_evictable_blocks(self) -> int:
        """Unpinned cached blocks (reclaimable on demand) — subtracted
        from observed reservation wherever occupancy means 'blocks live
        requests are using': a warm-but-idle cache is capacity, and
        counting it as pressure would brownout an idle server, while
        counting it as observed sequence occupancy would fire spurious
        kv_drift edges and recalibrate admission down on every warm
        cache (pinned pages DO count — live readers are using them)."""
        if not self._prefix_capable:
            return 0
        return self.engine.prefix_cache.evictable_blocks()

    def _prefix_gauges(self) -> None:
        """Fold the engine's prefix/prefill counters into the serving
        metrics each tick (pure host reads — the counters are plain
        ints the engine already maintains) and emit the dsmem-idiom
        counter track so cache occupancy lines up with the serve spans
        on the trace timeline."""
        stats_fn = getattr(self.engine, "prefix_stats", None)
        if stats_fn is None:
            return
        stats = stats_fn()
        resident = self.engine.resident_tokens()
        resident_bytes = self.engine.kv_resident_bytes()
        host = getattr(self.engine, "host_kv", None)
        self.metrics.set_prefix_gauges(
            stats, resident_tokens=resident, resident_bytes=resident_bytes,
            host_compression=(host.compression_ratio()
                              if host is not None else 1.0))
        if self._prefix_capable:
            tracer = get_tracer()
            if tracer.enabled:
                tracer.counter(
                    "serve/prefix_cache", cat="mem",
                    cached_blocks=int(stats.get("prefix_cached_blocks", 0)),
                    pinned_blocks=int(stats.get("prefix_pinned_blocks", 0)),
                    hit_tokens=int(stats.get("prefix_hit_tokens", 0)))

    # ------------------------------------------------------------------
    # degradation ladder
    # ------------------------------------------------------------------
    def _observe_ladder(self, queued: int, stolen_frac: float) -> None:
        """One pressure observation per tick. Pure host arithmetic; the
        ladder emits its own edge instants."""
        usable = max(self.engine.kv_usable_blocks(), 1)
        effective = effective_usable_blocks(usable, stolen_frac)
        reserved_fn = getattr(self.engine, "kv_reserved_blocks", None)
        if reserved_fn is not None:
            reserved = reserved_fn()
        else:
            reserved = int(self.engine.kv_occupancy() * usable)
        # a warm cache is reclaimable capacity, not pressure: without
        # this an idle server with an absorbed-history cache would sit
        # in brownout forever (evictable blocks free on demand)
        reserved = max(reserved - self._cache_evictable_blocks(), 0)
        host_bytes = (self.engine.host_kv_bytes()
                      if self._tier_capable else 0)
        pressure, reason = tier_pressure(
            reserved, effective, queued, self.config.max_queue_depth,
            host_bytes, self.config.host_kv_budget_bytes
            if self._tier_capable else 0)
        edge = self.ladder.observe(pressure, reason=reason)
        if edge is not None:
            self.metrics.on_ladder_transition(*edge)
        self.metrics.set_tier_gauges(int(self.ladder.level), host_bytes)

    def _latch_degraded(self, reason: str) -> None:
        """The sticky 503 — reserved for REAL engine faults (fatal
        classification, repeated unattributable step faults)."""
        get_tracer().instant("serve/degraded", cat="serve", reason=reason)
        with self._lock:
            self._degraded = reason
        edge = self.ladder.latch_degraded(reason)
        if edge is not None:
            # the ->DEGRADED edge counts like every other ladder edge, so
            # metrics.ladder_transitions ties out against ladder.transitions
            self.metrics.on_ladder_transition(*edge)
        self.metrics.on_degraded_latch()
        # a latched replica leaves rotation for good: dump the black box
        # BEFORE _fail_all clears the ledgers it records
        self.flight_dump(f"degraded: {reason}")

    # ------------------------------------------------------------------
    # flight recorder (the serving black box)
    # ------------------------------------------------------------------
    def _flight_on_kill(self, tick: int) -> None:
        """Pre-SIGKILL hook the chaos monkey calls synchronously — the
        only moment this process can still explain itself."""
        self.flight_dump(f"chaos_replica_kill@tick{tick}")

    def flight_dump(self, reason: str, min_interval_s: float = 0.0,
                    _locked: bool = False) -> Optional[str]:
        """Atomically dump this replica's black box: the trace ring (a
        Chrome dump) plus every live request's ledger under
        ``otherData.flight``. Write-then-rename into ``$DSTPU_FLIGHT_DIR``
        so a reader only ever sees complete dumps. No-op without the env
        var; ``min_interval_s`` throttles repeat triggers (shed storms);
        ``_locked`` means the caller already holds ``self._lock`` (the shed
        branch). Returns the dump path, or None when disabled/throttled/
        failed."""
        dirpath = os.environ.get(FLIGHT_DIR_ENV)
        if not dirpath:
            return None
        now = time.monotonic()
        if (min_interval_s > 0.0 and self._last_flight_dump is not None
                and now - self._last_flight_dump < min_interval_s):
            return None
        self._last_flight_dump = now
        tracer = get_tracer()
        tracer.instant("serve/flight_dump", cat="serve", reason=reason,
                       replica=self.replica_id, tick=self._tick)
        if _locked:
            inflight = [r.describe() for r in self._inflight.values()]
            queued = [r.describe() for r in self._queue]
        else:
            with self._lock:
                inflight = [r.describe() for r in self._inflight.values()]
                queued = [r.describe() for r in self._queue]
        doc = tracer.to_chrome()
        doc.setdefault("otherData", {})["flight"] = {
            "reason": reason,
            "replica_id": self.replica_id,
            "pid": os.getpid(),
            "tick": self._tick,
            "inflight": inflight,
            "queued": queued,
        }
        path = os.path.join(
            dirpath, f"flight_replica{self.replica_id}_{os.getpid()}.json")
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            logger.exception(f"serve: flight dump to {path} failed")
            return None
        logger.warning(f"serve: flight recorder dumped ({reason}) -> {path}")
        return path

    # ------------------------------------------------------------------
    # request-level fault isolation
    # ------------------------------------------------------------------
    def _note_clean_step(self) -> None:
        """A successful engine step: reset the fault window; after N clean
        steps a fault episode is declared over (health auto-recovery — the
        anti-sticky-503 half of the isolation story)."""
        self._consecutive_faults = 0
        if self._admitted_since_clean:
            self._admitted_since_clean.clear()
        if self._fault_episode:
            self._clean_steps += 1
            self._maybe_recover()

    def _maybe_recover(self) -> None:
        if self._clean_steps >= self.config.recover_clean_steps:
            with self._lock:
                self._fault_episode = False
            self._clean_steps = 0
            self.metrics.on_recovered()
            get_tracer().instant("serve/recovered", cat="serve",
                                 clean_steps=self.config.recover_clean_steps)

    def _on_step_fault(self, err: _EngineStepError) -> None:
        """Classify an engine-step exception through ``comm.guard``'s taxonomy
        (a CUDA allocation failure is TRANSIENT, a sticky CUDA error FATAL):
        FATAL latches the sticky degraded 503 (the only thing that
        should); TRANSIENT/TIMEOUT evicts a suspect request — retried with
        its KV recomputed, quarantined past its retry budget — so one bad
        request cannot take the replica down."""
        cause = err.__cause__ if err.__cause__ is not None else err
        outcome = classify_exception(cause)
        self.metrics.on_step_fault()
        self._consecutive_faults += 1
        self._clean_steps = 0
        with self._lock:
            self._fault_episode = True
        get_tracer().instant("serve/step_fault", cat="serve",
                             outcome=outcome.value,
                             consecutive=self._consecutive_faults,
                             error=repr(cause)[:200])
        if outcome is CommOutcome.FATAL:
            # the KV cache / sequence state may be inconsistent after a
            # fatal step failure: every engine-resident request is
            # compromised and the replica must stop advertising itself
            logger.exception("serve loop: FATAL engine step failure; "
                             "failing in-flight requests")
            self._latch_degraded(f"engine step failed: {cause}")
            self._fail_all("engine step raised (fatal)")
            return
        logger.warning(f"serve loop: transient engine step fault "
                       f"#{self._consecutive_faults}: {cause!r}")
        # the fixed fault budget only applies once isolation has run out
        # of suspects: while every fault still evicts someone, the suspect
        # pool strictly shrinks (evicted retries are held from
        # re-admission during the fault window), so blame WILL reach the
        # poison even when it was admitted first among many — latching on
        # a raw count mid-search would 503 the replica over one bad
        # request with a deep batch. The 4x backstop still bounds
        # pathological churn absolutely.
        suspect = self._pick_suspect()
        if suspect is None or self._consecutive_faults >= \
                4 * max(self.config.max_consecutive_step_faults, 1):
            if self._consecutive_faults >= \
                    self.config.max_consecutive_step_faults:
                # nothing left to evict (or the backstop tripped) and the
                # engine still faults — the engine itself is sick
                self._latch_degraded(
                    f"{self._consecutive_faults} consecutive engine step "
                    f"faults, last: {cause}")
                self._fail_all("engine step raised repeatedly")
            return
        self._evict_for_retry(suspect, cause)

    def _pick_suspect(self) -> Optional[Request]:
        """The most recently admitted ACTIVE request that has never
        survived a clean step — the request whose arrival correlates with
        the engine starting to fault. Falls back to the most recent active
        admission. Demoted (paused) requests are never suspects: they are
        not in the step plan, so they cannot have caused the fault —
        blaming one would quarantine an innocent while the real poison
        keeps faulting."""
        with self._lock:
            dem = set(self._demoted)
            for uid in reversed(self._admitted_since_clean):
                req = self._inflight.get(uid)
                if (req is not None and uid not in dem
                        and not req.state.terminal):
                    return req
            for uid in reversed(list(self._inflight)):
                req = self._inflight[uid]
                if uid not in dem and not req.state.terminal:
                    return req
        return None

    def _evict_for_retry(self, req: Request, cause: BaseException) -> None:
        """Remove a suspect from the engine. Within its retry budget it
        goes back to the queue for retry (its stream continues — the
        already-sent tokens become prompt, KV recomputed at re-admission);
        past the budget it is quarantined (FAILED, never retried)."""
        with self._lock:
            self._inflight.pop(req.uid, None)
            if req.uid in self._admitted_since_clean:
                self._admitted_since_clean.remove(req.uid)
            if req.uid in self._demoted:
                self._demoted.remove(req.uid)
        try:
            self.engine.finish(req.uid)
            # the reap may flush OTHER sequences already marked done this
            # tick (cancel/timeout/eos) — settle them, or their requests
            # leak in _inflight forever (drain would never converge)
            self._settle_reaped(self.engine.reap_finished())
        except Exception:
            logger.exception("serve loop: evicting suspect %s failed",
                             req.uid)
        req.fault_count += 1
        if req.fault_count > self.config.poison_retry_budget:
            get_tracer().instant("serve/quarantine", cat="serve",
                                 uid=req.uid, faults=req.fault_count)
            logger.error(f"serve loop: quarantining request {req.uid} "
                         f"after {req.fault_count} engine-step faults")
            req.finalize(RequestState.FAILED, "quarantined",
                         error=f"engine step fault x{req.fault_count}: "
                               f"{cause}")
            self.metrics.on_quarantine()
            self.metrics.on_finish(req)
            return
        recompute = len(req.prompt_tokens) + len(req.tokens)
        self.metrics.on_recompute(recompute)
        get_tracer().instant("serve/evicted", cat="serve", uid=req.uid,
                             faults=req.fault_count,
                             recompute_tokens=recompute)
        req.state = RequestState.QUEUED
        with self._lock:
            # BACK of the queue: co-evicted suspects rotate through
            # re-admission order, so blame cycles across the suspect set
            # instead of pinning the same (possibly innocent) request
            self._queue.append(req)
        self._wake.set()

    # ------------------------------------------------------------------
    # KV drift reconciliation (projected model vs engine reality)
    # ------------------------------------------------------------------
    def _reconcile_kv(self, projected_blocks: int) -> None:
        """Reconcile the projected KV watermark (admission control's model
        of memory) against what the engine actually reserved — so the
        model itself is observable: ``kv_projected_bytes`` vs
        ``kv_observed_bytes`` gauges on ``/metrics``, a ``serve/kv_bytes``
        counter track on the dstrace timeline, and an edge-triggered
        ``serve/kv_drift`` instant when they diverge >10%. A drift edge no
        longer passes silently: when the engine holds MORE than the model
        projected (the unsafe direction — leaked blocks, bookkeeping bug)
        the effective watermark is recalibrated down by the observed ratio
        (``serve/kv_recalibrate`` instant + counter) and restored to 1.0
        when the drift clears. The safe direction (projection worst-case >
        current reservation, expected mid-decode) recalibrates nothing.
        Pure host-int arithmetic — the serve tick stays sync-free."""
        block_bytes = getattr(self.engine, "kv_block_bytes", None)
        if block_bytes is None:
            return
        bb = block_bytes()
        projected = projected_blocks * bb
        # evictable cache blocks are attributable to NO live request:
        # counting them as observed occupancy would fire a kv_drift edge
        # (and recalibrate admission down) on every warm cache, masking
        # the real leaks this detector exists for. Pinned pages stay in:
        # live readers hold them and the projection covers those readers
        observed = (self.engine.kv_reserved_blocks()
                    - self._cache_evictable_blocks()) * bb
        self.metrics.set_kv_bytes(projected, observed)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.counter("serve/kv_bytes", cat="mem",
                           projected=projected, observed=observed)
        drifted = (max(projected, observed) > 0
                   and abs(projected - observed)
                   / max(projected, observed) > 0.10)
        if drifted and not self._kv_drifted:
            self.metrics.on_kv_drift()
            tracer.instant(
                "serve/kv_drift", cat="serve",
                projected_bytes=projected, observed_bytes=observed,
                drift_frac=round(abs(projected - observed)
                                 / max(projected, observed), 4))
        # recalibration tracks the ratio EVERY tick (the drift instant is
        # edge-triggered, the scale is not): a safe-direction episode that
        # flips unsafe mid-drift, or an unsafe one that worsens, must move
        # the watermark — only the >1% dead band keeps the instants from
        # firing every tick on ratio jitter
        if drifted and observed > projected:
            scale = max(projected / observed, 0.5)
        else:
            scale = 1.0
        if abs(scale - self._kv_watermark_scale) > 0.01:
            with self._lock:
                self._kv_watermark_scale = scale
            self.metrics.on_kv_recalibrate()
            tracer.instant("serve/kv_recalibrate", cat="serve",
                           watermark_scale=round(scale, 4),
                           direction=("observed_over_projected"
                                      if scale < 1.0 else "drift_cleared"))
        self._kv_drifted = drifted

    def _admit_from_queue(self, stolen_frac: float = 0.0) -> int:
        """FIFO admission while the engine has room for the request's FULL
        worst case (prompt + max_new_tokens) AND the active worst-case sum
        stays under the (possibly pressure-shrunk) capacity line — the
        dynamic form of the no-mid-decode-exhaustion invariant once the
        offload tier lets accepted work exceed device capacity. Brownout
        pauses low-priority admits (they wait in the queue, never silently
        dropped). Returns the number of requests admitted this tick."""
        admitted = 0
        brownout = self.ladder.level >= ServeLevel.BROWNOUT
        if self._tier_capable:
            # computed once, incremented per admission (the sum changes by
            # exactly the admitted request's worst case) — rescanning the
            # whole inflight table per admitted request would make a deep
            # queue drain O(queue x inflight) on the serve-loop thread
            usable = max(self.engine.kv_usable_blocks(), 1)
            effective = effective_usable_blocks(usable, stolen_frac)
            capacity = (self.config.kv_high_watermark
                        * self._kv_watermark_scale * effective)
            active_worst = self._active_worstcase()
        while True:
            # hold evicted retries while the fault window is open AND the
            # engine still has other work: re-admitting a retry into a
            # faulting batch makes it the "most recent admission" again and
            # blame-attribution would keep landing on it. When nothing
            # else can run, the retry IS admitted — alone, which is
            # exactly the isolation that disambiguates poison from victim
            hold_retries = (self._consecutive_faults > 0
                            and self.engine.has_work())
            with self._lock:
                req = None
                for cand in self._queue:
                    if brownout and cand.priority < 0:
                        continue
                    if cand.fault_count > 0 and hold_retries:
                        continue
                    req = cand
                    break
                if req is None:
                    return admitted
            need_blocks = self._blocks_for(req)
            if self._tier_capable and active_worst + need_blocks > capacity:
                return admitted
            need = len(req.prompt_tokens) + req.max_new_tokens
            if not self.engine.can_schedule([req.uid], [need]):
                return admitted
            with self._lock:
                self._queue.remove(req)
                self._inflight[req.uid] = req
                self._admitted_since_clean.append(req.uid)
            try:
                self.engine.admit(req.uid, req.engine_prompt())
            except Exception as e:
                # fail THIS request, not the batch (e.g. prompt longer than
                # the engine's max context)
                with self._lock:
                    self._inflight.pop(req.uid, None)
                    if req.uid in self._admitted_since_clean:
                        self._admitted_since_clean.remove(req.uid)
                req.finalize(RequestState.FAILED, "error", error=repr(e))
                self.metrics.on_finish(req)
                continue
            if req.admit_ts is None:
                # first admission only: re-admissions after eviction keep
                # the original queue-wait/TTFT edges
                req.admit_ts = time.monotonic()
            req.state = RequestState.PREFILL
            admitted += 1
            if self._tier_capable:
                active_worst += need_blocks

    def _active_worstcase(self) -> int:
        """Worst-case-at-completion block sum of ACTIVE (non-demoted)
        engine-resident requests — the left side of the dynamic admission
        invariant."""
        with self._lock:
            dem = set(self._demoted)
            total = 0
            for uid, r in self._inflight.items():
                if uid not in dem:
                    total += self._blocks_for(r)
            return total

    def _fan_out(self, step_out: Dict[int, int]):
        now = time.monotonic()
        n = 0
        ledger = getattr(self.engine, "sched_ledger", None)
        for uid, tok in step_out.items():
            req = self._inflight.get(uid)
            if req is None or req.state.terminal:
                continue
            req.state = RequestState.DECODE
            req.push_token(int(tok), now=now)
            if ledger is not None:
                # book this tick's decode work against the request — the
                # wall-clock-free per-request denominator (TickLedger
                # request attribution; settled into describe() at reap)
                ledger.attribute_request(uid, decode_tokens=1)
            n += 1
            seq = self.engine.state.get(uid)
            if seq is not None and seq.done:
                req.finalize(RequestState.FINISHED, "eos")
            elif len(req.tokens) >= req.max_new_tokens:
                req.finalize(RequestState.FINISHED, "length")
                self.engine.finish(uid)
        if n:
            self.metrics.on_tokens(n)

    def _expire_and_cancel(self):
        now = time.monotonic()
        with self._lock:
            queued = list(self._queue)
            inflight = list(self._inflight.values())
        for req in queued:
            if req.cancelled_requested or req.expired:
                with self._lock:
                    if req in self._queue:
                        self._queue.remove(req)
                self._finalize_expired(req, now)
                # never reached the engine: settle metrics here (engine-
                # resident requests settle in _reap)
                self.metrics.on_finish(req)
        for req in inflight:
            if req.cancelled_requested or req.expired:
                self._finalize_expired(req, now)
                self.engine.finish(req.uid)

    def _finalize_expired(self, req: Request, now: float):
        if req.cancelled_requested:
            req.finalize(RequestState.CANCELLED, "cancelled")
        else:
            req.finalize(RequestState.TIMED_OUT, "timeout")

    def _reap(self):
        """Release engine state (KV blocks in EITHER tier, sequence slots)
        for every done sequence and settle the owning requests."""
        self._settle_reaped(self.engine.reap_finished())

    def _settle_reaped(self, reaped) -> None:
        """Settle the owning requests of reaped uids — shared by the tick
        reap AND the fault-eviction path (whose reap_finished() may flush
        OTHER done sequences too; dropping those uids would leak their
        requests in ``_inflight`` forever)."""
        ledger = getattr(self.engine, "sched_ledger", None)
        for uid in reaped:
            with self._lock:
                req = self._inflight.pop(uid, None)
                if uid in self._demoted:
                    self._demoted.remove(uid)
                if uid in self._admitted_since_clean:
                    self._admitted_since_clean.remove(uid)
            if req is None:
                if ledger is not None:
                    ledger.pop_request(uid)
                continue
            if ledger is not None:
                # settle the request's tick attribution (also bounds the
                # ledger table: finished uids never linger there)
                req.sched_attribution = ledger.pop_request(uid)
            if not req.state.terminal:
                # engine marked it done (eos) but no token crossed this step
                req.finalize(RequestState.FINISHED, "eos")
            self.metrics.on_finish(req)

    def _fail_all(self, why: str):
        with self._lock:
            victims = list(self._queue) + list(self._inflight.values())
            self._queue.clear()
            inflight = list(self._inflight)
            self._inflight.clear()
            self._demoted.clear()
            self._admitted_since_clean.clear()
        for req in victims:
            req.finalize(RequestState.FAILED, "error", error=why)
            self.metrics.on_finish(req)
        for uid in inflight:
            try:
                self.engine.finish(uid)
            except Exception:
                pass
        try:
            self.engine.reap_finished()
        except Exception:
            logger.exception("serve loop: reap after failure also failed")
