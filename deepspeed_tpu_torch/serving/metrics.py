"""Serving observability: per-request latency stats, rolling throughput,
KV-occupancy gauges (port of ``deepspeed_tpu/serving/metrics.py``).

Two export paths: ``events()`` emits ``(tag, value, step)`` tuples for a
``deepspeed_tpu_torch.monitor`` backend (``CSVMonitor``), and
``prometheus_text()`` renders a Prometheus text-format dump for the
front-end's ``/metrics`` endpoint.
"""

import collections
import threading
from typing import Dict, List

from deepspeed_tpu_torch.monitor import Event
from deepspeed_tpu_torch.telemetry import hist as dshist
from deepspeed_tpu_torch.telemetry.tracer import get_tracer
from deepspeed_tpu_torch.utils.timer import RateTracker

# bounded sample reservoirs: serving runs indefinitely, metric memory must not
_SAMPLE_WINDOW = 1024

#: the SLO histogram families this module exports on /metrics, as
#: ``(family, attr, help)`` — one fixed-log-bucket histogram each
#: (``telemetry.hist``), fed from monotonic-stamp differences only.
#: bench_serve's proof set and env_report's inventory both derive from
#: THIS tuple, so a new family can never reach /metrics unlisted.
REQ_HIST_FAMILIES = (
    ("dstpu_req_ttft_seconds", "hist_ttft",
     "time to first token (from arrival, includes queue wait)"),
    ("dstpu_req_tpot_seconds", "hist_tpot",
     "time per output token (decode phase)"),
    ("dstpu_req_queue_wait_seconds", "hist_queue_wait",
     "admission queue wait"),
    ("dstpu_req_handoff_seconds", "hist_handoff",
     "prefill->decode KV handoff latency (role-split engines)"),
)


class _LatencyStat:
    """Bounded-window latency aggregate (mean / p50 / p99 / max + lifetime
    count and sum — the count/sum pair is what Prometheus summaries carry)."""

    def __init__(self, window: int = _SAMPLE_WINDOW):
        self.samples = collections.deque(maxlen=window)
        self.count = 0
        self.sum = 0.0

    def add(self, v: float):
        self.samples.append(v)
        self.count += 1
        self.sum += v

    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        i = min(int(q * len(s)), len(s) - 1)
        return s[i]

    def max(self) -> float:
        return max(self.samples) if self.samples else 0.0


class ServingMetrics:
    """All counters/gauges the serve loop maintains. Thread-safe: the serve
    loop writes, front-end threads read."""

    def __init__(self, rate_window_s: float = 30.0):
        self._lock = threading.Lock()
        # counters
        self.requests_submitted = 0
        self.requests_rejected = 0       # backpressure at submit()
        self.requests_shed = 0           # rejected BY THE LADDER (SHED)
        self.requests_completed = 0      # finished (length / eos)
        self.requests_cancelled = 0
        self.requests_timed_out = 0
        self.requests_failed = 0
        self.requests_quarantined = 0    # poison requests past retry budget
        self.tokens_generated = 0
        self.engine_steps = 0
        # request-level fault isolation (non-fatal engine-step failures)
        self.engine_step_faults = 0
        self.fault_recoveries = 0        # clean-tick recovery episodes
        self.recomputed_tokens = 0       # KV rebuilt for evicted retries
        self.degraded_latches = 0        # sticky-503 latches (fatal only)
        # host KV offload tier
        self.kv_demotions = 0
        self.kv_promotions = 0
        self.kv_demoted_bytes = 0
        self.kv_promoted_bytes = 0
        self.host_kv_bytes = 0           # gauge
        # radix prefix cache (counters mirrored from the engine's
        # prefix_stats each tick — the engine owns the source of truth,
        # these are the thread-safe read surface for /metrics)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0        # blocks reclaimed by the tick
        self.prefill_tokens_total = 0
        self.prefill_tokens_saved = 0
        self.prefill_tokens_computed = 0
        self.prefix_cache_hit_ratio = 0.0   # gauge (hit/lookup tokens)
        self.prefix_cached_blocks = 0       # gauge
        self.prefix_pinned_blocks = 0       # gauge
        # quantized host tier / capacity efficiency
        self.host_kv_compression_ratio = 1.0   # gauge (raw/stored)
        self.bytes_per_resident_token = 0.0    # gauge (both tiers)
        # degradation ladder
        self.ladder_level = 0            # gauge (ServeLevel int)
        self.ladder_transitions = 0
        self.brownout_entries = 0
        self.shed_entries = 0
        # projected-KV watermark recalibration (kv_drift satellite)
        self.kv_recalibrations = 0
        # latency distributions (seconds)
        self.ttft = _LatencyStat()
        self.tpot = _LatencyStat()
        self.queue_wait = _LatencyStat()
        # SLO histograms (deterministic fixed log buckets; lifetime, not
        # windowed — delta_from two slo_snapshot()s for a measured run)
        self.hist_ttft = dshist.LogHistogram()
        self.hist_tpot = dshist.LogHistogram()
        self.hist_queue_wait = dshist.LogHistogram()
        self.hist_handoff = dshist.LogHistogram()
        # gauges (set each serve-loop tick)
        self.queue_depth = 0
        self.inflight = 0
        self.kv_occupancy = 0.0
        self.kv_occupancy_peak = 0.0
        # projected-vs-observed KV reconciliation (dsmem satellite):
        # projected = admission control's worst-case byte sum, observed =
        # blocks the engine actually reserved; drift events count the
        # >10% divergence EDGES (episodes, not ticks)
        self.kv_projected_bytes = 0
        self.kv_observed_bytes = 0
        self.kv_drift_events = 0
        # rolling throughput
        self.token_rate = RateTracker(window_s=rate_window_s)
        self.request_rate = RateTracker(window_s=rate_window_s)

    # ---- serve-loop write API --------------------------------------------
    def on_submit(self):
        with self._lock:
            self.requests_submitted += 1

    def on_reject(self):
        with self._lock:
            self.requests_rejected += 1

    def on_tokens(self, n: int):
        with self._lock:
            self.tokens_generated += n
        self.token_rate.add(n)

    def on_step(self):
        with self._lock:
            self.engine_steps += 1

    def on_finish(self, req):
        """Fold a terminal request's latency samples in (any terminal state)."""
        from deepspeed_tpu_torch.serving.request import RequestState
        with self._lock:
            if req.state == RequestState.FINISHED:
                self.requests_completed += 1
            elif req.state == RequestState.CANCELLED:
                self.requests_cancelled += 1
            elif req.state == RequestState.TIMED_OUT:
                self.requests_timed_out += 1
            else:
                self.requests_failed += 1
            if req.queue_wait_s is not None:
                self.queue_wait.add(req.queue_wait_s)
                self.hist_queue_wait.observe(req.queue_wait_s)
            if req.ttft_s is not None:
                self.ttft.add(req.ttft_s)
                self.hist_ttft.observe(req.ttft_s)
            if req.tpot_s is not None:
                self.tpot.add(req.tpot_s)
                self.hist_tpot.observe(req.tpot_s)
        self.request_rate.add(1)

    def on_handoff_latency(self, lat_s: float):
        """Fold one completed prefill->decode KV handoff's latency in
        (role-split engines; the serve loop drains these each tick)."""
        with self._lock:
            self.hist_handoff.observe(lat_s)

    def set_gauges(self, queue_depth: int, inflight: int, kv_occupancy: float):
        with self._lock:
            self.queue_depth = queue_depth
            self.inflight = inflight
            self.kv_occupancy = kv_occupancy
            self.kv_occupancy_peak = max(self.kv_occupancy_peak, kv_occupancy)

    def set_kv_bytes(self, projected: int, observed: int):
        with self._lock:
            self.kv_projected_bytes = int(projected)
            self.kv_observed_bytes = int(observed)

    def on_kv_drift(self):
        with self._lock:
            self.kv_drift_events += 1

    def on_kv_recalibrate(self):
        with self._lock:
            self.kv_recalibrations += 1

    def on_shed(self):
        with self._lock:
            self.requests_rejected += 1
            self.requests_shed += 1

    def on_quarantine(self):
        with self._lock:
            self.requests_quarantined += 1

    def on_step_fault(self):
        with self._lock:
            self.engine_step_faults += 1

    def on_recovered(self):
        with self._lock:
            self.fault_recoveries += 1

    def on_recompute(self, tokens: int):
        with self._lock:
            self.recomputed_tokens += tokens

    def on_degraded_latch(self):
        with self._lock:
            self.degraded_latches += 1

    def on_prefix_evict(self, blocks: int):
        with self._lock:
            self.prefix_evictions += blocks

    def set_prefix_gauges(self, stats: dict, resident_tokens: int,
                          resident_bytes: int, host_compression: float):
        """Mirror the engine's prefix/prefill counters (one tick's
        consistent view) and derive bytes-per-resident-token — the
        capacity-efficiency headline the quantized host tier moves."""
        with self._lock:
            self.prefill_tokens_total = int(
                stats.get("prefill_tokens_total", 0))
            self.prefill_tokens_saved = int(
                stats.get("prefill_tokens_saved", 0))
            self.prefill_tokens_computed = int(
                stats.get("prefill_tokens_computed", 0))
            self.prefix_hits = int(stats.get("prefix_hits", 0))
            self.prefix_misses = int(stats.get("prefix_misses", 0))
            self.prefix_cache_hit_ratio = float(
                stats.get("prefix_hit_ratio", 0.0))
            self.prefix_cached_blocks = int(
                stats.get("prefix_cached_blocks", 0))
            self.prefix_pinned_blocks = int(
                stats.get("prefix_pinned_blocks", 0))
            self.host_kv_compression_ratio = float(host_compression)
            self.bytes_per_resident_token = (
                resident_bytes / resident_tokens if resident_tokens else 0.0)

    def on_demote(self, nbytes: int):
        with self._lock:
            self.kv_demotions += 1
            self.kv_demoted_bytes += nbytes

    def on_promote(self, nbytes: int):
        with self._lock:
            self.kv_promotions += 1
            self.kv_promoted_bytes += nbytes

    def on_ladder_transition(self, frm, to):
        """Fold a ladder edge in; ``to`` is a ``ServeLevel``."""
        with self._lock:
            self.ladder_transitions += 1
            if to.name == "BROWNOUT":
                self.brownout_entries += 1
            elif to.name == "SHED":
                self.shed_entries += 1

    def set_tier_gauges(self, ladder_level: int, host_kv_bytes: int):
        with self._lock:
            self.ladder_level = int(ladder_level)
            self.host_kv_bytes = int(host_kv_bytes)

    # ---- export -----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests_submitted": self.requests_submitted,
                "requests_rejected": self.requests_rejected,
                "requests_shed": self.requests_shed,
                "requests_completed": self.requests_completed,
                "requests_cancelled": self.requests_cancelled,
                "requests_timed_out": self.requests_timed_out,
                "requests_failed": self.requests_failed,
                "requests_quarantined": self.requests_quarantined,
                "tokens_generated": self.tokens_generated,
                "engine_steps": self.engine_steps,
                "engine_step_faults": self.engine_step_faults,
                "fault_recoveries": self.fault_recoveries,
                "recomputed_tokens": self.recomputed_tokens,
                "degraded_latches": self.degraded_latches,
                "kv_demotions": self.kv_demotions,
                "kv_promotions": self.kv_promotions,
                "kv_demoted_bytes": self.kv_demoted_bytes,
                "kv_promoted_bytes": self.kv_promoted_bytes,
                "host_kv_bytes": self.host_kv_bytes,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_evictions": self.prefix_evictions,
                "prefill_tokens_total": self.prefill_tokens_total,
                "prefill_tokens_saved": self.prefill_tokens_saved,
                "prefill_tokens_computed": self.prefill_tokens_computed,
                "prefix_cache_hit_ratio": self.prefix_cache_hit_ratio,
                "prefix_cached_blocks": self.prefix_cached_blocks,
                "prefix_pinned_blocks": self.prefix_pinned_blocks,
                "host_kv_compression_ratio": self.host_kv_compression_ratio,
                "bytes_per_resident_token": self.bytes_per_resident_token,
                "ladder_level": self.ladder_level,
                "ladder_transitions": self.ladder_transitions,
                "brownout_entries": self.brownout_entries,
                "shed_entries": self.shed_entries,
                "kv_recalibrations": self.kv_recalibrations,
                "queue_depth": self.queue_depth,
                "inflight": self.inflight,
                "kv_occupancy": self.kv_occupancy,
                "kv_occupancy_peak": self.kv_occupancy_peak,
                "kv_projected_bytes": self.kv_projected_bytes,
                "kv_observed_bytes": self.kv_observed_bytes,
                "kv_drift_events": self.kv_drift_events,
                "ttft_mean_s": self.ttft.mean(),
                "ttft_p50_s": self.ttft.quantile(0.5),
                "ttft_p99_s": self.ttft.quantile(0.99),
                "tpot_mean_s": self.tpot.mean(),
                "tpot_p50_s": self.tpot.quantile(0.5),
                "queue_wait_mean_s": self.queue_wait.mean(),
                "queue_wait_max_s": self.queue_wait.max(),
                "tokens_per_sec": self.token_rate.rate(),
                "requests_per_sec": self.request_rate.rate(),
            }

    def slo_snapshot(self) -> Dict[str, dict]:
        """One consistent snapshot of every SLO histogram, keyed by its
        /metrics family name — the bench_serve proof set. Diff two of
        these (``LogHistogram.from_snapshot`` + ``delta_from``) for the
        warmed-run window."""
        with self._lock:
            return {family: getattr(self, attr).snapshot()
                    for family, attr, _help in REQ_HIST_FAMILIES}

    def events(self, step: int) -> List[Event]:
        """(tag, value, step) tuples for ``MonitorMaster.write_events``."""
        return [(f"serving/{k}", float(v), step)
                for k, v in self.snapshot().items()]

    def export(self, monitor, step: int):
        """Fan the current snapshot out through a ``deepspeed_tpu_torch.monitor``
        backend (anything with ``write_events``)."""
        if monitor is not None and getattr(monitor, "enabled", False):
            monitor.write_events(self.events(step))

    def prometheus_text(self) -> str:
        """Prometheus text exposition (counters + gauges + summary stats)."""
        snap = self.snapshot()
        counters = {"requests_submitted", "requests_rejected",
                    "requests_shed", "requests_completed",
                    "requests_cancelled", "requests_timed_out",
                    "requests_failed", "requests_quarantined",
                    "tokens_generated", "engine_steps", "kv_drift_events",
                    "engine_step_faults", "fault_recoveries",
                    "recomputed_tokens", "degraded_latches",
                    "kv_demotions", "kv_promotions", "kv_demoted_bytes",
                    "kv_promoted_bytes", "ladder_transitions",
                    "brownout_entries", "shed_entries",
                    "kv_recalibrations", "prefix_hits", "prefix_misses",
                    "prefix_evictions", "prefill_tokens_total",
                    "prefill_tokens_saved", "prefill_tokens_computed"}
        lines = []
        with self._lock:
            summaries = [
                ("ttft_seconds", "time to first token (from arrival)",
                 self.ttft),
                ("tpot_seconds", "time per output token (decode phase)",
                 self.tpot),
                ("queue_wait_seconds", "admission queue wait", self.queue_wait),
            ]
            for name, help_text, stat in summaries:
                full = f"dstpu_serving_{name}"
                lines.append(f"# HELP {full} {help_text}")
                lines.append(f"# TYPE dstpu_serving_{name} summary")
                for q in (0.5, 0.9, 0.99):
                    lines.append(f'{full}{{quantile="{q}"}} '
                                 f"{stat.quantile(q):.9g}")
                lines.append(f"{full}_sum {stat.sum:.9g}")
                lines.append(f"{full}_count {stat.count}")
            # SLO histograms: the dstpu_req_* namespace, one
            # block per family (fixed log buckets -> per-replica pages
            # merge counterwise into fleet-wide distributions)
            for family, attr, help_text in REQ_HIST_FAMILIES:
                lines.extend(dshist.prometheus_histogram_lines(
                    family, getattr(self, attr), help_text=help_text))
        # every snapshot key renders except the latency aggregates (the
        # *_s keys), which are exposed as proper summaries above — derived
        # from the snapshot itself so a new counter/gauge can never be in
        # one list but not the other
        for key, val in snap.items():
            if key.endswith("_s"):
                continue
            full = f"dstpu_serving_{key}"
            kind = "counter" if key in counters else "gauge"
            lines.append(f"# TYPE dstpu_serving_{key} {kind}")
            lines.append(f"{full} {val:.9g}")
        # tracer-backed span summaries (request phase latencies straight
        # from the dstrace ring: serve/queued, serve/prefill, serve/decode)
        tracer = get_tracer()
        if tracer.enabled:
            # ONE call covering both families (serve spans + dsmem memory
            # tracks): two calls would emit the HELP/TYPE metadata block
            # twice, which the Prometheus text parser rejects wholesale
            lines.extend(tracer.prometheus_lines(prefix=("serve/", "mem/")))
        return "\n".join(lines) + "\n"
