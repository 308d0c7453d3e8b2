"""dstrace — structured span tracing (copy of
``deepspeed_tpu/telemetry/tracer.py``).

One host-clock event stream for the serving and training paths: a bounded
ring of span / instant / counter events with monotonic ids and request
correlation keys, exported as Chrome-trace JSON (Perfetto-loadable), as
per-name summaries and as Prometheus lines for ``/metrics``.

- **Never a device sync.** Emission reads ``time.monotonic()`` and appends
  a tuple: no tensor is touched, nothing waits for the card.
- **Lock-free emit.** ``deque.append`` and ``itertools.count.__next__`` are
  GIL-atomic; the only lock guards export and reconfiguration, so the serve
  loop, the HTTP handler threads and the main thread never contend.
- **Bounded memory.** The ring holds ``capacity`` events (oldest evicted).

Activation: ``configure_tracing(enabled=True)``, or ``DSTPU_TRACE=path``
in the environment — tracing starts at first use and the trace is dumped to
``path`` at interpreter exit.
"""

import atexit
import collections
import itertools
import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.utils.logging import logger

TRACE_ENV = "DSTPU_TRACE"
TRACE_CAPACITY_ENV = "DSTPU_TRACE_CAPACITY"
DEFAULT_CAPACITY = 65536

#: synthetic tid range for per-request serving tracks — renders one Perfetto
#: track per request uid. Real thread idents are pointer-sized (far above
#: this window), so [BASE, BASE + SPAN) never collides with a live thread.
REQUEST_TID_BASE = 1_000_000
REQUEST_TID_SPAN = 10_000_000


def request_tid(uid: int) -> int:
    """Synthetic per-request track id (stable for a given uid)."""
    return REQUEST_TID_BASE + (int(uid) % REQUEST_TID_SPAN)

# event tuple layout: (eid, name, cat, ph, ts_s, dur_s, tid, args_or_None)
_EID, _NAME, _CAT, _PH, _TS, _DUR, _TID, _ARGS = range(8)


def _quantile(sorted_vals, q: float) -> float:
    """Exact sample quantile over pre-sorted values — the rule the serving
    metrics (``_LatencyStat.quantile``) and ``bench_serve`` share: the
    value at index ``min(int(q*n), n-1)``."""
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(int(q * len(sorted_vals)), len(sorted_vals) - 1)]


class _NoopSpan:
    """Shared do-nothing context — THE fast path when tracing is off (one
    attribute read + one identity return per ``span()`` call)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """A live span: enter stamps t0, exit appends one complete ("X") event.
    Nesting falls out of Chrome-trace semantics — same-thread spans nest by
    ts/dur containment, which the with-statement guarantees."""
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        t0 = self._t0
        self._tracer._emit(self._name, self._cat, "X", t0,
                           time.monotonic() - t0,
                           threading.get_ident(), self._args)
        return False


class Tracer:
    """Thread-safe bounded span tracer with Chrome-trace export."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self._events: collections.deque = collections.deque(
            maxlen=max(int(capacity), 16))
        self._ids = itertools.count(1)        # monotonic event ids
        self._epoch = time.monotonic()        # export ts origin
        self._lock = threading.Lock()         # export/config only, never emit
        self._cleared = 0                     # events discarded by clear()

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def configure(self, enabled: Optional[bool] = None) -> "Tracer":
        """Turn emission on or off. The ring's capacity is fixed at
        construction (``DSTPU_TRACE_CAPACITY``): nothing resizes a ring
        that other threads emit into."""
        if enabled is not None:
            with self._lock:
                self.enabled = bool(enabled)
        return self

    @property
    def capacity(self) -> int:
        return self._events.maxlen

    def process_identity(self) -> Dict[str, Any]:
        """The dump header: who emitted this trace and a FRESH monotonic↔
        wall anchor pair (same instant, both clocks) so a merger can place
        this dump's monotonic timeline on the shared wall clock. Stamped at
        dump time — anchors age badly; a dump-time pair bounds NTP drift to
        the run's tail, not its whole life."""
        return {
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            # one anchor pair, read back-to-back: wall_s - monotonic_s maps
            # any event ts (epoch-relative monotonic) onto the wall clock
            "monotonic_s": time.monotonic(),
            "wall_s": time.time(),
            "epoch_monotonic_s": self._epoch,
        }

    def clear(self) -> None:
        with self._lock:
            # cleared events are not ring evictions: account for them so
            # dropped() stays exact across clear()
            self._cleared += len(self._events)
            self._events.clear()

    # ------------------------------------------------------------------
    # emission (must never wait for the device)
    # ------------------------------------------------------------------
    def _emit(self, name, cat, ph, ts, dur, tid, args) -> None:
        self._events.append(
            (next(self._ids), name, cat, ph, ts, dur, tid, args))

    def span(self, name: str, cat: str = "host", **args):
        """``with tracer.span("engine/dispatch", step=n): ...`` — a complete
        event on the current thread. Returns a shared no-op context when
        tracing is off (the fast path every instrumented call site relies
        on)."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "event",
                step: Optional[int] = None, tid: Optional[int] = None,
                **args) -> None:
        """A zero-duration marker (a ladder edge, a chaos injection, a
        step fault). ``step`` is the correlation key; ``tid`` overrides the
        track (per-request serving tracks). One append: no I/O, no lock."""
        if not self.enabled:
            return
        if step is not None:
            args["step"] = step
        self._emit(name, cat, "i", time.monotonic(), 0.0,
                   tid if tid is not None else threading.get_ident(),
                   args or None)

    def counter(self, name: str, cat: str = "mem",
                tid: Optional[int] = None, **series) -> None:
        """A Chrome-trace counter sample (``"ph":"C"``): ``series`` maps
        series label -> numeric value, rendered by Perfetto as a stacked
        counter track time-aligned with the spans (the dsmem HBM/RSS/KV
        watermark tracks). Same hot-path contract as ``instant``: one
        append, no locks, no I/O, no device touch."""
        if not self.enabled or not series:
            return
        self._emit(name, cat, "C", time.monotonic(), 0.0,
                   tid if tid is not None else threading.get_ident(),
                   series)

    def complete(self, name: str, dur_s: float, cat: str = "host",
                 end_ts: Optional[float] = None, tid: Optional[int] = None,
                 **args) -> None:
        """Record a span retroactively from a measured duration (the async
        drain's reconciled step window, serving request phases rebuilt from
        lifecycle timestamps). ``end_ts`` is on the tracer clock
        (``time.monotonic``); defaults to now. ``tid`` overrides the track
        (per-request serving tracks use ``REQUEST_TID_BASE + uid``)."""
        if not self.enabled:
            return
        if dur_s < 0.0:
            dur_s = 0.0
        end = time.monotonic() if end_ts is None else end_ts
        self._emit(name, cat, "X", end - dur_s, dur_s,
                   tid if tid is not None else threading.get_ident(),
                   args or None)

    # ------------------------------------------------------------------
    # read side
    # ------------------------------------------------------------------
    def events_snapshot(self) -> List[Tuple]:
        with self._lock:
            return list(self._events)

    def tail(self, seconds: float) -> List[Tuple]:
        """Events whose END falls inside the last ``seconds`` — the slice
        resilience diagnostic bundles embed ("what happened in the 30s
        before the guard quarantined")."""
        cutoff = time.monotonic() - max(float(seconds), 0.0)
        return [e for e in self.events_snapshot()
                if (e[_TS] + e[_DUR]) >= cutoff]

    def dropped(self) -> int:
        """Events evicted from the ring so far (monotonic ids make the count
        exact: last id minus retained length minus clear()ed events)."""
        snap = self.events_snapshot()
        if not snap:
            return 0
        last = max(e[_EID] for e in snap)
        return max(0, last - len(snap) - self._cleared)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def to_chrome(self, events: Optional[List[Tuple]] = None) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON object format. Span events are "X"
        (complete) with microsecond ts/dur relative to the tracer epoch;
        instants are "i"; thread-name metadata rides along so Perfetto
        tracks are labeled."""
        if events is None:
            events = self.events_snapshot()
        pid = os.getpid()
        thread_names = {t.ident: t.name for t in threading.enumerate()}
        trace_events: List[Dict[str, Any]] = []
        seen_tids: Dict[int, str] = {}
        for eid, name, cat, ph, ts, dur, tid, args in events:
            tid = int(tid)
            if tid not in seen_tids:
                if tid in thread_names:
                    seen_tids[tid] = thread_names[tid]
                elif REQUEST_TID_BASE <= tid < REQUEST_TID_BASE + \
                        REQUEST_TID_SPAN:
                    seen_tids[tid] = f"request-{tid - REQUEST_TID_BASE}"
                else:
                    seen_tids[tid] = f"thread-{tid}"   # exited thread
            ev: Dict[str, Any] = {
                "name": name, "cat": cat, "ph": ph, "pid": pid, "tid": tid,
                "ts": round((ts - self._epoch) * 1e6, 3),
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            elif ph == "i":
                ev["s"] = "t"          # thread-scoped instant
            if ph == "C":
                # counter events: args ARE the series values (adding the
                # event id would draw a bogus monotonically-rising series)
                ev["args"] = dict(args) if args else {}
            else:
                ev["args"] = dict(args, id=eid) if args else {"id": eid}
            trace_events.append(ev)
        identity = self.process_identity()
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": "deepspeed_tpu_torch"}}]
        meta.extend({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": label}}
                    for tid, label in sorted(seen_tids.items()))
        return {
            "traceEvents": meta + trace_events,
            "displayTimeUnit": "ms",
            "otherData": {
                "clock": "monotonic",
                "events": len(events),
                "dropped": self.dropped(),
                "capacity": self._events.maxlen,
                # which process this dump is, and the clock anchor that
                # places it on the wall clock
                "process": identity,
            },
        }

    def export_chrome(self, path: Optional[str] = None,
                      tail_s: Optional[float] = None) -> Dict[str, Any]:
        """Build (and optionally write) the Chrome-trace dump. ``tail_s``
        restricts it to the trailing slice — the diagnostic-bundle form."""
        events = self.tail(tail_s) if tail_s is not None else None
        trace = self.to_chrome(events)
        if path:
            d = os.path.dirname(os.path.abspath(path))
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                # args may hold numpy scalars etc. — stringify, never die
                json.dump(trace, f, default=str)
        return trace

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------
    def summary(self, prefix: Optional[str] = None) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregate over the ring's complete events:
        count / total_s / mean_s / max_s / p50_s / p95_s / p99_s.
        ``prefix`` filters span names (e.g. ``"serve/"``; a tuple of
        prefixes matches any — ``str.startswith`` semantics)."""
        buckets: Dict[str, List[float]] = {}
        for e in self.events_snapshot():
            if e[_PH] != "X":
                continue
            name = e[_NAME]
            if prefix and not name.startswith(prefix):
                continue
            buckets.setdefault(name, []).append(e[_DUR])
        out: Dict[str, Dict[str, float]] = {}
        for name, durs in buckets.items():
            durs.sort()
            n = len(durs)
            out[name] = {
                "count": n,
                "total_s": sum(durs),
                "mean_s": sum(durs) / n,
                "max_s": durs[-1],
                "p50_s": _quantile(durs, 0.5),
                "p95_s": _quantile(durs, 0.95),
                "p99_s": _quantile(durs, 0.99),
            }
        return out

    def instant_counts(self, prefix: Optional[str] = None) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events_snapshot():
            if e[_PH] != "i":
                continue
            name = e[_NAME]
            if prefix and not name.startswith(prefix):
                continue
            out[name] = out.get(name, 0) + 1
        return out

    def counter_series(self, prefix: Optional[str] = None
                       ) -> Dict[str, Dict[str, Dict[str, float]]]:
        """Per-counter per-series aggregate over the ring's "C" events:
        ``{counter: {series: {"last", "max", "p95", "p99", "count"}}}`` —
        the read side of the dsmem HBM/RSS/KV tracks (events are
        id-ordered, so "last" is the newest sample; p95/p99 follow the
        shared exact-quantile rule ``_quantile``, same as the serve-plan
        replay's standalone copy, so KV/prefix counter tracks report tails
        rather than just last/max)."""
        values: Dict[str, Dict[str, List[float]]] = {}
        for e in sorted(self.events_snapshot(), key=lambda e: e[_EID]):
            if e[_PH] != "C" or not e[_ARGS]:
                continue
            name = e[_NAME]
            if prefix and not name.startswith(prefix):
                continue
            bucket = values.setdefault(name, {})
            for series, value in e[_ARGS].items():
                try:
                    v = float(value)
                except (TypeError, ValueError):
                    continue
                bucket.setdefault(series, []).append(v)
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for name, bucket in values.items():
            rows = out.setdefault(name, {})
            for series, vals in bucket.items():
                last = vals[-1]
                vals.sort()
                rows[series] = {"last": last, "max": vals[-1],
                                "p95": _quantile(vals, 0.95),
                                "p99": _quantile(vals, 0.99),
                                "count": len(vals)}
        return out

    def prometheus_lines(self, prefix: Optional[str] = None) -> List[str]:
        """Prometheus exposition of the span aggregates plus counter-track
        gauges (the serving ``/metrics`` endpoint appends these for
        ``serve/*`` and ``mem/*``)."""
        lines: List[str] = []
        summ = self.summary(prefix=prefix)
        if summ:
            lines += ["# HELP dstpu_trace_span_seconds tracer span durations",
                      "# TYPE dstpu_trace_span_seconds summary"]
            for name in sorted(summ):
                s = summ[name]
                for q, key in ((0.5, "p50_s"), (0.95, "p95_s"),
                               (0.99, "p99_s")):
                    lines.append(f'dstpu_trace_span_seconds{{span="{name}",'
                                 f'quantile="{q}"}} {s[key]:.9g}')
                lines.append(f'dstpu_trace_span_seconds_sum{{span="{name}"}} '
                             f'{s["total_s"]:.9g}')
                lines.append(
                    f'dstpu_trace_span_seconds_count{{span="{name}"}} '
                    f'{int(s["count"])}')
        counters = self.counter_series(prefix=prefix)
        if counters:
            lines += ["# HELP dstpu_trace_counter tracer counter tracks "
                      "(last/peak per series)",
                      "# TYPE dstpu_trace_counter gauge"]
            for name in sorted(counters):
                for series in sorted(counters[name]):
                    s = counters[name][series]
                    for stat in ("last", "max", "p95", "p99"):
                        lines.append(
                            f'dstpu_trace_counter{{counter="{name}",'
                            f'series="{series}",stat="{stat}"}} '
                            f'{s[stat]:.9g}')
        return lines


# ---------------------------------------------------------------------------
# process-global tracer
# ---------------------------------------------------------------------------
_tracer: Optional[Tracer] = None
_tracer_guard = threading.Lock()


def _dump_at_exit(tracer: Tracer, path: str) -> None:
    try:
        tracer.export_chrome(path)
        logger.info(f"dstrace: trace written -> {path} "
                    f"(load in https://ui.perfetto.dev)")
    except Exception:
        logger.exception("dstrace: atexit trace dump failed")


def get_tracer() -> Tracer:
    """THE process tracer every instrumented subsystem shares. First call
    honors ``DSTPU_TRACE=path`` (enable + dump at exit) and
    ``DSTPU_TRACE_CAPACITY``."""
    global _tracer
    t = _tracer
    if t is not None:
        return t
    with _tracer_guard:
        if _tracer is None:
            try:
                cap = int(os.environ.get(TRACE_CAPACITY_ENV,
                                         DEFAULT_CAPACITY))
            except ValueError:
                cap = DEFAULT_CAPACITY
            t = Tracer(capacity=cap)
            path = os.environ.get(TRACE_ENV)
            if path:
                t.enabled = True
                atexit.register(_dump_at_exit, t, path)
                logger.info(f"dstrace: tracing enabled ({TRACE_ENV}); dump "
                            f"at exit -> {path}")
            _tracer = t
        return _tracer


def configure_tracing(enabled: Optional[bool] = None) -> Tracer:
    """Convenience front door: ``configure_tracing(enabled=True)``."""
    return get_tracer().configure(enabled=enabled)
