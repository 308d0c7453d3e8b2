"""Span tracing — the part of ``deepspeed_tpu/telemetry/tracer.py`` the
serving engine calls (``get_tracer().complete(...)``), copied.

Emission reads ``time.monotonic()`` and appends a tuple to a bounded ring:
no device work, no locks. Off by default; ``configure_tracing(enabled=True)``
or ``DSTPU_TRACE=1`` turns it on; ``events_snapshot()`` reads the ring.
"""

import collections
import itertools
import os
import threading
import time
from typing import List, Optional, Tuple

TRACE_ENV = "DSTPU_TRACE"
DEFAULT_CAPACITY = 65536

class Tracer:
    """Bounded span ring with lock-free emission."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self._events: collections.deque = collections.deque(
            maxlen=max(int(capacity), 16))
        self._ids = itertools.count(1)
        self._lock = threading.Lock()         # read side only, never emit

    def configure(self, enabled: Optional[bool] = None) -> "Tracer":
        if enabled is not None:
            self.enabled = bool(enabled)
        return self

    def complete(self, name: str, dur_s: float, cat: str = "host",
                 end_ts: Optional[float] = None, tid: Optional[int] = None,
                 **args) -> None:
        """Record a span retroactively from a measured duration; ``end_ts``
        is on ``time.monotonic`` and defaults to now."""
        if not self.enabled:
            return
        dur_s = max(dur_s, 0.0)
        end = time.monotonic() if end_ts is None else end_ts
        self._events.append(
            (next(self._ids), name, cat, "X", end - dur_s, dur_s,
             tid if tid is not None else threading.get_ident(),
             args or None))

    def events_snapshot(self) -> List[Tuple]:
        """Events as ``(eid, name, cat, ph, ts_s, dur_s, tid, args)``."""
        with self._lock:
            return list(self._events)


_tracer: Optional[Tracer] = None
_tracer_guard = threading.Lock()


def get_tracer() -> Tracer:
    """The process tracer; the first call honours ``DSTPU_TRACE``."""
    global _tracer
    if _tracer is not None:
        return _tracer
    with _tracer_guard:
        if _tracer is None:
            t = Tracer()
            t.enabled = bool(os.environ.get(TRACE_ENV))
            _tracer = t
        return _tracer


def configure_tracing(enabled: Optional[bool] = None) -> Tracer:
    return get_tracer().configure(enabled=enabled)
