"""Wall-clock and throughput timers.

Port of ``deepspeed_tpu/utils/timer.py`` (reference
``deepspeed/utils/timer.py``: ``SynchronizedWallClockTimer`` :44,
``ThroughputTimer`` :199), cut to what the training path uses, plus the
serving layer's ``RateTracker``. A timer that synchronises waits for the
card with ``torch.cuda.synchronize`` when one is in use; on the CPU there
is nothing to wait for.
"""

import collections
import threading
import time
from typing import Dict, List, Optional

import torch

from deepspeed_tpu_torch.utils.logging import logger

TRAIN_BATCH_TIMER = "train_batch"
# host time spent dispatching a step (the async pipeline's timer; that
# pipeline is not ported yet)
TRAIN_BATCH_DISPATCH_TIMER = "train_batch_dispatch"


def _device_sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """A single named timer with start/stop/elapsed and mean."""

    def __init__(self, name: str, synchronize: bool = True):
        self.name = name
        self.synchronize = synchronize
        self._started = False
        self._ever_started = False
        self._start_time = 0.0
        self._elapsed = 0.0
        self._records: List[float] = []

    def start(self):
        if self._started:
            return
        if self.synchronize:
            _device_sync()
        self._start_time = time.time()
        self._started = True
        self._ever_started = True

    def stop(self, record: bool = True):
        if not self._started:
            return
        if self.synchronize:
            _device_sync()
        delta = time.time() - self._start_time
        self._elapsed += delta
        if record:
            self._records.append(delta)
        self._started = False

    def reset(self):
        self._started = False
        self._elapsed = 0.0
        self._records = []

    def elapsed(self, reset: bool = True) -> float:
        """Elapsed seconds since last reset (stops/restarts a running timer)."""
        if not self._ever_started:
            logger.warning(f"timer '{self.name}': elapsed() before any "
                           "start(); returning 0.0")
            return 0.0
        was_started = self._started
        if was_started:
            self.stop(record=False)
        value = self._elapsed
        if reset:
            self._elapsed = 0.0
            self._records = []
        if was_started:
            self.start()
        return value

    def mean(self) -> float:
        if not self._ever_started:
            logger.warning(f"timer '{self.name}': mean() before any start(); "
                           "returning 0.0")
            return 0.0
        return sum(self._records) / len(self._records) if self._records else 0.0


class SynchronizedWallClockTimer:
    """Registry of named timers. ``synchronize=False`` times the host's
    enqueue only (the engine's default unless ``wall_clock_breakdown``)."""

    def __init__(self, synchronize: bool = True):
        self.timers: Dict[str, Timer] = {}
        self.synchronize = synchronize

    def __call__(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name, synchronize=self.synchronize)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True) -> None:
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}ms")
        if parts:
            logger.info("time (ms) | " + " | ".join(parts))

    def get_mean(self, names: List[str], normalizer: float = 1.0) -> Dict[str, float]:
        return {name: self.timers[name].mean() * 1000.0 / normalizer
                for name in names if name in self.timers}


class ThroughputTimer:
    """samples/s, measured edge to edge: the clock is read (after a device
    sync) only at report-window boundaries, so time the caller spends
    between steps is counted."""

    def __init__(self, batch_size: int, steps_per_output: int = 100,
                 logging_fn=None, synchronize: bool = True):
        self.batch_size = max(1, batch_size)
        self.steps_per_output = steps_per_output
        self.synchronize = synchronize
        self.logging = logging_fn or logger.info
        self.started = False
        self.global_step_count = 0
        self.steps_since_edge = 0
        self.total_elapsed_time = 0.0
        self._steps_in_total = 0
        self._edge_time: Optional[float] = None

    def start(self):
        self.started = True
        if self._edge_time is None:
            if self.synchronize:
                _device_sync()
            self._edge_time = time.time()

    def stop(self, global_step: bool = True, report_speed: bool = True):
        if not self.started:
            return
        self.started = False
        if not global_step:
            return
        self.global_step_count += 1
        self.steps_since_edge += 1
        if self.synchronize and self.steps_per_output and \
                self.global_step_count % self.steps_per_output == 0:
            _device_sync()
            self._close_window(report_speed)

    def _close_window(self, report_speed: bool):
        now = time.time()
        window = max(now - self._edge_time, 1e-9)
        self.total_elapsed_time += window
        self._steps_in_total += self.steps_since_edge
        if report_speed:
            sps = self.batch_size * self.steps_since_edge / window
            self.logging(f"epoch step {self.global_step_count}: "
                         f"{sps:.1f} samples/s, batch time "
                         f"{window / self.steps_since_edge * 1000:.1f} ms")
        self._edge_time = now
        self.steps_since_edge = 0

    def avg_samples_per_sec(self) -> float:
        if self._steps_in_total > 0 and self.total_elapsed_time > 0:
            return self.batch_size * self._steps_in_total / self.total_elapsed_time
        if self.steps_since_edge > 0 and self._edge_time is not None:
            partial = max(time.time() - self._edge_time, 1e-9)
            return self.batch_size * self.steps_since_edge / partial
        return 0.0


class RateTracker:
    """Rolling events/sec over a sliding wall-clock window (serving
    throughput gauges: tokens/sec, requests/sec). Thread-safe; no device
    sync — serving rates time host-observed events, not kernel completion."""

    def __init__(self, window_s: float = 30.0):
        self.window_s = window_s
        self._events = collections.deque()   # (monotonic_ts, count)
        self._start = time.monotonic()
        self._lock = threading.Lock()

    def add(self, n: float = 1.0, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((now, n))
            self._prune(now)

    def _prune(self, now: float):
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def rate(self, now: Optional[float] = None) -> float:
        """Events/sec averaged over the full window (0.0 when empty). The
        divisor is the window span — not the oldest-event age, which would
        spike absurdly for a single event right after an idle period — and
        shrinks to the tracker's lifetime while younger than the window."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune(now)
            if not self._events:
                return 0.0
            span = max(min(self.window_s, now - self._start), 1e-9)
            return sum(n for _, n in self._events) / span
