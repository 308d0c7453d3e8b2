"""Request lifecycle for the serving layer (copy of
``deepspeed_tpu/serving/request.py``).

Reference analog: DeepSpeed-MII's request/response plumbing over the FastGen
engine (MII sits above ``InferenceEngineV2`` exactly as this module sits above
``deepspeed_tpu_torch.inference.v2``). A request moves through
QUEUED -> PREFILL -> DECODE -> a terminal state; tokens fan out to a
per-request stream as the serve loop produces them, so callers iterate
tokens while the engine keeps batching other requests.
"""

import enum
import queue
import threading
import time
from typing import Iterator, List, Optional, Sequence

from deepspeed_tpu_torch.telemetry.tracer import get_tracer, request_tid


class RequestState(enum.Enum):
    QUEUED = "queued"          # accepted, waiting for engine admission
    PREFILL = "prefill"        # admitted, prompt KV being built (SplitFuse)
    DECODE = "decode"          # generating tokens
    FINISHED = "finished"      # completed normally (length / eos)
    CANCELLED = "cancelled"    # caller cancel()
    TIMED_OUT = "timed_out"    # deadline exceeded
    FAILED = "failed"          # engine error

    @property
    def terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.CANCELLED,
                        RequestState.TIMED_OUT, RequestState.FAILED)


# stream sentinel: pushed once when a request reaches a terminal state
_END = object()


class Request:
    """One generation request. Created by ``InferenceServer.submit``; the
    caller consumes ``stream()`` (token-at-a-time) or ``result()``
    (block until terminal). All mutation happens on the serve loop thread
    except ``cancel()``, which only sets an event the loop polls."""

    def __init__(self, uid: int, prompt_tokens: Sequence[int],
                 max_new_tokens: int, timeout_s: Optional[float] = None,
                 priority: int = 0):
        self.uid = uid
        self.prompt_tokens: List[int] = [int(t) for t in prompt_tokens]
        self.max_new_tokens = max_new_tokens
        # scheduling class: < 0 is low priority — brownout pauses its
        # engine admission (it waits in the queue; never silently dropped)
        self.priority = priority
        self.state = RequestState.QUEUED
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.tokens: List[int] = []
        # engine-step faults attributed to this request (fault isolation:
        # past the retry budget the request is quarantined, not retried)
        self.fault_count = 0
        # degradation-ladder level the server accepted this request under
        # (stamped by submit(); rides on the lifecycle retro-spans so the
        # serve plan reports latency tails per ladder level)
        self.ladder_level = "healthy"
        # fleet-wide trace id (stamped by submit() from the router's
        # X-Dstpu-Trace header). When set, the lifecycle retro-spans get
        # req/* twins carrying it — the join key reqtrace.py stitches the
        # router's and replicas' rings on. None (local callers) emits no
        # req/ spans at all, so single-process rings are unchanged.
        self.trace_id: Optional[str] = None
        # TickLedger request attribution, settled at reap: which slice of
        # the tick stream this request consumed (wall-clock-free; rides
        # describe() into responses and flight-recorder ledgers)
        self.sched_attribution: Optional[dict] = None

        # lifecycle timestamps (monotonic clock; durations only)
        self.arrival_ts = time.monotonic()
        self.admit_ts: Optional[float] = None        # engine admission
        self.first_token_ts: Optional[float] = None  # TTFT edge
        self.finish_ts: Optional[float] = None
        self.deadline: Optional[float] = (
            self.arrival_ts + timeout_s if timeout_s is not None else None)

        self._stream: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._cancel = threading.Event()

    # ---- caller-side API -------------------------------------------------
    def cancel(self):
        """Request cancellation; the serve loop honors it on its next tick
        (terminal state becomes CANCELLED unless already terminal)."""
        self._cancel.set()

    @property
    def cancelled_requested(self) -> bool:
        return self._cancel.is_set()

    def stream(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield generated tokens in order as they are produced; returns
        when the request reaches a terminal state. ``timeout`` bounds the
        wait for EACH token (raises ``queue.Empty`` on expiry)."""
        while True:
            item = self._stream.get(timeout=timeout)
            if item is _END:
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until terminal; returns the full generated token list.
        Raises ``TimeoutError`` if the request is still live after
        ``timeout`` seconds."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(f"request {self.uid} still "
                               f"{self.state.value} after {timeout}s")
        return list(self.tokens)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout=timeout)

    # ---- serve-loop-side API ---------------------------------------------
    def engine_prompt(self) -> List[int]:
        """Tokens to (re)admit with: the original prompt plus everything
        already generated — an evicted-and-retried request continues its
        stream instead of restarting it (tokens already fanned out cannot
        be unsent), at the cost of recomputing that KV (the
        ``recomputed_tokens`` counter)."""
        return self.prompt_tokens + self.tokens

    def push_token(self, tok: int, now: Optional[float] = None):
        if self.first_token_ts is None:
            self.first_token_ts = time.monotonic() if now is None else now
        self.tokens.append(tok)
        self._stream.put(tok)

    def finalize(self, state: RequestState, reason: str,
                 error: Optional[str] = None):
        if self.state.terminal:
            return
        self.state = state
        self.finish_reason = reason
        self.error = error
        self.finish_ts = time.monotonic()
        tracer = get_tracer()
        if tracer.enabled:
            self._trace_lifecycle(tracer)
        self._stream.put(_END)
        self._done.set()

    def _trace_lifecycle(self, tracer):
        """Emit the request's phase spans retroactively from the lifecycle
        timestamps (same monotonic clock as the tracer), one synthetic track
        per uid: queued (arrival→admit), prefill (admit→first token), decode
        (first token→finish), plus a terminal instant. TTFT/TPOT are
        derivable from the trace alone: TTFT = queued.dur + prefill.dur,
        TPOT = decode.dur / (tokens - 1)."""
        tid = request_tid(self.uid)
        level = self.ladder_level
        if self.admit_ts is not None:
            tracer.complete("serve/queued", self.admit_ts - self.arrival_ts,
                            cat="serve", end_ts=self.admit_ts, tid=tid,
                            uid=self.uid, level=level)
            if self.first_token_ts is not None:
                tracer.complete("serve/prefill",
                                self.first_token_ts - self.admit_ts,
                                cat="serve", end_ts=self.first_token_ts,
                                tid=tid, uid=self.uid, level=level,
                                prompt_tokens=len(self.prompt_tokens))
        if self.first_token_ts is not None and self.finish_ts is not None:
            tracer.complete("serve/decode",
                            self.finish_ts - self.first_token_ts,
                            cat="serve", end_ts=self.finish_ts, tid=tid,
                            uid=self.uid, level=level,
                            tokens=len(self.tokens))
        tracer.instant(f"serve/{self.state.value}", cat="serve", tid=tid,
                       uid=self.uid, reason=self.finish_reason)
        if self.trace_id is not None:
            self._trace_req_spans(tracer, tid)

    def _trace_req_spans(self, tracer, tid: int):
        """The trace_id-scoped twins of the lifecycle spans: same clock,
        same track, but named under ``req/`` and carrying the fleet-wide
        trace id so the offline stitcher can join this replica's phases
        with the router's ``req/wall`` envelope. Emitted ONLY for traced
        (fleet-routed) requests — local submits leave the ring exactly as
        it was before request tracing existed."""
        trace_id = self.trace_id
        if self.admit_ts is not None:
            tracer.complete("req/queue", self.admit_ts - self.arrival_ts,
                            cat="serve", end_ts=self.admit_ts, tid=tid,
                            trace_id=trace_id, uid=self.uid)
            if self.first_token_ts is not None:
                tracer.complete("req/prefill",
                                self.first_token_ts - self.admit_ts,
                                cat="serve", end_ts=self.first_token_ts,
                                tid=tid, trace_id=trace_id, uid=self.uid,
                                prompt_tokens=len(self.prompt_tokens))
        if self.first_token_ts is not None and self.finish_ts is not None:
            tracer.complete("req/decode",
                            self.finish_ts - self.first_token_ts,
                            cat="serve", end_ts=self.finish_ts, tid=tid,
                            trace_id=trace_id, uid=self.uid,
                            tokens=len(self.tokens), state=self.state.value)

    # ---- derived metrics -------------------------------------------------
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_ts is None:
            return None
        return self.admit_ts - self.arrival_ts

    @property
    def ttft_s(self) -> Optional[float]:
        """Time-to-first-token, measured from arrival (includes queue wait)."""
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.arrival_ts

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time-per-output-token over the decode phase (2nd token on)."""
        if (self.first_token_ts is None or self.finish_ts is None
                or len(self.tokens) < 2):
            return None
        return (self.finish_ts - self.first_token_ts) / (len(self.tokens) - 1)

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    def describe(self) -> dict:
        out = {
            "uid": self.uid,
            "state": self.state.value,
            "prompt_tokens": len(self.prompt_tokens),
            "generated_tokens": len(self.tokens),
            "finish_reason": self.finish_reason,
            "queue_wait_s": self.queue_wait_s,
            "ttft_s": self.ttft_s,
            "tpot_s": self.tpot_s,
        }
        if self.priority:
            out["priority"] = self.priority
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.sched_attribution is not None:
            out["sched_attribution"] = dict(self.sched_attribution)
        if self.fault_count:
            out["fault_count"] = self.fault_count
        if self.error is not None:
            out["error"] = self.error
        return out
