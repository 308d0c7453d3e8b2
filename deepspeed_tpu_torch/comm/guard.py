"""commguard: the fault taxonomy, timeout-bounded eager collectives and
wedge-proof initialization (copy of ``deepspeed_tpu/comm/guard.py``).

A rendezvous that never completes, or one dead peer, turns a collective
into an infinite hang that the step-level resilience layer cannot see. The
guard runs such calls on a watched worker thread and keeps a deadline in
the caller: a wedge becomes a ``CommWedgeError`` carrying the dstrace comm
tail instead of a silent hang. What it bounds here:

- ``init_distributed``'s ``torch.distributed.init_process_group`` through
  ``bounded_init`` (deadline, exponential-backoff retry of TRANSIENT
  failures, the ``DSTPU_COMM_INIT_*`` env);
- eager ops routed through ``guarded`` (``comm.device_broadcast``) while a
  ``CommGuard`` is installed with ``set_active_guard``.

Every facade collective notes its name into the op listener
(``note_comm_op``), the feed a membership heartbeat reads as "last comm
op" (``resilience/membership.py`` is not ported yet, ROADMAP Queue 1 item
6). ``next_op_seq`` numbers recorded ops: every rank records its
collectives in the same order, so the k-th op matches across ranks.

Outcomes:

  ok        completed inside the deadline
  timeout   wedged past a deadline -> ``CommWedgeError``
  transient retryable (connection refused/reset, UNAVAILABLE,
            DEADLINE_EXCEEDED, RESOURCE_EXHAUSTED, a CUDA allocation that
            failed: ``torch.OutOfMemoryError``)
  fatal     anything else, and always a sticky CUDA error

On the card an out-of-memory error is ``torch.OutOfMemoryError`` ("CUDA
out of memory"), the counterpart of the TPU's RESOURCE_EXHAUSTED: the
allocation failed and nothing ran, so the serving layer may evict a
request and go on. A sticky CUDA error (an illegal address, a device-side
assert, a launch failure) poisons the context: every later call fails, so
it is FATAL even where its text holds a transient marker ("the launch timed
out and was terminated").

``CommGuardConfig`` is the ``"comm_guard"`` group's model, a dataclass with
the reference's fields, defaults and validation messages (the card's
machine has no pydantic).
"""

import dataclasses
import enum
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from deepspeed_tpu_torch.telemetry.tracer import get_tracer
from deepspeed_tpu_torch.utils.logging import logger

# torch.OutOfMemoryError from 2.5 on; torch.cuda's name is the same class
_CUDA_OOM = getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError)


#: worker exit status meaning "a comm fault was detected and handled"
#: (classified abort after autosave): 75 = BSD EX_TEMPFAIL, "temporary
#: failure, retry", so a relauncher treats it like a preemption
COMM_FAULT_EXIT_CODE = 75

#: env overrides for the init path (0 deadline disables bounding)
INIT_DEADLINE_ENV = "DSTPU_COMM_INIT_DEADLINE_S"
INIT_RETRIES_ENV = "DSTPU_COMM_INIT_RETRIES"
INIT_BACKOFF_ENV = "DSTPU_COMM_INIT_BACKOFF_S"


class CommOutcome(enum.Enum):
    OK = "ok"
    TIMEOUT = "timeout"
    TRANSIENT = "transient"
    FATAL = "fatal"


@dataclasses.dataclass
class CommGuardConfig:
    """The ``"comm_guard"`` config group."""
    enabled: bool = False
    # deadline for one eager guarded collective
    op_deadline_s: float = 60.0
    # deadline for init/rendezvous (0 = unbounded)
    init_deadline_s: float = 300.0
    # exponential-backoff retry budget for TRANSIENT init failures
    init_retries: int = 3
    init_backoff_s: float = 1.0
    # distributed-health heartbeat (read by resilience/membership.py)
    heartbeat_interval_s: float = 1.0
    # a peer whose heartbeat is older than this is LOST
    lost_after_s: float = 10.0
    # where per-rank heartbeat files land
    membership_dir: str = ""
    # straggler detection: per-op duration > median * factor AND excess > min_s
    straggler_factor: float = 3.0
    straggler_min_s: float = 0.0
    # trailing dstrace slice attached to CommWedgeError
    trace_tail_s: float = 30.0

    def __post_init__(self):
        if self.op_deadline_s <= 0:
            raise ValueError("op_deadline_s must be > 0")
        if self.init_deadline_s < 0:
            raise ValueError("init_deadline_s must be >= 0 (0 = unbounded)")
        if self.straggler_factor <= 1.0:
            raise ValueError("straggler_factor must be > 1.0")
        if self.heartbeat_interval_s <= 0:
            raise ValueError("heartbeat_interval_s must be > 0")
        if self.lost_after_s <= self.heartbeat_interval_s:
            raise ValueError("lost_after_s must exceed heartbeat_interval_s")


# ---------------------------------------------------------------------------
# fault taxonomy
# ---------------------------------------------------------------------------
class CommFaultError(RuntimeError):
    """Base class for classified comm faults: the op name, the classified
    outcome and the elapsed time."""

    def __init__(self, msg: str, op: str, outcome: CommOutcome,
                 elapsed_s: float = 0.0):
        super().__init__(msg)
        self.op = op
        self.outcome = outcome
        self.elapsed_s = elapsed_s


class CommWedgeError(CommFaultError):
    """A guarded op ran past its deadline. ``comm_tail`` is the trailing
    slice of dstrace comm events, so the error says what the communicator
    was doing when it wedged."""

    def __init__(self, msg: str, op: str, elapsed_s: float,
                 comm_tail: Optional[List[dict]] = None):
        super().__init__(msg, op, CommOutcome.TIMEOUT, elapsed_s)
        self.comm_tail = comm_tail or []

    def __str__(self):
        base = super().__str__()
        if not self.comm_tail:
            return base
        last = self.comm_tail[-3:]
        ops = ", ".join(e.get("name", "?") for e in last)
        return f"{base} [comm tail ({len(self.comm_tail)} events): ... {ops}]"


class CommInitError(CommFaultError):
    """Initialization / rendezvous failed after the retry budget
    (TRANSIENT exhausted) or at once (FATAL)."""

    def __init__(self, msg: str, op: str, outcome: CommOutcome,
                 attempts: int = 1, cause: Optional[BaseException] = None):
        super().__init__(msg, op, outcome)
        self.attempts = attempts
        self.__cause__ = cause


class CommPeerLostError(CommFaultError):
    """The membership view declared a peer dead (stale heartbeat)."""

    def __init__(self, msg: str, ranks):
        super().__init__(msg, "membership", CommOutcome.FATAL)
        self.ranks = tuple(ranks)


#: exception-text markers meaning "the fabric/control plane hiccuped —
#: retry with backoff" (gRPC status names, plus the socket-level spellings)
_TRANSIENT_MARKERS = (
    "unavailable", "deadline_exceeded", "deadline exceeded", "aborted",
    "connection refused", "connection reset", "connection closed",
    "broken pipe", "temporarily", "try again", "resource_exhausted",
    "failed to connect", "socket closed", "timed out",
)
#: markers meaning "credentials, not connectivity" — never retried
_AUTH_MARKERS = ("permission denied", "permission_denied", "unauthenticated",
                 "forbidden", "credential", "authentication", "oauth")
#: the CUDA runtime's sticky errors (the context is lost until the process
#: exits); they win over every transient marker
_CUDA_STICKY_MARKERS = (
    "illegal memory access", "illegal address", "device-side assert",
    "launch failure", "launch timed out", "misaligned address",
    "illegal instruction", "hardware stack error", "uncorrectable ecc",
)


def classify_exception(exc: BaseException) -> CommOutcome:
    """TRANSIENT iff the error text (or type) says the control plane or the
    allocator may recover; auth failures, sticky CUDA errors and
    everything else are FATAL — retrying a credential failure just burns
    the deadline, and a lost CUDA context fails every retry."""
    text = f"{type(exc).__name__}: {exc}".lower()
    if any(m in text for m in _AUTH_MARKERS):
        return CommOutcome.FATAL
    if any(m in text for m in _CUDA_STICKY_MARKERS):
        return CommOutcome.FATAL
    if isinstance(exc, (ConnectionError, TimeoutError, _CUDA_OOM)):
        return CommOutcome.TRANSIENT
    if any(m in text for m in _TRANSIENT_MARKERS):
        return CommOutcome.TRANSIENT
    return CommOutcome.FATAL


def comm_trace_tail(tail_s: float = 30.0) -> List[dict]:
    """The trailing ``tail_s`` of dstrace comm events as plain dicts: what
    ``CommWedgeError`` embeds."""
    tracer = get_tracer()
    if not tracer.enabled:
        return []
    out = []
    for eid, name, cat, ph, ts, dur, tid, args in tracer.tail(tail_s):
        if cat != "comm" and not name.startswith("comm/"):
            continue
        out.append({"name": name, "ph": ph, "ts": ts, "dur_s": dur,
                    "args": dict(args) if args else {}})
    return out


# ---------------------------------------------------------------------------
# comm-op sequence numbers (the cross-rank join key)
# ---------------------------------------------------------------------------
_op_seq = itertools.count(1)


def next_op_seq() -> int:
    """Allocate the next comm-op sequence number (one counter increment,
    never a device sync)."""
    return next(_op_seq)


# ---------------------------------------------------------------------------
# comm-op listener (membership's "last comm op" feed)
# ---------------------------------------------------------------------------
_comm_listener: Optional[Callable[[str], None]] = None


def set_comm_op_listener(fn: Optional[Callable[[str], None]]) -> None:
    """Install the active heartbeat's ``note_op`` (one listener)."""
    global _comm_listener
    _comm_listener = fn


def clear_comm_op_listener(fn: Callable[[str], None]) -> None:
    """Uninstall ``fn`` only if it is still the active listener (equality,
    not identity: each ``obj.method`` access builds a new bound method)."""
    global _comm_listener
    if _comm_listener == fn:
        _comm_listener = None


def note_comm_op(op_name: str) -> None:
    """Called by the collective facade for every recorded op: one
    attribute read and one call, never a device sync."""
    lis = _comm_listener
    if lis is not None:
        lis(op_name)


# ---------------------------------------------------------------------------
# active guard (the facade's eager ops route through it)
# ---------------------------------------------------------------------------
_active_guard: Optional["CommGuard"] = None


def set_active_guard(guard: Optional["CommGuard"]) -> None:
    """Install the process-wide guard: while installed, ``guarded`` ops
    (``comm.device_broadcast``) run deadline-bounded."""
    global _active_guard
    _active_guard = guard


def get_active_guard() -> Optional["CommGuard"]:
    return _active_guard


def clear_active_guard(guard: "CommGuard") -> None:
    """Uninstall ``guard`` only if it is still the active one."""
    global _active_guard
    if _active_guard is guard:
        _active_guard = None


def guarded(op: str, fn: Callable[[], Any],
            deadline_s: Optional[float] = None) -> Any:
    """Run one eager comm op under the active guard, or inline when none
    is installed (one global read)."""
    g = _active_guard
    if g is None:
        return fn()
    return g.run(op, fn, deadline_s=deadline_s)


# ---------------------------------------------------------------------------
# deadline-bounded execution
# ---------------------------------------------------------------------------
def _run_with_deadline(fn: Callable[[], Any], deadline_s: float,
                       name: str) -> Dict[str, Any]:
    """Run ``fn`` on a daemon worker thread and wait up to ``deadline_s``.
    Returns ``{"done": bool, "value": ..., "error": ...}``; on timeout the
    worker is abandoned (it is stuck in native code)."""
    box: Dict[str, Any] = {}
    done = threading.Event()

    def _target():
        try:
            box["value"] = fn()
        except BaseException as e:   # noqa: BLE001 — classified by caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_target, daemon=True,
                         name=f"dstpu-commguard-{name}")
    t.start()
    box["done"] = done.wait(deadline_s)
    return box


def bounded_init(fn: Callable[[], Any], *, name: str = "init",
                 deadline_s: float = 300.0, retries: int = 3,
                 backoff_s: float = 1.0,
                 classify: Callable[[BaseException], CommOutcome]
                 = classify_exception,
                 trace_tail_s: float = 30.0) -> Any:
    """Run an init/rendezvous callable under a deadline, retrying
    TRANSIENT failures with exponential backoff:

    - no return inside ``deadline_s`` -> ``CommWedgeError`` at once (a
      wedged native init poisons the backend);
    - TRANSIENT exception -> up to ``retries`` retries, sleeping
      ``backoff_s * 2^(attempt-1)`` between attempts;
    - FATAL exception -> ``CommInitError`` at once.

    ``deadline_s <= 0`` runs ``fn`` inline (unbounded)."""
    tracer = get_tracer()
    attempts = 0
    while True:
        attempts += 1
        t0 = time.monotonic()
        with tracer.span(f"comm/init/{name}", cat="comm", attempt=attempts):
            if deadline_s and deadline_s > 0:
                box = _run_with_deadline(fn, deadline_s, name)
            else:
                # inline: catch Exception only, so KeyboardInterrupt and
                # SystemExit keep their meaning
                try:
                    box = {"done": True, "value": fn()}
                except Exception as e:
                    box = {"done": True, "error": e}
        elapsed = time.monotonic() - t0
        if not box["done"]:
            tracer.instant("comm/init_wedge", cat="comm", op=name,
                           deadline_s=deadline_s)
            raise CommWedgeError(
                f"{name}: initialization exceeded {deadline_s:.0f}s deadline "
                f"(wedged in native init; attempt {attempts})",
                op=name, elapsed_s=elapsed,
                comm_tail=comm_trace_tail(trace_tail_s))
        if "error" not in box:
            return box.get("value")
        exc = box["error"]
        outcome = classify(exc)
        if outcome is CommOutcome.TRANSIENT and attempts <= retries:
            sleep = backoff_s * 2 ** (attempts - 1)
            tracer.instant("comm/init_retry", cat="comm", op=name,
                           attempt=attempts, backoff_s=round(sleep, 3))
            logger.warning(f"commguard: {name} transient init failure "
                           f"(attempt {attempts}/{retries + 1}): {exc!r}; "
                           f"retrying in {sleep:.1f}s")
            time.sleep(sleep)
            continue
        kind = "transient (retry budget exhausted)" \
            if outcome is CommOutcome.TRANSIENT else "fatal"
        raise CommInitError(
            f"{name}: initialization failed ({kind}) after {attempts} "
            f"attempt(s): {exc!r}",
            op=name, outcome=outcome, attempts=attempts, cause=exc)


class CommGuard:
    """Deadline-bounds eager collectives and classifies every outcome.

    ``run(op, fn)`` executes ``fn`` on a watched worker thread: a return
    inside ``op_deadline_s`` is OK, a chaos delay OK-but-slow, and a wedge
    raises ``CommWedgeError`` with the dstrace comm tail. ``chaos`` is
    duck-typed: anything with ``.comm_fault(op, call_index)`` returning
    None, "delay" or "wedge"."""

    def __init__(self, config: Optional[CommGuardConfig] = None,
                 chaos=None):
        self.cfg = config or CommGuardConfig(enabled=True)
        self.chaos = chaos
        self.counters: Dict[str, int] = {o.value: 0 for o in CommOutcome}
        self._calls = 0                    # guarded-op call index (chaos key)

    def run(self, op: str, fn: Callable[[], Any],
            deadline_s: Optional[float] = None) -> Any:
        """One guarded eager op. Raises ``CommWedgeError`` on deadline,
        re-raises (classified, counted) on failure."""
        deadline = deadline_s if deadline_s is not None \
            else self.cfg.op_deadline_s
        call_idx = self._calls
        self._calls += 1
        tracer = get_tracer()
        # allocated at entry, so the k-th guarded op carries the same seq on
        # every rank even when one of them wedges mid-op
        op_seq = next_op_seq()
        fault = self.chaos.comm_fault(op, call_idx) \
            if self.chaos is not None else None
        run_fn = fn
        if fault == "wedge":
            run_fn = self._wedged(op, deadline)
        elif fault == "delay":
            run_fn = self._delayed(op, fn)
        t0 = time.monotonic()
        with tracer.span(f"comm/guarded/{op}", cat="comm", call=call_idx,
                         op_seq=op_seq, deadline_s=deadline):
            box = _run_with_deadline(run_fn, deadline, op)
        elapsed = time.monotonic() - t0
        if not box["done"]:
            self.counters["timeout"] += 1
            tracer.instant("comm/wedge", cat="comm", op=op,
                           deadline_s=deadline)
            raise CommWedgeError(
                f"collective '{op}' exceeded {deadline:.1f}s deadline "
                f"(wedged; call #{call_idx})",
                op=op, elapsed_s=elapsed,
                comm_tail=comm_trace_tail(self.cfg.trace_tail_s))
        if "error" in box:
            exc = box["error"]
            outcome = classify_exception(exc)
            self.counters[outcome.value] += 1
            tracer.instant("comm/op_failed", cat="comm", op=op,
                           outcome=outcome.value)
            raise exc
        self.counters["ok"] += 1
        note_comm_op(op)
        return box.get("value")

    def _wedged(self, op: str, deadline: float) -> Callable[[], None]:
        def _hang():
            # bounded far past the deadline (not infinite) so the abandoned
            # daemon thread exits in long-lived test processes
            time.sleep(max(deadline, 0.1) * 100)
        return _hang

    def _delayed(self, op: str, fn: Callable[[], Any]) -> Callable[[], Any]:
        delay = getattr(self.chaos.config, "comm_delay_s", 0.0)

        def _slow():
            time.sleep(delay)
            return fn()
        return _slow
