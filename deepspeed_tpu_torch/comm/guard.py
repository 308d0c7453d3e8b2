"""The fault taxonomy of ``deepspeed_tpu/comm/guard.py`` (``CommOutcome``,
``classify_exception`` and their marker lists, ``:71,175-198``), which the
serving layer uses to tell a fault it can isolate from one that leaves the
device suspect. The timeout-bounded collectives and the membership
heartbeat come with distribution (ROADMAP Queue 1, "distribution and
memory tiers").

Outcomes:

  ok        completed
  timeout   wedged past a deadline
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
"""

import enum

import torch

# torch.OutOfMemoryError from 2.5 on; torch.cuda's name is the same class
_CUDA_OOM = getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError)


class CommOutcome(enum.Enum):
    OK = "ok"
    TIMEOUT = "timeout"
    TRANSIENT = "transient"
    FATAL = "fatal"


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
