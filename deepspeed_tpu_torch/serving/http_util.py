"""Shared stdlib HTTP client for the serving tier (copy of
``deepspeed_tpu/serving/http_util.py``: router, healthz poller, bench_serve
client lanes, the smoke's HTTP load).

One place for the client-side discipline every fleet component needs:

* **deadline-bounded requests** — every call carries a socket timeout;
  a wedged replica becomes an exception the caller classifies, never a
  forever-hang on a router thread;
* **exponential backoff with deterministic jitter** — the retry delay is
  a pure function of ``(seed, salt, attempt)`` (the chaos ``_roll``
  idiom), so a drill's retry schedule replays bit-identically while
  still de-synchronizing real fleets; a server-sent ``Retry-After`` is a
  FLOOR over the schedule (the replica's own hint wins);
* **the comm-guard outcome taxonomy, reused** — transport failures are
  classified by ``comm.guard.classify_exception``: TRANSIENT retries,
  auth/fatal raises immediately (an auth failure retried is an account
  lockout, not resilience);
* **non-idempotent safety** — a POST is retried ONLY when the caller
  supplies an idempotency key (the fleet router's dedupe uid). Without
  one, a retried submit could double-admit a generation; the helper
  clamps such calls to a single attempt rather than trusting callers to
  remember.

Streaming (``open_stream``) returns the replica's chunked JSON-lines
response as an iterator of parsed records; ``http.client`` dechunks, and
the per-read socket timeout bounds every token wait. Non-200 statuses
come back as data (status + parsed error body), never as exceptions —
backpressure is routing input, not a failure.
"""

import dataclasses
import hashlib
import http.client
import json
import time
import urllib.parse
from typing import Dict, Iterator, Optional, Tuple

from deepspeed_tpu_torch.comm.guard import CommOutcome, classify_exception
from deepspeed_tpu_torch.utils.logging import logger


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter."""

    max_attempts: int = 3
    backoff_s: float = 0.05          # first retry's base delay
    backoff_max_s: float = 2.0       # exponential cap
    jitter_frac: float = 0.25        # delay *= 1 + jitter_frac * roll
    seed: int = 0                    # jitter stream (sha-rolled, replayable)


def backoff_delay(policy: RetryPolicy, attempt: int,
                  retry_after_s: Optional[float] = None,
                  salt: int = 0) -> float:
    """Delay before retry ``attempt`` (1-based): ``backoff_s * 2^(a-1)``
    capped at ``backoff_max_s``, stretched by deterministic jitter. A
    server-sent ``Retry-After`` is honored as a floor — backing off less
    than the replica asked for just re-arrives into the same shed."""
    base = min(policy.backoff_s * (2.0 ** max(attempt - 1, 0)),
               policy.backoff_max_s)
    h = hashlib.sha256(
        f"{policy.seed}:{salt}:{attempt}".encode()).digest()
    roll = int.from_bytes(h[:8], "big") / 2 ** 64
    delay = base * (1.0 + policy.jitter_frac * roll)
    if retry_after_s is not None:
        delay = max(delay, float(retry_after_s))
    return delay


def _parse_retry_after(headers: Dict[str, str]) -> Optional[float]:
    raw = headers.get("retry-after")
    if raw is None:
        return None
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return None


@dataclasses.dataclass
class HttpReply:
    """One completed (non-streaming) exchange."""

    status: int
    headers: Dict[str, str]          # lower-cased keys
    body: bytes
    attempts: int = 1

    def json(self) -> dict:
        try:
            out = json.loads(self.body or b"{}")
        except ValueError:
            return {"error": self.body[:200].decode(errors="replace")}
        return out if isinstance(out, dict) else {"value": out}

    def retry_after_s(self) -> Optional[float]:
        return _parse_retry_after(self.headers)


def _split(url: str) -> Tuple[str, int, str]:
    u = urllib.parse.urlsplit(url)
    if u.scheme not in ("http", ""):
        raise ValueError(f"http_util speaks plain http only, got {url!r}")
    return u.hostname or "127.0.0.1", u.port or 80, (u.path or "/") + (
        f"?{u.query}" if u.query else "")


def _one_request(method: str, url: str, body: Optional[bytes],
                 timeout_s: float,
                 headers: Optional[Dict[str, str]] = None) -> HttpReply:
    host, port, path = _split(url)
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        hdrs = {"Content-Type": "application/json"} if body else {}
        if headers:
            hdrs.update(headers)
        conn.request(method, path, body, hdrs)
        resp = conn.getresponse()
        data = resp.read()
        return HttpReply(resp.status,
                         {k.lower(): v for k, v in resp.getheaders()}, data)
    finally:
        conn.close()


def request_json(method: str, url: str, payload: Optional[dict] = None,
                 timeout_s: float = 5.0,
                 retry: Optional[RetryPolicy] = None,
                 retry_status: Tuple[int, ...] = (),
                 idempotency_key: Optional[object] = None,
                 headers: Optional[Dict[str, str]] = None) -> HttpReply:
    """One JSON request with bounded, classified retries.

    Transport failures retry only when ``classify_exception`` says
    TRANSIENT (auth/fatal raises immediately — reusing the comm-guard
    taxonomy, satellite contract). Statuses in ``retry_status`` (e.g.
    ``(429,)`` for bench lanes) retry with ``Retry-After`` honored as the
    backoff floor. A non-GET without ``idempotency_key`` is clamped to
    ONE attempt no matter what ``retry`` says: retrying a submit the
    server may already have admitted needs the router's dedupe uid to be
    safe."""
    policy = retry or RetryPolicy(max_attempts=1)
    attempts = policy.max_attempts
    if method.upper() != "GET" and idempotency_key is None:
        attempts = 1
    body = (json.dumps(payload).encode() if payload is not None else None)
    salt = hash((url, str(idempotency_key))) & 0xFFFF
    attempt = 0
    while True:
        attempt += 1
        try:
            reply = _one_request(method, url, body, timeout_s,
                                 headers=headers)
        except Exception as e:
            outcome = classify_exception(e)
            if outcome is not CommOutcome.TRANSIENT or attempt >= attempts:
                raise
            delay = backoff_delay(policy, attempt, salt=salt)
            logger.debug(f"http_util: {method} {url} failed transient "
                         f"({e!r}); retry {attempt}/{attempts} in "
                         f"{delay:.3f}s")
            time.sleep(delay)
            continue
        if reply.status in retry_status and attempt < attempts:
            time.sleep(backoff_delay(policy, attempt,
                                     retry_after_s=reply.retry_after_s(),
                                     salt=salt))
            continue
        reply.attempts = attempt
        return reply


class StreamReply:
    """A streamed ``/generate`` exchange: ``status`` + parsed error body
    for non-200, or an open connection whose ``records()`` yields the
    JSON-lines records (``{"token": t}`` ... ``{"done": true, ...}``).
    Transport death mid-stream raises from ``records()`` — the router's
    failover trigger. Always ``close()`` (records() closes on exit)."""

    def __init__(self, status: int, headers: Dict[str, str],
                 error: Optional[dict], conn=None, resp=None):
        self.status = status
        self.headers = headers
        self.error = error
        self._conn = conn
        self._resp = resp

    def retry_after_s(self) -> Optional[float]:
        return _parse_retry_after(self.headers)

    def records(self) -> Iterator[dict]:
        if self._resp is None:
            return
        try:
            for line in self._resp:
                line = line.strip()
                if line:
                    yield json.loads(line)
        finally:
            self.close()

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None
                self._resp = None


def open_stream(url: str, payload: dict, timeout_s: float = 30.0,
                headers: Optional[Dict[str, str]] = None) -> StreamReply:
    """POST ``payload`` and return the streamed reply. ``timeout_s`` is
    the per-socket-read deadline (bounds both connect and every token
    wait). Raises on transport failure BEFORE a status line; after that,
    non-200 statuses are returned as data with the parsed error body."""
    host, port, path = _split(url)
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    body = json.dumps(payload).encode()
    hdrs = {"Content-Type": "application/json"}
    if headers:
        hdrs.update(headers)
    try:
        conn.request("POST", path, body, hdrs)
        resp = conn.getresponse()
    except Exception:
        conn.close()
        raise
    headers = {k.lower(): v for k, v in resp.getheaders()}
    if resp.status != 200:
        try:
            raw = resp.read()
        except Exception:
            raw = b""
        conn.close()
        try:
            err = json.loads(raw or b"{}")
        except ValueError:
            err = {"error": raw[:200].decode(errors="replace")}
        return StreamReply(resp.status, headers, err)
    return StreamReply(200, headers, None, conn=conn, resp=resp)
