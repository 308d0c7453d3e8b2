"""The host-orchestration core of the training and serving loops.

Port of ``deepspeed_tpu/runtime/sched.py``:

* ``DispatchRing`` — the async step pipeline's ring: each step's outputs
  (device tensors) wait in ``pending``; ``drain()`` is the one designated
  readback, every pending tensor stacked and copied to the host in one
  transfer (``transfers`` counts them). Drained host entries wait in a
  bounded queue that consumers ``take()`` and ``requeue()``.
* ``StagedPrefetcher`` — one background loader per source iterator; a new
  source closes the old loader.
* ``TickLedger`` — the serve tick's deterministic scheduler counters.

Where the reference's payload values are all device arrays fetched by one
``jax.device_get``, a port payload mixes device tensors (the loss, the
gradient norm) with host scalars the engine already holds (the step, the
lr, the overflow flag): only the tensors cross, stacked into one
float32 tensor.
"""

import collections
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from deepspeed_tpu_torch.telemetry.tracer import get_tracer
from deepspeed_tpu_torch.utils.logging import logger


class DrainResult(NamedTuple):
    """One ``DispatchRing.drain()``: host payloads + the extra operand that
    rode the same transfer, and the window the drained steps span."""
    payloads: List[Dict[str, Any]]
    extra: Any
    window_s: float        # seconds since the window anchor (0.0 unanchored)
    anchored: bool


def _host_payloads(ring: List[Dict[str, Any]], extra: Any):
    """Every tensor of ``ring`` (and ``extra``) to the host in one copy:
    the scalars stacked as float32 on their device, moved once, put back
    in their places as Python floats. Other values pass through."""
    slots = [(i, k) for i, p in enumerate(ring) for k, v in p.items()
             if isinstance(v, torch.Tensor)]
    tensors = [ring[i][k] for i, k in slots]
    extra_is_tensor = isinstance(extra, torch.Tensor)
    if extra_is_tensor:
        tensors.append(extra)
    if not tensors:
        return [dict(p) for p in ring], extra, False
    flat = torch.stack([t.detach().reshape(()).float() for t in tensors])
    host = flat.cpu().tolist()            # the one transfer
    out = [dict(p) for p in ring]
    for (i, k), v in zip(slots, host):
        out[i][k] = v
    return out, (host[-1] if extra_is_tensor else extra), True


class DispatchRing:
    """Pending step payloads + bounded host-entry queue + THE designated
    drain transfer.

    The producer pushes payload dicts whose values may be device tensors.
    ``drain`` moves everything across in one transfer, computes the
    reconciliation window from the anchor the producer set at the
    window's first dispatch, and leaves host fan-out to the caller.
    Drained entries the caller stores land in a bounded deque consumers
    ``take()``/``requeue()`` from — overflow is never silent.
    """

    #: drained host entries kept for ``take()`` before the oldest go
    CAPACITY = 4096

    def __init__(self, sync_every: int = 1):
        self.pending: List[Dict[str, Any]] = []    # device-side payloads
        self.drained: collections.deque = collections.deque(
            maxlen=self.CAPACITY)
        self.sync_every = int(sync_every)
        self.anchor: Optional[float] = None        # window start (time.time)
        self.transfers = 0                         # device-to-host copies

    def __len__(self) -> int:
        return len(self.pending)

    def push(self, payload: Dict[str, Any]) -> bool:
        """Queue one step's payload; returns True when the ring reached
        the drain cadence (the caller runs its drain)."""
        self.pending.append(payload)
        return len(self.pending) >= self.sync_every

    def rearm_if_idle(self) -> None:
        """Anchor a fresh window at this dispatch iff the ring is empty —
        host pauses between windows (checkpoint I/O, idle gaps after a
        flush) must never be booked as step time at the next drain."""
        if not self.pending:
            self.anchor = time.time()

    def reset_anchor(self) -> None:
        self.anchor = None

    def drain(self, extra: Any = None) -> Optional[DrainResult]:
        """THE designated readback point: one transfer of every pending
        payload's tensors (+ ``extra``, which rides the same transfer).
        Returns None when nothing is pending."""
        if not self.pending:
            return None
        ring, self.pending = self.pending, []
        with get_tracer().span("engine/drain", cat="train", steps=len(ring)):
            host, extra_host, moved = _host_payloads(ring, extra)
        self.transfers += int(moved)
        window, anchored = 0.0, self.anchor is not None
        if anchored:
            window = max(time.time() - self.anchor, 0.0)
        return DrainResult(payloads=host, extra=extra_host,
                           window_s=window, anchored=anchored)

    def store(self, entries: List[Dict[str, Any]]) -> int:
        """Append drained host entries to the consumer queue; returns the
        number of oldest un-consumed entries the bounded deque evicted
        (warned)."""
        dropped = len(self.drained) + len(entries) - self.drained.maxlen
        if dropped > 0:
            logger.warning(
                "async_pipeline: drained-metrics queue overflow — %d "
                "oldest un-consumed entries dropped (no "
                "take_drained_metrics consumer attached?)", dropped)
        self.drained.extend(entries)
        return max(dropped, 0)

    def take(self) -> List[Dict[str, Any]]:
        """Pop every drained-but-unconsumed host entry, in order."""
        out = list(self.drained)
        self.drained.clear()
        return out

    def requeue(self, entries: List[Dict[str, Any]]) -> None:
        """Put taken-but-unprocessed entries back at the FRONT (original
        order preserved); refuses to evict newer entries silently."""
        free = self.drained.maxlen - len(self.drained)
        if len(entries) > free:
            logger.warning(
                "async_pipeline: requeue overflow — %d newest entries "
                "dropped from the drained-metrics queue", len(entries) - free)
            entries = entries[:free]
        for e in reversed(entries):
            self.drained.appendleft(e)


class StagedPrefetcher:
    """Identity-keyed staged-prefetch lifecycle: one loader per source
    iterator. A new source closes the old loader (dropping its staged
    batches — the source iterator has already advanced past them), loud
    the first few switches and throttled after."""

    def __init__(self, depth: int = 2):
        self.depth = int(depth)
        self.loader = None
        self.source = None
        self.switches = 0

    def ensure(self, source, factory: Callable[[], Any]):
        """Return the live loader for ``source``, building one via
        ``factory`` when the source identity changed (or none exists)."""
        if self.loader is not None and self.source is source:
            return self.loader
        if self.loader is not None:
            self.switches += 1
            if self.switches <= 3 or self.switches % 100 == 0:
                logger.warning(
                    "async_pipeline: data_iter identity changed (switch "
                    "#%d) — discarding the previous prefetcher and up to %d "
                    "staged batches; pass a STABLE iterator across "
                    "train_batch calls", self.switches,
                    self.depth)
            self.loader.close()
        self.loader = factory()
        self.source = source
        return self.loader

    def close(self) -> None:
        if self.loader is not None:
            self.loader.close()
            self.loader = None
            self.source = None


class TickLedger:
    """Deterministic per-tick serve-scheduler counters — the chunked
    prefill proof set. ``observe_tick`` is called once per engine step
    with that tick's planned work; everything else is host int
    arithmetic (no clocks, so the counters are identical across hosts
    for the same seeded workload).

    Window semantics: warmed bench runs call ``reset_window()`` at the
    measurement mark so the warm wave's ticks never leak into the
    measured maxima; cumulative totals keep running (every proof
    identity over them is conservation-shaped)."""

    #: bounded per-request attribution table (serving runs indefinitely;
    #: finished requests are popped, abandoned ones age out FIFO)
    REQUEST_CAP = 4096

    def __init__(self):
        self.ticks = 0                    # observed (working) ticks
        self.prefill_ticks = 0            # ticks that ran >= 1 chunk
        self.decode_ticks = 0             # ticks that ran a decode batch
        self.chunk_tokens_total = 0       # prefill tokens through chunks
        self.chunks_total = 0
        self.decode_tokens_total = 0
        self.capped_chunk_ticks = 0       # prefill ticks bound by the cap
        # uid -> {"ticks", "prefill_tokens", "chunks", "decode_tokens"}:
        # which slice of the tick stream each request consumed — the
        # wall-clock-free denominator the SLO layer states latencies in
        # (ceil-div cap units via ``units()``)
        self.request_ticks: Dict[int, Dict[str, int]] = {}
        self.reset_window()

    @staticmethod
    def units(tokens: int, unit_tokens: int) -> int:
        """Ceil-div of a token count into ``unit_tokens``-sized scheduling
        quanta — the ``max_decode_gap_ticks`` normalizer, exposed so the
        SLO histograms can be fed in cap units instead of wall seconds
        (deterministic across hosts; 0 when either operand is)."""
        if unit_tokens <= 0 or tokens <= 0:
            return 0
        return -(-int(tokens) // int(unit_tokens))    # ceil div

    def reset_window(self) -> None:
        """Start the measured window: maxima reset, totals keep running."""
        self.max_prefill_tokens_per_tick = 0
        # prefill tokens in the worst tick that ALSO ran decodes — the
        # exact "tokens of prefill a decode token waited behind" measure
        self.max_decode_stall_tokens = 0
        self.window_prefill_ticks = 0
        self.window_chunk_tokens = 0

    def observe_tick(self, prefill_tokens: int, chunks: int,
                     decode_tokens: int, cap: int = 0) -> None:
        self.ticks += 1
        if chunks:
            self.prefill_ticks += 1
            self.window_prefill_ticks += 1
            self.chunks_total += chunks
            self.chunk_tokens_total += prefill_tokens
            self.window_chunk_tokens += prefill_tokens
            if cap > 0 and prefill_tokens >= cap:
                self.capped_chunk_ticks += 1
        if decode_tokens:
            self.decode_ticks += 1
            self.decode_tokens_total += decode_tokens
        if prefill_tokens > self.max_prefill_tokens_per_tick:
            self.max_prefill_tokens_per_tick = prefill_tokens
        if decode_tokens and prefill_tokens > self.max_decode_stall_tokens:
            self.max_decode_stall_tokens = prefill_tokens

    def attribute_request(self, uid: int, prefill_tokens: int = 0,
                          chunks: int = 0, decode_tokens: int = 0) -> None:
        """Book one tick's work against the request that consumed it.
        Called alongside ``observe_tick`` by callers that know the
        per-request split (the serve loop's fan-out does); pure host int
        arithmetic like everything else here."""
        entry = self.request_ticks.get(uid)
        if entry is None:
            while len(self.request_ticks) >= self.REQUEST_CAP:
                # FIFO age-out: dict preserves insertion order
                self.request_ticks.pop(next(iter(self.request_ticks)))
            entry = {"ticks": 0, "prefill_tokens": 0, "chunks": 0,
                     "decode_tokens": 0}
            self.request_ticks[uid] = entry
        entry["ticks"] += 1
        entry["prefill_tokens"] += int(prefill_tokens)
        entry["chunks"] += int(chunks)
        entry["decode_tokens"] += int(decode_tokens)

    def pop_request(self, uid: int) -> Optional[Dict[str, int]]:
        """Remove and return a finished request's attribution entry (None
        when the request was never attributed or already aged out)."""
        return self.request_ticks.pop(uid, None)

    def merge_from(self, other: "TickLedger") -> None:
        """Fold another ledger in (the disaggregated pair sums its role
        engines' ledgers into one proof set)."""
        self.ticks += other.ticks
        self.prefill_ticks += other.prefill_ticks
        self.decode_ticks += other.decode_ticks
        self.chunk_tokens_total += other.chunk_tokens_total
        self.chunks_total += other.chunks_total
        self.decode_tokens_total += other.decode_tokens_total
        self.capped_chunk_ticks += other.capped_chunk_ticks
        self.window_prefill_ticks += other.window_prefill_ticks
        self.window_chunk_tokens += other.window_chunk_tokens
        self.max_prefill_tokens_per_tick = max(
            self.max_prefill_tokens_per_tick,
            other.max_prefill_tokens_per_tick)
        self.max_decode_stall_tokens = max(
            self.max_decode_stall_tokens, other.max_decode_stall_tokens)

    def snapshot(self, cap: int = 0, gap_unit_tokens: int = 0
                 ) -> Dict[str, Any]:
        """The scheduler proof set. ``max_decode_gap_ticks`` states the
        worst decode stall in cap-sized scheduling ticks: how many
        chunk-cap quanta of prefill a decode token waited behind in the
        worst tick (1 == decode never waited more than one chunk —
        "never serialized behind a full prefill"). ``gap_unit_tokens``
        overrides the normalizer so an uncapped baseline run can be
        stated in the SAME units as the capped run it is compared to."""
        unit = int(gap_unit_tokens or cap or 0)
        gap = self.units(self.max_decode_stall_tokens, unit)
        util = 0.0
        if cap > 0 and self.window_prefill_ticks > 0:
            util = self.window_chunk_tokens / float(
                cap * self.window_prefill_ticks)
        return {
            "prefill_chunk_tokens": int(cap),
            "ticks": self.ticks,
            "prefill_ticks": self.prefill_ticks,
            "decode_ticks": self.decode_ticks,
            "chunks_total": self.chunks_total,
            "chunk_tokens_total": self.chunk_tokens_total,
            "decode_tokens_total": self.decode_tokens_total,
            "capped_chunk_ticks": self.capped_chunk_ticks,
            "max_prefill_tokens_per_tick": self.max_prefill_tokens_per_tick,
            "max_decode_stall_tokens": self.max_decode_stall_tokens,
            "decode_gap_unit_tokens": unit,
            "max_decode_gap_ticks": gap,
            "prefill_cap_utilization": round(util, 4),
        }
