"""Serve-scheduler counters: ``TickLedger``, copied from
``deepspeed_tpu/runtime/sched.py``.

Only ``TickLedger`` is ported here. The rest of that module (the dispatch
ring and the staged prefetcher) belongs to the training loop and comes with
the training slice.

Host int arithmetic only: no clocks, no device work.
"""

from typing import Any, Dict, Optional


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
