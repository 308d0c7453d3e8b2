"""Communication volume / bandwidth accounting (copy of
``deepspeed_tpu/comm/comms_logging.py``; reference
``deepspeed/utils/comms_logging.py:67`` ``CommsLogger`` and
``calc_bw_log:34``, alg/bus bandwidth).

The port's collectives are eager ``torch.distributed`` calls, so the facade
(``comm/comm.py``) records each one when it runs: with the logger off, a
trace instant of its analytic bytes (``emit_comm_instant``); with the
logger on, ``timed``: wall-clock latency around the call (the facade
synchronizes the card before and after it, the only place it does) plus
alg/bus bandwidth, as the reference's ``timed_op``. ``record_traced`` keeps
the analytic per-op counts of ops recorded without a duration.
"""

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.telemetry.tracer import get_tracer
from deepspeed_tpu_torch.utils.logging import logger


#: canonical op-name -> op-kind registry. Classification is an EXACT lookup
#: on this table (plus the explicit ``kind`` the facade passes for new ops),
#: never a substring match — "quantized_all_reduce" must take the allreduce
#: busbw factor because the table says so, and an op whose NAME merely
#: contains "all_reduce" must not silently inherit the 2(n-1)/n factor.
OP_KINDS = {
    "all_reduce": "all_reduce",
    "quantized_all_reduce": "all_reduce",
    "all_gather": "all_gather",
    "sparse_all_gather": "all_gather",
    "reduce_scatter": "reduce_scatter",
    "quantized_reduce_scatter": "reduce_scatter",
    "all_to_all": "all_to_all",
    "quantized_all_to_all": "all_to_all",
    "ppermute": "ppermute",
    "broadcast": "broadcast",
    "device_broadcast": "broadcast",
    "barrier": "barrier",
}

#: busbw = algbw * factor(n) per op kind (reference calc_bw_log ring factors)
_RING_FACTORS = {
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
}


def canonical_op_kind(op_name: str, kind: str = None) -> str:
    """The op's canonical kind: an explicit ``kind`` wins, else the exact
    registry entry, else ``"other"`` (busbw == algbw)."""
    if kind:
        return kind
    return OP_KINDS.get(op_name, "other")


def calc_bw(op_name: str, size_bytes: int, duration_s: float, world: int,
            kind: str = None):
    """Algorithm vs bus bandwidth (reference: comms_logging.py:34 calc_bw_log).

    busbw scales algbw by the ring-collective traffic factor: allreduce 2(n-1)/n,
    allgather/reduce_scatter/all_to_all (n-1)/n — selected by the CANONICAL
    op kind (``canonical_op_kind``), an exact lookup, so compressed /
    quantized op names can never misclassify the factor.

    Degenerate inputs are guarded, not propagated: a zero/negative duration
    (clock granularity on a fast op) or a negative size yields (0, 0)
    instead of inf/garbage, and ``world <= 1`` reports busbw == algbw — the
    ring factor would otherwise multiply a single-member op down to a 0
    busbw that reads as "link dead" on a dashboard.
    """
    if duration_s <= 0 or size_bytes < 0:
        return 0.0, 0.0
    algbw = size_bytes / duration_s
    n = max(world, 1)
    if n == 1:
        return algbw, algbw     # no inter-member traffic to scale by
    factor = _RING_FACTORS.get(canonical_op_kind(op_name, kind))
    busbw = algbw * factor(n) if factor else algbw
    return algbw, busbw


def emit_comm_instant(op_name: str, nbytes: int, world: int,
                      wire_bytes: int = None, kind: str = None,
                      op_seq: int = None) -> None:
    """Trace-time analytic comm record: an instant event (no runtime duration
    exists under XLA scheduling) carrying op/bytes/wire_bytes/world. THE
    single emission point — both ``CommsLogger.record_traced`` and the
    collective facade's logger-off path route through here so the trace args
    can never drift. ``wire_bytes`` defaults to the logical ``bytes`` (an
    uncompressed op is its own wire format); compressed collectives pass
    the codes+scales payload so dstrace / ``dstpu plan`` rollups can report
    the compression ratio deterministically. ``op_seq`` is the commguard
    sequence number — the cross-rank join key ``dstpu trace merge`` matches
    the k-th collective on rank 0 to the k-th on rank 3 by."""
    tracer = get_tracer()
    if tracer.enabled:
        args = {"bytes": int(nbytes),
                "wire_bytes": int(nbytes if wire_bytes is None
                                  else wire_bytes),
                "kind": canonical_op_kind(op_name, kind),
                "world": int(world)}
        if op_seq is not None:
            args["op_seq"] = int(op_seq)
        tracer.instant(f"comm/{op_name}", cat="comm", **args)


class CommsLogger:
    def __init__(self):
        self.enabled = False
        self.verbose = False
        self.prof_all = True
        self.prof_ops = []
        # op -> {count, total_bytes, wire_bytes}
        self.traced: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "bytes": 0, "wire_bytes": 0})
        # op -> list of (bytes, seconds, world, wire_bytes)
        self.timed_records: Dict[str, list] = defaultdict(list)

    def configure(self, enabled: bool = True, verbose: bool = False,
                  prof_all: bool = True, prof_ops=None):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []

    def record_traced(self, op_name: str, nbytes: int, world: int,
                      wire_bytes: int = None, kind: str = None,
                      op_seq: int = None):
        rec = self.traced[op_name]
        rec["count"] += 1
        rec["bytes"] += nbytes
        rec["wire_bytes"] += nbytes if wire_bytes is None else wire_bytes
        emit_comm_instant(op_name, nbytes, world, wire_bytes=wire_bytes,
                          kind=kind, op_seq=op_seq)
        if self.verbose:
            logger.info(f"[comms][trace] {op_name}: {nbytes / 1e6:.2f} MB over {world} members")

    @contextmanager
    def timed(self, op_name: str, nbytes: int, world: int,
              wire_bytes: int = None, kind: str = None, op_seq: int = None):
        tracer = get_tracer()
        if not (self.enabled or tracer.enabled):
            yield
            return
        wire = nbytes if wire_bytes is None else wire_bytes
        start = time.time()
        yield
        dur = time.time() - start
        algbw, busbw = calc_bw(op_name, nbytes, dur, world, kind=kind)
        if tracer.enabled:
            extra = {} if op_seq is None else {"op_seq": int(op_seq)}
            tracer.complete(f"comm/{op_name}", dur, cat="comm",
                            bytes=int(nbytes), wire_bytes=int(wire),
                            kind=canonical_op_kind(op_name, kind),
                            world=int(world),
                            algbw_gbps=algbw / 1e9, busbw_gbps=busbw / 1e9,
                            **extra)
        if not self.enabled:
            return
        self.timed_records[op_name].append((nbytes, dur, world, wire))
        if self.verbose:
            logger.info(f"[comms] {op_name}: {nbytes / 1e6:.2f} MB in {dur * 1e3:.2f} ms | "
                        f"algbw {algbw / 1e9:.2f} GB/s busbw {busbw / 1e9:.2f} GB/s")

    def log_summary(self, show_straggler: bool = False):
        """reference: dist.log_summary (comm/comm.py:422)."""
        lines = ["Communication summary:"]
        for op, rec in sorted(self.traced.items()):
            lines.append(f"  [traced] {op}: {int(rec['count'])} calls, "
                         f"{rec['bytes'] / 1e9:.3f} GB total")
        for op, recs in sorted(self.timed_records.items()):
            tot_b = sum(r[0] for r in recs)
            tot_t = sum(r[1] for r in recs)
            algbw, busbw = calc_bw(op, tot_b, tot_t, recs[-1][2] if recs else 1)
            lines.append(f"  [timed]  {op}: {len(recs)} calls, {tot_b / 1e9:.3f} GB, "
                         f"{tot_t * 1e3:.1f} ms, algbw {algbw / 1e9:.2f} GB/s")
        logger.info("\n".join(lines))
        return lines

    def per_op_totals(self) -> Dict[str, Dict[str, float]]:
        """Merged per-op volume/time totals across both recording modes —
        the summary ``env_report`` and tests consume without parsing log
        lines: ``{op: {count, bytes, wire_bytes, seconds}}`` (seconds only
        for eager timed ops; traced ops are scheduled by XLA). The
        compression ratio of an op is ``bytes / wire_bytes`` — equal when
        nothing on that op compresses."""
        out: Dict[str, Dict[str, float]] = {}
        for op, rec in self.traced.items():
            out[op] = {"count": int(rec["count"]),
                       "bytes": float(rec["bytes"]),
                       "wire_bytes": float(rec["wire_bytes"]),
                       "seconds": 0.0}
        for op, recs in self.timed_records.items():
            e = out.setdefault(op, {"count": 0, "bytes": 0.0,
                                    "wire_bytes": 0.0, "seconds": 0.0})
            e["count"] += len(recs)
            e["bytes"] += float(sum(r[0] for r in recs))
            e["wire_bytes"] += float(sum(
                r[3] if len(r) > 3 else r[0] for r in recs))
            e["seconds"] += float(sum(r[1] for r in recs))
        return out

    def env_report_rows(self) -> List[Tuple[str, str]]:
        """(key, value) rows for the ``dstpu_report`` environment report —
        per-op volume with the wire column, plus ONE comm-compression
        status row summarizing whether any op this process recorded moved
        fewer wire than logical bytes."""
        totals = self.per_op_totals()
        if not totals:
            return [("comms ops", "none recorded in this process"),
                    ("comm compression",
                     "no compressed ops recorded (enable the "
                     "comm_compression config group)")]
        rows = []
        logical_total = wire_total = 0.0
        for op, t in sorted(totals.items()):
            val = f"{int(t['count'])} calls, {t['bytes'] / 1e6:.2f} MB"
            if t["wire_bytes"] < t["bytes"]:
                ratio = t["bytes"] / max(t["wire_bytes"], 1.0)
                val += (f" -> {t['wire_bytes'] / 1e6:.2f} MB wire "
                        f"({ratio:.2f}x)")
            if t["seconds"] > 0:
                # volume/duration only: bus bandwidth needs the per-op world
                # size, which totals deliberately do not aggregate over
                val += (f", {t['seconds'] * 1e3:.1f} ms, "
                        f"{t['bytes'] / t['seconds'] / 1e9:.2f} GB/s")
            rows.append((f"comms[{op}]", val))
            logical_total += t["bytes"]
            wire_total += t["wire_bytes"]
        if wire_total < logical_total:
            rows.append(("comm compression",
                         f"active: {logical_total / 1e6:.2f} MB logical -> "
                         f"{wire_total / 1e6:.2f} MB wire "
                         f"({logical_total / max(wire_total, 1.0):.2f}x)"))
        else:
            rows.append(("comm compression",
                         "no compressed ops recorded (enable the "
                         "comm_compression config group)"))
        return rows

    def reset(self):
        self.traced.clear()
        self.timed_records.clear()


_comms_logger: Optional[CommsLogger] = None


def get_comms_logger() -> CommsLogger:
    global _comms_logger
    if _comms_logger is None:
        _comms_logger = CommsLogger()
    return _comms_logger
