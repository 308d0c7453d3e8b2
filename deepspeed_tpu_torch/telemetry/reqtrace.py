"""dstpu reqtrace — per-request timeline stitching across the fleet (port
of ``deepspeed_tpu/telemetry/reqtrace.py``).

This module answers "where did REQUEST X's latency go" by joining the
router's and every replica's rings on the fleet-wide **trace id** (minted
at the router, propagated via the ``X-Dstpu-Trace`` header / ``trace_id``
body field, stamped on every ``req/*`` span — see ``telemetry/names.py``).

Per trace id, the stitched timeline holds:

* the router's ``req/wall`` **envelope** — the router-observed wall time
  from route entry to the terminal verdict, the denominator every other
  number is stated against;
* per-replica **visit chains** — ``req/queue`` -> ``req/prefill`` ->
  ``req/decode`` retro-spans (shared monotonic edges, so the chain sum
  is exact within each process), grouped by source process;
* **router-attributed gaps** — ``req/reroute`` spans covering failover
  backoffs, the link between a dying replica's chain and its
  survivor's;
* **recovered ledgers** — a replica that died mid-request never emitted
  its retro-spans, but its flight-recorder dump (``serving.server
  .flight_dump``) carries the in-flight ``describe()`` ledgers; those
  fold in as duration-only ``recovered`` entries so the killed attempt
  is visible, not vanished.

**Tie-out invariant**: phase + reroute span time must fit inside the wall
envelope without overlap — ``tie_out_error = (span_sum −
covered_inside_wall) / wall_dur``. In a clean stitch the spans nest
disjointly inside the envelope and the error is ~0; clock misalignment or
a broken trace-id join pushes spans outside the envelope (or on top of
each other) and the error grows past ``TIE_OUT_TOLERANCE`` — the row is
flagged, not trusted. ``req/handoff`` is deliberately OUTSIDE the
conservation sum: it sub-spans the prefill->decode boundary inside time
the phase spans already cover (including it would double-count by
construction).

Clock alignment: each dump's process-identity header pins monotonic ts to
wall time (``crossrank._wall_base_us``); dumps without a header fold in
unaligned (offset 0) and are flagged — their spans still group by trace
id, but their tie-out rows are suspect by definition.

Offline only: it replays whole dumps and never rides a serving path.
CLI: ``python -m deepspeed_tpu_torch.telemetry.reqtrace ring.json
ring_replica*.json flight_replica*.json --out reqtrace.json``.
"""

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Tuple

from deepspeed_tpu_torch.telemetry import crossrank as _crossrank
from deepspeed_tpu_torch.telemetry import names as _names

REQ_PREFIX = _names.REQ_PREFIX
REQ_TRACE_ARG = _names.REQ_TRACE_ARG
REQ_WALL_NAME = _names.REQ_WALL_NAME
REQ_HANDOFF_NAME = _names.REQ_HANDOFF_NAME
REQ_REROUTE_NAME = _names.REQ_REROUTE_NAME
REQ_STAGE_OF = _names.REQ_STAGE_OF

EXIT_OK = 0
EXIT_REGRESSION = 1
EXIT_UNREADABLE = 2

REQTRACE_VERSION = 1
REQTRACE_ARTIFACT_ENV = "DSTPU_REQTRACE_ARTIFACT"
DEFAULT_REQTRACE_ARTIFACT = "reqtrace.json"

#: per-trace tie-out: phase+reroute span time that does not fit inside
#: the wall envelope without overlap, as a fraction of the envelope (the
#: reference's 5% alignment-sanity bar)
TIE_OUT_TOLERANCE = 0.05

#: the conservation sum's members: phase chains + router-attributed
#: gaps. req/wall is the denominator, req/handoff is a sub-span of time
#: the phases already cover (counting it would double-book).
_CONSERVED = frozenset(n for n in REQ_STAGE_OF if n != REQ_HANDOFF_NAME)


class ReqTraceError(Exception):
    """Unreadable/unstitchable input — maps to CLI exit code 2."""


# ---------------------------------------------------------------------------
# dump loading
# ---------------------------------------------------------------------------
def _load_source(path: str, index: int) -> Dict[str, Any]:
    """One dump -> {path, kind, ident, base_us, events, flight}. A flight
    dump is an ordinary Chrome trace whose ``otherData.flight`` carries
    the dying process's in-flight request ledgers."""
    try:
        obj = _crossrank.load_dump(path)
    except _crossrank.CrossRankError as e:
        raise ReqTraceError(str(e)) from e
    ident = _crossrank.dump_identity(obj, fallback_rank=index)
    flight = (obj.get("otherData") or {}).get("flight")
    return {
        "path": path,
        "kind": "flight" if isinstance(flight, dict) else "ring",
        "ident": ident,
        "base_us": _crossrank._wall_base_us(ident),
        "events": [e for e in obj.get("traceEvents", ())
                   if isinstance(e, dict)],
        "flight": flight if isinstance(flight, dict) else None,
    }


def _req_spans(src: Dict[str, Any], src_idx: int
               ) -> Tuple[List[Dict[str, Any]], int]:
    """Extract one source's ``req/*`` complete spans on the shared wall
    axis. Returns ``(spans, malformed)`` — a req/ span without a trace_id
    arg cannot join anything and counts as malformed (an orphan by
    construction)."""
    base = src["base_us"]
    spans: List[Dict[str, Any]] = []
    malformed = 0
    for e in src["events"]:
        name = str(e.get("name", ""))
        if e.get("ph") != "X" or not name.startswith(REQ_PREFIX):
            continue
        args = e.get("args") or {}
        trace_id = args.get(REQ_TRACE_ARG)
        if trace_id is None:
            malformed += 1
            continue
        ts = float(e.get("ts", 0.0))
        dur = max(float(e.get("dur", 0.0)), 0.0)
        start = (base + ts) if base is not None else ts
        spans.append({
            "trace_id": str(trace_id),
            "name": name,
            "source": src_idx,
            "aligned": base is not None,
            "start_us": start,
            "end_us": start + dur,
            "dur_us": dur,
            "args": {k: v for k, v in args.items() if k != REQ_TRACE_ARG},
        })
    return spans, malformed


def _flight_ledgers(src: Dict[str, Any], src_idx: int
                    ) -> List[Dict[str, Any]]:
    """The duration-only recovered entries from one flight dump's
    in-flight/queued request ledgers (``Request.describe()`` dicts)."""
    out: List[Dict[str, Any]] = []
    flight = src["flight"] or {}
    for state_key in ("inflight", "queued"):
        for entry in flight.get(state_key) or ():
            if not isinstance(entry, dict):
                continue
            trace_id = entry.get("trace_id")
            if trace_id is None:
                continue
            out.append({
                "trace_id": str(trace_id),
                "source": src_idx,
                "replica_id": flight.get("replica_id"),
                "reason": flight.get("reason"),
                "was": state_key,
                "state": entry.get("state"),
                "generated_tokens": entry.get("generated_tokens", 0),
                "queue_wait_s": entry.get("queue_wait_s"),
                "ttft_s": entry.get("ttft_s"),
            })
    return out


# ---------------------------------------------------------------------------
# stitching
# ---------------------------------------------------------------------------
def _covered_us(intervals: List[Tuple[float, float]],
                lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]`` — the
    sweep the tie-out compares raw span time against (overlap and
    out-of-envelope time both vanish from the union but not the sum)."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                     if min(b, hi) > max(a, lo))
    total, cur_a, cur_b = 0.0, None, None
    for a, b in clipped:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def stitch_requests(paths: List[str]) -> Dict[str, Any]:
    """Stitch per-process dstrace dumps (router + replicas + recovered
    flight dumps) into per-request timelines keyed by trace id.

    Every trace id with a ``req/wall`` envelope becomes a request row:
    per-source visit chains, reroute links, recovered flight ledgers,
    unattributed gap, and the tie-out verdict. Spans whose trace id has
    no envelope anywhere are **orphans** — counted loudly (an orphan is
    either a dropped router dump or a propagation bug), never silently
    merged away."""
    if not paths:
        raise ReqTraceError("nothing to stitch (no trace paths)")
    sources = [_load_source(p, i) for i, p in enumerate(paths)]

    all_spans: List[Dict[str, Any]] = []
    malformed = 0
    for i, src in enumerate(sources):
        spans, bad = _req_spans(src, i)
        all_spans.extend(spans)
        malformed += bad
    recovered: List[Dict[str, Any]] = []
    for i, src in enumerate(sources):
        if src["flight"] is not None:
            recovered.extend(_flight_ledgers(src, i))

    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in all_spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    rec_by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for r in recovered:
        rec_by_trace.setdefault(r["trace_id"], []).append(r)

    traces: Dict[str, Dict[str, Any]] = {}
    orphan_spans = malformed
    orphan_traces: List[str] = []
    violations: List[str] = []
    max_err = 0.0
    for trace_id in sorted(set(by_trace) | set(rec_by_trace)):
        spans = sorted(by_trace.get(trace_id, ()),
                       key=lambda s: (s["start_us"], s["name"]))
        recs = rec_by_trace.get(trace_id, [])
        walls = [s for s in spans if s["name"] == REQ_WALL_NAME]
        if not walls:
            # no envelope anywhere: every span of this trace is an orphan
            orphan_spans += len(spans)
            orphan_traces.append(trace_id)
            traces[trace_id] = {"wall": None, "spans": spans,
                                "recovered": recs, "orphan": True}
            continue
        wall = walls[0]
        w0, w1 = wall["start_us"], wall["end_us"]
        wall_dur = max(wall["dur_us"], 0.0)
        phases = [s for s in spans
                  if s["name"] in _CONSERVED and s is not wall]
        # per-source visit chains, ordered by first span start — "which
        # replicas served this request, in what order". Reroute spans are
        # router-side gap attribution, not a replica visit.
        chain_spans = [s for s in phases if s["name"] != REQ_REROUTE_NAME]
        visit_order: List[int] = []
        for s in chain_spans:
            if s["source"] not in visit_order:
                visit_order.append(s["source"])
        visits = []
        for src_idx in visit_order:
            chain = [s for s in chain_spans if s["source"] == src_idx]
            visits.append({
                "source": src_idx,
                "pid": sources[src_idx]["ident"]["pid"],
                "stages": [REQ_STAGE_OF.get(s["name"]) for s in chain],
                "start_us": min(s["start_us"] for s in chain),
                "end_us": max(s["end_us"] for s in chain),
                "span_sum_us": sum(s["dur_us"] for s in chain),
            })
        span_sum = sum(s["dur_us"] for s in phases)
        aligned = all(s["aligned"] for s in spans)
        covered = _covered_us([(s["start_us"], s["end_us"])
                               for s in phases], w0, w1)
        # the conservation check: span time that did NOT land inside the
        # envelope as disjoint coverage is overflow — misalignment or a
        # broken join, never real latency
        overflow = max(span_sum - covered, 0.0)
        tie_out_error = (overflow / wall_dur) if wall_dur > 0 else 0.0
        gap_us = max(wall_dur - covered, 0.0)
        reroutes = sum(1 for s in spans if s["name"] == "req/reroute")
        row = {
            "wall": {"start_us": round(w0, 3), "end_us": round(w1, 3),
                     "dur_us": round(wall_dur, 3),
                     "outcome": wall["args"].get("outcome"),
                     "uid": wall["args"].get("uid"),
                     "source": wall["source"]},
            "spans": spans,
            "visits": visits,
            "recovered": recs,
            "reroutes": reroutes,
            "span_sum_us": round(span_sum, 3),
            "covered_us": round(covered, 3),
            "gap_us": round(gap_us, 3),
            "tie_out_error": round(tie_out_error, 6),
            "aligned": aligned,
            "flight_recovered": bool(recs),
            "orphan": False,
        }
        traces[trace_id] = row
        if tie_out_error > TIE_OUT_TOLERANCE:
            violations.append(trace_id)
        max_err = max(max_err, tie_out_error)

    unaligned_sources = [i for i, s in enumerate(sources)
                         if s["base_us"] is None]
    stitched = [t for t, row in traces.items() if not row["orphan"]]
    return {
        "version": REQTRACE_VERSION,
        "sources": [{
            "path": os.path.basename(s["path"]),
            "kind": s["kind"],
            "pid": s["ident"]["pid"],
            "hostname": s["ident"]["hostname"],
            "aligned": s["base_us"] is not None,
            "flight_reason": (s["flight"] or {}).get("reason")
            if s["flight"] else None,
        } for s in sources],
        "alignment": ("wall_anchor" if not unaligned_sources
                      else ("none" if len(unaligned_sources) == len(sources)
                            else "partial")),
        "unaligned_sources": unaligned_sources,
        "traces": traces,
        "requests_stitched": len(stitched),
        "orphan_spans": orphan_spans,
        "orphan_traces": orphan_traces,
        "recovered_requests": len(recovered),
        "flight_dumps": sum(1 for s in sources if s["kind"] == "flight"),
        "tie_out_violations": violations,
        "max_tie_out_error": round(max_err, 6),
    }


# ---------------------------------------------------------------------------
# rendering + CLI
# ---------------------------------------------------------------------------
def render(report: Dict[str, Any], top: int = 20) -> str:
    out = []
    out.append("dstpu reqtrace — per-request fleet timelines")
    out.append(f"{len(report['sources'])} sources "
               f"({report['flight_dumps']} flight dumps) | alignment "
               f"{report['alignment']} | {report['requests_stitched']} "
               f"requests stitched, {report['orphan_spans']} orphan spans, "
               f"{report['recovered_requests']} recovered from flight "
               f"dumps | max tie-out error "
               f"{report['max_tie_out_error'] * 100:.2f}%")
    out.append("")
    out.append(f"{'trace id':<22} {'wall ms':>9} {'visits':>7} "
               f"{'reroutes':>9} {'gap ms':>8} {'tie-out':>8}  flags")
    out.append("-" * 78)
    rows = [(t, r) for t, r in report["traces"].items() if not r["orphan"]]
    rows.sort(key=lambda kv: -(kv[1]["wall"]["dur_us"]))
    for trace_id, r in rows[:top]:
        flags = []
        if r["flight_recovered"]:
            flags.append("flight")
        if not r["aligned"]:
            flags.append("UNALIGNED")
        if r["tie_out_error"] > TIE_OUT_TOLERANCE:
            flags.append("TIE-OUT")
        out.append(f"{trace_id:<22} {r['wall']['dur_us'] / 1e3:>9.3f} "
                   f"{len(r['visits']):>7} {r['reroutes']:>9} "
                   f"{r['gap_us'] / 1e3:>8.3f} "
                   f"{r['tie_out_error'] * 100:>7.2f}%  "
                   f"{','.join(flags) or '-'}")
    if len(rows) > top:
        out.append(f"... {len(rows) - top} more requests")
    if report["orphan_traces"]:
        out.append("")
        out.append(f"orphan traces (spans but no req/wall envelope): "
                   f"{report['orphan_traces'][:10]}"
                   + (" ..." if len(report["orphan_traces"]) > 10 else ""))
    return "\n".join(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.telemetry.reqtrace",
        description="stitch router + replica dstrace dumps (and recovered "
                    "flight-recorder dumps) into per-request timelines "
                    "joined on the fleet trace id, with the span/wall "
                    "tie-out check")
    parser.add_argument("traces", nargs="+",
                        help="per-process Chrome-trace JSON dumps (router "
                             "ring, replica rings, flight dumps)")
    parser.add_argument("--out", default=None,
                        help="write the full artifact JSON here "
                             f"(the reference's env_report reads "
                             f"${REQTRACE_ARTIFACT_ENV} or "
                             f"./{DEFAULT_REQTRACE_ARTIFACT})")
    parser.add_argument("--json", action="store_true",
                        help="print the report as JSON instead of a table")
    parser.add_argument("--top", type=int, default=20,
                        help="requests to show (slowest first)")
    args = parser.parse_args(argv)
    try:
        report = stitch_requests(args.traces)
    except ReqTraceError as e:
        print(f"dstpu reqtrace: {e}", file=sys.stderr)
        return EXIT_UNREADABLE
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render(report, top=args.top))
    for trace_id in report["tie_out_violations"]:
        err = report["traces"][trace_id]["tie_out_error"]
        print(f"WARNING: trace {trace_id} spans overflow the wall "
              f"envelope by {err * 100:.1f}% "
              f"(> {TIE_OUT_TOLERANCE * 100:.0f}% tolerance) — broken "
              "clock alignment or trace-id join; treat its row as suspect",
              file=sys.stderr)
    return EXIT_REGRESSION if report["tie_out_violations"] else EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
