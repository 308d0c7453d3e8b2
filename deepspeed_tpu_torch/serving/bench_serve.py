"""bench_serve — open/closed-loop synthetic load for the serving stack
(port of ``deepspeed_tpu/serving/bench_serve.py``, one replica).

Drives an ``InferenceServer`` with deterministic synthetic traffic (burst,
multi-turn, slow-client, low-priority mixes; chaos scenarios ride on
``DSTPU_CHAOS_SERVE_*``) and reports

* p50/p99 TTFT/TPOT derived STRAIGHT from the dstrace request spans
  (``serve/queued`` + ``serve/prefill`` durations per uid; decode span /
  (tokens-1)), which tie out against ``ServingMetrics``;
* the deterministic counter set: demotions/promotions/bytes through the KV
  tiers, sheds and ladder transitions, recomputed tokens from fault
  evictions, quarantines, drift recalibrations, and — the availability
  headline — ``sticky_503`` (degraded latches), which a healthy siege run
  must keep at ZERO;
* the prefix proof set (``report["prefix"]``): cache-hit ratio and the
  prefill-work conservation identity ``saved + computed == total``,
  asserted against the workload's ground-truth shareable-token
  denominator, plus host-tier compression and bytes-per-resident-token.

Closed-loop mode models N concurrent users each waiting for their reply
(lane i issues its requests sequentially); open-loop mode submits on a
fixed arrival schedule regardless of completions (the overload generator:
rejections are counted, not retried). Prompt/token shapes are seeded per
request INDEX, so the workload is identical regardless of thread timing.

The reference's ``compiles_during_measurement`` counter has no counterpart:
the port's decode is eager (no compile to count until decode capture
lands). The fleet lane and ``--verify-plan`` are not ported yet.

CLI: ``python -m deepspeed_tpu_torch.serving.bench_serve --scenario micro``
(tiny random-init fp32 llama, on the card unless ``--device cpu``).
"""

import dataclasses
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.serving.server import (BackpressureError,
                                                InferenceServer,
                                                ServerClosedError)
from deepspeed_tpu_torch.telemetry import hist as dshist
from deepspeed_tpu_torch.telemetry.tracer import _quantile, get_tracer


def _slo_section(snapshots: List[Dict[str, dict]],
                 pre_snapshots: List[Dict[str, dict]]) -> Dict[str, dict]:
    """The SLO proof set: the deterministic ``dstpu_req_*`` log-bucket
    histograms (``telemetry/hist.py``), folded across replicas and stated
    as measured-window deltas (the warmed-run discipline every counter in
    the report follows). Quantiles are bucket upper edges — exact and
    platform-independent, unlike the wall-clock percentile sketches."""
    merged: Dict[str, dshist.LogHistogram] = {}
    for i, snap in enumerate(snapshots):
        pre = pre_snapshots[i] if i < len(pre_snapshots) else {}
        for family, h_snap in snap.items():
            h = dshist.LogHistogram.from_snapshot(h_snap)
            if family in pre:
                h = h.delta_from(dshist.LogHistogram.from_snapshot(
                    pre[family]))
            if family in merged:
                merged[family].merge(h)
            else:
                merged[family] = h
    return {family: {"count": h.count, "sum_s": round(h.sum, 6),
                     "p50_le_s": h.quantile(0.5),
                     "p99_le_s": h.quantile(0.99)}
            for family, h in merged.items()}


@dataclasses.dataclass
class ServeScenario:
    name: str = "micro"
    mode: str = "closed"                 # "closed" | "open"
    num_requests: int = 100
    concurrency: int = 8                 # closed-loop lanes
    prompt_len: Tuple[int, int] = (4, 12)       # [lo, hi) per request
    max_new_tokens: Tuple[int, int] = (2, 5)    # [lo, hi) per request
    turns: int = 1                       # >1: lanes carry history forward
    arrival_interval_s: float = 0.0      # open-loop fixed interarrival
    burst: int = 0                       # open-loop: first K back-to-back
    slow_client_every: int = 0           # every Kth request streams slowly
    slow_client_token_s: float = 0.005
    low_priority_every: int = 0          # every Kth request priority=-1
    # fraction of each prompt drawn from ONE seeded shared pool (the
    # "shared system prompt" of real traffic): request i's prompt starts
    # with pool[:round(frac * len_i)] — deterministic per index, so the
    # shareable-token sum is a ground-truth denominator the report can
    # assert the prefix cache's savings against
    shared_prefix_frac: float = 0.0
    timeout_s: Optional[float] = None
    submit_retry_limit: int = 200        # closed-loop 429 retries/request
    result_timeout_s: float = 300.0
    vocab: int = 128
    seed: int = 0


#: named presets; chaos scenarios are the same workloads run under
#: DSTPU_CHAOS_SERVE_* env knobs (the harness never sets env itself)
SCENARIOS: Dict[str, ServeScenario] = {
    "micro": ServeScenario(name="micro", num_requests=100, concurrency=8),
    "burst": ServeScenario(name="burst", mode="open", num_requests=64,
                           burst=32, arrival_interval_s=0.005,
                           max_new_tokens=(2, 6),
                           prompt_len=(24, 48), shared_prefix_frac=0.5),
    "multi_turn": ServeScenario(name="multi_turn", num_requests=48,
                                concurrency=6, turns=4,
                                prompt_len=(4, 10)),
    "slow_client": ServeScenario(name="slow_client", num_requests=32,
                                 concurrency=4, slow_client_every=2,
                                 max_new_tokens=(4, 8)),
    "overload": ServeScenario(name="overload", mode="open",
                              num_requests=200, arrival_interval_s=0.001,
                              max_new_tokens=(4, 10),
                              low_priority_every=3,
                              prompt_len=(24, 48), shared_prefix_frac=0.5),
    # decode-first scheduling proof workload: a first burst starts
    # decoding, then seeded LONG prompts (several KV blocks each, larger
    # than the tiny engine's 64-token step budget) keep landing mid-decode
    # — unchunked, each arrival serializes every decode behind a full
    # prefill tick; with `serving.scheduler.prefill_chunk_tokens` set, the
    # tick ledger proves prefill never exceeds the cap
    "long_prompt": ServeScenario(name="long_prompt", mode="open",
                                 num_requests=16, burst=4,
                                 arrival_interval_s=0.01,
                                 max_new_tokens=(8, 16),
                                 prompt_len=(48, 96)),
}


def _stats(vals: List[float]) -> Dict[str, float]:
    s = sorted(vals)
    n = len(s)
    return {"count": n,
            "mean_s": (sum(s) / n) if n else 0.0,
            "p50_s": _quantile(s, 0.5),
            "p99_s": _quantile(s, 0.99),
            "max_s": s[-1] if n else 0.0}


def _shared_pool(scenario: ServeScenario) -> List[int]:
    """The one shared token pool every request's shared prefix is cut
    from — seeded by the scenario seed ONLY (identical across indices,
    the definition of 'shared')."""
    rng = np.random.default_rng(scenario.seed * 7_919 + 1)
    return [int(t) for t in rng.integers(1, scenario.vocab, 256)]


def _request_shape(scenario: ServeScenario, index: int
                   ) -> Tuple[List[int], int, int, int]:
    """Deterministic (prompt, max_new, priority, shared_len) for request
    ``index`` — a pure function of (seed, index), independent of thread
    timing. ``shared_len`` is the prompt's leading run drawn from the
    shared pool (0 when ``shared_prefix_frac`` is off): summed over the
    run it is the ground-truth shareable-token denominator the prefix
    counters are asserted against."""
    rng = np.random.default_rng(scenario.seed * 100_003 + index)
    lo, hi = scenario.prompt_len
    n = int(rng.integers(lo, max(hi, lo + 1)))
    prompt = [int(t) for t in rng.integers(1, scenario.vocab, n)]
    shared_len = 0
    if scenario.shared_prefix_frac > 0.0:
        pool = _shared_pool(scenario)
        shared_len = min(int(round(n * scenario.shared_prefix_frac)),
                         len(pool))
        prompt = pool[:shared_len] + prompt[shared_len:]
    mlo, mhi = scenario.max_new_tokens
    max_new = int(rng.integers(mlo, max(mhi, mlo + 1)))
    priority = (-1 if scenario.low_priority_every
                and index % scenario.low_priority_every == 0 else 0)
    return prompt, max_new, priority, shared_len


def _span_latencies(events, exclude_uids=()) -> Tuple[List[float], List[float]]:
    """Rebuild per-request TTFT/TPOT from the dstrace request spans: TTFT
    = queued.dur + prefill.dur; TPOT = decode.dur / (tokens - 1).
    ``exclude_uids`` drops warm-wave requests — they pay the first-call
    costs on purpose and must never land in the measured percentiles."""
    queued: Dict[int, float] = {}
    prefill: Dict[int, float] = {}
    decode: Dict[int, Tuple[float, int]] = {}
    exclude = set(exclude_uids)
    for e in events:
        _eid, name, _cat, ph, _ts, dur, _tid, args = e
        if ph != "X" or not args or "uid" not in args:
            continue
        uid = args["uid"]
        if uid in exclude:
            continue
        if name == "serve/queued":
            queued[uid] = dur
        elif name == "serve/prefill":
            prefill[uid] = dur
        elif name == "serve/decode":
            decode[uid] = (dur, int(args.get("tokens", 0)))
    ttft = [queued[u] + prefill[u] for u in prefill if u in queued]
    tpot = [dur / (tokens - 1) for dur, tokens in decode.values()
            if tokens > 1]
    return ttft, tpot


def warm_scenario(server: InferenceServer, scenario: ServeScenario
                  ) -> Tuple[int, List[int]]:
    """Warm the serving path with the scenario's exact shape space BEFORE
    the measured run: one wave per decode-batch bucket the measured
    concurrency can reach (all wave members share the same max_new so they
    decode TOGETHER at exactly that bucket), prompts from a shifted seed
    space with the shared-prefix pool disabled, so warming never
    pre-populates the prefix reuse the measured run's ground-truth
    accounting is asserted against. Returns ``(issued, uids)`` so the
    caller can subtract the warm wave from the measured report."""
    from deepspeed_tpu_torch.inference.v2.scheduler import snap_bucket
    warm_sc = dataclasses.replace(scenario, seed=scenario.seed + 104_729,
                                  shared_prefix_frac=0.0)
    conc = max(scenario.concurrency, 1)
    try:
        buckets = sorted({snap_bucket(
            n, server.engine.config.decode_batch_buckets)
            for n in range(1, conc + 1)})
    except AttributeError:        # engine without decode buckets: one wave
        buckets = [conc]
    # the LONGEST declared shapes: prompts stretched to the range max and
    # the max generation length, so the deepest context bucket (and every
    # shallower one passed through while decoding) runs now
    max_prompt = max(scenario.prompt_len[1] - 1, scenario.prompt_len[0], 1)
    warm_new = max(scenario.max_new_tokens[1] - 1,
                   scenario.max_new_tokens[0], 2)
    idx = 0
    issued = 0
    warm_uids: List[int] = []
    for bucket in buckets:
        reqs = []
        for _ in range(bucket):
            prompt, _max_new, _prio, _shared = _request_shape(warm_sc, idx)
            idx += 1
            prompt = (prompt * (max_prompt // len(prompt) + 1))[:max_prompt]
            try:
                reqs.append(server.submit(prompt, max_new_tokens=warm_new))
            except BackpressureError:
                break   # tiny pools: whatever got in still warms shapes
        issued += len(reqs)
        warm_uids.extend(r.uid for r in reqs)
        for r in reqs:
            try:
                r.wait(timeout=scenario.result_timeout_s)
            except Exception:
                r.cancel()
    return issued, warm_uids


class _Lane:
    """One closed-loop user: issues its assigned request indices in order,
    retrying 429s with the server's own Retry-After hint (bounded), and
    carrying multi-turn history forward."""

    def __init__(self, server: InferenceServer, scenario: ServeScenario,
                 indices: List[int], results: dict, lock: threading.Lock):
        self.server = server
        self.scenario = scenario
        self.indices = indices
        self.results = results
        self.lock = lock
        self.history: List[int] = []

    def run(self):
        sc = self.scenario
        max_ctx = self.server.engine.state.max_context_length
        for turn in range(max(sc.turns, 1)):
            for index in self.indices:
                prompt, max_new, priority, shared_len = _request_shape(
                    sc, index + turn * sc.num_requests)
                reusable = 0
                if sc.turns > 1:
                    # TRUE conversation continuation: the next turn's
                    # prompt starts with EXACTLY the previous turn's
                    # prompt + reply (the root prefix the radix cache
                    # reuses). Never slice a suffix of the history —
                    # that would break the prefix property and make the
                    # hit counters unaccountable; when the conversation
                    # outgrows the context, start a fresh one instead
                    if self.history and (len(self.history) + len(prompt)
                                         + max_new + 1 <= max_ctx):
                        prompt = self.history + prompt
                        reusable = len(self.history)
                    else:
                        self.history = []
                        reusable = shared_len
                else:
                    reusable = shared_len
                record = self._one(index, turn, prompt, max_new, priority)
                record["reusable_tokens"] = reusable
                if sc.turns > 1 and record.get("tokens") is not None:
                    self.history = (prompt + record["tokens"])
                with self.lock:
                    self.results[(turn, index)] = record

    def _one(self, index: int, turn: int, prompt, max_new, priority) -> dict:
        sc = self.scenario
        retries = 0
        while True:
            try:
                req = self.server.submit(prompt, max_new_tokens=max_new,
                                         timeout_s=sc.timeout_s,
                                         priority=priority)
                break
            except BackpressureError as e:
                retries += 1
                if retries > sc.submit_retry_limit:
                    return {"state": "gave_up", "retries": retries}
                time.sleep(min(e.retry_after_s, 0.02))
            except ServerClosedError:
                return {"state": "refused", "retries": retries}
        slow = (sc.slow_client_every
                and index % sc.slow_client_every == 0)
        try:
            if slow:
                for _tok in req.stream(timeout=sc.result_timeout_s):
                    time.sleep(sc.slow_client_token_s)
            else:
                req.wait(timeout=sc.result_timeout_s)
        except Exception:
            req.cancel()
            req.wait(timeout=10.0)
        return {"state": req.state.value, "uid": req.uid,
                "tokens": list(req.tokens), "retries": retries,
                "finish_reason": req.finish_reason}


def run_scenario(server: InferenceServer, scenario: ServeScenario,
                 provenance: Optional[dict] = None,
                 warmup: bool = False) -> dict:
    """Drive ``server`` (already started) with the scenario; drains it at
    the end and returns the report dict. The process-global tracer is
    enabled for the run if it wasn't (the span-derived latency section
    depends on it).

    The report carries a ``provenance`` section — preset name, seed, the
    full scenario and resolved serving config, and the DSTPU_TRACE dump
    path — so a later run can re-execute the SAME seeded preset. Caller-
    supplied ``provenance`` keys
    (e.g. an explicit ``trace_path``, the builder args) merge over the
    auto-filled ones."""
    tracer = get_tracer()
    if not tracer.enabled:
        tracer.configure(enabled=True)
    warm_requests, warm_uids = warm_scenario(server, scenario) \
        if warmup else (0, [])
    # measurement marks: the warm wave pays the first-call costs and
    # full-bucket traffic ON PURPOSE — snapshot every cumulative counter
    # here so nothing it did leaks into the measured proof set (its uids
    # are likewise dropped from the span-derived latency percentiles below)
    if hasattr(server.engine, "sched_mark"):
        # reset the tick-ledger window maxima (max prefill tokens/tick,
        # max decode stall) so the scheduler proof set below covers the
        # measured window only, like every other counter here
        server.engine.sched_mark()
    pre_snap = server.metrics.snapshot() if warmup else {}
    pre_slo = server.metrics.slo_snapshot() if warmup else {}
    pre_prefix = (server.engine.prefix_stats()
                  if warmup and hasattr(server.engine, "prefix_stats")
                  else {})
    results: dict = {}
    lock = threading.Lock()
    t0 = time.monotonic()
    if scenario.mode == "closed":
        lanes = [
            _Lane(server, scenario,
                  list(range(i, scenario.num_requests, scenario.concurrency)),
                  results, lock)
            for i in range(max(scenario.concurrency, 1))]
        threads = [threading.Thread(target=lane.run, daemon=True,
                                    name=f"bench-lane-{i}")
                   for i, lane in enumerate(lanes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    elif scenario.mode == "open":
        pending = []
        for index in range(scenario.num_requests):
            prompt, max_new, priority, shared_len = _request_shape(
                scenario, index)
            if index >= scenario.burst and scenario.arrival_interval_s > 0:
                time.sleep(scenario.arrival_interval_s)
            try:
                pending.append((index, shared_len, server.submit(
                    prompt, max_new_tokens=max_new,
                    timeout_s=scenario.timeout_s, priority=priority)))
            except BackpressureError:
                results[(0, index)] = {"state": "rejected"}
            except ServerClosedError:
                results[(0, index)] = {"state": "refused"}
        for index, shared_len, req in pending:
            req.wait(timeout=scenario.result_timeout_s)
            results[(0, index)] = {"state": req.state.value, "uid": req.uid,
                                   "tokens": list(req.tokens),
                                   "finish_reason": req.finish_reason,
                                   "reusable_tokens": shared_len}
    else:
        raise ValueError(f"unknown scenario mode {scenario.mode!r}")
    drained = server.drain(timeout=scenario.result_timeout_s)
    wall_s = time.monotonic() - t0

    snap = server.metrics.snapshot()
    ttft, tpot = _span_latencies(tracer.events_snapshot(),
                                 exclude_uids=warm_uids)

    def measured(key):
        """Cumulative counter -> measured-window delta (identical to the
        raw value on unwarmed runs — pre_snap is empty)."""
        return snap[key] - pre_snap.get(key, 0)
    states: Dict[str, int] = {}
    client_tokens = 0
    for rec in results.values():
        states[rec["state"]] = states.get(rec["state"], 0) + 1
        client_tokens += len(rec.get("tokens") or ())
    ledger = (server.engine.kv_ledger()
              if hasattr(server.engine, "kv_ledger") else {})
    # engine-truth prefix/prefill counters (the metrics mirror can lag
    # one tick; after the drain these are final and exact)
    prefix = (server.engine.prefix_stats()
              if hasattr(server.engine, "prefix_stats") else {})
    if prefix and pre_prefix:
        # warmed run: the monotonic prefix counters become measured-window
        # deltas (occupancy gauges stay live values) and the hit ratio is
        # recomputed over the window — warm traffic is deliberately novel
        # and would otherwise dilute it
        for k in ("prefill_tokens_total", "prefill_tokens_saved",
                  "prefill_tokens_computed", "prefix_lookups",
                  "prefix_hits", "prefix_misses", "prefix_hit_tokens",
                  "prefix_lookup_tokens", "prefix_inserted_blocks",
                  "prefix_evicted_blocks"):
            if k in prefix:
                prefix[k] = prefix[k] - pre_prefix.get(k, 0)
        if "prefix_hit_ratio" in prefix:
            prefix["prefix_hit_ratio"] = (
                prefix.get("prefix_hit_tokens", 0)
                / max(prefix.get("prefix_lookup_tokens", 0), 1))
    if prefix:
        # ground-truth denominator: tokens the workload genuinely made
        # shareable (conversation histories + shared-pool prefixes); the
        # cache can never legitimately save more than this
        prefix["expected_reusable_tokens"] = sum(
            rec.get("reusable_tokens", 0) for rec in results.values())
        prefix["conservation_ok"] = (
            prefix.get("prefill_tokens_saved", 0)
            + prefix.get("prefill_tokens_computed", 0)
            == prefix.get("prefill_tokens_total", 0))
        prefix["bytes_per_resident_token"] = \
            snap["bytes_per_resident_token"]
        prefix["host_compression_ratio"] = \
            snap["host_kv_compression_ratio"]
    # scheduler proof set: the engine tick ledger (per-tick prefill-token
    # maxima, cap utilization, decode-gap in ticks). Window maxima cover
    # the measured window (sched_mark above); totals are cumulative, and
    # the conservation check ties them to the engine-truth prefill
    # counter — chunking must neither lose nor duplicate a prompt token.
    sched: dict = {}
    if hasattr(server.engine, "sched_stats"):
        sched_cfg = dict(getattr(server.config, "scheduler", None) or {})
        cap = int(sched_cfg.get("prefill_chunk_tokens", 0) or 0)
        plan_cfg = getattr(getattr(server.engine, "config", None),
                           "scheduler", None)
        # unchunked runs report the decode gap in units of the smallest
        # prefill bucket so a chunked A/B can re-state its gap in the
        # same units (sched_stats(gap_unit_tokens=...))
        unit = cap or (int(plan_cfg.prefill_buckets[0])
                       if plan_cfg is not None and plan_cfg.prefill_buckets
                       else 0)
        sched = server.engine.sched_stats(gap_unit_tokens=unit)
        if hasattr(server.engine, "prefix_stats"):
            computed = int(server.engine.prefix_stats()
                           .get("prefill_tokens_computed", 0))
            sched["prefill_tokens_engine"] = computed
            sched["chunk_conservation_ok"] = \
                sched["chunk_tokens_total"] == computed
    # the SLO proof set + its conservation gate: every measured request
    # that produced a first token lands in the TTFT histogram exactly
    # once (on_finish observes iff first_token_ts is set, and the client
    # record holds tokens iff one fanned out) — a mismatch means a
    # request's latency escaped the SLO accounting
    slo = _slo_section([server.metrics.slo_snapshot()], [pre_slo])
    ttft_n = slo.get("dstpu_req_ttft_seconds", {}).get("count", 0)
    first_token_requests = sum(
        1 for rec in results.values() if rec.get("tokens"))
    slo["conservation"] = {
        "ttft_observations": ttft_n,
        "first_token_requests": first_token_requests,
        "ok": ttft_n == first_token_requests,
    }
    # the atexit dump lands relative to THIS process's cwd — record it
    # absolute
    env_trace = os.environ.get("DSTPU_TRACE")
    prov = {
        "preset": scenario.name,
        "seed": scenario.seed,
        "mode": scenario.mode,
        "num_requests": scenario.num_requests,
        "scenario": dataclasses.asdict(scenario),
        "serving_config": dataclasses.asdict(server.config),
        "trace_path": (os.path.abspath(env_trace) if env_trace else None),
    }
    kv_cfg = getattr(getattr(server.engine, "kv", None), "cfg", None)
    if kv_cfg is not None:
        prov["kv_num_blocks"] = kv_cfg.num_blocks
        prov["kv_block_size"] = kv_cfg.block_size
    if provenance:
        prov.update(provenance)
    return {
        "scenario": dataclasses.asdict(scenario),
        "provenance": prov,
        "wall_s": round(wall_s, 3),
        "drained": drained,
        "requests": {"issued": len(results), "states": states,
                     "client_tokens": client_tokens},
        "metrics": snap,
        # the deterministic proof set (see module docstring) — on warmed
        # runs every entry is the measured-window DELTA over the warm
        # wave's snapshot (identical to the raw counter otherwise)
        "counters": {
            "demotions": measured("kv_demotions"),
            "promotions": measured("kv_promotions"),
            "demoted_bytes": measured("kv_demoted_bytes"),
            "promoted_bytes": measured("kv_promoted_bytes"),
            "sheds": measured("requests_shed"),
            "rejected": measured("requests_rejected"),
            "brownout_entries": measured("brownout_entries"),
            "shed_entries": measured("shed_entries"),
            "ladder_transitions": measured("ladder_transitions"),
            "quarantined": measured("requests_quarantined"),
            "step_faults": measured("engine_step_faults"),
            "recomputed_tokens": measured("recomputed_tokens"),
            "kv_drift_events": measured("kv_drift_events"),
            "kv_recalibrations": measured("kv_recalibrations"),
            "sticky_503": measured("degraded_latches"),
            "prefix_evictions": measured("prefix_evictions"),
            "prefill_tokens_total": prefix.get("prefill_tokens_total", 0),
            "prefill_tokens_saved": prefix.get("prefill_tokens_saved", 0),
            "prefill_tokens_computed":
                prefix.get("prefill_tokens_computed", 0),
            # worst tick's prefill tokens in the measured window — the
            # counter the `prefill_chunk_tokens` plan rule predicts on
            "max_prefill_tokens_per_tick":
                sched.get("max_prefill_tokens_per_tick", 0),
        },
        # latency_from_trace + counters are measured-window only; the raw
        # "metrics" mirror (and its percentile sketches) stays cumulative
        "warmed": {"enabled": warmup, "requests": warm_requests},
        "slo": slo,
        "scheduler": sched,
        "prefix": prefix,
        "kv_ledger": ledger,
        "ladder": {"level": server.ladder.level.name.lower(),
                   "transitions": dict(server.ladder.transitions),
                   "entries": dict(server.ladder.entries)},
        "latency_from_trace": {"ttft_s": _stats(ttft),
                               "tpot_s": _stats(tpot)},
        "latency_from_metrics": {
            "ttft_p50_s": snap["ttft_p50_s"], "ttft_p99_s": snap["ttft_p99_s"],
            "tpot_p50_s": snap["tpot_p50_s"],
        },
    }


# ---------------------------------------------------------------------------
# fleet mode: the reference drives the same workloads through FleetRouter
# ---------------------------------------------------------------------------
def _fleet_not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "the fleet lane of bench_serve is not ported yet: it comes with the "
        "fleet part of the serving-layer slice (ROADMAP Queue 1)")


build_tiny_fleet = stop_tiny_fleet = run_fleet_scenario = _fleet_not_ported


# ---------------------------------------------------------------------------
# CLI — the tiny random-init llama
# ---------------------------------------------------------------------------
def build_tiny_server(kv_num_blocks: int = 64, kv_block_size: int = 16,
                      kv_offload: bool = True,
                      prefix_cache: bool = True,
                      host_kv_quantize: str = "int8",
                      serving_overrides: Optional[dict] = None,
                      device=None) -> InferenceServer:
    """The benchmark target: tiny random-init fp32 llama (weights from
    seed 0) + small KV pool so tier/ladder behavior shows at micro request
    counts. On the card unless ``device="cpu"``."""
    import torch

    from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,
                                                            V2EngineConfig)
    from deepspeed_tpu_torch.inference.v2.scheduler import SchedulerConfig
    from deepspeed_tpu_torch.models.convert import init_llama_params
    from deepspeed_tpu_torch.models.llama import TINY_LLAMA
    from deepspeed_tpu_torch.serving.server import ServingConfig

    sched_group = dict((serving_overrides or {}).get("scheduler") or {})
    if sched_group.get("role_split"):
        raise NotImplementedError(
            "the prefill/decode role split (serving/disagg.py) is not ported "
            "yet: it comes with the serving-layer slice (ROADMAP Queue 1)")
    cfg = dataclasses.replace(TINY_LLAMA, dtype=torch.float32,
                              max_seq_len=512)
    params = init_llama_params(cfg, seed=0, device=device)
    engine = InferenceEngineV2(params, cfg, V2EngineConfig(
        kv_block_size=kv_block_size, kv_num_blocks=kv_num_blocks,
        scheduler=SchedulerConfig(max_tokens_per_step=64,
                                  prefill_buckets=(16, 32, 64))),
        device=device)
    overrides = {"max_queue_depth": 32, "kv_offload_enabled": kv_offload,
                 "kv_demote_watermark": 0.5,
                 "kv_demote_watermark_brownout": 0.3,
                 "prefix_cache_enabled": prefix_cache,
                 "host_kv_quantize": (host_kv_quantize if kv_offload
                                      else "none"),
                 "idle_poll_s": 0.001}
    overrides.update(serving_overrides or {})
    return InferenceServer(engine, ServingConfig(**overrides))


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.serving.bench_serve",
        description=__doc__)
    p.add_argument("--scenario", default="micro",
                   choices=sorted(SCENARIOS))
    p.add_argument("--requests", type=int, default=None,
                   help="override the scenario's num_requests")
    p.add_argument("--concurrency", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--kv-num-blocks", type=int, default=64)
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--replicas", type=int, default=1,
                   help="more than 1 runs the fleet lane (not ported yet)")
    p.add_argument("--no-kv-offload", action="store_true",
                   help="run with the offload tier disabled (pre-tier "
                        "admission semantics)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="run with the radix prefix cache disabled "
                        "(every prompt prefills from scratch)")
    p.add_argument("--host-kv-quantize", default="int8",
                   choices=("none", "int8", "fp8"),
                   help="host-tier page codec for demoted KV")
    p.add_argument("--shared-prefix-frac", type=float, default=None,
                   help="override the scenario's shared-prefix fraction "
                        "(0.0 disables; seeded, deterministic per index)")
    p.add_argument("--warm", action="store_true",
                   help="warm the serving path with the scenario's shape "
                        "distribution before measuring")
    p.add_argument("--json", default=None,
                   help="write the full report JSON here (stdout always "
                        "gets it too)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="dump the dstrace ring here after the run and "
                        "record it in the report's provenance")
    p.add_argument("--serving-overrides", default=None, metavar="JSON",
                   help="serving-config override dict applied to the "
                        "tiny server (e.g. '{\"kv_demote_watermark\": "
                        "0.5}') — recorded in provenance")
    p.add_argument("--verify-plan", default=None, metavar="PLAN",
                   help="re-execute a serve plan's proposals (not ported "
                        "yet)")
    args = p.parse_args(argv)

    if args.verify_plan:
        raise NotImplementedError(
            "--verify-plan (autotuning/serve_verify.py) is not ported yet: "
            "it comes after the serving-layer slice (ROADMAP Queue 1)")
    if args.replicas > 1:
        _fleet_not_ported()

    scenario = SCENARIOS[args.scenario]
    patch = {}
    if args.requests is not None:
        patch["num_requests"] = args.requests
    if args.concurrency is not None:
        patch["concurrency"] = args.concurrency
    if args.seed is not None:
        patch["seed"] = args.seed
    if args.shared_prefix_frac is not None:
        patch["shared_prefix_frac"] = args.shared_prefix_frac
    if patch:
        scenario = dataclasses.replace(scenario, **patch)

    serving_overrides = (json.loads(args.serving_overrides)
                         if args.serving_overrides else {})
    builder = {"kv_num_blocks": args.kv_num_blocks,
               "kv_block_size": args.kv_block_size,
               "kv_offload": not args.no_kv_offload,
               "prefix_cache": not args.no_prefix_cache,
               "host_kv_quantize": args.host_kv_quantize,
               "serving_overrides": serving_overrides}
    provenance = {"builder": dict(builder, device=args.device)}
    if args.trace:
        provenance["trace_path"] = os.path.abspath(args.trace)
    server = build_tiny_server(device=args.device, **builder).start()
    try:
        report = run_scenario(server, scenario, provenance=provenance,
                              warmup=args.warm)
    finally:
        server.stop(drain_timeout=30.0)
    if args.trace:
        get_tracer().export_chrome(args.trace)
    text = json.dumps(report, indent=2, default=str)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    slo_cons = (report.get("slo") or {}).get("conservation") or {}
    if slo_cons and not slo_cons.get("ok"):
        # explicit check, not assert: python -O must not strip the proof,
        # and the CLI keeps its exit-code discipline
        print("bench_serve: SLO conservation identity failed — "
              f"{slo_cons} (a request's latency escaped the dstpu_req_* "
              "histograms, or was double-counted)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
