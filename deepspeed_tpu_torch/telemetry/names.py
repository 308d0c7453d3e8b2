"""Canonical trace-name registry (copy of
``deepspeed_tpu/telemetry/names.py``) — THE one place a span, instant or
counter name is declared.

Every name a ``Tracer.span/instant/counter/complete`` call of the port
emits as a literal must appear in :data:`TRACE_NAMES` with the kind it is
emitted as, and an f-string name must start with a :data:`DYNAMIC_PREFIXES`
entry (``tests/test_torch_serving.py`` scans the serving layer for both),
so a renamed span cannot silently fall out of the consumers that key on
it: ``bench_serve``'s span-derived latencies, the ``/metrics`` span
summaries and the smoke's tick-stage shares. The registry is the
reference's, names of layers the port has not carried yet included.

Stdlib-only pure data.
"""

from typing import Dict, Tuple

#: every literal trace name the package emits, mapped to the event kinds
#: it may be emitted as.
TRACE_NAMES: Dict[str, Tuple[str, ...]] = {
    # -- training engine ---------------------------------------------------
    "engine/train_step": ("span",),
    "engine/dispatch": ("span",),
    "engine/drain": ("span",),              # DispatchRing's drain span
    "engine/steps_reconciled": ("complete",),
    "engine/overflow_step": ("instant",),
    "comm/h2d": ("span",),
    "comm/overlap": ("complete",),
    "ckpt/save": ("span",),
    "ckpt/load": ("span",),
    "prefetch/next": ("span",),
    "prefetch/stage": ("span",),
    "xla/compile": ("instant",),
    # -- memory telemetry --------------------------------------------------
    "mem/oom": ("instant",),
    "mem/see_memory_usage": ("instant",),
    "mem/hbm_bytes_in_use": ("counter",),
    "mem/hbm_peak_bytes": ("counter",),
    "mem/hbm_bytes_limit": ("counter",),
    "mem/host_rss_bytes": ("counter",),
    # -- collective guard / membership ------------------------------------
    "comm/init_retry": ("instant",),
    "comm/init_wedge": ("instant",),
    "comm/op_failed": ("instant",),
    "comm/wedge": ("instant",),
    "comm/straggler": ("instant",),
    # -- resilience --------------------------------------------------------
    "resilience/bad_step": ("instant",),
    "resilience/lr_backoff": ("instant",),
    "resilience/quarantine": ("instant",),
    "resilience/comm_fault": ("instant",),
    "resilience/preempt_signal": ("instant",),
    "resilience/watchdog_flag": ("instant",),
    # -- chaos drills ------------------------------------------------------
    "chaos/stall": ("complete",),
    "chaos/serve_slow_tick": ("complete",),
    "chaos/ckpt_io_fail": ("instant",),
    "chaos/comm_delay": ("instant",),
    "chaos/comm_wedge": ("instant",),
    "chaos/die": ("instant",),
    "chaos/nan": ("instant",),
    "chaos/oom": ("instant",),
    "chaos/replica_kill": ("instant",),
    "chaos/serve_kv_pressure": ("instant",),
    "chaos/serve_poison": ("instant",),
    # -- elasticity --------------------------------------------------------
    "elastic/peer_lost": ("instant",),
    "elastic/regrow": ("instant",),
    "elastic/shrink_refused": ("instant",),
    "elastic/shrink_planned": ("instant",),
    "elastic/reshard": ("instant",),
    # -- serving tick ------------------------------------------------------
    "serve/tick": ("complete",),
    "serve/engine_step": ("span",),
    "serve/admit": ("span",),
    "serve/demote": ("span",),
    "serve/promote": ("span",),
    "serve/drain": ("span",),
    "serve/step_prefill": ("complete",),
    "serve/step_decode": ("complete",),
    "serve/prefill_chunk": ("complete",),
    "serve/queued": ("complete",),
    "serve/prefill": ("complete",),
    "serve/decode": ("complete",),
    "serve/kv_bytes": ("counter",),
    "serve/tick_stage_share": ("counter",),
    "serve/kv_tier": ("counter",),
    "serve/prefix_cache": ("counter",),
    "serve/backpressure": ("instant",),
    "serve/degraded": ("instant",),
    "serve/evicted": ("instant",),
    "serve/kv_demote": ("instant",),
    "serve/kv_promote": ("instant",),
    "serve/kv_recalibrate": ("instant",),
    "serve/kv_drift": ("instant",),
    "serve/ladder": ("instant",),
    "serve/prefix_evict": ("instant",),
    "serve/prefix_handoff_adopt": ("instant",),
    "serve/prefix_handoff_export": ("instant",),
    "serve/quarantine": ("instant",),
    "serve/recovered": ("instant",),
    "serve/step_fault": ("instant",),
    "serve/flight_dump": ("instant",),
    # -- per-request tracing (trace_id-scoped; reqtrace.py stitches) -------
    "req/queue": ("complete",),
    "req/prefill": ("complete",),
    "req/decode": ("complete",),
    "req/handoff": ("complete",),
    "req/reroute": ("complete",),
    "req/wall": ("complete",),
    # -- disaggregated prefill/decode -------------------------------------
    "disagg/tick": ("complete",),
    "disagg/handoff": ("instant",),
    # -- fleet router ------------------------------------------------------
    "fleet/poll_tick": ("span",),
    "fleet/rotation": ("counter",),
    "fleet/load": ("counter",),
    "fleet/handoff": ("instant",),
    "fleet/out_of_rotation": ("instant",),
    "fleet/replica_lost": ("instant",),
    "fleet/replica_relaunched": ("instant",),
    "fleet/request_lost": ("instant",),
    "fleet/reroute": ("instant",),
    "fleet/retire": ("instant",),
    "fleet/scale_out": ("instant",),
    "fleet/spill": ("instant",),
    "fleet/flight_recovered": ("instant",),
}

#: f-string names are allowed when their literal head starts with one of
#: these (per-state request transitions); every other name is a literal
#: registered above.
DYNAMIC_PREFIXES: Tuple[str, ...] = ("comm/", "serve/")
