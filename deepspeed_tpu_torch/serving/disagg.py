"""Prefill/decode disaggregation: a role-split engine pair in one process
(port of ``deepspeed_tpu/serving/disagg.py``).

DeepSpeed-MII's split: one ``InferenceEngineV2`` owns the prefill role
(admission, prefix cache, chunked SplitFuse prefill), a second owns the
decode role (steady-state decode batches, the KV offload tier). The
boundary is a block-granular KV handoff through ``HostKVStore`` + the
quantized page codec
(``kv_offload.quantize_pages``) — the fleet handoff-file path generalized
to in-process adoption (``InferenceEngineV2.adopt_kv_handoff``): demote
out of the prefill engine, adopt into the decode engine, no filesystem.

``DisaggregatedEngine`` presents the single-engine serving surface, so
``InferenceServer`` drives the pair unchanged. Gated behind
``serving.scheduler.role_split`` (default off = one engine, today's
semantics).

Handoff correctness envelope: "none" codec round-trips pages bit-identical
(device-fp8 pages always travel full-width with their scales); "int8"/
"fp8" round-trips are tolerance-bounded by ``quantize_error_bound``. Under
greedy sampling the handed-off sequence continues to the same tokens as a
single-engine run (``tests/test_torch_disagg.py``).

The two role engines may share one set of weights (``params`` is read,
never copied or moved, by ``InferenceEngineV2``); each has its own KV pool.
The handoff is a device-to-host gather, the host codec and a host-to-device
scatter of the sequence's pages.
"""

import time
from typing import Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.runtime.sched import TickLedger
from deepspeed_tpu_torch.telemetry.tracer import get_tracer


class _PairStateView:
    """The two role engines' sequence tables behind the single-engine
    ``engine.state`` read surface the serve loop uses (get/contains/len/
    all + max_context_length). Admission writes go through the pair's
    ``admit``, never through this view."""

    def __init__(self, prefill, decode):
        self._p = prefill
        self._d = decode

    @property
    def max_context_length(self) -> int:
        return self._d.state.max_context_length

    @property
    def max_tracked_sequences(self) -> int:
        return self._d.state.max_tracked_sequences

    def get(self, uid: int):
        seq = self._d.state.get(uid)
        return seq if seq is not None else self._p.state.get(uid)

    def all(self):
        return list(self._p.state.all()) + list(self._d.state.all())

    def __contains__(self, uid: int) -> bool:
        return uid in self._p.state or uid in self._d.state

    def __len__(self) -> int:
        return len(self._p.state) + len(self._d.state)


class DisaggregatedEngine:
    """Drives a prefill-role/decode-role ``InferenceEngineV2`` pair as one
    engine: admission and prefix cache on the prefill engine, the KV
    offload tier and steady-state decode on the decode engine, and the
    block-granular KV handoff between them inside ``step()``."""

    def __init__(self, prefill_engine, decode_engine,
                 handoff_quantize: str = "none"):
        if prefill_engine.kv.cfg.block_size != \
                decode_engine.kv.cfg.block_size:
            raise ValueError(
                "role engines must share KV block geometry: "
                f"{prefill_engine.kv.cfg.block_size} != "
                f"{decode_engine.kv.cfg.block_size}")
        self.prefill = prefill_engine
        self.decode = decode_engine
        self.handoff_quantize = handoff_quantize
        self.state = _PairStateView(prefill_engine, decode_engine)
        self.sched_ledger = TickLedger()
        self.last_step_timing = {"prefill_s": 0.0, "decode_s": 0.0}
        self.last_step_counters = {"prefill_tokens": 0, "chunks": 0,
                                   "decode_tokens": 0}
        self.handoff_stats = {"handoffs": 0, "handoff_blocks": 0,
                              "handoff_bytes": 0, "handoff_raw_bytes": 0,
                              "handoff_deferred": 0}
        # (uid, seconds) per completed handoff since the last drain — the
        # serve loop pops these each tick and folds them into the SLO
        # histograms (and the traced request's req/handoff span)
        self._handoff_latencies: List[Tuple[int, float]] = []

    # -- pass-through config surfaces ----------------------------------
    @property
    def config(self):
        return self.decode.config

    @property
    def kv(self):
        # tier planning (demotions/promotions, free-block headroom) is a
        # decode-role concern — that's where sequences live out their KV
        return self.decode.kv

    @property
    def prefix_cache(self):
        return self.prefill.prefix_cache

    def enable_prefix_cache(self, max_cached_blocks: int = 0) -> None:
        self.prefill.enable_prefix_cache(max_cached_blocks)

    def configure_chunked_prefill(self, prefill_chunk_tokens: int) -> None:
        self.prefill.configure_chunked_prefill(prefill_chunk_tokens)

    # -- admission (prefill role) --------------------------------------
    def query(self, uid: int, max_request_length: int) -> Tuple[int, int]:
        return self.prefill.query(uid, max_request_length)

    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> bool:
        fresh = [u for u in uids if u not in self.state]
        return self.prefill.can_schedule(uids, lengths) and \
            len(self.decode.state) + len(fresh) <= \
            self.decode.state.max_tracked_sequences

    def admit(self, uid: int, prompt_tokens: Sequence[int]):
        return self.prefill.admit(uid, prompt_tokens)

    # -- the step: prefill role, handoff, decode role ------------------
    def step(self) -> Dict[int, int]:
        t0 = time.perf_counter()
        out = self.prefill.step()
        out.update(self.decode.step())
        # handoff AFTER both role steps: a uid is resident on exactly one
        # engine at plan time, so the merged dict never clobbers a token
        # and the pair keeps the single-engine one-token-per-tick cadence
        # (adopting between the steps would decode the fresh sequence a
        # second time in the same tick, dropping its first token)
        self._handoff()
        pc, dc = self.prefill.last_step_counters, self.decode.last_step_counters
        pt, dt = self.prefill.last_step_timing, self.decode.last_step_timing
        self.last_step_timing = {
            "prefill_s": pt["prefill_s"] + dt["prefill_s"],
            "decode_s": pt["decode_s"] + dt["decode_s"]}
        counters = {
            "prefill_tokens": pc["prefill_tokens"] + dc["prefill_tokens"],
            "chunks": pc["chunks"] + dc["chunks"],
            "decode_tokens": pc["decode_tokens"] + dc["decode_tokens"]}
        self.last_step_counters = counters
        if counters["chunks"] or counters["decode_tokens"]:
            # the pair's OWN ledger sees one combined tick — decode-stall
            # semantics (prefill tokens a decode tick waited behind) apply
            # to the pair as a unit, not to each role engine alone
            self.sched_ledger.observe_tick(
                counters["prefill_tokens"], counters["chunks"],
                counters["decode_tokens"],
                cap=self.prefill.config.scheduler.prefill_chunk_tokens)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.complete("disagg/tick", time.perf_counter() - t0,
                            cat="serve",
                            prefill_tokens=counters["prefill_tokens"],
                            decode_tokens=counters["decode_tokens"],
                            chunks=counters["chunks"])
        return out

    def _handoff(self) -> None:
        """Move every sequence that finished prefill this tick across the
        role boundary: demote its pages out of the prefill engine (the
        codec path tier demotion uses), adopt them into the decode
        engine, drop the donor-side residue. A decode engine that can't
        cover the entry right now defers the sequence (it stays paused
        with its host entry, invisible to the prefill planner) and the
        handoff retries next tick."""
        for seq in list(self.prefill.state.all()):
            if seq.done or seq.in_prefill:
                continue
            uid = seq.uid
            # per-handoff latency window: demote -> adopt for this tick's
            # attempt. A deferred handoff accrues only its successful
            # retry tick's work — the wait between ticks is queue time,
            # already visible as the gap before the handoff span.
            t_h0 = time.perf_counter()
            if not seq.paused:
                # freshly completed prefill (first token already sampled):
                # gather+release its pages into the prefill engine's host
                # store through the handoff codec
                self.prefill.demote_kv(uid, quantize=self.handoff_quantize)
            entry = self.prefill.host_kv.get(uid)
            if entry is None:
                continue
            if self.decode.adopt_kv_handoff(uid, seq.prompt_tokens,
                                            seq.generated, entry):
                self.prefill.host_kv.pop(uid)
                self.prefill.state.pop(uid)
                lat_s = time.perf_counter() - t_h0
                self.handoff_stats["handoffs"] += 1
                self.handoff_stats["handoff_blocks"] += entry.blocks
                self.handoff_stats["handoff_bytes"] += entry.nbytes
                self.handoff_stats["handoff_raw_bytes"] += entry.raw_nbytes
                self._handoff_latencies.append((uid, lat_s))
                get_tracer().instant("disagg/handoff", cat="serve",
                                     uid=uid, blocks=entry.blocks,
                                     bytes=entry.nbytes,
                                     quantize=self.handoff_quantize)
            else:
                self.handoff_stats["handoff_deferred"] += 1

    def pop_handoff_latencies(self) -> List[Tuple[int, float]]:
        """Drain the completed-handoff latencies accumulated since the
        last call: ``[(uid, seconds), ...]``. The serve loop calls this
        each tick to feed the handoff SLO histogram and, for traced
        requests, the ``req/handoff`` span."""
        out = self._handoff_latencies
        self._handoff_latencies = []
        return out

    # -- lifecycle -----------------------------------------------------
    def finish(self, uid: int) -> None:
        self.prefill.finish(uid)
        self.decode.finish(uid)

    def finished_uids(self) -> List[int]:
        return self.prefill.finished_uids() + self.decode.finished_uids()

    def reap_finished(self) -> Dict[int, List[int]]:
        out = self.prefill.reap_finished()
        out.update(self.decode.reap_finished())
        return out

    def flush(self, uid: int) -> List[int]:
        if uid in self.prefill.state:
            return self.prefill.flush(uid)
        return self.decode.flush(uid)

    def has_work(self) -> bool:
        # a deferred handoff is paused on the prefill engine (its own
        # has_work ignores paused) but is very much pending work here
        return any(not s.done for s in self.prefill.state.all()) or \
            self.decode.has_work()

    # -- KV tier hooks (decode role) -----------------------------------
    def demote_kv(self, uid: int, quantize: str = "none") -> int:
        return self.decode.demote_kv(uid, quantize=quantize)

    def promote_kv(self, uid: int) -> Optional[int]:
        return self.decode.promote_kv(uid)

    def demoted_uids(self) -> List[int]:
        return self.decode.demoted_uids()

    def demoted_blocks(self, uid: int) -> int:
        return self.decode.demoted_blocks(uid)

    def kv_held_blocks(self, uid: int) -> int:
        return self.prefill.kv_held_blocks(uid) + \
            self.decode.kv_held_blocks(uid)

    def host_kv_bytes(self) -> int:
        # deferred handoff entries sit in the prefill engine's store until
        # adoption — they are host bytes all the same
        return self.prefill.host_kv_bytes() + self.decode.host_kv_bytes()

    # -- prefix handoff files (prefill role owns the cache) ------------
    def export_prefix_handoff(self, path: str,
                              quantize: str = "none") -> Dict[str, int]:
        return self.prefill.export_prefix_handoff(path, quantize=quantize)

    def import_prefix_handoff(self, path: str) -> Dict[str, int]:
        return self.prefill.import_prefix_handoff(path)

    def evict_prefix_blocks(self, want: int) -> int:
        return self.prefill.evict_prefix_blocks(want)

    # -- gauges (pair sums) --------------------------------------------
    def kv_usable_blocks(self) -> int:
        return self.prefill.kv_usable_blocks() + \
            self.decode.kv_usable_blocks()

    def kv_reserved_blocks(self) -> int:
        return self.prefill.kv_reserved_blocks() + \
            self.decode.kv_reserved_blocks()

    def kv_occupancy(self) -> float:
        usable = self.kv_usable_blocks()
        return self.kv_reserved_blocks() / max(usable, 1)

    def kv_block_bytes(self) -> int:
        return self.decode.kv_block_bytes()

    def resident_tokens(self) -> int:
        return self.prefill.resident_tokens() + self.decode.resident_tokens()

    def kv_resident_bytes(self) -> int:
        return self.prefill.kv_resident_bytes() + \
            self.decode.kv_resident_bytes()

    def kv_ledger(self) -> Dict[str, int]:
        led = dict(self.prefill.kv_ledger())
        for k, v in self.decode.kv_ledger().items():
            if k == "host_compression_ratio":
                continue
            led[k] = led.get(k, 0) + v
        raw = self.prefill.host_kv.raw_bytes + self.decode.host_kv.raw_bytes
        stored = led["host_bytes"]
        led["host_compression_ratio"] = (raw / stored) if stored else 1.0
        return led

    def prefix_stats(self) -> Dict[str, float]:
        out = dict(self.prefill.prefix_stats())
        for k, v in self.decode.prefix_stats().items():
            if k.endswith("_ratio"):
                continue
            out[k] = out.get(k, 0) + v
        return out

    def speculative_stats(self) -> Dict[str, float]:
        return self.decode.speculative_stats()

    def sched_mark(self) -> None:
        self.sched_ledger.reset_window()
        self.prefill.sched_mark()
        self.decode.sched_mark()

    def sched_stats(self, gap_unit_tokens: int = 0) -> Dict[str, object]:
        return self.sched_ledger.snapshot(
            cap=self.prefill.config.scheduler.prefill_chunk_tokens,
            gap_unit_tokens=gap_unit_tokens)
