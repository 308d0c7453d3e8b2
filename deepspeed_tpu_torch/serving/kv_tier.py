"""Tier policy for the host-RAM KV offload — the decision half (copy of
``deepspeed_tpu/serving/kv_tier.py``).

Storage and page movement live on the engine
(``inference/v2/kv_offload.py`` + ``InferenceEngineV2.demote_kv`` /
``promote_kv``); this module is the pure arithmetic the serve tick runs
every iteration to decide WHO moves. Both planners are hot paths: the
per-tick bookkeeping is plain host-int arithmetic over the request tables
and must never grow a device sync — the actual page copies happen inside
the engine calls the server then issues, off these functions.

Policy:

* **Prefix-cache eviction precedes sequence demotion** — under pressure
  the tick first reclaims UNPINNED cached prefix blocks (capacity nobody
  is reading; freeing them costs no copies and pauses no request), and
  only then demotes live sequences. Pinned shared-prefix pages are never
  discarded: they outlive every unshared page, and when their last
  reader demotes they travel to the host tier inside that reader's
  entry (``demote_kv``) instead of being dropped — the demotion-ordering
  contract: unpinned cache -> unshared sequences (LIFO) -> shared
  prefixes last, via the host tier.
* **Demotion is LIFO over the admit order** — the most recently admitted
  active request spills first, so the oldest requests keep running to
  completion (FIFO fairness preserved; same victim order as vLLM's
  recompute-preemption).
* **Promotion is FIFO over the demotion order** — the longest-demoted
  (most starved) request returns first, as soon as its worst-case blocks
  fit under the capacity line AND its held pages fit in free blocks.
* Two trigger lines: the *capacity* line (worst-case sum of active
  requests must fit under ``watermark x effective usable`` — the
  no-mid-decode-exhaustion invariant, re-established dynamically when
  chaos/pressure shrinks effective capacity) and the *demote* line
  (observed reserved blocks over ``demote_watermark x effective usable``
  — brownout lowers it, demoting more aggressively to keep headroom).
"""

from typing import List, Sequence, Tuple


def effective_usable_blocks(usable: int, stolen_frac: float) -> int:
    """Usable device blocks after chaos/pressure steals ``stolen_frac``
    (the ``DSTPU_CHAOS_SERVE_KV_PRESSURE`` drill surface); never < 1."""
    if stolen_frac <= 0.0:
        return max(usable, 1)
    kept = int(usable * (1.0 - stolen_frac))
    return max(kept, 1)


def plan_prefix_evictions(evictable_blocks: int, over_cap_blocks: int,
                          reserved_blocks: int,
                          demote_line_blocks: float) -> int:
    """How many unpinned cached prefix blocks to reclaim THIS tick,
    before any sequence is considered for demotion: enough to bring
    observed reservation back under the demote line (pressure relief
    that costs no copies and pauses nobody), plus any cache overhang
    past the configured cap — bounded by what is actually evictable.
    Pure host-int arithmetic; the engine executes the
    plan via ``evict_prefix_blocks``."""
    want = over_cap_blocks
    if reserved_blocks > demote_line_blocks:
        want = max(want, reserved_blocks - int(demote_line_blocks))
    return min(max(want, 0), max(evictable_blocks, 0))


def plan_demotions(worst_blocks: Sequence[int], held_blocks: Sequence[int],
                   reserved_blocks: int, capacity_blocks: float,
                   demote_line_blocks: float, min_active: int) -> List[int]:
    """Indices of ACTIVE requests to demote this tick, chosen from the
    tail of the admit-ordered lists (LIFO). ``worst_blocks[i]`` is request
    i's worst-case-at-completion block count, ``held_blocks[i]`` its
    currently reserved blocks. Demote until the active worst-case sum fits
    under the capacity line AND observed reservation is back under the
    demote line, keeping at least ``min_active`` requests running so the
    engine always makes progress. A victim is skipped (kept active) when
    demoting it would not help the binding constraint — e.g. a
    freshly-admitted prefill holding zero blocks frees nothing against the
    demote line; pausing it would just collapse throughput."""
    n = len(worst_blocks)
    worst_sum = 0
    for w in worst_blocks:
        worst_sum += w
    reserved = reserved_blocks
    out: List[int] = []
    kept = n
    i = n - 1
    while (i >= 0 and kept > max(min_active, 1)
           and (worst_sum > capacity_blocks
                or reserved > demote_line_blocks)):
        helps = worst_sum > capacity_blocks or held_blocks[i] > 0
        if helps:
            out.append(i)
            kept -= 1
            worst_sum -= worst_blocks[i]
            reserved -= held_blocks[i]
        i -= 1
    return out


def plan_promotions(demoted_worst: Sequence[int],
                    demoted_held: Sequence[int],
                    active_worst_sum: int, capacity_blocks: float,
                    free_blocks: int, reserved_blocks: int,
                    demote_line_blocks: float) -> int:
    """How many demoted requests (FIFO head of the demotion order) to
    promote this tick: each must fit under the capacity line with the
    already-active worst-case sum, its held pages must fit in currently
    free device blocks, AND restoring it must keep observed reservation
    under the demote line — the demote line doubles as the promotion
    hysteresis band, so one tick can never demote a request and promote it
    straight back (tier ping-pong). Progress guard: when NOTHING is active
    (every resident request is demoted) the FIFO head is promoted on free
    blocks alone — a paused server must always be able to restart."""
    k = 0
    worst_sum = active_worst_sum
    free = free_blocks
    reserved = reserved_blocks
    for w, h in zip(demoted_worst, demoted_held):
        if h > free:
            break
        if worst_sum + w > capacity_blocks or reserved + h > demote_line_blocks:
            if k == 0 and worst_sum == 0:
                return 1          # progress guard
            break
        k += 1
        worst_sum += w
        free -= h
        reserved += h
    return k


def tier_pressure(reserved_blocks: int, effective_usable: int,
                  queued: int, max_queue_depth: int,
                  host_bytes: int, host_budget_bytes: int
                  ) -> Tuple[float, str]:
    """The scalar the degradation ladder climbs on: the max of the three
    normalized exhaustion fractions, plus which one dominates (the
    ladder's transition ``reason``)."""
    device_frac = reserved_blocks / max(effective_usable, 1)
    queue_frac = queued / max(max_queue_depth, 1)
    host_frac = (host_bytes / host_budget_bytes
                 if host_budget_bytes > 0 else 0.0)
    pressure, reason = device_frac, "device_kv"
    if queue_frac > pressure:
        pressure, reason = queue_frac, "queue"
    if host_frac > pressure:
        pressure, reason = host_frac, "host_kv"
    return pressure, reason
