"""The serving degradation ladder — explicit, drillable overload states
(copy of ``deepspeed_tpu/serving/degradation.py``).

The serving layer degrades to "slower" before "429"; the ladder makes that
a real state machine instead of an emergent property:

    HEALTHY ──pressure≥brownout──> BROWNOUT ──pressure≥shed──> SHED
       ^                              |   ^                      |
       └──── calm for cooldown ───────┘   └── calm for cooldown ─┘

                     (any fatal engine fault)
    HEALTHY/BROWNOUT/SHED ────────────────────> DEGRADED   (sticky)

* **HEALTHY** — normal admission.
* **BROWNOUT** — degrade to slower: new admissions get their
  ``max_new_tokens`` capped, low-priority queue entries wait (admits
  paused), and the KV tier demotes more aggressively. Still 200s.
* **SHED** — new submissions are rejected with 429 + ``Retry-After``;
  everything already accepted keeps running.
* **DEGRADED** — sticky 503, reserved for REAL engine faults (fatal
  classification through ``comm.guard.classify_exception``); pressure
  alone can never latch it, and it never self-clears — the replica must
  be drained and replaced.

Upward transitions are edge-triggered and immediate (overload must not
wait). Downward transitions carry hysteresis: pressure must stay below
``threshold - hysteresis`` for ``cooldown_ticks`` consecutive observations
before the ladder steps down ONE rung — so a load oscillating around a
threshold cannot flap the server between accepting and shedding.

Every transition emits an edge-triggered ``serve/ladder`` dstrace instant
(from/to/pressure/reason), which is how a whole overload episode is
reconstructed from the trace alone (the bench_serve/chaos-drill
contract). ``observe`` is pure host arithmetic, never a device touch.
"""

import enum
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from deepspeed_tpu_torch.telemetry.tracer import get_tracer


class ServeLevel(enum.IntEnum):
    HEALTHY = 0
    BROWNOUT = 1
    SHED = 2
    DEGRADED = 3


@dataclass
class LadderConfig:
    brownout_pressure: float = 0.85   # climb to BROWNOUT at/above
    shed_pressure: float = 0.97       # climb to SHED at/above
    hysteresis: float = 0.10          # descend below threshold - this
    cooldown_ticks: int = 20          # consecutive calm ticks to descend

    def validate(self) -> "LadderConfig":
        if not 0.0 < self.brownout_pressure < self.shed_pressure:
            raise ValueError(
                f"need 0 < brownout_pressure ({self.brownout_pressure}) < "
                f"shed_pressure ({self.shed_pressure})")
        if self.hysteresis < 0.0 or self.cooldown_ticks < 1:
            raise ValueError("hysteresis must be >= 0 and "
                             "cooldown_ticks >= 1")
        return self


class DegradationLadder:
    """Single-writer state machine: only the serve loop calls ``observe``
    / ``latch_degraded``; other threads read ``level``/``reason`` (enum /
    str attribute reads, GIL-atomic)."""

    def __init__(self, config: Optional[LadderConfig] = None):
        self.config = (config or LadderConfig()).validate()
        self.level = ServeLevel.HEALTHY
        self.reason = ""
        self.last_pressure = 0.0
        self._calm_ticks = 0
        # lifetime transition counters keyed "FROM->TO" plus per-level
        # entry counts — the deterministic proof surface for bench_serve
        self.transitions: Dict[str, int] = {}
        self.entries: Dict[str, int] = {lv.name.lower(): 0
                                        for lv in ServeLevel}

    # ------------------------------------------------------------------
    def _threshold(self, level: ServeLevel) -> float:
        if level is ServeLevel.SHED:
            return self.config.shed_pressure
        if level is ServeLevel.BROWNOUT:
            return self.config.brownout_pressure
        return 0.0

    def _target(self, pressure: float) -> ServeLevel:
        if pressure >= self.config.shed_pressure:
            return ServeLevel.SHED
        if pressure >= self.config.brownout_pressure:
            return ServeLevel.BROWNOUT
        return ServeLevel.HEALTHY

    def _transition(self, to: ServeLevel, pressure: float, reason: str
                    ) -> Tuple[ServeLevel, ServeLevel]:
        frm = self.level
        self.level = to
        self.reason = reason
        self._calm_ticks = 0
        key = f"{frm.name}->{to.name}"
        self.transitions[key] = self.transitions.get(key, 0) + 1
        self.entries[to.name.lower()] += 1
        get_tracer().instant(
            "serve/ladder", cat="serve", frm=frm.name.lower(),
            to=to.name.lower(), pressure=round(pressure, 4), reason=reason)
        return frm, to

    # ------------------------------------------------------------------
    def observe(self, pressure: float, reason: str = ""
                ) -> Optional[Tuple[ServeLevel, ServeLevel]]:
        """Feed one tick's pressure scalar; returns the (from, to) edge
        when the ladder moved, else None. DEGRADED is sticky — pressure is
        recorded but cannot move the ladder."""
        self.last_pressure = pressure
        if self.level is ServeLevel.DEGRADED:
            return None
        target = self._target(pressure)
        if target > self.level:
            # overload climbs immediately (and may jump rungs)
            return self._transition(target, pressure, reason)
        if target < self.level:
            # descend one rung only after a full calm cooldown below the
            # CURRENT level's threshold minus the hysteresis band
            if pressure < self._threshold(self.level) - self.config.hysteresis:
                self._calm_ticks += 1
            else:
                self._calm_ticks = 0
            if self._calm_ticks >= self.config.cooldown_ticks:
                down = ServeLevel(self.level - 1)
                return self._transition(down, pressure, "pressure_lifted")
            return None
        self._calm_ticks = 0
        return None

    def latch_degraded(self, reason: str
                       ) -> Optional[Tuple[ServeLevel, ServeLevel]]:
        """Sticky latch for real engine faults — the ONLY path to
        DEGRADED, and there is no path out (drain + replace the replica)."""
        if self.level is ServeLevel.DEGRADED:
            return None
        return self._transition(ServeLevel.DEGRADED, self.last_pressure,
                                reason)
