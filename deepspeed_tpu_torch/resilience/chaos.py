"""Deterministic fault injection (copy of
``deepspeed_tpu/resilience/chaos.py``), the serving knobs.

Every injection decision is a pure function of ``(seed, kind, tick)`` — a
sha256-derived roll — so a chaos run replays bit-identically regardless of
call order or thread timing; the serving drills pin seeds and assert exact
recovery behaviour.

The serving-tick faults (``serving/server.py`` asks once per tick): stall
the serve tick (``DSTPU_CHAOS_SERVE_SLOW_TICK``), steal a fraction of usable
KV blocks over a tick window so the degradation ladder and the host KV tier
drill end to end (``DSTPU_CHAOS_SERVE_KV_PRESSURE``), make one request uid
fault the engine step so the poison-quarantine path fires
(``DSTPU_CHAOS_SERVE_POISON_UID``), or SIGKILL one fleet replica mid-decode
(``DSTPU_CHAOS_REPLICA_KILL="RID[:TICK]"``).

The training, checkpoint and comm knobs of the reference come with the
resilience runner (ROADMAP Queue 1, "checkpoint and resilience"); the
NaN-batch injection raises until the micro-step protocol is ported.
"""

import hashlib
import os
import signal
import time
from dataclasses import dataclass
from typing import Optional

from deepspeed_tpu_torch.telemetry.tracer import get_tracer
from deepspeed_tpu_torch.utils.logging import logger


#: set by the fleet launcher on every replica worker it spawns; the
#: replica-kill knob selects its victim by this id (and the fleet router
#: reports it back through /healthz for affinity + retirement decisions)
REPLICA_ID_ENV = "DSTPU_REPLICA_ID"


def _parse_replica_kill(raw: str):
    """``"RID[:TICK]"`` -> (replica_id, tick); tick 0 = sha-rolled."""
    if not raw:
        return -1, 0
    head, _, tick = raw.partition(":")
    return int(head), int(tick or 0)


def _parse_slow_tick(raw: str):
    """``"N:SECS"`` (every Nth tick) or ``"pP:SECS"`` (probability P per
    tick via the sha roll) -> (every, prob, seconds)."""
    if not raw:
        return 0, 0.0, 0.0
    head, _, secs = raw.partition(":")
    s = float(secs or 0.0)
    if head.startswith("p"):
        return 0, float(head[1:]), s
    return int(head or 0), 0.0, s


def _parse_kv_pressure(raw: str):
    """``"FRAC[:FROM[:UNTIL]]"`` -> (frac, from_tick, until_tick);
    until < 0 means the pressure never lifts."""
    if not raw:
        return 0.0, 0, -1
    parts = raw.split(":")
    frac = float(parts[0])
    frm = int(parts[1]) if len(parts) > 1 else 0
    until = int(parts[2]) if len(parts) > 2 else -1
    return frac, frm, until


@dataclass(frozen=True)
class ChaosConfig:
    """The serving knobs of the reference's ``ChaosConfig`` (same fields,
    same ``DSTPU_CHAOS_*`` spellings)."""
    seed: int = 0
    # serving-tick faults (consumed by serving/server.py). slow_tick
    # stalls the serve tick (every Nth tick, or per-tick probability via
    # the sha roll); kv_pressure steals a fraction of usable KV blocks
    # over [from, until) ticks (until < 0 = forever); poison_uid makes
    # that request uid fault the engine step whenever it is resident
    serve_slow_tick_every: int = 0
    serve_slow_tick_prob: float = 0.0
    serve_slow_tick_s: float = 0.0
    serve_kv_pressure_frac: float = 0.0
    serve_kv_pressure_from: int = 0
    serve_kv_pressure_until: int = -1
    serve_poison_uid: int = -1
    # fleet replica death: SIGKILL the worker whose DSTPU_REPLICA_ID
    # matches, at the first serve tick >= replica_kill_tick that has
    # decode work in flight (mid-decode by construction — the router must
    # fail over live streams, not an idle process). tick 0 = sha-rolled
    # from the seed; replica_kill_once spares DSTPU_RESUME relaunches
    # (die_once contract), so kill -> reroute -> rejoin drills exactly once
    replica_kill_id: int = -1
    replica_kill_tick: int = 0
    replica_kill_once: bool = True

    @property
    def active(self) -> bool:
        return bool((self.serve_slow_tick_s > 0
                     and (self.serve_slow_tick_every
                          or self.serve_slow_tick_prob))
                    or self.serve_kv_pressure_frac > 0
                    or self.serve_poison_uid >= 0
                    or self.replica_kill_id >= 0)

    @classmethod
    def from_env(cls, env=os.environ) -> "ChaosConfig":
        g = env.get
        return cls(
            seed=int(g("DSTPU_CHAOS_SEED", "0")),
            **dict(zip(("serve_slow_tick_every", "serve_slow_tick_prob",
                        "serve_slow_tick_s"),
                       _parse_slow_tick(g("DSTPU_CHAOS_SERVE_SLOW_TICK",
                                          "")))),
            **dict(zip(("serve_kv_pressure_frac", "serve_kv_pressure_from",
                        "serve_kv_pressure_until"),
                       _parse_kv_pressure(g("DSTPU_CHAOS_SERVE_KV_PRESSURE",
                                            "")))),
            serve_poison_uid=int(g("DSTPU_CHAOS_SERVE_POISON_UID", "-1")),
            **dict(zip(("replica_kill_id", "replica_kill_tick"),
                       _parse_replica_kill(g("DSTPU_CHAOS_REPLICA_KILL",
                                             "")))),
            replica_kill_once=g("DSTPU_CHAOS_REPLICA_KILL_ONCE", "1")
            not in ("0", "false"),
        )


class ChaosInjectedPoisonError(RuntimeError):
    """An injected per-request engine-step fault. The message says
    "aborted" so ``comm.guard.classify_exception`` calls it TRANSIENT —
    the serving layer must route it to the poison-quarantine path, NOT the
    sticky degraded latch (that asymmetry is exactly what the drill
    proves)."""


class ChaosMonkey:
    """Stateless-roll injector; the only mutable state is bookkeeping
    counters so tests can assert exactly what fired."""

    def __init__(self, config: Optional[ChaosConfig] = None):
        self.config = config if config is not None else ChaosConfig.from_env()
        self.injected = {"serve_slow_tick": 0, "serve_kv_pressure": 0,
                         "serve_poison": 0, "replica_kill": 0}
        self._serve_kv_pressure_on = False   # edge detector for the instant
        # pre-SIGKILL hook (serving flight recorder): SIGKILL is
        # uncatchable, so a replica's last chance to dump its black box is
        # a synchronous callback BEFORE os.kill — registered by the
        # serving layer, called with the due tick; its failure must never
        # save the victim (the drill's contract is that the process dies)
        self.on_replica_kill: Optional[callable] = None

    # ------------------------------------------------------------------
    def _roll(self, kind: str, step: int, salt: int = 0) -> float:
        """Deterministic uniform [0, 1) from (seed, kind, step, salt)."""
        h = hashlib.sha256(
            f"{self.config.seed}:{kind}:{step}:{salt}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2 ** 64

    # ------------------------------------------------------------------
    # nan grads (training)
    # ------------------------------------------------------------------
    def corrupt_batch(self, batch, step: int):
        raise NotImplementedError(
            "chaos NaN-batch injection is not ported yet: it comes with the "
            "micro-step protocol (ROADMAP Queue 1)")

    # ------------------------------------------------------------------
    # serving-tick faults (serving/server.py asks per serve tick)
    # ------------------------------------------------------------------
    def serve_slow_tick(self, tick: int) -> float:
        """Stall this serve tick when due (cadence or sha-rolled
        probability); returns the injected stall seconds."""
        c = self.config
        if c.serve_slow_tick_s <= 0:
            return 0.0
        due = bool(c.serve_slow_tick_every and tick > 0
                   and tick % c.serve_slow_tick_every == 0)
        if not due and c.serve_slow_tick_prob > 0:
            due = self._roll("serve_slow", tick) < c.serve_slow_tick_prob
        if not due:
            return 0.0
        self.injected["serve_slow_tick"] += 1
        logger.warning(f"chaos: stalling serve tick {tick} for "
                       f"{c.serve_slow_tick_s:.3f}s")
        time.sleep(c.serve_slow_tick_s)
        get_tracer().complete("chaos/serve_slow_tick", c.serve_slow_tick_s,
                              cat="resilience", tick=tick)
        return c.serve_slow_tick_s

    def serve_kv_pressure(self, tick: int) -> float:
        """Fraction of usable KV blocks stolen at this tick (0 outside the
        configured window). Window edges emit a chaos instant so the whole
        pressure episode is reconstructible from the trace."""
        c = self.config
        if c.serve_kv_pressure_frac <= 0:
            return 0.0
        on = tick >= c.serve_kv_pressure_from and (
            c.serve_kv_pressure_until < 0
            or tick < c.serve_kv_pressure_until)
        if on != self._serve_kv_pressure_on:
            self._serve_kv_pressure_on = on
            if on:
                self.injected["serve_kv_pressure"] += 1
            get_tracer().instant("chaos/serve_kv_pressure", cat="resilience",
                                 tick=tick, state="on" if on else "off",
                                 frac=c.serve_kv_pressure_frac)
            logger.warning(
                f"chaos: serve KV pressure {'ON' if on else 'OFF'} at tick "
                f"{tick} (stealing {c.serve_kv_pressure_frac:.0%} of blocks)")
        return c.serve_kv_pressure_frac if on else 0.0

    def maybe_poison_serve(self, uids) -> None:
        """Raise when the poisoned request uid is resident in this engine
        step — a per-request transient engine fault the serving layer must
        isolate (evict + retry + quarantine), never latch degraded on."""
        uid = self.config.serve_poison_uid
        if uid < 0 or uid not in uids:
            return
        self.injected["serve_poison"] += 1
        get_tracer().instant("chaos/serve_poison", cat="resilience", uid=uid)
        logger.warning(f"chaos: poisoning engine step (request uid {uid})")
        raise ChaosInjectedPoisonError(
            f"chaos: poisoned request {uid} aborted the engine step")

    def maybe_kill_replica(self, tick: int, mid_decode: bool) -> None:
        """SIGKILL this serving replica when it is the configured victim
        and the due tick has arrived WITH decode work in flight
        (``mid_decode``) — the drill's contract is death mid-decode, so
        there are live streams for the router to fail over, never an idle
        process quietly disappearing. The victim is selected by
        ``DSTPU_REPLICA_ID`` (set by the fleet launcher); the due tick is
        sha-rolled from the seed when not pinned; ``replica_kill_once``
        spares the DSTPU_RESUME relaunch (die-once contract)."""
        c = self.config
        if c.replica_kill_id < 0 or not mid_decode:
            return
        try:
            rid = int(os.environ.get(REPLICA_ID_ENV, "-1") or "-1")
        except ValueError:
            return
        if rid != c.replica_kill_id:
            return
        due = c.replica_kill_tick or 1 + int(self._roll("replica_kill",
                                                        rid) * 32)
        if tick < due:
            return
        if c.replica_kill_once and os.environ.get("DSTPU_RESUME"):
            return
        self.injected["replica_kill"] += 1
        logger.warning(f"chaos: SIGKILL replica {rid} at serve tick {tick}")
        # breadcrumb only: SIGKILL is uncatchable — the router learns of
        # the death from its broken streams + healthz, which is the drill
        get_tracer().instant("chaos/replica_kill", cat="resilience",
                             tick=tick, replica=rid)
        if self.on_replica_kill is not None:
            try:
                self.on_replica_kill(tick)
            except Exception:
                logger.exception("chaos: pre-kill flight hook failed "
                                 "(the kill proceeds regardless)")
        os.kill(os.getpid(), signal.SIGKILL)


def monkey_from_env() -> Optional[ChaosMonkey]:
    """A ``ChaosMonkey`` when any DSTPU_CHAOS_* knob is set, else None."""
    cfg = ChaosConfig.from_env()
    return ChaosMonkey(cfg) if cfg.active else None
