"""dstpu hist — deterministic fixed-log-bucket latency histograms (copy of
``deepspeed_tpu/telemetry/hist.py``).

The SLO layer's measurement primitive: a histogram whose bucket bounds
are EXACT powers of two (``2.0**e`` seconds) so the bucket a value lands
in is a pure function of the value — no adaptive resizing, no
quantile-sketch randomness, no platform-dependent rounding. Two
properties the serving tests lean on:

* **bit-identical cross-platform** — IEEE-754 represents powers of two
  exactly, so ``bucket_index(v)`` gives the same answer on every host
  and the golden-bucket tests can pin exact counts;
* **mergeable** — same-bounds histograms add counterwise, so per-replica
  histograms fold into fleet-wide ones without approximation error
  (the same reason Prometheus's histogram type is cumulative-bucket).

The default span ``2**-20 s .. 2**6 s`` (~1 us .. 64 s) covers every
serving latency this repo measures (queue wait, TTFT, TPOT, KV handoff);
values beyond the top bound land in the implicit ``+Inf`` bucket, never
dropped. No wall-clock anywhere in this module: callers feed it
monotonic-stamp differences or TickLedger ceil-div units, which is what
keeps the histogram tests deterministic.

Offline-friendly by construction (stdlib only) but
NOT offline-only: ``serving/metrics.py`` feeds histograms on the serve
path's bookkeeping side (stdlib float/int work — no host sync).
"""

from typing import Dict, List, Optional, Sequence, Tuple

#: default bucket span: 2**-20 s (~0.95 us) .. 2**6 s (64 s), one bucket
#: per power of two — 27 finite bounds + the implicit +Inf bucket
DEFAULT_LOW_EXP = -20
DEFAULT_HIGH_EXP = 6


def log2_bounds(low_exp: int = DEFAULT_LOW_EXP,
                high_exp: int = DEFAULT_HIGH_EXP) -> Tuple[float, ...]:
    """Upper bucket bounds ``2.0**e`` for ``e`` in ``[low_exp, high_exp]``
    — each IEEE-754-exact, so the bounds (and therefore every bucket
    verdict) are identical on every platform."""
    if high_exp < low_exp:
        raise ValueError(f"empty bound span [{low_exp}, {high_exp}]")
    return tuple(2.0 ** e for e in range(low_exp, high_exp + 1))


class LogHistogram:
    """Fixed-bound histogram with Prometheus-histogram semantics: a value
    lands in the first bucket whose upper bound is ``>= value`` (le-
    inclusive, the Prometheus ``le`` contract), or in ``+Inf`` past the
    top bound. Tracks exact ``count`` and ``sum`` alongside the bucket
    counters so conservation identities (bucket total == observations ==
    completed requests) are checkable, not approximate."""

    __slots__ = ("bounds", "counts", "inf_count", "count", "sum")

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self.bounds: Tuple[float, ...] = tuple(
            bounds if bounds is not None else log2_bounds())
        if list(self.bounds) != sorted(self.bounds) or len(
                set(self.bounds)) != len(self.bounds):
            raise ValueError("bounds must be strictly increasing")
        self.counts: List[int] = [0] * len(self.bounds)
        self.inf_count = 0
        self.count = 0
        self.sum = 0.0

    def bucket_index(self, value: float) -> int:
        """Index of the bucket ``value`` lands in; ``len(bounds)`` means
        the +Inf bucket. Linear scan: the bound list is ~27 entries and
        observation sits on bookkeeping paths, not hot loops."""
        v = float(value)
        for i, b in enumerate(self.bounds):
            if v <= b:
                return i
        return len(self.bounds)

    def observe(self, value: float) -> None:
        v = float(value)
        i = self.bucket_index(v)
        if i < len(self.counts):
            self.counts[i] += 1
        else:
            self.inf_count += 1
        self.count += 1
        self.sum += v

    def merge(self, other: "LogHistogram") -> None:
        """Counterwise fold of a same-bounds histogram (per-replica ->
        fleet-wide). Differing bounds are a programming error, not data."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.inf_count += other.inf_count
        self.count += other.count
        self.sum += other.sum

    def quantile(self, q: float) -> float:
        """Upper-bound quantile estimate: the upper edge of the bucket
        holding the q-th observation (``min(int(q*n), n-1)`` rank, the
        repo-wide exact-quantile rule applied to bucket ranks). +Inf-
        bucket hits report the top finite bound — a floor, clearly
        saturated, never a fabricated value."""
        if self.count <= 0:
            return 0.0
        rank = min(int(q * self.count), self.count - 1)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if rank < seen:
                return self.bounds[i]
        return self.bounds[-1] if self.bounds else 0.0

    def snapshot(self) -> Dict[str, object]:
        """JSON-able state: finite-bucket counts, +Inf count, exact
        count/sum — the bench_serve proof-set row."""
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "inf_count": self.inf_count, "count": self.count,
                "sum": self.sum}

    @classmethod
    def from_snapshot(cls, snap: Dict[str, object]) -> "LogHistogram":
        h = cls(bounds=snap.get("bounds") or log2_bounds())
        counts = list(snap.get("counts") or ())
        if len(counts) != len(h.counts):
            raise ValueError("snapshot counts do not match bounds")
        h.counts = [int(c) for c in counts]
        h.inf_count = int(snap.get("inf_count", 0))
        h.count = int(snap.get("count", 0))
        h.sum = float(snap.get("sum", 0.0))
        return h

    def delta_from(self, earlier: "LogHistogram") -> "LogHistogram":
        """This histogram minus an earlier same-bounds snapshot — the
        bench_serve warmed-run discipline (measure the measured window,
        not the warmup)."""
        if earlier.bounds != self.bounds:
            raise ValueError("cannot diff histograms with different bounds")
        out = LogHistogram(bounds=self.bounds)
        out.counts = [max(a - b, 0) for a, b in zip(self.counts,
                                                    earlier.counts)]
        out.inf_count = max(self.inf_count - earlier.inf_count, 0)
        out.count = max(self.count - earlier.count, 0)
        out.sum = self.sum - earlier.sum
        return out


def format_le(bound: float) -> str:
    """The ``le`` label text for one bound: ``repr`` of the float, which
    for powers of two is the exact shortest decimal — deterministic
    across platforms (goldens pin it)."""
    return repr(float(bound))


#: the one namespace this module may emit TYPE metadata for
#: (`dstpu_req_*` belongs to the function below alone)
FAMILY_NAMESPACE = "dstpu_req_"


def prometheus_histogram_lines(family: str, hist: LogHistogram,
                               help_text: str = "") -> List[str]:
    """Render ONE histogram as a Prometheus exposition block:
    exactly one ``# TYPE`` (and optional ``# HELP``) line per family,
    cumulative ``_bucket`` rows ending in ``+Inf``, then ``_sum`` and
    ``_count``. ``family`` must live inside ``dstpu_req_*`` — this
    function is the single TYPE emission site for that namespace, which
    is what makes duplicate-metadata collisions impossible by
    construction."""
    if not family.startswith(FAMILY_NAMESPACE):
        raise ValueError(
            f"histogram family {family!r} outside the {FAMILY_NAMESPACE}* "
            f"namespace this emission site owns")
    key = family[len(FAMILY_NAMESPACE):]
    lines: List[str] = []
    if help_text:
        lines.append(f"# HELP {family} {help_text}")
    lines.append(f"# TYPE dstpu_req_{key} histogram")
    cum = 0
    for bound, c in zip(hist.bounds, hist.counts):
        cum += c
        lines.append(f'{family}_bucket{{le="{format_le(bound)}"}} {cum}')
    cum += hist.inf_count
    lines.append(f'{family}_bucket{{le="+Inf"}} {cum}')
    lines.append(f"{family}_sum {hist.sum}")
    lines.append(f"{family}_count {hist.count}")
    return lines
