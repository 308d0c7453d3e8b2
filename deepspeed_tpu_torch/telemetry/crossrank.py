"""Trace-dump loading and process identity, the part of
``deepspeed_tpu/telemetry/crossrank.py`` that ``reqtrace`` needs.

A dump is a Chrome trace written by ``Tracer.export_chrome``; its
``otherData.process`` header pins the dump's monotonic clock to wall time,
which is how dumps of several processes land on one time axis. The
cross-rank merge and the collective-skew ledger of the reference module
are not ported yet (ROADMAP Queue 1 item 7).

Stdlib only.
"""

import json
from typing import Any, Dict, Optional


class CrossRankError(Exception):
    """Unreadable/unmergeable input — maps to CLI exit code 2."""


def load_dump(path: str) -> dict:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise CrossRankError(f"cannot read trace {path}: {e}") from e
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise CrossRankError(f"{path}: not a Chrome trace (no traceEvents)")
    return obj


def dump_identity(obj: dict, fallback_rank: int) -> Dict[str, Any]:
    """The process-identity header (``Tracer.process_identity``) of one
    dump, defaulted for pre-header dumps: rank falls back to the dump's
    POSITION in the argument list (stable, documented), anchors to None."""
    proc = (obj.get("otherData") or {}).get("process") or {}
    return {
        "rank": int(proc.get("rank", fallback_rank)),
        "world": int(proc.get("world", 0) or 0),
        "hostname": proc.get("hostname", "?"),
        "pid": int(proc.get("pid", 0) or 0),
        "wall_s": proc.get("wall_s"),
        "monotonic_s": proc.get("monotonic_s"),
        "epoch_monotonic_s": proc.get("epoch_monotonic_s"),
    }


def _wall_base_us(ident: Dict[str, Any]) -> Optional[float]:
    """Wall-clock time (us) at the dump's trace epoch (ts == 0), from the
    header's monotonic<->wall anchor pair — or None for pre-header dumps."""
    if ident["wall_s"] is None or ident["monotonic_s"] is None \
            or ident["epoch_monotonic_s"] is None:
        return None
    return (float(ident["wall_s"])
            - (float(ident["monotonic_s"])
               - float(ident["epoch_monotonic_s"]))) * 1e6
