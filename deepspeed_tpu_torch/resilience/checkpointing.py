"""Preemption-safe checkpoint orchestration over ``checkpoint/engine.py``
(port of ``deepspeed_tpu/resilience/checkpointing.py``).

What ``checkpoint/engine.py`` provides (mechanism): the whole-leaf files,
the sidecars, the integrity manifest, the fsync'd atomic ``latest``
commit, verify-on-load. What this module adds (policy):

  - ``save_with_retry``    : exponential-backoff retry around transient
                             checkpoint I/O errors (chaos-injectable)
  - ``find_latest_committed``: newest tag whose manifest verifies — the
                             ``latest`` pointer is a hint, not an oracle; a
                             torn or corrupted tag falls back to the newest
                             clean one
  - ``resume_from_latest`` : restore the engine (and with it the
                             lr schedule, a pure function of the restored
                             step) from that tag (never a torn checkpoint)
  - ``prune_checkpoints``  : bounded-disk retention (keep newest N committed)
  - ``Autosaver``          : step- and wall-clock-cadence save triggers
"""

import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.checkpoint.engine import (
    CheckpointCorruptionError, is_committed, read_latest_tag,
    wait_pending_checkpoint)
from deepspeed_tpu_torch.utils.logging import logger


class CheckpointSaveError(RuntimeError):
    """A checkpoint save failed after exhausting its retry budget."""


def _tag_meta(save_dir: str, tag: str) -> Dict[str, Any]:
    import json
    try:
        with open(os.path.join(save_dir, tag, "ds_meta.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def list_tags(save_dir: str) -> List[str]:
    """Candidate checkpoint tags (subdirectories), newest first by the saved
    global step (mtime is the tiebreaker — step metadata can be missing on a
    torn save)."""
    save_dir = os.path.abspath(save_dir)
    if not os.path.isdir(save_dir):
        return []
    tags = [d for d in os.listdir(save_dir)
            if os.path.isdir(os.path.join(save_dir, d))]

    def key(tag):
        meta = _tag_meta(save_dir, tag)
        try:
            mtime = os.path.getmtime(os.path.join(save_dir, tag))
        except OSError:
            mtime = 0.0
        return (int(meta.get("global_steps", -1)), mtime)

    return sorted(tags, key=key, reverse=True)


def find_latest_committed(save_dir: str, verify: bool = True) -> Optional[str]:
    """The tag to resume from: the ``latest`` pointer when it names a clean
    committed checkpoint, else the newest other tag that qualifies. Returns
    None when no committed checkpoint exists at all. ``verify=False`` checks
    the commit marker only (for callers whose load path re-verifies anyway —
    skipping a redundant full-CRC read of a multi-GB checkpoint)."""
    save_dir = os.path.abspath(save_dir)
    pointed = read_latest_tag(save_dir)
    if pointed is not None and is_committed(save_dir, pointed, verify=verify):
        return pointed
    if pointed is not None:
        logger.warning(
            f"resume: 'latest' points at '{pointed}' which is missing "
            f"or fails integrity verification; scanning for the newest "
            f"committed tag")
    for tag in list_tags(save_dir):
        if tag != pointed and is_committed(save_dir, tag, verify=verify):
            return tag
    return None


def save_with_retry(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict[str, Any]] = None,
                    retries: int = 3, backoff_s: float = 0.5,
                    chaos=None) -> str:
    """``engine.save_checkpoint`` with exponential-backoff retry on I/O
    errors (reference pattern: object-store flakiness is the COMMON failure
    for long runs; one transient error must not kill the job). Retries are
    synchronous — a save that must survive preemption cannot ride an async
    finalizer whose error surfaces a step later."""
    step = engine.global_steps
    last_err: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            if chaos is not None:
                chaos.ckpt_io_check(step, attempt)
            path = engine.save_checkpoint(save_dir, tag=tag,
                                          client_state=client_state)
            # surface async-finalizer errors NOW, inside the retry loop
            wait_pending_checkpoint(engine)
            return path
        except (OSError, RuntimeError) as e:
            last_err = e
            if attempt >= retries:
                break
            delay = backoff_s * (2 ** attempt)
            logger.warning(
                f"checkpoint save attempt {attempt + 1}/{retries + 1} failed "
                f"({e!r}); retrying in {delay:.2f}s")
            time.sleep(delay)
    raise CheckpointSaveError(
        f"checkpoint save to {save_dir} failed after {retries + 1} "
        f"attempts") from last_err


def resume_from_latest(engine, save_dir: str,
                       load_optimizer_states: bool = True
                       ) -> Tuple[Optional[str], Dict[str, Any]]:
    """Discover the newest *committed* checkpoint and restore the engine
    from it — params, optimizer, loss-scale, step counter (which also pins
    the lr schedule: every schedule here is a pure function of the restored
    step). Returns ``(tag, client_state)``;
    ``(None, {})`` when nothing committed exists (fresh start).

    Torn checkpoints are never loaded: a tag only qualifies after its
    integrity manifest verifies, and a corruption race between discovery and
    load falls back to the next-newest clean tag."""
    save_dir = os.path.abspath(save_dir)
    tried: List[str] = []
    last_err: Optional[BaseException] = None
    while True:
        # commit-marker discovery only (verify=False): the load path's
        # verify_manifest is the single authoritative full-CRC gate — a torn
        # candidate raises there and the loop falls back, so discovery-time
        # verification would only double the resume I/O
        if not tried:
            tag = find_latest_committed(save_dir, verify=False)
        else:
            tag = next((c for c in list_tags(save_dir)
                        if c not in tried
                        and is_committed(save_dir, c, verify=False)),
                       None)
        if tag is None:
            if tried:
                raise CheckpointCorruptionError(
                    f"no loadable committed checkpoint in {save_dir} "
                    f"(tried {tried})") from last_err
            logger.info(f"resume: no committed checkpoint in {save_dir}; "
                        f"starting fresh")
            return None, {}
        tried.append(tag)
        try:
            _, client_state = engine.load_checkpoint(
                save_dir, tag=tag,
                load_optimizer_states=load_optimizer_states)
            logger.info(f"resume: restored checkpoint '{tag}' "
                        f"(global step {engine.global_steps})")
            return tag, client_state
        except (CheckpointCorruptionError, OSError, ValueError, KeyError) as e:
            # not just checksum mismatches: a tag torn BEFORE its manifest
            # landed (crash mid-ds_meta.json write, missing leaf files)
            # surfaces as JSONDecodeError / FileNotFoundError / ValueError —
            # all mean "this tag is unusable, try the next-newest commit"
            last_err = e
            logger.warning(f"resume: tag '{tag}' failed to load ({e!r}); "
                           f"trying an older commit")


def prune_checkpoints(save_dir: str, keep_last: int) -> List[str]:
    """Delete committed tags beyond the newest ``keep_last`` (the currently
    pointed-to tag is always kept). Uncommitted/torn tags are left alone —
    they are diagnostic evidence, not reclaimable state. Returns the tags
    removed."""
    if keep_last <= 0:
        return []
    save_dir = os.path.abspath(save_dir)
    # commit-marker check only (verify=False): pruning runs inside the
    # training loop on every autosave, and a full CRC re-read of every kept
    # multi-GB checkpoint there is pure waste — corruption is caught where
    # it matters, at load (verify_manifest)
    pointed = read_latest_tag(save_dir)
    committed = [t for t in list_tags(save_dir)
                 if is_committed(save_dir, t, verify=False)]
    keep = set(committed[:keep_last]) | ({pointed} if pointed else set())
    removed = []
    for tag in committed:
        if tag not in keep:
            shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
            removed.append(tag)
    if removed:
        logger.info(f"pruned checkpoints: {removed}")
    return removed


class Autosaver:
    """Step- and wall-clock-cadence trigger. ``due()`` is cheap enough to
    call every step; ``mark_saved()`` resets both clocks (any save counts —
    cadence, preemption, or user-initiated)."""

    def __init__(self, every_steps: int = 0, every_seconds: float = 0.0):
        self.every_steps = int(every_steps)
        self.every_seconds = float(every_seconds)
        self.last_save_step = 0
        self.last_save_time = time.monotonic()

    @property
    def enabled(self) -> bool:
        return self.every_steps > 0 or self.every_seconds > 0

    def due(self, step: int) -> bool:
        if self.every_steps > 0 and step - self.last_save_step >= self.every_steps:
            return True
        return (self.every_seconds > 0
                and time.monotonic() - self.last_save_time >= self.every_seconds)

    def mark_saved(self, step: int):
        self.last_save_step = int(step)
        self.last_save_time = time.monotonic()

    def state_dict(self) -> Dict[str, Any]:
        return {"last_save_step": self.last_save_step}

    def load_state_dict(self, sd: Dict[str, Any]):
        self.last_save_step = int(sd.get("last_save_step", 0))
        self.last_save_time = time.monotonic()
