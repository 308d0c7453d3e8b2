"""Dynamic SplitFuse scheduling.

Reference analog: ``deepspeed/inference/v2/scheduling_utils.py`` + the admission
logic in ``engine_v2.py:158,184`` (``query``/``can_schedule``): each engine step
carries a fixed token budget; running decodes get 1 token each, remaining budget is
filled by *chunks* of pending prefills (long prompts split across steps — SplitFuse).

Copied from ``deepspeed_tpu/inference/v2/scheduler.py``: chunk sizes snap to
the same bucket ladder, so the port plans exactly the steps the reference
plans; decodes batch into a padded [max_batch] call.
"""

import dataclasses
from typing import List, Sequence, Tuple

from deepspeed_tpu_torch.inference.v2.ragged_manager import SequenceDescriptor


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_tokens_per_step: int = 2048      # SplitFuse token budget
    max_decode_batch: int = 64
    prefill_buckets: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    # decode-first chunk cap: at most this many prefill tokens per step, so
    # chunked prefill interleaves with decode and TPOT never spikes behind a
    # long prompt. 0 (default) = uncapped, bit-identical pre-cap planning.
    prefill_chunk_tokens: int = 0


@dataclasses.dataclass
class PrefillChunk:
    seq: SequenceDescriptor
    start: int           # token offset into the sequence
    length: int          # real tokens this chunk
    bucket: int          # padded compile shape


@dataclasses.dataclass
class StepPlan:
    decode_seqs: List[SequenceDescriptor]
    prefill_chunks: List[PrefillChunk]

    @property
    def empty(self) -> bool:
        return not self.decode_seqs and not self.prefill_chunks


def snap_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def plan_step(decoding: List[SequenceDescriptor],
              prefilling: List[SequenceDescriptor],
              cfg: SchedulerConfig,
              block_tokens: int = 0) -> StepPlan:
    """Build one step's work: decodes first (latency), then prefill chunks up to
    the token budget (reference: SplitFuse composition in engine_v2.put).

    With ``cfg.prefill_chunk_tokens > 0`` the decode-first cap applies: total
    prefill tokens this step never exceed the cap, and mid-prompt chunk
    boundaries are rounded DOWN to ``block_tokens`` multiples (KV-block /
    PrefixCache granularity — a chunk ending mid-block would strand a
    partial page no later hit or handoff could adopt). Buckets are unchanged,
    so capped chunks reuse the warm compile ladder. Cap off (0, default) is
    bit-identical to pre-cap planning."""
    cap = int(cfg.prefill_chunk_tokens)
    decodes = decoding[:cfg.max_decode_batch]
    budget = cfg.max_tokens_per_step - len(decodes)
    if cap > 0:
        budget = min(budget, cap)
    chunks: List[PrefillChunk] = []
    for seq in prefilling:
        if budget < cfg.prefill_buckets[0] // 2 and chunks:
            break
        remaining = len(seq.prompt_tokens) - seq.seen_tokens
        take = min(remaining, budget, cfg.prefill_buckets[-1])
        if cap > 0 and block_tokens > 0 and take < remaining:
            # a capped mid-prompt boundary snaps to KV-block granularity;
            # when the leftover budget can't cover one block, the prompt
            # waits a tick (decodes keep the step — that's the point)
            take -= take % block_tokens
        if take <= 0:
            break
        bucket = snap_bucket(take, cfg.prefill_buckets)
        chunks.append(PrefillChunk(seq=seq, start=seq.seen_tokens,
                                   length=take, bucket=bucket))
        budget -= take
    return StepPlan(decode_seqs=decodes, prefill_chunks=chunks)
