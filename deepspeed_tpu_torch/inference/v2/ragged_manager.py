"""Sequence state tracking for continuous batching.

Copied from ``deepspeed_tpu/inference/v2/ragged_manager.py``.

Reference analogs: ``deepspeed/inference/v2/ragged/sequence_descriptor.py``
(``DSSequenceDescriptor``) and ``ragged_manager.py:19`` (``DSStateManager``) —
uid-keyed sequence records holding seen-token counts and KV block tables.
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class SequenceDescriptor:
    uid: int
    prompt_tokens: np.ndarray                 # full prompt (host)
    blocks: List[int] = dataclasses.field(default_factory=list)
    seen_tokens: int = 0                      # tokens whose KV is in cache
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # demoted to the host KV tier: holds no device blocks, invisible to the
    # step planner until promoted back (engine_v2.demote_kv/promote_kv)
    paused: bool = False

    @property
    def total_tokens(self) -> int:
        return len(self.prompt_tokens) + len(self.generated)

    @property
    def in_prefill(self) -> bool:
        return self.seen_tokens < len(self.prompt_tokens)

    def remaining_prompt(self) -> np.ndarray:
        return self.prompt_tokens[self.seen_tokens:]


class StateManager:
    """uid -> SequenceDescriptor (reference: DSStateManager ragged_manager.py:19)."""

    def __init__(self, max_tracked_sequences: int = 256,
                 max_context_length: int = 8192):
        self.max_tracked_sequences = max_tracked_sequences
        self.max_context_length = max_context_length
        self._seqs: Dict[int, SequenceDescriptor] = {}

    def __contains__(self, uid: int) -> bool:
        return uid in self._seqs

    def __len__(self) -> int:
        return len(self._seqs)

    def get(self, uid: int) -> Optional[SequenceDescriptor]:
        return self._seqs.get(uid)

    def create(self, uid: int, prompt_tokens) -> SequenceDescriptor:
        if uid in self._seqs:
            raise ValueError(f"uid {uid} already tracked")
        if len(self._seqs) >= self.max_tracked_sequences:
            raise RuntimeError("max_tracked_sequences exceeded")
        prompt = np.asarray(prompt_tokens, dtype=np.int32)
        if len(prompt) > self.max_context_length:
            raise ValueError(f"prompt length {len(prompt)} > max context "
                             f"{self.max_context_length}")
        seq = SequenceDescriptor(uid=uid, prompt_tokens=prompt)
        self._seqs[uid] = seq
        return seq

    def pop(self, uid: int) -> SequenceDescriptor:
        return self._seqs.pop(uid)

    def all(self) -> List[SequenceDescriptor]:
        return list(self._seqs.values())

    def running(self) -> List[SequenceDescriptor]:
        return [s for s in self._seqs.values() if not s.done]

    def decoding(self) -> List[SequenceDescriptor]:
        return [s for s in self._seqs.values()
                if not s.done and not s.paused and not s.in_prefill]

    def prefilling(self) -> List[SequenceDescriptor]:
        return [s for s in self._seqs.values()
                if not s.done and not s.paused and s.in_prefill]
