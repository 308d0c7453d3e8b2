"""Free-list allocator for paged KV-cache blocks.

Copied from ``deepspeed_tpu/inference/v2/blocked_allocator.py``.

Reference analog: ``deepspeed/inference/v2/ragged/blocked_allocator.py:11``
(``BlockedAllocator`` — a linked free list over a fixed block pool). Host-side
bookkeeping; the blocks themselves are rows of device KV arrays.
"""

from typing import List

import numpy as np


class BlockedAllocator:
    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        # linked free list: _next[i] = next free block after i
        self._next = np.arange(1, num_blocks + 1, dtype=np.int64)
        self._head = 0
        self._free = num_blocks

    @property
    def free_blocks(self) -> int:
        return self._free

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    def allocate(self, num_blocks: int) -> List[int]:
        if num_blocks > self._free:
            raise ValueError(
                f"cannot allocate {num_blocks} blocks ({self._free} free)")
        out = []
        for _ in range(num_blocks):
            out.append(self._head)
            self._head = int(self._next[self._head])
            self._free -= 1
        return out

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if not 0 <= b < self._num_blocks:
                raise ValueError(f"invalid block id {b}")
            self._next[b] = self._head
            self._head = b
            self._free += 1
