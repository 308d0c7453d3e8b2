"""Block-sparse attention layout configs (numpy).

Port of ``deepspeed_tpu/ops/sparse_attention/sparsity_configs.py``, kept as
the port's own copy (the port imports nothing of the JAX package, though
that module imports no JAX): the same six config classes, arguments and
patterns, and for the same arguments and seed the same layouts, an int64
{0,1} array [num_heads, nb, nb] (nb = seq_len // block) marking which
[block x block] score tiles exist. Random patterns draw from
``np.random.default_rng(seed)`` in the reference's order. Reference analog:
``deepspeed/ops/sparse_attention/sparsity_config.py``.
"""

import numpy as np


class SparsityConfig:
    """Base: shared block/head bookkeeping (reference sparsity_config.py:10)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"sequence length {seq_len} must be divisible by block "
                f"{self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), np.int64)

    def check_and_propagate_first_head_layout(self, layout) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks present (reference :63 — the dense degenerate case)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer 'fixed' pattern (reference :95; arxiv 1904.10509):
    local windows of ``num_local_blocks`` + per-window global representative
    columns (last ``num_global_blocks`` of each window, rotated per head when
    ``num_different_global_patterns`` > 1)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal global attention requires bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "multiple global patterns require different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError("too many global patterns for the local window")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def _set_local(self, h, layout):
        nb = layout.shape[1]
        for i in range(0, nb, self.num_local_blocks):
            end = min(i + self.num_local_blocks, nb)
            for row in range(i, end):
                cols_end = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, i:cols_end] = 1
        return layout

    def _set_global(self, h, layout):
        nb = layout.shape[1]
        first = self.num_local_blocks - \
            (1 + h % self.num_different_global_patterns) * self.num_global_blocks
        end = nb - (nb % self.num_local_blocks)
        for i in range(first, end, self.num_local_blocks):
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + self.num_global_blocks] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + self.num_global_blocks, :] = 1
        if end < nb:
            start = min(end + first, nb - self.num_global_blocks)
            stop = start + self.num_global_blocks
            first_row = 0 if self.attention == "bidirectional" else start
            layout[h, first_row:, start:stop] = 1
            if self.horizontal_global_attention:
                layout[h, start:stop, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self._set_local(h, layout)
            layout = self._set_global(h, layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """'Variable' pattern (reference :239): random blocks + variable-size local
    windows + explicit global block columns/rows."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal global attention requires bidirectional attention")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and \
                len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global block start/end index lists must align")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def _set_random(self, h, layout, rng):
        nb = layout.shape[1]
        for row in range(nb):
            hi = nb if self.attention == "bidirectional" else row + 1
            cols = rng.choice(hi, size=min(self.num_random_blocks, hi),
                              replace=False)
            layout[h, row, cols] = 1
        return layout

    def _set_local(self, h, layout):
        nb = layout.shape[1]
        start = 0
        wi = 0
        while start < nb:
            w = self.local_window_blocks[min(wi,
                                             len(self.local_window_blocks) - 1)]
            end = min(start + w, nb)
            for row in range(start, end):
                cols_end = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, start:cols_end] = 1
            start = end
            wi += 1
        return layout

    def _set_global(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start, end in spans:
            if start >= nb:
                continue
            end = min(end, nb)
            layout[h, :, start:end] = 1            # vertical
            if self.horizontal_global_attention:
                layout[h, start:end, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_layout_heads):
            if self.num_random_blocks:
                layout = self._set_random(h, layout, rng)
            layout = self._set_local(h, layout)
            layout = self._set_global(h, layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (reference :411; arxiv 2007.14062): random + sliding window +
    ITC global (first ``num_global_blocks`` rows AND columns)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < max(self.num_random_blocks, self.num_sliding_window_blocks,
                    self.num_global_blocks):
            raise ValueError(
                f"{nb} blocks is too few for the configured pattern")
        rng = np.random.default_rng(self.seed)
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for row in range(nb):
                hi = nb if self.attention == "bidirectional" else row + 1
                cols = rng.choice(hi, size=min(self.num_random_blocks, hi),
                                  replace=False)
                layout[h, row, cols] = 1
                layout[h, row, max(0, row - w):min(row + w + 1, nb)] = 1
            layout[h, :self.num_global_blocks, :] = 1
            layout[h, :, :self.num_global_blocks] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Blocked Longformer (reference :546): sliding window + explicit global
    block indices (rows AND columns)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and \
                len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global block start/end index lists must align")
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for row in range(nb):
                layout[h, row, max(0, row - w):min(row + w + 1, nb)] = 1
            if self.global_block_end_indices is None:
                spans = [(i, i + 1) for i in self.global_block_indices]
            else:
                spans = list(zip(self.global_block_indices,
                                 self.global_block_end_indices))
            for start, end in spans:
                if start >= nb:
                    continue
                end = min(end, nb)
                layout[h, start:end, :] = 1
                layout[h, :, start:end] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Purely local sliding window (reference :678)."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for row in range(nb):
                layout[h, row, max(0, row - w):min(row + w + 1, nb)] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)
