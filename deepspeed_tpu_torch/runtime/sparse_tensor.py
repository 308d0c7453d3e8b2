"""A row-indexed sparse tensor and the sparse gradient collectives.

Port of ``deepspeed_tpu/runtime/sparse_tensor.py`` (reference
``deepspeed/runtime/sparse_tensor.py`` and the engine's
``sparse_allreduce_bucket``, ``runtime/engine.py:2518-2588``: an
all-gather of every rank's (indices, values); the sum stays implicit
until the tensor is densified).

``SparseTensor.from_dense`` keeps the ``k`` rows of largest L2 norm
(``torch.topk``); rows of equal norm, the zero rows above all, may be
picked in another order than ``jax.lax.top_k`` picks them, so results
are compared densified. ``sparse_all_gather`` runs over the comm facade
on the global mesh's process groups: one recorded op of the logical bytes
(the dense tensor a full-precision reduction would move) and the wire
bytes (the indices and values a rank sends).
"""

from typing import Sequence, Tuple

import torch


class SparseTensor:
    """indices [K] int32 row ids; values [K, D]; ``dense_rows`` N."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor,
                 dense_rows: int):
        self.indices = indices
        self.values = values
        self.dense_rows = int(dense_rows)

    @classmethod
    def from_dense(cls, dense: torch.Tensor, k: int) -> "SparseTensor":
        """The ``k`` rows of ``dense`` [N, D] with the largest L2 norm (the
        fixed-k form of the reference's nonzero-row selection)."""
        norms = dense.float().square().sum(dim=-1)
        idx = torch.topk(norms, k).indices.to(torch.int32)
        return cls(idx, dense.index_select(0, idx), dense.shape[0])

    def to_dense(self) -> torch.Tensor:
        """[N, D]: every value row added at its index (duplicates sum)."""
        out = torch.zeros((self.dense_rows, self.values.shape[-1]),
                          dtype=self.values.dtype, device=self.values.device)
        return out.index_add_(0, self.indices.long(), self.values)

    def add(self, other: "SparseTensor") -> "SparseTensor":
        assert self.dense_rows == other.dense_rows
        return SparseTensor(torch.cat([self.indices, other.indices]),
                            torch.cat([self.values, other.values]),
                            self.dense_rows)

    def sparse_size(self) -> Tuple[int, int]:
        """(elements held, elements of the dense tensor)."""
        return (self.indices.numel() + self.values.numel(),
                self.dense_rows * self.values.shape[-1])


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def sparse_all_gather(st: SparseTensor, axis_name,
                      logical_bytes: int = None) -> SparseTensor:
    """Every member's (indices, values) over ``axis_name``, concatenated
    in member order; duplicates stay unsummed until ``to_dense``. Recorded
    as ``sparse_all_gather`` (kind ``all_gather``) with ``bytes`` =
    ``logical_bytes`` (default the sparse payload) and ``wire_bytes`` =
    the indices and values this rank sends."""
    from deepspeed_tpu_torch.comm.comm import _record, group_of, raw_all_gather
    group, world = group_of(axis_name)
    wire = _nbytes(st.indices) + _nbytes(st.values)

    def run():
        idx = raw_all_gather(st.indices, group, world).reshape(-1)
        vals = raw_all_gather(st.values, group, world).reshape(
            -1, st.values.shape[-1])
        return SparseTensor(idx, vals, st.dense_rows)

    return _record("sparse_all_gather", st.values, world, run,
                   nbytes=wire if logical_bytes is None else int(logical_bytes),
                   wire_bytes=wire, kind="all_gather")


def sparse_grad_sync(g: torch.Tensor, axes: Sequence[str], k: int
                     ) -> torch.Tensor:
    """The mean of an embedding-style gradient [N, D] over ``axes`` on the
    sparse wire: this rank's top-``k`` rows by norm (exact when ``k`` is at
    least the rows the gradient touches), gathered axis by axis, then
    densified and divided by the world, in ``g``'s dtype."""
    from deepspeed_tpu_torch.comm.comm import group_of
    st = SparseTensor.from_dense(g, k)
    dense_bytes = _nbytes(g)
    w = 1
    for ax in axes:
        w *= group_of(ax)[1]
        # the logical payload of each hop is the dense gradient a
        # full-precision reduction over this axis would move
        st = sparse_all_gather(st, ax, logical_bytes=dense_bytes)
    return (st.to_dense() / w).to(g.dtype)
