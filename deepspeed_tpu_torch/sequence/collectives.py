"""Differentiable collectives of the sequence-parallel layers.

The facade's ``all_to_all``, ``ppermute`` and ``all_gather``
(``comm/comm.py``) return plain tensors. The JAX package runs Ulysses and
the ring inside ``shard_map``, where JAX differentiates through
``lax.all_to_all`` and ``lax.ppermute``; here each rank is a process, so
each op's transpose is placed by hand:

- ``all_to_all(split_axis, concat_axis)``: the backward is the inverse
  ``all_to_all(concat_axis, split_axis)``;
- ``ppermute(perm)``: the backward sends each cotangent back along the
  reversed pairs;
- ``psum_replicated``: a sum over the axis whose result every rank holds
  and counts once (the vocab-parallel loss), so the backward is the
  identity;
- ``all_gather_ids``: the segment ids, integers without a gradient.

Every op runs under ``comm.op_label(label)``, so the comms logger keeps
the slice's bytes apart (``sequence/ulysses/all_to_all``, ...).
"""

from typing import Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm import comm

AXIS = "sequence"


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis, tiled, label):
        ctx.args = (axis, split_axis, concat_axis, tiled, label)
        with comm.op_label(label):
            return comm.all_to_all(x, axis, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        axis, split_axis, concat_axis, tiled, label = ctx.args
        with comm.op_label(label):
            dx = comm.all_to_all(g.contiguous(), axis, concat_axis,
                                 split_axis, tiled)
        return dx, None, None, None, None, None


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               label: str, axis: str = AXIS, tiled: bool = True):
    """``jax.lax.all_to_all`` over ``axis`` with its transpose as the
    backward."""
    return _AllToAll.apply(x, axis, split_axis, concat_axis, tiled, label)


def _reversed(perm: Sequence[Tuple[int, int]]):
    return tuple((d, s) for s, d in perm)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, label):
        ctx.args = (axis, perm, label)
        with comm.op_label(label):
            return comm.ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        axis, perm, label = ctx.args
        with comm.op_label(label):
            dx = comm.ppermute(g.contiguous(), axis, _reversed(perm))
        return dx, None, None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], label: str,
             axis: str = AXIS):
    """``jax.lax.ppermute`` over ``axis``; the backward runs the reversed
    pairs."""
    return _Ppermute.apply(x, axis, tuple(perm), label)


def ring_perm(sp: int) -> Tuple[Tuple[int, int], ...]:
    """One hop forward around the ring: j -> j + 1."""
    return tuple((j, (j + 1) % sp) for j in range(sp))


def send_next(x: torch.Tensor, sp: int, label: str, axis: str = AXIS):
    """``x`` one hop around the ring, without a gradient (the flash ring's
    own backward moves the cotangents)."""
    with comm.op_label(label):
        return comm.ppermute(x.contiguous(), axis, ring_perm(sp))


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, label):
        with comm.op_label(label):
            return comm.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum_replicated(x: torch.Tensor, axis: str, label: str):
    """``psum`` over ``axis`` whose result every rank holds and whose
    downstream loss every rank counts once: the backward is the identity."""
    return _PsumReplicated.apply(x, axis, label)


def all_gather_ids(ids: torch.Tensor, label: str, axis: str = AXIS,
                   dim: int = 1):
    """The members' segment ids concatenated along ``dim`` (no gradient)."""
    with comm.op_label(label):
        return comm.all_gather(ids.contiguous(), axis, axis=dim, tiled=True)
