"""Megatron-style tensor-parallel layers and their collectives.

Port of ``deepspeed_tpu/module_inject/layers.py`` (reference
``deepspeed/module_inject/layers.py``: ``LinearLayer``,
``LinearAllreduce``, ``EmbeddingLayer``). Under GSPMD the JAX package
writes no collective: XLA inserts the all-reduce a row-parallel product
needs. Here each rank is a process holding its block of every sharded
leaf, so the collectives are written, as ``torch.autograd.Function``s
over the facade's ``all_reduce`` on the mesh's ``tensor`` axis:

- ``copy_to_tensor``: the identity forward and the all-reduce backward,
  before a column-parallel product (each rank's dX is a partial sum over
  its block of the outputs);
- ``reduce_from_tensor``: the all-reduce forward and the identity
  backward, after a row-parallel product (each rank's product is a
  partial sum over its block of the inputs);
- ``vocab_parallel_lookup``: rows outside this rank's block of the
  vocabulary give 0, then ``reduce_from_tensor``.

Each op is recorded by the comms logger under its ``tensor/...`` label.
At a ``tensor`` axis of one rank every op is the identity and calls no
collective.

A leaf the rules leave whole (a dimension the axis does not divide: the
JAX package's spec builder replicates it, ``runtime/zero/partition.py``)
runs the plain path at any ``tensor`` size: no copy before it, no sum
after it, what one rank computes (``block_of`` tells the two apart).

``ColumnParallelLinear``, ``RowParallelLinear`` and
``VocabParallelEmbedding`` keep the flax parameter names (``col_kernel``,
``row_kernel``, ``embedding``), so the generic AutoTP rule finds them.
Each is built at its full shape; the rules (``models/convert.py::
tp_shard``, or the engine) cut it to this rank's block, and the forward
reads the block's size from the parameter.
"""

import math
from typing import Optional

import torch
from torch import nn

TENSOR_AXIS = "tensor"
COPY_LABEL = "tensor/copy"
REDUCE_LABEL = "tensor/reduce"
EMBED_LABEL = "tensor/embed"
GATHER_LABEL = "tensor/gather"


def tensor_world() -> int:
    """The global mesh's ``tensor`` axis size (1 without a mesh)."""
    from deepspeed_tpu_torch.comm.mesh import get_global_mesh
    mesh = get_global_mesh()
    return mesh.shape[TENSOR_AXIS] if mesh is not None else 1


def tensor_rank() -> int:
    from deepspeed_tpu_torch.comm.mesh import get_global_mesh
    mesh = get_global_mesh()
    return mesh.coords[TENSOR_AXIS] if mesh is not None else 0


def _all_reduce(x: torch.Tensor, label: str) -> torch.Tensor:
    from deepspeed_tpu_torch.comm import comm
    with comm.op_label(label):
        return comm.all_reduce(x.contiguous(), TENSOR_AXIS)


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, label):
        ctx.label = label
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.label), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, label):
        return _all_reduce(x, label)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor(x: torch.Tensor, label: str = COPY_LABEL) -> torch.Tensor:
    """The input of column-parallel products: the identity, whose backward
    sums the ranks' partial dX over ``tensor``."""
    if tensor_world() == 1:
        return x
    return _CopyToTensor.apply(x, label)


def reduce_from_tensor(x: torch.Tensor,
                       label: str = REDUCE_LABEL) -> torch.Tensor:
    """The output of a row-parallel product: summed over ``tensor``; the
    backward is the identity (every rank holds the whole cotangent)."""
    if tensor_world() == 1:
        return x
    return _ReduceFromTensor.apply(x, label)


def gather_from_tensor(x: torch.Tensor, dim: int = -1,
                       label: str = GATHER_LABEL) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` (no
    gradient): the whole vocabulary of a vocab-parallel head."""
    if tensor_world() == 1:
        return x
    from deepspeed_tpu_torch.comm import comm
    with torch.no_grad(), comm.op_label(label):
        return comm.all_gather(x.detach().contiguous(), TENSOR_AXIS,
                               axis=dim % x.dim(), tiled=True)


def leaf_shape(module: nn.Module, name: str) -> torch.Size:
    """The shape parameter ``name`` of ``module`` reads as, without
    reading it: a stage-3 leaf's parametrization would gather it."""
    from torch.nn.utils import parametrize
    if not parametrize.is_parametrized(module, name):
        return getattr(module, name).shape
    plist = module.parametrizations[name]
    shape = plist.original.shape
    for pz in plist:
        shape = pz.full_shape(shape)
    return shape


def block_of(full: int, held: int, what: str) -> bool:
    """Whether a leaf holding ``held`` of ``full`` along a dimension is
    this rank's block over ``tensor`` (False: the whole leaf, at any
    ``tensor`` size); anything else raises."""
    tp = tensor_world()
    if held == full:
        return False
    if held * tp != full:
        raise ValueError(f"{what}: this rank holds {held} of {full} over a "
                         f"tensor axis of {tp}; cut the leaf to its block "
                         "by the rules (models/convert.py::tp_shard)")
    return True


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor,
                          vocab_size: int,
                          label: str = EMBED_LABEL) -> torch.Tensor:
    """``table[ids]`` where ``table`` is this rank's block of the
    ``[vocab_size, D]`` embedding over ``tensor`` (the whole table at a
    ``tensor`` axis of one): ids outside the block give 0, then the
    blocks' rows are summed over ``tensor``."""
    ids = ids.long()
    rows = table.shape[0]
    if not block_of(vocab_size, rows, "the embedding"):
        return table[ids]
    local = ids - tensor_rank() * rows
    inside = (local >= 0) & (local < rows)
    out = table[torch.where(inside, local, 0)]
    out = torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype,
                                                          device=out.device))
    return reduce_from_tensor(out, label)


class ColumnParallelLinear(nn.Module):
    """Output-dim sharded linear (reference ``LinearLayer``):
    ``col_kernel [in, features]`` (its last dim cut over ``tensor``) and
    ``col_bias [features]`` cut with it; the output stays this rank's
    block."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.col_kernel = nn.Parameter(torch.empty(in_features, features,
                                                   device=device))
        self.col_bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None
        nn.init.normal_(self.col_kernel, std=1.0 / math.sqrt(in_features))

    def forward(self, x):
        kernel = self.col_kernel
        if block_of(self.features, kernel.shape[-1], "col_kernel"):
            x = copy_to_tensor(x)
        dt = self.dtype or x.dtype
        y = x.to(dt) @ kernel.to(dt)
        if self.col_bias is not None:
            y = y + self.col_bias.to(y.dtype)
        return y


class RowParallelLinear(nn.Module):
    """Input-dim sharded linear (reference ``LinearAllreduce``):
    ``row_kernel [in, features]`` (its first dim cut over ``tensor``); the
    partial products are summed over ``tensor``, then ``row_bias``
    (replicated) is added."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.in_features, self.dtype = in_features, dtype
        self.row_kernel = nn.Parameter(torch.empty(in_features, features,
                                                   device=device))
        self.row_bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None
        nn.init.normal_(self.row_kernel, std=1.0 / math.sqrt(in_features))

    def forward(self, x):
        kernel = self.row_kernel
        dt = self.dtype or x.dtype
        y = x.to(dt) @ kernel.to(dt)
        if block_of(self.in_features, kernel.shape[0], "row_kernel"):
            y = reduce_from_tensor(y)
        if self.row_bias is not None:
            y = y + self.row_bias.to(y.dtype)
        return y


class VocabParallelEmbedding(nn.Module):
    """Vocab-dim sharded embedding table (reference ``EmbeddingLayer``
    under AutoTP's vocab rule): ``embedding [num_embeddings, features]``,
    its rows cut over ``tensor``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_embeddings, self.dtype = num_embeddings, dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features,
                                                  device=device))
        nn.init.normal_(self.embedding, std=0.02)

    def forward(self, ids):
        table = self.embedding
        if self.dtype is not None:
            table = table.to(self.dtype)
        return vocab_parallel_lookup(table, ids, self.num_embeddings)
