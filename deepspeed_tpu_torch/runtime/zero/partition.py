"""ZeRO stages as partition specs, and the torch functions that apply them.

Port of ``deepspeed_tpu/runtime/zero/partition.py`` (reference
``deepspeed/runtime/zero/stage_1_and_2.py:97``, ``stage3.py``,
``partition_parameters.py``). The JAX package turns a stage into a
``PartitionSpec`` per parameter and optimizer-state leaf and lets XLA emit
the collectives. The port keeps the same policy on a port-side spec, a
tuple with one entry per dimension (``None``, an axis name or a tuple of
axis names; ``()`` is replicated, as ``PartitionSpec()``), and applies it
with explicit collectives over the mesh's process groups:

  stage 0 - params, grads, optimizer states replicated over the DP axes
  stage 1 - optimizer states sharded over (fsdp_out, fsdp)
  stage 2 - + gradients reduce-scattered into the shard
  stage 3 - + parameters sharded over (fsdp_out, fsdp) (FSDP)

Hierarchical variants split the ZeRO world into ``fsdp_out`` x ``fsdp``
(reference ``partition.py:21-30``):

- **MiCS** (``mics=True``): every spec shards over the inner ``fsdp`` axis
  only, replicated across ``fsdp_out`` (``zero_fsdp_axes``), so
  ``fsdp_out`` is a replica axis whose gradients are summed by all-reduce.
- **ZeRO++ hpZ**: masters and moments keep the (fsdp_out, fsdp) block,
  and the compute copy takes the secondary spec (``secondary_partition_
  spec``: ``fsdp`` only). The engine gathers each leaf's block over
  ``fsdp_out`` once a micro-batch (``GatherParam`` with the ``hpz`` label,
  or ``QwzHop``: int8 codes and per-row scales, qwZ) and ``ShardedParam``
  gathers that secondary block over ``fsdp`` at each use. For the first
  hop to be a gather over ``fsdp_out``, a block's index along its
  dimension is fsdp-major, ``f * fsdp_out + o`` (``HPZ_BLOCK_AXES``): the
  secondary block ``f`` is then the primary blocks of the ``fsdp_out``
  members that share ``f``. The reference's primary layout is o-major;
  the full leaf, its moments and every result are the same.

``shard_of`` takes this rank's block of a full leaf (``block_slices`` the
index of the block after several cuts, for a checkpoint's slice read),
``gather_full`` puts
the members' blocks back together, ``reduce_scatter_full`` sums a full
gradient over the members into this rank's block, each along the one
dimension a spec shards, the block index row-major over the axes in the
order given; ``sum_over_blocks`` sums per-leaf block sums over the ranks
that cut each leaf (the global norm's squares, LAMB's whole-leaf
norms). ``build_param_specs`` takes model-parallel ``tensor_rules``:
the expert rules (``moe_tensor_rules``) and the Megatron rules
(``models/llama.py::llama_tensor_rules``, ``module_inject/``'s
policies). A leaf a rule shards over ``tensor`` or ``expert`` takes
``fsdp`` on another dimension, chosen on the global shape as the JAX
package's ``build_param_shardings`` does (``partition.py:155-185``). The
engine first cuts such a leaf to this rank's block over that axis; the
stage-3 ``ShardedParam`` then holds its block over the ZeRO axes and
gathers over them only, so a read gives this rank's tensor block and
never the whole leaf.
"""

import contextlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm.mesh import FSDP_AXES, Mesh
from deepspeed_tpu_torch.utils.logging import logger

#: the axis order of an hpZ stage-3 block's index (fsdp-major)
HPZ_BLOCK_AXES = ("fsdp", "fsdp_out")
#: the comms logger's label of the hpZ hop over ``fsdp_out``
HPZ_LABEL = "hpz"

# Minimum leaf size worth sharding; tiny leaves (biases, norms) stay
# replicated (the reference's stage-3 persistence threshold)
DEFAULT_MIN_SHARD_SIZE = 2 ** 11

Spec = Tuple

_warned = set()


def _warning_once(msg: str) -> None:
    if msg not in _warned:
        _warned.add(msg)
        logger.warning(msg)


def _choose_fsdp_dim(shape, fsdp_size: int, taken_dims) -> Optional[int]:
    """The largest dimension divisible by the fsdp world size, the first
    one on a tie."""
    candidates = [d for d in range(len(shape))
                  if d not in taken_dims and shape[d] % fsdp_size == 0
                  and shape[d] >= fsdp_size]
    if not candidates:
        return None
    return max(candidates, key=lambda d: (shape[d], -d))


def _normalize_axes(fsdp_axes: Sequence[str]):
    """A single axis goes in bare; several as a tuple entry."""
    axes = tuple(fsdp_axes)
    return axes[0] if len(axes) == 1 else axes


def _spec(base) -> Spec:
    return tuple(base) if any(a is not None for a in base) else ()


def param_partition_spec(shape, stage: int, fsdp_size: int,
                         tensor_spec: Optional[Spec] = None,
                         min_shard_size: int = DEFAULT_MIN_SHARD_SIZE,
                         axis_sizes: Optional[dict] = None,
                         fsdp_axes: Sequence[str] = FSDP_AXES) -> Spec:
    """The spec of a parameter leaf under ZeRO ``stage``: replicated below
    stage 3, under ``min_shard_size`` elements or with no dimension the
    fsdp world divides; else ``fsdp_axes`` on the largest such dimension
    (layered on ``tensor_spec``'s unused dimensions)."""
    ndim = len(shape)
    base = list(tensor_spec) if tensor_spec is not None else []
    base = base + [None] * (ndim - len(base))
    if axis_sizes:
        for i, ax in enumerate(base):
            if ax is not None and shape[i] % axis_sizes.get(ax, 1) != 0:
                _warning_once(f"dim {i} of shape {shape} not divisible by "
                              f"{ax}={axis_sizes.get(ax)}; replicating that dim")
                base[i] = None
    if stage < 3 or fsdp_size <= 1:
        return _spec(base)
    if int(math.prod(shape)) < min_shard_size:
        return _spec(base)
    taken = {i for i, a in enumerate(base) if a is not None}
    dim = _choose_fsdp_dim(shape, fsdp_size, taken)
    if dim is None:
        _warning_once(f"param of shape {shape} not divisible by "
                      f"fsdp={fsdp_size}; replicated")
        return _spec(base)
    base[dim] = _normalize_axes(fsdp_axes)
    return tuple(base)


def optimizer_state_spec_fn(param_specs, stage: int, fsdp_size: int,
                            min_shard_size: int = DEFAULT_MIN_SHARD_SIZE,
                            fsdp_axes: Sequence[str] = FSDP_AXES):
    """A function (param spec, shape) -> the spec of an optimizer-state
    leaf of that shape: stage >= 1 shards moments over the ZeRO world like
    a stage-3 param (stage 3: the param's own spec); stage 0 follows the
    param."""
    def spec_for(param_spec: Spec, shape) -> Spec:
        if stage == 0 or fsdp_size <= 1:
            return param_spec
        if stage >= 3:
            return param_spec
        return param_partition_spec(shape, stage=3, fsdp_size=fsdp_size,
                                    tensor_spec=param_spec,
                                    min_shard_size=min_shard_size,
                                    fsdp_axes=fsdp_axes)
    return spec_for


def zero_fsdp_axes(mesh: Mesh, mics: bool = False
                   ) -> Tuple[Sequence[str], int]:
    """(axes, world) the ZeRO policy shards over: the full hierarchical
    world, or the inner ``fsdp`` axis only under MiCS."""
    if mics:
        return ("fsdp",), mesh.shape["fsdp"]
    axes = tuple(a for a in FSDP_AXES if a in mesh.shape)
    world = int(math.prod([mesh.shape[a] for a in axes]))
    return axes, world


def zero_placement(mesh_shape: dict, stage: int,
                   offload_optimizer: str = "none",
                   offload_param: str = "none") -> dict:
    """The ZeRO placement signature of a mesh and stage (recorded in a
    checkpoint's provenance by the JAX package)."""
    sizes = {a: int(mesh_shape.get(a, 1) or 1) for a in FSDP_AXES}
    return {
        "stage": int(stage),
        "zero_world": int(math.prod(list(sizes.values()))),
        "sharded_axes": [a for a in FSDP_AXES if sizes[a] > 1],
        "offload_optimizer": str(offload_optimizer),
        "offload_param": str(offload_param),
    }


# ---------------------------------------------------------------------------
# applying a spec
# ---------------------------------------------------------------------------
def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def sharded_dim(spec: Spec, axes: Sequence[str] = FSDP_AXES
                ) -> Optional[int]:
    """The dimension ``spec`` shards over any of ``axes``, or None."""
    for i, entry in enumerate(spec):
        if set(_entry_axes(entry)) & set(axes):
            return i
    return None


def shard_of(full: torch.Tensor, dim: int, mesh: Mesh,
             axes: Sequence[str]) -> torch.Tensor:
    """This rank's block of ``full`` along ``dim`` over ``axes`` (a view)."""
    w = mesh.axis_world(axes)
    n = full.shape[dim] // w
    return full.narrow(dim, mesh.axis_index(axes) * n, n)


def block_slices(shape, cuts, mesh: Mesh) -> Tuple[slice, ...]:
    """The index of this rank's block of a whole leaf of ``shape``, cut by
    ``cuts`` (``(dim, axes)`` pairs in the order the engine cuts: expert,
    tensor, then the ZeRO block; a ``dim`` of None is skipped), as
    ``shard_of`` applied cut after cut takes it. A checkpoint's whole-leaf
    file read at this index gives the rank's block at any world, stage or
    tier (``checkpoint/engine.py``)."""
    starts, sizes = [0] * len(shape), list(shape)
    for d, axes in cuts:
        if d is None:
            continue
        n = sizes[d] // mesh.axis_world(axes)
        starts[d] += mesh.axis_index(axes) * n
        sizes[d] = n
    return tuple(slice(s, s + n) for s, n in zip(starts, sizes))


def _hops(mesh: Mesh, axes: Sequence[str]) -> Tuple[Tuple[str, ...], ...]:
    """How a block index row-major over ``axes`` is gathered: one group
    when the live axes come in mesh order (the group's member order), else
    one axis at a time from the innermost."""
    axes = tuple(axes)
    live = mesh.live_axes(axes)
    if tuple(a for a in axes if a in live) == live:
        return (axes,)
    return tuple((a,) for a in reversed(axes))


def gather_full(shard: torch.Tensor, dim: int, axes: Sequence[str]
                ) -> torch.Tensor:
    """The members' blocks of a leaf concatenated along ``dim``, block
    ``axis_index(axes)`` from each member."""
    from deepspeed_tpu_torch.comm import comm
    for hop in _hops(comm._mesh(), axes):
        shard = comm.all_gather(shard, hop, axis=dim, tiled=True)
    return shard


def reduce_scatter_full(full: torch.Tensor, dim: int, axes: Sequence[str]
                        ) -> torch.Tensor:
    """The sum of the members' ``full`` tensors, this rank's block
    (``axis_index(axes)``) along ``dim``."""
    from deepspeed_tpu_torch.comm import comm
    for hop in reversed(_hops(comm._mesh(), axes)):
        full = comm.reduce_scatter(full, hop, scatter_dimension=dim)
    return full


def sum_over_blocks(sums: Sequence[torch.Tensor],
                    cuts: Sequence[Tuple[Sequence[Optional[int]],
                                         Sequence[str]]]) -> list:
    """Per-leaf sums (one tensor a leaf, e.g. a block's sum of squares)
    made whole-leaf: for each ``(dims, axes)`` of ``cuts``, the sums of the
    leaves whose ``dims`` entry is not None (a block over ``axes``) are
    summed over ``axes`` in one all-reduce of their stack, one cut after
    another. A leaf no cut names counts once. Every rank must call it with
    the same leaves and cuts. Used by the engine's global gradient norm and
    by LAMB's trust ratio (``ops/optimizers.py``)."""
    from deepspeed_tpu_torch.comm import comm
    out = list(sums)
    for dims, axes in cuts:
        idx = [i for i, d in enumerate(dims) if d is not None]
        if not idx:
            continue
        red = comm.all_reduce(torch.stack([out[i] for i in idx]), axes)
        for k, i in enumerate(idx):
            out[i] = red[k]
    return out


class GatherParam(torch.autograd.Function):
    """Stage 3's compute copy: the members' compute-dtype blocks gathered
    along ``dim`` before use; the backward reduce-scatters the full
    gradient (summed over the members) into this rank's block. Under remat
    the recompute gathers again. ``label`` names both in the comms logger
    (``comm.op_label``)."""

    @staticmethod
    def forward(ctx, shard, dim, axes, label=None):
        from deepspeed_tpu_torch.comm import comm
        ctx.dim, ctx.axes, ctx.label = dim, axes, label
        with comm.op_label(label) if label else contextlib.nullcontext():
            return gather_full(shard, dim, axes)

    @staticmethod
    def backward(ctx, g):
        from deepspeed_tpu_torch.comm import comm
        with comm.op_label(ctx.label) if ctx.label \
                else contextlib.nullcontext():
            g = reduce_scatter_full(g.contiguous(), ctx.dim, ctx.axes)
        return g, None, None, None


def qwz_codes(block: torch.Tensor, dim: int, row_axes: Sequence[str]):
    """qwZ's int8 codes and fp32 scales of a compute-dtype block, the
    scale of each row that of the whole leaf's row (``_qwz_regather``'s
    ``max |leaf|`` over the last axis): ``quantize_int8`` gives the block's
    own rows' scales; a block cut along its last axis holds pieces of the
    rows, so their scales take the max over ``row_axes`` (the members
    holding the other pieces) and the codes are made again with it
    (``quantize_int8_scaled``). The map from absmax to scale is monotone,
    so the max of the pieces' scales is the row's scale."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops.quant import (quantize_int8,
                                               quantize_int8_scaled)
    codes, scales = quantize_int8(block)
    if dim == block.dim() - 1 and comm.group_of(row_axes)[1] > 1:
        scales = comm.all_reduce(scales, tuple(row_axes), comm.ReduceOp.MAX)
        codes = quantize_int8_scaled(block, scales)
    return codes, scales


class QwzHop(torch.autograd.Function):
    """ZeRO++ qwZ's hop (reference ``_qwz_regather``, ``engine.py:96-122``;
    quantized-weights all-gather, ``partition_parameters.py:761``): the
    primary block goes over ``axes`` as int8 codes (``qwz_codes``) and
    fp32 per-row scales (gathered along ``dim`` unless ``dim`` is the last
    axis, where every member holds the same scales), and is dequantized to
    its dtype. The gradient is straight through: the identity on the
    gathered block, then the hop's reduce-scatter into this rank's block.
    Both are recorded under the ``hpz`` label."""

    @staticmethod
    def forward(ctx, block, dim, axes, row_axes):
        from deepspeed_tpu_torch.comm import comm
        from deepspeed_tpu_torch.ops.quant import dequantize_int8
        ctx.dim, ctx.axes = dim, axes
        with comm.op_label(HPZ_LABEL):
            codes, scales = qwz_codes(block, dim, row_axes)
            codes = comm.all_gather(codes, axes, axis=dim, tiled=True)
            if dim != block.dim() - 1:
                scales = comm.all_gather(scales, axes, axis=dim, tiled=True)
        return dequantize_int8(codes, scales, dtype=block.dtype)

    @staticmethod
    def backward(ctx, g):
        from deepspeed_tpu_torch.comm import comm
        with comm.op_label(HPZ_LABEL):
            g = reduce_scatter_full(g.contiguous(), ctx.dim, ctx.axes)
        return g, None, None, None


class ShardedParam(torch.nn.Module):
    """A parametrization (``torch.nn.utils.parametrize``) whose original is
    this rank's fp32 block of a stage-3 leaf (block ``axis_index
    (block_axes)`` of the leaf): reading the parameter casts the block to
    the compute dtype and gathers the full leaf over ``axes``. Under hpZ
    (``secondary=True``) it gathers ``self.secondary`` instead, the block
    the engine made for this micro-batch (reading it without one raises)."""

    def __init__(self, dim: int, axes: Sequence[str], mesh: Mesh,
                 compute_dtype: torch.dtype,
                 block_axes: Optional[Sequence[str]] = None,
                 secondary: bool = False):
        super().__init__()
        self.dim, self.axes, self.mesh = dim, tuple(axes), mesh
        self.block_axes = tuple(block_axes or axes)
        self.compute_dtype = compute_dtype
        self.uses_secondary = secondary
        self.secondary: Optional[torch.Tensor] = None

    def forward(self, shard):
        if not self.uses_secondary:
            return GatherParam.apply(shard.to(self.compute_dtype), self.dim,
                                     self.axes)
        if self.secondary is None:
            raise RuntimeError("hpZ: the parameter was read outside the "
                               "engine's compute copy (no secondary block)")
        return GatherParam.apply(self.secondary, self.dim, self.axes)

    def right_inverse(self, full):
        return shard_of(full, self.dim, self.mesh, self.block_axes).clone()

    def full_shape(self, shape) -> torch.Size:
        """The shape a read gives, from the block's ``shape`` (no gather)."""
        shape = list(shape)
        shape[self.dim] *= self.mesh.axis_world(self.block_axes)
        return torch.Size(shape)


def secondary_partition_spec(spec: Spec) -> Spec:
    """ZeRO++ hpZ's secondary spec (reference ``partition.py:187-200``):
    a dimension sharded over the hierarchical world shards over the inner
    ``fsdp`` axis only, so the compute copy is replicated across
    ``fsdp_out``."""
    def fix(entry):
        if isinstance(entry, (tuple, list)) and "fsdp" in entry:
            rest = tuple(a for a in entry if a not in FSDP_AXES)
            return rest + ("fsdp",) if rest else "fsdp"
        if entry in FSDP_AXES:
            return "fsdp"
        return entry
    return tuple(fix(e) for e in spec)


def build_secondary_specs(param_specs: Sequence[Spec]) -> list:
    """hpZ's compute-copy specs from the primary param specs (the
    reference's ``build_secondary_shardings``)."""
    return [secondary_partition_spec(s) for s in param_specs]


def build_param_specs(params, mesh: Mesh, stage: int,
                      tensor_rules: Optional[Callable] = None,
                      min_shard_size: int = DEFAULT_MIN_SHARD_SIZE,
                      mics: bool = False) -> Dict[str, Spec]:
    """The reference's ``build_param_shardings`` (``partition.py:154``) on
    the port's spec: ``params`` maps a parameter name (dotted, as
    ``named_parameters`` gives it) to a tensor or a shape; each leaf's spec
    is ``tensor_rules(name, leaf)`` (model-parallel rules such as
    ``moe_tensor_rules``: an expert leaf takes ``("expert", None, None)``)
    with the ZeRO ``stage``'s fsdp placement layered on its unused
    dimensions (``mics``: over the inner ``fsdp`` axis only)."""
    fsdp_axes, fsdp_size = zero_fsdp_axes(mesh, mics=mics)
    axis_sizes = dict(mesh.shape)
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf) if isinstance(leaf, (tuple, list, torch.Size)) \
            else tuple(leaf.shape)
        tspec = tensor_rules(name, leaf) if tensor_rules else None
        out[name] = param_partition_spec(shape, stage, fsdp_size,
                                         tensor_spec=tspec,
                                         min_shard_size=min_shard_size,
                                         axis_sizes=axis_sizes,
                                         fsdp_axes=fsdp_axes)
    return out


def leaf_specs(shapes: Dict[str, Tuple[int, ...]], mesh: Mesh, stage: int,
               tensor_rules: Optional[Callable] = None,
               mics: bool = False) -> Dict[str, list]:
    """Per leaf of ``shapes`` (name -> shape, in order): the param spec
    (``build_param_specs``) and the optimizer-state spec over the mesh
    (the reference's ``build_opt_state_shardings``; ``mics``: over the
    inner ``fsdp`` axis only)."""
    fsdp_axes, fsdp_size = zero_fsdp_axes(mesh, mics=mics)
    params = list(build_param_specs(shapes, mesh, stage, tensor_rules,
                                    mics=mics).values())
    spec_of = optimizer_state_spec_fn(params, max(stage, 0), fsdp_size,
                                      fsdp_axes=fsdp_axes)
    return {"param": params,
            "opt": [spec_of(p, s) for p, s in zip(params, shapes.values())]}
