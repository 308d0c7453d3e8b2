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

``shard_of`` takes this rank's block of a full leaf, ``gather_full`` puts
the members' blocks back together, ``reduce_scatter_full`` sums a full
gradient over the members into this rank's block, each along the one
dimension a spec shards. ``build_param_specs`` takes model-parallel
``tensor_rules``, of which the expert rules are ported (the expert axis,
ROADMAP Queue 1 item 4); MiCS and hpZ's secondary specs
(``secondary_partition_spec``, ``build_secondary_shardings``) and the
tensor-parallel rules are not yet (item 2).
"""

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm.mesh import FSDP_AXES, Mesh
from deepspeed_tpu_torch.utils.logging import logger

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
    """(axes, world) the ZeRO policy shards over."""
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


def gather_full(shard: torch.Tensor, dim: int, axes: Sequence[str]
                ) -> torch.Tensor:
    """The members' blocks of a leaf concatenated along ``dim``."""
    from deepspeed_tpu_torch.comm import comm
    return comm.all_gather(shard, tuple(axes), axis=dim, tiled=True)


def reduce_scatter_full(full: torch.Tensor, dim: int, axes: Sequence[str]
                        ) -> torch.Tensor:
    """The sum of the members' ``full`` tensors, this rank's block along
    ``dim``."""
    from deepspeed_tpu_torch.comm import comm
    return comm.reduce_scatter(full, tuple(axes), scatter_dimension=dim)


class GatherParam(torch.autograd.Function):
    """Stage 3's compute copy: the members' compute-dtype blocks gathered
    along ``dim`` before use; the backward reduce-scatters the full
    gradient (summed over the members) into this rank's block. Under remat
    the recompute gathers again."""

    @staticmethod
    def forward(ctx, shard, dim, axes):
        ctx.dim, ctx.axes = dim, axes
        return gather_full(shard, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_full(g.contiguous(), ctx.dim, ctx.axes), \
            None, None


class ShardedParam(torch.nn.Module):
    """A parametrization (``torch.nn.utils.parametrize``) whose original is
    this rank's fp32 block of a stage-3 leaf: reading the parameter casts
    the block to the compute dtype and gathers the full leaf."""

    def __init__(self, dim: int, axes: Sequence[str], mesh: Mesh,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.dim, self.axes, self.mesh = dim, tuple(axes), mesh
        self.compute_dtype = compute_dtype

    def forward(self, shard):
        return GatherParam.apply(shard.to(self.compute_dtype), self.dim,
                                 self.axes)

    def right_inverse(self, full):
        return shard_of(full, self.dim, self.mesh, self.axes).clone()


def build_param_specs(params, mesh: Mesh, stage: int,
                      tensor_rules: Optional[Callable] = None,
                      min_shard_size: int = DEFAULT_MIN_SHARD_SIZE
                      ) -> Dict[str, Spec]:
    """The reference's ``build_param_shardings`` (``partition.py:154``) on
    the port's spec: ``params`` maps a parameter name (dotted, as
    ``named_parameters`` gives it) to a tensor or a shape; each leaf's spec
    is ``tensor_rules(name, leaf)`` (model-parallel rules such as
    ``moe_tensor_rules``: an expert leaf takes ``("expert", None, None)``)
    with the ZeRO ``stage``'s fsdp placement layered on its unused
    dimensions."""
    fsdp_axes, fsdp_size = zero_fsdp_axes(mesh)
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
               tensor_rules: Optional[Callable] = None) -> Dict[str, list]:
    """Per leaf of ``shapes`` (name -> shape, in order): the param spec
    (``build_param_specs``) and the optimizer-state spec over the mesh
    (the reference's ``build_opt_state_shardings``)."""
    fsdp_axes, fsdp_size = zero_fsdp_axes(mesh)
    params = list(build_param_specs(shapes, mesh, stage, tensor_rules)
                  .values())
    spec_of = optimizer_state_spec_fn(params, max(stage, 0), fsdp_size,
                                      fsdp_axes=fsdp_axes)
    return {"param": params,
            "opt": [spec_of(p, s) for p, s in zip(params, shapes.values())]}
