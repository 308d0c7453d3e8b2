"""qgZ (ZeRO++ quantized gradients): int8 on the wire over replica axes.

Port of ``deepspeed_tpu/runtime/zero/qgz.py:54-112`` (reference ZeRO++
``all_to_all_quant_reduce``, ``deepspeed/runtime/comm/
coalesced_collectives.py:31``, backed by ``quant_reduce.cu``). The
replica axes are the batch axes over which every parameter is replicated
(``data``; and ``fsdp`` below stage 3): their gradient reduction is a pure
all-reduce, which ``quantized_grad_sync`` runs with int8 codes + fp32
per-chunk scales on the wire (``comm.quantized_all_reduce``), about 4x
fewer bytes than fp32.

The engine calls it on the gradients summed over the micro-batches, after
the per-micro-batch reduction over the other batch axes, as the
reference's partial-manual gradient phase does (``wrap_grads_phase``,
``manual_part``: a process per rank has no ``shard_map`` region; the
engine's per-rank gradient phase is that region). Without a replica axis
the engine takes the int8 round trip of every micro-batch gradient
instead (``runtime/engine.py``).
"""

from typing import List, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm.mesh import Mesh

# leaves below this many elements reduce in full precision: norm scales and
# biases are bandwidth-irrelevant and the most quantization-sensitive
MIN_QUANT_SIZE = 2048


def _spec_axes(spec) -> Tuple[str, ...]:
    axes = []
    for entry in spec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            axes.append(a)
    return tuple(axes)


def replica_grad_axes(mesh: Mesh, batch_spec, param_specs) -> Tuple[str, ...]:
    """The batch axes whose gradient reduction is a pure replica
    all-reduce: in the batch spec, in no parameter spec, larger than 1."""
    used = set()
    for spec in param_specs:
        used.update(_spec_axes(spec))
    return tuple(a for a in _spec_axes(batch_spec)
                 if a not in used and mesh.shape.get(a, 1) > 1)


def quantizes(shape, world: int, itemsize: int) -> bool:
    """Whether ``quantized_grad_sync`` sends a gradient of ``shape`` and
    ``itemsize`` bytes an element through the int8 wire over ``world``
    ranks: two or more dimensions, at least ``MIN_QUANT_SIZE`` elements,
    and a padded wire payload smaller than the dense one."""
    from deepspeed_tpu_torch.comm.compress import (DEFAULT_CHUNK,
                                                   padded_elems,
                                                   wire_payload_bytes)
    n = 1
    for s in shape:
        n *= s
    if len(shape) < 2 or n < MIN_QUANT_SIZE:
        return False
    return wire_payload_bytes(padded_elems(n, world, DEFAULT_CHUNK)) \
        < n * itemsize


def quantized_grad_sync(grads: Sequence[torch.Tensor],
                        axes: Sequence[str]) -> List[torch.Tensor]:
    """Mean-reduce each gradient over ``axes`` with int8 on the wire: a
    leaf that ``quantizes`` rides one ``comm.quantized_all_reduce``; the
    others take a full-precision mean (``all_reduce`` AVG) in their own
    dtype."""
    from deepspeed_tpu_torch.comm.comm import (ReduceOp, all_reduce,
                                               quantized_all_reduce)
    from deepspeed_tpu_torch.comm.compress import axis_world
    axes = tuple(axes)
    world = axis_world(axes)

    def sync(g):
        if not quantizes(g.shape, world, g.element_size()):
            return all_reduce(g, axes, ReduceOp.AVG)
        out, _ = quantized_all_reduce(g.reshape(-1), axes)
        return out[:g.numel()].reshape(g.shape).to(g.dtype)

    return [sync(g) for g in grads]


def quantized_leaves(shapes: Sequence[Tuple[int, ...]], world: int,
                     itemsize: int) -> int:
    """How many leaves of ``shapes`` ``quantized_grad_sync`` quantizes."""
    return sum(quantizes(s, world, itemsize) for s in shapes)
