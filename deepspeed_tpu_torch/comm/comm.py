"""The collective facade on ``torch.distributed``.

Port of ``deepspeed_tpu/comm/comm.py`` (reference ``deepspeed/comm/
comm.py``: every collective wrapped by ``timed_op``, feeding a
``CommsLogger``). The JAX facade's ops run inside ``shard_map`` over named
mesh axes; here each takes an axis name (or a tuple) of the global mesh
(``comm.mesh.set_global_mesh``) and runs eagerly on that axis set's
process group. The semantics are ``jax.lax``'s: ``all_reduce`` is
``psum`` (``AVG``: the sum divided by the world), ``all_gather`` /
``reduce_scatter`` / ``all_to_all`` take ``axis`` / ``scatter_dimension``
/ ``split_axis`` and ``concat_axis`` with ``tiled``, ``ppermute`` takes
``(source, destination)`` pairs of axis indices (a rank that receives
nothing gets zeros), and each returns a new tensor. Over an axis set of one
rank every op is the identity.

Every op is recorded through ``_record``: the op listener
(``note_comm_op``), the cross-rank ``op_seq``, and with the comms logger
on, its bytes, world and wall time (``CommsLogger.timed``, the card
synchronized before and after: the only place the facade waits for it);
with only the tracer on, a ``comm/<op>`` instant of its analytic bytes.

**The gloo transport on the card.** NCCL takes CUDA tensors; gloo takes
them only for ``all_reduce`` and ``broadcast``. For gloo's other ops a
CUDA tensor goes through a pinned host copy and back. This is the caller's
choice of backend (two ranks on one card, where NCCL refuses a second
rank), never a fallback from a failed NCCL start. A gloo group whose ranks
share a host moves the payloads of ``all_gather``, ``all_to_all``,
``reduce_scatter``, ``all_reduce`` and ``ppermute`` through shared memory
(``comm/shm.py``), gloo keeping the barriers; a group over hosts keeps
gloo's own collectives.

``quantized_all_reduce`` and ``quantized_reduce_scatter`` run
``comm/compress.py``'s codec and are recorded once each, with the logical
and the wire bytes.

``op_label(label)`` names the ops recorded inside it ``<label>/<op>``
(kind ``<op>``), so a caller's collectives keep their own totals in the
logger: the MoE layer's dispatch, combine and gate exchanges
(``moe/sharded_moe.py``).
"""

import contextlib
import enum
from typing import Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm.comms_logging import (emit_comm_instant,
                                                    get_comms_logger)
from deepspeed_tpu_torch.comm.guard import guarded, next_op_seq, note_comm_op
from deepspeed_tpu_torch.comm.mesh import Mesh, axes_tuple, get_global_mesh
from deepspeed_tpu_torch.telemetry.tracer import get_tracer


class ReduceOp(enum.Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVG = 4


def _mesh() -> Mesh:
    mesh = get_global_mesh()
    if mesh is None:
        raise RuntimeError("no global mesh: build one with comm.create_mesh "
                           "and install it with comm.set_global_mesh")
    return mesh


def group_of(axis_name):
    """(process group or None, world) of an axis set of the global mesh."""
    mesh = _mesh()
    return mesh.group(axis_name), mesh.axis_world(axes_tuple(axis_name))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


_label: Optional[str] = None


@contextlib.contextmanager
def op_label(label: str):
    """Record the ops run inside as ``<label>/<op>`` of kind ``<op>``."""
    global _label
    saved, _label = _label, label
    try:
        yield
    finally:
        _label = saved


def _record(op_name: str, x: torch.Tensor, world: int, fn,
            nbytes: Optional[int] = None, wire_bytes: Optional[int] = None,
            kind: Optional[str] = None):
    """Run ``fn`` as the recorded op ``op_name`` on ``x``: listener,
    ``op_seq``, and the logger's timing or the tracer's instant."""
    note_comm_op(op_name)
    if _label is not None:
        op_name, kind = f"{_label}/{op_name}", kind or op_name
    logger_ = get_comms_logger()
    tracer = get_tracer()
    if not (logger_.enabled or tracer.enabled):
        return fn()
    # op_seq: the cross-rank join key; every rank records its collectives
    # in the same order, so the k-th op matches across ranks
    op_seq = next_op_seq()
    if nbytes is None:
        nbytes = _nbytes(x)
    if logger_.enabled:
        _sync(x)
        with logger_.timed(op_name, nbytes, world, wire_bytes=wire_bytes,
                           kind=kind, op_seq=op_seq):
            out = fn()
            _sync(x)
        return out
    emit_comm_instant(op_name, nbytes, world, wire_bytes=wire_bytes,
                      kind=kind, op_seq=op_seq)
    return fn()


# ---------------------------------------------------------------------------
# transport: gloo on one host through shared memory; over hosts gloo on
# CUDA tensors goes through pinned host copies
# ---------------------------------------------------------------------------
def _channel(group):
    """The group's shared-memory channel (``comm/shm.py``) or None."""
    from deepspeed_tpu_torch.comm import shm
    return shm.channel(group)


def _staged(group, x: torch.Tensor) -> bool:
    import torch.distributed as dist
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _host_empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


#: codes no backend reduces travel as their bytes (moving ops only)
_BYTE_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint8) if x.dtype in _BYTE_DTYPES else x


def raw_all_gather(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """[w, *x.shape]: row j is group rank j's ``x`` (unrecorded). The
    buffers are flat, the one layout every backend takes."""
    import torch.distributed as dist
    if group is None:
        return x[None]
    if x.dtype in _BYTE_DTYPES:
        return raw_all_gather(_as_bytes(x), group, world).view(x.dtype)
    ch = _channel(group)
    if ch is not None:
        return ch.all_gather(x)
    flat = x.reshape(-1)
    if _staged(group, x):
        out = _host_empty((world * flat.numel(),), x.dtype)
        dist.all_gather_into_tensor(out, _host(flat), group=group)
        out = out.to(x.device)
    else:
        out = torch.empty(world * flat.numel(), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, flat.contiguous(), group=group)
    return out.view(world, *x.shape)


def raw_all_to_all(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """x [w, ...]: row j goes to group rank j; row j of the result came
    from group rank j (unrecorded)."""
    import torch.distributed as dist
    if group is None:
        return x.clone()
    if x.shape[0] != world:
        raise ValueError(f"all_to_all rows {x.shape[0]} != world {world}")
    if x.dtype in _BYTE_DTYPES:
        return raw_all_to_all(_as_bytes(x), group, world).view(x.dtype)
    ch = _channel(group)
    if ch is not None:
        return ch.all_to_all(x)
    flat = x.reshape(-1)
    if _staged(group, x):
        out = _host_empty(flat.shape, x.dtype)
        dist.all_to_all_single(out, _host(flat), group=group)
        out = out.to(x.device)
    else:
        out = torch.empty_like(flat)
        dist.all_to_all_single(out, flat.contiguous(), group=group)
    return out.view(x.shape)


def raw_reduce_scatter(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """x [w, ...] -> the sum over the group of row (my index) (unrecorded)."""
    import torch.distributed as dist
    if group is None:
        return x[0].clone()
    ch = _channel(group)
    if ch is not None:
        return ch.reduce_scatter(x, _COMBINE[ReduceOp.SUM])
    flat = x.reshape(-1)
    m = flat.numel() // world
    if _staged(group, x):
        out = _host_empty((m,), x.dtype)
        dist.reduce_scatter_tensor(out, _host(flat), group=group)
        out = out.to(x.device)
    else:
        out = torch.empty(m, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
    return out.view(x.shape[1:])


# the reduce ops the reference's facade takes (psum, pmax, pmin)
_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.AVG: "SUM",
              ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN"}
# the shared-memory channel's combine of two partials (the first is new)
_COMBINE = {ReduceOp.SUM: lambda a, b: a.add_(b),
            ReduceOp.AVG: lambda a, b: a.add_(b),
            ReduceOp.MAX: torch.maximum, ReduceOp.MIN: torch.minimum}


def raw_all_reduce(x: torch.Tensor, group, world: int,
                   op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: the reduction over the group (``AVG``: the sum, then a
    true division by the world, as ``psum(x) / n``). Unrecorded."""
    import torch.distributed as dist
    if group is None:
        return x
    ch = _channel(group)
    if ch is not None:
        y = ch.all_reduce(x, _COMBINE[op])
    else:
        y = x.contiguous().clone()
        dist.all_reduce(y, op=getattr(dist.ReduceOp, _TORCH_OPS[op]),
                        group=group)
    return y / world if op == ReduceOp.AVG else y


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------
def all_reduce(x: torch.Tensor, axis_name, op: ReduceOp = ReduceOp.SUM):
    """reference: comm.py all_reduce; ``jax.lax.psum`` / ``pmax`` /
    ``pmin`` over the axes (``AVG``: psum / n)."""
    if op not in _TORCH_OPS:
        raise NotImplementedError(f"reduce op {op}")
    group, world = group_of(axis_name)
    return _record("all_reduce", x, world,
                   lambda: raw_all_reduce(x, group, world, op))


def all_gather(x: torch.Tensor, axis_name, axis: int = 0,
               tiled: bool = True):
    """reference: all_gather_into_tensor; ``jax.lax.all_gather``: the
    members' ``x`` concatenated along ``axis`` (``tiled``) or stacked on a
    new axis there."""
    group, world = group_of(axis_name)

    def run():
        parts = raw_all_gather(x, group, world).movedim(0, axis)
        if not tiled:
            return parts
        shape = list(x.shape)
        shape[axis] *= world
        return parts.reshape(shape)
    return _record("all_gather", x, world, run)


def reduce_scatter(x: torch.Tensor, axis_name, scatter_dimension: int = 0,
                   tiled: bool = True):
    """reference: reduce_scatter_fn; ``jax.lax.psum_scatter``: the sum
    over the members, this member's block of ``scatter_dimension`` (untiled:
    that dimension is the world and drops out)."""
    group, world = group_of(axis_name)
    d = scatter_dimension

    def run():
        n = x.shape[d]
        if n % world:
            raise ValueError(f"reduce_scatter: dim {d} of {tuple(x.shape)} "
                             f"not divisible by {world}")
        blocks = x.movedim(d, 0).reshape(world, n // world, *x.shape[:d],
                                         *x.shape[d + 1:])
        out = raw_reduce_scatter(blocks, group, world)
        return out.movedim(0, d) if tiled else out[0]
    return _record("reduce_scatter", x, world, run)


def _all_to_all(x, group, world, split_axis, concat_axis, tiled):
    n = x.shape[split_axis]
    if n % world:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"not divisible by {world}")
    rows = x.movedim(split_axis, 0).reshape(world, n // world,
                                            *x.shape[:split_axis],
                                            *x.shape[split_axis + 1:])
    got = raw_all_to_all(rows, group, world)
    pieces = [got[j].movedim(0, split_axis) for j in range(world)]
    if tiled:
        return torch.cat(pieces, dim=concat_axis)
    return torch.stack([p.squeeze(split_axis) for p in pieces],
                       dim=concat_axis)


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int, tiled: bool = True):
    """reference: single_all_to_all, MoE dispatch; ``jax.lax.all_to_all``:
    ``split_axis`` cut into one block per member, block j sent to member j,
    the received blocks concatenated along ``concat_axis`` (untiled: the
    split axis is the world and the blocks are stacked there)."""
    group, world = group_of(axis_name)
    return _record("all_to_all", x, world,
                   lambda: _all_to_all(x, group, world, split_axis,
                                       concat_axis, tiled))


def ppermute(x: torch.Tensor, axis_name, perm: Sequence[Tuple[int, int]]):
    """Ring shift (reference pipe/p2p send/recv pairs); ``perm`` holds
    (source, destination) axis indices; a member that receives nothing
    gets zeros."""
    import torch.distributed as dist
    mesh = _mesh()
    group, world = group_of(axis_name)
    me = mesh.axis_index(axis_name)

    def run():
        out = torch.zeros_like(x)
        if group is None:
            return x.clone() if any(s == d == 0 for s, d in perm) else out
        ch = _channel(group)
        if ch is not None:
            return ch.permute(x, next((s for s, d in perm if d == me), None))
        staged = _staged(group, x)
        src_t = _host(x) if staged else x.contiguous()
        dst_t = _host_empty(x.shape, x.dtype) if staged else out
        received = False
        reqs = []
        for s, d in perm:
            if s == me and d == me:
                dst_t.copy_(src_t)
                received = True
            elif s == me:
                reqs.append(dist.isend(src_t, dist.get_global_rank(group, d),
                                       group=group))
            elif d == me:
                reqs.append(dist.irecv(dst_t, dist.get_global_rank(group, s),
                                       group=group))
                received = True
        for r in reqs:
            r.wait()
        if staged and received:
            out.copy_(dst_t)
        return out
    return _record("ppermute", x, len(perm) if perm else 1, run)


def broadcast_one_to_all(x: torch.Tensor, axis_name, root: int = 0):
    """reference: comm.py broadcast: member ``root``'s value on every
    member."""
    group, world = group_of(axis_name)
    return _record("broadcast", x, world,
                   lambda: x if group is None else raw_broadcast(x, group,
                                                                 root))


def barrier(axis_name):
    """reference: dist.barrier; as the JAX facade, a sum of ones over the
    axes (returns the world as a float32 scalar)."""
    mesh = _mesh()
    group, world = group_of(axis_name)
    return raw_all_reduce(torch.ones((), device=mesh.device), group, world)


# ---------------------------------------------------------------------------
# quantized collectives (comm/compress.py, facade-recorded)
# ---------------------------------------------------------------------------
def quantized_all_reduce(x: torch.Tensor, axis_name,
                         op: ReduceOp = ReduceOp.AVG,
                         wire_dtype: str = "int8", chunk: Optional[int] = None,
                         error=None):
    """All-reduce with int8/fp8 codes + per-chunk fp32 scales on the wire
    (``comm/compress.py``: reduce-scatter, server re-quantize, regather).
    ``x`` is flat [n]; ``error`` an optional ``compress.TensorEF`` (worker
    [n_pad], server [n_pad / W]). Returns ``(out [n_pad], new_error)``
    (``new_error`` None when ``error`` is); recorded with the logical and
    the wire bytes."""
    from deepspeed_tpu_torch.comm import compress
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError(f"quantized reduce op {op}")
    axes = axes_tuple(axis_name)
    chunk = compress.DEFAULT_CHUNK if chunk is None else chunk
    world = compress.axis_world(axes)

    def run():
        out, w_err, s_err = compress.all_reduce_impl(
            x, axes, wire_dtype, chunk,
            worker_error=None if error is None else error.worker,
            server_error=None if error is None else error.server,
            mean=(op == ReduceOp.AVG))
        new_error = None if error is None else compress.TensorEF(
            worker=w_err, server=s_err)
        return out, new_error
    return _record("quantized_all_reduce", x, world, run,
                   wire_bytes=compress.all_reduce_wire_bytes(
                       x.numel(), world, wire_dtype, chunk),
                   kind="all_reduce")


def quantized_reduce_scatter(x: torch.Tensor, axis_name,
                             op: ReduceOp = ReduceOp.AVG,
                             wire_dtype: str = "int8",
                             chunk: Optional[int] = None, error=None):
    """Quantized reduce-scatter (the all-reduce's first phase): flat [n]
    in, this member's reduced shard [n_pad / W] out. ``error`` is the
    worker residual [n_pad] or None. Returns ``(shard, new_error)``."""
    from deepspeed_tpu_torch.comm import compress
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError(f"quantized reduce op {op}")
    axes = axes_tuple(axis_name)
    chunk = compress.DEFAULT_CHUNK if chunk is None else chunk
    world = compress.axis_world(axes)
    return _record("quantized_reduce_scatter", x, world,
                   lambda: compress.reduce_scatter_impl(
                       x, axes, wire_dtype, chunk, worker_error=error,
                       mean=(op == ReduceOp.AVG)),
                   wire_bytes=compress.reduce_scatter_wire_bytes(
                       x.numel(), world, wire_dtype, chunk),
                   kind="reduce_scatter")


# ---------------------------------------------------------------------------
# eager host-driven helpers
# ---------------------------------------------------------------------------
def device_broadcast(x, mesh: Mesh):
    """Replicate rank 0's host array on every rank's device (reference
    ``_broadcast_model``, params replicated from rank 0), under the active
    ``CommGuard`` when one is installed."""
    import numpy as np

    def run():
        t = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x))
        t = t.to(mesh.device)
        group = mesh.group(mesh.axis_names)
        if group is None:
            return t
        return _record("device_broadcast", t, mesh.size,
                       lambda: raw_broadcast(t, group))
    return guarded("device_broadcast", run)


def raw_broadcast(x: torch.Tensor, group, root: int = 0) -> torch.Tensor:
    import torch.distributed as dist
    y = x.contiguous().clone()
    dist.broadcast(y, dist.get_global_rank(group, root), group=group)
    return y
