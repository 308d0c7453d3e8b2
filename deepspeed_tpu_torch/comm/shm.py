"""The shared-memory transport of a gloo group whose ranks share a host.

gloo moves every byte through a TCP socket, and between processes of one
host that ran at 0.3-0.6 GB/s (``PERF.md``). Ranks of one host exchange
through shared memory instead: each rank owns one segment of
``Channel.CAPACITY`` bytes under ``/dev/shm``, and a payload goes in
pieces that fit it. For each piece:

1. copy this rank's piece into its own segment;
2. a gloo barrier, so every piece is in place;
3. read from the peers' segments what this rank needs;
4. a gloo barrier, so no segment is written while a peer still reads it.

On the card the segments are registered with CUDA (``cudaHostRegister``)
once: steps 1 and 3 are DMA copies at the host link's rate. A sum is taken
in group-rank order, one add at a time in the payload's dtype, so every
rank of an all-reduce holds the same bits.

A segment's name is unlinked as soon as every peer has mapped it, so a
killed rank leaves nothing under ``/dev/shm``. ``channel(group)`` answers
None for a group that is not gloo or whose ranks do not all read one test
file there (another host); such a group keeps gloo's own collectives.
"""

import mmap
import os
import secrets
from typing import Callable, Dict, List, Optional

import torch

from deepspeed_tpu_torch.utils.logging import logger

_SHM_DIR = "/dev/shm"


class _Segment:
    """One rank's mapped segment: its bytes as a uint8 tensor."""

    def __init__(self, path: str, nbytes: int, create: bool):
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, nbytes)
            self.map = mmap.mmap(fd, nbytes)
        finally:
            os.close(fd)
        self.bytes = torch.frombuffer(self.map, dtype=torch.uint8)
        self.registered = False

    def register(self) -> None:
        """Page-lock the mapping for the card's DMA copies."""
        if self.registered:
            return
        rc = torch.cuda.cudart().cudaHostRegister(
            self.bytes.data_ptr(), self.bytes.numel(), 0)
        if int(rc) != 0:
            raise RuntimeError(f"cudaHostRegister of {self.bytes.numel()} "
                               f"shared bytes failed ({rc})")
        self.registered = True

    def view(self, dtype: torch.dtype, shape) -> torch.Tensor:
        n = torch.Size(shape).numel() * dtype.itemsize
        return self.bytes[:n].view(dtype).view(shape)


class Channel:
    """The segments of one group: ``segments[j]`` is group rank j's. Each
    op takes its payload as [rows, columns] and moves it a block of
    columns at a time."""

    #: bytes of a rank's segment, set when the channel maps it
    CAPACITY = 256 << 20

    def __init__(self, group, world: int, me: int, name: str):
        self.group = group
        self.world = world
        self.me = me
        self.name = name
        self.segments: List[_Segment] = []

    def _barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.group)

    def _open(self) -> None:
        """Every rank at once: map the group's segments."""
        path = os.path.join(_SHM_DIR, f"{self.name}_{{}}")
        own = _Segment(path.format(self.me), self.CAPACITY, create=True)
        self._barrier()                  # every segment exists
        self.segments = [own if j == self.me else
                         _Segment(path.format(j), self.CAPACITY, create=False)
                         for j in range(self.world)]
        self._barrier()                  # every peer mapped mine
        os.unlink(path.format(self.me))

    # -- one exchange --------------------------------------------------------
    def exchange(self, x2: torch.Tensor,
                 read: Callable[[List[torch.Tensor], int, int], None]) -> None:
        """``x2`` [rows, columns]: for each block of columns [a, b) that
        fits a segment, write ``x2[:, a:b]`` into this rank's segment, then
        ``read(views, a, b)``, the group's blocks in group-rank order."""
        if not self.segments:
            self._open()
        cuda = x2.is_cuda
        if cuda:
            for seg in self.segments:
                seg.register()
        rows, cols = x2.shape
        width = self.segments[0].bytes.numel() // (rows * x2.element_size())
        for a in range(0, cols, width):
            b = min(cols, a + width)
            views = [seg.view(x2.dtype, (rows, b - a))
                     for seg in self.segments]
            views[self.me].copy_(x2[:, a:b], non_blocking=cuda)
            if cuda:
                torch.cuda.current_stream(x2.device).synchronize()
            self._barrier()
            read(views, a, b)
            if cuda:
                torch.cuda.current_stream(x2.device).synchronize()
            self._barrier()

    # -- the collectives -----------------------------------------------------
    def _reduce(self, parts, out, combine) -> None:
        """``out`` = the parts combined in group-rank order."""
        cuda = out.is_cuda
        acc = torch.empty_like(out)
        acc.copy_(parts[0], non_blocking=cuda)
        part = torch.empty_like(out)
        for p in parts[1:]:
            part.copy_(p, non_blocking=cuda)
            acc = combine(acc, part)
        out.copy_(acc)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[world, *x.shape]: row j is group rank j's ``x``."""
        x2 = x.reshape(1, -1)
        out = torch.empty((self.world, x2.shape[1]), dtype=x.dtype,
                          device=x.device)

        def read(views, a, b):
            for j, v in enumerate(views):
                out[j, a:b].copy_(v[0], non_blocking=x.is_cuda)
        self.exchange(x2, read)
        return out.view(self.world, *x.shape)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [world, ...]: row j of the result is group rank j's row (me)."""
        x2 = x.reshape(self.world, -1)
        out = torch.empty_like(x2)

        def read(views, a, b):
            for j, v in enumerate(views):
                out[j, a:b].copy_(v[self.me], non_blocking=x.is_cuda)
        self.exchange(x2, read)
        return out.view(x.shape)

    def reduce_scatter(self, x: torch.Tensor, combine) -> torch.Tensor:
        """x [world, ...] -> the reduction over the group of row (me)."""
        x2 = x.reshape(self.world, -1)
        out = torch.empty(x2.shape[1], dtype=x.dtype, device=x.device)
        self.exchange(x2, lambda views, a, b: self._reduce(
            [v[self.me] for v in views], out[a:b], combine))
        return out.view(x.shape[1:])

    def all_reduce(self, x: torch.Tensor, combine) -> torch.Tensor:
        """The reduction over the group of ``x``, the same on every rank."""
        x2 = x.reshape(1, -1)
        out = torch.empty(x2.shape[1], dtype=x.dtype, device=x.device)
        self.exchange(x2, lambda views, a, b: self._reduce(
            [v[0] for v in views], out[a:b], combine))
        return out.view(x.shape)

    def permute(self, x: torch.Tensor, source: Optional[int]) -> torch.Tensor:
        """Group rank ``source``'s ``x`` (zeros where ``source`` is None)."""
        x2 = x.reshape(1, -1)
        out = torch.zeros(x2.shape[1], dtype=x.dtype, device=x.device)

        def read(views, a, b):
            if source is not None:
                out[a:b].copy_(views[source][0], non_blocking=x.is_cuda)
        self.exchange(x2, read)
        return out.view(x.shape)


_channels: Dict[object, Optional[Channel]] = {}


def _same_host(group, me: int) -> Optional[str]:
    """A name every rank of ``group`` agrees on, if each maps the segment
    group rank 0 made under it; else None."""
    import torch.distributed as dist
    box = [f"dstpu_{os.getpid()}_{secrets.token_hex(6)}" if me == 0 else None]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    name = box[0]
    probe = os.path.join(_SHM_DIR, f"{name}_probe")
    if me == 0:
        try:
            with open(probe, "w") as f:
                f.write(name)
        except OSError:
            pass
    dist.barrier(group=group)
    try:
        with open(probe) as f:
            ok = f.read() == name
    except OSError:
        ok = False
    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    if me == 0 and os.path.exists(probe):
        os.unlink(probe)
    return name if int(flag) else None


def channel(group) -> Optional[Channel]:
    """The shared-memory channel of a gloo ``group``, built at its first
    collective (a collective itself: every rank calls it there), or None
    where the group is not gloo or spans hosts."""
    import torch.distributed as dist
    if group in _channels:
        return _channels[group]
    ch = None
    if dist.get_backend(group) == "gloo":
        me = dist.get_rank(group)
        name = _same_host(group, me)
        if name is None:
            logger.info("gloo group of %d ranks spans hosts: its collectives "
                        "go over gloo", dist.get_world_size(group))
        else:
            ch = Channel(group, dist.get_world_size(group), me, name)
    _channels[group] = ch
    return ch
