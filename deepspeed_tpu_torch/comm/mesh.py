"""The named-axis process mesh on ``torch.distributed``.

Port of ``deepspeed_tpu/comm/mesh.py`` (reference ``deepspeed/utils/
groups.py`` and ``comm.init_distributed``, ``deepspeed/comm/comm.py:619``).
The JAX package's process groups are the named axes of one device mesh:

    axes (outer -> inner): ('pipe', 'data', 'fsdp_out', 'fsdp', 'expert',
                            'sequence', 'tensor')

Here one process is one rank, and a ``Mesh`` holds the axis sizes, this
rank's coordinates (row-major over ``MESH_AXES``, the order in which the
reference lays devices out, so rank r sits where the reference's device r
sits) and a ``torch.distributed`` process group for every set of axes
larger than 1: the group of a set holds the ranks whose coordinates differ
only on those axes, in rank order, so a rank's index in the group is its
row-major coordinate over the set. Every rank creates every group, in the
same order, as ``new_group`` requires.

``init_distributed`` starts the process group under ``bounded_init``
(deadline, retries of transient failures): NCCL for a CUDA device, gloo for
``device="cpu"``, or the ``backend`` the caller names. It never switches
backend because one failed to start. Rank to device is ``LOCAL_RANK %
device_count()``, so two ranks on one card share ``cuda:0``.
"""

import itertools
import math
import os
import socket
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from deepspeed_tpu_torch.config.config import MeshConfig
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist, logger

# Canonical axis order, outermost first. ``fsdp_out`` is the hierarchical
# sharding replica axis (MiCS / hpZ; size 1 in the port).
MESH_AXES: Tuple[str, ...] = ("pipe", "data", "fsdp_out", "fsdp", "expert",
                              "sequence", "tensor")

# Axes over which a replicated batch is split (DP world for batch-size math).
BATCH_AXES: Tuple[str, ...] = ("data", "fsdp_out", "fsdp")

# The full ZeRO sharding world (what stages 1-3 partition over).
FSDP_AXES: Tuple[str, ...] = ("fsdp_out", "fsdp")

Axes = Union[str, Sequence[str]]

_global_mesh: Optional["Mesh"] = None


def resolve_axis_sizes(cfg: MeshConfig, n_devices: int) -> Dict[str, int]:
    """Fill the single -1 axis with the remaining rank count; validate the
    product."""
    sizes = {
        "pipe": cfg.pipe, "data": cfg.data,
        "fsdp_out": getattr(cfg, "fsdp_outer", 1), "fsdp": cfg.fsdp,
        "expert": cfg.expert, "sequence": cfg.sequence, "tensor": cfg.tensor,
    }
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
    known = int(math.prod([v for v in sizes.values() if v != -1]))
    if unknown:
        if n_devices % known != 0:
            raise ValueError(
                f"device count {n_devices} not divisible by fixed axes product {known}")
        sizes[unknown[0]] = n_devices // known
    total = int(math.prod(list(sizes.values())))
    if total != n_devices:
        raise ValueError(
            f"mesh axes product {total} != device count {n_devices} (sizes={sizes})")
    return sizes


def axes_tuple(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Axis sizes, this rank's coordinates and one process group per set
    of axes larger than 1. ``shape`` maps every axis of ``MESH_AXES`` to
    its size, as the JAX mesh's does. ``device`` is this rank's device:
    the card unless the caller names the CPU (no card raises)."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 device=None):
        self.shape: Dict[str, int] = {a: int(sizes.get(a, 1))
                                      for a in MESH_AXES}
        self.axis_names = MESH_AXES
        self.size = int(math.prod(self.shape.values()))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = int(rank)
        self.device = resolve_device(device)
        self.coords: Dict[str, int] = {}
        rest = self.rank
        for a in reversed(MESH_AXES):          # row-major: last axis fastest
            self.coords[a] = rest % self.shape[a]
            rest //= self.shape[a]
        self._groups: Dict[Tuple[str, ...], object] = {}
        live = [a for a in MESH_AXES if self.shape[a] > 1]
        if live:
            import torch.distributed as dist
            for k in range(1, len(live) + 1):
                for subset in itertools.combinations(live, k):
                    self._groups[subset] = self._new_group(dist, subset)

    def _new_group(self, dist, subset):
        """Create every group over ``subset`` (one per setting of the other
        axes, the same calls on every rank) and keep the one holding this
        rank."""
        others = [a for a in MESH_AXES if a not in subset]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
            coords = dict(zip(others, fixed))
            ranks = []
            for inner in itertools.product(*(range(self.shape[a])
                                             for a in subset)):
                coords.update(zip(subset, inner))
                ranks.append(self.rank_of(coords))
            group = dist.new_group(sorted(ranks))
            if self.rank in ranks:
                mine = group
        return mine

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in MESH_AXES:
            r = r * self.shape[a] + int(coords.get(a, 0))
        return r

    def live_axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` in mesh order, without the axes of size 1."""
        wanted = set(axes_tuple(axes))
        unknown = wanted - set(MESH_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; known: "
                             f"{MESH_AXES}")
        return tuple(a for a in MESH_AXES if a in wanted and self.shape[a] > 1)

    def group(self, axes: Axes):
        """The process group over ``axes`` (None when they span one rank)."""
        live = self.live_axes(axes)
        return self._groups[live] if live else None

    def axis_world(self, axes: Axes) -> int:
        return int(math.prod(self.shape[a] for a in axes_tuple(axes)))

    def axis_index(self, axes: Axes) -> int:
        """This rank's row-major coordinate over ``axes`` (in the order
        given, as ``jax.lax.axis_index`` over a tuple)."""
        idx = 0
        for a in axes_tuple(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, rank={self.rank})"


def _world_and_rank() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(cfg: Optional[MeshConfig] = None, device=None) -> Mesh:
    """Build the named-axis mesh over the ranks of the default process
    group (one rank when none is initialized), on ``device``: the card
    unless the caller names the CPU."""
    cfg = cfg or MeshConfig()
    world, rank = _world_and_rank()
    sizes = resolve_axis_sizes(cfg, world)
    mesh = Mesh(sizes, rank, device)
    log_dist(f"created mesh {dict(mesh.shape)} over {world} ranks", ranks=[0])
    return mesh


def get_global_mesh() -> Optional[Mesh]:
    return _global_mesh


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    _global_mesh = mesh


# --- world-size accessors (reference: utils/groups.py get_*_world_size) -----

def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def get_data_parallel_world_size(mesh: Mesh) -> int:
    """DP world for batch math = data x fsdp_out x fsdp."""
    return int(math.prod([mesh.shape.get(a, 1) for a in BATCH_AXES]))


def get_seq_data_parallel_world_size(mesh: Mesh) -> int:
    return get_data_parallel_world_size(mesh) * mesh.shape["sequence"]


def get_model_parallel_world_size(mesh: Mesh) -> int:
    return mesh.shape["tensor"]


def get_expert_parallel_world_size(mesh: Mesh) -> int:
    return mesh.shape["expert"]


def get_expert_parallel_group(mesh: Mesh):
    """The process group over ``expert`` (None at an expert axis of one):
    the ranks whose coordinates differ only there, in expert order (the
    reference's expert-parallel group, utils/groups.py:117)."""
    return mesh.group("expert")


def get_expert_parallel_rank(mesh: Mesh) -> int:
    """This rank's expert coordinate: its experts are block
    ``coordinate`` of the experts' leading dim."""
    return mesh.coords["expert"]


def get_sequence_parallel_world_size(mesh: Mesh) -> int:
    return mesh.shape["sequence"]


def get_pipe_parallel_world_size(mesh: Mesh) -> int:
    return mesh.shape["pipe"]


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh.shape)


def discover_cluster_env() -> dict:
    """Rendezvous discovery chain (reference ``comm/comm.py:619`` env:// +
    ``mpi_discovery:688``): DSTPU_* > torch-style RANK/WORLD_SIZE/
    MASTER_ADDR > OpenMPI OMPI_COMM_WORLD_* > SLURM_* (the last two only
    with ``DSTPU_AUTO_MPI_DISCOVERY=1``). Returns possibly-empty kwargs
    for ``init_distributed``."""
    env = os.environ
    out = {}
    if "DSTPU_NUM_PROCESSES" in env:
        out["num_processes"] = int(env["DSTPU_NUM_PROCESSES"])
    if "DSTPU_PROCESS_ID" in env:
        out["process_id"] = int(env["DSTPU_PROCESS_ID"])
    if env.get("DSTPU_COORDINATOR_ADDRESS"):
        out["coordinator_address"] = env["DSTPU_COORDINATOR_ADDRESS"]
    if out:
        return out
    # torch-style: a launcher sets the triple together
    if "WORLD_SIZE" in env and "RANK" in env and env.get("MASTER_ADDR"):
        return {"num_processes": int(env["WORLD_SIZE"]),
                "process_id": int(env["RANK"]),
                "coordinator_address":
                    f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"}
    # MPI/SLURM allocations leak their env into interactive shells, so
    # these are opt-in
    if env.get("DSTPU_AUTO_MPI_DISCOVERY") != "1":
        return {}
    if "OMPI_COMM_WORLD_SIZE" in env:             # mpirun (mpi_discovery)
        out["num_processes"] = int(env["OMPI_COMM_WORLD_SIZE"])
        out["process_id"] = int(env["OMPI_COMM_WORLD_RANK"])
        if env.get("MASTER_ADDR"):
            out["coordinator_address"] = \
                f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        else:
            # mpirun sets no MASTER_ADDR: rank 0's address over MPI when
            # mpi4py is present, else the user must export MASTER_ADDR
            host = None
            try:
                from mpi4py import MPI
                host = MPI.COMM_WORLD.bcast(_host_ip(), root=0)
            except Exception as e:   # degrade, never crash startup
                logger.warning(f"OMPI discovery failed ({e})")
            if host:
                out["coordinator_address"] = \
                    f"{host}:{env.get('MASTER_PORT', '29500')}"
            else:
                logger.warning(
                    "OMPI discovery: cannot derive the coordinator address; "
                    "export MASTER_ADDR to rendezvous")
    elif "SLURM_NTASKS" in env and "SLURM_PROCID" in env:   # srun
        out["num_processes"] = int(env["SLURM_NTASKS"])
        out["process_id"] = int(env["SLURM_PROCID"])
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        head = _slurm_head_node(nodelist)
        if head:
            out["coordinator_address"] = \
                f"{head}:{env.get('MASTER_PORT', '29500')}"
    return out


def _host_ip() -> str:
    """This host's address by name ("" when it resolves to loopback)."""
    ip = socket.gethostbyname(socket.gethostname())
    return "" if ip.startswith("127.") else ip


def _slurm_head_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist: ``node[1-4,7]`` -> ``node1``."""
    import re
    first = nodelist.split(",")[0].strip()
    m = re.match(r"^([^\[]+)\[(\d+)", first)
    if m:
        return m.group(1) + m.group(2)
    return first


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     deadline_s: Optional[float] = None,
                     retries: Optional[int] = None,
                     backoff_s: Optional[float] = None,
                     backend: Optional[str] = None,
                     device=None) -> None:
    """Start ``torch.distributed`` (reference ``comm.init_distributed``):
    the TCP rendezvous at ``coordinator_address`` (``host:port``) for
    ``num_processes`` ranks, this one ``process_id``; arguments left out
    come from ``discover_cluster_env``. A no-op for one process with no
    coordinator, or when the default group is already up.

    ``backend`` defaults to NCCL for a CUDA ``device`` (the default) and
    gloo for ``device="cpu"``. On the card the rank takes
    ``cuda:LOCAL_RANK % device_count()`` (``LOCAL_RANK`` defaults to the
    process id). The rendezvous runs under ``comm.guard.bounded_init``: a
    deadline (``deadline_s``, default 300 s, env
    ``DSTPU_COMM_INIT_DEADLINE_S``, 0 = unbounded) turns a hung rendezvous
    into ``CommWedgeError``; transient failures retry with backoff."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    disc = discover_cluster_env()
    if num_processes is None:
        num_processes = disc.get("num_processes", 1)
    if coordinator_address is None:
        coordinator_address = disc.get("coordinator_address")
    if process_id is None:
        process_id = disc.get("process_id", 0)
    if num_processes <= 1 and coordinator_address is None:
        return
    if coordinator_address is None:
        raise ValueError("init_distributed needs a coordinator_address "
                         "(host:port) for more than one process")
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" or backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"init_distributed: backend {backend!r} on {dev} needs a CUDA "
                "device and none is available; pass device='cpu' (gloo) to "
                "run on the CPU explicitly")
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())

    from deepspeed_tpu_torch.comm.guard import (INIT_BACKOFF_ENV,
                                                INIT_DEADLINE_ENV,
                                                INIT_RETRIES_ENV, bounded_init)

    def _env(name, cast, default):
        try:
            return cast(os.environ.get(name, default))
        except ValueError:
            return cast(default)

    if deadline_s is None:
        deadline_s = _env(INIT_DEADLINE_ENV, float, 300.0)
    if retries is None:
        retries = _env(INIT_RETRIES_ENV, int, 3)
    if backoff_s is None:
        backoff_s = _env(INIT_BACKOFF_ENV, float, 1.0)
    bounded_init(lambda: dist.init_process_group(
                     backend, init_method=f"tcp://{coordinator_address}",
                     world_size=int(num_processes), rank=int(process_id)),
                 name="torch_distributed", deadline_s=deadline_s,
                 retries=retries, backoff_s=backoff_s)
    # stamp the dstrace process identity at rendezvous: every later dump
    # carries rank/world
    from deepspeed_tpu_torch.telemetry.tracer import get_tracer
    get_tracer().set_process_identity(dist.get_rank(), dist.get_world_size())
    log_dist(f"torch.distributed initialized: {dist.get_world_size()} "
             f"processes, backend {backend}", ranks=[0])
