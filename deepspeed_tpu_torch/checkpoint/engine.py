"""Checkpoint save/load: one logical checkpoint of whole leaves, reshaped
on load to any world, mesh, ZeRO stage or memory tier.

Port of ``deepspeed_tpu/checkpoint/engine.py`` (reference
``runtime/engine.py`` ``save_checkpoint`` / ``load_checkpoint``,
``checkpoint/ds_to_universal.py``). What is kept as it is there: the
integrity manifest (``ds_manifest.json``: every file's size and zlib
CRC32, written before the commit), the ``ds_meta.json`` provenance block
and the sampler contract, the ``latest`` pointer published by an fsync'd
tmp + rename, the async save on a non-daemon thread, and the load's
classified errors (``CheckpointCorruptionError``,
``CheckpointProvenanceError``).

**The store is the port's own** (ROADMAP Queue 3). The JAX package writes
through orbax/tensorstore, which imports JAX; the port writes the same
parameter-atomic layout itself, one ``.npy`` file a leaf, each holding the
whole leaf whatever block a rank holds:

- ``params/<flax path>.npy``: the fp32 master (the names of
  ``models/convert.py::to_flax_tree``, ``/``-joined);
- ``opt_state/<state>/<flax path>.npy``: each optimizer state's whole
  per-leaf tensor under its optax name (``mu``, ``nu``: Adam and LAMB;
  ``mu``: Lion; ``sum_of_squares``: Adagrad; ``trace``: SGD; ``nu``,
  ``trace``: RMSprop; the host tier's kernels file their buffers under
  the same names, ``runtime/offload.py::STATE_NAMES``), so moments move
  between the tiers in either direction without the JAX package's
  ``_extract_moments`` / ``_inject_moments_into_optax`` mining;
- ``opt_state/error_feedback/<bucket>/{worker,server}.npy``: the
  ``comm_compression`` residuals, one row a rank in global rank order;
- ``scalars.json``: step, loss scale, good steps, hysteresis, skipped
  steps and the optimizer's update count; ``offload_state_proc<r>.json``:
  a host tier's per-rank sidecar (its kernel's step count and its
  blocks' shapes; a rank the saving world did not have reads proc0's).

Over ranks every block goes to the whole leaf by a gather, a leaf at a
time (``engine._whole_leaf``: the ZeRO block over the data/fsdp axes, the
expert block, the tensor block, a tier's host block), and global rank 0
writes it: a rank holds at most one whole leaf beyond its own state, and
no file is written by two processes. A load is a slice read: each rank
maps the file and copies its block (``partition.block_slices``) into the
tensor that holds it. The port does not read the JAX package's orbax
checkpoints; models move between the packages through the universal fp32
npz (``checkpoint/universal.py``).

The RNG record holds the states of the engine's torch generators (the
CPU's, and the card's on the card), where JAX records its PRNG key. The
memory-ledger provenance records only ``bytes_limit``
(``torch.cuda.mem_get_info``): ``telemetry/memory`` is not ported.
"""

import collections
import concurrent.futures
import contextlib
import hashlib
import io
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist, logger

LATEST_FILE = "latest"
MANIFEST_FILE = "ds_manifest.json"
META_FILE = "ds_meta.json"
SCALARS_FILE = "scalars.json"
PARAMS_DIR = "params"
OPT_DIR = "opt_state"
EF_DIR = "error_feedback"

#: ds_meta.json provenance block schema version
PROVENANCE_VERSION = 1

#: the data-sampler determinism contract recorded in every checkpoint
#: (JAX ``checkpoint/engine.py:37-49``): the stream position is
#: ``consumed_samples``; ``train_batch_size`` is invariant across resume
SAMPLER_CONTRACT = ("next_sample_index == consumed_samples; "
                    "epoch == consumed_samples // dataset_size; "
                    "train_batch_size invariant across resume")

#: bytes a checksum task reads or writes (a file's CRC32 is combined from
#: its chunks)
CRC_CHUNK = 64 << 20
#: bytes of host tensors whose writes a save keeps in flight
WRITE_INFLIGHT_BYTES = 4 << 30
#: device bytes an async save leaves free after its snapshot on the card
SNAPSHOT_MARGIN = 1 << 30


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed its integrity-manifest verification: a listed
    file is missing or its size or checksum no longer matches — the
    checkpoint is torn and must never be restored."""


class CheckpointProvenanceError(RuntimeError):
    """The checkpoint's recorded provenance (``ds_meta.json``) is
    incompatible with the engine restoring it: a different model (the
    parameter tree differs), a broken sampler contract (a changed
    ``train_batch_size``) or an optimizer whose state the checkpoint does
    not hold. A world, mesh, stage or tier change is not an error."""


def _ckpt_dir(save_dir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(save_dir), str(tag))


# ---------------------------------------------------------------------------
# threads: leaf writes and checksums
# ---------------------------------------------------------------------------
_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    """The module's worker threads (file reads, writes and zlib release the
    GIL, so a checkpoint's I/O and checksums run on every core)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(16, os.cpu_count() or 4),
                thread_name_prefix="dstpu-ckpt-io")
        return _POOL


# ---------------------------------------------------------------------------
# durability primitives: fsync + integrity manifest + atomic commit
# ---------------------------------------------------------------------------
def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """Flush directory entries to disk; no-op where directory fds reject
    fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _gf2_times(mat: Sequence[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: Sequence[int]) -> List[int]:
    return [_gf2_times(mat, mat[n]) for n in range(32)]


#: _BYTE_SHIFTS[k]: the operator that appends 2**k zero bytes to a CRC32
#: register (zlib's ``crc32_combine`` matrices)
_BYTE_SHIFTS: List[List[int]] = []


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib's ``crc32_combine``: the CRC32 of A + B from CRC32(A), CRC32(B)
    and len(B), so one file's chunks are checksummed in parallel and the
    manifest still holds ``zlib.crc32`` of the whole file."""
    if len2 <= 0:
        return crc1
    if not _BYTE_SHIFTS:
        op = [0xEDB88320] + [1 << n for n in range(31)]     # one zero bit
        for _ in range(3):
            op = _gf2_square(op)
        _BYTE_SHIFTS.append(op)
    k = 0
    while len2:
        while len(_BYTE_SHIFTS) <= k:
            _BYTE_SHIFTS.append(_gf2_square(_BYTE_SHIFTS[-1]))
        if len2 & 1:
            crc1 = _gf2_times(_BYTE_SHIFTS[k], crc1)
        len2 >>= 1
        k += 1
    return crc1 ^ crc2


def _crc_range(path: str, start: int, n: int) -> int:
    crc = 0
    buf = bytearray(min(n, 8 << 20))
    view = memoryview(buf)
    with open(path, "rb", buffering=0) as f:
        f.seek(start)
        while n > 0:
            got = f.readinto(view[:min(n, len(buf))])
            if not got:
                break
            crc = zlib.crc32(view[:got], crc)
            n -= got
    return crc


def _crc_files(paths: Sequence[str]) -> Dict[str, Tuple[int, int]]:
    """(size, zlib CRC32) of every file, its chunks checksummed on the
    thread pool and combined in order."""
    pool = _pool()
    work = {}
    for p in paths:
        size = os.path.getsize(p)
        work[p] = (size, [(pool.submit(_crc_range, p, a,
                                       min(CRC_CHUNK, size - a)),
                           min(CRC_CHUNK, size - a))
                          for a in range(0, size, CRC_CHUNK)])
    out = {}
    for p, (size, parts) in work.items():
        crc = 0
        for fut, n in parts:
            crc = crc32_combine(crc, fut.result(), n)
        out[p] = (size, crc)
    return out


def write_manifest(path: str, extra_meta: Optional[Dict[str, Any]] = None,
                   exclude=None,
                   sums: Optional[Dict[str, Tuple[int, int]]] = None
                   ) -> Dict[str, Any]:
    """Checksum every file of the checkpoint dir (size + CRC32), fsync each,
    then persist ``ds_manifest.json``. Written strictly before the
    ``latest`` commit, so a committed tag always carries a verifiable
    manifest. ``exclude(filename) -> bool`` skips files; ``sums`` holds
    (size, CRC32) of files the caller checksummed and fsync'd as it wrote
    them (``_LeafWriter``), by path relative to ``path``: each is only
    held to its size on disk."""
    sums = sums or {}
    rels = []
    for root, _, names in os.walk(path):
        for name in sorted(names):
            if name == MANIFEST_FILE or (exclude is not None
                                         and exclude(name)):
                continue
            rels.append(os.path.relpath(os.path.join(root, name), path))
    rels.sort()
    fresh = [r for r in rels if r not in sums]
    read = _crc_files([os.path.join(path, r) for r in fresh])
    files: Dict[str, Dict[str, int]] = {}
    for rel in rels:
        full = os.path.join(path, rel)
        if rel in sums:
            size, crc = sums[rel]
            if os.path.getsize(full) != size:
                raise OSError(f"checkpoint {path}: {rel} holds "
                              f"{os.path.getsize(full)} bytes, {size} "
                              "were written")
        else:
            size, crc = read[full]
            _fsync_file(full)
        files[rel] = {"size": size, "crc32": crc}
    manifest = {"version": 1, "files": files, "meta": extra_meta or {}}
    mpath = os.path.join(path, MANIFEST_FILE)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(path)
    return manifest


def verify_manifest(path: str) -> bool:
    """Re-checksum a checkpoint against its manifest: True when every
    listed file matches; False for a manifest-less (legacy) checkpoint;
    ``CheckpointCorruptionError`` on a missing file, a size or a checksum
    mismatch. Sizes are checked first, so a truncated file is caught
    before any byte is read."""
    mpath = os.path.join(path, MANIFEST_FILE)
    if not os.path.exists(mpath):
        return False
    with open(mpath) as f:
        manifest = json.load(f)
    files = manifest.get("files", {})
    for rel, want in files.items():
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            raise CheckpointCorruptionError(
                f"checkpoint {path}: manifest file missing: {rel}")
        size = os.path.getsize(full)
        if size != want["size"]:
            raise CheckpointCorruptionError(
                f"checkpoint {path}: size mismatch for {rel} (size {size} "
                f"vs {want['size']})")
    sums = _crc_files([os.path.join(path, rel) for rel in files])
    for rel, want in files.items():
        size, crc = sums[os.path.join(path, rel)]
        if size != want["size"] or crc != want["crc32"]:
            raise CheckpointCorruptionError(
                f"checkpoint {path}: checksum mismatch for {rel} "
                f"(size {size} vs {want['size']}, crc {crc} vs "
                f"{want['crc32']})")
    return True


def is_committed(save_dir: str, tag: str, verify: bool = True) -> bool:
    """True when ``tag`` is a committed, integrity-clean checkpoint (a
    verification failure counts as not committed rather than raising:
    callers use this to pick a fallback tag)."""
    path = _ckpt_dir(save_dir, tag)
    if not os.path.isdir(path) or not os.path.exists(
            os.path.join(path, META_FILE)):
        return False
    if not verify:
        return True
    try:
        verify_manifest(path)
    except CheckpointCorruptionError as e:
        logger.warning(f"checkpoint integrity: {e}")
        return False
    return True


def read_latest_tag(save_dir: str) -> Optional[str]:
    """The tag the ``latest`` pointer names, or None."""
    latest = os.path.join(os.path.abspath(save_dir), LATEST_FILE)
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return f.read().strip() or None


def _commit_latest(save_dir: str, tag: str) -> None:
    """Publish ``tag`` as the latest committed checkpoint: tmp file + fsync
    + rename + directory fsync, so a crash leaves the old pointer or the
    new one, never a torn ``latest``."""
    save_dir = os.path.abspath(save_dir)
    tmp = os.path.join(save_dir, LATEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        f.write(tag)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(save_dir, LATEST_FILE))
    _fsync_dir(save_dir)


def _barrier(engine) -> None:
    """Every rank of the engine's mesh, when it has more than one."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.mesh import MESH_AXES
    live = engine.mesh.live_axes(MESH_AXES)
    if live:
        comm.barrier(live)


def wait_pending_checkpoint(engine) -> None:
    """Block until a previous async save has committed, and re-raise any
    error its writer hit. Over ranks every rank calls it (rank 0 writes;
    the others wait for its commit)."""
    t = getattr(engine, "_pending_ckpt", None)
    if t is not None:
        t.join()
        engine._pending_ckpt = None
    if getattr(engine, "_pending_barrier", False):
        engine._pending_barrier = False
        _barrier(engine)
    err = getattr(engine, "_pending_ckpt_error", None)
    if err is not None:
        engine._pending_ckpt_error = None
        raise RuntimeError("async checkpoint save failed") from err


# ---------------------------------------------------------------------------
# the engine's leaves
# ---------------------------------------------------------------------------
def _inner_optimizer(engine):
    opt = engine.optimizer
    return getattr(opt, "inner", opt)


def state_names(engine) -> Tuple[str, ...]:
    """The optimizer states a checkpoint of ``engine`` holds per leaf,
    under their optax names (none for a client optimizer)."""
    if engine._offload is not None:
        return tuple(engine._offload.state_names)
    return tuple(getattr(_inner_optimizer(engine), "STATE", ()))


def _leaf_file(kind: str, path: str) -> str:
    return f"{kind}/{path}.npy"


def _local_leaves(engine, names) -> Iterator[Tuple[str, torch.Tensor, list]]:
    """(file, this rank's tensor, its cuts) of every leaf file, in order:
    each leaf's master, then its states. Under either tier the master and
    the states are the host optimizer's blocks; in HBM the master is the
    module's (a stage-3 block) and the states the optimizer's (a ZeRO
    block of the moments below stage 3)."""
    host = engine._offload
    opt = _inner_optimizer(engine)
    for i, p in enumerate(engine._paths):
        if host is not None:
            cuts = engine._opt_cuts(i)
            yield _leaf_file(PARAMS_DIR, p), host.master(i), cuts
            states = host.leaf_states(i) if names else []
            for name, t in zip(names, states):
                yield _leaf_file(f"{OPT_DIR}/{name}", p), t, cuts
            continue
        yield _leaf_file(PARAMS_DIR, p), engine._masters[i].detach(), \
            engine._master_cuts(i)
        for name in names:
            yield _leaf_file(f"{OPT_DIR}/{name}", p), getattr(opt, name)[i], \
                engine._opt_cuts(i)


def _ef_state(engine):
    comp = getattr(engine, "_comm_compress", None)
    if comp is None or not comp.ef_enabled():
        return None
    return engine.optimizer.state.error_feedback


def _whole_leaves(engine, names, keep: bool
                  ) -> Iterator[Tuple[str, Optional[torch.Tensor],
                                      torch.Tensor]]:
    """(file, whole tensor or None, this rank's tensor) of every file: the
    leaves gathered to whole leaves (every rank takes part), then the
    ``comm_compression`` residuals gathered to one row a rank. Only global
    rank 0 (``keep``) keeps the whole tensors."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.mesh import MESH_AXES
    for rel, t, cuts in _local_leaves(engine, names):
        whole = engine._whole_leaf(t, cuts)
        yield rel, whole if keep else None, t
    ef = _ef_state(engine)
    live = engine.mesh.live_axes(MESH_AXES)
    for b, e in enumerate(ef or ()):
        for part in ("worker", "server"):
            t = getattr(e, part)
            rows = comm.all_gather(t, live, axis=0, tiled=False) if live \
                else t[None]
            yield f"{OPT_DIR}/{EF_DIR}/{b}/{part}.npy", \
                rows if keep else None, rows


def _npy_header(dtype: np.dtype, shape) -> bytes:
    """The ``.npy`` header ``np.save`` writes for an array of ``dtype`` and
    ``shape`` (format 1.0, C order)."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {
        "descr": np.lib.format.dtype_to_descr(dtype), "fortran_order": False,
        "shape": tuple(int(n) for n in shape)})
    return buf.getvalue()


def _pwrite_all(fd: int, data, offset: int) -> None:
    view = memoryview(data).cast("B")
    while len(view):
        n = os.pwrite(fd, view, offset)
        view, offset = view[n:], offset + n


def _write_part(fd: int, offset: int, buf: torch.Tensor, n: int,
                event: Optional[torch.cuda.Event]) -> int:
    """Write ``n`` bytes of the host byte tensor ``buf`` at ``offset`` once
    ``event`` (its copy from the card) has completed; their CRC32."""
    if event is not None:
        event.synchronize()
    view = memoryview(buf.numpy())[:n]
    _pwrite_all(fd, view, offset)
    return zlib.crc32(view)


def _fsync_close(fd: int) -> None:
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _LeafWriter:
    """Writes whole-leaf ``.npy`` files, each as ``np.save`` would, and
    checksums them as they are written, so the manifest reads nothing back.

    A tensor on the card comes down in ``CRC_CHUNK`` pieces through a
    ring of ``STAGES`` pinned buffers; the thread pool writes each piece at
    its offset and takes its CRC32 while the next piece is in flight (the
    pieces' CRCs are combined in order). A host tensor is written from its
    own memory, at most ``WRITE_INFLIGHT_BYTES`` of it in flight. Each file
    is fsync'd once its pieces are in. ``sums`` maps each file to its
    (size, zlib CRC32)."""

    STAGES = 8

    def __init__(self, root: str):
        self.root = root
        self.bytes = 0
        self.sums: Dict[str, Tuple[int, int]] = {}
        self._stages: List[torch.Tensor] = []
        self._stage_futs: List[Optional[concurrent.futures.Future]] = []
        self._next = 0
        self._open = collections.deque()     # files whose pieces are queued
        self._closing: List[concurrent.futures.Future] = []
        self._held = 0

    def _stage(self) -> Tuple[int, torch.Tensor]:
        k = self._next
        self._next = (k + 1) % self.STAGES
        if k == len(self._stages):
            self._stages.append(torch.empty(CRC_CHUNK, dtype=torch.uint8,
                                            pin_memory=True))
            self._stage_futs.append(None)
        if self._stage_futs[k] is not None:
            self._stage_futs[k].result()
        return k, self._stages[k]

    def put(self, rel: str, t: torch.Tensor) -> None:
        t = t.detach()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        header = _npy_header(dtype, t.shape)
        full = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        fd = os.open(full, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        _pwrite_all(fd, header, 0)
        src = t.contiguous().reshape(-1).view(torch.uint8)
        n, pool, parts = src.numel(), _pool(), []
        on_card = src.device.type == "cuda"
        if not on_card:
            self._held += n
            while self._open and self._held > WRITE_INFLIGHT_BYTES:
                self._retire(self._open.popleft())
        for a in range(0, n, CRC_CHUNK):
            m = min(CRC_CHUNK, n - a)
            if on_card:
                k, stage = self._stage()
                stage[:m].copy_(src[a:a + m], non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                fut = pool.submit(_write_part, fd, len(header) + a, stage, m,
                                  event)
                self._stage_futs[k] = fut
            else:
                fut = pool.submit(_write_part, fd, len(header) + a,
                                  src[a:a + m], m, None)
            parts.append((fut, m))
        # src stays referenced until its pieces are written
        self._open.append((rel, fd, header, parts, src,
                           0 if on_card else n))
        self.bytes += n
        while self._open and all(f.done() for f, _ in self._open[0][3]):
            self._retire(self._open.popleft())

    def _retire(self, record) -> None:
        rel, fd, header, parts, _, held = record
        crc = zlib.crc32(header)
        for fut, m in parts:
            crc = crc32_combine(crc, fut.result(), m)
        self.sums[rel] = (len(header) + sum(m for _, m in parts), crc)
        self._held -= held
        self._closing.append(_pool().submit(_fsync_close, fd))

    def __enter__(self) -> "_LeafWriter":
        return self

    def __exit__(self, kind, *_) -> None:
        """Every file written, checksummed, fsync'd and closed; after an
        error, every file closed and the error left to propagate."""
        if kind is None:
            while self._open:
                self._retire(self._open.popleft())
            for fut in self._closing:
                fut.result()
            return
        for _, fd, _, parts, _, _ in self._open:
            concurrent.futures.wait([f for f, _ in parts])
            os.close(fd)
        concurrent.futures.wait(self._closing)


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------
def _keystr(path: str) -> str:
    return "".join(f"['{k}']" for k in path.split("/"))


def _param_fingerprint(engine) -> Dict[str, Any]:
    """Name/shape inventory of the whole parameter tree (dtype-free), in
    the JAX package's flattening order and line format, and the sha256
    over its lines: the compatibility key a resume checks before reading
    an array."""
    shapes = engine._full_shapes
    paths = sorted(shapes, key=lambda p: p.split("/"))
    lines = [f"{_keystr(p)}:{tuple(shapes[p])}" for p in paths]
    return {
        "count": int(sum(int(np.prod(shapes[p] or (1,))) for p in paths)),
        "leaves": len(lines),
        "tree": lines,
        "tree_sha256": hashlib.sha256("\n".join(lines).encode()).hexdigest(),
    }


def _rng_record(engine) -> Dict[str, Any]:
    """The states of the engine's torch generators, host-serialized: the
    CPU generator's, and on the card the card's (JAX records its PRNG
    key)."""
    cpu = torch.get_rng_state().numpy()
    rec = {"impl": "torch", "typed": False, "dtype": str(cpu.dtype),
           "shape": list(cpu.shape), "data": cpu.tobytes().hex()}
    if engine.device.type == "cuda":
        rec["cuda"] = torch.cuda.get_rng_state(
            engine.device).numpy().tobytes().hex()
    return rec


def _restore_rng(engine, rec: Dict[str, Any]) -> None:
    def state(hexed):
        return torch.from_numpy(np.frombuffer(bytes.fromhex(hexed),
                                              np.uint8).copy())
    torch.set_rng_state(state(rec["data"]))
    if rec.get("cuda") and engine.device.type == "cuda":
        torch.cuda.set_rng_state(state(rec["cuda"]), engine.device)


def _ledger_provenance(engine) -> Dict[str, Any]:
    """The card's memory limit at save time (JAX also records the analytic
    plan of ``telemetry/memory``, which is not ported)."""
    limit = 0
    if engine.device.type == "cuda":
        limit = int(torch.cuda.mem_get_info(engine.device)[1])
    return {"bytes_limit": limit}


def checkpoint_provenance(engine) -> Dict[str, Any]:
    """The ``ds_meta.json`` provenance block: what a resume at another
    world, mesh, stage or tier needs to classify compatibility before any
    array byte is read."""
    from deepspeed_tpu_torch.runtime.zero.partition import zero_placement
    mesh_shape = {str(k): int(v) for k, v in engine.mesh.shape.items()}
    zc = engine.config.zero_config
    return {
        "version": PROVENANCE_VERSION,
        "world": {"process_count": int(engine.mesh.size),
                  "device_count": int(engine.mesh.size)},
        "mesh": mesh_shape,
        "zero": zero_placement(mesh_shape, engine.zero_stage,
                               offload_optimizer=zc.offload_optimizer.device,
                               offload_param=zc.offload_param.device),
        "batch": {
            "train_batch_size": int(engine.train_batch_size),
            "micro_batch": int(engine.micro_batch_size),
            "gradient_accumulation_steps":
                int(engine.gradient_accumulation_steps),
            "dp_world": int(engine.dp_world_size),
        },
        "sampler": {"consumed_samples": int(engine.global_samples),
                    "contract": SAMPLER_CONTRACT},
        "rng": _rng_record(engine),
        "params": _param_fingerprint(engine),
        "ledger": _ledger_provenance(engine),
        "config": engine.config.raw(),
    }


def check_provenance(engine, meta: Dict[str, Any], path: str,
                     strict: bool = True) -> Optional[Dict[str, Any]]:
    """Classify checkpoint-vs-engine compatibility from ``ds_meta.json``
    before any array read. Returns the provenance block (None for a
    checkpoint without one). Raises ``CheckpointProvenanceError`` on a
    model mismatch or a broken sampler contract (a warning under
    ``strict=False``); a mesh, world or stage change only logs and stamps
    an ``elastic/reshard`` instant."""
    from deepspeed_tpu_torch.telemetry.tracer import get_tracer
    prov = meta.get("provenance")
    if not prov:
        return None
    saved_fp = prov.get("params") or {}
    if saved_fp.get("tree_sha256"):
        cur = _param_fingerprint(engine)
        if cur["tree_sha256"] != saved_fp["tree_sha256"]:
            saved_tree = saved_fp.get("tree") or []
            diff = [f"  saved: {s!r}  !=  engine: {c!r}"
                    for s, c in zip(saved_tree, cur["tree"]) if s != c]
            if len(saved_tree) != len(cur["tree"]):
                diff.append(f"  leaf count: saved {len(saved_tree)} != "
                            f"engine {len(cur['tree'])}")
            raise CheckpointProvenanceError(
                f"checkpoint {path} was saved from a different model: "
                f"parameter tree mismatch ({saved_fp.get('count')} vs "
                f"{cur['count']} params). First differences:\n"
                + "\n".join(diff[:5] or ["  (tree hash differs)"]))
    saved_tb = (prov.get("batch") or {}).get("train_batch_size")
    if saved_tb and int(saved_tb) != int(engine.train_batch_size):
        msg = (f"checkpoint {path} breaks the sampler contract: saved "
               f"train_batch_size {saved_tb} != engine "
               f"{engine.train_batch_size}. The global batch is the elastic "
               f"invariant — resume must re-factor (micro_batch, gas, "
               f"dp_world) at the new mesh, not change the global batch "
               f"(else 'step k <-> samples k*batch' breaks and samples are "
               f"dropped/double-trained). Pass strict_provenance=False to "
               f"override deliberately.")
        if strict:
            raise CheckpointProvenanceError(msg)
        logger.warning(msg + " (override active: consumed_samples stays "
                       "authoritative for the data position)")
    saved_mesh = prov.get("mesh") or {}
    cur_mesh = {str(k): int(v) for k, v in engine.mesh.shape.items()}
    saved_zero = prov.get("zero") or {}
    if saved_mesh and saved_mesh != cur_mesh:
        saved_world = (prov.get("world") or {}).get("device_count", "?")
        log_dist(
            f"mesh-portable resume: checkpoint saved at world {saved_world} "
            f"mesh {saved_mesh} (zero stage {saved_zero.get('stage', '?')}), "
            f"restoring onto world {engine.mesh.size} mesh {cur_mesh} (zero "
            f"stage {engine.zero_stage}) — re-sharding from the "
            f"parameter-atomic store", ranks=[0])
        get_tracer().instant(
            "elastic/reshard", cat="elastic",
            saved_world=saved_world, new_world=engine.mesh.size,
            saved_zero_stage=saved_zero.get("stage"),
            new_zero_stage=engine.zero_stage,
            consumed_samples=(prov.get("sampler")
                              or {}).get("consumed_samples"))
    return prov


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------
def _offload_sidecar(rank: int) -> str:
    return f"offload_state_proc{rank}.json"


def _offload_sidecar_path(path: str, rank: int) -> Optional[str]:
    """This rank's host-tier sidecar, falling back to proc0's when the
    checkpoint was saved at a smaller world (JAX
    ``checkpoint/engine.py:677-695``): the step count is the same on every
    rank, and the moments themselves are whole leaves every rank slices."""
    own = os.path.join(path, _offload_sidecar(rank))
    if os.path.exists(own):
        return own
    p0 = os.path.join(path, _offload_sidecar(0))
    if rank != 0 and os.path.exists(p0):
        logger.warning(f"checkpoint has no offload sidecar for rank {rank} "
                       "(saved at a smaller world); using proc0's")
        return p0
    return None


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)
        f.flush()
        os.fsync(f.fileno())


def _snapshot_meta(engine, client_state, names) -> Dict[str, Any]:
    meta = {
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "micro_steps": engine.micro_steps,
        "zero_stage": engine.zero_stage,
        "mesh_shape": dict(engine.mesh.shape),
        "client_state": client_state or {},
        "state_names": list(names),
    }
    if _ef_state(engine) is not None:
        meta["error_feedback"] = {
            "replica_axes": list(engine._comm_compress.axes)}
    try:
        meta["provenance"] = checkpoint_provenance(engine)
    except Exception:
        # a provenance failure must never lose the checkpoint itself; the
        # tag then resumes like a checkpoint without provenance
        logger.exception("checkpoint: provenance capture failed")
    return meta


def _scalars(engine, names) -> Dict[str, Any]:
    ls = engine.loss_scale
    host = engine._offload
    count = int(host.kernel.step_count) if host is not None else \
        int(getattr(_inner_optimizer(engine), "count", 0))
    return {"step": int(engine.step_count), "loss_scale": float(ls.scale),
            "good_steps": int(ls.good_steps),
            "hysteresis": int(ls.hysteresis),
            "skipped_steps": int(engine._skipped_steps),
            "optimizer_count": count, "state_names": list(names)}


def _snapshot_copy(whole: torch.Tensor, local: torch.Tensor,
                   on_device: bool) -> torch.Tensor:
    """A point-in-time copy for the async writer: a gathered tensor is
    already one (over ranks it goes to the host, so rank 0's card never
    holds the whole state); a rank's own tensor is cloned, on the card
    when the snapshot fits there."""
    if whole.data_ptr() != local.data_ptr():
        return whole.cpu() if whole.device.type == "cuda" else whole
    if whole.device.type == "cuda" and on_device:
        return whole.detach().clone()
    return whole.detach().to("cpu", copy=True)


def _device_snapshot_fits(engine, names) -> bool:
    if engine.device.type != "cuda" or engine._offload is not None:
        return False
    need = sum(m.numel() * m.element_size() for m in engine._masters)
    need *= 1 + len(names)
    # the caching allocator's free blocks are free for the clones too
    free = torch.cuda.mem_get_info(engine.device)[0] + \
        torch.cuda.memory_reserved(engine.device) - \
        torch.cuda.memory_allocated(engine.device)
    return need + SNAPSHOT_MARGIN < free


def save_engine_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                           client_state: Optional[Dict[str, Any]] = None,
                           async_save: Optional[bool] = None) -> str:
    """Save ``engine`` as tag ``tag`` (default ``global_step<N>``) under
    ``save_dir``: every leaf whole, the scalars, ``ds_meta.json``, the
    manifest, then the ``latest`` commit. ``async_save`` (default: the
    ``checkpoint.async_save`` config) snapshots the state (on the card when
    it fits, else on the host) and returns; a non-daemon thread writes and
    commits (``wait_pending_checkpoint`` joins it). Every rank calls it."""
    if async_save is None:
        async_save = bool(engine.config.checkpoint_config.async_save)
    wait_pending_checkpoint(engine)          # one in flight at a time
    tag = tag if tag is not None else f"global_step{engine.global_steps}"
    path = _ckpt_dir(save_dir, tag)
    rank0 = engine.mesh.rank == 0
    t0 = time.perf_counter()
    if rank0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.isdir(path):              # a retried or repeated tag
            shutil.rmtree(path)
        os.makedirs(path)
    _barrier(engine)
    names = state_names(engine)
    if engine._offload is not None:
        host = engine._offload
        _write_json(os.path.join(path, _offload_sidecar(engine.mesh.rank)),
                    {"step_count": int(host.kernel.step_count),
                     "blocks": [list(s) for s in host.leaf_shapes()]})
    meta = _snapshot_meta(engine, client_state, names) if rank0 else None
    scalars = _scalars(engine, names)
    stats = {"tag": tag, "async": bool(async_save)}
    engine.ckpt_stats = stats

    def commit(write_s: float, sums) -> None:
        t = time.perf_counter()
        _write_json(os.path.join(path, SCALARS_FILE), scalars)
        _write_json(os.path.join(path, META_FILE), meta)
        write_manifest(path, extra_meta={"tag": tag,
                                         "global_steps": meta["global_steps"]},
                       sums=sums)
        stats.update(write_s=write_s, manifest_s=time.perf_counter() - t)
        _commit_latest(save_dir, tag)
        log_dist(f"saved checkpoint {path}", ranks=[0])

    if not async_save:
        writer = _LeafWriter(path)
        with writer if rank0 else contextlib.nullcontext():
            for rel, whole, _ in _whole_leaves(engine, names, keep=rank0):
                if rank0:
                    writer.put(rel, whole)
                del whole
        stats["bytes"] = writer.bytes
        _barrier(engine)                     # every rank's sidecar is in
        if rank0:
            commit(time.perf_counter() - t0, writer.sums)
        _barrier(engine)
        stats["seconds"] = time.perf_counter() - t0
        return path

    on_device = _device_snapshot_fits(engine, names)
    items = [(rel, _snapshot_copy(whole, local, on_device))
             for rel, whole, local in _whole_leaves(engine, names,
                                                    keep=rank0)
             if whole is not None]
    event = None
    if engine.device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    _barrier(engine)
    stats.update(snapshot_s=time.perf_counter() - t0,
                 snapshot="device" if on_device else "host")

    def finalize() -> None:
        try:
            t = time.perf_counter()
            writer = _LeafWriter(path)
            side = None
            if event is not None:
                side = torch.cuda.Stream(engine.device)
                side.wait_event(event)
            with writer, torch.cuda.stream(side) if side is not None \
                    else contextlib.nullcontext():
                while items:
                    rel, tensor = items.pop(0)
                    writer.put(rel, tensor)
                    del tensor
            stats["bytes"] = writer.bytes
            commit(time.perf_counter() - t, writer.sums)
            stats["seconds"] = time.perf_counter() - t0
        except BaseException as e:      # surfaced by wait_pending_checkpoint
            engine._pending_ckpt_error = e
            raise

    engine._pending_barrier = engine.mesh.size > 1
    if rank0:
        # non-daemon: a save in flight at interpreter exit completes instead
        # of losing the run's last checkpoint
        t = threading.Thread(target=finalize, daemon=False,
                             name="dstpu-async-ckpt")
        t.start()
        engine._pending_ckpt = t
        log_dist(f"async checkpoint scheduled: {path}", ranks=[0])
    return path


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------
def _read_block(path: str, rel: str, cuts, mesh) -> torch.Tensor:
    """This rank's block of a whole-leaf file: the file is mapped
    copy-on-write and only the block's pages are read."""
    from deepspeed_tpu_torch.runtime.zero.partition import block_slices
    mm = np.load(os.path.join(path, rel), mmap_mode="c")
    return torch.from_numpy(mm[block_slices(mm.shape, cuts, mesh)])


def _shadow(block: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The compute-dtype copy of a master block the tiers keep on the card
    (bf16 by the host's round-to-nearest-even kernel, as a step does)."""
    if dtype == torch.bfloat16:
        from deepspeed_tpu_torch.ops.cpu_adam import to_bf16
        return to_bf16(block.contiguous())
    return block.to(dtype)


def _adopt_error_feedback(engine, path: str, meta: Dict[str, Any]) -> None:
    """The ``comm_compression`` residuals of this rank's replica group at
    save time, fitted to this engine (``compress.adopt_error_feedback``):
    the rows of the saved ranks whose coordinates on the other axes are
    this rank's. A layout the residuals cannot follow (another size on an
    axis outside the replica axes, another bucket count) keeps the fresh
    zeros, logged."""
    from deepspeed_tpu_torch.comm.compress import adopt_error_feedback
    from deepspeed_tpu_torch.comm.mesh import MESH_AXES
    cur = _ef_state(engine)
    if cur is None:
        return
    comp, mesh = engine._comm_compress, engine.mesh
    root = os.path.join(path, OPT_DIR, EF_DIR)
    saved_axes = set((meta.get("error_feedback") or {}).get(
        "replica_axes") or ())
    saved_mesh = meta.get("mesh_shape") or {}
    others = [a for a in MESH_AXES
              if a not in saved_axes and a not in comp.axes]
    if not os.path.isdir(root) or not saved_mesh or any(
            int(saved_mesh.get(a, 1)) != mesh.shape[a] for a in others):
        log_dist("comm_compression: checkpoint carries no adoptable "
                 "error-feedback residuals; starting fresh (moments "
                 "unaffected)", ranks=[0])
        return
    rows = []
    for r in range(int(np.prod([int(saved_mesh.get(a, 1))
                                for a in MESH_AXES]))):
        coords, rest = {}, r
        for a in reversed(MESH_AXES):
            size = int(saved_mesh.get(a, 1))
            coords[a] = rest % size
            rest //= size
        if all(coords[a] == mesh.coords[a] for a in others):
            rows.append(r)
    buckets = sorted(int(b) for b in os.listdir(root))
    saved = [(np.load(os.path.join(root, str(b), "worker.npy"))[rows],
              np.load(os.path.join(root, str(b), "server.npy"))[rows])
             for b in buckets]
    new = adopt_error_feedback(saved, cur, comp.world,
                               mesh.axis_index(comp.axes))
    if new is None:
        log_dist("comm_compression: the checkpoint's bucket plan does not "
                 "fit this engine; error-feedback residuals start fresh",
                 ranks=[0])
        return
    engine.optimizer.state = engine.optimizer.state._replace(
        error_feedback=new)
    log_dist("comm_compression: error-feedback residuals adopted from the "
             "checkpoint", ranks=[0])


def load_engine_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                           load_optimizer_states: bool = True,
                           verify_integrity: bool = True,
                           strict_provenance: bool = True):
    """Restore ``engine`` from tag ``tag`` (default: the ``latest``
    pointer) of ``load_dir``, at this engine's world, mesh, stage and
    tier. Returns ``(path, client_state)``; ``(None, {})`` without a
    ``latest``. Nothing of the engine changes before the manifest, the
    provenance and the presence of every file it reads are checked."""
    wait_pending_checkpoint(engine)      # an in-flight async save commits
    _barrier(engine)
    load_dir = os.path.abspath(load_dir)
    if tag is None:
        tag = read_latest_tag(load_dir)
        if tag is None:
            log_dist(f"no '{LATEST_FILE}' file in {load_dir}; nothing "
                     "restored", ranks=[0])
            return None, {}
    path = _ckpt_dir(load_dir, tag)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    t0 = time.perf_counter()
    if verify_integrity and verify_manifest(path):
        # a torn checkpoint is never restored (resume_from_latest falls
        # back to the newest clean tag); a manifest-less one loads
        # unverified
        log_dist(f"checkpoint integrity verified: {path}", ranks=[0])
    t_verify = time.perf_counter()
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    provenance = check_provenance(engine, meta, path,
                                  strict=strict_provenance)
    with open(os.path.join(path, SCALARS_FILE)) as f:
        sc = json.load(f)
    names = state_names(engine) if load_optimizer_states else ()
    missing = [rel for rel in (_leaf_file(PARAMS_DIR, p)
                               for p in engine._paths)
               if not os.path.exists(os.path.join(path, rel))]
    if missing:
        raise FileNotFoundError(f"checkpoint {path} lacks {missing[:3]} "
                                f"({len(missing)} leaf files)")
    if any(not os.path.exists(os.path.join(path, _leaf_file(
            f"{OPT_DIR}/{n}", p))) for n in names for p in engine._paths):
        raise CheckpointProvenanceError(
            f"checkpoint {path}: saved optimizer state "
            f"{sc.get('state_names')} does not hold this engine's "
            f"{list(names)}; resume with load_optimizer_states=False to "
            "restore weights only")

    mesh, host = engine.mesh, engine._offload
    opt = _inner_optimizer(engine)
    nbytes = 0
    with torch.no_grad():
        for i, p in enumerate(engine._paths):
            states = [_read_block(path, _leaf_file(f"{OPT_DIR}/{n}", p),
                                  engine._opt_cuts(i), mesh) for n in names]
            if host is not None:
                master = _read_block(path, _leaf_file(PARAMS_DIR, p),
                                     engine._opt_cuts(i), mesh)
                if not names:      # no moments restored: they restart at 0
                    states = [torch.zeros(master.shape)
                              for _ in range(host.n_states)]
                host.load_leaf(i, master, states)
                if engine._param_offload is None:   # the card's shadow
                    engine._masters[i].data.copy_(_shadow(
                        _read_block(path, _leaf_file(PARAMS_DIR, p),
                                    engine._master_cuts(i), mesh),
                        engine.compute_dtype))
            else:
                master = _read_block(path, _leaf_file(PARAMS_DIR, p),
                                     engine._master_cuts(i), mesh)
                engine._masters[i].data.copy_(master)
                for n, s in zip(names, states):
                    getattr(opt, n)[i].copy_(s)
            nbytes += 4 * (master.numel() + sum(s.numel() for s in states))
        if names and host is not None:
            side = _offload_sidecar_path(path, mesh.rank)
            count = sc.get("optimizer_count", 0)
            if side is not None:
                with open(side) as f:
                    count = json.load(f)["step_count"]
            host.kernel.step_count = int(count)
        elif names:
            opt.count = int(sc.get("optimizer_count", 0))
        if engine._param_offload is not None:
            engine._param_offload.sync_store()
        if load_optimizer_states:
            _adopt_error_feedback(engine, path, meta)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)

    from deepspeed_tpu_torch.runtime.precision import LossScaleState
    engine.step_count = int(sc["step"])
    engine.loss_scale = LossScaleState(float(sc["loss_scale"]),
                                       int(sc["good_steps"]),
                                       int(sc["hysteresis"]))
    engine._skipped_steps = int(sc["skipped_steps"])
    client_state: Dict[str, Any] = {}
    if meta:
        engine.global_steps = meta.get("global_steps", 0)
        engine.global_samples = meta.get("global_samples", 0)
        engine.micro_steps = meta.get("micro_steps", 0)
        client_state = meta.get("client_state", {})
    if provenance and provenance.get("rng"):
        # the generators continue where the save left them
        _restore_rng(engine, provenance["rng"])
    engine.ckpt_stats = {"tag": tag, "bytes": nbytes,
                         "verify_s": t_verify - t0,
                         "read_s": time.perf_counter() - t_verify,
                         "seconds": time.perf_counter() - t0}
    log_dist(f"loaded checkpoint {path}", ranks=[0])
    return path, client_state
