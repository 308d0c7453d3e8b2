"""Universal-checkpoint tools: inspect / consolidate / extract.

Port of ``deepspeed_tpu/checkpoint/universal.py`` (reference
``deepspeed/checkpoint/ds_to_universal.py``, ``utils/zero_to_fp32.py``).
The engine checkpoint (``checkpoint/engine.py``) is already
parameter-atomic, one whole-leaf ``.npy`` file a leaf, so every checkpoint
is a universal checkpoint. What is left to do, on the host, with no card:

- ``inspect_checkpoint``: the parameter inventory and the provenance,
  from the files' headers (no array byte read);
- ``consolidate_to_fp32``: one ``.npz`` of fp32 weights under
  ``params/<flax path>``, the JAX package's keys letter for letter, so an
  npz either package consolidates loads in the other;
  ``include_optimizer`` adds the optimizer states under
  ``opt_state/<state>/<flax path>`` (the port's own keys: the JAX package
  flattens its optax tree there);
- ``extract_param``: one parameter, read from its own file;
- ``compat_check``: whether a checkpoint's global batch divides over the
  data-parallel world of another size (the JAX package also re-plans the
  memory ledger, ``telemetry/memory``, which is not ported).

CLI: ``python -m deepspeed_tpu_torch.checkpoint.universal inspect PATH
[--tag T] [--compat WORLD]`` and ``... consolidate PATH OUT.npz [--tag T]
[--include-optimizer]``.
"""

import concurrent.futures
import json
import os
import struct
import zipfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.checkpoint.engine import (LATEST_FILE, META_FILE,
                                                   OPT_DIR, PARAMS_DIR, _pool,
                                                   crc32_combine)
from deepspeed_tpu_torch.utils.logging import logger

#: bytes a consolidation copies at a time
COPY_BYTES = 64 << 20


def resolve_checkpoint_dir(path: str, tag: Optional[str] = None) -> str:
    """A checkpoint dir itself, or the tag ``latest`` names (or ``tag``)
    under a save dir."""
    path = os.path.abspath(path)
    if tag is not None:
        tagged = os.path.join(path, str(tag))
        if not os.path.isdir(tagged):
            raise FileNotFoundError(f"no checkpoint with tag {tag!r} under "
                                    f"{path}")
        return tagged
    if os.path.exists(os.path.join(path, META_FILE)) or os.path.isdir(
            os.path.join(path, PARAMS_DIR)):
        return path
    latest = os.path.join(path, LATEST_FILE)
    if os.path.exists(latest):
        with open(latest) as f:
            return os.path.join(path, f.read().strip())
    raise FileNotFoundError(f"no checkpoint found under {path}")


def _npy_header(path: str):
    """(shape, dtype) from a ``.npy`` file's header."""
    with open(path, "rb") as f:
        major, _ = np.lib.format.read_magic(f)
        read = np.lib.format.read_array_header_1_0 if major == 1 \
            else np.lib.format.read_array_header_2_0
        shape, _, dtype = read(f)
    return list(shape), str(dtype)


def _leaf_files(ckpt_dir: str, kind: str) -> Dict[str, str]:
    """{leaf name: file} of the ``.npy`` files under ``kind``, the names
    ``/``-joined as the JAX package flattens its tree."""
    root = os.path.join(ckpt_dir, kind)
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith(".npy"):
                full = os.path.join(dirpath, n)
                out[os.path.relpath(full, root)[:-4].replace(os.sep, "/")] = \
                    full
    return dict(sorted(out.items()))


def _meta(ckpt_dir: str) -> Dict[str, Any]:
    meta_path = os.path.join(ckpt_dir, META_FILE)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def inspect_checkpoint(path: str, tag: Optional[str] = None) -> Dict[str, Any]:
    """Parameter inventory + metadata + provenance, from the files'
    headers only."""
    ckpt_dir = resolve_checkpoint_dir(path, tag)
    meta = _meta(ckpt_dir)
    params = {}
    for name, full in _leaf_files(ckpt_dir, PARAMS_DIR).items():
        shape, dtype = _npy_header(full)
        params[name] = {"shape": shape, "dtype": dtype}
    total = int(sum(int(np.prod(m["shape"])) for m in params.values()))
    return {"checkpoint": ckpt_dir, "meta": meta, "num_params": total,
            "provenance": provenance_summary(meta), "parameters": params}


def provenance_summary(meta: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The rendered provenance block: saved world, the mesh axes larger
    than 1, the ZeRO placement, step, sampler position, the RNG record's
    shape. None for a checkpoint without provenance."""
    prov = (meta or {}).get("provenance")
    if not prov:
        return None
    mesh = prov.get("mesh") or {}
    rng = prov.get("rng") or {}
    return {
        "saved_world": prov.get("world"),
        "mesh_axes": {a: s for a, s in mesh.items() if int(s or 1) != 1}
        or {"(all axes 1)": 1},
        "zero": prov.get("zero"),
        "step": (meta or {}).get("global_steps"),
        "sampler": prov.get("sampler"),
        "rng_key": {"shape": rng.get("shape"), "dtype": rng.get("dtype"),
                    "typed": rng.get("typed")},
        "batch": prov.get("batch"),
        "ledger": {k: v for k, v in (prov.get("ledger") or {}).items()
                   if k != "phase_hbm_bytes"},
    }


def compat_check(path: str, world: int, tag: Optional[str] = None
                 ) -> Dict[str, Any]:
    """Resharding feasibility of resuming this checkpoint at ``world``
    ranks, from its metadata: the saved global batch must divide over the
    data-parallel part of the world (the model-parallel axes of the saved
    mesh divided out). The memory-ledger check of the JAX package is not
    made: ``telemetry/memory`` is not ported."""
    ckpt_dir = resolve_checkpoint_dir(path, tag)
    prov = _meta(ckpt_dir).get("provenance") or {}
    out: Dict[str, Any] = {"checkpoint": ckpt_dir, "world": int(world),
                           "checks": {}, "feasible": True}
    if not prov:
        out["feasible"] = False
        out["checks"]["provenance"] = {
            "ok": False, "detail": "legacy checkpoint: no provenance block "
            "(saved before PROVENANCE_VERSION 1)"}
        return out
    tb = int((prov.get("batch") or {}).get("train_batch_size", 0) or 0)
    mesh = prov.get("mesh") or {}
    model_world = 1
    for a in ("pipe", "tensor", "expert", "sequence"):
        model_world *= max(1, int(mesh.get(a, 1) or 1))
    dp = max(1, int(world) // model_world)
    ok = not tb or tb % dp == 0
    detail = (f"train_batch_size {tb} divides over dp world {dp} ({world} "
              f"ranks / model-parallel {model_world})") if ok else (
        f"train_batch_size {tb} not divisible by the dp world {dp} ({world} "
        f"ranks / model-parallel {model_world}): the sampler contract "
        f"(global batch invariant) cannot hold")
    out["checks"]["batch"] = {"ok": ok, "detail": detail}
    out["checks"]["ledger"] = {
        "ok": True, "bytes_limit": (prov.get("ledger") or {}).get(
            "bytes_limit"),
        "detail": "no memory plan: telemetry/memory is not ported"}
    out["feasible"] = all(c.get("ok") for c in out["checks"].values())
    return out


def consolidate_to_fp32(path: str, output: str, tag: Optional[str] = None,
                        include_optimizer: bool = False) -> str:
    """The ``zero_to_fp32`` analog: one ``.npz`` of fp32 weights (and with
    ``include_optimizer`` the optimizer states). Returns its path. The
    checkpoint's files are fp32 ``.npy`` files already, so each becomes its
    member byte for byte, as ``np.savez`` would write it, in pieces of
    ``COPY_BYTES``."""
    ckpt_dir = resolve_checkpoint_dir(path, tag)
    members = {f"params/{k}": v
               for k, v in _leaf_files(ckpt_dir, PARAMS_DIR).items()}
    if include_optimizer:
        members.update({f"opt_state/{k}": v
                        for k, v in _leaf_files(ckpt_dir, OPT_DIR).items()})
    output = os.path.abspath(output)
    out_path = output if output.endswith(".npz") else output + ".npz"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    buf = bytearray(COPY_BYTES)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, full in members.items():
            with open(full, "rb", buffering=0) as src, \
                    zf.open(f"{key}.npy", "w", force_zip64=True) as dst:
                while True:
                    n = src.readinto(buf)
                    if not n:
                        break
                    dst.write(memoryview(buf)[:n])
    logger.info(f"consolidated {len(members)} tensors -> {out_path}")
    return out_path


def extract_param(path: str, param_name: str,
                  tag: Optional[str] = None) -> np.ndarray:
    """One parameter, read from its own file (the per-parameter atomic
    file of the reference's universal checkpoint)."""
    ckpt_dir = resolve_checkpoint_dir(path, tag)
    known = _leaf_files(ckpt_dir, PARAMS_DIR)
    if param_name not in known:
        close = [k for k in known if param_name in k]
        raise KeyError(f"param {param_name!r} not in checkpoint; "
                       f"closest: {close[:5]}")
    return np.load(known[param_name])


def _npy_layout(f) -> Tuple[tuple, bool, np.dtype]:
    """(shape, fortran order, dtype) from the ``.npy`` header at ``f``."""
    fmt = np.lib.format
    version = fmt.read_magic(f)
    read = {(1, 0): fmt.read_array_header_1_0,
            (2, 0): fmt.read_array_header_2_0}.get(version)
    if read is None:
        raise ValueError(f".npy format {version} is not read here")
    shape, fortran, dtype = read(f)
    if dtype.hasobject:
        raise ValueError(".npy member holds Python objects")
    return shape, fortran, dtype


def _pread_crc(fd: int, view: memoryview, offset: int) -> int:
    """Fill ``view`` from ``fd`` at ``offset``; the bytes' CRC32."""
    got = 0
    while got < len(view):
        n = os.preadv(fd, [view[got:]], offset + got)
        if not n:
            raise zipfile.BadZipFile("npz member ends early")
        got += n
    return zlib.crc32(view)


def _read_stored(npz_path: str, info: zipfile.ZipInfo, fd: int, pool):
    """An uncompressed member: its array, the CRC32 of its ``.npy`` header
    and the pieces (future of the piece's CRC32, its length) in which the
    pool fills the array from ``fd``, ``COPY_BYTES`` each."""
    with open(npz_path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        if local[:4] != b"PK\x03\x04":
            raise zipfile.BadZipFile(f"{npz_path}: bad header for "
                                     f"{info.filename}")
        start = info.header_offset + 30 + sum(struct.unpack("<HH",
                                                            local[26:30]))
        f.seek(start)
        shape, fortran, dtype = _npy_layout(f)
        head = f.tell() - start
        f.seek(start)
        head_crc = zlib.crc32(f.read(head))
    arr = np.empty(shape, dtype, order="F" if fortran else "C")
    view = memoryview(arr.reshape(-1, order="A")).cast("B")
    if head + len(view) != info.file_size:
        raise zipfile.BadZipFile(f"{npz_path}: {info.filename} does not "
                                 f"hold {shape} {dtype}")
    parts = [(pool.submit(_pread_crc, fd, view[a:a + COPY_BYTES],
                          start + head + a), min(COPY_BYTES, len(view) - a))
             for a in range(0, len(view), COPY_BYTES)]
    return arr, head_crc, parts


def load_fp32_state(npz_path: str) -> Dict[str, np.ndarray]:
    """Read back a consolidated file as {name: array}: the ``params/``
    members, each read in pieces on the checkpoint engine's threads
    straight into its array and held to its CRC32 in the archive. The
    members must be stored uncompressed, as ``np.savez`` (either package's
    ``consolidate_to_fp32``) stores them."""
    pool, out, pieces = _pool(), {}, {}
    fd = os.open(npz_path, os.O_RDONLY)
    try:
        with zipfile.ZipFile(npz_path) as zf:
            for info in zf.infolist():
                if not info.filename.startswith("params/"):
                    continue
                if info.compress_type != zipfile.ZIP_STORED:
                    raise ValueError(f"{npz_path}: {info.filename} is "
                                     "compressed; write the npz with "
                                     "np.savez")
                key = info.filename[len("params/"):].removesuffix(".npy")
                out[key], crc, parts = _read_stored(npz_path, info, fd, pool)
                pieces[key] = (info, crc, parts)
        for info, crc, parts in pieces.values():
            for fut, n in parts:
                crc = crc32_combine(crc, fut.result(), n)
            if crc != info.CRC:
                raise zipfile.BadZipFile(
                    f"Bad CRC-32 for file {info.filename!r}")
        return out
    finally:
        concurrent.futures.wait([f for _, _, parts in pieces.values()
                                 for f, _ in parts])
        os.close(fd)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch.checkpoint.universal",
        description="Universal checkpoint tools (inspect / consolidate to "
                    "fp32)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("inspect", help="list parameters + metadata + "
                                        "provenance")
    pi.add_argument("path")
    pi.add_argument("--tag", default=None)
    pi.add_argument("--compat", type=int, metavar="WORLD", default=None,
                    help="also report resharding feasibility at WORLD "
                         "ranks; exit 1 when infeasible")
    pc = sub.add_parser("consolidate",
                        help="write a single fp32 .npz (zero_to_fp32 analog)")
    pc.add_argument("path")
    pc.add_argument("output")
    pc.add_argument("--tag", default=None)
    pc.add_argument("--include-optimizer", action="store_true")
    args = p.parse_args(argv)
    if args.cmd == "inspect":
        info = inspect_checkpoint(args.path, tag=args.tag)
        if args.compat is not None:
            info["compat"] = compat_check(args.path, args.compat,
                                          tag=args.tag)
        print(json.dumps(info, indent=2))
        if args.compat is not None and not info["compat"]["feasible"]:
            return 1
    else:
        print(consolidate_to_fp32(args.path, args.output, tag=args.tag,
                                  include_optimizer=args.include_optimizer))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
