"""Build the port's CUDA kernels and count their launches.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, which the kernel's wrapper loads
with ``ctypes``. Builds happen on first use (never at import), one ``nvcc``
per source, all started together, into ``build/deepspeed_tpu_torch/`` at
the repository root. A library is named by a hash of its source, the
headers beside it and the flags, so an edited source or header is rebuilt
and an unchanged one is reused.

Every wrapper calls ``count_launch(name)`` right after it launched its
kernel, and nowhere else: ``launch_counts()`` then shows which kernels a
run went through.
"""

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepspeed_tpu_torch"
# --split-compile=0 spreads one source's device compilation over all cores,
# for the evoformer source's 50 template instances (build times in PERF.md)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float       # nvcc wall time; 0.0 when an earlier build was reused
    log: str             # nvcc output, with ptxas's registers and shared memory


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_builds: Dict[str, BuildResult] = {}
_launches: Dict[str, int] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                       "the CUDA kernels are built on the machine with the card")


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, every header of
    ``CSRC`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, BuildResult]:
    """Compile every named source that has no up-to-date library yet, all
    at once; raise with nvcc's output if any fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in names:
            if name in _builds:
                continue
            path = _target(name)
            log_path = path.with_suffix(".log")
            if path.exists() and log_path.exists():
                _builds[name] = BuildResult(name, path, 0.0,
                                            log_path.read_text())
                continue
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, path, tmp, time.monotonic(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
        failures: List[str] = []
        for name, path, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            seconds = time.monotonic() - t0
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name} (rc "
                                f"{proc.returncode}):\n{log}")
                continue
            os.replace(tmp, path)               # atomic: readers never see half
            path.with_suffix(".log").write_text(log)
            _builds[name] = BuildResult(name, path, seconds, log)
        if failures:
            raise RuntimeError("\n".join(failures))
        return {n: _builds[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        result = build([name])[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(result.path)))
    return lib


def count_launch(name: str) -> None:
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()
