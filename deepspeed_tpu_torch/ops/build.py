"""Build the port's CUDA kernels and host sources, and count launches.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, which the kernel's wrapper loads
with ``ctypes``. Builds happen on first use (never at import), one ``nvcc``
per source, all started together, into ``build/deepspeed_tpu_torch/`` at
the repository root. A library is named by a hash of its source, the
headers beside it and the flags, so an edited source or header is rebuilt
and an unchanged one is reused.

The host sources ``csrc/<name>.cpp`` (the fused CPU optimizers and the
async file I/O engine of the memory tiers) take the same road through
``g++`` with the JAX package's flags (``deepspeed_tpu/ops/op_builder.py``):
``-O3 -march=native -fopenmp``, plus ``-pthread`` for ``aio``. A
``-march=native`` binary runs only on CPUs like the one that built it, so
its name also hashes the CPU's identity (``/proc/cpuinfo``'s model name and
flags). A missing ``g++`` or a failed build raises with the compiler's
output; nothing falls back to a Python version. Their OpenMP runtime (the
system ``libgomp``; PyTorch's wheel carries its own) is loaded with
``OMP_WAIT_POLICY=PASSIVE`` unless the caller chose a policy: its threads
sleep between parallel regions instead of spinning on the cores that
PyTorch's threads need between two host optimizer calls.

Every wrapper calls ``count_launch(name)`` right after it launched its
kernel, and nowhere else: ``launch_counts()`` then shows which kernels a
run went through.
"""

import ctypes
import dataclasses
import hashlib
import os
import platform
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
# the JAX package's host flags (op_builder.py DEFAULT_FLAGS and its ops)
HOST_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared",
              "-std=c++17")
HOST_EXTRA_FLAGS = {"aio": ("-pthread",)}


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


def gxx() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise RuntimeError("g++ not found on PATH; the host sources "
                           "(csrc/*.cpp) are built with it on first use")
    return cand


def cpu_identity() -> str:
    """``/proc/cpuinfo``'s first model name and flags lines, with the
    machine type: what a ``-march=native`` binary depends on."""
    lines = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and key not in lines:
                    lines[key] = line.strip()
    except OSError:
        pass
    return "\n".join([platform.machine(), *[lines[k] for k in sorted(lines)]])


def host_flags(name: str) -> tuple:
    return HOST_FLAGS + HOST_EXTRA_FLAGS.get(name, ())


def _is_host(name: str) -> bool:
    return (CSRC / f"{name}.cpp").exists()


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, every header of
    ``CSRC`` (a source may include any of them) and the flags; a host
    source's also by the CPU's identity."""
    if _is_host(name):
        h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
        h.update(" ".join(host_flags(name)).encode())
        h.update(cpu_identity().encode())
        return BUILD_DIR / f"lib{name}-host-{h.hexdigest()[:16]}.so"
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    if _is_host(name):
        return [gxx(), *host_flags(name), str(CSRC / f"{name}.cpp"), "-o",
                str(out)]
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Sequence[str]) -> Dict[str, BuildResult]:
    """Compile every named source (``csrc/<name>.cu`` with nvcc,
    ``csrc/<name>.cpp`` with g++) that has no up-to-date library yet, all at
    once; raise with the compiler's output if any fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        cmd_of: Dict[str, List[str]] = {}
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
            cmd = cmd_of[name] = _command(name, tmp)
            procs.append((name, path, tmp, time.monotonic(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
        failures: List[str] = []
        for name, path, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            seconds = time.monotonic() - t0
            if proc.returncode != 0:
                failures.append(f"{Path(cmd_of[name][0]).name} failed for "
                                f"{name} (rc {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, path)               # atomic: readers never see half
            path.with_suffix(".log").write_text(log)
            _builds[name] = BuildResult(name, path, seconds, log)
        if failures:
            raise RuntimeError("\n".join(failures))
        return {n: _builds[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu`` or ``csrc/<name>.cpp``, built on
    first use."""
    lib = _libs.get(name)
    if lib is None:
        result = build([name])[name]
        if _is_host(name):         # read by libgomp when it loads, below
            os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(result.path)))
    return lib


def count_launch(name: str) -> None:
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()
