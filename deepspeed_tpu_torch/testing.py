"""Multi-process distributed test harness.

Port of ``deepspeed_tpu/testing.py`` (reference ``tests/unit/common.py:416``
``DistributedTest``): every distributed test spawns ``world_size`` real
processes on one host (``_launch_daemonic_procs:170``), which rendezvous
over TCP through the port's ``init_distributed``, run the test body in
every rank (``_dist_run:279``) and hand failures and timeouts back.

``run_distributed`` launches N fresh Python processes. Each starts
``torch.distributed`` on ``device`` (the card by default; the CPU tests
name ``device="cpu"``) with ``backend`` (by default NCCL on the card and
gloo on the CPU, as ``init_distributed`` picks; two ranks on one card name
gloo, since NCCL refuses a second rank on a device) and calls the target, which
must be importable (``module:qualname``). Each rank's
``OMP_NUM_THREADS`` defaults to its share of the cores. Returns each
rank's stdout.
"""

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Optional, Sequence, Union

DEFAULT_TIMEOUT = 240

_BOOTSTRAP = r"""
import importlib, os, sys
for p in os.environ.get("DSTPU_TEST_PATH", "").split(os.pathsep):
    if p and p not in sys.path:
        sys.path.insert(0, p)
from deepspeed_tpu_torch.comm.mesh import init_distributed
# the bounded rendezvous (comm/guard.py bounded_init): a dead coordinator
# fails the rank inside the deadline instead of hanging the harness
init_distributed(
    coordinator_address=os.environ["DSTPU_TEST_COORD"],
    num_processes=int(os.environ["DSTPU_TEST_NPROC"]),
    process_id=int(os.environ["DSTPU_TEST_RANK"]),
    backend=os.environ["DSTPU_TEST_BACKEND"],
    device=os.environ["DSTPU_TEST_DEVICE"])
mod_name, _, qual = os.environ["DSTPU_TEST_FN"].partition(":")
fn = importlib.import_module(mod_name)
for part in qual.split("."):
    fn = getattr(fn, part)
try:
    fn()
finally:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _target(fn: Union[Callable, str]):
    """``module:qualname`` of ``fn`` and the paths a child needs."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    extra_paths = [repo_root]
    if callable(fn):
        mod = getattr(fn, "__module__", None)
        qual = getattr(fn, "__qualname__", None)
        if not mod or not qual or "<locals>" in qual:
            raise ValueError("fn must be importable (module-level) to run in "
                             "spawned ranks")
        if "." in mod:
            import importlib.util
            try:
                if importlib.util.find_spec(mod) is None:
                    raise ValueError(f"module {mod!r} is not importable from "
                                     "a spawned rank")
            except ImportError:
                raise ValueError(f"module {mod!r} is not importable from a "
                                 "spawned rank") from None
        else:
            # a top-level module (a pytest-loaded test file): its own
            # directory must be importable in the child
            mod_file = getattr(sys.modules.get(mod), "__file__", None)
            if mod_file:
                extra_paths.append(os.path.dirname(os.path.abspath(mod_file)))
        fn = f"{mod}:{qual}"
    return fn, repo_root, extra_paths


def run_distributed(fn: Union[Callable, str], world_size: int = 2,
                    timeout: float = DEFAULT_TIMEOUT,
                    env: Optional[dict] = None,
                    backend: Optional[str] = None,
                    device: str = "cuda") -> Sequence[str]:
    """Run ``fn`` in ``world_size`` fresh processes under one
    ``torch.distributed`` rendezvous. ``fn`` is a module-level callable or
    a ``"module:qualname"`` string. Returns per-rank stdout; raises
    RuntimeError with the failing rank's output on a nonzero exit, or
    TimeoutError after ``timeout`` seconds (every rank is killed)."""
    fn, repo_root, extra_paths = _target(fn)
    if backend is None:
        backend = "nccl" if device.startswith("cuda") else "gloo"
    coord = f"127.0.0.1:{free_port()}"
    # ranks that each take every core for their intra-op threads slow one
    # another down tenfold on the CPU: each gets its share unless the
    # caller says otherwise
    threads = str(max(1, (os.cpu_count() or 1) // world_size))
    procs = []
    for rank in range(world_size):
        rank_env = dict(os.environ, OMP_NUM_THREADS=threads,
                        DSTPU_TEST_COORD=coord,
                        DSTPU_TEST_NPROC=str(world_size),
                        DSTPU_TEST_RANK=str(rank),
                        DSTPU_TEST_BACKEND=backend,
                        DSTPU_TEST_DEVICE=device,
                        DSTPU_TEST_FN=fn,
                        DSTPU_TEST_PATH=os.pathsep.join(extra_paths),
                        LOCAL_RANK=str(rank))
        rank_env.update(env or {})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _BOOTSTRAP], env=rank_env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=repo_root))

    # drain every rank at once: a rank blocked on a full stdout pipe would
    # stall its collectives and look like a hang of its peers
    outs = [None] * world_size

    def drain(rank, p):
        outs[rank], _ = p.communicate()

    readers = [threading.Thread(target=drain, args=(r, p), daemon=True)
               for r, p in enumerate(procs)]
    for t in readers:
        t.start()
    deadline = time.time() + timeout
    try:
        for t in readers:
            t.join(max(0.0, deadline - time.time()))
        timed_out = [r for r, t in enumerate(readers) if t.is_alive()]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for t in readers:
        t.join(10)
    # a rank that crashed while its peers hung in a collective is the root
    # cause: report its output, not the peers' timeout
    for rank, p in enumerate(procs):
        if p.returncode not in (0, None) and rank not in timed_out:
            raise RuntimeError(
                f"rank {rank} exited {p.returncode}:\n{outs[rank]}")
    if timed_out:
        raise TimeoutError(f"ranks {timed_out} timed out ({timeout}s)")
    return outs


class DistributedTest:
    """Class-style sugar matching the reference spelling: subclass, set
    ``world_size``, point ``run = staticmethod(body_fn)`` at a module-level
    body, call ``self.launch()`` from a normal pytest test."""

    world_size: int = 2
    timeout: float = DEFAULT_TIMEOUT
    backend: Optional[str] = None
    device: str = "cuda"
    run: Callable = None

    def launch(self):
        return run_distributed(type(self).run, self.world_size, self.timeout,
                               backend=self.backend, device=self.device)
