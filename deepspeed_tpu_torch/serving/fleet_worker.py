"""One fleet replica as a process: tiny hermetic engine + HTTP front (port
of ``deepspeed_tpu/serving/fleet_worker.py``).

``python -m deepspeed_tpu_torch.serving.fleet_worker`` is what
``fleet.subprocess_launcher`` spawns — a ``build_tiny_server`` engine
behind a ``ServingFrontend``, on the card unless ``--device cpu``, publishing its URL through a ready file
(written atomically: the launcher polls for it). The process exits when
the front door's ``/admin/drain`` retirement completes (``on_retired``)
or on SIGTERM — so for the router, "process exited after drain" IS the
handoff-complete signal.

``DSTPU_REPLICA_ID`` identifies the replica in ``/healthz`` and selects
it for ``DSTPU_CHAOS_REPLICA_KILL`` drills; the launcher sets it, and a
bare CLI run defaults it to ``--replica-id``. Each worker is a process of
its own, so on the card each has its own CUDA context; a relaunch after a
SIGKILL starts a fresh one.
"""

import argparse
import json
import os
import signal
import sys
import threading
from typing import Optional, Sequence

from deepspeed_tpu_torch.resilience.chaos import REPLICA_ID_ENV


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="fleet_worker", description=__doc__)
    p.add_argument("--replica-id", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--ready-file", required=True,
                   help="JSON {url, pid, replica_id} written (atomically) "
                        "once the front door is up")
    p.add_argument("--kv-num-blocks", type=int, default=64)
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--host-kv-quantize", default="int8",
                   choices=("none", "int8", "fp8"))
    p.add_argument("--serving-overrides", default=None, metavar="JSON")
    p.add_argument("--adopt-handoff", default=None, metavar="PATH",
                   help="import this prefix handoff before serving")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    os.environ.setdefault(REPLICA_ID_ENV, str(args.replica_id))

    # heavyweight imports AFTER arg parsing (and after the env is set so
    # the chaos monkey + replica identity see it)
    from deepspeed_tpu_torch.serving.bench_serve import build_tiny_server
    from deepspeed_tpu_torch.serving.frontend import ServingFrontend

    overrides = (json.loads(args.serving_overrides)
                 if args.serving_overrides else {})
    server = build_tiny_server(
        kv_num_blocks=args.kv_num_blocks,
        kv_block_size=args.kv_block_size,
        host_kv_quantize=args.host_kv_quantize,
        serving_overrides=overrides, device=args.device).start()
    if args.adopt_handoff:
        server.adopt_prefix_handoff(args.adopt_handoff)
    done = threading.Event()
    frontend = ServingFrontend(server, host=args.host, port=args.port)
    frontend.on_retired = done.set
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    frontend.start()
    ready = {"url": frontend.url, "pid": os.getpid(),
             "replica_id": args.replica_id}
    tmp = args.ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ready, f)
    os.replace(tmp, args.ready_file)
    done.wait()
    frontend.stop()
    if server.running:            # SIGTERM path; retirement already stopped
        server.stop(drain_timeout=10.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
