"""Stand up the serving stack on one host (port of
``deepspeed_tpu/serving/cli.py``, the reference's ``dstpu_serve``).

Builds a Llama-family model from a named preset with random weights from a
seed (``init_llama_params``), wraps it in ``InferenceEngineV2`` +
``InferenceServer`` + the HTTP front door, and serves until SIGINT or
SIGTERM (which triggers a graceful drain). The engine runs on the card
unless ``--device cpu`` is asked for:

    python -m deepspeed_tpu_torch.serving.cli --preset LLAMA3_8B --port 8000
    curl -s localhost:8000/generate -d '{"prompt_tokens": [1,2,3]}'
"""

import argparse
import signal
import sys
import threading


def main(argv=None):
    p = argparse.ArgumentParser(prog="deepspeed_tpu_torch.serving.cli",
                                description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--preset", default="TINY_LLAMA",
                   help="model preset from deepspeed_tpu_torch.models.llama "
                        "(TINY_LLAMA, LLAMA3_8B, ...)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--checkpoint", default=None,
                   help="fp32 params path (not ported yet)")
    p.add_argument("--max-queue-depth", type=int, default=64)
    p.add_argument("--max-new-tokens", type=int, default=64,
                   help="default per-request generation budget")
    p.add_argument("--kv-num-blocks", type=int, default=512)
    p.add_argument("--kv-block-size", type=int, default=64)
    p.add_argument("--kv-high-watermark", type=float, default=0.95)
    p.add_argument("--request-timeout-s", type=float, default=None)
    p.add_argument("--kv-offload", action="store_true",
                   help="enable the host-RAM KV offload tier (overload "
                        "demotes queued/idle requests' KV pages to host "
                        "RAM instead of rejecting)")
    p.add_argument("--host-kv-budget-mb", type=int, default=256,
                   help="host-RAM budget for demoted KV pages")
    p.add_argument("--brownout-pressure", type=float, default=0.85,
                   help="degradation-ladder brownout threshold")
    p.add_argument("--shed-pressure", type=float, default=0.97,
                   help="degradation-ladder shed (429) threshold")
    p.add_argument("--brownout-max-new-tokens", type=int, default=16,
                   help="per-request generation cap while browned out")
    args = p.parse_args(argv)

    from deepspeed_tpu_torch.models import llama as llama_lib

    cfg = getattr(llama_lib, args.preset, None)
    if not isinstance(cfg, llama_lib.LlamaConfig):
        p.error(f"unknown preset {args.preset!r}")
    if args.checkpoint:
        # the reference re-nests a universal fp32 npz
        # (checkpoint/universal.py::load_fp32_state), which is not ported
        raise NotImplementedError(
            "--checkpoint is not ported yet: it comes with checkpoint and "
            "resilience (ROADMAP Queue 1)")

    from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,
                                                            V2EngineConfig)
    from deepspeed_tpu_torch.models.convert import init_llama_params
    from deepspeed_tpu_torch.serving import (InferenceServer, ServingConfig,
                                             ServingFrontend)
    from deepspeed_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    params = init_llama_params(cfg, seed=args.seed, device=device)
    engine = InferenceEngineV2(params, cfg, V2EngineConfig(
        kv_block_size=args.kv_block_size, kv_num_blocks=args.kv_num_blocks),
        device=device)
    server = InferenceServer(engine, ServingConfig(
        max_queue_depth=args.max_queue_depth,
        default_max_new_tokens=args.max_new_tokens,
        default_timeout_s=args.request_timeout_s,
        kv_high_watermark=args.kv_high_watermark,
        kv_offload_enabled=args.kv_offload,
        host_kv_budget_bytes=args.host_kv_budget_mb << 20,
        brownout_pressure=args.brownout_pressure,
        shed_pressure=args.shed_pressure,
        brownout_max_new_tokens=args.brownout_max_new_tokens)).start()
    frontend = ServingFrontend(server, host=args.host, port=args.port).start()
    print(f"deepspeed_tpu_torch.serving: {frontend.url} (preset="
          f"{args.preset}, device={device}, kv_blocks={args.kv_num_blocks})",
          flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    print("deepspeed_tpu_torch.serving: draining...", flush=True)
    server.stop(drain_timeout=30.0)
    frontend.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
