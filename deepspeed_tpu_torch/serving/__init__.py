"""Continuous-batching serving layer over the v2 ragged engine (port of
``deepspeed_tpu/serving/``; MII analog), as one replica.

Request lifecycle + serve loop + tiered admission control (host-RAM KV
offload) + degradation ladder + request-level fault isolation +
observability + a stdlib HTTP front door (``frontend.py``, run by
``python -m deepspeed_tpu_torch.serving.cli``) + the ``bench_serve`` load
harness. The prefill/decode role split (``disagg.py``) and the
multi-replica fleet (``fleet.py``, ``fleet_worker.py``) are not ported yet
(ROADMAP Queue 1, "the serving-layer slice").
"""

from deepspeed_tpu_torch.serving.degradation import (DegradationLadder,
                                                     LadderConfig, ServeLevel)
from deepspeed_tpu_torch.serving.frontend import ServingFrontend
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.request import Request, RequestState
from deepspeed_tpu_torch.serving.server import (BackpressureError,
                                                InferenceServer,
                                                ServerClosedError,
                                                ServingConfig)

__all__ = [
    "BackpressureError",
    "DegradationLadder",
    "InferenceServer",
    "LadderConfig",
    "Request",
    "RequestState",
    "ServeLevel",
    "ServerClosedError",
    "ServingConfig",
    "ServingFrontend",
    "ServingMetrics",
]
