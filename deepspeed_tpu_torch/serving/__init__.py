"""Continuous-batching serving layer over the v2 ragged engine (port of
``deepspeed_tpu/serving/``; MII analog).

Request lifecycle + serve loop + tiered admission control (host-RAM KV
offload) + degradation ladder + request-level fault isolation +
observability + a stdlib HTTP front door (``frontend.py``, run by
``python -m deepspeed_tpu_torch.serving.cli``) + the ``bench_serve`` load
harness; the prefill/decode role split (``disagg.py``,
``serving.scheduler.role_split``) and the multi-replica fleet router
(``fleet.py`` over ``fleet_worker.py`` processes, run by
``python -m deepspeed_tpu_torch.serving.fleet``).
"""

from deepspeed_tpu_torch.serving.degradation import (DegradationLadder,
                                                     LadderConfig, ServeLevel)
from deepspeed_tpu_torch.serving.disagg import DisaggregatedEngine
from deepspeed_tpu_torch.serving.fleet import (FleetConfig, FleetRouter,
                                               ReplicaHandle)
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
    "DisaggregatedEngine",
    "FleetConfig",
    "FleetRouter",
    "InferenceServer",
    "LadderConfig",
    "ReplicaHandle",
    "Request",
    "RequestState",
    "ServeLevel",
    "ServerClosedError",
    "ServingConfig",
    "ServingFrontend",
    "ServingMetrics",
]
