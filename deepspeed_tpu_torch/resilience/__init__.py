"""Resilience: the checkpoint policy (``checkpointing.py``) and the
deterministic fault injection (``chaos.py``), ported from
``deepspeed_tpu/resilience``.

The fault-tolerant loop around them (the runner with its SIGTERM
autosave, the step guard, the hung-step watchdog, membership and their
config group) is ROADMAP Queue 1 item 6b: its names are here so that a
caller learns that, and each raises ``NotImplementedError`` when built.
"""

from deepspeed_tpu_torch.resilience.chaos import (ITEM_6B, ChaosConfig,
                                                  ChaosInjectedIOError,
                                                  ChaosMonkey,
                                                  monkey_from_env)
from deepspeed_tpu_torch.resilience.checkpointing import (Autosaver,
                                                          CheckpointSaveError,
                                                          find_latest_committed,
                                                          list_tags,
                                                          prune_checkpoints,
                                                          resume_from_latest,
                                                          save_with_retry)


def _item_6b(name: str, module: str):
    """A class of ``resilience/<module>.py`` that is not ported yet."""
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} (resilience/{module}.py) is not "
                                  f"ported yet ({ITEM_6B})")
    return type(name, (), {"__init__": __init__, "__module__": __name__})


FaultTolerantRunner = _item_6b("FaultTolerantRunner", "runner")
StepGuard = _item_6b("StepGuard", "guards")
StepWatchdog = _item_6b("StepWatchdog", "watchdog")
MembershipView = _item_6b("MembershipView", "membership")
ResilienceConfig = _item_6b("ResilienceConfig", "config")

__all__ = [
    "Autosaver",
    "ChaosConfig",
    "ChaosInjectedIOError",
    "ChaosMonkey",
    "CheckpointSaveError",
    "FaultTolerantRunner",
    "MembershipView",
    "ResilienceConfig",
    "StepGuard",
    "StepWatchdog",
    "find_latest_committed",
    "list_tags",
    "monkey_from_env",
    "prune_checkpoints",
    "resume_from_latest",
    "save_with_retry",
]
