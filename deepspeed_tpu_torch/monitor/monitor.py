"""Experiment monitoring (copy of ``deepspeed_tpu/monitor/monitor.py``,
reference ``deepspeed/monitor/monitor.py:13``): the ``Monitor`` base that
takes ``(tag, value, step)`` events and its CSV backend, rank 0 only.

The TensorBoard, WandB and Comet backends and ``MonitorMaster`` are not
ported yet (ROADMAP Queue 1, "the rest").
"""

import csv
import os
from typing import List, Tuple

import torch.distributed as dist

Event = Tuple[str, float, int]


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Monitor:
    def __init__(self, config):
        self.enabled = False

    def write_events(self, events: List[Event]):
        raise NotImplementedError


class CSVMonitor(Monitor):
    """reference: monitor/csv_monitor.py — one csv per tag."""

    def __init__(self, csv_config):
        self.enabled = csv_config.enabled and _rank() == 0
        self.output_path = csv_config.output_path or "./csv_monitor"
        self.job_name = csv_config.job_name

    def _path_for(self, tag: str) -> str:
        d = os.path.join(self.output_path, self.job_name)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, tag.replace("/", "_") + ".csv")

    def write_events(self, events: List[Event]):
        if not self.enabled:
            return
        for tag, value, step in events:
            p = self._path_for(tag)
            new = not os.path.exists(p)
            with open(p, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["step", tag])
                w.writerow([step, value])
