"""Rank-aware logging (copy of ``deepspeed_tpu/utils/logging.py``).

A module-level logger plus rank-filtered helpers. The rank is
``torch.distributed``'s when a process group is up, else 0.
"""

import logging
import os
import sys
from typing import Iterable, Optional

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


def create_logger(name: str = "deepspeed_tpu_torch",
                  level: int = logging.INFO) -> logging.Logger:
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(logging.Formatter(LOG_FORMAT))
        logger_.addHandler(handler)
    return logger_


logger = create_logger(
    level=getattr(logging, os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper(),
                  logging.INFO))


def _process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` only on the listed ranks (None or [] => rank 0,
    [-1] => all)."""
    my_rank = _process_index()
    if ranks is None or len(list(ranks)) == 0:
        should = my_rank == 0
    else:
        ranks = list(ranks)
        should = (-1 in ranks) or (my_rank in ranks)
    if should:
        logger.log(level, f"[Rank {my_rank}] {message}")
