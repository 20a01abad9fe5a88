"""Rank-aware logging.

Counterpart of ``deepspeed_tpu/utils/logging.py``: one package logger plus
rank-filtered helpers. The rank comes from ``torch.distributed`` when a
process group is up, else from the ``RANK`` environment variable.
"""

from __future__ import annotations

import functools
import logging
import os
import sys

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch",
                   level: int | None = None) -> logging.Logger:
    if level is None:
        level = getattr(logging,
                        os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper(),
                        logging.INFO)
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(LOG_FORMAT))
        lg.addHandler(handler)
    return lg


logger = _create_logger()


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def log_dist(message: str, ranks: list[int] | None = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` only on the listed process ranks (``[-1]`` or None =
    all)."""
    my_rank = _rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message: str) -> None:
    _warn_cache(message)


@functools.lru_cache(None)
def _warn_cache(message: str) -> None:
    logger.warning(message)
