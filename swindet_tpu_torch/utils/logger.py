"""The root logger (counterpart of ``swindet_tpu/utils/logger.py:11``;
reference mmdet/utils/logger.py:19)."""
from __future__ import annotations

import logging
from typing import Optional

import torch

LOG_FORMAT = '%(asctime)s - %(name)s - %(levelname)s - %(message)s'


def _rank() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO,
                    name: str = 'swindet') -> logging.Logger:
    """Get (and on first use set up) the framework's logger: a stream
    handler, and a file handler for ``log_file`` on rank 0. Rank 0 logs
    at ``log_level``, other ranks errors only."""
    logger = logging.getLogger(name)
    if getattr(logger, '_swindet_init', False):
        return logger
    fmt = logging.Formatter(LOG_FORMAT)
    stream = logging.StreamHandler()
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    rank = _rank()
    if rank == 0 and log_file is not None:
        fh = logging.FileHandler(log_file, 'w')
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    logger._swindet_init = True
    return logger


def print_log(msg: str, logger=None, level: int = logging.INFO) -> None:
    if logger is None:
        print(msg)
    elif logger == 'silent':
        pass
    elif isinstance(logger, str):
        get_root_logger(name=logger).log(level, msg)
    else:
        logger.log(level, msg)
