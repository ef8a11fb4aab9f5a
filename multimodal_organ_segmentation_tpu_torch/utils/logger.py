"""Logging: named-logger registry with console + file handlers.

A copy of the JAX package's ``utils/logger.py``: a
registry of named loggers, console handler at the requested level, file
handler always at DEBUG, and a ``LoggerAdapter`` with config/metric/epoch
helpers.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

_LOGGERS: Dict[str, logging.Logger] = {}

_FORMAT = "%(asctime)s | %(name)s | %(levelname)s | %(message)s"


def setup_logger(
    name: str = "main",
    log_file: Optional[str] = None,
    level: str = "INFO",
) -> logging.Logger:
    """Create (or reconfigure) a named logger."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    logger.propagate = False

    console = logging.StreamHandler(sys.stdout)
    console.setLevel(getattr(logging, level.upper(), logging.INFO))
    console.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(console)

    if log_file is not None:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setLevel(logging.DEBUG)  # file handler always records DEBUG
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)

    _LOGGERS[name] = logger
    return logger


def get_logger(name: str = "main") -> logging.Logger:
    """Fetch a logger from the registry, creating a console-only one if new."""
    if name not in _LOGGERS:
        return setup_logger(name)
    return _LOGGERS[name]


class LoggerAdapter:
    """Convenience wrappers for structured log lines."""

    def __init__(self, logger: logging.Logger):
        self.logger = logger

    def __getattr__(self, item: str) -> Any:
        return getattr(self.logger, item)

    def log_config(self, config: Mapping) -> None:
        self.logger.info("Configuration:")
        for key, value in config.items():
            if str(key).startswith("_"):
                continue
            self.logger.info(f"  {key}: {value}")

    def log_metrics(self, metrics: Mapping[str, Any], prefix: str = "") -> None:
        parts = []
        for k, v in metrics.items():
            if isinstance(v, float):
                parts.append(f"{k}={v:.6f}")
            elif isinstance(v, (int, str)):
                parts.append(f"{k}={v}")
        self.logger.info(f"{prefix}{' '.join(parts)}")

    def log_epoch(
        self, epoch: int, total: int, metrics: Mapping[str, Any]
    ) -> None:
        self.log_metrics(metrics, prefix=f"Epoch [{epoch}/{total}] ")
