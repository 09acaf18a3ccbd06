"""Leveled, colored logging (port of ``scl_slam_tpu/utils/logging.py``,
the standard library only): the rosconsole replacement.

The reference routes ANSI-colored ``ROS_INFO/DEBUG/ERROR`` through rosconsole
with the level picked by a one-line config file
(``config/rosconsole_{info,warn,error}.conf``, SURVEY §5). Here: stdlib
logging with the same color scheme, level from ``SCL_SLAM_LOG`` env var or
:func:`configure`.
"""
from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    logging.DEBUG: "\033[32m",    # green (rosconsole debug)
    logging.INFO: "\033[0m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[1;31m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


def configure(level: str | int | None = None) -> logging.Logger:
    """Configure and return the package logger (idempotent)."""
    logger = logging.getLogger("scl_slam_tpu_torch")
    if logger.handlers:
        return logger
    if level is None:
        level = os.environ.get("SCL_SLAM_LOG", "INFO")
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    handler = logging.StreamHandler()
    handler.setFormatter(
        _ColorFormatter("[%(levelname).1s %(asctime)s %(name)s] %(message)s", "%H:%M:%S")
    )
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger


def get_logger(name: str = "") -> logging.Logger:
    base = configure()
    return base.getChild(name) if name else base
