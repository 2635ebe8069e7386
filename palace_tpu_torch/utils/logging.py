"""Leveled, timestamped logging shared by the port's stages."""
from __future__ import annotations

import logging
import sys
import time


class _Formatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(record.created))
        return f"[{ts}] [{record.levelname}] {record.getMessage()}"


def get_logger(name: str = "palace") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_Formatter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
