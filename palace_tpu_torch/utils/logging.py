"""Leveled, timestamped logging shared by the port's stages.

The reference driver's ``log()`` (palace:81-108), with its SUCCESS
level, and ``show_progress`` (palace:163-170), as a thin wrapper over
:mod:`logging` so every stage shares one sink and a ``tee``-style
logfile can be attached (palace:320-325).
"""
from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

SUCCESS = 25  # between INFO and WARNING
logging.addLevelName(SUCCESS, "SUCCESS")


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


def attach_logfile(path: str | Path, name: str = "palace") -> None:
    """Also write every log line to ``path`` (palace:320-325)."""
    handler = logging.FileHandler(path)
    handler.setFormatter(_Formatter())
    get_logger(name).addHandler(handler)


def log(level: str, *message: object, name: str = "palace") -> None:
    """Bash-style ``log LEVEL msg...`` (palace:86-108)."""
    lvl = SUCCESS if level.upper() == "SUCCESS" else getattr(logging, level.upper(), logging.INFO)
    get_logger(name).log(lvl, " ".join(str(m) for m in message))


def show_progress(current: int, total: int, step_name: str, name: str = "palace") -> None:
    """Progress line (palace:163-170)."""
    percent = current * 100 // total
    log("INFO", f"Progress: Step {current}/{total} ({percent}%) - {step_name}", name=name)
