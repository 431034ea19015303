"""Structured logging (the port's copy of ``das4whales_tpu.utils.log``)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "das4whales_tpu_torch",
               level: int | None = None) -> logging.Logger:
    """Package logger with a single stderr handler (idempotent).

    ``level=None`` (the default) sets INFO on first creation and leaves
    an existing logger's level ALONE — so the many internal
    ``get_logger(name)`` call sites can never clobber a level an
    operator configured. An EXPLICIT ``level`` is honored on every call."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO if level is None else level)
        logger.propagate = False
    elif level is not None:
        logger.setLevel(level)
    return logger


def log_metadata(metadata, logger: logging.Logger | None = None) -> None:
    """Log an acquisition-metadata summary (the reference prints this by
    hand in every script prologue, main_mfdetect.py:16-22)."""
    log = logger or get_logger()
    meta = metadata if isinstance(metadata, dict) else getattr(metadata, "__dict__", {})
    fs = meta.get("fs")
    dx = meta.get("dx")
    nx = meta.get("nx")
    ns = meta.get("ns")
    log.info(
        "acquisition: fs=%s Hz, dx=%s m, nx=%s channels, ns=%s samples (%s s, %.1f km)",
        fs, dx, nx, ns,
        None if not (fs and ns) else ns / fs,
        0.0 if not (dx and nx) else nx * dx / 1e3,
    )
