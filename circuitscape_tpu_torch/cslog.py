"""Logging subsystem: console + optional file sink + UI callback.

Parity reference: src/logging.jl:1-61.  Every record is timestamped;
`suppress_messages` gates INFO to the console but never WARN; the
`ui_interface` callback receives every formatted message so embedders
(Omniscape-style moving-window callers, GUIs) can surface progress.
"""

from __future__ import annotations

import logging
import sys
from datetime import datetime

# Embedding hook (src/logging.jl:1): callable (message, level_symbol) -> None
ui_interface = [lambda msg, level: None]

LOGGER_NAME = "circuitscape_tpu_torch"
logger = logging.getLogger(LOGGER_NAME)
logger.propagate = False


class _CSFormatter(logging.Formatter):
    def format(self, record):
        ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        return f"{ts} : {record.getMessage()}"


class _CSConsoleHandler(logging.StreamHandler):
    """Console handler honoring suppress_messages (warnings always pass)."""

    def __init__(self, suppress_messages=False):
        super().__init__(sys.stderr)
        self.suppress_messages = suppress_messages
        self.setFormatter(_CSFormatter())

    def emit(self, record):
        if self.suppress_messages and record.levelno < logging.WARNING:
            return
        super().emit(record)


class _UIHandler(logging.Handler):
    def emit(self, record):
        ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        msg = f"{ts} : {record.getMessage()}"
        level = "warn" if record.levelno >= logging.WARNING else "info"
        try:
            ui_interface[0](msg, level)
        except Exception:
            pass


def update_logging(cfg) -> None:
    """Install handlers per config (src/logging.jl:43-60)."""
    for h in list(logger.handlers):
        logger.removeHandler(h)
        try:
            h.close()
        except Exception:
            pass
    logger.setLevel(cfg.log_level)
    logger.addHandler(_UIHandler())
    logger.addHandler(_CSConsoleHandler(cfg.suppress_messages))
    if cfg.log_file:
        fh = logging.FileHandler(cfg.log_file, mode="w")
        fh.setFormatter(_CSFormatter())
        logger.addHandler(fh)
        logger.info("Logs will recorded to file: %s", cfg.log_file)


def info(msg, *args):
    logger.info(msg, *args)


def warn(msg, *args):
    logger.warning(msg, *args)


def debug(msg, *args):
    logger.debug(msg, *args)
