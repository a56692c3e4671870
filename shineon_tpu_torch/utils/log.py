"""Console logging (counterpart of shineon_tpu/utils/log.py): one logger
named "logger", coloured levels on a terminal, and a filter that drops a
message already emitted once."""

from __future__ import annotations

import logging
import sys

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[37m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[31;47m",
}
_RESET = "\033[0m"


class ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _COLORS.get(record.levelname, "")
        if color and sys.stderr.isatty():
            return f"{color}{msg}{_RESET}"
        return msg


class DuplicateFilter(logging.Filter):
    """Drops a message whose text was already emitted once."""

    def __init__(self) -> None:
        super().__init__()
        self._seen: set = set()

    def filter(self, record: logging.LogRecord) -> bool:
        fresh = record.msg not in self._seen
        self._seen.add(record.msg)
        return fresh


def setup_custom_logger(name: str = "logger") -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_shineon_configured", False):
        return logger
    handler = logging.StreamHandler()
    handler.setFormatter(ColorFormatter(
        "%(name)s | %(asctime)s | %(levelname)s | %(message)s", datefmt="%Y-%m-%d %H:%M:%S"))
    logger.setLevel(logging.DEBUG)
    logger.addHandler(handler)
    logger.addFilter(DuplicateFilter())
    logger._shineon_configured = True  # type: ignore[attr-defined]
    return logger


def get_logger() -> logging.Logger:
    return setup_custom_logger("logger")
