"""Coloured severity logging with file:line source info.

The port's copy of ``elevenrender_tpu/utils/logging.py`` (the
reference's Boost.Log setup: timestamp, severity, file:line, ANSI colour
per level), under a logger name of its own, ``elevenrender_torch``: with
both packages in one process, each line is printed once, by the package
that logged it.  The name is no parent of the port's module loggers
(``elevenrender_tpu_torch.*``), whose records still reach the root
logger.
"""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[32m",      # green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[41m",  # red background
}
_RESET = "\x1b[0m"

LOGGER_NAME = "elevenrender_torch"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        base = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelno, '')}{base}{_RESET}"
        return base


def get_logger() -> logging.Logger:
    """The port's logger, given its handler on first use."""
    logger = logging.getLogger(LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(_ColorFormatter(
            "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d] "
            "%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
