"""Verbosity-gated logging (reference: solr/Logging.h — LOG_INFO(level,
msg) / LOG_WARNING / LOG_ERROR stream macros gated by a global level).

Python's stdlib logging is the idiomatic host-side analog; this module
pins one namespaced logger with the reference's three severities plus
the numeric info-verbosity gate its LOG_INFO(level, ...) macro had.
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER = logging.getLogger("solstice")
_INFO_VERBOSITY = int(os.environ.get("SOLR_LOG_LEVEL", "1"))

if not _LOGGER.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("[solstice %(levelname).1s %(asctime)s] %(message)s",
                          datefmt="%H:%M:%S")
    )
    _LOGGER.addHandler(handler)
    _LOGGER.setLevel(logging.INFO)
    _LOGGER.propagate = False


def get_logger() -> logging.Logger:
    return _LOGGER


def set_verbosity(level: int) -> None:
    """Info messages with ``level`` above this are dropped (reference:
    the compile-time verbosity gate on LOG_INFO)."""
    global _INFO_VERBOSITY
    _INFO_VERBOSITY = int(level)


def log_info(level: int, msg: str, *args) -> None:
    if level <= _INFO_VERBOSITY:
        _LOGGER.info(msg, *args)


def log_warning(msg: str, *args) -> None:
    _LOGGER.warning(msg, *args)


def log_error(msg: str, *args) -> None:
    _LOGGER.error(msg, *args)
