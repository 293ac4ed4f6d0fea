"""Logging (the part of ``spartan_tpu/utils/log.py`` the checkpointed
loop and the plan guards use): ``log_debug``, ``log_info`` and
``log_warn`` on the ``spartan_tpu_torch`` logger. The package attaches
no handler and sets no level: the application's logging configuration
decides what is shown."""

from __future__ import annotations

import logging
from typing import Any

_logger = logging.getLogger("spartan_tpu_torch")
_logger.addHandler(logging.NullHandler())


def log_debug(msg: str, *args: Any) -> None:
    _logger.debug(msg, *args)


def log_info(msg: str, *args: Any) -> None:
    _logger.info(msg, *args)


def log_warn(msg: str, *args: Any) -> None:
    _logger.warning(msg, *args)
