"""Logging, assertion helpers and timers (port of
``spartan_tpu/utils/log.py``): ``log_debug``, ``log_info``,
``log_warn`` and ``log_error`` on the ``spartan_tpu_torch`` logger,
``divup``, the reference's ``Assert`` test idioms, ``timer_ctx`` and the
accumulating ``Timer`` (both on the host clock). The package attaches no
handler and sets no level: the application's logging configuration
decides what is shown."""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Any, Iterator

import numpy as np

_logger = logging.getLogger("spartan_tpu_torch")
_logger.addHandler(logging.NullHandler())


def log_debug(msg: str, *args: Any) -> None:
    _logger.debug(msg, *args)


def log_info(msg: str, *args: Any) -> None:
    _logger.info(msg, *args)


def log_warn(msg: str, *args: Any) -> None:
    _logger.warning(msg, *args)


def log_error(msg: str, *args: Any) -> None:
    _logger.error(msg, *args)


def divup(a: int, b: int) -> int:
    return (a + b - 1) // b


class Assert:
    """Assertion helpers mirroring the reference's test idioms."""

    @staticmethod
    def all_eq(a: Any, b: Any, tol: float = 0.0) -> None:
        a = np.asarray(a)
        b = np.asarray(b)
        if a.shape != b.shape:
            raise AssertionError(f"shape mismatch: {a.shape} vs {b.shape}")
        if tol > 0:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(a, b)

    @staticmethod
    def all_close(a: Any, b: Any, rtol: float = 1e-5,
                  atol: float = 1e-6) -> None:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=rtol, atol=atol)

    @staticmethod
    def eq(a: Any, b: Any) -> None:
        if not a == b:
            raise AssertionError(f"{a!r} != {b!r}")

    @staticmethod
    def true(cond: Any, msg: str = "") -> None:
        if not cond:
            raise AssertionError(msg or "expected truthy value")

    @staticmethod
    def isinstance_(obj: Any, cls: type) -> None:
        if not isinstance(obj, cls):
            raise AssertionError(f"{obj!r} is not a {cls.__name__}")


@contextmanager
def timer_ctx(name: str = "span") -> Iterator[None]:
    """Log the wall time of the block (host clock) at info level."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log_info("%s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)


class Timer:
    """Accumulating host-clock timer for benchmark harnesses."""

    def __init__(self) -> None:
        self.elapsed = 0.0
        self.count = 0

    @contextmanager
    def measure(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.elapsed += time.perf_counter() - t0
            self.count += 1

    @property
    def mean(self) -> float:
        return self.elapsed / max(self.count, 1)
