"""Structured logging with rate limiting.

The port of `lighthouse_tpu/common/logging.py` (the role of common/logging:
slog drains, `TimeLatch` rate limiting): stdlib logging configured for
key=value structured records, plus a TimeLatch for suppressing log storms on
hot paths. The level is an argument; nothing is read from the environment.
"""

import logging
import sys
import time


class KeyValueFormatter(logging.Formatter):
    def format(self, record):
        base = (
            f"{self.formatTime(record, '%H:%M:%S')} "
            f"{record.levelname:5s} {record.name}: {record.getMessage()}"
        )
        extras = getattr(record, "kv", None)
        if extras:
            base += " " + " ".join(f"{k}={v}" for k, v in extras.items())
        return base


def get_logger(name: str = "lighthouse_tpu", level=logging.INFO):
    """Named structured logger at `level` (a `logging` level; INFO by
    default) on its first call for `name`; later calls return it as set."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(KeyValueFormatter())
        logger.addHandler(h)
        logger.setLevel(level)
    return logger


def kv(logger, level, msg, **fields):
    logger.log(level, msg, extra={"kv": fields})


class TimeLatch:
    """At-most-once-per-interval gate for noisy log sites."""

    def __init__(self, interval_s: float = 30.0):
        self.interval = interval_s
        self._last = 0.0

    def elapsed(self) -> bool:
        now = time.monotonic()
        if now - self._last >= self.interval:
            self._last = now
            return True
        return False
