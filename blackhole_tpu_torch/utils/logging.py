"""Leveled, structured logging.

PyTorch counterpart of blackhole_tpu.utils.logging (which imports no
JAX; this package keeps its own copy): level filtering on Python's
logging stack and an every-Nth throttle for chatty sites.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_configured = False


def get_logger(name: str = "blackhole_tpu_torch", level: str = "INFO"
               ) -> logging.Logger:
    """A logger under the package's root logger, which writes to stderr
    (configured once per process)."""
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("blackhole_tpu_torch")
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    logger = logging.getLogger(name)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    return logger


class Throttled:
    """Log only every Nth call (calls 1, N + 1, 2N + 1, ...)."""

    def __init__(self, logger: logging.Logger, every: int = 500):
        self.logger = logger
        self.every = every
        self.count = 0

    def log(self, level, msg, *args):
        self.count += 1
        if self.count % self.every == 1:
            self.logger.log(
                level, f"{msg} (call {self.count})", *args
            )
