"""Uniform logging + warning routing for the whole stack.

Every subsystem used to define its own ``UserWarning`` subclass and call
``warnings.warn`` directly, so there was no single switch that surfaced
them all.  This module provides:

* :class:`MatchWarning` — the common base every repo warning derives
  from (``ScheduleCacheWarning``, ``CalibrationProfileWarning``,
  ``UnsetFrequencyWarning``, ``CalibrationDriftWarning``), so one
  ``warnings.filterwarnings`` / ``pytest.warns`` clause covers the lot;
* :func:`get_logger` — the shared ``"repro_torch"`` logger hierarchy, with its
  level driven by the ``MATCH_LOG`` environment variable (``debug``,
  ``info``, ``warning``, ...); when ``MATCH_LOG`` is set a stderr
  handler is attached once so the messages actually appear;
* :func:`warn` — drop-in for ``warnings.warn`` that *also* echoes the
  message through the logger, so ``MATCH_LOG=debug`` surfaces every
  cache fallback / calibration drift / unset-clock event uniformly, in
  order, with timestamps.

This module must stay stdlib-only: ``repro_torch.core`` and ``repro_torch.backend``
import it at module load, and ``repro_torch.obs`` importing them back would be
a cycle.
"""

from __future__ import annotations

import logging
import os
import sys
import warnings

__all__ = ["LOG_ENV", "MatchWarning", "get_logger", "log_level", "warn"]

LOG_ENV = "MATCH_LOG"


class MatchWarning(UserWarning):
    """Common base of every warning this repo emits (schedule-cache
    fallbacks, calibration-profile fallbacks, unset module clocks,
    calibration drift).  Filter or promote them all with one clause:
    ``warnings.filterwarnings("error", category=MatchWarning)``."""


_ROOT = "repro_torch"
_configured = False


def log_level(default: int = logging.WARNING) -> int:
    """The level ``MATCH_LOG`` selects (name or number), else ``default``."""
    raw = os.environ.get(LOG_ENV, "").strip()
    if not raw:
        return default
    if raw.isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    return level if isinstance(level, int) else default


def _configure() -> None:
    """Attach one stderr handler when MATCH_LOG asks for output.

    Runs once per process, lazily (first ``get_logger`` call), so merely
    importing the library never touches logging config.  Without
    ``MATCH_LOG`` the logger stays handler-less and propagates to the
    root logger — standard library behavior, nothing forced on embedders.
    """
    global _configured
    if _configured:
        return
    _configured = True
    logger = logging.getLogger(_ROOT)
    logger.setLevel(log_level(logging.NOTSET))
    if os.environ.get(LOG_ENV, "").strip() and not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        )
        logger.addHandler(h)
        logger.propagate = False
    else:
        # library etiquette: a NullHandler keeps logging.lastResort from
        # spraying our warning echoes to stderr when the embedding app
        # configured no logging; records still propagate to app handlers
        logger.addHandler(logging.NullHandler())


def get_logger(name: str = "") -> logging.Logger:
    """The shared repo logger (``repro_torch`` or ``repro_torch.<name>``)."""
    _configure()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def warn(
    message: str,
    category: type[Warning] = MatchWarning,
    *,
    stacklevel: int = 2,
    logger: str = "",
) -> None:
    """``warnings.warn`` + a logger echo, so every repo warning is both a
    filterable Python warning AND a ``MATCH_LOG``-surfaced log record.

    ``stacklevel`` counts from the *caller* of this function exactly as
    it would for a direct ``warnings.warn`` call (the extra frame this
    wrapper adds is compensated internally).
    """
    get_logger(logger or "warnings").warning("%s: %s", category.__name__, message)
    warnings.warn(message, category, stacklevel=stacklevel + 1)
