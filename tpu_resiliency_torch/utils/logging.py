"""Structured, rank-aware logging.

The port's copy of ``tpu_resiliency/utils/logging.py``: env-driven levels,
rank / node prefixes, an optional node-local file sink.  Both packages log
under the one ``"tpurx"`` logger hierarchy, so a process that imports both
configures it once.  The rank comes from the launcher env (``TPURX_RANK``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import sys
from typing import Optional

from . import env

_ROOT_NAME = "tpurx"

# Env knobs (reference analog: NVRX_LOG_DEBUG etc.) — declared in utils/env.py
ENV_LOG_LEVEL = env.LOG_LEVEL.name
ENV_LOG_FILE = env.LOG_FILE.name
ENV_RANK = env.RANK.name
ENV_INFRA_RANK = env.INFRA_RANK.name


@dataclasses.dataclass
class LogConfig:
    """Logging configuration.

    Attributes:
        level: log level name ("DEBUG", "INFO", ...). Env ``TPURX_LOG_LEVEL``
            overrides.
        to_file: optional path for a per-process log file; ``%r`` expands to
            the rank, ``%h`` to the hostname.  Env ``TPURX_LOG_FILE``.
        rank: explicit rank for the prefix; defaults to env / unknown.
        stream: stream for the console handler.
    """

    level: str = "INFO"
    to_file: Optional[str] = None
    rank: Optional[int] = None
    stream: object = None

    @classmethod
    def from_env(cls) -> "LogConfig":
        return cls(
            level=env.LOG_LEVEL.get(),
            to_file=env.LOG_FILE.get(),
        )


def _resolve_rank(explicit: Optional[int] = None) -> str:
    if explicit is not None:
        return str(explicit)
    for knob in (env.RANK, env.GROUP_RANK, env.INFRA_RANK):
        val = knob.raw()
        if val is not None:
            return val
    return "?"


class _RankFilter(logging.Filter):
    """Injects rank/host fields into every record (cheap, lazy)."""

    def __init__(self, rank: Optional[int] = None):
        super().__init__()
        self._rank = rank
        self._host = socket.gethostname()

    def filter(self, record: logging.LogRecord) -> bool:
        record.rank = _resolve_rank(self._rank)
        record.host = self._host
        return True


_FORMAT = "[%(asctime)s] [%(levelname)s] [%(host)s:r%(rank)s] [%(name)s] %(message)s"


class _TemplateFileHandler(logging.FileHandler):
    """File handler whose ``%r``/``%h`` placeholders expand lazily.

    ``setup_logger`` routinely runs at import time (``get_logger`` at module
    scope), *before* the launcher exports ``TPURX_RANK`` into the worker —
    eager expansion bakes ``"?"`` into the path for the life of the process.
    Expansion therefore happens per record: the first emit resolves the
    template, and a later rank change (env set between setup and first log,
    or a re-rank across restart cycles) closes the old stream and reopens at
    the new path.
    """

    def __init__(self, template: str, rank: Optional[int] = None):
        self._template = template
        self._explicit_rank = rank
        # delay=True: no stream (and no directory) is created until a record
        # actually arrives — by which time the rank env is usually set
        super().__init__(self._expand(), delay=True)

    def _expand(self) -> str:
        return os.path.abspath(
            self._template.replace("%r", _resolve_rank(self._explicit_rank))
            .replace("%h", socket.gethostname())
        )

    def emit(self, record: logging.LogRecord) -> None:
        # runs under the handler lock (Handler.handle); swap the stream
        # directly — Handler.close() would also deregister us from logging's
        # shutdown flush list
        path = self._expand()
        if path != self.baseFilename:
            stream, self.stream = self.stream, None
            if stream is not None:
                stream.flush()
                stream.close()
            self.baseFilename = path
        if self.stream is None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        super().emit(record)


def setup_logger(
    config: Optional[LogConfig] = None, force: bool = False
) -> logging.Logger:
    """Configure and return the root ``tpurx`` logger.  Idempotent unless
    ``force=True`` (which drops existing handlers and reconfigures)."""
    cfg = config or LogConfig.from_env()
    logger = logging.getLogger(_ROOT_NAME)
    level = getattr(logging, env.LOG_LEVEL.get(default=cfg.level).upper(), logging.INFO)
    logger.setLevel(level)
    if getattr(logger, "_tpurx_configured", False):
        if not force:
            return logger
        for handler in list(logger.handlers):
            logger.removeHandler(handler)
            handler.close()

    logger.propagate = False
    rank_filter = _RankFilter(cfg.rank)
    formatter = logging.Formatter(_FORMAT)

    console = logging.StreamHandler(cfg.stream or sys.stderr)
    console.setFormatter(formatter)
    console.addFilter(rank_filter)
    logger.addHandler(console)

    to_file = env.LOG_FILE.get(default=cfg.to_file)
    if to_file:
        fh = _TemplateFileHandler(to_file, cfg.rank)
        fh.setFormatter(formatter)
        fh.addFilter(rank_filter)
        logger.addHandler(fh)

    logger._tpurx_configured = True  # type: ignore[attr-defined]
    return logger


def get_logger(name: str = "") -> logging.Logger:
    """Child logger under the ``tpurx`` hierarchy; configures root on first use."""
    setup_logger()
    return logging.getLogger(f"{_ROOT_NAME}.{name}" if name else _ROOT_NAME)
