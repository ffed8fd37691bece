"""Shared horizontal substrate of the port (counterpart of
``tpu_resiliency/utils``)."""

from .logging import LogConfig, get_logger, setup_logger
from .profiling import ProfilingEvent, ProfilingRecorder, record_event

__all__ = [
    "LogConfig",
    "setup_logger",
    "get_logger",
    "ProfilingEvent",
    "ProfilingRecorder",
    "record_event",
]
