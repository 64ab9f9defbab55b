"""Leveled logging with a pluggable callback (the JAX package's
``runtime/logging.py`` minus ``system_info``): ``whisper_log_set`` +
``whisper_log_internal`` of the reference."""

from __future__ import annotations

import enum
import sys
from typing import Callable, Optional


class LogLevel(enum.IntEnum):
    # mirrors ggml_log_level
    ERROR = 2
    WARN = 3
    INFO = 4
    DEBUG = 5


_callback: Optional[Callable[[LogLevel, str], None]] = None


def default_log_callback(level: LogLevel, text: str) -> None:
    stream = sys.stderr if level <= LogLevel.WARN else sys.stdout
    stream.write(text)


def log_set(callback: Optional[Callable[[LogLevel, str], None]]) -> None:
    """Install a log callback; None restores the default (stderr/stdout)."""
    global _callback
    _callback = callback


def log(level: LogLevel, fmt: str, *args) -> None:
    text = (fmt % args) if args else fmt
    if not text.endswith("\n"):
        text += "\n"
    (_callback or default_log_callback)(level, text)


def log_warn(fmt: str, *args) -> None:
    log(LogLevel.WARN, fmt, *args)
