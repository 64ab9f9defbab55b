"""Leveled logging with a pluggable callback, port of the JAX package's
``runtime/logging.py``: ``whisper_log_set`` + ``whisper_log_internal`` of
the reference, and ``system_info`` (whisper_print_system_info)."""

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


def log_error(fmt: str, *args) -> None:
    log(LogLevel.ERROR, fmt, *args)


def log_warn(fmt: str, *args) -> None:
    log(LogLevel.WARN, fmt, *args)


def log_info(fmt: str, *args) -> None:
    log(LogLevel.INFO, fmt, *args)


def log_debug(fmt: str, *args) -> None:
    log(LogLevel.DEBUG, fmt, *args)


def system_info() -> str:
    """Capability string (whisper_print_system_info,
    whisper.cpp:3850-3873): torch, CUDA and the cards."""
    import torch

    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        devices = f"{n}x {torch.cuda.get_device_name(0)}"
    else:
        devices = "none"
    return (f"godot_whisper_tpu_torch: torch = {torch.__version__} | "
            f"cuda = {torch.version.cuda} | devices = {devices} | "
            f"backend = CUDA kernels (csrc/)")
