"""Structured tracing — chrome://tracing (Perfetto) span export.

The reference has only accumulated wall-clock buckets
(whisper_state timers, whisper.cpp:770-783) and "no structured tracing"
(SURVEY.md §5).  This module records named spans and emits the Chrome
Trace Event JSON format, loadable in Perfetto / chrome://tracing.

Enable via ``GWT_TRACE=/path/trace.json`` (dumped at process exit) or
programmatically::

    from godot_whisper_tpu_torch.runtime.trace import tracer
    with tracer.span("encode", window=3):
        ...
    tracer.dump("trace.json")

For device-side profiling, ``torch.profiler`` remains available;
this tracer covers the host-side pipeline structure (mel/encode/decode/
emit per window) with negligible overhead.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Tracer:
    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self.enabled = bool(os.environ.get("GWT_TRACE"))
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        if self.enabled:
            atexit.register(self._atexit_dump)

    def enable(self) -> None:
        self.enabled = True

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, **args):
        if not self.enabled:
            yield
            return
        start = self._now_us()
        try:
            yield
        finally:
            end = self._now_us()
            with self._lock:
                self.events.append({
                    "name": name, "ph": "X", "ts": start,
                    "dur": end - start, "pid": os.getpid(),
                    "tid": threading.get_ident() % 100000,
                    "args": args or {},
                })

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.events.append({
                "name": name, "ph": "i", "ts": self._now_us(), "s": "t",
                "pid": os.getpid(),
                "tid": threading.get_ident() % 100000, "args": args or {},
            })

    def dump(self, path: str) -> None:
        with self._lock:
            data = {"traceEvents": list(self.events),
                    "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(data, f)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()

    def _atexit_dump(self) -> None:
        path = os.environ.get("GWT_TRACE")
        if path and self.events:
            try:
                self.dump(path)
            except OSError:
                pass


tracer = Tracer()
