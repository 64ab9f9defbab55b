"""The port's tracer: named spans at the layer boundaries of serving and
training, on the clock of ``torch.profiler``'s device trace.

The reference has only accumulated wall-clock buckets (whisper_state
timers, whisper.cpp:770-783) and "no structured tracing" (SURVEY.md §5).
This module records spans and writes them as Chrome Trace Event JSON
(Perfetto, chrome://tracing)::

    from godot_whisper_tpu_torch.runtime.trace import tracer
    with tracer.span("gwt.encode", device=x.device, rows=8):
        ...
    tracer.dump("trace.json")

When it is on.  The tracer records while ``GWT_TRACE`` is set
(``GWT_TRACE=/path/trace.json`` is written at process exit), after
``tracer.enable()``, and while a ``torch.profiler`` records.  Otherwise
``span()`` costs one flag test and one question to the profiler, and
returns a shared no-op object: it opens no range and records nothing.

A record holds the span's name, its id, the id of the span that encloses
it on the same thread (``parent``), the thread, its start and end in
Unix-epoch nanoseconds (``time.time_ns``, the clock that Kineto's
``start_ns`` gives), and its counts (keyword arguments of ``span`` or of
``Span.set``).  While a profiler records, a span also opens a
``torch.profiler.record_function`` range of its name, so the device trace
shows it as a ``user_annotation`` and the device's idle gaps can be named
by it.

``device=`` a CUDA device: the span records a CUDA event on that device's
current stream at entry and another at exit; ``device_ms`` is the stream
time between the two, which holds the span's device work and any time the
stream waited for the host inside it.  The pairs are resolved by
``records()`` (one synchronize a device) and never on the hot path;
``device_ms`` stays None for a span without events.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled
_RESOLVE_EVERY = 1024      # pending event pairs between non-blocking sweeps


class _Off:
    """The shared span of a tracer that is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **counts) -> None:
        pass


OFF = _Off()


class Span:
    """One span; kept as the tracer's record once closed."""
    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns",
                 "counts", "device_ms", "_tracer", "_range", "_events",
                 "_stream")

    def __init__(self, tracer: "Tracer", name: str, device,
                 counts: Dict[str, Any]):
        self.name, self.counts, self._tracer = name, counts, tracer
        self.id = next(tracer._ids)
        self.parent = None
        self.thread = threading.get_native_id()
        self.start_ns = self.end_ns = 0
        self.device_ms: Optional[float] = None
        self._range = self._events = self._stream = None
        if getattr(device, "type", None) == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def set(self, **counts) -> None:
        """Counts known only inside the span."""
        self.counts.update(counts)

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self._events is not None:
            self._events[0].record(self._stream)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record(self._stream)
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._tracer._stack().pop()
        self._tracer._add(self)
        return False


class Tracer:
    def __init__(self):
        self.enabled = bool(os.environ.get("GWT_TRACE"))
        self._records: List[Span] = []
        self._pending: List[Span] = []    # closed, events not resolved
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        if self.enabled:
            atexit.register(self._atexit_dump)

    def enable(self) -> None:
        self.enabled = True

    def span(self, name: str, device=None, **counts):
        """A context manager for one span: the shared no-op object while
        the tracer is off and no profiler records."""
        if not self.enabled and not _profiling():
            return OFF
        return Span(self, name, device, counts)

    def _stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add(self, sp: Span) -> None:
        with self._lock:
            self._records.append(sp)
            if sp._events is not None:
                self._pending.append(sp)
                if len(self._pending) % _RESOLVE_EVERY == 0:
                    self._pending = [p for p in self._pending
                                     if not self._resolve(p, wait=False)]

    @staticmethod
    def _resolve(sp: Span, wait: bool) -> bool:
        if not wait and not sp._events[1].query():
            return False
        sp.device_ms = sp._events[0].elapsed_time(sp._events[1])
        sp._events = sp._stream = None
        return True

    def records(self) -> List[Span]:
        """Every closed span, oldest first, their device times resolved."""
        with self._lock:
            pending, self._pending = self._pending, []
            out = list(self._records)
        for dev in {sp._stream.device for sp in pending}:
            torch.cuda.synchronize(dev)
        for sp in pending:
            self._resolve(sp, wait=True)
        return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._pending.clear()

    def dump(self, path: str) -> None:
        """Chrome Trace Event JSON: ``ts`` and ``dur`` in microseconds since
        the Unix epoch, as the profiler's own export; the counts, the ids
        and ``device_ms`` in ``args``."""
        pid = os.getpid()
        events = []
        for sp in self.records():
            args = dict(sp.counts, id=sp.id, parent=sp.parent)
            if sp.device_ms is not None:
                args["device_ms"] = sp.device_ms
            events.append({"name": sp.name, "ph": "X",
                           "ts": sp.start_ns / 1e3,
                           "dur": (sp.end_ns - sp.start_ns) / 1e3,
                           "pid": pid, "tid": sp.thread, "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)

    def _atexit_dump(self) -> None:
        path = os.environ.get("GWT_TRACE")
        if path and self._records:
            try:
                self.dump(path)
            except OSError:
                pass


tracer = Tracer()
