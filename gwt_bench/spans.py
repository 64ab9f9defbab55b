"""The program's own spans in a traced run, for the per-layer readers.

The port's tracer (``godot_whisper_tpu_torch.runtime.trace.tracer``)
records a span for each layer it crosses while the profiler records, and
opens a profiler range of the same name, which ``devtrace.events`` keeps
in ``Trace.host``.  The readers run in the process that ran the traced
window, so they read the tracer's records directly:

- ``window``: the traced window's clock range (Unix-epoch ns), from the
  profiler's host and device events;
- ``records``: the tracer's records of one name that start inside it;
- ``device_ms`` / ``count``: sums over those records of their device time
  (CUDA events around the span) and of one of their counts;
- ``inside``: the device's busy and idle ns within the union of one name's
  profiler ranges.

A program without these spans gives no records and no ranges; every
function here then returns an empty list, 0 or None, and never raises.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .devtrace import merged


def window(run) -> Optional[Tuple[int, int]]:
    """First start to last end of the trace's host and device events (the
    host events are one thread's, the busiest: in training the autograd
    thread, which ends before the last step's AdamW)."""
    if run.trace is None:
        return None
    ends = [(s, e) for _, s, e in run.trace.host] + [
        (s, e) for _, _, s, e in run.trace.device]
    if not ends:
        return None
    return min(s for s, _ in ends), max(e for _, e in ends)


def _all_records() -> list:
    try:
        from godot_whisper_tpu_torch.runtime.trace import tracer
    except ImportError:
        return []
    read = getattr(tracer, "records", None)
    return list(read()) if callable(read) else []


def records(run, name: str) -> list:
    w = window(run)
    if w is None:
        return []
    return [r for r in _all_records()
            if r.name == name and w[0] <= r.start_ns <= w[1]]


def device_ms(run, name: str) -> Optional[float]:
    """Summed device ms of ``name``'s records; None where none has one."""
    ms = [r.device_ms for r in records(run, name) if r.device_ms is not None]
    return sum(ms) if ms else None


def count(run, name: str, key: str) -> int:
    return sum(int(r.counts.get(key, 0)) for r in records(run, name))


def intersection_ns(a: List[Tuple[int, int]],
                    b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two merged, sorted interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def inside(run, name: str) -> Optional[Tuple[int, int]]:
    """(busy ns, idle ns) of the device within the union of ``name``'s
    ranges on the traced host thread; None where there is no such range
    or no device interval."""
    if run.trace is None or not run.trace.device:
        return None
    spans = merged((s, e) for n, s, e in run.trace.host if n == name)
    if not spans:
        return None
    busy = intersection_ns(spans, merged((s, e) for _, _, s, e in
                                         run.trace.device))
    return busy, sum(e - s for s, e in spans) - busy
