"""The device trace of a traced run, and its reduction to numbers.

``profiler()`` is ``torch.profiler`` (CPU and CUDA activities) for the
traced window.  ``events()`` reads the raw Kineto events (no tree of
function events is built: a window holds millions of them) into plain
tuples, and the rest works on those tuples only, so it is tested on the
CPU with events made by hand:

- ``busy_s``: the union of kernel, memcpy and memset intervals;
- ``idle_share``: the traced window's idle share, the reader of the
  ``idle_share.*`` metrics;
- ``kernel_s``: the device time of the kernels whose names match;
- ``launches``: the launch API calls (runtime and driver, graphs too);
- ``top_device_ops``: device time by operation name, longest first;
- ``idle_gaps``: the gaps between device intervals, each named by the
  innermost host operation (runtime calls included) of the busiest host
  thread that encloses its middle, summed by name, longest first.
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, \
    Tuple

DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_KINDS = {"cpu_op", "user_annotation", "python_function",
              "cuda_runtime", "cuda_driver"}
LAUNCH_KINDS = {"cuda_runtime", "cuda_driver"}
LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel|"
                    r"cuLaunchKernelEx|cudaGraphLaunch|cuGraphLaunch)"
                    r"(_v\d+)?$")

Span = Tuple[str, int, int]          # name, start ns, end ns


class Trace(NamedTuple):
    device: List[Tuple[str, str, int, int]]    # kind, name, start, end
    host: List[Span]                           # busiest host thread
    launches: int


def profiler():
    """``torch.profiler`` with CPU and (where there is a card) CUDA
    activities, to run around the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _kind(e) -> str:
    """Kineto's activity type of an event; older builds have no
    ``activity_type``, so it is worked out from the device and the name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if getattr(e, "is_user_annotation", lambda: False)():
        return "user_annotation"
    name = e.name()
    if e.device_type().name == "CUDA":
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "cuda_sync" if "Sync" in name else "kernel"
    if name.startswith("cuda") or re.match(r"cu[A-Z]", name):
        return "cuda_runtime"
    return "cpu_op"


def events(prof) -> Trace:
    """The profiler's raw events as plain tuples."""
    device, host, launches = [], collections.defaultdict(list), 0
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            s = e.start_ns()
            device.append((kind, e.name(), s, s + e.duration_ns()))
        elif kind in HOST_KINDS:
            s, name = e.start_ns(), e.name()
            host[e.start_thread_id()].append((name, s, s + e.duration_ns()))
            if kind in LAUNCH_KINDS and LAUNCH.match(name):
                launches += 1
    main = max(host.values(), key=len) if host else []
    return Trace(device=device, host=main, launches=launches)


# -------------------------------------------------------------- reductions
def merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in merged((s, e) for _, _, s, e in
                                        trace.device)) * 1e-9


def idle_share(run) -> Optional[float]:
    """The device's idle share of the traced window, in percent: one minus
    the union of kernel, memcpy and memset intervals over the window's
    length.  The profiler slows the host, so in a host-paced cell this
    reads higher than a window without it would."""
    if run.trace is None or not run.trace.device or not run.trace_window_s:
        return None
    return 100.0 * (1.0 - busy_s(run.trace) / run.trace_window_s)


def kernel_s(trace: Trace, patterns: Sequence[str]) -> Optional[float]:
    """Device seconds of the kernels matching any pattern; None if none
    ran."""
    rx = [re.compile(p) for p in patterns]
    hits = [e - s for kind, name, s, e in trace.device
            if kind == "kernel" and any(r.search(name) for r in rx)]
    return sum(hits) * 1e-9 if hits else None


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:width]


def top_device_ops(trace: Trace, n: int = 10) -> List[List]:
    tot: Dict[str, int] = collections.Counter()
    for _, name, s, e in trace.device:
        tot[short_name(name)] += e - s
    return [[k, v * 1e-9] for k, v in tot.most_common(n)]


def idle_gaps(trace: Trace, n: int = 10) -> List[List]:
    """Idle time between device intervals, summed by the host operation
    that encloses each gap's middle ("python" where none does)."""
    busy = merged((s, e) for _, _, s, e in trace.device)
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    host = sorted(trace.host, key=lambda h: (h[1], -h[2]))
    starts = [h[1] for h in host]
    tot: Dict[str, int] = collections.Counter()
    stack: List[Span] = []
    i = 0
    for g0, g1 in gaps:                      # gaps come in time order
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(starts, mid)
        while i < j:
            h = host[i]
            while stack and stack[-1][2] <= h[1]:
                stack.pop()
            stack.append(h)
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        tot[stack[-1][0] if stack else "python"] += g1 - g0
    return [[k, v * 1e-9] for k, v in tot.most_common(n)]
