"""Run one cell of the benchmark once and print its result.

    python3 -m gwt_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell (``workloads/<cell>.json``) and its configuration, makes
the weights and the traffic from the seed, warms up every shape, measures
for ``--seconds``, checks what the window produced against the plain
reference, and prints one JSON line as the last line of standard output
(the numbers compared, each with its limit, also as the last lines of
standard error).  ``setup_built`` in the line says whether set-up built
or compiled anything into the checkout's caches (a checkout's first run):
that run's ``setup_s`` is the compiling one, to be kept apart from warm
set-ups.  ``--trace 1`` follows the window with a second one of
the same length under ``torch.profiler`` and reports the cell's per-layer
metrics instead of its end-to-end ones.

It runs on the card only: without CUDA, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result.  It refuses to print
a result (exit code 3) if JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional, Sequence  # noqa: E402

from . import nojax, specs  # noqa: E402

CACHE = specs.ROOT / ".cache"


def process_age_s() -> float:
    """Seconds since this process started (from /proc where there is one,
    else since this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def use_caches() -> None:
    """Every build and kernel cache in fixed directories of the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    from godot_whisper_tpu_torch.runtime.cache import enable_compilation_cache
    enable_compilation_cache(str(CACHE / "kernels"))


def cache_files() -> set:
    """The files under the checkout's caches, to tell a set-up that built
    something from one that loaded it all."""
    return {p for p in CACHE.rglob("*") if p.is_file()}


class Run:
    """What a per-layer reader sees: the configuration, the cell, its own
    metric file (``metric``), the untraced window's length and counts
    (``window_s``, ``facts``), and the traced segment's (``trace``,
    ``trace_window_s``, ``trace_facts``)."""

    def __init__(self, cfg, spec, window_s, facts, trace=None,
                 trace_window_s=0.0, trace_facts=None):
        self.cfg, self.spec = cfg, spec
        self.window_s, self.facts = window_s, facts
        self.trace, self.trace_window_s = trace, trace_window_s
        self.trace_facts = trace_facts or {}
        self.metric: dict = {}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", roots: Optional[Sequence[Path]] = None,
             setup_clock=process_age_s) -> dict:
    """One run of a cell; returns the result object (not printed)."""
    import torch

    from . import devtrace, entries

    spec = specs.workload(name, roots)
    cfg = specs.config(spec["config"], roots)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        cached = cache_files()
        use_caches()
    entry = entries.load(spec["entry"])(cfg, spec, seed, device)
    entry.setup()
    setup_s = setup_clock()
    built = on_card and cache_files() != cached
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    e2e, facts = entry.window(seconds)
    window_s = facts["window_s"]
    peak = 0
    if on_card:
        facts["window_peak_bytes"] = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, facts["window_peak_bytes"])
    if trace:
        # the profiler slows the host-bound loop several times over, so the
        # traced segment comes after the window and the readers that time
        # the host take the untraced window
        with devtrace.profiler() as prof:
            _, trace_facts = entry.window(seconds)
        trace_window_s = trace_facts["window_s"]   # not the profiler's stop
        tr = devtrace.events(prof)
        del prof
        if on_card:
            peak = max(peak, torch.cuda.max_memory_allocated())
    entry.release()

    metrics = {}
    if trace:
        run = Run(cfg, spec, window_s, facts, tr, trace_window_s,
                  trace_facts)
        for mname, mspec in specs.metrics_of(name, roots).items():
            run.metric = mspec
            value = specs.reader(mspec)(run)
            if value is not None:
                metrics[mname] = {"value": float(value),
                                  "unit": mspec["unit"]}
    else:
        for mname in spec["end_to_end"]:
            if mname == "setup_s":
                metrics[mname] = {"value": float(setup_s), "unit": "s"}
            else:
                metrics[mname] = {"value": float(e2e[mname]),
                                  "unit": entry.E2E[mname]}

    compared = entry.check()
    correct = all(v <= lim for _, v, lim in compared)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(spec["chips"]) if on_card else 0,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(entry.attempted),
           "failed": int(entry.failed), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = devtrace.busy_s(tr)
        dev["window_s"] = trace_window_s
        out["breakdown"] = {"device_ops": devtrace.top_device_ops(tr),
                            "idle_gaps": devtrace.idle_gaps(tr)}
    out["setup_built"] = bool(built)
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, v, lim in compared}
    u = sorted(facts["unit_s"])
    out["_window"] = (f"window {window_s:.3f} s, {len(u)} units of "
                      f"{u[0]:.4f} / {u[len(u) // 2]:.4f} / {u[-1]:.4f} s "
                      f"(min / median / max)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    found = nojax.loaded()
    if found:
        print(f"refusing to run: {', '.join(found)} loaded", file=sys.stderr)
        return 3
    chips = int(specs.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = nojax.loaded()
    if found:
        print(f"no result: {', '.join(found)} loaded after the window",
              file=sys.stderr)
        return 3
    print(out.pop("_window") + f"; the run took {process_age_s():.1f} s; "
          f"set-up built kernels: {out['setup_built']}", file=sys.stderr)
    for k, c in out["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
