"""Launch API calls in the traced window (runtime and driver launches,
graph launches too) over the window's decode steps (the program's
``Timings.n_decode``): how many launches the host pays a token."""


def read(run):
    steps = run.trace_facts.get("decode_steps", 0)
    if run.trace is None or not run.trace.launches or not steps:
        return None
    return run.trace.launches / steps
