"""Device busy time inside the token loop a decode step: the busy ns
within the union of the program's ``gwt.token_loop`` ranges in the
profiler's trace (kernels, copies and sets) over the steps those spans
count."""

from gwt_bench import spans


def read(run):
    got = spans.inside(run, "gwt.token_loop")
    steps = spans.count(run, "gwt.token_loop", "steps")
    if got is None or not steps:
        return None
    return got[0] * 1e-6 / steps
