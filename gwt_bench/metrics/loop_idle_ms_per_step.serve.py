"""Device idle time inside the token loop a decode step: the idle ns
within the union of the program's ``gwt.token_loop`` ranges in the
profiler's trace over the steps those spans count.  The loop synchronises
every step, so its range holds its own device work, and its idle time is
the host's share of a step."""

from gwt_bench import spans


def read(run):
    got = spans.inside(run, "gwt.token_loop")
    steps = spans.count(run, "gwt.token_loop", "steps")
    if got is None or not steps:
        return None
    return got[1] * 1e-6 / steps
