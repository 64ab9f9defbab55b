"""The encoder attention's backward a training step: the stream time of
the program's ``gwt.attn_recompute`` spans (K2's plain function recomputed
and differentiated, on the autograd thread) over the traced window's
steps."""

from gwt_bench import spans


def read(run):
    ms = spans.device_ms(run, "gwt.attn_recompute")
    steps = run.trace_facts.get("units")
    if ms is None or not steps:
        return None
    return ms / steps
