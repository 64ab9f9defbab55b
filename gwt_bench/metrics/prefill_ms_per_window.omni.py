"""The LM prefill's device time a window: the stream time of the
program's ``gwt.prefill`` spans (CUDA events at entry and exit) over the
rows they ran."""

from gwt_bench import spans


def read(run):
    ms = spans.device_ms(run, "gwt.prefill")
    rows = spans.count(run, "gwt.prefill", "rows")
    if ms is None or not rows:
        return None
    return ms / rows
