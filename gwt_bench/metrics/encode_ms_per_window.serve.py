"""The encoder's device time a window: the stream time of the program's
``gwt.encode`` spans (the mel windows and ``encoder_forward``, CUDA events
at entry and exit) over the rows they encoded."""

from gwt_bench import spans


def read(run):
    ms = spans.device_ms(run, "gwt.encode")
    rows = spans.count(run, "gwt.encode", "rows")
    if ms is None or not rows:
        return None
    return ms / rows
