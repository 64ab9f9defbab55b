"""AdamW a training step: the stream time of the program's
``gwt.train.optimizer`` spans (``opt.update`` and ``apply_updates``) over
the traced window's steps."""

from gwt_bench import spans


def read(run):
    ms = spans.device_ms(run, "gwt.train.optimizer")
    steps = run.trace_facts.get("units")
    if ms is None or not steps:
        return None
    return ms / steps
