"""Device idle time inside the LM token loop's ``gwt.token_loop`` ranges a
step (``decode/omni.py``): ``loop_idle_ms_per_step.serve``'s reader,
loaded from its file so that the two read alike."""

from pathlib import Path

from gwt_bench import specs

read = specs.reader({"name": "loop_idle_ms_per_step.serve", "_reader": str(
    Path(__file__).with_name("loop_idle_ms_per_step.serve.py"))})
