"""Launch API calls in the traced window over its decode steps in the
Uni-MoE cell (the program's ``Timings.n_decode``, as in the Whisper
cells): ``launches_per_step.serve``'s reader, loaded from its file so that
the two read alike."""

from pathlib import Path

from gwt_bench import specs

read = specs.reader({"name": "launches_per_step.serve", "_reader": str(
    Path(__file__).with_name("launches_per_step.serve.py"))})
