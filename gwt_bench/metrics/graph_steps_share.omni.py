"""The share of the LM token loop's steps that replayed the captured
``lm_step`` (``decode/omni.py``'s ``graph_steps`` over ``steps`` on
``gwt.token_loop``): ``graph_steps_share.serve``'s reader, loaded from its
file so that the two read alike."""

from pathlib import Path

from gwt_bench import specs

read = specs.reader({"name": "graph_steps_share.serve", "_reader": str(
    Path(__file__).with_name("graph_steps_share.serve.py"))})
