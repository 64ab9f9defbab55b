"""The encoder's device time a window in the Uni-MoE cell, whose context
(``decode/omni.py``) runs the shared ``encoder_forward`` under the same
``gwt.encode`` span: ``encode_ms_per_window.serve``'s reader, loaded from
its file so that the two read alike."""

from pathlib import Path

from gwt_bench import specs

read = specs.reader({"name": "encode_ms_per_window.serve", "_reader": str(
    Path(__file__).with_name("encode_ms_per_window.serve.py"))})
