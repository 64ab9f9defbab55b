"""The share of token-layers in the token loop whose top-p set holds the
null expert, in percent: the ``null_picks`` counts of the traced window's
``gwt.token_loop`` spans over their ``token_layers``.  A program whose
spans carry no such counts gives None."""

from gwt_bench import spans


def read(run):
    n = spans.count(run, "gwt.token_loop", "token_layers")
    if not n:
        return None
    return 100.0 * spans.count(run, "gwt.token_loop", "null_picks") / n
