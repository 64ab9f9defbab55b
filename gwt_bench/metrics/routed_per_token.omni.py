"""Routed experts run a token and layer in the token loop, the dynamic
capacity in action (0 to 2): the ``routed_pairs`` counts of the traced
window's ``gwt.token_loop`` spans over their ``token_layers``.  A program
whose spans carry no such counts gives None."""

from gwt_bench import spans


def read(run):
    n = spans.count(run, "gwt.token_loop", "token_layers")
    if not n:
        return None
    return spans.count(run, "gwt.token_loop", "routed_pairs") / n
