"""The share of the token loop's steps that replayed the program's
captured decoder step: the ``graph_steps`` counts of the traced window's
``gwt.token_loop`` spans over their ``steps``, in percent.  A program
whose spans carry no ``graph_steps`` count (one without the graph) gives
None."""

from gwt_bench import spans


def read(run):
    recs = spans.records(run, "gwt.token_loop")
    steps = sum(int(r.counts.get("steps", 0)) for r in recs)
    if not steps or not any("graph_steps" in r.counts for r in recs):
        return None
    return 100.0 * sum(int(r.counts.get("graph_steps", 0))
                       for r in recs) / steps
