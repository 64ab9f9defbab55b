"""The token loop's share of its roofline: the least time its decode
steps need (``work_unimoe.decode_steps``: every LM weight but the routed
experts once a step, the routed experts that some row chose, the live K/V
slots; from each ``gwt.token_loop`` span's ``steps``, ``experts_hit``,
``routed_pairs`` and ``token_layers``) over the device's busy time inside
the traced window's ``gwt.token_loop`` ranges, in percent.  A program
whose spans carry no routing counts gives None."""

from gwt_bench import spans, work, work_unimoe


def read(run):
    busy = spans.inside(run, "gwt.token_loop")
    recs = [r for r in spans.records(run, "gwt.token_loop")
            if "experts_hit" in r.counts]
    if busy is None or not busy[0] or not recs:
        return None
    layers = int(run.cfg["num_hidden_layers"])
    prompt = run.trace_facts["prompt"]
    bound = 0.0
    for r in recs:
        fw = int(r.counts["steps"]) - 1
        if fw <= 0:
            continue
        rows = int(r.counts["token_layers"]) // (layers * fw)
        w = work_unimoe.decode_steps(run.cfg, rows, prompt, fw,
                                     int(r.counts["experts_hit"]),
                                     int(r.counts["routed_pairs"]))
        bound += work.bound_s(w["ops"], w["bytes"], run.cfg["compute_dtype"])
    return 100.0 * bound / (busy[0] * 1e-9)
