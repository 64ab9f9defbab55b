"""The grouped-query decode attention kernel's (K14) share of its
roofline: the least time the token loop's attention needs
(``work_unimoe.gqa_attention``: every live K/V slot read once a layer a
step, bytes-bound) over the device time of the kernels the metric file
names, in percent.  The steps and rows come from the traced window's
``gwt.token_loop`` spans; a program without K14 gives None."""

from gwt_bench import devtrace, spans, work, work_unimoe


def read(run):
    if run.trace is None:
        return None
    t = devtrace.kernel_s(run.trace, run.metric["kernels"])
    recs = [r for r in spans.records(run, "gwt.token_loop")
            if "token_layers" in r.counts]
    if not t or not recs:
        return None
    layers = int(run.cfg["num_hidden_layers"])
    prompt = run.trace_facts["prompt"]
    ops = n_bytes = 0.0
    for r in recs:
        fw = int(r.counts["steps"]) - 1
        if fw <= 0:
            continue
        rows = int(r.counts["token_layers"]) // (layers * fw)
        w = work_unimoe.gqa_attention(run.cfg, rows, prompt, fw)
        ops += w["ops"]
        n_bytes += w["bytes"]
    return 100.0 * work.bound_s(ops, n_bytes, run.cfg["compute_dtype"]) / t
