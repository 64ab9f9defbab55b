"""The encoder self-attention kernel's share of its roofline: the least
time the window's encoder attention needs (``work.encoder_attention``:
Q.K^T and P.V over 1500 positions, a layer and window each) over the
device time of the kernels the metric file names, in percent."""

from gwt_bench import devtrace, work


def read(run):
    if run.trace is None:
        return None
    t = devtrace.kernel_s(run.trace, run.metric["kernels"])
    if not t:
        return None
    w = work.encoder_attention(run.cfg, run.trace_facts["windows"])
    return 100.0 * work.bound_s(w["ops"], w["bytes"],
                                run.cfg["compute_dtype"]) / t
