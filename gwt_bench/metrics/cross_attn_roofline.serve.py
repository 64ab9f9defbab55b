"""The cross-attention kernel's share of its roofline.  The kernel that
reads a decode step's audio K/V computes the step's self-attention over
the KV cache in the same launch, so its time cannot be split and the bound
counts both (``work.decode_attention``: every live K/V byte read once a
layer a step, bytes-bound; the audio K/V is most of it) over the device
time of the kernels the metric file names, in percent."""

from gwt_bench import devtrace, work


def read(run):
    if run.trace is None:
        return None
    t = devtrace.kernel_s(run.trace, run.metric["kernels"])
    if not t:
        return None
    ops = n_bytes = 0.0
    for n in run.trace_facts["served_tokens"]:
        w = work.decode_attention(run.cfg, 1, run.trace_facts["prompt"], n - 1)
        ops += w["ops"]
        n_bytes += w["bytes"]
    return 100.0 * work.bound_s(ops, n_bytes, run.cfg["compute_dtype"]) / t
