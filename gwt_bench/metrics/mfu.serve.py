"""Model operations of the work completed in the window (encoder, cross
K/V, prompt pass and every decode step with its logits, counted from the
configuration and the served token counts) over the window's seconds
times the compute dtype's peak, in percent."""

from gwt_bench import work


def read(run):
    cfg, f = run.cfg, run.facts
    ops = sum(work.serve_window_ops(cfg, f["prompt"], n)
              for n in f["served_tokens"])
    if not ops:
        return None
    return work.mfu_pct(ops, run.window_s, cfg["compute_dtype"])
