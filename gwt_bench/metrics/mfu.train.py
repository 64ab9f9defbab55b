"""Model operations of the window's training steps (three times each
row's forward pass, recomputation not counted: ``work.
train_row_forward_ops``) over the window's seconds times the compute
dtype's peak, in percent."""

from gwt_bench import work


def read(run):
    cfg, f = run.cfg, run.facts
    if not f.get("units"):
        return None
    ops = 3.0 * f["units"] * f["rows"] * work.train_row_forward_ops(cfg,
                                                                    f["T"])
    return work.mfu_pct(ops, run.window_s, cfg["compute_dtype"])
