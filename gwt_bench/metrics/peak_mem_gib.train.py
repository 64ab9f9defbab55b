"""The allocator's peak over the window (``torch.cuda.
max_memory_allocated`` after ``reset_peak_memory_stats`` at its start),
in GiB."""


def read(run):
    peak = run.facts.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
