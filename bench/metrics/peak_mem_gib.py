"""Peak device memory (GiB): ``torch.cuda.max_memory_allocated()`` over
set-up and window, after ``reset_peak_memory_stats()`` at the start, read
when the window ends (before the check)."""


def read(ctx):
    return ctx["peak_bytes"] / float(1 << 30) if ctx["peak_bytes"] else None
