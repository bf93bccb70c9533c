"""Device ms a step in which an operation ran (the union of the device
operations of the steps profiled after the window): the step's device
work, which neither the host's speed nor the profiler's host overhead
changes, so it reads steadier than ``train_tokens_per_s``."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.units or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / tr.units
