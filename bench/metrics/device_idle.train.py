"""The device's idle share (%) of the timed window: 1 - (device busy a
unit) / (window seconds a unit).  Busy is the union of the device
operations of the units profiled after the window (the trace), a step's
or a call's device work, which the profiler's host overhead does not
change; the window's seconds a unit are the untraced window's own (host
clock), so the share is that of the measured window, not of the slower
profiled one."""


def read(ctx):
    tr, w = ctx["trace"], ctx["window"]
    if tr is None or not w["units"]:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.units) / (w["seconds"] / w["units"]))
