"""Model flops utilisation of prefill (%): the model flops of the calls
completed in the window (one forward each: 2 N a token, attention over
its live pairs, the SSD scan's own work), over the window's seconds
times the bf16 peak."""

from bench.flops import peaks, work


def read(ctx):
    w, t = ctx["window"], ctx["traffic"]
    if not w["units"]:
        return None
    flops = w["units"] * work.forward_flops(ctx["config"], t["batch"],
                                            t["seq"])
    return 100.0 * flops / (w["seconds"] * peaks.BF16_FLOPS)
