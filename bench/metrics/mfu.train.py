"""Model flops utilisation of training (%): the model flops of the steps
completed in the window (3 forwards a step: 2 N a token for the products,
attention over its live pairs, the SSD scan's own work, the hybrid's
shared block at every call; remat's recomputation left out), over the
window's seconds times the bf16 peak."""

from bench.flops import peaks, work


def read(ctx):
    w, t = ctx["window"], ctx["traffic"]
    if not w["units"]:
        return None
    flops = w["units"] * work.train_step_flops(ctx["config"], t["batch"],
                                               t["seq"])
    return 100.0 * flops / (w["seconds"] * peaks.BF16_FLOPS)
