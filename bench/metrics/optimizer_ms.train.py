"""Device ms a step inside the optimizer's update (``adamw_update`` or
``vb_update``), from the trace: the operations launched while the
benchmark's range around the call was open."""

WRAPS = {"adamw_update": ("repro_torch.train.optimizer", "adamw_update"),
         "vb_update": ("repro_torch.bayes.vb_optimizer", "vb_update")}


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not any(tr.span_calls.get(n) for n in WRAPS):
        return None
    s = sum(tr.span_device_s.get(n, 0.0) for n in WRAPS)
    return 1e3 * s / tr.units if s > 0 else None
