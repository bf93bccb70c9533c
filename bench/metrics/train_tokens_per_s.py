"""Training tokens/s: all tokens of the steps completed in the window,
over the window (host clock; the loss is read to the host every step, so
a step has ended when the next begins)."""


def read(ctx):
    w = ctx["window"]
    return w["tokens"] / w["seconds"] if w["units"] else None
