"""Prefill tokens/s: all prompt tokens of the calls completed in the
window, over the window (host clock; each call ends with its served
tokens on the host)."""


def read(ctx):
    w = ctx["window"]
    return w["tokens"] / w["seconds"] if w["units"] else None
