"""Set-up seconds: from the start of the run to the first timed step --
imports, CUDA's start, the kernels' build (the first run in a checkout)
or load, the weights and state made on the card, the corpus, the warm-up
and checked steps."""


def read(ctx):
    return ctx["setup_s"]
