"""Device ms a step of the blocks' own work around the products and the
hand kernels: the ops launched in the program's ``lm.block`` and
``lm.block.backward`` spans (forward, recomputation under remat and
backward), neither cuBLAS products (a kernel named as cuBLAS names its
own) nor inside a ``kernel.*`` span, from the program's spans placed on
the trace (``bench/program_spans.py``)."""

from bench import program_spans

read = program_spans.elementwise_in(["lm.block", "lm.block.backward"])
