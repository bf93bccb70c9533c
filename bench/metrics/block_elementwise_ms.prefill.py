"""Device ms a prefill call of the blocks' own work around the products
and the hand kernels: the ops launched in the program's ``lm.block``
spans, neither cuBLAS products nor inside a ``kernel.*`` span, from the
program's spans placed on the trace (``bench/program_spans.py``)."""

from bench import program_spans

read = program_spans.elementwise_in(["lm.block"])
