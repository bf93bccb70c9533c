"""Device idle ms a prefill call between the first and the last device op
launched in the program's ``lm.forward`` span: the gaps between its
kernels, from the program's spans placed on the trace
(``bench/program_spans.py``)."""

from bench import program_spans

read = program_spans.gap_of("lm.forward", any_thread=False)
