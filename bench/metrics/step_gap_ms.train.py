"""Device idle ms a step between the first and the last device op
launched, on any thread, while the program's ``train.step`` span was
open: the time the host leaves the card waiting inside a step, from the
program's spans placed on the trace (``bench/program_spans.py``)."""

from bench import program_spans

read = program_spans.gap_of("train.step", any_thread=True)
