"""Device ms a prefill call in the program's ``lm.head`` span (the final
norm and the unembedding into fp32 logits), from the program's spans
placed on the trace (``bench/program_spans.py``)."""

from bench import program_spans

read = program_spans.device_ms_in(["lm.head"])
