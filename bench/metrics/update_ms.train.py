"""Device ms a step inside the program's ``train.update`` span: the
optimizer's update, and under VB the posterior's KL beside it (both in
one span of ``train/step.py``), from the program's spans placed on the
trace (``bench/program_spans.py``)."""

from bench import program_spans

read = program_spans.device_ms_in(["train.update"])
