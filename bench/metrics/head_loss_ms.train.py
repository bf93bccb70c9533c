"""Device ms a step of the head and the loss, forward and backward: the
program's ``lm.head`` (final norm, unembedding into fp32 logits),
``train.loss`` and their backward spans ``lm.head.backward`` and
``train.loss.backward``, from the program's spans placed on the trace
(``bench/program_spans.py``)."""

from bench import program_spans

read = program_spans.device_ms_in(["lm.head", "train.loss",
                                   "lm.head.backward", "train.loss.backward"])
