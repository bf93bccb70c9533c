"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on one card and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by name:

    bench/configs/<config>.json     sizes, cuts, precision, deployment
    bench/traffic/<traffic>.json    a traffic mix: the parameters of the
                                    general generator, and its kind
    bench/traffic/<kind>.py         a traffic kind: how a cell drives the
                                    program and what its check compares
    bench/workloads/<cell>.json     the limits of the cell's check
    bench/metrics/<metric>.py       a per-layer metric's reader

The yardstick (the generator, the plain reference, the frozen work counts,
the peaks and the comparison that decides ``correct``) lives here and
imports nothing of the program.
"""
