"""Workload configurations of the port (``amidst_pgm``: the paper's plates)."""
