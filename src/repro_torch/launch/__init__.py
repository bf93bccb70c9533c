"""Command-line drivers of the port (counterpart of ``repro.launch``)."""
