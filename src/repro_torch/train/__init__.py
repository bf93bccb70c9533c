"""Training-side utilities of the port (counterpart of ``repro.train``):
so far the flat-key npz checkpoint format (``train.checkpoint``)."""
