"""The plain reference: the benchmark's language models, their loss,
gradients and optimizers in plain PyTorch.  Imports nothing of the
program."""
