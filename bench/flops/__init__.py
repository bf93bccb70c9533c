"""Frozen work counts: the operations and bytes of the port's calls and of
a model's step, from shapes alone (copied from the program's own
arithmetic so that later changes to the program cannot move the
yardstick)."""
