"""``torch.profiler`` hook: the port's counterpart of ``repro.obs.profile``
(which bridges to ``jax.profiler``).

Device time (kernel durations, the op breakdown) is out of scope for the
host span tracer; :func:`profile` records it with ``torch.profiler`` and
writes a Chrome trace (``trace.json``, opens in Perfetto or
``chrome://tracing``) into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

from repro_torch.obs import sink


@contextlib.contextmanager
def profile(logdir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``logdir/trace.json``.

    No-op when ``logdir`` is falsy, so call sites can pass a CLI flag
    straight through.  Records CUDA activity when a card is present (CPU
    activity always).  Emits a ``log`` event before and after the capture
    when obs is enabled."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    out = os.path.join(logdir, "trace.json")
    sink.emit("log", msg=f"profiler trace -> {logdir}", component="profile")
    with _profile(activities=acts) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(out)
    sink.emit("log", msg=f"profiler trace written to {logdir}",
              component="profile")
