"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``.  Libraries go to ``build/repro_torch_kernels/`` at
the root of the checkout, in a directory keyed by a hash of the source, the
headers it includes from ``csrc/`` (and the headers those include) and the
flags, so a changed source or header is rebuilt and an unchanged one is
reused.

    python -m repro_torch.kernels.build      # build every source, print logs
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = {"clg_stats": CSRC / "clg_stats.cu",
           "factor_ops": CSRC / "factor_ops.cu",
           "family_counts": CSRC / "family_counts.cu",
           "flash_attn": CSRC / "flash_attn.cu",
           "flash_attn_bwd": CSRC / "flash_attn_bwd.cu",
           "ssd_scan": CSRC / "ssd_scan.cu",
           "ssd_scan_bwd": CSRC / "ssd_scan_bwd.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# one build and load at a time: the async serving tier's workers can
# reach a kernel's first call together
_LOCK = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = SOURCES[name].read_bytes()
    seen, todo = set(), [src]
    while todo:          # the headers it includes from csrc/, and theirs
        for header in re.findall(rb'^#include "([^"]+)"', todo.pop(), re.M):
            if header not in seen:
                seen.add(header)
                text = (CSRC / header.decode()).read_bytes()
                src += text
                todo.append(text)
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{key}" / f"lib{name}.so"


def build_all() -> Tuple[float, Dict[str, str]]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together.  Returns (seconds, {name: log})."""
    t0 = time.perf_counter()
    procs = {}
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            os.unlink(tmp)
            failed.append(name)
        else:
            os.replace(tmp, out)       # atomic: readers never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed.
    Thread-safe: concurrent first calls build and load once."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                path = _lib_path(name)
                if not path.exists():
                    build_all()
                lib = ctypes.CDLL(str(path))
                _LOADED[name] = lib
    return lib


if __name__ == "__main__":
    secs, logs = build_all()
    for name, log in logs.items():
        print(f"--- {name}\n{log}")
    print(f"built in {secs:.2f} s")
