"""chip_smoke's LM training phase alone, on the card.

Builds the kernels (``build.build_all``), then runs ``chip_smoke.train_phase``
(phase 18: granite-3-2b at full width and depth -- the gradients of one
batch on both routes, AdamW and streaming-VB steps --, one AdamW step of
mixtral-8x7b cut to one layer, of whisper-medium and of gemma-2b,
zamba2-1.2b's gradients on both routes and one AdamW step each of
zamba2-1.2b and mamba2-1.3b) and ``chip_smoke.train_rows_phase`` (the
attention backward kernels at the five shapes, the SSD backward at
zamba2's and mamba2's), TF32 off as chip_smoke sets it.

    python3 probes/lm_train.py

Prints the card's name and power limit, the phases' logs, their launch
counts, and the kernel rows as one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("lm_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"build: {build.build_all()[0]:.2f} s", flush=True)
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    total, counts = cs.train_phase(dev, card)
    rows = cs.train_rows_phase(dev, counts)
    print(f"launches {total}", flush=True)
    print(json.dumps({"kernels": list(rows.values())}))
    print(f"phases {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
