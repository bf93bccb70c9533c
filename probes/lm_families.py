"""chip_smoke's mixture-of-experts and encoder-decoder phases alone, on
the card.

Builds the kernels (``build.build_all``), then runs ``chip_smoke.moe_phase``
(phase 16: mixtral-8x7b at full width, 4 of 32 layers),
``chip_smoke.audio_phase`` (phase 17: whisper-medium at full width and
depth) and ``chip_smoke.attn_shapes_phase`` (``flash_attention`` at the
shapes the two phases launched) with one shared count of launches by
shape, TF32 off as chip_smoke sets it; ~70 s on an H100.

    python3 probes/lm_families.py

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
        print("lm_families: no CUDA device", file=sys.stderr)
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
    shapes, total = {}, {}
    for phase in (cs.moe_phase, cs.audio_phase):
        for k, v in phase(dev, card, shapes).items():
            total[k] = total.get(k, 0) + v
    rows = cs.attn_shapes_phase(dev, shapes)
    print(f"launches {total}", flush=True)
    print(json.dumps({"kernels": list(rows.values())}))
    print(f"phases {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
