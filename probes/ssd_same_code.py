"""The SSD scan's kernels of an older checkout and of this one compile to
the same machine code.

Builds ``ssd_scan.cu`` and ``ssd_scan_bwd.cu`` of the older checkout (the
first argument, a directory holding ``src/``) and of this one with the
same ``nvcc`` flags, dumps each library's SASS with ``cuobjdump -sass``,
and compares it kernel by kernel (the lines after each function's name,
its file paths left out).  The same code gives the same bits on the same
inputs: a change that moves the kernels' helpers between headers keeps
the SSD rows' bits when every kernel is the same.

    python3 probes/ssd_same_code.py OLDER_CHECKOUT

Prints one line a kernel and a JSON line ``{"same_code": bool,
"kernels": n}``; exits 1 if any kernel differs.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _sass(csrc, name, out):
    from repro_torch.kernels import build

    so = os.path.join(out, f"lib{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", so,
                    os.path.join(csrc, f"{name}.cu")], check=True,
                   capture_output=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], check=True,
                          capture_output=True, text=True).stdout
    kernels, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:     # the anonymous namespace's tag hashes the file's path
            cur = kernels.setdefault(
                re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", m.group(1)), [])
        elif cur is not None and line.strip().startswith("/*"):
            cur.append(line.strip())
    return kernels


def main(older):
    from repro_torch.kernels import build

    out = os.path.join(ROOT, "build", "ssd_same_code")
    same, n = True, 0
    for name in ("ssd_scan", "ssd_scan_bwd"):
        sides = {}
        for side, csrc in (("older", os.path.join(older, "src", "repro_torch",
                                                  "kernels", "csrc")),
                           ("newer", str(build.CSRC))):
            d = os.path.join(out, side)
            os.makedirs(d, exist_ok=True)
            sides[side] = _sass(csrc, name, d)
        for kernel in sorted(set(sides["older"]) | set(sides["newer"])):
            eq = sides["older"].get(kernel) == sides["newer"].get(kernel)
            same &= eq
            n += 1
            print(f"{name} {kernel}: the same SASS {eq} "
                  f"({len(sides['newer'].get(kernel, []))} lines)",
                  flush=True)
    print(json.dumps({"same_code": bool(same), "kernels": n}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
