"""How far zamba2-1.2b's gradients move under errors of the SSD kernels' size.

chip_smoke phase 18 holds zamba2's gradients on ``"cuda"`` against
``"einsum"`` per parameter.  This probe splits that difference, at full
width on one TokenStream batch of 2 x 4096 (chip_smoke's), random weights
from seed 0, at each depth of ``--layers`` (the first n blocks; the
shared attention block follows every sixth):

* einsum vs einsum with ``ssd_chunked``'s y multiplied by (1 + 1e-6 r),
  r standard normal from a fixed seed (about the split-TF32 forward's
  error): how the model itself amplifies an error of that size;
* cuda vs cuda with ``ssd_scan_backward`` replaced by the plain backward
  in fp32: what the backward kernels alone add;
* cuda vs einsum, as phase 18 measures it;
* cuda with every gradient of each ``ssd_scan_backward`` call multiplied
  by (1 + eps r), eps 1e-4, 1e-3 and 1e-2, and with ``ssd_scan``'s
  outputs detached, each vs einsum: how large a fault of the backward a
  bar at that depth sees.

Each line gives the worst and median relative L2 error over the
parameters and the worst parameter.

    python3 probes/ssm_route_noise.py [--layers 2,6,38]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="38",
                    help="comma-separated depths (blocks) to measure")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.data.tokens import TokenStream, markov_sequence_fast
    from repro_torch.kernels import build, ssd_scan
    from repro_torch.nn import ssm as S
    from repro_torch.nn import transformer as T
    from repro_torch.train import step as TS

    if not torch.cuda.is_available():
        print("ssm_route_noise: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    build.build_all()
    dev = torch.device("cuda:0")
    full = cs._ssm_config(cs.TRAIN_SSM["zamba2"])
    batch = next(TokenStream(markov_sequence_fast(
        cs.TRAIN_CORPUS, full.vocab, seed=0), cs.TRAIN_B, cs.TRAIN_S,
        device=dev).batches(1))
    kern = ssd_scan.ssd_scan_backward
    plain_ssd = S.ssd_chunked

    for n in (int(v) for v in args.layers.split(",")):
        cfg = dataclasses.replace(full, n_layers=n)
        params = T.init_model(torch.Generator(device=dev).manual_seed(0),
                              cfg, trainable=True)

        def grads(backend):
            return TS.grads_of(params, batch, cfg, backend=backend)[1]

        def compare(what, a, b):
            rel = {k: cs._bwd_rel(a[k], e) for k, e in b.items()}
            worst = max(rel, key=rel.get)
            vals = sorted(rel.values())
            print(f"[{n} blocks] {what}: relative L2 worst {rel[worst]:.4e} "
                  f"({worst}), median {vals[len(vals) // 2]:.4e}", flush=True)

        ein = grads("einsum")
        g = torch.Generator(device=dev).manual_seed(5)

        def noisy(*a, **kw):
            y, h = plain_ssd(*a, **kw)
            r = torch.randn(y.shape, generator=g, device=dev)
            return y * (1 + 1e-6 * r), h

        S.ssd_chunked = noisy
        try:
            compare("einsum vs einsum with y (1 + 1e-6 r)", grads("einsum"),
                    ein)
        finally:
            S.ssd_chunked = plain_ssd
        cu = grads("cuda")
        ssd_scan.ssd_scan_backward = lambda *a: \
            ssd_scan.ssd_scan_backward_plain(*a)
        try:
            compare("cuda vs cuda with the plain SSD backward in fp32", cu,
                    grads("cuda"))
        finally:
            ssd_scan.ssd_scan_backward = kern
        compare("cuda vs einsum", cu, ein)
        del cu
        for eps in (1e-4, 1e-3, 1e-2):
            def faulty(*a, eps=eps):
                return tuple(t * (1 + eps * torch.randn(
                    t.shape, generator=g, device=dev)) for t in kern(*a))

            ssd_scan.ssd_scan_backward = faulty
            try:
                compare(f"cuda with the SSD gradients (1 + {eps:g} r) vs "
                        f"einsum", grads("cuda"), ein)
            finally:
                ssd_scan.ssd_scan_backward = kern
        with cs._SsdDetached():
            compare("cuda with ssd_scan detached vs einsum", grads("cuda"),
                    ein)
        del params, ein
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
