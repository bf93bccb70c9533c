"""How far the factorial HMM's M-step sums move under float32, on the card.

The fHMM's M-step divides, for each chain and state, the responsibility-
weighted sum of residuals over every frame by the weights' sum.  At
``chip_smoke.py`` phase 12's size (B = 2^14 sequences x T = 64 frames, F =
10, C = 2 chains of S = 3 states, on phase 12's data and initial state)
this probe runs the einsum sweeps and, at each of 5 sweeps, from that
sweep's state:

- the numerators from the einsum backend (``torch.einsum`` over the 2^20
  frames), the ``clg_seq_suffstats`` kernel (one launch a chain) and the
  plain ``clg_suffstats_ref``, each against the same sums in float64: the
  largest |error| over (chain, state, feature), absolute and relative to
  max |sum|;
- then how the sweeps carry a difference: the einsum fit of 5 sweeps with
  sweep 1's means scaled by 1 + 1e-6, against the unperturbed fit (the
  largest |means difference| after sweep 5).

    python3 probes/fhmm_sums.py

Prints the card's name and power limit, one line a sweep, then the
perturbation's result.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fhmm_sums: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.kernels import clg_stats, ref
    from repro_torch.pgm_models import dynamic as dyn

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda:0")
    B, T, F, S = cs.TEMPORAL_B, cs.TEMPORAL_T, cs.TEMPORAL_F, cs.TEMPORAL_S
    C, S2 = cs.FHMM_C, cs.FHMM_S
    # phase 12's draws: the two kernel checks', then the HMM sequences
    g = torch.Generator(device=dev).manual_seed(0)
    for D in (1, 2):
        torch.randn(B, T, F, D, generator=g, device=dev)
        torch.randn(B, T, F, generator=g, device=dev)
        torch.randn(B, T, S, generator=g, device=dev)
    trans, means = cs._hmm_params(S, F, 1)
    xc = cs._sample_hmm(g, dev, B, T, trans, means)
    m0 = dyn.FactorialHMMModel(cs._attrs(F), n_chains=C, n_states=S2,
                               seed=0, device=dev, backend="einsum")
    mask = torch.ones(B, T, device=dev)
    init = (m0.means, m0.log_trans,
            torch.full((B, T, C, S2), 1.0 / S2, device=dev))
    ones = xc.new_ones(B, T, F, 1)

    def sweep(state, scale=1.0):
        mn, lt, gm, e = dyn._fhmm_sweep(*state[:2], m0.log_init, m0.noise,
                                        state[2], xc, mask, "einsum")
        return (mn * scale, lt, gm), e

    state = init
    for k in range(5):
        new, _ = sweep(state)
        contrib = torch.einsum("btcs,csf->cbtf", state[2], state[0])
        resid = (xc[None] - (contrib.sum(0, keepdim=True)
                             - contrib)).contiguous()
        w = new[2].permute(2, 0, 1, 3).contiguous()
        exact = torch.einsum("cbts,cbtf->csf", w.double(), resid.double())
        nums = {
            "einsum": torch.einsum("cbts,cbtf->csf", w, resid),
            "kernel": torch.stack([
                clg_stats.clg_seq_suffstats(ones, resid[c], w[c])[1][..., 0].T
                for c in range(C)]),
            "plain": torch.stack([
                ref.clg_suffstats_ref(ones.view(B * T, F, 1),
                                      resid[c].view(B * T, F),
                                      w[c].view(B * T, S2))[1][..., 0].T
                for c in range(C)]),
        }
        scale = float(exact.abs().max())
        errs = {name: float((n.double() - exact).abs().max())
                for name, n in nums.items()}
        print(f"sweep {k}: max|sum| {scale:.4e}; |err| vs float64 "
              + ", ".join(f"{name} {e:.3e} ({e / scale:.2e})"
                          for name, e in errs.items()), flush=True)
        state = new
    a, b = init, init
    for k in range(5):
        a, _ = sweep(a)
        b, _ = sweep(b, 1.0 + 1e-6 if k == 0 else 1.0)
    print(f"means scaled by 1 + 1e-6 after sweep 1: max |means difference| "
          f"after sweep 5 {float((a[0] - b[0]).abs().max()):.3e} (max|means|"
          f" {float(a[0].abs().max()):.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
