"""Native exact inference -- the HUGIN-link replacement (paper §2.2, §3);
counterpart of ``repro.infer_exact``.

A junction-tree engine for the CLG ``BayesianNetwork`` of
``repro_torch.core.dag`` whose factor algebra is batched over evidence
instances and runs the hand-written CUDA kernels of
``repro_torch.kernels.factor_ops`` on a card.

Modules:
  graph         moralization, min-fill triangulation, junction-tree
                construction with running-intersection verification; strong
                triangulation + strong-root directed trees for CLG networks
                with continuous-continuous edges (static Python over DAG)
  factors       batched log-space discrete factor algebra (product,
                marginalize, evidence reduction)
  cg_potentials batched conditional-Gaussian potential algebra -- canonical
                (g, h, K) and moment (p, mu, Sigma) forms with combine /
                strong-marginalize / weak-marginalize (moment matching) ops
  engine        JunctionTreeEngine -- two-pass (collect/distribute) belief
                propagation; discrete pipeline and Lauritzen's strong
                junction tree for the full CLG class
  brute         brute-force enumeration oracle for tests and tiny networks
                (full CLG: per-configuration joint Gaussians)
"""

from repro_torch.infer_exact.brute import (brute_posterior,
                                           brute_posterior_mean_var,
                                           enumerate_log_joint)
from repro_torch.infer_exact.cg_potentials import CGPotential, MomentPotential
from repro_torch.infer_exact.engine import JunctionTreeEngine
from repro_torch.infer_exact.factors import Factor
from repro_torch.infer_exact.graph import (JunctionTree, compile_junction_tree,
                                           compile_strong_junction_tree)

__all__ = [
    "JunctionTreeEngine",
    "JunctionTree",
    "compile_junction_tree",
    "compile_strong_junction_tree",
    "Factor",
    "CGPotential",
    "MomentPotential",
    "brute_posterior",
    "brute_posterior_mean_var",
    "enumerate_log_joint",
]
