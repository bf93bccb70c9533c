"""Shared set-up of the port-vs-reference tests (``test_torch_*.py``): the
same plate compiled by both packages, the reference's initial posterior
carried into the port (``jax.random`` cannot be reproduced in PyTorch), and
comparisons of stats and parameter trees.  Inputs are numpy arrays made from
a seed and handed to both packages."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.core import expfam as jef
from repro.core import vmp as jvmp
from repro.core.dag import PlateSpec as JPlateSpec
from repro_torch import convert
from repro_torch.core import expfam as tef
from repro_torch.core import vmp as tvmp
from repro_torch.core.dag import PlateSpec as TPlateSpec

# one intra-op thread: the suite runs in several worker processes at once,
# and the reference's timing-sensitive serving tests share those cores
torch.set_num_threads(1)


def plates(seed=0, latent_mask=None, **spec):
    """(jax cp, jax prior, jax init, port cp, port prior, port init)."""
    jcp = jvmp.compile_plate(JPlateSpec(**spec), None if latent_mask is None
                             else jnp.asarray(latent_mask))
    jprior = jvmp.default_prior(jcp)
    jinit = jvmp.symmetry_broken(jprior, jax.random.PRNGKey(seed))
    tcp = tvmp.compile_plate(TPlateSpec(**spec), latent_mask, device="cpu")
    return (jcp, jprior, jinit, tcp,
            convert.plate_params_from_numpy(jprior, "cpu"),
            convert.plate_params_from_numpy(jinit, "cpu"))


def data(n, f, fd=0, cards=(), seed=0, masked_tail=0):
    """xc [n, f], xd [n, fd] (column j in [0, cards[j])), mask [n]."""
    g = np.random.default_rng(seed)
    xc = g.standard_normal((n, f), dtype=np.float32)
    xd = np.stack([g.integers(0, c, n) for c in cards], 1).astype(np.int32) \
        if fd else np.zeros((n, 0), np.int32)
    mask = np.ones(n, np.float32)
    if masked_tail:
        mask[-masked_tail:] = 0.0
    return xc, xd, mask


def T(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


def J(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def assert_stats_close(js, ts, rtol=1e-4, atol=5e-4, label=""):
    """Dense-form comparison (the einsum backends keep the latent block
    lazily; reg_dense reconciles)."""
    a, b = jef.reg_dense(js.reg), tef.reg_dense(ts.reg)
    for x, y, name in [(js.counts, ts.counts, "counts"), (a.sxx, b.sxx, "sxx"),
                       (a.sxy, b.sxy, "sxy"), (a.syy, b.syy, "syy"),
                       (a.n, b.n, "n"), (js.disc, ts.disc, "disc"),
                       (js.n, ts.n, "n_inst"),
                       (js.local_elbo, ts.local_elbo, "local_elbo")]:
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=rtol,
                                   atol=atol, err_msg=f"{label} {name}")


def assert_params_close(jp, tp, rtol, atol, label=""):
    for name, x, y in [("mix", jp.mix.alpha, tp.mix.alpha),
                       ("m", jp.reg.m, tp.reg.m), ("K", jp.reg.K, tp.reg.K),
                       ("a", jp.reg.a, tp.reg.a), ("b", jp.reg.b, tp.reg.b),
                       ("disc", jp.disc.alpha, tp.disc.alpha)]:
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=rtol,
                                   atol=atol, err_msg=f"{label} {name}")


def trees_equal(a, b):
    from repro_torch.core.streaming import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def bn_to_port(jbn, device="cpu"):
    """The port's ``BayesianNetwork`` from a JAX-package network: same
    registry order, parent order and CPD arrays."""
    from repro_torch.convert import bayesian_network_from_numpy

    variables = [(v.name, v.kind, v.card) for v in jbn.dag.variables]
    parents = {v.name: [p.name for p in jbn.dag.get_parents(v)]
               for v in jbn.dag.variables}
    cpds = {}
    for name, cpd in jbn.cpds.items():
        if hasattr(cpd, "table"):
            cpds[name] = {"table": np.asarray(cpd.table)}
        else:
            cpds[name] = {f: np.asarray(getattr(cpd, f))
                          for f in ("alpha", "beta", "sigma2")}
    return bayesian_network_from_numpy(variables, parents, cpds, device)
