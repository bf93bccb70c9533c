"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke`` in a fresh process pulls in neither JAX nor any module of
the JAX package ``repro``; and ``chip_smoke.py`` refuses to run (non-zero
exit, no result line) where there is no CUDA card or no port beside it."""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_imports_no_jax_and_no_reference_package():
    mods = _modules()
    for m in ("kernels.clg_stats", "core.streaming", "kernels.factor_ops",
              "infer_exact.graph", "infer_exact.factors",
              "infer_exact.cg_potentials", "infer_exact.engine",
              "serve.plan", "serve.engine", "kernels.family_counts",
              "learn_structure", "learn_structure.scores",
              "learn_structure.chowliu", "learn_structure.search",
              "learn_structure.stream_adapt", "learn_structure.metrics",
              "configs.base", "configs.zamba2_1_2b", "nn.layers",
              "nn.attention", "nn.ssm", "nn.transformer",
              "kernels.flash_attn", "kernels.ssd_scan", "launch.serve",
              "pgm_models.dynamic", "core.factored_frontier", "data.io",
              "core.importance_sampling", "core.map_inference",
              "pgm_models.lda", "core.svi", "core.dvmp", "launch.mesh",
              "launch.dryrun_pgm", "obs", "obs.sink", "obs.agg",
              "obs.trace", "obs.metrics", "obs.export", "obs.health",
              "resilience", "resilience.errors",
              "resilience.checkpoint", "resilience.faultinject", "train",
              "train.checkpoint", "serve.queue", "train.optimizer",
              "train.step", "train.trainer", "bayes", "bayes.drift",
              "bayes.vb_optimizer", "data.tokens", "launch.train",
              "sharding", "sharding.specs", "sharding.collectives",
              "sharding.params", "launch.dryrun", "infer_exact.brute"):
        assert f"repro_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_chip_smoke_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke would run")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
