"""The benchmark stands alone: what ``bench/run.py`` loads holds neither
JAX nor the JAX package; the plain reference loads nothing of the
program; a run with no card, or with no program beside the benchmark,
exits non-zero and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(ROOT, "src")
CELL = "granite-3-2b.train-adamw.2x4096"


def _fresh(code, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=120)


def test_the_run_s_import_graph_loads_no_jax_and_no_jax_package():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{ROOT!r}, {SRC!r}]\n"
        "import bench.run, bench.calibrate, bench.check, bench.drive\n"
        "import bench.trace, bench.flops.calls\n"
        "import repro_torch.train.trainer, repro_torch.train.step\n"
        "import repro_torch.nn.transformer, repro_torch.kernels.build\n"
        "import repro_torch.kernels.flash_attn, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.bayes.vb_optimizer\n"
        "from bench import spec\n"
        "b = spec.benchmark()\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "for w in b['workloads']:\n"
        "    spec.kind(spec.find_cell(w['name']).traffic['kind'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro'))\n"
        "assert not bad, bad\n"
        "assert not bench.run.forbidden_modules()\n")
    out = _fresh(code)
    assert out.returncode == 0, out.stderr


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{ROOT!r}]\n"
        "import bench.reference.lm, bench.reference.optim\n"
        "import bench.weights, bench.feed, bench.flops.work\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro', 'repro_torch'))\n"
        "assert not bad, bad\n")
    out = _fresh(code)
    assert out.returncode == 0, out.stderr


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "bench/run.py", "--workload",
                           CELL, "--seed", "1", "--seconds", "0.2", *extra],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--device", "cpu")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "repro_torch" in out.stderr
