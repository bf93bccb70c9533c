import os
import sys

# Tests run single-device (the dry-run alone uses 512 host devices).
# Keep XLA quiet and deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")
