import os
import sys

# Tests see the real (single) CPU device — only launch/dryrun.py forces
# the 512-device placeholder topology.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "float32")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA card; skips without one")
