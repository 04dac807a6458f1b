import os
import sys

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device; only launch/dryrun.py forces 512 host devices.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    # no pytest.ini/pyproject in this repo; register the chaos marker here
    # so `-m chaos` selects the fault-injection suite without warnings
    config.addinivalue_line(
        "markers",
        "chaos: fault-injection / recovery tests on simulated devices")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's Hopper kernels); skips without one")
