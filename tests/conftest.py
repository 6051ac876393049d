import os
import pathlib
import sys

# Smoke tests and benches run on the single real CPU device; only
# launch/dryrun.py (never imported here) installs fake devices.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

try:  # property tests use hypothesis when available ...
    import hypothesis  # noqa: F401
except ImportError:  # ... and a deterministic shim otherwise
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    import _hypothesis_shim

    _hypothesis_shim.install()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (skips without them)")
