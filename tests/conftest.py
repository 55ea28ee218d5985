import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

# smoke tests and benches must see 1 device (dry-run sets its own flags in
# a separate process); keep CPU math deterministic
jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels); "
        "skips where torch sees none")
