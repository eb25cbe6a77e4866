"""Test config: CPU-only JAX with a virtual 8-device platform.

Must run before any jax import (pytest imports conftest first). Tests never
use an accelerator; the on-GPU checks are chip_smoke.py's.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Route pipeline work to local CPU devices (the device pool reads
# SEGALIGN_DEVICES).
os.environ.setdefault("SEGALIGN_DEVICES", "cpu")


def pytest_configure(config):
    import jax
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
