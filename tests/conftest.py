"""Test configuration.

The suite runs on the CPU by default: JAX tests use a virtual 8-device CPU
mesh.  Tests marked ``gpu`` need a card; they skip (from the ``gpu_device``
fixture, never at import) unless JAX's default backend is a GPU.  Run them
on a machine with a card with ``JAX_PLATFORMS=cuda python -m pytest tests
-m gpu``, or through ``python chip_smoke.py`` (which runs them in its own
process after JAX has started on the card).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import numpy as np
import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden():
    return {
        i: (
            (GOLDEN / f"sample{i}.ref").read_bytes(),
            (GOLDEN / f"sample{i}.bz2").read_bytes(),
        )
        for i in (1, 2, 3)
    }


@pytest.fixture()
def rng():
    return np.random.default_rng(0xB21)


@pytest.fixture()
def gpu_device():
    """The first JAX device, if it is a GPU; skips the test otherwise."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX default backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]
