"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding tests use XLA's host-platform device virtualization, and
numeric tests run on CPU for determinism and float64 support. Tests of
code that runs only on the card carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them without a CUDA device; run them on the
card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a CUDA GPU (decided when the
    test runs, never at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")

REFERENCE = "/root/reference"


def has_reference() -> bool:
    return os.path.isdir(REFERENCE)


requires_reference = pytest.mark.skipif(
    not os.path.isdir(REFERENCE), reason="reference checkout not available"
)
