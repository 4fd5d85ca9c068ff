"""Test configuration: CPU backend with 8 virtual devices + float64 support.

Tests run on a faked 8-device CPU mesh (SURVEY.md §4) so multi-device
sharding is exercised without TPUs, and with x64 enabled so parity tests can
match the float64 reference exactly. These env vars must be set before jax
is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

# A plugin may have imported jax before this conftest ran, in which case the
# env vars above were too late — set the config directly (both work before
# backend initialization).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on the CPU")


@pytest.fixture(scope="session")
def example_map_path():
    """Path to the bundled copy of the reference's example map."""
    from f1tenth_gym_tpu.maps import map_path

    return map_path("example_map")
