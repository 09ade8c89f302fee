"""Test configuration: JAX on a virtual 8-device CPU mesh.

Multi-device behavior is tested without accelerators via
``--xla_force_host_platform_device_count`` (SURVEY.md SS4 lesson: the
reference could only test multi-node *on* the cluster; we fix that).
JAX_PLATFORMS, when set, wins: ``JAX_PLATFORMS=cuda,cpu pytest -m gpu``
runs the GPU-marked tests on the card with the CPU device beside it.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided here, at run
    time, never while a test module is imported)."""
    from geosongpu_tpu.device import NoGPUError, require_gpu

    try:
        return require_gpu()
    except NoGPUError as e:
        pytest.skip(str(e))
