"""Test configuration: force a CPU backend with an 8-device virtual mesh.

Multi-device sharding tests run on a host-simulated mesh per SURVEY.md §4
(``--xla_force_host_platform_device_count=8``).  ``jax_platforms`` is set to
``cpu`` before the first backend use unless ``JAX_PLATFORMS`` names the
platforms explicitly, so the suite never touches an accelerator by accident.
Tests marked ``gpu`` check for a card in the ``gpu_device`` fixture and skip
without one; on a GPU host they run with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_threefry_partitionable", True)

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.key(0)


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip.  Decided here, at test time, never
    at import or collection time: xdist workers must all collect the same
    tests."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip(
            "needs an NVIDIA GPU (on a GPU host: "
            "JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu)"
        )
    return gpus[0]
