"""Test configuration: run JAX on CPU with 8 virtual devices.

Sharding tests exercise a multi-device mesh without accelerators
(``--xla_force_host_platform_device_count=8``). Tests that need an NVIDIA
GPU carry the ``gpu`` marker and take the ``gpu`` fixture, which skips
where JAX has no GPU; ``chip_smoke.py`` runs them on the card in its own
process, after JAX has opened the card (the overrides below then change
nothing).
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# pytest plugins (jaxtyping) import jax before this conftest runs, which
# freezes jax_platforms from the env — override the live config too.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX runs without one."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on "
                    "the card")
