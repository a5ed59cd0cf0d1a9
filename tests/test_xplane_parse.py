"""scripts/xplane_parse.py reads traces with jax.profiler.ProfileData and
refuses a trace without a GPU device plane."""

import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import xplane_parse  # noqa: E402


def test_cpu_trace_has_no_device_plane(tmp_path):
    f = jax.jit(lambda x: (x * 2).sum())
    x = jnp.ones((256, 256))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    path = xplane_parse.latest_xplane(str(tmp_path))
    assert path.endswith(".xplane.pb")
    with pytest.raises(RuntimeError, match="no GPU device plane"):
        xplane_parse.op_durations(path)


def test_missing_trace_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        xplane_parse.latest_xplane(str(tmp_path))
