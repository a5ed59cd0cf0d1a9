"""Device-op durations from a JAX profiler trace (``*.xplane.pb``).

Reads the trace with ``jax.profiler.ProfileData`` (nothing beyond JAX) and
sums event durations per name on the GPU device planes
(``/device:GPU:<n>``). Which line holds the ops differs between XLA
versions: the ``XLA Ops`` line when the trace has one, else the CUDA
stream lines (one event per kernel). A trace with no GPU device plane —
a CPU run, or a trace of the wrong process — is an error, not an empty
result.
"""

import glob
import os

from jax.profiler import ProfileData

DEVICE_PLANE_PREFIX = "/device:GPU:"


def latest_xplane(trace_dir: str) -> str:
    """Newest ``*.xplane.pb`` under a ``jax.profiler.trace`` directory."""
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return paths[-1]


def device_planes(pd: ProfileData) -> list:
    planes = [p for p in pd.planes if p.name.startswith(DEVICE_PLANE_PREFIX)]
    if not planes:
        names = [p.name for p in pd.planes]
        raise RuntimeError(f"no GPU device plane in the trace (planes: "
                           f"{names})")
    return planes


def op_lines(plane) -> list:
    """The lines of a device plane whose events are the device ops."""
    lines = list(plane.lines)
    ops = [ln for ln in lines if ln.name == "XLA Ops"]
    return ops or [ln for ln in lines if ln.name.startswith("Stream")]


def op_durations(xplane_path: str) -> dict:
    """{op name: total device seconds} over every GPU device plane."""
    pd = ProfileData.from_file(xplane_path)
    durs: dict = {}
    for plane in device_planes(pd):
        for line in op_lines(plane):
            for ev in line.events:
                durs[ev.name] = durs.get(ev.name, 0.0) + ev.duration_ns / 1e9
    return durs
