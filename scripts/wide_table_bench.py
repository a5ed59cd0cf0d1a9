"""Wide-table classify regime: device time vs target count (real chip).

Runs the PRODUCTION single-dispatch kernel (classify_batch_packed) over
synthetic tables generated on device, traces the device-op time per
batch, and reports reads/s plus the effective gather bandwidth.

Table shapes model T equal genomes at h=4 / fp=0.05 (the bench db's
ratio: 1 Mbp -> bin_size 870575): 1 technical bin per target, W8 = T
bytes per row.
"""

import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from ganon_tpu.classify.device import classify_batch_packed, pack_batch_input
from xplane_parse import latest_xplane, op_durations


K, W = 19, 31
B, L = 8192, 150
N_TRACE = 3


def trace_jit_total(fn, inputs):
    """(device ms per call, top-10 [(ms, op)]) over ``inputs[1:]``."""
    np.asarray(fn(*inputs[0]))
    tracedir = os.path.join("chiprun_out", "wide_table_trace")
    shutil.rmtree(tracedir, ignore_errors=True)
    with jax.profiler.trace(tracedir):
        outs = [fn(*i) for i in inputs[1:]]
        for o in outs:
            np.asarray(o)
    durs = op_durations(latest_xplane(tracedir))
    n = len(inputs) - 1
    top = sorted(((d, nm) for nm, d in durs.items()), reverse=True)[:10]
    return (sum(durs.values()) / n * 1e3,
            [(d / n * 1e3, nm[:100]) for d, nm in top])


def run_config(T, R, rng, verbose_ops=False, h=4):
    # production layout (classify.device.DeviceFilter): the u32 word
    # view. Bit content is irrelevant to gather cost, so the table is
    # generated on device directly.
    assert T % 4 == 0
    tbl8 = jax.jit(
        lambda k: jax.random.bits(k, (R, T // 4), dtype=jnp.uint32)
        & jnp.uint32(0x5B5B5B5B),
    )(jax.random.key(T))
    layout = "u32"
    tbl8.block_until_ready()
    byte_starts = jnp.arange(T, dtype=jnp.int32)
    byte_ends = byte_starts + 1

    def mk_inputs(i):
        r = np.random.default_rng(i)
        c1 = r.integers(0, 4, size=(B, L), dtype=np.uint8)
        c2 = r.integers(0, 4, size=(B, L), dtype=np.uint8)
        lens = np.full(B, L, np.int32)
        return (jnp.asarray(pack_batch_input(c1, lens, c2, lens)),)

    kw = dict(
        k=K, w=W, L1=L, L2=L, bin_size=R, hash_functions=h,
        top_k=min(128, T), pack16=True,
    )

    def fn(inbuf):
        return classify_batch_packed(
            tbl8, byte_starts, byte_ends, inbuf,
            jnp.float64(0.25), jnp.float64(0.0), jnp.int32(65535), **kw,
        )

    inputs = [mk_inputs(i) for i in range(N_TRACE + 1)]
    ms, top = trace_jit_total(fn, inputs)
    reads_s = B / (ms / 1e3)
    # gather traffic: probes x hash_fns x W8 bytes (W8 == T here)
    probes = B * 48 * h  # compaction width 48 for paired 150bp
    gbs = probes * T / (ms / 1e3) / 1e9
    mb = R * T / 1e6
    print(
        f"T={T:5d} R={R:8d} h={h} {layout} table={mb:7.0f} MB: "
        f"{ms:8.2f} ms/batch = {reads_s:9,.0f} reads/s  "
        f"({ms * 1e6 / probes:5.1f} ns/probe, ~{gbs:4.0f} GB/s)"
    )
    if verbose_ops:
        for d, nm in top:
            print(f"      {d:8.3f} ms  {nm}")
    return ms


def main():
    rng = np.random.default_rng(0)
    verbose = "-v" in sys.argv
    only = None
    if "-only" in sys.argv:  # e.g. -only 4096,680975,1
        only = tuple(
            int(x) for x in sys.argv[sys.argv.index("-only") + 1].split(",")
        )
    print(f"device: {jax.devices()[0]}")
    # (T, R, h): R models per-target genome size at fp=0.05 with h hash
    # functions (1 Mbp, h=4 -> 870575 rows; h=2 -> x1.27; h=1 -> x3.13);
    # W8 == T bytes.
    for T, R, h in [
        (32, 870575, 4),
        (256, 870575, 4),
        (1024, 870575, 4),
        (1024, 1104057, 2),
        (1024, 2723899, 1),
        (4096, 217644, 4),
        (4096, 680975, 1),
        (8192, 108822, 4),
        (8192, 340487, 1),
    ]:
        if only and (T, R, h) != only:
            continue
        run_config(T, R, rng, verbose_ops=verbose, h=h)


if __name__ == "__main__":
    main()
