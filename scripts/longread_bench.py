"""Long-read classify regime (real chip): uncompacted vs compacted path.

Long reads (L > ~2k) skip hash compaction (classify.device.compact_width
returns 0), so the table gather runs over every window position with a
~1/7 emission mask — 7x more probes than emitted hashes. This bench
measures the production kernel at long L to decide whether raising the
compaction ceiling (sort cost grows with M) would pay.

Single-end reads, table shapes as in wide_table_bench.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, "scripts")

import jax
import jax.numpy as jnp
import numpy as np

from ganon_tpu.classify.device import classify_batch_packed, pack_batch_input

from wide_table_bench import trace_jit_total

K, W = 19, 31
N_TRACE = 3


def run_config(T, R, B, L, h):
    # the DeviceFilter layout: u32 word view of a T-byte row
    assert T % 4 == 0
    tbl = jax.jit(
        lambda k: jax.random.bits(k, (R, T // 4), dtype=jnp.uint32)
        & jnp.uint32(0x5B5B5B5B),
    )(jax.random.key(T))
    layout = "u32"
    tbl.block_until_ready()
    byte_starts = jnp.arange(T, dtype=jnp.int32)
    byte_ends = byte_starts + 1

    def mk_inputs(i):
        r = np.random.default_rng(i)
        c1 = r.integers(0, 4, size=(B, L), dtype=np.uint8)
        lens = np.full(B, L, np.int32)
        return (jnp.asarray(pack_batch_input(c1, lens, None, None)),)

    kw = dict(
        k=K, w=W, L1=L, L2=0, bin_size=R, hash_functions=h,
        top_k=min(128, T), pack16=True,
    )

    def fn(inbuf):
        return classify_batch_packed(
            tbl, byte_starts, byte_ends, inbuf,
            jnp.float64(0.25), jnp.float64(0.0), jnp.int32(65535), **kw,
        )

    inputs = [mk_inputs(i) for i in range(N_TRACE + 1)]
    ms, top = trace_jit_total(fn, inputs)
    reads_s = B / (ms / 1e3)
    bp_s = reads_s * L
    print(
        f"T={T:5d} R={R:8d} h={h} {layout} B={B:5d} L={L:6d}: "
        f"{ms:8.2f} ms/batch = {reads_s:9,.0f} reads/s "
        f"({bp_s * 60 / 1e6:8,.0f} Mbp/m)"
    )
    if "-v" in sys.argv:
        for d, nm in top:
            print(f"      {d:8.3f} ms  {nm}")
    return ms


def main():
    print(f"device: {jax.devices()[0]}")
    for T, R, B, L, h in [
        (32, 870575, 8192, 150, 4),      # short single-end baseline
        (32, 870575, 512, 10000, 4),     # long reads, 27 MB table
        (1024, 870575, 512, 10000, 4),   # long reads, 891 MB table
        (1024, 2723899, 512, 10000, 1),  # long reads, h=1
    ]:
        run_config(T, R, B, L, h)


if __name__ == "__main__":
    main()
