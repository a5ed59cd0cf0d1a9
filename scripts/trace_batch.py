"""Device-op trace of the production classify_batch_packed dispatch.

Traces a few production batches on the GPU and prints the top device ops
per batch from the trace (scripts/xplane_parse.py).

    python scripts/trace_batch.py [db.ibf]
"""

import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


from ganon_tpu.index.ibf import IBF
from ganon_tpu.ops.ibf_query import pack_table_u8, table_as_u32
from ganon_tpu.classify.device import classify_batch_packed, pack_batch_input
from xplane_parse import latest_xplane, op_durations

K, W = 19, 31
B, L = 8192, 150
N_TRACE = 3


def main(db=".bench_cache/db_T32.ibf"):
    ibf = IBF.load(db)
    cfg = ibf.ibf_config
    T = len(ibf.targets())
    tbl8np, bsnp, benp = pack_table_u8(ibf.bits, ibf.bin_to_target_ids(), T)
    tbl = jax.device_put(table_as_u32(tbl8np))  # the DeviceFilter layout
    bs, be = jnp.asarray(bsnp), jnp.asarray(benp)
    print(f"T={T} table={tbl8np.nbytes/1e6:.1f}MB")

    rng = np.random.default_rng(0)

    def make_batch(i):
        rng2 = np.random.default_rng(i)
        codes1 = rng2.integers(0, 4, size=(B, L), dtype=np.uint8)
        codes2 = rng2.integers(0, 4, size=(B, L), dtype=np.uint8)
        lens = np.full((B,), L, dtype=np.int32)
        return pack_batch_input(codes1, lens, codes2, lens)

    def run(buf):
        # python-scalar thresholds: same jit signature as the engine,
        # so the persistent compile cache from bench/e2e runs hits
        return classify_batch_packed(
            tbl, bs, be, jnp.asarray(buf),
            0.25, 0.0, 65535,
            k=K, w=W, L1=L, L2=L,
            bin_size=cfg.bin_size_bits,
            hash_functions=cfg.hash_functions,
            top_k=min(128, T), pack16=True,
        )

    np.asarray(run(make_batch(0)))  # warm

    tracedir = os.path.join("chiprun_out", "trace_batch")
    shutil.rmtree(tracedir, ignore_errors=True)
    bufs = [make_batch(i + 1) for i in range(N_TRACE)]
    with jax.profiler.trace(tracedir):
        outs = [run(b) for b in bufs]
        for o in outs:
            np.asarray(o)

    durs = op_durations(latest_xplane(tracedir))
    print("== device ops ==")
    for name, d in sorted(durs.items(), key=lambda kv: -kv[1])[:30]:
        print(f"  {d/N_TRACE*1e3:9.3f} ms  {name[:150]}")
    print(f"  (sum: {sum(durs.values())/N_TRACE*1e3:.3f} ms/batch)")


if __name__ == "__main__":
    main(*sys.argv[1:])
