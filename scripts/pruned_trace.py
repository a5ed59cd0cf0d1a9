"""Device-op trace of classify_batch_packed_pruned (see trace_batch.py)."""

import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


import bench
from bench import CACHE_DIR, K, W, READ_LEN, _genomes, sample_paired_reads
from ganon_tpu.classify import device as dev
from ganon_tpu.index.pruned import PrunedForest

B = 8192
N_TRACE = 3


def main(name="T8192", S=2, gs=64):
    pf = PrunedForest.load(
        os.path.join(CACHE_DIR, f"db_{name}_pruned.hibf")
    )
    f = dev.DevicePrunedForest(pf)
    genomes = _genomes(name)
    rng = np.random.default_rng(7)

    def make_batch(i):
        r1, r2, ln = sample_paired_reads(np.random.default_rng(i), genomes, B)
        L = READ_LEN
        Lb = dev.bucket_len(L)
        c1 = np.zeros((B, Lb), np.uint8)
        c2 = np.zeros((B, Lb), np.uint8)
        c1[:, :L] = r1
        c2[:, :L] = r2
        return jnp.asarray(dev.pack_batch_input(c1, ln, c2, ln)), Lb

    def run(ib, Lb):
        return dev.classify_batch_packed_pruned(
            f.ctbl, f.ftbl, f.grp_row_off, f.grp_bin_size, f.grp_shift,
            f.grp_ntargets, ib,
            jnp.float64(0.75), jnp.float64(0.1), jnp.int32(65535),
            k=K, w=W, L1=Lb, L2=Lb,
            coarse_bin_size=pf.coarse_bin_size, coarse_h=pf.coarse_h,
            fine_h=pf.fine_h, max_groups=int(S), group_size=pf.group_size,
            num_targets=f.num_targets, top_k=4, match_cap=2 * B,
        )

    jax.block_until_ready(jnp.ones((8,)).sum())
    t0 = time.time()
    np.asarray(run(*make_batch(0)))
    print(f"warm: {time.time() - t0:.1f}s")

    tracedir = os.path.join("chiprun_out", "pruned_trace")
    shutil.rmtree(tracedir, ignore_errors=True)
    bufs = [make_batch(i + 1) for i in range(N_TRACE)]
    with jax.profiler.trace(tracedir):
        outs = [run(*b) for b in bufs]
        for o in outs:
            np.asarray(o)

    from xplane_parse import latest_xplane, op_durations

    durs = op_durations(latest_xplane(tracedir))
    print("== device ops ==")
    total = 0.0
    for opname, d in sorted(durs.items(), key=lambda kv: -kv[1])[:30]:
        total += d
        print(f"  {d/N_TRACE*1e3:9.3f} ms  {opname[:150]}")
    print(f"  total (top30): {total/N_TRACE*1e3:.1f} ms/batch")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
