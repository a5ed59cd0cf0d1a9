"""Stage-level device timing for the classify hot path.

Times each jitted stage of the fused classify step separately on the
bench database (.bench_cache/db.ibf) so kernel work targets the real
bottleneck. Not part of the test suite.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from ganon_tpu.index.ibf import IBF
from ganon_tpu.ops.minimizers import minimizers_masked_jax
from ganon_tpu.ops.ibf_query import (
    bulk_target_counts_packed,
    compact_hashes,
    ibf_row_indices,
    pack_table_u8,
    table_as_u32,
)
from ganon_tpu.classify.device import (
    classify_counts_fused,
    compact_width,
    threshold_topk,
)

K, W = 19, 31
B, L = 8192, 150
REPS = 20


def timeit(name, fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / REPS
    print(f"{name:34s} {dt*1e3:8.3f} ms  {B/dt/1e6:8.2f} Mreads/s")
    return out


def main():
    ibf = IBF.load(".bench_cache/db.ibf")
    cfg = ibf.ibf_config
    T = len(ibf.targets())
    tbl8, bs, be = pack_table_u8(ibf.bits, ibf.bin_to_target_ids(), T)
    print(f"table [{tbl8.shape[0]} x {tbl8.shape[1]}] bytes, "
          f"S={cfg.hash_functions}, T={T}")

    rng = np.random.default_rng(0)
    codes1 = jnp.asarray(rng.integers(0, 4, size=(B, L), dtype=np.uint8))
    codes2 = jnp.asarray(rng.integers(0, 4, size=(B, L), dtype=np.uint8))
    len1 = jnp.full((B,), L, dtype=jnp.int32)
    m1 = L - W + 1

    ext = jax.jit(lambda c, l: minimizers_masked_jax(c, l, k=K, w=W))
    h1, e1, n1 = timeit("minimizers (one mate)", ext, codes1, len1)

    hashes = jnp.concatenate([h1[:, :m1], h1[:, :m1]], axis=1)
    mask = jnp.concatenate([e1[:, :m1], e1[:, :m1]], axis=1)
    mc = compact_width(2 * m1)
    comp = jax.jit(lambda h, m: compact_hashes(h, m, max_compact=mc))
    hc, mcm, ovf = timeit(f"compact_hashes -> {mc}", comp, hashes, mask)

    rowf = jax.jit(
        lambda h: ibf_row_indices(
            h, bin_size=cfg.bin_size_bits, hash_functions=cfg.hash_functions
        )
    )
    rows = timeit("ibf_row_indices", rowf, hc)

    tbl = jnp.asarray(table_as_u32(tbl8))
    bs, be = jnp.asarray(bs), jnp.asarray(be)
    cntf = jax.jit(lambda r, m: bulk_target_counts_packed(tbl, r, m, bs, be))
    counts = timeit("gather+AND+popcount+segsum", cntf, rows, mcm)

    thr = jax.jit(
        lambda c, n: threshold_topk(
            c, n, jnp.float32(0.25), jnp.float32(0.0), jnp.int32(65535),
            top_k=32,
        )
    )
    timeit("threshold_topk", thr, counts, n1 * 2)

    fused = jax.jit(
        lambda c1, l1, c2, l2: classify_counts_fused(
            tbl, bs, be, c1, l1, c2, l2,
            k=K, w=W, m1=m1, m2=m1,
            bin_size=cfg.bin_size_bits, hash_functions=cfg.hash_functions,
        )
    )
    timeit("FUSED end-to-end", fused, codes1, len1, codes2, len1)


if __name__ == "__main__":
    main()
