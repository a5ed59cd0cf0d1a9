"""Probe-locality experiment: sorted vs unsorted wide-table gathers.

Sorts each batch's row indices so the device-memory gather walks the
table quasi-sequentially instead of randomly, inside the REAL packed
program (classify_batch_packed sort_probes=True; the count sums over the
hash axis, so the permutation needs no undo and exactness is free —
asserted here). Runs on db_T1024, the wide flat-table regime.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


import jax
import jax.numpy as jnp

import bench
from bench import BATCH, K, READ_LEN, W, _genomes, build_database, \
    sample_paired_reads
from ganon_tpu.classify import device as dev
from ganon_tpu.ops.ibf_query import pack_table_u8, table_as_u32


def main(name="T1024"):
    genomes, ibf, _ = build_database(name)
    cfg = ibf.ibf_config
    T = len(ibf.targets())
    tbl8np, bs, be = pack_table_u8(ibf.bits, ibf.bin_to_target_ids(), T)
    tbl8 = jax.device_put(table_as_u32(tbl8np))
    bs, be = jnp.asarray(bs), jnp.asarray(be)
    print(f"T={T} table={tbl8np.nbytes/1e6:.0f}MB dtype={tbl8.dtype} "
          f"h={cfg.hash_functions}")
    jax.block_until_ready(jnp.ones((8,)).sum())

    rng = np.random.default_rng(7)
    B, L = BATCH, READ_LEN
    Lb = dev.bucket_len(L)
    batches = []
    for _ in range(8):
        r1, r2, ln = sample_paired_reads(rng, genomes, B)
        c1 = np.zeros((B, Lb), np.uint8)
        c2 = np.zeros((B, Lb), np.uint8)
        c1[:, :L] = r1
        c2[:, :L] = r2
        batches.append(jnp.asarray(dev.pack_batch_input(c1, ln, c2, ln)))
    jax.block_until_ready(batches)

    def step(ib, sp):
        return dev.classify_batch_packed(
            tbl8, bs, be, ib, jnp.float64(0.75), jnp.float64(0.1),
            jnp.int32(65535),
            k=K, w=W, L1=Lb, L2=Lb, bin_size=cfg.bin_size_bits,
            hash_functions=cfg.hash_functions,
            top_k=32, pack16=True, match_cap=2 * B, sort_probes=sp,
        )

    # exactness: identical packed outputs
    a = np.asarray(step(batches[0], False))
    b = np.asarray(step(batches[0], True))
    assert np.array_equal(a, b), "sorted-probe path changed results!"
    print("outputs identical")

    for sp in (False, True, False, True):
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            outs = [step(ib, sp) for ib in batches]
            jax.block_until_ready(outs)
            np.asarray(outs[-1])
            best = min(best, time.time() - t0)
        rate = B * len(batches) / best
        print(f"sort_probes={sp}: {rate:,.0f} reads/s "
              f"({best*1000/len(batches):.1f} ms/batch)")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
