"""Variant sweep for the pruned kernel: (S, fine_h, coarse_h/fp, B).

One process, all variants (each program compiles once). The defaults
(fine_h=1, coarse_h=1) are database-format values; this sweep is how to
retune them on a given device.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


import jax
import jax.numpy as jnp

import bench
from bench import CACHE_DIR, K, W, READ_LEN, _extract_target_hashes, \
    _genomes, family_digest, sample_paired_reads
from ganon_tpu.classify import device as dev
from ganon_tpu.index.pruned import PrunedForest, build_pruned


def get_db(name, fine_h, coarse_h, coarse_fp, gs):
    tag = f"{name}_p_g{gs}_f{fine_h}_c{coarse_h}_{coarse_fp}"
    path = os.path.join(CACHE_DIR, f"db_{tag}.hibf")
    if os.path.exists(path):
        try:
            with open(path + ".family") as f:
                if f.read().strip() == family_digest():
                    return PrunedForest.load(path)
        except Exception:
            pass
    th = _extract_target_hashes(name)
    t0 = time.time()
    pf = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05,
                      fine_h=fine_h, coarse_h=coarse_h,
                      coarse_fp=coarse_fp, group_size=gs)
    print(f"  built {tag}: {time.time()-t0:.0f}s fine "
          f"{pf.fine.nbytes/1e6:.0f}MB coarse {pf.coarse.nbytes/1e6:.0f}MB")
    pf.save(path)
    with open(path + ".family", "w") as f:
        f.write(family_digest())
    return pf


def time_variant(name, genomes, pf, S, B, n_batches=8, Lb=None,
                 pair_cap=0):
    f = dev.DevicePrunedForest(pf)
    rng = np.random.default_rng(7)
    L = READ_LEN
    if Lb is None:
        Lb = dev.bucket_len(L)
    batches = []
    for _ in range(n_batches):
        r1, r2, ln = sample_paired_reads(rng, genomes, B)
        c1 = np.zeros((B, Lb), np.uint8)
        c2 = np.zeros((B, Lb), np.uint8)
        c1[:, :L] = r1
        c2[:, :L] = r2
        batches.append(jnp.asarray(dev.pack_batch_input(c1, ln, c2, ln)))
    jax.block_until_ready(batches)

    def step(ib):
        return dev.classify_batch_packed_pruned(
            f.ctbl, f.ftbl, f.grp_row_off, f.grp_bin_size, f.grp_shift,
            f.grp_ntargets, ib,
            jnp.float64(0.75), jnp.float64(0.1), jnp.int32(65535),
            k=K, w=W, L1=Lb, L2=Lb,
            coarse_bin_size=pf.coarse_bin_size, coarse_h=pf.coarse_h,
            fine_h=pf.fine_h, max_groups=S, group_size=pf.group_size,
            num_targets=f.num_targets, top_k=4, match_cap=2 * B,
            pair_cap=pair_cap,
        )

    t0 = time.time()
    r = step(batches[0])
    jax.block_until_ready(r)
    tc = time.time() - t0
    res = dev.unpack_batch_result_ragged(np.asarray(r), B, 2 * B,
                                         f.num_targets, 4)
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        outs = [step(ib) for ib in batches]
        jax.block_until_ready(outs)
        np.asarray(outs[-1])  # fetch-fence
        best = min(best, time.time() - t0)
    rate = B * n_batches / best
    print(f"S={S} fh={pf.fine_h} ch={pf.coarse_h} cfp={pf.coarse_fp} "
          f"B={B} Lb={Lb} P={pair_cap}: "
          f"{rate:,.0f} reads/s ({best*1000/n_batches:.1f} ms/b; "
          f"compile+first {tc:.0f}s; cls {int(res['seqs_classified'])}, "
          f"ovf {int(res['overflow'].sum())})")
    return rate


def main():
    name = "T8192"
    print("device:", jax.devices()[0])
    jax.block_until_ready(jnp.ones((8,)).sum())
    genomes = _genomes(name)
    variants = [
        # (S, fine_h, coarse_h, coarse_fp, B, Lb, pair_cap)
        (2, 1, 1, 0.1, 8192, 160, 0),        # round-4 best (dense slots)
        (1, 1, 1, 0.1, 8192, 160, 0),        # S=1 floor (info only)
        (2, 1, 1, 0.1, 8192, 160, 8192),     # pairs = 1.00 B
        (2, 1, 1, 0.1, 8192, 160, 10240),    # pairs = 1.25 B
        (2, 1, 1, 0.1, 8192, 160, 12288),    # pairs = 1.50 B
    ]
    for S, fh, ch, cfp, B, Lb, pc in variants:
        pf = get_db(name, fh, ch, cfp, 64)
        try:
            time_variant(name, genomes, pf, S, B, Lb=Lb, pair_cap=pc)
        except Exception as e:
            print(f"variant failed: {e!r}")


if __name__ == "__main__":
    main()
