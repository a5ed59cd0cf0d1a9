"""Measure the merged-bin pruned kernel at T=8192 on the real chip.

Builds (and caches) a PrunedForest over the bench's T8192 regime, then
times classify_batch_packed_pruned with the bench's kernel methodology
(async per-batch dispatches, block once, best of 3).

Usage: python scripts/pruned_probe.py [T8192|T1024] [S] [group_size]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from bench import (  # noqa: E402
    CACHE_DIR, K, W, READ_LEN, _extract_target_hashes, _genomes,
    family_digest, sample_paired_reads,
)


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "T8192"
    S = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    group_size = int(sys.argv[3]) if len(sys.argv) > 3 else 64


    import jax
    import jax.numpy as jnp

    print("device:", jax.devices()[0])
    t0 = time.time()
    jax.block_until_ready(jnp.ones((8,), jnp.float32).sum())
    print(f"warmup: {time.time() - t0:.1f}s")

    from ganon_tpu.index.pruned import PrunedForest, build_pruned

    path = os.path.join(CACHE_DIR, f"db_{name}_pruned{group_size}.hibf")
    ok = False
    if os.path.exists(path):
        try:
            with open(path + ".family") as f:
                ok = f.read().strip() == family_digest()
        except Exception:
            ok = False
    if ok:
        pf = PrunedForest.load(path)
    else:
        th = _extract_target_hashes(name)
        t0 = time.time()
        pf = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05,
                          group_size=group_size)
        print(f"build_pruned: {time.time() - t0:.1f}s")
        pf.save(path)
        with open(path + ".family", "w") as f:
            f.write(family_digest())
    print(f"fine {pf.fine.nbytes/1e6:.0f} MB, coarse "
          f"{pf.coarse.nbytes/1e6:.0f} MB, {pf.num_groups} groups, "
          f"coarse_bin {pf.coarse_bin_size}")

    from ganon_tpu.classify import device as dev

    f = dev.DevicePrunedForest(pf)
    print("ftbl dtype", f.ftbl.dtype, "ctbl dtype", f.ctbl.dtype)

    genomes = _genomes(name)
    rng = np.random.default_rng(7)
    B = 8192
    n_batches = 8
    batches = []
    for _ in range(n_batches):
        r1, r2, ln = sample_paired_reads(rng, genomes, B)
        # pack as the engine does
        L = READ_LEN
        Lb = dev.bucket_len(L)
        c1 = np.zeros((B, Lb), np.uint8)
        c2 = np.zeros((B, Lb), np.uint8)
        c1[:, :L] = r1
        c2[:, :L] = r2
        ib = dev.pack_batch_input(c1, ln, c2, ln)
        batches.append((jnp.asarray(ib), Lb))
    jax.block_until_ready([b for b, _ in batches])

    def step(ib, Lb):
        return dev.classify_batch_packed_pruned(
            f.ctbl, f.ftbl, f.grp_row_off, f.grp_bin_size, f.grp_shift,
            f.grp_ntargets, ib,
            jnp.float64(0.75), jnp.float64(0.1), jnp.int32(65535),
            k=K, w=W, L1=Lb, L2=Lb,
            coarse_bin_size=pf.coarse_bin_size, coarse_h=pf.coarse_h,
            fine_h=pf.fine_h, max_groups=S, group_size=pf.group_size,
            num_targets=f.num_targets, top_k=4,
            match_cap=2 * B,
        )

    t0 = time.time()
    r = step(*batches[0])
    jax.block_until_ready(r)
    print(f"compile+first: {time.time() - t0:.1f}s, out {r.shape}")
    # sanity: unpack and report match stats
    res = dev.unpack_batch_result_ragged(np.asarray(r), B, 2 * B,
                                         f.num_targets, 4)
    print("cap_overflow:", res["cap_overflow"],
          "classified:", int(res["seqs_classified"]),
          "overflow reads:", int(res["overflow"].sum()))

    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        outs = [step(ib, Lb) for ib, Lb in batches]
        jax.block_until_ready(outs)
        np.asarray(outs[-1])  # fetch-fence
        best = min(best, time.time() - t0)
    rate = B * n_batches / best
    print(f"pruned kernel {name} S={S} gs={group_size}: "
          f"{rate:,.0f} reads/s ({best*1000/n_batches:.1f} ms/batch)")


if __name__ == "__main__":
    main()
