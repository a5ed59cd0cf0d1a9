"""Build-side scaling probe on the virtual CPU mesh: count pass + scatter.

Times DeviceBuildPipeline's two passes (group-parallel counting; mesh
scatter) with 1 vs N virtual devices at a few input sizes. CPU-backend
timings validate that the distribution machinery adds no serial
regression; absolute speedups are only meaningful on real multi-device
hardware (the virtual devices share host cores).

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python scripts/build_scaling_probe.py [--mbp 4 8] [--targets 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import ganon_tpu  # noqa: F401  (honors JAX_PLATFORMS before jax inits)
import numpy as np

K, W = 19, 31


def run_once(seqs_by_target, devices, mesh=None):
    import jax

    from ganon_tpu.index import sizing
    from ganon_tpu.index.device_build import DeviceBuildPipeline
    from ganon_tpu.ops.minimizers import encode_seqs

    pipe = DeviceBuildPipeline(K, W, devices=devices)
    try:
        t0 = time.time()
        for target, seqs in seqs_by_target.items():
            for fi, s in enumerate(seqs):
                enc, _ = encode_seqs([s], max_len=len(s))
                pipe.add_sequence((target, fi), enc[0])
        pipe.finish_counts()
        hashes_count = {t: c for t, c in pipe.hashes_count().items() if c}
        t_count = time.time() - t0
        icfg = sizing.size_filter(
            hashes_count, kmer_size=K, window_size=W, max_fp=0.05
        )
        t0 = time.time()
        bits = pipe.scatter(icfg, mesh=mesh)
        t_scatter = time.time() - t0
        return t_count, t_scatter, bits
    finally:
        pipe.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, nargs="+", default=[2.0, 8.0])
    ap.add_argument("--targets", type=int, default=8)
    args = ap.parse_args()

    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    print(f"{len(devs)} devices ({devs[0].platform})")
    bases = "ACGT"
    for mbp in args.mbp:
        per_t = int(mbp * 1e6 / args.targets)
        rng = np.random.default_rng(1)
        seqs = {
            f"T{t}": ["".join(
                bases[b] for b in rng.integers(0, 4, size=per_t)
            )]
            for t in range(args.targets)
        }
        c1, s1, b1 = run_once(seqs, [devs[0]])
        mesh = Mesh(np.asarray(devs).reshape(-1), ("bins",))
        cN, sN, bN = run_once(seqs, list(devs), mesh=mesh)
        same = np.array_equal(b1, bN)
        print(
            f"{mbp:5.1f} Mbp x{args.targets}t  "
            f"count 1dev {c1:6.2f}s  {len(devs)}dev {cN:6.2f}s  "
            f"scatter 1dev {s1:5.2f}s  mesh {sN:5.2f}s  "
            f"bit-identical={same}"
        )
        assert same


if __name__ == "__main__":
    main()
