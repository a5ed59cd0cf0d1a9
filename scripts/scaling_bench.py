"""Scaling-efficiency benchmark over a (batch, bins) device mesh.

Runs the sharded classify step over 1..N of the available devices and
reports reads/s per mesh shape plus scaling efficiency vs 1 device.
On a single GPU this degenerates to the 1-device row; on a multi-GPU
host or a multi-host run (launch identically on every host under
`jax.distributed`, e.g. with JAX_COORDINATOR_ADDRESS set) it sweeps
mesh shapes.

Usage: python scripts/scaling_bench.py [--targets 256] [--batches 8]
       [--batch 8192] [--virtual N]   (N virtual CPU devices, for
       validating the sweep logic without hardware — timings on the
       CPU backend are NOT representative of a GPU)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", type=int, default=256)
    ap.add_argument("--hashes-per-target", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--virtual", type=int, default=0)
    args = ap.parse_args()

    if args.virtual:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()

    import jax
    import numpy as np

    from ganon_tpu.index.ibf import build_ibf
    from ganon_tpu.parallel.mesh import ShardedClassifier, make_mesh
    from ganon_tpu.parallel.multihost import maybe_initialize

    pi, pc = maybe_initialize()
    devices = jax.devices()
    print(
        f"process {pi}/{pc}, {len(devices)} device(s): {devices[0]}",
        file=sys.stderr,
    )

    rng = np.random.default_rng(0)
    th = {
        f"T{i}": np.unique(
            rng.integers(
                0, 2**62, size=args.hashes_per_target, dtype=np.uint64
            )
        )
        for i in range(args.targets)
    }
    ibf = build_ibf(th, kmer_size=19, window_size=31, max_fp=0.05)

    codes = rng.integers(
        0, 4, size=(args.batch, args.read_len), dtype=np.uint8
    )
    lengths = np.full(args.batch, args.read_len, np.int32)

    base = None
    n = 1
    while n <= len(devices):
        mesh = make_mesh(devices[:n])
        clf = ShardedClassifier(ibf, mesh)
        counts, _ = clf.counts(codes, lengths)  # compile
        counts.block_until_ready()
        t0 = time.time()
        for _ in range(args.batches):
            counts, _ = clf.counts(codes, lengths)
        counts.block_until_ready()
        dt = time.time() - t0
        rps = args.batch * args.batches / dt
        if base is None:
            base = rps
        eff = rps / (base * n)
        print(
            f"devices={n:3d} mesh=(batch={mesh.shape['batch']},"
            f"bins={mesh.shape['bins']}): {rps:12,.0f} reads/s "
            f"(x{rps / base:5.2f}, efficiency {eff:5.1%})"
        )
        n *= 2


if __name__ == "__main__":
    main()
