"""Mixed-length (nanopore-style) classify: bucketing ON vs OFF.

Generates a log-normal length distribution (median ~2 kb, tail to
~50 kb — a typical nanopore run) against the bench T32 database and
runs the FULL run_classify with length bucketing enabled vs disabled.
Without bucketing, one long record pads every read in its batch to the
same width, multiplying the hashing work; with bucketing each length
class pays only its own width. Not part of the test suite.

Usage: python scripts/mixedlen_bench.py [n_reads_total]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

K, W = 19, 31
N_TARGETS = 32
GENOME_LEN = 1_000_000


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000

    from ganon_tpu.classify.engine import ClassifyConfig, run_classify

    db = os.path.join(
        os.path.dirname(__file__), "..", ".bench_cache", "db_T32.ibf"
    )
    if not os.path.exists(db):
        sys.exit("run `python bench.py` once to build .bench_cache dbs")

    rng = np.random.default_rng(42)
    genomes = rng.integers(0, 4, size=(N_TARGETS, GENOME_LEN), dtype=np.uint8)

    tmp = "/tmp/mixedlen_bench"
    os.makedirs(tmp, exist_ok=True)
    fq = os.path.join(tmp, "reads.fq")
    rr = np.random.default_rng(11)
    # discrete nanopore-ish length classes (weights ~ log-normal mass):
    # a continuous distribution would compile one program per 64-multiple
    # bucket, each a compile
    classes = np.array([500, 1000, 2000, 4000, 8000, 16000])
    weights = np.array([0.15, 0.2, 0.3, 0.2, 0.1, 0.05])
    lens = rr.choice(classes, size=n, p=weights / weights.sum())
    base = np.frombuffer(b"ACGT", dtype=np.uint8)
    total_bp = int(lens.sum())
    with open(fq, "wb") as f:
        for i in range(n):
            ln = int(lens[i])
            t = rr.integers(0, N_TARGETS)
            s = rr.integers(0, GENOME_LEN - ln)
            seq = base[genomes[t, s : s + ln]].tobytes()
            f.write(b"@q%d\n%s\n+\n%s\n" % (i, seq, b"I" * ln))
    print(f"{n} reads, {total_bp/1e6:.1f} Mbp, median "
          f"{int(np.median(lens))} bp, max {int(lens.max())} bp",
          file=sys.stderr)

    results = {}
    for bucketing in (True, False):
        kw = dict(
            ibf=[db], single_reads=[fq],
            output_prefix=os.path.join(tmp, f"res_{bucketing}"),
            rel_cutoff=[0.25], output_all=True,
            length_bucketing=bucketing, quiet=True,
        )
        run_classify(ClassifyConfig(**kw))  # warmup/compile
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            run_classify(ClassifyConfig(**kw))
            best = min(best, time.time() - t0)
        results[bucketing] = best
        print(f"bucketing={bucketing}: {n/best:,.0f} reads/s "
              f"({total_bp/1e6/(best/60):,.0f} Mbp/m)", file=sys.stderr)
    print(f"speedup: {results[False]/results[True]:.2f}x")


if __name__ == "__main__":
    main()
