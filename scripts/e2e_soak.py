"""1M-pair sustained e2e soak on the pruned T8192 path.

Drives the FULL engine (fastq parse -> pruned kernel -> thresholds ->
LCA -> .one/.all/.unc/.rep) over 1,048,576 paired 150 bp reads in one
process, fetch-fenced, and prints the per-term wall split (input_wait /
dispatch / fetch / finish). The first pass in a fresh process pays
start-up and compilation; the WARM pass is the sustained number.

Usage: python scripts/e2e_soak.py [n_reads]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import bench
from bench import CACHE_DIR, _e2e_kw, _reads_fastq, build_pruned_database
from ganon_tpu.classify.engine import ClassifyConfig, run_classify


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_048_576
    genomes, _, db = build_pruned_database("T8192")
    fq = _reads_fastq("T8192", genomes, n)
    kw = _e2e_kw([db], fq, "e2e_soak")
    for label in ("cold", "warm", "warm2"):
        t0 = time.time()
        stats = run_classify(ClassifyConfig(**kw))
        dt = time.time() - t0
        timing = {k: round(v, 2)
                  for k, v in stats.get("timing", {}).items()}
        cls = sum(t.seqs_classified for t in stats["totals"].values())
        print(f"{label}: {n/dt:,.0f} reads/s ({dt:.1f}s) "
              f"classified {cls} split {timing}")


if __name__ == "__main__":
    main()
