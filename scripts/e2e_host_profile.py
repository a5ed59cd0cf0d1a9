"""cProfile of a warm e2e pass on the pruned T8192 path.

The 1M-pair soak is host-bound (dispatch + finish ~= wall; device fully
overlapped), so the next e2e lever is whatever Python the main thread
runs per batch. Profiles the SECOND run_classify pass (warm shapes) and
prints the top host functions by cumulative time. Writer-thread work
(line formatting) shows under the Thread.run tree.

Usage: python scripts/e2e_host_profile.py [n_reads]
"""

import cProfile
import io
import os
import pstats
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import bench
from bench import _e2e_kw, _reads_fastq, build_pruned_database
from ganon_tpu.classify.engine import ClassifyConfig, run_classify


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 262_144
    genomes, _, db = build_pruned_database("T8192")
    fq = _reads_fastq("T8192", genomes, n)
    kw = _e2e_kw([db], fq, "e2e_prof")
    run_classify(ClassifyConfig(**kw))  # warm (compiles + stall)
    pr = cProfile.Profile()
    pr.enable()
    run_classify(ClassifyConfig(**kw))
    pr.disable()
    s = io.StringIO()
    ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
    ps.print_stats(40)
    print(s.getvalue())


if __name__ == "__main__":
    main()
