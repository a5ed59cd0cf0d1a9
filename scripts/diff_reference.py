"""Differential rig against real reference binaries (when on PATH).

When `ganon-build` / `ganon-classify` (the reference C++ binaries,
GanonBuild.cpp / GanonClassify.cpp) are installed, this script
cross-validates byte-level compatibility in both directions:

  1. reference ganon-build -> our read_ibf -> our classify
     vs reference ganon-classify on the same reads (sorted .all equal);
  2. our build (--filter-format reference) -> reference ganon-classify
     vs our classify (sorted .all equal).

The binaries cannot be built in this environment (seqan3 submodule not
vendored), so this runs opportunistically: tests/test_diff_reference.py
invokes it automatically whenever the binaries appear on PATH and skips
otherwise. Exit 0 = all comparisons equal.

Usage: python scripts/diff_reference.py [workdir]
       python scripts/diff_reference.py --time [threads] [workdir]

`--time` is the CPU-baseline scaffold (BASELINE.md north star): it
builds a db from the reference's bundled real assemblies with the
reference `ganon-build`, then times reference `ganon-classify`
(default 24 threads) on the same x256-replicated sim reads that
`bench.py` measures as `extra.e2e_refdata` — making the
accelerator-vs-24-thread-CPU comparison one command the day binaries
exist.
"""

import os
import random
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

K, W = 19, 31


def have_binaries() -> bool:
    return bool(
        shutil.which("ganon-build") and shutil.which("ganon-classify")
    )


def _mkseq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _write_inputs(d):
    rng = random.Random(11)
    refs = {f"tgt{i}": _mkseq(rng, 600) for i in range(5)}
    ti = os.path.join(d, "target_info.tsv")
    with open(ti, "w") as f:
        for t, s in refs.items():
            p = os.path.join(d, f"{t}.fa")
            with open(p, "w") as g:
                g.write(f">{t}\n{s}\n")
            f.write(f"{p}\t{t}\n")
    reads = {}
    for i, (t, s) in enumerate(sorted(refs.items())):
        reads[f"r{i}"] = s[20:170]
    reads["junk"] = _mkseq(rng, 150)
    fq = os.path.join(d, "reads.fq")
    with open(fq, "w") as f:
        for rid, s in reads.items():
            f.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n")
    return ti, fq


def _run(cmd):
    print("+", " ".join(cmd), file=sys.stderr)
    subprocess.run(cmd, check=True)


def _our_classify(db, fq, out):
    from ganon_tpu.classify.engine import ClassifyConfig, run_classify

    run_classify(ClassifyConfig(
        ibf=[db], single_reads=[fq], output_prefix=out,
        rel_cutoff=[0.25], rel_filter=[1.0], fpr_query=[1.0],
        output_all=True, quiet=True,
    ))
    return out + ".all"


def _ref_classify(db, fq, out):
    _run([
        "ganon-classify", "--single-reads", fq, "--ibf", db,
        "--output-prefix", out, "--output-all",
        "--rel-cutoff", "0.25", "--rel-filter", "1.0",
        "--fpr-query", "1.0", "--threads", "2",
    ])
    return out + ".all"


def _sorted_lines(path):
    with open(path) as f:
        return sorted(line.rstrip("\n") for line in f if line.strip())


def main(workdir="/tmp/diff_reference"):
    if not have_binaries():
        sys.exit("reference binaries not on PATH; nothing to diff")
    os.makedirs(workdir, exist_ok=True)
    ti, fq = _write_inputs(workdir)

    failures = []

    # direction 1: reference build -> both classifiers
    ref_db = os.path.join(workdir, "ref_built.ibf")
    _run(["ganon-build", "--input-file", ti, "--output-file", ref_db,
          "--kmer-size", str(K), "--window-size", str(W),
          "--max-fp", "0.05", "--threads", "2"])
    ours = _sorted_lines(
        _our_classify(ref_db, fq, os.path.join(workdir, "ours_on_ref")))
    refs = _sorted_lines(
        _ref_classify(ref_db, fq, os.path.join(workdir, "ref_on_ref")))
    if ours != refs:
        failures.append(("ref-built db", ours, refs))

    # direction 2: our build (reference format) -> both classifiers
    from ganon_tpu.index.builder import BuildConfig, run_build

    our_db = os.path.join(workdir, "ours_built.ibf")
    run_build(BuildConfig(
        input_file=ti, output_file=our_db, kmer_size=K, window_size=W,
        max_fp=0.05, filter_format="reference",
    ))
    ours2 = _sorted_lines(
        _our_classify(our_db, fq, os.path.join(workdir, "ours_on_ours")))
    refs2 = _sorted_lines(
        _ref_classify(our_db, fq, os.path.join(workdir, "ref_on_ours")))
    if ours2 != refs2:
        failures.append(("our-built db", ours2, refs2))

    if failures:
        for label, a, b in failures:
            print(f"MISMATCH [{label}]:", file=sys.stderr)
            for line in sorted(set(a) ^ set(b))[:20]:
                side = "ours" if line in a else "ref"
                print(f"  {side}: {line}", file=sys.stderr)
        sys.exit(1)
    print("all cross-comparisons equal")


def main_time(threads="24", workdir="/tmp/diff_reference_time"):
    """CPU-ganon reads/s on the bench's refdata input (see module doc)."""
    import glob
    import gzip
    import time

    if not have_binaries():
        sys.exit("reference binaries not on PATH; nothing to time")
    data = "/root/reference/tests/ganon/data"
    os.makedirs(workdir, exist_ok=True)

    # db from the bundled real assemblies (reference builder)
    ti = os.path.join(workdir, "target_info.tsv")
    with open(ti, "w") as f:
        for p in sorted(
            glob.glob(os.path.join(data, "build-custom/files/*.fna.gz"))
        ):
            t = os.path.basename(p).split("_genomic")[0]
            f.write(f"{p}\t{t}\n")
    db = os.path.join(workdir, "refdata.ibf")
    if not os.path.exists(db):
        _run(["ganon-build", "--input-file", ti, "--output-file", db,
              "--kmer-size", str(K), "--window-size", str(W),
              "--max-fp", "0.05", "--threads", threads])

    # the same x1024-replicated sim reads bench.py times (reuse the
    # bench cache when present)
    reps = 1024
    cache = os.path.join(os.path.dirname(__file__), "..", ".bench_cache")
    fqs = []
    for m in (1, 2):
        dst = os.path.join(cache, f"refdata_sim{reps}.{m}.fq")
        if not os.path.exists(dst):
            dst = os.path.join(workdir, f"refdata_sim{reps}.{m}.fq")
            if not os.path.exists(dst):
                with gzip.open(
                    os.path.join(data, f"classify/sim.{m}.fq.gz"), "rb"
                ) as f:
                    payload = f.read()
                with open(dst, "wb") as f:
                    for _ in range(reps):
                        f.write(payload)
        fqs.append(dst)
    n_reads = sum(1 for _ in open(fqs[0], "rb")) // 4

    out = os.path.join(workdir, "cpu")
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        _run([
            "ganon-classify", "--paired-reads", fqs[0], fqs[1],
            "--ibf", db, "--output-prefix", out,
            "--rel-cutoff", "0.25", "--threads", threads,
        ])
        best = min(best, time.time() - t0)
    print(
        f"cpu ganon-classify ({threads} threads): "
        f"{n_reads / best:,.0f} reads/s ({n_reads} reads, best of 3; "
        f"compare extra.e2e_refdata in BENCH_r*.json)"
    )


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--time":
        main_time(*sys.argv[2:])
    else:
        main(*sys.argv[1:])
