"""Smoke run of ganon-tpu on an NVIDIA GPU: build-custom + classify, checked.

    python chip_smoke.py               # one GPU, every single-device phase
    python chip_smoke.py --four-gpus   # only the multi-device path, 4 GPUs

The default run builds a flat IBF shaped like RefSeq archaea complete
genomes (about 1,000 genomes of 2.5 Mbp) and a merged-bin pruned HIBF
shaped like RefSeq viral (8,192 targets of 50 kbp, cut from the full set
for time), classifies a million seeded 2x150 bp read pairs and a thousand
long reads against them through ``ganon_tpu.cli.main``, and checks:

* every database layout (flat, pruned, forest, raptor, multi-filter,
  hierarchy) gives byte-identical sorted ``.all/.one/.rep/.unc`` to the
  same CLI run on the CPU backend in a child process;
* a few hundred reads match the independent numpy oracle of
  ``tests/test_fuzz_equivalence.py``;
* the device-built bit-matrix equals the host-array build on a
  64-target cut, and at full size every inserted minimizer of a sample
  of targets is set in its bins;
* the tests marked ``gpu`` pass.

Everything runs in this one process, which opens the card; the only child
is the CPU reference run, which sets ``JAX_PLATFORMS=cpu`` before it
imports JAX. All data is generated from ``--seed``. The last line of
standard output is one JSON object; it is printed only when every phase
passed, and the exit code is 0 only then.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K, W = 19, 31
READ_LEN = 150
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# full sizes: the reference's default RefSeq archaea complete-genomes
# database (BASELINE.md: 318 MB filter) and RefSeq viral cut to 8,192
FLAT_GENOMES, FLAT_LEN = 1000, 2_500_000
PRUNED_TARGETS, PRUNED_LEN = 8192, 50_000
N_PAIRS = 1_000_000
N_LONG = 1000
SUBSET_PAIRS = 16_384  # compared with the CPU reference
SUBSET_LONG = 256
ORACLE_READS = 300
CHECK_TARGETS = 4  # full-size inserted-minimizer check
CUT_TARGETS, CUT_LEN = 64, 500_000  # device build == host-array build
BUILD_THREADS = 8  # build-custom --threads: reader threads per build
CPU_CHILD_TIMEOUT_S = 900
# the 4-GPU check compares layouts, not speeds: fewer reads, and the
# fewest targets at which hibf builds the pruned layout
FOUR_GPU_PAIRS = 262_144
FOUR_GPU_PRUNED_TARGETS = 2048


# --------------------------------------------------------------------------
# seeded data


def random_genomes(rng, lengths) -> list[np.ndarray]:
    """One uint8 code array (0..3 = A, C, G, T) per genome length."""
    return [rng.integers(0, 4, size=int(n), dtype=np.uint8) for n in lengths]


def mutate(rng, codes: np.ndarray, rate: float) -> None:
    """Substitute each base with probability ``rate`` (in place)."""
    hit = rng.random(codes.shape) < rate
    codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()),
                                            dtype=np.uint8)) % 4


def sample_pairs(rng, genomes, n, *, sub_rate=0.01, absent_frac=0.10,
                 insert=(300, 500)):
    """``n`` 2x150 bp read pairs: ``1 - absent_frac`` of them drawn from
    ``genomes`` (mate 2 reverse-complemented at the far end of a
    300-500 bp insert) and the rest random, absent from any database.
    Substitutions hit every read at ``sub_rate``. Returns uint8 codes
    ``(r1, r2)``, each [n, 150], in shuffled order."""
    lens = np.asarray([len(g) for g in genomes])
    flat = np.concatenate(genomes)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    n_abs = int(round(n * absent_frac))
    n_db = n - n_abs
    r1 = np.empty((n, READ_LEN), np.uint8)
    r2 = np.empty((n, READ_LEN), np.uint8)
    idx = np.arange(READ_LEN)
    for s in range(0, n_db, 1 << 17):
        m = min(1 << 17, n_db - s)
        t = rng.integers(0, len(genomes), m)
        ins = rng.integers(insert[0], insert[1] + 1, m)
        ins = np.minimum(ins, lens[t])
        p = offs[t] + (rng.random(m) * (lens[t] - ins + 1)).astype(np.int64)
        r1[s:s + m] = flat[p[:, None] + idx]
        r2[s:s + m] = 3 - flat[(p + ins - READ_LEN)[:, None] + idx][:, ::-1]
    r1[n_db:] = rng.integers(0, 4, (n_abs, READ_LEN), dtype=np.uint8)
    r2[n_db:] = rng.integers(0, 4, (n_abs, READ_LEN), dtype=np.uint8)
    mutate(rng, r1, sub_rate)
    mutate(rng, r2, sub_rate)
    perm = rng.permutation(n)
    return r1[perm], r2[perm]


def sample_long_reads(rng, genomes, n, *, lo=5_000, hi=20_000,
                      sub_rate=0.01) -> list[np.ndarray]:
    """``n`` single long reads of ``lo..hi`` bp from ``genomes``."""
    out = []
    for _ in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        ln = min(int(rng.integers(lo, hi + 1)), len(g))
        p = int(rng.integers(0, len(g) - ln + 1))
        r = g[p:p + ln].copy()
        mutate(rng, r, sub_rate)
        out.append(r)
    return out


def fastq_bytes(codes: np.ndarray, first_id: int = 0) -> bytes:
    """Fixed-length reads as FASTQ records named ``r%08d``."""
    n, L = codes.shape
    ids = np.char.zfill(np.arange(first_id, first_id + n).astype("U8"), 8)
    cols = [
        np.full((n, 1), ord("@"), np.uint8),
        np.full((n, 1), ord("r"), np.uint8),
        np.frombuffer(ids.astype("S8").tobytes(), np.uint8).reshape(n, 8),
        np.full((n, 1), ord("\n"), np.uint8),
        BASES[codes],
        np.frombuffer(b"\n+\n", np.uint8)[None, :].repeat(n, 0),
        np.full((n, L), ord("I"), np.uint8),
        np.full((n, 1), ord("\n"), np.uint8),
    ]
    return np.concatenate(cols, axis=1).tobytes()


def write_fastq(path, codes, first_id=0) -> None:
    with open(path, "wb") as f:
        f.write(fastq_bytes(codes, first_id))


def write_long_fastq(path, reads) -> None:
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@L%08d\n%s\n+\n%s\n" % (i, BASES[r].tobytes(),
                                            b"I" * len(r)))


def write_genome_files(folder, genomes, prefix="G") -> str:
    """One FASTA per genome plus a build-custom ``--input-file`` listing
    them (one target per file). Returns the input-file path."""
    os.makedirs(folder, exist_ok=True)
    rows = []
    for i, g in enumerate(genomes):
        path = os.path.join(folder, f"{prefix}{i:05d}.fna")
        with open(path, "wb") as f:
            f.write(b">%s%05d\n%s\n" % (prefix.encode(), i,
                                        BASES[g].tobytes()))
        rows.append(path)
    listing = os.path.join(folder, "input.txt")
    with open(listing, "w") as f:
        f.write("".join(p + "\n" for p in rows))
    return listing


# --------------------------------------------------------------------------
# output comparison


def sorted_lines(path) -> list[bytes]:
    with open(path, "rb") as f:
        return sorted(f.read().splitlines())


def compare_output_dirs(a, b) -> list[str]:
    """Differences between two classify output folders: files present in
    one only, and files whose sorted lines differ (row order is not part
    of the output contract). An empty list means identical."""
    fa, fb = set(os.listdir(a)), set(os.listdir(b))
    diffs = [f"only in {a}: {n}" for n in sorted(fa - fb)]
    diffs += [f"only in {b}: {n}" for n in sorted(fb - fa)]
    for name in sorted(fa & fb):
        la = sorted_lines(os.path.join(a, name))
        lb = sorted_lines(os.path.join(b, name))
        if la != lb:
            first = next((i for i, (x, y) in enumerate(zip(la, lb))
                          if x != y), min(len(la), len(lb)))
            diffs.append(f"{name}: {len(la)} vs {len(lb)} lines, first "
                         f"difference at sorted line {first}")
    return diffs


# --------------------------------------------------------------------------
# device and environment


def card_line() -> str:
    """``name, power limit`` of the card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def require_gpu(n_devices: int):
    """Stop unless JAX's default backend is the GPU with enough devices.

    JAX falls back to the CPU on its own when its CUDA plugin fails to
    load; this check keeps that fallback from passing as a GPU run."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, not "
                         "'gpu'; no accelerator, no result")
    devs = jax.devices()
    if len(devs) < n_devices:
        raise SystemExit(f"chip_smoke: needs {n_devices} GPUs, JAX sees "
                         f"{len(devs)}")
    return devs


class Phases:
    """Runs named phases, prints each outcome, remembers failures."""

    def __init__(self):
        self.failed: list[str] = []

    def run(self, name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.failed.append(name)
            print(f"phase {name}: FAILED after "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            traceback.print_exc()
            return None
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f}s)",
              flush=True)
        return out


# --------------------------------------------------------------------------
# CLI drivers


def build_custom(listing, db_prefix, **kw) -> float:
    """``ganon build-custom`` in process; returns wall seconds."""
    from ganon_tpu.cli import main as cli

    t0 = time.perf_counter()
    ok = cli("build-custom", input_file=listing, db_prefix=db_prefix,
             taxonomy="skip", input_target="file", threads=BUILD_THREADS,
             quiet=True, **kw)
    if not ok:
        raise RuntimeError(f"build-custom failed for {db_prefix}")
    return time.perf_counter() - t0


def classify_kwargs(db_prefixes, out_prefix, *, pairs=None, single=None,
                    **kw) -> dict:
    """The classify arguments every layout uses (paired or single)."""
    args = dict(db_prefix=list(db_prefixes), output_prefix=out_prefix,
                output_all=True, output_one=True, output_unclassified=True,
                quiet=True)
    if pairs:
        args["paired_reads"] = list(pairs)
    if single:
        args["single_reads"] = [single]
    args.update(kw)
    return args


def classify(kwargs) -> float:
    from ganon_tpu.cli import main as cli

    os.makedirs(os.path.dirname(kwargs["output_prefix"]), exist_ok=True)
    t0 = time.perf_counter()
    if not cli("classify", **kwargs):
        raise RuntimeError(f"classify failed: {kwargs['output_prefix']}")
    return time.perf_counter() - t0


def cpu_reference(jobs_file) -> None:
    """Child process: the same classify calls on the CPU backend, on the
    upper half of the host's cores (the GPU process keeps the rest)."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        os.sched_setaffinity(0, cores[len(cores) // 2:])
    import jax

    if jax.default_backend() != "cpu":
        raise SystemExit("the reference run must use the CPU backend")
    with open(jobs_file) as f:
        jobs = json.load(f)
    for name, kwargs in jobs:
        dt = classify(kwargs)
        print(f"cpu reference {name}: {dt:.1f}s", flush=True)


def start_cpu_reference(work, jobs):
    """Launch the CPU reference child (see :func:`cpu_reference`)."""
    jobs_file = os.path.join(work, "cpu_jobs.json")
    with open(jobs_file, "w") as f:
        json.dump(jobs, f)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference",
         jobs_file],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=REPO,
    )


# --------------------------------------------------------------------------
# checks


def check_inserted_minimizers(db_prefix, listing, n_check, rng) -> None:
    """Every distinct minimizer of a sample of targets is set, for every
    hash function, in the technical bin the reference's index-range
    split assigns it to (GanonBuild.cpp:619-653)."""
    from ganon_tpu.index import sizing
    from ganon_tpu.index.builder import count_target_hashes
    from ganon_tpu.index.ibf import IBF
    from ganon_tpu.ops.ibf_query import ibf_row_indices_np

    ibf = IBF.load(db_prefix + ".ibf")
    cfg = ibf.ibf_config
    with open(listing) as f:
        files = [line.strip() for line in f if line.strip()]
    splits = sizing.split_target_bins(cfg, ibf.hashes_count)
    pick = rng.choice(len(files), size=n_check, replace=False)
    for i in pick:
        path = files[int(i)]
        target = os.path.basename(path)
        hashes = count_target_hashes({target: [path]}, kmer_size=cfg.kmer_size,
                                     window_size=cfg.window_size)[target]
        if len(hashes) != ibf.hashes_count[target]:
            raise AssertionError(f"{target}: {len(hashes)} minimizers, "
                                 f"filter counted {ibf.hashes_count[target]}")
        for binno, t, st, en in splits:
            if t != target:
                continue
            h = hashes[st:en + 1]
            rows = ibf_row_indices_np(h, bin_size=cfg.bin_size_bits,
                                      hash_functions=cfg.hash_functions)
            words = ibf.bits[rows, binno // 32]
            if not np.all((words >> np.uint32(binno % 32)) & 1):
                raise AssertionError(f"{target}: minimizer missing from "
                                     f"bin {binno}")


def check_oracle(db_file, r1, r2, all_file, rel_cutoff=0.75, rel_filter=0.1,
                 fpr_query=1e-5) -> int:
    """Each ``.all`` line of the first reads equals the numpy oracle's
    count, and the match set equals the oracle's after cutoff, filter and
    the binomial-tail fpr query. Returns the number of matches checked."""
    import math

    from tests.test_fuzz_equivalence import _oracle_counts

    from ganon_tpu.classify.thresholds import binom_tail_q
    from ganon_tpu.index.ibf import IBF

    reads1 = {f"r{i:08d}": BASES[r1[i]].tobytes().decode()
              for i in range(len(r1))}
    reads2 = {f"r{i:08d}": BASES[r2[i]].tobytes().decode()
              for i in range(len(r2))}
    oracle = _oracle_counts(db_file, None, reads1, reads2, K, W)
    tfpr = IBF.load(db_file).target_fpr()
    have = {}
    with open(all_file) as f:
        for line in f:
            rid, target, cnt = line.rstrip("\n").split("\t")[:3]
            if rid in oracle:
                have[(rid, target)] = int(cnt)
    expect = {}
    for rid, (n, counts) in oracle.items():
        kept = {t: c for t, c in counts.items()
                if n and c >= max(math.ceil(n * rel_cutoff), 1)}
        if not kept:
            continue
        mx = max(kept.values())
        thr = mx - math.ceil((mx - min(n, min(kept.values()))) * rel_filter)
        for t, c in kept.items():
            if c >= thr and binom_tail_q(c, n, tfpr[t]) <= fpr_query:
                expect[(rid, t)] = c
    if have != expect:
        extra = sorted(set(have) - set(expect))[:5]
        missing = sorted(set(expect) - set(have))[:5]
        wrong = [k for k in have if k in expect and have[k] != expect[k]][:5]
        raise AssertionError(f"oracle mismatch: extra {extra}, missing "
                             f"{missing}, wrong counts {wrong}")
    return len(have)


def use_repo_tests_package() -> None:
    """Make ``import tests.<module>`` resolve to this checkout's tests/.

    The tests import one another as ``tests.<module>`` from a folder
    without ``__init__.py`` (a namespace package); a regular package
    named ``tests`` installed in site-packages would win over it."""
    import types

    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(REPO, "tests")]
    sys.modules["tests"] = pkg


def run_gpu_tests() -> None:
    """The tests marked ``gpu``, in this process (the card is open)."""
    import jax
    import pytest

    env, plat = dict(os.environ), jax.config.jax_platforms
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests")])
    finally:
        os.environ.clear()
        os.environ.update(env)
        jax.config.update("jax_platforms", plat)
    if rc != 0:
        raise AssertionError(f"gpu tests: pytest exit code {rc}")


# --------------------------------------------------------------------------
# the runs


def single_gpu(args, phases: Phases, work) -> None:
    import jax

    from ganon_tpu.index import builder
    from ganon_tpu.index.device_build import DeviceBuildPipeline
    from ganon_tpu.index.ibf import IBF
    from ganon_tpu.native import NativeSeqReader

    card = card_line()
    print(f"native C++ reader built: {NativeSeqReader.available()}")
    rng = np.random.default_rng(args.seed)
    flat_len = FLAT_LEN // args.shrink
    pruned_len = PRUNED_LEN // args.shrink
    if args.shrink > 1:
        print(f"cut: genome lengths divided by {args.shrink} (flat "
              f"{flat_len} bp, pruned {pruned_len} bp)")

    # data -----------------------------------------------------------------
    t0 = time.perf_counter()
    flat_genomes = random_genomes(rng, [flat_len] * FLAT_GENOMES)
    flat_list = write_genome_files(os.path.join(work, "flat"), flat_genomes)
    cut_list = write_genome_files(
        os.path.join(work, "cut"),
        [g[:CUT_LEN] for g in flat_genomes[:CUT_TARGETS]], "C")
    p1, p2 = sample_pairs(rng, flat_genomes, N_PAIRS)
    flat_reads = [os.path.join(work, f"flat.{m}.fq") for m in (1, 2)]
    sub_reads = [os.path.join(work, f"flat_sub.{m}.fq") for m in (1, 2)]
    for path, r in zip(flat_reads, (p1, p2)):
        write_fastq(path, r)
    for path, r in zip(sub_reads, (p1, p2)):
        write_fastq(path, r[:SUBSET_PAIRS])
    longs = sample_long_reads(rng, flat_genomes, N_LONG)
    long_fq = os.path.join(work, "long.fq")
    long_sub = os.path.join(work, "long_sub.fq")
    write_long_fastq(long_fq, longs)
    write_long_fastq(long_sub, longs[:SUBSET_LONG])
    long_bp = sum(len(r) for r in longs)

    pr_genomes = random_genomes(rng, [pruned_len] * PRUNED_TARGETS)
    pr_list = write_genome_files(os.path.join(work, "pruned"), pr_genomes)
    q1, q2 = sample_pairs(rng, pr_genomes, N_PAIRS)
    pr_reads = [os.path.join(work, f"pr.{m}.fq") for m in (1, 2)]
    pr_sub = [os.path.join(work, f"pr_sub.{m}.fq") for m in (1, 2)]
    for path, r in zip(pr_reads, (q1, q2)):
        write_fastq(path, r)
    for path, r in zip(pr_sub, (q1, q2)):
        write_fastq(path, r[:SUBSET_PAIRS])
    del pr_genomes, q1, q2

    # small databases: skewed lengths (forest classes), two halves
    small = random_genomes(rng, np.geomspace(20_000, 400_000, 48).astype(int))
    small_list = write_genome_files(os.path.join(work, "small"), small, "S")
    halves = random_genomes(rng, [200_000] * 32)
    half_lists = [
        write_genome_files(os.path.join(work, f"half{h}"),
                           halves[16 * h:16 * (h + 1)], f"H{h}")
        for h in (0, 1)
    ]
    s1, s2 = sample_pairs(rng, small, SUBSET_PAIRS)
    small_reads = [os.path.join(work, f"small.{m}.fq") for m in (1, 2)]
    for path, r in zip(small_reads, (s1, s2)):
        write_fastq(path, r)
    h1, h2 = sample_pairs(rng, halves, SUBSET_PAIRS)
    half_reads = [os.path.join(work, f"half.{m}.fq") for m in (1, 2)]
    for path, r in zip(half_reads, (h1, h2)):
        write_fastq(path, r)
    print(f"data generated in {time.perf_counter() - t0:.1f}s")

    # builds ---------------------------------------------------------------
    runs = {"n": 0}
    scatter = DeviceBuildPipeline.scatter

    def counted_scatter(self, *a, **kw):
        runs["n"] += 1
        return scatter(self, *a, **kw)

    DeviceBuildPipeline.scatter = counted_scatter
    db = {name: os.path.join(work, "db", name) for name in (
        "cut_dev", "cut_host", "flat", "pruned", "forest", "raptor",
        "half0", "half1")}
    os.makedirs(os.path.join(work, "db"), exist_ok=True)

    def build_cut():
        build_custom(cut_list, db["cut_dev"])
        if runs["n"] != 1:
            raise AssertionError("the device build pipeline did not run")
        saved = os.environ.get("GANON_TPU_BUILD_PIPELINE")
        os.environ["GANON_TPU_BUILD_PIPELINE"] = "host"
        try:
            build_custom(cut_list, db["cut_host"])
        finally:
            if saved is None:
                del os.environ["GANON_TPU_BUILD_PIPELINE"]
            else:
                os.environ["GANON_TPU_BUILD_PIPELINE"] = saved
        a, b = IBF.load(db["cut_dev"] + ".ibf"), IBF.load(db["cut_host"]
                                                          + ".ibf")
        if a.ibf_config != b.ibf_config or a.bits.shape != b.bits.shape \
                or a.bits.tobytes() != b.bits.tobytes():
            raise AssertionError("device-built bit-matrix differs from the "
                                 "host-array build")
        print(f"  cut of {CUT_TARGETS} targets x {CUT_LEN} bp: device == "
              f"host-array build, {a.bits.nbytes / 2**20:.1f} MB bit-matrix")

    phases.run("build_cut_device_eq_host", build_cut)

    def build_flat():
        before = runs["n"]
        dt = build_custom(flat_list, db["flat"])
        if runs["n"] != before + 1:
            raise AssertionError("the device build pipeline did not run")
        ibf = IBF.load(db["flat"] + ".ibf")
        mbp = FLAT_GENOMES * flat_len / 1e6
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", 0)
        print(f"  flat IBF: {ibf.bits.nbytes / 2**20:.1f} MB, "
              f"{len(ibf.targets())} targets, "
              f"h={ibf.ibf_config.hash_functions}"
              f", scatter plane {8 * ibf.bits.nbytes / 2**30:.2f} GiB, "
              f"device peak {peak / 2**30:.2f} GiB")
        print(f"TIMING build flat: {mbp:.0f} Mbp in {dt:.1f}s = "
              f"{mbp / (dt / 60):.0f} Mbp/m [{card}]")

    phases.run("build_flat", build_flat)
    phases.run("inserted_minimizers", check_inserted_minimizers, db["flat"],
               flat_list, CHECK_TARGETS, rng)

    def build_pruned():
        dt = build_custom(pr_list, db["pruned"], filter_type="hibf")
        from ganon_tpu.index.pruned import is_pruned_file

        if not is_pruned_file(db["pruned"] + ".hibf"):
            raise AssertionError("hibf at 8192 targets is not pruned")
        mbp = PRUNED_TARGETS * pruned_len / 1e6
        print(f"TIMING build pruned: {mbp:.0f} Mbp in {dt:.1f}s = "
              f"{mbp / (dt / 60):.0f} Mbp/m [{card}]")

    phases.run("build_pruned", build_pruned)

    def build_small():
        build_custom(small_list, db["forest"], filter_type="hibf",
                     hibf_layout="forest")
        build_custom(small_list, db["raptor"], filter_type="hibf",
                     filter_format="reference")
        for h in (0, 1):
            build_custom(half_lists[h], db[f"half{h}"])

    phases.run("build_small", build_small)
    DeviceBuildPipeline.scatter = scatter

    # comparison jobs: the same CLI call on GPU and in the CPU child -------
    jobs = {
        "flat": dict(dbs=[db["flat"]], pairs=sub_reads),
        "flat_long": dict(dbs=[db["flat"]], single=long_sub),
        "pruned": dict(dbs=[db["pruned"]], pairs=pr_sub),
        "forest": dict(dbs=[db["forest"]], pairs=small_reads),
        "raptor": dict(dbs=[db["raptor"]], pairs=small_reads),
        "multi": dict(dbs=[db["half0"], db["half1"]], pairs=half_reads),
        "hierarchy": dict(dbs=[db["half0"], db["half1"]], pairs=half_reads,
                          hierarchy_labels=["H1", "H2"]),
    }

    def job_kwargs(name, side):
        spec = dict(jobs[name])
        dbs = spec.pop("dbs")
        return classify_kwargs(dbs, os.path.join(work, side, name, "out"),
                               **spec)

    for name in jobs:
        phases.run(f"classify_{name}", classify, job_kwargs(name, "gpu"))
    child = start_cpu_reference(
        work, [(name, job_kwargs(name, "cpu")) for name in jobs])
    from ganon_tpu.classify import engine

    engine_runs = []
    run_classify = engine.run_classify

    def timed_run_classify(cfg):
        t0 = time.perf_counter()
        stats = run_classify(cfg)
        engine_runs.append((time.perf_counter() - t0,
                            stats.get("timing", {})))
        return stats

    engine.run_classify = timed_run_classify
    try:
        # timed runs (programs already compiled by the subset runs); the
        # CLI wall includes EM reassignment, the engine wall does not
        def timed(name, kwargs, n_reads, bp=None):
            dt = classify(kwargs)
            eng, split = engine_runs[-1]
            rate = f"{n_reads / dt:,.0f} reads/s"
            if bp:
                rate += f", {bp / 1e6 / (dt / 60):,.0f} Mbp/m"
            split = ", ".join(f"{k} {v:.2f}s" for k, v in split.items())
            print(f"TIMING classify {name}: {n_reads} reads in {dt:.1f}s = "
                  f"{rate}; engine {eng:.1f}s = {n_reads / eng:,.0f} "
                  f"reads/s ({split}) [{card}]")

        phases.run("timed_flat_pairs", timed, "flat 2x150",
                   classify_kwargs([db["flat"]],
                                   os.path.join(work, "timed", "flat", "out"),
                                   pairs=flat_reads), N_PAIRS)
        phases.run("timed_flat_long", timed, "flat long",
                   classify_kwargs([db["flat"]],
                                   os.path.join(work, "timed", "long", "out"),
                                   single=long_fq), N_LONG, long_bp)
        phases.run("timed_pruned_pairs", timed, "pruned 2x150",
                   classify_kwargs([db["pruned"]],
                                   os.path.join(work, "timed", "pr", "out"),
                                   pairs=pr_reads), N_PAIRS)
        def oracle():
            n = check_oracle(db["flat"] + ".ibf", p1[:ORACLE_READS],
                             p2[:ORACLE_READS],
                             os.path.join(work, "gpu", "flat", "out.all"))
            print(f"  oracle agrees on {n} matches")

        phases.run("oracle_flat", oracle)
        phases.run("gpu_tests", run_gpu_tests)
        rc = child.wait(timeout=CPU_CHILD_TIMEOUT_S)
    finally:
        engine.run_classify = run_classify
        if child.poll() is None:
            child.kill()
            child.wait()
    if rc != 0:
        phases.failed.append("cpu_reference")
        print(f"phase cpu_reference: FAILED (exit code {rc})")
        return
    for name in jobs:
        def same(name=name):
            diffs = compare_output_dirs(os.path.join(work, "gpu", name),
                                        os.path.join(work, "cpu", name))
            if diffs:
                raise AssertionError("; ".join(diffs[:8]))
            files = sorted(os.listdir(os.path.join(work, "gpu", name)))
            print(f"  {name}: {', '.join(files)} identical to the CPU run")

        phases.run(f"equal_cpu_{name}", same)


def four_gpus(args, phases: Phases, work) -> None:
    """Bins-mesh build and (batch, bins)-mesh classify over 4 GPUs, each
    compared byte for byte with the single-device path on GPU 0."""
    from ganon_tpu.classify.engine import ClassifyConfig, run_classify
    from ganon_tpu.index.builder import BuildConfig, run_build
    from ganon_tpu.index.ibf import IBF

    card = card_line()
    rng = np.random.default_rng(args.seed)
    flat_len = FLAT_LEN // args.shrink
    pruned_len = PRUNED_LEN // args.shrink
    print(f"cut: genome lengths divided by {args.shrink} (flat {flat_len} "
          f"bp, pruned {pruned_len} bp), {FOUR_GPU_PRUNED_TARGETS} pruned "
          f"targets, {FOUR_GPU_PAIRS} read pairs")
    genomes = random_genomes(rng, [flat_len] * FLAT_GENOMES)
    flat_list = write_genome_files(os.path.join(work, "flat"), genomes)
    p1, p2 = sample_pairs(rng, genomes, FOUR_GPU_PAIRS)
    flat_reads = [os.path.join(work, f"flat.{m}.fq") for m in (1, 2)]
    for path, r in zip(flat_reads, (p1, p2)):
        write_fastq(path, r)
    del genomes
    pg = random_genomes(rng, [pruned_len] * FOUR_GPU_PRUNED_TARGETS)
    pr_list = write_genome_files(os.path.join(work, "pruned"), pg)
    q1, q2 = sample_pairs(rng, pg, FOUR_GPU_PAIRS)
    pr_reads = [os.path.join(work, f"pr.{m}.fq") for m in (1, 2)]
    for path, r in zip(pr_reads, (q1, q2)):
        write_fastq(path, r)
    del pg
    dbdir = os.path.join(work, "db")
    os.makedirs(dbdir, exist_ok=True)
    flat_db = os.path.join(dbdir, "flat")
    pr_db = os.path.join(dbdir, "pruned")

    def build_flat():
        t0 = time.perf_counter()
        # build_mesh auto: the scatter shards over the 4 GPUs
        build_custom(flat_list, flat_db, keep_files=True)
        dt = time.perf_counter() - t0
        target_info = os.path.join(flat_db + "_files", "build",
                                   "target_info.tsv")
        one = run_build(BuildConfig(input_file=target_info,
                                    output_file=os.path.join(dbdir, "one.ibf"),
                                    hash_functions=4, max_fp=0.05,
                                    build_mesh="off"))
        mesh = IBF.load(flat_db + ".ibf")
        if mesh.bits.tobytes() != one.bits.tobytes() or \
                mesh.ibf_config != one.ibf_config:
            raise AssertionError("bins-mesh build differs from GPU 0 build")
        mbp = FLAT_GENOMES * flat_len / 1e6
        print(f"  flat build over 4 GPUs == GPU 0 build "
              f"({mesh.bits.nbytes / 2**20:.1f} MB)")
        print(f"TIMING build flat 4 GPUs (cold): {mbp:.0f} Mbp in {dt:.1f}s "
              f"[{card}]")

    phases.run("build_flat_mesh_eq_single", build_flat)
    phases.run("build_pruned", build_custom, pr_list, pr_db,
               filter_type="hibf")

    for name, dbp, reads in (("flat", flat_db, flat_reads),
                             ("pruned", pr_db, pr_reads)):
        def run(name=name, dbp=dbp, reads=reads):
            dirs = {}
            for use_mesh in (True, False):
                dirs[use_mesh] = os.path.join(work, f"mesh{use_mesh}", name)
                os.makedirs(dirs[use_mesh])
                t0 = time.perf_counter()
                run_classify(ClassifyConfig(
                    ibf=[dbp + (".hibf" if name == "pruned" else ".ibf")],
                    paired_reads=list(reads),
                    output_prefix=os.path.join(dirs[use_mesh], "out"),
                    rel_cutoff=[0.75], rel_filter=[0.1], fpr_query=[1e-5],
                    output_all=True, output_unclassified=True,
                    use_mesh=use_mesh,
                ))
                if use_mesh:
                    dt = time.perf_counter() - t0
            diffs = compare_output_dirs(dirs[True], dirs[False])
            if diffs:
                raise AssertionError("; ".join(diffs))
            files = ", ".join(sorted(os.listdir(dirs[True])))
            print(f"  {name}: 4-GPU mesh {files} == GPU 0 "
                  f"({FOUR_GPU_PAIRS / dt:,.0f} reads/s cold, [{card}])")

        phases.run(f"classify_{name}_mesh_eq_single", run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU mesh path and its comparison")
    ap.add_argument("--shrink", type=int, default=1,
                    help="divide genome lengths by this factor")
    ap.add_argument("--cpu-reference", metavar="JOBS",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    use_repo_tests_package()
    if args.cpu_reference:
        cpu_reference(args.cpu_reference)
        return 0

    n_dev = 4 if args.four_gpus else 1
    devs = require_gpu(n_dev)
    import ganon_tpu  # noqa: F401  (x64 + compile cache)

    kind = devs[0].device_kind
    print(f"device: {kind} x{len(devs)} (jax {__import__('jax').__version__})")
    print(f"card: {card_line()}")
    work = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    phases = Phases()
    t0 = time.perf_counter()
    try:
        if args.four_gpus:
            four_gpus(args, phases, work)
        else:
            single_gpu(args, phases, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"total {time.perf_counter() - t0:.0f}s")
    if phases.failed:
        print(f"FAILED phases: {', '.join(phases.failed)}")
        return 1
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
