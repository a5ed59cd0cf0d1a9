"""Classification throughput benchmark on one accelerator — regimes.

Architecture: a PARENT orchestrator (no jax) runs ONE CHILD process over
all stages under the deadline (a crashed child is relaunched with the
remaining stages, dropping the one in flight). The child prints one
``BENCHSTAGE {json}`` line per completed stage; the parent folds those
into the metric line and RE-EMITS it after every stage, so a stage that
runs long can never leave the run without a number.

Stage order (earliest = most protected; the headline right after the
micro stage):
  kernel_micro, e2e_T32 (the headline), kernel_T32,
  kernel_T1024, e2e_T1024, kernel_T8192, e2e_T8192,
  e2e_forest, e2e_hierarchy, e2e_multifilter, e2e_mixedlen,
  build, e2e_soak (1M-pair sustained), e2e_refdata

Databases (cached under .bench_cache/, keyed by sizing policy + hash
family digest):
  * T32:   32 targets x 1 Mbp — narrow rows.
  * T1024: 1024 targets x 100 kbp — wide-table regime (the
    realistic RefSeq-subset shape; BASELINE.md north star).
  * T8192: 8192 targets x 20 kbp — many small targets (viral-scale;
    exercises the wide-T argmax top-K tier).
  * F256:  256 targets, skewed lengths 10-200 kbp — HIBF forest regime
    (4 size classes; the reference's default filter type is hibf).
  * T32 halves: 2 x 16 targets — the two-level hierarchy regime with
    leftover requeue (GanonClassify.cpp:1459-1639) AND the
    multi-filter one-level regime (both halves under one label).
  * refdata: the reference's bundled real assemblies + sim reads
    (tests/ganon/data) through the full build-custom + classify path.

kernel = the fused device classify step alone (extract + bulk count +
aggregation). e2e = the FULL run_classify: fastq parse, dispatch
pipeline, thresholds at the reference's Python-tier defaults
(rel-cutoff 0.75, rel-filter 0.1, fpr-query 1e-5), LCA, .one/.all/.unc
writing.

Baseline: the reference publishes no reads/s figure; its only in-tree
classify throughput is the documented toy log of 372.3 Mbp/m
(docs/classification.md:44). vs_baseline is the HEADLINE (end-to-end,
T32) Mbp/m over that number; everything else rides in "extra".

Prints ONE JSON line (repeatedly, growing as stages finish; the last
line is the most complete):
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": N,
   "extra": {...}}
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

K, W = 19, 31
READ_LEN = 150
BATCH = 8192
N_BATCHES = 16
CHUNK = 1 << 18
REPO = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(REPO, ".bench_cache")

BASELINE_MBP_PER_MIN = 372.3  # reference docs/classification.md:44

REGIMES = {
    # name: (n_targets, genome_len, rng_seed)
    "T32": (32, 1_000_000, 42),
    "T1024": (1024, 100_000, 43),
    "F256": (256, 200_000, 44),  # skewed per-target lengths (forest)
    # toward the real RefSeq shape: many small targets (viral-scale),
    # [~266k x 2048B] u32 table
    "T8192": (8192, 20_000, 45),
}

GROUPS = [
    # (group name, [stage names], weight for budget allocation)
    # headline (e2e_T32) right after the micro stage, so a long first
    # stage cannot push it out of budget
    ("core32", ["kernel_micro", "e2e_T32", "kernel_T32"], 1.3),
    ("wide", ["kernel_T1024", "e2e_T1024", "kernel_T8192",
              "e2e_T8192"], 1.0),
    ("extras", ["e2e_forest", "e2e_hierarchy", "e2e_multifilter",
                "e2e_mixedlen", "build", "e2e_soak", "e2e_refdata"],
     1.0),
]

# conservative WARM-cache wall-clock estimates per stage (seconds); a
# child skips a stage whose estimate does not fit its remaining budget
# (cold compiles are bounded by the parent's group kill instead)
STAGE_EST = {
    "kernel_micro": 25,
    "kernel_T32": 30,
    "e2e_T32": 35,
    "kernel_T1024": 55,
    "e2e_T1024": 45,
    "kernel_T8192": 60,
    "e2e_T8192": 60,
    "e2e_forest": 60,
    "e2e_hierarchy": 55,
    "e2e_multifilter": 50,
    "e2e_mixedlen": 75,
    "build": 55,
    "e2e_soak": 90,  # 1M pairs x 3 passes (shapes warm from e2e_T8192)
    "e2e_refdata": 110,  # ~100k pairs x 4 passes + db load
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# database cache


def family_digest() -> str:
    """Digest of the IBF hash family + sizing-relevant constants: a
    cached db built under a different family would stay self-consistent
    (counts still match) so nothing downstream would fail — fold the
    constants into the cache key instead."""
    from ganon_tpu.ops.ibf_query import GOLDEN, HASH_SEEDS

    return hashlib.sha256(
        repr((GOLDEN, HASH_SEEDS, K, W)).encode()
    ).hexdigest()[:16]


def _cache_current(ibf, db_path) -> bool:
    """Does the cached db match what today's policy would build?

    Sizing is cheap (the expensive part is minimizer extraction), so
    re-derive the expected IBFConfig from the cached per-target counts
    and compare; the hash-family digest rides in a sidecar file.
    """
    from ganon_tpu.index import sizing

    try:
        with open(db_path + ".family") as f:
            if f.read().strip() != family_digest():
                return False
    except OSError:
        return False
    cfg = sizing.size_filter(
        ibf.hashes_count, kmer_size=K, window_size=W, max_fp=0.05
    )
    got = ibf.ibf_config
    return (
        got.kmer_size == cfg.kmer_size
        and got.window_size == cfg.window_size
        and got.hash_functions == cfg.hash_functions
        and got.bin_size_bits == cfg.bin_size_bits
        and got.n_bins == cfg.n_bins
        and got.max_hashes_bin == cfg.max_hashes_bin
    )


def _genomes(name):
    n_targets, genome_len, seed = REGIMES[name]
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(n_targets, genome_len), dtype=np.uint8)


def _target_lengths(name):
    """Per-target usable genome length (F256 is skewed for the forest)."""
    n_targets, genome_len, _ = REGIMES[name]
    if name == "F256":
        return np.geomspace(10_000, genome_len, n_targets).astype(np.int64)
    return np.full(n_targets, genome_len, dtype=np.int64)


def _extract_target_hashes(name):
    """Sorted distinct minimizers per target, cached as one npz."""
    from ganon_tpu.ops.minimizers import window_mins_jax

    path = os.path.join(CACHE_DIR, f"hashes_{name}.npz")
    n_targets, _, _ = REGIMES[name]
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                if bytes(z["family"].tobytes()).decode() == family_digest():
                    flat, offs = z["flat"], z["offsets"]
                    return {
                        f"T{t}": flat[offs[t] : offs[t + 1]]
                        for t in range(n_targets)
                    }
        except Exception:
            pass
    genomes = _genomes(name)
    lens = _target_lengths(name)
    step = CHUNK - (W - 1)
    pieces = [
        (t, s)
        for t in range(n_targets)
        for s in range(0, int(lens[t]) - W + 1, step)
    ]
    width = min(CHUNK, genomes.shape[1])
    group = max(1, (16 << 20) // width)
    parts: dict[int, list] = {t: [] for t in range(n_targets)}
    for i in range(0, len(pieces), group):
        grp = pieces[i : i + group]
        chunks = np.zeros((group, width), dtype=np.uint8)  # fixed shape
        plens = np.zeros(group, dtype=np.int32)
        for j, (t, s) in enumerate(grp):
            piece = genomes[t, s : min(s + CHUNK, int(lens[t]))]
            chunks[j, : len(piece)] = piece
            plens[j] = len(piece)
        mv, valid = window_mins_jax(chunks, plens, k=K, w=W)
        mv, valid = np.asarray(mv), np.asarray(valid)
        for j, (t, s) in enumerate(grp):
            parts[t].append(mv[j][valid[j]])
    hashes = {
        f"T{t}": np.unique(np.concatenate(v)) for t, v in parts.items() if v
    }
    flat = np.concatenate([hashes[f"T{t}"] for t in range(n_targets)])
    offsets = np.zeros(n_targets + 1, dtype=np.int64)
    for t in range(n_targets):
        offsets[t + 1] = offsets[t] + len(hashes[f"T{t}"])
    os.makedirs(CACHE_DIR, exist_ok=True)
    np.savez(
        path + ".tmp.npz", flat=flat, offsets=offsets,
        family=np.frombuffer(family_digest().encode(), dtype=np.uint8),
    )
    os.replace(path + ".tmp.npz", path)
    return hashes


def _mark_family(db_path):
    with open(db_path + ".family", "w") as f:
        f.write(family_digest())


def build_database(name):
    from ganon_tpu.index.ibf import IBF, build_ibf

    genomes = _genomes(name)
    db_path = os.path.join(CACHE_DIR, f"db_{name}.ibf")
    if os.path.exists(db_path):
        try:
            ibf = IBF.load(db_path)
            if _cache_current(ibf, db_path):
                return genomes, ibf, db_path
            log(f"cached {name} db stale (policy changed), rebuilding")
        except Exception:
            pass
    target_hashes = _extract_target_hashes(name)
    ibf = build_ibf(target_hashes, kmer_size=K, window_size=W, max_fp=0.05)
    os.makedirs(CACHE_DIR, exist_ok=True)
    ibf.save(db_path)
    _mark_family(db_path)
    return genomes, ibf, db_path


def build_forest_database():
    """HIBF forest over the skewed F256 regime (4 size classes)."""
    from ganon_tpu.index.hibf import HIBF, build_hibf

    db_path = os.path.join(CACHE_DIR, "db_F256.hibf")
    genomes = _genomes("F256")
    if os.path.exists(db_path):
        try:
            with open(db_path + ".family") as f:
                if f.read().strip() == family_digest():
                    return genomes, HIBF.load(db_path), db_path
        except Exception:
            pass
    target_hashes = _extract_target_hashes("F256")
    hibf = build_hibf(
        target_hashes, kmer_size=K, window_size=W, max_fp=0.05,
        num_classes=4,
    )
    hibf.save(db_path)
    _mark_family(db_path)
    return genomes, hibf, db_path


def build_pruned_database(name):
    """Merged-bin pruned forest over a many-targets regime — the layout
    build-custom's default (--filter-type hibf / --hibf-layout auto)
    produces at >=2048 targets (index.pruned)."""
    from ganon_tpu.index.pruned import PrunedForest, build_pruned

    db_path = os.path.join(CACHE_DIR, f"db_{name}_pruned.hibf")
    genomes = _genomes(name)
    if os.path.exists(db_path):
        try:
            with open(db_path + ".family") as f:
                ok = f.read().strip() == family_digest()
            if ok:
                pf = PrunedForest.load(db_path)
                import inspect

                from ganon_tpu.index.pruned import build_pruned as _bp

                defaults = inspect.signature(_bp).parameters
                if (
                    pf.fine_h == defaults["fine_h"].default
                    and pf.coarse_h == defaults["coarse_h"].default
                    and pf.coarse_fp == defaults["coarse_fp"].default
                    and pf.group_size == defaults["group_size"].default
                ):
                    return genomes, pf, db_path
                log(f"cached pruned {name} db stale, rebuilding")
        except Exception:
            pass
    th = _extract_target_hashes(name)
    pf = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05)
    pf.save(db_path)
    _mark_family(db_path)
    return genomes, pf, db_path


def build_hierarchy_databases():
    """Two 16-target IBFs split from T32 (levels share k/w)."""
    from ganon_tpu.index.ibf import IBF, build_ibf

    paths = [os.path.join(CACHE_DIR, f"db_T32{h}.ibf") for h in "ab"]
    if all(os.path.exists(p) for p in paths):
        try:
            ok = True
            for p in paths:
                with open(p + ".family") as f:
                    ok &= f.read().strip() == family_digest()
            if ok:
                return paths
        except Exception:
            pass
    target_hashes = _extract_target_hashes("T32")
    halves = [
        {f"T{t}": target_hashes[f"T{t}"] for t in range(16)},
        {f"T{t}": target_hashes[f"T{t}"] for t in range(16, 32)},
    ]
    for p, th in zip(paths, halves):
        build_ibf(th, kmer_size=K, window_size=W, max_fp=0.05).save(p)
        _mark_family(p)
    return paths


# --------------------------------------------------------------------------
# read generation


def sample_paired_reads(rng, genomes, n, lens=None):
    n_targets, genome_len = genomes.shape
    tgt = rng.integers(0, n_targets, size=n)
    hi = (
        np.full(n, genome_len - READ_LEN)
        if lens is None
        else (lens[tgt] - READ_LEN)
    )
    pos1 = rng.integers(0, hi)
    pos2 = rng.integers(0, hi)
    idx = np.arange(READ_LEN)
    r1 = genomes[tgt[:, None], pos1[:, None] + idx]
    r2 = 3 - genomes[tgt[:, None], pos2[:, None] + idx][:, ::-1]  # revcomp
    lengths = np.full(n, READ_LEN, dtype=np.int32)
    return r1.astype(np.uint8), r2.astype(np.uint8), lengths


def _reads_fastq(name, genomes, n, lens=None):
    """Paired fastq on disk for the e2e runs (cached)."""
    base = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual = b"I" * READ_LEN
    # n is part of the cache key: a >=-size check let a LARGER cached
    # file (e.g. the 1M soak file) satisfy a 64k request, silently
    # running 16x the reads while the stage divided by n
    paths = [
        os.path.join(CACHE_DIR, f"reads_{name}_{n}.{m}.fq")
        for m in (1, 2)
    ]
    if all(
        os.path.exists(p) and os.path.getsize(p) >= n * (READ_LEN + 8)
        for p in paths
    ):
        return paths
    rng = np.random.default_rng(7)
    r1, r2, _ = sample_paired_reads(rng, genomes, n, lens=lens)
    for p, r in zip(paths, (r1, r2)):
        chars = base[r]
        with open(p, "wb") as f:
            for i in range(n):
                f.write(b"@q%d\n%s\n+\n%s\n" % (i, chars[i].tobytes(), qual))
    return paths


def _mixedlen_fastq(genomes, n):
    """Single-end nanopore-style discrete length mix vs T32 (cached).

    Discrete classes, not a continuous log-normal: each distinct length
    bucket is one compiled program (scripts/mixedlen_bench.py runs
    both).
    """
    path = os.path.join(CACHE_DIR, "reads_mixedlen.fq")
    meta = os.path.join(CACHE_DIR, "reads_mixedlen.json")
    if os.path.exists(path) and os.path.exists(meta):
        with open(meta) as f:
            return path, json.load(f)["total_bp"]
    rng = np.random.default_rng(11)
    classes = np.array([500, 1000, 2000, 4000, 8000, 16000])
    weights = np.array([0.15, 0.2, 0.3, 0.2, 0.1, 0.05])
    lens = rng.choice(classes, size=n, p=weights / weights.sum())
    base = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_targets, genome_len = genomes.shape
    total_bp = int(lens.sum())
    with open(path + ".tmp", "wb") as f:
        for i in range(n):
            ln = int(lens[i])
            t = rng.integers(0, n_targets)
            s = rng.integers(0, genome_len - ln)
            seq = base[genomes[t, s : s + ln]].tobytes()
            f.write(b"@q%d\n%s\n+\n%s\n" % (i, seq, b"I" * ln))
    os.replace(path + ".tmp", path)
    with open(meta, "w") as f:
        json.dump({"total_bp": total_bp, "n": n}, f)
    return path, total_bp


# --------------------------------------------------------------------------
# measurement helpers


def _time_kernel(genomes, ibf, batch, n_batches, lens=None):
    """Fused device kernel throughput (reads/s).

    Dispatches batches asynchronously (each folds its outputs to one
    scalar on device) and blocks once at the end — the same device work
    as a lax.scan mega-program, but each program stays the production
    per-batch dispatch, so the compile is the one the engine uses.
    """
    import jax
    import jax.numpy as jnp

    from ganon_tpu.classify.device import classify_counts_fused
    from ganon_tpu.ops.ibf_query import pack_table_u8, table_as_u32

    cfg = ibf.ibf_config
    tbl8_np, bstarts_np, bends_np = pack_table_u8(
        ibf.bits, ibf.bin_to_target_ids(), len(ibf.targets())
    )
    # the DeviceFilter layout: the u32 word view
    tbl8 = jax.device_put(table_as_u32(tbl8_np))
    bstarts, bends = jnp.asarray(bstarts_np), jnp.asarray(bends_np)
    m = READ_LEN - W + 1

    @jax.jit
    def step(tbl8, bstarts, bends, b1, b2, bl):
        c, n, _ = classify_counts_fused(
            tbl8, bstarts, bends, b1, bl, b2, bl,
            k=K, w=W, m1=m, m2=m,
            bin_size=cfg.bin_size_bits,
            hash_functions=cfg.hash_functions,
        )
        # fold outputs so nothing large leaves the device
        return c.sum(dtype=jnp.int64) + n.sum(dtype=jnp.int64)

    rng = np.random.default_rng(7)
    batches = []
    for _ in range(n_batches):
        r1, r2, ln = sample_paired_reads(rng, genomes, batch, lens=lens)
        batches.append((jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(ln)))
    jax.block_until_ready(batches)
    b1, b2, bl = batches[0]
    int(step(tbl8, bstarts, bends, b1, b2, bl))  # compile + fence
    # report the best of 3 passes
    elapsed = float("inf")
    for _ in range(3):
        t0 = time.time()
        totals = [
            step(tbl8, bstarts, bends, b1, b2, bl) for b1, b2, bl in batches
        ]
        jax.block_until_ready(totals)
        int(totals[-1])  # fence: fetch the last result
        elapsed = min(elapsed, time.time() - t0)
    return batch * n_batches / elapsed


def _time_e2e(kw, n_reads, timed_passes=3, breakdown_into=None,
              breakdown_key=None):
    """Full run_classify throughput (reads/s) — what a user gets.

    When ``breakdown_into`` is given, the best pass's wall-clock split
    (input_wait / dispatch / finish, seconds) is stored under
    ``breakdown_key`` so the e2e-vs-kernel gap has per-term evidence in
    the driver output, not just in prose notes."""
    from ganon_tpu.classify.engine import ClassifyConfig, run_classify

    run_classify(ClassifyConfig(**kw))  # warmup (compiles)
    elapsed = float("inf")
    best_timing = None
    for _ in range(timed_passes):
        t0 = time.time()
        stats = run_classify(ClassifyConfig(**kw))
        dt = time.time() - t0
        if dt < elapsed:
            elapsed, best_timing = dt, stats.get("timing")
    if breakdown_into is not None and best_timing:
        breakdown_into[breakdown_key] = {
            k: round(v, 2) for k, v in best_timing.items()
        }
    return n_reads / elapsed


def _e2e_kw(db_paths, fq_pair, out_tag, **over):
    kw = dict(
        ibf=list(db_paths),
        output_prefix=os.path.join(CACHE_DIR, out_tag),
        rel_cutoff=[0.75], rel_filter=[0.1], fpr_query=[1e-5],
        output_all=True, output_lca=True, output_unclassified=True,
        quiet=True,
    )
    if len(fq_pair) == 2:
        kw["paired_reads"] = list(fq_pair)
    else:
        kw["single_reads"] = list(fq_pair)
    kw.update(over)
    return kw


# --------------------------------------------------------------------------
# stages (each returns {metric_key: value} merged into extra)


def st_kernel_micro():
    """Tiny insurance number: 4 targets x 50 kbp, 2 x 1024 reads.

    Completes in seconds warm; its only job is to guarantee the metric
    line is never empty even if every later stage stalls."""
    from ganon_tpu.index.ibf import IBF, build_ibf

    db_path = os.path.join(CACHE_DIR, "db_micro.ibf")
    rng = np.random.default_rng(5)
    genomes = rng.integers(0, 4, size=(4, 50_000), dtype=np.uint8)
    ibf = None
    if os.path.exists(db_path):
        try:
            ibf = IBF.load(db_path)
            if not _cache_current(ibf, db_path):
                ibf = None
        except Exception:
            ibf = None
    if ibf is None:
        from ganon_tpu.ops.minimizers import window_mins_jax

        lens = np.full(4, 50_000, dtype=np.int32)
        mv, valid = window_mins_jax(genomes, lens, k=K, w=W)
        mv, valid = np.asarray(mv), np.asarray(valid)
        th = {f"T{t}": np.unique(mv[t][valid[t]]) for t in range(4)}
        ibf = build_ibf(th, kmer_size=K, window_size=W, max_fp=0.05)
        ibf.save(db_path)
        _mark_family(db_path)
    v = _time_kernel(genomes, ibf, batch=1024, n_batches=2)
    return {"kernel_micro": round(v, 1)}


def st_kernel_T32():
    genomes, ibf, _ = build_database("T32")
    return {"kernel_T32": round(_time_kernel(genomes, ibf, BATCH, N_BATCHES), 1)}


def st_e2e_T32():
    n = 131072
    genomes, _, db = build_database("T32")
    fq = _reads_fastq("T32", genomes, n)
    extra = {}
    v = _time_e2e(_e2e_kw([db], fq, "e2e_T32"), n,
                  breakdown_into=extra, breakdown_key="e2e_T32_split")
    extra["e2e_T32"] = round(v, 1)
    return extra


def st_kernel_T1024():
    genomes, ibf, _ = build_database("T1024")
    return {
        "kernel_T1024": round(_time_kernel(genomes, ibf, BATCH, N_BATCHES), 1)
    }


def st_e2e_T1024():
    n = 65536
    genomes, _, db = build_database("T1024")
    fq = _reads_fastq("T1024", genomes, n)
    extra = {}
    v = _time_e2e(_e2e_kw([db], fq, "e2e_T1024"), n,
                  breakdown_into=extra, breakdown_key="e2e_T1024_split")
    extra["e2e_T1024"] = round(v, 1)
    return extra


def st_kernel_T8192():
    """Fused kernel at 8192 targets x 20 kbp — the many-small-targets
    end of the wide-table regime (real RefSeq dbs hold tens of
    thousands of targets; BASELINE.md north star). Since round 5 this
    regime runs the merged-bin PRUNED layout (the build default at this
    scale, --hibf-layout auto): a coarse gate + top-S narrow fine
    gathers instead of full-width HBM rows
    (hierarchical_interleaved_bloom_filter.hpp:432-460 re-expressed;
    index.pruned). The flat wide-table path stays covered by
    kernel/e2e_T1024. This kernel INCLUDES on-device threshold+top-K
    (the pruned program is one fused dispatch end to end)."""
    import jax
    import jax.numpy as jnp

    from ganon_tpu.classify import device as dev

    genomes, pf, _ = build_pruned_database("T8192")
    f = dev.DevicePrunedForest(pf)
    rng = np.random.default_rng(7)
    B = BATCH
    L = READ_LEN
    Lb = dev.bucket_len(L)
    batches = []
    # 16 pre-staged batches: deeper pipelining amortizes the
    # per-dispatch overhead
    for _ in range(16):
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
            fine_h=pf.fine_h, max_groups=2, group_size=pf.group_size,
            num_targets=f.num_targets, top_k=4, match_cap=2 * B,
            # production config: (read, slot) pair compaction at P=B
            # (ClassifyConfig.pruned_pair_frac default; sweep measured
            # +14% over dense slots at this shape)
            pair_cap=B,
        )

    np.asarray(step(batches[0]))  # compile + fence (fetch)
    elapsed = float("inf")
    for _ in range(3):
        t0 = time.time()
        outs = [step(ib) for ib in batches]
        jax.block_until_ready(outs)
        # fetch the last result like _time_kernel
        np.asarray(outs[-1])
        elapsed = min(elapsed, time.time() - t0)
    return {"kernel_T8192": round(B * len(batches) / elapsed, 1)}


def st_e2e_T8192():
    n = 65536
    genomes, _, db = build_pruned_database("T8192")
    fq = _reads_fastq("T8192", genomes, n)
    extra = {}
    v = _time_e2e(_e2e_kw([db], fq, "e2e_T8192"), n,
                  breakdown_into=extra, breakdown_key="e2e_T8192_split")
    extra["e2e_T8192"] = round(v, 1)
    return extra


def st_e2e_forest():
    """HIBF forest db (4 size classes) through the forest fast path —
    the reference's default filter type is hibf (config.py:179)."""
    n = 65536
    genomes, _, db = build_forest_database()
    lens = _target_lengths("F256")
    fq = _reads_fastq("F256", genomes, n, lens=lens)
    v = _time_e2e(_e2e_kw([db], fq, "e2e_forest"), n)
    return {"e2e_forest": round(v, 1)}


def st_e2e_hierarchy():
    """Two-level hierarchy with leftover requeue: reads span both halves
    of T32, so ~half fall through level 1 and requeue to level 2
    (GanonClassify.cpp:1459-1639)."""
    n = 65536
    genomes, _, _ = build_database("T32")
    dbs = build_hierarchy_databases()
    fq = _reads_fastq("T32", genomes, n)
    kw = _e2e_kw(
        dbs, fq, "e2e_hier",
        hierarchy_labels=["1_first", "2_second"],
        rel_cutoff=[0.75, 0.75],
        rel_filter=[0.1, 0.1], fpr_query=[1e-5, 1e-5],
    )
    extra = {}
    v = _time_e2e(kw, n, breakdown_into=extra,
                  breakdown_key="e2e_hierarchy_split")
    extra["e2e_hierarchy"] = round(v, 1)
    return extra


def st_e2e_multifilter():
    """Two databases on ONE hierarchy level (per-read max across
    filters, merged on device — GanonClassify.cpp:504-541 multi-filter
    semantics): the T32 halves under a single label."""
    n = 131072
    genomes, _, _ = build_database("T32")
    dbs = build_hierarchy_databases()
    fq = _reads_fastq("T32", genomes, n)
    kw = _e2e_kw(
        dbs, fq, "e2e_multi",
        hierarchy_labels=["H1", "H1"],
        rel_cutoff=[0.75, 0.75],
    )
    extra = {}
    v = _time_e2e(kw, n, breakdown_into=extra,
                  breakdown_key="e2e_multifilter_split")
    extra["e2e_multifilter"] = round(v, 1)
    return extra


def st_e2e_mixedlen():
    """Nanopore-style mixed-length single-end reads vs T32 with length
    bucketing (the 2-regime claim, driver-visible). 49152 reads
    (~160 Mbp): at 16384 the per-pass fixed costs (6 per-bucket
    dispatches + uploads) dominate and the number measures latency,
    not throughput."""
    n = 49152
    genomes, _, db = build_database("T32")
    fq, total_bp = _mixedlen_fastq(genomes, n)
    kw = _e2e_kw([db], [fq], "e2e_mixedlen")
    extra = {}
    reads_per_sec = _time_e2e(kw, n, breakdown_into=extra,
                              breakdown_key="e2e_mixedlen_split")
    mbp_per_min = reads_per_sec / n * total_bp / 1e6 * 60
    extra.update({
        "e2e_mixedlen": round(reads_per_sec, 1),
        "e2e_mixedlen_mbp_per_min": round(mbp_per_min, 1),
    })
    return extra


def st_e2e_soak():
    """Sustained throughput: 1M pairs through the FULL engine against
    the pruned T8192 db. The short e2e stages measure a handful of
    warm batches; this one proves the rate HOLDS across 128 pipelined
    batches (128x the per-batch host+device steady state;
    scripts/e2e_soak.py is the standalone form with per-pass prints).
    Shapes are warm by this point in the child (e2e_T8192 ran first)."""
    n = 1_048_576
    genomes, _, db = build_pruned_database("T8192")
    fq = _reads_fastq("T8192", genomes, n)
    extra = {}
    v = _time_e2e(_e2e_kw([db], fq, "e2e_soak"), n, timed_passes=2,
                  breakdown_into=extra, breakdown_key="e2e_soak_split")
    extra["e2e_soak"] = round(v, 1)
    return extra


def st_build():
    """Driver-visible build throughput (the reference always prints
    build Mbp/m — GanonBuild.cpp:700-720). Synthetic 64 Mbp through the production
    device build pipeline: ingest + count pass + sizing + scatter +
    bit-matrix fetch; random-sequence generation time is excluded
    (input synthesis, not build work)."""
    from ganon_tpu.index import sizing as _sizing
    from ganon_tpu.index.device_build import CHUNK, DeviceBuildPipeline

    rng = np.random.default_rng(21)

    def one_build(total_bp, n_targets):
        per_target = total_bp // n_targets
        pipe = DeviceBuildPipeline(K, W)
        t0 = time.time()
        gen = 0.0
        try:
            for t in range(n_targets):
                remaining = per_target
                while remaining > 0:
                    n = min(CHUNK, remaining)
                    g0 = time.time()
                    piece = rng.integers(0, 4, size=n, dtype=np.uint8)
                    gen += time.time() - g0
                    pipe.add_encoded((f"T{t}", 0), piece)
                    remaining -= n - (W - 1) if n == CHUNK else remaining
            pipe.finish_counts()
            hashes_count = {
                t: c for t, c in pipe.hashes_count().items() if c
            }
            icfg = _sizing.size_filter(
                hashes_count, kmer_size=K, window_size=W, max_fp=0.05
            )
            bits = np.asarray(pipe.scatter(icfg))
            assert bits.any()
        finally:
            pipe.close()
        return time.time() - t0 - gen, bits.nbytes

    one_build(8_000_000, 8)  # warm the extract/close/scatter compiles
    total_bp = 64_000_000
    wall, nbytes = one_build(total_bp, 32)
    mbpm = total_bp / 1e6 / (wall / 60)
    return {
        "build_mbp_per_min": round(mbpm, 1),
        "build_filter_mb": round(nbytes / 1e6, 1),
    }


def st_e2e_refdata():
    """The reference's bundled real assemblies + sim reads through the
    full build-custom + classify path (BASELINE.md north star data; the
    CPU side runs via scripts/diff_reference.py --time when reference
    binaries are available)."""
    import gzip

    data = "/root/reference/tests/ganon/data"
    if not os.path.isdir(data):
        log("refdata: reference test data not mounted, skipping")
        return {}
    db = os.path.join(CACHE_DIR, "refdata", "db")
    os.makedirs(os.path.dirname(db), exist_ok=True)
    if not os.path.exists(db + ".ibf"):
        from ganon_tpu.cli import main as ganon_main
        from ganon_tpu.config import Config

        ok = ganon_main(
            cfg=Config(
                "build-custom",
                db_prefix=db,
                input=[os.path.join(data, "build-custom/files")],
                input_extension="fna.gz",
                taxonomy="ncbi",
                taxonomy_files=[
                    os.path.join(data, "build-custom/taxdump.tar.gz")
                ],
                ncbi_file_info=[
                    os.path.join(data, "build-custom/assembly_summary.txt")
                ],
                genome_size_files=[
                    os.path.join(
                        data, "build-custom/species_genome_size.txt.gz"
                    )
                ],
                quiet=True,
            )
        )
        if not ok:
            log("refdata: build-custom failed, skipping")
            return {}
    # replicate the 98 sim pairs x1024 (~100k pairs) so the number
    # measures throughput, not per-run latency (the raw pair is
    # byte-tested in tests/test_reference_data.py)
    reps = 1024
    fqs = []
    for m in (1, 2):
        src = os.path.join(data, f"classify/sim.{m}.fq.gz")
        dst = os.path.join(CACHE_DIR, f"refdata_sim{reps}.{m}.fq")
        if not os.path.exists(dst):
            with gzip.open(src, "rb") as f:
                payload = f.read()
            with open(dst + ".tmp", "wb") as f:
                for _ in range(reps):
                    f.write(payload)
            os.replace(dst + ".tmp", dst)
        fqs.append(dst)
    n = (sum(1 for _ in open(fqs[0], "rb")) // 4)
    kw = _e2e_kw(
        [db + ".ibf"], fqs, "e2e_refdata",
        tax=[db + ".tax"], rel_cutoff=[0.25],
    )
    v = _time_e2e(kw, n)
    return {"e2e_refdata": round(v, 1)}


STAGES = {
    "kernel_micro": st_kernel_micro,
    "kernel_T32": st_kernel_T32,
    "e2e_T32": st_e2e_T32,
    "kernel_T1024": st_kernel_T1024,
    "e2e_T1024": st_e2e_T1024,
    "kernel_T8192": st_kernel_T8192,
    "e2e_T8192": st_e2e_T8192,
    "e2e_forest": st_e2e_forest,
    "e2e_hierarchy": st_e2e_hierarchy,
    "e2e_multifilter": st_e2e_multifilter,
    "e2e_mixedlen": st_e2e_mixedlen,
    "build": st_build,
    "e2e_soak": st_e2e_soak,
    "e2e_refdata": st_e2e_refdata,
}


# --------------------------------------------------------------------------
# child: run stages in-process, print BENCHSTAGE lines


def child_main(stage_names, deadline_at):
    import jax
    import jax.numpy as jnp


    log(f"child device: {jax.devices()[0]}")
    # device start-up, timed apart from every stage
    t0 = time.time()
    jax.block_until_ready(jnp.ones((8,), jnp.float32).sum())
    log(f"device first-execution warmup: {time.time() - t0:.1f}s")
    for name in stage_names:
        remaining = deadline_at - time.time() if deadline_at else float("inf")
        est = STAGE_EST.get(name, 60)
        if remaining < est and name != stage_names[-1]:
            # skipping protects LATER stages; the final stage has none,
            # so always attempt it — the parent's group kill bounds an
            # overrun and a partial loss costs nothing extra
            log(f"[{name}] skipped: {remaining:.0f}s left < ~{est}s needed")
            continue
        t0 = time.time()
        try:
            result = STAGES[name]()
        except Exception as e:
            log(f"[{name}] FAILED: {e!r}")
            continue
        log(f"[{name}] done in {time.time() - t0:.1f}s: {result}")
        if result:
            print("BENCHSTAGE " + json.dumps(result), flush=True)
    os._exit(0)


# --------------------------------------------------------------------------
# parent: orchestrate groups under the deadline, emit incrementally


def _emit(extra):
    """Print THE metric line from whatever has been measured so far.

    Headline: END-TO-END throughput in the easy regime (what a user
    gets, not just the kernel). Falls back to the kernel number, then
    to 0.0 (a visible failure that still parses — never rc!=0 with no
    line; reference stats always print, GanonClassify.cpp:1091-1128).
    """
    # every fallback stage carries its own bp-per-read so the Mbp/m
    # conversion (and vs_baseline) never assumes the wrong read length
    # for a substituted headline; all current candidates are paired
    # 150 bp (incl. refdata: the reference sim reads are 2 x 150 bp),
    # but the table is the contract, not the coincidence
    stage_bp = {
        "e2e_T32": 2 * READ_LEN, "e2e_T1024": 2 * READ_LEN,
        "e2e_forest": 2 * READ_LEN, "e2e_refdata": 2 * 150,
        "e2e_multifilter": 2 * READ_LEN, "e2e_hierarchy": 2 * READ_LEN,
        "kernel_T32": 2 * READ_LEN, "kernel_T1024": 2 * READ_LEN,
        "kernel_micro": 2 * READ_LEN,
    }
    e2e32, used = 0.0, "none"
    for key in stage_bp:
        if extra.get(key):
            e2e32, used = extra[key], key
            break
    if used != "none":
        extra = dict(extra, headline_stage=used)
    mbp_per_min = e2e32 * stage_bp.get(used, 0) / 1e6 * 60
    print(
        json.dumps(
            {
                "metric": "classify_e2e_reads_per_sec_chip",
                "value": round(e2e32, 1),
                "unit": "reads/s",
                "vs_baseline": round(mbp_per_min / BASELINE_MBP_PER_MIN, 3),
                "extra": extra,
            }
        ),
        flush=True,
    )


def parent_main():
    deadline = float(os.environ.get("GANON_BENCH_DEADLINE", "480"))
    t_start = time.time()
    reserve = 15.0  # parent overhead + final emit
    only = os.environ.get("GANON_BENCH_STAGES")
    extra: dict = {}
    _emit(extra)  # a parseable line exists from second 0

    if only:
        pending = [s.strip() for s in only.split(",") if s.strip()]
    else:
        pending = [s for _, stages, _ in GROUPS for s in stages]

    # ONE child runs ALL stages (device start-up and compiles paid
    # once). A crashed/hung child is relaunched with the remaining
    # stages — minus the stage that was in flight, which is not retried.
    import threading

    completed: set = set()
    attempt = 0
    while pending and attempt < 4:
        attempt += 1
        if deadline:
            remaining = deadline - (time.time() - t_start) - reserve
            if remaining <= 20:
                log(f"{len(pending)} stages skipped: {remaining:.0f}s left")
                break
            deadline_at = time.time() + remaining
        else:
            remaining, deadline_at = None, 0
        log(
            f"=== child {attempt}: {pending} "
            f"(budget {remaining and round(remaining)}s)"
        )
        cmd = [
            sys.executable, os.path.abspath(__file__),
            "--child", ",".join(pending), str(deadline_at),
        ]
        try:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=sys.stderr,
                text=True, start_new_session=True, cwd=REPO,
            )
        except Exception as e:
            log(f"child spawn failed: {e!r}")
            break

        def pump(p=proc):
            for line in p.stdout:
                line = line.strip()
                if line.startswith("BENCHSTAGE "):
                    try:
                        payload = json.loads(line[len("BENCHSTAGE "):])
                    except Exception:
                        continue
                    extra.update(payload)
                    completed.update(
                        k for k in payload if k in STAGE_EST
                    )
                    _emit(extra)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        killed = False
        try:
            proc.wait(timeout=(remaining + 15) if remaining else None)
        except subprocess.TimeoutExpired:
            log("child over deadline; killing")
            killed = True
            try:
                os.killpg(proc.pid, 9)
            except Exception:
                proc.kill()
            proc.wait()
        t.join(timeout=5)

        survivors = [s for s in pending if s not in completed]
        if not survivors or killed:
            break
        if proc.returncode == 0:
            # clean exit with stages left = the child's own budget
            # checks skipped them deliberately; nothing more to gain
            break
        # crash: drop the in-flight stage (first survivor), retry rest
        log(f"child died (rc={proc.returncode}) in stage "
            f"{survivors[0]}; continuing without it")
        pending = survivors[1:]

    _emit(extra)
    sys.exit(0)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        stages = [s for s in sys.argv[2].split(",") if s in STAGES]
        deadline_at = float(sys.argv[3]) if len(sys.argv) > 3 else 0
        child_main(stages, deadline_at)
    elif len(sys.argv) > 1 and sys.argv[1] == "--inproc":
        # debugging: all stages in this process, no budget
        extra = {}
        for name, fn in STAGES.items():
            extra.update(fn())
            _emit(extra)
    else:
        parent_main()


if __name__ == "__main__":
    main()
