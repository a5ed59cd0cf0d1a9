"""Merged-bin pruned forest: build, gating semantics, engine identity.

The pruned forest is a batched re-expression of the reference HIBF's
threshold-gated descent (hierarchical_interleaved_bloom_filter.hpp:
432-460): a coarse merged-bin IBF prunes target groups before the fine
gather. Its defined semantics are GATED (prune-only: a group below the
read's rel-cutoff threshold contributes no matches, exactly like the
reference's non-descent) — so the contract tested here is that the
fast S-slot kernel, the probe-all gated fallback, and every engine
entry point produce identical outputs, and that gating never drops a
true-hash match.
"""

import os

import numpy as np
import pytest

from ganon_tpu.index.pruned import (
    PrunedForest,
    build_pruned,
    is_pruned_file,
)

K, W = 19, 31


@pytest.fixture(scope="module")
def small_db():
    rng = np.random.default_rng(7)
    genomes = rng.integers(0, 4, size=(80, 3000), dtype=np.uint8)
    from ganon_tpu.ops.minimizers import window_mins_jax

    lens = np.full(80, 3000, dtype=np.int32)
    mv, valid = window_mins_jax(genomes, lens, k=K, w=W)
    mv, valid = np.asarray(mv), np.asarray(valid)
    th = {f"T{t}": np.unique(mv[t][valid[t]]) for t in range(80)}
    pf = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05,
                      group_size=16)
    return genomes, th, pf


def test_build_structure_and_roundtrip(small_db, tmp_path):
    genomes, th, pf = small_db
    assert pf.num_groups == 5
    assert sorted(pf.targets()) == sorted(th)
    # count-sorted grouping: group bin sizes are non-increasing
    assert (np.diff(pf.grp_bin_size) <= 0).all()
    # per-target fp: single fine bin, within the sizing target
    fprs = pf.target_fpr()
    assert max(fprs.values()) <= 0.05 * 1.05
    db = tmp_path / "db.hibf"
    pf.save(str(db))
    assert is_pruned_file(str(db))
    pf2 = PrunedForest.load(str(db))
    assert pf2.targets() == pf.targets()
    assert np.array_equal(pf2.fine, pf.fine)
    assert np.array_equal(pf2.coarse, pf.coarse)
    assert pf2.hashes_count == pf.hashes_count
    raw = tmp_path / "db_raw.hibf"
    pf.save_raw(str(raw))
    assert is_pruned_file(str(raw))
    pf3 = PrunedForest.load(str(raw))
    assert np.array_equal(np.asarray(pf3.fine), pf.fine)
    assert np.array_equal(np.asarray(pf3.coarse), pf.coarse)


def test_membership_and_gate_properties(small_db):
    """Inserted hashes always count; gating only ever removes counts;
    a true-hash match above cutoff is never gated away (superset
    property of the merged coarse bins)."""
    import jax.numpy as jnp

    from ganon_tpu.classify import device as dev

    genomes, th, pf = small_db
    f = dev.DevicePrunedForest(pf)
    targets = pf.targets()
    rng = np.random.default_rng(3)
    B, M = 8, 64
    hashes = np.zeros((B, M), dtype=np.uint64)
    mask = np.zeros((B, M), dtype=bool)
    own = []
    for b in range(B):
        t = targets[int(rng.integers(0, len(targets)))]
        hs = th[t][:40]
        hashes[b, :len(hs)] = hs
        mask[b, :len(hs)] = True
        own.append((t, len(hs)))
    nh = mask.sum(1).astype(np.int32)
    hj, mj, nj = jnp.asarray(hashes), jnp.asarray(mask), jnp.asarray(nh)
    c_un = np.asarray(f.counts(hj, mj, nj))
    c_g = np.asarray(f.counts_gated(hj, mj, nj, 0.25))
    assert (c_g <= c_un).all()
    for b, (t, n) in enumerate(own):
        ti = targets.index(t)
        assert c_un[b, ti] == n  # no false negatives
        assert c_g[b, ti] == n   # true-hash match survives the gate


def _write_reads(path, rng, genomes, n, noise_every=5, chimeric=()):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "w") as f:
        for i in range(n):
            if i in chimeric:
                t1, t2 = rng.integers(0, len(genomes), size=2)
                s1 = int(rng.integers(0, genomes.shape[1] - 75))
                s2 = int(rng.integers(0, genomes.shape[1] - 75))
                seq = (bases[genomes[t1, s1:s1 + 75]].tobytes()
                       + bases[genomes[t2, s2:s2 + 75]].tobytes()).decode()
            elif i % noise_every == noise_every - 1:
                seq = bases[rng.integers(0, 4, size=150)].tobytes().decode()
            else:
                t = int(rng.integers(0, len(genomes)))
                s = int(rng.integers(0, genomes.shape[1] - 150))
                seq = bases[genomes[t, s:s + 150]].tobytes().decode()
            f.write(f"@q{i}\n{seq}\n+\n{'I' * 150}\n")


def _run(db, reads, out, **over):
    from ganon_tpu.classify.engine import ClassifyConfig, run_classify

    kw = dict(
        ibf=[db], single_reads=[reads], output_prefix=out,
        rel_cutoff=[0.25], rel_filter=[0.1],
        output_all=True, output_unclassified=True, use_mesh=False,
    )
    kw.update(over)
    run_classify(ClassifyConfig(**kw))
    res = {}
    for ext in (".all", ".rep", ".unc"):
        if os.path.exists(out + ext):
            with open(out + ext) as fh:
                res[ext] = sorted(fh.read().splitlines())
    return res


def test_fast_path_equals_gated_slow_path(small_db, tmp_path):
    """classify_batch_packed_pruned == probe-all counts_gated through
    the full engine, byte for byte (the pruned layout's exactness
    contract)."""
    genomes, th, pf = small_db
    db = str(tmp_path / "db.hibf")
    pf.save(db)
    reads = str(tmp_path / "r.fq")
    _write_reads(reads, np.random.default_rng(11), genomes, 400)
    fast = _run(db, reads, str(tmp_path / "fast"))
    slow = _run(db, reads, str(tmp_path / "slow"),
                device_thresholding=False)
    assert fast == slow
    assert len(fast[".all"]) > 100  # the run classified something


def test_group_overflow_falls_back_identical(small_db, tmp_path):
    """Chimeric reads survive in >S groups; the overflow flag must route
    them through the gated fallback with identical results."""
    genomes, th, pf = small_db
    db = str(tmp_path / "db.hibf")
    pf.save(db)
    reads = str(tmp_path / "r.fq")
    # many chimeric reads + low cutoff -> multi-group survivors
    _write_reads(reads, np.random.default_rng(13), genomes, 200,
                 chimeric=set(range(0, 200, 3)))
    wide = _run(db, reads, str(tmp_path / "s4"), rel_cutoff=[0.1])
    narrow = _run(db, reads, str(tmp_path / "s1"), rel_cutoff=[0.1],
                  pruned_max_groups=1)
    assert wide == narrow


def test_pair_compaction_identical_outputs(small_db, tmp_path):
    """(read, slot) pair compaction (pruned_pair_frac) must not change
    outputs at any cap: ample cap computes the same counts; a cap too
    small for the batch spills reads to the exact fallback."""
    genomes, th, pf = small_db
    db = str(tmp_path / "db.hibf")
    pf.save(db)
    reads = str(tmp_path / "r.fq")
    _write_reads(reads, np.random.default_rng(31), genomes, 300,
                 chimeric=set(range(0, 300, 7)))
    on = _run(db, reads, str(tmp_path / "on"), rel_cutoff=[0.2])
    off = _run(db, reads, str(tmp_path / "off"), rel_cutoff=[0.2],
               pruned_pair_frac=0.0)
    tiny = _run(db, reads, str(tmp_path / "tiny"), rel_cutoff=[0.2],
                pruned_pair_frac=0.01)
    assert on == off == tiny
    assert len(on[".all"]) > 100


def test_pair_compaction_kernel_identity(small_db):
    """Kernel level: pair_cap ample == dense byte-for-byte; a tiny cap
    only ever sets overflow flags (spilled reads), never corrupts the
    non-overflow reads' matches."""
    from ganon_tpu.classify import device as dev

    genomes, th, pf = small_db
    f = dev.DevicePrunedForest(pf)
    rng = np.random.default_rng(37)
    B = 64
    rows = []
    for _ in range(B):
        t = int(rng.integers(0, 80))
        s = int(rng.integers(0, genomes.shape[1] - 150))
        rows.append(genomes[t, s:s + 150])
    codes = np.stack(rows).astype(np.uint8)
    l1 = np.full(B, 150, np.int32)
    inbuf = dev.pack_batch_input(codes, l1, None, None)
    kw = dict(k=K, w=W, L1=150, L2=0, coarse_bin_size=f.coarse_bin_size,
              coarse_h=f.coarse_h, fine_h=f.fine_h, max_groups=2,
              group_size=f.group_size, num_targets=f.num_targets,
              top_k=16)
    args = (f.ctbl, f.ftbl, f.grp_row_off, f.grp_bin_size, f.grp_shift,
            f.grp_ntargets, inbuf, 0.25, 0.1, 65535)
    dense = np.asarray(
        dev.classify_batch_packed_pruned(*args, **kw, pair_cap=0))
    ample = np.asarray(
        dev.classify_batch_packed_pruned(*args, **kw, pair_cap=B * 2))
    assert np.array_equal(dense, ample)
    tiny = np.asarray(
        dev.classify_batch_packed_pruned(*args, **kw, pair_cap=8))
    rd = dev.unpack_batch_result(dense, B, 16, f.num_targets, True,
                                 False, n_extra=1)
    rt = dev.unpack_batch_result(tiny, B, 16, f.num_targets, True,
                                 False, n_extra=1)
    assert rt["overflow"].any()  # the tiny cap spilled someone
    keep = ~rt["overflow"]
    assert keep.any()
    for key in ("top_idx", "top_vals", "n_matches"):
        assert np.array_equal(rd[key][keep], rt[key][keep]), key


def test_bins_sharded_counts_identical(small_db):
    """BinShardedPrunedForest (fine table group-strided over the mesh
    bins axis) must produce bit-identical gated counts to the
    single-device forest, including pad groups when G does not divide
    the shard count."""
    import jax
    import jax.numpy as jnp

    from ganon_tpu.classify import device as dev
    from ganon_tpu.parallel.mesh import make_mesh
    from ganon_tpu.parallel.pruned_shard import BinShardedPrunedForest

    genomes, th, pf8 = small_db
    # group_size=8 -> 10 groups over a bins axis of 4: shards hold
    # 3/3/2/2 groups (pad groups exercised)
    pf = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05,
                      group_size=8)
    mesh = make_mesh(jax.devices())
    assert mesh.shape["bins"] > 1
    sh = BinShardedPrunedForest(pf, mesh)

    rng = np.random.default_rng(53)
    B, M = 48, 64
    hashes = np.zeros((B, M), np.uint64)
    mask = np.zeros((B, M), bool)
    targets = pf.targets()
    for b in range(B):
        if b % 5 == 4:
            hs = rng.integers(0, 2**62, size=30, dtype=np.uint64)
        else:
            hs = th[targets[int(rng.integers(0, len(targets)))]][:40]
        hashes[b, :len(hs)] = hs
        mask[b, :len(hs)] = True
    nh = mask.sum(1).astype(np.int32)
    ref = np.asarray(dev.DevicePrunedForest(pf).counts_gated(
        jnp.asarray(hashes), jnp.asarray(mask), jnp.asarray(nh), 0.25
    ))
    got = sh.counts_gated(hashes, mask, nh, 0.25)
    assert np.array_equal(got, ref)
    assert ref.any()  # the check is not vacuous


def test_engine_mesh_outputs_match_single_device(small_db, tmp_path):
    genomes, th, pf = small_db
    import jax

    db = str(tmp_path / "db.hibf")
    pf.save(db)
    reads = str(tmp_path / "r.fq")
    _write_reads(reads, np.random.default_rng(17), genomes, 256)
    meshed = _run(db, reads, str(tmp_path / "mesh"), use_mesh=True)
    single = _run(db, reads, str(tmp_path / "single"), use_mesh=False)
    assert len(jax.devices()) > 1  # conftest pins 8 virtual devices
    assert meshed == single


def test_true_reads_classified_to_source_target(small_db, tmp_path):
    """Every error-free read drawn from a target must keep that target
    among its matches (gating never loses true matches end-to-end)."""
    genomes, th, pf = small_db
    db = str(tmp_path / "db.hibf")
    pf.save(db)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(23)
    reads = str(tmp_path / "r.fq")
    src = []
    with open(reads, "w") as f:
        for i in range(200):
            t = int(rng.integers(0, 80))
            s = int(rng.integers(0, 3000 - 150))
            seq = bases[genomes[t, s:s + 150]].tobytes().decode()
            f.write(f"@q{i}\n{seq}\n+\n{'I' * 150}\n")
            src.append(f"T{t}")
    res = _run(db, reads, str(tmp_path / "out"), rel_cutoff=[0.75])
    matches = {}
    for line in res[".all"]:
        rid, t, c = line.split("\t")
        matches.setdefault(rid, set()).add(t)
    for i, t in enumerate(src):
        assert t in matches.get(f"q{i}", set()), (i, t)


def test_device_build_identical_to_host(small_db):
    """The jitted sort-scatter build (chunked, dedup + OR on
    device) produces bit-identical fine/coarse tables to the host numpy
    scatter — same insert set, idempotent OR."""
    genomes, th, pf_host = small_db
    pf_dev = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05,
                          group_size=16, device=True)
    assert np.array_equal(pf_dev.fine, pf_host.fine)
    assert np.array_equal(np.ascontiguousarray(pf_dev.coarse),
                          pf_host.coarse)
    assert pf_dev.targets() == pf_host.targets()
    assert np.array_equal(pf_dev.grp_bin_size, pf_host.grp_bin_size)
    assert pf_dev.coarse_bin_size == pf_host.coarse_bin_size


def test_many_targets_beyond_u16(tmp_path):
    """The pruned fast path has no T <= 65535 bound (matches ship as
    lane ids + per-read surviving-group words; RefSeq-scale databases
    hold hundreds of thousands of targets): 70,000 tiny targets, reads
    made of their exact hashes, fast path == gated slow path and every
    read maps back to its true (high-id) target."""
    import jax.numpy as jnp

    from ganon_tpu.classify import device as dev

    rng = np.random.default_rng(41)
    T = 70_000
    # distinct 24-hash sets per target (disjoint id ranges, no overlap)
    base = np.arange(T, dtype=np.uint64) * np.uint64(1 << 32)
    th = {
        f"T{i}": base[i] + np.arange(24, dtype=np.uint64)
        for i in range(T)
    }
    pf = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05)
    assert pf.num_groups == -(-T // 64)
    f = dev.DevicePrunedForest(pf)
    assert f.num_targets == T > 0xFFFF

    targets = pf.targets()
    B, M = 64, 32
    hashes = np.zeros((B, M), dtype=np.uint64)
    mask = np.zeros((B, M), dtype=bool)
    pick = rng.integers(0, T, size=B)
    for b in range(B):
        hs = th[targets[pick[b]]]
        hashes[b, :len(hs)] = hs
        mask[b, :len(hs)] = True
    nh = mask.sum(1).astype(np.int32)

    # fast kernel (via the packed program on synthetic codes is heavy
    # to arrange here; drive the device kernel parts directly)
    hj, mj, nj = jnp.asarray(hashes), jnp.asarray(mask), jnp.asarray(nh)
    c_gated = np.asarray(f.counts_gated(hj, mj, nj, 0.75))
    for b in range(B):
        ti = pick[b]
        assert c_gated[b, ti] == 24, (b, ti)
    # each read's own target is the (unique) confident match
    cutoff = np.ceil(nh * 0.75)
    assert ((c_gated >= cutoff[:, None]).sum(axis=1) >= 1).all()


def test_engine_many_targets_fast_path(tmp_path):
    """run_classify end-to-end on a 66k-target pruned db with the REAL
    targets sorted last (global ids > 65535): reads must classify to
    their source targets through the fast path's lane->global mapping,
    and fast == gated slow path byte-for-byte."""
    from ganon_tpu.ops.minimizers import window_mins_jax

    rng = np.random.default_rng(43)
    n_dummy, n_real = 65_990, 10
    # dummies: 150 synthetic hashes each — more than any real target's
    # minimizer count, so count-sorted grouping puts the real targets
    # at the HIGHEST global ids (beyond u16)
    base = np.arange(n_dummy, dtype=np.uint64) * np.uint64(1 << 33)
    th = {f"D{i}": base[i] + np.arange(150, dtype=np.uint64)
          for i in range(n_dummy)}
    genomes = rng.integers(0, 4, size=(n_real, 600), dtype=np.uint8)
    lens = np.full(n_real, 600, dtype=np.int32)
    mv, valid = window_mins_jax(genomes, lens, k=K, w=W)
    mv, valid = np.asarray(mv), np.asarray(valid)
    for t in range(n_real):
        hs = np.unique(mv[t][valid[t]])
        assert len(hs) < 150
        th[f"R{t}"] = hs  # ALL minimizers: reads always covered
    pf = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05)
    targets = pf.targets()
    for t in range(n_real):
        assert targets.index(f"R{t}") > 0xFFFF  # real ids beyond u16
    db = str(tmp_path / "big.hibf")
    pf.save(db)

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = str(tmp_path / "r.fq")
    src = []
    with open(reads, "w") as f:
        for i in range(60):
            t = int(rng.integers(0, n_real))
            s = int(rng.integers(0, 600 - 300))
            seq = bases[genomes[t, s:s + 300]].tobytes().decode()
            f.write(f"@q{i}\n{seq}\n+\n{'I' * 300}\n")
            src.append(f"R{t}")
    fast = _run(db, reads, str(tmp_path / "fast"), rel_cutoff=[0.2])
    slow = _run(db, reads, str(tmp_path / "slow"), rel_cutoff=[0.2],
                device_thresholding=False)
    assert fast == slow
    matches = {}
    for line in fast[".all"]:
        rid, t, c = line.split("\t")
        matches.setdefault(rid, set()).add(t)
    for i, t in enumerate(src):
        assert t in matches.get(f"q{i}", set()), (i, t)


def test_run_build_hibf_layout_selection(tmp_path):
    """layout='pruned' builds a pruned container through the build
    entry point; 'auto' keeps the forest below the target threshold."""
    from ganon_tpu.index.hibf import HIBF, run_build_hibf

    rng = np.random.default_rng(29)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    info = tmp_path / "info.tsv"
    lines = []
    for t in range(6):
        fa = tmp_path / f"t{t}.fa"
        seq = bases[rng.integers(0, 4, size=800)].tobytes().decode()
        fa.write_text(f">s{t}\n{seq}\n")
        lines.append(f"{fa}\tT{t}\n")
    info.write_text("".join(lines))

    out_p = str(tmp_path / "pruned.hibf")
    got = run_build_hibf(
        target_info_file=str(info), output_file=out_p, kmer_size=K,
        window_size=W, max_fp=0.05, layout="pruned",
    )
    assert isinstance(got, PrunedForest)
    assert is_pruned_file(out_p)
    from ganon_tpu.classify.device import load_device_filter

    f = load_device_filter(out_p)
    assert f.num_targets == 6

    out_f = str(tmp_path / "forest.hibf")
    got = run_build_hibf(
        target_info_file=str(info), output_file=out_f, kmer_size=K,
        window_size=W, max_fp=0.05, layout="auto",
    )
    assert isinstance(got, HIBF)  # 6 targets < PRUNED_AUTO_MIN_TARGETS
    assert not is_pruned_file(out_f)
