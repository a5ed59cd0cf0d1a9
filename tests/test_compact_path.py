"""Device-thresholded compact path must match the full-matrix path."""

import filecmp
import os
import random

import pytest

from ganon_tpu.classify.engine import ClassifyConfig, run_classify
from tests.test_classify import build_db, write_fastq, write_tax, read_tsv


@pytest.mark.parametrize("fpr_query", [1.0, 1e-3])
@pytest.mark.parametrize("rel_filter", [0.0, 0.5])
def test_compact_equals_full(tmp_path, rel_filter, fpr_query):
    rng = random.Random(11)
    refs = {
        f"T{i}": "".join(rng.choice("ACGT") for _ in range(300))
        for i in range(8)
    }
    db = build_db(tmp_path, refs, k=10, w=12, max_fp=0.01)
    tax_rows = [("1", "0", "no rank", "root")] + [
        (t, "1", "species", t) for t in refs
    ]
    tax = write_tax(tmp_path / "db.tax", tax_rows)

    reads = {}
    for i in range(60):
        t = f"T{i % 8}"
        s = rng.randint(0, 250)
        reads[f"q{i}"] = refs[t][s : s + rng.randint(20, 50)]
    for i in range(10):
        reads[f"junk{i}"] = "".join(rng.choice("ACGT") for _ in range(40))
    fq = tmp_path / "reads.fq"
    write_fastq(fq, reads)

    outputs = {}
    for mode in (True, False):
        out = str(tmp_path / f"m{mode}")
        cfg = ClassifyConfig(
            ibf=[db],
            tax=[tax],
            single_reads=[str(fq)],
            output_prefix=out,
            rel_cutoff=[0.3],
            rel_filter=[rel_filter],
            fpr_query=[fpr_query],
            output_lca=True,
            output_all=True,
            output_unclassified=True,
            output_stats=True,
            device_thresholding=mode,
        )
        stats = run_classify(cfg)
        outputs[mode] = (out, stats)

    for ext in (".one", ".unc", ".rep", ".sta"):
        a = sorted(map(tuple, read_tsv(outputs[True][0] + ext)))
        b = sorted(map(tuple, read_tsv(outputs[False][0] + ext)))
        assert a == b, ext
    # .all compared as sets (match order differs between paths)
    a = sorted(map(tuple, read_tsv(outputs[True][0] + ".all")))
    b = sorted(map(tuple, read_tsv(outputs[False][0] + ".all")))
    assert a == b

    ta = outputs[True][1]["totals"][""]
    tb = outputs[False][1]["totals"][""]
    for f in (
        "seqs_processed", "seqs_classified", "matches", "seqs_unique",
        "discarded_matches_filter", "discarded_matches_fprquery",
        "kmers_matches", "kmers_from_classified_seqs",
    ):
        assert getattr(ta, f) == getattr(tb, f), f


def test_topk_overflow_fallback(tmp_path):
    # many targets share the same sequence -> every read matches all of
    # them, exceeding top_k -> engine must fall back and still be correct
    rng = random.Random(3)
    seq = "".join(rng.choice("ACGT") for _ in range(100))
    refs = {f"S{i}": seq for i in range(12)}
    db = build_db(tmp_path, refs, k=10, w=12, max_fp=0.001)
    reads = {"r0": seq[10:60]}
    fq = tmp_path / "r.fq"
    write_fastq(fq, reads)
    out = str(tmp_path / "ov")
    cfg = ClassifyConfig(
        ibf=[db],
        single_reads=[str(fq)],
        output_prefix=out,
        rel_cutoff=[0.3],
        output_all=True,
        device_thresholding=True,
        top_k_matches=4,  # force overflow
    )
    run_classify(cfg)
    allm = read_tsv(out + ".all")
    assert len(allm) == 12  # all 12 identical targets reported


def test_u32_table_fast_path_equals_slow_path(tmp_path):
    """DeviceFilter holds its table as the u32 word view, and the packed
    single-dispatch fast path on it reproduces the host slow path's
    outputs end to end."""
    import ganon_tpu.classify.device as devmod

    rng = random.Random(23)
    refs = {
        f"T{i}": "".join(rng.choice("ACGT") for _ in range(300))
        for i in range(8)
    }
    db = build_db(tmp_path, refs, k=10, w=12, max_fp=0.01)
    reads = {}
    for i in range(60):
        t = f"T{i % 8}"
        s = rng.randint(0, 250)
        reads[f"q{i}"] = refs[t][s : s + rng.randint(20, 50)]
    fq = tmp_path / "reads.fq"
    write_fastq(fq, reads)

    import jax.numpy as jnp
    from ganon_tpu.index.ibf import IBF

    assert devmod.DeviceFilter(IBF.load(db)).tbl.dtype == jnp.uint32
    outputs = {}
    for fast in (False, True):
        out = str(tmp_path / f"fast{fast}")
        cfg = ClassifyConfig(
            ibf=[db],
            single_reads=[str(fq)],
            output_prefix=out,
            rel_cutoff=[0.3],
            rel_filter=[0.2],
            output_all=True,
            output_unclassified=True,
            device_thresholding=fast,
        )
        run_classify(cfg)
        outputs[fast] = out

    for ext in (".one", ".unc", ".rep", ".all"):
        a = sorted(map(tuple, read_tsv(outputs[False] + ext)))
        b = sorted(map(tuple, read_tsv(outputs[True] + ext)))
        assert a == b, ext


def test_fallback_gather_slicing_equals_unsliced(tmp_path, monkeypatch):
    """The full-matrix fallback's batch slicing (bounds [B, M, W] gather
    temps for uncompacted long reads) must not change any output."""
    import ganon_tpu.classify.engine as eng

    rng = random.Random(31)
    refs = {
        f"T{i}": "".join(rng.choice("ACGT") for _ in range(6000))
        for i in range(4)
    }
    # k=10/w=12 emission density (~0.5) overflows the 1/5 compaction
    # width, forcing the uncompacted fallback the slicing protects
    db = build_db(tmp_path, refs, k=10, w=12, max_fp=0.01)
    reads = {}
    for i in range(12):
        t = f"T{i % 4}"
        s = rng.randint(0, 1000)
        reads[f"q{i}"] = refs[t][s : s + 4000]
    fq = tmp_path / "reads.fq"
    write_fastq(fq, reads)

    outputs = {}
    for sliced in (False, True):
        if sliced:
            # M ~ 4000 positions, batch pads to 64 rows: a budget of
            # 16*4096 forces step 16 -> 4 slices per batch
            monkeypatch.setattr(eng, "_FALLBACK_GATHER_ROWS", 16 * 4096)
        else:
            monkeypatch.undo()
        out = str(tmp_path / f"s{sliced}")
        cfg = ClassifyConfig(
            ibf=[db],
            single_reads=[str(fq)],
            output_prefix=out,
            rel_cutoff=[0.3],
            rel_filter=[0.2],
            output_all=True,
            output_unclassified=True,
            output_stats=True,
        )
        run_classify(cfg)
        outputs[sliced] = out

    for ext in (".one", ".unc", ".rep", ".all", ".sta"):
        a = sorted(map(tuple, read_tsv(outputs[False] + ext)))
        b = sorted(map(tuple, read_tsv(outputs[True] + ext)))
        assert a == b, ext


@pytest.mark.parametrize("fpr_query", [1.0, 1e-3])
def test_multi_filter_fast_equals_slow(tmp_path, fpr_query):
    """The multi-filter single-dispatch fast path (per-filter
    rel-cutoffs, strict-greater union merge, winner-filter fpr) must
    match the host slow path, including ambiguous targets present in
    both databases with different content."""
    rng = random.Random(41)
    refs1 = {
        f"T{i}": "".join(rng.choice("ACGT") for _ in range(300))
        for i in range(5)
    }
    # AMB exists in both dbs with overlapping-but-different content so
    # either filter can win a read, exercising the winner payload
    amb_core = "".join(rng.choice("ACGT") for _ in range(200))
    refs1["AMB"] = amb_core + "".join(rng.choice("ACGT") for _ in range(100))
    refs2 = {
        f"S{i}": "".join(rng.choice("ACGT") for _ in range(300))
        for i in range(4)
    }
    refs2["AMB"] = "".join(rng.choice("ACGT") for _ in range(80)) + amb_core
    db1 = build_db(tmp_path, refs1, name="db1", k=10, w=12, max_fp=0.05)
    db2 = build_db(tmp_path, refs2, name="db2", k=10, w=12, max_fp=0.01)

    reads = {}
    pool = {**refs1, **refs2}
    keys = sorted(pool)
    for i in range(80):
        t = keys[i % len(keys)]
        s = rng.randint(0, 200)
        reads[f"q{i}"] = pool[t][s : s + rng.randint(25, 60)]
    for i in range(10):
        reads[f"amb{i}"] = amb_core[i * 10 : i * 10 + 50]
    fq = tmp_path / "reads.fq"
    write_fastq(fq, reads)

    outputs = {}
    for mode in (True, False):
        out = str(tmp_path / f"mf{mode}{fpr_query}")
        cfg = ClassifyConfig(
            ibf=[db1, db2],
            single_reads=[str(fq)],
            output_prefix=out,
            rel_cutoff=[0.3, 0.5],  # per-filter cutoffs
            rel_filter=[0.4],
            fpr_query=[fpr_query],
            output_all=True,
            output_unclassified=True,
            output_stats=True,
            device_thresholding=mode,
        )
        stats = run_classify(cfg)
        outputs[mode] = (out, stats)
        if mode:
            # the fast path must actually have engaged (pack16 bounds ok)
            assert len(read_tsv(out + ".all")) > 0

    for ext in (".one", ".unc", ".rep", ".sta", ".all"):
        a = sorted(map(tuple, read_tsv(outputs[True][0] + ext)))
        b = sorted(map(tuple, read_tsv(outputs[False][0] + ext)))
        assert a == b, ext

    ta = outputs[True][1]["totals"][""]
    tb = outputs[False][1]["totals"][""]
    for f in (
        "seqs_processed", "seqs_classified", "matches", "seqs_unique",
        "discarded_matches_filter", "discarded_matches_fprquery",
        "kmers_matches", "kmers_from_classified_seqs",
    ):
        assert getattr(ta, f) == getattr(tb, f), f


def test_threshold_topk_sort16_equals_topk():
    """The packed u32 single-sort top-K must reproduce lax.top_k exactly
    (descending count, ascending index on ties), incl. the winner
    payload variant."""
    import numpy as np
    import jax.numpy as jnp

    from ganon_tpu.classify.device import threshold_topk

    rng = np.random.default_rng(7)
    B, T = 64, 300
    counts = rng.integers(0, 50, size=(B, T)).astype(np.int32)
    counts[rng.random((B, T)) < 0.8] = 0
    nh = rng.integers(1, 60, size=B).astype(np.int32)
    counts = np.minimum(counts, nh[:, None])
    args = (jnp.asarray(counts), jnp.asarray(nh), jnp.float64(0.2),
            jnp.float64(0.6), jnp.int32(65535))
    a = {k: np.asarray(v) for k, v in threshold_topk(
        *args, top_k=16, sort16=False).items()}
    b = {k: np.asarray(v) for k, v in threshold_topk(
        *args, top_k=16, sort16=True).items()}
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    winners = jnp.asarray(rng.integers(0, 3, size=(B, T)), dtype=jnp.int32)
    c = threshold_topk(*args, top_k=16, sort16=True, winners=winners)
    assert np.array_equal(np.asarray(c["top_vals"]), a["top_vals"])
    assert np.array_equal(np.asarray(c["top_idx"]), a["top_idx"])
    # winner payload rides with its match
    tw = np.asarray(c["top_win"])
    ti = np.asarray(c["top_idx"])
    nm = np.asarray(c["n_matches"])
    wn = np.asarray(winners)
    for i in range(B):
        for j in range(int(nm[i]) if nm[i] <= 16 else 0):
            assert tw[i, j] == wn[i, ti[i, j]]


def test_adaptive_topk_escalation(tmp_path):
    """More matches than the initial compact width (32): the engine must
    widen to --top-k-matches and still produce full-path-identical
    outputs (no silent truncation of .all)."""
    rng = random.Random(31)
    shared = "".join(rng.choice("ACGT") for _ in range(200))
    # 40 targets sharing one sequence -> every read matches all 40
    refs = {f"T{i:02d}": shared for i in range(40)}
    db = build_db(tmp_path, refs, k=10, w=12, max_fp=0.01)
    reads = {f"q{i}": shared[i : i + 60] for i in range(0, 100, 10)}
    fq = tmp_path / "reads.fq"
    write_fastq(fq, reads)

    outs = {}
    for tag, fast in (("fast", True), ("full", False)):
        out = str(tmp_path / tag)
        run_classify(ClassifyConfig(
            ibf=[db], single_reads=[str(fq)], output_prefix=out,
            rel_cutoff=[0.1], output_all=True, output_unclassified=True,
            device_thresholding=fast,
        ))
        outs[tag] = {
            ext: sorted(open(out + ext).read().splitlines())
            for ext in (".all", ".rep", ".unc")
        }
    assert outs["fast"] == outs["full"]
    # every read must carry all 40 matches in .all
    from collections import Counter

    per_read = Counter(line.split("\t")[0]
                       for line in outs["fast"][".all"])
    assert all(v == 40 for v in per_read.values()), per_read


def test_ragged_match_cap_escalation(tmp_path):
    # every read matches all 40 targets: the ragged match stream (cap =
    # 2 slots/read) must overflow, escalate sticky, and still produce
    # the full match set (device.unpack_batch_result_ragged +
    # engine cap-overflow re-dispatch)
    rng = random.Random(9)
    seq = "".join(rng.choice("ACGT") for _ in range(120))
    refs = {f"S{i}": seq for i in range(40)}
    db = build_db(tmp_path, refs, k=10, w=12, max_fp=0.001)
    reads = {f"r{j}": seq[5:80] for j in range(10)}
    fq = tmp_path / "r.fq"
    write_fastq(fq, reads)
    out = str(tmp_path / "rc")
    cfg = ClassifyConfig(
        ibf=[db],
        single_reads=[str(fq)],
        output_prefix=out,
        rel_cutoff=[0.3],
        output_all=True,
        device_thresholding=True,
    )
    run_classify(cfg)
    allm = read_tsv(out + ".all")
    assert len(allm) == 400  # 10 reads x 40 identical targets
    by_read = {}
    for rid, t, v in allm:
        by_read.setdefault(rid, set()).add(t)
    assert all(len(s) == 40 for s in by_read.values())


def test_multi_filter_ragged_cap_escalation(tmp_path):
    # two dbs holding the same 20 copies of one sequence: every read
    # matches 40 union targets, overflowing the ragged cap on the
    # MULTI fast path (winner payload rides a second compacted stream)
    rng = random.Random(13)
    seq = "".join(rng.choice("ACGT") for _ in range(120))
    db1 = build_db(tmp_path, {f"A{i}": seq for i in range(20)},
                   name="db1", k=10, w=12, max_fp=0.001)
    db2 = build_db(tmp_path, {f"B{i}": seq for i in range(20)},
                   name="db2", k=10, w=12, max_fp=0.001)
    reads = {f"r{j}": seq[5:80] for j in range(10)}
    fq = tmp_path / "r.fq"
    write_fastq(fq, reads)
    outputs = {}
    for mode in (True, False):
        out = str(tmp_path / f"mc{mode}")
        run_classify(ClassifyConfig(
            ibf=[db1, db2],
            single_reads=[str(fq)],
            output_prefix=out,
            rel_cutoff=[0.3],
            output_all=True,
            device_thresholding=mode,
        ))
        outputs[mode] = out
    a = sorted(map(tuple, read_tsv(outputs[True] + ".all")))
    b = sorted(map(tuple, read_tsv(outputs[False] + ".all")))
    assert len(a) == 400 and a == b


def test_threshold_topk_argmax_tier_matches_oracle():
    """k<=8 at T>=2048 takes the iterative-argmax tier; results must
    equal a numpy sort oracle (desc count, asc index ties), with and
    without the winners payload."""
    import jax.numpy as jnp
    import numpy as np

    from ganon_tpu.classify.device import threshold_topk

    rng = np.random.default_rng(5)
    B, T, k = 64, 4096, 4
    counts = rng.integers(0, 300, size=(B, T)).astype(np.int32)
    counts[rng.random((B, T)) < 0.995] = 0
    n_hashes = np.full(B, 300, dtype=np.int32)
    winners = rng.integers(0, 3, size=(B, T)).astype(np.int32)

    res = threshold_topk(
        jnp.asarray(counts), jnp.asarray(n_hashes), 0.1, 1.0, 65535,
        top_k=k, sort16=True, winners=jnp.asarray(winners),
    )
    tv = np.asarray(res["top_vals"])
    ti = np.asarray(res["top_idx"])
    tw = np.asarray(res["top_win"])

    cutoff = np.maximum(np.ceil(n_hashes * 0.1), 1).astype(np.int32)
    fvals = np.where(counts >= cutoff[:, None], counts, 0)
    # oracle: desc value, asc index on ties
    order = np.lexsort((np.arange(T)[None, :].repeat(B, 0), -fvals),
                       axis=1)[:, :k]
    want_v = np.take_along_axis(fvals, order, axis=1)
    assert np.array_equal(tv, want_v)
    got_v_at_idx = np.take_along_axis(fvals, ti % T, axis=1)
    assert np.array_equal(np.where(want_v > 0, got_v_at_idx, 0),
                          want_v)
    # tie order exact: indices match the lexsort oracle wherever v>0
    assert np.array_equal(np.where(want_v > 0, ti, 0),
                          np.where(want_v > 0, order, 0))
    assert np.array_equal(
        np.where(want_v > 0, tw, 0),
        np.where(want_v > 0, np.take_along_axis(winners, order, 1), 0),
    )


def test_wide_table_fast_slow_equality(tmp_path):
    """4096-target db: the K=4 argmax start tier + overflow escalation
    must match the host slow path line for line."""
    import numpy as np

    from ganon_tpu.classify.engine import ClassifyConfig, run_classify
    from ganon_tpu.index.ibf import build_ibf
    from ganon_tpu.ops.minimizers import encode_seqs, minimizers_golden

    rng = np.random.default_rng(6)
    bases = "ACGT"
    k, w = 10, 12
    refs = {
        f"T{i:04d}": "".join(
            bases[int(b)] for b in rng.integers(0, 4, size=300)
        )
        for i in range(4096)
    }
    th = {
        t: np.unique(np.asarray(
            minimizers_golden(s, k=k, w=w), dtype=np.uint64))
        for t, s in refs.items()
    }
    ibf = build_ibf(th, kmer_size=k, window_size=w, max_fp=0.05)
    db = str(tmp_path / "wide.ibf")
    ibf.save(db)

    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(50):
            t = f"T{i % 4096:04d}"
            s = int(rng.integers(0, 240))
            f.write(f"@q{i}\n{refs[t][s:s + 60]}\n+\n{'I' * 60}\n")

    outs = {}
    for mode in (True, False):
        out = str(tmp_path / f"w{mode}")
        run_classify(ClassifyConfig(
            ibf=[db], single_reads=[str(fq)], output_prefix=out,
            # lax thresholds force multi-matches (fp hits) so the
            # overflow escalation from K=4 fires too
            rel_cutoff=[0.1], rel_filter=[1.0], fpr_query=[1.0],
            output_all=True, output_unclassified=True,
            device_thresholding=mode,
        ))
        res = {}
        for ext in (".all", ".one", ".unc", ".rep"):
            import os

            if os.path.exists(out + ext):
                with open(out + ext) as f:
                    res[ext] = sorted(f.read().splitlines())
        outs[mode] = res
    assert outs[True] == outs[False]
