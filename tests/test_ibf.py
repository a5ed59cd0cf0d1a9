"""IBF build/query: round-trip property, fp bound, persistence.

Mirrors the reference contract tests: every inserted minimizer must be
found in its target's bins (GanonBuild.test.cpp validate_elements), and the
achieved max fp must respect the configured bound (validate_filter).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ganon_tpu.index import IBF, build_ibf
from ganon_tpu.ops.ibf_query import (
    bulk_count_bins,
    ibf_row_indices,
    ibf_row_indices_np,
    target_counts,
)
from ganon_tpu.ops.minimizers import encode_seqs, minimizers_jax


def _random_target_hashes(rng, n_targets, lo=50, hi=900):
    out = {}
    for i in range(n_targets):
        n = rng.integers(lo, hi)
        h = rng.integers(0, 2**62, size=n, dtype=np.uint64)
        out[f"T{i}"] = np.unique(h)
    return out


def test_row_indices_np_jax_agree():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2**64, size=500, dtype=np.uint64)
    for bin_size in (97, 8192, 1 << 20, (1 << 31) + 7):
        a = ibf_row_indices_np(h, bin_size=bin_size, hash_functions=5)
        b = np.asarray(
            ibf_row_indices(jnp.asarray(h), bin_size=bin_size, hash_functions=5)
        )
        assert (a == b).all()
        assert a.min() >= 0 and a.max() < bin_size


def test_build_roundtrip_all_hashes_found():
    rng = np.random.default_rng(1)
    th = _random_target_hashes(rng, 6)
    ibf = build_ibf(th, kmer_size=19, window_size=31, max_fp=0.05)

    tb = ibf.target_bins()
    targets = list(th)
    M = max(len(h) for h in th.values())
    hs = np.zeros((len(targets), M), dtype=np.uint64)
    mask = np.zeros((len(targets), M), dtype=bool)
    for i, t in enumerate(targets):
        hs[i, : len(th[t])] = th[t]
        mask[i, : len(th[t])] = True
    rows = ibf_row_indices(
        jnp.asarray(hs),
        bin_size=ibf.ibf_config.bin_size_bits,
        hash_functions=ibf.ibf_config.hash_functions,
    )
    counts = np.asarray(
        bulk_count_bins(jnp.asarray(ibf.bits), rows, jnp.asarray(mask))
    )
    for i, t in enumerate(targets):
        # all hashes of the target hit the union of its technical bins
        assert counts[i, tb[t]].sum() >= len(th[t])


def test_fp_bound():
    rng = np.random.default_rng(2)
    th = _random_target_hashes(rng, 4, lo=300, hi=800)
    ibf = build_ibf(th, kmer_size=19, window_size=31, max_fp=0.05)
    # ceil-rounding on split bins can overshoot the target fp marginally
    # (same formulas as the reference); allow a small tolerance.
    assert ibf.ibf_config.true_max_fp <= 0.05 * 1.05

    # empirical fp: random foreign hashes should rarely hit
    foreign = rng.integers(2**62, 2**63, size=4000, dtype=np.uint64)
    rows = ibf_row_indices(
        jnp.asarray(foreign)[None, :],
        bin_size=ibf.ibf_config.bin_size_bits,
        hash_functions=ibf.ibf_config.hash_functions,
    )
    counts = np.asarray(
        bulk_count_bins(jnp.asarray(ibf.bits), rows, jnp.ones((1, 4000), dtype=bool))
    )[0]
    n_bins = ibf.ibf_config.n_bins
    emp_fp = counts[:n_bins].sum() / (4000 * n_bins)
    assert emp_fp <= 3 * max(ibf.ibf_config.true_max_fp, 0.01)


def test_target_counts_matmul():
    rng = np.random.default_rng(3)
    technical = 64
    bc = rng.integers(0, 100, size=(5, technical)).astype(np.int32)
    b2t = np.full(technical, 3, dtype=np.int32)
    b2t[:10] = 0
    b2t[10:25] = 1
    b2t[25:40] = 2
    tc = np.asarray(
        target_counts(jnp.asarray(bc), jnp.asarray(b2t), num_targets=3)
    )
    assert (tc[:, 0] == bc[:, :10].sum(1)).all()
    assert (tc[:, 1] == bc[:, 10:25].sum(1)).all()
    assert (tc[:, 2] == bc[:, 25:40].sum(1)).all()


def test_bulk_target_counts_equals_matmul_path():
    """The cumsum segment-sum target reduction matches the reference
    formulation (per-bin bulk count + per-target technical-bin sum) on
    random filters, including non-contiguous bin maps (permutation)."""
    import jax.numpy as jnp
    from ganon_tpu.ops.ibf_query import bulk_target_counts, target_segments

    rng = np.random.default_rng(11)
    R, W, B, M, S, T = 4096, 2, 16, 50, 3, 7
    bits = jnp.asarray(rng.integers(0, 2**32, (R, W), dtype=np.uint32))
    rows = jnp.asarray(rng.integers(0, R, (B, M, S)), dtype=jnp.int32)
    mask = jnp.asarray(rng.random((B, M)) < 0.7)
    for shuffle in (False, True):
        b2t = np.sort(rng.integers(0, T + 1, W * 32)).astype(np.int32)
        if shuffle:
            rng.shuffle(b2t)
        ref = np.asarray(
            target_counts(
                bulk_count_bins(bits, rows, mask), jnp.asarray(b2t),
                num_targets=T,
            )
        )
        perm, starts, ends = target_segments(b2t, T)
        got = np.asarray(
            bulk_target_counts(
                bits, rows, mask, jnp.asarray(starts), jnp.asarray(ends),
                jnp.asarray(perm) if perm is not None else None,
            )
        )
        assert (got == ref).all()
        assert shuffle or perm is None  # contiguous maps skip the permute


def test_packed_layout_counts_equal_reference_formulation():
    """The byte-aligned device layout (pack_table_u8 viewed as u32 words,
    bulk_target_counts_packed) produces the same per-target counts as the
    interleaved u32 formulation, for contiguous and shuffled bin maps."""
    import jax.numpy as jnp
    from ganon_tpu.ops.ibf_query import (
        bulk_target_counts_packed, pack_table_u8, table_as_u32)

    rng = np.random.default_rng(12)
    R, W, B, M, S, T = 2048, 3, 8, 40, 4, 11
    bits = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    rows = jnp.asarray(rng.integers(0, R, (B, M, S)), dtype=jnp.int32)
    mask = jnp.asarray(rng.random((B, M)) < 0.5)
    for shuffle in (False, True):
        b2t = np.sort(rng.integers(0, T + 1, W * 32)).astype(np.int32)
        if shuffle:
            rng.shuffle(b2t)
        ref = np.asarray(
            target_counts(
                bulk_count_bins(jnp.asarray(bits), rows, mask),
                jnp.asarray(b2t), num_targets=T,
            )
        )
        tbl8, bs, be = pack_table_u8(bits, b2t, T)
        got = np.asarray(
            bulk_target_counts_packed(
                jnp.asarray(table_as_u32(tbl8)), rows, mask,
                jnp.asarray(bs), jnp.asarray(be),
            )
        )
        assert (got == ref).all()


def test_packed_layout_pads_odd_byte_widths():
    """A byte width that is not a multiple of 4 zero-pads the u32 word
    view (table_as_u32) and still counts exactly."""
    import jax.numpy as jnp
    from ganon_tpu.ops.ibf_query import (
        bulk_target_counts_packed, pack_table_u8, table_as_u32)

    rng = np.random.default_rng(21)
    R, W, B, M, S, T = 1024, 3, 8, 40, 3, 13  # W8 = 13 -> pads to 16
    bits = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    rows = jnp.asarray(rng.integers(0, R, (B, M, S)), dtype=jnp.int32)
    mask = jnp.asarray(rng.random((B, M)) < 0.5)
    b2t = np.sort(rng.integers(0, T + 1, W * 32)).astype(np.int32)
    tbl8, bs, be = pack_table_u8(bits, b2t, T)
    assert tbl8.shape[1] % 4 != 0  # exercises the pad branch
    tbl32 = table_as_u32(tbl8)
    assert tbl32.shape == (R, -(-tbl8.shape[1] // 4))
    ref = np.asarray(target_counts(
        bulk_count_bins(jnp.asarray(bits), rows, mask), jnp.asarray(b2t),
        num_targets=T))
    got = np.asarray(bulk_target_counts_packed(
        jnp.asarray(tbl32), rows, mask, jnp.asarray(bs), jnp.asarray(be)))
    assert (got == ref).all()


def test_compact_hashes_rank_select():
    """Compaction keeps the emitted multiset in order and flags
    overflow exactly."""
    import jax.numpy as jnp
    from ganon_tpu.ops.ibf_query import compact_hashes

    rng = np.random.default_rng(13)
    B, M, MC = 16, 50, 16
    h = rng.integers(0, 2**60, (B, M), dtype=np.uint64)
    msk = rng.random((B, M)) < 0.25
    msk[0] = True  # guaranteed overflow row (50 > 16)
    msk[1] = False  # empty row
    hc, mc, over = compact_hashes(
        jnp.asarray(h), jnp.asarray(msk), max_compact=MC
    )
    hc, mc, over = np.asarray(hc), np.asarray(mc), np.asarray(over)
    for b in range(B):
        emitted = h[b][msk[b]]
        assert over[b] == (len(emitted) > MC)
        n = min(len(emitted), MC)
        assert (hc[b][:n] == emitted[:n]).all()
        assert mc[b].sum() == n
        assert not mc[b][n:].any()


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    th = _random_target_hashes(rng, 3)
    ibf = build_ibf(th, kmer_size=19, window_size=31, max_fp=0.05)
    p = str(tmp_path / "db.ibf")
    ibf.save(p)
    loaded = IBF.load(p)
    assert (loaded.bits == ibf.bits).all()
    assert loaded.ibf_config == ibf.ibf_config
    assert loaded.hashes_count == ibf.hashes_count
    assert loaded.bin_map == ibf.bin_map


def test_end_to_end_sequence_membership():
    # build from actual sequences; query reads drawn from them
    import random

    rng = random.Random(5)
    refs = {
        f"G{i}": "".join(rng.choice("ACGT") for _ in range(400)) for i in range(4)
    }
    k, w = 19, 31
    th = {}
    for t, s in refs.items():
        codes, lengths = encode_seqs([s])
        h, n = minimizers_jax(codes, lengths, k=k, w=w, max_minimizers=400)
        th[t] = np.unique(np.asarray(h)[0, : int(n[0])])
    ibf = build_ibf(th, kmer_size=k, window_size=w, max_fp=0.01)

    # a 100bp read from G2 must match all its minimizers in G2's bins
    read = refs["G2"][37:137]
    codes, lengths = encode_seqs([read])
    h, n = minimizers_jax(codes, lengths, k=k, w=w, max_minimizers=100)
    M = int(n[0])
    rows = ibf_row_indices(
        h[:, :M],
        bin_size=ibf.ibf_config.bin_size_bits,
        hash_functions=ibf.ibf_config.hash_functions,
    )
    counts = np.asarray(
        bulk_count_bins(jnp.asarray(ibf.bits), rows, jnp.ones((1, M), dtype=bool))
    )[0]
    tc = {
        t: int(counts[bins].sum()) for t, bins in ibf.target_bins().items()
    }
    assert tc["G2"] >= M  # full containment


def test_build_roundtrip_single_hash_function():
    """h=1 filters (an explicit --hash-functions 1) stay exact."""
    rng = np.random.default_rng(9)
    th = _random_target_hashes(rng, 6)
    ibf = build_ibf(
        th, kmer_size=19, window_size=31, max_fp=0.05, hash_functions=1
    )
    assert ibf.ibf_config.hash_functions == 1
    assert ibf.ibf_config.true_max_fp <= 0.05 * 1.01

    tb = ibf.target_bins()
    targets = list(th)
    M = max(len(h) for h in th.values())
    hs = np.zeros((len(targets), M), dtype=np.uint64)
    mask = np.zeros((len(targets), M), dtype=bool)
    for i, t in enumerate(targets):
        hs[i, : len(th[t])] = th[t]
        mask[i, : len(th[t])] = True
    rows = ibf_row_indices(
        jnp.asarray(hs),
        bin_size=ibf.ibf_config.bin_size_bits,
        hash_functions=1,
    )
    counts = np.asarray(
        bulk_count_bins(jnp.asarray(ibf.bits), rows, jnp.asarray(mask))
    )
    for i, t in enumerate(targets):
        assert counts[i, tb[t]].sum() >= len(th[t])


def test_raw_format_roundtrip_and_parity(tmp_path):
    """tpu-raw container: bit-identical round trip, mmap-backed load,
    and identical classification to the npz-format db."""
    import os

    import numpy as np

    from ganon_tpu.index.ibf import IBF, build_ibf

    rng = np.random.default_rng(7)
    th = {
        f"T{i}": np.unique(
            rng.integers(0, 2**62, size=500, dtype=np.uint64)
        )
        for i in range(6)
    }
    ibf = build_ibf(th, kmer_size=19, window_size=31, max_fp=0.05)
    npz = str(tmp_path / "a.ibf")
    raw = str(tmp_path / "b.ibf")
    ibf.save(npz)
    ibf.save_raw(raw)

    got = IBF.load(raw)
    assert isinstance(got.bits, np.memmap)  # pages in on demand
    assert np.array_equal(np.asarray(got.bits), ibf.bits)
    assert got.hashes_count == ibf.hashes_count
    assert got.bin_map == ibf.bin_map
    assert got.ibf_config.to_dict() == ibf.ibf_config.to_dict()
    # raw is larger on disk but loads without decompression
    assert os.path.getsize(raw) >= ibf.bits.nbytes


def test_raw_format_via_cli_build_and_classify(tmp_path):
    """--filter-format tpu-raw through build-custom + classify."""
    import numpy as np

    from ganon_tpu.cli import main
    from ganon_tpu.config import Config

    rng = np.random.default_rng(8)
    bases = "ACGT"
    genome = "".join(bases[int(b)] for b in rng.integers(0, 4, size=5000))
    fa = tmp_path / "g.fa"
    fa.write_text(f">G\n{genome}\n")
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(20):
            s = int(rng.integers(0, 4800))
            f.write(f"@q{i}\n{genome[s:s + 150]}\n+\n{'I' * 150}\n")
    outs = {}
    for fmt in ("tpu", "tpu-raw"):
        db = str(tmp_path / f"db_{fmt}")
        assert main(cfg=Config(
            "build-custom", db_prefix=db, input=[str(fa)],
            input_extension="fa", taxonomy="skip", input_target="file",
            filter_format=fmt, quiet=True,
        ))
        out = str(tmp_path / f"res_{fmt}")
        assert main(cfg=Config(
            "classify", db_prefix=[db], single_reads=[str(fq)],
            output_prefix=out, output_all=True, quiet=True,
        ))
        with open(out + ".all") as f:
            outs[fmt] = sorted(f.read().splitlines())
    assert outs["tpu"] == outs["tpu-raw"]
