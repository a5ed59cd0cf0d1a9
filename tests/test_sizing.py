"""Sizing math invariants (mirroring GanonBuild.test.cpp perf invariants)."""

import numpy as np
import pytest

from ganon_tpu.index.config import IBFConfig
from ganon_tpu.index import sizing


def _skewed_counts(rng, n=24):
    # skewed target sizes like the reference mode_input fixture
    return {f"T{i}": int(v) for i, v in enumerate(rng.integers(100, 8000, n))}


def _filter_size_bits(cfg):
    return sizing.optimal_bins(cfg.n_bins) * cfg.bin_size_bits


def _run(max_fp=0.05, filter_size=0.0, mode="avg", hash_functions=0, counts=None):
    cfg = IBFConfig(kmer_size=19, window_size=31)
    sizing.optimal_hashes(
        max_fp, filter_size, cfg, counts, hash_functions=hash_functions, mode=mode
    )
    cfg.true_max_fp, cfg.true_avg_fp = sizing.true_false_positive(
        counts, cfg.max_hashes_bin, cfg.bin_size_bits, cfg.hash_functions
    )
    return cfg


def test_bin_size_formulas():
    # classic bloom formulas sanity
    assert sizing.bin_size_fp(0.01, 1000) > sizing.bin_size_fp(0.05, 1000)
    assert sizing.bin_size_fp_hf(0.01, 1000, 3) > sizing.bin_size_fp_hf(0.05, 1000, 3)
    assert 1 <= sizing.get_optimal_hash_functions(9600, 1000) <= 5


def test_higher_fp_smaller_filter():
    rng = np.random.default_rng(0)
    counts = _skewed_counts(rng)
    sizes = [
        _filter_size_bits(_run(max_fp=fp, counts=counts)) for fp in (0.01, 0.05, 0.2)
    ]
    assert sizes[0] > sizes[1] > sizes[2]


def test_fp_respected():
    rng = np.random.default_rng(1)
    counts = _skewed_counts(rng)
    # ceil-rounding on split bins can overshoot marginally (reference
    # formulas have the same property); a ~10% relative tolerance holds.
    for fp in (0.01, 0.05, 0.2):
        cfg = _run(max_fp=fp, counts=counts)
        assert cfg.true_max_fp <= fp * 1.12


def test_modes_ordering():
    rng = np.random.default_rng(2)
    counts = _skewed_counts(rng)
    avg = _run(mode="avg", counts=counts)
    smallest = _run(mode="smallest", counts=counts)
    fastest = _run(mode="fastest", counts=counts)
    assert _filter_size_bits(smallest) <= _filter_size_bits(avg)
    assert fastest.n_bins <= avg.n_bins


def test_filter_size_fixed():
    rng = np.random.default_rng(3)
    counts = _skewed_counts(rng)
    cfg = _run(max_fp=0.0, filter_size=2.0, counts=counts)  # 2 MB
    total_mb = _filter_size_bits(cfg) / 8388608
    assert abs(total_mb - 2.0) < 0.05
    bigger = _run(max_fp=0.0, filter_size=8.0, counts=counts)
    assert _filter_size_bits(bigger) > _filter_size_bits(cfg)


def test_split_target_bins_cover_all_hashes():
    rng = np.random.default_rng(4)
    counts = _skewed_counts(rng)
    cfg = _run(counts=counts)
    splits = sizing.split_target_bins(cfg, counts)
    assert len(splits) == cfg.n_bins
    covered = {t: 0 for t in counts}
    for binno, target, st, en in splits:
        assert 0 <= st <= en < counts[target]
        covered[target] += en - st + 1
    for t, c in counts.items():
        assert covered[t] == c  # every hash index in exactly one bin

    binnos = [b for b, *_ in splits]
    assert binnos == list(range(len(splits)))  # consecutive


def test_fixed_hash_functions():
    rng = np.random.default_rng(5)
    counts = _skewed_counts(rng)
    cfg = _run(hash_functions=2, counts=counts)
    assert cfg.hash_functions == 2


# -- the build sizes exactly as the reference does -------------------------


@pytest.mark.parametrize(
    "counts,hash_functions",
    [
        ({f"T{i}": 5_000 for i in range(16)}, 0),
        ({f"T{i}": 140_000 for i in range(1024)}, 0),
        ({f"T{i}": 140_000 for i in range(1024)}, 4),
        ({f"T{i}": 500 + 900 * i for i in range(40)}, 4),
    ],
)
def test_size_filter_is_reference_memory_optimal(counts, hash_functions):
    """Every build path's sizing is the reference's memory-optimal search
    (GanonBuild.cpp:428-616) and nothing else: no re-size trades the
    filter's size for fewer hash functions."""
    ref = IBFConfig(kmer_size=19, window_size=31)
    sizing.optimal_hashes(0.05, 0.0, ref, counts,
                          hash_functions=hash_functions)
    got = sizing.size_filter(counts, kmer_size=19, window_size=31,
                             max_fp=0.05, hash_functions=hash_functions)
    for field in ("hash_functions", "bin_size_bits", "n_bins",
                  "max_hashes_bin", "max_fp"):
        assert getattr(got, field) == getattr(ref, field), field
