"""Bloom-filter sizing math: bin size, hash functions, optimal split search.

Formula-level parity with the reference engine (the formulas are facts of
the IBF data structure; the search is re-implemented over deterministic
dict ordering):

* ``bin_size_fp``            <- GanonBuild.cpp:290-296
* ``bin_size_fp_hf``         <- GanonBuild.cpp:298-306
* ``hash_functions_from_ratio`` / ``get_optimal_hash_functions``
                             <- GanonBuild.cpp:308-333
* ``number_of_bins``         <- GanonBuild.cpp:336-347
* ``correction_rate``        <- GanonBuild.cpp:350-362
* ``optimal_bins`` (64-pad)  <- GanonBuild.cpp:365-371
* ``false_positive``         <- GanonBuild.cpp:373-380
* ``true_false_positive``    <- GanonBuild.cpp:382-412
* ``optimal_hashes`` search with modes avg/smaller/smallest/faster/fastest
                             <- GanonBuild.cpp:428-616
* ``split_target_bins``      <- create_bin_map_hash, GanonBuild.cpp:619-653
* ``target_fpr``             <- GanonClassify.cpp:968-982
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ganon_tpu.index.config import IBFConfig

MAX_HASH_FUNCTIONS = 5


def bin_size_fp(max_fp: float, n_hashes: int) -> int:
    """Optimal Bloom bin size in bits for a target fp (optimal #hashes)."""
    return math.ceil((n_hashes * math.log(max_fp)) / math.log(1.0 / 2 ** math.log(2)))


def bin_size_fp_hf(max_fp: float, n_hashes: int, hash_functions: int) -> int:
    """Bloom bin size in bits for a target fp with a fixed #hash functions."""
    return math.ceil(
        n_hashes
        * (-hash_functions / math.log(1 - math.exp(math.log(max_fp) / hash_functions)))
    )


def hash_functions_from_ratio(bin_size_bits: int, n_hashes: int) -> int:
    return int(math.log(2) * (bin_size_bits / n_hashes))


def get_optimal_hash_functions(
    bin_size_bits: int,
    n_hashes: int,
    hash_functions: int = 0,
    max_hash_functions: int = MAX_HASH_FUNCTIONS,
) -> int:
    hf = hash_functions
    if hf == 0:
        hf = hash_functions_from_ratio(bin_size_bits, n_hashes)
    if hf > max_hash_functions or hf == 0:
        hf = max_hash_functions
    return hf


def number_of_bins(hashes_count: dict[str, int], n_hashes: int) -> int:
    """Total technical bins if every target is split every ``n_hashes``."""
    return sum(math.ceil(c / n_hashes) for c in hashes_count.values())


def optimal_bins(n_bins: int) -> int:
    """64-pad the bin count (the IBF stores bins in 64-bit words)."""
    return math.ceil(n_bins / 64.0) * 64


def false_positive(bin_size_bits: int, hash_functions: int, n_hashes: int) -> float:
    """Theoretical fp of one Bloom bin."""
    return (1 - math.exp(-hash_functions / (bin_size_bits / n_hashes))) ** hash_functions


def correction_rate(
    max_split_bins: int, max_fp: float, hash_functions: int, n_hashes: int
) -> float:
    """Bin-size growth factor to compensate multiple testing on split bins."""
    target_fpr = 1.0 - math.exp(math.log(1.0 - max_fp) / max_split_bins)
    new_size = bin_size_fp_hf(target_fpr, n_hashes, hash_functions)
    original = bin_size_fp_hf(max_fp, n_hashes, hash_functions)
    return new_size / original


def true_false_positive(
    hashes_count: dict[str, int], max_hashes_bin: int, bin_size_bits: int,
    hash_functions: int,
) -> tuple[float, float]:
    """Achieved (max, avg) per-target fp accounting for split bins."""
    highest = 0.0
    total = 0.0
    for count in hashes_count.values():
        n_bins_target = math.ceil(count / max_hashes_bin)
        n_hashes_bin = math.ceil(count / n_bins_target) if n_bins_target else 0
        real_fp = 1.0 - (
            1.0 - false_positive(bin_size_bits, hash_functions, n_hashes_bin)
        ) ** n_bins_target
        highest = max(highest, real_fp)
        total += real_fp
    return highest, total / max(len(hashes_count), 1)


def target_fpr(
    hashes_count: dict[str, int], ibf_config: IBFConfig
) -> dict[str, float]:
    """Per-target achieved fp used by the --fpr-query filter."""
    out = {}
    for target, count in hashes_count.items():
        n_bins_target = math.ceil(count / ibf_config.max_hashes_bin)
        n_hashes_bin = math.ceil(count / n_bins_target) if n_bins_target else 0
        out[target] = 1.0 - (
            1.0
            - false_positive(
                ibf_config.bin_size_bits, ibf_config.hash_functions, n_hashes_bin
            )
        ) ** n_bins_target
    return out


@dataclass
class _Sim:
    n_hashes: int
    n_bins: int
    filter_size_bits: int
    fp: float


def optimal_hashes(
    max_fp: float,
    filter_size: float,
    ibf_config: IBFConfig,
    hashes_count: dict[str, int],
    hash_functions: int = 0,
    max_hash_functions: int = MAX_HASH_FUNCTIONS,
    mode: str = "avg",
) -> None:
    """Search the best max-hashes-per-bin; fills ``ibf_config`` in place.

    Scans candidate bin capacities every 100 elements from the largest
    target down, computes the resulting filter size (or fp when
    ``filter_size`` is fixed), and picks the capacity minimizing a
    mode-weighted harmonic mean of the size/fp ratio and the bin-count
    ratio against their minima.
    """
    max_hashes = max(hashes_count.values(), default=0)

    min_filter_size = 0
    min_bins = 0
    min_fp = 1.0
    simulations: list[_Sim] = []

    iter_step = 100
    if max_hashes < iter_step:
        iter_step = max_hashes

    n = max_hashes + 1
    while n > iter_step:
        n_hashes = n - 1
        n_bins = number_of_bins(hashes_count, n_hashes)

        bin_size_bits = 0
        if filter_size:
            bin_size_bits = int(
                (filter_size / optimal_bins(n_bins)) * 8388608
            )
            hf = get_optimal_hash_functions(
                bin_size_bits, n_hashes, hash_functions, max_hash_functions
            )
        else:
            if hash_functions == 0:
                bin_size_bits = bin_size_fp(max_fp, n_hashes)
                hf = get_optimal_hash_functions(
                    bin_size_bits, n_hashes, hash_functions, max_hash_functions
                )
            else:
                hf = get_optimal_hash_functions(
                    bin_size_bits, n_hashes, hash_functions, max_hash_functions
                )
                bin_size_bits = bin_size_fp_hf(max_fp, n_hashes, hf)

        max_split_bins = math.ceil(max_hashes / n_hashes)

        fp = 0.0
        filter_size_bits = 0
        if filter_size:
            fp = 1 - (1.0 - false_positive(bin_size_bits, hf, n_hashes)) ** max_split_bins
            if fp < min_fp:
                min_fp = fp
        else:
            avg_n_hashes = math.ceil(max_hashes / max_split_bins)
            approx_fp = false_positive(bin_size_bits, hf, avg_n_hashes)
            if approx_fp > max_fp:
                approx_fp = max_fp
            crate = correction_rate(max_split_bins, approx_fp, hf, n_hashes)
            bin_size_bits = int(bin_size_bits * crate)
            filter_size_bits = bin_size_bits * optimal_bins(n_bins)
            if filter_size_bits == 0 or math.isinf(crate):
                break
            if filter_size_bits < min_filter_size or min_filter_size == 0:
                min_filter_size = filter_size_bits

        simulations.append(_Sim(n_hashes, n_bins, filter_size_bits, fp))

        if n_bins < min_bins or min_bins == 0:
            min_bins = n_bins
        n -= iter_step

    # mode weighting: avg=1 (plain harmonic mean), smaller/faster=0.5,
    # smallest/fastest=0 (ignore the other metric entirely)
    mode_val = 1.0
    if mode in ("smaller", "faster"):
        mode_val = 0.5
    elif mode in ("smallest", "fastest"):
        mode_val = 0.0
    var_val = 1.0
    bins_val = 1.0
    if mode in ("smaller", "smallest"):
        var_val = mode_val
    elif mode in ("faster", "fastest"):
        bins_val = mode_val

    min_avg = 0.0
    for params in simulations:
        if filter_size:
            var_ratio = params.fp / min_fp
        else:
            var_ratio = params.filter_size_bits / min_filter_size
        bins_ratio = params.n_bins / min_bins
        avg = (1 + mode_val**2) * (
            (var_ratio * bins_ratio) / ((var_val * var_ratio) + (bins_val * bins_ratio))
        )
        if avg < min_avg or min_avg == 0:
            min_avg = avg
            if filter_size:
                ibf_config.bin_size_bits = int(
                    (filter_size / optimal_bins(params.n_bins)) * 8388608
                )
                ibf_config.max_fp = params.fp
            else:
                ibf_config.bin_size_bits = params.filter_size_bits // optimal_bins(
                    params.n_bins
                )
                ibf_config.max_fp = max_fp
            ibf_config.max_hashes_bin = params.n_hashes
            ibf_config.n_bins = params.n_bins
            ibf_config.hash_functions = get_optimal_hash_functions(
                ibf_config.bin_size_bits, params.n_hashes, hash_functions,
                max_hash_functions,
            )


def size_filter(
    hashes_count: dict[str, int],
    *,
    kmer_size: int,
    window_size: int,
    max_fp: float = 0.05,
    filter_size: float = 0.0,
    hash_functions: int = 0,
    mode: str = "avg",
) -> IBFConfig:
    """THE sizing entry point shared by every build path.

    Runs the reference-parity ``optimal_hashes`` search and computes the
    achieved ``true_max_fp``/``true_avg_fp`` — so the host-array build
    (`ibf.build_ibf`), the device pipeline (`builder.run_build`), benches
    and tests all agree on one ``IBFConfig`` for the same inputs.
    Reference invariants: GanonBuild.cpp:428-616 (search), :382-412
    (true fp).
    """
    cfg = IBFConfig(kmer_size=kmer_size, window_size=window_size)
    eff_max_fp = max_fp if not filter_size else 0.0
    optimal_hashes(
        eff_max_fp, filter_size, cfg, hashes_count,
        hash_functions=hash_functions, mode=mode,
    )
    if cfg.n_bins == 0:
        raise ValueError("no valid sequences to build")
    cfg.true_max_fp, cfg.true_avg_fp = true_false_positive(
        hashes_count, cfg.max_hashes_bin, cfg.bin_size_bits,
        cfg.hash_functions,
    )
    return cfg


def split_target_bins(
    ibf_config: IBFConfig, hashes_count: dict[str, int]
) -> list[tuple[int, str, int, int]]:
    """Assign consecutive technical bins per target with hash index ranges.

    Returns ``[(binno, target, idx_start, idx_end_inclusive), ...]`` in
    deterministic target order (dict insertion order).
    """
    binno = 0
    out = []
    for target, count in hashes_count.items():
        n_bins_target = math.ceil(count / ibf_config.max_hashes_bin)
        n_hashes_bin = math.ceil(count / n_bins_target) if n_bins_target else 0
        if n_hashes_bin > ibf_config.max_hashes_bin:
            n_hashes_bin = ibf_config.max_hashes_bin
        for i in range(n_bins_target):
            st = i * n_hashes_bin
            en = st + n_hashes_bin - 1
            if st >= count:
                break
            if en >= count:
                en = count - 1
            out.append((binno, target, st, en))
            binno += 1
    return out
