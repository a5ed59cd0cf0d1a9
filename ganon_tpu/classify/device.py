"""Device-side classify compute: minimizer extraction + IBF bulk count.

Static-shape jitted stages with length bucketing so a stream of variable
length reads reuses a small set of compiled programs. All filters in a
hierarchy level share (k, w), so hashes are extracted once per batch and
counted against each filter's bit-matrix.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ganon_tpu.ops.minimizers import encode_seqs, minimizers_masked_jax
from ganon_tpu.ops.ibf_query import (
    ibf_row_indices,
    bulk_target_counts_packed,
    compact_hashes,
    pack_table_u8,
    table_as_u32,
)


def bucket_len(n: int, minimum: int = 128) -> int:
    """Round a length up to the next bucket.

    Multiples of 32 up to 256 (padding sets the compact-hash width and
    with it every gather's probe count, so 150 bp reads pad to 160, not
    192), multiples of 64 up to 1024, powers of two beyond (bounds the
    number of compiled shapes for long reads).
    """
    if n <= minimum:
        return minimum
    if n <= 256:
        return -(-n // 32) * 32
    if n <= 1024:
        return -(-n // 64) * 64
    b = 1024
    while b < n:
        b *= 2
    return b


@partial(jax.jit, static_argnames=("k", "w", "m1", "m2"))
def extract_hashes(codes1, len1, codes2, len2, *, k: int, w: int, m1: int, m2: int):
    """Minimizers for a (possibly paired) batch, concatenated per read.

    Mate-2 hashes are appended when ``len2 >= w``; a read whose first mate
    is shorter than ``w`` is skipped entirely (``n_hashes == 0``), matching
    GanonClassify.cpp:689-700.

    Uses the compaction-free (values, emission-mask) representation — the
    bulk count consumes masked values, so no argsort/gather is needed.
    ``m1``/``m2`` cap the per-mate hash positions (normally ``L - w + 1``).

    Returns (hashes uint64 [B, <=m1+m2], mask bool [...], n_hashes int32 [B]).
    """
    h1, e1, n1 = minimizers_masked_jax(codes1, len1, k=k, w=w)
    h1, e1 = h1[:, :m1], e1[:, :m1]
    if codes2 is not None:
        h2, e2, n2 = minimizers_masked_jax(codes2, len2, k=k, w=w)
        h2, e2 = h2[:, :m2], e2[:, :m2]
        hashes = jnp.concatenate([h1, h2], axis=1)
        mask = jnp.concatenate([e1, e2], axis=1)
        n_hashes = n1 + n2
    else:
        hashes, mask, n_hashes = h1, e1, n1
    read_ok = (len1 >= w)[:, None]
    mask = mask & read_ok
    n_hashes = jnp.where(len1 >= w, n_hashes, 0)
    return hashes, mask, n_hashes


@partial(jax.jit, static_argnames=("bin_size", "hash_functions"))
def filter_counts(
    tbl, byte_starts, byte_ends, hashes, mask, n_hashes, *,
    bin_size: int, hash_functions: int,
):
    """Per-target clamped counts on the device query table (u32 view)."""
    rows = ibf_row_indices(hashes, bin_size=bin_size, hash_functions=hash_functions)
    tc = bulk_target_counts_packed(tbl, rows, mask, byte_starts, byte_ends)
    return jnp.minimum(tc, n_hashes[:, None])


def compact_width(m_total: int) -> int:
    """Compacted hash capacity for a read of ``m_total`` window positions.

    Emission density for typical (k, w) is ~2/(w-k+2) (~1/7 at 19/31), so
    a fifth of the positions still covers >3x the expectation (observed
    max for random 150bp pairs at 19/31 is 46 of 240 positions, i.e.
    under the 48-slot width); overflowing reads fall back to the
    uncompacted path, so counts stay exact either way.

    Long reads compact too (the compare/select sort scales fine): the
    uncompacted gather probes every masked window position, several
    times the emitted hashes, and at wide tables its [B, m, W] gather
    temporaries reach gigabytes.
    """
    return min(m_total, max(32, -(-m_total // 5 // 8) * 8))


@partial(
    jax.jit,
    static_argnames=("k", "w", "m1", "m2", "bin_size", "hash_functions"),
)
def classify_counts_fused(
    tbl, byte_starts, byte_ends, codes1, len1, codes2, len2, *,
    k: int, w: int, m1: int, m2: int,
    bin_size: int, hash_functions: int,
):
    """One-dispatch classify step: codes -> clamped per-target counts.

    Fuses hash extraction (single or paired), emitted-hash compaction and
    the bulk count so a batch costs a single host->device round trip.
    Returns ``(counts, n_hashes, overflow)``; overflowing reads (more
    emissions than the compaction width) have inexact counts and must be
    re-run uncompacted.
    """
    hashes, mask, n_hashes = extract_hashes(
        codes1, len1, codes2, len2, k=k, w=w, m1=m1, m2=m2
    )
    mc = compact_width(hashes.shape[1])
    if mc and mc < hashes.shape[1]:
        hashes, mask, overflow = compact_hashes(hashes, mask, max_compact=mc)
    else:
        overflow = jnp.zeros(hashes.shape[0], dtype=bool)
    rows = ibf_row_indices(hashes, bin_size=bin_size, hash_functions=hash_functions)
    tc = bulk_target_counts_packed(tbl, rows, mask, byte_starts, byte_ends)
    return jnp.minimum(tc, n_hashes[:, None]), n_hashes, overflow


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """Host-side 2-bit packing of dna4 ranks (4 bases per byte).

    Minimizes the host->device transfer (the classify pipeline's other
    half besides the packed fetch): a 150bp read costs 38 bytes instead
    of a 256-byte padded row.
    """
    B, L = codes.shape
    Lp = -(-L // 4)
    if Lp * 4 != L:
        codes = np.pad(codes, ((0, 0), (0, Lp * 4 - L)))
    c = codes.reshape(B, Lp, 4)
    return (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6)).astype(np.uint8)


def unpack_codes_2bit(packed, L: int):
    """Device-side unpack (jnp): [B, ceil(L/4)] u8 -> [B, L] ranks."""
    B, Lp = packed.shape
    shifts = jnp.arange(4, dtype=jnp.uint8) * jnp.uint8(2)
    u = (packed[:, :, None] >> shifts) & jnp.uint8(3)
    return u.reshape(B, Lp * 4)[:, :L]


def pack_batch_input(codes1: np.ndarray, len1: np.ndarray,
                     codes2: np.ndarray | None, len2: np.ndarray | None):
    """One host->device buffer per batch: 2-bit codes + lengths.

    Layout (u8): [B, L1p | L2p | 4 (len1 le-i32) | 4 (len2 le-i32)].
    A single transfer matters because each host<->device hop pays fixed
    latency on top of bandwidth.
    """
    parts = [pack_codes_2bit(codes1)]
    if codes2 is not None:
        parts.append(pack_codes_2bit(codes2))
    parts.append(np.ascontiguousarray(len1, dtype="<i4").view(np.uint8)
                 .reshape(len(len1), 4))
    if codes2 is not None:
        parts.append(np.ascontiguousarray(len2, dtype="<i4").view(np.uint8)
                     .reshape(len(len2), 4))
    return np.concatenate(parts, axis=1)


def pack_batch_direct(batch, batch_pad: int):
    """2-bit-pack an EncodedBatch straight into the padded device input
    buffer (:func:`pack_batch_input` layout), skipping the
    [batch_pad, Lb] u8 intermediate (zeroing and copying that 4x-larger
    array is host time on every dispatch). Byte-identical to
    batch_to_device + pack_batch_input.

    Returns (inbuf, L1, L2) with L2 = 0 for single-end.
    """
    L1 = bucket_len(max(batch.codes1.shape[1], 1))
    L1p = L1 // 4  # bucket lengths are multiples of 32
    L2 = bucket_len(max(batch.codes2.shape[1], 1)) if batch.paired else 0
    L2p = L2 // 4
    width = L1p + L2p + 4 + (4 if batch.paired else 0)
    buf = np.zeros((batch_pad, width), np.uint8)

    def pack_into(dst, codes):
        b, L = codes.shape
        L4 = -(-L // 4) * 4
        if L4 != L:
            codes = np.pad(codes, ((0, 0), (0, L4 - L)))
        c = codes.reshape(b, L4 // 4, 4)
        dst[:b, : L4 // 4] = (
            c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6)
        )

    def lens_into(dst, lengths):
        lens = np.zeros((batch_pad,), dtype="<i4")
        lens[: len(lengths)] = lengths
        dst[:] = lens.view(np.uint8).reshape(batch_pad, 4)

    o = 0
    pack_into(buf[:, o:o + L1p], batch.codes1)
    o += L1p
    if batch.paired:
        pack_into(buf[:, o:o + L2p], batch.codes2)
        o += L2p
    lens_into(buf[:, o:o + 4], batch.len1)
    o += 4
    if batch.paired:
        lens_into(buf[:, o:o + 4], batch.len2)
    return buf, L1, L2


def _unpack_batch_input(buf, L1: int, L2: int):
    """Device-side split of :func:`pack_batch_input` (jnp)."""
    import jax.lax as lax

    L1p = -(-L1 // 4)
    L2p = -(-L2 // 4) if L2 else 0
    o = 0
    codes1p = buf[:, o:o + L1p]; o += L1p  # noqa: E702
    codes2p = buf[:, o:o + L2p] if L2 else None
    o += L2p
    len1 = lax.bitcast_convert_type(buf[:, o:o + 4], jnp.int32).reshape(-1)
    o += 4
    if L2:
        len2 = lax.bitcast_convert_type(
            buf[:, o:o + 4], jnp.int32).reshape(-1)
    else:
        len2 = None
    return codes1p, len1, codes2p, len2


def _pack_result(res, n_hashes, overflow, *, pack16: bool, match_cap: int,
                 with_win: bool = False, extra_rows: tuple = ()):
    """Shared packed-output tail of the classify_batch_packed family.

    Dense (``match_cap == 0``): [B*K(*2)] matches (+ [B*K] winners) |
    [B] n_matches | [B] max_count | [B] n_hashes | [B] overflow |
    [B] per extra row | [T]*3 tallies | 3 scalars.

    Ragged (``match_cap > 0``, requires pack16): the valid top-K
    entries compact row-major into a [C] buffer (+ [C] winners), and
    the per-read side arrays pack into two u32 words — see
    classify_batch_packed's docstring for why this ~10x payload cut
    matters. ``extra_rows``: additional [B] int32 arrays riding after
    the side words (the pruned kernel ships the surviving-group ids
    this way). Unpack with unpack_batch_result /
    unpack_batch_result_ragged (matching ``n_extra``).
    """
    tallies = [res["disc_t"]]
    if "matches_t" in res:
        tallies.append(res["matches_t"])
    tallies.append(jnp.stack([
        res["seqs_classified"].astype(jnp.int32),
        res["kmers_from_classified"].astype(jnp.int32),
        res["kmers_matches"].astype(jnp.int32),
    ]))
    if match_cap > 0:
        assert pack16, "ragged match transfer requires pack16"
        K = res["top_vals"].shape[1]
        m2d = ((res["top_vals"] << 16) | res["top_idx"]).ravel()
        vmask = (
            jnp.arange(K, dtype=jnp.int32)[None, :]
            < res["n_matches"][:, None]
        ).ravel()
        pos = jnp.cumsum(vmask.astype(jnp.int32)) - 1
        dst = jnp.where(vmask, pos, match_cap)
        comp = jnp.zeros((match_cap,), dtype=jnp.int32).at[dst].set(
            m2d, mode="drop"
        )
        w1 = (res["max_count"] << 16) | res["n_matches"]
        # the 0x1FFFF clamp is lossless ONLY because every ragged
        # (match_cap>0) dispatch path guards cfg.hashes_limit <= 0xFFFF
        # (engine.py pack16 checks): a clamped n_hashes still compares
        # as over-limit and the read falls back, never mis-thresholds
        w2 = (jnp.minimum(n_hashes, 0x1FFFF) << 1) | overflow.astype(
            jnp.int32
        )
        parts = [comp]
        if with_win:
            parts.append(
                jnp.zeros((match_cap,), dtype=jnp.int32).at[dst].set(
                    res["top_win"].ravel(), mode="drop"
                )
            )
        parts += [w1, w2] + list(extra_rows) + tallies
        return jnp.concatenate([p.astype(jnp.int32) for p in parts])
    if pack16:
        matches = [((res["top_vals"] << 16) | res["top_idx"]).ravel()]
    else:
        matches = [res["top_vals"].ravel(), res["top_idx"].ravel()]
    if with_win:
        matches.append(res["top_win"].ravel())
    parts = matches + [
        res["n_matches"],
        res["max_count"],
        n_hashes,
        overflow.astype(jnp.int32),
    ] + list(extra_rows) + tallies
    return jnp.concatenate([p.astype(jnp.int32) for p in parts])


@partial(
    jax.jit,
    static_argnames=(
        "k", "w", "L1", "L2", "bin_size", "hash_functions", "top_k",
        "pack16", "match_cap", "sort_probes", "emit_matches_t",
    ),
)
def classify_batch_packed(
    tbl, byte_starts, byte_ends, inbuf,
    rel_cutoff, rel_filter, hashes_limit, *,
    k: int, w: int, L1: int, L2: int, bin_size: int, hash_functions: int,
    top_k: int, pack16: bool, match_cap: int = 0,
    sort_probes: bool = False, emit_matches_t: bool = True,
):
    """Whole per-batch device work in ONE dispatch, ONE int32 fetch.

    2-bit unpack + extract + compact + bulk count + threshold/top-K,
    with every output packed into a single flat int32 array — the
    classify engine pays exactly one host->device and one device->host
    transfer per batch (each sync stalls the pipeline). Layout (B = batch
    rows, K = top_k, T targets); with ``pack16`` the matches ride as
    ``(count << 16) | target`` in one [B*K] block:

      [B*K(*2)] matches | [B] n_matches | [B] max_count | [B] n_hashes |
      [B] overflow | [T] matches_t | [T] disc_t | [T] unique_t |
      3 scalars (seqs_classified, kmers_from_classified, kmers_matches)

    Unpack with :func:`unpack_batch_result`.

    ``match_cap`` (static, requires ``pack16``) switches to the RAGGED
    layout: the valid entries of the [B, K] match matrix are compacted
    row-major into a [match_cap] buffer and the per-read side arrays
    ride as two packed u32 words — at default cutoffs most reads carry
    0-2 matches, so the device->host payload shrinks ~10x:

      [C] (count<<16|target) | [B] (max_count<<16 | n_matches) |
      [B] (min(n_hashes, 0x1FFFF)<<1 | overflow) | [T]*3 | 3 scalars

    The host detects cap overflow as sum(n_matches) > C (entries past
    the cap are dropped by the scatter) and re-dispatches with a larger
    cap. Unpack with :func:`unpack_batch_result_ragged`.
    """
    codes1p, len1, codes2p, len2 = _unpack_batch_input(inbuf, L1, L2)
    codes1 = unpack_codes_2bit(codes1p, L1)
    codes2 = unpack_codes_2bit(codes2p, L2) if codes2p is not None else None
    m1 = max(L1 - w + 1, 1)
    m2 = max(L2 - w + 1, 1) if codes2p is not None else 0
    if sort_probes:
        # probe-locality experiment (scripts/probe_locality.py): reorder
        # each read's hashes by their first-hash-function row index so
        # the wide-table gather walks memory quasi-sequentially. The count
        # is a sum over the hash axis, so the permutation needs no undo
        # (the mask rides along in the sort).
        hashes, mask, n_hashes = extract_hashes(
            codes1, len1, codes2, len2, k=k, w=w, m1=m1, m2=m2
        )
        mc = compact_width(hashes.shape[1])
        if mc and mc < hashes.shape[1]:
            hashes, mask, overflow = compact_hashes(
                hashes, mask, max_compact=mc
            )
        else:
            overflow = jnp.zeros(hashes.shape[0], dtype=bool)
        r0 = ibf_row_indices(
            hashes, bin_size=bin_size, hash_functions=hash_functions
        )[..., 0].astype(jnp.uint32)
        lo = hashes.astype(jnp.uint32)
        hi = (hashes >> jnp.uint64(32)).astype(jnp.uint32)
        _, lo_s, hi_s, m_s = jax.lax.sort(
            (r0, lo, hi, mask.astype(jnp.uint32)),
            dimension=1, num_keys=1, is_stable=False,
        )
        hashes = lo_s.astype(jnp.uint64) | (
            hi_s.astype(jnp.uint64) << jnp.uint64(32)
        )
        mask = m_s.astype(bool)
        rows = ibf_row_indices(
            hashes, bin_size=bin_size, hash_functions=hash_functions
        )
        tc = bulk_target_counts_packed(
            tbl, rows, mask, byte_starts, byte_ends
        )
        counts = jnp.minimum(tc, n_hashes[:, None])
    else:
        counts, n_hashes, overflow = classify_counts_fused(
            tbl, byte_starts, byte_ends, codes1, len1, codes2, len2,
            k=k, w=w, m1=m1, m2=m2,
            bin_size=bin_size, hash_functions=hash_functions,
        )
    res = threshold_topk(
        counts, n_hashes, rel_cutoff, rel_filter, hashes_limit,
        top_k=top_k, sort16=pack16, emit_matches_t=emit_matches_t,
    )
    return _pack_result(res, n_hashes, overflow, pack16=pack16,
                        match_cap=match_cap)


@partial(
    jax.jit,
    static_argnames=(
        "k", "w", "L1", "L2", "sub_params", "top_k", "pack16",
        "match_cap", "emit_matches_t",
    ),
)
def classify_batch_packed_forest(
    tbls, byte_startss, byte_endss, inbuf,
    rel_cutoff, rel_filter, hashes_limit, *,
    k: int, w: int, L1: int, L2: int,
    sub_params: tuple,  # ((bin_size, hash_functions), ...) per sub-IBF
    top_k: int, pack16: bool, match_cap: int = 0,
    emit_matches_t: bool = True,
):
    """classify_batch_packed over an IBF forest (native HIBF).

    Extraction/compaction run once; every sub-IBF is bulk-counted in
    the same dispatch and the per-sub target counts concatenate in
    global target order (sub-filters hold disjoint targets, and the
    forest's target order is the concatenation of its subs' —
    index.hibf.HIBF.targets). Thresholds/top-K apply to the combined
    matrix, so a forest costs the same single RPC as a flat IBF.
    """
    codes1p, len1, codes2p, len2 = _unpack_batch_input(inbuf, L1, L2)
    codes1 = unpack_codes_2bit(codes1p, L1)
    codes2 = unpack_codes_2bit(codes2p, L2) if codes2p is not None else None
    m1 = max(L1 - w + 1, 1)
    m2 = max(L2 - w + 1, 1) if codes2p is not None else 0
    hashes, mask, n_hashes = extract_hashes(
        codes1, len1, codes2, len2, k=k, w=w, m1=m1, m2=m2
    )
    mc = compact_width(hashes.shape[1])
    if mc and mc < hashes.shape[1]:
        hashes, mask, overflow = compact_hashes(hashes, mask, max_compact=mc)
    else:
        overflow = jnp.zeros(hashes.shape[0], dtype=bool)
    parts = []
    for tbl, bs, be, (bin_size, hash_functions) in zip(
        tbls, byte_startss, byte_endss, sub_params
    ):
        rows = ibf_row_indices(
            hashes, bin_size=bin_size, hash_functions=hash_functions
        )
        parts.append(bulk_target_counts_packed(tbl, rows, mask, bs, be))
    counts = jnp.minimum(
        jnp.concatenate(parts, axis=1), n_hashes[:, None]
    )
    res = threshold_topk(
        counts, n_hashes, rel_cutoff, rel_filter, hashes_limit,
        top_k=top_k, sort16=pack16, emit_matches_t=emit_matches_t,
    )
    return _pack_result(res, n_hashes, overflow, pack16=pack16,
                        match_cap=match_cap)


@partial(
    jax.jit,
    static_argnames=(
        "k", "w", "L1", "L2", "sub_params", "num_targets", "top_k",
        "pack16", "match_cap", "emit_matches_t",
    ),
)
def classify_batch_packed_raptor(
    tbls, byte_startss, byte_endss, colss, inbuf,
    rel_cutoff, rel_filter, hashes_limit, *,
    k: int, w: int, L1: int, L2: int,
    sub_params: tuple,  # ((bin_size, hash_functions), ...) per sub-IBF
    num_targets: int, top_k: int, pack16: bool, match_cap: int = 0,
    emit_matches_t: bool = True,
):
    """classify_batch_packed over a raptor-format HIBF.

    Like classify_batch_packed_forest, but raptor user bins can appear
    in more than one sub-IBF (merged-bin routing), so per-sub counts
    scatter-max into the global target matrix (same accumulate as
    DeviceRaptorHIBF.counts) before thresholding — still one dispatch
    and one packed fetch per batch.
    """
    codes1p, len1, codes2p, len2 = _unpack_batch_input(inbuf, L1, L2)
    codes1 = unpack_codes_2bit(codes1p, L1)
    codes2 = unpack_codes_2bit(codes2p, L2) if codes2p is not None else None
    m1 = max(L1 - w + 1, 1)
    m2 = max(L2 - w + 1, 1) if codes2p is not None else 0
    hashes, mask, n_hashes = extract_hashes(
        codes1, len1, codes2, len2, k=k, w=w, m1=m1, m2=m2
    )
    mc = compact_width(hashes.shape[1])
    if mc and mc < hashes.shape[1]:
        hashes, mask, overflow = compact_hashes(hashes, mask, max_compact=mc)
    else:
        overflow = jnp.zeros(hashes.shape[0], dtype=bool)
    counts = jnp.zeros((hashes.shape[0], num_targets), dtype=jnp.int32)
    for tbl, bs, be, cols, (bin_size, hash_functions) in zip(
        tbls, byte_startss, byte_endss, colss, sub_params
    ):
        rows = ibf_row_indices(
            hashes, bin_size=bin_size, hash_functions=hash_functions
        )
        c = bulk_target_counts_packed(tbl, rows, mask, bs, be)
        counts = counts.at[:, cols].max(c)
    counts = jnp.minimum(counts, n_hashes[:, None])
    res = threshold_topk(
        counts, n_hashes, rel_cutoff, rel_filter, hashes_limit,
        top_k=top_k, sort16=pack16, emit_matches_t=emit_matches_t,
    )
    return _pack_result(res, n_hashes, overflow, pack16=pack16,
                        match_cap=match_cap)


@partial(
    jax.jit,
    static_argnames=(
        "k", "w", "L1", "L2", "sub_params", "num_union", "top_k",
        "match_cap", "emit_matches_t",
    ),
)
def classify_batch_packed_multi(
    tbls, startss, endss, colss, inbuf,
    rel_cutoffs, rel_filter, hashes_limit, *,
    k: int, w: int, L1: int, L2: int,
    sub_params: tuple,  # ((bin_size, hash_functions), ...) per filter
    num_union: int, top_k: int, match_cap: int = 0,
    emit_matches_t: bool = True,
):
    """classify_batch_packed over SEVERAL independent IBFs in one level.

    Reference semantics (GanonClassify.cpp select_matches, multi-filter
    levels): each filter applies ITS rel-cutoff, per-target counts merge
    into the union by strict-greater max (first filter wins ties), and
    the winning filter's per-target fpr rides with the match for the
    host-side fpr-query stage — so the winner index travels through the
    top-K sort as a payload. rel-filter/top-K then run on the union.
    (Deliberate deviation, matching our host slow path: min_count for
    rel-filter is taken over the FINAL union, not over superseded
    per-filter counts the reference transiently tracks.)

    Requires the pack16 bound (union targets and counts <= 0xFFFF);
    the engine gates on it. One dispatch, one packed fetch, layout:

      [B*K] matches | [B*K] winners | [B] n_matches | [B] max_count |
      [B] n_hashes | [B] overflow | [U] matches_t | [U] disc_t |
      [U] unique_t | 3 scalars
    """
    codes1p, len1, codes2p, len2 = _unpack_batch_input(inbuf, L1, L2)
    codes1 = unpack_codes_2bit(codes1p, L1)
    codes2 = unpack_codes_2bit(codes2p, L2) if codes2p is not None else None
    m1 = max(L1 - w + 1, 1)
    m2 = max(L2 - w + 1, 1) if codes2p is not None else 0
    hashes, mask, n_hashes = extract_hashes(
        codes1, len1, codes2, len2, k=k, w=w, m1=m1, m2=m2
    )
    mc = compact_width(hashes.shape[1])
    if mc and mc < hashes.shape[1]:
        hashes, mask, overflow = compact_hashes(hashes, mask, max_compact=mc)
    else:
        overflow = jnp.zeros(hashes.shape[0], dtype=bool)
    B = hashes.shape[0]
    nhf = n_hashes.astype(jnp.float64)
    valid = (n_hashes > 0) & (n_hashes <= hashes_limit)
    ucounts = jnp.zeros((B, num_union), dtype=jnp.int32)
    uwin = jnp.zeros((B, num_union), dtype=jnp.int32)
    for fi, (tbl, bs, be, cols, (bin_size, hash_functions)) in enumerate(
        zip(tbls, startss, endss, colss, sub_params)
    ):
        rows = ibf_row_indices(
            hashes, bin_size=bin_size, hash_functions=hash_functions
        )
        c = jnp.minimum(
            bulk_target_counts_packed(tbl, rows, mask, bs, be),
            n_hashes[:, None],
        )
        cutoff = jnp.maximum(
            jnp.ceil(nhf * rel_cutoffs[fi]), 1.0
        ).astype(jnp.int32)
        cand = jnp.where((c >= cutoff[:, None]) & valid[:, None], c, 0)
        cu = jnp.zeros((B, num_union), dtype=jnp.int32).at[:, cols].set(cand)
        better = cu > ucounts
        ucounts = jnp.where(better, cu, ucounts)
        uwin = jnp.where(better, fi, uwin)
    # per-filter cutoffs are pre-applied (zeros dropped by the >=1 floor)
    res = threshold_topk(
        ucounts, n_hashes, jnp.float64(0.0), rel_filter, hashes_limit,
        top_k=top_k, sort16=True, winners=uwin,
        emit_matches_t=emit_matches_t,
    )
    return _pack_result(res, n_hashes, overflow, pack16=True,
                        match_cap=match_cap, with_win=True)


def unpack_batch_result(packed: np.ndarray, B: int, K: int, T: int,
                        pack16: bool = True, has_win: bool = False,
                        n_extra: int = 0,
                        has_matches_t: bool = True) -> dict:
    """Split a classify_batch_packed fetch back into the result dict."""
    o = 0

    def take(n, shape=None):
        nonlocal o
        v = packed[o:o + n]
        o += n
        return v.reshape(shape) if shape is not None else v

    if pack16:
        m = take(B * K, (B, K)).view(np.uint32)
        top_vals = (m >> 16).astype(np.int32)
        top_idx = (m & 0xFFFF).astype(np.int32)
    else:
        top_vals = take(B * K, (B, K))
        top_idx = take(B * K, (B, K))
    top_win = take(B * K, (B, K)) if has_win else None
    out = {
        "top_vals": top_vals,
        "top_idx": top_idx,
        "top_win": top_win,
        "n_matches": take(B),
        "max_count": take(B),
        "n_hashes": take(B),
        "overflow": take(B).astype(bool),
        "extra_rows": [take(B).view(np.uint32) for _ in range(n_extra)],
        "disc_t": take(T),
    }
    if has_matches_t:
        out["matches_t"] = take(T)
    scalars = take(3)
    out["seqs_classified"] = scalars[0]
    out["kmers_from_classified"] = scalars[1]
    out["kmers_matches"] = scalars[2]
    return out


def unpack_batch_result_ragged(packed: np.ndarray, B: int, C: int,
                               T: int, K: int,
                               has_win: bool = False,
                               n_extra: int = 0,
                               has_matches_t: bool = True) -> dict:
    """Split a ragged classify_batch_packed fetch (match_cap layout).

    Reconstructs the [B, Kmax] top_vals/top_idx matrices from the
    row-major compacted match stream. The stream holds
    ``min(n_matches, K)`` entries per row (the device's top-K matrix is
    K wide even when more targets passed; the raw ``n_matches`` rides
    in w1 so the caller's top-K escalation check still sees it). Sets
    ``cap_overflow`` when the stream exceeded the cap (entries were
    dropped on device — re-dispatch with a larger cap); the matrices
    are not reconstructed in that case.
    """
    o = 0

    def take(n):
        nonlocal o
        v = packed[o:o + n]
        o += n
        return v

    comp = take(C).view(np.uint32)
    comp_win = take(C) if has_win else None
    w1 = take(B).view(np.uint32)
    w2 = take(B).view(np.uint32)
    n_matches = (w1 & 0xFFFF).astype(np.int32)
    max_count = (w1 >> 16).astype(np.int32)
    overflow = (w2 & 1).astype(bool)
    n_hashes = (w2 >> 1).astype(np.int32)
    out = {
        "n_matches": n_matches,
        "max_count": max_count,
        "n_hashes": n_hashes,
        "overflow": overflow,
        "top_win": None,
        "extra_rows": [take(B).view(np.uint32) for _ in range(n_extra)],
        "disc_t": take(T),
    }
    if has_matches_t:
        out["matches_t"] = take(T)
    scalars = take(3)
    out["seqs_classified"] = scalars[0]
    out["kmers_from_classified"] = scalars[1]
    out["kmers_matches"] = scalars[2]
    nm_eff = np.minimum(n_matches, K)
    total = int(nm_eff.sum())
    out["cap_overflow"] = total > C
    if not out["cap_overflow"]:
        Km = max(1, int(nm_eff.max()) if B else 1)
        tv = np.zeros((B, Km), dtype=np.int32)
        ti = np.zeros((B, Km), dtype=np.int32)
        tw = np.zeros((B, Km), dtype=np.int32) if has_win else None
        if total:
            ii = np.repeat(np.arange(B), nm_eff)
            off = np.zeros(B, dtype=np.int64)
            off[1:] = np.cumsum(nm_eff[:-1])
            jj = np.arange(total) - off[ii]
            vals = comp[:total]
            tv[ii, jj] = (vals >> 16).astype(np.int32)
            ti[ii, jj] = (vals & 0xFFFF).astype(np.int32)
            if has_win:
                tw[ii, jj] = comp_win[:total]
        out["top_vals"] = tv
        out["top_idx"] = ti
        if has_win:
            out["top_win"] = tw
    return out


def _place_table(tbl8, byte_starts, byte_ends, mesh):
    """Put a :func:`pack_table_u8` table on device as its u32 word view.

    With ``mesh`` the word axis is column-sharded over ``bins`` (padded
    so every shard holds whole words) and the byte ranges replicate.
    Returns ``(tbl, byte_starts, byte_ends)`` as device arrays.
    """
    if mesh is None:
        return (jax.device_put(table_as_u32(tbl8)), jnp.asarray(byte_starts),
                jnp.asarray(byte_ends))
    from jax.sharding import NamedSharding, PartitionSpec as P

    align = 4 * mesh.shape["bins"]
    W8 = tbl8.shape[1]
    W8_pad = -(-W8 // align) * align
    if W8_pad != W8:
        tbl8 = np.pad(tbl8, ((0, 0), (0, W8_pad - W8)))
    rep = NamedSharding(mesh, P())
    return (
        jax.device_put(table_as_u32(tbl8),
                       NamedSharding(mesh, P(None, "bins"))),
        jax.device_put(jnp.asarray(byte_starts), rep),
        jax.device_put(jnp.asarray(byte_ends), rep),
    )


class DeviceFilter:
    """An IBF resident on device, ready for batched counting.

    With ``mesh`` (a 2-D ``(batch, bins)`` jax Mesh) the table is
    column-sharded over the ``bins`` axis and inputs are expected
    batch-sharded: the gather + popcount + per-byte reduction stay
    shard-local and GSPMD inserts the small all_gather of per-byte
    counts before the target segment sum (the collective the reference
    never needed single-host — SURVEY §2.1).
    """

    def __init__(self, ibf, device=None, mesh=None):
        self.ibf_config = ibf.ibf_config
        self.targets = ibf.targets()
        self.num_targets = len(self.targets)
        self.mesh = mesh
        self.batch_mult = 1
        b2t = ibf.bin_to_target_ids()
        tbl8, byte_starts, byte_ends = pack_table_u8(
            ibf.bits, b2t, self.num_targets
        )
        self.tbl, self.byte_starts, self.byte_ends = _place_table(
            tbl8, byte_starts, byte_ends, mesh
        )
        if mesh is not None:
            self.batch_mult = mesh.shape["batch"]
        self.target_fpr = ibf.target_fpr()

    def put_batch(self, arr):
        """Device-put a [B, ...] host array, batch-sharded when meshed."""
        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = P("batch", *([None] * (arr.ndim - 1)))
        return jax.device_put(arr, NamedSharding(self.mesh, spec))

    def counts(self, hashes, mask, n_hashes) -> np.ndarray:
        return filter_counts(
            self.tbl,
            self.byte_starts,
            self.byte_ends,
            hashes,
            mask,
            n_hashes,
            bin_size=self.ibf_config.bin_size_bits,
            hash_functions=self.ibf_config.hash_functions,
        )


@partial(jax.jit, static_argnames=("top_k", "sort16", "emit_matches_t"))
def threshold_topk(
    counts, n_hashes, rel_cutoff, rel_filter, hashes_limit, *,
    top_k: int, sort16: bool = False, winners=None,
    emit_matches_t: bool = True,
):
    """Device-side rel-cutoff + rel-filter + top-K match compaction.

    Applies the reference threshold semantics (GanonClassify.cpp:719-758)
    on device and returns only compact results, so a batch's device->host
    traffic drops from B x T counts to B x K matches plus per-target
    tallies — essential here because host transfers are the bottleneck,
    and the right production design regardless.

    ``sort16`` (static; requires counts and target ids <= 0xFFFF, the
    same bound the engine's pack16 flag asserts) replaces lax.top_k's
    full variadic (vals, iota) sort with a single u32 sort of
    ``count << 16 | ~idx`` — half the data through the sort network,
    with identical results (descending count, ascending index on ties).

    Returns dict with:
      top_vals/top_idx  int32 [B, K] final matches (desc count, 0-padded)
      n_matches         int32 [B]
      max_count         int32 [B]
      n_hashes          int32 [B]
      matches_t/disc_t/unique_t  int32 [T] per-target tallies
    """
    nh = n_hashes.astype(jnp.float64)
    cutoff = jnp.maximum(jnp.ceil(nh * rel_cutoff), 1.0)
    valid = (n_hashes > 0) & (n_hashes <= hashes_limit)
    kept = (counts >= cutoff[:, None].astype(jnp.int32)) & valid[:, None]
    kcounts = jnp.where(kept, counts, 0)
    max_count = kcounts.max(axis=1)
    big = jnp.iinfo(jnp.int32).max
    min_count = jnp.minimum(
        n_hashes, jnp.where(kept, counts, big).min(axis=1)
    )
    # thr is integral (int minus a ceil'd int); comparing in int32 keeps
    # the [B, T] compare off the (emulated, slow) f64 path — only the
    # [B]-sized threshold math runs in f64 like the reference's doubles
    thr = (
        max_count.astype(jnp.float64)
        - jnp.ceil((max_count - min_count).astype(jnp.float64) * rel_filter)
    ).astype(jnp.int32)
    final = kept & (counts >= thr[:, None])
    n_matches = final.sum(axis=1).astype(jnp.int32)
    fvals = jnp.where(final, counts, 0)
    k = min(top_k, counts.shape[1])
    top_win = None
    if sort16:
        T = counts.shape[1]
        idx_c = jnp.uint32(0xFFFF) - jnp.arange(T, dtype=jnp.uint32)
        packed = (fvals.astype(jnp.uint32) << jnp.uint32(16)) | idx_c
        if k <= 8 and T >= 4096:
            # iterative masked-argmax extraction: 2k [B, T] reductions
            # in place of the full-width sort at wide T (compare with
            # scripts/argmax_topk_probe.py) — the engine starts wide
            # tables at this tier and escalates on match overflow.
            # Exact, incl. the descending-count/ascending-index tie
            # order (the packed value encodes both).
            rows = jnp.arange(packed.shape[0])
            tv, ti, tw = [], [], []
            for _ in range(k):
                j = jnp.argmax(packed, axis=1)
                p = jnp.take_along_axis(packed, j[:, None], axis=1)[:, 0]
                tv.append((p >> jnp.uint32(16)).astype(jnp.int32))
                ti.append(
                    (jnp.uint32(0xFFFF) - (p & jnp.uint32(0xFFFF)))
                    .astype(jnp.int32)
                )
                if winners is not None:
                    tw.append(
                        jnp.take_along_axis(
                            winners, j[:, None], axis=1
                        )[:, 0].astype(jnp.int32)
                    )
                packed = packed.at[rows, j].set(0)
            top_vals = jnp.stack(tv, axis=1)
            top_idx = jnp.stack(ti, axis=1)
            if winners is not None:
                top_win = jnp.stack(tw, axis=1)
        else:
            if winners is not None:
                # carry the winning-filter id as a sort payload (no
                # post-hoc [B, K] take_along_axis gather)
                s, w_s = jax.lax.sort(
                    (packed, winners.astype(jnp.uint32)),
                    dimension=1, num_keys=1, is_stable=False,
                )
                top_win = w_s[:, T - k:][:, ::-1].astype(jnp.int32)
            else:
                s = jax.lax.sort(packed, dimension=1, is_stable=False)
            top = s[:, T - k:][:, ::-1]
            top_vals = (top >> 16).astype(jnp.int32)
            top_idx = (
                jnp.uint32(0xFFFF) - (top & jnp.uint32(0xFFFF))
            ).astype(jnp.int32)
    else:
        assert winners is None, "winners requires sort16"
        top_vals, top_idx = jax.lax.top_k(fvals, k)
    classified = n_matches > 0
    out = {} if top_win is None else {"top_win": top_win}
    if emit_matches_t:
        # only consumed by the host when fpr-query is off (the fpr
        # branch recomputes matches from the top matrices); per-batch
        # [T] payloads grow the fetch at wide T
        out["matches_t"] = final.sum(axis=0).astype(jnp.int32)
    return out | {
        "top_vals": top_vals.astype(jnp.int32),
        "top_idx": top_idx.astype(jnp.int32),
        "n_matches": n_matches,
        "max_count": max_count.astype(jnp.int32),
        "disc_t": (kept & ~final).sum(axis=0).astype(jnp.int32),
        "seqs_classified": classified.sum().astype(jnp.int64),
        "kmers_from_classified": jnp.where(classified, n_hashes, 0)
        .sum()
        .astype(jnp.int64),
        "kmers_matches": jnp.where(classified, max_count, 0)
        .sum()
        .astype(jnp.int64),
    }


class DeviceHIBF:
    """A size-stratified IBF forest on device (same interface as
    DeviceFilter): per-class counts are concatenated in global target
    order (classes hold disjoint targets). ``mesh`` shards every
    sub-IBF's table over the bins axis (DeviceFilter)."""

    def __init__(self, hibf, device=None, mesh=None):
        self.ibf_config = hibf.ibf_config
        self.targets = hibf.targets()
        self.num_targets = len(self.targets)
        self.mesh = mesh
        self.batch_mult = 1 if mesh is None else mesh.shape["batch"]
        tid = {t: i for i, t in enumerate(self.targets)}
        self.subs = [DeviceFilter(s, mesh=mesh) for s in hibf.subs]
        self.sub_cols = [
            np.asarray([tid[t] for t in s.targets], dtype=np.int32)
            for s in self.subs
        ]
        # by construction the global target order is the concatenation of
        # the subs' orders; the packed forest dispatch relies on it
        off = 0
        self.contiguous = True
        for cols in self.sub_cols:
            if not np.array_equal(cols, np.arange(off, off + len(cols))):
                self.contiguous = False
                break
            off += len(cols)
        self.target_fpr = hibf.target_fpr()

    put_batch = DeviceFilter.put_batch

    def counts(self, hashes, mask, n_hashes) -> np.ndarray:
        out = jnp.zeros(
            (hashes.shape[0], self.num_targets), dtype=jnp.int32
        )
        for sub, cols in zip(self.subs, self.sub_cols):
            c = sub.counts(hashes, mask, n_hashes)
            out = out.at[:, cols].set(c.astype(jnp.int32))
        return out


class DeviceRaptorHIBF:
    """A raptor-format HIBF flattened into per-sub-IBF u8 tables.

    Queries every sub-IBF (see index.hibf.RaptorHIBF for why that is
    equivalent to the reference's gated recursion) and sums each user
    bin's technical-bin counts; user bins spread across sub-IBFs are
    scattered into global target columns.
    """

    def __init__(self, rhibf, device=None, mesh=None):
        self.ibf_config = rhibf.ibf_config
        self.targets = rhibf.targets()
        self.num_targets = len(self.targets)
        self.target_fpr = rhibf.target_fpr()
        self.mesh = mesh
        self.batch_mult = 1 if mesh is None else mesh.shape["batch"]
        self.subs = []
        for (bits, bins, bin_size, hash_funs), b2f in zip(
            rhibf.ibfs, rhibf.bin_to_filename
        ):
            tb = bits.shape[1] * 32
            # per-sub target map: technical bin -> local user index; the
            # local->global column map routes counts to target columns
            fpos = np.asarray(b2f[:tb] if len(b2f) >= tb else
                              np.pad(b2f, (0, tb - len(b2f)),
                                     constant_values=-1))
            used = sorted({int(v) for v in fpos if v >= 0})
            if not used:
                # routing-only IBF (all bins merged): the flattened query
                # reads its children directly
                continue
            local_of = {g: i for i, g in enumerate(used)}
            b2t_local = np.asarray(
                [local_of.get(int(v), len(used)) for v in fpos],
                dtype=np.int32,
            )
            tbl, bstarts, bends = _place_table(
                *pack_table_u8(bits, b2t_local, len(used)), mesh
            )
            self.subs.append({
                "tbl": tbl,
                "byte_starts": bstarts,
                "byte_ends": bends,
                "bin_size": int(bin_size),
                "hash_funs": int(hash_funs),
                "cols": np.asarray(used, dtype=np.int32),
            })

    put_batch = DeviceFilter.put_batch

    def counts(self, hashes, mask, n_hashes) -> np.ndarray:
        out = jnp.zeros((hashes.shape[0], self.num_targets), dtype=jnp.int32)
        for sub in self.subs:
            if not len(sub["cols"]):
                continue
            c = filter_counts(
                sub["tbl"], sub["byte_starts"], sub["byte_ends"],
                hashes, mask, n_hashes,
                bin_size=sub["bin_size"],
                hash_functions=sub["hash_funs"],
            )
            out = out.at[:, sub["cols"]].max(c.astype(jnp.int32))
        return out


# --------------------------------------------------------------------------
# merged-bin pruned forest (index.pruned): coarse gate + grouped fine table


def _bit_expand(member, nbits: int):
    """[..., W] words -> [..., W*nbits] bit lanes (little-endian order).

    Little-endian u32 words view the same bytes as the u8 table, so bit
    ``i`` of the expanded axis is bin ``i`` under either element type.
    """
    shifts = jnp.arange(nbits, dtype=member.dtype)
    planes = (member[..., None] >> shifts) & member.dtype.type(1)
    return planes.reshape(*member.shape[:-1], member.shape[-1] * nbits)


@partial(jax.jit, static_argnames=("num_groups",))
def bulk_group_counts(ctbl, crows, hash_mask, *, num_groups: int):
    """Coarse merged-bin counts: one bin per target GROUP, bit-packed.

    ``counts[b, g] = #hashes whose h rows all have bit g set`` — the
    same bulk-count semantics as the fine stage, but the row is only
    ``G/8`` bytes so the whole coarse pass reads little memory. Unlike
    pack_table_u8 there is no per-target byte padding (padding would
    inflate the coarse table 8x for 1-bin groups).
    """
    member = ctbl[crows[:, :, 0]]  # [B, M, Wc]
    for s in range(1, crows.shape[2]):
        member = member & ctbl[crows[:, :, s]]
    zero = member.dtype.type(0)
    member = jnp.where(hash_mask[:, :, None], member, zero)
    nbits = 32 if member.dtype == jnp.uint32 else 8
    planes = _bit_expand(member, nbits)  # [B, M, Gp]
    counts = jnp.sum(planes.astype(jnp.int32), axis=1)
    return counts[:, :num_groups]


def _pruned_fine_rows(hashes, sel_bsz, sel_shift, sel_off, *, fine_h: int):
    """Fine-table row indices with PER-SLOT (bin_size, shift, offset).

    The pruned forest's groups each have their own bin size (the
    per-group re-expression of the reference's per-level IBF geometry),
    so fastrange runs with dynamic parameters gathered per (read, slot)
    — all vector ALU, no extra gathers. Returns int32 [B, S, M, H].
    """
    from ganon_tpu.ops.ibf_query import GOLDEN, HASH_SEEDS, _mulhi64

    h = hashes[:, None, :]  # [B, 1, M] u64
    bsz = sel_bsz[:, :, None]  # [B, S, 1] u64
    shift = sel_shift[:, :, None]  # [B, S, 1] u64
    rows = []
    for i in range(fine_h):
        g = h * jnp.uint64(HASH_SEEDS[i])
        g = g ^ (g >> shift)
        g = g * jnp.uint64(GOLDEN)
        r = _mulhi64(g, bsz).astype(jnp.int32) + sel_off[:, :, None]
        rows.append(r)
    return jnp.stack(rows, axis=-1)


@partial(
    jax.jit,
    static_argnames=(
        "k", "w", "L1", "L2", "coarse_bin_size", "coarse_h", "fine_h",
        "max_groups", "group_size", "num_targets", "top_k", "match_cap",
        "emit_matches_t", "pair_cap",
    ),
)
def classify_batch_packed_pruned(
    ctbl, ftbl, grp_row_off, grp_bin_size, grp_shift, grp_ntargets, inbuf,
    rel_cutoff, rel_filter, hashes_limit, *,
    k: int, w: int, L1: int, L2: int,
    coarse_bin_size: int, coarse_h: int, fine_h: int,
    max_groups: int, group_size: int, num_targets: int,
    top_k: int, match_cap: int = 0, emit_matches_t: bool = True,
    pair_cap: int = 0,
):
    """One-dispatch pruned classify: coarse gate -> top-S fine probes.

    A flat, branch-free form of the reference HIBF's threshold-gated descent
    (hierarchical_interleaved_bloom_filter.hpp:432-460): bulk-count the
    coarse merged-bin IBF, keep only groups whose count reaches the
    read's rel-cutoff threshold, then gather ONLY the surviving groups'
    narrow fine rows (``max_groups`` static slots per read; a read with
    more surviving groups sets its overflow flag and the engine falls
    back to the probe-all gated path). Probed fine bytes drop from the
    full table width to ``S x group_size/8`` per hash.

    ``pair_cap`` > 0 compacts the fine stage further: only the actual
    surviving (read, slot) pairs (at most ``pair_cap`` of them, in
    read-major order) hash and gather, instead of every read paying all
    S slots — at default cutoffs survivors average ~1 of S=2, so the
    fine probes drop another ~(1 - cap/(B*S)). Reads whose pairs spill
    past the cap set their overflow flag (exact probe-all fallback,
    same contract as ``n_surv > S``). 0 = dense [B, S] fine stage.

    Packed output layout = classify_batch_packed (pack16 always; gated
    semantics — see index.pruned module docstring).
    """
    G = grp_row_off.shape[0]
    S = max_groups
    gs = group_size
    codes1p, len1, codes2p, len2 = _unpack_batch_input(inbuf, L1, L2)
    codes1 = unpack_codes_2bit(codes1p, L1)
    codes2 = unpack_codes_2bit(codes2p, L2) if codes2p is not None else None
    m1 = max(L1 - w + 1, 1)
    m2 = max(L2 - w + 1, 1) if codes2p is not None else 0
    hashes, mask, n_hashes = extract_hashes(
        codes1, len1, codes2, len2, k=k, w=w, m1=m1, m2=m2
    )
    mc = compact_width(hashes.shape[1])
    if mc and mc < hashes.shape[1]:
        hashes, mask, overflow = compact_hashes(hashes, mask, max_compact=mc)
    else:
        overflow = jnp.zeros(hashes.shape[0], dtype=bool)
    B = hashes.shape[0]

    # coarse stage
    crows = ibf_row_indices(
        hashes, bin_size=coarse_bin_size, hash_functions=coarse_h
    )
    gcounts = bulk_group_counts(ctbl, crows, mask, num_groups=G)
    nh = n_hashes.astype(jnp.float64)
    cutoff = jnp.maximum(jnp.ceil(nh * rel_cutoff), 1.0).astype(jnp.int32)
    valid = (n_hashes > 0) & (n_hashes <= hashes_limit)
    surv = (gcounts >= cutoff[:, None]) & valid[:, None]
    n_surv = surv.sum(axis=1).astype(jnp.int32)
    overflow = overflow | (n_surv > S)

    # top-S surviving groups by coarse count (iterative masked argmax:
    # S is tiny and G-wide sorts are the wide-table lesson's cost)
    keyed = jnp.where(surv, gcounts, -1)
    rows_b = jnp.arange(B)
    sel, sel_ok = [], []
    for _ in range(S):
        j = jnp.argmax(keyed, axis=1)
        ok = jnp.take_along_axis(keyed, j[:, None], axis=1)[:, 0] >= 0
        sel.append(jnp.where(ok, j, 0).astype(jnp.int32))
        sel_ok.append(ok)
        keyed = keyed.at[rows_b, j].set(-1)
    gsel = jnp.stack(sel, axis=1)  # [B, S] int32 (0 where invalid)
    slot_ok = jnp.stack(sel_ok, axis=1)  # [B, S] bool

    # fine stage: per-slot dynamic fastrange + one narrow gather
    sel_off = grp_row_off[gsel]  # [B, S] int32
    sel_bsz = grp_bin_size[gsel].astype(jnp.uint64)
    sel_shift = grp_shift[gsel].astype(jnp.uint64)
    nbits = 32 if ftbl.dtype == jnp.uint32 else 8
    if pair_cap and pair_cap < B * S:
        # (read, slot) pair compaction: cumsum-position the surviving
        # pairs read-major, scatter their coordinates into pair_cap
        # static slots (drop past the cap; spilled reads -> overflow),
        # then hash/gather/expand on [P, M] instead of [B, S, M]
        P = pair_cap
        n_slots = slot_ok.sum(axis=1).astype(jnp.int32)
        read_end = jnp.cumsum(n_slots)
        overflow = overflow | ((read_end > P) & (n_slots > 0))
        flat_ok = slot_ok.reshape(-1)
        pos = jnp.cumsum(flat_ok.astype(jnp.int32)) - 1
        tgt = jnp.where(flat_ok, jnp.minimum(pos, P), P)
        pair_read = jnp.full((P,), B, jnp.int32).at[tgt].set(
            jnp.repeat(jnp.arange(B, dtype=jnp.int32), S), mode="drop"
        )
        pair_slot = jnp.zeros((P,), jnp.int32).at[tgt].set(
            jnp.tile(jnp.arange(S, dtype=jnp.int32), B), mode="drop"
        )
        pvalid = pair_read < B  # slots past the last pair stay sentinel
        pr = jnp.where(pvalid, pair_read, 0)
        ps = pair_slot
        frows = _pruned_fine_rows(
            hashes[pr],
            sel_bsz[pr, ps][:, None],
            sel_shift[pr, ps][:, None],
            sel_off[pr, ps][:, None],
            fine_h=fine_h,
        )  # [P, 1, M, H]
        member = ftbl[frows[:, 0, :, 0]]  # [P, M, Wf]
        for s in range(1, fine_h):
            member = member & ftbl[frows[:, 0, :, s]]
        zero = member.dtype.type(0)
        pmask = mask[pr] & pvalid[:, None]
        member = jnp.where(pmask[:, :, None], member, zero)
        planes = _bit_expand(member, nbits)[..., :gs]  # [P, M, gs]
        pcounts = jnp.sum(planes.astype(jnp.int32), axis=1).astype(
            jnp.int32
        )  # [P, gs] (sum promotes to i64 under x64; scatter wants i32)
        counts = jnp.zeros((B, S, gs), jnp.int32).at[pair_read, pair_slot].add(
            pcounts, mode="drop"
        )
    else:
        frows = _pruned_fine_rows(
            hashes, sel_bsz, sel_shift, sel_off, fine_h=fine_h
        )  # [B, S, M, H]
        member = ftbl[frows[..., 0]]  # [B, S, M, Wf]
        for s in range(1, fine_h):
            member = member & ftbl[frows[..., s]]
        zero = member.dtype.type(0)
        fmask = mask[:, None, :, None] & slot_ok[:, :, None, None]
        member = jnp.where(fmask, member, zero)
        # expansion width can exceed gs (table_as_u32 pads rows x4)
        planes = _bit_expand(member, nbits)[..., :gs]  # [B, S, M, gs]
        counts = jnp.sum(planes.astype(jnp.int32), axis=2)  # [B, S, gs]
    counts = jnp.minimum(counts, n_hashes[:, None, None])

    # LANE ids (slot*gs + offset <= S*gs-1, always u16-safe) instead of
    # global target ids: the top-K matches ship lanes plus the per-read
    # surviving-group words, and the HOST maps lane -> global
    # (gsel[lane//gs]*gs + lane%gs). This frees the fast path from the
    # old T <= 0xFFFF bound — RefSeq-scale databases (hundreds of
    # thousands of targets) stay on the pruned kernel; the only
    # remaining pack16 requirement is counts <= 0xFFFF (hashes_limit).
    lane = jnp.arange(gs, dtype=jnp.int32)
    lane_ok = (
        (lane[None, None, :] < grp_ntargets[gsel][:, :, None])
        & slot_ok[:, :, None]
    )
    C = S * gs
    lanes = jnp.where(
        lane_ok,
        (jnp.arange(S, dtype=jnp.int32) * gs)[None, :, None]
        + lane[None, None, :],
        C,
    )
    res = threshold_topk_ids(
        counts.reshape(B, C), lanes.reshape(B, C), n_hashes,
        rel_cutoff, rel_filter, hashes_limit,
        top_k=top_k, num_targets=C, tallies=False,
    )
    # surviving-group ids ride as packed u16 pairs (ceil(S/2) words)
    gsel_u = jnp.where(slot_ok, gsel, 0xFFFF).astype(jnp.uint32)
    gsel_words = tuple(
        (gsel_u[:, 2 * i]
         | (gsel_u[:, 2 * i + 1] << jnp.uint32(16)
            if 2 * i + 1 < S else jnp.uint32(0xFFFF0000))).astype(
             jnp.int32)
        for i in range(-(-S // 2))
    )
    # per-target tallies via a GROUP-indexed scatter: [B, S] indices with
    # [gs]-lane payloads instead of B*S*gs scalar adds: gs-fold fewer
    # scatter indices than the flat .at[ids].add form, with vectorized
    # rows
    final3 = res.pop("final").reshape(B, S, gs)
    kept3 = res.pop("kept").reshape(B, S, gs)
    T = num_targets
    dt = jnp.zeros((G, gs), jnp.int32).at[gsel].add(
        (kept3 & ~final3).astype(jnp.int32), mode="drop"
    )
    res["disc_t"] = dt.reshape(-1)[:T]
    if emit_matches_t:
        mt = jnp.zeros((G, gs), jnp.int32).at[gsel].add(
            final3.astype(jnp.int32), mode="drop"
        )
        res["matches_t"] = mt.reshape(-1)[:T]
    return _pack_result(res, n_hashes, overflow, pack16=True,
                        match_cap=match_cap, extra_rows=gsel_words)


@partial(jax.jit, static_argnames=("top_k", "num_targets", "tallies"))
def threshold_topk_ids(
    counts, ids, n_hashes, rel_cutoff, rel_filter, hashes_limit, *,
    top_k: int, num_targets: int, tallies: bool = True,
):
    """threshold_topk over a COMPACT (counts, ids) matrix.

    Same reference threshold semantics (GanonClassify.cpp:719-758), but
    the candidate axis is the pruned kernel's ``S x group_size`` lanes
    with explicit global target ids (sentinel ``num_targets`` marks
    invalid lanes) instead of a dense [B, T] matrix — the matrix the
    wide-table regime can no longer afford to sort. Requires u16-safe
    ids and counts (<= 0xFFFF) — the pruned kernel passes LANE ids
    (slot*group_size + offset, bounded by S*gs regardless of the
    database's target count) and maps lane -> global on the host.
    Per-target tallies scatter-add into [T] (sentinel ids drop) when
    ``tallies`` is set.
    """
    nh = n_hashes.astype(jnp.float64)
    cutoff = jnp.maximum(jnp.ceil(nh * rel_cutoff), 1.0).astype(jnp.int32)
    valid = (n_hashes > 0) & (n_hashes <= hashes_limit)
    live = ids < num_targets
    kept = live & (counts >= cutoff[:, None]) & valid[:, None]
    max_count = jnp.where(kept, counts, 0).max(axis=1)
    big = jnp.iinfo(jnp.int32).max
    min_count = jnp.minimum(
        n_hashes, jnp.where(kept, counts, big).min(axis=1)
    )
    thr = (
        max_count.astype(jnp.float64)
        - jnp.ceil((max_count - min_count).astype(jnp.float64) * rel_filter)
    ).astype(jnp.int32)
    final = kept & (counts >= thr[:, None])
    n_matches = final.sum(axis=1).astype(jnp.int32)
    fvals = jnp.where(final, counts, 0)

    C = counts.shape[1]
    k = min(top_k, C)
    idx_c = jnp.uint32(0xFFFF) - jnp.minimum(
        ids, num_targets
    ).astype(jnp.uint32)
    packed = (fvals.astype(jnp.uint32) << jnp.uint32(16)) | idx_c
    s = jax.lax.sort(packed, dimension=1, is_stable=False)
    top = s[:, C - k:][:, ::-1]
    top_vals = (top >> 16).astype(jnp.int32)
    top_idx = (
        jnp.uint32(0xFFFF) - (top & jnp.uint32(0xFFFF))
    ).astype(jnp.int32)

    classified = n_matches > 0
    out = {
        "top_vals": top_vals,
        "top_idx": top_idx,
        "n_matches": n_matches,
        "max_count": max_count.astype(jnp.int32),
        "seqs_classified": classified.sum().astype(jnp.int64),
        "kmers_from_classified": jnp.where(classified, n_hashes, 0)
        .sum()
        .astype(jnp.int64),
        "kmers_matches": jnp.where(classified, max_count, 0)
        .sum()
        .astype(jnp.int64),
    }
    if not tallies:
        # caller computes per-target tallies from the masks (the pruned
        # kernel uses a far cheaper group-indexed scatter)
        out["final"] = final
        out["kept"] = kept
        return out
    T = num_targets
    fin32 = final.astype(jnp.int32)
    out["matches_t"] = jnp.zeros((T,), jnp.int32).at[ids.reshape(-1)].add(
        fin32.reshape(-1), mode="drop"
    )
    out["disc_t"] = jnp.zeros((T,), jnp.int32).at[ids.reshape(-1)].add(
        (kept & ~final).astype(jnp.int32).reshape(-1), mode="drop"
    )
    return out


@partial(
    jax.jit,
    static_argnames=("fine_h", "group_size", "num_targets",
                     "coarse_bin_size", "coarse_h", "gated"),
)
def _pruned_all_counts(
    ftbl, ctbl, grp_row_off, grp_bin_size, grp_shift,
    hashes, mask, n_hashes, rel_cutoff, hashes_limit, *,
    fine_h: int, group_size: int, num_targets: int,
    coarse_bin_size: int = 0, coarse_h: int = 0, gated: bool = True,
):
    """Probe-ALL-groups counts [B, T] (the pruned forest's slow path).

    ``gated=True`` applies the same coarse gate as the fast kernel
    (groups below the read's cutoff zero out), so the overflow fallback
    is bit-identical to the pruned path at any match width; False gives
    the raw ungated counts (tests / curiosity only — NOT the filter's
    defined semantics). A lax.scan over groups keeps the program small
    at any G.
    """
    from ganon_tpu.ops.ibf_query import GOLDEN, HASH_SEEDS, _mulhi64

    B = hashes.shape[0]
    gs = group_size
    nbits_f = 32 if ftbl.dtype == jnp.uint32 else 8

    def body(_, xs):
        off, bsz, shift = xs
        members = None
        for i in range(fine_h):
            g = hashes * jnp.uint64(HASH_SEEDS[i])
            g = g ^ (g >> shift)
            g = g * jnp.uint64(GOLDEN)
            r = _mulhi64(g, bsz).astype(jnp.int32) + off
            m = ftbl[r]  # [B, M, Wf]
            members = m if members is None else (members & m)
        zero = members.dtype.type(0)
        members = jnp.where(mask[:, :, None], members, zero)
        # slice to gs: table_as_u32 pads rows to x4 bytes
        planes = _bit_expand(members, nbits_f)[..., :gs]  # [B, M, gs]
        return None, jnp.sum(planes.astype(jnp.int32), axis=1)

    _, per_group = jax.lax.scan(
        body, None,
        (grp_row_off, grp_bin_size.astype(jnp.uint64),
         grp_shift.astype(jnp.uint64)),
    )  # [G, B, gs]
    counts = jnp.transpose(per_group, (1, 0, 2)).reshape(B, -1)
    counts = jnp.minimum(counts[:, :num_targets], n_hashes[:, None])
    if gated:
        crows = ibf_row_indices(
            hashes, bin_size=coarse_bin_size, hash_functions=coarse_h
        )
        G = grp_row_off.shape[0]
        gcounts = bulk_group_counts(ctbl, crows, mask, num_groups=G)
        nh = n_hashes.astype(jnp.float64)
        cutoff = jnp.maximum(jnp.ceil(nh * rel_cutoff), 1.0).astype(
            jnp.int32
        )
        valid = (n_hashes > 0) & (n_hashes <= hashes_limit)
        surv = (gcounts >= cutoff[:, None]) & valid[:, None]
        gate = jnp.repeat(surv, gs, axis=1)[:, :num_targets]
        counts = jnp.where(gate, counts, 0)
    return counts


class DevicePrunedForest:
    """A merged-bin pruned forest on device (index.pruned.PrunedForest).

    Fast path: :func:`classify_batch_packed_pruned` (the engine
    dispatches it directly). Slow/fallback path: :meth:`counts_gated`
    (probe all groups, same gate). ``mesh`` replicates both tables and
    batch-shards inputs (read data parallelism; bins-axis sharding of
    the grouped layout is future work — the pruned gather is already
    back in the cheap per-probe regime single-chip).
    """

    def __init__(self, pf, device=None, mesh=None):
        from ganon_tpu.ops.ibf_query import clz64

        self.ibf_config = pf.ibf_config
        self.targets = pf.targets()
        self.num_targets = len(self.targets)
        self.target_fpr = pf.target_fpr()
        self.group_size = pf.group_size
        self.fine_h = pf.fine_h
        self.coarse_h = pf.coarse_h
        self.coarse_bin_size = pf.coarse_bin_size
        self.num_groups = pf.num_groups
        self.mesh = mesh
        self.batch_mult = 1 if mesh is None else mesh.shape["batch"]
        # both tables as u32 word views (the flat filter's layout)
        fine = table_as_u32(np.ascontiguousarray(pf.fine))
        coarse = table_as_u32(np.ascontiguousarray(pf.coarse))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            rep = NamedSharding(mesh, P())
            self.ftbl = jax.device_put(fine, rep)
            self.ctbl = jax.device_put(coarse, rep)
        else:
            self.ftbl = jax.device_put(fine)
            self.ctbl = jax.device_put(coarse)
        self.grp_row_off = jnp.asarray(pf.grp_row_off, dtype=jnp.int32)
        self.grp_bin_size = jnp.asarray(pf.grp_bin_size, dtype=jnp.uint32)
        self.grp_shift = jnp.asarray(
            [clz64(int(b)) for b in pf.grp_bin_size], dtype=jnp.uint32
        )
        self.grp_ntargets = jnp.asarray(pf.grp_ntargets, dtype=jnp.int32)

    put_batch = DeviceFilter.put_batch

    def counts_gated(self, hashes, mask, n_hashes, rel_cutoff):
        """Full [B, T] counts under the filter's gated semantics."""
        return _pruned_all_counts(
            self.ftbl, self.ctbl, self.grp_row_off, self.grp_bin_size,
            self.grp_shift, hashes, mask, n_hashes,
            jnp.float64(rel_cutoff), jnp.int32(0x7FFFFFFF),
            fine_h=self.fine_h, group_size=self.group_size,
            num_targets=self.num_targets,
            coarse_bin_size=self.coarse_bin_size, coarse_h=self.coarse_h,
            gated=True,
        )

    def counts(self, hashes, mask, n_hashes):
        """UNgated probe-all counts (diagnostics; the filter's defined
        semantics are the gated ones — see index.pruned)."""
        return _pruned_all_counts(
            self.ftbl, self.ctbl, self.grp_row_off, self.grp_bin_size,
            self.grp_shift, hashes, mask, n_hashes,
            jnp.float64(0.0), jnp.int32(0x7FFFFFFF),
            fine_h=self.fine_h, group_size=self.group_size,
            num_targets=self.num_targets,
            coarse_bin_size=self.coarse_bin_size, coarse_h=self.coarse_h,
            gated=False,
        )


# repeated run_classify calls over the same db (servers, benchmarks, the
# report->reclassify loop) pay filter load + table packing + device
# placement every time otherwise; key on file
# identity so a rebuilt db invalidates
_FILTER_CACHE: dict = {}
_FILTER_CACHE_CAP = 4


def load_device_filter(path: str, mesh=None):
    """Open an .ibf or .hibf file as a device-resident filter.

    ``.hibf`` files are auto-detected: raptor cereal index (the files the
    reference builds through raptor) or our native npz forest. ``mesh``
    shards plain IBFs over a (batch, bins) device mesh (HIBF forests
    stay single-device for now). Loaded filters are memoized on
    (path, mtime_ns, size, mesh) so back-to-back runs skip the load.
    """
    from ganon_tpu.index.ibf import IBF
    from ganon_tpu.index.hibf import HIBF, RaptorHIBF
    from ganon_tpu.index.pruned import PrunedForest, is_pruned_file
    from ganon_tpu.index import serialize

    try:
        st = os.stat(path)
        key = (os.path.abspath(path), st.st_mtime_ns, st.st_size,
               None if mesh is None else tuple(mesh.devices.flat))
    except OSError:
        key = None
    if key is not None and key in _FILTER_CACHE:
        return _FILTER_CACHE[key]

    if path.endswith(".hibf"):
        import zipfile

        if is_pruned_file(path):
            f = DevicePrunedForest(PrunedForest.load(path), mesh=mesh)
        elif not zipfile.is_zipfile(path) and serialize.is_raptor_hibf(
            path
        ):
            f = DeviceRaptorHIBF(RaptorHIBF.load(path), mesh=mesh)
        else:
            f = DeviceHIBF(HIBF.load(path), mesh=mesh)
    else:
        f = DeviceFilter(IBF.load(path), mesh=mesh)
    if key is not None:
        while len(_FILTER_CACHE) >= _FILTER_CACHE_CAP:
            _FILTER_CACHE.pop(next(iter(_FILTER_CACHE)))
        _FILTER_CACHE[key] = f
    return f


def batch_to_device(batch, w: int, batch_pad: int):
    """Pad an EncodedBatch to bucketed static shapes for the device.

    Returns (codes1, len1, codes2|None, len2|None, m1, m2) with the batch
    dimension padded to ``batch_pad`` and read length padded to the next
    bucket (limits distinct compiled shapes).
    """

    def pad(codes, lengths):
        b, L = codes.shape
        Lb = bucket_len(max(L, 1))
        out = np.zeros((batch_pad, Lb), dtype=np.uint8)
        out[:b, :L] = codes
        lens = np.zeros((batch_pad,), dtype=np.int32)
        lens[:b] = lengths
        return out, lens, Lb

    codes1, len1, L1 = pad(batch.codes1, batch.len1)
    m1 = max(L1 - w + 1, 1)
    if batch.paired:
        codes2, len2, L2 = pad(batch.codes2, batch.len2)
        m2 = max(L2 - w + 1, 1)
    else:
        codes2 = len2 = None
        m2 = 0
    return codes1, len1, codes2, len2, m1, m2
