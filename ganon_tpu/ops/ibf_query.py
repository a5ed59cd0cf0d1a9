"""Interleaved Bloom filter bit-matrix: hash family and bulk-count query.

The IBF is a dense bit-matrix ``[bin_size_bits rows x technical_bins cols]``
held as ``uint32[bin_size, n_words]`` (bin ``b`` lives in word ``b // 32``,
bit ``b % 32``; ``technical_bins = 32 * n_words`` is the 64-padded bin
count). This maps directly onto device memory and lets a read's whole hash
set query every bin with gathers + bitwise AND + bit-plane accumulation.

Hash family (seqan3-style multiply/xor-shift/multiply + fastrange; build and
query must agree — membership semantics only depend on this file):

    g  = ((h * seed_i) ^ ((h * seed_i) >> hash_shift)) * GOLDEN   (mod 2^64)
    row = mulhi64(g, bin_size)          # fastrange to [0, bin_size)

with ``hash_shift = clz64(bin_size)``. Functional equivalent of the seqan3
IBF used by the reference (``GanonBuild.cpp:694``, ``GanonClassify.cpp:514``);
cross-loading reference ``.ibf`` files additionally requires byte-level
cereal parsing (see ganon_tpu.index.serialize).

Bulk count (reference semantics ``GanonClassify.cpp:504-541``): per read,
``counts[bin] = #hashes whose g-rows are all set for that bin``; per-target
counts sum the target's technical bins and clamp at ``n_hashes``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# 2^64 / golden ratio — spreads the xor-folded value over the full range.
GOLDEN = 0x9E3779B97F4A7C15
# seqan3 IBF hash seeds (fixed family constants, max 5 hash functions)
HASH_SEEDS = (
    13572355802537770549,  # 2**64 / (e/2)
    13043817825332782213,  # 2**64 / sqrt(2)
    10650232656628343401,  # 2**64 / sqrt(5)
    16499269484942379435,  # 2**64 / (sqrt(3)/2)
    4893150838803335377,  # 2**64 / (3/(2*sqrt(e)))
)
MAX_HASH_FUNCTIONS = 5


def clz64(x: int) -> int:
    """Count leading zeros of a 64-bit value (host-side, static)."""
    assert 0 < x < 1 << 64
    return 64 - x.bit_length()


def _mulhi64(a, b):
    """High 64 bits of a 64x64 multiply, via 32-bit limbs (u64 lanes)."""
    m32 = jnp.uint64(0xFFFFFFFF)
    s32 = jnp.uint64(32)
    ah, al = a >> s32, a & m32
    bh, bl = b >> s32, b & m32
    lo = al * bl
    m1 = ah * bl
    m2 = al * bh
    carry = ((lo >> s32) + (m1 & m32) + (m2 & m32)) >> s32
    return ah * bh + (m1 >> s32) + (m2 >> s32) + carry


@partial(jax.jit, static_argnames=("bin_size", "hash_functions"))
def ibf_row_indices(hashes, *, bin_size: int, hash_functions: int):
    """Row indices into the bit-matrix for each hash and hash function.

    Args:
      hashes: uint64 ``[...,]`` minimizer values.
      bin_size: rows in the bit-matrix (static).
      hash_functions: number of hash functions 1..5 (static).

    Returns int32 ``[..., hash_functions]`` row indices in [0, bin_size).
    """
    shift = jnp.uint64(clz64(bin_size))
    bsz = jnp.uint64(bin_size)
    rows = []
    for i in range(hash_functions):
        g = hashes * jnp.uint64(HASH_SEEDS[i])
        g = g ^ (g >> shift)
        g = g * jnp.uint64(GOLDEN)
        rows.append(_mulhi64(g, bsz))
    return jnp.stack(rows, axis=-1).astype(jnp.int32)


def ibf_row_indices_np(hashes: np.ndarray, *, bin_size: int, hash_functions: int):
    """NumPy twin of :func:`ibf_row_indices` (used by the host-side builder)."""
    h = hashes.astype(np.uint64)
    shift = np.uint64(clz64(bin_size))
    rows = np.empty(h.shape + (hash_functions,), dtype=np.int64)
    with np.errstate(over="ignore"):
        for i in range(hash_functions):
            g = h * np.uint64(HASH_SEEDS[i])
            g = g ^ (g >> shift)
            g = g * np.uint64(GOLDEN)
            # mulhi via 32-bit limbs
            m32 = np.uint64(0xFFFFFFFF)
            s32 = np.uint64(32)
            ah, al = g >> s32, g & m32
            b = np.uint64(bin_size)
            bh, bl = b >> s32, b & m32
            lo = al * bl
            m1 = ah * bl
            m2 = al * bh
            carry = ((lo >> s32) + (m1 & m32) + (m2 & m32)) >> s32
            rows[..., i] = (ah * bh + (m1 >> s32) + (m2 >> s32) + carry).astype(
                np.int64
            )
    return rows


@jax.jit
def bulk_count_bins(bits, rows, hash_mask):
    """Per-bin hash hit counts for a batch of reads.

    Args:
      bits: uint32 ``[bin_size, n_words]`` IBF bit-matrix.
      rows: int32 ``[B, M, S]`` row indices (S = hash functions).
      hash_mask: bool ``[B, M]`` valid-hash mask (padding excluded).

    Returns int32 ``[B, technical_bins]`` counts (one per hash occurrence
    whose S rows are all set for the bin).
    """
    n_words = bits.shape[1]
    member = bits[rows[:, :, 0]]  # [B, M, W]
    for s in range(1, rows.shape[2]):
        member = member & bits[rows[:, :, s]]
    member = jnp.where(hash_mask[:, :, None], member, jnp.uint32(0))  # [B, M, W]
    # bit-plane accumulation: counts[b, w*32 + bit] = sum_m (member >> bit) & 1
    shifts = jnp.arange(32, dtype=jnp.uint32)
    planes = (member[:, :, :, None] >> shifts) & jnp.uint32(1)  # [B, M, W, 32]
    counts = jnp.sum(planes.astype(jnp.int32), axis=1)  # [B, W, 32]
    return counts.reshape(counts.shape[0], n_words * 32)


@partial(jax.jit, static_argnames=("num_targets",))
def target_counts(bin_counts, bin_to_target, *, num_targets: int):
    """Sum technical-bin counts into per-target counts (one-hot matmul).

    Args:
      bin_counts: int32 ``[B, technical_bins]``.
      bin_to_target: int32 ``[technical_bins]`` target id per bin
        (``num_targets`` for padding bins).
      num_targets: static target count T.

    Returns int32 ``[B, T]``. Exact: counts are < 2^24 and the dot runs
    at ``Precision.HIGHEST`` (full f32; a TF32 or bf16 pass would round
    counts above 2^11 or 2^8).
    """
    onehot = jax.nn.one_hot(bin_to_target, num_targets + 1, dtype=jnp.float32)
    out = jnp.dot(
        bin_counts.astype(jnp.float32),
        onehot,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, :num_targets].astype(jnp.int32)


def pack_table_u8(bits: np.ndarray, bin_to_target: np.ndarray,
                  num_targets: int, row_chunk: int = 4096):
    """Repack the interleaved bit-matrix into the byte-aligned query layout.

    Layout: ``uint8[bin_size, W8]`` with every target's technical bins
    moved to a byte-aligned contiguous range (padding bins are zero).
    Byte alignment lets the query path count hits with byte popcounts +
    one segment sum instead of expanding 32 bit-planes per word. The
    device holds it as the :func:`table_as_u32` word view.
    Returns ``(tbl8, byte_starts, byte_ends)`` with int32 [T] byte ranges.

    The on-disk format keeps the compact interleaved u32 layout
    (reference-equivalent contents); this expansion costs at most 7
    padding bins per target and happens once at load.
    """
    b2t = np.asarray(bin_to_target)
    R = bits.shape[0]
    order = np.argsort(b2t, kind="stable")
    sorted_t = b2t[order]
    starts = np.searchsorted(sorted_t, np.arange(num_targets), side="left")
    ends = np.searchsorted(sorted_t, np.arange(num_targets), side="right")
    widths = ends - starts
    pad_w = (widths + 7) // 8 * 8
    pstarts = np.concatenate([[0], np.cumsum(pad_w)[:-1]])
    TBP = int(np.sum(pad_w))
    W8 = max(TBP // 8, 1)

    # destination bit position for every real source bin; real bins sort
    # before padding bins (id == num_targets), so they occupy [0, n_real)
    n_real = int(widths.sum())
    src_bins = order[:n_real]
    local = np.arange(n_real, dtype=np.int64) - np.repeat(starts, widths)
    dst_bits = np.repeat(pstarts, widths) + local

    tbl8 = np.zeros((R, W8), dtype=np.uint8)
    for r0 in range(0, R, row_chunk):
        r1 = min(r0 + row_chunk, R)
        chunk_bytes = bits[r0:r1].view(np.uint8).reshape(r1 - r0, -1)
        unpacked = np.unpackbits(chunk_bytes, axis=1, bitorder="little")
        out = np.zeros((r1 - r0, W8 * 8), dtype=np.uint8)
        out[:, dst_bits] = unpacked[:, src_bins]
        tbl8[r0:r1] = np.packbits(out, axis=1, bitorder="little")
    byte_starts = (pstarts // 8).astype(np.int32)
    byte_ends = ((pstarts + pad_w) // 8).astype(np.int32)
    return tbl8, byte_starts, byte_ends


def table_as_u32(tbl8: np.ndarray) -> np.ndarray:
    """View the u8 query table as little-endian u32 words (pads W8 to x4).

    Same bytes, same target byte ranges; the gather fetches a row in a
    quarter of the elements. This is the one device layout: on an H100
    the u32 gather beat the u8 gather at every table size measured,
    27 MB to 2.1 GB (PERF.md, "Findings").
    """
    R, W8 = tbl8.shape
    W8p = -(-W8 // 4) * 4
    if W8p != W8:
        tbl8 = np.pad(tbl8, ((0, 0), (0, W8p - W8)))
    return np.ascontiguousarray(tbl8).view(np.uint32)


def _popcount_u32_bytelanes(x):
    """Per-byte popcounts kept in their byte lanes (SWAR, no fold)."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    return (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)


@jax.jit
def bulk_target_counts_packed(tbl32, rows, hash_mask, byte_starts,
                              byte_ends):
    """Per-target counts on the byte-aligned table's u32 word view.

    ``counts[b, t] = sum_m popcount(AND_s tbl8[rows[b,m,s],
    byte_starts[t]:byte_ends[t]])`` with ``tbl32 = table_as_u32(tbl8)``:
    the AND runs on u32 words, per-byte popcounts stay in their byte
    lanes, and the little-endian byte unpack restores byte order so
    ``byte_starts``/``byte_ends`` apply unchanged. One gather per hash
    function, ANDed pairwise.
    """
    member = tbl32[rows[:, :, 0]]  # [B, M, W]
    for s in range(1, rows.shape[2]):
        member = member & tbl32[rows[:, :, s]]
    member = jnp.where(hash_mask[:, :, None], member, jnp.uint32(0))
    pc = _popcount_u32_bytelanes(member)  # [B, M, W] 4 lanes/word
    # lane-safe grouped accumulation: per-byte popcounts (each <= 8) sum
    # to G*8 = 128 without carrying across byte lanes, so groups of G
    # hashes reduce in u32 before the 4x int32 lane expansion (G-fold
    # less data through the expand + sum)
    B, M, W = pc.shape
    G = 16
    Mp = -(-M // G) * G
    if Mp != M:
        pc = jnp.pad(pc, ((0, 0), (0, Mp - M), (0, 0)))
    grp = jnp.sum(
        pc.reshape(B, Mp // G, G, W), axis=2, dtype=jnp.uint32
    )  # [B, Gn, W] byte-lane partial sums
    shifts = jnp.arange(4, dtype=jnp.uint32) * jnp.uint32(8)
    pcb = ((grp[:, :, :, None] >> shifts) & jnp.uint32(0xFF)).astype(
        jnp.int32
    )  # [B, Gn, W, 4] little-endian byte order = tbl8 byte order
    cw = jnp.sum(pcb, axis=1).reshape(B, -1)  # [B, W8p]
    return _segment_matmul(cw, byte_starts, byte_ends,
                           max_val=8 * rows.shape[1])


def _segment_matmul(cw, byte_starts, byte_ends, max_val: int = 65535 * 8):
    """Per-target segment sum of per-byte counts as a matmul.

    ``counts[b, t] = sum_{bs[t] <= w < be[t]} cw[b, w]``. The one-hot
    segment matrix is built in-kernel from the byte ranges and fuses
    away.

    Exactness without a full-f32 dot: ``cw`` is split into base-256
    digits with one bf16 dot per digit. Digits <= 255 and the 0/1
    segment matrix are exact in bf16, the products accumulate in f32
    (``preferred_element_type``; exact for integer sums < 2^24, guarded
    below), and the int32 recombination is exact because each digit's
    scaled contribution is bounded by the true count. ``max_val`` bounds
    cw (callers pass 8 * hash-axis length): short reads need 2 digits,
    reads with more than 8,192 compacted hashes 3.
    """
    W8 = cw.shape[1]
    w_idx = jnp.arange(W8, dtype=jnp.int32)[:, None]  # [W8, 1]
    segb = (w_idx >= byte_starts[None, :]) & (w_idx < byte_ends[None, :])
    if 255 * W8 >= 1 << 24:  # f32 accumulation exactness bound
        out = jnp.dot(
            cw.astype(jnp.float32),
            segb.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return out.astype(jnp.int32)
    seg = segb.astype(jnp.bfloat16)  # [W8, T]
    n_digits = max(1, (int(max_val).bit_length() + 7) // 8)
    out = jnp.zeros((cw.shape[0], seg.shape[1]), dtype=jnp.int32)
    for d in range(n_digits):
        dig = ((cw >> (8 * d)) & 0xFF).astype(jnp.bfloat16)
        part = jnp.dot(dig, seg, preferred_element_type=jnp.float32)
        out = out + (part.astype(jnp.int32) << (8 * d))
    return out


@partial(jax.jit, static_argnames=("max_compact",))
def compact_hashes(hashes, mask, *, max_compact: int):
    """Compact emitted hashes to the first ``max_compact`` slots per read.

    The minimizer view leaves emitted values scattered across window
    positions (~1/7 density for k=19, w=31); compaction cuts the table
    gather — the classify bottleneck — by ~4x.

    Implemented as a stable partition via ``lax.sort`` (key = position,
    emitted positions keyed first) carrying the hash as two u32 payload
    planes. The sort network is pure compare/select — no gather — so its
    cost does not depend on the layout XLA picks for the minimizer
    pipeline, as a take_along_axis gather's would.

    Returns ``(hashes [B, max_compact], mask [B, max_compact],
    overflow bool [B])``; ``overflow`` marks reads with more emissions
    than ``max_compact`` (caller must fall back to the uncompacted path
    to keep counts exact).
    """
    M = hashes.shape[1]
    n = jnp.sum(mask.astype(jnp.int32), axis=1)
    pos = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[None, :], mask.shape)
    key = jnp.where(mask, pos, pos + M)
    lo = hashes.astype(jnp.uint32)
    hi = (hashes >> jnp.uint64(32)).astype(jnp.uint32)
    _, lo_s, hi_s = jax.lax.sort(
        (key, lo, hi), dimension=1, num_keys=1, is_stable=False
    )
    take = min(max_compact, M)
    hc = lo_s[:, :take].astype(jnp.uint64) | (
        hi_s[:, :take].astype(jnp.uint64) << jnp.uint64(32)
    )
    if take < max_compact:
        hc = jnp.pad(hc, ((0, 0), (0, max_compact - take)))
    mc = jnp.arange(max_compact, dtype=jnp.int32)[None, :] < n[:, None]
    hc = jnp.where(mc, hc, jnp.uint64(0))
    return hc, mc, n > max_compact


def target_segments(bin_to_target: np.ndarray, num_targets: int):
    """Static (perm, starts, ends) for the segment-sum target reduction.

    ``perm`` reorders technical bins so every target's bins are contiguous
    (identity → None; our builder always lays targets out contiguously,
    sizing.split_target_bins). ``starts``/``ends`` are int32 [T] indices
    into the inclusive-prefix-sum axis: target t owns permuted bins
    [starts[t], ends[t]).
    """
    b2t = np.asarray(bin_to_target)
    order = np.argsort(b2t, kind="stable")
    perm = None if np.array_equal(order, np.arange(len(b2t))) else order
    sorted_t = b2t[order]
    starts = np.searchsorted(sorted_t, np.arange(num_targets), side="left")
    ends = np.searchsorted(sorted_t, np.arange(num_targets), side="right")
    return perm, starts.astype(np.int32), ends.astype(np.int32)


@jax.jit
def bulk_target_counts(bits, rows, hash_mask, starts, ends, perm=None):
    """Per-target hash hit counts: gather + AND + plane-sum + cumsum segsum.

    Semantics identical to ``target_counts(bulk_count_bins(...))``
    (reference bulk_count + per-target technical-bin sum,
    GanonClassify.cpp:504-541) but with the target reduction as a prefix
    sum over the bin axis instead of a one-hot matmul — the per-target sum
    is a segmented reduction over contiguous bins.

    Args:
      bits: uint32 ``[bin_size, n_words]``.
      rows: int32 ``[B, M, S]`` row indices.
      hash_mask: bool ``[B, M]``.
      starts/ends: int32 ``[T]`` contiguous permuted-bin ranges per target.
      perm: optional int32 ``[technical_bins]`` bin permutation.

    Returns int32 ``[B, T]``.
    """
    n_words = bits.shape[1]
    member = bits[rows[:, :, 0]]  # [B, M, W]
    for s in range(1, rows.shape[2]):
        member = member & bits[rows[:, :, s]]
    member = jnp.where(hash_mask[:, :, None], member, jnp.uint32(0))
    shifts = jnp.arange(32, dtype=jnp.uint32)
    planes = ((member[:, :, :, None] >> shifts) & jnp.uint32(1)).astype(
        jnp.int32
    )
    cb = jnp.sum(planes, axis=1).reshape(planes.shape[0], n_words * 32)
    if perm is not None:
        cb = cb[:, perm]
    cs = jnp.cumsum(cb, axis=1)
    zeros = jnp.zeros((cs.shape[0], 1), cs.dtype)
    cs = jnp.concatenate([zeros, cs], axis=1)  # exclusive prefix [B, TB+1]
    return cs[:, ends] - cs[:, starts]
