"""Merged-bin pruned forest: a coarse IBF gates a grouped fine table.

This is a batched, branch-free re-expression of the reference HIBF's query
trick — threshold-gated descent into merged bins
(``hierarchical_interleaved_bloom_filter.hpp:432-460``): the reference
only counts a merged bin's child IBF when the merged-bin count reaches
the read's threshold, slashing probed bytes on wide databases. The
pointer-chasing recursion does not batch, so the same gating becomes two
data-parallel stages:

1. **Coarse stage** — targets are partitioned into groups of
   ``group_size`` (count-sorted, so group members have similar sizes);
   one small IBF holds one bin per group containing the union of the
   group's minimizers (a superset Bloom: any hash that hits a member
   target's fine bin with a TRUE hash also hits the group bin, so a
   group whose count is below the read's rel-cutoff threshold cannot
   contain a passing target through true hashes). Bulk-counting it
   costs ``B x M x h_coarse`` probes of ``G/8``-byte rows.
2. **Fine stage** — only the top ``S`` surviving groups per read are
   probed. Every target owns exactly ONE fine bin (per-group bin sizes
   replace the flat IBF's technical-bin splitting), and all groups
   flatten into one ``[sum_g bin_size_g, group_size/8]`` byte matrix;
   a probe's row index is computed with the group's own
   ``(bin_size, shift, row_offset)`` gathered per slot — dynamic
   fastrange, all vector ALU. Probed bytes drop from the full table
   width to ``S x group_size/8`` per probe.

Semantics (the reference's, by design): a target is reported only when
BOTH its fine count and its group's coarse count reach the read's
rel-cutoff threshold — "prune-only": gating can drop false-positive-only
borderline matches whose hashes are not in the coarse union, exactly
like the reference's non-descent, and can never add matches. The
probe-all fallback (``DevicePrunedForest.counts_gated``) applies the
same gate, so fast path and fallback are bit-identical.

File format (``.hibf``): npz with a JSON header (magic
``ganon-tpu-pruned-v1``) or the raw mmap-able container.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ganon_tpu.index.config import IBFConfig
from ganon_tpu.index.sizing import bin_size_fp_hf, false_positive
from ganon_tpu.ops.ibf_query import ibf_row_indices_np

MAGIC = "ganon-tpu-pruned-v1"
RAW_MAGIC = b"GANON-TPU-PRUNED-RAW1\n"


def _scatter_or_u8(table: np.ndarray, rows: np.ndarray, bits: np.ndarray):
    """OR bit ``bits[i]`` of row ``rows[i]`` into a u8 [R, W] matrix.

    Sort-and-reduce (like ibf._scatter_bits) — orders of magnitude
    faster than ``np.bitwise_or.at`` for tens of millions of inserts.
    """
    W = table.shape[1]
    widx = rows.astype(np.int64) * W + (bits >> 3).astype(np.int64)
    mask = (np.uint8(1) << (bits & 7).astype(np.uint8)).astype(np.uint8)
    order = np.argsort(widx, kind="stable")
    widx = widx[order]
    mask = mask[order]
    boundaries = np.flatnonzero(np.r_[True, widx[1:] != widx[:-1]])
    merged = np.bitwise_or.reduceat(mask, boundaries)
    flat = table.reshape(-1)
    flat[widx[boundaries]] |= merged


class PrunedForest:
    """Grouped one-bin-per-target fine table + coarse merged-bin IBF."""

    hashes_count_is_estimate = False

    def __init__(
        self,
        fine: np.ndarray,          # u8 [R_total, group_size // 8]
        coarse: np.ndarray,        # u8 [coarse_bin_size, ceil(G/8)]
        *,
        targets: list[str],        # count-sorted canonical order
        hashes_count: dict[str, int],
        grp_bin_size: np.ndarray,  # int64 [G]
        grp_row_off: np.ndarray,   # int64 [G]
        grp_ntargets: np.ndarray,  # int32 [G]
        group_size: int,
        coarse_bin_size: int,
        kmer_size: int,
        window_size: int,
        max_fp: float,
        fine_h: int,
        coarse_fp: float,
        coarse_h: int,
    ):
        self.fine = fine
        self.coarse = coarse
        self._targets = list(targets)
        self.hashes_count = dict(hashes_count)
        self.grp_bin_size = np.asarray(grp_bin_size, dtype=np.int64)
        self.grp_row_off = np.asarray(grp_row_off, dtype=np.int64)
        self.grp_ntargets = np.asarray(grp_ntargets, dtype=np.int32)
        self.group_size = int(group_size)
        self.coarse_bin_size = int(coarse_bin_size)
        self.max_fp = float(max_fp)
        self.fine_h = int(fine_h)
        self.coarse_fp = float(coarse_fp)
        self.coarse_h = int(coarse_h)
        fprs = self.target_fpr()
        self.ibf_config = IBFConfig(
            kmer_size=kmer_size,
            window_size=window_size,
            max_fp=max_fp,
            n_bins=len(targets),
            # one bin per target: max_hashes_bin never splits
            max_hashes_bin=max(hashes_count.values(), default=1),
            hash_functions=fine_h,
            bin_size_bits=int(self.grp_bin_size.max(initial=1)),
            true_max_fp=max(fprs.values(), default=0.0),
            true_avg_fp=(
                sum(fprs.values()) / len(fprs) if fprs else 0.0
            ),
        )

    @property
    def num_groups(self) -> int:
        return len(self.grp_bin_size)

    def targets(self) -> list[str]:
        return list(self._targets)

    def target_fpr(self) -> dict[str, float]:
        """Per-target achieved fp: single fine bin, direct formula."""
        out = {}
        for gi in range(len(self.grp_bin_size)):
            bsz = int(self.grp_bin_size[gi])
            for j in range(int(self.grp_ntargets[gi])):
                t = self._targets[gi * self.group_size + j]
                out[t] = false_positive(bsz, self.fine_h,
                                        self.hashes_count[t])
        return out

    def group_of(self, target: str) -> int:
        return self._targets.index(target) // self.group_size

    # --- persistence -------------------------------------------------------

    def _header(self) -> dict:
        return {
            "magic": MAGIC,
            "kmer_size": self.ibf_config.kmer_size,
            "window_size": self.ibf_config.window_size,
            "max_fp": self.max_fp,
            "fine_h": self.fine_h,
            "coarse_fp": self.coarse_fp,
            "coarse_h": self.coarse_h,
            "group_size": self.group_size,
            "coarse_bin_size": self.coarse_bin_size,
            "targets": self._targets,
            "hashes_count": [self.hashes_count[t] for t in self._targets],
            "grp_bin_size": self.grp_bin_size.tolist(),
            "grp_row_off": self.grp_row_off.tolist(),
            "grp_ntargets": self.grp_ntargets.tolist(),
        }

    def save(self, path: str) -> None:
        arrays = {
            "header": np.frombuffer(
                json.dumps(self._header()).encode(), dtype=np.uint8
            ),
            "fine": self.fine,
            "coarse": self.coarse,
        }
        np.savez_compressed(path + ".tmp.npz", **arrays)
        os.replace(path + ".tmp.npz", path)

    def save_raw(self, path: str) -> None:
        """mmap-able container (``--filter-format tpu-raw``); load time
        independent of table size (see IBF.save_raw for rationale)."""
        header = self._header()
        header["magic"] = MAGIC + "-raw"
        header["fine_shape"] = list(self.fine.shape)
        header["coarse_shape"] = list(self.coarse.shape)
        blob = json.dumps(header).encode()
        with open(path + ".tmp", "wb") as f:
            f.write(RAW_MAGIC)
            f.write(len(blob).to_bytes(8, "little"))
            f.write(blob)
            f.write(b"\0" * (-f.tell() % 4096))
            f.write(np.ascontiguousarray(self.fine).tobytes())
            f.write(b"\0" * (-f.tell() % 4096))
            f.write(np.ascontiguousarray(self.coarse).tobytes())
        os.replace(path + ".tmp", path)

    @classmethod
    def _from_header(cls, header, fine, coarse) -> "PrunedForest":
        return cls(
            fine, coarse,
            targets=header["targets"],
            hashes_count=dict(
                zip(header["targets"], header["hashes_count"])
            ),
            grp_bin_size=np.asarray(header["grp_bin_size"], np.int64),
            grp_row_off=np.asarray(header["grp_row_off"], np.int64),
            grp_ntargets=np.asarray(header["grp_ntargets"], np.int32),
            group_size=header["group_size"],
            coarse_bin_size=header["coarse_bin_size"],
            kmer_size=header["kmer_size"],
            window_size=header["window_size"],
            max_fp=header["max_fp"],
            fine_h=header["fine_h"],
            coarse_fp=header["coarse_fp"],
            coarse_h=header["coarse_h"],
        )

    @classmethod
    def load(cls, path: str) -> "PrunedForest":
        import zipfile

        if not zipfile.is_zipfile(path):
            with open(path, "rb") as f:
                if f.read(len(RAW_MAGIC)) != RAW_MAGIC:
                    raise ValueError(f"not a ganon-tpu pruned file: {path}")
                hlen = int.from_bytes(f.read(8), "little")
                header = json.loads(f.read(hlen).decode())
                off = len(RAW_MAGIC) + 8 + hlen
                off += -off % 4096
            fine = np.memmap(path, mode="r", dtype=np.uint8, offset=off,
                             shape=tuple(header["fine_shape"]))
            off2 = off + fine.size
            off2 += -off2 % 4096
            coarse = np.memmap(path, mode="r", dtype=np.uint8, offset=off2,
                               shape=tuple(header["coarse_shape"]))
            return cls._from_header(header, fine, coarse)
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("magic") != MAGIC:
                raise ValueError(f"not a ganon-tpu pruned file: {path}")
            return cls._from_header(header, z["fine"], z["coarse"])


def is_pruned_file(path: str) -> bool:
    """Sniff a ``.hibf`` path for the pruned container (npz or raw)."""
    import zipfile

    try:
        with open(path, "rb") as f:
            if f.read(len(RAW_MAGIC)) == RAW_MAGIC:
                return True
        if not zipfile.is_zipfile(path):
            return False
        with np.load(path, allow_pickle=False) as z:
            if "header" not in z:
                return False
            header = json.loads(bytes(z["header"].tobytes()).decode())
            return header.get("magic") == MAGIC
    except Exception:
        return False


_pruned_scatter_step = None


def _pruned_scatter_jit():
    """Jitted device scatter-OR for the pruned tables (built once).

    The IBF scatter (`ibf._scatter_chunk_jit`) computes row indices
    with a STATIC bin size; the pruned fine table has a bin size PER
    GROUP, so rows come from the dynamic fastrange (the same per-slot
    math the query kernel uses) with per-hash ``(bin_size, shift,
    row_off, bit)`` arrays. The sort/dedup/scatter tail is the same
    pattern. ``fine_h`` static; the coarse table is built by
    the same program with per-hash params all equal.
    """
    import jax
    import jax.numpy as jnp
    from functools import partial

    from ganon_tpu.ops.ibf_query import GOLDEN, HASH_SEEDS, _mulhi64

    @partial(
        jax.jit,
        donate_argnums=(0,),
        static_argnames=("fine_h", "row_bits"),
    )
    def step(bits, hashes, bsz, shift, row_off, bit, n_valid, *,
             fine_h: int, row_bits: int):
        rb = jnp.uint64(row_bits)
        valid = jnp.arange(hashes.shape[0], dtype=jnp.int32) < n_valid
        total = jnp.uint64(bits.size * 32)
        bidxs = []
        for i in range(fine_h):
            g = hashes * jnp.uint64(HASH_SEEDS[i])
            g = g ^ (g >> shift.astype(jnp.uint64))
            g = g * jnp.uint64(GOLDEN)
            row = _mulhi64(g, bsz.astype(jnp.uint64)) + row_off.astype(
                jnp.uint64
            )
            bidx = row * rb + bit.astype(jnp.uint64)
            bidxs.append(jnp.where(valid, bidx, total))
        bidx = jnp.stack(bidxs, axis=1).reshape(-1)
        hi = (bidx >> jnp.uint64(32)).astype(jnp.uint32)
        lo = bidx.astype(jnp.uint32)
        hi_s, lo_s = jax.lax.sort((hi, lo), num_keys=2)
        first = jnp.concatenate(
            [
                jnp.ones((1,), dtype=bool),
                (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1]),
            ]
        )
        sbidx = (
            (hi_s.astype(jnp.uint64) << jnp.uint64(32))
            | lo_s.astype(jnp.uint64)
        )
        uniq = first & (sbidx < total)
        word = (sbidx >> jnp.uint64(5)).astype(jnp.int64)
        payload = jnp.where(
            uniq,
            jnp.uint32(1) << (sbidx & jnp.uint64(31)).astype(jnp.uint32),
            jnp.uint32(0),
        )
        delta = jnp.zeros(bits.size, dtype=jnp.uint32)
        delta = delta.at[word].add(
            payload, indices_are_sorted=True, mode="drop"
        )
        return bits | delta.reshape(bits.shape)

    return step


def _device_scatter_table(rows_total: int, width_bytes: int, chunks,
                          fine_h: int) -> np.ndarray:
    """Device-build a [rows_total, width_bytes] u8 bit table.

    ``chunks`` yields (hashes u64, bsz, shift, row_off, bit) arrays of
    equal length; sizes are padded to power-of-two buckets to bound
    compiled shapes. Returns the u8 table (little-endian bit order, the
    query layout)."""
    global _pruned_scatter_step
    import jax.numpy as jnp

    if _pruned_scatter_step is None:
        _pruned_scatter_step = _pruned_scatter_jit()
    row_bits = width_bytes * 8
    words = rows_total * width_bytes // 4
    assert (rows_total * width_bytes) % 4 == 0
    bits = jnp.zeros((words,), dtype=jnp.uint32)
    for hashes, bsz, shift, row_off, bit in chunks:
        n = len(hashes)
        if not n:
            continue
        cap = 1024
        while cap < n:
            cap *= 2
        if cap != n:
            pad = (0, cap - n)
            hashes = np.pad(hashes, pad)
            bsz = np.pad(bsz, pad, constant_values=1)
            shift = np.pad(shift, pad, constant_values=63)
            row_off = np.pad(row_off, pad)
            bit = np.pad(bit, pad)
        bits = _pruned_scatter_step(
            bits, jnp.asarray(hashes, dtype=jnp.uint64),
            jnp.asarray(bsz, dtype=jnp.uint32),
            jnp.asarray(shift, dtype=jnp.uint32),
            jnp.asarray(row_off, dtype=jnp.uint32),
            jnp.asarray(bit, dtype=jnp.uint32),
            jnp.int32(n), fine_h=fine_h, row_bits=row_bits,
        )
    return (
        np.ascontiguousarray(np.asarray(bits))
        .view(np.uint8)
        .reshape(rows_total, width_bytes)
    )


def build_pruned(
    target_hashes: dict[str, np.ndarray],
    *,
    kmer_size: int,
    window_size: int,
    max_fp: float = 0.05,
    fine_h: int = 1,
    coarse_fp: float = 0.1,
    coarse_h: int = 1,
    group_size: int = 64,
    device: bool | None = None,
) -> PrunedForest:
    """Build the pruned forest from per-target distinct-minimizer arrays.

    Targets sort by hash count descending (stable), so groups hold
    similar-sized targets and per-group bin sizes waste little space —
    the role the reference's DP layout (raptor) plays for merged bins.
    The defaults are database-format values: ``fine_h=1`` and
    ``coarse_h=1`` (one probe per hash per table) and ``coarse_fp=0.1``,
    which keeps the coarse table small while the threshold gating
    crushes group-level fp (a group survives only when >= cutoff of the
    read's hashes hit — a binomial tail, not a per-hash fp).

    ``device``: build the bit tables with the jitted sort-scatter (the
    same machinery as the flat IBF build — chunked uploads, dedup and
    scatter-OR all on the device) instead of the host numpy scatter.
    Both paths produce IDENTICAL tables (same insert set; OR is
    idempotent). Default: the device path whenever the build runs on
    an accelerator (``builder._use_device_pipeline``), as the flat
    build does. The coarse bin is sized by the SUM of member counts — a
    safe upper bound on the union size (over-sizing only lowers the
    coarse fp) that avoids materializing per-group unions entirely.
    """
    if not target_hashes:
        raise ValueError("no targets to build")
    names = list(target_hashes.keys())
    counts = np.asarray([len(target_hashes[t]) for t in names])
    order = np.argsort(-counts, kind="stable")
    targets = [names[i] for i in order]
    hashes_count = {t: int(len(target_hashes[t])) for t in targets}

    G = -(-len(targets) // group_size)
    grp_bin_size = np.empty(G, dtype=np.int64)
    grp_ntargets = np.empty(G, dtype=np.int32)
    grp_sum = np.empty(G, dtype=np.int64)
    for g in range(G):
        members = targets[g * group_size:(g + 1) * group_size]
        grp_ntargets[g] = len(members)
        mx = max(1, max(hashes_count[t] for t in members))
        grp_bin_size[g] = max(64, bin_size_fp_hf(max_fp, mx, fine_h))
        grp_sum[g] = sum(hashes_count[t] for t in members)
    grp_row_off = np.concatenate([[0], np.cumsum(grp_bin_size)[:-1]])
    R_total = int(grp_bin_size.sum())
    Wf = group_size // 8
    if group_size % 8:
        raise ValueError("group_size must be a multiple of 8")
    coarse_bin_size = max(
        64, bin_size_fp_hf(coarse_fp, max(1, int(grp_sum.max())), coarse_h)
    )
    # u32-word alignment for the device scatter's flat bit array
    coarse_bin_size += -coarse_bin_size % 32
    Wc = -(-G // 8)
    if device is None:
        from ganon_tpu.index.builder import _use_device_pipeline

        device = _use_device_pipeline()

    def member_stream():
        """(group, local_idx, hashes) per target, group-major."""
        for g in range(G):
            members = targets[g * group_size:(g + 1) * group_size]
            for j, t in enumerate(members):
                yield g, j, np.asarray(target_hashes[t], dtype=np.uint64)

    if device:
        def chunks(coarse_pass: bool):
            CH = 4 << 20
            acc = {k: [] for k in ("h", "b", "s", "o", "bit")}
            n = 0
            from ganon_tpu.ops.ibf_query import clz64

            for g, j, hs in member_stream():
                if not len(hs):
                    continue
                acc["h"].append(hs)
                if coarse_pass:
                    acc["b"].append(np.full(len(hs), coarse_bin_size,
                                            np.uint32))
                    acc["s"].append(np.full(len(hs),
                                            clz64(coarse_bin_size),
                                            np.uint32))
                    acc["o"].append(np.zeros(len(hs), np.uint32))
                    acc["bit"].append(np.full(len(hs), g, np.uint32))
                else:
                    acc["b"].append(np.full(len(hs), grp_bin_size[g],
                                            np.uint32))
                    acc["s"].append(np.full(len(hs),
                                            clz64(int(grp_bin_size[g])),
                                            np.uint32))
                    acc["o"].append(np.full(len(hs), grp_row_off[g],
                                            np.uint32))
                    acc["bit"].append(np.full(len(hs), j, np.uint32))
                n += len(hs)
                if n >= CH:
                    yield tuple(np.concatenate(acc[k]) for k in
                                ("h", "b", "s", "o", "bit"))
                    acc = {k: [] for k in acc}
                    n = 0
            if n:
                yield tuple(np.concatenate(acc[k]) for k in
                            ("h", "b", "s", "o", "bit"))

        # widths pad to x4 bytes for the u32 flat bit array (the bit
        # indices in chunks() use the PADDED row width via row_bits)
        fine = _device_scatter_table(
            R_total, Wf + (-Wf % 4), chunks(False), fine_h
        )[:, :Wf]
        coarse = _device_scatter_table(
            coarse_bin_size, Wc + (-Wc % 4), chunks(True), coarse_h
        )[:, :Wc]
    else:
        fine = np.zeros((R_total, Wf), dtype=np.uint8)
        coarse = np.zeros((coarse_bin_size, Wc), dtype=np.uint8)
        for g, j, hs in member_stream():
            if not len(hs):
                continue
            rows = ibf_row_indices_np(
                hs, bin_size=int(grp_bin_size[g]), hash_functions=fine_h
            ) + int(grp_row_off[g])
            _scatter_or_u8(
                fine, rows.reshape(-1),
                np.full(rows.size, j, dtype=np.int64),
            )
            crows = ibf_row_indices_np(
                hs, bin_size=coarse_bin_size, hash_functions=coarse_h
            )
            _scatter_or_u8(
                coarse, crows.reshape(-1),
                np.full(crows.size, g, dtype=np.int64),
            )

    return PrunedForest(
        fine, coarse,
        targets=targets, hashes_count=hashes_count,
        grp_bin_size=grp_bin_size, grp_row_off=grp_row_off,
        grp_ntargets=grp_ntargets, group_size=group_size,
        coarse_bin_size=coarse_bin_size,
        kmer_size=kmer_size, window_size=window_size, max_fp=max_fp,
        fine_h=fine_h, coarse_fp=coarse_fp, coarse_h=coarse_h,
    )
