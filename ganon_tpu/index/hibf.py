"""Hierarchical/size-stratified IBF: variable bin sizes per target class.

The reference delegates HIBF construction to raptor (DP layout + recursive
merged-bin IBFs, build_update.py:411-518) and queries it by per-read
recursive descent (hierarchical_interleaved_bloom_filter.hpp:417-532).
That pointer-chasing design is hostile to batched accelerators; the
equivalent benefit —
small targets don't pay the bin size of the largest target — is achieved
here with a *forest* of IBFs: targets are partitioned into size classes by
minimizer count, each class builds its own optimally-sized IBF (reusing
the full sizing search), and a query bulk-counts every class in parallel,
concatenating per-class target counts. Outputs are identical to a single
IBF holding all targets (same per-target count semantics, class-local fp).

File format (``.hibf``): npz with a JSON header + one bits matrix per
class.
"""

from __future__ import annotations

import json

import numpy as np

from ganon_tpu.index.config import IBFConfig
from ganon_tpu.index.ibf import IBF, build_ibf

MAGIC = "ganon-tpu-hibf-v1"
# mmap-able raw container (save_raw / --filter-format tpu-raw)
RAW_MAGIC = b"GANON-TPU-HIBF-RAW1\n"
RAW_MAGIC_STR = "ganon-tpu-hibf-raw-v1"


class HIBF:
    """A forest of size-stratified IBFs acting as one filter."""

    hashes_count_is_estimate = False  # exact, carried per sub-IBF

    def __init__(self, subs: list[IBF], kmer_size: int, window_size: int,
                 max_fp: float):
        self.subs = subs
        self.ibf_config = IBFConfig(
            kmer_size=kmer_size,
            window_size=window_size,
            max_fp=max_fp,
            n_bins=sum(s.ibf_config.n_bins for s in subs),
            hash_functions=subs[0].ibf_config.hash_functions if subs else 0,
            true_max_fp=max((s.ibf_config.true_max_fp for s in subs), default=0),
            true_avg_fp=(
                sum(s.ibf_config.true_avg_fp for s in subs) / len(subs)
                if subs
                else 0
            ),
        )
        self.hashes_count = {}
        for s in subs:
            self.hashes_count.update(s.hashes_count)

    def targets(self):
        return list(self.hashes_count.keys())

    def target_fpr(self):
        out = {}
        for s in self.subs:
            out.update(s.target_fpr())
        return out

    def save(self, path: str):
        header = {
            "magic": MAGIC,
            "kmer_size": self.ibf_config.kmer_size,
            "window_size": self.ibf_config.window_size,
            "max_fp": self.ibf_config.max_fp,
            "subs": [
                {
                    "ibf_config": s.ibf_config.to_dict(),
                    "targets": s.targets(),
                    "hashes_count": [s.hashes_count[t] for t in s.targets()],
                    "bin_map": s.bin_map,
                }
                for s in self.subs
            ],
        }
        arrays = {
            "header": np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
        }
        for i, s in enumerate(self.subs):
            arrays[f"bits{i}"] = s.bits
        np.savez_compressed(path + ".tmp.npz", **arrays)
        import os

        os.replace(path + ".tmp.npz", path)

    def save_raw(self, path: str) -> None:
        """mmap-able forest container (``--filter-format tpu-raw``):
        JSON header + one page-aligned raw bit-matrix per class. Load
        time is independent of forest size (see IBF.save_raw)."""
        import os

        header = {
            "magic": RAW_MAGIC_STR,
            "kmer_size": self.ibf_config.kmer_size,
            "window_size": self.ibf_config.window_size,
            "max_fp": self.ibf_config.max_fp,
            "subs": [],
        }
        offset = 0  # filled below once the header size is known
        metas = []
        for s in self.subs:
            metas.append({
                "ibf_config": s.ibf_config.to_dict(),
                "targets": s.targets(),
                "hashes_count": [s.hashes_count[t] for t in s.targets()],
                "bin_map": s.bin_map,
                "bits_shape": list(s.bits.shape),
                "bits_dtype": str(s.bits.dtype),
                "bits_offset": 0,
            })
        # two-pass: serialize with placeholder offsets to learn the
        # header size (offsets are fixed-width ints, so re-serializing
        # with real values cannot change the length — they are padded)
        for m in metas:
            # 2^48-1 serializes to 15 decimal digits; real offsets are
            # always shorter and the ljust below pads the header back
            m["bits_offset"] = 0xFFFFFFFFFFFF
        blob = json.dumps(header | {"subs": metas}).encode()
        data_start = len(RAW_MAGIC) + 8 + len(blob)
        data_start += -data_start % 4096
        offset = data_start
        for m, s in zip(metas, self.subs):
            m["bits_offset"] = offset
            offset += int(np.prod(m["bits_shape"])) * s.bits.dtype.itemsize
            offset += -offset % 4096
        blob2 = json.dumps(header | {"subs": metas}).encode()
        # pad shorter real offsets back to the placeholder length
        blob2 = blob2.ljust(len(blob), b" ")
        assert len(blob2) == len(blob)
        with open(path + ".tmp", "wb") as f:
            f.write(RAW_MAGIC)
            f.write(len(blob2).to_bytes(8, "little"))
            f.write(blob2)
            f.write(b"\0" * (data_start - f.tell()))
            for m, s in zip(metas, self.subs):
                f.write(b"\0" * (m["bits_offset"] - f.tell()))
                f.write(np.ascontiguousarray(s.bits).tobytes())
        os.replace(path + ".tmp", path)

    @classmethod
    def _load_raw(cls, path: str) -> "HIBF":
        with open(path, "rb") as f:
            assert f.read(len(RAW_MAGIC)) == RAW_MAGIC
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen).decode())
        if header.get("magic") != RAW_MAGIC_STR:
            raise ValueError(f"not a ganon-tpu raw HIBF file: {path}")
        subs = []
        for sh in header["subs"]:
            cfg = IBFConfig.from_dict(sh["ibf_config"])
            hashes_count = dict(zip(sh["targets"], sh["hashes_count"]))
            bin_map = [(int(b), t) for b, t in sh["bin_map"]]
            bits = np.memmap(
                path, mode="r", dtype=np.dtype(sh["bits_dtype"]),
                offset=int(sh["bits_offset"]),
                shape=tuple(sh["bits_shape"]),
            )
            subs.append(IBF(bits, cfg, hashes_count, bin_map))
        return cls(
            subs, header["kmer_size"], header["window_size"],
            header["max_fp"],
        )

    @classmethod
    def load(cls, path: str) -> "HIBF":
        import zipfile

        if not zipfile.is_zipfile(path):
            with open(path, "rb") as f:
                if f.read(len(RAW_MAGIC)) == RAW_MAGIC:
                    return cls._load_raw(path)
            raise ValueError(f"not a ganon-tpu HIBF file: {path}")
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("magic") != MAGIC:
                raise ValueError(f"not a ganon-tpu HIBF file: {path}")
            subs = []
            for i, sh in enumerate(header["subs"]):
                cfg = IBFConfig.from_dict(sh["ibf_config"])
                hashes_count = dict(zip(sh["targets"], sh["hashes_count"]))
                bin_map = [(int(b), t) for b, t in sh["bin_map"]]
                subs.append(IBF(z[f"bits{i}"], cfg, hashes_count, bin_map))
        return cls(
            subs, header["kmer_size"], header["window_size"], header["max_fp"]
        )


def _per_bin_set_bits(bits: np.ndarray, row_chunk: int = 8192) -> np.ndarray:
    """Set-bit count per technical bin of a [rows, words] u32 bit matrix.

    Bin ``b`` is bit ``b % 32`` of word ``b // 32``; rows are processed
    in chunks so large filters never materialize the unpacked matrix.
    """
    rows, words = bits.shape
    out = np.zeros(words * 32, dtype=np.int64)
    for r0 in range(0, rows, row_chunk):
        chunk = bits[r0:r0 + row_chunk].view(np.uint8)
        # little-endian u32: byte j of word w covers bins w*32+8j..+7
        out += np.unpackbits(
            chunk, axis=1, bitorder="little"
        ).sum(axis=0, dtype=np.int64)
    return out


class RaptorHIBF:
    """A raptor-format hierarchical IBF, flattened for data-parallel query.

    The reference queries this structure with per-read recursive descent
    (hierarchical_interleaved_bloom_filter.hpp:432-460): count technical
    bins of IBF 0, descend into a merged bin's child IBF when its summed
    count reaches the read's threshold, record user-bin sums. Merged-bin
    Blooms contain every hash of their subtree (supersets, no false
    negatives), so a parent's count is always >= any descendant's — the
    gating never removes a user bin whose own count passes the threshold.
    A branch-free equivalent therefore queries EVERY sub-IBF and lets the
    engine's rel-cutoff do the thresholding: uniform batched work
    instead of pointer chasing.
    """

    def __init__(self, parsed: dict):
        self.window_size = parsed["window_size"]
        self.kmer_size = parsed["kmer_size"]
        self.fpr = parsed["fpr"]
        self._targets = parsed["targets"]
        self.ibfs = parsed["ibfs"]  # list of (bits, bins, bin_size, funs)
        self.next_ibf_id = parsed["next_ibf_id"]
        self.bin_to_filename = parsed["bin_to_filename"]
        self.ibf_config = IBFConfig(
            kmer_size=self.kmer_size,
            window_size=self.window_size,
            max_fp=self.fpr,
            n_bins=sum(b for _, b, _, _ in self.ibfs),
            hash_functions=self.ibfs[0][3] if self.ibfs else 0,
            true_max_fp=self.fpr,
            true_avg_fp=self.fpr,
        )
        self._hashes_count = None

    # unlike IBF/HIBF (exact counts carried in the file), raptor-format
    # counts are occupancy estimates (~10% error) — consumers shared
    # with the exact formats (sizing, abundance) must check this flag
    hashes_count_is_estimate = True

    @property
    def hashes_count(self) -> dict:
        """Per-target element counts ESTIMATED from filter occupancy.

        The raptor format does not carry per-target hash counts (the
        reference reports a single global fpr instead,
        GanonClassify.cpp:930-934). Rather than silent zeros, invert
        the Bloom fill per technical bin — n = -(m/h)·ln(1 - X/m) for X
        of m bits set — and sum a user bin's technical bins. Merged
        (routing) bins carry filename position -1 and are excluded, so
        subtree supersets are not double-counted. Computed lazily on
        first access (one pass over the bit matrices) and cached.
        """
        if self._hashes_count is None:
            est = np.zeros(len(self._targets), dtype=np.float64)
            for (bits, bins, bin_size, hash_funs), b2f in zip(
                self.ibfs, self.bin_to_filename
            ):
                if not len(b2f) or hash_funs <= 0:
                    continue
                x = _per_bin_set_bits(bits)  # [total technical bins]
                fpos = np.asarray(b2f, dtype=np.int64)
                nb = min(len(fpos), x.shape[0])
                fill = np.minimum(x[:nb] / float(bin_size), 1.0 - 1e-12)
                n_b = -(float(bin_size) / hash_funs) * np.log1p(-fill)
                keep = fpos[:nb] >= 0
                np.add.at(est, fpos[:nb][keep], n_b[keep])
            self._hashes_count = {
                t: int(round(est[i])) for i, t in enumerate(self._targets)
            }
        return self._hashes_count

    def targets(self):
        return list(self._targets)

    def target_fpr(self):
        # raptor reports a single fpr for all user bins
        # (GanonClassify.cpp:930-934)
        return {t: self.fpr for t in self._targets}

    @classmethod
    def load(cls, path: str) -> "RaptorHIBF":
        from ganon_tpu.index import serialize

        return cls(serialize.read_raptor_hibf(path))


def build_hibf(
    target_hashes: dict[str, np.ndarray],
    *,
    kmer_size: int,
    window_size: int,
    max_fp: float = 0.001,
    hash_functions: int = 0,
    num_classes: int = 4,
) -> HIBF:
    """Partition targets into size classes and build one IBF per class.

    Classes are split at geometric boundaries of the per-target minimizer
    count so bin sizes within a class are within ~4x of each other,
    bounding the space waste that a single flat IBF would pay.
    """
    counts = {t: len(h) for t, h in target_hashes.items()}
    if not counts:
        raise ValueError("no targets to build")
    cmin, cmax = min(counts.values()), max(counts.values())
    subs = []
    if cmin == cmax or num_classes <= 1:
        groups = [list(counts.keys())]
    else:
        bounds = np.geomspace(cmin, cmax, num_classes + 1)[1:-1]
        groups = [[] for _ in range(len(bounds) + 1)]
        for t, c in counts.items():
            groups[int(np.searchsorted(bounds, c, side="right"))].append(t)
        groups = [g for g in groups if g]
    for group in groups:
        subs.append(
            build_ibf(
                {t: target_hashes[t] for t in group},
                kmer_size=kmer_size,
                window_size=window_size,
                max_fp=max_fp,
                hash_functions=hash_functions,
            )
        )
    return HIBF(subs, kmer_size, window_size, max_fp)


def export_raptor_hibf(
    hibf: HIBF, target_hashes: dict[str, np.ndarray], output_file: str
) -> None:
    """Export the forest as a raptor-format ``.hibf`` the reference
    binaries can load (GanonClassify.cpp:875-938).

    Emits a 2-level hierarchy: IBF 0 holds one merged bin per forest
    class (the union of the class's hashes — a superset Bloom, so a
    parent count >= any descendant count and the reference's threshold
    descent never misses a user bin), each class IBF becomes a child
    with its user bins. Target names are mangled the way raptor derives
    them from file names ('.'->'|||', ' '->'---', + '.minimiser'),
    which the reference classifier undoes at load
    (GanonClassify.cpp:920-928) — as does our reader.
    """
    from ganon_tpu.index.serialize import write_raptor_hibf

    def mangle(t: str) -> str:
        return t.replace(".", "|||").replace(" ", "---") + ".minimiser"

    cfg = hibf.ibf_config
    merged = {
        f"merged{gi}": np.unique(
            np.concatenate([target_hashes[t] for t in sub.targets()])
        )
        for gi, sub in enumerate(hibf.subs)
    }
    root = build_ibf(
        merged, kmer_size=cfg.kmer_size, window_size=cfg.window_size,
        max_fp=cfg.max_fp,
    )
    filenames: list[str] = []
    fidx: dict[str, int] = {}
    for sub in hibf.subs:
        for t in sub.targets():
            fidx[t] = len(filenames)
            filenames.append(mangle(t))
    ibfs = [(root.bits, root.ibf_config.n_bins,
             root.ibf_config.hash_functions)]
    next_ibf_id = [np.zeros(root.bits.shape[1] * 32, dtype=np.int64)]
    bin_to_filename = [np.full(root.bits.shape[1] * 32, -1, dtype=np.int64)]
    root_bins: dict[str, list[int]] = {}
    for b, t in root.bin_map:
        root_bins.setdefault(t, []).append(b)
    for gi, sub in enumerate(hibf.subs):
        tb = sub.bits.shape[1] * 32
        ibfs.append((sub.bits, sub.ibf_config.n_bins,
                     sub.ibf_config.hash_functions))
        b2f = np.full(tb, -1, dtype=np.int64)
        for b, t in sub.bin_map:
            b2f[b] = fidx[t]
        next_ibf_id.append(np.full(tb, gi + 1, dtype=np.int64))
        bin_to_filename.append(b2f)
        for b in root_bins[f"merged{gi}"]:
            next_ibf_id[0][b] = gi + 1
    write_raptor_hibf(
        output_file, window_size=cfg.window_size, kmer_size=cfg.kmer_size,
        fpr=cfg.max_fp, filenames=filenames, ibfs=ibfs,
        next_ibf_id=next_ibf_id, bin_to_filename=bin_to_filename,
    )


# target count at/above which ``--hibf-layout auto`` picks the pruned
# merged-bin layout: below it the whole query table is cheap to probe
# at full width and the forest's per-class sizing already bounds space
# waste; at many-targets scale the coarse gate is what keeps the probed
# bytes per read small
PRUNED_AUTO_MIN_TARGETS = 2048


def run_build_hibf(
    *, target_info_file: str, output_file: str, kmer_size: int,
    window_size: int, hash_functions: int = 0, max_fp: float = 0.001,
    min_length: int = 0, threads: int = 1,
    filter_format: str = "tpu", layout: str = "auto", quiet: bool = True,
):
    """Count hashes from a target_info file and build/save a hierarchical
    filter: the size-stratified forest (``layout="forest"``) or the
    merged-bin pruned forest (``layout="pruned"``; index.pruned).
    ``auto`` picks pruned at many-targets scale. The raptor-format
    export (``filter_format="reference"``) always uses the forest
    layout (that IS the reference's container model)."""
    from ganon_tpu.index.builder import (
        BuildStats,
        count_target_hashes,
        parse_target_info,
    )

    stats = BuildStats()
    input_map = parse_target_info(target_info_file, quiet, stats)
    if not input_map:
        raise ValueError("No valid input files")
    target_hashes = count_target_hashes(
        input_map, kmer_size=kmer_size, window_size=window_size,
        min_length=min_length, stats=stats, threads=threads,
    )
    target_hashes = {t: h for t, h in target_hashes.items() if len(h)}
    if not target_hashes:
        raise ValueError("No valid sequences to build")
    if layout == "auto":
        layout = (
            "pruned"
            if (len(target_hashes) >= PRUNED_AUTO_MIN_TARGETS
                and filter_format != "reference")
            else "forest"
        )
    if layout == "pruned" and filter_format != "reference":
        from ganon_tpu.index.pruned import build_pruned

        pf = build_pruned(
            target_hashes, kmer_size=kmer_size, window_size=window_size,
            max_fp=max_fp,
        )
        if filter_format == "tpu-raw":
            pf.save_raw(output_file)
        else:
            pf.save(output_file)
        return pf
    hibf = build_hibf(
        target_hashes, kmer_size=kmer_size, window_size=window_size,
        max_fp=max_fp, hash_functions=hash_functions,
    )
    if filter_format == "reference":
        export_raptor_hibf(hibf, target_hashes, output_file)
    elif filter_format == "tpu-raw":
        hibf.save_raw(output_file)
    else:
        hibf.save(output_file)
    return hibf
