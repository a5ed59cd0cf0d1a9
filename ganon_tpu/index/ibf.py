"""IBF container: host build (vectorized scatter), save/load, device query.

File format (``.ibf``): a NumPy ``.npz`` with a JSON header — our own
format (``--filter-format tpu``), functionally equivalent to the reference's cereal
archive contents (version, IBFConfig, hashes_count, bin_map, bit data;
reference layout: GanonBuild.cpp:251-288).
"""

from __future__ import annotations

import io
import json
import math
import zipfile

import numpy as np

from ganon_tpu.index.config import IBFConfig
from ganon_tpu.index import sizing
from ganon_tpu.ops.ibf_query import ibf_row_indices_np

MAGIC = "ganon-tpu-ibf-v1"
# mmap-able raw container (save_raw / --filter-format tpu-raw)
RAW_MAGIC = b"GANON-TPU-IBF-RAW1\n"


class IBF:
    """Interleaved Bloom filter as a dense ``uint32[bin_size, n_words]``.

    Attributes:
      bits: uint32 [bin_size_bits, n_words] bit-matrix (numpy, host).
      ibf_config: IBFConfig.
      hashes_count: {target: distinct-minimizer count} (insertion order is
        the canonical target order).
      bin_map: list[(binno, target)] technical-bin ownership.
    """

    # counts are exact (carried in the file); see RaptorHIBF for the
    # occupancy-estimated counterpart
    hashes_count_is_estimate = False

    def __init__(self, bits, ibf_config: IBFConfig, hashes_count, bin_map):
        self.bits = bits
        self.ibf_config = ibf_config
        self.hashes_count = dict(hashes_count)
        self.bin_map = list(bin_map)

    # --- derived views -----------------------------------------------------

    @property
    def bin_count(self) -> int:
        return self.ibf_config.n_bins

    @property
    def technical_bins(self) -> int:
        return self.bits.shape[1] * 32

    def target_bins(self) -> dict[str, list[int]]:
        out: dict[str, list[int]] = {}
        for binno, target in self.bin_map:
            out.setdefault(target, []).append(binno)
        return out

    def targets(self) -> list[str]:
        return list(self.hashes_count.keys())

    def bin_to_target_ids(self) -> np.ndarray:
        """int32 [technical_bins]; padding bins get id == num_targets."""
        tids = {t: i for i, t in enumerate(self.targets())}
        arr = np.full((self.technical_bins,), len(tids), dtype=np.int32)
        for binno, target in self.bin_map:
            arr[binno] = tids[target]
        return arr

    def target_fpr(self) -> dict[str, float]:
        return sizing.target_fpr(self.hashes_count, self.ibf_config)

    # --- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        header = {
            "magic": MAGIC,
            "ibf_config": self.ibf_config.to_dict(),
            "targets": self.targets(),
            "hashes_count": [self.hashes_count[t] for t in self.targets()],
            "bin_map": self.bin_map,
        }
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".tmp.npz",
            header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
            bits=self.bits,
        )
        if not path.endswith(".npz"):
            import os

            os.replace(path + ".tmp.npz", path)

    def save_raw(self, path: str) -> None:
        """mmap-able container (``--filter-format tpu-raw``): small JSON
        header + page-aligned raw bit-matrix bytes.

        The default npz container zlib-compresses the bit-matrix, which
        costs a full decompress at every classify start — minutes for a
        RefSeq-scale (100 GB-class) db. The raw layout loads via
        ``np.memmap``: the OS pages bits in on demand, so time-to-first-
        batch is independent of filter size.
        """
        header = {
            "magic": MAGIC,
            "ibf_config": self.ibf_config.to_dict(),
            "targets": self.targets(),
            "hashes_count": [self.hashes_count[t] for t in self.targets()],
            "bin_map": self.bin_map,
            "bits_shape": list(self.bits.shape),
            "bits_dtype": str(self.bits.dtype),
        }
        blob = json.dumps(header).encode()
        import os

        with open(path + ".tmp", "wb") as f:
            f.write(RAW_MAGIC)
            f.write(len(blob).to_bytes(8, "little"))
            f.write(blob)
            pos = f.tell()
            f.write(b"\0" * (-pos % 4096))  # page-align the matrix
            f.write(np.ascontiguousarray(self.bits).tobytes())
        os.replace(path + ".tmp", path)

    @classmethod
    def _load_raw(cls, path: str) -> "IBF":
        with open(path, "rb") as f:
            assert f.read(len(RAW_MAGIC)) == RAW_MAGIC
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen).decode())
            offset = f.tell()
            offset += -offset % 4096
        if header.get("magic") != MAGIC:
            raise ValueError(f"not a ganon-tpu IBF file: {path}")
        bits = np.memmap(
            path, mode="r", dtype=np.dtype(header["bits_dtype"]),
            offset=offset, shape=tuple(header["bits_shape"]),
        )
        cfg = IBFConfig.from_dict(header["ibf_config"])
        hashes_count = dict(zip(header["targets"], header["hashes_count"]))
        bin_map = [(int(b), t) for b, t in header["bin_map"]]
        return cls(bits, cfg, hashes_count, bin_map)

    @classmethod
    def load(cls, path: str) -> "IBF":
        if not zipfile.is_zipfile(path):
            with open(path, "rb") as f:
                if f.read(len(RAW_MAGIC)) == RAW_MAGIC:
                    return cls._load_raw(path)
            # reference-format cereal archive (cross-compatibility)
            from ganon_tpu.index import serialize

            if serialize.is_cereal_ibf(path):
                return serialize.read_ibf(path)
            raise ValueError(f"unrecognized IBF file format: {path}")
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("magic") != MAGIC:
                raise ValueError(f"not a ganon-tpu IBF file: {path}")
            bits = z["bits"]
        cfg = IBFConfig.from_dict(header["ibf_config"])
        hashes_count = dict(zip(header["targets"], header["hashes_count"]))
        bin_map = [(int(b), t) for b, t in header["bin_map"]]
        return cls(bits, cfg, hashes_count, bin_map)


def is_ganon_tpu_ibf(path: str) -> bool:
    try:
        if not zipfile.is_zipfile(path):
            return False
        with np.load(path, allow_pickle=False) as z:
            if "header" not in z:
                return False
            header = json.loads(bytes(z["header"].tobytes()).decode())
            return header.get("magic") == MAGIC
    except Exception:
        return False


def _scatter_bits(bits: np.ndarray, rows: np.ndarray, bins: np.ndarray) -> None:
    """OR bit ``bins[i]`` into row ``rows[i]`` for all i (duplicate-safe).

    Sort-and-reduce instead of ``np.bitwise_or.at`` (orders of magnitude
    faster for large inserts). Host fallback; the production build path
    is the device-side :func:`_scatter_chunk` pipeline.
    """
    n_words = bits.shape[1]
    widx = rows.astype(np.int64) * n_words + (bins >> 5)
    mask = (np.uint32(1) << (bins & 31).astype(np.uint32)).astype(np.uint32)
    order = np.argsort(widx, kind="stable")
    widx = widx[order]
    mask = mask[order]
    boundaries = np.flatnonzero(np.r_[True, widx[1:] != widx[:-1]])
    merged = np.bitwise_or.reduceat(mask, boundaries)
    flat = bits.reshape(-1)
    flat[widx[boundaries]] |= merged


# hashes per device scatter dispatch (x hash_functions bit-inserts each)
SCATTER_CHUNK = 4 << 20


def _scatter_chunk_jit():
    """Build (once) the jitted device scatter-OR step.

    One dispatch inserts a chunk of (hash, technical-bin) pairs into the
    bit-matrix: row indices from the IBF hash family, flat bit indices
    sorted + first-occurrence-deduplicated on device (duplicates within
    a chunk would corrupt the scatter-ADD; duplicates ACROSS chunks are
    harmless because chunks combine with bitwise OR). Everything —
    hashing, sort, dedup, scatter, OR — runs on device; the build's
    host<->device traffic is one hash upload per chunk and one final
    bit-matrix fetch. Replaces the reference's thread-parallel
    ``ibf.emplace`` loop (GanonBuild.cpp:871-896).
    """
    import jax
    import jax.numpy as jnp
    from functools import partial

    from ganon_tpu.ops.ibf_query import ibf_row_indices

    @partial(
        jax.jit,
        donate_argnums=(0,),
        static_argnames=("bin_size", "hash_functions"),
    )
    def step(bits, hashes, bins, n_valid, *, bin_size, hash_functions):
        n_words = bits.shape[1]
        technical = jnp.uint64(n_words * 32)
        rows = ibf_row_indices(
            hashes, bin_size=bin_size, hash_functions=hash_functions
        )  # [N, S]
        bidx = rows.astype(jnp.uint64) * technical + bins.astype(jnp.uint64)[
            :, None
        ]
        valid = (
            jnp.arange(hashes.shape[0], dtype=jnp.int32) < n_valid
        )  # [N]
        # pad entries -> sentinel that sorts last and is masked out
        sentinel = jnp.uint64(bin_size) * technical
        bidx = jnp.where(valid[:, None], bidx, sentinel).reshape(-1)
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
        uniq = first & (sbidx < sentinel)
        # word index unconditionally from the sorted bit index: keeps the
        # index vector truly sorted (required by indices_are_sorted=True).
        # Sentinel entries map to exactly bits.size — out of bounds, so
        # mode="drop" discards them; duplicate entries keep their true
        # (sorted) word with a zero bit payload.
        word = (sbidx >> jnp.uint64(5)).astype(jnp.int64)
        bit = jnp.where(
            uniq,
            jnp.uint32(1) << (sbidx & jnp.uint64(31)).astype(jnp.uint32),
            jnp.uint32(0),
        )
        delta = jnp.zeros(bits.size, dtype=jnp.uint32)
        delta = delta.at[word].add(
            bit, indices_are_sorted=True, mode="drop"
        )
        return bits | delta.reshape(bits.shape)

    return step


_scatter_step = None


def scatter_hashes_device(
    bits_shape: tuple[int, int],
    chunks,
    *,
    bin_size: int,
    hash_functions: int,
) -> np.ndarray:
    """Device-build the bit-matrix from an iterator of (hashes, bins).

    ``chunks`` yields (uint64 hash array, int32 technical-bin array) of
    equal length; chunk sizes are bucketed to bound compiled shapes.
    Returns the final uint32 bit-matrix on host.
    """
    global _scatter_step
    import jax
    import jax.numpy as jnp

    if _scatter_step is None:
        _scatter_step = _scatter_chunk_jit()
    bits = jnp.zeros(bits_shape, dtype=jnp.uint32)
    for hashes, bins in chunks:
        n = len(hashes)
        if n == 0:
            continue
        cap = 1024
        while cap < n:
            cap *= 2
        if cap != n:
            hashes = np.pad(hashes, (0, cap - n))
            bins = np.pad(bins, (0, cap - n))
        bits = _scatter_step(
            bits,
            jnp.asarray(hashes),
            jnp.asarray(bins),
            jnp.int32(n),
            bin_size=bin_size,
            hash_functions=hash_functions,
        )
    # jax->numpy can come back non-C-contiguous; downstream views
    # (pack_table_u8, serializers) need C order
    return np.ascontiguousarray(np.asarray(bits))


def build_ibf(
    target_hashes: dict[str, np.ndarray],
    *,
    kmer_size: int,
    window_size: int,
    max_fp: float = 0.05,
    filter_size: float = 0.0,
    hash_functions: int = 0,
    mode: str = "avg",
) -> IBF:
    """Build an IBF from per-target minimizer arrays (sorted, deduplicated).

    ``target_hashes`` values are uint64 arrays of distinct minimizers in a
    deterministic (sorted) order; the split of a target across technical
    bins follows index ranges over that order.
    """
    hashes_count = {t: int(len(h)) for t, h in target_hashes.items()}
    cfg = sizing.size_filter(
        hashes_count,
        kmer_size=kmer_size,
        window_size=window_size,
        max_fp=max_fp,
        filter_size=filter_size,
        hash_functions=hash_functions,
        mode=mode,
    )

    splits = sizing.split_target_bins(cfg, hashes_count)
    technical = sizing.optimal_bins(cfg.n_bins)
    n_words = technical // 32

    def chunks():
        # stream (hashes, bins) pairs, merging small splits into
        # SCATTER_CHUNK-sized device dispatches
        acc_h, acc_b, acc_n = [], [], 0
        for binno, target, st, en in splits:
            h = np.asarray(target_hashes[target][st : en + 1], dtype=np.uint64)
            acc_h.append(h)
            acc_b.append(np.full(len(h), binno, dtype=np.int32))
            acc_n += len(h)
            if acc_n >= SCATTER_CHUNK:
                yield np.concatenate(acc_h), np.concatenate(acc_b)
                acc_h, acc_b, acc_n = [], [], 0
        if acc_n:
            yield np.concatenate(acc_h), np.concatenate(acc_b)

    bits = scatter_hashes_device(
        (cfg.bin_size_bits, n_words),
        chunks(),
        bin_size=cfg.bin_size_bits,
        hash_functions=cfg.hash_functions,
    )

    bin_map = [(binno, target) for binno, target, _, _ in splits]
    return IBF(bits, cfg, hashes_count, bin_map)
