"""Device-resident two-pass IBF construction.

The round-1 builder extracted minimizers on device but fetched every
per-piece hash array to host (for the per-file ``np.unique`` merge) and
re-uploaded the merged hashes for the scatter — through a slow device
link those transfers dominate (measured ~48 Mbp/m end-to-end while the
extraction kernel alone runs at ~8,500 Mbp/m device-only).

This pipeline keeps hashes on device end-to-end:

  pass 1 (count)   upload 2-bit pieces -> extract per-piece sorted
                   uniques (device) -> per-GROUP close dispatches that
                   sort/dedup across each file's pieces and emit
                   per-file distinct counts (device) -> one batched
                   fetch of all counts (4 bytes/file)
  host             sizing (optimal_hashes) from the counts
  pass 2 (scatter) walk the per-piece extract outputs again
                   (device-cached while they fit, re-extracted from the
                   host packed-piece spill when trimmed) -> close
                   dispatches that dedup, rank each unique hash within
                   its file, derive its technical bin from the
                   reference's index-range split
                   (GanonBuild.cpp:619-653), and scatter-OR into a
                   donated bit-matrix -> ONE final matrix fetch

Groups are cut at FILE boundaries during ingest (all piece buffers flush
at a cut), so a close group is always a run of whole batches: the
gather is a handful of concats, never per-row slices — essential
through a device link where every eager op costs ~20 ms and every
fetch ~120 ms of round-trip latency.

Per-file semantics match the reference (and the host-array path)
exactly: dedup within a file, duplicates across files of one target
counted twice (GanonBuild.cpp:225-240), a target's hashes split across
technical bins by index ranges over the per-file-sorted concatenated
order — the produced bit-matrix is bit-identical to the host path's.
Pieces with more distinct minima than the compaction cap divert their
whole file to an exact host fallback.
"""

from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass, field
from functools import partial

import numpy as np

# pieces per extraction dispatch; row threshold for a group cut.
# Bigger amortizes the ~20 ms/op + ~120 ms/fetch link latency; device
# exec scales linearly (~300 ms per 128-row close group).
PIECES_PER_BATCH = 64
CLOSE_ROWS = 128
# keep per-piece extract outputs device-resident up to this many bytes;
# beyond, the oldest are dropped and re-extracted from the packed spill
# when a close group needs them again
DEVICE_CACHE_BYTES = 4 << 30
# peak bytes for the scatter's u8 bit plane; larger filters scatter in
# row-range chunks (the plane is 8x the bit-matrix, so a multi-GB filter
# would otherwise exhaust device memory). Each extra chunk re-walks every
# entry. 3 GiB keeps a filter of up to 384 MiB (the RefSeq archaea
# complete-genomes shape) in one pass while the plane stays a small part
# of the ~60 GB that JAX reserves on an 80 GB card.
PLANE_CHUNK_BYTES = 3 << 30

CHUNK = 1 << 18


def _bucket(n: int, minimum: int = 4096) -> int:
    b = minimum
    while b < n:
        b *= 2
    return min(b, CHUNK)


def _unique_cap(L: int) -> int:
    """Compaction slots per piece: 1/5 of positions (~1.4x the expected
    distinct-minima density of 2/(w-k+2)); overflow falls back."""
    return max(min(L // 5, L), 1024)


def _row_bucket(n: int) -> int:
    """Pad close-dispatch row counts to powers of two (bounded compiles)."""
    b = 8
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------------
# jitted kernels


def _make_kernels():
    import jax
    import jax.numpy as jnp

    from ganon_tpu.classify.device import unpack_codes_2bit
    from ganon_tpu.ops.ibf_query import ibf_row_indices
    from ganon_tpu.ops.minimizers import window_mins_unique_jax

    @partial(jax.jit, static_argnames=("k", "w", "L", "cap"))
    def extract(packed, lengths, *, k, w, L, cap):
        """Per-piece sorted distinct window minima (device-resident).

        Returns (vals u64 [B, cap], n i32 [B], ovf bool [B]).
        """
        codes = unpack_codes_2bit(packed, L)
        return window_mins_unique_jax(codes, lengths, k=k, w=w, cap=cap)

    @jax.jit
    def close_sort(vals, n, keys, ovf):
        """Flatten piece rows, sort by (file key, value), first-occurrence
        mask. Padding/overflow slots get the sentinel key (sorts last).

        Shared by both passes — compiled once per (rows, cap) shape.
        Returns (k_s i32 [N], hi_s/lo_s u32 [N], uniq bool [N]).
        """
        R, cap = vals.shape
        slot = jnp.arange(cap, dtype=jnp.int32)[None, :]
        valid = (slot < n[:, None]) & (~ovf[:, None])
        keyf = jnp.where(valid, keys[:, None], jnp.int32(R)).reshape(-1)
        hi = (vals >> jnp.uint64(32)).astype(jnp.uint32).reshape(-1)
        lo = vals.astype(jnp.uint32).reshape(-1)
        k_s, hi_s, lo_s = jax.lax.sort((keyf, hi, lo), num_keys=3)
        first = jnp.concatenate(
            [
                jnp.ones((1,), dtype=bool),
                (k_s[1:] != k_s[:-1])
                | (hi_s[1:] != hi_s[:-1])
                | (lo_s[1:] != lo_s[:-1]),
            ]
        )
        uniq = first & (k_s < R)
        return k_s, hi_s, lo_s, uniq

    @jax.jit
    def close_counts_sorted(k_s, keys, ovf, uniq):
        """Per-file distinct counts + overflow flags from sorted entries.

        Returns (counts i32 [R] by file id, ovf i32 [R] by file id).
        """
        R = keys.shape[0]
        counts = jax.ops.segment_sum(
            uniq.astype(jnp.int32), k_s, num_segments=R + 1,
            indices_are_sorted=True,
        )[:R]
        kovf = jax.ops.segment_max(
            ovf.astype(jnp.int32), keys, num_segments=R
        )
        return counts, kovf

    @partial(
        jax.jit,
        donate_argnums=(0,),
        static_argnames=("bin_size", "hash_functions", "n_words",
                         "n_chunks"),
    )
    def scatter_sorted(
        bits, k_s, hi_s, lo_s, uniq, skip_key, params,
        *, bin_size, hash_functions, n_words, n_chunks=1,
    ):
        """Rank each unique hash within its file, derive its technical
        bin from the index-range split, scatter-OR into donated bits.

        skip_key: bool [R] per FILE id — files handled by the exact host
        fallback (overflow). params: i32 [3, R] per file id — first
        technical bin of the file's target, the target's per-bin hash
        quota, and the count of same-target hashes in earlier files
        (reference bin split: GanonBuild.cpp:619-653).

        The bit accumulation scatter-maxes ones into a LANE-MAJOR u8 bit
        plane ``[32, rows*n_words]`` (idempotent, so no dedup sort is
        needed): keeping the word axis minor keeps every plane row
        contiguous, and the OR-chain that packs the planes back into u32
        words fuses elementwise. Large
        filters process the plane in ``n_chunks`` row-range passes
        (static) so peak memory stays ~plane_bytes/n_chunks regardless
        of filter size; out-of-range entries drop via the scatter
        sentinel (negative = earlier chunk entries are clamped onto it,
        since JAX wraps negative indices even in drop mode).

        ``bits`` is FLAT u32 [bin_size * n_words] on device, so row-range
        chunks are contiguous slices.
        """
        flat, lane = _entry_coords(
            k_s, hi_s, lo_s, uniq, skip_key, params,
            bin_size=bin_size, hash_functions=hash_functions,
            n_words=n_words,
        )
        rows_per_chunk = -(-bin_size // n_chunks)
        out = []
        for c in range(n_chunks):
            r0 = c * rows_per_chunk
            rc = min(rows_per_chunk, bin_size - r0)
            if rc <= 0:
                break
            out.append(_scatter_span(
                bits[r0 * n_words : (r0 + rc) * n_words],
                flat, lane, jnp.int64(r0 * n_words), rc, n_words,
            ))
        return jnp.concatenate(out) if len(out) > 1 else out[0]

    def _entry_coords(k_s, hi_s, lo_s, uniq, skip_key, params,
                      *, bin_size, hash_functions, n_words):
        """(flat, lane) i64 [N, S] plane coordinates per sorted entry.

        Ranks each unique hash within its file, derives its technical
        bin from the index-range split (reference GanonBuild.cpp:619-653)
        and its row from the IBF hash family; dropped entries (padding,
        duplicates, host-fallback files) map past the plane end.
        """
        R = skip_key.shape[0]
        bin_base, nhb, offset = params[0], params[1], params[2]
        kc = jnp.clip(k_s, 0, R - 1)
        uniq = uniq & ~skip_key[kc]
        # rank of each unique value within its file (a file's uniq entries
        # are contiguous and value-ascending after the sort)
        uniq_i = uniq.astype(jnp.int32)
        uniq_rank = jnp.cumsum(uniq_i) - 1
        key_counts = jax.ops.segment_sum(
            uniq_i, k_s, num_segments=R + 1, indices_are_sorted=True
        )[:R]
        key_start = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(key_counts)[:-1]]
        )
        idx = uniq_rank - key_start[kc] + offset[kc]
        binno = (bin_base[kc] + idx // jnp.maximum(nhb[kc], 1)).astype(
            jnp.int64
        )
        v64 = (hi_s.astype(jnp.uint64) << jnp.uint64(32)) | lo_s.astype(
            jnp.uint64
        )
        rows = ibf_row_indices(
            v64, bin_size=bin_size, hash_functions=hash_functions
        )  # [N, S]
        # per-entry (row, word, lane) in lane-major plane coordinates
        word = binno >> jnp.int64(5)
        lane = (binno & jnp.int64(31)).astype(jnp.int64)
        flat = rows.astype(jnp.int64) * jnp.int64(n_words) + word[:, None]
        lane = jnp.broadcast_to(lane[:, None], flat.shape)
        big = jnp.int64(bin_size) * jnp.int64(n_words)  # out-of-range
        flat = jnp.where(uniq[:, None], flat, big)
        return flat, lane

    def _scatter_span(bits_span, flat, lane, w0, rc, n_words):
        """Scatter-OR the entries landing in ``[w0, w0 + rc*n_words)``
        into that word span of the bit-matrix (``w0`` may be traced —
        the mesh path derives it from axis_index; ``rc`` is static).
        """
        span = jnp.int64(rc * n_words)
        # entries past the range drop via mode="drop"; entries BEFORE
        # it would be negative, which JAX WRAPS (drop only handles
        # too-large) — clamp them onto the drop sentinel instead
        lflat = flat - w0
        lflat = jnp.where(lflat < 0, span, lflat)
        lidx = lane * span + lflat  # lane-major: [32, rc*n_words]
        lidx = jnp.where(lflat >= span, 32 * span, lidx)
        plane = jnp.zeros((32 * rc * n_words,), dtype=jnp.uint8)
        plane = plane.at[lidx.reshape(-1)].max(jnp.uint8(1), mode="drop")
        # pack: unrolled OR-chain, u8 until the final byte merge — a
        # jnp.sum reduce materializes the full u32-expanded plane
        # (4x, observed 2x 8 GB temps); this fuses elementwise
        p = plane.reshape(32, rc * n_words)
        delta = jnp.zeros((rc * n_words,), jnp.uint32)
        for k in range(4):
            byte_k = p[8 * k]
            for j in range(1, 8):
                byte_k = byte_k | (p[8 * k + j] << jnp.uint8(j))
            delta = delta | (
                byte_k.astype(jnp.uint32) << jnp.uint32(8 * k)
            )
        return bits_span | delta

    def make_scatter_mesh(mesh):
        """Mesh-sharded scatter_sorted: the flat bit-matrix is sharded
        over the mesh's ``bins`` axis (row ranges — the flat layout is
        row-major), every device derives its span offset from
        axis_index and scatters only locally-landing entries (the same
        drop logic the single-device chunk loop uses). Entry inputs are
        replicated; no collectives touch the plane itself, so per-chip
        scatter traffic and peak plane memory drop by the shard count —
        the multi-chip answer to the build-at-scale HBM ceiling.
        """
        from jax.sharding import PartitionSpec as P

        from jax import shard_map

        nb = mesh.shape["bins"]

        @partial(
            jax.jit,
            donate_argnums=(0,),
            static_argnames=("bin_size", "hash_functions", "n_words",
                             "rows_per_shard", "n_chunks"),
        )
        def scatter_sorted_mesh(
            bits, k_s, hi_s, lo_s, uniq, skip_key, params,
            *, bin_size, hash_functions, n_words, rows_per_shard,
            n_chunks=1,
        ):
            flat, lane = _entry_coords(
                k_s, hi_s, lo_s, uniq, skip_key, params,
                bin_size=bin_size, hash_functions=hash_functions,
                n_words=n_words,
            )

            def body(bits_local, flat, lane):
                i = jax.lax.axis_index("bins").astype(jnp.int64)
                shard_w0 = i * jnp.int64(rows_per_shard * n_words)
                rpc = -(-rows_per_shard // n_chunks)
                out = []
                for c in range(n_chunks):
                    r0 = c * rpc
                    rc = min(rpc, rows_per_shard - r0)
                    if rc <= 0:
                        break
                    out.append(_scatter_span(
                        bits_local[r0 * n_words : (r0 + rc) * n_words],
                        flat, lane, shard_w0 + jnp.int64(r0 * n_words),
                        rc, n_words,
                    ))
                return jnp.concatenate(out) if len(out) > 1 else out[0]

            return shard_map(
                body, mesh=mesh,
                in_specs=(P("bins"), P(), P()),
                out_specs=P("bins"),
            )(bits, flat, lane)

        return scatter_sorted_mesh

    return extract, close_sort, close_counts_sorted, scatter_sorted, \
        make_scatter_mesh


_KERNELS = None


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        _KERNELS = _make_kernels()
    return _KERNELS


# --------------------------------------------------------------------------
# piece spill (host-side 2-bit packed cache: re-extraction + exact fallback)


class PieceSpill:
    """Append-only spill of 2-bit packed pieces to one tmp file."""

    def __init__(self, tmp_dir: str | None = None):
        fd, self.path = tempfile.mkstemp(suffix=".pieces", dir=tmp_dir or None)
        self._w = os.fdopen(fd, "wb")
        self._r = open(self.path, "rb")
        self.index: list[tuple[int, int, int]] = []  # (offset, L, length)
        self._off = 0

    def add(self, packed_row: np.ndarray, L: int, length: int) -> int:
        b = packed_row.tobytes()
        self._w.write(b)
        self.index.append((self._off, L, length))
        self._off += len(b)
        return len(self.index) - 1

    def read(self, piece_id: int) -> tuple[np.ndarray, int, int]:
        off, L, length = self.index[piece_id]
        nbytes = -(-L // 4)
        self._w.flush()
        self._r.seek(off)
        buf = np.frombuffer(self._r.read(nbytes), dtype=np.uint8)
        return buf, L, length

    def close(self):
        for f in (self._w, self._r):
            try:
                f.close()
            except OSError:
                pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


# --------------------------------------------------------------------------
# pipeline


@dataclass
class _FileRec:
    key: object                      # (target, file_index)
    count: int = 0
    ovf: bool = False
    pids: list = field(default_factory=list)  # spill piece ids


@dataclass
class _Batch:
    vals: object                     # device u64 [B, cap]; None if trimmed
    n: object                        # device i32 [B]
    ovf: object                      # device bool [B]
    cap: int
    L: int
    pids: list                       # spill piece ids, one per row
    rows: list                       # owning _FileRec, one per row
    nbytes: int = 0
    dev: object = None               # owner device (group-parallel counting)


@dataclass
class _Group:
    batch_ids: list
    files: list                      # ordered unique _FileRec
    sorted: object = None            # cached close_sort output (device)
    sorted_bytes: int = 0


class DeviceBuildPipeline:
    """Streamed two-pass device IBF build (see module docstring).

    With several visible devices, close groups round-robin over them:
    each group's extraction and dedup-sort dispatches run on its owner
    device (async dispatch makes them concurrent), and the scatter pass
    re-homes the sorted entries to the scatter's device/mesh. Groups
    never interact until the final bit-matrix, so results are
    bit-identical to single-device (tests/test_device_build.py).
    """

    def __init__(self, k: int, w: int, tmp_dir: str | None = None,
                 device_cache_bytes: int = DEVICE_CACHE_BYTES,
                 devices=None):
        self.k, self.w = k, w
        self.spill = PieceSpill(tmp_dir)
        self.files: list[_FileRec] = []
        self._file_of_key: dict[object, _FileRec] = {}
        self.batches: list[_Batch] = []
        self.groups: list[_Group] = []
        self._cache_bytes = 0
        self._cache_limit = device_cache_bytes
        # bucket L -> [(rec, pid, packed_row)]
        self._bufs: dict[int, list] = {}
        self._cur_rec: _FileRec | None = None
        self._cut_batch0 = 0          # first batch id of the open group
        self._cut_files: list = []    # files of the open group
        self._rows_since_cut = 0
        self._devices = devices       # None = all local (resolved lazily)

    def _group_device(self):
        """Owner device of the OPEN group (groups round-robin)."""
        if self._devices is None:
            import jax

            self._devices = jax.local_devices()
        if len(self._devices) == 1:
            return None  # uncommitted: keep default placement
        return self._devices[len(self.groups) % len(self._devices)]

    # -- ingest ------------------------------------------------------------

    def add_encoded(self, key, row: np.ndarray) -> None:
        """Add one dna4-encoded piece (uint8 [n], n <= CHUNK) of file
        ``key``. Pieces of one file must arrive consecutively."""
        if len(row) < self.w:
            return
        from ganon_tpu.classify.device import pack_codes_2bit

        rec = self._file_of_key.get(key)
        if rec is None:
            # file boundary: cut a close group if enough rows accumulated
            if self._cur_rec is not None and self._rows_since_cut >= CLOSE_ROWS:
                self._cut()
            rec = _FileRec(key=key)
            self._file_of_key[key] = rec
            self.files.append(rec)
            self._cut_files.append(rec)
        self._cur_rec = rec
        L = CHUNK if len(row) == CHUNK else _bucket(len(row))
        packed = pack_codes_2bit(np.ascontiguousarray(row)[None, :])[0]
        nb = -(-L // 4)
        if len(packed) < nb:
            packed = np.pad(packed, (0, nb - len(packed)))
        pid = self.spill.add(packed, L, len(row))
        rec.pids.append(pid)
        buf = self._bufs.setdefault(L, [])
        buf.append((rec, pid, packed))
        self._rows_since_cut += 1
        if len(buf) >= PIECES_PER_BATCH:
            self._submit(L)

    def add_sequence(self, key, seq_codes: np.ndarray) -> None:
        """Chunk a full encoded sequence into w-1-overlapping pieces."""
        n = len(seq_codes)
        if n < self.w:
            return
        step = CHUNK - (self.w - 1)
        for s in range(0, max(n - self.w + 1, 1), step):
            self.add_encoded(key, seq_codes[s : s + CHUNK])

    def _cut(self) -> None:
        """Close the open group: flush every buffer, record the group."""
        for L in list(self._bufs):
            self._submit(L)
        if self._cut_files:
            self.groups.append(
                _Group(
                    batch_ids=list(range(self._cut_batch0, len(self.batches))),
                    files=list(self._cut_files),
                )
            )
        self._cut_batch0 = len(self.batches)
        self._cut_files = []
        self._rows_since_cut = 0

    def _submit(self, L: int) -> None:
        buf = self._bufs.pop(L, [])
        if not buf:
            return
        bt = self._extract_batch(
            L, [pid for _, pid, _ in buf], [p for _, _, p in buf],
            dev=self._group_device(),
        )
        bt.rows = [rec for rec, _, _ in buf]
        self.batches.append(bt)
        self._cache_bytes += bt.nbytes
        self._trim_cache()

    def _extract_batch(self, L: int, pids: list,
                       packed_rows: list | None = None,
                       dev=None) -> _Batch:
        import jax
        import jax.numpy as jnp

        extract = _kernels()[0]
        B = len(pids)
        nb = -(-L // 4)
        packed = np.zeros((B, nb), dtype=np.uint8)
        lengths = np.zeros((B,), dtype=np.int32)
        for i, pid in enumerate(pids):
            if packed_rows is not None:
                packed[i] = packed_rows[i]
                lengths[i] = self.spill.index[pid][2]
            else:
                prow, _, plen = self.spill.read(pid)
                packed[i] = prow
                lengths[i] = plen
        cap = _unique_cap(L)
        if dev is not None:
            packed_d = jax.device_put(packed, dev)
            lengths_d = jax.device_put(lengths, dev)
        else:
            packed_d = jnp.asarray(packed)
            lengths_d = jnp.asarray(lengths)
        vals, n, ovf = extract(
            packed_d, lengths_d, k=self.k, w=self.w, L=L, cap=cap,
        )
        bt = _Batch(vals, n, ovf, cap, L, list(pids), [],
                    nbytes=B * (cap * 8 + 8))
        bt.dev = dev
        return bt

    def _ensure_group(self, group: _Group) -> None:
        for bid in group.batch_ids:
            bt = self.batches[bid]
            if bt.vals is None:
                nb = self._extract_batch(
                    bt.L, bt.pids, dev=getattr(bt, "dev", None)
                )
                bt.vals, bt.n, bt.ovf = nb.vals, nb.n, nb.ovf
                self._cache_bytes += bt.nbytes

    def _trim_cache(self) -> None:
        if self._cache_bytes <= self._cache_limit:
            return
        for bt in self.batches:
            if bt.vals is not None:
                bt.vals = bt.n = bt.ovf = None
                self._cache_bytes -= bt.nbytes
                if self._cache_bytes <= self._cache_limit:
                    return
        # batches gone; drop cached sorted groups (oldest first) — the
        # scatter pass falls back to re-gather + re-sort
        for group in self.groups:
            if group.sorted is not None:
                group.sorted = None
                self._cache_bytes -= group.sorted_bytes
                group.sorted_bytes = 0
                if self._cache_bytes <= self._cache_limit:
                    return

    # -- group gather ---------------------------------------------------------

    def _gather_group(self, group: _Group):
        """Concat the group's batches whole (device) + per-row file keys
        (host). Never slices rows — each eager device op costs ~20 ms of
        link latency."""
        import jax.numpy as jnp

        self._ensure_group(group)
        fidx = {id(rec): i for i, rec in enumerate(group.files)}
        bts = [self.batches[b] for b in group.batch_ids]
        cap = max(bt.cap for bt in bts)
        parts_v, parts_n, parts_o, keys = [], [], [], []
        for bt in bts:
            v = bt.vals
            if bt.cap < cap:
                v = jnp.pad(v, ((0, 0), (0, cap - bt.cap)))
            parts_v.append(v)
            parts_n.append(bt.n)
            parts_o.append(bt.ovf)
            keys.extend(fidx[id(rec)] for rec in bt.rows)
        vals = jnp.concatenate(parts_v) if len(parts_v) > 1 else parts_v[0]
        n = jnp.concatenate(parts_n) if len(parts_n) > 1 else parts_n[0]
        ovf = jnp.concatenate(parts_o) if len(parts_o) > 1 else parts_o[0]
        R = vals.shape[0]
        Rp = _row_bucket(R)
        if Rp != R:
            # padding rows: n=0 (no valid slots), ovf=False; their clamped
            # key aliases a real file but contributes nothing
            vals = jnp.pad(vals, ((0, Rp - R), (0, 0)))
            n = jnp.pad(n, (0, Rp - R))
            ovf = jnp.pad(ovf, (0, Rp - R))
            keys.extend([len(group.files) - 1] * (Rp - R))
        return vals, n, ovf, np.asarray(keys, dtype=np.int32)

    # -- pass 1: counts ------------------------------------------------------

    def finish_counts(self) -> None:
        """Cut the final group, run all close dispatches, fetch counts in
        one batched device->host transfer."""
        import jax.numpy as jnp

        self._cut()
        _, close_sort, close_counts_sorted, _, _ = _kernels()
        pending = []  # (counts_d, kovf_d, group)
        for group in self.groups:
            vals, n, ovf, keys = self._gather_group(group)
            keys_d = jnp.asarray(keys)
            k_s, hi_s, lo_s, uniq = close_sort(vals, n, keys_d, ovf)
            counts, kovf = close_counts_sorted(k_s, keys_d, ovf, uniq)
            # cache the sorted entries for the scatter pass (saves the
            # second sort + any re-extraction); the trimmer may
            # drop them under memory pressure
            group.sorted = (k_s, hi_s, lo_s, uniq)
            group.sorted_bytes = int(k_s.shape[0]) * 13
            self._cache_bytes += group.sorted_bytes
            pending.append((counts, kovf, group))
            self._trim_cache()
        if not pending:
            return
        # one fetch per owner device (groups round-robin over devices;
        # concatenating across devices is not allowed). Chunked concat
        # keeps op arity sane.
        def _devkey(x):
            d = getattr(x, "devices", None)
            return tuple(sorted(map(str, d()))) if d else ""

        by_dev: dict = {}
        for counts, kovf, group in pending:
            by_dev.setdefault(_devkey(counts), []).append(
                (counts, kovf, group)
            )
        for dev_pending in by_dev.values():
            flat = []
            for counts, kovf, _ in dev_pending:
                flat.extend((counts, kovf))
            merged = []
            for i in range(0, len(flat), 256):
                merged.append(jnp.concatenate(flat[i : i + 256]))
            allv = np.asarray(
                jnp.concatenate(merged) if len(merged) > 1 else merged[0]
            )
            off = 0
            for counts_d, kovf_d, group in dev_pending:
                R = counts_d.shape[0]
                counts = allv[off : off + R]
                kovf = allv[off + R : off + 2 * R]
                off += 2 * R
                for i, rec in enumerate(group.files):
                    rec.count = int(counts[i])
                    rec.ovf = bool(kovf[i])
        # exact host fallback for overflowing files
        for rec in self.files:
            if rec.ovf:
                rec.count = len(self._host_uniques(rec))

    def _host_uniques(self, rec: _FileRec) -> np.ndarray:
        """Exact per-file distinct minimizers via the uncompacted kernel
        (host dedup) — overflow fallback only."""
        import jax.numpy as jnp

        from ganon_tpu.classify.device import unpack_codes_2bit
        from ganon_tpu.ops.minimizers import window_mins_jax

        parts = []
        for pid in rec.pids:
            prow, L, length = self.spill.read(pid)
            codes = np.asarray(
                unpack_codes_2bit(jnp.asarray(prow[None, :]), L)
            )
            mv, valid = window_mins_jax(
                codes, np.asarray([length], np.int32), k=self.k, w=self.w
            )
            parts.append(np.asarray(mv)[0][np.asarray(valid)[0]])
        return (
            np.unique(np.concatenate(parts))
            if parts
            else np.empty(0, dtype=np.uint64)
        )

    # -- sizing inputs -------------------------------------------------------

    def hashes_count(self) -> dict[str, int]:
        """{target: sum of per-file distinct counts} in insertion order."""
        out: dict[str, int] = {}
        for rec in self.files:
            target = rec.key[0]
            out[target] = out.get(target, 0) + rec.count
        return out

    # -- pass 2: scatter -------------------------------------------------------

    def scatter(self, ibf_config, mesh=None) -> np.ndarray:
        """Build the bit-matrix on device; returns it as host uint32.

        With ``mesh`` (any jax Mesh with a ``bins`` axis) the flat
        bit-matrix row-shards over the mesh and every scatter pass runs
        shard-locally (make_scatter_mesh): per-chip plane memory and
        scatter traffic drop by the shard count, lifting the
        single-chip HBM ceiling that bounds build-at-scale.
        """
        import jax
        import jax.numpy as jnp

        from ganon_tpu.index import sizing

        _, close_sort, _, scatter_sorted, make_scatter_mesh = _kernels()
        technical = sizing.optimal_bins(ibf_config.n_bins)
        n_words = technical // 32
        plane_bytes = ibf_config.bin_size_bits * technical
        rows_per_shard = 0
        if mesh is not None:
            from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

            if tuple(mesh.axis_names) != ("bins",):
                # build wants every device on one bins axis; flatten
                # whatever mesh the caller holds (e.g. classify's
                # (batch, bins)) into a dedicated 1-D build mesh
                mesh = Mesh(np.asarray(mesh.devices).reshape(-1), ("bins",))
            nb = mesh.shape["bins"]
            rows_per_shard = -(-ibf_config.bin_size_bits // nb)
            scatter_mesh = make_scatter_mesh(mesh)
            # flat on device: 2-D with small n_words tile-pads up to 64x
            bits = jax.device_put(
                jnp.zeros((rows_per_shard * nb * n_words,), jnp.uint32),
                NamedSharding(mesh, P("bins")),
            )
            n_chunks = 1
            while n_chunks * PLANE_CHUNK_BYTES < plane_bytes // nb:
                n_chunks *= 2
        else:
            bits = jnp.zeros(
                (ibf_config.bin_size_bits * n_words,), dtype=jnp.uint32
            )
            n_chunks = 1
            while n_chunks * PLANE_CHUNK_BYTES < plane_bytes:
                n_chunks *= 2

        # per-file bin parameters from the reference's split math (must
        # agree with sizing.split_target_bins)
        hashes_count = self.hashes_count()
        mhb = ibf_config.max_hashes_bin
        bin_base_t, nhb_t = {}, {}
        binno = 0
        for target, count in hashes_count.items():
            nb = math.ceil(count / mhb) if count else 0
            nhb = min(math.ceil(count / nb), mhb) if nb else 1
            bin_base_t[target] = binno
            nhb_t[target] = nhb
            binno += nb
        running: dict[str, int] = {}
        params_of: dict[int, tuple] = {}
        for rec in self.files:
            t = rec.key[0]
            off = running.get(t, 0)
            params_of[id(rec)] = (bin_base_t[t], nhb_t[t], off)
            running[t] = off + rec.count

        for group in self.groups:
            if all(rec.ovf for rec in group.files):
                continue
            if group.sorted is not None:
                k_s, hi_s, lo_s, uniq = group.sorted
                group.sorted = None
                self._cache_bytes -= group.sorted_bytes
                group.sorted_bytes = 0
                R = _row_bucket(
                    sum(len(self.batches[b].pids) for b in group.batch_ids)
                )
            else:
                vals, n, ovf, keys = self._gather_group(group)
                R = vals.shape[0]
                k_s, hi_s, lo_s, uniq = close_sort(
                    vals, n, jnp.asarray(keys), ovf
                )
            params = np.zeros((3, R), np.int32)
            params[1, :] = 1
            skip_key = np.zeros(R, dtype=bool)
            for i, rec in enumerate(group.files):
                params[0, i], params[1, i], params[2, i] = params_of[id(rec)]
                skip_key[i] = rec.ovf
            # re-home entries counted on another device (group-parallel
            # counting): the scatter's device/mesh wins
            if mesh is not None:
                rep = NamedSharding(mesh, P())
                k_s, hi_s, lo_s, uniq = (
                    jax.device_put(x, rep) for x in (k_s, hi_s, lo_s, uniq)
                )
            elif getattr(
                next(iter(k_s.devices())), "id", 0
            ) != getattr(jax.local_devices()[0], "id", 0):
                k_s, hi_s, lo_s, uniq = (
                    jax.device_put(x, jax.local_devices()[0])
                    for x in (k_s, hi_s, lo_s, uniq)
                )
            if mesh is not None:
                bits = scatter_mesh(
                    bits, k_s, hi_s, lo_s, uniq, jnp.asarray(skip_key),
                    jnp.asarray(params),
                    bin_size=ibf_config.bin_size_bits,
                    hash_functions=ibf_config.hash_functions,
                    n_words=n_words,
                    rows_per_shard=rows_per_shard,
                    n_chunks=n_chunks,
                )
            else:
                bits = scatter_sorted(
                    bits, k_s, hi_s, lo_s, uniq, jnp.asarray(skip_key),
                    jnp.asarray(params),
                    bin_size=ibf_config.bin_size_bits,
                    hash_functions=ibf_config.hash_functions,
                    n_words=n_words,
                    n_chunks=n_chunks,
                )
            self._trim_cache()

        out = np.ascontiguousarray(
            np.asarray(bits).reshape(-1, n_words)[:ibf_config.bin_size_bits]
        )

        # exact host path for overflowed files (rare)
        from ganon_tpu.index.ibf import _scatter_bits
        from ganon_tpu.ops.ibf_query import ibf_row_indices_np

        for rec in self.files:
            if not rec.ovf:
                continue
            u = self._host_uniques(rec)
            if not len(u):
                continue
            base, nhb, off = params_of[id(rec)]
            idx = np.arange(len(u), dtype=np.int64) + off
            bins = base + idx // max(nhb, 1)
            rows = ibf_row_indices_np(
                u, bin_size=ibf_config.bin_size_bits,
                hash_functions=ibf_config.hash_functions,
            )
            for s in range(rows.shape[1]):
                _scatter_bits(out, rows[:, s], bins.astype(np.int64))
        return out

    def close(self):
        self.spill.close()
