"""Index construction engine (ganon-build equivalent).

Reads a ``target_info`` table (``file [<tab> target]`` rows,
reference contract GanonBuild.cpp:86-136), extracts per-target minimizer
sets with the device kernel (long sequences are chunked with ``w-1``
overlap so every window is covered by exactly one chunk pass), sizes the
filter, and builds/saves the IBF.

Reference behaviors kept:
* hashes are deduplicated per *file* (duplicates across files of the same
  target are stored and counted twice — GanonBuild.cpp:225-240),
* sequences shorter than ``min_length`` are skipped,
* a missing/empty input file is a warning, not an error.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ganon_tpu.index.ibf import IBF, build_ibf
from ganon_tpu.io.sequence import SequenceReader
from ganon_tpu.ops.minimizers import (
    encode_seqs,
    window_mins_jax,
    window_mins_unique_jax,
)

# chunk length for device minimizer extraction over long sequences
CHUNK = 1 << 18
# pieces per device dispatch (amortizes dispatch/transfer latency; the
# device link pays a fixed RPC cost per transfer, so bigger is better
# until host memory pressure)
PIECES_PER_BATCH = 32


@dataclass
class BuildStats:
    files: int = 0
    invalid_files: int = 0
    sequences: int = 0
    skipped_sequences: int = 0
    length_bp: int = 0


@dataclass
class BuildConfig:
    input_file: str = ""
    output_file: str = ""
    kmer_size: int = 19
    window_size: int = 31
    max_fp: float = 0.05
    filter_size: float = 0.0
    hash_functions: int = 0
    mode: str = "avg"
    min_length: int = 0
    threads: int = 1
    quiet: bool = True
    verbose: bool = False
    # tpu (npz) | tpu-raw (mmap-able, instant load for huge dbs)
    # | reference (cereal, cross-loadable)
    filter_format: str = "tpu"
    # shard the scatter's bit-matrix over all local devices ("auto":
    # whenever >1 device is visible; results are bit-identical)
    build_mesh: str = "auto"  # auto | off

    def validate(self):
        if not self.input_file:
            raise ValueError("--input-file is mandatory")
        if not self.output_file:
            raise ValueError("--output-file is mandatory")
        if self.hash_functions > 5:
            raise ValueError("--hash-functions must be <=5")
        if self.filter_size == 0 and self.max_fp == 0:
            raise ValueError("--max-fp or --filter-size is mandatory")
        if self.filter_size > 0:
            self.max_fp = 0
        if self.window_size < self.kmer_size:
            raise ValueError("--window-size has to be >= --kmer-size")
        if self.kmer_size > 32:
            raise ValueError("--kmer-size has to be <= 32")
        if self.mode not in ("avg", "smaller", "smallest", "faster", "fastest"):
            raise ValueError("invalid --mode")


def _build_mesh(cfg: BuildConfig):
    """1-D bins mesh over all local devices (None single-device/off).

    The sharded scatter is bit-identical to the single-device path
    (tests/test_device_build.py) and divides per-chip plane memory and
    scatter traffic by the device count — the multi-chip answer to the
    build-at-scale HBM ceiling (see DeviceBuildPipeline.scatter).
    """
    if cfg.build_mesh == "off":
        return None
    import jax

    # local devices: each host builds from its own inputs
    devs = jax.local_devices()
    if len(devs) < 2:
        return None
    from jax.sharding import Mesh

    return Mesh(np.array(devs), ("bins",))


def parse_target_info(
    input_file: str, quiet: bool, stats: BuildStats
) -> dict[str, list[str]]:
    """``file [<tab> target]`` rows -> {target: [files]} (insertion order)."""
    input_map: dict[str, list[str]] = {}
    seen_files = set()
    with open(input_file) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            path = fields[0]
            seen_files.add(path)
            if not os.path.exists(path) or os.path.getsize(path) == 0:
                if not quiet:
                    print(
                        f"WARNING: input file not found/empty: {path}",
                        file=sys.stderr,
                    )
                stats.invalid_files += 1
                continue
            target = fields[1] if len(fields) >= 2 else os.path.basename(path)
            input_map.setdefault(target, []).append(path)
    stats.files = len(seen_files)
    return input_map


def _bucket(n: int, minimum: int = 4096) -> int:
    b = minimum
    while b < n:
        b *= 2
    return min(b, CHUNK)


def _unique_cap(L: int) -> int:
    """Compaction slots per piece: 1/5 of positions (~1.4x the expected
    distinct-minima density of 2/(w-k+2)); overflow falls back."""
    return max(min(L // 5, L), 1024)


@partial(jax.jit, static_argnames=("k", "w", "L", "cap"))
def _extract_packed(packed, lengths, *, k: int, w: int, L: int, cap: int):
    """One-dispatch, one-fetch extraction: 2-bit codes -> packed u32.

    Output layout (B pieces): [B*cap*2] value planes (lo, hi interleaved
    per piece) | [B] n_unique | [B] overflow. A single flat fetch per
    dispatch matters because the device link pays a fixed RPC cost per
    transfer (same single-RPC pattern as classify_batch_packed).
    """
    from ganon_tpu.classify.device import unpack_codes_2bit

    codes = unpack_codes_2bit(packed, L)
    vals, n, ovf = window_mins_unique_jax(codes, lengths, k=k, w=w, cap=cap)
    lo = vals.astype(jnp.uint32)
    hi = (vals >> jnp.uint64(32)).astype(jnp.uint32)
    return jnp.concatenate(
        [
            jnp.stack([lo, hi], axis=-1).reshape(-1),
            n.astype(jnp.uint32),
            ovf.astype(jnp.uint32),
        ]
    )


class _HashExtractor:
    """Batched device minimizer extraction with per-piece dedup.

    Pieces (sequence chunks with ``w-1`` overlap) from any file are
    packed into per-bucket ``[PIECES_PER_BATCH, L]`` buffers; one device
    dispatch extracts sorted-distinct window minima for the whole buffer
    (window_mins_unique_jax), so dispatch/transfer latency amortizes
    over ~8 Mbp instead of one chunk — the reference gets the same
    effect from its thread pool over per-target work items
    (GanonBuild.cpp:184-249). Uploads are 2-bit packed; each dispatch
    returns ONE flat u32 array. Dispatches are double-buffered: the
    fetch of batch i overlaps the device compute of batch i+1.
    """

    def __init__(self, k: int, w: int):
        self.k, self.w = k, w
        self.bufs: dict[int, list] = {}   # bucket L -> [(key, codes)]
        self.pending: list = []           # [(handle, owners, L, ...)]
        self.out: dict[object, list] = {} # key -> [np.uint64 arrays]

    def add(self, key, seq: str) -> None:
        if len(seq) < self.w:
            return
        step = CHUNK - (self.w - 1)
        for s in range(0, max(len(seq) - self.w + 1, 1), step):
            piece = seq[s : s + CHUNK]
            enc, _ = encode_seqs([piece], max_len=len(piece))
            self.add_encoded(key, enc[0])

    def add_encoded(self, key, row: np.ndarray) -> None:
        """Add one dna4-encoded piece (uint8 [n], n <= CHUNK)."""
        if len(row) < self.w:
            return
        L = CHUNK if len(row) == CHUNK else _bucket(len(row))
        buf = self.bufs.setdefault(L, [])
        buf.append((key, row))
        if len(buf) >= PIECES_PER_BATCH:
            self._submit(L)

    def _submit(self, L: int) -> None:
        from ganon_tpu.classify.device import pack_codes_2bit

        buf = self.bufs.pop(L, [])
        if not buf:
            return
        codes = np.zeros((len(buf), L), dtype=np.uint8)
        lengths = np.zeros((len(buf),), dtype=np.int32)
        for i, (_, row) in enumerate(buf):
            codes[i, : len(row)] = row
            lengths[i] = len(row)
        cap = _unique_cap(L)
        packed = _extract_packed(
            pack_codes_2bit(codes), jnp.asarray(lengths),
            k=self.k, w=self.w, L=L, cap=cap,
        )
        self.pending.append((packed, [k for k, _ in buf], cap, codes,
                             lengths))
        if len(self.pending) >= 2:
            self._drain_one()

    def _drain_one(self) -> None:
        packed, owners, cap, codes, lengths = self.pending.pop(0)
        flat = np.asarray(packed)
        B = len(owners)
        planes = flat[: B * cap * 2].view(np.uint64).reshape(B, cap)
        n = flat[B * cap * 2 : B * cap * 2 + B].astype(np.int64)
        ovf = flat[B * cap * 2 + B :].astype(bool)
        for i, key in enumerate(owners):
            if ovf[i]:
                # rare: more distinct minima than the compaction cap —
                # exact fallback fetches the full window-min row
                mv, valid = window_mins_jax(
                    codes[i : i + 1], lengths[i : i + 1], k=self.k, w=self.w
                )
                u = np.unique(np.asarray(mv)[0][np.asarray(valid)[0]])
            else:
                u = planes[i, : n[i]]
            if len(u):
                self.out.setdefault(key, []).append(u)

    def finish(self) -> dict[object, np.ndarray]:
        for L in list(self.bufs):
            self._submit(L)
        while self.pending:
            self._drain_one()
        return {
            key: np.unique(np.concatenate(parts))
            for key, parts in self.out.items()
        }


def sequence_hashes(seq: str, k: int, w: int) -> np.ndarray:
    """Distinct minimizer values of one sequence (device, chunked)."""
    ex = _HashExtractor(k, w)
    ex.add(0, seq)
    res = ex.finish()
    return res.get(0, np.empty(0, dtype=np.uint64))


def _use_native_reader(min_length: int) -> bool:
    if min_length >= CHUNK:
        return False
    try:
        from ganon_tpu.native import NativeSeqReader

        return NativeSeqReader.available()
    except Exception:
        return False


def _file_piece_batches(
    path: str, window_size: int, min_length: int, use_native: bool
):
    """Yield ``(rows, (seqs, skipped, bp))`` batches for one file.

    ``rows`` is a list of dna4-encoded piece arrays (chunks of one or
    more sequences, ``window_size - 1`` overlap between chunks of the
    same sequence). Pure function of the file — safe to run on a reader
    thread (the native parser releases the GIL through ctypes).
    """
    from ganon_tpu.io.pipeline import native_supported

    if use_native and native_supported(path):
        from ganon_tpu.native import NativeSeqReader

        reader = NativeSeqReader(path)
        try:
            while True:
                codes, lens, (seqs, skipped, bp) = reader.next_pieces(
                    PIECES_PER_BATCH, CHUNK, window_size - 1, min_length
                )
                if not len(codes):
                    break
                rows = [codes[i, : lens[i]] for i in range(len(codes))]
                yield rows, (seqs - skipped, skipped, bp)
        finally:
            reader.close()
    else:
        step = CHUNK - (window_size - 1)
        for _id, seq in SequenceReader(path):
            if len(seq) < min_length:
                yield [], (0, 1, 0)
                continue
            rows = []
            if len(seq) >= window_size:
                for s in range(0, max(len(seq) - window_size + 1, 1), step):
                    piece = seq[s : s + CHUNK]
                    enc, _ = encode_seqs([piece], max_len=len(piece))
                    rows.append(enc[0])
            yield rows, (1, 0, len(seq))


def iter_pieces(
    input_map: dict[str, list[str]],
    *,
    window_size: int,
    min_length: int = 0,
    stats: BuildStats | None = None,
    threads: int = 1,
):
    """Yield ``(key=(target, file_index), dna4-encoded piece row)``.

    Pieces are sequence chunks with ``window_size - 1`` overlap so every
    window is covered by exactly one piece. Pieces of one file arrive
    consecutively and files arrive in input order (the bin-split layout
    depends on arrival order, so the stream must be deterministic).
    Uses the native C++ reader (parse + chunk + encode in one pass) when
    available; with ``threads > 1``, reader threads prefetch upcoming
    files in parallel (the reference's thread pool over per-target work
    items, GanonBuild.cpp:810-828) while this generator drains files
    strictly in order.
    """
    stats = stats if stats is not None else BuildStats()
    use_native = _use_native_reader(min_length)
    entries = [
        ((target, fi), path)
        for target, files in input_map.items()
        for fi, path in enumerate(files)
    ]
    if threads > 1 and len(entries) > 1:
        yield from _iter_pieces_parallel(
            entries, window_size, min_length, stats, use_native,
            threads=threads,
        )
        return
    for key, path in entries:
        for rows, (seqs, skipped, bp) in _file_piece_batches(
            path, window_size, min_length, use_native
        ):
            stats.sequences += seqs
            stats.skipped_sequences += skipped
            stats.length_bp += bp
            for row in rows:
                yield key, row


def _iter_pieces_parallel(
    entries, window_size, min_length, stats, use_native, *,
    threads: int, queue_batches: int = 4,
):
    """Reader-thread prefetch behind :func:`iter_pieces`.

    Each worker claims the next unclaimed file (bounded to a lookahead
    window past the consumer position, so buffered batches stay
    bounded: ~lookahead x queue_batches x PIECES_PER_BATCH pieces) and
    streams its batches into that file's own bounded queue; the
    consumer drains file queues strictly in input order, so the yielded
    stream is identical to the serial path's.
    """
    import queue as queue_mod
    import threading

    n = len(entries)
    threads = min(threads, n)
    lookahead = threading.Semaphore(threads * 2)
    stop = threading.Event()
    next_file = [0]
    claim_lock = threading.Lock()
    stats_lock = threading.Lock()
    queues = [queue_mod.Queue(maxsize=queue_batches) for _ in range(n)]
    _DONE = object()

    def _put(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        while not stop.is_set():
            lookahead.acquire()
            with claim_lock:
                i = next_file[0]
                if i >= n:
                    lookahead.release()
                    return
                next_file[0] = i + 1
            _, path = entries[i]
            q = queues[i]
            try:
                for rows, deltas in _file_piece_batches(
                    path, window_size, min_length, use_native
                ):
                    with stats_lock:
                        stats.sequences += deltas[0]
                        stats.skipped_sequences += deltas[1]
                        stats.length_bp += deltas[2]
                    if rows and not _put(q, rows):
                        return
                _put(q, _DONE)
            except BaseException as e:  # surfaced by the consumer
                _put(q, e)

    workers = [
        threading.Thread(target=worker, daemon=True) for _ in range(threads)
    ]
    for t in workers:
        t.start()
    try:
        for i in range(n):
            key = entries[i][0]
            q = queues[i]
            while True:
                item = q.get()
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                for row in item:
                    yield key, row
            lookahead.release()  # let workers claim one more file ahead
    finally:
        stop.set()
        for t in workers:
            t.join(timeout=10)


def count_target_hashes(
    input_map: dict[str, list[str]],
    *,
    kmer_size: int,
    window_size: int,
    min_length: int = 0,
    stats: BuildStats | None = None,
    threads: int = 1,
) -> dict[str, np.ndarray]:
    """{target: concatenated per-file unique minimizer arrays}.

    Reference semantics: dedup within a file; duplicates across files of
    the same target are stored and counted twice (GanonBuild.cpp:225-240).
    Host-array variant (fetches the hashes); the production ``run_build``
    path uses the device-resident DeviceBuildPipeline instead.
    """
    stats = stats if stats is not None else BuildStats()
    ex = _HashExtractor(kmer_size, window_size)
    file_keys: dict[str, list] = {}
    for target, files in input_map.items():
        file_keys[target] = [(target, fi) for fi in range(len(files))]
    for key, row in iter_pieces(
        input_map, window_size=window_size, min_length=min_length,
        stats=stats, threads=threads,
    ):
        ex.add_encoded(key, row)
    per_file = ex.finish()
    out: dict[str, np.ndarray] = {}
    for target, keys in file_keys.items():
        parts = [per_file[k] for k in keys if k in per_file]
        out[target] = (
            np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)
        )
    return out


def _use_device_pipeline() -> bool:
    """The device-resident pipeline exists to avoid host<->device
    transfers; on the CPU backend those are memcpys and the host-array
    path is faster (XLA CPU sorts are slow). Override with
    GANON_TPU_BUILD_PIPELINE={device,host}."""
    mode = os.environ.get("GANON_TPU_BUILD_PIPELINE", "")
    if mode in ("device", "host"):
        return mode == "device"
    import jax

    return jax.default_backend() != "cpu"


def run_build(cfg: BuildConfig) -> IBF:
    """Full ganon-build equivalent: parse, count, size, build, save.

    On an accelerator the compute path is the device-resident two-pass
    pipeline (index.device_build): per-piece extraction, per-file
    dedup/count and the bin-split scatter all run on device; the host
    fetches 4 bytes per file plus the final bit-matrix. Output is
    bit-identical to the host-array path (``build_ibf``), which serves
    the CPU backend.
    """
    import time as _time

    cfg.validate()
    stats = BuildStats()
    phases: list[tuple[str, float]] = []  # StopClock analogue
    t_phase = _time.time()

    def _mark(name: str) -> None:
        nonlocal t_phase
        now = _time.time()
        phases.append((name, now - t_phase))
        t_phase = now

    input_map = parse_target_info(cfg.input_file, cfg.quiet, stats)
    if not input_map:
        raise ValueError("No valid input files")

    if not _use_device_pipeline():
        target_hashes = count_target_hashes(
            input_map,
            kmer_size=cfg.kmer_size,
            window_size=cfg.window_size,
            min_length=cfg.min_length,
            stats=stats,
            threads=cfg.threads,
        )
        _mark("Count")
        target_hashes = {t: h for t, h in target_hashes.items() if len(h)}
        if not target_hashes:
            raise ValueError("No valid sequences to build")
        ibf = build_ibf(
            target_hashes,
            kmer_size=cfg.kmer_size,
            window_size=cfg.window_size,
            max_fp=cfg.max_fp,
            filter_size=cfg.filter_size,
            hash_functions=cfg.hash_functions,
            mode=cfg.mode,
        )
        _mark("EstimateParams/BuildIBF")
        return _finish_build(cfg, ibf, stats, phases, _mark)

    from ganon_tpu.index import sizing
    from ganon_tpu.index.device_build import DeviceBuildPipeline

    pipe = DeviceBuildPipeline(cfg.kmer_size, cfg.window_size)
    try:
        for key, row in iter_pieces(
            input_map, window_size=cfg.window_size,
            min_length=cfg.min_length, stats=stats, threads=cfg.threads,
        ):
            pipe.add_encoded(key, row)
        _mark("Ingest")
        pipe.finish_counts()
        _mark("Count")
        # drop targets with zero hashes (sequences all too short)
        hashes_count = {t: c for t, c in pipe.hashes_count().items() if c}
        if not hashes_count:
            raise ValueError("No valid sequences to build")
        icfg = sizing.size_filter(
            hashes_count,
            kmer_size=cfg.kmer_size,
            window_size=cfg.window_size,
            max_fp=cfg.max_fp,
            filter_size=cfg.filter_size,
            hash_functions=cfg.hash_functions,
            mode=cfg.mode,
        )
        _mark("EstimateParams")
        splits = sizing.split_target_bins(icfg, hashes_count)
        bits = pipe.scatter(icfg, mesh=_build_mesh(cfg))
        _mark("BuildIBF")
    finally:
        pipe.close()
    ibf = IBF(
        bits, icfg, hashes_count,
        [(binno, target) for binno, target, _, _ in splits],
    )
    return _finish_build(cfg, ibf, stats, phases, _mark)


def _finish_build(cfg: BuildConfig, ibf: IBF, stats: BuildStats,
                  phases=None, mark=None) -> IBF:
    if cfg.output_file:
        if cfg.filter_format == "reference":
            from ganon_tpu.index import serialize

            serialize.write_ibf(ibf, cfg.output_file)
        elif cfg.filter_format == "tpu-raw":
            ibf.save_raw(cfg.output_file)
        else:
            ibf.save(cfg.output_file)
        if mark is not None:
            mark("WriteIBF")
    if not cfg.quiet:
        c = ibf.ibf_config
        mb = (len(ibf.bits.tobytes())) / 1048576
        total = sum(d for _, d in phases or [])
        mbpm = (stats.length_bp / 1e6) / (total / 60) if total else 0.0
        if cfg.verbose and phases:
            # reference StopClock phase report (GanonBuild.cpp:722-748)
            for name, dur in phases:
                print(f" - {name}: {dur:.2f}s", file=sys.stderr)
        print(
            f"ganon-tpu build processed {stats.sequences} sequences "
            f"({stats.length_bp / 1e6:.2f} Mbp) in {total:.2f}s "
            f"({mbpm:,.1f} Mbp/m) — max fp {c.true_max_fp:.4f} "
            f"(avg {c.true_avg_fp:.4f}), filter size {mb:.2f}MB",
            file=sys.stderr,
        )
    return ibf
