"""Reference-compatible ``.ibf`` codec (cereal binary archive).

Byte-level reader/writer for the filter files produced and consumed by the
reference C++ binaries, so databases can be cross-loaded in both directions.

Layout (reference write: ``GanonBuild.cpp:251-288``; read:
``GanonClassify.cpp:949-986``). cereal's BinaryOutputArchive emits raw
little-endian bytes with no padding or tags; ``std::tuple`` elements are
written in order, strings and vectors are length-prefixed with a ``uint64``:

  1. version        tuple<int,int,int>           3 x i32
  2. ibf_config     IBFConfig                    u64 n_bins, u64 max_hashes_bin,
                                                 u8 hash_functions, u8 kmer_size,
                                                 u16 window_size, u64 bin_size_bits,
                                                 f64 max_fp, f64 true_max_fp,
                                                 f64 true_avg_fp
                                                 (``IBFConfig.hpp:18-40``)
  3. hashes_count   vector<tuple<string,u64>>    u64 n; per elem u64 len+bytes, u64
  4. bin_map        vector<tuple<u64,string>>    u64 n; per elem u64, u64 len+bytes
  5. seqan3 IBF     6 x u64 header               bins, technical_bins, bin_size,
                                                 hash_shift, bin_words, hash_funs
     sdsl bit_vector                             u64 m_size (bits), u8 m_width (=1),
                                                 ceil(m_size/64) x u64 words

The sdsl tail (5.) is the one part whose layout we cannot read off the
reference tree (the seqan3 submodule is not vendored); the parser therefore
self-validates — every header field is re-derivable from ``ibf_config`` and
the word count must exactly consume the file — and tolerates the two known
sdsl int_vector serializations (with/without the width byte).

Bit semantics: bit ``row * technical_bins + bin`` set means hash-row ``row``
hits technical bin ``bin``. With technical_bins a multiple of 64, the
little-endian u64 word stream reinterpreted as u32 yields exactly our
``uint32[bin_size, technical_bins/32]`` layout (ops/ibf_query.py docstring).
The hash family (seeds, xor-shift, golden multiply, fastrange) already
matches seqan3's ``hash_and_fit``, so cross-loaded filters produce
bit-identical counts.
"""

from __future__ import annotations

import struct

import numpy as np

from ganon_tpu.index.config import IBFConfig
from ganon_tpu.index.ibf import IBF
from ganon_tpu.ops.ibf_query import clz64

# version written into new files (tracks the reference release whose layout
# this implements)
VERSION = (2, 1, 1)

_IBFCONFIG_FMT = "<QQBBHQddd"  # no padding: cereal writes fields back-to-back


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise ValueError(
                f"truncated cereal archive: need {n} bytes at offset "
                f"{self.off}, file has {len(self.buf)}"
            )
        out = self.buf[self.off : self.off + n]
        self.off += n
        return out

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def u8(self) -> int:
        return self.take(1)[0]

    def string(self) -> str:
        n = self.u64()
        if n > len(self.buf):
            raise ValueError(f"implausible string length {n} at {self.off - 8}")
        return self.take(n).decode()

    def remaining(self) -> int:
        return len(self.buf) - self.off


def read_ibf(path: str) -> IBF:
    """Parse a reference-format ``.ibf`` into our :class:`IBF`."""
    with open(path, "rb") as f:
        r = _Reader(f.read())

    version = (r.i32(), r.i32(), r.i32())
    if not all(0 <= v < 1000 for v in version):
        raise ValueError(f"{path}: implausible version tuple {version}; "
                         "not a reference cereal .ibf?")
    cfg_fields = struct.unpack(_IBFCONFIG_FMT, r.take(struct.calcsize(_IBFCONFIG_FMT)))
    (n_bins, max_hashes_bin, hash_functions, kmer_size, window_size,
     bin_size_bits, max_fp, true_max_fp, true_avg_fp) = cfg_fields

    n = r.u64()
    hashes_count = {}
    for _ in range(n):
        t = r.string()
        hashes_count[t] = r.u64()
    n = r.u64()
    bin_map = []
    for _ in range(n):
        binno = r.u64()
        bin_map.append((binno, r.string()))

    # seqan3 interleaved_bloom_filter header (all size_t)
    bins = r.u64()
    technical_bins = r.u64()
    bin_size = r.u64()
    hash_shift = r.u64()
    bin_words = r.u64()
    hash_funs = r.u64()
    expect_tb = -(-n_bins // 64) * 64
    checks = {
        "bins": (bins, n_bins),
        "technical_bins": (technical_bins, expect_tb),
        "bin_size": (bin_size, bin_size_bits),
        "hash_shift": (hash_shift, clz64(bin_size_bits)),
        "bin_words": (bin_words, expect_tb // 64),
        "hash_funs": (hash_funs, hash_functions),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad:
        raise ValueError(
            f"{path}: seqan3 IBF header does not match IBFConfig "
            f"(got, expected): {bad} — unknown layout variant"
        )

    # sdsl bit_vector: m_size (+ optional m_width byte) + words
    m_size = r.u64()
    n_words = -(-m_size // 64)
    if m_size != technical_bins * bin_size:
        raise ValueError(
            f"{path}: sdsl bit count {m_size} != technical_bins*bin_size "
            f"{technical_bins * bin_size}"
        )
    if r.remaining() == n_words * 8 + 1:
        width = r.u8()
        if width != 1:
            raise ValueError(f"{path}: sdsl bit_vector width {width} != 1")
    elif r.remaining() != n_words * 8:
        raise ValueError(
            f"{path}: trailing {r.remaining()} bytes, expected "
            f"{n_words * 8} (+1 width byte) for {m_size} bits"
        )
    data = np.frombuffer(r.take(n_words * 8), dtype="<u8")

    bits = (
        data.reshape(bin_size, technical_bins // 64)
        .view(np.uint32)
        .astype(np.uint32, copy=True)
    )
    cfg = IBFConfig(
        kmer_size=kmer_size,
        window_size=window_size,
        max_fp=max_fp,
        n_bins=n_bins,
        max_hashes_bin=max_hashes_bin,
        hash_functions=hash_functions,
        bin_size_bits=bin_size_bits,
        true_max_fp=true_max_fp,
        true_avg_fp=true_avg_fp,
    )
    return IBF(bits, cfg, hashes_count, [(int(b), t) for b, t in bin_map])


def write_ibf(ibf: IBF, path: str, *, version=VERSION) -> None:
    """Write our :class:`IBF` as a reference-format cereal ``.ibf``."""
    cfg = ibf.ibf_config
    technical_bins = ibf.technical_bins
    if technical_bins % 64:
        raise ValueError("technical bin count must be a multiple of 64")
    out = bytearray()
    out += struct.pack("<iii", *version)
    out += struct.pack(
        _IBFCONFIG_FMT,
        cfg.n_bins,
        cfg.max_hashes_bin,
        cfg.hash_functions,
        cfg.kmer_size,
        cfg.window_size,
        cfg.bin_size_bits,
        cfg.max_fp,
        cfg.true_max_fp,
        cfg.true_avg_fp,
    )
    out += struct.pack("<Q", len(ibf.hashes_count))
    for t, c in ibf.hashes_count.items():
        b = t.encode()
        out += struct.pack("<Q", len(b)) + b + struct.pack("<Q", c)
    out += struct.pack("<Q", len(ibf.bin_map))
    for binno, t in ibf.bin_map:
        b = t.encode()
        out += struct.pack("<QQ", binno, len(b)) + b
    bin_size = cfg.bin_size_bits
    out += struct.pack(
        "<QQQQQQ",
        cfg.n_bins,
        technical_bins,
        bin_size,
        clz64(bin_size),
        technical_bins // 64,
        cfg.hash_functions,
    )
    m_size = technical_bins * bin_size
    out += struct.pack("<Q", m_size) + bytes([1])  # m_size, m_width
    words = np.ascontiguousarray(ibf.bits).view("<u8")
    out += words.tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))


def _read_seqan3_ibf(r: "_Reader", width_byte: bool = False):
    """One seqan3 interleaved_bloom_filter from a cereal stream.

    Returns ``(bits uint32[bin_size, technical_bins/32], bins, bin_size,
    hash_funs)``. ``width_byte`` selects the sdsl bit_vector
    serialization variant (with/without a trailing width u8 after the
    size); the caller resolves it by attempting the whole archive with
    each variant — a local peek is ambiguous since the first data byte
    can legitimately be 1.
    """
    bins = r.u64()
    technical_bins = r.u64()
    bin_size = r.u64()
    hash_shift = r.u64()
    bin_words = r.u64()
    hash_funs = r.u64()
    if (
        technical_bins % 64
        or bin_words != technical_bins // 64
        or hash_shift != clz64(max(bin_size, 1))
        or not (0 < hash_funs <= 5)
        or bins > technical_bins
    ):
        raise ValueError(
            "implausible seqan3 IBF header "
            f"(bins={bins}, tb={technical_bins}, size={bin_size}, "
            f"shift={hash_shift}, words={bin_words}, funs={hash_funs})"
        )
    m_size = r.u64()
    if m_size != technical_bins * bin_size:
        raise ValueError(
            f"sdsl bit count {m_size} != technical_bins*bin_size"
        )
    n_words = -(-m_size // 64)
    if width_byte:
        width = r.u8()
        if width != 1:
            raise ValueError(f"sdsl bit_vector width {width} != 1")
    data = np.frombuffer(r.take(n_words * 8), dtype="<u8")
    bits = (
        data.reshape(bin_size, technical_bins // 64)
        .view(np.uint32)
        .astype(np.uint32, copy=True)
    )
    return bits, bins, bin_size, hash_funs


def read_raptor_hibf(path: str):
    """Parse a raptor-format ``.hibf`` index (the files 'ganon build-custom
    --filter-type hibf' produces through raptor).

    Layout (reference read: GanonClassify.cpp:875-938; HIBF serialize:
    hierarchical_interleaved_bloom_filter.hpp:163-168,293-298): cereal
    binary archive of (u32 version, u64 window, seqan3::shape, u8 parts,
    bool compressed, vector<vector<string>> bin_path, f64 fpr,
    bool is_hibf, HIBF{ibf_vector, next_ibf_id,
    user_bins{user_bin_filenames, ibf_bin_to_filename_position}}).

    Returns a dict with keys: window_size, kmer_size, fpr, targets (one
    per user bin, '.minimiser' suffix stripped and the '|||'/'---' name
    mangling undone, GanonClassify.cpp:920-928), ibfs (list of
    (bits, bins, bin_size, hash_funs)), next_ibf_id, bin_to_filename.
    """
    with open(path, "rb") as f:
        buf = f.read()
    first_error = None
    for width_byte in (False, True):
        try:
            return _read_raptor_hibf_buf(buf, path, width_byte)
        except ValueError as e:
            if first_error is None:
                first_error = e
    raise first_error


def _read_raptor_hibf_buf(buf: bytes, path: str, width_byte: bool):
    r = _Reader(buf)
    version = struct.unpack("<I", r.take(4))[0]
    if version > 1000:
        raise ValueError(f"{path}: implausible raptor index version {version}")
    window_size = r.u64()
    # seqan3::shape (dynamic_bitset): u64 size then u64 bits — tolerate
    # the swapped order by plausibility
    a, b = r.u64(), r.u64()
    if 0 < a <= 58 and b < (1 << a):
        size, sbits = a, b
    elif 0 < b <= 58 and a < (1 << b):
        size, sbits = b, a
    else:
        raise ValueError(f"{path}: cannot decode seqan3 shape ({a}, {b})")
    kmer_size = bin(sbits).count("1")
    parts = r.u8()
    compressed = r.u8()
    if compressed:
        raise ValueError(f"{path}: compressed raptor indexes not supported")
    n_outer = r.u64()
    if n_outer > 1 << 32:
        raise ValueError(f"{path}: implausible bin_path size {n_outer}")
    bin_path = []
    for _ in range(n_outer):
        m = r.u64()
        bin_path.append([r.string() for _ in range(m)])
    fpr = struct.unpack("<d", r.take(8))[0]
    is_hibf = r.u8()
    if not is_hibf:
        raise ValueError(f"{path}: raptor index without is_hibf flag")

    n_ibfs = r.u64()
    if n_ibfs > 1 << 20:
        raise ValueError(f"{path}: implausible IBF count {n_ibfs}")
    ibfs = [_read_seqan3_ibf(r, width_byte) for _ in range(n_ibfs)]
    next_ibf_id = []
    for _ in range(r.u64()):
        m = r.u64()
        next_ibf_id.append(
            np.frombuffer(r.take(m * 8), dtype="<i8").astype(np.int64)
        )
    n_files = r.u64()
    filenames = [r.string() for _ in range(n_files)]
    bin_to_filename = []
    for _ in range(r.u64()):
        m = r.u64()
        bin_to_filename.append(
            np.frombuffer(r.take(m * 8), dtype="<i8").astype(np.int64)
        )
    if r.remaining():
        raise ValueError(f"{path}: {r.remaining()} trailing bytes")

    def unmangle(name: str) -> str:
        import os

        f = os.path.basename(name)
        found = f.find(".minimiser")
        if found != -1:
            f = f[:found]
        return f.replace("|||", ".").replace("---", " ")

    targets = [unmangle(f) for f in filenames]
    del parts, bin_path  # parsed for layout fidelity; not needed downstream
    return {
        "window_size": int(window_size),
        "kmer_size": int(kmer_size),
        "shape_size": int(size),
        "fpr": float(fpr),
        "targets": targets,
        "raw_filenames": filenames,  # mangled on-disk names (re-serialize)
        "ibfs": ibfs,
        "next_ibf_id": next_ibf_id,
        "bin_to_filename": bin_to_filename,
    }


def write_raptor_hibf(
    path: str,
    *,
    window_size: int,
    kmer_size: int,
    fpr: float,
    filenames: list[str],
    ibfs,
    next_ibf_id,
    bin_to_filename,
    version: int = 3,
) -> None:
    """Write a raptor-format ``.hibf`` (layout of :func:`read_raptor_hibf`).

    ``ibfs`` is a list of ``(bits uint32[bin_size, tb/32], bins,
    hash_funs)``.
    Enables exporting hierarchical filters built here for the reference
    binaries, and round-trips the reader in tests.
    """
    out = bytearray()
    out += struct.pack("<I", version)
    out += struct.pack("<Q", window_size)
    out += struct.pack("<QQ", kmer_size, (1 << kmer_size) - 1)  # shape
    out += bytes([1])  # parts
    out += bytes([0])  # compressed
    out += struct.pack("<Q", len(filenames))  # bin_path: one file per bin
    for f in filenames:
        b = f.encode()
        out += struct.pack("<Q", 1) + struct.pack("<Q", len(b)) + b
    out += struct.pack("<d", fpr)
    out += bytes([1])  # is_hibf
    out += struct.pack("<Q", len(ibfs))
    for bits, bins, hash_funs in ibfs:
        bin_size, n_words32 = bits.shape
        technical_bins = n_words32 * 32
        if technical_bins % 64:
            raise ValueError("technical bins must be a multiple of 64")
        out += struct.pack(
            "<QQQQQQ",
            bins,
            technical_bins,
            bin_size,
            clz64(bin_size),
            technical_bins // 64,
            hash_funs,
        )
        out += struct.pack("<Q", technical_bins * bin_size)
        out += np.ascontiguousarray(bits).view("<u8").tobytes()
    out += struct.pack("<Q", len(next_ibf_id))
    for v in next_ibf_id:
        arr = np.asarray(v, dtype="<i8")
        out += struct.pack("<Q", len(arr)) + arr.tobytes()
    out += struct.pack("<Q", len(filenames))
    for f in filenames:
        b = f.encode()
        out += struct.pack("<Q", len(b)) + b
    out += struct.pack("<Q", len(bin_to_filename))
    for v in bin_to_filename:
        arr = np.asarray(v, dtype="<i8")
        out += struct.pack("<Q", len(arr)) + arr.tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))


def is_raptor_hibf(path: str) -> bool:
    """Sniff: u32 version + u64 window + decodable shape."""
    try:
        with open(path, "rb") as f:
            head = f.read(28)
        if len(head) < 28:
            return False
        version, window = struct.unpack("<IQ", head[:12])
        a, b = struct.unpack("<QQ", head[12:28])
        if version > 1000 or not (0 < window < 1 << 16):
            return False
        return (0 < a <= 58 and b < (1 << a)) or (
            0 < b <= 58 and a < (1 << b)
        )
    except OSError:
        return False


def is_cereal_ibf(path: str) -> bool:
    """Cheap sniff: plausible version tuple + IBFConfig at the head."""
    try:
        with open(path, "rb") as f:
            head = f.read(12 + struct.calcsize(_IBFCONFIG_FMT))
        if len(head) < 12 + struct.calcsize(_IBFCONFIG_FMT):
            return False
        ver = struct.unpack("<iii", head[:12])
        if not all(0 <= v < 1000 for v in ver):
            return False
        (n_bins, _mh, hf, k, w, bsb, max_fp, _tm, _ta) = struct.unpack(
            _IBFCONFIG_FMT, head[12:]
        )
        return (
            0 < n_bins < 1 << 40
            and 0 < hf <= 5
            and 0 < k <= 32
            and k <= w < 1 << 16
            and bsb > 0
            and 0 < max_fp <= 1
        )
    except OSError:
        return False
