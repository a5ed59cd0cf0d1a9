"""Device-resident build pipeline: bit-identical to the host-array path."""

import numpy as np
import pytest

from ganon_tpu.index import sizing
from ganon_tpu.index.device_build import DeviceBuildPipeline
from ganon_tpu.index.ibf import build_ibf
from ganon_tpu.ops.minimizers import encode_seqs

K, W = 19, 31
BASES = "ACGT"


def _random_seq(rng, n):
    return "".join(BASES[b] for b in rng.integers(0, 4, size=n))


def _host_path(seq_files, **kw):
    """Reference host path: per-file unique hashes -> build_ibf."""
    from ganon_tpu.index.builder import sequence_hashes

    target_hashes = {}
    for target, files in seq_files.items():
        parts = []
        for seqs in files:
            hs = [sequence_hashes(s, K, W) for s in seqs]
            hs = [h for h in hs if len(h)]
            if hs:
                parts.append(np.unique(np.concatenate(hs)))
        target_hashes[target] = (
            np.concatenate(parts) if parts else np.empty(0, np.uint64)
        )
    target_hashes = {t: h for t, h in target_hashes.items() if len(h)}
    return build_ibf(target_hashes, kmer_size=K, window_size=W, **kw)


def _device_path(seq_files, **kw):
    pipe = DeviceBuildPipeline(K, W)
    try:
        for target, files in seq_files.items():
            for fi, seqs in enumerate(files):
                for s in seqs:
                    enc, _ = encode_seqs([s], max_len=len(s))
                    pipe.add_sequence((target, fi), enc[0])
        pipe.finish_counts()
        hashes_count = {t: c for t, c in pipe.hashes_count().items() if c}
        # the one shared sizing entry point (same as build_ibf / run_build)
        icfg = sizing.size_filter(
            hashes_count, kmer_size=K, window_size=W,
            max_fp=kw.get("max_fp", 0.05),
            filter_size=kw.get("filter_size", 0.0),
            hash_functions=kw.get("hash_functions", 0),
            mode=kw.get("mode", "avg"),
        )
        bits = pipe.scatter(icfg)
        return bits, hashes_count, icfg
    finally:
        pipe.close()


def _mkinput(rng, n_targets=3, files_per_target=2, seqs_per_file=2,
             seq_len=4000):
    return {
        f"T{t}": [
            [_random_seq(rng, seq_len) for _ in range(seqs_per_file)]
            for _ in range(files_per_target)
        ]
        for t in range(n_targets)
    }


def test_counts_match_host():
    rng = np.random.default_rng(7)
    seq_files = _mkinput(rng)
    ibf = _host_path(seq_files, max_fp=0.05)
    _, hashes_count, _ = _device_path(seq_files, max_fp=0.05)
    assert hashes_count == ibf.hashes_count


def test_bits_identical_to_host():
    rng = np.random.default_rng(8)
    seq_files = _mkinput(rng)
    ibf = _host_path(seq_files, max_fp=0.05)
    bits, hashes_count, icfg = _device_path(seq_files, max_fp=0.05)
    assert icfg.bin_size_bits == ibf.ibf_config.bin_size_bits
    assert icfg.n_bins == ibf.ibf_config.n_bins
    assert bits.shape == ibf.bits.shape
    assert np.array_equal(bits, ibf.bits)


def test_bits_identical_multibin_split():
    """Small max_hashes_bin forces targets across several technical bins
    (index-range split consistency across files)."""
    rng = np.random.default_rng(9)
    seq_files = _mkinput(rng, n_targets=2, files_per_target=3,
                         seqs_per_file=1, seq_len=9000)
    # filter_size path -> small bins, multiple splits
    ibf = _host_path(seq_files, max_fp=0.05)
    assert ibf.ibf_config.n_bins >= 2
    bits, _, icfg = _device_path(seq_files, max_fp=0.05)
    assert np.array_equal(bits, ibf.bits)


def test_duplicate_across_files_double_counted():
    """Reference: dedup within a file; across files of one target the
    same hash is stored and counted twice (GanonBuild.cpp:225-240)."""
    rng = np.random.default_rng(10)
    s = _random_seq(rng, 3000)
    seq_files = {"T0": [[s], [s]]}
    _, hashes_count, _ = _device_path(seq_files, max_fp=0.05)
    ibf = _host_path(seq_files, max_fp=0.05)
    assert hashes_count["T0"] == ibf.hashes_count["T0"]
    from ganon_tpu.index.builder import sequence_hashes

    n1 = len(sequence_hashes(s, K, W))
    assert hashes_count["T0"] == 2 * n1


def test_cache_trim_reextraction():
    """Dropping the device cache forces pass-2 re-extraction from the
    spill; results stay identical."""
    rng = np.random.default_rng(11)
    seq_files = _mkinput(rng, n_targets=2, files_per_target=1,
                         seqs_per_file=2, seq_len=5000)
    ibf = _host_path(seq_files, max_fp=0.05)

    pipe = DeviceBuildPipeline(K, W, device_cache_bytes=0)  # trim everything
    try:
        for target, files in seq_files.items():
            for fi, seqs in enumerate(files):
                for s in seqs:
                    enc, _ = encode_seqs([s], max_len=len(s))
                    pipe.add_sequence((target, fi), enc[0])
        pipe.finish_counts()
        hashes_count = {t: c for t, c in pipe.hashes_count().items() if c}
        assert hashes_count == ibf.hashes_count
        bits = pipe.scatter(ibf.ibf_config)
        assert np.array_equal(bits, ibf.bits)
    finally:
        pipe.close()


def test_long_sequence_chunking():
    """A sequence spanning multiple CHUNK pieces dedups across pieces."""
    rng = np.random.default_rng(12)
    from ganon_tpu.index.device_build import CHUNK

    s = _random_seq(rng, CHUNK + CHUNK // 2)
    seq_files = {"T0": [[s]]}
    ibf = _host_path(seq_files, max_fp=0.05)
    bits, hashes_count, _ = _device_path(seq_files, max_fp=0.05)
    assert hashes_count == ibf.hashes_count
    assert np.array_equal(bits, ibf.bits)


def test_run_build_device_matches_host(tmp_path, monkeypatch):
    """run_build with the device pipeline writes the same .ibf as the
    host-array path (CLI-level A/B on the reference mini data)."""
    import glob

    from ganon_tpu.index.builder import BuildConfig, run_build
    from ganon_tpu.index.ibf import IBF

    D = "/root/reference/tests/ganon/data/build-custom/files"
    files = sorted(glob.glob(D + "/*.fna.gz"))[:2]
    if not files:
        pytest.skip("reference mini data unavailable")
    ti = tmp_path / "ti.tsv"
    ti.write_text("".join(f"{f}\t{i}\n" for i, f in enumerate(files)))

    outs = {}
    for mode in ("host", "device"):
        monkeypatch.setenv("GANON_TPU_BUILD_PIPELINE", mode)
        out = tmp_path / f"db_{mode}.ibf"
        run_build(BuildConfig(input_file=str(ti), output_file=str(out)))
        outs[mode] = IBF.load(str(out))
    assert outs["host"].hashes_count == outs["device"].hashes_count
    assert np.array_equal(outs["host"].bits, outs["device"].bits)
    assert outs["host"].bin_map == outs["device"].bin_map


def test_bits_identical_chunked_plane(monkeypatch):
    """Large-filter path: the scatter plane split into row-range chunks
    must produce the same bit-matrix as the single-pass plane."""
    from ganon_tpu.index import device_build

    rng = np.random.default_rng(12)
    seq_files = _mkinput(rng, n_targets=4)
    ibf = _host_path(seq_files, max_fp=0.05)
    monkeypatch.setattr(device_build, "PLANE_CHUNK_BYTES", 1 << 16)
    bits, _, icfg = _device_path(seq_files, max_fp=0.05)
    assert np.array_equal(bits, ibf.bits)


def test_scatter_mesh_identical_to_single_device():
    """The mesh-sharded scatter (bits row-sharded over a 'bins' axis,
    shard-local scatters offset by axis_index) produces a bit-identical
    matrix to the single-device chunked scatter, including when
    bin_size does not divide the shard count (padded rows trimmed)."""
    import jax
    from jax.sharding import Mesh

    rng = np.random.default_rng(17)
    seq_files = _mkinput(rng)

    def run(mesh):
        pipe = DeviceBuildPipeline(K, W)
        try:
            for target, files in seq_files.items():
                for fi, seqs in enumerate(files):
                    for s in seqs:
                        enc, _ = encode_seqs([s], max_len=len(s))
                        pipe.add_sequence((target, fi), enc[0])
            pipe.finish_counts()
            hashes_count = {
                t: c for t, c in pipe.hashes_count().items() if c
            }
            icfg = sizing.size_filter(
                hashes_count, kmer_size=K, window_size=W, max_fp=0.05
            )
            # force an odd row count so the shard split needs padding
            icfg.bin_size_bits |= 1
            return pipe.scatter(icfg, mesh=mesh), icfg
        finally:
            pipe.close()

    single, icfg = run(None)
    mesh8 = Mesh(np.asarray(jax.devices()).reshape(-1), ("bins",))
    sharded, icfg2 = run(mesh8)
    assert icfg.bin_size_bits == icfg2.bin_size_bits
    assert icfg.bin_size_bits % len(jax.devices())  # exercises padding
    assert single.shape == sharded.shape
    assert np.array_equal(single, sharded)
    # a 2-D (batch, bins) mesh flattens onto the build's 1-D bins axis
    from ganon_tpu.parallel.mesh import make_mesh

    sharded2, _ = run(make_mesh(jax.devices()))
    assert np.array_equal(single, sharded2)


def test_count_pass_multidevice_identical_to_single(monkeypatch):
    """Group-parallel counting (close groups round-robin over all 8
    virtual devices) must be bit-identical to the single-device pipeline
    — counts AND scattered bits (GanonBuild.cpp:655-698 bin-parallel
    build analogue). CLOSE_ROWS is shrunk so several groups form."""
    import jax

    from ganon_tpu.index import device_build

    monkeypatch.setattr(device_build, "CLOSE_ROWS", 4)
    rng = np.random.default_rng(23)
    seq_files = _mkinput(rng, n_targets=5, files_per_target=2,
                         seqs_per_file=2, seq_len=3000)

    def run(devs):
        pipe = DeviceBuildPipeline(K, W, devices=devs)
        try:
            for target, files in seq_files.items():
                for fi, seqs in enumerate(files):
                    for s in seqs:
                        enc, _ = encode_seqs([s], max_len=len(s))
                        pipe.add_sequence((target, fi), enc[0])
            pipe.finish_counts()
            hashes_count = {
                t: c for t, c in pipe.hashes_count().items() if c
            }
            icfg = sizing.size_filter(
                hashes_count, kmer_size=K, window_size=W, max_fp=0.05
            )
            return hashes_count, pipe.scatter(icfg)
        finally:
            pipe.close()

    assert len(jax.devices()) == 8
    h1, b1 = run([jax.devices()[0]])
    h8, b8 = run(list(jax.devices()))
    assert h1 == h8
    assert np.array_equal(b1, b8)


# -- sorts far longer than one 2^18-entry column ----------------------------
# The build's dedup sorts are plain rank-1 lax.sort calls; these cases push
# each sort past 2^18 entries (the column length of the columnsort they
# replaced) and compare with an independent path.


@pytest.mark.parametrize("n_targets,files_per_target,seq_len", [
    (1, 1, 600_000),  # one file of three 2^18 bp pieces
    (3, 1, 250_000),
    (1, 3, 200_000),  # the same target's files counted twice
])
def test_device_pipeline_equals_host_past_old_sort_boundary(
        n_targets, files_per_target, seq_len):
    rng = np.random.default_rng(seq_len + n_targets)
    seq_files = _mkinput(rng, n_targets=n_targets,
                         files_per_target=files_per_target, seqs_per_file=1,
                         seq_len=seq_len)
    ibf = _host_path(seq_files, max_fp=0.05)
    bits, hashes_count, _ = _device_path(seq_files, max_fp=0.05)
    assert hashes_count == ibf.hashes_count
    assert np.array_equal(bits, ibf.bits)


@pytest.mark.parametrize("layout,fine_h", [("ibf", 4), ("pruned", 1),
                                           ("pruned", 2)])
def test_sort_scatter_equals_numpy_past_old_sort_boundary(layout, fine_h):
    """The jitted sort + dedup + scatter-OR equals a numpy scatter of the
    same inserts, with more than 2^18 inserts in one sort."""
    from ganon_tpu.index.ibf import _scatter_bits
    from ganon_tpu.index.pruned import build_pruned
    from ganon_tpu.ops.ibf_query import ibf_row_indices_np

    rng = np.random.default_rng(fine_h)
    th = {
        f"T{i:02d}": np.unique(rng.integers(0, 2**63, 8_000 if
                                            layout == "pruned" else 80_000,
                                            dtype=np.uint64))
        for i in range(40 if layout == "pruned" else 2)
    }
    if layout == "pruned":
        dev = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05,
                           fine_h=fine_h, group_size=16, device=True)
        host = build_pruned(th, kmer_size=K, window_size=W, max_fp=0.05,
                            fine_h=fine_h, group_size=16, device=False)
        assert np.array_equal(dev.fine, host.fine)
        assert np.array_equal(np.ascontiguousarray(dev.coarse), host.coarse)
        return
    ibf = build_ibf(th, kmer_size=K, window_size=W, max_fp=0.05,
                    hash_functions=fine_h)
    cfg = ibf.ibf_config
    ref = np.zeros_like(ibf.bits)
    for binno, t, st, en in sizing.split_target_bins(cfg, ibf.hashes_count):
        h = th[t][st:en + 1]
        rows = ibf_row_indices_np(h, bin_size=cfg.bin_size_bits,
                                  hash_functions=cfg.hash_functions)
        for s in range(rows.shape[1]):
            _scatter_bits(ref, rows[:, s], np.full(len(h), binno))
    assert np.array_equal(ibf.bits, ref)
