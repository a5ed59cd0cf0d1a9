"""Multi-chip sharding of the classify pipeline.

Replaces the reference's CPU-thread data parallelism (reader/classifier
thread pools over SafeQueues, GanonClassify.cpp:1220-1287,1579-1597) with
a 2-D device mesh:

* axis ``batch``: read batches are data-parallel (each chip hashes and
  thresholds its shard of reads),
* axis ``bins``: the filter's byte-aligned u8 table is column-sharded
  (each chip holds a slice of the Bloom bins; a read's hash set queries
  all local bins).

Per-byte hit counts are summed locally on each bin shard; the per-target
segment sum runs on the (small) gathered ``[B, W8]`` count matrix —
GSPMD inserts the ``all_gather`` over ``bins`` automatically, which is
the collective the reference never needed (single-host shared memory)
but a pod does.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


# device count -> batch-axis size. bins gets the larger share (column
# sharding divides the table's HBM footprint per chip; read batches can
# also scale across hosts via multihost.shard_reads, so the in-mesh
# batch axis stays modest).
_BATCH_AXIS = {1: 1, 2: 1, 4: 2, 8: 2, 16: 4, 32: 4, 64: 8, 128: 8}


def choose_batch_axis(n: int) -> int:
    """Batch-axis size for an n-device mesh (bins gets n // batch)."""
    if n in _BATCH_AXIS:
        return _BATCH_AXIS[n]
    # fallback: largest power-of-two divisor of n not exceeding sqrt(n)
    b = 1
    while (b * 2) ** 2 <= n and n % (b * 2) == 0:
        b *= 2
    return b


def make_mesh(devices=None, batch_axis: int | None = None) -> Mesh:
    """Build a (batch, bins) mesh over the given/available devices."""
    if devices is None:
        devices = jax.local_devices()
    n = len(devices)
    if batch_axis is None:
        batch_axis = choose_batch_axis(n)
    bins_axis = n // batch_axis
    dev = np.asarray(devices[: batch_axis * bins_axis]).reshape(
        batch_axis, bins_axis
    )
    return Mesh(dev, ("batch", "bins"))


class ShardedClassifier:
    """An IBF sharded over a mesh, classifying read batches end to end.

    Rides the production fused path (classify.device): the table is a
    mesh-sharded DeviceFilter, so hash compaction, the u8/u32 layout
    choice, lane-grouped popcounts and the digit segment matmul are all
    the same code the engine runs — the scaling numbers this produces
    are the production numbers. Reads overflowing the compaction width
    re-run uncompacted (exact either way).
    """

    def __init__(self, ibf, mesh: Mesh):
        from ganon_tpu.classify.device import DeviceFilter

        self.mesh = mesh
        self.cfg = ibf.ibf_config
        self.f = DeviceFilter(ibf, mesh=mesh)
        self.num_targets = self.f.num_targets
        self.batch_mult = mesh.shape["batch"]

    def counts(self, codes: np.ndarray, lengths: np.ndarray):
        """codes uint8 [B, L] / lengths int32 [B] -> (counts [B, T], n_hashes)."""
        from ganon_tpu.classify import device as dev

        B, L = codes.shape
        B_pad = -(-B // self.batch_mult) * self.batch_mult
        if B_pad != B:
            codes = np.pad(codes, ((0, B_pad - B), (0, 0)))
            lengths = np.pad(lengths, (0, B_pad - B))
        k, w = self.cfg.kmer_size, self.cfg.window_size
        m1 = max(L - w + 1, 1)
        f = self.f
        c1 = f.put_batch(codes)
        l1 = f.put_batch(np.asarray(lengths, dtype=np.int32))
        counts, n_hashes, ovf = dev.classify_counts_fused(
            f.tbl, f.byte_starts, f.byte_ends, c1, l1, None, None,
            k=k, w=w, m1=m1, m2=0,
            bin_size=self.cfg.bin_size_bits,
            hash_functions=self.cfg.hash_functions,
        )
        if bool(np.asarray(ovf).any()):
            hashes, mask, nh = dev.extract_hashes(
                c1, l1, None, None, k=k, w=w, m1=m1, m2=0
            )
            counts = dev.filter_counts(
                f.tbl, f.byte_starts, f.byte_ends, hashes, mask, nh,
                bin_size=self.cfg.bin_size_bits,
                hash_functions=self.cfg.hash_functions,
            )
            n_hashes = nh
        return counts[:B], n_hashes[:B]
