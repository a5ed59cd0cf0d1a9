"""Bins-axis sharding of the merged-bin pruned forest.

Capacity scaling for RefSeq-scale pruned databases: the fine table (one
row range per target group, index.pruned) row-shards over the mesh
``bins`` axis so each chip holds ~1/n of the fine HBM footprint; the
coarse merged-bin IBF (ceil(G/8) bytes per row) replicates. Groups
STRIDE over shards (group g -> shard g % n_bins): the grouped layout is
count-sorted, so striding balances rows — and therefore HBM bytes and
gather work — across shards to within one group's size.

Query: every shard computes the (small, replicated) coarse gate, scans
only ITS groups' fine rows, and emits its groups' gated counts; the
``P("batch", "bins")`` out-sharding assembles the global matrix with no
cross-device traffic on the fine path. Semantics are exactly the
single-device ``DevicePrunedForest.counts_gated`` (bit-identical,
asserted in tests/test_pruned.py and __graft_entry__.dryrun_multichip).

This is the device-mesh re-expression of how the reference HIBF spreads one
logical index over many technical sub-IBFs
(hierarchical_interleaved_bloom_filter.hpp:432-460) — here the split is
a device sharding of one flat grouped table, not nested containers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map


class BinShardedPrunedForest:
    """A PrunedForest with its fine table group-sharded over ``bins``.

    ``counts_gated(hashes, mask, n_hashes, rel_cutoff)`` returns the
    same gated [B, T] counts as the single-device forest. Pad groups
    (when G does not divide the shard count) carry a sentinel id and a
    1-row bin pointing at each shard's zero padding; the gate masks
    them before they can contribute.
    """

    def __init__(self, pf, mesh: Mesh):
        from ganon_tpu.classify.device import table_as_u32
        from ganon_tpu.ops.ibf_query import clz64

        self.mesh = mesh
        self.pf = pf
        nb = mesh.shape["bins"]
        bm = mesh.shape["batch"]
        self.nb, self.bm = nb, bm
        G, gs = pf.num_groups, pf.group_size
        self.G, self.gs = G, gs
        self.num_targets = len(pf.targets())
        G_loc = -(-G // nb)
        self.G_loc = G_loc

        fine = np.ascontiguousarray(pf.fine)  # u8 [R, gs//8]
        shard_rows = []
        shard_meta = []  # (gids, local row offsets)
        for s in range(nb):
            gids = list(range(s, G, nb))
            offs, pos = [], 0
            pieces = []
            for g in gids:
                r0 = int(pf.grp_row_off[g])
                n = int(pf.grp_bin_size[g])
                pieces.append(fine[r0:r0 + n])
                offs.append(pos)
                pos += n
            shard_rows.append(pieces)
            shard_meta.append((gids, offs, pos))
        R_max = max(m[2] for m in shard_meta) + 1  # >=1 zero pad row

        tbls, offs_a, bsz_a, shift_a, gid_a = [], [], [], [], []
        for s in range(nb):
            gids, offs, pos = shard_meta[s]
            t = np.zeros((R_max, fine.shape[1]), dtype=fine.dtype)
            if pos:
                t[:pos] = np.concatenate(shard_rows[s])
            tbls.append(table_as_u32(t))
            off = np.full(G_loc, pos, np.int32)  # pads -> zero zone
            bsz = np.ones(G_loc, np.uint32)
            gid = np.full(G_loc, -1, np.int32)
            off[: len(gids)] = offs
            bsz[: len(gids)] = pf.grp_bin_size[gids]
            gid[: len(gids)] = gids
            offs_a.append(off)
            bsz_a.append(bsz)
            gid_a.append(gid)
            shift_a.append(np.asarray(
                [clz64(int(b)) for b in bsz], dtype=np.uint32))

        tbl_sh = NamedSharding(mesh, P("bins", None))
        par_sh = NamedSharding(mesh, P("bins", None))
        rep_sh = NamedSharding(mesh, P())
        self.ftbl = jax.device_put(np.concatenate(tbls), tbl_sh)
        self.loc_off = jax.device_put(np.stack(offs_a), par_sh)
        self.loc_bsz = jax.device_put(np.stack(bsz_a), par_sh)
        self.loc_shift = jax.device_put(np.stack(shift_a), par_sh)
        self.loc_gid = jax.device_put(np.stack(gid_a), par_sh)
        self.ctbl = jax.device_put(
            table_as_u32(np.ascontiguousarray(pf.coarse)), rep_sh
        )

        # shard-major column -> global target id permutation
        g = np.arange(G)
        col_base = ((g % nb) * G_loc + g // nb) * gs
        self.perm = (
            col_base[:, None] + np.arange(gs)[None, :]
        ).reshape(-1)[: self.num_targets]

        self._fn = self._build(pf.fine_h, pf.coarse_bin_size,
                               pf.coarse_h)

    def _build(self, fine_h: int, coarse_bin_size: int, coarse_h: int):
        from ganon_tpu.classify.device import (
            _bit_expand,
            bulk_group_counts,
            ibf_row_indices,
        )
        from ganon_tpu.ops.ibf_query import GOLDEN, HASH_SEEDS, _mulhi64

        G, gs, mesh = self.G, self.gs, self.mesh

        def body(tbl, off, bsz, shift, gid, ctbl, hashes, mask,
                 n_hashes, rel_cutoff, hashes_limit):
            off, bsz, shift, gid = off[0], bsz[0], shift[0], gid[0]
            crows = ibf_row_indices(
                hashes, bin_size=coarse_bin_size, hash_functions=coarse_h
            )
            gcounts = bulk_group_counts(ctbl, crows, mask, num_groups=G)
            nh = n_hashes.astype(jnp.float64)
            cutoff = jnp.maximum(
                jnp.ceil(nh * rel_cutoff), 1.0
            ).astype(jnp.int32)
            valid = (n_hashes > 0) & (n_hashes <= hashes_limit)
            surv = (
                (jnp.take(gcounts, jnp.maximum(gid, 0), axis=1)
                 >= cutoff[:, None])
                & valid[:, None]
                & (gid >= 0)[None, :]
            )  # [B, G_loc]
            nbits = 32 if tbl.dtype == jnp.uint32 else 8

            def scan_body(_, xs):
                o, b, sh = xs
                members = None
                for i in range(fine_h):
                    h = hashes * jnp.uint64(HASH_SEEDS[i])
                    h = h ^ (h >> sh)
                    h = h * jnp.uint64(GOLDEN)
                    r = _mulhi64(h, b).astype(jnp.int32) + o
                    m = tbl[r]  # [B, M, W]
                    members = m if members is None else (members & m)
                zero = members.dtype.type(0)
                members = jnp.where(mask[:, :, None], members, zero)
                planes = _bit_expand(members, nbits)[..., :gs]
                return None, jnp.sum(planes.astype(jnp.int32), axis=1)

            _, per_group = jax.lax.scan(
                scan_body, None,
                (off, bsz.astype(jnp.uint64), shift.astype(jnp.uint64)),
            )  # [G_loc, B, gs]
            counts = jnp.transpose(per_group, (1, 0, 2))
            counts = jnp.minimum(counts, n_hashes[:, None, None])
            counts = jnp.where(surv[:, :, None], counts, 0)
            return counts.reshape(hashes.shape[0], -1)

        return jax.jit(shard_map(
            body, mesh=mesh,
            in_specs=(
                P("bins", None), P("bins", None), P("bins", None),
                P("bins", None), P("bins", None), P(),
                P("batch", None), P("batch", None), P("batch"),
                P(), P(),
            ),
            out_specs=P("batch", "bins"),
        ))

    def counts_gated(self, hashes, mask, n_hashes, rel_cutoff):
        """Gated [B, T] counts == single-device counts_gated."""
        B = np.asarray(hashes).shape[0]
        B_pad = -(-B // self.bm) * self.bm
        h = np.asarray(hashes)
        m = np.asarray(mask)
        nh = np.asarray(n_hashes)
        if B_pad != B:
            h = np.pad(h, ((0, B_pad - B), (0, 0)))
            m = np.pad(m, ((0, B_pad - B), (0, 0)))
            nh = np.pad(nh, (0, B_pad - B))
        out = self._fn(
            self.ftbl, self.loc_off, self.loc_bsz, self.loc_shift,
            self.loc_gid, self.ctbl, jnp.asarray(h), jnp.asarray(m),
            jnp.asarray(nh), jnp.float64(rel_cutoff),
            jnp.int32(0x7FFFFFFF),
        )
        return np.asarray(out)[:B][:, self.perm]
