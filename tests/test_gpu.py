"""Exactness of the count kernels as XLA compiles them for an NVIDIA GPU.

The integer sums ride in float dots (bf16 digits, f32 accumulation) that
are exact only while no TF32 or bf16 rounding enters; these tests check
that on the card, at real table widths. They skip where JAX has no GPU;
``chip_smoke.py`` runs them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ganon_tpu.ops.ibf_query import (
    _segment_matmul,
    bulk_target_counts_packed,
    table_as_u32,
)


def _segments(rng, n_bytes, n_targets):
    cuts = np.sort(rng.choice(np.arange(1, n_bytes), n_targets - 1,
                              replace=False))
    starts = np.concatenate([[0], cuts]).astype(np.int32)
    ends = np.concatenate([cuts, [n_bytes]]).astype(np.int32)
    return starts, ends


@pytest.mark.gpu
@pytest.mark.parametrize("n_bytes,max_val", [
    (1000, 8 * 48),  # 2x150 bp reads against a 1000-target flat filter
    (1000, 8 * 8192),  # > 8192 compacted hashes: three digits
    (8192, 8 * 48),
    (8192, 8 * 65535),
])
def test_segment_matmul_exact(gpu, n_bytes, max_val):
    rng = np.random.default_rng(n_bytes + max_val)
    cw = rng.integers(0, max_val + 1, (256, n_bytes)).astype(np.int32)
    starts, ends = _segments(rng, n_bytes, n_bytes // 8)
    want = np.stack([cw[:, s:e].sum(axis=1) for s, e in zip(starts, ends)],
                    axis=1)
    with jax.default_device(gpu):
        got = jax.jit(_segment_matmul, static_argnames="max_val")(
            jnp.asarray(cw), jnp.asarray(starts), jnp.asarray(ends),
            max_val=max_val)
    assert got.devices() == {gpu}
    assert np.array_equal(np.asarray(got), want)


@pytest.mark.gpu
def test_packed_counts_exact(gpu):
    """Gather + AND + popcount + segment sum against a numpy count."""
    rng = np.random.default_rng(7)
    R, W8, B, M, S, T = 4096, 1000, 64, 48, 4, 700
    tbl8 = rng.integers(0, 256, (R, W8), dtype=np.uint8)
    tbl8 |= rng.integers(0, 256, (R, W8), dtype=np.uint8)  # ~75% set
    rows = rng.integers(0, R, (B, M, S)).astype(np.int32)
    mask = rng.random((B, M)) < 0.9
    starts, ends = _segments(rng, W8, T)
    member = np.bitwise_and.reduce(tbl8[rows], axis=2)  # [B, M, W8]
    member[~mask] = 0
    per_byte = np.unpackbits(member[..., None], axis=-1).sum(axis=(1, 3))
    want = np.stack([per_byte[:, s:e].sum(axis=1)
                     for s, e in zip(starts, ends)], axis=1)
    with jax.default_device(gpu):
        got = bulk_target_counts_packed(
            jnp.asarray(table_as_u32(tbl8)), jnp.asarray(rows),
            jnp.asarray(mask), jnp.asarray(starts), jnp.asarray(ends))
    assert got.devices() == {gpu}
    assert np.array_equal(np.asarray(got), want)
