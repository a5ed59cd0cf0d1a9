"""Iterative masked-argmax top-k vs the packed u32 full sort at wide T.

At production default cutoffs most reads carry 0-2 matches; the engine
already escalates the compact width adaptively. A tiny k (4/8) via
k rounds of (max, argmax, mask) costs 2k cheap [B, T] reductions
instead of one full-width sort — candidates for the first tier of the
adaptive escalation.

Usage: python scripts/argmax_topk_probe.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__)))

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


from wide_layout_probe import trace_ms

B = 8192
N_TRACE = 3


@partial(jax.jit, static_argnames=("k",))
def topk_packed(fvals, *, k):
    T = fvals.shape[1]
    idx_c = jnp.uint32(0xFFFF) - jnp.arange(T, dtype=jnp.uint32)
    packed = (fvals.astype(jnp.uint32) << jnp.uint32(16)) | idx_c
    s = jax.lax.sort(packed, dimension=1, is_stable=False)
    top = s[:, -k:][:, ::-1]
    return (
        (top >> 16).astype(jnp.int32),
        (jnp.uint32(0xFFFF) - (top & jnp.uint32(0xFFFF))).astype(jnp.int32),
    )


@partial(jax.jit, static_argnames=("k",))
def topk_argmax(fvals, *, k):
    """k rounds of (argmax, mask): exact top-k incl. ascending-index
    tie order (the packed value prefers lower index on equal count)."""
    T = fvals.shape[1]
    idx_c = jnp.uint32(0xFFFF) - jnp.arange(T, dtype=jnp.uint32)
    packed = (fvals.astype(jnp.uint32) << jnp.uint32(16)) | idx_c
    vals, idxs = [], []
    for _ in range(k):
        j = jnp.argmax(packed, axis=1)
        p = jnp.take_along_axis(packed, j[:, None], axis=1)[:, 0]
        vals.append((p >> 16).astype(jnp.int32))
        idxs.append(
            (jnp.uint32(0xFFFF) - (p & jnp.uint32(0xFFFF))).astype(jnp.int32)
        )
        packed = packed.at[jnp.arange(packed.shape[0]), j].set(0)
    return jnp.stack(vals, axis=1), jnp.stack(idxs, axis=1)


def main():
    for T in (1024, 4096, 8192):
        rng = np.random.default_rng(T)
        fv = rng.integers(1, 400, size=(B, T)).astype(np.int32)
        fv[rng.random((B, T)) < 0.999] = 0  # ~2 matches/read
        for k in (4, 8):
            tv0, ti0 = map(np.asarray, topk_packed(jnp.asarray(fv), k=k))
            tv1, ti1 = map(np.asarray, topk_argmax(jnp.asarray(fv), k=k))
            assert np.array_equal(tv0, tv1) and np.array_equal(ti0, ti1), (
                T, k)

        def mk(i):
            r = np.random.default_rng(i)
            f = r.integers(1, 400, size=(B, T)).astype(np.int32)
            f[r.random((B, T)) < 0.999] = 0
            return (jnp.asarray(f),)

        inputs = [mk(i) for i in range(N_TRACE + 1)]
        ms0 = trace_ms(lambda f: topk_packed(f, k=8), inputs)
        ms4 = trace_ms(lambda f: topk_argmax(f, k=4), inputs)
        ms8 = trace_ms(lambda f: topk_argmax(f, k=8), inputs)
        print(f"T={T}: packed-sort k8 {ms0:6.2f} ms | argmax k4 "
              f"{ms4:6.2f} ms | argmax k8 {ms8:6.2f} ms (exact ok)")


if __name__ == "__main__":
    main()
