"""ganon_tpu — a JAX metagenomic read classifier and taxonomic profiler.

A from-scratch JAX/XLA framework with the capabilities of ganon2
(reference: pirovc/ganon). The compute core — winnowed-minimizer extraction,
interleaved-Bloom-filter (IBF) construction and bulk membership counting —
runs as JAX programs on the accelerator (an NVIDIA GPU; the CPU backend
serves tests), holding the IBF as a dense device-resident bit-matrix.
Multi-device scaling shards the Bloom-bin axis and read batches over a
`jax.sharding.Mesh`.

The package uses native uint64 JAX arrays for 2k-bit k-mer hashes and the
64-bit Bloom hash family, so 64-bit mode is enabled at import.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=_os.environ) -> str:
    """The persistent compilation cache directory.

    ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself), else one
    fixed path inside the checkout: the CLI is a short-lived process, and
    without a cache every ``build``/``classify`` invocation recompiles
    every program.
    """
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _REPO, ".jax_cache"
    )


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

__version__ = "0.1.0"
