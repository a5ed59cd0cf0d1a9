"""Multi-host runtime wiring.

The reference's only multi-node notion is embarrassingly parallel
file-level batching (``--batch-reads``, GanonClassify.cpp:289-351). This
runtime keeps that shape: every host runs the same CLI command;
``jax.distributed.initialize`` wires the processes into one runtime; read
files are partitioned per host (host-side parsing/writing stays local,
mirroring the reference's reader/writer threads), and each host
classifies its shard on its own devices.

Outputs: each host writes its shard's outputs under
``{output_prefix}.h{process_index}`` unless it owns the whole input.
``ganon-tpu report``/``table`` accept many ``.rep`` inputs, so the
per-host reports merge downstream exactly like ``--batch-reads``
outputs do.
"""

from __future__ import annotations

import os


def maybe_initialize(force: bool = False) -> tuple[int, int]:
    """Initialize the jax distributed runtime when configured.

    Triggers on ``--distributed`` (force=True) or the standard
    coordination env (JAX_COORDINATOR_ADDRESS). Returns
    (process_index, process_count).
    Safe to call repeatedly.
    """
    import jax

    want = force or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if want:
        # explicit args (auto-detection needs a managed cluster):
        # JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
        # JAX_PROCESS_ID are the standard launcher-provided variables
        kwargs = {}
        addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
        nproc = os.environ.get("JAX_NUM_PROCESSES")
        pid = os.environ.get("JAX_PROCESS_ID")
        if addr and nproc is not None and pid is not None:
            kwargs = dict(
                coordinator_address=addr,
                num_processes=int(nproc),
                process_id=int(pid),
            )
        try:
            jax.distributed.initialize(**kwargs)
        except RuntimeError:
            pass  # already initialized
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def shard_reads(single, paired, batch, process_index: int,
                process_count: int):
    """Partition read inputs across hosts.

    ``paired`` is a flat [r1a, r2a, r1b, r2b, ...] list — pairs stay
    together. Returns ``(single, paired, batch, stride, offset)``:

    * enough file units (>= hosts): file-level round-robin, stride 1 —
      the reference's --batch-reads shape (GanonClassify.cpp:289-351);
    * fewer units than hosts (e.g. ONE big fastq on a pod): every host
      keeps ALL files and instead takes records where
      ``record_index % stride == offset`` (record-range sharding —
      the engine applies the stripe reader-agnostically via
      io.pipeline.strided_batches), so no host sits idle.
    """
    if process_count <= 1:
        return single, paired, batch, 1, 0

    pairs = [tuple(paired[i : i + 2]) for i in range(0, len(paired), 2)]
    units = (
        [("s", f) for f in single]
        + [("p", p) for p in pairs]
        + [("b", f) for f in batch]
    )
    if len(units) < process_count:
        return single, paired, batch, process_count, process_index

    # one round-robin over ALL units (not per kind) so every host gets
    # a unit whenever units >= hosts
    mine = [u for i, u in enumerate(units)
            if i % process_count == process_index]
    return (
        [f for k, f in mine if k == "s"],
        [f for k, p in mine if k == "p" for f in p],
        [f for k, f in mine if k == "b"],
        1,
        0,
    )


def host_output_prefix(prefix: str, process_index: int,
                       process_count: int) -> str:
    """Per-host output prefix (merge downstream via report/table)."""
    if process_count <= 1 or not prefix:
        return prefix
    return f"{prefix}.h{process_index}"
