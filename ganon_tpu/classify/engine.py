"""Classification pipeline: hierarchy orchestration, thresholds, outputs.

Re-implements the full semantics of the reference classify engine
(``src/ganon-classify/GanonClassify.cpp``) on top of the device compute
path:

* multi-level hierarchies with leftover-read requeue (queue-swap semantics
  become an in-memory survivor list between levels),
* per-filter rel-cutoff, per-hierarchy rel-filter and fpr-query,
* unique/LCA accounting, ``.rep``/``.one``/``.all``/``.unc``/``.sta``
  outputs with the reference's file-naming matrix,
* uint16-style big-read skipping (``hashes_limit``) and short-read skipping.

The device computes per-target clamped counts for whole read batches; the
host applies thresholds with numpy and streams output lines.
"""

from __future__ import annotations

import math
import sys
import time as _time
from dataclasses import dataclass, field

import numpy as np

from ganon_tpu.classify import device as dev
from ganon_tpu.classify.lca import LCA, build_lca
from ganon_tpu.classify.thresholds import FprQueryMinCount
from ganon_tpu.io.pipeline import (
    BatchCoalescer,
    EncodedBatch,
    ThreadedBatchSource,
    bucketed_batches,
    encoded_batches,
    strided_batches,
)


# --------------------------------------------------------------------------
# configuration


@dataclass
class FilterSpec:
    ibf_file: str
    tax_file: str = ""
    rel_cutoff: float = 0.2


@dataclass
class ClassifyConfig:
    """Mirrors the reference ganon-classify Config (Config.hpp:18-290)."""

    ibf: list = field(default_factory=list)
    tax: list = field(default_factory=list)
    single_reads: list = field(default_factory=list)
    paired_reads: list = field(default_factory=list)  # flat [r1, r2, r1, r2...]
    batch_reads: list = field(default_factory=list)
    output_prefix: str = ""
    hierarchy_labels: list = field(default_factory=lambda: ["H1"])
    rel_cutoff: list = field(default_factory=lambda: [0.2])
    rel_filter: list = field(default_factory=lambda: [0.0])
    fpr_query: list = field(default_factory=lambda: [1.0])
    output_lca: bool = False
    output_all: bool = False
    output_unclassified: bool = False
    output_stats: bool = False
    output_single: bool = False
    skip_lca: bool = False
    tax_root_node: str = "1"
    # device batch size (reads per dispatch)
    n_reads: int = 8192
    # in-flight fast-path batches before fetching the oldest result;
    # >1 hides the device round-trip behind host work
    pipeline_depth: int = 4
    # regroup read batches by length bucket before padding (mixed-length
    # inputs; io.pipeline.bucketed_batches). Off = original streaming.
    length_bucketing: bool = True
    hashes_limit: int = 65535  # uint16 counter limit; raise for long reads
    # pruned-forest fast path: static surviving-group slots per read
    # (reads with more coarse-surviving groups fall back to the exact
    # probe-all gated path; classify_batch_packed_pruned). Every slot
    # gathers, masked or not, and at the default rel-cutoff (0.75)
    # multi-group survivors are rare
    pruned_max_groups: int = 2
    # (read, slot) pair compaction for the pruned fine stage: the fine
    # gather sizes to ~frac x B pairs instead of B x S slots (surviving
    # groups average well under 1 at default cutoffs, so masked slots
    # are ~half the probes). A
    # batch whose pairs spill past the cap is retried once with dense
    # slots (exact), and the level's cap self-tunes upward so spilling
    # workloads converge to dense instead of double-dispatching.
    # <= 0 = off.
    pruned_pair_frac: float = 1.0
    device_thresholding: bool = True  # on-device cutoff/filter + top-K
    top_k_matches: int = 128  # compact output width (falls back if exceeded)
    use_mesh: bool = True  # shard over all devices when more than one
    # record-range sharding: keep records with index % stride == offset
    # (multi-host runs on fewer files than hosts; multihost.shard_reads)
    read_stride: int = 1
    read_offset: int = 0
    quiet: bool = True
    verbose: bool = False

    def validate(self) -> None:
        """Broadcast vector params (reference validate_hierarchy)."""
        if not self.output_prefix:
            raise ValueError("--output-prefix is mandatory")
        if not (self.single_reads or self.paired_reads or self.batch_reads):
            raise ValueError("at least one of --single|paired|batch-reads needed")
        if not self.ibf:
            raise ValueError("--ibf is mandatory")
        if len(self.paired_reads) % 2 != 0:
            raise ValueError("--paired-reads should be an even number of files")
        n_filters = len(self.ibf)
        uniq = len(set(self.hierarchy_labels))
        if len(self.hierarchy_labels) == 1 and n_filters > 1:
            self.hierarchy_labels = self.hierarchy_labels * n_filters
        if len(self.hierarchy_labels) != n_filters:
            raise ValueError("--hierarchy-labels must match --ibf")
        uniq = len(set(self.hierarchy_labels))
        if len(self.rel_cutoff) == 1 and n_filters > 1:
            self.rel_cutoff = self.rel_cutoff * n_filters
        if len(self.rel_cutoff) != n_filters:
            raise ValueError("one --rel-cutoff per filter")
        if len(self.rel_filter) == 1 and uniq > 1:
            self.rel_filter = self.rel_filter * uniq
        if len(self.rel_filter) != uniq:
            raise ValueError("one --rel-filter per hierarchy")
        if len(self.fpr_query) == 1 and uniq > 1:
            self.fpr_query = self.fpr_query * uniq
        if len(self.fpr_query) != uniq:
            raise ValueError("one --fpr-query per hierarchy")
        if self.tax and len(self.tax) != len(self.ibf):
            raise ValueError("--ibf and --tax must match")
        if not self.tax:
            self.skip_lca = True
        for v in self.rel_cutoff + self.rel_filter + self.fpr_query:
            if v < 0 or v > 1:
                raise ValueError("threshold values must be within [0, 1]")


@dataclass
class HierarchyLevel:
    label: str
    filters: list  # list[FilterSpec]
    rel_filter: float
    fpr_query: float
    output_file_one: str
    output_file_all: str


def parse_hierarchy(cfg: ClassifyConfig) -> dict[str, HierarchyLevel]:
    """Group filters by sorted hierarchy label (GanonClassify.cpp:353-401)."""
    uniq = sorted(set(cfg.hierarchy_labels))
    levels: dict[str, HierarchyLevel] = {}
    hierarchy_count = 0
    for h, label in enumerate(cfg.hierarchy_labels):
        spec = FilterSpec(
            ibf_file=cfg.ibf[h],
            tax_file=cfg.tax[h] if cfg.tax else "",
            rel_cutoff=cfg.rel_cutoff[h],
        )
        if label not in levels:
            one, all_ = "one", "all"
            if len(uniq) > 1 and not cfg.output_single:
                one = f"{label}.one"
                all_ = f"{label}.all"
            levels[label] = HierarchyLevel(
                label=label,
                filters=[spec],
                rel_filter=cfg.rel_filter[hierarchy_count],
                fpr_query=cfg.fpr_query[hierarchy_count],
                output_file_one=one,
                output_file_all=all_,
            )
            hierarchy_count += 1
        else:
            levels[label].filters.append(spec)
    return dict(sorted(levels.items()))


def parse_reads_config(cfg: ClassifyConfig) -> dict[str, list[tuple[str, str]]]:
    """{prefix: [(file1, file2|""), ...]} (GanonClassify.cpp:289-351)."""
    rc: dict[str, list[tuple[str, str]]] = {}
    if cfg.batch_reads:
        for bf in cfg.batch_reads:
            with open(bf) as f:
                for line in f:
                    fields = line.rstrip("\n").split("\t")
                    if len(fields) < 2:
                        raise ValueError(
                            "invalid --batch-reads file (prefix\tfile1[\tfile2])"
                        )
                    f2 = fields[2] if len(fields) >= 3 else ""
                    rc.setdefault(fields[0], []).append((fields[1], f2))
    else:
        for rf in cfg.single_reads:
            rc.setdefault("", []).append((rf, ""))
        for i in range(0, len(cfg.paired_reads), 2):
            rc.setdefault("", []).append(
                (cfg.paired_reads[i], cfg.paired_reads[i + 1])
            )
    return rc


def load_tax(tax_file: str) -> dict[str, tuple[str, str, str]]:
    """.tax rows: target <tab> parent <tab> rank <tab> name [...]"""
    tax = {}
    with open(tax_file) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            tax[fields[0]] = (fields[1], fields[2], fields[3])
    return tax


# --------------------------------------------------------------------------
# stats containers


# max (reads x window positions) per uncompacted fallback gather — the
# [rows, M, W] gather temps must fit HBM for any table width W
_FALLBACK_GATHER_ROWS = 2048 * 512

_TOTAL_FIELDS = (
    "input_seqs",
    "seqs_processed",
    "seqs_skipped_big",
    "seqs_skipped_small",
    "length_processed",
    "kmers_processed",
    "seqs_classified",
    "kmers_matches",
    "kmers_from_classified_seqs",
    "matches",
    "seqs_unique",
    "discarded_matches_filter",
    "discarded_matches_fprquery",
)


class Total:
    __slots__ = _TOTAL_FIELDS

    def __init__(self):
        for f in _TOTAL_FIELDS:
            setattr(self, f, 0)

    def add(self, other: "Total"):
        for f in _TOTAL_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))


class Rep:
    """Per-(prefix, target) report counters."""

    __slots__ = ("matches", "seqs_lca", "seqs_unique", "disc_filter", "disc_fpr")

    def __init__(self):
        self.matches = 0
        self.seqs_lca = 0
        self.seqs_unique = 0
        self.disc_filter = 0
        self.disc_fpr = 0


# --------------------------------------------------------------------------
# per-level classification context


class LevelContext:
    """Loaded filters + union target table + LCA for one hierarchy level."""

    def __init__(self, level: HierarchyLevel, cfg: ClassifyConfig, mesh=None):
        self.level = level
        self.filters: list[dev.DeviceFilter] = []
        self.specs = level.filters
        taxes = []
        for spec in level.filters:
            self.filters.append(dev.load_device_filter(spec.ibf_file, mesh))
            if spec.tax_file:
                taxes.append(load_tax(spec.tax_file))
        k = self.filters[0].ibf_config.kmer_size
        w = self.filters[0].ibf_config.window_size
        for f in self.filters[1:]:
            if f.ibf_config.kmer_size != k or f.ibf_config.window_size != w:
                raise ValueError(
                    "databases on the same hierarchy must share k-mer/window sizes"
                )
        self.kmer_size, self.window_size = k, w

        # union target table (deterministic: filter order, then target order)
        self.union_targets: list[str] = []
        index: dict[str, int] = {}
        self.filter_cols: list[np.ndarray] = []
        self.filter_fprs: list[np.ndarray] = []
        for f in self.filters:
            cols = np.empty(f.num_targets, dtype=np.int64)
            fprs = np.empty(f.num_targets, dtype=np.float64)
            for j, t in enumerate(f.targets):
                if t not in index:
                    index[t] = len(self.union_targets)
                    self.union_targets.append(t)
                cols[j] = index[t]
                fprs[j] = f.target_fpr[t]
            self.filter_cols.append(cols)
            self.filter_fprs.append(fprs)
        # per-filter fpr indexed by UNION column (multi-filter fast path:
        # the winning filter's fpr rides with each match)
        self.union_fprs: list[np.ndarray] = []
        for cols, fprs in zip(self.filter_cols, self.filter_fprs):
            u = np.zeros(len(self.union_targets), dtype=np.float64)
            u[cols] = fprs
            self.union_fprs.append(u)
        # level-scoped fpr-query threshold cache (reads repeat lengths,
        # targets repeat fprs across batches)
        self.fpr_min = FprQueryMinCount(level.fpr_query)
        # adaptive compact-output width: the [B, K] match transfer is the
        # per-batch device->host payload, and with strict default
        # cutoffs most reads carry a handful of matches — start small
        # and escalate to cfg.top_k_matches only when a batch overflows
        # (the escalation is sticky for the rest of the level).
        # Wide tables (union >= 4096 targets) start at K=4: that keeps
        # threshold_topk on the iterative-argmax tier (2.6x cheaper
        # than the full-width sort at [8192, 8192]; device.py) and the
        # overflow path escalates exactly as before.
        start_k = 4 if len(self.union_targets) >= 4096 else 32
        self.top_k_current = min(start_k, cfg.top_k_matches)
        # ragged match transfer: average compacted slots per read
        # (device.classify_batch_packed match_cap). 2 slots/read covers
        # the default-cutoff regime (~30-40% classified, mostly unique)
        # with headroom; doubles sticky on cap overflow, None = dense
        self.match_slots: int | None = 2
        # pruned (read, slot) pair-compaction cap as a fraction of B;
        # bumps sticky when a batch's pairs spill past the cap
        self.pair_frac: float = getattr(cfg, "pruned_pair_frac", 0.0)

        # taxonomy: merge (first wins), add missing targets under root
        self.tax: dict[str, tuple[str, str, str]] = {}
        for t in reversed(taxes):
            self.tax.update(t)
        if self.tax:
            for t in self.union_targets:
                if t not in self.tax:
                    self.tax[t] = (cfg.tax_root_node, "no rank", t)
        # per-prefix vectorized tally accumulators: the host finish adds
        # whole [T] arrays per batch (bincounts / device tallies) and the
        # per-target Rep objects materialize ONCE at level end
        # (_fold_tallies) — per-batch Python loops over matched targets
        # were the dominant host-post term at T=8192
        self._tally: dict[str, dict[str, np.ndarray]] = {}
        self._lca_tally: dict[str, dict[str, int]] = {}
        self.lca: LCA | None = None
        self.union_lca_ids: np.ndarray | None = None
        if not cfg.skip_lca:
            if cfg.tax_root_node not in self.tax:
                raise ValueError(
                    f"root node [{cfg.tax_root_node}] not found (--tax-root-node)"
                )
            self.lca = build_lca(self.tax, cfg.tax_root_node)
            # union column -> LCA node id, for the batched per-row LCA
            self.union_lca_ids = self.lca.encode_ids(self.union_targets)

    def tally(self, prefix: str) -> dict[str, np.ndarray]:
        t = self._tally.get(prefix)
        if t is None:
            T = len(self.union_targets)
            t = {
                k: np.zeros(T, np.int64)
                for k in ("matches", "seqs_unique", "disc_filter",
                          "disc_fpr")
            }
            self._tally[prefix] = t
        return t

    def lca_tally(self, prefix: str) -> dict[str, int]:
        d = self._lca_tally.get(prefix)
        if d is None:
            d = {}
            self._lca_tally[prefix] = d
        return d


def _fold_tallies(rep: dict, ctx: LevelContext) -> None:
    """Materialize the level's accumulated tallies into Rep objects
    (union-target order, then LCA nodes) before .rep writing."""
    for prefix, t in ctx._tally.items():
        nz = np.nonzero(
            t["matches"] | t["seqs_unique"] | t["disc_filter"]
            | t["disc_fpr"]
        )[0]
        for j in nz:
            r = rep.setdefault((prefix, ctx.union_targets[j]), Rep())
            r.matches += int(t["matches"][j])
            r.seqs_unique += int(t["seqs_unique"][j])
            r.disc_filter += int(t["disc_filter"][j])
            r.disc_fpr += int(t["disc_fpr"][j])
    for prefix, d in ctx._lca_tally.items():
        for node, n in d.items():
            rep.setdefault((prefix, node), Rep()).seqs_lca += n


# --------------------------------------------------------------------------
# main engine


class _Out:
    """Lazy per-prefix output file handles + a background writer thread.

    The reference drains its .one/.all/.unc writers on dedicated threads
    fed by SafeQueues (GanonClassify.cpp:1444-1455,1539-1569); here one
    writer thread drains submitted jobs in order, so line formatting and
    file I/O overlap the main thread's device waits (which release the
    GIL). Direct ``get().write()`` stays for the end-of-run writers
    (.rep/.sta); call :meth:`drain` before mixing direct writes into a
    file that also received submitted jobs.
    """

    _DONE = object()

    def __init__(self):
        import queue
        import threading

        self._files = {}
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=64)
        self._err = None

        def work():
            while True:
                job = self._q.get()
                try:
                    if job is self._DONE:
                        return
                    path, payload = job
                    if callable(payload):
                        payload = payload()
                    if payload:
                        self._file(path).write(payload)
                except BaseException as e:  # surfaced on drain/close
                    if self._err is None:
                        self._err = e
                finally:
                    self._q.task_done()

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def _file(self, path: str, mode: str = "w"):
        with self._lock:
            if path not in self._files:
                self._files[path] = open(path, mode)
            return self._files[path]

    def get(self, path: str, mode: str = "w"):
        """Direct handle (create with ``mode`` on first touch)."""
        self._file(path, mode)

        return self._files[path]

    def submit(self, path: str, payload):
        """Queue a write: a string, or a zero-arg callable returning one
        (formatting then runs on the writer thread)."""
        self._q.put((path, payload))
        if self._err is not None:
            self.drain()

    def drain(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close_all(self):
        self.drain()
        self._q.put(self._DONE)
        self._t.join()
        for f in self._files.values():
            f.close()
        self._files.clear()


def run_classify(cfg: ClassifyConfig) -> dict:
    """Run the full classification; returns collected stats (for tests)."""
    t_start = _time.monotonic()
    cfg.validate()
    levels = parse_hierarchy(cfg)
    reads_config = parse_reads_config(cfg)
    prefixes = list(reads_config.keys())

    # multi-chip: shard filters (bins) and read batches (batch) over the
    # available devices; single device keeps the plain path
    mesh = None
    if getattr(cfg, "use_mesh", True):
        import jax

        # LOCAL devices only: under jax.distributed each host classifies
        # its own file shard (multihost.shard_reads), so a global mesh
        # would issue mismatched collectives across hosts
        if len(jax.local_devices()) > 1:
            from ganon_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(jax.local_devices())
            if not cfg.quiet:
                print(
                    f" - device mesh {dict(mesh.shape)} over "
                    f"{mesh.size} devices",
                    file=sys.stderr,
                )

    totals: dict[str, Total] = {p: Total() for p in prefixes}
    hierarchy_totals: dict[str, dict[str, Total]] = {
        lbl: {p: Total() for p in prefixes} for lbl in levels
    }
    # wall-clock breakdown of the main loop (dispatch overlaps device
    # compute, so "dispatch" is host-side dispatch cost; "finish" is
    # fetch-block + host post-processing; "input_wait" is reader stall)
    timing = {"input_wait": 0.0, "dispatch": 0.0, "fetch": 0.0,
              "finish": 0.0}

    out = _Out()
    for p in prefixes:
        out.get(cfg.output_prefix + p + ".rep")
        if cfg.output_unclassified:
            out.get(cfg.output_prefix + p + ".unc")

    # Cross-level pipelined scheduler. The round-4 design ran levels
    # strictly in sequence, so the device pipeline drained once per
    # hierarchy level (the requeue boundary the reference never stalls
    # on — its consumers keep popping the swapped queue,
    # GanonClassify.cpp:811-830,1521-1537). Here every level is a
    # runner with its own ready queue; leftovers coalesce INCREMENTALLY
    # as level-N batches finish, so level-N+1 dispatches start while
    # level-N results are still in flight and the pipeline never
    # empties at the boundary. Lower levels have dispatch priority, so
    # single-level runs behave exactly as before.
    from collections import deque

    level_labels = list(levels.keys())
    n_reads = cfg.n_reads  # run-local: never mutate the caller's config

    class _Runner:
        __slots__ = (
            "li", "label", "level", "first", "last", "ctx", "rep",
            "coalescer", "source_done", "inflight", "complete", "ready",
            "one_files", "all_files", "finish_args",
        )

    runners: list[_Runner] = []
    for li, label in enumerate(level_labels):
        r = _Runner()
        r.li, r.label, r.level = li, label, levels[label]
        r.first = li == 0
        r.last = li == len(level_labels) - 1
        r.ctx = None
        r.rep = {}
        r.coalescer = None
        r.source_done = False
        r.inflight = 0
        r.complete = False
        r.ready = deque()
        runners.append(r)

    def ensure_ctx(r: _Runner) -> LevelContext:
        if r.ctx is not None:
            return r.ctx
        r.ctx = LevelContext(r.level, cfg, mesh)
        file_mode = "w" if (r.first or not cfg.output_single) else "a"
        r.one_files = {
            p: cfg.output_prefix + p + "." + r.level.output_file_one
            for p in prefixes
        }
        r.all_files = {
            p: cfg.output_prefix + p + "." + r.level.output_file_all
            for p in prefixes
        }
        if cfg.output_lca and not cfg.skip_lca:
            for p in prefixes:
                out.get(r.one_files[p], file_mode)
        if cfg.output_all:
            for p in prefixes:
                out.get(r.all_files[p], file_mode)
        r.finish_args = (
            r.ctx, cfg, r.rep, hierarchy_totals[r.label], r.first,
            r.last, out, r.one_files, r.all_files,
        )
        return r.ctx

    # level-0 source: reader/encoder on a background thread (SafeQueue
    # analogue) overlapping device compute; mixed-length inputs regroup
    # by length bucket so one long read does not pad a whole batch
    ensure_ctx(runners[0])

    def produce():
        for prefix, files in reads_config.items():
            for f1, f2 in files:
                yield from encoded_batches(f1, f2, prefix, n_reads)

    stream = produce()
    if cfg.read_stride > 1:
        stream = strided_batches(stream, cfg.read_stride, cfg.read_offset)
    if cfg.length_bucketing:
        # bp-budgeted batch sizing (B x L ~ const): long-read buckets
        # flush at ~n_reads x 1024 bp instead of n_reads rows, so a
        # mixed-length stream feeds the device long before EOF (with
        # row-count sizing no nanopore-mix bucket ever filled and every
        # batch waited for the whole input to parse); buckets <= 1024 bp
        # keep full n_reads rows — short-read behavior unchanged
        stream = bucketed_batches(stream, n_reads,
                                  bp_budget=n_reads * 1024)
    lvl0 = iter(ThreadedBatchSource(stream))

    # N-deep pipeline: keep several batches in flight before fetching
    # the oldest result. Each dispatch also starts the device->host
    # copy asynchronously, so result transfers overlap device compute
    # and each other.
    depth = max(1, cfg.pipeline_depth)
    pending: deque = deque()  # (runner, batch, disp) in dispatch order

    def route_leftover(r: _Runner, lo) -> None:
        if lo is None or not len(lo):
            return
        nxt = runners[r.li + 1]
        if cfg.length_bucketing:
            # leftovers are ragged half-empty sub-batches; each
            # dispatch pays a fixed per-call cost, so coalesce them
            # back to full n_reads batches (re-bucketing by length,
            # since survivors of different buckets merge)
            if nxt.coalescer is None:
                nxt.coalescer = BatchCoalescer(n_reads,
                                               bp_budget=n_reads * 1024)
            nxt.ready.extend(nxt.coalescer.add(lo))
        else:
            nxt.ready.append(lo)

    def maybe_complete(r: _Runner) -> None:
        while (
            not r.complete and r.source_done and not r.inflight
            and not r.ready
        ):
            r.complete = True
            # fold per-level totals and reports into global stats
            for p in prefixes:
                t = hierarchy_totals[r.label][p]
                tt = totals[p]
                for fld in _TOTAL_FIELDS:
                    if fld != "input_seqs":
                        setattr(tt, fld, getattr(tt, fld) + getattr(t, fld))
            if r.ctx is not None:
                _fold_tallies(r.rep, r.ctx)
                _write_rep(r.rep, r.ctx, cfg, r.label, out)
            if r.li + 1 >= len(runners):
                return
            nxt = runners[r.li + 1]
            if nxt.coalescer is not None:
                nxt.ready.extend(nxt.coalescer.flush())
            nxt.source_done = True
            r = nxt

    def finish_oldest() -> None:
        r, batch, disp = pending.popleft()
        t0 = _time.monotonic()
        lo = _finish_batch_fast((batch, disp), *r.finish_args,
                                timing=timing)
        timing["finish"] += _time.monotonic() - t0
        if not r.last:
            route_leftover(r, lo)
        r.inflight -= 1
        maybe_complete(r)

    def next_ready():
        """(runner, batch) to dispatch next; None when nothing is ready.
        The returned runner's inflight count is already incremented (the
        batch counts as in-flight the moment it leaves a queue)."""
        r0 = runners[0]
        if not r0.source_done:
            t0 = _time.monotonic()
            batch = next(lvl0, None)
            timing["input_wait"] += _time.monotonic() - t0
            if batch is not None:
                totals[batch.prefix].input_seqs += len(batch)
                r0.inflight += 1
                return r0, batch
            r0.source_done = True
            maybe_complete(r0)
        for r in runners:
            if r.ready:
                r.inflight += 1
                return r, r.ready.popleft()
        return None

    while True:
        nb = next_ready()
        if nb is None:
            if pending:
                finish_oldest()
                continue
            break
        r, batch = nb
        ctx = ensure_ctx(r)
        t0 = _time.monotonic()
        disp = _dispatch_batch_fast(batch, ctx, cfg)
        timing["dispatch"] += _time.monotonic() - t0
        if disp is None:
            t0 = _time.monotonic()
            while pending:
                finish_oldest()
            lo = _classify_batch(batch, *r.finish_args)
            timing["finish"] += _time.monotonic() - t0
            if not r.last:
                route_leftover(r, lo)
            r.inflight -= 1
            maybe_complete(r)
        else:
            if len(pending) >= depth:
                finish_oldest()
            pending.append((r, batch, disp))

    # .rep totals trailer
    for p in prefixes:
        f = out.get(cfg.output_prefix + p + ".rep")
        f.write(f"#total_classified\t{totals[p].seqs_classified}\n")
        f.write(
            f"#total_unclassified\t{totals[p].input_seqs - totals[p].seqs_classified}\n"
        )

    out.close_all()

    if cfg.output_stats:
        _write_stats(cfg, totals, hierarchy_totals, levels, prefixes)

    if not cfg.quiet:
        _print_stats(totals, elapsed=_time.monotonic() - t_start)

    timing["total"] = _time.monotonic() - t_start
    return {
        "totals": totals,
        "hierarchy_totals": hierarchy_totals,
        "timing": timing,
    }


def _dispatch_batch_fast(batch: EncodedBatch, ctx: LevelContext,
                         cfg: ClassifyConfig):
    """Kick off the single-dispatch fast path; None when not applicable
    (multi-filter level, forest/raptor HIBF, or device thresholding off).
    Returns the in-flight packed device array + unpack dims."""
    if not cfg.device_thresholding:
        return None
    if len(ctx.filters) != 1:
        return _dispatch_batch_fast_multi(batch, ctx, cfg)
    f = ctx.filters[0]
    is_forest = (
        isinstance(f, dev.DeviceHIBF)
        and getattr(f, "contiguous", False)
        and f.subs
    )
    is_raptor = isinstance(f, dev.DeviceRaptorHIBF) and f.subs
    is_pruned = isinstance(f, dev.DevicePrunedForest)
    if is_pruned and (
        f.num_groups > 0xFFFF or cfg.hashes_limit > 0xFFFF
    ):
        # counts must fit 16 bits and group ids must fit the packed u16
        # words; target count itself is unbounded (matches ship as
        # lane ids + per-read surviving-group words)
        return None
    if not isinstance(f, dev.DeviceFilter) and not is_forest and not (
        is_raptor
    ) and not is_pruned:
        return None

    B0 = len(batch)
    w = ctx.window_size
    batch_pad = dev.bucket_len(B0, minimum=64)
    # put_batch shards the batch axis over the mesh: the padded batch must
    # divide the mesh batch axis regardless of the bucket minimum chosen
    mult = getattr(f, "batch_mult", 1)
    if mult > 1 and batch_pad % mult:
        batch_pad = -(-batch_pad // mult) * mult
    inbuf, L1, L2 = dev.pack_batch_direct(batch, batch_pad)
    K = min(ctx.top_k_current, f.num_targets)
    if is_pruned:
        K = min(ctx.top_k_current,
                cfg.pruned_max_groups * f.group_size)
        pack16 = True  # lane ids are always u16-safe
    else:
        pack16 = f.num_targets <= 0xFFFF and cfg.hashes_limit <= 0xFFFF
    cap = 0
    if pack16 and ctx.match_slots is not None:
        cap = batch_pad * ctx.match_slots
        if cap >= batch_pad * K:
            cap = 0  # dense is no larger — use it
    # per-batch [T] matches_t is only consumed when fpr-query is off
    # (static per level); skipping it cuts the per-batch fetch payload
    emit_mt = ctx.level.fpr_query >= 1.0
    if is_pruned:
        S = cfg.pruned_max_groups
        pair_cap = 0
        if ctx.pair_frac > 0 and S > 1:
            # round to a 256 multiple so bucketed batch sizes share
            # compiled programs; the kernel ignores caps >= B*S
            pair_cap = -(-int(batch_pad * ctx.pair_frac) // 256) * 256
            pair_cap = min(pair_cap, batch_pad * S)
        packed = dev.classify_batch_packed_pruned(
            f.ctbl, f.ftbl, f.grp_row_off, f.grp_bin_size, f.grp_shift,
            f.grp_ntargets, f.put_batch(inbuf),
            ctx.specs[0].rel_cutoff, ctx.level.rel_filter,
            cfg.hashes_limit,
            k=ctx.kmer_size, w=w, L1=L1, L2=L2,
            coarse_bin_size=f.coarse_bin_size, coarse_h=f.coarse_h,
            fine_h=f.fine_h, max_groups=cfg.pruned_max_groups,
            group_size=f.group_size, num_targets=f.num_targets,
            top_k=K, match_cap=cap, emit_matches_t=emit_mt,
            pair_cap=pair_cap,
        )
    elif is_raptor:
        import jax.numpy as jnp

        packed = dev.classify_batch_packed_raptor(
            tuple(s["tbl"] for s in f.subs),
            tuple(s["byte_starts"] for s in f.subs),
            tuple(s["byte_ends"] for s in f.subs),
            tuple(jnp.asarray(s["cols"]) for s in f.subs),
            f.put_batch(inbuf),
            ctx.specs[0].rel_cutoff, ctx.level.rel_filter, cfg.hashes_limit,
            k=ctx.kmer_size, w=w, L1=L1, L2=L2,
            sub_params=tuple(
                (s["bin_size"], s["hash_funs"]) for s in f.subs
            ),
            num_targets=f.num_targets,
            top_k=K, pack16=pack16, match_cap=cap,
            emit_matches_t=emit_mt,
        )
    elif is_forest:
        import jax.numpy as jnp

        packed = dev.classify_batch_packed_forest(
            tuple(s.tbl for s in f.subs),
            tuple(s.byte_starts for s in f.subs),
            tuple(s.byte_ends for s in f.subs),
            f.put_batch(inbuf),
            ctx.specs[0].rel_cutoff, ctx.level.rel_filter, cfg.hashes_limit,
            k=ctx.kmer_size, w=w, L1=L1, L2=L2,
            sub_params=tuple(
                (s.ibf_config.bin_size_bits, s.ibf_config.hash_functions)
                for s in f.subs
            ),
            top_k=K, pack16=pack16, match_cap=cap,
            emit_matches_t=emit_mt,
        )
    else:
        packed = dev.classify_batch_packed(
            f.tbl, f.byte_starts, f.byte_ends, f.put_batch(inbuf),
            ctx.specs[0].rel_cutoff, ctx.level.rel_filter, cfg.hashes_limit,
            k=ctx.kmer_size, w=w, L1=L1, L2=L2,
            bin_size=f.ibf_config.bin_size_bits,
            hash_functions=f.ibf_config.hash_functions,
            top_k=K, pack16=pack16, match_cap=cap,
            emit_matches_t=emit_mt,
        )
    _start_host_copy(packed)
    pinfo = None
    if is_pruned:
        S = cfg.pruned_max_groups
        pinfo = (S, f.group_size, -(-S // 2),
                 0 < pair_cap < batch_pad * S)
    return (packed, batch_pad, K, f.num_targets, pack16, False, cap,
            pinfo, emit_mt)


def _start_host_copy(packed) -> None:
    """Enqueue the device->host copy now (non-blocking): it runs as soon
    as the result is computed, so pipelined batches' transfers overlap."""
    try:
        packed.copy_to_host_async()
    except AttributeError:
        pass


def _dispatch_batch_fast_multi(batch: EncodedBatch, ctx: LevelContext,
                               cfg: ClassifyConfig):
    """Single-dispatch fast path for a multi-filter level (several
    plain IBFs classified together; per-filter rel-cutoffs, union merge
    and the winning filter id all on device). None when a filter is a
    forest/raptor HIBF or the pack16 bound does not hold."""
    import jax.numpy as jnp

    if not all(type(f) is dev.DeviceFilter for f in ctx.filters):
        return None
    U = len(ctx.union_targets)
    if U > 0xFFFF or cfg.hashes_limit > 0xFFFF:
        return None
    B0 = len(batch)
    w = ctx.window_size
    batch_pad = dev.bucket_len(B0, minimum=64)
    mult = max(getattr(f, "batch_mult", 1) for f in ctx.filters)
    if mult > 1 and batch_pad % mult:
        batch_pad = -(-batch_pad // mult) * mult
    inbuf, L1, L2 = dev.pack_batch_direct(batch, batch_pad)
    K = min(ctx.top_k_current, U)
    cap = 0
    if ctx.match_slots is not None:
        cap = batch_pad * ctx.match_slots
        if cap >= batch_pad * K:
            cap = 0
    packed = dev.classify_batch_packed_multi(
        tuple(f.tbl for f in ctx.filters),
        tuple(f.byte_starts for f in ctx.filters),
        tuple(f.byte_ends for f in ctx.filters),
        tuple(jnp.asarray(c, dtype=jnp.int32) for c in ctx.filter_cols),
        ctx.filters[0].put_batch(inbuf),
        jnp.asarray([s.rel_cutoff for s in ctx.specs], dtype=jnp.float64),
        ctx.level.rel_filter, cfg.hashes_limit,
        k=ctx.kmer_size, w=w, L1=L1, L2=L2,
        sub_params=tuple(
            (f.ibf_config.bin_size_bits, f.ibf_config.hash_functions)
            for f in ctx.filters
        ),
        num_union=U, top_k=K, match_cap=cap,
        emit_matches_t=ctx.level.fpr_query >= 1.0,
    )
    _start_host_copy(packed)
    return (packed, batch_pad, K, U, True, True, cap, None,
            ctx.level.fpr_query >= 1.0)


def _finish_batch_fast(pending, ctx, cfg, rep, level_totals, first, last,
                       out, one_files, all_files, timing=None):
    """Fetch + finish an in-flight fast batch (one device->host trip);
    escalates the compact width on top-K overflow (sticky for the
    level), falls back to the exact full path on compaction overflow.
    ``timing`` (optional dict) accumulates the device->host fetch-block
    seconds under "fetch" — a SUB-term of the caller's "finish" — so
    the e2e split separates link transfer from host post-processing."""
    batch, (packed, B_pad, K, T, pack16, has_win, cap, pinfo,
            emit_mt) = pending
    B0 = len(batch)
    n_extra = pinfo[2] if pinfo else 0

    def _fetch(arr):
        if timing is None:
            return np.asarray(arr)
        t0 = _time.monotonic()
        host = np.asarray(arr)
        timing["fetch"] += _time.monotonic() - t0
        return host

    if cap > 0:
        res = dev.unpack_batch_result_ragged(_fetch(packed), B_pad,
                                             cap, T, K, has_win,
                                             n_extra=n_extra,
                                             has_matches_t=emit_mt)
        if res["cap_overflow"]:
            # the compacted match stream overran the cap: double the
            # per-read slot budget (sticky; dense layout once it stops
            # paying) and re-dispatch this batch
            total = int(np.minimum(res["n_matches"], K).sum())
            need = -(-total // max(B_pad, 1)) + 1
            # a pipelined in-flight batch can land AFTER a newer batch
            # already escalated to dense (None); never resurrect the
            # ragged layout that was just proven too small
            if ctx.match_slots is not None:
                ctx.match_slots = max(ctx.match_slots * 2, need)
                if ctx.match_slots >= K:
                    ctx.match_slots = None
            disp = _dispatch_batch_fast(batch, ctx, cfg)
            if disp is None:
                return _classify_batch(
                    batch, ctx, cfg, rep, level_totals, first, last, out,
                    one_files, all_files,
                )
            return _finish_batch_fast(
                (batch, disp), ctx, cfg, rep, level_totals, first, last,
                out, one_files, all_files, timing=timing,
            )
    else:
        res = dev.unpack_batch_result(
            _fetch(packed), B_pad, K, T, pack16, has_win,
            n_extra=n_extra, has_matches_t=emit_mt,
        )
    if not res["overflow"][:B0].any() and (
        res["n_matches"][:B0] > K
    ).any() and ctx.top_k_current < cfg.top_k_matches:
        # matches exceeded the adaptive compact width: widen to the
        # configured cap and re-dispatch this batch on the fast path
        ctx.top_k_current = cfg.top_k_matches
        disp = _dispatch_batch_fast(batch, ctx, cfg)
        if disp is not None:
            return _finish_batch_fast(
                (batch, disp), ctx, cfg, rep, level_totals, first, last,
                out, one_files, all_files, timing=timing,
            )
    if (res["overflow"][:B0].any()
            or (res["n_matches"][:B0] > K).any()):
        if (pinfo is not None and pinfo[3]
                and res["overflow"][:B0].any()):
            # overflow with pair compaction active may be a pair-cap
            # spill, not true multi-group overflow: retry once with
            # dense slots (exact), and bump the level's cap sticky so a
            # spilling workload converges to dense instead of paying a
            # double dispatch per batch. True overflow (n_surv > S,
            # hash-compaction) survives the dense retry and falls
            # through to the probe-all path below.
            ctx.pair_frac += 0.5
            saved, ctx.pair_frac = ctx.pair_frac, 0.0
            disp = _dispatch_batch_fast(batch, ctx, cfg)
            ctx.pair_frac = saved
            if disp is not None:
                return _finish_batch_fast(
                    (batch, disp), ctx, cfg, rep, level_totals, first,
                    last, out, one_files, all_files, timing=timing,
                )
        return _classify_batch(
            batch, ctx, cfg, rep, level_totals, first, last, out,
            one_files, all_files,
        )
    if pinfo is not None:
        # pruned kernel matches carry LANE ids (slot*gs + offset);
        # reconstruct the per-read surviving-group ids from the packed
        # u16 words and map to global target ids. Entries beyond
        # n_matches map to garbage and are clamped (every consumer
        # masks by n_matches before use).
        S, gs = pinfo[0], pinfo[1]
        gsel = np.empty((B_pad, S), np.int64)
        for i, w in enumerate(res["extra_rows"]):
            gsel[:, 2 * i] = w & 0xFFFF
            if 2 * i + 1 < S:
                gsel[:, 2 * i + 1] = w >> 16
        lanes = res["top_idx"]
        slot = np.minimum(lanes // gs, S - 1)
        g = np.take_along_axis(gsel[:lanes.shape[0]], slot, axis=1)
        res["top_idx"] = np.minimum(
            g * gs + lanes % gs, T - 1
        ).astype(np.int32)
    nh = res["n_hashes"][:B0].astype(np.int64)
    l1 = batch.len1.astype(np.int64)
    l2 = (batch.len2.astype(np.int64) if batch.paired
          else np.zeros(B0, np.int64))
    return _finish_batch_compact(
        batch, ctx, cfg, rep, level_totals, first, last, out,
        one_files, all_files, res, nh, l1, l2,
    )


def _classify_batch(
    batch: EncodedBatch,
    ctx: LevelContext,
    cfg: ClassifyConfig,
    rep: dict,
    level_totals: dict[str, Total],
    first: bool,
    last: bool,
    out: _Out,
    one_files: dict,
    all_files: dict,
) -> EncodedBatch | None:
    """Classify one batch at one level; returns leftover (unclassified)."""
    B0 = len(batch)
    w = ctx.window_size
    batch_pad = dev.bucket_len(B0, minimum=64)
    codes1, len1, codes2, len2, m1, m2 = dev.batch_to_device(batch, w, batch_pad)

    import jax.numpy as jnp

    hashes, mask, n_hashes_d = dev.extract_hashes(
        jnp.asarray(codes1),
        jnp.asarray(len1),
        jnp.asarray(codes2) if codes2 is not None else None,
        jnp.asarray(len2) if len2 is not None else None,
        k=ctx.kmer_size,
        w=w,
        m1=m1,
        m2=m2,
    )
    # compact emitted hashes (shared across the level's filters): ~4x
    # fewer table fetches; reads overflowing the compaction width fall
    # back to the exact uncompacted arrays
    mc = dev.compact_width(hashes.shape[1])
    if mc and mc < hashes.shape[1]:
        from ganon_tpu.ops.ibf_query import compact_hashes

        hc, mk, overflow = compact_hashes(hashes, mask, max_compact=mc)
        if not bool(np.asarray(overflow).any()):
            hashes, mask = hc, mk
    # bound the uncompacted gather working set: overflowing long reads
    # would otherwise materialize [B, M, W] gather temporaries of
    # several GB each (4.9 GB at [512 reads, 9970 positions, 1 KB rows])
    Bp, M = hashes.shape
    step = Bp
    if M > 2048:
        step = max(1, min(Bp, _FALLBACK_GATHER_ROWS // M))
        p = 1
        while p * 2 <= step and Bp % (p * 2) == 0:
            p *= 2
        step = p
    def _fcounts(f, spec, h, m, nh_d):
        # pruned forests apply their coarse gate (the filter's DEFINED
        # semantics — index.pruned) so this fallback stays bit-identical
        # to the pruned fast path; plain filters are ungated
        if hasattr(f, "counts_gated"):
            return f.counts_gated(h, m, nh_d, spec.rel_cutoff)
        return f.counts(h, m, nh_d)

    if step < Bp:
        import jax.numpy as jnp

        counts_dev = [
            jnp.concatenate(
                [
                    _fcounts(f, spec, hashes[i:i + step],
                             mask[i:i + step], n_hashes_d[i:i + step])
                    for i in range(0, Bp, step)
                ],
                axis=0,
            )
            for f, spec in zip(ctx.filters, ctx.specs)
        ]
    else:
        counts_dev = [
            _fcounts(f, spec, hashes, mask, n_hashes_d)
            for f, spec in zip(ctx.filters, ctx.specs)
        ]
    nh = np.asarray(n_hashes_d)[:B0].astype(np.int64)
    l1 = batch.len1.astype(np.int64)
    l2 = (
        batch.len2.astype(np.int64)
        if batch.paired
        else np.zeros(B0, np.int64)
    )

    # single-filter fast path: thresholds + top-K compaction on device
    if len(ctx.filters) == 1 and cfg.device_thresholding:
        res = dev.threshold_topk(
            counts_dev[0],
            n_hashes_d,
            ctx.specs[0].rel_cutoff,
            ctx.level.rel_filter,
            cfg.hashes_limit,
            top_k=cfg.top_k_matches,
            sort16=(ctx.filters[0].num_targets <= 0xFFFF
                    and cfg.hashes_limit <= 0xFFFF),
            emit_matches_t=ctx.level.fpr_query >= 1.0,
        )
        res = {k: np.asarray(v) for k, v in res.items()}
        if not (res["n_matches"][:B0] > res["top_vals"].shape[1]).any():
            return _finish_batch_compact(
                batch, ctx, cfg, rep, level_totals, first, last, out,
                one_files, all_files, res, nh, l1, l2,
            )
        # top-K overflow: fall through to the full-matrix path

    counts_list = [np.asarray(c)[:B0] for c in counts_dev]

    small = l1 < w
    big = (~small) & (nh > cfg.hashes_limit)
    ok = (~small) & (~big)

    tot = level_totals[batch.prefix]
    if first:
        tot.seqs_skipped_small += int(small.sum())
        tot.seqs_skipped_big += int(big.sum())
        tot.seqs_processed += int(ok.sum())
        tot.length_processed += int((l1 + l2)[ok].sum())
        tot.kmers_processed += int(nh[ok].sum())

    U = len(ctx.union_targets)
    union_counts = np.zeros((B0, U), dtype=np.int64)
    union_fpr = np.zeros((B0, U), dtype=np.float64)
    for fi, (f, counts) in enumerate(zip(ctx.filters, counts_list)):
        spec = ctx.specs[fi]
        cutoff = np.maximum(np.ceil(nh * spec.rel_cutoff), 1).astype(np.int64)
        kept = (counts >= cutoff[:, None]) & ok[:, None]
        cand = np.where(kept, counts.astype(np.int64), 0)
        uf = np.zeros((B0, U), dtype=np.int64)
        uf[:, ctx.filter_cols[fi]] = cand
        better = uf > union_counts
        union_counts = np.where(better, uf, union_counts)
        fpr_row = np.zeros(U, dtype=np.float64)
        fpr_row[ctx.filter_cols[fi]] = ctx.filter_fprs[fi]
        union_fpr = np.where(better, fpr_row[None, :], union_fpr)

    kept_any = union_counts > 0
    max_count = union_counts.max(axis=1)
    with np.errstate(invalid="ignore"):
        min_kept = np.where(kept_any, union_counts, np.iinfo(np.int64).max).min(axis=1)
    min_count = np.minimum(nh, min_kept)

    rel_filter = ctx.level.rel_filter
    threshold_filter = max_count - np.ceil((max_count - min_count) * rel_filter)
    pass_filter = kept_any & (union_counts >= threshold_filter[:, None])

    # rel-filter discards
    disc_f = kept_any & ~pass_filter
    prefix = batch.prefix
    tal = ctx.tally(prefix)
    T = len(ctx.union_targets)

    if disc_f.any():
        tal["disc_filter"] += disc_f.sum(axis=0)[:T]
        tot.discarded_matches_filter += int(disc_f.sum())

    # fpr-query filter: vectorized count-threshold comparison (the
    # binomial tail is monotone in count; thresholds.FprQueryMinCount)
    final = pass_filter
    if ctx.level.fpr_query < 1.0:
        ii, jj = np.nonzero(pass_filter)
        if len(ii):
            cmin = ctx.fpr_min.min_count_arr(nh[ii], union_fpr[ii, jj])
            drop = union_counts[ii, jj] < cmin
            final = pass_filter.copy()
            final[ii[drop], jj[drop]] = False
            disc_q = pass_filter & ~final
            if disc_q.any():
                tal["disc_fpr"] += disc_q.sum(axis=0)[:T]
                tot.discarded_matches_fprquery += int(disc_q.sum())

    classified = final.any(axis=1)
    n_matches = final.sum(axis=1)

    tot.seqs_classified += int(classified.sum())
    tot.kmers_from_classified_seqs += int(nh[classified].sum())
    tot.kmers_matches += int(max_count[classified].sum())
    tot.matches += int(n_matches.sum())
    tot.seqs_unique += int((classified & (n_matches == 1)).sum())

    tal["matches"] += final.sum(axis=0)[:T]

    # vectorized finish (mirrors _finish_batch_compact): bincount
    # accounting + deferred line formatting on the writer thread
    tn = ctx.union_targets
    ids = batch.ids
    uniq_rows = np.nonzero(classified & (n_matches == 1))[0]
    multi_rows = np.nonzero(classified & (n_matches > 1))[0]

    if len(uniq_rows):
        u_t = np.argmax(final[uniq_rows], axis=1)
        tal["seqs_unique"] += np.bincount(u_t, minlength=T)[:T]
    lca_of: list[str] = []
    if len(multi_rows):
        ltal = ctx.lca_tally(prefix)
        if not cfg.skip_lca:
            # batched per-row LCA: left-align each row's match columns,
            # then one RMQ per read (lca.lca_rows)
            F = final[multi_rows]
            order = np.argsort(~F, axis=1, kind="stable")
            nm = n_matches[multi_rows].astype(np.int32)
            cols = order[:, : int(nm.max())]
            lca_ids = ctx.lca.lca_rows(ctx.union_lca_ids[cols], nm)
            lj, ln_ = np.unique(lca_ids, return_counts=True)
            names = [ctx.lca.decode_id(int(i)) for i in lj]
            for name, n in zip(names, ln_):
                ltal[name] = ltal.get(name, 0) + int(n)
            if cfg.output_lca:
                remap = {int(i): nm_ for i, nm_ in zip(lj, names)}
                lca_of = [remap[int(i)] for i in lca_ids]
        else:
            ltal[cfg.tax_root_node] = (
                ltal.get(cfg.tax_root_node, 0) + len(multi_rows)
            )

    if cfg.output_all:
        ai, aj = np.nonzero(final)
        a_v = union_counts[ai, aj]

        def _fmt_all(ai=ai, aj=aj, a_v=a_v, ids=ids, tn=tn):
            return "".join(
                f"{ids[i]}\t{tn[j]}\t{v}\n"
                for i, j, v in zip(ai.tolist(), aj.tolist(), a_v.tolist())
            )

        out.submit(all_files[prefix], _fmt_all)
    if cfg.output_lca and not cfg.skip_lca:
        u_v = (
            union_counts[uniq_rows, np.argmax(final[uniq_rows], axis=1)]
            if len(uniq_rows) else np.empty(0, np.int64)
        )
        u_j = (
            np.argmax(final[uniq_rows], axis=1)
            if len(uniq_rows) else np.empty(0, np.int64)
        )
        m_c = max_count[multi_rows]

        def _fmt_one(uniq_rows=uniq_rows, u_j=u_j, u_v=u_v,
                     multi_rows=multi_rows, lca_of=lca_of, m_c=m_c,
                     ids=ids, tn=tn):
            parts = [
                f"{ids[i]}\t{tn[j]}\t{v}\n"
                for i, j, v in zip(
                    uniq_rows.tolist(), u_j.tolist(), u_v.tolist()
                )
            ]
            parts += [
                f"{ids[i]}\t{t}\t{c}\n"
                for i, t, c in zip(multi_rows.tolist(), lca_of, m_c.tolist())
            ]
            return "".join(parts)

        out.submit(one_files[prefix], _fmt_one)

    left = np.nonzero(~classified)[0]
    if last:
        if cfg.output_unclassified and len(left):
            out.submit(
                cfg.output_prefix + prefix + ".unc",
                lambda left=left, ids=ids: "".join(
                    ids[i] + "\n" for i in left.tolist()
                ),
            )
        return None
    return batch.select(left.astype(np.int64))


def _finish_batch_compact(
    batch, ctx, cfg, rep, level_totals, first, last, out, one_files,
    all_files, res, nh, l1, l2,
):
    """Host finish for the device-thresholded compact path."""
    B0 = len(batch)
    w = ctx.window_size
    prefix = batch.prefix
    tot = level_totals[prefix]

    small = l1 < w
    big = (~small) & (nh > cfg.hashes_limit)
    ok = (~small) & (~big)
    if first:
        tot.seqs_skipped_small += int(small.sum())
        tot.seqs_skipped_big += int(big.sum())
        tot.seqs_processed += int(ok.sum())
        tot.length_processed += int((l1 + l2)[ok].sum())
        tot.kmers_processed += int(nh[ok].sum())

    top_vals = res["top_vals"][:B0].copy()
    top_idx = res["top_idx"][:B0].copy()
    n_matches = res["n_matches"][:B0].astype(np.int64).copy()
    max_count = res["max_count"][:B0].astype(np.int64)

    tal = ctx.tally(prefix)
    T = len(ctx.union_targets)

    # rel-filter discards (device tally; unaffected by fpr-query)
    tal["disc_filter"] += res["disc_t"]
    tot.discarded_matches_filter += int(res["disc_t"].sum())

    if ctx.level.fpr_query < 1.0:
        # vectorized: min passing count per (n_hashes, fpr) pair, then
        # one array comparison + stable left-compaction of survivors.
        # single filter: fpr by (union == filter) target index; multi:
        # the device reports which filter won each match (reference
        # semantics: the winner's fpr, GanonClassify.cpp:533)
        Kc = top_vals.shape[1]
        valid = np.arange(Kc)[None, :] < n_matches[:, None]
        top_win = res.get("top_win")
        if top_win is not None:
            fpr_mat = np.stack(ctx.union_fprs)[top_win[:B0], top_idx]
        else:
            fpr_mat = ctx.union_fprs[0][top_idx]
        ii, jj = np.nonzero(valid)
        if len(ii):
            cmin = ctx.fpr_min.min_count_arr(nh[ii], fpr_mat[ii, jj])
            keep = valid.copy()
            keep[ii, jj] = top_vals[ii, jj] >= cmin
            disc = valid & ~keep
            if disc.any():
                tal["disc_fpr"] += np.bincount(top_idx[disc],
                                               minlength=T)[:T]
                tot.discarded_matches_fprquery += int(disc.sum())
                order = np.argsort(~keep, axis=1, kind="stable")
                top_idx = np.take_along_axis(top_idx, order, axis=1)
                top_vals = np.take_along_axis(top_vals, order, axis=1)
                n_matches = keep.sum(axis=1).astype(np.int64)
        classified = n_matches > 0
        tot.seqs_classified += int(classified.sum())
        tot.kmers_from_classified_seqs += int(nh[classified].sum())
        tot.kmers_matches += int(max_count[classified].sum())
        tot.matches += int(n_matches.sum())
        tot.seqs_unique += int((n_matches == 1).sum())
        vkeep = np.arange(top_vals.shape[1])[None, :] < n_matches[:, None]
        tal["matches"] += np.bincount(top_idx[vkeep], minlength=T)[:T]
    else:
        classified = n_matches > 0
        tot.seqs_classified += int(res["seqs_classified"])
        tot.kmers_from_classified_seqs += int(res["kmers_from_classified"])
        tot.kmers_matches += int(res["kmers_matches"])
        tot.matches += int(n_matches.sum())
        tot.seqs_unique += int((n_matches == 1).sum())
        tal["matches"] += res["matches_t"]

    # vectorized finish: bincount accounting + deferred line formatting
    # on the writer thread (overlaps the next batch's device wait)
    tn = ctx.union_targets
    ids = batch.ids
    uniq_rows = np.nonzero(n_matches == 1)[0]
    multi_rows = np.nonzero(n_matches > 1)[0]

    if len(uniq_rows):
        tal["seqs_unique"] += np.bincount(top_idx[uniq_rows, 0],
                                          minlength=T)[:T]
    lca_of: list[str] = []
    if len(multi_rows):
        ltal = ctx.lca_tally(prefix)
        if not cfg.skip_lca:
            # batched per-row LCA (one RMQ per read, no Python fold)
            lca_ids = ctx.lca.lca_rows(
                ctx.union_lca_ids[top_idx[multi_rows]],
                n_matches[multi_rows],
            )
            lj, ln_ = np.unique(lca_ids, return_counts=True)
            names = [ctx.lca.decode_id(int(i)) for i in lj]
            for name, n in zip(names, ln_):
                ltal[name] = ltal.get(name, 0) + int(n)
            if cfg.output_lca:
                # decoded strings are only needed for .one lines; map
                # through the (small) unique set instead of per-read
                remap = {int(i): nm for i, nm in zip(lj, names)}
                lca_of = [remap[int(i)] for i in lca_ids]
        else:
            ltal[cfg.tax_root_node] = (
                ltal.get(cfg.tax_root_node, 0) + len(multi_rows)
            )

    if cfg.output_all:
        vmask = np.arange(top_vals.shape[1])[None, :] < n_matches[:, None]
        ai, aj = np.nonzero(vmask)
        a_t = top_idx[ai, aj]
        a_v = top_vals[ai, aj]

        def _fmt_all(ai=ai, a_t=a_t, a_v=a_v, ids=ids, tn=tn):
            return "".join(
                f"{ids[i]}\t{tn[t]}\t{v}\n"
                for i, t, v in zip(ai.tolist(), a_t.tolist(), a_v.tolist())
            )

        out.submit(all_files[prefix], _fmt_all)
    if cfg.output_lca and not cfg.skip_lca:
        u_t = top_idx[uniq_rows, 0] if len(uniq_rows) else uniq_rows
        u_v = top_vals[uniq_rows, 0] if len(uniq_rows) else uniq_rows
        m_c = max_count[multi_rows]

        def _fmt_one(uniq_rows=uniq_rows, u_t=u_t, u_v=u_v,
                     multi_rows=multi_rows, lca_of=lca_of, m_c=m_c,
                     ids=ids, tn=tn):
            parts = [
                f"{ids[i]}\t{tn[t]}\t{v}\n"
                for i, t, v in zip(
                    uniq_rows.tolist(), u_t.tolist(), u_v.tolist()
                )
            ]
            parts += [
                f"{ids[i]}\t{t}\t{c}\n"
                for i, t, c in zip(multi_rows.tolist(), lca_of, m_c.tolist())
            ]
            return "".join(parts)

        out.submit(one_files[prefix], _fmt_one)

    left = np.nonzero(n_matches == 0)[0]
    if last:
        if cfg.output_unclassified and len(left):
            out.submit(
                cfg.output_prefix + prefix + ".unc",
                lambda left=left, ids=ids: "".join(
                    ids[i] + "\n" for i in left.tolist()
                ),
            )
        return None
    return batch.select(left.astype(np.int64))


def _write_rep(rep, ctx: LevelContext, cfg: ClassifyConfig, label, out: _Out):
    """Write one level's .rep rows (GanonClassify.cpp:834-853)."""
    by_prefix: dict[str, list] = {}
    for (prefix, target), r in rep.items():
        if r.matches or r.seqs_lca or r.seqs_unique:
            by_prefix.setdefault(prefix, []).append((target, r))
    for prefix, items in by_prefix.items():
        f = out.get(cfg.output_prefix + prefix + ".rep")
        for target, r in items:
            line = f"{label}\t{target}\t{r.matches}\t{r.seqs_unique}\t{r.seqs_lca}"
            if ctx.tax:
                node = ctx.tax.get(target, (cfg.tax_root_node, "no rank", target))
                line += f"\t{node[1]}\t{node[2]}"
            f.write(line + "\n")


def _write_stats(cfg, totals, hierarchy_totals, levels, prefixes):
    """.sta TSV, 18 columns per hierarchy + -total- row
    (GanonClassify.cpp:1130-1218)."""
    header = [
        "prefix", "hierarchy_label", "seq_processed", "seq_unclassified",
        "seq_classified", "seq_classified_perc", "seq_unique_matches",
        "seq_unique_matches_perc", "seq_multiple_matches",
        "seq_multiple_matches_perc", "matches", "avg_matches_ref_seq",
        "dis_matches_rel_filter", "dis_matches_fpr_query", "kmers_proccessed",
        "kmers_matched", "kmers_from_classified_seqs", "kmers_matched_perc",
    ]
    for p in prefixes:
        total = totals[p]
        seq_unclassified = total.seqs_processed - total.seqs_classified
        seq_processed = float(total.seqs_processed) if total.seqs_processed else 1.0
        with open(cfg.output_prefix + p + ".sta", "w") as f:
            f.write("\t".join(header) + "\n")

            def row(t: Total, label: str):
                smm = t.seqs_classified - t.seqs_unique
                avg = t.matches / t.seqs_classified if t.seqs_classified else 0
                kperc = (
                    (t.kmers_matches / t.kmers_from_classified_seqs) * 100
                    if t.kmers_matches
                    else 0
                )
                cols = [
                    p, label, int(seq_processed), seq_unclassified,
                    t.seqs_classified,
                    f"{(t.seqs_classified / seq_processed) * 100:.6f}",
                    t.seqs_unique,
                    f"{(t.seqs_unique / seq_processed) * 100:.6f}",
                    smm,
                    f"{(smm / seq_processed) * 100:.6f}",
                    t.matches,
                    f"{avg:.6f}",
                    t.discarded_matches_filter,
                    t.discarded_matches_fprquery,
                    total.kmers_processed,
                    t.kmers_matches,
                    t.kmers_from_classified_seqs,
                    f"{kperc:.6f}",
                ]
                f.write("\t".join(str(c) for c in cols) + "\n")

            for label in levels:
                row(hierarchy_totals[label][p], label)
            if len(levels) > 1:
                row(total, "-total-")


def _print_stats(totals, elapsed: float = 0.0):
    for p, t in totals.items():
        sp = float(t.seqs_processed) if t.seqs_processed else 1.0
        print(
            f"{'[' + p + '] ' if p else ''}{t.seqs_classified} sequences "
            f"classified ({t.seqs_classified / sp * 100:.2f}%), "
            f"{t.seqs_unique} unique, {t.matches} matches",
            file=sys.stderr,
        )
    if elapsed > 0:
        bp = sum(t.length_processed for t in totals.values())
        seqs = sum(t.seqs_processed for t in totals.values())
        # reference prints the same Mbp/m figure (GanonClassify.cpp:1091)
        print(
            f"ganon-tpu classify processed {seqs} sequences "
            f"({bp / 1e6:.2f} Mbp) in {elapsed:.3f}s "
            f"({bp / 1e6 / (elapsed / 60):.1f} Mbp/m, "
            f"{seqs / elapsed:,.0f} reads/s)",
            file=sys.stderr,
        )
