"""Top-level command orchestration: classify chaining and build download.

Equivalent of ``/root/reference/src/ganon/classify.py`` (db detection,
engine invocation, EM-reassign and report chaining) and the download front
of ``build_update.build`` (genome_updater acquisition; offline operation
uses local assembly_summary files).
"""

from __future__ import annotations

import os

from ganon_tpu.config import Config
from ganon_tpu.util import check_file, find_rep_files, print_log


def classify(cfg) -> bool:
    """ganon classify: engine + optional reassign (EM) + report.

    Multi-host: when the jax distributed runtime spans several
    processes (``--distributed`` or JAX_COORDINATOR_ADDRESS), read
    files are partitioned per host and each host writes under
    ``{output_prefix}.h{process_index}`` (parallel/multihost.py) —
    the shape of the reference's --batch-reads file-level parallelism.
    """
    from ganon_tpu.classify.engine import ClassifyConfig, run_classify
    from ganon_tpu.parallel import multihost

    pidx, pcount = multihost.maybe_initialize(
        force=getattr(cfg, "distributed", False)
    )
    read_stride, read_offset = 1, 0
    if pcount > 1:
        (
            cfg.single_reads, cfg.paired_reads, cfg.batch_reads,
            read_stride, read_offset,
        ) = multihost.shard_reads(
            cfg.single_reads, cfg.paired_reads, cfg.batch_reads,
            pidx, pcount,
        )
        cfg.output_prefix = multihost.host_output_prefix(
            cfg.output_prefix, pidx, pcount
        )
        if not (cfg.single_reads or cfg.paired_reads or cfg.batch_reads):
            print_log(
                f"host {pidx}: no input files in this shard", cfg.quiet
            )
            return True
        if read_stride > 1:
            print_log(
                f"host {pidx}: record-range shard {read_offset}/"
                f"{read_stride} of {len(cfg.single_reads)} single + "
                f"{len(cfg.paired_reads) // 2} paired files", cfg.quiet
            )

    filter_files = []
    tax_files = []
    for dbp in cfg.db_prefix:
        if check_file(dbp + ".hibf"):
            filter_files.append(dbp + ".hibf")
        elif check_file(dbp + ".ibf"):
            filter_files.append(dbp + ".ibf")
        else:
            raise ValueError(f"no .ibf/.hibf found for db prefix {dbp}")
        if check_file(dbp + ".tax"):
            tax_files.append(dbp + ".tax")
    # only use tax if all dbs have one (classify.py:24-27)
    if len(tax_files) != len(filter_files):
        tax_files = []

    ecfg = ClassifyConfig(
        ibf=filter_files,
        tax=tax_files,
        single_reads=cfg.single_reads,
        paired_reads=cfg.paired_reads,
        batch_reads=cfg.batch_reads,
        output_prefix=cfg.output_prefix,
        hierarchy_labels=cfg.hierarchy_labels or ["H1"],
        rel_cutoff=cfg.rel_cutoff or [0.75],
        rel_filter=cfg.rel_filter or [0.1],
        fpr_query=cfg.fpr_query or [1e-5],
        skip_lca=cfg.multiple_matches != "lca",
        output_lca=cfg.multiple_matches == "lca" and cfg.output_one,
        output_all=cfg.output_all or cfg.multiple_matches == "em",
        output_unclassified=cfg.output_unclassified,
        output_stats=cfg.output_stats,
        output_single=cfg.output_single,
        tax_root_node=cfg.tax_root_node,
        n_reads=cfg.n_reads,
        pipeline_depth=getattr(cfg, "pipeline_depth", 4),
        top_k_matches=getattr(cfg, "top_k_matches", 128),
        length_bucketing=not getattr(cfg, "no_length_bucketing", False),
        hashes_limit=(1 << 32) - 1 if getattr(cfg, "longreads", False) else 65535,
        read_stride=read_stride,
        read_offset=read_offset,
        quiet=cfg.quiet,
        verbose=cfg.verbose,
    )
    run_classify(ecfg)

    if cfg.batch_reads:
        prefixes = set()
        for br in cfg.batch_reads:
            with open(br) as f:
                prefixes.update(
                    cfg.output_prefix + row.split("\t")[0] for row in f
                )
        prefixes = sorted(prefixes)
    else:
        prefixes = [cfg.output_prefix]

    if cfg.multiple_matches == "em":
        from ganon_tpu.reassign import ReassignConfig, reassign

        reassign(
            ReassignConfig(
                input_prefix=list(prefixes),
                remove_all=not cfg.output_all,
                skip_one=not cfg.output_one,
                max_iter=cfg.reassign_max_iter,
                threshold=cfg.reassign_threshold,
                quiet=cfg.quiet,
                verbose=cfg.verbose,
            )
        )

    if tax_files and not cfg.skip_report:
        from ganon_tpu.report.report import ReportConfig, report

        report(
            ReportConfig(
                input=[
                    str(r) for pre in prefixes for r in find_rep_files(pre)
                ],
                db_prefix=list(cfg.db_prefix),
                min_count=cfg.min_count,
                ranks=cfg.ranks,
                output_format="tsv",
                report_type=cfg.report_type,
                quiet=cfg.quiet,
                verbose=cfg.verbose,
            )
        )
    return True


def build(cfg) -> bool:
    """ganon build: acquire reference genomes, then build-custom.

    Mirrors build_update.build (/root/reference/src/ganon/build_update.py:
    29-155): versioned download snapshot (native acquisition layer instead
    of the genome_updater.sh subprocess), resume checkpoint, then chains
    into build-custom on the snapshot's files + assembly_summary.
    """
    import shutil

    from ganon_tpu import acquire
    from ganon_tpu.build import build_custom, save_config
    from ganon_tpu.util import (
        load_state, save_state, set_output_folder,
    )

    files_output_folder = set_output_folder(cfg.db_prefix)
    if cfg.restart and os.path.isdir(files_output_folder):
        shutil.rmtree(files_output_folder)
    os.makedirs(files_output_folder, exist_ok=True)

    assembly_summary = os.path.join(files_output_folder, "assembly_summary.txt")
    if load_state("build_download", files_output_folder) and check_file(
        assembly_summary
    ):
        print_log("Download finished - skipping", cfg.quiet)
    else:
        print_log(
            "Downloading files from " + ",".join(cfg.source) + " ["
            + ",".join(cfg.organism_group if cfg.organism_group else cfg.taxid)
            + "]",
            cfg.quiet,
        )
        acquire.acquire(
            files_output_folder,
            sources=cfg.source,
            organism_groups=cfg.organism_group,
            taxids=cfg.taxid,
            complete_genomes=cfg.complete_genomes,
            reference_genomes=cfg.reference_genomes,
            top=cfg.top,
            gtdb=cfg.taxonomy == "gtdb",
            threads=getattr(cfg, "threads", 1) or 1,
            quiet=cfg.quiet,
        )
        save_state("build_download", files_output_folder)

    input_folder = os.path.join(
        files_output_folder, acquire.current_version(files_output_folder),
        "files",
    )

    build_custom_params = {
        "input": [input_folder],
        "input_extension": "fna.gz",
        "input_recursive": True,
        "input_target": "file",
        "ncbi_file_info": [assembly_summary],
    }
    for key in (
        "db_prefix", "level", "taxonomy", "taxonomy_files",
        "genome_size_files", "skip_genome_size", "threads", "max_fp",
        "filter_size", "kmer_size", "window_size", "hash_functions", "mode",
        "min_length", "verbose", "quiet", "filter_type", "write_info_file",
        "keep_files",
    ):
        if hasattr(cfg, key):
            build_custom_params[key] = getattr(cfg, key)
    bc_cfg = Config("build-custom", **build_custom_params)
    bc_cfg.validate()
    save_config(bc_cfg, os.path.join(files_output_folder, "config.pkl"))

    ok = build_custom(cfg=bc_cfg, which_call="build")
    if ok:
        print_log("", cfg.quiet)
        print_log(
            files_output_folder
            + " contains reference sequences and configuration files. Keep "
            "it to update the database later.",
            cfg.quiet,
        )
    return ok
