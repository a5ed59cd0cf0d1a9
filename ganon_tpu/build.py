"""build / build-custom / update orchestration.

Functional equivalent of the reference's ``src/ganon/build_update.py``:
parses input files/sequences, resolves taxonomy (NCBI/GTDB/custom, offline
files supported), writes ``.tax`` + ``target_info.tsv``, runs the device
build engine, and supports resume states, restart and pickled-config
updates. Network acquisition (genome_updater equivalent) accepts local
assembly_summary files for offline operation.
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
import sys
import time

import pandas as pd

from ganon_tpu import taxonomy as taxmod
from ganon_tpu.index.builder import BuildConfig, run_build
from ganon_tpu.util import (
    check_file,
    clear_states,
    load_state,
    print_log,
    rm_files,
    save_state,
    set_output_folder,
    validate_input_files,
)

INFO_COLS = ["file", "target", "node", "specialization", "specialization_name"]
CHOICES_LEVEL = ["assembly", "custom"]
CHOICES_INPUT_TARGET = ["file", "sequence"]


# --------------------------------------------------------------------------
# input parsing


def parse_input_file(input_file, input_target, quiet=True):
    """--input-file TSV with 1..5 cols (build_update.py:586-610)."""
    info = pd.read_csv(input_file, sep="\t", header=None, dtype=object)
    info.rename(columns=lambda x: INFO_COLS[x], inplace=True)
    info = pd.concat([info, pd.DataFrame(columns=INFO_COLS)])
    if info["target"].isna().all() and input_target == "file":
        info["target"] = info["file"].apply(os.path.basename)
    total = len(info["file"].unique().tolist())
    valid = validate_input_files(info["file"].unique().tolist(), "", quiet)
    if total - len(valid) > 0:
        info = info[info["file"].isin(valid)]
        print_log(f" - {total - len(valid)} invalid files skipped", quiet)
    return info


ASSEMBLY_ACCESSION_RE = re.compile(r"GC[A|F]_[0-9]+\.[0-9]+")


def parse_file_accession(input_files):
    """Assembly accession from filename, else basename
    (tax_util.py:55-74)."""
    rows = []
    for file in input_files:
        m = ASSEMBLY_ACCESSION_RE.search(file)
        rows.append((m.group() if m else os.path.basename(file), file))
    info = pd.DataFrame(columns=INFO_COLS)
    info[["target", "file"]] = pd.DataFrame(rows)
    return info


def parse_sequence_accession(input_files, build_output_folder):
    """Split input fastas per sequence; target = seqid up to first space
    (tax_util.py:11-52, python instead of awk)."""
    from ganon_tpu.io.sequence import SequenceReader

    rows = []
    n_folders = 10
    for sub in range(n_folders):
        os.makedirs(os.path.join(build_output_folder, str(sub)), exist_ok=True)
    i = 0
    for file in input_files:
        for header, seq in SequenceReader(file):
            seqid = header.split(" ")[0]
            sub = str(i % n_folders)
            out = os.path.join(build_output_folder, sub, seqid + ".fna")
            with open(out, "w") as f:
                f.write(f">{header}\n{seq}\n")
            rows.append((seqid, out))
            i += 1
    info = pd.DataFrame(columns=INFO_COLS)
    if rows:
        info[["target", "file"]] = pd.DataFrame(rows)
    return info


def load_input(cfg, input_files, build_output_folder):
    """Target info frame from --input-file or --input
    (build_update.py:611-694)."""
    if cfg.input_file:
        info = parse_input_file(cfg.input_file, cfg.input_target, cfg.quiet)
        if cfg.input_target == "sequence":
            info_seqs = parse_sequence_accession(
                info["file"].unique().tolist(), build_output_folder
            )
            info = pd.merge(
                left=info, right=info_seqs, on="target", suffixes=("", "_seqs")
            )[INFO_COLS + ["file_seqs"]]
            info["file"] = info["file_seqs"]
            info.drop("file_seqs", axis=1, inplace=True)
    else:
        if cfg.input_target == "sequence":
            info = parse_sequence_accession(input_files, build_output_folder)
        else:
            info = parse_file_accession(input_files)

    info.dropna(how="all", inplace=True)
    info.dropna(subset=["target"], inplace=True)
    info.drop_duplicates(subset=["target"], inplace=True)
    info.set_index("target", inplace=True)
    print_log(f" - {info.shape[0]} unique entries", cfg.quiet)
    return info


# --------------------------------------------------------------------------
# taxonomy resolution


def load_taxonomy(cfg, build_output_folder=None):
    tax_ver = cfg.taxonomy.split("-")
    if tax_ver[0] == "ncbi":
        files = cfg.taxonomy_files
        if not files:
            # auto-fetch like multitax (reference build_update.py:706-718);
            # honors the local_dir repository override
            from ganon_tpu.acquire import fetch_taxdump

            files = [fetch_taxdump(build_output_folder or ".", cfg.quiet)]
        tax = taxmod.load_ncbi(files=files)
    elif tax_ver[0] == "gtdb":
        files = cfg.taxonomy_files
        if not files:
            from ganon_tpu.acquire import fetch_gtdb_tax

            files = fetch_gtdb_tax(build_output_folder or ".", cfg.quiet)
        tax = taxmod.load_gtdb(files=files)
    else:
        raise ValueError(f"unknown taxonomy: {cfg.taxonomy}")
    if cfg.level not in [None, "", "leaves"] + CHOICES_LEVEL:
        if cfg.level not in tax.ranks():
            print_log(
                f" - {cfg.level} not found in taxonomic ranks, changing to "
                "--level 'leaves'",
                cfg.quiet,
            )
            cfg.level = "leaves"
    return tax


ASSEMBLY_SUMMARY_PREFIXES = (
    "refseq", "genbank", "refseq_historical", "genbank_historical",
)


def get_file_info(cfg, info, tax, build_output_folder=None):
    """Resolve taxids (+assembly specialization) for file accessions
    (tax_util.get_file_info:227-281): assembly_summary files/prefixes for
    NCBI, accession->node from the taxonomy files for GTDB."""
    if cfg.taxonomy.startswith("gtdb"):
        info.update(get_gtdb_target_node(tax, cfg.level))
        return
    files, urls = [], []
    for entry in cfg.ncbi_file_info:
        if entry in ASSEMBLY_SUMMARY_PREFIXES:
            source = entry.split("_")[0]
            ncbi_url = getattr(
                cfg, "ncbi_url", "https://ftp.ncbi.nlm.nih.gov/"
            ).rstrip("/")
            urls.append(
                ncbi_url + "/genomes/" + source
                + "/assembly_summary_" + entry + ".txt"
            )
        else:
            files.append(entry)
    if urls:
        from ganon_tpu.util import download

        files.extend(download(urls, build_output_folder or "."))
    files = [f for f in files if check_file(f)]
    if not files:
        raise ValueError(
            "no valid assembly_summary file(s) via --ncbi-file-info"
        )
    counts = parse_assembly_summary(info, files, cfg.level)
    for f, cnt in counts.items():
        print_log(f" - {cnt} entries found in {os.path.basename(f)}", cfg.quiet)


def get_gtdb_target_node(tax, level):
    """Accession -> GTDB leaf node from the taxonomy source files
    (tax_util.get_gtdb_target_node:283-315)."""
    rows = {}
    for source in getattr(tax, "sources", []):
        import gzip as _gzip

        op = _gzip.open if str(source).endswith(".gz") else open
        with op(source, "rt") as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 2:
                    continue
                acc = fields[0]
                acc = acc[3:] if acc[:3] in ("RS_", "GB_") else acc
                rows[acc] = fields[1].split(";")[-1].strip()
    out = pd.DataFrame({"node": pd.Series(rows, dtype=str)})
    out.index.name = "target"
    if level == "assembly":
        out["specialization"] = out.index
        out["specialization_name"] = out["node"].map(tax.name)
    return out


def get_sequence_info(cfg, info, tax, build_output_folder=None):
    """Resolve taxids (+assembly specialization) for sequence accessions
    (tax_util.get_sequence_info:318-437): e-utils in auto mode for small
    inputs, accession2taxid prefixes/files otherwise; assembly level always
    goes through e-utils."""
    max_seqs_eutils = 50000
    acc2txid_prefixes = (
        "nucl_gb", "nucl_wgs", "nucl_est", "nucl_gss", "pdb", "prot",
        "dead_nucl", "dead_wgs", "dead_prot",
    )
    if not cfg.ncbi_sequence_info:
        mode = (["eutils"] if info.shape[0] <= max_seqs_eutils
                else ["nucl_gb", "nucl_wgs"])
    elif "eutils" in cfg.ncbi_sequence_info:
        mode = ["eutils"]
    else:
        mode = list(cfg.ncbi_sequence_info)

    if mode[0] == "eutils":
        from ganon_tpu.eutils import run_eutils

        print_log("Retrieving sequence information from NCBI e-utils",
                  cfg.quiet)
        info.update(run_eutils(
            info, build_output_folder or ".", skip_taxid=False,
            level=cfg.level, quiet=cfg.quiet,
        ))
        return

    files, urls = [], []
    for entry in mode:
        if entry in acc2txid_prefixes:
            ncbi_url = getattr(
                cfg, "ncbi_url", "https://ftp.ncbi.nlm.nih.gov/"
            ).rstrip("/")
            urls.append(
                ncbi_url + "/pub/taxonomy/accession2taxid/"
                + entry + ".accession2taxid.gz"
            )
        else:
            files.append(entry)
    if urls:
        from ganon_tpu.util import download

        files.extend(download(urls, build_output_folder or "."))
    files = [f for f in files if check_file(f)]
    if not files:
        raise ValueError(
            "no valid accession2taxid file(s) via --ncbi-sequence-info"
        )
    counts = parse_acc2txid(info, files)
    for f, cnt in counts.items():
        print_log(f" - {cnt} entries found in {os.path.basename(f)}", cfg.quiet)
    if cfg.level == "assembly":
        from ganon_tpu.eutils import run_eutils

        print_log("Retrieving assembly information from NCBI e-utils",
                  cfg.quiet)
        info.update(run_eutils(
            info, build_output_folder or ".", skip_taxid=True,
            level="assembly", quiet=cfg.quiet,
        ))


def parse_acc2txid(info, acc2txid_files):
    """accession.version -> taxid merge (tax_util.py:440-482)."""
    count = {}
    unique_acc = set(info.index)
    for acc2txid in acc2txid_files:
        count[acc2txid] = 0
        with pd.read_csv(
            acc2txid, sep="\t", header=None, skiprows=1, usecols=[1, 2],
            names=["target", "node"], index_col="target",
            converters={"target": lambda x: x if x in unique_acc else None,
                        "node": str},
            chunksize=10**6,
        ) as reader:
            for chunk in reader:
                chunk = chunk[chunk.index.notnull()]
                chunk = chunk[chunk["node"] != "0"]
                if chunk.shape[0]:
                    info.update(chunk)
                    count[acc2txid] += chunk.shape[0]
                    if sum(count.values()) == len(unique_acc):
                        break
    return count


def parse_assembly_summary(info, assembly_summary_files, level):
    """assembly accession -> taxid (+assembly specialization)
    (tax_util.py:485-552)."""
    count = {}
    unique_acc = set(info.index)
    for summary in assembly_summary_files:
        header_lines = 0
        with open(summary) as f:
            for line in f:
                if line[0] == "#":
                    header_lines += 1
                else:
                    break
        tmp = pd.read_csv(
            summary, sep="\t", header=None, skiprows=header_lines,
            usecols=[0, 5, 7, 8],
            names=["target", "node", "organism_name", "infraspecific_name"],
            index_col="target",
            converters={"target": lambda x: x if x in unique_acc else None,
                        "node": str},
        )
        tmp = tmp[tmp.index.notnull()]
        count[summary] = tmp.shape[0]
        if not count[summary]:
            continue
        if level == "assembly":
            tmp["infraspecific_name"] = (
                tmp["infraspecific_name"].replace("^[a-z]+=", "", regex=True)
                .fillna("")
            )

            def build_name(n):
                if n.organism_name.endswith(n.infraspecific_name):
                    return n.organism_name
                return n.organism_name + " " + n.infraspecific_name

            tmp["specialization_name"] = tmp[
                ["organism_name", "infraspecific_name"]
            ].apply(build_name, axis=1)
            tmp["specialization"] = tmp.index
        info.update(tmp)
        if sum(count.values()) == len(unique_acc):
            break
    return count


def _convert_nodes(info, tax, cfg):
    """Cross-taxonomy conversion of the node column
    (build_update.py:874-955). Returns the target taxonomy.

    ncbi->ncbi re-resolves ids on the newer taxdump; the gtdb-anchored
    directions map through per-assembly conversion files
    (taxonomy.parse_gtdb_conversion_file) and fold one-to-many results
    with an LCA on the target taxonomy.
    """
    tax_from = cfg.taxonomy.split("-")[0]
    tax_to = cfg.convert_taxonomy.split("-")[0]
    conv_files = list(getattr(cfg, "convert_taxonomy_files", []) or [])
    gtdb_files = list(getattr(cfg, "convert_gtdb_files", []) or [])

    if tax_from == "ncbi" and tax_to == "ncbi" and not cfg.taxonomy_files:
        # already resolved on the latest downloaded taxdump
        return tax
    print_log(
        f" - converting taxonomy [{cfg.taxonomy} -> {cfg.convert_taxonomy}]",
        cfg.quiet,
    )
    def load_target(kind):
        if conv_files:
            return (
                taxmod.load_ncbi(files=conv_files)
                if kind == "ncbi"
                else taxmod.load_gtdb(files=conv_files)
            )
        # no local files: fetch like the source taxonomy does (multitax
        # auto-download in the reference; honors the local_dir override)
        from ganon_tpu import acquire

        if kind == "ncbi":
            return taxmod.load_ncbi(files=[acquire.fetch_taxdump(".", cfg.quiet)])
        return taxmod.load_gtdb(files=acquire.fetch_gtdb_tax(".", cfg.quiet))

    if tax_from == "ncbi" and tax_to == "ncbi":
        target_tax = load_target("ncbi")
        info["node"] = info["node"].apply(
            lambda n: target_tax.latest(n) if n else None
        )
        info["node"] = info["node"].replace("", None)
        return target_tax

    if not gtdb_files:
        raise ValueError(
            "--convert-gtdb-files is required to convert "
            f"[{cfg.taxonomy} -> {cfg.convert_taxonomy}] offline"
        )
    if tax_from == "gtdb" and tax_to == "gtdb":
        target_tax = load_target("gtdb")
        mapping = taxmod.gtdb_conversion_map(gtdb_files[0], gtdb_files[1])
    elif tax_from == "gtdb" and tax_to == "ncbi":
        target_tax = load_target("ncbi")
        # project each assembly's ncbi taxid to the ncbi ancestor at the
        # gtdb node's rank BEFORE the lca fold (assemblies with no
        # ancestor at that rank abstain) — this reproduces the reference
        # expectations (test_build_custom.py:405-445: g__JOSHI-001 ->
        # family 2975441, not the raw-taxid lca at order level)
        raw = taxmod.gtdb_to_ncbi_map(gtdb_files[0])
        mapping = {}
        for node, taxids in raw.items():
            rank = taxmod.GTDB_RANKS.get(node[0])
            # old taxdumps call the top rank superkingdom, new ones domain
            ranks = ("domain", "superkingdom") if rank == "domain" else (rank,)
            projected = set()
            for t in taxids:
                t = target_tax.latest(t)
                for r in ranks:
                    p = target_tax.parent_rank(t, r) if t else None
                    if p:
                        projected.add(p)
                        break
            mapping[node] = projected
    else:  # ncbi -> gtdb
        target_tax = load_target("gtdb")
        # direct taxid match only: an ncbi node with no assembly carrying
        # exactly that taxid does not translate (reference
        # test_build_custom.py:476-481 drops 2648079, the direct parent
        # of a mapped taxid)
        mapping = taxmod.ncbi_to_gtdb_map(gtdb_files[0])

    # one-to-many -> LCA on the target taxonomy (build_update.py:936-942)
    def fold(n):
        if not n:
            return None
        nodes = sorted(mapping.get(n, ()))
        return target_tax.lca(nodes) or None if nodes else None

    info["node"] = info["node"].apply(fold)
    info["node"] = info["node"].replace("", None)
    return target_tax


def validate_convert_taxonomy(info, tax, cfg):
    """Validate nodes on the taxonomy, convert to --convert-taxonomy, and
    apply the --level rank projection (build_update.py:860-1001)."""
    info["node"] = info["node"].apply(
        lambda n: tax.latest(n) if pd.notna(n) else None
    )
    info["node"] = info["node"].replace("", None)

    if getattr(cfg, "convert_taxonomy", ""):
        tax = _convert_nodes(info, tax, cfg)
        cfg.taxonomy = cfg.convert_taxonomy

    if cfg.level and cfg.level not in ["leaves"] + CHOICES_LEVEL:
        info["node"] = info["node"].apply(
            lambda n: tax.parent_rank(n, cfg.level) if n else None
        )
        info["node"] = info["node"].replace("", None)

    na_entries = int(info["node"].isna().sum())
    if cfg.keep_invalid_taxa:
        info["node"] = info["node"].fillna(tax.root_node)
        if na_entries:
            print_log(
                f" - {na_entries} entries without valid taxonomic nodes kept "
                "at the root node",
                cfg.quiet,
            )
    elif na_entries > 0:
        print_log(
            f" - {na_entries} entries without valid taxonomic nodes skipped",
            cfg.quiet,
        )
        info.dropna(subset=["node"], inplace=True)
    return tax


def validate_specialization(info, quiet):
    """Each specialization must have exactly one parent node
    (build_update.py:800-856)."""
    if all(info.specialization.isna()):
        print_log(" - No specialization provided/retrieved", quiet)
    else:
        idx_null = info.specialization.isna()
        node_spec = info[["node", "specialization"]].drop_duplicates()
        idx_multi = info.specialization.isin(
            node_spec.specialization[
                node_spec.specialization.duplicated(keep=False)
            ].unique()
        )
        idx_replace = idx_null | idx_multi
        if idx_replace.any():
            info.loc[idx_replace, "specialization"] = info.index[idx_replace]
            info.loc[idx_replace, "specialization_name"] = info.index[idx_replace]
    info.dropna(subset=["specialization"], inplace=True)
    info["specialization_name"] = info["specialization_name"].fillna(
        info["specialization"]
    )


def write_tax(tax_file, info, tax, genome_sizes, user_bins_col, level,
              input_target):
    """.tax writer with specialization nodes + genome_size column
    (build_update.py:736-778)."""
    if user_bins_col != "node":
        tax_rank = level if level else input_target
        for target, row in info.iterrows():
            tax_node = (
                row["specialization"] if user_bins_col == "specialization" else target
            )
            tax_name = (
                row["specialization_name"]
                if user_bins_col == "specialization"
                else target
            )
            if tax.latest(tax_node) == tax.undefined_node:
                tax.add(tax_node, row["node"], name=tax_name, rank=tax_rank)
            else:
                assert tax.parent(tax_node) == row["node"]
    rm_files(tax_file)
    root_gs = genome_sizes.get(tax.root_node, 1)
    with open(tax_file, "w") as f:
        for node in tax.nodes():
            gs = genome_sizes.get(node)
            if gs is None:
                gs = genome_sizes.get(tax.parent(node), root_gs)
            f.write(
                f"{node}\t{tax.parent(node)}\t{tax.rank(node)}\t"
                f"{tax.name(node)}\t{gs}\n"
            )


def write_target_info(info, user_bins_col, target_info_file):
    with open(target_info_file, "w") as f:
        for target, row in info.iterrows():
            t = row[user_bins_col] if user_bins_col != "target" else target
            f.write(f"{row['file']}\t{t}\n")


def write_info_file(info, filename):
    info.reset_index()[INFO_COLS].to_csv(
        filename, sep="\t", header=False, index=False
    )


# --------------------------------------------------------------------------
# main orchestration


def build_custom(cfg, which_call: str = "build_custom") -> bool:
    files_output_folder = set_output_folder(cfg.db_prefix)
    build_output_folder = os.path.join(files_output_folder, "build/")
    target_info_file = os.path.join(build_output_folder, "target_info.tsv")

    if which_call == "build_custom" and cfg.restart:
        shutil.rmtree(files_output_folder, ignore_errors=True)

    if load_state(which_call + "_parse", files_output_folder):
        print_log("Parse finished - skipping", cfg.quiet)
    else:
        tax = None
        input_files = []
        shutil.rmtree(build_output_folder, ignore_errors=True)
        os.makedirs(build_output_folder, exist_ok=True)

        if cfg.input:
            input_files = validate_input_files(
                cfg.input, cfg.input_extension, cfg.quiet,
                input_recursive=cfg.input_recursive,
            )
            if not input_files:
                raise ValueError("No valid input files found")

        if cfg.taxonomy != "skip":
            tax = load_taxonomy(cfg, build_output_folder)

        info = load_input(cfg, input_files, build_output_folder)
        user_bins_col = "target"
        if cfg.level in CHOICES_LEVEL:
            user_bins_col = "specialization"
        elif cfg.level and cfg.level not in CHOICES_INPUT_TARGET:
            user_bins_col = "node"

        if info.empty:
            raise ValueError("Unable to parse input files")

        if (tax or cfg.level == "assembly") and not cfg.input_file:
            if cfg.input_target == "sequence":
                get_sequence_info(cfg, info, tax, build_output_folder)
            else:
                get_file_info(cfg, info, tax, build_output_folder)

        if tax:
            tax = validate_convert_taxonomy(info, tax, cfg)
            if info.empty:
                raise ValueError("Unable to match taxonomy to targets")

        if cfg.level in CHOICES_LEVEL:
            validate_specialization(info, cfg.quiet)
            if info.empty:
                raise ValueError("Unable to match specialization to targets")

        if tax:
            unique_nodes = info["node"].unique()
            if (
                user_bins_col == "target" and info.index.isin(unique_nodes).any()
            ) or (
                user_bins_col == "specialization"
                and info["specialization"].isin(unique_nodes).any()
            ):
                raise ValueError(
                    f"{user_bins_col} overlaps with taxonomic identifiers"
                )
            # genome sizes from provided files, auto-fetched auxiliary
            # files (tax_util.py:77-105), or 1s when skipped/unavailable
            if cfg.skip_genome_size:
                leaves_sizes = {}
            else:
                gs_files = cfg.genome_size_files
                if not gs_files:
                    from ganon_tpu.acquire import fetch_genome_size_files

                    try:
                        gs_files = fetch_genome_size_files(
                            cfg.taxonomy, build_output_folder, cfg.quiet
                        )
                    except Exception as e:
                        print_log(
                            f" - genome size files unavailable ({e}); "
                            "using size 1",
                            cfg.quiet,
                        )
                        gs_files = []
                leaves_sizes = (
                    taxmod.parse_genome_size_files(gs_files, cfg.taxonomy)
                    if gs_files
                    else {}
                )
            genome_sizes = taxmod.estimate_genome_sizes(
                unique_nodes, tax, leaves_sizes
            )
            tax.filter(unique_nodes)
            write_tax(
                cfg.db_prefix + ".tax", info, tax, genome_sizes, user_bins_col,
                cfg.level, cfg.input_target,
            )

        if cfg.write_info_file:
            write_info_file(info, cfg.db_prefix + ".info.tsv")

        write_target_info(info, user_bins_col, target_info_file)
        save_state(which_call + "_parse", files_output_folder)

    if load_state(which_call + "_run", files_output_folder):
        print_log("Build finished - skipping", cfg.quiet)
    else:
        if cfg.filter_type == "hibf":
            from ganon_tpu.index.hibf import run_build_hibf

            run_build_hibf(
                target_info_file=target_info_file,
                output_file=cfg.db_prefix + ".hibf",
                kmer_size=cfg.kmer_size,
                window_size=cfg.window_size,
                hash_functions=cfg.hash_functions,
                max_fp=cfg.max_fp,
                min_length=cfg.min_length,
                threads=getattr(cfg, "threads", 1) or 1,
                filter_format=getattr(cfg, "filter_format", "tpu"),
                layout=getattr(cfg, "hibf_layout", "auto"),
                quiet=cfg.quiet,
            )
        else:
            bcfg = BuildConfig(
                input_file=target_info_file,
                output_file=cfg.db_prefix + ".ibf",
                kmer_size=cfg.kmer_size,
                window_size=cfg.window_size,
                max_fp=cfg.max_fp if cfg.max_fp else 0,
                filter_size=cfg.filter_size if cfg.filter_size else 0,
                hash_functions=cfg.hash_functions,
                mode=cfg.mode,
                min_length=cfg.min_length,
                threads=getattr(cfg, "threads", 1) or 1,
                quiet=cfg.quiet,
                verbose=cfg.verbose,
                filter_format=getattr(cfg, "filter_format", "tpu"),
            )
            run_build(bcfg)
        save_state(which_call + "_run", files_output_folder)

    ext = ["hibf" if cfg.filter_type == "hibf" else "ibf"]
    if cfg.taxonomy != "skip":
        ext.append("tax")
    ok = all(check_file(cfg.db_prefix + "." + e) for e in ext)
    if ok:
        save_config(cfg, os.path.join(files_output_folder, "config.pkl"))
        if not cfg.keep_files:
            # keep config.pkl for updates; remove temp build folder
            shutil.rmtree(
                os.path.join(files_output_folder, "build/"), ignore_errors=True
            )
        clear_states(which_call, files_output_folder)
        print_log("Build finished successfully", cfg.quiet)
        return True
    raise ValueError("build failed - one or more database files not found")


def update(cfg) -> bool:
    """Update a database built with ``ganon build``/``build-custom``
    (build_update.py:143-280 semantics).

    When the database folder holds an acquisition ``history.tsv`` (written
    by ``ganon build``), a fresh snapshot is acquired with the recorded
    selection (reference: re-running genome_updater with no args,
    build_update.py:177-188) and the rebuild runs on it; otherwise the
    update rebuilds from the given ``--input``.
    """
    files_output_folder = set_output_folder(cfg.db_prefix)
    config_file = os.path.join(files_output_folder, "config.pkl")
    if not check_file(config_file):
        raise ValueError(
            f"no saved build configuration found at {config_file}; "
            "run build/build-custom with the same --db-prefix first"
        )
    saved = load_config(config_file)
    # apply saved build params, overriding input with the update's
    for key in (
        "kmer_size", "window_size", "hash_functions", "max_fp", "filter_size",
        "mode", "min_length", "taxonomy", "taxonomy_files", "level",
        "input_target", "filter_type", "genome_size_files",
    ):
        unset = getattr(cfg, key, None) in (None, "", [], 0)
        if key == "hash_functions":
            # a defaulted -s 4 must not shadow the saved build's value
            unset = unset or getattr(cfg, "hash_functions_defaulted", False)
        if key in saved and unset:
            setattr(cfg, key, saved[key])
            if key == "hash_functions":
                cfg.hash_functions_defaulted = saved.get(
                    "hash_functions_defaulted", False
                )

    acquired = False
    if check_file(os.path.join(files_output_folder, "history.tsv")):
        from ganon_tpu import acquire

        if load_state("update_download", files_output_folder):
            print_log("Download finished - skipping", cfg.quiet)
        else:
            print_log("Downloading updated files", cfg.quiet)
            acquire.acquire_update(
                files_output_folder,
                threads=getattr(cfg, "threads", 1) or 1,
                quiet=cfg.quiet,
            )
            save_state("update_download", files_output_folder)
        version = acquire.current_version(files_output_folder)
        cfg.input = [os.path.join(files_output_folder, version, "files")]
        cfg.input_extension = "fna.gz"
        cfg.input_recursive = True
        cfg.input_target = "file"
        cfg.ncbi_file_info = [
            os.path.join(files_output_folder, "assembly_summary.txt")
        ]
        acquired = True

    if cfg.output_db_prefix:
        cfg.db_prefix = cfg.output_db_prefix
    ok = build_custom(cfg, which_call="update")

    if ok:
        clear_states("update", files_output_folder)
        if acquired and cfg.output_db_prefix:
            # migrate the acquisition folder (snapshots, history, summary
            # symlink) to the new prefix, reference build_update.py:245-280
            new_folder = set_output_folder(cfg.output_db_prefix)
            os.makedirs(new_folder, exist_ok=True)
            for entry in os.listdir(files_output_folder):
                if entry == "config.pkl":
                    continue
                dst = os.path.join(new_folder, entry)
                if os.path.lexists(dst):
                    continue
                shutil.move(os.path.join(files_output_folder, entry), dst)
            # re-point the saved config at the migrated folder
            new_config = load_config(os.path.join(new_folder, "config.pkl"))
            version = os.path.basename(os.path.dirname(new_config["input"][0]))
            new_config["input"] = [os.path.join(new_folder, version, "files")]
            new_config["ncbi_file_info"] = [
                os.path.join(new_folder, "assembly_summary.txt")
            ]
            with open(os.path.join(new_folder, "config.pkl"), "wb") as f:
                pickle.dump(new_config, f)
            shutil.rmtree(files_output_folder, ignore_errors=True)
    return ok


def save_config(cfg, config_file):
    v = {k: val for k, val in vars(cfg).items() if not k.startswith("_")}
    with open(config_file, "wb") as f:
        pickle.dump(v, f)


def load_config(config_file):
    with open(config_file, "rb") as f:
        return pickle.load(f)
