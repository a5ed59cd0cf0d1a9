"""Behavioral coverage for flags the audit found parse-only.

Round-4 verdict: flag parity was existence-based (the mechanical test
proves all 98 reference flags parse); these tests assert the BEHAVIOR
of the flags docs/flag_audit.md lists as gaps — classify
--output-single naming across 3 hierarchies, reassign
--skip-one/--skip-rep, report --normalize and the
--split-hierarchy/--skip-hierarchy interplay, build-custom --restart
and --keep-invalid-taxa, full-build --mode orderings
(GanonBuild.test.cpp:265-335), acquisition --complete-genomes /
--reference-genomes selection, and --verbose stats output.
"""

import gzip
import os

import numpy as np
import pytest

from ganon_tpu.classify.engine import ClassifyConfig, run_classify
from ganon_tpu.index.ibf import build_ibf

K, W = 19, 31
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mini_dbs(tmp_path, n_dbs=3, targets_per_db=4, glen=3000, seed=5):
    """n_dbs tiny IBFs over disjoint random genomes + reads hitting all."""
    from ganon_tpu.ops.minimizers import window_mins_jax

    rng = np.random.default_rng(seed)
    dbs, genomes = [], []
    for d in range(n_dbs):
        g = rng.integers(0, 4, size=(targets_per_db, glen), dtype=np.uint8)
        genomes.append(g)
        lens = np.full(targets_per_db, glen, dtype=np.int32)
        mv, valid = window_mins_jax(g, lens, k=K, w=W)
        mv, valid = np.asarray(mv), np.asarray(valid)
        th = {
            f"D{d}T{t}": np.unique(mv[t][valid[t]])
            for t in range(targets_per_db)
        }
        p = str(tmp_path / f"db{d}.ibf")
        build_ibf(th, kmer_size=K, window_size=W, max_fp=0.05).save(p)
        dbs.append(p)
    reads = str(tmp_path / "r.fq")
    with open(reads, "w") as f:
        i = 0
        for d, g in enumerate(genomes):
            for t in range(targets_per_db):
                for _ in range(6):
                    s = int(rng.integers(0, glen - 150))
                    seq = BASES[g[t, s:s + 150]].tobytes().decode()
                    f.write(f"@q{i}\n{seq}\n+\n{'I' * 150}\n")
                    i += 1
    return dbs, reads


def test_output_single_three_hierarchies(tmp_path):
    """--output-single folds per-hierarchy .all/.one files into ONE pair
    (reference parse_hierarchy: GanonClassify.cpp:353-401 — per-label
    '{label}.all' names only when NOT output_single); contents must be
    the union of the per-label files."""
    dbs, reads = _mini_dbs(tmp_path)
    labels = ["1_a", "2_b", "3_c"]

    def run(tag, single):
        out = str(tmp_path / tag)
        run_classify(ClassifyConfig(
            ibf=dbs, single_reads=[reads], output_prefix=out,
            hierarchy_labels=labels, rel_cutoff=[0.25] * 3,
            output_all=True, output_single=single, use_mesh=False,
        ))
        return out

    out_m = run("multi", False)
    per_label = []
    for lb in labels:
        path = f"{out_m}.{lb}.all"
        assert os.path.isfile(path), f"expected per-label file {path}"
        per_label.extend(open(path).read().splitlines())
    assert not os.path.isfile(out_m + ".all")

    out_s = run("single", True)
    assert os.path.isfile(out_s + ".all")
    for lb in labels:
        assert not os.path.isfile(f"{out_s}.{lb}.all")
    merged = open(out_s + ".all").read().splitlines()
    assert sorted(merged) == sorted(per_label)
    # every level contributed (reads were drawn from all three dbs)
    tgt_dbs = {line.split("\t")[1][:2] for line in merged}
    assert tgt_dbs == {"D0", "D1", "D2"}


def test_reassign_skip_one_skip_rep(tmp_path):
    """--skip-one leaves .one unwritten; --skip-rep leaves .rep
    untouched (reference reassign.py flags)."""
    from ganon_tpu.reassign import ReassignConfig, reassign

    def fixture(name):
        pre = tmp_path / name
        with open(f"{pre}.all", "w") as f:
            f.write("u1\tA\t10\nm1\tA\t8\nm1\tB\t8\n")
        with open(f"{pre}.rep", "w") as f:
            f.write("H1\tA\t2\t1\t0\nH1\tB\t1\t0\t1\n")
            f.write("#total_classified\t2\n#total_unclassified\t0\n")
        return str(pre)

    pre = fixture("base")
    assert reassign(ReassignConfig(input_prefix=[pre]))
    assert os.path.isfile(pre + ".one")
    base_rep = open(pre + ".rep").read()

    pre1 = fixture("skipone")
    assert reassign(ReassignConfig(input_prefix=[pre1], skip_one=True))
    assert not os.path.isfile(pre1 + ".one")
    assert open(pre1 + ".rep").read() == base_rep  # rep still rewritten

    pre2 = fixture("skiprep")
    before = open(pre2 + ".rep").read()
    assert reassign(ReassignConfig(input_prefix=[pre2], skip_rep=True))
    assert open(pre2 + ".rep").read() == before  # untouched
    assert os.path.isfile(pre2 + ".one")


def _rep_file(path):
    """A two-hierarchy .rep fixture for report tests."""
    with open(path, "w") as f:
        f.write("A\t562\t30\t20\t0\tspecies\tEscherichia coli\n")
        f.write("B\t1280\t12\t8\t0\tspecies\tStaphylococcus aureus\n")
        f.write("#total_classified\t28\n")
        f.write("#total_unclassified\t12\n")
    return path


def _run_report(tmp_path, tag, **over):
    from ganon_tpu.report.report import ReportConfig, report

    rep = _rep_file(str(tmp_path / f"{tag}.rep"))
    kw = dict(
        input=[rep], output_prefix=str(tmp_path / tag),
        taxonomy="skip", report_type="reads", ranks=["all"], quiet=True,
    )
    kw.update(over)
    assert report(ReportConfig(**kw))
    return str(tmp_path / tag)


def test_report_normalize_drops_unclassified(tmp_path):
    """--normalize reports percentages over classified reads only: the
    unclassified row disappears and root cumulative_perc becomes 100%
    (reference report.py parse_rep normalize handling)."""
    out = _run_report(tmp_path, "plain")
    lines = open(out + ".tre").read().splitlines()
    assert any(ln.startswith("unclassified\t") for ln in lines)

    out_n = _run_report(tmp_path, "norm", normalize=True)
    lines_n = open(out_n + ".tre").read().splitlines()
    assert not any(ln.startswith("unclassified\t") for ln in lines_n)
    root = [ln for ln in lines_n if ln.split("\t")[0] == "root"]
    assert root and abs(float(root[0].split("\t")[-1]) - 100.0) < 1e-6


def test_report_split_skip_hierarchy_interplay(tmp_path):
    """--split-hierarchy writes one .tre per hierarchy label EXCEPT the
    --skip-hierarchy ones (reference report.py hierarchy selectors)."""
    out = _run_report(tmp_path, "split", split_hierarchy=True)
    assert os.path.isfile(out + ".A.tre")
    assert os.path.isfile(out + ".B.tre")
    a = open(out + ".A.tre").read()
    assert "562" in a and "1280" not in a

    out2 = _run_report(tmp_path, "splitskip", split_hierarchy=True,
                       skip_hierarchy=["A"])
    assert not os.path.isfile(out2 + ".A.tre")
    assert os.path.isfile(out2 + ".B.tre")
    assert "1280" in open(out2 + ".B.tre").read()


def _write_fasta(path, seq):
    with gzip.open(path, "wt") if str(path).endswith(".gz") else open(
        path, "w"
    ) as f:
        f.write(">s\n")
        f.write(seq + "\n")


def test_build_custom_restart_reruns_parse(tmp_path, capsys):
    """After an interrupted run (parse state present) the next run skips
    the parse stage; --restart wipes the state and re-runs it
    (reference build_update.py:299,1011-1023; states are cleared on
    SUCCESS, so only interrupted runs resume)."""
    from ganon_tpu.cli import main
    from ganon_tpu.config import Config
    from ganon_tpu.util import save_state

    rng = np.random.default_rng(1)
    fa = str(tmp_path / "t.fa")
    _write_fasta(fa, BASES[rng.integers(0, 4, 2000)].tobytes().decode())
    dbp = str(tmp_path / "db")

    def run(**kw):
        import io
        from contextlib import redirect_stderr

        buf = io.StringIO()
        with redirect_stderr(buf):
            ok = main(cfg=Config(
                "build-custom", db_prefix=dbp, input=[fa],
                input_extension="fa", taxonomy="skip",
                input_target="file", verbose=True, keep_files=True, **kw,
            ))
        assert ok
        return buf.getvalue()

    first = run()
    assert "skipping" not in first
    # simulate an interruption AFTER parse: the touch-state exists but
    # the run stage never completed
    save_state("build_custom_parse", dbp + "_files/")
    assert "Parse finished - skipping" in run()
    save_state("build_custom_parse", dbp + "_files/")
    assert "skipping" not in run(restart=True)  # --restart re-runs all


def test_build_custom_keep_invalid_taxa(tmp_path):
    """Entries with no valid taxonomic node are dropped by default but
    kept at the root with --keep-invalid-taxa (build_update.py
    validate_taxonomy semantics)."""
    from ganon_tpu.cli import main
    from ganon_tpu.config import Config

    data = "/root/reference/tests/ganon/data/build-custom"
    if not os.path.isdir(data):
        pytest.skip("reference test data not available")
    rng = np.random.default_rng(2)
    fa = str(tmp_path / "GCA_999999999.1_FAKE_genomic.fna")
    _write_fasta(fa, BASES[rng.integers(0, 4, 2000)].tobytes().decode())

    def run(tag, **kw):
        dbp = str(tmp_path / tag)
        ok = main(cfg=Config(
            "build-custom", db_prefix=dbp, input=[fa],
            input_extension="fna", taxonomy="ncbi",
            taxonomy_files=[os.path.join(data, "taxdump.tar.gz")],
            ncbi_file_info=[os.path.join(data, "assembly_summary.txt")],
            skip_genome_size=True, input_target="file", quiet=True, **kw,
        ))
        return dbp, ok

    # unknown accession -> no node -> build fails (nothing valid left)
    with pytest.raises(ValueError, match="taxonomy"):
        run("drop")
    dbp, ok = run("keep", keep_invalid_taxa=True)
    assert ok
    rows = [ln.split("\t") for ln in open(dbp + ".tax").read().splitlines()]
    kept = [r for r in rows if r[0] == "GCA_999999999.1"]
    assert kept and kept[0][1] == "1"  # kept, parented at the root


def test_build_mode_orderings_full_build(tmp_path):
    """Full builds on a skewed fixture preserve the reference's mode
    invariants (GanonBuild.test.cpp:265-335): smallest filter file <=
    avg; fastest uses no more bins than avg."""
    from ganon_tpu.index.builder import BuildConfig, run_build
    from ganon_tpu.index.ibf import IBF

    rng = np.random.default_rng(3)
    lines = []
    for t in range(12):
        fa = tmp_path / f"t{t}.fa"
        n = 400 + 900 * t  # skewed target sizes (mode_input.tsv analogue)
        _write_fasta(str(fa), BASES[rng.integers(0, 4, n)].tobytes().decode())
        lines.append(f"{fa}\tT{t}\n")
    info = tmp_path / "info.tsv"
    info.write_text("".join(lines))

    results = {}
    for mode in ("avg", "smallest", "fastest"):
        out = str(tmp_path / f"{mode}.ibf")
        run_build(BuildConfig(
            input_file=str(info), output_file=out, kmer_size=K,
            window_size=W, max_fp=0.05, mode=mode,
        ))
        ibf = IBF.load(out)
        results[mode] = (
            ibf.ibf_config.bin_size_bits
            * (ibf.technical_bins // 8),  # filter bits
            ibf.ibf_config.n_bins,
        )
    assert results["smallest"][0] <= results["avg"][0]
    assert results["fastest"][1] <= results["avg"][1]


def test_acquire_complete_and_reference_genomes(tmp_path, monkeypatch):
    """--complete-genomes / --reference-genomes selection filters
    (genome_updater -c / -r analogues) applied to assembly_summary."""
    from ganon_tpu.acquire import select_assemblies

    root = tmp_path / "repo"
    d = root / "genomes" / "genbank" / "bacteria"
    os.makedirs(d)
    hdr = ("# comment\n# assembly_accession\tbioproject\tbiosample\t"
           "wgs_master\trefseq_category\ttaxid\tspecies_taxid\t"
           "organism_name\tinfraspecific_name\tisolate\tversion_status\t"
           "assembly_level\trelease_type\tgenome_rep\tseq_rel_date\t"
           "asm_name\tsubmitter\tgbrs_paired_asm\tpaired_asm_comp\t"
           "ftp_path\texcluded_from_refseq\trelation_to_type_material\t"
           "asm_not_live_date\n")

    def row(acc, cat, level):
        cols = [acc, "", "", "", cat, "100", "100", "Org x", "", "",
                "latest", level, "Major", "Full", "2020/01/01", "a", "s",
                "", "", f"/fake/{acc}", "", "", ""]
        return "\t".join(cols) + "\n"

    with open(d / "assembly_summary.txt", "w") as f:
        f.write(hdr)
        f.write(row("GCA_1.1", "reference genome", "Complete Genome"))
        f.write(row("GCA_2.1", "na", "Complete Genome"))
        f.write(row("GCA_3.1", "na", "Contig"))
    monkeypatch.setenv("local_dir", str(root))

    def accs(**kw):
        df = select_assemblies(
            ["genbank"], organism_groups=["bacteria"],
            workdir=str(tmp_path / "w"), **kw,
        )
        return set(df["assembly_accession"])

    assert accs() == {"GCA_1.1", "GCA_2.1", "GCA_3.1"}
    assert accs(complete_genomes=True) == {"GCA_1.1", "GCA_2.1"}
    assert accs(reference_genomes=True) == {"GCA_1.1"}
    assert accs(complete_genomes=True, reference_genomes=True) == {"GCA_1.1"}


def test_classify_verbose_prints_throughput(tmp_path, capsys):
    """--verbose (non-quiet) prints the classified summary and the
    Mbp/m line the reference prints (GanonClassify.cpp:1091-1128)."""
    import io
    from contextlib import redirect_stderr

    dbs, reads = _mini_dbs(tmp_path, n_dbs=1)
    buf = io.StringIO()
    with redirect_stderr(buf):
        run_classify(ClassifyConfig(
            ibf=dbs, single_reads=[reads], output_prefix=str(tmp_path / "v"),
            rel_cutoff=[0.25], quiet=False, use_mesh=False,
        ))
    err = buf.getvalue()
    assert "sequences classified" in err
    assert "Mbp/m" in err
