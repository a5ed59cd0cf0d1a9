"""End-to-end integration: programmatic Config API through all subcommands.

Mirrors the reference's integration strategy (tests/ganon/integration/):
run the real pipeline on miniature data via ``main(cfg=Config(which,
**kwargs))`` with sanity-check oracles.
"""

import os
import random

import pytest

from ganon_tpu.cli import main
from ganon_tpu.config import Config


def _rand_genome(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


@pytest.fixture(scope="module")
def mini_data(tmp_path_factory):
    """3 genomes, NCBI-style taxdump files, simulated reads."""
    tmp = tmp_path_factory.mktemp("mini")
    rng = random.Random(7)
    genomes = {
        "GCF_000000001.1": ("11", _rand_genome(rng, 3000)),
        "GCF_000000002.1": ("12", _rand_genome(rng, 3000)),
        "GCF_000000003.1": ("21", _rand_genome(rng, 3000)),
    }
    files = []
    for acc, (taxid, seq) in genomes.items():
        p = tmp / f"{acc}_genomic.fna"
        with open(p, "w") as f:
            f.write(f">{acc}_seq1 test\n{seq}\n")
        files.append(str(p))

    # NCBI-style taxdump (nodes/names)
    nodes = [
        ("1", "1", "no rank"), ("10", "1", "genus"), ("20", "1", "genus"),
        ("11", "10", "species"), ("12", "10", "species"),
        ("21", "20", "species"),
    ]
    names = {
        "1": "root", "10": "GenusA", "20": "GenusB", "11": "SpeciesA1",
        "12": "SpeciesA2", "21": "SpeciesB1",
    }
    with open(tmp / "nodes.dmp", "w") as f:
        for n, p, r in nodes:
            f.write(f"{n}\t|\t{p}\t|\t{r}\t|\n")
    with open(tmp / "names.dmp", "w") as f:
        for n, name in names.items():
            f.write(f"{n}\t|\t{name}\t|\t\t|\tscientific name\t|\n")

    # assembly_summary for file-accession -> taxid resolution
    with open(tmp / "assembly_summary.txt", "w") as f:
        f.write("#header\n#assembly_accession\tbioproject\tbiosample\twgs\t"
                "refseq_category\ttaxid\tspecies_taxid\torganism_name\t"
                "infraspecific_name\n")
        for acc, (taxid, _) in genomes.items():
            f.write(
                f"{acc}\tPRJ\tSAM\t\trepresentative genome\t{taxid}\t{taxid}"
                f"\tOrganism {taxid}\tstrain=X\n"
            )

    # simulated reads: 60 from each genome + junk
    reads = []
    for acc, (taxid, seq) in genomes.items():
        for i in range(20):
            s = rng.randint(0, len(seq) - 100)
            reads.append((f"{acc}_read{i}", seq[s : s + 100]))
    for i in range(5):
        reads.append((f"junk{i}", _rand_genome(rng, 100)))
    with open(tmp / "reads.fq", "w") as f:
        for rid, seq in reads:
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")

    return {
        "tmp": tmp,
        "files": files,
        "genomes": genomes,
        "reads_fq": str(tmp / "reads.fq"),
        "tax_files": [str(tmp / "nodes.dmp"), str(tmp / "names.dmp")],
        "assembly_summary": str(tmp / "assembly_summary.txt"),
        "n_reads": len(reads),
    }


def _build(mini_data, db_prefix, **kw):
    params = dict(
        db_prefix=db_prefix,
        input=mini_data["files"],
        input_extension="fna",
        taxonomy="ncbi",
        taxonomy_files=mini_data["tax_files"],
        ncbi_file_info=[mini_data["assembly_summary"]],
        kmer_size=11,
        window_size=15,
        quiet=True,
    )
    params.update(kw)
    return main(cfg=Config("build-custom", **params))


def test_build_custom_and_classify_lca(mini_data, tmp_path):
    db = str(tmp_path / "db")
    assert _build(mini_data, db)
    assert os.path.isfile(db + ".ibf")
    assert os.path.isfile(db + ".tax")

    # .tax holds targets with taxid parents + genome sizes
    with open(db + ".tax") as f:
        tax = {r.split("\t")[0]: r.rstrip("\n").split("\t") for r in f}
    assert "GCF_000000001.1" in tax
    assert tax["GCF_000000001.1"][1] == "11"
    assert len(tax["1"]) == 5  # genome_size column

    out = str(tmp_path / "res")
    assert main(
        cfg=Config(
            "classify",
            db_prefix=[db],
            single_reads=[mini_data["reads_fq"]],
            output_prefix=out,
            multiple_matches="lca",
            output_one=True,
            output_all=True,
            output_unclassified=True,
            rel_cutoff=[0.25],
            quiet=True,
        )
    )
    assert os.path.isfile(out + ".rep")
    assert os.path.isfile(out + ".one")
    assert os.path.isfile(out + ".tre")  # chained report
    with open(out + ".one") as f:
        one = {r.split("\t")[0]: r.split("\t")[1] for r in f}
    # reads from genome 1 should hit its target
    hits = [
        t for r, t in one.items() if r.startswith("GCF_000000001.1_read")
    ]
    assert hits and all("GCF_000000001.1" in t or t in ("10", "1") for t in hits)


def test_classify_em_chain(mini_data, tmp_path):
    db = str(tmp_path / "db")
    assert _build(mini_data, db)
    out = str(tmp_path / "em")
    assert main(
        cfg=Config(
            "classify",
            db_prefix=[db],
            single_reads=[mini_data["reads_fq"]],
            output_prefix=out,
            multiple_matches="em",
            output_one=True,
            rel_cutoff=[0.25],
            quiet=True,
        )
    )
    assert os.path.isfile(out + ".one")  # written by reassign
    assert os.path.isfile(out + ".rep")
    assert os.path.isfile(out + ".tre")
    with open(out + ".rep") as f:
        rows = [r.rstrip("\n").split("\t") for r in f if not r.startswith("#")]
    # after EM there are no LCA-only rows (lca col = reassigned - unique)
    assert all(len(r) >= 5 for r in rows)


def test_build_custom_level_species(mini_data, tmp_path):
    db = str(tmp_path / "dbs")
    assert _build(mini_data, db, level="species")
    # user bins are taxid nodes at species level
    from ganon_tpu.index.ibf import IBF

    ibf = IBF.load(db + ".ibf")
    assert set(ibf.targets()) == {"11", "12", "21"}


def test_build_custom_hibf(mini_data, tmp_path):
    db = str(tmp_path / "dbh")
    assert _build(mini_data, db, filter_type="hibf")
    assert os.path.isfile(db + ".hibf")
    out = str(tmp_path / "resh")
    assert main(
        cfg=Config(
            "classify",
            db_prefix=[db],
            single_reads=[mini_data["reads_fq"]],
            output_prefix=out,
            multiple_matches="lca",
            output_one=True,
            rel_cutoff=[0.25],
            quiet=True,
        )
    )
    assert os.path.isfile(out + ".rep")


def test_update(mini_data, tmp_path):
    db = str(tmp_path / "dbu")
    assert _build(mini_data, db, keep_files=True)
    from ganon_tpu.index.ibf import IBF

    n_before = len(IBF.load(db + ".ibf").targets())

    # add one more genome
    import random

    rng = random.Random(99)
    newg = tmp_path / "GCF_000000009.1_genomic.fna"
    with open(newg, "w") as f:
        f.write(">GCF_000000009.1_seq1\n")
        f.write("".join(rng.choice("ACGT") for _ in range(2000)) + "\n")
    with open(mini_data["assembly_summary"], "a") as f:
        f.write(
            "GCF_000000009.1\tPRJ\tSAM\t\tna\t21\t21\tOrganism 21\tstrain=Z\n"
        )

    assert main(
        cfg=Config(
            "update",
            db_prefix=db,
            input=mini_data["files"] + [str(newg)],
            input_extension="fna",
            taxonomy="ncbi",
            taxonomy_files=mini_data["tax_files"],
            ncbi_file_info=[mini_data["assembly_summary"]],
            quiet=True,
        )
    )
    assert len(IBF.load(db + ".ibf").targets()) == n_before + 1


def test_input_target_sequence(mini_data, tmp_path):
    db = str(tmp_path / "dbseq")
    # sequence-level targets resolved via accession2taxid
    acc2txid = tmp_path / "acc2txid.tsv"
    with open(acc2txid, "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        for acc, (taxid, _) in mini_data["genomes"].items():
            f.write(f"{acc}_seq1\t{acc}_seq1\t{taxid}\t0\n")
    assert main(
        cfg=Config(
            "build-custom",
            db_prefix=db,
            input=mini_data["files"],
            input_extension="fna",
            input_target="sequence",
            taxonomy="ncbi",
            taxonomy_files=mini_data["tax_files"],
            ncbi_sequence_info=[str(acc2txid)],
            kmer_size=11,
            window_size=15,
            quiet=True,
        )
    )
    from ganon_tpu.index.ibf import IBF

    ibf = IBF.load(db + ".ibf")
    assert set(ibf.targets()) == {
        f"{acc}_seq1" for acc in mini_data["genomes"]
    }


def test_report_and_table_cli(mini_data, tmp_path):
    db = str(tmp_path / "db")
    assert _build(mini_data, db)
    out = str(tmp_path / "r1")
    main(
        cfg=Config(
            "classify", db_prefix=[db], single_reads=[mini_data["reads_fq"]],
            output_prefix=out, multiple_matches="lca", rel_cutoff=[0.25],
            skip_report=True, quiet=True,
        )
    )
    tre = str(tmp_path / "rep_out")
    assert main(
        cfg=Config(
            "report", input=[out + ".rep"], output_prefix=tre,
            db_prefix=[db], report_type="reads", ranks=["all"], quiet=True,
        )
    )
    assert os.path.isfile(tre + ".tre")
    tbl = str(tmp_path / "table.tsv")
    assert main(
        cfg=Config(
            "table", input=[tre + ".tre"], output_file=tbl, header="taxid",
            quiet=True,
        )
    )
    assert os.path.isfile(tbl)


def test_cli_flag_parity_with_reference():
    """Every reference CLI flag exists here (mechanically extracted
    from the reference's argparse calls); our extras are the known
    framework additions only."""
    import ast
    import os

    import pytest

    ref_cfg = "/root/reference/src/ganon/config.py"
    if not os.path.isfile(ref_cfg):
        pytest.skip("reference source not mounted")

    def flags_of(path):
        out = set()
        for node in ast.walk(ast.parse(open(path).read())):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"
            ):
                for a in node.args:
                    if (
                        isinstance(a, ast.Constant)
                        and isinstance(a.value, str)
                        and a.value.startswith("--")
                    ):
                        out.add(a.value)
        return out

    ref = flags_of(ref_cfg)
    ours = flags_of(
        os.path.join(os.path.dirname(__file__), "..", "ganon_tpu",
                     "config.py")
    )
    assert ref - ours == set(), f"reference flags missing: {ref - ours}"
    assert ours - ref == {
        # documented framework extensions
        "--distributed", "--filter-format", "--hibf-layout",
        "--longreads", "--no-length-bucketing", "--pipeline-depth",
        "--reassign-max-iter", "--reassign-threshold",
        "--tax-root-node", "--top-k-matches",
    }, f"undocumented extra flags: {ours - ref}"
