"""chip_smoke.py's CPU-testable parts: seeded data, output comparison and
the refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _pairs(seed):
    rng = np.random.default_rng(seed)
    genomes = chip_smoke.random_genomes(rng, [5_000, 8_000, 3_000])
    return genomes, chip_smoke.sample_pairs(rng, genomes, 400)


def test_pairs_are_seeded():
    g1, (a1, b1) = _pairs(3)
    g2, (a2, b2) = _pairs(3)
    _, (a3, _) = _pairs(4)
    assert all(np.array_equal(x, y) for x, y in zip(g1, g2))
    assert np.array_equal(a1, a2) and np.array_equal(b1, b2)
    assert not np.array_equal(a1, a3)
    assert a1.shape == b1.shape == (400, chip_smoke.READ_LEN)
    assert a1.dtype == np.uint8 and a1.max() <= 3


def test_pairs_come_from_genomes_with_substitutions():
    rng = np.random.default_rng(0)
    genomes = chip_smoke.random_genomes(rng, [20_000])
    r1, r2 = chip_smoke.sample_pairs(rng, genomes, 2000, sub_rate=0.0)
    text = chip_smoke.BASES[genomes[0]].tobytes()
    found = sum(chip_smoke.BASES[r].tobytes() in text for r in r1)
    assert found == 1800  # 10% absent (random) reads
    rc = (3 - r2[:, ::-1]).astype(np.uint8)
    assert sum(chip_smoke.BASES[r].tobytes() in text for r in rc) == 1800
    m1, _ = chip_smoke.sample_pairs(np.random.default_rng(1), genomes, 2000,
                                    sub_rate=0.01, absent_frac=0.0)
    exact = sum(chip_smoke.BASES[r].tobytes() in text for r in m1)
    # P(no substitution in 150 bp at 1%) = 0.22
    assert 300 < exact < 600


def test_long_reads_and_fastq(tmp_path):
    rng = np.random.default_rng(5)
    genomes = chip_smoke.random_genomes(rng, [30_000])
    longs = chip_smoke.sample_long_reads(rng, genomes, 5, lo=1000, hi=2000)
    assert all(1000 <= len(r) <= 2000 for r in longs)
    path = tmp_path / "l.fq"
    chip_smoke.write_long_fastq(str(path), longs)
    lines = path.read_bytes().splitlines()
    assert len(lines) == 20 and lines[0] == b"@L00000000"
    assert lines[1] == chip_smoke.BASES[longs[0]].tobytes()
    codes = rng.integers(0, 4, (3, 7), dtype=np.uint8)
    rec = chip_smoke.fastq_bytes(codes, first_id=41).splitlines()
    assert rec[0] == b"@r00000041" and rec[4] == b"@r00000042"
    assert rec[1] == chip_smoke.BASES[codes[0]].tobytes()
    assert rec[2] == b"+" and rec[3] == b"I" * 7


def test_compare_output_dirs(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    (a / "out.all").write_text("r1\tT1\t5\nr2\tT2\t7\n")
    (b / "out.all").write_text("r2\tT2\t7\nr1\tT1\t5\n")  # order only
    assert chip_smoke.compare_output_dirs(str(a), str(b)) == []
    (b / "out.all").write_text("r2\tT2\t7\nr1\tT1\t6\n")
    (a / "out.unc").write_text("r9\n")
    diffs = chip_smoke.compare_output_dirs(str(a), str(b))
    assert len(diffs) == 2
    assert any("out.unc" in d and "only in" in d for d in diffs)
    assert any(d.startswith("out.all") for d in diffs)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu(tmp_path, alone):
    """Under JAX_PLATFORMS=cpu, and copied alone into an empty folder,
    the smoke exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    out = subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not 'gpu'" in out.stderr
