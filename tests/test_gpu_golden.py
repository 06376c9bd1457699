"""Real-card golden: genotype the in-repo multigene panel end to end
with `--backend device` (the band DP compiled for the GPU) and compare
byte-wise against the committed goldens, which the native engine wrote.
Runs in-process on a GPU (T1K_REAL_DEVICE=1); skips elsewhere."""

import os

import pytest

from tests.conftest import DATA_DIR, GOLDEN_DIR

pytestmark = pytest.mark.gpu


def test_device_backend_golden(gpu, tmp_path):
    from t1k_tpu.cli.genotype import main

    prefix = str(tmp_path / "g")
    rc = main(["-f", os.path.join(DATA_DIR, "multigene_rna.fa"),
               "-1", os.path.join(DATA_DIR, "multigene_1.fq"),
               "-2", os.path.join(DATA_DIR, "multigene_2.fq"),
               "-o", prefix, "--backend", "device"])
    assert rc == 0
    for suffix in ("_genotype.tsv", "_allele.tsv"):
        with open(prefix + suffix) as f, open(
                os.path.join(GOLDEN_DIR, "multigene" + suffix)) as g:
            assert f.read() == g.read(), suffix
