"""End-to-end genotyping parity tests.

Each case simulates reads deterministically, runs the full pipeline, and
compares outputs byte-for-byte against goldens produced by the reference
implementation (see make_goldens.py):
  * genotype.tsv and allele.tsv compared literally,
  * per-read assignment table and aligned-read fasta compared by digest.
"""

import hashlib
import os

import pytest

from tests.conftest import DATA_DIR, GOLDEN_DIR
from tests.make_goldens import CASES
from t1k_tpu.core.pipeline import GenotypeOptions, run_genotyper


def _opts_from_args(args):
    opts = GenotypeOptions(output_read_assignment=True)
    it = iter(range(len(args)))
    i = 0
    while i < len(args):
        if args[i] == "-s":
            opts.ref_seq_similarity = float(args[i + 1])
            i += 2
        elif args[i] == "--relaxIntronAlign":
            opts.relax_intron_align = True
            i += 1
        else:
            raise ValueError(args[i])
    return opts


@pytest.mark.parametrize("name", list(CASES.keys()))
def test_pipeline_matches_reference(name, tmp_path):
    case = CASES[name]
    ref = (os.path.join(DATA_DIR, "multigene_rna.fa")
           if case["ref"] == "MULTIGENE" else case["ref"])
    if not os.path.exists(ref):
        pytest.skip(f"reference database not available: {ref}")
    p1 = os.path.join(DATA_DIR, f"{name}_1.fq")
    p2 = os.path.join(DATA_DIR, f"{name}_2.fq")
    assert os.path.exists(p1), "run tests/make_goldens.py first"

    prefix = str(tmp_path / name)
    opts = _opts_from_args(case["args"])
    run_genotyper(ref, [p1], [p2] if case["paired"] else None, prefix, opts)

    for suffix in ("_genotype.tsv", "_allele.tsv"):
        with open(prefix + suffix) as f:
            got = f.read()
        with open(os.path.join(GOLDEN_DIR, name + suffix)) as f:
            want = f.read()
        assert got == want, f"{name}{suffix} differs"

    digests = {}
    with open(os.path.join(GOLDEN_DIR, name + "_digests.txt")) as f:
        for line in f:
            k, v = line.split()
            digests[k] = v

    with open(prefix + "_assign.tsv") as f:
        lines = sorted(f.readlines())
    got = hashlib.sha256("".join(lines).encode()).hexdigest()
    assert got == digests["_assign.tsv"], f"{name} assign.tsv differs"

    aligned = prefix + ("_aligned_1.fa" if case["paired"] else "_aligned.fa")
    with open(aligned, "rb") as f:
        got = hashlib.sha256(f.read()).hexdigest()
    assert got == digests["_aligned.fa"], f"{name} aligned fasta differs"


@pytest.mark.parametrize("workers", [2, 3])
def test_distributed_matches_single_host(workers, tmp_path):
    """Host-sharded execution (parallel/distributed.py) must be
    byte-identical to the single-host pipeline: contiguous fragment
    shards restore global coalesce order, coverage tensors sum."""
    from t1k_tpu.parallel.distributed import run_genotyper_distributed

    ref = CASES["rna"]["ref"]
    if not os.path.exists(ref):
        pytest.skip("reference database not available")
    p1 = os.path.join(DATA_DIR, "rna_1.fq")
    p2 = os.path.join(DATA_DIR, "rna_2.fq")

    prefix = str(tmp_path / f"dist{workers}")
    run_genotyper_distributed(ref, [p1], [p2], prefix,
                              GenotypeOptions(), n_workers=workers)
    for suffix in ("_genotype.tsv", "_allele.tsv"):
        with open(prefix + suffix) as f:
            got = f.read()
        with open(os.path.join(GOLDEN_DIR, "rna" + suffix)) as f:
            want = f.read()
        assert got == want, f"distributed {suffix} differs"


def test_device_candidates_byte_identical(tmp_path):
    """Phase-A-lite: device-generated candidate pruning
    (GenotypeOptions.device_candidates) must leave every output
    byte-identical — the device keep set equals the engine's
    overlap-emitting bucket set by construction (parity-tested in
    test_phase_a.py), so the pruned engine sees the same overlaps."""
    case = CASES["rna"]
    if not os.path.exists(case["ref"]):
        pytest.skip("reference database not available")
    p1 = os.path.join(DATA_DIR, "rna_1.fq")
    p2 = os.path.join(DATA_DIR, "rna_2.fq")
    prefix = str(tmp_path / "devcand")
    run_genotyper(case["ref"], [p1], [p2], prefix,
                  GenotypeOptions(device_candidates=True,
                                  output_read_assignment=True))
    for suffix in ("_genotype.tsv", "_allele.tsv"):
        with open(prefix + suffix) as f:
            got = f.read()
        with open(os.path.join(GOLDEN_DIR, "rna" + suffix)) as f:
            want = f.read()
        assert got == want, f"device-candidates {suffix} differs"
    # the full per-read assignment dump must also match an unpruned run
    plain = str(tmp_path / "plain")
    run_genotyper(case["ref"], [p1], [p2], plain,
                  GenotypeOptions(output_read_assignment=True))
    assert (open(prefix + "_assign.tsv").read()
            == open(plain + "_assign.tsv").read())


def test_distributed_cli_two_processes(tmp_path):
    """An N-process run of the full driver CLI (T1K_NUM_PROCESSES /
    T1K_PROCESS_ID env, real processes, file-based shard exchange) is
    byte-identical to the single-process chain — the CLI surface of
    parallel/distributed.py (SURVEY.md section 2.4 row 1)."""
    import subprocess
    import sys

    ref = CASES["rna"]["ref"]
    if not os.path.exists(ref):
        pytest.skip("reference database not available")
    p1 = os.path.join(DATA_DIR, "rna_1.fq")
    p2 = os.path.join(DATA_DIR, "rna_2.fq")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(nproc, outdir):
        os.makedirs(outdir, exist_ok=True)
        procs = []
        for pid in range(nproc):
            env = dict(os.environ)
            env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": repo})
            if nproc > 1:
                env.update({"T1K_NUM_PROCESSES": str(nproc),
                            "T1K_PROCESS_ID": str(pid)})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "t1k_tpu.cli.run", "-f", ref,
                 "-1", p1, "-2", p2, "--od", outdir, "-o", "chain",
                 "-t", "1"],
                env=env, cwd=repo,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err.decode()[-4000:]

    run(2, str(tmp_path / "dist"))
    run(1, str(tmp_path / "single"))
    for suffix in ("_genotype.tsv", "_allele.tsv", "_allele.vcf",
                   "_aligned_1.fa", "_aligned_2.fa"):
        with open(tmp_path / "dist" / f"chain{suffix}") as f:
            got = f.read()
        with open(tmp_path / "single" / f"chain{suffix}") as f:
            want = f.read()
        assert got == want, f"distributed CLI {suffix} differs"


def test_thread_count_invariance(tmp_path):
    """Race check: the multi-threaded engine must be byte-deterministic
    and identical to single-threaded output (reference contiguous-shard
    convention; coverage scatter is atomic and order-free)."""
    case = CASES["dna"]
    if not os.path.exists(case["ref"]):
        pytest.skip("reference database not available")
    p1 = os.path.join(DATA_DIR, "dna_1.fq")
    p2 = os.path.join(DATA_DIR, "dna_2.fq")
    outs = []
    for threads in (1, 8):
        prefix = str(tmp_path / f"t{threads}")
        opts = _opts_from_args(case["args"])
        opts.threads = threads
        run_genotyper(case["ref"], [p1], [p2], prefix, opts)
        with open(prefix + "_genotype.tsv") as f:
            g = f.read()
        with open(prefix + "_assign.tsv") as f:
            a = "".join(sorted(f.readlines()))
        outs.append((g, a))
    assert outs[0] == outs[1]


def test_truncated_mate_boundary_sentinel(tmp_path):
    """Fragments whose mate-pair window reaches exactly position 0 of a
    better-matching allele must be dropped: the reference's separator
    list carries -1/len boundary sentinels that trip the truncated-mate
    filter (SeqSet.hpp:924-928, 502-520). Found by fuzzing."""
    ref = os.path.join(DATA_DIR, "truncmate_panel.fa")
    prefix = str(tmp_path / "tm")
    run_genotyper(ref, [os.path.join(DATA_DIR, "truncmate_1.fq")],
                  [os.path.join(DATA_DIR, "truncmate_2.fq")], prefix,
                  GenotypeOptions(output_read_assignment=True))
    with open(prefix + "_assign.tsv") as f:
        assert f.read() == ""  # both fragments filtered
    with open(prefix + "_genotype.tsv") as f:
        got = f.read()
    with open(os.path.join(GOLDEN_DIR, "truncmate_genotype.tsv")) as f:
        assert got == f.read()


def test_device_backend_chain_matches_golden(tmp_path):
    """Full extract -> genotype -> analyze chain with the device
    alignment backend (deferred-DP batched to the band DP) must be
    byte-identical to the native chain's reference goldens."""
    cyp = os.environ.get(
        "T1K_CYP2D6_IDX", "/root/reference/vcf_database/cyp2d6_idx"
    ) + "/cyp2d6_rna_seq.fa"
    if not os.path.exists(cyp):
        pytest.skip("cyp2d6 database unavailable")
    golden = os.path.join(GOLDEN_DIR, "runt1k_genotype.tsv")
    if not os.path.exists(golden):
        pytest.skip("run tests/make_goldens.py first")
    from t1k_tpu.cli.run import main

    outdir = str(tmp_path / "devicerun")
    rc = main(["-f", cyp,
               "-1", os.path.join(DATA_DIR, "rna_1.fq"),
               "-2", os.path.join(DATA_DIR, "rna_2.fq"),
               "--od", outdir, "-o", "chain", "--backend", "device"])
    assert rc == 0
    for suffix in ("_genotype.tsv", "_allele.tsv", "_allele.vcf"):
        with open(os.path.join(outdir, "chain" + suffix)) as f:
            got = f.read()
        with open(os.path.join(GOLDEN_DIR, "runt1k" + suffix)) as f:
            assert got == f.read(), f"device-backend chain{suffix} differs"


def test_error_read_assigns_to_true_allele():
    """Property (SURVEY.md §4): a read simulated from allele X with a
    few substitutions must be assigned to X with similarity >= the
    default refSeqSimilarity (0.8), and X must rank among the read's
    top-matchCnt assignments."""
    import numpy as np

    from t1k_tpu.constants import encode_seq
    from t1k_tpu.io.refset import RefSet
    from t1k_tpu.native import NativeEngine

    cyp = os.environ.get(
        "T1K_CYP2D6_IDX", "/root/reference/vcf_database/cyp2d6_idx"
    ) + "/cyp2d6_rna_seq.fa"
    if not os.path.exists(cyp):
        pytest.skip("cyp2d6 database unavailable")
    rs = RefSet.from_fasta(cyp)
    packed = rs.packed()
    engine = NativeEngine(packed, 11)
    name_to_idx = {a.name: i for i, a in enumerate(rs.alleles)}

    rng = np.random.default_rng(4242)
    reads, truths = [], []
    for trial in range(40):
        ai = int(rng.integers(0, len(rs.alleles)))
        allele = rs.alleles[ai]
        seq = allele.seq.replace("N", "")
        if len(seq) < 150:
            continue
        start = int(rng.integers(0, len(seq) - 100))
        read = list(seq[start:start + 100])
        n_err = int(rng.integers(0, 4))
        for _ in range(n_err):
            p = int(rng.integers(0, 100))
            if read[p] in "ACGT":
                read[p] = "ACGT"[("ACGT".index(read[p]) + 1) % 4]
        reads.append("".join(read))
        truths.append(ai)

    codes = [encode_seq(s) for s in reads]
    lens = np.array([len(c) for c in codes], np.int32)
    starts = np.zeros(len(codes), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    flat = np.concatenate(codes).astype(np.int8)
    rec, off = engine.assign_batch(flat, starts, lens,
                                   np.ones(len(codes), np.int32))
    assigned_true = 0
    for i, ai in enumerate(truths):
        rows = rec[off[i]:off[i + 1]]
        if not len(rows):
            continue
        # rows: [seq_idx, ..., matchCnt at col 5?, similarity col?]
        alleles_hit = {int(r[0]) for r in rows}
        # the truth allele may be deduped into an identical sequence --
        # accept any allele whose packed sequence equals the truth's
        if ai in alleles_hit:
            assigned_true += 1
        else:
            truth_seq = rs.alleles[ai].seq
            if any(rs.alleles[int(r[0])].seq == truth_seq for r in rows):
                assigned_true += 1
    assert assigned_true >= int(0.9 * len(truths)), (
        f"only {assigned_true}/{len(truths)} error-reads assigned to "
        "their source allele")


def test_em_state_snapshot_resume(tmp_path):
    """Preemption tolerance (SURVEY.md §5): a run's EM sufficient
    statistics snapshot can be resumed (skipping quantification) and
    reproduces the genotype output byte-for-byte; a snapshot from a
    different problem is rejected."""
    import numpy as np

    p1 = os.path.join(DATA_DIR, "rna_1.fq")
    p2 = os.path.join(DATA_DIR, "rna_2.fq")
    ref = CASES["rna"]["ref"]
    if not os.path.exists(ref):
        pytest.skip(f"reference database not available: {ref}")

    first = str(tmp_path / "first")
    run_genotyper(ref, [p1], [p2], first, GenotypeOptions())
    snap = first + "_em_state.npz"
    assert os.path.exists(snap)

    resumed = str(tmp_path / "resumed")
    res = run_genotyper(ref, [p1], [p2], resumed,
                        GenotypeOptions(em_state_file=snap))
    assert res.em_iterations == 0
    with open(first + "_genotype.tsv") as f, \
            open(resumed + "_genotype.tsv") as g:
        assert f.read() == g.read()

    # corrupt the EC structure -> must refuse to resume
    data = dict(np.load(snap))
    data["ec_sizes"] = data["ec_sizes"] + 1
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, **data)
    with pytest.raises(ValueError, match="different equivalence"):
        run_genotyper(ref, [p1], [p2], str(tmp_path / "x"),
                      GenotypeOptions(em_state_file=bad))


@pytest.mark.parametrize("threads", [1, 8])
def test_engine_coalesce_matches_host(threads):
    """fragment_batch_coalesced (engine-side read-group coalescing,
    engine.cc t1k_coalesce_batch) must reproduce exactly the flat group
    CSR that the host path (fragment_batch -> Genotyper.coalesce_arrays)
    builds: same group order, spans, float32 weight accumulation, and
    per-fragment counts/flags — at 1 and 8 engine threads."""
    import numpy as np

    from t1k_tpu.constants import GENOTYPER_KMER_LENGTH
    from t1k_tpu.core.genotyper import Genotyper
    from t1k_tpu.core.pipeline import assign_unique_reads
    from t1k_tpu.io.reads import read_seq_files
    from t1k_tpu.io.refset import RefSet
    from t1k_tpu.native import NativeEngine

    ref = CASES["rna"]["ref"]
    if not os.path.exists(ref):
        pytest.skip("reference database not available")
    seqs1 = [r.seq for r in read_seq_files([os.path.join(DATA_DIR, "rna_1.fq")])]
    seqs2 = [r.seq for r in read_seq_files([os.path.join(DATA_DIR, "rna_2.fq")])]

    refset = RefSet.from_fasta(ref, -1, "")
    engine = NativeEngine(refset.packed(), GENOTYPER_KMER_LENGTH,
                          threads=threads)
    _, group_of, _, _ = assign_unique_reads(engine, seqs1 + seqs2,
                                            store_results=False)
    n = len(seqs1)
    has_n = np.array([("N" in a) or ("N" in b)
                      for a, b in zip(seqs1, seqs2)], dtype=np.uint8)
    uid1, uid2 = group_of[:n], group_of[n:]

    rec, counts_h, flags_h = engine.fragment_batch(uid1, uid2, has_n, True)
    host = Genotyper(refset)
    cnt_h = host.coalesce_arrays(rec, counts_h)

    coalesced, cnt_e, counts_e, flags_e = engine.fragment_batch_coalesced(
        uid1, uid2, has_n, True)
    eng = Genotyper(refset)
    eng.adopt_coalesced(coalesced, cnt_e)

    assert cnt_h == cnt_e and cnt_h > 0
    np.testing.assert_array_equal(counts_h, counts_e)
    np.testing.assert_array_equal(flags_h, flags_e)
    np.testing.assert_array_equal(host._grp_off, eng._grp_off)
    for attr in ("_flat_allele", "_flat_start", "_flat_end",
                 "_flat_weight", "_flat_qual", "_flat_adjust"):
        a, b = getattr(host, attr), getattr(eng, attr)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=attr)
