"""Device-op tests (virtual CPU mesh): band-DP parity with the native
walk, jitted EM vs the exact native EM, device k-mer prefilter safety,
and the multi-device sharded EM step."""

import os

import numpy as np
import pytest

from tests.conftest import DATA_DIR, GOLDEN_DIR
from t1k_tpu.constants import encode_seq

CYP_RNA = os.environ.get(
    "T1K_CYP2D6_IDX", "/root/reference/vcf_database/cyp2d6_idx"
) + "/cyp2d6_rna_seq.fa"


def _golden_batch():
    cases = []
    with open(os.path.join(GOLDEN_DIR, "align_global.tsv")) as f:
        for line in f:
            lent, lenp, t, p, score, _ = line.rstrip("\n").split("\t")
            t = "" if t == "-" else t
            p = "" if p == "-" else p
            cases.append((t, p, int(score)))
    Lt = max(len(t) for t, _, _ in cases) + 1
    Lp = max(len(p) for _, p, _ in cases) + 1
    B = len(cases)
    tc = np.zeros((B, Lt), np.int8)
    pc = np.zeros((B, Lp), np.int8)
    tl = np.zeros(B, np.int32)
    pl = np.zeros(B, np.int32)
    for i, (t, p, _) in enumerate(cases):
        tc[i, :len(t)] = encode_seq(t)
        pc[i, :len(p)] = encode_seq(p)
        tl[i] = len(t)
        pl[i] = len(p)
    want = np.array([s for _, _, s in cases], np.int32)
    return tc, tl, pc, pl, want


def test_jax_aligner_matches_reference_scores():
    from t1k_tpu.ops.align import banded_scores

    tc, tl, pc, pl, want = _golden_batch()
    got = np.asarray(banded_scores(tc, tl, pc, pl))
    assert (got == want).all()


def _random_pairs(rng, n, max_len, max_diff=10):
    """Pattern/text pairs with |Δlen| <= max_diff: half mutated copies
    (N bases included), half unrelated."""
    lp = rng.integers(1, max_len + 1, n)
    lt = np.clip(lp + rng.integers(-max_diff, max_diff + 1, n), 1, max_len)
    tc = rng.integers(0, 5, (n, max_len)).astype(np.int8)
    pc = tc.copy()
    mut = rng.random((n, max_len)) < 0.05
    pc[mut] = rng.integers(0, 5, int(mut.sum()))
    other = rng.random(n) < 0.5
    pc[other] = rng.integers(0, 5, (int(other.sum()), max_len))
    return tc, lt.astype(np.int32), pc, lp.astype(np.int32)


def _walk_stats(tc, tl, pc, pl):
    from t1k_tpu.native import align_global

    out = []
    for i in range(len(tl)):
        s, ops = align_global(tc[i, :tl[i]], pc[i, :pl[i]])
        out.append((s, int((ops == 0).sum()), int((ops == 1).sum()),
                    int(((ops == 2) | (ops == 3)).sum())))
    return np.array(out)


@pytest.mark.parametrize("bucket", [96, 256])
def test_band_dp_matches_walk_at_deferred_buckets(bucket):
    """The band DP at the deferred service's fixed (ML, W) class and each
    length bucket equals the native walk exactly: score and all three
    traceback counts."""
    from t1k_tpu.ops.align import _DESC_ML, _DESC_W, banded_stats

    rng = np.random.default_rng(bucket)
    tc, tl, pc, pl = _random_pairs(rng, 96, bucket - 2)
    got = np.stack(banded_stats(tc, tl, pc, pl, ml=_DESC_ML, w=_DESC_W),
                   axis=1)
    assert np.array_equal(got, _walk_stats(tc, tl, pc, pl))


def test_deferred_desc_service_buckets_slices_and_order():
    """Items of both length buckets, spread over several fixed-size
    slices, come back from the descriptor service in input order, equal
    to the native walk's match counts; forward and reverse-complement
    pattern windows both resolve."""
    from t1k_tpu.native import align_stats
    from t1k_tpu.ops.align import DeferredDescService

    rng = np.random.default_rng(7)
    ref = rng.integers(0, 5, 5000).astype(np.int8)
    read_lens = rng.integers(150, 250, 12).astype(np.int32)
    starts = np.zeros(12, np.int64)
    starts[1:] = np.cumsum(read_lens[:-1])
    reads = rng.integers(0, 4, int(read_lens.sum())).astype(np.int8)

    svc = DeferredDescService(slice_items=8)
    svc.set_ref(ref)
    svc.set_layout(starts, read_lens)
    rc_base = svc.begin_batch(reads)

    n = 40
    p_len = np.where(np.arange(n) % 3 == 0, rng.integers(100, 150, n),
                     rng.integers(1, 90, n)).astype(np.int32)
    t_len = np.clip(p_len + rng.integers(-10, 11, n), 1, None).astype(np.int32)
    rd = rng.integers(0, 12, n)
    p_off = starts[rd] + rng.integers(0, read_lens[rd] - p_len + 1)
    rc = rng.random(n) < 0.5
    p_off = np.where(rc, rc_base + p_off, p_off)
    t_off = rng.integers(0, len(ref) - 300, n)
    got = svc.stats(t_off, t_len, p_off, p_len)

    rc_reads = np.where(reads < 4, 3 - reads, reads)
    want = []
    for i in range(n):
        t = ref[t_off[i]:t_off[i] + t_len[i]]
        o = int(p_off[i])
        if rc[i]:
            # the rc half is each read reversed in place
            o -= rc_base
            r = int(rd[i])
            s, ln = int(starts[r]), int(read_lens[r])
            read_rc = rc_reads[s:s + ln][::-1]
            p = read_rc[o - s:o - s + p_len[i]]
        else:
            p = reads[o:o + p_len[i]]
        want.append(align_stats(t, p)[0])
    assert np.array_equal(got, np.array(want))
    assert svc.items_scored == n


def _em_inputs():
    rng = np.random.default_rng(3)
    n_alleles, n_genes, n_majors, ec_cnt, rg_cnt = 40, 3, 12, 15, 200
    ec_to_alleles = [[] for _ in range(ec_cnt)]
    for a in range(n_alleles):
        ec_to_alleles[a % ec_cnt].append(a)
    offs = [0]
    ecs = []
    for _ in range(rg_cnt):
        k = rng.integers(1, 6)
        ecs.extend(rng.choice(ec_cnt, size=k, replace=False).tolist())
        offs.append(len(ecs))
    args = dict(
        ec_to_alleles=ec_to_alleles,
        rg_ecs_csr=(np.array(offs, np.int64), np.array(ecs, np.int32)),
        rg_counts=rng.choice([1.0, 0.5, 2.0], rg_cnt),
        allele_eff_len=rng.integers(900, 1400, n_alleles).astype(np.int32),
        allele_missing=np.zeros(n_alleles, np.int32),
        allele_weight=rng.integers(1, 4, n_alleles).astype(np.int32),
        allele_gene=(np.arange(n_alleles) % n_genes).astype(np.int32),
        allele_major=(np.arange(n_alleles) % n_majors).astype(np.int32),
        n_genes=n_genes,
        n_majors=n_majors,
    )
    return args


def test_jax_em_matches_native():
    from t1k_tpu.native import em_quantify
    from t1k_tpu.ops.em import em_quantify_jax

    args = _em_inputs()
    it_native, count_native = em_quantify(**args)
    it_jax, count_jax = em_quantify_jax(**args)
    assert it_native == it_jax
    np.testing.assert_allclose(count_jax, count_native, rtol=2e-3, atol=1e-3)


def test_device_kmer_prefilter_no_false_negatives():
    if not os.path.exists(CYP_RNA):
        pytest.skip("cyp2d6 database unavailable")
    from t1k_tpu.io.refset import RefSet
    from t1k_tpu.io.reads import read_seq_file
    from t1k_tpu.native import NativeEngine
    from t1k_tpu.ops.kmer import DeviceKmerTable, prefilter_flags

    refset = RefSet(digit_units=-1)
    for rec in read_seq_file(CYP_RNA):
        refset.add_allele(rec.id, rec.seq, rec.comment)
    packed = refset.packed()
    k = 11
    hit_len = 27
    engine = NativeEngine(packed, k, hit_len_required=hit_len)
    table = DeviceKmerTable.build(packed, k)

    p1 = os.path.join(DATA_DIR, "extract_1.fq")
    if not os.path.exists(p1):
        pytest.skip("run tests/make_goldens.py first")
    recs = list(read_seq_file(p1))
    L = max(len(r.seq) for r in recs)
    codes = np.zeros((len(recs), L), np.int8)
    lens = np.zeros(len(recs), np.int32)
    for i, r in enumerate(recs):
        codes[i, :len(r.seq)] = encode_seq(r.seq)
        lens[i] = len(r.seq)

    flags_device = prefilter_flags(table, codes, lens, hit_len)

    flat = np.concatenate([encode_seq(r.seq) for r in recs])
    starts = np.zeros(len(recs), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    flags_exact = engine.screen_batch(flat, starts, lens)

    # prefilter must never reject a read the exact screen accepts
    assert not np.any((flags_exact == 1) & (~flags_device))
    # and it should reject a decent share of background
    reject_rate = 1 - flags_device.mean()
    assert reject_rate > 0.3


def test_sharded_em_multichip():
    import jax

    from t1k_tpu.parallel.mesh import data_mesh, em_quantify_sharded

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    rng = np.random.default_rng(5)
    ec_cnt, rg_cnt, nnz = 12, 300, 900
    seg_rg = np.sort(rng.integers(0, rg_cnt, nnz)).astype(np.int32)
    seg_ec = rng.integers(0, ec_cnt, nnz).astype(np.int32)
    counts = np.ones(nnz, np.float64)
    ec_len = rng.integers(800, 1200, ec_cnt).astype(np.float64)
    init = np.ones(ec_cnt, np.float64)

    mesh = data_mesh(8)
    x_sharded = em_quantify_sharded(
        mesh, seg_rg, seg_ec, counts, rg_cnt, ec_len, init, iterations=20)

    # single-device truth
    mesh1 = data_mesh(1)
    x_single = em_quantify_sharded(
        mesh1, seg_rg, seg_ec, counts, rg_cnt, ec_len, init, iterations=20)
    np.testing.assert_allclose(x_sharded, x_single, rtol=1e-4, atol=1e-6)


def test_sharded_squarem_matches_native():
    """The PRODUCTION sharded quantification (full SQUAREM + convergence
    + 10-round masking + psum, parallel/mesh.py — what dryrun_multichip
    compiles) follows the native f64 oracle's trajectory: same iteration
    count, counts to float tolerance, on an 8-device CPU mesh."""
    import jax

    from t1k_tpu.native import em_quantify
    from t1k_tpu.parallel.mesh import data_mesh, em_quantify_sharded_squarem

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    args = _em_inputs()
    it_native, count_native = em_quantify(**args)

    rg_off, rg_ecs = args["rg_ecs_csr"]
    rg_cnt = len(args["rg_counts"])
    seg_rg = np.repeat(np.arange(rg_cnt), np.diff(rg_off)).astype(np.int32)
    it_sharded, count_sharded = em_quantify_sharded_squarem(
        data_mesh(8), seg_rg, np.asarray(rg_ecs, np.int32),
        np.asarray(args["rg_counts"], np.float64), rg_cnt,
        args["ec_to_alleles"], args["allele_eff_len"],
        args["allele_weight"], args["allele_gene"], args["allele_major"],
        args["n_genes"], args["n_majors"])
    assert it_sharded == it_native
    np.testing.assert_allclose(count_sharded, count_native,
                               rtol=2e-3, atol=1e-3)


def test_sharded_squarem_single_dispatch_matches_host_loop():
    """The single-dispatch production path (whole convergence loop as ONE
    shard_mapped while_loop with the psum inside — what real device meshes
    run) follows the same trajectory as the per-round host loop used by
    the virtual-CPU dryrun.  A 1-device mesh sidesteps the CPU-backend
    psum-in-while deadlock while still exercising the shard_map +
    while_loop + psum program."""
    from t1k_tpu.native import em_quantify
    from t1k_tpu.parallel.mesh import data_mesh, em_quantify_sharded_squarem

    args = _em_inputs()
    it_native, count_native = em_quantify(**args)

    rg_off, rg_ecs = args["rg_ecs_csr"]
    rg_cnt = len(args["rg_counts"])
    seg_rg = np.repeat(np.arange(rg_cnt), np.diff(rg_off)).astype(np.int32)
    common = (data_mesh(1), seg_rg, np.asarray(rg_ecs, np.int32),
              np.asarray(args["rg_counts"], np.float64), rg_cnt,
              args["ec_to_alleles"], args["allele_eff_len"],
              args["allele_weight"], args["allele_gene"], args["allele_major"],
              args["n_genes"], args["n_majors"])
    it_one, count_one = em_quantify_sharded_squarem(
        *common, single_dispatch=True)
    it_host, count_host = em_quantify_sharded_squarem(
        *common, single_dispatch=False)
    assert it_one == it_host == it_native
    # while_loop vs per-dispatch compile to different fusions, which can
    # reassociate the f32 matvec accumulation by 1-2 ulps — identical
    # trip counts and float-level counts are the contract
    np.testing.assert_allclose(count_one, count_host, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(count_one, count_native,
                               rtol=2e-3, atol=1e-3)


def test_band_pallas_interpret_matches():
    """The 400 golden cases at the deferred service's fixed window."""
    from t1k_tpu.ops.align import _DESC_ML, _DESC_W, banded_stats

    tc, tl, pc, pl, want = _golden_batch()
    got = banded_stats(tc, tl, pc, pl, ml=_DESC_ML, w=_DESC_W)[0]
    assert (np.asarray(got) == want).all()


def test_band_pallas_stats_matches_walk():
    """Forward count propagation == native traceback counts, including
    boundary-quirk shapes (short pattern, long text)."""
    from t1k_tpu.native import align_global
    from t1k_tpu.ops.align import banded_stats

    rng = np.random.default_rng(19)
    t_list, p_list = [], []
    for it in range(256):
        lenp = int(rng.integers(1, 90))
        if it % 3 == 0:
            lent = max(1, lenp + int(rng.integers(-5, 6)))
            t = rng.integers(0, 5, lent)
        elif it % 3 == 1:
            lent = int(rng.integers(1, 25))
            lenp = max(1, lent + int(rng.integers(-8, 9)))
            t = rng.integers(0, 5, lent)
        else:  # mutated copy
            lent = max(1, lenp + int(rng.integers(-3, 4)))
            p0 = rng.integers(0, 4, max(lent, lenp))
            t = p0[:lent].copy()
            for _ in range(int(rng.integers(0, 6))):
                t[int(rng.integers(0, lent))] = int(rng.integers(0, 5))
            p_list.append(p0[:lenp])
            t_list.append(t)
            continue
        p_list.append(rng.integers(0, 5, lenp))
        t_list.append(t)

    B = len(t_list)
    Lt = max(len(t) for t in t_list)
    Lp = max(len(p) for p in p_list)
    tc = np.zeros((B, Lt), np.int8)
    pc = np.zeros((B, Lp), np.int8)
    tl = np.array([len(t) for t in t_list], np.int32)
    pl = np.array([len(p) for p in p_list], np.int32)
    for i, (t, p) in enumerate(zip(t_list, p_list)):
        tc[i, :len(t)] = t
        pc[i, :len(p)] = p
    ML = 5 + max(0, int((pl - tl).max()))
    tl = np.minimum(tl, pl + (32 - 1 - 5 - ML))  # keep band in window

    scores, ma, mi, ind = banded_stats(tc, tl, pc, pl)
    for i in range(B):
        s_ref, ops = align_global(tc[i, :tl[i]], pc[i, :pl[i]])
        want = (int((ops == 0).sum()), int((ops == 1).sum()),
                int(((ops == 2) | (ops == 3)).sum()))
        assert int(scores[i]) == s_ref, i
        assert (int(ma[i]), int(mi[i]), int(ind[i])) == want, i


def test_band_window_adapts_to_length_difference():
    """The window width tracks the batch's band extent: every band cell
    (w up to ML + 5 + (t_len - p_len), SeqSet band widening at
    AlignAlgo.hpp:240) must be representable.  Narrow batches (equal
    lengths -> W=11) and wide ones (diff 25 -> W=36) both match the
    native oracle exactly."""
    from t1k_tpu.native import align_global
    from t1k_tpu.ops.align import band_window, banded_scores

    assert band_window(5, 0) == 11
    assert band_window(5, 12) == 23
    assert band_window(15, 10) == 31
    assert band_window(5, 25) == 36

    rng = np.random.default_rng(23)
    for diff in (0, 25):
        B = 32
        lenp = 60
        lent = lenp + diff
        tc = rng.integers(0, 4, (B, lent)).astype(np.int8)
        pc = tc[:, :lenp].copy()
        mut = rng.random((B, lenp)) < 0.05
        pc[mut] = rng.integers(0, 4, int(mut.sum())).astype(np.int8)
        tl = np.full(B, lent, np.int32)
        pl = np.full(B, lenp, np.int32)
        got = banded_scores(tc, tl, pc, pl)
        want = np.array([align_global(tc[i], pc[i])[0] for i in range(B)])
        assert (np.asarray(got) == want).all(), f"diff={diff}"


def test_jax_em_segment_path_matches_dense():
    """Both device EM formulations (dense matvec fast path vs the
    scatter-free segment path for cohort-scale problems) agree with the
    native oracle."""
    from t1k_tpu.native import em_quantify
    from t1k_tpu.ops import em as em_mod

    args = _em_inputs()
    it_native, count_native = em_quantify(**args)
    old = em_mod.DENSE_EM_MAX_ELEMS
    em_mod.DENSE_EM_MAX_ELEMS = 0  # force the segment path
    try:
        it_seg, count_seg = em_mod.em_quantify_jax(**args)
    finally:
        em_mod.DENSE_EM_MAX_ELEMS = old
    assert it_seg == it_native
    np.testing.assert_allclose(count_seg, count_native, rtol=2e-3, atol=1e-3)


def _cohort_problems(n_cells=9, n_alleles=40, n_genes=4, seed0=50):
    """Randomized per-cell EC problems against one shared reference."""
    allele_gene = (np.arange(n_alleles) % n_genes).astype(np.int32)
    allele_major = (np.arange(n_alleles) // 2).astype(np.int32)
    n_majors = n_alleles // 2
    rng = np.random.default_rng(seed0)
    allele_eff_len = rng.integers(800, 1600, n_alleles).astype(np.float64)

    problems = []
    for s in range(n_cells):
        r = np.random.default_rng(seed0 + 1 + s)
        K = int(r.integers(3, 12))
        pool = list(range(n_alleles))
        r.shuffle(pool)
        ecs, used = [], 0
        for _ in range(K):
            sz = int(r.integers(1, 4))
            ecs.append(sorted(pool[used:used + sz]))
            used += sz
        G = int(r.integers(5, 40))
        rg_off, rg_ecs = [0], []
        for _ in range(G):
            n = int(r.integers(1, min(4, K) + 1))
            rg_ecs.extend(sorted(r.choice(K, n, replace=False).tolist()))
            rg_off.append(len(rg_ecs))
        counts = r.integers(1, 20, G).astype(np.float64)
        problems.append((ecs, (np.array(rg_off), np.array(rg_ecs)), counts,
                         np.ones(n_alleles)))
    return problems, allele_eff_len, allele_gene, allele_major, n_genes, n_majors


def test_cohort_batched_em_matches_per_cell():
    """Cells-as-a-batched-axis EM: each cell's padded/stacked trajectory
    (with per-cell convergence freeze) must reproduce the solo device
    EM — same iteration counts, counts to f32 reduction-order
    tolerance; an empty cell passes through."""
    from t1k_tpu.ops.em import em_quantify_jax, em_quantify_jax_batched

    (problems, allele_eff_len, allele_gene, allele_major, n_genes,
     n_majors) = _cohort_problems()
    problems[4] = ([], (np.array([0]), np.array([], np.int64)),
                   np.zeros(0), np.ones(len(allele_eff_len)))

    batched = em_quantify_jax_batched(
        problems, allele_eff_len, allele_gene, allele_major, n_genes,
        n_majors)
    assert len(batched) == len(problems)
    for i, p in enumerate(problems):
        it_s, c_s = em_quantify_jax(
            p[0], p[1], p[2], allele_eff_len,
            np.zeros(len(allele_eff_len)), p[3], allele_gene, allele_major,
            n_genes, n_majors)
        it_b, c_b = batched[i]
        assert it_s == it_b, f"cell {i}: iters {it_s} vs {it_b}"
        np.testing.assert_allclose(c_b, c_s, rtol=1e-3, atol=1e-3)


def test_cohort_batched_em_sharded_matches():
    """The cell axis shards over the device mesh with identical results
    (the only collective is the loop-condition all-reduce)."""
    import jax

    from t1k_tpu.ops.em import em_quantify_jax_batched
    from t1k_tpu.parallel.mesh import data_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    (problems, allele_eff_len, allele_gene, allele_major, n_genes,
     n_majors) = _cohort_problems(n_cells=11, seed0=90)
    plain = em_quantify_jax_batched(
        problems, allele_eff_len, allele_gene, allele_major, n_genes,
        n_majors)
    sharded = em_quantify_jax_batched(
        problems, allele_eff_len, allele_gene, allele_major, n_genes,
        n_majors, mesh=data_mesh())
    for (it_a, c_a), (it_b, c_b) in zip(plain, sharded):
        assert it_a == it_b
        np.testing.assert_allclose(c_b, c_a, rtol=1e-4, atol=1e-5)


def test_cohort_batched_em_chunking():
    """A tiny chunk budget forces multiple padded stacks; results must
    not depend on the chunking.  Run in f64 so the check isolates the
    padding/chunk bookkeeping: in f32, reduction-order noise can flip
    the every-10-rounds mask's strict comparisons and legitimately
    diverge trajectories (same sensitivity as the reference's own f32
    assignment weights)."""
    import jax

    from t1k_tpu.ops.em import em_quantify_jax_batched

    (problems, allele_eff_len, allele_gene, allele_major, n_genes,
     n_majors) = _cohort_problems(n_cells=7, seed0=130)
    with jax.enable_x64():
        one = em_quantify_jax_batched(
            problems, allele_eff_len, allele_gene, allele_major, n_genes,
            n_majors)
        many = em_quantify_jax_batched(
            problems, allele_eff_len, allele_gene, allele_major, n_genes,
            n_majors, max_chunk_elems=1500)
    for (it_a, c_a), (it_b, c_b) in zip(one, many):
        assert it_a == it_b
        np.testing.assert_allclose(c_b, c_a, rtol=1e-9, atol=1e-9)
