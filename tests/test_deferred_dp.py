"""Deferred-DP assignment path: the engine's three-phase batch mode
(seed/chain -> external gap counts -> external extension counts ->
finish) must be byte-identical to the inline path, with the native
oracle, the device band DP and the descriptor service serving the
counts."""

import os

import numpy as np
import pytest

from t1k_tpu.constants import encode_seq
from t1k_tpu.io.reads import read_seq_file
from t1k_tpu.io.refset import RefSet
from t1k_tpu.native import NativeEngine, align_global

CYP_RNA = os.environ.get(
    "T1K_CYP2D6_IDX", "/root/reference/vcf_database/cyp2d6_idx"
) + "/cyp2d6_rna_seq.fa"


def _oracle_stats(tc, tl, pc, pl):
    out = np.zeros(len(tl), np.int32)
    for i in range(len(tl)):
        _, ops = align_global(tc[i, :tl[i]], pc[i, :pl[i]])
        out[i] = int((ops == 0).sum())
    return out


def _setup(n_alleles=None, n_reads=80):
    from t1k_tpu.tools.simulate import SimConfig, simulate_pairs

    recs = list(read_seq_file(CYP_RNA))
    if n_alleles:
        import tempfile

        sub = tempfile.NamedTemporaryFile(
            "w", suffix=".fa", delete=False)
        for r in recs[:n_alleles]:
            sub.write(f">{r.id} {r.comment}\n{r.seq}\n")
        sub.close()
        rs = RefSet.from_fasta(sub.name)
        os.unlink(sub.name)
    else:
        rs = RefSet.from_fasta(CYP_RNA)
    by_name = {r.id: r for r in recs}
    r1, r2 = simulate_pairs([by_name["CYP2D6*1"], by_name["CYP2D6*4"]],
                            [1.0, 0.8], SimConfig(n_pairs=n_reads, seed=5))
    seqs = [r.seq for r in r1] + [r.seq for r in r2]
    codes = [encode_seq(s) for s in seqs]
    lens = np.array([len(c) for c in codes], np.int32)
    starts = np.zeros(len(codes), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    flat = np.concatenate(codes).astype(np.int8)
    weights = np.ones(len(codes), np.int32)
    return rs, flat, starts, lens, weights


@pytest.mark.parametrize("threads", [1, 3])
def test_deferred_matches_inline_oracle(threads):
    if not os.path.exists(CYP_RNA):
        pytest.skip("cyp2d6 database unavailable")
    rs, flat, starts, lens, weights = _setup(n_alleles=24, n_reads=60)
    packed = rs.packed()
    k = rs.infer_kmer_length()

    eng1 = NativeEngine(packed, k, threads=threads)
    rec1, off1 = eng1.assign_batch(flat, starts, lens, weights)
    pw1 = eng1.pos_weight()

    eng2 = NativeEngine(packed, k, threads=threads)
    rec2, off2 = eng2.assign_batch_deferred(flat, starts, lens, weights,
                                            _oracle_stats)
    pw2 = eng2.pos_weight()

    assert rec1.shape == rec2.shape
    assert np.array_equal(rec1, rec2)
    assert np.array_equal(off1, off2)
    assert np.array_equal(pw1, pw2)
    assert rec1.shape[0] > 0


def test_deferred_matches_inline_pallas_interpret():
    if not os.path.exists(CYP_RNA):
        pytest.skip("cyp2d6 database unavailable")
    from t1k_tpu.ops.align import make_deferred_stats_fn

    rs, flat, starts, lens, weights = _setup(n_alleles=8, n_reads=20)
    packed = rs.packed()
    k = rs.infer_kmer_length()

    eng1 = NativeEngine(packed, k)
    rec1, off1 = eng1.assign_batch(flat, starts, lens, weights)

    eng2 = NativeEngine(packed, k)
    rec2, off2 = eng2.assign_batch_deferred(
        flat, starts, lens, weights, make_deferred_stats_fn())

    assert np.array_equal(rec1, rec2)
    assert np.array_equal(off1, off2)


def test_desc_service_matches_inline_on_multigene_panel():
    """The descriptor transport the device backend runs (reference and
    reads device-resident, small fixed slices here) through the engine's
    chunked deferral leaves the same engine state as the inline path, on
    the in-repo multigene panel and reads."""
    from t1k_tpu.ops.align import DeferredDescService

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    rs = RefSet.from_fasta(os.path.join(data, "multigene_rna.fa"))
    recs1 = list(read_seq_file(os.path.join(data, "multigene_1.fq")))[:150]
    recs2 = list(read_seq_file(os.path.join(data, "multigene_2.fq")))[:150]
    seqs = [r.seq for r in recs1] + [r.seq for r in recs2]
    codes = [encode_seq(s) for s in seqs]
    lens = np.array([len(c) for c in codes], np.int32)
    starts = np.zeros(len(codes), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    flat = np.concatenate(codes).astype(np.int8)
    weights = np.ones(len(codes), np.int32)
    packed = rs.packed()
    k = rs.infer_kmer_length()

    eng1 = NativeEngine(packed, k)
    rec1, off1 = eng1.assign_batch(flat, starts, lens, weights)
    svc = DeferredDescService(slice_items=512)
    eng2 = NativeEngine(packed, k)
    rec2, off2 = eng2.assign_batch_deferred(flat, starts, lens, weights,
                                            desc_service=svc)
    assert np.array_equal(rec1, rec2)
    assert np.array_equal(off1, off2)
    assert np.array_equal(eng1.pos_weight(), eng2.pos_weight())
    assert svc.items_scored > 0 and rec1.shape[0] > 0


def test_chunked_deferral_matches_unchunked():
    """Bounded-chunk deferral must leave identical engine-side state
    (fragment records + coverage) as one-shot deferral."""
    if not os.path.exists(CYP_RNA):
        pytest.skip("cyp2d6 database unavailable")
    rs, flat, starts, lens, weights = _setup(n_alleles=24, n_reads=50)
    packed = rs.packed()
    k = rs.infer_kmer_length()
    n = len(lens)
    uid1 = np.arange(n // 2, dtype=np.int64)
    uid2 = np.arange(n // 2, n, dtype=np.int64)
    has_n = np.zeros(n // 2, np.uint8)

    eng1 = NativeEngine(packed, k)
    eng1.assign_batch_deferred(flat, starts, lens, weights, _oracle_stats,
                               store_results=False)
    rec1, cnt1, fl1 = eng1.fragment_batch(uid1, uid2, has_n, True, 2000, None)
    pw1 = eng1.pos_weight()

    eng2 = NativeEngine(packed, k)
    eng2.assign_batch_deferred(flat, starts, lens, weights, _oracle_stats,
                               store_results=False, chunk_size=17)
    rec2, cnt2, fl2 = eng2.fragment_batch(uid1, uid2, has_n, True, 2000, None)
    pw2 = eng2.pos_weight()

    assert np.array_equal(rec1, rec2)
    assert np.array_equal(cnt1, cnt2)
    assert np.array_equal(fl1, fl2)
    assert np.array_equal(pw1, pw2)
    assert rec1.shape[0] > 0


@pytest.mark.parametrize("chunk", [37, 100])
def test_chunked_deferral_with_device_candidates(chunk):
    """Device candidate pruning through chunked deferral: every chunk's
    begin pass must prune with its own reads' candidate buckets, so the
    engine ends in the same state as an unpruned run (on the in-repo
    multigene panel, many chunks)."""
    from t1k_tpu.ops.phase_a import DeviceCandidates

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    rs = RefSet.from_fasta(os.path.join(data, "multigene_rna.fa"))
    recs1 = list(read_seq_file(os.path.join(data, "multigene_1.fq")))[:120]
    recs2 = list(read_seq_file(os.path.join(data, "multigene_2.fq")))[:120]
    seqs = [r.seq for r in recs1] + [r.seq for r in recs2]
    codes = [encode_seq(s) for s in seqs]
    lens = np.array([len(c) for c in codes], np.int32)
    starts = np.zeros(len(codes), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    flat = np.concatenate(codes).astype(np.int8)
    weights = np.ones(len(codes), np.int32)
    packed = rs.packed()
    k = rs.infer_kmer_length()
    n = len(lens)
    uid1 = np.arange(n // 2, dtype=np.int64)
    uid2 = np.arange(n // 2, n, dtype=np.int64)
    has_n = np.zeros(n // 2, np.uint8)

    def run(candidates):
        eng = NativeEngine(packed, k)
        if candidates:
            padded = np.full((n, int(lens.max())), 4, np.int8)
            for i, c in enumerate(codes):
                padded[i, :len(c)] = c
            dev = DeviceCandidates.build(packed, k, eng.hit_len_required,
                                         row_chunk=128, tile_rows=1024)
            c_reads, c_seqs, c_strands, undecided = dev.generate(padded, lens)
            assert not undecided.all()
            eng.set_candidates(n, c_reads, c_seqs, c_strands, undecided)
        eng.assign_batch_deferred(flat, starts, lens, weights, _oracle_stats,
                                  store_results=False, chunk_size=chunk)
        total = eng.last_assign_count
        rec, cnt, fl = eng.fragment_batch(uid1, uid2, has_n, True, 2000, None)
        return total, rec, cnt, fl, eng.pos_weight()

    plain, pruned = run(False), run(True)
    assert plain[0] > 0 and plain[0] == pruned[0]
    for a, b in zip(plain[1:], pruned[1:]):
        assert np.array_equal(a, b)


def test_deferred_pallas_with_indel_reads():
    """Reads carrying 3-9bp indels produce gap-fill / extension windows
    with large length differences, exercising the adaptive ML / window
    buckets of the deferred stats DP (ops/align.py make_deferred_stats_fn)
    — still byte-identical to the inline path."""
    if not os.path.exists(CYP_RNA):
        pytest.skip("cyp2d6 database unavailable")
    from t1k_tpu.ops.align import make_deferred_stats_fn

    rs, _, _, _, _ = _setup(n_alleles=8, n_reads=4)
    recs = list(read_seq_file(CYP_RNA))
    base = recs[0].seq
    rng = np.random.default_rng(31)
    seqs = []
    for i in range(24):
        p = int(rng.integers(100, len(base) - 220))
        s = list(base[p:p + 120])
        q = int(rng.integers(20, 90))
        n_ind = int(rng.integers(3, 10))
        if i % 2 == 0:  # deletion of n_ind bases
            del s[q:q + n_ind]
        else:           # insertion of n_ind random bases
            s[q:q] = list("ACGT"[int(b)] for b in rng.integers(0, 4, n_ind))
        seqs.append("".join(s[:120]))
    codes = [encode_seq(s) for s in seqs]
    lens = np.array([len(c) for c in codes], np.int32)
    starts = np.zeros(len(codes), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    flat = np.concatenate(codes).astype(np.int8)
    weights = np.ones(len(codes), np.int32)

    k = rs.infer_kmer_length()
    packed = rs.packed()
    eng1 = NativeEngine(packed, k)
    rec1, off1 = eng1.assign_batch(flat, starts, lens, weights)
    eng2 = NativeEngine(packed, k)
    rec2, off2 = eng2.assign_batch_deferred(
        flat, starts, lens, weights, make_deferred_stats_fn())
    assert np.array_equal(rec1, rec2)
    assert np.array_equal(off1, off2)
    assert rec1.shape[0] > 0
