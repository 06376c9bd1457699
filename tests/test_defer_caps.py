"""Deferred-DP cap boundaries (engine.cc kDeferMaxLen / kDeferMaxDiff and
the stats kernel's 9-bit packed counters).

Items whose gap/extension window exceeds the device length cap (254) or
whose length difference exceeds 10 must be aligned inline by the engine;
everything else goes to the external stats fn.  Both routes must stay
byte-identical to the pure-inline path, and the kernel must refuse
shapes whose counter fields could overflow (t_len+p_len+2 >= 512)."""

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

DEFER_MAX_LEN = 254   # engine.cc kDeferMaxLen
DEFER_MAX_DIFF = 10   # engine.cc kDeferMaxDiff


def _oracle_stats(tc, tl, pc, pl):
    out = np.zeros(len(tl), np.int32)
    for i in range(len(tl)):
        _, ops = align_global(tc[i, :tl[i]], pc[i, :pl[i]])
        out[i] = int((ops == 0).sum())
    return out


class CapCheckingStats:
    """Oracle stats fn that records every deferred item's shape and
    asserts the engine honors the caps."""

    def __init__(self):
        self.shapes = []

    def __call__(self, tc, tl, pc, pl):
        for a, b in zip(tl.tolist(), pl.tolist()):
            assert a <= DEFER_MAX_LEN and b <= DEFER_MAX_LEN, (a, b)
            assert abs(a - b) <= DEFER_MAX_DIFF, (a, b)
            self.shapes.append((a, b))
        return _oracle_stats(tc, tl, pc, pl)


def _pack(seqs):
    codes = [encode_seq(s) for s in seqs]
    lens = np.array([len(c) for c in codes], np.int32)
    starts = np.zeros(len(codes), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    return (np.concatenate(codes).astype(np.int8), starts, lens,
            np.ones(len(codes), np.int32))


def _refset():
    if not os.path.exists(CYP_RNA):
        pytest.skip("cyp2d6 database unavailable")
    recs = list(read_seq_file(CYP_RNA))
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        for r in recs[:6]:
            f.write(f">{r.id} {r.comment}\n{r.seq}\n")
        name = f.name
    rs = RefSet.from_fasta(name)
    os.unlink(name)
    return rs, recs[0].seq


def test_long_reads_route_oversize_windows_inline():
    """300-450bp reads produce extension overhangs above the 254 cap;
    the engine must align those inline while keeping in-cap items
    deferred, byte-identical to the all-inline path."""
    rs, base = _refset()
    rng = np.random.default_rng(11)
    seqs = []
    # long reads anchored at one end so the other end's overhang window
    # spans up to ~readlen (well past the cap)
    for L in (250, 254, 255, 300, 400, 450):
        p = int(rng.integers(0, len(base) - L - 1))
        s = list(base[p:p + L])
        # a mismatch cluster near one end breaks the chain there,
        # forcing a long extension window
        for q in range(5, 40, 7):
            s[q] = "ACGT"[("ACGT".index(s[q]) + 1) % 4]
        seqs.append("".join(s))
    flat, starts, lens, weights = _pack(seqs)
    packed = rs.packed()
    k = rs.infer_kmer_length()

    eng1 = NativeEngine(packed, k)
    rec1, off1 = eng1.assign_batch(flat, starts, lens, weights)

    checker = CapCheckingStats()
    eng2 = NativeEngine(packed, k)
    rec2, off2 = eng2.assign_batch_deferred(flat, starts, lens, weights,
                                            checker)
    assert np.array_equal(rec1, rec2)
    assert np.array_equal(off1, off2)
    assert np.array_equal(eng1.pos_weight(), eng2.pos_weight())
    assert rec1.shape[0] > 0
    assert checker.shapes, "expected some in-cap deferred items"


@pytest.mark.parametrize("indel", [9, 10, 11, 14])
def test_diff_cap_boundary(indel):
    """Gap windows from an indel of `indel` bases have |Δlen| == indel;
    10 is the last deferred size, 11+ must fall back inline — identical
    output either way."""
    rs, base = _refset()
    rng = np.random.default_rng(100 + indel)
    seqs = []
    for i in range(12):
        p = int(rng.integers(100, len(base) - 220))
        s = list(base[p:p + 120])
        q = int(rng.integers(20, 90))
        if i % 2 == 0:
            del s[q:q + indel]
        else:
            s[q:q] = list("ACGT"[int(b)]
                          for b in rng.integers(0, 4, indel))
        seqs.append("".join(s[:120]))
    flat, starts, lens, weights = _pack(seqs)
    packed = rs.packed()
    k = rs.infer_kmer_length()

    eng1 = NativeEngine(packed, k)
    rec1, off1 = eng1.assign_batch(flat, starts, lens, weights)

    checker = CapCheckingStats()
    eng2 = NativeEngine(packed, k)
    rec2, off2 = eng2.assign_batch_deferred(flat, starts, lens, weights,
                                            checker)
    assert np.array_equal(rec1, rec2)
    assert np.array_equal(off1, off2)
    diffs = {abs(a - b) for a, b in checker.shapes}
    if indel == DEFER_MAX_DIFF:
        # the last deferrable size must actually ride the device path
        assert DEFER_MAX_DIFF in diffs, "expected the Δ=10 window on-device"
    assert max(diffs, default=0) <= DEFER_MAX_DIFF


def test_kernel_511_op_walk_boundary():
    """The packed counters carry up to t_len+p_len+2 ops; 254+254+2=510
    is the largest legal walk (counts must match the oracle exactly) and
    255+255 must be refused."""
    from t1k_tpu.ops.align import banded_stats

    rng = np.random.default_rng(3)
    L = 254
    t = rng.integers(0, 4, size=(4, L)).astype(np.int8)
    # p = t with sprinkled mismatches so the walk is all 254 columns long
    p = t.copy()
    for i in range(4):
        for q in range(i + 1, L, 17):
            p[i, q] = (p[i, q] + 1) % 4
    tl = np.full(4, L, np.int32)
    pl = np.full(4, L, np.int32)
    scores, match, mis, ind = banded_stats(t, tl, p, pl)
    for i in range(4):
        sc, ops = align_global(t[i], p[i])
        assert scores[i] == sc
        assert match[i] == int((ops == 0).sum())
        assert mis[i] == int((ops == 1).sum())
        assert int(match[i] + mis[i] + ind[i]) <= 510

    big = np.zeros((1, 255), np.int8)
    with pytest.raises(AssertionError):
        banded_stats(big, np.array([255], np.int32), big,
                     np.array([255], np.int32))
