"""Device-resident phase A (ops/phase_a.py) vs the native engine.

The native screen (engine.cc HasHitInSet) is the oracle — it is itself
fuzz-verified byte-identical against the reference fastq-extractor — so
agreement here certifies the device formulation of the full seeding/
chaining stack: posting-table quirks, probe dedup/skip heuristics,
bucket selection, diagonal clustering, dominant-diagonal seed filter,
the exact LIS tie rules, span accounting, and the mismatch-budget test
(reference SeqSet.hpp:1071-1990).
"""

import numpy as np
import pytest

from t1k_tpu.constants import encode_seq
from t1k_tpu.io.refset import RefSet
from t1k_tpu.native import NativeEngine
from t1k_tpu.ops.phase_a import DeviceScreen, PhaseAIndex

BASES = "ACGT"


def rand_seq(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def mutate(rng, s, rate=0.05, n_rate=0.2):
    out = list(s)
    for i in range(len(out)):
        r = rng.random()
        if r < rate:
            out[i] = BASES[rng.integers(0, 4)]
        elif r < rate * (1 + n_rate):
            out[i] = "N"
    return "".join(out)


def revcomp(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    return "".join(comp[c] for c in reversed(s))


def make_reads(rng, seqs, n):
    reads = []
    for _ in range(n):
        kind = rng.integers(0, 6)
        s = seqs[rng.integers(0, len(seqs))]
        if kind == 0:
            reads.append(rand_seq(rng, int(rng.integers(30, 150))))
        elif kind == 1:
            st = rng.integers(0, max(1, len(s) - 100))
            reads.append(mutate(rng, s[st:st + 100], rng.random() * 0.2))
        elif kind == 2:
            st = rng.integers(0, max(1, len(s) - 100))
            reads.append(revcomp(mutate(rng, s[st:st + 100],
                                        rng.random() * 0.1)))
        elif kind == 3 and len(s) > 250:
            # two distant regions: multi-segment diagonal clusters
            reads.append(mutate(rng, s[:60] + s[-60:], 0.02))
        elif kind == 4:
            reads.append("A" * int(rng.integers(5, 40)))  # code-0 quirk
        else:
            st = rng.integers(0, max(1, len(s) - 60))
            reads.append(mutate(rng, s[st:st + 60], 0.05))
    return reads


def check_parity(seqs, reads, k, hit_len, sim, caps=None):
    refset = RefSet(digit_units=-1, delimiter="")
    for i, s in enumerate(seqs):
        refset.add_allele(f"G{i % 3}*{i:03d}", s, None)
    packed = refset.packed()
    eng = NativeEngine(packed, k, ref_seq_similarity=sim,
                       hit_len_required=hit_len)
    dev = DeviceScreen.build(packed, k, hit_len, sim,
                             **(caps or dict(bucket_cap=128)))
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), 4, np.int8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        c = encode_seq(r)
        codes[i, :len(c)] = c
        lens[i] = len(c)
    verdict, decided = dev.screen(codes, lens)

    cat = np.concatenate([encode_seq(r) for r in reads])
    starts = np.zeros(len(reads), np.int64)
    starts[1:] = np.cumsum(lens[:-1].astype(np.int64))
    ref_flags = eng.screen_batch(cat, starts, lens).astype(bool)
    mism = np.nonzero(decided & (verdict != ref_flags))[0]
    assert len(mism) == 0, (
        f"device screen diverges on {len(mism)} reads, first: "
        f"{reads[mism[0]]!r}")
    return decided


def test_screen_parity_random_panels():
    total_decided = 0
    for trial in range(4):
        rng = np.random.default_rng(500 + trial)
        base = rand_seq(rng, int(rng.integers(300, 700)))
        seqs = []
        for s in range(int(rng.integers(3, 25))):
            if rng.random() < 0.7:
                seqs.append(mutate(rng, base, 0.03).replace("N", "A"))
            else:
                seqs.append(rand_seq(rng, int(rng.integers(200, 600))))
        reads = make_reads(rng, seqs, 60)
        dec = check_parity(seqs, reads, k=9, hit_len=23,
                           sim=[0.8, 0.9, 0.97][trial % 3])
        total_decided += int(dec.sum())
    assert total_decided > 200  # the caps actually decide the bulk


def test_screen_parity_skip_heuristic():
    """>=100-posting k-mers exercise the probe skip path."""
    rng = np.random.default_rng(77)
    base = rand_seq(rng, 500)
    seqs = [mutate(rng, base, 0.01).replace("N", "C") for _ in range(120)]
    reads = make_reads(rng, seqs, 50)
    check_parity(seqs, reads, k=9, hit_len=23, sim=0.8,
                 caps=dict(bucket_cap=256))


def test_screen_parity_repeats_and_hashed():
    """Tandem repeats (duplicate-b chains) and the k=13 hashed table."""
    rng = np.random.default_rng(91)
    motif = rand_seq(rng, 25)
    seqs = [rand_seq(rng, 40) + motif * int(rng.integers(3, 7))
            + rand_seq(rng, 60) + motif + rand_seq(rng, 40)
            for _ in range(10)]
    reads = make_reads(rng, seqs, 50)
    check_parity(seqs, reads, k=9, hit_len=23, sim=0.8)
    base = rand_seq(rng, 600)
    seqs13 = [mutate(rng, base, 0.02).replace("N", "G") for _ in range(15)]
    idx = PhaseAIndex.build(_packed(seqs13), 13)
    assert not idx.direct and idx.max_probe >= 1
    check_parity(seqs13, make_reads(rng, seqs13, 40), k=13, hit_len=23,
                 sim=0.9)


def _packed(seqs):
    rs = RefSet(digit_units=-1, delimiter="")
    for i, s in enumerate(seqs):
        rs.add_allele(f"G0*{i:03d}", s, None)
    return rs.packed()


def test_screen_edge_cases():
    rng = np.random.default_rng(13)
    seqs = [rand_seq(rng, 300)]
    # reads shorter than k, exactly k, all-N, empty-ish
    reads = ["ACGT", seqs[0][:9], "N" * 50, "A" * 9, seqs[0][10:19]]
    check_parity(seqs, reads, k=9, hit_len=9, sim=0.8)


def test_overflow_reads_are_flagged_undecided():
    rng = np.random.default_rng(5)
    base = rand_seq(rng, 400)
    seqs = [mutate(rng, base, 0.005).replace("N", "T") for _ in range(110)]
    reads = [mutate(rng, base[:100], 0.01) for _ in range(8)]
    refset = RefSet(digit_units=-1, delimiter="")
    for i, s in enumerate(seqs):
        refset.add_allele(f"G0*{i:03d}", s, None)
    packed = refset.packed()
    dev = DeviceScreen.build(packed, 9, 23, 0.8,
                             hit_cap=256, bucket_cap=32)
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), 4, np.int8)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode_seq(r)
    _, decided = dev.screen(codes, lens)
    assert not decided.any()  # tiny caps: every read overflows, none lies


# ------------------------------------------------- candidate generation

def check_candidate_parity(seqs, reads, k, hit_len, caps=None):
    """DeviceCandidates vs the engine's overlap-bucket oracle: for every
    DECIDED read, the device keep set must EQUAL the set of buckets that
    emit >= 1 overlap in the assignment path."""
    from t1k_tpu.ops.phase_a import DeviceCandidates

    refset = RefSet(digit_units=-1, delimiter="")
    for i, s in enumerate(seqs):
        refset.add_allele(f"G{i % 3}*{i:03d}", s, None)
    packed = refset.packed()
    eng = NativeEngine(packed, k, hit_len_required=hit_len)
    dev = DeviceCandidates.build(packed, k, hit_len,
                                 **(caps or dict(bucket_cap=128)))

    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), 4, np.int8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        c = encode_seq(r)
        codes[i, :len(c)] = c
        lens[i] = len(c)
    reads_k, seqs_k, strands_k, undecided = dev.generate(codes, lens)

    cat = np.concatenate([encode_seq(r) for r in reads])
    starts = np.zeros(len(reads), np.int64)
    starts[1:] = np.cumsum(lens[:-1].astype(np.int64))
    off, oseqs, ostrands = eng.overlap_buckets(cat, starts, lens)

    dev_sets = {}
    for r, s, st in zip(reads_k, seqs_k, strands_k):
        dev_sets.setdefault(int(r), set()).add((int(s), int(st)))
    n_checked = 0
    for i in range(len(reads)):
        if undecided[i]:
            continue
        want = {(int(oseqs[j]), int(ostrands[j]))
                for j in range(off[i], off[i + 1])}
        got = dev_sets.get(i, set())
        assert got == want, (
            f"read {i} candidate set differs:\n  device-only: "
            f"{sorted(got - want)[:5]}\n  engine-only: "
            f"{sorted(want - got)[:5]}\n  read: {reads[i]!r}")
        n_checked += 1
    return n_checked


def test_candidates_parity_random_panels():
    total = 0
    for trial in range(3):
        rng = np.random.default_rng(900 + trial)
        base = rand_seq(rng, int(rng.integers(300, 700)))
        seqs = []
        for s in range(int(rng.integers(3, 25))):
            if rng.random() < 0.7:
                seqs.append(mutate(rng, base, 0.03).replace("N", "A"))
            else:
                seqs.append(rand_seq(rng, int(rng.integers(200, 600))))
        reads = make_reads(rng, seqs, 40)
        total += check_candidate_parity(seqs, reads, k=9, hit_len=23)
    assert total > 80


def test_candidates_parity_near_identical_panel():
    """The genotyper regime: many near-identical alleles, k=11,
    hitLen=31 — nearly every bucket survives; the keep set must still
    be exact (including the rare losers)."""
    rng = np.random.default_rng(41)
    base = rand_seq(rng, 900)
    seqs = [mutate(rng, base, 0.01).replace("N", "G") for _ in range(40)]
    reads = make_reads(rng, seqs, 40)
    n = check_candidate_parity(seqs, reads, k=11, hit_len=31,
                               caps=dict(bucket_cap=256))
    assert n > 20


@pytest.mark.gpu
def test_candidates_parity_on_gpu(gpu):
    """The candidate parity checks above, with the kernels compiled for
    the card (a scatter, sort or segment reduction that behaves
    differently there shows up here)."""
    test_candidates_parity_random_panels()
    test_candidates_parity_near_identical_panel()
