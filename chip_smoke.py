#!/usr/bin/env python3
"""Smoke test of the whole system on one GPU, in one process.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the multi-device phases only

Phases (each prints its seconds; any failure exits non-zero before the
last line):

  0  environment: card name and power limit (nvidia-smi), JAX version,
     devices, compile-cache directory, device round trip; builds the
     native library from the committed sources.  Exits non-zero unless
     JAX runs on a GPU.
  1  the gpu-marked tests (pytest -m gpu, in this process).
  2  compiles at real widths, each with its compile seconds and
     memory_analysis(): the band DP at both deferred length buckets on
     full 131,072-item slices, the dense EM at the auto gate's size and
     near DENSE_EM_MAX_BYTES, the extraction screen at every tier up to
     2^22.
  3  each device program against its plain reference on the card: band
     DP vs the native walk (exact), dense and segment EM vs native
     (f32 vs f64 at rtol 2e-3; rounded abundances equal after the f64
     polish), cohort EM vs per-cell native, device screen vs native.
  4  the extract -> genotype -> analyze chain (cli.run.main) at a real
     size on a panel and sample made from --seed: device and auto runs
     in this process, the native oracle runs in a child process that
     never touches the card (started with phase 1, so it overlaps the
     device phases); outputs compared against the native run.
     --deviceCandidates runs once on a smaller sample of the same kind,
     compared the same way against its own native run.
  5  proof that the device did the work: the stage counters of the
     device and auto runs, and per-stage seconds of each run.

The last line is {"ok": true, "device": {...}} with the device as JAX
reports it.  Inputs are written under <repo>/.smoke/ and removed at the
end.
"""

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
READ_LEN = 100
GENES, ALLELES, ALLELE_LEN, ALLELE_SNPS = 24, 250, 1500, 30
ON_TARGET_GENES = 8
CHAIN_OUTPUTS = ("_genotype.tsv", "_allele.tsv", "_allele.vcf",
                 "_aligned_1.fa", "_aligned_2.fa")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*parts):
    print(*parts, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        say(f"== phase {self.name}")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else "FAILED"
        say(f"== phase {self.name}: {status} in {dt:.1f} s")
        return False


def gpu_label():
    """`name, power.limit` of the card, as nvidia-smi reports them (from
    a child process that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------------ inputs

def make_panel(path, seed):
    """An HLA-class RNA panel: GENES genes x ALLELES alleles of
    ALLELE_LEN bases.  Each gene has its own random backbone (genes differ
    at ~75% of positions), each allele carries ALLELE_SNPS substitutions
    against it, and names follow the IPD-IMGT/HLA field layout, so two
    synonymous alleles share each 3-field major allele.  The header
    comment carries six exon spans, as in T1K's *_rna_seq.fa."""
    rng = np.random.default_rng(seed)
    edges = np.linspace(100, ALLELE_LEN - 100, 7).astype(int)
    exons = " ".join(f"{a + (i > 0)} {b}" for i, (a, b)
                     in enumerate(zip(edges[:-1], edges[1:])))
    comment = f"{len(edges) - 1} {exons}"
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "w") as f:
        for g in range(GENES):
            backbone = rng.integers(0, 4, ALLELE_LEN)
            for a in range(ALLELES):
                seq = backbone.copy()
                pos = rng.choice(ALLELE_LEN, ALLELE_SNPS, replace=False)
                seq[pos] = (seq[pos] + rng.integers(1, 4, ALLELE_SNPS)) % 4
                name = (f"G{g:02d}*{a // 10:02d}:{a % 10 // 2 + 1:02d}"
                        f":01:{a % 2 + 1:02d}")
                f.write(f">{name} {comment}\n"
                        f"{acgt[seq].tobytes().decode()}\n")


def _fastq_block(seqs, first_index):
    """FASTQ bytes for fixed-length ASCII reads [n, READ_LEN], named
    @s<9-digit index>."""
    n = len(seqs)
    # "@s" + 9 digits + "\n", sequence + "\n", "+\n", qualities + "\n"
    rec = np.empty((n, 12 + READ_LEN + 3 + READ_LEN + 1), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1] = ord("s")
    idx = np.arange(first_index, first_index + n)
    for d in range(9):
        rec[:, 2 + d] = 48 + (idx // 10 ** (8 - d)) % 10
    rec[:, 11] = ord("\n")
    rec[:, 12:12 + READ_LEN] = seqs
    o = 12 + READ_LEN
    rec[:, o] = ord("\n")
    rec[:, o + 1] = ord("+")
    rec[:, o + 2] = ord("\n")
    rec[:, o + 3:o + 3 + READ_LEN] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def make_sample(panel, prefix, n_pairs, on_frac, seed):
    """n_pairs read pairs of READ_LEN bases: on_frac of them simulated
    (tools/simulate.py) from two alleles of each of ON_TARGET_GENES
    genes, the rest random off-target background, shuffled together."""
    from t1k_tpu.io.reads import read_seq_file
    from t1k_tpu.tools.simulate import SimConfig, simulate_pairs

    rng = np.random.default_rng(seed)
    by_gene = {}
    for rec in read_seq_file(panel):
        by_gene.setdefault(rec.id.split("*")[0], []).append(rec)
    chosen, abund = [], []
    for g in sorted(by_gene)[:ON_TARGET_GENES]:
        for j, p in enumerate(rng.choice(len(by_gene[g]), 2, replace=False)):
            chosen.append(by_gene[g][p])
            abund.append(1.0 - 0.3 * j)
    n_on = int(round(n_pairs * on_frac))
    r1, r2 = simulate_pairs(chosen, abund,
                            SimConfig(n_pairs=n_on, read_len=READ_LEN,
                                      seed=seed + 1))
    slots = np.sort(rng.choice(n_pairs, n_on, replace=False))
    on1 = np.frombuffer("".join(r.seq for r in r1).encode(),
                        np.uint8).reshape(n_on, READ_LEN)
    on2 = np.frombuffer("".join(r.seq for r in r2).encode(),
                        np.uint8).reshape(n_on, READ_LEN)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    chunk = 500_000
    with open(prefix + "_1.fq", "wb") as f1, open(prefix + "_2.fq", "wb") as f2:
        for lo in range(0, n_pairs, chunk):
            hi = min(lo + chunk, n_pairs)
            s1 = acgt[rng.integers(0, 4, (hi - lo, READ_LEN))]
            s2 = acgt[rng.integers(0, 4, (hi - lo, READ_LEN))]
            a, b = np.searchsorted(slots, [lo, hi])
            s1[slots[a:b] - lo] = on1[a:b]
            s2[slots[a:b] - lo] = on2[a:b]
            f1.write(_fastq_block(s1, lo))
            f2.write(_fastq_block(s2, lo))
    return n_on


# ------------------------------------------------------------------ phases

def phase_environment():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(f"JAX runs on {devs[0].platform}, not a GPU")
    label = gpu_label()
    say(label)
    say(f"card: {label}")
    say(f"jax {jax.__version__}; devices {devs}")
    from t1k_tpu.utils import jaxcache

    say(f"compile cache: {jaxcache.cache_dir()}")
    native = os.path.join(ROOT, "t1k_tpu", "native")
    r = subprocess.run(["make", "-C", native], capture_output=True, text=True)
    if r.returncode != 0:
        raise SmokeFailure("native build failed:\n" + r.stdout[-2000:]
                           + r.stderr[-2000:])
    ldd = subprocess.run(["ldd", os.path.join(native, "libt1k_native.so")],
                         capture_output=True, text=True).stdout
    say(f"native library built; libdeflate linked: {'libdeflate' in ldd}")
    from t1k_tpu.core.pipeline import device_rtt_ms

    say(f"device round trip: {device_rtt_ms(reps=5):.3f} ms "
        f"(auto DP gate T1K_DEVICE_RTT_MS="
        f"{os.environ.get('T1K_DEVICE_RTT_MS', '10')})")
    return label


def phase_gpu_tests():
    import pytest

    os.environ["T1K_REAL_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def _compiled_report(name, lowered):
    t0 = time.perf_counter()
    compiled = lowered.compile()
    dt = time.perf_counter() - t0
    say(f"compile {name}: {dt:.2f} s; memory {compiled.memory_analysis()}")
    return compiled, dt


def _em_args(rg_cnt, ec_cnt, n_alleles, dtype):
    import jax
    import jax.numpy as jnp

    S = jax.ShapeDtypeStruct
    return (S((rg_cnt, ec_cnt), jnp.int8), S((rg_cnt,), dtype),
            S((ec_cnt,), dtype), S((ec_cnt,), dtype),
            S((ec_cnt,), jnp.int32), S((n_alleles,), jnp.int32),
            S((n_alleles,), jnp.bool_), S((n_alleles,), jnp.int32),
            S((n_alleles,), jnp.int32), S((ec_cnt,), dtype),
            S((), jnp.float32), S((), jnp.float32))


def phase_compile(panel):
    """Compile the device programs at real widths; returns the band-DP
    slice timings (the §2 measurement) for phase 5."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from benchmarks.aligner_kernel import time_desc_slices
    from t1k_tpu.ops import em as em_mod

    dp = time_desc_slices(reps=5)
    for lb, r in dp.items():
        say(f"compile band DP Lb={lb} (131072-item slice): "
            f"{r['compile_s']:.2f} s; memory {r['memory']}")
        say(f"band DP Lb={lb}: {r['slice_s'] * 1e3:.3f} ms per slice "
            f"({r['items'] / r['slice_s']:.4g} items/s)")

    # dense EM: the auto gate's size and a size near DENSE_EM_MAX_BYTES
    for rg, ec in ((100_000, 600), (4_000_000, 1000)):
        assert rg * ec <= em_mod.DENSE_EM_MAX_BYTES
        lowered = em_mod._em_loop_dense.lower(
            *_em_args(rg, ec, 2 * ec, jnp.float32), ec_cnt=ec, gene_cnt=8,
            major_cnt=ec, max_iterations=1000, mask_round=10)
        compiled, _ = _compiled_report(f"dense EM {rg}x{ec}", lowered)
        temp = compiled.memory_analysis().temp_size_in_bytes
        a_bytes = rg * ec
        # a float32 copy of A would need 4x its int8 bytes of scratch
        say(f"dense EM {rg}x{ec}: A is {a_bytes / 2**30:.3f} GiB int8; "
            f"temp {temp / 2**30:.3f} GiB; float32 copy of A "
            f"materialized: {temp >= a_bytes}")

    # extraction screen at every tier up to 2^22, on the smoke panel's
    # index (the panel fixes the table sizes and sequence count)
    from t1k_tpu.constants import EXTRACTOR_HIT_LEN_PAIRED
    from t1k_tpu.io.reads import read_seq_file
    from t1k_tpu.io.refset import RefSet
    from t1k_tpu.ops import phase_a

    rs = RefSet(digit_units=-1, delimiter="")
    for rec in read_seq_file(panel):
        rs.add_allele(rec.id, rec.seq, rec.comment)
    packed = rs.packed()
    k = max(rs.infer_kmer_length(), 9)
    screen = phase_a.DeviceScreen.build(packed, k, EXTRACTOR_HIT_LEN_PAIRED,
                                        0.8, hit_cap=1 << 22)
    idx = screen.index
    S = jax.ShapeDtypeStruct
    rows, L = screen.row_chunk, 128
    probe_in = (S((rows, L), jnp.int8), S((rows,), jnp.int32),
                idx.starts, idx.keys, idx.hstart, idx.hcount)
    probe_kw = dict(k=idx.k, direct=idx.direct, hsize=idx.hsize,
                    max_probe=idx.max_probe)
    _compiled_report(f"screen probe k={k} rows={rows} L={L}",
                     phase_a._probe_kernel.lower(*probe_in, **probe_kw))
    contrib, cstart, _ = jax.eval_shape(
        lambda *a: phase_a._probe_kernel(*a, **probe_kw), *probe_in)
    for tier in screen.tiers:
        _compiled_report(
            f"screen chain tier 2^{tier.bit_length() - 1}",
            phase_a._chain_kernel.lower(
                contrib, cstart, S((rows,), jnp.int32), S((rows,), jnp.int32),
                idx.post_seq, idx.post_off, k=idx.k, n_seqs=idx.n_seqs,
                radius=screen.radius,
                hit_len_required=screen.hit_len_required, cap=tier,
                bucket_cap=screen.bucket_cap))
    return dp, packed, k


def _walk(tc, tl, pc, pl):
    from t1k_tpu.native import align_global

    out = np.zeros((len(tl), 4), np.int64)
    for i in range(len(tl)):
        s, ops = align_global(tc[i, :tl[i]], pc[i, :pl[i]])
        out[i] = (s, np.count_nonzero(ops == 0), np.count_nonzero(ops == 1),
                  np.count_nonzero((ops == 2) | (ops == 3)))
    return out


def check_band_dp(n_pairs, seed):
    from t1k_tpu.constants import encode_seq
    from t1k_tpu.ops.align import _DESC_ML, _DESC_W, banded_scores, banded_stats

    rng = np.random.default_rng(seed)
    lp = rng.integers(100, 151, n_pairs).astype(np.int32)
    lt = np.clip(lp + rng.integers(-10, 11, n_pairs), 1, 150).astype(np.int32)
    tc = rng.integers(0, 4, (n_pairs, 150)).astype(np.int8)
    pc = tc.copy()
    mut = rng.random(tc.shape) < 0.03
    pc[mut] = rng.integers(0, 5, int(mut.sum()))
    indel = rng.random(n_pairs) < 0.3  # shift the pattern: gaps in the walk
    pc[indel] = np.roll(pc[indel], 3, axis=1)
    t0 = time.perf_counter()
    got = np.stack(banded_stats(tc, lt, pc, lp, ml=_DESC_ML, w=_DESC_W), 1)
    dev_s = time.perf_counter() - t0
    want = _walk(tc, lt, pc, lp)
    bad = int((got != want).any(axis=1).sum())
    say(f"band DP vs native walk: {n_pairs} pairs (lengths 100-150, "
        f"|dlen| <= 10), {bad} differ (device call {dev_s:.2f} s)")
    check(bad == 0, "band DP differs from the native walk")

    cases = []
    with open(os.path.join(ROOT, "tests", "golden", "align_global.tsv")) as f:
        for line in f:
            _, _, t, p, score, _ = line.rstrip("\n").split("\t")
            cases.append(("" if t == "-" else t, "" if p == "-" else p,
                          int(score)))
    Lt = max(len(c[0]) for c in cases) + 1
    Lp = max(len(c[1]) for c in cases) + 1
    tc = np.zeros((len(cases), Lt), np.int8)
    pc = np.zeros((len(cases), Lp), np.int8)
    for i, (t, p, _) in enumerate(cases):
        tc[i, :len(t)] = encode_seq(t)
        pc[i, :len(p)] = encode_seq(p)
    tl = np.array([len(c[0]) for c in cases], np.int32)
    pl = np.array([len(c[1]) for c in cases], np.int32)
    got = banded_scores(tc, tl, pc, pl)
    bad = int((got != np.array([c[2] for c in cases])).sum())
    say(f"band DP vs golden: {len(cases)} cases, {bad} differ")
    check(bad == 0, "band DP differs from tests/golden/align_global.tsv")


def _em_problem(rng, rg_cnt, ec_cnt):
    n_alleles = 2 * ec_cnt
    k = rng.integers(1, 5, rg_cnt)
    offs = np.zeros(rg_cnt + 1, np.int64)
    offs[1:] = np.cumsum(k)
    ecs = np.concatenate([rng.choice(ec_cnt, size=int(m), replace=False)
                          for m in k]).astype(np.int32)
    return dict(
        ec_to_alleles=[[2 * i, 2 * i + 1] for i in range(ec_cnt)],
        rg_ecs_csr=(offs, ecs),
        rg_counts=rng.choice([1.0, 0.5, 2.0], rg_cnt),
        allele_eff_len=rng.integers(900, 1400, n_alleles).astype(np.int32),
        allele_missing=np.zeros(n_alleles, np.int32),
        allele_weight=rng.integers(1, 4, n_alleles).astype(np.int32),
        allele_gene=(np.arange(n_alleles) // 2 % 8).astype(np.int32),
        allele_major=(np.arange(n_alleles) // 2).astype(np.int32),
        n_genes=8, n_majors=ec_cnt)


def _ec_len(args):
    return np.array([min(int(args["allele_eff_len"][a]) for a in al)
                     for al in args["ec_to_alleles"]], np.float64)


def check_em(seed):
    from t1k_tpu.native import em_quantify
    from t1k_tpu.ops import em as em_mod

    args = _em_problem(np.random.default_rng(seed), 100_000, 600)
    it_nat, c_nat = em_quantify(**args)
    ec_len = _ec_len(args)
    for route in ("dense", "segment"):
        saved = em_mod.DENSE_EM_MAX_ELEMS
        if route == "segment":
            em_mod.DENSE_EM_MAX_ELEMS = 0
        try:
            t0 = time.perf_counter()
            it_dev, c_dev = em_mod.em_quantify_jax(**args)
            dt = time.perf_counter() - t0
        finally:
            em_mod.DENSE_EM_MAX_ELEMS = saved
        rel = float(np.max(np.abs(c_dev - c_nat) / np.maximum(
            np.abs(c_nat), 1e-3)))
        x = c_dev / ec_len
        it_pol, pol = em_quantify(init_x=x / x.sum(), **args)
        n_diff = int((np.round(pol / ec_len * 1000, 2)
                      != np.round(c_nat / ec_len * 1000, 2)).sum())
        say(f"{route} EM 100000x600: {it_dev} f32 iters in {dt:.2f} s vs "
            f"native {it_nat}; max rel diff {rel:.2e} (rtol 2e-3); "
            f"{it_pol} polish iters, {n_diff} rounded abundances differ")
        check(np.allclose(c_dev, c_nat, rtol=2e-3, atol=1e-3),
              f"{route} EM outside rtol 2e-3 of native")
        check(n_diff == 0, f"{route} EM: rounded abundances differ after "
              "the f64 polish")


def _cohort(rng, n_cells, n_alleles=400, n_genes=8):
    problems = []
    for _ in range(n_cells):
        K = int(rng.integers(20, 120))
        pool = rng.permutation(n_alleles)
        sizes = rng.integers(1, 4, K)
        cut = np.concatenate([[0], np.cumsum(sizes)])
        ecs = [sorted(pool[cut[i]:cut[i + 1]].tolist()) for i in range(K)]
        G = int(rng.integers(200, 2000))
        m = rng.integers(1, 4, G)
        offs = np.zeros(G + 1, np.int64)
        offs[1:] = np.cumsum(m)
        rg_ecs = np.concatenate([np.sort(rng.choice(K, int(j), replace=False))
                                 for j in m])
        problems.append((ecs, (offs, rg_ecs),
                         rng.integers(1, 20, G).astype(np.float64),
                         np.ones(n_alleles)))
    return problems


def check_cohort_em(n_cells, seed, mesh=None, against_native=True):
    """Cohort EM of n_cells random cells; returns the per-cell results.

    Against per-cell native runs: the same program under 64-bit mode
    must take the native iteration counts and match to 1e-6 (summation
    order differs); the float32 program must land within rtol 2e-3 of
    the native counts plus an absolute 1e-4 of the cell's reads, since a
    float32 trajectory meets its 1e-5 L1 stopping step a round earlier
    or later than float64 and so stops a fraction of a read away on
    low-count ECs."""
    import jax

    from t1k_tpu.native import em_quantify
    from t1k_tpu.ops.em import em_quantify_jax_batched

    rng = np.random.default_rng(seed)
    n_alleles, n_genes = 400, 8
    problems = _cohort(rng, n_cells, n_alleles, n_genes)
    eff = rng.integers(800, 1600, n_alleles).astype(np.float64)
    # synonymous pairs share a major allele, and a major allele belongs
    # to one gene (as allele names guarantee in a real panel)
    major = (np.arange(n_alleles) // 2).astype(np.int32)
    gene = major % n_genes
    run = lambda: em_quantify_jax_batched(  # noqa: E731
        problems, eff, gene, major, n_genes, n_alleles // 2, mesh=mesh)
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0
    if not against_native:
        return res, dt
    with jax.enable_x64():
        res64 = run()
    bad32, bad64 = [], []
    for i, (p, (_, c), (it64, c64)) in enumerate(zip(problems, res, res64)):
        it, want = em_quantify(p[0], p[1], p[2], eff.astype(np.int32),
                               np.zeros(n_alleles, np.int32),
                               p[3].astype(np.int32), gene, major, n_genes,
                               n_alleles // 2)
        if not np.allclose(c, want, rtol=2e-3, atol=1e-4 * want.sum()):
            bad32.append(i)
        if it64 != it or not np.allclose(c64, want, rtol=1e-6, atol=1e-6):
            bad64.append(i)
    say(f"cohort EM: {n_cells} cells in {dt:.2f} s; float32: {len(bad32)} "
        f"cells outside rtol 2e-3 + 1e-4 of the cell's reads of per-cell "
        f"native {bad32[:10]}; 64-bit: {len(bad64)} cells differ "
        f"{bad64[:10]}")
    check(not bad32 and not bad64,
          "cohort EM differs from per-cell native runs")
    return res, dt


def check_screen(panel, packed, k, n_reads, seed):
    from t1k_tpu.constants import EXTRACTOR_HIT_LEN_PAIRED
    from t1k_tpu.io.reads import read_seq_file
    from t1k_tpu.native import NativeEngine
    from t1k_tpu.ops.phase_a import DeviceScreen

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_reads, READ_LEN)).astype(np.int8)
    # a quarter on target: windows of panel alleles with a few errors
    on = rng.random(n_reads) < 0.25
    starts = np.asarray(packed.seq_starts)
    lens = np.asarray(packed.seq_lens)
    s = rng.integers(0, packed.n, int(on.sum()))
    o = rng.integers(0, lens[s] - READ_LEN)
    src = np.asarray(packed.seq_codes, np.int8)
    win = src[(starts[s] + o)[:, None] + np.arange(READ_LEN)]
    err = rng.random(win.shape) < 0.02
    win[err] = rng.integers(0, 4, int(err.sum()))
    codes[on] = win
    read_lens = np.full(n_reads, READ_LEN, np.int32)
    hit_len = EXTRACTOR_HIT_LEN_PAIRED
    screen = DeviceScreen.build(packed, k, hit_len, 0.8)
    t0 = time.perf_counter()
    verdict, decided = screen.screen(codes, read_lens)
    dev_s = time.perf_counter() - t0
    engine = NativeEngine(packed, k, ref_seq_similarity=0.8,
                          hit_len_required=hit_len)
    flat_starts = np.arange(n_reads, dtype=np.int64) * READ_LEN
    t0 = time.perf_counter()
    want = engine.screen_batch(codes.reshape(-1), flat_starts,
                               read_lens).astype(bool)
    nat_s = time.perf_counter() - t0
    bad = int((verdict[decided] != want[decided]).sum())
    say(f"device screen vs native: {n_reads} reads, {int(decided.sum())} "
        f"decided on the device, {int(want.sum())} accepted, {bad} verdicts "
        f"differ; device {dev_s:.2f} s ({n_reads / dev_s:.4g} reads/s), "
        f"native {nat_s:.2f} s ({n_reads / nat_s:.4g} reads/s, 1 core)")
    check(bad == 0, "device screen verdicts differ from the native screen")
    check(decided.mean() > 0.9, "device screen decided < 90% of reads")


def _chain_argv(panel, sample, outdir, name, flags):
    return (["-f", panel, "-1", sample + "_1.fq", "-2", sample + "_2.fq",
             "--od", outdir, "-o", name, "-t", "1", "--preset", "hla"]
            + flags)


def _chain_metrics(outdir, name):
    with open(os.path.join(outdir, name + "_metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(outdir, name + "_analyzer_metrics.json")) as f:
        metrics.update(json.load(f))
    return metrics


def run_chain(panel, sample, outdir, name, flags):
    """One chain run in this process, through cli.run.main."""
    from t1k_tpu.cli.run import main

    t0 = time.perf_counter()
    rc = main(_chain_argv(panel, sample, outdir, name, flags))
    dt = time.perf_counter() - t0
    check(rc == 0, f"chain run {name} exited {rc}")
    say(f"chain {name} ({' '.join(flags)}): {dt:.1f} s")
    return dt, _chain_metrics(outdir, name)


NATIVE_FLAGS = ["--backend", "native", "--emBackend", "native"]
_NATIVE_CHILD = """
import json, sys, time
from t1k_tpu.cli.run import main
for argv in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    rc = main(argv)
    print(json.dumps({"name": argv[argv.index("-o") + 1], "rc": rc,
                      "seconds": time.perf_counter() - t0}), flush=True)
    if rc:
        sys.exit(rc)
"""


def start_native_runs(jobs, log_path):
    """The native oracle runs, in a child process that never touches the
    card (JAX pinned to the CPU, both backends native), so they proceed
    on the host while this process drives the device.  jobs: (panel,
    sample, outdir, name) tuples."""
    argvs = [_chain_argv(p, s, o, n, NATIVE_FLAGS) for p, s, o, n in jobs]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("T1K_BACKEND", None)
    log = open(log_path, "w")
    return subprocess.Popen(
        [sys.executable, "-c", _NATIVE_CHILD, json.dumps(argvs)],
        stdout=subprocess.PIPE, stderr=log, text=True, env=env, cwd=ROOT)


def finish_native_runs(proc, outdir, log_path):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        with open(log_path) as f:
            sys.stderr.write(f.read()[-4000:])
    check(proc.returncode == 0, f"native chain runs exited {proc.returncode}")
    runs = {}
    for line in out.splitlines():
        r = json.loads(line)
        say(f"chain {r['name']} ({' '.join(NATIVE_FLAGS)}, host-only child "
            f"process): {r['seconds']:.1f} s")
        runs[r["name"]] = (r["seconds"], _chain_metrics(outdir, r["name"]))
    return runs


def _genotype_rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def compare_chain(outdir, name, base, em_route):
    """Byte-compare a run's outputs with the native run's.  Where the run
    took the device EM route, _genotype.tsv is compared field by field
    instead: every field byte-equal except the abundances, which the
    float32 SQUAREM trajectory plus float64 polish reproduces to within
    the EM's own convergence criterion (an L1 step of 1e-5 on the
    normalized abundances), so rtol 1e-5; the largest difference is
    printed."""
    for suf in CHAIN_OUTPUTS:
        a = os.path.join(outdir, name + suf)
        b = os.path.join(outdir, base + suf)
        check(os.path.exists(a) and os.path.exists(b), f"missing {suf}")
        same = filecmp.cmp(a, b, shallow=False)
        say(f"  {name}{suf} == {base}{suf}: {same} "
            f"({os.path.getsize(a)} bytes)")
        if same:
            continue
        check(suf == "_genotype.tsv" and em_route == "jax",
              f"{name}{suf} differs from the native run")
        ra, rb = _genotype_rows(a), _genotype_rows(b)
        check(len(ra) == len(rb) and all(len(x) == len(y)
                                         for x, y in zip(ra, rb)),
              f"{name}_genotype.tsv has another shape than native")
        worst = 0.0
        for x, y in zip(ra, rb):
            for col, (u, v) in enumerate(zip(x, y)):
                if col in (3, 6) and u != v:  # abundance_1, abundance_2
                    fu, fv = float(u), float(v)
                    worst = max(worst, abs(fu - fv) / max(abs(fv), 1e-6))
                    check(np.isclose(fu, fv, rtol=1e-5, atol=1e-6),
                          f"{name}: abundance {u} vs native {v}")
                else:
                    check(u == v, f"{name}_genotype.tsv: {u!r} vs native "
                          f"{v!r} in row {x[0]}")
        say(f"  {name}_genotype.tsv is NOT byte-identical to native: the "
            f"device-EM abundances differ (max rel diff {worst:.2e}, within "
            f"rtol 1e-5); every other field is equal")


def print_stages(label, runs):
    stages = ("extraction_screen", "read_assignment", "fragment_assignment",
              "em_quantification", "allele_selection",
              "analyzer_read_assignment")
    say(f"per-stage seconds on {label} (set-up evidence, not a benchmark; "
        "the native run shared the host with the device phases):")
    say("  " + "stage".ljust(26) + "".join(n.rjust(12) for n in runs))
    for st in stages:
        say("  " + st.ljust(26) + "".join(
            f"{m.get(st, {}).get('seconds', float('nan')):12.2f}"
            for _, m in runs.values()))
    say("  " + "wall".ljust(26) + "".join(f"{dt:12.1f}"
                                          for dt, _ in runs.values()))


def single_card(args):
    native_proc = None
    try:
        with Phase("0 environment"):
            label = phase_environment()
        os.makedirs(WORK, exist_ok=True)
        panel = os.path.join(WORK, "panel.fa")
        with Phase("inputs"):
            make_panel(panel, args.seed)
            big = os.path.join(WORK, "sample")
            n_on = make_sample(panel, big, args.pairs, args.on_target,
                               args.seed + 10)
            small = os.path.join(WORK, "cand_sample")
            n_on_small = make_sample(panel, small, args.cand_pairs,
                                     args.on_target, args.seed + 20)
            out = os.path.join(WORK, "out")
            os.makedirs(out, exist_ok=True)
            native_log = os.path.join(WORK, "native_runs.log")
            native_proc = start_native_runs(
                [(panel, small, out, "cand_native"),
                 (panel, big, out, "native")], native_log)
            say(f"panel: {GENES} genes x {ALLELES} alleles x {ALLELE_LEN} bp "
                f"({GENES * ALLELES * ALLELE_LEN / 1e6:.1f} Mb); sample: "
                f"{args.pairs} pairs of {READ_LEN} bp, {n_on} on target; "
                f"--deviceCandidates sample: {args.cand_pairs} pairs, "
                f"{n_on_small} on target")
            say("cuts against a real deployment: a full IPD-IMGT/HLA panel has "
                "tens of thousands of alleles over ~40 genes, and a real "
                "RNA-seq/WES sample has tens of millions of pairs; here 24 x "
                f"250 synthetic alleles and {args.pairs} pairs")
        with Phase("1 gpu-marked tests"):
            phase_gpu_tests()
        with Phase("2 compile"):
            dp, packed, k = phase_compile(panel)
        with Phase("3 device vs reference"):
            check_band_dp(args.dp_pairs, args.seed + 1)
            check_em(args.seed + 2)
            check_cohort_em(args.cells, args.seed + 3)
            check_screen(panel, packed, k, args.screen_reads, args.seed + 4)
        runs = {}
        with Phase("4 chain"):
            runs["device"] = run_chain(panel, big, out, "device",
                                       ["--backend", "device",
                                        "--emBackend", "jax"])
            runs["auto"] = run_chain(panel, big, out, "auto", ["--backend", "auto"])
            cand = run_chain(panel, small, out, "cand",
                             ["--backend", "device", "--deviceCandidates"])
            native = finish_native_runs(native_proc, out, native_log)
            runs["native"] = native["native"]
            for name, base, run in (("device", "native", runs["device"]),
                                    ("auto", "native", runs["auto"]),
                                    ("cand", "cand_native", cand)):
                compare_chain(out, name, base,
                              run[1]["em_quantification"].get("em_route"))
        with Phase("5 device counters"):
            dev = runs["device"][1]
            auto = runs["auto"][1]
            screened = dev["extraction_screen"].get("device_screened_read_count", 0)
            items = dev["read_assignment"].get("device_dp_item_count", 0)
            route = dev["em_quantification"].get("em_route")
            say(f"device run: {screened} reads decided by the device screen, "
                f"{items} DP items scored on the device, EM route {route}")
            check(screened > 0 and items > 0 and route == "jax",
                  "the device run left a stage on the host")
            a_screen = auto["extraction_screen"].get("device_screened_read_count", 0)
            a_items = auto["read_assignment"].get("device_dp_item_count", 0)
            say(f"auto run: {a_screen} reads decided by the device screen, "
                f"{a_items} DP items on the device, EM route "
                f"{auto['em_quantification'].get('em_route')}")
            check(a_screen > 0 and a_items > 0,
                  "auto did not engage the device screen and the DP offload")
            ra = dev["read_assignment"]
            dp_s = sum(ra.get(f"device_dp_slices_lb{lb}", 0) * r["slice_s"]
                       for lb, r in dp.items())
            say(f"deferred DP: {ra.get('device_dp_slices_lb96', 0)} + "
                f"{ra.get('device_dp_slices_lb256', 0)} slices (Lb 96 + 256) = "
                f"{dp_s:.3f} s of device time in a read_assignment stage of "
                f"{ra['seconds']:.2f} s ({100 * dp_s / ra['seconds']:.2f}%)")
            print_stages(label, runs)
        shutil.rmtree(WORK, ignore_errors=True)
    finally:
        if native_proc is not None and native_proc.poll() is None:
            native_proc.kill()
            native_proc.wait()


def multi_card(args):
    """The paths that exist only across cards: the cohort EM sharded over
    a 4-device mesh against the same call on one device, and
    dryrun_multichip(4) against the native oracle (f64 rerun included)."""
    import jax

    with Phase("0 environment"):
        phase_environment()
        check(len(jax.devices()) >= 4, "--multi needs 4 GPUs")
    with Phase("multi: sharded cohort EM"):
        from t1k_tpu.parallel.mesh import data_mesh

        mesh = data_mesh(4)
        one, dt1 = check_cohort_em(args.cells, args.seed + 3,
                                   against_native=False)
        four, dt4 = check_cohort_em(args.cells, args.seed + 3, mesh=mesh,
                                    against_native=False)
        bad = [i for i, ((ia, ca), (ib, cb)) in enumerate(zip(one, four))
               if ia != ib or not np.allclose(ca, cb, rtol=1e-4, atol=1e-5)]
        say(f"cohort EM {args.cells} cells: 1 device {dt1:.2f} s, "
            f"4-device mesh {dt4:.2f} s; {len(bad)} cells differ {bad[:10]}")
        check(not bad, "sharded cohort EM differs from one device")
    with Phase("multi: dryrun_multichip(4)"):
        sys.path.insert(0, ROOT)
        import __graft_entry__

        __graft_entry__.dryrun_multichip(4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phases")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--pairs", type=int, default=3_000_000,
                    help="read pairs of the chain sample")
    ap.add_argument("--on-target", type=float, default=0.02)
    ap.add_argument("--cand-pairs", type=int, default=200_000,
                    help="read pairs of the --deviceCandidates sample")
    ap.add_argument("--dp-pairs", type=int, default=200_000)
    ap.add_argument("--screen-reads", type=int, default=1_000_000)
    ap.add_argument("--cells", type=int, default=256)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        if args.multi:
            multi_card(args)
        else:
            single_card(args)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
