"""Randomized genotyper fuzz: synthetic multi-gene panels (rna and dna
mode with N separators), simulated reads, randomized flags; run the
reference genotyper binary and cli.genotype, byte-compare every output.

Not collected by pytest (no test_ prefix) — run manually:
  python tests/fuzz_genotyper.py <start_seed> <n_cases>
Requires the reference binaries (see tests/make_goldens.py docstring);
build with:  cp -r /root/reference /tmp/t1k-src && make -C /tmp/t1k-src
"""

import hashlib
import os
import random
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from t1k_tpu.io.reads import SeqRecord, write_fastq  # noqa: E402
from t1k_tpu.tools.simulate import SimConfig, simulate_pairs  # noqa: E402

REF_BIN = os.environ.get("T1K_REFERENCE_BIN", "/tmp/t1k-ref") + "/genotyper"
OUT = "/tmp/genofuzz"
BASES = "ACGT"


def _rand_seq(rng, n):
    return "".join(rng.choice(BASES) for _ in range(n))


def _mutate(rng, seq, sub_rate, indel_rate=0.0):
    out = []
    for c in seq:
        r = rng.random()
        if r < sub_rate and c in BASES:
            out.append(BASES[(BASES.index(c) + rng.randint(1, 3)) % 4])
        elif r < sub_rate + indel_rate:
            if rng.random() < 0.5:
                continue  # deletion
            out.append(c)
            out.append(rng.choice(BASES))  # insertion
        else:
            out.append(c)
    return "".join(out)


def make_panel(rng, path, dna):
    """Genes diverge by 1-5%, alleles within a gene by 0.1-1%.  DNA mode
    builds exon blocks with intron padding and single-N separators and
    real exon coords; RNA mode uses a 50bp UTR + one or more exons."""
    big = bool(os.environ.get("T1K_FUZZ_BIG"))
    n_genes = rng.randint(3, 6) if big else rng.randint(1, 3)
    gene_div = rng.uniform(0.01, 0.05)
    records = []
    base = _rand_seq(rng, rng.randint(500, 1200))
    for g in range(n_genes):
        gname = f"FZG{chr(65 + g)}"
        gene_seq = _mutate(rng, base, gene_div)
        n_alleles = rng.randint(6, 30) if big else rng.randint(2, 12)
        if dna:
            # exon layout over the gene sequence
            n_ex = rng.randint(2, 4)
            cut = sorted(rng.sample(range(60, len(gene_seq) - 60), n_ex - 1))
            bounds = [0] + cut + [len(gene_seq)]
            exons = [gene_seq[bounds[i]:bounds[i + 1]] for i in range(n_ex)]
        for a in range(n_alleles):
            allele_seq = _mutate(rng, gene_seq, rng.uniform(0.001, 0.01),
                                 indel_rate=0.0 if dna else 0.002)
            if dna:
                al_ex = [_mutate(rng, e, rng.uniform(0.001, 0.01))
                         for e in exons]
                parts = [_rand_seq(rng, 50)]
                coords = []
                pos = 50
                for i, e in enumerate(al_ex):
                    coords.append((pos, pos + len(e) - 1))
                    parts.append(e)
                    pos += len(e)
                    if i + 1 < len(al_ex):
                        pad_l = _rand_seq(rng, rng.randint(40, 120))
                        pad_r = _rand_seq(rng, rng.randint(40, 120))
                        parts.append(pad_l + "N" + pad_r)
                        pos += len(pad_l) + 1 + len(pad_r)
                parts.append(_rand_seq(rng, 50))
                seq = "".join(parts)
                comment = f"{len(coords)} " + " ".join(
                    f"{s} {e}" for s, e in coords)
            else:
                seq = _rand_seq(rng, 50) + allele_seq + _rand_seq(rng, 50)
                comment = f"1 50 {50 + len(allele_seq) - 1}"
            records.append((f"{gname}*{a + 1:03d}", seq, comment))
    with open(path, "w") as f:
        for name, seq, comment in records:
            f.write(f">{name} {comment}\n{seq}\n")
    return records


def sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_case(seed):
    rng = random.Random(seed)
    os.makedirs(OUT, exist_ok=True)
    dna = rng.random() < 0.4
    panel = f"{OUT}/panel_{seed}.fa"
    records = make_panel(rng, panel, dna)

    # reads from 1-2 alleles per gene
    genes = sorted({r[0].split("*")[0] for r in records})
    by_gene = {g: [r for r in records if r[0].startswith(g + "*")]
               for g in genes}
    chosen, abund = [], []
    for g in genes:
        for r in rng.sample(by_gene[g], min(len(by_gene[g]), rng.randint(1, 2))):
            chosen.append(SeqRecord(r[0], r[1], None, r[2]))
            abund.append(rng.uniform(0.4, 1.0))
    n_pairs = (rng.randint(300, 900) if os.environ.get("T1K_FUZZ_BIG")
               else rng.randint(40, 300))
    cfg = SimConfig(n_pairs=n_pairs, seed=seed,
                    read_len=rng.choice([75, 100]),
                    error_rate=rng.choice([0.0, 0.005, 0.02]))
    r1, r2 = simulate_pairs(chosen, abund, cfg)
    paired = rng.random() < 0.75
    p1, p2 = f"{OUT}/r1_{seed}.fq", f"{OUT}/r2_{seed}.fq"
    write_fastq(p1, r1)
    if paired:
        write_fastq(p2, r2)

    args = []
    if dna:
        if rng.random() < 0.7:
            args += ["--relaxIntronAlign"]
        args += ["-s", rng.choice(["0.8", "0.9"])]
    else:
        args += ["-s", rng.choice(["0.8", "0.97"])]
    if rng.random() < 0.3:
        args += ["--frac", rng.choice(["0.05", "0.3"])]
    if rng.random() < 0.3:
        args += ["--cov", rng.choice(["0.5", "2.0"])]
    if rng.random() < 0.3:
        args += ["--crossGeneRate", rng.choice(["0.0", "0.1"])]
    if rng.random() < 0.2:
        args += ["-n", rng.choice(["20", "5"])]

    refp, minep = f"{OUT}/ref_{seed}", f"{OUT}/mine_{seed}"
    cmd = [REF_BIN, "-f", panel, "-o", refp, "--outputReadAssignment"] + args
    inp = ["-1", p1, "-2", p2] if paired else ["-u", p1]
    r = subprocess.run(cmd + inp, capture_output=True)
    if r.returncode != 0:
        return "refcrash"

    from t1k_tpu.cli.genotype import main as gmain

    # T1K_FUZZ_EXTRA_ARGS="--backend device" fuzzes the deferred-DP path
    # (with JAX_PLATFORMS=cpu, the same band DP on the CPU)
    extra = os.environ.get("T1K_FUZZ_EXTRA_ARGS", "").split()
    # Randomly exercise the device candidate-pruning path too (exact
    # pre-DP chain filters on the keep set, ops/phase_a.py
    # DeviceCandidates) — byte-identical by construction across every
    # mode this harness generates: DNA with separator clipping,
    # --relaxIntronAlign, single-end, RNA (SeqSet.hpp:2005-2051).
    if rng.random() < 0.4 and "--deviceCandidates" not in extra:
        extra = extra + ["--deviceCandidates"]
    rc = gmain(["-f", panel, "-o", minep, "--outputReadAssignment"]
               + args + inp + extra)
    if rc != 0:
        print(f"seed {seed}: our rc={rc}")
        return "fail"

    ok = True
    for suf in ("_genotype.tsv", "_allele.tsv"):
        if open(refp + suf).read() != open(minep + suf).read():
            print(f"seed {seed}: DIFF {suf} (dna={dna} args={args})")
            ok = False

    # -a EM-bypass parity: re-run both with a synthesized kallisto-style
    # abundance file (Genotyper.hpp:1016-1051 skips quantification)
    if ok and rng.random() < 0.25:
        ab = f"{OUT}/abund_{seed}.tsv"
        arng = random.Random(seed ^ 0xAB)
        with open(ab, "w") as f:
            f.write("target_id\tlength\teff_length\test_counts\ttpm\n")
            for name, _, _ in records:
                if arng.random() < 0.8:
                    f.write(f"{name}\t1000\t900\t"
                            f"{arng.uniform(0, 80):.4f}\t0\n")
        r = subprocess.run(cmd + inp + ["-a", ab], capture_output=True)
        if r.returncode == 0:
            rc = gmain(["-f", panel, "-o", minep, "--outputReadAssignment",
                        "-a", ab] + args + inp + extra)
            if rc != 0:
                print(f"seed {seed}: -a rc={rc}")
                ok = False
            for suf in ("_genotype.tsv", "_allele.tsv"):
                if open(refp + suf).read() != open(minep + suf).read():
                    print(f"seed {seed}: DIFF -a {suf} (dna={dna})")
                    ok = False
    for suf in ("_assign.tsv",):
        a = sorted(open(refp + suf).readlines())
        b = sorted(open(minep + suf).readlines())
        if a != b:
            print(f"seed {seed}: DIFF {suf} (dna={dna} args={args})")
            ok = False
    aligned = "_aligned_1.fa" if paired else "_aligned.fa"
    if sha(refp + aligned) != sha(minep + aligned):
        print(f"seed {seed}: DIFF {aligned} (dna={dna} args={args})")
        ok = False
    if ok:
        for f in os.listdir(OUT):
            if f"_{seed}." in f or f.endswith(f"_{seed}") or f"_{seed}_" in f:
                os.unlink(os.path.join(OUT, f))
    return "ok" if ok else "fail"


if __name__ == "__main__":
    start, n = int(sys.argv[1]), int(sys.argv[2])
    stats = {"ok": 0, "fail": 0, "refcrash": 0}
    for seed in range(start, start + n):
        stats[run_case(seed)] += 1
        if (seed - start + 1) % 20 == 0:
            print(f"...{seed - start + 1} done: {stats}", flush=True)
    print(stats)
