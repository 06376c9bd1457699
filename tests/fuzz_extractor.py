"""Randomized extractor parity fuzz: random panels plus on/off-target
read mixtures through the reference fastq-extractor and cli.extract,
byte-comparing the candidate fastq(s) and formatted/corrected barcode
output across the option surface: paired/single/interleaved and
MULTI-FILE inputs, -s, read1/read2 trimming ranges, barcode slicing
(start/end/revcomp), and whitelist correction.

Not collected by pytest (no test_ prefix) — run manually:
  python tests/fuzz_extractor.py <start_seed> <n_cases>
Requires the reference binaries in T1K_REFERENCE_BIN
(default /tmp/t1k-ref).
"""

import os
import random
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from t1k_tpu.io.reads import SeqRecord, write_fastq  # noqa: E402
from t1k_tpu.tools.simulate import SimConfig, simulate_pairs  # noqa: E402
from tests.fuzz_genotyper import make_panel  # noqa: E402

REF_BIN = os.path.join(os.environ.get("T1K_REFERENCE_BIN", "/tmp/t1k-ref"),
                       "fastq-extractor")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = "/tmp/extractfuzz"
BASES = "ACGT"


def _rand_read(rng, n):
    return "".join(rng.choice(BASES) for _ in range(n))


def _make_reads(rng, records, n, read_len, lead1=0, lead2=0, bc_len=0):
    """On-target pairs diluted with random background; optional leading
    junk (exercises read ranges) and per-read barcodes."""
    genes = sorted({r[0].split("*")[0] for r in records})
    by_gene = {g: [r for r in records if r[0].startswith(g + "*")]
               for g in genes}
    chosen, abund = [], []
    for g in genes:
        r = rng.choice(by_gene[g])
        chosen.append(SeqRecord(r[0], r[1], None, r[2]))
        abund.append(1.0)
    cfg = SimConfig(n_pairs=n, seed=rng.randint(0, 10**6),
                    read_len=read_len,
                    error_rate=rng.choice([0.0, 0.01]))
    r1, r2 = simulate_pairs(chosen, abund, cfg)
    out1, out2, bcs = [], [], []
    for i, (a, b) in enumerate(zip(r1, r2)):
        if rng.random() < 0.5:  # replace with off-target background
            a = SeqRecord(a.id, _rand_read(rng, read_len), a.qual, None)
            b = SeqRecord(b.id, _rand_read(rng, read_len), b.qual, None)
        if lead1:
            a = SeqRecord(a.id, _rand_read(rng, lead1) + a.seq,
                          ("I" * lead1 + a.qual) if a.qual else None, None)
        if lead2:
            b = SeqRecord(b.id, _rand_read(rng, lead2) + b.seq,
                          ("I" * lead2 + b.qual) if b.qual else None, None)
        out1.append(a)
        out2.append(b)
        if bc_len:
            bcs.append(SeqRecord(a.id, _rand_read(rng, bc_len),
                                 "I" * bc_len, None))
    return out1, out2, bcs


def run_case(seed):
    rng = random.Random(seed)
    case = f"{OUT}/case_{seed}"
    shutil.rmtree(case, ignore_errors=True)
    os.makedirs(case)

    panel = f"{case}/panel.fa"
    records = make_panel(rng, panel, dna=rng.random() < 0.3)

    io_mode = rng.choices(["paired", "single", "interleaved"],
                          weights=[0.55, 0.3, 0.15])[0]
    multi = io_mode in ("paired", "single") and rng.random() < 0.3
    read_len = rng.choice([75, 100])
    lead1 = rng.choice([0, 0, 8]) if io_mode != "interleaved" else 0
    lead2 = rng.choice([0, 0, 6]) if io_mode == "paired" else 0
    use_bc = rng.random() < 0.4 and io_mode != "interleaved"
    bc_len = rng.choice([8, 12]) if use_bc else 0

    n = rng.randint(80, 250)
    r1, r2, bcs = _make_reads(rng, records, n, read_len, lead1, lead2,
                              bc_len)
    extra = []
    io_args = []
    bc_files = []
    if io_mode == "interleaved":
        inter = [x for pair in zip(r1, r2) for x in pair]
        write_fastq(f"{case}/ri.fq", inter)
        io_args = ["-i", f"{case}/ri.fq"]
    else:
        splits = ([(0, n)] if not multi
                  else [(0, n // 2), (n // 2, n)])
        f1s, f2s, bfs = [], [], []
        for si, (lo, hi) in enumerate(splits):
            f1 = f"{case}/r{si}_1.fq"
            write_fastq(f1, r1[lo:hi])
            f1s.append(f1)
            if io_mode == "paired":
                f2 = f"{case}/r{si}_2.fq"
                write_fastq(f2, r2[lo:hi])
                f2s.append(f2)
            if use_bc:
                bf = f"{case}/bc{si}.fq"
                write_fastq(bf, bcs[lo:hi])
                bfs.append(bf)
        if io_mode == "paired":
            for f in f1s:
                io_args += ["-1", f]
            for f in f2s:
                io_args += ["-2", f]
        else:
            for f in f1s:
                io_args += ["-u", f]
        bc_files = bfs

    if rng.random() < 0.5:
        extra += ["-s", rng.choice(["0.8", "0.9", "0.97"])]
    if lead1:
        extra += ["--read1Start", str(lead1)]
        if rng.random() < 0.5:
            extra += ["--read1End", str(lead1 + read_len - 1)]
    if lead2:
        extra += ["--read2Start", str(lead2)]
    for bf in bc_files:
        extra += ["--barcode", bf]
    if bc_files:
        if rng.random() < 0.5:
            extra += ["--barcodeStart", "1",
                      "--barcodeEnd", str(bc_len - 2)]
        if rng.random() < 0.3:
            extra += ["--barcodeRevComp"]
        if rng.random() < 0.4:
            # whitelist: half the observed barcodes plus 1-Hamming decoys
            wl = sorted({b.seq for b in bcs})[::2]
            with open(f"{case}/wl.txt", "w") as f:
                f.write("\n".join(wl) + "\n")
            extra += ["--barcodeWhitelist", f"{case}/wl.txt"]

    r = subprocess.run([REF_BIN, "-f", panel, "-o", f"{case}/ref"]
                       + io_args + extra, capture_output=True)
    if r.returncode != 0:
        shutil.rmtree(case, ignore_errors=True)
        return "refcrash"

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # ours-only flags, e.g. T1K_FUZZ_EXTRA_ARGS="--backend device" runs
    # the device screen in front of the exact native re-screen of the
    # undecided reads — output must stay byte-identical
    ours_extra = os.environ.get("T1K_FUZZ_EXTRA_ARGS", "").split()
    if os.environ.get("T1K_FUZZ_JAX_CPU"):
        # run the device screen's XLA program on the CPU (identical
        # math, no card needed)
        env["JAX_PLATFORMS"] = "cpu"
    m = subprocess.run(
        [sys.executable, "-m", "t1k_tpu.cli.extract", "-f", panel,
         "-o", f"{case}/mine"] + io_args + extra + ours_extra,
        capture_output=True, env=env)
    if m.returncode != 0:
        print(f"seed {seed}: our rc={m.returncode} (mode={io_mode} "
              f"extra={extra})\n{m.stderr.decode()[-300:]}")
        return "fail"

    ok = True
    ref_files = sorted(f for f in os.listdir(case) if f.startswith("ref"))
    mine_files = sorted(f for f in os.listdir(case) if f.startswith("mine"))
    if [f[3:] for f in ref_files] != [f[4:] for f in mine_files]:
        print(f"seed {seed}: file sets differ: {ref_files} vs {mine_files} "
              f"(mode={io_mode} multi={multi} extra={extra})")
        ok = False
    else:
        for rf, mf in zip(ref_files, mine_files):
            with open(os.path.join(case, rf), "rb") as f:
                a = f.read()
            with open(os.path.join(case, mf), "rb") as f:
                b = f.read()
            if a != b:
                print(f"seed {seed}: DIFF {rf} (mode={io_mode} "
                      f"multi={multi} lead=({lead1},{lead2}) extra={extra})")
                ok = False
    if ok:
        shutil.rmtree(case, ignore_errors=True)
    return "ok" if ok else "fail"


if __name__ == "__main__":
    start, n = int(sys.argv[1]), int(sys.argv[2])
    stats = {"ok": 0, "fail": 0, "refcrash": 0}
    for seed in range(start, start + n):
        stats[run_case(seed)] += 1
        if (seed - start + 1) % 20 == 0:
            print(f"...{seed - start + 1} done: {stats}", flush=True)
    print(stats)
