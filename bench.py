"""Round benchmark: full genotyper-stage throughput vs the reference,
PLUS device-executed metrics for the GPU programs.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": R,
   "device": {"platform": "gpu", "kind": ..., "count": N},
   "device_metrics": {...}}

Headline workload: the HLA-scale end-to-end benchmark
(benchmarks/hla_scale.py — 24 genes x 250 alleles, 12,000 read pairs,
100bp).  The metric is candidate reads aligned per second for the FULL
genotyper stage (read ingest, unique-read dedupe, seed/chain/banded-DP
assignment, mate pairing, coalescing, EC construction, EM, selection
and outputs) on the production default backend.  Baseline = the
reference T1K `genotyper` binary on the SAME input, single thread both
sides; outputs are byte-compared before reporting.

Device metrics: each microbenchmark runs in its own subprocess with its
own timeout, so one failing program cannot black out the others:

  band_dp       benchmarks/aligner_kernel.py  band-DP slice time
  device_em     benchmarks/em_iters.py        SQUAREM rounds/s on device
  device_screen benchmarks/kmer_screen.py     extraction-screen reads/s

The benchmark needs a GPU: on a host where JAX finds none it exits
non-zero instead of reporting host-only numbers.  Every device run is a
child process, one at a time, so this process never holds the card.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

REF_SRC = "/root/reference"
REF_BIN = os.environ.get("T1K_REFERENCE_BIN", "/tmp/t1k-ref-bench")

# per-subprocess budget for one device microbenchmark
DEV_TIMEOUT_S = float(os.environ.get("T1K_DEVICE_BENCH_TIMEOUT_S", "600"))


def gpu_device() -> dict:
    """The GPU as JAX reports it, asked in a child process so that this
    process keeps off the card; exits non-zero without a GPU."""
    probe = ("import jax, json; d = jax.devices(); print(json.dumps("
             "{'platform': d[0].platform, 'kind': d[0].device_kind, "
             "'count': len(d)}))")
    p = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True)
    dev = json.loads(p.stdout.strip().splitlines()[-1]) if p.returncode == 0 \
        else {"platform": "none"}
    if dev["platform"] != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX finds {dev}")
    return dev


def ensure_reference() -> str:
    """Build the reference binaries once; returns the genotyper path."""
    geno = os.path.join(REF_BIN, "genotyper")
    if os.path.exists(geno):
        return geno
    import shutil

    shutil.copytree(REF_SRC, REF_BIN, dirs_exist_ok=True)
    subprocess.run(["make", "-j8"], cwd=REF_BIN, check=True,
                   capture_output=True)
    return geno


def run_device_bench(script: str, args=()):
    """One device microbenchmark in its own subprocess + timeout.

    Returns the benchmark's parsed JSON line(s), or a machine-readable
    {"status": "timeout"|"error", ...} marker — never raises."""
    cmd = [sys.executable, os.path.join(ROOT, "benchmarks", script)] + list(args)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    try:
        p = subprocess.run(cmd, timeout=DEV_TIMEOUT_S, capture_output=True,
                           text=True, env=env)
    except subprocess.TimeoutExpired:
        return {"status": "timeout", "timeout_s": DEV_TIMEOUT_S}
    lines = []
    for ln in p.stdout.splitlines():
        ln = ln.strip()
        if ln.startswith("{"):
            try:
                lines.append(json.loads(ln))
            except json.JSONDecodeError:
                pass
    if p.returncode != 0 or not lines:
        return {"status": "error", "rc": p.returncode,
                "stderr_tail": p.stderr[-400:]}
    return lines[0] if len(lines) == 1 else lines


def main():
    device = gpu_device()
    # Generate the benchmark inputs (cached in /tmp/hlabench).
    env = dict(os.environ)
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "benchmarks", "hla_scale.py"),
                    "none"], check=True, capture_output=True, env=env)
    OUT = "/tmp/hlabench"
    panel, fq1, fq2 = f"{OUT}/panel.fa", f"{OUT}/r_1.fq", f"{OUT}/r_2.fq"

    # --- ours, production default backend, single thread, in a child
    # process (one process holds the card at a time)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "t1k_tpu.cli.genotype",
                    "-f", panel, "-1", fq1, "-2", fq2,
                    "-o", f"{OUT}/bench_mine", "-t", "1"],
                   check=True, capture_output=True, env=env, cwd=ROOT)
    ours = time.perf_counter() - t0

    # --- reference binary, same input, single thread
    geno = ensure_reference()
    t0 = time.perf_counter()
    subprocess.run([geno, "-f", panel, "-1", fq1, "-2", fq2,
                    "-o", f"{OUT}/bench_ref", "-t", "1"],
                   check=True, capture_output=True)
    ref = time.perf_counter() - t0

    # validity: byte-identical calls
    for suf in ("_genotype.tsv", "_allele.tsv"):
        a = open(f"{OUT}/bench_mine{suf}").read()
        b = open(f"{OUT}/bench_ref{suf}").read()
        assert a == b, f"output mismatch vs reference: {suf}"

    # --- device-executed metrics, each in its own subprocess + timeout
    device_metrics = {
        "band_dp": run_device_bench("aligner_kernel.py"),
        "device_em": run_device_bench("em_iters.py"),
        "device_screen": run_device_bench("kmer_screen.py"),
        "sharded_em": run_device_bench("sharded_em.py"),
        "cohort_em": run_device_bench("cohort_em.py", ["2048"]),
    }

    n_reads = 24000  # 12k pairs, both mates aligned
    print(json.dumps({
        "metric": "genotyper_stage_reads_per_s",
        "value": round(n_reads / ours, 1),
        "unit": "candidate reads aligned/s (full stage, "
                "byte-identical to reference)",
        "vs_baseline": round(ref / ours, 3),
        "device": device,
        "device_metrics": device_metrics,
    }))


if __name__ == "__main__":
    main()
