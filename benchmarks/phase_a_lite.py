"""Phase-A-lite crossover measurement (VERDICT r3 #4).

Quantifies, on the HLA-scale benchmark's real read/panel data:

  * the host assignment stage with and without device candidate
    pruning (engine hits/chain/sort decomposition via
    T1K_ENGINE_PROFILE),
  * the device candidate-generation cost (probe + census + chain
    tiles) and the keep-set return traffic,
  * the pruning factor (surviving buckets / total buckets), and
  * the link bandwidth at which shipping the keep set beats the host
    work it eliminates — the crossover that decides the default
    routing.

Run variants: `python benchmarks/phase_a_lite.py native|pruned` each
print one JSON line from a clean process (profile counters are
process-cumulative); `analysis` prints the oracle-based crossover
numbers without touching the device; no argv runs everything.

Candidate pruning is off by default; its device cost on the GPU is not
measured yet.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

OUT = "/tmp/hlabench"


def load_unique_reads():
    from t1k_tpu.constants import encode_seq
    from t1k_tpu.io.reads import read_seq_files

    seqs = [r.seq for r in read_seq_files([f"{OUT}/r_1.fq"])]
    seqs += [r.seq for r in read_seq_files([f"{OUT}/r_2.fq"])]
    uniq = sorted(set(seqs))
    codes = np.concatenate([encode_seq(s) for s in uniq])
    lens = np.array([len(s) for s in uniq], np.int32)
    starts = np.zeros(len(lens), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    return uniq, codes, starts, lens


def build_engine():
    from t1k_tpu.constants import GENOTYPER_KMER_LENGTH
    from t1k_tpu.io.refset import RefSet
    from t1k_tpu.native import NativeEngine

    refset = RefSet.from_fasta(f"{OUT}/panel.fa", -1, "")
    packed = refset.packed()
    return NativeEngine(packed, GENOTYPER_KMER_LENGTH), packed


def parse_profile(stderr: str) -> dict:
    out = {}
    for line in stderr.splitlines():
        if line.startswith("[engine] hits="):
            for tok in line.replace("[engine] ", "").replace(
                    "(", "").replace(")", "").split():
                k, v = tok.split("=")
                out[k] = float(v.rstrip("s"))
    return out


def run_variant(variant: str):
    """One assignment pass in THIS process; prints a JSON line."""
    uniq, codes, starts, lens = load_unique_reads()
    engine, packed = build_engine()
    w = np.ones(len(lens), np.int32)

    gen_s = 0.0
    keep = tot_buckets = 0
    if variant == "pruned":
        from t1k_tpu.ops.phase_a import DeviceCandidates

        dev = DeviceCandidates.build(packed, engine.kmer_length,
                                     engine.hit_len_required)
        L = int(lens.max())
        padded = np.full((len(uniq), L), 4, np.int8)
        for i in range(len(uniq)):
            padded[i, :lens[i]] = codes[starts[i]:starts[i] + lens[i]]
        t0 = time.perf_counter()
        c_reads, c_seqs, c_strands, undecided = dev.generate(padded, lens)
        gen_s = time.perf_counter() - t0
        keep = int(len(c_reads))
        engine.set_candidates(len(uniq), c_reads, c_seqs, c_strands,
                              undecided)

    t0 = time.perf_counter()
    engine.assign_batch(codes, starts, lens, w, store_results=False)
    assign_s = time.perf_counter() - t0
    print(json.dumps({
        "variant": variant, "n_uniq_reads": len(uniq),
        "assign_s": round(assign_s, 3),
        "device_gen_s": round(gen_s, 3),
        "keep_buckets": keep,
        "undecided_reads": int(undecided.sum()) if variant == "pruned" else 0,
    }))


def run_analysis():
    """Host-only crossover analysis via the engine's overlap-bucket
    oracle: exact keep-set size + the host cost pruning competes with."""
    uniq, codes, starts, lens = load_unique_reads()
    engine, packed = build_engine()
    t0 = time.perf_counter()
    off, _, _ = engine.overlap_buckets(codes, starts, lens)
    host_s = time.perf_counter() - t0
    n_keep = int(off[-1])
    traffic_mb = n_keep * 8 / 1e6
    print(json.dumps({
        "metric": "phase_a_lite_crossover",
        "n_uniq_reads": len(uniq), "panel_seqs": int(packed.n),
        "keep_buckets": n_keep,
        "keep_per_read": round(n_keep / len(uniq), 1),
        "keep_set_mb": round(traffic_mb, 1),
        "host_hits_chain_overlap_s": round(host_s, 2),
        "transfer_s_at_1GBps": round(traffic_mb / 1000, 2),
    }))


def main():
    if len(sys.argv) > 1:
        if sys.argv[1] == "analysis":
            subprocess.run([sys.executable,
                            os.path.join(ROOT, "benchmarks",
                                         "hla_scale.py"), "none"],
                           check=True, capture_output=True)
            return run_analysis()
        return run_variant(sys.argv[1])

    subprocess.run([sys.executable,
                    os.path.join(ROOT, "benchmarks", "hla_scale.py"),
                    "none"], check=True, capture_output=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["T1K_ENGINE_PROFILE"] = "1"
    res = {}
    for variant in ("native", "pruned"):
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), variant],
            capture_output=True, text=True, env=env, timeout=3600)
        assert p.returncode == 0, p.stderr[-2000:]
        res[variant] = json.loads(
            [l for l in p.stdout.splitlines() if l.startswith("{")][-1])
        res[variant]["profile"] = parse_profile(p.stderr)

    n = res["pruned"]["keep_buckets"]
    traffic_mb = n * 8 / 1e6  # (read id, seq, strand) packed 8B/bucket
    pn, pp = res["native"]["profile"], res["pruned"]["profile"]
    host_saved = (pn.get("hits", 0) - pp.get("hits", 0)
                  + pn.get("chain", 0) - pp.get("chain", 0)
                  + pn.get("sort", 0) - pp.get("sort", 0))
    dev_s = res["pruned"]["device_gen_s"]
    # crossover: device wins when gen + traffic/bw < host_saved
    bw = (traffic_mb / (host_saved - dev_s)
          if host_saved > dev_s else float("inf"))
    print(json.dumps({
        "metric": "phase_a_lite_crossover",
        "native": res["native"], "pruned": res["pruned"],
        "host_seconds_saved": round(host_saved, 3),
        "keep_set_mb": round(traffic_mb, 1),
        "breakeven_link_mb_per_s": (round(bw, 1)
                                    if bw != float("inf") else "never"),
    }))


if __name__ == "__main__":
    main()
