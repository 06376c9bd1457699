"""Deferred-DP host-half decomposition at HLA scale (VERDICT r4 #1).

Runs the HLA-scale read-assignment stage three ways on one thread:

  inline    engine.assign_batch (the production native path)
  deferred  engine.assign_batch_deferred with the NATIVE stats oracle as
            the scorer, timed inside the stats_fn — so
            host_half = wall - scoring, independent of any device
  deferred+profile  same, with T1K_ENGINE_PROFILE phase counters

and byte-compares the assignment records.  This isolates the question
the offload hinges on: how much host bookkeeping does the deferral
machinery add over the inline path's non-DP work?

Prints JSON lines:
  {"metric": "defer_host_half_s", "inline_s": ..., "deferred_wall_s": ...,
   "scoring_s": ..., "host_half_s": ..., "n_items": ...}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    # ensure the HLA-scale inputs exist
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.exists("/tmp/hlabench/panel.fa"):
        subprocess.run([sys.executable,
                        os.path.join(root, "benchmarks", "hla_scale.py"),
                        "none"], check=True)

    from t1k_tpu.constants import GENOTYPER_KMER_LENGTH, encode_seq
    from t1k_tpu.io.reads import read_seq_file
    from t1k_tpu.io.refset import RefSet
    from t1k_tpu.native import NativeEngine, align_stats_batch

    refset = RefSet.from_fasta("/tmp/hlabench/panel.fa", -1, "")
    packed = refset.packed()

    seqs = ([r.seq for r in read_seq_file("/tmp/hlabench/r_1.fq")]
            + [r.seq for r in read_seq_file("/tmp/hlabench/r_2.fq")])
    # unique-read dedupe exactly as the pipeline does
    order = sorted(range(len(seqs)), key=lambda i: seqs[i])
    uniq, weights = [], []
    i = 0
    while i < len(order):
        j = i + 1
        while j < len(order) and seqs[order[j]] == seqs[order[i]]:
            j += 1
        uniq.append(seqs[order[i]])
        weights.append(j - i)
        i = j
    codes = np.concatenate([encode_seq(s) for s in uniq])
    lens = np.array([len(s) for s in uniq], np.int32)
    starts = np.zeros(len(lens), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    w = np.array(weights, np.int32)

    def fresh_engine():
        return NativeEngine(packed, GENOTYPER_KMER_LENGTH,
                            ref_seq_similarity=0.8, threads=1)

    # --- inline
    eng = fresh_engine()
    t0 = time.perf_counter()
    rec_i, off_i = eng.assign_batch(codes, starts, lens, w)
    t_inline = time.perf_counter() - t0

    # --- deferred, native oracle scorer (timed separately)
    scoring = [0.0]
    n_items = [0]

    def stats_fn(tc, tl, pc, pl):
        t0 = time.perf_counter()
        out = align_stats_batch(tc, tl, pc, pl)
        scoring[0] += time.perf_counter() - t0
        n_items[0] += len(tl)
        return out

    eng2 = fresh_engine()
    t0 = time.perf_counter()
    rec_d, off_d = eng2.assign_batch_deferred(codes, starts, lens, w,
                                              stats_fn=stats_fn)
    t_defer = time.perf_counter() - t0

    assert np.array_equal(off_i, off_d)
    assert np.array_equal(rec_i, rec_d), "deferred records differ from inline"

    print(json.dumps({
        "metric": "defer_host_half_s",
        "mode": "unchunked",
        "n_unique_reads": len(uniq),
        "n_items": n_items[0],
        "inline_s": round(t_inline, 2),
        "deferred_wall_s": round(t_defer, 2),
        "scoring_s": round(scoring[0], 2),
        "host_half_s": round(t_defer - scoring[0], 2),
        "host_vs_inline": round((t_defer - scoring[0]) / t_inline, 3),
    }))

    # --- production config: engine-side accumulation + chunked
    # deferral (what the pipeline runs with --backend device), swept over
    # chunk sizes: small chunks keep the per-chunk SoA arenas
    # cache-resident for the finish pass
    eng3 = fresh_engine()
    t0 = time.perf_counter()
    eng3.assign_batch(codes, starts, lens, w, store_results=False)
    t_inline_ns = time.perf_counter() - t0
    print(json.dumps({"metric": "inline_no_store_s",
                      "value": round(t_inline_ns, 2)}))

    for chunk in (8192, 2048, 512, 128):
        scoring[0] = 0.0
        n_items[0] = 0
        enge = fresh_engine()
        t0 = time.perf_counter()
        enge.assign_batch_deferred(codes, starts, lens, w,
                                   stats_fn=stats_fn, store_results=False,
                                   chunk_size=chunk)
        t_defer = time.perf_counter() - t0
        print(json.dumps({
            "metric": "defer_host_half_s",
            "mode": f"chunk_{chunk}",
            "n_items": n_items[0],
            "deferred_wall_s": round(t_defer, 2),
            "scoring_s": round(scoring[0], 2),
            "host_half_s": round(t_defer - scoring[0], 2),
            "host_vs_inline": round((t_defer - scoring[0]) / t_inline_ns, 3),
        }))


if __name__ == "__main__":
    main()
