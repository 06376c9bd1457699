"""Device k-mer classification throughput (north-star hot loop 1:
candidate screening).  Reads/s/device for the device prefilter
(ops/kmer.py) vs the native exact screen, single thread, on the
cyp2d6 RNA panel with 95% off-target background (the extractor's
real regime).

RTT-robust methodology (see bench.py): R batches chained in one jit
with a data dependency; every timed rep uses distinct inputs.

Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

CYP = os.environ.get(
    "T1K_CYP2D6_IDX", "/root/reference/vcf_database/cyp2d6_idx"
) + "/cyp2d6_rna_seq.fa"


def make_reads(B, L=100, on_target_frac=0.05, seed=3):
    from t1k_tpu.io.reads import read_seq_file

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    alleles = [r.seq for r in read_seq_file(CYP)][:50]
    n_on = int(B * on_target_frac)
    enc = {"A": 0, "C": 1, "G": 2, "T": 3}
    for i in range(n_on):
        a = alleles[int(rng.integers(0, len(alleles)))]
        p = int(rng.integers(0, len(a) - L))
        codes[i] = np.array([enc.get(c, 0) for c in a[p:p + L]], np.int8)
    lens = np.full(B, L, np.int32)
    return codes, lens


def bench_device(B=32768, R=8, n_reps=5):
    # R and B bounded: one device execution must stay well under the
    # remote runtime's watchdog (the probe loop is gather-bound)
    import functools

    import jax
    import jax.numpy as jnp

    from t1k_tpu.io.refset import RefSet
    from t1k_tpu.io.reads import read_seq_file
    from t1k_tpu.ops.kmer import DeviceKmerTable, _classify, _classify_direct

    refset = RefSet(digit_units=-1)
    for rec in read_seq_file(CYP):
        refset.add_allele(rec.id, rec.seq, rec.comment)
    packed = refset.packed()
    table = DeviceKmerTable.build(packed, 9)

    codes, lens = make_reads(B)
    codes_d = jnp.asarray(codes)
    lens_d = jnp.asarray(lens)
    tbl = jnp.asarray(table.table)

    @functools.partial(jax.jit, static_argnames=("reps",))
    def chained(c0, reps):
        def body(i, carry):
            acc, c = carry
            if table.direct:
                fwd, rc = _classify_direct(c, lens_d, tbl, table.k)
            else:
                fwd, rc = _classify(c, lens_d, tbl, table.k, table.size)
            matches = fwd + rc
            # data dependency between batches: mutate one base per read
            # from this batch's match counts
            d = (matches % 3 + 1).astype(jnp.int8)
            c = c.at[:, 0].set((c[:, 0] + d) % 4)
            return acc + matches.sum(), c
        acc, _ = jax.lax.fori_loop(0, reps, body, (jnp.int32(0), c0))
        return acc

    jax.block_until_ready(chained(codes_d, R))
    variants = [jnp.asarray((codes + s + 1) % 4) for s in range(n_reps)]
    jax.block_until_ready(variants)
    times = []
    for c in variants:
        t0 = time.perf_counter()
        int(chained(c, R))
        times.append(time.perf_counter() - t0)
    times.sort()
    return B * R / times[len(times) // 2]


def bench_native(n=20000):
    from t1k_tpu.constants import EXTRACTOR_KMER_LENGTH
    from t1k_tpu.io.refset import RefSet
    from t1k_tpu.io.reads import read_seq_file
    from t1k_tpu.native import NativeEngine

    refset = RefSet(digit_units=-1)
    for rec in read_seq_file(CYP):
        refset.add_allele(rec.id, rec.seq, rec.comment)
    packed = refset.packed()
    eng = NativeEngine(packed, kmer_length=EXTRACTOR_KMER_LENGTH,
                       hit_len_required=23)
    codes, lens = make_reads(n, seed=4)
    starts = (np.arange(n, dtype=np.int64) * codes.shape[1])
    t0 = time.perf_counter()
    eng.screen_batch(codes.reshape(-1), starts, lens)
    return n / (time.perf_counter() - t0)


def main():
    dev = bench_device()
    nat = bench_native()
    print(json.dumps({
        "metric": "kmer_screen_reads_per_s_per_device",
        "value": round(dev),
        "unit": "reads/s",
        "vs_native_single_thread": round(dev / nat, 2),
    }))


if __name__ == "__main__":
    main()
