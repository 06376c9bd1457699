"""Device EM iteration throughput at HLA/KIR scale (north-star metric:
"EM iters/s on the read-group x EC matrix", BASELINE.md).

Shapes model a real HLA RNA run: thousands of equivalence classes,
hundreds of thousands of read groups, ~8 EC incidences per read group
(the reference's EMupdate walks the same adjacency serially,
Genotyper.hpp:372-421).  One "iteration" is a full SQUAREM round =
3 EM updates + extrapolation, as in QuantifyAlleleEquivalentClass
(Genotyper.hpp:1234-1290).

RTT-robust methodology (see bench.py): R rounds are chained inside one
jitted while-loop (the production _em_loop already is), timed around a
single host round-trip.

Prints one JSON line per configuration:
  {"metric": "em_squarem_rounds_per_s", "ec_cnt": ..., "rg_cnt": ...,
   "value": ..., "vs_native_single_thread": ...}
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def make_problem(ec_cnt, rg_cnt, fanout, seed=3):
    rng = np.random.default_rng(seed)
    nnz = rg_cnt * fanout
    seg_rg = np.repeat(np.arange(rg_cnt, dtype=np.int32), fanout)
    seg_ec = rng.integers(0, ec_cnt, nnz).astype(np.int32)
    # fragment counts are per read GROUP (Genotyper.hpp readGroupCount)
    counts = np.repeat(rng.integers(1, 20, rg_cnt), fanout).astype(np.float64)
    ec_len = rng.integers(800, 3500, ec_cnt).astype(np.float64)
    init = rng.random(ec_cnt) + 0.1
    return seg_rg, seg_ec, counts, ec_len, init


def bench_device(seg_rg, seg_ec, counts, ec_len, init, rounds=20,
                 n_reps=5):
    # rounds is kept small so one timed execution stays short
    import functools

    import jax
    import jax.numpy as jnp

    from t1k_tpu.ops.em import segment_bounds, sorted_segment_sum

    rg_cnt = int(seg_rg[-1]) + 1
    ec_cnt = len(ec_len)
    dtype = jnp.float32
    perm = np.argsort(seg_ec, kind="stable").astype(np.int32)
    rg_s, rg_e = segment_bounds(seg_rg, rg_cnt)
    ec_s, ec_e = segment_bounds(seg_ec[perm], ec_cnt)
    sec_sorted_h = seg_ec[perm]
    srg_eco_h = seg_rg[perm]
    cts_eco_h = counts[perm]

    # incidence arrays are jit ARGUMENTS, not closed-over constants,
    # which would be baked into the compiled program
    @functools.partial(jax.jit, static_argnames=("R",))
    def run(x0, sec, secs, srgo, ctso, rgs, rge, ecs, ece, R):
        elen = jnp.asarray(ec_len, dtype)

        def em_update(x):
            psum = sorted_segment_sum(x[sec], rgs, rge)
            psum = jnp.where(psum == 0, 1, psum)
            contrib = ctso * x[secs] / psum[srgo]
            count = sorted_segment_sum(contrib, ecs, ece)
            per_len = count / elen
            return per_len / per_len.sum()

        def body(i, x0):
            x1 = em_update(x0)
            x2 = em_update(x1)
            r = x1 - x0
            v = x2 - 2 * x1 + x0
            sum_r = (r * r).sum()
            sum_v = (v * v).sum()
            alpha = jnp.where(sum_v == 0, -1.0,
                              -jnp.sqrt(sum_r) / jnp.sqrt(sum_v))
            x3 = x0 - 2 * alpha * r + alpha * alpha * v
            return em_update(x3)

        x = jax.lax.fori_loop(0, R, body, x0.astype(dtype))
        return x, x.sum()

    # every timed rep gets a DISTINCT input and fetches a scalar to the
    # host, so the timing ends with the device work it measures
    x0 = jnp.asarray(init / init.sum(), dtype)
    inc = (jnp.asarray(seg_ec), jnp.asarray(sec_sorted_h),
           jnp.asarray(srg_eco_h), jnp.asarray(cts_eco_h, dtype),
           jnp.asarray(rg_s), jnp.asarray(rg_e), jnp.asarray(ec_s),
           jnp.asarray(ec_e))
    jax.block_until_ready(run(x0, *inc, rounds))
    times = []
    for rep in range(n_reps):
        xr = x0 * (1.0 + 1e-3 * (rep + 1))
        xr = xr / xr.sum()
        jax.block_until_ready(xr)
        t0 = time.perf_counter()
        _, s = run(xr, *inc, rounds)
        float(s)
        times.append(time.perf_counter() - t0)
    times.sort()
    return rounds / times[len(times) // 2]


def bench_device_dense(seg_rg, seg_ec, counts, ec_len, init, rounds=200,
                       n_reps=5):
    """Dense-incidence formulation (ops/em.py fast path): the E-step is
    two dense matvecs — no gathers or scatters."""
    import functools

    import jax
    import jax.numpy as jnp

    rg_cnt = int(seg_rg[-1]) + 1
    ec_cnt = len(ec_len)
    dtype = jnp.float32
    from t1k_tpu.ops.em import _build_incidence, _mv, _vm
    # built on device (int8: the matvecs are HBM-bound streaming of A,
    # so byte-wide storage is a 4x bandwidth win — ops/em.py); only the
    # nnz index lists cross the host link
    A = _build_incidence(jnp.asarray(seg_rg), jnp.asarray(seg_ec),
                         rg_cnt, ec_cnt)
    cts_rg = np.zeros(rg_cnt, np.float32)
    np.maximum.at(cts_rg, seg_rg, counts.astype(np.float32))

    # A is a jit ARGUMENT (device-resident), not a closed-over constant,
    # which would bake hundreds of MB into the compiled program
    @functools.partial(jax.jit, static_argnames=("R",))
    def run(x0, Ad, cts, R):
        elen = jnp.asarray(ec_len, dtype)

        def em_update(x):
            psum = _mv(Ad, x, dtype)
            psum = jnp.where(psum == 0, 1, psum)
            count = x * _vm(cts / psum, Ad, dtype)
            per_len = count / elen
            return per_len / per_len.sum()

        def body(i, x0):
            x1 = em_update(x0)
            x2 = em_update(x1)
            r = x1 - x0
            v = x2 - 2 * x1 + x0
            sum_r = (r * r).sum()
            sum_v = (v * v).sum()
            alpha = jnp.where(sum_v == 0, -1.0,
                              -jnp.sqrt(sum_r) / jnp.sqrt(sum_v))
            x3 = x0 - 2 * alpha * r + alpha * alpha * v
            return em_update(x3)

        x = jax.lax.fori_loop(0, R, body, x0.astype(dtype))
        return x, x.sum()

    x0 = jnp.asarray(init / init.sum(), dtype)
    Ad = jnp.asarray(A)
    cts = jnp.asarray(cts_rg)
    jax.block_until_ready(run(x0, Ad, cts, rounds))
    times = []
    for rep in range(n_reps):
        xr = x0 * (1.0 + 1e-3 * (rep + 1))
        xr = xr / xr.sum()
        jax.block_until_ready(xr)
        t0 = time.perf_counter()
        _, s = run(xr, Ad, cts, rounds)
        float(s)
        times.append(time.perf_counter() - t0)
    times.sort()
    return rounds / times[len(times) // 2]


def bench_native(seg_rg, seg_ec, counts, ec_len, init, rounds=50):
    """Reference-algorithm oracle on one CPU thread (native/em.cc runs
    the same serial adjacency walk the reference does)."""
    rg_cnt = int(seg_rg[-1]) + 1
    ec_cnt = len(ec_len)
    x0 = init / init.sum()

    def em_update(x):
        vals = x[seg_ec]
        psum = np.zeros(rg_cnt)
        np.add.at(psum, seg_rg, vals)
        psum[psum == 0] = 1
        contrib = counts * vals / psum[seg_rg]
        count = np.zeros(ec_cnt)
        np.add.at(count, seg_ec, contrib)
        per_len = count / ec_len
        return per_len / per_len.sum()

    t0 = time.perf_counter()
    x = x0
    for _ in range(rounds):
        x1 = em_update(x)
        x2 = em_update(x1)
        r, v = x1 - x, x2 - 2 * x1 + x
        sv = float((v * v).sum())
        alpha = -1.0 if sv == 0 else -np.sqrt((r * r).sum()) / np.sqrt(sv)
        x = em_update(x - 2 * alpha * r + alpha * alpha * v)
    return rounds / (time.perf_counter() - t0)


def main():
    # (ec, rg) shapes: the HLA-scale run's actual EM (880 ECs, 4897
    # read groups), a large single-sample, and a very large problem
    # (819M elems, 3.3GB f32) measured on BOTH formulations: dense is
    # the production path there (fits DENSE_EM_MAX_BYTES, built on
    # device), segment is the beyond-budget fallback
    for ec_cnt, rg_cnt, fanout, dense in (
            (880, 4897, 4, True), (2048, 30000, 6, True),
            (4096, 200000, 8, True), (4096, 200000, 8, False)):
        prob = make_problem(ec_cnt, rg_cnt, fanout)
        dev = (bench_device_dense if dense else bench_device)(*prob)
        nat = bench_native(*prob)
        print(json.dumps({
            "metric": "em_squarem_rounds_per_s",
            "path": "dense" if dense else "segment",
            "ec_cnt": ec_cnt, "rg_cnt": rg_cnt, "nnz": rg_cnt * fanout,
            "value": round(dev, 1),
            "vs_host_single_thread": round(dev / nat, 2),
        }))


if __name__ == "__main__":
    main()
