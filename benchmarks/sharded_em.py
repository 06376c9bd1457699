"""Production sharded SQUAREM throughput on a real device mesh.

Measures `parallel/mesh.py em_quantify_sharded_squarem` — the FULL
multi-device quantification loop (3 EM updates + SQUAREM extrapolation
per round, 1e-5 convergence with the forced extra round, the
every-10-rounds abundance mask, and ONE psum of per-EC counts per EM
update) — in BOTH dispatch modes on a 1-device mesh of the attached
device:

  single  the whole convergence loop as ONE jitted shard_mapped
          lax.while_loop with the psum inside (what real device meshes
          run; reference anchor: the EM iterates to convergence as one
          loop, Genotyper.hpp:1234-1290)
  hostloop  one jitted round per host dispatch (the virtual-CPU dryrun
          workaround), which pays a dispatch per round

Prints one JSON line per mode:
  {"metric": "sharded_em_convergence_wall_s", "dispatch": ...,
   "rounds_to_convergence": N, "value": seconds,
   "rounds_per_s_incl_dispatch": R}
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def make_problem(seed=7, n_alleles=4096, n_genes=24, n_majors=512,
                 ec_cnt=2048, rg_cnt=30000, fanout=6):
    rng = np.random.default_rng(seed)
    ec_to_alleles = [[] for _ in range(ec_cnt)]
    for a in range(n_alleles):
        ec_to_alleles[a % ec_cnt].append(a)
    seg_rg = np.repeat(np.arange(rg_cnt, dtype=np.int32), fanout)
    seg_ec = rng.integers(0, ec_cnt, rg_cnt * fanout).astype(np.int32)
    counts = rng.choice([1.0, 0.5, 2.0], rg_cnt)
    tables = dict(
        allele_eff_len=rng.integers(900, 1400, n_alleles).astype(np.int32),
        allele_weight=rng.integers(1, 4, n_alleles).astype(np.int32),
        allele_gene=(np.arange(n_alleles) % n_genes).astype(np.int32),
        allele_major=(np.arange(n_alleles) % n_majors).astype(np.int32),
        gene_cnt=n_genes,
        major_cnt=n_majors,
    )
    return seg_rg, seg_ec, counts, rg_cnt, ec_to_alleles, tables


def main():
    import jax

    from t1k_tpu.parallel.mesh import data_mesh, em_quantify_sharded_squarem

    mesh = data_mesh(1)
    seg_rg, seg_ec, counts, rg_cnt, ec_to_alleles, tables = make_problem()

    for mode, single in (("single", True), ("hostloop", False)):
        # warmup compiles; each timed rep perturbs the counts
        em_quantify_sharded_squarem(
            mesh, seg_rg, seg_ec, counts, rg_cnt, ec_to_alleles,
            **tables, single_dispatch=single)

        def run(c, cap):
            t0 = time.perf_counter()
            iters, _ = em_quantify_sharded_squarem(
                mesh, seg_rg, seg_ec, c, rg_cnt, ec_to_alleles,
                **tables, max_iterations=cap, single_dispatch=single)
            return iters, time.perf_counter() - t0

        # full-convergence wall (the production call), median of 3
        times, iters = [], 0
        for rep in range(3):
            it, dt = run(counts * (1.0 + 1e-3 * (rep + 1)), 1000)
            iters = it
            times.append(dt)
        times.sort()
        med = times[len(times) // 2]
        print(json.dumps({
            "metric": "sharded_em_convergence_wall_s",
            "dispatch": mode,
            "mesh_devices": 1,
            "ec_cnt": len(ec_to_alleles), "rg_cnt": rg_cnt,
            "rounds_to_convergence": int(iters),
            "value": round(med, 4),
            "rounds_per_s_incl_dispatch": round(iters / med, 1),
            "unit": "s to full SQUAREM convergence (dense per-shard "
                    "E-step, one dispatch for mode=single)",
        }))


if __name__ == "__main__":
    main()
