"""Scaling measurement of the sharded production step over a device mesh.

Two workloads at mesh sizes 1..N:
  * the full composite step (band-packed v2 stats kernel + bucket
    weights + psum-EM round — the __graft_entry__ production step) at
    CONSTANT PER-DEVICE load (weak scaling: ideal efficiency keeps the
    step time flat as devices and total work grow together), and
  * the psum-merged sharded EM step at fixed total load (strong
    scaling).

On this development rig the mesh is virtual (N CPU "devices"
multiplexed over the same physical cores), so the numbers validate the
collective mechanics and measure the sharding overhead rather than
speed — weak-scaling times grow with total work because every virtual
device shares one socket.  On a multi-GPU host (T1K_SCALING_REAL=1) the same
code spans real chips over ICI and the per-device work is genuinely
parallel.

  python -m t1k_tpu.parallel.scaling_bench
"""

from __future__ import annotations

import json
import os
import sys
import time


def bench_full_step(sizes) -> dict:
    """Weak-scaling of the composite alignment+EM step (per-device load
    constant)."""
    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    import __graft_entry__ as ge

    results = {}
    base = None
    for n in sizes:
        if n > len(jax.devices()):
            break
        t0 = time.perf_counter()
        ge.dryrun_multichip(n)  # compile + run (fresh shapes per n)
        t_first = time.perf_counter() - t0
        # timed reruns reuse the compiled executable
        t0 = time.perf_counter()
        for _ in range(3):
            ge.dryrun_multichip(n)
        dt = (time.perf_counter() - t0) / 3
        if base is None:
            base = dt
        results[n] = {
            "s_per_step": round(dt, 3),
            "compile_s": round(t_first - dt, 3),
            "weak_efficiency": round(base / dt, 3),
        }
        print(f"full step devices={n}: {dt:.3f} s/step  "
              f"weak-eff={base/dt:.2f}", file=sys.stderr)
    return results


def main() -> int:
    # default: a virtual 8-device CPU mesh (set T1K_SCALING_REAL=1 to use
    # the real device set, e.g. on a multi-GPU host)
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    if not os.environ.get("T1K_SCALING_REAL"):
        os.environ.setdefault("JAX_PLATFORMS", "cpu")  # also: no cache
    import jax

    if not os.environ.get("T1K_SCALING_REAL"):
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
    import numpy as np

    from .mesh import data_mesh, em_quantify_sharded

    rng = np.random.default_rng(11)
    ec_cnt, rg_cnt = 4096, 200000
    nnz = rg_cnt * 8
    seg_rg = np.sort(rng.integers(0, rg_cnt, nnz)).astype(np.int32)
    seg_ec = rng.integers(0, ec_cnt, nnz).astype(np.int32)
    counts = np.ones(nnz, np.float64)
    ec_len = rng.integers(800, 20000, ec_cnt).astype(np.float64)
    init = np.ones(ec_cnt, np.float64)

    results = {}
    base = None
    for n in (1, 2, 4, 8):
        if n > len(jax.devices()):
            break
        mesh = data_mesh(n)
        em_quantify_sharded(mesh, seg_rg, seg_ec, counts, rg_cnt, ec_len,
                            init, iterations=2)  # warm
        t0 = time.perf_counter()
        em_quantify_sharded(mesh, seg_rg, seg_ec, counts, rg_cnt, ec_len,
                            init, iterations=20)
        dt = (time.perf_counter() - t0) / 20
        if base is None:
            base = dt
        results[n] = {
            "ms_per_iteration": round(dt * 1e3, 3),
            "speedup": round(base / dt, 3),
            "efficiency": round(base / dt / n, 3),
        }
        print(f"devices={n}: {dt*1e3:.2f} ms/iter  "
              f"speedup={base/dt:.2f}  eff={base/dt/n:.2f}", file=sys.stderr)
    step_results = bench_full_step((1, 2, 4, 8))
    print(json.dumps({"metric": "sharded_em_scaling", "results": results,
                      "full_step_weak_scaling": step_results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
