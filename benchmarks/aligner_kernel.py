"""Band-DP throughput on the GPU (microbenchmark of ops/align.py).

Times the program the deferred-DP service runs (`_desc_stats_call`): one
fixed slice of 131,072 items gathered from device-resident sequences at
each length bucket (Lb = 96 and 256), at the service's window class
(ML = 15, W = 32).  Items are random pairs with |Δlen| <= 10, the
engine's deferral limit.  Reports compile seconds, the median device
time per slice (host clock around work that ends in block_until_ready),
items/s and window-cell updates/s, and the share of the card's int32
peak that the DP's vector work reaches.  The native engine's single-thread DP rate on the same item
shapes is the baseline.

Prints ONE JSON line; fails on a host without a GPU or on a GPU that is
not in PEAKS.

  python benchmarks/aligner_kernel.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# Published peaks per device kind.  NVIDIA H100 SXM data sheet: 80 GB
# HBM3 at 3.35 TB/s; int32 rate from the Hopper architecture white
# paper: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost clock.  A
# device missing from the table is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "int32_ops_per_s": 64 * 132 * 1.98e9},
}

# Hand count of int32 vector operations per window slot per DP row in
# ops/align.py _band_loop (scores: substitution 4, e/h/u/f 14, masks
# and selects 8; counts: 22; final-slot picks 4).
OPS_PER_CELL = 52


def peaks_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add them to PEAKS with a source")
    return PEAKS[device_kind]


def random_items(rng, n, lb, ref_len, reads_len):
    """Descriptor columns for n random items with max length <= lb."""
    p_len = rng.integers(max(1, lb // 3), lb - 10, n).astype(np.int32)
    t_len = np.clip(p_len + rng.integers(-10, 11, n), 1, lb).astype(np.int32)
    t_off = rng.integers(0, ref_len - lb, n).astype(np.int32)
    p_off = rng.integers(0, reads_len - lb, n).astype(np.int32)
    return t_off, t_len, p_off, p_len


def time_desc_slices(buckets=(96, 256), reps=5, seed=3):
    """Per bucket: compile seconds, median device seconds per slice, the
    slice's items and its memory analysis, for the deferred service's
    DP program."""
    import jax
    import jax.numpy as jnp

    from t1k_tpu.ops.align import (_DESC_ML, _DESC_SLICE, _DESC_W,
                                   _desc_stats_call)

    rng = np.random.default_rng(seed)
    ref = jnp.asarray(rng.integers(0, 5, 1 << 23).astype(np.int8))
    reads = jnp.asarray(rng.integers(0, 5, 1 << 23).astype(np.int8))
    out = {}
    for lb in buckets:
        cols = [jnp.asarray(c) for c in random_items(
            rng, _DESC_SLICE, lb, ref.shape[0], reads.shape[0])]
        t0 = time.perf_counter()
        fn = _desc_stats_call.lower(ref, reads, *cols, Lb=lb, ML=_DESC_ML,
                                    W=_DESC_W).compile()
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(fn(ref, reads, *cols))
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(ref, reads, *cols))
            times.append(time.perf_counter() - t0)
        out[lb] = {"compile_s": compile_s,
                   "slice_s": sorted(times)[len(times) // 2],
                   "items": _DESC_SLICE, "rows": lb,
                   "memory": fn.memory_analysis()}
    return out


def native_items_per_s(lb, n=4000, seed=4):
    from t1k_tpu.native import align_stats

    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 5, 1 << 16).astype(np.int8)
    t_off, t_len, p_off, p_len = random_items(rng, n, lb, len(ref), len(ref))
    t0 = time.perf_counter()
    for i in range(n):
        align_stats(ref[t_off[i]:t_off[i] + t_len[i]],
                    ref[p_off[i]:p_off[i] + p_len[i]])
    return n / (time.perf_counter() - t0)


def main():
    import jax

    from t1k_tpu.ops.align import _DESC_W

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX runs on {dev.platform}")
    peak = peaks_for(dev.device_kind)
    result = {}
    for lb, r in time_desc_slices().items():
        cells = r["items"] * r["rows"] * _DESC_W
        result[f"Lb{lb}"] = {
            "compile_s": r["compile_s"],
            "slice_s": r["slice_s"],
            "items_per_s": r["items"] / r["slice_s"],
            "window_cells_per_s": cells / r["slice_s"],
            "int32_peak_share": (cells * OPS_PER_CELL / r["slice_s"]
                                 / peak["int32_ops_per_s"]),
            "native_items_per_s_1core": native_items_per_s(lb),
        }
    print(json.dumps({"metric": "band_dp_slice_seconds",
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())},
                      "buckets": result}))


if __name__ == "__main__":
    main()
