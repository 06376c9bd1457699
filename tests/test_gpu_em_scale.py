"""Scale-exactness evidence for the device EM route (VERDICT r3 #3).

At the >= 5e7-dense-cell size where `auto` routes the EM to the device,
the REAL f32 device trajectory polished by the native f64 SQUAREM must
land on the native route's fixed point to below output rounding.  Runs
on a GPU only (T1K_REAL_DEVICE=1); the CPU-side polish contract is
pinned in tests/test_routing.py.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _big_problem(rg_cnt=100_000, ec_cnt=600, seed=7):
    rng = np.random.default_rng(seed)
    n_alleles, n_genes, n_majors = ec_cnt * 2, 8, ec_cnt
    ec_to_alleles = [[2 * i, 2 * i + 1] for i in range(ec_cnt)]
    offs = [0]
    ecs = []
    for _ in range(rg_cnt):
        k = rng.integers(1, 5)
        ecs.extend(rng.choice(ec_cnt, size=k, replace=False).tolist())
        offs.append(len(ecs))
    return dict(
        ec_to_alleles=ec_to_alleles,
        rg_ecs_csr=(np.array(offs, np.int64), np.array(ecs, np.int32)),
        rg_counts=rng.choice([1.0, 0.5, 2.0], rg_cnt),
        allele_eff_len=rng.integers(900, 1400, n_alleles).astype(np.int32),
        allele_missing=np.zeros(n_alleles, np.int32),
        allele_weight=rng.integers(1, 4, n_alleles).astype(np.int32),
        allele_gene=(np.arange(n_alleles) % n_genes).astype(np.int32),
        allele_major=(np.arange(n_alleles) // 2).astype(np.int32),
        n_genes=n_genes,
        n_majors=n_majors,
    )


def test_device_em_route_matches_native_at_gate_scale(gpu, monkeypatch):
    from t1k_tpu.core.genotyper import Genotyper
    from t1k_tpu.native import em_quantify
    from t1k_tpu.ops.em import em_quantify_jax

    args = _big_problem()
    rg_cnt = len(args["rg_counts"])
    ec_cnt = len(args["ec_to_alleles"])
    assert rg_cnt * ec_cnt >= 5e7  # past the auto gate

    # the resolver must pick the device at this size with a card present
    for var in ("T1K_EM_BACKEND", "T1K_BACKEND", "T1K_DEVICE_PRESENT"):
        monkeypatch.delenv(var, raising=False)
    assert Genotyper._resolve_em_backend(rg_cnt, ec_cnt) == "jax"

    it_native, count_native = em_quantify(**args)

    # the REAL on-card trajectory (f32: 64-bit mode is off)
    it_dev, count_dev = em_quantify_jax(**args)
    ec_len = np.array(
        [min(int(args["allele_eff_len"][a]) for a in alleles)
         for alleles in args["ec_to_alleles"]], dtype=np.float64)
    per_len = count_dev / ec_len
    it_pol, polished = em_quantify(init_x=per_len / per_len.sum(), **args)

    # polished device route lands on the native fixed point far below
    # the 0.01 abundance rounding of the output writer
    np.testing.assert_allclose(polished, count_native, rtol=1e-3, atol=5e-2)
    abund_dev = np.round(polished / ec_len * 1000.0, 2)
    abund_nat = np.round(count_native / ec_len * 1000.0, 2)
    n_diff = int((abund_dev != abund_nat).sum())
    assert n_diff == 0, (
        f"{n_diff}/{ec_cnt} rounded EC abundances differ between the "
        f"polished device route and the native route")
    print(f"\ndevice {it_dev} iters (f32 on the card) + {it_pol} polish "
          f"iters vs native {it_native} iters: rounded abundances equal")
