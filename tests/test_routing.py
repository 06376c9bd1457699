"""Backend-routing contracts (core/pipeline.py, core/genotyper.py).

The bulk-compute stages (EM at scale, extraction screen, cohort EM)
route on GPU *presence*; only the latency-sensitive deferred-DP offload
adds the round-trip gate.  A forced device route with no GPU fails
instead of running elsewhere, unless JAX_PLATFORMS pins the CPU.
"""

import os

import numpy as np
import pytest


def _clear_routing_env(monkeypatch):
    for var in ("T1K_BACKEND", "T1K_DEVICE_PRESENT", "T1K_EM_BACKEND"):
        monkeypatch.delenv(var, raising=False)


def test_tpu_present_env_contract(monkeypatch):
    from t1k_tpu.core.pipeline import device_present

    _clear_routing_env(monkeypatch)
    # pinned verdicts are honored without asking JAX
    monkeypatch.setenv("T1K_DEVICE_PRESENT", "1")
    assert device_present() is True
    monkeypatch.setenv("T1K_DEVICE_PRESENT", "0")
    assert device_present() is False
    # user override beats the pin ("tpu" is the old spelling of "device")
    monkeypatch.setenv("T1K_BACKEND", "native")
    monkeypatch.setenv("T1K_DEVICE_PRESENT", "1")
    assert device_present() is False
    for forced in ("device", "tpu"):
        monkeypatch.setenv("T1K_BACKEND", forced)
        monkeypatch.setenv("T1K_DEVICE_PRESENT", "0")
        assert device_present() is True
    # a cpu platform pin (this test process) resolves False
    monkeypatch.delenv("T1K_BACKEND", raising=False)
    monkeypatch.delenv("T1K_DEVICE_PRESENT", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert device_present() is False


def test_locality_gate_does_not_disable_presence_routing(monkeypatch):
    """resolve_backend("auto") keeping the DP on the host must NOT flip
    device_present() to False, and must leave the user's T1K_BACKEND
    alone."""
    from t1k_tpu.core.pipeline import device_present, resolve_backend

    _clear_routing_env(monkeypatch)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # DP route -> native
    monkeypatch.setenv("T1K_DEVICE_PRESENT", "1")  # card present (pinned)
    assert resolve_backend("auto") == "native"
    assert os.environ.get("T1K_BACKEND", "") == ""  # user env untouched
    assert device_present() is True


def test_pinned_absence_resolves_native_without_probe(monkeypatch):
    """A pinned T1K_DEVICE_PRESENT=0 (multi-process workers sharing one
    card, cli/run.py policy) must resolve the DP backend to native
    WITHOUT asking JAX for its devices, which would open the card."""
    from t1k_tpu.core import pipeline

    _clear_routing_env(monkeypatch)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setenv("T1K_DEVICE_PRESENT", "0")

    def boom(*a, **k):
        raise AssertionError("JAX must not be asked with a pinned verdict")

    monkeypatch.setattr(pipeline, "_gpu_in_process", boom)
    assert pipeline.resolve_backend("auto") == "native"
    assert pipeline.device_present() is False


def test_em_auto_routes_on_presence_and_size(monkeypatch):
    from t1k_tpu.core.genotyper import Genotyper

    _clear_routing_env(monkeypatch)
    monkeypatch.setenv("T1K_DEVICE_PRESENT", "1")
    # small problems stay on the bit-exact native loop even with a card
    assert Genotyper._resolve_em_backend(1000, 100) == "native"
    # >= 5e7 dense cells with a card present: device EM (even though the
    # deferred-DP route would stay on the host here)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert Genotyper._resolve_em_backend(100_000, 1000) == "jax"
    # same size without a card: native
    monkeypatch.setenv("T1K_DEVICE_PRESENT", "0")
    assert Genotyper._resolve_em_backend(100_000, 1000) == "native"
    # explicit override wins
    monkeypatch.setenv("T1K_EM_BACKEND", "jax")
    assert Genotyper._resolve_em_backend(10, 10) == "jax"


def test_extractor_gate_uses_presence(monkeypatch):
    """The size-gated device screen engages for auto + present once the
    gate's read count has streamed, without the DP route's RTT gate; a
    forced "device" (or its "tpu" alias) engages from the first batch."""
    from t1k_tpu.core.extractor import LazyDeviceScreen

    _clear_routing_env(monkeypatch)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("T1K_DEVICE_PRESENT", "1")
    monkeypatch.setenv("T1K_SCREEN_DEVICE_MIN_READS", "100")
    built = []
    gate = LazyDeviceScreen("auto", lambda: built.append(1) or "screen")
    assert gate(60) is None and gate(60) is None  # 0, then 60 < 100
    assert gate(10) == "screen" and built == [1]
    assert LazyDeviceScreen("tpu", lambda: "screen")(1) == "screen"
    monkeypatch.setenv("T1K_DEVICE_PRESENT", "0")
    gate = LazyDeviceScreen("auto", lambda: "screen")
    gate(200)
    assert gate(1) is None


@pytest.mark.parametrize("route", ["resolve", "present", "em", "cli"])
def test_forced_device_without_gpu_raises(monkeypatch, tmp_path, route):
    """With no GPU and no JAX_PLATFORMS=cpu pin, every forced device route
    fails loudly instead of running the device programs elsewhere."""
    from t1k_tpu.core import pipeline
    from t1k_tpu.core.genotyper import Genotyper, GenotyperConfig

    _clear_routing_env(monkeypatch)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(pipeline, "_gpu_in_process", lambda: False)
    if route == "resolve":
        with pytest.raises(pipeline.DeviceUnavailableError):
            pipeline.resolve_backend("device")
        # auto quietly stays on the host
        assert pipeline.resolve_backend("auto") == "native"
    elif route == "present":
        monkeypatch.setenv("T1K_BACKEND", "device")
        with pytest.raises(pipeline.DeviceUnavailableError):
            pipeline.device_present()
    elif route == "em":
        g = Genotyper.__new__(Genotyper)
        g.cfg = GenotyperConfig(em_backend="jax")
        g.ec_to_alleles = [[0]]
        g._read_group_csr = lambda: (np.zeros(2, np.int64),
                                     np.zeros(1, np.int32), np.ones(1))
        with pytest.raises(pipeline.DeviceUnavailableError):
            g.quantify()
    else:
        from t1k_tpu.cli.run import main

        data = os.path.join(os.path.dirname(__file__), "data")
        for flags in (["--backend", "device"], ["--emBackend", "jax"]):
            rc = main(["-f", os.path.join(data, "multigene_rna.fa"),
                       "-1", os.path.join(data, "multigene_1.fq"),
                       "-2", os.path.join(data, "multigene_2.fq"),
                       "--od", str(tmp_path), "-o", "x"] + flags)
            assert rc == 2
        assert os.listdir(tmp_path) == []  # failed before any output


def _em_inputs(rg_cnt=2000, ec_cnt=60, seed=3):
    rng = np.random.default_rng(seed)
    n_alleles, n_genes, n_majors = 120, 4, 24
    ec_to_alleles = [[] for _ in range(ec_cnt)]
    for a in range(n_alleles):
        ec_to_alleles[a % ec_cnt].append(a)
    offs = [0]
    ecs = []
    for _ in range(rg_cnt):
        k = rng.integers(1, 8)
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
        allele_major=(np.arange(n_alleles) % n_majors).astype(np.int32),
        n_genes=n_genes,
        n_majors=n_majors,
    )


def test_f32_polish_reaches_native_fixed_point():
    """Exactness gate for the device EM route: an f32 SQUAREM trajectory
    (what the device computes with 64-bit mode off) polished by the native f64
    loop warm-started from its solution lands on the same fixed point as
    the all-native route, to far below output-rounding resolution."""
    import jax.numpy as jnp

    from t1k_tpu.native import em_quantify
    from t1k_tpu.ops.em import em_quantify_jax

    args = _em_inputs()
    it_native, count_native = em_quantify(**args)

    it_dev, count_dev = em_quantify_jax(dtype=jnp.float32, **args)
    ec_len = np.array(
        [min(int(args["allele_eff_len"][a]) for a in alleles)
         for alleles in args["ec_to_alleles"]], dtype=np.float64)
    per_len = count_dev / ec_len
    it_pol, polished = em_quantify(init_x=per_len / per_len.sum(), **args)

    # the polish satisfies the reference's own f64 convergence criterion
    # quickly (device did the heavy iterations)
    assert it_pol <= it_native
    np.testing.assert_allclose(polished, count_native, rtol=5e-4, atol=5e-4)
    # abundance outputs round to 2 decimals (FPK x abundance); the
    # polished route must agree at far finer resolution than that
    assert float(np.abs(polished - count_native).max()) < 1e-2


def test_warm_start_at_fixed_point_converges_immediately():
    from t1k_tpu.native import em_quantify

    args = _em_inputs(rg_cnt=500, ec_cnt=30, seed=11)
    _, count = em_quantify(**args)
    ec_len = np.array(
        [min(int(args["allele_eff_len"][a]) for a in alleles)
         for alleles in args["ec_to_alleles"]], dtype=np.float64)
    per_len = count / ec_len
    it2, count2 = em_quantify(init_x=per_len / per_len.sum(), **args)
    assert it2 <= 3
    # both endpoints satisfy the reference's diffSum < 1e-5 criterion, so
    # they agree to ~1e-4 of a read — far below the 0.01 output rounding
    np.testing.assert_allclose(count2, count, rtol=1e-3, atol=1e-3)


def test_compile_cache_dir_rule(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set (JAX reads it itself);
    otherwise the cache is the fixed <repo>/.jax_cache/, which git
    ignores."""
    from t1k_tpu.utils import jaxcache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert jaxcache.cache_dir() == "/elsewhere/cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert jaxcache.cache_dir() == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_smartseq_pool_workers_pinned_off_device(monkeypatch):
    """With a worker pool, every cell worker runs with JAX pinned to the
    CPU and both backends native, so only the parent may hold the card;
    a single worker runs in-process with the caller's settings."""
    from t1k_tpu.tools import smartseq

    seen = []

    class FakePool:
        def __init__(self, n, initializer=None):
            self.initializer = initializer

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def starmap(self, fn, jobs):
            self.initializer()
            seen.append((dict(os.environ), [j[0] for j in jobs]))
            return ["out"] * len(jobs)

    class FakeCtx:
        Pool = FakePool

    for var in smartseq.WORKER_ENV:
        monkeypatch.setenv(var, os.environ.get(var, ""))
    monkeypatch.setattr(smartseq.multiprocessing, "get_context",
                        lambda method: FakeCtx)
    jobs = [({"--backend": "device"}, "ref.fa", f"c{i}.fq", None, "o",
             f"c{i}") for i in range(3)]
    assert smartseq._run_cells(jobs, workers=2) == ["out"] * 3
    env, args = seen[0]
    assert env["JAX_PLATFORMS"] == "cpu" and env["T1K_BACKEND"] == "native"
    assert all(a["--backend"] == "native" and a["--emBackend"] == "native"
               for a in args)
    assert jobs[0][0] == {"--backend": "device"}  # caller's dict untouched

