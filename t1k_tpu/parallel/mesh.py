"""Multi-chip scaling: device mesh construction and the sharded EM step.

Design (SURVEY.md section 2.4): the allele reference index and EC tables
are small (MBs) and replicated on every device; read batches and the
read-group x EC incidence lists are sharded along the data axis.  Each EM
iteration computes local per-EC sufficient statistics (expected counts)
and merges them with a single psum over ICI — the only cross-device
communication in the hot loop.  The same layout serves the alignment
stage: candidate (read, allele-window) pairs shard along the batch axis
with no communication at all.
"""

from __future__ import annotations

import functools
from typing import Optional

from ..utils import jaxcache as _jaxcache

_jaxcache.enable()

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch(mesh: Mesh, arr, axis: str = "dp"):
    """Place a batch-major array sharded along the mesh data axis."""
    spec = P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, arr):
    return jax.device_put(arr, NamedSharding(mesh, P()))


def sharded_em_step(mesh: Mesh, axis: str = "dp"):
    """Build one data-parallel EM update step over the mesh.

    The incidence arrays (seg_rg, seg_ec, counts) are sharded along the
    data axis; x (EC abundances) is replicated.  Returns a jitted
    function (x, seg_rg_shard, seg_ec_shard, counts_shard, rg_psum_denom
    precomputed?) -> (x1, count).

    To keep the E-step correct under sharding, the per-read-group
    normalizer must see all of a group's entries — so read groups are
    sharded whole (the host partitioner cuts on group boundaries), and
    the per-EC count reduction is a psum.
    """

    from ..ops.em import sorted_segment_sum

    def step(x, seg_ec, sec_sorted, srg_ecorder, cts_ecorder, rg_starts,
             rg_ends, ecs_starts, ecs_ends, ec_len):
        # sorted-segment sums (see ops/em.py): the shard's incidence
        # list is precomputed in read-group order AND in EC order, so
        # the hot loop needs no big->big permutation gather
        psum = sorted_segment_sum(x[seg_ec], rg_starts, rg_ends)
        psum = jnp.where(psum == 0, 1, psum)
        contrib = cts_ecorder * x[sec_sorted] / psum[srg_ecorder]
        local = sorted_segment_sum(contrib, ecs_starts, ecs_ends)
        count = jax.lax.psum(local, axis)
        per_len = count / ec_len
        x1 = per_len / per_len.sum()
        return x1, count

    return step


def partition_read_groups(seg_rg: np.ndarray, seg_ec: np.ndarray,
                          counts: np.ndarray, rg_cnt: int, n_shards: int,
                          ec_cnt: Optional[int] = None):
    """Split incidence arrays into n_shards with whole read groups per
    shard, padded to equal length (padding points at a dummy group whose
    abundance contribution is zero).  When ec_cnt is given, also emits
    the per-shard EC sort permutation and the per-shard segment bounds
    needed by the sorted-segment device step (ops/em.py)."""
    from ..ops.em import segment_bounds

    order = np.argsort(seg_rg, kind="stable")
    seg_rg, seg_ec, counts = seg_rg[order], seg_ec[order], counts[order]
    bounds = np.searchsorted(
        seg_rg, np.linspace(0, rg_cnt, n_shards + 1)[1:-1])
    pieces = np.split(np.arange(len(seg_rg)), bounds)
    max_len = max((len(p) for p in pieces), default=0)
    max_len = max(max_len, 1)
    out_rg = np.full((n_shards, max_len), rg_cnt, dtype=seg_rg.dtype)
    out_ec = np.zeros((n_shards, max_len), dtype=seg_ec.dtype)
    out_ct = np.zeros((n_shards, max_len), dtype=counts.dtype)
    for s, p in enumerate(pieces):
        out_rg[s, :len(p)] = seg_rg[p]
        out_ec[s, :len(p)] = seg_ec[p]
        out_ct[s, :len(p)] = counts[p]
    if ec_cnt is None:
        return out_rg, out_ec, out_ct
    out_secs = np.zeros((n_shards, max_len), np.int32)
    out_srgo = np.zeros((n_shards, max_len), np.int32)
    out_ctso = np.zeros((n_shards, max_len), counts.dtype)
    out_rgs = np.zeros((n_shards, rg_cnt + 1), np.int32)
    out_rge = np.zeros((n_shards, rg_cnt + 1), np.int32)
    out_ecs = np.zeros((n_shards, ec_cnt), np.int32)
    out_ece = np.zeros((n_shards, ec_cnt), np.int32)
    for s in range(n_shards):
        # padding entries carry count 0, so wherever the sorts place
        # them their prefix-sum contribution is zero
        perm = np.argsort(out_ec[s], kind="stable").astype(np.int32)
        out_secs[s] = out_ec[s][perm]
        out_srgo[s] = out_rg[s][perm]
        out_ctso[s] = out_ct[s][perm]
        out_rgs[s], out_rge[s] = segment_bounds(out_rg[s], rg_cnt + 1)
        out_ecs[s], out_ece[s] = segment_bounds(out_secs[s], ec_cnt)
    return (out_rg, out_ec, out_ct, out_secs, out_srgo, out_ctso,
            out_rgs, out_rge, out_ecs, out_ece)


def em_quantify_sharded_squarem(
    mesh: Mesh,
    seg_rg: np.ndarray,
    seg_ec: np.ndarray,
    counts: np.ndarray,
    rg_cnt: int,
    ec_to_alleles,
    allele_eff_len: np.ndarray,
    allele_weight: np.ndarray,
    allele_gene: np.ndarray,
    allele_major: np.ndarray,
    gene_cnt: int,
    major_cnt: int,
    filter_frac: float = 0.15,
    min_squarem_alpha: float = 0.0,
    max_iterations: int = 1000,
    axis: str = "dp",
    dtype=None,
    single_dispatch: Optional[bool] = None,
):
    """The PRODUCTION multi-chip quantification: the full SQUAREM loop —
    3 EM updates + extrapolation per round, L1 convergence at 1e-5 with
    one forced extra round, and the every-10-rounds low-abundance
    major-allele mask (reference semantics, Genotyper.hpp:1234-1314) —
    with the incidence sharded over the mesh on whole-read-group
    boundaries and ONE psum of per-EC expected counts per EM update
    (the only collective).  This is the step dryrun_multichip compiles
    and a multi-device run would use; trajectory matches the single-device
    device EM (ops/em.py) and the native f64 loop's iteration count
    (tests/test_device_ops.py::test_sharded_squarem_matches_native).

    Dispatch model (single_dispatch=None resolves by platform): on real
    device meshes the ENTIRE convergence loop runs as ONE jitted
    shard_mapped `lax.while_loop` with the psum inside — no per-round
    host dispatch, matching the reference's run-to-convergence loop
    (Genotyper.hpp:1234-1290) and the single-device path (ops/em.py
    _squarem_while).  On the virtual multi-device CPU backend used for
    dry runs a psum inside a device-side while_loop deadlocks, so there
    rounds are advanced by a host loop with one shard_mapped jitted
    round per step (correctness-identical: the loop state is replicated
    and deterministic, so every shard agrees on the trip count).
    Returns (iterations, ec_read_count[f64])."""
    import jax.numpy as jnp

    from ..ops.em import (_make_mask_reset, _pack_ec_tables, segment_bounds,
                          sorted_segment_sum)

    if dtype is None:
        dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32
    n = mesh.devices.size
    ec_cnt = len(ec_to_alleles)
    (ec_len, ec_size, ec_first, allele_ec, allele_valid, init_x) = (
        _pack_ec_tables(ec_to_alleles, allele_eff_len, allele_weight))
    counts = np.asarray(counts, np.float64)
    # accept per-read-group counts (the native em_quantify convention)
    # or per-incidence-entry counts
    counts_per_rg = counts.shape == (rg_cnt,)
    entry_counts = counts[seg_rg] if counts_per_rg else counts
    (out_rg, sec, _, secs_sorted, srgo, ctso, srgs, srge, secs, sece) = (
        partition_read_groups(seg_rg, seg_ec, entry_counts,
                              rg_cnt, n, ec_cnt=ec_cnt))

    # Dense per-shard E-step (ops/em.py dense formulation applied inside
    # the shard): read groups are contiguous per shard, so each shard
    # owns a local [R_local+1, ec] int8 incidence (last row = padding
    # dummy) built on device; the E-step becomes two mixed-precision
    # matvecs, with no gathers or scatters.
    # Falls back to the sorted-segment formulation when per-entry
    # counts were supplied (dense rows carry one count per read group)
    # or the per-shard incidence exceeds the device budget.
    from ..ops.em import DENSE_EM_MAX_BYTES, _mv, _vm

    lrg = None
    if counts_per_rg:
        rg_lo = np.zeros(n, np.int64)
        span = 0
        for s in range(n):
            real = out_rg[s][out_rg[s] < rg_cnt]
            rg_lo[s] = int(real[0]) if len(real) else 0
            if len(real):
                span = max(span, int(real[-1]) - int(rg_lo[s]) + 1)
        r_local = max(span, 1)
        if (r_local + 1) * ec_cnt <= DENSE_EM_MAX_BYTES:
            lrg = np.where(out_rg < rg_cnt, out_rg - rg_lo[:, None],
                           r_local).astype(np.int32)
            cts_local = np.zeros((n, r_local + 1), np.float64)
            for s in range(n):
                real = out_rg[s][out_rg[s] < rg_cnt]
                cts_local[s, real - rg_lo[s]] = counts[real]

    mask_reset = _make_mask_reset(
        jnp.asarray(ec_len, dtype), jnp.asarray(ec_size, dtype),
        jnp.asarray(ec_first), jnp.asarray(allele_ec),
        jnp.asarray(allele_valid), jnp.asarray(allele_gene, jnp.int32),
        jnp.asarray(allele_major, jnp.int32), gene_cnt, major_cnt,
        float(filter_frac))

    def squarem_round(t, x, em_update):
        """One SQUAREM round (Genotyper.hpp:1234-1290) on any E-step
        formulation; the psum inside em_update is the only collective."""
        x1, _ = em_update(x)
        x2, _ = em_update(x1)
        r = x1 - x
        v = x2 - 2 * x1 + x
        sum_r = (r * r).sum()
        sum_v = (v * v).sum()
        alpha = jnp.where(sum_v == 0, -1.0,
                          -jnp.sqrt(sum_r) / jnp.sqrt(jnp.where(sum_v == 0, 1,
                                                                sum_v)))
        alpha = jnp.where(
            (min_squarem_alpha < 0) & (alpha < min_squarem_alpha),
            min_squarem_alpha, alpha)
        x3 = x - 2 * alpha * r + alpha * alpha * v
        x1b, count = em_update(x3)
        diff = jnp.abs(x1b - x).sum()
        t = jnp.where((diff < 1e-5) & (t < max_iterations - 2),
                      max_iterations - 2, t)
        do_mask = (t > 0) & (t % 10 == 0)
        x_next = jnp.where(do_mask, mask_reset(count), x1b)
        return t + 1, x_next, count

    if lrg is not None:
        # ---- dense per-shard E-step
        data = (lrg, sec, cts_local)
        data_in_specs = (P(axis, None),) * 3 + (P(),)

        def make_update(shard_args, ec_len_r):
            lrg_s, sec_s, cts_s = shard_args
            A = jnp.zeros((r_local + 1, ec_cnt), jnp.int8).at[
                lrg_s.reshape(-1), sec_s.reshape(-1)].add(1)
            cts_f = cts_s.reshape(-1).astype(dtype)

            def em_update(xk):
                psum_rg = _mv(A, xk, dtype)
                psum_rg = jnp.where(psum_rg == 0, 1, psum_rg)
                local = xk * _vm(cts_f / psum_rg, A, dtype)
                count = jax.lax.psum(local, axis)
                per_len = count / ec_len_r
                x1 = per_len / per_len.sum()
                return x1, count

            return em_update
    else:
        # ---- sorted-segment E-step (per-entry counts, or the
        # per-shard dense incidence exceeds the device budget)
        data = (sec, secs_sorted, srgo, ctso.astype(np.float64), srgs,
                srge, secs, sece)
        data_in_specs = (P(axis, None),) * 8 + (P(),)

        def make_update(shard_args, ec_len_r):
            (sec_f, secs_f, srgo_f, ctso_f, rgs_f, rge_f, ecs_f,
             ece_f) = (a.reshape(-1) for a in shard_args)

            def em_update(xk):
                # per-read-group normalizers are shard-local (whole
                # groups per shard); per-EC counts merge with the psum
                psum_rg = sorted_segment_sum(xk[sec_f], rgs_f, rge_f)
                psum_rg = jnp.where(psum_rg == 0, 1, psum_rg)
                contrib = ctso_f * xk[secs_f] / psum_rg[srgo_f]
                local = sorted_segment_sum(contrib, ecs_f, ece_f)
                count = jax.lax.psum(local, axis)
                per_len = count / ec_len_r
                x1 = per_len / per_len.sum()
                return x1, count

            return em_update

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P()) + data_in_specs,
        out_specs=(P(), P(), P()),
    )
    def round_step(t, x, *shard_args):
        em_update = make_update(shard_args[:-1], shard_args[-1])
        return squarem_round(t, x, em_update)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=data_in_specs,
        out_specs=(P(), P(), P()),
    )
    def full_loop(*shard_args):
        # SINGLE dispatch: the whole convergence loop on device, psum
        # inside the while body.  Loop state (t, x, count, round count)
        # is computed identically on every shard from replicated inputs,
        # so all shards agree on the trip count and the psums pair up.
        # The dense incidence is built ONCE here, loop-invariant.
        em_update = make_update(shard_args[:-1], shard_args[-1])

        def body(state):
            t, x, _, rounds = state
            t1, x1, count = squarem_round(t, x, em_update)
            return t1, x1, count, rounds + 1

        def cond(state):
            return state[0] < max_iterations

        ec_cnt_l = shard_args[-1].shape[0]
        state0 = (jnp.zeros((), jnp.int32),
                  jnp.asarray(init_x, dtype),
                  jnp.zeros(ec_cnt_l, dtype),
                  jnp.zeros((), jnp.int32))
        t, x, count, rounds = jax.lax.while_loop(cond, body, state0)
        return rounds, x, count

    shard2 = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P())
    args = tuple(
        jax.device_put(jnp.asarray(a), shard2) for a in data)
    ec_len_d = jax.device_put(jnp.asarray(ec_len, dtype), repl)
    if single_dispatch is None:
        single_dispatch = mesh.devices.flat[0].platform != "cpu"
    if single_dispatch:
        rounds, _, count = jax.jit(full_loop)(*args, ec_len_d)
        return int(rounds), np.asarray(count, np.float64)
    round_step = jax.jit(round_step)
    x = jax.device_put(jnp.asarray(init_x, dtype), repl)
    t = jax.device_put(jnp.zeros((), jnp.int32), repl)
    count = None
    iters = 0
    while int(t) < max_iterations:
        t, x, count = round_step(t, x, *args, ec_len_d)
        iters += 1
    return iters, np.asarray(count, np.float64)


def em_quantify_sharded(
    mesh: Mesh,
    seg_rg: np.ndarray,
    seg_ec: np.ndarray,
    counts: np.ndarray,
    rg_cnt: int,
    ec_len: np.ndarray,
    init_x: np.ndarray,
    iterations: int = 50,
    axis: str = "dp",
):
    """Multi-chip plain-EM quantification (no SQUAREM) used by the
    dry-run and scaling benchmarks; the single-chip SQUAREM variant lives
    in ops/em.py."""
    n = mesh.devices.size
    ec_cnt = len(init_x)
    (_, sec, _, secs_sorted, srgo, ctso, srgs, srge, secs, sece) = (
        partition_read_groups(seg_rg, seg_ec, counts, rg_cnt, n,
                              ec_cnt=ec_cnt))
    dtype = jnp.float32
    step = sharded_em_step(mesh, axis)

    # NOTE: the update is shard_mapped per iteration (psum inside a
    # device-side fori_loop deadlocks on the virtual CPU backend used for
    # multi-chip dry runs; on real hardware the per-call overhead is
    # dwarfed by the E-step work).
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis, None), P(axis, None),
                  P(axis, None), P(axis, None), P(axis, None),
                  P(axis, None), P(axis, None), P()),
        out_specs=P(),
    )
    def run_step(x, sec_s, secs_s, srgo_s, ctso_s, rgs_s, rge_s, ecs_s,
                 ece_s, ec_len_r):
        x1, _ = step(x, sec_s.reshape(-1), secs_s.reshape(-1),
                     srgo_s.reshape(-1), ctso_s.reshape(-1),
                     rgs_s.reshape(-1), rge_s.reshape(-1),
                     ecs_s.reshape(-1), ece_s.reshape(-1), ec_len_r)
        return x1

    run_step = jax.jit(run_step, donate_argnums=(0,))
    x = jnp.asarray(init_x, dtype)
    x = x / x.sum()
    args = tuple(jnp.asarray(a) for a in
                 (sec, secs_sorted, srgo, ctso.astype(np.float32),
                  srgs, srge, secs, sece))
    ec_len_d = jnp.asarray(ec_len, dtype)
    for _ in range(iterations):
        x = run_step(x, *args, ec_len_d)
    return np.asarray(x)
