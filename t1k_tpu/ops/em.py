"""SQUAREM-accelerated EM on device (jitted dense linear algebra).

The read-group x equivalence-class adjacency is kept as flat segment
arrays (one entry per read-group/EC incidence); the E-step is two
segment-sums and the M-step a normalized reduction — all fuseable by XLA
and shardable over a device mesh (see parallel/mesh.py: the incidence
entries are sharded and the per-EC sufficient statistics merged with a
psum each iteration, which is the only cross-device communication).

Numerical contract follows the reference EM (Genotyper.hpp:372-437,
1142-1328): double EM update + SQUAREM extrapolation + stabilizing
update, L1 convergence at 1e-5 with one forced extra iteration, and the
every-10-rounds low-abundance major-allele mask.  The native engine
(native/em.cc) is the bit-exact f64 oracle; this device version matches
it to float tolerance and is the path used at scale.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

from ..utils import jaxcache as _jaxcache

_jaxcache.enable()

import jax
import jax.numpy as jnp

import numpy as np


def _segment_sum(data, seg, n):
    return jax.ops.segment_sum(data, seg, num_segments=n)


@functools.partial(jax.jit, static_argnames=("rg_cnt", "ec_cnt", "dtype"))
def _build_incidence(seg_rg, seg_ec, rg_cnt: int, ec_cnt: int,
                     dtype=jnp.int8):
    """0/1 [rg_cnt, ec_cnt] incidence built on device: a one-time
    scatter-add over the nnz index lists, so the full matrix never
    crosses the host link (it can be GBs at the dense cap).

    Stored int8 by default: the EM matvecs stream A from device memory,
    so byte-wide storage moves a quarter of the bytes of f32; values are
    exact small integers, so the f32-accumulating mixed dot below loses
    nothing."""
    return jnp.zeros((rg_cnt, ec_cnt), dtype).at[seg_rg, seg_ec].add(1)


# Full float32 products: a float32 dot may otherwise run in TF32 on the
# GPU, and these matvecs are bound by streaming A, so TF32 would buy
# nothing but a different SQUAREM trajectory.
_HIGHEST = jax.lax.Precision.HIGHEST


def _mv(A, x, dtype):
    """[rg, ec] (any int/float dtype) @ [ec] -> [rg] accumulated in
    `dtype` (mixed-precision dot: A is converted as it is read, so int8
    A streams at 1 byte/element)."""
    return jax.lax.dot_general(A, x.astype(dtype), (((1,), (0,)), ((), ())),
                               precision=_HIGHEST,
                               preferred_element_type=dtype)


def _vm(w, A, dtype):
    """[rg] @ [rg, ec] -> [ec] accumulated in `dtype`."""
    return jax.lax.dot_general(w.astype(dtype), A, (((0,), (0,)), ((), ())),
                               precision=_HIGHEST,
                               preferred_element_type=dtype)


# Memory budget for the dense-incidence EM path's [rg, ec] matrix.  The
# incidence is built ON DEVICE by a one-time scatter from the index
# lists, so only the ~nnz indices cross the host link and the budget is
# device memory only.  A is stored int8 (1 byte/element), so this cap
# admits 4G-element problems — beyond every realistic single sample.
DENSE_EM_MAX_BYTES = 4 << 30

# Host-side budget for the cohort-batched path, which still builds the
# padded [cells, R, K] incidence stack on host (cells are small; the
# stack is chunked to this size before transfer).
BATCH_EM_MAX_ELEMS = 64_000_000

# Backwards-compat alias (tests force the segment path through this);
# with int8 storage one element is one byte.
DENSE_EM_MAX_ELEMS = DENSE_EM_MAX_BYTES


def segment_bounds(seg_sorted: np.ndarray, n: int):
    """(starts, ends) of each segment id in a SORTED segment array —
    host precompute for the device sorted-segment sum."""
    ids = np.arange(n + 1)
    b = np.searchsorted(seg_sorted, ids).astype(np.int32)
    return b[:-1], b[1:]


def sorted_segment_sum(vals, starts, ends):
    """Segment sums of `vals` laid out in sorted segment order: segment s
    owns vals[starts[s]:ends[s]], and entries outside every segment (the
    padding of a shard) are dropped.  Each sum accumulates only its own
    entries, so its rounding error is relative to that segment alone (a
    prefix-sum difference over the whole array loses the small segments'
    digits in float32, enough to keep SQUAREM from ever reaching its
    1e-5 convergence step).  Segment ids come from a search of `starts`,
    which is loop-invariant inside the EM loops."""
    n = starts.shape[0]
    pos = jnp.arange(vals.shape[0], dtype=starts.dtype)
    seg = jnp.searchsorted(starts, pos, side="right") - 1
    inside = (seg >= 0) & (pos < ends[jnp.maximum(seg, 0)])
    return jax.ops.segment_sum(vals, jnp.where(inside, seg, n),
                               num_segments=n, indices_are_sorted=True)


@functools.partial(
    jax.jit,
    static_argnames=("ec_cnt", "rg_cnt", "gene_cnt", "major_cnt",
                     "max_iterations", "mask_round"))
def _em_loop(
    seg_ec, sec_sorted, srg_ecorder, cts_ecorder, rg_starts, rg_ends,
    ecs_starts, ecs_ends, ec_len, ec_size, ec_first_allele,
    allele_ec, allele_valid, allele_gene, allele_major, init_x,
    filter_frac, min_squarem_alpha,
    ec_cnt: int, rg_cnt: int, gene_cnt: int, major_cnt: int,
    max_iterations: int, mask_round: int,
):
    dtype = init_x.dtype

    def em_update(x):
        # Permutation-free E/M steps.  The incidence list exists in two
        # precomputed orders: read-group order (for the per-group
        # normalizer) and EC order (for the count reduction), so both
        # segment sums run over sorted segments and the only large
        # gather reads the [rg_cnt] psum table.
        psum = sorted_segment_sum(x[seg_ec], rg_starts, rg_ends)
        psum = jnp.where(psum == 0, 1, psum)
        contrib = cts_ecorder * x[sec_sorted] / psum[srg_ecorder]
        count = sorted_segment_sum(contrib, ecs_starts, ecs_ends)
        per_len = count / ec_len
        norm = per_len.sum()
        x1 = per_len / norm
        diff = jnp.abs(x1 - x).sum()
        return x1, count, diff

    mask_reset = _make_mask_reset(
        ec_len, ec_size, ec_first_allele, allele_ec, allele_valid,
        allele_gene, allele_major, gene_cnt, major_cnt, filter_frac)

    return _squarem_while(em_update, mask_reset, init_x, min_squarem_alpha,
                          ec_cnt, max_iterations, mask_round, dtype)


def _make_mask_reset(ec_len, ec_size, ec_first_allele, allele_ec,
                     allele_valid, allele_gene, allele_major,
                     gene_cnt: int, major_cnt: int, filter_frac: float):
    """Every-10-rounds abundance mask (Genotyper.hpp:1292-1313), shared
    by the segment and dense EM loops: major-allele abundances below
    filter_frac * 0.5 * their gene's max reset their EC abundance to 0.
    (The cohort-batched loop carries a vmapped variant of the same
    rule.)"""

    def mask_reset(count):
        ec_abund = count / ec_len * 1000.0
        allele_abund = jnp.where(
            allele_valid, ec_abund[allele_ec] / ec_size[allele_ec], 0)
        major_abund = _segment_sum(allele_abund, allele_major, major_cnt)
        per_allele_major = major_abund[allele_major]
        gene_max = jax.ops.segment_max(
            jnp.where(allele_valid, per_allele_major, 0), allele_gene,
            num_segments=gene_cnt)
        masked = per_allele_major < filter_frac * 0.5 * gene_max[allele_gene]
        first_masked = masked[ec_first_allele]
        return jnp.where(first_masked, 0.0, ec_abund)

    return mask_reset


def _squarem_while(em_update, mask_reset, init_x, min_squarem_alpha,
                   ec_cnt, max_iterations, mask_round, dtype):
    """Shared SQUAREM driver (Genotyper.hpp:1234-1314): 3 EM updates +
    extrapolation per round, convergence with one forced extra round,
    and the every-mask_round abundance mask."""

    def body(state):
        t, x0, count, iters = state
        iters = iters + 1
        x1, _, _ = em_update(x0)
        x2, _, _ = em_update(x1)
        r = x1 - x0
        v = x2 - 2 * x1 + x0
        sum_r = (r * r).sum()
        sum_v = (v * v).sum()
        alpha = jnp.where(sum_v == 0, -1.0, -jnp.sqrt(sum_r) / jnp.sqrt(sum_v))
        alpha = jnp.where(
            (min_squarem_alpha < 0) & (alpha < min_squarem_alpha),
            min_squarem_alpha, alpha)
        x3 = x0 - 2 * alpha * r + alpha * alpha * v
        x1b, count, _ = em_update(x3)
        diff = jnp.abs(x1b - x0).sum()
        x0 = x1b
        t = jnp.where((diff < 1e-5) & (t < max_iterations - 2),
                      max_iterations - 2, t)
        do_mask = (t > 0) & (t % mask_round == 0)
        x0 = jnp.where(do_mask, mask_reset(count), x0)
        return t + 1, x0, count, iters

    def cond(state):
        t, _, _, _ = state
        return t < max_iterations

    count0 = jnp.zeros(ec_cnt, dtype)
    t, x, count, iters = jax.lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), init_x, count0,
                     jnp.zeros((), jnp.int32)))
    return count, iters


@functools.partial(
    jax.jit,
    static_argnames=("ec_cnt", "gene_cnt", "major_cnt", "max_iterations",
                     "mask_round"))
def _em_loop_dense(
    A, cts_rg, ec_len, ec_size, ec_first_allele,
    allele_ec, allele_valid, allele_gene, allele_major, init_x,
    filter_frac, min_squarem_alpha,
    ec_cnt: int, gene_cnt: int, major_cnt: int,
    max_iterations: int, mask_round: int,
):
    """Dense-incidence EM: A is the 0/1 [rg_cnt, ec_cnt] int8 matrix.
    The E-step is two mixed-precision dense matvecs (bandwidth-bound
    streaming of A at 1 byte/element, no gathers or scatters); used
    whenever A fits the device-memory budget, which covers every
    single-sample workload."""
    dtype = init_x.dtype

    def em_update(x):
        psum = _mv(A, x, dtype)
        psum = jnp.where(psum == 0, 1, psum)
        count = x * _vm(cts_rg / psum, A, dtype)
        per_len = count / ec_len
        norm = per_len.sum()
        x1 = per_len / norm
        diff = jnp.abs(x1 - x).sum()
        return x1, count, diff

    mask_reset = _make_mask_reset(
        ec_len, ec_size, ec_first_allele, allele_ec, allele_valid,
        allele_gene, allele_major, gene_cnt, major_cnt, filter_frac)

    return _squarem_while(em_update, mask_reset, init_x, min_squarem_alpha,
                          ec_cnt, max_iterations, mask_round, dtype)


def _pack_ec_tables(ec_to_alleles, allele_eff_len, allele_weight):
    """Host packing of one problem's EC-level tables, shared by the
    single-sample and cohort-batched paths."""
    ec_len = np.array(
        [min(int(allele_eff_len[a]) for a in alleles) for alleles in ec_to_alleles],
        dtype=np.float64)
    ec_size = np.array([len(a) for a in ec_to_alleles], dtype=np.float64)
    ec_first = np.array([a[0] for a in ec_to_alleles], dtype=np.int32)
    allele_cnt = len(allele_eff_len)
    allele_ec = np.zeros(allele_cnt, dtype=np.int32)
    allele_valid = np.zeros(allele_cnt, dtype=bool)
    for i, alleles in enumerate(ec_to_alleles):
        for a in alleles:
            allele_ec[a] = i
            allele_valid[a] = True
    init_x = np.array(
        [sum(int(allele_weight[a]) for a in alleles) for alleles in ec_to_alleles],
        dtype=np.float64)
    return ec_len, ec_size, ec_first, allele_ec, allele_valid, init_x


def em_quantify_jax(
    ec_to_alleles: List[List[int]],
    rg_ecs_csr: Tuple[np.ndarray, np.ndarray],
    rg_counts: np.ndarray,
    allele_eff_len: np.ndarray,
    allele_missing: np.ndarray,
    allele_weight: np.ndarray,
    allele_gene: np.ndarray,
    allele_major: np.ndarray,
    n_genes: int,
    n_majors: int,
    filter_frac: float = 0.15,
    min_squarem_alpha: float = 0.0,
    max_iterations: int = 1000,
    dtype=jnp.float64,
) -> Tuple[int, np.ndarray]:
    """Drop-in device replacement for native.em_quantify."""
    ec_cnt = len(ec_to_alleles)
    if ec_cnt == 0:
        return 0, np.zeros(0)
    if dtype == jnp.float64 and not jax.config.read("jax_enable_x64"):
        dtype = jnp.float32

    rg_off, rg_ecs = rg_ecs_csr
    rg_cnt = len(rg_counts)
    seg_rg = np.repeat(np.arange(rg_cnt), np.diff(rg_off)).astype(np.int32)
    seg_ec = np.asarray(rg_ecs, dtype=np.int32)
    rg_counts_flat = np.asarray(rg_counts, dtype=np.float64)[seg_rg]
    ec_perm = np.argsort(seg_ec, kind="stable").astype(np.int32)
    sec_sorted = seg_ec[ec_perm]
    srg_ecorder = seg_rg[ec_perm]
    cts_ecorder = rg_counts_flat[ec_perm]
    rg_starts, rg_ends = segment_bounds(seg_rg, rg_cnt)
    ecs_starts, ecs_ends = segment_bounds(sec_sorted, ec_cnt)

    (ec_len, ec_size, ec_first, allele_ec, allele_valid,
     init_x) = _pack_ec_tables(ec_to_alleles, allele_eff_len, allele_weight)

    # Dense fast path: when the [rg_cnt, ec_cnt] int8 incidence matrix
    # fits in the device-memory budget (built on device, never
    # transferred), the E-step is two mixed-precision dense matvecs.
    # Covers every realistic single-sample workload; the segment path
    # handles problems beyond device memory.
    elem_cap = min(DENSE_EM_MAX_ELEMS, DENSE_EM_MAX_BYTES)
    if rg_cnt * ec_cnt <= elem_cap:
        A = _build_incidence(jnp.asarray(seg_rg), jnp.asarray(seg_ec),
                             rg_cnt, ec_cnt)
        count, iters = _em_loop_dense(
            A, jnp.asarray(rg_counts, dtype),
            jnp.asarray(ec_len, dtype), jnp.asarray(ec_size, dtype),
            jnp.asarray(ec_first), jnp.asarray(allele_ec),
            jnp.asarray(allele_valid), jnp.asarray(allele_gene, jnp.int32),
            jnp.asarray(allele_major, jnp.int32), jnp.asarray(init_x, dtype),
            float(filter_frac), float(min_squarem_alpha),
            ec_cnt, n_genes, n_majors, max_iterations, 10,
        )
        return int(iters), np.asarray(count, dtype=np.float64)

    count, iters = _em_loop(
        jnp.asarray(seg_ec), jnp.asarray(sec_sorted),
        jnp.asarray(srg_ecorder), jnp.asarray(cts_ecorder, dtype),
        jnp.asarray(rg_starts), jnp.asarray(rg_ends),
        jnp.asarray(ecs_starts), jnp.asarray(ecs_ends),
        jnp.asarray(ec_len, dtype), jnp.asarray(ec_size, dtype),
        jnp.asarray(ec_first), jnp.asarray(allele_ec),
        jnp.asarray(allele_valid), jnp.asarray(allele_gene, jnp.int32),
        jnp.asarray(allele_major, jnp.int32), jnp.asarray(init_x, dtype),
        float(filter_frac), float(min_squarem_alpha),
        ec_cnt, rg_cnt, n_genes, n_majors, max_iterations, 10,
    )
    return int(iters), np.asarray(count, dtype=np.float64)


# ------------------------------------------------------------------ cohort
#
# Cells as a batched axis (north-star config 5; reference analog:
# independent per-cell genotyper processes, t1k-smartseq.pl:90-112).
# Every cell's dense EC problem is padded to the chunk's [R, K] envelope
# and stacked; one jitted while_loop advances all cells together with
# batched matvecs (the E-step streams the [C, R, K] incidence stack —
# bandwidth-bound, exactly like the single-sample dense path but with
# the dispatch and HBM streaming amortized across cells).  A cell that
# converges is frozen (its state no longer updated), so each cell's
# SQUAREM trajectory is the same as running it alone; the loop exits
# when every cell has finished.  The cell axis is embarrassingly
# parallel: with a mesh, the stack shards along it and the only
# collective is the all-reduce implied by the loop condition.

@functools.partial(
    jax.jit,
    static_argnames=("ec_cnt", "gene_cnt", "major_cnt", "max_iterations",
                     "mask_round"))
def _em_loop_dense_batched(
    A, cts_rg, ec_len, ec_size, ec_first_allele,
    allele_ec, allele_valid, allele_gene, allele_major, init_x,
    filter_frac, min_squarem_alpha,
    ec_cnt: int, gene_cnt: int, major_cnt: int,
    max_iterations: int, mask_round: int,
):
    """Batched dense EM: A is the [C, R, K] int8 incidence stack;
    per-cell tables carry a leading cell axis; allele_gene/allele_major
    are shared (same reference)."""
    dtype = init_x.dtype
    C = A.shape[0]

    def em_update(x):
        # batched mixed-precision matvecs: [C,R,K] @ [C,K] and
        # [C,R] @ [C,R,K], accumulating in the compute dtype while A
        # streams at 1 byte/element
        psum = jnp.einsum("crk,ck->cr", A, x.astype(dtype),
                          precision=_HIGHEST, preferred_element_type=dtype)
        psum = jnp.where(psum == 0, 1, psum)
        count = x * jnp.einsum("cr,crk->ck", (cts_rg / psum).astype(dtype),
                               A, precision=_HIGHEST,
                               preferred_element_type=dtype)
        per_len = count / ec_len
        norm = per_len.sum(axis=1, keepdims=True)
        norm = jnp.where(norm == 0, 1, norm)
        x1 = per_len / norm
        diff = jnp.abs(x1 - x).sum(axis=1)
        return x1, count, diff

    def mask_reset(count):
        ec_abund = count / ec_len * 1000.0
        allele_abund = jnp.where(
            allele_valid,
            jnp.take_along_axis(ec_abund, allele_ec, axis=1)
            / jnp.take_along_axis(ec_size, allele_ec, axis=1), 0)
        seg_sum = jax.vmap(
            lambda v: _segment_sum(v, allele_major, major_cnt))
        major_abund = seg_sum(allele_abund)
        per_allele_major = jnp.take_along_axis(
            major_abund, jnp.broadcast_to(allele_major, allele_abund.shape),
            axis=1)
        seg_max = jax.vmap(
            lambda v: jax.ops.segment_max(v, allele_gene,
                                          num_segments=gene_cnt))
        gene_max = seg_max(jnp.where(allele_valid, per_allele_major, 0))
        masked = per_allele_major < filter_frac * 0.5 * jnp.take_along_axis(
            gene_max, jnp.broadcast_to(allele_gene, allele_abund.shape),
            axis=1)
        first_masked = jnp.take_along_axis(masked, ec_first_allele, axis=1)
        return jnp.where(first_masked, 0.0, ec_abund)

    def body(state):
        t, x0, count, iters = state
        active = t < max_iterations
        x1, _, _ = em_update(x0)
        x2, _, _ = em_update(x1)
        r = x1 - x0
        v = x2 - 2 * x1 + x0
        sum_r = (r * r).sum(axis=1)
        sum_v = (v * v).sum(axis=1)
        alpha = jnp.where(sum_v == 0, -1.0,
                          -jnp.sqrt(sum_r) / jnp.sqrt(jnp.where(sum_v == 0, 1,
                                                                sum_v)))
        alpha = jnp.where(
            (min_squarem_alpha < 0) & (alpha < min_squarem_alpha),
            min_squarem_alpha, alpha)
        x3 = x0 - 2 * alpha[:, None] * r + (alpha * alpha)[:, None] * v
        x1b, count_n, _ = em_update(x3)
        diff = jnp.abs(x1b - x0).sum(axis=1)
        t_n = jnp.where((diff < 1e-5) & (t < max_iterations - 2),
                        max_iterations - 2, t)
        do_mask = (t_n > 0) & (t_n % mask_round == 0)
        x0_n = jnp.where(do_mask[:, None], mask_reset(count_n), x1b)
        # freeze finished cells so their trajectories match solo runs
        t = jnp.where(active, t_n + 1, t)
        x0 = jnp.where(active[:, None], x0_n, x0)
        count = jnp.where(active[:, None], count_n, count)
        iters = jnp.where(active, iters + 1, iters)
        return t, x0, count, iters

    def cond(state):
        t = state[0]
        return (t < max_iterations).any()

    count0 = jnp.zeros((C, ec_cnt), dtype)
    t0 = jnp.zeros(C, jnp.int32)
    t, x, count, iters = jax.lax.while_loop(
        cond, body, (t0, init_x, count0, jnp.zeros(C, jnp.int32)))
    return count, iters


def em_quantify_jax_batched(
    problems: List[Tuple[List[List[int]], Tuple[np.ndarray, np.ndarray],
                         np.ndarray, np.ndarray]],
    allele_eff_len: np.ndarray,
    allele_gene: np.ndarray,
    allele_major: np.ndarray,
    n_genes: int,
    n_majors: int,
    filter_frac: float = 0.15,
    min_squarem_alpha: float = 0.0,
    max_iterations: int = 1000,
    dtype=jnp.float64,
    mesh=None,
    max_chunk_elems: int = BATCH_EM_MAX_ELEMS,
) -> List[Tuple[int, np.ndarray]]:
    """Quantify many cells' EC problems in one device program.

    problems: per cell, (ec_to_alleles, rg_ecs_csr, rg_counts,
    allele_weight).  All cells must share the reference (allele_eff_len /
    allele_gene / allele_major describe every cell).  Returns per cell
    (em_iterations, ec_read_count) in input order.  With `mesh`, the
    cell axis is sharded across its devices ('dp' axis; the reference
    tables are replicated).
    """
    if dtype == jnp.float64 and not jax.config.read("jax_enable_x64"):
        dtype = jnp.float32
    n_alleles = len(allele_eff_len)
    results: List[Optional[Tuple[int, np.ndarray]]] = [None] * len(problems)

    packed = []  # (cell_idx, A, cts, ec tables..., init_x, K, R)
    for ci, (ec_to_alleles, rg_ecs_csr, rg_counts, allele_weight) in enumerate(
            problems):
        ec_cnt = len(ec_to_alleles)
        if ec_cnt == 0:
            results[ci] = (0, np.zeros(0))
            continue
        rg_off, rg_ecs = rg_ecs_csr
        rg_cnt = len(rg_counts)
        seg_rg = np.repeat(np.arange(rg_cnt), np.diff(rg_off)).astype(np.int32)
        seg_ec = np.asarray(rg_ecs, dtype=np.int32)
        A = np.zeros((rg_cnt, ec_cnt), np.int8)
        np.add.at(A, (seg_rg, seg_ec), 1)
        tables = _pack_ec_tables(ec_to_alleles, allele_eff_len, allele_weight)
        packed.append((ci, A, np.asarray(rg_counts, np.float64), tables,
                       ec_cnt, rg_cnt))

    # Chunk cells so the padded [C, Rmax, Kmax] stack stays in budget;
    # sorting by R keeps the padding envelope tight within each chunk.
    packed.sort(key=lambda p: (p[5], p[4]))
    chunks: List[List] = []
    cur: List = []
    for p in packed:
        trial = cur + [p]
        rmax = max(q[5] for q in trial)
        kmax = max(q[4] for q in trial)
        if cur and len(trial) * rmax * kmax > max_chunk_elems:
            chunks.append(cur)
            cur = [p]
        else:
            cur = trial
    if cur:
        chunks.append(cur)

    for chunk in chunks:
        C = len(chunk)
        pad_c = C
        if mesh is not None:
            n_dev = int(np.prod(list(mesh.shape.values())))
            pad_c = -(-C // n_dev) * n_dev
        rmax = max(p[5] for p in chunk)
        kmax = max(p[4] for p in chunk)
        A = np.zeros((pad_c, rmax, kmax), np.int8)
        cts = np.zeros((pad_c, rmax), np.float64)
        ec_len = np.ones((pad_c, kmax), np.float64)
        ec_size = np.ones((pad_c, kmax), np.float64)
        ec_first = np.zeros((pad_c, kmax), np.int32)
        allele_ec = np.zeros((pad_c, n_alleles), np.int32)
        allele_valid = np.zeros((pad_c, n_alleles), bool)
        init_x = np.zeros((pad_c, kmax), np.float64)
        for i, (ci, Ai, ctsi, tables, K, R) in enumerate(chunk):
            el, es, ef, aec, avalid, ix = tables
            A[i, :R, :K] = Ai
            cts[i, :R] = ctsi
            ec_len[i, :K] = el
            ec_size[i, :K] = es
            ec_first[i, :K] = ef
            allele_ec[i] = aec
            allele_valid[i] = avalid
            init_x[i, :K] = ix

        args = [jnp.asarray(A, dtype), jnp.asarray(cts, dtype),
                jnp.asarray(ec_len, dtype), jnp.asarray(ec_size, dtype),
                jnp.asarray(ec_first), jnp.asarray(allele_ec),
                jnp.asarray(allele_valid),
                jnp.asarray(allele_gene, jnp.int32),
                jnp.asarray(allele_major, jnp.int32),
                jnp.asarray(init_x, dtype)]
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            axis = list(mesh.shape.keys())[0]
            shard = NamedSharding(mesh, P(axis))
            repl = NamedSharding(mesh, P())
            # cell-major stacks shard along the cell axis; the shared
            # allele_gene/allele_major reference tables replicate
            args = ([jax.device_put(a, shard) for a in args[:7]]
                    + [jax.device_put(args[7], repl),
                       jax.device_put(args[8], repl),
                       jax.device_put(args[9], shard)])
        count, iters = _em_loop_dense_batched(
            *args, float(filter_frac), float(min_squarem_alpha),
            kmax, n_genes, n_majors, max_iterations, 10)
        count = np.asarray(count, np.float64)
        iters = np.asarray(iters)
        for i, (ci, _, _, _, K, _) in enumerate(chunk):
            results[ci] = (int(iters[i]), count[i, :K])
    return results
