"""Device-resident phase A: k-mer hit generation, diagonal clustering
and LIS chaining as one on-device program.

This is the seeding/chaining half of the reference's alignment stack
(SeqSet.hpp GetHitsFromRead :1071 / GetOverlapsFromHits :1232 /
LongestIncreasingSubsequence :352) re-designed as a batched device
program: the k-mer index is a CSR posting table in HBM, a read chunk is
one padded [R, L] tensor, and every stage — rolling-code probing with
the reference's dedup/skip heuristics, posting expansion, (strand, seq)
bucket statistics, diagonal clustering with dominant-diagonal seed
filtering, the exact LIS state machine, and the chain span accounting —
runs as dense vector ops, multi-key sorts, and short scans over the
whole chunk at once.  No per-read host control flow, no per-descriptor
round trips: reads go up once, verdicts come back as one bool per read.

The first consumer is the extraction screen (reference HasHitInSet,
SeqSet.hpp:1915-1990): the device owns ALL of phase A for that stage
and returns the exact accept/reject decision.  Reads whose hit volume
exceeds the static device caps are flagged `undecided` and re-screened
by the native engine — the caps are sized so that is rare, and the
combined output is byte-identical to the host screen by construction.

Bit-exactness contract (verified against the native engine, which is
fuzz-verified against the reference binaries):
  * posting-table construction reproduces KmerIndex::BuildIndexFromRead's
    consecutive-duplicate dedup including its two boundary quirks
    (KmerIndex.hpp:107-130): the first window is skipped when its code
    equals the empty rolling state 0, the offset-1 window always inserts;
  * probing reproduces GetHitsFromRead's per-strand scan: rolling codes
    carry N as bit pattern 3 with a separate validity window, duplicate
    consecutive codes are probed once, and >=100-posting k-mers are
    skipped up to k/2 times in a row without updating the dedup state
    (SeqSet.hpp:1081-1119 and the engine's contract note);
  * the best (strand, seq) bucket is the first strictly-largest group in
    bucket order (strand -1 first, then seq ascending);
  * clustering sorts by (diagonal, seqOff, readOff), splits segments at
    diagonal gaps > radius, picks the first maximal equal-diagonal run
    as the dominant diagonal, keeps per read-offset the seeds nearest
    it, and chains with the reference's exact patience-LIS tie rules
    (equal tails never replace, chain = backtrack from the last top);
  * TotalSpan counts k-mer coverage with gap breaks > k-1 on both axes
    (SeqSet.hpp:1556-1592) and the screen accepts when
    len - matchCnt/2 <= int(len*(1-similarity)) * k.

All device arithmetic is int32 (multi-key sorts instead of packed
keys), so the program is exact under JAX's default 32-bit mode on
every backend.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..utils import jaxcache as _jaxcache

_jaxcache.enable()

import jax
import jax.numpy as jnp


I32MAX = np.int32(np.iinfo(np.int32).max)
I32MIN = np.int32(np.iinfo(np.int32).min)
_DIRECT_MAX_K = 12      # 4^12+1 int32 CSR offsets = 64MB HBM
_MIN_HIT_REQUIRED = 3   # SeqSet.hpp minHitRequired


# --------------------------------------------------------------- table build

@dataclass
class PhaseAIndex:
    """CSR k-mer posting table in device memory.

    k <= 12 direct-addresses `starts` by the 2-bit code (one gather per
    probe); larger k uses an open-addressed table of the distinct codes
    with an exact probe bound computed at build time: `max_probe` is the
    worst insertion displacement, so present keys provably resolve, and
    absent keys are correct at ANY probe count (the final slot either
    mismatches or is empty)."""

    k: int
    n_seqs: int
    max_seq_len: int
    post_seq: jnp.ndarray    # int32 [P]
    post_off: jnp.ndarray    # int32 [P]
    direct: bool
    starts: jnp.ndarray      # direct: int32 [4^k+1]
    keys: jnp.ndarray        # hashed: uint32 [S]  (0xFFFFFFFF = empty)
    hstart: jnp.ndarray      # hashed: int32 [S]
    hcount: jnp.ndarray      # hashed: int32 [S]
    hsize: int
    max_probe: int

    @classmethod
    def build(cls, packed, k: int) -> "PhaseAIndex":
        # 0xFFFFFFFF is the hashed-table empty sentinel, so the all-T
        # k=16 code cannot be represented: the effective ceiling is 15.
        assert k <= 15, "phase-A codes are uint32 with an empty sentinel (k <= 15)"
        max_len = int(packed.seq_lens.max()) if packed.n else 0
        assert max_len < 1 << 20, "diagonal packing assumes seq len < 1M"
        all_codes = []
        all_seq = []
        all_off = []
        pows = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
        for s in range(packed.n):
            start = int(packed.seq_starts[s])
            ln = int(packed.seq_lens[s])
            if ln < k:
                continue
            codes = packed.seq_codes[start:start + ln].astype(np.int64)
            win = np.lib.stride_tricks.sliding_window_view(codes, k)
            valid = (win < 4).all(axis=1)
            vals = (np.minimum(win, 3) * pows).sum(axis=1)
            # KmerIndex.hpp:107-130 insertion rule incl. boundary quirks
            w = len(vals)
            keep = valid.copy()
            keep[0] &= vals[0] != 0          # first window: skip code 0
            if w > 2:                        # offset 1 always inserts;
                keep[2:] &= vals[2:] != vals[1:-1]  # others dedup vs prev
            idx = np.nonzero(keep)[0]
            all_codes.append(vals[idx].astype(np.uint32))
            all_seq.append(np.full(len(idx), s, np.int32))
            all_off.append(idx.astype(np.int32))
        if all_codes:
            codes = np.concatenate(all_codes)
            seqs = np.concatenate(all_seq)
            offs = np.concatenate(all_off)
        else:
            codes = np.zeros(0, np.uint32)
            seqs = np.zeros(0, np.int32)
            offs = np.zeros(0, np.int32)
        order = np.argsort(codes, kind="stable")  # per-code insertion order
        codes, seqs, offs = codes[order], seqs[order], offs[order]
        if len(seqs) == 0:  # keep gathers in-bounds for an empty panel
            seqs = np.zeros(1, np.int32)
            offs = np.zeros(1, np.int32)

        # Canonicalize every panel-dependent compile-cache dimension to a
        # power-of-two TIER so panels of similar scale share compiled
        # programs (a DB version bump must not force recompiles).
        # - n_seqs pads the group axis: padding groups own no postings,
        #   so they never win a bucket and never decode into results;
        #   group ORDER (rev block before fwd, seq ascending within) is
        #   preserved, so min-index tie-breaks are unchanged.
        # - post_seq/post_off pad with zeros: flat slots past a chunk's
        #   hit total are masked by `valid` before use.
        n_pad = 32
        while n_pad < packed.n:
            n_pad *= 2
        p_pad = 1 << max(int(len(seqs) - 1).bit_length(), 5)
        seqs = np.concatenate([seqs, np.zeros(p_pad - len(seqs), np.int32)])
        offs = np.concatenate([offs, np.zeros(p_pad - len(offs), np.int32)])

        empty = jnp.zeros(0, np.int32)
        if k <= _DIRECT_MAX_K:
            starts = np.zeros(4 ** k + 1, np.int64)
            np.add.at(starts, codes.astype(np.int64) + 1, 1)
            starts = np.cumsum(starts).astype(np.int32)
            return cls(k=k, n_seqs=n_pad, max_seq_len=max_len,
                       post_seq=jnp.asarray(seqs), post_off=jnp.asarray(offs),
                       direct=True, starts=jnp.asarray(starts),
                       keys=empty, hstart=empty, hcount=empty,
                       hsize=1, max_probe=1)
        assert k <= 15, "hashed keys reserve 0xFFFFFFFF as empty"
        uniq, first, counts = np.unique(codes, return_index=True,
                                        return_counts=True)
        n = max(len(uniq), 1)
        size = 1
        while size < 4 * n:
            size *= 2
        mask = size - 1
        keys = np.full(size, 0xFFFFFFFF, np.uint32)
        hstart = np.zeros(size, np.int32)
        hcount = np.zeros(size, np.int32)
        # Vectorized parallel insertion: any insertion order produces a
        # valid open-addressing layout (each key sits on its own probe
        # chain before any empty slot), so rounds of claim-and-advance
        # replace the sequential loop.  max_probe = worst displacement.
        key64 = uniq.astype(np.int64)
        h = (key64 * 2654435761) & mask
        step = ((key64 >> 15) | 1) & mask | 1
        unres = np.arange(len(uniq))
        max_probe = 0
        while len(unres):
            max_probe += 1
            hh = h[unres]
            free = keys[hh] == 0xFFFFFFFF
            cand = unres[free]
            keys[h[cand]] = cand.astype(np.uint32)  # stash idx; last wins
            won = cand[keys[h[cand]] == cand]
            keys[h[won]] = uniq[won]
            hstart[h[won]] = first[won]
            hcount[h[won]] = counts[won]
            lost = np.setdiff1d(unres, won, assume_unique=True)
            h[lost] = (h[lost] + step[lost]) & mask
            unres = lost
        # canonicalize the probe bound too (absent keys stay correct at
        # ANY probe count; present keys resolve within the real bound)
        mp_pad = 1
        while mp_pad < max_probe:
            mp_pad *= 2
        return cls(k=k, n_seqs=n_pad, max_seq_len=max_len,
                   post_seq=jnp.asarray(seqs), post_off=jnp.asarray(offs),
                   direct=False, starts=jnp.zeros(1, np.int32),
                   keys=jnp.asarray(keys), hstart=jnp.asarray(hstart),
                   hcount=jnp.asarray(hcount), hsize=size,
                   max_probe=mp_pad)


# ------------------------------------------------------------ window probing

def _window_codes(codes: jnp.ndarray, k: int):
    """[rows, L] int32 base codes -> ([rows, W] uint32 window codes with
    N as bit pattern 3 — the rolling-code dedup state — and validity)."""
    rows, L = codes.shape
    W = L - k + 1
    acc = jnp.zeros((rows, W), jnp.uint32)
    invalid = jnp.zeros((rows, W), bool)
    for t in range(k):
        sl = jax.lax.slice(codes, (0, t), (rows, t + W))
        acc = (acc << 2) | jnp.minimum(sl, 3).astype(jnp.uint32)
        invalid |= sl >= 4
    return acc, ~invalid


def _csr_lookup(wcodes, valid, starts, keys, hstart, hcount,
                direct: bool, hsize: int, max_probe: int):
    """Per-window CSR slice: (posting start, count), both [rows, W]."""
    if direct:
        c = wcodes.astype(jnp.int32)
        st = starts[c]
        cnt = starts[c + 1] - st
    else:
        mask = jnp.uint32(hsize - 1)
        h = (wcodes * jnp.uint32(2654435761)) & mask
        step = (((wcodes >> 15) | 1) & mask) | 1

        def body(_, state):
            h, done = state
            hit = keys[h] == wcodes
            emptyslot = keys[h] == jnp.uint32(0xFFFFFFFF)
            nxt = jnp.where(done | hit | emptyslot, h, (h + step) & mask)
            return nxt, done | hit | emptyslot

        h, _ = jax.lax.fori_loop(0, max_probe, body,
                                 (h, jnp.zeros_like(wcodes, bool)))
        found = keys[h] == wcodes
        st = jnp.where(found, hstart[h], 0)
        cnt = jnp.where(found, hcount[h], 0)
    return jnp.where(valid, st, 0), jnp.where(valid, cnt, 0)


def _probe_scan(wcodes, sizes, lens, k: int):
    """GetHitsFromRead's per-strand probe loop (SeqSet.hpp:1081-1119) as
    a scan: dedup against the previous rolling code, skip >=100-posting
    windows up to k/2 consecutive times WITHOUT updating the dedup state
    (the engine's contract quirk), always probe the first and last
    window of the read.  Returns the emit mask [rows, W]."""
    rows, W = wcodes.shape
    skip_limit = k // 2
    last_w = lens - k          # engine i == len-1  <=>  w == len-k

    def step(state, xs):
        prev, skip = state
        w, code, size = xs
        active = (w <= last_w) & (lens >= k)
        considered = active & ((w == 0) | (code != prev))
        skipped = (considered & (size >= 100) & (w != 0) & (w != last_w)
                   & (skip < skip_limit))
        emit = considered & ~skipped & (size > 0)
        skip = jnp.where(~active, skip,
                         jnp.where(skipped, skip + 1,
                                   jnp.where(considered, 0, skip)))
        prev = jnp.where(active & ~skipped, code, prev)
        return (prev, skip), emit

    ws = jnp.arange(W)
    (_, _), emits = jax.lax.scan(
        step,
        (jnp.zeros(rows, jnp.uint32), jnp.zeros(rows, jnp.int32)),
        (ws, wcodes.T, sizes.T))
    return emits.T


# ------------------------------------------------------- segmented helpers

def _seg_scan_last(flag_start, has, val):
    """Segmented copy-scan along axis 1: for each position, the most
    recent (has, val) at a STRICTLY earlier position within the same
    segment (segments delimited by flag_start)."""
    h = jnp.concatenate([jnp.zeros_like(has[:, :1]), has[:, :-1]], axis=1)
    v = jnp.concatenate([jnp.zeros_like(val[:, :1]), val[:, :-1]], axis=1)
    # a segment start consumes nothing from the left — not even t-1
    h = jnp.where(flag_start, False, h)

    def combine(x, y):
        xf, xh, xv = x
        yf, yh, yv = y
        return (xf | yf,
                jnp.where(yf, yh, yh | xh),
                jnp.where(yf | yh, yv, xv))

    _, oh, ov = jax.lax.associative_scan(combine, (flag_start, h, v), axis=1)
    return oh, ov


def _segment_reduce(values, seg_ids, num, op="sum"):
    """Flat segmented reduction over [R, C] with per-row segment ids in
    [0, num)."""
    R, C = values.shape
    flat_ids = (jnp.arange(R)[:, None] * num + seg_ids).reshape(-1)
    flat = values.reshape(-1)
    if op == "sum":
        out = jax.ops.segment_sum(flat, flat_ids, num_segments=R * num)
    elif op == "max":
        out = jax.ops.segment_max(flat, flat_ids, num_segments=R * num)
    else:
        raise ValueError(op)
    return out.reshape(R, num)


# ------------------------------------------------------------ the kernels
#
# Two-phase execution so device work scales with the ACTUAL posting
# volume of each chunk rather than a per-read worst case: the probe
# kernel computes per-window posting slices and the chunk's hit total
# (the only scalar that returns to the host); the chain kernel then
# expands postings into a FLAT hit arena sized by a small ladder of
# static capacities.  Off-target-dominated chunks (the real extraction
# regime) land in the smallest tier and cost little more than the table
# probes; saturated on-target chunks use a larger tier.  The [R, W2]
# intermediates stay device-resident between the two dispatches.


@functools.partial(
    jax.jit, static_argnames=("k", "direct", "hsize", "max_probe"))
def _probe_kernel(codes, lens, starts, keys, hstart, hcount,
                  k: int, direct: bool, hsize: int, max_probe: int):
    """Windows, CSR lookups and the probe dedup/skip scan.

    Returns ([R, 2W] contrib/cstart with fwd then rc windows, tot [R])."""
    R, L = codes.shape
    codes = codes.astype(jnp.int32)

    # rc read left-aligned like the engine
    j = lens[:, None] - 1 - jnp.arange(L, dtype=jnp.int32)[None, :]
    rc_base = jnp.take_along_axis(codes, jnp.maximum(j, 0), axis=1)
    rc_codes = jnp.where(j >= 0,
                         jnp.where(rc_base < 4, 3 - rc_base, rc_base), 4)

    stacked = jnp.concatenate([codes, rc_codes], axis=0)        # [2R, L]
    wc, wvalid = _window_codes(stacked, k)                      # [2R, W]
    cstart, csize = _csr_lookup(wc, wvalid, starts, keys, hstart, hcount,
                                direct, hsize, max_probe)
    emit = _probe_scan(wc, csize, jnp.tile(lens, 2), k)

    def halves(x):  # [2R, W] -> [R, 2W]  (fwd windows then rc windows)
        return jnp.concatenate([x[:R], x[R:]], axis=1)

    contrib = halves(jnp.where(emit, csize, 0))
    cstart = halves(cstart)
    return contrib, cstart, contrib.sum(axis=1)


def _fill_last(flag, val, fill=0):
    """1-D forward fill: at each position, the most recent `val` where
    `flag` was set (or `fill` before the first)."""
    _, out = jax.lax.associative_scan(
        lambda x, y: (x[0] | y[0], jnp.where(y[0], y[1], x[1])),
        (flag, jnp.where(flag, val, fill)))
    return out


@functools.partial(
    jax.jit,
    static_argnames=("k", "n_seqs", "radius", "hit_len_required",
                     "cap", "bucket_cap"))
def _chain_kernel(contrib, cstart, lens, budgets, post_seq, post_off,
                  k: int, n_seqs: int, radius: int,
                  hit_len_required: int, cap: int, bucket_cap: int):
    """Flat posting expansion, bucket selection, diagonal clustering,
    LIS chaining and the screen decision.  The wrapper guarantees the
    chunk's hit total fits `cap`.

    Returns (verdict bool [R], decided bool [R])."""
    R, W2 = contrib.shape
    W = W2 // 2

    # ---- flat CSR expansion: scatter each emitting window's id at its
    # output offset, forward-fill, and derive (read, window, posting)
    # per flat slot — work and memory scale with the chunk's hit volume
    flatc = contrib.reshape(-1)
    ends = jnp.cumsum(flatc)
    tot_all = ends[-1]
    startf = ends - flatc
    emitf = flatc > 0
    wid = jnp.arange(R * W2, dtype=jnp.int32)
    tgt = jnp.where(emitf, startf, cap)
    scat = lambda v: jnp.zeros(cap + 1, jnp.int32).at[tgt].set(v)[:cap]
    w = jax.lax.cummax(scat(wid))        # window ids ascend with offset
    q = _fill_last(scat(emitf.astype(jnp.int32)).astype(bool),
                   scat(cstart.reshape(-1) - startf))
    slot = jnp.arange(cap, dtype=jnp.int32)
    valid = slot < tot_all
    r = w // W2
    woff = w % W2
    is_fwd = woff < W
    roff = jnp.where(is_fwd, woff, woff - W)
    pidx = jnp.clip(q + slot, 0, post_seq.shape[0] - 1)
    seq = jnp.where(valid, post_seq[pidx], 0)

    # ---- best (strand, seq) bucket per read: strand -1 first, then seq
    # ascending; counting via one segment-sum, no sort of the hit arena
    B = bucket_cap
    NG = 2 * n_seqs + 1
    lkey = seq + jnp.where(is_fwd, n_seqs, 0)
    gcnt = jax.ops.segment_sum(
        valid.astype(jnp.int32), r * NG + jnp.where(valid, lkey, 2 * n_seqs),
        num_segments=R * NG).reshape(R, NG)
    best_len = gcnt[:, :2 * n_seqs].max(axis=1, initial=0)
    best_key = jnp.where(
        gcnt[:, :2 * n_seqs] == best_len[:, None],
        jnp.arange(2 * n_seqs, dtype=jnp.int32)[None, :],
        2 * n_seqs).min(axis=1, initial=2 * n_seqs)
    pass0 = (best_len * k >= hit_len_required) & (best_len > 0)
    decided = best_len <= B

    # ---- compact the winning bucket onto the [R, B] chaining axis
    inb = valid & (lkey == best_key[r])
    base = jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         jnp.cumsum(jax.ops.segment_sum(inb.astype(jnp.int32), r,
                                        num_segments=R))[:-1]])
    tpos = jnp.cumsum(inb.astype(jnp.int32)) - 1 - base[r]
    btgt = jnp.where(inb & (tpos < B), tpos, B)
    rows = jnp.arange(R)[:, None]
    a = jnp.zeros((R, B + 1), jnp.int32).at[r, btgt].set(
        jnp.where(inb, roff, 0))[:, :B]
    bpidx = jnp.zeros((R, B + 1), jnp.int32).at[r, btgt].set(
        jnp.where(inb, pidx, 0))[:, :B]
    b = post_off[bpidx]
    nb = jnp.minimum(best_len, B)

    seg_core, seg_budget = _chain_rows(a, b, nb, lens, budgets, k=k,
                                       radius=radius,
                                       hit_len_required=hit_len_required)
    verdict = pass0 & (seg_core & seg_budget).any(axis=1)
    return verdict, decided


def _chain_rows(a, b, nb, lens, budgets, *, k: int, radius: int,
                hit_len_required: int):
    """The exact per-bucket chain state machine on a dense [NR, B] seed
    tile: diagonal clustering (radius gaps), dominant-diagonal seed
    dedupe, reference patience-LIS, TotalSpan on both axes, and the
    per-segment keep filters (engine.cc BuildOverlaps; reference
    SeqSet.hpp:1232-1556).  Row r holds one (read, strand, seq) bucket's
    seeds (a=readOff, b=seqOff), the first nb[r] columns valid; input
    order within a row is irrelevant (the cluster sort normalizes).

    Returns per-SEGMENT masks ([NR, B+1]):
      seg_core    the four conditions every overlap-emitting segment
                  meets (size >= 3, size*k >= hitLen, lis*k >= hitLen,
                  spans >= hitLen on both axes) — a bucket emits >= 1
                  overlap in the assignment path iff seg_core.any()
      seg_budget  the screen's extra mismatch-budget test
                  (lens - span_a <= budgets); HasHitInSet accepts iff
                  (seg_core & seg_budget).any()
    """
    NR, B = a.shape
    pos = jnp.arange(B, dtype=jnp.int32)[None, :]
    rows = jnp.arange(NR)[:, None]
    mv = pos < nb[:, None]

    # ---- diagonal sort of the bucket: (c, b, a) ascending
    c = a - b
    sk = lambda x: jnp.where(mv, x, I32MAX)
    c, b, a = jax.lax.sort((sk(c), sk(b), sk(a)), dimension=1, num_keys=3)
    m = c < I32MAX

    # ---- segments: diagonal gap > radius starts a new one
    prev_c = jnp.concatenate([c[:, :1], c[:, :-1]], axis=1)
    newseg = m & ((pos == 0) | (c - prev_c > radius))
    seg = jnp.where(m, jnp.cumsum(newseg.astype(jnp.int32), axis=1) - 1, B)
    NSEG = B + 1

    # ---- dominant diagonal per segment: first maximal equal-c run
    newrun = m & (newseg | (c != prev_c))
    run_first = jax.lax.cummax(jnp.where(newrun, pos, 0), axis=1)
    run_id = jnp.where(m, jnp.cumsum(newrun.astype(jnp.int32), axis=1) - 1,
                       B)
    run_len = _segment_reduce(m.astype(jnp.int32), run_id, NSEG)
    rlen = jnp.take_along_axis(run_len, run_id, axis=1)
    # maximize (run length, earliest run): fits int32 for B <= 2^15
    dom_pack = jnp.where(m, rlen * (B + 1) + (B - run_first), 0)
    seg_dom = _segment_reduce(dom_pack, seg, NSEG, op="max")
    is_dom = m & (dom_pack == jnp.take_along_axis(seg_dom, seg, axis=1))
    dom_c = _segment_reduce(jnp.where(is_dom, c, I32MIN), seg, NSEG,
                            op="max")
    seg_sz = _segment_reduce(m.astype(jnp.int32), seg, NSEG)

    # ---- offsetBest: keep seeds nearest the dominant diagonal per read
    # offset (SeqSet.hpp:1412-1448), then order by (b, a) for the LIS
    d = jnp.abs(a - b - jnp.take_along_axis(dom_c, seg, axis=1))
    if radius > 0:
        sk3 = lambda x: jnp.where(m, x, I32MAX)
        seg3, a3, d3, b3 = jax.lax.sort(
            (sk3(seg), sk3(a), sk3(d), sk3(b)), dimension=1, num_keys=3)
        m3 = seg3 < I32MAX
        grp_start = m3 & ((pos == 0) | (seg3 != jnp.concatenate(
            [seg3[:, :1], seg3[:, :-1]], axis=1)) | (a3 != jnp.concatenate(
                [a3[:, :1] - 1, a3[:, :-1]], axis=1)))
        # first element of each (seg, a) group carries min d; propagate
        _, mind = jax.lax.associative_scan(
            lambda x, y: (x[0] | y[0], jnp.where(y[0], y[1], x[1])),
            (grp_start | ~m3, d3), axis=1)
        keep = m3 & (d3 == mind)
        a, b, seg = a3, b3, seg3
    else:
        keep = m
    sk4 = lambda x: jnp.where(keep, x, I32MAX)
    seg, b, a = jax.lax.sort((sk4(seg), sk4(b), sk4(a)), dimension=1,
                             num_keys=3)
    ml = seg < I32MAX
    a = jnp.where(ml, a, 0)
    b = jnp.where(ml, b, 0)
    seg = jnp.where(ml, seg, B)
    posl = pos
    segstart = ml & ((posl == 0) | (seg != jnp.concatenate(
        [jnp.full_like(seg[:, :1], -1), seg[:, :-1]], axis=1)))

    # ---- exact reference LIS (SeqSet.hpp:352-436): scan the patience
    # state; equal tails never replace; chain ends at the last top
    def lis_step(state, xs):
        top_v, top_i = state
        t, v, active, reset = xs
        top_v = jnp.where(reset[:, None], I32MAX, top_v)
        top_i = jnp.where(reset[:, None], -1, top_i)
        c_lt = (top_v < v[:, None]).sum(axis=1)
        iseq = ((top_v == v[:, None]) & active[:, None]).any(axis=1)
        do = active & ~iseq
        oh = (posl == c_lt[:, None]) & do[:, None]
        link = jnp.where(
            do & (c_lt > 0),
            jnp.take_along_axis(
                top_i, jnp.maximum(c_lt - 1, 0)[:, None], axis=1)[:, 0],
            -1)
        top_v = jnp.where(oh, v[:, None], top_v)
        top_i = jnp.where(oh, t, top_i)
        ret = (top_v < I32MAX).sum(axis=1)
        chain_end = jnp.take_along_axis(
            top_i, jnp.maximum(ret - 1, 0)[:, None], axis=1)[:, 0]
        chain_end = jnp.where(ret > 0, chain_end, -1)
        return (top_v, top_i), (link, chain_end)

    (_, _), (links, chain_ends) = jax.lax.scan(
        lis_step,
        (jnp.full((NR, B), I32MAX, jnp.int32),
         jnp.full((NR, B), -1, jnp.int32)),
        (jnp.arange(B, dtype=jnp.int32), a.T, ml.T, segstart.T))
    links = links.T                  # [NR, B]
    chain_ends = chain_ends.T

    # ---- backtrack every segment's chain in parallel
    seg_last = ml & ((posl == B - 1) | (jnp.concatenate(
        [seg[:, 1:], jnp.full_like(seg[:, :1], -1)], axis=1) != seg))

    def bt_step(_, state):
        ptr, chosen = state
        valid = ptr >= 0
        chosen = chosen.at[rows, jnp.maximum(ptr, 0)].max(valid)
        nxt = jnp.where(valid, links[rows, jnp.maximum(ptr, 0)], -1)
        return nxt, chosen

    _, chosen = jax.lax.while_loop(
        lambda st: (st[0] >= 0).any(),
        lambda st: bt_step(0, st),
        (jnp.where(seg_last, chain_ends, -1),
         jnp.zeros((NR, B), bool)))
    chosen &= ml

    # ---- collapse duplicate b along each chain (keep the first)
    ph, pb = _seg_scan_last(segstart, chosen, b)
    kept = chosen & ~(ph & (pb == b))

    # ---- spans with gap breaks > k-1 (TotalSpan, both axes)
    kh, ka = _seg_scan_last(segstart, kept, a)
    _, kb = _seg_scan_last(segstart, kept, b)
    ca = jnp.where(kept,
                   jnp.where(~kh, k,
                             jnp.where(a - ka > k - 1, k, a - ka)), 0)
    cb = jnp.where(kept,
                   jnp.where(~kh, k,
                             jnp.where(b - kb > k - 1, k, b - kb)), 0)
    span_a = _segment_reduce(ca, seg, NSEG)
    span_b = _segment_reduce(cb, seg, NSEG)
    lis_sz = _segment_reduce(kept.astype(jnp.int32), seg, NSEG)

    hlr = hit_len_required
    seg_core = ((seg_sz >= _MIN_HIT_REQUIRED)
                & (seg_sz * k >= hlr)
                & (lis_sz * k >= hlr)
                & (span_a >= hlr) & (span_b >= hlr))
    seg_budget = lens[:, None] - span_a <= budgets[:, None]
    return seg_core, seg_budget


class DeviceScreen:
    """Batched exact extraction screen on device (HasHitInSet twin).

    screen(codes [n, L] int8, lens) -> (verdict, decided) — `decided`
    False marks reads whose hit volume overflows the static caps; the
    caller re-screens those on the native engine."""

    _TIER_LADDER = (1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24)

    # Default ceiling 2^20: chunks past it are on-target-dominated, the
    # ones the native re-screen handles quickly and that gain little
    # from bulk device discard; off-target-dominated extraction chunks
    # (the screen's purpose) fit the small tiers.
    def __init__(self, index: PhaseAIndex, hit_len_required: int,
                 ref_sim: float, radius: int = 10,
                 hit_cap: int = 1 << 20, bucket_cap: int = 512,
                 row_chunk: int = 1024):
        assert bucket_cap <= (1 << 15) - 1  # dominant-run int32 packing
        self.index = index
        self.hit_len_required = hit_len_required
        self.ref_sim = ref_sim
        self.radius = radius
        self.bucket_cap = bucket_cap
        self.row_chunk = row_chunk
        # flat-arena capacity ladder, clamped by hit_cap (the ceiling
        # above which a chunk falls back to the native screen)
        self.tiers = sorted({min(hit_cap, t) for t in self._TIER_LADDER})
        self.reads_decided = 0  # reads whose verdict the device decided

    @classmethod
    def build(cls, packed, k: int, hit_len_required: int, ref_sim: float,
              radius: int = 10, **caps) -> "DeviceScreen":
        return cls(PhaseAIndex.build(packed, k), hit_len_required,
                   ref_sim, radius, **caps)

    def screen(self, codes: np.ndarray,
               lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n, L = codes.shape
        if n == 0:
            return np.zeros(0, bool), np.zeros(0, bool)
        idx = self.index
        if L < idx.k:
            # no window fits: the engine rejects every such read
            return np.zeros(n, bool), np.ones(n, bool)
        if L >= 1 << 12:
            # Reads at/above the 4096-length envelope go to the host,
            # but PER READ: the rest of the batch is re-padded to its
            # own max length and screened on device (a single long read
            # must not forfeit the device path for the whole chunk).
            keep = lens < (1 << 12)
            out_v = np.zeros(n, bool)
            out_d = np.zeros(n, bool)
            if keep.any():
                sub_l = lens[keep]
                sub_c = codes[keep][:, :int(sub_l.max())]
                out_v[keep], out_d[keep] = self.screen(sub_c, sub_l)
            return out_v, out_d
        Lp = 64
        while Lp < L:
            Lp *= 2
        # Always the FULL row_chunk rows: the row count is a compile-cache
        # shape key, so padding small inputs up (zero-length rows emit no
        # hits) means one compiled program serves every input size.
        rows = self.row_chunk
        out_v = np.zeros(n, bool)
        out_d = np.zeros(n, bool)
        # Probe/chain software pipeline with a BOUNDED in-flight window:
        # each chunk's probe leaves [rows, 2W] contrib/cstart resident on
        # device until its chain consumes them, so dispatching every
        # probe up front holds O(n/rows) such arenas at once (multiple
        # GB of HBM at the default 65536-read batch near the length
        # envelope).  A small window keeps the probe kernel of chunk
        # i+1..i+K in flight while chunk i's arena total syncs and its
        # chain dispatches, then drops chunk i's intermediates.
        MAX_INFLIGHT = 4
        probes: list = []
        chains = []

        def _drain_one():
            lo, hi, pl, budgets, contrib, cstart, tot = probes.pop(0)
            # size the chunk's flat hit arena from its measured total
            # ([R, 2W] intermediates never leave the device); a chunk
            # past the last tier falls back to the native screen whole
            tot_all = int(np.asarray(tot).sum())
            cap = next((t for t in self.tiers if tot_all <= t), None)
            if cap is None:
                return
            v, d = _chain_kernel(
                contrib, cstart, jnp.asarray(pl), jnp.asarray(budgets),
                idx.post_seq, idx.post_off,
                k=idx.k, n_seqs=idx.n_seqs, radius=self.radius,
                hit_len_required=self.hit_len_required,
                cap=cap, bucket_cap=self.bucket_cap)
            chains.append((lo, hi, v, d))

        for lo in range(0, n, rows):
            hi = min(lo + rows, n)
            pc = np.full((rows, Lp), 4, np.int8)
            pc[:hi - lo, :L] = codes[lo:hi]
            pl = np.zeros(rows, np.int32)
            pl[:hi - lo] = lens[lo:hi]
            # int(len * (1 - s)) truncates in C++ double arithmetic; keep
            # the budget computation in host f64 (SeqSet.hpp:1973-1978)
            budgets = (np.trunc(pl.astype(np.float64)
                                * (1.0 - self.ref_sim))
                       .astype(np.int32) * idx.k)
            contrib, cstart, tot = _probe_kernel(
                jnp.asarray(pc), jnp.asarray(pl),
                idx.starts, idx.keys, idx.hstart, idx.hcount,
                k=idx.k, direct=idx.direct, hsize=idx.hsize,
                max_probe=idx.max_probe)
            probes.append((lo, hi, pl, budgets, contrib, cstart, tot))
            if len(probes) >= MAX_INFLIGHT:
                _drain_one()
        while probes:
            _drain_one()
        for lo, hi, v, d in chains:
            out_v[lo:hi] = np.asarray(v)[:hi - lo]
            out_d[lo:hi] = np.asarray(d)[:hi - lo]
        self.reads_decided += int(out_d.sum())
        return out_v, out_d


# ----------------------------------------------------- candidate generation
#
# Phase-A-lite for the GENOTYPER stage: the device evaluates, per
# (read, strand, seq) bucket, the exact pre-DP chain filters of the
# assignment path (engine.cc BuildOverlaps; SeqSet.hpp:1232-1556) and
# returns the set of buckets that emit at least one overlap — the
# host engine then only collects/chains hits for surviving buckets.
# Unlike the extraction screen (one best bucket per read), EVERY bucket
# becomes a chain row: the census kernel sorts the flat hit arena by
# bucket and the tile kernel runs the shared _chain_rows state machine
# on dense [TR, B] bucket tiles.


@functools.partial(jax.jit, static_argnames=("n_seqs", "cap"))
def _cand_census_kernel(contrib, cstart, post_seq, post_off,
                        n_seqs: int, cap: int):
    """Flat posting expansion + bucket sort.

    Returns per-slot arrays sorted by bucket key gk = r * NG + lkey
    (I32MAX for empty slots): (gk_s, a_s, b_s, bid, within, nb_total)
    where bid is the dense bucket index and `within` the slot's rank
    inside its bucket."""
    R, W2 = contrib.shape
    W = W2 // 2
    flatc = contrib.reshape(-1)
    ends = jnp.cumsum(flatc)
    tot_all = ends[-1]
    startf = ends - flatc
    emitf = flatc > 0
    wid = jnp.arange(R * W2, dtype=jnp.int32)
    tgt = jnp.where(emitf, startf, cap)
    scat = lambda v: jnp.zeros(cap + 1, jnp.int32).at[tgt].set(v)[:cap]
    w = jax.lax.cummax(scat(wid))
    q = _fill_last(scat(emitf.astype(jnp.int32)).astype(bool),
                   scat(cstart.reshape(-1) - startf))
    slot = jnp.arange(cap, dtype=jnp.int32)
    valid = slot < tot_all
    r = w // W2
    woff = w % W2
    is_fwd = woff < W
    roff = jnp.where(is_fwd, woff, woff - W)
    pidx = jnp.clip(q + slot, 0, post_seq.shape[0] - 1)
    seq = jnp.where(valid, post_seq[pidx], 0)
    soff = jnp.where(valid, post_off[pidx], 0)

    NG = 2 * n_seqs
    lkey = seq + jnp.where(is_fwd, n_seqs, 0)
    gk = jnp.where(valid, r * NG + lkey, I32MAX)
    gk_s, a_s, b_s = jax.lax.sort((gk, roff, soff), dimension=0, num_keys=1)
    pos = slot
    mvalid = gk_s < I32MAX
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), gk_s[:-1]])
    newb = mvalid & (gk_s != prev)
    bid = jnp.where(mvalid, jnp.cumsum(newb.astype(jnp.int32)) - 1, I32MAX)
    bstart = _fill_last(newb, pos)
    within = jnp.where(mvalid, pos - bstart, 0)
    return gk_s, a_s, b_s, bid, within, newb.sum()


@functools.partial(
    jax.jit,
    static_argnames=("TR", "B", "k", "n_seqs", "radius",
                     "hit_len_required"))
def _cand_tile_kernel(gk_s, a_s, b_s, bid, within, lens, tile_start,
                      TR: int, B: int, k: int, n_seqs: int, radius: int,
                      hit_len_required: int):
    """Chain one tile of TR buckets: scatter the tile's slots into a
    dense [TR, B] seed block and run the shared chain state machine.

    Returns (keep [TR], read [TR], lkey [TR], nb [TR], over [TR]):
    `keep` marks buckets whose chain emits >= 1 overlap; `over` marks
    buckets whose hit count exceeds B (the caller falls back to the
    host for those reads)."""
    cap = gk_s.shape[0]
    sel = (bid >= tile_start) & (bid < tile_start + TR)
    row = jnp.where(sel, bid - tile_start, TR)
    over_slot = sel & (within >= B)
    tgt_r = jnp.where(sel & ~over_slot, row, TR)
    tgt_c = jnp.where(sel & ~over_slot, within, B)
    A = jnp.zeros((TR + 1, B + 1), jnp.int32).at[tgt_r, tgt_c].set(
        jnp.where(sel, a_s, 0))[:TR, :B]
    Bm = jnp.zeros((TR + 1, B + 1), jnp.int32).at[tgt_r, tgt_c].set(
        jnp.where(sel, b_s, 0))[:TR, :B]
    cnt = jax.ops.segment_sum(sel.astype(jnp.int32), row,
                              num_segments=TR + 1)[:TR]
    nonempty = cnt > 0
    # segment_max fills empty segments with int32 min: mask them out
    over = nonempty & (jax.ops.segment_max(
        over_slot.astype(jnp.int32), row, num_segments=TR + 1)[:TR] > 0)
    rowgk = jnp.where(nonempty, jax.ops.segment_max(
        jnp.where(sel, gk_s, 0), row, num_segments=TR + 1)[:TR], 0)
    NG = 2 * n_seqs
    read = rowgk // NG
    lkey = rowgk % NG
    nb = jnp.minimum(cnt, B)
    lens_row = lens[jnp.clip(read, 0, lens.shape[0] - 1)]
    seg_core, _ = _chain_rows(A, Bm, nb, lens_row,
                              jnp.zeros_like(lens_row), k=k, radius=radius,
                              hit_len_required=hit_len_required)
    keep = seg_core.any(axis=1) & ~over & (cnt > 0)
    return keep, read, lkey, nb, over


class DeviceCandidates:
    """Per-read candidate (strand, seq) generation on device.

    generate(codes [n, L], lens) -> (reads, seqs, strands, undecided):
    flat arrays of the surviving buckets (exactly the buckets whose
    chains emit >= 1 overlap in the host assignment path), plus a bool
    [n] marking reads the device could not decide (hit-volume or
    bucket-size overflow) — the caller runs those reads unpruned."""

    _TIER_LADDER = (1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24)

    def __init__(self, index: PhaseAIndex, hit_len_required: int,
                 radius: int = 10, hit_cap: int = 1 << 24,
                 bucket_cap: int = 128, row_chunk: int = 1024,
                 tile_rows: int = 16384):
        self.index = index
        self.hit_len_required = hit_len_required
        self.radius = radius
        self.bucket_cap = bucket_cap
        self.row_chunk = row_chunk
        self.tile_rows = tile_rows
        self.tiers = sorted({min(hit_cap, t) for t in self._TIER_LADDER})

    @classmethod
    def build(cls, packed, k: int, hit_len_required: int,
              **caps) -> "DeviceCandidates":
        return cls(PhaseAIndex.build(packed, k), hit_len_required, **caps)

    def generate(self, codes: np.ndarray, lens: np.ndarray):
        n, L = codes.shape
        reads_out, seqs_out, strands_out = [], [], []
        undecided = np.zeros(n, bool)
        if n == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.int8), undecided)
        idx = self.index
        if L < idx.k or L >= 1 << 12:
            undecided[:] = True
            return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.int8), undecided)
        Lp = 64
        while Lp < L:
            Lp *= 2
        rows = self.row_chunk  # full chunk rows: one variant per shape class
        NG = 2 * idx.n_seqs
        for lo in range(0, n, rows):
            hi = min(lo + rows, n)
            pc = np.full((rows, Lp), 4, np.int8)
            pc[:hi - lo, :L] = codes[lo:hi]
            pl = np.zeros(rows, np.int32)
            pl[:hi - lo] = lens[lo:hi]
            contrib, cstart, tot = _probe_kernel(
                jnp.asarray(pc), jnp.asarray(pl),
                idx.starts, idx.keys, idx.hstart, idx.hcount,
                k=idx.k, direct=idx.direct, hsize=idx.hsize,
                max_probe=idx.max_probe)
            tot_all = int(np.asarray(tot).sum())
            cap = next((t for t in self.tiers if tot_all <= t), None)
            if cap is None:
                undecided[lo:hi] = True
                continue
            gk_s, a_s, b_s, bid, within, nb_total = _cand_census_kernel(
                contrib, cstart, idx.post_seq, idx.post_off,
                n_seqs=idx.n_seqs, cap=cap)
            nb_total = int(nb_total)
            pl_d = jnp.asarray(pl)
            for ts in range(0, nb_total, self.tile_rows):
                keep, read, lkey, nb, over = _cand_tile_kernel(
                    gk_s, a_s, b_s, bid, within, pl_d,
                    jnp.int32(ts), TR=self.tile_rows, B=self.bucket_cap,
                    k=idx.k, n_seqs=idx.n_seqs, radius=self.radius,
                    hit_len_required=self.hit_len_required)
                keep = np.asarray(keep)
                read = np.asarray(read)
                lkey = np.asarray(lkey)
                over = np.asarray(over)
                if over.any():
                    undecided[lo + read[over]] = True
                if keep.any():
                    reads_out.append(lo + read[keep].astype(np.int64))
                    is_fwd = lkey[keep] >= idx.n_seqs
                    seqs_out.append(np.where(
                        is_fwd, lkey[keep] - idx.n_seqs,
                        lkey[keep]).astype(np.int32))
                    strands_out.append(
                        np.where(is_fwd, 1, -1).astype(np.int8))
        if reads_out:
            reads = np.concatenate(reads_out)
            seqs = np.concatenate(seqs_out)
            strands = np.concatenate(strands_out)
        else:
            reads = np.zeros(0, np.int64)
            seqs = np.zeros(0, np.int32)
            strands = np.zeros(0, np.int8)
        # drop buckets of undecided reads (the host recomputes them)
        if undecided.any() and len(reads):
            m = ~undecided[reads]
            reads, seqs, strands = reads[m], seqs[m], strands[m]
        return reads, seqs, strands, undecided
