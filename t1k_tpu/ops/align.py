"""Banded affine-gap global alignment on device: scores and traceback
counts for batches of (text, pattern) pairs.

Scoring contract of the native engine and the reference aligner
(AlignAlgo.hpp:215-421): match 2 / mismatch -2 / gap open -4 / extend -1,
band 5 widened by the length difference, N matches everything, boundary
quirks preserved.  The match/mismatch/indel counts along the optimal
traceback follow the walk's exact tie-break rules (engine.cc
BandedGlobalAlignStats), so every result is bit-identical to the host
engine (tested).

Layout: each pair's DP state lives in band-window coordinates
w = j - i + ML, so one DP row of the whole batch is W per-slot [B]
int32 vectors (W = 32 covers every deferrable item), and a
lax.fori_loop walks the pattern rows.  In w-space the diagonal
move needs no shift and the vertical move comes from the neighbouring
slot.  The horizontal affine chain decouples: writing H = max(diag, E),
F[j] = GO + GE*j + max_{k<j}(H[k] - GE*k) is a running max over the
slots.  Traceback counts propagate forward with the walk's local rules,
so no direction bits and no traceback pass are needed.

On the H100 the device time of this program hides under the host's
half of the deferred assignment, so a hand-written kernel did not pay
end to end (see PERF.md).
"""

from __future__ import annotations

import functools
import hashlib

from ..utils import jaxcache as _jaxcache

_jaxcache.enable()

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

SCORE_MATCH = 2
SCORE_MISMATCH = -2
GO = -4
GE = -1
NEG_INF = -(1 << 24)

# Packed traceback-stat counters: match in bits 0-8, mismatch in 9-17,
# indel in 18-26 (a field never exceeds t_len+p_len+2 < 512 for the
# supported shapes).  One int32 carries all three through the fill.
MU = 1
XU = 1 << 9
IU = 1 << 18


def _band_dp(t_pad, t_lens, p_pad, p_lens, *, ML: int, W: int, Lp: int):
    """Scores and packed traceback counts of a batch.

    t_pad [B, Lt_pad] int8: each text shifted right by ML+1 columns
    (t_pad[:, ML+1+j] = t[j]), with Lt_pad >= Lp + W.  p_pad [B, >=Lp]
    int8 patterns.  The state of window slot w is one [B] vector per
    matrix (m, e and their packed counts), so a shift along the window
    is a change of list index, the two in-window scans are running
    sequences over the slots, and every operation is elementwise across
    pairs.  Returns (score [B], packed counts [B]) int32."""
    tT, pT = t_pad.T, p_pad.T  # padded column r of every pair is row r

    def text_row(r):
        return lax.dynamic_index_in_dim(tT, r, 0, keepdims=False)

    def pat_row(r):
        return lax.dynamic_index_in_dim(pT, r, 0, keepdims=False)

    tl = t_lens.astype(jnp.int32)
    pl = p_lens.astype(jnp.int32)
    diff = tl - pl
    left = 5 + jnp.maximum(-diff, 0)
    right = 5 + jnp.maximum(diff, 0)
    # derived from the inputs, so that under shard_map the loop carry is
    # as device-varying as the rows it is combined with
    zero = tl * 0
    neg = zero + NEG_INF
    slots = range(W)
    # with j = i + w - ML, the band test j in [i-left, i+right] is a
    # bound on w alone
    wband = [(w >= ML - left) & (w <= ML + right) for w in slots]
    wfin = [w == ML + diff for w in slots]  # slot holding m[lenp][lent]

    # row 0, including the reference walk's boundary behaviour
    # (AlignAlgo.hpp:379-400): along the top row the delete run costs j
    # indels, plus one spurious insert when the insert matrix dominates
    # (j > 4*(lenp+1) with these scores); an insert run reaching the top
    # row costs one extra op
    m0, e0, pm0, pe0 = [], [], [], []
    for w in slots:
        j = w - ML
        in_row0 = (j >= 1) & (j <= tl)
        m0.append(zero if j == 0 else jnp.where(in_row0, GO + j * GO, neg))
        e0.append(zero if j == 0 else
                  jnp.where(in_row0, GO + (pl + 1) * GO, neg))
        pm0.append(zero if j == 0 else
                   j * IU + jnp.where(j * GE >= (pl + 1) * GO, 0, IU))
        pe0.append(zero + (0 if j == 0 else (j + 1) * IU))

    def body(i, carry):
        m_prev, e_prev, pm_prev, pe_prev, score, stat = carry
        p_base = pat_row(i - 1)
        p_n = p_base == 4
        m0_i = GO + i * GO
        start_le1 = left >= i - 1  # start = max(i-left, 1) <= 1
        active = i <= pl
        sub = []
        for w in slots:
            t = text_row(i + w)
            sub.append(jnp.where((t == p_base) | (t == 4) | p_n,
                                 SCORE_MATCH, SCORE_MISMATCH))

        # scores: e comes down from slot w+1 of the previous row; f is the
        # exclusive running max of u over the slots to the left
        m_cur, e_cur, f_all, col0_all = [], [], [], []
        run = None
        for w in slots:
            j = i + (w - ML)
            col0 = j == 0
            e = (jnp.maximum(e_prev[w + 1] + GE, m_prev[w + 1] + (GO + GE))
                 if w + 1 < W else neg)
            e = jnp.where(col0, GO + i * GE, e)
            in_band = wband[w] & (j >= 1) & (j <= tl)
            h = jnp.maximum(m_prev[w] + sub[w], e)
            h = jnp.where(col0, m0_i, h)
            h = jnp.where(in_band | (col0 & start_le1), h, NEG_INF)
            # max(m0_i, m0_i - GO) == m0_i - GO since GO < 0
            u = jnp.where(col0, jnp.where(start_le1, m0_i - GO, NEG_INF),
                          h - GE * j)
            f = GO + GE * j + (neg if run is None else run)
            run = u if run is None else jnp.maximum(run, u)
            ibc = in_band | col0
            m = jnp.where(col0, m0_i, jnp.where(ibc, jnp.maximum(h, f),
                                                NEG_INF))
            m_cur.append(jnp.where(active, m, m_prev[w]))
            e_cur.append(jnp.where(active, jnp.where(ibc, e, NEG_INF),
                                   e_prev[w]))
            f_all.append(f)
            col0_all.append(col0)

        # Forward count propagation with the walk's exact local rules
        # (engine.cc BandedGlobalAlignStats).  The insert-run pop check
        # compares the previous row's m (same j -> slot w+1); the
        # delete-run pop check compares this row's m one slot left.  A
        # delete run takes its root from the nearest slot at or left of
        # w where one may open (the running key/payload pair); with no
        # such slot the payload is the slot's own.
        pm_cur, pe_cur = [], []
        key = payload_run = nof_left = None
        for w in slots:
            j = i + (w - ML)
            col0 = col0_all[w]
            su = jnp.where(sub[w] == SCORE_MATCH, MU, XU)
            if w + 1 < W:
                open_e = m_prev[w + 1] + GO + GE == e_cur[w]
                pe = IU + jnp.where(open_e, pm_prev[w + 1], pe_prev[w + 1])
            else:
                pe = zero + IU
            diag_ok = (m_prev[w] + sub[w] == m_cur[w]) & (j >= 1) & ~col0
            m_left = m_cur[w - 1] if w > 0 else neg
            o = ((m_left + GO + GE == f_all[w]) & (j >= 1) & ~col0) | col0
            payload = jnp.where(col0, i * IU,
                                zero if nof_left is None else nof_left)
            if key is None:
                key = jnp.where(o, w, -1024)
                payload_run = payload
            else:
                payload_run = jnp.where(o | (key == -1024), payload,
                                        payload_run)
                key = jnp.where(o, w, key)
            nof_left = jnp.where(diag_ok, pm_prev[w] + su, pe)
            pf = payload_run + (w - key + 1) * IU
            pm = jnp.where(diag_ok, pm_prev[w] + su,
                           jnp.where(f_all[w] >= e_cur[w], pf, pe))
            pm = jnp.where(col0, i * IU, pm)
            pm_cur.append(jnp.where(active, pm, pm_prev[w]))
            pe_cur.append(jnp.where(active, pe, pe_prev[w]))

        fin = i == pl
        sc, st = neg, zero
        for w in slots:
            sc = jnp.where(wfin[w], m_cur[w], sc)
            st = jnp.where(wfin[w], pm_cur[w], st)
        score = jnp.where(fin, jnp.maximum(sc, NEG_INF), score)
        stat = jnp.where(fin, jnp.maximum(st, 0), stat)
        return m_cur, e_cur, pm_cur, pe_cur, score, stat

    *_, score, packed = lax.fori_loop(1, Lp + 1, body,
                                      (m0, e0, pm0, pe0, neg, zero))

    # degenerate shapes (reference AlignAlgo.hpp:217-236)
    t0 = text_row(ML + 1)
    p0 = pat_row(0)
    single = (tl == 1) & (pl == 1)
    eq = (t0 == p0) | (t0 == 4) | (p0 == 4)
    score = jnp.where(single, jnp.where(eq, SCORE_MATCH, SCORE_MISMATCH),
                      score)
    packed = jnp.where(single, jnp.where(eq, MU, XU), packed)
    empty = (tl == 0) | (pl == 0)
    return jnp.where(empty, 0, score), jnp.where(empty, 0, packed)


_band_stats = jax.jit(_band_dp, static_argnames=("ML", "W", "Lp"))


def band_window(ml: int, max_tp_diff: int, cap: int = 256) -> int:
    """Smallest window width covering the full band: the in-band region
    reaches w = ML + 5 + (t_len - p_len) mid-row, so every band cell is
    represented iff W > that for every pair."""
    w = ml + 5 + max(max_tp_diff, 0) + 1
    assert w <= cap, "band exceeds the maximum window"
    return w


def banded_stats(t_codes, t_lens, p_codes, p_lens, ml: int = None,
                 w: int = None):
    """Scores plus match/mismatch/indel counts along the optimal
    traceback for a padded batch (t_codes [B, Lt], p_codes [B, Lp]).
    Returns (scores, match, mismatch, indel) int32 arrays of shape [B].
    ML and the window width default to the batch's length differences."""
    t_codes = np.asarray(t_codes, np.int8)
    p_codes = np.asarray(p_codes, np.int8)
    t_lens = np.asarray(t_lens, np.int32)
    p_lens = np.asarray(p_lens, np.int32)
    B, Lt = t_codes.shape
    Lp = int(p_codes.shape[1])
    min_ml = 5 + max(0, int((p_lens - t_lens).max(initial=0)))
    ML = ml if ml is not None else min_ml
    assert ML >= min_ml
    min_w = band_window(ML, int((t_lens - p_lens).max(initial=0)))
    W = w if w is not None else min_w
    assert W >= min_w
    # A counter field can reach t_len+p_len+2 ops for its pair; the 9-bit
    # packing overflows at 512 (tests/test_defer_caps.py pins both sides).
    max_ops = int((t_lens + p_lens).max(initial=0)) + 2
    assert max_ops < 512, "packed count fields overflow beyond 511 ops"

    lead = ML + 1
    t_pad = np.zeros((B, max(Lt + lead, Lp + W)), np.int8)
    t_pad[:, lead:lead + Lt] = t_codes
    scores, packed = _band_stats(jnp.asarray(t_pad), jnp.asarray(t_lens),
                                 jnp.asarray(p_codes), jnp.asarray(p_lens),
                                 ML=ML, W=W, Lp=Lp)
    packed = np.asarray(packed)
    return (np.asarray(scores), packed & 511, (packed >> 9) & 511,
            (packed >> 18) & 511)


def banded_scores(t_codes, t_lens, p_codes, p_lens) -> np.ndarray:
    """Alignment scores for a padded batch; int32 [B]."""
    return banded_stats(t_codes, t_lens, p_codes, p_lens)[0]


# Length and length-difference buckets for the byte-window stats_fn:
# padding item batches to a few static shapes bounds recompiles.
_LEN_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256)
_DIFF_BUCKETS = (0, 2, 6, 10)


def _bucket(n: int, buckets) -> int:
    return next((b for b in buckets if n <= b), n)


def make_deferred_stats_fn():
    """Returns stats_fn(t_codes, t_lens, p_codes, p_lens) -> match[int32]
    for NativeEngine.assign_batch_deferred's byte-window transport."""

    def stats_fn(t_codes, t_lens, p_codes, p_lens):
        t_lens = np.asarray(t_lens, np.int32)
        p_lens = np.asarray(p_lens, np.int32)
        n = len(t_lens)
        if n == 0:
            return np.zeros(0, np.int32)
        lt = _bucket(t_codes.shape[1], _LEN_BUCKETS)
        lp = _bucket(p_codes.shape[1], _LEN_BUCKETS)
        ml = 5 + _bucket(int((p_lens - t_lens).max(initial=0)), _DIFF_BUCKETS)
        wd = band_window(ml, _bucket(int((t_lens - p_lens).max(initial=0)),
                                     _DIFF_BUCKETS))
        cap = 1 << max(7, (n - 1).bit_length())
        tc = np.zeros((cap, lt), np.int8)
        pc = np.zeros((cap, lp), np.int8)
        tc[:n, :t_codes.shape[1]] = t_codes
        pc[:n, :p_codes.shape[1]] = p_codes
        tl = np.zeros(cap, np.int32)
        pl = np.zeros(cap, np.int32)
        tl[:n] = t_lens
        pl[:n] = p_lens
        _, match, _, _ = banded_stats(tc, tl, pc, pl, ml=ml, w=wd)
        return match[:n].astype(np.int32)

    return stats_fn


# ------------------------------------------------------------- descriptors
#
# Descriptor transport for the deferred-DP service: the packed reference
# and the batch's reads are device-resident (uploaded once), and each
# deferred item ships only (t_off, t_len, p_off, p_len) instead of two
# padded byte windows.  Windows are gathered on device with contiguous
# dynamic slices; reverse-complement pattern windows address the
# precomputed rc half of the doubled [fwd | rc] read tensor, so every
# gather is forward-contiguous.

# Fixed per-call item-slice size: every call sees the same shapes, so
# the compiled set is one program per length bucket.
_DESC_SLICE = 131072

# One (ML, W) class covers every deferrable item: the engine defers only
# |t_len - p_len| <= 10 (engine.cc kDeferMaxDiff), and 5+10+ML+1 <= 32.
_DESC_ML, _DESC_W = 15, 32

# Two length buckets: the engine defers items up to 254 bases
# (kDeferMaxLen), and HLA/KIR gap and extension windows are mostly
# short, so the 96 bucket serves nearly every item.
_DESC_BUCKETS = (96, 256)


@functools.partial(jax.jit, static_argnames=("Lb", "ML", "W"))
def _desc_stats_call(ref_pad, reads_pad, t_off, t_len, p_off, p_len,
                     Lb: int, ML: int, W: int):
    """Gather item windows from device-resident sequence tensors and run
    the band DP.  Offsets are int32 row starts (sequences are padded
    with trailing zeros so no slice clamps).  Returns per-item match
    counts (int16)."""
    gather = jax.vmap(
        lambda flat, o: lax.dynamic_slice(flat, (o,), (Lb,)),
        in_axes=(None, 0))
    col = lax.broadcasted_iota(jnp.int32, (t_off.shape[0], Lb), 1)
    # mask beyond each item's length (padding bytes may be arbitrary)
    t_win = jnp.where(col < t_len[:, None], gather(ref_pad, t_off), 0)
    p_win = jnp.where(col < p_len[:, None], gather(reads_pad, p_off), 0)
    lead = ML + 1
    t_pad = jnp.pad(t_win, ((0, 0), (lead, max(lead, W) - lead)))
    _, packed = _band_dp(t_pad, t_len, p_win, p_len, ML=ML, W=W, Lp=Lb)
    return (packed & 511).astype(jnp.int16)


def _pow2_pad(n: int, lo: int) -> int:
    """Sequence tensors are padded to power-of-2 lengths with a floor, so
    the shapes the DP program is compiled for are the same across
    datasets: a reference up to 8 MB and a read batch up to 4 MB share
    one compiled program per length bucket, for a few MB of device
    memory."""
    p = lo
    while p < n:
        p <<= 1
    return p


class DeferredDescService:
    """Descriptor-mode scorer for NativeEngine.assign_batch_deferred.

    Holds the device-resident packed reference (per engine lifetime) and
    the current batch's doubled [fwd | rc] read tensor; `stats` buckets
    items by maximum length, pads each bucket to fixed slices of
    `slice_items`, and runs the band DP per slice.  `items_scored` and
    `slices` count the items the device has scored and the slices it
    ran, per length bucket."""

    def __init__(self, slice_items: int = _DESC_SLICE):
        self.slice_items = slice_items
        self.items_scored = 0
        self.slices = dict.fromkeys(_DESC_BUCKETS, 0)
        self._ref = None
        self._ref_key = None
        self._reads = None
        self._rev_idx = None

    def set_ref(self, codes: np.ndarray) -> None:
        # Content digest key: a buffer-address key can alias a freed
        # temporary when the caller passes a fresh contiguous copy, and
        # a service reused across engines could then score against a
        # stale reference.
        key = (hashlib.blake2b(codes.tobytes(), digest_size=16).digest(),
               codes.shape[0])
        if self._ref_key == key:
            return
        buf = np.zeros(_pow2_pad(codes.shape[0] + 256, 1 << 23), np.int8)
        buf[:codes.shape[0]] = codes
        self._ref = jnp.asarray(buf)
        self._ref_key = key

    def set_layout(self, read_starts: np.ndarray,
                   read_lens: np.ndarray) -> None:
        """Precompute per-position reversal indices: position start+j of
        read r maps to start + len-1-j (host-side numpy; ~4 bytes/base,
        uploaded once per batch)."""
        starts = np.asarray(read_starts, np.int64)
        lens = np.asarray(read_lens, np.int64)
        total = int((starts[-1] + lens[-1]) if len(lens) else 0)
        if total >= 2**30:
            raise ValueError("rev-index transport caps at 2^30 read bytes "
                             "per batch; chunk the reads")
        rep_start = np.repeat(starts, lens)
        rep_len = np.repeat(lens, lens)
        idx = np.arange(total, dtype=np.int64)
        self._rev_idx = (2 * rep_start + rep_len - 1 - idx).astype(np.int32)

    def begin_batch(self, read_codes: np.ndarray) -> int:
        """Upload the batch's flat read codes and build the doubled
        [fwd | rc] tensor on device.  rc windows in the engine's
        descriptors address padded_total + offset and are forward-
        contiguous there; the per-read reversal indices come from the
        same starts/lens the engine saw (set via set_layout).  Returns
        the padded total the engine must use as its rc base."""
        total = int(read_codes.shape[0])
        # rc-half offsets are int32 in the descriptor transport and the
        # doubled tensor addresses 2*padded+256 positions
        if total >= 2**30:
            raise ValueError("deferred descriptor transport caps at 2^30 "
                             "read bytes per batch; chunk the reads")
        p = _pow2_pad(total + 256, 1 << 22)
        buf = np.zeros(p, np.int8)
        buf[:total] = read_codes
        fwd = jnp.asarray(buf)
        rev = np.zeros(p, np.int32)
        rev[:total] = self._rev_idx
        src = fwd[jnp.asarray(rev)]
        rc = jnp.where(src < 4, 3 - src, src).astype(jnp.int8)
        self._reads = jnp.concatenate([fwd, rc, jnp.zeros(256, jnp.int8)])
        return p

    def stats_async(self, t_off, t_len, p_off, p_len):
        """Dispatch scoring of the items to the device and return a
        materializer.  JAX execution is asynchronous, so the caller can
        do host work (the next chunk's seed/chain) while the DP runs;
        calling the returned function blocks on and collects the match
        counts, in input order."""
        n = len(t_len)
        if n == 0:
            zero = np.zeros(0, np.int32)
            return lambda: zero
        t_off = np.asarray(t_off)
        p_off = np.asarray(p_off)
        t_len = np.asarray(t_len, np.int32)
        p_len = np.asarray(p_len, np.int32)
        if max(int(t_off.max()), int(p_off.max())) >= 2**31:
            raise ValueError("descriptor offsets must fit int32")
        maxlen = np.maximum(t_len, p_len)
        if int(maxlen.max()) > _DESC_BUCKETS[-1]:
            raise ValueError("deferred items longer than the largest "
                             f"length bucket ({_DESC_BUCKETS[-1]})")
        cap = self.slice_items
        pending = []  # (item indices, device match array)
        lower = 0
        for lb in _DESC_BUCKETS:
            idx = np.flatnonzero((maxlen <= lb) & (maxlen > lower))
            lower = lb
            for lo in range(0, len(idx), cap):
                part = idx[lo:lo + cap]
                cols = [np.zeros(cap, np.int32) for _ in range(4)]
                for c, v in zip(cols, (t_off, t_len, p_off, p_len)):
                    c[:len(part)] = v[part]
                m = _desc_stats_call(self._ref, self._reads,
                                     *map(jnp.asarray, cols),
                                     Lb=lb, ML=_DESC_ML, W=_DESC_W)
                pending.append((part, m))
                self.slices[lb] += 1
        self.items_scored += n

        def collect() -> np.ndarray:
            out = np.zeros(n, np.int32)
            for part, m in pending:
                out[part] = np.asarray(m)[:len(part)]
            return out

        return collect

    def stats(self, t_off, t_len, p_off, p_len) -> np.ndarray:
        return self.stats_async(t_off, t_len, p_off, p_len)()
