"""Device k-mer classification against the allele database.

The reference index becomes a fixed-width integer open-addressing hash
table in device memory (replacing the host map-of-vectors): keys are
2-bit-packed k-mers (k <= 16 fits uint32 key space), values are posting
counts.  Read batches are classified entirely on device:

  1. rolling 2-bit codes for every window of every read (both strands),
  2. table lookup via double hashing with a bounded probe loop,
  3. per-read tally of matching windows -> candidate flag.

This is the extractor's fast path: a read that the exact screen accepts
must have at least ceil(hitLenRequired / k) index-matching windows on one
strand (SeqSet.hpp:1959), so flagging reads with fewer total matches
cannot produce false negatives.  The native engine re-screens the
surviving reads exactly, preserving byte-identical extractor output
while the device discards the bulk of off-target input.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..utils import jaxcache as _jaxcache

_jaxcache.enable()

import jax
import jax.numpy as jnp

import numpy as np

_EMPTY = np.uint32(0xFFFFFFFF)


# Largest k that uses direct bitmap addressing (4^14 bits = 32MB HBM).
_DIRECT_MAX_K = 14


@dataclass
class DeviceKmerTable:
    k: int
    table: jnp.ndarray      # direct: uint32 bitmap [4^k/32];
    #                         hashed: uint32 [size] keys, 0xFFFFFFFF empty
    size: int               # power of two
    direct: bool = False    # direct-addressed bitmap vs open addressing

    @classmethod
    def build(cls, packed, k: int) -> "DeviceKmerTable":
        """Collect distinct valid k-mers of all reference sequences.

        For k <= 14 the key space 4^k is small enough to direct-address
        a membership bitmap — the classify program then costs exactly
        ONE table gather per window, with exact membership.  Larger k falls back to open addressing."""
        keys = set()
        for s in range(packed.n):
            start = int(packed.seq_starts[s])
            ln = int(packed.seq_lens[s])
            codes = packed.seq_codes[start:start + ln].astype(np.int64)
            if ln < k:
                continue
            win = np.lib.stride_tricks.sliding_window_view(codes, k)
            valid = (win < 4).all(axis=1)
            pows = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
            vals = (np.where(win < 4, win, 3) * pows).sum(axis=1)
            keys.update(int(v) for v in vals[valid])
        if k <= _DIRECT_MAX_K:
            nbits = 4 ** k
            bitmap = np.zeros(max(nbits // 32, 1), np.uint32)
            if keys:
                ka = np.fromiter(keys, np.int64, len(keys))
                np.bitwise_or.at(bitmap, ka >> 5,
                                 np.uint32(1) << (ka & 31).astype(np.uint32))
            return cls(k=k, table=jnp.asarray(bitmap), size=len(bitmap),
                       direct=True)
        n = max(len(keys), 1)
        # 4x oversizing keeps the load factor <= 0.25 so the classify
        # kernel's short probe cap (conservative overflow, see
        # _classify) almost never fires: P(6 non-empty probes) ~ 0.02%
        size = 1
        while size < 4 * n:
            size *= 2
        table = np.full(size, _EMPTY, dtype=np.uint32)
        mask = size - 1
        for key in keys:
            h = (key * 2654435761) & mask
            step = ((key >> 15) | 1) & mask | 1
            while table[h] != _EMPTY:
                h = (h + step) & mask
            table[h] = key
        return cls(k=k, table=jnp.asarray(table), size=size)


def _rolling_codes(codes: jnp.ndarray, k: int):
    """codes [R, L] int32 -> (window codes [R, L-k+1], valid mask)."""
    R, L = codes.shape
    W = L - k + 1
    acc = jnp.zeros((R, W), jnp.uint32)
    invalid = jnp.zeros((R, W), bool)
    for t in range(k):
        sl = jax.lax.slice(codes, (0, t), (R, t + W))
        acc = (acc << 2) | jnp.where(sl < 4, sl, 3).astype(jnp.uint32)
        invalid |= sl >= 4
    return acc, ~invalid


@functools.partial(jax.jit, static_argnames=("k", "size", "max_probe"))
def _classify(codes, lens, table, k: int, size: int, max_probe: int = 6):
    """Count index-matching windows per read on both strands.

    Returns (fwd_matches [R], rc_matches [R]) int32 — an UPPER BOUND on
    the true match counts: a probe chain not resolved within max_probe
    steps counts as a match.  Device gathers dominate this kernel's
    cost (each probe is one table gather per window), and the table is
    >=4x oversized, so a short probe cap with conservative overflow is
    ~5x cheaper than probing to completion while preserving the
    prefilter's no-false-negative guarantee.
    """
    mask = jnp.uint32(size - 1)

    def lookup(keys):  # keys [R, W] uint32
        h0 = (keys * jnp.uint32(2654435761)) & mask
        step = (((keys >> 15) | 1) & mask) | 1

        def body(i, state):
            h, found, empty = state
            entry = table[h]
            found = found | (entry == keys)
            empty = empty | (entry == jnp.uint32(0xFFFFFFFF))
            h = jnp.where(found | empty, h, (h + step) & mask)
            return h, found, empty

        _, found, empty = jax.lax.fori_loop(
            0, max_probe, body,
            (h0, jnp.zeros_like(keys, bool), jnp.zeros_like(keys, bool)))
        return found | ~(found | empty)  # unresolved -> conservative hit

    return _strand_counts(codes, lens, lookup, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _classify_direct(codes, lens, bitmap, k: int):
    """Direct-addressed membership: one bitmap-word gather per window,
    exact counts (the fast path for k <= 14; see DeviceKmerTable)."""

    def lookup(keys):
        words = bitmap[(keys >> 5).astype(jnp.int32)]
        return ((words >> (keys & 31)) & 1) == 1

    return _strand_counts(codes, lens, lookup, k)


def _strand_counts(codes, lens, lookup, k: int):
    R, L = codes.shape
    W = L - k + 1
    fwd, fwd_valid = _rolling_codes(codes, k)
    # reverse complement read: windows mirror; compute rc codes directly
    rc_codes = jnp.where(codes < 4, 3 - codes, codes)[:, ::-1]
    rc, rc_valid = _rolling_codes(rc_codes, k)

    win_idx = jnp.arange(W)[None, :]
    in_read = win_idx < (lens[:, None] - k + 1)
    # for the reverse strand, valid windows sit at the END of the padded row
    rc_in_read = win_idx >= (L - lens[:, None])

    fwd_hit = lookup(fwd) & fwd_valid & in_read
    rc_hit = lookup(rc) & rc_valid & rc_in_read
    return fwd_hit.sum(axis=1), rc_hit.sum(axis=1)


def classify_reads(table: DeviceKmerTable, codes: np.ndarray, lens: np.ndarray):
    """Per-read matching-window counts (fwd, rc) for a padded batch.

    The batch is padded up to a power-of-two row count so repeated calls
    reuse the compiled kernel."""
    n = codes.shape[0]
    rows = 256
    while rows < n:
        rows *= 2
    if codes.shape[1] < table.k:
        # every read shorter than k: no window can match (the exact
        # screen returns false for len < k); avoid a negative window
        # axis in the kernel
        return (np.zeros(n, np.int32), np.zeros(n, np.int32))
    if rows != n:
        codes = np.vstack([codes, np.zeros((rows - n, codes.shape[1]), codes.dtype)])
        lens = np.concatenate([lens, np.zeros(rows - n, lens.dtype)])
    if table.direct:
        fwd, rc = _classify_direct(jnp.asarray(codes, jnp.int32),
                                   jnp.asarray(lens, jnp.int32),
                                   table.table, table.k)
    else:
        fwd, rc = _classify(jnp.asarray(codes, jnp.int32),
                            jnp.asarray(lens, jnp.int32),
                            table.table, table.k, table.size)
    return fwd[:n], rc[:n]


def prefilter_flags(table: DeviceKmerTable, codes: np.ndarray,
                    lens: np.ndarray, hit_len_required: int) -> np.ndarray:
    """Conservative candidate prefilter: keep a read iff its total
    matching windows could satisfy the exact screen's chain-length
    requirement (no false negatives by construction).

    The exact screen accepts when lisSize*k >= hitLenRequired
    (SeqSet.hpp:1959-1978) and the LIS length is bounded by the number
    of distinct index-matching windows, so ceil(hitLenRequired/k)
    windows are necessary.  No constant floor above that is safe: the
    screen's minHitRequired=3 counts POSTING hits, and one window whose
    k-mer occurs several times in an allele yields several hits."""
    fwd, rc = classify_reads(table, codes, lens)
    need = max(1, -(-hit_len_required // table.k))
    return np.asarray((fwd + rc) >= need)
