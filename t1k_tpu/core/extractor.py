"""Candidate-read extraction (the reference `fastq-extractor` stage).

Screens raw reads with the k-mer index: a read pair is kept when either
mate has a chained hit with enough matching bases.  Behavior contract:
reference FastqExtractor.cpp (k=9 raised to log4(refLen)+1, hit-length
thresholds 27/23 raised to meanReadLen/5, low-complexity filter,
read/barcode range slicing, whitelist barcode correction).

The screen itself runs in the native engine (HasHitInSet) or, in
batches, on the device screen (ops/phase_a.py DeviceScreen).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..constants import (
    EXTRACTOR_HIT_LEN_PAIRED,
    EXTRACTOR_HIT_LEN_SINGLE,
    EXTRACTOR_KMER_LENGTH,
    encode_seq,
)
from ..io.reads import SeqRecord, read_seq_files
from ..io.refset import RefSet
from .barcode import BarcodeCorrector, format_barcode


def low_complexity_flags(codes: np.ndarray, seg: np.ndarray,
                         lens: np.ndarray) -> np.ndarray:
    """Vectorized FastqExtractor.cpp:89-111 over concatenated reads:
    dominated by one base, too many Ns, or at least two bases nearly
    absent.  `codes` are the concatenated base codes, `seg` the read
    index per base, `lens` the per-read lengths.  The single contract
    shared by the FASTQ and BAM extraction paths."""
    n = len(lens)
    cnt = np.bincount(seg * 5 + codes, minlength=n * 5).reshape(n, 5)
    return ((cnt[:, :4] >= (lens // 2)[:, None]).any(axis=1)
            | (cnt[:, 4] >= lens // 10)
            | ((cnt[:, :4] <= 2).sum(axis=1) >= 2))


def is_low_complexity(seq: str) -> bool:
    """Single-read wrapper over low_complexity_flags."""
    codes = encode_seq(seq)
    return bool(low_complexity_flags(
        codes, np.zeros(len(codes), np.int64),
        np.array([len(seq)], np.int64))[0])


class LazyDeviceScreen:
    """Size-gated lazy device screen shared by the FASTQ and BAM
    extraction paths.  Calling it with the number of reads about to be
    screened returns the DeviceScreen, or None while the host screens.
    Backend "auto" engages the device once T1K_SCREEN_DEVICE_MIN_READS
    (default 2M) reads have streamed through and a GPU is present: the
    per-process device setup (compiles and first dispatches) only
    amortizes on large inputs, and the mid-run switch is safe because
    both routes are byte-identical.  Backend "device" forces the device
    from the first call.  `build` is called lazily at most once."""

    def __init__(self, backend: str, build):
        from .pipeline import canonical_backend

        self.backend = canonical_backend(backend)
        self.build = build
        self.screen = None
        self.checked = False
        self.reads = 0
        self.min_reads = int(os.environ.get("T1K_SCREEN_DEVICE_MIN_READS",
                                            "2000000"))

    def __call__(self, n_new: int):
        if not self.checked and (
                self.backend == "device"
                or (self.backend == "auto" and self.reads >= self.min_reads)):
            self.checked = True
            from .pipeline import device_present, require_device
            if self.backend == "device":
                require_device("the device extraction screen")
            if self.backend == "device" or device_present():
                self.screen = self.build()
        self.reads += n_new
        return self.screen

    @property
    def reads_decided(self) -> int:
        """Reads whose verdict the device screen decided."""
        return self.screen.reads_decided if self.screen is not None else 0


def screen_flags(codes_cat: np.ndarray, lens: np.ndarray,
                 starts: np.ndarray, device_screen, engine):
    """Batched candidate screen shared by the FASTQ and BAM extraction
    paths: the vectorized low-complexity rule over the whole batch, the
    device prefilter for the reads it can decide, and the exact native
    re-screen for the rest (so output stays byte-identical).

    codes_cat: concatenated base codes; lens/starts: per-read layout.
    Returns (hits bool[n] — False for low-complexity reads, lc bool[n]).
    """
    n = len(lens)
    hits = np.zeros(n, bool)
    if n == 0:
        return hits, np.zeros(0, bool)
    seg = np.repeat(np.arange(n), lens)
    lc = low_complexity_flags(codes_cat, seg, lens)
    todo = np.flatnonzero(~lc)
    if len(todo) and device_screen is not None:
        max_len = int(lens[todo].max())
        padded = np.full((len(todo), max_len), 4, dtype=np.int8)
        plens = lens[todo].astype(np.int32)
        for j, i in enumerate(todo):
            padded[j, :lens[i]] = codes_cat[starts[i]:starts[i] + lens[i]]
        verdict, dec = device_screen.screen(padded, plens)
        hits[todo[dec]] = verdict[dec]
        todo = todo[~dec]
    if len(todo):
        codes = np.concatenate(
            [codes_cat[starts[i]:starts[i] + lens[i]] for i in todo])
        l2 = lens[todo].astype(np.int32)
        s2 = np.zeros(len(l2), dtype=np.int64)
        s2[1:] = np.cumsum(l2[:-1])
        hits[todo] = engine.screen_batch(codes, s2, l2).astype(bool)
    return hits, lc


@dataclass
class ExtractorOptions:
    ref_seq_similarity: float = 0.8
    threads: int = 1
    barcode_file: Optional[str] = None
    barcode_start: int = 0
    barcode_end: int = -1
    barcode_revcomp: bool = False
    barcode_whitelist: Optional[str] = None
    read1_start: int = 0
    read1_end: int = -1
    read2_start: int = 0
    read2_end: int = -1
    backend: str = "auto"  # auto = device screen when a GPU is present


def _slice(seq: Optional[str], start: int, end: int) -> Optional[str]:
    if seq is None or (start == 0 and end == -1):
        return seq
    e = len(seq) - 1 if end == -1 else end
    return seq[start:e + 1]


def run_extractor(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    output_prefix: str,
    opts: Optional[ExtractorOptions] = None,
    interleaved: bool = False,
) -> dict:
    """Returns counts: {"total": n, "candidates": m}."""
    opts = opts or ExtractorOptions()
    has_mate = reads2 is not None or interleaved

    # The extractor indexes every allele record without dedupe
    # (reference InputRefFa, SeqSet.hpp:872-904).
    refset = RefSet(digit_units=-1, delimiter="")
    from ..io.reads import read_seq_file
    for rec in read_seq_file(ref_fasta):
        refset.add_allele(rec.id, rec.seq, rec.comment)
    packed = refset.packed()

    # Streaming ingest (reference FastqExtractor.cpp:483-567 processes
    # 512*threads-read batches): the raw input is consumed in bounded
    # chunks — screen, correct, and write each chunk before reading the
    # next — so a WGS-scale FASTQ runs in O(chunk) memory.
    BATCH = int(os.environ.get("T1K_EXTRACT_BATCH", "65536"))

    if interleaved:
        it1 = read_seq_files(reads1, interleaved_id=1)
        it2 = read_seq_files(reads1, interleaved_id=2)
    else:
        it1 = read_seq_files(reads1)
        it2 = read_seq_files(reads2) if reads2 else None

    first1: List[SeqRecord] = []
    for rec in it1:
        first1.append(rec)
        if len(first1) >= BATCH:
            break

    # hit-length threshold from a 1000-read sample (FastqExtractor.cpp:390-407)
    hit_len = EXTRACTOR_HIT_LEN_PAIRED if has_mate else EXTRACTOR_HIT_LEN_SINGLE
    sample = first1[:1000]
    if not sample:
        raise ValueError("read file is empty")
    total_len = sum(len(r.seq) for r in sample)
    if total_len // (len(sample) * 5) > hit_len:
        hit_len = total_len // (len(sample) * 5)

    kmer_length = EXTRACTOR_KMER_LENGTH
    inferred = refset.infer_kmer_length()
    if inferred > kmer_length:
        kmer_length = inferred
        if kmer_length > hit_len:
            hit_len = kmer_length

    from ..native import NativeEngine
    engine = NativeEngine(
        packed, kmer_length,
        ref_seq_similarity=opts.ref_seq_similarity,
        hit_len_required=hit_len,
        threads=opts.threads,
    )

    corrector = None
    bc_iter = None
    has_bc = bool(opts.barcode_file)
    if has_bc:
        bc_files = (opts.barcode_file
                    if isinstance(opts.barcode_file, (list, tuple))
                    else [opts.barcode_file])
        if opts.barcode_whitelist:
            corrector = BarcodeCorrector()
            corrector.set_whitelist(opts.barcode_whitelist)
            # background distribution from a dedicated streaming pass
            # (the corrector caps its sample at 2M reads like the
            # reference, BarcodeCorrector.hpp:154-168)
            corrector.collect_background(
                (r.seq for r in read_seq_files(bc_files)),
                opts.barcode_start, opts.barcode_end, opts.barcode_revcomp)
        bc_iter = read_seq_files(bc_files)

    # Device screen (backend "device"): the EXACT extraction screen runs as
    # one on-device phase-A program — k-mer hit generation, diagonal
    # clustering, LIS chaining and the mismatch-budget test
    # (ops/phase_a.py) — so the device owns seeding/chaining for this
    # stage.  Only reads whose hit volume overflows the static device
    # caps fall back to the native engine; output is byte-identical by
    # construction.
    # Routing: the per-process device setup only amortizes on large
    # inputs — see LazyDeviceScreen.
    def _build():
        from ..ops.phase_a import DeviceScreen
        return DeviceScreen.build(packed, kmer_length, hit_len,
                                  opts.ref_seq_similarity)

    get_screen = LazyDeviceScreen(opts.backend, _build)

    # Screen: low-complexity prefilter, then batched k-mer chained
    # screen (screen_flags, shared with the BAM extraction path).  The
    # whole chunk is encoded ONCE and the low-complexity rule evaluated
    # vectorized (a per-read numpy call costs ~15us of fixed overhead —
    # 0.3s per 20k reads).
    def screen(recs: List[SeqRecord]) -> np.ndarray:
        n = len(recs)
        if n == 0:
            return np.zeros(0, dtype=np.uint8)
        device_screen = get_screen(n)
        codes_cat = encode_seq("".join(r.seq for r in recs))
        lens_all = np.array([len(r.seq) for r in recs], dtype=np.int64)
        starts_all = np.zeros(n, dtype=np.int64)
        np.cumsum(lens_all[:-1], out=starts_all[1:])
        hits, _ = screen_flags(codes_cat, lens_all, starts_all,
                               device_screen, engine)
        return hits.astype(np.uint8)

    # Outputs (opened up front; chunks append in input order).
    if has_mate:
        f1 = open(f"{output_prefix}_1.fq", "w")
        f2 = open(f"{output_prefix}_2.fq", "w")
    else:
        f1 = open(f"{output_prefix}.fq", "w")
        f2 = None
    fbc = open(f"{output_prefix}_bc.fa", "w") if has_bc else None

    def write_rec(f, name: str, rec: SeqRecord, start: int, end: int):
        seq = _slice(rec.seq, start, end)
        qual = _slice(rec.qual, start, end)
        if qual is None:
            f.write(f">{name}\n{seq}\n")
        else:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")

    n_total = 0
    n_out = 0
    from ..utils.observability import stage
    with stage("extraction_screen") as st:
        chunk1 = first1
        while chunk1:
            chunk2 = None
            if it2 is not None:
                chunk2 = []
                for rec2 in it2:
                    chunk2.append(rec2)
                    if len(chunk2) >= len(chunk1):
                        break
            bc_chunk = None
            if bc_iter is not None:
                bc_chunk = []
                for recb in bc_iter:
                    bc_chunk.append(recb)
                    if len(bc_chunk) >= len(chunk1):
                        break

            good = screen(chunk1)
            if chunk2 is not None:
                # only screen mate 2 where mate 1 failed (either-mate rule)
                failed = [i for i in range(len(chunk2)) if not good[i]]
                if failed:
                    sub_flags = screen([chunk2[i] for i in failed])
                    for j, i in enumerate(failed):
                        if sub_flags[j]:
                            good[i] = 1

            for i, keep in enumerate(good):
                if not keep:
                    continue
                n_out += 1
                write_rec(f1, chunk1[i].id, chunk1[i],
                          opts.read1_start, opts.read1_end)
                if f2 is not None:
                    write_rec(f2, chunk1[i].id, chunk2[i],
                              opts.read2_start, opts.read2_end)
                if fbc is not None:
                    raw = bc_chunk[i].seq
                    if raw:
                        bc = format_barcode(raw, opts.barcode_start,
                                            opts.barcode_end,
                                            opts.barcode_revcomp)
                        if corrector is not None:
                            bc = corrector.correct(bc, bc_chunk[i].qual)
                        # only an UNCORRECTABLE barcode becomes
                        # missing_barcode; a nonempty raw barcode SLICED
                        # to empty is emitted as an empty line
                        # (OutputBarcode only tests the raw barcode,
                        # FastqExtractor.cpp:157-199, and Correct("")
                        # resolves at the trie root)
                        fbc.write(f">{chunk1[i].id}\n"
                                  f"{bc if bc is not None else 'missing_barcode'}\n")
                    else:
                        fbc.write(f">{chunk1[i].id}\nmissing_barcode\n")

            n_total += len(chunk1)
            chunk1 = []
            for rec in it1:
                chunk1.append(rec)
                if len(chunk1) >= BATCH:
                    break
        st["read_count"] = n_total
        st["candidate_count"] = n_out
        st["device_screened_read_count"] = get_screen.reads_decided

    f1.close()
    if f2 is not None:
        f2.close()
    if fbc is not None:
        fbc.close()
    return {"total": n_total, "candidates": n_out}
