"""Minimal BAM I/O (BGZF container + BAM record codec) and the
BAM candidate-extraction stage.

No external htslib dependency: BGZF blocks are plain gzip members, and
the BAM record layout is decoded directly.  Covers what the extraction
stage needs — flags, tid/pos, CIGAR reference span, sequence/qual
(reverse-complemented back to original orientation for reverse-strand
records), and string aux tags (CB/UB style barcodes).

Extraction behavior contract (reference BamExtractor.cpp): keep
(a) unaligned templates (mate pairs arriving together unless
--abnormalUnmapFlag), (b) aligned reads on alternative contigs (name
contains '_' '.' or '*'), (c) aligned reads overlapping the gene
intervals from the coordinate file; candidates are screened with the
k-mer index (hit length 21 paired / 17 single, raised to readLen/5);
paired data does a second pass to recover both mates by name.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib

import numpy as np
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
# hex() renders each packed byte as two nibble chars -> map to bases
_HEX_TO_BASE = str.maketrans("0123456789abcdef", _SEQ_NIBBLE)
_QUAL_PLUS_33 = bytes((min(q + 33, 255)) for q in range(256))
_COMP = str.maketrans("ACGTN", "TGCAN")


@dataclass
class BamRecord:
    name: str
    flag: int
    tid: int
    pos: int
    mapq: int
    cigar: List[Tuple[int, int]]   # (op_len, op_char_index)
    mtid: int
    mpos: int
    tlen: int
    seq: str                       # as stored (alignment orientation)
    qual: Optional[str]
    tags: Dict[str, object]

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & 0x1)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4) or self.tid < 0

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def mate_reverse(self) -> bool:
        return bool(self.flag & 0x20)

    @property
    def is_first_mate(self) -> bool:
        return bool(self.flag & 0x40)

    @property
    def is_primary(self) -> bool:
        return (self.flag & 0x900) == 0

    def is_template_aligned(self) -> bool:
        """reference alignments.hpp:426-432."""
        if (self.flag & 0xD) == 0xD or (self.flag & 0x5) == 0x4 or self.tid < 0:
            return False
        return True

    def is_aligned(self) -> bool:
        return not ((self.flag & 0x4) or self.tid < 0)

    def ref_span(self) -> int:
        """Reference bases consumed by the alignment (M/D/N/=/X)."""
        span = 0
        for ln, op in self.cigar:
            if _CIGAR_OPS[op] in "MDN=X":
                span += ln
        return span

    def original_seq(self) -> str:
        """Read sequence in sequencing orientation
        (alignments.hpp:527-563)."""
        if self.is_reverse:
            return self.seq[::-1].translate(_COMP)
        return self.seq

    def original_qual(self) -> Optional[str]:
        if self.qual is None:
            return None
        return self.qual[::-1] if self.is_reverse else self.qual


class BamReader:
    def __init__(self, path: str):
        self.path = path
        self._open()

    def _open(self):
        self._fh = gzip.open(self.path, "rb")
        magic = self._fh.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{self.path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._fh.read(4))
        self.header_text = self._fh.read(l_text).decode("ascii", "replace")
        (n_ref,) = struct.unpack("<i", self._fh.read(4))
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._fh.read(4))
            name = self._fh.read(l_name)[:-1].decode("ascii")
            (l_ref,) = struct.unpack("<i", self._fh.read(4))
            self.ref_names.append(name)
            self.ref_lens.append(l_ref)
        self.name_to_tid = {n: i for i, n in enumerate(self.ref_names)}

    def rewind(self):
        self._fh.close()
        self._open()

    def __iter__(self) -> Iterator[BamRecord]:
        while True:
            hdr = self._fh.read(4)
            if len(hdr) < 4:
                return
            (block_size,) = struct.unpack("<i", hdr)
            data = self._fh.read(block_size)
            yield self._decode(data)

    def _decode(self, d: bytes) -> BamRecord:
        (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, mtid,
         mpos, tlen) = struct.unpack("<iiBBHHHiiii", d[:32])
        off = 32
        name = d[off:off + l_read_name - 1].decode("ascii")
        off += l_read_name
        cigar = []
        if n_cigar:
            vals = struct.unpack(f"<{n_cigar}I", d[off:off + 4 * n_cigar])
            cigar = [(v >> 4, v & 0xF) for v in vals]
            off += 4 * n_cigar
        nbytes = (l_seq + 1) // 2
        seq = d[off:off + nbytes].hex().translate(_HEX_TO_BASE)[:l_seq]
        off += nbytes
        qual_raw = d[off:off + l_seq]
        qual = None
        if l_seq and qual_raw[0] != 0xFF:
            qual = qual_raw.translate(_QUAL_PLUS_33).decode("latin-1")
        off += l_seq
        tags: Dict[str, object] = {}
        while off < len(d):
            tag = d[off:off + 2].decode("ascii")
            typ = chr(d[off + 2])
            off += 3
            if typ == "Z":
                end = d.index(0, off)
                tags[tag] = d[off:end].decode("ascii")
                off = end + 1
            elif typ == "A":
                tags[tag] = chr(d[off])
                off += 1
            elif typ in "cC":
                tags[tag] = d[off]
                off += 1
            elif typ in "sS":
                (tags[tag],) = struct.unpack("<H" if typ == "S" else "<h", d[off:off + 2])
                off += 2
            elif typ in "iI":
                (tags[tag],) = struct.unpack("<I" if typ == "I" else "<i", d[off:off + 4])
                off += 4
            elif typ == "f":
                (tags[tag],) = struct.unpack("<f", d[off:off + 4])
                off += 4
            elif typ == "B":
                sub = chr(d[off])
                (cnt,) = struct.unpack("<i", d[off + 1:off + 5])
                size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
                off += 5 + cnt * size
                tags[tag] = None
            else:
                break
        return BamRecord(name, flag, tid, pos, mapq, cigar, mtid, mpos, tlen,
                         seq, qual, tags)


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compress(payload, 6)[2:-4]
    bsize = len(comp) + 25 + 1
    out = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
           + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize - 1)
           + comp
           + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload)))
    return out

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class BamWriter:
    """Writes a valid BAM (one BGZF block per call chunk) — used by the
    test suite and the simulator; covers flags/cigar/seq/qual/Z tags."""

    def __init__(self, path: str, ref_names: List[str], ref_lens: List[int],
                 header_text: str = ""):
        self._f = open(path, "wb")
        hdr = b"BAM\x01" + struct.pack("<i", len(header_text)) + header_text.encode()
        hdr += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lens):
            nb = n.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
        self._f.write(_bgzf_block(hdr))
        self._buf = b""

    def write(self, rec: BamRecord) -> None:
        name_b = rec.name.encode() + b"\x00"
        data = struct.pack(
            "<iiBBHHHiiii", rec.tid, rec.pos, len(name_b), rec.mapq,
            0, len(rec.cigar), rec.flag, len(rec.seq), rec.mtid, rec.mpos,
            rec.tlen)
        data += name_b
        for ln, op in rec.cigar:
            data += struct.pack("<I", (ln << 4) | op)
        nib = []
        lookup = {c: i for i, c in enumerate(_SEQ_NIBBLE)}
        s = rec.seq
        for i in range(0, len(s), 2):
            hi = lookup.get(s[i], 15) << 4
            lo = lookup.get(s[i + 1], 15) if i + 1 < len(s) else 0
            nib.append(hi | lo)
        data += bytes(nib)
        if rec.qual is not None:
            data += bytes(ord(q) - 33 for q in rec.qual)
        else:
            data += b"\xff" * len(s)
        for tag, val in rec.tags.items():
            if isinstance(val, str) and len(val) > 1:
                data += tag.encode() + b"Z" + val.encode() + b"\x00"
        self._buf += struct.pack("<i", len(data)) + data
        if len(self._buf) > 32000:
            self._f.write(_bgzf_block(self._buf))
            self._buf = b""

    def close(self) -> None:
        if self._buf:
            self._f.write(_bgzf_block(self._buf))
        self._f.write(BGZF_EOF)
        self._f.close()


# ---------------------------------------------------------------- extraction

class _RecView:
    """Lightweight record view over a native scan batch (bamscan.cc):
    scalar fields as attributes, strings sliced from the batch blobs on
    demand."""

    __slots__ = ("flag", "tid", "pos", "mapq", "mtid", "mpos", "tlen",
                 "l_seq", "ref_span_v", "name_hash", "_i", "_offs",
                 "_blobs", "_name")

    def __init__(self, row, i, offs, blobs, name_hash):
        (self.flag, self.tid, self.pos, self.mapq, self.mtid, self.mpos,
         self.tlen, self.l_seq, self.ref_span_v) = row
        self._i = i
        self._offs = offs
        self._blobs = blobs
        self.name_hash = name_hash
        self._name = None

    @property
    def name(self) -> str:
        if self._name is None:
            o = self._offs["name"]
            self._name = self._blobs["name"][o[self._i]:o[self._i + 1]]                 .decode("ascii")
        return self._name

    def _slice(self, key):
        o = self._offs[key]
        return self._blobs[key][o[self._i]:o[self._i + 1]]

    @property
    def is_paired(self):
        return bool(self.flag & 0x1)

    @property
    def is_reverse(self):
        return bool(self.flag & 0x10)

    @property
    def mate_reverse(self):
        return bool(self.flag & 0x20)

    @property
    def is_first_mate(self):
        return bool(self.flag & 0x40)

    @property
    def is_primary(self):
        return (self.flag & 0x900) == 0

    def is_template_aligned(self):
        if (self.flag & 0xD) == 0xD or (self.flag & 0x5) == 0x4                 or self.tid < 0:
            return False
        return True

    def is_aligned(self):
        return not ((self.flag & 0x4) or self.tid < 0)

    def ref_span(self):
        return self.ref_span_v

    @property
    def seq(self):
        return self._slice("seq").decode("ascii")

    def original_seq(self):
        s = self.seq
        if self.is_reverse:
            return s[::-1].translate(_COMP)
        return s

    def original_qual(self):
        q = self._slice("qual")
        if not q and self.l_seq:
            return None
        q = q.decode("latin-1")
        return q[::-1] if self.is_reverse else (q or None)

    @property
    def tags(self):
        d = {}
        bc = self._slice("bc")
        if bc:
            d["__bc__"] = bc.decode("ascii")
        umi = self._slice("umi")
        if umi:
            d["__umi__"] = umi.decode("ascii")
        return d


class NativeBamReader:
    """BamReader-compatible streaming reader backed by the native
    scanner; string aux tags are limited to the requested barcode/UMI
    tags (exposed as tags['__bc__'] / tags['__umi__'])."""

    def __init__(self, path: str, bc_tag: str = "", umi_tag: str = "",
                 trim_len: int = -1):
        from ..native import BamScan

        self._args = (path, bc_tag, umi_tag, trim_len)
        self._scan = BamScan(path, bc_tag, umi_tag, trim_len)
        self.path = path
        self.ref_names = self._scan.ref_names
        self.ref_lens = self._scan.ref_lens
        self.header_text = self._scan.header_text
        self.name_to_tid = {n: i for i, n in enumerate(self.ref_names)}

    def rewind(self):
        self._scan.close()
        from ..native import BamScan

        self._scan = BamScan(*self._args)

    def __iter__(self):
        while True:
            b = self._scan.scan()
            if b is None:
                return
            fields, hashes, offs, blobs = b
            rows = fields.tolist()
            hs = hashes.tolist()
            offl = {k: v.tolist() for k, v in offs.items()}
            for i in range(len(rows)):
                yield _RecView(rows[i], i, offl, blobs, hs[i])

    def scan_blocks(self):
        """Yield raw (fields, hashes, offs, blobs) batches."""
        while True:
            b = self._scan.scan()
            if b is None:
                return
            yield b


def _general_info(reader: "NativeBamReader", sample_max: int = 100000):
    """Sample read length / fragment stats (alignments.hpp:597-690),
    vectorized over the native scan's batch columns (flag, tid, pos,
    mtid, mpos, l_seq)."""
    len_chunks: List[np.ndarray] = []
    mate_chunks: List[np.ndarray] = []
    total = 0
    has_mate = 0
    while total < sample_max:
        fields = reader._scan.scan_headers()
        if fields is None:
            break
        f = fields[(fields[:, 0] & 0x900) == 0]
        if total + len(f) > sample_max:
            f = f[:sample_max - total]
        flag = f[:, 0]
        len_chunks.append(f[:, 7])
        md = ((f[:, 1] == f[:, 4]) & (f[:, 2] < f[:, 5])
              & (((flag >> 4) ^ (flag >> 5)) & 1).astype(bool))
        mate_chunks.append((f[:, 5] - f[:, 2])[md].astype(np.int64))
        has_mate += int(np.count_nonzero(flag & 0x1))
        total += len(f)
    return _general_stats(len_chunks, mate_chunks, total, has_mate)


def _general_stats(len_chunks: List[np.ndarray],
                   mate_chunks: List[np.ndarray], total: int, has_mate: int):
    """Reduce sampled header columns to (read_len, frag_len, frag_stdev)
    — shared by the headers-only prepass and the fused single-scan path
    in extract_from_bam."""
    lens = (np.concatenate(len_chunks) if len_chunks
            else np.zeros(0, np.int32))
    read_len = int(lens.max()) if len(lens) else 0
    mate_diff = (np.concatenate(mate_chunks) if mate_chunks
                 else np.zeros(0, np.int64))
    # C integer division (alignments.hpp:660: hasMateCnt >=
    # totalReadCnt/2).  When that gate passes with NO mate-diff samples
    # the reference divides by zero (k==0 at alignments.hpp:674) and
    # dies; we fall back to single-end mode instead (survival deviation,
    # pinned by test_missing_qual_records_emit_space_quals).
    if total and has_mate >= total // 2 and len(mate_diff):
        mate_diff.sort()
        k = max(int(len(mate_diff) * 0.7), 1)
        vals = mate_diff[:k] + read_len
        frag_len = int(vals.sum()) // k
        frag_stdev = int((int((vals * vals).sum()) // k
                          - frag_len * frag_len) ** 0.5)
        if frag_stdev == 0:
            frag_stdev = 1
    else:
        frag_len = read_len
        frag_stdev = 0
    return read_len, frag_len, frag_stdev


def _valid_alternative_chrom(name: str) -> bool:
    return "_" in name or "." in name or "*" in name


def _trim_name(name: str, trim_len: int) -> str:
    if trim_len == -1:
        if len(name) >= 2 and name[-2] == "/" and name[-1] in "12":
            return name[:-2]
        return name
    return name[:len(name) - trim_len]


def extract_from_bam(bam_path: str, coord_path: str, ref_fasta: str,
                     output_prefix: str, opts=None,
                     abnormal_unmap_flag: bool = False,
                     mate_id_len: int = -1,
                     bc_field: str = "", umi_field: str = "") -> dict:
    from ..constants import EXTRACTOR_KMER_LENGTH, encode_seq
    from ..core.extractor import LazyDeviceScreen, screen_flags
    from ..io.reads import read_seq_file
    from ..io.refset import RefSet
    from ..native import NativeEngine

    if opts is not None:
        bc_field = getattr(opts, "barcode_file", None) or bc_field

    refset = RefSet(digit_units=-1)
    for rec in read_seq_file(ref_fasta):
        refset.add_allele(rec.id, rec.seq, rec.comment)
    packed = refset.packed()

    reader = NativeBamReader(bam_path, bc_field, umi_field)

    # gene intervals
    genes: List[Tuple[int, int, int]] = []
    with open(coord_path) as f:
        toks = f.read().split()
    i = 0
    while i + 4 < len(toks):
        chrom, start, end = toks[i + 1], int(toks[i + 2]), int(toks[i + 3])
        tid = reader.name_to_tid.get(chrom, -1)
        genes.append((tid, start, end))
        i += 6
    genes.sort()

    # Batch pre-mask (conservative, exact under coordinate order): a
    # record can matter only if its template is unaligned, it sits on an
    # alternative contig, or it overlaps the union of the gene
    # intervals.  The exact per-record logic below (including the
    # reference's forward-only interval sweep) runs on the selected
    # subset only.
    is_alt = np.array(
        [_valid_alternative_chrom(n) for n in reader.ref_names] + [False])
    merged: List[Tuple[int, int, int]] = []
    for gtid, gs, ge in genes:
        if merged and merged[-1][0] == gtid and gs <= merged[-1][2]:
            merged[-1] = (gtid, merged[-1][1], max(merged[-1][2], ge))
        else:
            merged.append((gtid, gs, ge))
    SHIFT = 40
    mkey_start = np.array([(t << SHIFT) + st for t, st, _ in merged],
                          np.int64)
    mkey_end = np.array([(t << SHIFT) + en for t, _, en in merged], np.int64)

    # SINGLE scan for sampling + selection: the read-length/fragment
    # sampling (alignments.hpp:597-690) needs only the header fields and
    # the selection mask is independent of its outcome, so both run over
    # one scan_lazy stream — no headers-only prepass, no rewind, and the
    # BGZF prefix is inflated once instead of twice.  Only the batches
    # the stats sample needs are BUFFERED (selected views of the first
    # ~sample_max records; each fetch() call materializes its own blob
    # copies); once the engine is configured from the sampled stats, the
    # rest of the file streams straight through the pass-1 logic — a
    # WGS-scale BAM must not hold its full selected set in memory.
    sample_max = 100000

    def select_batch(fields, hashes, base):
        flag = fields[:, 0]
        tid = fields[:, 1]
        pos = fields[:, 2].astype(np.int64)
        span = fields[:, 8].astype(np.int64)
        nta = (((flag & 0xD) == 0xD) | ((flag & 0x5) == 0x4)
               | (tid < 0))
        aligned = ~(((flag & 0x4) != 0) | (tid < 0))
        alt = aligned & is_alt[np.where(tid < 0, len(is_alt) - 1, tid)]
        sel = nta | alt
        if len(merged):
            end = pos + span - 1
            key_s = (tid.astype(np.int64) << SHIFT) + pos
            key_e = (tid.astype(np.int64) << SHIFT) + end
            # overlap(union): exists m with end > m.start and
            # start <= m.end  (strictness mirrors the sweep)
            j = np.searchsorted(mkey_start, key_e, side="left") - 1
            jc = np.clip(j, 0, len(merged) - 1)
            ov = (j >= 0) & (key_s <= mkey_end[jc]) & aligned
            # also catch records starting before an interval that
            # still reach past its start
            j2 = np.searchsorted(mkey_start, key_s, side="right")
            j2c = np.clip(j2, 0, len(merged) - 1)
            ov |= ((j2 < len(merged)) & (key_e > mkey_start[j2c])
                   & ((tid.astype(np.int64)) == (mkey_start[j2c] >> SHIFT))
                   & aligned)
            sel |= ov
        idxs = np.flatnonzero(sel)
        out: List[Tuple[int, "_RecView"]] = []
        if len(idxs):
            offs, blobs = reader._scan.fetch(idxs)
            rows = fields[idxs].tolist()
            hs = hashes[idxs].tolist()
            for j, (r, i, h) in enumerate(zip(rows, idxs.tolist(), hs)):
                out.append((base + i, _RecView(r, j, offs, blobs, h)))
        return out

    len_chunks: List[np.ndarray] = []
    mate_chunks: List[np.ndarray] = []
    sampled = 0
    has_mate = 0
    buffered: List[Tuple[int, "_RecView"]] = []
    base = 0
    while sampled < sample_max:
        b = reader._scan.scan_lazy()
        if b is None:
            break
        fields, hashes = b
        f = fields[(fields[:, 0] & 0x900) == 0]
        if sampled + len(f) > sample_max:
            f = f[:sample_max - sampled]
        sflag = f[:, 0]
        len_chunks.append(f[:, 7])
        md = ((f[:, 1] == f[:, 4]) & (f[:, 2] < f[:, 5])
              & (((sflag >> 4) ^ (sflag >> 5)) & 1).astype(bool))
        mate_chunks.append((f[:, 5] - f[:, 2])[md].astype(np.int64))
        has_mate += int(np.count_nonzero(sflag & 0x1))
        sampled += len(f)
        buffered.extend(select_batch(fields, hashes, base))
        base += fields.shape[0]

    def rest_views():
        nonlocal base
        while True:
            b = reader._scan.scan_lazy()
            if b is None:
                return
            fields, hashes = b
            yield from select_batch(fields, hashes, base)
            base += fields.shape[0]

    read_len, frag_len, frag_stdev = _general_stats(
        len_chunks, mate_chunks, sampled, has_mate)
    paired = frag_stdev != 0

    hit_len = 21 if paired else 17
    if read_len // 5 > hit_len:
        hit_len = read_len // 5
    kmer_length = EXTRACTOR_KMER_LENGTH
    inferred = refset.infer_kmer_length()
    if inferred > kmer_length:
        kmer_length = inferred
        if kmer_length > hit_len:
            hit_len = kmer_length
    engine = NativeEngine(packed, kmer_length, hit_len_required=hit_len)

    # Device screen, same size-gated routing as the FASTQ extractor
    # (core/extractor.py LazyDeviceScreen): the exact phase-A program
    # screens flushed batches on the chip once the run has streamed
    # enough reads to amortize the per-process device setup; undecided
    # reads re-screen natively, so output stays byte-identical (which
    # also makes the mid-run switch safe).
    backend = getattr(opts, "backend", "auto") if opts is not None else "auto"

    def _build():
        from ..ops.phase_a import DeviceScreen
        # bam-extractor has no -s knob; HasHitInSet runs at the default
        # similarity (reference BamExtractor.cpp uses SeqSet defaults)
        return DeviceScreen.build(packed, kmer_length, hit_len, 0.8)

    get_screen = LazyDeviceScreen(backend, _build)

    if paired:
        fp1 = open(f"{output_prefix}_1.fq", "w")
        fp2 = open(f"{output_prefix}_2.fq", "w")
    else:
        fp1 = open(f"{output_prefix}.fq", "w")
        fp2 = None
    fp_bc = open(f"{output_prefix}_bc.fa", "w") if bc_field else None
    fp_umi = open(f"{output_prefix}_umi.fa", "w") if umi_field else None

    def out_rec(fp, name, seq, qual):
        if qual is not None:
            fp.write(f"@{name}\n{seq}\n+\n{qual}\n")
        else:
            fp.write(f">{name}\n{seq}\n")

    def out_bc(name, rec):
        if fp_bc is not None:
            bc = rec.tags.get("__bc__")
            fp_bc.write(f">{name}\n{bc if bc else 'missing_barcode'}\n")
        if fp_umi is not None:
            umi = rec.tags.get("__umi__")
            fp_umi.write(f">{name}\n{umi if umi else 'missing_barcode'}\n")

    candidates: Dict[str, List] = {}
    cand_hashes: List[int] = []
    used_names: Dict[str, int] = {}
    tag = 0
    n_out = 0

    # Pass 1 runs as collect -> batch-screen -> replay: the sequential
    # sweep/mate logic stays in the collect loop, the k-mer screen runs
    # as ONE native batch call per flush, and the order-dependent
    # bookkeeping (used_names, candidate registration, output order)
    # replays in the original record order, so outputs stay
    # byte-identical to the reference's record-at-a-time loop.
    jobs: List[tuple] = []
    screen_seqs: List[str] = []

    def want_screen(seq: str) -> int:
        screen_seqs.append(seq)
        return len(screen_seqs) - 1

    def flush_jobs():
        nonlocal jobs, screen_seqs, n_out
        if not jobs:
            return
        if screen_seqs:
            n = len(screen_seqs)
            device_screen = get_screen(n)
            lens = np.array([len(s) for s in screen_seqs], np.int64)
            starts = np.zeros(n, np.int64)
            starts[1:] = np.cumsum(lens[:-1])
            codes = encode_seq("".join(screen_seqs))
            # shared batched screen (core/extractor.py screen_flags):
            # low-complexity rule + device prefilter + exact native
            # re-screen — the same pipeline the FASTQ extractor runs
            hits, lc = screen_flags(codes, lens, starts, device_screen,
                                    engine)
            passed = hits.tolist()
            not_lc = (~lc).tolist()
        else:
            passed = []
            not_lc = []
        for job in jobs:
            kind = job[0]
            if kind == "pair":
                (_, name, seq1, qual1, seq2, qual2, bc_rec, swap,
                 s1, s2) = job
                if (not_lc[s1] and not_lc[s2]
                        and (passed[s1] or passed[s2])):
                    if swap:
                        seq1, seq2 = seq2, seq1
                        qual1, qual2 = qual2, qual1
                    out_rec(fp1, name, seq1, qual1)
                    out_rec(fp2, name, seq2, qual2)
                    out_bc(name, bc_rec)
                    n_out += 1
            elif kind == "sel":
                _, name, key, seq, qual, bc_rec, aligned, name_hash, si = job
                if paired:
                    if passed[si] and key not in candidates:
                        candidates[key] = [None, None, None, None]
                        cand_hashes.append(name_hash)
                else:
                    if aligned and name in used_names:
                        continue
                    if passed[si]:
                        if aligned:
                            used_names[name] = 1
                        out_rec(fp1, name, seq, qual)
                        out_bc(name, bc_rec)
                        n_out += 1
            else:  # "region": interval hit; only the low-complexity gate
                _, name, key, seq, qual, bc_rec, name_hash, si = job
                if not not_lc[si]:
                    continue
                if paired:
                    if key not in candidates:
                        candidates[key] = [None, None, None, None]
                        cand_hashes.append(name_hash)
                else:
                    if name in used_names:
                        continue
                    used_names[name] = 1
                    out_rec(fp1, name, seq, qual)
                    out_bc(name, bc_rec)
                    n_out += 1
        jobs = []
        screen_seqs = []

    want_tags = fp_bc is not None or fp_umi is not None

    class _BcTags:
        __slots__ = ("tags",)

        def __init__(self, tags):
            self.tags = tags

    def bc_snapshot(rec):
        return _BcTags(rec.tags if want_tags else {})

    import itertools

    it = itertools.chain(iter(buffered), rest_views())
    for orig_i, rec in it:
        if (not rec.is_template_aligned()) or (
            rec.is_aligned()
            and _valid_alternative_chrom(reader.ref_names[rec.tid])
        ):
            if (not rec.is_template_aligned()) and paired and not abnormal_unmap_flag:
                # both mates of an unaligned template arrive together
                seq1 = rec.original_seq()
                qual1 = rec.original_qual()
                name = _trim_name(rec.name, mate_id_len)
                nxt = next(it, None)
                mate = nxt[1] if nxt is not None else None
                if (mate is None or nxt[0] != orig_i + 1
                        or _trim_name(mate.name, mate_id_len) != name):
                    raise RuntimeError(
                        "Two reads from the unaligned fragment are not "
                        "showing up together. Use --abnormalUnmapFlag.")
                seq2 = mate.original_seq()
                qual2 = mate.original_qual()
                # mate order is decided from the SECOND record's
                # first-mate flag after advancing (BamExtractor.cpp:
                # 681: `!alignments.IsFirstMate()` queries the mate)
                jobs.append(("pair", name, seq1, qual1, seq2, qual2,
                             bc_snapshot(mate), mate.is_first_mate,
                             want_screen(seq1), want_screen(seq2)))
            else:
                seq = rec.original_seq()
                jobs.append(("sel", rec.name,
                             _trim_name(rec.name, mate_id_len), seq,
                             rec.original_qual(), bc_snapshot(rec),
                             rec.is_aligned(), rec.name_hash,
                             want_screen(seq)))
            if len(jobs) >= 65536:
                flush_jobs()
            continue

        if not rec.is_aligned():
            continue

        start = rec.pos
        end = rec.pos + rec.ref_span() - 1
        while tag < len(genes) and (rec.tid > genes[tag][0] or (
                rec.tid == genes[tag][0] and start > genes[tag][2])):
            tag += 1
        if tag >= len(genes):
            continue
        if rec.tid < genes[tag][0] or (
                rec.tid == genes[tag][0] and end <= genes[tag][1]):
            continue
        seq = rec.original_seq()
        jobs.append(("region", rec.name,
                     _trim_name(rec.name, mate_id_len), seq,
                     rec.original_qual(), bc_snapshot(rec), rec.name_hash,
                     want_screen(seq)))
        if len(jobs) >= 65536:
            flush_jobs()
    flush_jobs()

    if not paired:
        fp1.close()
        if fp_bc:
            fp_bc.close()
        if fp_umi:
            fp_umi.close()
        return {"candidates": n_out}

    # second pass: recover both mates by name (hash-prefiltered)
    reader.rewind()
    remaining = len(candidates)
    hash_arr = np.unique(np.array(cand_hashes, dtype=np.uint64))

    def pass2_views():
        while True:
            b = reader._scan.scan_lazy()
            if b is None:
                return
            fields, hashes = b
            flag = fields[:, 0]
            m = np.isin(hashes, hash_arr) & ((flag & 0x900) == 0)
            if not abnormal_unmap_flag:
                tid = fields[:, 1]
                m &= ~(((flag & 0xD) == 0xD) | ((flag & 0x5) == 0x4)
                       | (tid < 0))
            idxs = np.flatnonzero(m)
            if len(idxs):
                offs, blobs = reader._scan.fetch(idxs)
                rows = fields[idxs].tolist()
                for j, r in enumerate(rows):
                    yield _RecView(r, j, offs, blobs, 0)

    for rec in pass2_views():
        if remaining == 0:
            break
        name = _trim_name(rec.name, mate_id_len)
        ent = candidates.get(name)
        if ent is None:
            continue
        seq = rec.original_seq()
        qual = rec.original_qual()
        if rec.is_first_mate:
            ent[0], ent[1] = seq, qual
        else:
            ent[2], ent[3] = seq, qual
        if ent[0] is not None and ent[2] is not None:
            out_rec(fp1, name, ent[0], ent[1])
            out_rec(fp2, name, ent[2], ent[3])
            out_bc(name, rec)
            ent[0] = ent[2] = None
            remaining -= 1
            n_out += 1

    fp1.close()
    fp2.close()
    if fp_bc:
        fp_bc.close()
    if fp_umi:
        fp_umi.close()
    return {"candidates": n_out}
