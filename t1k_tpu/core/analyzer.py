"""Post-analysis stage (the reference `analyzer`): re-align the aligned
reads against only the selected alleles, re-quantify, store full edit
walks, call novel SNPs, and emit the VCF plus barcode expression matrix.

Behavior contract: reference Analyzer.cpp:218-731.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..constants import GENOTYPER_KMER_LENGTH, encode_seq, revcomp_codes
from ..io.reads import read_seq_files
from ..io.refset import RefSet
from ..native import NativeEngine, align_global_batch
from .fragment import RefContext, fragment_assign, set_read_assignments
from .genotyper import Genotyper, GenotyperConfig
from ..utils.observability import metrics, stage
from .pipeline import assign_unique_reads, log, overlap_lists_from_records
from .variant import BarcodeSummary, VariantCaller


@dataclass
class AnalyzerOptions:
    ref_seq_similarity: float = 0.8
    relax_intron_align: bool = False
    max_assign_cnt: int = 2000
    digit_units: int = -1
    delimiter: str = ""
    barcode_file: Optional[str] = None
    var_max_group: int = 8
    threads: int = 1
    backend: str = "auto"


class _AnalyzerOverlap:
    """Overlap view carrying the edit walk for the variant caller."""
    __slots__ = ("seq_idx", "read_start", "read_end", "seq_start", "seq_end",
                 "strand", "match_cnt", "similarity", "align", "walk_cache")

    def __init__(self, rec):
        self.seq_idx = rec.seq_idx
        self.read_start = rec.read_start
        self.read_end = rec.read_end
        self.seq_start = rec.seq_start
        self.seq_end = rec.seq_end
        self.strand = rec.strand
        self.match_cnt = rec.match_cnt
        self.similarity = rec.similarity
        self.align = None
        self.walk_cache = None


class _AnalyzerFragment:
    __slots__ = ("seq_idx", "has_mate_pair", "o1_from_r2", "overlap1",
                 "overlap2", "r1_codes", "r2_codes", "o1_rc", "o2_rc",
                 "read_len1", "read_len2")

    def __init__(self, frag, r1_codes, r2_codes):
        self.seq_idx = frag.seq_idx
        self.has_mate_pair = frag.has_mate_pair
        self.o1_from_r2 = frag.o1_from_r2
        self.overlap1 = _AnalyzerOverlap(frag.overlap1)
        self.overlap2 = _AnalyzerOverlap(frag.overlap2) if frag.overlap2 else None
        self.r1_codes = r1_codes
        self.r2_codes = r2_codes
        self.o1_rc = None
        self.o2_rc = None
        self.read_len1 = len(r1_codes) if r1_codes is not None else 0
        self.read_len2 = len(r2_codes) if r2_codes is not None else 0


def _add_alignment_info_batch(frags_lists, refset) -> None:
    """Full-span edit walks for every overlap (SeqSet.hpp:2657-2680),
    all DP calls batched into one native call."""
    t_parts, p_parts, targets = [], [], []

    def enqueue(o: _AnalyzerOverlap, codes: np.ndarray):
        r = revcomp_codes(codes) if o.strand == -1 else codes
        t_parts.append(
            refset.alleles[o.seq_idx].codes[o.seq_start:o.seq_end + 1])
        p_parts.append(r[o.read_start:o.read_end + 1])
        targets.append(o)
        return r if o.strand == -1 else None

    for frags in frags_lists:
        for frag in frags:
            if frag.has_mate_pair:
                frag.o1_rc = enqueue(frag.overlap1, frag.r1_codes)
                frag.o2_rc = enqueue(frag.overlap2, frag.r2_codes)
            else:
                codes = frag.r2_codes if frag.o1_from_r2 else frag.r1_codes
                frag.o1_rc = enqueue(frag.overlap1, codes)
    for o, edits in zip(targets, align_global_batch(t_parts, p_parts)):
        o.align = edits


def run_analyzer(
    ref_fasta: str,
    allele_file: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    output_prefix: str,
    opts: Optional[AnalyzerOptions] = None,
) -> dict:
    opts = opts or AnalyzerOptions()
    has_mate = reads2 is not None

    selected = set()
    with open(allele_file) as f:
        for line in f:
            toks = line.split()
            if toks:
                selected.add(toks[0])

    refset = RefSet.from_fasta(ref_fasta, opts.digit_units, opts.delimiter,
                               selected_names=selected)
    packed = refset.packed()
    engine = NativeEngine(
        packed, GENOTYPER_KMER_LENGTH,
        ref_seq_similarity=opts.ref_seq_similarity,
        relax_intron_align=opts.relax_intron_align,
        threads=opts.threads,
    )

    ids1, seqs1 = [], []
    ids2, seqs2 = [], []
    barcodes: Optional[List[str]] = None
    barcode_idx: List[int] = []
    if opts.barcode_file:
        barcodes = []
        bc_names: List[str] = []
        bc_map = {}
        bc_files = (opts.barcode_file
                    if isinstance(opts.barcode_file, (list, tuple))
                    else [opts.barcode_file])
        bc_iter = iter(read_seq_files(bc_files))
    it1 = read_seq_files(reads1)
    it2 = read_seq_files(reads2) if has_mate else None
    for rec1 in it1:
        rec2 = next(it2) if has_mate else None
        if barcodes is not None:
            bc = next(bc_iter)
            if bc.seq == "missing_barcode":
                continue
            if bc.seq not in bc_map:
                bc_map[bc.seq] = len(bc_names)
                bc_names.append(bc.seq)
            barcode_idx.append(bc_map[bc.seq])
        ids1.append(rec1.id)
        seqs1.append(rec1.seq)
        if has_mate:
            ids2.append(rec2.id)
            seqs2.append(rec2.seq)

    read_cnt = len(seqs1)
    max_read_length = max([len(s) for s in seqs1 + seqs2], default=0)
    gcfg = GenotyperConfig(read_length=max_read_length)
    genotyper = Genotyper(refset, gcfg)

    log(f"Found {read_cnt} read fragments. Start read assignment.")
    all_seqs = seqs1 + seqs2
    with stage("analyzer_read_assignment", read_count=read_cnt) as st:
        from .pipeline import resolve_backend
        uniq, group_of, rec, off = assign_unique_reads(
            engine, all_seqs, zero_weights=True,
            dp_backend=resolve_backend(opts.backend), counters=st)
        overlap_lists = overlap_lists_from_records(rec, off)
        st["unique_read_count"] = len(uniq)
    log("Finish read end assignments.")

    ctx = RefContext(refset, hit_len_required=31,
                     relax_intron_align=opts.relax_intron_align,
                     ref_seq_similarity=opts.ref_seq_similarity)

    r1_codes = [encode_seq(s) for s in seqs1]
    r2_codes = [encode_seq(s) for s in seqs2] if has_mate else [None] * read_cnt

    fragment_assignments: List[List[_AnalyzerFragment]] = []
    per_read_assignments = []
    aligned_flags = [False] * read_cnt
    for i in range(read_cnt):
        ov1 = overlap_lists[group_of[i]]
        ov2 = overlap_lists[group_of[read_cnt + i]] if has_mate else None
        has_n = ("N" in seqs1[i]) or (has_mate and "N" in seqs2[i])
        frags = fragment_assign(ctx, ov1, ov2, has_n, has_mate)
        per_read_assignments.append(
            set_read_assignments(ctx, frags, None, opts.max_assign_cnt))
        if frags:
            aligned_flags[i] = True
        fragment_assignments.append(
            [_AnalyzerFragment(f, r1_codes[i],
                               r2_codes[i] if has_mate else None)
             for f in frags])

    aligned_cnt = genotyper.coalesce(per_read_assignments)
    genotyper.finalize(engine.pos_weight(), packed)
    log(f"Finish read fragment assignments. {aligned_cnt} read fragments can "
        f"be assigned.")
    em_iters = genotyper.quantify()
    log(f"Finish allele quantification in {em_iters} EM iterations.")

    with stage("alignment_info", fragment_count=aligned_cnt):
        _add_alignment_info_batch(
            (fragment_assignments[i] for i in range(read_cnt)
             if aligned_flags[i]), refset)

    vc = VariantCaller(refset, packed, opts.var_max_group)
    vc.set_seq_abundance(genotyper)
    with stage("variant_calling") as st:
        vc.compute(fragment_assignments)
        st["variant_count"] = len(vc.final_variants)
    vc.write_vcf(f"{output_prefix}_allele.vcf")

    if barcodes is not None:
        summary = BarcodeSummary(refset)
        for i in range(read_cnt):
            if not aligned_flags[i]:
                continue
            summary.add_fragment(barcode_idx[i], vc, fragment_assignments[i])
        summary.write(f"{output_prefix}_barcode_expr.tsv", bc_names)

    log("Post analysis finishes.")
    metrics().save(f"{output_prefix}_analyzer_metrics.json")
    return {"em_iterations": em_iters, "variants": len(vc.final_variants)}
