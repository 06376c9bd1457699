"""End-to-end genotyping pipeline (the reference `genotyper` stage).

Flow (reference Genotyper.cpp:194-738):
  load reference -> read fastq (both mates into one pool) -> sort by
  sequence so duplicate reads share one alignment -> read-end assignment
  (native engine or device backend) -> mate pairing / fragment assignment
  -> coalesce identical assignment vectors -> equivalence classes -> EM ->
  allele selection -> outputs (genotype.tsv, allele.tsv, aligned fastas).
"""

from __future__ import annotations

import time
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import (
    DEFAULT_MAX_ASSIGN_CNT,
    DEFAULT_REF_SEQ_SIMILARITY,
    GENOTYPER_KMER_LENGTH,
    encode_seq,
)
from ..io.reads import read_seq_files
from ..io.refset import RefSet
from .fragment import OverlapRec
from .genotyper import Genotyper, GenotyperConfig


def log(msg: str) -> None:
    ts = time.strftime("%a %b %d %H:%M:%S %Y")
    print(f"[{ts}] {msg}", file=sys.stderr)


@dataclass
class GenotypeOptions:
    ref_seq_similarity: float = DEFAULT_REF_SEQ_SIMILARITY
    relax_intron_align: bool = False
    max_assign_cnt: int = DEFAULT_MAX_ASSIGN_CNT
    filter_frac: float = 0.15
    filter_cov: float = 1.0
    cross_gene_rate: float = 0.04
    min_squarem_alpha: float = 0.0
    digit_units: int = -1
    delimiter: str = ""
    allele_whitelist: Optional[str] = None
    abundance_file: Optional[str] = None
    em_state_file: Optional[str] = None  # resume EM from a prior snapshot
    barcode_file: Optional[str] = None
    output_read_assignment: bool = False
    threads: int = 1
    # Alignment backend: "auto" picks "device" when a GPU is attached
    # (the deferred small-DP batches then run on the card via the
    # descriptor service) and "native" otherwise; both are
    # byte-identical.
    backend: str = "auto"
    # device backend: reads per deferred-DP cycle.  2048 keeps each
    # chunk's flat SoA arenas (~90MB of overlaps at HLA overlap density)
    # cache/TLB-friendly for the host's finish pass
    # (benchmarks/defer_host.py times the host half at other sizes).
    defer_chunk: int = 2048
    em_backend: str = "auto"
    # Phase-A-lite: the device pre-computes each read's surviving
    # candidate (strand, seq) buckets (ops/phase_a.py DeviceCandidates,
    # exact pre-DP chain filters) and the host engine skips hit
    # collection for pruned buckets — byte-identical by construction
    # (parity-tested against the engine's overlap-bucket oracle).  Off
    # by default.
    device_candidates: bool = False


DEVICE_BACKENDS = ("device", "tpu")  # "tpu": the former name, kept as an alias


class DeviceUnavailableError(RuntimeError):
    """A device route was forced on a host where JAX finds no GPU."""


def canonical_backend(backend: str) -> str:
    return "device" if backend in DEVICE_BACKENDS else backend


def _platform_env_pins_cpu() -> bool:
    import os

    plats = os.environ.get("JAX_PLATFORMS", "")
    return plats.split(",")[0].strip().lower() == "cpu"


def _gpu_in_process() -> bool:
    """Does JAX, in this process, run on a GPU?"""
    import jax

    return jax.devices()[0].platform == "gpu"


def require_device(what: str) -> None:
    """A forced device route must find a GPU: raise rather than run the
    device programs somewhere else.  The one exception is an explicit
    JAX_PLATFORMS=cpu pin, under which the same XLA programs run on the
    CPU (how the tests exercise them)."""
    if _platform_env_pins_cpu() or _gpu_in_process():
        return
    raise DeviceUnavailableError(
        f"{what} needs a GPU, but JAX finds none (set JAX_PLATFORMS=cpu "
        "to run the device programs on the CPU)")


def device_rtt_ms(reps: int = 3) -> float:
    """Median round trip of a tiny host->device->host transfer."""
    import jax

    x = np.zeros(8, np.int32)
    np.asarray(jax.device_put(x))  # first-use setup stays outside the timing
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(jax.device_put(x))
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def device_present() -> bool:
    """Is a GPU attached to this process?

    The routing predicate of the bulk-compute stages (EM at scale, the
    extraction screen, cohort EM), which ship MBs once and iterate on
    the device.  T1K_BACKEND=native|device forces the verdict (a forced
    device verdict still needs a GPU, see require_device);
    T1K_DEVICE_PRESENT=0|1 pins it, which is how worker processes that
    must stay off the card are told so."""
    import os

    env = canonical_backend(os.environ.get("T1K_BACKEND", ""))
    if env == "native":
        return False
    if env == "device":
        require_device("T1K_BACKEND=device")
        return True
    pinned = os.environ.get("T1K_DEVICE_PRESENT", "")
    if pinned in ("0", "1"):
        return pinned == "1"
    if _platform_env_pins_cpu():
        return False
    return _gpu_in_process()


def resolve_backend(backend: str) -> str:
    """Resolve the alignment/DP backend to "native" or "device".

    "auto" routes the deferred-DP offload to the device when this
    process runs on a GPU whose round trip (device_rtt_ms) is below
    T1K_DEVICE_RTT_MS (default 10 ms): the offload pays one round trip
    per read chunk.  A pinned T1K_DEVICE_PRESENT=0 or a JAX_PLATFORMS
    pin that leads with "cpu" resolves native without touching JAX.  An
    explicit "device" (flag or T1K_BACKEND) must find a GPU.  Both
    routes give byte-identical outputs."""
    import os

    backend = canonical_backend(backend)
    if backend == "auto":
        backend = canonical_backend(os.environ.get("T1K_BACKEND", "")) or "auto"
    if backend == "device":
        require_device("the device backend")
        return "device"
    if backend != "auto":
        return backend
    if (os.environ.get("T1K_DEVICE_PRESENT", "") == "0"
            or _platform_env_pins_cpu() or not _gpu_in_process()):
        return "native"
    limit = float(os.environ.get("T1K_DEVICE_RTT_MS", "10"))
    return "device" if device_rtt_ms() <= limit else "native"


@dataclass
class GenotypeResult:
    genotyper: Genotyper
    refset: RefSet
    aligned_flags: List[bool]
    read_ids1: List[str]
    read_ids2: List[str]
    read_seqs1: List[str]
    read_seqs2: List[str]
    barcodes: Optional[List[str]]
    em_iterations: int
    aligned_fragment_cnt: int
    fragment_assignments: Optional[List] = None  # used by the analyzer stage


def assign_unique_reads(
    engine, seqs: List[str], zero_weights: bool = False,
    dp_backend: str = "native", store_results: bool = True,
    defer_chunk: int = 0, device_candidates=None, counters=None,
) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
    """Group identical read sequences; run the engine once per unique
    sequence with the group size as the coverage weight
    (Genotyper.cpp:450-479).  The analyzer stage passes zero weights so
    base coverage is left untouched (Analyzer.cpp:142).

    With dp_backend="device" the gap-fill and overhang alignments are
    batched to the device band DP (ops/align.py) via the engine's
    deferred-DP descriptor mode (the reference and reads stay
    device-resident; only index tuples cross the link); the DP is
    bit-exact vs the native DP, so results are byte-identical.  When
    `counters` is a dict, the number of items the device scored and of
    DP slices it ran per length bucket are stored there."""
    order = sorted(range(len(seqs)), key=lambda i: seqs[i])
    uniq: List[str] = []
    weights: List[int] = []
    group_of = np.zeros(len(seqs), dtype=np.int64)
    i = 0
    while i < len(order):
        j = i + 1
        while j < len(order) and seqs[order[j]] == seqs[order[i]]:
            j += 1
        for k in range(i, j):
            group_of[order[k]] = len(uniq)
        uniq.append(seqs[order[i]])
        weights.append(0 if zero_weights else j - i)
        i = j

    if uniq:
        codes = np.concatenate([encode_seq(s) for s in uniq])
    else:
        codes = np.zeros(0, dtype=np.int8)
    lens = np.array([len(s) for s in uniq], dtype=np.int32)
    starts = np.zeros(len(lens), dtype=np.int64)
    if len(lens):
        starts[1:] = np.cumsum(lens[:-1])
    w = np.array(weights, dtype=np.int32)
    if device_candidates is not None and len(uniq):
        # phase-A-lite: device computes the surviving candidate buckets
        # (exact pre-DP chain filters); the engine skips the rest
        L = int(lens.max())
        padded = np.full((len(uniq), L), 4, dtype=np.int8)
        for i in range(len(uniq)):
            padded[i, :lens[i]] = codes[starts[i]:starts[i] + lens[i]]
        c_reads, c_seqs, c_strands, undecided = device_candidates.generate(
            padded, lens)
        engine.set_candidates(len(uniq), c_reads, c_seqs, c_strands,
                              undecided)
    if dp_backend == "device":
        from ..ops.align import DeferredDescService

        service = DeferredDescService()
        rec, off = engine.assign_batch_deferred(
            codes, starts, lens, w, desc_service=service,
            store_results=store_results,
            chunk_size=defer_chunk if not store_results else 0)
        if counters is not None:
            counters["device_dp_item_count"] = service.items_scored
            for lb, n in service.slices.items():
                counters[f"device_dp_slices_lb{lb}"] = n
    else:
        rec, off = engine.assign_batch(codes, starts, lens, w,
                                       store_results=store_results)
    if device_candidates is not None and len(uniq):
        engine.set_candidates(0, None, None, None, None)  # clear
    return uniq, group_of, rec, off


def overlap_lists_from_records(rec: np.ndarray, off: np.ndarray) -> List[List[OverlapRec]]:
    out = []
    for i in range(len(off) - 1):
        out.append([OverlapRec.from_row(rec[k]) for k in range(off[i], off[i + 1])])
    return out


@dataclass
class PreparedGenotype:
    """Pipeline state after fragment assignment, before EM — the seam
    where a cohort driver batches many cells' EM problems into one
    device program (tools/smartseq.py --cohortEm)."""
    genotyper: Genotyper
    refset: RefSet
    opts: GenotypeOptions
    aligned_flags: List[bool]
    read_ids1: List[str]
    read_ids2: List[str]
    read_seqs1: List[str]
    read_seqs2: List[str]
    barcodes: Optional[List[str]]
    aligned_fragment_cnt: int
    assign_rows: Optional[List[str]]
    has_mate: bool


def run_genotyper(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    output_prefix: str,
    opts: Optional[GenotypeOptions] = None,
    refset: Optional[RefSet] = None,
) -> GenotypeResult:
    prep = prepare_genotyper(ref_fasta, reads1, reads2, opts, refset)
    return finish_genotyper(prep, output_prefix)


def prepare_genotyper(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    opts: Optional[GenotypeOptions] = None,
    refset: Optional[RefSet] = None,
) -> PreparedGenotype:
    """Load reference + reads, run read/fragment assignment and EC
    construction; stop at the EM boundary (Genotyper.cpp:194-637)."""
    opts = opts or GenotypeOptions()
    if refset is None:
        refset = RefSet.from_fasta(ref_fasta, opts.digit_units, opts.delimiter)
    packed = refset.packed()

    from ..native import NativeEngine
    engine = NativeEngine(
        packed, GENOTYPER_KMER_LENGTH,
        ref_seq_similarity=opts.ref_seq_similarity,
        relax_intron_align=opts.relax_intron_align,
        threads=opts.threads,
    )

    has_mate = reads2 is not None

    # Ingest reads (+ optional per-read barcodes).
    ids1, seqs1, quals1 = [], [], []
    ids2, seqs2, quals2 = [], [], []
    barcodes: Optional[List[str]] = [] if opts.barcode_file else None
    bc_files = (opts.barcode_file
                if isinstance(opts.barcode_file, (list, tuple))
                else [opts.barcode_file])
    bc_iter = (iter(read_seq_files(bc_files))
               if opts.barcode_file else None)
    it1 = read_seq_files(reads1)
    it2 = read_seq_files(reads2) if has_mate else None
    for rec1 in it1:
        rec2 = next(it2) if has_mate else None
        if bc_iter is not None:
            bc = next(bc_iter)
            if bc.seq == "missing_barcode":
                continue
            barcodes.append(bc.seq)
        ids1.append(rec1.id)
        seqs1.append(rec1.seq)
        quals1.append(rec1.qual)
        if has_mate:
            ids2.append(rec2.id)
            seqs2.append(rec2.seq)
            quals2.append(rec2.qual)

    read_cnt = len(seqs1)
    max_read_length = 0
    for s in seqs1:
        max_read_length = max(max_read_length, len(s))
    for s in seqs2:
        max_read_length = max(max_read_length, len(s))

    gcfg = GenotyperConfig(
        filter_frac=opts.filter_frac, filter_cov=opts.filter_cov,
        cross_gene_rate=opts.cross_gene_rate,
        max_assign_cnt=opts.max_assign_cnt,
        min_squarem_alpha=opts.min_squarem_alpha,
        read_length=max_read_length, em_backend=opts.em_backend,
    )
    genotyper = Genotyper(refset, gcfg)
    if opts.allele_whitelist:
        with open(opts.allele_whitelist) as f:
            genotyper.set_allele_whitelist(f.read().split())
    whitelist = genotyper.whitelist if opts.allele_whitelist else None

    from ..utils.observability import stage

    log(f"Found {read_cnt} read fragments. Start read assignment.")
    all_seqs = seqs1 + seqs2
    dev_cand = None
    if opts.device_candidates:
        from ..ops.phase_a import DeviceCandidates
        dev_cand = DeviceCandidates.build(
            packed, GENOTYPER_KMER_LENGTH, engine.hit_len_required)
    with stage("read_assignment") as ctx:
        uniq, group_of, rec, off = assign_unique_reads(
            engine, all_seqs, dp_backend=resolve_backend(opts.backend),
            store_results=False, defer_chunk=opts.defer_chunk,
            device_candidates=dev_cand, counters=ctx)
        ctx["read_count"] = len(all_seqs)
        ctx["unique_read_count"] = len(uniq)
        ctx["alignment_count"] = engine.last_assign_count
    del rec, off  # per-read results stay inside the engine
    log("Finish read end assignments.")

    has_n = np.array(
        [("N" in s1) or (has_mate and "N" in s2)
         for s1, s2 in zip(seqs1, seqs2 if has_mate else [""] * read_cnt)],
        dtype=np.uint8)
    uid1 = group_of[:read_cnt]
    uid2 = (group_of[read_cnt:] if has_mate
            else np.full(read_cnt, -1, dtype=np.int64))

    with stage("fragment_assignment") as sctx:
        frag_rec = frag_counts = None
        if opts.output_read_assignment:
            # the per-fragment records must cross into Python for the
            # assignment dump; coalesce host-side
            frag_rec, frag_counts, aligned_flags_arr = engine.fragment_batch(
                uid1, uid2, has_n, has_mate, opts.max_assign_cnt,
                whitelist if whitelist is not None else None)
            aligned_fragment_cnt = genotyper.coalesce_arrays(
                frag_rec, frag_counts)
        else:
            coalesced, assigned_cnt, frag_counts, aligned_flags_arr = (
                engine.fragment_batch_coalesced(
                    uid1, uid2, has_n, has_mate, opts.max_assign_cnt,
                    whitelist if whitelist is not None else None))
            aligned_fragment_cnt = genotyper.adopt_coalesced(
                coalesced, assigned_cnt)
        aligned_flags = aligned_flags_arr.tolist()
        pos_weight = engine.pos_weight()
        genotyper.finalize(pos_weight, packed)
        sctx["fragment_count"] = read_cnt
        sctx["aligned_fragment_count"] = aligned_fragment_cnt
        sctx["read_group_count"] = genotyper.read_group_count
        sctx["equivalence_class_count"] = len(genotyper.ec_to_alleles)

    assign_rows = None
    if opts.output_read_assignment:
        assign_rows = []
        off = np.zeros(read_cnt + 1, dtype=np.int64)
        off[1:] = np.cumsum(frag_counts)
        for i in range(read_cnt):
            for k in range(off[i], off[i + 1]):
                r = frag_rec[k]
                assign_rows.append(
                    f"{ids1[i]}\t{refset.alleles[int(r[0])].name}"
                    f"\t{int(r[1])}\t{int(r[2])}")
    log(f"Finish read fragment assignments. {aligned_fragment_cnt} read fragments "
        f"can be assigned.")
    return PreparedGenotype(
        genotyper=genotyper, refset=refset, opts=opts,
        aligned_flags=aligned_flags, read_ids1=ids1, read_ids2=ids2,
        read_seqs1=seqs1, read_seqs2=seqs2, barcodes=barcodes,
        aligned_fragment_cnt=aligned_fragment_cnt, assign_rows=assign_rows,
        has_mate=has_mate)


def finish_genotyper(
    prep: PreparedGenotype,
    output_prefix: str,
    em_result: Optional[Tuple[int, np.ndarray]] = None,
) -> GenotypeResult:
    """EM (or injected sufficient statistics), allele selection, and
    output writing (Genotyper.cpp:640-738).  `em_result` is (iterations,
    per-EC read counts) from an external quantification — the cohort
    driver's batched device EM."""
    opts = prep.opts
    genotyper = prep.genotyper
    refset = prep.refset
    ids1, ids2 = prep.read_ids1, prep.read_ids2
    seqs1, seqs2 = prep.read_seqs1, prep.read_seqs2
    aligned_flags = prep.aligned_flags
    aligned_fragment_cnt = prep.aligned_fragment_cnt
    assign_rows = prep.assign_rows
    barcodes = prep.barcodes
    has_mate = prep.has_mate
    read_cnt = len(seqs1)
    from ..utils.observability import metrics, stage

    if opts.abundance_file:
        genotyper.init_abundance_from_file(opts.abundance_file)
        em_iters = 0
    elif opts.em_state_file:
        genotyper.load_em_state(opts.em_state_file)
        em_iters = 0
        log("Resumed EM sufficient statistics from "
            f"{opts.em_state_file}; skipping quantification.")
    elif em_result is not None:
        em_iters = genotyper.set_em_result(*em_result)
        log(f"Adopted externally quantified abundances "
            f"({em_iters} EM iterations).")
    else:
        with stage("em_quantification") as ctx:
            em_iters = genotyper.quantify()
            ctx["em_iteration_count"] = em_iters
            ctx["em_route"] = genotyper.last_em_route
            genotyper.save_em_state(f"{output_prefix}_em_state.npz",
                                    genotyper._last_ec_read_count)
        log(f"Finish allele quantification in {em_iters} EM iterations.")
    with stage("allele_selection"):
        genotyper.remove_low_likelihood()
        genotyper.select_alleles()

    # ------------------------------------------------------------ outputs
    genotyper.write_genotype_tsv(f"{output_prefix}_genotype.tsv")
    with open(f"{output_prefix}_allele.tsv", "w") as f:
        for name, qual in genotyper.representative_alleles():
            f.write(f"{name} {qual}\n")

    suffix1 = "_aligned_1.fa" if has_mate else "_aligned.fa"
    with open(f"{output_prefix}{suffix1}", "w") as f:
        for i in range(read_cnt):
            if aligned_flags[i]:
                f.write(f">{ids1[i]}\n{seqs1[i]}\n")
    if has_mate:
        with open(f"{output_prefix}_aligned_2.fa", "w") as f:
            for i in range(read_cnt):
                if aligned_flags[i]:
                    f.write(f">{ids2[i]}\n{seqs2[i]}\n")
    if barcodes is not None:
        with open(f"{output_prefix}_aligned_bc.fa", "w") as f:
            for i in range(read_cnt):
                if aligned_flags[i]:
                    f.write(f">{ids1[i]}\n{barcodes[i]}\n")
    if assign_rows is not None:
        with open(f"{output_prefix}_assign.tsv", "w") as f:
            for row in assign_rows:
                f.write(row + "\n")

    metrics().save(f"{output_prefix}_metrics.json")
    log("Genotyping finishes.")
    return GenotypeResult(
        genotyper=genotyper, refset=refset, aligned_flags=aligned_flags,
        read_ids1=ids1, read_ids2=ids2, read_seqs1=seqs1, read_seqs2=seqs2,
        barcodes=barcodes, em_iterations=em_iters,
        aligned_fragment_cnt=aligned_fragment_cnt,
    )
