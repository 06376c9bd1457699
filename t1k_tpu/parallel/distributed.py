"""Host-sharded genotyping: the multi-host execution model.

Each host owns a contiguous shard of the input fragments, runs ingest ->
read assignment -> fragment assignment against its local replica of the
reference (engine + device), and ships only the per-fragment
assignment records (allele, span, float32 weights — a few bytes per
fragment-allele) plus its integer coverage tensor to the driver.  The
driver concatenates records in host order, sums the coverage tensors and
runs the global stages (coalesce -> ECs -> EM -> selection), optionally
sharding the EM over a device mesh (parallel/mesh.py).

This composition is *byte-identical* to the single-host pipeline:

* fragment records concatenated in host order reproduce the global
  fragment order, so float32 coalescing accumulates identically;
* the per-base coverage scatter is integer and additive, so per-host
  tensors sum to the global tensor regardless of how duplicate reads
  split across shards (per-shard multiplicities sum to the global one);
* read assignment itself is per-read and weight-independent.

The same entry point runs the shards in-process (workers = simulated
hosts), which is how the equivalence is tested; on a real cluster each
worker call maps to one host process.

Reference behavior contract: Genotyper.cpp:337-718 (single-node flow
this distributes).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def shard_bounds(n: int, workers: int) -> List[tuple]:
    """Contiguous fragment shards, reference thread-split convention
    (Genotyper.cpp:132-135)."""
    base = n // workers
    out = []
    for w in range(workers):
        lo = base * w
        hi = n if w == workers - 1 else base * (w + 1)
        out.append((lo, hi))
    return out


def _load_reads(reads1: List[str], reads2: Optional[List[str]]):
    from ..io.reads import read_seq_files

    has_mate = reads2 is not None
    ids1, seqs1 = [], []
    ids2, seqs2 = [], []
    it1 = read_seq_files(reads1)
    it2 = read_seq_files(reads2) if has_mate else None
    for rec1 in it1:
        rec2 = next(it2) if has_mate else None
        ids1.append(rec1.id)
        seqs1.append(rec1.seq)
        if has_mate:
            ids2.append(rec2.id)
            seqs2.append(rec2.seq)
    return ids1, seqs1, ids2, seqs2


def _worker_stage(packed, opts, s1: List[str], s2: List[str],
                  has_mate: bool):
    """The per-host stage: read assignment + fragment assignment on one
    contiguous fragment shard.  Returns (frag_rec, frag_counts, flags,
    pos_weight) — the only data that crosses hosts."""
    from ..constants import GENOTYPER_KMER_LENGTH
    from ..core.pipeline import assign_unique_reads, resolve_backend
    from ..native import NativeEngine

    engine = NativeEngine(
        packed, GENOTYPER_KMER_LENGTH,
        ref_seq_similarity=opts.ref_seq_similarity,
        relax_intron_align=opts.relax_intron_align,
        threads=opts.threads,
    )
    all_seqs = s1 + s2
    _, group_of, _, _ = assign_unique_reads(
        engine, all_seqs, dp_backend=resolve_backend(opts.backend),
        store_results=False)
    n = len(s1)
    has_n = np.array(
        [("N" in a) or (has_mate and "N" in b)
         for a, b in zip(s1, s2 if has_mate else [""] * n)],
        dtype=np.uint8)
    uid1 = group_of[:n]
    uid2 = (group_of[n:] if has_mate
            else np.full(n, -1, dtype=np.int64))
    rec, counts, flags = engine.fragment_batch(
        uid1, uid2, has_n, has_mate, opts.max_assign_cnt, None)
    pw = engine.pos_weight()
    del engine
    return rec, counts, flags, pw


def _merge_and_finish(refset, packed, opts, ids1, seqs1, ids2, seqs2,
                      frag_rec, frag_counts, aligned_flags, pos_weight,
                      output_prefix: str):
    """The driver stage: global order restored by host-order concat,
    then coalesce -> ECs -> EM -> selection -> outputs."""
    from ..core.genotyper import Genotyper, GenotyperConfig
    from ..core.pipeline import log

    has_mate = bool(seqs2)
    read_cnt = len(seqs1)
    max_read_length = max(
        [len(s) for s in seqs1] + [len(s) for s in seqs2] + [0])
    gcfg = GenotyperConfig(
        filter_frac=opts.filter_frac, filter_cov=opts.filter_cov,
        cross_gene_rate=opts.cross_gene_rate,
        max_assign_cnt=opts.max_assign_cnt,
        min_squarem_alpha=opts.min_squarem_alpha,
        read_length=max_read_length, em_backend=opts.em_backend,
    )
    genotyper = Genotyper(refset, gcfg)
    aligned_fragment_cnt = genotyper.coalesce_arrays(frag_rec, frag_counts)
    genotyper.finalize(pos_weight, packed)
    log(f"Finish read fragment assignments. {aligned_fragment_cnt} read "
        f"fragments can be assigned.")
    em_iters = genotyper.quantify()
    log(f"Finish allele quantification in {em_iters} EM iterations.")
    genotyper.remove_low_likelihood()
    genotyper.select_alleles()

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
    log("Genotyping finishes.")
    return genotyper


def run_genotyper_distributed(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    output_prefix: str,
    opts=None,
    n_workers: int = 2,
):
    """Sharded equivalent of core.pipeline.run_genotyper (subset: the
    standard paired/single genotyping flow; barcode and whitelist paths
    go through the single-host driver).  Runs the shards in-process —
    the multi-process CLI flavor lives in worker_shard_to_file /
    merge_shards_and_finish (cli/run.py distributed mode)."""
    from ..core.pipeline import GenotypeOptions, log
    from ..io.refset import RefSet

    opts = opts or GenotypeOptions()
    refset = RefSet.from_fasta(ref_fasta, opts.digit_units, opts.delimiter)
    packed = refset.packed()

    has_mate = reads2 is not None
    ids1, seqs1, ids2, seqs2 = _load_reads(reads1, reads2)
    read_cnt = len(seqs1)
    log(f"Distributed genotyping over {n_workers} workers, "
        f"{read_cnt} fragments.")

    frag_rec_parts, frag_count_parts, flag_parts = [], [], []
    pos_weight = None
    for (lo, hi) in shard_bounds(read_cnt, n_workers):
        rec, counts, flags, pw = _worker_stage(
            packed, opts, seqs1[lo:hi], seqs2[lo:hi] if has_mate else [],
            has_mate)
        frag_rec_parts.append(rec)
        frag_count_parts.append(counts)
        flag_parts.append(flags)
        pos_weight = pw if pos_weight is None else pos_weight + pw

    frag_rec = (np.concatenate(frag_rec_parts)
                if frag_rec_parts else np.zeros((0, 6)))
    frag_counts = np.concatenate(frag_count_parts)
    aligned_flags = np.concatenate(flag_parts).tolist()
    return _merge_and_finish(
        refset, packed, opts, ids1, seqs1, ids2, seqs2,
        frag_rec, frag_counts, aligned_flags, pos_weight, output_prefix)


# ------------------------------------------------------- multi-process CLI
#
# The CLI flavor of the same model: each PROCESS runs the per-host stage
# on its contiguous fragment shard and publishes the shard file; process
# 0 merges in process order and runs the global stages.  Exchange is
# file-based (atomic rename), matching the framework's stage-boundary
# philosophy (run-t1k's files-between-stages contract) — restartable,
# coordinator-free, byte-identical at any process count.  The collective
# in-EM path (jax.distributed + psum across hosts) is a separate,
# explicitly-invoked mechanism (parallel/multihost.py): the merged EM
# here runs under the genotyper's normal backend routing, which keeps
# the default CLI contract byte-exact.


def wait_for_files(paths: List[str], timeout_s: float = 600.0,
                   poll_s: float = 0.2) -> None:
    import time

    deadline = time.monotonic() + timeout_s
    missing = list(paths)
    while missing:
        missing = [p for p in missing if not os.path.exists(p)]
        if not missing:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"distributed barrier timed out waiting for: {missing[:4]}")
        time.sleep(poll_s)


def worker_shard_to_file(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    opts,
    pid: int,
    nproc: int,
    out_path: str,
) -> None:
    """One process's per-host stage: slice shard `pid` of `nproc` from
    the input fragments, assign, and publish the shard file atomically."""
    from ..core.pipeline import log
    from ..io.refset import RefSet

    refset = RefSet.from_fasta(ref_fasta, opts.digit_units, opts.delimiter)
    packed = refset.packed()
    has_mate = reads2 is not None
    _, seqs1, _, seqs2 = _load_reads(reads1, reads2)
    lo, hi = shard_bounds(len(seqs1), nproc)[pid]
    log(f"Distributed worker {pid}/{nproc}: fragments [{lo}, {hi}).")
    rec, counts, flags, pw = _worker_stage(
        packed, opts, seqs1[lo:hi], seqs2[lo:hi] if has_mate else [],
        has_mate)
    tmp = f"{out_path}.tmp.{pid}"
    np.savez(tmp, rec=rec, counts=counts, flags=flags, pos_weight=pw)
    os.replace(tmp + ".npz", out_path)
    log(f"Distributed worker {pid}/{nproc}: shard published.")


def merge_shards_and_finish(
    ref_fasta: str,
    reads1: List[str],
    reads2: Optional[List[str]],
    output_prefix: str,
    opts,
    shard_paths: List[str],
):
    """Process 0's driver stage: concatenate the published shards in
    process order and run the global pipeline tail."""
    from ..io.refset import RefSet

    refset = RefSet.from_fasta(ref_fasta, opts.digit_units, opts.delimiter)
    packed = refset.packed()
    ids1, seqs1, ids2, seqs2 = _load_reads(reads1, reads2)

    frag_rec_parts, frag_count_parts, flag_parts = [], [], []
    pos_weight = None
    for p in shard_paths:
        with np.load(p) as z:
            frag_rec_parts.append(z["rec"])
            frag_count_parts.append(z["counts"])
            flag_parts.append(z["flags"])
            pw = z["pos_weight"]
        pos_weight = pw if pos_weight is None else pos_weight + pw
    frag_rec = (np.concatenate(frag_rec_parts)
                if frag_rec_parts else np.zeros((0, 6)))
    frag_counts = np.concatenate(frag_count_parts)
    aligned_flags = np.concatenate(flag_parts).tolist()
    return _merge_and_finish(
        refset, packed, opts, ids1, seqs1, ids2, seqs2,
        frag_rec, frag_counts, aligned_flags, pos_weight, output_prefix)
