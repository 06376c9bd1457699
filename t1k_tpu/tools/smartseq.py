"""SMART-seq single-cell pipeline (reference t1k-smartseq.pl).

Per-cell genotyping -> cross-cell allele voting -> reduced reference of
the winning alleles -> per-cell re-genotyping against the reduced
reference (--noExtraction).  Cells are independent, so both per-cell
passes dispatch over a worker pool (`--workers N`): each worker
processes a cell shard against its own replica of the reference, on the
host (only one process may hold the card).  The
cross-cell voting and reduced-reference construction are global
barriers between the two passes, exactly as in t1k-smartseq.pl.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from typing import List, Optional

from ..io.reads import read_seq_file
from .merge import merge_genotypes


def run_cell(args_common: dict, ref: str, file1: str, file2: Optional[str],
             outdir: str, prefix: str, no_extraction: bool = False) -> str:
    from ..cli.run import main as run_main

    os.makedirs(outdir, exist_ok=True)
    argv = ["-f", ref, "-o", prefix, "--od", outdir]
    if no_extraction:
        argv.append("--noExtraction")
    for k, v in args_common.items():
        argv.extend([k, str(v)] if v is not True else [k])
    if file2:
        argv.extend(["-1", file1, "-2", file2])
    else:
        argv.extend(["-u", file1])
    run_main(argv)
    return os.path.join(outdir, f"{prefix}_genotype.tsv")


# What a pool worker runs with: JAX pinned to the CPU and every stage on
# the native engine.  A JAX process reserves most of a GPU's memory when
# it first touches it, so with a pool only this parent process may keep
# the card; the host engine is byte-identical to the device routes.
WORKER_ENV = {"JAX_PLATFORMS": "cpu", "T1K_BACKEND": "native"}
WORKER_ARGS = {"--backend": "native", "--emBackend": "native"}


def _pin_worker_off_device() -> None:
    os.environ.update(WORKER_ENV)


def _run_cells(jobs: list, workers: int) -> List[str]:
    """Dispatch independent per-cell pipelines over a process pool (cell
    shards; results returned in cell order).  Pool workers are pinned
    off the device (WORKER_ENV, WORKER_ARGS)."""
    if workers <= 1 or len(jobs) <= 1:
        return [run_cell(*job) for job in jobs]
    jobs = [(dict(job[0], **WORKER_ARGS),) + tuple(job[1:]) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(jobs)),
                  initializer=_pin_worker_off_device) as pool:
        return pool.starmap(run_cell, jobs)


def _run_cells_cohort(jobs: list, mesh=None) -> List[str]:
    """Second-pass cells with ONE batched device EM: cells are a batched
    axis of the quantification (north-star config 5; the reference's
    analog is an independent genotyper process per cell,
    t1k-smartseq.pl:160-184).  Per-cell alignment and EC construction
    run in-process against a shared parsed reference; every cell's EC
    problem is then stacked and quantified in a single jitted SQUAREM
    while_loop (ops/em.py em_quantify_jax_batched — with a mesh the cell
    axis shards across its devices); selection and outputs finish per
    cell.  Float-tolerance path: the device EM matches the native f64
    oracle to float32 tolerance, not byte-exactly."""
    from ..cli.run import resolve_preset
    from ..core.pipeline import (GenotypeOptions, finish_genotyper,
                                 prepare_genotyper)
    from ..io.refset import RefSet
    from ..ops.em import em_quantify_jax_batched

    refset = None
    preps, prefixes = [], []
    for t1k_args, ref, f1, f2, outdir, prefix, _no_extraction in jobs:
        geno_sim, _, relax = resolve_preset(
            t1k_args.get("--preset", ""),
            float(t1k_args["-s"]) if "-s" in t1k_args else None,
            "--relaxIntronAlign" in t1k_args)
        if refset is None:
            refset = RefSet.from_fasta(ref)
        opts = GenotypeOptions(
            ref_seq_similarity=geno_sim, relax_intron_align=relax,
            threads=int(t1k_args.get("-t", 1)))
        os.makedirs(outdir, exist_ok=True)
        preps.append(prepare_genotyper(ref, [f1], [f2] if f2 else None,
                                       opts, refset=refset))
        prefixes.append(os.path.join(outdir, prefix))

    g0 = preps[0].genotyper
    results = em_quantify_jax_batched(
        [p.genotyper.em_problem() for p in preps],
        g0.allele_eff_len, g0.allele_gene, g0.allele_major,
        g0.gene_cnt, g0.major_cnt,
        filter_frac=g0.cfg.filter_frac,
        min_squarem_alpha=g0.cfg.min_squarem_alpha,
        mesh=mesh)

    out = []
    for prep, res, prefix in zip(preps, results, prefixes):
        finish_genotyper(prep, prefix, em_result=res)
        out.append(f"{prefix}_genotype.tsv")
    return out


def run_smartseq(
    read1_list: str,
    read2_list: Optional[str],
    ref: str,
    output_prefix: str = "T1K",
    t1k_args: Optional[dict] = None,
    workers: int = 1,
    cohort_em: bool = False,
    mesh=None,
) -> str:
    """Returns the path of the final merged genotype matrix."""
    t1k_args = dict(t1k_args or {})
    with open(read1_list) as f:
        files1 = [line.strip() for line in f if line.strip()]
    files2: List[Optional[str]] = [None] * len(files1)
    if read2_list:
        with open(read2_list) as f:
            files2 = [line.strip() for line in f if line.strip()]

    cells = []
    jobs = []
    for f1, f2 in zip(files1, files2):
        cell = os.path.basename(f1).split(".")[0]
        outdir = f"{output_prefix}_{cell}"
        jobs.append((t1k_args, ref, f1, f2, outdir, cell))
        cells.append(cell)
    genotype_files = _run_cells(jobs, workers)
    with open(f"{output_prefix}_genotype_list.out", "w") as f:
        f.write("".join(p + "\n" for p in genotype_files))

    quality_filter = max(len(cells) * 2, 30)
    merged = f"{output_prefix}_merged_genotype.tsv"
    with open(merged, "w") as out:
        final_alleles = merge_genotypes(genotype_files, total_qual=quality_filter,
                                        out=out)

    # Reduced reference: any allele whose header matches a winning
    # major-allele name (substring match, as the reference driver does).
    reduced_ref = f"{output_prefix}_reduced_ref.fa"
    wanted = set(final_alleles.keys())
    if not wanted:
        raise RuntimeError("No qualified allele found.")
    with open(reduced_ref, "w") as out:
        for rec in read_seq_file(ref):
            header = rec.id + (" " + rec.comment if rec.comment else "")
            if any(w in header for w in wanted):
                out.write(f">{header}\n{rec.seq}\n")

    jobs = []
    for cell, f2 in zip(cells, files2):
        outdir = f"{output_prefix}_{cell}"
        if f2 is not None:
            c1 = os.path.join(outdir, f"{cell}_candidate_1.fq")
            c2 = os.path.join(outdir, f"{cell}_candidate_2.fq")
        else:
            c1 = os.path.join(outdir, f"{cell}_candidate.fq")
            c2 = None
        jobs.append((t1k_args, reduced_ref, c1, c2, outdir,
                     f"{cell}_reduced", True))
    reduced_files = (_run_cells_cohort(jobs, mesh=mesh) if cohort_em
                     else _run_cells(jobs, workers))
    with open(f"{output_prefix}_reduced_genotype_list.out", "w") as f:
        f.write("".join(p + "\n" for p in reduced_files))

    final = f"{output_prefix}_final_genotype.tsv"
    with open(final, "w") as out:
        merge_genotypes(reduced_files, total_qual=quality_filter, out=out)
    return final


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="T1K SMART-seq pipeline")
    ap.add_argument("-1", dest="list1", required=True)
    ap.add_argument("-2", dest="list2", default=None)
    ap.add_argument("-f", dest="ref", required=True)
    ap.add_argument("-o", dest="prefix", default="T1K")
    ap.add_argument("-t", dest="threads", type=int, default=1,
                    help="threads per cell pipeline")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells processed concurrently (process pool)")
    ap.add_argument("--preset", default=None)
    ap.add_argument("--cohortEm", action="store_true",
                    help="second pass: batch every cell's EM into one "
                         "device program (cells as a batched axis, "
                         "sharded over the local device mesh)")
    args = ap.parse_args(argv)
    extra = {}
    if args.preset:
        extra["--preset"] = args.preset
    if args.threads != 1:
        extra["-t"] = args.threads
    mesh = None
    if args.cohortEm:
        import jax
        if len(jax.devices()) > 1:
            from ..parallel.mesh import data_mesh
            mesh = data_mesh()
    run_smartseq(args.list1, args.list2, args.ref, args.prefix, extra,
                 workers=args.workers, cohort_em=args.cohortEm, mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
