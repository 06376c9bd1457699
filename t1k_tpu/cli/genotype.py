"""Genotyping CLI (reference genotyper, Genotyper.cpp:194-738).

  python -m t1k_tpu.cli.genotype -f ref.fa -1 c_1.fq -2 c_2.fq -o prefix
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from . import BACKEND_CHOICES, check_forced_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="t1k-genotype", description="Genotype candidate reads")
    ap.add_argument("-f", dest="ref", required=True)
    # repeated occurrences extend like the reference binaries' getopt
    # loops (each -1/-u/--barcode appends another file)
    ap.add_argument("-1", dest="first", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-2", dest="second", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-u", dest="single", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-i", dest="interleaved", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-o", dest="prefix", default="t1k")
    ap.add_argument("-t", dest="threads", type=int, default=1)
    ap.add_argument("-s", dest="similarity", type=float, default=0.8)
    ap.add_argument("-n", dest="maxAssign", type=int, default=2000)
    ap.add_argument("-a", dest="abundance", default=None)
    ap.add_argument("--frac", type=float, default=0.15)
    ap.add_argument("--cov", type=float, default=1.0)
    ap.add_argument("--crossGeneRate", type=float, default=0.04)
    ap.add_argument("--squaremMinAlpha", type=float, default=0.0)
    ap.add_argument("--alleleDigitUnits", type=int, default=-1)
    ap.add_argument("--alleleDelimiter", default="")
    ap.add_argument("--alleleWhitelist", default=None)
    ap.add_argument("--barcode", nargs="+", action="extend",
                    default=[])
    ap.add_argument("--relaxIntronAlign", action="store_true")
    ap.add_argument("--outputReadAssignment", action="store_true")
    ap.add_argument("--backend", default="auto", choices=BACKEND_CHOICES,
                    help="alignment backend; auto = device when a GPU is "
                         "present, else native (byte-identical either way)")
    ap.add_argument("--deviceCandidates", dest="deviceCandidates",
                    action="store_true",
                    help="phase-A-lite: device-pruned candidate buckets for "
                         "the assignment stage (byte-identical outputs)")
    ap.add_argument("--emBackend", dest="emBackend", default="auto",
                    choices=["auto", "native", "jax"],
                    help="EM implementation: native f64 (byte-exact), "
                         "jitted device EM, or auto = device iff a GPU is "
                         "present and the problem is past the size gate")
    ap.add_argument("--resumeEmState", dest="resumeEmState", default=None,
                    help="resume from a <prefix>_em_state.npz snapshot of "
                         "a preempted run: skip EM quantification and "
                         "restore its sufficient statistics")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from ..core.pipeline import GenotypeOptions, run_genotyper

    from . import fold_negative_values
    args = build_parser().parse_args(
        fold_negative_values(argv) if argv is not None
        else fold_negative_values(__import__('sys').argv[1:]))
    if not check_forced_device(args.backend, args.emBackend):
        return 2
    from ..utils.observability import reset_metrics
    reset_metrics()
    opts = GenotypeOptions(
        ref_seq_similarity=args.similarity,
        relax_intron_align=args.relaxIntronAlign,
        max_assign_cnt=args.maxAssign,
        filter_frac=args.frac, filter_cov=args.cov,
        cross_gene_rate=args.crossGeneRate,
        min_squarem_alpha=args.squaremMinAlpha,
        digit_units=args.alleleDigitUnits,
        delimiter=args.alleleDelimiter,
        allele_whitelist=args.alleleWhitelist,
        abundance_file=args.abundance,
        em_state_file=args.resumeEmState,
        barcode_file=args.barcode or None,
        output_read_assignment=args.outputReadAssignment,
        threads=args.threads, backend=args.backend,
        em_backend=args.emBackend,
        device_candidates=args.deviceCandidates,
    )
    if args.interleaved:
        from ..io.reads import read_seq_files, write_fastq

        # split interleaved input into the pipeline's two-pool form
        import tempfile
        r1 = list(read_seq_files(args.interleaved, interleaved_id=1))
        r2 = list(read_seq_files(args.interleaved, interleaved_id=2))
        f1 = tempfile.NamedTemporaryFile("w", suffix="_1.fq", delete=False)
        f2 = tempfile.NamedTemporaryFile("w", suffix="_2.fq", delete=False)
        f1.close()
        f2.close()
        write_fastq(f1.name, r1)
        write_fastq(f2.name, r2)
        run_genotyper(args.ref, [f1.name], [f2.name], args.prefix, opts)
    elif args.single:
        run_genotyper(args.ref, args.single, None, args.prefix, opts)
    else:
        run_genotyper(args.ref, args.first, args.second or None, args.prefix,
                      opts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
