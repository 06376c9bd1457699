"""Post-analysis CLI (reference analyzer, Analyzer.cpp:300-733): re-align
aligned reads against the selected alleles, re-quantify, call novel SNPs,
and emit the single-cell barcode matrix.

  python -m t1k_tpu.cli.analyze -f ref.fa -a prefix_allele.tsv \
      -1 prefix_aligned_1.fa -2 prefix_aligned_2.fa -o prefix
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from . import BACKEND_CHOICES, check_forced_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="t1k-analyze", description="Novel-SNP / barcode post-analysis")
    ap.add_argument("-f", dest="ref", required=True)
    ap.add_argument("-a", dest="allele_tsv", required=True)
    ap.add_argument("-1", dest="first", nargs="+", action="extend",
                    default=[])
    ap.add_argument("-2", dest="second", nargs="+", action="extend", default=[])
    ap.add_argument("-u", dest="single", nargs="+", action="extend", default=[])
    ap.add_argument("-o", dest="prefix", default="t1k")
    ap.add_argument("-t", dest="threads", type=int, default=1)
    ap.add_argument("-s", dest="similarity", type=float, default=0.8)
    ap.add_argument("-n", dest="maxAssign", type=int, default=2000)
    ap.add_argument("--alleleDigitUnits", type=int, default=-1)
    ap.add_argument("--alleleDelimiter", default="")
    ap.add_argument("--barcode", nargs="+", action="extend",
                    default=[])
    ap.add_argument("--relaxIntronAlign", action="store_true")
    ap.add_argument("--varMaxGroup", type=int, default=8)
    ap.add_argument("--backend", default="auto", choices=BACKEND_CHOICES,
                    help="alignment backend; auto = device when a GPU is "
                         "present (byte-identical)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from ..core.analyzer import AnalyzerOptions, run_analyzer

    if argv is None:
        import sys

        argv = sys.argv[1:]
    # "--varMaxGroup -1" (no-limit, accepted by the reference's getopt)
    # would be read by argparse as the -1 option; fold the value in
    argv = list(argv)
    for i, tok in enumerate(argv[:-1]):
        if tok == "--varMaxGroup" and argv[i + 1].lstrip("-").isdigit():
            argv[i] = f"--varMaxGroup={argv[i + 1]}"
            del argv[i + 1]
            break
    from . import fold_negative_values
    args = build_parser().parse_args(
        fold_negative_values(argv) if argv is not None
        else fold_negative_values(__import__('sys').argv[1:]))
    if not check_forced_device(args.backend):
        return 2
    opts = AnalyzerOptions(
        ref_seq_similarity=args.similarity,
        relax_intron_align=args.relaxIntronAlign,
        max_assign_cnt=args.maxAssign,
        digit_units=args.alleleDigitUnits,
        delimiter=args.alleleDelimiter,
        barcode_file=args.barcode or None,
        var_max_group=args.varMaxGroup,
        threads=args.threads,
        backend=args.backend,
    )
    reads1 = args.single or args.first
    reads2 = args.second or None
    run_analyzer(args.ref, args.allele_tsv, reads1, reads2, args.prefix,
                 opts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
