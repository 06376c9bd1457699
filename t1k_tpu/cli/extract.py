"""Candidate-read extraction CLI (reference fastq-extractor,
FastqExtractor.cpp:220-628).

  python -m t1k_tpu.cli.extract -f ref.fa -1 r1.fq -2 r2.fq -o prefix
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import BACKEND_CHOICES, check_forced_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="t1k-extract",
        description="Screen raw FASTQ for candidate reads")
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
    ap.add_argument("--barcode", nargs="+", action="extend",
                    default=[])
    ap.add_argument("--barcodeRange", nargs=3, default=None,
                    metavar=("START", "END", "STRAND"))
    ap.add_argument("--barcodeWhitelist", default=None)
    ap.add_argument("--read1Range", nargs=2, type=int, default=None)
    ap.add_argument("--read2Range", nargs=2, type=int, default=None)
    # split-flag aliases matching the reference binary's own getopt
    # table (FastqExtractor.cpp:35-47) for drop-in invocations
    ap.add_argument("--barcodeStart", type=int, default=None)
    ap.add_argument("--barcodeEnd", type=int, default=None)
    ap.add_argument("--barcodeRevComp", action="store_true")
    ap.add_argument("--read1Start", type=int, default=None)
    ap.add_argument("--read1End", type=int, default=None)
    ap.add_argument("--read2Start", type=int, default=None)
    ap.add_argument("--read2End", type=int, default=None)
    ap.add_argument("--backend", default="auto", choices=BACKEND_CHOICES,
                    help="screen backend; device = device screen + exact "
                         "native re-screen of undecided reads, auto = "
                         "device past the size gate when a GPU is present "
                         "(byte-identical output either way)")
    return ap


_INT_FLAGS = {"--barcodeStart", "--barcodeEnd", "--read1Start",
              "--read1End", "--read2Start", "--read2End"}


def _merge_negative_ints(argv: List[str]) -> List[str]:
    """`--read2End -1` -> `--read2End=-1`: argparse would otherwise
    read `-1` as the option of that name (the reference's sentinel for
    read length - 1, FastqExtractor.cpp:35-47)."""
    out, i = [], 0
    while i < len(argv):
        a = argv[i]
        if (a in _INT_FLAGS and i + 1 < len(argv)
                and argv[i + 1].lstrip("-").isdigit()):
            out.append(a + "=" + argv[i + 1])
            i += 2
        else:
            out.append(a)
            i += 1
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from ..core.extractor import ExtractorOptions, run_extractor

    if argv is None:
        argv = sys.argv[1:]
    args = build_parser().parse_args(_merge_negative_ints(list(argv)))
    if not check_forced_device(args.backend):
        return 2
    opts = ExtractorOptions(ref_seq_similarity=args.similarity,
                            threads=args.threads, backend=args.backend)
    if args.barcode:
        opts.barcode_file = args.barcode
    if args.barcodeRange:
        opts.barcode_start = int(args.barcodeRange[0])
        opts.barcode_end = int(args.barcodeRange[1])
        opts.barcode_revcomp = args.barcodeRange[2] == "-"
    if args.barcodeWhitelist:
        opts.barcode_whitelist = args.barcodeWhitelist
    if args.read1Range:
        opts.read1_start, opts.read1_end = args.read1Range
    if args.read2Range:
        opts.read2_start, opts.read2_end = args.read2Range
    for attr, val in (("barcode_start", args.barcodeStart),
                      ("barcode_end", args.barcodeEnd),
                      ("read1_start", args.read1Start),
                      ("read1_end", args.read1End),
                      ("read2_start", args.read2Start),
                      ("read2_end", args.read2End)):
        if val is not None:
            setattr(opts, attr, val)
    if args.barcodeRevComp:
        opts.barcode_revcomp = True

    if args.interleaved:
        stats = run_extractor(args.ref, args.interleaved, None, args.prefix,
                              opts, interleaved=True)
    elif args.single:
        stats = run_extractor(args.ref, args.single, None, args.prefix, opts)
    else:
        stats = run_extractor(args.ref, args.first, args.second or None,
                              args.prefix, opts)
    print(f"extracted {stats['candidates']} candidates", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
