"""CLI entry points (extract / bamextract / genotype / analyze / run)."""

import os
import re
import sys

# "tpu" is the former name of "device", kept as an alias
BACKEND_CHOICES = ["auto", "native", "device", "tpu"]

_NEG_NUM = re.compile(r"^-\d+(\.\d+)?([eE][+-]?\d+)?$")

# single-value flags whose values are legitimately negative (the
# reference getopt consumes them; argparse would read them as the
# -1/-2 options these parsers register)
_NEG_VALUE_FLAGS = {
    "--post-varMaxGroup", "--varMaxGroup", "--squaremMinAlpha",
    "--alleleDigitUnits",
}
# multi-value flags whose trailing values may be -1 sentinels
_RANGE_FLAGS = {"--read1Range": 2, "--read2Range": 2, "--barcodeRange": 3}


def fold_negative_values(argv):
    """Make reference-style negative option values argparse-safe:
    `--squaremMinAlpha -0.5` -> `--squaremMinAlpha=-0.5`, and range
    values like `--read1Range 0 -1` get a leading space (int() accepts
    it; argparse then no longer mistakes -1 for an option).  Only known
    value-taking flags are touched, so `--noExtraction -1 a.fq` keeps
    -1 as the next option."""
    out, i = [], 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if (a in _NEG_VALUE_FLAGS and i + 1 < len(argv)
                and _NEG_NUM.match(argv[i + 1])):
            out.append(a + "=" + argv[i + 1])
            i += 2
        elif a in _RANGE_FLAGS:
            n = _RANGE_FLAGS[a]
            out.append(a)
            for v in argv[i + 1:i + 1 + n]:
                out.append(" " + v if _NEG_NUM.match(v) else v)
            i += 1 + n
        else:
            out.append(a)
            i += 1
    return out


def check_forced_device(backend: str, em_backend: str = "auto") -> bool:
    """False (after printing why) when --backend device, --emBackend jax
    or T1K_BACKEND=device force a device route on a host where JAX finds
    no GPU; an explicit JAX_PLATFORMS=cpu pin is allowed (the same XLA
    programs then run on the CPU)."""
    from ..core.pipeline import (DeviceUnavailableError, canonical_backend,
                                 require_device)

    forced = []
    if canonical_backend(backend) == "device":
        forced.append(f"--backend {backend}")
    if em_backend == "jax":
        forced.append("--emBackend jax")
    if canonical_backend(os.environ.get("T1K_BACKEND", "")) == "device":
        forced.append("T1K_BACKEND=device")
    if not forced:
        return True
    try:
        require_device(" and ".join(forced))
    except DeviceUnavailableError as e:
        print(f"error: {e}", file=sys.stderr)
        return False
    return True

