"""Reference-bias calculation from count_supporting_reads output (copy of
``panvc3_tpu.postprocess.reference_bias``).

Own implementation of the behaviour of the reference's
``calculate_reference_bias.py`` (count-supporting-reads/
calculate_reference_bias.py:24-89): per variant, balance =
#REF / (#REF + #ALT) subject to a minimum coverage, with REF/ALT swapped
when the variant is flagged reversed (CO/USRA); prints an overall
ref-to-alt ratio at the end.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass


@dataclass
class BiasResult:
    variants_counted: int = 0
    variants_skipped: int = 0
    overall_ref: int = 0
    overall_alt: int = 0


def calculate_reference_bias(in_fp, out=sys.stdout, err=sys.stderr, *, min_coverage: int = 1) -> BiasResult:
    res = BiasResult()
    out.write("BALANCE\tREF_LENGTH\tALT_LENGTH\n")

    ref = alt = ""
    ref_count = alt_count = 0
    have_variant = False

    def flush():
        nonlocal ref_count, alt_count
        if not have_variant:
            return
        if ref_count + alt_count >= min_coverage:
            res.variants_counted += 1
            balance = float(ref_count) / float(ref_count + alt_count)
            out.write(f"{balance}\t{len(ref)}\t{len(alt)}\n")
        else:
            res.variants_skipped += 1

    for lineno, raw in enumerate(in_fp, 1):
        line = raw.rstrip("\n")
        fields = line.split("\t")
        kind = fields[0]
        if kind == "V":
            flush()
            have_variant = True
            alts = fields[5].split(",")
            if len(alts) != 1:
                err.write(
                    f"WARNING: ALT count is not equal to one on input line "
                    f"{lineno}. Considering only the first ALT.\n"
                )
            alt = "" if alts[0] == "<DEL>" else alts[0]
            ref = fields[4]
            if int(fields[7]):
                ref, alt = alt, ref
            ref_count = alt_count = 0
        elif kind == "R":
            count = int(fields[1])
            text = fields[2]
            if text == ref:
                ref_count += count
                res.overall_ref += count
            elif text == alt:
                alt_count += count
                res.overall_alt += count
        else:
            err.write(raw)

    flush()
    err.write(f"Variants counted: {res.variants_counted}\n")
    err.write(f"Variants skipped: {res.variants_skipped}\n")
    if res.overall_alt > 0:
        out.write(f"# Overall ref-to-alt ratio: {res.overall_ref / res.overall_alt}\n")
    else:
        err.write("Found zero ALT alleles.\n")
    return res


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Calculate reference bias per site from "
        "count_supporting_reads output."
    )
    p.add_argument("--min-coverage", metavar="N", type=int, default=1)
    args = p.parse_args(argv)
    calculate_reference_bias(sys.stdin, min_coverage=args.min_coverage)
    return 0


if __name__ == "__main__":
    sys.exit(main())
