"""ohmcmp: compare two .ohm maps.

Reference parity: utils/ohmcmp (CompareMaps driven diff).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="ohmcmp", description=__doc__)
    p.add_argument("reference", help="reference .ohm")
    p.add_argument("test", help="test .ohm")
    p.add_argument("--tolerance", type=float, default=0.0,
                   help="epsilon applied to every float member")
    p.add_argument("--member-tolerance", action="append", default=[],
                   metavar="MEMBER=EPS",
                   help="per-member typed epsilon (repeatable; int members take "
                        "integer epsilons — reference configureTolerance); "
                        "overrides --tolerance entirely when given")
    p.add_argument("--layout-only", action="store_true")
    args = p.parse_args(argv)

    from ohm_tpu_torch.io import load
    from ohm_tpu_torch.core.compare import compare_maps, compare_layout, configure_tolerance

    tolerance = args.tolerance
    if args.member_tolerance:
        tolerance = {}
        for spec in args.member_tolerance:
            name, _, eps = spec.partition("=")
            if not _:
                p.error(f"--member-tolerance needs MEMBER=EPS, got {spec!r}")
            configure_tolerance(tolerance, name, int(eps) if eps.lstrip("+-").isdigit()
                                else float(eps))

    ref, _ = load(args.reference)
    test, _ = load(args.test)
    if args.layout_only:
        result = compare_layout(ref, test)
    else:
        result = compare_maps(ref, test, tolerance=tolerance)
    for severity, msg in result.messages:
        print(f"  [{severity.name.lower()}] {msg}")
    print(f"layout: {'match' if result.layout_match else 'MISMATCH'}")
    print(f"regions compared: {result.regions_compared} (missing: {result.missing_regions})")
    print(f"voxels compared: {result.voxels_compared} failed: {result.voxels_failed}")
    print("maps match" if result.ok else "MAPS DIFFER")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
