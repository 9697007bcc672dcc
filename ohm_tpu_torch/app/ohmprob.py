"""ohmprob: convert between occupancy probability and log-odds value.

Reference parity: utils/ohmprob (docs/docutils.md:114-117).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="ohmprob", description=__doc__)
    p.add_argument("value", type=float, help="probability in (0,1) or log-odds value")
    p.add_argument("--to-value", action="store_true", help="force probability -> value")
    p.add_argument("--to-prob", action="store_true", help="force value -> probability")
    args = p.parse_args(argv)

    from ohm_tpu_torch.core.probability import probability_to_value, value_to_probability

    v = args.value
    as_prob = args.to_value or (0.0 < v < 1.0 and not args.to_prob)
    if as_prob:
        print(f"probability {v} -> value {float(probability_to_value(v)):.6f}")
    else:
        print(f"value {v} -> probability {float(value_to_probability(v)):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
