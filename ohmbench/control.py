"""The control of ``correct``: the reference put in the program's place, a
precision lower than the configuration states, must come out not correct.

    python3 ohmbench/control.py --workload occ-box-stream --seeds 11 12 13 --window-batches 3000

For each seed this makes the cell's pool, takes the sequence of batches a
run integrates (the warm-up, then ``--window-batches`` batches of the
window), and compares with the reference, by the cell's own comparison,
the map that each control gives (the mode's ``compare``):

``geometry_f32``
    keys, the line walk and the NDT math in float32, where the
    configuration states float64 (the step a port that quantised on the
    device would take);
``values_bf16``
    the voxel values (and an NDT map's means and covariances) in bfloat16,
    where the configuration states float32.

It prints one JSON line a seed and control with each number the cell
compares beside its limit.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

CONTROLS = {"geometry_f32": ("float32", "float32"), "values_bf16": ("float64", "bfloat16")}


def control_readings(workload: str, seed: int, window_batches: int, device="cuda",
                     overrides: dict | None = None) -> list:
    """[{control, <number>: share, limits, ...}] of each control on one seed."""
    import torch

    from ohmbench import find, generator, run
    from ohmbench.reference import compare

    _, config, mix, limits = run.load_cell(workload, overrides)
    mode = find("modes", config["mode"])
    device = torch.device(device)
    pool = run.Pool(generator.make_pool(mix, seed, device), mix["batching"]["cycle"])
    seq = pool.plan(mix["warmup"], window_batches)
    batch = lambda i: torch.from_numpy(pool.batches[i]).to(device)  # noqa: E731
    ref = mode.make_reference(config)
    ref.walk_batches(batch, seq)
    ref_map = ref.replay(seq)
    rows = []
    for name, (geometry, values) in CONTROLS.items():
        ctl = mode.make_reference(config, getattr(torch, geometry), getattr(torch, values))
        ctl.walk_batches(batch, seq)
        result = mode.compare(ctl.replay(seq), ref_map, config["resolution"])
        rows.append({"workload": workload, "seed": seed, "control": name, "batches": len(seq),
                     **{k: compare.share(v) for k, v in result.items()},
                     "limits": {k: limits[k] for k in result}, "compared": result})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--window-batches", type=int, required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        for row in control_readings(args.workload, seed, args.window_batches):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
