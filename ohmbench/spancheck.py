"""Checks of the program's worker spans on the card, for one cell.

    python3 ohmbench/spancheck.py --workload occ-box-stream --seed 7 [--out FILE]

It runs on a CUDA device only, and exits 2 where PyTorch sees none.  After the
cell's own set-up and warm-up (``run.py``'s), in one process:

  traced     a traced window (``devicetrace.Profiled``, as ``--trace 1``
             runs it): the device-idle split over every worker span, beside
             ``device_idle_share.stream``'s reading of the same trace, and
             the clock check (``WindowSpans.clock_margins``: each
             host-to-device copy and each batch's first K1 launch against the
             span that issued it, on the trace's own clock and aligned on the
             worker's copies, with the copies the alignment anchors on; a
             negative margin beyond the slack means the two clocks disagree
             there.  Aligned, an anchored copy's margin holds by
             construction: only the K1 margin tests the alignment; on
             the synchronous path, each dispatch's first device operation
             after its waited-for pageable copy, against its span)
  syncs      a window with recording turned on through the recorder's API
             and ``torch.cuda.set_sync_debug_mode("warn")``: the
             synchronizing calls PyTorch reports on the worker's thread,
             where in the program each was made, against the recorder's
             ``host_syncs``; then a few synchronous ``integrate_rays``
             calls, counted the same way
  cost       rays/s over windows with recording off and on (through the API,
             no profiler), in turns off, on, on, off, off, on

The last line of standard output is the result as JSON (also written to
``--out``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time
import traceback
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ohmbench import run, spans  # noqa: E402
from ohmbench.loops import closed  # noqa: E402

#: The sync-debug window (s): ~100 batches or more in either cell.
SYNC_SECONDS = 2.0


def drive(mapper, pool, seconds: float, sync) -> dict:
    """A window of the closed loop, one client: the worker's spans as the
    cells' runs make them."""
    return closed.drive_window(mapper, pool, seconds, sync, {"kind": "closed", "clients": 1})


def prepare(workload: str, seed: int, device, overrides=None):
    """The cell's pool and mapper, warmed up as ``run.run_cell`` warms
    them; returns (mapper, pool, sync)."""
    import torch

    from ohmbench import generator

    _, config, mix, _ = run.load_cell(workload, overrides)
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    pool = run.Pool(generator.make_pool(mix, seed, device), mix["batching"]["cycle"])
    _, mapper = run.build_mapper(config, device)
    if mix["warmup"].get("prime_caps"):
        mapper.prime_caps(pool.batches)
    for _ in range(pool.warm_up_count(mix["warmup"])):
        mapper.integrate_rays_async(pool.batches[pool.take()])
    mapper.flush()
    sync()
    if pool.cycle:
        pool.next = 0
    return mapper, pool, sync


def traced(mapper, pool, seconds: float, sync) -> dict:
    """A traced window: the idle split over every worker span, the idle
    share as ``device_idle_share.stream`` reads it, the clock check."""
    from ohmbench.devicetrace import Profiled

    with Profiled(True) as prof:
        window = drive(mapper, pool, seconds, sync)
    mapper.flush()  # the recorder follows the profiler again: off
    trace = prof.trace
    trace.window_s = window["seconds"]
    ctx = {"window": window, "trace": trace, "probes": {}}
    spans.probe(ctx)
    snap, batches = ctx["probes"]["worker_spans"], len(window["batches"])
    out = {"window_s": window["seconds"], "batches": batches, "device_ops": len(trace.ops)}
    if snap is None:
        return out
    out["spans"] = {name: snap.count(name) for name in
                    ("worker.wait", "worker.group", "worker.prep", "worker.upload",
                     "worker.dispatch", "sync")}
    out["span_ms_per_batch"] = {name: snap.seconds(name) / batches * 1e3 for name in
                                spans.ATTRIBUTED + ("worker.group", "sync")}
    out["dispatch_self_ms_per_batch"] = snap.seconds("worker.dispatch", less="sync") / batches * 1e3
    if trace.ops:
        shares = spans.idle_shares(ctx)
        idle_share = 100.0 * (1.0 - trace.busy_s() / trace.window_s)
        out["idle_split_share"] = shares
        out["device_idle_share"] = idle_share
        # An identity of the partition, up to operations the alignment
        # moves across the window's edges.
        out["split_sum_less_idle_share"] = (None if shares is None else
                                            sum(shares[k] for k in spans.ATTRIBUTED)
                                            + shares["unattributed"] - idle_share)
        out["clock"] = snap.clock_margins(trace.ops)
        out["clock"]["slack_ns"] = spans.CLOCK_SLACK_NS
    return out


class SyncWarnings:
    """Counts PyTorch's synchronizing-call warnings by thread, with the
    program's innermost frame of each."""

    def __init__(self):
        self.by_thread = {}
        self.sites = {}

    def __enter__(self):
        import torch

        self._filters = warnings.filters[:]
        self._show = warnings.showwarning
        warnings.simplefilter("always")
        warnings.showwarning = self._record
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        warnings.filters[:] = self._filters
        warnings.showwarning = self._show
        return False

    def _record(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        name = threading.current_thread().name
        self.by_thread[name] = self.by_thread.get(name, 0) + 1
        frames = [f for f in traceback.extract_stack() if "ohm_tpu_torch" in f.filename]
        site = (f"{os.path.relpath(frames[-1].filename, ROOT)}:{frames[-1].lineno} "
                f"{frames[-1].name}") if frames else f"{filename}:{lineno}"
        self.sites[site] = self.sites.get(site, 0) + 1


def sync_count(mapper, pool, seconds: float, sync) -> dict:
    """Synchronizing calls PyTorch reports against the recorder's
    host_syncs, over a window through the worker and over a few
    synchronous calls."""
    from ohm_tpu_torch.utils.profile import Profile

    rec = Profile.instance()
    rec.record(True)
    try:
        before = rec.counters().get("host_syncs", 0)
        with SyncWarnings() as seen:
            window = drive(mapper, pool, seconds, sync)
        worker = {"batches": len(window["batches"]),
                  "host_syncs": rec.counters().get("host_syncs", 0) - before,
                  "reported_by_thread": seen.by_thread, "reported_sites": seen.sites}
        before = rec.counters().get("host_syncs", 0)
        with SyncWarnings() as seen:
            for _ in range(8):
                mapper.integrate_rays(pool.batches[pool.take()])
            mapper.flush()
        synchronous = {"batches": 8,
                       "host_syncs": rec.counters().get("host_syncs", 0) - before,
                       "reported_by_thread": seen.by_thread, "reported_sites": seen.sites}
    finally:
        rec.record(False)
        sync()
    return {"worker": worker, "synchronous": synchronous}


def cost(mapper, pool, seconds: float, sync) -> dict:
    """rays/s with recording off and on (the API, no profiler), in turns."""
    from ohm_tpu_torch.utils.profile import Profile

    rec = Profile.instance()
    rates = {"off": [], "on": []}
    for state in ("off", "on", "on", "off", "off", "on"):
        rec.record(state == "on")
        gc.collect()
        window = drive(mapper, pool, seconds, sync)
        rates[state].append(window["rays"] / window["seconds"])
        rec.record(False)
        rec.reset()
    rates["on_over_off"] = sum(rates["on"]) / sum(rates["off"])
    return rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Checks of the program's worker spans, one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost-seconds", type=float, default=10.0,
                    help="each of the cost check's six windows; 0 leaves the check out")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.scrub_environment()
    import torch

    if not torch.cuda.is_available():
        print("spancheck measures the card: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    mapper, pool, sync = prepare(args.workload, args.seed, "cuda")
    result = {"workload": args.workload, "seed": args.seed, "setup_s": time.perf_counter() - t0,
              **run.card_state()}
    result["traced"] = traced(mapper, pool, run.TRACE_WINDOW_S, sync)
    result["syncs"] = sync_count(mapper, pool, SYNC_SECONDS, sync)
    if args.cost_seconds > 0:
        result["cost"] = cost(mapper, pool, args.cost_seconds, sync)
    line = json.dumps(result, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
