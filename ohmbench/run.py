"""ohmbench: one run of one cell of the benchmark of ohm_tpu_torch.

    python3 ohmbench/run.py --workload occ-box-stream --seed 7 --seconds 20 --trace 0

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``ohmbench/configs/<config>.json``: the mapper, the map and ohmpop's
settings) and a traffic mix (``ohmbench/traffic/<traffic>.json``, read by
``ohmbench/generator.py``).  A run makes the mix's pool of ray batches from
``--seed`` on the card, builds the mapper, warms it up, then drives it for
``--seconds`` with the mix's client loop (``ohmbench/loops/<kind>.py``).
After the window it reads the map back (``sync_voxels``), frees the
program's state and works the map out again with the plain reference of
the configuration's mode (``ohmbench/modes/<mode>.py`` over
``ohmbench/reference``) from the same rays; ``correct`` holds the numbers
of the mode's own ``compare``, the rays lost and the mode's counts of the
program's stats against the limits in ``ohmbench/limits/<cell>.json``.
Every such file is found by the name a cell, a configuration or a mix
gives, so a new cell, mode, traffic part or loop is a new file.  A mode
also names the arena layers its comparison reads (``VALUE_LAYERS``),
which the tests' planted fault alters, and a cell brings the size at
which ``ohmbench/tests`` run it on the CPU, with the controls that must
fail there (``ohmbench/small/<cell>.json``).

With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, each read by
``ohmbench/metrics/<metric>.py`` from the device trace of the window, the
program's counters and the reference's work counts.  Earlier lines
(``# info``) record the card, its power limit and clocks, the memory and
what the run did.  Every ``OHM_*`` variable is removed before the program
is imported, so each run takes the library's defaults.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "ohm_tpu")
#: A traced window lasts at most this long (s): the trace of a longer one
#: holds too many operations to read back within a run's time.
TRACE_WINDOW_S = 4.0


def info(**kw) -> None:
    print("# info " + json.dumps(kw, default=str), flush=True)


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader module of metric ``name`` (``ohmbench/metrics/<name>.py``)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("ohmbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def scrub_environment() -> list:
    """Remove every OHM_* variable; return their names."""
    names = sorted(k for k in os.environ if k.startswith("OHM_"))
    for k in names:
        del os.environ[k]
    return names


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_state() -> dict:
    """nvidia-smi's reading of the card, or what stopped it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return {"nvidia_smi": out.stdout.strip() or out.stderr.strip()}
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}


def load_cell(workload: str, overrides: dict | None = None) -> tuple:
    """(cell, config, traffic mix, limits) of cell ``workload``, each file
    found by name; ``overrides`` replaces keys of the configuration
    (``config``), traffic (``traffic``) and limits (``limits``), and may give
    the cell itself (``cell``: one not in BENCHMARK.json): tests run cells
    at a size the CPU holds."""
    overrides = overrides or {}
    cell = overrides.get("cell") or next(w for w in load_bench()["workloads"]
                                         if w["name"] == workload)
    config = merged(load_json("configs", cell["config"] + ".json"), overrides.get("config"))
    mix = merged(load_json("traffic", cell["traffic"] + ".json"), overrides.get("traffic"))
    limits = merged(load_json("limits", workload + ".json"), overrides.get("limits"))
    mix["batching"].setdefault("batch_rays", config["batch_size"])
    return cell, config, mix, limits


def build_mapper(config: dict, device):
    """The configuration's map and mapper, through the package's public
    names: ``mapper`` is the class, built on the map with the arena's
    ``capacity``, ``device`` and the configuration's ``mapper_args``; every
    other parameter takes the library's default (ohmpop's)."""
    import ohm_tpu_torch as port

    flags = port.MapFlag.NONE
    for layer in config.get("layers", []):
        flags |= getattr(port.MapFlag, layer)
    m = port.OccupancyMap(resolution=config["resolution"], region_voxel_dims=config["region_dim"],
                          flags=flags)
    m.set_hit_probability(config["hit_probability"])
    m.set_miss_probability(config["miss_probability"])
    m.set_occupancy_threshold_probability(config["threshold_probability"])
    cls = getattr(port, config["mapper"])
    mapper = cls(m, capacity=config["arena_capacity"], device=device,
                 **config.get("mapper_args", {}))
    return m, mapper


class Pool:
    """The traffic's batches and the order the run takes them in."""

    def __init__(self, batches, cycle: bool):
        self.batches = batches
        self.cycle = cycle
        self.next = 0
        self.sequence = []  # pool index of every batch integrated, in order

    def take(self):
        """The next batch's index, or None when a pool that does not cycle
        is spent."""
        i = self.next
        if i >= len(self.batches):
            if not self.cycle:
                return None
            i = 0
        self.next = i + 1
        self.sequence.append(i)
        return i

    def warm_up_count(self, warmup: dict) -> int:
        """Batches the warm-up integrates: the pool once, or a number."""
        return len(self.batches) if warmup["batches"] == "pool" else int(warmup["batches"])

    def plan(self, warmup: dict, window_batches: int) -> list:
        """The pool indices a run takes, without integrating them: the
        warm-up, then ``window_batches`` of the window."""
        for _ in range(self.warm_up_count(warmup)):
            self.take()
        if self.cycle:
            self.next = 0
        for _ in range(window_batches):
            if self.take() is None:
                break
        return self.sequence


def rays_of(batch) -> int:
    return batch.shape[0] // 2


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None) -> dict:
    """One run of cell ``workload``; returns the result line's object with
    ``checks`` last.  ``overrides`` as ``load_cell`` takes them."""
    import torch

    from ohmbench import find, generator
    from ohmbench.hostmeter import speed_probe
    from ohmbench.reference import compare

    _, config, mix, limits = load_cell(workload, overrides)
    mode = find("modes", config["mode"])
    loop = find("loops", mix["loop"]["kind"])
    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    phases = {"imports": time.perf_counter() - _T0}
    pool = Pool(generator.make_pool(mix, seed, device), mix["batching"]["cycle"])
    sync()
    phases["traffic"] = time.perf_counter() - _T0
    m, mapper = build_mapper(config, device)

    # Warm-up: every shape the window will use, the map made resident.
    warm = mix["warmup"]
    n_warm = pool.warm_up_count(warm)
    if warm.get("prime_caps"):
        mapper.prime_caps(pool.batches)
    phases["prime_caps"] = time.perf_counter() - _T0
    for _ in range(n_warm):
        mapper.integrate_rays_async(pool.batches[pool.take()])
    mapper.flush()
    sync()
    if pool.cycle:
        pool.next = 0
    phases["warm_up"] = time.perf_counter() - _T0
    stats_before = mapper.stats
    arena_before = dict(mapper.arena.stats)
    gc.collect()
    gc.freeze()

    length = min(seconds, TRACE_WINDOW_S) if trace else seconds
    if trace:
        from ohmbench.devicetrace import Profiled

        with Profiled(on_card) as prof:
            window = loop.drive_window(mapper, pool, length, sync, mix["loop"])
        prof.trace.window_s = window["seconds"]
        window_trace = prof.trace
    else:
        window = loop.drive_window(mapper, pool, length, sync, mix["loop"])
        window_trace = None
    setup_s = window["start"] - _T0
    gc.unfreeze()
    host_ms = speed_probe()

    stats_after = mapper.stats
    arena_after = dict(mapper.arena.stats)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    arena_bytes = sum(t.numel() * t.element_size() for t in mapper.arena.layers.values())
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"

    # What the metric readers read: the window, its trace, the arena's
    # counters, the pool, the card; the probes' and the reference's
    # results join it below.
    ctx = {"window": window, "trace": window_trace,
           "arena": {"before": arena_before, "after": arena_after}, "probes": {},
           "pool": pool.batches, "device_kind": kind}
    metrics_of_cell = ([mt for mt in load_bench()["per_layer"]
                        if workload in mt.get("workloads", [workload])] if trace else [])
    readers = {mt["name"]: load_metric(mt["name"]) for mt in metrics_of_cell}
    for reader in readers.values():
        if hasattr(reader, "probe"):
            reader.probe(ctx, mapper)

    # The program's map, read back; then its state is freed.
    mapper.sync_voxels()
    stats_final = mapper.stats
    del mapper
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    prog = mode.program_map(m, config, device)
    del m

    # The reference, from the same rays.
    t_ref = time.perf_counter()
    ref = mode.make_reference(config)
    ref.walk_batches(lambda i: torch.from_numpy(pool.batches[i]).to(device), pool.sequence)
    ref_map = ref.replay(pool.sequence)
    result = mode.compare(prog, ref_map, config["resolution"])
    ref_s = time.perf_counter() - t_ref
    ctx["counts"] = ref.counts
    ctx["gauss_voxels"] = getattr(ref, "gauss_voxels", None)

    submitted = sum(rays_of(pool.batches[i]) for i in pool.sequence)
    numbers = {name: compare.share(part) for name, part in result.items()}
    numbers["rays_lost"] = max(0, submitted - stats_final["rays"])
    numbers.update(mode.counted(stats_final))
    if set(numbers) != set(mode.NUMBERS):
        raise ValueError(f"mode {config['mode']!r} compares {sorted(mode.NUMBERS)}, "
                         f"the run gave {sorted(numbers)}")
    checks = {name: {"value": value, "limit": limits[name]} for name, value in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    info(device=kind, device_count=torch.cuda.device_count() if on_card else 0,
         **(card_state() if on_card else {}))
    info(memory_peak_bytes=memory_peak, arena_bytes=arena_bytes, setup_s=setup_s,
         window_s=window["seconds"], window_batches=len(window["batches"]),
         window_rays=window["rays"], pool_batches=len(pool.batches),
         pool_spent=window["pool_spent"], warm_batches=n_warm,
         host_by_second=window["host_by_second"], host_speed_probe_ms=host_ms,
         setup_phases_s=phases, reference_s=ref_s, compared=result,
         mapper_stats={k: stats_final[k] - stats_before.get(k, 0) for k in stats_final},
         arena_stats={k: arena_after[k] - arena_before.get(k, 0) for k in arena_after})

    if trace:
        metrics = {}
        for mt in metrics_of_cell:
            value = readers[mt["name"]].read(ctx)
            if value is not None:
                metrics[mt["name"]] = {"value": value, "unit": mt["unit"]}
    else:
        metrics = {"rays_per_s": {"value": window["rays"] / window["seconds"], "unit": "rays/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    device_obj = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": memory_peak}
    out = {"correct": bool(correct), "attempted": window["rays"],
           "failed": max(0, window["rays"] - (stats_after["rays"] - stats_before["rays"])),
           "metrics": metrics, "device": device_obj}
    if trace:
        device_obj["busy_s"] = window_trace.busy_s()
        device_obj["window_s"] = window_trace.window_s
        out["breakdown"] = {"device_ops": window_trace.top_ops(), "idle_gaps": window_trace.idle_gaps()}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of ohmbench.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    removed = scrub_environment()
    info(removed_environment=removed, note="every OHM_* knob unset: the library's defaults")

    bench = load_bench()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print("modules that no run may load were loaded: " + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
