"""Inputs that reach the kernels' edge cases, and a log of the PyTorch
operations a call issues: one copy, used by ``tests/test_torch_*.py`` and
``chip_smoke.py`` alike, so that both hold the kernels to the same cases."""

from __future__ import annotations

import numpy as np
import torch


def fused_traversal_atol(resolution: float) -> float:
    """The largest difference the fused and the split apply may give one
    voxel's traversal: both sum the same records by ops.segments'
    blocked sums, in other groupings.  Each of a sum's 11 rounding steps
    (10 in-row log-shift levels, the row carry) rounds an in-row prefix of
    at most 1024 records, each at most a voxel diagonal (sqrt(3) x
    ``resolution``) long, to f32 (2^-23 relative): 11 x 1024 x sqrt(3) x
    resolution x 2^-23 each, twice for the two groupings (4.6e-4 at 0.1 m)."""
    return 2 * 11 * 1024 * 3 ** 0.5 * resolution * 2.0 ** -23


def ndt_flag_arena(n_arena: int, n_voxels: int, rng, n_nan: int, n_big: int,
                   seen: float = 0.6):
    """An NDT arena's occupancy and u32 mean counts for the flag gather, as
    numpy arrays of ``n_arena`` voxels: occupancy +inf (unobserved) but on a
    ``seen`` share of the first ``n_voxels``, which are finite, and NaN on
    ``n_nan`` of those voxels; counts 0-5 (both sides of every threshold
    from 0 to 5), and at or above 2^31 on ``n_big`` of them."""
    occ = np.full(n_arena, np.inf, np.float32)
    observed = rng.random(n_voxels) < seen
    occ[:n_voxels][observed] = rng.normal(0.0, 3.0, int(observed.sum())).astype(np.float32)
    occ[rng.choice(n_voxels, n_nan, replace=False)] = np.nan
    count = rng.integers(0, 6, n_arena).astype(np.uint32)
    big = rng.choice(n_voxels, n_big, replace=False)
    count[big] = rng.integers(2**31, 2**32, big.size, dtype=np.uint64).astype(np.uint32)
    return occ, count


def edge_rays(b: dict, cfg) -> None:
    """Make the first 48 rays of a decoded wire (ops.wire.unpack_batch; in
    place, in the wire's own strided views) reach the expand kernel's edge
    cases: rays 0-15 start on the voxel wall they leave (e0 = +-0), 16-23
    have zero length, 24-31 carry a denormal direction component on an axis
    they cross once (read as zero, as XLA reads it: inv = 3e38; 24-27 start
    on the wall, e0 = 0), 32-39 are invalid, and
    40-47 cross more than S walls on an axis."""
    half = float(np.float32(0.5) * np.float32(cfg.resolution))
    b["start_frac"][:16] = torch.where(b["direction"][:16] < 0, -half, half)
    b["length"][16:24] = 0.0
    b["direction"][24:32, 1] = 1e-39
    b["end_abs"][24:32, 1] = b["start_abs"][24:32, 1] + 1
    b["start_frac"][24:28, 1] = half
    b["valid"][32:40] = False
    b["end_abs"][40:48, 2] = b["start_abs"][40:48, 2] + cfg.max_steps + 5


def dispatched_ops(fn) -> list:
    """The names of the ATen ops ``fn`` issues, in order (python dispatch
    mode): a kernel wrapper should issue its outputs' allocations only."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Log():
        fn()
    return ops


#: Streams at the edges of the run-length deposits (K2, K3).
DEPOSIT_EDGE_STREAMS = ("long_run", "block_edges", "empty", "all_sentinel", "negative")
#: K3's streams: K2's, and the cases of its second stream and its delta.
NDT_EDGE_STREAMS = DEPOSIT_EDGE_STREAMS + ("end_only", "delta_only", "neg_zero_delta",
                                           "delta_last")


def _runs(name: str, sentinel: int, rng) -> list:
    """(flat, misses, hits) runs, ascending by flat, of a stream of
    DEPOSIT_EDGE_STREAMS (empty for "empty" and "all_sentinel"):

      long_run      70,000 misses on one voxel, 65,600 hits on the next,
                    65,536 misses and 3 hits on a third (counts cap at 65535)
      block_edges   ~60 runs of 1 to 1,030 records, misses then hits, whose
                    run and hit/miss boundaries cross multiples of 256 and 1024
      negative      voxels with flat -2^29, -77 and -1 (skipped), then
                    block_edges' runs
    with 40 short runs of up to 5 records beside them (and alone for K3's
    own cases)."""
    if name in ("empty", "all_sentinel"):
        return []
    runs = []
    if name == "long_run":
        runs += [(10, 70_000, 0), (11, 0, 65_600), (12, 65_536, 3)]
    if name in ("block_edges", "negative"):
        if name == "negative":
            runs += [(-(1 << 29), 5, 2), (-77, 300, 0), (-1, 0, 1)]
        lengths = [1, 2, 3, 127, 254, 255, 256, 257, 511, 769, 1023, 1024, 1025, 1030]
        flat = 40
        for _ in range(60):
            n = int(rng.choice(lengths))
            hits = int(rng.integers(0, n + 1)) if rng.random() < 0.6 else 0
            runs.append((flat, n - hits, hits))
            flat += int(rng.integers(1, 4))
    start = max((r[0] for r in runs), default=0) + 1
    spread = rng.choice(np.arange(start, sentinel), 40, replace=False)
    runs += [(int(f), int(rng.integers(0, 4)), int(rng.integers(1, 3))) for f in np.sort(spread)]
    return runs


def _keys(runs) -> np.ndarray:
    """The sorted (flat << 1 | hit) keys of (flat, misses, hits) runs."""
    parts = [np.zeros(0, np.int64)]
    for flat, misses, hits in runs:
        parts += [np.full(misses, flat << 1), np.full(hits, (flat << 1) | 1)]
    return np.sort(np.concatenate(parts)).astype(np.int32)


def deposit_edge_stream(name: str, sentinel: int, seed: int = 0) -> np.ndarray:
    """K2's key stream for ``name`` (DEPOSIT_EDGE_STREAMS), sorted i32: the
    runs of ``_runs``, then 100 sentinel records (both key parities; 3,000
    and nothing else for "all_sentinel"; none for "empty")."""
    rng = np.random.default_rng(seed)
    keys = _keys(_runs(name, sentinel, rng))
    if name != "empty":
        n = 3000 if name == "all_sentinel" else 100
        tail = (np.int64(sentinel) << 1) | (np.arange(n) & 1)
        keys = np.sort(np.concatenate([keys, tail])).astype(np.int32)
    return keys


def ndt_edge_streams(name: str, sentinel: int, seed: int = 0) -> dict:
    """K3's streams for ``name`` (NDT_EDGE_STREAMS), as numpy arrays:

      walk    ascending (flat << 1) miss ids where each voxel's first records
              (a random prefix, as the NDT miss phase's Gaussian-applied
              ones) are masked to the sentinel, then sentinel ids
      bounds  the same ids unmasked (the reference kernel's bounds stream)
      end     the end/sample keys (hits and misses), sorted
      dkeys, dvals
              the sparse miss delta: (flat << 1, value) records sorted by
              id, one value per voxel at its last record, zero-valued
              records before it, some values zero, a sentinel tail
      plane   the same delta as a dense f32 plane [sentinel + 1]

    The cases beyond K2's: "end_only" voxels whose only records are end
    keys (hits only, misses only, both); "delta_only" voxels with a delta
    and every walk record masked, or no record at all; "neg_zero_delta"
    -0.0 and +0.0 deltas on voxels with and without records; "delta_last"
    a voxel's value at its last delta record behind 5 zero-valued ones."""
    rng = np.random.default_rng(seed)
    runs = _runs(name, sentinel, rng)
    sent = np.int64(sentinel)
    walk_runs = [(f, m + h) for f, m, h in runs if m + h > 0]
    end_runs = []
    if name in ("long_run", "block_edges", "negative"):
        # A third of the voxels' records come as end keys, the hits among them.
        walk_runs = [(f, m) for f, m, h in runs if m > 0]
        end_runs = [(f, 0, h) for f, m, h in runs if h > 0]
    lo = max([f for f, _ in walk_runs] + [0]) + 10
    extra = {}  # voxel -> delta value (f32) for the delta cases
    if name == "end_only":
        end_runs += [(lo, 0, 4), (lo + 1, 3, 0), (lo + 2, 2, 5)]
    elif name == "delta_only":
        walk_runs.append((lo, 7))  # every record masked below
        extra = {lo: -0.5, lo + 1: 0.25}
    elif name == "neg_zero_delta":
        walk_runs += [(lo, 2), (lo + 1, 3)]
        extra = {lo: -0.0, lo + 1: 0.0, lo + 2: -0.0, lo + 3: 0.0}
    elif name == "delta_last":
        walk_runs.append((lo, 4))
        extra = {lo: -0.375}
    ids = np.sort(np.concatenate([np.zeros(0, np.int64)]
                                 + [np.full(n, f, np.int64) for f, n in walk_runs]))
    masked = np.zeros(ids.size, bool)
    for f, n in walk_runs:
        at = np.searchsorted(ids, f)
        k = n if (name == "delta_only" and f == lo) else int(rng.integers(0, n + 1) // 2)
        if n > 65_535:  # the long runs keep a count above the cap
            k = min(k, n - 65_536)
        masked[at:at + k] = True
    if name != "empty":
        ids = np.concatenate([ids, np.full(64, sent)])
        masked = np.concatenate([masked, np.zeros(64, bool)])
    if name == "all_sentinel":
        ids, masked = np.full(3000, sent), np.zeros(3000, bool)
    bounds = ids << 1
    walk = np.where(masked, sent << 1, bounds)
    end = _keys(end_runs).astype(np.int64)
    if name == "all_sentinel":
        end = (sent << 1) | (np.arange(500) & 1)
    elif name != "empty":
        end = np.concatenate([end, (sent << 1) | (np.arange(20) & 1)])

    # The delta: a value on a fifth of the walk's voxels (some 0), and the
    # cases' own voxels, each at its last record behind zero-valued ones.
    real = np.unique(ids[(ids >= 0) & (ids < sentinel)])
    chosen = real[rng.random(real.size) < 0.2] if real.size else real
    values = dict(zip(chosen.tolist(), rng.normal(0.0, 0.5, chosen.size).astype(np.float32)))
    for f in chosen[: max(1, chosen.size // 8)].tolist():
        values[f] = np.float32(0.0)
    values.update({f: np.float32(v) for f, v in extra.items()})
    dkeys, dvals = [], []
    for f in sorted(values):
        zeros = 5 if name == "delta_last" and f == lo else int(rng.integers(0, 3))
        dkeys += [f] * (zeros + 1)
        dvals += [np.float32(0.0)] * zeros + [values[f]]
    if name == "negative":
        dkeys, dvals = [-77, -1] + dkeys, [np.float32(0.5), np.float32(-0.5)] + dvals
    if name == "all_sentinel":
        dkeys, dvals = [], []
    if name != "empty":
        dkeys, dvals = dkeys + [sentinel] * 17, dvals + [np.float32(0.0)] * 17
    dkeys = np.asarray(dkeys, np.int64)
    dvals = np.asarray(dvals, np.float32).reshape(-1)
    plane = np.zeros(sentinel + 1, np.float32)
    live = (dkeys >= 0) & (dkeys < sentinel) & (dvals.view(np.uint32) != 0)
    plane[dkeys[live]] = dvals[live]
    return {"walk": walk.astype(np.int32), "bounds": bounds.astype(np.int32),
            "end": np.sort(end).astype(np.int32), "dkeys": (dkeys << 1).astype(np.int32),
            "dvals": dvals, "plane": plane}


#: Streams at the edges of the fused TSDF per-visit update (tsdf_visits).
TSDF_VISIT_STREAMS = ("specials", "long_runs", "saturation", "near_zero", "weighted", "short",
                      "all_sentinel")
#: f32 patterns a stored TSDF pair may hold: -0.0, +-inf, denormals, and NaN
#: payloads (quiet, signalling, negative).
TSDF_SPECIALS = np.array([0x80000000, 0x7F800000, 0xFF800000, 0x000116C2, 0x80000001,
                          0x7FC00000, 0x7FA00001, 0xFFC12345], np.uint32).view(np.float32)


def tsdf_visit_stream(name: str, sentinel: int, n_arena: int | None = None,
                      seed: int = 0) -> dict:
    """The per-visit update's inputs for ``name`` (TSDF_VISIT_STREAMS), as
    numpy arrays and f32 values: ``ids`` ascending (i32, voxel runs, then a
    sentinel tail, so no length is a multiple of 1024), ``w`` (f32, or None
    for the uniform weighting), ``wsdf`` (f32, w * sdf with sdf beyond the
    truncation band both ways), the stored planes ``weight`` and
    ``distance`` (f32[n_arena], default sentinel + 1), ``trunc`` and
    ``max_weight``:

      specials      uniform weights, runs of 1-8 visits; the visited voxels'
                    stored pairs hold TSDF_SPECIALS (each plane on its own)
      long_runs     uniform, runs of 1023 to 3,500 visits crossing one or
                    several 1024-record rows, among short ones
      saturation    max_weight 3: stored weights at and below it, runs of
                    1-12 visits and one of 1,500, so the weight saturates
                    in the middle of a run
      near_zero     weights 0, -0.0 and below, at and above 1e-5: skipped
                    visits and voxels whose weight stays below 1e-5
      weighted      weights in [0, 2] (a tenth exactly 0), a run of 2,500
      short         uniform, 700 records in all
      all_sentinel  900 sentinel records"""
    rng = np.random.default_rng(seed)
    n_arena = sentinel + 1 if n_arena is None else n_arena
    trunc, max_weight = 0.1, 1e4
    if name == "all_sentinel":
        lengths = np.zeros(0, np.int64)
    elif name == "long_runs":
        lengths = np.concatenate([rng.integers(1, 6, 200), [1023, 1024, 1025], rng.integers(1, 6, 50),
                                  [2100, 3500], rng.integers(1, 6, 100)])
    elif name == "saturation":
        lengths = np.concatenate([rng.integers(1, 13, 300), [1500], rng.integers(1, 13, 100)])
    elif name == "weighted":
        lengths = np.concatenate([rng.integers(1, 9, 400), [2500], rng.integers(1, 9, 200)])
    elif name == "short":
        lengths = rng.integers(1, 6, 400)
    else:  # specials, near_zero
        lengths = rng.integers(1, 9, 600)
    if name == "short":
        lengths = lengths[np.cumsum(lengths) <= 680]
    voxels = np.sort(rng.choice(sentinel, lengths.size, replace=False))
    n_tail = 900 if name == "all_sentinel" else 20 if name == "short" else 37
    ids = np.concatenate([np.repeat(voxels, lengths), np.full(n_tail, sentinel)]).astype(np.int32)
    n = ids.size
    live = ids != sentinel

    weight = np.zeros(n_arena, np.float32)
    distance = np.zeros(n_arena, np.float32)
    seen = rng.random(voxels.size) < 0.7
    weight[voxels[seen]] = rng.uniform(0.5, 50.0, int(seen.sum()))
    distance[voxels[seen]] = rng.uniform(-trunc, trunc, int(seen.sum()))
    if name == "specials":
        k = voxels[rng.permutation(voxels.size)]
        weight[k[:200]] = TSDF_SPECIALS[np.arange(200) % TSDF_SPECIALS.size]
        distance[k[100:300]] = TSDF_SPECIALS[np.arange(200) % TSDF_SPECIALS.size]
    if name == "saturation":
        max_weight = 3.0
        weight[voxels] = np.array([0.0, 1.0, 2.0, 2.5, 2.9, 3.0],
                                  np.float32)[rng.integers(0, 6, voxels.size)]

    w = None
    if name == "near_zero":
        choices = np.array([0.0, -0.0, 1e-7, 3e-6, 9.99e-6, 1e-5, 1.2e-5, 0.5], np.float32)
        w = choices[rng.integers(0, choices.size, n)]
        weight[voxels] = np.where(rng.random(voxels.size) < 0.5, 0.0, weight[voxels])
    elif name == "weighted":
        w = rng.uniform(0.0, 2.0, n).astype(np.float32)
        w[rng.random(n) < 0.1] = 0.0
    if w is not None:
        w[~live] = 0.0
    sdf = rng.uniform(-2.5 * trunc, 2.5 * trunc, n).astype(np.float32)
    wsdf = sdf if w is None else w * sdf
    return {"ids": ids, "w": w, "wsdf": wsdf.astype(np.float32), "weight": weight,
            "distance": distance, "trunc": float(np.float32(trunc)),
            "max_weight": float(np.float32(max_weight))}


#: One PyTorch call computing each deposit probe's function, its library
#: yardstick (chip_smoke.py times it beside the kernel; no path of the port
#: calls it), or the reason there is none.
PROBE_LIBRARY_CALLS = {
    "vmem_scatter_add": lambda idx: torch.bincount(idx.reshape(-1) & 127, minlength=128)
    .view(1, 128).float(),
    "take_along_axis": lambda x, idx: torch.gather(x, 1, (idx & 127).long()),
    "dynamic_fori": "none: every PyTorch call takes its trip count from the host",
    "dyn_offset_dma": "none: narrow takes its offset from the host; index_select needs "
                      "the row indices built by another call",
    # Voxel indices in [0, 32768), as the probe's.
    "onehot_mxu_dot": lambda v: torch.bincount(v.reshape(-1), minlength=32768)
    .view(64, 512).float(),
}


#: The mappers whose timed loops in the port's benches go through the
#: worker: occupancy and TSDF (timed_integration), NDT-TM with intensities
#: and timestamps (integrate_frame, config 5's loop).
BENCH_WORKER_KINDS = ("occupancy", "tsdf", "ndt_tm")


def bench_worker_maps(kind: str, device, rays_per_batch: int = 256, n_batches: int = 4) -> tuple:
    """Two maps of one small box scene (0.1 m, 8 regions): one built by the
    benches' loop through the worker, the other by the same calls in the
    same order through synchronous integrate_rays.  Returns (worker map,
    synchronous map)."""
    from ohm_tpu_torch.bench import box_scene_rays, timed_integration
    from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
    from ohm_tpu_torch.mapping.ndt_map import TorchNdtMap
    from ohm_tpu_torch.mapping.torch_map import TorchRayMapper
    from ohm_tpu_torch.mapping.tsdf_map import TorchTsdfMap
    from ohm_tpu_torch.oracle.ndt import NdtParams
    from ohm_tpu_torch.scripts.bench_modes import integrate_frame

    rng = np.random.default_rng(3)
    batches = [box_scene_rays(rays_per_batch, rng, half=(2.0, 2.0, 1.0))
               for _ in range(n_batches)]
    warmup = 2

    def mapper():
        m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
        if kind == "ndt_tm":
            return TorchNdtMap(m, NdtParams(ndt_tm=True), capacity=16, miss_k=1 << 15,
                               validate=True, device=device)
        cls = TorchTsdfMap if kind == "tsdf" else TorchRayMapper
        return cls(m, capacity=16, validate=True, device=device)

    worker, sync = mapper(), mapper()
    if kind == "ndt_tm":
        frame = np.concatenate(batches)
        n = len(frame) // 2
        intens = rng.uniform(0.0, 1.0, n).astype(np.float32)
        times = np.linspace(0.0, 0.1, n)
        integrate_frame(worker, frame, intens, times, rays_per_batch, warmup=warmup)
        step = 2 * rays_per_batch
        for i in [*range(0, warmup * step, step), *range(0, len(frame), step)]:
            sync.integrate_rays(frame[i:i + step],
                                intensities=intens[i // 2:i // 2 + rays_per_batch],
                                timestamps=times[i // 2:i // 2 + rays_per_batch])
    else:
        timed_integration(worker, batches, warmup=warmup)
        sync.prime_caps(batches)
        for b in batches[:warmup] + batches + batches:
            sync.integrate_rays(b)
    worker.sync_voxels()
    sync.sync_voxels()
    return worker.map, sync.map


def map_bytes(m) -> dict:
    """(region, layer index) -> the bytes of every layer of every chunk."""
    return {(key, i): np.ascontiguousarray(layer).tobytes()
            for key, chunk in m.chunks.items() for i, layer in enumerate(chunk.layers)}
