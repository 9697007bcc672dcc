"""The deposit probe: primitive probes and a slot-grid occupancy deposit on
one synthetic sorted record stream shaped like a bench batch (8192 rays ->
~1.25 M (flat << 1 | hit) records over 320 live slots of a 512-slot,
32768-voxel/region arena), beside the plain deposits and the production
deposit kernel on the same stream.

Counterpart of ``scripts/probe_deposit.py``.  Stages (the reference's names
in brackets):

  probes    [lower]    five probes of the primitives a slot-grid deposit
                       rests on (ops.probes_cuda): shared-memory scatter-add,
                       take-along-axis from a staged tile, a loop bound read
                       on the device, a bulk async copy from a run-time
                       offset, a one-hot product on the tensor cores
  slotgrid  [pallas]   the slot-grid deposit with the fused sweep
                       (ops.slotgrid_cuda): sorted-run counts read off
                       positions, one launch balanced by record, touching
                       only voxels with records; against the f64 reference
                       and, bit for bit, the scatter yardstick
  onehot    [xla]      the one-hot segmented matmul in plain PyTorch: block
                       partial planes by a batched product, a block -> slot
                       add (cost only: blocks spanning two slots drop the
                       second slot's records, as in the reference)
  scatter   [scatter]  the yardstick, a production-style unique scatter and
                       sweep in plain PyTorch; beside it the port's
                       production NDT deposit kernel (K3,
                       ops.deposit_cuda.deposit_and_sweep_ndt) with a zero
                       delta, which computes the same function here

Usage:
  python -m ohm_tpu_torch.scripts.probe_deposit                 # on the GPU
  python -m ohm_tpu_torch.scripts.probe_deposit --device cpu --small

``--device cpu`` runs the plain PyTorch versions of the kernels, every stage
included, and times nothing.  On the GPU each stage also prints ms/iter
(CUDA events).  The exit code is 1 when a probe fails or a deposit that
must equal the yardstick bit for bit does not.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ohm_tpu_torch.device import resolve_device
from ohm_tpu_torch.ops import deposit_cuda, probes_cuda
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.slotgrid_cuda import (V, V_SHIFT, onehot_deposit, scatter_deposit,
                                             slotgrid_deposit)

# ---- stream shape (bench-like) ---------------------------------------------
C = 512                 # arena capacity in slots
LIVE = 320              # live slots in the batch
CHUNK = 512             # records per one-hot block
N = 2442 * CHUNK        # ~1.25 M records (8192 rays x ~145 + ends, padded)
SMALL = (16 * CHUNK, 8, 5)  # (N, C, LIVE) of --small

HIT_VALUE = 0.85
MISS_VALUE = -0.15
MAX_VALUE = 250.0
MIN_VALUE = -100.0
SWEEP = {"hit": HIT_VALUE, "miss": MISS_VALUE, "min_value": MIN_VALUE,
         "max_value": MAX_VALUE}
STAGES = ("probes", "slotgrid", "onehot", "scatter")


def make_stream(n: int = N, c: int = C, live: int = LIVE, seed: int = 0) -> np.ndarray:
    """Sorted (flat<<1|hit) key stream shaped like a bench batch."""
    rng = np.random.default_rng(seed)
    # skewed slot popularity (near-sensor slots absorb most records)
    slot_pop = rng.zipf(1.3, size=n) % live
    slots = rng.permutation(live)[slot_pop].astype(np.int64)
    vox = rng.integers(0, V, size=n, dtype=np.int64)
    # ~12% of records are duplicates of a hot voxel per slot to mimic
    # near-sensor contention
    hot = rng.random(n) < 0.12
    vox[hot] = (slots[hot] * 977) % V
    flat = slots * V + vox
    hit = (rng.random(n) < 0.0067).astype(np.int64)  # ~8192 hits
    # 2% sentinel padding
    pad = rng.random(n) < 0.02
    flat[pad] = c * V
    hit[pad] = 0
    key = np.sort((flat << 1) | hit)
    return key.astype(np.int32)


def np_reference(key: np.ndarray, occ0: np.ndarray, c: int = C) -> np.ndarray:
    """f64-exact reference deposit + sweep (hit/miss counts, simple model)."""
    flat = key >> 1
    hit = key & 1
    real = flat < c * V
    n_hit = np.zeros(c * V, np.int64)
    n_miss = np.zeros(c * V, np.int64)
    np.add.at(n_hit, flat[real & (hit == 1)], 1)
    np.add.at(n_miss, flat[real & (hit == 0)], 1)
    total = n_hit * HIT_VALUE + n_miss * MISS_VALUE
    unobs = np.isposinf(occ0)
    base = np.where(unobs, 0.0, occ0)
    value = (base + total).astype(np.float32)
    value = np.where(total > 0, np.minimum(value, MAX_VALUE), value)
    value = np.where(total < 0, np.maximum(value, MIN_VALUE), value)
    touched = (n_hit + n_miss) > 0
    return np.where(touched, value, occ0).astype(np.float32)


def initial_occupancy(n: int = N, c: int = C) -> np.ndarray:
    """f32[c * V + 1 + n]: +inf (unobserved) but 20,000 normals (seed 1),
    with room past the sentinel for the scatter yardstick's tail."""
    occ0 = np.full(c * V + 1 + n, np.inf, np.float32)
    rng = np.random.default_rng(1)
    seeded = rng.integers(0, c * V, 20000)
    occ0[seeded] = rng.normal(0, 5, 20000).astype(np.float32)
    return occ0


EDGE_STREAMS = ("empty_slot", "all_sentinel", "boundary_in_row", "long_run",
                "run_across_tiles", "no_sentinel_tail")
LONG_RUN = 70_144
#: run_across_tiles's two voxels with misses and hits: (flat, first record,
#: misses, hits); each count a power of two, so that n * hit and n * miss
#: are exact in f32 and no FMA can move the sweep's bits.  The edges they
#: cross, 4096 and 8192, are multiples of the kernel's tile
#: (``slotgrid_cuda.TILE``).
ACROSS_TILES = ((20_000, 3072, 1024, 128), (V + 5_000, 8000, 64, 256))


def edge_stream(name: str):
    """A stream at the slot-grid deposit's edges: (sorted keys i32[N],
    occupancy f32[c * V], c), N a multiple of 512.

      empty_slot        4 slots, records in slots 0 and 2 only, 100 sentinels
      all_sentinel      every key is the sentinel
      boundary_in_row   slot edges at records 300 and 1300, inside 128-key
                        rows, over 64 voxels a slot (repeated counts)
      long_run          70,144 equal miss keys on one voxel, whose count
                        passes 65535 uncapped (the voxel starts at 1.1e4, so
                        the fused sweep shows it unclamped), 512 more in
                        slot 1
      run_across_tiles  12,288 records, 4 slots: a voxel's misses from
                        record 3072 to 4095 and its hits from exactly 4096
                        (a 4096-record edge), and another's hits across the
                        8192 edge (ACROSS_TILES), 100 sentinels
      no_sentinel_tail  2560 records over 2 slots, no sentinel: the last
                        three keys are real hits of the last voxel

    Every third voxel takes hits only, the others misses only, but for
    ACROSS_TILES's two.
    """
    rng = np.random.default_rng(3)
    if name == "empty_slot":
        c, n = 4, 2048
        flat = rng.choice([0, 2], n) * V + rng.integers(0, V, n)
        flat[:100] = c * V
    elif name == "all_sentinel":
        c, n = 4, 1024
        flat = np.full(n, c * V)
    elif name == "boundary_in_row":
        c, n = 4, 2048
        flat = np.repeat([0, 1, 2], [300, 1000, n - 1300]) * V + rng.integers(0, 64, n)
    elif name == "long_run":
        c, n = 2, LONG_RUN + 512
        flat = np.concatenate([np.full(LONG_RUN, 977), V + rng.integers(0, V, 512)])
    elif name == "run_across_tiles":
        c, n = 4, 12_288
        (x, x0, xm, xh), (y, y0, ym, yh) = ACROSS_TILES
        parts = [rng.integers(0, x, x0), np.full(xm + xh, x),
                 rng.integers(x + 1, y, y0 - x0 - xm - xh), np.full(ym + yh, y),
                 rng.integers(y + 1, 3 * V, n - 100 - y0 - ym - yh), np.full(100, c * V)]
        flat = np.concatenate(parts)
    elif name == "no_sentinel_tail":
        c, n = 2, 2560
        last = 2 * V - 4  # a multiple of 3: hits
        flat = np.concatenate([rng.integers(0, last, n - 3), np.full(3, last)])
    else:
        raise ValueError(f"unknown edge stream {name!r}; choose from {EDGE_STREAMS}")
    # Hits on every third voxel, misses elsewhere: no voxel takes both, so
    # the sweep's total is one rounded product (XLA's CPU backend contracts
    # a product and a sum into an FMA; tests compare mixed voxels apart).
    hit = ((flat % 3 == 0) & (flat < c * V)).astype(np.int64)
    if name == "run_across_tiles":
        for v, _, misses, hits in ACROSS_TILES:
            hit[flat == v] = np.repeat([0, 1], [misses, hits])
    occ = np.full(c * V, np.inf, np.float32)
    seeded = rng.integers(0, c * V, c * V // 8)
    occ[seeded] = rng.normal(0, 5, seeded.size).astype(np.float32)
    if name == "long_run":
        occ[977] = 1.1e4
    keys = np.sort((flat.astype(np.int64) << 1) | hit).astype(np.int32)
    return keys, occ, c


def k3_config(c: int = C) -> IntegrateConfig:
    """K3's configuration for this stream: 32^3 regions, the probe's values,
    no saturation (resolution and max_steps are not read by K3)."""
    return IntegrateConfig(resolution=0.1, region_shift=V_SHIFT // 3, capacity=c, max_steps=1,
                           hit_value=HIT_VALUE, miss_value=MISS_VALUE, min_value=MIN_VALUE,
                           max_value=MAX_VALUE, saturation_min=float("-inf"),
                           saturation_max=float("inf"))


def deposit(keys: torch.Tensor, occ: torch.Tensor, c: int = C) -> torch.Tensor:
    """The slot-grid deposit as the reference's ``run`` calls it, with the
    fused sweep (``occ`` updated in place)."""
    return slotgrid_deposit(keys, occ, c, **SWEEP)


def k3_deposit(keys: torch.Tensor, occ: torch.Tensor, cfg: IntegrateConfig) -> torch.Tensor:
    """The production NDT deposit on this stream, as the mappers call it:
    ``keys`` (sorted) as the walk stream and its bounds, no end keys, an
    empty sparse delta; in place."""
    none = torch.empty(0, dtype=torch.int32, device=keys.device)
    no_delta = (none, torch.empty(0, dtype=torch.float32, device=keys.device))
    return deposit_cuda.deposit_and_sweep_ndt(occ, keys, none, no_delta, cfg,
                                              bounds_key=keys)[0]


def largest_count(keys: torch.Tensor, c: int = C) -> int:
    """The largest hit or miss count of one voxel (equal keys in a row)."""
    real = keys[(keys >> 1) < c * V]
    if real.numel() == 0:
        return 0
    return int(torch.unique_consecutive(real, return_counts=True)[1].max())


def largest_run(keys: torch.Tensor, c: int = C) -> int:
    """The most records of one voxel (its misses and hits, one run)."""
    return largest_count(keys >> 1 << 1, c)


def time_ms(fn, iters: int) -> float:
    """Mean ms per call on the current CUDA stream (CUDA events), after one
    call to warm up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bit_mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


def run(device="cuda", stages=STAGES, n: int = N, c: int = C, live: int = LIVE,
        iters: int = 10) -> dict:
    """Run ``stages`` on ``device`` and print what each finds; returns the
    findings, with ``ok`` False when a probe failed or a deposit that must
    equal the yardstick does not."""
    dev = resolve_device(device)
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}; choose from {STAGES}")
    timed = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if timed else "cpu"
    print(f"device: {name}  stream N={n} C={c} live={live}", flush=True)
    n_vox = c * V
    key_np = make_stream(n, c, live)
    keys = torch.from_numpy(key_np).to(dev)
    occ0_np = initial_occupancy(n, c)
    occ_flat = torch.from_numpy(occ0_np).to(dev)
    ref = np_reference(key_np, occ0_np[:n_vox], c) if set(stages) != {"probes"} else None
    out = {"device": name, "n": n, "c": c, "live": live, "largest_count": largest_count(keys, c)}
    ok = True
    yardstick = None

    def scatter():
        nonlocal yardstick
        if yardstick is None:
            yardstick = scatter_deposit(keys, occ_flat, c, **SWEEP)
        return yardstick

    def report(tag, fn):
        if timed:
            ms = time_ms(fn, iters)
            print(f"  [{tag}] {ms:.4f} ms/iter  ({n / ms * 1e3 / 1e6:.1f} M rec/s)", flush=True)
            return ms
        return None

    if "probes" in stages:
        print("== A. deposit probes ==", flush=True)
        out["probes"] = probes_cuda.probe_lowering(dev)
        ok = ok and all(status == "OK" for status, _ in out["probes"].values())

    if "slotgrid" in stages:
        print("== B. slot-grid deposit ==", flush=True)
        got = deposit(keys, occ_flat.clone(), c)
        host = got[:n_vox].cpu().numpy()
        mism = int(np.sum(host != ref))
        with np.errstate(invalid="ignore"):  # inf - inf where both are unobserved
            worst = float(np.max(np.abs(np.nan_to_num(host - ref, posinf=0))))
        bits = bit_mismatches(got[:n_vox], scatter()[:n_vox])
        run_len = largest_run(keys, c)
        print(f"  [slotgrid] vs f64 reference: mismatches={mism} worst={worst}")
        print(f"  [slotgrid] vs f32 scatter path: bit mismatches={bits}")
        print(f"  [slotgrid] largest run: {run_len} records of one voxel")
        occ = occ_flat.clone()
        out["slotgrid"] = {"mismatches_f64": mism, "worst_f64": worst,
                           "bit_mismatches_scatter": bits, "largest_run_records": run_len,
                           "ms": report("slotgrid", lambda: deposit(keys, occ, c))}
        ok = ok and bits == 0

    if "onehot" in stages:
        print("== C. one-hot segmented matmul (cost only) ==", flush=True)
        occ_slots = occ_flat[:n_vox]
        got = onehot_deposit(keys, occ_slots, c, **SWEEP)
        mism = int(np.sum(got.cpu().numpy() != ref))
        print(f"  [onehot] vs f64 reference: mismatches={mism} (records of blocks spanning "
              f"two slots are dropped)")
        out["onehot"] = {"mismatches_f64": mism,
                         "ms": report("onehot", lambda: onehot_deposit(keys, occ_slots, c,
                                                                       **SWEEP))}

    if "scatter" in stages:
        print("== yardstick: production-style scatter + sweep ==", flush=True)
        sc = scatter()
        mism = int(np.sum(sc[:n_vox].cpu().numpy() != ref))
        print(f"  [scatter] vs f64 reference: mismatches={mism}")
        cfg = k3_config(c)
        k3 = k3_deposit(keys, occ_flat.clone(), cfg)
        bits = bit_mismatches(k3[:n_vox], sc[:n_vox])
        print(f"  [k3] vs f32 scatter path: bit mismatches={bits} "
              f"(largest count {out['largest_count']}; K3 caps at 65535)")
        scatter_ms = report("scatter", lambda: scatter_deposit(keys, occ_flat, c, **SWEEP))
        occ = occ_flat.clone()
        k3_ms = report("k3", lambda: k3_deposit(keys, occ, cfg))
        out["scatter"] = {"mismatches_f64": mism, "ms": scatter_ms,
                          "k3_bit_mismatches_scatter": bits, "k3_ms": k3_ms}
        ok = ok and bits == 0
    out["ok"] = bool(ok)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their plain versions)")
    ap.add_argument("--small", action="store_true",
                    help=f"tiny stream (N, C, live) = {SMALL} for logic checks")
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    n, c, live = SMALL if args.small else (N, C, LIVE)
    return run(args.device, tuple(args.stages.split(",")), n, c, live, args.iters)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
