"""Device-side all-to-all routing of a source-sharded segmented batch.

Counterpart of ``ohm_tpu/parallel/a2a.py``.  Host routing
(parallel.sharded.make_routed_batch) packs per-shard subsets in a Python
loop; here the batch arrives sharded by SOURCE and is routed on the
devices with the MoE-dispatch pattern:

  1. each source shard computes, per segment, the DISTINCT owners of its
     2x2x2 corner-region box (region_owner_torch, bit-identical to the host
     hash): a (segment, owner) pair list with duplicates masked;
  2. pairs are sorted by destination (a stable sort); each pair's position
     within its destination comes from a running maximum of the
     destination's first position (torch.cummax); segments scatter into a
     [n_dest, cap, ...] send buffer;
  3. ShardMesh.all_to_all swaps the send buffers; the receive side reads
     its [n_src, cap] slots as one local batch.

Corner slots are resolved on the HOST against each corner's OWNER table
(make_source_batch), and every destination masks foreign corners (owner !=
this shard -> slot -1), so each voxel record applies on exactly one shard.
The fixed per-(source, dest) capacity drops overflowing pairs and counts
them (``routing_dropped``, 0 in a correct run: the host sizes the capacity
from exact counts).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ohm_tpu_torch.mapping.batch import fill_corner_slots
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.integrate import integrate_decoded
from ohm_tpu_torch.ops.wire import unpack_segmented
from ohm_tpu_torch.parallel.mesh import ShardMesh
from ohm_tpu_torch.parallel.sharded import _upload, region_owner, region_owner_torch

#: Corner offsets in cidx order (dx + 2*dy + 4*dz): mapping.batch's corner
#: packing and ops.integrate.resolve_corner_slots.
_OFFS = np.array([[dx, dy, dz] for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
                 dtype=np.int32)

#: The stats of an a2a step.
A2A_STATS = ("missed_updates", "applied_updates", "overflow", "touched", "routing_dropped")


def make_source_batch(prepared, arenas, mesh: ShardMesh):
    """Shard a prepared batch by SOURCE (round-robin) with corner slots
    resolved against each corner's OWNER shard table.

    ``arenas`` is a ShardedArena or ResidentShardedArena.  Returns
    (per-shard batch dicts of ints/floats/flags/touch [B_loc, ...] on each
    shard's device, the largest (source, dest) pair count, for the
    capacity)."""
    shards = arenas.shards
    n_shards = len(shards)
    total = prepared.n_segments

    # Resolve every corner against its owner's table: query each shard's
    # table for all corners, then select by ownership.
    corner_regions = prepared.corner_regions[:total]  # [B, 8, 3]
    owners = region_owner(corner_regions.reshape(-1, 3), n_shards).reshape(total, 8)
    slots = np.full((total, 8), -1, np.int32)
    for s in range(n_shards):
        sub = dataclasses.replace(
            prepared, size=total, n_segments=total,
            arrays={k: v[:total].copy() for k, v in prepared.arrays.items()},
            corner_regions=corner_regions)
        fill_corner_slots(sub, shards[s].table)
        mine = owners == s
        slots[mine] = sub.arrays["ints"][:total, 9:17][mine]

    arrays = {k: v[:total] for k, v in prepared.arrays.items()}
    ints = arrays["ints"].copy()
    ints[:, 9:17] = slots

    b_loc = -(-total // n_shards)
    b_loc = max(256, 1 << (b_loc - 1).bit_length())

    def shard_arr(a, s):
        out = np.zeros((b_loc,) + a.shape[1:], a.dtype)
        part = a[s::n_shards]
        out[:len(part)] = part
        return out

    src = {"ints": ints, "floats": arrays["floats"].astype(np.float32),
           "flags": arrays["flags"].astype(bool), "touch": arrays["touch"]}
    batches = [_upload(mesh, s, {k: shard_arr(v, s) for k, v in src.items()})
               for s in range(n_shards)]
    # Exact per-(source, dest) distinct-owner pair counts for capacity.
    max_pairs = 0
    for s in range(n_shards):
        sub_owners = owners[s::n_shards]
        for d in range(n_shards):
            max_pairs = max(max_pairs, int(np.any(sub_owners == d, axis=1).sum()))
    return batches, max_pairs


def dest_slots(dest: torch.Tensor, n_shards: int, capacity: int):
    """Send-buffer rows of pairs with destination ``dest`` (i32[P], n_shards
    marking no pair): pairs sorted by destination (stable), each one's
    position within its destination (torch.cummax of the destinations'
    first positions).  Returns (order of the pairs by destination, row in
    the [n_shards * capacity + 1] buffer (the last row takes what does not
    fit), fits, count of live pairs dropped)."""
    dest_s, order = torch.sort(dest, stable=True)
    n = dest_s.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=dest.device)
    first = torch.ones_like(dest_s, dtype=torch.bool)
    first[1:] = dest_s[1:] != dest_s[:-1]
    base = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    slot_in = pos - base
    live = dest_s < n_shards
    ok = live & (slot_in < capacity)
    dropped = (live & ~ok).sum()
    row = torch.where(ok, dest_s.to(torch.int64) * capacity + slot_in,
                      torch.full_like(pos, n_shards * capacity))
    return order, row, ok, dropped


def send_buffer(arr: torch.Tensor, order, row, ok, fill, n_shards: int, capacity: int):
    """Rows ``arr[order]`` scattered to their send rows: [n_shards, capacity,
    ...], ``fill`` where no pair landed."""
    rows = arr[order]
    rows = torch.where(ok.reshape((-1,) + (1,) * (arr.dim() - 1)), rows,
                       torch.full_like(rows, fill))
    buf = torch.full((n_shards * capacity + 1,) + tuple(arr.shape[1:]), fill,
                     dtype=arr.dtype, device=arr.device)
    buf[row] = rows
    return buf[:-1].reshape((n_shards, capacity) + tuple(arr.shape[1:]))


def _corner_owners(ints: torch.Tensor, region_dim_shift: int, n_shards: int,
                   offs: torch.Tensor) -> torch.Tensor:
    """Owners i32[B, 8] of each segment's 2x2x2 corner-region box."""
    start_r = ints[:, 0:3] >> region_dim_shift
    end_r = ints[:, 3:6] >> region_dim_shift
    rmin = torch.minimum(start_r, end_r)
    span = torch.clamp(torch.maximum(start_r, end_r) - rmin, max=1)
    corners = rmin[:, None, :] + offs[None, :, :] * span[:, None, :]
    return region_owner_torch(corners, n_shards)


def sharded_integrate_a2a(mesh: ShardMesh, cfg: IntegrateConfig, capacity: int,
                          region_dim_shift: int):
    """The step: on-device corner-owner routing + all_to_all + the local
    occupancy core (ops.integrate.integrate_decoded).  ``capacity`` is the
    per-(source, dest) segment budget.  ``step(states, batches)`` updates
    each shard's layers in place and returns A2A_STATS stacked [n_shards]."""
    n_shards = mesh.n_shards

    def route(s, batch):
        ints, flags = batch["ints"], batch["flags"]
        B = ints.shape[0]
        offs = torch.from_numpy(_OFFS).to(ints.device)
        owner8 = _corner_owners(ints, region_dim_shift, n_shards, offs)
        # Each (segment, owner) pair once: its first corner with that owner.
        firsts = torch.ones((B, 8), dtype=torch.bool, device=ints.device)
        for c in range(1, 8):
            firsts[:, c] = ~(owner8[:, :c] == owner8[:, c:c + 1]).any(dim=1)
        pair_valid = firsts & flags[:, 3:4]
        dest = torch.where(pair_valid, owner8, torch.full_like(owner8, n_shards)).reshape(-1)
        seg = torch.arange(B, device=ints.device).repeat_interleave(8)
        order, row, ok, dropped = dest_slots(dest, n_shards, capacity)
        send = {name: send_buffer(batch[name], seg[order], row, ok, fill, n_shards, capacity)
                for name, fill in (("ints", -1), ("floats", 0.0), ("flags", False),
                                   ("touch", 0))}
        return send, dropped

    def local(s, state, recv, dropped):
        r_ints = recv["ints"].reshape(n_shards * capacity, -1)
        offs = torch.from_numpy(_OFFS).to(r_ints.device)
        # Only the corners this shard owns resolve; received padding rows
        # carry flags False, so the valid bit drops them.
        rowner = _corner_owners(r_ints, region_dim_shift, n_shards, offs)
        slots8 = torch.where(rowner == s, r_ints[:, 9:17], torch.full_like(rowner, -1))
        batch = {"ints": torch.cat([r_ints[:, 0:9], slots8], dim=1),
                 "floats": recv["floats"].reshape(n_shards * capacity, -1),
                 "flags": recv["flags"].reshape(n_shards * capacity, -1),
                 "touch": recv["touch"].reshape(n_shards * capacity)}
        stats = integrate_decoded(state, unpack_segmented(batch, cfg), cfg)
        stats["routing_dropped"] = dropped
        return stats

    def step(states, batches):
        routed = mesh.run(route, [(b,) for b in batches])
        recv = {name: mesh.all_to_all([send[name] for send, _ in routed])
                for name in ("ints", "floats", "flags", "touch")}
        stats = mesh.run(local, [(states[d], {k: v[d] for k, v in recv.items()},
                                  routed[d][1].to(mesh.devices[d])) for d in range(n_shards)])
        return mesh.gather_stats(stats, A2A_STATS)

    return step
