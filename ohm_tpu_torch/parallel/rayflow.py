"""Multi-shard mapping on the rayflow wire, routed on the devices.

Counterpart of ``ohm_tpu/parallel/rayflow.py``:

  - Host: rays are split round-robin by SOURCE shard; each sub-batch is
    prepared with the rayflow C++ pass (mapping.batch.prepare_rayflow)
    against a common union bbox, and its candidate dictionary is resolved
    against each region's OWNER shard table (the wire layout is the
    single-device one).  Each shard's wire goes to its device.
  - Device, per shard: unpack its wire (ops.wire.unpack_batch); derive every
    ray's DISTINCT candidate-region owners (region_owner_torch, bit-identical
    to the host hash); route the unpacked fields with the MoE dispatch
    (parallel.a2a.dest_slots, three transport planes: ints, floats, flags,
    swapped by ShardMesh.all_to_all); on the destination, mask foreign
    candidates (their slots never resolve), rebuild the batch with the keys
    unpack_batch gives, and run the unchanged single-device core
    (ops.integrate.integrate_decoded, integrate_ndt or integrate_tsdf)
    against the shard's resident arena.

Every region has one owner, each ray reaches every owner of its candidate
set once, and foreign candidates are masked, so each voxel record deposits
on exactly one shard.

The step runs the walk as the single-device mapper does on this wire: the
rank walk under group compaction, so K1 (ops.expand_cuda) launches on each
shard; the host sizes each destination's group cap from the exact crossing
counts of the rays routed to it.  (The reference runs its monolith here;
the occupancy counts, hence the bits, are the same.)  A routed ray keeps its
source's ray index times n_shards plus the source: its index in the
round-robin split's batch, so each voxel's NDT samples and TSDF visits
keep the single-device order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ohm_tpu_torch import native
from ohm_tpu_torch.core.rayflags import RayFlag, normalize_reverse_walk
from ohm_tpu_torch.mapping.batch import frac_dict_of, prepare_rayflow, rayflow_wire
from ohm_tpu_torch.mapping.torch_map import TorchRayMapper
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.integrate import integrate_decoded
from ohm_tpu_torch.ops.wire import end_frac_of, unpack_batch
from ohm_tpu_torch.parallel.a2a import dest_slots, send_buffer
from ohm_tpu_torch.parallel.mapper import ShardedRayMapper
from ohm_tpu_torch.parallel.mesh import ShardMesh
from ohm_tpu_torch.parallel.sharded import region_owner, region_owner_torch

#: Rows of a compaction group (ops.integrate.group_rows), as the
#: single-device mapper takes them on a wire whose rpad divides by 64.
GROUP_SIZE = 64


def _pow2(n: int, floor: int = 64) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


def _decode_rel(tcand: torch.Tensor) -> torch.Tensor:
    """Packed candidate -> bbox-relative region coords [..., 3]."""
    return torch.stack([tcand & 63, (tcand >> 6) & 63, (tcand >> 12) & 63], dim=-1)


def build_rayflow_step(mesh: ShardMesh, cfg, core_fn, stats_keys, capacity: int):
    """The step: unpack -> owner routing -> all_to_all -> foreign-candidate
    masking -> the single-device core, on every shard.  ``step(states,
    wires)`` takes each shard's layer dict and its wire (uint8 on its device),
    updates the layers in place and returns ``stats_keys`` stacked
    [n_shards]."""
    n_shards = mesh.n_shards
    base = cfg if isinstance(cfg, IntegrateConfig) else cfg.base
    K = base.table_k

    def route(s, wire):
        b = unpack_batch(wire, base)
        R = b["length"].shape[0]
        gmeta = b["gmeta"]
        # Distinct candidate-region owners per ray (null dictionary entries
        # carry slot bits 0 and never route).
        owner = region_owner_torch(_decode_rel(b["tcand"]) + gmeta[0:3], n_shards)
        live = ((b["tcand"] >> 18) > 0) & b["valid"][:, None]
        dest = torch.sort(torch.where(live, owner, torch.full_like(owner, n_shards)),
                          dim=1).values
        firsts = torch.ones_like(live)
        firsts[:, 1:] = dest[:, 1:] != dest[:, :-1]
        dest_flat = torch.where(firsts, dest, torch.full_like(dest, n_shards)).reshape(-1)
        order, row, ok, dropped = dest_slots(dest_flat, n_shards, capacity)
        ray = torch.arange(R, device=wire.device).repeat_interleave(K)[order]
        planes = {
            "ints": (torch.cat([b["start_abs"], b["end_abs"], b["tcand"],
                                b["ray_order"][:, None]], dim=1), -1),
            "floats": (torch.cat([b["start_frac"], b["direction"], b["length"][:, None],
                                  b["intensity"][:, None]], dim=1), 0.0),
            "flags": (torch.stack([b["is_sample"], b["end_as_miss"], b["valid"]], dim=1),
                      False),
        }
        send = {name: send_buffer(arr, ray, row, ok, fill, n_shards, capacity)
                for name, (arr, fill) in planes.items()}
        return send, dropped, gmeta

    def local(d, state, recv, dropped, gmeta):
        n = n_shards * capacity
        r_ints = recv["ints"].reshape(n, -1)
        r_floats = recv["floats"].reshape(n, -1)
        r_flags = recv["flags"].reshape(n, -1)
        tcand = r_ints[:, 6:6 + K]
        owner = region_owner_torch(_decode_rel(tcand) + gmeta[0:3], n_shards)
        tcand = torch.where(owner == d, tcand, torch.zeros_like(tcand))
        valid = r_flags[:, 2].contiguous()
        start_abs, end_abs = r_ints[:, 0:3].contiguous(), r_ints[:, 3:6].contiguous()
        start_frac, direction, length = r_floats[:, 0:3], r_floats[:, 3:6], r_floats[:, 6]
        source = torch.arange(n, dtype=torch.int32, device=r_ints.device) // capacity
        rb = {
            "start_abs": start_abs,
            "end_abs": end_abs,
            "start_frac": start_frac,
            "end_frac": end_frac_of(start_frac, start_abs, end_abs, length, direction,
                                    base.resolution),
            "direction": direction,
            "length": length,
            "is_sample": r_flags[:, 0] & valid,
            "end_as_miss": r_flags[:, 1] & valid,
            "exclude_start": valid,
            "valid": valid,
            "intensity": r_floats[:, 7],
            "tcand": tcand,
            "gmeta": gmeta,
            "ray_order": r_ints[:, 6 + K] * n_shards + source,
            "t0": torch.zeros_like(length),
            "full_length": length,
        }
        stats = core_fn(state, rb, cfg)
        stats["routing_dropped"] = dropped
        return stats

    def step(states, wires):
        routed = mesh.run(route, [(w,) for w in wires])
        recv = {name: mesh.all_to_all([send[name] for send, _, _ in routed])
                for name in ("ints", "floats", "flags")}
        stats = mesh.run(local, [(states[d], {k: v[d] for k, v in recv.items()},
                                  routed[d][1], routed[d][2]) for d in range(n_shards)])
        return mesh.gather_stats(stats, stats_keys)

    return step


class ShardedRayFlowMapper:
    """Region-sharded multi-shard mapper on the rayflow wire.

    The arena and kind machinery of parallel.mapper.ShardedRayMapper; per
    batch the single-device pipeline: rayflow C++ prep, the dictionary
    candidate wire, one upload a shard, on-device routing, and the unchanged
    integrate cores per shard.  A batch outside the rayflow envelope (a
    source sub-batch that prepare_rayflow refuses, uneven padded source
    sizes, a union bbox over 63 regions, over 2047 regions in one source)
    raises ValueError: ShardedRayMapper is the segmented path."""

    OCC_STATS = ("missed_updates", "applied_updates", "overflow", "touched",
                 "compaction_dropped", "routing_dropped")
    AUX_STATS = ("missed_updates", "overflow", "touched", "compaction_dropped",
                 "routing_dropped")

    def __init__(self, map_obj, mesh: ShardMesh, kind: str = "occupancy",
                 capacity: int = 256, scatter_pad: int = 1 << 20, validate: bool = False,
                 ndt_params=None, tsdf_options=None):
        """The reference's parameters in its order and with its defaults
        (ohm_tpu/parallel/rayflow.py:195-197); ``scatter_pad`` is stored and
        bounds nothing, as in parallel.mapper.ShardedRayMapper."""
        self._seg = ShardedRayMapper(map_obj, mesh, kind=kind, capacity=capacity,
                                     scatter_pad=scatter_pad, ndt_params=ndt_params,
                                     tsdf_options=tsdf_options)
        self.scatter_pad = int(scatter_pad)
        self.map = map_obj
        self.mesh = mesh
        self.kind = kind
        self.validate = validate
        self.arena = self._seg.arena
        self.n_shards = self.arena.n_shards
        self._stats = {"rays": 0, "batches": 0, "missed_updates": 0, "overflow": 0,
                       "compaction_dropped": 0, "routing_dropped": 0, "routed_rays": 0,
                       "wire_bytes": 0}
        #: Per-shard applied_updates of the most recent drained batch (the
        #: record balance across shards).
        self.last_balance = None
        self._pending = []
        # Monotone shape caches (the single-device mapper's).
        self._k_cache = 4
        self._steps_cache = 32
        self._wcap_cache = 64
        self._cap_cache = 64
        self._gcap_cache = 0

    # ------------------------------------------------------------------ #

    def _owner_slots(self, region_keys: np.ndarray) -> np.ndarray:
        """Resolve every region's slot in its OWNER shard's table."""
        n = len(region_keys)
        owners = region_owner(region_keys, self.n_shards)
        slots = np.full(n, -1, np.int32)
        for s in range(self.n_shards):
            mine = owners == s
            if not mine.any():
                continue
            slots[mine] = native.lookup_slots(region_keys[mine], self.arena.shards[s].table)
        if (slots < 0).any():
            raise RuntimeError("owner table missing a just-ensured region")
        return slots

    def _routing(self, rfs) -> tuple[int, int, int]:
        """The per-(source, dest) ray capacity from the host's exact owner
        sets, the routed ray copies (a ray ships to each distinct owner of
        its candidate regions), and the largest group cap over the
        destinations: each destination receives, source by source, the rays
        routed to it in wire order, each source's block padded to the
        capacity (the device's stable sort by destination)."""
        S = self.n_shards
        routed = []
        cap = 0
        for rf in rfs:
            rt = rf.bufs["ray_table"][:rf.n_rays]
            counts = rf.bufs["ray_count"][:rf.n_rays]
            owners = region_owner(rt.reshape(-1, 3), S).reshape(rf.n_rays, -1)
            kidx = np.arange(rt.shape[1])[None, :]
            owners = np.where(kidx < counts[:, None], owners, -1)
            rows = [np.flatnonzero(np.any(owners == d, axis=1)) for d in range(S)]
            cap = max(cap, max(len(r) for r in rows))
            routed.append(rows)
        self._cap_cache = max(self._cap_cache, _pow2(cap))
        gcap = 0
        for d in range(S):
            crossings = np.zeros(S * self._cap_cache, np.int32)
            for s, rf in enumerate(rfs):
                rows = routed[s][d]
                start = s * self._cap_cache
                crossings[start:start + len(rows)] = rf.crossings[rows]
            gcap = max(gcap, TorchRayMapper._rayflow_group_cap(crossings, GROUP_SIZE, False))
        return self._cap_cache, sum(len(r) for rows in routed for r in rows), gcap

    def integrate_rays(self, rays, intensities=None, timestamps=None,
                       ray_update_flags: int = 0) -> int:
        ray_update_flags = normalize_reverse_walk(ray_update_flags)
        m = self.map
        m.touch()
        r = np.asarray(rays, dtype=np.float64).reshape(-1, 3)
        n_rays = r.shape[0] // 2
        S = self.n_shards

        # Source split (round-robin): the stand-in for one sensor stream a
        # shard.
        pairs = r.reshape(n_rays, 2, 3)
        subs = [pairs[s::S].reshape(-1, 3) for s in range(S)]
        sub_int = [None if intensities is None
                   else np.asarray(intensities, np.float32).reshape(-1)[s::S]
                   for s in range(S)]
        rfs = [prepare_rayflow(m, subs[s], intensities=sub_int[s],
                               ray_update_flags=ray_update_flags) for s in range(S)]
        if any(rf is None for rf in rfs):
            raise ValueError("batch outside the rayflow envelope; use "
                             "parallel.mapper.ShardedRayMapper for the segmented path")
        rpad = rfs[0].rpad
        if any(rf.rpad != rpad for rf in rfs):
            raise ValueError("uneven source split (rpad mismatch); pass a batch with "
                             ">= 256*n_shards rays")

        # Common union bbox (every wire encodes rel coords against it).
        bbox = rfs[0].bbox.copy()
        for rf in rfs[1:]:
            bbox[0:3] = np.minimum(bbox[0:3], rf.bbox[0:3])
            bbox[3:6] = np.maximum(bbox[3:6], rf.bbox[3:6])
        if np.any(bbox[3:6] - bbox[0:3] > 63):
            raise ValueError("union bbox exceeds the 6-bit rel-region bound")

        all_regions = np.unique(np.concatenate([rf.region_keys for rf in rfs]),
                                axis=0).astype(np.int32)
        self.arena.ensure_regions(all_regions, host_map=m)

        # Shared shape caps (monotone, as the single-device mapper's).
        self._k_cache = max(self._k_cache, max(rf.table_k for rf in rfs))
        steps = max(int(rf.max_axis_steps) for rf in rfs) + 1
        self._steps_cache = max(self._steps_cache, -(-steps // 32) * 32)
        wcap = max(int(rf.crossings.max()) if rf.n_rays else 1 for rf in rfs) + 2
        self._wcap_cache = max(self._wcap_cache, -(-wcap // 64) * 64)

        # Per-source wires against the union bbox, dictionaries resolved per
        # OWNER.  The dictionary modes agree across shards (one wire layout).
        nreg_max = max(len(rf.region_keys) for rf in rfs)
        cdict = 1 if nreg_max <= 255 else (2 if nreg_max <= 2047 else 0)
        if cdict == 0:
            raise ValueError("sharded rayflow requires the dictionary wire "
                             "(<= 2047 regions per source sub-batch)")
        fds = [frac_dict_of(rf) for rf in rfs]
        fdict_on = all(fd is not None for fd in fds)
        wires = []
        for s, rf in enumerate(rfs):
            rf.bufs["bbox"][:] = bbox
            rf = dataclasses.replace(rf, table_k=self._k_cache)
            w = rayflow_wire(rf, self.arena.shards[0].table, with_touch=False,
                             with_intensity=self.kind == "ndt", cdict=cdict,
                             fdict=fds[s] if fdict_on else None)
            # Overwrite the dictionary block with owner-resolved candidates.
            keys = rf.region_keys
            slots = self._owner_slots(keys)
            rel = keys.astype(np.int64) - bbox[0:3][None, :]
            packed = (((slots.astype(np.int64) + 1) << 18)
                      | rel[:, 0] | (rel[:, 1] << 6) | (rel[:, 2] << 12)).astype(np.int32)
            n_entries, idx_w = (256, 1) if cdict == 1 else (2048, 2)
            dict_bytes = 4 * n_entries
            tail = dict_bytes + idx_w * rpad * self._k_cache
            dict_block = np.zeros(n_entries, np.int32)
            dict_block[:len(packed)] = packed
            w[-tail:-tail + dict_bytes] = dict_block.view(np.uint8)
            wires.append(w)

        capacity, routed_total, gcap = self._routing(rfs)
        self._gcap_cache = max(self._gcap_cache, gcap)
        self._stats["routed_rays"] += routed_total
        self._stats["wire_bytes"] += sum(int(w.nbytes) for w in wires)
        uploads = [torch.from_numpy(w).to(dev) for w, dev in zip(wires, self.mesh.devices)]

        cfg, core, stats_keys = self._config_and_core(ray_update_flags, cdict, fdict_on)
        step = build_rayflow_step(self.mesh, cfg, core, stats_keys, capacity)
        stats = step(self.arena.layers, uploads)

        self._stats["rays"] += n_rays
        self._stats["batches"] += 1
        self._pending.append(stats)
        if self.validate:
            self._drain()
            for name in ("routing_dropped", "overflow", "compaction_dropped"):
                if self._stats[name]:
                    raise RuntimeError(f"sharded rayflow batch: {name}={self._stats[name]}")
        return n_rays

    def _config_and_core(self, ray_flags: int, cdict: int, fdict: bool):
        """The shards' config: the segmented mapper's with the rayflow
        wire's shapes, no touch block, and the rank walk under group
        compaction (so K1 runs) but under STOP_ON_FIRST_OCCUPIED."""
        seg = self._seg
        # A group cap of 0 would turn the rank walk off; 512 is the
        # single-device cap's floor.
        group_cap = self._gcap_cache or 512
        base = dataclasses.replace(
            seg._base_config(ray_flags),
            max_steps=self._steps_cache,
            walk_cap=self._wcap_cache,
            table_k=self._k_cache,
            rayw_cdict=cdict,
            rayw_fdict=fdict,
            rayw_intensity=self.kind == "ndt",
            with_touch_time=False,
            group_cap=group_cap,
            group_size=GROUP_SIZE,
            unordered_walk=not (int(ray_flags) & RayFlag.STOP_ON_FIRST_OCCUPIED),
        )
        if self.kind == "occupancy":
            return base, integrate_decoded, self.OCC_STATS
        cfg, core, _ = seg._config_and_core(ray_flags)
        return dataclasses.replace(cfg, base=base), core, self.AUX_STATS

    def _drain(self):
        for stats in self._pending:
            for name in ("missed_updates", "overflow", "compaction_dropped",
                         "routing_dropped"):
                self._stats[name] += int(stats[name].sum())
            if "applied_updates" in stats:
                self.last_balance = stats["applied_updates"].reshape(-1).tolist()
        self._pending.clear()

    def sync_voxels(self):
        self._drain()
        self.arena.sync_to_host(self.map, stamp=self.map.stamp)

    @property
    def stats(self) -> dict:
        self._drain()
        return dict(self._stats)
