"""ShardedRayMapper: multi-shard ray integration with arenas resident on
their devices.

Counterpart of ``ohm_tpu/parallel/mapper.py``:

  - ``ResidentShardedArena`` keeps one port ``VoxelArena`` per shard on its
    mesh device (layout ``capacity * V + 1``, the single-device arena's;
    the reference's scatter tail is not ported), updated in place by each
    step; region upload and eviction touch only the affected slot of one
    shard.  The slot directories and the LRU follow the reference's
    ``ResidentShardedArena`` exactly (one batch clock over all shards, one
    region evicted at a time), so both packages place every region in the
    same slot of the same shard.
  - ``ShardedRayMapper`` drives the per-batch pipeline: host prep
    (mapping.batch.prepare_ray_batch) -> per-shard region allocation -> host
    routing (parallel.sharded.make_routed_batch: each segment ships only to
    the owners of its corner regions) -> one step on every shard (the
    single-device core: ops.integrate.integrate_decoded, integrate_ndt or
    integrate_tsdf) -> deferred sync_voxels.
  - Occupancy, NDT and TSDF share the machinery (``kind``).

Each shard's layers are its own tensors, so a read of one region copies its
bits, -0.0 included (the reference reads through ``addressable_shards``
because XLA's cross-shard slice canonicalises -0.0).
"""

from __future__ import annotations

import numpy as np

from ohm_tpu_torch.core.layout import (INCIDENT_NORMAL_LAYER, MEAN_LAYER, TOUCH_TIME_LAYER,
                                       TRAVERSAL_LAYER)
from ohm_tpu_torch.mapping.arena import VoxelArena
from ohm_tpu_torch.mapping.batch import max_steps_for, prepare_ray_batch
from ohm_tpu_torch.ops.config import IntegrateConfig, NdtConfig, TsdfConfig
from ohm_tpu_torch.ops.integrate import integrate_decoded
from ohm_tpu_torch.ops.integrate_ndt import integrate_ndt
from ohm_tpu_torch.ops.integrate_tsdf import integrate_tsdf
from ohm_tpu_torch.parallel.mesh import ShardMesh
from ohm_tpu_torch.parallel.sharded import build_routed_step, make_routed_batch, region_owner


class ResidentShardedArena:
    """One VoxelArena per shard, resident on its mesh device across batches.

    ``shards[s]`` is shard s's arena: its ``layers`` (layer name -> tensor on
    shard s's device) and its slot directory (``table``, ``slot_of``,
    ``region_of``, ``free_slots``, ``last_used``); the batch clock and the
    stats are this object's."""

    def __init__(self, mesh: ShardMesh, capacity: int, region_shift: int,
                 layer_names, scatter_pad: int = 1 << 20, occupancy_encoding: str = "zero"):
        """The reference's parameters in its order.  ``scatter_pad`` is
        stored and bounds nothing: the reference sizes each shard's scratch
        tail with it, and the port's shards have none (their layout is the
        single-device arena's)."""
        self.mesh = mesh
        self.scatter_pad = int(scatter_pad)
        self.n_shards = mesh.n_shards
        self.capacity = int(capacity)
        self.region_shift = int(region_shift)
        self.voxels_per_region = 1 << (3 * region_shift)
        self.layer_names = list(layer_names)
        self.occupancy_encoding = occupancy_encoding
        self.shards = [VoxelArena(self.capacity, self.region_shift, dev, self.layer_names,
                                  occupancy_encoding) for dev in mesh.devices]
        self.batch_counter = 0
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}

    @property
    def layers(self) -> list:
        """Each shard's layer dict (what a step updates in place)."""
        return [a.layers for a in self.shards]

    def ensure_regions(self, region_keys: np.ndarray, host_map=None):
        """Allocate owner-shard slots for every region; evict the least
        recently used region of a full shard (spilled to ``host_map``).
        Raises RuntimeError when a shard's regions of this batch alone fill
        it."""
        self.batch_counter += 1
        keys = np.asarray(region_keys, dtype=np.int64).reshape(-1, 3)
        owners = region_owner(keys, self.n_shards)
        for key, owner in zip(map(tuple, keys), owners):
            key = (int(key[0]), int(key[1]), int(key[2]))
            s = int(owner)
            d = self.shards[s]
            slot = d.slot_of.get(key)
            if slot is not None:
                d.last_used[slot] = self.batch_counter
                self.stats["hits"] += 1
                continue
            self.stats["misses"] += 1
            if not d.free_slots:
                self._evict_lru(s, host_map)
            slot = d.free_slots.pop()
            d.slot_of[key] = slot
            d.region_of[slot] = key
            d.last_used[slot] = self.batch_counter
            d.table.insert(key, slot)
            if host_map is not None and host_map.region(key) is not None:
                d._upload_region(host_map, key, slot)

    def _evict_lru(self, s: int, host_map):
        d = self.shards[s]
        used = [(d.last_used[i], i) for i in range(d.capacity)
                if d.region_of[i] is not None and d.last_used[i] < self.batch_counter]
        if not used:
            raise RuntimeError(
                f"shard {s} arena capacity exhausted within a single batch; "
                f"increase per-shard capacity (capacity={d.capacity})")
        _, slot = min(used)
        self.stats["evictions"] += 1
        key = d.region_of[slot]
        if host_map is not None:
            d._download_region(host_map, key, slot)
        d.table.remove(key)
        del d.slot_of[key]
        d.region_of[slot] = None
        d.free_slots.append(slot)

    def sync_to_host(self, host_map, stamp=None):
        """Download every resident region that holds a touched voxel into
        the host map."""
        for arena in self.shards:
            arena.sync_to_host(host_map, stamp=stamp)


class ShardedRayMapper:
    """Multi-shard region-sharded ray integrator (occupancy / NDT / TSDF).

    Batches are routed on the host (each segment ships only to the shards
    owning its corner regions) and integrated in one step against per-shard
    arenas that stay resident on their devices across batches."""

    OCC_STATS = ("missed_updates", "applied_updates", "overflow", "touched")
    AUX_STATS = ("missed_updates", "overflow", "touched")

    def __init__(self, map_obj, mesh: ShardMesh, kind: str = "occupancy",
                 capacity: int = 256, scatter_pad: int = 1 << 20, validate: bool = False,
                 ndt_params=None, tsdf_options=None):
        """The reference's parameters in its order and with its defaults
        (ohm_tpu/parallel/mapper.py:257-259).  ``scatter_pad`` is stored
        (``self.scatter_pad``) and bounds nothing the port allocates: the
        reference's shards keep a scratch tail of that length, the port's
        have none."""
        if kind not in ("occupancy", "ndt", "tsdf"):
            raise ValueError(f"unknown sharded mapper kind {kind!r}")
        self.map = map_obj
        self.mesh = mesh
        self.kind = kind
        self.validate = validate
        dims = map_obj.region_voxel_dims
        if not (dims[0] == dims[1] == dims[2]) or (dims[0] & (dims[0] - 1)) != 0:
            raise ValueError("sharded mapper requires cubic power-of-two region dims")
        self.region_shift = int(dims[0]).bit_length() - 1
        region_edge = float(dims[0]) * map_obj.resolution
        self.segment_length = region_edge * 0.999
        self.max_steps = max_steps_for(self.segment_length, map_obj.resolution)

        self.with_mean = self.with_traversal = False
        self.with_touch = self.with_incident = False
        if kind == "occupancy":
            layer_names = ["occupancy"]
            self.with_mean = map_obj.layer_index(MEAN_LAYER) >= 0
            self.with_traversal = map_obj.layer_index(TRAVERSAL_LAYER) >= 0
            self.with_touch = map_obj.layer_index(TOUCH_TIME_LAYER) >= 0
            self.with_incident = map_obj.layer_index(INCIDENT_NORMAL_LAYER) >= 0
            if self.with_mean:
                layer_names += ["mean_coord", "mean_count"]
            if self.with_traversal:
                layer_names.append("traversal")
            if self.with_touch:
                layer_names.append("touch_time")
            if self.with_incident:
                layer_names.append("incident")
        elif kind == "ndt":
            from ohm_tpu_torch.core.probability import value_to_probability
            from ohm_tpu_torch.oracle.ndt import (NdtParams,
                                                  ndt_adaptation_rate_from_miss_probability)

            self.ndt_params = ndt_params or NdtParams()
            if self.ndt_params.adaptation_rate <= 0:
                miss_p = float(value_to_probability(map_obj.miss_value))
                self.ndt_params.adaptation_rate = (
                    ndt_adaptation_rate_from_miss_probability(miss_p))
            map_obj.layout.add_occupancy()
            map_obj.layout.add_mean()
            map_obj.layout.add_covariance()
            self.with_mean = True
            layer_names = ["occupancy", "mean_coord", "mean_count", "cov"]
            if self.ndt_params.ndt_tm:
                map_obj.layout.add_intensity()
                map_obj.layout.add_hit_miss_count()
                layer_names += ["intensity", "hit_count", "miss_count"]
        else:  # tsdf
            from ohm_tpu_torch.oracle.tsdf import TsdfOptions

            self.tsdf_options = tsdf_options or TsdfOptions()
            map_obj.layout.add_tsdf()
            layer_names = ["occupancy", "tsdf_weight", "tsdf_distance"]

        self.scatter_pad = int(scatter_pad)
        self.arena = ResidentShardedArena(
            mesh, capacity, self.region_shift, layer_names, scatter_pad=scatter_pad,
            occupancy_encoding="zero" if kind == "occupancy" else "inf")
        self._stats = {"rays": 0, "segments": 0, "batches": 0,
                       "missed_updates": 0, "overflow": 0, "routed_records": 0}
        self._pending = []

    # ------------------------------------------------------------------ #

    def _base_config(self, ray_flags: int) -> IntegrateConfig:
        m = self.map
        return IntegrateConfig(
            resolution=float(m.resolution),
            region_shift=self.region_shift,
            capacity=self.arena.capacity,
            max_steps=self.max_steps,
            ray_flags=int(ray_flags),
            with_mean=self.with_mean,
            with_traversal=self.with_traversal,
            with_touch_time=self.with_touch,
            with_incident=self.with_incident,
            hit_value=float(np.float32(m.hit_value)),
            miss_value=float(np.float32(m.miss_value)),
            occupancy_threshold=float(np.float32(m.occupancy_threshold_value)),
            min_value=float(np.float32(m.min_voxel_value)),
            max_value=float(np.float32(m.max_voxel_value)),
            saturation_min=float(np.float32(m.saturation_min)),
            saturation_max=float(np.float32(m.saturation_max)),
            wire_tsdf=self.kind == "tsdf",
        )

    def _config_and_core(self, ray_flags: int):
        base = self._base_config(ray_flags)
        if self.kind == "occupancy":
            return base, integrate_decoded, self.OCC_STATS
        if self.kind == "ndt":
            p = self.ndt_params
            cfg = NdtConfig(
                base=base,
                sensor_noise=float(p.sensor_noise),
                sample_threshold=int(p.sample_threshold),
                adaptation_rate=float(p.adaptation_rate),
                reinit_threshold=float(np.float32(p.reinitialise_covariance_threshold)),
                reinit_count=int(p.reinitialise_covariance_point_count),
                initial_intensity_covariance=float(p.initial_intensity_covariance),
                ndt_tm=bool(p.ndt_tm),
            )
            return cfg, integrate_ndt, self.AUX_STATS
        o = self.tsdf_options
        cfg = TsdfConfig(
            base=base,
            max_weight=float(o.max_weight),
            default_truncation_distance=float(o.default_truncation_distance),
            dropoff_epsilon=float(o.dropoff_epsilon),
            sparsity_compensation_factor=float(o.sparsity_compensation_factor),
        )
        return cfg, integrate_tsdf, self.AUX_STATS

    def integrate_rays(self, rays, intensities=None, timestamps=None,
                       ray_update_flags: int = 0) -> int:
        m = self.map
        m.touch()
        prepared = prepare_ray_batch(
            m, rays, timestamps=timestamps, intensities=intensities,
            ray_update_flags=ray_update_flags, segment_length=self.segment_length)
        n_rays = np.asarray(rays).reshape(-1, 3).shape[0] // 2
        if prepared.n_segments == 0:
            return n_rays

        self.arena.ensure_regions(prepared.region_keys, host_map=m)
        batches, counts = make_routed_batch(prepared, self.arena, self.mesh,
                                            with_intensity=self.kind == "ndt")
        cfg, core, stats_keys = self._config_and_core(ray_update_flags)
        stats = build_routed_step(self.mesh, cfg, core, stats_keys)(self.arena.layers, batches)

        self._stats["rays"] += n_rays
        self._stats["segments"] += prepared.n_segments
        self._stats["batches"] += 1
        self._stats["routed_records"] += int(counts.sum())
        self._pending.append(stats)
        if self.validate:
            self._drain()
        return n_rays

    def _drain(self):
        for stats in self._pending:
            # Sharded: records in other shards' regions miss by design.
            self._stats["overflow"] += int(stats["overflow"].sum())
            if self.validate and "applied_updates" in stats:
                # Every active record applies on exactly one shard; without
                # an unrouted reference run, hold the necessary condition:
                # some records applied.
                if int(stats["applied_updates"].sum()) <= 0:
                    raise RuntimeError("a validated sharded batch applied no record")
        self._pending.clear()

    def sync_voxels(self):
        self._drain()
        self.arena.sync_to_host(self.map, stamp=self.map.stamp)

    @property
    def stats(self) -> dict:
        self._drain()
        return dict(self._stats)
