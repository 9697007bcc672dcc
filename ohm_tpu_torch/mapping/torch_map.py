"""TorchRayMapper: the occupancy ray integrator on PyTorch (CUDA or CPU).

Counterpart of ``TpuRayMapper`` (``ohm_tpu/mapping/tpu_map.py``) on its
rayflow wire, for the occupancy layer and any of the side layers voxel
mean, traversal, touch time and incident normal.  Per batch:

  host prep      mapping.batch.prepare_rayflow / rayflow_wire (native C++)
  allocation     mapping.arena.VoxelArena.ensure_regions (LRU, host spill)
  upload         the wire, one uint8 tensor
  decode         ops.wire.unpack_batch
  expand         ops.integrate.expand_records (kernel K1)
  sort + apply   ops.integrate.apply_records (torch.sort, kernel K2, the
                 traversal sums)
  samples        ops.integrate.apply_sample_layers (mean, touch, incident)
  sync           sync_voxels -> host OccupancyMap chunks

On a CUDA device the two kernels run; with ``device="cpu"`` their plain
PyTorch versions do, with bit-identical results.  The host map is the
port's own (``ohm_tpu_torch.core.map.OccupancyMap``).
``integrate_rays_async`` queues batches for one worker thread, in order;
``flush``, ``sync_voxels`` and ``stats`` wait for it and raise what it
raised.  Not ported yet (each raises NotImplementedError):
STOP_ON_FIRST_OCCUPIED and batches outside the rayflow envelope (the
reference's segmented wire).  The TPU levers (fused, delta, chained and
monolith dispatch, coalesced transfers, scatter windows) are not ported.

Subclasses (mapping.ndt_map.TorchNdtMap, mapping.tsdf_map.TorchTsdfMap)
override the hooks: the layer
check ``_check_layers``, the arena's layers ``_arena_layers``, the wire's
intensity block ``_rayflow_intensity``, the device step
``_integrate_device`` under ``_dispatch``, and the stats ``_STAT_NAMES``
summed by ``_drain_stats``.
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from ohm_tpu_torch.core.layout import (INCIDENT_NORMAL_LAYER, MEAN_LAYER, OCCUPANCY_LAYER,
                                       TOUCH_TIME_LAYER, TRAVERSAL_LAYER)
from ohm_tpu_torch.core.rayflags import RayFlag, normalize_reverse_walk
from ohm_tpu_torch.device import resolve_device
from ohm_tpu_torch.mapping.arena import CacheFull, VoxelArena
from ohm_tpu_torch.mapping.batch import (
    frac_dict_of, prepare_rayflow, rayflow_wire, snake_perm)
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.integrate import apply_records, apply_sample_layers, expand_records
from ohm_tpu_torch.ops.wire import unpack_batch

#: The side layers the occupancy mapper integrates.
SIDE_LAYERS = (MEAN_LAYER, TRAVERSAL_LAYER, TOUCH_TIME_LAYER, INCIDENT_NORMAL_LAYER)

#: Candidate entries pack (slot + 1) << 18 into an int32, so slot + 1 must
#: stay below 2^13 or the sign bit sets and a valid match is rejected.
MAX_CAPACITY = 8191


class TorchRayMapper:
    """Occupancy ray integrator over a device voxel arena."""

    #: The wire carries a per-ray intensity block.
    _rayflow_intensity = False
    #: Per-batch device stats summed into ``stats`` by _drain_stats.
    _STAT_NAMES = ("missed_updates", "overflow", "compaction_dropped")

    def __init__(self, map_obj, capacity: int = 1024, validate: bool = False,
                 stream_budget: int = 1 << 21, device="cuda"):
        self.device = resolve_device(device)
        self.map = map_obj
        #: A batch whose estimated record stream (total wall crossings)
        #: exceeds this is split in half before prep (_integrate_with_retry);
        #: 0 disables.
        self.stream_budget = int(stream_budget)
        dims = map_obj.region_voxel_dims
        if not (dims[0] == dims[1] == dims[2]) or (dims[0] & (dims[0] - 1)) != 0:
            raise ValueError("the mapper requires cubic power-of-two region dims (e.g. 32)")
        self.region_shift = int(dims[0]).bit_length() - 1
        self.validate = validate

        self._check_layers(map_obj)
        # The side layers the map holds, as the reference's config carries
        # them; the NDT and TSDF mappers integrate none of them.
        (self.with_mean, self.with_traversal, self.with_touch,
         self.with_incident) = (map_obj.layer_index(name) >= 0 for name in SIDE_LAYERS)
        if capacity > MAX_CAPACITY:
            raise ValueError(
                f"capacity {capacity} > {MAX_CAPACITY} needs the segmented "
                f"wire, which is not ported yet")
        names, encoding = self._arena_layers()
        self.arena = VoxelArena(capacity, self.region_shift, self.device, names, encoding)
        self._config(0)  # validate int32 addressing headroom at construction
        # Monotone shape caches (step bucket, walk cap, group cap, K):
        # grow only, as the reference's compile-shape caches do.
        self._k_cache_rf = 4
        self._steps_cache_rf = 0
        self._wcap_cache_rf = 0
        self._cap_cache_rf = 0
        self._stats = {"rays": 0, "segments": 0, "batches": 0, "missed_updates": 0,
                       "overflow": 0, "dropped_updates": 0, "compaction_dropped": 0}
        self._stats.update({k: 0 for k in self._STAT_NAMES})
        self._pending_stats = []
        self._queue = None
        self._worker = None
        self._worker_error = None

    def _check_layers(self, map_obj) -> None:
        """Raise for map layers this mapper does not integrate."""
        others = [layer.name for layer in map_obj.layout.layers
                  if layer.name not in (OCCUPANCY_LAYER, *SIDE_LAYERS)]
        if others:
            raise NotImplementedError(
                f"map layers other than occupancy, mean, traversal, touch time "
                f"and incident normal are not ported yet: {others}")

    def _arena_layers(self) -> tuple[list[str], str]:
        """The arena's layers and its occupancy encoding."""
        names = ["occupancy"]
        if self.with_mean:
            names += ["mean_coord", "mean_count"]
        if self.with_traversal:
            names.append("traversal")
        if self.with_touch:
            names.append("touch_time")
        if self.with_incident:
            names.append("incident")
        return names, "zero"

    def prime_caps(self, batches) -> None:
        """Host-only pass seeding the monotone shape caches (group cap, step
        bucket, walk cap, candidate-table K) to their maxima over
        ``batches``, so every batch of a run sees the same shapes."""
        for rays in self._presplit_all(batches):
            rf = prepare_rayflow(self.map, rays)
            if rf is None:
                continue
            self._k_cache_rf = max(self._k_cache_rf, rf.table_k)
            steps = -(-(rf.max_axis_steps + 1) // 32) * 32
            self._steps_cache_rf = max(self._steps_cache_rf, steps)
            wcap = -(-(int(rf.crossings.max()) + 2) // 64) * 64 if rf.n_rays else 64
            self._wcap_cache_rf = max(self._wcap_cache_rf, wcap)
            G, snake = self._rayflow_grouping(rf.rpad)
            cap = self._rayflow_group_cap(rf.crossings, G, snake)
            self._cap_cache_rf = max(self._cap_cache_rf, cap)

    @staticmethod
    def _rayflow_grouping(rpad: int) -> tuple[int, bool]:
        """Strided group size G (64; 8 when rpad does not divide) and the
        snake-ordering flag, shared by prime_caps and the batch setup."""
        G = 64 if rpad % 64 == 0 else 8
        return G, rpad % G == 0

    @staticmethod
    def _rayflow_group_cap(crossings, G: int, snake: bool, perm=None) -> int:
        """Quantised per-group record cap for the strided compaction: the
        maximum group sum of crossings plus margin (2% + 256-quantised under
        snake ordering, ~6% + 512 otherwise)."""
        if len(crossings) % G:
            return 0
        if snake and perm is None:
            perm = snake_perm(crossings, G)
        cr = crossings[perm] if snake else crossings
        gmax = int(cr.reshape(G, -1).sum(axis=0).max())
        if not gmax:
            return 0
        if snake:
            return max(512, -(-(gmax + max(128, gmax >> 6)) // 256) * 256)
        return max(512, -(-(gmax + max(256, gmax >> 4)) // 512) * 512)

    def _rayflow_setup_host(self, rays, timestamps, intensities, ray_update_flags):
        """Host half of a batch: allocate its regions and build its wire.
        Returns (numpy uint8 wire, cfg, n_rays)."""
        rf = prepare_rayflow(self.map, rays, timestamps=timestamps,
                             intensities=intensities,
                             ray_update_flags=ray_update_flags,
                             min_table_k=self._k_cache_rf)
        if rf is None:
            raise NotImplementedError(
                "batch outside the rayflow envelope (more than 65535 rays, a "
                "ray over 32 regions or a region bbox over 63): the segmented "
                "wire is not ported yet")
        self._k_cache_rf = max(self._k_cache_rf, rf.table_k)
        self.arena.ensure_regions(rf.region_keys, host_map=self.map)
        # Candidate dictionary: u8 indices for <= 255 regions, u16 for
        # <= 2047, else full i32 candidates.
        nreg = len(rf.region_keys)
        cdict = 1 if nreg <= 255 else (2 if nreg <= 2047 else 0)
        steps = -(-(rf.max_axis_steps + 1) // 32) * 32
        self._steps_cache_rf = max(self._steps_cache_rf, steps)
        wcap = -(-(int(rf.crossings.max()) + 2) // 64) * 64 if rf.n_rays else 64
        self._wcap_cache_rf = max(self._wcap_cache_rf, wcap)
        G, snake = self._rayflow_grouping(rf.rpad)
        perm = snake_perm(rf.crossings, G) if snake else None
        fdict = frac_dict_of(rf)
        wire = rayflow_wire(rf, self.arena.table, with_touch=self.with_touch,
                            with_intensity=self._rayflow_intensity, cdict=cdict,
                            fdict=fdict, perm=perm)
        cap = self._rayflow_group_cap(rf.crossings, G, snake, perm=perm)
        self._cap_cache_rf = max(self._cap_cache_rf, cap)
        cfg = self._config(ray_update_flags, group_cap=self._cap_cache_rf,
                           max_steps=self._steps_cache_rf, group_size=G,
                           table_k=rf.table_k, walk_cap=self._wcap_cache_rf,
                           rayw_cdict=cdict, rayw_fdict=fdict is not None)
        return wire, cfg, rf.n_rays

    def _config(self, ray_flags: int, group_cap: int = 0,
                max_steps: int = 0, group_size: int = 64,
                table_k: int = 0, walk_cap: int = 0, rayw_cdict: int = 0,
                rayw_fdict: bool = False) -> IntegrateConfig:
        m = self.map
        return IntegrateConfig(
            resolution=float(m.resolution),
            region_shift=self.region_shift,
            capacity=self.arena.capacity,
            max_steps=max_steps,
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
            group_cap=group_cap,
            group_size=group_size,
            table_k=table_k,
            walk_cap=walk_cap,
            rayw_cdict=rayw_cdict,
            rayw_fdict=rayw_fdict,
            rayw_intensity=self._rayflow_intensity,
        )

    def integrate_rays(self, rays, intensities=None, timestamps=None,
                       ray_update_flags: int = 0) -> int:
        """Integrate interleaved origin/sample rays (2N, 3). Returns N.

        A batch whose region demand exceeds the arena capacity is split in
        half and retried (the reference's cache-full flush-and-retry,
        ohmgpu/GpuMap.cpp:922-1017)."""
        ray_update_flags = normalize_reverse_walk(ray_update_flags)
        if ray_update_flags & RayFlag.STOP_ON_FIRST_OCCUPIED:
            raise NotImplementedError("STOP_ON_FIRST_OCCUPIED is not ported yet")
        return self._integrate_with_retry(rays, intensities, timestamps, ray_update_flags)

    def integrate_rays_async(self, rays, intensities=None, timestamps=None,
                             ray_update_flags: int = 0) -> int:
        """Queue a ray batch for the worker thread; returns its ray count N.

        One worker integrates the queued batches in order, each as
        integrate_rays would, so host prep of a batch overlaps the device
        work of the one before.  ``flush`` (and ``sync_voxels``, ``stats``)
        waits for the queue and raises the first error the worker met."""
        ray_update_flags = normalize_reverse_walk(ray_update_flags)
        if ray_update_flags & RayFlag.STOP_ON_FIRST_OCCUPIED:
            raise NotImplementedError("STOP_ON_FIRST_OCCUPIED is not ported yet")
        if self._worker is None:
            self._queue = queue.Queue(maxsize=4)
            self._worker = threading.Thread(target=self._work, daemon=True)
            self._worker.start()
        self._queue.put((rays, intensities, timestamps, ray_update_flags))
        return np.asarray(rays).reshape(-1, 3).shape[0] // 2

    def _work(self) -> None:
        """The worker: integrate queued batches in order, for the mapper's life.

        The current device is per thread, so the worker enters the mapper's
        own.  It launches on that device's current stream, the same one the
        caller's thread uses, so a region the worker evicts (a .cpu()
        download) is read after the previous batch's kernels wrote it."""
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            while True:
                item = self._queue.get()
                try:
                    self._integrate_with_retry(*item)
                except Exception as e:  # raised again by flush
                    if self._worker_error is None:
                        self._worker_error = e
                finally:
                    self._queue.task_done()

    def flush(self) -> None:
        """Wait until the worker has integrated every queued batch; raise the
        first error it met since the last flush."""
        if self._worker is not None:
            self._queue.join()
            if self._worker_error is not None:
                err, self._worker_error = self._worker_error, None
                raise err

    def _stream_estimate(self, r: np.ndarray) -> int:
        """Record-stream estimate of a batch: total wall crossings + 3/ray."""
        n = r.shape[0] // 2
        return int(np.abs(r[1::2] - r[0::2]).sum() / self.map.resolution) + 3 * n

    def _presplit_all(self, batches):
        """Apply the stream-budget split rule to a batch list (host-only) so
        cap priming sees the shapes the run will dispatch."""
        out = []
        stack = [np.asarray(b, dtype=np.float64).reshape(-1, 3) for b in batches]
        stack.reverse()
        while stack:
            r = stack.pop()
            n = r.shape[0] // 2
            if self.stream_budget and n > 256 and self._stream_estimate(r) > self.stream_budget:
                h = n // 2
                stack.append(r[2 * h:])
                stack.append(r[: 2 * h])
                continue
            out.append(r)
        return out

    def _split_and_integrate(self, rays, intensities, timestamps, ray_update_flags) -> int:
        """Integrate a batch as two half-batches (recursively)."""
        r = np.asarray(rays, dtype=np.float64).reshape(-1, 3)
        n = r.shape[0] // 2
        h = n // 2

        def part(x, a, b):
            if x is None:
                return None
            x = np.asarray(x).reshape(-1)
            return x[a:b] if x.size == n else None

        total = self._integrate_with_retry(
            r[: 2 * h], part(intensities, 0, h), part(timestamps, 0, h),
            ray_update_flags)
        total += self._integrate_with_retry(
            r[2 * h:], part(intensities, h, n), part(timestamps, h, n),
            ray_update_flags)
        return total

    def _integrate_with_retry(self, rays, intensities, timestamps, ray_update_flags) -> int:
        r = np.asarray(rays, dtype=np.float64).reshape(-1, 3)
        n = r.shape[0] // 2
        if self.stream_budget and n > 256 and self._stream_estimate(r) > self.stream_budget:
            return self._split_and_integrate(r, intensities, timestamps, ray_update_flags)
        try:
            return self._integrate_batch(r, intensities, timestamps, ray_update_flags)
        except CacheFull:
            if n <= 1:
                raise
            return self._split_and_integrate(r, intensities, timestamps, ray_update_flags)

    def _integrate_batch(self, rays, intensities, timestamps, ray_update_flags) -> int:
        self.map.touch()
        wire, cfg, n_rays = self._rayflow_setup_host(
            rays, timestamps, intensities, ray_update_flags)
        return self._dispatch(torch.from_numpy(wire).to(self.device), cfg, n_rays)

    def _dispatch(self, wire: torch.Tensor, cfg: IntegrateConfig, n_rays: int) -> int:
        """Decode a wire already on the device and integrate it; the arena
        updates in place and the stats stay on the device until read."""
        stats = self._integrate_device(unpack_batch(wire, cfg), cfg)
        self._stats["rays"] += n_rays
        self._stats["segments"] += n_rays
        self._stats["batches"] += 1
        self._pending_stats.append(stats)
        if self.validate:
            self._drain_stats()
            for name, what in (("missed_updates", "slot resolution missed: host allocation bug"),
                               ("overflow", "walk step cap exceeded: step bucket bug"),
                               ("compaction_dropped", "group compaction dropped live records: group cap bug"),
                               ("dropped_updates", "the deposit dropped voxel updates")):
                if self._stats[name]:
                    raise RuntimeError(f"{name}={self._stats[name]}: {what}")
        return n_rays

    def _integrate_device(self, b: dict, cfg: IntegrateConfig) -> dict:
        """Expand + sort + deposit of one decoded batch, then the sample
        layers; returns its stats."""
        records, stats = expand_records(b, cfg)
        layers = self.arena.layers
        stats["touched"] = apply_records(layers["occupancy"], records, cfg,
                                         traversal=layers.get("traversal"))
        if cfg.with_mean or cfg.with_touch_time or cfg.with_incident:
            apply_sample_layers(layers, records, b, cfg)
        return stats

    def _drain_stats(self) -> list[dict]:
        """Read the pending batches' stats back and sum _STAT_NAMES into
        ``stats``.  Returns the drained per-batch values (ints)."""
        drained = [{k: int(stats[k]) for k in self._STAT_NAMES}
                   for stats in self._pending_stats]
        for stats in drained:
            for k, v in stats.items():
                self._stats[k] += v
        self._pending_stats.clear()
        return drained

    def sync_voxels(self):
        """Flush device voxel state into the host OccupancyMap (GpuMap::syncVoxels)."""
        self.flush()
        self._drain_stats()
        self.arena.sync_to_host(self.map, stamp=self.map.stamp)

    @property
    def stats(self) -> dict:
        self.flush()
        self._drain_stats()
        return dict(self._stats)
