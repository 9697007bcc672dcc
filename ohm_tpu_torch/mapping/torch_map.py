"""TorchRayMapper: the occupancy ray integrator on PyTorch (CUDA or CPU).

Counterpart of ``TpuRayMapper`` (``ohm_tpu/mapping/tpu_map.py``) for the
occupancy layer and any of the side layers voxel mean, traversal, touch
time and incident normal; any other layer of the map stays as the host map
holds it, as the reference leaves it.  A batch takes the rayflow wire
(per-ray records) unless the flags include STOP_ON_FIRST_OCCUPIED, the
arena holds more than 8191 regions, or the batch leaves the rayflow
envelope (more than 65535 rays, a ray over 32 regions, a region bbox over
63); then it takes the segmented wire (per-segment records, each segment at
most one region edge long), as the reference does.  Per batch:

  host prep      rayflow: mapping.batch.prepare_rayflow / rayflow_wire;
                 segmented: prepare_ray_batch / fill_corner_slots /
                 build_wire (each one native C++ pass)
  allocation     mapping.arena.VoxelArena.ensure_regions (LRU, host spill)
  upload         the wire, one uint8 tensor (segmented at capacity 32767 or
                 more, or region dims over 32: the full per-segment blocks)
  decode         ops.wire.decode
  expand         ops.integrate.expand_records (the walk front end: kernel K1
                 on the rayflow wire, the plain walk on the segmented one)
  sort + apply   ops.integrate.apply_records (torch.sort, kernel K2, the
                 traversal sums), or apply_records_fused, or apply_delta
  samples        ops.integrate.apply_sample_layers (mean, touch, incident)
  sync           sync_voxels -> host OccupancyMap chunks

Each batch takes the route the reference's _dispatch gives it
(tpu_map.py:570-624, _integrate_device): the monolith
(ops.integrate.integrate_occupancy: the ordered walk, the stop masks, K2)
under STOP_ON_FIRST_OCCUPIED or OHM_MONOLITH=1; the delta path where
``delta_path`` is set and the batch is eligible; the fused row-local apply
where OHM_FUSED allows it and the sized ``row_cap`` compacts the rows; else
the split apply.  On a CUDA device the kernels run; with ``device="cpu"``
their plain PyTorch versions do, with bit-identical results.  The host map
is the port's own (``ohm_tpu_torch.core.map.OccupancyMap``).
``integrate_rays_async`` queues batches for one worker thread, in order; it
takes up to OHM_COALESCE queued batches at once, uploads their wires in one
copy and runs a full, sized group as one chain (OHM_CHAIN);
``flush``, ``sync_voxels`` and ``stats`` wait for it and raise what it
raised.  On a card the worker replays a group's device work from a CUDA
graph where it can (``mapping.graphs``; ``_graph_key`` says where): the
same kernels in the same order, issued in one launch instead of hundreds.

Each batch the mapper takes gets a sequence number, and the process-wide
span recorder (``utils.profile.Profile.instance()``), on while a
torch.profiler session runs on the caller's thread, records the worker's
spans under it: ``worker.wait`` (blocked on the empty queue),
``worker.group`` (one ``_integrate_group``), ``worker.prep`` (a batch's host
half), ``worker.upload`` (on a card with its ``worker.copy``: the issue of
the pinned copy, which ties the device trace's copies to the host's clock),
``worker.dispatch`` (decode to the last launch of a batch or chain, or a
group's replay, with its ``graph.replay`` span, counted in
``graph_replays``), ``worker.capture`` (a group's capture, counted in
``graph_captures``; a capture that raised counts in ``graph_fallbacks``),
and a ``sync`` span, counted in ``host_syncs``, around every blocking
device read or copy.

Subclasses (mapping.ndt_map.TorchNdtMap, mapping.tsdf_map.TorchTsdfMap)
override the hooks: the arena's layers ``_arena_layers``, the wire's
intensity block ``_rayflow_intensity``, whether STOP_ON_FIRST_OCCUPIED
leaves the rayflow wire ``_stop_needs_segments``, the segmented config
``_segmented_config``, the device step ``_integrate_device`` under
``_dispatch``, the route its host logic picks (``_route``, which the
graph key holds too), what it may still read back (``_sizing_pending``)
and what every graph is made under (``_graph_epoch``), and the stats
``_STAT_NAMES`` summed by ``_drain_stats``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import queue
import threading

import numpy as np
import torch

from ohm_tpu_torch.core.layout import (INCIDENT_NORMAL_LAYER, MEAN_LAYER, TOUCH_TIME_LAYER,
                                       TRAVERSAL_LAYER)
from ohm_tpu_torch.core.rayflags import RayFlag, normalize_reverse_walk
from ohm_tpu_torch.device import resolve_device
from ohm_tpu_torch.mapping.arena import CacheFull, NeedsEviction, VoxelArena
from ohm_tpu_torch.mapping.batch import (
    build_wire, fill_corner_slots, frac_dict_of, max_steps_for, prepare_ray_batch,
    prepare_rayflow, rayflow_wire, snake_perm)
from ohm_tpu_torch.mapping.graphs import CAPTURE, EAGER, CudaCapture, GraphCache
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.ddawalk import walk_total_cap
from ohm_tpu_torch.ops.integrate import (apply_decoded, delta_path_ok, expand_records,
                                         integrate_chain, integrate_delta, integrate_occupancy)
from ohm_tpu_torch.ops.wire import decode
from ohm_tpu_torch.utils.profile import Profile

_PROFILE = Profile.instance()

#: The side layers the occupancy mapper integrates.
SIDE_LAYERS = (MEAN_LAYER, TRAVERSAL_LAYER, TOUCH_TIME_LAYER, INCIDENT_NORMAL_LAYER)

#: The largest arena the rayflow wire addresses: candidate entries pack
#: (slot + 1) << 18 into an int32, so slot + 1 must stay below 2^13 or the
#: sign bit sets and a valid match is rejected.  Larger arenas take the
#: segmented wire.
RAYFLOW_MAX_CAPACITY = 8191
#: The segmented wire ships int16 corner slots below this capacity (and
#: region dims up to 32), the full int32 blocks from it on.
COMPACT_MAX_CAPACITY = 32767


def _int64(v, device) -> torch.Tensor:
    """A stat (a 0-dim device tensor, or a host int) as an int64 0-dim
    tensor on ``device``, with no host-to-device copy."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64)
    return torch.full((), int(v), dtype=torch.int64, device=device)


class TorchRayMapper:
    """Occupancy ray integrator over a device voxel arena."""

    #: The wire carries a per-ray intensity block (the segmented batch a
    #: per-segment intensity array).
    _rayflow_intensity = False
    #: STOP_ON_FIRST_OCCUPIED sends a batch to the segmented wire (the
    #: occupancy mapper's monolith); the NDT and TSDF mappers take the
    #: rayflow wire under it, as the reference's do.
    _stop_needs_segments = True
    #: Per-batch device stats summed into ``stats`` by _drain_stats.
    _STAT_NAMES = ("missed_updates", "overflow", "compaction_dropped", "dropped_updates")
    #: What ``validate`` says when a batch dropped voxel updates.
    _DROPPED_WHAT = ("scatter_cap exceeded (the delta window or the fused row window): "
                     "raise TorchRayMapper(scatter_cap=...)")

    def __init__(self, map_obj, capacity: int = 1024, segment_length: float | None = None,
                 validate: bool = False, scatter_pad: int = 1 << 22,
                 scatter_cap: int | str = "auto", rayflow: bool | None = None,
                 delta_path: bool = False, stream_budget: int | None = None,
                 device="cuda"):
        """The reference's parameters in its order and with its defaults
        (tpu_map.py:58-69), then ``device``.  ``rayflow=None`` reads
        OHM_RAYFLOW ("0" sends every batch to the segmented wire, else the
        rayflow wire where a batch allows it); ``stream_budget=None`` reads
        OHM_STREAM_BUDGET (default 1 << 21).  The reference's OHM_PALLAS and
        OHM_EXPAND are not read: on a CUDA device the kernels run, and their
        plain versions (its "0") run only on the CPU, which is also what its
        interpret mode ("2") is."""
        self.device = resolve_device(device)
        self.map = map_obj
        #: Take the rayflow wire where a batch allows it; False sends every
        #: batch to the segmented wire.
        if rayflow is None:
            rayflow = os.environ.get("OHM_RAYFLOW", "1") != "0"
        self.rayflow = bool(rayflow)
        #: A batch whose estimated record stream (total wall crossings)
        #: exceeds this is split in half before prep (_integrate_with_retry);
        #: 0 disables.
        if stream_budget is None:
            stream_budget = int(os.environ.get("OHM_STREAM_BUDGET", 1 << 21))
        self.stream_budget = int(stream_budget)
        dims = map_obj.region_voxel_dims
        if not (dims[0] == dims[1] == dims[2]) or (dims[0] & (dims[0] - 1)) != 0:
            raise ValueError("the mapper requires cubic power-of-two region dims (e.g. 32)")
        self.region_shift = int(dims[0]).bit_length() - 1
        self.validate = validate
        # The segmented wire cuts rays into segments of at most one region
        # edge (the 2x2x2 corner-slot contract), each walked to max_steps
        # crossings an axis.
        region_edge = float(dims[0]) * map_obj.resolution
        self.segment_length = min(segment_length or region_edge * 0.999, region_edge * 0.999)
        self.max_steps = max_steps_for(self.segment_length, map_obj.resolution)

        # The side layers the map holds, as the reference's config carries
        # them (the TSDF mapper integrates none of them); every other layer
        # stays as the host map holds it.
        (self.with_mean, self.with_traversal, self.with_touch,
         self.with_incident) = (map_obj.layer_index(name) >= 0 for name in SIDE_LAYERS)
        names, encoding = self._arena_layers()
        self.arena = VoxelArena(capacity, self.region_shift, self.device, names, encoding)
        #: The reference's scratch-tail length: it bounds the delta window
        #: and the fused merge stream (the port's arena has no tail).
        self.scatter_pad = int(scatter_pad)
        #: The delta path's window of touched voxels a batch.  "auto": the
        #: fourth batch's touched count read back once, 2x headroom, a
        #: power of two, grown only (_auto_size_scatter_cap); an int pins
        #: it, 0 disables.  ``delta_path`` routes eligible batches
        #: (ops.integrate.delta_path_ok) to apply_delta within it.
        self._auto_scatter = scatter_cap == "auto"
        self.scatter_cap = 0 if self._auto_scatter else int(scatter_cap)
        self._cap_rays = 0
        self.delta_path = bool(delta_path)
        #: OHM_FUSED: "1" (default) routes a batch to the fused row-local
        #: apply once ``row_cap`` is sized and its rows compact
        #: (_fused_row_cap_for), "2" also where they do not, "0" never.
        fused_env = os.environ.get("OHM_FUSED", "1")
        self.fused = fused_env != "0"
        self._fused_force = fused_env == "2"
        self.row_cap = 0
        self._row_cap_rays = 0
        #: OHM_MONOLITH=1 sends every batch through the monolith
        #: (ops.integrate.integrate_occupancy); OHM_CHAIN=0 turns off the
        #: worker's chained groups; OHM_COALESCE batches (4) share one
        #: upload in the worker.
        self.monolith = os.environ.get("OHM_MONOLITH", "0") == "1"
        self.chain = os.environ.get("OHM_CHAIN", "1") != "0"
        self._coalesce = int(os.environ.get("OHM_COALESCE", "4"))
        #: The route the last batch took: "monolith", "delta", "fused",
        #: "split" (NDT: "fused", "k3"; TSDF: "tsdf"); "chain_fused" or
        #: "chain_split" for a chained group.
        self.last_route = None
        self._config(0)  # validate int32 addressing headroom at construction
        # Monotone shape caches (step bucket, walk cap, group cap, K):
        # grow only, as the reference's compile-shape caches do.
        self._k_cache_rf = 4
        self._steps_cache_rf = 0
        self._wcap_cache_rf = 0
        self._cap_cache_rf = 0
        self._cap_cache = 0  # the segmented wire's group cap
        self._stats = {"rays": 0, "segments": 0, "batches": 0, "missed_updates": 0,
                       "overflow": 0, "dropped_updates": 0, "compaction_dropped": 0}
        self._stats.update({k: 0 for k in self._STAT_NAMES})
        self._pending_stats = []
        self._queue = None
        self._worker = None
        self._worker_error = None
        self._staged = []  # pinned upload buffers with the event of their copy
        self._batches_taken = 0  # sequence numbers given to batches
        #: The worker's captured CUDA graphs (mapping.graphs), on a card only.
        self.graphs = (GraphCache(CudaCapture(self.device)) if self.device.type == "cuda"
                       else None)

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
        """Strided group size G (OHM_RAYFLOW_G, default 64; 8 when rpad does
        not divide) and the snake-ordering flag (OHM_SNAKE, default on; off
        where G does not divide rpad), shared by prime_caps and the batch
        setup (tpu_map.py:236-245)."""
        G = int(os.environ.get("OHM_RAYFLOW_G", 64))
        if rpad % G:
            G = 8
        snake = os.environ.get("OHM_SNAKE", "1") != "0" and rpad % G == 0
        return G, snake

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

    def _rayflow_setup_host(self, rays, timestamps, intensities, ray_update_flags,
                            allow_evict: bool = True):
        """Host half of a rayflow batch: allocate its regions and build its
        wire.  Returns (numpy uint8 wire, cfg, n_rays), or None where the
        arena or the batch leaves the rayflow wire.  With ``allow_evict``
        False an allocation that would evict raises NeedsEviction (the
        worker's group holds wires that name slots)."""
        if self.arena.capacity > RAYFLOW_MAX_CAPACITY:
            return None
        rf = prepare_rayflow(self.map, rays, timestamps=timestamps,
                             intensities=intensities,
                             ray_update_flags=ray_update_flags,
                             min_table_k=self._k_cache_rf)
        if rf is None:
            return None
        self._k_cache_rf = max(self._k_cache_rf, rf.table_k)
        self.arena.ensure_regions(rf.region_keys, host_map=self.map, allow_evict=allow_evict)
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

    def _group_cap(self, prepared) -> int:
        """The segmented wire's record cap per 64-segment group (strided,
        ops.integrate.group_rows): the largest group sum of the segments'
        exact crossing counts, +128 and 256-quantised, grown only (the
        reference's compile-shape cache); 0 where it would not cut the
        ordered walk's record axis."""
        G = 64
        ints = prepared.arrays["ints"]
        if len(ints) % G:
            return 0
        crossings = np.abs(ints[:, 3:6] - ints[:, 0:3]).sum(axis=1)
        gmax = int(crossings.reshape(G, -1).sum(axis=0).max())
        self._cap_cache = max(self._cap_cache, max(256, -(-(gmax + 128) // 256) * 256))
        cap = self._cap_cache
        return cap if cap < G * walk_total_cap(self.max_steps) else 0

    def _segmented_config(self, prepared, ray_update_flags) -> IntegrateConfig:
        """The segmented batch's config: no group compaction under
        STOP_ON_FIRST_OCCUPIED (the monolith walks in time order)."""
        stop = ray_update_flags & RayFlag.STOP_ON_FIRST_OCCUPIED
        return self._config(ray_update_flags,
                             group_cap=0 if stop else self._group_cap(prepared))

    def _segmented_setup_host(self, rays, timestamps, intensities, ray_update_flags):
        """Host half of a segmented batch: segment and quantise the rays,
        allocate their regions, resolve the corner slots and pack the
        upload.  Returns (upload: dict of numpy arrays, cfg, n_rays,
        n_segments), or None for a batch with no segment."""
        m = self.map
        prepared = prepare_ray_batch(
            m, rays, timestamps=timestamps, intensities=intensities,
            ray_update_flags=ray_update_flags, segment_length=self.segment_length)
        n_rays = np.asarray(rays).reshape(-1, 3).shape[0] // 2
        if prepared.n_segments == 0:
            return None
        self.arena.ensure_regions(prepared.region_keys, host_map=m)
        fill_corner_slots(prepared, self.arena.table)
        cfg = self._segmented_config(prepared, ray_update_flags)
        dims0 = int(m.region_voxel_dims[0])
        if dims0 <= 32 and self.arena.capacity < COMPACT_MAX_CAPACITY:
            upload = {"wire": build_wire(prepared, dims0, with_mean=cfg.with_mean,
                                         with_tsdf=cfg.wire_tsdf,
                                         with_touch=cfg.with_touch_time)}
        else:
            arrays = prepared.arrays
            upload = {"ints": arrays["ints"], "floats": arrays["floats"],
                      "flags": arrays["flags"], "touch": arrays["touch"].view(np.int32)}
        if self._rayflow_intensity:
            upload["intensity"] = (prepared.intensities if prepared.intensities is not None
                                   else np.zeros(prepared.size, dtype=np.float32))
        return upload, cfg, n_rays, prepared.n_segments

    def _config(self, ray_flags: int, group_cap: int = 0,
                max_steps: int | None = None, group_size: int = 64,
                table_k: int = 0, walk_cap: int = 0, rayw_cdict: int = 0,
                rayw_fdict: bool = False) -> IntegrateConfig:
        """The batch's config; ``max_steps`` None is the segmented wire's."""
        m = self.map
        return IntegrateConfig(
            resolution=float(m.resolution),
            region_shift=self.region_shift,
            capacity=self.arena.capacity,
            max_steps=self.max_steps if max_steps is None else max_steps,
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
            unordered_walk=bool(group_cap) and not (
                int(ray_flags) & RayFlag.STOP_ON_FIRST_OCCUPIED),
            scatter_cap=self.scatter_cap,
            scatter_pad=self.scatter_pad,
        )

    def _auto_size_scatter_cap(self, stats, n_rays) -> None:
        """Size the delta window once from the fourth batch's touched count
        (one read back; 2x headroom, a power of two, at most scatter_pad),
        and again, grown only, for a batch with more rays than the one that
        sized it (tpu_map.py:348-370)."""
        if not self._scatter_cap_unsized(n_rays):
            return
        if self.scatter_cap == 0 and self._stats["batches"] < 3:
            return
        with _PROFILE.sync():
            t = int(stats["touched"])
        cap = 1 << 16
        while cap < 2 * t:
            cap *= 2
        self.scatter_cap = max(self.scatter_cap, min(cap, self.scatter_pad))
        self._cap_rays = n_rays

    def _scatter_cap_unsized(self, n_rays: int) -> bool:
        """Whether _auto_size_scatter_cap may still size the delta window
        for a batch of ``n_rays``."""
        return self._auto_scatter and (self.scatter_cap == 0 or n_rays > self._cap_rays)

    def _row_cap_unsized(self, n_segments: int) -> bool:
        """Whether _auto_size_row_cap may still size row_cap for a batch of
        ``n_segments``."""
        return self.fused and (self.row_cap == 0 or n_segments > 2 * self._row_cap_rays)

    def _fused_row_cap_for(self, n_segments: int, group_cap: int) -> int:
        """The fused apply's row_cap where a batch may take it, else 0
        (tpu_map.py:372-393): OHM_FUSED on, row_cap sized for at least half
        this many segments, at most 16384 segments and a group cap below
        2^16 (the 16-bit packed counts), and the row window compacting the
        rows (row_cap < group_cap) unless OHM_FUSED=2."""
        if (self.fused and self.row_cap > 0 and 0 < n_segments <= 16384
                and n_segments <= 2 * self._row_cap_rays
                and 0 < group_cap < (1 << 16)
                and (self.row_cap < group_cap or self._fused_force)):
            return self.row_cap
        return 0

    def _auto_size_row_cap(self, stats, n_rays) -> None:
        """Size row_cap from the expand's 'row_lasts_max' (tpu_map.py:395-415):
        from the fourth batch, 2x headroom, a power of two (at least 256),
        grown only, and again for a batch with over twice the rays that
        sized it; it reads the stat back on those batches only."""
        if not self._row_cap_unsized(n_rays):
            return
        if self.row_cap == 0 and self._stats["batches"] < 3:
            return
        with _PROFILE.sync():
            m = int(stats.get("row_lasts_max", -1))
        if m < 0:
            return
        cap = 256
        while cap < 2 * m:
            cap *= 2
        self.row_cap = max(self.row_cap, cap)
        self._row_cap_rays = n_rays

    def integrate_rays(self, rays, intensities=None, timestamps=None,
                       ray_update_flags: int = 0) -> int:
        """Integrate interleaved origin/sample rays (2N, 3). Returns N.

        A batch whose region demand exceeds the arena capacity is split in
        half and retried (the reference's cache-full flush-and-retry,
        ohmgpu/GpuMap.cpp:922-1017)."""
        ray_update_flags = normalize_reverse_walk(ray_update_flags)
        _PROFILE.set_batch(self._take_batch())
        return self._integrate_with_retry(rays, intensities, timestamps, ray_update_flags)

    def _take_batch(self, n: int = 1) -> int:
        """The sequence number of the first of ``n`` batches the mapper
        takes now; the span recorder's switch is sampled here, on the
        caller's thread."""
        _PROFILE.refresh()
        first = self._batches_taken
        self._batches_taken += n
        return first

    def integrate_rays_async(self, rays, intensities=None, timestamps=None,
                             ray_update_flags: int = 0) -> int:
        """Queue a ray batch for the worker thread; returns its ray count N.

        One worker integrates the queued batches in order, so host prep of
        a batch overlaps the device work of the ones before; it takes up to
        OHM_COALESCE queued batches at once and uploads their rayflow wires
        in one copy (_integrate_group).  ``flush`` (and ``sync_voxels``,
        ``stats``) waits for the queue and raises the first error the
        worker met."""
        ray_update_flags = normalize_reverse_walk(ray_update_flags)
        if self._worker is None:
            self._queue = queue.Queue(maxsize=max(4, self._coalesce))
            self._worker = threading.Thread(target=self._work, daemon=True)
            self._worker.start()
        self._queue.put((rays, intensities, timestamps, ray_update_flags, self._take_batch()))
        return np.asarray(rays).reshape(-1, 3).shape[0] // 2

    def _work(self) -> None:
        """The worker: integrate queued batches in order, up to OHM_COALESCE
        at a time, for the mapper's life.

        The current device is per thread, so the worker enters the mapper's
        own.  It launches on that device's current stream, the same one the
        caller's thread uses, so a region the worker evicts (a .cpu()
        download) is read after the previous batch's kernels wrote it."""
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            while True:
                _PROFILE.set_batch(None)
                with _PROFILE.span("worker.wait"):
                    items = [self._queue.get()]
                while len(items) < self._coalesce:
                    try:
                        items.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                try:
                    self._integrate_group(items)
                except Exception as e:  # raised again by flush
                    if self._worker_error is None:
                        self._worker_error = e
                finally:
                    for _ in items:
                        self._queue.task_done()

    def _integrate_group(self, items) -> None:
        """Integrate queued batches in order (tpu_map.py:701-767): consecutive
        rayflow batches of one wire length form a group, whose wires go up
        in one copy (_upload) and run as one chain (_dispatch_chain) or row
        by row.  While a group is pending no allocation may evict (its wires
        name slots): NeedsEviction flushes the group first.  A batch that
        cannot join (the segmented wire, STOP_ON_FIRST_OCCUPIED, a stream
        budget presplit, CacheFull, another wire length) flushes the group
        and takes the synchronous path.  A batch that raises is skipped and
        the others are integrated; the first error is raised at the end
        (the reference's worker drops the rest of the group instead).
        An item is (rays, intensities, timestamps, flags, batch number), as
        the worker's queue holds it; items without the number are numbered
        here."""
        if items and len(items[0]) == 4:
            first = self._take_batch(len(items))
            items = [(*item, first + i) for i, item in enumerate(items)]
        pending = []  # (numpy wire, cfg, n_rays, flags, batch)
        error = None

        def flush():
            if not pending:
                return
            group = list(pending)
            pending.clear()
            self._dispatch_group(group)

        def add(rays, intensities, timestamps, fl, batch):
            def prep(allow_evict):
                _PROFILE.set_batch(batch)
                with _PROFILE.span("worker.prep"):
                    return self._rayflow_setup_host(r, timestamps, intensities, fl,
                                                    allow_evict=allow_evict)

            def synchronous(integrate):
                flush()
                _PROFILE.set_batch(batch)
                integrate(r, intensities, timestamps, fl)

            r = np.asarray(rays, dtype=np.float64).reshape(-1, 3)
            presplit = (self.stream_budget and r.shape[0] // 2 > 256
                        and self._stream_estimate(r) > self.stream_budget)
            if not self.rayflow or presplit or fl & RayFlag.STOP_ON_FIRST_OCCUPIED:
                synchronous(self._integrate_with_retry)
                return
            self.map.touch()
            try:
                setup = prep(not pending)
            except NeedsEviction:
                flush()
                try:
                    setup = prep(True)
                except CacheFull:
                    synchronous(self._split_and_integrate)
                    return
            except CacheFull:
                synchronous(self._split_and_integrate)
                return
            if setup is None:  # the segmented wire
                synchronous(self._integrate_with_retry)
                return
            wire, cfg, n_rays = setup
            if pending and wire.shape != pending[0][0].shape:
                flush()
            pending.append((wire, cfg, n_rays, fl, batch))

        with _PROFILE.span("worker.group", batch=items[0][4] if items else None,
                           count=len(items)):
            for item in items:
                try:
                    add(*item)
                except Exception as e:
                    error = error or e
            flush()
        if error is not None:
            raise error

    def _dispatch_group(self, group) -> None:
        """Upload a pending group's wires in one copy and integrate them:
        by replaying the group's captured graph where _graph_key gives a
        key the cache has seen before (capturing it at the second
        sighting), else as one chain (_dispatch_chain) or row by row."""
        _PROFILE.set_batch(group[0][4])
        wires = [p[0] for p in group]
        cfg = self._chain_cfg(group) if len(group) > 1 else None
        key = self._graph_key(group, cfg)
        step, entry = (self.graphs.step(key, self._graph_epoch()) if key is not None
                       else (EAGER, None))
        if step is EAGER:
            stacked = self._upload(wires)
        elif step is CAPTURE:
            stacked = self._upload(wires, into=torch.empty(
                (len(group), wires[0].shape[0]), dtype=torch.uint8, device=self.device))
            entry = self.graphs.capture(key, stacked,
                                        lambda: self._group_stats(stacked, group, cfg),
                                        count=len(group))
            if entry is not None:
                entry.route = self.last_route
        else:
            self._upload(wires, into=entry.input)
        n_rays = [p[2] for p in group]
        if entry is not None:
            with _PROFILE.span("worker.dispatch", count=len(group)):
                stats = self.graphs.replay(entry, count=len(group))
                self.last_route = entry.route
                self._record(n_rays, n_rays, stats)
        elif cfg is not None:
            self._dispatch_chain(stacked, group, cfg)
        else:
            for row, p in zip(stacked, group):
                _PROFILE.set_batch(p[4])
                self._dispatch(row, p[1], p[2])

    def _graph_key(self, group, cfg):
        """The key of a pending group's captured graph, or None where the
        group runs eagerly: off a card, under ``validate`` (it reads each
        batch's stats back), under OHM_MONOLITH, or where a batch may still
        read an auto-sized window back (_sizing_pending).  The key holds
        what the captured launches depend on: the stacked upload's shape
        (the chain length and the wire's byte length), the chain's resolved
        config or each row's config and route (_route), and the arena
        layers' addresses."""
        if self.graphs is None or self.validate or self.monolith:
            return None
        if any(self._sizing_pending(p[2], p[2]) for p in group):
            return None
        if cfg is not None:
            work = ("chain", cfg)
        else:
            work = ("rows",) + tuple((p[1], self._route(p[1], p[2], p[2])) for p in group)
        return (len(group), group[0][0].shape[0], work,
                tuple(t.data_ptr() for t in self.arena.layers.values()))

    def _sizing_pending(self, n_rays: int, n_segments: int) -> bool:
        """Whether the device step may still size a window from a batch
        (a read back, which a graph cannot hold)."""
        return self._row_cap_unsized(n_segments) or self._scatter_cap_unsized(n_rays)

    def _route(self, cfg: IntegrateConfig, n_rays: int, n_segments: int) -> tuple:
        """The route _integrate_device takes for a batch outside the
        monolith: (the delta path: ``delta_path`` set, delta_path_ok(cfg)
        and no more rays than the batch that sized the window; the fused
        apply's row_cap, 0: the split apply)."""
        delta = (self.delta_path and delta_path_ok(cfg)
                 and not (self._auto_scatter and n_rays > self._cap_rays))
        return (delta, self._fused_row_cap_for(n_segments, cfg.group_cap))

    def _graph_epoch(self) -> tuple:
        """What every captured graph is made under: the sized windows, which
        only grow, and the arena layers' addresses.  A new epoch (an
        escalation, a reallocated arena) drops every graph."""
        return (self.scatter_cap, self.row_cap,
                tuple(t.data_ptr() for t in self.arena.layers.values()))

    def _group_stats(self, stacked, group, cfg) -> torch.Tensor:
        """A group's device work, as a graph captures it: the chain, or each
        row's _integrate_device; its stats entries as one int64 tensor, a
        row an entry, the columns _STAT_NAMES."""
        if cfg is not None:
            entries = [self._chain_device(stacked, len(group), cfg)]
        else:
            entries = [self._integrate_device(decode(row, p[1]), p[1], p[2], p[2])
                       for row, p in zip(stacked, group)]
        return torch.stack([_int64(s[k], self.device) for s in entries
                            for k in self._STAT_NAMES]).view(len(entries), -1)

    def _upload(self, wires, into: torch.Tensor | None = None) -> torch.Tensor:
        """The wires stacked, u8[k, L], in one host-to-device copy, into a
        new tensor or into ``into``.  On a card the stack is written into a
        pinned buffer and copied without blocking the host (a pageable copy
        synchronizes the stream); the buffer is kept, with an event
        recorded after its copy, until that event has passed."""
        with _PROFILE.span("worker.upload", count=len(wires)):
            if self.device.type != "cuda":
                host = torch.from_numpy(np.stack(wires))
                return host.to(self.device) if into is None else into.copy_(host)
            staged = torch.empty((len(wires), wires[0].shape[0]), dtype=torch.uint8,
                                 pin_memory=True)
            np.stack(wires, out=staged.numpy())
            with _PROFILE.span("worker.copy"):
                stacked = (staged.to(self.device, non_blocking=True) if into is None
                           else into.copy_(staged, non_blocking=True))
            copied = torch.cuda.Event()
            copied.record()
            self._staged = [(buf, ev) for buf, ev in self._staged if not ev.query()]
            self._staged.append((staged, copied))
            return stacked

    def _chain_cfg(self, pending):
        """The one config under which a pending group runs as a chain, with
        its row_cap resolved, or None (tpu_map.py:769-809): OHM_CHAIN on, no
        monolith or delta routing, the occupancy mapper's own device step, a
        full group (OHM_COALESCE batches) of equal configs, and the windows
        sized (the chain's summed stats cannot size them)."""
        if (not self.chain or self.monolith or self.delta_path
                or type(self)._integrate_device is not TorchRayMapper._integrate_device):
            return None
        if len(pending) != self._coalesce:
            return None
        cfg0 = pending[0][1]
        if any(p[1] != cfg0 for p in pending[1:]):
            return None
        if self.fused:
            if self.row_cap == 0:
                return None
            rcs = {self._fused_row_cap_for(p[2], cfg0.group_cap) for p in pending}
            if len(rcs) != 1:
                return None
            rc = rcs.pop()
            if rc > 0:
                return dataclasses.replace(cfg0, row_cap=rc)
        if self._auto_scatter and self.scatter_cap == 0:
            return None
        return cfg0

    def _dispatch_chain(self, stacked, pending, cfg) -> None:
        """One chained group: every row of the stacked upload in order under
        ``cfg``; one stats entry."""
        with _PROFILE.span("worker.dispatch", count=len(pending)):
            stats = self._chain_device(stacked, len(pending), cfg)
            self._record([p[2] for p in pending], [p[2] for p in pending], stats)

    def _chain_device(self, stacked, k: int, cfg) -> dict:
        """The chain's device work (ops.integrate.integrate_chain); its
        summed stats."""
        self.last_route = "chain_fused" if cfg.row_cap else "chain_split"
        return integrate_chain(self.arena.layers, stacked, cfg, k)

    def flush(self) -> None:
        """Wait until the worker has integrated every queued batch; raise the
        first error it met since the last flush."""
        _PROFILE.refresh()
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
        stop = ray_update_flags & RayFlag.STOP_ON_FIRST_OCCUPIED
        setup = segmented = None
        with _PROFILE.span("worker.prep"):
            if self.rayflow and not (stop and self._stop_needs_segments):
                setup = self._rayflow_setup_host(rays, timestamps, intensities,
                                                 ray_update_flags)
            if setup is None:
                segmented = self._segmented_setup_host(rays, timestamps, intensities,
                                                       ray_update_flags)
        if setup is not None:
            wire, cfg, n_rays = setup
            with _PROFILE.span("worker.upload"):
                upload = self._to_device(wire)
            return self._dispatch(upload, cfg, n_rays)
        if segmented is None:  # no segment: nothing to integrate
            return np.asarray(rays).reshape(-1, 3).shape[0] // 2
        upload, cfg, n_rays, n_segments = segmented
        with _PROFILE.span("worker.upload"):
            upload = {k: self._to_device(v) for k, v in upload.items()}
        return self._dispatch(upload, cfg, n_rays, n_segments)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array copied to the device; from pageable memory the copy
        blocks the host until the stream reaches it (a sync)."""
        with _PROFILE.sync():
            return torch.from_numpy(array).to(self.device)

    def _dispatch(self, upload, cfg: IntegrateConfig, n_rays: int,
                  n_segments: int | None = None) -> int:
        """Decode an upload already on the device (a rayflow wire, or a dict
        of a segmented batch's tensors) and integrate it; the arena updates
        in place and the stats stay on the device until read."""
        n_segments = n_rays if n_segments is None else n_segments
        with _PROFILE.span("worker.dispatch"):
            stats = self._integrate_device(decode(upload, cfg), cfg, n_rays, n_segments)
            self._record([n_rays], [n_segments], stats)
        return n_rays

    def _record(self, rays, segments, stats: dict) -> None:
        """Count dispatched batches (their ray and segment counts) and keep
        their stats; under ``validate`` read them back and raise on any
        missed, overflowing, compaction-dropped or dropped update."""
        self._stats["rays"] += sum(rays)
        self._stats["segments"] += sum(segments)
        self._stats["batches"] += len(rays)
        self._pending_stats.append(stats)
        if self.validate:
            self._drain_stats()
            for name, what in (("missed_updates", "slot resolution missed: host allocation bug"),
                               ("overflow", "walk step cap exceeded: step bucket bug"),
                               ("compaction_dropped", "group compaction dropped live records: group cap bug"),
                               ("dropped_updates", self._DROPPED_WHAT)):
                if self._stats[name]:
                    raise RuntimeError(f"{name}={self._stats[name]}: {what}")

    def _integrate_device(self, b: dict, cfg: IntegrateConfig, n_rays: int,
                          n_segments: int) -> dict:
        """One decoded batch into the arena, routed as the reference's
        _dispatch routes it (tpu_map.py:570-624): the monolith under
        STOP_ON_FIRST_OCCUPIED or OHM_MONOLITH=1; the delta path where
        ``delta_path`` is set, delta_path_ok(cfg) holds and the batch has no
        more rays than the one that sized the window; else the expand
        (row_cap sized from its stat), then the fused apply where
        _fused_row_cap_for allows it, or the split one.  Returns the
        batch's stats.  The expand phase is this module's name for it,
        which a test may wrap."""
        layers = self.arena.layers
        if self.monolith or cfg.ray_flags & RayFlag.STOP_ON_FIRST_OCCUPIED:
            self.last_route = "monolith"
            return integrate_occupancy(layers, b, cfg)
        if self._route(cfg, n_rays, n_segments)[0]:
            self.last_route = "delta"
            return integrate_delta(layers, b, cfg, expand=expand_records)
        records, stats = expand_records(b, cfg)
        self._auto_size_row_cap(stats, n_segments)
        rc = self._route(cfg, n_rays, n_segments)[1]  # row_cap as just sized
        self.last_route = "fused" if rc else "split"
        stats.update(apply_decoded(layers, records, b,
                                   dataclasses.replace(cfg, row_cap=rc) if rc else cfg))
        self._auto_size_scatter_cap(stats, n_rays)
        return stats

    def _drain_stats(self) -> list[dict]:
        """Read the pending stats entries back (a dict of device values, or
        a replayed group's int64 rows, _group_stats) and sum _STAT_NAMES
        into ``stats``.  Returns the drained values (ints), an entry each.
        The reads count as one sync."""
        drained = []
        if self._pending_stats:
            with _PROFILE.sync():
                for stats in self._pending_stats:
                    if isinstance(stats, torch.Tensor):
                        drained += [dict(zip(self._STAT_NAMES, row)) for row in stats.tolist()]
                    else:
                        drained.append({k: int(stats[k]) for k in self._STAT_NAMES})
        for stats in drained:
            for k, v in stats.items():
                self._stats[k] += v
        self._pending_stats.clear()
        new_drops = sum(s["dropped_updates"] for s in drained)
        if new_drops:
            # Batches past the sized windows lost their over-window
            # voxel-lasts; widen the windows for the next ones, and say so
            # (tpu_map.py:878-895).
            esc = []
            if self._auto_scatter and 0 < self.scatter_cap < self.scatter_pad:
                self.scatter_cap = min(self.scatter_cap * 2, self.scatter_pad)
                esc.append(f"scatter_cap->{self.scatter_cap}")
            if self.row_cap:
                self.row_cap *= 2
                esc.append(f"row_cap->{self.row_cap}")
            logging.getLogger("ohm_tpu_torch").warning(
                "integrate dropped %d voxel updates (deposit window exceeded); escalating %s",
                new_drops, ", ".join(esc) or "nothing (pinned caps)")
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
