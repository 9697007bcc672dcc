"""Structured debug tracing (reference: ohm/Trace + RayMapperTrace + 3es).

The reference streams visual debug events to 3rd Eye Scene; without a 3es
viewer in this stack, Trace writes structured JSONL events (rays, voxel
snapshots, map stats) that tooling can replay or plot.  RayMapperTrace-style
decoration is provided by ``TracingRayMapper``.
"""

from __future__ import annotations

import json
import time

import numpy as np


class Trace:
    """Event stream writer (reference API: ohm/Trace.h:37-66)."""

    def __init__(self, filename: str):
        self.filename = filename
        self._f = open(filename, "w")
        self.event("trace_begin", time=time.time())

    def event(self, kind: str, **payload):
        def clean(v):
            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, (np.floating, np.integer)):
                return v.item()
            return v

        self._f.write(json.dumps({"event": kind, **{k: clean(v) for k, v in payload.items()}}) + "\n")

    def close(self):
        if self._f:
            self.event("trace_end", time=time.time())
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TracingRayMapper:
    """Decorates a ray mapper with per-batch trace events
    (reference: ohm/RayMapperTrace.h:38-80)."""

    def __init__(self, mapper, trace: Trace, sample_limit: int = 64):
        self.mapper = mapper
        self.trace = trace
        self.sample_limit = sample_limit
        self.map = mapper.map

    def integrate_rays(self, rays, intensities=None, timestamps=None, ray_update_flags=0):
        rays = np.asarray(rays, dtype=np.float64).reshape(-1, 3)
        n = self.mapper.integrate_rays(rays, intensities=intensities, timestamps=timestamps,
                                       ray_update_flags=ray_update_flags)
        self.trace.event(
            "integrate_rays",
            count=int(rays.shape[0] // 2),
            flags=int(ray_update_flags),
            rays=rays[: 2 * self.sample_limit],
            regions=self.map.region_count(),
            stamp=self.map.stamp,
        )
        return n

    def __getattr__(self, name):
        return getattr(self.mapper, name)


def sector_key(region, local, dims):
    """Sector key (region xyz + octant w in [0, 7]): bit i of w selects the
    upper half of the region along axis i (reference:
    ohm/RayMapperTrace.h:66-81 SectorSet)."""
    w = (int(local[0] >= dims[0] // 2)
         | (int(local[1] >= dims[1] // 2) << 1)
         | (int(local[2] >= dims[2] // 2) << 2))
    return (int(region[0]), int(region[1]), int(region[2]), w)


class RayMapperTrace(TracingRayMapper):
    """Full per-ray/voxel/ellipsoid trace decorator
    (reference: ohm/RayMapperTrace.{h,cpp}).

    Wraps any mapper; each integrate_rays snapshots the occupancy state of
    every voxel the batch touches (walked on the host, as the reference's
    cacheState does), integrates through the wrapped mapper, re-snapshots,
    and emits the rays plus only the voxels whose OccupancyType CHANGED —
    including NDT ellipsoid pose/scale from the covariance layer when
    present (reference VoxelState ellipse_{rotation,pos,scale}).  The 3es
    stream is replaced by Trace's JSONL events, mirroring the reference's
    incremental viewer protocol (round 4):

    - ``occupancy_mesh_update``: a persistent point mesh of every occupied
      voxel with STABLE vertex indices — newly occupied voxels take indices
      from a free list (reference OccupancyMesh::update vertex reuse),
      newly freed voxels release theirs, still-occupied touched voxels
      recolour in place.  A viewer replays these as vertex add/remove/
      recolour deltas without rescanning the map.
    - ``ndt_sector`` / ``ndt_sector_destroy``: per (region, octant) sector
      the FULL current ellipsoid set, replace-by-shape-id semantics
      (reference drawNdt's MultiShape setReplace(true) with
      id = chunk + sector); a sector whose last ellipsoid vanished destroys
      its shape.  Sector = half-region per axis, sectorKey() parity.
      NDT-TM maps carry intensity/hit/miss per ellipsoid (drawNdtTm's
      colouring inputs).
    """

    def __init__(self, mapper, trace: Trace, sample_limit: int = 64):
        super().__init__(mapper, trace, sample_limit)
        self._vidx: dict = {}     # (region, local) -> stable vertex index
        self._vfree: list = []    # released vertex indices (reuse pool)
        self._vnext = 0
        self._sectors_live: set = set()

    # -- state snapshots ---------------------------------------------------

    def _touched_keys(self, rays):
        from ohm_tpu_torch.oracle.linewalk import walk_segment_keys
        from ohm_tpu_torch.core import keys as keymath

        abs_keys = set()

        def visit(abs_key, marker, enter, exit_):
            abs_keys.add(tuple(int(v) for v in abs_key))
            return True

        for i in range(0, len(rays), 2):
            walk_segment_keys(self.map, rays[i], rays[i + 1], visit)

        keys = set()
        dims = self.map.region_voxel_dims
        if abs_keys:
            arr = np.array(sorted(abs_keys), np.int64)
            region, local = keymath.abs_to_key(arr, dims)
            for j in range(len(arr)):
                keys.add((tuple(int(v) for v in region[j]), tuple(int(v) for v in local[j])))
        for i in range(1, len(rays), 2):
            region, local = self.map.voxel_key(rays[i])
            keys.add((tuple(int(v) for v in np.asarray(region).reshape(3)),
                      tuple(int(v) for v in np.asarray(local).reshape(3))))
        return keys

    def _snapshot(self, keys):
        from ohm_tpu_torch.core.layout import OCCUPANCY_LAYER, COVARIANCE_LAYER, MEAN_LAYER
        from ohm_tpu_torch.core.subvoxel import sub_voxel_to_local_coord

        occ_idx = self.map.layer_index(OCCUPANCY_LAYER)
        cov_idx = self.map.layer_index(COVARIANCE_LAYER)
        mean_idx = self.map.layer_index(MEAN_LAYER)
        states = {}
        for region, local in keys:
            chunk = self.map.region(region)
            if chunk is None:
                states[(region, local)] = ("null", 0.0, None)
                continue
            idx = int(self.map.voxel_index(np.asarray(local)))
            value = float(chunk.layers[occ_idx][OCCUPANCY_LAYER][idx])
            kind = self.map.occupancy_type(value)
            ellipse = None
            if cov_idx >= 0 and kind == "occupied":
                cov6 = np.array([chunk.layers[cov_idx][n][idx]
                                 for n in ("P00", "P01", "P11", "P02", "P12", "P22")], np.float64)
                s = np.zeros((3, 3))
                s[0, 0], s[1, 0], s[1, 1], s[2, 0], s[2, 1], s[2, 2] = cov6
                p = s @ s.T
                w, v = np.linalg.eigh(p)
                scale = np.sqrt(np.maximum(w, 0.0))
                centre = self.map.voxel_centre_global(
                    np.asarray(region, np.int32), np.asarray(local, np.int32)).reshape(3)
                if mean_idx >= 0:
                    coord = chunk.layers[mean_idx]["coord"][idx]
                    centre = centre + sub_voxel_to_local_coord(
                        np.asarray([coord], np.uint32), self.map.resolution)[0]
                ellipse = {"pos": centre.tolist(), "scale": scale.tolist(),
                           "axes": v.tolist()}
            states[(region, local)] = (kind, value, ellipse)
        return states

    def _sector_ellipsoids(self, sk):
        """All ellipsoids currently in one (region, octant) sector — the
        replace-payload of an ndt_sector event (reference drawNdt/drawNdtTm,
        RayMapperTrace.cpp:407-533)."""
        from ohm_tpu_torch.core.layout import (OCCUPANCY_LAYER, COVARIANCE_LAYER,
                                         MEAN_LAYER, INTENSITY_LAYER,
                                         HIT_MISS_COUNT_LAYER)
        from ohm_tpu_torch.core import keys as keymath
        from ohm_tpu_torch.core.subvoxel import sub_voxel_to_local_coord

        m = self.map
        chunk = m.region(sk[:3])
        if chunk is None:
            return []
        dims = m.region_voxel_dims
        cov_idx = m.layer_index(COVARIANCE_LAYER)
        occ = chunk.layers[m.layer_index(OCCUPANCY_LAYER)][OCCUPANCY_LAYER]
        # Octant local-index range: bit i of w selects the upper half on axis i.
        half = dims // 2
        rng = [np.arange(half[i], dims[i]) if (sk[3] >> i) & 1 else np.arange(half[i])
               for i in range(3)]
        idx = (rng[0][:, None, None] + rng[1][None, :, None] * dims[0]
               + rng[2][None, None, :] * dims[0] * dims[1]).reshape(-1)
        sel = idx[np.isfinite(occ[idx])
                  & (occ[idx] >= m.occupancy_threshold_value)]
        mean_idx = m.layer_index(MEAN_LAYER)
        int_idx = m.layer_index(INTENSITY_LAYER)
        hm_idx = m.layer_index(HIT_MISS_COUNT_LAYER)
        cov = chunk.layers[cov_idx]
        ells = []
        region = np.asarray(sk[:3], np.int32)
        for i in sel:
            i = int(i)
            cov6 = np.array([cov[nm][i] for nm in
                             ("P00", "P01", "P11", "P02", "P12", "P22")], np.float64)
            s = np.zeros((3, 3))
            s[0, 0], s[1, 0], s[1, 1], s[2, 0], s[2, 1], s[2, 2] = cov6
            p = s @ s.T
            w, v = np.linalg.eigh(p)
            local = keymath.local_key_from_index(np.asarray([i]), dims)[0]
            centre = m.voxel_centre_global(region, local).reshape(3)
            if mean_idx >= 0:
                coord = chunk.layers[mean_idx]["coord"][i]
                centre = centre + sub_voxel_to_local_coord(
                    np.asarray([coord], np.uint32), m.resolution)[0]
            e = {"pos": centre.tolist(),
                 "scale": np.sqrt(np.maximum(w, 0.0)).tolist(),
                 "axes": v.tolist()}
            if int_idx >= 0:  # NDT-TM colouring inputs (drawNdtTm)
                e["intensity"] = float(chunk.layers[int_idx]["mean"][i])
            if hm_idx >= 0:
                e["hit"] = int(chunk.layers[hm_idx]["hit_count"][i])
                e["miss"] = int(chunk.layers[hm_idx]["miss_count"][i])
            ells.append(e)
        return ells

    def integrate_rays(self, rays, intensities=None, timestamps=None, ray_update_flags=0):
        rays = np.asarray(rays, dtype=np.float64).reshape(-1, 3)
        keys = self._touched_keys(rays)
        before = self._snapshot(keys)
        n = self.mapper.integrate_rays(rays, intensities=intensities, timestamps=timestamps,
                                       ray_update_flags=ray_update_flags)
        if hasattr(self.mapper, "sync_voxels"):
            self.mapper.sync_voxels()
        after = self._snapshot(keys)

        changes = []
        ellipsoids = []
        added, removed, recolour = [], [], []
        for key in keys:
            old_kind = before[key][0]
            new_kind, new_value, new_ellipse = after[key]
            if old_kind != new_kind:
                changes.append({"region": list(key[0]), "local": list(key[1]),
                                "from": old_kind, "to": new_kind})
            if new_ellipse is not None:
                ellipsoids.append({"region": list(key[0]), "local": list(key[1]),
                                   **new_ellipse})
            # Incremental occupied-voxel mesh (reference OccupancyMesh::
            # update): stable vertex indices with free-list reuse.
            if new_kind == "occupied" and old_kind != "occupied":
                vi = self._vfree.pop() if self._vfree else self._vnext
                if vi == self._vnext:
                    self._vnext += 1
                self._vidx[key] = vi
                centre = self.map.voxel_centre_global(
                    np.asarray(key[0], np.int32), np.asarray(key[1], np.int32)).reshape(3)
                added.append({"i": vi, "pos": centre.tolist(), "value": new_value})
            elif old_kind == "occupied" and new_kind != "occupied":
                vi = self._vidx.pop(key, None)
                if vi is not None:
                    removed.append(vi)
                    self._vfree.append(vi)
            elif new_kind == "occupied":
                vi = self._vidx.get(key)
                if vi is None:  # occupied before tracing began
                    vi = self._vfree.pop() if self._vfree else self._vnext
                    if vi == self._vnext:
                        self._vnext += 1
                    self._vidx[key] = vi
                    centre = self.map.voxel_centre_global(
                        np.asarray(key[0], np.int32), np.asarray(key[1], np.int32)).reshape(3)
                    added.append({"i": vi, "pos": centre.tolist(), "value": new_value})
                else:
                    recolour.append({"i": vi, "value": new_value})
        self.trace.event(
            "integrate_rays",
            count=int(rays.shape[0] // 2),
            flags=int(ray_update_flags),
            rays=rays[: 2 * self.sample_limit],
            voxel_changes=changes,
            ellipsoids=ellipsoids[: self.sample_limit],
            regions=self.map.region_count(),
            stamp=self.map.stamp,
        )
        if added or removed or recolour:
            self.trace.event("occupancy_mesh_update", added=added,
                             removed=removed, recolour=recolour,
                             vertex_count=len(self._vidx))

        # Sector-keyed NDT shape replacement (reference drawNdt per sector
        # crossed by the batch's rays, cacheState's SectorSet).
        from ohm_tpu_torch.core.layout import COVARIANCE_LAYER

        if self.map.layer_index(COVARIANCE_LAYER) >= 0:
            dims = self.map.region_voxel_dims
            sectors = sorted({sector_key(k[0], k[1], dims) for k in keys})
            for sk in sectors:
                ells = self._sector_ellipsoids(sk)
                if ells:
                    self._sectors_live.add(sk)
                    self.trace.event("ndt_sector", shape_id=list(sk),
                                     replace=True, ellipsoids=ells)
                elif sk in self._sectors_live:
                    self._sectors_live.discard(sk)
                    self.trace.event("ndt_sector_destroy", shape_id=list(sk))
        return n


def debug_draw(map_obj, trace: Trace, max_voxels: int = 200000):
    """Whole-map snapshot event (reference: ohm/DebugDraw.h:17-32
    debugDraw* send complete occupied/free/NDT-ellipsoid sets to 3es).

    Emits one 'debug_draw' event with every observed voxel's centre, type
    and value, plus NDT ellipsoids (pos/scale/axes) when a covariance layer
    is present.  ``max_voxels`` bounds the payload; the count of omitted
    voxels is reported so truncation is never silent.
    """
    from ohm_tpu_torch.core.layout import OCCUPANCY_LAYER, COVARIANCE_LAYER, MEAN_LAYER
    from ohm_tpu_torch.core import keys as keymath
    from ohm_tpu_torch.core.subvoxel import sub_voxel_to_local_coord

    occ_idx = map_obj.layer_index(OCCUPANCY_LAYER)
    cov_idx = map_obj.layer_index(COVARIANCE_LAYER)
    mean_idx = map_obj.layer_index(MEAN_LAYER)
    dims = map_obj.region_voxel_dims
    centres, values, kinds = [], [], []
    ellipsoids = []
    omitted = 0
    for key, chunk in map_obj.chunks.items():
        occ = chunk.layers[occ_idx][OCCUPANCY_LAYER]
        sel = np.flatnonzero(np.isfinite(occ))
        if not sel.size:
            continue
        if len(values) and len(values[0]) * len(values) > max_voxels:
            omitted += sel.size
            continue
        local = keymath.local_key_from_index(sel, dims)
        region = np.broadcast_to(np.asarray(key, np.int32), (len(sel), 3))
        c = map_obj.voxel_centre_global(region, local)
        centres.append(c)
        values.append(occ[sel])
        kinds.append(occ[sel] >= map_obj.occupancy_threshold_value)
        if cov_idx >= 0:
            occupied = np.flatnonzero(occ[sel] >= map_obj.occupancy_threshold_value)
            for j in occupied[:256]:
                idx = int(sel[j])
                cov6 = np.array([chunk.layers[cov_idx][n][idx]
                                 for n in ("P00", "P01", "P11", "P02", "P12", "P22")],
                                np.float64)
                s = np.zeros((3, 3))
                s[0, 0], s[1, 0], s[1, 1], s[2, 0], s[2, 1], s[2, 2] = cov6
                p = s @ s.T
                w, v = np.linalg.eigh(p)
                centre = c[j].copy()
                if mean_idx >= 0:
                    coord = chunk.layers[mean_idx]["coord"][idx]
                    centre = centre + sub_voxel_to_local_coord(
                        np.asarray([coord], np.uint32), map_obj.resolution)[0]
                ellipsoids.append({"pos": centre.tolist(),
                                   "scale": np.sqrt(np.maximum(w, 0)).tolist(),
                                   "axes": v.tolist()})
    if centres:
        centres = np.concatenate(centres)
        values = np.concatenate(values)
        kinds = np.concatenate(kinds)
    trace.event(
        "debug_draw",
        voxel_count=int(len(values)) if len(centres) else 0,
        omitted=omitted,
        centres=centres[:max_voxels] if len(centres) else [],
        values=values[:max_voxels] if len(centres) else [],
        occupied=kinds[:max_voxels] if len(centres) else [],
        ellipsoids=ellipsoids,
        stamp=map_obj.stamp,
    )
