"""Heightmap: collapse an occupancy map into a 2.5D surface map.

Reference parity: ohmheightmap/Heightmap.{h,cpp}, HeightmapVoxel.h,
HeightmapMode.h, UpAxis.h, HeightmapUtil.cpp — configurable up axis
(+-X/Y/Z), floor/ceiling band around a reference position, minimum
clearance, virtual surfaces (free voxels with unobserved above), voxel-mean
heights, and single-layer or multi-layer (sorted / unordered) extraction.

Design note: the reference's planar and flood-fill walkers visit one column
at a time; this implementation classifies the whole region of interest as a
dense [X, Y, Z] grid and reduces every column in parallel (numpy today; the
classification and reductions are jnp-compatible).  Coverage of the fill
modes equals the full extent rectangle in the reference too (neighbours are
pushed whether or not a column found ground, Heightmap.cpp:619+626); what the
fill changes is the SEARCH SEED — each column's floor/ceiling band tracks the
visiting neighbour's ground height rather than the fixed reference plane
(PlaneFillWalker open list carries the ground key).  kSimpleFill runs that
BFS height propagation here; the layered modes run the multi-height
(column, height) BFS of PlaneFillLayeredWalker when a floor/ceiling band is
set, falling back to the equivalent parallel full-column
extraction (all candidates per column, a coverage-equal superset).
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np

from ohm_tpu_torch.core import keys as keymath
from ohm_tpu_torch.core import subvoxel
from ohm_tpu_torch.core.layout import (
    MapLayout,
    DataType,
    OCCUPANCY_LAYER,
    MEAN_LAYER,
    COVARIANCE_LAYER,
)
from ohm_tpu_torch.core.map import OccupancyMap, MapFlag

HEIGHTMAP_LAYER = "heightmap"


class UpAxis(IntEnum):
    """Reference: ohmheightmap/UpAxis.h."""

    NEG_Z = -3
    NEG_Y = -2
    NEG_X = -1
    X = 0
    Y = 1
    Z = 2


class HeightmapMode(IntEnum):
    """Reference: ohmheightmap/HeightmapMode.h:17-30."""

    PLANAR = 0
    SIMPLE_FILL = 1
    LAYERED_FILL_UNORDERED = 2
    LAYERED_FILL = 3


class HeightmapVoxelType(IntEnum):
    """Reference: ohmheightmap/HeightmapVoxelType.h."""

    UNKNOWN = 0
    VACANT = 1
    SURFACE = 2
    VIRTUAL_SURFACE = 3
    FENCE = 4


class HeightmapVoxelLayer(IntEnum):
    """HeightmapVoxel.layer marker values (ohmheightmap/HeightmapVoxel.h:16-28).

    NOT a stack index: kLayeredFill marks exactly one voxel per column as the
    base (preferred) surface; all other surfaces in the column are extended.
    """

    BASE_LAYER = 0
    EXTENDED = 1
    INVALID = 2


#: HeightmapVoxel.flags bit: some observed (non-unobserved) voxel exists above
#: the surface (ohmheightmap/HeightmapVoxel.h:31-56).
HVF_OBSERVED_ABOVE = 1


def add_heightmap_layer(layout: MapLayout):
    """Heightmap voxel layer schema (reference: HeightmapUtil.cpp:39-46)."""
    existing = layout.layer(HEIGHTMAP_LAYER)
    if existing:
        return existing
    layer = layout.add_layer(HEIGHTMAP_LAYER)
    v = layer.voxel_layout
    v.add_member("height", DataType.FLOAT, 0)
    v.add_member("clearance", DataType.FLOAT, 0)
    v.add_member("normal_x", DataType.FLOAT, 0)
    v.add_member("normal_y", DataType.FLOAT, 0)
    v.add_member("normal_z", DataType.FLOAT, 0)
    v.add_member("layer", DataType.UINT8, 0)
    v.add_member("flags", DataType.UINT8, 0)
    v.add_member("contributing_samples", DataType.UINT16, 0)
    return layer


_AXIS_OF = {UpAxis.X: 0, UpAxis.NEG_X: 0, UpAxis.Y: 1, UpAxis.NEG_Y: 1, UpAxis.Z: 2, UpAxis.NEG_Z: 2}


@dataclasses.dataclass
class _Dense:
    """Dense classification of the source map (axes permuted to [u, v, up])."""

    kind: np.ndarray  # uint8 [U, V, W]: 0 unobserved, 1 free, 2 occupied
    height: np.ndarray  # f32 [U, V, W] voxel height along up (mean-adjusted)
    samples: np.ndarray  # uint16 [U, V, W] contributing sample counts
    cov6: np.ndarray | None  # f32 [U, V, W, 6] packed sqrt-covariance rows
    #                          (P00,P01,P11,P02,P12,P22) when available;
    #                          normals are derived LAZILY for emitted cells
    #                          only (the per-voxel eigendecomposition is the
    #                          classify phase's dominant cost otherwise)
    vmin: np.ndarray  # int64 [3] minimum abs voxel coordinate (original axes)
    shape: tuple

    def normals_at(self, ui, vi, z, axis):
        """Surface normals for selected cells: smallest eigenvector of
        P = S·Sᵀ (reference: HeightmapMesh / CovarianceVoxel eigen helpers),
        oriented along +axis; zeros for non-occupied (virtual) cells."""
        if self.cov6 is None:
            return None
        s6 = self.cov6[ui, vi, z].astype(np.float64)
        n_out = np.zeros((len(ui), 3), np.float32)
        occ = self.kind[ui, vi, z] == 2
        if occ.any():
            s = s6[occ]
            s_mat = np.zeros((len(s), 3, 3))
            s_mat[:, 0, 0] = s[:, 0]
            s_mat[:, 1, 0] = s[:, 1]
            s_mat[:, 1, 1] = s[:, 2]
            s_mat[:, 2, 0] = s[:, 3]
            s_mat[:, 2, 1] = s[:, 4]
            s_mat[:, 2, 2] = s[:, 5]
            p = s_mat @ s_mat.transpose(0, 2, 1)
            w, v = np.linalg.eigh(p)
            n = v[:, :, 0]
            n *= np.where(n[:, axis:axis + 1] < 0, -1.0, 1.0)
            n_out[occ] = n.astype(np.float32)
        return n_out


class Heightmap:
    """Heightmap generator (reference API: ohmheightmap/Heightmap.h:43-131)."""

    def __init__(self, grid_resolution: float | None = None, min_clearance: float = 1.0,
                 up_axis: UpAxis = UpAxis.Z):
        self.min_clearance = float(min_clearance)
        self.grid_resolution = grid_resolution
        self.up_axis = UpAxis(up_axis)
        self.mode = HeightmapMode.PLANAR
        self.ceiling = 0.0  # limit above reference_pos (voxels up); 0 = unbounded
        self.floor = 0.0  # limit below reference_pos; 0 = unbounded
        self.generate_virtual_surfaces = False
        self.virtual_surface_promotion = False
        #: Remove virtual surfaces with fewer than this many surface voxels
        #: among their 26 source-map neighbours (0 = off; ordered layered
        #: mode only — reference filterVirtualVoxels).
        self.virtual_surface_filter_threshold = 0
        self.use_voxel_mean = True
        self._heightmap: OccupancyMap | None = None
        self._source: OccupancyMap | None = None

    # ------------------------------------------------------------------ #

    def heightmap(self) -> OccupancyMap:
        return self._heightmap

    def build_heightmap(self, source_map: OccupancyMap, reference_pos=(0.0, 0.0, 0.0),
                        cull_to_extents=None) -> int:
        """Collapse ``source_map`` into this heightmap around ``reference_pos``.

        Returns the number of heightmap voxels generated
        (reference: Heightmap::buildHeightmap, Heightmap.cpp:335-400).
        """
        self._source = source_map
        res = self.grid_resolution or source_map.resolution
        hm = OccupancyMap(resolution=res, region_voxel_dims=tuple(source_map.region_voxel_dims),
                          flags=MapFlag.NONE, origin=source_map.origin)
        add_heightmap_layer(hm.layout)
        hm.ensure_chunk_layers()
        # Record generation parameters (reference: HeightmapDetail::toMapInfo).
        hm.info["heightmap"] = True
        hm.info["heightmap-axis"] = int(self.up_axis)
        hm.info["heightmap-clearance"] = self.min_clearance
        hm.info["heightmap-mode"] = int(self.mode)
        hm.info["heightmap-virtual-surfaces"] = bool(self.generate_virtual_surfaces)
        self._heightmap = hm

        dense = self._classify(source_map, reference_pos, cull_to_extents)
        if dense is None:
            return 0

        if self.mode == HeightmapMode.PLANAR:
            return self._extract_single(dense, reference_pos)
        if self.mode == HeightmapMode.SIMPLE_FILL:
            return self._extract_fill(dense, reference_pos)
        return self._extract_layered(dense, reference_pos,
                                     sort=self.mode == HeightmapMode.LAYERED_FILL)

    # ------------------------------------------------------------------ #

    def _classify(self, m: OccupancyMap, reference_pos, cull) -> _Dense | None:
        extents = m.calculate_extents()
        if extents is None:
            return None
        dims = m.region_voxel_dims
        res = m.resolution
        axis = _AXIS_OF[self.up_axis]
        up_sign = 1 if int(self.up_axis) >= 0 else -1

        keys = np.array(list(m.chunks.keys()), dtype=np.int64)
        if cull is not None:
            cmin, cmax = (np.asarray(c, np.float64) for c in cull)
            centres = m.origin + keys * m.region_spatial_dims
            half = 0.5 * m.region_spatial_dims
            sel = np.all(centres - half <= cmax, axis=1) & np.all(centres + half >= cmin, axis=1)
            keys = keys[sel]
        if not len(keys):
            return None
        rmin = keys.min(axis=0)
        rmax = keys.max(axis=0)
        vmin = rmin * dims
        shape = tuple(((rmax - rmin + 1) * dims).astype(int))
        if np.prod(shape) > 768 ** 3:
            raise MemoryError("heightmap ROI too large; cull to extents")

        kind = np.zeros(shape, np.uint8)
        height = np.zeros(shape, np.float32)
        samples = np.zeros(shape, np.uint16)
        occ_idx = m.layer_index(OCCUPANCY_LAYER)
        mean_idx = m.layer_index(MEAN_LAYER)
        cov_idx = m.layer_index(COVARIANCE_LAYER)
        cov6 = np.zeros(shape + (6,), np.float32) if cov_idx >= 0 else None
        threshold = np.float32(m.occupancy_threshold_value)

        for key, chunk in m.chunks.items():
            rk = np.asarray(key, np.int64)
            if np.any(rk < rmin) or np.any(rk > rmax):
                continue
            occ = chunk.layers[occ_idx][OCCUPANCY_LAYER].reshape(dims[2], dims[1], dims[0]).transpose(2, 1, 0)
            k = np.where(~np.isfinite(occ), 0, np.where(occ >= threshold, 2, 1)).astype(np.uint8)
            o = (rk - rmin) * dims
            sl = (slice(o[0], o[0] + dims[0]), slice(o[1], o[1] + dims[1]), slice(o[2], o[2] + dims[2]))
            kind[sl] = k
            # Heights: voxel centre along up axis (+ sub-voxel mean offset).
            if mean_idx >= 0 and self.use_voxel_mean:
                coord = chunk.layers[mean_idx]["coord"].reshape(dims[2], dims[1], dims[0]).transpose(2, 1, 0)
                off = subvoxel.sub_voxel_to_local_coord(coord, res)[..., axis]
                samples[sl] = np.minimum(
                    chunk.layers[mean_idx]["count"].reshape(dims[2], dims[1], dims[0]).transpose(2, 1, 0), 0xFFFF)
            else:
                off = np.zeros((dims[0], dims[1], dims[2]), np.float32)
            base = (m.origin[axis] + (np.arange(dims[axis]) + rk[axis] * dims[axis] - dims[axis] // 2 + 0.5) * res
                    ).astype(np.float32)
            shape_b = [1, 1, 1]
            shape_b[axis] = dims[axis]
            height[sl] = base.reshape(shape_b) + off
            if cov6 is not None:
                cov = chunk.layers[cov_idx]
                for j, k2 in enumerate(("P00", "P01", "P11", "P02", "P12", "P22")):
                    cov6[sl + (j,)] = cov[k2].reshape(
                        dims[2], dims[1], dims[0]).transpose(2, 1, 0)

        # Permute axes so 'up' is last and ascending along +up.
        order = [i for i in range(3) if i != axis] + [axis]
        kind = np.transpose(kind, order)
        height = np.transpose(height, order)
        samples = np.transpose(samples, order)
        if cov6 is not None:
            cov6 = np.transpose(cov6, order + [3])
        if up_sign < 0:
            kind = kind[..., ::-1]
            height = -height[..., ::-1]
            samples = samples[..., ::-1]
            if cov6 is not None:
                cov6 = cov6[..., ::-1, :]
        return _Dense(kind=kind, height=height, samples=samples, cov6=cov6,
                      vmin=vmin, shape=shape)

    # ------------------------------------------------------------------ #

    def _candidates(self, dense: _Dense):
        """Per-column ground candidate mask + clearance + observation (vectorised).

        A ground candidate is an occupied voxel (or, with virtual surfaces, a
        free voxel whose -up neighbour is unobserved) with at least
        min_clearance of non-occupied space above it; at least one clear voxel
        directly above is always required (reference: findGround's walk-up and
        findNearestSupportingVoxel's clearance_voxel_count_permissive =
        max(1, ...), Heightmap.cpp:568-570).

        Returns (candidates, virtual, clearance_dist, observed_above):
        clearance_dist is the height gap to the next occupied voxel above
        (0 = no known obstruction, ohmheightmap HeightmapVoxel::clearance);
        observed_above marks candidates with any observed voxel above them
        (HeightmapVoxel kHvfObservedAbove).
        """
        kind = dense.kind
        res = self._source.resolution
        clearance_vox = max(1, int(np.ceil(self.min_clearance / res)))
        occupied = kind == 2
        free = kind == 1
        unobserved = kind == 0

        W = kind.shape[-1]
        # Clearance: no occupied voxel within clearance_vox above the candidate.
        clear = np.ones_like(occupied)
        for dz in range(1, clearance_vox + 1):
            shifted = np.zeros_like(occupied)
            shifted[..., :W - dz] = occupied[..., dz:]
            clear &= ~shifted

        candidates = occupied & clear
        virtual = np.zeros_like(candidates)
        if self.generate_virtual_surfaces:
            # A virtual surface is a free voxel with an unobserved voxel
            # below it (reference: Heightmap.h:67-71), reported only in
            # columns without a real occupied candidate (handled by callers).
            below_unobs = np.zeros_like(unobserved)
            below_unobs[..., 1:] = unobserved[..., :-1]
            virtual = free & below_unobs & clear & ~candidates
        # Clearance distance to the next occupied voxel above (0 = unknown).
        next_occ = np.full(kind.shape, np.inf, np.float32)
        running = np.full(kind.shape[:2], np.inf, np.float32)
        for z in range(W - 1, -1, -1):
            next_occ[..., z] = running
            running = np.where(occupied[..., z], dense.height[..., z], running)
        has = np.isfinite(next_occ)
        clearance_dist = np.where(has, next_occ - dense.height, 0.0).astype(np.float32)
        # Any observed (free or occupied) voxel strictly above -> suffix-any.
        observed = kind != 0
        observed_above = np.zeros_like(observed)
        observed_above[..., :-1] = np.cumsum(observed[..., ::-1], axis=-1)[..., ::-1][..., 1:] > 0
        return candidates, virtual, clearance_dist, observed_above

    def _extract_single(self, dense: _Dense, reference_pos) -> int:
        axis = _AXIS_OF[self.up_axis]
        ref_h = float(np.asarray(reference_pos, np.float64)[axis]) * (1 if int(self.up_axis) >= 0 else -1)
        candidates, virtual, clearance, observed_above = self._candidates(dense)
        cand = candidates | virtual
        h = dense.height
        # Floor / ceiling band relative to the reference height.
        if self.floor > 0:
            cand &= h >= ref_h - self.floor
        if self.ceiling > 0:
            cand &= h <= ref_h + self.ceiling
        # Virtual candidates count only in columns with no real candidate
        # (reference: Heightmap.h:70; setPromoteVirtualBelow alters this).
        has_real = (cand & ~virtual).any(axis=-1, keepdims=True)
        if self.virtual_surface_promotion:
            virt_ok = virtual & ((h < ref_h) | ~has_real)
        else:
            virt_ok = virtual & ~has_real
        cand = (cand & ~virtual) | virt_ok
        # Nearest candidate to the reference height per column.
        dist = np.where(cand, np.abs(h - ref_h), np.inf)
        zi = np.argmin(dist, axis=-1)
        has = np.isfinite(np.take_along_axis(dist, zi[..., None], axis=-1)[..., 0])
        return self._emit(dense, zi[..., None], has[..., None], virtual, clearance, observed_above)

    def _extract_fill(self, dense: _Dense, reference_pos) -> int:
        """kSimpleFill: 8-connected BFS over the plane where each column's
        floor/ceiling search band is centred on the VISITING column's ground
        height, so the heightmap follows terrain beyond the seed plane
        (reference: Heightmap.cpp:608-626 + PlaneFillWalker — the open list
        carries the ground key; findNearestSupportingVoxel searches around
        the propagated walk key, not around the global reference height)."""
        from collections import deque

        axis = _AXIS_OF[self.up_axis]
        up_sign = 1 if int(self.up_axis) >= 0 else -1
        plane_axes = [i for i in range(3) if i != axis]
        ref_h = float(np.asarray(reference_pos, np.float64)[axis]) * up_sign
        candidates, virtual, clearance, observed_above = self._candidates(dense)
        h = dense.height
        U, V, W = candidates.shape

        # Seed column from the reference position (clamped into the ROI).
        src = self._source
        region, local = src.voxel_key(np.asarray(reference_pos, np.float64))
        abs_v = np.asarray(region, np.int64) * src.region_voxel_dims + local
        su = int(np.clip(abs_v[plane_axes[0]] - dense.vmin[plane_axes[0]], 0, U - 1))
        sv = int(np.clip(abs_v[plane_axes[1]] - dense.vmin[plane_axes[1]], 0, V - 1))

        visited = np.zeros((U, V), bool)
        has = np.zeros((U, V), bool)
        out_z = np.zeros((U, V), np.int64)
        queue = deque([(su, sv, ref_h)])
        visited[su, sv] = True
        while queue:
            u, v, h_seed = queue.popleft()
            col_h = h[u, v]
            band = np.ones(W, bool)
            if self.floor > 0:
                band &= col_h >= h_seed - self.floor
            if self.ceiling > 0:
                band &= col_h <= h_seed + self.ceiling
            real = candidates[u, v] & band
            virt = virtual[u, v] & band
            # Virtual candidates count only without a real one (or below the
            # seed height when promotion is enabled) — same gating as planar.
            if real.any():
                sel = real | (virt & (col_h < h_seed)) if self.virtual_surface_promotion else real
            else:
                sel = virt
            h_next = h_seed
            if sel.any():
                dist = np.where(sel, np.abs(col_h - h_seed), np.inf)
                z = int(np.argmin(dist))
                has[u, v] = True
                out_z[u, v] = z
                h_next = float(col_h[z])
            for du in (-1, 0, 1):
                for dv in (-1, 0, 1):
                    nu, nv = u + du, v + dv
                    if (du or dv) and 0 <= nu < U and 0 <= nv < V and not visited[nu, nv]:
                        visited[nu, nv] = True
                        queue.append((nu, nv, h_next))
        return self._emit(dense, out_z[..., None], has[..., None], virtual, clearance, observed_above)

    def _discover_layered(self, dense: _Dense, candidates, virtual,
                          reference_pos):
        """Multi-height BFS surface discovery for the layered modes.

        Port of the reference's PlaneFillLayeredWalker seeding semantics
        (PlaneFillLayeredWalker.cpp:69-101 + Heightmap.cpp onVisitWalker):
        the open list holds (column, height) pairs; each visit searches its
        floor/ceiling band around the SEED height, the found ground seeds
        the 8 plane neighbours AT THE GROUND HEIGHT (each (column, height)
        visited once), and a fruitless visit falls back to
        kAddUnvisitedColumnNeighbours (column-level dedup).  A column can
        thus be revisited at different heights, discovering one surface per
        chain — surfaces beyond every chain's band are NOT discovered,
        unlike round-2's full-column extraction.
        Returns a bool [U, V, W] mask of discovered surfaces.
        """
        from collections import deque

        axis = _AXIS_OF[self.up_axis]
        up_sign = 1 if int(self.up_axis) >= 0 else -1
        plane_axes = [i for i in range(3) if i != axis]
        ref_h = float(np.asarray(reference_pos, np.float64)[axis]) * up_sign
        h = dense.height
        U, V, W = candidates.shape

        src = self._source
        region, local = src.voxel_key(np.asarray(reference_pos, np.float64))
        abs_v = np.asarray(region, np.int64) * src.region_voxel_dims + local
        su = int(np.clip(abs_v[plane_axes[0]] - dense.vmin[plane_axes[0]], 0, U - 1))
        sv = int(np.clip(abs_v[plane_axes[1]] - dense.vmin[plane_axes[1]], 0, V - 1))
        # The dense arrays are REVERSED along up when up_sign < 0
        # (_densify's kind[..., ::-1]), so the up index mirrors to W-1-i.
        iz = int(abs_v[axis] - dense.vmin[axis])
        sz = int(np.clip(iz if up_sign > 0 else W - 1 - iz, 0, W - 1))

        visited_h = np.zeros((U, V, W), bool)   # (column, height) touched
        visited_col = np.zeros((U, V), bool)    # column touched (fruitless mode)
        reached = np.zeros((U, V, W), bool)
        queue = deque([(su, sv, sz)])
        visited_h[su, sv, sz] = True
        visited_col[su, sv] = True
        while queue:
            u, v, z_seed = queue.popleft()
            h_seed = float(h[u, v, z_seed])
            band = np.ones(W, bool)
            if self.floor > 0:
                band &= h[u, v] >= h_seed - self.floor
            if self.ceiling > 0:
                band &= h[u, v] <= h_seed + self.ceiling
            real = candidates[u, v] & band
            virt = virtual[u, v] & band
            if real.any():
                sel = (real | (virt & (h[u, v] < h_seed))
                       if self.virtual_surface_promotion else real)
            else:
                sel = virt
            if sel.any():
                dist = np.where(sel, np.abs(h[u, v] - h_seed), np.inf)
                z = int(np.argmin(dist))
                reached[u, v, z] = True
                for du in (-1, 0, 1):
                    for dv in (-1, 0, 1):
                        nu, nv = u + du, v + dv
                        if (du or dv) and 0 <= nu < U and 0 <= nv < V \
                                and not visited_h[nu, nv, z]:
                            visited_h[nu, nv, z] = True
                            visited_col[nu, nv] = True
                            queue.append((nu, nv, z))
            else:
                # Fruitless visit: column-level neighbour seeding only
                # (PlaneWalkVisitMode::kAddUnvisitedColumnNeighbours).
                for du in (-1, 0, 1):
                    for dv in (-1, 0, 1):
                        nu, nv = u + du, v + dv
                        if (du or dv) and 0 <= nu < U and 0 <= nv < V \
                                and not visited_col[nu, nv]:
                            visited_col[nu, nv] = True
                            visited_h[nu, nv, z_seed] = True
                            queue.append((nu, nv, z_seed))
        return reached

    def _extract_layered(self, dense: _Dense, reference_pos, sort: bool) -> int:
        """Multi-surface (layered) extraction.

        Reference semantics reproduced (Heightmap.cpp buildHeightmapT +
        HeightmapOperations.cpp finaliseLayeredHeightmap):
        - every surface of a column is emitted, stacked consecutively along
          the up axis from vertical index 0, ordered ascending by height
          (kLayeredFill sorts columns; kLayeredFillUnordered leaves insertion
          order unspecified — ascending is emitted for both);
        - HeightmapVoxel.layer carries kHvlBaseLayer/kHvlExtended markers: the
          ordered mode marks exactly ONE voxel per column as base — the
          candidate with clearAbove (clearance > 0 or observed above) closest
          to the seed height (BaseLayerCandidate::isOtherCandidateBetter);
          unordered mode marks every base-candidate (no uniqueness pass);
        - virtual surfaces too close (<= min_clearance) to another surface in
          the column are dropped (Heightmap.cpp addSurfaceVoxel's
          nearest_voxel_below/above rejection);
        - with virtual_surface_filter_threshold > 0, ordered mode removes
          virtual surfaces with fewer than threshold surface voxels among
          their 26 source-map neighbours (filterVirtualVoxels).

        Candidate CLASSIFICATION is a parallel full-column pass; with a
        floor/ceiling band set, discovery is then restricted to the
        surfaces reachable by the reference's neighbour-seeded multi-height
        BFS (_discover_layered, PlaneFillLayeredWalker.cpp:69-101) — an
        unbanded build reaches everything, where the full-column set is
        already exact.
        """
        axis = _AXIS_OF[self.up_axis]
        up_sign = 1 if int(self.up_axis) >= 0 else -1
        ref_h = float(np.asarray(reference_pos, np.float64)[axis]) * up_sign
        candidates, virtual, clearance, observed_above = self._candidates(dense)
        h = dense.height
        if self.floor > 0 or self.ceiling > 0:
            # Neighbour-seeded discovery (reference PlaneFillLayeredWalker:
            # the open list carries full keys, so each visit's floor/ceiling
            # band is centred on the VISITING NEIGHBOUR's ground height and
            # the surface set is what the seed chains can reach).  Without a
            # band every candidate is reachable and the BFS is an identity.
            reached = self._discover_layered(dense, candidates, virtual,
                                             reference_pos)
            candidates = candidates & reached
            virtual = virtual & reached
        cand = candidates | virtual

        # Virtual-surface proximity rejection: ascending sweep keeping the
        # running height of the last kept surface per column; a virtual
        # candidate within min_clearance of the kept surface below or the
        # next real surface above is dropped.
        if self.min_clearance > 0 and self.generate_virtual_surfaces and virtual.any():
            W = cand.shape[-1]
            next_real_h = np.full(cand.shape, np.inf, np.float32)
            running = np.full(cand.shape[:2], np.inf, np.float32)
            for z in range(W - 1, -1, -1):
                next_real_h[..., z] = running
                running = np.where(candidates[..., z], h[..., z], running)
            last_h = np.full(cand.shape[:2], -np.inf, np.float32)
            for z in range(W):
                sel = cand[..., z]
                v = virtual[..., z]
                too_close = v & ((h[..., z] - last_h <= self.min_clearance)
                                 | (next_real_h[..., z] - h[..., z] <= self.min_clearance))
                cand[..., z] = sel & ~too_close
                keep = cand[..., z]
                last_h = np.where(keep, h[..., z], last_h)

        # Virtual neighbour-support filter (ordered mode only in reference).
        if sort and self.virtual_surface_filter_threshold > 0 and virtual.any():
            surf = cand
            support = np.zeros(cand.shape, np.int32)
            for du in (-1, 0, 1):
                for dv in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        if du == 0 and dv == 0 and dz == 0:
                            continue
                        shifted = np.zeros_like(surf)
                        src = shifted[max(0, -du):shifted.shape[0] - max(0, du),
                                      max(0, -dv):shifted.shape[1] - max(0, dv),
                                      max(0, -dz):shifted.shape[2] - max(0, dz)]
                        src[...] = surf[max(0, du):surf.shape[0] - max(0, du),
                                        max(0, dv):surf.shape[1] - max(0, dv),
                                        max(0, dz):surf.shape[2] - max(0, dz)]
                        support += shifted
            cand &= ~(virtual & (support < self.virtual_surface_filter_threshold))

        max_layers = int(cand.sum(axis=-1).max()) if cand.any() else 0
        if max_layers == 0:
            return 0
        # Indices of candidates per column, ascending up-height (already
        # ascending along the permuted up axis) -> layered stack order.
        order = np.argsort(~cand, axis=-1, kind="stable")  # candidates first
        zi = order[..., :max_layers]
        has = np.take_along_axis(cand, zi, axis=-1)

        # Base-layer candidacy: clearance > 0 or observed above
        # (Heightmap.cpp:628-631 is_base_layer_candidate).
        clear_above = (clearance > 0) | observed_above
        is_base = np.take_along_axis(cand & clear_above, zi, axis=-1) & has
        layer_marker = np.full(zi.shape, int(HeightmapVoxelLayer.EXTENDED), np.uint8)
        if sort:
            # Exactly one base per column: the base candidate closest to the
            # seed height; single-surface columns are always base
            # (finaliseLayeredHeightmap single-voxel handling).
            hh = np.take_along_axis(h, zi, axis=-1)
            dist = np.where(is_base, np.abs(hh - ref_h), np.inf)
            best = np.argmin(dist, axis=-1)
            has_base = np.isfinite(np.take_along_axis(dist, best[..., None], axis=-1)[..., 0])
            single = has.sum(axis=-1) == 1
            np.put_along_axis(layer_marker, best[..., None],
                              np.where(has_base[..., None], int(HeightmapVoxelLayer.BASE_LAYER),
                                       int(HeightmapVoxelLayer.EXTENDED)).astype(np.uint8), axis=-1)
            layer_marker[single, 0] = int(HeightmapVoxelLayer.BASE_LAYER)
        else:
            layer_marker = np.where(is_base, int(HeightmapVoxelLayer.BASE_LAYER),
                                    int(HeightmapVoxelLayer.EXTENDED)).astype(np.uint8)
        return self._emit(dense, zi, has, virtual, clearance, observed_above, layer_marker)

    def _emit(self, dense: _Dense, zi, has, virtual, clearance, observed_above,
              layer_marker=None) -> int:
        """Write selected candidates into the heightmap map.

        ``layer_marker`` carries per-entry HeightmapVoxelLayer values for the
        layered modes; single-layer modes mark everything kHvlBaseLayer
        (reference: addSurfaceVoxel's is_base_layer_candidate is always true
        for non-layered maps).
        """
        hm = self._heightmap
        src = self._source
        axis = _AXIS_OF[self.up_axis]
        up_sign = 1 if int(self.up_axis) >= 0 else -1
        plane_axes = [i for i in range(3) if i != axis]
        res = src.resolution

        U, V, L = zi.shape
        uu, vv = np.meshgrid(np.arange(U), np.arange(V), indexing="ij")
        count = 0
        hm_layer = hm.layer_index(HEIGHTMAP_LAYER)
        occ_layer = hm.layer_index(OCCUPANCY_LAYER)
        dims = hm.region_voxel_dims

        for layer_idx in range(L):
            sel = has[..., layer_idx]
            if not sel.any():
                continue
            ui = uu[sel]
            vi = vv[sel]
            z = zi[..., layer_idx][sel]
            heights = dense.height[ui, vi, z] * up_sign
            clear = clearance[ui, vi, z]
            is_virtual = virtual[ui, vi, z]
            obs_above = observed_above[ui, vi, z]
            markers = (layer_marker[..., layer_idx][sel] if layer_marker is not None
                       else np.zeros(len(ui), np.uint8))
            samples = dense.samples[ui, vi, z]
            normals = dense.normals_at(ui, vi, z, axis)

            # Heightmap voxel key: 2D cell in the plane axes; the up-axis key
            # is the layer index for layered maps (0 for single layer) —
            # the reference stores layered entries stacked along up.
            abs_keys = np.zeros((sel.sum(), 3), np.int64)
            abs_keys[:, plane_axes[0]] = dense.vmin[plane_axes[0]] + ui
            abs_keys[:, plane_axes[1]] = dense.vmin[plane_axes[1]] + vi
            abs_keys[:, axis] = layer_idx
            region, local = keymath.abs_to_key(abs_keys, dims)
            idx = keymath.voxel_index(local, dims)

            # Vectorised field values (the per-cell Python loop this replaces
            # dominated layered builds at ~10 µs/cell).
            centres = hm.voxel_centre_global(region, local)
            rel_heights = (heights - centres[:, axis]).astype(np.float32)
            # kHeightmapSurfaceValue = 1, kHeightmapVirtualSurfaceValue = -1
            # (reference: Heightmap.h:112-121).
            occ_vals = np.where(is_virtual, np.float32(-1.0), np.float32(1.0))
            flag_vals = np.where(obs_above, HVF_OBSERVED_ABOVE, 0).astype(np.uint8)

            # Group cells by destination region: one chunk lookup + sliced
            # writes per region instead of per cell.
            pk = keymath.pack_region_key(region)
            order_g = np.argsort(pk, kind="stable")
            pk_s = pk[order_g]
            starts = np.flatnonzero(np.r_[True, pk_s[1:] != pk_s[:-1]])
            bounds = np.r_[starts, len(pk_s)]
            for g in range(len(starts)):
                rows = order_g[bounds[g]:bounds[g + 1]]
                chunk = hm.region(region[rows[0]], allow_create=True)
                ii = idx[rows]
                chunk.layers[occ_layer][OCCUPANCY_LAYER][ii] = occ_vals[rows]
                arr = chunk.layers[hm_layer]
                arr["height"][ii] = rel_heights[rows]
                arr["clearance"][ii] = clear[rows]
                if normals is not None:
                    arr["normal_x"][ii] = normals[rows, 0]
                    arr["normal_y"][ii] = normals[rows, 1]
                    arr["normal_z"][ii] = normals[rows, 2]
                arr["layer"][ii] = markers[rows]
                arr["flags"][ii] = flag_vals[rows]
                arr["contributing_samples"][ii] = samples[rows]
                chunk.dirty_stamp = hm.touch()
            count += int(sel.sum())
        return count

    # ------------------------------------------------------------------ #

    def voxel_type(self, point) -> HeightmapVoxelType:
        """Classify a heightmap cell (reference: Heightmap voxel type queries)."""
        hm = self._heightmap
        region, local = hm.voxel_key(np.asarray(point, np.float64))
        chunk = hm.region(region)
        if chunk is None:
            return HeightmapVoxelType.UNKNOWN
        idx = int(hm.voxel_index(local))
        occ = chunk.layers[hm.layer_index(OCCUPANCY_LAYER)][OCCUPANCY_LAYER][idx]
        if not np.isfinite(occ):
            return HeightmapVoxelType.UNKNOWN
        if occ >= hm.occupancy_threshold_value:
            return HeightmapVoxelType.SURFACE
        return HeightmapVoxelType.VIRTUAL_SURFACE

    def surface_points(self):
        """All heightmap surface cell centres with their heights (for export)."""
        hm = self._heightmap
        src = self._source
        axis = _AXIS_OF[self.up_axis]
        hm_layer = hm.layer_index(HEIGHTMAP_LAYER)
        occ_layer = hm.layer_index(OCCUPANCY_LAYER)
        dims = hm.region_voxel_dims
        pts = []
        kinds = []
        for key, chunk in hm.chunks.items():
            occ = chunk.layers[occ_layer][OCCUPANCY_LAYER]
            sel = np.flatnonzero(np.isfinite(occ))
            if not sel.size:
                continue
            local = keymath.local_key_from_index(sel, dims)
            region = np.broadcast_to(np.asarray(key, np.int32), (len(sel), 3))
            centres = hm.voxel_centre_global(region, local)
            centres[:, axis] = centres[:, axis] * 0 + chunk.layers[hm_layer]["height"][sel] + centres[:, axis]
            pts.append(centres)
            kinds.append(np.where(occ[sel] >= hm.occupancy_threshold_value,
                                  HeightmapVoxelType.SURFACE, HeightmapVoxelType.VIRTUAL_SURFACE))
        if not pts:
            return np.zeros((0, 3)), np.zeros(0, np.int32)
        return np.concatenate(pts), np.concatenate(kinds).astype(np.int32)
