"""The port's heightmap: tests/test_heightmap.py's tests on ohm_tpu_torch
(reference analogue: tests/ohmtestheightmap/HeightmapTests.cpp), at the
same sizes; then the layered heightmap of one scene built by both packages,
each on its own host map, with identical heightmap layers."""

import numpy as np
import pytest

from ohm_tpu_torch.core.map import OccupancyMap, MapFlag
from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy
from ohm_tpu_torch.heightmap import Heightmap, HeightmapMode, UpAxis, HeightmapVoxelType
from ohm_tpu_torch.heightmap.heightmap import HEIGHTMAP_LAYER
from ohm_tpu_torch.io import save, load


def build_floor_map(rng, slope=0.0, hole=False, res=0.25, sensor=None):
    """Scan a floor z = slope * x (+ optional hole) from above.

    With ``hole``, a single elevated sensor is used so rays cross over the
    hole leaving free voxels above unobserved ones (virtual surface setup).
    """
    m = OccupancyMap(resolution=res, flags=MapFlag.VOXEL_MEAN)
    mapper = RayMapperOccupancy(m)
    xs, ys = np.meshgrid(np.arange(-2, 2.01, res / 2), np.arange(-2, 2.01, res / 2))
    pts = np.column_stack([xs.ravel(), ys.ravel(), slope * xs.ravel()])
    if hole:
        keep = ~((np.abs(pts[:, 0]) < 0.5) & (np.abs(pts[:, 1]) < 0.5))
        pts = pts[keep]
    rays = np.empty((2 * len(pts), 3))
    if sensor is None and hole:
        sensor = (0.0, 0.0, 3.0)
    if sensor is not None:
        rays[0::2] = np.asarray(sensor)
    else:
        rays[0::2] = pts + np.array([0.0, 0.0, 5.0])
    rays[1::2] = pts
    mapper.integrate_rays(rays)
    return m


def test_planar_heightmap_flat_floor():
    rng = np.random.default_rng(31)
    m = build_floor_map(rng)
    hm = Heightmap(min_clearance=1.0, up_axis=UpAxis.Z)
    n = hm.build_heightmap(m, reference_pos=(0, 0, 1.0))
    assert n > 100
    pts, kinds = hm.surface_points()
    # All surface heights ~ 0 (the floor plane).
    assert np.all(kinds == HeightmapVoxelType.SURFACE)
    assert np.abs(pts[:, 2]).max() < m.resolution


def test_sloped_floor_heights():
    rng = np.random.default_rng(32)
    m = build_floor_map(rng, slope=0.3)
    hm = Heightmap(min_clearance=0.5)
    hm.build_heightmap(m, reference_pos=(0, 0, 1.0))
    pts, _ = hm.surface_points()
    # Height tracks the slope (within a voxel).
    err = np.abs(pts[:, 2] - 0.3 * pts[:, 0])
    assert np.median(err) < m.resolution


def test_virtual_surfaces_fill_hole():
    rng = np.random.default_rng(33)
    m = build_floor_map(rng, hole=True)
    hm = Heightmap(min_clearance=0.5)
    hm.generate_virtual_surfaces = True
    hm.build_heightmap(m, reference_pos=(0, 0, 1.0))
    pts, kinds = hm.surface_points()
    assert (kinds == HeightmapVoxelType.VIRTUAL_SURFACE).any(), "hole edges should yield virtual surfaces"
    assert (kinds == HeightmapVoxelType.SURFACE).any()


def test_min_clearance_excludes_covered_ground():
    # Floor plus a low ceiling slab over half the area: covered ground fails
    # a 1.2 m clearance requirement.
    res = 0.25
    m = OccupancyMap(resolution=res, flags=MapFlag.NONE)
    mapper = RayMapperOccupancy(m)
    xs, ys = np.meshgrid(np.arange(-2, 2.01, res / 2), np.arange(-2, 2.01, res / 2))
    floor = np.column_stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)])
    rays = np.empty((2 * len(floor), 3))
    rays[0::2] = floor + np.array([0, 0, 0.8])  # sensor under the slab height
    rays[1::2] = floor
    mapper.integrate_rays(rays)
    ceil_sel = xs.ravel() > 0
    ceiling = np.column_stack([xs.ravel()[ceil_sel], ys.ravel()[ceil_sel], np.full(ceil_sel.sum(), 1.0)])
    rays2 = np.empty((2 * len(ceiling), 3))
    rays2[0::2] = ceiling - np.array([0, 0, 0.5])
    rays2[1::2] = ceiling
    mapper.integrate_rays(rays2)

    hm = Heightmap(min_clearance=1.2)
    hm.build_heightmap(m, reference_pos=(0, 0, 0.5))
    pts, _ = hm.surface_points()
    floor_pts = pts[np.abs(pts[:, 2]) < 0.3]
    # Open half keeps ground; covered half must be excluded (or reports the slab).
    assert (floor_pts[:, 0] < 0).sum() > 0
    covered = floor_pts[(floor_pts[:, 0] > 0.3)]
    assert len(covered) == 0, f"covered ground voxels leaked: {covered[:5]}"


def test_layered_heightmap_two_surfaces():
    # Floor at z=0 and a platform at z=2 -> layered mode reports both.
    res = 0.25
    m = OccupancyMap(resolution=res, flags=MapFlag.NONE)
    mapper = RayMapperOccupancy(m)
    xs, ys = np.meshgrid(np.arange(-1, 1.01, res / 2), np.arange(-1, 1.01, res / 2))
    for z in (0.0, 2.0):
        pts = np.column_stack([xs.ravel(), ys.ravel(), np.full(xs.size, z)])
        rays = np.empty((2 * len(pts), 3))
        rays[0::2] = pts + np.array([0, 0, 1.2])
        rays[1::2] = pts
        mapper.integrate_rays(rays)

    hm = Heightmap(min_clearance=0.5)
    hm.mode = HeightmapMode.LAYERED_FILL
    n = hm.build_heightmap(m, reference_pos=(0, 0, 0.5))
    pts, _ = hm.surface_points()
    zs = np.round(pts[:, 2] / 2.0) * 2.0
    assert set(np.unique(zs)) == {0.0, 2.0}, f"expected two layers, got {np.unique(pts[:, 2])}"


def test_up_axis_negative_z():
    rng = np.random.default_rng(35)
    m = build_floor_map(rng)
    hm = Heightmap(min_clearance=0.5, up_axis=UpAxis.NEG_Z)
    # With -Z up, the floor is a ceiling; reference below it.
    n = hm.build_heightmap(m, reference_pos=(0, 0, -1.0))
    assert n > 0
    pts, _ = hm.surface_points()
    assert np.abs(pts[:, 2]).max() < 2 * m.resolution


def test_heightmap_serialises():
    rng = np.random.default_rng(36)
    m = build_floor_map(rng)
    hm = Heightmap(min_clearance=0.5)
    hm.build_heightmap(m, reference_pos=(0, 0, 1.0))
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "hm.ohm")
        save(path, hm.heightmap())
        loaded, _ = load(path)
        assert loaded.layout.layer_index(HEIGHTMAP_LAYER) >= 0
        assert loaded.info["heightmap"].value is True
        assert len(loaded.chunks) == len(hm.heightmap().chunks)


def test_heightmap_mesh():
    from ohm_tpu_torch.heightmap import HeightmapMesh

    rng = np.random.default_rng(37)
    m = build_floor_map(rng, slope=0.2)
    hm = Heightmap(min_clearance=0.5)
    hm.build_heightmap(m, reference_pos=(0, 0, 1.0))
    mesh = HeightmapMesh()
    assert mesh.build_mesh(hm)
    assert mesh.vertex_count() > 50
    assert mesh.triangle_count() > 50
    # Normals roughly match the slope plane normal.
    expected = np.array([-0.2, 0.0, 1.0])
    expected /= np.linalg.norm(expected)
    dots = mesh.vertex_normals @ expected
    assert np.median(dots) > 0.95


def test_simple_fill_tracks_terrain_beyond_band():
    """kSimpleFill seeds each column's search band at the visiting
    neighbour's ground height (reference: Heightmap.cpp:608-626), so a steep
    slope stays connected even when its far end lies outside the fixed
    floor/ceiling band that defeats PLANAR mode."""
    rng = np.random.default_rng(33)
    m = build_floor_map(rng, slope=0.8, res=0.25)

    def build(mode):
        hm = Heightmap(min_clearance=0.5, up_axis=UpAxis.Z)
        hm.mode = mode
        hm.floor = 0.6   # tight band around the seed height
        hm.ceiling = 0.6
        hm.build_heightmap(m, reference_pos=(0, 0, 0.0))
        return hm.surface_points()[0]

    planar_pts = build(HeightmapMode.PLANAR)
    fill_pts = build(HeightmapMode.SIMPLE_FILL)
    # PLANAR clips the slope to |z| <= band; the fill follows it to the ends.
    assert planar_pts[:, 2].max() < 0.8
    assert fill_pts[:, 2].max() > 1.2
    assert fill_pts[:, 2].min() < -1.2
    # On-slope accuracy holds for the fill result.
    err = np.abs(fill_pts[:, 2] - 0.8 * fill_pts[:, 0])
    assert np.median(err) < m.resolution


def test_simple_fill_matches_planar_on_flat_floor():
    rng = np.random.default_rng(34)
    m = build_floor_map(rng)
    hm_p = Heightmap(min_clearance=1.0)
    hm_p.build_heightmap(m, reference_pos=(0, 0, 1.0))
    hm_f = Heightmap(min_clearance=1.0)
    hm_f.mode = HeightmapMode.SIMPLE_FILL
    hm_f.build_heightmap(m, reference_pos=(0, 0, 1.0))
    p, _ = hm_p.surface_points()
    f, _ = hm_f.surface_points()
    assert len(p) == len(f)
    order_p = np.lexsort(p.T)
    order_f = np.lexsort(f.T)
    np.testing.assert_allclose(p[order_p], f[order_f], atol=1e-6)


def test_simple_fill_virtual_surfaces():
    """BFS fill keeps the planar virtual-surface gating: virtual candidates
    only in columns without a real one (Heightmap.h:67-71)."""
    rng = np.random.default_rng(35)
    m = build_floor_map(rng, hole=True)
    hm = Heightmap(min_clearance=0.5)
    hm.mode = HeightmapMode.SIMPLE_FILL
    hm.generate_virtual_surfaces = True
    n = hm.build_heightmap(m, reference_pos=(0, 0, 1.0))
    assert n > 0
    pts, kinds = hm.surface_points()
    # The hole yields virtual surfaces; the floor yields real ones.
    assert (kinds == HeightmapVoxelType.VIRTUAL_SURFACE).any()
    assert (kinds == HeightmapVoxelType.SURFACE).any()
    virt = pts[kinds == HeightmapVoxelType.VIRTUAL_SURFACE]
    # Virtual cells sit over the hole (|x|,|y| < ~0.75 with margin).
    assert np.all(np.abs(virt[:, :2]) < 1.0)


@pytest.mark.parametrize("axis", [UpAxis.X, UpAxis.NEG_X, UpAxis.Y, UpAxis.NEG_Y])
def test_up_axis_xy(axis):
    """±X/±Y up axes (reference: HeightmapTests.cpp axis sweep): a wall
    perpendicular to the up axis becomes the 'floor' of the heightmap."""
    rng = np.random.default_rng(36)
    m = OccupancyMap(resolution=0.25, flags=MapFlag.VOXEL_MEAN)
    mapper = RayMapperOccupancy(m)
    a = {UpAxis.X: 0, UpAxis.NEG_X: 0, UpAxis.Y: 1, UpAxis.NEG_Y: 1}[axis]
    sign = 1 if int(axis) >= 0 else -1
    # Wall at up-coordinate 0, spanning the other two axes; scan from "above"
    # (up-positive side).
    uv = rng.uniform(-1.5, 1.5, (300, 2))
    pts = np.zeros((300, 3))
    other = [i for i in range(3) if i != a]
    pts[:, other[0]] = uv[:, 0]
    pts[:, other[1]] = uv[:, 1]
    sensor = np.zeros(3)
    sensor[a] = 2.0 * sign
    rays = np.empty((600, 3))
    rays[0::2] = sensor
    rays[1::2] = pts
    mapper.integrate_rays(rays)

    hm = Heightmap(min_clearance=0.5, up_axis=axis)
    ref = np.zeros(3)
    ref[a] = 1.0 * sign
    n = hm.build_heightmap(m, reference_pos=ref)
    assert n > 50
    hpts, kinds = hm.surface_points()
    assert np.all(kinds == HeightmapVoxelType.SURFACE)
    # Surface sits at up-coordinate ~0 regardless of axis/sign.
    assert np.abs(hpts[:, a]).max() < m.resolution


# --------------------------------------------------------------------------- #
# Layered-mode parity tests (reference: HeightmapTests.cpp heightmapLayeredTest
# + finaliseLayeredHeightmap semantics).

from ohm_tpu_torch.heightmap import HeightmapVoxelLayer, HVF_OBSERVED_ABOVE
from ohm_tpu_torch.core import keys as keymath
from ohm_tpu_torch.core.layout import OCCUPANCY_LAYER


def build_multi_level_map(res=0.25):
    """Floor over [-2,2]^2 at z=0 plus a platform at z=2 over the x>0 half
    (analogue of the reference's populateMultiLevelMap scene)."""
    m = OccupancyMap(resolution=res, flags=MapFlag.NONE)
    mapper = RayMapperOccupancy(m)
    xs, ys = np.meshgrid(np.arange(-2, 2.01, res / 2), np.arange(-2, 2.01, res / 2))
    floor = np.column_stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)])
    rays = np.empty((2 * len(floor), 3))
    rays[0::2] = floor + np.array([0, 0, 1.0])  # sensors under the platform
    rays[1::2] = floor
    mapper.integrate_rays(rays)
    sel = xs.ravel() > 0.1
    plat = np.column_stack([xs.ravel()[sel], ys.ravel()[sel], np.full(sel.sum(), 2.0)])
    rays2 = np.empty((2 * len(plat), 3))
    rays2[0::2] = plat + np.array([0, 0, 1.0])
    rays2[1::2] = plat
    mapper.integrate_rays(rays2)
    return m


def collect_columns(hm_map):
    """Heightmap voxels grouped per 2D column: (x_abs, y_abs) ->
    list of (z_stack_index, absolute_height, layer_marker, flags, occ)."""
    hm_layer = hm_map.layer_index(HEIGHTMAP_LAYER)
    occ_layer = hm_map.layer_index(OCCUPANCY_LAYER)
    dims = hm_map.region_voxel_dims
    cols = {}
    for key, chunk in hm_map.chunks.items():
        occ = chunk.layers[occ_layer][OCCUPANCY_LAYER]
        arr = chunk.layers[hm_layer]
        sel = np.flatnonzero(np.isfinite(occ))
        if not sel.size:
            continue
        local = keymath.local_key_from_index(sel, dims)
        abs_v = np.asarray(key, np.int64) * dims + local
        region = np.broadcast_to(np.asarray(key, np.int32), (len(sel), 3)).copy()
        centres = hm_map.voxel_centre_global(region, local)
        for j, i in enumerate(sel):
            cols.setdefault((abs_v[j, 0], abs_v[j, 1]), []).append(
                (abs_v[j, 2], float(arr["height"][i] + centres[j, 2]),
                 int(arr["layer"][i]), int(arr["flags"][i]), float(occ[i])))
    for c in cols.values():
        c.sort()
    return cols


def test_layered_columns_ordered_and_packed():
    m = build_multi_level_map()
    hm = Heightmap(min_clearance=0.5)
    hm.mode = HeightmapMode.LAYERED_FILL
    assert hm.build_heightmap(m, reference_pos=(0, 0, 0.5)) > 0
    cols = collect_columns(hm.heightmap())
    two_layer = [c for c in cols.values() if len(c) == 2]
    assert len(two_layer) > 50, "platform half should produce two-surface columns"
    for entries in cols.values():
        # Packed consecutively from stack index 0.
        assert [e[0] for e in entries] == list(range(len(entries)))
        # Heights strictly ascending along the stack (kLayeredFill ordering).
        heights = [e[1] for e in entries]
        assert heights == sorted(heights)
    for entries in two_layer:
        assert abs(entries[0][1] - 0.0) < m.resolution
        assert abs(entries[1][1] - 2.0) < m.resolution


def test_layered_base_layer_markers_follow_seed():
    m = build_multi_level_map()
    for seed_z, base_height in ((0.5, 0.0), (2.5, 2.0)):
        hm = Heightmap(min_clearance=0.5)
        hm.mode = HeightmapMode.LAYERED_FILL
        hm.build_heightmap(m, reference_pos=(0, 0, seed_z))
        cols = collect_columns(hm.heightmap())
        for entries in cols.values():
            base = [e for e in entries if e[2] == HeightmapVoxelLayer.BASE_LAYER]
            # Exactly one base layer voxel per column.
            assert len(base) == 1, entries
            if len(entries) == 2:
                # The base follows the seed height (isOtherCandidateBetter).
                assert abs(base[0][1] - base_height) < m.resolution, (seed_z, entries)
        # Both surfaces under the sensors are observed above.
        two = next(c for c in cols.values() if len(c) == 2)
        assert two[0][3] & HVF_OBSERVED_ABOVE


def test_layered_unordered_marks_all_base_candidates():
    m = build_multi_level_map()
    hm = Heightmap(min_clearance=0.5)
    hm.mode = HeightmapMode.LAYERED_FILL_UNORDERED
    hm.build_heightmap(m, reference_pos=(0, 0, 0.5))
    cols = collect_columns(hm.heightmap())
    two = [c for c in cols.values() if len(c) == 2]
    assert two
    for entries in two:
        # Unordered mode skips the uniqueness pass: every base candidate
        # keeps kHvlBaseLayer (both surfaces here have observations above).
        assert all(e[2] == HeightmapVoxelLayer.BASE_LAYER for e in entries), entries


def test_layered_reconstruction_covers_all_surfaces():
    # Reference heightmapLayeredTest validation: rebuilding a map from every
    # surface voxel position must reproduce every source occupied voxel that
    # has no occupied voxel directly above it.
    m = build_multi_level_map()
    hm = Heightmap(min_clearance=-1.0)  # no clearance constraint
    hm.mode = HeightmapMode.LAYERED_FILL
    hm.build_heightmap(m, reference_pos=(0, 0, 0.5))
    pts, kinds = hm.surface_points()
    assert np.all(kinds == HeightmapVoxelType.SURFACE)

    # Expected: occupied source voxels whose +z neighbour is not occupied.
    occ_idx = m.layer_index(OCCUPANCY_LAYER)
    dims = m.region_voxel_dims
    occupied = set()
    for key, chunk in m.chunks.items():
        occ = chunk.layers[occ_idx][OCCUPANCY_LAYER]
        sel = np.flatnonzero(np.isfinite(occ) & (occ >= m.occupancy_threshold_value))
        local = keymath.local_key_from_index(sel, dims)
        abs_v = np.asarray(key, np.int64) * dims + local
        occupied.update(map(tuple, abs_v))
    expected = {v for v in occupied if (v[0], v[1], v[2] + 1) not in occupied}

    got = set()
    for p in pts:
        region, local = m.voxel_key(p)
        got.add(tuple(np.asarray(region, np.int64) * dims + local))
    assert got == expected


def test_heightmap_image_render_modes(tmp_path):
    # Reference: ohmheightmapimage/HeightmapImage.h:111-160 — normals and
    # depth bitmaps interpolated across the heightmap mesh.
    from ohm_tpu_torch.heightmap.image import HeightmapImage, ImageType

    rng = np.random.default_rng(40)
    m = build_floor_map(rng, slope=0.2)
    hm = Heightmap(min_clearance=0.5)
    hm.build_heightmap(m, reference_pos=(0, 0, 1.0))

    img = HeightmapImage(ImageType.NORMALS)
    assert img.generate_from_heightmap(hm)
    bitmap, info = img.bitmap()
    assert bitmap.shape == (info.image_height, info.image_width, 3)
    assert bitmap.dtype == np.float32
    # Decode: channels map [0,1] -> [-1,1]; a 0.2-slope floor's normal is
    # ~(-0.196, 0, 0.98) -> blue channel ~0.99, red < 0.5.
    covered = bitmap[..., 2] > 0
    assert covered.mean() > 0.5, "mesh interior should be covered"
    nz = bitmap[covered][:, 2] * 2 - 1
    nx = bitmap[covered][:, 0] * 2 - 1
    assert np.median(nz) == pytest.approx(0.98, abs=0.03)
    assert np.median(nx) == pytest.approx(-0.196, abs=0.05)

    img8 = HeightmapImage(ImageType.NORMALS_888)
    assert img8.generate_from_heightmap(hm)
    b8, i8 = img8.bitmap()
    assert b8.dtype == np.uint8 and i8.bpp == 3

    imgd = HeightmapImage(ImageType.HEIGHTS)
    assert imgd.generate_from_heightmap(hm)
    bd, idp = imgd.bitmap()
    assert bd.dtype == np.float32 and bd.ndim == 2
    # Depth range ~ slope * x-extent = 0.2 * 4 m.
    assert bd.max() == pytest.approx(0.8, abs=0.2)


def test_ohmhm2img_mesh_modes(tmp_path):
    import os
    from ohm_tpu_torch.app import ohmhm2img, ohmheightmap as hm_cli
    from ohm_tpu_torch.io import save

    rng = np.random.default_rng(41)
    m = build_floor_map(rng)
    src = str(tmp_path / "floor.ohm")
    save(src, m)
    hm_file = str(tmp_path / "floor-hm.ohm")
    assert hm_cli.main([src, hm_file, "--clearance", "0.5"]) == 0
    for mode, ext in (("normals", ".png"), ("normals-f32", ".npy"),
                      ("heights-f32", ".npy"), ("height", ".png")):
        out = str(tmp_path / f"img-{mode}{ext}")
        assert ohmhm2img.main([hm_file, out, "--mode", mode]) == 0
        assert os.path.getsize(out) > 60
    npy = np.load(str(tmp_path / "img-normals-f32.npy"))
    assert npy.ndim == 3 and npy.dtype == np.float32


def test_layered_seeded_discovery_excludes_unreachable_shelf():
    """Neighbour-seeded layered discovery (PlaneFillLayeredWalker semantics,
    round-2 VERDICT item 10): with a ceiling band, a high shelf disconnected
    from the terrain by more than the band must NOT be discovered (full-column
    extraction would include it); without a band it must be."""
    from ohm_tpu_torch.heightmap.heightmap import Heightmap, HeightmapMode

    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy

    mapper = RayMapperOccupancy(m)
    # Ground plane at z~0 over [0,4]x[0,2].
    xs, ys = np.meshgrid(np.arange(0.1, 4.0, 0.25), np.arange(0.1, 2.0, 0.25))
    ground = np.column_stack([xs.ravel(), ys.ravel(), np.full(xs.size, 0.1)])
    # Elevated shelf at z=3 over x in [2.5, 4] — no ramp connects it.
    sx, sy = np.meshgrid(np.arange(2.6, 4.0, 0.25), np.arange(0.1, 2.0, 0.25))
    shelf = np.column_stack([sx.ravel(), sy.ravel(), np.full(sx.size, 3.1)])
    pts = np.vstack([ground, shelf])
    rays = np.empty((2 * len(pts), 3))
    rays[0::2] = pts + np.array([0.0, 0.0, 0.9])  # sensors directly above
    rays[1::2] = pts
    mapper.integrate_rays(rays)

    def build(ceiling):
        hm = Heightmap(min_clearance=0.0)
        hm.mode = HeightmapMode.LAYERED_FILL
        hm.ceiling = ceiling
        hm.floor = ceiling
        n = hm.build_heightmap(m, reference_pos=(0.2, 0.2, 0.1))
        pts, _ = hm.surface_points()
        return n, (pts[:, 2] if len(pts) else np.zeros(0))

    n_banded, h_banded = build(ceiling=1.0)
    n_free, h_free = build(ceiling=0.0)
    assert n_banded > 0 and n_free > n_banded
    assert max(h_banded) < 2.0, "shelf leaked into banded layered build"
    assert max(h_free) > 2.5, "unbanded build must include the shelf"


def test_layered_seeded_discovery_negative_up_axis():
    """Regression: _discover_layered computed the BFS seed height index as
    -(abs - vmin) for negative up axes (always clipped to 0) instead of the
    reversed index W-1-(abs-vmin) matching _densify's up-axis flip — banded
    layered builds on NEG_Z seeded at the column's far end and missed the
    terrain around the reference height."""
    from ohm_tpu_torch.heightmap.heightmap import Heightmap, HeightmapMode, UpAxis

    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy

    mapper = RayMapperOccupancy(m)
    # The shelf scene mirrored in z: up = NEG_Z, terrain at z~0, a
    # disconnected "shelf" at z=-3 (i.e. 3 m UP in NEG_Z terms).
    xs, ys = np.meshgrid(np.arange(0.1, 4.0, 0.25), np.arange(0.1, 2.0, 0.25))
    ground = np.column_stack([xs.ravel(), ys.ravel(), np.full(xs.size, -0.1)])
    sx, sy = np.meshgrid(np.arange(2.6, 4.0, 0.25), np.arange(0.1, 2.0, 0.25))
    shelf = np.column_stack([sx.ravel(), sy.ravel(), np.full(sx.size, -3.1)])
    pts = np.vstack([ground, shelf])
    rays = np.empty((2 * len(pts), 3))
    rays[0::2] = pts + np.array([0.0, 0.0, -0.9])  # sensors "above" (-z)
    rays[1::2] = pts
    mapper.integrate_rays(rays)

    def build(ceiling):
        hm = Heightmap(min_clearance=0.0, up_axis=UpAxis.NEG_Z)
        hm.mode = HeightmapMode.LAYERED_FILL
        hm.ceiling = ceiling
        hm.floor = ceiling
        n = hm.build_heightmap(m, reference_pos=(0.2, 0.2, -0.1))
        spts, _ = hm.surface_points()
        return n, (spts[:, 2] if len(spts) else np.zeros(0))

    n_banded, h_banded = build(ceiling=1.0)
    n_free, h_free = build(ceiling=0.0)
    assert n_banded > 0, "banded NEG_Z build discovered nothing (seed off-band)"
    assert n_free > n_banded
    assert min(h_banded) > -2.0, "shelf leaked into banded NEG_Z layered build"
    assert min(h_free) < -2.5, "unbanded build must include the shelf"


def test_voxel_normals_from_covariance():
    """Heightmap surface-cell normals derive from the NDT covariance's
    smallest eigenvector (reference: HeightmapMesh / CovarianceVoxel eigen
    helpers); pins the lazy emitted-cells-only computation against the
    analytic plane normal of a sloped floor."""
    from ohm_tpu_torch.oracle.ndt import RayMapperNdt
    from ohm_tpu_torch.heightmap.heightmap import HEIGHTMAP_LAYER

    slope = 0.3
    m = OccupancyMap(resolution=0.25, flags=MapFlag.VOXEL_MEAN)
    m.layout.add_covariance()
    m.ensure_chunk_layers()
    mapper = RayMapperNdt(m)
    rng = np.random.default_rng(5)
    # Dense, jittered multi-sample hits so per-voxel covariances are planar.
    xs, ys = np.meshgrid(np.arange(-1.5, 1.51, 0.0625), np.arange(-1.5, 1.51, 0.0625))
    pts = np.column_stack([xs.ravel(), ys.ravel(), slope * xs.ravel()])
    pts += rng.normal(scale=0.02, size=pts.shape)
    rays = np.empty((2 * len(pts), 3))
    rays[0::2] = pts + np.array([0.0, 0.0, 5.0])
    rays[1::2] = pts
    mapper.integrate_rays(rays)

    hm = Heightmap(min_clearance=0.0)
    assert hm.build_heightmap(m) > 0
    hml = hm.heightmap()
    hm_layer = hml.layer_index(HEIGHTMAP_LAYER)
    expected = np.array([-slope, 0.0, 1.0]) / np.hypot(slope, 1.0)
    checked = 0
    for key, chunk in hml.chunks.items():
        arr = chunk.layers[hm_layer]
        occ = chunk.layers[hml.layer_index("occupancy")]["occupancy"]
        sel = np.flatnonzero(np.isfinite(occ) & (occ > 0))
        n = np.stack([arr["normal_x"][sel], arr["normal_y"][sel],
                      arr["normal_z"][sel]], axis=-1)
        # Well-sampled cells only: few-sample covariances are legitimately
        # ray-direction-dominated, not planar.
        nz = (np.linalg.norm(n, axis=1) > 0.5) & (arr["contributing_samples"][sel] >= 8)
        dots = n[nz] @ expected
        if nz.any():
            assert (dots > 0.9).mean() > 0.85, f"normals off-plane in {key}"
        checked += int(nz.sum())
    assert checked > 50, "too few covariance normals emitted to validate"


def _box_rays(n, rng, half=(3.0, 3.0, 1.5)):
    """A sensor in a box room (bench.py's scene, smaller)."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.min(np.asarray(half) / np.abs(dirs), axis=1)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * t[:, None]
    return rays


def _layered_heightmap_chunks(m, heightmap_cls, mode):
    hm = heightmap_cls(min_clearance=0.5)
    hm.mode = mode
    assert hm.build_heightmap(m) > 0
    out = hm.heightmap()
    return {(k, i, name): np.ascontiguousarray(c.layers[i][name]).tobytes()
            for k, c in out.chunks.items() for i in range(len(c.layers))
            for name in c.layers[i].dtype.names}


def test_layered_heightmap_matches_the_jax_package():
    """The layered heightmap (min clearance 0.5) of one box scan: the
    port's TorchRayMapper on the CPU and its heightmap against TpuRayMapper
    (rayflow wire, split apply) and the JAX package's heightmap, each on its
    own host map; every heightmap layer identical byte for byte."""
    import ohm_tpu.core.map as ref_map
    import ohm_tpu.heightmap as ref_heightmap
    from ohm_tpu.mapping.tpu_map import TpuRayMapper
    from ohm_tpu_torch import TorchRayMapper

    rng = np.random.default_rng(41)
    batches = [_box_rays(1024, rng) for _ in range(2)]
    ref_m = ref_map.OccupancyMap(resolution=0.1, flags=ref_map.MapFlag.NONE)
    port_m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    ref = TpuRayMapper(ref_m, capacity=64, rayflow=True, scatter_cap=0)
    port = TorchRayMapper(port_m, capacity=64, device="cpu", rayflow=True)
    for rays in batches:
        ref.integrate_rays(rays)
        port.integrate_rays(rays)
    ref.sync_voxels()
    port.sync_voxels()
    a = _layered_heightmap_chunks(ref_m, ref_heightmap.Heightmap,
                                  ref_heightmap.HeightmapMode.LAYERED_FILL)
    b = _layered_heightmap_chunks(port_m, Heightmap, HeightmapMode.LAYERED_FILL)
    assert a.keys() == b.keys() and len(a) > 0
    assert all(a[k] == b[k] for k in a)
