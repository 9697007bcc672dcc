"""The port's own host layer against the JAX package's, which it copies:

  source      every copied module (core, oracle, query, mapping.mapper, and
              io, heightmap, tools, utils and app) and batch_prep.cpp and
              laszip.cpp equal their
              originals once the import paths are rewritten; the listed
              differences are core/filters.py, which ORs np.uint32 flags (numpy
              2.1 and later refuse the original's in-place OR of an IntFlag
              into a uint32 array), the device choices of ohmpop, ohmquery
              and timing_run, io/pcd.py's docstring, io/slam.py's
              transform_samples_device (PyTorch in place of a jitted
              function) and app/harness.py, whose option, stats and harness
              classes keep the original's text but for the default device
              and the JAX compile-cache switch; utils/profile.py, which the
              port extends into its span recorder, keeps its original's
              names and gives the same report of the same scopes
  behaviour   the same OccupancyMap operations give the same chunk arrays,
              layer by layer and member by member, and the layouts the same
              voxel structs and clear bytes
  native      the copied rayflow pass gives the same wire bytes as
              ohm_tpu.native on two scenes
  parallel    region_owner and the small host helpers of ohm_tpu/parallel
              equal their originals' text
  oracle      the copied f64 oracles leave chunk arrays bit-identical to
              ohm_tpu.oracle's for occupancy, NDT-OM, NDT-TM, TSDF and the
              secondary samples"""

import os
import re

import numpy as np
import pytest
import torch

import ohm_tpu.core.layout as ref_layout
import ohm_tpu.core.map as ref_map
import ohm_tpu_torch.core.layout as port_layout
import ohm_tpu_torch.core.map as port_map
from ohm_tpu.mapping import batch as ref_batch
from ohm_tpu.oracle.ndt import NdtParams as RefNdtParams
from ohm_tpu.oracle.ndt import RayMapperNdt as RefNdt
from ohm_tpu.oracle.occupancy import RayMapperOccupancy as RefOccupancy
from ohm_tpu.oracle.secondary import RayMapperSecondarySample as RefSecondary
from ohm_tpu.oracle.tsdf import RayMapperTsdf as RefTsdf
from ohm_tpu.oracle.tsdf import TsdfOptions as RefTsdfOptions
from ohm_tpu_torch.mapping import batch as port_batch
from ohm_tpu_torch.mapping.arena import VoxelArena
from ohm_tpu_torch.oracle.ndt import NdtParams, RayMapperNdt
from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy
from ohm_tpu_torch.oracle.secondary import RayMapperSecondarySample
from ohm_tpu_torch.oracle.tsdf import RayMapperTsdf, TsdfOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = [("core", m) for m in ("rayflags", "probability", "keys", "layout", "subvoxel",
                                "filters", "map", "raypattern")]
COPIES += [("oracle", m) for m in ("linewalk", "occupancy", "ndt", "tsdf")]
COPIES += [("query", m) for m in ("base", "nearest", "line_query")]
COPIES += [("mapping", "mapper")]
COPIES += [("core", m) for m in ("compare", "copyutil", "voxel", "compression", "density")]
COPIES += [("io", m) for m in ("__init__", "ply", "las", "serialise")]
COPIES += [("oracle", "secondary")]
COPIES += [("heightmap", m) for m in ("__init__", "heightmap", "image", "mesh")]
COPIES += [("tools", m) for m in ("__init__", "gen")]
COPIES += [("utils", m) for m in ("__init__", "log", "progress", "profile", "trace")]
COPIES += [("app", m) for m in ("export", "ohminfo", "ohm2ply", "ohmheightmap", "ohmhm2img",
                                "ohmfilter", "ohmprob", "ohmcmp", "ohmsubmap")]
#: Copies with a few lines rewritten: (source, port copy) -> [(original
#: text, the port's)], each original text found once.
_DEVICE = ('    p.add_argument("--device", choices=["tpu", "cpu"], default="tpu")\n',
           '    p.add_argument("--device", choices=["cuda", "cpu", "oracle"], default="cuda",\n'
           '                   help="cuda: the port\'s mappers on the card; cpu: their plain PyTorch "\n'
           '                        "versions; oracle: the f64 host mappers")\n')
REWRITTEN = {
    ("ohm_tpu/app/__init__.py", "ohm_tpu_torch/app/__init__.py"): [
        ("(python -m ohm_tpu.app.<tool>)", "(python -m ohm_tpu_torch.app.<tool>)")],
    ("ohm_tpu/app/ohmpop.py", "ohm_tpu_torch/app/ohmpop.py"): [
        ("'--device tpu' replaces", "'--device cuda' replaces"), _DEVICE],
    ("ohm_tpu/app/ohmquery.py", "ohm_tpu_torch/app/ohmquery.py"): [
        ('.split()[0]))\n', '.split()[0]))\n'
         '    ry.add_argument("--device", choices=["cuda", "cpu"], default="cuda")\n'),
        ("RaysQuery(m)", "RaysQuery(m, device=args.device)")],
    ("scripts/timing_run.py", "ohm_tpu_torch/scripts/timing_run.py"): [
        ("#!/usr/bin/env python3\n", ""),
        ("TPU-native analogue of", "Analogue of"),
        ("``ohm_tpu.app.ohmpop``", "``ohm_tpu_torch.app.ohmpop``"),
        ("python scripts/timing_run.py", "python -m ohm_tpu_torch.scripts.timing_run"),
        ("--device tpu cpu", "--device cuda cpu"),
        ("\nsys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))\n",
         ""),
        ('"ohm_tpu timing matrix"', '"ohm_tpu_torch timing matrix"'),
        ('default=["tpu"], choices=["tpu", "cpu"]',
         'default=["cuda"], choices=["cuda", "cpu", "oracle"]')],
}
_IMPORT = re.compile(r"^(\s*)(from|import) ohm_tpu\b", re.MULTILINE)
#: The numpy 2 fix: flags OR'ed as np.uint32.
_FILTER_OR = re.compile(r"\|= (RayFilterFlag\.\w+)")


def _read(*parts) -> str:
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def _profile_keeps_its_source():
    """utils/profile.py: the original's names, and the same report lines
    (scope, depth and calls) from the same nested markers."""
    import ohm_tpu.utils.profile as ref
    import ohm_tpu_torch.utils.profile as port

    def lines(mod):
        prof = mod.Profile()
        for _ in range(3):
            with mod.ProfileMarker("outer", prof):
                with mod.profile_marker("inner", prof):
                    pass
            with mod.ProfileMarker("other", prof):
                pass
        return sorted(re.sub(r": [0-9.]+ ms", "", line) for line in prof.report().splitlines())

    names = {n for n in vars(ref) if not n.startswith("_")} - {
        "annotations", "contextmanager", "threading", "time"}
    assert names <= set(vars(port))
    assert {n for n in vars(ref.Profile) if not n.startswith("_")} - {"push", "pop"} <= set(
        vars(port.Profile))
    assert lines(port) == lines(ref)


#: Copies the port has extended: each is held to its source by the check
#: given instead of text equality.
EXTENDED = {("utils", "profile"): _profile_keeps_its_source}


@pytest.mark.parametrize("package,module", COPIES)
def test_copied_module_matches_its_source(package, module):
    if (package, module) in EXTENDED:
        EXTENDED[(package, module)]()
        return
    ref = _IMPORT.sub(r"\1\2 ohm_tpu_torch", _read("ohm_tpu", package, module + ".py"))
    if module == "filters":
        assert _FILTER_OR.search(ref)
        ref = _FILTER_OR.sub(r"|= np.uint32(\1)", ref)
    assert _read("ohm_tpu_torch", package, module + ".py") == ref


def test_native_source_is_a_copy():
    assert (_read("ohm_tpu_torch", "native", "batch_prep.cpp")
            == _read("ohm_tpu", "native", "batch_prep.cpp"))


def test_laszip_source_is_a_copy():
    assert (_read("ohm_tpu_torch", "native", "laszip.cpp")
            == _read("ohm_tpu", "native", "laszip.cpp"))


@pytest.mark.parametrize("source,port", list(REWRITTEN), ids=lambda p: p.split("/")[-1])
def test_rewritten_copy_differs_only_where_listed(source, port):
    ref = _IMPORT.sub(r"\1\2 ohm_tpu_torch", _read(source))
    for old, new in REWRITTEN[(source, port)]:
        assert ref.count(old) == 1, old
        ref = ref.replace(old, new)
    assert _read(port) == ref


def _without(text: str, start: str, end: str) -> str:
    """``text`` less the part from ``start`` up to ``end``, each found once."""
    assert text.count(start) == 1 and text.count(end) == 1
    return text[:text.index(start)] + text[text.index(end):]


def test_pcd_copy_differs_only_in_its_docstring():
    """io/pcd.py's docstring names the reference's PDAL reader by its path in
    the reference's tree, not on a machine; the code is the original's."""
    ref = _IMPORT.sub(r"\1\2 ohm_tpu_torch", _read("ohm_tpu", "io", "pcd.py"))
    port = _read("ohm_tpu_torch", "io", "pcd.py")
    assert port.startswith('"""') and port.split('"""', 2)[2] == ref.split('"""', 2)[2]
    assert "slamio/PointCloudReaderPdal.cpp" in port.split('"""', 2)[1]


def test_slam_copy_differs_only_in_its_device_transform():
    """io/slam.py is a copy but for transform_samples_device, which is
    PyTorch on an explicit device in the port (tests/test_torch_io.py holds
    it to the JAX version)."""
    cut = ("def transform_samples_device(", "class SlamCloudLoader")
    ref = _IMPORT.sub(r"\1\2 ohm_tpu_torch", _read("ohm_tpu", "io", "slam.py"))
    port = _read("ohm_tpu_torch", "io", "slam.py")
    assert _without(port, *cut) == _without(ref, *cut)


def test_harness_keeps_the_reference_classes():
    """The harness's options, stats and run loop keep the reference's text,
    but for the default device and the JAX compile-cache switch, which the
    port leaves out (its kernels build once into ohm_tpu_torch/_build)."""
    import inspect

    import ohm_tpu.app.harness as ref
    import ohm_tpu_torch.app.harness as port

    for name in ("RayStats", "OutputOptions"):
        assert inspect.getsource(getattr(port, name)) == inspect.getsource(getattr(ref, name))
    assert (inspect.getsource(port.MapOptions)
            == inspect.getsource(ref.MapOptions).replace(
                'device: str = "tpu"  # tpu | cpu (oracle)',
                'device: str = "cuda"  # cuda | cpu (plain PyTorch) | oracle (f64 host)'))
    assert port.MapOptions().device == "cuda"
    run = _IMPORT.sub(r"\1\2 ohm_tpu_torch", inspect.getsource(ref.MapHarness))
    run = _without(run, "        from ohm_tpu_torch.utils.cache import enable_persistent_cache\n",
                   "        self._install_signals()\n")
    assert inspect.getsource(port.MapHarness) == run


#: The segmented wire's and the LASzip codec's loader entries, which the
#: port's native/__init__.py copies verbatim.
NATIVE_COPIES = ("MapParamsStruct", "_ptr", "count_segments", "fill_segments", "unique_regions",
                 "compact_wire", "lookup_slots", "laz_decompress", "laz_compress",
                 "laz_read_chunk_table", "laz_write_chunk_table",
                 "laz_read_chunk_table_variable", "laz_write_chunk_table_variable")


@pytest.mark.parametrize("name", NATIVE_COPIES)
def test_native_loader_entry_is_a_copy(name):
    import inspect

    import ohm_tpu.native as ref_native
    import ohm_tpu_torch.native as port_native

    assert (inspect.getsource(getattr(ref_native, name))
            == inspect.getsource(getattr(port_native, name)))


#: Host functions of ohm_tpu/parallel that ohm_tpu_torch/parallel copies
#: verbatim: (module, name).
PARALLEL_COPIES = [("sharded", "region_owner"), ("sharded", "_next_pow2"),
                   ("sharded", "_subset_prepared"), ("rayflow", "_pow2")]


@pytest.mark.parametrize("module,name", PARALLEL_COPIES)
def test_parallel_host_function_is_a_copy(module, name):
    import importlib
    import inspect

    ref = importlib.import_module(f"ohm_tpu.parallel.{module}")
    port = importlib.import_module(f"ohm_tpu_torch.parallel.{module}")
    assert inspect.getsource(getattr(port, name)) == inspect.getsource(getattr(ref, name))


def _chunk_bytes(m) -> dict:
    """(region, layer, member) -> (dtype, bytes) of every chunk of a map."""
    return {(k, i, name): (str(layer.dtype[name]), np.ascontiguousarray(layer[name]).tobytes())
            for k, c in m.chunks.items() for i, layer in enumerate(c.layers)
            for name in layer.dtype.names}


def _assert_same_chunks(ref, port):
    a, b = _chunk_bytes(ref), _chunk_bytes(port)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key] == b[key], key


def test_layouts_give_the_same_voxel_structs():
    adds = ("add_mean", "add_traversal", "add_covariance", "add_clearance", "add_intensity",
            "add_hit_miss_count", "add_touch_time", "add_incident_normal", "add_tsdf",
            "add_secondary_samples")
    ref, port = ref_layout.default_layout(), port_layout.default_layout()
    for name in adds:
        getattr(ref, name)()
        getattr(port, name)()
    assert len(ref) == len(port) == len(adds) + 1
    for a, b in zip(ref, port):
        assert a.name == b.name and a.voxel_byte_size() == b.voxel_byte_size()
        assert a.voxel_layout.numpy_dtype().descr == b.voxel_layout.numpy_dtype().descr
        assert a.voxel_layout.clear_record().tobytes() == b.voxel_layout.clear_record().tobytes()


def test_map_operations_give_the_same_chunks():
    rng = np.random.default_rng(31)
    rays = np.zeros((400, 3))
    rays[1::2] = rng.uniform(-3.0, 3.0, (200, 3))
    flags = int(ref_map.MapFlag.VOXEL_MEAN | ref_map.MapFlag.TRAVERSAL)
    maps = []
    for mod in (ref_map, port_map):
        m = mod.OccupancyMap(resolution=0.2, region_voxel_dims=16, flags=flags)
        m.integrate_rays(rays)
        m.region((5, 5, 5), allow_create=True)
        m.expire_regions_by_distance((3.0, 3.0, 3.0), 2.5)
        m.touch()
        maps.append(m)
    ref, port = maps
    _assert_same_chunks(ref, port)
    assert len(port.chunks) > 4
    for p in ([0.1, 0.1, 0.1], [2.5, -1.0, 0.3], [9.0, 9.0, 9.0]):
        a, b = ref.voxel_value(point=p), port.voxel_value(point=p)
        assert a == b or (np.isnan(a) and np.isnan(b))
    assert np.array_equal(np.asarray(ref.calculate_extents()),
                          np.asarray(port.calculate_extents()))


def _scene(kind, rng):
    n = 300
    rays = np.empty((2 * n, 3))
    if kind == "one_sensor":
        dirs = rng.normal(size=(n, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        rays[0::2] = 0.0
        rays[1::2] = dirs * rng.uniform(0.3, 6.0, n)[:, None]
    else:  # many sensor poses, so start_frac takes the full float block
        rays[0::2] = rng.uniform(-2.0, 2.0, (n, 3))
        rays[1::2] = rays[0::2] + rng.uniform(-4.0, 4.0, (n, 3))
    return rays


@pytest.mark.parametrize("kind", ["one_sensor", "many_poses"])
def test_native_rayflow_pass_gives_the_same_wire(kind):
    rays = _scene(kind, np.random.default_rng(32))
    wires = []
    for batch_mod, map_mod in ((ref_batch, ref_map), (port_batch, port_map)):
        m = map_mod.OccupancyMap(resolution=0.1, flags=0)
        rf = batch_mod.prepare_rayflow(m, rays)
        assert rf is not None
        arena = VoxelArena(512, 5, torch.device("cpu"))
        arena.ensure_regions(rf.region_keys)
        perm = batch_mod.snake_perm(rf.crossings, 64)
        wires.append(batch_mod.rayflow_wire(rf, arena.table, with_touch=False,
                                            with_intensity=False, cdict=0,
                                            fdict=batch_mod.frac_dict_of(rf), perm=perm))
    assert wires[0].size > 10_000
    assert np.array_equal(wires[0], wires[1])


def _oracle_runs(kind):
    """The same rays through each package's oracle; returns both maps."""
    rng = np.random.default_rng(33)
    rays = np.zeros((240, 3))
    rays[0::2] = (0.0, 0.0, 2.0)
    rays[1::2] = np.column_stack([rng.uniform(-1, 1, 120), rng.uniform(-1, 1, 120),
                                  rng.normal(0.0, 0.01, 120)])
    intens = rng.uniform(10.0, 20.0, 120)
    out = []
    for map_mod, occ, ndt, ndt_params, tsdf, tsdf_opts, secondary in (
            (ref_map, RefOccupancy, RefNdt, RefNdtParams, RefTsdf, RefTsdfOptions, RefSecondary),
            (port_map, RayMapperOccupancy, RayMapperNdt, NdtParams, RayMapperTsdf,
             TsdfOptions, RayMapperSecondarySample)):
        m = map_mod.OccupancyMap(resolution=0.25, flags=0)
        if kind == "occupancy":
            mapper = occ(m)
        elif kind == "secondary":
            mapper = secondary(m)
        elif kind == "tsdf":
            mapper = tsdf(m, tsdf_opts(default_truncation_distance=0.3))
        else:
            mapper = ndt(m, ndt_params(ndt_tm=kind == "ndt_tm"))
        for i in range(0, 240, 80):
            if kind.startswith("ndt"):
                mapper.integrate_rays(rays[i:i + 80], intensities=intens[i // 2:i // 2 + 40])
            else:
                mapper.integrate_rays(rays[i:i + 80])
        out.append(m)
    return out


@pytest.mark.parametrize("kind", ["occupancy", "ndt_om", "ndt_tm", "tsdf", "secondary"])
def test_oracle_copies_give_the_same_chunks(kind):
    ref, port = _oracle_runs(kind)
    assert len(port.chunks) > 0
    _assert_same_chunks(ref, port)
