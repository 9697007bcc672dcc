"""The modes (``ohmbench/modes``) give the maps that ``run.py`` gave before
they moved into files of their own, on a small CPU run of each box cell,
and compare them as ``reference/compare.py`` did before each mode brought
its own comparison; a mode, a scene and a client loop added as files alone
carry a cell through ``run.run_cell`` with no edit to ``run.py`` or
``generator.py``; and a mode with a comparison of its own, with a new
cell's configuration, limits and small size, carries that cell through the
run, the controls and the planted faults with no edit to a file that
exists."""

import hashlib
import json
import sys
import textwrap

import pytest
import torch

import ohmbench
import ohmbench.loops
import ohmbench.modes
import ohmbench.small
import ohmbench.traffic_parts
import test_ohmbench_control as checks
from ohmbench import find, generator, run
from conftest import SMALL

#: SHA-256 of the reference's map (every tensor of ``replay``, keys sorted)
#: over the whole small pool of seed 41: in the configuration's
#: precisions, geometry in float32, values in bfloat16; taken with
#: ``run.make_reference`` as it stood before the modes.
REFERENCE_SHA256 = {
    "occ-box-stream": (
        "bf926536faade5e681543f467cfb221526511c6f70c34a2eaeab3722ae339a8c",
        "0962e36205ef4e8f03b6d91a5f3befcd2936d929c64ada0b62b37bb4d96f8f26",
        "dee754457c56df24067c7a2508dfe6561e4bc8a3cd5d94aedfc732da130bb8c6"),
    "ndt-box-stream": (
        "fa37b4bfb4d73676306419967959da19a4de3ba7ac63296121707369daae59b4",
        "3e94a5de0bc26ae6d093d6843411eb7335b0b529a2f2763c13d30f15533eb543",
        "c56720be750fe9920ee35f8be5c6baa8e43ce790147789b318ba673910113520"),
}
PRECISIONS = ((None, None), (torch.float32, torch.float32), (torch.float64, torch.bfloat16))


def digest(maps: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(maps):
        h.update(k.encode())
        h.update(maps[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def program_map_before(m, config, device):
    """``run.program_map`` as it stood before the modes."""
    from ohmbench.reference import compare

    layers = {"occupancy": (m.layer_index("occupancy"), ("occupancy",))}
    if config["mode"] == "ndt":
        layers["mean"] = (m.layer_index("mean"), ("coord", "count"))
        layers["covariance"] = (m.layer_index("covariance"), compare.COV_KEYS)
    chunks = {key: {f"{name}.{member}": c.layers[index][member]
                    for name, (index, members) in layers.items() for member in members}
              for key, c in m.chunks.items()}
    return compare.read_map(chunks, config["region_dim"], config["resolution"], device)


@pytest.mark.parametrize("workload", sorted(REFERENCE_SHA256))
def test_modes_give_the_maps_run_py_gave(workload):
    _, config, mix, _ = run.load_cell(workload, SMALL[workload])
    mode = find("modes", config["mode"])
    pool = generator.make_pool(mix, 41, "cpu")
    seq = list(range(len(pool)))
    for (geometry, values), expect in zip(PRECISIONS, REFERENCE_SHA256[workload]):
        ref = mode.make_reference(config, geometry, values)
        ref.walk_batches(lambda i: torch.from_numpy(pool[i]), seq)
        assert digest(ref.replay(seq)) == expect, (geometry, values)
    m, mapper = run.build_mapper(config, "cpu")
    for b in pool:
        mapper.integrate_rays_async(b)
    mapper.flush()
    mapper.sync_voxels()
    got, before = mode.program_map(m, config, "cpu"), program_map_before(m, config, "cpu")
    assert sorted(got) == sorted(before)
    assert all(torch.equal(got[k], before[k]) for k in got)


#: ``reference.compare.compare``'s result on a small CPU run of each cell at
#: seed 41 (the warm-up and six window batches, each through
#: ``integrate_rays``), taken before each mode brought its own ``compare``.
COMPARED_BEFORE = {
    "occ-box-stream": {
        "voxel_mismatch_share": {"voxels": 170487, "mismatched": 6, "status_differs": 6,
                                 "worst_abs_diff": 0.0}},
    "ndt-box-stream": {
        "voxel_mismatch_share": {"voxels": 1327, "mismatched": 0, "status_differs": 0,
                                 "worst_abs_diff": 1.9550323486328125e-05},
        "ndt_mismatch_share": {"voxels": 575, "mismatched": 0, "count_differs": 0,
                               "worst_mean_steps": 1.0000000139552867,
                               "worst_cov_share": 0.0029868029593085195}},
    "occ-survey-stream": {
        "voxel_mismatch_share": {"voxels": 39575, "mismatched": 0, "status_differs": 0,
                                 "worst_abs_diff": 0.0}},
}


@pytest.mark.parametrize("workload", sorted(COMPARED_BEFORE))
def test_modes_compare_as_compare_py_did(workload):
    _, config, mix, _ = run.load_cell(workload, SMALL[workload])
    mode = find("modes", config["mode"])
    pool = run.Pool(generator.make_pool(mix, 41, "cpu"), mix["batching"]["cycle"])
    seq = pool.plan(mix["warmup"], 6)
    m, mapper = run.build_mapper(config, "cpu")
    for i in seq:
        mapper.integrate_rays(pool.batches[i])
    mapper.sync_voxels()
    prog = mode.program_map(m, config, "cpu")
    ref = mode.make_reference(config)
    ref.walk_batches(lambda i: torch.from_numpy(pool.batches[i]), seq)
    got = mode.compare(prog, ref.replay(seq), config["resolution"])
    assert got == COMPARED_BEFORE[workload]
    assert list(got) == list(COMPARED_BEFORE[workload])


#: A mode that compares one number more than occupancy does.
MODE = '''
from ohmbench.modes import occupancy

NUMBERS = occupancy.NUMBERS + ("empty_map",)
VALUE_LAYERS = occupancy.VALUE_LAYERS
compare = occupancy.compare
CALLS = []


def make_reference(config, geometry=None, values=None):
    CALLS.append("reference")
    return occupancy.make_reference(config, geometry, values)


def program_map(m, config, device):
    CALLS.append("program_map")
    return occupancy.program_map(m, config, device)


def counted(stats):
    return {"empty_map": int(stats["rays"] == 0)}
'''
#: A scene: the inside of a sphere of ``radius_m`` about the origin.
SCENE = '''
import torch

CALLS = []


def cast(scene, origins, dirs):
    CALLS.append(origins.shape[0])
    b = (origins * dirs).sum(dim=1)
    c = (origins * origins).sum(dim=1) - scene["radius_m"] ** 2
    return -b + torch.sqrt(b * b - c)
'''
#: ohmpop's synchronous client: a fixed number of batches through
#: ``integrate_rays``, each returning when its batch is in the map.
LOOP = '''
import time


def drive_window(mapper, pool, seconds, sync, loop):
    first = len(pool.sequence)
    t0 = time.perf_counter()
    rays = 0
    for _ in range(loop["batches"]):
        i = pool.take()
        mapper.integrate_rays(pool.batches[i])
        rays += pool.batches[i].shape[0] // 2
    sync()
    t1 = time.perf_counter()
    return {"start": t0, "end": t1, "seconds": t1 - t0, "rays": rays,
            "batches": pool.sequence[first:], "pool_spent": False,
            "host_by_second": {}}
'''


def test_a_mode_scene_and_loop_added_as_files_carry_a_cell(tmp_path, monkeypatch):
    files = {"modes": ("plugmode", MODE), "traffic_parts": ("scene_plugsphere", SCENE),
             "loops": ("plugsync", LOOP)}
    for package, (name, text) in files.items():
        (tmp_path / package).mkdir()
        (tmp_path / package / f"{name}.py").write_text(textwrap.dedent(text))
        pkg = getattr(ohmbench, package)
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(tmp_path / package)])
    over = {"config": {**SMALL["occ-box-stream"]["config"], "mode": "plugmode"},
            "traffic": {**SMALL["occ-box-stream"]["traffic"],
                        "scene": {"kind": "plugsphere", "radius_m": 8.0},
                        "loop": {"kind": "plugsync", "batches": 5}},
            "limits": {"empty_map": 0}}
    try:
        out = run.run_cell("occ-box-stream", 53, 1.0, False, device="cpu", overrides=over)
        mode = sys.modules["ohmbench.modes.plugmode"]
        scene = sys.modules["ohmbench.traffic_parts.scene_plugsphere"]
        assert out["correct"], out["checks"]
        assert set(out["checks"]) == set(mode.NUMBERS)
        assert out["checks"]["empty_map"]["value"] == 0
        assert out["attempted"] == 5 * 256
        assert mode.CALLS == ["program_map", "reference"] and scene.CALLS
    finally:
        for name in ("ohmbench.modes.plugmode", "ohmbench.traffic_parts.scene_plugsphere",
                     "ohmbench.loops.plugsync"):
            sys.modules.pop(name, None)


#: A mode that compares only NDT-OM's sampled voxels (their counts, means
#: and covariances), with no ``voxel_mismatch_share``, and whose planted
#: fault alters the covariance layer.
COV_MODE = '''
from ohmbench.modes import ndt
from ohmbench.reference.compare import ndt_mismatch

NUMBERS = ("ndt_mismatch_share", "rays_lost", "ndt_overflow")
VALUE_LAYERS = ("cov",)
make_reference = ndt.make_reference
program_map = ndt.program_map
counted = ndt.counted


def compare(prog, ref, resolution):
    return {"ndt_mismatch_share": ndt_mismatch(prog, ref, resolution)}
'''
#: The new cell's files: its configuration (NDT-OM under the plug mode),
#: its limits and its small size, the NDT cell's.
COV_CELL = {"name": "ndtcov-box-stream", "config": "ohmpop-ndtcov", "traffic": "box-stream",
            "chips": 1}


def test_a_mode_with_its_own_comparison_and_a_new_cell_added_as_files_carry_the_cell(
        tmp_path, monkeypatch):
    ndt_small = ohmbench.small.load("ndt-box-stream")
    files = {
        "modes/plugcov.py": textwrap.dedent(COV_MODE),
        "configs/ohmpop-ndtcov.json": json.dumps(
            {**run.load_json("configs", "ohmpop-ndt.json"), "mode": "plugcov"}),
        "limits/ndtcov-box-stream.json": json.dumps(
            {"ndt_mismatch_share": 1e-4, "rays_lost": 0, "ndt_overflow": 0}),
        "small/ndtcov-box-stream.json": json.dumps(
            {"why": "the NDT cell's small size",
             "overrides": {"cell": COV_CELL, **ndt_small["overrides"]},
             "failing_controls": ndt_small["failing_controls"]}),
    }
    for name, text in files.items():
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_text(text)
    # Modes and small files are found along their packages' paths; the
    # configuration and the limits through run.load_json, here with the
    # temporary directory beside ohmbench/.
    for pkg in (ohmbench.modes, ohmbench.small):
        directory = str(tmp_path / pkg.__name__.split(".")[-1])
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, directory])
    real_load_json = run.load_json

    def load_json(*parts):
        path = tmp_path.joinpath(*parts)
        return json.loads(path.read_text()) if path.exists() else real_load_json(*parts)

    monkeypatch.setattr(run, "load_json", load_json)
    name = COV_CELL["name"]
    try:
        out = checks.sound_run_is_correct(name, False)
        assert set(out["checks"]) == set(sys.modules["ohmbench.modes.plugcov"].NUMBERS)
        checks.control_fails(name, 31)
        for fault in checks.FAULTS:
            with monkeypatch.context() as m:
                checks.fault_is_not_correct(name, fault, m)
    finally:
        sys.modules.pop("ohmbench.modes.plugcov", None)
