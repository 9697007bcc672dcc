"""The modes (``ohmbench/modes``) give the maps that ``run.py`` gave before
they moved into files of their own, on a small CPU run of each box cell;
and a mode, a scene and a client loop added as files alone carry a cell
through ``run.run_cell`` with no edit to ``run.py`` or ``generator.py``."""

import hashlib
import sys
import textwrap

import pytest
import torch

import ohmbench
import ohmbench.loops
import ohmbench.modes
import ohmbench.traffic_parts
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


#: A mode that compares one number more than occupancy does.
MODE = '''
from ohmbench.modes import occupancy

NUMBERS = occupancy.NUMBERS + ("empty_map",)
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
