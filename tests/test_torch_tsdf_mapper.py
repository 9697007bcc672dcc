"""TorchTsdfMap on the CPU against TpuTsdfMap on the rayflow wire, and
against the f64 oracle RayMapperTsdf (the port's own copy).

The JAX side runs two ways: with its kernels in interpret mode
(OHM_PALLAS=2, OHM_EXPAND=2: the branch the JAX package takes on a TPU, with
the seed gather and the pair deposit), and on its XLA branch with
``scatter_cap=0`` (the full-stream seed gather and unique scatter).  Region
dims 8 (V = 512, which the reference's deposit kernels need), 0.25 m voxels.

Scenarios (each run once per module on every side):

  mixed       tests/test_tsdf.py's per-visit scene of near and far walls,
              whose voxels' record sdfs straddle the truncation band
  saturation  tests/test_tsdf.py's tight cone with max_weight 3: voxels
              saturate in the middle of a batch, and the second batch starts
              from saturated seeds
  per_batch   per_visit=False on a sphere scene: one blend and truncation
              per voxel and batch
  sparsity    a sparsity compensation factor of 0.5: non-uniform weights
              ride the sorts as payloads

Against TpuTsdfMap: the wire bytes, the per-batch stats (touched,
missed_updates, overflow, compaction_dropped, dropped_updates) and the
weights are equal, bit for bit, in the device arena and the host map;
distances agree within atol = rtol = 1e-5 (XLA's CPU backend contracts the
sdf dot product, the visit maps and the composition's a2*b1 + b2 into FMAs;
the port rounds each op, as the TPU does).  Under per_visit=False the
per-voxel sum of w*sdf is a blocked segment sum whose in-row cumulative sum
of up to 1024 records with |sdf| <= 2 m stays below 2048 (one ulp there is
1.2e-4), so a last-bit sdf difference moves a distance by up to two such
ulps: there the jitted reference is held to atol 2.5e-4, and the XLA branch
run op by op (``jax.disable_jit``, no contraction) to the same bits.  Against the oracle: tests/test_tsdf.py's
compare_tsdf at atol 5e-3."""

import jax
import numpy as np
import pytest

import ohm_tpu.mapping.tsdf_map as ref_tsdf_map
import ohm_tpu_torch.mapping.tsdf_map as port_tsdf_map
from ohm_tpu.core.layout import TSDF_LAYER
from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.mapping.tsdf_map import TpuTsdfMap
from ohm_tpu.oracle.tsdf import TsdfOptions as RefOptions
from ohm_tpu_torch import TorchTsdfMap
from ohm_tpu_torch.core.map import MapFlag as PortMapFlag
from ohm_tpu_torch.core.map import OccupancyMap as PortMap
from ohm_tpu_torch.oracle.tsdf import RayMapperTsdf, TsdfOptions

STATS = ("touched", "missed_updates", "overflow", "compaction_dropped", "dropped_updates")
TOL = dict(atol=1e-5, rtol=1e-5)
BLOCKED_SUM_TOL = dict(atol=2.5e-4, rtol=0)  # two ulps of an in-row cumsum < 2048
BRANCHES = {"kernels": dict(env="2", scatter_cap="auto"), "xla": dict(env="0", scatter_cap=0)}


def _sphere(n, rng, radius=2.0):
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * radius
    return rays


def _mixed(rng, n=96):
    """Near samples at 0.6 m and far ones at 6 m through one forward cone."""
    dirs = rng.normal(size=(n, 3))
    dirs[:, 0] = np.abs(dirs[:, 0]) + 2.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * np.where(np.arange(n) % 2 == 0, 0.6, 6.0)[:, None]
    return rays


def _cone(rng, n=128):
    """A tight cone: every ray crosses the same first voxels."""
    dirs = rng.normal(size=(n, 3)) * np.array([0.05, 1.0, 0.2])
    dirs[:, 1] = np.abs(dirs[:, 1]) + 4.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = np.zeros((2 * n, 3))
    rays[1::2] = dirs * rng.uniform(1.5, 3.5, n)[:, None]
    return rays


def _scenarios():
    rng = np.random.default_rng(99)
    mixed = _mixed(rng)
    cone = _cone(np.random.default_rng(41))
    sphere = _sphere(300, np.random.default_rng(12))
    return {
        "mixed": dict(batches=[mixed] * 3, capacity=128,
                      options=dict(default_truncation_distance=0.3)),
        "saturation": dict(batches=[cone] * 2, capacity=64,
                           options=dict(default_truncation_distance=0.4, max_weight=3.0)),
        "per_batch": dict(batches=[sphere[i:i + 200] for i in range(0, 600, 200)], capacity=64,
                          options=dict(default_truncation_distance=0.3, per_visit=False)),
        "sparsity": dict(batches=[sphere[i:i + 200] for i in range(0, 600, 200)], capacity=64,
                         options=dict(default_truncation_distance=0.3,
                                      sparsity_compensation_factor=0.5)),
    }


class _Recorder:
    """Each batch's stats and wire bytes of one mapper."""

    def __init__(self):
        self.stats, self.wires = [], []


def _run_reference(spec, branch):
    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OHM_PALLAS", BRANCHES[branch]["env"])
        mp.setenv("OHM_EXPAND", BRANCHES[branch]["env"])
        m = OccupancyMap(resolution=0.25, region_voxel_dims=8, flags=MapFlag.NONE)
        ref = TpuTsdfMap(m, RefOptions(**spec["options"]), capacity=spec["capacity"],
                         validate=True, scatter_cap=BRANCHES[branch]["scatter_cap"])
        ref.rayflow = True
        inner_jit, inner_dispatch = ref_tsdf_map.integrate_tsdf_jit, ref._dispatch_rayflow

        def jit(arena, batch, cfg):
            out = inner_jit(arena, batch, cfg)
            rec.stats.append({k: int(out[1][k]) for k in STATS})
            return out

        def dispatch(batch, base_cfg, n_rays, flags):
            rec.wires.append(np.array(batch["rayw"]))
            return inner_dispatch(batch, base_cfg, n_rays, flags)

        mp.setattr(ref_tsdf_map, "integrate_tsdf_jit", jit)
        ref._dispatch_rayflow = dispatch
        ref.prime_caps(spec["batches"])
        for rays in spec["batches"]:
            ref.integrate_rays(rays)
        arena = {k: np.asarray(v) for k, v in ref.arena.arrays.items()}
        ref.sync_voxels()
    return {"map": m, "stats": ref.stats, "rec": rec, "arena": arena}


def _run_port(spec):
    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        m = PortMap(resolution=0.25, region_voxel_dims=8, flags=PortMapFlag.NONE)
        port = TorchTsdfMap(m, TsdfOptions(**spec["options"]), capacity=spec["capacity"],
                            validate=True, device="cpu", rayflow=True)
        inner, inner_dispatch = port_tsdf_map.integrate_tsdf, port._dispatch

        def integrate(arena, b, cfg):
            out = inner(arena, b, cfg)
            rec.stats.append({k: int(out[k]) for k in STATS})
            return out

        def dispatch(wire, cfg, n_rays):
            rec.wires.append(wire.numpy().copy())
            return inner_dispatch(wire, cfg, n_rays)

        mp.setattr(port_tsdf_map, "integrate_tsdf", integrate)
        port._dispatch = dispatch
        port.prime_caps(spec["batches"])
        for rays in spec["batches"]:
            port.integrate_rays(rays)
        arena = {k: v.numpy().copy() for k, v in port.arena.layers.items()}
        port.sync_voxels()
    return {"map": m, "stats": port.stats, "rec": rec, "arena": arena}


def _run_oracle(spec):
    m = PortMap(resolution=0.25, region_voxel_dims=8, flags=PortMapFlag.NONE)
    oracle = RayMapperTsdf(m, TsdfOptions(**spec["options"]))
    for rays in spec["batches"]:
        oracle.integrate_rays(rays)
    return m


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, spec in _scenarios().items():
        out[name] = {"port": _run_port(spec), "oracle": _run_oracle(spec)}
        for branch in BRANCHES:
            out[name][branch] = _run_reference(spec, branch)
        if name == "per_batch":
            with jax.disable_jit():
                out[name]["op_by_op"] = _run_reference(spec, "xla")
    return out


SCENARIOS = ("mixed", "saturation", "per_batch", "sparsity")
CASES = [(name, branch) for name in SCENARIOS for branch in BRANCHES]


def _distance_tol(name):
    return BLOCKED_SUM_TOL if name == "per_batch" else TOL


def _tsdf(m) -> dict:
    idx = m.layer_index(TSDF_LAYER)
    return {k: (np.array(c.layers[idx]["weight"]), np.array(c.layers[idx]["distance"]))
            for k, c in m.chunks.items()}


@pytest.mark.parametrize("name,branch", CASES)
def test_wires_and_batch_stats_equal(runs, name, branch):
    ref, port = runs[name][branch], runs[name]["port"]
    assert len(ref["rec"].wires) == len(port["rec"].wires) > 0
    for a, b in zip(ref["rec"].wires, port["rec"].wires):
        assert np.array_equal(a, b)
    assert ref["rec"].stats == port["rec"].stats
    assert all(s["touched"] > 0 for s in port["rec"].stats)
    for k in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        assert port["stats"][k] == ref["stats"][k] == 0, k


@pytest.mark.parametrize("name,branch", CASES)
def test_arenas_agree(runs, name, branch):
    """The device planes before the host sync, over [0, sentinel]: weights
    bit for bit, distances within 1e-5."""
    ref, port = runs[name][branch]["arena"], runs[name]["port"]["arena"]
    n = port["tsdf_weight"].shape[0]
    wa, wb = ref["tsdf_weight"][:n], port["tsdf_weight"]
    assert np.array_equal(wa.view(np.uint32), wb.view(np.uint32))
    assert (wb > 0).sum() > 40
    np.testing.assert_allclose(port["tsdf_distance"], ref["tsdf_distance"][:n],
                               **_distance_tol(name))


@pytest.mark.parametrize("name,branch", CASES)
def test_host_maps_agree(runs, name, branch):
    ref, port = _tsdf(runs[name][branch]["map"]), _tsdf(runs[name]["port"]["map"])
    assert ref.keys() == port.keys()
    for key in ref:
        assert np.array_equal(ref[key][0], port[key][0]), key
        np.testing.assert_allclose(port[key][1], ref[key][1], **_distance_tol(name))


def test_per_batch_bit_identical_to_the_reference_op_by_op(runs):
    """Without XLA's contractions the per_visit=False arithmetic is the
    reference's, op for op: both planes give the same bits."""
    ref, port = runs["per_batch"]["op_by_op"], runs["per_batch"]["port"]
    assert ref["rec"].stats == port["rec"].stats
    n = port["arena"]["tsdf_weight"].shape[0]
    for layer in ("tsdf_weight", "tsdf_distance"):
        a, b = ref["arena"][layer][:n], port["arena"][layer]
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), layer
    assert (port["arena"]["tsdf_weight"] > 0).sum() > 100


@pytest.mark.parametrize("name", SCENARIOS)
def test_port_matches_oracle(runs, name):
    """tests/test_tsdf.py's compare_tsdf: weights within rtol 1e-5 / atol
    1e-4 and distances within 5e-3 on every voxel either side touched."""
    oracle, port = _tsdf(runs[name]["oracle"]), _tsdf(runs[name]["port"]["map"])
    assert oracle.keys() <= port.keys()
    checked = 0
    for key, (wa, da) in oracle.items():
        wb, db = port[key]
        active = (wa > 0) | (wb > 0)
        np.testing.assert_allclose(wa[active], wb[active], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(da[active], db[active], atol=5e-3)
        checked += int(active.sum())
    assert checked > 40


def test_saturation_binds_mid_batch(runs):
    """The cone's shared voxels reach max_weight within the first batch."""
    w = runs["saturation"]["port"]["arena"]["tsdf_weight"]
    assert (w == np.float32(3.0)).sum() > 0 and w.max() == np.float32(3.0)
