"""The plain PyTorch versions of the NDT path's kernels against the JAX
package's Pallas kernels in interpret mode:

  K3  deposit_and_sweep_ndt, with the miss delta as a sparse stream and as
      a dense plane, a masked walk stream (the reference's bounds stream is
      the unmasked one) and a second end/sample stream: occupancy bits and
      the touched count identical over [0, sentinel]
  K4  gather_plane over a sorted id stream with sentinel padding: identical
  K1  expand_keys with_vox: keys identical, voxel planes identical on every
      lane whose key is not the sentinel (the reference's contract)

Shapes follow tests/test_pallas_deposit.py: 16 slots of 8^3 voxels."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.ops import deposit_pallas, expand_pallas
from ohm_tpu.ops.integrate import IntegrateConfig as RefConfig
from ohm_tpu.ops.integrate import _unpack_batch
from ohm_tpu_torch.ops import deposit_cuda, expand_cuda, gather_cuda
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.wire import unpack_batch

BASE = dict(resolution=0.1, region_shift=3, capacity=16, max_steps=64,
            hit_value=0.85, miss_value=-0.15, occupancy_threshold=0.0,
            min_value=-10.0, max_value=12.0)


def _cfgs(**kw):
    kw = {**BASE, **kw}
    return RefConfig(scatter_pad=8192, pallas_deposit=2, **kw), IntegrateConfig(**kw)


def _streams(cfg, seed, n=6000):
    """Sorted walk ids (flat << 1; 5% sentinel), the same stream with a
    fifth of it masked to the sentinel, and 500 sorted end keys (60% hits)."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, cfg.capacity * 2 // 3, n)
    flat = slots * cfg.voxels_per_region + rng.integers(0, cfg.voxels_per_region, n)
    hot = rng.random(n) < 0.3
    flat[hot] = (slots[hot] * 7) % cfg.sentinel
    flat[rng.random(n) < 0.05] = cfg.sentinel
    bounds = np.sort(flat << 1).astype(np.int32)
    walk = np.where(rng.random(n) < 0.2, cfg.sentinel << 1, bounds).astype(np.int32)
    end_flat = rng.integers(0, cfg.sentinel, 500)
    end_flat[:20] = cfg.sentinel
    end = np.sort((end_flat << 1) | (rng.random(500) < 0.6)).astype(np.int32)
    return bounds, walk, end


def _arena(cfg, seed):
    """+inf (unobserved), free, occupied and clamped voxels, in the
    reference arena's padded length."""
    n = -(-(cfg.sentinel + 1 + cfg.scatter_pad) // 512) * 512
    rng = np.random.default_rng(seed)
    occ = np.full(n, np.inf, np.float32)
    seeded = rng.integers(0, cfg.sentinel, cfg.sentinel // 2)
    occ[seeded] = rng.normal(0.0, 5.0, seeded.size).astype(np.float32)
    occ[seeded[:40]] = np.float32(cfg.max_value)
    occ[seeded[40:80]] = np.float32(cfg.min_value)
    return occ


def _deltas(cfg, bounds, n_arena, seed):
    """A dense delta plane and its sparse stream: one value per voxel at its
    last record, zero-valued duplicates, some zero values, sentinel tail."""
    rng = np.random.default_rng(seed)
    ids = bounds >> 1
    dk = np.unique(rng.choice(ids[ids < cfg.sentinel], 300))
    dv = rng.normal(0.0, 0.5, dk.size).astype(np.float32)
    dv[:20] = 0.0
    plane = np.zeros(n_arena, np.float32)
    plane[dk] = dv
    sk = np.sort(np.concatenate([dk, dk[: dk.size // 2],
                                 np.full(17, cfg.sentinel)])).astype(np.int32)
    sv = np.zeros(sk.size, np.float32)
    last = np.concatenate([sk[1:] != sk[:-1], [True]]) & (sk < cfg.sentinel)
    lut = dict(zip(dk.tolist(), dv.tolist()))
    sv[last] = [lut[int(k)] for k in sk[last]]
    return plane, (sk << 1, sv)


@pytest.mark.parametrize("form", ["sparse", "dense"])
@pytest.mark.parametrize("saturation", [None, (-4.0, 4.0)])
def test_ndt_deposit_plain_matches_pallas_interpret(form, saturation):
    extra = {} if saturation is None else dict(saturation_min=saturation[0],
                                               saturation_max=saturation[1])
    ref_cfg, cfg = _cfgs(**extra)
    bounds, walk, end = _streams(ref_cfg, seed=3)
    occ = _arena(ref_cfg, seed=4)
    plane, (sk, sv) = _deltas(ref_cfg, bounds, occ.shape[0], seed=5)
    if form == "sparse":
        delta_j, delta_p = (jnp.asarray(sk), jnp.asarray(sv)), (torch.from_numpy(sk),
                                                                torch.from_numpy(sv))
    else:
        delta_j, delta_p = jnp.asarray(plane), torch.from_numpy(plane.copy())
    ref_occ, ref_touched = deposit_pallas.deposit_and_sweep_ndt(
        jnp.asarray(occ), jnp.asarray(walk), delta_j, ref_cfg, interpret=True,
        bounds_key=jnp.asarray(bounds), key2_sorted=jnp.asarray(end))
    n = cfg.sentinel + 1
    port_occ, port_touched = deposit_cuda.deposit_and_sweep_ndt(
        torch.from_numpy(occ[:n].copy()), torch.from_numpy(walk), torch.from_numpy(end),
        delta_p, cfg)
    a = np.asarray(ref_occ)[:n].view(np.uint32)
    b = port_occ.numpy().view(np.uint32)
    assert np.array_equal(a, b), np.flatnonzero(a != b)[:10]
    assert int(port_touched) == int(ref_touched) > 0
    assert b[cfg.sentinel] == np.float32(np.inf).view(np.uint32)  # never written
    assert (b != occ[:n].view(np.uint32)).sum() > 100


def test_ndt_deposit_delta_alone_sweeps_and_is_not_touched():
    """A voxel with a delta and no counts is swept but not counted as
    touched; a zero delta leaves its voxel alone; saturated voxels keep
    their value."""
    _, cfg = _cfgs(saturation_max=11.0)
    occ = torch.full((cfg.sentinel + 1,), float("inf"))
    occ[:4] = torch.tensor([1.0, 1.0, 11.5, 2.0])
    empty = torch.zeros(0, dtype=torch.int32)
    keys = torch.tensor([0, 1 << 1, 2 << 1, 3 << 1, cfg.sentinel << 1], dtype=torch.int32)
    vals = torch.tensor([-0.5, 0.0, -0.5, 0.25, 3.0])
    out, touched = deposit_cuda.deposit_and_sweep_ndt(occ, empty, empty, (keys, vals), cfg)
    assert out[:4].tolist() == [0.5, 1.0, 11.5, 2.25]
    assert int(touched) == 0
    assert torch.isposinf(out[4:]).all()


def test_gather_plain_matches_pallas_interpret():
    ref_cfg, cfg = _cfgs()
    rng = np.random.default_rng(9)
    n_arena = -(-(ref_cfg.sentinel + 1 + ref_cfg.scatter_pad) // 512) * 512
    plane = rng.integers(-3, 4, n_arena).astype(np.int8)
    ids = np.concatenate([np.sort(rng.integers(0, cfg.sentinel, 2500)),
                          np.full(300, cfg.sentinel)]).astype(np.int32)
    ref = np.asarray(deposit_pallas.gather_plane(jnp.asarray(plane), jnp.asarray(ids),
                                                 ref_cfg, interpret=True))
    port = gather_cuda.gather_plane(torch.from_numpy(plane), torch.from_numpy(ids),
                                    cfg.sentinel)
    assert port.dtype == torch.int32
    assert np.array_equal(ref, port.numpy())
    assert (port.numpy()[-300:] == 0).all() and np.abs(port.numpy()).sum() > 0


def _scene(n=96, seed=13):
    """tests/test_expand_pallas.py's scene: random rays, exact-corner
    diagonals from the origin, axis-aligned rays."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lengths = rng.uniform(0.25, 5.0, n)
    origins = rng.uniform(-0.8, 0.8, (n, 3))
    dirs[:8] = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    origins[:8] = 0.0
    dirs[8:12] = np.eye(3)[[0, 1, 2, 0]]
    rays = np.zeros((2 * n, 3))
    rays[0::2] = origins
    rays[1::2] = origins + dirs * lengths[:, None]
    return rays


@pytest.mark.parametrize("flags", [0, int(RayFlag.EXCLUDE_ORIGIN)])
def test_expand_voxel_planes_match_pallas_interpret(flags):
    m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    wire, jcfg, _ = TpuRayMapper(m, capacity=64, rayflow=True)._rayflow_setup_host(
        _scene(), None, None, flags)
    excl = bool(flags & RayFlag.EXCLUDE_ORIGIN)
    ref_key, _, ref_aux = expand_pallas.expand_keys(
        _unpack_batch({"rayw": jnp.asarray(wire)}, jcfg), jcfg, exclude_origin=excl,
        with_vox=True, interpret=True)
    names = [f.name for f in dataclasses.fields(IntegrateConfig)]
    cfg = IntegrateConfig(**{k: getattr(jcfg, k) for k in names})
    key, aux = expand_cuda.expand_keys(unpack_batch(torch.from_numpy(wire), cfg), cfg,
                                       exclude_origin=excl, with_vox=True)
    ref_key = np.asarray(ref_key)
    assert np.array_equal(ref_key, key.numpy())
    assert int(ref_aux["missed_n"]) == int(aux["missed_n"])
    live = ref_key != cfg.sentinel
    assert live.sum() > 1000
    assert aux["vox"].shape == (key.shape[0], key.shape[1], 3)
    assert np.array_equal(np.asarray(ref_aux["vox"])[live], aux["vox"].numpy()[live])
