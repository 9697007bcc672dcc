"""The expand phase of the PyTorch port (kernel K1's plain version:
ops.ddawalk.walk_rays_unordered + ops.integrate.resolve_slots + masking,
then the end records and group compaction) against the JAX package's
expand_records on the same wire: the whole key stream bit for bit, and
every stat.  The scenes hold exact-corner and axis-aligned rays (walk
ties), and one case corrupts candidates so that records miss."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.ops import expand_pallas
from ohm_tpu.ops.integrate import _unpack_batch, expand_records_jit
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.expand_cuda import expand_keys, expand_keys_reference
from ohm_tpu_torch.ops.integrate import expand_records
from ohm_tpu_torch.ops.wire import unpack_batch

STATS = ("missed_updates", "overflow", "compaction_dropped")


def _scene(n=192, seed=7, spread=5.0):
    """tests/test_expand_pallas.py's scene: random rays, 8 exact-corner
    diagonals from the origin and 4 axis-aligned rays."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lengths = rng.uniform(0.25, spread, n)
    origins = rng.uniform(-0.8, 0.8, (n, 3))
    dirs[:8] = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    origins[:8] = 0.0
    dirs[8:12] = np.eye(3)[[0, 1, 2, 0]]
    rays = np.zeros((2 * n, 3))
    rays[0::2] = origins
    rays[1::2] = origins + dirs * lengths[:, None]
    return rays


def _wire(rays, flags=0):
    m = OccupancyMap(resolution=0.1, flags=MapFlag.NONE)
    wire, cfg, _ = TpuRayMapper(m, capacity=64, rayflow=True)._rayflow_setup_host(
        rays, None, None, flags)
    assert cfg.unordered_walk and cfg.group_cap and cfg.table_k
    return wire, cfg


def _port_cfg(jcfg):
    names = [f.name for f in dataclasses.fields(IntegrateConfig)]
    return IntegrateConfig(**{k: getattr(jcfg, k) for k in names})


def _compare(ref_out, ref_stats, port_out, port_stats):
    a = np.asarray(ref_out["key"])
    b = port_out["key"].numpy()
    assert a.dtype == b.dtype == np.int32
    assert np.array_equal(a, b), np.flatnonzero(a != b)[:10]
    for k in STATS:
        assert int(ref_stats[k]) == int(port_stats[k]), k


@pytest.mark.parametrize("flags", [0, int(RayFlag.EXCLUDE_ORIGIN),
                                   int(RayFlag.EXCLUDE_SAMPLE),
                                   int(RayFlag.EXCLUDE_RAY)])
def test_expand_records_bit_identical(flags):
    wire, cfg = _wire(_scene(), flags)
    ref_out, ref_stats = expand_records_jit({"rayw": jnp.asarray(wire)},
                                            dataclasses.replace(cfg, pallas_expand=0))
    port_cfg = _port_cfg(cfg)
    port_out, port_stats = expand_records(unpack_batch(torch.from_numpy(wire), port_cfg),
                                          port_cfg)
    _compare(ref_out, ref_stats, port_out, port_stats)
    assert int(port_stats["compaction_dropped"]) == 0


def test_expand_counts_missed_records():
    """Drop candidate 0 of every other ray: records in that region resolve
    to no slot, become sentinels and are counted, identically."""
    wire, cfg = _wire(_scene(seed=11))
    ref_b = dict(_unpack_batch({"rayw": jnp.asarray(wire)}, cfg))
    ref_b["tcand"] = ref_b["tcand"].at[::2, 0].set(0)
    ref_out, ref_stats = expand_records_jit(ref_b, dataclasses.replace(cfg, pallas_expand=0))
    port_cfg = _port_cfg(cfg)
    port_b = unpack_batch(torch.from_numpy(wire), port_cfg)
    port_b["tcand"] = port_b["tcand"].clone()
    port_b["tcand"][::2, 0] = 0
    port_out, port_stats = expand_records(port_b, port_cfg)
    assert int(port_stats["missed_updates"]) > 0
    _compare(ref_out, ref_stats, port_out, port_stats)


def test_expand_matches_pallas_interpret():
    """The reference's Pallas expand kernel (interpret mode) gives the same
    key stream as the port."""
    wire, cfg = _wire(_scene(n=64, seed=3), int(RayFlag.EXCLUDE_ORIGIN))
    ref_out, ref_stats = expand_records_jit({"rayw": jnp.asarray(wire)},
                                            dataclasses.replace(cfg, pallas_expand=2))
    port_cfg = _port_cfg(cfg)
    port_out, port_stats = expand_records(unpack_batch(torch.from_numpy(wire), port_cfg),
                                          port_cfg)
    _compare(ref_out, ref_stats, port_out, port_stats)


def test_expand_keys_on_cpu_is_the_plain_version():
    wire, cfg = _wire(_scene(n=64, seed=5))
    port_cfg = _port_cfg(cfg)
    b = unpack_batch(torch.from_numpy(wire), port_cfg)
    flat, aux = expand_keys(b, port_cfg, exclude_origin=True)
    ref_flat, ref_missed = expand_keys_reference(b, port_cfg, exclude_origin=True)
    assert torch.equal(flat, ref_flat)
    assert int(aux["missed_n"]) == int(ref_missed) == 0
    assert flat.shape == (b["valid"].shape[0], 3 * port_cfg.max_steps)
    assert not bool(aux["overflow"].any())
    # The end voxel's enter time: max over axes of each axis's last event.
    assert bool((aux["end_enter"] >= 0).all())
    # The traversal output is its plain version's, bit for bit.
    flat_t, aux_t = expand_keys(b, port_cfg, exclude_origin=True, with_trav=True)
    trav = expand_keys_reference(b, port_cfg, exclude_origin=True, with_trav=True)[-1]
    assert torch.equal(flat_t, ref_flat)
    assert torch.equal(aux_t["trav"].view(torch.int32), trav.view(torch.int32))


EDGE_KINDS = ("on_walls", "zero_length", "axis_aligned", "invalid", "overflow", "denormal")

#: Denormal direction components: XLA's comparisons read them as zero.
DENORMALS = np.array([1e-40, -1e-40, 2.0**-149, -2.0**-149], np.float32)


def _edge_batch(b: dict, kind: str, S: int, resolution: float, n: int = 16) -> dict:
    """numpy copies of a batch's fields with its first ``n`` rays made
    ``kind``: starting exactly on the voxel wall they leave (e0 = +-0),
    of zero length (inv = 0), with a zero direction component on an axis
    they still cross (inv = +-3e38), invalid, crossing more than S walls
    on an axis, or with denormal direction components (+-1e-40, +-2^-149)
    on one axis, or on two for half of them, which they cross once
    (forwards or backwards; a quarter start on the wall)."""
    out = {k: np.array(v) for k, v in b.items()}
    half = np.float32(0.5) * np.float32(resolution)
    d, sf, sa, ea = out["direction"], out["start_frac"], out["start_abs"], out["end_abs"]
    if kind == "on_walls":
        sf[:n] = np.where(d[:n] < 0, -half, half)
    elif kind == "zero_length":
        out["length"][:n] = 0.0
        sf[:n // 2] = np.where(d[:n // 2] < 0, -half, half)
    elif kind == "axis_aligned":
        d[:n] = np.eye(3, dtype=np.float32)[np.arange(n) % 3]
        d[:n // 2] *= -1
        ea[:n, 1] = sa[:n, 1] + 2  # crosses an axis its direction does not move on
    elif kind == "invalid":
        out["valid"][:n] = False
        out["exclude_start"][:n] = False
    elif kind == "denormal":
        i = np.arange(n)
        d[:n, 1] = DENORMALS[i % 4]
        d[n // 2:n, 2] = DENORMALS[(i[n // 2:] + 1) % 4]
        ea[:n, 1] = sa[:n, 1] + np.where(i % 2 == 0, 1, -1)
        sf[:n // 4, 1] = half
    else:
        ea[:n, np.arange(n) % 3] = sa[:n, np.arange(n) % 3] + S + 1 + np.arange(n)
    return out


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_expand_aux_matches_pallas_interpret_on_edge_rays(kind):
    """The keys, missed count, overflow and the end voxel's enter time (the
    plain prelude on the CPU, which the kernel computes on the card) against
    the reference's Pallas expand_keys, bit for bit, on rays whose set-up
    hits the walk's edge cases."""
    wire, jcfg = _wire(_scene(n=64, seed=5))
    cfg = _port_cfg(jcfg)
    edge = _edge_batch(dict(_unpack_batch({"rayw": jnp.asarray(wire)}, jcfg)), kind,
                       cfg.max_steps, cfg.resolution)
    ref_key, _, ref_aux = expand_pallas.expand_keys(
        {k: jnp.asarray(v) for k, v in edge.items()}, jcfg, interpret=True)
    key, aux = expand_keys({k: torch.from_numpy(v) for k, v in edge.items()}, cfg)
    assert np.array_equal(np.asarray(ref_key), key.numpy())
    assert int(ref_aux["missed_n"]) == int(aux["missed_n"])
    ref_enter = np.asarray(ref_aux["end_enter"])
    assert np.array_equal(ref_enter.view(np.uint32), aux["end_enter"].numpy().view(np.uint32))
    assert np.array_equal(np.asarray(ref_aux["overflow"]), aux["overflow"].numpy())
    assert aux["overflow"].numpy()[:16].all() == (kind == "overflow")
    assert aux["overflow"].numpy()[16:].sum() == 0
    if kind == "invalid":
        assert (ref_enter[:16] == 0).all()
    if kind == "axis_aligned":
        assert (ref_enter[:16] > 1e30).all()  # e0 + dd on the still axis: ~1e37
    if kind == "denormal":
        # The denormal axis is still (inv = +3e38): its one event is at
        # e0 = (half - start_frac) * 3e38, 0 on the wall, ~1e37 or more
        # (inf on a second such axis it crosses) elsewhere; never NaN.
        assert not np.isnan(ref_enter[:16]).any() and (ref_enter[4:16] > 1e30).all()
