"""The occupancy mapper's side layers in the PyTorch port, op by op, against
the JAX package on the CPU: the touch-time block of the rayflow wire (bytes
and every decoded field), the incident-normal codec, the expand stream with
K1's traversal output (the plain version, beside the reference with its
Pallas expand kernel in interpret mode and without it) under each ray flag
that shapes it, and the sample-layer update, including a touch time at or
above 2^31.

Keys, stats, counts and touch times are exact.  Traversal follows
tests/test_expand_pallas.py: per record within rtol 2e-6 / atol 1e-6 where
the key is unique, per voxel sums alike (XLA's CPU backend contracts
e0 + count * dd into an FMA in jitted code; the port rounds each op)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ohm_tpu.core.map import MapFlag, OccupancyMap
from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.mapping.tpu_map import TpuRayMapper
from ohm_tpu.ops import subvoxel_jnp
from ohm_tpu.ops.integrate import IntegrateConfig as RefConfig
from ohm_tpu.ops.integrate import _apply_sample_layers, _unpack_batch, expand_records_jit
from ohm_tpu_torch import TorchRayMapper
from ohm_tpu_torch.core.map import MapFlag as PortMapFlag
from ohm_tpu_torch.core.map import OccupancyMap as PortMap
from ohm_tpu_torch.ops import subvoxel
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.expand_cuda import expand_keys, expand_keys_reference
from ohm_tpu_torch.ops.integrate import apply_sample_layers, expand_records
from ohm_tpu_torch.ops.wire import unpack_batch

STATS = ("missed_updates", "overflow", "compaction_dropped")
ALL_LAYERS = ("VOXEL_MEAN", "TRAVERSAL", "TOUCH_TIME", "INCIDENT_NORMAL")


def _flags(names, flag_cls):
    out = flag_cls.NONE
    for name in names:
        out |= getattr(flag_cls, name)
    return out


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


def _port_cfg(jcfg):
    names = [f.name for f in dataclasses.fields(IntegrateConfig)]
    return IntegrateConfig(**{k: getattr(jcfg, k) for k in names})


def _setups(layers, rays, timestamps=None, flags=0):
    """Both mappers' host setup of one batch on a map with ``layers``."""
    ref = TpuRayMapper(OccupancyMap(resolution=0.1, flags=_flags(layers, MapFlag)),
                       capacity=64, rayflow=True)
    port = TorchRayMapper(PortMap(resolution=0.1, flags=_flags(layers, PortMapFlag)),
                          capacity=64, device="cpu", rayflow=True)
    return (ref._rayflow_setup_host(rays, timestamps, None, flags),
            port._rayflow_setup_host(rays, timestamps, None, flags))


def _as_np(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("layers", [("TOUCH_TIME",), ALL_LAYERS])
def test_touch_wire_bytes_and_decode_match(layers):
    """A touch-time map's wire: the same bytes and config as TpuRayMapper's,
    and every decoded field bit for bit, touch times at and above 2^31 ms
    (25 days after the first ray) included."""
    rng = np.random.default_rng(3)
    rays = _scene(n=160, seed=4)
    stamps = 1000.0 + np.sort(rng.uniform(0.0, 3.0e6, 160))
    (w_ref, c_ref, n_ref), (w_port, c_port, n_port) = _setups(layers, rays, stamps)
    assert n_ref == n_port and np.array_equal(w_ref, w_port)
    names = [f.name for f in dataclasses.fields(IntegrateConfig)]
    assert {k: getattr(c_ref, k) for k in names} == dataclasses.asdict(c_port)
    assert c_port.with_touch_time
    ref = _unpack_batch({"rayw": jnp.asarray(w_ref)}, c_ref)
    port = unpack_batch(torch.from_numpy(w_port), c_port)
    for name, val in port.items():
        a, b = _as_np(ref[name]), _as_np(val.numpy())
        assert a.shape == b.shape, name
        assert np.array_equal(a, b.astype(a.dtype) if b.dtype != np.uint32 else b), name
    touch = port["touch_enc"].numpy().view(np.uint32)[port["valid"].numpy()]
    assert touch.max() >= 2**31 and touch.min() < 2**31


def test_wire_length_check_refuses_a_touch_mismatch():
    rays = _scene(n=64, seed=5)
    _, (wire, cfg, _) = _setups(("TOUCH_TIME",), rays, 5.0 + np.arange(64) * 1e-3)
    unpack_batch(torch.from_numpy(wire), cfg)
    with pytest.raises(ValueError, match="touch"):
        unpack_batch(torch.from_numpy(wire), dataclasses.replace(cfg, with_touch_time=False))
    _, (plain, pcfg, _) = _setups((), rays)
    with pytest.raises(ValueError, match="touch"):
        unpack_batch(torch.from_numpy(plain), dataclasses.replace(pcfg, with_touch_time=True))


def test_normal_codec_matches_subvoxel_jnp():
    """encode_normal / decode_normal against subvoxel_jnp run op by op, bit
    for bit: unit and non-unit vectors, components past +-1, zeros, -0.0,
    axis directions, and every flag-bit combination of the patterns."""
    rng = np.random.default_rng(21)
    n = rng.normal(size=(4000, 3)).astype(np.float32)
    n[:2000] /= np.linalg.norm(n[:2000], axis=1, keepdims=True)
    n[2000:2100] = 0.0
    n[2100:2106] = np.concatenate([np.eye(3), -np.eye(3)])
    n[2106:2110, 2] = -0.0
    n[2110:2200] *= 3.0
    with jax.disable_jit():
        ref = np.asarray(subvoxel_jnp.encode_normal(jnp.asarray(n)))
    port = subvoxel.encode_normal(torch.from_numpy(n)).numpy()
    assert np.array_equal(ref, port.view(np.uint32))
    patterns = np.concatenate([ref, rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32),
                               np.array([0, 1 << 30, 1 << 31, (1 << 31) | (1 << 30)], np.uint32)])
    with jax.disable_jit():
        dec_ref = np.asarray(subvoxel_jnp.decode_normal(jnp.asarray(patterns)))
    dec_port = subvoxel.decode_normal(torch.from_numpy(patterns.view(np.int32))).numpy()
    assert np.array_equal(dec_ref.view(np.uint32), dec_port.view(np.uint32))


FLAGS = [0, int(RayFlag.EXCLUDE_ORIGIN), int(RayFlag.EXCLUDE_SAMPLE), int(RayFlag.EXCLUDE_RAY),
         int(RayFlag.END_POINT_AS_FREE)]


def _compare_traversal(keys, a, b):
    """tests/test_expand_pallas.py's bounds: per record where the key is
    unique, and per voxel sums."""
    uniq, first_idx, counts = np.unique(keys, return_index=True, return_counts=True)
    solo = first_idx[counts == 1]
    np.testing.assert_allclose(a[solo], b[solo], rtol=2e-6, atol=1e-6)
    order = np.argsort(keys, kind="stable")
    bounds = np.flatnonzero(np.concatenate([[True], keys[order][1:] != keys[order][:-1]]))
    s_a = np.add.reduceat(a[order].astype(np.float64), bounds)
    s_b = np.add.reduceat(b[order].astype(np.float64), bounds)
    np.testing.assert_allclose(s_a, s_b, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("pallas_expand", [0, 2])
@pytest.mark.parametrize("flags", FLAGS)
def test_expand_stream_with_traversal(flags, pallas_expand):
    """expand_records on a traversal map against the reference's (its Pallas
    expand kernel in interpret mode, or its XLA walk chain): the key stream,
    the end records and the stats exactly, traversal at the bounds above."""
    (wire, cfg, _), _ = _setups(("TRAVERSAL",), _scene(n=128, seed=9), flags=flags)
    assert cfg.with_traversal and cfg.unordered_walk and cfg.group_cap
    ref_out, ref_stats = expand_records_jit(
        {"rayw": jnp.asarray(wire)}, dataclasses.replace(cfg, pallas_expand=pallas_expand))
    port_cfg = _port_cfg(cfg)
    out, stats = expand_records(unpack_batch(torch.from_numpy(wire), port_cfg), port_cfg)
    keys = np.asarray(ref_out["key"])
    assert np.array_equal(keys, out["key"].numpy())
    for name in ("end_flat", "end_is_hit"):
        assert np.array_equal(np.asarray(ref_out[name]), out[name].numpy()), name
    for k in STATS:
        assert int(ref_stats[k]) == int(stats[k]), k
    trav = out["trav"].numpy()
    assert trav.shape == keys.shape and trav.dtype == np.float32
    _compare_traversal(keys, np.asarray(ref_out["trav"]), trav)
    live = (keys >> 1) != port_cfg.sentinel
    assert np.all(trav[~live] == 0)
    if flags & RayFlag.EXCLUDE_RAY:
        assert not np.any(trav[:len(keys) - len(out["end_flat"])])  # the walk records
    else:
        assert trav[live].sum() > 100.0


def test_expand_keys_traversal_on_cpu_is_the_plain_version():
    """K1's wrapper with traversal (and voxel planes) on a CPU tensor is
    its plain version: keys, traversal and missed count bit for bit, the
    traversal 0 on every lane whose record is not valid."""
    _, (wire, cfg, _) = _setups(("TRAVERSAL",), _scene(n=64, seed=5))
    b = unpack_batch(torch.from_numpy(wire), cfg)
    flat, aux = expand_keys(b, cfg, exclude_origin=True, with_trav=True, with_vox=True)
    ref_flat, ref_missed, ref_vox, ref_trav = expand_keys_reference(
        b, cfg, exclude_origin=True, with_vox=True, with_trav=True)
    assert torch.equal(flat, ref_flat) and int(aux["missed_n"]) == int(ref_missed)
    assert torch.equal(aux["trav"].view(torch.int32), ref_trav.view(torch.int32))
    assert torch.equal(aux["vox"], ref_vox)
    assert bool((aux["trav"][flat == cfg.sentinel] == 0).all())
    assert bool((aux["trav"] >= 0).all()) and float(aux["trav"].sum()) > 10.0


def _sample_inputs(rng, n_vox, n):
    """Hits over a few voxels (several per voxel), misses and sentinel ends,
    and an arena holding earlier means, counts, touch times and normals."""
    end_flat = rng.integers(0, 40, n).astype(np.int32)
    end_flat[rng.random(n) < 0.1] = n_vox  # unresolved ends
    end_is_hit = rng.random(n) < 0.8
    end_frac = rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    # Touch times straddle 2^31: a voxel's maximum must be taken unsigned.
    touch = rng.choice(np.array([5, 2**31 - 1, 2**31, 2**31 + 7, 2**32 - 2], np.uint32), n)
    prior = rng.random(n_vox) < 0.5
    mean_coord = np.where(prior, (rng.integers(0, 1 << 30, n_vox) | (1 << 31)), 0).astype(np.uint32)
    mean_count = np.where(prior, rng.integers(1, 9, n_vox), 0).astype(np.uint32)
    touch_time = np.where(prior, rng.integers(0, 2**32, n_vox, dtype=np.uint64), 0).astype(np.uint32)
    normals = rng.normal(size=(n_vox, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    with jax.disable_jit():
        incident = np.where(prior, np.asarray(subvoxel_jnp.encode_normal(jnp.asarray(normals))), 0)
    arena = {"mean_coord": mean_coord, "mean_count": mean_count, "touch_time": touch_time,
             "incident": incident.astype(np.uint32)}
    batch = {"end_frac": end_frac, "direction": direction, "touch_enc": touch}
    return arena, batch, {"end_flat": end_flat, "end_is_hit": end_is_hit}


@pytest.mark.parametrize("layers", [("mean",), ("touch",), ("incident",), ("touch", "incident"),
                                    ("mean", "touch", "incident")])
def test_apply_sample_layers_matches_reference(layers):
    """apply_sample_layers against _apply_sample_layers run op by op: mean
    codes and counts, touch times (an unsigned maximum over values at and
    above 2^31) and incident codes bit for bit; voxels with no hit and the
    sentinel keep their values."""
    rng = np.random.default_rng(len(layers) * 7 + len(layers[0]))
    n_vox, pad = 64, 512
    arena, batch, records = _sample_inputs(rng, n_vox, 300)
    flags = {"with_mean": "mean" in layers, "with_touch_time": "touch" in layers,
             "with_incident": "incident" in layers}
    ref_cfg = RefConfig(resolution=0.1, region_shift=2, capacity=1, max_steps=8,
                        scatter_pad=pad, **flags)
    assert ref_cfg.sentinel == n_vox
    ref_arena = {k: jnp.asarray(np.concatenate([v, np.zeros(1 + pad, np.uint32)]))
                 for k, v in arena.items()}
    ref_batch = {"start_abs": jnp.zeros((300, 3), jnp.int32),
                 **{k: jnp.asarray(v) for k, v in batch.items()}}
    with jax.disable_jit():
        ref = _apply_sample_layers(ref_arena, {k: jnp.asarray(v) for k, v in records.items()},
                                   ref_batch, ref_cfg)
    cfg = IntegrateConfig(resolution=0.1, region_shift=2, capacity=1, max_steps=8, **flags)
    port = {k: torch.from_numpy(np.concatenate([v, np.zeros(1, np.uint32)]).view(np.int32))
            for k, v in arena.items()}
    apply_sample_layers(port, {k: torch.from_numpy(v) for k, v in records.items()},
                        {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
                         for k, v in batch.items()}, cfg)
    names = {"mean": ("mean_coord", "mean_count"), "touch": ("touch_time",),
             "incident": ("incident",)}
    hit_vox = np.unique(records["end_flat"][records["end_is_hit"]])
    hit_vox = hit_vox[hit_vox < n_vox]
    for layer in layers:
        for name in names[layer]:
            a = np.asarray(ref[name])[:n_vox + 1]
            b = port[name].numpy().view(np.uint32)
            assert np.array_equal(a, b), (name, np.flatnonzero(a != b)[:8])
            untouched = np.setdiff1d(np.arange(n_vox + 1), hit_vox)
            assert np.array_equal(b[untouched], np.append(arena[name], 0)[untouched]), name
            assert not np.array_equal(b[hit_vox], arena[name][hit_vox]), name
    if "touch" in layers:
        assert (port["touch_time"].numpy().view(np.uint32)[hit_vox] >= 2**31).any()
