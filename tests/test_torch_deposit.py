"""The deposit-and-sweep of the PyTorch port (kernel K2's plain version)
against the JAX package: its XLA apply (sorted_hit_miss_counts +
_apply_occupancy_dense) and its Pallas deposit kernel in interpret mode,
on one sorted key stream and a batch-start arena that mixes unobserved
(-0.0), free, occupied and saturated voxels.  Occupancy must agree bit for
bit over [0, sentinel] (the JAX arena has a longer scratch tail) and the
touched-voxel counts must be equal.

The sweep's total = n_hit * hit + n_miss * miss rounds each product and the
sum (the reference's op order, and the port's).  XLA's CPU backend
contracts that into an FMA inside jitted programs, which changes the last
bit on voxels that take both hits and misses in one batch.  So the jitted
reference paths (apply_records_jit, the Pallas kernel) are compared on
streams where no voxel mixes the two, and mixed streams are compared with
the reference's XLA functions run op by op, which do not contract.  The
edge streams of ohm_tpu_torch.testing (which the run-length kernel's design
makes risky) use hit and miss values whose products are exact, so mixed
voxels compare against the Pallas kernel too."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ohm_tpu.core.rayflags import RayFlag
from ohm_tpu.ops import deposit_pallas
from ohm_tpu.ops.integrate import IntegrateConfig as RefConfig
from ohm_tpu.ops.integrate import _apply_occupancy_dense, sorted_hit_miss_counts
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.deposit_cuda import (
    deposit_and_sweep, deposit_and_sweep_reference)
from ohm_tpu_torch.testing import DEPOSIT_EDGE_STREAMS, deposit_edge_stream

# tests/test_pallas_deposit.py's shapes: 16 slots of 8^3 voxels.
BASE = dict(resolution=0.1, region_shift=3, capacity=16, max_steps=64,
            hit_value=0.85, miss_value=-0.15, occupancy_threshold=0.0,
            min_value=-10.0, max_value=12.0)


def _cfgs(**kw):
    kw = {**BASE, **kw}
    return RefConfig(scatter_pad=8192, zero_unobserved=True, **kw), IntegrateConfig(**kw)


def _stream(cfg, n=6000, seed=0, mixed=False):
    """Sorted (flat << 1 | hit) keys: repeated voxels, ~10% hits, ~5%
    sentinel records.  Unless ``mixed``, a voxel takes only hits or only
    misses."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, cfg.capacity * 2 // 3, n)
    flat = slots * cfg.voxels_per_region + rng.integers(0, cfg.voxels_per_region, n)
    hot = rng.random(n) < 0.3
    flat[hot] = (slots[hot] * 7) % cfg.sentinel
    if mixed:
        hit = (rng.random(n) < 0.1).astype(np.int64)
    else:
        hit = (flat % 10 == 0).astype(np.int64)
    sent = rng.random(n) < 0.05
    flat[sent] = cfg.sentinel
    hit[sent] = 0
    return np.sort((flat << 1) | hit).astype(np.int32)


def _arena(ref_cfg, seed=1):
    """Batch-start occupancy in the reference's arena length: -0.0
    (unobserved), free and occupied values, some at the clamp bounds."""
    n = -(-(ref_cfg.sentinel + 1 + ref_cfg.scatter_pad) // 512) * 512
    rng = np.random.default_rng(seed)
    occ = np.full(n, np.float32(-0.0), np.float32)
    seeded = rng.integers(0, ref_cfg.sentinel, ref_cfg.sentinel // 2)
    occ[seeded] = rng.normal(0.0, 5.0, seeded.size).astype(np.float32)
    occ[seeded[:40]] = np.float32(ref_cfg.max_value)
    occ[seeded[40:80]] = np.float32(ref_cfg.min_value)
    occ[seeded[80:90]] = np.float32(0.0)  # observed, exactly zero
    return occ


def _reference(ref_cfg, occ_j, key_j):
    ids, _, last, n_hit, n_miss = sorted_hit_miss_counts(key_j)
    occ_out, _, _ = _apply_occupancy_dense(occ_j, ids, last, n_hit, n_miss, ref_cfg)
    return occ_out, jnp.sum((last & (ids != ref_cfg.sentinel)).astype(jnp.int32))


def _check(ref_cfg, cfg, keys, occ, jitted=True):
    """The port against the reference's XLA apply run op by op and, when
    ``jitted``, against the jitted XLA apply and the Pallas kernel."""
    n = cfg.sentinel + 1
    key_j, occ_j = jnp.asarray(keys), jnp.asarray(occ)
    refs = {"xla_op_by_op": _reference(ref_cfg, occ_j, key_j)}
    if jitted:
        refs["xla_jit"] = jax.jit(lambda o, k: _reference(ref_cfg, o, k))(occ_j, key_j)
        refs["pallas_interpret"] = jax.jit(
            lambda o, k: deposit_pallas.deposit_and_sweep(o, k, ref_cfg, interpret=True))(
                occ_j, key_j)
    port_occ, port_touched = deposit_and_sweep(
        torch.from_numpy(occ[:n].copy()), torch.from_numpy(keys), cfg)
    port_bits = port_occ.numpy().view(np.uint32)
    for name, (ref_occ, ref_touched) in refs.items():
        ref_bits = np.asarray(ref_occ)[:n].view(np.uint32)
        assert np.array_equal(ref_bits, port_bits), (name, np.flatnonzero(ref_bits != port_bits)[:10])
        assert int(port_touched) == int(ref_touched), name
    assert port_bits[cfg.sentinel] == np.float32(-0.0).view(np.uint32)  # never written
    changed = port_bits != occ[:n].view(np.uint32)
    assert changed.sum() > 100


FLAGS = [
    0,
    int(RayFlag.EXCLUDE_FREE),
    int(RayFlag.EXCLUDE_OCCUPIED),
    int(RayFlag.EXCLUDE_UNOBSERVED),
    int(RayFlag.EXCLUDE_FREE | RayFlag.EXCLUDE_OCCUPIED),
]


@pytest.mark.parametrize("flags", FLAGS)
def test_deposit_bit_identical_under_exclude_flags(flags):
    ref_cfg, cfg = _cfgs(ray_flags=flags)
    _check(ref_cfg, cfg, _stream(cfg), _arena(ref_cfg))


@pytest.mark.parametrize("flags", FLAGS)
def test_deposit_bit_identical_with_mixed_voxels(flags):
    ref_cfg, cfg = _cfgs(ray_flags=flags)
    _check(ref_cfg, cfg, _stream(cfg, seed=2, mixed=True), _arena(ref_cfg, seed=5),
           jitted=False)


def test_deposit_keeps_saturated_voxels():
    ref_cfg, cfg = _cfgs(saturation_min=-4.0, saturation_max=4.0)
    occ = _arena(ref_cfg, seed=4)
    _check(ref_cfg, cfg, _stream(cfg, seed=3), occ)
    _check(ref_cfg, cfg, _stream(cfg, seed=3, mixed=True), occ, jitted=False)


def test_deposit_unaligned_stream():
    ref_cfg, cfg = _cfgs()
    keys = _stream(cfg, n=777)  # not a multiple of the reference's 512 chunk
    _check(ref_cfg, cfg, keys, _arena(ref_cfg))


def test_counts_cap_at_65535():
    """A voxel with more than 65535 misses takes 65535 of them, as the
    reference's 16-bit packed counts do; the hit count is unaffected."""
    _, cfg = _cfgs(min_value=-1e9)
    keys = torch.tensor([10 << 1] * 70000 + [(10 << 1) | 1] * 3, dtype=torch.int32)
    occ = torch.full((cfg.sentinel + 1,), -0.0)
    out, touched = deposit_and_sweep_reference(occ, keys, cfg)
    expect = np.float32(np.float32(3) * np.float32(cfg.hit_value)
                        + np.float32(65535) * np.float32(cfg.miss_value))
    assert out[10].item() == expect
    assert int(touched) == 1
    assert torch.equal(out[:10].view(torch.int32), torch.full((10,), -0.0).view(torch.int32))


@pytest.mark.parametrize("name", DEPOSIT_EDGE_STREAMS)
def test_deposit_edge_streams_match_pallas_interpret(name):
    """The streams that the run-length kernel's design makes risky (a run
    past the 65535 cap, runs and hit/miss boundaries across 256- and
    1024-record blocks, an empty and an all-sentinel stream, negative flat
    keys) through the plain version, against the Pallas kernel in interpret
    mode and the XLA apply run op by op.  Hit and miss values are exact
    binary fractions, so every product is exact and XLA's FMA contraction
    cannot change a bit: mixed voxels are compared here too."""
    ref_cfg, cfg = _cfgs(hit_value=0.75, miss_value=-0.25, min_value=-1e5, max_value=1e5)
    keys = deposit_edge_stream(name, cfg.sentinel)
    # The XLA apply scatters every record: its scratch tail must hold them.
    ref_cfg = dataclasses.replace(ref_cfg, scatter_pad=max(8192, keys.size))
    occ = _arena(ref_cfg, seed=6)
    n = cfg.sentinel + 1
    key_j, occ_j = jnp.asarray(keys), jnp.asarray(occ)
    # The Pallas kernel cannot slice a chunk out of an empty stream; it gets
    # one sentinel key instead, which every version skips.
    key_p = key_j if keys.size else jnp.asarray([cfg.sentinel << 1], jnp.int32)
    refs = {"xla_op_by_op": _reference(ref_cfg, occ_j, key_j),
            "pallas_interpret": deposit_pallas.deposit_and_sweep(occ_j, key_p, ref_cfg,
                                                                 interpret=True)}
    port_occ, port_touched = deposit_and_sweep(
        torch.from_numpy(occ[:n].copy()), torch.from_numpy(keys), cfg)
    port_bits = port_occ.numpy().view(np.uint32)
    for ref_name, (ref_occ, ref_touched) in refs.items():
        ref_bits = np.asarray(ref_occ)[:n].view(np.uint32)
        assert np.array_equal(ref_bits, port_bits), (ref_name,
                                                     np.flatnonzero(ref_bits != port_bits)[:10])
        # The XLA apply counts negative ids among its distinct voxels (no
        # mapper gives one); the Pallas kernel and the port skip them.
        if not (name == "negative" and ref_name == "xla_op_by_op"):
            assert int(port_touched) == int(ref_touched), ref_name
    live = (keys >> 1 >= 0) & (keys >> 1 < cfg.sentinel)
    assert int(port_touched) == np.unique(keys[live] >> 1).size
    assert (int(port_touched) > 0) == (name not in ("empty", "all_sentinel"))
    if name == "long_run":  # 70,000 misses take 65,535 of them
        x = occ[10] if occ[10] != 0 else np.float32(0.0)
        assert port_occ[10].item() == np.float32(x + np.float32(65535 * -0.25))
