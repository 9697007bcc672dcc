"""The TSDF path's kernels and scan against the JAX package:

  K5  gather_planes_f32's plain version against the Pallas kernel in
      interpret mode, on a sorted id stream with sentinel padding over planes
      holding -0.0, +-inf, NaN payloads and denormals: bit for bit
  K6  tsdf_set_deposit's plain version against the Pallas kernel in
      interpret mode, one depositing record per voxel carrying negative,
      -0.0, infinite and NaN distances: both planes bit for bit; and its
      contract check
  the affine-clamp composition (ops.segments) against
      ohm_tpu.ops.blocked's, within 1e-6, over several 1024-wide rows with
      segments that cross row boundaries
  K5+K6 fused (ops.tsdf_cuda.tsdf_visits): its plain version against the
      JAX package's per-visit chain (the two Pallas kernels in interpret
      mode around blocked.segment_sums and segment_compose_affine_clamp,
      jitted, as ohm_tpu/ops/integrate_tsdf.py:300-404 runs it) on
      ohm_tpu_torch.testing's edge streams: weights bit for bit, distances
      within atol = rtol = 1e-5 (XLA's CPU backend contracts the maps'
      products and sums into FMAs); the wrapper on the CPU is its plain
      version

Shapes follow tests/test_torch_ndt_kernels.py: 16 slots of 8^3 voxels."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ohm_tpu.ops import blocked, deposit_pallas
from ohm_tpu.ops.integrate import IntegrateConfig as RefConfig
from ohm_tpu_torch.ops import deposit_cuda, gather_cuda, segments, tsdf_cuda
from ohm_tpu_torch.testing import TSDF_SPECIALS, TSDF_VISIT_STREAMS, tsdf_visit_stream

CFG = RefConfig(resolution=0.1, region_shift=3, capacity=16, max_steps=64, pallas_deposit=2)
SPECIALS = np.array([-0.0, np.inf, -np.inf, 1e-40, -1e-42], np.float32)
NAN_BITS = np.array([0x7FC00000, 0x7FA00001, 0xFFC12345], np.uint32)  # quiet, signalling, negative


def _planes(rng, n):
    """Two f32 arena planes of random values with the special patterns
    scattered through them (length a multiple of 512, as the kernel needs)."""
    out = []
    for _ in range(2):
        p = rng.normal(0.0, 2.0, n).astype(np.float32)
        at = rng.choice(n, 400, replace=False)
        p[at[:200]] = SPECIALS[np.arange(200) % SPECIALS.size]
        p.view(np.uint32)[at[200:]] = NAN_BITS[np.arange(200) % NAN_BITS.size]
        out.append(p)
    return out


def test_gather_f32_plain_matches_pallas_interpret():
    rng = np.random.default_rng(21)
    n_arena = (CFG.capacity + 1) * CFG.voxels_per_region
    planes = _planes(rng, n_arena)
    ids = np.concatenate([np.sort(rng.integers(0, CFG.sentinel, 3000)),
                          np.full(400, CFG.sentinel)]).astype(np.int32)
    ref = deposit_pallas.gather_planes_f32(tuple(jnp.asarray(p) for p in planes),
                                           jnp.asarray(ids), CFG, interpret=True)
    port = gather_cuda.gather_planes_f32(tuple(torch.from_numpy(p) for p in planes),
                                         torch.from_numpy(ids), CFG.sentinel)
    assert len(port) == 2
    for a, b in zip(ref, port):
        assert b.dtype == torch.float32
        a, b = np.asarray(a).view(np.uint32), b.numpy().view(np.uint32)
        assert np.array_equal(a, b)
        assert (b[-400:] == 0).all()  # sentinel records read +0.0
    live = port[0].numpy()[:-400]
    assert np.isnan(live).any() and np.isinf(live).any() and np.signbit(live[live == 0]).any()
    nan_bits = port[1].numpy().view(np.uint32)[np.isnan(port[1].numpy())]
    assert set(nan_bits.tolist()) <= set(NAN_BITS.tolist()) and len(set(nan_bits.tolist())) > 1


def _deposit_stream(rng):
    """Sorted ids over 10 of 16 slots: at most one record per voxel carries
    w > 0 (the segment last), its distance drawn from negatives, -0.0,
    +-inf and NaN; a lone record with w <= 0 and d = 0 stands for a voxel
    whose visits were skipped; the other records carry (0, 0); sentinel tail."""
    ids = np.sort(rng.integers(0, 10 * CFG.voxels_per_region, 4000))
    ids = np.concatenate([ids, np.full(300, CFG.sentinel)]).astype(np.int32)
    last = np.concatenate([ids[1:] != ids[:-1], [True]]) & (ids < CFG.sentinel)
    first = np.concatenate([[True], ids[1:] != ids[:-1]])
    w = np.zeros(ids.size, np.float32)
    d = np.zeros(ids.size, np.float32)
    dep = last & (rng.random(ids.size) < 0.8)
    w[dep] = rng.uniform(1e-5, 50.0, int(dep.sum())).astype(np.float32)
    d[dep] = rng.uniform(-0.3, 0.3, int(dep.sum())).astype(np.float32)
    k = np.flatnonzero(dep)
    d[k[:40]] = np.array([-0.0, np.inf, -np.inf, np.nan], np.float32)[np.arange(40) % 4]
    w[k[40:45]] = np.inf
    lone = np.flatnonzero(first & last & ~dep & (ids < CFG.sentinel))[:12]
    w[lone] = np.array([-1.0, -0.0, np.nan], np.float32)[np.arange(lone.size) % 3]
    w[-300:] = 5.0  # sentinel records never store
    d[-300:] = 1.0
    return ids, w, d


def test_tsdf_deposit_plain_matches_pallas_interpret():
    rng = np.random.default_rng(22)
    n_arena = (CFG.capacity + 1) * CFG.voxels_per_region
    wp, dp = _planes(rng, n_arena)
    ids, w, d = _deposit_stream(rng)
    ref_w, ref_d = deposit_pallas.tsdf_set_deposit(
        jnp.asarray(wp), jnp.asarray(dp), jnp.asarray(ids), jnp.asarray(w), jnp.asarray(d),
        CFG, interpret=True)
    port_w, port_d = torch.from_numpy(wp.copy()), torch.from_numpy(dp.copy())
    out = deposit_cuda.tsdf_set_deposit(port_w, port_d, torch.from_numpy(ids),
                                        torch.from_numpy(w), torch.from_numpy(d), CFG.sentinel)
    assert out[0] is port_w and out[1] is port_d  # in place
    n = CFG.sentinel + 1
    for a, b, before in ((ref_w, port_w, wp), (ref_d, port_d, dp)):
        a, b = np.asarray(a)[:n].view(np.uint32), b.numpy()[:n].view(np.uint32)
        assert np.array_equal(a, b), np.flatnonzero(a != b)[:10]
        assert b[CFG.sentinel] == before[:n].view(np.uint32)[CFG.sentinel]
    stored = (w > 0) & (ids < CFG.sentinel)
    assert np.array_equal(port_d.numpy()[ids[stored]].view(np.uint32), d[stored].view(np.uint32))
    kept = np.setdiff1d(np.arange(CFG.sentinel), ids[stored])
    assert np.array_equal(port_w.numpy()[kept].view(np.uint32), wp[kept].view(np.uint32))


def test_tsdf_deposit_refuses_two_depositing_records_for_a_voxel():
    w = torch.zeros(CFG.sentinel + 1)
    d = torch.zeros(CFG.sentinel + 1)
    ids = torch.tensor([3, 3, 7], dtype=torch.int32)
    with pytest.raises(ValueError, match="more than one"):
        deposit_cuda.tsdf_set_deposit(w, d, ids, torch.tensor([1.0, 2.0, 1.0]),
                                      torch.zeros(3), CFG.sentinel)
    # A second record of the voxel with w = 0 does not deposit.
    deposit_cuda.tsdf_set_deposit(w, d, ids, torch.tensor([0.0, 2.0, 1.0]),
                                  torch.tensor([0.0, -0.5, 0.25]), CFG.sentinel)
    assert w[3] == 2.0 and d[3] == -0.5 and w[7] == 1.0 and d[7] == 0.25


def _affine_stream(rng, n):
    """Per-visit TSDF maps over a sorted stream: slopes in [0, 1], offsets
    of either sign, the truncation clamp or the identity (a skipped visit),
    with segments of 1 to ~3000 records, several crossing 1024-wide rows."""
    lengths = np.concatenate([rng.integers(1, 40, 60), [1500], rng.integers(1, 40, 40),
                              [2600], rng.integers(1, 40, 200)])
    starts = np.cumsum(np.concatenate([[0], lengths]))
    first = np.zeros(n, bool)
    first[starts[starts < n]] = True
    a = rng.uniform(0.0, 1.0, n).astype(np.float32)
    b = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    skip = rng.random(n) < 0.05
    trunc = np.float32(0.3)
    lo = np.where(skip, np.float32(-3e38), -trunc).astype(np.float32)
    hi = np.where(skip, np.float32(3e38), trunc).astype(np.float32)
    a[skip], b[skip] = 1.0, 0.0
    return a, b, lo, hi, first


def test_affine_clamp_composition_matches_blocked():
    rng = np.random.default_rng(23)
    n = 5 * 1024 + 300
    a, b, lo, hi, first = _affine_stream(rng, n)
    starts = np.flatnonzero(first)
    spans = np.diff(np.concatenate([starts, [n]]))
    assert (spans > 1024).sum() >= 2  # segments cross row boundaries
    ref = blocked.segment_compose_affine_clamp(*(jnp.asarray(x) for x in (a, b, lo, hi, first)))
    port = segments.segment_compose_affine_clamp(*(torch.from_numpy(x) for x in (a, b, lo, hi,
                                                                                   first)))
    for name, x, y in zip("ABLH", ref, port):
        assert y.shape == (n,)
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-6, rtol=1e-6, err_msg=name)
    # Applied to a seed at every position, as the TSDF path does at segment lasts.
    d0 = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    ref_d = np.minimum(np.maximum(np.asarray(ref[0]) * d0 + np.asarray(ref[1]),
                                  np.asarray(ref[2])), np.asarray(ref[3]))
    A, B, LO, HI = port
    port_d = torch.minimum(torch.maximum(A * torch.from_numpy(d0) + B, LO), HI).numpy()
    np.testing.assert_allclose(port_d, ref_d, atol=1e-6)


N_ARENA = (CFG.capacity + 1) * CFG.voxels_per_region


@jax.jit
def _jax_visits(weight, distance, ids, w, wsdf, trunc, max_weight):
    """The JAX package's per-visit chain (ohm_tpu/ops/integrate_tsdf.py:
    300-404 with its kernels, which have no function of their own there)."""
    first = jnp.concatenate([jnp.array([True]), ids[1:] != ids[:-1]])
    last = jnp.concatenate([ids[1:] != ids[:-1], jnp.array([True])])
    w0_s, d0_s = deposit_pallas.gather_planes_f32((weight, distance), ids, CFG, interpret=True)
    w_run = w0_s + blocked.segment_sums(w, first)
    wc_prev = jnp.minimum(w_run - w, max_weight)
    new_w_vis = wc_prev + w
    alive_vis = new_w_vis >= jnp.float32(1e-5)
    fbig = jnp.float32(3.0e38)
    denom = jnp.where(alive_vis, new_w_vis, 1.0)
    a_map = jnp.where(alive_vis, wc_prev / denom, 1.0)
    b_map = jnp.where(alive_vis, wsdf / denom, 0.0)
    lo_map = jnp.where(alive_vis, -trunc, -fbig)
    hi_map = jnp.where(alive_vis, trunc, fbig)
    A, Bm, LO, HI = blocked.segment_compose_affine_clamp(a_map, b_map, lo_map, hi_map, first)
    d_k = jnp.minimum(jnp.maximum(A * d0_s + Bm, LO), HI)
    w_k = jnp.minimum(w_run, max_weight)
    upd = last & (w_run >= jnp.float32(1e-5)) & (ids != CFG.sentinel)
    return deposit_pallas.tsdf_set_deposit(weight, distance, ids, jnp.where(upd, w_k, 0.0),
                                           jnp.where(upd, d_k, 0.0), CFG, interpret=True)


def _port_visits(s, fn):
    weight, distance = torch.from_numpy(s["weight"].copy()), torch.from_numpy(s["distance"].copy())
    w = None if s["w"] is None else torch.from_numpy(s["w"])
    out = fn(weight, distance, torch.from_numpy(s["ids"]), w, torch.from_numpy(s["wsdf"]),
             s["trunc"], s["max_weight"], CFG.sentinel)
    assert out[0] is weight and out[1] is distance  # in place
    return weight.numpy(), distance.numpy()


@pytest.mark.parametrize("name", TSDF_VISIT_STREAMS)
def test_visits_plain_matches_the_jax_chain(name):
    s = tsdf_visit_stream(name, CFG.sentinel, N_ARENA, seed=1)
    w = s["w"] if s["w"] is not None else (s["ids"] != CFG.sentinel).astype(np.float32)
    ref_w, ref_d = (np.asarray(x) for x in _jax_visits(
        *(jnp.asarray(x) for x in (s["weight"], s["distance"], s["ids"], w, s["wsdf"])),
        jnp.float32(s["trunc"]), jnp.float32(s["max_weight"])))
    port_w, port_d = _port_visits(s, tsdf_cuda.tsdf_visits_reference)
    assert np.array_equal(ref_w.view(np.uint32), port_w.view(np.uint32)), \
        np.flatnonzero(ref_w.view(np.uint32) != port_w.view(np.uint32))[:10]
    np.testing.assert_allclose(port_d, ref_d, atol=1e-5, rtol=1e-5)
    stored = port_w.view(np.uint32) != s["weight"].view(np.uint32)
    assert stored.sum() > 100 if name != "all_sentinel" else not stored.any()
    assert port_w[stored].max(initial=0) <= s["max_weight"]
    # Distances stay in the band but where a stored NaN seed propagates.
    assert np.abs(port_d[stored & ~np.isnan(port_d)]).max(initial=0) <= s["trunc"]


def _runs(ids):
    """(start, length) of each voxel's run below the sentinel."""
    starts = np.flatnonzero(np.concatenate([[True], ids[1:] != ids[:-1]]))
    lengths = np.diff(np.concatenate([starts, [ids.size]]))
    live = ids[starts] != CFG.sentinel
    return starts[live], lengths[live]


def test_visit_streams_reach_their_edges():
    """Each stream holds the case it is named for; none is a whole number
    of 1024-record rows."""
    streams = {name: tsdf_visit_stream(name, CFG.sentinel, N_ARENA, seed=1)
               for name in TSDF_VISIT_STREAMS}
    assert all(s["ids"].size % 1024 for s in streams.values())
    s = streams["specials"]
    voxels = np.unique(s["ids"][s["ids"] != CFG.sentinel])
    for plane in ("weight", "distance"):
        held = set(s[plane][voxels].view(np.uint32).tolist())
        assert set(TSDF_SPECIALS.view(np.uint32).tolist()) <= held, plane
    starts, lengths = _runs(streams["long_runs"]["ids"])
    crossings = (starts + lengths - 1) // 1024 - starts // 1024
    assert (crossings >= 1).sum() >= 3 and crossings.max() >= 3
    s = streams["saturation"]
    starts, lengths = _runs(s["ids"])
    w0 = s["weight"][s["ids"][starts]]
    assert ((w0 < s["max_weight"]) & (w0 + lengths > s["max_weight"] + 1)).sum() > 20
    w = streams["near_zero"]["w"]
    assert (w < 1e-5).mean() > 0.4 and (w.view(np.uint32) == 0x80000000).any()
    assert (w >= 1e-5).any()
    s = streams["weighted"]
    assert (s["w"] == 0).mean() > 0.05 and _runs(s["ids"])[1].max() > 2048
    assert streams["short"]["ids"].size < 1024
    assert (streams["all_sentinel"]["ids"] == CFG.sentinel).all()


def test_visits_wrapper_on_cpu_is_its_plain_version():
    """On CPU tensors the wrapper runs the plain version, counting no launch."""
    tsdf_cuda.tsdf_visits.launches = 0
    for name in TSDF_VISIT_STREAMS:
        s = tsdf_visit_stream(name, CFG.sentinel, N_ARENA, seed=2)
        a = _port_visits(s, tsdf_cuda.tsdf_visits)
        b = _port_visits(s, tsdf_cuda.tsdf_visits_reference)
        for x, y in zip(a, b):
            assert np.array_equal(x.view(np.uint32), y.view(np.uint32)), name
    assert tsdf_cuda.tsdf_visits.launches == 0
