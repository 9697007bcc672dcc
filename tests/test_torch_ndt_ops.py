"""The port's NDT math, sub-voxel codec and segmented reductions against the
JAX package's, function by function, on seeded numpy inputs.

The JAX functions run op by op (not jitted), so nothing is contracted into
an FMA.  Tolerances: the codec and the segmented reductions are
bit-identical (same ops in the same order); the NDT math is held to
rtol 1e-5 / atol 1e-6, which covers the last-ulp differences between
XLA's and PyTorch's exp, log and sqrt.  The raw likelihoods get rtol 1e-4:
``jnp.linalg.norm`` is a jitted program of its own, inside which XLA's CPU
backend contracts the sum of squares into FMAs (the TPU and the port round
each op), and exp(-x/2) of the badly conditioned solves amplifies that
last bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ohm_tpu.ops import blocked
from ohm_tpu.ops import ndt as ref_ndt
from ohm_tpu.ops import subvoxel_jnp
from ohm_tpu.ops.integrate import _segment_reduce
from ohm_tpu_torch.ops import ndt as port_ndt
from ohm_tpu_torch.ops import segments, subvoxel

RES = 0.25
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(n=4096, seed=0):
    """Voxel-local geometry around a Gaussian: packed sqrt covariances with
    a positive diagonal, sensor / sample / mean positions, counts and
    batch-start occupancy (some +inf)."""
    rng = np.random.default_rng(seed)
    cov = rng.normal(0, 0.01, (n, 6)).astype(np.float32)
    cov[:, [0, 2, 5]] = np.abs(cov[:, [0, 2, 5]]) + np.float32(0.02)
    sensor = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    sample = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    mean = rng.uniform(-RES / 2, RES / 2, (n, 3)).astype(np.float32)
    count = rng.integers(0, 200, n).astype(np.uint32)
    occ = rng.normal(0, 2.0, n).astype(np.float32)
    occ[rng.random(n) < 0.1] = np.inf
    return dict(cov=cov, sensor=sensor, sample=sample, mean=mean, count=count, occ=occ)


def _t(x):
    x = np.array(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(ref, port, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **(tol or TOL))


def test_solve_triangular_packed():
    d = _inputs()
    _close(ref_ndt.solve_triangular_packed(jnp.asarray(d["cov"]), jnp.asarray(d["sensor"])),
           port_ndt.solve_triangular_packed(_t(d["cov"]), _t(d["sensor"])))


def test_sample_likelihoods():
    d = _inputs(seed=1)
    args = [d[k] for k in ("cov", "sensor", "sample", "mean")]
    ref = ref_ndt.sample_likelihoods(*map(jnp.asarray, args), 0.05)
    port = port_ndt.sample_likelihoods(*map(_t, args), 0.05)
    for a, b in zip(ref, port):
        _close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("rate", [0.4, 0.9])
def test_ndt_miss_delta(rate):
    d = _inputs(seed=2)
    args = [d[k] for k in ("cov", "sensor", "sample", "mean")]
    args[0][:8] = 0.0  # singular covariances: the NaN guard
    ref_delta, ref_miss = ref_ndt.ndt_miss_delta(*map(jnp.asarray, args), rate, 0.05)
    delta, miss = port_ndt.ndt_miss_delta(*map(_t, args), rate, 0.05)
    _close(ref_delta, delta)
    assert np.isfinite(delta.numpy()).all()
    # is_miss compares a likelihood with a threshold: allow flips only where
    # the likelihood sits within the tolerance of it.
    assert (np.asarray(ref_miss) != miss.numpy()).sum() <= 2


def test_tm_hit_consistency():
    d = _inputs(seed=3)
    cfg = {"reinit_threshold": -1.3862944, "reinit_count": 100, "sensor_noise": 0.05,
           "adaptation_rate": 0.4, "sample_threshold": 3}
    args = [d[k] for k in ("cov", "sensor", "sample", "mean", "count", "occ")]
    ref = ref_ndt.tm_hit_consistency(*map(jnp.asarray, args), cfg)
    port = port_ndt.tm_hit_consistency(*map(_t, args), cfg)
    assert np.array_equal(np.asarray(ref[0]), port[0].numpy())
    for a, b in zip(ref[1:], port[1:]):
        assert (np.asarray(a) != b.numpy()).sum() <= 2


@pytest.mark.parametrize("name", ["cov6_to_full", "chol3_packed", "_outer6"])
def test_packed_matrix_helpers(name):
    rng = np.random.default_rng(4)
    if name == "chol3_packed":  # symmetric positive definite, packed
        s = rng.normal(0, 0.05, (2048, 6)).astype(np.float32)
        s[:, [0, 2, 5]] = np.abs(s[:, [0, 2, 5]]) + np.float32(0.01)
        x = np.asarray(ref_ndt.cov6_to_full(jnp.asarray(s)))
    elif name == "_outer6":
        x = rng.normal(0, 0.1, (2048, 3)).astype(np.float32)
    else:
        x = rng.normal(0, 0.05, (2048, 6)).astype(np.float32)
    _close(getattr(ref_ndt, name)(jnp.asarray(x)), getattr(port_ndt, name)(_t(x)))


def test_merge_covariance_batch():
    d = _inputs(seed=5)
    rng = np.random.default_rng(6)
    n = d["cov"].shape[0]
    k = rng.integers(1, 9, n).astype(np.float32)
    z = rng.uniform(-RES / 2, RES / 2, (n, 3)).astype(np.float32)
    z_sum = (z * k[:, None]).astype(np.float32)
    zz_sum = np.asarray(ref_ndt._outer6(jnp.asarray(z))) * k[:, None] + np.float32(1e-4)
    count = d["count"].copy()
    count[:64] = 0  # fresh voxels
    args = [d["cov"], d["mean"], count, d["occ"], k, z_sum, zz_sum.astype(np.float32)]
    ref = ref_ndt.merge_covariance_batch(*map(jnp.asarray, args), RES, -1.3862944, 100)
    port = port_ndt.merge_covariance_batch(*map(_t, args), RES, -1.3862944, 100)
    for a, b in zip(ref[:3], port[:3]):
        _close(a, b)
    assert np.array_equal(np.asarray(ref[3]), port[3].numpy())  # reset


def test_sub_voxel_codec_bit_identical():
    rng = np.random.default_rng(7)
    local = rng.uniform(-0.7 * RES, 0.7 * RES, (8192, 3)).astype(np.float32)
    local[:4] = [[RES / 2] * 3, [-RES / 2] * 3, [0.0] * 3, [np.nan, 0.0, 1e30]]
    ref = np.asarray(subvoxel_jnp.sub_voxel_coord(jnp.asarray(local), RES))
    port = subvoxel.sub_voxel_coord(_t(local), RES).numpy().view(np.uint32)
    assert np.array_equal(ref, port)
    patterns = np.concatenate([ref, rng.integers(0, 2**32, 4096, dtype=np.uint32),
                               np.zeros(4, np.uint32)])
    ref_back = np.asarray(subvoxel_jnp.sub_voxel_to_local_coord(jnp.asarray(patterns), RES))
    port_back = subvoxel.sub_voxel_to_local_coord(_t(patterns), RES).numpy()
    assert np.array_equal(ref_back.view(np.uint32), port_back.view(np.uint32))


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 7777])
def test_segment_reduce_bit_identical(n):
    rng = np.random.default_rng(n)
    ids = np.sort(rng.integers(0, max(1, n // 3), n)).astype(np.int32)
    vals = rng.normal(size=(n, 3)).astype(np.float32)
    last, (s0, s1, mx) = _segment_reduce(
        jnp.asarray(ids), [(jnp.asarray(vals[:, 0]), "sum"), (jnp.asarray(vals[:, 1]), "sum"),
                           (jnp.asarray(vals[:, 2]), "max")], None)
    p_last, sums = segments.segment_reduce(_t(ids), _t(vals[:, :2]))
    _, p_max = segments.segment_reduce(_t(ids), _t(vals[:, 2]), "max")
    assert np.array_equal(np.asarray(last), p_last.numpy())
    for ref, port in ((s0, sums[:, 0]), (s1, sums[:, 1]), (mx, p_max)):
        assert np.array_equal(np.asarray(ref).view(np.uint32), port.numpy().view(np.uint32))


@pytest.mark.parametrize("n", [5, 1024, 3000])
def test_segment_sums_bit_identical(n):
    rng = np.random.default_rng(n + 1)
    ids = np.sort(rng.integers(0, max(1, n // 4), n))
    first = np.concatenate([[True], ids[1:] != ids[:-1]])
    vals = rng.uniform(0.0, 50.0, n).astype(np.float32)
    ref = np.asarray(blocked.segment_sums(jnp.asarray(vals), jnp.asarray(first)))
    port = segments.segment_sums(_t(vals), _t(first)).numpy()
    assert np.array_equal(ref.view(np.uint32), port.view(np.uint32))


def test_cumsum_matches_and_refuses_floats():
    x = np.random.default_rng(9).integers(0, 2, 5000).astype(np.int32)
    assert np.array_equal(np.asarray(blocked.cumsum(jnp.asarray(x))),
                          segments.cumsum(_t(x)).numpy())
    with pytest.raises(TypeError):
        segments.cumsum(torch.zeros(4))
