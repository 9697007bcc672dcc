"""Vectorised NDT math.

Counterpart of ``ohm_tpu/ops/ndt.py`` (reference: ohm/CovarianceVoxelCompute.h),
function for function and op for op: the packed-triangular solve, the miss
and hit likelihoods, the NDT-TM consistency test, and the closed-form batch
covariance merge (Chan's parallel combine, then one packed 3x3 Cholesky).
All geometry is voxel-local float32.  ``f32`` turns each Python constant
into the float32 value the reference uses.
"""

from __future__ import annotations

import torch

from ohm_tpu_torch.ops.ddawalk import f32

#: Seed scale for a fresh covariance: sqrt cov = 0.1 * resolution * I.
COV_SEED_SCALE = 0.1


def solve_triangular_packed(cov6, y):
    """Forward substitution L x = y, L packed lower-triangular [..., 6]
    ([0; 1 2; 3 4 5]); y [..., 3]."""
    x0 = y[..., 0] / cov6[..., 0]
    x1 = (y[..., 1] - cov6[..., 1] * x0) / cov6[..., 2]
    x2 = (y[..., 2] - cov6[..., 3] * x0 - cov6[..., 4] * x1) / cov6[..., 5]
    return torch.stack([x0, x1, x2], dim=-1)


def _dot3(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def sample_likelihoods(cov6, sensor, sample, mean, sensor_noise):
    """(p_x_ml_given_voxel, p_x_ml_given_sample); positions voxel-local
    f32 [..., 3] (ohm/CovarianceVoxelCompute.h:226-272)."""
    sensor_to_sample = sample - sensor
    norm = torch.sqrt(_dot3(sensor_to_sample, sensor_to_sample))[..., None]
    sensor_ray = sensor_to_sample / torch.clamp(norm, min=f32(1e-12))
    mean_to_sensor = sensor - mean

    a = solve_triangular_packed(cov6, sensor_ray)
    b_norm = solve_triangular_packed(cov6, mean_to_sensor)
    t = -_dot3(a, b_norm) / torch.clamp(_dot3(a, a), min=f32(1e-20))
    x_ml = sensor_ray * t[..., None] + sensor

    sol = solve_triangular_packed(cov6, x_ml - mean)
    p_voxel = torch.exp(-0.5 * _dot3(sol, sol))
    noise_var = f32(f32(sensor_noise) * f32(sensor_noise))
    d = x_ml - sample
    p_sample = torch.exp(-0.5 * _dot3(d, d) / noise_var)
    return p_voxel, p_sample


def ndt_miss_delta(cov6, sensor, sample, mean, adaptation_rate, sensor_noise):
    """Log-odds adjustment of an NDT miss on a Gaussian-bearing voxel
    (ohm/CovarianceVoxelCompute.h:598-637).  Returns (delta, is_miss); a
    NaN delta becomes 0, as in the reference."""
    p_voxel, p_sample = sample_likelihoods(cov6, sensor, sample, mean, sensor_noise)
    scaling = f32(f32(0.5) * f32(adaptation_rate))
    prod = p_voxel * (1.0 - p_sample)
    pu = 0.5 - scaling * prod
    is_miss = prod < scaling
    delta = torch.log(pu / (1.0 - pu))
    delta = torch.where(torch.isnan(delta), torch.zeros_like(delta), delta)
    return delta, is_miss


def tm_hit_consistency(cov6, sensor, sample, mean, count, occ, cfg_ndt: dict):
    """NDT-TM per-sample hit/miss consistency
    (ohm/CovarianceVoxelCompute.h:446-505).  ``count`` is the int32 bit
    pattern of the u32 mean count.  Returns (needs_reset, inc_hit, inc_miss)."""
    count = count.to(torch.int64) & 0xFFFFFFFF
    needs_reset = torch.isposinf(occ) | (count == 0) | (
        (occ < f32(cfg_ndt["reinit_threshold"])) & (count >= cfg_ndt["reinit_count"]))
    p_voxel, p_sample = sample_likelihoods(cov6, sensor, sample, mean,
                                           cfg_ndt["sensor_noise"])
    prod = p_voxel * p_sample
    eta = f32(f32(0.5) * f32(cfg_ndt["adaptation_rate"]))
    below = count < cfg_ndt["sample_threshold"]
    inc_hit = needs_reset | below | (prod >= eta)
    inc_miss = ~needs_reset & ~below & (prod < eta) & (p_voxel >= eta)
    return needs_reset, inc_hit, inc_miss


def cov6_to_full(cov6):
    """Packed sqrt [..., 6] -> P = S S^T as [P00, P01, P11, P02, P12, P22]."""
    s00, s10, s11, s20, s21, s22 = cov6.unbind(-1)
    p00 = s00 * s00
    p01 = s10 * s00
    p11 = s10 * s10 + s11 * s11
    p02 = s20 * s00
    p12 = s20 * s10 + s21 * s11
    p22 = s20 * s20 + s21 * s21 + s22 * s22
    return torch.stack([p00, p01, p11, p02, p12, p22], dim=-1)


def chol3_packed(p6, eps=1e-12):
    """3x3 Cholesky of packed symmetric [P00, P01, P11, P02, P12, P22] ->
    packed lower sqrt [L00; L10 L11; L20 L21 L22]."""
    eps = f32(eps)
    l00 = torch.sqrt(torch.clamp(p6[..., 0], min=eps))
    l10 = p6[..., 1] / l00
    l11 = torch.sqrt(torch.clamp(p6[..., 2] - l10 * l10, min=eps))
    l20 = p6[..., 3] / l00
    l21 = (p6[..., 4] - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(p6[..., 5] - l20 * l20 - l21 * l21, min=eps))
    return torch.stack([l00, l10, l11, l20, l21, l22], dim=-1)


def _outer6(v):
    """v v^T as packed [00, 01, 11, 02, 12, 22]; v [..., 3]."""
    x, y, z = v.unbind(-1)
    return torch.stack([x * x, x * y, y * y, x * z, y * z, z * z], dim=-1)


def merge_covariance_batch(cov6_old, mean_old, count_old, occ_old, k, z_sum, zz_sum,
                           resolution, reinit_threshold, reinit_count):
    """Closed-form batch hit merge (ohm/CovarianceVoxelCompute.h:301-370 in
    exact arithmetic).  ``count_old`` is the int32 bit pattern of the u32
    count.  Returns (sqrt cov6, mean, count f32, reset mask)."""
    count_old = (count_old.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
    reset = (count_old == 0) | (
        (occ_old < f32(reinit_threshold)) & (count_old >= f32(reinit_count)))
    zero = torch.zeros_like(count_old)
    n0 = torch.where(reset, zero, count_old)
    mu0 = torch.where(reset[..., None], torch.zeros_like(mean_old), mean_old)

    kf = torch.clamp(k, min=1.0)
    mu_b = z_sum / kf[..., None]
    m2_b = zz_sum - kf[..., None] * _outer6(mu_b)

    seed = f32((COV_SEED_SCALE * resolution) ** 2)
    full = torch.full_like(kf, seed)
    seed6 = torch.stack([full, zero, full, zero, zero, full], dim=-1)
    q0 = torch.where((n0 > 0)[..., None], n0[..., None] * cov6_to_full(cov6_old), seed6)

    delta = mu_b - mu0
    corr = (n0 * kf / torch.clamp(n0 + kf, min=1.0))[..., None] * _outer6(delta)
    q = q0 + m2_b + corr
    n_new = n0 + kf
    p_new = q / n_new[..., None]
    cov_new = chol3_packed(p_new)
    mean_new = (mu0 * n0[..., None] + z_sum) / n_new[..., None]
    return cov_new, mean_new, n_new, reset
