"""Rank walk: expand rays into per-voxel visit records without a sort.

Counterpart of ``_init_walk`` and ``walk_rays_unordered`` in
``ohm_tpu/ops/ddawalk.py``; with ``ops.integrate.resolve_slots`` it is the
plain PyTorch version of the expand kernel K1 (``ops.expand_cuda``).

Along each axis the wall-crossing times form an arithmetic sequence
``e0 + k * dd``.  Event (axis a, index k) is one record; its count of events
on another axis b comes from inverting b's sequence (estimate, then a
bounded binary advance) in the masked-int time domain ``bits(t) & ~3``, with
ties won by the higher axis (ohm/LineWalkCompute.h walkSelectNextAxis).

Every float op keeps the reference's order, and each product and sum is a
separate PyTorch op, so nothing fuses into an FMA: the keys are bit-identical
to the JAX package's.  Each record also carries its enter and exit times
(the traversal layer's ``exits - enters``).
"""

from __future__ import annotations

import numpy as np
import torch

# "Infinite" time: a large finite value, as in the reference.
_BIG = float(np.float32(3.0e38))
#: The smallest normal f32.  XLA's CPU backend and the TPU compare with
#: denormals flushed to zero, so a smaller direction component reads as 0.
_TINY = float(np.finfo(np.float32).tiny)


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in either type)."""
    return float(np.float32(x))


def floor_to_i32(x: torch.Tensor) -> torch.Tensor:
    """floor(x) cast to int32 the way XLA casts: saturating, NaN -> 0.
    (A plain ``.to(torch.int32)`` of inf or NaN is undefined.)"""
    f = torch.floor(x).double().nan_to_num(0.0).clamp(-2.0**31, 2.0**31 - 1)
    return f.to(torch.int32)


def masked_bits(t: torch.Tensor) -> torch.Tensor:
    """The walk's comparison domain: the f32 bits with the low two cleared."""
    return t.view(torch.int32) & ~3


def init_walk(start_frac, direction, length, start_abs, end_abs, resolution):
    """Per-ray walk set-up (ohm/LineWalkCompute.h:188-280): times are
    distances from the start point along the ray, in f32.

    A direction component below the smallest normal f32 in magnitude reads
    as zero (sign False, inverse +_BIG), as the reference's comparisons
    read it under XLA.

    Returns (sign bool[B,3], initial_exit f32[B,3], step_delta f32[B,3],
    crossings i32[B,3])."""
    res = f32(resolution)
    half = float(np.float32(0.5) * np.float32(resolution))
    normal = ~(torch.abs(direction) < _TINY)  # NaN stays nonzero, as in the reference
    sign = (direction < 0) & normal
    nonzero = (direction != 0) & normal
    safe = torch.where(nonzero, direction, torch.ones_like(direction))
    inv = torch.where(nonzero, torch.ones_like(safe) / safe,
                      torch.where(sign, -_BIG, _BIG).to(direction.dtype))
    inv = torch.where(length[:, None] > 0, inv, torch.zeros_like(inv))
    wall = torch.where(sign, -half, half).to(direction.dtype)
    initial_exit = (wall - start_frac) * inv
    step_delta = torch.abs(res * inv)
    crossings = torch.abs(end_abs - start_abs)
    return sign, initial_exit, step_delta, crossings


def max_keep_first(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(a, b) that returns ``a`` when the two compare equal, as XLA's max
    does: +0.0 and -0.0 keep their order.  torch.maximum may pick either
    zero, and not alike on every device (K1 selects the same way)."""
    return torch.where(b > a, b, a)


def safe_inverse(step_delta: torch.Tensor) -> torch.Tensor:
    """1 / step_delta where positive, else 0."""
    pos = step_delta > 0
    safe = torch.where(pos, step_delta, torch.ones_like(step_delta))
    return torch.where(pos, torch.ones_like(safe) / safe, torch.zeros_like(safe))


def walk_rays_unordered(start_abs, end_abs, start_frac, direction, length,
                        resolution, max_steps: int):
    """Visit records of a ray batch, axis-major: record j of ray r is event
    (a = j // S, k = j % S).

    Returns a dict: voxels i32[B,3S,3] (absolute voxel coords), valid
    bool[B,3S], first bool[B,3S] (the ray's origin-voxel record), enters
    f32[B,3S] (the latest earlier event over the axes, 0 on invalid
    records) and exits f32[B,3S] (the record's own event time), end_enter
    f32[B], overflow bool[B] (a per-axis count exceeded S)."""
    B = start_abs.shape[0]
    S = int(max_steps)
    sign, initial_exit, step_delta, crossings = init_walk(
        start_frac, direction, length, start_abs, end_abs, resolution)
    step_dir = torch.where(sign, -1, 1).to(torch.int32)
    n_ax = torch.clamp(crossings, max=S)

    k = torch.arange(S, dtype=torch.int32, device=start_abs.device)
    times = initial_exit[:, :, None] + step_delta[:, :, None] * k.to(torch.float32)
    valid = k < n_ax[:, :, None]  # [B,3,S]
    mt = masked_bits(times)
    inv_d = safe_inverse(step_delta)

    def rank_against(b_axis, a_axis):
        """Events of axis b before each event of axis a ([B,S])."""
        t_a = times[:, a_axis, :]
        mt_a = mt[:, a_axis, :]
        e0_b = initial_exit[:, b_axis, None]
        d_b = step_delta[:, b_axis, None]
        n_b = n_ax[:, b_axis, None]
        est = floor_to_i32((t_a - e0_b) * inv_d[:, b_axis, None])
        # est - 3 wraps in int32, as the reference's does.
        c = torch.minimum(torch.clamp(est - 3, min=0), n_b)
        for step in (4, 2, 1):
            m = c + (step - 1)
            t_m = e0_b + m.to(torch.float32) * d_b
            adv = (m < n_b) & (masked_bits(t_m) < mt_a)
            c = c + adv.to(torch.int32) * step
        if b_axis > a_axis:  # higher axis wins ties (walkSelectNextAxis)
            t_c = e0_b + c.to(torch.float32) * d_b
            c = c + ((c < n_b) & (masked_bits(t_c) == mt_a)).to(torch.int32)
        return c

    def prev_time(b_axis, count):
        """Time of axis b's last event before ``count`` of them (0 if none):
        e0 + (count - 1) * dd, product and sum rounded separately."""
        t = initial_exit[:, b_axis, None] + (count - 1).to(torch.float32) * step_delta[:, b_axis, None]
        return torch.where(count > 0, t, torch.zeros_like(t))

    voxels, enters = [], []
    own = k.expand(B, S)
    for a in range(3):
        counts = [own if b == a else rank_against(b, a) for b in range(3)]
        voxels.append(start_abs[:, None, :]
                      + step_dir[:, None, :] * torch.stack(counts, dim=-1))
        # Own axis first, then the others ascending (the reference's order).
        prevs = [prev_time(b, counts[b]) for b in [a] + [b for b in range(3) if b != a]]
        enters.append(max_keep_first(max_keep_first(prevs[0], prevs[1]), prevs[2]))
    voxels = torch.cat(voxels, dim=1)  # [B,3S,3]
    valid_flat = valid.reshape(B, 3 * S)
    first = valid_flat & torch.all(voxels == start_abs[:, None, :], dim=-1)
    exits = times.reshape(B, 3 * S)
    enters = torch.cat(enters, dim=1)
    end_enter = torch.where(valid_flat, exits, torch.zeros_like(exits)).amax(dim=1)
    return {
        "voxels": voxels,
        "valid": valid_flat,
        "first": first,
        "enters": torch.where(valid_flat, enters, torch.zeros_like(enters)),
        "exits": exits,
        "end_enter": end_enter,
        "overflow": torch.any(crossings > S, dim=1),
    }
