"""Inputs that reach the kernels' edge cases, and a log of the PyTorch
operations a call issues: one copy, used by ``tests/test_torch_*.py`` and
``chip_smoke.py`` alike, so that both hold the kernels to the same cases."""

from __future__ import annotations

import numpy as np
import torch


def ndt_flag_arena(n_arena: int, n_voxels: int, rng, n_nan: int, n_big: int,
                   seen: float = 0.6):
    """An NDT arena's occupancy and u32 mean counts for the flag gather, as
    numpy arrays of ``n_arena`` voxels: occupancy +inf (unobserved) but on a
    ``seen`` share of the first ``n_voxels``, which are finite, and NaN on
    ``n_nan`` of those voxels; counts 0-5 (both sides of every threshold
    from 0 to 5), and at or above 2^31 on ``n_big`` of them."""
    occ = np.full(n_arena, np.inf, np.float32)
    observed = rng.random(n_voxels) < seen
    occ[:n_voxels][observed] = rng.normal(0.0, 3.0, int(observed.sum())).astype(np.float32)
    occ[rng.choice(n_voxels, n_nan, replace=False)] = np.nan
    count = rng.integers(0, 6, n_arena).astype(np.uint32)
    big = rng.choice(n_voxels, n_big, replace=False)
    count[big] = rng.integers(2**31, 2**32, big.size, dtype=np.uint64).astype(np.uint32)
    return occ, count


def edge_rays(b: dict, cfg) -> None:
    """Make the first 48 rays of a decoded wire (ops.wire.unpack_batch; in
    place, in the wire's own strided views) reach the expand kernel's edge
    cases: rays 0-15 start on the voxel wall they leave (e0 = +-0), 16-23
    have zero length, 24-31 carry a denormal direction component on an axis
    they cross once (1/d = inf: a NaN enter time), 32-39 are invalid, and
    40-47 cross more than S walls on an axis."""
    half = float(np.float32(0.5) * np.float32(cfg.resolution))
    b["start_frac"][:16] = torch.where(b["direction"][:16] < 0, -half, half)
    b["length"][16:24] = 0.0
    b["direction"][24:32, 1] = 1e-39
    b["end_abs"][24:32, 1] = b["start_abs"][24:32, 1] + 1
    b["start_frac"][24:28, 1] = half
    b["valid"][32:40] = False
    b["end_abs"][40:48, 2] = b["start_abs"][40:48, 2] + cfg.max_steps + 5


def dispatched_ops(fn) -> list:
    """The names of the ATen ops ``fn`` issues, in order (python dispatch
    mode): a kernel wrapper should issue its outputs' allocations only."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Log():
        fn()
    return ops
