"""What the modes' comparisons draw on: two maps, voxel by voxel.

A map is given as sorted voxel ids with their occupancy values (every
observed voxel, none other).  A voxel mismatches where one side observed it
and the other did not, or where the two values differ by more than
``TOLERANCE``.  The number compared is the share of mismatching voxels
among those either side observed.  An NDT-OM map adds its sampled voxels'
counts, means and covariances, compared the same way
(``ndt_mismatch``).  Each mode's ``compare`` (``ohmbench/modes``) picks
the comparisons that decide ``correct`` in its cells.
"""

from __future__ import annotations

import numpy as np
import torch

from ohmbench.reference.walk import pack_ids

#: Two observed values closer than this agree (bench.py's voxel tolerance:
#: well above the float32 rounding of a log-odds value near 3.5, 4.8e-7,
#: and far below one miss, 0.2).
TOLERANCE = 1e-4

#: The covariance layer's members, the packed square root in order.
COV_KEYS = ("P00", "P01", "P11", "P02", "P12", "P22")
#: Two means agree within this many steps of ohm's sub-voxel code (its
#: rounding may fall either side of a step; one step is resolution / 1023).
MEAN_TOLERANCE_STEPS = 1
#: Two covariances agree where no element of P = L L^T differs by more than
#: this share of the reference's largest element.  (A voxel whose samples
#: lie on a wall has a near-zero direction, whose off-diagonal elements are
#: rounding noise of either sign: the program's float32 against this
#: float64 differed there by up to 0.9% of the largest element over 1,500
#: batches of the box stream, and a one-voxel excess moves the share by
#: 1 / 168,000.)
COV_TOLERANCE = 1e-2


def _observed_ids(keys: np.ndarray, plane: torch.Tensor, mask: torch.Tensor, region_dim: int):
    """(ids, region row, voxel index) of the ``mask`` voxels of per-region
    planes [R, dim^3], x fastest, sorted by id."""
    region, index = torch.nonzero(mask, as_tuple=True)
    d = region_dim
    local = torch.stack([index % d, (index // d) % d, index // (d * d)], dim=1)
    abs_keys = torch.from_numpy(keys).to(plane.device)[region] * d + local
    ids = pack_ids(abs_keys)
    order = torch.argsort(ids)
    return ids[order], region[order], index[order]


def read_map(chunks: dict, region_dim: int, resolution: float, device) -> dict:
    """A map's host chunks {region key (x, y, z): {"layer.member": array
    [dim^3]}} in the reference's form: sorted ``ids`` and ``occupancy`` of
    every observed voxel (+inf unobserved); with the mean layer, the
    sampled voxels' ``ndt_ids``, ``count``, ``mean`` (voxel-centre
    relative, decoded from ohm's sub-voxel code) and ``cov``."""
    from ohmbench.reference.ndt import mean_of_code

    out = {"ids": torch.zeros(0, dtype=torch.int64, device=device),
           "occupancy": torch.zeros(0, dtype=torch.float32, device=device)}
    if not chunks:
        return out
    keys = np.asarray(list(chunks), dtype=np.int64)
    plane = lambda name, dtype: torch.from_numpy(np.stack(  # noqa: E731
        [np.asarray(c[name]).astype(dtype) for c in chunks.values()])).to(device)
    occ = plane("occupancy.occupancy", np.float32)
    ids, region, index = _observed_ids(keys, occ, ~(torch.isinf(occ) & (occ > 0)), region_dim)
    out.update(ids=ids, occupancy=occ[region, index])
    first = next(iter(chunks.values()))
    if "mean.count" in first:
        count = plane("mean.count", np.int64)
        ids, region, index = _observed_ids(keys, count, count > 0, region_dim)
        code = plane("mean.coord", np.int64)[region, index]
        axes = torch.stack([(code >> (10 * a)) & 1023 for a in range(3)], dim=1)
        cov = torch.stack([plane("covariance." + k, np.float32)[region, index]
                           for k in COV_KEYS], dim=1)
        out.update(ndt_ids=ids, count=count[region, index],
                   mean=mean_of_code(axes.to(torch.float64), resolution).to(torch.float32),
                   cov=cov)
    return out


def mismatch(ids_a, vals_a, ids_b, vals_b) -> dict:
    """Voxels either map observed, and how many of them mismatch."""
    union = torch.unique(torch.cat([ids_a, ids_b]))
    full = []
    for ids, vals in ((ids_a, vals_a), (ids_b, vals_b)):
        v = torch.full(union.shape, float("inf"), dtype=torch.float32, device=union.device)
        v[torch.searchsorted(union, ids)] = vals.to(torch.float32)
        full.append(v)
    a, b = full
    seen_a, seen_b = ~torch.isinf(a), ~torch.isinf(b)
    both = seen_a & seen_b
    diff = torch.where(both, (a - b).abs(), torch.zeros_like(a))
    bad = (seen_a != seen_b) | (diff > TOLERANCE)
    return {"voxels": int(union.shape[0]), "mismatched": int(bad.sum()),
            "status_differs": int((seen_a != seen_b).sum()),
            "worst_abs_diff": float(diff.max()) if union.numel() else 0.0}


def ndt_mismatch(a: dict, b: dict, resolution: float) -> dict:
    """Sampled voxels either map holds, and how many of them mismatch:
    sampled on one side only, a different sample count, a mean more than
    ``MEAN_TOLERANCE_STEPS`` code steps away on some axis, or a covariance
    off by more than ``COV_TOLERANCE`` (``b`` is the reference)."""
    from ohmbench.reference.ndt import square

    union = torch.unique(torch.cat([a["ndt_ids"], b["ndt_ids"]]))
    full = []
    for side in (a, b):
        at = torch.searchsorted(union, side["ndt_ids"])
        count = torch.zeros(union.shape, dtype=torch.int64, device=union.device)
        mean = torch.zeros((union.shape[0], 3), dtype=torch.float64, device=union.device)
        cov = torch.zeros((union.shape[0], 6), dtype=torch.float64, device=union.device)
        count[at], mean[at], cov[at] = side["count"], side["mean"].double(), side["cov"].double()
        full.append((count, mean, cov))
    (ca, ma, va), (cb, mb, vb) = full
    step = resolution / 1023
    mean_off = ((ma - mb).abs().max(dim=1).values / step) if union.numel() else ma[:, 0]
    pa, pb = square(va), square(vb)
    scale = pb.abs().max(dim=1).values
    cov_off = (pa - pb).abs().max(dim=1).values / torch.where(scale > 0, scale, 1.0)
    bad = (ca != cb) | (mean_off > MEAN_TOLERANCE_STEPS + 0.5) | (cov_off > COV_TOLERANCE)
    return {"voxels": int(union.shape[0]), "mismatched": int(bad.sum()),
            "count_differs": int((ca != cb).sum()),
            "worst_mean_steps": float(mean_off.max()) if union.numel() else 0.0,
            "worst_cov_share": float(cov_off.max()) if union.numel() else 0.0}


def share(result: dict) -> float:
    """The mismatching share of the compared voxels (1 where none was
    compared: an empty map is no answer)."""
    return result["mismatched"] / result["voxels"] if result["voxels"] else 1.0
