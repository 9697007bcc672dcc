"""``orbit``: one pose a frame on a horizontal circle of ``radius_m`` at
``height_m`` about the origin, the frames spread evenly round it from a
phase that the seed draws.  The path visits the same places whatever the
seed, so every seed asks the same work of the map in another order."""

import math

import torch


def poses(path: dict, n_frames, g, device):
    if n_frames is None:
        raise ValueError("an orbit has no length of its own: give the pool's pool_batches")
    phase = torch.rand(1, generator=g, device=device, dtype=torch.float64) * (2 * math.pi)
    a = phase + 2 * math.pi * torch.arange(n_frames, dtype=torch.float64, device=device) / n_frames
    r = path["radius_m"]
    return torch.stack([r * torch.cos(a), r * torch.sin(a),
                        torch.full_like(a, path["height_m"])], dim=1)
