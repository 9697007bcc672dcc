"""``street``: the ground plane z = 0 and ``boxes`` axis-aligned buildings
standing on it over a square of ``half_extent_m`` about the origin, a
straight street ``street_half_width_m`` either side of the x axis left
clear.  Each building's footprint sides (``footprint_m``), height
(``height_m``) and place are drawn once from the mix's own ``seed``, never
from the run's, so every run meets the same geometry."""

import torch

from ohmbench.traffic_parts import nonzero


def buildings(scene: dict, device) -> tuple:
    """(lo, hi) corners of the buildings, f64[boxes, 3] on ``device``."""
    g = torch.Generator().manual_seed(int(scene["seed"]))
    u = torch.rand((scene["boxes"], 6), generator=g, dtype=torch.float64)
    half, street = scene["half_extent_m"], scene["street_half_width_m"]
    (f0, f1), (h0, h1) = scene["footprint_m"], scene["height_m"]
    sx, sy = f0 + (f1 - f0) * u[:, 0], f0 + (f1 - f0) * u[:, 1]
    height = h0 + (h1 - h0) * u[:, 2]
    side = torch.where(u[:, 3] < 0.5, -1.0, 1.0).to(torch.float64)
    cx = -half + sx / 2 + u[:, 4] * (2 * half - sx)
    cy = side * (street + sy / 2 + u[:, 5] * (half - street - sy))
    lo = torch.stack([cx - sx / 2, cy - sy / 2, torch.zeros_like(cx)], dim=1)
    hi = torch.stack([cx + sx / 2, cy + sy / 2, height], dim=1)
    return lo.to(device), hi.to(device)


def cast(scene: dict, origins, dirs):
    """Distance along unit ``dirs`` to the ground or the nearest building
    face ahead (origins outside every building), ``inf`` where none."""
    d = nonzero(dirs)
    inf = torch.full_like(d[:, 2], float("inf"))
    t = torch.where(d[:, 2] < 0, -origins[:, 2] / d[:, 2], inf)
    inv = 1.0 / d
    lo, hi = buildings(scene, origins.device)
    for i in range(lo.shape[0]):
        t1 = (lo[i] - origins) * inv
        t2 = (hi[i] - origins) * inv
        near = torch.minimum(t1, t2).max(dim=1).values
        far = torch.maximum(t1, t2).min(dim=1).values
        hit = (near <= far) & (near > 0)
        t = torch.where(hit & (near < t), near, t)
    return t
