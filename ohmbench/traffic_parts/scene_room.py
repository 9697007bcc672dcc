"""``room``: the inside of an axis-aligned box, ``half_extents`` about the
origin; every beam from inside hits a wall."""

import torch

from ohmbench.traffic_parts import nonzero


def cast(scene: dict, origins, dirs):
    """Distance along unit ``dirs`` from inside the box [-half, half]."""
    h = torch.as_tensor(scene["half_extents"], dtype=origins.dtype, device=origins.device)
    d = nonzero(dirs)
    bound = torch.where(d > 0, h, -h)
    return ((bound - origins) / d).min(dim=1).values
