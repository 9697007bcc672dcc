"""``spinning``: a multi-channel lidar turning about the vertical axis.
Each of ``azimuth_steps`` steps a revolution fires every channel once, in
the order of ``elevations_deg`` (the firing order); the head turns on from
revolution to revolution.  The run's seed draws the start azimuth, uniform
over one revolution, and nothing else: every seed sends the same beams
turned about the axis."""

import math

import torch


def per_frame(sensor: dict) -> int:
    return sensor["azimuth_steps"] * len(sensor["elevations_deg"])


def prepare(sensor: dict, g, device):
    return torch.rand(1, generator=g, device=device, dtype=torch.float64) * (2 * math.pi)


def directions(sensor: dict, start, first: int, count: int, g, device):
    steps = sensor["azimuth_steps"]
    el = torch.deg2rad(torch.tensor(sensor["elevations_deg"], dtype=torch.float64, device=device))
    step = torch.arange(first * steps, (first + count) * steps, dtype=torch.float64, device=device)
    az = (start + 2 * math.pi * step / steps)[:, None]
    return torch.stack([torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az),
                        torch.sin(el).expand(az.shape[0], -1)], dim=2).reshape(-1, 3)
