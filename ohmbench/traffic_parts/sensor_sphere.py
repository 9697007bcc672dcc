"""``sphere``: ``rays_per_pose`` directions uniform over the sphere from
each pose, drawn beam by beam."""

import torch


def per_frame(sensor: dict) -> int:
    return sensor["rays_per_pose"]


def prepare(sensor: dict, g, device):
    return None


def directions(sensor: dict, prepared, first: int, count: int, g, device):
    dirs = torch.randn((count * per_frame(sensor), 3), generator=g, device=device,
                       dtype=torch.float64)
    return dirs / dirs.norm(dim=1, keepdim=True)
