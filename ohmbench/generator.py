"""The one traffic generator: a sensor carried along a path through a
scene, its returns cut into batches of rays.

A traffic mix is a data file under ``ohmbench/traffic/`` (JSON) that names
the parts and their parameters; the generator reads it and nothing else
belongs to a mix.  Parts:

``scene``
    ``room``: the inside of an axis-aligned box, ``half_extents`` about the
    origin (every ray hits a wall).  The scene is fixed by the mix; the
    run's seed never moves it, so every seed meets the same geometry.
``sensor``
    ``sphere``: ``rays_per_pose`` directions uniform over the sphere from
    one pose, with a ``max_range_m``: a beam that hits nothing nearer gives
    no ray.
``path``
    ``orbit``: one pose a frame on a horizontal circle of ``radius_m`` at
    ``height_m`` about the room's centre, the frames spread evenly round
    it from a phase that the seed draws.  The path visits the same places
    whatever the seed, so every seed asks the same work of the map in
    another order.
``batching``
    ``batch_rays`` consecutive returns a batch and ``pool_batches`` batches;
    ``cycle`` true: the window walks the pool round and round.

The run's seed draws the path's phase and the directions from one
``torch.Generator`` on the generating device, in a fixed order of a few
large draws.  Rays are float64, origins and samples interleaved (2N, 3),
as a point cloud gives them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SEED_MASK = (1 << 64) - 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & _SEED_MASK)
    return g


def _nonzero(d: torch.Tensor) -> torch.Tensor:
    """Directions with no component exactly 0 (so every slab test divides)."""
    return torch.where(d == 0, torch.full_like(d, 1e-300), d)


def cast_room(origins, dirs, half):
    """Distance along unit ``dirs`` from inside the box [-half, half]."""
    h = torch.as_tensor(half, dtype=origins.dtype, device=origins.device)
    d = _nonzero(dirs)
    bound = torch.where(d > 0, h, -h)
    return ((bound - origins) / d).min(dim=1).values


def _sphere_frames(mix: dict, g, device, n_frames: int):
    """Origins and unit directions of ``n_frames`` sphere poses."""
    sensor, path = mix["sensor"], mix["path"]
    if path["kind"] != "orbit":
        raise ValueError("a sphere sensor orbits")
    per = sensor["rays_per_pose"]
    phase = torch.rand(1, generator=g, device=device, dtype=torch.float64) * (2 * math.pi)
    dirs = torch.randn((n_frames * per, 3), generator=g, device=device, dtype=torch.float64)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    a = phase + 2 * math.pi * torch.arange(n_frames, dtype=torch.float64, device=device) / n_frames
    r = path["radius_m"]
    poses = torch.stack([r * torch.cos(a), r * torch.sin(a),
                         torch.full_like(a, path["height_m"])], dim=1)
    return poses.repeat_interleave(per, dim=0), dirs


def make_pool(mix: dict, seed: int, device) -> list[np.ndarray]:
    """The mix's pool of batches, each f64[2 * batch_rays, 3] on the host."""
    g = generator(seed, device)
    b = mix["batching"]
    per, n_batches = b["batch_rays"], b["pool_batches"]
    need = per * n_batches
    sensor, scene = mix["sensor"], mix["scene"]
    if sensor["kind"] != "sphere" or scene["kind"] != "room":
        raise ValueError(f"unknown sensor {sensor['kind']!r} in scene {scene['kind']!r}")
    o, d = _sphere_frames(mix, g, device, -(-need // sensor["rays_per_pose"]))
    t = cast_room(o, d, scene["half_extents"])
    keep = t <= sensor["max_range_m"]
    if int(keep.sum()) < need:
        raise ValueError(f"the mix gives {int(keep.sum())} returns, fewer than its pool's {need}")
    origins = o[keep][:need]
    samples = (o + d * t[:, None])[keep][:need]
    rays = torch.stack([origins, samples], dim=1).reshape(n_batches, 2 * per, 3)
    host = rays.cpu().numpy()
    return [host[i] for i in range(n_batches)]
