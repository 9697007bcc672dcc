"""The one traffic generator: a sensor carried along a path through a
scene, its returns cut into batches of rays.

A traffic mix is a data file under ``ohmbench/traffic/`` (JSON) that names
its parts by ``kind`` with their parameters; the generator reads it and
nothing else belongs to a mix.  Each part is a module of
``ohmbench/traffic_parts/`` found by its kind (``scene_<kind>``,
``sensor_<kind>``, ``path_<kind>``; that package says what each gives), so
a new kind of scene, sensor or path is a new file.  The generator only
composes them:

``path``
    one sensor origin a frame;
``sensor``
    the directions of each frame's beams, in firing order, with a
    ``max_range_m``: a beam that meets nothing nearer gives no ray;
``scene``
    where each beam meets the first surface;
``batching``
    ``batch_rays`` consecutive returns a batch and ``pool_batches``
    batches, or ``"path"``: every whole batch of the path's returns;
    ``cycle`` true: the window walks the pool round and round.

The run's seed draws, from one ``torch.Generator`` on the generating
device, first what the path draws, then what the sensor draws for the run,
then the sensor's beam by beam draws, a block of frames at a time, in a few
large draws.  Rays are float64, origins and samples interleaved (2N, 3), as
a point cloud gives them.
"""

from __future__ import annotations

import numpy as np
import torch

from ohmbench import find

_SEED_MASK = (1 << 64) - 1
#: Beams cast in one block of frames: a pool whose beams fit one block
#: (the box stream's 2^20) draws its directions in one call.
BLOCK_BEAMS = 1 << 22


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & _SEED_MASK)
    return g


def parts(mix: dict) -> tuple:
    """The (scene, sensor, path) modules that the mix's kinds name."""
    return tuple(find("traffic_parts", f"{role}_{mix[role]['kind']}")
                 for role in ("scene", "sensor", "path"))


def make_pool(mix: dict, seed: int, device) -> list[np.ndarray]:
    """The mix's pool of batches, each f64[2 * batch_rays, 3] on the host."""
    scene, sensor, path = parts(mix)
    g = generator(seed, device)
    b = mix["batching"]
    per = b["batch_rays"]
    whole_path = b["pool_batches"] == "path"
    need = None if whole_path else per * b["pool_batches"]
    per_frame = sensor.per_frame(mix["sensor"])
    poses = path.poses(mix["path"], None if whole_path else -(-need // per_frame), g, device)
    prepared = sensor.prepare(mix["sensor"], g, device)
    block = max(1, BLOCK_BEAMS // per_frame)
    # One host buffer, made once and kept, that holds a ray for every beam;
    # each block's returns are copied in from the device.  No large host
    # buffer is freed before the window: glibc raises its mmap and trim
    # thresholds on such a free, which speeds up the program's host prep
    # (it allocates large arrays every batch) and so would change what the
    # run measures.
    host = torch.empty((poses.shape[0] * per_frame, 2, 3), dtype=torch.float64)
    n_returns = 0
    for first in range(0, poses.shape[0], block):
        count = min(block, poses.shape[0] - first)
        o = poses[first:first + count].repeat_interleave(per_frame, dim=0)
        d = sensor.directions(mix["sensor"], prepared, first, count, g, device)
        t = scene.cast(mix["scene"], o, d)
        keep = t <= mix["sensor"]["max_range_m"]
        rays = torch.stack([o[keep], (o + d * t[:, None])[keep]], dim=1)
        host[n_returns:n_returns + len(rays)].copy_(rays)
        n_returns += len(rays)
    n_batches = n_returns // per if whole_path else b["pool_batches"]
    if n_returns < per * n_batches:
        raise ValueError(f"the mix gives {n_returns} returns, fewer than its pool's "
                         f"{per * n_batches}")
    pool = host[:per * n_batches].view(n_batches, 2 * per, 3).numpy()
    return [pool[i] for i in range(n_batches)]
