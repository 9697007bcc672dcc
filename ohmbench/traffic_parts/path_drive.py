"""``drive``: a straight drive at ``height_m`` from ``from_m`` to ``to_m``
(x, y), one pose a frame every ``step_m``; the path draws nothing from the
seed.  ``n_frames`` None takes the whole drive, a number its first frames."""

import math

import torch


def poses(path: dict, n_frames, g, device):
    a = torch.tensor(path["from_m"], dtype=torch.float64, device=device)
    b = torch.tensor(path["to_m"], dtype=torch.float64, device=device)
    length = float(torch.linalg.vector_norm(b - a))
    whole = int(math.floor(length / path["step_m"] + 1e-9))
    if n_frames is not None and n_frames > whole:
        raise ValueError(f"the drive has {whole} frames, fewer than the {n_frames} asked")
    n = whole if n_frames is None else n_frames
    s = torch.arange(n, dtype=torch.float64, device=device) * path["step_m"]
    xy = a + s[:, None] * ((b - a) / length)
    return torch.cat([xy, torch.full_like(s, path["height_m"])[:, None]], dim=1)
