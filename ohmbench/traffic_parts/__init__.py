"""The parts a traffic mix is made of, each found by its ``kind``
(``ohmbench.find``) by ``ohmbench/generator.py``, which composes them:

``scene_<kind>.py``
    ``cast(scene, origins, dirs)``: the distance along each unit direction
    from its origin to the scene's first surface, ``inf`` where the beam
    meets none.  The scene is fixed by the mix; the run's seed never moves
    it.
``sensor_<kind>.py``
    ``per_frame(sensor)``: the beams of one frame (a pose's shot, a
    revolution); ``prepare(sensor, g, device)``: what the run's seed draws
    for the whole run, drawn once after the path; ``directions(sensor,
    prepared, first, count, g, device)``: the unit directions of frames
    ``first`` .. ``first + count - 1``, frame after frame and each in firing
    order, as f64[count * per_frame, 3], drawing what varies beam by beam.
``path_<kind>.py``
    ``poses(path, n_frames, g, device)``: one sensor origin a frame, f64[F,
    3], the first draw of the run's seed; ``n_frames`` is how many frames
    the pool asks for, or None where the pool takes the whole path.

A new kind is a new file here and its parameters in a mix.
"""

import torch


def nonzero(d: torch.Tensor) -> torch.Tensor:
    """Directions with no component exactly 0 (so every slab test divides)."""
    return torch.where(d == 0, torch.full_like(d, 1e-300), d)
