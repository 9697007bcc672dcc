"""The survey's traffic parts on the CPU: the VLP-16's beams in firing order,
the street that every seed meets, and the drive's batches, at the mix's own
widths over the drive's first revolutions."""

import math

import numpy as np
import pytest
import torch

from ohmbench import find, generator, run

SENSOR = run.load_json("traffic", "survey-stream.json")["sensor"]
#: The VLP-16's channels in firing order (laser ids 0..15).
VLP16 = [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15]


def survey_mix(revolutions: int) -> dict:
    """The survey mix as the cell runs it (4096-return batches), its drive
    cut to its first ``revolutions``."""
    _, _, mix, _ = run.load_cell("occ-survey-stream")
    x0 = mix["path"]["from_m"][0]
    mix["path"]["to_m"] = [x0 + (revolutions + 0.5) * mix["path"]["step_m"], 0.0]
    return mix


def test_spinning_sensor_fires_the_vlp16_channels_in_order():
    sensor = find("traffic_parts", "sensor_spinning")
    assert SENSOR["elevations_deg"] == VLP16 and SENSOR["azimuth_steps"] == 1800
    assert sensor.per_frame(SENSOR) == 1800 * 16
    start = torch.tensor([0.25], dtype=torch.float64)
    d = sensor.directions(SENSOR, start, 3, 2, None, "cpu").reshape(2 * 1800, 16, 3)
    assert torch.allclose(d.norm(dim=2), torch.ones(2 * 1800, 16, dtype=torch.float64))
    elevation = torch.rad2deg(torch.asin(d[..., 2]))
    assert torch.allclose(elevation, torch.tensor(VLP16, dtype=torch.float64).expand_as(elevation))
    azimuth = torch.atan2(d[..., 1], d[..., 0])
    # Every channel of a step fires at the step's azimuth; 0.2 deg a step,
    # the head turning on from frame 3.
    assert torch.allclose(azimuth, azimuth[:, :1].expand_as(azimuth))
    steps = torch.arange(3 * 1800, 5 * 1800, dtype=torch.float64)
    expect = torch.remainder(0.25 + steps * (2 * math.pi / 1800) + math.pi, 2 * math.pi) - math.pi
    assert torch.allclose(azimuth[:, 0], expect, atol=1e-9)


def test_street_is_fixed_by_the_mix_and_leaves_the_street_clear():
    scene = run.load_json("traffic", "survey-stream.json")["scene"]
    street = find("traffic_parts", "scene_street")
    lo, hi = street.buildings(scene, "cpu")
    lo2, hi2 = street.buildings(scene, "cpu")
    assert torch.equal(lo, lo2) and torch.equal(hi, hi2) and lo.shape == (60, 3)
    size = hi - lo
    assert bool(((size[:, :2] >= 8) & (size[:, :2] <= 30)).all())
    assert bool(((size[:, 2] >= 4) & (size[:, 2] <= 20)).all()) and bool((lo[:, 2] == 0).all())
    assert bool((lo[:, :2] >= -120).all() and (hi[:, :2] <= 120).all())
    # Nothing stands within the street's half width of the centre line.
    assert bool(((lo[:, 1] >= 10) | (hi[:, 1] <= -10)).all())


@pytest.fixture(scope="module")
def pools():
    mix = survey_mix(2)
    return mix, {seed: generator.make_pool(mix, seed, "cpu") for seed in (5, 2**31 + 77)}


def _on_a_surface(points: np.ndarray, scene: dict) -> np.ndarray:
    """Whether each point lies on the ground or on a face of a building."""
    lo, hi = (t.numpy() for t in find("traffic_parts", "scene_street").buildings(scene, "cpu"))
    on = np.abs(points[:, 2]) < 1e-9
    for a, b in zip(lo, hi):
        inside = np.all((points >= a - 1e-9) & (points <= b + 1e-9), axis=1)
        face = np.any((np.abs(points - a) < 1e-9) | (np.abs(points - b) < 1e-9), axis=1)
        on |= inside & face
    return on


def test_drive_gives_whole_batches_of_returns_within_range(pools):
    mix, by_seed = pools
    pool = by_seed[5]
    assert len(pool) >= 8
    assert all(b.shape == (2 * 4096, 3) and b.dtype == np.float64 for b in pool)
    rays = np.concatenate(pool)
    origins, samples = rays[0::2], rays[1::2]
    length = np.linalg.norm(samples - origins, axis=1)
    assert np.all(length > 0) and np.all(length <= 100.0)
    # Two revolutions' poses, 0.15 m apart, 1.8 m up on the centre line.
    assert np.all(origins[:, 1:] == [0.0, 1.8])
    assert set(np.unique(origins[:, 0])) == {-120.0, -120.0 + 0.15}
    assert np.all(_on_a_surface(samples, mix["scene"]))


def test_drive_is_deterministic_per_seed_on_one_street(pools):
    mix, by_seed = pools
    a = np.concatenate(generator.make_pool(mix, 5, "cpu"))
    assert np.array_equal(a, np.concatenate(by_seed[5]))
    b = np.concatenate(by_seed[2**31 + 77])
    assert a.shape != b.shape or not np.array_equal(a, b)
    # Another seed turns the head; the street it meets is the same.
    assert np.all(_on_a_surface(b[1::2], mix["scene"]))


def test_whole_drive_frames():
    """The whole drive: the configuration's ``survey_length_m`` (108 m) of the
    240 m street from its start, at 0.15 m a revolution, 1.8 m up."""
    _, config, mix, _ = run.load_cell("occ-survey-stream")
    assert config["survey_length_m"] == 108.0 and "survey_length_m" in config["reduced"]
    assert mix["path"]["to_m"][0] - mix["path"]["from_m"][0] == config["survey_length_m"]
    poses = find("traffic_parts", "path_drive").poses(mix["path"], None, None, "cpu")
    assert poses.shape == (720, 3)
    assert float(poses[0, 0]) == -120.0 and float(poses[-1, 0]) == pytest.approx(-12.15)
    assert bool((poses[:, 2] == 1.8).all())
