"""``correct`` must be able to come out false.

The control (the reference a precision lower, in the program's place) and
a run with the timed path broken underneath, each at a size the CPU holds,
on the cells' own comparison and limits.  Each cell's size and the
controls that must fail there come from its ``ohmbench/small/<cell>.json``;
the checks below take any cell those files and ``run.load_cell`` find."""

import pytest

from ohmbench import control, find, run, small
from conftest import SMALL

CELLS = list(SMALL)


def control_fails(workload, seed):
    """Both controls give readings; each that the cell's small file names
    fails at least one of the cell's numbers."""
    spec = small.load(workload)
    rows = control.control_readings(workload, seed, 24, "cpu", spec["overrides"])
    assert {r["control"] for r in rows} == set(control.CONTROLS)
    for r in rows:
        if r["control"] in spec["failing_controls"]:
            assert any(r[k] > limit for k, limit in r["limits"].items()), r


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [31, 32, 2**31 + 33])
def test_control_is_not_correct(workload, seed):
    control_fails(workload, seed)


def sound_run_is_correct(workload, trace):
    out = run.run_cell(workload, 41, 1.0, trace, device="cpu",
                       overrides=small.load(workload)["overrides"])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:
        # No device on the CPU: the device-trace metrics find nothing to read.
        assert "breakdown" in out and out["device"]["busy_s"] == 0
        listed = [m["name"] for m in run.load_bench()["per_layer"]
                  if workload in m.get("workloads", [workload])]
        assert set(out["metrics"]) <= set(listed)
        assert ("host_prep_ms_per_batch.stream" in out["metrics"]) == bool(listed)
    else:
        assert set(out["metrics"]) == {"rays_per_s", "setup_s"}
    return out


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace):
    sound_run_is_correct(workload, trace)


def _target(workload):
    """The program's mapper class that the cell's configuration names, and
    the configuration's mode."""
    import ohm_tpu_torch

    _, config, _, _ = run.load_cell(workload, small.load(workload)["overrides"])
    return getattr(ohm_tpu_torch, config["mapper"]), find("modes", config["mode"])


def _state_unchanged(monkeypatch, cls, mode):
    """Every third batch leaves the map as it found it."""
    real = cls._integrate_device
    calls = [0]

    def integrate(self, b, cfg, n_rays, n_segments):
        calls[0] += 1
        if calls[0] % 3:
            return real(self, b, cfg, n_rays, n_segments)
        saved = {k: v.clone() for k, v in self.arena.layers.items()}
        stats = real(self, b, cfg, n_rays, n_segments)
        for k, v in saved.items():
            self.arena.layers[k].copy_(v)
        return stats

    monkeypatch.setattr(cls, "_integrate_device", integrate)


def _half_batch(monkeypatch, cls, mode):
    """Every batch integrates only its first half of rays."""
    real = cls.integrate_rays_async

    def integrate(self, rays, *args, **kw):
        n = len(rays) // 2
        return real(self, rays[: 2 * (n // 2)], *args, **kw)

    monkeypatch.setattr(cls, "integrate_rays_async", integrate)


def _answer_altered(monkeypatch, cls, mode):
    """Each batch's update is off by 1e-3 of every value it wrote to the
    layers that the mode's comparison reads."""
    real = cls._integrate_device

    def integrate(self, b, cfg, n_rays, n_segments):
        before = {name: self.arena.layers[name].clone() for name in mode.VALUE_LAYERS}
        stats = real(self, b, cfg, n_rays, n_segments)
        for name, old in before.items():
            layer = self.arena.layers[name]
            written = layer != old
            layer[written] = layer[written] * (1 + 1e-3)
        return stats

    monkeypatch.setattr(cls, "_integrate_device", integrate)


FAULTS = (_state_unchanged, _half_batch, _answer_altered)


def fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch, *_target(workload))
    out = run.run_cell(workload, 43, 1.0, False, device="cpu",
                       overrides=small.load(workload)["overrides"])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault_is_not_correct(workload, fault, monkeypatch)


def test_card_run_is_correct(card):
    """On the card: a short run of the first cell, at its own size."""
    out = run.run_cell(run.load_bench()["workloads"][0]["name"], 45, 2.0, False, device=card)
    assert out["correct"], out["checks"]


test_card_run_is_correct = pytest.mark.cuda(test_card_run_is_correct)
