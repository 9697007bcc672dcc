"""What a run loads: never JAX or the JAX package, whose name the port's
begins with (top-level names compared whole), and the reference nothing of
the program."""

import json
import os
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys
import ohmbench.reference, ohmbench.reference.walk, ohmbench.reference.occupancy
import ohmbench.reference.compare, ohmbench.reference.ndt
import ohmbench.modes.occupancy, ohmbench.modes.ndt
ref_tops = sorted({m.split('.')[0] for m in sys.modules})
import ohmbench.run, ohmbench.generator, ohmbench.control, ohmbench.devicetrace
import ohmbench.hostmeter, ohmbench.loops.closed, ohmbench.traffic_parts.scene_room
import ohmbench.traffic_parts.scene_street, ohmbench.traffic_parts.sensor_sphere
import ohmbench.traffic_parts.sensor_spinning, ohmbench.traffic_parts.path_orbit
import ohmbench.traffic_parts.path_drive
run_tops = sorted({m.split('.')[0] for m in sys.modules})
print(json.dumps({"reference": ref_tops, "run": run_tops}))
"""


def loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_nothing_loads_jax_or_the_jax_package_and_the_reference_not_the_port():
    tops = loaded()
    for name in ("jax", "jaxlib", "flax", "ohm_tpu"):
        assert name not in tops["run"]
        assert name not in tops["reference"]
    assert "ohm_tpu_torch" not in tops["reference"]


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from ohmbench import run

    monkeypatch.setitem(sys.modules, "ohm_tpu_torch_lookalike", sys)
    assert "ohm_tpu_torch_lookalike" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ohm_tpu.core", sys)
    assert run.forbidden_modules() == ["ohm_tpu.core"]
