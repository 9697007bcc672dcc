"""The size at which ``ohmbench/tests`` run each cell on the CPU:
``ohmbench/small/<cell>.json``, found by the cell's name along this
package's ``__path__`` (as ``ohmbench.find`` finds a mode), so a new cell
brings its own file.  A file holds

``why``
    why that size still works what the cell works;
``overrides``
    what ``run.load_cell`` takes: keys of the configuration (``config``),
    the traffic mix (``traffic``) and the limits (``limits``) replaced so
    that a run takes seconds on the CPU, and the cell itself (``cell``)
    where it is not in ``BENCHMARK.json``;
``failing_controls``
    the controls of ``ohmbench/control.py`` that must come out not correct
    at that size, with ``failing_controls_why`` where one is left out.
"""

from __future__ import annotations

import json
import os


def path(cell: str) -> str | None:
    """The file of cell ``cell``, or None where no directory holds one."""
    for directory in __path__:
        p = os.path.join(directory, cell + ".json")
        if os.path.exists(p):
            return p
    return None


def load(cell: str) -> dict:
    p = path(cell)
    if p is None:
        raise FileNotFoundError(f"no ohmbench/small/{cell}.json")
    with open(p) as f:
        return json.load(f)
