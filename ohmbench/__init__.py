"""ohmbench: the benchmark of ohm_tpu_torch (see ohmbench/run.py)."""

import importlib


def find(package: str, name: str):
    """The module ``ohmbench.<package>.<name>``, found by a name that a
    configuration or a traffic mix gives: a mode (``modes``), a traffic
    part (``traffic_parts``) or a client loop (``loops``).  A new one is a
    new file; nothing that looks it up names it."""
    if not name.isidentifier():
        raise ValueError(f"no {package} module can be named {name!r}")
    return importlib.import_module(f"{__name__}.{package}.{name}")
