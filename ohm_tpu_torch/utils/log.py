"""Levelled logging (reference: logutil/Logger.h:18-33).

Thin wrapper over the stdlib logging module exposing the reference's
trace/info/warn/error levels and a redirectable interface.
"""

from __future__ import annotations

import logging

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_root = logging.getLogger("ohm_tpu")
if not _root.handlers:
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))
    _root.addHandler(handler)
    _root.setLevel(logging.INFO)


def get_logger(name: str = "") -> logging.Logger:
    return _root.getChild(name) if name else _root


def set_log_level(level):
    if isinstance(level, str):
        level = {"trace": TRACE, "info": logging.INFO, "warn": logging.WARNING,
                 "error": logging.ERROR}.get(level.lower(), logging.INFO)
    _root.setLevel(level)


def trace(msg, *args):
    _root.log(TRACE, msg, *args)
