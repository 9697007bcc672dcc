"""The device trace of a window: torch.profiler's record of every device
activity (kernels, copies, memsets), reduced to what the per-layer metrics
read.

Only device activity is recorded (``ProfilerActivity.CUDA``): recording
the host's operators as well would slow the host, and the host is what
holds this program's device back, so the idle share would read high.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

#: The profiler's kinds of device activity.
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceOp:
    name: str
    kind: str
    start_ns: int
    end_ns: int


@dataclass
class WindowTrace:
    """Device activity in a traced window of ``window_s`` host seconds."""
    ops: list = field(default_factory=list)
    window_s: float = 0.0

    def busy_s(self) -> float:
        """Seconds in which some operation ran: the union of the intervals
        (copies that overlap a kernel count once)."""
        total, end = 0, None
        for op in sorted(self.ops, key=lambda o: o.start_ns):
            if end is None or op.start_ns > end:
                total += op.end_ns - op.start_ns
                end = op.end_ns
            elif op.end_ns > end:
                total += op.end_ns - end
                end = op.end_ns
        return total / 1e9

    def seconds_of(self, names) -> float:
        """Summed device seconds of the kernels whose identifier is in
        ``names``."""
        names = set(names)
        return sum(op.end_ns - op.start_ns for op in self.ops
                   if op.kind == "kernel" and identifier(op.name) in names) / 1e9

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for op in self.ops:
            key = short_name(op.name)
            by[key] = by.get(key, 0) + (op.end_ns - op.start_ns)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle gaps summed by the operation the device waited
        to run next (what the host was launching)."""
        by, end = {}, None
        for op in sorted(self.ops, key=lambda o: o.start_ns):
            if end is not None and op.start_ns > end:
                key = "before " + short_name(op.name)
                by[key] = by.get(key, 0) + (op.start_ns - end)
            end = op.end_ns if end is None else max(end, op.end_ns)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _bare(name: str) -> str:
    """A device operation's name without a leading 'void ' and anonymous
    namespaces."""
    s = name.strip().replace("(anonymous namespace)::", "")
    return s[5:] if s.startswith("void ") else s


def identifier(name: str) -> str:
    """A kernel's bare function name: 'void ns::k<T>(int*)' -> 'k'."""
    s = re.split(r"[(<]", _bare(name), maxsplit=1)[0]
    return s.split("::")[-1].strip()


def short_name(name: str) -> str:
    """A device operation's name without its arguments, at most 100
    characters."""
    return re.split(r"\(", _bare(name), maxsplit=1)[0].strip()[:100]


class Profiled:
    """Context manager: torch.profiler over a block, then ``trace`` (a
    WindowTrace without its window length, which the caller sets).  On a
    CPU there is no device activity; the host's operators are recorded so
    that the profiler has something to record."""

    def __init__(self, on_card: bool):
        self.on_card = on_card

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activity = ProfilerActivity.CUDA if self.on_card else ProfilerActivity.CPU
        self._prof = profile(activities=[activity])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = WindowTrace(ops=_device_ops(self._prof))
        return False


def _kind(ev) -> str:
    """The event's kind of device activity, or "" for a host event."""
    kind = ev.activity_type() if hasattr(ev, "activity_type") else None
    if kind is not None:
        return kind if kind in DEVICE_KINDS else ""
    # Versions without activity_type: a device event by its device type.
    if "CUDA" not in str(ev.device_type()):
        return ""
    name = ev.name().lower()
    if name.startswith("memcpy"):
        return "gpu_memcpy"
    if name.startswith("memset"):
        return "gpu_memset"
    return "kernel"


def _device_ops(prof) -> list:
    ops = []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if kind:
            start = ev.start_ns()
            ops.append(DeviceOp(ev.name(), kind, start, start + ev.duration_ns()))
    return ops
