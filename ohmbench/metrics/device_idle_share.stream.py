"""Share of the traced window in which no operation ran on the device:
1 - (the union of device activity intervals) / (the window's host seconds).
Overlapping activities (a copy beside a kernel) count once."""

UNIT = "%"
LAYER = "device"
MOVES = "rays_per_s"
SOURCE = "device_trace"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
