"""Share of the traced window in which the device was idle (no kernel, copy
or memset: the complement of the union of device operations) inside the
program's ``worker.prep`` spans (the host preparing a batch), on the device
trace's clock.  With the idle shares inside the other worker spans and
``device_idle_unattributed_share.stream`` it adds up to
``device_idle_share.stream`` (``ohmbench/spans.py``)."""

from ohmbench import spans

UNIT = "%"
LAYER = "device"
MOVES = "rays_per_s"
SOURCE = "device_trace"


def probe(ctx, mapper):
    spans.probe(ctx)


def read(ctx):
    shares = spans.idle_shares(ctx)
    return None if shares is None else shares["worker.prep"]
