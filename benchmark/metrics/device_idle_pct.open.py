"""Share of the traced window in which no device operation ran (1 -
union of the device-op intervals over the window), %."""

from harness import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
