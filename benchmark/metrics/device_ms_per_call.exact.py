"""Device time (kernels and copies, torch.profiler) in the traced
window over the graph launches in it: ms of device work per
``retrieve_batch`` call."""

from harness import readers


def read(ctx):
    return readers.device_ms_per_call(ctx)
