"""95th percentile of the measured window's query latency, from each
query's due time to its answer, computed as ``query_p95_ms`` is, in the
cell whose tail moves with the host's speed by more than an end-to-end
bound can hold, ms."""

import math

import numpy as np

from harness import runner


def read(ctx):
    rec = ctx["rec"]
    if rec.ok.size == 0:
        return None
    lat = np.where(rec.ok, rec.done - rec.due, math.inf) * 1e3
    return runner.percentile(lat, 95)
