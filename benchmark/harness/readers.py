"""What the per-layer metric files read. ``ctx`` holds the measured
window's spans (``rec``, ``calls``), the traced window's reduction
(``trace``, in ``--trace 1`` runs), ``encoder_ms``, the cell, its
configuration and the configuration's ``.py`` (``model``), the index's
shape and the card's peaks. Each function
returns None where it finds nothing to read."""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np

from . import yardstick


def batcher_wait_p95_ms(ctx: Dict) -> Optional[float]:
    rec = ctx["rec"]
    wait = (rec.dispatch - rec.due)[rec.ok & ~np.isnan(rec.dispatch)]
    return float(np.percentile(wait, 95) * 1e3) if wait.size else None


def tokenize_mean_ms(ctx: Dict) -> Optional[float]:
    calls = ctx["calls"]
    if not calls:
        return None
    return float(np.mean([c["tokenize_s"] for c in calls]) * 1e3)


def encoder_ms(ctx: Dict) -> Optional[float]:
    return ctx.get("encoder_ms")


def device_ms_per_call(ctx: Dict) -> Optional[float]:
    red = ctx.get("trace")
    if red is None:
        return None
    launches = len(red["launches"])
    return red["op_s"] / launches * 1e3 if launches else None


def device_idle_pct(ctx: Dict) -> Optional[float]:
    red = ctx.get("trace")
    if red is None or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])


def scan_roofline_pct(ctx: Dict, kernel: str = "maxsim_int8") -> Optional[float]:
    """The int8 scan's bound over its traced time per launch (bf16 ops
    at the tensor-core peak or bytes at the HBM peak, whichever is
    longer), on the cell's one flat index at the traced batch."""
    red, peaks = ctx.get("trace"), ctx.get("peaks")
    if red is None or peaks is None or len(ctx["index"]["subs"]) != 1:
        return None
    pat = re.compile(rf"\b{kernel}_kernel\b")
    secs = [v for k, v in red["by_kernel"].items() if pat.search(k)]
    if not secs:
        return None
    t = sum(s for s, _ in secs) / sum(n for _, n in secs)
    b = ctx["cell"]["load"]["batch"]
    lq = ctx["arch"]["query_maxlen"]
    sub = ctx["index"]["subs"][0]
    dim = ctx["index"]["dim"]
    flops = yardstick.scan_flops(b, lq, dim, sub["valid_rows"])
    nbytes = yardstick.scan_int8_bytes(b, lq, dim, sub["valid_rows"],
                                       sub["n_pad"] * sub["doc_len"],
                                       sub["n_pad"])
    return 100.0 * yardstick.roofline_bound_s(flops, nbytes, peaks) / t


def step_mfu_pct(ctx: Dict) -> Optional[float]:
    """FLOPs of the measured window's calls (real queries only) over the
    sum of those calls' host-clock durations, against the bf16 peak."""
    peaks, calls = ctx.get("peaks"), ctx["calls"]
    if peaks is None or not calls:
        return None
    lq = ctx["arch"]["query_maxlen"]
    flops = sum(yardstick.call_flops(ctx["arch"], ctx["route"], ctx["index"],
                                     c["n_real"], lq, ctx["model"])
                for c in calls)
    secs = sum(c["t1"] - c["t0"] for c in calls)
    return 100.0 * flops / secs / peaks["bf16_flops"]
