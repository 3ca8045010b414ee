"""The int8 full scan's share of its roofline: its bound (bf16 ops at
the tensor-core peak, or bytes at the HBM peak, counted once each from
the rows that hold a token) over its traced time per launch, %."""

from harness import readers


def read(ctx):
    return readers.scan_roofline_pct(ctx, "maxsim_int8")
