"""The measured window's calls: FLOPs of their shapes for the real
queries (encoder, stage A and B or the scan, the rerank) over the sum of
the calls' host-clock durations, against the bf16 peak, %."""

from harness import readers


def read(ctx):
    return readers.step_mfu_pct(ctx)
