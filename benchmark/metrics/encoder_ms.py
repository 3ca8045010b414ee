"""The query encoder alone, captured as its own CUDA graph at B = 16,
Lq = 32 and timed by CUDA events over 50 replays, ms per replay."""

from harness import readers


def read(ctx):
    return readers.encoder_ms(ctx)
