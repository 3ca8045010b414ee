"""Mean host time of ``retrieve_batch``'s ``tokenize`` stage per call
(the program's ``StageTimer`` through ``timings_out``), ms."""

from harness import readers


def read(ctx):
    return readers.tokenize_mean_ms(ctx)
