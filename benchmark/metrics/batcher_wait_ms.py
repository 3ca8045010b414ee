"""95th percentile of a query's wait in the batcher: from its due time
to the start of the ``retrieve_batch`` call that carries it (harness
spans around ``MicroBatcher``'s ``fn_batch``), ms."""

from harness import readers


def read(ctx):
    return readers.batcher_wait_p95_ms(ctx)
