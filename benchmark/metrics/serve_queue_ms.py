"""The micro-batcher's queue wait (``serve/batcher.py``): the median of
the program's ``serve.queue`` spans in the window, from a request's
submit to the cut of its batch."""

import statistics


def read(ctx):
    d = ctx.spans.durations_ms("serve.queue")
    return statistics.median(d) if d else None
