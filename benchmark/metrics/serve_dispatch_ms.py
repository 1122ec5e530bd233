"""The host's part of a dispatch (``serve/engine.py``): the median of the
program's ``serve.dispatch`` spans in the window (copy in, the route's
replay or launch)."""

import statistics


def read(ctx):
    d = ctx.spans.durations_ms("serve.dispatch")
    return statistics.median(d) if d else None
