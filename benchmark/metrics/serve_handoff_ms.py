"""The hand-off of a reply to its client (``serve/batcher.py``): the
median of the program's ``serve.handoff`` spans in the window, from the
batcher setting the request's future to ``result()`` returning on the
client's thread (its wake-up and wait for the interpreter)."""

import statistics


def read(ctx):
    d = ctx.spans.durations_ms("serve.handoff")
    return statistics.median(d) if d else None
