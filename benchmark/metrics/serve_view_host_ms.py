"""The view's host work around its render (``serve/engine.py``
``render_view``): the median over the window's views of the program's
``serve.rays`` (pose to rays) plus ``serve.image`` (reply to image and
cache put) spans, from the traced run's span rows."""

import statistics

from harness.spans import view_host_s


def read(ctx):
    d = view_host_s(ctx.spans.rows)
    return statistics.median(d) * 1e3 if d else None
