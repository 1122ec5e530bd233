"""The queue wait spent behind other batches (``serve/batcher.py``): the
95th percentile over the window's requests of the ``behind_s`` attribute
of the program's ``serve.queue`` spans, the part of a request's wait in
which the batcher's worker was rendering other batches (the rest is the
batch edge's: the delay or the ray budget)."""

import numpy as np

from harness.spans import behind_s


def read(ctx):
    d = behind_s(ctx.spans.rows)
    return float(np.percentile(np.asarray(d, np.float64), 95)) * 1e3 \
        if d else None
