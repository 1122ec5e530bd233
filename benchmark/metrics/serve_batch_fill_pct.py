"""How full the batcher's buckets ran (``serve/batcher.py`` over the
engine's buckets): the engine's rendered rays over rendered plus padding
rays, over the window."""


def read(ctx):
    real = ctx.counters["n_rays_rendered"]
    total = real + ctx.counters["n_pad_rays"]
    return 100.0 * real / total if total > 0 else None
