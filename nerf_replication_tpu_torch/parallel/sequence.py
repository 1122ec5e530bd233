"""Ray-axis (sequence) parallelism: one image rendered over the ranks (port
of ``nerf_replication_tpu/parallel/sequence.py``).

The global ray axis is padded to the world size; each rank renders its
slice through the full coarse + fine pipeline (or the occupancy march) in
``chunk_size``-ray chunks, with no traffic between ranks during the march;
one all-gather at the end rebuilds the image on every rank. A ray's
arithmetic does not depend on the rank or chunk it lands in, so the image
equals the one-process render.

Each builder returns ``render(rays[, grid, bbox]) -> dict`` with a
``local`` attribute: the per-rank render of a padded slice, the function
:func:`aot_register_sequence_renderer` / ``_march`` capture as a CUDA
graph (the all-gather stays eager).
"""

from __future__ import annotations

import torch

from ..renderer.volume import map_chunks, render_rays
from .collectives import all_gather
from .mesh import DATA_AXIS


def local_rays(rays: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of ``rays`` zero-padded to a multiple of the world
    size."""
    n_shards = int(mesh.shape[DATA_AXIS])
    pad = (-rays.shape[0]) % n_shards
    if pad:
        rays = torch.cat([rays, rays.new_zeros((pad, rays.shape[-1]))])
    per = rays.shape[0] // n_shards
    return rays[mesh.rank * per:(mesh.rank + 1) * per]


def gather_rays(out: dict, mesh, n: int) -> dict:
    """Every rank's per-ray outputs concatenated in rank order and cut back
    to the ``n`` real rays: one all-gather of the outputs packed as float32
    columns (exact for float32 and bool)."""
    keys = sorted(out)
    cols = [out[k].reshape(out[k].shape[0], -1).to(torch.float32)
            for k in keys]
    widths = [c.shape[1] for c in cols]
    whole = all_gather(torch.cat(cols, 1), mesh, tiled=True)[:n]
    res, off = {}, 0
    for k, w in zip(keys, widths):
        v = whole[:, off:off + w].reshape((n,) + tuple(out[k].shape[1:]))
        res[k] = v.to(out[k].dtype)
        off += w
    return res


def _chunked(route, rays, chunk_size):
    with torch.no_grad():
        return map_chunks(route, rays, int(chunk_size or rays.shape[0]))


def build_sequence_parallel_renderer(mesh, apply_fn, options, near, far,
                                     chunk_size: int | None = None):
    """``render(rays [N, C]) -> dict`` with the ray axis over ``mesh``'s
    data axis; ``apply_fn(pts, viewdirs, model)`` is the network's (the
    fused trunk's, K1, on the card). ``chunk_size`` bounds a rank's
    activations as ``render_chunked`` does on one card (None: one call)."""
    near, far = float(near), float(far)

    def route(rc):
        return render_rays(apply_fn, rc, near, far, None, options)

    def local(rays):
        return _chunked(route, rays, chunk_size)

    def render(rays):
        mine = local_rays(rays, mesh)
        fn = render.captured.get(mine.shape[0])
        out = fn(mine) if fn is not None else local(mine)
        return gather_rays(out, mesh, rays.shape[0])

    render.local, render.captured, render.mesh = local, {}, mesh
    return render


def build_sequence_parallel_march(mesh, apply_fn, march_options, near, far,
                                  chunk_size: int | None = None):
    """The sequence-parallel ESS + ERT march (the per-ray
    ``march_rays_accelerated``; the grid and bbox replicated on every
    rank): ``march(rays, grid, bbox) -> dict``, whose ``n_truncated`` sums
    the per-ray flags of the real rays."""
    from ..renderer.accelerated import march_rays_accelerated

    near, far = float(near), float(far)

    def local(rays, grid, bbox):
        return _chunked(
            lambda rc: march_rays_accelerated(apply_fn, rc, near, far, grid,
                                              bbox, march_options),
            rays, chunk_size)

    def march(rays, grid, bbox):
        mine = local_rays(rays, mesh)
        fn = march.captured.get(mine.shape[0])
        out = (fn(mine, grid, bbox) if fn is not None
               else local(mine, grid, bbox))
        out = gather_rays(out, mesh, rays.shape[0])
        out["n_truncated"] = torch.sum(out.pop("truncated"))
        return out

    march.local, march.captured, march.mesh = local, {}, mesh
    return march


def padded_rays(n_rays: int, mesh) -> int:
    n_shards = int(mesh.shape[DATA_AXIS])
    return n_rays + (-n_rays) % n_shards


def _aot_register(registry, surface, kind: str, n_rays: int, static=(),
                  width: int = 6) -> str | None:
    """Capture ``surface.local`` on a rank's slice of ``n_rays`` rays
    (``static``: the march's grid and bbox, read where they lie) and
    install it; the name, or None when the capture failed (the slice then
    renders eagerly)."""
    mesh = surface.mesh
    per = padded_rays(int(n_rays), mesh) // int(mesh.shape[DATA_AXIS])
    name = f"seqpar_{kind}_{padded_rays(int(n_rays), mesh)}"
    dev = mesh.device if not static else static[0].device
    rays = torch.zeros((per, width), dtype=torch.float32, device=dev)
    registry.register(name, surface.local, (rays, *static))
    registry.compile_all()
    fn = registry.take(name)
    if fn is None:
        return None
    surface.captured[per] = fn
    return name


def aot_register_sequence_renderer(registry, render, n_rays: int,
                                   width: int = 6) -> str | None:
    """A :func:`build_sequence_parallel_renderer`'s slice captured in
    ``registry`` (``seqpar_render_{n_pad}``, the JAX name)."""
    return _aot_register(registry, render, "render", n_rays, width=width)


def aot_register_sequence_march(registry, march, n_rays: int, grid,
                                bbox) -> str | None:
    """A :func:`build_sequence_parallel_march`'s slice captured with the
    grid and bbox it reads (``seqpar_march_{n_pad}``)."""
    return _aot_register(registry, march, "march", n_rays, (grid, bbox))
