"""Mesh-sharded serving on one process's ``(data, model)`` device mesh
(port of ``nerf_replication_tpu/scale/mesh_dispatch.py``).

The JAX package serves a mesh from one process: ``shard_map`` splits a
bucket's whole ray chunks over the ``data`` axis, and under a model axis
``M > 1`` GSPMD shards the parameters by the tensor-parallel rules and
places the collectives. The port's :class:`~..parallel.mesh.Mesh` is a
process group, one rank a card; the serving mesh is a type of its own,
:class:`ServeMesh`: a ``(D, M)`` array of ``torch.device`` addressed by one
process.

* **Data axis.** A bucket's ``bucket // chunk`` chunks split into ``D``
  contiguous groups, one a data index. Each data index ``d`` has a
  :class:`Lane` on its device ``(d, 0)``: the slots (the network's
  parameters, one K5 ``FusedWeights`` per family, the grid and the bbox),
  its own routes and, on the card, its own captured graphs (a registry of
  its own: a memory pool no other lane replays into) and its own stream.
  :func:`launch_lanes` launches every lane's replay or route, then
  :func:`lanes_to_host` copies every lane's outputs back and concatenates
  them in chunk order, so the devices overlap. Rays are independent and
  every chunk runs the math it runs without a mesh, so every family is
  bitwise equal to the mesh-less engine, for every ``M``.
* **Model axis.** The hand-written kernels cannot split a weight matrix or
  a table (neither can XLA split a ``pallas_call``: under GSPMD the JAX
  package gathers those operands and repeats the work over ``model``).
  So a scene lives sharded at rest (:func:`place_tree`): on devices ``(d,
  0..M-1)`` one piece each of the tensors the rule table
  (``parallel/sharding.py``) splits, along the split dimension of the
  port's layout, and the replicated tensors, the grid and the bbox on
  ``(d, 0)``. A scene switch fills lane ``d``'s slots from the ``M``
  pieces (:func:`gather_into`, a ``copy_`` into each piece's slice: the
  all-gather, exact). The lanes' full slots are the engine's fixed
  working set; the bytes of a scene at rest fall by about ``M`` a device
  (:func:`scene_nbytes`, what fleet admission checks).

:func:`validate_mesh_buckets` rejects a bucket layout the data axis cannot
split at engine construction, and :func:`mesh_from_scale_cfg` builds the
mesh the ``scale:`` block asks for, in the JAX package's words.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.mesh import DATA_AXIS, MODEL_AXIS


class MeshDispatchError(ValueError):
    """The serve bucket layout cannot shard over the configured mesh (or
    ``scale.mesh`` names no mode)."""


# after MeshDispatchError: options.py re-exports it from here
from .options import MeshShapeError  # noqa: E402  (re-export; raised here too)


def validate_mesh_buckets(buckets, chunk: int, mesh) -> None:
    """Reject bucket sets whose chunk counts don't divide over the mesh's
    data axis (at engine construction, before warm-up). The model axis
    splits parameters, not chunks; the error names the full 2-D shape."""
    n_data = int(mesh.shape[DATA_AXIS])
    n_model = int(mesh.shape.get(MODEL_AXIS, 1))
    bad = [int(b) for b in buckets if (int(b) // int(chunk)) % n_data]
    if bad:
        raise MeshDispatchError(
            f"buckets {bad} have chunk counts not divisible by the data "
            f"size {n_data} of the ({n_data}, {n_model}) mesh "
            f"(chunk={chunk}); adjust serve.buckets so every bucket "
            f"holds a multiple of {n_data} chunks"
        )


def model_size(mesh) -> int:
    """The mesh's model-axis extent (1 when absent or mesh is None)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(MODEL_AXIS, 1))


@dataclass(frozen=True, eq=False)
class ServeMesh:
    """A ``(data, model)`` device mesh of one process: ``devices`` a ``(D,
    M)`` object array of ``torch.device`` (devices may repeat: a layout
    over ``[cpu] * 8`` or ``[cuda:0] * 2`` splits, shards and gathers as
    one over distinct devices does)."""

    devices: np.ndarray

    @property
    def shape(self) -> dict:
        d, m = self.devices.shape
        return {DATA_AXIS: int(d), MODEL_AXIS: int(m)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    axis_names = (DATA_AXIS, MODEL_AXIS)


def default_devices(lead=None) -> list:
    """The devices a mesh spans by default: every visible card, from the
    card ``lead`` names on (default: ``cuda:0``) and then the others in
    turn, so the mesh's ``(0, 0)`` is the engine's device; else the
    CPU."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        first = 0 if lead is None else torch.device(lead).index or 0
        return [torch.device("cuda", (first + i) % n) for i in range(n)]
    return [torch.device("cpu")]


def make_serve_mesh(data: int, model: int, devices) -> ServeMesh:
    """The first ``data * model`` of ``devices`` as a ``(data, model)``
    mesh (JAX ``make_mesh``'s row-major layout, a sub-mesh allowed)."""
    devices = [torch.device(d) for d in devices]
    if data * model > len(devices):
        raise MeshShapeError(f"mesh {data}x{model} needs {data * model} "
                             f"devices, have {len(devices)}")
    grid = np.empty((data, model), dtype=object)
    for i, dev in enumerate(devices[:data * model]):
        grid[i // model, i % model] = dev
    return ServeMesh(grid)


def mesh_from_scale_cfg(cfg, devices=None) -> ServeMesh | None:
    """The serving mesh the ``scale:`` block asks for (None = off).

    ``scale.mesh``: ``off`` serves without a mesh; ``auto`` builds the
    data-parallel mesh only when more than one device is visible;
    ``force`` builds it even on one device. ``scale.mesh_shape: [D, M]``
    picks an explicit layout (``D = -1``: all remaining devices); one that
    does not fit raises :class:`MeshShapeError`. ``devices`` (default:
    :func:`default_devices`) is what the mesh lays out; tests pass a list
    that repeats a device to lay out a wider mesh."""
    from .options import ScaleOptions

    opts = ScaleOptions.from_cfg(cfg)
    mode = opts.mesh
    if mode not in ("off", "auto", "force"):
        raise MeshDispatchError(
            f"scale.mesh must be off|auto|force, got {mode!r}"
        )
    if mode == "off":
        return None
    devices = default_devices() if devices is None else list(devices)
    n_dev = len(devices)
    if mode == "auto" and n_dev <= 1:
        return None
    if opts.mesh_shape is None:
        # data-parallel only: every device on the data axis
        return make_serve_mesh(n_dev, 1, devices)
    d, m = opts.mesh_shape
    if n_dev % m:
        raise MeshShapeError(
            f"scale.mesh_shape ({d}, {m}): model size {m} does not "
            f"divide the {n_dev} visible devices"
        )
    want = (n_dev // m if d == -1 else d) * m
    if want > n_dev:
        raise MeshShapeError(
            f"scale.mesh_shape ({d}, {m}) needs {want} devices, only "
            f"{n_dev} visible"
        )
    return make_serve_mesh(want // m, m, devices)


# -- scenes at rest on the mesh ----------------------------------------------


@dataclass(frozen=True, eq=False)
class MeshParams:
    """A state dict at rest on a mesh: ``pieces[d][name]`` is a tuple of
    ``M`` tensors (piece ``m`` on device ``(d, m)``) for a tensor the rules
    split along ``dims[name]``, else a 1-tuple on ``(d, 0)``."""

    pieces: tuple
    dims: dict


def _bounds(size: int, parts: int) -> list:
    """``[(start, length)]`` of ``parts`` pieces of ``size``: ``ceil(size /
    parts)`` each, the last shorter (the rule table's byte count)."""
    step = -(-int(size) // parts)
    return [(min(m * step, size), max(0, min(step, size - m * step)))
            for m in range(parts)]


def place_tree(mesh: ServeMesh, tree):
    """A host ``(params, grid, bbox)`` on the mesh: ``((MeshParams, grids,
    bboxes), ready)`` with one grid and bbox a data index (on ``(d, 0)``)
    and ``ready`` the events the card copies recorded (a tuple, empty on
    the CPU). On a card each device's copies run on a side stream of its
    own, from the (pinned) host tensors."""
    from ..parallel.sharding import spec_for_path, split_dim

    params, grid, bbox = tree
    n_data, n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    # the dimension each tensor splits along (None: replicated); with M = 1
    # a split tensor is one piece
    dims = {k: split_dim(spec_for_path(k, v)) for k, v in params.items()}
    streams: dict = {}

    def put(t, dev):
        if dev.type != "cuda":
            return t.to(dev, copy=True)
        if dev not in streams:
            streams[dev] = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(streams[dev]):
            return t.to(dev, non_blocking=True)

    pieces, grids, bboxes = [], [], []
    for d in range(n_data):
        devs = mesh.devices[d]
        lane = {}
        for name, t in params.items():
            dim = dims[name]
            if dim is None:
                lane[name] = (put(t, devs[0]),)
            else:
                lane[name] = tuple(
                    put(t.narrow(dim, a, n).contiguous(), devs[m])
                    for m, (a, n) in enumerate(_bounds(t.shape[dim],
                                                       n_model)))
        pieces.append(lane)
        grids.append(None if grid is None else put(grid, devs[0]))
        bboxes.append(None if bbox is None else put(bbox, devs[0]))
    ready = []
    for dev, stream in streams.items():
        ev = torch.cuda.Event()
        ev.record(stream)
        ready.append(ev)
    return ((MeshParams(tuple(pieces), dims), tuple(grids), tuple(bboxes)),
            tuple(ready))


def scene_nbytes(mesh: ServeMesh, tree) -> int:
    """Bytes the largest device holds once :func:`place_tree` placed
    ``tree``: the rule table's per-device bytes of the params
    (``tree_shard_nbytes``) plus the grid and the bbox, JAX's figure."""
    from ..parallel.sharding import tree_shard_nbytes

    params, grid, bbox = tree
    rest = sum(int(t.numel()) * int(t.element_size())
               for t in (grid, bbox) if t is not None)
    return tree_shard_nbytes(params, mesh) + rest


def gather_into(slots: dict, params: MeshParams, d: int, stream=None) -> None:
    """Fill data index ``d``'s slots (``{name: tensor}``) from its pieces:
    each piece copied into its slice of the slot (the all-gather; exact).
    With a ``stream`` (the lane's, current here) each card source is kept
    alive until that stream has read it."""
    lane = params.pieces[d]
    for name, dst in slots.items():
        src = lane[name]
        dim = params.dims[name]
        if dim is None:
            dst.copy_(src[0])
        else:
            for piece, (a, n) in zip(src, _bounds(dst.shape[dim], len(src))):
                dst.narrow(dim, a, n).copy_(piece)
        if stream is not None:
            for piece in src:
                if piece.device.type == "cuda":
                    piece.record_stream(stream)


# -- the data axis: lanes ----------------------------------------------------


class Lane:
    """Data index ``index``'s working set on ``device``: the slots
    (``network``, ``grid``, ``bbox``, ``fused``: K5's packed weights a
    family), the built routes ``fns`` and captured routes ``captured`` a
    ``(bucket, family)``, the registry ``aot`` that captured them, and
    ``stream`` (None: the device's current stream, the mesh-less engine)."""

    def __init__(self, index: int, device, network, grid, bbox, aot,
                 stream=None):
        self.index = int(index)
        self.device = device
        self.network = network
        self.grid = grid
        self.bbox = bbox
        self.aot = aot
        self.stream = stream
        self.fused: dict = {}
        self.fns: dict = {}
        self.captured: dict = {}

    @contextmanager
    def on_stream(self):
        """Make the lane's stream current, after the work the device's
        current stream already holds."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            yield

    def slot_nbytes(self) -> int:
        """Bytes of the lane's parameter, grid and bbox slots."""
        tensors = [*self.network.state_dict().values(), self.grid, self.bbox]
        return sum(int(t.numel()) * int(t.element_size())
                   for t in tensors if t is not None)


def launch_lanes(lanes, rays: torch.Tensor, call, events=None) -> list:
    """``call(lane, rays_d)`` on every lane's stream, ``rays_d`` the lane's
    contiguous share of the host ``rays`` (whole chunks: the bucket layout
    was validated). Returns the lanes' device outputs, not yet waited for.
    ``events`` (a list, on the card) gets each lane's (start, end) timing
    events."""
    n = rays.shape[0] // len(lanes)
    outs = []
    for lane in lanes:
        part = rays[lane.index * n:(lane.index + 1) * n]
        with lane.on_stream():
            if events is not None and lane.stream is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(lane.stream)
            outs.append(call(lane, part))
            if events is not None and lane.stream is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(lane.stream)
                events.append((start, end))
    return outs


def lanes_to_host(lanes, outs) -> dict:
    """Every lane's outputs copied to host numpy (each on its lane's
    stream, so the first copy waits for its own lane only), concatenated
    in chunk order."""
    host = []
    for lane, out in zip(lanes, outs):
        with lane.on_stream():
            # graftlint: ok(blocking-under-lock: a replay's static outputs are read back under the engine's lock — the next replay overwrites them)
            host.append({k: v.cpu().numpy() for k, v in out.items()})
    if len(host) == 1:
        return host[0]
    return {k: np.concatenate([h[k] for h in host], axis=0)
            for k in host[0]}


def overlap_ms(events) -> dict:
    """``{lanes_ms, span_ms, overlap_ms}`` of one dispatch's lane events:
    the sum of the lanes' device ms, the ms from the first lane's start to
    the last lane's end, and what the lanes ran at once (their sum less the
    span)."""
    events[-1][1].synchronize()
    lanes = [s.elapsed_time(e) for s, e in events]
    first = events[0][0]
    span = max(first.elapsed_time(e) for _, e in events)
    return {"lanes_ms": lanes, "span_ms": span,
            "overlap_ms": sum(lanes) - span}
