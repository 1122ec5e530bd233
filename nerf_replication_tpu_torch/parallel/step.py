"""The data-parallel and the ``data x model`` train steps (port of
``build_dp_step`` / ``build_gspmd_step`` in
``nerf_replication_tpu/parallel/step.py``; :class:`TPStep` below for the
model axis).

JAX runs the step under ``shard_map``: each shard draws ``N_rays / n_data``
rays from its bank slice with a key folded by its axis index, computes
gradients, ``pmean`` s gradients and stats over the data axis, and applies
them. The port's step is the same program on every rank, in three pieces:

1. draw → forward → backward, the gradients and stats packed into one flat
   float32 buffer (:class:`FlatGrads`) — captured as a CUDA graph;
2. an eager ``all_reduce(SUM)`` of that buffer, then a division by the world
   size (a gloo collective stages through the host and cannot be captured;
   one collective a step);
3. unpack → clip by value at 40 → Adam — captured.

The all-reduce comes before the clip, as JAX's ``pmean`` before
``apply_gradients``, so a two-rank step is bitwise ``(g0 + g1) / 2`` fed to
the single-card update, and a one-rank step is bitwise the single-card step.
Rank ``r`` draws from ``step_seed(seed, step, r)``; rank 0's stream is the
single-card stream.

``TIME_REDUCE = True`` records each all-reduce's milliseconds between CUDA
events on the current stream (``REDUCE_MS``): from the end of piece 1 to
the end of the division, which is what the collective adds to a step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..datasets.sampling import reseed
from ..train.optim import optimizer_step, set_lr
from ..train.step_core import sampled_grad_step
from .collectives import all_reduce_
from .mesh import DATA_AXIS

TIME_REDUCE = False
REDUCE_MS: list = []


class FlatGrads:
    """One float32 buffer holding a step's gradients (of the parameters that
    have one, in order) and its stats (sorted keys), so that the ranks
    reduce them with one collective. The buffer and its layout are made on
    the first :meth:`pack` (the eager warm-up of a captured step), and
    reused: a captured segment writes and reads it where it lies."""

    def __init__(self):
        self.buf: torch.Tensor | None = None
        self.params: list = []
        self.keys: list = []
        self.dtypes: dict = {}

    @property
    def nbytes(self) -> int:
        return 0 if self.buf is None else self.buf.numel() * 4

    def pack(self, params, stats: dict, grads=None) -> None:
        """``grads``: the tensor packed for each of ``params`` (default:
        its ``.grad``; None: it has none), unpacked into its ``.grad``."""
        params = list(params)
        if grads is None:
            grads = [p.grad for p in params]
        if self.buf is None:
            self.params = [p for p, g in zip(params, grads) if g is not None]
            self.keys = sorted(stats)
            self.dtypes = {k: stats[k].dtype for k in self.keys}
            n = sum(p.numel() for p in self.params) + len(self.keys)
            self.buf = torch.empty(n, dtype=torch.float32,
                                   device=self.params[0].device)
        parts = [g.reshape(-1).to(torch.float32) for g in grads
                 if g is not None]
        parts += [stats[k].reshape(1).to(torch.float32) for k in self.keys]
        torch.cat(parts, out=self.buf)

    def reduce(self, mesh) -> None:
        """The eager piece: sum over the ranks, then divide by their
        number."""
        if TIME_REDUCE and self.buf.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        all_reduce_(self.buf, mesh, "sum").div_(mesh.size)
        if TIME_REDUCE and self.buf.is_cuda:
            end.record()
            end.synchronize()
            REDUCE_MS.append(start.elapsed_time(end))

    def unpack_grads(self) -> None:
        """Each parameter's ``.grad`` a view of the buffer."""
        off = 0
        for p in self.params:
            n = p.numel()
            p.grad = self.buf[off:off + n].view_as(p).to(p.dtype)
            off += n

    def stats(self) -> dict:
        """The reduced stats (copies: the next step overwrites the
        buffer)."""
        off = self.buf.numel() - len(self.keys)
        return {k: self.buf[off + i].clone().to(self.dtypes[k])
                for i, k in enumerate(self.keys)}


def local_batch(n_rays_global: int, mesh, what: str = "n_rays_global") -> int:
    """Rays a rank draws: the global batch over the data axis, which must
    divide it (a silent round-down would train another batch)."""
    n_data = int(mesh.shape[DATA_AXIS])
    if n_rays_global % n_data:
        raise ValueError(
            f"{what}={n_rays_global} must divide the data axis ({n_data}) "
            "— a silent round-down would train a different effective batch "
            "than configured")
    return n_rays_global // n_data


class DPStep:
    """``step(state, bank_rays, bank_rgbs[, pool]) -> (state, stats)`` over
    ``mesh`` with this rank's bank slice (and precrop pool segment):
    ``k_steps`` steps of the three pieces above; returns the last step's
    reduced stats. With a registry (:meth:`aot_register`) pieces 1 and 3
    replay captured graphs."""

    def __init__(self, mesh, loss, n_rays_global: int, near: float,
                 far: float, seed: int = 0, k_steps: int = 1,
                 grad_accum: int = 1):
        self.mesh = mesh
        self.loss = loss
        self.n_local = local_batch(n_rays_global, mesh)
        self.near, self.far = float(near), float(far)
        self.seed = int(seed)
        self.k_steps = max(1, int(k_steps))
        self.grad_accum = max(1, int(grad_accum))
        self.flat = FlatGrads()
        self.aot = None
        self._gen: torch.Generator | None = None
        self._step_t: torch.Tensor | None = None

    def _prepare(self, state, device) -> None:
        """The host part: this rank's stream at the step, the lr and the
        step count."""
        device = torch.device(device)
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device)
            self._step_t = (torch.zeros((), dtype=torch.int64, device=device)
                            if device.type == "cuda" else None)
        reseed(self._gen, self.seed, state.step, self.mesh.rank)
        set_lr(state.optimizer, state.schedule, state.step)
        if self._step_t is not None:
            self._step_t.fill_(state.step)

    def grad_segment(self, state, bank_rays, bank_rgbs, pool=None) -> None:
        """Piece 1 (capturable): draw, render, backward, pack."""
        stats = sampled_grad_step(
            self.loss, state.network.parameters(), bank_rays, bank_rgbs,
            self.n_local, self.near, self.far, self._gen, index_pool=pool,
            grad_accum=self.grad_accum,
            step=state.step if self._step_t is None else self._step_t)
        self.flat.pack(state.network.parameters(), stats)

    def update_segment(self, state) -> None:
        """Piece 3 (capturable): unpack, clip, Adam."""
        self.flat.unpack_grads()
        optimizer_step(state.optimizer)

    def capture_grad(self, state) -> bool:
        """Whether piece 1 can be captured (it holds no collective)."""
        return True

    @staticmethod
    def _grad_name(pool: bool) -> str:
        return "dp_grad_pool" if pool else "dp_grad"

    def _take(self, name):
        return None if self.aot is None else self.aot.take(name)

    def one_step(self, state, bank_rays, bank_rgbs, pool=None) -> dict:
        self._prepare(state, bank_rays.device)
        fn = self._take(self._grad_name(pool is not None))
        if fn is not None:
            fn()
        else:
            self.grad_segment(state, bank_rays, bank_rgbs, pool)
        self.flat.reduce(self.mesh)
        fn = self._take("dp_update")
        if fn is not None:
            fn()
        else:
            self.update_segment(state)
        state.step += 1
        return self.flat.stats()

    def __call__(self, state, bank_rays, bank_rgbs, pool=None, k_steps=None):
        stats = None
        for _ in range(max(1, int(k_steps or self.k_steps))):
            stats = self.one_step(state, bank_rays, bank_rgbs, pool)
        return state, stats

    def aot_register(self, registry, state, bank, pool=None) -> None:
        """Capture pieces 1 (with the pool's variant when ``pool`` is given)
        and 3 in ``registry`` (the state restored after their warm-ups)."""
        from ..train.trainer import capture_steps

        self.aot = registry
        if registry is None or not registry.enabled:
            return
        self._prepare(state, bank[0].device)
        entries = {}
        if self.capture_grad(state):
            entries[self._grad_name(False)] = lambda: self.grad_segment(
                state, bank[0], bank[1])
            if pool is not None:
                entries[self._grad_name(True)] = lambda: self.grad_segment(
                    state, bank[0], bank[1], pool)
        elif self.flat.buf is None:
            # piece 3 unpacks the buffer that piece 1's first pack lays out
            self.grad_segment(state, bank[0], bank[1], pool)
        entries["dp_update"] = lambda: self.update_segment(state)
        if not capture_steps(self, state, entries):
            self._gen = None


def build_dp_step(mesh, loss, n_rays_global: int, near: float, far: float,
                  seed: int = 0, k_steps: int = 1,
                  grad_accum: int = 1) -> DPStep:
    """The DP step over ``mesh`` (the JAX builder's arguments, plus the
    run's ``seed``: the port's streams are seeded on the host; a precrop
    pool segment is passed with each call, where JAX compiles a pool
    variant)."""
    return DPStep(mesh, loss, n_rays_global, near, far, seed=seed,
                  k_steps=k_steps, grad_accum=grad_accum)


def aot_register_dp_step(registry, state, bank, *, mesh, loss,
                         n_rays_global: int, near: float, far: float,
                         seed: int = 0, k_steps: int = 1, pool=None,
                         grad_accum: int = 1) -> DPStep:
    """A :class:`DPStep` whose pieces 1 and 3 are captured in ``registry``
    (JAX registers the sharded executable)."""
    step = build_dp_step(mesh, loss, n_rays_global, near, far, seed=seed,
                         k_steps=k_steps, grad_accum=grad_accum)
    step.aot_register(registry, state, bank, pool)
    return step


# -- tensor parallelism over the (data, model) mesh --------------------------

GATHER_MS: list = []


class TPLeaf:
    """One parameter under the rule table: ``full`` (the network's
    tensor), ``block`` (what the optimizer updates: this rank's block of
    ``full`` along ``dim``, or ``full`` itself when replicated), the block's
    ``start`` / ``length`` / padded ``size``, and whether its layer runs
    column-parallel (``column``) or on gathered weights."""

    __slots__ = ("name", "full", "block", "dim", "start", "length", "size",
                 "column")

    def __init__(self, name, full, mesh, dim, column):
        from .tensor import block_range

        self.name, self.full, self.dim, self.column = name, full, dim, column
        if dim is None:
            self.block, self.start, self.length, self.size = full, 0, 0, 0
            return
        n = full.shape[dim]
        self.start, self.length = block_range(n, mesh)
        self.size = -(-n // mesh.model)
        self.block = torch.nn.Parameter(
            full.detach().narrow(dim, self.start, self.length).clone())

    def local_grad(self):
        """The gradient this rank reduces and applies to its block."""
        if self.dim is None:
            return self.full.grad
        if self.column:
            return self.block.grad
        g = self.full.grad
        return None if g is None else g.narrow(self.dim, self.start,
                                               self.length)


class TPLayout:
    """A network's parameters split by the rule table over ``mesh``'s model
    axis. ``column``: the plain trunk's ``Dense`` / ``SplitDense`` layers run
    column-parallel (``parallel/tensor.py``); otherwise every split leaf is
    all-gathered into the network's full tensor before a step (the fused
    trunk's K1/K2 and the hash table's K6/K6b take whole operands, as XLA
    gathers a ``pallas_call``'s)."""

    def __init__(self, network, mesh, column: bool = False):
        from ..models.nerf.network import Dense, SplitDense
        from .sharding import spec_for_path, split_dim

        self.mesh = mesh
        modules = dict(network.named_modules())
        self.leaves: list[TPLeaf] = []
        owners = {}
        for name, p in network.named_parameters():
            dim = split_dim(spec_for_path(name, p))
            owner = modules[name.rpartition(".")[0]]
            col = (column and dim == 0
                   and isinstance(owner, (Dense, SplitDense)))
            leaf = TPLeaf(name, p, mesh, dim, col)
            self.leaves.append(leaf)
            if col:
                owners.setdefault(id(owner), [owner, None, None])[
                    1 if name.endswith("weight") else 2] = leaf.block
        self.columns = [tuple(v) for v in owners.values()]

    @property
    def blocks(self) -> list:
        return [leaf.block for leaf in self.leaves]

    def grad_params(self) -> list:
        """Every tensor a step's backward writes a gradient into."""
        return ([leaf.full for leaf in self.leaves]
                + [leaf.block for leaf in self.leaves if leaf.column])

    def split_leaves(self, gathered_only: bool) -> list[TPLeaf]:
        return [leaf for leaf in self.leaves if leaf.dim is not None
                and not (gathered_only and leaf.column)]

    @torch.no_grad()
    def gather(self, all_leaves: bool = False) -> int:
        """Every rank's blocks into the network's full tensors, in place:
        one all-gather over the model group (the gathered leaves; with
        ``all_leaves`` the column ones too, for validation and saves).
        Returns the bytes this rank sent."""
        from .collectives import _count
        from .tensor import pad_block

        leaves = self.split_leaves(not all_leaves)
        if not leaves:
            return 0
        flat = torch.cat([pad_block(leaf.block.detach(), leaf.dim,
                                    leaf.size).reshape(-1)
                          for leaf in leaves])
        _count("all_gather", flat)
        parts = [torch.empty_like(flat) for _ in range(self.mesh.model)]
        dist.all_gather(parts, flat, group=self.mesh.model_group)
        for m, part in enumerate(parts):
            off = 0
            for leaf in leaves:
                shape = list(leaf.full.shape)
                shape[leaf.dim] = leaf.size
                n = int(np.prod(shape))
                start = m * leaf.size
                length = max(0, min(leaf.size, leaf.full.shape[leaf.dim]
                                    - start))
                if length:
                    leaf.full.narrow(leaf.dim, start, length).copy_(
                        part[off:off + n].view(shape).narrow(leaf.dim, 0,
                                                             length))
                off += n
        return flat.numel() * flat.element_size()

    @torch.no_grad()
    def pull_blocks(self) -> None:
        """The blocks from the full tensors (after a load into the
        network), in place."""
        for leaf in self.split_leaves(False):
            leaf.block.copy_(leaf.full.narrow(leaf.dim, leaf.start,
                                              leaf.length))

    def slice_optimizer_state(self, saved: dict) -> dict:
        """A one-card optimizer state dict (moments shaped as the full
        parameters) cut to this rank's blocks."""
        state = {}
        for i, st in saved["state"].items():
            leaf = self.leaves[int(i)]
            state[i] = {k: (v.narrow(leaf.dim, leaf.start, leaf.length)
                            .clone() if leaf.dim is not None
                            and torch.is_tensor(v)
                            and v.shape == leaf.full.shape else v)
                        for k, v in st.items()}
        return {"state": state, "param_groups": saved["param_groups"]}

    def gathered_optimizer_state(self, optimizer) -> dict:
        """The block optimizer's state dict with every moment all-gathered
        to its full shape: a one-card optimizer over the network's
        parameters loads it (every rank must call this)."""
        from .tensor import gather_blocks

        sd = optimizer.state_dict()
        state = {}
        for i, st in sd["state"].items():
            leaf = self.leaves[int(i)]
            state[i] = {k: (gather_blocks(v, self.mesh, leaf.dim,
                                          leaf.full.shape[leaf.dim])
                            if leaf.dim is not None and torch.is_tensor(v)
                            and v.shape == leaf.block.shape else v)
                        for k, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def full_state(self, state):
        """The gathered training state a checkpoint holds (every rank must
        call this): the network with its full weights and an optimizer
        whose ``state_dict`` is the gathered one."""
        from dataclasses import replace

        self.gather(all_leaves=True)
        return replace(state, optimizer=_SavedOptimizer(
            self.gathered_optimizer_state(state.optimizer)), tp=None)

    @torch.no_grad()
    def broadcast_blocks(self, optimizer) -> None:
        """Each block and its moments from data index 0 of this rank's data
        group (the ranks of one model index), in place."""
        from .collectives import _count

        if self.mesh.shape[DATA_AXIS] == 1:
            return
        tensors = list(self.blocks)
        for b in self.blocks:
            st = optimizer.state.get(b, {})
            tensors += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
        for t in tensors:
            _count("broadcast", t)
            dist.broadcast(t, src=self.mesh.model_index,
                           group=self.mesh.data_group)


class _SavedOptimizer:
    """What ``save_model`` reads of an optimizer: its state dict."""

    def __init__(self, sd: dict):
        self._sd = sd

    def state_dict(self) -> dict:
        return self._sd


def shard_train_state(state, mesh, column: bool = False):
    """The TP state of a one-card ``TrainState`` (JAX ``shard_train_state``):
    the network keeps its full tensors (the gathered weights), the
    optimizer runs on this rank's blocks (Adam's moments cut from the
    one-card ones), ``state.tp`` holds the :class:`TPLayout`."""
    from dataclasses import replace

    from ..train.checkpoint import load_optimizer_state
    from ..train.optim import make_capturable

    layout = TPLayout(state.network, mesh, column)
    old = state.optimizer
    opt = type(old)(layout.blocks, **old.defaults)
    saved = old.state_dict()
    if saved["state"]:
        load_optimizer_state(opt, layout.slice_optimizer_state(saved))
    make_capturable(opt)
    return replace(state, optimizer=opt, tp=layout)


class TPStep(DPStep):
    """The GSPMD ``data x model`` step (JAX ``build_gspmd_step``) over
    ``mesh`` and a state made by :func:`shard_train_state`: the data axis as
    :class:`DPStep` over this rank's data group (each data group draws from
    its bank slice with the stream of its data index; every model rank of
    a group draws the same rays), the model axis by ``state.tp``:

    0. one all-gather of the gathered leaves' blocks over the model group
       into the full weights (eager; ``GATHER_MS`` under ``TIME_REDUCE``);
    1. draw → forward → backward (the column layers column-parallel), this
       rank's gradient blocks and the stats packed (captured, unless a
       column layer's collectives sit inside it);
    2. the all-reduce over the data group, then the division (eager);
    3. unpack into the blocks → clip → Adam on the blocks (captured).

    Adam and the clip are elementwise, so a rank's blocks after a step are
    bitwise the columns of the data-parallel step's update when the forward
    ran on gathered weights."""

    def __init__(self, mesh, loss, n_rays_global: int, near: float,
                 far: float, seed: int = 0, k_steps: int = 1,
                 grad_accum: int = 1):
        local_batch(n_rays_global, mesh, "n_rays")
        super().__init__(mesh.data_mesh(), loss, n_rays_global, near, far,
                         seed=seed, k_steps=k_steps, grad_accum=grad_accum)
        self.tp_mesh = mesh
        self.gather_bytes = 0

    def capture_grad(self, state) -> bool:
        return not state.tp.columns

    def grad_segment(self, state, bank_rays, bank_rgbs, pool=None) -> None:
        from .tensor import column_parallel

        tp = state.tp
        with column_parallel(tp.columns, self.tp_mesh):
            stats = sampled_grad_step(
                self.loss, tp.grad_params(), bank_rays, bank_rgbs,
                self.n_local, self.near, self.far, self._gen,
                index_pool=pool, grad_accum=self.grad_accum,
                step=state.step if self._step_t is None else self._step_t)
        self.flat.pack(tp.blocks, stats,
                       grads=[leaf.local_grad() for leaf in tp.leaves])

    def _gather(self, state) -> None:
        timed = TIME_REDUCE and self.mesh.device.type == "cuda"
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        self.gather_bytes = state.tp.gather()
        if timed:
            end.record()
            end.synchronize()
            GATHER_MS.append(start.elapsed_time(end))

    def one_step(self, state, bank_rays, bank_rgbs, pool=None) -> dict:
        self._gather(state)
        return super().one_step(state, bank_rays, bank_rgbs, pool)

    def aot_register(self, registry, state, bank, pool=None) -> None:
        self._gather(state)
        super().aot_register(registry, state, bank, pool)


def build_gspmd_step(mesh, loss, n_rays: int, near: float, far: float,
                     seed: int = 0, k_steps: int = 1,
                     grad_accum: int = 1) -> TPStep:
    """The ``data x model`` step over ``mesh`` (JAX's builder's arguments,
    plus the run's ``seed``); ``n_rays`` must divide the data axis."""
    return TPStep(mesh, loss, n_rays, near, far, seed=seed,
                  k_steps=k_steps, grad_accum=grad_accum)


def aot_register_gspmd_step(registry, state, bank, *, mesh, loss,
                            n_rays: int, near: float, far: float,
                            seed: int = 0, k_steps: int = 1,
                            grad_accum: int = 1) -> TPStep:
    """A :class:`TPStep` whose capturable pieces are captured in
    ``registry`` (JAX registers the GSPMD executable)."""
    step = build_gspmd_step(mesh, loss, n_rays, near, far, seed=seed,
                            k_steps=k_steps, grad_accum=grad_accum)
    step.aot_register(registry, state, bank)
    return step
