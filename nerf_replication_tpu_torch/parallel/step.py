"""The data-parallel train step (port of ``build_dp_step`` in
``nerf_replication_tpu/parallel/step.py``).

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

import torch

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

    def pack(self, params, stats: dict) -> None:
        if self.buf is None:
            self.params = [p for p in params if p.grad is not None]
            self.keys = sorted(stats)
            self.dtypes = {k: stats[k].dtype for k in self.keys}
            n = sum(p.numel() for p in self.params) + len(self.keys)
            self.buf = torch.empty(n, dtype=torch.float32,
                                   device=self.params[0].device)
        parts = [p.grad.reshape(-1).to(torch.float32) for p in self.params]
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
        entries = {self._grad_name(False):
                   lambda: self.grad_segment(state, bank[0], bank[1])}
        if pool is not None:
            entries[self._grad_name(True)] = lambda: self.grad_segment(
                state, bank[0], bank[1], pool)
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
