"""Training robustness (port of ``nerf_replication_tpu/resil``): the finite-
loss guard. Rollback, the SIGTERM guard and fault injection come with port
slice 10."""

from .guard import DivergenceError, check_finite

__all__ = ["DivergenceError", "check_finite"]
