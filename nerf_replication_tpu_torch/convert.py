"""Weights carried across from the JAX package.

A JAX checkpoint's parameter tree, as numpy arrays::

    {"params": {"coarse"|"fine": {"pts_linear_i" | "alpha_linear" |
        "feature_linear" | "views_linear_0" | "rgb_linear":
            {"kernel": [in, out], "bias": [out]}}}}

maps onto the port's ``Network`` state dict: kernels are transposed to the
``nn.Linear`` layout ``[out, in]``; a SplitDense kernel stays one matrix whose
input columns split at ``c1`` exactly where the Flax module splits its rows.
A parametric encoder's table, ``{"xyz_encoder": {"embeddings": [T, C]}}`` (or
the cell-packed ``[buckets, 2^D·C]``), is carried as it is, without a
transpose, to ``xyz_encoder.embeddings``. Nested encoder trees map the same
way, one dotted level per subtree: ``xyz_encoder/hash/embeddings``,
``latent_t``, ``basis_i``, ``coefs``, ``plane_xy|yz|xz`` (``plane_01`` /
``plane_12`` / ``plane_02``), ``feat`` as they are; the Dense layers
``coef_hidden``, ``coef_out``, ``warp/linear_i``, ``warp/delta``,
``mlp_i``, ``mlp_out`` and the img_fit network's ``backbone_i`` / ``rgb``
transposed.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) → port state dict (float32).

    Nested subtrees become dotted names. A Dense leaf pair ``{kernel,
    bias}`` becomes ``weight`` (transposed) and ``bias``; any other leaf (a
    hash table's ``embeddings``, ``latent_t``, ``feat``) is carried as it
    is."""
    inner = tree["params"] if set(tree.keys()) == {"params"} else tree
    state: dict[str, torch.Tensor] = {}

    def leaf(x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, np.float32).copy())

    def walk(prefix: str, node: dict) -> None:
        if set(node.keys()) == {"kernel", "bias"}:
            state[prefix + "weight"] = leaf(np.asarray(node["kernel"]).T)
            state[prefix + "bias"] = leaf(node["bias"])
            return
        for name, child in node.items():
            if isinstance(child, dict):
                walk(f"{prefix}{name}.", child)
            else:
                state[prefix + name] = leaf(child)

    walk("", inner)
    return state


def jax_path(name: str) -> str:
    """The JAX parameter path of a port state-dict key: the inverse of
    :func:`params_from_jax`'s names (``coarse.pts_linear_3.weight`` ->
    ``coarse/pts_linear_3/kernel``)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def transposed(name: str) -> bool:
    """Whether the port tensor ``name`` is a JAX leaf transposed (a Dense
    kernel ``[in, out]`` carried as ``weight [out, in]``)."""
    return name.endswith(".weight") or name == "weight"


def load_jax_params(network: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy a JAX parameter tree into ``network`` in place (strict)."""
    network.load_state_dict(params_from_jax(tree), strict=True)
    return network
