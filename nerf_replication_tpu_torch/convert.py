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
transpose, to ``xyz_encoder.embeddings``.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) → port state dict (float32)."""
    inner = tree["params"] if set(tree.keys()) == {"params"} else tree
    state: dict[str, torch.Tensor] = {}
    for branch, layers in inner.items():
        if "embeddings" in layers:  # an encoder table: no transpose
            state[f"{branch}.embeddings"] = torch.from_numpy(
                np.asarray(layers["embeddings"], np.float32).copy())
            continue
        for name, leaf in layers.items():
            kernel = np.asarray(leaf["kernel"], np.float32)
            bias = np.asarray(leaf["bias"], np.float32)
            state[f"{branch}.{name}.weight"] = torch.from_numpy(
                kernel.T.copy()
            )
            state[f"{branch}.{name}.bias"] = torch.from_numpy(bias.copy())
    return state


def load_jax_params(network: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy a JAX parameter tree into ``network`` in place (strict)."""
    network.load_state_dict(params_from_jax(tree), strict=True)
    return network
