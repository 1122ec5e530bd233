"""Encoder dispatch (port of ``nerf_replication_tpu/models/encoding``).

Parameter-free encoders (frequency) return ``(callable, out_dim)``;
parametric encoders (the hash grids, the tri-plane and the time-conditioned
family of ``dynamic.py``) return ``(nn.Module, out_dim)`` and the network
binds them as a submodule, so their tables train with the MLP.
"""

from __future__ import annotations

from .freq import FrequencyEncoder, frequency_encoder

__all__ = ["FrequencyEncoder", "frequency_encoder", "get_encoder"]

# time-conditioned family: the reference's type names → dynamic.py classes
_DYNAMIC_TYPES = {
    "cuda_hashgrid_latent": "HashLatentEncoder",
    "cuda_hashgrid_4d": "HashEncoder4d",
    "cuda_hashgrid_coef": "HashCoefEncoder",
    "cuda_motion2d": "Motion2dEncoder",
    "dnerf": "DNeRFEncoder",
    "cuda_dnerf_ngp_tensorf": "DNeRFNGPEncoder",
    "dnerf_ngp_tensorf": "DNeRFNGPEncoder",
    "dnerf_ngp_mlp": "DNeRFEncoder",
    "dnerf_mlp_tensorf": "DNeRFNGPEncoder",
}

# input_dim is not forwarded: each dynamic class owns its hash input rank
_HASH_KEYS = (
    "num_levels", "level_dim", "per_level_scale",
    "base_resolution", "log2_hashmap_size", "desired_resolution",
)

# the dynamic encoders normalize with explicit world bounds
_DEFAULT_BBOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))


def get_encoder(enc_cfg, precision=None):
    """``(encoder, out_dim)`` for a config node with ``type``/``input_dim``.
    ``precision`` (cfg.precision) is handed to the packed hash grid, which
    accepts it as the JAX one does."""
    enc_type = enc_cfg.type
    if enc_type == "frequency":
        return frequency_encoder(
            input_dim=int(enc_cfg.input_dim),
            n_freqs=int(enc_cfg.freq),
            include_input=True,
            log_sampling=True,
        )
    if enc_type in ("hashgrid", "cuda_hashgrid", "grid_hash"):
        from .hashgrid import HashGridEncoder

        module = HashGridEncoder.from_cfg(enc_cfg)
        return module, module.out_dim
    if enc_type == "hashgrid_packed":
        from .packed_hash import PackedHashGridEncoder

        module = PackedHashGridEncoder.from_cfg(enc_cfg, precision)
        return module, module.out_dim
    if enc_type in ("triplane", "cuda_triplane"):
        from .triplane import TriPlaneEncoder

        module = TriPlaneEncoder.from_cfg(enc_cfg)
        return module, module.out_dim
    if enc_type in _DYNAMIC_TYPES:
        module = _make_dynamic(enc_type, enc_cfg)
        return module, module.out_dim
    raise NotImplementedError(
        f"Encoder type {enc_type!r} is not implemented (supported: "
        "frequency, hashgrid, hashgrid_packed, triplane + dynamic family "
        f"{sorted(_DYNAMIC_TYPES)})"
    )


def _make_dynamic(enc_type, enc_cfg):
    from . import dynamic

    cls = getattr(dynamic, _DYNAMIC_TYPES[enc_type])
    bbox = enc_cfg.get("bbox", None)
    return cls(
        num_frames=int(enc_cfg.get("num_frames", 1)),
        bbox=tuple(map(tuple, bbox)) if bbox is not None else _DEFAULT_BBOX,
        hash_kwargs={k: enc_cfg[k] for k in _HASH_KEYS if k in enc_cfg},
    )
