"""Encoder dispatch (port of ``nerf_replication_tpu/models/encoding``).

Parameter-free encoders (frequency) return ``(callable, out_dim)``;
parametric encoders (the hash grids) return ``(nn.Module, out_dim)`` and the
network binds them as a submodule, so their tables train with the MLP. The
triplane and time-conditioned encoders raise, naming the port slice that
brings them.
"""

from __future__ import annotations

from .freq import FrequencyEncoder, frequency_encoder

__all__ = ["FrequencyEncoder", "frequency_encoder", "get_encoder"]

# time-conditioned family of the JAX package (reference type names)
_DYNAMIC_TYPES = (
    "cuda_hashgrid_latent", "cuda_hashgrid_4d", "cuda_hashgrid_coef",
    "cuda_motion2d", "dnerf", "cuda_dnerf_ngp_tensorf", "dnerf_ngp_tensorf",
    "dnerf_ngp_mlp", "dnerf_mlp_tensorf",
)


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
    if enc_type in ("triplane", "cuda_triplane") or enc_type in _DYNAMIC_TYPES:
        raise NotImplementedError(
            f"Encoder type {enc_type!r} is not ported to PyTorch yet; the "
            "triplane and time-conditioned encoders come with port slice 6"
        )
    raise NotImplementedError(
        f"Encoder type {enc_type!r} is not implemented (supported: "
        "frequency, hashgrid, hashgrid_packed)"
    )
