"""Encoder dispatch (port of ``nerf_replication_tpu/models/encoding``).

Only the parameter-free frequency encoder is ported so far; the other types
(hash grids, triplanes, the time-conditioned family) raise, naming the port
slice that brings them.
"""

from __future__ import annotations

from .freq import FrequencyEncoder, frequency_encoder

__all__ = ["FrequencyEncoder", "frequency_encoder", "get_encoder"]


def get_encoder(enc_cfg, precision=None):
    """``(encoder, out_dim)`` for a config node with ``type``/``input_dim``."""
    enc_type = enc_cfg.type
    if enc_type == "frequency":
        return frequency_encoder(
            input_dim=int(enc_cfg.input_dim),
            n_freqs=int(enc_cfg.freq),
            include_input=True,
            log_sampling=True,
        )
    raise NotImplementedError(
        f"Encoder type {enc_type!r} is not ported to PyTorch yet (frequency "
        "only); hash-grid encoders come with the hash/NGP slice (kernel K6)"
    )
