"""img_fit loss module (port of
``nerf_replication_tpu/train/loss_img_fit.py``): MSE of the network's rgb at
the batch's uv (the ``rays`` slot) against its ``rgbs``, with a PSNR stat.
Callable as ``(batch, gen, train) -> (output, loss, stats)``, as the NeRF
loss is.

:class:`ImgFitRenderer` renders a whole image in ``chunk_size``-pixel chunks
(the last zero-padded, as JAX's ``lax.map`` over padded chunks), with the
renderer surface the trainer's validation uses; under ``compile.aot`` the
chunked apply of the test image is captured as a CUDA graph under JAX's
entry name ``img_fit_apply_{n_chunks}x{chunk}``.
"""

from __future__ import annotations

import torch

from ..renderer.volume import chunk_layout, replay_padded
from .loss import mse, mse_to_psnr


class ImgFitRenderer:
    def __init__(self, cfg, network):
        self.network = network
        self.chunk_size = int(cfg.task_arg.get("chunk_size", 16384))
        self._fns: dict = {}  # (n_chunks, chunk) -> captured apply
        self._aot_names: dict = {}

    def _apply(self, uv: torch.Tensor, chunk: int) -> dict:
        """The padded image's uv ``[n_chunks·chunk, 2]``, chunk by chunk,
        without autograd."""
        with torch.no_grad():
            rgb = torch.cat([self.network(uv[i:i + chunk])
                             for i in range(0, uv.shape[0], chunk)], 0)
        return {"rgb": rgb, "rgb_map_f": rgb}

    def render_chunked(self, batch: dict) -> dict:
        uv = batch["rays"]
        n = uv.shape[0]
        chunk, n_chunks = chunk_layout(n, self.chunk_size)
        fn = self._fns.get((n_chunks, chunk))
        if fn is not None:
            return replay_padded(fn, uv, n_chunks * chunk)
        pad = n_chunks * chunk - n
        if pad:
            uv = torch.cat([uv, uv.new_zeros((pad, uv.shape[-1]))], 0)
        return {k: v[:n] for k, v in self._apply(uv, chunk).items()}

    def aot_register_eval(self, registry, n_rays: int, near=0.0, far=1.0,
                          width: int = 2) -> list[str]:
        """Register the chunked apply of ``n_rays``-pixel images (JAX
        ``ImgFitRenderer.aot_register``); :meth:`aot_install` after
        ``registry.compile_all()``."""
        chunk, n_chunks = chunk_layout(int(n_rays), self.chunk_size)
        name = f"img_fit_apply_{n_chunks}x{chunk}"
        dev = next(self.network.parameters()).device
        uv = torch.zeros((n_chunks * chunk, width), dtype=torch.float32,
                         device=dev)
        registry.register(name, lambda u: self._apply(u, chunk), (uv,))
        self._aot_names[name] = (n_chunks, chunk)
        return [name]

    def aot_install(self, registry) -> int:
        installed = 0
        for name, key in self._aot_names.items():
            fn = registry.take(name)
            if fn is not None:
                self._fns[key] = fn
                installed += 1
        return installed


class ImgFitLoss:
    # bound-free task: near/far are unused dummies (the trainer's contract)
    ray_bounds = (0.0, 1.0)

    def __init__(self, cfg, network):
        self.network = network
        self.renderer = ImgFitRenderer(cfg, network)

    def __call__(self, batch, gen=None, train: bool = True):
        uv = batch.get("uv", batch.get("rays"))
        target = batch.get("rgb", batch.get("rgbs"))
        rgb = self.network(uv)
        loss = mse(rgb, target)
        stats = {"loss": loss, "psnr": mse_to_psnr(loss)}
        return {"rgb": rgb}, loss, stats


def make_loss(cfg, network) -> ImgFitLoss:
    return ImgFitLoss(cfg, network)


NetworkWrapper = ImgFitLoss
