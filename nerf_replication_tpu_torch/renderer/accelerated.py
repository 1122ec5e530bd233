"""March options (port of ``MarchOptions`` in
``nerf_replication_tpu/renderer/accelerated.py``).

The staged accelerated march itself is not ported: serving in the port runs
the fused march (``ops/fused_march.py``), and the staged routes come with a
later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MarchOptions:
    """Accelerated-march configuration (same fields and defaults as the JAX
    package; ``fused_block`` is read for the compositing tile size only —
    the CUDA kernels choose their own rays per block)."""

    step_size: float = 0.005
    transmittance_threshold: float = 1e-4
    max_samples: int = 192
    white_bkgd: bool = True
    chunk_size: int = 4096
    clip_bbox: bool = False
    coarse_block: int = 0
    coarse_cap: int = 0
    march_fused: str = "off"
    fused_block: int = 256

    @classmethod
    def from_cfg(cls, cfg) -> "MarchOptions":
        ta = cfg.task_arg
        raw_fused = ta.get("march_fused", False)
        if isinstance(raw_fused, str):
            if raw_fused not in ("off", "gather", "full"):
                raise ValueError(
                    "task_arg.march_fused must be one of off/gather/full "
                    f"(or a bool; true = gather), got {raw_fused!r}"
                )
            fused = raw_fused
        else:
            fused = "gather" if raw_fused else "off"
        return cls(
            step_size=float(ta.get("render_step_size", 0.005)),
            transmittance_threshold=float(
                ta.get("transmittance_threshold", 1e-4)
            ),
            max_samples=int(ta.get("max_march_samples", 192)),
            white_bkgd=bool(ta.get("white_bkgd", True)),
            chunk_size=int(ta.get("march_chunk_size", 4096)),
            clip_bbox=bool(ta.get("march_clip_bbox", False)),
            coarse_block=int(ta.get("march_coarse_block", 0)),
            coarse_cap=int(ta.get("march_coarse_cap", 0)),
            march_fused=fused,
            fused_block=int(ta.get("march_fused_block", 256)),
        )

    @classmethod
    def eval_from_cfg(cls, cfg) -> "MarchOptions":
        """Eval/serve march options: ``task_arg.eval_render_step_size`` and
        ``task_arg.eval_max_march_samples`` override the shared keys."""
        base = cls.from_cfg(cfg)
        ta = cfg.task_arg
        return replace(
            base,
            step_size=float(ta.get("eval_render_step_size", base.step_size)),
            max_samples=int(
                ta.get("eval_max_march_samples", base.max_samples)
            ),
        )
