"""Graceful degradation under queue-depth backpressure (the port's copy of
``nerf_replication_tpu/serve/policy.py``).

Serving the NerfAcc lesson in reverse: once occupancy-grid sampling makes
per-ray FLOPs cheap, the knob that matters under overload is HOW MUCH work
a request is allowed to cost, not whether it runs. Instead of letting a
backlog push requests past their deadline (timeout = 100% quality loss for
the affected user), the policy trades quality for latency in deterministic
steps, and every response records the tier it was served at so degraded
traffic is measurable, never silent.

Tier ladder (cheapest executable family in parentheses — the last two
tiers share one, so degrading never compiles anything new):

==========  =================  =============================================
tier        executable family  meaning
==========  =================  =============================================
full        full               eval-budget march, fine network, f32
bf16        bf16               full march budget, fine network, bf16
                               COMPUTE (matmul chain) with f32 compositing —
                               the mildest shed step: quality loss is a
                               rounding-level PSNR delta
proposal    proposal           learned-sampler fine pass at HALF the fine
                               budget (renderer/sampling.py) — checkpoints
                               trained with ``sampling.mode: proposal``
                               carry the proposal net, and its histogram
                               concentrates a reduced budget where the
                               density is, so this sheds compute with less
                               PSNR loss than a uniform-march cut. For
                               coarse+fine checkpoints (no proposal branch)
                               the engine serves this tier from the
                               reduced_k family — never a new executable
reduced_k   reduced_k          half the max_samples MLP budget per ray
coarse      coarse             coarse network + reduced budget
half_res    coarse             coarse, every 2nd ray rendered, output
                               nearest-neighbor expanded back
==========  =================  =============================================
"""

from __future__ import annotations

from dataclasses import dataclass

# degradation order; index 0 is the undegraded tier
TIER_NAMES: tuple[str, ...] = (
    "full", "bf16", "proposal", "reduced_k", "coarse", "half_res"
)

# tier -> (executable family, ray stride applied OUTSIDE the executable)
TIER_IMPL: dict[str, tuple[str, int]] = {
    "full": ("full", 1),
    "bf16": ("bf16", 1),
    "proposal": ("proposal", 1),
    "reduced_k": ("reduced_k", 1),
    "coarse": ("coarse", 1),
    "half_res": ("coarse", 2),
}

# the executable families the engine pre-warms per bucket; "proposal" is
# warmed only when the loaded checkpoint carries the proposal branch
# (engine._families_for_params), else its tier falls back to reduced_k
FAMILIES: tuple[str, ...] = ("full", "bf16", "proposal", "reduced_k", "coarse")


@dataclass(frozen=True)
class DegradationPolicy:
    """Deterministic queue-depth -> tier mapping.

    ``thresholds[i]`` is the queue depth (requests still waiting when a
    batch is cut) at which tier ``i+1`` activates; depths below
    ``thresholds[0]`` serve at full quality. Monotonic by construction:
    the tier index is the count of thresholds the depth has reached.
    """

    thresholds: tuple[int, ...] = (4, 8, 16, 32)

    def __post_init__(self):
        if list(self.thresholds) != sorted(self.thresholds):
            raise ValueError(
                f"shed_queue_depths must be ascending, got {self.thresholds}"
            )
        if len(self.thresholds) > len(TIER_NAMES) - 1:
            raise ValueError(
                f"at most {len(TIER_NAMES) - 1} shed thresholds (one per "
                f"degraded tier), got {len(self.thresholds)}"
            )

    @classmethod
    def from_cfg(cls, cfg) -> "DegradationPolicy":
        s = cfg.get("serve", {})
        return cls(
            thresholds=tuple(
                int(d) for d in s.get("shed_queue_depths", (4, 8, 16, 32))
            )
        )

    def tier_for(self, queue_depth: int) -> str:
        i = sum(queue_depth >= t for t in self.thresholds)
        return TIER_NAMES[min(i, len(TIER_NAMES) - 1)]
