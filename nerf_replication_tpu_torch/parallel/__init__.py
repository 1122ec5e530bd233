"""Data parallelism and sequence parallelism on ``torch.distributed`` (port
of ``nerf_replication_tpu/parallel/``): the process group and its mesh,
collectives, the ray bank over the ranks, the data-parallel train step
(captured segments around one all-reduce) and the sequence-parallel
renderer and march. Tensor parallelism (``build_gspmd_step`` and the rule
table) comes with ROADMAP item 8 part 2.
"""

from .collectives import (  # noqa: F401
    all_gather,
    axis_index,
    barrier,
    broadcast_from_chief,
    device_count,
    pmax,
    pmean,
    process_count,
    psum,
    tree_pmean,
)
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    is_chief,
    make_mesh,
    make_mesh_from_cfg,
    multihost_init,
)
from .sharding import (  # noqa: F401
    data_sharding,
    shard_bank,
    shard_index_pool,
)
from .step import (  # noqa: F401
    DPStep,
    aot_register_dp_step,
    build_dp_step,
)
