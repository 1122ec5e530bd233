"""Data, tensor and sequence parallelism on ``torch.distributed`` (port
of ``nerf_replication_tpu/parallel/``): the process group and its ``(data,
model)`` mesh, collectives, the ray bank over the data axis, the rule table
(``tree_specs``, ``tree_shard_nbytes``), the data-parallel step (captured
segments around one all-reduce), the GSPMD step (the model axis through
``parallel/tensor.py``'s seams and gathered weights) and the
sequence-parallel renderer and march.
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
    chunk_sharding,
    data_sharding,
    shard_bank,
    shard_index_pool,
    spec_for_path,
    tree_shard_nbytes,
    tree_specs,
)
from .step import (  # noqa: F401
    DPStep,
    TPStep,
    aot_register_dp_step,
    aot_register_gspmd_step,
    build_dp_step,
    build_gspmd_step,
    shard_train_state,
)
