"""Device meshes, parameter sharding, the pipeline and the mesh's
collectives (counterpart of orbit2_tpu/parallel/)."""

from orbit2_tpu_torch.parallel.mesh import (
    AXES,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_REPLICA,
    AXIS_SEQ,
    AXIS_STAGE,
    AXIS_TENSOR,
    BATCH_AXES,
    data_group,
    data_rank,
    data_size,
    in_mesh,
    init_distributed,
    make_mesh,
    mesh_from_config,
    rank_grid,
    seq_split,
    stage_split,
    world_size,
)
from orbit2_tpu_torch.parallel.sharding import (
    full_state_dict,
    full_tensor,
    load_full_state_dict,
    shard_like,
    shard_model,
    spec_for,
)
