from dmvsnet_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_SPATIAL,
    AXIS_VIEW,
    Mesh,
    make_mesh,
    replicate_tree,
    shard_batch,
)
from dmvsnet_tpu_torch.parallel.multihost import init_multihost  # noqa: F401
