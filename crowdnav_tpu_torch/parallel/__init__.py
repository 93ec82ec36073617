"""Runtime: batched actor-learner loops, the rank mesh, sharded training
over torch.distributed."""

from crowdnav_tpu_torch.parallel.runtime import (  # noqa: F401
    Trainer,
    TrainerConfig,
    TrainerState,
)
from crowdnav_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    ShardedTrainer,
)
from crowdnav_tpu_torch.parallel.distributed import (  # noqa: F401
    init_multihost,
    distribute,
    process_summary,
)
