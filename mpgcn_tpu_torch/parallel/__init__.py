"""Data-parallel training over a torch.distributed process group
(counterpart of mpgcn_tpu/parallel/): ``initialize`` joins the group,
``make_mesh`` gives the rank's place on the ("data", "model") mesh,
``batch_shard`` its rows of a batch, ``ParallelModelTrainer`` trains on
them with one gradient all-reduce a step, and
``check_replica_consistency`` compares the ranks' replicas (it lives
beside the other fault detectors, in resilience/consistency.py, which
the base trainer imports). The model
axis (``halo.py``, branch and tensor sharding) and liveness
(``liveness.py``) are not ported yet (ROADMAP.md Queue 1, items 1(b) and
1(c))."""

from mpgcn_tpu_torch.parallel.distributed import initialize  # noqa: F401
from mpgcn_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_MODEL,
    Mesh,
    make_mesh,
)
from mpgcn_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_shard,
    replicated,
)
from mpgcn_tpu_torch.parallel.trainer import (  # noqa: F401
    ParallelModelTrainer,
)
from mpgcn_tpu_torch.resilience.consistency import (  # noqa: F401
    ReplicaDivergenceError,
    check_replica_consistency,
)
