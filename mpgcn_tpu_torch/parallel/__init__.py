"""Data- and model-parallel training over a torch.distributed process
group (counterpart of mpgcn_tpu/parallel/): ``initialize`` joins the
group, ``make_mesh`` gives the rank's place on the (dp, mp) ("data",
"model") mesh and its subgroups, ``batch_shard`` its rows of a batch and
``node_shard`` its block of origin nodes, ``gather_origins`` the model
axis's differentiable all-gather, ``ParallelModelTrainer`` trains on the
shard with one gradient all-reduce a step, ``check_replica_consistency``
compares the ranks' replicas (it lives beside the other fault detectors,
in resilience/consistency.py, which the base trainer imports), and
``halo.py`` is the node-sharded sparse SpMM (``build_halo_plan``,
``halo_spmm``). Branch sharding, ``-bexec stacked`` and the fleet's mesh
rungs (ROADMAP.md Queue 1, item 1(b), part two) and liveness
(``liveness.py``, item 1(c)) are not ported yet."""

from mpgcn_tpu_torch.node_shard import (  # noqa: F401
    NodeShard,
    gather_origins,
)
from mpgcn_tpu_torch.parallel.distributed import initialize  # noqa: F401
from mpgcn_tpu_torch.parallel.halo import (  # noqa: F401
    HaloPlan,
    build_halo_plan,
    halo_spmm,
)
from mpgcn_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_MODEL,
    Mesh,
    make_mesh,
)
from mpgcn_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_shard,
    node_shard,
    replicated,
    shard_nodes,
)
from mpgcn_tpu_torch.parallel.trainer import (  # noqa: F401
    ParallelModelTrainer,
)
from mpgcn_tpu_torch.resilience.consistency import (  # noqa: F401
    ReplicaDivergenceError,
    check_replica_consistency,
)
