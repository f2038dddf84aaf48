"""Multi-rank SpMM, solvers and training on `torch.distributed`.

Counterpart of `tpusparse/parallel/` part a: the mesh (`make_mesh`,
`initialize_distributed`), the row-partitioned and ring-halo SpMM, the
sharded Krylov and DIA solvers, the dp×tp sparse-MLP step, the node-sharded
GCN and the scaling projection. Collectives run on NCCL for the card and
on gloo for `device='cpu'`; each rank runs its own shard, and where JAX
returns a global array every rank gets the global tensor. The bytes a rank
sends point to point are counted (`p2p_bytes`, `count_p2p_bytes`, the
counterpart of JAX's `count_ppermute_bytes`). Megatron BERT, ring and
Ulysses attention, the pipeline, MoE and TP serving are not ported yet.
"""

from tpusparse_torch.parallel.mesh import initialize_distributed, make_mesh
from tpusparse_torch.parallel.spmm import (
    HaloShardedPlan,
    RowShardedPlan,
    count_p2p_bytes,
    halo_spmm,
    p2p_bytes,
    shard_plan_2d,
    shard_plan_rows,
    sharded_spmm,
)
from tpusparse_torch.parallel.train import (
    ShardedMLPConfig,
    make_sharded_train_state,
    make_sharded_train_step,
)
from tpusparse_torch.parallel.projection import (
    ScalingProjection,
    project_halo_spmm,
    project_sharded_spmm,
    projection_table,
)
from tpusparse_torch.parallel.gcn import make_sharded_gcn_forward, make_sharded_gcn_train_step
from tpusparse_torch.parallel.linalg import (
    make_sharded_matvec,
    sharded_cg,
    sharded_power_iteration,
)
from tpusparse_torch.parallel.dia import make_sharded_dia_matvec, sharded_dia_cg

# JAX's `__all__` of part a, in its order; the point-to-point byte count
# stands where `count_ppermute_bytes` stood, with its counter
__all__ = [
    "make_mesh",
    "initialize_distributed",
    "RowShardedPlan",
    "shard_plan_rows",
    "sharded_spmm",
    "HaloShardedPlan",
    "shard_plan_2d",
    "halo_spmm",
    "make_sharded_train_state",
    "make_sharded_train_step",
    "ScalingProjection",
    "project_sharded_spmm",
    "project_halo_spmm",
    "projection_table",
    "count_p2p_bytes",
    "p2p_bytes",
    "make_sharded_gcn_forward",
    "make_sharded_gcn_train_step",
    "make_sharded_matvec",
    "sharded_cg",
    "sharded_power_iteration",
    "make_sharded_dia_matvec",
    "sharded_dia_cg",
]
