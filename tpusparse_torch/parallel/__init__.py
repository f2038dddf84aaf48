"""Multi-rank SpMM, solvers and training on `torch.distributed`.

Counterpart of `tpusparse/parallel/` part a: the mesh (`make_mesh`,
`initialize_distributed`), the row-partitioned and ring-halo SpMM, the
sharded Krylov and DIA solvers, the dp×tp sparse-MLP step, the node-sharded
GCN and the scaling projection. Collectives run on NCCL for the card and
on gloo for `device='cpu'`; each rank runs its own shard, and where JAX
returns a global array every rank gets the global tensor. The bytes a rank
sends point to point are counted (`p2p_bytes`, `count_p2p_bytes`, the
counterpart of JAX's `count_ppermute_bytes`).

Part b, on the same meshes and on the differentiable collectives of
`mesh` (the all-to-all, the ring permute, Megatron's sum): Megatron tensor
parallelism of the BERT layer and encoder (`bert`), ring-local, Ulysses and
ring-flash attention over a sequence axis (`attention`), the GPipe pipeline
(`pipeline`), expert-parallel MoE in its replicated and all-to-all forms
(`moe`), tensor-parallel int8 GPT decode (`serving`) and a multi-rank dry run
of every path (`dryrun_multichip`). Their gradients are the global loss's on
every rank.
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
from tpusparse_torch.parallel.bert import (
    bert_param_specs,
    make_tp_forward,
    shard_bert_params,
    validate_tp_heads,
)
from tpusparse_torch.parallel.attention import (
    ring_flash_attention,
    ring_local_attention,
    ulysses_attention,
)
from tpusparse_torch.parallel.pipeline import pipeline_apply
from tpusparse_torch.parallel.moe import (
    init_moe_params,
    load_balance_loss,
    moe_forward,
    moe_forward_a2a,
    moe_forward_reference,
)
from tpusparse_torch.parallel.serving import make_tp_decode_step, qgpt_param_specs, shard_qgpt
from tpusparse_torch.parallel.dryrun import dryrun_multichip

# JAX's `__all__`, in its order; the point-to-point byte count stands where
# `count_ppermute_bytes` stood, with its counter; then the dry run
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
    "bert_param_specs",
    "shard_bert_params",
    "make_tp_forward",
    "validate_tp_heads",
    "ring_flash_attention",
    "ring_local_attention",
    "ulysses_attention",
    "pipeline_apply",
    "init_moe_params",
    "moe_forward",
    "moe_forward_a2a",
    "moe_forward_reference",
    "load_balance_loss",
    "make_sharded_gcn_forward",
    "make_sharded_gcn_train_step",
    "make_sharded_matvec",
    "sharded_cg",
    "sharded_power_iteration",
    "make_sharded_dia_matvec",
    "sharded_dia_cg",
    "qgpt_param_specs",
    "shard_qgpt",
    "make_tp_decode_step",
    "dryrun_multichip",
]
