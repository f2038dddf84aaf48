"""A multi-rank dry run of every sharded path on tiny shapes.

Counterpart of `__graft_entry__.dryrun_multichip`: `dryrun_multichip(n)`
starts n ranks (one process each, a `file://` store in a temporary
directory), NCCL and a card a rank for `device=None`, gloo for
`device='cpu'`, and each rank runs every path of `tpusparse_torch.parallel`
once on JAX's dry-run shapes: the dp×tp sparse-MLP step, the Megatron BERT
layer, ring-local and ring-flash attention (with its gradient), the
pipeline, the node-sharded GCN step, sharded CG, the sharded DIA matvec,
both MoE forms (the all-to-all one with its gradient), the ring-halo SpMM,
the footprint executor on each rank's row block, and the tensor-parallel
int8 decode. Each result must be finite; a rank that fails makes the call
raise.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip"]


def _finite(name: str, *tensors) -> None:
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"dry run: non-finite {name}")


def _body(n: int, dev: torch.device) -> None:
    import tpusparse_torch as tt
    from tpusparse_torch import parallel as P
    from tpusparse_torch.kernels.tiled_spmm import footprint_spmm_kernel
    from tpusparse_torch.parallel.mesh import all_gather_rows, axis_rank

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    dp = 2 if n % 2 == 0 and n > 1 else 1
    tp = n // dp
    mesh = P.make_mesh((dp, tp), ("data", "model"), device=dev)
    cfg = P.ShardedMLPConfig(in_features=64, hidden=32, num_classes=10, density=0.2,
                             blocksize=(8, 16))
    params, rsp, mask, opt = P.make_sharded_train_state(cfg, mesh, gen(0))
    step = P.make_sharded_train_step(cfg, mesh, rsp)
    rng = np.random.default_rng(0)
    x = t(rng.normal(size=(4 * dp, cfg.in_features)).astype(np.float32))
    y = t(rng.integers(0, cfg.num_classes, size=(4 * dp,)))
    _finite("sharded MLP loss", step(params, opt, mask, x, y))

    # Megatron BERT over the same mesh
    heads = tp if tp > 1 else 2
    layer = tt.BertAttentionLayer(hidden=16 * heads, num_heads=heads, intermediate=32 * heads,
                                  device=dev, generator=gen(1))
    hx = t(rng.normal(size=(2 * dp, 8, 16 * heads)).astype(np.float32))
    P.validate_tp_heads(heads, mesh)
    local, specs = P.shard_bert_params(layer, mesh)
    _finite("TP attention output", P.make_tp_forward(layer, mesh, specs)(local, hx))

    # ring-local band and ring flash, the sequence over 'model'
    w = 8
    q = t(rng.normal(size=(2, 2, w * tp * 2, 8)).astype(np.float32))
    _finite("ring attention output", P.ring_local_attention(q, q, q, w, mesh, axis="model"))
    qf = t(rng.normal(size=(1, 2, 128 * tp, 64)).astype(np.float32)).requires_grad_()
    loss = (P.ring_flash_attention(qf, qf, qf, mesh, axis="model") ** 2).sum()
    loss.backward()
    _finite("ring flash output/grads", loss.detach(), qf.grad)

    # the pipeline over a 1-D 'stage' mesh
    mesh_pp = P.make_mesh((n,), ("stage",), device=dev)
    ws = t((rng.normal(size=(n, 8, 8)) / np.sqrt(8)).astype(np.float32))
    xp = t(rng.normal(size=(8, 8)).astype(np.float32))
    yp = P.pipeline_apply(lambda wl, h: torch.tanh(tt.mm(h, wl)), ws, xp, mesh_pp,
                          axis="stage", num_microbatches=2)
    _finite("pipeline output", yp)

    # the node-sharded GCN, one step
    mesh_g = P.make_mesh((n,), ("model",), device=dev)
    n_nodes = 8 * n
    a_hat = tt.normalized_adjacency(tt.random_graph(4, n_nodes, avg_degree=4, device=dev))
    xg = t(rng.normal(size=(n_nodes, 8)).astype(np.float32))
    yg = t(rng.integers(0, 3, size=(n_nodes,)))
    gmodel = tt.GCN(8, hidden=(8,), num_classes=3, device=dev, generator=gen(3))
    rsp_g = P.shard_plan_rows(a_hat, n, (8, 8))
    gstep = P.make_sharded_gcn_train_step(gmodel, rsp_g, mesh_g)
    gopt = torch.optim.Adam(gmodel.parameters(), lr=1e-2)
    _finite("sharded GCN loss", gstep(gmodel, gopt, rsp_g.pack_values(a_hat.data), xg, yg,
                                      torch.ones((n_nodes,), device=dev)))

    # sharded CG and the sharded DIA matvec
    n_s = 16 * n
    c_s = tt.random_csr(5, (n_s, n_s), 0.08, device=dev)
    base = tt.sp_add(tt.sp_add(c_s, tt.transpose_csr(c_s)), tt.speye(n_s, device=dev), 1.0,
                     4.0 + 0.16 * n_s)
    b_s = t(rng.normal(size=(n_s,)).astype(np.float32))
    _finite("sharded CG solution",
            P.sharded_cg(base, b_s, mesh_g, blocksize=(8, 8), tol=1e-6, maxiter=200)[0])
    offs = np.array([-2, -1, 0, 1, 2], np.int64)
    dia = tt.DIA(data=t(rng.normal(size=(offs.size, n_s)).astype(np.float32)), offsets=offs,
                 shape=(n_s, n_s))
    _finite("sharded DIA matvec", P.make_sharded_dia_matvec(dia, mesh_g)(b_s))

    # both MoE forms, the experts over a 1-D 'expert' mesh
    mesh_ep = P.make_mesh((n,), ("expert",), device=dev)
    moe = P.init_moe_params(gen(2), num_experts=n, d_model=8, d_hidden=16, device=dev)
    xm = t(rng.normal(size=(16, 8)).astype(np.float32))
    _finite("MoE output", P.moe_forward(moe, xm, mesh_ep, axis="expert"))
    moe = {k: v.requires_grad_() for k, v in moe.items()}
    la = (P.moe_forward_a2a(moe, xm, mesh_ep, capacity_factor=float(n)) ** 2).sum()
    la.backward()
    _finite("MoE a2a loss/grads", la.detach(), *(v.grad for v in moe.values()))

    # the ring-halo SpMM
    n_h = 16 * n
    a_h = tt.random_csr(7, (n_h, n_h), 0.1, device=dev)
    b_h = t(rng.normal(size=(n_h, 16)).astype(np.float32))
    _finite("halo SpMM output",
            P.halo_spmm(P.shard_plan_2d(a_h, n, (8, 8)), a_h.data, b_h, mesh_g))

    # the footprint executor on each rank's row block, one pattern for all
    a_loc = tt.random_csr(9, (16, 64), 0.15, device=dev)
    fp = tt.footprint_plan(tt.build_plan(a_loc, (8, 8)), rows_per_super=2)
    vals = fp.pack_values(a_loc.data * (1.0 + 0.1 * axis_rank(mesh_g, "model")))
    bf = t(rng.normal(size=(64, 16)).astype(np.float32))
    _finite("footprint output", all_gather_rows(
        footprint_spmm_kernel(fp, vals, bf)[None], mesh_g.get_group("model")))

    # the tensor-parallel int8 decode
    tpq = 4 if n % 4 == 0 else n
    gpt = tt.GPTDecoder(num_layers=2, hidden=64, num_heads=tpq, intermediate=128,
                        vocab_size=64, max_position=16, device=dev, generator=gen(17))
    gids = t(rng.integers(0, 64, (n // tpq, 6)))
    qgm = tt.quantize_gpt(gpt)
    mesh_q = P.make_mesh((n // tpq, tpq), ("data", "model"), device=dev)
    with torch.no_grad():
        _, qcache = qgm.prefill(gids)
    qgm_s, _ = P.shard_qgpt(qgm, mesh_q)
    logits, _ = P.make_tp_decode_step(qgm_s, mesh_q)(gids[:, -1], qcache, 6)
    _finite("TP decode logits", logits)


def _rank(rank: int, n: int, store: str, device_type: str) -> None:
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method="file://" + store, rank=rank, world_size=n)
    try:
        _body(n, dev)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run every sharded path once over `n_devices` ranks (see the module
    docstring): on as many cards for `device=None` (raises when there are
    fewer), on CPU processes over gloo for `device='cpu'`."""
    import torch.multiprocessing as mp

    from tpusparse_torch.utils.config import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): {torch.cuda.device_count()} "
                           f"card(s) present")
    tmp = tempfile.mkdtemp(prefix="tpusparse_torch_dryrun_")
    try:
        mp.start_processes(_rank, args=(n_devices, os.path.join(tmp, "store"), dev.type),
                           nprocs=n_devices, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
