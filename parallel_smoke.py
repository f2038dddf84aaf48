#!/usr/bin/env python3
"""Drive tpusparse_torch.parallel across the cards of one host, a rank a card.

Run from the repo root:  python3 parallel_smoke.py

It starts one process per CUDA card (at least 2); they bring up NCCL
through `parallel.initialize_distributed` from `RANK`/`WORLD_SIZE` (a
`localhost` store) and run, each check raising on failure:
  1. `sharded_spmm` and `halo_spmm` at chip_smoke.py's headline (16384^2
     with 10 % of its 128^2 blocks, B 16384 x 512 fp32 'high') over every
     rank, against the one-card `spmm_blocks` on the same card (<= 1e-5 of
     scale); the ring's bytes a rank against `halo_comm_bytes_per_dev`; the
     one-card, sharded and ring times (CUDA events, median of 10) beside
     the projection for this rank count on the card's fit;
  2. the dp×tp sparse-MLP step at ShardedMLPConfig's defaults on a
     (2, N/2) mesh (N odd: (1, N)), batch 32, 20 steps: 1 block_ell_spmm
     + 1 sddmm a rank a step, the loss dropping, the weights outside the
     mask exactly 0;
  3. the node-sharded GCN on the Cora-shaped task over every rank: the
     forward and 3 Adam steps against the one-card `GCN` on the same
     weights (rtol 1e-4, atol 5e-5), the loss dropping over 20 steps;
  4. sharded_dia_cg on laplace3d_64 at tol 1e-7 (one restart from its x),
     its float64 residual < 1e-4 and its time beside one card's;
  5. part b, `chip_smoke.run_parallel_models` over every rank: the
     Megatron BERT-base layer ('flash', batch 8, seq 512) on (1, N) and
     (2, N/2) meshes, forward and backward against the one-card layer
     (1 flash_fwd, 1 flash_dq, 1 flash_dkv a rank), the 12-layer encoder's
     forward; ring-flash and fused Ulysses attention at (2, 12, 4096, 64)
     and (1, 12, 16384, 64), causal and not, forward and backward against
     `flash_attention_diff` on one card (2e-5 of scale for o, 2e-4 for the
     grads; the ring N flash_fwd, N flash_dq and N flash_dkv a rank), the
     bytes and time of one ring hop; ring_local_attention at
     (2, 12, 4096, 64), window 128; MoE at Switch-Base-8's widths (4096
     tokens) in both forms against the reference, and the share capacity
     2.0 drops; the pipeline, a stage a rank (d 1024, batch 512, 8
     microbatches), against the sequential loop; TP int8 decode at the
     serving GPT on (1, N), batch 1 and 8, logits within 5e-3 of scale of
     one card's and the gathered int8 cache equal but at the new token
     (within 1 there): each beside its one-card time;
then, the ranks gone, `parallel.dryrun_multichip(N)` on the cards.
Rank 0 prints the card's name and power limit, each result and, last, one
JSON object {"ok": true, "world": N, "kind": ...}. Exits non-zero with no
result when fewer than two cards are present or a rank fails; stops every
process it starts.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

TOL_FP32 = dict(rtol=1e-4, atol=5e-5)
STEPS = 20
PARITY_STEPS = 3
MLP_STEP = {"block_ell_spmm": 1, "sddmm": 1}


def _say(*args) -> None:
    if int(os.environ["RANK"]) == 0:
        print(*args, flush=True)


def _launches() -> dict:
    from tpusparse_torch import kernels

    torch.cuda.synchronize()
    return {k: v for k, v in kernels.launches_by_kernel().items() if v}


def _reset() -> None:
    from tpusparse_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()


def headline(P, tt, world) -> None:
    from tpusparse_torch import ops
    from tpusparse_torch.parallel.projection import halo_comm_bytes_per_dev
    from tpusparse_torch.utils.matrices import block_sparse_csr

    a = block_sparse_csr(1, (16384, 16384), (128, 128), 0.10, device="cuda")
    b = torch.from_numpy(np.random.default_rng(7).random((16384, 512), dtype=np.float32)).cuda()
    plan = tt.build_plan(a, (128, 128))
    bv = plan.pack_values(a.data)
    want = tt.spmm_blocks(plan, bv, b)
    mesh = P.make_mesh((world,), ("model",))
    rsp, hsp = P.shard_plan_rows(a, world, (128, 128)), P.shard_plan_2d(a, world, (128, 128))
    _reset()
    got = {"sharded_spmm": P.sharded_spmm(rsp, a.data, b, mesh)}
    sent = P.count_p2p_bytes(lambda: got.update(halo_spmm=P.halo_spmm(hsp, a.data, b, mesh)))
    counts = _launches()
    if counts != {"block_ell_spmm": 1 + world}:
        raise AssertionError(f"headline: launched {counts}, expected {1 + world} block_ell_spmm")
    for label, c in got.items():
        rel = cs.over_scale(c, want)[1]
        _say(f"{label} headline over {world} cards: against one card over scale {rel:.3e} "
             f"(limit {cs.HEADLINE_TOL})")
        if not (rel <= cs.HEADLINE_TOL and bool(torch.isfinite(c).all())):
            raise AssertionError(f"{label} disagrees with one card")
    if sent != halo_comm_bytes_per_dev(hsp, 512):
        raise AssertionError(f"halo_spmm sent {sent} bytes, the model says "
                             f"{halo_comm_bytes_per_dev(hsp, 512)}")
    pair = tt.build_plan_pair(a)
    one = cs.time_ms(lambda: tt.tiled_spmm(a, b, plans=pair))
    rows = cs.time_ms(lambda: P.sharded_spmm(rsp, a.data, b, mesh))
    ring = cs.time_ms(lambda: P.halo_spmm(hsp, a.data, b, mesh))
    fit = tt.calibrate(save=False, verbose=False)
    try:
        proj = {"sharded_spmm": P.project_sharded_spmm(a, 512, (world,), (128, 128))[0],
                "halo_spmm": P.project_halo_spmm(a, 512, (world,), (128, 128))[0]}
    finally:
        ops.set_cost_constants(**ops._COST_DEFAULTS)
    _say(f"headline times (median of 10, CUDA events, rank 0): one card (tiled_spmm, plans "
         f"held) {one:.4f} ms; over {world} cards sharded_spmm {rows:.4f} ms, halo_spmm "
         f"{ring:.4f} ms (ring {sent} bytes a rank); measured efficiency one / ({world} x "
         f"sharded) {one / (world * rows):.3f}, ring {one / (world * ring):.3f}")
    for label, p in proj.items():
        _say(f"  projection of {label} at {world} ranks on this card's fit "
             f"(dense_fp32_flops {fit['dense_fp32_flops']:.3g}): total {p.t_total_s * 1e3:.4f} "
             f"ms, efficiency {p.efficiency:.3f} (the kernel alone, no pack or gather)")


def mlp(P, world) -> None:
    from tpusparse_torch.parallel.mesh import axis_size

    dp = 2 if world % 2 == 0 else 1
    mesh = P.make_mesh((dp, world // dp))
    cfg = P.ShardedMLPConfig()
    params, rsp, mask, opt = P.make_sharded_train_state(cfg, mesh,
                                                        torch.Generator().manual_seed(0))
    step = P.make_sharded_train_step(cfg, mesh, rsp)
    losses = []
    for i, (x, y) in enumerate(cs._mnist_batches()):
        _reset()
        losses.append(float(step(params, opt, mask, x.cuda(), y.cuda())))
        if _launches() != MLP_STEP:
            raise AssertionError(f"mlp step {i}: launched {_launches()}, expected {MLP_STEP}")
    if not (all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0]):
        raise AssertionError(f"mlp: loss did not drop: {losses}")
    if not bool((params["w1_blocks"].detach()[mask == 0] == 0).all()):
        raise AssertionError("mlp: a weight outside the mask moved")
    x, y = (t.cuda() for t in cs._mnist_batches()[0])
    ms = cs.time_ms(lambda: step(params, opt, mask, x, y), warmup=5, iters=50)
    _say(f"mlp on a ({dp}, {axis_size(mesh, 'model')}) mesh: {len(losses)} steps of "
         f"{json.dumps(MLP_STEP)} a rank, loss {losses[0]:.4f} -> {losses[-1]:.4f}, weights "
         f"outside the mask 0, {ms:.4f} ms a step (rank 0, median of 50)")


def gcn(P, tt, world) -> None:
    from tpusparse_torch.models import gcn as gm

    adj, (x, labels, node_mask) = cs._graph_task(cs.CORA, 30)
    a_hat = tt.normalized_adjacency(cs._on(adj, "cuda"))
    xc, lc, mc = x.cuda(), labels.cuda(), node_mask.cuda()

    def model():
        return tt.GCN(cs.CORA["features"], hidden=(64,), num_classes=cs.CORA["classes"],
                      device="cuda", generator=torch.Generator().manual_seed(31))

    sharded, one = model(), model()
    mesh = P.make_mesh((world,), ("model",))
    rsp = P.shard_plan_rows(a_hat, world)
    blocks = rsp.pack_values(a_hat.data)
    with torch.no_grad():
        out = P.make_sharded_gcn_forward(sharded, rsp, mesh)(sharded, blocks, xc)
        torch.testing.assert_close(out, one(a_hat, xc), **TOL_FP32)
    step = P.make_sharded_gcn_train_step(sharded, rsp, mesh)
    opt, one_opt = gm.make_train_state(sharded, 1e-2), gm.make_train_state(one, 1e-2)
    losses = []
    for i in range(STEPS):
        losses.append(float(step(sharded, opt, blocks, xc, lc, mc)))
        if i < PARITY_STEPS:
            want = float(gm.train_step(one, one_opt, a_hat, xc, lc, mc))
            np.testing.assert_allclose(losses[-1], want, **TOL_FP32)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"gcn: loss did not drop: {losses}")
    ms = cs.time_ms(lambda: step(sharded, opt, blocks, xc, lc, mc), warmup=3, iters=20)
    _say(f"gcn cora over {world} cards: forward and {PARITY_STEPS} Adam steps against one "
         f"card within tolerance, loss {losses[0]:.4f} -> {losses[-1]:.4f}, {ms:.4f} ms a "
         f"step (rank 0, median of 20)")


def dia_cg(P, tt, world) -> None:
    from tpusparse_torch.utils.matrices import get_matrix

    lap = get_matrix("laplace3d_64", device="cuda")
    op = tt.csr_to_dia(lap)
    rhs = torch.from_numpy(np.random.default_rng(101).random(lap.shape[0],
                                                             dtype=np.float32)).cuda()
    mesh = P.make_mesh((world,), ("model",))
    sp64, b64 = lap.to_scipy().astype(np.float64), rhs.double().cpu().numpy()
    for label, solve in (("sharded_dia_cg", lambda x0: P.sharded_dia_cg(
            op, rhs, mesh, x0=x0, tol=cs.AMG_TOL, maxiter=1000)[0]),
                         ("linalg.cg on one card", lambda x0: tt.linalg.cg(
            op, rhs, x0=x0, tol=cs.AMG_TOL, maxiter=1000)[0])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = solve(solve(None))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res = float(np.linalg.norm(sp64 @ x.double().cpu().numpy() - b64) / np.linalg.norm(b64))
        _say(f"{label} (laplace3d_64, tol {cs.AMG_TOL}, a solve and one restart): "
             f"{secs * 1e3:.1f} ms, float64 relative residual {res:.3e}")
        if not res < cs.AMG_RESID_LIMIT:
            raise AssertionError(f"{label}: residual {res}")


def rank_main(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist

    import tpusparse_torch as tt
    from tpusparse_torch import parallel as P

    P.initialize_distributed()
    try:
        if rank == 0:
            cs.phase_build()
        dist.barrier()
        _say(f"parallel_smoke: {dist.get_backend()} over {world} ranks, one a card")
        meshes = [(1, world)] + ([(2, world // 2)] if world % 2 == 0 else [])
        for name, fn, args in (("headline", headline, (P, tt, world)), ("mlp", mlp, (P, world)),
                               ("gcn", gcn, (P, tt, world)),
                               ("dia cg", dia_cg, (P, tt, world)),
                               ("parallel models", cs.run_parallel_models,
                                (P, world, meshes, (cs.PM_LONG_SHAPE,)))):
            t0 = time.perf_counter()
            fn(*args)
            _say(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("parallel_smoke: needs two or more CUDA cards", file=sys.stderr)
        return 2
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    name = torch.cuda.get_device_name(0)
    print(cs._power_line())
    with socket.socket() as s:  # a free port on this host for the store
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(rank_main, args=(world, port), nprocs=world, join=True)
    from tpusparse_torch import parallel as P

    t1 = time.perf_counter()
    P.dryrun_multichip(world)
    print(f"dryrun_multichip({world}) on the cards: every path finite, "
          f"{time.perf_counter() - t1:.1f} s")
    print(f"parallel_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(cs._power_line())  # again here: the build's output can push the first out of a tail
    print(json.dumps({"ok": True, "world": world, "kind": name}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
