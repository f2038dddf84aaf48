"""One rank of the CPU parity runs of `tpusparse_torch.parallel`.

    python tests/torch_parallel_worker.py GROUP RANK WORLD STORE OUT [INPUTS]

Each of WORLD processes runs this script with its RANK; they meet on a gloo
group at the `file://` store STORE and run GROUP's cases ('spmm' or
'train'); rank 0 writes every case's result to the `.npz` OUT. INPUTS, an
`.npz` of weights to carry (the 'train' group), is read where a case needs
it. The module imports torch, numpy, scipy and tpusparse_torch only, and
its input functions are shared with the tests, which hold the results
against the JAX package on the same inputs.
"""

from __future__ import annotations

import sys

import numpy as np
import scipy.sparse as ssp
import torch
import torch.distributed as dist

WORLD = 4
MLP = dict(in_features=64, hidden=32, num_classes=10, density=0.2, blocksize=(8, 16))
MLP_MESH = (2, 2)
PARITY_STEPS, TRAIN_STEPS, GCN_STEPS = 3, 30, 5


# -- inputs, from numpy seeds --------------------------------------------------


def rand_csr(seed, shape, density) -> ssp.csr_matrix:
    """A scipy CSR with uniform values, sorted indices."""
    a = ssp.random(*shape, density=density, random_state=seed, format="csr", dtype=np.float32)
    a.sort_indices()
    return a


def dense_b(seed, k, n) -> np.ndarray:
    return np.random.default_rng(seed).random((k, n), dtype=np.float32)


def spd_csr(seed, n=128, density=0.06) -> ssp.csr_matrix:
    """B + Bᵀ + (2·n·density + 1)·I: symmetric and diagonally dominant."""
    b = rand_csr(seed, (n, n), density)
    a = (b + b.T + (2.0 * n * density + 1.0) * ssp.eye(n, dtype=np.float32)).tocsr()
    a = a.astype(np.float32)
    a.sort_indices()
    return a


def laplace2d(n1=16) -> ssp.csr_matrix:
    t = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n1, n1), format="csr")
    eye = ssp.eye(n1, format="csr")
    a = (ssp.kron(eye, t) + ssp.kron(t, eye) + 0.1 * ssp.eye(n1 * n1)).tocsr()
    a = a.astype(np.float32)
    a.sort_indices()
    return a


def tridiag250() -> ssp.csr_matrix:
    """250 rows, which do not divide over 4 ranks: a zero-padded tail."""
    a = ssp.diags([np.ones(249), 3 * np.ones(250), np.ones(249)], [-1, 0, 1]).tocsr()
    a = a.astype(np.float32)
    a.sort_indices()
    return a


def wide250() -> ssp.csr_matrix:
    """A band of 70 sub-diagonals: more than the 63 rows a rank holds."""
    a = ssp.diags([np.ones(250 - 70), np.ones(250)], [-70, 0]).tocsr().astype(np.float32)
    a.sort_indices()
    return a


def ring_order_case():
    """A (32, 32) A and B whose ring sum shows its order: with blocks of 8
    and 4 ranks, row r of chunk i adds B's rows r % 8 of the four column
    strips, whose values are 2^24, 1, -2^24 and 1 by strip. Each product is
    exact; fp32 sums in JAX's order (strip i, i + 1, ...) give 1, 2, 2 and 0
    by chunk, another order gives other values."""
    rows = np.repeat(np.arange(32), 4)
    cols = (np.tile(np.arange(4), 32) * 8 + rows % 8)
    a = ssp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(32, 32))
    a.sort_indices()
    strip = np.array([2.0 ** 24, 1.0, -(2.0 ** 24), 1.0], np.float32)
    b = np.repeat(strip, 8)[:, None] * np.ones((1, 3), np.float32)
    return a, b


def matvec_inputs():
    """The SPD operator of the matvec and its (128,) and (128, 3) vectors."""
    rng = np.random.default_rng(0)
    return (spd_csr(0), rng.normal(size=(128,)).astype(np.float32),
            rng.normal(size=(128, 3)).astype(np.float32))


def cg_inputs():
    return spd_csr(1), np.random.default_rng(1).normal(size=(128,)).astype(np.float32)


def dia_inputs():
    """laplace2d's (256,) and (256, 3) vectors and CG right-hand side, and a
    (250,) vector for the tail case."""
    rng = np.random.default_rng(0)
    return tuple(rng.normal(size=s).astype(np.float32) for s in ((256,), (256, 3), (256,), (250,)))


def mnist_like(seed, steps, batch=16):
    """JAX's test task: ten prototypes in 64 dimensions plus noise."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, 64)).astype(np.float32)
    out = []
    for _ in range(steps):
        y = rng.integers(0, 10, size=(batch,))
        x = protos[y] + 0.3 * rng.normal(size=(batch, 64)).astype(np.float32)
        out.append((x.astype(np.float32), y.astype(np.int64)))
    return out


def gcn_inputs():
    """(Â pattern source, x) of the sharded GCN forward: JAX's test graph."""
    import tpusparse_torch as tt

    adj = tt.random_graph(7, 64, avg_degree=6, device="cpu")
    x = np.random.default_rng(8).random((64, 12), dtype=np.float32)
    return adj, x


def gcn_train_inputs():
    import tpusparse_torch as tt

    a, labels = tt.two_cluster_graph(1, nodes_per_cluster=32, device="cpu")
    n = a.shape[0]
    return a, np.eye(n, 8, dtype=np.float32), labels.astype(np.int64), np.ones(n, np.float32)


# -- the cases -------------------------------------------------------------------


def _csr(sp):
    import tpusparse_torch as tt

    return tt.CSR.from_scipy(sp, device="cpu")


def _dia(sp):
    import tpusparse_torch as tt

    return tt.csr_to_dia(_csr(sp))


def run_spmm(out: dict) -> None:
    from tpusparse_torch import parallel as P

    mesh = P.make_mesh((1, WORLD), device="cpu")
    for shape in ((128, 96), (200, 130)):
        a = _csr(rand_csr(0, shape, 0.08))
        b = torch.from_numpy(dense_b(1, shape[1], 24))
        rsp = P.shard_plan_rows(a, WORLD, (8, 16))
        out[f"sharded_{shape}"] = P.sharded_spmm(rsp, a.data, b, mesh)
        out[f"sharded_{shape}_bytes"] = P.count_p2p_bytes(P.sharded_spmm, rsp, a.data, b, mesh)
    for shape in ((128, 128), (160, 250)):
        a = _csr(rand_csr(2, shape, 0.06))
        b = torch.from_numpy(dense_b(3, shape[1], 16))
        out[f"halo_{shape}"] = P.halo_spmm(P.shard_plan_2d(a, WORLD, (8, 16)), a.data, b, mesh)
    a = _csr(rand_csr(3, (256, 256), 0.06))
    hsp = P.shard_plan_2d(a, WORLD, (8, 16))
    out["halo_bytes"] = P.count_p2p_bytes(P.halo_spmm, hsp, a.data, torch.zeros((256, 24)), mesh)
    sp, b = ring_order_case()
    a = _csr(sp)
    out["ring_order"] = P.halo_spmm(P.shard_plan_2d(a, WORLD, (8, 8)), a.data,
                                    torch.from_numpy(b), mesh)
    mesh22 = P.make_mesh((2, 2), device="cpu")
    a = _csr(rand_csr(4, (64, 64), 0.1))
    b = torch.from_numpy(dense_b(5, 64, 8))
    out["halo_2d_mesh"] = P.halo_spmm(P.shard_plan_2d(a, 2, (8, 8)), a.data, b, mesh22,
                                      axis="model")

    mesh1d = P.make_mesh((WORLD,), ("model",), device="cpu")
    sp, v, vk = matvec_inputs()
    a = _csr(sp)
    mv = P.make_sharded_matvec(P.shard_plan_rows(a, WORLD, (8, 8)), a.data, mesh1d)
    out["matvec_1d"], out["matvec_2d"] = mv(torch.from_numpy(v)), mv(torch.from_numpy(vk))
    sp, b = cg_inputs()
    out["cg"] = P.sharded_cg(_csr(sp), torch.from_numpy(b), mesh1d, blocksize=(8, 8), tol=1e-8,
                             maxiter=300)[0]
    lam, v = P.sharded_power_iteration(_csr(spd_csr(3)), mesh1d, blocksize=(8, 8), iters=150)
    out["power_lam"], out["power_v"] = lam, v

    v, vk, b, v2 = (torch.from_numpy(t) for t in dia_inputs())
    mv = P.make_sharded_dia_matvec(_dia(laplace2d()), mesh1d)
    out["dia_1d"], out["dia_2d"] = mv(v), mv(vk)
    out["dia_cg"] = P.sharded_dia_cg(_dia(laplace2d()), b, mesh1d, tol=1e-7, maxiter=500)[0]
    out["dia_tail"] = P.make_sharded_dia_matvec(_dia(tridiag250()), mesh1d)(v2)
    try:
        P.make_sharded_dia_matvec(_dia(wide250()), mesh1d)
        out["dia_wide_error"] = np.array("")
    except ValueError as e:
        out["dia_wide_error"] = np.array(str(e))


def _over_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """The model ranks' shards of `t`, stacked: JAX's global blocks."""
    from tpusparse_torch.parallel.mesh import all_gather_rows

    return all_gather_rows(t.detach()[None], mesh.get_group("model"))


def run_train(out: dict, inputs: dict) -> None:
    import tpusparse_torch as tt
    from tpusparse_torch import parallel as P
    from tpusparse_torch.convert import load_flax_params, load_sharded_train_state
    from tpusparse_torch.parallel.mesh import axis_rank, axis_size
    from tpusparse_torch.parallel.train import sharded_plan

    cfg = P.ShardedMLPConfig(**MLP)
    mesh = P.make_mesh(MLP_MESH, device="cpu")
    rsp = sharded_plan(cfg, axis_size(mesh, "model"))
    state = {k[len("mlp_"):]: inputs[k] for k in inputs if k.startswith("mlp_")}
    params, mask, opt = load_sharded_train_state(
        cfg, {k: state[k] for k in ("w1_blocks", "b1", "w2", "b2")}, state["mask"],
        {k: state["trace_" + k] for k in ("w1_blocks", "b1", "w2", "b2")},
        model_rank=axis_rank(mesh, "model"), device="cpu")
    step = P.make_sharded_train_step(cfg, mesh, rsp)
    batches = mnist_like(0, TRAIN_STEPS)
    losses = []
    for i, (x, y) in enumerate(batches):
        losses.append(float(step(params, opt, mask, torch.from_numpy(x), torch.from_numpy(y))))
        if i + 1 == PARITY_STEPS:
            out["mlp_w1_after"] = _over_model(params["w1_blocks"], mesh)
            for k in ("b1", "w2", "b2"):
                out[f"mlp_{k}_after"] = params[k].detach().clone()
    out["mlp_losses"] = np.array(losses)
    out["mlp_w1_final"] = _over_model(params["w1_blocks"], mesh)
    out["mlp_mask"] = _over_model(mask, mesh)

    model_mesh = P.make_mesh((WORLD,), ("model",), device="cpu")
    adj, x = gcn_inputs()
    a_hat = tt.normalized_adjacency(adj)
    model = tt.GCN(12, hidden=(16,), num_classes=4, device="cpu")
    load_flax_params(model, {"params": _tree(inputs, "gcn_")})
    rsp = P.shard_plan_rows(a_hat, WORLD, (8, 8))
    fwd = P.make_sharded_gcn_forward(model, rsp, model_mesh)
    out["gcn_forward"] = fwd(model, rsp.pack_values(a_hat.data), torch.from_numpy(x)).detach()

    a, x, labels, node_mask = gcn_train_inputs()
    a_hat = tt.normalized_adjacency(a)
    model = tt.GCN(8, hidden=(8,), num_classes=2, device="cpu")
    load_flax_params(model, {"params": _tree(inputs, "gcntrain_")})
    rsp = P.shard_plan_rows(a_hat, WORLD, (8, 8))
    step = P.make_sharded_gcn_train_step(model, rsp, model_mesh)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    blocks = rsp.pack_values(a_hat.data)
    out["gcn_losses"] = np.array([
        float(step(model, opt, blocks, torch.from_numpy(x), torch.from_numpy(labels),
                   torch.from_numpy(node_mask))) for _ in range(GCN_STEPS)])


def flat_tree(tree, prefix="") -> dict:
    """A nested dict of arrays as one flat dict, keys joined by '/'."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _tree(flat: dict, prefix: str) -> dict:
    """The nested tree of `flat`'s keys under `prefix` (flat_tree's inverse)."""
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def launch(group: str, tmp, inputs: dict | None = None, timeout: float = 240.0) -> dict:
    """Run GROUP on WORLD ranks, each a process of this script, and return
    rank 0's results. Raises with the ranks' output if one fails."""
    import os
    import subprocess
    from pathlib import Path

    tmp = Path(tmp)
    args = [str(WORLD), str(tmp / "store"), str(tmp / "out.npz")]
    if inputs is not None:
        np.savez(tmp / "inputs.npz", **inputs)
        args.append(str(tmp / "inputs.npz"))
    root = str(Path(__file__).resolve().parent.parent)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])}
    procs = []
    for rank in range(WORLD):
        procs.append(subprocess.Popen([sys.executable, __file__, group, str(rank), *args],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(
            f"rank {r} (rc {p.returncode}):\n{log[-3000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return dict(np.load(tmp / "out.npz"))


def main(argv) -> int:
    group, rank, world, store, out_path = argv[:5]
    inputs = dict(np.load(argv[5])) if len(argv) > 5 else {}
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=int(rank),
                            world_size=int(world))
    try:
        out: dict = {}
        if group == "spmm":
            run_spmm(out)
        else:
            run_train(out, inputs)
        if int(rank) == 0:
            np.savez(out_path, **{k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                                  for k, v in out.items()})
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
