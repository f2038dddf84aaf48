"""Beyond the reference (single-GPU only, SURVEY.md §2.5): sharding the
sparse operator over ranks with `torch.distributed`.

Each rank is a process that runs its own shard; the collectives run on
NCCL between cards, one rank a card, or on gloo between CPU processes with
`device='cpu'`. The same code runs at any world size that divides the 256
rows into whole (8, 8) blocks a rank (1, 2, 4, 8, ...).

    python examples_torch/06_distributed.py     # on every card present
    main(device='cpu', world_size=4)             # four gloo ranks on the CPU
"""

import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import scipy.sparse as ssp
import torch
import torch.distributed as dist

import tpusparse_torch as tt
from _common import host, launches_since
from tpusparse_torch import kernels
from tpusparse_torch.parallel import make_mesh, shard_plan_rows, sharded_spmm
from tpusparse_torch.parallel.linalg import sharded_cg

N, BLOCKSIZE = 256, (8, 8)


def inputs() -> dict:
    """A (256 x 256 at 5 %), B and b, from numpy seeds."""
    rng = np.random.default_rng(0)
    a = ssp.random(N, N, density=0.05, format="csr", random_state=0, dtype=np.float32)
    a.sort_indices()
    return dict(A=a, B=rng.normal(size=(N, 32)).astype(np.float32),
                b=rng.normal(size=(N,)).astype(np.float32))


def spd(a: tt.CSR) -> tt.CSR:
    """A + Aᵀ + 30 I: symmetric and diagonally dominant."""
    s = tt.sp_add(a, tt.transpose_csr(a))
    return tt.sp_add(s, tt.speye(a.shape[0], device=a.data.device), 1.0, 30.0)


def run(world: int, device: torch.device, inp: dict) -> dict:
    """One rank's part, in a process group of `world` ranks that is up."""
    mesh = make_mesh((world,), ("model",), device=device)
    a_sp = inp["A"]
    A = tt.CSR.from_scipy(a_sp, device=device)
    B = torch.from_numpy(inp["B"]).to(device)
    before = kernels.launches_by_kernel()

    # row-partitioned SpMM: A sharded, B replicated, no communication
    # forward but the all_gather that hands every rank the global C
    rsp = shard_plan_rows(A, world, blocksize=BLOCKSIZE)
    y = sharded_spmm(rsp, A.data, B, mesh)
    ref = a_sp.astype(np.float64) @ inp["B"].astype(np.float64)
    err = float(np.abs(host(y) - ref).max() / np.abs(ref).max())
    if not err < 1e-4:
        raise AssertionError(f"sharded_spmm: rel err {err}")

    # distributed CG: every matvec is a sharded SpMM
    S = spd(A)
    b = torch.from_numpy(inp["b"]).to(device)
    x, _ = sharded_cg(S, b, mesh, blocksize=BLOCKSIZE, tol=1e-8, maxiter=200)
    r = S.to_scipy().astype(np.float64) @ host(x) - inp["b"]
    res = float(np.linalg.norm(r) / np.linalg.norm(inp["b"]))
    if not res < 1e-4:
        raise AssertionError(f"sharded_cg: rel resid {res}")
    return {"spmm_err": err, "cg_resid": res, "y": host(y), "x": host(x),
            "launches": launches_since(before)}


def _rank(rank: int, world: int, store: str, device_type: str, inp: dict, out: str) -> None:
    """One rank: its process group on the `file://` store, then `run`; rank 0
    saves the figures to `out`."""
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method="file://" + store, rank=rank, world_size=world)
    try:
        figures = run(world, dev, inp)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(figures, out)


def main(device=None, world_size=None) -> dict:
    """Runs `run` on `world_size` ranks (default: every card present for the
    card, 4 for the CPU): in this process at world size 1 where no process
    group is up in it, else in spawned processes, one a rank (the card's
    rank r on card r)."""
    import torch.multiprocessing as mp

    dev = tt.resolve_device(device)
    world = world_size or (torch.cuda.device_count() if dev.type == "cuda" else 4)
    if N % (BLOCKSIZE[0] * world):
        raise ValueError(f"world size {world} must divide {N} rows into whole "
                         f"{BLOCKSIZE[0]}-row blocks")
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"world size {world}: {torch.cuda.device_count()} card(s) present")
    inp = inputs()
    tmp = tempfile.mkdtemp(prefix="tpusparse_torch_example06_")
    try:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "figures.pt")
        if world == 1 and not dist.is_initialized():
            _rank(0, 1, store, dev.type, inp, out)
        else:
            mp.start_processes(_rank, args=(world, store, dev.type, inp, out), nprocs=world,
                               join=True, start_method="spawn")
        figures = torch.load(out, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  sharded_spmm over {world} ranks: rel err {figures['spmm_err']:.2e}")
    print(f"  sharded_cg over {world} ranks:   rel resid {figures['cg_resid']:.2e}")
    print(f"  rank 0's kernel launches: {figures['launches']}")
    print("06_distributed: OK  (ring-halo SpMM, dp x tp training, TP BERT, pipeline, MoE, "
          "sequence parallel: tpusparse_torch/parallel/)")
    out = {"y": figures.pop("y"), "x": figures.pop("x")}
    return {"world_size": world, **figures, "out": out}


if __name__ == "__main__":
    main()
