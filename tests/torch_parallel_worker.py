"""One rank of the CPU parity runs of `tpusparse_torch.parallel`.

    python tests/torch_parallel_worker.py GROUP RANK WORLD STORE OUT [INPUTS]

Each of WORLD processes runs this script with its RANK; they meet on a gloo
group at the `file://` store STORE and run GROUP's cases ('spmm', 'train',
'attention' or 'models'); rank 0 writes every case's result to the `.npz`
OUT. INPUTS, an `.npz` of weights to carry (the 'train' and 'models'
groups), is read where a case needs it. The module imports torch, numpy,
scipy and tpusparse_torch only, and its input functions are shared with
the tests, which hold the results against the JAX package on the same
inputs.
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


# -- part b: attention and the sharded models ----------------------------------------

BAND = dict(shape=(2, 2, 256, 16), window=32)  # 2 window blocks a rank
ULYSSES_SHAPE = (1, 4, 64, 16)
FLASH_SHAPE = (1, 4, 4 * 128, 32)  # 128 rows a rank
BERT = dict(hidden=48, num_heads=4, intermediate=96)
BERT_X = (4, 40, 48)
BERT_IDS = (4, 16)
ENCODER = dict(num_layers=2, vocab_size=100, max_position=16, **BERT)
BERT_MESH = (2, 2)
PIPE = dict(stages=WORLD, d=16, batch=32, microbatches=4)
MOE = dict(num_experts=8, d_model=16, d_hidden=32, tokens=64)
GPT_SMALL = dict(num_layers=2, hidden=64, num_heads=4, intermediate=128, vocab_size=50,
                 max_position=32)
GPT_MESHES = ((2, 2), (1, 4))  # the vocabulary split over 'model', and whole


def normal(seed, shape, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def band_inputs():
    return tuple(normal(20 + i, BAND["shape"]) for i in range(3))


def ulysses_inputs():
    """q, k, v and a per-head bool mask of (b, h, s, s)."""
    qkv = tuple(normal(30 + i, ULYSSES_SHAPE) for i in range(3))
    b, h, s, _ = ULYSSES_SHAPE
    return qkv + (np.random.default_rng(33).random((b, h, s, s)) > 0.2,)


def flash_inputs():
    return tuple(normal(40 + i, FLASH_SHAPE) for i in range(3))


def bert_input():
    return normal(50, BERT_X)


def bert_ids():
    return np.random.default_rng(51).integers(0, ENCODER["vocab_size"], BERT_IDS)


def pipe_inputs():
    """(Ws (S, d, d), bs (S, d), x (batch, d)) of relu(h W + b) stages."""
    S, d = PIPE["stages"], PIPE["d"]
    return (normal(60, (S, d, d), 1 / np.sqrt(d)), normal(61, (S, d), 0.1),
            normal(62, (PIPE["batch"], d)))


def moe_x():
    return normal(70, (MOE["tokens"], MOE["d_model"]))


def gpt_ids():
    return np.random.default_rng(0).integers(0, GPT_SMALL["vocab_size"], (2, 8))


def _grads(out: dict, key: str, tensors: dict) -> None:
    for name, t in tensors.items():
        out[f"{key}_grad_{name}"] = t.grad.detach().clone()


def _leaves(arrays) -> tuple:
    return tuple(torch.from_numpy(a).requires_grad_() for a in arrays)


def _errors(out: dict, cases: dict) -> None:
    """The message of the ValueError each case raises ('' where none)."""
    for name, fn in cases.items():
        try:
            fn()
            out[f"error_{name}"] = np.array("")
        except ValueError as e:
            out[f"error_{name}"] = np.array(str(e))


def run_attention(out: dict) -> None:
    from tpusparse_torch import parallel as P

    mesh = P.make_mesh((WORLD,), ("seq",), device="cpu")

    def with_grads(key, fn, arrays):
        q, k, v = _leaves(arrays)
        o = fn(q, k, v)
        o.square().sum().backward()
        out[key] = o.detach()
        _grads(out, key, {"q": q, "k": k, "v": v})

    with_grads("band", lambda q, k, v: P.ring_local_attention(q, k, v, BAND["window"], mesh),
               band_inputs())
    *qkv, mask = ulysses_inputs()
    with_grads("ulysses_mask", lambda q, k, v: P.ulysses_attention(
        q, k, v, mesh, mask=torch.from_numpy(mask)), qkv)
    with_grads("ulysses_causal", lambda q, k, v: P.ulysses_attention(q, k, v, mesh, causal=True),
               qkv)
    for causal in (False, True):
        with_grads(f"ring_flash_{causal}", lambda q, k, v: P.ring_flash_attention(
            q, k, v, mesh, causal=causal), flash_inputs())
        with_grads(f"ulysses_fused_{causal}", lambda q, k, v: P.ulysses_attention(
            q, k, v, mesh, fused=True, causal=causal), flash_inputs())
    q, k, v = (torch.from_numpy(a).bfloat16() for a in flash_inputs())
    o = P.ring_flash_attention(q, k, v, mesh)
    out["ring_flash_bf16_dtype"] = np.array(str(o.dtype))
    out["ring_flash_bf16"] = o.float()
    out["ring_bytes"] = P.count_p2p_bytes(P.ring_flash_attention, *_leaves(flash_inputs()), mesh)
    z = torch.zeros((1, 6, 64, 8))
    _errors(out, {
        "ulysses_heads": lambda: P.ulysses_attention(z, z, z, mesh),
        "ring_flash_seq": lambda: P.ring_flash_attention(z[:, :, :62], z[:, :, :62],
                                                         z[:, :, :62], mesh),
        "band_seq": lambda: P.ring_local_attention(z[:, :, :48], z[:, :, :48], z[:, :, :48],
                                                   16, mesh)})


def run_models(out: dict, inputs: dict) -> None:
    import tpusparse_torch as tt
    from tpusparse_torch import parallel as P
    from tpusparse_torch.convert import load_moe_params, load_stage_params
    from tpusparse_torch.parallel.mesh import _gather_dim

    # Megatron BERT: the layer at 'dense' and 'flash', the 2-layer encoder
    mesh = P.make_mesh(BERT_MESH, device="cpu")
    group = mesh.get_group("model")
    for kind in ("dense", "flash", "encoder"):
        if kind == "encoder":
            model = tt.BertEncoder(**ENCODER, device="cpu")
            x = torch.from_numpy(bert_ids())
        else:
            model = tt.BertAttentionLayer(**BERT, attention=kind, device="cpu")
            x = torch.from_numpy(bert_input())
        tt.load_flax_params(model, {"params": _tree(inputs, f"bert_{kind}/")})
        local, specs = P.shard_bert_params(model, mesh)
        y = P.make_tp_forward(model, mesh, specs)(local, x)
        tt.bert_loss(y).backward()
        out[f"bert_{kind}"] = y.detach()
        for name, p in local.items():
            dim = specs[name].index("model") if "model" in specs[name] else None
            g = p.grad if dim is None else _gather_dim(p.grad, group, dim)
            out[f"bert_{kind}_grad:{name}"] = g
    _errors(out, {"bert_heads": lambda: P.validate_tp_heads(6, P.make_mesh((1, WORLD),
                                                                             device="cpu"))})

    # the pipeline: relu(h W + b) stages, one a rank
    pmesh = P.make_mesh((WORLD,), ("stage",), device="cpu")
    ws, bs, x = pipe_inputs()
    params = tuple(t.requires_grad_() for t in load_stage_params((ws, bs), device="cpu"))
    x = torch.from_numpy(x).requires_grad_()
    y = P.pipeline_apply(lambda p, h: torch.relu(tt.mm(h, p[0]) + p[1]), params, x, pmesh,
                         num_microbatches=PIPE["microbatches"])
    y.square().sum().backward()
    out["pipe"] = y.detach()
    _grads(out, "pipe", {"ws": params[0], "bs": params[1], "x": x})
    _errors(out, {"pipe_batch": lambda: P.pipeline_apply(
        lambda p, h: h, torch.zeros((WORLD, 1)), torch.zeros((10, 4)), pmesh,
        num_microbatches=4)})

    # MoE, the experts over 'expert'
    emesh = P.make_mesh((WORLD,), ("expert",), device="cpu")
    for key, fn in (("moe", lambda p, x: P.moe_forward(p, x, emesh)),
                    ("moe_a2a", lambda p, x: P.moe_forward_a2a(
                        p, x, emesh, capacity_factor=float(MOE["num_experts"])))):
        params = {k: v.requires_grad_() for k, v in
                  load_moe_params(_tree(inputs, "moe/"), device="cpu").items()}
        x = torch.from_numpy(moe_x()).requires_grad_()
        y = fn(params, x)
        y.square().sum().backward()
        out[key] = y.detach()
        _grads(out, key, {**params, "x": x})
    params = load_moe_params(_tree(inputs, "moe/"), device="cpu")
    x = torch.from_numpy(moe_x())
    out["moe_a2a_drop"] = P.moe_forward_a2a(params, x, emesh, capacity_factor=1.0)
    out["moe_balance"] = P.load_balance_loss(params, x)
    six = {k: v[:6] if k != "router" else v[:, :6] for k, v in params.items()}
    _errors(out, {"moe_experts": lambda: P.moe_forward(six, x, emesh),
                  "moe_a2a_experts": lambda: P.moe_forward_a2a(six, x, emesh),
                  "moe_a2a_tokens": lambda: P.moe_forward_a2a(params, x[:30], emesh)})

    # TP int8 decode: the single-card step and two meshes
    gpt = tt.GPTDecoder(**GPT_SMALL, device="cpu")
    tt.load_flax_params(gpt, {"params": _tree(inputs, "gpt/")})
    qm = tt.quantize_gpt(gpt)
    ids = torch.from_numpy(gpt_ids())
    with torch.no_grad():
        _, cache = qm.prefill(ids[:, :4])

    def copy(c):
        return tuple(tuple(t.clone() for t in layer) for layer in c)

    with torch.no_grad():
        out["gpt_single"], single = qm.decode_step(ids[:, 4], copy(cache), 4)
    out["gpt_single_kq0"] = single[0][0]
    for shape in GPT_MESHES:
        tag = "x".join(map(str, shape))
        gmesh = P.make_mesh(shape, device="cpu")
        qs, _ = P.shard_qgpt(qm, gmesh)
        step = P.make_tp_decode_step(qs, gmesh)
        logits, local = step(ids[:, 4], copy(cache), 4)
        full = step.gather_cache(local)
        out[f"gpt_tp_{tag}"] = logits
        for i, name in enumerate(("kq", "ks", "vq", "vs")):
            out[f"gpt_tp_{tag}_{name}"] = torch.stack([layer[i] for layer in full])
        out[f"gpt_single_{tag}_match"] = np.array(all(
            torch.equal(a, b) for la, lb in zip(full, single) for a, b in zip(la, lb)))
    _errors(out, {"gpt_heads": lambda: P.shard_qgpt(
        tt.quantize_gpt(tt.GPTDecoder(2, 48, 3, 96, 50, 32, device="cpu")),
        P.make_mesh((1, WORLD), device="cpu"))})

    # the dry run's body on these ranks, as `dryrun_multichip(WORLD, 'cpu')`
    # runs it on the ranks it spawns
    from tpusparse_torch.parallel.dryrun import _body
    try:
        _body(WORLD, torch.device("cpu"))
        out["dryrun_error"] = np.array("")
    except Exception as e:  # every rank fails alike on these shapes
        out["dryrun_error"] = np.array(repr(e))


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
        elif group == "attention":
            run_attention(out)
        elif group == "models":
            run_models(out, inputs)
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
