#!/usr/bin/env python3
"""Time one group of tpusparse_torch's kernels from one tree on the card, so
two trees can be compared on one card in turns.

    python3 compare_trees.py GROUP TREE

TREE is a directory that holds a `tpusparse_torch/` package (the repo
root, or another tree unpacked with `git archive <rev> tpusparse_torch`
into a directory that .gitignore lists). Its package is imported first; the
timing helpers and shapes come from this directory's chip_smoke.py. Run it
once a tree in a separate process, in the order A, B, B, A. GROUP is one of:

block_spmm   the block SpMM executors, each by `chip_smoke.time_ms_queued`
             in fp32 'high': the 2-D executor (`tiled_spmm_kernel`) and the
             compact one at the 16384^2 headline (10 % of its 128^2 blocks,
             n 512), at the low-fill plan (4096^2 at 1 %, blocks 8 x 32, n
             256) and on the low-fill matrix in blocks of 16, 32, 48 and 56
             rows by 32 (row-blocks under 64 rows); the batched executor at
             bench.py's two batched shapes (B (32, 2048, 512) under 10 % of
             the 128^2 blocks of 2048^2, and bert4d's (4096, 512, 64) under
             512^2 at 10 %) and their training steps (5 steps between
             events); the 2-D executor on bert4d's A times B[0] cut to n 32
             and 64; and the MNIST MLP's 'sparse' forward at batch 32 (its
             fc1 runs the 2-D executor at n 32 on 128^2 blocks), and each of
             its two layers' kernels alone, all three behind a sleep
             (`chip_smoke.time_ms_ahead`).
flash_backward
             the attention backward: flash_dq and flash_dkv at the
             BERT-base shapes (bh 96 at seq 512 and 128, bh 24 at seq 4096,
             head dim 64) in fp32 'high', fp32 'default' and on bf16
             operands, and blk_flash_dq and blk_flash_dkv at the 'bigbird'
             shape (bh 96, seq 512, block 64) in the same three tiers, each
             by `chip_smoke.time_ms_queued`; then the BERT-base 'flash'
             layer's training step at batch 8, seq 512 and batch 2, seq
             4096, and the 'bigbird' layer's at batch 8, seq 512 (5 steps
             between events)."""
import os
import sys


def block_spmm(name, cs, tt):
    import numpy as np
    import torch

    from tpusparse_torch.kernels import tiled_spmm as tk
    from tpusparse_torch.utils.matrices import block_sparse_csr

    lf = cs.LOW_FILL
    head = block_sparse_csr(1, (16384, 16384), (128, 128), 0.10, device="cuda")
    head_b = torch.from_numpy(np.random.default_rng(7).random((16384, 512),
                                                              dtype=np.float32)).cuda()
    low = tt.random_csr(41, lf["shape"], lf["density"], device="cuda")
    low_b = torch.from_numpy(np.random.default_rng(42).random(
        (lf["shape"][1], lf["n"]), dtype=np.float32)).cuda()
    cases = [("headline", head, head_b, (128, 128)), ("low-fill", low, low_b, lf["blocksize"])]
    cases += [(f"low-fill matrix, blocks {bm}x32", low, low_b, (bm, 32))
              for bm in (16, 32, 48, 56)]
    for label, a, b, bs in cases:
        plan = tt.build_plan(a, bs)
        cp = tt.compact_plan(plan)
        pv, cv = plan.pack_values(a.data), cp.pack_values(a.data)
        ms = cs.time_ms_queued(lambda: tk.tiled_spmm_kernel(plan, pv, b))
        cms = cs.time_ms_queued(lambda: tk.compact_spmm_kernel(cp, cv, b))
        print(f"{name} {label}: block_ell_spmm {ms:.4f} ms, compact_spmm {cms:.4f} ms",
              flush=True)
        del plan, cp, pv, cv
    del head, head_b, low, low_b
    for seed, (label, kind, shape, density, bshape) in zip((21, 11), cs.BATCHED_SHAPES):
        a, b3, g = cs._batched_operands(kind, shape, density, bshape, seed)
        plan = tt.build_plan(a)
        bv = plan.pack_values(a.data)
        ms = cs.time_ms_queued(lambda: tk.resident_spmm_batched_kernel(plan, bv, b3), reps=10)
        data = a.data.clone().requires_grad_(True)
        bb = b3.clone().requires_grad_(True)
        a_var = tt.CSR(data, a.indices, a.indptr, a.shape)

        def step():
            data.grad = bb.grad = None
            tt.tiled_spmm(a_var, bb).backward(g)

        step_ms = cs.time_ms_queued(step, reps=5, warmup=2, iters=3)
        print(f"{name} batched {label} {bshape}: resident_spmm_batched {ms:.4f} ms, training "
              f"step {step_ms:.4f} ms queued", flush=True)
        if label == "bert4d":
            for n in (32, 64):
                b = b3[0, :, :n].contiguous()
                ms = cs.time_ms_queued(lambda: tk.tiled_spmm_kernel(plan, bv, b))
                print(f"{name} bert4d A x B[0] (512, {n}): block_ell_spmm {ms:.4f} ms",
                      flush=True)
        del a, b3, g, plan, bv, data, bb, a_var
    net = cs._net("sparse", "cuda")
    x = torch.from_numpy(np.random.default_rng(3).random((32, 784), dtype=np.float32)).cuda()
    with torch.inference_mode():
        ms = cs.time_ms_ahead(lambda: net(x))
        h, layers = x, []
        for i in (1, 2):
            layer = getattr(net, f"fc{i}")
            lplan = tt.build_plan(layer.pattern.to_csr(layer.kernel_values))
            lbv = lplan.pack_values(layer.kernel_values)
            lb = h.transpose(0, 1).contiguous()
            layers.append(cs.time_ms_ahead(lambda: tk.resident_spmm_kernel(lplan, lbv, lb)))
            h = torch.relu(layer(h))
    print(f"{name} mlp sparse forward (batch 32): {ms:.4f} ms; block_ell_spmm fc1 (256x784 @ "
          f"784x32) {layers[0]:.4f} ms, fc2 (10x256 @ 256x32) {layers[1]:.4f} ms, each behind "
          "a sleep", flush=True)


def flash_backward(name, cs, tt):
    import torch

    from tpusparse_torch.kernels import block_flash_attention as bfa
    from tpusparse_torch.kernels import flash_attention as fa

    for shape in ((96, 512, 64), (96, 128, 64), (24, 4096, 64)):
        for dtype, prec in ((torch.float32, "high"), (torch.float32, "default"),
                            (torch.bfloat16, "high")):
            if shape[1] == 4096 and prec == "default":
                continue
            q, k, v, do = cs._flash_operands(shape, 700 + shape[1], dtype)
            kw = dict(sm_scale=1 / shape[-1] ** 0.5, causal=False, precision=prec)
            o, lse = fa.flash_fwd_kernel(q, k, v, **kw)
            delta = (do.float() * o.float()).sum(-1)
            dq = cs.time_ms_queued(lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, **kw))
            dkv = cs.time_ms_queued(lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, **kw))
            print(f"{name} {shape} {str(dtype)[6:]} {prec}: dq {dq:.4f} ms, dkv "
                  f"{dkv:.4f} ms, pair {dq + dkv:.4f}", flush=True)
            del q, k, v, do, o, lse, delta
    plan = tt.BlockAttnPlan(tt.bigbird_block_mask(512, cs.PATTERN_WINDOW), cs.PATTERN_WINDOW,
                            cs.PATTERN_WINDOW, 512)
    for dtype, prec in ((torch.float32, "high"), (torch.float32, "default"),
                        (torch.bfloat16, "high")):
        q, k, v, do = cs._flash_operands((96, 512, 64), 800 + 512, dtype)
        kw = dict(sm_scale=1 / 8, precision=prec)
        o, lse = bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw)
        args = (q, k, v, do, lse, cs._delta(do, o), plan)
        dq = cs.time_ms_queued(lambda: bfa.blk_flash_dq_kernel(*args, **kw))
        dkv = cs.time_ms_queued(lambda: bfa.blk_flash_dkv_kernel(*args, **kw))
        print(f"{name} bigbird_512 (96, 512, 64) {str(dtype)[6:]} {prec}: blk dq "
              f"{dq:.4f} ms, blk dkv {dkv:.4f} ms, pair {dq + dkv:.4f}", flush=True)
        del q, k, v, do, o, lse, args
    for attention, batch, seq in (("flash", cs.BERT_BATCH, 512),
                                  ("flash", cs.LONG_BATCH, cs.LONG_SEQ),
                                  ("bigbird", cs.BERT_BATCH, 512)):
        x = cs._bert_input(batch, seq, 40 + seq).cuda()
        layer = cs._bert_layer(attention, "cuda")
        opt = tt.make_train_state(layer)
        ms = cs.time_ms_queued(lambda: tt.bert_train_step(layer, opt, x), reps=5, warmup=2,
                               iters=3)
        print(f"{name} bert layer {attention} seq {seq} batch {batch}: train step "
              f"{ms:.4f} ms queued", flush=True)
        del x, layer, opt


GROUPS = {"block_spmm": block_spmm, "flash_backward": flash_backward}

if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in GROUPS:
        raise SystemExit(f"usage: compare_trees.py {{{'|'.join(GROUPS)}}} TREE")
    tree = os.path.abspath(sys.argv[2])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import tpusparse_torch as tt

    if not tt.__file__.startswith(tree):
        raise SystemExit(f"tpusparse_torch came from {tt.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    GROUPS[sys.argv[1]](sys.argv[2], cs, tt)
