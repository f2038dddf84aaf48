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
             between events).
gemm         the float GEMM (`gemm_kernel`) by `chip_smoke.time_ms_queued` at
             GEMM_CASES: 4096^3 in fp32 'high' and 'default' and on bf16
             operands, (512, 4096, 4096), a ragged transposed case and the
             MNIST MLP's 'dense' products; each with a SHA-256 of its output
             (equal digests: equal bits), and in a tree whose gemm_kernel
             takes `block_m`, each block height's time.
gemm_s8      the int8 GEMM's entry point (`gemm_int8_kernel`: int8_kmajor
             and the kernel) by `chip_smoke.time_ms_queued` at 4096^3, at
             (4096, 4096, n) for n 8, 64 and 512 (QuantizedDense's
             activation panels), at the ragged (4100, 4100, 4100) and at
             (4096, 4112, 4096) (k a multiple of 16, not of 128: A read as
             stored, its rows off 128-byte lines); in a tree that has them,
             also int8_kmajor alone behind a sleep and the kernel alone
             (`_gemm_s8_launch` on B already K-major); the host's
             microseconds a call at n 8 and 64
             (the entry point, and in a tree that has them int8_kmajor and
             the kernel alone), enqueued behind a sleep so the card never
             holds the host back; then the int8 headline's entry point (the
             16384^2 QuantizedMatrix, 10 % of its 128^2 blocks, times B
             16384 x 512), which this group's kernel does not run.
flash_wide_forward
             the attention forwards at head dims above 128: flash_fwd and
             blk_flash_fwd (on 'bigbird', window 64) at chip_smoke's
             WIDE_SHAPE and at the same (b, h, s) with d 384, 512 and 640
             (512-wide chunks of o), after the d = 64 flash_fwd at (96, 512,
             64), each in fp32 'high', fp32 'default' and on bf16 operands,
             by `chip_smoke.time_ms_queued`, with a SHA-256 of o and lse
             (equal digests: equal bits).
flash_wide_backward
             the flash backward at head dims above 128: flash_dq and
             flash_dkv at WIDE_SHAPE's (b, h, s) with d 256, 384, 512 and 640
             (512-wide chunks of the output), in fp32 'high', fp32 'default'
             and on bf16 operands, by `chip_smoke.time_ms_queued`, each with
             a SHA-256 of its outputs and its bound (3xTF32 in 'high', else
             the bf16 tensor cores), beside SDPA's autograd backward behind a
             sleep (fp32 for 'high', bf16 for the other two); first the
             digests of the kernels it must leave alone: flash_dq/flash_dkv
             and blk_flash_dq/blk_flash_dkv ('bigbird', window 64) at (96,
             512, 64), and at WIDE_SHAPE flash_fwd, blk_flash_fwd and
             blk_flash_dq/blk_flash_dkv, in the three tiers. Every output is
             held against the plain version (printed with the limit it is
             within), and in fp32 'high' the kernel's and the plain
             version's dq, dk and dv against float64.
block_wide_backward
             the same for blk_flash_dq and blk_flash_dkv on 'bigbird',
             window 64 (SDPA with the plan's token mask), after the same
             digests at d 64 and, at WIDE_SHAPE, of flash_fwd, blk_flash_fwd
             and flash_dq/flash_dkv."""
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


GEMM_S8_SHAPES = ((4096, 4096, 4096), (4096, 4096, 8), (4096, 4096, 64), (4096, 4096, 512),
                  (4100, 4100, 4100), (4096, 4112, 4096))


def gemm(name, cs, tt):
    import hashlib
    import inspect

    import numpy as np
    import torch

    from tpusparse_torch.kernels import gemm as gk

    tiles = "block_m" in inspect.signature(gk.gemm_kernel).parameters
    rng = np.random.default_rng(5)
    for (m, n, k), transa, transb, dtype_name, prec in GEMM_CASES:
        dtype = getattr(torch, dtype_name)
        a = rng.standard_normal((k, m) if transa else (m, k)).astype(np.float32)
        b = rng.standard_normal((n, k) if transb else (k, n)).astype(np.float32)
        a, b = torch.from_numpy(a).to("cuda", dtype), torch.from_numpy(b).to("cuda", dtype)
        kw = dict(transa=transa, transb=transb, precision=prec)
        c = gk.gemm_kernel(a, b, **kw)
        digest = hashlib.sha256(c.float().cpu().numpy().tobytes()).hexdigest()[:16]
        label = (f"({m}, {n}, {k}){' transa' if transa else ''}{' transb' if transb else ''} "
                 f"{dtype_name} '{prec}'")
        ms = cs.time_ms_queued(lambda: gk.gemm_kernel(a, b, **kw))
        line = f"{name} gemm {label}: {ms:.4f} ms, C sha256 {digest}"
        for bm in gk.BLOCK_MS if tiles else ():
            ms = cs.time_ms_queued(lambda: gk.gemm_kernel(a, b, block_m=bm, **kw))
            line += f", block_m {bm} {ms:.4f} ms"
        print(line, flush=True)
        del a, b, c


# gemm's cases: (m, n, k), transa, transb, operand type, tier
GEMM_CASES = (
    ((4096, 4096, 4096), False, False, "float32", "high"),
    ((4096, 4096, 4096), False, False, "float32", "default"),
    ((4096, 4096, 4096), False, False, "bfloat16", "high"),
    ((512, 4096, 4096), False, False, "float32", "high"),
    ((1000, 300, 777), True, True, "float32", "high"),
    ((32, 256, 784), False, True, "float32", "high"),
    ((256, 784, 32), True, False, "float32", "high"),
)


def gemm_s8(name, cs, tt):
    import numpy as np
    import torch

    from tpusparse_torch import quant
    from tpusparse_torch.kernels import gemm as gk
    from tpusparse_torch.kernels import tiled_spmm as tk
    from tpusparse_torch.utils.matrices import block_sparse_csr

    rng = np.random.default_rng(19)
    redesigned = hasattr(gk, "_gemm_s8_launch")
    for m, k, n in GEMM_S8_SHAPES:
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
        b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).cuda()
        ms = cs.time_ms_queued(lambda: gk.gemm_int8_kernel(a, b))
        line = f"{name} gemm_s8 ({m}, {k}, {n}): entry point {ms:.4f} ms"
        if redesigned:
            ldt = gk._s8_ldt(k)
            bt, a_k = tk.int8_kmajor_kernel(b, ldt), gk._rows_for_tma(a, ldt)
            kt = cs.time_ms_ahead(lambda: tk.int8_kmajor_kernel(b, ldt))
            t = cs.time_ms_queued(lambda: gk._gemm_s8_launch(a_k, bt, k))
            line += (f"; int8_kmajor {kt:.4f} ms behind a sleep; the kernel alone at 128 x "
                     f"{gk._s8_tile_n(m, n)} {t:.4f}")
            del bt, a_k
        print(line, flush=True)
        if n in (8, 64):
            line = (f"{name} gemm_s8 ({m}, {k}, {n}) host us a call: entry point "
                    f"{cs.host_us(lambda: gk.gemm_int8_kernel(a, b)):.1f}")
            if redesigned:
                bt = tk.int8_kmajor_kernel(b, ldt)
                line += (f", int8_kmajor {cs.host_us(lambda: tk.int8_kmajor_kernel(b, ldt)):.1f}"
                         f", the kernel {cs.host_us(lambda: gk._gemm_s8_launch(a, bt, k)):.1f}")
                del bt
            print(line, flush=True)
        del a, b
    head = block_sparse_csr(1, (16384, 16384), (128, 128), 0.10, device="cuda")
    qa = tt.QuantizedMatrix(head, (128, 128))
    hb = torch.from_numpy(np.random.default_rng(7).random((16384, 512), dtype=np.float32)).cuda()
    b_q, t = quant.quantize_columns(hb)
    args = (qa.plan, qa.qvals, qa.scales, b_q, t)
    ms = cs.time_ms_queued(lambda: tk.resident_spmm_int8_kernel(*args))
    print(f"{name} int8 headline entry point (int8_kmajor + spmm_int8): {ms:.4f} ms", flush=True)


def flash_wide_forward(name, cs, tt):
    import hashlib

    import torch

    from tpusparse_torch.kernels import block_flash_attention as bfa
    from tpusparse_torch.kernels import flash_attention as fa

    def digest(o, lse):
        h = hashlib.sha256(o.float().cpu().numpy().tobytes())
        h.update(lse.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    tiers = ((torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"))
    b, h, s, _ = cs.WIDE_SHAPE
    plan = tt.BlockAttnPlan(tt.bigbird_block_mask(s, cs.PATTERN_WINDOW), cs.PATTERN_WINDOW,
                            cs.PATTERN_WINDOW, s)
    for dtype, prec in tiers:
        q, k, v, _ = cs._flash_operands((96, 512, 64), 1400, dtype)
        kw = dict(sm_scale=1 / 8, causal=False, precision=prec)
        ms = cs.time_ms_queued(lambda: fa.flash_fwd_kernel(q, k, v, **kw))
        print(f"{name} flash_fwd (96, 512, 64) {str(dtype)[6:]} '{prec}': {ms:.4f} ms, o+lse "
              f"sha256 {digest(*fa.flash_fwd_kernel(q, k, v, **kw))}", flush=True)
        del q, k, v
    for d in (cs.WIDE_SHAPE[-1], 384, 512, 640):
        for dtype, prec in tiers:
            q, k, v, _ = cs._flash_operands((b * h, s, d), 1300, dtype)
            kw = dict(sm_scale=1 / d ** 0.5, causal=False, precision=prec)
            bkw = dict(sm_scale=1 / d ** 0.5, precision=prec)
            runs = {"flash_fwd": lambda: fa.flash_fwd_kernel(q, k, v, **kw),
                    "blk_flash_fwd": lambda: bfa.blk_flash_fwd_kernel(q, k, v, plan, **bkw)}
            for kern, run in runs.items():
                ms = cs.time_ms_queued(run)
                print(f"{name} {kern} {(b, h, s, d)} {str(dtype)[6:]} '{prec}': {ms:.4f} ms, "
                      f"o+lse sha256 {digest(*run())}", flush=True)
            del q, k, v


def _wide_backward(name, cs, tt, block):
    """flash_wide_backward (`block` False) and block_wide_backward (True)."""
    import hashlib

    import torch
    from torch.nn.attention import sdpa_kernel

    from tpusparse_torch.kernels import block_flash_attention as bfa
    from tpusparse_torch.kernels import flash_attention as fa
    from tpusparse_torch.utils.config import fp32_matmul

    def digest(*ts):
        h = hashlib.sha256()
        for x in ts:
            h.update(x.float().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    tiers = ((torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"))
    b, h, s, _ = cs.WIDE_SHAPE
    plans = {n: tt.BlockAttnPlan(tt.bigbird_block_mask(n, cs.PATTERN_WINDOW), cs.PATTERN_WINDOW,
                                 cs.PATTERN_WINDOW, n) for n in {512, s}}

    def backward(q, k, v, do, kw, plan=None):
        """(flash or block) forward, then dq and (dk, dv) and their runs"""
        if plan is None:
            kw = dict(kw, causal=False)
            o, lse = fa.flash_fwd_kernel(q, k, v, **kw)
            args = (q, k, v, do, lse, cs._delta(do, o))
            return (o, lse), args, (lambda: fa.flash_dq_kernel(*args, **kw),
                                    lambda: fa.flash_dkv_kernel(*args, **kw))
        o, lse = bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw)
        args = (q, k, v, do, lse, cs._delta(do, o), plan)
        return (o, lse), args, (lambda: bfa.blk_flash_dq_kernel(*args, **kw),
                                lambda: bfa.blk_flash_dkv_kernel(*args, **kw))

    # the digests of the kernels this group must leave alone: both backwards
    # at d 64, both forwards and the other backward at WIDE_SHAPE
    for label, shape, d in (("(96, 512, 64)", (96, 512, 64), 64),
                            (f"{cs.WIDE_SHAPE}", (b * h, s, cs.WIDE_SHAPE[-1]),
                             cs.WIDE_SHAPE[-1])):
        for dtype, prec in tiers:
            q, k, v, do = cs._flash_operands(shape, 1500 + d, dtype)
            kw = dict(sm_scale=1 / d ** 0.5, precision=prec)
            fwd, _, (dq, dkv) = backward(q, k, v, do, kw)
            bfwd, _, (bdq, bdkv) = backward(q, k, v, do, kw, plans[shape[1]])
            line = f"{name} digests {label} {str(dtype)[6:]} '{prec}': "
            if d == 64:
                line += (f"flash dq+dk+dv {digest(dq(), *dkv())}, "
                         f"blk dq+dk+dv {digest(bdq(), *bdkv())}")
            else:
                other, (odq, odkv) = ("flash", (dq, dkv)) if block else ("blk", (bdq, bdkv))
                line += (f"flash_fwd o+lse {digest(*fwd)}, blk_flash_fwd o+lse {digest(*bfwd)}, "
                         f"{other} dq+dk+dv {digest(odq(), *odkv())}")
            print(line, flush=True)
            del q, k, v, do, fwd, bfwd

    plan = plans[s] if block else None
    kind = "blk_flash" if block else "flash"
    plain = ((bfa._blk_dq_plain, bfa._blk_dkv_plain) if block
             else (fa._flash_dq_plain, fa._flash_dkv_plain))
    f64 = cs._blk_bwd_f64 if block else cs._flash_bwd_f64
    bh = b * h
    entries = float(bh * (plan.covered_tiles * plan.block_q * plan.block_k if block else s * s))
    mask = plan.token_mask("cuda") if block else None
    for d in (cs.WIDE_SHAPE[-1], 384, 512, 640):
        # (flops, bytes) of dq and dk/dv: each input read once, each output
        # written once
        qkv, stat = 4.0 * bh * s * d, 4.0 * bh * s
        work = {"dq": (6 * entries * d, 5 * qkv + 2 * stat),
                "dkv": (8 * entries * d, 6 * qkv + 2 * stat)}
        sdpa_ms = {}  # SDPA's autograd backward behind a sleep, by operand type
        for dtype, prec in tiers:
            q, k, v, do = cs._flash_operands((bh, s, d), 1300, dtype)
            kw = dict(sm_scale=1 / d ** 0.5, precision=prec)
            _, args, (dq, dkv) = backward(q, k, v, do, kw, plan)
            pkw = kw if block else dict(kw, causal=False)
            got = (dq(), *dkv())
            want = (plain[0](*args, **pkw), *plain[1](*args, **pkw))
            err = max(cs.rel_err(g_, w_)[1] for g_, w_ in zip(got, want))
            high = dtype == torch.float32 and prec == "high"
            limit = cs.FLASH_LIMIT_FP32 if high else cs.FLASH_LIMIT_ROUNDED
            witness = ""
            if high:  # which side is farther from float64: kernel, plain
                ref = f64(*args, sm_scale=kw["sm_scale"])
                witness = "; over scale vs float64 (kernel, plain) " + ", ".join(
                    f"{n} {cs.rel_err(g_, w_)[1]:.2e} {cs.rel_err(p_, w_)[1]:.2e}"
                    for n, g_, p_, w_ in zip(("dq", "dk", "dv"), got, want, ref))
                del ref
            sha = digest(got[0]), digest(*got[1:])
            del got, want
            dq_ms, dkv_ms = cs.time_ms_queued(dq), cs.time_ms_queued(dkv)
            bounds = {}
            for n, (flops, nbytes) in work.items():
                if high:
                    bounds[n] = f"{cs.bound_fp32(flops, nbytes)[0]:.4f} ms 3xTF32"
                else:
                    if dtype == torch.bfloat16:  # q, k, v, do and the outputs in 2 bytes
                        nbytes -= (5 if n == "dq" else 6) * 2.0 * bh * s * d
                    bounds[n] = f"{cs.bound(flops, nbytes, cs.BF16_FLOPS)[0]:.4f} ms bf16"
            lib_dtype = torch.float32 if high else torch.bfloat16
            if lib_dtype not in sdpa_ms:
                b4 = [t.to(lib_dtype).view(b, h, s, d).detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
                do4 = do.to(lib_dtype).view(b, h, s, d)
                backend = cs._sdpa_backend(*b4, mask)
                with sdpa_kernel([backend]), fp32_matmul():
                    og = torch.nn.functional.scaled_dot_product_attention(*b4, attn_mask=mask)
                    sdpa_ms[lib_dtype] = (cs.time_ms_ahead(
                        lambda: torch.autograd.grad(og, b4, do4, retain_graph=True)),
                        backend.name)
                del b4, do4, og
            lib_ms, backend = sdpa_ms[lib_dtype]
            print(f"{name} {(b, h, s, d)} {str(dtype)[6:]} '{prec}': {kind}_dq {dq_ms:.4f} ms "
                  f"(bound {bounds['dq']}), sha256 {sha[0]}; {kind}_dkv {dkv_ms:.4f} ms (bound "
                  f"{bounds['dkv']}), sha256 {sha[1]}; pair {dq_ms + dkv_ms:.4f}; sdpa "
                  f"{str(lib_dtype)[6:]} ({backend}) autograd backward"
                  f"{' with the token mask' if block else ''} behind a sleep {lib_ms:.4f} ms; "
                  f"dq/dk/dv vs plain {err:.2e} (limit {limit:.0e}"
                  f"{'' if err <= limit else ', OVER'}){witness}", flush=True)
            del q, k, v, do, args


def flash_wide_backward(name, cs, tt):
    _wide_backward(name, cs, tt, block=False)


def block_wide_backward(name, cs, tt):
    _wide_backward(name, cs, tt, block=True)


GROUPS = {"block_spmm": block_spmm, "flash_backward": flash_backward, "gemm": gemm,
          "gemm_s8": gemm_s8, "flash_wide_forward": flash_wide_forward,
          "flash_wide_backward": flash_wide_backward, "block_wide_backward": block_wide_backward}

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
