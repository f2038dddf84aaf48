#!/usr/bin/env python3
"""Drive tpusparse_torch on one NVIDIA card and hold its kernels to account.

Run from the repo root:  python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:
  1. the card's name and power limit;
  2. build of the five CUDA sources from the repo (one nvcc per source, all
     started together; sm_90a), with ptxas's report;
  3. each kernel against its plain PyTorch version on the card at small
     shapes: block_ell_spmm (ragged m/k/n, blocksizes (8, 16), (32, 8),
     (128, 128), empty row-blocks, fp32 'high' and 'default', bf16; both
     entry points, which must agree bitwise), sddmm (the same blocksizes,
     ragged m/k/n, an empty row-block whose pad slots must be exactly 0,
     fp32 'high'/'highest'/'default', bf16) and gemm (all four transpose
     flags, ragged (100, 70, 33), fp32 'high' and 'default', bf16) and the
     three flash attention kernels (flash_fwd, flash_dq, flash_dkv) at
     (b, h, s, d) = (2, 3, 256, 64), causal (1, 2, 384, 64), ragged
     (1, 1, 200, 64), (2, 4, 128, 24), (1, 2, 128, 128) and a causal chunk
     with q_offset 256, each in 'high' and 'default' with fp32 and with
     bf16 inputs: o, lse, dq, dk, dv, each as max-abs error over scale; and
     the three block-pattern kernels (blk_flash_fwd, blk_flash_dq,
     blk_flash_dkv) on mask-free plans ('bigbird' block masks at blocks 32
     and 64, a block mask at s = 160) and token-exact masked plans (band
     patterns at blocks 64, 64x32, 128x256 and 256, s = 160 and 1000 off
     the block, the 'sparse' layer's plan at seq 4096), d from 24 to 128,
     each in fp32 'high', fp32 'default' and bf16, with dq, dk and dv run
     twice and required bitwise equal;
  4. the main path, each part with the launch counts set to 0 just before
     it and read just after:
     a. the 16384^2 block-sparse SpMM (10% of its 128x128 blocks, B
        16384 x 512 fp32, 'high') through `spmm_blocks`, and the forward of
        the flagship MNIST MLP (784 -> 256 -> 10, batch 32) in its 'sparse'
        and 'blocksparse' variants, with weights from a seeded generator;
     b. 20 SGD steps (lr 0.01, momentum 0.9, batch 32, synthetic MNIST)
        of the same MLP in its 'sparse', 'blocksparse' and 'dense' (GEMM
        kernel switched on) variants, with the launches of every step
        checked: 3 block_ell_spmm + 2 sddmm, or 5 gemm;
     c. the backward of the headline SpMM (dblocks by sddmm, dB by
        block_ell_spmm on the transpose plan) for a seeded dC;
     d. the BERT-base attention layer (hidden 768, 12 heads of 64,
        intermediate 3072, fp32 'high'), 'flash' and 'dense', batch 8 at seq
        128 and 512: a forward and 10 SGD steps (loss mean(out²), lr 0.01,
        momentum 0.9), the launches of each checked (1 flash_fwd per
        forward; 1 flash_fwd + 1 flash_dq + 1 flash_dkv per 'flash' step,
        none for 'dense');
     e. the BERT-base encoder ('flash', 12 layers, vocab 30522, batch 8,
        seq 512, seeded input_ids): a forward (12 flash_fwd) and 3 SGD steps
        (12 of each flash kernel per step);
     f. the BERT-base layer with attention='bigbird' (block = window = 64),
        batch 8, seq 512: a forward and 10 SGD steps (1 blk_flash_fwd per
        forward, 1 of each block kernel per step, no other launch); the
        'bigbird' encoder (12 layers, batch 8, seq 512): a forward and 3
        steps (12 of each per step);
     g. the long-seq grid of benchmarks/bert_attention_benchmark.py
        (--long-seq: seq 4096, batch 2): 'bigbird' with window 256,
        'sparse' with window 64 (routed to 'blockflash' with token masks,
        1 of each block kernel per step) and 'local' with window 128 (no
        kernel), a forward and 3 steps each; and the seq-512 routes at
        batch 8: 'sparse' (routed to 'dense', no kernel) and 'local';
  5. checks of the main path's results: headline forward, dblocks and dB
     against their plain versions (max-abs error over scale <= 1e-5), MLP
     log-probs, and the first 3 training steps' losses and parameters,
     against the same weights run on the CPU (rtol 1e-4, atol 5e-5); the
     loss must drop over the 20 steps (last < 0.8 x first); the BERT
     layer's loss must drop over its 10 steps and the encoder's outputs and
     losses be finite; one full-width 'flash' layer at batch 1, seq 128 on
     the card against the same weights on the CPU: the forward and 3
     steps' losses and parameters (rtol 1e-4, atol 5e-5); the same for a
     full-width 'bigbird' layer and a 'sparse' layer forced onto
     'blockflash', each at batch 1, seq 512;
  6. timings with CUDA events (median after warm-up): each kernel, its
     plain version and one PyTorch call that computes the same function (a
     yardstick the port never calls), at the headline shapes and at the
     MLP's, one training step per variant, and each kernel's bound from
     this run's inputs; the flash kernels at (b, h, s, d) = (8, 12, 512, 64)
     and (8, 12, 128, 64) against their plain versions, their bounds and
     torch's scaled_dot_product_attention (forward, and its autograd
     backward) in fp32, with the SDPA backend named; the block kernels at
     the 'bigbird' shapes (bh 96, seq 512, block 64; bh 24, seq 4096, block
     256) and at the 'sparse' layer's masked seq-4096 plan, against their
     plain versions, their bounds from the covered tiles and
     scaled_dot_product_attention with the token-exact boolean mask; the
     BERT layer's forward and step times in every variant and shape of 4d,
     4f and 4g, the seq-512 variants' steps queued back to back in turns,
     and the 'flash' and 'bigbird' encoders' times; a torch.profiler trace of the layer's steps at seq 512 ('flash',
     'dense', 'bigbird': device busy and idle share, the kernels that take
     the most time);
  7. the `kernels` JSON line, then the device JSON line, last.

Exits non-zero, printing no result, when no CUDA device is present or the
package is not beside the script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# fp32 tier tolerance of the JAX suite (CLAUDE.md "Conventions"). Kernel and
# plain version sum in different orders, both in fp32.
TOL_FP32 = dict(rtol=1e-4, atol=5e-5)
# C written in bf16: two fp32 sums a few ulps apart can round to adjacent
# bf16 values, one bf16 ulp being 2^-8..2^-7 of the value.
TOL_BF16_OUT = dict(rtol=1e-2, atol=1e-3)
HEADLINE_TOL = 1e-5  # max |kernel - plain| / max(|plain|, 1)
# NVIDIA H100 SXM datasheet peaks (dense, at the 700 W limit).
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
TRAIN_STEPS = 20
PARITY_STEPS = 3
# kernel launches of one training step, by variant (fc1, fc2 forward;
# fc2's dB; both layers' dW; fc1's input is the data, so no dB for it)
NO_FLASH = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
NO_BLK = {"blk_flash_fwd": 0, "blk_flash_dq": 0, "blk_flash_dkv": 0}
# every kernel's count, all 0
NO_LAUNCH = {"block_ell_spmm": 0, "sddmm": 0, "gemm": 0, **NO_FLASH, **NO_BLK}
STEP_LAUNCHES = {
    "sparse": {**NO_LAUNCH, "block_ell_spmm": 3, "sddmm": 2},
    "blocksparse": {**NO_LAUNCH, "block_ell_spmm": 3, "sddmm": 2},
    "dense": {**NO_LAUNCH, "gemm": 5},
}
# flash attention: max-abs error over scale of the kernel against its plain
# version. fp32 'high': both sum in fp32, in other orders (the forward's
# online softmax rescales per 64-key tile): 1e-5. 'default' tier and bf16
# inputs: p is rounded to bf16 against its tile's running max in the kernel
# and against the row max in the plain version, and bf16 outputs sit one ulp
# (2^-8..2^-7) apart: 1e-2.
FLASH_LIMIT_FP32 = 1e-5
FLASH_LIMIT_ROUNDED = 1e-2
BERT = dict(hidden=768, num_heads=12, intermediate=3072)  # BERT-base
BERT_BATCH = 8
BERT_SEQS = (128, 512)
BERT_LAYER_STEPS = 10
BERT_ENCODER_STEPS = 3
# the attention kernels of a path: (forward, dq, dk/dv)
FLASH = tuple(NO_FLASH)
BLK = tuple(NO_BLK)
# the pattern variants' window (the layer's default; 'bigbird' takes it as
# its block) and the long-seq grid of benchmarks/bert_attention_benchmark.py
# (--long-seq, l.71-99): variant, window
PATTERN_WINDOW = 64
LONG_SEQ, LONG_BATCH, LONG_STEPS = 4096, 2, 3
LONG_GRID = (("bigbird", 256), ("sparse", 64), ("local", 128))
ROUTE_STEPS = 3


def time_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median device time of one call of `fn`, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms_queued(fn, reps: int = 20, warmup: int = 3, iters: int = 5) -> float:
    """Median device time per call of `fn` over `reps` back-to-back calls
    between two CUDA events. The host enqueues ahead of the card, so the
    launch overhead hides behind kernels longer than it (`time_ms` events
    one call, overhead included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    """(bound ms, 'operations' or 'bytes') on the fp32 FFMA and HBM peaks."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def over_scale(got: torch.Tensor, want: torch.Tensor):
    """(max-abs error, max-abs error / max(|want|, 1))."""
    max_abs = float((got.float() - want.float()).abs().max())
    return max_abs, max_abs / max(float(want.abs().max()), 1.0)


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(f"device: {name}")
    print(smi.stdout.strip())  # name, power.limit
    return name


def phase_build() -> None:
    from tpusparse_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build(_build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in sorted(set(line.strip() for line in text.splitlines()
                               if "Used" in line or "spill" in line)):
            print(f"  ptxas {name}: {line}")


def _dense_case(seed, m, k, density, empty_block=None):
    rng = np.random.default_rng(seed)
    a = (rng.random((m, k)) < density) * rng.standard_normal((m, k))
    if empty_block is not None:
        r0, r1 = empty_block
        a[r0:r1] = 0.0
    return a.astype(np.float32), rng


def _check_case(name, got, want, extra=""):
    tol = TOL_BF16_OUT if got.dtype == torch.bfloat16 else TOL_FP32
    g, w = got.float(), want.float()
    rel = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
    ok = torch.allclose(g, w, **tol) and bool(torch.isfinite(g).all())
    print(f"case {name}: max_rel_err {rel:.3e} (rtol {tol['rtol']}, atol "
          f"{tol['atol']}){extra}, {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")


def phase_small_cases() -> None:
    import tpusparse_torch as tt
    from tpusparse_torch.kernels.tiled_spmm import (
        _block_exec_plain,
        resident_spmm_kernel,
        tiled_spmm_kernel,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    # name, (m, k, n), blocksize, density, empty rows, vals, b, precision
    cases = [
        ("ragged_8x16_fp32_high", (100, 70, 33), (8, 16), 0.15, None, f32, f32, "high"),
        ("ragged_32x8_fp32_default", (100, 70, 130), (32, 8), 0.15, None, f32, f32, "default"),
        ("ragged_8x16_bf16_high", (100, 70, 65), (8, 16), 0.15, None, bf16, bf16, "high"),
        ("ragged_32x8_f32vals_bf16b", (97, 61, 40), (32, 8), 0.2, None, f32, bf16, "high"),
        ("empty_rowblock_128x128_fp32_high", (300, 260, 200), (128, 128), 0.05,
         (128, 256), f32, f32, "high"),
        ("empty_rowblock_8x16_fp32_highest", (64, 48, 17), (8, 16), 0.3,
         (16, 40), f32, f32, "highest"),
        ("mlp_fc1_128x128_fp32_high", (256, 784, 32), (128, 128), 0.1, None, f32, f32, "high"),
        ("mlp_fc1_128x128_bf16_default", (256, 784, 32), (128, 128), 0.1, None,
         bf16, bf16, "default"),
    ]
    for seed, (name, (m, k, n), bs, dens, empty, vdt, bdt, prec) in enumerate(cases):
        a_np, rng = _dense_case(seed, m, k, dens, empty)
        a = tt.CSR.from_dense(a_np, device="cuda")
        plan = tt.build_plan(a, bs)
        bv = plan.pack_values(a.data.to(vdt))
        b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to("cuda", bdt)
        out_t = tiled_spmm_kernel(plan, bv, b, precision=prec)
        out_r = resident_spmm_kernel(plan, bv, b, precision=prec)
        ref = _block_exec_plain(plan, bv, b, precision=prec)
        torch.cuda.synchronize()
        if not torch.equal(out_t, out_r):
            raise AssertionError(f"{name}: tiled and resident entry points differ")
        if out_t.dtype != ref.dtype or out_t.shape != (m, n):
            raise AssertionError(f"{name}: got {out_t.dtype} {tuple(out_t.shape)}")
        _check_case(name, out_t, ref, ", entry points bitwise equal")


def phase_small_sddmm() -> None:
    import tpusparse_torch as tt
    from tpusparse_torch.kernels.sddmm import _sddmm_plain, sddmm_kernel

    f32, bf16 = torch.float32, torch.bfloat16
    # name, (m, k, n), blocksize, density, empty rows, dtype, precision
    cases = [
        ("sddmm_ragged_8x16_fp32_high", (100, 70, 33), (8, 16), 0.15, None, f32, "high"),
        ("sddmm_ragged_32x8_fp32_highest", (97, 61, 130), (32, 8), 0.2, None, f32, "highest"),
        ("sddmm_ragged_32x8_fp32_default", (100, 70, 65), (32, 8), 0.15, None, f32, "default"),
        ("sddmm_ragged_8x16_bf16_high", (100, 70, 40), (8, 16), 0.15, None, bf16, "high"),
        ("sddmm_empty_rowblock_128x128_fp32_high", (300, 260, 200), (128, 128), 0.05,
         (128, 256), f32, "high"),
        ("sddmm_empty_rowblock_8x16_fp32_high", (64, 48, 17), (8, 16), 0.3,
         (16, 40), f32, "high"),
        ("sddmm_mlp_fc1_128x128_fp32_high", (256, 784, 32), (128, 128), 0.1, None, f32, "high"),
    ]
    for seed, (name, (m, k, n), bs, dens, empty, dt, prec) in enumerate(cases):
        a_np, rng = _dense_case(100 + seed, m, k, dens, empty)
        plan = tt.build_plan(tt.CSR.from_dense(a_np, device="cuda"), bs)
        dc = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to("cuda", dt)
        b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to("cuda", dt)
        got = sddmm_kernel(plan, dc, b, precision=prec)
        ref = _sddmm_plain(plan, dc, b, precision=prec)
        torch.cuda.synchronize()
        if got.dtype != dt or got.shape != (plan.num_slots, *bs):
            raise AssertionError(f"{name}: got {got.dtype} {tuple(got.shape)}")
        pad = ~plan.slot_valid_mask("cuda").bool().reshape(-1)
        if int(torch.count_nonzero(got[pad])) != 0:
            raise AssertionError(f"{name}: pad slots are not exactly 0")
        _check_case(name, got, ref, f", {int(pad.sum())} pad slots exactly 0")


def phase_small_gemm() -> None:
    from tpusparse_torch.kernels.gemm import _gemm_plain, gemm_kernel

    m, n, k = 100, 70, 33
    rng = np.random.default_rng(200)
    for dt, prec in ((torch.float32, "high"), (torch.float32, "default"),
                     (torch.bfloat16, "high")):
        for transa, transb in ((False, False), (True, False), (False, True), (True, True)):
            a = rng.standard_normal((k, m) if transa else (m, k)).astype(np.float32)
            b = rng.standard_normal((n, k) if transb else (k, n)).astype(np.float32)
            a = torch.from_numpy(a).to("cuda", dt)
            b = torch.from_numpy(b).to("cuda", dt)
            got = gemm_kernel(a, b, transa=transa, transb=transb, precision=prec)
            ref = _gemm_plain(a, b, transa=transa, transb=transb, precision=prec)
            torch.cuda.synchronize()
            if got.dtype != dt or got.shape != (m, n):
                raise AssertionError(f"gemm: got {got.dtype} {tuple(got.shape)}")
            name = (f"gemm_{m}x{n}x{k}_ta{int(transa)}_tb{int(transb)}_"
                    f"{str(dt).split('.')[1]}_{prec}")
            _check_case(name, got, ref)


def _mnist_batches():
    from tpusparse_torch.utils.data import batches, synthetic_mnist

    tx, ty, _, _ = synthetic_mnist(n_train=1024, n_test=64)
    out = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches(tx, ty, 32, seed=0)]
    return out[:TRAIN_STEPS]


def _net(variant, device, seed=0):
    import tpusparse_torch as tt

    return tt.MnistNet(variant, hidden=256, device=device,
                       generator=torch.Generator().manual_seed(seed))


def phase_train(batches) -> dict:
    """The training main path: TRAIN_STEPS SGD steps per variant on the
    card, with the launches of every step checked; then the first
    PARITY_STEPS steps again on the CPU from the same weights."""
    import tpusparse_torch as tt
    from tpusparse_torch import kernels

    totals = {"block_ell_spmm": 0, "sddmm": 0, "gemm": 0, **NO_FLASH}
    for variant, expect in STEP_LAUNCHES.items():
        tt.set_config(use_gemm_kernel=variant == "dense")
        try:
            net = _net(variant, "cuda")
            opt = tt.make_train_state(net)
            torch.cuda.synchronize()
            losses, snapshot = [], None
            kernels.reset_launch_counts()
            for i, (x, y) in enumerate(batches):
                before = kernels.launches_by_kernel()
                losses.append(tt.train_step(net, opt, x.cuda(), y.cuda()))
                after = kernels.launches_by_kernel()
                step = {kk: after[kk] - before[kk] for kk in after}
                if step != expect:
                    raise AssertionError(f"train {variant} step {i}: launches {step}, "
                                         f"expected {expect}")
                if i + 1 == PARITY_STEPS:
                    snapshot = {n_: p.detach().cpu().clone() for n_, p in net.named_parameters()}
            torch.cuda.synchronize()
            counts = kernels.launches_by_kernel()
            losses = [float(v) for v in losses]
            cpu = _net(variant, "cpu")
            cpu_opt = tt.make_train_state(cpu)
            cpu_losses = [float(tt.train_step(cpu, cpu_opt, x, y))
                          for x, y in batches[:PARITY_STEPS]]
        finally:
            tt.set_config(use_gemm_kernel=False)
        for kk in totals:
            totals[kk] += counts[kk]
        print(f"train {variant}: {TRAIN_STEPS} steps, launches {json.dumps(counts)} "
              f"({json.dumps(expect)} per step), loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        if not (all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0]):
            raise AssertionError(f"train {variant}: loss did not drop: {losses}")
        np.testing.assert_allclose(losses[:PARITY_STEPS], cpu_losses, **TOL_FP32)
        err = 0.0
        for n_, p in cpu.named_parameters():
            torch.testing.assert_close(snapshot[n_], p.detach(), **TOL_FP32, msg=n_)
            err = max(err, float((snapshot[n_] - p.detach()).abs().max()))
        print(f"train {variant}: card vs CPU over {PARITY_STEPS} steps: losses within "
              f"tolerance, params max_abs_err {err:.3e} (ok)")
    return totals


def phase_headline_backward(plan, bv, b):
    """dblocks and dB of the headline SpMM for a seeded dC, counted."""
    import tpusparse_torch as tt
    from tpusparse_torch import kernels
    from tpusparse_torch.kernels.sddmm import _sddmm_plain
    from tpusparse_torch.kernels.tiled_spmm import _block_exec_plain

    m, k = plan.shape
    n = b.shape[1]
    dc = torch.from_numpy(
        np.random.default_rng(11).standard_normal((m, n), dtype=np.float32)).cuda()
    blocks = bv.clone().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tt.spmm_blocks(plan, blocks, bb).backward(dc)
    torch.cuda.synchronize()
    counts = kernels.launches_by_kernel()
    print(f"headline backward launches: {json.dumps(counts)}")
    if counts != {**NO_LAUNCH, "block_ell_spmm": 2, "sddmm": 1}:
        raise AssertionError("headline backward: expected 2 block_ell_spmm and 1 sddmm")
    dblocks_ref = _sddmm_plain(plan, dc, b)
    d_err, d_rel = over_scale(blocks.grad, dblocks_ref)
    del dblocks_ref
    plan_t, t_slot_perm = tt.block_transpose_plan(plan)
    bm, bk = plan.blocksize
    ext = torch.cat([bv.transpose(1, 2), bv.new_zeros((1, bk, bm))])
    bv_t = ext[plan_t.perm_tensor("t_slot_perm", t_slot_perm, "cuda")].contiguous()
    del ext
    db_err, db_rel = over_scale(bb.grad, _block_exec_plain(plan_t, bv_t, dc))
    print(f"headline dblocks: max_abs_err {d_err:.3e}, over scale {d_rel:.3e}; "
          f"dB: max_abs_err {db_err:.3e}, over scale {db_rel:.3e}")
    if not (d_rel <= HEADLINE_TOL and db_rel <= HEADLINE_TOL
            and bool(torch.isfinite(blocks.grad).all()) and bool(torch.isfinite(bb.grad).all())):
        raise AssertionError("headline backward disagrees with its plain versions")
    return counts, d_err, dc, plan_t, bv_t


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max-abs error, max-abs error / max |want|)."""
    max_abs = float((got.float() - want.float()).abs().max())
    return max_abs, max_abs / max(float(want.float().abs().max()), 1e-30)


def _flash_pair(q, k, v, do, kw):
    """(kernel, plain) results (o, lse, dq, dk, dv) on the same inputs; the
    plain backward takes the kernel's lse and delta."""
    from tpusparse_torch.kernels import flash_attention as fa

    o, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).to(q.dtype).float()
    got = (o, lse, fa.flash_dq_kernel(q, k, v, do, lse, delta, **kw),
           *fa.flash_dkv_kernel(q, k, v, do, lse, delta, **kw))
    want = (*fa._flash_fwd_plain(q, k, v, **kw),
            fa._flash_dq_plain(q, k, v, do, lse, delta, **kw),
            *fa._flash_dkv_plain(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    return got, want


def _flash_operands(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)
            for _ in range(4)]


def phase_small_flash() -> None:
    """Each flash kernel against its plain version at small shapes, in both
    tiers, with fp32 and with bf16 inputs."""
    # name, (bh, s, d), causal, q_offset; the last is rows 256:512 of a
    # 512-long causal attention against keys 0:256 (tests/test_attention.py:290)
    cases = [
        ("2x3x256x64", (6, 256, 64), False, 0),
        ("causal_1x2x384x64", (2, 384, 64), True, 0),
        ("ragged_1x1x200x64", (1, 200, 64), False, 0),
        ("narrow_2x4x128x24", (8, 128, 24), False, 0),
        ("wide_1x2x128x128", (2, 128, 128), True, 0),
        ("offsets_1x1x256x64_q256", (1, 256, 64), True, 256),
    ]
    for seed, (name, shape, causal, q_off) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            for prec in ("high", "default"):
                q, k, v, do = _flash_operands(shape, 300 + seed, dtype)
                kw = dict(sm_scale=1 / shape[-1] ** 0.5, causal=causal, q_offset=q_off,
                          kv_offset=0, precision=prec)
                got, want = _flash_pair(q, k, v, do, kw)
                _check_attention_case(f"flash_{name}_{str(dtype).split('.')[1]}_{prec}",
                                      got, want, dtype == torch.bfloat16 or prec == "default")


def _check_attention_case(label, got, want, rounded, extra="") -> None:
    """Kernel results (o, lse, dq, dk, dv) against the plain version's, each
    as max-abs error over scale: lse within FLASH_LIMIT_FP32 always, the
    rest within FLASH_LIMIT_ROUNDED where the tier rounds to bf16."""
    names = ("o", "lse", "dq", "dk", "dv")
    limit = FLASH_LIMIT_ROUNDED if rounded else FLASH_LIMIT_FP32
    errs = {n: rel_err(g, w)[1] for n, g, w in zip(names, got, want)}
    ok = (all(e <= (FLASH_LIMIT_FP32 if n == "lse" else limit) for n, e in errs.items())
          and all(bool(torch.isfinite(g.float()).all()) for g in got)
          and all(g.dtype == w.dtype and g.shape == w.shape for g, w in zip(got, want)))
    print(f"case {label}: over scale " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" (limit {limit:.0e}, lse {FLASH_LIMIT_FP32:.0e}){extra}, "
          + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"{label}: a kernel disagrees with its plain version")


def _blk_pair(q, k, v, do, plan, kw):
    """(kernel, plain) results (o, lse, dq, dk, dv) of the block-pattern
    attention on the same inputs; the plain backward takes the kernel's lse
    and delta."""
    from tpusparse_torch.kernels import block_flash_attention as bfa

    o, lse = bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw)
    delta = _delta(do, o)
    got = (o, lse, bfa.blk_flash_dq_kernel(q, k, v, do, lse, delta, plan, **kw),
           *bfa.blk_flash_dkv_kernel(q, k, v, do, lse, delta, plan, **kw))
    want = (*bfa._blk_fwd_plain(q, k, v, plan, **kw),
            bfa._blk_dq_plain(q, k, v, do, lse, delta, plan, **kw),
            *bfa._blk_dkv_plain(q, k, v, do, lse, delta, plan, **kw))
    torch.cuda.synchronize()
    return got, want


def _blk_plan(name):
    """The small cases' plans: 'bigbird' block masks and a block mask at an
    unpadded seq (mask-free), band token patterns (token-exact tile masks)
    at blocks 64, 64x32, 128x256 and 256 with s on and off the block, and
    the 'sparse' layer's plan at seq 4096 (what its router builds)."""
    import tpusparse_torch as tt

    if name == "bigbird_512_b64":
        return tt.BlockAttnPlan(tt.bigbird_block_mask(512, 64), 64, 64, 512)
    if name == "bigbird_256_b32":
        return tt.BlockAttnPlan(tt.bigbird_block_mask(256, 32, 3, 1, 1), 32, 32, 256)
    if name == "maskfree_unpadded_160_b64":
        mask = np.array([[1, 0, 1], [0, 1, 0], [1, 0, 1]], bool)
        return tt.BlockAttnPlan(mask, 64, 64, 160)
    s, bq, bk, window, glob = {
        "band_masked_256_b64": (256, 64, 64, 20, 3),
        "band_masked_unpadded_160_b64x32": (160, 64, 32, 20, 3),
        "band_masked_512_b128x256": (512, 128, 256, 40, 2),
        "band_masked_unpadded_1000_b256": (1000, 256, 256, 64, 0),
        "sparse_layer_4096_b256": (LONG_SEQ, 256, 256, PATTERN_WINDOW, 0),
    }[name]
    ind, ptr = tt.local_global_pattern(s, window, glob)
    return tt.BlockAttnPlan.from_token_pattern(ind, ptr, s, bq, bk)


# name: (bh, d)
BLK_SMALL_CASES = {
    "bigbird_512_b64": (4, 64),
    "bigbird_256_b32": (2, 128),
    "maskfree_unpadded_160_b64": (3, 40),
    "band_masked_256_b64": (3, 64),
    "band_masked_unpadded_160_b64x32": (2, 24),
    "band_masked_512_b128x256": (2, 128),
    "band_masked_unpadded_1000_b256": (2, 64),
    "sparse_layer_4096_b256": (2, 64),
}


def phase_small_block_flash() -> None:
    """Each block-pattern kernel against its plain version on every kind of
    plan, in fp32 'high' and 'default' and with bf16 inputs; dq, dk and dv
    of the fp32 'high' run repeated and required bitwise equal."""
    from tpusparse_torch.kernels import block_flash_attention as bfa

    for seed, (name, (bh, d)) in enumerate(BLK_SMALL_CASES.items()):
        plan = _blk_plan(name)
        kind = "masked" if plan.tile_masks is not None else "mask-free"
        for dtype, prec in ((torch.float32, "high"), (torch.float32, "default"),
                            (torch.bfloat16, "high")):
            q, k, v, do = _flash_operands((bh, plan.seq, d), 700 + seed, dtype)
            kw = dict(sm_scale=1 / d ** 0.5, precision=prec)
            got, want = _blk_pair(q, k, v, do, plan, kw)
            extra = ""
            if dtype == torch.float32 and prec == "high":
                lse, delta = got[1], _delta(do, got[0])
                again = (bfa.blk_flash_dq_kernel(q, k, v, do, lse, delta, plan, **kw),
                         *bfa.blk_flash_dkv_kernel(q, k, v, do, lse, delta, plan, **kw))
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got[2:], again)):
                    raise AssertionError(f"blk_{name}: dq, dk, dv do not repeat bit for bit")
                extra = ", dq/dk/dv repeat bitwise"
            _check_attention_case(
                f"blk_{name}_{kind}_L{plan.L}_{str(dtype).split('.')[1]}_{prec}", got, want,
                dtype == torch.bfloat16 or prec == "default", extra)


def _delta(do, o):
    return (do.float() * o.float()).sum(-1).to(do.dtype).float()


def _bert_input(batch, seq, seed):
    x = np.random.default_rng(seed).standard_normal((batch, seq, BERT["hidden"]), dtype=np.float32)
    return torch.from_numpy(x)


def _bert_layer(attention, device, seed=0, window=PATTERN_WINDOW):
    import tpusparse_torch as tt

    return tt.BertAttentionLayer(**BERT, attention=attention, window=window, device=device,
                                 generator=torch.Generator().manual_seed(seed))


def _launches() -> dict:
    from tpusparse_torch import kernels

    return kernels.launches_by_kernel()


def _only(counts, names) -> dict:
    return {n: counts[n] for n in names}


def _drive(label, model, inp, steps, path=(), layers=1, must_drop=False):
    """A forward and `steps` SGD steps of `model` on `inp`, with the launch
    counts set to 0 just before and read just after. `path` names the
    path's (forward, dq, dk/dv) kernels: the forward must launch the first
    `layers` times and each step each of them `layers` times, and no other
    kernel may launch. Prints and returns (counts, losses)."""
    import tpusparse_torch as tt
    from tpusparse_torch import kernels

    fwd_expect = {**NO_LAUNCH, **{n: layers for n in path[:1]}}
    step_expect = {**NO_LAUNCH, **{n: layers for n in path}}
    opt = tt.make_train_state(model)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = model(inp)
    torch.cuda.synchronize()
    if _launches() != fwd_expect:
        raise AssertionError(f"{label}: forward launched {_launches()}")
    if out.shape != (*inp.shape[:2], BERT["hidden"]) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: bad forward output {tuple(out.shape)}")
    losses = []
    for i in range(steps):
        before = _launches()
        losses.append(tt.bert_train_step(model, opt, inp))
        after = _launches()
        step = {n: after[n] - before[n] for n in after}
        if step != step_expect:
            raise AssertionError(f"{label} step {i}: launches {step}, expected {step_expect}")
    torch.cuda.synchronize()
    counts = _launches()
    losses = [float(v) for v in losses]
    print(f"{label}: forward + {steps} steps, launches "
          f"{json.dumps(_only(counts, path)) if path else 'none'}, losses "
          + ", ".join(f"{v:.6f}" for v in losses))
    if not all(np.isfinite(losses)) or (must_drop and not losses[-1] < losses[0]):
        raise AssertionError(f"{label}: loss not finite or did not drop: {losses}")
    return counts, losses


def phase_bert_layers() -> dict:
    """The BERT-base layer, 'flash' and 'dense', batch 8 at each seq: a
    forward and BERT_LAYER_STEPS SGD steps, launches checked per call;
    returns the flash launches counted."""
    totals = dict(NO_FLASH)
    for seq in BERT_SEQS:
        x = _bert_input(BERT_BATCH, seq, 40 + seq).cuda()
        for attention in ("flash", "dense"):
            counts, _ = _drive(f"bert layer {attention} seq {seq} batch {BERT_BATCH}",
                               _bert_layer(attention, "cuda"), x, BERT_LAYER_STEPS,
                               FLASH if attention == "flash" else (), must_drop=True)
            for n in totals:
                totals[n] += counts[n]
    return totals


def phase_bert_encoder(attention):
    """BertEncoder(attention) ('flash' or 'bigbird') at full size, batch 8,
    seq 512: a forward and BERT_ENCODER_STEPS SGD steps, each layer
    launching its attention kernels; returns (launches, encoder,
    input_ids)."""
    import tpusparse_torch as tt

    enc = tt.BertEncoder(attention=attention, window=PATTERN_WINDOW, device="cuda",
                         generator=torch.Generator().manual_seed(1))
    ids = torch.from_numpy(np.random.default_rng(12).integers(
        0, 30522, size=(BERT_BATCH, 512))).cuda()
    counts, _ = _drive(
        f"bert encoder {attention} ({enc.num_layers} layers, batch {BERT_BATCH}, seq 512)",
        enc, ids, BERT_ENCODER_STEPS, FLASH if attention == "flash" else BLK, enc.num_layers)
    return counts, enc, ids


def phase_bert_card_vs_cpu(attention="flash", seq=128, method=None) -> None:
    """One full-width layer at batch 1 from one seed, on the card and on the
    CPU: the forward, then PARITY_STEPS steps' losses and parameters.
    `method` forces the engine of a 'sparse' layer."""
    import tpusparse_torch as tt

    x = _bert_input(1, seq, 7)
    layers = {d: _bert_layer(attention, d, seed=2) for d in ("cuda", "cpu")}
    if method is not None:
        for layer in layers.values():
            layer.attention.method = method
    label = f"bert layer {attention}{' (' + method + ')' if method else ''}"
    with torch.no_grad():
        got, want = layers["cuda"](x.cuda()).cpu(), layers["cpu"](x)
    fwd_err = float((got - want).abs().max())
    if not torch.allclose(got, want, **TOL_FP32):
        raise AssertionError(f"{label} card vs CPU forward: max_abs_err {fwd_err:.3e}")
    opts = {d: tt.make_train_state(m) for d, m in layers.items()}
    losses = {d: [float(tt.bert_train_step(layers[d], opts[d], x.to(d)))
                  for _ in range(PARITY_STEPS)] for d in layers}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], **TOL_FP32)
    err = 0.0
    for (n_, p), (_, q) in zip(layers["cuda"].named_parameters(), layers["cpu"].named_parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), **TOL_FP32, msg=n_)
        err = max(err, float((p.detach().cpu() - q.detach()).abs().max()))
    print(f"{label} card vs CPU (batch 1, seq {seq}): forward max_abs_err "
          f"{fwd_err:.3e}; {PARITY_STEPS} steps' losses within tolerance, params "
          f"max_abs_err {err:.3e} (ok)")


def _sdpa_backend(q, k, v, attn_mask=None):
    """The first SDPA backend, in the order flash, efficient, cudnn, math,
    that takes these fp32 inputs (and this mask)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
            return backend
        except RuntimeError:
            continue
    raise AssertionError("no SDPA backend takes fp32 inputs")


def phase_flash_timings() -> dict:
    """The three kernels, their plain versions and bounds, and SDPA in fp32,
    at the BERT-base attention shapes; returns {seq: results}."""
    from torch.nn.attention import sdpa_kernel

    from tpusparse_torch.kernels import flash_attention as fa
    from tpusparse_torch.utils.config import fp32_matmul

    out = {}
    b, h, d = BERT_BATCH, BERT["num_heads"], BERT["hidden"] // BERT["num_heads"]
    for seq in sorted(BERT_SEQS, reverse=True):
        bh = b * h
        q, k, v, do = _flash_operands((bh, seq, d), 500 + seq)
        kw = dict(sm_scale=1 / d ** 0.5, causal=False, precision="high")
        got, want = _flash_pair(q, k, v, do, kw)
        errs = {n: rel_err(g, w) for n, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want)}
        if not all(e[1] <= FLASH_LIMIT_FP32 for e in errs.values()):
            raise AssertionError(f"flash at seq {seq}: kernel vs plain {errs}")
        o, lse = got[0], got[1]
        delta = (do * o).sum(-1)
        del got, want
        r = {"err": errs}
        r["ms"] = {
            "fwd": time_ms_queued(lambda: fa.flash_fwd_kernel(q, k, v, **kw)),
            "dq": time_ms_queued(lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, **kw)),
            "dkv": time_ms_queued(lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, **kw)),
        }
        r["one_call_ms"] = {
            "fwd": time_ms(lambda: fa.flash_fwd_kernel(q, k, v, **kw)),
            "dq": time_ms(lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, **kw)),
            "dkv": time_ms(lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, **kw)),
        }
        r["plain_ms"] = {
            "fwd": time_ms_queued(lambda: fa._flash_fwd_plain(q, k, v, **kw)),
            "dq": time_ms_queued(lambda: fa._flash_dq_plain(q, k, v, do, lse, delta, **kw)),
            "dkv": time_ms_queued(
                lambda: fa._flash_dkv_plain(q, k, v, do, lse, delta, **kw)),
        }
        qkv_bytes = 4.0 * bh * seq * d
        stat_bytes = 4.0 * bh * seq
        # flops: q.k^T and p.v (fwd); + do.v^T and dS.k (dq); q.k^T, do.v^T,
        # p^T.do, dS^T.q (dk/dv); bytes: each input read once, each output
        # written once
        work = {
            "fwd": (4.0 * bh * seq * seq * d, 4 * qkv_bytes + stat_bytes),
            "dq": (6.0 * bh * seq * seq * d, 5 * qkv_bytes + 2 * stat_bytes),
            "dkv": (8.0 * bh * seq * seq * d, 6 * qkv_bytes + 2 * stat_bytes),
        }
        r["bound"] = {kname: bound(*wk) for kname, wk in work.items()}
        q4, k4, v4, do4 = (t.view(b, h, seq, d) for t in (q, k, v, do))
        backend = _sdpa_backend(q4, k4, v4)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with sdpa_kernel([backend]), fp32_matmul():
            r["sdpa_fwd_ms"] = time_ms_queued(lambda: sdpa(q4, k4, v4))
            lib_err = rel_err(sdpa(q4, k4, v4).reshape(bh, seq, d), o)[1]
            qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
            og = sdpa(qg, kg, vg)
            r["sdpa_bwd_ms"] = time_ms_queued(
                lambda: torch.autograd.grad(og, (qg, kg, vg), do4, retain_graph=True))
        r["sdpa_backend"] = backend.name
        out[seq] = r
        for kname in ("fwd", "dq", "dkv"):
            bms, by = r["bound"][kname]
            flops = work[kname][0]
            print(f"flash_{kname} ({b}, {h}, {seq}, {d}) fp32 'high': kernel "
                  f"{r['ms'][kname]:.4f} ms queued ({r['one_call_ms'][kname]:.4f} ms one "
                  f"call), plain {r['plain_ms'][kname]:.4f} ms, bound "
                  f"{bms:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP, "
                  f"{work[kname][1] / 1e6:.1f} MB), kernel at "
                  f"{flops / (r['ms'][kname] * 1e-3) / 1e12:.2f} TFLOP/s")
        print(f"flash ({b}, {h}, {seq}, {d}): kernel vs plain over scale " + ", ".join(
            f"{n} {e[1]:.2e}" for n, e in errs.items()))
        print(f"sdpa ({b}, {h}, {seq}, {d}) fp32, backend {backend.name}: forward "
              f"{r['sdpa_fwd_ms']:.4f} ms (vs kernel o {lib_err:.2e} of scale), autograd "
              f"backward (dq, dk, dv) {r['sdpa_bwd_ms']:.4f} ms")
        del q, k, v, do, q4, k4, v4, do4, qg, kg, vg, og
    return out


def phase_bert_profile(seq: int = 512, steps: int = 3) -> None:
    """Where a layer's training step spends the card's time: torch.profiler
    over `steps` steps of each variant at batch 8; prints the device's busy
    and idle share of the span from the first to the last kernel, and the
    kernels that take the most time."""
    import tpusparse_torch as tt
    from torch.profiler import ProfilerActivity, profile

    x = _bert_input(BERT_BATCH, seq, 40 + seq).cuda()
    for attention in ("flash", "dense", "bigbird"):
        layer = _bert_layer(attention, "cuda")
        opt = tt.make_train_state(layer)
        for _ in range(2):
            tt.bert_train_step(layer, opt, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                tt.bert_train_step(layer, opt, x)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            print(f"profile bert layer {attention} seq {seq}: no device time recorded")
            continue
        busy = sum(e.time_range.end - e.time_range.start for e in kernels)
        span = (max(e.time_range.end for e in kernels)
                - min(e.time_range.start for e in kernels))
        print(f"profile bert layer {attention} seq {seq} batch {BERT_BATCH}, {steps} steps: "
              f"{len(kernels)} kernels, device busy {busy / 1e3 / steps:.4f} ms per step "
              f"of a {span / 1e3 / steps:.4f} ms span, idle share {1 - busy / span:.3f}")
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
        for name_, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {t / 1e3 / steps:.4f} ms/step ({t / busy:.1%}) {name_[:90]}")


def phase_pattern_paths():
    """The pattern variants' main path (4f, 4g), each part counted on its
    own; returns (block kernel launches summed over the runs, the 'bigbird'
    encoder, its input_ids)."""
    totals = dict(NO_BLK)

    def tally(counts):
        for n in totals:
            totals[n] += counts[n]

    x = _bert_input(BERT_BATCH, 512, 60).cuda()
    tally(_drive(f"bert layer bigbird seq 512 batch {BERT_BATCH}", _bert_layer("bigbird", "cuda"),
                 x, BERT_LAYER_STEPS, BLK, must_drop=True)[0])
    counts, enc, ids = phase_bert_encoder("bigbird")
    tally(counts)

    x = _bert_input(LONG_BATCH, LONG_SEQ, 61).cuda()
    for variant, window in LONG_GRID:
        layer = _bert_layer(variant, "cuda", window=window)
        label = f"bert layer {variant} window {window} seq {LONG_SEQ} batch {LONG_BATCH}"
        tally(_drive(label, layer, x, LONG_STEPS, () if variant == "local" else BLK)[0])
        if variant == "sparse":
            method, plan, _, _ = layer.attention.engine(LONG_SEQ)
            if method != "blockflash" or plan.tile_masks is None:
                raise AssertionError(f"{label}: routed to {method}, not masked blockflash")
            print(f"{label}: routed to blockflash (block {plan.block_q}, {plan.covered_tiles} "
                  f"covered tiles of {plan.nq * plan.nk}, token-exact masks)")
        del layer

    x = _bert_input(BERT_BATCH, 512, 62).cuda()
    for variant in ("sparse", "local"):
        layer = _bert_layer(variant, "cuda")
        label = f"bert layer {variant} window {PATTERN_WINDOW} seq 512 batch {BERT_BATCH}"
        _drive(label, layer, x, ROUTE_STEPS)
        if variant == "sparse":
            method = layer.attention.engine(512)[0]
            if method != "dense":
                raise AssertionError(f"{label}: routed to {method}, not dense")
            print(f"{label}: routed to dense")
    return totals, enc, ids


def phase_block_flash_timings() -> dict:
    """The three block kernels at the 'bigbird' layer's shapes (seq 512,
    block 64; seq 4096, block 256) and at the 'sparse' layer's masked
    seq-4096 plan: kernel vs plain (<= 1e-5 of scale), times, bounds from the
    covered tiles, and SDPA with the token-exact boolean mask in fp32;
    returns {label: results}."""
    from torch.nn.attention import sdpa_kernel

    import tpusparse_torch as tt
    from tpusparse_torch.kernels import block_flash_attention as bfa
    from tpusparse_torch.utils.config import fp32_matmul

    h, d = BERT["num_heads"], BERT["hidden"] // BERT["num_heads"]
    shapes = {
        "bigbird_512": (BERT_BATCH, 512, tt.BlockAttnPlan(
            tt.bigbird_block_mask(512, PATTERN_WINDOW), PATTERN_WINDOW, PATTERN_WINDOW, 512)),
        "bigbird_4096": (LONG_BATCH, LONG_SEQ, tt.BlockAttnPlan(
            tt.bigbird_block_mask(LONG_SEQ, 256), 256, 256, LONG_SEQ)),
        "sparse_4096": (LONG_BATCH, LONG_SEQ, _blk_plan("sparse_layer_4096_b256")),
    }
    out = {}
    for label, (b, seq, plan) in shapes.items():
        bh = b * h
        q, k, v, do = _flash_operands((bh, seq, d), 800 + seq)
        kw = dict(sm_scale=1 / d ** 0.5, precision="high")
        got, want = _blk_pair(q, k, v, do, plan, kw)
        errs = {n: rel_err(g, w) for n, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want)}
        if not all(e[1] <= FLASH_LIMIT_FP32 for e in errs.values()):
            raise AssertionError(f"block flash {label}: kernel vs plain {errs}")
        o, lse = got[0], got[1]
        delta = _delta(do, o)
        del got, want
        fns = {
            "fwd": (lambda: bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw),
                    lambda: bfa._blk_fwd_plain(q, k, v, plan, **kw)),
            "dq": (lambda: bfa.blk_flash_dq_kernel(q, k, v, do, lse, delta, plan, **kw),
                   lambda: bfa._blk_dq_plain(q, k, v, do, lse, delta, plan, **kw)),
            "dkv": (lambda: bfa.blk_flash_dkv_kernel(q, k, v, do, lse, delta, plan, **kw),
                    lambda: bfa._blk_dkv_plain(q, k, v, do, lse, delta, plan, **kw)),
        }
        r = {"err": errs, "tiles": plan.covered_tiles, "masked": plan.tile_masks is not None}
        r["ms"] = {n: time_ms_queued(f[0]) for n, f in fns.items()}
        r["one_call_ms"] = {n: time_ms(f[0]) for n, f in fns.items()}
        r["plain_ms"] = {n: time_ms_queued(f[1], reps=5) for n, f in fns.items()}
        # work of the covered tiles: q.k^T and p.v (fwd); + do.v^T and dS.k
        # (dq); q.k^T, do.v^T, p^T.do, dS^T.q (dk/dv). Bytes: each input read
        # once, each output written once, the plan's lists and masks included.
        entries = float(bh * plan.covered_tiles * plan.block_q * plan.block_k)
        qkv_bytes, stat_bytes = 4.0 * bh * seq * d, 4.0 * bh * seq
        masks = 0 if plan.tile_masks is None else plan.tile_masks.nbytes + plan.q_slot.nbytes
        fwd_plan = plan.kv_list.nbytes + plan.kv_cnt.nbytes + masks
        bwd_plan = plan.q_list.nbytes + plan.q_cnt.nbytes + masks
        work = {
            "fwd": (4.0 * entries * d, 4 * qkv_bytes + stat_bytes + fwd_plan),
            "dq": (6.0 * entries * d, 5 * qkv_bytes + 2 * stat_bytes + fwd_plan),
            "dkv": (8.0 * entries * d, 6 * qkv_bytes + 2 * stat_bytes + bwd_plan),
        }
        r["bound"] = {n: bound(*wk) for n, wk in work.items()}
        q4, k4, v4, do4 = (t.view(b, h, seq, d) for t in (q, k, v, do))
        mask = plan.token_mask(q.device)
        backend = _sdpa_backend(q4, k4, v4, mask)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with sdpa_kernel([backend]), fp32_matmul():
            r["sdpa_fwd_ms"] = time_ms_queued(lambda: sdpa(q4, k4, v4, attn_mask=mask))
            lib_err = rel_err(sdpa(q4, k4, v4, attn_mask=mask).reshape(bh, seq, d), o)[1]
            qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
            og = sdpa(qg, kg, vg, attn_mask=mask)
            r["sdpa_bwd_ms"] = time_ms_queued(
                lambda: torch.autograd.grad(og, (qg, kg, vg), do4, retain_graph=True))
        r["sdpa_backend"] = backend.name
        out[label] = r
        shape = (f"{label} (bh {bh}, seq {seq}, d {d}, block {plan.block_q}, "
                 f"{plan.covered_tiles} of {plan.nq * plan.nk} tiles"
                 f"{', token-exact masks' if r['masked'] else ''})")
        for n in fns:
            bms, by = r["bound"][n]
            flops = work[n][0]
            print(f"blk_flash_{n} {shape} fp32 'high': kernel {r['ms'][n]:.4f} ms queued "
                  f"({r['one_call_ms'][n]:.4f} ms one call), plain {r['plain_ms'][n]:.4f} ms, "
                  f"bound {bms:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP, "
                  f"{work[n][1] / 1e6:.1f} MB), kernel at "
                  f"{flops / (r['ms'][n] * 1e-3) / 1e12:.2f} TFLOP/s")
        print(f"blk_flash {label}: kernel vs plain over scale " + ", ".join(
            f"{n} {e[1]:.2e}" for n, e in errs.items()))
        print(f"sdpa {label} with the token mask, fp32, backend {backend.name}: forward "
              f"{r['sdpa_fwd_ms']:.4f} ms (vs kernel o {lib_err:.2e} of scale), autograd "
              f"backward (dq, dk, dv) {r['sdpa_bwd_ms']:.4f} ms")
        del q, k, v, do, q4, k4, v4, do4, qg, kg, vg, og, o, lse, delta, fns
    return out


def phase_bert_timings(encoders) -> None:
    """Forward and step times by CUDA events: the layer in each variant and
    shape the main path drives, the seq-512 variants' steps queued in turns,
    and the encoders ({attention: (encoder, input_ids)})."""
    import tpusparse_torch as tt

    cases = [(v, BERT_BATCH, seq, PATTERN_WINDOW) for seq in BERT_SEQS for v in ("flash", "dense")]
    cases += [(v, BERT_BATCH, 512, PATTERN_WINDOW) for v in ("bigbird", "sparse", "local")]
    cases += [(v, LONG_BATCH, LONG_SEQ, w) for v, w in LONG_GRID]
    for variant, batch, seq, window in cases:
        x = _bert_input(batch, seq, 40 + seq).cuda()
        layer = _bert_layer(variant, "cuda", window=window)
        opt = tt.make_train_state(layer)
        with torch.no_grad():
            fwd_ms = time_ms(lambda: layer(x))
        step_ms = time_ms(lambda: tt.bert_train_step(layer, opt, x))
        name = variant if variant in ("flash", "dense") else f"{variant} window {window}"
        print(f"bert layer {name} seq {seq} batch {batch}: forward {fwd_ms:.4f} ms, train step "
              f"{step_ms:.4f} ms")
        del layer, opt, x
    # one call between two events exposes the host's latency; steps queued
    # back to back give the card's pace. The seq-512 variants in turns,
    # in order and then reversed, so drift hits them alike.
    x = _bert_input(BERT_BATCH, 512, 572).cuda()
    layers = {}
    for variant in ("flash", "bigbird", "sparse", "local", "dense"):
        layer = _bert_layer(variant, "cuda")
        layers[variant] = (layer, tt.make_train_state(layer))
    queued = {v: [] for v in layers}
    for variant in [*layers, *reversed(layers)]:
        layer, opt = layers[variant]
        queued[variant].append(time_ms_queued(lambda: tt.bert_train_step(layer, opt, x),
                                              reps=5, warmup=2, iters=3))
    for variant, times in queued.items():
        print(f"bert layer {variant} seq 512 batch {BERT_BATCH}: train step "
              + " / ".join(f"{t:.4f}" for t in times) + " ms queued (5 steps between events, "
              "two turns)")
    del layers, x
    for attention, (enc, ids) in encoders.items():
        opt = tt.make_train_state(enc)
        with torch.no_grad():
            fwd_ms = time_ms(lambda: enc(ids), warmup=2, iters=5)
        step_ms = time_ms(lambda: tt.bert_train_step(enc, opt, ids), warmup=2, iters=5)
        print(f"bert encoder {attention} ({enc.num_layers} layers) seq 512 batch {BERT_BATCH}: "
              f"forward {fwd_ms:.4f} ms, train step {step_ms:.4f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    import tpusparse_torch as tt
    from tpusparse_torch.kernels.gemm import _gemm_plain, gemm_kernel
    from tpusparse_torch.kernels.sddmm import _sddmm_plain, sddmm_kernel
    from tpusparse_torch.kernels.tiled_spmm import (
        _block_exec_plain,
        launch_counts,
        reset_launch_counts,
        resident_spmm_kernel,
    )
    from tpusparse_torch.utils.config import fp32_matmul
    from tpusparse_torch.utils.matrices import block_sparse_csr

    name = phase_device()
    phase_build()
    phase_small_cases()
    phase_small_sddmm()
    phase_small_gemm()
    phase_small_flash()
    phase_small_block_flash()

    # -- set-up of the main path (host inspector, packing on the card) ------
    t0 = time.perf_counter()
    m = k = 16384
    n = 512
    a = block_sparse_csr(1, (m, k), (128, 128), 0.10, device="cuda")
    plan = tt.build_plan(a, (128, 128))
    bv = plan.pack_values(a.data)
    b = torch.from_numpy(
        np.random.default_rng(7).random((k, n), dtype=np.float32)
    ).cuda()
    print(f"headline set-up: {time.perf_counter() - t0:.1f} s, nnz {a.nnz}, "
          f"nblocks {plan.nblocks}, ell_width {plan.ell_width}")
    x_np = np.random.default_rng(3).standard_normal((32, 784)).astype(np.float32)
    x = torch.from_numpy(x_np).cuda()
    variants = ("sparse", "blocksparse")
    nets = {
        v: tt.MnistNet(v, hidden=256, device="cuda",
                       generator=torch.Generator().manual_seed(0)).eval()
        for v in variants
    }
    batches = _mnist_batches()
    torch.cuda.synchronize()

    # -- the main path, counted: forward ---------------------------------------
    reset_launch_counts()
    per_forward = {}
    with torch.inference_mode():
        c = tt.spmm_blocks(plan, bv, b)
        logp = {}
        for v in variants:
            before = sum(launch_counts().values())
            logp[v] = nets[v](x)
            per_forward[v] = sum(launch_counts().values()) - before
    torch.cuda.synchronize()
    counts = launch_counts()
    fwd_launches = sum(counts.values())
    print(f"main path launches by entry point: {json.dumps(counts)}")
    for v in variants:
        print(f"mlp {v}: {per_forward[v]} kernel launches per forward")
        if per_forward[v] != 2:
            raise AssertionError(f"{v} forward launched {per_forward[v]} kernels, not 2")
    if fwd_launches != 1 + 2 * len(variants):
        raise AssertionError(f"main path launched {fwd_launches} kernels")

    # -- checks of the forward's results ---------------------------------------
    ref = _block_exec_plain(plan, bv, b)
    max_abs = float((c - ref).abs().max())
    scale = max(float(ref.abs().max()), 1.0)
    print(f"headline: max_abs_err {max_abs:.3e}, over scale {max_abs / scale:.3e}")
    if not (max_abs / scale <= HEADLINE_TOL and bool(torch.isfinite(c).all())):
        raise AssertionError("headline kernel disagrees with its plain version")
    del ref
    for v in variants:
        cpu_net = tt.MnistNet(v, hidden=256, device="cpu",
                              generator=torch.Generator().manual_seed(0)).eval()
        with torch.inference_mode():
            want = cpu_net(torch.from_numpy(x_np))
        got = logp[v].cpu()
        err = float((got - want).abs().max())
        ok = (got.shape == (32, 10) and bool(torch.isfinite(got).all())
              and torch.allclose(got, want, **TOL_FP32))
        print(f"mlp {v}: card vs CPU max_abs_err {err:.3e} "
              f"({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"mlp {v}: card and CPU log-probs disagree")

    # -- the main path, counted: training and the headline backward -----------
    train_counts = phase_train(batches)
    bwd_counts, sddmm_err, dc, plan_t, bv_t = phase_headline_backward(plan, bv, b)
    layer_counts = phase_bert_layers()
    enc_counts, enc, enc_ids = phase_bert_encoder("flash")
    flash_launches = {n: layer_counts[n] + enc_counts[n] for n in NO_FLASH}
    phase_bert_card_vs_cpu()
    blk_launches, bb_enc, bb_ids = phase_pattern_paths()
    phase_bert_card_vs_cpu("bigbird", 512)
    phase_bert_card_vs_cpu("sparse", 512, method="blockflash")

    # -- timings: block_ell_spmm at the headline -------------------------------
    kernel_ms = time_ms(lambda: resident_spmm_kernel(plan, bv, b))
    plain_ms = time_ms(lambda: _block_exec_plain(plan, bv, b))
    a_dense = plan.blocks_to_dense(bv)
    with fp32_matmul():  # TF32 off: the yardstick is a true fp32 product
        library_ms = time_ms(lambda: torch.matmul(a_dense, b))
        lib_err = float((torch.matmul(a_dense, b) - c).abs().max()) / scale
    del a_dense
    bm, bk = plan.blocksize
    flops = 2.0 * a.nnz * n
    nbytes = 4.0 * (plan.nblocks * bm * bk + k * n + m * n)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"headline: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.matmul dense {library_ms:.4f} ms (vs kernel {lib_err:.2e}), "
          f"bound {bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
          f"kernel at {flops / (kernel_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    # dB = Aᵀ·dC on the transpose plan: the same kernel, transposed blocks
    dbt_ms = time_ms(lambda: resident_spmm_kernel(plan_t, bv_t, dc))
    dbt_plain_ms = time_ms(lambda: _block_exec_plain(plan_t, bv_t, dc))
    print(f"headline dB (transpose plan {plan_t.shape}, ell_width {plan_t.ell_width}): "
          f"kernel {dbt_ms:.4f} ms, plain {dbt_plain_ms:.4f} ms, same bound "
          f"{bound_ms:.4f} ms, kernel at {flops / (dbt_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    del bv_t

    # -- timings: sddmm at the headline ----------------------------------------
    s_ms = time_ms(lambda: sddmm_kernel(plan, dc, b))
    s_plain_ms = time_ms(lambda: _sddmm_plain(plan, dc, b))
    bt = b.transpose(0, 1)
    with fp32_matmul():
        s_library_ms = time_ms(lambda: torch.matmul(dc, bt))
    s_flops = 2.0 * plan.nblocks * bm * bk * n
    s_bytes = 4.0 * (m * n + k * n + plan.num_slots * bm * bk)
    s_bound_ms, s_bound_by = bound(s_flops, s_bytes)
    print(f"headline sddmm: kernel {s_ms:.4f} ms, plain {s_plain_ms:.4f} ms, "
          f"torch.matmul(dC, B^T) dense superset {s_library_ms:.4f} ms, bound "
          f"{s_bound_ms:.4f} ms ({s_flops / 1e9:.2f} GFLOP, {s_bytes / 1e6:.1f} MB), "
          f"kernel at {s_flops / (s_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    del dc, bt

    # -- timings and check: gemm at 4096^3 --------------------------------------
    g = 4096
    rng = np.random.default_rng(5)
    ga = torch.from_numpy(rng.standard_normal((g, g), dtype=np.float32)).cuda()
    gb = torch.from_numpy(rng.standard_normal((g, g), dtype=np.float32)).cuda()
    gc = gemm_kernel(ga, gb, precision="high")
    g_err, g_rel = over_scale(gc, _gemm_plain(ga, gb, precision="high"))
    print(f"gemm {g}^3: max_abs_err {g_err:.3e}, over scale {g_rel:.3e}")
    if not (g_rel <= HEADLINE_TOL and bool(torch.isfinite(gc).all())):
        raise AssertionError("gemm disagrees with its plain version at 4096^3")
    del gc
    gm_ms = time_ms(lambda: gemm_kernel(ga, gb, precision="high"))
    gm_plain_ms = time_ms(lambda: _gemm_plain(ga, gb, precision="high"))
    with fp32_matmul():
        gm_library_ms = time_ms(lambda: torch.matmul(ga, gb))
    gm_flops = 2.0 * g ** 3
    gm_bound_ms, gm_bound_by = bound(gm_flops, 4.0 * 3 * g * g)
    print(f"gemm {g}^3 fp32 'high': kernel {gm_ms:.4f} ms, plain {gm_plain_ms:.4f} ms, "
          f"torch.matmul (TF32 off; the plain version's own call) {gm_library_ms:.4f} ms, "
          f"bound {gm_bound_ms:.4f} ms, kernel at "
          f"{gm_flops / (gm_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    del ga, gb

    # -- timings: the MLP -------------------------------------------------------
    with torch.inference_mode():
        for v in variants:
            ms = time_ms(lambda: nets[v](x), warmup=5, iters=50)
            print(f"mlp {v}: {ms:.4f} ms per forward (batch 32)")
        # where a sparse forward's time goes: the kernel alone, per layer
        h = x
        for i in (1, 2):
            layer = getattr(nets["sparse"], f"fc{i}")
            lplan, lplan_t, lt_perm = tt.build_plan_pair(
                layer.pattern.to_csr(layer.kernel_values))
            lbv = lplan.pack_values(layer.kernel_values)
            lb = h.transpose(0, 1).contiguous()
            ms = time_ms(lambda: resident_spmm_kernel(lplan, lbv, lb), warmup=5, iters=50)
            gy = torch.ones((lplan.shape[0], lb.shape[1]), device="cuda")
            sms = time_ms(lambda: sddmm_kernel(lplan, gy, lb), warmup=5, iters=50)
            print(f"mlp sparse fc{i}: kernel alone {ms:.4f} ms "
                  f"({lplan.shape[0]}x{lplan.shape[1]} @ {lb.shape[0]}x{lb.shape[1]}, "
                  f"{lplan.nblocks} blocks); its sddmm (dW) alone {sms:.4f} ms")
            if i == 2:  # the step's dB runs for fc2 only (fc1's input is the data)
                perm = lplan_t.perm_tensor("t_perm", lt_perm, "cuda")
                lbv_t = lplan_t.pack_values(layer.kernel_values[perm])
                dms = time_ms(lambda: resident_spmm_kernel(lplan_t, lbv_t, gy),
                              warmup=5, iters=50)
                print(f"mlp sparse fc{i}: its dB on the transpose plan alone {dms:.4f} ms "
                      f"({lplan_t.shape[0]}x{lplan_t.shape[1]} @ {gy.shape[0]}x{gy.shape[1]})")
            h = torch.relu(layer(h))
        # the five products of a 'dense' step on the GEMM kernel, alone
        gen = torch.Generator().manual_seed(4)
        w1, w2, h1, g2 = (torch.randn(shape, generator=gen).cuda()
                          for shape in ((256, 784), (10, 256), (32, 256), (32, 10)))
        products = {
            "fc1 fwd x.W1^T": (x, w1, False, True),
            "fc2 fwd h.W2^T": (h1, w2, False, True),
            "fc2 dX g.W2": (g2, w2, False, False),
            "fc2 dW g^T.h": (g2, h1, True, False),
            "fc1 dW g^T.x": (h1, x, True, False),
        }
        for pname, (pa, pb, ta, tb) in products.items():
            ms = time_ms(lambda: gemm_kernel(pa, pb, transa=ta, transb=tb), warmup=5, iters=50)
            print(f"mlp dense {pname}: gemm alone {ms:.4f} ms")
    for v in ("sparse", "blocksparse", "dense", "dense_cublas", "xla"):
        variant = "dense" if v.startswith("dense") else v
        tt.set_config(use_gemm_kernel=v == "dense")
        try:
            net = _net(variant, "cuda")
            opt = tt.make_train_state(net)
            xb, yb = batches[0][0].cuda(), batches[0][1].cuda()
            ms = time_ms(lambda: tt.train_step(net, opt, xb, yb), warmup=5, iters=50)
        finally:
            tt.set_config(use_gemm_kernel=False)
        label = {"dense": "dense (GEMM kernel)", "dense_cublas": "dense (torch.matmul)",
                 "xla": "xla (nn.Linear)"}.get(v, v)
        print(f"train step {label}: {ms:.4f} ms per step (batch 32)")

    # -- timings: flash attention and the BERT layer and encoder -----------------
    flash_t = phase_flash_timings()
    blk_t = phase_block_flash_timings()
    phase_bert_timings({"flash": (enc, enc_ids), "bigbird": (bb_enc, bb_ids)})
    del enc, enc_ids, bb_enc, bb_ids
    phase_bert_profile()

    kernels = [
        {
            "name": "block_ell_spmm",
            "route": "cuda",
            "source": "tpusparse_torch/csrc/block_ell_spmm.cu",
            "replaces": "tpusparse/kernels/tiled_spmm.py:43 (_executor_kernel); "
                        "tpusparse/kernels/tiled_spmm.py:210 (_resident_kernel)",
            "launches": fwd_launches + train_counts["block_ell_spmm"]
            + bwd_counts["block_ell_spmm"],
            "max_abs_err": max_abs,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        },
        {
            "name": "sddmm",
            "route": "cuda",
            "source": "tpusparse_torch/csrc/sddmm.cu",
            "replaces": "tpusparse/kernels/sddmm.py:35 (_sddmm_kernel)",
            "launches": train_counts["sddmm"] + bwd_counts["sddmm"],
            "max_abs_err": sddmm_err,
            "ms": s_ms,
            "plain_ms": s_plain_ms,
            "bound_ms": s_bound_ms,
            "bound_by": s_bound_by,
            "library_ms": s_library_ms,
        },
        {
            "name": "gemm",
            "route": "cuda",
            "source": "tpusparse_torch/csrc/gemm.cu",
            "replaces": "tpusparse/kernels/gemm.py:31 (_gemm_kernel)",
            "launches": train_counts["gemm"],
            "max_abs_err": g_err,
            "ms": gm_ms,
            "plain_ms": gm_plain_ms,
            "bound_ms": gm_bound_ms,
            "bound_by": gm_bound_by,
            "library_ms": gm_library_ms,
        },
    ]
    main_seq = max(BERT_SEQS)
    ft = flash_t[main_seq]
    flash_rows = (
        ("flash_fwd", "fwd", "53 (_flash_kernel)", ft["err"]["o"][0], ft["sdpa_fwd_ms"]),
        ("flash_dq", "dq", "495 (_flash_dq_kernel)", ft["err"]["dq"][0], ft["sdpa_bwd_ms"]),
        ("flash_dkv", "dkv", "538 (_flash_dkv_kernel)",
         max(ft["err"]["dk"][0], ft["err"]["dv"][0]), ft["sdpa_bwd_ms"]),
    )
    for kname, key, line, err, lib_ms in flash_rows:
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "tpusparse_torch/csrc/flash_attention.cu",
            "replaces": f"tpusparse/kernels/flash_attention.py:{line}",
            "launches": flash_launches[kname],
            "max_abs_err": err,
            "ms": ft["ms"][key],
            "plain_ms": ft["plain_ms"][key],
            "bound_ms": ft["bound"][key][0],
            "bound_by": ft["bound"][key][1],
            "library_ms": lib_ms,
        })
    bt = blk_t["bigbird_512"]
    blk_rows = (
        ("blk_flash_fwd", "fwd", "929 (_blk_flash_kernel; pallas_call l.1087)",
         bt["err"]["o"][0], bt["sdpa_fwd_ms"]),
        ("blk_flash_dq", "dq", "1136 (_blk_dq_kernel, _blk_dq_mask l.1171; pallas_call l.1286)",
         bt["err"]["dq"][0], bt["sdpa_bwd_ms"]),
        ("blk_flash_dkv", "dkv",
         "1175 (_blk_dkv_kernel, _blk_dkv_mask l.1215; pallas_call l.1339)",
         max(bt["err"]["dk"][0], bt["err"]["dv"][0]), bt["sdpa_bwd_ms"]),
    )
    for kname, key, line, err, lib_ms in blk_rows:
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "tpusparse_torch/csrc/block_flash_attention.cu",
            "replaces": f"tpusparse/kernels/flash_attention.py:{line}",
            "launches": blk_launches[kname],
            "max_abs_err": err,
            "ms": bt["ms"][key],
            "plain_ms": bt["plain_ms"][key],
            "bound_ms": bt["bound"][key][0],
            "bound_by": bt["bound"][key][1],
            "library_ms": lib_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
