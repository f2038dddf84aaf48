#!/usr/bin/env python3
"""Drive tpusparse_torch on one NVIDIA card and hold its kernels to account.

Run from the repo root:  python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:
  1. the card's name and power limit;
  2. build of the three CUDA kernels from the repo's sources (one nvcc per
     source, all started together; sm_90a), with ptxas's report;
  3. each kernel against its plain PyTorch version on the card at small
     shapes: block_ell_spmm (ragged m/k/n, blocksizes (8, 16), (32, 8),
     (128, 128), empty row-blocks, fp32 'high' and 'default', bf16; both
     entry points, which must agree bitwise), sddmm (the same blocksizes,
     ragged m/k/n, an empty row-block whose pad slots must be exactly 0,
     fp32 'high'/'highest'/'default', bf16) and gemm (all four transpose
     flags, ragged (100, 70, 33), fp32 'high' and 'default', bf16);
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
  5. checks of the main path's results: headline forward, dblocks and dB
     against their plain versions (max-abs error over scale <= 1e-5), MLP
     log-probs, and the first 3 training steps' losses and parameters,
     against the same weights run on the CPU (rtol 1e-4, atol 5e-5); the
     loss must drop over the 20 steps (last < 0.8 x first);
  6. timings with CUDA events (median after warm-up): each kernel, its
     plain version and one PyTorch call that computes the same function (a
     yardstick the port never calls), at the headline shapes and at the
     MLP's, one training step per variant, and each kernel's bound from
     this run's inputs;
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
STEP_LAUNCHES = {
    "sparse": {"block_ell_spmm": 3, "sddmm": 2, "gemm": 0},
    "blocksparse": {"block_ell_spmm": 3, "sddmm": 2, "gemm": 0},
    "dense": {"block_ell_spmm": 0, "sddmm": 0, "gemm": 5},
}


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
    reports = _build.build(["block_ell_spmm", "sddmm", "gemm"])
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

    totals = {"block_ell_spmm": 0, "sddmm": 0, "gemm": 0}
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
    if counts != {"block_ell_spmm": 2, "sddmm": 1, "gemm": 0}:
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
