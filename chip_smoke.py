#!/usr/bin/env python3
"""Drive tpusparse_torch on one NVIDIA card and hold its kernel to account.

Run from the repo root:  python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:
  1. the card's name and power limit;
  2. build of the CUDA kernel from the repo's sources (nvcc, sm_90a);
  3. kernel against its plain PyTorch version on the card at small shapes
     (ragged m/k/n, blocksizes (8, 16), (32, 8), (128, 128), empty
     row-blocks, fp32 'high' and 'default', bf16), through both entry
     points, which must agree bitwise;
  4. the main path, with the launch counts set to 0 just before it and read
     just after: the 16384^2 block-sparse SpMM (10% of its 128x128 blocks,
     B 16384 x 512 fp32, 'high') through `spmm_blocks`, and the forward of
     the flagship MNIST MLP (784 -> 256 -> 10, batch 32) in its 'sparse'
     and 'blocksparse' variants, with weights from a seeded generator;
  5. checks of the main path's results: headline kernel against the plain
     version (max-abs error over scale <= 1e-5), MLP log-probs against the
     same weights run on the CPU (rtol 1e-4, atol 5e-5);
  6. timings with CUDA events (median after warm-up): kernel, plain
     version, and one torch.matmul on the densified A (fp32, TF32 off; a
     yardstick the port never calls), and the bound from this run's inputs;
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
    reports = _build.build(["block_ell_spmm"])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def _dense_case(seed, m, k, density, empty_block=None):
    rng = np.random.default_rng(seed)
    a = (rng.random((m, k)) < density) * rng.standard_normal((m, k))
    if empty_block is not None:
        r0, r1 = empty_block
        a[r0:r1] = 0.0
    return a.astype(np.float32), rng


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
        tol = TOL_BF16_OUT if out_t.dtype == bf16 else TOL_FP32
        got, want = out_t.float(), ref.float()
        rel = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
        ok = torch.allclose(got, want, **tol) and bool(torch.isfinite(got).all())
        print(f"case {name}: max_rel_err {rel:.3e} (rtol {tol['rtol']}, atol "
              f"{tol['atol']}), entry points bitwise equal, "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    import tpusparse_torch as tt
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
    torch.cuda.synchronize()

    # -- the main path, counted ----------------------------------------------
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
    launches = sum(counts.values())
    print(f"main path launches by entry point: {json.dumps(counts)}")
    for v in variants:
        print(f"mlp {v}: {per_forward[v]} kernel launches per forward")
        if per_forward[v] != 2:
            raise AssertionError(f"{v} forward launched {per_forward[v]} kernels, not 2")
    if launches != 1 + 2 * len(variants):
        raise AssertionError(f"main path launched {launches} kernels")

    # -- checks of the main path's results -----------------------------------
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

    # -- timings --------------------------------------------------------------
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
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    print(f"headline: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.matmul dense {library_ms:.4f} ms (vs kernel {lib_err:.2e}), "
          f"bound {bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
          f"kernel at {flops / (kernel_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    with torch.inference_mode():
        for v in variants:
            ms = time_ms(lambda: nets[v](x), warmup=5, iters=50)
            print(f"mlp {v}: {ms:.4f} ms per forward (batch 32)")
        # where a sparse forward's time goes: the kernel alone, per layer
        h = x
        for i in (1, 2):
            layer = getattr(nets["sparse"], f"fc{i}")
            lplan = tt.build_plan(layer.pattern.to_csr(layer.kernel_values))
            lbv = lplan.pack_values(layer.kernel_values)
            lb = h.transpose(0, 1).contiguous()
            ms = time_ms(lambda: resident_spmm_kernel(lplan, lbv, lb), warmup=5, iters=50)
            print(f"mlp sparse fc{i}: kernel alone {ms:.4f} ms "
                  f"({lplan.shape[0]}x{lplan.shape[1]} @ {lb.shape[0]}x{lb.shape[1]}, "
                  f"{lplan.nblocks} blocks)")
            h = torch.relu(layer(h))

    kernels = [{
        "name": "block_ell_spmm",
        "route": "cuda",
        "source": "tpusparse_torch/csrc/block_ell_spmm.cu",
        "replaces": "tpusparse/kernels/tiled_spmm.py:43 (_executor_kernel); "
                    "tpusparse/kernels/tiled_spmm.py:210 (_resident_kernel)",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
