#!/usr/bin/env python3
"""Drive tpusparse_torch on one NVIDIA card and hold its kernels to account.

Run from the repo root:  python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:
  1. the card's name and power limit;
  2. build of the fifteen CUDA sources from the repo (one nvcc per source,
     all started together; sm_90a), with ptxas's registers, stack and
     spills for each kernel instance;
  3. each kernel against its plain PyTorch version on the card at small
     shapes: block_ell_spmm (ragged m/k/n, blocksizes (8, 16), (32, 8),
     (64, 16), (128, 128), (200, 8), n 1 to 512, empty row-blocks, fp32
     'high' and 'default', bf16; both entry points, which must agree
     bitwise, and a second call bitwise equal to the first), sddmm (the
     same blocksizes, ragged m/k/n, n 1 to 512, an empty row-block whose pad
     slots must be exactly 0, fp32 'high'/'highest'/'default', bf16, a
     second call bitwise equal; and 4 slots over n = 65,536, split into
     ranges of n) and gemm (all four transpose
     flags, ragged (100, 70, 33) in fp32 and bf16, 'high' and 'default',
     and the MLP's n = 10 layer (32, 10, 256) in fp32; each run twice and
     bitwise equal) and the
     three flash attention kernels (flash_fwd, flash_dq, flash_dkv) at
     (b, h, s, d) = (2, 3, 256, 64), causal (1, 2, 384, 64), ragged
     (1, 1, 200, 64), (2, 4, 128, 24), (1, 2, 128, 128), a causal chunk
     with q_offset 256, d 20, and a causal (1, 2, 1030, 64) with
     kv_offset 300 (rows that see no key must give 0 and -1e30), in fp32
     'high', 'highest' and 'default' and bf16 'high' and 'default': o, lse,
     dq, dk, dv, each as max-abs error over scale; and
     the three block-pattern kernels (blk_flash_fwd, blk_flash_dq,
     blk_flash_dkv) on mask-free plans ('bigbird' block masks at blocks 32
     and 64, a block mask at s = 160) and token-exact masked plans (band
     patterns at blocks 64, 64x32, 128x256 and 256, s = 160 and 1000 off
     the block, a band whose rows find their first sub-tile wholly masked
     at d 96, the 'sparse' layer's plan at seq 4096), d from 24 to 128,
     each in fp32 'high', fp32 'default' and bf16, with the forward (and in
     fp32 'high' dq, dk and dv) run twice and required bitwise equal; the
     int8 kernels: spmm_int8 at
     blocksizes (8, 16), (32, 8), (128, 128), (64, 128), (128, 64) and
     (64, 32) (ragged m, k, n, n 1 and 257, empty row-blocks, pad slots)
     and a 1024^2 pattern of 128^2 blocks at 10 % (both entry points
     bitwise equal to each other and to the plain version), gemm_s8 at
     GEMM_S8_CASES' twelve shapes up to 4096^3 (int32 equal, 1 gemm_s8 and
     1 int8_kmajor a call; both tile widths, each on a shape with more
     tiles than the card holds blocks), flash_q8 at the flash cases' six shapes, a
     causal seq 1000 and q and kv offsets together, with fp32 and bf16 q;
     naive_spmm with every reducer and the arg of max and min (ragged m,
     n 1, 7, 64 and 300, empty rows, one long row, tied products, a bf16
     b; values and args bitwise equal to the plain version); the
     seven attention entry points at head dims 192, 256 and 200 (causal with
     and without offsets, a 'bigbird' plan for the block kernels; fp32
     'high', 'default' and bf16); the batched, compact, grouped and
     footprint kernels at blocksizes (5, 8), (8, 32), (24, 16), (32, 16),
     (64, 64), (72, 32), (128, 128) and (200, 16) (the n-major tile, one
     and two warpgroups, taller than a grouped window), ragged m/k/n, n 1,
     row-blocks with no slot, batch 1 to 5, fp32 'high' and 'default' and
     bf16: the batched and compact kernels are block_ell_spmm's body, so
     the batched kernel is bitwise equal to block_ell_spmm on the folded B
     and on every B[g] alone and the compact one to it on the base plan;
     the grouped and footprint kernels
     share one FFMA chain, bitwise equal to each other on the base plan and
     within the tier of block_ell_spmm; windowed_gather and
     windowed_segsum on six index maps (local with far outliers, a single
     far read, fully scattered, empty segments with n and the segment count
     off the 1024 padding, a
     table shorter than its window, the segment
     plan's W = 4096), each in fp32, bf16 and fp16, bitwise equal to their
     plain versions, and a chunked accumulation forced with a small target
     bitwise equal to the whole one; dia_spmv bitwise equal to its plain
     version on fourteen planes (1, 7, 129, 160, 200, 400 and 2105
     diagonals, square and rectangular, offsets past both edges, fp32 and
     bf16 planes and x; whole zero 32-row tiles, tiles of -0.0, a NaN in
     an occupied tile, a NaN or +Inf in x that only skipped terms meet),
     each walking every diagonal and walking the plane's tile list, and
     x's nonfinite check on each x, PackedDIA.mv (1 check and 1 walk) and
     dia_spmm on one column (1 walk), bitwise, and the backward's d_data
     and dx against float64;
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
     h. the int8 serving tier (benchmarks/quant_benchmark.py --full): the
        headline A as a QuantizedMatrix times B (1 resident spmm_int8
        launch and 1 int8_kmajor, which makes b_q K-major), a 4096 x 16384
        pattern with fewer blocks than block-columns (1 ring launch, 1
        int8_kmajor), quantized_matmul and
        QuantizedDense.matmul at 4096^3 (1 gemm_s8 and 1 int8_kmajor each),
        and quantize_kv +
        flash_attention_q8 at (8, 16, 512, 64) causal and (2, 12, 4096, 64)
        (1 flash_q8 each);
     i. GPT serving at benchmarks/serving_benchmark.py's configuration (24
        layers, hidden 1024, 16 heads, intermediate 4096, vocab 32000,
        max_position 512, seeded weights, a 16-token prompt): generate in
        fp32, bf16 and int8 (quantize_gpt) at batch 1 and 8 for 16 and 96
        steps, with no kernel launched; the fused=True forward at batch 8,
        seq 512 with exactly 24 flash_fwd, timed beside the unfused one;
     j. GCN at Cora's published sizes (a generated graph of 2708 nodes and
        mean degree 3.9, 1433 binary features, 7 classes, 140 training
        nodes; hidden 64, spmm_method 'naive'): a forward and 20 Adam steps
        (lr 1e-2), 2 naive_spmm launches each and nothing else;
     k. GCN at ogbn-arxiv's published sizes (169,343 nodes, mean degree
        13.7, 128 features, 40 classes; OGB's baseline, 3 layers of width
        256) on 'naive': a forward and 5 Adam steps, 3 launches each; the
        block count a 128^2 'tiled' plan would need, printed, not run;
     l. GAT at the Cora shape (8 heads of 8, add_self_loops, 'naive'): a
        forward and 20 Adam steps (lr 5e-3), 16 launches each;
     m. APPNP at the Cora shape (hidden 64, alpha 0.1, K 10) on the
        default 'tiled' route: 10 block_ell_spmm launches a forward, 20 a
        step (the dB of each propagation step; no SDDMM, since A-hat's
        values need no gradient);
     n. spmm's routes on Cora's A-hat: 'naive', 'gather', 'dense', 'tiled'
        against 'reference', a BSR operand and a 3-D b;
     o. bench.py's batched shapes (A 2048^2 with 10% of its 128^2 blocks x
        B (32, 2048, 512); 'bert4d', A 512^2 at 10% x B (4096, 512, 64);
        fp32 'high'): one tiled_spmm training step each with grads in
        a.data and B (1 resident_spmm_batched forward, 1 sddmm on the folded
        batch, 1 resident_spmm_batched dB);
     p. the compact, grouped and footprint executors at the headline plan
        and at a low-fill plan (4096^2 at 1%, blocks 8x32, n 256), one
        launch each, and one spmm(method='footprint') step at the headline
        (1 footprint_spmm, 1 sddmm, 1 block_ell_spmm);
     q. SpGEMM, A·A in fp32 at the shapes of the JAX package's own
        measurement (BENCH_DETAILS.json "r5_spgemm": 4096^2 at 0.1 %,
        16384^2 at 0.05 %, 4096^2 at 1 %), with grads in both operands'
        values: a forward and backward through `a @ a`, then `spgemm` and
        `spgemm(method='auto')`, each counted: one windowed_gather per
        adopted gather plan and one windowed_segsum per segment plan or
        chunk a forward, the gathers of dC, a and b where adopted a
        backward (3 gathers and 1 segment sum, 4 at 4096^2 at 1 %); the
        route of 'auto' ('schedule'), the adopted plans and which inspector
        built them;
     r. AMG-preconditioned CG on laplace3d_64 (the 7-point Laplacian on a
        64^3 grid, 262,144 rows; the JAX package's solver measurement,
        benchmarks/realmatrix_benchmark.py FULL_SET with --amg):
        smoothed_aggregation_setup on the card with its host seconds, the
        hierarchy's four levels and formats against the JAX package's
        (AMG_LEVELS), the tile lists of its PackedDIA planes built on the
        device with their time, then Jacobi-CG (50 iterations) and AMG-CG (40
        iterations) at tol 1e-7 on the 7-diagonal DIA operator, the AMG-CG
        solve counted: per V-cycle 14 dia_spmv, 14 dia_nonfinite (x's check
        before each walk of a tile list) and the windowed gathers and
        segment sums of the adopted plans;
     s. `tpusparse_torch.parallel` at world size 1 on NCCL (a `file://`
        store; the group torn down after): `sharded_spmm` and `halo_spmm` at
        the headline (1 block_ell_spmm each), the dp×tp sparse-MLP step at
        ShardedMLPConfig's defaults (784/256/10, density 0.1, blocks
        (8, 128)), batch 32, 20 steps of 1 block_ell_spmm + 1 sddmm, the
        node-sharded GCN on the Cora-shaped task (2 block_ell_spmm a
        forward, 4 a step), sharded_dia_cg on laplace3d_64 and sharded_cg
        on a 4096^2 SPD CSR (1 block_ell_spmm a matvec), and the scaling
        projection at the headline on this card's fit;
     t. `tpusparse_torch.parallel` part b at world size 1 on NCCL
        (run_parallel_models, which parallel_smoke.py runs over its cards):
        the Megatron BERT-base layer ('flash', batch 8, seq 512, fp32
        'high') on a (1, 1) mesh, forward (1 flash_fwd) and backward (1
        flash_dq + 1 flash_dkv) against the one-card layer (output and
        grads equal at one rank, at the fp32 tier over cards), and the 12-layer
        encoder's forward (12 flash_fwd); ring-flash and fused Ulysses
        attention at (2, 12, 4096, 64), causal and not, forward and
        backward (1 of each flash kernel), o, dq, dk and dv equal to
        flash_attention_diff bit for bit; ring_local_attention at (2, 12,
        4096, 64), window 128, against LocalAttention's core (fp32 tier);
        MoE at Switch-Base-8's widths (d 768, d_ff 3072, 8 experts, 4096
        tokens): moe_forward and moe_forward_a2a at capacity 8.0 with their
        gradients against moe_forward_reference (fp32 tier), capacity 2.0's
        share of dropped tokens; pipeline_apply (d 1024, batch 512, 8
        microbatches) against the sequential loop; TP int8 decode at the
        serving GPT, batch 1 and 8, logits and the gathered int8 cache
        equal to decode_step's; each timed beside its one-card form;
     u. the examples, after the timings: each examples_torch/0*.py
        `main()` on the card (06 at world size 1 on NCCL), the counts set
        to 0 before each and read after: its launches by kernel and its
        wall time; each example asserts its own figures against float64;
     v. the tile autotuners, last, on a temporary calibration file:
        autotune_gemm at 4096^3 in bf16 and fp32 'high' and at (512, 4096,
        4096) 'high', autotune_flash at (96, 512, 64) fp32 'high', causal
        and not, with each candidate tile's time; a call with no tile
        arguments then takes the saved tile, and its output must be
        bitwise equal to the kernel's own tile's; the tile lookup's host
        cost (at most 2 us a call) and gemm_kernel's host time at (4096,
        4096, 8) with and without a saved tile;
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
     'blockflash', each at batch 1, seq 512; the int8 headline against
     float64 on 32 columns and flash_q8 against the fp32 flash forward
     (< 5e-2); the fused GPT forward against the unfused (< 2e-3); int8
     against fp32 GPT quality over 24 teacher-forced steps at batch 1 (max
     logit rel err, top-1 agreement, finite); a full-width QuantizedGPT on
     the card against the CPU (int8 weights and scales bitwise equal,
     prefill + 3 decode steps' logits < GPT_CARD_CPU_LIMIT of scale); the
     Cora-shaped GCN, GAT and APPNP: loss drops over 20 steps, the forward
     and 3 steps on the card against the same weights on the CPU (rtol
     1e-4, atol 5e-5; parameters by the Adam rule of
     tests/test_torch_graph.py); the arxiv GCN's outputs and losses finite
     and its loss dropping; the batched steps' forward and dB and the
     footprint step's against their plain versions and the batched steps'
     dA against float64 (<= 1e-5 of scale), the
     batched kernel bitwise equal to block_ell_spmm at its first and last
     batch elements and to the fold at both shapes,
     each plan executor against its plain version, compact bitwise equal
     to block_ell_spmm and grouped to footprint at both plans;
     SpGEMM's C against a float64 scipy
     product and its pattern against scipy's, dA and dB against the dense
     algebra in float64, the 'dense' route against the same oracle (each
     <= 1e-5 of scale), and at 16384^2 the card against the CPU (values and
     grads, rtol 1e-4, atol 5e-5); one AMG V-cycle on the card against the
     same hierarchy on the CPU (<= 1e-5 of scale) and AMG-CG's float64
     relative residual after 40 iterations (< 1e-4); the sharded headline
     products against the plain executor (<= 1e-5 of scale; whether each
     equals spmm(method='tiled') bit for bit, printed), the sharded MLP's
     loss dropping over 20 steps (last < 0.8 x first), its weights outside
     the mask exactly 0 and 3 steps against the same steps on the CPU
     (gloo, before NCCL comes up; rtol 1e-4, atol 5e-5), the sharded GCN
     forward against the single-card GCN (the same tier) and its loss
     dropping, the sharded solvers' float64 residuals (< 1e-4; sharded_dia_cg
     after one restart from its x, its first solve within 10 % of linalg.cg's);
  6. timings with CUDA events (median after warm-up): each kernel, its
     plain version and one PyTorch call that computes the same function (a
     yardstick the port never calls), at the headline shapes and at the
     MLP's, one training step per variant, and each kernel's bound from
     this run's inputs; gemm at 4096^3 in 'high' (3xTF32) beside its FFMA
     predecessor's time and in 'default' against torch.matmul of the
     bf16-rounded operands, each bound at the tensor-core rate its tier
     uses, and with bf16 operands, held against its plain version first;
     the flash kernels at (b, h, s, d) = (8, 12, 512, 64)
     and (8, 12, 128, 64) against their plain versions, their bounds and
     torch's scaled_dot_product_attention (forward, and its autograd
     backward) in fp32, with the SDPA backend named, each beside its FFMA
     predecessor's time, and also in 'default' and on bf16 operands
     against bf16 SDPA (the backward pair, dq with dk and dv, against
     SDPA's autograd backward), and at (2, 12, 4096, 64) (the backward in
     fp32 'high' held against float64 too) and GPT's fused call (8 x 16,
     512, 64) causal, forward only; every fp32 'high' product's bound on 3xTF32
     (3 x FLOP at 495 TFLOP/s tf32), the FFMA figure printed beside it as
     a design figure; the block kernels at
     the 'bigbird' shapes (bh 96, seq 512, block 64; bh 24, seq 4096, block
     256) and at the 'sparse' layer's masked seq-4096 plan, against their
     plain versions, their bounds from the covered tiles and
     scaled_dot_product_attention with the token-exact boolean mask (each
     forward and SDPA also behind a sleep, `time_ms_ahead`, with the
     forward's TFLOP/s and share of its 3xTF32 bound, the 'bigbird' one
     beside its FFMA predecessor's time; the forward in fp32 'default' and
     on bf16 operands against bf16 SDPA with the mask, behind a sleep); the
     BERT layer's forward and step times in every variant and shape of 4d,
     4f and 4g and 'flash' at 4g's seq 4096, batch 2, the seq-512 variants'
     steps queued back to back in turns,
     and the 'flash' and 'bigbird' encoders' times; a torch.profiler trace of the layer's steps at seq 512 ('flash',
     'dense', 'bigbird': device busy and idle share, the kernels that take
     the most time); the int8 kernels at the main path's shapes against
     their plain versions, bounds and yardsticks (a bf16 torch.matmul of the
     dequantized dense A, torch._int_mm with B row-major and column-major,
     bf16 SDPA), gemm_s8 (the entry point: int8_kmajor and the kernel; the
     kernel alone and int8_kmajor at 4096^2 apart), spmm_int8 (the entry
     point: int8_kmajor and the executor) beside its unpipelined
     predecessor's time, the executor alone as a design figure, with
     quantize_columns and beside the fp32
     block_ell_spmm, int8_kmajor against b_q.t().contiguous(), the ring
     entry point on the ring pattern, flash_q8 (bf16
     tensor cores) beside its first port's time and its bound's fraction;
     GPT ms per token and tokens/s per tier and batch ((96-step - 16-step
     generate) / 80) against the HBM bound, and the device's busy share of a decode step
     (torch.profiler kernel time over the per-token time); naive_spmm at
     the arxiv-shaped A-hat (sum at n 256 and 40, max with its arg) against
     its plain version, gather_spmm and torch.sparse.mm on a CSR tensor
     (the sum also both behind a sleep, beside the whole-row kernel's time
     before its redesign, with the gathers' bytes and rate, and as a design
     figure the gathers at L2's rate for a streaming read of a 16 MiB
     buffer, read once and 32 times a call), the sum at each width of B's column strips (16, 32 and 64
     fp32 columns, each bitwise equal to the plain version); ms
     per Adam step and the device's busy share for 4j-4m; the seven
     attention entry points at (2, 8, 512, 256) against their plain
     versions, bounds and SDPA; the batched kernel at both batched shapes
     against the fold, its plain version, torch.matmul of the dense A
     broadcast over the batch and its bound, each step's time and a
     torch.profiler breakdown of it; the plan executors beside
     block_ell_spmm, their plain versions, torch.matmul of the dense A,
     torch.sparse.mm (low-fill plan) and their bound, the footprint and
     grouped kernels beside their first ports' times (the footprint also
     beside its time before its tile was shared) and their bound's
     fraction, the footprint plan's
     B-tile fetches against the slots and the kernel's thread blocks a
     super, the grouped kernel's grid at both plans, and the
     footprint step's
     time with the host's plan lookups; SpGEMM's forward and
     forward+backward with the plan held and looked up, the 'dense' route, torch.sparse.mm of two
     CSR tensors (cuSPARSE, a yardstick), a torch.profiler breakdown of the
     forward+backward, both windowed kernels on the 16384^2 case's maps
     against their plain versions, torch.index_select / index_add_ and
     their bound (both kernels and both PyTorch calls queued behind a
     sleep, so the host's launch overhead is hidden), and spgemm_plan's host seconds
     on the native and the numpy symbolic pass at 4096^2 at 1 %; ms per
     Jacobi-CG and AMG-CG iteration on laplace3d_64, a torch.profiler
     breakdown of AMG-CG iterations, dia_spmv at the level-1 and level-2
     planes (2105 x 31,868 and 2129 x 2,861) on PackedDIA's tile list and
     walking every diagonal, against its plain version, its bound by the
     function's bytes (nonzeros, their positions, x and y), two design
     figures (the whole plane's bytes; the occupied tiles') and
     torch.sparse.mm of the same DIA part as a CSR tensor, x's nonfinite
     check alone, and windowed_segsum on the hierarchy's restriction maps
     beside index_add_; the sharded headline products against one spmm
     (the gap: the all_gather and the layer), the sharded MLP step beside
     phase_train's 'sparse' step, the sharded GCN step, ms an iteration of
     sharded_dia_cg beside linalg.cg on one card;
  7. each phase's wall time, the `kernels` JSON line, then the device JSON
     line, last.

Exits non-zero, printing no result, when no CUDA device is present or the
package is not beside the script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

# fp32 tier tolerance of the JAX suite (CLAUDE.md "Conventions"). Kernel and
# plain version sum in different orders, both in fp32.
TOL_FP32 = dict(rtol=1e-4, atol=5e-5)
# C written in bf16: two fp32 sums a few ulps apart can round to adjacent
# bf16 values, one bf16 ulp being 2^-8..2^-7 of the value.
TOL_BF16_OUT = dict(rtol=1e-2, atol=1e-3)
HEADLINE_TOL = 1e-5  # max |kernel - plain| / max(|plain|, 1)
# gemm 'default' at 4096^3 against its plain version (the same bf16-rounded
# operands, fp32 sums): exact products summed in another order, the tensor
# cores' against cuBLAS's, over 4096 terms
GEMM_DEFAULT_TOL = 1e-4
# gemm of bf16 operands at 4096^3, C written in bf16, against its plain
# version: the same sums rounded to bf16 sit at most one bf16 ulp (2^-8..2^-7
# of a value) apart, over scale
GEMM_BF16_OUT_TOL = 1e-2
# NVIDIA H100 SXM datasheet peaks (dense, at the 700 W limit).
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
TILE_ROWS = 32  # the rows of a dia_spmv tile
TRAIN_STEPS = 20
PARITY_STEPS = 3
# kernel launches of one training step, by variant (fc1, fc2 forward;
# fc2's dB; both layers' dW; fc1's input is the data, so no dB for it)
NO_FLASH = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
NO_BLK = {"blk_flash_fwd": 0, "blk_flash_dq": 0, "blk_flash_dkv": 0}
NO_INT8 = {"spmm_int8": 0, "int8_kmajor": 0, "gemm_s8": 0, "flash_q8": 0}
# every kernel's count, all 0
NO_WINDOWED = {"windowed_gather": 0, "windowed_segsum": 0}
NO_LAUNCH = {"block_ell_spmm": 0, "sddmm": 0, "gemm": 0, **NO_FLASH, **NO_BLK, **NO_INT8,
             "naive_spmm": 0, "resident_spmm_batched": 0, "compact_spmm": 0,
             "grouped_spmm": 0, "footprint_spmm": 0, **NO_WINDOWED, "dia_spmv": 0,
             "dia_nonfinite": 0}
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
# Times of the kernels before their redesign (FFMA flash_q8; shared-memory
# footprint accumulators; the grouped executor's thread block per group; the
# FFMA gemm; the FFMA flash_fwd; the unpipelined spmm_int8; the FFMA
# blk_flash_fwd and the whole-row naive_spmm, both behind a sleep; the FFMA
# block_ell_spmm and sddmm; the FFMA blk_flash_dq and blk_flash_dkv,
# queued; the FFMA batched and compact executors; the FFMA forwards at d
# 256, queued; the FFMA flash_dq and flash_dkv, and blk_flash_dq and
# blk_flash_dkv, at d 256, queued), ms,
# measured by this script on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md:
# its kernel table, rows 1-11, 13-19, §5 for bert4d's dA, and an earlier
# run for the seq-4096 shape);
# printed beside the new. SHARED_TILE_MS: the
# footprint executor's times on its register windows before the tile moved
# into window_tiles.cuh, which the shared tile must stay within 9 % of.
OLD_MS = {"flash_q8 (8, 16, 512, 64)": 0.292, "flash_q8 (2, 12, 4096, 64)": 4.793,
          "flash_q8 d 256": 0.414, "footprint_spmm headline": 21.870,
          "footprint_spmm low-fill": 7.981, "grouped_spmm headline": 15.112,
          "grouped_spmm low-fill": 25.642, "gemm 4096^3 high": 6.969,
          "flash_fwd (8, 12, 512, 64) high": 0.331, "spmm_int8 headline": 0.411,
          "flash_dq (8, 12, 512, 64) high": 0.435, "flash_dkv (8, 12, 512, 64) high": 0.508,
          "blk_flash_fwd bigbird_512 high": 0.2783, "naive_spmm arxiv n 256": 0.8871,
          "blk_flash_dq bigbird_512 high": 0.340, "blk_flash_dkv bigbird_512 high": 0.447,
          "block_ell_spmm headline": 1.494, "sddmm headline": 1.280, "sddmm bert4d": 40.26,
          "resident_spmm_batched block-sparse batched": 0.822,
          "resident_spmm_batched bert4d": 5.962, "compact_spmm headline": 1.501,
          "compact_spmm low-fill": 2.882, "flash_fwd d 256 high": 0.573,
          "blk_flash_fwd d 256 high": 0.428, "flash_dq d 256": 0.8606,
          "flash_dkv d 256": 1.0665, "blk_flash_dq d 256": 0.7430,
          "blk_flash_dkv d 256": 0.8159}
SHARED_TILE_MS = {"footprint_spmm headline": 1.160, "footprint_spmm low-fill": 0.868}
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


def time_ms_ahead(fn, reps: int = 20, warmup: int = 3, iters: int = 5) -> float:
    """Median device time per call of `fn` over `reps` back-to-back calls
    between two CUDA events, queued behind a sleep kernel that lasts twice
    the host's time to enqueue them: the card runs the calls with no wait on
    the host between them (launch gaps on the card included). For calls
    whose host overhead exceeds their kernels' time, where `time_ms_queued`
    would time the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(2 * host_s, 1e-3) * 2e9)  # at most ~2 GHz: at least twice the host time
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak: float = FP32_FLOPS):
    """(bound ms, 'operations' or 'bytes') on a compute peak (default the
    fp32 FFMA one) and the HBM peak."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bound_fp32(flops: float, nbytes: float):
    """An fp32 'high' product's bound on this card's fp32-class route,
    3xTF32 (three tf32 passes at TF32_FLOPS), and the HBM peak: (bound ms,
    'operations' or 'bytes', the FFMA figure in ms, a design figure)."""
    ms, by = bound(3 * flops, nbytes, TF32_FLOPS)
    return ms, by, bound(flops, nbytes)[0]


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


def _demangle(names):
    """{mangled: the kernel's name and template arguments} by c++filt where
    the machine has it."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {n: n for n in names}
    return {n: d.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
            for n, d in zip(names, out)}


def phase_build() -> None:
    """Builds every source; prints ptxas's registers, stack and spills for
    each kernel instance."""
    from tpusparse_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build(_build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        rows, fn = [], None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and ("Used" in line or "spill" in line):
                rows.append((fn, line.split(":", 1)[-1].strip()))
        names = _demangle(sorted({f for f, _ in rows}))
        for f, line in rows:
            print(f"  ptxas {name} {names[f]}: {line}")


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
        ("bm64_bk16_n64_fp32_high", (300, 200, 64), (64, 16), 0.15, None, f32, f32, "high"),
        ("bm200_bk8_n5_fp32_high", (610, 150, 5), (200, 8), 0.15, (200, 400), f32, f32, "high"),
        ("bm128_bk32_n1_fp32_default", (260, 300, 1), (128, 32), 0.15, None, f32, f32,
         "default"),
        ("bm128_bk128_n512_fp32_high", (400, 520, 512), (128, 128), 0.1, None, f32, f32, "high"),
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
        if not torch.equal(out_t, tiled_spmm_kernel(plan, bv, b, precision=prec)):
            raise AssertionError(f"{name}: a second call differs from the first")
        if out_t.dtype != ref.dtype or out_t.shape != (m, n):
            raise AssertionError(f"{name}: got {out_t.dtype} {tuple(out_t.shape)}")
        _check_case(name, out_t, ref, ", entry points and two calls bitwise equal")


def phase_small_sddmm() -> None:
    import tpusparse_torch as tt
    from tpusparse_torch.kernels import sddmm as sk
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
        ("sddmm_bm64_bk16_n64_fp32_high", (300, 200, 64), (64, 16), 0.15, None, f32, "high"),
        ("sddmm_bm200_bk8_n5_fp32_default", (610, 150, 5), (200, 8), 0.15, (200, 400), f32,
         "default"),
        ("sddmm_bm128_bk128_n512_fp32_high", (400, 520, 512), (128, 128), 0.1, None, f32,
         "high"),
        # 4 valid slots and pad slots over n = 65,536: split into ranges of n
        ("sddmm_split_n65536_fp32_high", (384, 256, 65536), (128, 128), 0.15, (128, 256), f32,
         "high"),
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
        if not torch.equal(got, sddmm_kernel(plan, dc, b, precision=prec)):
            raise AssertionError(f"{name}: a second call differs from the first")
        splits = sk.sddmm_splits(sk.sddmm_tiles(plan), n, sk._sm_count(0))
        extra = (f", {int(pad.sum())} pad slots exactly 0, two calls bitwise equal, {splits} "
                 "range(s) of n")
        if splits == 1:
            _check_case(name, got, ref, extra)
            continue
        # a sum over n = 65,536: held against float64, whose distance from the
        # fp32 plain version is printed beside it
        want = _sddmm_f64(plan, dc, b)
        rel, plain_rel = over_scale(got, want)[1], over_scale(ref, want)[1]
        ok = rel <= HEADLINE_TOL and bool(torch.isfinite(got).all())
        print(f"case {name}: {rel:.3e} of scale vs float64 (limit {HEADLINE_TOL}; the plain "
              f"version {plain_rel:.3e}){extra}, {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with float64")


def phase_small_gemm() -> None:
    """gemm against its plain version at (100, 70, 33) (132-byte rows: the
    element-load path) in fp32 'high' and 'default' and bf16 'high' and
    'default', and at the MLP's last layer, (32, 10, 256) with n = 10, in
    fp32 'high' and 'default'; all four transpose pairs each; every case
    run twice and required bitwise equal."""
    from tpusparse_torch.kernels.gemm import _gemm_plain, gemm_kernel

    rng = np.random.default_rng(200)
    cases = [((100, 70, 33), dt, prec) for dt, prec in (
        (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
        (torch.bfloat16, "default"))]
    cases += [((32, 10, 256), torch.float32, prec) for prec in ("high", "default")]
    for (m, n, k), dt, prec in cases:
        for transa, transb in ((False, False), (True, False), (False, True), (True, True)):
            a = rng.standard_normal((k, m) if transa else (m, k)).astype(np.float32)
            b = rng.standard_normal((n, k) if transb else (k, n)).astype(np.float32)
            a = torch.from_numpy(a).to("cuda", dt)
            b = torch.from_numpy(b).to("cuda", dt)
            got = gemm_kernel(a, b, transa=transa, transb=transb, precision=prec)
            again = gemm_kernel(a, b, transa=transa, transb=transb, precision=prec)
            ref = _gemm_plain(a, b, transa=transa, transb=transb, precision=prec)
            torch.cuda.synchronize()
            if got.dtype != dt or got.shape != (m, n):
                raise AssertionError(f"gemm: got {got.dtype} {tuple(got.shape)}")
            name = (f"gemm_{m}x{n}x{k}_ta{int(transa)}_tb{int(transb)}_"
                    f"{str(dt).split('.')[1]}_{prec}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two identical calls differ")
            _check_case(name, got, ref, ", two calls bitwise equal")


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
    """Each flash kernel against its plain version at small shapes, in every
    tier, with fp32 and with bf16 inputs."""
    # name, (bh, s, d), causal, q_offset, kv_offset; "offsets" is rows
    # 256:512 of a 512-long causal attention against keys 0:256
    # (tests/test_attention.py:290); "kv_ahead" has rows that see no key
    # and spans nine 128-row q-tiles. (s = 1 is a card-only test: its dq and
    # dk are 0 up to rounding, which no over-scale limit can hold.)
    cases = [
        ("2x3x256x64", (6, 256, 64), False, 0, 0),
        ("causal_1x2x384x64", (2, 384, 64), True, 0, 0),
        ("ragged_1x1x200x64", (1, 200, 64), False, 0, 0),
        ("narrow_2x4x128x24", (8, 128, 24), False, 0, 0),
        ("wide_1x2x128x128", (2, 128, 128), True, 0, 0),
        ("offsets_1x1x256x64_q256", (1, 256, 64), True, 256, 0),
        ("ragged_d_1x3x150x20", (3, 150, 20), False, 0, 0),
        ("kv_ahead_1x2x1030x64_kv300", (2, 1030, 64), True, 0, 300),
    ]
    tiers = ((torch.float32, "high"), (torch.float32, "highest"), (torch.float32, "default"),
             (torch.bfloat16, "high"), (torch.bfloat16, "default"))
    for seed, (name, shape, causal, q_off, kv_off) in enumerate(cases):
        for dtype, prec in tiers:
            q, k, v, do = _flash_operands(shape, 300 + seed, dtype)
            kw = dict(sm_scale=1 / shape[-1] ** 0.5, causal=causal, q_offset=q_off,
                      kv_offset=kv_off, precision=prec)
            got, want = _flash_pair(q, k, v, do, kw)
            _check_attention_case(f"flash_{name}_{str(dtype).split('.')[1]}_{prec}",
                                  got, want, dtype == torch.bfloat16 or prec == "default")
            blind = min(max(kv_off - q_off, 0), shape[1])  # rows that see no key
            if blind and not (torch.count_nonzero(got[0][:, :blind]) == 0
                              and bool((got[1][:, :blind] == -1e30).all())):
                raise AssertionError(f"flash {name}: rows that see no key are not 0, -1e30")


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
    at blocks 64, 64x32, 128x256 and 256 with s on and off the block (one
    without global keys, whose rows past the band's start find their first
    listed sub-tile wholly masked), and the 'sparse' layer's plan at seq
    4096 (what its router builds)."""
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
        "band_masked_first_empty_256_b64": (256, 64, 64, 20, 0),
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
    "band_masked_first_empty_256_b64": (2, 96),
    "band_masked_unpadded_160_b64x32": (2, 24),
    "band_masked_512_b128x256": (2, 128),
    "band_masked_unpadded_1000_b256": (2, 64),
    "sparse_layer_4096_b256": (2, 64),
}


def phase_small_block_flash() -> None:
    """Each block-pattern kernel against its plain version on every kind of
    plan, in fp32 'high' and 'default' and with bf16 inputs; the forward of
    every run and dq, dk and dv of the fp32 'high' run repeated and required
    bitwise equal."""
    from tpusparse_torch.kernels import block_flash_attention as bfa

    for seed, (name, (bh, d)) in enumerate(BLK_SMALL_CASES.items()):
        plan = _blk_plan(name)
        kind = "masked" if plan.tile_masks is not None else "mask-free"
        for dtype, prec in ((torch.float32, "high"), (torch.float32, "default"),
                            (torch.bfloat16, "high")):
            q, k, v, do = _flash_operands((bh, plan.seq, d), 700 + seed, dtype)
            kw = dict(sm_scale=1 / d ** 0.5, precision=prec)
            got, want = _blk_pair(q, k, v, do, plan, kw)
            again = bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got[:2], again)):
                raise AssertionError(f"blk_{name}: the forward does not repeat bit for bit")
            extra = ", o/lse repeat bitwise"
            if dtype == torch.float32 and prec == "high":
                lse, delta = got[1], _delta(do, got[0])
                again = (bfa.blk_flash_dq_kernel(q, k, v, do, lse, delta, plan, **kw),
                         *bfa.blk_flash_dkv_kernel(q, k, v, do, lse, delta, plan, **kw))
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got[2:], again)):
                    raise AssertionError(f"blk_{name}: dq, dk, dv do not repeat bit for bit")
                extra = ", o/lse/dq/dk/dv repeat bitwise"
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


def phase_wide_bigbird() -> dict:
    """`BigBirdAttention` at WIDE_BIGBIRD's widths, batch and seq, from one
    seed on the card and on the CPU (the card's module loaded from the CPU
    module's state dict): the forward, then the backward of one upstream
    gradient, with the launch counts set to 0 just before and read just
    after (1 blk_flash_fwd, 1 blk_flash_dq, 1 blk_flash_dkv and no other
    kernel); the output and the input's gradient on the card against the
    CPU at the fp32 tier; then the step's time on the card, a profile of
    the step (its block kernels' share of the device time) and the three
    block kernels alone at the step's shape. Returns the launches."""
    import tpusparse_torch as tt
    from tpusparse_torch import kernels

    cfg = WIDE_BIGBIRD
    b, s = cfg["batch"], cfg["seq"]
    mods = {"cpu": tt.BigBirdAttention(cfg["num_heads"], cfg["head_dim"], block=cfg["block"],
                                       hidden=cfg["hidden"], device="cpu",
                                       generator=torch.Generator().manual_seed(26))}
    mods["cuda"] = tt.BigBirdAttention(cfg["num_heads"], cfg["head_dim"], block=cfg["block"],
                                       hidden=cfg["hidden"], device="cuda")
    mods["cuda"].load_state_dict(mods["cpu"].state_dict())
    rng = np.random.default_rng(26)
    x, g = (torch.from_numpy(rng.standard_normal((b, s, cfg["hidden"]), dtype=np.float32))
            for _ in range(2))
    plan = mods["cuda"].plan(s)  # drawn once, on the host
    xs = {d: x.detach().to(d).requires_grad_(True) for d in mods}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = mods["cuda"](xs["cuda"])
    out.backward(g.cuda())
    torch.cuda.synchronize()
    counts = _launches()
    expect = {**NO_LAUNCH, "blk_flash_fwd": 1, "blk_flash_dq": 1, "blk_flash_dkv": 1}
    if counts != expect:
        raise AssertionError(f"wide bigbird attention: launches {counts}, expected {expect}")
    want = mods["cpu"](xs["cpu"])
    want.backward(g)
    label = (f"wide bigbird attention (hidden {cfg['hidden']}, {cfg['num_heads']} heads of "
             f"{cfg['head_dim']}, block {cfg['block']}, batch {b}, seq {s}; "
             f"{plan.covered_tiles} of {plan.nq * plan.nk} tiles)")
    errs = {}
    for name, got_, want_ in (("output", out, want), ("input grad", xs["cuda"].grad,
                                                       xs["cpu"].grad)):
        got_ = got_.detach().cpu()
        errs[name] = float((got_ - want_.detach()).abs().max())
        if not (got_.shape == want_.shape and bool(torch.isfinite(got_).all())
                and torch.allclose(got_, want_.detach(), **TOL_FP32)):
            raise AssertionError(f"{label}: card vs CPU {name} max_abs_err {errs[name]:.3e}")
    gc = g.cuda()

    def step():
        xs["cuda"].grad = None
        mods["cuda"](xs["cuda"]).backward(gc)

    ms = time_ms(step)
    print(f"{label}: launches {json.dumps(_only(counts, BLK))}; card vs CPU max_abs_err "
          f"output {errs['output']:.3e}, input grad {errs['input grad']:.3e} (rtol "
          f"{TOL_FP32['rtol']}, atol {TOL_FP32['atol']}), ok; forward + backward {ms:.4f} ms")
    # where the step's device time goes, and the three block kernels alone at
    # the step's own shape and plan
    by_name = _profile(label, step, 3, top=10)
    blk_ms = sum(t for n_, t in by_name.items() if "blk_" in n_)
    if by_name:
        busy = sum(by_name.values())
        print(f"{label}: device busy {busy:.4f} ms a step, its block kernels {blk_ms:.4f} ms "
              f"({blk_ms / busy:.1%}), the rest {busy - blk_ms:.4f} ms")
    _bigbird_kernels_alone(label, (b * cfg["num_heads"], s, cfg["head_dim"]), plan)
    return _only(counts, BLK)


def _bigbird_kernels_alone(label, shape, plan) -> None:
    """blk_flash_fwd, blk_flash_dq and blk_flash_dkv queued at `shape` on
    `plan` in the module's tier, on operands from a seed."""
    from tpusparse_torch.kernels import block_flash_attention as bfa

    q, k, v, do = _flash_operands(shape, 1600)
    kw = dict(sm_scale=1 / shape[-1] ** 0.5, precision=bfa.resolve_precision(None))
    o, lse = bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw)
    args = (q, k, v, do, lse, _delta(do, o), plan)
    ms = {"blk_flash_fwd": time_ms_queued(lambda: bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw)),
          "blk_flash_dq": time_ms_queued(lambda: bfa.blk_flash_dq_kernel(*args, **kw)),
          "blk_flash_dkv": time_ms_queued(lambda: bfa.blk_flash_dkv_kernel(*args, **kw))}
    print(f"{label}: the block kernels alone at {shape} fp32 '{kw['precision']}', queued: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items())
          + f"; together {sum(ms.values()):.4f} ms")


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


def _flash_fwd_times(label, q, k, v, shape, causal=False) -> None:
    """flash_fwd at one shape in its three tiers: fp32 'high' (3xTF32)
    against fp32 SDPA, fp32 'default' and bf16 operands against bf16 SDPA
    on bf16 copies of q, k, v; each checked against its plain version
    first, each bound on its tier's tensor-core rate."""
    from torch.nn.attention import sdpa_kernel

    from tpusparse_torch.kernels import flash_attention as fa
    from tpusparse_torch.utils.config import fp32_matmul

    b, h, seq, d = shape
    bh = b * h
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    flops = 4.0 * bh * d * (seq * (seq + 1) / 2 if causal else seq * seq)
    stats = 4.0 * bh * seq
    sdpa_ms = {}
    for tname, ops in (("fp32", (q, k, v)), ("bf16", (qb, kb, vb))):
        o4 = [x.view(b, h, seq, d) for x in ops]
        backend = _sdpa_backend(*o4)
        with sdpa_kernel([backend]), fp32_matmul():
            sdpa_ms[tname] = (time_ms_queued(lambda: sdpa(*o4, is_causal=causal)), backend.name)
    for tier, ops, prec in (("fp32 'high'", (q, k, v), "high"),
                            ("fp32 'default'", (q, k, v), "default"),
                            ("bf16 operands", (qb, kb, vb), "high")):
        kw = dict(sm_scale=1 / d ** 0.5, causal=causal, precision=prec)
        got, want = fa.flash_fwd_kernel(*ops, **kw), fa._flash_fwd_plain(*ops, **kw)
        err = max(rel_err(got[0], want[0])[1], rel_err(got[1], want[1])[1])
        limit = FLASH_LIMIT_FP32 if prec == "high" and ops[0].dtype == torch.float32 \
            else FLASH_LIMIT_ROUNDED
        if not (err <= limit and bool(torch.isfinite(got[0].float()).all())):
            raise AssertionError(f"flash_fwd {label} {tier}: kernel vs plain {err:.2e}")
        del got, want
        ms = time_ms_queued(lambda: fa.flash_fwd_kernel(*ops, **kw))
        nbytes = 4 * ops[0].element_size() * bh * seq * d + stats
        if prec == "high" and ops[0].dtype == torch.float32:
            bms, by, ffma = bound_fp32(flops, nbytes)
            lib_type, design = "fp32", f"; FFMA design figure {ffma:.4f} ms"
        else:
            (bms, by), lib_type, design = bound(flops, nbytes, BF16_FLOPS), "bf16", ""
        lib, lname = sdpa_ms[lib_type]
        old = OLD_MS.get(f"flash_fwd {shape} high") if tier == "fp32 'high'" else None
        was = f" (the FFMA kernel before its redesign {old:.3f}: {old / ms:.2f}x)" if old else ""
        print(f"flash_fwd {label} {shape} causal={causal} {tier}: kernel {ms:.4f} ms queued"
              f"{was}, sdpa {lib_type} ({lname}) "
              f"{lib:.4f} ms (kernel/sdpa {ms / lib:.2f}); bound {bms:.4f} ms by {by} "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB{design}), kernel at "
              f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, {bms / ms:.3f} of its bound; "
              f"vs plain {err:.2e} of scale")


def _flash_bwd_times(label, q, k, v, do, shape) -> None:
    """flash_dq and flash_dkv at one shape in 'default' (fp32 operands) and
    on bf16 operands, each checked against its plain version first, the
    pair against bf16 SDPA's autograd backward; bound on bf16 tensor cores.
    All behind a sleep (`time_ms_ahead`): an autograd backward queued from
    the host can take longer to enqueue than to run."""
    from torch.nn.attention import sdpa_kernel

    from tpusparse_torch.kernels import flash_attention as fa

    b, h, seq, d = shape
    bh = b * h
    qb, kb, vb, dob = (x.to(torch.bfloat16) for x in (q, k, v, do))
    o4 = [x.view(b, h, seq, d).detach().clone().requires_grad_(True) for x in (qb, kb, vb)]
    backend = _sdpa_backend(*o4)
    with sdpa_kernel([backend]):
        og = torch.nn.functional.scaled_dot_product_attention(*o4)
        lib = time_ms_ahead(lambda: torch.autograd.grad(og, o4, dob.view(b, h, seq, d),
                                                        retain_graph=True))
    del og, o4
    stats = 2 * 4.0 * bh * seq
    for tier, ops, prec in (("fp32 'default'", (q, k, v, do), "default"),
                            ("bf16 operands", (qb, kb, vb, dob), "high")):
        kw = dict(sm_scale=1 / d ** 0.5, causal=False, precision=prec)
        o, lse = fa.flash_fwd_kernel(*ops[:3], **kw)
        delta = (ops[3].float() * o.float()).sum(-1)
        args = (*ops, lse, delta)
        got = (fa.flash_dq_kernel(*args, **kw), *fa.flash_dkv_kernel(*args, **kw))
        want = (fa._flash_dq_plain(*args, **kw), *fa._flash_dkv_plain(*args, **kw))
        err = max(rel_err(g, w)[1] for g, w in zip(got, want))
        if not (err <= FLASH_LIMIT_ROUNDED and all(bool(torch.isfinite(g.float()).all())
                                                   for g in got)):
            raise AssertionError(f"flash backward {label} {tier}: kernel vs plain {err:.2e}")
        del got, want
        ms = {"dq": time_ms_ahead(lambda: fa.flash_dq_kernel(*args, **kw)),
              "dkv": time_ms_ahead(lambda: fa.flash_dkv_kernel(*args, **kw))}
        esz = ops[0].element_size()
        work = {"dq": (6.0 * bh * seq * seq * d, 5 * esz * bh * seq * d + stats),
                "dkv": (8.0 * bh * seq * seq * d, 6 * esz * bh * seq * d + stats)}
        for kname, (flops, nbytes) in work.items():
            bms, by = bound(flops, nbytes, BF16_FLOPS)
            print(f"flash_{kname} {label} {shape} {tier}: kernel {ms[kname]:.4f} ms behind a sleep, "
                  f"bound {bms:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP at bf16), kernel at "
                  f"{flops / (ms[kname] * 1e-3) / 1e12:.2f} TFLOP/s, {bms / ms[kname]:.3f} of "
                  f"its bound")
        pair = ms["dq"] + ms["dkv"]
        print(f"flash backward {label} {shape} {tier}: flash_dq + flash_dkv {pair:.4f} ms, "
              f"sdpa bf16 ({backend.name}) autograd backward {lib:.4f} ms ({pair / lib:.2f}x "
              f"sdpa); vs plain {err:.2e} of scale")
        del o, lse, delta, args


def _flash_bwd_long(label, q, k, v, do, shape) -> None:
    """flash_dq and flash_dkv at the long-seq shape in fp32 'high': dq, dk
    and dv against the plain version and against float64 (an fp32 plain
    sum over seq terms carries its own error), each within
    FLASH_LIMIT_FP32 of scale; both kernels timed, the pair beside SDPA's
    fp32 autograd backward."""
    from torch.nn.attention import sdpa_kernel

    from tpusparse_torch.kernels import flash_attention as fa
    from tpusparse_torch.utils.config import fp32_matmul

    b, h, seq, d = shape
    kw = dict(sm_scale=1 / d ** 0.5, causal=False, precision="high")
    o, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta)
    got = (fa.flash_dq_kernel(*args, **kw), *fa.flash_dkv_kernel(*args, **kw))
    plain = (fa._flash_dq_plain(*args, **kw), *fa._flash_dkv_plain(*args, **kw))
    f64 = _flash_bwd_f64(*args, sm_scale=kw["sm_scale"])
    errs = {n: (rel_err(g, p)[1], rel_err(g, w)[1], rel_err(p, w)[1])
            for n, g, p, w in zip(("dq", "dk", "dv"), got, plain, f64)}
    if not all(e[0] <= FLASH_LIMIT_FP32 and e[1] <= FLASH_LIMIT_FP32 for e in errs.values()):
        raise AssertionError(f"flash backward {label}: kernel vs plain, float64 {errs}")
    del got, plain, f64
    ms = {"dq": time_ms_queued(lambda: fa.flash_dq_kernel(*args, **kw)),
          "dkv": time_ms_queued(lambda: fa.flash_dkv_kernel(*args, **kw))}
    q4, k4, v4 = (x.view(b, h, seq, d).detach().clone().requires_grad_(True) for x in (q, k, v))
    backend = _sdpa_backend(q4, k4, v4)
    with sdpa_kernel([backend]), fp32_matmul():
        og = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
        lib = time_ms_queued(lambda: torch.autograd.grad(og, (q4, k4, v4), do.view(b, h, seq, d),
                                                         retain_graph=True))
    print(f"flash backward {label} {shape} fp32 'high': flash_dq {ms['dq']:.4f} ms, flash_dkv "
          f"{ms['dkv']:.4f} ms queued, pair {ms['dq'] + ms['dkv']:.4f} ms, sdpa fp32 "
          f"({backend.name}) autograd backward {lib:.4f} ms; over scale (kernel vs plain, "
          f"kernel vs float64, plain vs float64) " + ", ".join(
              f"{n} {e[0]:.2e} {e[1]:.2e} {e[2]:.2e}" for n, e in errs.items()))


def _flash_bwd_f64(q, k, v, do, lse, delta, *, sm_scale):
    """dq, dk, dv of non-causal attention in float64 from the kernels' lse
    and delta, q pre-scaled in fp32 as the kernels take it, one head at a
    time."""
    outs = [], [], []
    for i in range(q.shape[0]):
        qs = (q[i] * sm_scale).double()
        kd, vd, dod = k[i].double(), v[i].double(), do[i].double()
        p = torch.exp(qs @ kd.T - lse[i].double()[:, None])
        ds = p * (dod @ vd.T - delta[i].double()[:, None])
        for acc, x in zip(outs, ((ds @ kd) * sm_scale, ds.T @ qs, p.T @ dod)):
            acc.append(x)
    return tuple(torch.stack(x) for x in outs)


def phase_flash_timings() -> dict:
    """The three kernels, their plain versions and bounds, and SDPA in fp32,
    at the BERT-base attention shapes; the forward also in 'default' and on
    bf16 operands, at (2, 12, 4096, 64) and at GPT's fused shape (8 x 16,
    512, 64) causal; returns {seq: results}."""
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
        r["bound"] = {kname: bound_fp32(*wk) for kname, wk in work.items()}
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
            r["sdpa_bwd_ahead_ms"] = time_ms_ahead(
                lambda: torch.autograd.grad(og, (qg, kg, vg), do4, retain_graph=True))
        r["sdpa_backend"] = backend.name
        out[seq] = r
        for kname in ("fwd", "dq", "dkv"):
            bms, by, ffma = r["bound"][kname]
            flops = work[kname][0]
            old = OLD_MS.get(f"flash_{kname} {(b, h, seq, d)} high")
            was = (f" (the FFMA kernel before its redesign {old:.3f}: "
                   f"{old / r['ms'][kname]:.2f}x)" if old else "")
            print(f"flash_{kname} ({b}, {h}, {seq}, {d}) fp32 'high': kernel "
                  f"{r['ms'][kname]:.4f} ms queued{was} ({r['one_call_ms'][kname]:.4f} ms one "
                  f"call), plain {r['plain_ms'][kname]:.4f} ms, bound "
                  f"{bms:.4f} ms by {by} (3xTF32: 3 x {flops / 1e9:.2f} GFLOP at 495 TFLOP/s; "
                  f"{work[kname][1] / 1e6:.1f} MB; FFMA design figure {ffma:.4f} ms), "
                  f"kernel at {flops / (r['ms'][kname] * 1e-3) / 1e12:.2f} TFLOP/s")
        print(f"flash ({b}, {h}, {seq}, {d}): kernel vs plain over scale " + ", ".join(
            f"{n} {e[1]:.2e}" for n, e in errs.items()))
        pair = r["ms"]["dq"] + r["ms"]["dkv"]
        print(f"sdpa ({b}, {h}, {seq}, {d}) fp32, backend {backend.name}: forward "
              f"{r['sdpa_fwd_ms']:.4f} ms (vs kernel o {lib_err:.2e} of scale), autograd "
              f"backward (dq, dk, dv) {r['sdpa_bwd_ms']:.4f} ms queued, "
              f"{r['sdpa_bwd_ahead_ms']:.4f} ms behind a sleep; flash_dq + flash_dkv "
              f"{pair:.4f} ms ({pair / r['sdpa_bwd_ms']:.2f}x sdpa)")
        del qg, kg, vg, og, q4, k4, v4, do4
        _flash_fwd_times("bert", q, k, v, (b, h, seq, d))
        _flash_bwd_times("bert", q, k, v, do, (b, h, seq, d))
        del q, k, v, do
    # the long-seq backward against float64: 64 tiles on each axis, so the
    # 3xTF32 sums are banked
    q, k, v, do = _flash_operands((2 * h, LONG_SEQ, d), 520)
    _flash_bwd_long("long", q, k, v, do, (2, h, LONG_SEQ, d))
    del q, k, v, do
    # the long-seq shape and GPT's fused forward (one layer's call)
    for label, shape, causal in (("long", (2, h, LONG_SEQ, d), False),
                                 ("gpt", (8, GPT["num_heads"], GPT_FUSED_SEQ,
                                          GPT["hidden"] // GPT["num_heads"]), True)):
        q, k, v, _ = _flash_operands((shape[0] * shape[1], *shape[2:]), 510 + shape[2])
        _flash_fwd_times(label, q, k, v, shape, causal)
        del q, k, v
    return out


def phase_bert_profile(seq: int = 512, steps: int = 3) -> None:
    """Where a layer's training step spends the card's time: torch.profiler
    over `steps` steps of each variant at batch 8; prints the device's busy
    and idle share of the span from the first to the last kernel, and the
    kernels that take the most time."""
    import tpusparse_torch as tt

    x = _bert_input(BERT_BATCH, seq, 40 + seq).cuda()
    for attention in ("flash", "dense", "bigbird"):
        layer = _bert_layer(attention, "cuda")
        opt = tt.make_train_state(layer)
        for _ in range(2):
            tt.bert_train_step(layer, opt, x)
        _profile(f"bert layer {attention} seq {seq} batch {BERT_BATCH}",
                 lambda: tt.bert_train_step(layer, opt, x), steps)


def _profile(label, step, steps, top=8) -> dict:
    """torch.profiler over `steps` calls of `step`, after one call that the
    profiler runs but does not record (its schedule's warm-up; without it
    the first recorded call can lose its kernels): the device's busy and
    idle share of the span from the first to the last kernel, and the
    kernels that take the most time. Returns each kernel's ms a step by
    name (empty where no device time was recorded)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps)) as prof:
        for i in range(steps + 1):
            step()
            if i == 0 or i == steps:  # the recorded calls queue back to back
                torch.cuda.synchronize()
            if i < steps:  # a step() after the last would close the cycle and drop its events
                prof.step()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]  # the schedule's step spans
    if not kernels:
        print(f"profile {label}: no device time recorded")
        return {}
    busy = sum(e.time_range.end - e.time_range.start for e in kernels)
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    print(f"profile {label}, {steps} steps: {len(kernels)} kernels, device busy "
          f"{busy / 1e3 / steps:.4f} ms per step of a {span / 1e3 / steps:.4f} ms span, idle "
          f"share {1 - busy / span:.3f}")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    for name_, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {t / 1e3 / steps:.4f} ms/step ({t / busy:.1%}) {name_[:90]}")
    return {n: t / 1e3 / steps for n, t in by_name.items()}


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


def _blk_bwd_f64(q, k, v, do, lse, delta, plan, *, sm_scale):
    """dq, dk, dv of the block-pattern attention in float64 from the
    kernels' lse and delta, over the plan's token mask, one head at a time."""
    vis = plan.token_mask(q.device)
    outs = [], [], []
    for i in range(q.shape[0]):
        qd, kd, vd, dod = q[i].double(), k[i].double(), v[i].double(), do[i].double()
        p = torch.where(vis, torch.exp((qd @ kd.T) * sm_scale - lse[i].double()[:, None]), 0.0)
        ds = p * (dod @ vd.T - delta[i].double()[:, None]) * sm_scale
        for acc, x in zip(outs, (ds @ kd, ds.T @ qd, p.T @ dod)):
            acc.append(x)
    return tuple(torch.stack(x) for x in outs)


def _blk_bwd_tiers(label, shape, q, k, v, do, plan, work, r) -> None:
    """blk_flash_dq and blk_flash_dkv in fp32 'default' and on bf16
    operands: each checked against its plain version (<= 1e-2 of scale),
    timed queued and behind a sleep, beside bf16 SDPA's autograd backward
    with the token mask behind a sleep; bounds on the bf16 tensor cores or
    bytes."""
    from torch.nn.attention import sdpa_kernel

    from tpusparse_torch.kernels import block_flash_attention as bfa

    b, h, seq, d = shape
    qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (q, k, v, do))
    mask = plan.token_mask(q.device)
    b4 = [t.view(b, h, seq, d).detach().clone().requires_grad_(True) for t in (qb, kb, vb)]
    backend = _sdpa_backend(*b4, mask)
    with sdpa_kernel([backend]):
        og = torch.nn.functional.scaled_dot_product_attention(*b4, attn_mask=mask)
        lib = time_ms_ahead(lambda: torch.autograd.grad(og, b4, dob.view(b, h, seq, d),
                                                        retain_graph=True))
    del og, b4
    r["bwd_tiers"] = {}
    for tier, ops, prec in (("fp32 'default'", (q, k, v, do), "default"),
                            ("bf16 operands", (qb, kb, vb, dob), "high")):
        kw = dict(sm_scale=1 / d ** 0.5, precision=prec)
        o, lse = bfa.blk_flash_fwd_kernel(*ops[:3], plan, **kw)
        args = (*ops, lse, _delta(ops[3], o), plan)
        got = (bfa.blk_flash_dq_kernel(*args, **kw), *bfa.blk_flash_dkv_kernel(*args, **kw))
        want = (bfa._blk_dq_plain(*args, **kw), *bfa._blk_dkv_plain(*args, **kw))
        err = max(rel_err(g, w)[1] for g, w in zip(got, want))
        if not (err <= FLASH_LIMIT_ROUNDED and all(bool(torch.isfinite(g.float()).all())
                                                   for g in got)):
            raise AssertionError(f"block backward {label} {tier}: kernel vs plain {err:.2e}")
        del got, want
        fns = {"dq": lambda: bfa.blk_flash_dq_kernel(*args, **kw),
               "dkv": lambda: bfa.blk_flash_dkv_kernel(*args, **kw)}
        ms = {n: (time_ms_queued(f), time_ms_ahead(f)) for n, f in fns.items()}
        r["bwd_tiers"][tier] = (ms, err)
        for n, (queued, ahead) in ms.items():
            flops, nbytes = work[n]
            if "bf16" in tier:  # q, k, v, do and the outputs in 2 bytes, not 4
                nbytes -= (5 if n == "dq" else 6) * 2.0 * b * h * seq * d
            bms, by = bound(flops, nbytes, BF16_FLOPS)
            print(f"blk_flash_{n} {label} {tier}: kernel {queued:.4f} ms queued, {ahead:.4f} ms "
                  f"behind a sleep; bound {bms:.4f} ms by {by} (bf16 tensor cores), kernel at "
                  f"{flops / (ahead * 1e-3) / 1e12:.2f} TFLOP/s, {bms / ahead:.3f} of its "
                  f"bound")
        pair = ms["dq"][1] + ms["dkv"][1]
        print(f"blk_flash backward {label} {tier} behind a sleep: dq + dkv {pair:.4f} ms, sdpa "
              f"bf16 ({backend.name}) autograd backward with the token mask {lib:.4f} ms "
              f"({pair / lib:.2f}x sdpa); vs plain {err:.2e} of scale")
        del o, lse, args, fns
    r["sdpa_bf16_bwd_ms"] = lib


def phase_block_flash_timings() -> dict:
    """The three block kernels at the 'bigbird' layer's shapes (seq 512,
    block 64; seq 4096, block 256) and at the 'sparse' layer's masked
    seq-4096 plan: kernel vs plain (<= 1e-5 of scale; the backward at seq
    4096 also against float64), times, bounds from the covered tiles, and
    SDPA with the token-exact boolean mask in fp32; the backward also in
    'default' and on bf16 operands beside bf16 SDPA (`_blk_bwd_tiers`);
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
        if seq == LONG_SEQ:
            # long lists: 16 listed blocks of 256 for the global rows and
            # keys, so the 3xTF32 sums are banked; an fp32 plain sum over
            # 4096 terms carries an error of its own
            f64 = _blk_bwd_f64(q, k, v, do, lse, delta, plan, sm_scale=kw["sm_scale"])
            errs64 = {n: (rel_err(g, w)[1], rel_err(p, w)[1])
                      for n, g, p, w in zip(("dq", "dk", "dv"), got[2:], want[2:], f64)}
            if not all(e[0] <= FLASH_LIMIT_FP32 for e in errs64.values()):
                raise AssertionError(f"block backward {label}: kernel vs float64 {errs64}")
            print(f"blk_flash backward {label}: over scale against float64 (kernel, plain) "
                  + ", ".join(f"{n} {e[0]:.2e} {e[1]:.2e}" for n, e in errs64.items()))
            del f64
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
        r["bound"] = {n: bound_fp32(*wk) for n, wk in work.items()}
        q4, k4, v4, do4 = (t.view(b, h, seq, d) for t in (q, k, v, do))
        mask = plan.token_mask(q.device)
        backend = _sdpa_backend(q4, k4, v4, mask)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with sdpa_kernel([backend]), fp32_matmul():
            r["sdpa_fwd_ms"] = time_ms_queued(lambda: sdpa(q4, k4, v4, attn_mask=mask))
            # the forward and its yardstick behind a sleep: no host time in either
            r["ahead_ms"] = (time_ms_ahead(fns["fwd"][0]),
                             time_ms_ahead(lambda: sdpa(q4, k4, v4, attn_mask=mask)))
            lib_err = rel_err(sdpa(q4, k4, v4, attn_mask=mask).reshape(bh, seq, d), o)[1]
            qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
            og = sdpa(qg, kg, vg, attn_mask=mask)
            r["sdpa_bwd_ms"] = time_ms_queued(
                lambda: torch.autograd.grad(og, (qg, kg, vg), do4, retain_graph=True))
            r["sdpa_bwd_ahead_ms"] = time_ms_ahead(
                lambda: torch.autograd.grad(og, (qg, kg, vg), do4, retain_graph=True))
        r["bwd_ahead_ms"] = {n: time_ms_ahead(fns[n][0]) for n in ("dq", "dkv")}
        r["sdpa_backend"] = backend.name
        # the forward's other tiers, each checked against its plain version,
        # behind a sleep beside bf16 SDPA with the token mask
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        r["tiers"] = {}
        for tier, ops, prec in (("fp32 'default'", (q, k, v), "default"),
                                ("bf16 operands", (qb, kb, vb), "high")):
            kwt = dict(sm_scale=1 / d ** 0.5, precision=prec)
            g_t = bfa.blk_flash_fwd_kernel(*ops, plan, **kwt)
            w_t = bfa._blk_fwd_plain(*ops, plan, **kwt)
            err = max(rel_err(g_t[0], w_t[0])[1], rel_err(g_t[1], w_t[1])[1])
            if not (err <= FLASH_LIMIT_ROUNDED and bool(torch.isfinite(g_t[0].float()).all())):
                raise AssertionError(f"blk_flash_fwd {label} {tier}: kernel vs plain {err:.2e}")
            del g_t, w_t
            r["tiers"][tier] = (time_ms_ahead(lambda: bfa.blk_flash_fwd_kernel(*ops, plan, **kwt)),
                                err)
        b4 = [t.view(b, h, seq, d) for t in (qb, kb, vb)]
        bf16_backend = _sdpa_backend(*b4, mask)
        with sdpa_kernel([bf16_backend]):
            r["sdpa_bf16_ms"] = time_ms_ahead(lambda: sdpa(*b4, attn_mask=mask))
        out[label] = r
        shape = (f"{label} (bh {bh}, seq {seq}, d {d}, block {plan.block_q}, "
                 f"{plan.covered_tiles} of {plan.nq * plan.nk} tiles"
                 f"{', token-exact masks' if r['masked'] else ''})")
        for n in fns:
            bms, by, ffma = r["bound"][n]
            flops = work[n][0]
            print(f"blk_flash_{n} {shape} fp32 'high': kernel {r['ms'][n]:.4f} ms queued "
                  f"({r['one_call_ms'][n]:.4f} ms one call), plain {r['plain_ms'][n]:.4f} ms, "
                  f"bound {bms:.4f} ms by {by} (3xTF32: 3 x {flops / 1e9:.2f} GFLOP at 495 "
                  f"TFLOP/s; {work[n][1] / 1e6:.1f} MB; FFMA design figure {ffma:.4f} ms), "
                  f"kernel at {flops / (r['ms'][n] * 1e-3) / 1e12:.2f} TFLOP/s, "
                  f"{bms / r['ms'][n]:.3f} of its bound")
        fwd_ms, old = r["ahead_ms"][0], OLD_MS.get(f"blk_flash_fwd {label} high")
        was = f" (the FFMA kernel before its redesign {old:.4f}: {old / fwd_ms:.2f}x)" if old else ""
        print(f"blk_flash_fwd {label} behind a sleep: kernel {fwd_ms:.4f} ms{was}, sdpa "
              f"with the token mask {r['ahead_ms'][1]:.4f} ms (kernel/sdpa "
              f"{fwd_ms / r['ahead_ms'][1]:.2f}); kernel at "
              f"{work['fwd'][0] / (fwd_ms * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{r['bound']['fwd'][0] / fwd_ms:.3f} of its 3xTF32 bound")
        for tier, (ms, err) in r["tiers"].items():
            bms, by = bound(work["fwd"][0], work["fwd"][1] - (2 * qkv_bytes if "bf16" in tier
                                                              else 0), BF16_FLOPS)
            print(f"blk_flash_fwd {label} {tier} behind a sleep: kernel {ms:.4f} ms, sdpa bf16 "
                  f"({bf16_backend.name}) with the token mask {r['sdpa_bf16_ms']:.4f} ms "
                  f"(kernel/sdpa {ms / r['sdpa_bf16_ms']:.2f}); bound {bms:.4f} ms by {by} "
                  f"(bf16 tensor cores), kernel at {work['fwd'][0] / (ms * 1e-3) / 1e12:.2f} "
                  f"TFLOP/s; vs plain {err:.2e} of scale")
        ahead = r["bwd_ahead_ms"]
        for n in ("dq", "dkv"):
            old = OLD_MS.get(f"blk_flash_{n} {label} high")
            was = (f" (the FFMA kernel before its redesign {old:.3f} queued: "
                   f"{old / r['ms'][n]:.2f}x)" if old else "")
            print(f"blk_flash_{n} {label} fp32 'high': kernel {r['ms'][n]:.4f} ms queued{was}, "
                  f"{ahead[n]:.4f} ms behind a sleep, {r['bound'][n][0] / ahead[n]:.3f} of its "
                  f"3xTF32 bound")
        print(f"blk_flash {label}: kernel vs plain over scale " + ", ".join(
            f"{n} {e[1]:.2e}" for n, e in errs.items()))
        pair = ahead["dq"] + ahead["dkv"]
        print(f"sdpa {label} with the token mask, fp32, backend {backend.name}: forward "
              f"{r['sdpa_fwd_ms']:.4f} ms (vs kernel o {lib_err:.2e} of scale), autograd "
              f"backward (dq, dk, dv) {r['sdpa_bwd_ms']:.4f} ms queued, "
              f"{r['sdpa_bwd_ahead_ms']:.4f} ms behind a sleep; blk_flash_dq + blk_flash_dkv "
              f"{pair:.4f} ms behind a sleep ({pair / r['sdpa_bwd_ahead_ms']:.2f}x sdpa)")
        del q4, k4, v4, do4, qg, kg, vg, og, o, lse, delta, fns, qb, kb, vb, b4
        _blk_bwd_tiers(label, (b, h, seq, d), q, k, v, do, plan, work, r)
        del q, k, v, do
    return out


def phase_bert_timings(encoders) -> None:
    """Forward and step times by CUDA events: the layer in each variant and
    shape the main path drives and 'flash' at the long-seq shape, the
    seq-512 variants' steps queued in turns, and the encoders ({attention:
    (encoder, input_ids)})."""
    import tpusparse_torch as tt

    cases = [(v, BERT_BATCH, seq, PATTERN_WINDOW) for seq in BERT_SEQS for v in ("flash", "dense")]
    cases += [(v, BERT_BATCH, 512, PATTERN_WINDOW) for v in ("bigbird", "sparse", "local")]
    cases += [(v, LONG_BATCH, LONG_SEQ, w) for v, w in (("flash", PATTERN_WINDOW), *LONG_GRID)]
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


# -- the int8 serving tier ------------------------------------------------------

# int8-against-float quality bounds: the headline against float64
# (benchmarks/quant_benchmark.py:59) and flash_q8 against the fp32 flash
# forward (tests/test_attention.py:753)
INT8_REL_LIMIT = 5e-2
# the 'sparse' cut of the headline that takes the ring entry point: fewer
# occupied blocks than block-columns
RING_SHAPE, RING_FILL = (4096, 16384), 0.005
Q8_SHAPES = (((8, 16, 512, 64), True), ((2, 12, 4096, 64), False))
# GPT serving at benchmarks/serving_benchmark.py's configuration (l.27-35)
GPT = dict(num_layers=24, hidden=1024, num_heads=16, intermediate=4096, vocab_size=32000,
           max_position=512)
GPT_PROMPT, GPT_BATCHES, GPT_STEPS = 16, (1, 8), (16, 96)
GPT_QUALITY_STEPS, GPT_PARITY_STEPS, GPT_FUSED_SEQ = 24, 3, 512
# QuantizedGPT logits, card against CPU, max-abs error over scale: both sum
# the same exact bf16 products in fp32, in other orders, and an activation an
# ulp apart may round to the neighbouring bf16 value (2^-8 of it) before the
# next product; expected near 1e-3
GPT_CARD_CPU_LIMIT = 1e-2
# gemm_s8's card cases, (m, k, n): ragged m, k and n; m under 64 with n
# under 8; n off a multiple of 8; m and n one past a tile edge; k in 64
# chunks of 128; k % 16 != 0 (A padded) at 4100; more tiles than the card
# holds blocks at once at each width (128 x 256, 128 x 128: each block walks
# several); 4096^3
GEMM_S8_CASES = ((100, 70, 33), (64, 37, 50), (130, 259, 257), (1, 1024, 8), (37, 100, 5),
                 (200, 256, 100), (129, 384, 257), (256, 8192, 320), (1030, 4100, 1030),
                 (4096, 128, 4096), (40000, 128, 128), (4096, 4096, 4096))


def phase_small_int8() -> None:
    """Each int8 kernel against its plain version on the card at small
    shapes: spmm_int8 (both entry points bitwise equal to each other and to
    the plain version), gemm_s8 (int32 equal, both tile widths) and
    flash_q8 (within
    FLASH_LIMIT_ROUNDED of scale)."""
    import tpusparse_torch as tt
    from tpusparse_torch import kernels, quant
    from tpusparse_torch.kernels import flash_attention as fa
    from tpusparse_torch.kernels import gemm as gk
    from tpusparse_torch.kernels import tiled_spmm as tk

    from tpusparse_torch.utils.matrices import block_sparse_csr

    # name, (m, k, n), blocksize, density, empty rows; ragged m, k, n; the
    # pipelined instances (bm a multiple of 64, bk of 32) at 64 and 128 rows
    # and 32- to 128-deep chunks, and a block pattern ("blocks") at the
    # headline's fill
    cases = [
        ("int8_ragged_8x16", (100, 70, 33), (8, 16), 0.15, None),
        ("int8_ragged_32x8", (100, 70, 130), (32, 8), 0.15, None),
        ("int8_empty_rowblock_128x128", (300, 260, 200), (128, 128), 0.05, (128, 256)),
        ("int8_ragged_64x128", (200, 300, 70), (64, 128), 0.05, None),
        ("int8_ragged_128x64_n1", (300, 200, 1), (128, 64), 0.05, (128, 256)),
        ("int8_64x32_n257", (256, 256, 257), (64, 32), 0.1, None),
        ("int8_1024sq_blocks_128x128_n512", (1024, 1024, 512), (128, 128), "blocks", None),
    ]
    for seed, (name, (m, k, n), bs, dens, empty) in enumerate(cases):
        if dens == "blocks":
            a = block_sparse_csr(900 + seed, (m, k), bs, 0.10, device="cuda")
            rng = np.random.default_rng(900 + seed)
        else:
            a_np, rng = _dense_case(900 + seed, m, k, dens, empty)
            a = tt.CSR.from_dense(a_np, device="cuda")
        plan = tt.build_plan(a, bs)
        qvals, scales = quant.quantize_block_values(plan.pack_values(a.data))
        b_q, t = quant.quantize_columns(torch.from_numpy(
            rng.standard_normal((k, n)).astype(np.float32)).cuda())
        got_r = tk.resident_spmm_int8_kernel(plan, qvals, scales, b_q, t)
        got_t = tk.tiled_spmm_int8_kernel(plan, qvals, scales, b_q, t)
        want = tk._block_exec_int8_plain(plan, qvals, scales, b_q, t)
        torch.cuda.synchronize()
        pads = int(plan.num_slots - plan.nblocks)
        ok = (torch.equal(got_r, got_t) and torch.equal(got_r, want)
              and got_r.shape == (m, n) and bool(torch.isfinite(got_r).all()))
        print(f"case {name} ({m}, {k}, {n}), {pads} pad slots: entry points bitwise equal "
              f"to each other and to the plain version: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: spmm_int8 disagrees with its plain version "
                                 f"(max_abs_err {float((got_r - want).abs().max()):.3e})")
    rng = np.random.default_rng(950)
    widths = set()
    for m, k, n in GEMM_S8_CASES:
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).cuda()
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).cuda()
        kernels.reset_launch_counts()
        got = gk.gemm_int8_kernel(a, b)
        torch.cuda.synchronize()
        counts = kernels.launches_by_kernel()
        ok = (got.dtype == torch.int32 and torch.equal(got, gk._gemm_int8_plain(a, b))
              and counts["gemm_s8"] == 1 and counts["int8_kmajor"] == 1)
        bn = gk._s8_tile_n(m, n)
        widths.add(bn)
        print(f"case gemm_s8 ({m}, {k}, {n}), tiles 128 x {bn}: int32 equal to the plain "
              f"version, 1 gemm_s8 + 1 int8_kmajor: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"gemm_s8 ({m}, {k}, {n}) disagrees with its plain version "
                                 f"or launched {counts}")
    if widths != {128, 256}:
        raise AssertionError(f"gemm_s8's cases ran tiles 128 x {sorted(widths)}, not both widths")
    # name, (bh, s, d), causal, q_offset, kv_offset (rows 256:512 of a causal
    # attention against keys 0:256; the tile edges of the tensor-core kernel)
    q8_cases = [
        ("2x3x256x64", (6, 256, 64), False, 0, 0),
        ("causal_1x2x384x64", (2, 384, 64), True, 0, 0),
        ("ragged_1x1x200x64", (1, 200, 64), False, 0, 0),
        ("narrow_2x4x128x24", (8, 128, 24), False, 0, 0),
        ("wide_1x2x128x128", (2, 128, 128), True, 0, 0),
        ("offsets_1x1x256x64_q256", (1, 256, 64), True, 256, 0),
        ("ragged_causal_1x2x1000x64", (2, 1000, 64), True, 0, 0),
        ("offsets_1x2x256x40_q192_kv64", (2, 256, 40), True, 192, 64),
    ]
    for seed, (name, shape, causal, q_off, kv_off) in enumerate(q8_cases):
        q, k, v, _ = _flash_operands(shape, 960 + seed)
        kq, ks, vq, vs = fa.quantize_kv(k, v)
        kw = dict(sm_scale=1 / shape[-1] ** 0.5, causal=causal, q_offset=q_off,
                  kv_offset=kv_off)
        for dtype in (torch.float32, torch.bfloat16):
            got = fa.flash_q8_kernel(q.to(dtype), kq, vq, ks, vs, **kw)
            want = fa._flash_q8_plain(q.to(dtype), kq, vq, ks, vs, **kw)
            torch.cuda.synchronize()
            err = rel_err(got, want)[1]
            ok = (err <= FLASH_LIMIT_ROUNDED and got.dtype == dtype
                  and bool(torch.isfinite(got.float()).all()))
            print(f"case flash_q8_{name}_{str(dtype).split('.')[1]}: o over scale {err:.2e} "
                  f"(limit {FLASH_LIMIT_ROUNDED:.0e}), {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_q8 {name}: kernel disagrees with its plain version")


def _expect(label, counts, expect) -> None:
    if counts != {**NO_LAUNCH, **expect}:
        raise AssertionError(f"{label}: launched {counts}, expected {expect} and nothing else")


def phase_int8_serving(a, b, c_fp32) -> dict:
    """The int8 serving tier's main path, each part counted on its own: the
    headline QuantizedMatrix (1 resident spmm_int8 launch), a pattern with
    fewer blocks than block-columns (1 ring launch), quantized_matmul and
    QuantizedDense.matmul at 4096 (1 gemm_s8 and 1 int8_kmajor each), and
    quantize_kv +
    flash_attention_q8 at both serving shapes (1 flash_q8 each); then the
    checks of their results. Returns what the timings and the kernels line
    need."""
    import tpusparse_torch as tt
    from tpusparse_torch import kernels
    from tpusparse_torch.kernels import flash_attention as fa
    from tpusparse_torch.kernels import tiled_spmm as tk
    from tpusparse_torch.utils.matrices import block_sparse_csr

    r = {"launches": dict(NO_INT8)}

    def counted(label, fn, expect, entry=None):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = kernels.launches_by_kernel()
        _expect(label, counts, expect)
        if entry is not None and tk.launch_counts()[entry] != 1:
            raise AssertionError(f"{label}: not through {entry}: {tk.launch_counts()}")
        for n in NO_INT8:
            r["launches"][n] += counts[n]
        print(f"{label}: launches {json.dumps({n: counts[n] for n in expect})}")
        return out

    t0 = time.perf_counter()
    qa = tt.QuantizedMatrix(a, (128, 128))
    torch.cuda.synchronize()
    print(f"int8 headline set-up (plan + quantize): {time.perf_counter() - t0:.2f} s, "
          f"nblocks {qa.plan.nblocks}, num_col_blocks {qa.plan.num_col_blocks}")
    y = counted("int8 headline QuantizedMatrix @ B (16384^2, 10% of 128^2 blocks, n 512)",
                lambda: qa @ b, {"spmm_int8": 1, "int8_kmajor": 1}, "resident_spmm_int8")
    ring_a = block_sparse_csr(3, RING_SHAPE, (128, 128), RING_FILL, device="cuda")
    qr = tt.QuantizedMatrix(ring_a, (128, 128))
    if not qr.plan.nblocks < qr.plan.num_col_blocks:
        raise AssertionError("the ring case's pattern re-uses the B panel")
    yr = counted(f"int8 ring QuantizedMatrix @ B ({RING_SHAPE}, {qr.plan.nblocks} blocks < "
                 f"{qr.plan.num_col_blocks} block-columns)", lambda: qr @ b,
                 {"spmm_int8": 1, "int8_kmajor": 1}, "tiled_spmm_int8")
    g = 4096
    rng = np.random.default_rng(13)
    wa, wb = (torch.from_numpy(rng.standard_normal((g, g), dtype=np.float32)).cuda()
              for _ in range(2))
    qd = tt.QuantizedDense(wa)
    ym = counted(f"quantized_matmul {g}^3", lambda: tt.quantized_matmul(wa, wb),
                 {"gemm_s8": 1, "int8_kmajor": 1})
    yd = counted(f"QuantizedDense.matmul {g}^3", lambda: qd @ wb,
                 {"gemm_s8": 1, "int8_kmajor": 1})

    # -- checks -----------------------------------------------------------------
    m = a.shape[0]
    cols = 32
    with torch.no_grad():
        a64 = qa.plan.blocks_to_dense(qa.plan.pack_values(a.data)).double()
        ref = a64 @ b[:, :cols].double()
        del a64
    rel64 = rel_err(y[:, :cols].double(), ref)[1]
    rel32 = rel_err(y, c_fp32)[1]
    print(f"int8 headline: rel err against float64 on {cols} columns {rel64:.3e} (limit "
          f"{INT8_REL_LIMIT:.0e}), against the fp32 spmm_blocks {rel32:.3e}")
    ring_ref = tt.spmm_blocks(qr.plan, qr.plan.pack_values(ring_a.data), b)
    rel_ring = rel_err(yr, ring_ref)[1]
    rel_mm = rel_err(ym, wa.double() @ wb.double())[1]
    rel_d = rel_err(yd, ym)[1]
    print(f"int8 ring: rel err against the fp32 spmm_blocks {rel_ring:.3e}; quantized_matmul "
          f"against float64 {rel_mm:.3e}; QuantizedDense against quantized_matmul {rel_d:.1e}")
    if not (rel64 < INT8_REL_LIMIT and rel_ring < INT8_REL_LIMIT and rel_mm < INT8_REL_LIMIT
            and rel_d == 0.0 and all(bool(torch.isfinite(x).all()) for x in (y, yr, ym))
            and y.shape == (m, b.shape[1])):
        raise AssertionError("the int8 serving tier is outside its error class")
    del ym, yd, ring_ref

    r["q8"] = {}
    for shape, causal in Q8_SHAPES:
        bsz, h, s, d = shape
        q, k, v, _ = _flash_operands((bsz * h, s, d), 970 + s)
        q, k, v = (x.view(shape) for x in (q, k, v))
        kq, ks, vq, vs = counted(f"quantize_kv {shape}", lambda: fa.quantize_kv(k, v), {})
        o8 = counted(f"flash_attention_q8 {shape} causal={causal}",
                     lambda: fa.flash_attention_q8(q, kq, ks, vq, vs, causal=causal),
                     {"flash_q8": 1})
        of = fa.flash_attention(q, k, v, causal=causal)
        rel = rel_err(o8, of)[1]
        print(f"flash_q8 {shape}: rel err against the fp32 flash_fwd {rel:.3e} (limit "
              f"{INT8_REL_LIMIT:.0e})")
        if not (rel < INT8_REL_LIMIT and bool(torch.isfinite(o8).all())):
            raise AssertionError(f"flash_q8 {shape} is outside its error class")
        r["q8"][shape] = (q, k, v, kq, ks, vq, vs, causal)
    r.update(qa=qa, y=y, wa=wa, wb=wb, qd=qd, qr=qr)
    return r


def phase_int8_timings(r, plan, bv, b) -> dict:
    """Times of the three int8 kernels at the main path's shapes, each
    against its plain version, its bound and one PyTorch call as yardstick;
    returns the kernels line's rows."""
    from torch.nn.attention import sdpa_kernel

    from tpusparse_torch import quant
    from tpusparse_torch.kernels import flash_attention as fa
    from tpusparse_torch.kernels import gemm as gk
    from tpusparse_torch.kernels import tiled_spmm as tk

    rows = []
    # -- spmm_int8 at the headline: B made K-major, then the executor ----------
    qa = r["qa"]
    p = qa.plan
    m, k = p.shape
    n = b.shape[1]
    bm, bk = p.blocksize
    b_q, t = quant.quantize_columns(b)
    args = (p, qa.qvals, qa.scales, b_q, t)
    ldt = -(-p.num_col_blocks * bk // 16) * 16
    bt = tk.int8_kmajor_kernel(b_q, ldt)
    got, want = tk.resident_spmm_int8_kernel(*args), tk._block_exec_int8_plain(*args)
    err = float((got - want).abs().max())
    bt_err = float((bt.int() - tk._int8_kmajor_plain(b_q, ldt).int()).abs().max())
    del got, want
    ms = time_ms_queued(lambda: tk.resident_spmm_int8_kernel(*args))
    one_ms = time_ms(lambda: tk.resident_spmm_int8_kernel(*args))
    exec_ms = time_ms_queued(
        lambda: tk._spmm_int8_launch("resident_spmm_int8", p, qa.qvals, qa.scales, bt, t))
    e2e_ms = time_ms_queued(lambda: qa @ b)
    plain_ms = time_ms(lambda: tk._block_exec_int8_plain(*args))
    fp32_ms = time_ms_queued(lambda: tk.resident_spmm_kernel(plan, bv, b))
    dq = qa.dequantize()
    a16 = p.blocks_to_dense(p.pack_values(dq.data)).to(torch.bfloat16)
    b16 = b.to(torch.bfloat16)
    lib_ms = time_ms_queued(lambda: torch.matmul(a16, b16))
    del dq, a16, b16
    ops = 2.0 * p.nblocks * bm * bk * n
    nbytes = p.nblocks * bm * bk + 4.0 * p.nblocks + k * n + 4.0 * n + 4.0 * m * n
    bms, by = bound(ops, nbytes, INT8_OPS)
    old = OLD_MS["spmm_int8 headline"]
    print(f"spmm_int8 headline (16384^2, {p.nblocks} blocks, n {n}): entry point "
          f"(int8_kmajor + executor) {ms:.4f} ms queued ({one_ms:.4f} ms one call; the "
          f"unpipelined entry point before its redesign {old:.3f}: {old / ms:.2f}x), design "
          f"figure: the executor alone on B already K-major {exec_ms:.4f} ms queued; "
          f"quantize_columns + entry point {e2e_ms:.4f} ms, plain {plain_ms:.4f} ms, fp32 "
          f"block_ell_spmm {fp32_ms:.4f} ms (int8/fp32 {ms / fp32_ms:.3f}), torch.matmul "
          f"of the dequantized dense A in bf16 {lib_ms:.4f} ms (entry point/library "
          f"{ms / lib_ms:.2f}); bound {bms:.4f} ms by {by} ({ops / 1e9:.2f} G int8 ops, "
          f"{nbytes / 1e6:.1f} MB), entry point at {ops / (ms * 1e-3) / 1e12:.2f} TOPS, "
          f"{bms / ms:.3f} of its bound; kernel vs plain max_abs_err {err:.1e}")
    rows.append({
        "name": "spmm_int8", "route": "cuda",
        "source": "tpusparse_torch/csrc/block_ell_spmm_int8.cu",
        "replaces": "tpusparse/kernels/tiled_spmm.py:643 (_resident_int8_kernel); "
                    "tpusparse/kernels/tiled_spmm.py:845 (_tiled_int8_kernel)",
        "launches": r["launches"]["spmm_int8"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
    })
    kt_ms = time_ms_ahead(lambda: tk.int8_kmajor_kernel(b_q, ldt))
    kt_plain = time_ms_queued(lambda: tk._int8_kmajor_plain(b_q, ldt))
    kt_lib = time_ms_ahead(lambda: b_q.t().contiguous())
    kt_bound, kt_by = bound(0.0, k * n + n * ldt)
    print(f"int8_kmajor headline b_q ({k}, {n}) -> ({n}, {ldt}): kernel {kt_ms:.4f} ms, "
          f"b_q.t().contiguous() {kt_lib:.4f} ms (both queued behind a sleep), plain "
          f"{kt_plain:.4f} ms, bound {kt_bound:.4f} ms by {kt_by} "
          f"({(k * n + n * ldt) / 1e6:.1f} MB); kernel vs plain max_abs_err {bt_err:.0f}")
    if bt_err != 0.0:
        raise AssertionError("int8_kmajor disagrees with its plain version")
    rows.append({
        "name": "int8_kmajor", "route": "cuda",
        "source": "tpusparse_torch/csrc/block_ell_spmm_int8.cu",
        "replaces": "tpusparse/kernels/tiled_spmm.py:643 (_resident_int8_kernel, its B "
                    "operand made K-major for the s8 tensor cores); "
                    "tpusparse/kernels/tiled_spmm.py:845 (_tiled_int8_kernel)",
        "launches": r["launches"]["int8_kmajor"], "max_abs_err": bt_err, "ms": kt_ms,
        "plain_ms": kt_plain, "bound_ms": kt_bound, "bound_by": kt_by, "library_ms": kt_lib,
    })
    del bt
    # the ring entry point on the ring pattern
    qr = r["qr"]
    rp = qr.plan
    rargs = (rp, qr.qvals, qr.scales, b_q, t)
    ring_same = torch.equal(tk.tiled_spmm_int8_kernel(*rargs), tk._block_exec_int8_plain(*rargs))
    ring_ms = time_ms_queued(lambda: tk.tiled_spmm_int8_kernel(*rargs))
    ring_e2e = time_ms_queued(lambda: qr @ b)
    ring_ops = 2.0 * rp.nblocks * bm * bk * n
    ring_bytes = rp.nblocks * bm * bk + 4.0 * rp.nblocks + 2.0 * k * n + 4.0 * n \
        + 4.0 * rp.shape[0] * n
    ring_bound, ring_by = bound(ring_ops, ring_bytes, INT8_OPS)
    print(f"spmm_int8 ring {RING_SHAPE} ({rp.nblocks} blocks) through tiled_spmm_int8: "
          f"{ring_ms:.4f} ms queued (int8_kmajor included), quantize_columns + entry point "
          f"{ring_e2e:.4f} ms, bound {ring_bound:.4f} ms by {ring_by}; bitwise equal to the "
          f"plain version: {ring_same}")
    if not ring_same:
        raise AssertionError("spmm_int8 on the ring pattern disagrees with its plain version")
    # -- gemm_s8 at 4096^3 ----------------------------------------------------
    qa8, _ = quant.quantize_rows(r["wa"])
    qb8, _ = quant.quantize_columns(r["wb"])
    g = qa8.shape[0]
    got = gk.gemm_int8_kernel(qa8, qb8)
    err = float((got - gk._gemm_int8_plain(qa8, qb8)).abs().max())
    ms = time_ms_queued(lambda: gk.gemm_int8_kernel(qa8, qb8))
    plain_ms = time_ms(lambda: gk._gemm_int8_plain(qa8, qb8))
    # the kernel alone on B made K-major, and int8_kmajor alone at 4096^2
    bt8 = tk.int8_kmajor_kernel(qb8, gk._s8_ldt(g))
    bn = gk._s8_tile_n(g, g)
    kernel_ms = time_ms_queued(lambda: gk._gemm_s8_launch(qa8, bt8, g))
    kt8_ms = time_ms_ahead(lambda: tk.int8_kmajor_kernel(qb8, gk._s8_ldt(g)))
    del bt8
    # torch._int_mm with B as given, and column-major (K-major), the layout
    # cuBLASLt's int8 tensor-core path takes; the faster is the yardstick
    qb8_cm = qb8.t().contiguous().t()
    lib_rm_ms = time_ms_queued(lambda: torch._int_mm(qa8, qb8))
    lib_cm_ms = time_ms_queued(lambda: torch._int_mm(qa8, qb8_cm))
    lib_rm_err = float((torch._int_mm(qa8, qb8) - got).abs().max())
    lib_cm_err = float((torch._int_mm(qa8, qb8_cm) - got).abs().max())
    lib_ms = min(lib_rm_ms, lib_cm_ms)
    ops = 2.0 * g ** 3
    bms, by = bound(ops, 2.0 * g * g + 4.0 * g * g, INT8_OPS)
    print(f"gemm_s8 {g}^3 (tiles 128 x {bn}): entry point (int8_kmajor + kernel) {ms:.4f} ms "
          f"queued, {ops / (ms * 1e-3) / 1e12:.2f} TOPS, {bms / ms:.3f} of its bound; the "
          f"kernel alone {kernel_ms:.4f} ms, {ops / (kernel_ms * 1e-3) / 1e12:.2f} TOPS, "
          f"{bms / kernel_ms:.3f} of its bound; int8_kmajor ({g}, {g}) alone {kt8_ms:.4f} ms "
          f"behind a sleep; plain (float64) {plain_ms:.4f} ms; torch._int_mm B row-major "
          f"{lib_rm_ms:.4f} ms (vs kernel max_abs_err {lib_rm_err:.0f}), B column-major "
          f"{lib_cm_ms:.4f} ms (vs kernel max_abs_err {lib_cm_err:.0f}); bound {bms:.4f} ms "
          f"by {by}; kernel vs plain max_abs_err {err:.0f}")
    if err != 0.0 or lib_cm_err != 0.0:
        raise AssertionError("gemm_s8 at 4096^3 disagrees with its plain version or with "
                             "torch._int_mm on column-major B")
    rows.append({
        "name": "gemm_s8", "route": "cuda", "source": "tpusparse_torch/csrc/gemm_s8.cu",
        "replaces": "tpusparse/kernels/gemm.py:298 (_gemm_s8_kernel)",
        "launches": r["launches"]["gemm_s8"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
    })
    del qa8, qb8, qb8_cm, got
    # -- flash_q8 at both serving shapes ---------------------------------------
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q8_row = None
    for shape, (q, k, v, kq, ks, vq, vs, causal) in r["q8"].items():
        bsz, h, s, d = shape
        bh = bsz * h
        q3, kq3, vq3 = (x.reshape(bh, s, d) for x in (q, kq, vq))
        ks1, vs1 = ks.reshape(-1).contiguous(), vs.reshape(-1).contiguous()
        kw = dict(sm_scale=1 / d ** 0.5, causal=causal)
        err = rel_err(fa.flash_q8_kernel(q3, kq3, vq3, ks1, vs1, **kw),
                      fa._flash_q8_plain(q3, kq3, vq3, ks1, vs1, **kw))
        ms = time_ms_queued(lambda: fa.flash_q8_kernel(q3, kq3, vq3, ks1, vs1, **kw))
        plain_ms = time_ms_queued(lambda: fa._flash_q8_plain(q3, kq3, vq3, ks1, vs1, **kw),
                                  reps=5)
        k3, v3 = (x.reshape(bh, s, d) for x in (k, v))
        fwd_ms = time_ms_queued(lambda: fa.flash_fwd_kernel(q3, k3, v3, precision="default",
                                                            **kw))
        qb, kb, vb = (x.to(torch.bfloat16) for x in
                      (q, kq.float() * ks[..., None, None], vq.float() * vs[..., None, None]))
        backend = _sdpa_backend(qb, kb, vb)
        with sdpa_kernel([backend]):
            lib_ms = time_ms_queued(lambda: sdpa(qb, kb, vb, is_causal=causal))
        scores = bh * (s * (s + 1) / 2 if causal else s * s)
        ops = 4.0 * scores * d
        nbytes = bh * s * d * (4 + 1 + 1 + 4) + 8.0 * bh
        bms, by = bound(ops, nbytes, BF16_FLOPS)
        old = OLD_MS[f"flash_q8 {shape}"]
        print(f"flash_q8 {shape} causal={causal}: kernel {ms:.4f} ms queued (first port "
              f"{old:.3f}: {old / ms:.2f}x), plain {plain_ms:.4f} ms, flash_fwd 'default' on "
              f"the fp32 k, v {fwd_ms:.4f} ms, sdpa bf16 on the dequantized k, v "
              f"({backend.name}) {lib_ms:.4f} ms (kernel/sdpa {ms / lib_ms:.2f}); bound "
              f"{bms:.4f} ms by {by} ({ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), kernel at "
              f"{bms / ms:.3f} of it; kernel vs plain over scale {err[1]:.2e}")
        if q8_row is None:  # the first shape, the causal serving batch, is the row's
            q8_row = {
                "name": "flash_q8", "route": "cuda",
                "source": "tpusparse_torch/csrc/flash_attention_q8.cu",
                "replaces": "tpusparse/kernels/flash_attention.py:1434 (_flash_q8_kernel)",
                "launches": r["launches"]["flash_q8"], "max_abs_err": err[0], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            }
        del qb, kb, vb
    rows.append(q8_row)
    return rows


# -- GPT serving ------------------------------------------------------------------


def _gpt_bytes(model, batch, tier_bytes):
    """HBM bytes one decode token must move: every linear weight once, at
    the tier's width, and the whole max_position K/V cache of every layer
    (decode attends over the static buffer)."""
    w = sum(blk_p.numel() for name, blk_p in model.named_parameters() if name.endswith("kernel"))
    kv = 2.0 * model.num_layers * batch * GPT["hidden"] * model.max_position
    return w * tier_bytes + kv * tier_bytes


def _gen_ms(gen, prompt):
    """ms per generated token: the 96-step run minus the 16-step run, over
    the 80 steps between (benchmarks/serving_benchmark.py:125-140), each
    the best of two after a warm-up; the host clock around runs that end in
    a synchronize."""
    gen(prompt, 2)
    t = {}
    for steps in GPT_STEPS:
        best = float("inf")
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gen(prompt, steps)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        if out.shape != (prompt.shape[0], steps):
            raise AssertionError(f"generate gave {tuple(out.shape)}")
        t[steps] = best
    return (t[GPT_STEPS[1]] - t[GPT_STEPS[0]]) / (GPT_STEPS[1] - GPT_STEPS[0]) * 1e3


def _busy_ms(step, n=8):
    """Device busy time per decode step: torch.profiler's kernel time over
    `n` steps (the profiler slows the host, so the share is taken against
    the unprofiled step time)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.end - e.time_range.start for e in ks) / 1e3 / n, len(ks) / n


def phase_gpt_serving() -> None:
    """GPT serving at benchmarks/serving_benchmark.py's configuration: the
    fp32 GPTDecoder, its bf16 cast and quantize_gpt of it generate at batch 1
    and 8 with no kernel launched; the fused forward at batch 8, seq 512
    launches 24 flash_fwd; int8 against fp32 quality over 24 teacher-forced
    steps; QuantizedGPT card against CPU; per-token times against the HBM
    bound, and the device's busy share of a decode step."""
    import copy

    import tpusparse_torch as tt
    from tpusparse_torch import kernels

    t0 = time.perf_counter()
    model = tt.GPTDecoder(**GPT, device="cuda", generator=torch.Generator().manual_seed(21)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    qm = tt.quantize_gpt(model)
    m16 = copy.deepcopy(model).to(torch.bfloat16)
    torch.cuda.synchronize()
    print(f"gpt set-up: {time.perf_counter() - t0:.1f} s, {n_params / 1e6:.1f} M parameters "
          f"({GPT['num_layers']} layers, hidden {GPT['hidden']}, {GPT['num_heads']} heads, "
          f"vocab {GPT['vocab_size']}, max_position {GPT['max_position']})")
    rng = np.random.default_rng(22)
    tiers = {
        "fp32": (lambda p, s: tt.generate(model, p, s), model, 4),
        "bf16": (lambda p, s: tt.generate(m16, p, s), m16, 2),
        "int8": (qm.generate, model, 1),
    }
    steppers = {"fp32": model, "bf16": m16, "int8": qm}
    for batch in GPT_BATCHES:
        prompt = torch.from_numpy(rng.integers(0, GPT["vocab_size"], (batch, GPT_PROMPT))).cuda()
        for tier, (gen, shape_model, width) in tiers.items():
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            ms = _gen_ms(gen, prompt)
            _expect(f"gpt generate {tier} batch {batch}", kernels.launches_by_kernel(), {})
            mdl = steppers[tier]
            with torch.no_grad():
                _, cache = mdl.prefill(prompt)
                busy, nk = _busy_ms(lambda: mdl.decode_step(prompt[:, 0], cache, GPT_PROMPT))
            bms = _gpt_bytes(shape_model, batch, width) / HBM_BYTES_PER_S * 1e3
            print(f"gpt generate {tier} batch {batch}: {ms:.4f} ms per token, "
                  f"{batch / ms * 1e3:.1f} tokens/s; HBM bound {bms:.4f} ms per token; device "
                  f"busy {busy:.4f} ms per decode step ({nk:.0f} kernels), busy share "
                  f"{busy / ms:.3f}; no kernel of the port launched")
            del cache

    # -- the fused forward: 24 flash_fwd --------------------------------------
    ids = torch.from_numpy(rng.integers(0, GPT["vocab_size"], (8, GPT_FUSED_SEQ))).cuda()
    with torch.no_grad():
        ref = model(ids)
        for blk in model.blocks:
            blk.fused = True
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            out = model(ids)
            torch.cuda.synchronize()
            counts = kernels.launches_by_kernel()
        finally:
            for blk in model.blocks:
                blk.fused = False
    _expect("gpt fused forward", counts, {"flash_fwd": GPT["num_layers"]})
    err = rel_err(out, ref)[1]
    print(f"gpt fused=True forward (batch 8, seq {GPT_FUSED_SEQ}): launches "
          f"{json.dumps({'flash_fwd': counts['flash_fwd']})}; logits against the unfused "
          f"forward over scale {err:.2e} (limit 2e-3, tests/test_gpt.py:79)")
    if not (err < 2e-3 and bool(torch.isfinite(out).all())):
        raise AssertionError("gpt fused forward disagrees with the unfused one")
    del ref, out
    fwd_ms = {}
    with torch.no_grad():
        try:
            for fused in (False, True):
                for blk in model.blocks:
                    blk.fused = fused
                fwd_ms[fused] = time_ms(lambda: model(ids), warmup=2, iters=5)
        finally:
            for blk in model.blocks:
                blk.fused = False
    print(f"gpt forward (batch 8, seq {GPT_FUSED_SEQ}): unfused {fwd_ms[False]:.4f} ms, fused "
          f"({GPT['num_layers']} flash_fwd) {fwd_ms[True]:.4f} ms")

    # -- quality: int8 against fp32 over teacher-forced steps at batch 1 ---------
    prompt = torch.from_numpy(rng.integers(0, GPT["vocab_size"], (1, GPT_PROMPT))).cuda()
    with torch.no_grad():
        lf, cf = model.prefill(prompt)
        lq, cq = qm.prefill(prompt)
        tok = lf[:, -1].argmax(-1)
        errs, agree = [], 0
        for i in range(GPT_QUALITY_STEPS):
            lf, cf = model.decode_step(tok, cf, GPT_PROMPT + i)
            lq, cq = qm.decode_step(tok, cq, GPT_PROMPT + i)
            if not (bool(torch.isfinite(lf).all()) and bool(torch.isfinite(lq).all())):
                raise AssertionError(f"gpt quality step {i}: non-finite logits")
            errs.append(rel_err(lq, lf)[1])
            agree += int(lq.argmax(-1).item() == lf.argmax(-1).item())
            tok = lf.argmax(-1)
    print(f"gpt quality int8 against fp32, batch 1, {GPT_QUALITY_STEPS} teacher-forced steps: "
          f"max logit rel err {max(errs):.3e}, top-1 agreement {agree / GPT_QUALITY_STEPS:.3f}")
    del cf, cq, m16

    # -- QuantizedGPT on the card against the CPU ---------------------------------
    t0 = time.perf_counter()
    cpu_model = tt.GPTDecoder(**GPT, device="cpu", generator=torch.Generator().manual_seed(21))
    qc = tt.quantize_gpt(cpu_model)
    del cpu_model
    lins = [(getattr(bc, n), getattr(bg, n)) for bc, bg in zip(qc.blocks, qm.blocks)
            for n in ("qkv", "o", "fc1", "fc2")] + [(qc.lm_head, qm.lm_head)]
    same = all(torch.equal(c.qw, g.qw.cpu()) and torch.equal(c.sw, g.sw.cpu()) for c, g in lins)
    prompt = torch.from_numpy(rng.integers(0, GPT["vocab_size"], (1, GPT_PROMPT)))
    errs = []
    with torch.no_grad():
        lc, cc = qc.prefill(prompt)
        lg, cg = qm.prefill(prompt.cuda())
        errs.append(rel_err(lg.cpu(), lc)[1])
        tok = lc[:, -1].argmax(-1)
        for i in range(GPT_PARITY_STEPS):
            lc, cc = qc.decode_step(tok, cc, GPT_PROMPT + i)
            lg, cg = qm.decode_step(tok.cuda(), cg, GPT_PROMPT + i)
            errs.append(rel_err(lg.cpu(), lc)[1])
            tok = lc.argmax(-1)
    print(f"gpt QuantizedGPT card vs CPU (batch 1, prefill + {GPT_PARITY_STEPS} steps, "
          f"{time.perf_counter() - t0:.1f} s): int8 weights and scales bitwise equal: {same}; "
          f"logits over scale " + ", ".join(f"{e:.2e}" for e in errs)
          + f" (limit {GPT_CARD_CPU_LIMIT:.0e})")
    if not (same and max(errs) < GPT_CARD_CPU_LIMIT):
        raise AssertionError("QuantizedGPT on the card disagrees with the CPU")


# -- the naive SpMM and the graph models ------------------------------------------

# every reducer, and the arg output of max and min: (reduce, return_arg)
NAIVE_MODES = (("sum", False), ("mean", False), ("max", False), ("min", False), ("mul", False),
               ("div", False), ("max", True), ("min", True))
# Cora's published sizes (Kipf & Welling 2017, Table 1): 2708 nodes, mean
# degree 3.9, 1433 binary bag-of-words features (1.27 % set), 7 classes, 140
# training nodes; the graph is generated, not downloaded
CORA = dict(nodes=2708, avg_degree=3.9, features=1433, density=0.0127, classes=7, train=140)
# ogbn-arxiv's published sizes (Hu et al. 2020, OGB): 169,343 nodes, mean
# degree 13.7, 128 features, 40 classes, 54 % of the nodes in the training
# split; OGB's GCN baseline has 3 layers of width 256
ARXIV = dict(nodes=169343, avg_degree=13.7, features=128, density=1.0, classes=40, train=0.537)
ARXIV_HIDDEN = (256, 256)
# OGB's baseline trains at 1e-2 with batch norm; without it 1e-2 overshoots
# on the third step (a CPU probe of this model at 20,000 nodes), 5e-3 does not
ARXIV_LR = 5e-3
GRAPH_STEPS = 20
ARXIV_STEPS = 5
NAIVE_TIMING_N = (256, 40)
# the widths of B's column strips naive_spmm is timed at (fp32 columns; the
# kernel's own choice is the widest strip within 32 MB of B)
NAIVE_STRIP_SWEEP = (16, 32, 64)
# attention kernels at a head dim above 128: (b, h, s, d)
WIDE_SHAPE = (2, 8, 512, 256)
# BigBirdAttention at Gemma-7B's attention widths (google/gemma-7b
# config.json: hidden_size 3072, num_attention_heads 16, head_dim 256),
# block 64 with the module's default window, global and random blocks
WIDE_BIGBIRD = dict(hidden=3072, num_heads=16, head_dim=256, block=64, batch=2, seq=512)


def kernels_reset() -> None:
    from tpusparse_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()


def _same(got, want) -> bool:
    """Bitwise equal, NaN where the other has NaN."""
    return (got.dtype == want.dtype and got.shape == want.shape
            and bool(((got == want) | (got.isnan() & want.isnan())).all())
            if got.is_floating_point() else torch.equal(got, want))


def _naive_case(seed, m, k, n, b_dtype=torch.float32, ties=False):
    """A CSR on the card whose every 7th row is empty and one row far longer
    than the rest (a power-law tail), and a dense B; with `ties` both from a
    few small integers, so equal products (the arg tie-break) are common."""
    import tpusparse_torch as tt

    rng = np.random.default_rng(seed)
    mask = rng.random((m, k)) < 0.06
    mask[m // 2, : 3 * k // 4] = True
    mask[::7] = False
    vals = (rng.choice([-2.0, -1.0, 1.0, 2.0], (m, k)) if ties
            else rng.uniform(0.5, 1.5, (m, k)) * rng.choice([-1.0, 1.0], (m, k)))
    a = tt.CSR.from_dense((mask * vals).astype(np.float32), device="cuda")
    b = rng.integers(-2, 3, (k, n)) if ties else rng.uniform(0.5, 1.5, (k, n))
    return a, torch.from_numpy(b.astype(np.float32)).to("cuda", b_dtype)


def phase_small_naive() -> None:
    """The naive SpMM kernel against its plain version on the card, every
    reducer and arg output: ragged m, n from 1 to 300, empty rows, one long
    row, tied products for the arg, a bf16 b. Values and args bitwise
    equal: both round each product and each update on their own."""
    from tpusparse_torch.kernels import naive_spmm as nk

    cases = [("ragged_101x77_n1", 101, 77, 1, torch.float32),
             ("ragged_101x77_n7", 101, 77, 7, torch.float32),
             ("ragged_101x77_n64", 101, 77, 64, torch.float32),
             ("ragged_301x250_n300", 301, 250, 300, torch.float32),
             ("bf16b_101x77_n40", 101, 77, 40, torch.bfloat16)]
    for seed, (name, m, k, n, bdt) in enumerate(cases):
        for reduce, return_arg in NAIVE_MODES:
            a, b = _naive_case(1100 + seed, m, k, n, bdt, ties=return_arg)
            ell = nk.ell_pack(a)
            nnz = a.nnz if return_arg else 0
            kw = dict(reduce=reduce, return_arg=return_arg, nnz=nnz)
            got = nk.naive_spmm_kernel(ell, a.shape, b, **kw)
            want = nk._naive_spmm_plain(ell, a.shape, b, **kw)
            torch.cuda.synchronize()
            pairs = list(zip(got, want)) if return_arg else [(got, want)]
            ok = all(_same(g, w) for g, w in pairs)
            label = f"{reduce}{' + arg' if return_arg else ''}"
            print(f"case naive_{name} (L {ell[0].shape[1]}, nnz {a.nnz}) {label}: bitwise equal "
                  f"to the plain version: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"naive {name} {label}: kernel disagrees with its plain "
                                     "version")


def phase_small_wide_attention() -> None:
    """The seven attention entry points at head dims above 128 against their
    plain versions: flash causal with and without offsets at d 136 (S wider
    than one 128-column slice of the forward's teams), 192, 200, 256 (also
    at s 1100, where the 3xTF32 bank folds, and with rows that see no key),
    320 and 330 (off 16 bytes; beyond one 256-wide accumulator), 384 at s
    512 (the wide backward's bank folds once) and 640 (512-wide chunks of
    o; also at s 1100); the block kernels on a 'bigbird' plan at d 136,
    192, 256, 320, 330 and 640, a mask-free plan of 1024 keys a row at d 256,
    384 and 640, and a band plan with rows that see no key at d 256, 320 and
    640; flash_q8; fp32 'high', fp32
    'default' and bf16; the existing limits. Each forward and each backward
    is run twice and must repeat bit for bit."""
    import tpusparse_torch as tt
    from tpusparse_torch.kernels import block_flash_attention as bfa
    from tpusparse_torch.kernels import flash_attention as fa

    # name, (bh, s, d), causal, q_offset, kv_offset
    cases = [("wide_2x256x136", (2, 256, 136), False, 0, 0),
             ("wide_2x256x192", (2, 256, 192), False, 0, 0),
             ("wide_causal_2x256x256", (2, 256, 256), True, 0, 0),
             ("wide_ragged_offsets_1x200x200_q64", (1, 200, 200), True, 64, 0),
             ("wide_causal_2x256x256_q64", (2, 256, 256), True, 64, 0),
             ("wide_fold_1x1100x256", (1, 1100, 256), False, 0, 0),
             ("wide_no_key_rows_1x128x256_kv100", (1, 128, 256), True, 0, 100),
             ("wide_causal_2x256x320", (2, 256, 320), True, 0, 0),
             ("wide_2x256x330", (2, 256, 330), False, 0, 0),
             ("wide_causal_2x256x640", (2, 256, 640), True, 0, 0),
             ("wide_2x512x384", (2, 512, 384), False, 0, 0),
             ("wide_fold_1x1100x640", (1, 1100, 640), False, 0, 0)]
    tiers = ((torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"))
    plan = tt.BlockAttnPlan(tt.bigbird_block_mask(256, 64), 64, 64, 256)

    def check_repeat(label, first, again, what="the forward"):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{label}: {what} does not repeat bit for bit")

    def check_blk_repeat(label, q, k, v, do, bplan, bkw, got):
        check_repeat(label, got[:2], bfa.blk_flash_fwd_kernel(q, k, v, bplan, **bkw))
        bwd = (q, k, v, do, got[1], _delta(do, got[0]), bplan)
        check_repeat(label, got[2:], (bfa.blk_flash_dq_kernel(*bwd, **bkw),
                                      *bfa.blk_flash_dkv_kernel(*bwd, **bkw)), "the backward")

    for seed, (name, shape, causal, q_off, kv_off) in enumerate(cases):
        for dtype, prec in tiers:
            q, k, v, do = _flash_operands(shape, 1200 + seed, dtype)
            d = shape[-1]
            tag = f"{str(dtype).split('.')[1]}_{prec}"
            rounded = dtype == torch.bfloat16 or prec == "default"
            kw = dict(sm_scale=1 / d ** 0.5, causal=causal, q_offset=q_off, kv_offset=kv_off,
                      precision=prec)
            got, want = _flash_pair(q, k, v, do, kw)
            check_repeat(f"flash_{name}_{tag}", got[:2], fa.flash_fwd_kernel(q, k, v, **kw))
            bwd = (q, k, v, do, got[1], (do.float() * got[0].float()).sum(-1).to(dtype).float())
            check_repeat(f"flash_{name}_{tag}", got[2:], (fa.flash_dq_kernel(*bwd, **kw),
                                                          *fa.flash_dkv_kernel(*bwd, **kw)),
                         "the backward")
            _check_attention_case(f"flash_{name}_{tag}", got, want, rounded,
                                  ", o/lse and dq/dk/dv repeat bitwise")
            blind = min(max(kv_off - q_off, 0), shape[1])  # rows that see no key
            if blind and not (torch.count_nonzero(got[0][:, :blind]) == 0
                              and bool((got[1][:, :blind] == -1e30).all())):
                raise AssertionError(f"flash {name}: rows that see no key are not 0, -1e30")
            if shape[1] == plan.seq and q_off == 0:
                bkw = dict(sm_scale=1 / d ** 0.5, precision=prec)
                got, want = _blk_pair(q, k, v, do, plan, bkw)
                label = f"blk_bigbird_256_b64_d{d}_{tag}"
                check_blk_repeat(label, q, k, v, do, plan, bkw, got)
                _check_attention_case(label, got, want, rounded,
                                      ", o/lse and dq/dk/dv repeat bitwise")
        q, k, v, _ = _flash_operands(shape, 1250 + seed)
        kq, ks, vq, vs = fa.quantize_kv(k, v)
        kw = dict(sm_scale=1 / shape[-1] ** 0.5, causal=causal, q_offset=q_off,
                  kv_offset=kv_off)
        for dtype in (torch.float32, torch.bfloat16):
            got = fa.flash_q8_kernel(q.to(dtype), kq, vq, ks, vs, **kw)
            want = fa._flash_q8_plain(q.to(dtype), kq, vq, ks, vs, **kw)
            torch.cuda.synchronize()
            err = rel_err(got, want)[1]
            ok = (err <= FLASH_LIMIT_ROUNDED and got.dtype == dtype and got.shape == want.shape
                  and bool(torch.isfinite(got.float()).all()))
            print(f"case flash_q8_{name}_{str(dtype).split('.')[1]}: o over scale {err:.2e} "
                  f"(limit {FLASH_LIMIT_ROUNDED:.0e}), {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_q8 {name}: kernel disagrees with its plain version")
    # the block forward's bank folding (a mask-free plan, 1024 keys a row) and
    # rows that see no key (a band plan, rows 70-89 of q-block 1 masked out)
    ind, ptr = tt.local_global_pattern(256, 20, 3)
    blind_plan = tt.BlockAttnPlan.from_token_pattern(ind, ptr, 256, 64, 64)
    blind_plan.tile_masks[blind_plan.L:2 * blind_plan.L, 70 - 64:90 - 64] = 0
    # (also on the 512 instance and in its chunks, where the backward's masks
    # are staged beside dk/dv's sub-tiles and held in dq's registers, and the
    # backward's bank folds there too)
    maskfree = tt.BlockAttnPlan(np.ones((16, 16), bool), 64, 64, 1024)
    for seed, (name, bplan, d) in enumerate((
            ("maskfree_1024_b64", maskfree, 256),
            ("blind_rows_256_b64", blind_plan, 256), ("blind_rows_256_b64", blind_plan, 320),
            ("blind_rows_256_b64", blind_plan, 640), ("maskfree_1024_b64", maskfree, 384),
            ("maskfree_1024_b64", maskfree, 640))):
        for dtype, prec in tiers:
            q, k, v, do = _flash_operands((1, bplan.seq, d), 1280 + seed, dtype)
            tag = f"{str(dtype).split('.')[1]}_{prec}"
            bkw = dict(sm_scale=1 / d ** 0.5, precision=prec)
            got, want = _blk_pair(q, k, v, do, bplan, bkw)
            label = f"blk_{name}_d{d}_{tag}"
            check_blk_repeat(label, q, k, v, do, bplan, bkw, got)
            _check_attention_case(label, got, want, dtype == torch.bfloat16 or prec == "default",
                                  ", o/lse and dq/dk/dv repeat bitwise")
            blind = ~bplan.token_mask(q.device).any(-1)
            if not (torch.count_nonzero(got[0][:, blind]) == 0
                    and torch.count_nonzero(got[2][:, blind]) == 0
                    and bool((got[1][:, blind] == -1e30).all())):
                raise AssertionError(f"{label}: rows that see no key are not o = dq = 0, "
                                     "lse = -1e30")


def _graph_task(cfg, seed):
    """A graph of the configuration's size and mean degree, its features,
    labels and training mask, all from `seed`, on the host. The labels are
    ones a GCN can learn: the class of a random projection of the features
    propagated once over Â (random labels at the arxiv shape leave the loss
    flat over 5 steps on the card)."""
    import scipy.sparse as ssp

    import tpusparse_torch as tt

    n = cfg["nodes"]
    adj = tt.random_graph(seed, n, avg_degree=cfg["avg_degree"], device="cpu")
    rng = np.random.default_rng(seed + 1)
    if cfg["density"] < 1.0:  # binary bag-of-words
        x = (rng.random((n, cfg["features"]), dtype=np.float32) < cfg["density"])
        x = x.astype(np.float32)
    else:
        x = rng.standard_normal((n, cfg["features"]), dtype=np.float32)
    a = tt.normalized_adjacency(adj)
    a = ssp.csr_matrix((a.data.numpy(), a.indices, a.indptr), shape=a.shape)
    labels = np.argmax(a @ (x @ rng.standard_normal((cfg["features"], cfg["classes"]),
                                                    dtype=np.float32)), axis=1)
    train = cfg["train"] if cfg["train"] >= 1 else int(cfg["train"] * n)
    mask = np.zeros(n, np.float32)
    mask[rng.choice(n, train, replace=False)] = 1.0
    return adj, (torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))


def _on(adj, device):
    import tpusparse_torch as tt

    return tt.CSR(adj.data.to(device), adj.indices, adj.indptr, adj.shape)


def _graph_models(family, device):
    """(model, optimizer, operator maker) of the Cora-shaped configurations,
    weights from one seed, so the card and the CPU start alike."""
    import tpusparse_torch as tt
    from tpusparse_torch.models import gat, gcn

    gen = torch.Generator().manual_seed({"gcn": 31, "gat": 32, "appnp": 33}[family])
    f, c = CORA["features"], CORA["classes"]
    if family == "gcn":
        model = tt.GCN(f, hidden=(64,), num_classes=c, spmm_method="naive", device=device,
                       generator=gen)
        return model, gcn.make_train_state(model, 1e-2), tt.normalized_adjacency
    if family == "gat":
        model = tt.GAT(f, hidden=(8,), num_heads=8, num_classes=c, spmm_method="naive",
                       device=device, generator=gen)
        return model, gat.make_train_state(model, 5e-3), tt.add_self_loops
    model = tt.APPNP(f, hidden=(64,), num_classes=c, alpha=0.1, k=10, device=device,
                     generator=gen)
    return model, gcn.make_train_state(model, 1e-2), tt.normalized_adjacency


# launches of one forward and of one Adam step: GCN one naive_spmm per layer
# (Â's values need no gradient: no backward launch); GAT one per head per
# layer (its backward is the gather and scatter-add); APPNP one
# block_ell_spmm per propagation step forward and one dB each backward
GRAPH_LAUNCHES = {"gcn": ({"naive_spmm": 2}, {"naive_spmm": 2}),
                  "gat": ({"naive_spmm": 16}, {"naive_spmm": 16}),
                  "appnp": ({"block_ell_spmm": 10}, {"block_ell_spmm": 20})}


def phase_graph_cora(family, task) -> dict:
    """A Cora-shaped model on the card: a forward, GRAPH_STEPS Adam steps,
    each one's launches checked and the loss required to drop; then the
    forward and PARITY_STEPS steps on the CPU from the same weights, held
    at the fp32 tier (parameters by the Adam rule of tests/test_torch_graph.py:
    elements whose first-step gradient is under 1e-3 of the largest may part
    by 2·lr a step). Returns the launches and what the timings need."""
    from tpusparse_torch.models import gcn

    adj, (x, labels, mask) = task
    fwd_expect, step_expect = GRAPH_LAUNCHES[family]
    model, opt, op = _graph_models(family, "cuda")
    a = op(_on(adj, "cuda"))
    xc, lc, mc = x.cuda(), labels.cuda(), mask.cuda()
    total = {"naive_spmm": 0, "block_ell_spmm": 0}
    torch.cuda.synchronize()
    kernels_reset()
    with torch.no_grad():
        out = model(a, xc)
    torch.cuda.synchronize()
    _expect(f"{family} cora forward", _launches(), fwd_expect)
    for kname in total:
        total[kname] += _launches()[kname]
    losses, snapshot = [], None
    for i in range(GRAPH_STEPS):
        kernels_reset()
        losses.append(gcn.train_step(model, opt, a, xc, lc, mc))
        torch.cuda.synchronize()
        _expect(f"{family} cora step {i}", _launches(), step_expect)
        for kname in total:
            total[kname] += _launches()[kname]
        if i + 1 == PARITY_STEPS:
            snapshot = [p.detach().cpu().clone() for p in model.parameters()]
    losses = [float(v) for v in losses]
    print(f"{family} cora ({CORA['nodes']} nodes, nnz {a.nnz}): forward launches "
          f"{json.dumps(fwd_expect)}, {GRAPH_STEPS} Adam steps with {json.dumps(step_expect)} "
          f"each, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{family} cora: loss did not drop: {losses}")
    # the same weights on the CPU
    cpu, cpu_opt, _ = _graph_models(family, "cpu")
    a_cpu = op(adj)
    with torch.no_grad():
        want = cpu(a_cpu, x)
    fwd_err = float((out.cpu() - want).abs().max())
    torch.testing.assert_close(out.cpu(), want, **TOL_FP32)
    cpu_losses, grads = [], None
    for i in range(PARITY_STEPS):
        cpu_losses.append(float(gcn.train_step(cpu, cpu_opt, a_cpu, x, labels, mask)))
        if i == 0:
            grads = [p.grad.clone() for p in cpu.parameters()]
    np.testing.assert_allclose(losses[:PARITY_STEPS], cpu_losses, **TOL_FP32)
    lr = cpu_opt.param_groups[0]["lr"]
    err = 0.0
    for (name, p), g, s in zip(cpu.named_parameters(), grads, snapshot):
        sensitive = g.abs() < 1e-3 * max(float(gg.abs().max()) for gg in grads)
        diff = (s - p.detach()).abs()
        if bool((diff[~sensitive] > 1e-5 + 1e-3 * lr).any()) or bool(
                (diff[sensitive] > 2 * PARITY_STEPS * lr).any()):
            raise AssertionError(f"{family} cora card vs CPU: parameter {name} apart by "
                                 f"{float(diff.max()):.3e}")
        err = max(err, float(diff[~sensitive].max()) if bool((~sensitive).any()) else 0.0)
    print(f"{family} cora card vs CPU: forward max_abs_err {fwd_err:.3e}, {PARITY_STEPS} steps' "
          f"losses within tolerance, parameters max_abs_err {err:.3e} (ok)")
    return {"launches": total, "model": model, "opt": opt, "a": a,
            "batch": (xc, lc, mc)}


def phase_graph_arxiv(task) -> dict:
    """The ogbn-arxiv-shaped GCN (OGB's baseline: 3 layers of width 256) on
    the naive route: a forward and ARXIV_STEPS Adam steps, 3 naive_spmm
    launches each, the loss finite and dropping. The 'tiled' route is not
    run: the block count of a 128^2 plan of this graph says why."""
    import tpusparse_torch as tt
    from tpusparse_torch.models import gcn

    adj, (x, labels, mask) = task
    t0 = time.perf_counter()
    a = tt.normalized_adjacency(_on(adj, "cuda"))
    n = adj.shape[0]
    rows = a.row_ids().astype(np.int64)
    nbc = -(-n // 128)
    nblocks = np.unique((rows // 128) * nbc + np.asarray(a.indices, np.int64) // 128).size
    print(f"gcn arxiv set-up: {time.perf_counter() - t0:.1f} s; {n} nodes, nnz of A-hat "
          f"{a.nnz}, ELL width {tt.ops.resolve_ell_width(a)}; a 128^2 block plan would pack "
          f"{nblocks} blocks ({nblocks * 128 * 128 * 4 / 1e9:.1f} GB of fp32 values for "
          f"{a.nnz} nonzeros, {a.nnz / (nblocks * 128 * 128):.2e} of each block): not run")
    model = tt.GCN(ARXIV["features"], hidden=ARXIV_HIDDEN, num_classes=ARXIV["classes"],
                   spmm_method="naive", device="cuda", generator=torch.Generator().manual_seed(34))
    opt = gcn.make_train_state(model, ARXIV_LR)
    xc, lc, mc = x.cuda(), labels.cuda(), mask.cuda()
    layers = len(ARXIV_HIDDEN) + 1
    kernels_reset()
    with torch.no_grad():
        out = model(a, xc)
    torch.cuda.synchronize()
    _expect("gcn arxiv forward", _launches(), {"naive_spmm": layers})
    total = layers
    losses = []
    for i in range(ARXIV_STEPS):
        kernels_reset()
        losses.append(gcn.train_step(model, opt, a, xc, lc, mc))
        torch.cuda.synchronize()
        _expect(f"gcn arxiv step {i}", _launches(), {"naive_spmm": layers})
        total += layers
    losses = [float(v) for v in losses]
    print(f"gcn arxiv (hidden {ARXIV_HIDDEN}, {ARXIV['classes']} classes): forward "
          f"{layers} naive_spmm, {ARXIV_STEPS} Adam steps with {layers} each, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and bool(torch.isfinite(out).all()) and out.shape == (n, ARXIV["classes"])):
        raise AssertionError(f"gcn arxiv: outputs not finite or loss did not drop: {losses}")
    return {"launches": {"naive_spmm": total}, "model": model, "opt": opt, "a": a,
            "batch": (xc, lc, mc)}


def phase_spmm_routes(a) -> dict:
    """spmm's routes at one shape (Cora's A-hat, n 64): 'naive', 'gather',
    'dense', 'tiled' against 'reference' within the fp32 tier; the same
    matrix as a BSR through 'tiled' and 'naive', and a 3-D b through the
    routes that fold it."""
    import tpusparse_torch as tt

    rng = np.random.default_rng(35)
    b = torch.from_numpy(rng.standard_normal((a.shape[1], 64), dtype=np.float32)).cuda()
    b3 = torch.from_numpy(rng.standard_normal((3, a.shape[1], 16), dtype=np.float32)).cuda()
    bsr = tt.csr_to_bsr(a, (128, 128))
    kernels_reset()
    ref, ref3 = tt.spmm(a, b, method="reference"), tt.spmm(a, b3, method="reference")
    runs = [(f"{m}", tt.spmm(a, b, method=m), ref) for m in ("naive", "gather", "dense", "tiled")]
    runs += [(f"bsr {m}", tt.spmm(bsr, b, method=m), ref) for m in ("tiled", "naive")]
    runs += [(f"3-D {m}", tt.spmm(a, b3, method=m), ref3) for m in ("naive", "gather", "dense")]
    torch.cuda.synchronize()
    counts = _launches()
    _expect("spmm routes", counts, {"naive_spmm": 3, "block_ell_spmm": 2})
    for label, got, want in runs:
        ok = got.shape == want.shape and torch.allclose(got, want, **TOL_FP32)
        print(f"spmm route {label}: against 'reference' max_abs_err "
              f"{float((got - want).abs().max()):.3e}, {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"spmm route {label} disagrees with 'reference'")
    return {"naive_spmm": counts["naive_spmm"], "block_ell_spmm": counts["block_ell_spmm"]}


def phase_naive_timings(a) -> dict:
    """The naive kernel at the arxiv-shaped A-hat: sum at n 256 and 40, max
    with its arg at n 256; each against its plain version, gather_spmm and
    torch.sparse.mm on a CSR tensor (cuSPARSE, TF32 off), with its bound
    from this run's nonzeros; the sum at each strip width of B
    (NAIVE_STRIP_SWEEP, each bitwise equal to the plain version), the
    gathers' rate and, as a design figure, their bytes at the rate L2 gives
    a streaming read. Returns the kernels line's row."""
    import tpusparse_torch as tt
    from tpusparse_torch.kernels import naive_spmm as nk
    from tpusparse_torch.utils.config import fp32_matmul

    m, k = a.shape
    ell = tt.ops.ell_pack_traced(a)
    crow = torch.from_numpy(np.asarray(a.indptr, np.int64)).cuda()
    col = torch.from_numpy(np.asarray(a.indices, np.int64)).cuda()
    a_sp = torch.sparse_csr_tensor(crow, col, a.data, size=a.shape)
    rng = np.random.default_rng(36)
    # L2's read rate as a streaming read attains it: a 16 MiB buffer, held
    # in L2 after the first pass, summed behind a sleep once a call and 32
    # times in one call (a reduction over a stride-0 view, so one kernel
    # streams 512 MiB from L2); the faster rate makes the design figure
    buf = torch.ones(4 << 20, device="cuda")
    reads = {1: time_ms_ahead(lambda: buf.sum()),
             32: time_ms_ahead(lambda: buf.expand(32, -1).sum())}
    rates = {r: r * buf.nbytes / (ms * 1e-3) for r, ms in reads.items()}
    l2_rate = max(rates.values())
    print("L2 streaming read of a 16 MiB buffer, behind a sleep: " + "; ".join(
        f"read {r} time(s) a call {reads[r]:.4f} ms, {rates[r] / 1e12:.2f} TB/s" for r in reads))
    del buf
    row = None
    for n in NAIVE_TIMING_N:
        b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).cuda()
        got = nk.naive_spmm_kernel(ell, a.shape, b)
        plain = nk._naive_spmm_plain(ell, a.shape, b)
        err = float((got - plain).abs().max())
        with fp32_matmul():
            lib = torch.sparse.mm(a_sp, b)
            lib_err = rel_err(lib, got)[1]
            lib_ms = time_ms_queued(lambda: torch.sparse.mm(a_sp, b))
        del plain, lib
        ms = time_ms_queued(lambda: nk.naive_spmm_kernel(ell, a.shape, b))
        plain_ms = time_ms(lambda: nk._naive_spmm_plain(ell, a.shape, b), warmup=1, iters=3)
        gather_ms = time_ms_queued(lambda: tt.gather_spmm(a, b), reps=5)
        # each ELL entry visited once (index, value), the row counts, B once, C once
        nbytes = 8.0 * a.nnz + 4.0 * m + 4.0 * k * n + 4.0 * m * n
        flops = 2.0 * a.nnz * n
        bms, by = bound(flops, nbytes)
        print(f"naive_spmm sum arxiv ({m}^2, nnz {a.nnz}, L {ell[0].shape[1]}) x ({k}, {n}) fp32: "
              f"kernel {ms:.4f} ms queued, plain {plain_ms:.4f} ms, gather_spmm {gather_ms:.4f} "
              f"ms, torch.sparse.mm (CSR) {lib_ms:.4f} ms (vs kernel {lib_err:.2e} of scale); "
              f"bound {bms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
              f"kernel at {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of compulsory traffic; kernel vs "
              f"plain max_abs_err {err:.1e}")
        if not (err == 0.0 and lib_err < 1e-4):
            raise AssertionError(f"naive_spmm at arxiv n {n}: kernel vs plain {err:.3e}, vs "
                                 f"torch.sparse.mm {lib_err:.3e}")
        with fp32_matmul():  # both behind a sleep: no host time in either
            ahead = (time_ms_ahead(lambda: nk.naive_spmm_kernel(ell, a.shape, b)),
                     time_ms_ahead(lambda: torch.sparse.mm(a_sp, b)))
        old = OLD_MS.get(f"naive_spmm arxiv n {n}")
        was = f" (the whole-row kernel before its redesign {old:.4f}: {old / ahead[0]:.2f}x)" \
            if old else ""
        gathers = 4.0 * a.nnz * n  # each stored entry reads its row of B, strip by strip
        print(f"naive_spmm sum arxiv n {n} behind a sleep: kernel {ahead[0]:.4f} ms{was}, "
              f"torch.sparse.mm {ahead[1]:.4f} ms (kernel/library {ahead[0] / ahead[1]:.2f}); "
              f"gathers {gathers / 1e9:.3f} GB at {gathers / (ahead[0] * 1e-3) / 1e12:.2f} TB/s; "
              f"design figure {gathers / l2_rate * 1e3:.4f} ms (the gathers at L2's streaming "
              f"read rate), {gathers / l2_rate * 1e3 / ahead[0]:.3f} of the kernel's time")
        sweep = {}
        for sw in NAIVE_STRIP_SWEEP:
            strips = nk._naive_spmm_strips(ell, a.shape, b, "sum", False, 0, sw)
            if not _same(strips, got):
                raise AssertionError(f"naive_spmm at arxiv n {n}, strips of {sw} columns: not "
                                     "bitwise equal to the plain version")
            sweep[sw] = time_ms_ahead(
                lambda: nk._naive_spmm_strips(ell, a.shape, b, "sum", False, 0, sw))
        del strips
        print(f"naive_spmm sum arxiv n {n} by the width of B's column strips, behind a sleep, "
              f"each bitwise equal to the plain version: " + ", ".join(
                  f"{sw} columns ({k * sw * 4 / 1e6:.1f} MB of B) {t:.4f} ms"
                  for sw, t in sweep.items()) + f"; the kernel's choice {ahead[0]:.4f} ms")
        if n == NAIVE_TIMING_N[0]:
            row = {"name": "naive_spmm", "route": "cuda",
                   "source": "tpusparse_torch/csrc/naive_spmm.cu",
                   "replaces": "tpusparse/kernels/naive_spmm.py:68 (_naive_kernel)",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "library_ms": lib_ms}
            kw = dict(reduce="max", return_arg=True, nnz=a.nnz)
            got = nk.naive_spmm_kernel(ell, a.shape, b, **kw)
            plain = nk._naive_spmm_plain(ell, a.shape, b, **kw)
            same = _same(got[0], plain[0]) and _same(got[1], plain[1])
            del got, plain
            ms = time_ms_queued(lambda: nk.naive_spmm_kernel(ell, a.shape, b, **kw))
            plain_ms = time_ms(lambda: nk._naive_spmm_plain(ell, a.shape, b, **kw),
                               warmup=1, iters=3)
            bms, by = bound(flops, nbytes + 4.0 * m + 4.0 * m * n)
            print(f"naive_spmm max + arg arxiv n {n}: kernel {ms:.4f} ms queued, plain "
                  f"{plain_ms:.4f} ms, bound {bms:.4f} ms by {by}; bitwise equal to the plain "
                  f"version: {same}")
            if not same:
                raise AssertionError("naive_spmm max + arg at arxiv disagrees with its plain "
                                     "version")
        del b
    return row


def phase_graph_step_timings(runs) -> None:
    """ms per Adam step (CUDA events around one step, median) of each graph
    configuration, and the device's busy share of a step from torch.profiler."""
    from tpusparse_torch.models import gcn

    for label, r in runs.items():
        model, opt, a = r["model"], r["opt"], r["a"]
        xc, lc, mc = r["batch"]
        step = lambda: gcn.train_step(model, opt, a, xc, lc, mc)  # noqa: E731
        ms = time_ms(step, warmup=2, iters=5 if "arxiv" in label else 20)
        busy, nk = _busy_ms(step, n=3)
        print(f"{label} Adam step: {ms:.4f} ms per step; device busy {busy:.4f} ms "
              f"({nk:.0f} kernels) per step, busy share {busy / ms:.3f}")


def phase_wide_timings() -> None:
    """The seven attention entry points at (b, h, s, d) = WIDE_SHAPE, fp32
    'high' (flash_q8 at its own tier): kernel against plain and bound, SDPA
    as the yardstick (the block kernels' with the token-exact mask; its
    autograd backward behind a sleep); then the two forwards and both
    backwards in fp32 'default' and on bf16 operands."""
    from torch.nn.attention import sdpa_kernel

    import tpusparse_torch as tt
    from tpusparse_torch.kernels import block_flash_attention as bfa
    from tpusparse_torch.kernels import flash_attention as fa
    from tpusparse_torch.utils.config import fp32_matmul

    b, h, s, d = WIDE_SHAPE
    bh = b * h
    q, k, v, do = _flash_operands((bh, s, d), 1300)
    kw = dict(sm_scale=1 / d ** 0.5, causal=False, precision="high")
    got, want = _flash_pair(q, k, v, do, kw)
    errs = {n: rel_err(g, w)[1] for n, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want)}
    if not all(e <= FLASH_LIMIT_FP32 for e in errs.values()):
        raise AssertionError(f"flash at d {d}: kernel vs plain {errs}")
    o, lse = got[0], got[1]
    delta = _delta(do, o)
    del got, want
    plan = tt.BlockAttnPlan(tt.bigbird_block_mask(s, PATTERN_WINDOW), PATTERN_WINDOW,
                            PATTERN_WINDOW, s)
    bkw = dict(sm_scale=1 / d ** 0.5, precision="high")
    bgot, bwant = _blk_pair(q, k, v, do, plan, bkw)
    berrs = {n: rel_err(g, w)[1] for n, g, w in zip(("o", "lse", "dq", "dk", "dv"), bgot, bwant)}
    if not all(e <= FLASH_LIMIT_FP32 for e in berrs.values()):
        raise AssertionError(f"block flash at d {d}: kernel vs plain {berrs}")
    bo, blse = bgot[0], bgot[1]
    bdelta = _delta(do, bo)
    del bgot, bwant
    kq, ks, vq, vs = fa.quantize_kv(k, v)
    qkw = dict(sm_scale=1 / d ** 0.5, causal=False)
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd_kernel(q, k, v, **kw),
                      lambda: fa._flash_fwd_plain(q, k, v, **kw)),
        "flash_dq": (lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, **kw),
                     lambda: fa._flash_dq_plain(q, k, v, do, lse, delta, **kw)),
        "flash_dkv": (lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, **kw),
                      lambda: fa._flash_dkv_plain(q, k, v, do, lse, delta, **kw)),
        "blk_flash_fwd": (lambda: bfa.blk_flash_fwd_kernel(q, k, v, plan, **bkw),
                          lambda: bfa._blk_fwd_plain(q, k, v, plan, **bkw)),
        "blk_flash_dq": (lambda: bfa.blk_flash_dq_kernel(q, k, v, do, blse, bdelta, plan, **bkw),
                         lambda: bfa._blk_dq_plain(q, k, v, do, blse, bdelta, plan, **bkw)),
        "blk_flash_dkv": (
            lambda: bfa.blk_flash_dkv_kernel(q, k, v, do, blse, bdelta, plan, **bkw),
            lambda: bfa._blk_dkv_plain(q, k, v, do, blse, bdelta, plan, **bkw)),
        "flash_q8": (lambda: fa.flash_q8_kernel(q, kq, vq, ks, vs, **qkw),
                     lambda: fa._flash_q8_plain(q, kq, vq, ks, vs, **qkw)),
    }
    q8_err = rel_err(fns["flash_q8"][0](), fns["flash_q8"][1]())[1]
    if q8_err > FLASH_LIMIT_ROUNDED:
        raise AssertionError(f"flash_q8 at d {d}: kernel vs plain {q8_err:.3e}")
    qkv, stat = 4.0 * bh * s * d, 4.0 * bh * s
    entries = float(bh * s * s)
    bentries = float(bh * plan.covered_tiles * plan.block_q * plan.block_k)
    # (flops, bytes, peak): each input read once, each output written once;
    # the fp32 'high' rows on 3xTF32 (peak None: bound_fp32)
    work = {
        "flash_fwd": (4 * entries * d, 4 * qkv + stat, None),
        "flash_dq": (6 * entries * d, 5 * qkv + 2 * stat, None),
        "flash_dkv": (8 * entries * d, 6 * qkv + 2 * stat, None),
        "blk_flash_fwd": (4 * bentries * d, 4 * qkv + stat, None),
        "blk_flash_dq": (6 * bentries * d, 5 * qkv + 2 * stat, None),
        "blk_flash_dkv": (8 * bentries * d, 6 * qkv + 2 * stat, None),
        "flash_q8": (4 * entries * d, bh * s * d * (4 + 1 + 1 + 4) + 8.0 * bh, BF16_FLOPS),
    }
    q4, k4, v4, do4 = (t.view(b, h, s, d) for t in (q, k, v, do))
    mask = plan.token_mask(q.device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = {}
    for key, attn_mask in (("full", None), ("masked", mask)):
        backend = _sdpa_backend(q4, k4, v4, attn_mask)
        with sdpa_kernel([backend]), fp32_matmul():
            fwd_ms = time_ms_queued(lambda: sdpa(q4, k4, v4, attn_mask=attn_mask))
            qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
            og = sdpa(qg, kg, vg, attn_mask=attn_mask)
            bwd_ms = time_ms_ahead(  # its host work would bound a queued time
                lambda: torch.autograd.grad(og, (qg, kg, vg), do4, retain_graph=True))
        lib[key] = (fwd_ms, bwd_ms, backend.name)
        del qg, kg, vg, og
    qb, kb, vb = (x.to(torch.bfloat16).view(b, h, s, d) for x in
                  (q, kq.float() * ks[:, None, None], vq.float() * vs[:, None, None]))
    backend = _sdpa_backend(qb, kb, vb)
    with sdpa_kernel([backend]):
        lib["q8"] = (time_ms_queued(lambda: sdpa(qb, kb, vb)), None, backend.name)
    for name, (kern, plain) in fns.items():
        ms = time_ms_queued(kern)
        plain_ms = time_ms_queued(plain, reps=5)
        flops, nbytes, peak = work[name]
        if peak is None:
            bms, by, ffma = bound_fp32(flops, nbytes)
            design = f"; 3xTF32, FFMA design figure {ffma:.4f} ms"
        else:
            (bms, by), design = bound(flops, nbytes, peak), ""
        key = "q8" if name == "flash_q8" else ("masked" if name.startswith("blk") else "full")
        fwd_ms, bwd_ms, backend = lib[key]
        lib_ms = fwd_ms if name.endswith(("fwd", "q8")) else bwd_ms
        old = OLD_MS.get(f"{name} d {d} high" if name.endswith("fwd") else f"{name} d {d}")
        was = ((f" (first port {old:.3f})" if name == "flash_q8" else
                f" (the FFMA kernel before its redesign {old:.3f}: {old / ms:.2f}x)")
               if old else "")
        print(f"{name} {WIDE_SHAPE} d {d} ({'bigbird block 64, ' if key == 'masked' else ''}"
              f"{'int8 K/V' if key == 'q8' else 'fp32 high'}): kernel {ms:.4f} ms queued{was}, "
              f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP"
              f"{design}), "
              f"kernel at {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, {bms / ms:.3f} of the bound; "
              f"sdpa ({backend}) "
              f"{'forward' if name.endswith(('fwd', 'q8')) else 'autograd backward behind a sleep'}"
              f" {lib_ms:.4f} ms")
    _wide_forward_tiers(q, k, v, plan, mask, work)
    _flash_bwd_times("wide", q, k, v, do, WIDE_SHAPE)
    _blk_bwd_tiers("wide", WIDE_SHAPE, q, k, v, do, plan,
                   {n: work[f"blk_flash_{n}"][:2] for n in ("dq", "dkv")}, {})
    print(f"d {d} kernel vs plain over scale: flash " + ", ".join(
        f"{n} {e:.2e}" for n, e in errs.items()) + "; block " + ", ".join(
        f"{n} {e:.2e}" for n, e in berrs.items()) + f"; flash_q8 o {q8_err:.2e}")


def _wide_forward_tiers(q, k, v, plan, mask, work) -> None:
    """flash_fwd and blk_flash_fwd at WIDE_SHAPE in fp32 'default' and on
    bf16 operands (fp32 'high' is phase_wide_timings' own row), each checked
    against its plain version, timed beside bf16 SDPA (the block kernel's
    with the token-exact mask) and bound on the bf16 tensor cores."""
    from torch.nn.attention import sdpa_kernel

    from tpusparse_torch.kernels import block_flash_attention as bfa
    from tpusparse_torch.kernels import flash_attention as fa

    b, h, s, d = WIDE_SHAPE
    bh = b * h
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf = [x.to(torch.bfloat16) for x in (q, k, v)]
    lib = {}
    for key, attn_mask in (("full", None), ("masked", mask)):
        o4 = [x.view(b, h, s, d) for x in bf]
        backend = _sdpa_backend(*o4, attn_mask=attn_mask)
        with sdpa_kernel([backend]):
            lib[key] = (time_ms_queued(lambda: sdpa(*o4, attn_mask=attn_mask)), backend.name)
    for tier, ops, prec in (("fp32 'default'", (q, k, v), "default"),
                            ("bf16 operands", bf, "high")):
        runs = {
            "flash_fwd": (lambda: fa.flash_fwd_kernel(*ops, sm_scale=1 / d ** 0.5, precision=prec),
                          lambda: fa._flash_fwd_plain(*ops, sm_scale=1 / d ** 0.5,
                                                      precision=prec), "full"),
            "blk_flash_fwd": (
                lambda: bfa.blk_flash_fwd_kernel(*ops, plan, sm_scale=1 / d ** 0.5,
                                                 precision=prec),
                lambda: bfa._blk_fwd_plain(*ops, plan, sm_scale=1 / d ** 0.5, precision=prec),
                "masked"),
        }
        for name, (kern, plain, key) in runs.items():
            got, want = kern(), plain()
            err = max(rel_err(got[0], want[0])[1], rel_err(got[1], want[1])[1])
            if not (err <= FLASH_LIMIT_ROUNDED and bool(torch.isfinite(got[0].float()).all())):
                raise AssertionError(f"{name} at d {d} {tier}: kernel vs plain {err:.2e}")
            del got, want
            ms = time_ms_queued(kern)
            flops = work[name][0]
            nbytes = 4 * ops[0].element_size() * bh * s * d + 4.0 * bh * s
            bms, by = bound(flops, nbytes, BF16_FLOPS)
            lib_ms, backend = lib[key]
            print(f"{name} {WIDE_SHAPE} d {d} ({'bigbird block 64, ' if key == 'masked' else ''}"
                  f"{tier}): kernel {ms:.4f} ms queued, bound {bms:.4f} ms by {by} "
                  f"({flops / 1e9:.2f} GFLOP), kernel at {flops / (ms * 1e-3) / 1e12:.2f} "
                  f"TFLOP/s, {bms / ms:.3f} of the bound; sdpa bf16 ({backend}) forward "
                  f"{lib_ms:.4f} ms (kernel/sdpa {ms / lib_ms:.2f}); vs plain {err:.2e} of scale")


# -- batched (3-D) block SpMM and the executors of the derived plans ---------------

# the full-width batched shapes of bench.py: label, A's kind, shape, density
# (block occupancy for 'blocks'), B's shape
BATCHED_SHAPES = (
    ("block-sparse batched", "blocks", (2048, 2048), 0.10, (32, 2048, 512)),  # bench.py:480-520
    ("bert4d", "random", (512, 512), 0.10, (4096, 512, 64)),  # bench.py:437-478
)
# the low-fill plan: 4096^2 at 1 %, blocks 8 x 32, n 256 (the shape class of
# benchmarks/RESULTS.md:75-78; the density is chosen here)
LOW_FILL = dict(shape=(4096, 4096), density=0.01, blocksize=(8, 32), n=256)
PLAN_EXECUTORS = ("compact_spmm", "grouped_spmm", "footprint_spmm")


def _derived_plans(plan, group_size=64, rows_per_super=16):
    """{entry: (derived plan, kernel wrapper)}; the defaults are JAX's."""
    import tpusparse_torch as tt
    from tpusparse_torch.kernels import tiled_spmm as tk

    return {"compact_spmm": (tt.compact_plan(plan), tk.compact_spmm_kernel),
            "grouped_spmm": (tt.group_plan(plan, group_size), tk.grouped_spmm_kernel),
            "footprint_spmm": (tt.footprint_plan(plan, rows_per_super),
                               tk.footprint_spmm_kernel)}


def phase_small_plan_executors() -> None:
    """The batched, compact, grouped and footprint kernels against their
    plain versions at small shapes: ragged m, k and n, n 1, blocksizes
    (5, 8), (8, 32), (24, 16), (32, 16) (the n-major tile), (64, 64),
    (72, 32), (128, 128) and (200, 16) (taller than a grouped window),
    row-blocks with no slot, batch 1 to 5, fp32 'high' and 'default' and
    bf16. The batched and compact kernels are block_ell_spmm's body
    (block_ell_spmm.cuh), so they are held bitwise to it: the batched
    kernel on the folded B and on every B[g] alone, the compact one on the
    base plan. The grouped and
    footprint kernels share one FFMA chain (window_tiles.cuh): each is held
    bitwise to the other on the base plan, and within the tier of
    block_ell_spmm (`_ffma_pair_base`)."""
    import tpusparse_torch as tt
    from tpusparse_torch.kernels import tiled_spmm as tk

    f32, bf16 = torch.float32, torch.bfloat16
    # (m, k, n), blocksize, empty rows, batch
    shapes = [((100, 70, 130), (8, 32), (16, 40), 5), ((75, 53, 33), (32, 16), None, 1),
              ((43, 37, 1), (5, 8), (10, 20), 4), ((100, 70, 130), (24, 16), (24, 48), 2),
              ((150, 90, 64), (72, 32), (72, 144), 3),
              ((190, 150, 70), (64, 64), (64, 128), 5), ((300, 260, 200), (128, 128),
                                                         (128, 256), 1),
              ((610, 150, 70), (200, 16), (200, 400), 1)]
    tiers = [(f32, "high"), (f32, "default"), (bf16, "high")]
    seed = 50
    for (m, k, n), bs, empty, batch in shapes:
        for dt, prec in tiers:
            seed += 1
            a_np, rng = _dense_case(seed, m, k, 0.12, empty)
            a = tt.CSR.from_dense(a_np, device="cuda")
            plan = tt.build_plan(a, bs)
            bv = plan.pack_values(a.data.to(dt))
            b3 = torch.from_numpy(rng.standard_normal((batch, k, n)).astype(np.float32)).to(
                "cuda", dt)
            label = f"{m}x{k}x{n}_{bs[0]}x{bs[1]}_b{batch}_{str(dt)[6:]}_{prec}"
            got = tk.resident_spmm_batched_kernel(plan, bv, b3, precision=prec)
            per_g = torch.stack([tk.tiled_spmm_kernel(plan, bv, b3[g].contiguous(),
                                                      precision=prec) for g in range(batch)])
            folded = tt.ops._fold_batch(
                lambda x: tk.tiled_spmm_kernel(plan, bv, x, precision=prec), b3)
            want = tk._block_exec_batched_plain(plan, bv, b3, precision=prec)
            torch.cuda.synchronize()
            if not (_same(got, folded) and _same(got, per_g)):
                raise AssertionError(f"batched {label}: not bitwise equal to block_ell_spmm on "
                                     "the folded B and on each B[g]")
            _check_case(f"batched {label}", got, want, ", bitwise equal to block_ell_spmm "
                        "on the folded B and per batch element")
            b = b3[0].contiguous()
            # groups and supers of 4 row-blocks: several per plan
            derived = _derived_plans(plan, 4, 4)
            outs = {}
            for entry, (dp, fn) in derived.items():
                dv = dp.pack_values(a.data.to(dt))
                outs[entry] = got = fn(dp, dv, b, precision=prec)
                want = tk._PLAIN[entry](dp, dv, b, precision=prec)
                torch.cuda.synchronize()
                _check_case(f"{entry} {label}", got, want)
            if not _same(outs["compact_spmm"], per_g[0]):
                raise AssertionError(f"compact_spmm {label}: not bitwise equal to block_ell_spmm")
            _ffma_pair_base(f"small {label}", outs, per_g[0])
            print(f"small plan executors {label}: compact bitwise equal to block_ell_spmm, "
                  "grouped to footprint")


def _ffma_pair_base(label, outs, tc):
    """The grouped and footprint executors share one FFMA chain
    (window_tiles.cuh): each output bitwise equal to the other's on the same
    base plan, and within the tier of the tensor-core block_ell_spmm's `tc`
    on the same operands (TOL_FP32, or TOL_BF16_OUT for a bf16 C)."""
    got, other = outs["grouped_spmm"], outs["footprint_spmm"]
    if not _same(got, other):
        raise AssertionError(f"{label}: grouped and footprint not bitwise equal")
    tol = TOL_BF16_OUT if got.dtype == torch.bfloat16 else TOL_FP32
    if not torch.allclose(got.float(), tc.float(), **tol):
        raise AssertionError(f"{label}: the FFMA pair and block_ell_spmm differ beyond the tier")

def _sddmm_f64(plan, dc, b):
    """The SDDMM of plan's pattern in float64, (num_slots, bm, bk): the oracle
    of sums over n too long for the fp32 plain version."""
    dense = dc.double() @ b.double().t()  # (m, k)
    bm, bk = plan.blocksize
    nbr, L = plan.num_row_blocks, plan.ell_width
    dp = dense.new_zeros((nbr * bm, plan.num_col_blocks * bk))
    dp[:dense.shape[0], :dense.shape[1]] = dense
    tiles = dp.reshape(nbr, bm, -1, bk).permute(0, 2, 1, 3)  # (nbr, nbc, bm, bk)
    cols = plan.index_tensor("block_cols", dc.device).reshape(nbr, L).long()
    out = tiles[torch.arange(nbr, device=dc.device)[:, None], cols]
    valid = plan.slot_valid_mask(dc.device).bool()[..., None, None]
    return torch.where(valid, out, 0.0).reshape(plan.num_slots, bm, bk)


def _batched_operands(kind, shape, density, bshape, seed):
    import tpusparse_torch as tt
    from tpusparse_torch.utils.matrices import block_sparse_csr

    if kind == "blocks":
        a = block_sparse_csr(seed, shape, (128, 128), density, device="cuda")
    else:
        a = tt.random_csr(seed, shape, density, device="cuda")
    rng = np.random.default_rng(seed + 1)
    b3 = torch.from_numpy(rng.random(bshape, dtype=np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((bshape[0], shape[0], bshape[2]),
                                             dtype=np.float32)).cuda()
    return a, b3, g


def phase_batched_spmm() -> dict:
    """bench.py's two batched shapes at full width, fp32 'high': one
    training step of tiled_spmm(a, b3) with grads in a.data and b3, counted
    (1 resident_spmm_batched forward, 1 sddmm on the folded batch, 1
    resident_spmm_batched dB where the transpose plan passes the reuse
    test), its forward and dB against the plain versions and its dA against
    float64 (the fp32 plain version's own error over n = 262,144 is larger
    than the kernel's); the batched kernel bitwise against block_ell_spmm
    on B[g] and on the fold; then the times of the batched
    kernel, of the fold (the 2-D kernel on (k, batch·n), transposes
    included), of the plain version and of torch.matmul of the densified A
    broadcast over the batch (TF32 off), the bound and the step. Returns
    the kernels line's row (block-sparse batched shape) and the launches of
    every kernel in the counted steps."""
    import tpusparse_torch as tt
    from tpusparse_torch.kernels import sddmm as sk
    from tpusparse_torch.kernels import tiled_spmm as tk
    from tpusparse_torch.kernels.sddmm import _sddmm_plain
    from tpusparse_torch.utils.config import fp32_matmul

    row, launches = None, dict(NO_LAUNCH)
    for seed, (label, kind, shape, density, bshape) in zip((21, 11), BATCHED_SHAPES):
        a, b3, g = _batched_operands(kind, shape, density, bshape, seed)
        batch, k, n = bshape
        plan, plan_t, t_perm = tt.build_plan_pair(a)
        data = a.data.clone().requires_grad_(True)
        bb = b3.clone().requires_grad_(True)
        a_var = tt.CSR(data, a.indices, a.indptr, a.shape)
        torch.cuda.synchronize()
        kernels_reset()
        out = tt.tiled_spmm(a_var, bb)
        out.backward(g)
        torch.cuda.synchronize()
        counts = _launches()
        db_entry = ("resident_spmm_batched" if plan_t.nblocks >= plan_t.num_col_blocks
                    else "block_ell_spmm")
        expect = {"resident_spmm_batched": 1, "sddmm": 1}
        expect[db_entry] = expect.get(db_entry, 0) + 1
        _expect(f"batched {label} step", counts, expect)
        launches = {kn: v + counts[kn] for kn, v in launches.items()}
        bv = plan.pack_values(a.data)
        err, rel = over_scale(out.detach(), tk._block_exec_batched_plain(plan, bv, b3))
        fold_g, fold_b = tt.ops._fold_cols(g), tt.ops._fold_cols(b3)
        # dA sums over batch * n (262,144 at bert4d): held against float64, since
        # the fp32 plain version's own rounding there exceeds the kernel's
        da64 = plan.unpack_values(_sddmm_f64(plan, fold_g, fold_b))
        da_err, da_rel = over_scale(data.grad, da64)
        da_plain_rel = over_scale(plan.unpack_values(_sddmm_plain(plan, fold_g, fold_b)),
                                  da64)[1]
        del fold_g, fold_b, da64
        bv_t = plan_t.pack_values(a.data[plan_t.perm_tensor("t_perm", t_perm, "cuda")])
        db_err, db_rel = over_scale(bb.grad, tk._block_exec_batched_plain(plan_t, bv_t, g))
        print(f"batched {label} ({shape[0]}x{shape[1]}, {plan.nblocks} of "
              f"{plan.num_row_blocks * plan.num_col_blocks} blocks, B {bshape}): step "
              f"launches {json.dumps({n_: c for n_, c in counts.items() if c})}; over scale: "
              f"C {rel:.3e} and dB {db_rel:.3e} vs plain, dA {da_rel:.3e} vs float64 (the "
              f"plain version's dA vs float64 {da_plain_rel:.3e})")
        if not (max(rel, da_rel, db_rel) <= HEADLINE_TOL and bool(torch.isfinite(out).all())
                and bool(torch.isfinite(data.grad).all()) and bool(torch.isfinite(bb.grad).all())):
            raise AssertionError(f"batched {label}: step disagrees with the plain versions")
        del out
        got = tk.resident_spmm_batched_kernel(plan, bv, b3)

        def fold():
            return tt.ops._fold_batch(lambda x: tk.resident_spmm_kernel(plan, bv, x), b3)

        for gi in (0, batch - 1):  # one body: bitwise equal to block_ell_spmm on B[g] alone
            if not _same(got[gi], tk.tiled_spmm_kernel(plan, bv, b3[gi].contiguous())):
                raise AssertionError(f"batched {label}: not bitwise equal to block_ell_spmm")
        if not _same(got, tk.resident_spmm_batched_kernel(plan, bv, b3)):
            raise AssertionError(f"batched {label}: a second call differs")
        if not _same(got, fold()):
            raise AssertionError(f"batched {label}: kernel and fold not bitwise equal")
        print(f"batched {label}: kernel bitwise equal to block_ell_spmm on B[g] at elements 0 "
              f"and {batch - 1}, to the fold onto it and to a second call")
        ms = time_ms(lambda: tk.resident_spmm_batched_kernel(plan, bv, b3))
        fold_ms = time_ms(fold)
        plain_ms = time_ms(lambda: tk._block_exec_batched_plain(plan, bv, b3), warmup=1, iters=3)
        a_dense = plan.blocks_to_dense(bv)
        with fp32_matmul():
            lib_err = rel_err(torch.matmul(a_dense, b3), got)[1]
            lib_ms = time_ms(lambda: torch.matmul(a_dense, b3))
        del a_dense, got

        def step():
            data.grad = bb.grad = None
            tt.tiled_spmm(a_var, bb).backward(g)

        step_ms = time_ms(step, warmup=1, iters=5)
        _profile(f"batched {label} step", step, 2, top=6)
        bm, bk = plan.blocksize
        flops = 2.0 * plan.nblocks * bm * bk * n * batch
        nbytes = 4.0 * (plan.nblocks * bm * bk + batch * k * n + batch * shape[0] * n)
        bms, by, ffma = bound_fp32(flops, nbytes)
        old = OLD_MS[f"resident_spmm_batched {label}"]
        print(f"batched {label}: resident_spmm_batched {ms:.4f} ms (the FFMA kernel before its "
              f"redesign {old:.3f}: {old / ms:.2f}x; {ms / lib_ms:.3f}x torch.matmul's time, "
              f"{bms / ms:.3f} of the bound), fold (2-D kernel on "
              f"(k, batch*n), transposes included) {fold_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.matmul dense broadcast {lib_ms:.4f} ms (vs kernel {lib_err:.2e} of scale; "
              f"{2.0 * shape[0] * k * n * batch / 1e9:.1f} GFLOP dense), bound {bms:.4f} ms by "
              f"{by} (3xTF32: 3 x {flops / 1e9:.2f} GFLOP of blocks, "
              f"{2.0 * a.nnz * n * batch / 1e9:.2f} GFLOP of nonzeros, {nbytes / 1e6:.1f} MB; "
              f"FFMA design figure {ffma:.4f} ms), kernel at "
              f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; training step {step_ms:.4f} ms")
        # the step's dA: sddmm on the batch folded into n
        fold_g, fold_b = tt.ops._fold_cols(g), tt.ops._fold_cols(b3)
        nf = fold_g.shape[1]
        splits = sk.sddmm_splits(sk.sddmm_tiles(plan), nf, sk._sm_count(0))
        da_ms = time_ms(lambda: sk.sddmm_kernel(plan, fold_g, fold_b))
        da_flops = 2.0 * plan.nblocks * bm * bk * nf
        da_bms = bound_fp32(da_flops, 4.0 * (shape[0] * nf + k * nf
                                             + plan.num_slots * bm * bk))[0]
        old = OLD_MS.get(f"sddmm {label}")
        print(f"batched {label} dA (sddmm on (m, batch*n) = ({shape[0]}, {nf}), {splits} "
              f"range(s) of n): {da_ms:.4f} ms"
              + (f" (FFMA kernel before its redesign {old:.2f}: {old / da_ms:.2f}x)" if old else "")
              + f", bound {da_bms:.4f} ms on 3xTF32 (3 x {da_flops / 1e9:.1f} GFLOP), "
              f"{da_flops / (da_ms * 1e-3) / 1e12:.2f} TFLOP/s, {da_bms / da_ms:.3f} of its bound")
        del fold_g, fold_b
        if kind == "blocks":
            row = {"name": "resident_spmm_batched", "route": "cuda",
                   "source": "tpusparse_torch/csrc/block_ell_spmm_batched.cu",
                   "replaces": "tpusparse/kernels/tiled_spmm.py:420 (_resident_batched_kernel; "
                               "pallas_call l.600)",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "library_ms": lib_ms}
        del a, b3, g, data, bb, a_var, bv, bv_t
    return {"row": row, "launches": launches}


def _grouped_geometry(gp, n) -> str:
    from tpusparse_torch.kernels import tiled_spmm as tk

    g = tk.grouped_tile(gp, n)
    return (f"{g['grid'][0]} x {g['grid'][1]} = {g['grid'][0] * g['grid'][1]} thread blocks, "
            f"each a window of {g['rows']} x {g['cols']}")


def phase_plan_executors(a, plan, bv, b) -> dict:
    """The compact, grouped and footprint executors at the headline and at
    the low-fill plan, each driven once with the counts set to 0 just
    before (1 launch each), then held against its plain version, compact
    bitwise against block_ell_spmm on the same plan and grouped against
    footprint, and timed beside block_ell_spmm, its plain version,
    torch.matmul of the densified A (TF32 off) and, at the low-fill plan,
    torch.sparse.mm on a CSR tensor; the footprint plan's B-tile fetches (ntiles) against the base plan's slots;
    the grouped kernel's grid; the grouped and footprint kernels beside
    their earlier times (OLD_MS, SHARED_TILE_MS);
    then one spmm(method='footprint') step at the headline, counted (1
    footprint_spmm, 1 sddmm, 1 block_ell_spmm) and checked. Returns the
    kernels line's rows (headline) and the launches."""
    import tpusparse_torch as tt
    from tpusparse_torch.kernels import tiled_spmm as tk
    from tpusparse_torch.kernels.sddmm import _sddmm_plain
    from tpusparse_torch.utils.config import fp32_matmul

    lf = LOW_FILL
    low = tt.random_csr(41, lf["shape"], lf["density"], device="cuda")
    low_plan = tt.build_plan(low, lf["blocksize"])
    low_b = torch.from_numpy(np.random.default_rng(42).random(
        (lf["shape"][1], lf["n"]), dtype=np.float32)).cuda()
    cases = (("headline", a, plan, bv, b),
             ("low-fill", low, low_plan, low_plan.pack_values(low.data), low_b))
    rows, launches = {}, dict(NO_LAUNCH)
    for label, aa, pp, pv, bb in cases:
        t0 = time.perf_counter()
        derived = _derived_plans(pp)
        packed = {e: dp.pack_values(aa.data) for e, (dp, _) in derived.items()}
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        kernels_reset()
        outs = {e: fn(dp, packed[e], bb) for e, (dp, fn) in derived.items()}
        torch.cuda.synchronize()
        counts = _launches()
        _expect(f"plan executors {label}", counts, dict.fromkeys(PLAN_EXECUTORS, 1))
        launches = {kn: v + counts[kn] for kn, v in launches.items()}
        m, k = pp.shape
        n = bb.shape[1]
        bm, bk = pp.blocksize
        base = tk.tiled_spmm_kernel(pp, pv, bb)
        _ffma_pair_base(f"plan executors {label}", outs, base)
        base_ms = time_ms(lambda: tk.tiled_spmm_kernel(pp, pv, bb))
        a_dense = pp.blocks_to_dense(pv)
        with fp32_matmul():
            dense_ms = time_ms(lambda: torch.matmul(a_dense, bb))
        del a_dense
        sparse_ms = None
        if label == "low-fill":
            crow = torch.from_numpy(np.asarray(aa.indptr, np.int64)).cuda()
            col = torch.from_numpy(np.asarray(aa.indices, np.int64)).cuda()
            a_sp = torch.sparse_csr_tensor(crow, col, aa.data, size=aa.shape)
            with fp32_matmul():
                sparse_ms = time_ms_queued(lambda: torch.sparse.mm(a_sp, bb))
            del a_sp
        flops = 2.0 * pp.nblocks * bm * bk * n
        nbytes = 4.0 * (pp.nblocks * bm * bk + k * n + m * n)
        bms, by, ffma = bound_fp32(flops, nbytes)
        fp = derived["footprint_spmm"][0]
        print(f"plan executors {label} ({m}x{k}, blocks {bm}x{bk}, nnz {aa.nnz}, "
              f"{pp.nblocks} blocks, ell_width {pp.ell_width}; n {n}): derived plans and "
              f"packing {host_s:.2f} s on the host; block_ell_spmm {base_ms:.4f} ms "
              f"({flops / (base_ms * 1e-3) / 1e12:.2f} TFLOP/s of blocks, {bms / base_ms:.3f} "
              f"of the bound), "
              f"torch.matmul dense {dense_ms:.4f} ms"
              + (f", torch.sparse.mm (CSR) {sparse_ms:.4f} ms" if sparse_ms is not None else "")
              + f"; bound {bms:.4f} ms by {by} (3xTF32: 3 x {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB; FFMA design figure {ffma:.4f} ms); footprint plan: "
              f"{fp.ntiles} B-tile fetches for "
              f"{pp.nblocks} slots ({pp.nblocks / max(fp.ntiles, 1):.2f}x fewer); footprint "
              f"kernel: {tk.footprint_tile(fp)} thread blocks a super; grouped kernel: "
              f"{_grouped_geometry(derived['grouped_spmm'][0], n)}")
        for e, (dp, fn) in derived.items():
            # compact: block_ell_spmm's body; grouped and footprint: one FFMA
            # chain, bitwise equal to each other (checked above)
            same = _same(outs[e], base) if e == "compact_spmm" else True
            err, rel = over_scale(outs[e], tk._PLAIN[e](dp, packed[e], bb))
            ms = time_ms(lambda: fn(dp, packed[e], bb))
            plain_ms = time_ms(lambda: tk._PLAIN[e](dp, packed[e], bb), warmup=1, iters=3)
            print(f"  {e} {label}: {ms:.4f} ms ({ms / base_ms:.2f}x block_ell_spmm), plain "
                  f"{plain_ms:.4f} ms; vs plain over scale {rel:.3e}; bitwise equal to "
                  + ("block_ell_spmm" if e == "compact_spmm" else
                     "grouped_spmm" if e == "footprint_spmm" else "footprint_spmm")
                  + f": {same}")
            if not (same and rel <= HEADLINE_TOL and bool(torch.isfinite(outs[e]).all())):
                raise AssertionError(f"{e} {label}: disagrees with its plain version or with "
                                     "block_ell_spmm")
            if e == "compact_spmm":
                old = OLD_MS[f"{e} {label}"]
                print(f"  {e} {label}: {ms:.4f} ms (the FFMA kernel before its redesign "
                      f"{old:.3f}: {old / ms:.2f}x; torch.matmul dense {dense_ms:.4f}"
                      + (f", torch.sparse.mm {sparse_ms:.4f}" if sparse_ms is not None else "")
                      + f"), at {bms / ms:.3f} of its bound {bms:.4f} ms")
            if e in ("footprint_spmm", "grouped_spmm"):  # against the earlier designs
                old = OLD_MS[f"{e} {label}"]
                before = SHARED_TILE_MS.get(f"{e} {label}")
                print(f"  {e} {label}: {ms:.4f} ms (first port {old:.3f}: {old / ms:.2f}x"
                      + (f"; before the shared tile {before:.3f}: {ms / before:.3f}x of it"
                         if before else "")
                      + f"; torch.matmul dense {dense_ms:.4f}"
                      + (f", torch.sparse.mm {sparse_ms:.4f}" if sparse_ms is not None else "")
                      + f"), at {bms / ms:.3f} of its bound {bms:.4f} ms")
            if label == "headline":
                rows[e] = {"name": e, "route": "cuda",
                           "source": f"tpusparse_torch/csrc/block_ell_spmm_"
                                     f"{e.split('_')[0]}.cu",
                           "replaces": "tpusparse/kernels/tiled_spmm.py:" + {
                               "compact_spmm": "1029 (_compact_kernel; pallas_call l.1150)",
                               "grouped_spmm": "1186 (_grouped_kernel; pallas_call l.1297)",
                               "footprint_spmm": "1344 (_footprint_kernel; pallas_call l.1487)",
                           }[e],
                           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                           "bound_by": by, "library_ms": dense_ms}
        del outs, packed, derived, base
    del low, low_plan, low_b, cases

    # one spmm(method='footprint') step at the headline, counted
    m, k = plan.shape
    dc = torch.from_numpy(np.random.default_rng(43).standard_normal(
        (m, b.shape[1]), dtype=np.float32)).cuda()
    data = a.data.clone().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    a_var = tt.CSR(data, a.indices, a.indptr, a.shape)
    torch.cuda.synchronize()
    kernels_reset()
    out = tt.spmm(a_var, bb, method="footprint")
    out.backward(dc)
    torch.cuda.synchronize()
    counts = _launches()
    _expect("footprint step", counts, {"footprint_spmm": 1, "sddmm": 1, "block_ell_spmm": 1})
    launches = {kn: v + counts[kn] for kn, v in launches.items()}
    _, plan_t, t_perm = tt.build_plan_pair(a)
    err = over_scale(out.detach(), tk._block_exec_plain(plan, bv, b))[1]
    da = over_scale(data.grad, plan.unpack_values(_sddmm_plain(plan, dc, b)))[1]
    bv_t = plan_t.pack_values(a.data[plan_t.perm_tensor("t_perm", t_perm, "cuda")])
    dbe = over_scale(bb.grad, tk._block_exec_plain(plan_t, bv_t, dc))[1]
    del bv_t, out

    def step():
        data.grad = bb.grad = None
        tt.spmm(a_var, bb, method="footprint").backward(dc)

    step_ms = time_ms(step, warmup=1, iters=5)
    _profile("footprint step at the headline", step, 2, top=4)
    t0 = time.perf_counter()
    for _ in range(3):  # the host's plan lookups of one step, all cache hits
        tt.footprint_plan(tt.build_plan_pair(a)[0])
    lookup_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"footprint step at the headline: launches "
          f"{json.dumps({n_: c for n_, c in counts.items() if c})}, {step_ms:.4f} ms, of which "
          f"the host's plan lookups (fingerprints of the {a.nnz}-nnz pattern) {lookup_ms:.1f} "
          f"ms; vs plain over scale: C {err:.3e}, dA {da:.3e}, dB {dbe:.3e}")
    if not max(err, da, dbe) <= HEADLINE_TOL:
        raise AssertionError("footprint step disagrees with the plain versions")
    return {"rows": rows, "launches": launches}


# -- the windowed kernels and SpGEMM --------------------------------------------

# A·A, fp32: the shapes of the JAX package's own SpGEMM measurement
# (BENCH_DETAILS.json "r5_spgemm"; the shapes only): name, n, density, seed
SPGEMM_CASES = (("4096_0.1pct", 4096, 0.001, 61), ("16384_0.05pct", 16384, 0.0005, 62),
                ("4096_1pct", 4096, 0.01, 63))
SPGEMM_KERNEL_CASE = "16384_0.05pct"  # the kernels line's index maps
SPGEMM_CPU_CASE = "16384_0.05pct"     # run on the CPU too, the same plan
SPGEMM_NATIVE_CASE = "4096_1pct"      # spgemm_plan timed native and numpy
SPGEMM_TOL = 1e-5  # max |C - float64| / max |float64|, and the same for dA and dB
# small windowed cases: name, (n or n_in, table length or segments, map)
WINDOWED_SMALL = {
    "local_far_outliers": (5000, 900, "local"),
    "single_far_read": (4096, 4096, "one_far"),
    "scattered": (2000, 50000, "scattered"),
    "empty_segments_ragged": (1030, 601, "half_empty"),
    "short_table": (1000, 40, "scattered"),
    "window_4096": (8192, 256, "wide"),  # spans of 4096 entries: the segment plan's cap
}


def _windowed_small_map(name, seed):
    n, t, kind = WINDOWED_SMALL[name]
    rng = np.random.default_rng(seed)
    if kind == "scattered":
        idx = rng.integers(0, t, n)
    elif kind == "half_empty":
        idx = np.sort(rng.integers(0, t // 2, n))
    elif kind == "wide":  # 128-segment span s draws from positions [4096 s, 4096 (s + 1))
        pos = np.arange(n)
        idx = (pos // 4096) * 128 + pos % 128
    else:
        idx = np.minimum((np.arange(n) * t) // n + rng.integers(0, 40, n), t - 1)
        if kind == "one_far":
            idx[7] = t - 1
        else:
            idx[rng.integers(0, n, 25)] = rng.integers(0, t, 25)
    return idx, t, rng


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)


def phase_small_windowed() -> None:
    """windowed_gather and windowed_segsum against their plain versions on
    the card: a local map with far outliers, a single far read, a fully
    scattered map (nearly every read an exception), empty segments with n
    and num_segments off the 1024 padding, a table shorter than its window,
    the segment plan's W = 4096, each in fp32, bf16 and fp16. The gather
    must be bitwise equal; the segment sum too, since the plain version sums
    in the kernel's order. Then a chunked accumulation forced with a small
    target (as tests/test_spgemm.py:297-325 does) against the whole one."""
    import dataclasses

    import tpusparse_torch as tt
    from tpusparse_torch.kernels import windowed as wk
    from tpusparse_torch.spgemm import _chunk_segment_plans, _spgemm_data

    seed = 70
    for name in WINDOWED_SMALL:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            seed += 1
            idx, t, rng = _windowed_small_map(name, seed)
            label = f"{name}_{str(dt)[6:]}"
            gp = wk.windowed_gather_plan(idx, t)
            table = torch.from_numpy(rng.normal(size=t).astype(np.float32)).to("cuda", dt)
            table[:3] = -0.0
            gargs = (gp.tensor("rel", "cuda"), gp.tensor("starts", "cuda"))
            got = wk.windowed_gather_kernel(table, *gargs, n=gp.n, window=gp.window)
            want = wk._gather_plain(table, *gargs, n=gp.n, window=gp.window)
            full = wk.windowed_gather(table, gp)
            sp = wk.windowed_segment_plan(idx, t)
            y = torch.from_numpy(rng.normal(size=idx.size).astype(np.float32)).to("cuda", dt)
            sargs = (sp.tensor("seg_masked", "cuda"), sp.tensor("starts", "cuda"))
            sgot = wk.windowed_segsum_kernel(y, *sargs, num_segments=t, window=sp.window)
            swant = wk._segsum_plain(y, *sargs, num_segments=t, window=sp.window)
            ref = torch.zeros(t, dtype=torch.float64).index_add_(
                0, torch.from_numpy(idx), y.double().cpu())
            s_full = wk.windowed_segment_sum(y, sp).double().cpu()
            torch.cuda.synchronize()
            g_ok = torch.equal(_bits(got), _bits(want)) and torch.equal(
                full, table[torch.from_numpy(idx).cuda()])
            s_ok = torch.equal(_bits(sgot), _bits(swant))
            # fp32: the whole operation against float64; in bf16 and fp16 the
            # exception path adds in the table's dtype, as JAX's does, so its
            # error is printed and not held
            s_err = float((s_full - ref).abs().max() / ref.abs().max().clamp_min(1.0))
            ok = g_ok and s_ok and (dt != torch.float32 or s_err <= 1e-6)
            if name == "window_4096" and sp.window != 4096:
                raise AssertionError(f"windowed {label}: segment window {sp.window}, not 4096")
            print(f"case windowed {label}: gather W {gp.window}, {gp.exc_pos.size} exceptions, "
                  f"bitwise equal to plain {g_ok}; segsum W {sp.window}, {sp.exc_pos.size} "
                  f"exceptions, bitwise equal to plain {s_ok}, whole op vs float64 over scale "
                  f"{s_err:.3e}{' (limit 1e-06)' if dt == torch.float32 else ''}, "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"windowed {label}: a kernel disagrees with its plain version")
    # the chunked accumulation, forced with a small target
    a = tt.random_csr(31, (256, 256), 0.05, device="cuda")
    b = tt.random_csr(32, (256, 256), 0.05, device="cuda")
    plan = tt.spgemm_plan(a, b)
    chunks = _chunk_segment_plans(plan.c_pos, plan.c_nnz, lambda p, n: True,
                                  target=max(plan.nmul // 3, 1))
    forced = dataclasses.replace(plan, ws_c=None, ws_c_chunks=tuple(chunks))
    got = _spgemm_data(forced, a.data, b.data)
    whole = _spgemm_data(plan, a.data, b.data)
    cpu = _spgemm_data(forced, a.data.cpu(), b.data.cpu())
    torch.cuda.synchronize()
    err = over_scale(got.cpu(), cpu)[1]
    same = _same(got, whole)
    print(f"case windowed chunked accumulation (256^2 at 5 %, {len(chunks)} chunks of "
          f"{plan.nmul} products): bitwise equal to the whole plan {same}, card vs CPU over "
          f"scale {err:.3e}, {'ok' if same and err <= 1e-6 else 'FAIL'}")
    if not (same and err <= 1e-6):
        raise AssertionError("chunked windowed accumulation disagrees")


def _spgemm_expected(plan) -> tuple:
    """(gathers, segment sums) a forward and a backward launch: one gather
    per adopted gather plan, one segment sum per segment plan or chunk; the
    backward gathers dC, a and b where adopted."""
    fwd_g = (plan.wg_a is not None) + (plan.wg_b is not None)
    segs = 1 if plan.ws_c is not None else len(plan.ws_c_chunks or ())
    return fwd_g, segs, fwd_g + (plan.wg_c is not None)


def _spgemm_oracle(a, plan):
    """(C's values, scipy's boolean pattern) in float64 on the host."""
    sa = a.to_scipy().astype(np.float64)
    ref = (sa @ sa).tocsr()
    ref.sort_indices()
    rows = np.repeat(np.arange(a.shape[0]), np.diff(plan.c_indptr))
    vals = np.asarray(ref[rows, plan.c_indices]).ravel()
    pat = (sa.astype(bool) @ sa.astype(bool)).tocsr()
    pat.sort_indices()
    return vals, pat


def _grad_oracle(a, plan, g):
    """(dA, dB) of vdot(g, C) for C = A·A in float64 on the card:
    (dC·Aᵀ) on A's pattern and (Aᵀ·dC) on A's pattern."""
    m = a.shape[0]
    rows = torch.from_numpy(a.row_ids().astype(np.int64)).cuda()
    cols = torch.from_numpy(a.indices.astype(np.int64)).cuda()
    c_rows = torch.from_numpy(np.repeat(np.arange(m), np.diff(plan.c_indptr))).cuda()
    c_cols = torch.from_numpy(plan.c_indices.astype(np.int64)).cuda()
    ad = torch.zeros((m, m), dtype=torch.float64, device="cuda")
    ad[rows, cols] = a.data.double()
    gd = torch.zeros((m, m), dtype=torch.float64, device="cuda")
    gd[c_rows, c_cols] = g.double()
    da = (gd @ ad.T)[rows, cols]
    db = (ad.T @ gd)[rows, cols]
    del ad, gd
    return da, db


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def phase_spgemm() -> dict:
    """A·A at the three shapes of SPGEMM_CASES, fp32, with grads in both
    operands' values: the plan (native or numpy inspector), the adopted
    windowed plans and the route of 'auto'; a forward and backward through
    `a @ a`, counted, with exactly the launches the plan implies; `spgemm`
    and `spgemm(method='auto')`, counted, bitwise equal to it; C against a
    float64 scipy product, its pattern against scipy's, dA and dB against the
    dense algebra in float64, the 'dense' route against the same oracle; at
    SPGEMM_CPU_CASE the same plan on the CPU. Timings: forward and
    forward+backward with the plan held and without, the 'dense' route,
    torch.sparse.mm of two CSR tensors (a yardstick), a profile of the
    forward+backward, both kernels on SPGEMM_KERNEL_CASE's maps, and
    spgemm_plan's host seconds native and numpy at SPGEMM_NATIVE_CASE.
    Returns the kernels line's rows and the launches."""
    import tpusparse_torch as tt
    from tpusparse_torch.kernels import windowed as wk
    from tpusparse_torch.runtime import native
    from tpusparse_torch.spgemm import _PLAN_CACHE, _route_spgemm
    from tpusparse_torch.utils.config import fp32_matmul

    inspector = ("native (tpusparse_torch/csrc/inspector.cpp)" if native.available()
                 else f"numpy (no native library: {native.unavailable_reason})")
    print(f"spgemm: the symbolic pass on the {inspector} inspector; window plans in numpy")
    launches = {"windowed_gather": 0, "windowed_segsum": 0}
    rows = {}
    for name, n, density, seed in SPGEMM_CASES:
        a = tt.random_csr(seed, (n, n), density, device="cuda")
        t0 = time.perf_counter()
        plan = tt.spgemm_plan(a, a)
        plan_s = time.perf_counter() - t0
        route = _route_spgemm(a, a)
        adopted = {f: getattr(plan, f).window for f in ("ws_c", "wg_a", "wg_b", "wg_c")
                   if getattr(plan, f) is not None}
        nchunks = len(plan.ws_c_chunks or ())
        rep = plan.report()
        print(f"spgemm {name}: A {n}^2 nnz {a.nnz}; {rep['nmul']} products, C nnz "
              f"{rep['c_nnz']}; plan {plan_s:.2f} s on the host; 'auto' routes to {route}; "
              f"windowed plans adopted (W) {json.dumps(adopted)}, segment chunks {nchunks}"
              + (f" (W {[c[4].window for c in plan.ws_c_chunks]})" if nchunks else ""))
        if route != "schedule":
            raise AssertionError(f"spgemm {name}: 'auto' routed to {route}, not 'schedule'")
        fwd_g, segs, bwd_g = _spgemm_expected(plan)
        # JAX's rule at these shapes: the gathers of a (forward and backward)
        # and of dC, and one segment plan, or 4 chunks at 4096^2 at 1 %
        jax_rule = (3, 4 if name == "4096_1pct" else 1)
        if (fwd_g + bwd_g, segs) != jax_rule or (name == "4096_1pct") != (nchunks > 1):
            raise AssertionError(f"spgemm {name}: {fwd_g + bwd_g} gathers and {segs} segment "
                                 f"sums a step ({nchunks} chunks), not JAX's {jax_rule}")
        g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
            plan.c_nnz).astype(np.float32)).cuda()
        x = tt.CSR(a.data.clone().requires_grad_(True), a.indices, a.indptr, a.shape)
        y = tt.CSR(a.data.clone().requires_grad_(True), a.indices, a.indptr, a.shape)
        # the main path, counted: forward and backward through the operator
        torch.cuda.synchronize()
        kernels_reset()
        c = x @ y
        c.data.backward(g)
        torch.cuda.synchronize()
        counts = _launches()
        expect = {"windowed_gather": fwd_g + bwd_g, "windowed_segsum": segs}
        _expect(f"spgemm {name} a @ a forward+backward", counts, expect)
        launches = {k: v + counts[k] for k, v in launches.items()}
        # the other two entry points, forward only, counted
        kernels_reset()
        with torch.no_grad():
            c_fn = tt.spgemm(x, y)
            c_auto = tt.spgemm(x, y, method="auto")
        torch.cuda.synchronize()
        counts = _launches()
        _expect(f"spgemm {name} spgemm + auto", counts,
                {"windowed_gather": 2 * fwd_g, "windowed_segsum": 2 * segs})
        launches = {k: v + counts[k] for k, v in launches.items()}
        print(f"spgemm {name}: launches a forward {fwd_g} windowed_gather + {segs} "
              f"windowed_segsum, a backward {bwd_g} windowed_gather")
        if not (_same(c_fn.data, c.data.detach()) and _same(c_auto.data, c.data.detach())):
            raise AssertionError(f"spgemm {name}: spgemm, auto and a @ a disagree")
        # checks against float64
        vals, pat = _spgemm_oracle(a, plan)
        pat_ok = (np.array_equal(plan.c_indptr, pat.indptr)
                  and np.array_equal(plan.c_indices, pat.indices))
        c_err = _rel(c.data.detach().cpu(), torch.from_numpy(vals))
        da_ref, db_ref = _grad_oracle(a, plan, g)
        da_err, db_err = _rel(x.data.grad, da_ref), _rel(y.data.grad, db_ref)
        del da_ref, db_ref
        with fp32_matmul():
            cd = tt.spgemm(a, a, method="dense")
        d_err = _rel(cd.data.cpu(), torch.from_numpy(vals))
        d_pat = np.array_equal(cd.indices, plan.c_indices) and np.array_equal(
            cd.indptr, plan.c_indptr)
        finite = bool(torch.isfinite(c.data).all())
        ok = pat_ok and d_pat and finite and max(c_err, da_err, db_err, d_err) <= SPGEMM_TOL
        print(f"spgemm {name}: C vs float64 rel err {c_err:.3e}, pattern equal to scipy's "
              f"{pat_ok}; dA {da_err:.3e}, dB {db_err:.3e} vs the dense algebra; 'dense' "
              f"route {d_err:.3e}, same pattern {d_pat} (limit {SPGEMM_TOL:.0e}), "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"spgemm {name}: disagrees with the float64 oracle")
        del cd
        if name == SPGEMM_CPU_CASE:
            xc = tt.CSR(a.data.cpu().clone().requires_grad_(True), a.indices, a.indptr, a.shape)
            yc = tt.CSR(a.data.cpu().clone().requires_grad_(True), a.indices, a.indptr, a.shape)
            cc = xc @ yc
            cc.data.backward(g.cpu())
            pairs = ((c.data.detach(), cc.data.detach()), (x.data.grad, xc.data.grad),
                     (y.data.grad, yc.data.grad))
            errs = [float((p.cpu() - q).abs().max()) for p, q in pairs]
            ok = all(torch.allclose(p.cpu(), q, **TOL_FP32) for p, q in pairs)
            print(f"spgemm {name}: card vs CPU max abs err C {errs[0]:.3e}, dA {errs[1]:.3e}, "
                  f"dB {errs[2]:.3e} (rtol {TOL_FP32['rtol']}, atol {TOL_FP32['atol']}), "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"spgemm {name}: card and CPU disagree")
        # timings
        def fwd_held():
            return tt.spgemm(a, a, plan=plan)

        def fwd_lookup():
            return tt.spgemm(a, a)

        def step(held=True):
            x.data.grad = y.data.grad = None
            cc = tt.spgemm(x, y, plan=plan) if held else x @ y
            cc.data.backward(g)

        with torch.no_grad():
            f_ms, fl_ms = time_ms(fwd_held), time_ms(fwd_lookup)
        s_ms, sl_ms = time_ms(step), time_ms(lambda: step(False))
        with fp32_matmul(), torch.no_grad():
            dense_ms = time_ms(lambda: tt.spgemm(a, a, method="dense"), warmup=1, iters=3)
        crow = torch.from_numpy(a.indptr.astype(np.int64)).cuda()
        col = torch.from_numpy(a.indices.astype(np.int64)).cuda()
        a_sp = torch.sparse_csr_tensor(crow, col, a.data, size=a.shape)
        sp_ms = time_ms(lambda: torch.sparse.mm(a_sp, a_sp), warmup=1, iters=5)
        print(f"spgemm {name}: forward {f_ms:.4f} ms with the plan held, {fl_ms:.4f} ms with "
              f"the plan looked up; forward+backward {s_ms:.4f} / {sl_ms:.4f} ms; 'dense' "
              f"route {dense_ms:.3f} ms; torch.sparse.mm (CSR x CSR) {sp_ms:.4f} ms")
        _profile(f"spgemm {name} forward+backward (plan held)", step, 3, top=6)
        del a_sp
        if name == SPGEMM_KERNEL_CASE:
            rows = _windowed_kernel_rows(a, plan)
        if name == SPGEMM_NATIVE_CASE:
            _spgemm_plan_host_times(a)
        del a, x, y, c, c_fn, c_auto, g
        _PLAN_CACHE.clear()
        torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches}


def _windowed_kernel_rows(a, plan) -> dict:
    """Both kernels on the path's own maps (the gather of a over a_pos, the
    accumulation over c_pos): kernel, plain version, the PyTorch call that
    computes the same function (index_select, index_add_), all queued, and
    the bound by bytes from this map; each kernel and its PyTorch call also
    queued behind a sleep, the times the kernels line keeps."""
    from tpusparse_torch.kernels import windowed as wk

    gp, sp = plan.wg_a, plan.ws_c
    table = a.data
    gargs = (gp.tensor("rel", "cuda"), gp.tensor("starts", "cuda"))
    a_pos = plan.tensor("a_pos", "cuda")
    prods = table[a_pos] * table[plan.tensor("b_pos", "cuda")]
    sargs = (sp.tensor("seg_masked", "cuda"), sp.tensor("starts", "cuda"))
    c_pos = plan.tensor("c_pos", "cuda")
    gk = partial(wk.windowed_gather_kernel, table, *gargs, n=gp.n, window=gp.window)
    gpl = partial(wk._gather_plain, table, *gargs, n=gp.n, window=gp.window)
    sk = partial(wk.windowed_segsum_kernel, prods, *sargs, num_segments=sp.num_segments,
                 window=sp.window)
    spl = partial(wk._segsum_plain, prods, *sargs, num_segments=sp.num_segments,
                  window=sp.window)
    g_err = float((gk().float() - gpl().float()).abs().max())
    s_err = float((sk().float() - spl().float()).abs().max())
    def g_lib_fn():
        return torch.index_select(table, 0, a_pos)
    g_queued, g_lib_queued = time_ms_queued(gk), time_ms_queued(g_lib_fn)
    g_ms, g_lib = time_ms_ahead(gk), time_ms_ahead(g_lib_fn)
    g_plain = time_ms_queued(gpl, reps=5)
    zeros = torch.zeros(sp.num_segments, device="cuda")

    def s_lib_fn():
        return zeros.clone().index_add_(0, c_pos, prods)
    s_queued, s_lib_queued = time_ms_queued(sk), time_ms_queued(s_lib_fn)
    s_ms, s_lib = time_ms_ahead(sk), time_ms_ahead(s_lib_fn)
    s_plain = time_ms_queued(spl, reps=2, iters=3)
    # bytes each kernel must move: its index maps and output once, the table
    # entries the map reads (gather) or y (segment sum) once
    g_bytes = 4.0 * (2 * gp.n + gp.starts.size + np.unique(gp.idx).size)
    s_bytes = 4.0 * (2 * sp.n_in + sp.starts.size + sp.num_segments)
    g_bound, g_by = bound(0.0, g_bytes)
    s_bound, s_by = bound(float(sp.n_in), s_bytes)
    print(f"windowed_gather on {SPGEMM_KERNEL_CASE}'s a_pos map (n {gp.n}, W {gp.window}, "
          f"{gp.exc_pos.size} exceptions): kernel {g_ms:.4f} ms, torch.index_select "
          f"{g_lib:.4f} ms (kernel/library {g_ms / g_lib:.2f}; queued behind a sleep; queued "
          f"alone {g_queued:.4f} and {g_lib_queued:.4f}), plain {g_plain:.4f} ms, bound "
          f"{g_bound:.4f} ms by {g_by} "
          f"({g_bytes / 1e6:.2f} MB); kernel vs plain max abs err {g_err:.3e}")
    print(f"windowed_segsum on {SPGEMM_KERNEL_CASE}'s c_pos map (n_in {sp.n_in}, "
          f"{sp.num_segments} segments, W {sp.window}, {sp.exc_pos.size} exceptions): kernel "
          f"{s_ms:.4f} ms, index_add_ {s_lib:.4f} ms (queued behind a sleep; queued alone "
          f"{s_queued:.4f} and {s_lib_queued:.4f}), plain {s_plain:.4f} ms, bound "
          f"{s_bound:.4f} ms by {s_by} ({s_bytes / 1e6:.2f} MB); kernel vs plain max abs err "
          f"{s_err:.3e}")
    if g_err != 0.0 or s_err != 0.0:
        raise AssertionError("windowed kernels disagree with their plain versions on the path")
    return {
        "windowed_gather": {"name": "windowed_gather", "route": "cuda",
                            "source": "tpusparse_torch/csrc/windowed.cu",
                            "replaces": "tpusparse/kernels/windowed.py:148 (_gather_kernel; "
                                        "pallas_call l.175)",
                            "max_abs_err": g_err, "ms": g_ms, "plain_ms": g_plain,
                            "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib},
        "windowed_segsum": {"name": "windowed_segsum", "route": "cuda",
                            "source": "tpusparse_torch/csrc/windowed.cu",
                            "replaces": "tpusparse/kernels/windowed.py:314 (_segsum_kernel; "
                                        "pallas_call l.348)",
                            "max_abs_err": s_err, "ms": s_ms, "plain_ms": s_plain,
                            "bound_ms": s_bound, "bound_by": s_by, "library_ms": s_lib},
    }


def _spgemm_plan_host_times(a) -> None:
    """spgemm_plan's host seconds on the native and on the numpy symbolic
    pass (window plans included), and that both give the same schedule."""
    import os

    import tpusparse_torch as tt
    from tpusparse_torch.runtime import native
    from tpusparse_torch.spgemm import _PLAN_CACHE

    plans, secs = {}, {}
    for label in ("native", "numpy"):
        if label == "native" and not native.available():
            print("spgemm_plan: no native inspector on this host")
            continue
        _PLAN_CACHE.clear()
        if label == "numpy":
            os.environ["TPUSPARSE_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            plans[label] = tt.spgemm_plan(a, a)
            secs[label] = time.perf_counter() - t0
        finally:
            os.environ.pop("TPUSPARSE_NO_NATIVE", None)
    same = len(plans) < 2 or all(np.array_equal(getattr(plans["native"], f),
                                                getattr(plans["numpy"], f))
                                 for f in ("a_pos", "b_pos", "c_pos", "c_indices", "c_indptr"))
    print(f"spgemm_plan {SPGEMM_NATIVE_CASE} on the host: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f"; the same schedule: {same}")
    if not same:
        raise AssertionError("native and numpy spgemm schedules differ")


# the wide-DIA kernel against its plain version: m, k, diagonals, offsets'
# range, plane dtype, x dtype (square and rectangular, 1 to 2105 diagonals,
# offsets past both edges, fp32 and bf16 planes), and a pattern: whole zero
# 32-row tiles in a band ("band", ~10 % of the tiles occupied), tiles of
# -0.0 and +0.0 ("neg_zero"), a NaN in an occupied tile ("nan_plane"), a
# NaN or +Inf in x that only skipped terms meet ("nan_x", "inf_x")
DIA_SMALL = {
    "square_1": (700, 700, 1, (-5, 5), torch.float32, torch.float32),
    "rect_7_past_both_edges": (513, 400, 7, (-900, 900), torch.float32, torch.float32),
    "square_129": (1000, 1000, 129, (-990, 990), torch.float32, torch.float32),
    "rect_tall_200": (900, 640, 200, (-850, 600), torch.float32, torch.float32),
    "rect_wide_129_bf16": (600, 880, 129, (-500, 850), torch.bfloat16, torch.bfloat16),
    "square_200_bf16_plane": (1000, 1000, 200, (-990, 990), torch.bfloat16, torch.float32),
    "square_160_bf16_x": (777, 777, 160, (-700, 700), torch.float32, torch.bfloat16),
    "level1_2105": (31868, 31868, 2105, (-31000, 31000), torch.float32, torch.float32),
    "band_10pct_tiles": (4000, 4000, 400, (-3990, 3990), torch.float32, torch.float32, "band"),
    "band_bf16_both": (777, 800, 160, (-700, 700), torch.bfloat16, torch.bfloat16, "band"),
    "neg_zero_tiles": (1000, 1000, 200, (-990, 990), torch.float32, torch.float32, "neg_zero"),
    "nan_in_occupied_tile": (1000, 1000, 200, (-990, 990), torch.float32, torch.float32,
                             "nan_plane"),
    "nan_x_skipped": (1000, 1000, 200, (-990, 990), torch.float32, torch.float32, "nan_x"),
    "inf_x_skipped": (1003, 1000, 200, (-990, 990), torch.float32, torch.float32, "inf_x"),
}
# the AMG hierarchy of laplace3d_64 as the JAX package builds it on the CPU:
# (n, nnz, format) per level
AMG_LEVELS = ((262144, 1810432, "dia:7"), (31868, 957260, "dia:2105+csr:9364"),
              (2861, 311725, "dia:2129+csr:410"), (126, 12764, "dia:247"))
AMG_CG_ITERS, JACOBI_CG_ITERS, AMG_TOL = 40, 50, 1e-7
AMG_RESID_LIMIT = 1e-4  # float64 relative residual after 40 AMG-CG iterations
VCYCLE_LIMIT = 1e-5     # one V-cycle, card against CPU, over scale


def _dia_small_inputs(name, device="cuda"):
    m, k, nd, (lo, hi), ddt, xdt, *pattern = DIA_SMALL[name]
    rng = np.random.default_rng(nd + m)
    offs = np.sort(rng.choice(np.arange(lo, hi), nd, replace=False)).astype(np.int64)
    data = rng.standard_normal((nd, m)).astype(np.float32)
    tile_of = np.arange(m) // 32
    ntiles = int(tile_of[-1]) + 1
    if pattern == ["band"]:  # row d holds entries in a band of ~10 % of the tiles
        for d in range(nd):
            data[d, np.abs(tile_of - (d * ntiles) // nd) > max(1, ntiles // 20)] = 0.0
    elif pattern == ["neg_zero"]:
        data[::3, tile_of % 4 == 1] = -0.0
        data[1::3, tile_of % 4 == 2] = 0.0
    elif pattern == ["nan_plane"]:
        data[5, 70] = np.nan
        data[6:, tile_of % 2 == 0] = 0.0
    data = torch.from_numpy(data).to(device, ddt)
    x = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(device, xdt)
    return offs, data, x, rng


def _poison_skipped(plane, p_offs, x, value):
    """Zero every 32-row tile whose terms reach x[k // 2], then set that x
    to `value`: only skipped terms meet it. Returns the rows it reaches."""
    m, k = plane.shape[1], x.shape[0]
    j = k // 2
    rows = []
    for d, off in enumerate(p_offs):
        i = j - int(off)
        if 0 <= i < m:
            plane[d, (i // 32) * 32:(i // 32) * 32 + 32] = 0.0
            rows.append(i)
    x[j] = value
    return rows


def phase_small_dia() -> None:
    """dia_spmv against its plain version on the card, bitwise, on the
    DIA_SMALL cases (the plane in JAX's plane order), walking every
    diagonal and walking the plane's tile list (NaN rows included: a NaN or
    Inf in x that only skipped terms meet must make its rows NaN);
    PackedDIA.mv and dia_spmm on a one-column b, one launch each, bitwise
    equal to the plain version; and the backward's dx and d_data against
    float64."""
    import tpusparse_torch as tt
    from tpusparse_torch.kernels import dia as dk

    for name in DIA_SMALL:
        offs, data, x, _ = _dia_small_inputs(name)
        plane, p_offs = dk._pack_dia(data, offs)
        pattern = DIA_SMALL[name][6:]
        rows = []
        if pattern in (("nan_x",), ("inf_x",)):
            plane = plane.clone()
            rows = _poison_skipped(plane, p_offs, x, float(pattern[0][:3]))
        o = dk._offsets_tensor(p_offs, "cuda")
        tiles = dk.dia_tile_list(plane, o)
        got = dk.dia_spmv_kernel(plane, o, x)
        got_list = dk.dia_spmv_kernel(plane, o, x, tiles)
        want = dk._dia_spmv_plain(plane, o, x)
        flags = dk.dia_nonfinite_kernel(x)
        torch.cuda.synchronize()
        same = (torch.equal(_bits(got), _bits(want))
                and torch.equal(_bits(got_list), _bits(want))
                and torch.equal(flags, dk._nonfinite_plain(x))
                and bool(flags.any()) == bool(rows))
        nan_rows = bool(torch.isnan(got_list[rows]).all())
        print(f"case dia {name}: {plane.shape[0]} diagonals x {plane.shape[1]} rows, x "
              f"{x.shape[0]}, {str(plane.dtype)[6:]} plane, {str(x.dtype)[6:]} x, "
              f"{tiles.nocc} of {plane.shape[0] * (tiles.ptr.shape[0] - 1)} 32-row tiles "
              f"occupied: every diagonal, the tile list and x's nonfinite check equal to "
              f"plain {same}"
              + (f", the {len(rows)} rows a skipped term meets NaN {nan_rows}" if rows else ""))
        if not (same and nan_rows):
            raise AssertionError(f"dia {name}: the kernel disagrees with its plain version")
    offs, data, x, rng = _dia_small_inputs("rect_tall_200")
    m, k = data.shape[1], x.shape[0]
    plane, p_offs = dk._pack_dia(data, offs)
    want = dk._dia_spmv_plain(plane, dk._offsets_tensor(p_offs, "cuda"), x)
    packed = dk.pack_dia_operator(data, offs, (m, k))
    # PackedDIA walks its tile list (the check, then the walk); dia_spmm on
    # one column walks every diagonal
    for label, fn, checks in (("PackedDIA.mv", lambda: packed.mv(x), 1),
                              ("dia_spmm one column", lambda: tt.dia_spmm(
                                  tt.DIA(data, offs, (m, k)), x[:, None])[:, 0], 0)):
        dk.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        n_launch = dk.launch_counts()
        same = _same(got, want)
        print(f"case dia {label} (rect_tall_200): launches {json.dumps(n_launch)}, bitwise "
              f"equal to plain {same}")
        if n_launch != {"dia_spmv": 1, "dia_nonfinite": checks} or not same:
            raise AssertionError(f"dia {label}: launches {n_launch}, bitwise equal {same}")
    # the backward against float64
    d = data.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).cuda()
    (dk.dia_spmv(d, offs, xx) * g).sum().backward()
    d64, x64, g64 = (t.detach().double().cpu().numpy() for t in (data, x, g))
    cols = np.arange(m)[None, :] + offs[:, None]
    valid = (cols >= 0) & (cols < k)
    xs = np.where(valid, x64[np.clip(cols, 0, k - 1)], 0.0)
    dd_ref = g64[None, :] * xs
    dx_ref = np.zeros(k)
    np.add.at(dx_ref, cols[valid], (d64 * g64[None, :])[valid])
    dd_err = over_scale(d.grad.cpu(), torch.from_numpy(dd_ref))[1]
    dx_err = over_scale(xx.grad.cpu(), torch.from_numpy(dx_ref))[1]
    print(f"case dia backward (rect_tall_200): d_data vs float64 over scale {dd_err:.3e}, dx "
          f"{dx_err:.3e} (limit {HEADLINE_TOL})")
    if not (dd_err <= HEADLINE_TOL and dx_err <= HEADLINE_TOL):
        raise AssertionError("dia backward disagrees with float64")


def _amg_expected(m) -> dict:
    """The launches of one V-cycle the hierarchy implies: per level with a
    prolongator, its A matvecs (presmooth + 1 + postsmooth) and its factored
    P's two D⁻¹A matvecs on the wide-DIA kernel where they are PackedDIA,
    plus one windowed gather and one segment sum per adopted plan; each
    dia_spmv walks a tile list, so x's nonfinite check runs beside it."""
    from tpusparse_torch.amg import _HybridOp
    from tpusparse_torch.kernels.dia import PackedDIA

    def wide(op):
        return isinstance(op.dia if isinstance(op, _HybridOp) else op, PackedDIA)

    out = {"dia_spmv": 0, "windowed_gather": 0, "windowed_segsum": 0}
    for lvl in m.levels:
        if lvl.p is None:
            continue
        out["dia_spmv"] += (m.presmooth + 1 + m.postsmooth) * wide(lvl.a)
        if lvl.p_fact is not None:
            out["dia_spmv"] += wide(lvl.p_fact.dinv_a) + wide(lvl.p_fact.dinv_a_t)
            out["windowed_gather"] += lvl.p_fact.gplan is not None
            out["windowed_segsum"] += lvl.p_fact.splan is not None
    # every PackedDIA plane of the hierarchy has a tile list: each mv checks x
    out["dia_nonfinite"] = out["dia_spmv"]
    return out


def _check_amg_report(m) -> None:
    import re

    got = [(int(a), int(b), c) for a, b, c in
           re.findall(r"level \d+: n=\s*(\d+) nnz=\s*(\d+) \[([^\]]+)\]", m.report())]
    print(m.report())
    if tuple(got) != AMG_LEVELS:
        raise AssertionError(f"amg hierarchy {got} is not the JAX package's {AMG_LEVELS}")


def phase_amg_laplace3d() -> dict:
    """AMG-preconditioned CG on laplace3d_64 (262,144 rows; the JAX
    package's solver measurement, benchmarks/realmatrix_benchmark.py
    FULL_SET with --amg): setup with its host seconds, the hierarchy against
    the JAX package's (AMG_LEVELS), one V-cycle card against CPU, Jacobi-CG
    (maxiter 50) and AMG-CG (maxiter 40) at tol 1e-7 timed, the counted
    launches of the AMG-CG solve against what the hierarchy implies, the
    iteration where its stop test fires, AMG-CG's float64 residual, a
    torch.profiler breakdown of 8 iterations,
    and dia_spmv at the level-1 and level-2 planes against its plain
    version, its bound and torch.sparse.mm. Returns the kernel rows
    ('dia_spmv', 'dia_nonfinite'), the launches of the solve and level 1's
    input to `amg._route_level`."""
    import tpusparse_torch as tt
    from tpusparse_torch import amg as amg_mod
    from tpusparse_torch import kernels
    from tpusparse_torch.amg import _HybridOp
    from tpusparse_torch.kernels import dia as dk
    from tpusparse_torch.utils.matrices import get_matrix

    a = get_matrix("laplace3d_64", device="cuda")
    # each level's input to the per-diagonal router, for the calibrate phase
    level_args, route_level = [], amg_mod._route_level
    amg_mod._route_level = lambda *args: level_args.append(args) or route_level(*args)
    t0 = time.perf_counter()
    try:
        m = tt.smoothed_aggregation_setup(a)
    finally:
        amg_mod._route_level = route_level
    torch.cuda.synchronize()
    print(f"amg laplace3d_64 setup: {time.perf_counter() - t0:.2f} s on the host, pushes "
          f"included; grid complexity {m.grid_complexity:.3f}")
    _check_amg_report(m)
    wide = [op for lvl in m.levels for op in (lvl.a, *((lvl.p_fact.dinv_a, lvl.p_fact.dinv_a_t)
                                                     if lvl.p_fact is not None else ()))]
    wide = [op.dia if isinstance(op, _HybridOp) else op for op in wide]
    wide = [op for op in wide if isinstance(op, dk.PackedDIA)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nocc = sum(op.tiles().nocc for op in wide)
    torch.cuda.synchronize()
    print(f"amg tile lists: {len(wide)} PackedDIA planes, {nocc} occupied 32-row tiles of "
          f"{sum(op.data.shape[0] * -(-op.data.shape[1] // TILE_ROWS) for op in wide)}, built "
          f"in {(time.perf_counter() - t0) * 1e3:.2f} ms on the device (torch ops; PackedDIA "
          f"keeps each for its later mvs)")
    per_cycle = _amg_expected(m)
    print(f"amg: launches a V-cycle the hierarchy implies {json.dumps(per_cycle)}")
    if not per_cycle["dia_spmv"] == per_cycle["dia_nonfinite"] == 14:
        raise AssertionError(f"amg: {per_cycle['dia_spmv']} dia_spmv and "
                             f"{per_cycle['dia_nonfinite']} dia_nonfinite a V-cycle, not 14")
    n = a.shape[0]
    b = torch.from_numpy(np.random.default_rng(101).random(n, dtype=np.float32)).cuda()
    # one V-cycle, card against the same hierarchy on the CPU
    a_cpu = tt.CSR(a.data.cpu(), a.indices, a.indptr, a.shape)
    t0 = time.perf_counter()
    m_cpu = tt.smoothed_aggregation_setup(a_cpu)
    cpu_setup = time.perf_counter() - t0
    v_card = m(b).cpu()
    v_cpu = m_cpu(b.cpu())
    v_err = over_scale(v_card, v_cpu)[1]
    print(f"amg V-cycle card vs CPU (CPU setup {cpu_setup:.2f} s): over scale {v_err:.3e} "
          f"(limit {VCYCLE_LIMIT})")
    if not (v_err <= VCYCLE_LIMIT and bool(torch.isfinite(v_card).all())):
        raise AssertionError("amg V-cycle on the card disagrees with the CPU")
    del m_cpu, v_cpu
    op = tt.csr_to_dia(a)  # 7 diagonals: the outer operator, as the JAX benchmark takes
    jac = tt.linalg.jacobi_preconditioner(op)

    def counted(m_):
        calls = [0]

        def apply(v):
            calls[0] += 1
            return m_(v)
        return apply, calls

    def jacobi_cg(M=jac):
        return tt.linalg.cg(op, b, tol=AMG_TOL, maxiter=JACOBI_CG_ITERS, M=M)[0]

    def amg_cg(M=m):
        return tt.linalg.cg(op, b, tol=AMG_TOL, maxiter=AMG_CG_ITERS, M=M)[0]

    # the main path, counted: M(r0), then one V-cycle a loop iteration; the
    # stop test is read on the host every linalg._CHECK_EVERY iterations, and
    # the iterations past the stop run frozen
    jacobi_cg()
    torch.cuda.synchronize()
    m_counted, calls = counted(m)
    kernels.reset_launch_counts()
    x = amg_cg(m_counted)
    torch.cuda.synchronize()
    counts = kernels.launches_by_kernel()
    cycles = calls[0]
    expect = {k_: v * cycles for k_, v in per_cycle.items()}
    print(f"amg-cg (maxiter {AMG_CG_ITERS}, tol {AMG_TOL}): launches "
          f"{json.dumps({k_: counts[k_] for k_ in expect})} in {cycles} V-cycles, one a loop "
          f"iteration after M(r0): {counts['dia_spmv'] / cycles:g} dia_spmv and "
          f"{counts['dia_nonfinite'] / cycles:g} dia_nonfinite an iteration")
    _expect("amg-cg", counts, expect)
    # where the stop test fires: the same solve reading it every iteration,
    # which must give the same x bit for bit
    every = tt.linalg._CHECK_EVERY
    m_exact, exact_calls = counted(m)
    tt.linalg._CHECK_EVERY = 1
    try:
        x_exact = amg_cg(m_exact)
    finally:
        tt.linalg._CHECK_EVERY = every
    stop_it = exact_calls[0] - 1
    # not bitwise: the hybrid levels' CSR remainders add by index_add_, whose
    # atomics sum in another order on every run
    stop_err = over_scale(x, x_exact)[1]
    print(f"amg-cg: the stop test fires after iteration {stop_it} (the fp32 recursive residual "
          f"under {AMG_TOL} of |b|); with the flag read every {every} iterations the loop "
          f"ran {cycles - 1} (frozen past the stop); x against the exact stop over scale "
          f"{stop_err:.3e} (limit {VCYCLE_LIMIT})")
    if not stop_err <= VCYCLE_LIMIT:
        raise AssertionError("amg-cg: frozen iterations changed x")
    x64 = x.double().cpu().numpy()
    sp64 = a.to_scipy().astype(np.float64)
    b64 = b.double().cpu().numpy()
    resid = float(np.linalg.norm(sp64 @ x64 - b64) / np.linalg.norm(b64))
    print(f"amg-cg float64 relative residual |Ax - b|/|b| of the solve: {resid:.3e} "
          f"(limit {AMG_RESID_LIMIT})")
    if not (resid < AMG_RESID_LIMIT and np.isfinite(x64).all()):
        raise AssertionError(f"amg-cg residual {resid}")
    for label, make, m_, check in (("jacobi-cg", jacobi_cg, jac, every),
                                   ("amg-cg", amg_cg, m, every),
                                   ("amg-cg, stop flag read every iteration", amg_cg, m, 1)):
        times, its = [], 0
        tt.linalg._CHECK_EVERY = check
        try:
            for _ in range(3):
                m_c, c_ = counted(m_)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                xs = make(m_c)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                its = c_[0] - 1
        finally:
            tt.linalg._CHECK_EVERY = every
        r_ = float(np.linalg.norm(sp64 @ xs.double().cpu().numpy() - b64) / np.linalg.norm(b64))
        print(f"{label} (laplace3d_64): {min(times) * 1e3:.3f} ms a solve of {its} loop "
              f"iterations, {min(times) * 1e3 / (its + 1):.4f} ms an iteration (a matvec and a "
              f"preconditioner each, M(r0) counted as one; best of 3 on the host clock); "
              f"float64 relative residual {r_:.3e}")
    _profile("amg-cg laplace3d_64, 8 iterations",
             lambda: tt.linalg.cg(op, b, tol=AMG_TOL, maxiter=8, M=m), 2, top=10)
    rows = _dia_timings(m)
    _segsum_amg_rows(m)
    return {"rows": rows, "launches": counts, "level1_route_args": level_args[1]}


def _csr_yardstick(p):
    """The DIA part's entries (the plane's nonzeros) as a torch CSR tensor:
    torch.sparse.mm of it is row 20's yardstick (cuSPARSE)."""
    n = p.data.shape[1]
    d_i, i_i = torch.nonzero(p.data, as_tuple=True)
    cols = i_i + torch.from_numpy(np.array(p.offsets)).to(p.data.device)[d_i]
    order = torch.argsort(i_i * p.shape[1] + cols)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=p.data.device)
    crow[1:] = torch.cumsum(torch.bincount(i_i, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, cols[order], p.data[d_i, i_i][order], size=p.shape)


def _dia_timings(m) -> dict:
    """dia_spmv at the level-1 and level-2 planes (the A operators' DIA
    parts, as the V-cycle runs them) on PackedDIA's tile list, which is what
    AMG-CG runs, and walking every diagonal, each bitwise against the plain
    version; the list's size and build time; the bound of the function (its
    nonzeros' values, an int32 position each, x and y once at the HBM rate)
    beside two design figures (the whole plane's bytes, and the occupied
    tiles' with their list); torch.sparse.mm of the same DIA part's entries
    as a CSR tensor. Kernel and yardstick are queued behind a sleep
    (`time_ms_ahead`; the older `time_ms_queued` beside them). At level 1
    also x's nonfinite check alone, against its plain version. Returns the
    level-1 rows of the kernels line: 'dia_spmv' and 'dia_nonfinite'."""
    from tpusparse_torch.amg import _HybridOp
    from tpusparse_torch.kernels import dia as dk

    replaces = ("tpusparse/kernels/dia.py:57 (_dia_spmv_kernel; _dia_spmv_jit l.113, "
                "pallas_call l.123)")
    rows = {}
    for lv in (1, 2):
        p = m.levels[lv].a
        p = p.dia if isinstance(p, _HybridOp) else p
        nd, n = p.data.shape
        esize = p.data.element_size()
        x = torch.from_numpy(np.random.default_rng(lv).random(n, dtype=np.float32)).cuda()
        o = p._offsets_on(p.data.device)
        want = dk._dia_spmv_plain(p.data, o, x)
        full = dk.dia_spmv_kernel(p.data, o, x)
        same = torch.equal(_bits(full), _bits(want))
        full_ms = time_ms_ahead(lambda: dk.dia_spmv_kernel(p.data, o, x))
        full_bytes = esize * nd * n + 4.0 * (2 * n + nd)
        full_fig = full_bytes / HBM_BYTES_PER_S * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = dk.dia_tile_list(p.data, o)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        tiles = p.tiles()  # built at the solve's first mv
        same = same and all(torch.equal(a_, b_) for a_, b_ in (
            (tiles.ptr, fresh.ptr), (tiles.rows, fresh.rows), (tiles.offs, fresh.offs),
            (tiles.vals, fresh.vals)))
        got = dk.dia_spmv_kernel(p.data, o, x, tiles)
        same = same and torch.equal(_bits(got), _bits(want))
        same = same and torch.equal(_bits(p.mv(x)), _bits(want))
        k_ms = time_ms_ahead(lambda: dk.dia_spmv_kernel(p.data, o, x, tiles))
        mv_ms = time_ms_queued(lambda: p.mv(x))
        ptr = tiles.ptr.cpu().numpy()
        last = int(ptr[-1] - ptr[-2])
        occ_entries = TILE_ROWS * (tiles.nocc - last) + (n - TILE_ROWS * (ptr.size - 2)) * last
        held = sum(t_.numel() * t_.element_size()
                   for t_ in (tiles.ptr, tiles.rows, tiles.offs, tiles.vals))
        # design figure: the occupied tiles' values, their offsets and
        # tile_ptr, x and y once; the kernel reads these, zeros included
        occ_bytes = esize * occ_entries + 4.0 * (ptr.size + tiles.nocc) + 4.0 * (2 * n)
        occ_fig = occ_bytes / HBM_BYTES_PER_S * 1e3
        plain_ms = time_ms_queued(lambda: dk._dia_spmv_plain(p.data, o, x), reps=2, iters=3)
        ts_ = _csr_yardstick(p)
        nnz = int(ts_.values().numel())
        # the function's bound: each nonzero's value and one int32 position
        # (as the CSR yardstick reads them), x and y once; 2 flops a nonzero
        f_bytes = (esize + 4.0) * nnz + x.element_size() * n + 4.0 * n
        f_bound, f_by = bound(2.0 * nnz, f_bytes)
        lib_ms = time_ms_ahead(lambda: torch.sparse.mm(ts_, x[:, None]))
        lib_queued = time_ms_queued(lambda: torch.sparse.mm(ts_, x[:, None]))
        lib_err = over_scale(torch.sparse.mm(ts_, x[:, None])[:, 0], want)[1]
        print(f"dia_spmv level {lv} ({nd} diagonals x {n} rows, {nnz} nonzeros, "
              f"{nd * n / nnz:.1f}x padding): tile list {tiles.nocc} of {nd * (ptr.size - 1)} "
              f"32-row tiles ({tiles.nocc / (nd * (ptr.size - 1)):.4f}; "
              f"{nnz / occ_entries:.4f} of their entries nonzero), {held / 1e6:.2f} MB held, "
              f"built in {build_ms:.2f} ms; on the list {k_ms:.4f} ms, every diagonal "
              f"{full_ms:.4f} ms; PackedDIA.mv queued {mv_ms:.4f} ms; bound {f_bound:.4f} ms by "
              f"{f_by} ({f_bytes / 1e6:.2f} MB: nonzeros, their positions, x, y), the list "
              f"{k_ms / f_bound:.2f}x it; design figures at the HBM rate: the occupied tiles "
              f"{occ_fig:.4f} ms ({occ_bytes / 1e6:.1f} MB with their list, x, y; read at "
              f"{occ_bytes / (k_ms * 1e-3) / 1e12:.2f} TB/s), the whole plane {full_fig:.4f} ms "
              f"({full_bytes / 1e6:.1f} MB); plain {plain_ms:.4f} ms; torch.sparse.mm of its "
              f"CSR {lib_ms:.4f} ms (queued alone {lib_queued:.4f}; vs plain {lib_err:.2e} of "
              f"scale); bitwise equal to plain {same}")
        if not same:
            raise AssertionError(f"dia_spmv level {lv}: kernel disagrees with its plain version")
        del ts_
        rows[lv] = {"name": "dia_spmv", "route": "cuda",
                    "source": "tpusparse_torch/csrc/dia_spmv.cu", "replaces": replaces,
                    "max_abs_err": 0.0, "ms": k_ms, "plain_ms": plain_ms, "bound_ms": f_bound,
                    "bound_by": f_by, "library_ms": lib_ms}
        if lv != 1:
            continue
        # x's nonfinite check, which PackedDIA.mv launches before each walk
        bad = x.clone()
        bad[n // 2] = float("nan")
        flags, flags_bad = dk.dia_nonfinite_kernel(x), dk.dia_nonfinite_kernel(bad)
        c_same = (torch.equal(flags, dk._nonfinite_plain(x))
                  and torch.equal(flags_bad, dk._nonfinite_plain(bad)) and bool(flags_bad.any()))
        c_ms = time_ms_ahead(lambda: dk.dia_nonfinite_kernel(x))
        c_plain = time_ms_queued(lambda: dk._nonfinite_plain(x))
        # the library call of the same function: one flag for all of x
        c_lib = time_ms_ahead(lambda: torch.isfinite(x).all())
        c_bound, c_by = bound(float(n), x.element_size() * n + 4.0 * flags.numel())
        print(f"dia_nonfinite (x of {n}, {flags.numel()} slices): {c_ms:.4f} ms alone, plain "
              f"{c_plain:.4f} ms, torch.isfinite(x).all() {c_lib:.4f} ms (both behind a sleep), "
              f"bound {c_bound:.5f} ms by {c_by}; equal to plain with and without a NaN {c_same}")
        if not c_same:
            raise AssertionError("dia_nonfinite disagrees with its plain version")
        rows["check"] = {"name": "dia_nonfinite", "route": "cuda",
                         "source": "tpusparse_torch/csrc/dia_spmv.cu", "replaces": replaces,
                         "max_abs_err": 0.0, "ms": c_ms, "plain_ms": c_plain,
                         "bound_ms": c_bound, "bound_by": c_by, "library_ms": c_lib}
    return {"dia_spmv": rows[1], "dia_nonfinite": rows["check"]}


def _segsum_amg_rows(m) -> None:
    """windowed_segsum on the restriction maps of the AMG hierarchy (each
    level's factored P with an adopted segment plan: unsorted aggregation
    ids at cap 16384), bitwise against its plain version, beside
    index_add_ over the same map, both queued behind a sleep."""
    from tpusparse_torch.kernels import windowed as wk

    for lv, lvl in enumerate(m.levels):
        pf = getattr(lvl, "p_fact", None)
        if pf is None or pf.splan is None:
            continue
        sp = pf.splan
        y = torch.from_numpy(np.random.default_rng(lv).standard_normal(sp.n_in).astype(
            np.float32)).cuda()
        args = (sp.tensor("seg_masked", "cuda"), sp.tensor("starts", "cuda"))

        def sk():
            return wk.windowed_segsum_kernel(y, *args, num_segments=sp.num_segments,
                                             window=sp.window)
        want = wk._segsum_plain(y, *args, num_segments=sp.num_segments, window=sp.window)
        same = torch.equal(_bits(sk()), _bits(want))
        zeros = torch.zeros(sp.num_segments, device="cuda")
        k_ms = time_ms_ahead(sk)
        lib_ms = time_ms_ahead(lambda: zeros.clone().index_add_(0, pf.agg, y))
        nbytes = 4.0 * (2 * sp.n_in + sp.starts.size + sp.num_segments)
        b_ms, b_by = bound(float(sp.n_in), nbytes)
        print(f"windowed_segsum on amg level {lv}'s agg map (n_in {sp.n_in}, {sp.num_segments} "
              f"segments, W {sp.window}, {-(-sp.num_segments // 128)} spans, "
              f"{sp.exc_pos.size} exceptions): kernel {k_ms:.4f} ms, index_add_ {lib_ms:.4f} "
              f"ms (both queued behind a sleep), bound {b_ms:.4f} ms by {b_by}; bitwise equal "
              f"to plain {same}")
        if not same:
            raise AssertionError(f"windowed_segsum on amg level {lv}: kernel disagrees")


# -- the rest of the single-card surface: calibrate, RigL, the patched
# -- nn.Linear, GPT training and utils --------------------------------------

# RigL on the flagship MLP's widths (784 -> 256 -> 10) as masked dense weights
RIGL_DENSITY, RIGL_STEPS, RIGL_EVERY, RIGL_LR = 0.1, 200, 50, 1e-3
# the patched nn.Linear at the reference's smoke shapes
# (benchmarks/patched_linear.py: Linear(768, 768), x (16, 16, 768))
PATCH_FEATURES, PATCH_X = 768, (16, 16, 768)
# GPT training at the serving configuration's full width: batch 8 x seq 512
GPT_TRAIN_BATCH, GPT_TRAIN_STEPS, GPT_TRAIN_LR = 8, 3, 1e-4
# tests/test_torch_gpt.py's 2-layer fixture, card against CPU
GPT_SMALL = dict(num_layers=2, hidden=64, num_heads=4, intermediate=128, vocab_size=50,
                 max_position=32)
# device_time_per_iter against time_ms_queued of the same step: both time
# calls queued back to back (time_ms's one call adds the host's launch, ~0.045
# ms at the headline on an H100, 10-12 % of the step)
TIMER_AGREE = 0.10


def _power_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def _level_route(args, device) -> str:
    """What `amg._route_level` makes of a level on `device`'s constants."""
    from tpusparse_torch import amg

    split = amg._route_level(*args[:5], device)
    if split is None:
        return "csr"
    _, offs, rem = split
    return f"dia {offs.size} diagonals" + (f" + csr {int(rem[0][-1])} nnz" if rem else "")


def phase_calibrate(routes_at, level1_args) -> dict:
    """`calibrate()` on the card into a temporary file: the eight constants
    beside JAX's, each finite and positive; `load_calibration` reads them
    back, and a fit stamped with another card's name is ignored; the route
    'auto' takes at `routes_at` (label -> (CSR, n)) and laplace3d_64's level
    1 on JAX's constants (a CPU operand) and on the fit (a card operand).
    Then every constant is set back to JAX's, so that no later phase's
    launches depend on the fit. Returns the calibration's launches and the
    fit."""
    import os
    import tempfile

    import tpusparse_torch as tt
    from tpusparse_torch import ops
    from tpusparse_torch.utils import calibrate as cal

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calibration.json")
        kernels_reset()
        t0 = time.perf_counter()
        fit = tt.calibrate(save=True, path=path, verbose=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _launches()
        print(f"calibrate: {secs:.1f} s, launches {json.dumps({k: v for k, v in counts.items() if v})}"
              f" on {_power_line()}")
        for key in cal._CAL_KEYS:
            print(f"  {key}: fit {fit[key]!r}, JAX's TPU value {ops._COST_DEFAULTS[key]!r}")
        if sorted(fit) != sorted(cal._CAL_KEYS) or not all(
                np.isfinite(v) and v > 0 for v in fit.values()):
            raise AssertionError(f"calibrate: constants not finite and positive: {fit}")
        back = cal.load_calibration(path)
        with open(path) as f:
            payload = json.load(f)
        payload["device_kind"] = "another card"
        other = os.path.join(tmp, "other.json")
        with open(other, "w") as f:
            json.dump(payload, f)
        if back != fit or cal.load_calibration(other) is not None:
            raise AssertionError(f"calibrate: the saved fit reads back as {back}, and another "
                                 f"card's as {cal.load_calibration(other)}")
    print("calibrate: the saved fit reads back equal; a fit stamped with another card's name "
          "is ignored")
    for label, (csr, n) in routes_at.items():
        k = csr.shape[1]
        jax_route = ops._route_spmm(csr, torch.empty((k, n)), None)
        fit_route = ops._route_spmm(csr, torch.empty((k, n), device="cuda"), None)
        print(f"  'auto' at {label} (n {n}): JAX's constants {jax_route}, the fit {fit_route}")
    print(f"  amg laplace3d_64 level 1 (n {level1_args[3]}): JAX's constants "
          f"{_level_route(level1_args, 'cpu')}, the fit {_level_route(level1_args, 'cuda')}")
    ops.set_cost_constants(**ops._COST_DEFAULTS)
    if ops.get_cost_constants("cuda") != ops._COST_DEFAULTS:
        raise AssertionError("calibrate: JAX's constants not restored on the card")
    return counts, fit


def phase_rigl(batches) -> dict:
    """RigL on the card: the flagship MLP's widths as masked dense weights at
    density RIGL_DENSITY, RIGL_STEPS Adam steps over the MNIST batches with an
    update every RIGL_EVERY; nnz constant, the loss falling, no port kernel in
    the loop; then each harvested CSR through `tt.spmm` with the default
    method against the masked dense product (fp32 tier), its launches those
    of the route 'auto' takes. Returns those launches."""
    import torch.nn.functional as F

    import tpusparse_torch as tt
    from tpusparse_torch import ops
    from tpusparse_torch.nn import rigl
    from tpusparse_torch.utils.config import fp32_matmul

    gen = torch.Generator().manual_seed(41)
    shapes = {"fc1.weight": (256, 784), "fc1.bias": (256,), "fc2.weight": (10, 256),
              "fc2.bias": (10,)}
    params = {k: torch.nn.Parameter(((torch.rand(s, generator=gen) * 2 - 1)
                                     / np.sqrt(s[-1] if len(s) == 2 else 256)).cuda())
              for k, s in shapes.items()}
    masks = rigl.init_masks(params, RIGL_DENSITY, gen)
    nnz0 = {k: int(m.sum()) for k, m in masks.items() if m is not None}
    with torch.no_grad():
        for k, w in rigl.apply_masks(params, masks).items():
            params[k].copy_(w)
    opt = torch.optim.Adam(params.values(), lr=RIGL_LR)
    data = [(x.cuda(), y.long().cuda()) for x, y in batches]
    losses, moved = [], 0
    kernels_reset()
    t0 = time.perf_counter()
    for t in range(RIGL_STEPS):
        x, y = data[t % len(data)]
        opt.zero_grad(set_to_none=True)
        h = torch.relu(x @ params["fc1.weight"].T + params["fc1.bias"])
        loss = F.nll_loss(torch.log_softmax(h @ params["fc2.weight"].T + params["fc2.bias"], -1), y)
        loss.backward()
        dense = {k: p.grad.clone() for k, p in params.items()}
        for k, g in rigl.mask_grads(dense, masks).items():
            params[k].grad = g
        opt.step()
        if t % RIGL_EVERY == RIGL_EVERY - 1:
            new = rigl.rigl_update_tree(masks, params, dense,
                                        rigl.cosine_drop_fraction(t, RIGL_STEPS))
            moved += sum(int((new[k] != masks[k]).sum()) for k in nnz0)
            masks = new
        with torch.no_grad():
            for k, w in rigl.apply_masks(params, masks).items():
                params[k].copy_(w)
        losses.append(loss.detach())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _expect("rigl training", _launches(), {})
    losses = [float(v) for v in losses]
    nnz = {k: int(masks[k].sum()) for k in nnz0}
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"rigl ({RIGL_STEPS} Adam steps, updates every {RIGL_EVERY}): {secs * 1e3 / RIGL_STEPS:.3f}"
          f" ms a step on the host's clock, loss {first:.4f} -> {last:.4f} (means of 10), nnz "
          f"{nnz} (start {nnz0}), {moved} mask entries moved, no port kernel launched")
    if nnz != nnz0 or not (np.isfinite(losses).all() and last < first) or moved == 0:
        raise AssertionError(f"rigl: nnz {nnz} vs {nnz0}, losses {first} -> {last}, moved {moved}")
    total = dict(NO_LAUNCH)
    expect_by_route = {"tiled": {"block_ell_spmm": 1}}
    x = data[0][0]
    inp = {"fc1.weight": x.T.contiguous()}
    inp["fc2.weight"] = torch.relu(x @ params["fc1.weight"].detach().T
                                   + params["fc1.bias"].detach()).T.contiguous()
    for k in nnz0:
        a = rigl.harvest_csr(params[k], masks[k])
        route = ops._route_spmm(a, inp[k], None)
        kernels_reset()
        with torch.no_grad():
            y = tt.spmm(a, inp[k])
        torch.cuda.synchronize()
        counts = _launches()
        _expect(f"rigl harvested {k} spmm ('auto' -> {route})", counts,
                expect_by_route.get(route, {}))
        for kn, v in counts.items():
            total[kn] += v
        with fp32_matmul(), torch.no_grad():
            want = (params[k] * masks[k]) @ inp[k]
        err = over_scale(y, want)
        torch.testing.assert_close(y, want, **TOL_FP32)
        print(f"rigl harvested {k} ({a.shape}, nnz {a.nnz}) @ {tuple(inp[k].shape)}: 'auto' -> "
              f"{route}, launches {json.dumps({n_: v for n_, v in counts.items() if v})}, "
              f"vs masked dense max_abs_err {err[0]:.3e} (ok)")
    return total


def phase_patched_linear() -> dict:
    """The patched nn.Linear at the reference's smoke shapes, forward and
    backward, with cuBLAS and with the GEMM kernel (`use_gemm_kernel`): the
    output and the grads of x, W and b against a float64 product (fp32
    tier), and the launches `ops.transb_mm` implies (the kernel route: 1
    forward gemm, 2 backward, dX and dW). Returns the kernel route's."""
    import tpusparse_torch as tt

    gen = torch.Generator().manual_seed(42)
    with tt.patch_torch_linear():
        lin = torch.nn.Linear(PATCH_FEATURES, PATCH_FEATURES, device="cuda")
    if not isinstance(lin, tt.PatchedLinear) or torch.nn.Linear is tt.PatchedLinear:
        raise AssertionError("patched linear: the patch did not bind or did not restore")
    x = torch.randn(PATCH_X, generator=gen).cuda()
    g = torch.randn(PATCH_X[:-1] + (PATCH_FEATURES,), generator=gen).cuda()
    x64, w64, b64, g64 = (t.detach().double() for t in (x, lin.weight, lin.bias, g))
    want = {"y": x64 @ w64.T + b64, "dx": g64 @ w64,
            "dw": g64.reshape(-1, PATCH_FEATURES).T @ x64.reshape(-1, PATCH_FEATURES),
            "db": g64.sum((0, 1))}
    kernel_counts = None
    for use_kernel in (False, True):
        label = "GEMM kernel" if use_kernel else "cuBLAS"
        tt.set_config(use_gemm_kernel=use_kernel)
        try:
            def step():
                lin.zero_grad(set_to_none=True)
                xx = x.clone().requires_grad_(True)
                y = lin(xx)
                y.backward(g)
                return y, xx.grad

            kernels_reset()
            y, dx = step()
            torch.cuda.synchronize()
            counts = _launches()
            _expect(f"patched linear ({label})", counts, {"gemm": 3} if use_kernel else {})
            ms = time_ms(step)
        finally:
            tt.set_config(use_gemm_kernel=False)
        got = {"y": y.detach(), "dx": dx, "dw": lin.weight.grad, "db": lin.bias.grad}
        errs = {}
        for key, w in want.items():
            torch.testing.assert_close(got[key].double(), w, **TOL_FP32)
            errs[key] = over_scale(got[key].double(), w)[1]
        print(f"patched linear {PATCH_FEATURES}x{PATCH_FEATURES} at x {PATCH_X} ({label}): "
              f"forward and backward {ms:.4f} ms, launches "
              f"{json.dumps({n_: v for n_, v in counts.items() if v})}, vs float64 over scale "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " (ok)")
        if use_kernel:
            kernel_counts = counts
    return kernel_counts


def _gpt_losses(model, ids, steps, lr, on_step=None) -> list:
    """`steps` Adam steps of next-token loss on `ids`; the losses, detached."""
    import torch.nn.functional as F

    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    x, y = ids[:, :-1], ids[:, 1:]
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        logits = model(x)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1))
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if on_step is not None:
            on_step(i)
    return [float(v) for v in losses]


def phase_gpt_training() -> dict:
    """GPT training at the serving configuration's full width (GPT): batch
    GPT_TRAIN_BATCH x seq 512, fused=True, GPT_TRAIN_STEPS Adam steps, each
    with one flash_fwd, flash_dq and flash_dkv a layer counted and its time
    by CUDA events; the loss finite. Then the 2-layer fixture's 3 Adam steps
    (lr 1e-2, fused), card against CPU, within the fp32 tier. Returns the
    full-width steps' launches."""
    import tpusparse_torch as tt

    layers = GPT["num_layers"]
    per_step = {"flash_fwd": layers, "flash_dq": layers, "flash_dkv": layers}
    model = tt.GPTDecoder(**GPT, fused=True, device="cuda",
                          generator=torch.Generator().manual_seed(22))
    seq = GPT["max_position"]
    ids = torch.randint(0, GPT["vocab_size"], (GPT_TRAIN_BATCH, seq + 1),
                        generator=torch.Generator().manual_seed(23)).cuda()
    total = dict(NO_LAUNCH)
    times, events = [], []

    def mark(i):
        events[-1][1].record()
        torch.cuda.synchronize()
        counts = _launches()
        _expect(f"gpt training step {i}", counts, per_step)
        for kn, v in counts.items():
            total[kn] += v
        times.append(events[-1][0].elapsed_time(events[-1][1]))
        kernels_reset()
        events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
        events[-1][0].record()

    kernels_reset()
    events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
    events[-1][0].record()
    losses = _gpt_losses(model, ids, GPT_TRAIN_STEPS, GPT_TRAIN_LR, on_step=mark)
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"gpt training ({layers} layers, {GPT['hidden']} wide, vocab {GPT['vocab_size']}, batch "
          f"{GPT_TRAIN_BATCH} x seq {seq}, fused): {' / '.join(f'{t:.2f}' for t in times)} ms a "
          f"step by CUDA events (the first warms up), launches a step {json.dumps(per_step)}, "
          f"loss {' -> '.join(f'{v:.4f}' for v in losses)}, peak memory {mem:.1f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"gpt training: loss not finite: {losses}")
    del model
    small_ids = torch.from_numpy(np.random.default_rng(0).integers(0, 50, (2, 8)))
    runs = {}
    for dev in ("cuda", "cpu"):
        m = tt.GPTDecoder(**GPT_SMALL, fused=True, device=dev,
                          generator=torch.Generator().manual_seed(24))
        runs[dev] = _gpt_losses(m, small_ids.to(dev), 3, 1e-2)
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], **TOL_FP32)
    print(f"gpt training 2-layer fixture, 3 Adam steps card vs CPU: losses "
          f"{[round(v, 6) for v in runs['cuda']]} vs {[round(v, 6) for v in runs['cpu']]} (ok)")
    return {"launches": total, "ms": times}


def phase_utils(a, plan, bv, b) -> None:
    """The utils on the card: a checkpoint round trip of a card MLP and its
    Adam state, bitwise, and the same next step from both; a `trace` whose
    file names the block SpMM kernel; `measured_roofline` of the headline
    plan; `device_time_per_iter` of `resident_spmm_kernel` within
    TIMER_AGREE of `time_ms_queued` of the same step (`time_ms` printed
    beside); `debug_checks` catching a
    malformed CSR on the card, and `check_csr` a non-finite value."""
    import os
    import tempfile

    import tpusparse_torch as tt
    from tpusparse_torch.kernels.tiled_spmm import resident_spmm_kernel
    from tpusparse_torch.utils import checkpoint, debug, profiling, timing

    def adam_net():
        net = _net("dense", "cuda")
        return net, torch.optim.Adam(net.parameters(), lr=1e-3)

    batches = [(x.cuda(), y.cuda()) for x, y in _mnist_batches()[:3]]
    net, opt = adam_net()
    for xb, yb in batches[:2]:
        tt.train_step(net, opt, xb, yb)
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_checkpoint(tmp, 2, {"model": net.state_dict(), "opt": opt.state_dict()})
        net2, opt2 = adam_net()
        state = checkpoint.restore_checkpoint(
            tmp, template={"model": net2.state_dict(), "opt": opt2.state_dict()})
    net2.load_state_dict(state["model"])
    opt2.load_state_dict(state["opt"])
    same = all(torch.equal(p, q) for p, q in zip(net.parameters(), net2.parameters()))
    for s1, s2 in zip(opt.state.values(), opt2.state.values()):
        same &= all(torch.equal(torch.as_tensor(s1[k]), torch.as_tensor(s2[k])) for k in s1)
    l1 = tt.train_step(net, opt, *batches[2])
    l2 = tt.train_step(net2, opt2, *batches[2])
    same &= bool(torch.equal(l1, l2)) and all(
        torch.equal(p, q) for p, q in zip(net.parameters(), net2.parameters()))
    print(f"checkpoint: a card MLP and its Adam state round trip bitwise, and the next step "
          f"from both is bitwise equal: {same}")
    if not same:
        raise AssertionError("checkpoint: the restored state or its next step differs")

    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            with profiling.annotate("headline spmm"):
                tt.spmm_blocks(plan, bv, b)
        (path,) = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    gpu = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    # what the session itself holds, beside what its file holds
    in_session = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    spans = {e["name"] for e in events} & {"headline spmm"}
    print(f"trace: {os.path.basename(path)} with {len(events)} events; kernels {gpu[:4]}; "
          f"span {sorted(spans)}; {in_session} device events in the session")
    if not (spans and any("block_spmm" in n for n in gpu)):
        raise AssertionError("trace: the file does not name the span and the block SpMM kernel")

    rows = torch.from_numpy(a.row_ids().astype(np.int64)).cuda()
    scale = 1.0 / float(torch.zeros(a.shape[0], device="cuda").index_add_(0, rows, a.data.abs())
                        .max())

    def step(v):  # shape-preserving (A is square); the scale keeps the chain bounded
        return resident_spmm_kernel(plan, bv, v).mul_(scale)

    per_iter = timing.device_time_per_iter(step, b)
    one = time_ms(lambda: step(b)) * 1e-3
    queued = time_ms_queued(lambda: step(b)) * 1e-3
    rep = profiling.measured_roofline(plan, time_fn=lambda: per_iter, n_cols=b.shape[1])
    print(f"device_time_per_iter(resident_spmm_kernel, headline): {per_iter * 1e3:.4f} ms, "
          f"time_ms {one * 1e3:.4f} ms, time_ms_queued {queued * 1e3:.4f} ms; measured_roofline: "
          f"{rep['achieved_gflops']:.1f} GFLOP/s useful, projected {rep['projected_sol_sec'] * 1e3:.4f}"
          f" ms ({rep['plan_bound']}-bound), sol_fraction {rep['sol_fraction']:.3f}")
    if abs(per_iter - queued) > TIMER_AGREE * queued:
        raise AssertionError(f"device_time_per_iter {per_iter} not within {TIMER_AGREE} of "
                             f"time_ms_queued {queued}")

    bad = tt.CSR(a.data[:8].clone(), np.full(8, a.shape[1] + 5, np.int32),
                 np.array([0] + [8] * a.shape[0], np.int32), a.shape)
    tt.set_config(debug_checks=True)
    try:
        tt.spmm(bad, b)
        caught = None
    except ValueError as exc:
        caught = str(exc)
    finally:
        tt.set_config(debug_checks=False)
    nan = a.data[:8].clone()
    nan[3] = float("nan")
    try:
        debug.check_csr(tt.CSR(nan, np.arange(8, dtype=np.int32),
                               np.array([0, 8] + [8] * (a.shape[0] - 1), np.int32), a.shape))
        nan_caught = None
    except ValueError as exc:
        nan_caught = str(exc)
    print(f"debug_checks: spmm of a malformed card CSR raised {caught!r}; check_csr of a NaN "
          f"value raised {nan_caught!r}")
    if not (caught and "out of range" in caught and nan_caught and "non-finite" in nan_caught):
        raise AssertionError("debug checks missed a malformed CSR on the card")


# the parallel phase (world size 1 on NCCL): the sharded MLP's launches a
# step (its forward and the dblocks; x needs no gradient, so no dB) and the
# sharded GCN's on Cora (each of its 2 layers: the forward and the dB of
# H W; Â's values need no gradient, so no sddmm)
PAR_MLP_STEP = {"block_ell_spmm": 1, "sddmm": 1}
PAR_GCN_FORWARD = {"block_ell_spmm": 2}
PAR_GCN_STEP = {"block_ell_spmm": 4}
# unpreconditioned CG on laplace3d_64 at tol 1e-7 (~200 loop iterations)
PAR_CG_MAXITER = 1000
PAR_SPD_N = 4096  # sharded_cg's SPD CSR: B + Bᵀ + (2·n·density + 1)·I, B at 0.2 %
PAR_SPD_DENSITY = 0.002
PAR_NDEVS = (2, 4, 8)


def _par_mlp(cfg, mesh, batches, device, on_step=None):
    """The dp×tp sparse-MLP step from seed 0's weights over `batches`;
    returns (losses, params, mask, the step and its state)."""
    from tpusparse_torch import parallel as P

    params, rsp, mask, opt = P.make_sharded_train_state(cfg, mesh,
                                                        torch.Generator().manual_seed(0))
    step = P.make_sharded_train_step(cfg, mesh, rsp)
    losses = []
    for i, (x, y) in enumerate(batches):
        losses.append(float(step(params, opt, mask, x.to(device), y.to(device))))
        if on_step is not None:
            on_step(i, params)
    return losses, params, mask, (step, opt)


def _spd_csr(n, density, seed, device):
    import scipy.sparse as ssp

    import tpusparse_torch as tt

    bm = ssp.random(n, n, density=density, random_state=seed, format="csr", dtype=np.float32)
    a = (bm + bm.T + (2.0 * n * density + 1.0) * ssp.eye(n, dtype=np.float32)).tocsr()
    a = a.astype(np.float32)
    a.sort_indices()
    return tt.CSR.from_scipy(a, device=device), a


def phase_parallel(a, plan, bv, b, batches, cora, fit) -> dict:
    """`tpusparse_torch.parallel` at world size 1 on NCCL (a `file://`
    store), the group torn down at the end: `sharded_spmm` and `halo_spmm`
    at the headline against the plain executor, each timed against one
    `spmm`; the dp×tp sparse-MLP step at ShardedMLPConfig's defaults, batch
    32, TRAIN_STEPS steps with the launches of each checked, the loss
    dropping, the mask kept and PARITY_STEPS steps against the same steps on
    the CPU (gloo, world size 1, before NCCL comes up), timed beside
    phase_train's 'sparse' step; the node-sharded GCN on the Cora-shaped
    task against the single-card GCN and GRAPH_STEPS Adam steps; sharded_dia_cg
    on laplace3d_64 beside `linalg.cg` on one card (a solve, whose float64
    residual must be within 10 % of one card's, then one restart from its
    x, whose residual must be under AMG_RESID_LIMIT) and sharded_cg on an SPD
    CSR with its float64 residual; the scaling projection at the headline on
    this card's fit.
    Returns the launches of the counted runs."""
    import torch.distributed as dist

    import tpusparse_torch as tt
    from tpusparse_torch import ops
    from tpusparse_torch import parallel as P
    from tpusparse_torch.kernels.tiled_spmm import _block_exec_plain
    from tpusparse_torch.models import gcn
    from tpusparse_torch.parallel.projection import NVLINK_BW
    from tpusparse_torch.utils.matrices import get_matrix

    total = {"block_ell_spmm": 0, "sddmm": 0}

    def counted(label, expect):
        torch.cuda.synchronize()
        counts = _launches()
        _expect(label, counts, expect)
        for kname in total:
            total[kname] += counts[kname]

    cfg = P.ShardedMLPConfig()
    P.initialize_distributed(device="cpu")
    try:
        cpu_losses, cpu_params, _, _ = _par_mlp(cfg, P.make_mesh(device="cpu"),
                                               batches[:PARITY_STEPS], "cpu")
    finally:
        dist.destroy_process_group()

    P.initialize_distributed()
    try:
        mesh, mesh1 = P.make_mesh(), P.make_mesh((1,), ("model",))
        print(f"parallel: {dist.get_backend()} at world size {dist.get_world_size()}, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, on {_power_line()}")

        # -- sharded_spmm and halo_spmm at the headline --------------------------
        n = b.shape[1]
        t0 = time.perf_counter()
        rsp, hsp = P.shard_plan_rows(a, 1, plan.blocksize), P.shard_plan_2d(a, 1, plan.blocksize)
        print(f"parallel plans of the headline: {time.perf_counter() - t0:.2f} s on the host")
        if not (np.array_equal(rsp.block_cols[0], plan.block_cols)
                and np.array_equal(hsp.nslots[0, 0], plan.nslots)):
            raise AssertionError("the one-rank plans differ from the headline's plan")
        kernels_reset()
        c_rows = P.sharded_spmm(rsp, a.data, b, mesh)
        c_halo = P.halo_spmm(hsp, a.data, b, mesh)
        counted("sharded and halo spmm at the headline", {"block_ell_spmm": 2})
        ref = _block_exec_plain(plan, bv, b)
        single = tt.spmm(a, b, method="tiled")
        for label, got in (("sharded_spmm", c_rows), ("halo_spmm", c_halo)):
            rel = over_scale(got, ref)[1]
            same = torch.equal(got, single)
            print(f"{label} headline at world size 1: against the plain executor over scale "
                  f"{rel:.3e} (limit {HEADLINE_TOL}); equal to spmm(method='tiled') bit for "
                  f"bit: {same}")
            if not (rel <= HEADLINE_TOL and got.shape == single.shape
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"{label} disagrees with the plain executor")
        del ref, single, c_rows, c_halo
        # spmm looks its plans up by the pattern's fingerprint every call (a
        # SHA-1 of 27.3M indices); tiled_spmm with the plans held is the same
        # pack and launch without it, the yardstick of the gap
        lookup_ms = time_ms(lambda: tt.spmm(a, b, method="tiled"), warmup=0, iters=1)
        pair = tt.build_plan_pair(a)
        spmm_ms = time_ms(lambda: tt.tiled_spmm(a, b, plans=pair))
        rows_ms = time_ms(lambda: P.sharded_spmm(rsp, a.data, b, mesh))
        halo_ms = time_ms(lambda: P.halo_spmm(hsp, a.data, b, mesh))
        print(f"headline at world size 1 (median of 10, CUDA events): spmm(method='tiled') "
              f"with its plans held (tiled_spmm(plans=...)) {spmm_ms:.4f} ms, sharded_spmm "
              f"{rows_ms:.4f} ms ({rows_ms - spmm_ms:+.4f}), halo_spmm {halo_ms:.4f} ms "
              f"({halo_ms - spmm_ms:+.4f}): the all_gather and the layer; spmm(method='tiled') "
              f"looking its plans up {lookup_ms:.1f} ms (one call)")
        del rsp, hsp

        # -- the dp×tp sparse-MLP step --------------------------------------------
        snap = {}

        def on_step(i, params):
            counted(f"sharded mlp step {i}", PAR_MLP_STEP)
            kernels_reset()
            if i + 1 == PARITY_STEPS:
                snap.update({k: v.detach().cpu().clone() for k, v in params.items()})

        kernels_reset()
        losses, params, mask, (step, opt) = _par_mlp(cfg, mesh, batches, "cuda", on_step)
        print(f"sharded mlp ({cfg.in_features}/{cfg.hidden}/{cfg.num_classes}, density "
              f"{cfg.density}, blocks {cfg.blocksize}, batch {batches[0][0].shape[0]}): "
              f"{len(losses)} "
              f"steps, launches {json.dumps(PAR_MLP_STEP)} a step, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
        if not (all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0]):
            raise AssertionError(f"sharded mlp: loss did not drop: {losses}")
        outside = params["w1_blocks"].detach()[mask == 0]
        if not bool((outside == 0).all()):
            raise AssertionError("sharded mlp: a weight outside the mask moved")
        np.testing.assert_allclose(losses[:PARITY_STEPS], cpu_losses, **TOL_FP32)
        err = 0.0
        for k_, p in cpu_params.items():
            torch.testing.assert_close(snap[k_], p.detach(), **TOL_FP32, msg=k_)
            err = max(err, float((snap[k_] - p.detach()).abs().max()))
        print(f"sharded mlp: {int((mask == 0).sum())} weights outside the mask stay 0; card vs "
              f"CPU over {PARITY_STEPS} steps: losses within tolerance, params max_abs_err "
              f"{err:.3e} (ok)")
        xb, yb = batches[0][0].cuda(), batches[0][1].cuda()
        mlp_ms = time_ms(lambda: step(params, opt, mask, xb, yb), warmup=5, iters=50)
        net = _net("sparse", "cuda")
        net_opt = tt.make_train_state(net)
        train_ms = time_ms(lambda: tt.train_step(net, net_opt, xb, yb), warmup=5, iters=50)
        print(f"sharded mlp step {mlp_ms:.4f} ms against phase_train's 'sparse' step "
              f"{train_ms:.4f} ms (batch 32, median of 50, CUDA events)")
        del params, opt, step, net, net_opt

        # -- the node-sharded GCN on the Cora-shaped task --------------------------
        adj, (x, labels, node_mask) = cora
        a_hat = tt.normalized_adjacency(_on(adj, "cuda"))
        model = tt.GCN(CORA["features"], hidden=(64,), num_classes=CORA["classes"],
                       device="cuda", generator=torch.Generator().manual_seed(31))
        rsp = P.shard_plan_rows(a_hat, 1)
        blocks = rsp.pack_values(a_hat.data)
        forward = P.make_sharded_gcn_forward(model, rsp, mesh1)
        xc, lc, mc = x.cuda(), labels.cuda(), node_mask.cuda()
        kernels_reset()
        with torch.no_grad():
            out = forward(model, blocks, xc)
        counted("sharded gcn forward", PAR_GCN_FORWARD)
        with torch.no_grad():
            want = model(a_hat, xc)
        fwd_err = float((out - want).abs().max())
        torch.testing.assert_close(out, want, **TOL_FP32)
        step = P.make_sharded_gcn_train_step(model, rsp, mesh1)
        opt = gcn.make_train_state(model, 1e-2)
        losses = []
        for i in range(GRAPH_STEPS):
            kernels_reset()
            losses.append(float(step(model, opt, blocks, xc, lc, mc)))
            counted(f"sharded gcn step {i}", PAR_GCN_STEP)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"sharded gcn: loss did not drop: {losses}")
        gcn_ms = time_ms(lambda: step(model, opt, blocks, xc, lc, mc), warmup=3, iters=20)
        print(f"sharded gcn cora (blocks {rsp.blocksize}, {int(rsp.nslots.sum())} of them): "
              f"forward against the single-card GCN max_abs_err {fwd_err:.3e} (ok), "
              f"{GRAPH_STEPS} Adam steps with {json.dumps(PAR_GCN_STEP)} each, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, {gcn_ms:.4f} ms a step")
        del model, opt, step, blocks, rsp

        # -- the sharded solvers ----------------------------------------------------
        lap = get_matrix("laplace3d_64", device="cuda")
        op = tt.csr_to_dia(lap)
        rhs = torch.from_numpy(np.random.default_rng(101).random(lap.shape[0],
                                                                 dtype=np.float32)).cuda()
        sp64, b64 = lap.to_scipy().astype(np.float64), rhs.double().cpu().numpy()
        # one solve stops where the fp32 recursive residual passes tol; the
        # true residual drifts from it (1.8e-4 of |b| here in both paths on
        # the CPU), so the solve restarts once from its x, as a user does
        res = {}
        for label, solve in (
                ("sharded_dia_cg", lambda M, x0: P.sharded_dia_cg(
                    op, rhs, mesh1, x0=x0, tol=AMG_TOL, maxiter=PAR_CG_MAXITER, M=M)),
                ("linalg.cg on one card", lambda M, x0: tt.linalg.cg(
                    op, rhs, x0=x0, tol=AMG_TOL, maxiter=PAR_CG_MAXITER, M=M))):
            xs = None
            for run in ("a solve", "restarted from its x"):
                calls = [0]

                def ident(v):
                    calls[0] += 1
                    return v

                torch.cuda.synchronize()
                t0 = time.perf_counter()
                xs = solve(ident, xs)[0]
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                res[label, run] = float(np.linalg.norm(sp64 @ xs.double().cpu().numpy() - b64)
                                        / np.linalg.norm(b64))
                print(f"{label} (laplace3d_64, {op.noffsets} diagonals, tol {AMG_TOL}), {run}: "
                      f"{calls[0] - 1} loop iterations in {secs * 1e3:.3f} ms, "
                      f"{secs * 1e3 / calls[0]:.4f} ms an iteration (host clock), float64 "
                      f"relative residual {res[label, run]:.3e}")
                if not bool(torch.isfinite(xs).all()):
                    raise AssertionError(f"{label}: x not finite")
        one = (res["sharded_dia_cg", "a solve"], res["linalg.cg on one card", "a solve"])
        if not (res["sharded_dia_cg", "restarted from its x"] < AMG_RESID_LIMIT
                and abs(one[0] - one[1]) <= 0.1 * one[1]):
            raise AssertionError(f"sharded_dia_cg: residuals {res} (limit {AMG_RESID_LIMIT} "
                                 f"restarted; a solve within 10 % of one card's)")
        del op, lap, rhs, sp64
        spd, spd_host = _spd_csr(PAR_SPD_N, PAR_SPD_DENSITY, 3, "cuda")
        rhs = torch.from_numpy(np.random.default_rng(102).random(PAR_SPD_N,
                                                                 dtype=np.float32)).cuda()
        calls = [0]

        def ident(v):
            calls[0] += 1
            return v

        kernels_reset()
        xs = P.sharded_cg(spd, rhs, mesh1, tol=1e-6, maxiter=500, M=ident)[0]
        counted("sharded_cg", {"block_ell_spmm": calls[0]})
        b64 = rhs.double().cpu().numpy()
        resid = float(np.linalg.norm(spd_host.astype(np.float64) @ xs.double().cpu().numpy()
                                     - b64) / np.linalg.norm(b64))
        print(f"sharded_cg ({PAR_SPD_N}^2 SPD CSR, nnz {spd.nnz}): {calls[0] - 1} loop "
              f"iterations, {calls[0]} block_ell_spmm, float64 relative residual {resid:.3e} "
              f"(limit {AMG_RESID_LIMIT})")
        if not (resid < AMG_RESID_LIMIT and bool(torch.isfinite(xs).all())):
            raise AssertionError(f"sharded_cg: residual {resid}")

        # -- the scaling projection, on this card's fit ---------------------------
        ops._install_fit(torch.cuda.get_device_name(0), fit)
        try:
            t0 = time.perf_counter()
            print(P.projection_table(
                P.project_sharded_spmm(a, n, PAR_NDEVS, plan.blocksize),
                f"sharded_spmm at the headline, projected on this card's fit"))
            print(P.projection_table(
                P.project_halo_spmm(a, n, PAR_NDEVS, plan.blocksize),
                f"halo_spmm at the headline, projected on this card's fit, the ring at "
                f"{NVLINK_BW / 1e9:.0f} GB/s a direction (NVIDIA's NVLink 4 specification "
                f"for the H100 SXM, not a measurement)"))
            print(f"  (projections: {time.perf_counter() - t0:.1f} s on the host)")
        finally:
            ops.set_cost_constants(**ops._COST_DEFAULTS)
    finally:
        dist.destroy_process_group()
    return total


# -- part b of tpusparse_torch.parallel: the sharded models -------------------------
# (shared with parallel_smoke.py, which runs the same checks over its cards)

PM_BERT_BATCH, PM_BERT_SEQ = 8, 512
PM_ATTN_SHAPE = (2, 12, 4096, 64)      # the (b, h, s, d) flash timings' long shape
PM_LONG_SHAPE = (1, 12, 16384, 64)     # benchmarks/longcontext_benchmark.py's
PM_BAND_WINDOW = 128
# Switch-Base-8 (Fedus et al. 2021, Switch Transformers): d_model 768, d_ff
# 3072, 8 experts; 8 sequences of 512 tokens
SWITCH_BASE_8 = dict(num_experts=8, d_model=768, d_hidden=3072)
PM_TOKENS = 8 * 512
PM_CAPACITY, PM_LOSSLESS = 2.0, 8.0
PM_PIPE = dict(d=1024, batch=512, microbatches=8)
PM_DECODE_BATCHES = (1, 8)
PM_OUT_SCALE, PM_GRAD_SCALE = 2e-5, 2e-4   # tests/test_parallel.py:140-203
PM_DECODE_SCALE = 5e-3                      # tests/test_serving.py:110-111


def _rank0() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def say(*args) -> None:
    """print on rank 0 only."""
    if _rank0():
        print(*args, flush=True)


def _counted(label, fn, expect):
    """fn() with the launch counts set to 0 just before and checked just
    after (`expect` and nothing else); returns (fn's result, the counts)."""
    kernels_reset()
    out = fn()
    torch.cuda.synchronize()
    counts = _launches()
    _expect(label, counts, expect)
    return out, counts


def _add(total, counts) -> None:
    for k in total:
        total[k] += counts.get(k, 0)


def _global_grads(local, specs, group):
    """The rank's BERT parameter gradients gathered along their split dims."""
    from tpusparse_torch.parallel.mesh import _gather_dim

    out = {}
    for name, p in local.items():
        spec = specs[name]
        out[name] = p.grad if "model" not in spec else _gather_dim(
            p.grad.contiguous(), group, spec.index("model"))
    return out


def pm_bert(P, meshes, total) -> None:
    """The Megatron BERT-base layer ('flash', batch 8, seq 512, fp32 'high')
    on each mesh, a forward and a backward against the one-card layer; the
    12-layer encoder's forward on the last mesh."""
    import tpusparse_torch as tt

    layer = _bert_layer("flash", "cuda", seed=61)
    x = _bert_input(PM_BERT_BATCH, PM_BERT_SEQ, 62).cuda()
    want = layer(x)
    tt.bert_loss(want).backward()
    ref = {n: p.grad.detach().clone() for n, p in layer.named_parameters()}
    one_ms = time_ms(lambda: tt.bert_loss(layer(x)).backward())
    for shape in meshes:
        mesh = P.make_mesh(shape)
        local, specs = P.shard_bert_params(layer, mesh)
        fwd = P.make_tp_forward(layer, mesh, specs)
        label = f"megatron bert layer mesh {shape}"
        got, c1 = _counted(f"{label} forward", lambda: fwd(local, x), {"flash_fwd": 1})
        _, c2 = _counted(f"{label} backward", lambda: tt.bert_loss(got).backward(),
                         {"flash_dq": 1, "flash_dkv": 1})
        _add(total, c1)
        _add(total, c2)
        # one rank runs the layer's own code on its own tensors: equal there;
        # across ranks the fp32 tier, outputs and grads
        exact = int(np.prod(shape)) == 1
        err = over_scale(got, want)[1]
        grads = _global_grads(local, specs, mesh.get_group("model"))
        scale = max(float(g.abs().max()) for g in ref.values())
        gerr = 0.0
        for name, (g, w) in [("output", (got, want))] + [(n, (g, ref[n]))
                                                         for n, g in grads.items()]:
            if exact and not torch.equal(g, w):
                raise AssertionError(f"{label}: {name} differs from one card's at world size 1")
            torch.testing.assert_close(g, w, **TOL_FP32, msg=name)
            if name != "output":
                gerr = max(gerr, float((g - w).abs().max()) / scale)
        ms = time_ms(lambda: tt.bert_loss(fwd(local, x)).backward())
        say(f"{label}: forward 1 flash_fwd, backward 1 flash_dq + 1 flash_dkv a rank; output "
            f"over scale {err:.3e}, grads over the largest {gerr:.3e} "
            f"({'equal' if exact else 'fp32 tier'}); forward + backward {ms:.4f} ms against "
            f"one card's layer {one_ms:.4f} ms (rank 0, median of 10)")
        del local, fwd, got, grads
    del layer, ref
    enc = tt.BertEncoder(**BERT, attention="flash", device="cuda",
                         generator=torch.Generator().manual_seed(63))
    ids = torch.from_numpy(np.random.default_rng(64).integers(
        0, 30522, (PM_BERT_BATCH, PM_BERT_SEQ))).cuda()
    with torch.no_grad():
        want = enc(ids)
        local, specs = P.shard_bert_params(enc, mesh)
        fwd = P.make_tp_forward(enc, mesh, specs)
        got, c = _counted(f"megatron bert encoder mesh {shape}", lambda: fwd(local, ids),
                          {"flash_fwd": enc.num_layers})
        _add(total, c)
        torch.testing.assert_close(got, want, **TOL_FP32)
        ms, one = time_ms(lambda: fwd(local, ids), 1, 5), time_ms(lambda: enc(ids), 1, 5)
    say(f"megatron bert encoder ({enc.num_layers} layers) mesh {shape}: forward "
        f"{enc.num_layers} flash_fwd a rank, over scale {over_scale(got, want)[1]:.3e}; "
        f"{ms:.3f} ms against one card's {one:.3f} ms (rank 0, median of 5)")


def _grad_run(fn, q, k, v, do):
    for t in (q, k, v):
        t.grad = None
    o = fn(q, k, v)
    o.backward(do)
    return o.detach(), q.grad, k.grad, v.grad


def pm_attention(P, shape, world, total, causals=(False, True)) -> None:
    """Ring flash and fused Ulysses over every rank, forward and backward,
    against `flash_attention_diff` on one card: bit for bit at world size 1,
    within 2e-5 (o) and 2e-4 (grads) of scale otherwise; P flash_fwd a rank
    forward and P flash_dq + P flash_dkv backward for the ring, 1 of each
    for Ulysses; the bytes and time of one hop."""
    from tpusparse_torch.kernels.flash_attention import flash_attention_diff
    from tpusparse_torch.parallel.mesh import ring_permute

    mesh = P.make_mesh((world,), ("seq",))
    q, k, v, do = _flash_operands(shape, 70 + shape[2] // 1024)
    for t in (q, k, v):
        t.requires_grad_()
    for causal in causals:
        want = _grad_run(lambda *a: flash_attention_diff(*a, causal), q, k, v, do)
        one_ms = time_ms(lambda: _grad_run(lambda *a: flash_attention_diff(*a, causal),
                                           q, k, v, do), 1, 5)
        for name, fn, n in (("ring flash", P.ring_flash_attention, world),
                            ("fused ulysses", lambda *a, **kw: P.ulysses_attention(
                                *a, fused=True, **kw), 1)):
            label = f"{name} {shape} causal={causal} over {world}"
            o = _counted(f"{label} forward", lambda: fn(q, k, v, mesh, causal=causal),
                         {"flash_fwd": n})[0]
            kernels_reset()
            got = _grad_run(lambda *a: fn(*a, mesh, causal=causal), q, k, v, do)
            torch.cuda.synchronize()
            c = _launches()
            _expect(f"{label} forward + backward", c,
                    {"flash_fwd": n, "flash_dq": n, "flash_dkv": n})
            _add(total, c)
            if world == 1:
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                if not same:
                    raise AssertionError(f"{label}: not flash_attention_diff bit for bit")
                check = "o, dq, dk, dv equal to flash_attention_diff bit for bit"
            else:
                errs = [rel_err(a, b)[1] for a, b in zip(got, want)]
                if not (errs[0] <= PM_OUT_SCALE and max(errs[1:]) <= PM_GRAD_SCALE):
                    raise AssertionError(f"{label}: over scale {errs}")
                check = ("over scale o {:.2e} dq {:.2e} dk {:.2e} dv {:.2e} (limits 2e-5, "
                         "2e-4)".format(*errs))
            del o
            ms = time_ms(lambda: _grad_run(lambda *a: fn(*a, mesh, causal=causal),
                                           q, k, v, do), 1, 5)
            say(f"{label}: {n} flash_fwd, {n} flash_dq, {n} flash_dkv a rank; {check}; "
                f"forward + backward {ms:.4f} ms against flash_attention_diff on one card "
                f"{one_ms:.4f} ms (rank 0, median of 5)")
    if world > 1:
        group = mesh.get_group("seq")
        blk = tuple(t.detach()[:, :, :shape[2] // world].contiguous() for t in (k, v))
        before = P.p2p_bytes()
        ring_permute(blk, group, 1)
        sent = P.p2p_bytes() - before
        hop_ms = time_ms(lambda: ring_permute(blk, group, 1))
        say(f"ring hop {shape} over {world}: {sent} bytes a rank (the k and v block), "
            f"{hop_ms:.4f} ms (rank 0, median of 10), {sent / hop_ms / 1e6:.2f} GB/s")


def pm_band(P, world) -> None:
    """ring_local_attention (2, 12, 4096, 64), window 128, forward and
    backward, against LocalAttention's core on one card."""
    import torch.nn.functional as F

    from tpusparse_torch.nn.attention import banded_blocks

    mesh = P.make_mesh((world,), ("seq",))
    b, h, s, d = PM_ATTN_SHAPE
    w = PM_BAND_WINDOW
    q, k, v, do = _flash_operands(PM_ATTN_SHAPE, 80)
    for t in (q, k, v):
        t.requires_grad_()

    def core(q, k, v):
        def blocks(x):
            return x.reshape(b, h, s // w, w, d)

        pad = [F.pad(blocks(x), (0, 0, 0, 0, 1, 1)) for x in (k, v)]
        return banded_blocks(blocks(q), *pad, w, 0, s).reshape(b, h, s, d)

    want = _grad_run(core, q, k, v, do)
    got, c = _counted("ring_local_attention", lambda: _grad_run(
        lambda *a: P.ring_local_attention(*a, w, mesh), q, k, v, do), {})
    for a, bb, name in zip(got, want, ("o", "dq", "dk", "dv")):
        torch.testing.assert_close(a, bb, **TOL_FP32, msg=name)
    ms = time_ms(lambda: _grad_run(lambda *a: P.ring_local_attention(*a, w, mesh), q, k, v, do),
                 1, 5)
    one = time_ms(lambda: _grad_run(core, q, k, v, do), 1, 5)
    say(f"ring_local_attention {PM_ATTN_SHAPE} window {w} over {world}: no kernel, o and grads "
        f"within the fp32 tier of LocalAttention's core; forward + backward {ms:.4f} ms "
        f"against one card's core {one:.4f} ms (rank 0, median of 5)")


def pm_moe(P, world) -> None:
    """Switch-Base-8's widths, 4096 tokens: moe_forward and its gradients,
    moe_forward_a2a lossless (capacity 8.0) against moe_forward_reference,
    and at capacity 2.0 with its share of dropped tokens."""
    mesh = P.make_mesh((world,), ("expert",))
    params = P.init_moe_params(torch.Generator().manual_seed(90), device="cuda",
                               **SWITCH_BASE_8)
    for t in params.values():
        t.requires_grad_()
    x = torch.from_numpy(np.random.default_rng(91).standard_normal(
        (PM_TOKENS, SWITCH_BASE_8["d_model"]), dtype=np.float32)).cuda()

    def run(fn):
        for t in params.values():
            t.grad = None
        y = fn()
        y.square().sum().backward()
        return y.detach(), {n: t.grad for n, t in params.items()}

    want, wg = run(lambda: P.moe_forward_reference(params, x))
    one = time_ms(lambda: run(lambda: P.moe_forward_reference(params, x)), 1, 5)
    for label, fn in (("moe_forward", lambda: P.moe_forward(params, x, mesh)),
                      (f"moe_forward_a2a capacity {PM_LOSSLESS}", lambda: P.moe_forward_a2a(
                          params, x, mesh, capacity_factor=PM_LOSSLESS))):
        (got, gg), c = _counted(label, lambda: run(fn), {})
        torch.testing.assert_close(got, want, **TOL_FP32)
        for n in gg:
            torch.testing.assert_close(gg[n], wg[n], **TOL_FP32, msg=n)
        ms = time_ms(lambda: run(fn), 1, 5)
        say(f"{label} (Switch-Base-8 widths, {PM_TOKENS} tokens) over {world}: output and "
            f"router/w_in/w_out grads within the fp32 tier of moe_forward_reference; forward + "
            f"backward {ms:.3f} ms against the reference on one card {one:.3f} ms")
    with torch.no_grad():
        y = P.moe_forward_a2a(params, x, mesh, capacity_factor=PM_CAPACITY)
        dropped = (y == 0).all(dim=1)
        kept = ~dropped
        torch.testing.assert_close(y[kept], want[kept], **TOL_FP32)
        ms = time_ms(lambda: P.moe_forward_a2a(params, x, mesh, capacity_factor=PM_CAPACITY))
    say(f"moe_forward_a2a capacity {PM_CAPACITY} over {world}: {int(dropped.sum())} of "
        f"{PM_TOKENS} tokens dropped ({float(dropped.float().mean()):.4f}), the kept ones within "
        f"the fp32 tier of the reference; forward {ms:.3f} ms")


def pm_pipeline(P, world) -> None:
    """pipeline_apply, one relu(h W + b) stage a rank, d 1024, batch 512, 8
    microbatches: forward and gradients against the sequential loop."""
    import tpusparse_torch as tt

    S, d, M = world, PM_PIPE["d"], PM_PIPE["microbatches"]
    mesh = P.make_mesh((world,), ("stage",))
    rng = np.random.default_rng(95)
    ws = torch.from_numpy((rng.standard_normal((S, d, d)) / np.sqrt(d)).astype(np.float32))
    bs = torch.from_numpy((rng.standard_normal((S, d)) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((PM_PIPE["batch"], d)).astype(np.float32)).cuda()
    ws, bs = ws.cuda().requires_grad_(), bs.cuda().requires_grad_()

    def stage(p, h):
        return torch.relu(tt.mm(h, p[0]) + p[1])

    def seq():
        h = x
        for s in range(S):
            h = stage((ws[s], bs[s]), h)
        return h

    def run(fn):
        ws.grad = bs.grad = None
        y = fn()
        y.square().sum().backward()
        return y.detach(), ws.grad, bs.grad

    def pipe():
        return P.pipeline_apply(stage, (ws, bs), x, mesh, num_microbatches=M)

    want = run(seq)
    got, _ = _counted("pipeline", lambda: run(pipe), {})
    for a, b, n in zip(got, want, ("out", "dW", "db")):
        torch.testing.assert_close(a, b, **TOL_FP32, msg=n)
    ms, one = time_ms(lambda: run(pipe), 1, 5), time_ms(lambda: run(seq), 1, 5)
    say(f"pipeline_apply (d {d}, batch {PM_PIPE['batch']}, {M} microbatches, {S} stages): out "
        f"and grads within the fp32 tier of the sequential loop; forward + backward {ms:.3f} ms "
        f"against the loop on one card {one:.3f} ms; schedule utilisation M/(M+S-1) = "
        f"{M / (M + S - 1):.3f}, measured one / (S x pipeline) {one / (S * ms):.3f}")


def _cache_apart(full, one, pos):
    """(values of the gathered int8 cache apart from one card's at the new
    token's position, in layer 0 and in all; the largest gap there; whether
    every other entry, scales included, is equal)."""
    apart0 = apart = 0
    most, rest = 0.0, True
    for i, (la, lb) in enumerate(zip(full, one)):
        for j, (a, b) in enumerate(zip(la, lb)):
            if j % 2:  # the per-(b, h) scales, fixed at prefill
                rest = rest and torch.equal(a, b)
                continue
            d = (a[:, :, pos].float() - b[:, :, pos].float()).abs()
            n = int((d != 0).sum())
            apart, apart0 = apart + n, apart0 + (n if i == 0 else 0)
            most = max(most, float(d.max()))
            keep = torch.ones(a.shape[2], dtype=torch.bool, device=a.device)
            keep[pos] = False
            rest = rest and a.dtype == torch.int8 and torch.equal(a[:, :, keep], b[:, :, keep])
    return apart0, apart, most, rest


def pm_decode(P, world) -> None:
    """TP int8 decode at serving_benchmark.py's GPT on a (1, world) mesh,
    batch 1 and 8, against the one-card decode_step: at world size 1 the
    logits and the int8 cache equal; over more ranks the logits within 5e-3
    of scale (the row-parallel partial sums reassociate), the gathered cache
    int8 and equal but at the new token's position, where each value is
    within 1 of one card's (its k and v come from activations that may
    round to the neighbouring bf16 value); ms per token of both."""
    import tpusparse_torch as tt

    model = tt.GPTDecoder(**GPT, device="cuda", generator=torch.Generator().manual_seed(21))
    qm = tt.quantize_gpt(model)
    del model
    mesh = P.make_mesh((1, world))
    qs, _ = P.shard_qgpt(qm, mesh)
    step = P.make_tp_decode_step(qs, mesh)
    rng = np.random.default_rng(96)
    pos = GPT_PROMPT

    def copy(c):
        return tuple(tuple(t.clone() for t in layer) for layer in c)

    for batch in PM_DECODE_BATCHES:
        ids = torch.from_numpy(rng.integers(0, GPT["vocab_size"], (batch, pos + 1))).cuda()
        with torch.no_grad():
            _, cache = qm.prefill(ids[:, :pos])
            want, one_cache = qm.decode_step(ids[:, pos], copy(cache), pos)
        got, local = _counted(f"tp decode batch {batch}",
                              lambda: step(ids[:, pos], copy(cache), pos), {})[0]
        full = step.gather_cache(local)
        err = over_scale(got, want)[1]
        apart0, apart, most, rest = _cache_apart(full, one_cache, pos)
        exact = world == 1
        if not (rest and (err == 0 and apart == 0 if exact else
                          err < PM_DECODE_SCALE and most <= 1)):
            raise AssertionError(f"tp decode batch {batch}: logits over scale {err}, cache "
                                 f"{apart} values apart at the new token ({apart0} in layer "
                                 f"0), by at most {most}, the rest equal: {rest}")
        with torch.no_grad():
            one = time_ms(lambda: qm.decode_step(ids[:, pos], one_cache, pos))
        ms = time_ms(lambda: step(ids[:, pos], local, pos))
        n_new = 2 * GPT["num_layers"] * batch * GPT["hidden"]
        say(f"tp int8 decode batch {batch} over (1, {world}): logits over scale {err:.3e} "
            f"(limit {0 if exact else PM_DECODE_SCALE}); the gathered int8 cache equal to one "
            f"card's but {apart} of the new token's {n_new} values ({apart0} in layer 0), each "
            f"within {most:.0f}; {ms:.4f} ms a token against one card's decode_step "
            f"{one:.4f} ms (rank 0, median of 10)")


def run_parallel_models(P, world, bert_meshes, long_shapes=()) -> dict:
    """Every part b path over `world` ranks of the process group; returns
    this rank's flash launches."""
    total = dict(NO_FLASH)
    for name, fn in (("megatron bert", lambda: pm_bert(P, bert_meshes, total)),
                     ("ring flash and ulysses", lambda: pm_attention(
                         P, PM_ATTN_SHAPE, world, total)),
                     *((f"long context {s}", partial(pm_attention, P, s, world, total))
                       for s in long_shapes),
                     ("ring local", lambda: pm_band(P, world)),
                     ("moe", lambda: pm_moe(P, world)),
                     ("pipeline", lambda: pm_pipeline(P, world)),
                     ("tp decode", lambda: pm_decode(P, world))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        say(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
    return total


def phase_parallel_models() -> dict:
    """`tpusparse_torch.parallel` part b at world size 1 on NCCL (see
    run_parallel_models); returns the flash launches."""
    import torch.distributed as dist

    from tpusparse_torch import parallel as P

    P.initialize_distributed()
    try:
        return run_parallel_models(P, 1, [(1, 1)])
    finally:
        dist.destroy_process_group()


# the autotuners' shapes: GEMM (m, k, n, dtype, tier) at 4096^3 (where the
# kernel's own choice is the 128-row tile) and at m 512 (the 64-row one);
# flash (seq, head_dim, bh) at the BERT-base layer's (8 x 12 heads)
TUNE_GEMM = ((4096, 4096, 4096, torch.bfloat16, "high"), (4096, 4096, 4096, torch.float32, "high"),
             (512, 4096, 4096, torch.float32, "high"))
TUNE_FLASH = (512, 64, 96)
TUNE_HOST_N = 8         # gemm_kernel's host time with and without a saved tile, at (4096, 4096, n)
TUNE_LOOKUP_US = 2.0    # the most the tile lookup may add to a gemm_kernel call


def host_us(fn, calls=200, iters=3):
    """Median host microseconds a call of `fn` over `calls` calls enqueued
    behind a sleep that outlasts them, so the card never holds the host."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        torch.cuda._sleep(int(0.2 * 2e9))  # 0.1-0.2 s at 1-2 GHz
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def phase_examples() -> dict:
    """Each examples_torch/0*.py `main()` on the card (06 at world size 1 on
    NCCL), the launch counts set to 0 just before each and read just after:
    its launches by kernel and its wall time. An example's own check raises.
    Returns the launches summed over the examples."""
    import importlib.util
    import os

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch")
    paths = sorted(p for p in os.listdir(d) if p.startswith("0") and p.endswith(".py"))
    if len(paths) < 7:
        raise AssertionError(f"examples_torch holds {len(paths)} examples, not 7")
    sys.path.insert(0, d)
    total = dict(NO_LAUNCH)
    try:
        for name in paths:
            stem = name[:-3]
            spec = importlib.util.spec_from_file_location(stem, os.path.join(d, name))
            mod = importlib.util.module_from_spec(spec)
            sys.modules[stem] = mod
            spec.loader.exec_module(mod)
            kernels_reset()
            t0 = time.perf_counter()
            mod.main(**({"world_size": 1} if stem.startswith("06") else {}))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in _launches().items() if v}
            _add(total, counts)
            print(f"example {stem}: {wall:.2f} s, launches by kernel {json.dumps(counts)}",
                  flush=True)
    finally:
        sys.path.remove(d)
    print(f"examples: launches by kernel in all "
          f"{json.dumps({k: v for k, v in total.items() if v})}")
    return total


def phase_autotune() -> dict:
    """autotune_gemm and autotune_flash on the card, with
    TPUSPARSE_TORCH_CALIBRATION on a temporary file (removed after, the
    in-process tile caches emptied, the variable restored): each candidate
    tile's time (`time_ms_queued`, the kernel alone) and the autotuner's
    pick; a call with no tile arguments then launches the saved tile, with
    output bitwise equal to the kernel's own tile's; the tile lookup's host
    cost (at most TUNE_LOOKUP_US a call) and gemm_kernel's host
    microseconds at n TUNE_HOST_N with and without a saved tile. Returns
    the phase's launches."""
    import os
    import shutil
    import tempfile

    from tpusparse_torch.kernels import flash_attention as fa
    from tpusparse_torch.kernels import gemm as gk
    from tpusparse_torch.utils import calibrate

    def reread():
        gk._TILE_CACHE.clear()
        fa._FLASH_TILE_CACHE.clear()
        gk._TILE_CACHE_LOADED = fa._FLASH_TILE_LOADED = False

    tmp = tempfile.mkdtemp(prefix="tpusparse_torch_autotune_")
    old = os.environ.get("TPUSPARSE_TORCH_CALIBRATION")
    os.environ["TPUSPARSE_TORCH_CALIBRATION"] = os.path.join(tmp, "calibration.json")
    reread()
    total = dict(NO_LAUNCH)
    try:
        rng = np.random.default_rng(23)
        for m, k, n, dtype, tier in TUNE_GEMM:
            label = f"gemm ({m}, {k}, {n}) {str(dtype)[6:]} '{tier}'"
            a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to("cuda", dtype)
            b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to("cuda", dtype)
            own = gk.default_block_m(m, n)
            kernels_reset()
            tile, tflops = gk.autotune_gemm(m, k, n, dtype, repeats=2, save=True, verbose=True)
            _add(total, _launches())
            flops = 2.0 * m * n * k
            times = {}
            for t in gk.gemm_tiles(dtype, dtype, tier):
                times[t] = time_ms_queued(lambda: gk.gemm_kernel(a, b, precision=tier,
                                                                 block_m=t[0]))
            reread()  # the file, as a new process reads it
            if gk.resolve_tile(m, k, n, dtype, dtype, tier) != tuple(tile):
                raise AssertionError(f"{label}: a call does not take the saved tile {tile}")
            kernels_reset()
            tuned = gk.gemm_kernel(a, b, precision=tier)
            mine = gk.gemm_kernel(a, b, precision=tier, block_m=own)
            torch.cuda.synchronize()
            _add(total, _launches())
            same = torch.equal(tuned, mine)
            print(f"autotune {label}: candidates "
                  + ", ".join(f"{t} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)"
                              for t, ms in times.items())
                  + f"; picked {tuple(tile)} at {tflops:.1f} TFLOP/s (its chain); the kernel's "
                  f"own height {own}; a call with no tile launches the saved one, output "
                  f"{'bitwise equal to' if same else 'DIFFERENT from'} the own tile's", flush=True)
            if not same:
                raise AssertionError(f"{label}: the saved tile's output differs")
            del a, b, tuned, mine
        seq, d, bh = TUNE_FLASH
        for causal in (False, True):
            label = f"flash_fwd ({bh}, {seq}, {d}) fp32 'high'{' causal' if causal else ''}"
            kernels_reset()
            tile, secs = fa.autotune_flash(seq, d, bh, causal=causal, dtype=torch.float32,
                                           precision="high", repeats=2, save=True, verbose=True)
            _add(total, _launches())
            q, k, v = (torch.from_numpy(rng.standard_normal((bh, seq, d), dtype=np.float32)).cuda()
                       for _ in range(3))
            kw = dict(sm_scale=1 / d ** 0.5, causal=causal, precision="high")
            times = {t: time_ms_queued(lambda: fa.flash_fwd_kernel(q, k, v, block_q=t[0], **kw))
                     for t in fa.FLASH_TILES}
            reread()
            if fa.resolve_flash_tile(q.shape, q.dtype, causal, "high") != tuple(tile):
                raise AssertionError(f"{label}: a call does not take the saved tile {tile}")
            kernels_reset()
            o_t, lse_t = fa.flash_attention(q, k, v, causal=causal, precision="high",
                                            return_lse=True)
            o_d, lse_d = fa.flash_fwd_kernel(q, k, v, block_q=fa.FLASH_TILES[0][0], **kw)
            torch.cuda.synchronize()
            _add(total, _launches())
            same = torch.equal(o_t, o_d) and torch.equal(lse_t, lse_d)
            print(f"autotune {label}: candidates "
                  + ", ".join(f"{t} {ms:.4f} ms" for t, ms in times.items())
                  + f"; picked {tuple(tile)} at {secs * 1e3:.4f} ms (its chain); a call with no "
                  f"tile launches the saved one, o and lse "
                  f"{'bitwise equal to' if same else 'DIFFERENT from'} the default tile's",
                  flush=True)
            if not same:
                raise AssertionError(f"{label}: the saved tile's output differs")
            del q, k, v, o_t, o_d
        # the lookup's host cost: a saved tile for (4096, 4096, n), and none,
        # in turns (none, saved, saved, none): the host is shared and noisy,
        # so the lookup alone is the best of 5 runs of 20,000 calls
        m = k = 4096
        n = TUNE_HOST_N
        f32 = torch.float32
        a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).cuda()
        b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).cuda()
        path = os.environ["TPUSPARSE_TORCH_CALIBRATION"]
        tile, _ = gk.autotune_gemm(m, k, n, f32, repeats=1, save=False, verbose=False)

        def lookup_us():
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(20000):
                    gk.resolve_tile(m, k, n, f32, f32, None)
                best = min(best, (time.perf_counter() - t0) / 20000 * 1e6)
            return best

        runs = {False: [], True: []}
        for saved in (False, True, True, False):
            if os.path.exists(path):
                os.remove(path)
            if saved:
                calibrate.save_gemm_tile(gk._tile_key(m, k, n, "float32"), tile)
            reread()
            runs[saved].append((lookup_us(), host_us(lambda: gk.gemm_kernel(a, b))))
        look = {sv: min(r[0] for r in rs) for sv, rs in runs.items()}
        call = {sv: [round(r[1], 1) for r in rs] for sv, rs in runs.items()}
        print(f"autotune: the tile lookup {look[False]:.2f} us a call with no saved tile, "
              f"{look[True]:.2f} with one (limit {TUNE_LOOKUP_US}); gemm_kernel ({m}, {k}, {n}) "
              f"host us a call without a saved tile {call[False]}, with one {call[True]} "
              f"(in turns: none, saved, saved, none)")
        if max(look.values()) > TUNE_LOOKUP_US:
            raise AssertionError("the tile lookup adds more than 2 us a gemm_kernel call")
    finally:
        if old is None:
            os.environ.pop("TPUSPARSE_TORCH_CALIBRATION", None)
        else:
            os.environ["TPUSPARSE_TORCH_CALIBRATION"] = old
        reread()
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def run_phase(name, fn, *args):
    """fn(*args), with its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


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

    t_start = time.perf_counter()
    name = phase_device()
    run_phase("build", phase_build)
    run_phase("small block_ell_spmm", phase_small_cases)
    run_phase("small sddmm", phase_small_sddmm)
    run_phase("small gemm", phase_small_gemm)
    run_phase("small flash", phase_small_flash)
    run_phase("small block flash", phase_small_block_flash)
    run_phase("small int8", phase_small_int8)
    run_phase("small naive", phase_small_naive)
    run_phase("small wide attention", phase_small_wide_attention)
    run_phase("small batched and plan-variant spmm", phase_small_plan_executors)
    run_phase("small windowed", phase_small_windowed)
    run_phase("small dia", phase_small_dia)

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

    # the utils on the headline, before any phase runs torch.profiler: after
    # other sessions in the process, a later one recorded no kernel
    run_phase("utils", phase_utils, a, plan, bv, b)

    # -- the main path, counted: training and the headline backward -----------
    train_counts = run_phase("mlp training", phase_train, batches)
    bwd_counts, sddmm_err, dc, plan_t, bv_t = run_phase(
        "headline backward", phase_headline_backward, plan, bv, b)
    layer_counts = run_phase("bert layers", phase_bert_layers)
    enc_counts, enc, enc_ids = run_phase("bert encoder", phase_bert_encoder, "flash")
    flash_launches = {n: layer_counts[n] + enc_counts[n] for n in NO_FLASH}
    run_phase("bert card vs cpu", phase_bert_card_vs_cpu)
    blk_launches, bb_enc, bb_ids = run_phase("pattern paths", phase_pattern_paths)
    run_phase("bigbird card vs cpu", phase_bert_card_vs_cpu, "bigbird", 512)
    run_phase("sparse card vs cpu", phase_bert_card_vs_cpu, "sparse", 512, "blockflash")
    wide_bb = run_phase("wide bigbird attention", phase_wide_bigbird)
    int8_r = run_phase("int8 serving", phase_int8_serving, a, b, c)
    run_phase("gpt serving", phase_gpt_serving)
    cora = _graph_task(CORA, 30)
    graph = {f"{fam} cora": run_phase(f"{fam} cora", phase_graph_cora, fam, cora)
             for fam in ("gcn", "gat", "appnp")}
    graph["gcn arxiv"] = run_phase("gcn arxiv", phase_graph_arxiv, _graph_task(ARXIV, 40))
    route_counts = run_phase("spmm routes", phase_spmm_routes, graph["gcn cora"]["a"])
    graph_launches = {kn: route_counts[kn] + sum(r["launches"].get(kn, 0) for r in graph.values())
                      for kn in ("naive_spmm", "block_ell_spmm")}
    batched = run_phase("batched spmm", phase_batched_spmm)
    executors = run_phase("plan executors", phase_plan_executors, a, plan, bv, b)
    spgemm = run_phase("spgemm", phase_spgemm)
    amg = run_phase("amg laplace3d_64", phase_amg_laplace3d)
    calib_counts, fit = run_phase("calibrate", phase_calibrate, {
        "the headline (16384^2, 10 % of 128^2 blocks)": (a, n),
        "Cora's A-hat": (graph["gcn cora"]["a"], 64),
        "ogbn-arxiv's A-hat": (graph["gcn arxiv"]["a"], 256)}, amg["level1_route_args"])
    par_counts = run_phase("parallel", phase_parallel, a, plan, bv, b, batches, cora, fit)
    pm_counts = run_phase("parallel models", phase_parallel_models)
    rigl_counts = run_phase("rigl", phase_rigl, batches)
    patch_counts = run_phase("patched linear", phase_patched_linear)
    gpt_train = run_phase("gpt training", phase_gpt_training)
    slice_launches = {kn: calib_counts[kn] + rigl_counts[kn] + patch_counts[kn]
                      + gpt_train["launches"][kn] + par_counts.get(kn, 0)
                      + pm_counts.get(kn, 0) + wide_bb.get(kn, 0) for kn in NO_LAUNCH}

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
    bound_ms, bound_by, ffma_ms = bound_fp32(flops, nbytes)
    old = OLD_MS["block_ell_spmm headline"]
    print(f"headline: kernel {kernel_ms:.4f} ms (FFMA kernel before its redesign {old:.3f}: "
          f"{old / kernel_ms:.2f}x), plain {plain_ms:.4f} ms, "
          f"torch.matmul dense {library_ms:.4f} ms (vs kernel {lib_err:.2e}), "
          f"bound {bound_ms:.4f} ms by {bound_by} (3xTF32: 3 x {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB; FFMA design figure {ffma_ms:.4f} ms), "
          f"kernel at {flops / (kernel_ms * 1e-3) / 1e12:.2f} TFLOP/s, "
          f"{bound_ms / kernel_ms:.3f} of its bound")
    for tier, bvx, bx in (("fp32 'default'", bv, b),
                          ("bf16 operands", bv.bfloat16(), b.bfloat16())):
        prec = "default" if tier == "fp32 'default'" else "high"
        t_err = over_scale(resident_spmm_kernel(plan, bvx, bx, precision=prec),
                           _block_exec_plain(plan, bvx, bx, precision=prec))[1]
        t_ms = time_ms(lambda: resident_spmm_kernel(plan, bvx, bx, precision=prec))
        t_bound = bound(flops, nbytes * (0.5 if bvx.dtype == torch.bfloat16 else 1.0),
                        BF16_FLOPS)[0]
        print(f"headline {tier} (bf16 wgmma): kernel {t_ms:.4f} ms, vs plain over scale "
              f"{t_err:.3e}, bound {t_bound:.4f} ms ({flops / 1e9:.2f} GFLOP at 989 TFLOP/s "
              f"bf16), {t_bound / t_ms:.3f} of it")
        if not t_err <= (GEMM_BF16_OUT_TOL if bvx.dtype == torch.bfloat16 else GEMM_DEFAULT_TOL):
            raise AssertionError(f"headline {tier}: kernel disagrees with its plain version")
        del bvx, bx
    # dB = Aᵀ·dC on the transpose plan: the same kernel, transposed blocks
    dbt_ms = time_ms(lambda: resident_spmm_kernel(plan_t, bv_t, dc))
    dbt_plain_ms = time_ms(lambda: _block_exec_plain(plan_t, bv_t, dc))
    print(f"headline dB (transpose plan {plan_t.shape}, ell_width {plan_t.ell_width}): "
          f"kernel {dbt_ms:.4f} ms, plain {dbt_plain_ms:.4f} ms, same bound "
          f"{bound_ms:.4f} ms, kernel at {flops / (dbt_ms * 1e-3) / 1e12:.2f} TFLOP/s, "
          f"{bound_ms / dbt_ms:.3f} of its bound")
    del bv_t

    # -- timings: sddmm at the headline ----------------------------------------
    s_ms = time_ms(lambda: sddmm_kernel(plan, dc, b))
    s_plain_ms = time_ms(lambda: _sddmm_plain(plan, dc, b))
    bt = b.transpose(0, 1)
    with fp32_matmul():
        s_library_ms = time_ms(lambda: torch.matmul(dc, bt))
    s_flops = 2.0 * plan.nblocks * bm * bk * n
    s_bytes = 4.0 * (m * n + k * n + plan.num_slots * bm * bk)
    s_bound_ms, s_bound_by, s_ffma_ms = bound_fp32(s_flops, s_bytes)
    old = OLD_MS["sddmm headline"]
    print(f"headline sddmm: kernel {s_ms:.4f} ms (FFMA kernel before its redesign {old:.3f}: "
          f"{old / s_ms:.2f}x), plain {s_plain_ms:.4f} ms, "
          f"torch.matmul(dC, B^T) dense superset {s_library_ms:.4f} ms, bound "
          f"{s_bound_ms:.4f} ms by {s_bound_by} (3xTF32: 3 x {s_flops / 1e9:.2f} GFLOP, "
          f"{s_bytes / 1e6:.1f} MB; FFMA design figure {s_ffma_ms:.4f} ms), "
          f"kernel at {s_flops / (s_ms * 1e-3) / 1e12:.2f} TFLOP/s, "
          f"{s_bound_ms / s_ms:.3f} of its bound")
    del dc, bt

    # -- timings and check: gemm at 4096^3 --------------------------------------
    g = 4096
    rng = np.random.default_rng(5)
    ga = torch.from_numpy(rng.standard_normal((g, g), dtype=np.float32)).cuda()
    gb = torch.from_numpy(rng.standard_normal((g, g), dtype=np.float32)).cuda()
    gc = gemm_kernel(ga, gb, precision="high")
    g_err, g_rel = over_scale(gc, _gemm_plain(ga, gb, precision="high"))
    gd_want = _gemm_plain(ga, gb, precision="default")
    gd_err, gd_rel = over_scale(gemm_kernel(ga, gb, precision="default"), gd_want)
    # what a 'default' kernel that left its operands unrounded would read
    unrounded_rel = over_scale(gc, gd_want)[1]
    print(f"gemm {g}^3: 'high' max_abs_err {g_err:.3e}, over scale {g_rel:.3e} (limit "
          f"{HEADLINE_TOL}); 'default' max_abs_err {gd_err:.3e}, over scale {gd_rel:.3e} "
          f"(limit {GEMM_DEFAULT_TOL}; the unrounded 'high' product against the 'default' "
          f"plain version {unrounded_rel:.3e})")
    if not (g_rel <= HEADLINE_TOL and gd_rel <= GEMM_DEFAULT_TOL
            and bool(torch.isfinite(gc).all())):
        raise AssertionError("gemm disagrees with its plain version at 4096^3")
    del gc, gd_want
    gm_ms = time_ms(lambda: gemm_kernel(ga, gb, precision="high"))
    gm_plain_ms = time_ms(lambda: _gemm_plain(ga, gb, precision="high"))
    with fp32_matmul():
        gm_library_ms = time_ms(lambda: torch.matmul(ga, gb))
    gm_flops = 2.0 * g ** 3
    # each tier on the tensor-core rate it uses: 3xTF32 three tf32 passes
    gm_bound_ms, gm_bound_by = bound(3 * gm_flops, 4.0 * 3 * g * g, peak=TF32_FLOPS)
    print(f"gemm {g}^3 fp32 'high' (3xTF32 wgmma): kernel {gm_ms:.4f} ms (FFMA kernel before "
          f"this slice {OLD_MS['gemm 4096^3 high']:.3f}: {OLD_MS['gemm 4096^3 high'] / gm_ms:.2f}x)"
          f", plain {gm_plain_ms:.4f} ms, torch.matmul (TF32 off; the plain version's own "
          f"call) {gm_library_ms:.4f} ms, bound {gm_bound_ms:.4f} ms (3 x {gm_flops / 1e9:.1f} "
          f"GFLOP at 495 TFLOP/s tf32), kernel at {gm_flops / (gm_ms * 1e-3) / 1e12:.2f} "
          f"TFLOP/s, {gm_bound_ms / gm_ms:.3f} of its bound")
    gd_ms = time_ms(lambda: gemm_kernel(ga, gb, precision="default"))
    ab, bb16 = ga.bfloat16(), gb.bfloat16()
    gd_library_ms = time_ms(lambda: torch.matmul(ab, bb16))
    gbf = gemm_kernel(ab, bb16)
    gbf_err, gbf_rel = over_scale(gbf, _gemm_plain(ab, bb16))
    print(f"gemm {g}^3 bf16 operands, C in bf16: max_abs_err {gbf_err:.3e}, over scale "
          f"{gbf_rel:.3e} (limit {GEMM_BF16_OUT_TOL})")
    if not (gbf.dtype == torch.bfloat16 and gbf_rel <= GEMM_BF16_OUT_TOL
            and bool(torch.isfinite(gbf).all())):
        raise AssertionError("gemm of bf16 operands disagrees with its plain version at 4096^3")
    del gbf
    gbf_ms = time_ms(lambda: gemm_kernel(ab, bb16))
    gd_bound_ms, gd_bound_by = bound(gm_flops, 4.0 * 3 * g * g, peak=BF16_FLOPS)
    print(f"gemm {g}^3 fp32 'default' (bf16 wgmma): kernel {gd_ms:.4f} ms, torch.matmul of the "
          f"bf16-rounded operands {gd_library_ms:.4f} ms, bound {gd_bound_ms:.4f} ms by "
          f"{gd_bound_by} ({gm_flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16), "
          f"{gd_bound_ms / gd_ms:.3f} of it; bf16 operands: kernel {gbf_ms:.4f} ms")
    del ga, gb, ab, bb16

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
            ms_ahead = time_ms_ahead(lambda: resident_spmm_kernel(lplan, lbv, lb))
            gy = torch.ones((lplan.shape[0], lb.shape[1]), device="cuda")
            sms = time_ms(lambda: sddmm_kernel(lplan, gy, lb), warmup=5, iters=50)
            sms_ahead = time_ms_ahead(lambda: sddmm_kernel(lplan, gy, lb))
            lbm, lbk = lplan.blocksize
            lm, lk, ln = lplan.shape[0], lplan.shape[1], lb.shape[1]
            lflops = 2.0 * lplan.nblocks * lbm * lbk * ln
            lbound = bound_fp32(lflops, 4.0 * (lplan.nblocks * lbm * lbk + lk * ln + lm * ln))[0]
            print(f"mlp sparse fc{i}: kernel alone {ms:.4f} ms, {ms_ahead:.4f} ms behind a "
                  f"sleep ({lm}x{lk} @ {lk}x{ln}, {lplan.nblocks} blocks; bound {lbound:.4f} ms "
                  f"on 3xTF32); its sddmm (dW) alone {sms:.4f} ms, {sms_ahead:.4f} ms behind a "
                  f"sleep (the same bound)")
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
    flash_t = run_phase("flash timings", phase_flash_timings)
    blk_t = run_phase("block flash timings", phase_block_flash_timings)
    run_phase("bert timings", phase_bert_timings,
              {"flash": (enc, enc_ids), "bigbird": (bb_enc, bb_ids)})
    del enc, enc_ids, bb_enc, bb_ids
    run_phase("bert profile", phase_bert_profile)
    int8_rows = run_phase("int8 timings", phase_int8_timings, int8_r, plan, bv, b)
    naive_row = run_phase("naive timings", phase_naive_timings, graph["gcn arxiv"]["a"])
    run_phase("graph step timings", phase_graph_step_timings, graph)
    del graph
    run_phase("wide attention timings", phase_wide_timings)
    example_counts = run_phase("examples", phase_examples)
    tune_counts = run_phase("autotune", phase_autotune)

    kernels = [
        {
            "name": "block_ell_spmm",
            "route": "cuda",
            "source": "tpusparse_torch/csrc/block_ell_spmm.cu",
            "replaces": "tpusparse/kernels/tiled_spmm.py:43 (_executor_kernel); "
                        "tpusparse/kernels/tiled_spmm.py:210 (_resident_kernel)",
            "launches": fwd_launches + train_counts["block_ell_spmm"]
            + bwd_counts["block_ell_spmm"] + graph_launches["block_ell_spmm"]
            + batched["launches"]["block_ell_spmm"] + executors["launches"]["block_ell_spmm"],
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
            "launches": train_counts["sddmm"] + bwd_counts["sddmm"]
            + batched["launches"]["sddmm"] + executors["launches"]["sddmm"],
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
    # SDPA's autograd backward behind a sleep: queued from the host, it can
    # take longer to enqueue than to run
    flash_rows = (
        ("flash_fwd", "fwd", "53 (_flash_kernel)", ft["err"]["o"][0], ft["sdpa_fwd_ms"]),
        ("flash_dq", "dq", "495 (_flash_dq_kernel; pallas_call l.684)", ft["err"]["dq"][0],
         ft["sdpa_bwd_ahead_ms"]),
        ("flash_dkv", "dkv", "538 (_flash_dkv_kernel; pallas_call l.704)",
         max(ft["err"]["dk"][0], ft["err"]["dv"][0]), ft["sdpa_bwd_ahead_ms"]),
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
         bt["err"]["dq"][0], bt["sdpa_bwd_ahead_ms"]),
        ("blk_flash_dkv", "dkv",
         "1175 (_blk_dkv_kernel, _blk_dkv_mask l.1215; pallas_call l.1339)",
         max(bt["err"]["dk"][0], bt["err"]["dv"][0]), bt["sdpa_bwd_ahead_ms"]),
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
    kernels.extend(int8_rows)
    kernels.append({**naive_row, "launches": graph_launches["naive_spmm"]})
    kernels.append({**batched["row"],
                    "launches": batched["launches"]["resident_spmm_batched"]})
    kernels.extend({**executors["rows"][e], "launches": executors["launches"][e]}
                   for e in PLAN_EXECUTORS)
    kernels.extend({**spgemm["rows"][e],
                    "launches": spgemm["launches"][e] + amg["launches"][e]}
                   for e in ("windowed_gather", "windowed_segsum"))
    kernels.extend({**amg["rows"][e], "launches": amg["launches"][e]}
                   for e in ("dia_spmv", "dia_nonfinite"))
    # the launches of the calibrate, parallel, rigl, patch, gpt training,
    # examples and autotune phases
    for row in kernels:
        row["launches"] += (slice_launches.get(row["name"], 0)
                            + example_counts.get(row["name"], 0) + tune_counts.get(row["name"], 0))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
