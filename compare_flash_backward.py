#!/usr/bin/env python3
"""Time one tree of tpusparse_torch's attention backward on the card, so
two trees can be compared on one card in turns.

    python3 compare_flash_backward.py TREE

TREE is a directory that holds a `tpusparse_torch/` package (the repo
root, or an older tree unpacked with `git archive <rev> tpusparse_torch`
into a directory that .gitignore lists). Its package is imported first; the
timing helpers come from this directory's chip_smoke.py. Prints flash_dq and
flash_dkv at the BERT-base shapes (bh 96 at seq 512 and 128, bh 24 at seq
4096, head dim 64) in fp32 'high', fp32 'default' and on bf16 operands, and
blk_flash_dq and blk_flash_dkv at the 'bigbird' shape (bh 96, seq 512,
block 64) in the same three tiers, each by `chip_smoke.time_ms_queued`; then
the BERT-base 'flash' layer's training step at batch 8, seq 512 and batch
2, seq 4096, and the 'bigbird' layer's at batch 8, seq 512 (5 steps
between events). Run it once a tree in a separate process, in the order A,
B, B, A."""
import os
import sys

if __name__ == "__main__":
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import tpusparse_torch as tt
    from tpusparse_torch.kernels import block_flash_attention as bfa
    from tpusparse_torch.kernels import flash_attention as fa

    if not tt.__file__.startswith(tree):
        raise SystemExit(f"tpusparse_torch came from {tt.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
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
            print(f"{sys.argv[1]} {shape} {str(dtype)[6:]} {prec}: dq {dq:.4f} ms, dkv "
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
        print(f"{sys.argv[1]} bigbird_512 (96, 512, 64) {str(dtype)[6:]} {prec}: blk dq "
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
        print(f"{sys.argv[1]} bert layer {attention} seq {seq} batch {batch}: train step "
              f"{ms:.4f} ms queued", flush=True)
        del x, layer, opt
