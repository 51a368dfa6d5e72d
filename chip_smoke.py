#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

    python3 chip_smoke.py            # needs one CUDA device and nvcc
    python3 chip_smoke.py --profile  # also: device time of one served
                                     # micro-batch, of one BERT and one
                                     # LSTM LM train step (device shares
                                     # by kernel family), and of one
                                     # bucket-8 decode step
    python3 chip_smoke.py --ptxas    # also: nvcc's register and spill
                                     # report of every kernel
    python3 chip_smoke.py --zero-train  # phases 1, 2 and 11 alone, on
                                        # two or more cards
    python3 chip_smoke.py --compare DIR  # A/B on one card: the flash
        # forward, the long-sequence flash backward (dq, dkv), the
        # recurrence kernels and the decode step of the
        # checkout at DIR (e.g. the parent commit unpacked by `git archive`
        # under build/) and of this one, timed in turns (DIR, this, this,
        # DIR), with what each wrapper does at shapes the first versions
        # refused

Phases, each of which fails the run (non-zero exit) when it fails:

1. print the card's name and power limit, the torch and CUDA versions,
   and turn TF32 off for float32 products and convolutions;
2. build the CUDA kernel library from ``mxnet_tpu_torch/ops/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, with the tolerance printed beside the error, and
   time the kernel, the plain version and one PyTorch library call that
   computes the same function at the shapes of its path, in both dtypes
   (the backward kernels at BERT-base training's B*H = 384, S = 512,
   D = 64, at the long-sequence phase's S = 1024, and LayerNorm at
   16384 x 768; the flash forward's tile edges too: one position at D 1,
   Sq and Sk no multiple of a tile, causal with Sq < Sk and Sq > Sk, D 7,
   32, 80 and 128, S 512 causal and S 1024, each run twice to show it
   repeats bit for bit, and it is timed at BERT training's S 512 as well;
   the fused backward's tile edges: one position at D 1, one key, one
   query, D 128 causal at 512, 449 keys; the dq and dkv kernels' edges
   past 512: Sq = Sk = 513, Sq 1,030 x Sk 600 causal, Sq 1 x Sk 1,030
   causal, D 1, 7 and 80, D 128 causal at 1,024, each run twice to show
   dq, dk and dv repeat bit for bit, with the kernels' plans; every case
   launches one fused kernel, or one dq and one dkv and no fused one);
   the recurrence kernels in every mode (LSTM, GRU, tanh and relu RNN),
   forward and reverse, at T 7 x N 3 x H 37, N 1, N 130, H 129, at T 3 x
   N 300 x H 1,024 (and H 1,500 for the one-gate modes), where the
   backward's walk must read W_hh through L2, and the LSTM LM's T 35 x N
   64 x H 650, where the forward keeps W_hh's rows in shared memory
   (every output and gradient compared, timed at the LM's LSTM layer,
   with the host time of the walk's plan; each check prints both plans),
   and LSTM at T 3 x N 64 x H 4,096 (the forward reads W_hh through L2,
   several tiles a block) and T 2 x N 512 x H 4,096 (several walk tiles a
   block), shapes the first versions refused; the bias-GELU backward at
   4096 x 3072 and at an unaligned C, and the decode step (``rnn_decode``)
   in every mode at N 3 x H 37, N 128 x H 650 (two row groups), N 8 x H
   650 and N 8 x H 128, float32 and
   bfloat16, plus 35 chained decode steps against the ``rnn_scan_fwd``
   kernel's trajectory at N 8 x H 650 (within 1e-6); and the fused
   optimizer update (``opt_update``) for SGD, SGD-momentum and Adam, clip
   on and off, scalar and per-element hyperparameters, float32 and
   bfloat16, at 5000 elements, at BERT-base's word-embedding shard at dp 4
   (5,860,224) and at its bucket unit (88,322): float32 states bit-exact
   and weights within 1 ulp, bfloat16 within 2e-2; the Adam update of the
   word-embedding shard timed beside ``torch._fused_adam_`` in float32
   and bfloat16;
4. serve BERT-base (12 x 768, vocab 30522, seeded random weights) through
   ``CompiledPredictor`` + ``DynamicBatcher``: 8 client threads, 96
   requests of 1-8 rows at sequence length 128; check that every request
   resolved, that two requests match a CPU copy of the model, and that
   each micro-batch launched 12 flash and 25 LayerNorm kernels;
5. run a 2-layer ``TransformerEncoder`` with the ``gelu`` FFN, so the
   bias-GELU kernels launch: a forward checked against a CPU copy, and a
   backward (exactly 2 ``bias_gelu_bwd`` launches) with the gradients of
   every parameter against the CPU copy;
6. train the BERT-base classifier (float32, dropout 0.1, batch 32 x
   sequence 512, Adam) for ten steps of ``Trainer.compile_step`` on one
   seeded batch: every loss finite and the last below the first, exactly
   12 flash forward, 12 fused flash backward, 25 LayerNorm forward and 25
   LayerNorm backward launches per step, and one step's gradients of
   every parameter (batch 2 x 128, dropout off) against a CPU copy;
7. train a 2-layer BERT-width classifier at sequence 1024 for two steps,
   so the flash backward takes its dq and dkv kernels (two launches each
   per step, none of the fused one), with its gradients against a CPU
   copy;
8. train the LSTM word LM (``model_zoo.word_lm.WordLM``: vocab 33,278,
   embed and hidden 650, 2 layers, float32) at batch 64 x bptt 35 for ten
   SGD-momentum steps of ``Trainer.compile_step`` on one seeded batch:
   every loss finite and the last below the first, exactly 2
   ``rnn_scan_fwd`` and 2 ``rnn_scan_bwd`` launches per step, one step's
   gradients of all 11 parameters at batch 4 against a CPU copy; then an
   eval-mode forward of the batch (``lstm_forward`` line) against the
   CPU copy;
9. serve autoregressive decode through ``serving.run_decode`` (the
   continuous-batching ``DecodeEngine``, slot ladder 1-8, page size 16,
   prefill chunk 16) over the JAX package's decode mix (32 requests from
   RandomState(7)): ``decode_leg`` at ``TinyDecoder(256, 128, 4)``
   continuous, static, the speculative A/B (spec_k 4 with prefix sharing
   against plain greedy, 16 requests over a shared base) and the GQA
   decoder on 8 requests; ``decode_wide`` at the word LM's widths
   (vocab 33,278, d_model 650, 10 heads), continuous. Every run's tokens
   equal a CPU copy's, continuous = static and speculative = greedy
   request by request, 0 errors, and ``rnn_decode`` launches exactly
   one a decode step (spec_k + 1 a verify step) plus 16 a prefill chunk
   (0 for the GQA decoder);
10. BERT-base's ZeRO-1 update layout on this card: one backward at batch
    32 x sequence 512 (dropout 0) gives fixed gradients; the port's
    ``_ZeroShardPlan`` at 4 shards (88 units); ten Adam updates (lr 1e-5)
    through ``Optimizer.kernel_step_fn()`` on every shard of every unit
    in turn, reassembled, against ten eager ``trainer.step`` updates of a
    copy (weights within 1e-6 relative + 1e-7 absolute), exactly 88 x 4 x
    10 ``opt_update`` launches, and the state bytes a rank would hold;
11. with two or more cards only (one line says so otherwise): BERT-base
    ZeRO-1 training, one rank a card over NCCL (``parallel.dist.spawn``),
    batch 32 x 512 global, ten Adam steps through ``TrainLoop`` under
    ``make_mesh({"dp": world})``: the sharded update on, falling finite
    losses, bit-equal weights on every rank, 88 ``opt_update`` launches a
    rank a step, the first losses equal a one-card forward's within 1e-5,
    the Adam state a rank ~1/world; step ms, global tokens/s, peak memory;
    then one eager step on each rank's rows (``loss.backward()``,
    ``Trainer.allreduce_grads()`` over NCCL, ``Trainer.update``): every
    reduced gradient against rank 0's backward of the whole batch (as
    phase 6's gradient check bounds it) and bit-equal weights after.

``{"launch_counts": {...}}`` gives each kernel's launches on its path.
The line before the last is a JSON object with one entry per kernel
(launches on its path, error, times, bound, all at float32, the dtype of
every path here; ``rnn_decode`` at decode_wide's N 8 x H 650,
``opt_update`` at the word-embedding shard); the last
line is ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

#: published peaks of one H100 SXM (dense): HBM bytes/s, and flop/s for
#: float32 on CUDA cores and bfloat16 on tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

SERVE_SEQ = 128
SERVE_REQUESTS = 96
SERVE_CLIENTS = 8
SERVE_MAX_BATCH = 32
#: the phase-5 encoder: BERT-base's layer widths, FFN activation "gelu"
ENC_LAYERS, ENC_UNITS, ENC_HIDDEN, ENC_HEADS = 2, 768, 3072, 12
#: float32 logits, GPU vs CPU copy: twelve layers of float32 sums taken in
#: another order (cuBLAS vs a float64-accumulated CPU product, the kernels
#: vs their plain versions); on an H100 the differences are ~1e-6
LOGIT_ATOL = 2e-4
#: phase 6: the JAX package's BERT training leg (bench.py bench_bert):
#: batch 32 x sequence 512, Adam; ten steps on one seeded batch. From
#: random weights without warmup, Adam at 1e-4 overshoots (the second
#: loss jumps to ~2) and the ten losses end near the first; at 1e-5 they
#: fall step by step
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 32, 512, 10, 1e-5
#: the gradient check of phase 6 runs at this batch x sequence
GRAD_BATCH, GRAD_SEQ = 2, 128
#: phase 7: BERT-base widths, 2 layers, sequence 1024 (past the fused
#: backward's 512), two steps
LONG_LAYERS, LONG_BATCH, LONG_SEQ, LONG_STEPS = 2, 2, 1024, 2
#: float32 gradients, GPU vs CPU copy, per parameter: max |difference| <=
#: GRAD_ATOL + GRAD_RTOL * max |CPU gradient|. The scale is the
#: parameter's largest gradient, not each element's: key_proj.bias has a
#: zero gradient in exact arithmetic (softmax ignores a per-row shift), so
#: both sides hold rounding noise there, ~1e-9
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, arg_sets, iters=30, replays=5):
    """(device ms, eager ms) per call of ``fn``, cycling through
    ``arg_sets`` (together larger than the 50 MB L2, so each call finds
    its inputs cold), timed with CUDA events after a warm-up.

    Device ms: the ``iters`` calls captured once in a CUDA graph and the
    graph replayed, so the host's per-call work (argument checks, the
    ``ctypes`` call) is out of the timing. Eager ms: the same calls made
    one by one from Python; it exceeds the device ms where the host's work
    per call outlasts the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / (replays * iters)
    del graph
    return device, eager


def n_sets(torch, tensors):
    """How many copies of a call's tensors exceed the L2 twice over."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return max(1, math.ceil(100e6 / max(nbytes, 1)))


def compare(torch, got, ref, atol, rtol):
    """(ok, max abs error, relative error) of ``got`` against ``ref``: ok
    when every element is finite and within atol + rtol * |ref|; the
    relative error is the max abs error over the max |ref|."""
    err = (got.float() - ref.float()).abs()
    mag = ref.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and \
        bool((err <= atol + rtol * mag).all())
    if not err.numel():
        return ok, 0.0, 0.0
    return ok, float(err.max()), float(err.max() / mag.max().clamp_min(1e-30))


#: per-dtype (atol, rtol) of a kernel against its plain version on the
#: card: float32 sums in another order and the CUDA math library's
#: expf/erfcf/rsqrtf (~1e-6 observed); bfloat16 one or two ulps of an O(1)
#: output (2**-8 = 0.0039 per ulp)
TOLS = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
#: flash-attention cases (B, H, Sq, Sk, D, causal); the first two are the
#: served shapes of buckets 8 and 32, the last BERT training's (timed too)
FLASH_CASES = [
    (8, 12, 128, 128, 64, False),
    (32, 12, 128, 128, 64, False),
    (2, 4, 100, 164, 64, True),      # causal, Sq != Sk
    (2, 4, 100, 40, 64, True),       # rows 0..59 see no valid key
    (2, 3, 70, 70, 80, False),       # D not a power of two
    (2, 2, 33, 130, 32, True),
    # the tiles' edges: one position at D 1, Sq and Sk no multiple of a
    # tile, causal with Sq < Sk and Sq > Sk, D 7 (no 16-byte rows), D 128,
    # S 512 causal and S 1024
    (2, 3, 1, 1, 1, False),
    (1, 2, 77, 93, 32, True),
    (1, 2, 150, 70, 128, True),
    (1, 3, 65, 129, 7, False),
    (1, 2, 200, 130, 128, False),
    (1, 12, 512, 512, 64, True),
    (1, 4, 1024, 1024, 64, False),
    (32, 12, 512, 512, 64, False),
]
#: the flash forward's shapes timed: served (bucket 32) and BERT training
FLASH_SERVED, FLASH_TRAIN = (32, 128), (32, 512)
#: (rows, C) of the LayerNorm and bias-GELU checks; the first is served
LN_CASES = ((4096, 768), (37, 50))
BG_CASES = ((4096, 3072), (37, 50))


def check_kernels(torch, ATT, KN, dev):
    """Phase 3: every kernel against its plain version, in float32 and
    bfloat16. Returns {(kernel, dtype): (record, args)} of the served
    shapes, for :func:`time_kernels`."""
    g = torch.Generator(device=dev).manual_seed(0)
    failures, served = [], {}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def record(rec, args, key):
        emit({"check": rec})
        if not rec["ok"]:
            failures.append(rec)
        if key:
            served[(key, rec["dtype"])] = (rec, args)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        atol, rtol = TOLS[dn]
        for b, h, sq, sk, d, causal in FLASH_CASES:
            q, k, v = rnd(b, h, sq, d, dtype=dtype), \
                rnd(b, h, sk, d, dtype=dtype), rnd(b, h, sk, d, dtype=dtype)
            out, lse = ATT.flash_attention_fwd(q, k, v, causal)
            again = ATT.flash_attention_fwd(q, k, v, causal)
            torch.cuda.synchronize()
            repeats = bool(torch.equal(out, again[0])) and \
                bool(torch.equal(lse, again[1]))
            del again
            rout, rlse = ATT.flash_attention_fwd_plain(q, k, v, causal)
            ok1, e1, r1 = compare(torch, out, rout, atol, rtol)
            ok2, e2, _ = compare(torch, lse, rlse, 1e-4, 1e-5)
            key = None
            if not causal and sq == sk:
                key = {FLASH_SERVED: "flash_fwd",
                       FLASH_TRAIN: "flash_fwd@train"}.get((b, sq))
            record({"kernel": "flash_fwd", "dtype": dn,
                    "shape": [b, h, sq, sk, d], "causal": causal,
                    "max_abs_err": e1, "rel_err": r1, "lse_max_abs_err": e2,
                    "atol": atol, "rtol": rtol, "lse_atol": 1e-4,
                    "repeats_bit_for_bit": repeats,
                    "ok": ok1 and ok2 and repeats}, (q, k, v), key)

        for rows, c in LN_CASES:
            x = rnd(rows, c, dtype=dtype)
            gam, bet = rnd(c, dtype=torch.float32), rnd(c, dtype=torch.float32)
            y = KN.layer_norm(x, gam, bet, 1e-5)
            torch.cuda.synchronize()
            ok, e, r = compare(torch, y, KN.layer_norm_plain(x, gam, bet),
                               atol, rtol)
            record({"kernel": "layernorm_fwd", "dtype": dn,
                    "shape": [rows, c], "max_abs_err": e, "rel_err": r,
                    "atol": atol, "rtol": rtol, "ok": ok},
                   (x, gam, bet),
                   "layernorm_fwd" if (rows, c) == LN_CASES[0] else None)

        for rows, c in BG_CASES:
            x, bias = rnd(rows, c, dtype=dtype), rnd(c, dtype=dtype)
            y = KN.bias_gelu(x, bias)
            torch.cuda.synchronize()
            ok, e, r = compare(torch, y, KN.bias_gelu_plain(x, bias),
                               atol, rtol)
            record({"kernel": "bias_gelu_fwd", "dtype": dn,
                    "shape": [rows, c], "max_abs_err": e, "rel_err": r,
                    "atol": atol, "rtol": rtol, "ok": ok},
                   (x, bias),
                   "bias_gelu_fwd" if (rows, c) == BG_CASES[0] else None)
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")
    return served


def time_kernels(torch, F, ATT, KN, served):
    """Kernel, plain-version and library-call times (device and eager,
    :func:`time_ms`) at the served shapes (bucket 32, sequence 128), and
    the flash forward also at BERT training's (batch 32, sequence 512;
    key ``flash_fwd@train``), in each dtype, with the bound of this call's
    work. Returns {(kernel, dtype): timing}."""
    timing = {}
    for (key, dn), (rec, args) in served.items():
        name = key.split("@")[0]
        size = args[0].element_size()
        if name == "flash_fwd":
            q, k, v = args
            b, h, sq, d = q.shape
            sk = k.shape[2]
            sets = [tuple(t.clone() for t in args)
                    for _ in range(n_sets(torch, (q, k, v, q)))]
            # q, k, v read; out written in the input dtype, lse in float32
            nbytes = size * (2 * q.numel() + k.numel() + v.numel()) \
                + 4 * b * h * sq
            flops = 4.0 * b * h * sq * sk * d          # QK^T and PV
            fns = (lambda *a: ATT.flash_attention_fwd(*a),
                   lambda *a: ATT.flash_attention_fwd_plain(*a),
                   lambda *a: F.scaled_dot_product_attention(*a))
        elif name == "layernorm_fwd":
            x, gam, bet = args
            c = x.shape[-1]
            sets = [(x.clone(), gam, bet) for _ in range(n_sets(torch, (x, x)))]
            nbytes = size * 2 * x.numel() + 4 * 2 * c
            flops = 8.0 * x.numel()       # mean, deviation², scale, shift
            fns = (lambda *a: KN.layer_norm(*a),
                   lambda *a: KN.layer_norm_plain(*a),
                   lambda x_, g_, b_: F.layer_norm(
                       x_, (x_.shape[-1],), g_.to(x_.dtype), b_.to(x_.dtype),
                       1e-5))
        else:
            x, bias = args
            c = x.shape[-1]
            sets = [(x.clone(), bias) for _ in range(n_sets(torch, (x, x)))]
            nbytes = size * (2 * x.numel() + c)
            flops = 20.0 * x.numel()      # add, erfc (~15), three products
            fns = (lambda *a: KN.bias_gelu(*a),
                   lambda *a: KN.bias_gelu_plain(*a),
                   lambda x_, b_: F.gelu(x_ + b_))
        (ms, eager_ms), (plain_ms, plain_eager_ms), \
            (library_ms, library_eager_ms) = (time_ms(torch, fn, sets)
                                              for fn in fns)
        b_ms, b_by = bound_ms(nbytes, flops, dn)
        t = {"kernel": name, "dtype": dn, "shape": rec["shape"],
             "max_abs_err": rec["max_abs_err"], "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": b_ms, "bound_by": b_by,
             "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
             "library_eager_ms": library_eager_ms,
             "bytes": nbytes, "flops": flops}
        emit({"timing": t})
        timing[(key, dn)] = t
    return timing


#: flash backward cases (B, H, Sq, Sk, D, causal): the first is BERT-base
#: training's (B*H = 384), the sixth phase 7's (dq and dkv kernels)
FLASH_BWD_CASES = [
    (32, 12, 512, 512, 64, False),
    (32, 12, 512, 512, 64, True),
    (2, 4, 100, 164, 64, True),      # causal, Sq < Sk
    (2, 4, 100, 40, 64, True),       # rows 0..59 see no valid key
    (2, 3, 70, 70, 80, False),       # D not a power of two
    (LONG_BATCH, 12, LONG_SEQ, LONG_SEQ, 64, False),
    (LONG_BATCH, 12, LONG_SEQ, LONG_SEQ, 64, True),
    # the fused kernel's tile edges: one position at D = 1, one key, one
    # query, D = 128 causal at 512, a ragged key count
    (2, 3, 1, 1, 1, False),
    (2, 3, 77, 1, 64, True),
    (2, 3, 1, 130, 32, True),
    (2, 12, 512, 512, 128, True),
    (2, 3, 300, 449, 64, False),
    # the dq/dkv kernels' tile edges, all past 512 positions: one ragged
    # tile, rows that see no key, one query, D 1, D 7 (no 16-byte rows),
    # D 80, D 128 causal at 1024
    (2, 3, 513, 513, 64, False),
    (2, 3, 1030, 600, 64, True),
    (2, 3, 1, 1030, 64, True),
    (2, 3, 600, 600, 1, False),
    (2, 3, 600, 600, 7, False),
    (2, 3, 600, 600, 80, False),
    (2, 3, 1024, 1024, 128, True),
]
#: (rows, C) of the LayerNorm backward: training's 32 x 512 tokens, and
#: a C that takes the scalar (unaligned) path
LN_BWD_CASES = ((TRAIN_BATCH * TRAIN_SEQ, 768), (4099, 771))


def check_bwd_kernels(torch, ATT, K, KN, dev):
    """Phase 3, backward: the flash backward (through its dispatching
    wrapper: exactly one launch of the fused kernel, or one each of dq and
    dkv and none of the fused) and the LayerNorm backward against their
    plain versions, in float32 and bfloat16; past 512 positions the
    backward runs twice and must repeat bit for bit, and the record
    carries the dq and dkv kernels' plans. Returns {(kernel, dtype):
    (record, args)} at the shapes of the training paths, for
    :func:`time_bwd_kernels`."""
    g = torch.Generator(device=dev).manual_seed(1)
    failures, timed = [], {}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def record(rec, args, is_timed):
        emit({"check": rec})
        if not rec["ok"]:
            failures.append(rec)
        if is_timed:
            timed[(rec["kernel"], rec["dtype"])] = (rec, args)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        atol, rtol = TOLS[dn]
        for i, (b, h, sq, sk, d, causal) in enumerate(FLASH_BWD_CASES):
            q, k, v = rnd(b, h, sq, d, dtype=dtype), \
                rnd(b, h, sk, d, dtype=dtype), rnd(b, h, sk, d, dtype=dtype)
            do = rnd(b, h, sq, d, dtype=dtype)
            out, lse = ATT.flash_attention_fwd(q, k, v, causal)
            fused = ATT.uses_fused_bwd(sq, sk)
            K.reset_launch_counts()
            got = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
            torch.cuda.synchronize()
            n = K.launch_counts()
            launched = {name: n[name] for name in
                        ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")}
            launches_ok = launched == {"flash_bwd_fused": int(fused),
                                       "flash_bwd_dq": int(not fused),
                                       "flash_bwd_dkv": int(not fused)}
            ref = ATT.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                causal)
            res = [compare(torch, a, r, atol, rtol)
                   for a, r in zip(got, ref)]
            del ref
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, do, lse, delta, out)
            base = {"dtype": dn, "shape": [b, h, sq, sk, d],
                    "causal": causal, "atol": atol, "rtol": rtol,
                    "launches": launched}
            timed_case = i in (0, 5)
            if fused:
                record(dict(base, kernel="flash_bwd_fused",
                            max_abs_err=max(r[1] for r in res),
                            rel_err=max(r[2] for r in res),
                            ok=all(r[0] for r in res) and launches_ok), args,
                       timed_case)
                continue
            # no atomics: a second run gives dq, dk and dv bit for bit
            again = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
            torch.cuda.synchronize()
            repeats = [bool(torch.equal(a, r)) for a, r in zip(got, again)]
            del again
            for name, idx in (("flash_bwd_dq", (0,)),
                              ("flash_bwd_dkv", (1, 2))):
                record(dict(base, kernel=name,
                            max_abs_err=max(res[j][1] for j in idx),
                            rel_err=max(res[j][2] for j in idx),
                            repeats_bit_for_bit=all(repeats[j] for j in idx),
                            plan=ATT.flash_bwd_plan(name, b * h, sq, sk, d,
                                                    dtype, dev),
                            ok=all(res[j][0] and repeats[j] for j in idx)
                            and launches_ok), args, timed_case)

        for rows, c in LN_BWD_CASES:
            x, dy = rnd(rows, c, dtype=dtype), rnd(rows, c, dtype=dtype)
            gam = rnd(c, dtype=torch.float32)
            got = KN.layer_norm_bwd(x, gam, dy)
            torch.cuda.synchronize()
            res = [compare(torch, a, r, atol, rtol) for a, r in
                   zip(got, KN.layer_norm_bwd_plain(x, gam, dy))]
            again = KN.layer_norm_bwd(x, gam, dy)
            repeats = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            record({"kernel": "layernorm_bwd", "dtype": dn, "shape": [rows, c],
                    "max_abs_err": max(r[1] for r in res),
                    "rel_err": max(r[2] for r in res), "atol": atol,
                    "rtol": rtol, "repeats_bit_for_bit": repeats,
                    "ok": all(r[0] for r in res) and repeats},
                   (x, gam, dy), (rows, c) == LN_BWD_CASES[0])
    if failures:
        raise SystemExit(f"backward kernel checks failed: {failures}")
    return timed


def causal_pairs(sq, sk, causal):
    """(query, key) pairs the attention computes: all, or under the
    end-aligned causal mask those with k <= q + (sk - sq)."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


def time_eager_ms(torch, fn, args, iters=20, warmup=3):
    """Device ms per call of ``fn(*args)`` timed with CUDA events around
    ``iters`` calls made one by one from Python (for library calls with
    autograd, which a CUDA graph does not capture simply)."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_bwd_ms(torch, F, q, k, v, do):
    """The library yardstick of a flash backward: SDPA forward+backward
    minus SDPA forward, each timed eagerly."""
    def fwd(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_)

    def fwd_bwd(q_, k_, v_, do_):
        leaves = [t.detach().requires_grad_() for t in (q_, k_, v_)]
        torch.autograd.grad(fwd(*leaves), leaves, do_)

    return (time_eager_ms(torch, fwd_bwd, (q, k, v, do))
            - time_eager_ms(torch, fwd, (q, k, v)))


def time_bwd_kernels(torch, F, ATT, KN, timed):
    """Kernel, plain-version and library times of the backward kernels at
    the shapes of the training paths, in each dtype, with the bound of
    this call's work (each input read once, each output written once).
    The kernel is called through its own wrapper with delta precomputed,
    as ``flash_attention_bwd`` calls it. Returns {(kernel, dtype):
    timing}."""
    timing = {}
    for (name, dn), (rec, args) in timed.items():
        size = args[0].element_size()
        if name == "layernorm_bwd":
            x, gam, dy = args
            rows, c = x.shape
            sets = [(x.clone(), gam, dy.clone())
                    for _ in range(n_sets(torch, (x, x, x)))]
            # x and dy read, dx written; gamma read, dgamma/dbeta written
            nbytes = size * 3 * x.numel() + 4 * 3 * c
            flops = 14.0 * x.numel()
            nat = torch.native_layer_norm(x, (c,), gam.to(x.dtype),
                                          torch.zeros_like(gam).to(x.dtype),
                                          1e-5)
            lib_args = (dy, x, [c], nat[1], nat[2], gam.to(x.dtype),
                        torch.zeros_like(gam).to(x.dtype), [True] * 3)
            fns = (lambda *a: KN.layer_norm_bwd(*a),
                   lambda *a: KN.layer_norm_bwd_plain(*a))
            library = "torch.ops.aten.native_layer_norm_backward"
            library_ms = time_ms(
                torch, lambda *a: torch.ops.aten.native_layer_norm_backward(
                    *a), [lib_args])[0]
        else:
            q, k, v, do, lse, delta, out = args
            b, h, sq, d = q.shape
            sk = k.shape[2]
            causal = rec["causal"]
            scale = 1.0 / math.sqrt(d)
            sets = [tuple(t.clone() for t in (q, k, v, do)) + (lse, delta)
                    for _ in range(n_sets(torch, (q, k, v, do, q, k, v)))]
            pairs = b * h * causal_pairs(sq, sk, causal)
            # products a kernel needs: QK^T and dO V^T rebuild P and dP;
            # then dS K (dq), P^T dO and dS^T Q (dk, dv)
            n_products = {"flash_bwd_fused": 5, "flash_bwd_dq": 3,
                          "flash_bwd_dkv": 4}[name]
            flops = 2.0 * d * pairs * n_products
            reads = size * (2 * q.numel() + k.numel() + v.numel()) \
                + 4 * 2 * b * h * sq                # q, dO, k, v; lse, delta
            writes = {"flash_bwd_fused": q.numel() + k.numel() + v.numel(),
                      "flash_bwd_dq": q.numel(),
                      "flash_bwd_dkv": k.numel() + v.numel()}[name] * size
            nbytes = reads + writes
            kern = {"flash_bwd_fused": ATT.flash_bwd_fused,
                    "flash_bwd_dq": ATT.flash_bwd_dq,
                    "flash_bwd_dkv": ATT.flash_bwd_dkv}[name]
            fns = (lambda *a, kern=kern: kern(*a, causal, scale),
                   lambda q_, k_, v_, do_, lse_, delta_:
                   ATT.flash_attention_bwd_plain(q_, k_, v_, out, lse_, do_,
                                                 causal, scale))
            if name == "flash_bwd_fused":
                library = "SDPA forward+backward minus SDPA forward (eager)"
                library_ms = sdpa_bwd_ms(torch, F, q, k, v, do)
            else:
                # no one library call computes dq alone or dk, dv alone;
                # the whole backward's yardstick is printed beside it
                library, library_ms = None, None
        (ms, eager_ms), (plain_ms, plain_eager_ms) = (
            time_ms(torch, fn, sets) for fn in fns)
        b_ms, b_by = bound_ms(nbytes, flops, dn)
        t = {"kernel": name, "dtype": dn, "shape": rec["shape"],
             "max_abs_err": rec["max_abs_err"], "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "library": library, "bound_ms": b_ms, "bound_by": b_by,
             "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
             "bytes": nbytes, "flops": flops}
        if name == "flash_bwd_dq":
            t["library_ms_whole_backward"] = sdpa_bwd_ms(torch, F, q, k, v,
                                                         do)
            t["library_whole_backward"] = \
                "SDPA forward+backward minus SDPA forward (eager): dq, dk, dv"
        emit({"timing": t})
        timing[(name, dn)] = t
    return timing


#: recurrence cases (T, N, H): a ragged small one, one batch row, 130
#: rows (more than one block's rows), H 129 (ragged unit tiles), and the
#: LSTM LM's (bptt 35, batch 64, hidden 650), which is timed; every mode,
#: forward and reverse
RNN_TIMED = (35, 64, 650)
#: (T, N, H) per mode where the forward runs but no tile with W_hh's
#: column slice in shared memory keeps the backward walk's grid resident:
#: the walk reads W_hh through L2 there
RNN_L2_CASES = {"lstm": (3, 300, 1024), "gru": (3, 300, 1024),
                "rnn_tanh": (3, 300, 1500), "rnn_relu": (3, 300, 1500)}
RNN_CASES = ((7, 3, 37), (9, 1, 300), (5, 130, 200), (6, 17, 129),
             RNN_L2_CASES["lstm"], RNN_TIMED)
#: LSTM shapes the first versions refused ("too many blocks in cooperative
#: launch"): the forward at H 4,096, where the plan reads W_hh through L2
#: and a block takes several tiles a step; the walk at N 512 x H 4,096,
#: where a walk block takes several tiles a step. Forward only, T small
RNN_REFUSED = {"forward": (3, 64, 4096), "walk": (2, 512, 4096)}
RNN_MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
#: (rows, C) of the bias-GELU backward: the phase-5 encoder's FFN
#: (32 x 128 tokens x 3072), and an unaligned C
BG_BWD_CASES = ((4096, 3072), (37, 50))


def rnn_case(torch, K, KR, rnd, mode, n_t, n, h, rev):
    """One recurrence through ``rnn_scan`` (the kernels, forward and
    backward through autograd) and through the plain versions on the same
    card: (results, references, launches, inputs). Every output is
    compared: ys, h_T, c_T, dxw, dh0, dc0, dW, db."""
    lstm = mode == "lstm"
    g = KR.GATES[mode]
    xw, h0 = rnd(n_t, n, g * h, s=0.5), rnd(n, h, s=0.5)
    c0 = rnd(n, h, s=0.5) if lstm else None
    # W_hh of spectral radius ~0.5: a contracting recurrence, so that one
    # bfloat16 ulp of state does not grow over the steps
    w, b = rnd(g * h, h, s=0.5 * h ** -0.5), rnd(g * h, s=0.1)
    dys, dh_t = rnd(n_t, n, h, s=1.0), rnd(n, h, s=1.0)
    dc_t = rnd(n, h, s=1.0) if lstm else None
    names = ["xw", "h0"] + (["c0"] if lstm else []) + ["w_hh", "b_hh"]
    leaves = [t.detach().requires_grad_() for t in (xw, h0, c0, w, b)
              if t is not None]
    before = K.launch_counts()
    full = leaves[:2] + ([leaves[2]] if lstm else [None]) + leaves[-2:]
    ys, hy, cy = KR.rnn_scan(*full, mode, reverse=rev)
    grads = torch.autograd.grad([ys, hy] + ([cy] if lstm else []), leaves,
                                [dys, dh_t] + ([dc_t] if lstm else []))
    torch.cuda.synchronize()
    after = K.launch_counts()
    launched = {k: after[k] - before[k] for k in ("rnn_scan_fwd",
                                                  "rnn_scan_bwd")}
    flip = (lambda t: torch.flip(t, dims=(0,))) if rev else (lambda t: t)
    xs = flip(xw)
    ys_p, cs_p = KR.rnn_scan_plain(xs, h0, c0, w, b, mode)
    dys_s = flip(dys).clone()
    dys_s[-1] = dys_s[-1] + dh_t
    # the plain backward takes the kernel's own forward residuals (the
    # forward kernel again: it repeats bit for bit), so that a relu mask
    # or a bfloat16 state rounded the other way in the forward does not
    # count against the backward
    ys_k, cs_k = KR.rnn_scan_fwd(xs, h0, c0, w, b, mode)
    ref_g = KR.rnn_scan_bwd_plain(xs, h0, c0, w, b, ys_k, cs_k, dys_s, dc_t,
                                  mode)
    ys, hy = ys.detach(), hy.detach()
    cy = cy.detach() if lstm else None
    got = {"ys": ys, "h_T": hy}
    ref = {"ys": flip(ys_p), "h_T": ys_p[-1]}
    if lstm:
        got["c_T"], ref["c_T"] = cy, cs_p[-1]
    ref_grads = [flip(ref_g[0]), ref_g[1]] + ([ref_g[2]] if lstm else []) \
        + list(ref_g[3:])
    for nm, a, r in zip(names, grads, ref_grads):
        got["d" + nm], ref["d" + nm] = a, r
    return got, ref, launched, (xw, h0, c0, w, b, dys, dc_t)


def check_new_kernels(torch, K, KR, KN, dev):
    """Phase 3, this slice's kernels: the recurrence forward and backward
    (every mode, forward and reverse, a ragged shape and the LM's) and the
    bias-GELU backward against their plain versions on the card, in
    float32 and bfloat16. Returns {(kernel, dtype): (record, args)} at the
    shapes of their paths, for :func:`time_new_kernels`."""
    g = torch.Generator(device=dev).manual_seed(2)
    failures, timed = [], {}

    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape, s=1.0):
            return (torch.randn(*shape, generator=g, device=dev) * s).to(
                dtype)

        dn = str(dtype).replace("torch.", "")
        atol, rtol = TOLS[dn]
        cases = [(shape, mode, revs) for shape in RNN_CASES
                 for mode in RNN_MODES for revs in [(False, True)]]
        cases += [(shape, mode, (False, True))
                  for mode, shape in RNN_L2_CASES.items()
                  if shape not in RNN_CASES]
        cases += [(shape, "lstm", (False,)) for shape in RNN_REFUSED.values()]
        for (n_t, n, h), mode, revs in cases:
            for rev in revs:
                got, ref, launched, args = rnn_case(
                    torch, K, KR, rnd, mode, n_t, n, h, rev)
                res = {k: compare(torch, got[k], ref[k], atol, rtol)
                       for k in ref}
                del got, ref
                worst = max(res, key=lambda k: res[k][1])
                fwd = KR.rnn_fwd_plan(n, h, mode, dtype, dev)
                walk = KR.rnn_bwd_walk_plan(n, h, mode, dtype, dev)
                ok = all(r[0] for r in res.values()) and \
                    launched == {"rnn_scan_fwd": 1, "rnn_scan_bwd": 1}
                if RNN_L2_CASES.get(mode) == (n_t, n, h):
                    ok = ok and not walk["w_in_smem"]
                if (n_t, n, h) == RNN_TIMED and mode == "lstm":
                    ok = ok and fwd["w_in_smem"]
                if (n_t, n, h) == RNN_REFUSED["forward"]:
                    ok = ok and not fwd["w_in_smem"] and \
                        fwd["tiles_per_block"] > 1
                if (n_t, n, h) == RNN_REFUSED["walk"]:
                    ok = ok and walk["tiles_per_block"] > 1
                rec = {"kernel": "rnn_scan", "mode": mode,
                       "reverse": rev, "dtype": dn, "shape": [n_t, n, h],
                       "max_abs_err": {k: r[1] for k, r in res.items()},
                       "worst": worst, "atol": atol, "rtol": rtol,
                       "launches": launched, "fwd_plan": fwd, "walk": walk,
                       "ok": ok}
                emit({"check": rec})
                if not ok:
                    failures.append(rec)
                if (n_t, n, h) == RNN_TIMED and mode == "lstm" \
                        and not rev:
                    fwd_err = max(res[k][1] for k in ("ys", "h_T", "c_T"))
                    bwd_err = max(r[1] for k, r in res.items()
                                  if k.startswith("d"))
                    timed[("rnn_scan_fwd", dn)] = (
                        dict(rec, kernel="rnn_scan_fwd",
                             max_abs_err=fwd_err), args)
                    timed[("rnn_scan_bwd", dn)] = (
                        dict(rec, kernel="rnn_scan_bwd",
                             max_abs_err=bwd_err), args)
        for rows, c in BG_BWD_CASES:
            x, bias, dy = rnd(rows, c), rnd(c), rnd(rows, c)
            got = KN.bias_gelu_bwd(x, bias, dy)
            torch.cuda.synchronize()
            res = [compare(torch, a, r, atol, rtol) for a, r in
                   zip(got, KN.bias_gelu_bwd_plain(x, bias, dy))]
            again = KN.bias_gelu_bwd(x, bias, dy)
            repeats = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            rec = {"kernel": "bias_gelu_bwd", "dtype": dn, "shape": [rows, c],
                   "max_abs_err": max(r[1] for r in res),
                   "rel_err": max(r[2] for r in res), "atol": atol,
                   "rtol": rtol, "repeats_bit_for_bit": repeats,
                   "ok": all(r[0] for r in res) and repeats}
            emit({"check": rec})
            if not rec["ok"]:
                failures.append(rec)
            if (rows, c) == BG_BWD_CASES[0]:
                timed[("bias_gelu_bwd", dn)] = (rec, (x, bias, dy))
    if failures:
        raise SystemExit(f"rnn / bias-GELU backward checks failed: "
                         f"{failures}")
    return timed


def cudnn_rnn_ms(torch, xw, h0, c0):
    """The library yardstick of the recurrence: cuDNN through
    ``torch.nn.LSTM`` (one layer, input size H, the same T, N, H and
    dtype), timed eagerly: (forward ms, forward+backward minus forward
    ms). Its time includes the input projection, which the kernels do
    not do. The port never calls it."""
    n_t, n, _ = xw.shape
    h = h0.shape[-1]
    lstm = torch.nn.LSTM(h, h).to(device=xw.device, dtype=xw.dtype)
    x = torch.randn(n_t, n, h, device=xw.device).to(xw.dtype)
    dy = torch.randn(n_t, n, h, device=xw.device).to(xw.dtype)
    state = (h0[None].contiguous(), c0[None].contiguous())

    def fwd(x_):
        return lstm(x_, state)[0]

    def fwd_bwd(x_):
        leaf = x_.detach().requires_grad_()
        torch.autograd.grad(fwd(leaf), [leaf] + list(lstm.parameters()), dy)

    f = time_eager_ms(torch, fwd, (x,))
    return f, time_eager_ms(torch, fwd_bwd, (x,)) - f


def time_new_kernels(torch, F, KR, KN, timed):
    """Kernel, plain-version and library times of this slice's kernels at
    their paths' shapes (the LM's LSTM layer, the phase-5 FFN), in each
    dtype, with the bound of this call's work: each input read once and
    each output written once; the recurrence's operations are the TPU
    kernel's (2*T*N*G*H^2 a product; the backward's three: recompute, dh,
    dW). Returns {(kernel, dtype): timing}."""
    timing, cudnn = {}, {}
    for (name, dn), (rec, args) in timed.items():
        extra = {}
        if name == "bias_gelu_bwd":
            x, bias, dy = args
            size = x.element_size()
            sets = [(x.clone(), bias, dy.clone())
                    for _ in range(n_sets(torch, (x, x, x)))]
            nbytes = size * (3 * x.numel() + 2 * bias.numel())
            flops = 25.0 * x.numel()    # add, exp, erf (~15), six products
            fns = (lambda *a: KN.bias_gelu_bwd(*a),
                   lambda *a: KN.bias_gelu_bwd_plain(*a))

            def gelu_fwd(x_, b_):
                return F.gelu(x_ + b_)

            def gelu_fwd_bwd(x_, b_, dy_):
                leaves = [x_.detach().requires_grad_(),
                          b_.detach().requires_grad_()]
                torch.autograd.grad(gelu_fwd(*leaves), leaves, dy_)

            library = "autograd backward of F.gelu(x + b) (eager)"
            library_ms = time_eager_ms(torch, gelu_fwd_bwd, (x, bias, dy)) \
                - time_eager_ms(torch, gelu_fwd, (x, bias))
        else:
            xw, h0, c0, w, b, dys, dc_t = args
            n_t, n, gh = xw.shape
            h = h0.shape[-1]
            size = xw.element_size()
            product = 2.0 * n_t * n * gh * h
            state = 2 * n * h                             # h0, c0
            if dn not in cudnn:
                cudnn[dn] = cudnn_rnn_ms(torch, xw, h0, c0)
            if name == "rnn_scan_fwd":
                sets = [(xw.clone(), h0, c0, w, b)
                        for _ in range(n_sets(torch, (xw, dys, dys)))]
                # xw, h0, c0, W_hh, b_hh in; ys and cs out
                nbytes = size * (xw.numel() + state + w.numel() + b.numel()
                                 + 2 * dys.numel())
                flops = product
                fns = (lambda *a: KR.rnn_scan_fwd(*a, "lstm"),
                       lambda *a: KR.rnn_scan_plain(*a, "lstm"))
                library = "cuDNN torch.nn.LSTM forward (eager)"
                library_ms = cudnn[dn][0]
                extra["fwd_plan_host_us"] = plan_host_us(
                    KR.rnn_fwd_plan, n, h, xw.dtype, xw.device)
            else:
                ys, cs = KR.rnn_scan_fwd(xw, h0, c0, w, b, "lstm")
                sets = [(xw.clone(), h0, c0, w, b, ys, cs, dys.clone(), dc_t)
                        for _ in range(n_sets(torch, (xw, xw, ys, cs, dys)))]
                # in: xw, h0, c0, W, b, ys, cs, dys, dc_T; out: dxw, dh0,
                # dc0, dW, db
                nbytes = size * (2 * xw.numel() + 2 * state + 2 * w.numel()
                                 + 2 * b.numel() + 3 * dys.numel()
                                 + dc_t.numel())
                flops = 3 * product
                fns = (lambda *a: KR.rnn_scan_bwd(*a, "lstm"),
                       lambda *a: KR.rnn_scan_bwd_plain(*a, "lstm"))
                library = ("cuDNN torch.nn.LSTM forward+backward minus "
                           "forward (eager)")
                library_ms = cudnn[dn][1]
                extra["walk_plan_host_us"] = plan_host_us(
                    KR.rnn_bwd_walk_plan, n, h, xw.dtype, xw.device)
        (ms, eager_ms), (plain_ms, plain_eager_ms) = (
            time_ms(torch, fn, sets, iters=10 if name != "bias_gelu_bwd"
                    else 30) for fn in fns)
        b_ms, b_by = bound_ms(nbytes, flops, dn)
        t = {"kernel": name, "dtype": dn, "shape": rec["shape"],
             "max_abs_err": rec["max_abs_err"], "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "library": library, "bound_ms": b_ms, "bound_by": b_by,
             "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
             "bytes": nbytes, "flops": flops, **extra}
        emit({"timing": t})
        timing[(name, dn)] = t
    return timing


def plan_host_us(query, n, h, dtype, dev, calls=200):
    """Host microseconds of one plan of a recurrence kernel (the card
    queries and the tile search that every ``rnn_scan_fwd`` or
    ``rnn_scan_bwd`` call makes), through its query entry from Python
    (``query`` is ``rnn_fwd_plan`` or ``rnn_bwd_walk_plan``): the mean of
    ``calls``."""
    query(n, h, "lstm", dtype, dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        query(n, h, "lstm", dtype, dev)
    return (time.perf_counter() - t0) / calls * 1e6


#: decode-kernel cases (N, H): a ragged one, the decode_wide shape
#: (bucket 8, the word LM's hidden 650), and 128 rows at H 650, which the
#: first version refused (h of all rows in one block's shared memory);
#: decode_leg's (8, 128) is timed
DECODE_CASES = ((3, 37), (128, 650), (8, 650))
DECODE_TIMED = ((8, 650), (8, 128))
#: the chained case: T decode steps against the scan kernel's ys, float32
DECODE_CHAIN_T, DECODE_CHAIN_TOL = 35, 1e-6


def check_decode_kernel(torch, K, KR, dev):
    """Phase 3, the decode kernel: ``rnn_decode`` against its plain
    version in all four modes, float32 and bfloat16, at DECODE_CASES and
    DECODE_TIMED; then DECODE_CHAIN_T decode steps against the
    ``rnn_scan_fwd`` kernel's trajectory at (8, 650), LSTM, float32.
    Returns {(kernel, dtype, N, H): (record, args)} of the LSTM cases at
    DECODE_TIMED, for :func:`time_decode_kernel`."""
    g = torch.Generator(device=dev).manual_seed(3)
    failures, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape, s=1.0):
            return (torch.randn(*shape, generator=g, device=dev) * s).to(
                dtype)

        dn = str(dtype).replace("torch.", "")
        atol, rtol = TOLS[dn]
        for n, h in DECODE_CASES + DECODE_TIMED:
            for mode in RNN_MODES:
                gates = KR.GATES[mode]
                xw, hh = rnd(n, gates * h, s=0.5), rnd(n, h, s=0.5)
                cc = rnd(n, h, s=0.5) if mode == "lstm" else None
                w = rnd(gates * h, h, s=0.5 * h ** -0.5)
                b = rnd(gates * h, s=0.1)
                before = K.launch_counts()["rnn_decode"]
                got = KR.rnn_decode_step(xw, hh, cc, w, b, mode)
                torch.cuda.synchronize()
                launched = K.launch_counts()["rnn_decode"] - before
                ref = KR.rnn_decode_step_plain(xw, hh, cc, w, b, mode)
                res = [compare(torch, a, r, atol, rtol)
                       for a, r in zip(got, ref) if r is not None]
                rec = {"kernel": "rnn_decode", "mode": mode, "dtype": dn,
                       "shape": [n, h], "max_abs_err": max(r[1] for r in res),
                       "atol": atol, "rtol": rtol, "launches": launched,
                       "ok": all(r[0] for r in res) and launched == 1}
                emit({"check": rec})
                if not rec["ok"]:
                    failures.append(rec)
                if mode == "lstm" and (n, h) in DECODE_TIMED:
                    timed[("rnn_decode", dn, n, h)] = (rec, (xw, hh, cc, w,
                                                             b))
    # decode = scan position, at the kernel level
    n, h = DECODE_CASES[-1]
    xw = (torch.randn(DECODE_CHAIN_T, n, 4 * h, generator=g, device=dev)
          * 0.5)
    h0 = torch.randn(n, h, generator=g, device=dev) * 0.5
    c0 = torch.randn(n, h, generator=g, device=dev) * 0.5
    w = torch.randn(4 * h, h, generator=g, device=dev) * 0.5 * h ** -0.5
    b = torch.randn(4 * h, generator=g, device=dev) * 0.1
    ys, cs = KR.rnn_scan_fwd(xw, h0, c0, w, b, "lstm")
    hh, cc, err = h0, c0, 0.0
    for t in range(DECODE_CHAIN_T):
        hh, cc = KR.rnn_decode_step(xw[t], hh, cc, w, b, "lstm")
        err = max(err, float((hh - ys[t]).abs().max()),
                  float((cc - cs[t]).abs().max()))
    torch.cuda.synchronize()
    rec = {"kernel": "rnn_decode", "chained_vs": "rnn_scan_fwd ys, cs",
           "steps": DECODE_CHAIN_T, "shape": [n, h], "mode": "lstm",
           "dtype": "float32", "max_abs_err": err, "atol": DECODE_CHAIN_TOL,
           "ok": err <= DECODE_CHAIN_TOL}
    emit({"check": rec})
    if not rec["ok"]:
        failures.append(rec)
    if failures:
        raise SystemExit(f"decode kernel checks failed: {failures}")
    return timed


def time_decode_kernel(torch, KR, timed):
    """Kernel, plain-version and library times of ``rnn_decode`` (LSTM)
    at DECODE_TIMED in each dtype, by CUDA-graph replay over copies of
    W_hh larger than the L2 (the engine reads W_hh cold, after the 86 MB
    logits product of a step). W_hh is in the activation dtype, as the
    scan's checks hold it; the wrapper hands the kernel a float32 copy
    (no copy in float32). Bound: W_hh, b_hh, xw, h, c read once and h, c
    written once, against 2*N*G*H^2 float32 operations (the kernel's
    arithmetic is float32 in both dtypes). Library: ``torch.nn.LSTMCell`` at the same N, H and
    dtype, which also does the input projection. Returns {(kernel,
    dtype, N, H): timing}."""
    timing = {}
    for key, (rec, args) in timed.items():
        _, dn, n, h = key
        xw, hh, cc, w, b = args
        size = xw.element_size()
        sets = [(xw.clone(), hh.clone(), cc.clone(), w.clone(), b)
                for _ in range(n_sets(torch, (w,)))]
        nbytes = size * (w.numel() + b.numel() + xw.numel()
                         + 4 * hh.numel())
        flops = 2.0 * n * xw.shape[1] * h
        cell = torch.nn.LSTMCell(h, h).to(device=xw.device, dtype=xw.dtype)
        x = torch.randn(n, h, device=xw.device).to(xw.dtype)
        fns = (lambda *a: KR.rnn_decode_step(*a, "lstm"),
               lambda *a: KR.rnn_decode_step_plain(*a, "lstm"),
               lambda xw_, h_, c_, w_, b_: cell(x, (h_, c_)))
        (ms, eager_ms), (plain_ms, plain_eager_ms), \
            (library_ms, library_eager_ms) = (
                time_ms(torch, fn, sets, iters=50) for fn in fns)
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        t = {"kernel": "rnn_decode", "dtype": dn, "shape": [n, h],
             "max_abs_err": rec["max_abs_err"], "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "library": "torch.nn.LSTMCell (with its input projection)",
             "bound_ms": b_ms, "bound_by": b_by, "eager_ms": eager_ms,
             "plain_eager_ms": plain_eager_ms,
             "library_eager_ms": library_eager_ms, "bytes": nbytes,
             "flops": flops}
        emit({"timing": t})
        timing[key] = t
    return timing


def grad_check(torch, gpu_net, cpu_net, loss_fn, x, y):
    """One backward of ``loss_fn`` at (x, y) on both nets (in eval mode:
    dropout off); the worst parameter's max |difference| over its bound
    GRAD_ATOL + GRAD_RTOL * max |CPU gradient| (ok when <= 1)."""
    grads = []
    for net in (gpu_net, cpu_net):
        net.eval()
        dev = next(net.parameters()).device
        for p in net.parameters():
            p.grad = None
        loss_fn(net(torch.from_numpy(x).to(dev)),
                torch.from_numpy(y).to(dev)).sum().backward()
        grads.append({n: p.grad.detach().float().cpu()
                      for n, p in net.named_parameters()})
    worst, worst_name, worst_err = 0.0, None, 0.0
    for n, ref in grads[1].items():
        err = float((grads[0][n] - ref).abs().max())
        ratio = err / (GRAD_ATOL + GRAD_RTOL * float(ref.abs().max()))
        if not math.isfinite(ratio) or ratio > worst:
            worst, worst_name, worst_err = ratio, n, err
    return {"params": len(grads[1]), "worst_param": worst_name,
            "worst_max_abs_err": worst_err, "worst_err_over_bound": worst,
            "atol": GRAD_ATOL, "rtol_of_param_max": GRAD_RTOL,
            "ok": worst <= 1.0}


def copy_to_cpu(make_cpu_net, gpu_net, load_jax_params):
    """A CPU copy of ``gpu_net`` with its current weights."""
    cpu_net = make_cpu_net()
    load_jax_params(cpu_net, {n: p.detach().cpu().numpy()
                              for n, p in gpu_net.named_parameters()})
    return cpu_net


def run_train_steps(torch, K, step, x, y, steps):
    """``steps`` calls of a compiled train step on one batch: the losses,
    the wall ms of each step (each ends in a synchronize), the launches of
    each step, and the launches of the whole run (counted from 0)."""
    losses, step_ms, per_step = [], [], []
    K.reset_launch_counts()
    for _ in range(steps):
        before = K.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(x, y))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = K.launch_counts()
        per_step.append({n: after[n] - before[n] for n in after})
    counts = K.launch_counts()
    return [float(l.mean()) for l in losses], step_ms, per_step, counts


#: device-kernel name fragments of each family in a profile
FAMILIES = (("flash_fwd", ("flash_fwd",)), ("flash_bwd", ("flash_bwd",)),
            ("layernorm_fwd", ("ln_fwd",)), ("layernorm_bwd", ("ln_bwd",)),
            ("bias_gelu_fwd", ("bias_gelu_fwd",)),
            ("bias_gelu_bwd", ("bias_gelu_bwd",)),
            ("rnn_scan_fwd", ("rnn_scan_fwd",)),
            ("rnn_scan_bwd", ("rnn_bwd_walk", "rnn_gemm")),
            ("rnn_decode", ("rnn_decode",)),
            ("gemm", ("gemm", "cutlass", "gemv")))


def device_us_by_kernel(torch, prof):
    """Device µs of a ``torch.profiler`` run by kernel name."""
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us
    return kernels


def device_us_by_family(torch, prof):
    """Device µs of a ``torch.profiler`` run summed by kernel family."""
    families = {}
    for key, us in device_us_by_kernel(torch, prof).items():
        name = key.lower()
        fam = next((f for f, parts in FAMILIES
                    if any(p in name for p in parts)), "other")
        families[fam] = families.get(fam, 0.0) + us
    return families


def profile_train_step(torch, net, trainer, loss_fn, x, y, what, iters=3):
    """``--profile``: where the time of one training step goes. One step
    split by CUDA events into forward, backward and optimizer update;
    then ``torch.profiler`` over ``iters`` steps, device time summed by
    kernel family, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = loss_fn(net(x), y)
    ev[1].record()
    loss.sum().backward()
    ev[2].record()
    trainer.step(x.shape[0])
    ev[3].record()
    torch.cuda.synchronize()
    phases = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
              enumerate(("forward", "backward", "update"))}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            loss_fn(net(x), y).sum().backward()
            trainer.step(x.shape[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    families = device_us_by_family(torch, prof)
    busy = sum(families.values())
    top = sorted(device_us_by_kernel(torch, prof).items(),
                 key=lambda kv: -kv[1])[:8]
    emit({"train_profile": {
        "model": what, "iters": iters, "phase_ms_one_step": phases,
        "wall_ms_per_step": wall_us / iters / 1e3,
        "device_ms_per_step": {k: v / iters / 1e3
                               for k, v in families.items()},
        "device_share_by_family": {k: v / busy for k, v in families.items()}
        if busy else "not measured (the profiler saw no device time)",
        "top_kernels_ms_per_step": [[k[:80], v / iters / 1e3]
                                    for k, v in top],
        "device_busy_share": busy / wall_us if busy else
        "not measured (the profiler saw no device time)"}})


def train_bert(torch, np, K, dev, smi, profile=False):
    """Phase 6: BERT-base classifier training through
    ``Trainer.compile_step``; the launch counts of exactly the ten
    steps."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params

    def make(device):
        return BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=0.1,
                                        device=device),
                              num_classes=2, dropout=0.1, device=device)

    t0 = time.perf_counter()
    torch.manual_seed(0)        # the dropout masks
    net = make(dev)
    load_jax_params(net, init_params_numpy(net, seed=2))
    net.train()
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = rs.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    y = rs.randint(0, 2, (TRAIN_BATCH,)).astype(np.float32)
    loss_fn = SoftmaxCrossEntropyLoss()
    trainer = Trainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": TRAIN_LR})
    step = trainer.compile_step(lambda a, b: loss_fn(net(a), b))
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step, counts = run_train_steps(
        torch, K, step, xt, yt, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    median_ms = statistics.median(step_ms)
    expect = {n: 0 for n in K.KERNELS}
    expect.update(flash_fwd=12, flash_bwd_fused=12, layernorm_fwd=25,
                  layernorm_bwd=25)
    launches_ok = all(s == expect for s in per_step)
    losses_ok = all(math.isfinite(v) for v in losses) and \
        losses[-1] < losses[0]
    if profile:
        profile_train_step(torch, net, trainer, loss_fn, xt, yt,
                           "bert_base classifier 32 x 512")

    t1 = time.perf_counter()
    cpu_net = copy_to_cpu(lambda: make("cpu"), net, load_jax_params)
    grads = grad_check(torch, net, cpu_net, loss_fn,
                       x[:GRAD_BATCH, :GRAD_SEQ], y[:GRAD_BATCH])
    print(smi, flush=True)
    report = {
        "model": "bert_base classifier", "dtype": "float32",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "optimizer": "adam", "learning_rate": TRAIN_LR, "dropout": 0.1,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3),
        "max_memory_allocated": peak, "setup_s": setup_s,
        "launches": counts, "launches_per_step": per_step[-1],
        "launches_per_step_expected": expect,
        "grad_check": dict(grads, batch=GRAD_BATCH, seq=GRAD_SEQ,
                           seconds=time.perf_counter() - t1),
        "card": smi, "ok": launches_ok and losses_ok and grads["ok"]}
    emit({"train": report})
    if not report["ok"]:
        raise SystemExit(f"training phase failed: losses {losses}, "
                         f"launches per step {per_step}, gradients {grads}")
    return counts


def long_setup(torch, np, dev):
    """Phase 7's model (seeded weights, dropout 0.1, train mode), batch
    (numpy), loss and compiled Adam step on ``dev``, and the function
    that makes the model on a device."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, BERTModel
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params

    def make(device):
        return BERTClassifier(BERTModel(num_layers=LONG_LAYERS,
                                        max_length=LONG_SEQ, dropout=0.1,
                                        device=device),
                              num_classes=2, dropout=0.1, device=device)

    torch.manual_seed(1)        # the dropout masks
    net = make(dev)
    load_jax_params(net, init_params_numpy(net, seed=4))
    net.train()
    rs = np.random.RandomState(5)
    vocab = net.bert.word_embed.weight.shape[0]
    x = rs.randint(0, vocab, (LONG_BATCH, LONG_SEQ)).astype(np.int64)
    y = rs.randint(0, 2, (LONG_BATCH,)).astype(np.float32)
    loss_fn = SoftmaxCrossEntropyLoss()
    trainer = Trainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": TRAIN_LR})
    step = trainer.compile_step(lambda a, b: loss_fn(net(a), b))
    return make, net, x, y, loss_fn, step


def train_long(torch, np, K, dev):
    """Phase 7: a 2-layer BERT-width classifier at sequence 1024, where
    the flash backward takes its dq and dkv kernels."""
    from mxnet_tpu_torch.gluon.params import load_jax_params

    make, net, x, y, loss_fn, step = long_setup(torch, np, dev)
    losses, step_ms, per_step, counts = run_train_steps(
        torch, K, step, torch.from_numpy(x).to(dev),
        torch.from_numpy(y).to(dev), LONG_STEPS)
    expect = {n: 0 for n in K.KERNELS}
    expect.update(flash_fwd=LONG_LAYERS, flash_bwd_dq=LONG_LAYERS,
                  flash_bwd_dkv=LONG_LAYERS,
                  layernorm_fwd=2 * LONG_LAYERS + 1,
                  layernorm_bwd=2 * LONG_LAYERS + 1)
    cpu_net = copy_to_cpu(lambda: make("cpu"), net, load_jax_params)
    grads = grad_check(torch, net, cpu_net, loss_fn, x, y)
    ok = all(s == expect for s in per_step) and grads["ok"] and \
        all(math.isfinite(v) for v in losses)
    emit({"train_long": {
        "layers": LONG_LAYERS, "batch": LONG_BATCH, "seq": LONG_SEQ,
        "steps": LONG_STEPS, "losses": losses, "step_ms": step_ms,
        "launches": counts, "launches_per_step": per_step,
        "launches_per_step_expected": expect,
        "grad_check": dict(grads, batch=LONG_BATCH, seq=LONG_SEQ),
        "ok": ok}})
    if not ok:
        raise SystemExit(f"long-sequence phase failed: {per_step}, {grads}")
    return counts


def serve_bert(torch, np, K, dev):
    """Phase 4: BERT-base served through the batcher; the launch counts
    of exactly this run, and the predictor."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.serving import CompiledPredictor, DynamicBatcher, \
        loadgen

    t0 = time.perf_counter()
    net = BERTClassifier(bert_base(device=dev), num_classes=2, device=dev)
    params = init_params_numpy(net, seed=0)
    load_jax_params(net, params)
    n_params = sum(p.numel() for p in net.parameters())
    pred = CompiledPredictor(net, device=dev)
    rs = np.random.RandomState(0)
    vocab = net.bert.word_embed.weight.shape[0]
    warm = pred.warmup(rs.randint(0, vocab, (1, SERVE_SEQ)).astype(np.int64))
    emit({"serving_setup": {"params": n_params,
                            "setup_s": time.perf_counter() - t0,
                            "warmup_s": warm,
                            "service_time_seed_s": pred.service_time_seed_s}})
    reqs = [rs.randint(0, vocab, (int(rs.randint(1, 9)), SERVE_SEQ))
            .astype(np.int64) for _ in range(SERVE_REQUESTS)]
    results = [None] * SERVE_REQUESTS

    K.reset_launch_counts()
    with DynamicBatcher(pred, max_batch=SERVE_MAX_BATCH,
                        timeout_ms=2.0) as batcher:
        def issue(i):
            out = batcher.submit(reqs[i]).result(120)
            results[i] = out.float().cpu().numpy()

        rep = loadgen.run_closed_loop(issue, SERVE_CLIENTS, SERVE_REQUESTS)
    counts = K.launch_counts()
    stats = dict(batcher.stats)
    rows = sum(r.shape[0] for r in reqs)
    report = {
        "requests": rep["requests"], "errors": rep["errors"],
        "first_error": rep["first_error"],
        "req_per_s": rep["requests"] / rep["wall_s"],
        "tokens_per_s": rows * SERVE_SEQ / rep["wall_s"],
        "p50_ms": rep["p50_ms"], "p99_ms": rep["p99_ms"],
        "wall_s": rep["wall_s"], "rows": rows,
        "micro_batches": stats["batches"], "batch_fill": batcher.batch_fill,
        "buckets": {str(k): v for k, v in sorted(batcher.bucket_counts
                                                   .items())},
        "flush": {k[6:]: v for k, v in stats.items()
                  if k.startswith("flush_")},
        "launches": counts, "n_traces": pred.n_traces}
    emit({"serving": report})
    if rep["errors"] or rep["requests"] != SERVE_REQUESTS:
        raise SystemExit(f"serving failed: {rep}")
    for i, out in enumerate(results):
        if out is None or out.shape != (reqs[i].shape[0], 2) or \
                not np.isfinite(out).all():
            raise SystemExit(f"request {i}: bad logits {out!r}")
    nb = stats["batches"]
    if counts["flash_fwd"] != 12 * nb or counts["layernorm_fwd"] != 25 * nb:
        raise SystemExit(f"launches {counts} do not match 12 flash and 25 "
                         f"LayerNorm per micro-batch ({nb} micro-batches)")

    # two requests again through a CPU copy (plain kernels)
    cpu_net = BERTClassifier(bert_base(device="cpu"), num_classes=2,
                             device="cpu")
    load_jax_params(cpu_net, params)
    cpu_pred = CompiledPredictor(cpu_net, device="cpu")
    errs = []
    for i in (0, 1):
        padded, n = cpu_pred.pad_to_bucket(reqs[i])
        ref = cpu_pred.predict(*padded)[:n].numpy()
        errs.append(float(np.abs(ref - results[i]).max()))
    emit({"serving_vs_cpu": {"requests": [0, 1], "max_abs_err": max(errs),
                             "atol": LOGIT_ATOL}})
    if max(errs) > LOGIT_ATOL:
        raise SystemExit(f"GPU logits differ from the CPU copy: {errs}")
    return counts, pred


def profile_bucket(torch, np, pred, bucket=SERVE_MAX_BATCH, iters=5):
    """``--profile``: where the device time of one served micro-batch
    goes. ``torch.profiler`` over ``iters`` back-to-back predicts of the
    bucket; kernel time summed by family, and the device's busy share of
    the wall time."""
    from torch.profiler import ProfilerActivity, profile

    vocab = pred.net.bert.word_embed.weight.shape[0]
    x = np.random.RandomState(2).randint(0, vocab, (bucket, SERVE_SEQ)) \
        .astype(np.int64)
    pred.predict(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            pred.predict(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    families = device_us_by_family(torch, prof)
    busy = sum(families.values())
    emit({"profile": {
        "bucket": bucket, "seq": SERVE_SEQ, "iters": iters,
        "wall_ms_per_batch": wall_us / iters / 1e3,
        "device_ms_per_batch": {k: v / iters / 1e3
                                for k, v in families.items()},
        "device_busy_share": busy / wall_us if busy else
        "not measured (the profiler saw no device time)"}})


def run_encoder(torch, np, K, dev):
    """Phase 5: a TransformerEncoder with the default ``gelu`` FFN, so the
    bias-GELU kernels run: a forward checked against a CPU copy, then a
    backward at the same shapes (one ``bias_gelu_bwd`` launch per layer)
    and the gradients of every parameter against the CPU copy. The launch
    counts of the forward and the backward."""
    from mxnet_tpu_torch.gluon.nn import TransformerEncoder
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params

    shape = (ENC_LAYERS, ENC_UNITS, ENC_HIDDEN, ENC_HEADS)
    enc = TransformerEncoder(*shape, device=dev).eval()
    params = init_params_numpy(enc, seed=1)
    load_jax_params(enc, params)
    rs = np.random.RandomState(1)
    x = rs.standard_normal((SERVE_MAX_BATCH, SERVE_SEQ, ENC_UNITS)) \
        .astype(np.float32)
    wgt = rs.standard_normal(x.shape).astype(np.float32)
    K.reset_launch_counts()
    with torch.inference_mode():
        y = enc(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    cpu = TransformerEncoder(*shape, device="cpu").eval()
    load_jax_params(cpu, params)
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(x[:2]))
    err = float((y[:2].cpu() - ref).abs().max())
    ok = bool(torch.isfinite(y).all()) and err <= LOGIT_ATOL

    def weighted(out, w):
        """a per-sample loss (the repo's loss convention): the mean over
        tokens and units of the output weighted by w"""
        return (out * w).mean(dim=(1, 2))

    # backward at the phase's shapes
    K.reset_launch_counts()
    weighted(enc(torch.from_numpy(x).to(dev)),
             torch.from_numpy(wgt).to(dev)).sum().backward()
    torch.cuda.synchronize()
    bwd_counts = K.launch_counts()
    finite = all(bool(torch.isfinite(p.grad).all()) for p in enc.parameters())

    grads = grad_check(torch, enc, cpu, weighted, x[:GRAD_BATCH],
                       wgt[:GRAD_BATCH])
    ok = ok and finite and grads["ok"] and bwd_counts["bias_gelu_bwd"] == \
        ENC_LAYERS and bwd_counts["bias_gelu_fwd"] == ENC_LAYERS
    emit({"encoder": {"shape": list(y.shape), "launches": counts,
                      "max_abs_err_vs_cpu": err, "atol": LOGIT_ATOL,
                      "backward_launches": bwd_counts,
                      "grad_check": dict(grads, batch=GRAD_BATCH,
                                         seq=SERVE_SEQ),
                      "ok": ok}})
    if not ok or counts["bias_gelu_fwd"] != 2 or counts["flash_fwd"] != 2 \
            or counts["layernorm_fwd"] != 4:
        raise SystemExit(f"encoder phase failed: {counts}, {bwd_counts}, "
                         f"err {err}, gradients {grads}")
    return {k: counts[k] + bwd_counts[k] for k in counts}


#: phase 8: the JAX package's LSTM training leg (bench.py bench_lstm,
#: examples/train_lstm_lm.py WordLM): vocab 33,278 (wikitext-2), embed
#: and hidden 650, 2 layers, batch 64 x bptt 35, float32, SGD with
#: momentum 0.9 at the leg's own learning rate; ten steps on one seeded
#: batch
LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS = 33278, 650, 650, 2
LM_BATCH, LM_BPTT, LM_STEPS, LM_LR = 64, 35, 10, 0.5
#: the gradient check of phase 8 runs at this batch (x bptt 35)
LM_GRAD_BATCH = 4


def train_lstm(torch, np, K, dev, smi, profile=False):
    """Phase 8: the LSTM word LM trained through ``Trainer.compile_step``
    (SGD, momentum 0.9): every loss finite and the last below the first,
    exactly LM_LAYERS ``rnn_scan_fwd`` and LM_LAYERS ``rnn_scan_bwd``
    launches per step, one step's gradients of all 11 parameters at batch
    4 against a CPU copy; then an eval-mode forward of the same batch
    (tokens/s, logits against the CPU copy). The launch counts of exactly
    the ten steps."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import WordLM
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params

    def make(device):
        return WordLM(LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS, device=device)

    t0 = time.perf_counter()
    net = make(dev)
    load_jax_params(net, init_params_numpy(net, seed=6))
    net.train()
    rs = np.random.RandomState(7)
    x = rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT)).astype(np.int64)
    y = rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT)).astype(np.float32)
    loss_fn = SoftmaxCrossEntropyLoss()
    trainer = Trainer(dict(net.named_parameters()), "sgd",
                      {"learning_rate": LM_LR, "momentum": 0.9})
    step = trainer.compile_step(lambda a, b: loss_fn(net(a), b))
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step, counts = run_train_steps(
        torch, K, step, xt, yt, LM_STEPS)
    peak = torch.cuda.max_memory_allocated()
    median_ms = statistics.median(step_ms)
    expect = {n: 0 for n in K.KERNELS}
    expect.update(rnn_scan_fwd=LM_LAYERS, rnn_scan_bwd=LM_LAYERS)
    launches_ok = all(s == expect for s in per_step)
    losses_ok = all(math.isfinite(v) for v in losses) and \
        losses[-1] < losses[0]
    if profile:
        profile_train_step(torch, net, trainer, loss_fn, xt, yt,
                           "WordLM 64 x 35")

    t1 = time.perf_counter()
    cpu_net = copy_to_cpu(lambda: make("cpu"), net, load_jax_params)
    grads = grad_check(torch, net, cpu_net, loss_fn, x[:LM_GRAD_BATCH],
                       y[:LM_GRAD_BATCH])
    grad_s = time.perf_counter() - t1
    tokens = LM_BATCH * LM_BPTT
    report = {
        "model": "WordLM (LSTM LM)", "vocab": LM_VOCAB, "embed": LM_EMBED,
        "hidden": LM_HIDDEN, "layers": LM_LAYERS, "dtype": "float32",
        "batch": LM_BATCH, "bptt": LM_BPTT, "steps": LM_STEPS,
        "optimizer": "sgd", "momentum": 0.9, "learning_rate": LM_LR,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": tokens / (median_ms / 1e3),
        "max_memory_allocated": peak, "setup_s": setup_s,
        "launches": counts, "launches_per_step": per_step[-1],
        "launches_per_step_expected": expect,
        "grad_check": dict(grads, batch=LM_GRAD_BATCH, bptt=LM_BPTT,
                           seconds=grad_s),
        "card": smi, "ok": launches_ok and losses_ok and grads["ok"]}
    emit({"lstm_train": report})
    if not report["ok"]:
        raise SystemExit(f"LSTM LM phase failed: losses {losses}, launches "
                         f"per step {per_step}, gradients {grads}")

    # eval-mode forward of the same batch
    net.eval()
    fwd_ms = []
    with torch.inference_mode():
        for _ in range(5):
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            logits = net(xt)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t2) * 1e3)
        ref = cpu_net(torch.from_numpy(x[:LM_GRAD_BATCH]))
    err = float((logits[:LM_GRAD_BATCH].float().cpu() - ref).abs().max())
    ok = bool(torch.isfinite(logits).all()) and err <= LOGIT_ATOL and \
        tuple(logits.shape) == (LM_BATCH, LM_BPTT, LM_VOCAB)
    fwd_median = statistics.median(fwd_ms[1:])
    emit({"lstm_forward": {
        "batch": LM_BATCH, "bptt": LM_BPTT, "shape": list(logits.shape),
        "ms": fwd_ms, "median_ms": fwd_median,
        "tokens_per_s": tokens / (fwd_median / 1e3),
        "max_abs_err_vs_cpu": err, "atol": LOGIT_ATOL,
        "rows_vs_cpu": LM_GRAD_BATCH, "card": smi, "ok": ok}})
    if not ok:
        raise SystemExit(f"LSTM LM forward failed: err {err}")
    return counts


#: phase 9: the JAX package's decode leg as bench.py bench_decode runs it
#: on an accelerator (decode_leg), and the same engine and mix at the
#: word LM's widths (decode_wide); float32 weights and KV cache
DECODE_REQUESTS, DECODE_LADDER, DECODE_PAGE = 32, (1, 2, 4, 8), 16
DECODE_SPEC_K, DECODE_SPEC_NEW, DECODE_GQA_REQUESTS = 4, 24, 8
DECODE_LEG = dict(vocab=256, d_model=128, num_heads=4)
DECODE_WIDE = dict(vocab=33278, d_model=650, num_heads=10)


def decode_mix(np, vocab, n_req, page_size):
    """bench.py's decode mix from RandomState(7): prompts of 2-11 tokens,
    max_new 48 for every 8th request and 2-5 otherwise; then the
    speculative mix, a 3-page shared base plus a 2-4 token tail."""
    rng = np.random.RandomState(7)
    prompts, mns = [], []
    for i in range(n_req):
        prompts.append(rng.randint(0, vocab, size=int(rng.randint(2, 12))))
        mns.append(48 if i % 8 == 0 else int(rng.randint(2, 6)))
    base = rng.randint(0, vocab, size=3 * page_size).astype(np.int32)
    sp_prompts = [np.concatenate([base, rng.randint(0, vocab, size=2 + (
        i % 3)).astype(np.int32)]) for i in range(max(8, n_req // 2))]
    return prompts, mns, sp_prompts


def tiny_logit_gap(torch, ATT, model, seq):
    """Top-2 logit gap of a TinyDecoder after the tokens ``seq``, one
    slot, computed position by position (the diagnostic of a token
    mismatch: a near tie, or a bug)."""
    p = model.params
    dev = model.device
    h, c = model.init_state(1)
    ks, vs = [], []
    with torch.no_grad():
        for tok in seq:
            h, c = model._cell(p, torch.tensor([int(tok)], device=dev), h, c)
            q, k, v = model._qkv(p, h)
            ks.append(k)
            vs.append(v)
        keys = torch.stack(ks, 2)                  # (1, heads, T, hd)
        vals = torch.stack(vs, 2)
        attn = ATT.attention_reference(q[:, :, None], keys, vals)[:, :, 0]
        top = model._logits(p, h, attn)[0].float().topk(2).values
    return float(top[0] - top[1])


def state_drift(torch, model, prompt, tokens, at=(0, 8, 16, 24, 32, 40)):
    """max |h_float32 - h_float64| of a TinyDecoder's recurrent state
    along one request (its prompt, then ``tokens`` fed back), on the CPU
    copy, at the generated positions ``at``: how fast the recurrence
    amplifies float32 rounding at these widths."""
    p32 = model.params
    p64 = {k: v.double() for k, v in p32.items()}
    h = [torch.zeros(1, model.d_model, dtype=d) for d in (torch.float32,
                                                          torch.float64)]
    c = [x.clone() for x in h]
    seq = list(prompt) + list(tokens)
    out = {}
    with torch.no_grad():
        for i, tok in enumerate(seq[:-1]):
            t = torch.tensor([int(tok)])
            for j, p in enumerate((p32, p64)):
                h[j], c[j] = model._cell(p, t, h[j], c[j])
            gen = i - (len(prompt) - 1)
            if gen in at:
                out[gen] = float((h[0].double() - h[1]).abs().max())
    return out


def check_tokens(torch, ATT, what, got, ref, model, prompts, horizon=None):
    """Fail the phase where two runs' tokens differ within the first
    ``horizon`` tokens of a request (all of them when None), after
    printing the first differing request, position and the top-2 logit
    gap there. Returns the first difference past the horizon, or
    None."""
    def first_diff(a, r):
        a, r = a or [], r or []
        return next((j for j, (x, y) in enumerate(zip(a, r)) if x != y),
                    min(len(a), len(r)))

    if got == ref:
        return None
    if horizon is not None:
        cut = [[(a or [])[:horizon] for a in x] for x in (got, ref)]
        if cut[0] == cut[1] and None not in got:
            return next((i, first_diff(a, r))
                        for i, (a, r) in enumerate(zip(got, ref)) if a != r)
    for i, (a, r) in enumerate(zip(got, ref)):
        if a != r:
            pos = first_diff(a, r)
            gap = None
            if hasattr(model, "_cell") and r is not None:
                gap = tiny_logit_gap(torch, ATT, model,
                                     list(prompts[i]) + list(r[:pos]))
            emit({"token_mismatch": {"what": what, "request": i,
                                     "position": pos, "got": a, "ref": r,
                                     "top2_logit_gap": gap}})
            break
    raise SystemExit(f"decode tokens differ: {what}")


def decode_line(name, rep, smi, extra=None):
    keys = ("mode", "requests", "tokens", "wall_s", "decode_tokens_per_sec",
            "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms",
            "steps", "prefill_chunks", "kv_page_util", "kv_num_pages",
            "warmup_s", "errors", "acceptance_rate", "tokens_per_step",
            "spec_steps", "prefix_hits", "cow_copies", "kv_shared_peak")
    line = {k: rep[k] for k in keys if k in rep}
    line["rnn_decode_launches"] = rep["launches"]["rnn_decode"]
    line.update(extra or {}, card=smi)
    emit({name: line})


def decode_run(torch, K, model, prompts, mns, **kw):
    """``serving.run_decode`` on the card with the kernel counts set to 0
    just before it: (report, launches of the whole call)."""
    from mxnet_tpu_torch import serving
    K.reset_launch_counts()
    rep = serving.run_decode(model, prompts, mns, ladder=DECODE_LADDER,
                             page_size=DECODE_PAGE, **kw)
    torch.cuda.synchronize()
    return rep, K.launch_counts()


def decode_gates(rep, spec_k=0):
    """The run's own checks: no error, and its rnn_decode launches after
    the warm-up exactly one a decode step (spec_k + 1 a verify step) plus
    the chunk width per prefill chunk."""
    per_step = spec_k + 1
    want = per_step * rep["steps"] + 16 * rep["prefill_chunks"]
    return rep["errors"] == 0 and rep["launches"]["rnn_decode"] == want, \
        want


#: decode_wide's tokens are held exactly against the CPU copy over each
#: request's first DECODE_WIDE_HORIZON tokens: at d_model 650 with the
#: reference's random weights (std 0.3) the recurrence amplifies float32
#: rounding (the CPU copy's own float32 state drifts from float64 by
#: 4e-6 after 1 token, 1e-4 after 16, 1.5e-2 after 40), so two correct
#: float32 implementations part ways late in a 48-token request
#: (state_drift prints the drift of every run)
DECODE_WIDE_HORIZON = 32


def serve_decode(torch, np, K, ATT, dev, smi, widths, leg):
    """Phase 9: the decode engine on the card through ``run_decode``.
    ``leg`` True runs decode_leg (continuous, static, the speculative A/B
    with prefix sharing, and the GQA decoder on the first 8 prompts);
    False runs decode_wide (continuous). Every run's tokens are held
    against a CPU copy (same seed); continuous = static, speculative =
    greedy; exact rnn_decode launch counts. Returns the launch counts of
    the continuous run and its model."""
    from mxnet_tpu_torch.gluon import GQADecoder
    from mxnet_tpu_torch.serving import TinyDecoder
    name = "decode" if leg else "decode_wide"
    t0 = time.perf_counter()
    model = TinyDecoder(**widths, seed=0, device=dev)
    cpu_model = TinyDecoder(**widths, seed=0, device="cpu")
    prompts, mns, sp_prompts = decode_mix(np, widths["vocab"],
                                          DECODE_REQUESTS, DECODE_PAGE)
    emit({f"{name}_setup": {"widths": widths, "seconds":
                            time.perf_counter() - t0}})
    runs = [("continuous", model, cpu_model, prompts, mns, {})]
    if leg:
        runs += [("static", model, cpu_model, prompts, mns,
                  {"static": True}),
                 ("greedy", model, cpu_model, sp_prompts, DECODE_SPEC_NEW,
                  {"spec_k": 0, "prefix_share": False}),
                 ("speculative", model, cpu_model, sp_prompts,
                  DECODE_SPEC_NEW, {"spec_k": DECODE_SPEC_K,
                                    "prefix_share": True})]
        kw = dict(vocab=widths["vocab"], d_model=widths["d_model"],
                  num_heads=2 * widths["num_heads"],
                  num_kv_heads=widths["num_heads"], num_layers=2, seed=0)
        runs.append(("gqa", GQADecoder(**kw, device=dev),
                     GQADecoder(**kw, device="cpu"),
                     prompts[:DECODE_GQA_REQUESTS], mns[:DECODE_GQA_REQUESTS],
                     {}))
    horizon = None if leg else DECODE_WIDE_HORIZON
    reps, path_counts = {}, None
    for what, m, cm, ps_, mn, kw in runs:
        rep, counts = decode_run(torch, K, m, ps_, mn, **kw)
        t1 = time.perf_counter()
        ref = run_cpu_decode(cm, ps_, mn, **kw)
        cpu_s = time.perf_counter() - t1
        late = check_tokens(torch, ATT, f"{name} {what} vs CPU copy",
                            rep["tokens_by_request"], ref, cm, ps_, horizon)
        if what == "gqa":
            ok = rep["errors"] == 0 and counts["rnn_decode"] == 0
            want = 0
        else:
            ok, want = decode_gates(rep, kw.get("spec_k", 0))
        reps[what] = rep
        extra = {"launches_expected": want, "cpu_copy_s": cpu_s,
                 "tokens_equal_cpu_copy": late is None, "ok": ok}
        if horizon is not None:
            extra.update(exact_horizon=horizon, first_difference_past_it=late,
                         cpu_state_drift_f32_vs_f64=state_drift(
                             torch, cm, ps_[0], ref[0]))
        if what == "continuous":
            path_counts = counts
        decode_line(name, rep, smi, dict(extra, run=what))
        if not ok:
            raise SystemExit(f"{name} {what}: errors {rep['errors']} or "
                             f"rnn_decode launches {rep['launches']} "
                             f"(expected {want})")
    if leg:
        check_tokens(torch, ATT, "continuous vs static",
                     reps["continuous"]["tokens_by_request"],
                     reps["static"]["tokens_by_request"], cpu_model, prompts)
        check_tokens(torch, ATT, "speculative vs greedy",
                     reps["speculative"]["tokens_by_request"],
                     reps["greedy"]["tokens_by_request"], cpu_model,
                     sp_prompts)
        c, s = reps["continuous"], reps["static"]
        g, sp = reps["greedy"], reps["speculative"]
        emit({"decode_summary": {
            "speedup_vs_static": c["decode_tokens_per_sec"]
            / s["decode_tokens_per_sec"],
            "speedup_spec_vs_greedy": sp["decode_tokens_per_sec"]
            / g["decode_tokens_per_sec"],
            "acceptance_rate": sp.get("acceptance_rate"),
            "tokens_per_step": sp.get("tokens_per_step"),
            "continuous_equals_static": True,
            "speculative_equals_greedy": True, "card": smi}})
    return path_counts, model


def run_cpu_decode(model, prompts, mns, **kw):
    from mxnet_tpu_torch import serving
    rep = serving.run_decode(model, prompts, mns, ladder=DECODE_LADDER,
                             page_size=DECODE_PAGE, warmup=False, **kw)
    return rep["tokens_by_request"]


def profile_decode_step(torch, np, model, smi, bucket=8, iters=5):
    """``--profile``: where a decode step's time goes in decode_wide.
    Eight requests are seated (each prefill chunk dispatched and retired
    alone, host clock), then ``iters`` bucket-8 decode steps, each
    retired: timed by the host clock, then under ``cProfile`` (the host
    functions with the most own time), then under ``torch.profiler``
    (device time by kernel family per step, and the device's busy share
    of the wall time)."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.serving import DecodeEngine

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step_once()
        eng.sync()
        return (time.perf_counter() - t0) * 1e3

    eng = DecodeEngine(model, ladder=DECODE_LADDER, page_size=DECODE_PAGE,
                       max_context=80, start=False)
    try:
        eng.warmup()
        rng = np.random.RandomState(11)
        for _ in range(bucket):
            eng.submit(rng.randint(0, model.vocab, size=8), max_new=60)
        prefill_ms, steps = [], 0
        while any(o is None or o.phase != "decode" or o.generated < 1
                  for o in eng._occupant):
            before = eng.stats["prefill_chunks"]
            ms = timed_step()
            if eng.stats["prefill_chunks"] > before:
                prefill_ms.append(ms)
        decode_ms = [timed_step() for _ in range(iters)]
        prof_host = cProfile.Profile()
        prof_host.enable()
        for _ in range(iters):
            eng.step_once()
            eng.sync()
        prof_host.disable()
        stats = pstats.Stats(prof_host)
        host_top = sorted(
            ((f"{os.path.basename(k[0])}:{k[1]}:{k[2]}", v[1], v[2])
             for k, v in stats.stats.items()), key=lambda r: -r[2])[:12]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                eng.step_once()
                eng.sync()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        steps = eng.stats["steps"]
    finally:
        eng.close()
    families = device_us_by_family(torch, prof)
    busy = sum(families.values())
    top = sorted(device_us_by_kernel(torch, prof).items(),
                 key=lambda kv: -kv[1])[:8]
    emit({"decode_profile": {
        "bucket": bucket, "iters": iters, "steps_run": steps,
        "prefill_chunk_ms": prefill_ms,
        "decode_step_ms": decode_ms,
        "host_top_own_ms_per_step": [[name, calls // iters,
                                      own * 1e3 / iters]
                                     for name, calls, own in host_top],
        "wall_ms_per_step_under_profiler": wall_us / iters / 1e3,
        "device_ms_per_step": {k: v / iters / 1e3
                               for k, v in families.items()},
        "top_kernels_ms_per_step": [[k[:80], v / iters / 1e3]
                                    for k, v in top],
        "device_busy_share": busy / wall_us if busy else
        "not measured (the profiler saw no device time)", "card": smi}})


# ---------------------------------------------------------------------------
# kernel 12 (opt_update) and the ZeRO-1 update: phases 3, 10 and 11
# ---------------------------------------------------------------------------

#: the opt_update checks' lengths: ragged, BERT-base's word-embedding
#: shard at dp 4 (30,522 x 768 / 4) and its bucket unit (the 114
#: parameters under 2048 elements, concatenated)
OPT_RAGGED, OPT_EMBED_SHARD, OPT_BUCKET = 5000, 30522 * 768 // 4, 88322
#: (code, optimizer kind, rule constants)
OPT_KINDS = (("sgd", "sgd", {"momentum": 0.0}),
             ("sgd_mom", "sgd", {"momentum": 0.9}),
             ("adam", "adam", {"beta1": 0.9, "beta2": 0.999,
                               "epsilon": 1e-8}))
#: bfloat16 outputs, kernel vs plain: one or two bf16 ulps of O(1) values
OPT_BF16_TOL = 2e-2
#: phases 10 and 11: BERT-base's widths, the ZeRO layout at dp 4, ten Adam
#: steps at lr 1e-5 at batch 32 x sequence 512
BERT_BASE = dict(units=768, hidden_size=3072, num_layers=12, num_heads=12)
BERT_BASE_CLASSIFIER_PARAMS = 109_483_778
ZERO_SHARDS, ZERO_UNITS = 4, 88
#: phase 10's weights, sharded kernel updates vs eager ``trainer.step``:
#: the same float32 Adam rule, but the eager one takes 1 - b1**t in double
#: and the kernel a float32 powf, so the updates part by a few ulps
ZERO_WEIGHT_RTOL, ZERO_WEIGHT_ATOL = 1e-6, 1e-7
#: phase 11's first loss against a one-card forward of the same weights
ZERO_LOSS_ATOL = 1e-5


def opt_case(torch, dev, code, n, dtype, vec, seed):
    """Inputs of one opt_update check: w, g, the states, (lr, wd, t)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_states = {"sgd": 0, "sgd_mom": 1, "adam": 2}[code]
    w = torch.randn(n, generator=g, device=dev).to(dtype)
    grad = (torch.randn(n, generator=g, device=dev) * 3).to(dtype)
    states = tuple((torch.rand(n, generator=g, device=dev) * 0.1).to(dtype)
                   for _ in range(n_states))
    if vec:
        hp = (torch.rand(n, generator=g, device=dev) * 0.1,
              torch.rand(n, generator=g, device=dev) * 0.01,
              torch.randint(1, 5, (n,), generator=g, device=dev,
                            dtype=torch.int32))
    else:
        hp = (0.05, 0.01, 3)
    return w, grad, states, hp


def opt_weight_ulps(torch, got, ref, w_in):
    """Max |got - ref| in float32 ulps of max(|w_in|, |ref|)."""
    scale = torch.maximum(w_in.float().abs(), ref.float().abs())
    ulp = torch.nextafter(scale, torch.full_like(scale, math.inf)) - scale
    return float(((got.float() - ref.float()).abs() / ulp).max())


def check_opt_kernel(torch, KO, dev):
    """Phase 3, kernel 12: every kind x clip x scalar/vector
    hyperparameters x dtype at a ragged length, every kind x clip x dtype
    at the word-embedding shard (scalar) and at the bucket unit (vector).
    float32: new states bit-exact, the weight within 1 ulp; bfloat16
    within OPT_BF16_TOL. Returns the timed cases by dtype (Adam, the
    word-embedding shard)."""
    failures, timed, seed = [], {}, 0
    worst = {"float32_weight_ulps": 0.0, "float32_state_max_abs_err": 0.0,
             "bfloat16_max_abs_err": 0.0}
    for n, vecs in ((OPT_RAGGED, (False, True)), (OPT_EMBED_SHARD, (False,)),
                    (OPT_BUCKET, (True,))):
        for code, kind, extra in OPT_KINDS:
            for clip in (False, True):
                for vec in vecs:
                    for dtype in (torch.float32, torch.bfloat16):
                        seed += 1
                        w, g, st, (lr, wd, t) = opt_case(
                            torch, dev, code, n, dtype, vec, seed)
                        cfg = dict(extra, has_clip=clip)
                        pw, ps = KO.unit_update_plain(
                            kind, cfg, w, g, lr, wd, t, 0.25, 0.5, st)
                        kw, ks = w.clone(), tuple(s.clone() for s in st)
                        KO.unit_update(kind, cfg, kw, g, lr, wd, t, 0.25,
                                       0.5, ks)
                        torch.cuda.synchronize()
                        err = max(float((a.float() - b.float()).abs().max())
                                  for a, b in [(kw, pw)] + list(zip(ks, ps)))
                        dn = str(dtype).replace("torch.", "")
                        rec = {"kernel": "opt_update", "dtype": dn,
                               "kind": code, "n": n, "clip": clip,
                               "vector_hparams": vec, "max_abs_err": err}
                        if dtype == torch.float32:
                            ulps = opt_weight_ulps(torch, kw, pw, w)
                            st_err = max([float((a - b).abs().max())
                                          for a, b in zip(ks, ps)] or [0.0])
                            rec.update(weight_ulps=ulps,
                                       state_max_abs_err=st_err,
                                       ok=ulps <= 1 and st_err == 0.0)
                            worst["float32_weight_ulps"] = max(
                                worst["float32_weight_ulps"], ulps)
                            worst["float32_state_max_abs_err"] = max(
                                worst["float32_state_max_abs_err"], st_err)
                        else:
                            rec.update(atol=OPT_BF16_TOL, rtol=OPT_BF16_TOL,
                                       ok=all(compare(
                                           torch, a, b, OPT_BF16_TOL,
                                           OPT_BF16_TOL)[0] for a, b in
                                           [(kw, pw)] + list(zip(ks, ps))))
                            worst["bfloat16_max_abs_err"] = max(
                                worst["bfloat16_max_abs_err"], err)
                        emit({"check": rec})
                        if not rec["ok"]:
                            failures.append(rec)
                        if (n, code, clip, vec) == (
                                OPT_EMBED_SHARD, "adam", False, False):
                            timed[dn] = (rec, (w, g, st, (lr, wd, t)))
    emit({"opt_update_worst": worst})
    if failures:
        raise SystemExit(f"opt_update checks failed: {failures}")
    return timed


def time_opt_kernel(torch, KO, timed):
    """Kernel, plain-version and ``torch._fused_adam_`` times of one Adam
    update of the word-embedding shard in each dtype, by CUDA-graph replay
    over copies larger than the L2. Bound: w, g, m, v read once and w, m,
    v written once (28 B an element in float32, 14 in bfloat16) against
    ~20 float32 operations an element. Returns {("opt_update", dtype):
    timing}."""
    return dict(time_opt_case(torch, KO, dn, *case)
                for dn, case in timed.items())


def time_opt_case(torch, KO, dn, rec, args):
    w, g, st, (lr, wd, t) = args
    n = w.numel()
    cfg = dict(OPT_KINDS[2][2], has_clip=False)
    sets = [(w.clone(), g, tuple(s.clone() for s in st),
             torch.full((), float(t), device=w.device))
            for _ in range(n_sets(torch, (w, g) + st))]
    lib_err = None

    def library(w_, g_, st_, step_):
        torch._fused_adam_([w_], [g_], [st_[0]], [st_[1]], [], [step_],
                           lr=lr, beta1=0.9, beta2=0.999, weight_decay=wd,
                           eps=1e-8, amsgrad=False, maximize=False)

    fns = (lambda w_, g_, st_, s_: KO.unit_update(
               "adam", cfg, w_, g_, lr, wd, t, 0.25, 0.0, st_),
           lambda w_, g_, st_, s_: KO.unit_update_plain(
               "adam", cfg, w_, g_, lr, wd, t, 0.25, 0.0, st_),
           library)
    (ms, eager_ms), (plain_ms, plain_eager_ms) = (
        time_ms(torch, fn, sets) for fn in fns[:2])
    try:
        library_ms, library_eager_ms = time_ms(torch, fns[2], sets)
    except Exception as e:    # the yardstick only: the port never calls it
        library_ms = library_eager_ms = None
        lib_err = f"{type(e).__name__}: {e}"[:300]
    nbytes = 7 * w.element_size() * n
    b_ms, b_by = bound_ms(nbytes, 20.0 * n, "float32")
    t_rec = {"kernel": "opt_update", "dtype": dn, "shape": [n],
             "max_abs_err": rec["max_abs_err"], "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "library": "torch._fused_adam_ (torch.optim's fused Adam; "
                        "wd decoupled from the gradient there, the same "
                        "bytes)", "library_error": lib_err,
             "bound_ms": b_ms, "bound_by": b_by, "eager_ms": eager_ms,
             "plain_eager_ms": plain_eager_ms,
             "library_eager_ms": library_eager_ms, "bytes": nbytes,
             "flops": 20.0 * n}
    emit({"timing": t_rec})
    return ("opt_update", dn), t_rec


def bert_base_classifier(torch, seq, device, widths=None):
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, BERTModel
    return BERTClassifier(BERTModel(max_length=seq, dropout=0.0,
                                    device=device, **(widths or BERT_BASE)),
                          num_classes=2, dropout=0.0, device=device)


def zero_layout(torch, np, K, dev, smi, widths=None, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, steps=TRAIN_STEPS):
    """Phase 10: BERT-base's ZeRO-1 update on one card. One backward at
    batch x seq gives a fixed set of gradients; the port's plan at
    ZERO_SHARDS shards; ``steps`` Adam updates (lr 1e-5) through
    ``Optimizer.kernel_step_fn()`` on every shard of every unit in turn
    (what the ranks each do), reassembled; against ``steps`` eager
    ``trainer.step`` updates of a copy with the same gradients."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.fused_step import _ZeroShardPlan
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params

    t0 = time.perf_counter()
    nets = [bert_base_classifier(torch, seq, dev, widths) for _ in range(2)]
    init = init_params_numpy(nets[0], seed=2)
    for net in nets:
        load_jax_params(net, init)
    n_params = sum(p.numel() for p in nets[0].parameters())
    trainers = [Trainer(dict(net.named_parameters()), "adam",
                        {"learning_rate": TRAIN_LR}) for net in nets]
    rs = np.random.RandomState(3)
    vocab = nets[0].bert.word_embed.weight.shape[0]
    x = torch.from_numpy(rs.randint(0, vocab, (batch, seq))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (batch,))
                         .astype(np.float32)).to(dev)
    loss = SoftmaxCrossEntropyLoss()(nets[0](x), y)
    grads = [g.detach() for g in torch.autograd.grad(
        loss.sum(), trainers[0]._params)]
    del loss
    tz, te = trainers
    opt = tz.optimizer
    plan = _ZeroShardPlan(tz._params, opt, ZERO_SHARDS)
    states = [plan.create_states(opt, r) for r in range(ZERO_SHARDS)]
    fn = opt.kernel_step_fn()
    n = len(tz._params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    K.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        opt.rescale_grad = 1.0 / batch
        lrs, wds, ts = opt.begin_fused_step(list(range(n)))
        ulrs, uwds, uts = plan.pack_hparams(opt, lrs, wds, ts)
        for k, u in enumerate(plan.units):
            s = plan.shard_len(k)
            full = torch.empty(u["padded"], dtype=u["upd_dtype"], device=dev)
            for r in range(ZERO_SHARDS):
                w_sh = plan.copy_shard(k, tz._params, r, full[r * s:
                                                               (r + 1) * s])
                g_sh = plan.copy_shard(k, grads, r, torch.empty_like(w_sh))
                fn((w_sh,), (g_sh,),
                   [plan.shard_hparam(k, ulrs[k], r, dev)],
                   [plan.shard_hparam(k, uwds[k], r, dev)],
                   [plan.shard_hparam(k, uts[k], r, dev)],
                   np.float32(opt.rescale_grad), np.float32(0.0),
                   (states[r][k],))
            plan.write_unit(k, full)
    torch.cuda.synchronize()
    zero_s = time.perf_counter() - t1
    counts = K.launch_counts()

    for _ in range(steps):
        for p, g in zip(te._params, grads):
            p.grad = g.clone()
            p.fresh_grad = True
        te.step(batch)
    torch.cuda.synchronize()
    worst, worst_name = 0.0, None
    for (name, pz), pe in zip(nets[0].named_parameters(),
                              nets[1].parameters()):
        err = (pz.detach() - pe.detach()).abs()
        bound = ZERO_WEIGHT_ATOL + ZERO_WEIGHT_RTOL * pe.detach().abs()
        ratio = float((err / bound).max())
        if ratio > worst:
            worst, worst_name = ratio, name
    unsharded = sum(2 * 4 * p.numel() for p in tz._params)
    per_rank = [sum(s.numel() * s.element_size() for st in sts for s in st)
                for sts in states]
    expect = len(plan.units) * ZERO_SHARDS * steps
    report = {
        "model": "bert_base classifier", "params": n_params,
        "params_expected": BERT_BASE_CLASSIFIER_PARAMS if widths is None
        else n_params, "n_shards": ZERO_SHARDS, "units": len(plan.units),
        "units_expected": ZERO_UNITS if widths is None else len(plan.units),
        "bucket_unit_elements": max(u["total"] for u in plan.units
                                    if len(u["members"]) > 1),
        "steps": steps, "grad_batch": batch, "grad_seq": seq,
        "launches": counts["opt_update"], "launches_expected": expect,
        "worst_weight_err_over_bound": worst, "worst_param": worst_name,
        "rtol": ZERO_WEIGHT_RTOL, "atol": ZERO_WEIGHT_ATOL,
        "state_bytes_per_rank": per_rank, "state_bytes_unsharded": unsharded,
        "sharded_update_s": zero_s, "setup_s": setup_s, "card": smi}
    report["ok"] = (report["params"] == report["params_expected"]
                    and report["units"] == report["units_expected"]
                    and report["launches"] == expect and worst <= 1.0)
    emit({"zero_layout": report})
    if not report["ok"]:
        raise SystemExit(f"ZeRO layout phase failed: {report}")
    return counts


def zero_rank(widths, batch, seq, steps, lr):
    """Phase 11, one rank: BERT-base through ``TrainLoop`` under
    ``make_mesh({"dp": world})`` on the global batch (each rank keeps its
    contiguous 1/world), dropout 0, ten Adam steps. Returns the rank's
    facts; rank 0 also holds a one-card forward of the initial weights on
    the whole batch, for the first loss."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon import Trainer, TrainLoop
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.parallel import dist, make_mesh
    import torch.distributed as tdist

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dist.device()
    rank, world = dist.rank(), dist.size()
    net = bert_base_classifier(torch, seq, dev, widths)
    load_jax_params(net, init_params_numpy(net, seed=2))
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = torch.from_numpy(rs.randint(0, vocab, (batch, seq))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (batch,))
                         .astype(np.float32)).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    ref = None
    if rank == 0:
        with torch.no_grad():
            ref = loss_fn(net(x), y).float().cpu().numpy()
    # the rank's forward + backward alone (no reduction, no update), so
    # the step's remainder is the ZeRO reduction and update
    per = batch // world
    xl, yl = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    fb_ms = []
    for _ in range(4):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss_fn(net(xl), yl).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        fb_ms.append((time.perf_counter() - t0) * 1e3)
    for p in net.parameters():
        p.grad = None
    trainer = Trainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": lr})
    losses, step_ms, per_step = [], [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with make_mesh({"dp": world}):
        loop = TrainLoop(net, trainer, loss_fn)
        K.reset_launch_counts()
        for _ in range(steps):
            before = K.launch_counts()["opt_update"]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            losses.append(loop.step(x, y))
            loop.synchronize()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append(K.launch_counts()["opt_update"] - before)
    step = loop.compiled_step
    first = losses[0].float().contiguous()
    gathered = [torch.empty_like(first) for _ in range(world)]
    tdist.all_gather(gathered, first)
    same = weights_equal_all_ranks(torch, net)
    eager = eager_rank_step(torch, net, loss_fn, x, y)
    return {"rank": rank, "world": world, "zero_sharded": step.zero_sharded,
            "losses": [float(l.float().mean()) for l in losses],
            "first_losses_global": torch.cat(gathered).cpu().numpy()
            if rank == 0 else None, "one_card_first_losses": ref,
            "step_ms": step_ms, "opt_update_per_step": per_step,
            "fwd_bwd_ms": statistics.median(fb_ms[1:]),
            "units": len(step.zero_plan.units),
            "state_bytes": step.optimizer_state_bytes(),
            "state_bytes_unsharded": sum(2 * 4 * p.numel()
                                         for p in trainer._params),
            "weights_equal_all_ranks": same, "eager": eager,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None}


def weights_equal_all_ranks(torch, net):
    """Whether every rank holds rank 0's parameters bit for bit (the
    answer is the same on every rank)."""
    import torch.distributed as tdist
    same = True
    for p in net.parameters():
        q = p.detach().clone()
        tdist.broadcast(q, 0)
        same = same and bool(torch.equal(q, p.detach()))
    flag = torch.tensor([1 if same else 0], device=p.device)
    tdist.all_reduce(flag, op=tdist.ReduceOp.MIN)
    return bool(flag.item())


def eager_rank_step(torch, net, loss_fn, x, y, lr=0.1):
    """Phase 11's eager leg, one rank: ``loss.backward()`` on the rank's
    rows of the global batch, then ``Trainer.allreduce_grads()`` under
    the dp mesh and ``Trainer.update`` (together what ``Trainer.step``
    does, here with a look at the reduced gradients between them), SGD.
    Rank 0 first runs a backward of the whole batch on its card; each
    parameter's reduced gradient is held against it within GRAD_ATOL +
    GRAD_RTOL x its largest |gradient| (the sum over ranks is taken in
    another order), and the ranks' weights must end equal bit for bit."""
    import torch.distributed as tdist
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.parallel import dist, make_mesh
    rank, world = dist.rank(), dist.size()
    params = dict(net.named_parameters())
    ref = None
    if rank == 0:
        loss_fn(net(x), y).sum().backward()
        ref = {k: p.grad.detach().clone() for k, p in params.items()}
    per = x.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    trainer = Trainer(params, "sgd", {"learning_rate": lr})
    worst, worst_name = 0.0, None
    with make_mesh({"dp": world}):
        loss_fn(net(x[rows]), y[rows]).sum().backward()
        trainer.allreduce_grads()
        if ref is not None:
            for k, p in params.items():
                err = float((p.grad - ref[k]).abs().max())
                ratio = err / (GRAD_ATOL
                               + GRAD_RTOL * float(ref[k].abs().max()))
                if not math.isfinite(ratio) or ratio > worst:
                    worst, worst_name = ratio, k
        trainer.update(x.shape[0])
    return {"grad_worst_err_over_bound": worst, "grad_worst_param":
            worst_name, "weights_equal_all_ranks":
            weights_equal_all_ranks(torch, net)}


def zero_train_multi(torch, np, smi, device="cuda", world=None, widths=None,
                     batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                     timeout_s=600):
    """Phase 11: ZeRO-1 training across the visible cards, one rank a
    card over NCCL (``parallel.dist.spawn``). Gates: the sharded update
    on, finite losses falling, every rank's weights equal bit for bit,
    exactly one opt_update launch a unit a step, the first step's losses
    equal a one-card forward's within ZERO_LOSS_ATOL, each rank's Adam
    state ~1/world of the unsharded; and in the eager leg
    (:func:`eager_rank_step`) every reduced gradient within its bound and
    the ranks' weights equal after the update."""
    from mxnet_tpu_torch.parallel import dist
    world = world or torch.cuda.device_count()
    if device == "cuda":
        topo = subprocess.run(["nvidia-smi", "topo", "-m"],
                              capture_output=True, text=True)
        print(topo.stdout + topo.stderr, flush=True)
        # where nvidia-smi cannot draw the matrix: peer access between the
        # cards (NVLink or PCIe peer-to-peer) from the runtime
        peer = [[i == j or torch.cuda.can_device_access_peer(i, j)
                 for j in range(world)] for i in range(world)]
        emit({"peer_access": peer})
    ranks = dist.spawn(zero_rank, world, device,
                       (widths, batch, seq, steps, TRAIN_LR),
                       timeout_s=timeout_s)
    r0 = ranks[0]
    first_err = float(np.abs(r0["first_losses_global"]
                             - r0["one_card_first_losses"]).max())
    median = statistics.median(max(r["step_ms"][i] for r in ranks)
                               for i in range(1, steps))
    report = {
        "model": "bert_base classifier", "world": world, "batch": batch,
        "seq": seq, "steps": steps, "optimizer": "adam",
        "learning_rate": TRAIN_LR, "dropout": 0.0,
        "zero_sharded": all(r["zero_sharded"] for r in ranks),
        "losses_rank0": r0["losses"], "units": r0["units"],
        "opt_update_per_step": [r["opt_update_per_step"] for r in ranks],
        "first_loss_max_abs_err_vs_one_card": first_err,
        "first_loss_atol": ZERO_LOSS_ATOL,
        "weights_equal_all_ranks": all(r["weights_equal_all_ranks"]
                                       for r in ranks),
        "eager_grad_worst_err_over_bound":
            r0["eager"]["grad_worst_err_over_bound"],
        "eager_grad_worst_param": r0["eager"]["grad_worst_param"],
        "eager_weights_equal_all_ranks": all(
            r["eager"]["weights_equal_all_ranks"] for r in ranks),
        "state_bytes_per_rank": [r["state_bytes"] for r in ranks],
        "state_bytes_unsharded": r0["state_bytes_unsharded"],
        "step_ms_rank0": r0["step_ms"], "median_step_ms": median,
        "fwd_bwd_ms_per_rank": [r["fwd_bwd_ms"] for r in ranks],
        "reduce_and_update_ms": median - max(r["fwd_bwd_ms"]
                                             for r in ranks),
        "global_tokens_per_s": batch * seq / (median / 1e3),
        "max_memory_allocated_per_rank": [r["max_memory_allocated"]
                                          for r in ranks],
        "card": smi}
    share = max(report["state_bytes_per_rank"]) \
        / report["state_bytes_unsharded"]
    report["state_share_per_rank"] = share
    losses = r0["losses"]
    report["ok"] = (report["zero_sharded"]
                    and all(math.isfinite(v) for r in ranks
                            for v in r["losses"])
                    and losses[-1] < losses[0]
                    and report["weights_equal_all_ranks"]
                    and r0["units"] == (ZERO_UNITS if widths is None
                                        else r0["units"])
                    and all(c == r0["units"] for r in ranks
                            for c in r["opt_update_per_step"])
                    and first_err <= ZERO_LOSS_ATOL
                    and share <= 1.01 / world
                    and report["eager_grad_worst_err_over_bound"] <= 1.0
                    and report["eager_weights_equal_all_ranks"])
    emit({"zero_train": report})
    if not report["ok"]:
        raise SystemExit(f"ZeRO training phase failed: {report}")
    return report


#: --kernel-times: the kernels' shapes, each on its path (the flash
#: forward served and in BERT training; the long-sequence backward's dq
#: and dkv at phase 7's; the LM's LSTM layer; decode_wide's step)
AB_FLASH = ((32, 12, 128, 128, 64), (32, 12, 512, 512, 64))
AB_FLASH_BWD = (LONG_BATCH, 12, LONG_SEQ, LONG_SEQ, 64)
#: --kernel-times: phase 7's training steps timed after one warm-up step
AB_LONG_STEPS = 5
#: --kernel-times: one LSTM shape each recurrence wrapper refused before
#: this slice: (wrapper, T or None for decode, N, H)
AB_REFUSED = (("rnn_scan_fwd",) + RNN_REFUSED["forward"],
              ("rnn_scan_bwd",) + RNN_REFUSED["walk"],
              ("rnn_decode_step", None, 128, 650))


def kernel_times(root):
    """``--kernel-times ROOT``: build the kernels of the package under
    ROOT (another checkout, for an A/B on one card) and print one
    ``{"kernel_times": ...}`` line: device ms by CUDA-graph replay of the
    flash forward, the long-sequence backward's dq and dkv kernels, the
    recurrence forward and backward and the decode step at their paths'
    shapes, float32 and bfloat16 (the decode step float32), the median
    wall ms of phase 7's training step (host clock, each step ends in a
    synchronize),
    and what each wrapper does at the AB_REFUSED shapes (ran, then timed
    the same way, or the error it raised: a probe, not a path)."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from mxnet_tpu_torch.ops import attention as ATT
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.ops.kernels import rnn_scan as KR
    torch.backends.cuda.matmul.allow_tf32 = False
    K.build_library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

    out = {"root": root, "package": os.path.dirname(ATT.__file__)}

    def zeros(*shape):
        return torch.zeros(*shape, device=dev)

    probes = []
    for name, n_t, n, h in AB_REFUSED:
        w, b, st = zeros(4 * h, h), zeros(4 * h), zeros(n, h)
        if name == "rnn_decode_step":
            fn, args = KR.rnn_decode_step, (zeros(n, 4 * h), st, st, w, b)
        elif name == "rnn_scan_fwd":
            fn, args = KR.rnn_scan_fwd, (zeros(n_t, n, 4 * h), st, st, w, b)
        else:
            ys = zeros(n_t, n, h)
            fn, args = KR.rnn_scan_bwd, (zeros(n_t, n, 4 * h), st, st, w, b,
                                         ys, ys, ys, st)
        rec = {"wrapper": name, "lstm_t_n_h": [n_t, n, h]}
        try:
            fn(*args, "lstm")
            torch.cuda.synchronize()
        except Exception as e:    # the probe records what the parent raised
            probes.append(dict(rec, result=f"raised {type(e).__name__}: {e}"))
            continue
        rec["device_ms"] = time_ms(torch, lambda *a: fn(*a, "lstm"), [args],
                                   iters=3, replays=2)[0]
        probes.append(dict(rec, result="ran"))
        del args
    out["refused_shapes"] = probes
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for b, h, sq, sk, d in AB_FLASH:
            args = (rnd(b, h, sq, d, dtype=dtype), rnd(b, h, sk, d, dtype=dtype),
                    rnd(b, h, sk, d, dtype=dtype))
            sets = [tuple(t.clone() for t in args)
                    for _ in range(n_sets(torch, args + args[:1]))]
            times[f"flash_fwd {dn} {[b * h, sq, sk, d]}"] = time_ms(
                torch, lambda *a: ATT.flash_attention_fwd(*a), sets)[0]
            del args, sets
        b, h, sq, sk, d = AB_FLASH_BWD
        q, do = rnd(b, h, sq, d, dtype=dtype), rnd(b, h, sq, d, dtype=dtype)
        k, v = rnd(b, h, sk, d, dtype=dtype), rnd(b, h, sk, d, dtype=dtype)
        o, lse = ATT.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        sets = [tuple(t.clone() for t in (q, k, v, do)) + (lse, delta)
                for _ in range(n_sets(torch, (q, k, v, do, q, k, v)))]
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            times[f"{name} {dn} {[b * h, sq, sk, d]}"] = time_ms(
                torch, lambda *a, fn=getattr(ATT, name): fn(
                    *a, False, d ** -0.5), sets)[0]
        del q, k, v, do, o, lse, delta, sets
        n_t, n, h = RNN_TIMED
        xw, h0, c0 = rnd(n_t, n, 4 * h, dtype=dtype, s=0.5), \
            rnd(n, h, dtype=dtype, s=0.5), rnd(n, h, dtype=dtype, s=0.5)
        w, b = rnd(4 * h, h, dtype=dtype, s=0.5 * h ** -0.5), \
            rnd(4 * h, dtype=dtype, s=0.1)
        sets = [(xw.clone(), h0, c0, w, b)
                for _ in range(n_sets(torch, (xw, xw)))]
        times[f"rnn_scan_fwd {dn} {list(RNN_TIMED)}"] = time_ms(
            torch, lambda *a: KR.rnn_scan_fwd(*a, "lstm"), sets, iters=10)[0]
        ys, cs = KR.rnn_scan_fwd(xw, h0, c0, w, b, "lstm")
        dys = rnd(n_t, n, h, dtype=dtype)
        sets = [(xw.clone(), h0, c0, w, b, ys, cs, dys.clone(), c0)
                for _ in range(n_sets(torch, (xw, xw, ys, cs, dys)))]
        times[f"rnn_scan_bwd {dn} {list(RNN_TIMED)}"] = time_ms(
            torch, lambda *a: KR.rnn_scan_bwd(*a, "lstm"), sets, iters=10)[0]
        del xw, sets, ys, cs, dys
    n, h = DECODE_TIMED[0]
    xw, hh, cc = rnd(n, 4 * h, s=0.5), rnd(n, h, s=0.5), rnd(n, h, s=0.5)
    w, b = rnd(4 * h, h, s=0.5 * h ** -0.5), rnd(4 * h, s=0.1)
    sets = [(xw, hh, cc, w.clone(), b) for _ in range(n_sets(torch, (w,)))]
    times[f"rnn_decode float32 {[n, h]}"] = time_ms(
        torch, lambda *a: KR.rnn_decode_step(*a, "lstm"), sets, iters=50)[0]
    out["device_ms"] = times
    _, _, x, y, _, step = long_setup(torch, np, dev)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    wall = run_train_steps(torch, K, step, x, y, AB_LONG_STEPS + 1)[1]
    out["wall_ms"] = {"train_long step (median of "
                      f"{AB_LONG_STEPS} after a warm-up)":
                      statistics.median(wall[1:])}
    emit({"kernel_times": out})
    return 0


def compare_checkouts(parent):
    """``--compare PARENT``: ``--kernel-times`` of PARENT (a checkout of
    the parent commit, unpacked under build/) and of this checkout, in
    turns on this card (parent, change, change, parent), each in its own
    process; prints one ``{"compare": ...}`` line with both runs of each."""
    runs = []
    for root in (parent, ".", ".", parent):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--kernel-times", root], capture_output=True,
                             text=True)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith('{"kernel_times"')]
        if res.returncode != 0 or not line:
            raise SystemExit(f"--kernel-times {root} failed:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        runs.append((root, json.loads(line[0])["kernel_times"]))
    table = {}
    for root, r in runs:
        side = "parent" if root == parent else "change"
        for kind in ("device_ms", "wall_ms"):
            for key, ms in r[kind].items():
                table.setdefault(kind, {}).setdefault(
                    key, {"parent": [], "change": []})[side].append(ms)
    emit({"compare": {"order": [root for root, _ in runs], **table,
                      "refused_shapes": {("parent" if root == parent
                                          else "change"): r["refused_shapes"]
                                         for root, r in runs}}})
    return 0


def main(argv):
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if "--kernel-times" in argv:
        return kernel_times(argv[argv.index("--kernel-times") + 1])
    if "--compare" in argv:
        return compare_checkouts(argv[argv.index("--compare") + 1])
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import attention as ATT
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.ops.kernels import norm as KN
    from mxnet_tpu_torch.ops.kernels import opt_update as KO
    from mxnet_tpu_torch.ops.kernels import rnn_scan as KR

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count(),
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})
    dev = mx.default_device()

    # phase 2: build the kernel library from the sources in the checkout
    t0 = time.perf_counter()
    K.build_library(verbose="--ptxas" in argv)
    K.library()
    emit({"build_s": time.perf_counter() - t0})
    if "--zero-train" in argv:
        if torch.cuda.device_count() < 2:
            raise SystemExit("--zero-train needs two or more cards")
        zero_train_multi(torch, np, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    served_args = check_kernels(torch, ATT, KN, dev)
    timing = time_kernels(torch, F, ATT, KN, served_args)
    del served_args
    bwd_args = check_bwd_kernels(torch, ATT, K, KN, dev)
    timing.update(time_bwd_kernels(torch, F, ATT, KN, bwd_args))
    del bwd_args
    new_args = check_new_kernels(torch, K, KR, KN, dev)
    timing.update(time_new_kernels(torch, F, KR, KN, new_args))
    del new_args
    dec_args = check_decode_kernel(torch, K, KR, dev)
    dec_timing = time_decode_kernel(torch, KR, dec_args)
    del dec_args
    # the kernels line's row: the decode_wide shape (bucket 8, H 650)
    for dn in ("float32", "bfloat16"):
        timing[("rnn_decode", dn)] = dec_timing[("rnn_decode", dn)
                                                + DECODE_TIMED[0]]
    opt_timed = check_opt_kernel(torch, KO, dev)
    timing.update(time_opt_kernel(torch, KO, opt_timed))
    del opt_timed
    served, pred = serve_bert(torch, np, K, dev)
    if "--profile" in argv:
        profile_bucket(torch, np, pred)
    del pred
    encoder = run_encoder(torch, np, K, dev)
    trained = train_bert(torch, np, K, dev, smi, "--profile" in argv)
    trained_long = train_long(torch, np, K, dev)
    lstm = train_lstm(torch, np, K, dev, smi, "--profile" in argv)
    serve_decode(torch, np, K, ATT, dev, smi, DECODE_LEG, leg=True)
    decode_wide, wide_model = serve_decode(torch, np, K, ATT, dev, smi,
                                           DECODE_WIDE, leg=False)
    if "--profile" in argv:
        profile_decode_step(torch, np, wide_model, smi)
    del wide_model
    zero = zero_layout(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= 2:
        zero_train_multi(torch, np, smi)
    else:
        print("phase 11 (ZeRO training across cards) needs >= 2 GPUs; "
              f"{torch.cuda.device_count()} visible, so it did not run",
              flush=True)

    # each kernel's launches on the path that drives it, counted from 0
    path = {"flash_fwd": "bert_base_serving",
            "layernorm_fwd": "bert_base_serving",
            "bias_gelu_fwd": "transformer_encoder_gelu",
            "flash_bwd_fused": "bert_base_training",
            "layernorm_bwd": "bert_base_training",
            "flash_bwd_dq": "bert_width_training_seq1024",
            "flash_bwd_dkv": "bert_width_training_seq1024",
            "bias_gelu_bwd": "transformer_encoder_gelu",
            "rnn_scan_fwd": "lstm_lm_training",
            "rnn_scan_bwd": "lstm_lm_training",
            "rnn_decode": "decode_wide",
            "opt_update": "bert_base_zero_update_layout"}
    counts_of = {"bert_base_serving": served,
                 "transformer_encoder_gelu": encoder,
                 "bert_base_training": trained,
                 "bert_width_training_seq1024": trained_long,
                 "lstm_lm_training": lstm,
                 "decode_wide": decode_wide,
                 "bert_base_zero_update_layout": zero}
    launches = {name: counts_of[path[name]][name] for name in K.KERNELS}
    emit({"launch_counts": launches})
    if not all(n > 0 for n in launches.values()):
        raise SystemExit(f"a kernel never launched on its path: {launches}")
    rows = []
    for name, info in K.KERNELS.items():
        # every path runs in float32; bfloat16 times are on "timing" lines
        t = timing[(name, "float32")]
        rows.append({"name": name, "route": "cuda", "source": info.source,
                     "replaces": info.replaces, "launches": launches[name],
                     "path": path[name], "max_abs_err": t["max_abs_err"],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "shape": t["shape"],
                     "dtype": "float32"})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
