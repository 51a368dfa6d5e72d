#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

    python3 chip_smoke.py            # needs one CUDA device and nvcc
    python3 chip_smoke.py --profile  # also: wall, host and device time
                                     # of one served micro-batch (on its
                                     # captured program), of one BERT and
                                     # one LSTM LM train step (device
                                     # shares by kernel family), and of
                                     # one bucket-8 decode step
    python3 chip_smoke.py --ptxas    # also: nvcc's register and spill
                                     # report of every kernel
    python3 chip_smoke.py --zero-train  # phases 1, 2 and 11 alone, on
                                        # two or more cards (with A1's
                                        # BatchNorm leg)
    python3 chip_smoke.py --checkpoint  # phases 1, 2 and 6c alone
    python3 chip_smoke.py --elastic     # phases 1, 2 and 12 alone
    python3 chip_smoke.py --dist-kv     # phases 1, 2 and 13 alone (its
                                        # legs across cards on two or
                                        # more)
    python3 chip_smoke.py --resnet      # phases 1, 2 and 14 alone
    python3 chip_smoke.py --surface     # phases 1, 2 and 15 alone
    python3 chip_smoke.py --cells       # phases 1, 2 and 16 alone
    python3 chip_smoke.py --fleet       # phases 1, 2 and 17 alone (17b
                                        # on three or more cards)
    python3 chip_smoke.py --data        # phases 1, 2 and 18 alone
    python3 chip_smoke.py --telemetry   # phases 1, 2 and 19 alone
    python3 chip_smoke.py --analysis    # phases 1, 2 and 21 alone (21c
                                        # on four or more cards)
    python3 chip_smoke.py --analysis-zero  # phases 1, 2 and 21c alone
                                           # (four cards)
    python3 chip_smoke.py --ssd         # phases 1, 2 and 22 alone
    python3 chip_smoke.py --compare DIR  # A/B on one card: the flash
        # forward, the flash backward (fused at BERT training's shape;
        # dq, dkv at phase 7's), the recurrence kernels, the LayerNorm
        # forward (served and at BERT training's 16384 x 768) and
        # backward, the bias-GELU backward and the decode step (with the
        # launch floors of their plans' grids), phase
        # 7's step, the bf16 amp BERT step, the served bucket-32
        # micro-batch (wall and host ms, float32 and bf16) with phase
        # 4's req/s and the serving peak memory, and decode_wide's
        # prefill chunk and bucket-8 step ms, tokens/s and peak memory
        # of the checkout at DIR (e.g. the parent commit unpacked by
        # `git archive` under build/) and of this one, timed in turns
        # (DIR, this, this, DIR), with what each wrapper does at shapes
        # the first versions refused

Phases, each of which fails the run (non-zero exit) when it fails:

1. print the card's name and power limit, the torch and CUDA versions,
   and turn TF32 off for float32 products and convolutions;
2. build the CUDA kernel library from ``mxnet_tpu_torch/ops/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, with the tolerance printed beside the error, and
   time the kernel, the plain version and one PyTorch library call that
   computes the same function at the shapes of its path, in both dtypes
   (the LayerNorm forward served and at BERT training's 16384 x 768,
   with its plan's edges: one row, C 1, C 771, C 16,384, C 120,000, C at
   the warp branch's cap and one past it, and x offset by one element,
   each with its plan and one launch, run twice to show it repeats bit
   for bit, timed beside an empty kernel of its grid;
   the backward kernels at BERT-base training's B*H = 384, S = 512,
   D = 64, at the long-sequence phase's S = 1024, and LayerNorm at
   16384 x 768, with its plan's edges: C at the warp branch's cap and one
   past it, C 16,384, C 771, 3 rows and one row, each with its plan, one
   launch, and run twice to show dx, dgamma and dbeta repeat bit for bit;
   the flash forward's tile edges too: one position at D 1,
   Sq and Sk no multiple of a tile, causal with Sq < Sk and Sq > Sk, D 7,
   32, 80 and 128, S 512 causal and S 1024, each run twice to show it
   repeats bit for bit, and it is timed at BERT training's S 512 as well;
   the fused backward's tile edges: one position at D 1, one key, one
   query, D 128 causal at 512, 449 keys, D 7, each run twice to show dk
   and dv repeat bit for bit (bf16 on tensor cores, timed at BERT
   training's shape beside SDPA's bf16 backward); the dq and dkv kernels' edges
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
   4096 x 3072, an unaligned C, one row, C 1, C 16,384, x and dy offset
   by one element and a float32 b under bfloat16 x (db in b's dtype),
   each with its plan and one launch, run twice to show dx and db repeat
   bit for bit, timed beside an empty kernel of its grid; the decode
   step (``rnn_decode``)
   in every mode at N 3 x H 37, N 128 x H 650 (two row groups), N 2 x H
   4,096, N 8 x H 650 and N 8 x H 128, float32 and bfloat16 (bfloat16
   W_hh read as it is, equal bit for bit to its float32 widening), each
   with its plan, timed beside an empty kernel of its grid (the launch
   floor), plus 35 chained decode steps against the ``rnn_scan_fwd``
   kernel's trajectory at N 8 x H 650 (within 1e-6); and the fused
   optimizer update (``opt_update``) for SGD, SGD-momentum and Adam, clip
   on and off, hyperparameters as host scalars, per-element vectors and
   device scalars (lr, wd, t, rescale and clip read from a
   ``DeviceHParams`` block, the captured one-card step's form), float32
   and bfloat16, at 5000 elements, at BERT-base's word embedding
   (23,440,896; device scalars, as phase 6 runs it), at its shard at dp 4
   (5,860,224; host scalars, as phase 10 runs it) and at its bucket unit
   (88,322; vectors), and as ONE launch over a ragged list (1 to 88,322
   values, the last a view one element into a larger buffer; float32
   masters whose bfloat16 weights the launch writes) in each form:
   float32 states bit-exact and weights within 1 ulp,
   bfloat16 within 2e-2; the Adam update of the word embedding in the
   device form timed beside ``torch._fused_adam_`` in float32 and
   bfloat16; BERT-base's whole one-card float32 Adam update as the
   captured step runs it (one launch for its 201 parameters, each its
   own lr, wd and t in the block), held against the plain version
   parameter by parameter as above, and timed in a graph beside
   ``torch._fused_adam_`` over the same list and its bound
   (``bert_update_graph``);
4. serve BERT-base (12 x 768, vocab 30522, seeded random weights) through
   ``CompiledPredictor`` + ``DynamicBatcher``: ``warmup`` captures one
   CUDA graph per bucket (1-64; the capture seconds of each printed),
   each bucket's replay is held bit for bit against the net called
   eagerly on the same padded batch (``serving_graph_vs_eager``), then 8
   client threads send 96 requests of 1-8 rows at sequence length 128;
   check that every request resolved, that two requests match a CPU copy
   of the model, that each micro-batch launched 12 flash and 25
   LayerNorm kernels (counted through the replays), and that traffic
   captured nothing (``n_traces`` 7 after the warm-up and after the
   traffic); peak memory;
4b. the same traffic through ``serving.predictor_for(net,
   dtype="bfloat16")`` (every parameter but the LayerNorms' in bf16),
   the same captures and checks: every launch in bf16, two requests
   against a CPU copy converted the same way within 5e-2 of the largest
   logit; req/s, p50, p99;
5. run a 2-layer ``TransformerEncoder`` with the ``gelu`` FFN, so the
   bias-GELU kernels launch: a forward checked against a CPU copy, and a
   backward (exactly 2 ``bias_gelu_bwd`` launches) with the gradients of
   every parameter against the CPU copy;
6. train the BERT-base classifier (float32, dropout 0.1, batch 32 x
   sequence 512, Adam) for ten steps of ``Trainer.compile_step`` on one
   seeded batch, one captured CUDA graph replayed a step (``aot_compile``
   captures it first: its capture seconds, ``n_traces`` 1 after the
   warm-up and after the steps): every loss finite and the last below
   the first, exactly 12 flash forward, 12 fused flash backward, 25
   LayerNorm forward, 25 LayerNorm backward and one ``opt_update``
   launch (all 201 parameters) per step (counted through the replays), and one
   step's gradients of every parameter (batch 2 x 128, dropout off) against a
   CPU copy; then (``captured_vs_eager``) the captured step and the plain eager
   loop (``loss.sum().backward(); trainer.step(32)``) in turns from
   the same state (captured, eager, eager, captured: median step ms,
   tokens/s, peak allocated and reserved memory each), and the step's
   body run eagerly twice from that state: the replays' weights (rms)
   and losses within CKPT_SPREAD_FACTOR of the body runs' spread (dq
   atomics), and against the eager runs within CAPTURED_EAGER_RTOL of
   how far those moved (or twice the eager and body runs' spread), while
   a control run captured with its lr staged at twice the scheduler's
   must fail that gate (``vs_eager``, ``control_fails``);
6b. the same training under ``amp.init()`` (``amp.uninit()`` after it),
   captured and in turns as phase 6:
   finite falling losses, per step 12 ``flash_fwd`` and 12
   ``flash_bwd_fused`` launches in bf16 and 25 + 25 LayerNorm and one
   ``opt_update`` launch in float32 (counted by input dtype),
   parameters and gradients
   float32, the gradients against a CPU copy under amp within 2.5e-1 of
   each parameter's largest, and so against a float64 CPU copy of the
   same weights; each parameter's error to float64 (largest element and
   rms, the larger over three batches) on the card under amp, on the CPU
   under amp and on the CPU in float32, the five worst by the ratio card
   / CPU (``bf16_grad_vs_float64``); the bf16 ops against
   float64 on the same bf16 inputs, beside the CPU's result
   (``bf16_ops``): cuBLAS products at training's and the check's shapes
   with ``allow_bf16_reduced_precision_reduction`` on and off, the fused
   flash backward (dq, dk, dv) against an exact float64 backward and one
   rounding P and dS as the reference does, the flash forward's output,
   and dq's spread over five runs; median step ms, tokens/s, peak memory;
6c. phase 6's training through ``TrainLoop(checkpoint_dir=...,
   checkpoint_every=5)`` under ``build/chip_ckpt`` (removed after), in
   float32 and then converted to bf16 with Adam's ``multi_precision``
   (uint16 bf16 weights and float32 masters on disk): CKPT_RUNS
   uninterrupted ten-step runs; a run that saves at step 5 in the
   background and goes on two steps while the write is in flight; a
   fresh net, trainer and loop that resume and run steps 6-10. The
   checkpoint must equal a capture taken at step 5 and the restored state
   the checkpoint, bit for bit (parameters, states, masters, counts,
   scheduler, RNG); the resumed losses and final weights must lie within
   the uninterrupted runs' spread (``CKPT_SPREAD_FACTOR``; bit-equal where
   they are); the resumed steps launch phase 6's kernels exactly, on the
   captured step in float32 (one capture, one ``opt_update`` a step) and
   eagerly in bf16 + ``multi_precision`` (the JAX package's mode; one
   ``opt_update`` a step over the float32 masters, which writes the bf16
   weights). Then
   ``save_parameters`` of the resumed float32 net and ``load_parameters``
   into the net of a warmed ``CompiledPredictor``: bucket 32 bit-equal to
   that net called eagerly, changed by the load, ``n_traces`` unchanged.
   Prints capture ms, write s, checkpoint bytes, restore s and step ms
   with and without a write in flight;
7. train a 2-layer BERT-width classifier at sequence 1024 for six
   captured steps, so the flash backward takes its dq and dkv kernels
   (two launches each per step, none of the fused one; one
   ``opt_update`` a step), with its gradients against a CPU copy,
   and in turns against the eager loop as phase 6;
8. train the LSTM word LM (``model_zoo.word_lm.WordLM``: vocab 33,278,
   embed and hidden 650, 2 layers, float32) at batch 64 x bptt 35 for ten
   captured SGD-momentum steps of ``Trainer.compile_step`` on one seeded
   batch: every loss finite and the last below the first, exactly 2
   ``rnn_scan_fwd``, 2 ``rnn_scan_bwd`` and one ``opt_update`` launches
   per step, one step's gradients of all 11 parameters at batch 4
   against a CPU copy, and the turns of phase 6 with the replays
   bit-equal to the body runs (every kernel deterministic); then an
   eval-mode forward of the batch (``lstm_forward`` line) against the
   CPU copy;
8b. a Dense-only model (768 -> 3072 -> 768 -> 2, 4096 rows, three Adam
   steps) in the same turns: replays bit-equal to the body runs, one
   ``opt_update`` a step (``dense_train``);
9. serve autoregressive decode through ``serving.run_decode`` (the
   continuous-batching ``DecodeEngine``, slot ladder 1-8, page size 16,
   prefill chunk 16, one CUDA graph per (kind, bucket) captured by its
   ``warmup``) over the JAX package's decode mix (32 requests from
   RandomState(7)): ``decode_leg`` at ``TinyDecoder(256, 128, 4)``
   continuous, static, the speculative A/B (spec_k 4 with prefix sharing
   against plain greedy, 16 requests over a shared base) and the GQA
   decoder on 8 requests; ``decode_wide`` at the word LM's widths
   (vocab 33,278, d_model 650, 10 heads), continuous. First every
   decode, prefill and verify program's replay is held bit for bit
   against its body run eagerly from one random state
   (``*_graph_vs_eager``). Every run's tokens equal a CPU copy's,
   continuous = static and speculative = greedy request by request, 0
   errors, no program captured after the warm-up (``n_traces`` 0), and
   ``rnn_decode`` launches exactly one a decode step (spec_k + 1 a
   verify step) plus 16 a prefill chunk (0 for the GQA decoder); each
   run prints its captures and peak memory;
10. BERT-base's ZeRO-1 update layout on this card: one backward at batch
    32 x sequence 512 (dropout 0) gives fixed gradients; the port's
    ``_ZeroShardPlan`` at 4 shards (88 units); ten Adam updates (lr 1e-5)
    through ``Optimizer.kernel_step_fn()``, a rank's shards of every unit
    in one launch, reassembled, against ten eager ``trainer.step``
    updates of a copy (weights within 1e-6 relative + 1e-7 absolute),
    exactly 4 x 10 ``opt_update`` launches, and the state bytes a rank
    would hold;
    then bf16 + ``multi_precision`` (the model converted to bf16, its
    LayerNorms float32): every bf16 parameter an mp unit with float32
    master shards, three Adam updates through the kernel on the masters
    (one float32 launch a rank a step, which writes the bf16 weights),
    each weight equal to its gathered master in bf16, the masters
    against eager ``trainer.step``'s;
11. with two or more cards only (one line says so otherwise): BERT-base
    ZeRO-1 training, one rank a card over NCCL (``parallel.dist.spawn``),
    batch 32 x 512 global, ten Adam steps through ``TrainLoop`` under
    ``make_mesh({"dp": world})``: the sharded update on, falling finite
    losses, bit-equal weights on every rank, one ``opt_update`` launch a
    reduce group (a run of buckets of one dtype; one for float32
    BERT-base) a rank a step, the first step's loss on every rank the global
    batch's (32 values, all-gathered by the step) and within 1e-5 of a one-card
    forward's,
    the Adam state a rank ~1/world; step ms, global tokens/s, peak memory;
    then one eager step on each rank's rows (``loss.backward()``,
    ``Trainer.allreduce_grads()`` over NCCL, ``Trainer.update``): every
    reduced gradient against rank 0's backward of the whole batch (as
    phase 6's gradient check bounds it) and bit-equal weights after;
    the training loop checkpoints at step 5 (the shards gathered, rank 0
    writing), and half as many ranks resume that checkpoint and run steps
    6-10: the losses within ZERO_RESUME_RTOL of the full world's, one
    ``opt_update`` launch a reduce group a resumed step. Then four legs:
    (a) the ten steps again from one set of weights in turns serial
    (``MXNET_ZERO_BUCKET_BYTES=0``: one bucket reduced after the
    backward), overlapped (4 MiB buckets launched from the backward's
    gradient hooks), overlapped, serial: the median step ms of the
    slowest rank, peak memory a rank, forward / backward / after the
    backward ms from device events, one profiled overlapped step (the
    reduce-scatter's device ms and its share beside compute kernels),
    NCCL's reduce-scatter beside the step's at 4 MiB and at the whole
    model; gates: one ``opt_update`` a reduce group a rank a step, each
    overlapped run's
    weights (rms) and losses within CKPT_SPREAD_FACTOR of the serial
    runs' spread, a Dense-only model bit-equal in every bucketing; (b)
    ``loop.prefetch`` against plain steps over PREFETCH_STEPS host
    batches (step ms, ``input_wait_ms``, ``starvation_count``; losses
    within the plain runs' spread); (c) ``elastic.ElasticSupervisor`` at
    BERT-base's widths (ELASTIC_LAYERS layers), checkpoint_every=2,
    ``step.dispatch:before=6:revoke:2``: one ``device_lost`` event (dp 4
    -> 2, restored step 4), the run finished, its losses after the
    recovery within the spread of two uninterrupted dp-2 runs restored
    from the same checkpoint, ``downtime_s``; (d) a ``restore`` grows
    the run back to dp 4 through a planned re-form; (e) BatchNorm over the
    dp group (:func:`zero_batchnorm`): phase 14's resnet50_v1 on its 128 x
    224 x 224 images split over the ranks, three plain-SGD steps through
    ``compile_step``'s zero mode, against the same steps on one card:
    losses, every step's gradients and the running statistics within
    their stated tolerances, the running statistics bit-identical on
    every rank; the same steps with each rank's own statistics (the
    BatchNorm before this repair) printed beside them;
12. one card: the in-process ``ElasticSupervisor`` on phase 6's
    BERT-base recovering from ``step.dispatch:before=4:error``
    (``transient``: one event, restored step 2, losses within the spread
    of two uninterrupted restores, phase 6's launches for every step
    dispatched and, less the update, for the two warm-up runs of each
    formation's capture, ``downtime_s``), and ``TrainLoop.prefetch`` against plain steps
    (step ms, ``input_wait_ms``);
13. the dist store (``kvstore.KVStoreDist``). One card: phase 6's
    training (float32, dropout 0.1, ten Adam steps) with
    ``Trainer(kvstore=KVStoreDist("dist_sync"))`` forced onto its host
    path (``_force_fuse``), so ``compile_step`` takes its split program
    (``mode`` "fused"; one graph of the forward and backward, the store's
    ``pushpull_list`` on the host, one graph of the update), in turns
    against phase 6's one-graph step from the same weights and batch
    (fused, split, split, fused), then a control run with its lr staged
    at twice the scheduler's: per split step 12 + 12 + 25 + 25 forward
    and backward launches and one ``opt_update``, two graphs, no
    collective, the buckets printed, the split runs within
    :func:`vs_eager`'s limit of the fused runs and the control outside
    it; median step ms, tokens/s and peak memory of each turn. With two
    or more cards (one line says so otherwise), one rank a card over
    NCCL at batch 32 x 512 global, dropout 0: (a) ``dist_sync``
    through the split program from a seed of each rank's own (the
    store's init gives every rank rank 0's weights), ten Adam steps in
    turns against phase 11's plain mesh mode (split, mesh, mesh,
    split; the slowest rank's median step ms, the spread, global
    tokens/s): one collective a bucket and one wait a step, one
    ``opt_update`` a rank a step, bit-equal weights on every rank, the
    first step's reduced gradients within phase 11's bound of
    ``Trainer(kvstore=None)``'s eager step and the weights within
    :func:`vs_eager`'s limit of it; (b) ``Trainer.step`` with the store
    updating (the JAX default with several workers; one ``opt_update`` a
    parameter a step, as each key is pushed), within that limit
    of (a), and ``save_states`` / ``load_states`` through the store's
    updater; (c) fp16 (within FP16_MOVED_RTOL of (a)) and 2bit (finite,
    non-zero residuals) compression, three steps each; (d)
    ``dist_async``: no wait, within the spread of (a)'s runs, and on
    phase 8b's Dense-only widths bit-equal to ``dist_sync``;
14. the convolutional path: ``resnet50_v1`` (1000 classes, seeded
    He-normal weights) trained as ``bench.py bench_resnet`` trains it
    (batch 128 x 224 x 224 numpy-uniform images, SGD momentum 0.9 at lr
    0.1), ten steps through ``TrainLoop`` over ``compile_step`` (one
    captured graph a step), in float32 (TF32 off for products and
    convolutions) and under bf16 amp, each in phase 6's turns against the
    eager loop (capture s, ``n_traces``, median step ms, images/s, peak
    allocated and reserved memory; the replays within twice the body
    runs' spread: cuDNN's default backward algorithms may sum with
    atomics; the 2x-lr control failing): finite falling losses, exactly
    one ``opt_update`` launch a step (all 161 parameters) in float32 and
    nothing else of the library (convolutions, pooling and BatchNorm are
    cuDNN's), and two training-mode backward passes at 4 x 64 x 64 on a card
    copy and a CPU copy (float64 under amp) of the net after its first step:
    the gradients of every parameter and then every running statistic within
    phase 6's bound (bf16: phase 6b's of float64; the same check of the
    ten-step net printed, not held). Then the float32-trained net served in eval mode through
    ``predictor_for(net, "float32")`` and ``"bfloat16"`` (bfloat16
    images, its BatchNorms float32), one graph a bucket 1-128: bucket
    128's replay bit-equal to the net called eagerly, its first rows
    against a CPU copy converted the same way (float32 within 2e-4 of
    the largest logit, at least 1; bf16 within 5e-2 of the largest) with
    their top-1, images/s at buckets 32 and 128, one profiled bucket-128
    micro-batch's busy share, peak memory.
15. training's surface (the optimizers, losses, initializers and metrics
    beyond SGD / Adam): (a) phase 6's BERT-base training with LAMB as
    GluonNLP's BERT pretraining sets it (lr 1e-4, wd 0.01, no weight
    decay on gamma, beta and bias) in phase 6's turns: finite falling
    losses, per step exactly 12 + 12 + 25 + 25 flash / LayerNorm launches
    and no ``opt_update`` (LAMB runs as PyTorch ops in the graph), the
    replays against the body and eager runs with the 2x-lr control
    failing, one full-width LAMB update against a CPU copy fed the same
    weights and gradients (1e-6 + 1e-5 |w|), a ``metric.Loss`` fed ten
    captured steps' losses on the card with any sync an error, and the
    whole LAMB update timed alone; (b) phase 14's ResNet-50 under
    gluon-cv's ImageNet recipe (``initialize(net, MSRAPrelu())``, NAG
    momentum 0.9 at lr 0.1 under a cosine schedule, wd 1e-4 but not on
    beta, gamma, bias, labels smoothed by 0.1 into
    ``SoftmaxCrossEntropyLoss(sparse_label=False)``) in phase 14's turns
    and gates, no ``opt_update``, then an eval pass in micro-batches of
    32 with ``Accuracy``, ``TopKAccuracy(5)``, ``CrossEntropy`` updated on
    the card with no sync, against the same metrics on numpy copies
    (1e-5), and the NAG update timed beside ``torch._fused_sgd_``; (c)
    every registered optimizer (19, a non-default setting each) for three
    captured steps of phase 8b's Dense-only model against an eager twin
    (CAPTURED_EAGER_RTOL of the move; SGLD bit for bit from the same
    generator, its noise std within 5 % of sqrt(lr)) and a CPU copy fed
    the card's gradients (1e-6 + 1e-5 |w|), ``opt_update`` once a step
    for exact SGD / Adam only; (d) the 14 losses forward and backward at
    realistic sizes against a CPU copy (1e-5 of the largest value; CTC
    at T 200 x N 32 x 29 classes, labels of up to 50, ragged lengths,
    1e-4).
16. the recurrent cells, the contrib cells and layers, the Estimator:
    (a) phase 8's word LM built from two ``LSTMCell``s unrolled over the
    merged batch (the fused unroll): its first loss and one step's 11
    gradients against phase 8's layer model on the same batch and
    weights (bit for bit, or within 1e-6 relative), ten SGD-momentum
    steps in phase 6's turns (replays bit-equal to the body runs), per
    step exactly 2 ``rnn_scan_fwd`` + 2 ``rnn_scan_bwd`` + 1
    ``opt_update``, a falling loss, gradients at batch 4 against a CPU
    copy, the layer model's captured step beside it; GRUCell and RNNCell
    (tanh, relu) unrolls at 650 in eval mode, one ``rnn_scan_fwd`` each,
    against CPU copies; (b) Zoneout(LSTMCell 650) -> DropoutCell(0.5) ->
    Residual(LSTMCell 650) stepped by the loop (one graph of 70 cell
    steps, no ``rnn_scan``), in turns, in eval mode against a CPU copy;
    a BidirectionalCell over ragged lengths 35..1 and LSTMPCell(650,
    256) against CPU copies; (c) ConvLSTM at Shi et al. 2015's Moving
    MNIST widths (three Conv2DLSTMCells of 128, 64, 64 channels, 5 x 5,
    ten frames of 16 x 16 x 16 patches, batch 16, RMSProp) in turns under
    ``cudnn.deterministic`` (replays bit-equal), a falling loss, its
    gradients against a CPU copy, step ms and frames/s; Conv1DGRUCell and
    Conv3DRNNCell steps against CPU copies; (d) ``Estimator.fit`` on
    (c)'s model, 2 epochs of 4 batches with ``CheckpointHandler``,
    ``ValidationHandler``, ``EarlyStoppingHandler``, then a resumed
    Estimator's third epoch bit-equal to an uninterrupted 3-epoch run;
    (e) GroupNorm(32) on (32, 256, 56, 56), InstanceNorm on (4, 64, 256,
    256), PixelShuffle2D(3) on (1, 9, 224, 224), the activation layers
    on (4096, 3072) and a HybridConcatenate of two Dense(768), forward
    and backward against CPU copies (1e-4 + 1e-4 |ref|) with their ms.
17. serving resilience and the fleet, BERT-base at phase 4's widths and
    traffic (rows from a pool of FLEET_POOL, so a float32 CPU copy answers
    every row): (a) one card, float32 and bf16: a ``ServingSupervisor``
    under a ``serving.dispatch`` transient fault (retried in place, no
    request lost, 12 ``flash_fwd`` + 25 ``layernorm_fwd`` a micro-batch),
    an open loop at twice the closed loop's req/s with a per-request
    deadline (every request ok, rejected or deadline_missed; goodput), an
    open breaker failing submit fast, a drain under traffic (every
    accepted request finishes), a one-replica ``FleetController``'s
    ``swap_weights`` from a ``TrainCheckpointManager`` checkpoint of
    another seeded BERT-base (bit-equal to a fresh predictor on those
    weights, ``n_traces`` unchanged, a corrupted copy aborting typed with
    the weights still answering bit for bit); (b) three or more cards (in
    the default run, as phase 11): a fleet with one replica on each card
    but the last, a burst with ``serving.dispatch@replica-1`` revoking
    its card (simulated: the card stays healthy) mid-traffic: no request
    lost or hung, one failover and one restart onto the spare card, every
    answer within 2e-4 of the CPU copy, each replica's outputs and
    captured programs on its card, the time to recover and req/s before,
    during and after, rows 1 and 5 a card; then a rolling
    ``swap_weights`` under traffic (none dropped, at most one version of
    skew, each answer against the CPU copy of its ``fut.version``,
    ``n_traces`` unchanged); with two or more cards, the float32 fused
    flash backward launched on cuda:0 then cuda:1 from one process.
18. the input pipeline at full width: (a) 1,536 synthetic 3 x 480 x 640
    images as raw records (``recordio``) through ``RecordFileDataset``,
    gluon-cv's ImageNet augmentation and an 8-thread ``DataLoader``
    staging two batches ahead on the card, three epochs (36 batches of
    128) of phase 14's captured float32 ResNet-50 step: the first staged
    batch bit-equal to the host loader's without workers from the same
    seeds, labels those of their records, one ``opt_update`` a step,
    nothing captured after the warm-up; images/s end to end (steps 2-36,
    and within epochs without each epoch's first step) beside the step
    on a resident batch, the loader's input wait and starvation, the
    host ms a sample and the batchify ms; then, with PIL, 512 of the
    images as JPEG records read by ``io.ImageRecordIter`` (records/s, 4
    steps) and by ``ImageRecordDataset`` (one step); (b) phase 8's word LM trained as
    MXNet's word_language_model example trains it: windows through
    ``IntervalSampler``, ``clip_global_norm`` at 0.25 x 35 x 64, SGD
    ``step(1)``, ten eager steps (and one clipping at half its norm if
    none clipped): staged batches equal to the host's, each norm within
    1e-5 of a float64 CPU norm, the clipped norm within the bound, the
    update against a CPU copy, 2 + 2 + 1 launches a step; step, clip and
    plain-step ms.
19. the telemetry layer with ``MXNET_TELEMETRY`` on (``telemetry_phase``):
    (a) phase 6's BERT-base training through ``TrainLoop`` with
    ``prefetch`` under ``set_sync_debug_mode("error")`` (the retire and
    the checkpoint exempt), float32 then bf16 amp, numerics off (twice),
    ``global`` (with one checkpoint) and ``per_layer``: 12 flash_fwd, 12
    flash_bwd_fused, 25 + 25 LayerNorm and one ``opt_update`` a step in
    every mode, one capture; each numerics run's losses and weights
    within TELE_SPREAD_FACTOR of the two numerics-off runs' own distance
    (the fused backward's dq atomics), and phase 8b's Dense model, every
    kernel deterministic, bit-equal with numerics on and off; the grad
    and param norms of one more step within 1e-5 of float64 norms on the
    card; ``arm_mfu``'s FLOPs within 5 % of 6 x non-embedding weights x
    tokens + 12 x layers x tokens x S x d_model, ``mx_model_mfu_ratio``
    in (0, 1]; a NaN planted before step 4 gives one ``nan_loss`` and one
    ``nonfinite_grad`` anomaly at step 4 and one dump; a 2 s delay at the
    retire of step 8 (``testing/faults.py``) one ``stall`` at step 8;
    printed: the step ms with telemetry and numerics on against off, in
    turns, with each run's peak memory, and the MFU; (b) inside (a)'s
    float32 run: the census's ``params`` and ``optimizer`` pools equal to
    the parameters' and states' bytes, ``mx_mem_untracked_bytes``, a
    budget below use giving one ``memory_budget`` anomaly, an allocation
    past ``mem_get_info``'s free bytes in an ``oom_guard`` seam giving
    one ``oom`` anomaly and one dump naming the largest pool, the error
    re-raised, the process going on; (c) phase 4's closed loop (96
    requests, 8 clients): ``mx_serving_requests_total`` 96,
    ``mx_serving_batches_total`` the batcher's count, 96 request
    latencies; decode_wide (32 requests): ``rnn_decode`` launched,
    ``mx_decode_tokens_total`` the run's tokens, the KV pools' census
    bytes the allocator's requested bytes; (d) ``write_prometheus`` holds
    every catalog series, and a profiler trace of two BERT steps (the
    first captures) holds the funnel's ops and both steps' dispatch /
    window / retire spans.

21. ``analysis/`` at full width (``analysis_phase``): (a) BERT-base
    training (32 x 512, Adam) through ``compile_step(analyze="raise")``,
    float32 then bf16 amp: ``step.analyze`` records one run of the
    step's body before the first step, the weights, Adam states, update
    counts and the card's generator bit-equal after it; the report clean
    (no collective, no host transfer, no unblessed dtype drift, the 201
    parameters and their 402 Adam states updated in place); the kernel
    census's FLOPs within 5 % of ``step_flops``; the captured step's
    first call finding nothing, ``n_traces`` 1, 12 / 12 / 25 / 25 / 1
    launches a step; printed: the census's kernels, stranded ops and its
    15 largest stranded chains by bytes, the record's kernel nodes
    beside the captured graph's (``CUDAGraph.debug_dump``); (b) served
    BERT-base at bucket 32 (``CompiledPredictor(analyze="raise")``) and
    decode_wide's bucket-8 step (``DecodeEngine.analyze``), each clean
    under the ``predict`` expectations; (c) on four cards, phase 11's
    model under ZeRO dp 4, serial and at the default bucket: the
    collective census against the plan, serial ``overlap_fraction`` <=
    0.05 and bucketed above it, the analytical backend scoring serial
    worse; printed beside each exposed time the NCCL time no compute
    kernel overlapped in a ``torch.profiler`` trace of rank 0; (d) a
    loss with a planted ``.item()`` under ``MXNET_TRANSFER_GUARD=raise``
    raises naming its line, a clean loop stays quiet and
    ``mx_guard_host_syncs_total`` counts its retires; after the whole
    run the lock-order graph has no cycle and no edge outside
    ``tests/fixtures/torch_lock_hierarchy.json``.
22. the detection path (``ssd_phase``): bench.py bench_ssd's
    SSD-ResNet50 (resnet50_v1 features, two extra scales, 3 x 3 class and
    box heads, 536 anchors at 300 x 300) trained at 32 x 3 x 300 x 300
    with SGD momentum through ``compile_step``, float32 and bf16 amp,
    ``MultiBoxTarget`` inside the captured step: phase 14's turns
    (replays bit-equal to the body run eagerly under
    ``cudnn.deterministic``), finite falling losses, one ``opt_update``
    a step and nothing else of the library, gradients against a CPU
    copy, no host transfer in the step's ``analyze()`` report; the box
    ops on the card against the CPU (``MultiBoxTarget`` with planted
    padding rows and a duplicate best anchor, with and without mining;
    ``box_nms`` at the eval's shape); the NMS eval (softmax,
    ``MultiBoxDetection``) of the trained net at batch 4 captured through
    ``CompiledPredictor``; three steps fed by ``ImageDetIter`` over 64
    records (crop, pad, mirror) with one capture. Printed: step ms,
    images/s, peak memory, capture s, MultiBoxTarget's device ms and its
    share of the step, the eval's replay and eager ms, the fed run's
    images/s and input wait.

``{"launch_counts": {...}, "bf16_launch_counts": {...},
"dist_kv_launch_counts": {...}, "resnet_launch_counts": {...},
"surface_launch_counts": {...}, "cells_launch_counts": {...},
"fleet_launch_counts": {...}, "data_launch_counts": {...},
"telemetry_launch_counts": {...}}`` gives
each kernel's launches on its path, on its bf16 path where it has one,
on phase 13's one-card path, on phase 14's float32 and bf16 paths, on
phase 15's LAMB and NAG paths, on phase 16's cell-built LM, on phase
17a's supervised float32 serving (rows 1 and 5, ``fleet_launches``) and
on phase 18's two paths (``opt_update`` on ``resnet50_records`` and
``lstm_lm_clipped``, the recurrence kernels on ``lstm_lm_clipped``:
``data_launches`` by path, ``data_path``), on phase 19's paths
(``telemetry_launches``) and on phase 22's three SSD paths
(``ssd_launch_counts``; ``ssd_launches`` on the ``opt_update`` row).
The line before the last is a JSON object with one entry per kernel
(launches on its float32 path, error, times, bound; then its bf16 path,
bf16 launches there, and its bf16 error, times and bound; ``rnn_decode``
at decode_wide's N 8 x H 650, ``opt_update`` at the word embedding in
the device form, with its launches on phase 6's one-card path and on
phase 14's, ``resnet50_launches``; the recurrence kernels with their
launches on phase 16's cell LM, ``cells_launches``); the last line is
``{"ok": true, "device": {...}}``.
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
LONG_LAYERS, LONG_BATCH, LONG_SEQ, LONG_STEPS = 2, 2, 1024, 6
#: float32 gradients, GPU vs CPU copy, per parameter: max |difference| <=
#: GRAD_ATOL + GRAD_RTOL * max |CPU gradient|. The scale is the
#: parameter's largest gradient, not each element's: key_proj.bias has a
#: zero gradient in exact arithmetic (softmax ignores a per-row shift), so
#: both sides hold rounding noise there, ~1e-9
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-3
#: phase 6b's gradients under bf16 amp, GPU vs a CPU copy under amp:
#: 2.5e-1 of the parameter's largest gradient (a bias's: of its layer's
#: weight's too, ``bias_scale``). Twelve layers of bf16 products (2**-9
#: relative a rounding) after ten training steps whose float32 dq atomics
#: sum in no fixed order: on the CPU at this shape bf16 amp's gradients
#: differ from float32's by up to 4.7 % of a parameter's largest, and on
#: the card GPU and CPU bf16 differed by 5.8 % and 8.0 % in two runs, the
#: worst in the last layer's query and key projections (their dS is a
#: small difference of bf16-rounded products). A wrong gradient (a lost
#: term, a wrong scale or operand) is off by O(1) of its largest
GRAD_RTOL_BF16 = 2.5e-1
#: phase 6b also holds each side's gradients against a float64 CPU copy
#: at this many batches of GRAD_BATCH x GRAD_SEQ (the first is the
#: gradient check's)
GRAD_F64_BATCHES = 3
#: phase 6c: phase 6's setup through ``TrainLoop(checkpoint_dir=...)``: a
#: run that checkpoints at step CKPT_SAVE_AT (in the background) and goes
#: on CKPT_WRITE_STEPS steps while the write is in flight, then a resume
#: in fresh objects to step TRAIN_STEPS, held against CKPT_RUNS
#: uninterrupted runs. The fused flash backward sums dq with float32
#: atomics, so two runs may part in the last bits: the resumed run's
#: nearest uninterrupted run must be within CKPT_SPREAD_FACTOR times the
#: largest distance between two uninterrupted runs (the largest
#: |difference| of the resumed steps' losses; the rms difference of the
#: final weights), and bit-equal where those are. Three runs and the
#: factor, because the resumed run is one more draw of the same spread:
#: held to one measured distance alone it would fail about as often as it
#: passed. The weights' rms, not their largest difference: one element
#: with a tiny Adam denominator decides the largest (one H100 run gave
#: 3.4e-6 resumed against 1.4e-6 between two runs, losses within)
CKPT_SAVE_AT, CKPT_WRITE_STEPS, CKPT_RUNS, CKPT_SPREAD_FACTOR = 5, 2, 3, 2.0
#: phase 6c's checkpoints (git-ignored; removed at the end of the phase)
CKPT_DIR = os.path.join("build", "chip_ckpt")
#: phase 4b's bf16 logits, GPU vs a CPU copy converted the same way: 5e-2
#: of the largest |logit|. On the CPU at this shape bf16 logits differ
#: from float32's by 1.5 % of the largest; two bf16 runs about twice that
LOGIT_RTOL_BF16 = 5e-2
#: a served bucket's replay against the net called eagerly on the card,
#: the same padded batch: the graph runs the same kernels and cuBLAS
#: calls, so the logits are held bit for bit
GRAPH_ATOL = {"float32": 0.0, "bfloat16": 0.0}


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
#: (rows, C) of the LayerNorm and bias-GELU checks; the first is served.
#: The LayerNorm forward's also: BERT training's 16384 x 768 (timed in
#: float32 as ``layernorm_fwd@train``), then its plan's edges: one row,
#: C 1, C 771 (one element a load), C 16,384 (the block branch, the row
#: kept in shared memory) and C 120,000 (a row too wide for it); by dtype
#: C at the warp branch's cap and one past it; and x offset by one
#: element (LN_OFFSET_CASES: unaligned, one element a load)
LN_CASES = ((4096, 768), (37, 50), (TRAIN_BATCH * TRAIN_SEQ, 768), (1, 768),
            (3, 1), (4099, 771), (20, 16384), (3, 120000))
LN_CAP_CASES = {"float32": ((300, 1024), (300, 1025)),
                "bfloat16": ((300, 2048), (300, 2049))}
LN_OFFSET_CASES = ((4096, 768),)
BG_CASES = ((4096, 3072), (37, 50))


def check_kernels(torch, ATT, K, KN, dev):
    """Phase 3: every kernel against its plain version, in float32 and
    bfloat16 (the LayerNorm forward also at its plan's edges, each with
    its plan and one launch, run twice to show it repeats bit for bit).
    Returns {(kernel, dtype): (record, args)} of the served shapes (and
    the LayerNorm forward's training shape), for :func:`time_kernels`."""
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

        ln_cases = [(rows, c, 0) for rows, c in LN_CASES + LN_CAP_CASES[dn]]
        for rows, c, off in ln_cases + [(r, c, 1) for r, c in LN_OFFSET_CASES]:
            x = rnd(rows * c + off, dtype=dtype)[off:].view(rows, c)
            gam, bet = rnd(c, dtype=torch.float32), rnd(c, dtype=torch.float32)
            K.reset_launch_counts()
            y = KN.layer_norm(x, gam, bet, 1e-5)
            torch.cuda.synchronize()
            launched = K.launch_counts()["layernorm_fwd"]
            repeats = bool(torch.equal(y, KN.layer_norm(x, gam, bet, 1e-5)))
            ok, e, r = compare(torch, y, KN.layer_norm_plain(x, gam, bet),
                               atol, rtol)
            key = None
            if off == 0 and (rows, c) == LN_CASES[0]:
                key = "layernorm_fwd"
            elif off == 0 and (rows, c) == LN_CASES[2] and dn == "float32":
                key = "layernorm_fwd@train"
            record({"kernel": "layernorm_fwd", "dtype": dn,
                    "shape": [rows, c], "offset_elements": off,
                    "max_abs_err": e, "rel_err": r, "atol": atol,
                    "rtol": rtol, "repeats_bit_for_bit": repeats,
                    "launches": launched,
                    "plan": KN.ln_fwd_plan(rows, c, dtype, dev,
                                           aligned=off == 0),
                    "ok": ok and repeats and launched == 1},
                   (x, gam, bet), key)
            del x, y

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


def time_kernels(torch, F, ATT, K, KN, served):
    """Kernel, plain-version and library-call times (device and eager,
    :func:`time_ms`) at the served shapes (bucket 32, sequence 128), the
    flash forward also at BERT training's (batch 32, sequence 512; key
    ``flash_fwd@train``) and the LayerNorm forward at its 16384 x 768 in
    float32 (``layernorm_fwd@train``), in each dtype, with the bound of
    this call's work; the LayerNorm forward beside an empty kernel of its
    plan's grid (the launch floor). Returns {(kernel, dtype): timing}."""
    timing = {}
    for (key, dn), (rec, args) in served.items():
        name = key.split("@")[0]
        size = args[0].element_size()
        extra = {}
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
            extra = empty_floor(torch, K, x.device, rec["plan"])
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
             "bytes": nbytes, "flops": flops, **extra}
        emit({"timing": t})
        timing[(key, dn)] = t
    return timing


def empty_floor(torch, K, dev, plan):
    """The launch floor beside a kernel's time: an empty kernel of its
    plan's blocks and threads, timed as the kernel is (graph replay)."""
    return {"empty_kernel_ms": time_ms(torch, lambda: K.launch_empty(
        dev, plan["blocks"], plan["threads"]), [()])[0], "plan": plan}


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
    # query, D = 128 causal at 512, a ragged key count, D 7 (no 16-byte
    # rows, an odd dq row)
    (2, 3, 1, 1, 1, False),
    (2, 3, 77, 1, 64, True),
    (2, 3, 1, 130, 32, True),
    (2, 12, 512, 512, 128, True),
    (2, 3, 300, 449, 64, False),
    (2, 3, 200, 200, 7, False),
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
#: (rows, C) of the LayerNorm backward: training's 32 x 512 tokens, then
#: the plan's edges: a C that takes one element a load (771), C 16,384
#: (the block branch), rows below the block count, one row; and by dtype,
#: C at the warp branch's cap and one past it
LN_BWD_CASES = ((TRAIN_BATCH * TRAIN_SEQ, 768), (4099, 771), (20, 16384),
                (3, 768), (1, 768))
LN_BWD_CAP_CASES = {"float32": ((300, 1024), (300, 1025)),
                    "bfloat16": ((300, 2048), (300, 2049))}


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
            # a second run: dk and dv (one owner each) bit for bit, and
            # dq too past 512 (no atomics); the fused kernel's dq sums by
            # atomics in no fixed order, so it repeats within rounding
            again = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
            torch.cuda.synchronize()
            repeats = [bool(torch.equal(a, r)) for a, r in zip(got, again)]
            del again
            if fused:
                record(dict(base, kernel="flash_bwd_fused",
                            max_abs_err=max(r[1] for r in res),
                            rel_err=max(r[2] for r in res),
                            dk_dv_repeat_bit_for_bit=repeats[1]
                            and repeats[2],
                            ok=all(r[0] for r in res) and launches_ok
                            and repeats[1] and repeats[2]), args,
                       timed_case)
                continue
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

        for rows, c in LN_BWD_CASES + LN_BWD_CAP_CASES[dn]:
            x, dy = rnd(rows, c, dtype=dtype), rnd(rows, c, dtype=dtype)
            gam = rnd(c, dtype=torch.float32)
            K.reset_launch_counts()
            got = KN.layer_norm_bwd(x, gam, dy)
            torch.cuda.synchronize()
            launched = K.launch_counts()["layernorm_bwd"]
            res = [compare(torch, a, r, atol, rtol) for a, r in
                   zip(got, KN.layer_norm_bwd_plain(x, gam, dy))]
            again = KN.layer_norm_bwd(x, gam, dy)
            repeats = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            record({"kernel": "layernorm_bwd", "dtype": dn, "shape": [rows, c],
                    "max_abs_err": max(r[1] for r in res),
                    "rel_err": max(r[2] for r in res), "atol": atol,
                    "rtol": rtol, "repeats_bit_for_bit": repeats,
                    "launches": launched,
                    "plan": KN.ln_bwd_plan(rows, c, dtype, dev),
                    "ok": all(r[0] for r in res) and repeats
                    and launched == 1},
                   (x, gam, dy), (rows, c) == LN_BWD_CASES[0])
    if failures:
        raise SystemExit(f"backward kernel checks failed: {failures}")
    return timed


def causal_pairs(sq, sk, causal):
    """(query, key) pairs the attention computes (the package's count,
    which the flash wrappers report as their FLOPs' pairs)."""
    from mxnet_tpu_torch.ops.kernels import causal_pairs as pairs
    return pairs(sq, sk, causal)


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
#: (32 x 128 tokens x 3072), an unaligned C, then the plan's edges: one
#: row, C 1, C 16,384; x, dy offset by one element (BG_BWD_OFFSET_CASES:
#: one element a load); and b in float32 under bfloat16 x
#: (BG_BWD_F32_BIAS_CASES: b read and db written in b's dtype)
BG_BWD_CASES = ((4096, 3072), (37, 50), (1, 3072), (3, 1), (20, 16384))
BG_BWD_OFFSET_CASES = ((4096, 3072),)
BG_BWD_F32_BIAS_CASES = ((37, 3072),)


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
        bg_cases = [(rows, c, 0, dtype) for rows, c in BG_BWD_CASES] + \
            [(rows, c, 1, dtype) for rows, c in BG_BWD_OFFSET_CASES] + \
            [(rows, c, 0, torch.float32) for rows, c in BG_BWD_F32_BIAS_CASES]
        for rows, c, off, b_dtype in bg_cases:
            x = rnd(rows * c + off)[off:].view(rows, c)
            dy = rnd(rows * c + off)[off:].view(rows, c)
            bias = rnd(c).to(b_dtype)
            K.reset_launch_counts()
            got = KN.bias_gelu_bwd(x, bias, dy)
            torch.cuda.synchronize()
            launched = K.launch_counts()["bias_gelu_bwd"]
            res = [compare(torch, a, r, atol, rtol) for a, r in
                   zip(got, KN.bias_gelu_bwd_plain(x, bias, dy))]
            again = KN.bias_gelu_bwd(x, bias, dy)
            repeats = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            dtypes_ok = got[0].dtype == dtype and got[1].dtype == b_dtype
            rec = {"kernel": "bias_gelu_bwd", "dtype": dn, "shape": [rows, c],
                   "offset_elements": off,
                   "b_dtype": str(b_dtype).replace("torch.", ""),
                   "max_abs_err": max(r[1] for r in res),
                   "rel_err": max(r[2] for r in res), "atol": atol,
                   "rtol": rtol, "repeats_bit_for_bit": repeats,
                   "launches": launched,
                   "plan": KN.bg_bwd_plan(rows, c, dtype, dev,
                                          aligned=off == 0),
                   "ok": all(r[0] for r in res) and repeats and dtypes_ok
                   and launched == 1}
            emit({"check": rec})
            if not rec["ok"]:
                failures.append(rec)
            if (rows, c, off, b_dtype) == BG_BWD_CASES[0] + (0, dtype):
                timed[("bias_gelu_bwd", dn)] = (rec, (x, bias, dy))
            del x, dy, got, again
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


def time_new_kernels(torch, F, K, KR, KN, timed):
    """Kernel, plain-version and library times of this slice's kernels at
    their paths' shapes (the LM's LSTM layer, the phase-5 FFN), in each
    dtype, with the bound of this call's work: each input read once and
    each output written once; the recurrence's operations are the TPU
    kernel's (2*T*N*G*H^2 a product; the backward's three: recompute, dh,
    dW); the bias-GELU backward beside an empty kernel of its plan's grid
    (the launch floor). Returns {(kernel, dtype): timing}."""
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
            extra = empty_floor(torch, K, x.device, rec["plan"])
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


#: decode-kernel cases (N, H): a ragged one, 128 rows at H 650, which the
#: first version refused (h of all rows in one block's shared memory), H
#: 4,096 at N 2 (several rows of W_hh a warp), and the decode_wide shape
#: (bucket 8, the word LM's hidden 650); decode_leg's (8, 128) is timed
DECODE_CASES = ((3, 37), (128, 650), (2, 4096), (8, 650))
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
                       "plan": KR.rnn_decode_plan(n, h, mode, dtype, dev),
                       "ok": all(r[0] for r in res) and launched == 1}
                if dtype == torch.bfloat16:
                    # W_hh and b_hh read in bfloat16 as they are give the
                    # bits of their float32 widening
                    wide = KR.rnn_decode_step(xw, hh, cc, w.float(),
                                              b.float(), mode)
                    rec["bf16_weights_equal_widened"] = all(
                        bool(torch.equal(a, r)) for a, r in zip(got, wide)
                        if r is not None)
                    rec["ok"] = (rec["ok"]
                                 and rec["bf16_weights_equal_widened"])
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


def time_decode_kernel(torch, K, KR, timed):
    """Kernel, plain-version and library times of ``rnn_decode`` (LSTM)
    at DECODE_TIMED in each dtype, by CUDA-graph replay over copies of
    W_hh larger than the L2 (the engine reads W_hh cold, after the 86 MB
    logits product of a step). W_hh is in the activation dtype, as the
    scan's checks hold it; the kernel reads it as it is. Bound: W_hh,
    b_hh, xw, h, c read once and h, c written once, against 2*N*G*H^2
    float32 operations (the kernel's arithmetic is float32 in both
    dtypes). Beside it the launch floor: an empty kernel of the plan's
    blocks and threads, timed the same way. Library:
    ``torch.nn.LSTMCell`` at the same N, H and dtype, which also does the
    input projection. Returns {(kernel, dtype, N, H): timing}."""
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
        plan = rec["plan"]
        empty_ms = time_ms(torch, lambda *a: K.launch_empty(
            xw.device, plan["blocks"], plan["threads"]), [()], iters=50)[0]
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        t = {"kernel": "rnn_decode", "dtype": dn, "shape": [n, h],
             "max_abs_err": rec["max_abs_err"], "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "library": "torch.nn.LSTMCell (with its input projection)",
             "bound_ms": b_ms, "bound_by": b_by,
             "empty_kernel_ms": empty_ms, "plan": plan, "eager_ms": eager_ms,
             "plain_eager_ms": plain_eager_ms,
             "library_eager_ms": library_eager_ms, "bytes": nbytes,
             "flops": flops}
        emit({"timing": t})
        timing[key] = t
    return timing


def param_grads(torch, net, loss_fn, x, y):
    """One backward of ``loss_fn`` at (x, y) (numpy) on ``net`` in eval
    mode (dropout off, BatchNorm on its running statistics): {name:
    gradient on the CPU, in its dtype} of every trainable parameter."""
    net.eval()
    dev = next(net.parameters()).device
    for p in net.parameters():
        p.grad = None
    loss_fn(net(torch.from_numpy(x).to(dev)),
            torch.from_numpy(y).to(dev)).sum().backward()
    return {n: p.grad.detach().cpu() for n, p in net.named_parameters()
            if p.requires_grad}


def grad_scales(ref, scale_of=None):
    """Each parameter's scale: max |ref gradient| of the parameter, or the
    largest over the parameters ``scale_of(name)`` lists."""
    return {n: max(float(ref[m].abs().max())
                   for m in (scale_of(n) if scale_of else [n])) for n in ref}


def grad_check(torch, gpu_net, cpu_net, loss_fn, x, y, atol=GRAD_ATOL,
               rtol=GRAD_RTOL, scale_of=None, grads=None):
    """One backward of ``loss_fn`` at (x, y) on both nets (in eval mode:
    dropout off; or their gradients ``grads``, from :func:`param_grads`);
    the worst parameters' max |difference| over their bound
    ``atol + rtol * scale`` (:func:`grad_scales` of the CPU gradients; ok
    when <= 1)."""
    if grads is None:
        grads = [param_grads(torch, net, loss_fn, x, y)
                 for net in (gpu_net, cpu_net)]
    scales = grad_scales(grads[1], scale_of)
    ranked = []
    for n, ref in grads[1].items():
        err = float((grads[0][n].double() - ref.double()).abs().max())
        ratio = err / (atol + rtol * scales[n])
        ranked.append((ratio if math.isfinite(ratio) else math.inf, n, err))
    ranked.sort(reverse=True)
    worst, worst_name, worst_err = ranked[0]
    return {"params": len(grads[1]), "worst_param": worst_name,
            "worst_max_abs_err": worst_err, "worst_err_over_bound": worst,
            "next_worst": [[n, r] for r, n, _ in ranked[1:4]],
            "atol": atol, "rtol_of_param_max": rtol, "ok": worst <= 1.0}


def grad_errors(grads, ref, scale_of=None, rms=False):
    """Per parameter: max |gradient - ref| (with ``rms``: the root mean
    square of the difference) over the parameter's scale
    (:func:`grad_scales` of ``ref``)."""
    scales = grad_scales(ref, scale_of)
    out = {}
    for n, r in ref.items():
        d = grads[n].double() - r
        err = d.pow(2).mean().sqrt() if rms else d.abs().max()
        out[n] = float(err) / max(scales[n], 1e-300)
    return out


#: phase 6b's sides against float64, and the measures of their errors
F64_SIDES = ("card_amp", "cpu_amp", "cpu_float32")
F64_MEASURES = ("max", "rms")


def side_errors(g_card, g_amp, g_f32, g_f64):
    """One batch's errors against float64 (:func:`grad_errors`, max and
    rms, scaled as ``bias_scale`` says) of the card under amp, of the CPU
    copy under amp and of the CPU copy in float32: {measure: {side:
    {parameter: error}}}."""
    return {m: {side: grad_errors(g, g_f64, bias_scale, rms=m == "rms")
                for side, g in zip(F64_SIDES, (g_card, g_amp, g_f32))}
            for m in F64_MEASURES}


def amp_vs_float64(batches, sizes):
    """Phase 6b's three sides against float64 over several batches (a
    list of :func:`side_errors`; ``sizes``: each parameter's elements):
    each parameter's error is its largest over the batches; by each
    measure the largest and median error of each side, the median ratio
    card / CPU under amp, the five parameters with the largest ratio
    (with their element counts), and ``within_2x``: every ratio <= 2."""
    out = {"batches": len(batches),
           "per_param_columns": [f"{side} {m}" for m in F64_MEASURES
                                 for side in F64_SIDES]}
    errs = {m: {side: {n: max(b[m][side][n] for b in batches)
                       for n in sizes} for side in F64_SIDES}
            for m in F64_MEASURES}
    for m, e in errs.items():
        ratio = {n: e["card_amp"][n] / max(e["cpu_amp"][n], 1e-300)
                 for n in sizes}
        worst = sorted(ratio, key=ratio.get, reverse=True)[:5]
        out[m] = {
            "max": {side: max(v.values()) for side, v in e.items()},
            "argmax": {side: max(v, key=v.get) for side, v in e.items()},
            "median": {side: statistics.median(v.values())
                       for side, v in e.items()},
            "median_ratio": statistics.median(ratio.values()),
            "worst_ratio_card_over_cpu_amp": [
                [n, ratio[n], sizes[n]] + [e[sd][n] for sd in F64_SIDES]
                for n in worst],
            "within_2x": all(r <= 2.0 for r in ratio.values())}
    out["per_param"] = {n: [errs[m][side][n] for m in F64_MEASURES
                            for side in F64_SIDES] for n in sizes}
    return out


#: part of phase 6b: the bf16 products that BERT-base training (16384
#: tokens) and the gradient check (256 tokens) make, (M, K, N): the
#: forward's 768 x 768 and 768 x 3072 and 3072 x 768 layers, and the
#: weight gradients, whose K is the tokens
BF16_MATMUL_CASES = ((16384, 768, 768), (16384, 768, 3072),
                     (16384, 3072, 768), (768, 16384, 768),
                     (768, 16384, 3072), (256, 768, 768), (256, 3072, 768),
                     (768, 256, 768))
#: the fused flash backward's bf16 branch held against float64: BERT
#: training's shape and the gradient check's
BF16_FLASH_CASES = ((TRAIN_BATCH, 12, TRAIN_SEQ, TRAIN_SEQ, 64),
                    (GRAD_BATCH, 12, GRAD_SEQ, GRAD_SEQ, 64))
#: runs of the fused backward whose dq is compared (the atomics' order)
BF16_DQ_RUNS = 5


def rel_errs(torch, got, ref):
    """(max |err| / max |ref|, rms err / rms ref) of ``got`` against the
    float64 ``ref`` (on one device)."""
    err = got.double() - ref
    return (float(err.abs().max() / ref.abs().max()),
            float(err.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()))


def flash_bwd_float64(torch, q, k, v, out, lse, do, scale, rounded):
    """The attention backward in float64 from the same (bf16) q, k, v,
    out, lse and dO, the delta from that out; with ``rounded`` P is
    rounded to bf16 before dV and dS before dQ and dK, as the reference
    (``mxnet_tpu/ops/attention.py``) and the plain version round them."""
    q, k, v, o, do = (t.double() for t in (q, k, v, out, do))
    delta = (do * o).sum(-1, keepdim=True)
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale
                  - lse.double()[..., None])
    pv = p.to(torch.bfloat16).double() if rounded else p
    dv = torch.matmul(pv.transpose(-1, -2), do)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta) * scale
    if rounded:
        ds = ds.to(torch.bfloat16).double()
    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv


def bf16_op_checks(torch, ATT, dev):
    """Part of phase 6b: the card's bf16 ops against float64 on the same
    bf16 inputs, beside the CPU's bf16 result of the same op: (a) cuBLAS
    products (``torch.matmul``) at BF16_MATMUL_CASES with
    ``allow_bf16_reduced_precision_reduction`` True (PyTorch's default)
    and False, (b) the fused flash backward's bf16 branch (dq, dk, dv)
    against an exact float64 backward and one that rounds P and dS as
    the reference does, and the flash forward's output against exact
    float64 attention, (c) dq's spread over BF16_DQ_RUNS runs (float32
    atomics in no fixed order). Errors are (max, rms) relative; beside
    them the float64 result rounded once to bf16, the least any bf16
    output can miss by."""
    g = torch.Generator(device=dev).manual_seed(11)
    flag = torch.backends.cuda.matmul
    default = flag.allow_bf16_reduced_precision_reduction
    products = []
    for m, kk, n in BF16_MATMUL_CASES:
        a = torch.randn(m, kk, generator=g, device=dev).to(torch.bfloat16)
        b = (torch.randn(kk, n, generator=g, device=dev)
             * kk ** -0.5).to(torch.bfloat16)
        ref = torch.matmul(a.double(), b.double())
        rec = {"m_k_n": [m, kk, n],
               "bf16_rounding_floor": rel_errs(torch, ref.to(torch.bfloat16),
                                               ref)}
        try:
            for allow in (True, False):
                flag.allow_bf16_reduced_precision_reduction = allow
                rec[f"card_reduced_precision_{allow}"] = rel_errs(
                    torch, torch.matmul(a, b), ref)
        finally:
            flag.allow_bf16_reduced_precision_reduction = default
        rec["cpu"] = rel_errs(torch, torch.matmul(a.cpu(), b.cpu()),
                              ref.cpu())
        products.append(rec)
        del a, b, ref
    flash = []
    for bb, h, sq, sk, d in BF16_FLASH_CASES:
        q, k, v, do = (torch.randn(bb, h, s_, d, generator=g, device=dev)
                       .to(torch.bfloat16) for s_ in (sq, sk, sk, sq))
        out, lse = ATT.flash_attention_fwd(q, k, v)
        scale = d ** -0.5
        # the forward too: the card's online softmax over 64-key tiles
        # rounds P to bf16 against each tile's running max, the plain
        # version against the row's max
        ref = torch.softmax(torch.matmul(q.double(), k.double().transpose(
            -1, -2)) * scale, -1).matmul(v.double())
        rec = {"shape": [bb, h, sq, sk, d], "flash_fwd_out": {
            "card": rel_errs(torch, out, ref),
            "cpu": rel_errs(torch, ATT.flash_attention_fwd_plain(
                q.cpu(), k.cpu(), v.cpu())[0], ref.cpu()),
            "bf16_rounding_floor": rel_errs(torch, ref.to(torch.bfloat16),
                                            ref)}}
        del ref
        runs = [ATT.flash_attention_bwd(q, k, v, out, lse, do)
                for _ in range(BF16_DQ_RUNS)]
        cpu = ATT.flash_attention_bwd_plain(
            *(t.cpu() for t in (q, k, v, out, lse, do)))
        for rounded in (False, True):
            ref = flash_bwd_float64(torch, q, k, v, out, lse, do, scale,
                                    rounded)
            key = "rounded_as_reference" if rounded else "exact"
            rec[key] = {
                name: {"card": rel_errs(torch, runs[0][i], ref[i]),
                       "cpu": rel_errs(torch, cpu[i], ref[i].cpu()),
                       "bf16_rounding_floor": rel_errs(
                           torch, ref[i].to(torch.bfloat16), ref[i])}
                for i, name in enumerate(("dq", "dk", "dv"))}
            del ref
        dq0 = runs[0][0].float()
        spread = max(float((r[0].float() - dq0).abs().max())
                     for r in runs[1:])
        rec["dq_spread"] = {
            "runs": BF16_DQ_RUNS, "max_abs_over_max_dq":
            spread / float(dq0.abs().max()),
            "elements_differing": max(int((r[0] != runs[0][0]).sum())
                                      for r in runs[1:]),
            "elements": dq0.numel(),
            "dk_dv_bit_for_bit": all(torch.equal(r[1], runs[0][1])
                                     and torch.equal(r[2], runs[0][2])
                                     for r in runs[1:])}
        flash.append(rec)
        del q, k, v, do, out, lse, runs, cpu
    torch.cuda.empty_cache()
    return {"matmul": products, "flash_bwd_fused": flash,
            "allow_bf16_reduced_precision_reduction_default": default}


def bias_scale(name):
    """The gradients whose largest sets a parameter's bf16 bound: its own,
    and for a bias (LayerNorm beta) its layer's weight (gamma) too. A
    bias's gradient sums over rows what the weight's sums times an O(1)
    input, so both carry the same bf16 rounding; where the rows cancel
    (key_proj.bias: zero in exact arithmetic; the classifier's bias over
    two samples' opposite-signed terms) the bias's own largest
    understates it."""
    for bias, weight in ((".bias", ".weight"), (".beta", ".gamma")):
        if name.endswith(bias):
            return [name, name[:-len(bias)] + weight]
    return [name]


def copy_to_cpu(make_cpu_net, gpu_net, load_jax_params):
    """A CPU copy of ``gpu_net`` with its current weights."""
    cpu_net = make_cpu_net()
    load_jax_params(cpu_net, {n: p.detach().cpu().numpy()
                              for n, p in gpu_net.named_parameters()})
    return cpu_net


def by_dtype_diff(after, before):
    """Launches by kernel and dtype between two
    ``launch_counts_by_dtype()`` readings (kernels with none left out)."""
    out = {}
    for name, per in after.items():
        d = {dt: n - before.get(name, {}).get(dt, 0) for dt, n in per.items()}
        d = {dt: n for dt, n in d.items() if n}
        if d:
            out[name] = d
    return out


def run_train_steps(torch, K, step, x, y, steps, by_dtype=False):
    """``steps`` calls of a compiled train step on one batch: the losses,
    the wall ms of each step (each ends in a synchronize), the launches of
    each step, and the launches of the whole run (counted from 0). With
    ``by_dtype``, also each step's launches by kernel and input dtype."""
    losses, step_ms, per_step, per_step_dt = [], [], [], []
    K.reset_launch_counts()
    for _ in range(steps):
        before = K.launch_counts()
        before_dt = K.launch_counts_by_dtype() if by_dtype else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(x, y))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = K.launch_counts()
        per_step.append({n: after[n] - before[n] for n in after})
        if by_dtype:
            per_step_dt.append(by_dtype_diff(K.launch_counts_by_dtype(),
                                             before_dt))
    counts = K.launch_counts()
    out = ([float(l.mean()) for l in losses], step_ms, per_step, counts)
    return out + (per_step_dt,) if by_dtype else out


#: phases 6, 6b, 7 and 8: the captured step (``compile_step``: one CUDA
#: graph replayed a step) and the plain eager loop (``loss.sum().
#: backward(); trainer.step(batch)``) in turns, each from the same state;
#: then the step's body run eagerly BODY_RUNS times from that state, which
#: the replays must equal: bit for bit where every kernel is deterministic,
#: else within CKPT_SPREAD_FACTOR of the body runs' own spread (BERT's fused
#: backward sums dq by atomics). Three body runs, as phase 6c's CKPT_RUNS:
#: a replay is one more draw of the same spread, and the losses differ
#: by a few float32 ulps, so one measured distance between two body runs
#: (one ulp of the loss in one H100 run, against 2.5 for a replay) is too
#: small a sample to hold a third draw to
TRAIN_TURNS = ("captured", "eager", "eager", "captured")
BODY_RUNS = 3
#: the replays against the eager loop (its ``Trainer.step`` updates
#: through ``Optimizer._apply``, apart from the graph's code): the nearest
#: eager run's losses (largest step difference) and weights (rms
#: distance) within CKPT_SPREAD_FACTOR times the largest distance between
#: two eager or body runs, or within CAPTURED_EAGER_RTOL of how far the
#: eager run moved from the first step (losses: the largest |loss_k -
#: loss_0|; weights: the rms distance from the initial weights),
#: whichever is larger. The eager update takes Adam's 1 - b1**t in double
#: and the kernel a float32 powf, so the two part by a few ulps a step;
#: readings on an H100 (PERF.md §6): float32 losses 5.6e-6 to 8.0e-6 of
#: the move, weights 2.8e-5 to 4.7e-4; controls 0.51 to 1.14. A control
#: run, captured with every lr staged at CONTROL_LR_FACTOR times the
#: scheduler's (a wrong lr staged on the card), must fail the same gate.
CAPTURED_EAGER_RTOL, CONTROL_LR_FACTOR = 1e-2, 2.0


def body_step(step):
    """``step``'s body run eagerly on the card, no graph: each call stages
    the hyperparameters and copies the batch as a call of ``step`` does,
    then runs the body the graph holds."""
    def run(x, y):
        n = len(step._drawers)
        prog, key = step._fused_program((x, y), {}, None, advance=True)
        out = prog.body(*prog.inputs)
        step._settle_key(n, *key)
        return out
    return run


def plain_step(net, trainer, loss_fn):
    """The eager training loop's step: forward, backward, Trainer.step."""
    def run(x, y):
        loss = loss_fn(net(x), y)
        loss.sum().backward()
        trainer.step(x.shape[0])
        return loss.detach()
    return run


def control_step(step, np):
    """``step`` with every lr it stages multiplied by CONTROL_LR_FACTOR:
    what a wrong lr staged on the card would do (its capture made
    first)."""
    hp = step._hp
    stage = hp.stage

    def wrong(lrs, *rest):
        stage(np.asarray(lrs, np.float32) * CONTROL_LR_FACTOR, *rest)

    hp.stage = wrong
    return step


def vs_eager(eager, noise, w0, losses, w):
    """:data:`CAPTURED_EAGER_RTOL`'s gate of one run (``losses``, final
    weights ``w``) against the ``eager`` runs, with the ``noise`` runs'
    spread: [(losses, weights)] each."""
    def ldist(a, b):
        return max(abs(p - q) for p, q in zip(a, b))

    pairs = [(i, j) for i in range(len(noise))
             for j in range(i + 1, len(noise))]
    spread = {"loss": max(ldist(noise[i][0], noise[j][0]) for i, j in pairs),
              "weights_rms": max(rms_dist(noise[i][1], noise[j][1])
                                 for i, j in pairs)}
    moved = {"loss": max(abs(v - eager[0][0][0]) for v in eager[0][0]),
             "weights_rms": rms_dist(eager[0][1], w0)}
    gap = {"loss": min(ldist(losses, e[0]) for e in eager),
           "weights_rms": min(rms_dist(w, e[1]) for e in eager)}
    limit = {m: max(CKPT_SPREAD_FACTOR * spread[m],
                    CAPTURED_EAGER_RTOL * moved[m]) for m in gap}
    return {"gap": gap, "limit": limit, "spread": spread, "moved": moved,
            "gap_over_moved": {m: gap[m] / moved[m] if moved[m] else None
                               for m in gap},
            "ok": all(gap[m] <= limit[m] for m in gap)}


def train_turns(torch, K, build, x, y, steps, tokens, exact,
                by_dtype=False, loop=False, unit="tokens"):
    """Captured against eager in TRAIN_TURNS, then BODY_RUNS runs of the
    step's body and one control run, ``steps`` steps each on a fresh
    ``build()`` (net, trainer, loss; the dropout reseeded). A captured,
    body or control run first captures its signature (``aot_compile``:
    its capture seconds and ``n_traces``, again after the steps); with
    ``loop`` its step is a ``gluon.TrainLoop``'s (over the same
    ``compile_step``), and a captured run calls ``TrainLoop.step``. Per
    run: the losses, step ms and their median after the first step,
    ``tokens`` a step as ``unit``/s, peak allocated and reserved memory.
    Returns the report (``ok``: one capture a step object, the replays'
    weights and losses against the body runs' and against the eager
    runs' (:func:`vs_eager`), and the control run failing that gate),
    the first captured run's (net, trainer, loss_fn) and its
    :func:`run_train_steps` result, on which the phase's own gates
    hold."""
    import numpy as np
    runs, first, w0 = [], None, None
    for kind in TRAIN_TURNS + ("body",) * BODY_RUNS + ("control",):
        net, trainer, loss_fn = build()
        if w0 is None:
            w0 = flat_weights(torch, net)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec, step = {"kind": kind}, None
        if kind == "eager":
            fn = plain_step(net, trainer, loss_fn)
        else:
            if loop:
                from mxnet_tpu_torch.gluon import TrainLoop
                tloop = TrainLoop(net, trainer, loss_fn)
                step = tloop.compiled_step
            else:
                tloop = None
                step = trainer.compile_step(
                    lambda a, b, net=net, lf=loss_fn: lf(net(a), b))
            t0 = time.perf_counter()
            step.aot_compile(x, y)
            torch.cuda.synchronize()
            rec.update(mode=step.mode, capture_s=time.perf_counter() - t0,
                       n_traces_after_warmup=step.n_traces)
            fn = (tloop.step if loop else step) if kind == "captured" \
                else body_step(step) if kind == "body" \
                else control_step(step, np)
            del tloop
        out = run_train_steps(torch, K, fn, x, y, steps, by_dtype=by_dtype)
        med = statistics.median(out[1][1:])
        rec.update(losses=out[0], step_ms=out[1], median_step_ms=med,
                   **{f"{unit}_per_s": tokens / (med / 1e3)},
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   max_memory_reserved=torch.cuda.max_memory_reserved())
        if step is not None:
            rec["n_traces_after_steps"] = step.n_traces
        runs.append((rec, flat_weights(torch, net)))
        if first is None:
            first = (net, trainer, loss_fn), out
        # the step and its programs go here: its graph pool goes back to
        # the allocator at once
        del net, trainer, loss_fn, step, fn, out
    body = [(dict(enumerate(r["losses"])), w) for r, w in runs
            if r["kind"] == "body"]
    vs_body = []
    for r, w in runs:
        if r["kind"] != "captured":
            continue
        vs_body.append({
            "bit_equal": all(bool(torch.equal(w, b)) for _, b in body),
            "max_abs_diff": min(float((w - b).abs().max()) for _, b in body),
            "weights_rms": spread_gate([b for _, b in body], w, rms_dist),
            "losses": spread_gate([l for l, _ in body],
                                  dict(enumerate(r["losses"])), loss_dist)})
    one_capture = all(r["n_traces_after_warmup"] == r["n_traces_after_steps"]
                      == 1 and r["mode"] == "fused"
                      for r, _ in runs if r["kind"] != "eager")
    agree = all(v["bit_equal"] if exact else
                v["weights_rms"]["ok"] and v["losses"]["ok"]
                for v in vs_body)
    eager = [(r["losses"], w) for r, w in runs if r["kind"] == "eager"]
    noise = eager + [(r["losses"], w) for r, w in runs if r["kind"] == "body"]
    gates = {r["kind"] + str(i): vs_eager(eager, noise, w0, r["losses"], w)
             for i, (r, w) in enumerate(runs)
             if r["kind"] in ("captured", "control")}
    replays_ok = all(g["ok"] for k, g in gates.items()
                     if k.startswith("captured"))
    control_fails = not any(g["ok"] for k, g in gates.items()
                            if k.startswith("control"))

    def side(kind, key):
        return [r[key] for r, _ in runs if r["kind"] == kind]

    report = {"order": [r["kind"] for r, _ in runs], "steps": steps,
              "replays_vs_body": vs_body, "exact": exact,
              "one_capture_per_step_object": one_capture,
              "vs_eager": gates, "replays_vs_eager_ok": replays_ok,
              "control_lr_factor": CONTROL_LR_FACTOR,
              "control_fails": control_fails,
              "turns": [{k: v for k, v in r.items() if k != "step_ms"}
                        for r, _ in runs],
              "ok": one_capture and agree and replays_ok and control_fails}
    for kind in ("captured", "eager"):
        for key in ("median_step_ms", f"{unit}_per_s",
                    "max_memory_allocated", "max_memory_reserved"):
            report[f"{kind}_{key}"] = side(kind, key)
    report["capture_s"] = side("captured", "capture_s")
    return report, first[0], first[1]


#: device-kernel name fragments of each family in a profile
FAMILIES = (("flash_fwd", ("flash_fwd",)), ("flash_bwd", ("flash_bwd",)),
            ("layernorm_fwd", ("ln_fwd",)), ("layernorm_bwd", ("ln_bwd",)),
            ("bias_gelu_fwd", ("bias_gelu_fwd",)),
            ("bias_gelu_bwd", ("bias_gelu_bwd",)),
            ("rnn_scan_fwd", ("rnn_scan_fwd",)),
            ("rnn_scan_bwd", ("rnn_bwd_walk", "rnn_gemm")),
            ("rnn_decode", ("rnn_decode",)),
            ("opt_update", ("opt_multi",)),
            ("conv", ("conv", "fprop", "dgrad", "wgrad", "nchwtonhwc",
                      "nhwctonchw")),
            ("batch_norm", ("bn_fw", "bn_bw", "batch_norm", "batchnorm")),
            ("pool", ("pool",)),
            ("gemm", ("gemm", "cutlass", "gemv", "nvjet")))


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
    """``--profile``: where the time of one eager training step goes. One
    step split by CUDA events into forward, backward and optimizer update
    (``Trainer.step``); then ``torch.profiler`` over ``iters`` steps,
    device time summed by kernel family, and the device's busy share of
    the wall time."""
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


def profile_captured_step(torch, step, x, y, what, iters=3):
    """``--profile``: where the time of one captured step goes (``step``,
    a fresh ``compile_step``, captured here by its first call): a replay
    timed by CUDA events, then ``torch.profiler`` over ``iters`` replays,
    device time summed by kernel family (the whole update is the
    ``opt_update`` family; "other" the elementwise rest) and the device's
    busy share of the wall time. The replays step the net."""
    from torch.profiler import ProfilerActivity, profile

    step(x, y)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    step(x, y)
    ev[1].record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step(x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    families = device_us_by_family(torch, prof)
    busy = sum(families.values())
    top = sorted(device_us_by_kernel(torch, prof).items(),
                 key=lambda kv: -kv[1])[:8]
    none = "not measured (the profiler saw no device time in the replays)"
    emit({"train_profile": {
        "model": what, "program": "captured step, replayed",
        "iters": iters, "n_traces": step.n_traces,
        "replay_ms_by_events": ev[0].elapsed_time(ev[1]),
        "wall_ms_per_step": wall_us / iters / 1e3,
        "device_ms_per_step": {k: v / iters / 1e3
                               for k, v in families.items()},
        "device_share_by_family": {k: v / busy for k, v in families.items()}
        if busy else none,
        "top_kernels_ms_per_step": [[k[:80], v / iters / 1e3]
                                    for k, v in top],
        "device_busy_share": busy / wall_us if busy else none}})


def train_bert(torch, np, K, dev, smi, profile=False, bf16=False):
    """Phase 6: BERT-base classifier training through
    ``Trainer.compile_step``; the launch counts of exactly the ten steps.
    Phase 6b (``bf16``): the same under ``amp.init()`` (bf16 products and
    attention, float32 parameters, gradients, LayerNorms, loss and Adam
    state), ``amp.uninit()`` after it whatever happens; its launches are
    also held by input dtype, and the gradients against a CPU copy under
    amp and against a float64 CPU copy with the bf16 tolerance; beside
    them the three sides' errors to float64 (:func:`amp_vs_float64`) and
    the bf16 ops against float64 (:func:`bf16_op_checks`)."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.ops import attention as ATT
    if bf16:
        amp.init("bfloat16")
        try:
            return train_bert(torch, np, K, dev, smi, profile, False)
        finally:
            amp.uninit()
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
    net = make(dev)
    init = init_params_numpy(net, seed=2)
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = rs.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    y = rs.randint(0, 2, (TRAIN_BATCH,)).astype(np.float32)
    loss_fn = SoftmaxCrossEntropyLoss()
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    made = [net]
    del net

    def build():
        net = made.pop() if made else make(dev)
        load_jax_params(net, init)
        net.train()
        torch.manual_seed(0)        # the dropout masks
        return net, Trainer(dict(net.named_parameters()), "adam",
                            {"learning_rate": TRAIN_LR}), loss_fn

    setup_s = time.perf_counter() - t0
    amp_on = amp.is_enabled()
    turns, (net, trainer, _), gated = train_turns(
        torch, K, build, xt, yt, TRAIN_STEPS, TRAIN_BATCH * TRAIN_SEQ,
        exact=False, by_dtype=True)
    losses, step_ms, per_step, counts, per_step_dt = gated
    peak = turns["captured_max_memory_allocated"][0]
    median_ms = statistics.median(step_ms[1:])
    n_params = len(trainer._params)
    expect = {n: 0 for n in K.KERNELS}
    # the whole update of the n_params float32 parameters: one launch
    expect.update(flash_fwd=12, flash_bwd_fused=12, layernorm_fwd=25,
                  layernorm_bwd=25, opt_update=1)
    # under amp: attention in bf16, the LayerNorms in float32 (each sees
    # a residual sum, float32 + bf16 = float32); the update float32
    att = "bfloat16" if amp_on else "float32"
    expect_dt = {"flash_fwd": {att: 12}, "flash_bwd_fused": {att: 12},
                 "layernorm_fwd": {"float32": 25},
                 "layernorm_bwd": {"float32": 25},
                 "opt_update": {"float32": 1}}
    launches_ok = all(s == expect for s in per_step) and \
        all(s == expect_dt for s in per_step_dt)
    losses_ok = all(math.isfinite(v) for v in losses) and \
        losses[-1] < losses[0]
    master_ok = all(p.dtype == torch.float32 and (
        p.grad is None or p.grad.dtype == torch.float32)
        for p in net.parameters())
    if profile:
        what = "bert_base classifier 32 x 512" + (" bf16 amp" if amp_on
                                                 else "")
        profile_train_step(torch, net, trainer, loss_fn, xt, yt, what)
        profile_captured_step(torch, trainer.compile_step(
            lambda a, b: loss_fn(net(a), b)), xt, yt, what)

    t1 = time.perf_counter()
    cpu_net = copy_to_cpu(lambda: make("cpu"), net, load_jax_params)
    xs, ys = x[:GRAD_BATCH, :GRAD_SEQ], y[:GRAD_BATCH]
    extra = {}
    if amp_on:
        # the same weights on the CPU under amp, and without amp in
        # float32 and converted to float64 (its attention still float32:
        # the plain version computes in float32), at GRAD_F64_BATCHES
        # batches of the run's rows; the first is the gradient check's
        cpu64 = copy_to_cpu(lambda: make("cpu"), net, load_jax_params)
        cpu64.double()
        batches = []
        for i in range(GRAD_F64_BATCHES):
            rows = slice(i * GRAD_BATCH, (i + 1) * GRAD_BATCH)
            xb, yb = x[rows, :GRAD_SEQ], y[rows]
            g = [param_grads(torch, m, loss_fn, xb, yb)
                 for m in (net, cpu_net)]
            amp.uninit()
            try:
                g += [param_grads(torch, m, loss_fn, xb, yb)
                      for m in (cpu_net, cpu64)]
            finally:
                amp.init("bfloat16")
            if i == 0:
                grads = grad_check(torch, None, None, loss_fn, xs, ys,
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL_BF16,
                                   scale_of=bias_scale, grads=g[:2])
                card64 = grad_check(torch, None, None, loss_fn, xs, ys,
                                    atol=GRAD_ATOL, rtol=GRAD_RTOL_BF16,
                                    scale_of=bias_scale,
                                    grads=(g[0], g[3]))
                sizes = {n: t.numel() for n, t in g[3].items()}
            batches.append(side_errors(*g))
            del g
        del cpu_net, cpu64
        vs64 = amp_vs_float64(batches, sizes)
        emit({"bf16_grad_vs_float64": dict(vs64, card_vs_float64=card64)})
        extra["bf16_ops"] = bf16_op_checks(torch, ATT, dev)
        emit({"bf16_ops": extra["bf16_ops"]})
        extra["grad_vs_float64"] = {m: vs64[m] for m in F64_MEASURES}
        extra["grad_vs_float64"]["card_vs_float64_ok"] = card64["ok"]
        grads["ok"] = grads["ok"] and card64["ok"]
    else:
        grads = grad_check(torch, net, cpu_net, loss_fn, xs, ys)
    print(smi, flush=True)
    report = {
        "model": "bert_base classifier",
        "dtype": "bfloat16 amp, float32 parameters" if amp_on
        else "float32",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "optimizer": "adam", "learning_rate": TRAIN_LR, "dropout": 0.1,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3),
        "max_memory_allocated": peak, "setup_s": setup_s,
        "capture_s": turns["capture_s"][0],
        "n_traces_after_warmup": turns["turns"][0]["n_traces_after_warmup"],
        "n_traces_after_steps": turns["turns"][0]["n_traces_after_steps"],
        "launches": counts, "launches_per_step": per_step[-1],
        "launches_per_step_expected": expect,
        "launches_per_step_by_dtype": per_step_dt[-1],
        "launches_per_step_by_dtype_expected": expect_dt,
        "parameters_and_gradients_float32": master_ok,
        "grad_check": dict(grads, batch=GRAD_BATCH, seq=GRAD_SEQ,
                           seconds=time.perf_counter() - t1),
        **{k: v for k, v in extra.items() if k != "bf16_ops"},
        "captured_vs_eager": turns,
        "card": smi, "ok": launches_ok and losses_ok and grads["ok"]
        and master_ok and turns["ok"]}
    emit({"train_bf16" if amp_on else "train": report})
    if not report["ok"]:
        raise SystemExit(f"training phase failed: losses {losses}, "
                         f"launches per step {per_step} {per_step_dt}, "
                         f"gradients {grads}, float32 {master_ok}, "
                         f"captured vs eager {turns}")
    return counts


def flat_weights(torch, net):
    """Every parameter of ``net``, flattened into one float32 tensor on
    its device (a bf16 weight widened exactly)."""
    return torch.cat([p.detach().float().reshape(-1)
                      for p in net.parameters()])


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def loop_steps(torch, loop, x, y, steps):
    """``TrainLoop.step`` up to global step ``steps``: {step index: loss
    mean}, and per step (index, wall ms to a synchronize, whether a
    background checkpoint write was in flight when it began)."""
    mgr = loop.checkpoint_manager
    losses, timed = {}, []
    for i in range(loop.global_step, steps):
        writing = mgr is not None and mgr.writing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loop.step(x, y)
        torch.cuda.synchronize()
        timed.append((i, (time.perf_counter() - t0) * 1e3, writing))
        losses[i] = float(loss.float().mean())
    loop.synchronize()
    return losses, timed


def states_equal(a, b):
    """Names whose arrays differ between two ``TrainState``-like
    (arrays, meta) pairs, the update counts and scheduler among them."""
    (aa, am), (ba, bm) = a, b
    bad = sorted(set(aa) ^ set(ba))
    bad += [k for k in set(aa) & set(ba)
            if aa[k].dtype != ba[k].dtype or aa[k].shape != ba[k].shape
            or not (aa[k] == ba[k]).all()]
    bad += [k for k in ("num_update", "index_update_count", "lr_scheduler",
                        "optimizer", "param_names") if am.get(k) != bm.get(k)]
    return bad


def checkpoint_phase(torch, np, K, dev, smi, bf16=False):
    """Phase 6c: phase 6's BERT-base training (float32, or converted to
    bf16 with Adam's ``multi_precision``: bf16 weights, float32 masters)
    through ``TrainLoop(checkpoint_dir=..., checkpoint_every=5)``.

    CKPT_RUNS uninterrupted 10-step runs measure the spread; a run saves
    at step 5 (in the background) and goes on two steps while the write is
    in flight; a fresh net, trainer and loop on the same directory resume
    and run steps 6-10. Gates: the checkpoint holds what was captured at
    step 5 and the restored state (parameters, states, masters, counts,
    scheduler, RNG) equals it bit for bit; the resumed run's losses and
    final weights within the spread (bit-equal where the runs are); the
    resumed steps launch exactly phase 6's kernels. Prints capture ms,
    write s, checkpoint bytes, restore s and the step's ms with and
    without a write in flight. Returns the resumed net (float32) for the
    serving check."""
    import shutil
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.checkpoint import (capture_train_state,
                                            read_checkpoint)
    from mxnet_tpu_torch.gluon import Trainer, TrainLoop
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params

    dtype = "bfloat16" if bf16 else "float32"

    def make():
        net = BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=0.1,
                                       device=dev),
                             num_classes=2, dropout=0.1, device=dev)
        if bf16:
            amp.convert_hybrid_block(net)      # LayerNorms stay float32
        return net.train()

    def loop_for(net, **kw):
        trainer = Trainer(dict(net.named_parameters()), "adam",
                          {"learning_rate": TRAIN_LR,
                           "multi_precision": bf16})
        return TrainLoop(net, trainer, loss_fn, **kw)

    t_setup = time.perf_counter()
    net = make()
    init = init_params_numpy(net, seed=2)
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = torch.from_numpy(rs.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (TRAIN_BATCH,))
                         .astype(np.float32)).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    root = os.path.join(CKPT_DIR, dtype)
    shutil.rmtree(root, ignore_errors=True)
    try:
        runs, plain = [], []
        for _ in range(CKPT_RUNS):
            load_jax_params(net, init)
            torch.manual_seed(0)            # the dropout masks
            losses, timed = loop_steps(torch, loop_for(net), x, y,
                                       TRAIN_STEPS)
            runs.append((losses, flat_weights(torch, net)))
            plain += [ms for i, ms, _ in timed if i > 0]
        setup_s = time.perf_counter() - t_setup

        # the run that saves at step 5 and goes on while the write is in
        # flight; its own capture of step 5 is what the checkpoint must hold
        load_jax_params(net, init)
        torch.manual_seed(0)
        loop = loop_for(net, checkpoint_dir=root,
                        checkpoint_every=CKPT_SAVE_AT)
        mgr = loop.checkpoint_manager
        loop_steps(torch, loop, x, y, CKPT_SAVE_AT)
        captured = capture_train_state(trainer=loop.trainer, net=net,
                                       step=CKPT_SAVE_AT)
        _, timed = loop_steps(torch, loop, x, y,
                              CKPT_SAVE_AT + CKPT_WRITE_STEPS)
        writing_ms = [ms for _, ms, w in timed if w]
        loop.wait()
        path = mgr.latest_path()
        saved_step = mgr.latest_step()
        capture_ms, write_s = mgr.stats["capture_s"] * 1e3, \
            mgr.stats["write_s"]
        nbytes = dir_bytes(path)
        del loop, mgr, net

        # fresh objects on the same directory: auto-resume, steps 6-10
        net_b = make()
        t0 = time.perf_counter()
        loop_b = loop_for(net_b, checkpoint_dir=root,
                          checkpoint_every=CKPT_SAVE_AT)
        resume_wall_s = time.perf_counter() - t0
        restore_s = loop_b.checkpoint_manager.stats["restore_s"]
        resumed_at = loop_b.global_step
        disk, manifest = read_checkpoint(path)
        restored = capture_train_state(trainer=loop_b.trainer, net=net_b,
                                       step=CKPT_SAVE_AT)
        disk_vs_captured = states_equal((disk, manifest["meta"]),
                                        (captured.arrays, captured.meta))
        restored_vs_disk = states_equal((restored.arrays, restored.meta),
                                        (disk, manifest["meta"]))
        bf16_params = sorted({e["dtype"] for k, e in
                              manifest["arrays"].items()
                              if k.startswith("param/")})
        master_keys = sum(1 for k, e in manifest["arrays"].items()
                          if k.startswith("opt/") and e["dtype"] == "float32")
        del captured, restored, disk
        # the resumed loop's step captures its signature first (float32;
        # bf16 + multi_precision runs eagerly), so the counts below are
        # its steps' alone
        loop_b.compiled_step.aot_compile(x, y)
        step_mode = loop_b.compiled_step.mode
        K.reset_launch_counts()
        resumed, _ = loop_steps(torch, loop_b, x, y, TRAIN_STEPS)
        launches = K.launch_counts()
        n_traces_resumed = loop_b.compiled_step.n_traces
        loop_b.wait()
        w_res = flat_weights(torch, net_b)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)

    steps = sorted(resumed)

    def loss_dist(a, b):
        return max(abs(a[i] - b[i]) for i in steps)

    def w_rms(a, b):
        return float((a - b).double().pow(2).mean().sqrt())

    def w_max(a, b):
        return float((a - b).abs().max())

    pairs = [(i, j) for i in range(len(runs)) for j in range(i + 1,
                                                             len(runs))]
    spread = {"loss": max(loss_dist(runs[i][0], runs[j][0])
                          for i, j in pairs),
              "weights_rms": max(w_rms(runs[i][1], runs[j][1])
                                 for i, j in pairs)}
    nearest = {"loss": min(loss_dist(resumed, r[0]) for r in runs),
               "weights_rms": min(w_rms(w_res, r[1]) for r in runs)}
    within = {m: nearest[m] <= CKPT_SPREAD_FACTOR * spread[m]
              if spread[m] > 0 else nearest[m] == 0 for m in spread}
    # beside the gate: the largest element's difference, which one
    # element with a tiny Adam denominator decides
    weights_max = {"pairs": [w_max(runs[i][1], runs[j][1])
                             for i, j in pairs],
                   "resumed": [w_max(w_res, r[1]) for r in runs]}
    weights_unequal = {"pairs": [int((runs[i][1] != runs[j][1]).sum())
                                 for i, j in pairs],
                       "resumed": [int((w_res != r[1]).sum())
                                   for r in runs]}
    expect = {n: 0 for n in K.KERNELS}
    # one update launch a step: the captured step's, or the eager one's
    # over the float32 masters (and float32 LayerNorms) under bf16
    expect.update(flash_fwd=12, flash_bwd_fused=12, layernorm_fwd=25,
                  layernorm_bwd=25, opt_update=1)
    expect = {n: c * len(steps) for n, c in expect.items()}
    print(smi, flush=True)
    report = {
        "model": "bert_base classifier", "dtype": dtype,
        "step_mode": step_mode, "n_traces_resumed": n_traces_resumed,
        "multi_precision": bf16, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "optimizer": "adam", "learning_rate": TRAIN_LR, "dropout": 0.1,
        "saved_at_step": saved_step, "resumed_at_step": resumed_at,
        "resumed_steps": [i + 1 for i in steps],
        "capture_ms": capture_ms, "write_s": write_s,
        "checkpoint_bytes": nbytes, "restore_s": restore_s,
        "resume_wall_s": resume_wall_s,
        "step_ms_median": statistics.median(plain),
        "step_ms_with_write_in_flight": writing_ms,
        "param_dtypes_on_disk": bf16_params,
        "float32_state_arrays_on_disk": master_keys,
        "disk_vs_captured_mismatch": disk_vs_captured,
        "restored_vs_disk_mismatch": restored_vs_disk,
        "uninterrupted_losses": [[r[0][i] for i in range(TRAIN_STEPS)]
                                 for r in runs],
        "resumed_losses": [resumed[i] for i in steps],
        "spread": spread, "nearest_uninterrupted": nearest,
        "spread_factor": CKPT_SPREAD_FACTOR, "within_spread": within,
        "weights_max_abs_diff": weights_max,
        "weights_elements_unequal": weights_unequal,
        "launches_resumed": launches, "launches_expected": expect,
        "setup_s": setup_s, "card": smi}
    # converted to bf16, the LayerNorms keep float32 parameters
    report["ok"] = (saved_step == CKPT_SAVE_AT
                    and resumed_at == CKPT_SAVE_AT
                    and not disk_vs_captured and not restored_vs_disk
                    and bf16_params == (["bfloat16", "float32"] if bf16
                                        else ["float32"])
                    and all(within.values()) and launches == expect
                    and step_mode == ("eager" if bf16 else "fused")
                    and n_traces_resumed == (0 if bf16 else 1)
                    and all(math.isfinite(v) for v in resumed.values()))
    emit({"checkpoint_bf16" if bf16 else "checkpoint": report})
    if not report["ok"]:
        raise SystemExit(f"checkpoint phase failed: {report}")
    return net_b


def serve_loaded(torch, np, dev, smi, trained):
    """Phase 6c, serving: ``save_parameters`` of the resumed net, then
    ``load_parameters`` into the net of a warmed ``CompiledPredictor``
    (bucket 32, its own random weights): its replies must equal that net
    called eagerly on the loaded weights bit for bit, differ from the
    replies before the load, and nothing may be captured again."""
    import shutil
    from mxnet_tpu_torch.gluon import load_parameters, save_parameters
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.serving import CompiledPredictor
    os.makedirs(CKPT_DIR, exist_ok=True)
    fname = os.path.join(CKPT_DIR, "bert_base.params")
    try:
        save_parameters(trained, fname)
        file_bytes = os.path.getsize(fname)
        torch.manual_seed(1)
        net = BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=0.1,
                                       device=dev),
                             num_classes=2, dropout=0.1, device=dev)
        pred = CompiledPredictor(net, bucket_sizes=(SERVE_MAX_BATCH,))
        vocab = net.bert.word_embed.weight.shape[0]
        rs = np.random.RandomState(4)
        pred.warmup(rs.randint(0, vocab, (1, SERVE_SEQ)).astype(np.int64))
        traces = pred.n_traces
        xb = rs.randint(0, vocab, (SERVE_MAX_BATCH, SERVE_SEQ)) \
            .astype(np.int64)
        before = pred.predict(xb).clone()
        t0 = time.perf_counter()
        load_parameters(pred.net, fname)
        load_s = time.perf_counter() - t0
        got = pred.predict(xb)
        with torch.inference_mode():
            ref = pred.net(torch.from_numpy(xb).to(dev))
        loaded = all(torch.equal(a, b.to(a.device)) for a, b in zip(
            pred.net.parameters(), trained.parameters()))
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    report = {"bucket": SERVE_MAX_BATCH, "seq": SERVE_SEQ,
              "file_bytes": file_bytes, "load_s": load_s,
              "weights_equal_trained": loaded,
              "bit_equal_to_eager": bool(torch.equal(got, ref)),
              "max_abs_diff": float((got - ref).abs().max()),
              "changed_by_load": not bool(torch.equal(got, before)),
              "n_traces_before": traces, "n_traces_after": pred.n_traces,
              "card": smi}
    report["ok"] = (loaded and report["bit_equal_to_eager"]
                    and report["changed_by_load"]
                    and pred.n_traces == traces)
    emit({"checkpoint_serving": report})
    if not report["ok"]:
        raise SystemExit(f"checkpoint serving check failed: {report}")


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

    from mxnet_tpu_torch.gluon import Trainer
    make, net, x, y, loss_fn, step = long_setup(torch, np, dev)
    init = {n: p.detach().to("cpu", copy=True).numpy()
            for n, p in net.named_parameters()}
    made = [net]
    del net, step

    def build():
        net = made.pop() if made else make(dev)
        load_jax_params(net, init)
        net.train()
        torch.manual_seed(1)        # the dropout masks
        return net, Trainer(dict(net.named_parameters()), "adam",
                            {"learning_rate": TRAIN_LR}), loss_fn

    turns, (net, trainer, _), gated = train_turns(
        torch, K, build, torch.from_numpy(x).to(dev),
        torch.from_numpy(y).to(dev), LONG_STEPS, LONG_BATCH * LONG_SEQ,
        exact=False)
    losses, step_ms, per_step, counts = gated
    expect = {n: 0 for n in K.KERNELS}
    expect.update(flash_fwd=LONG_LAYERS, flash_bwd_dq=LONG_LAYERS,
                  flash_bwd_dkv=LONG_LAYERS,
                  layernorm_fwd=2 * LONG_LAYERS + 1,
                  layernorm_bwd=2 * LONG_LAYERS + 1, opt_update=1)
    cpu_net = copy_to_cpu(lambda: make("cpu"), net, load_jax_params)
    grads = grad_check(torch, net, cpu_net, loss_fn, x, y)
    ok = all(s == expect for s in per_step) and grads["ok"] and \
        all(math.isfinite(v) for v in losses) and turns["ok"]
    emit({"train_long": {
        "layers": LONG_LAYERS, "batch": LONG_BATCH, "seq": LONG_SEQ,
        "steps": LONG_STEPS, "losses": losses, "step_ms": step_ms,
        "median_step_ms": statistics.median(step_ms[1:]),
        "capture_s": turns["capture_s"][0],
        "n_traces_after_warmup": turns["turns"][0]["n_traces_after_warmup"],
        "n_traces_after_steps": turns["turns"][0]["n_traces_after_steps"],
        "launches": counts, "launches_per_step": per_step,
        "launches_per_step_expected": expect,
        "grad_check": dict(grads, batch=LONG_BATCH, seq=LONG_SEQ),
        "captured_vs_eager": turns, "ok": ok}})
    if not ok:
        raise SystemExit(f"long-sequence phase failed: {per_step}, {grads}"
                         f", captured vs eager {turns}")
    return counts


def serve_bert(torch, np, K, dev, dtype="float32"):
    """Phase 4: BERT-base served through the batcher; the launch counts
    of exactly this run, and the predictor. Phase 4b (``dtype``
    "bfloat16"): the same weights and traffic through
    ``predictor_for(net, dtype="bfloat16")`` (every parameter but the
    LayerNorms' in bf16), its logits against a CPU copy converted the
    same way, its launches held by input dtype."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.serving import DynamicBatcher, loadgen, \
        predictor_for

    t0 = time.perf_counter()
    net = BERTClassifier(bert_base(device=dev), num_classes=2, device=dev)
    params = init_params_numpy(net, seed=0)
    load_jax_params(net, params)
    n_params = sum(p.numel() for p in net.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pred = predictor_for(net, dtype=dtype, device=dev)
    rs = np.random.RandomState(0)
    vocab = net.bert.word_embed.weight.shape[0]
    warm = pred.warmup(rs.randint(0, vocab, (1, SERVE_SEQ)).astype(np.int64))
    traces_warm = pred.n_traces
    emit({"serving_setup": {"params": n_params, "dtype": dtype,
                            "setup_s": time.perf_counter() - t0,
                            "captures": len(warm),
                            "capture_s": {str(b): s_ for b, s_ in
                                          warm.items()},
                            "n_traces_after_warmup": traces_warm,
                            "service_time_seed_s": pred.service_time_seed_s,
                            "max_memory_allocated_after_warmup":
                            torch.cuda.max_memory_allocated()}})
    gve = predictor_graph_vs_eager(torch, np, pred, vocab)
    emit({"serving_graph_vs_eager": dict(gve, dtype=dtype)})
    if not gve["ok"]:
        raise SystemExit(f"{dtype} replays differ from the eager net: {gve}")
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
    counts_dt = K.launch_counts_by_dtype()
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
        "launches": counts, "launches_by_dtype": counts_dt,
        "n_traces_after_warmup": traces_warm, "n_traces": pred.n_traces,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "dtype": dtype}
    emit({"serving_bf16" if dtype != "float32" else "serving": report})
    if rep["errors"] or rep["requests"] != SERVE_REQUESTS:
        raise SystemExit(f"serving failed: {rep}")
    if not traces_warm == pred.n_traces == len(pred.bucket_sizes):
        raise SystemExit(f"programs captured: {traces_warm} after warm-up, "
                         f"{pred.n_traces} after traffic; expected one per "
                         f"bucket ({len(pred.bucket_sizes)})")
    for i, out in enumerate(results):
        if out is None or out.shape != (reqs[i].shape[0], 2) or \
                not np.isfinite(out).all():
            raise SystemExit(f"request {i}: bad logits {out!r}")
    nb = stats["batches"]
    # every LayerNorm sees the embedding's or a residual's dtype: bf16
    # once the embeddings are bf16
    expect_dt = {"flash_fwd": {dtype: 12 * nb},
                 "layernorm_fwd": {dtype: 25 * nb}}
    if counts["flash_fwd"] != 12 * nb or counts["layernorm_fwd"] != 25 * nb \
            or any(counts_dt.get(k) != v for k, v in expect_dt.items()):
        raise SystemExit(f"launches {counts_dt} do not match 12 flash and 25 "
                         f"LayerNorm per micro-batch ({nb} micro-batches) "
                         f"in {dtype}")

    # two requests again through a CPU copy (plain kernels)
    cpu_net = BERTClassifier(bert_base(device="cpu"), num_classes=2,
                             device="cpu")
    load_jax_params(cpu_net, params)
    cpu_pred = predictor_for(cpu_net, dtype=dtype, device="cpu")
    errs, refs = [], []
    for i in (0, 1):
        padded, n = cpu_pred.pad_to_bucket(reqs[i])
        ref = cpu_pred.predict(*padded)[:n].float().numpy()
        refs.append(float(np.abs(ref).max()))
        errs.append(float(np.abs(ref - results[i]).max()))
    atol = LOGIT_ATOL if dtype == "float32" else LOGIT_RTOL_BF16 * max(refs)
    emit({"serving_vs_cpu": {"dtype": dtype, "requests": [0, 1],
                             "max_abs_err": max(errs),
                             "max_abs_logit": max(refs), "atol": atol}})
    if max(errs) > atol:
        raise SystemExit(f"GPU logits differ from the CPU copy: {errs}")
    return counts, pred


def predictor_graph_vs_eager(torch, np, pred, vocab, seed=1):
    """Each bucket's replay against ``pred.net`` called eagerly (no
    program) on the same padded batch: the largest |difference| of the
    logits and whether they are bit-equal; ``ok`` when every bucket is
    within GRAPH_ATOL (bf16: of the largest logit)."""
    rs = np.random.RandomState(seed)
    out, ok = {}, True
    for b in pred.bucket_sizes:
        x = rs.randint(0, vocab, (b, SERVE_SEQ)).astype(np.int64)
        got = pred.predict(x)
        with torch.inference_mode():
            ref = pred.net(torch.from_numpy(x).to(pred.device))
        diff = float((got.float() - ref.float()).abs().max())
        dt = str(got.dtype).replace("torch.", "")
        tol = GRAPH_ATOL[dt] * (float(ref.float().abs().max())
                                if dt != "float32" else 1.0)
        ok = ok and diff <= tol
        out[str(b)] = {"bit_equal": bool(torch.equal(got, ref)),
                       "max_abs_diff": diff, "atol": tol}
    return {"buckets": out, "ok": ok,
            "all_bit_equal": all(r["bit_equal"] for r in out.values())}


def param_check_us(programs, n=1000):
    """Host µs of one check that the parameters did not move since a
    capture (``Programs.ptrs``, made on every predict and decode step):
    the mean of ``n``."""
    t0 = time.perf_counter()
    for _ in range(n):
        programs.ptrs()
    return (time.perf_counter() - t0) / n * 1e6


def profile_bucket(torch, np, pred, smi, bucket=SERVE_MAX_BATCH, iters=5,
                   x=None):
    """``--profile``: where the time of one served micro-batch goes, on
    the bucket's captured program (``x``: the batch, BERT token rows of
    SERVE_SEQ when None). Unprofiled, ``iters`` predicts each
    from an idle device: wall ms (to the synchronize) and host ms (the
    predict call alone: input copy, replay, output copy); the device ms
    of ``iters`` back-to-back predicts between CUDA events; then
    ``torch.profiler`` over ``iters`` back-to-back predicts: kernel time
    summed by family and the device's busy share of the wall time, under
    the profiler and of the unprofiled median wall; and the host µs of
    the check that the parameters did not move (:func:`param_check_us`)."""
    from torch.profiler import ProfilerActivity, profile

    if x is None:
        vocab = pred.net.bert.word_embed.weight.shape[0]
        x = np.random.RandomState(2).randint(
            0, vocab, (bucket, SERVE_SEQ)).astype(np.int64)
    pred.predict(x)
    torch.cuda.synchronize()
    wall, host = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        pred.predict(x)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        pred.predict(x)
    end.record()
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
    report = {
        "bucket": bucket, "shape": list(x.shape), "iters": iters,
        "dtype": str(next(pred.net.parameters()).dtype),
        "wall_ms": wall, "host_ms": host,
        "device_ms_per_batch_events": start.elapsed_time(end) / iters,
        "wall_ms_per_batch_under_profiler": wall_us / iters / 1e3,
        "device_ms_per_batch": {k: v / iters / 1e3
                                for k, v in families.items()},
        "device_busy_share": busy / wall_us if busy else
        "not measured (the profiler saw no device time)",
        "device_busy_share_unprofiled": busy / iters / 1e3
        / statistics.median(wall) if busy else "not measured",
        "param_check_us": param_check_us(pred._programs),
        "n_traces": pred.n_traces, "card": smi}
    emit({"profile": report})
    return report


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
    init = init_params_numpy(net, seed=6)
    rs = np.random.RandomState(7)
    x = rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT)).astype(np.int64)
    y = rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT)).astype(np.float32)
    loss_fn = SoftmaxCrossEntropyLoss()
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    made = [net]
    del net

    def build():
        net = made.pop() if made else make(dev)
        load_jax_params(net, init)
        net.train()
        return net, Trainer(dict(net.named_parameters()), "sgd",
                            {"learning_rate": LM_LR, "momentum": 0.9}), \
            loss_fn

    setup_s = time.perf_counter() - t0
    tokens = LM_BATCH * LM_BPTT
    turns, (net, trainer, _), gated = train_turns(
        torch, K, build, xt, yt, LM_STEPS, tokens, exact=True)
    losses, step_ms, per_step, counts = gated
    peak = turns["captured_max_memory_allocated"][0]
    median_ms = statistics.median(step_ms[1:])
    expect = {n: 0 for n in K.KERNELS}
    expect.update(rnn_scan_fwd=LM_LAYERS, rnn_scan_bwd=LM_LAYERS,
                  opt_update=1)
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
    report = {
        "model": "WordLM (LSTM LM)", "vocab": LM_VOCAB, "embed": LM_EMBED,
        "hidden": LM_HIDDEN, "layers": LM_LAYERS, "dtype": "float32",
        "batch": LM_BATCH, "bptt": LM_BPTT, "steps": LM_STEPS,
        "optimizer": "sgd", "momentum": 0.9, "learning_rate": LM_LR,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": tokens / (median_ms / 1e3),
        "max_memory_allocated": peak, "setup_s": setup_s,
        "capture_s": turns["capture_s"][0],
        "n_traces_after_warmup": turns["turns"][0]["n_traces_after_warmup"],
        "n_traces_after_steps": turns["turns"][0]["n_traces_after_steps"],
        "launches": counts, "launches_per_step": per_step[-1],
        "launches_per_step_expected": expect,
        "grad_check": dict(grads, batch=LM_GRAD_BATCH, bptt=LM_BPTT,
                           seconds=grad_s),
        "captured_vs_eager": turns, "card": smi,
        "ok": launches_ok and losses_ok and grads["ok"] and turns["ok"]}
    emit({"lstm_train": report})
    if not report["ok"]:
        raise SystemExit(f"LSTM LM phase failed: losses {losses}, launches "
                         f"per step {per_step}, gradients {grads}, "
                         f"captured vs eager {turns}")

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


def train_dense(torch, K, dev, smi):
    """Phase 8b: a Dense-only model (BERT-base's FFN widths, 768 -> 3072
    -> 768 -> 2, on DENSE_ROWS rows), DENSE_STEPS Adam steps in phase 6's
    turns: the replays bit-equal to the step's body run eagerly (every
    kernel deterministic), finite losses, one ``opt_update`` a step for
    all six parameters and nothing else launched."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.nn import Dense
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(DENSE_ROWS, 768, generator=g, device=dev)
    y = torch.randint(0, 2, (DENSE_ROWS,), generator=g, device=dev).float()
    loss_fn = SoftmaxCrossEntropyLoss()

    def build():
        init = torch.Generator().manual_seed(5)
        net = torch.nn.Sequential(
            Dense(3072, activation="relu", in_units=768, device=dev,
                  generator=init),
            Dense(768, in_units=3072, device=dev, generator=init),
            Dense(2, in_units=768, device=dev, generator=init))
        return net, Trainer(dict(net.named_parameters()), "adam",
                            {"learning_rate": 1e-3}), loss_fn

    turns, _, gated = train_turns(
        torch, K, build, x, y, DENSE_STEPS, DENSE_ROWS, exact=True)
    losses, _, per_step, counts = gated
    expect = {n: 0 for n in K.KERNELS}
    expect.update(opt_update=1)
    report = {"model": "Dense 768 -> 3072 -> 768 -> 2", "rows": DENSE_ROWS,
              "steps": DENSE_STEPS, "optimizer": "adam", "losses": losses,
              "launches_per_step": per_step,
              "launches_per_step_expected": expect,
              "captured_vs_eager": turns, "card": smi,
              "ok": turns["ok"] and all(p == expect for p in per_step)
              and all(math.isfinite(v) for v in losses)}
    emit({"dense_train": report})
    if not report["ok"]:
        raise SystemExit(f"Dense-only phase failed: {report}")
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
            "warmup_s", "captures", "n_traces", "errors", "acceptance_rate",
            "tokens_per_step", "spec_steps", "prefix_hits", "cow_copies",
            "kv_shared_peak")
    line = {k: rep[k] for k in keys if k in rep}
    line["rnn_decode_launches"] = rep["launches"]["rnn_decode"]
    line.update(extra or {}, card=smi)
    emit({name: line})


def decode_run(torch, K, model, prompts, mns, **kw):
    """``serving.run_decode`` on the card with the kernel counts set to 0
    just before it: (report with the run's peak memory, launches of the
    whole call)."""
    from mxnet_tpu_torch import serving
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rep = serving.run_decode(model, prompts, mns, ladder=DECODE_LADDER,
                             page_size=DECODE_PAGE, **kw)
    torch.cuda.synchronize()
    rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return rep, K.launch_counts()


def decode_gates(rep, spec_k=0):
    """The run's own checks: no error, no program captured after the
    warm-up, and its rnn_decode launches after the warm-up exactly one a
    decode step (spec_k + 1 a verify step) plus the chunk width per
    prefill chunk."""
    per_step = spec_k + 1
    want = per_step * rep["steps"] + 16 * rep["prefill_chunks"]
    return rep["errors"] == 0 and rep["n_traces"] == 0 and \
        rep["launches"]["rnn_decode"] == want, want


def decode_graph_vs_eager(torch, np, model, spec_k=0, seed=5):
    """Every warm-up program of an engine over ``model`` (slot ladder
    1-8, ``spec_k``) replayed against its body run eagerly: the model's
    entry point called directly, then the state stitch. Both start from
    one random state (slot state, tokens, K/V pages) and random inputs
    (disjoint page tables, so no two slots write one position); their
    outputs and new state (the null page aside, where inactive slots'
    writes collide) are compared bit for bit."""
    from mxnet_tpu_torch.serving import DecodeEngine
    from mxnet_tpu_torch.serving.captured import map_tensors
    eng = DecodeEngine(model, ladder=DECODE_LADDER, page_size=DECODE_PAGE,
                       max_context=80, start=False, spec_k=spec_k,
                       prefix_share=False)
    rs = np.random.RandomState(seed)
    g = torch.Generator(device=model.device).manual_seed(seed)
    ps, mp = eng.kv.page_size, eng.max_pages_per_slot
    state = (eng._h, eng._c, eng._tokens_dev, eng.kv.k_pages, eng.kv.v_pages)

    def flat(out):
        got = []
        map_tensors(got.append, out)
        return got

    try:
        warm = eng.warmup()
        with torch.no_grad():
            for t in state[:2] + state[3:]:
                t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                        .to(t.dtype) * 0.5)
            state[2].copy_(torch.from_numpy(
                rs.randint(0, model.vocab, eng.slots)))
        res = {}
        for kind, b in sorted(warm):
            prog = eng._entry(kind, b, count=False)
            table = rs.permutation(np.arange(1, eng.kv.num_pages))[
                :b * mp].reshape(b, mp)
            lengths = rs.randint(1, mp * ps + 1, b)
            width = {"decode": 1, "verify": spec_k + 1,
                     "prefill": eng._chunk}[kind]
            vals = {"pidx": table[np.arange(b), (lengths - 1) // ps],
                    "poff": (lengths - 1) % ps, "table": table,
                    "lengths": lengths,
                    "active": np.r_[True, rs.rand(b - 1) < 0.75],
                    "reset": rs.rand(b) < 0.3,
                    "tokens": rs.randint(0, model.vocab, (b, width)),
                    "start": rs.randint(0, mp * ps - width + 1, b),
                    "n_valid": rs.randint(1, width + 1, b),
                    "n_draft": rs.randint(1, width + 1, b)}
            eng._stage([vals[name] for name, _ in eng._fields(kind, b)])
            saved = [t.clone() for t in state]
            got = flat(prog.run()) + [t.clone() for t in state]
            for t, v in zip(state, saved):
                t.copy_(v)
            ref = flat(map_tensors(torch.clone, prog.body(*prog.inputs))) \
                + [t.clone() for t in state]
            for t, v in zip(state, saved):
                t.copy_(v)
            got[-2:] = [t[:, 1:] for t in got[-2:]]
            ref[-2:] = [t[:, 1:] for t in ref[-2:]]
            res[f"{kind} {b}"] = {
                "bit_equal": all(bool(torch.equal(a, r))
                                 for a, r in zip(got, ref)),
                "max_abs_diff": max(float((a.double() - r.double()).abs()
                                          .max()) for a, r in zip(got, ref))}
        return {"programs": res, "captures": len(warm),
                "n_traces": eng.n_traces,
                "ok": all(r["bit_equal"] for r in res.values())
                and eng.n_traces == 0}
    finally:
        eng.close()


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
    gve_runs = [("continuous", model, DECODE_SPEC_K if leg else 0)]
    if leg:
        gve_runs.append(("gqa", runs[-1][1], DECODE_SPEC_K))
    for what, m, sk in gve_runs:
        gve = decode_graph_vs_eager(torch, np, m, spec_k=sk)
        emit({f"{name}_graph_vs_eager": dict(gve, model=what, spec_k=sk)})
        if not gve["ok"]:
            raise SystemExit(f"{name} {what}: replays differ from the eager "
                             f"model or a program was captured live: {gve}")
    reps, path_counts = {}, None
    for what, m, cm, ps_, mn, kw in runs:
        rep, counts = decode_run(torch, K, m, ps_, mn, **kw)
        t1 = time.perf_counter()
        ref = run_cpu_decode(cm, ps_, mn, **kw)
        cpu_s = time.perf_counter() - t1
        late = check_tokens(torch, ATT, f"{name} {what} vs CPU copy",
                            rep["tokens_by_request"], ref, cm, ps_, horizon)
        if what == "gqa":
            ok = rep["errors"] == 0 and rep["n_traces"] == 0 and \
                counts["rnn_decode"] == 0
            want = 0
        else:
            ok, want = decode_gates(rep, kw.get("spec_k", 0))
        reps[what] = rep
        extra = {"launches_expected": want, "cpu_copy_s": cpu_s,
                 "tokens_equal_cpu_copy": late is None, "ok": ok,
                 "max_memory_allocated": rep["max_memory_allocated"]}
        if horizon is not None:
            extra.update(exact_horizon=horizon, first_difference_past_it=late,
                         cpu_state_drift_f32_vs_f64=state_drift(
                             torch, cm, ps_[0], ref[0]))
        if what == "continuous":
            path_counts = counts
        decode_line(name, rep, smi, dict(extra, run=what))
        if not ok:
            raise SystemExit(f"{name} {what}: errors {rep['errors']}, "
                             f"{rep['n_traces']} programs captured live or "
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


def seat_and_step(torch, np, eng, vocab, bucket=8, iters=5):
    """Seat ``bucket`` requests of 8 prompt tokens in the warmed engine
    ``eng`` (each prefill chunk dispatched and retired alone), then run
    ``iters`` bucket-``bucket`` decode steps, each from an idle device and
    retired. Returns (prefill chunk ms, decode step ms, decode step host
    ms): a step's ms run from the dispatch to its retire (host clock),
    its host ms to the end of the dispatch, before the retire waits."""
    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step_once()
        t1 = time.perf_counter()
        eng.sync()
        return (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3

    rng = np.random.RandomState(11)
    for _ in range(bucket):
        eng.submit(rng.randint(0, vocab, size=8), max_new=60)
    prefill_ms = []
    while any(o is None or o.phase != "decode" or o.generated < 1
              for o in eng._occupant):
        before = eng.stats["prefill_chunks"]
        ms = timed_step()[0]
        if eng.stats["prefill_chunks"] > before:
            prefill_ms.append(ms)
    steps = [timed_step() for _ in range(iters)]
    return prefill_ms, [w for w, _ in steps], [h for _, h in steps]


def profile_decode_step(torch, np, model, smi, bucket=8, iters=5):
    """``--profile``: where a decode step's time goes in decode_wide, on
    the captured programs. Eight requests are seated, then ``iters``
    bucket-8 decode steps are timed (:func:`seat_and_step`), then run
    under ``cProfile`` (the host functions with the most own time), then
    under ``torch.profiler`` (device time by kernel family per step, and
    the device's busy share of the wall time, under the profiler and of
    the unprofiled median step), and the host µs of the parameter check."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(model, ladder=DECODE_LADDER, page_size=DECODE_PAGE,
                       max_context=80, start=False)
    try:
        eng.warmup()
        prefill_ms, decode_ms, host_ms = seat_and_step(
            torch, np, eng, model.vocab, bucket, iters)
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
        n_traces = eng.n_traces
        check_us = param_check_us(eng._programs)
    finally:
        eng.close()
    families = device_us_by_family(torch, prof)
    busy = sum(families.values())
    top = sorted(device_us_by_kernel(torch, prof).items(),
                 key=lambda kv: -kv[1])[:8]
    emit({"decode_profile": {
        "bucket": bucket, "iters": iters, "steps_run": steps,
        "prefill_chunk_ms": prefill_ms,
        "decode_step_ms": decode_ms, "decode_step_host_ms": host_ms,
        "host_top_own_ms_per_step": [[name, calls // iters,
                                      own * 1e3 / iters]
                                     for name, calls, own in host_top],
        "wall_ms_per_step_under_profiler": wall_us / iters / 1e3,
        "device_ms_per_step": {k: v / iters / 1e3
                               for k, v in families.items()},
        "top_kernels_ms_per_step": [[k[:80], v / iters / 1e3]
                                    for k, v in top],
        "device_busy_share": busy / wall_us if busy else
        "not measured (the profiler saw no device time)",
        "device_busy_share_unprofiled": busy / iters / 1e3
        / statistics.median(decode_ms) if busy else "not measured",
        "param_check_us": check_us, "n_traces": n_traces, "card": smi}})


# ---------------------------------------------------------------------------
# kernel 12 (opt_update) and the ZeRO-1 update: phases 3, 10 and 11
# ---------------------------------------------------------------------------

#: the opt_update checks' lengths: ragged, BERT-base's word embedding
#: (30,522 x 768), its shard at dp 4 and its bucket unit (the 114
#: parameters under 2048 elements, concatenated)
OPT_RAGGED, OPT_EMBED, OPT_BUCKET = 5000, 30522 * 768, 88322
OPT_EMBED_SHARD = OPT_EMBED // 4
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
BERT_VOCAB = 30522
BERT_BASE_CLASSIFIER_PARAMS = 109_483_778
#: its parameter tensors, every one trainable: one opt_update launch each
#: a step on one card
BERT_BASE_TRAINABLE = 201
ZERO_SHARDS, ZERO_UNITS = 4, 88
#: phase 10's bf16 + multi_precision layout: Adam updates on the masters
ZERO_MP_STEPS = 3
#: phase 10's weights, sharded kernel updates vs eager ``trainer.step``:
#: the same float32 Adam rule, but the eager one takes 1 - b1**t in double
#: and the kernel a float32 powf, so the updates part by a few ulps
ZERO_WEIGHT_RTOL, ZERO_WEIGHT_ATOL = 1e-6, 1e-7
#: phase 11's first loss against a one-card forward of the same weights
ZERO_LOSS_ATOL = 1e-5
#: phase 11's resume at half the world from the step-5 checkpoint, its
#: losses against the full world's steps 6-10: the JAX package's dp 4 ->
#: dp 2 test bound (the gradient sums over the ranks in another order)
ZERO_RESUME_RTOL = 1e-5
#: phase 11 leg (a): the four BERT-base runs, in turns (serial: one
#: bucket reduced after the backward; overlap: 4 MiB buckets launched
#: from the backward's hooks)
OVERLAP_TURNS = ("serial", "overlap", "overlap", "serial")
#: leg (a)'s Dense-only model (BERT-base's FFN widths and a 2-way head),
#: trained DENSE_STEPS Adam steps on DENSE_ROWS rows
DENSE_ROWS, DENSE_STEPS = 4096, 3
#: legs (b) and phase 12's prefetch: host batches a run
PREFETCH_STEPS = 10
#: legs (c), (d): BERT-base widths with the depth cut to ELASTIC_LAYERS,
#: ELASTIC_STEPS steps a run
ELASTIC_LAYERS, ELASTIC_STEPS = 2, 8
#: phase 12: the in-process supervisor's run
ONE_CARD_STEPS = 6


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


def device_hparams(torch, dev, lr, wd, t, rescale, clip):
    """lr, wd, t, the rescale and the clip as the captured one-card step
    passes them: element 1 of a 2-parameter ``DeviceHParams`` block."""
    from mxnet_tpu_torch.optimizer.optimizer import DeviceHParams
    hp = DeviceHParams(2, dev)
    hp.stage([0.7, lr], [0.3, wd], [9, t], rescale, clip)
    lrs, wds, ts = hp.per_param()
    return lrs[1], wds[1], ts[1], hp.rescale, hp.clip


def check_opt_kernel(torch, KO, dev):
    """Phase 3, kernel 12: every kind x clip x hyperparameter form (host
    scalars, per-element vectors, device scalars read from a
    ``DeviceHParams`` block: the captured one-card step's form) x dtype at
    a ragged length, and every kind x clip x dtype in the form each path
    gives it: the word embedding (device scalars: the one-card step), its
    dp-4 shard (host scalars: ZeRO) and the bucket unit (vectors).
    float32: new states bit-exact, the weight within 1 ulp; bfloat16
    within OPT_BF16_TOL. Returns the timed cases by dtype (Adam, the word
    embedding, device scalars)."""
    failures, timed, seed = [], {}, 0
    worst = {"float32_weight_ulps": 0.0, "float32_state_max_abs_err": 0.0,
             "bfloat16_max_abs_err": 0.0}
    for n, forms in ((OPT_RAGGED, ("host", "vector", "device")),
                     (OPT_EMBED, ("device",)),
                     (OPT_EMBED_SHARD, ("host",)),
                     (OPT_BUCKET, ("vector",))):
        for code, kind, extra in OPT_KINDS:
            for clip in (False, True):
                for form in forms:
                    for dtype in (torch.float32, torch.bfloat16):
                        seed += 1
                        w, g, st, (lr, wd, t) = opt_case(
                            torch, dev, code, n, dtype, form == "vector",
                            seed)
                        hp = (lr, wd, t, 0.25, 0.5)
                        if form == "device":
                            hp = device_hparams(torch, dev, *hp)
                        cfg = dict(extra, has_clip=clip)
                        pw, ps = KO.unit_update_plain(
                            kind, cfg, w, g, *hp, st)
                        kw, ks = w.clone(), tuple(s.clone() for s in st)
                        KO.unit_update(kind, cfg, kw, g, *hp, ks)
                        torch.cuda.synchronize()
                        err = max(float((a.float() - b.float()).abs().max())
                                  for a, b in [(kw, pw)] + list(zip(ks, ps)))
                        dn = str(dtype).replace("torch.", "")
                        rec = {"kernel": "opt_update", "dtype": dn,
                               "kind": code, "n": n, "clip": clip,
                               "hparams": form, "max_abs_err": err}
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
                        if (n, code, clip, form) == (
                                OPT_EMBED, "adam", False, "device"):
                            timed[dn] = (rec, (w, g, st, hp))
    for code, kind, extra in OPT_KINDS:
        for dtype in (torch.float32, torch.bfloat16):
            for form in ("host", "vector", "device"):
                seed += 1
                rec = check_opt_list(torch, KO, dev, code, kind, extra,
                                     dtype, form, seed)
                emit({"check": rec})
                if not rec["ok"]:
                    failures.append(rec)
                key = f"{str(dtype).replace('torch.', '')}_list"
                worst[key + "_max_abs_err"] = max(
                    worst.get(key + "_max_abs_err", 0.0), rec["max_abs_err"])
    emit({"opt_update_worst": worst})
    if failures:
        raise SystemExit(f"opt_update checks failed: {failures}")
    return timed


#: check_opt_list's entries: 1 to 64 values, a bias, ragged lengths, one
#: of several chunks, the bucket unit's length, and (last) a view one
#: element into a larger buffer (the element path)
OPT_LIST = (1, 3, 64, 768, 5000, 8193, 20000, OPT_BUCKET, 999)


def check_opt_list(torch, KO, dev, code, kind, extra, dtype, form, seed):
    """Phase 3: ONE ``multi_update`` launch over the ragged, misaligned
    list OPT_LIST (clip on), every entry's lr / wd / t in ``form`` (host
    scalars, per-element vectors, or device scalars in a ``DeviceHParams``
    block with the rescale and the clip), against the plain version of
    each entry; in float32 every other entry is a master whose bfloat16
    copy the launch writes (equal to the rounding of the new weight).
    float32: states bit-exact and weights within 1 ulp; bfloat16 within
    OPT_BF16_TOL."""
    from mxnet_tpu_torch.ops import kernels as K
    units = [opt_case(torch, dev, code, n, dtype, form == "vector",
                      seed * 100 + i) for i, n in enumerate(OPT_LIST)]
    big = torch.empty(OPT_LIST[-1] + 1, device=dev, dtype=dtype)
    w_last = big[1:].copy_(units[-1][0])
    units[-1] = (w_last,) + units[-1][1:]
    hps = [u[3] if form == "vector" else
           (0.05 * (1 + i % 3), 0.01 * (i % 2), 1 + i % 4)
           for i, u in enumerate(units)]
    rescale, clip = 0.25, 0.5
    if form == "device":
        hp = device_hparams_list(torch, dev, hps, rescale, clip)
        hps, rescale, clip = hp
    lows = [torch.empty(u[0].numel(), dtype=torch.bfloat16, device=dev)
            if dtype == torch.float32 and i % 2 else None
            for i, u in enumerate(units)]
    cfg = dict(extra, has_clip=True)
    plain = KO.multi_update_plain(
        kind, cfg, [u[0] for u in units], [u[1] for u in units],
        *zip(*hps), rescale, clip, [u[2] for u in units])
    ws = [u[0].clone() for u in units]
    sts = [tuple(s.clone() for s in u[2]) for u in units]
    before = K.launch_counts()["opt_update"]
    KO.multi_update(kind, cfg, ws, [u[1] for u in units], *zip(*hps),
                    rescale, clip, sts, lows)
    torch.cuda.synchronize()
    launches = K.launch_counts()["opt_update"] - before
    err, ulps, st_err, lows_ok, bf16_ok = 0.0, 0.0, 0.0, True, True
    for u, kw, ks, (pw, ps), low in zip(units, ws, sts, plain, lows):
        err = max([err] + [float((a.float() - b.float()).abs().max())
                           for a, b in [(kw, pw)] + list(zip(ks, ps))])
        if dtype == torch.float32:
            ulps = max(ulps, opt_weight_ulps(torch, kw, pw, u[0]))
            st_err = max([st_err] + [float((a - b).abs().max())
                                     for a, b in zip(ks, ps)])
            if low is not None:
                lows_ok &= bool(torch.equal(low, kw.to(low.dtype)))
        else:
            bf16_ok &= all(compare(torch, a, b, OPT_BF16_TOL,
                                   OPT_BF16_TOL)[0]
                           for a, b in [(kw, pw)] + list(zip(ks, ps)))
    rec = {"kernel": "opt_update", "list": list(OPT_LIST),
           "dtype": str(dtype).replace("torch.", ""), "kind": code,
           "hparams": form, "clip": True, "launches": launches,
           "max_abs_err": err}
    if dtype == torch.float32:
        rec.update(weight_ulps=ulps, state_max_abs_err=st_err,
                   lows_are_the_rounding=lows_ok,
                   ok=launches == 1 and ulps <= 1 and st_err == 0.0
                   and lows_ok)
    else:
        rec.update(atol=OPT_BF16_TOL, rtol=OPT_BF16_TOL,
                   ok=launches == 1 and bf16_ok)
    return rec


def device_hparams_list(torch, dev, hps, rescale, clip):
    """A list's (lr, wd, t) as the captured one-card step passes them:
    views of one ``DeviceHParams`` block, with its rescale and clip."""
    from mxnet_tpu_torch.optimizer.optimizer import DeviceHParams
    hp = DeviceHParams(len(hps), dev)
    hp.stage(*zip(*hps), rescale, clip)
    return list(zip(*hp.per_param())), hp.rescale, hp.clip


def time_opt_kernel(torch, KO, timed):
    """Kernel, plain-version and ``torch._fused_adam_`` times of one Adam
    update of the word embedding in each dtype, the hyperparameters device
    scalars as phase 6 passes them, by CUDA-graph replay over copies
    larger than the L2. Bound: w, g, m, v read once and w, m, v written
    once (28 B an element in float32, 14 in bfloat16) against ~20 float32
    operations an element. Returns {("opt_update", dtype): timing}."""
    return dict(time_opt_case(torch, KO, dn, *case)
                for dn, case in timed.items())


def time_opt_case(torch, KO, dn, rec, args):
    w, g, st, hp = args
    lr, wd, t = float(hp[0]), float(hp[1]), int(hp[2])   # the library's
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
               "adam", cfg, w_, g_, *hp, st_),
           lambda w_, g_, st_, s_: KO.unit_update_plain(
               "adam", cfg, w_, g_, *hp, st_),
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
             "hparams": "device", "max_abs_err": rec["max_abs_err"],
             "ms": ms,
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


def time_whole_update(torch, K, KO, dev, what, params, opt, lr, batch,
                      expect, per_elem, library, library_name):
    """One card's whole float32 update as the captured step runs it
    (``Optimizer.whole_step_fn``: ONE ``opt_update`` launch for the
    ``expect`` parameters, lr / wd / t / rescale / clip read from a device
    block, each parameter its own lr, wd and t there, every state seeded
    nonzero). Its first run is held against the plain version of each
    parameter's unit on copies of the same inputs, reading the same
    block: float32 states bit-exact, each weight within 1 ulp; a miss, or
    other than one launch, ends the run. Then it is timed by CUDA-graph
    replay beside ``library(params, grads, states)`` (the yardstick; the port
    never calls it) and the plain version, against the bound of ``per_elem`` =
    (bytes, float32 operations) an element: each parameter's weight,
    gradient and states read once, the weight and states written once."""
    from mxnet_tpu_torch.optimizer.optimizer import DeviceHParams
    g = torch.Generator(device=dev).manual_seed(11)
    grads = [torch.randn(p.shape, generator=g, device=dev) * 1e-3
             for p in params]
    states = [opt.create_state(i, p) for i, p in enumerate(params)]
    for st in states:
        for s in opt.state_tensors(st):
            s.copy_(torch.rand(s.shape, generator=g, device=dev) * 1e-3)
    n_p = len(params)
    hp = DeviceHParams(n_p, dev)
    hp.stage([lr * (1 + (i % 7) / 7) for i in range(n_p)],
             [0.01 * (i % 3) for i in range(n_p)],
             [1 + i % 5 for i in range(n_p)], 1.0 / batch, 0.0)
    lrs, wds, ts = hp.per_param()
    kind, cfg = KO.opt_kernel_kind(opt)
    w_in = [p.clone() for p in params]
    st_in = [tuple(s.clone() for s in opt.state_tensors(st))
             for st in states]
    update = opt.whole_step_fn(params, states, hp)
    K.reset_launch_counts()
    update(grads)
    torch.cuda.synchronize()
    launches = K.launch_counts()["opt_update"]
    worst_ulps, worst_state, bad = 0.0, 0.0, []
    for i, (w, gr, st) in enumerate(zip(params, grads, states)):
        pw, ps = KO.unit_update_plain(
            kind, cfg, w_in[i].reshape(-1), gr.reshape(-1), lrs[i],
            wds[i], ts[i], hp.rescale, hp.clip,
            tuple(s.reshape(-1) for s in st_in[i]))
        ulps = opt_weight_ulps(torch, w.reshape(-1), pw, w_in[i].reshape(-1))
        st_err = max(float((a.reshape(-1) - b).abs().max())
                     for a, b in zip(opt.state_tensors(st), ps))
        worst_ulps, worst_state = max(worst_ulps, ulps), max(worst_state,
                                                             st_err)
        if ulps > 1 or st_err != 0.0:
            bad.append({"param": i, "shape": list(w.shape),
                        "weight_ulps": ulps, "state_max_abs_err": st_err})
    del w_in, st_in
    lib_states = [tuple(s.clone() for s in opt.state_tensors(st))
                  for st in states]

    def plain_update():
        for i, (w, gr, st) in enumerate(zip(params, grads, states)):
            KO.unit_update_plain(kind, cfg, w.reshape(-1), gr.reshape(-1),
                                 lrs[i], wds[i], ts[i], hp.rescale, hp.clip,
                                 tuple(s.reshape(-1)
                                       for s in opt.state_tensors(st)))

    ms, eager_ms = time_ms(torch, lambda: update(grads), [()], iters=10)
    plain_ms, _ = time_ms(torch, plain_update, [()], iters=3, replays=2)
    try:
        library_ms, library_eager_ms = time_ms(
            torch, lambda: library(params, grads, lib_states), [()],
            iters=10)
        lib_err = None
    except Exception as e:    # the yardstick only: the port never calls it
        library_ms = library_eager_ms = None
        lib_err = f"{type(e).__name__}: {e}"[:300]
    n = sum(p.numel() for p in params)
    b_ms, b_by = bound_ms(per_elem[0] * n, per_elem[1] * n, "float32")
    rec = {"what": what, "parameters": n_p, "elements": n,
           "opt_update_launches": launches,
           "vs_plain": {"float32_weight_ulps": worst_ulps,
                        "float32_state_max_abs_err": worst_state,
                        "failed": bad[:10]},
           "ms": ms, "eager_ms": eager_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_eager_ms": library_eager_ms, "library_error": lib_err,
           "library": library_name,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": per_elem[0] * n,
           "ok": launches == 1 and n_p == expect and not bad}
    return rec


def time_bert_update(torch, K, KO, dev):
    """Phase 3: BERT-base's whole one-card float32 Adam update
    (:func:`time_whole_update`; 28 B and ~20 operations an element),
    beside ``torch._fused_adam_`` over the same list."""
    from mxnet_tpu_torch.optimizer.optimizer import Adam
    net = bert_base_classifier(torch, TRAIN_SEQ, dev)
    params = [p.detach() for p in net.parameters()]
    del net
    steps = [torch.ones((), device=dev) for _ in params]

    def library(params, grads, states):
        torch._fused_adam_(params, grads, [s[0] for s in states],
                           [s[1] for s in states], [], steps,
                           lr=TRAIN_LR, beta1=0.9, beta2=0.999,
                           weight_decay=0.0, eps=1e-8, amsgrad=False,
                           maximize=False)

    rec = time_whole_update(
        torch, K, KO, dev, "bert_base classifier Adam update, one card, "
        "float32", params, Adam(learning_rate=TRAIN_LR), TRAIN_LR,
        TRAIN_BATCH, BERT_BASE_TRAINABLE, (28, 20.0), library,
        "torch._fused_adam_ over the same list")
    emit({"bert_update_graph": rec})
    if not rec["ok"]:
        raise SystemExit(f"the one-card BERT-base update failed: {rec}")
    return rec


def time_resnet_update(torch, K, KO, dev):
    """Phase 14: resnet50_v1's whole one-card float32 SGD-momentum update
    over its RESNET50_TRAINABLE parameters, 64 to 2,359,296 values each
    (:func:`time_whole_update`; w, g, m read and w, m written: 20 B and
    ~7 operations an element), beside ``torch._fused_sgd_`` over the same
    list. Under amp the step updates the same float32 parameters."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.optimizer.optimizer import SGD
    net = resnet50_v1(classes=RESNET_CLASSES, device=dev)
    params = [p.detach() for p in net.parameters()
              if getattr(p, "grad_req", "write") != "null"]
    del net

    def library(params, grads, states):
        torch._fused_sgd_(params, grads, [s[0] for s in states],
                          weight_decay=0.0, momentum=RESNET_MOMENTUM,
                          lr=RESNET_LR, dampening=0.0, nesterov=False,
                          maximize=False, is_first_step=False)

    rec = time_whole_update(
        torch, K, KO, dev, "resnet50_v1 SGD-momentum update, one card, "
        "float32", params, SGD(learning_rate=RESNET_LR,
                               momentum=RESNET_MOMENTUM), RESNET_LR,
        RESNET_BATCH, RESNET50_TRAINABLE, (20, 7.0), library,
        "torch._fused_sgd_ over the same list")
    rec["sizes"] = [min(p.numel() for p in params),
                    max(p.numel() for p in params)]
    emit({"resnet_update_graph": rec})
    if not rec["ok"]:
        raise SystemExit(f"phase 14: the one-card resnet50_v1 update "
                         f"failed: {rec}")
    return rec


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
    ``Optimizer.kernel_step_fn()``, each rank's shards of every unit in
    one launch (what the ranks each do), reassembled; against ``steps``
    eager ``trainer.step`` updates of a copy with the same gradients."""
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
        packed = plan.pack_hparams(opt, lrs, wds, ts)
        fulls = [torch.empty(u["padded"], dtype=u["upd_dtype"], device=dev)
                 for u in plan.units]
        for r in range(ZERO_SHARDS):
            # rank r's update: all its shards in one launch
            ws, gs = [], []
            for k, f in enumerate(fulls):
                s = plan.shard_len(k)
                ws.append(plan.copy_shard(k, tz._params, r,
                                          f[r * s:(r + 1) * s]))
                gs.append(plan.copy_shard(k, grads, r,
                                          torch.empty_like(ws[-1])))
            fn(ws, gs, *plan.stage_hparams(*packed, r, dev),
               np.float32(opt.rescale_grad), np.float32(0.0), states[r])
        for k, f in enumerate(fulls):
            plan.write_unit(k, f)
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
    expect = ZERO_SHARDS * steps            # one launch a rank a step
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


def zero_layout_mp(torch, np, K, dev, smi, widths=None, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, steps=ZERO_MP_STEPS):
    """Phase 10, bf16 + ``multi_precision``: BERT-base converted to bf16
    (``amp.convert_hybrid_block``: the LayerNorms stay float32), Adam
    with ``multi_precision``. One backward at batch x seq gives fixed
    gradients; the plan at ZERO_SHARDS shards makes every bf16 parameter
    an mp unit with a float32 master shard on each rank. ``steps``
    updates through ``Optimizer.kernel_step_fn()``, each rank's shards
    in one launch (an mp unit's on its master, the gradient cast to
    float32, its weight's shard written as the master's rounding by the
    same launch), each weight gathered; against
    ``steps`` eager ``trainer.step`` updates of a copy (the Updater's
    masters). Checks: the mp units and their float32 masters, every
    ``opt_update`` launch in float32, each weight equal to its master in
    bf16, and the masters against the eager ones."""
    from mxnet_tpu_torch import amp
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
        amp.convert_hybrid_block(net)
    hp = {"learning_rate": TRAIN_LR, "multi_precision": True}
    trainers = [Trainer(dict(net.named_parameters()), "adam", dict(hp))
                for net in nets]
    rs = np.random.RandomState(3)
    vocab = nets[0].bert.word_embed.weight.shape[0]
    x = torch.from_numpy(rs.randint(0, vocab, (batch, seq))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (batch,))
                         .astype(np.float32)).to(dev)
    loss = SoftmaxCrossEntropyLoss()(nets[0](x), y)
    grads = [g.detach() for g in torch.autograd.grad(
        loss.float().sum(), trainers[0]._params)]
    del loss
    tz, te = trainers
    opt = tz.optimizer
    plan = _ZeroShardPlan(tz._params, opt, ZERO_SHARDS)
    states, masters = [], []
    for r in range(ZERO_SHARDS):
        states.append(plan.create_states(opt, r))
        masters.append(dict(plan.masters))
    mp_units = [k for k, u in enumerate(plan.units) if u["mp"]]
    n_bf16 = sum(1 for p in tz._params if p.dtype == torch.bfloat16)
    fn = opt.kernel_step_fn()
    n = len(tz._params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    K.reset_launch_counts()
    for _ in range(steps):
        opt.rescale_grad = 1.0 / batch
        lrs, wds, ts = opt.begin_fused_step(list(range(n)))
        packed = plan.pack_hparams(opt, lrs, wds, ts)
        # each unit gathered in its weight's dtype: an mp unit's shards
        # written by the launch as its masters' rounding
        fulls = [torch.empty(u["padded"], dtype=u["dtypes"][0], device=dev)
                 for u in plan.units]
        for r in range(ZERO_SHARDS):
            # rank r's update: all its shards, masters included, in one
            # launch
            ws, gs, lows = [], [], []
            for k, (u, f) in enumerate(zip(plan.units, fulls)):
                s = plan.shard_len(k)
                part = f[r * s:(r + 1) * s]
                ws.append(masters[r][k] if u["mp"] else
                          plan.copy_shard(k, tz._params, r, part))
                gs.append(plan.copy_shard(k, grads, r,
                                          torch.empty_like(ws[-1])))
                lows.append(part if u["mp"] else None)
            fn(ws, gs, *plan.stage_hparams(*packed, r, dev),
               np.float32(opt.rescale_grad), np.float32(0.0), states[r],
               lows=lows)
        for k, f in enumerate(fulls):
            plan.write_unit(k, f)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    counts_dt = K.launch_counts_by_dtype()

    for _ in range(steps):
        for p, g in zip(te._params, grads):
            p.grad = g.clone()
            p.fresh_grad = True
        te.step(batch)
    torch.cuda.synchronize()
    weights_are_masters = True
    worst, worst_name = 0.0, None
    for k in mp_units:
        j = plan.units[k]["members"][0]
        w = tz._params[j]
        full = torch.cat([masters[r][k] for r in range(ZERO_SHARDS)])
        master = full[:w.numel()].view(w.shape)
        weights_are_masters &= bool(torch.equal(w, master.to(w.dtype)))
        eager_master = te._updater.states[j][1]
        err = (master - eager_master).abs()
        bound = ZERO_WEIGHT_ATOL + ZERO_WEIGHT_RTOL * eager_master.abs()
        ratio = float((err / bound).max())
        if ratio > worst:
            worst, worst_name = ratio, tz._param_names[j]
    expect = ZERO_SHARDS * steps            # one launch a rank a step
    per_rank = [sum(t.numel() * t.element_size() for st in sts for t in st)
                + sum(m.numel() * m.element_size() for m in ms.values())
                for sts, ms in zip(states, masters)]
    report = {
        "model": "bert_base classifier, bf16 (LayerNorms float32)",
        "optimizer": "adam, multi_precision", "n_shards": ZERO_SHARDS,
        "units": len(plan.units), "mp_units": len(mp_units),
        "bf16_params": n_bf16, "steps": steps,
        "masters_float32": all(m.dtype == torch.float32
                               for ms in masters for m in ms.values()),
        "launches": counts["opt_update"], "launches_expected": expect,
        "launches_by_dtype": counts_dt.get("opt_update", {}),
        "weights_equal_master_in_bf16": weights_are_masters,
        "worst_master_err_over_bound": worst, "worst_param": worst_name,
        "rtol": ZERO_WEIGHT_RTOL, "atol": ZERO_WEIGHT_ATOL,
        "state_and_master_bytes_per_rank": per_rank, "setup_s": setup_s,
        "card": smi}
    report["ok"] = (len(mp_units) == n_bf16 > 0
                    and report["masters_float32"]
                    and report["launches"] == expect
                    and report["launches_by_dtype"] == {"float32": expect}
                    and weights_are_masters and worst <= 1.0)
    emit({"zero_layout_mp": report})
    if not report["ok"]:
        raise SystemExit(f"ZeRO multi-precision layout failed: {report}")
    return counts


def zero_rank(widths, batch, seq, steps, lr, ckpt_dir=None):
    """Phase 11, one rank: BERT-base through ``TrainLoop`` under
    ``make_mesh({"dp": world})`` on the global batch (each rank keeps its
    contiguous 1/world), dropout 0, ten Adam steps; with ``ckpt_dir`` the
    loop checkpoints every CKPT_SAVE_AT steps there (the shards gathered,
    rank 0 writing). Returns the rank's facts; rank 0 also holds a
    one-card forward of the initial weights on the whole batch, for the
    first loss."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon import Trainer, TrainLoop
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.parallel import dist, make_mesh

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
    losses, step_ms, per_step, ckpt_busy = [], [], [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with make_mesh({"dp": world}):
        loop = TrainLoop(net, trainer, loss_fn, checkpoint_dir=ckpt_dir,
                         checkpoint_every=CKPT_SAVE_AT if ckpt_dir else None)
        mgr = loop.checkpoint_manager
        K.reset_launch_counts()
        for i in range(steps):
            # a step that saves, or runs beside a write, is not timed
            # into the median
            ckpt_busy.append(mgr is not None and (
                mgr.writing or (i + 1) % CKPT_SAVE_AT == 0))
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
        loop.wait()
        ckpt = None if mgr is None else {
            "latest_step": mgr.latest_step(), "capture_s": mgr.stats[
                "capture_s"], "write_s": mgr.stats["write_s"]}
    step = loop.compiled_step
    same = weights_equal_all_ranks(torch, net)
    eager = eager_rank_step(torch, net, loss_fn, x, y)
    return {"rank": rank, "world": world, "zero_sharded": step.zero_sharded,
            "losses": [float(l.float().mean()) for l in losses],
            # the step returns the global batch's loss on every rank
            "first_losses": losses[0].float().cpu().numpy(),
            "one_card_first_losses": ref,
            "step_ms": step_ms, "ckpt_busy": ckpt_busy,
            "opt_update_per_step": per_step,
            "fwd_bwd_ms": statistics.median(fb_ms[1:]),
            "units": len(step.zero_plan.units), "groups": zero_groups(step),
            "state_bytes": step.optimizer_state_bytes(),
            "state_bytes_unsharded": sum(2 * 4 * p.numel()
                                         for p in trainer._params),
            "weights_equal_all_ranks": same, "eager": eager,
            "checkpoint": ckpt,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None}


def zero_resume_rank(widths, batch, seq, steps, lr, ckpt_dir):
    """Phase 11's resume, one rank of a smaller world: a fresh BERT-base,
    trainer and ``TrainLoop`` on ``ckpt_dir`` resume from the larger
    world's checkpoint (the layout-free states sharded again for this
    world) and run to step ``steps``: the losses, the ``opt_update``
    launches of each resumed step, the restore's provenance and time."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon import Trainer, TrainLoop
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.parallel import dist, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dist.device()
    net = bert_base_classifier(torch, seq, dev, widths)
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = torch.from_numpy(rs.randint(0, vocab, (batch, seq))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (batch,))
                         .astype(np.float32)).to(dev)
    trainer = Trainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": lr})
    with make_mesh({"dp": dist.size()}):
        loop = TrainLoop(net, trainer, SoftmaxCrossEntropyLoss(),
                         checkpoint_dir=ckpt_dir)
        start = loop.global_step
        K.reset_launch_counts()
        losses, per_step = {}, []
        for i in range(start, steps):
            before = K.launch_counts()["opt_update"]
            losses[i] = float(loop.step(x, y).float().mean())
            loop.synchronize()
            per_step.append(K.launch_counts()["opt_update"] - before)
    mgr = loop.checkpoint_manager
    step = loop.compiled_step
    return {"start": start, "losses": losses, "opt_update_per_step": per_step,
            "groups": zero_groups(step) if step.zero_sharded else None,
            "zero_sharded": step.zero_sharded,
            "provenance": mgr.restore_provenance,
            "restore_s": mgr.stats["restore_s"]}


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
    exactly one opt_update launch a unit a step, the first step's loss on
    every rank of the global batch's shape and within ZERO_LOSS_ATOL of a
    one-card forward's, each rank's Adam
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
    import shutil
    from mxnet_tpu_torch.checkpoint import list_checkpoints
    from mxnet_tpu_torch.checkpoint.atomic import step_dir_name
    root = os.path.abspath(os.path.join(CKPT_DIR, "zero"))
    shutil.rmtree(root, ignore_errors=True)
    try:
        ranks = dist.spawn(zero_rank, world, device,
                           (widths, batch, seq, steps, TRAIN_LR, root),
                           timeout_s=timeout_s)
        # the step-5 checkpoint of this world, resumed on half of it:
        # the newer ones go (the restore warns that `latest` is gone)
        for s in list_checkpoints(root):
            if s != CKPT_SAVE_AT:
                shutil.rmtree(os.path.join(root, step_dir_name(s)))
        resumed = dist.spawn(zero_resume_rank, world // 2, device,
                             (widths, batch, seq, steps, TRAIN_LR, root),
                             timeout_s=timeout_s)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    r0 = ranks[0]
    ref = r0["one_card_first_losses"]
    global_loss = all(r["first_losses"].shape == ref.shape for r in ranks)
    first_err = max(float(np.abs(r["first_losses"] - ref).max())
                    if global_loss else math.inf for r in ranks)
    median = statistics.median(max(r["step_ms"][i] for r in ranks)
                               for i in range(1, steps)
                               if not any(r["ckpt_busy"][i] for r in ranks))
    report = {
        "model": "bert_base classifier", "world": world, "batch": batch,
        "seq": seq, "steps": steps, "optimizer": "adam",
        "learning_rate": TRAIN_LR, "dropout": 0.0,
        "zero_sharded": all(r["zero_sharded"] for r in ranks),
        "losses_rank0": r0["losses"], "units": r0["units"],
        "opt_update_per_step": [r["opt_update_per_step"] for r in ranks],
        "first_loss_shape_per_rank": [list(r["first_losses"].shape)
                                      for r in ranks],
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
        "checkpoint_busy_steps": r0["ckpt_busy"],
        "fwd_bwd_ms_per_rank": [r["fwd_bwd_ms"] for r in ranks],
        "reduce_and_update_ms": median - max(r["fwd_bwd_ms"]
                                             for r in ranks),
        "global_tokens_per_s": batch * seq / (median / 1e3),
        "max_memory_allocated_per_rank": [r["max_memory_allocated"]
                                          for r in ranks],
        "checkpoint_rank0": r0["checkpoint"], "card": smi}
    # the resume at world // 2 against this world's own steps 6-10
    res0 = resumed[0]
    res_err = max(abs(res0["losses"][i] - r0["losses"][i])
                  / abs(r0["losses"][i]) for i in res0["losses"])
    report["resume"] = {
        "world": world // 2, "start": res0["start"],
        "provenance": res0["provenance"], "restore_s": res0["restore_s"],
        "losses": [r["losses"] for r in resumed],
        "max_rel_err_vs_this_world": res_err, "rtol": ZERO_RESUME_RTOL,
        "opt_update_per_step": [r["opt_update_per_step"] for r in resumed],
        "zero_sharded": all(r["zero_sharded"] for r in resumed)}
    report["resume"]["ok"] = (
        res0["start"] == CKPT_SAVE_AT
        and r0["checkpoint"]["latest_step"] >= CKPT_SAVE_AT
        and res_err <= ZERO_RESUME_RTOL
        and all(r["losses"] == res0["losses"] for r in resumed)
        and (world // 2 < 2 or (report["resume"]["zero_sharded"] and all(
            c == r["groups"] for r in resumed
            for c in r["opt_update_per_step"]))))
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
                    and all(c == r["groups"] for r in ranks
                            for c in r["opt_update_per_step"])
                    and global_loss and first_err <= ZERO_LOSS_ATOL
                    and share <= 1.01 / world
                    and report["eager_grad_worst_err_over_bound"] <= 1.0
                    and report["eager_weights_equal_all_ranks"]
                    and report["resume"]["ok"])
    emit({"zero_train": report})
    if not report["ok"]:
        raise SystemExit(f"ZeRO training phase failed: {report}")
    return report


def zero_groups(step):
    """A ZeRO step's reduce groups (its runs of buckets of one update and
    weight dtype): what it updates in one ``opt_update`` launch each, a
    rank a step."""
    plan = step.zero_plan
    keys = [(plan.units[b[0]]["upd_dtype"], plan.units[b[0]]["dtypes"][0])
            for b in step.buckets]
    return sum(1 for i, k in enumerate(keys) if i == 0 or k != keys[i - 1])


def spread_gate(refs, got, dist):
    """Phase 6c's gate for two card runs that cannot be bit-equal (the fused
    backward's dq atomics): ``got``'s nearest of ``refs`` within
    CKPT_SPREAD_FACTOR times the largest distance between two ``refs``,
    or bit-equal where those are."""
    pairs = [(i, j) for i in range(len(refs)) for j in range(i + 1,
                                                             len(refs))]
    spread = max(dist(refs[i], refs[j]) for i, j in pairs)
    nearest = min(dist(got, r) for r in refs)
    ok = nearest <= CKPT_SPREAD_FACTOR * spread if spread > 0 \
        else nearest == 0
    return {"spread": spread, "nearest": nearest, "ok": bool(ok)}


def loss_dist(a, b):
    """The largest difference of two runs' losses ({step: loss})."""
    return max(abs(a[i] - b[i]) for i in a)


def rms_dist(a, b):
    return float((a - b).double().pow(2).mean().sqrt())


def kernel_intervals(path):
    """(name, start us, end us) of every kernel in a ``torch.profiler``
    chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(intervals, cover):
    """How much of ``intervals`` (disjoint or not, each counted) lies
    inside the union ``cover``."""
    total = 0.0
    for a, b in intervals:
        for c, d in cover:
            total += max(0.0, min(b, d) - max(a, c))
    return total


def reduce_split(ivs):
    """Phase 11's profile of one overlapped step: device ms of the
    reduce-scatter's exchange kernels (NCCL's SendRecv: an all_to_all),
    of the all-gathers, and the share of the exchange's time that runs
    while compute kernels run."""
    nccl = [(n, a, b) for n, a, b in ivs if "nccl" in n.lower()]
    compute = union([(a, b) for n, a, b in ivs if "nccl" not in n.lower()])
    rs = [(a, b) for n, a, b in nccl if "sendrecv" in n.lower()]
    ag = [(a, b) for n, a, b in nccl if "allgather" in n.lower()]
    rs_us = sum(b - a for a, b in rs)
    return {"reduce_scatter_device_ms": rs_us / 1e3,
            "all_gather_device_ms": sum(b - a for a, b in ag) / 1e3,
            "reduce_scatter_kernels": len(rs),
            "reduce_scatter_share_beside_compute":
                overlap_us(rs, compute) / rs_us if rs_us else None,
            "nccl_kernel_names": sorted({n.split("(")[0] for n, _, _ in
                                         nccl})}


def collective_ms(torch, n_elems, reps=5):
    """One rank's device ms of NCCL's reduce_scatter_tensor and of the
    step's reduce-scatter (all_to_all + rank-ordered sum,
    ``collectives.reduce_scatter_rows``) of an (N, n/N) float32 buffer."""
    import torch.distributed as tdist
    from mxnet_tpu_torch.parallel import collectives, current_mesh
    mesh = current_mesh()
    n = mesh.size
    buf = torch.ones(n, n_elems // n, device=torch.cuda.current_device())
    out = torch.empty(n_elems // n, device=buf.device)
    res = {}
    for name, fn in (("nccl_reduce_scatter", lambda: tdist.
                      reduce_scatter_tensor(out, buf.reshape(-1))),
                     ("all_to_all_ordered_sum", lambda: collectives.
                      reduce_scatter_rows(buf, mesh))):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        res[name] = a.elapsed_time(b) / reps
    return res


def overlap_rank(widths, batch, seq, steps, lr, trace_dir, dense_rows):
    """Phase 11 legs (a) and (b), one rank. (a) BERT-base through
    ``TrainLoop`` under the dp mesh from one set of weights, four runs in
    turns: serial (MXNET_ZERO_BUCKET_BYTES=0: one bucket, reduced after
    the backward), overlapped (4 MiB buckets launched from the
    backward's hooks), overlapped, serial: step ms, peak memory, the
    opt_update launches of each step, device events around the backward
    (forward, backward, and after the backward to the step's end: the
    exposed reduction and update), the losses and (rank 0) the final
    weights; rank 0 profiles one more overlapped step. Then a Dense-only
    model, three Adam steps serial, at 4 MiB and with one unit a bucket,
    and NCCL's reduce-scatter beside the step's at a 4 MiB bucket and at
    the whole model. (b) plain steps against ``loop.prefetch`` over
    PREFETCH_STEPS host batches, in turns."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon import Trainer, TrainLoop
    from mxnet_tpu_torch.gluon import fused_step as FS
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.nn import Dense
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.parallel import dist, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dist.device()
    rank, world = dist.rank(), dist.size()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    net = bert_base_classifier(torch, seq, dev, widths)
    init = init_params_numpy(net, seed=2)
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = torch.from_numpy(rs.randint(0, vocab, (batch, seq))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (batch,))
                         .astype(np.float32)).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    marks = []
    real_backward = FS._BucketReducer.backward

    def marked_backward(self, loss_sum, params):
        a = torch.cuda.Event(enable_timing=True) if cuda else None
        if a is not None:
            a.record()
        real_backward(self, loss_sum, params)
        b = torch.cuda.Event(enable_timing=True) if cuda else None
        if b is not None:
            b.record()
        marks.append((a, b))

    FS._BucketReducer.backward = marked_backward

    def fresh_loop(model):
        for p in model.parameters():
            p.grad = None
        tr = Trainer(dict(model.named_parameters()), "adam",
                     {"learning_rate": lr})
        return TrainLoop(model, tr, loss_fn)

    runs = []
    with make_mesh({"dp": world}):
        for mode in OVERLAP_TURNS:
            os.environ["MXNET_ZERO_BUCKET_BYTES"] = \
                "0" if mode == "serial" else str(4 << 20)
            load_jax_params(net, init)
            loop = fresh_loop(net)
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            losses, step_ms, per_step, split = {}, [], [], []
            K.reset_launch_counts()
            for i in range(steps):
                before = K.launch_counts()["opt_update"]
                del marks[:]
                sync()
                t0 = time.perf_counter()
                e0 = torch.cuda.Event(enable_timing=True) if cuda else None
                if e0 is not None:
                    e0.record()
                loss = loop.step(x, y)
                e1 = torch.cuda.Event(enable_timing=True) if cuda else None
                if e1 is not None:
                    e1.record()
                loop.synchronize()
                sync()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                per_step.append(K.launch_counts()["opt_update"] - before)
                losses[i] = float(loss.float().mean())
                if cuda and marks:
                    a, b = marks[0]
                    split.append((e0.elapsed_time(a), a.elapsed_time(b),
                                  b.elapsed_time(e1)))
            buckets = len(loop.compiled_step.buckets)
            runs.append({
                "mode": mode, "losses": losses, "step_ms": step_ms,
                "opt_update_per_step": per_step, "buckets": buckets,
                "groups": zero_groups(loop.compiled_step),
                "zero_sharded": loop.compiled_step.zero_sharded,
                "split_ms": split,
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev)
                if cuda else None,
                "weights": flat_weights(torch, net) if rank == 0 else None})
        # rank 0 profiles one more overlapped step
        profile = None
        os.environ["MXNET_ZERO_BUCKET_BYTES"] = str(4 << 20)
        load_jax_params(net, init)
        loop = fresh_loop(net)
        loop.step(x, y)
        loop.synchronize()
        sync()
        if cuda and rank == 0:
            from torch.profiler import ProfilerActivity, profile as prof_cm
            with prof_cm(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                loop.step(x, y)
                loop.synchronize()
                sync()
            path = os.path.join(trace_dir, "overlap_step.json")
            prof.export_chrome_trace(path)
            profile = reduce_split(kernel_intervals(path))
            os.remove(path)
        else:
            loop.step(x, y)
            loop.synchronize()
        FS._BucketReducer.backward = real_backward
        del loop
        coll = None
        if cuda:
            coll = {"bucket_4MiB": collective_ms(torch, 1 << 20),
                    "whole_model": collective_ms(
                        torch, sum(p.numel() for p in net.parameters())
                        // world * world)}

        # the Dense-only model (the FFN's widths and a 2-way head):
        # bit-equal in every bucketing
        c, h = (widths or BERT_BASE)["units"], \
            (widths or BERT_BASE)["hidden_size"]
        rd = np.random.RandomState(11)
        dense_init = {k: (rd.randn(*s) * 0.02).astype(np.float32)
                      for k, s in (("0.weight", (h, c)), ("0.bias", (h,)),
                                   ("1.weight", (c, h)), ("1.bias", (c,)),
                                   ("2.weight", (2, c)), ("2.bias", (2,)))}
        xd = torch.from_numpy(rd.randn(dense_rows, c)
                              .astype(np.float32)).to(dev)
        yd = torch.from_numpy(rd.randint(0, 2, (dense_rows,))
                              .astype(np.float32)).to(dev)
        dense = {}
        for mode, bb in (("serial", 0), ("bucket_4MiB", 4 << 20),
                         ("one_unit_a_bucket", 64)):
            os.environ["MXNET_ZERO_BUCKET_BYTES"] = str(bb)
            dnet = torch.nn.Sequential(
                Dense(h, in_units=c, activation="relu", device=dev),
                Dense(c, in_units=h, activation="relu", device=dev),
                Dense(2, in_units=c, device=dev))
            load_jax_params(dnet, dense_init)
            dloop = fresh_loop(dnet)
            dl = [float(dloop.step(xd, yd).float().mean())
                  for _ in range(DENSE_STEPS)]
            dloop.synchronize()
            dense[mode] = (dl, flat_weights(torch, dnet),
                           len(dloop.compiled_step.buckets))
        dense_equal = all(dense[m][0] == dense["serial"][0] and torch.equal(
            dense[m][1], dense["serial"][1]) for m in dense)
        dense_buckets = {m: v[2] for m, v in dense.items()}
        del dense

        # (b) plain steps against loop.prefetch, in turns
        os.environ["MXNET_ZERO_BUCKET_BYTES"] = str(4 << 20)
        host = []
        hb = np.random.RandomState(5)
        for _ in range(PREFETCH_STEPS):
            host.append((hb.randint(0, vocab, (batch, seq)).astype(np.int64),
                         hb.randint(0, 2, (batch,)).astype(np.float32)))
        pf_runs = []
        for mode in ("plain", "prefetch", "prefetch", "plain"):
            load_jax_params(net, init)
            loop = fresh_loop(net)
            src = loop.prefetch(iter(host), depth=2) if mode == "prefetch" \
                else iter(host)
            losses, step_ms = {}, []
            sync()
            t_prev = time.perf_counter()
            for i, (bx, by) in enumerate(src):
                losses[i] = float(loop.step(bx, by).float().mean())
                loop.synchronize()
                sync()
                t = time.perf_counter()
                step_ms.append((t - t_prev) * 1e3)
                t_prev = t
            st = loop.engine_stats()
            pf_runs.append({"mode": mode, "losses": losses,
                            "step_ms": step_ms,
                            "input_wait_ms": st.get("input_wait_ms"),
                            "starvation_count": st.get("starvation_count"),
                            "prefetch_batches": st.get("prefetch_batches")})
            del loop, src
    return {"rank": rank, "world": world, "runs": runs, "profile": profile,
            "collectives_ms": coll, "dense_equal": dense_equal,
            "dense_buckets": dense_buckets, "prefetch": pf_runs}


def zero_overlap(torch, np, smi, device="cuda", world=None, widths=None,
                 batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                 dense_rows=DENSE_ROWS, timeout_s=600):
    """Phase 11 legs (a) serial against overlapped and (b) prefetch, on
    every visible card (:func:`overlap_rank`). Gates: every run sharded
    with exactly one opt_update launch a unit a rank a step; each
    overlapped run's final weights (rms) and losses within the spread
    of the serial runs (``spread_gate``); the Dense-only model bit-equal
    serial, at 4 MiB and one unit a bucket; the prefetch runs' losses
    within the spread of the plain runs, every batch staged."""
    from mxnet_tpu_torch.parallel import dist
    world = world or torch.cuda.device_count()
    trace_dir = os.path.abspath(os.path.join("build", "chip_trace"))
    os.makedirs(trace_dir, exist_ok=True)
    ranks = dist.spawn(overlap_rank, world, device,
                       (widths, batch, seq, steps, TRAIN_LR, trace_dir,
                        dense_rows), timeout_s=timeout_s)
    r0 = ranks[0]
    runs = {}
    for k, run in enumerate(r0["runs"]):
        runs.setdefault(run["mode"], []).append(k)
    serial = [r0["runs"][k] for k in runs["serial"]]
    over = [r0["runs"][k] for k in runs["overlap"]]

    def median_slowest(k):
        return statistics.median(max(r["runs"][k]["step_ms"][i]
                                     for r in ranks)
                                 for i in range(1, steps))

    def split_median(k, j):
        vals = [r0["runs"][k]["split_ms"][i][j] for i in range(1, steps)
                if i < len(r0["runs"][k]["split_ms"])]
        return statistics.median(vals) if vals else None

    turns = []
    for k, run in enumerate(r0["runs"]):
        turns.append({
            "mode": run["mode"], "buckets": run["buckets"],
            "median_step_ms_slowest_rank": median_slowest(k),
            "peak_memory_per_rank": [r["runs"][k]["max_memory_allocated"]
                                     for r in ranks],
            "forward_ms": split_median(k, 0),
            "backward_ms": split_median(k, 1),
            "after_backward_ms": split_median(k, 2),
            "losses_rank0": [run["losses"][i] for i in range(steps)]})
    w_gate = [spread_gate([s["weights"] for s in serial], o["weights"],
                          rms_dist) for o in over]
    l_gate = [spread_gate([s["losses"] for s in serial], o["losses"],
                          loss_dist) for o in over]
    launches_ok = all(c == run["groups"] for r in ranks
                      for run in r["runs"] for c in run["opt_update_per_step"])
    pf = r0["prefetch"]
    plain = [p["losses"] for p in pf if p["mode"] == "plain"]
    pf_gate = [spread_gate(plain, p["losses"], loss_dist)
               for p in pf if p["mode"] == "prefetch"]
    report = {
        "model": "bert_base classifier", "world": world, "batch": batch,
        "seq": seq, "steps": steps, "turns": turns,
        "overlap_vs_serial_weights_rms": w_gate,
        "overlap_vs_serial_losses": l_gate,
        "spread_factor": CKPT_SPREAD_FACTOR,
        "opt_update_per_rank_step": [run["opt_update_per_step"]
                                     for run in r0["runs"]],
        "profile_overlapped_step_rank0": r0["profile"],
        "collectives_ms_rank0": r0["collectives_ms"],
        "dense_only_bit_equal": all(r["dense_equal"] for r in ranks),
        "dense_only_buckets": r0["dense_buckets"], "card": smi}
    report["ok"] = (all(r["zero_sharded"] for rk in ranks
                        for r in rk["runs"])
                    and launches_ok and all(g["ok"] for g in w_gate)
                    and all(g["ok"] for g in l_gate)
                    and report["dense_only_bit_equal"]
                    and all(math.isfinite(v) for r in r0["runs"]
                            for v in r["losses"].values()))
    emit({"zero_overlap": report})
    prefetch = {
        "model": "bert_base classifier", "world": world,
        "steps": PREFETCH_STEPS,
        "turns": [{"mode": p["mode"],
                   "median_step_ms_slowest_rank": statistics.median(
                       max(r["prefetch"][k]["step_ms"][i] for r in ranks)
                       for i in range(1, PREFETCH_STEPS)),
                   "input_wait_ms_per_rank": [r["prefetch"][k]
                                              ["input_wait_ms"]
                                              for r in ranks],
                   "starvation_count_rank0": p["starvation_count"],
                   "prefetch_batches": p["prefetch_batches"]}
                  for k, p in enumerate(pf)],
        "losses_vs_plain": pf_gate, "card": smi}
    prefetch["ok"] = (all(g["ok"] for g in pf_gate)
                      and all(p["prefetch_batches"] == PREFETCH_STEPS
                              for p in pf if p["mode"] == "prefetch"))
    emit({"zero_prefetch": prefetch})
    if not (report["ok"] and prefetch["ok"]):
        raise SystemExit(f"ZeRO overlap / prefetch legs failed: "
                         f"{report} {prefetch}")
    return report


def elastic_build(widths, seq, lr, dropout=0.0):
    """What each formation of phase 11's elastic legs builds, on this
    rank's card: a BERT-base-width classifier of ``widths`` (depth cut),
    its weights from one seed, Adam."""
    import torch
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.parallel import dist
    net = bert_base_classifier(torch, seq, dist.device(), widths)
    load_jax_params(net, init_params_numpy(net, seed=2))
    trainer = Trainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": lr})
    return net, trainer, SoftmaxCrossEntropyLoss()


def elastic_batch(batch, seq, vocab, i):
    """Step i's global batch on the host, from its own seed."""
    import numpy as np
    rs = np.random.RandomState(100 + i)
    return (rs.randint(0, vocab, (batch, seq)).astype(np.int64),
            rs.randint(0, 2, (batch,)).astype(np.float32))


def elastic_ref_rank(build, batch_fn, ckpt_dir, restored, total, runs):
    """An uninterrupted run of this world restored from checkpoint
    ``restored``, ``runs`` times: rank 0's summed losses of each."""
    import torch
    from mxnet_tpu_torch.checkpoint import TrainCheckpointManager
    from mxnet_tpu_torch.gluon import TrainLoop
    from mxnet_tpu_torch.parallel import dist, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    with make_mesh({"dp": dist.size()}):
        for _ in range(runs):
            net, trainer, loss_fn = build()
            TrainCheckpointManager(ckpt_dir, keep_last=99).restore_step(
                restored, trainer=trainer, net=net)
            loop = TrainLoop(net, trainer, loss_fn)
            h = {i: loop.step(*batch_fn(i)) for i in range(restored, total)}
            loop.synchronize()
            out.append({i: float(v.detach().double().sum())
                        for i, v in h.items()})
            del net, trainer, loop, h
    return out if dist.rank() == 0 else None


def zero_elastic(torch, np, smi, device="cuda", widths=None,
                 batch=TRAIN_BATCH, seq=TRAIN_SEQ, timeout_s=300):
    """Phase 11 legs (c) and (d): ``elastic.ElasticSupervisor`` over the
    visible cards, one process group a formation. (c) ELASTIC_STEPS
    steps with checkpoint_every=2 and ``step.dispatch:before=6:revoke:2``:
    exactly one device_lost event (dp N -> N - 2, restored step 4), the
    run finishing at its last step, and the losses after the recovery
    within the spread of two uninterrupted runs at the smaller world
    restored from the same checkpoint; ``downtime_s`` is the time to
    recover. (d) a revocation and then a ``restore`` at the smaller
    formation's second dispatch: the run grows back through a planned
    re-form (cause ``grow``) and finishes at the full world."""
    import functools
    import shutil
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.testing import faults
    widths = widths or dict(BERT_BASE, num_layers=ELASTIC_LAYERS)
    world = len(dist.available_devices(device))
    vocab = widths.get("vocab_size", BERT_VOCAB)
    build = functools.partial(elastic_build, widths, seq, TRAIN_LR)
    batch_fn = functools.partial(elastic_batch, batch, seq, vocab)
    root = os.path.abspath(os.path.join(CKPT_DIR, "elastic"))
    report = {"model": "bert_base-width classifier", "widths": widths,
              "world": world, "batch": batch, "seq": seq, "card": smi}
    try:
        shutil.rmtree(root, ignore_errors=True)
        spec = "step.dispatch:before=6:revoke:2"
        faults.configure(spec)
        t0 = time.perf_counter()
        sup = elastic.ElasticSupervisor(
            build, os.path.join(root, "shrink"), mesh_axes={"dp": -1},
            checkpoint_every=2, keep_last=99, backoff_base=0.0,
            final_checkpoint=False, device=device,
            log=elastic.RecoveryLog(), formation_timeout_s=timeout_s)
        res = sup.run(batch_fn, ELASTIC_STEPS)
        wall = time.perf_counter() - t0
        faults.reset()
        ev = res.events[0] if res.events else {}
        restored = ev.get("restored_step", 4)
        refs = dist.spawn(elastic_ref_rank, world - 2, device,
                          (build, batch_fn, os.path.join(root, "shrink"),
                           restored, ELASTIC_STEPS, 2),
                          timeout_s=timeout_s)[0]
        after = {i: res.losses[i] for i in range(restored, ELASTIC_STEPS)
                 if i in res.losses}
        gate = spread_gate(refs, after, loss_dist) \
            if len(after) == ELASTIC_STEPS - restored else {"ok": False}
        report["shrink"] = {
            "fault": spec, "steps": ELASTIC_STEPS, "events": res.events,
            "final_step": res.final_step, "world_size": res.world_size,
            "losses": res.losses, "reference_losses": refs,
            "losses_vs_uninterrupted": gate, "wall_s": wall,
            "downtime_s": ev.get("downtime_s")}
        report["shrink"]["ok"] = (
            len(res.events) == 1 and ev["cause"] == "device_lost"
            and (ev["old_dp"], ev["new_dp"], ev["restored_step"])
            == (world, world - 2, 4)
            and res.final_step == ELASTIC_STEPS and gate["ok"])

        spec = "step.dispatch:before=4:revoke:2;" \
            f"step.dispatch@dp{world - 2}:before=2:restore"
        faults.configure(spec)
        t0 = time.perf_counter()
        sup = elastic.ElasticSupervisor(
            build, os.path.join(root, "grow"), mesh_axes={"dp": -1},
            checkpoint_every=2, backoff_base=0.0, final_checkpoint=False,
            device=device, log=elastic.RecoveryLog(),
            formation_timeout_s=timeout_s)
        res = sup.run(batch_fn, ELASTIC_STEPS)
        wall = time.perf_counter() - t0
        faults.reset()
        causes = [(e["cause"], e["old_dp"], e["new_dp"])
                  for e in res.events]
        report["grow"] = {
            "fault": spec, "events": res.events, "final_step":
                res.final_step, "world_size": res.world_size,
            "wall_s": wall,
            "downtime_s": [e["downtime_s"] for e in res.events]}
        report["grow"]["ok"] = (
            causes == [("device_lost", world, world - 2),
                       ("grow", world - 2, world)]
            and res.final_step == ELASTIC_STEPS
            and res.world_size == world
            and res.events[1]["discarded_steps"] == 0
            and all(math.isfinite(v) for v in res.losses.values()))
    finally:
        faults.reset()
        shutil.rmtree(root, ignore_errors=True)
    report["ok"] = report["shrink"]["ok"] and report["grow"]["ok"]
    emit({"zero_elastic": report})
    if not report["ok"]:
        raise SystemExit(f"elastic legs failed: {report}")
    return report


def one_card_build(dev, init):
    """Phase 12's formation: phase 6's BERT-base (dropout 0.1, Adam at
    TRAIN_LR) from the weights ``init``, its dropout seeded."""
    import torch
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import load_jax_params
    net = BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=0.1,
                                   device=dev),
                         num_classes=2, dropout=0.1, device=dev).train()
    load_jax_params(net, init)
    torch.manual_seed(0)
    trainer = Trainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": TRAIN_LR})
    return net, trainer, SoftmaxCrossEntropyLoss()


def elastic_one_card(torch, np, K, dev, smi):
    """Phase 12, one card: (1) the in-process ``ElasticSupervisor`` on
    phase 6's BERT-base (32 x 512, dropout 0.1, Adam), checkpoint_every=2,
    with ``step.dispatch:before=4:error``: one ``transient`` event
    restored at step 2, the run finishing at step ONE_CARD_STEPS, its
    losses after the recovery within the spread of two uninterrupted
    runs restored from the same checkpoint, and exactly phase 6's
    launches for every step dispatched; ``downtime_s``. (2)
    ``TrainLoop.prefetch`` against plain steps over PREFETCH_STEPS host
    batches, in turns: step ms, ``input_wait_ms``, losses within the
    plain runs' spread."""
    import functools
    import shutil
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.checkpoint import TrainCheckpointManager
    from mxnet_tpu_torch.gluon import TrainLoop
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy
    from mxnet_tpu_torch.testing import faults
    t_phase = time.perf_counter()
    net = BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=0.1,
                                   device=dev), num_classes=2, dropout=0.1,
                         device=dev)
    init = init_params_numpy(net, seed=2)
    vocab = net.bert.word_embed.weight.shape[0]
    del net
    build = functools.partial(one_card_build, dev, init)
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (TRAIN_BATCH,))
                         .astype(np.float32)).to(dev)
    root = os.path.abspath(os.path.join(CKPT_DIR, "one_card"))
    shutil.rmtree(root, ignore_errors=True)
    spec = "step.dispatch:before=4:error"
    try:
        faults.configure(spec)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        sup = elastic.ElasticSupervisor(
            build, root, mesh_axes=None, checkpoint_every=2, keep_last=99,
            backoff_base=0.0, final_checkpoint=False, device=dev.type,
            log=elastic.RecoveryLog())
        res = sup.run(lambda i: (x, y), ONE_CARD_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        faults.reset()
        ev = res.events[0] if res.events else {}
        restored = ev.get("restored_step", 2)
        refs = []
        for _ in range(2):
            net, trainer, loss_fn = build()
            TrainCheckpointManager(root, keep_last=99).restore_step(
                restored, trainer=trainer, net=net)
            loop = TrainLoop(net, trainer, loss_fn)
            h = {i: loop.step(x, y) for i in range(restored, ONE_CARD_STEPS)}
            loop.synchronize()
            refs.append({i: float(v.detach().double().sum())
                         for i, v in h.items()})
            del net, trainer, loop, h
    finally:
        faults.reset()
        shutil.rmtree(root, ignore_errors=True)
    after = {i: res.losses[i] for i in range(restored, ONE_CARD_STEPS)}
    gate = spread_gate(refs, after, loss_dist)
    dispatched = 3 + ONE_CARD_STEPS - restored
    # each formation's loop captures its step at its first call: the
    # warm-up runs the step's forward and backward WARMUP_RUNS times
    # eagerly, without its update
    from mxnet_tpu_torch.captured import WARMUP_RUNS
    captures = 1 + len(res.events)
    runs = dispatched + WARMUP_RUNS * captures
    expect = {n: 0 for n in K.KERNELS}
    expect.update(flash_fwd=12, flash_bwd_fused=12, layernorm_fwd=25,
                  layernorm_bwd=25)
    expect = {n: c * runs for n, c in expect.items()}
    expect["opt_update"] = dispatched       # one a step
    report = {"model": "bert_base classifier", "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ, "dropout": 0.1, "fault": spec,
              "steps": ONE_CARD_STEPS, "events": res.events,
              "final_step": res.final_step, "losses": res.losses,
              "reference_losses": refs, "losses_vs_uninterrupted": gate,
              "downtime_s": ev.get("downtime_s"), "wall_s": wall,
              "steps_dispatched": dispatched, "captures": captures,
              "warmup_runs_a_capture": WARMUP_RUNS, "launches": launches,
              "launches_expected": expect, "card": smi}
    report["ok"] = (len(res.events) == 1 and ev["cause"] == "transient"
                    and ev["restored_step"] == 2 and ev["step"] == 3
                    and res.final_step == ONE_CARD_STEPS and gate["ok"]
                    and launches == expect)
    emit({"elastic_one_card": report})

    # TrainLoop.prefetch on one card against plain steps, in turns
    hb = np.random.RandomState(5)
    host = [(hb.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64),
             hb.randint(0, 2, (TRAIN_BATCH,)).astype(np.float32))
            for _ in range(PREFETCH_STEPS)]
    turns, plain = [], []
    for mode in ("plain", "prefetch", "prefetch", "plain"):
        net, trainer, loss_fn = build()
        loop = TrainLoop(net, trainer, loss_fn)
        src = loop.prefetch(iter(host), depth=2) if mode == "prefetch" \
            else iter(host)
        losses, step_ms = {}, []
        torch.cuda.synchronize()
        t_prev = time.perf_counter()
        for i, (bx, by) in enumerate(src):
            losses[i] = float(loop.step(bx, by).float().mean())
            loop.synchronize()
            torch.cuda.synchronize()
            t = time.perf_counter()
            step_ms.append((t - t_prev) * 1e3)
            t_prev = t
        st = loop.engine_stats()
        turns.append({"mode": mode, "losses": losses,
                      "median_step_ms": statistics.median(step_ms[1:]),
                      "input_wait_ms": st.get("input_wait_ms"),
                      "starvation_count": st.get("starvation_count"),
                      "prefetch_batches": st.get("prefetch_batches")})
        del net, trainer, loop, src
    plain = [t["losses"] for t in turns if t["mode"] == "plain"]
    pf_gate = [spread_gate(plain, t["losses"], loss_dist)
               for t in turns if t["mode"] == "prefetch"]
    pf = {"model": "bert_base classifier", "steps": PREFETCH_STEPS,
          "turns": turns, "losses_vs_plain": pf_gate, "card": smi,
          "phase_s": time.perf_counter() - t_phase}
    pf["ok"] = (all(g["ok"] for g in pf_gate)
                and all(t["prefetch_batches"] == PREFETCH_STEPS
                        for t in turns if t["mode"] == "prefetch"))
    emit({"prefetch_one_card": pf})
    if not (report["ok"] and pf["ok"]):
        raise SystemExit(f"phase 12 failed: {report} {pf}")
    return report


#: phase 13: the dist store (``kvstore.KVStoreDist``). One card:
#: phase 6's training with the store forced onto its host path
#: (``_force_fuse``), so ``compile_step`` takes its split program, in
#: turns against phase 6's one-graph fused step from the same weights
#: and batch, then a control run of the split program with its lr
#: staged at CONTROL_LR_FACTOR times the scheduler's
DIST_KV_TURNS = ("fused", "split", "split", "fused")
#: across cards, leg (a) (``dist_sync``, the split program) and phase
#: 11's plain ``mesh`` mode, in turns
DIST_KV_MULTI_TURNS = ("split", "mesh", "mesh", "split")
#: leg (c): steps of each compression type
DIST_KV_COMPRESSED_STEPS = 3
#: leg (c)'s bound for fp16: the rms distance of its weights from leg
#: (a)'s after DIST_KV_COMPRESSED_STEPS steps within this share of how
#: far (a)'s moved from the initial weights. fp16 keeps 11 bits of each
#: rank's gradient and Adam divides each element by its own running
#: magnitude, so a step's move changes by ~2**-11 of itself, more only
#: where a gradient underflows fp16 (below 6e-8) or a near-zero one
#: flips sign; a lost or doubled gradient moves it by O(1) of itself
FP16_MOVED_RTOL = 5e-2
#: leg (d) on a model whose kernels are all deterministic (phase 8b's
#: Dense-only widths): dist_async equals dist_sync bit for bit
DIST_KV_DENSE_ROWS, DIST_KV_DENSE_STEPS = 4096, 3


def dist_kv_one_card(torch, np, K, dev, smi, widths=None, batch=TRAIN_BATCH,
                     seq=TRAIN_SEQ, steps=TRAIN_STEPS):
    """Phase 13 on one card: BERT-base float32 (dropout 0.1, phase 6's
    seeds) through ``compile_step`` with a ``dist_sync`` store forced onto
    its host path (``_force_fuse``):
    the split program (``mode`` "fused", two captured graphs, the store's
    ``pushpull_list`` between them, no collective in one process), in
    DIST_KV_TURNS against phase 6's fused step, then a control run.
    Gates: per split step exactly phase 6's forward and backward launches
    and one ``opt_update`` a parameter; one capture and two graphs; the
    split runs' losses and weights within :func:`vs_eager`'s limit of
    the fused runs (their spread: the dq atomics), and the control
    outside it. Prints the buckets, median step ms of each turn, tokens/s
    and peak memory."""
    from mxnet_tpu_torch import kvstore as kvs
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, BERTModel
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params

    def make():
        return BERTClassifier(BERTModel(max_length=seq, dropout=0.1,
                                        device=dev, **(widths or BERT_BASE)),
                              num_classes=2, dropout=0.1, device=dev)

    t0 = time.perf_counter()
    net = make()
    init = init_params_numpy(net, seed=2)
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = torch.from_numpy(rs.randint(0, vocab, (batch, seq))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (batch,))
                         .astype(np.float32)).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    made, runs, w0 = [net], [], None
    del net
    for kind in DIST_KV_TURNS + ("control",):
        net = made.pop() if made else make()
        load_jax_params(net, init)
        net.train()
        torch.manual_seed(0)            # the dropout masks, as phase 6
        if w0 is None:
            w0 = flat_weights(torch, net)
        kv = None
        if kind != "fused":     # the store forced onto its host path
            kv = kvs.KVStoreDist("dist_sync")
            kv._force_fuse = True
        trainer = Trainer(dict(net.named_parameters()), "adam",
                          {"learning_rate": TRAIN_LR}, kvstore=kv)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = trainer.compile_step(
            lambda a, b, net=net: loss_fn(net(a), b))
        t1 = time.perf_counter()
        step.aot_compile(x, y)
        torch.cuda.synchronize()
        rec = {"kind": kind, "mode": step.mode, "split": step._split,
               "graphs": len(step._programs),
               "capture_s": time.perf_counter() - t1,
               "n_traces_after_warmup": step.n_traces}
        fn = control_step(step, np) if kind == "control" else step
        out = run_train_steps(torch, K, fn, x, y, steps)
        med = statistics.median(out[1][1:])
        rec.update(losses=out[0], step_ms=out[1], median_step_ms=med,
                   tokens_per_s=batch * seq / (med / 1e3),
                   launches_per_step=out[2][-1],
                   launches_each_step_equal=all(s == out[2][0]
                                                for s in out[2]),
                   n_traces_after_steps=step.n_traces,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   max_memory_reserved=torch.cuda.max_memory_reserved())
        if kv is not None:
            rec.update(stats=dict(kv.stats), buckets=list(kv.last_buckets),
                       bucket_elements=sum(kv.last_buckets),
                       n_params=len(trainer._params))
        runs.append((rec, flat_weights(torch, net)))
        del net, trainer, step, fn, out, kv
    fused = [(r["losses"], w) for r, w in runs if r["kind"] == "fused"]
    gates = {r["kind"] + str(i): vs_eager(fused, fused, w0, r["losses"], w)
             for i, (r, w) in enumerate(runs) if r["kind"] != "fused"}
    layers = (widths or BERT_BASE)["num_layers"]
    expect = {n: 0 for n in K.KERNELS}
    expect.update(flash_fwd=layers, flash_bwd_fused=layers,
                  layernorm_fwd=2 * layers + 1, layernorm_bwd=2 * layers + 1,
                  opt_update=1)
    split = [r for r, _ in runs if r["kind"] != "fused"]
    counts_ok = all(r["launches_per_step"] == expect
                    and r["launches_each_step_equal"] for r, _ in runs)
    shape_ok = all(r["mode"] == "fused" and r["split"] and r["graphs"] == 2
                   and r["n_traces_after_warmup"] == 1
                   and r["n_traces_after_steps"] == 1
                   and r["stats"] == {"collectives": 0, "blocks": 0}
                   and r["bucket_elements"] == w0.numel()
                   for r in split)
    losses = runs[1][0]["losses"]
    report = {
        "model": "bert_base classifier", "dtype": "float32",
        "store": "KVStoreDist('dist_sync'), _force_fuse", "batch": batch,
        "seq": seq, "steps": steps, "optimizer": "adam",
        "learning_rate": TRAIN_LR, "dropout": 0.1,
        "order": [r["kind"] for r, _ in runs],
        "buckets": runs[1][0]["buckets"],
        "launches_per_step_expected": expect,
        "vs_fused": gates,
        "split_vs_fused_ok": all(g["ok"] for k, g in gates.items()
                                 if k.startswith("split")),
        "control_fails": not any(g["ok"] for k, g in gates.items()
                                 if k.startswith("control")),
        "control_lr_factor": CONTROL_LR_FACTOR,
        "turns": [{k: v for k, v in r.items() if k != "step_ms"}
                  for r, _ in runs],
        "setup_s": time.perf_counter() - t0, "card": smi}
    for kind in ("fused", "split"):
        for key in ("median_step_ms", "tokens_per_s", "max_memory_allocated",
                    "max_memory_reserved"):
            report[f"{kind}_{key}"] = [r[key] for r, _ in runs
                                       if r["kind"] == kind]
    report["ok"] = (counts_ok and shape_ok and report["split_vs_fused_ok"]
                    and report["control_fails"]
                    and all(math.isfinite(v) for v in losses)
                    and losses[-1] < losses[0])
    emit({"dist_kv_one_card": report})
    if not report["ok"]:
        raise SystemExit(f"phase 13 (one card) failed: {report}")
    # each kernel's launches on this phase's path: the first split run's
    return {n: c * steps for n, c in runs[1][0]["launches_per_step"].items()}


def dist_kv_run(ctx, kind, seed=2, steps=None, store="dist_sync",
                compression=None, update_on_kvstore=False, keep_grads=False,
                at_step=None):
    """One run of phase 13's across-cards legs on this rank, from
    ``seed``'s weights: ``kind`` "split" (``compile_step`` over
    ``store``: each rank its own rows, ``batch_size`` the global batch),
    "mesh" (phase 11's plain mode: the global batch under a dp mesh),
    "ref" (``Trainer(kvstore=None)``'s eager step: backward,
    ``allreduce_grads``, ``update``) or "eager" (``Trainer.step`` over
    ``store``). Per step: the rank's loss (mean of its rows), wall ms,
    ``opt_update`` launches, the store's collectives and waits. The
    final weights stay on the rank (flat), with those after ``at_step``
    steps and the first step's reduced gradients where asked."""
    torch, K, dev = ctx["torch"], ctx["K"], ctx["dev"]
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.parallel import make_mesh
    steps = steps or ctx["steps"]
    net = ctx["build"](seed)
    kv = None if kind in ("ref", "mesh") else store
    trainer = Trainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": ctx["lr"]}, kvstore=kv,
                      compression_params=compression,
                      update_on_kvstore=update_on_kvstore)
    lf, x, y, xl, yl = ctx["loss_fn"], ctx["x"], ctx["y"], ctx["xl"], \
        ctx["yl"]
    batch = x.shape[0]
    rec = {"kind": kind, "store": store if kv else None,
           "compression": compression, "losses": [], "step_ms": [],
           "opt_update": [], "collectives": [], "blocks": []}
    mesh = make_mesh({"dp": ctx["world"]}) if kind == "mesh" else None
    step = None
    if kind == "split":
        step = trainer.compile_step(lambda a, b: lf(net(a), b))
        step.aot_compile(xl, yl, batch_size=batch)
        rec.update(mode=step.mode, split=step._split,
                   graphs=len(step._programs),
                   update_on_kvstore=trainer._update_on_kvstore,
                   init_equal_all_ranks=weights_equal_all_ranks(torch, net),
                   init_is_rank0s=bool(torch.equal(
                       flat_weights(torch, net), ctx["w0"])))
    elif kind == "mesh":
        step = trainer.compile_step(lambda a, b: lf(net(a), b),
                                    zero_shard=False, mesh=mesh)
    stats = trainer._kvstore.stats if trainer._kvstore is not None and \
        hasattr(trainer._kvstore, "stats") else None
    grads = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(steps):
        before = K.launch_counts()["opt_update"]
        s0 = dict(stats) if stats else None
        ctx["sync"]()
        t0 = time.perf_counter()
        if kind == "split":
            loss = step(xl, yl, batch_size=batch)
        elif kind == "mesh":
            with mesh:
                loss = step(x, y)
            loss = loss[ctx["rows"]]
        else:
            loss = lf(net(xl), yl)
            loss.sum().backward()
            if kind == "ref":
                trainer.allreduce_grads()
                if i == 0 and keep_grads:
                    grads = [p.grad.detach().clone()
                             for p in trainer._params]
                trainer.update(batch)
            else:
                trainer.step(batch)
        ctx["sync"]()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["losses"].append(float(loss.detach().float().mean()))
        rec["opt_update"].append(K.launch_counts()["opt_update"] - before)
        if stats is not None:
            rec["collectives"].append(stats["collectives"]
                                      - s0["collectives"])
            rec["blocks"].append(stats["blocks"] - s0["blocks"])
        if i == 0 and keep_grads and kind == "split":
            grads = [g.clone() for g in step._grads]
        if at_step is not None and i + 1 == at_step:
            rec["weights_at_step"] = flat_weights(torch, net)
    if kv is not None:
        kvo = trainer._kvstore
        rec["buckets"] = list(kvo.last_buckets)
        rec["update_on_kvstore"] = trainer._update_on_kvstore
        if kvo._compression is not None:
            res = torch.cat([r.reshape(-1).float() for r in
                             kvo._compression._residuals.values()])
            rec["residuals"] = {
                "n": len(kvo._compression._residuals),
                "finite": bool(torch.isfinite(res).all()),
                "nonzero_share": float((res != 0).float().mean()),
                "max_abs": float(res.abs().max())}
        if trainer._update_on_kvstore and ctx["rank"] == 0:
            # save_states / load_states through the store's updater (on
            # one rank: every rank's states are the same)
            f = os.path.join(ctx["out_dir"], "states")
            trainer.save_states(f)
            before = kvo._updater.get_states()
            kvo._updater.states = {}
            trainer.load_states(f)
            rec["states_round_trip"] = kvo._updater.get_states() == before
            rec["one_updater"] = trainer._updater is kvo._updater
    rec["weights_equal_all_ranks"] = weights_equal_all_ranks(torch, net)
    rec["n_params"] = len(trainer._params)
    if dev.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    rec["weights"] = flat_weights(torch, net)
    rec["grads"] = grads
    del net, trainer, step
    return rec


def dist_kv_dense(ctx):
    """Leg (d) on phase 8b's Dense-only widths (every kernel
    deterministic): dist_sync and dist_async through the split program
    from the same weights, each rank its 1/world of DIST_KV_DENSE_ROWS
    rows; whether the weights are bit-equal, and async's waits."""
    torch, dev, rank, world = ctx["torch"], ctx["dev"], ctx["rank"], \
        ctx["world"]
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.nn import Dense
    rows = ctx.get("dense_rows", DIST_KV_DENSE_ROWS)
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(rows, 768, generator=g, device=dev)
    y = torch.randint(0, 2, (rows,), generator=g, device=dev).float()
    per = rows // world
    xl, yl = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    lf = SoftmaxCrossEntropyLoss()
    out = {}
    for store in ("dist_sync", "dist_async"):
        init = torch.Generator().manual_seed(5)
        net = torch.nn.Sequential(
            Dense(3072, activation="relu", in_units=768, device=dev,
                  generator=init),
            Dense(768, in_units=3072, device=dev, generator=init),
            Dense(2, in_units=768, device=dev, generator=init))
        tr = Trainer(dict(net.named_parameters()), "adam",
                     {"learning_rate": 1e-3}, kvstore=store,
                     update_on_kvstore=False)
        step = tr.compile_step(lambda a, b: lf(net(a), b))
        for _ in range(DIST_KV_DENSE_STEPS):
            step(xl, yl, batch_size=rows)
        ctx["sync"]()
        out[store] = (flat_weights(torch, net), dict(tr._kvstore.stats),
                      step._split)
    (ws, ss, sp1), (wa, sa, sp2) = out["dist_sync"], out["dist_async"]
    return {"bit_equal": bool(torch.equal(ws, wa)), "sync_stats": ss,
            "async_stats": sa, "split": sp1 and sp2,
            "steps": DIST_KV_DENSE_STEPS, "rows": rows}


def dist_kv_rank(widths, batch, seq, steps, lr, out_dir, dense_rows=None):
    """Phase 13 across cards, one rank: BERT-base (dropout 0) on its
    contiguous 1/world of a seeded global batch. Runs, in order: leg (a)
    and phase 11's plain mesh mode in DIST_KV_MULTI_TURNS (leg (a) from
    a seed of the rank's own: the store's init must give it rank 0's
    weights; the mesh runs from rank 0's); the reference
    ``Trainer(kvstore=None)`` eager step; leg (b) (``Trainer.step``,
    ``update_on_kvstore`` by the JAX package's default); leg (c) (fp16
    and 2bit compression, DIST_KV_COMPRESSED_STEPS steps); leg (d)
    (``dist_async``) and :func:`dist_kv_dense`. Returns the rank's
    numbers; every comparison of weights is made here, on the card."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dist.device()
    rank, world = dist.rank(), dist.size()
    inits = {}

    def build(seed):
        net = bert_base_classifier(torch, seq, dev, widths)
        if seed not in inits:
            inits[seed] = init_params_numpy(net, seed=seed)
        load_jax_params(net, inits[seed])
        return net

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    net = build(2)
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = torch.from_numpy(rs.randint(0, vocab, (batch, seq))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (batch,))
                         .astype(np.float32)).to(dev)
    per = batch // world
    rows = slice(rank * per, (rank + 1) * per)
    ctx = {"torch": torch, "K": K, "dev": dev, "rank": rank,
           "world": world, "build": build, "sync": sync, "lr": lr,
           "steps": steps, "loss_fn": SoftmaxCrossEntropyLoss(), "x": x,
           "y": y, "xl": x[rows], "yl": y[rows], "rows": rows,
           "w0": flat_weights(torch, net), "out_dir": out_dir}
    if dense_rows:
        ctx["dense_rows"] = dense_rows
    del net
    own_seed = 2 + rank
    runs = [dist_kv_run(ctx, kind, seed=own_seed if kind == "split" else 2,
                        keep_grads=kind == "split" and i == 0,
                        at_step=DIST_KV_COMPRESSED_STEPS
                        if kind == "split" and i == 0 else None)
            for i, kind in enumerate(DIST_KV_MULTI_TURNS)]
    ref = dist_kv_run(ctx, "ref", keep_grads=True)
    on_store = dist_kv_run(ctx, "eager", update_on_kvstore=None)
    fp16 = dist_kv_run(ctx, "split", seed=own_seed,
                       steps=DIST_KV_COMPRESSED_STEPS,
                       compression={"type": "fp16"})
    two_bit = dist_kv_run(ctx, "split", seed=own_seed,
                          steps=DIST_KV_COMPRESSED_STEPS,
                          compression={"type": "2bit", "threshold": 0.5})
    async_ = dist_kv_run(ctx, "split", seed=own_seed, store="dist_async")
    w0 = ctx["w0"]
    split = [r for r in runs if r["kind"] == "split"]
    pair = [(r["losses"], r["weights"]) for r in split]
    # (a) against the reference: phase 6's vs_eager gate (the two (a)
    # runs' spread, or 1e-2 of how far the reference moved)
    vs_ref = [vs_eager([(ref["losses"], ref["weights"])], pair, w0,
                       r["losses"], r["weights"]) for r in split]
    # the first step's reduced gradients, (a) against the reference, as
    # phase 11's gradient check bounds them
    worst, worst_i = 0.0, None
    for i, (g, gr) in enumerate(zip(split[0]["grads"], ref["grads"])):
        ratio = float((g - gr).abs().max()) / (
            GRAD_ATOL + GRAD_RTOL * float(gr.abs().max()))
        if not math.isfinite(ratio) or ratio > worst:
            worst, worst_i = ratio, i
    a3 = split[0]["weights_at_step"]
    fp16_gap = rms_dist(fp16["weights"], a3)
    a3_moved = rms_dist(a3, w0)

    def facts(r):
        return {k: v for k, v in r.items()
                if k not in ("weights", "grads", "weights_at_step")}

    out = {"rank": rank, "world": world,
           "turns": [facts(r) for r in runs], "ref": facts(ref),
           "on_store": facts(on_store), "fp16": facts(fp16),
           "two_bit": facts(two_bit), "async": facts(async_),
           "a_vs_ref": vs_ref,
           "b_vs_a": vs_eager(pair, pair, w0, on_store["losses"],
                              on_store["weights"]),
           "grad_worst_err_over_bound": worst,
           "grad_worst_param_index": worst_i,
           "fp16_vs_a": {"rms_gap": fp16_gap, "a_moved": a3_moved,
                         "gap_over_moved": fp16_gap / a3_moved
                         if a3_moved else None,
                         "rtol": FP16_MOVED_RTOL,
                         "ok": fp16_gap <= FP16_MOVED_RTOL * a3_moved},
           "d_vs_a": spread_gate([w for _, w in pair], async_["weights"],
                                 rms_dist),
           "d_bit_equal_a": [bool(torch.equal(async_["weights"], w))
                             for _, w in pair],
           "dense": dist_kv_dense(ctx)}
    return out


def dist_kv_multi(torch, np, smi, device="cuda", world=None, widths=None,
                  batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                  timeout_s=900, dense_rows=None):
    """Phase 13 across the visible cards (:func:`dist_kv_rank`), one rank
    a card over NCCL. Gates: (a) the split program (``mode`` "fused",
    two graphs, ``update_on_kvstore`` False), every rank holding rank
    0's weights after the store's init, finite losses falling, bit-equal
    weights on every rank, one ``opt_update`` a step, one collective a
    bucket and one wait a step, the first step's reduced
    gradients within phase 11's bound of the reference's and the weights
    within :func:`vs_eager`'s limit of the reference's; (b) the store
    updating (the JAX default with several workers), bit-equal weights
    on every rank, within :func:`vs_eager`'s limit of (a)'s runs, one
    ``opt_update`` a parameter a step (the store updates each key as it
    is pushed), the states' round trip through the store's updater; (c)
    fp16 within FP16_MOVED_RTOL of (a) and 2bit's residuals finite and
    non-zero; (d) ``dist_async`` with no wait, its weights within the
    spread of (a)'s two runs (BERT's dq atomics keep two runs
    from being bit-equal) and, on the Dense-only model, bit-equal to
    ``dist_sync``. Prints the slowest rank's median step ms of (a) and
    of the mesh mode in turns, the spread and global tokens/s."""
    import shutil
    from mxnet_tpu_torch.parallel import dist
    world = world or torch.cuda.device_count()
    out_dir = os.path.abspath(os.path.join("build", "dist_kv"))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        ranks = dist.spawn(dist_kv_rank, world, device,
                           (widths, batch, seq, steps, TRAIN_LR, out_dir,
                            dense_rows), timeout_s=timeout_s)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]

    def slowest_median(i, n):
        return statistics.median(max(r["turns"][i]["step_ms"][s]
                                     for r in ranks)
                                 for s in range(1, n))

    medians = {}
    for i, kind in enumerate(DIST_KV_MULTI_TURNS):
        medians.setdefault(kind, []).append(slowest_median(i, steps))
    a = [t for t in r0["turns"] if t["kind"] == "split"]
    n_params = a[0]["n_params"]
    n_buckets = len(a[0]["buckets"])

    def every_rank(key, fn):
        return all(fn(r[key]) for r in ranks)

    def split_ok(t, blocks):
        return (t["mode"] == "fused" and t["split"] and t["graphs"] == 2
                and t["update_on_kvstore"] is False
                and t["init_equal_all_ranks"]
                and all(c == 1 for c in t["opt_update"])
                and all(c == len(t["buckets"]) for c in t["collectives"])
                and all(b == blocks for b in t["blocks"])
                and t["weights_equal_all_ranks"]
                and all(math.isfinite(v) for v in t["losses"]))

    def global_losses(i):
        # the ranks' rows are equal parts of the batch: the mean of their
        # means is the global batch's
        return [statistics.fmean(r["turns"][i]["losses"][s] for r in ranks)
                for s in range(steps)]

    a_losses = [global_losses(i) for i, k in enumerate(DIST_KV_MULTI_TURNS)
                if k == "split"]
    legs = {
        "a": all(split_ok(t, 1) and t["init_is_rank0s"]
                 for r in ranks for t in r["turns"] if t["kind"] == "split")
        and all(ls[-1] < ls[0] for ls in a_losses)
        and all(g["ok"] for r in ranks for g in r["a_vs_ref"])
        and max(r["grad_worst_err_over_bound"] for r in ranks) <= 1.0,
        # (the store's init broadcasts inside the first step)
        "b": r0["on_store"]["states_round_trip"]
        and r0["on_store"]["one_updater"]
        and every_rank("on_store", lambda t: t["update_on_kvstore"] is True
                        and t["weights_equal_all_ranks"]
                        and all(c == n_params for c in t["opt_update"])
                        and all(c == n_params for c in t["collectives"][1:])
                        and all(math.isfinite(v) for v in t["losses"]))
        and all(r["b_vs_a"]["ok"] for r in ranks),
        "c": every_rank("fp16", lambda t: split_ok(t, 1))
        and all(r["fp16_vs_a"]["ok"] for r in ranks)
        and every_rank("two_bit", lambda t: split_ok(t, 1)
                       and t["residuals"]["finite"]
                       and t["residuals"]["nonzero_share"] > 0),
        "d": every_rank("async", lambda t: split_ok(t, 0))
        and all(r["d_vs_a"]["ok"] for r in ranks)
        and all(r["dense"]["bit_equal"] and r["dense"]["split"]
                and r["dense"]["async_stats"]["blocks"] == 0
                for r in ranks)}
    report = {
        "model": "bert_base classifier", "world": world, "batch": batch,
        "seq": seq, "steps": steps, "optimizer": "adam",
        "learning_rate": TRAIN_LR, "dropout": 0.0,
        "order": list(DIST_KV_MULTI_TURNS), "buckets": a[0]["buckets"],
        "collectives_per_step": a[0]["collectives"][-1],
        "buckets_per_step": n_buckets,
        "blocks_per_step": a[0]["blocks"][-1],
        "opt_update_per_step": a[0]["opt_update"][-1],
        "losses_a_global": a_losses,
        "median_step_ms_slowest_rank": medians,
        "spread_ms": {k: max(v) - min(v) for k, v in medians.items()},
        "global_tokens_per_s": {k: [batch * seq / (m / 1e3) for m in v]
                                for k, v in medians.items()},
        "max_memory_allocated_rank0": {
            t["kind"] + str(i): t.get("max_memory_allocated")
            for i, t in enumerate(r0["turns"])},
        "a_vs_ref": r0["a_vs_ref"],
        "grad_worst_err_over_bound": max(r["grad_worst_err_over_bound"]
                                         for r in ranks),
        "b": {"vs_a": r0["b_vs_a"],
              "collectives_per_step": r0["on_store"]["collectives"][-1],
              "blocks_per_step": r0["on_store"]["blocks"][-1],
              "median_step_ms_rank0": statistics.median(
                  r0["on_store"]["step_ms"][1:]),
              "states_round_trip": r0["on_store"]["states_round_trip"]},
        "c": {"fp16_vs_a": r0["fp16_vs_a"],
              "fp16_losses": r0["fp16"]["losses"],
              "two_bit_losses": r0["two_bit"]["losses"],
              "two_bit_residuals": r0["two_bit"]["residuals"]},
        "d": {"blocks": r0["async"]["blocks"], "vs_a": r0["d_vs_a"],
              "bit_equal_a": r0["d_bit_equal_a"],
              "median_step_ms_rank0": statistics.median(
                  r0["async"]["step_ms"][1:]),
              "dense": r0["dense"]},
        "legs_ok": legs, "card": smi}
    report["ok"] = all(legs.values())
    emit({"dist_kv": report})
    if not report["ok"]:
        raise SystemExit(f"phase 13 (across cards) failed: {report}")
    return report

#: phase 14: bench.py bench_resnet's leg (bench.py:402-442): resnet50_v1
#: (1000 classes), batch 128 x 224 x 224 numpy-uniform images, SGD with
#: momentum 0.9 at lr 0.1, in float32 (both TF32 flags off) and under bf16
#: amp, through TrainLoop over compile_step; RESNET_STEPS steps a run
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 128, 224, 1000
RESNET_STEPS, RESNET_LR, RESNET_MOMENTUM = 10, 0.1, 0.9
#: resnet50_v1's trainable tensors (53 convolutions, 53 BatchNorms' gamma
#: and beta, the Dense weight and bias; its 106 running statistics are not
#: updated by the optimizer): one ``opt_update`` each a step
RESNET50_TRAINABLE = 161
#: the gradient check: the net after its first training step (a fresh
#: build and one step of the eager loop: every gradient non-zero, the
#: zero gammas of :func:`resnet_init` moved) is copied to the card and to
#: the CPU, and each copy takes RESNET_GRAD_STEPS training-mode backward
#: passes of
#: RESNET_GRAD_BATCH images of RESNET_GRAD_SIZE pixels (BatchNorm on the
#: batch's statistics, its running statistics written; no update). In
#: float32 each pass's gradients are held within GRAD_ATOL + GRAD_RTOL x
#: each parameter's largest CPU gradient, and the running statistics
#: after them within the same bound of each tensor's largest CPU value.
#: Under amp the card is held against a float64 CPU copy (amp off there):
#: each parameter's root-mean-square error within GRAD_RTOL_BF16 of its
#: largest gradient (a bias's: its layer's weight's too, ``bias_scale``),
#: and the running statistics within GRAD_RTOL_BF16 of their largest; the
#: largest element errors are printed beside those of a CPU copy under
#: amp, not held: a BatchNorm gamma's gradient sums bf16-rounded products
#: over every pixel of the batch, so one element can be off by O(1) of the
#: largest on any bf16 side (an H100 and a CPU copy under amp both reached
#: 1.16-1.18 at this shape, their rms 0.126-0.127: PERF.md section 6). A
#: wrong gradient (a lost term, a wrong scale) is off by O(1) of its
#: largest in rms too. The check runs on the net after its first step, not
#: after all RESNET_STEPS: at lr 0.1 on one repeated batch the net leaves
#: the region where two float32 implementations agree to 1e-3 of a
#: parameter's largest gradient (float32 against float64 on the CPU:
#: ``tests/vision_rounding.py``'s ``resnet50_trained_gradients``; PERF.md
#: section 6)
RESNET_GRAD_BATCH, RESNET_GRAD_SIZE, RESNET_GRAD_STEPS = 4, 64, 2
#: serving: the trained float32 net in eval mode through
#: ``predictor_for(net, "float32")``, then ``"bfloat16"`` (bfloat16
#: images), one captured program a bucket; RESNET_CPU_ROWS rows (a whole
#: bucket 128) against a CPU copy (converted the same way for bf16, so
#: that some of its rows clear the top-1 margin too): float32 logits within RESNET_LOGIT_RTOL of the largest |logit|
#: (at least 1: LOGIT_ATOL's 2e-4 where the logits are O(1); eval-mode
#: logits of a net trained ten steps are not), bf16 within
#: LOGIT_RTOL_BF16 of the largest; top-1 equal wherever the CPU copy's
#: top-2 margin exceeds that bound; images/s timed at
#: RESNET_TIMED_BUCKETS (the scoring batches of BASELINE.md's rows) over
#: RESNET_SERVE_ITERS back-to-back predicts
RESNET_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
RESNET_CPU_ROWS, RESNET_LOGIT_RTOL = 128, LOGIT_ATOL
RESNET_TIMED_BUCKETS, RESNET_SERVE_ITERS = (32, 128), 10


def resnet_init(np, net, seed):
    """Seeded float32 initial weights under ``net``'s parameter names:
    He-normal convolutions (std sqrt(2 / fan-in)), a 1 / sqrt(fan-in)
    Dense weight, BatchNorm's gamma 1, beta 0, running mean 0 and
    running variance 1, the Dense bias 0; and gamma 0 in the last
    BatchNorm of every residual block's body, so each block starts as
    its shortcut (Goyal et al. 2017, "Accurate, Large Minibatch SGD",
    section 5.1). With gamma 1 there, the random 50-layer net amplifies
    float32 rounding so far that no two float32 implementations agree:
    at the gradient check's shape, float32 training-mode gradients
    differ from float64's by 259 and 508 times the check's bound, with
    the zero gamma by 0.0035 and 0.0031 times (the CPU, float32
    accumulation: ``tests/vision_rounding.py``)."""
    rs = np.random.RandomState(seed)
    last = {f"{name}.{len(m) - 1}.gamma" for name, m in net.named_modules()
            if name.endswith(".body")}
    out = {}
    for name, p in net.named_parameters():
        shape = tuple(p.shape)
        if name in last:
            out[name] = np.zeros(shape, np.float32)
        elif name.endswith(("gamma", "running_var")):
            out[name] = np.ones(shape, np.float32)
        elif p.dim() == 1:
            out[name] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            std = math.sqrt((2.0 if p.dim() > 2 else 1.0) / fan_in)
            out[name] = (rs.standard_normal(shape) * std).astype(np.float32)
    return out


def train_grads(torch, net, loss_fn, x, y):
    """One backward of ``loss_fn`` at (x, y) (numpy) on ``net`` in
    training mode (BatchNorm on the batch's statistics, its running
    statistics written): {name: gradient on the CPU} of the parameters
    that have one."""
    net.train()
    dev = next(net.parameters()).device
    for p in net.parameters():
        p.grad = None
    loss_fn(net(torch.from_numpy(x).to(dev)),
            torch.from_numpy(y).to(dev)).sum().backward()
    out = {n: p.grad.detach().cpu() for n, p in net.named_parameters()
           if p.grad is not None}
    for p in net.parameters():
        p.grad = None
    return out


def running_stats(net):
    """{name: running statistic on the CPU, float64}."""
    return {n: p.detach().cpu().double() for n, p in net.named_parameters()
            if n.endswith(("running_mean", "running_var"))}


def resnet_grad_check(torch, np, net, loss_fn, amp_on):
    """The gradient check of :data:`RESNET_GRAD_BATCH`: a card copy of the
    trained ``net`` against a CPU copy (float32; under amp a float64 one,
    and beside it a float32 CPU copy under amp): each pass's worst
    gradients over their bound, then the running statistics'."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.params import load_jax_params
    t0 = time.perf_counter()

    def copy(device):
        return copy_to_cpu(lambda: resnet50_v1(classes=RESNET_CLASSES,
                                               device=device), net,
                           load_jax_params)

    card, cpu = copy(net.output.weight.device), copy("cpu")
    cpu_amp = copy("cpu") if amp_on else None
    if amp_on:
        cpu.double()
    rs = np.random.RandomState(8)
    passes = []
    for _ in range(RESNET_GRAD_STEPS):
        shape = (RESNET_GRAD_BATCH, 3, RESNET_GRAD_SIZE, RESNET_GRAD_SIZE)
        x = rs.uniform(size=shape).astype(np.float32)
        y = rs.randint(0, RESNET_CLASSES, (RESNET_GRAD_BATCH,)) \
            .astype(np.float32)
        g_card = train_grads(torch, card, loss_fn, x, y)
        if not amp_on:
            passes.append(grad_check(
                torch, None, None, loss_fn, x, y,
                grads=(g_card, train_grads(torch, cpu, loss_fn, x, y))))
            continue
        g_amp = train_grads(torch, cpu_amp, loss_fn, x, y)
        amp.uninit()
        try:
            g64 = train_grads(torch, cpu, loss_fn, x, y)
        finally:
            amp.init("bfloat16")
        rms = grad_errors(g_card, g64, bias_scale, rms=True)
        worst = max(rms, key=rms.get)
        passes.append({
            "params": len(rms), "worst_param": worst,
            "worst_rms_err_over_scale": rms[worst],
            "rtol_of_param_max": GRAD_RTOL_BF16,
            "largest_err_over_scale": {
                side: max(grad_errors(g, g64, bias_scale).values())
                for side, g in (("card_amp", g_card), ("cpu_amp", g_amp))},
            "cpu_amp_worst_rms_err_over_scale": max(grad_errors(
                g_amp, g64, bias_scale, rms=True).values()),
            "ok": rms[worst] <= GRAD_RTOL_BF16})
    stats = grad_check(torch, None, None, loss_fn, None, None,
                       rtol=GRAD_RTOL_BF16 if amp_on else GRAD_RTOL,
                       grads=(running_stats(card), running_stats(cpu)))
    return {"batch": RESNET_GRAD_BATCH, "size": RESNET_GRAD_SIZE,
            "passes": passes, "running_stats": stats,
            "cpu_dtype": "float64" if amp_on else "float32",
            "seconds": time.perf_counter() - t0,
            "ok": all(p["ok"] for p in passes) and stats["ok"]}


def train_resnet(torch, np, K, dev, smi, bf16=False, profile=False):
    """Phase 14: resnet50_v1 trained as ``bench_resnet`` trains it,
    through ``TrainLoop`` over ``compile_step`` (one captured graph a
    step), in the turns of :func:`train_turns` against the eager loop
    (the replays held bit-equal to the body run eagerly: the caller sets
    ``cudnn.deterministic``), with exactly one ``opt_update`` launch a
    step for its RESNET50_TRAINABLE parameters (float32, also under amp)
    and nothing else of the library, falling finite losses,
    and the gradient check of :func:`resnet_grad_check` on the net after
    its first step. ``bf16``: the
    same under ``amp.init()``, ``amp.uninit()`` after it whatever
    happens. ``profile``: :func:`profile_train_step` and
    :func:`profile_captured_step` of the trained net. Returns (the gated
    run's launches, its trained net)."""
    from mxnet_tpu_torch import amp
    if bf16:
        amp.init("bfloat16")
        try:
            return train_resnet(torch, np, K, dev, smi, False, profile)
        finally:
            amp.uninit()
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.params import load_jax_params
    amp_on = amp.is_enabled()
    t0 = time.perf_counter()
    net = resnet50_v1(classes=RESNET_CLASSES, device=dev)
    init = resnet_init(np, net, seed=6)
    rs = np.random.RandomState(7)
    x = rs.uniform(size=(RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE)) \
        .astype(np.float32)
    y = rs.randint(0, RESNET_CLASSES, (RESNET_BATCH,)).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    made = [net]
    del net, x

    def build():
        net = made.pop() if made else resnet50_v1(classes=RESNET_CLASSES,
                                                  device=dev)
        load_jax_params(net, init)
        net.train()
        return net, Trainer(dict(net.named_parameters()), "sgd",
                            {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM}), loss_fn

    setup_s = time.perf_counter() - t0
    turns, (net, trainer, _), gated = train_turns(
        torch, K, build, xt, yt, RESNET_STEPS, RESNET_BATCH, exact=True,
        by_dtype=True, loop=True, unit="images")
    losses, step_ms, per_step, counts, per_step_dt = gated
    n_params = len(trainer._params)
    expect = {n: 0 for n in K.KERNELS}
    # the whole update of the RESNET50_TRAINABLE float32 parameters
    expect.update(opt_update=1)
    expect_dt = {"opt_update": {"float32": 1}}
    launches_ok = n_params == RESNET50_TRAINABLE and \
        all(s == expect for s in per_step) and \
        all(s == expect_dt for s in per_step_dt)
    losses_ok = all(math.isfinite(v) for v in losses) and \
        losses[-1] < losses[0]
    master_ok = all(p.dtype == torch.float32 for p in net.parameters())
    if profile:
        what = f"resnet50_v1 {RESNET_BATCH} x {RESNET_SIZE}" + (
            " bf16 amp" if amp_on else "")
        profile_train_step(torch, net, trainer, loss_fn, xt, yt, what)
        profile_captured_step(torch, trainer.compile_step(
            lambda a, b: loss_fn(net(a), b)), xt, yt, what)
    torch.cuda.empty_cache()
    first, first_trainer, _ = build()
    plain_step(first, first_trainer, loss_fn)(xt, yt)
    del xt, yt, first_trainer
    grads = resnet_grad_check(torch, np, first, loss_fn, amp_on)
    del first
    median_ms = statistics.median(step_ms[1:])
    print(smi, flush=True)
    report = {
        "model": "resnet50_v1", "classes": RESNET_CLASSES,
        "dtype": "bfloat16 amp, float32 parameters" if amp_on
        else "float32",
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "batch": RESNET_BATCH, "size": RESNET_SIZE, "steps": RESNET_STEPS,
        "optimizer": "sgd", "learning_rate": RESNET_LR,
        "momentum": RESNET_MOMENTUM, "losses": losses, "step_ms": step_ms,
        "median_step_ms": median_ms,
        "images_per_s": RESNET_BATCH / (median_ms / 1e3),
        "max_memory_allocated": turns["captured_max_memory_allocated"][0],
        "max_memory_reserved": turns["captured_max_memory_reserved"][0],
        "setup_s": setup_s, "capture_s": turns["capture_s"][0],
        "n_traces_after_warmup": turns["turns"][0]["n_traces_after_warmup"],
        "n_traces_after_steps": turns["turns"][0]["n_traces_after_steps"],
        "trainable": n_params, "launches": counts,
        "launches_per_step": per_step[-1],
        "launches_per_step_expected": expect,
        "launches_per_step_by_dtype": per_step_dt[-1],
        "parameters_float32": master_ok, "grad_check": grads,
        "captured_vs_eager": turns, "card": smi,
        "ok": launches_ok and losses_ok and grads["ok"] and master_ok
        and turns["ok"]}
    emit({"resnet_train_bf16" if amp_on else "resnet_train": report})
    if not report["ok"]:
        raise SystemExit(f"phase 14 training failed: losses {losses}, "
                         f"launches per step {per_step} {per_step_dt}, "
                         f"gradients {grads}, float32 {master_ok}, "
                         f"captured vs eager {turns}")
    return counts, net


def serve_resnet(torch, np, dev, smi, net, dtype):
    """Phase 14's serving: ``predictor_for(net, dtype)`` over the trained
    net in eval mode (``"bfloat16"`` converts it in place, its
    BatchNorms float32; its images go in bfloat16), one program a bucket
    of RESNET_BUCKETS (capture s each, ``n_traces`` after the warm-up and
    after the run); a full bucket's replay against the net called eagerly
    on the card (GRAPH_ATOL); its first RESNET_CPU_ROWS rows against a
    CPU copy converted the same way (``cpu_s``: the copy's forward) and
    their top-1; images/s at
    RESNET_TIMED_BUCKETS; the profile of one bucket-128 micro-batch (its
    device busy share); peak memory."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.params import load_jax_params
    from mxnet_tpu_torch.serving import predictor_for
    bf16 = dtype == "bfloat16"
    xdt = torch.bfloat16 if bf16 else torch.float32
    cpu = copy_to_cpu(lambda: resnet50_v1(classes=RESNET_CLASSES,
                                          device="cpu"), net,
                      load_jax_params).eval()
    if bf16:
        amp.convert_hybrid_block(cpu, "bfloat16")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pred = predictor_for(net, dtype, bucket_sizes=RESNET_BUCKETS,
                         device=dev)
    rs = np.random.RandomState(9)
    big = RESNET_BUCKETS[-1]
    x = torch.from_numpy(rs.uniform(
        size=(big, 3, RESNET_SIZE, RESNET_SIZE)).astype(np.float32)) \
        .to(xdt).to(dev)
    capture = pred.warmup(x[:1])
    n_warm = pred.n_traces
    got = pred.predict(x)
    with torch.inference_mode():
        eager = pred.net(x)
    graph_diff = float((got.float() - eager.float()).abs().max())
    graph_tol = GRAPH_ATOL[dtype] * (float(eager.float().abs().max())
                                     if bf16 else 1.0)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu(x[:RESNET_CPU_ROWS].cpu()).float()
    cpu_s = time.perf_counter() - t0
    mine = got[:RESNET_CPU_ROWS].float().cpu()
    scale = float(ref.abs().max())
    tol = (LOGIT_RTOL_BF16 if bf16 else RESNET_LOGIT_RTOL) * max(scale, 1.0)
    err = float((mine - ref).abs().max())
    top2 = ref.topk(2, dim=1).values
    sure = (top2[:, 0] - top2[:, 1]) > tol
    top1_ok = bool(torch.equal(mine.argmax(1)[sure], ref.argmax(1)[sure]))
    rates = {}
    for b in RESNET_TIMED_BUCKETS:
        xb = x[:b]
        pred.predict(xb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RESNET_SERVE_ITERS):
            pred.predict(xb)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / RESNET_SERVE_ITERS
        rates[str(b)] = {"ms_per_batch": ms, "images_per_s": b / ms * 1e3}
    prof = profile_bucket(torch, np, pred, smi, bucket=big, x=x)
    print(smi, flush=True)
    report = {
        "model": "resnet50_v1", "dtype": dtype, "images": str(xdt),
        "buckets": list(RESNET_BUCKETS), "capture_s": capture,
        "n_traces_after_warmup": n_warm, "n_traces": pred.n_traces,
        "graph_vs_eager": {"max_abs_diff": graph_diff, "atol": graph_tol,
                           "bit_equal": bool(torch.equal(got, eager))},
        "vs_cpu": {"rows": RESNET_CPU_ROWS, "max_abs_err": err,
                   "largest_logit": scale, "atol": tol,
                   "top1_rows_checked": int(sure.sum()),
                   "top1_equal": top1_ok, "cpu_s": cpu_s},
        "throughput": rates,
        "device_busy_share": prof["device_busy_share"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "max_memory_reserved": torch.cuda.max_memory_reserved(),
        "card": smi,
        "ok": err <= tol and top1_ok and graph_diff <= graph_tol
        and n_warm == pred.n_traces == len(RESNET_BUCKETS)}
    emit({"resnet_serving_bf16" if bf16 else "resnet_serving": report})
    if not report["ok"]:
        raise SystemExit(f"phase 14 serving failed: {report}")
    return report


def resnet_phase(torch, np, K, dev, smi, profile=False):
    """Phase 14: resnet50_v1's whole update held against its plain
    version, the net trained in float32 and under bf16 amp, then the
    float32-trained net served in float32 and bfloat16. Returns the
    launches of the float32 and bf16 runs.

    The training runs under ``cudnn.deterministic``, so that a replay is
    held bit-equal to its body run eagerly: with cuDNN's default
    algorithms the float32 backward sums in an order that changes between
    runs, and a gate on the spread of two body runs failed one run in four
    (PERF.md section 6). Serving runs on the defaults."""
    from mxnet_tpu_torch.ops.kernels import opt_update as KO
    torch.cuda.empty_cache()
    time_resnet_update(torch, K, KO, dev)
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        counts, net = train_resnet(torch, np, K, dev, smi, profile=profile)
        torch.cuda.empty_cache()
        counts_bf16, _ = train_resnet(torch, np, K, dev, smi, bf16=True,
                                      profile=profile)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        serve_resnet(torch, np, dev, smi, net, dtype)
        torch.cuda.empty_cache()
    del net
    torch.cuda.empty_cache()
    return counts, counts_bf16


#: phase 15, training's surface. (a) BERT-base pretraining with LAMB as
#: GluonNLP's script sets it: lr 1e-4, wd 0.01, no weight decay on gamma,
#: beta and bias; phase 6's model, batch, dropout and turns
SURFACE_BERT_LR, SURFACE_BERT_WD = 1e-4, 0.01
#: (b) gluon-cv's ImageNet recipe (``train_imagenet.py``) on phase 14's
#: ResNet-50: ``MSRAPrelu`` initial weights (each block's last gamma 0,
#: its ``--last-gamma``), NAG momentum 0.9 at lr 0.1 under a cosine
#: schedule over the run, wd 1e-4 but not on beta, gamma and bias
#: (``--no-wd``), labels smoothed by 0.1 (``--label-smoothing``); its
#: evaluation in micro-batches of SURFACE_EVAL_MICRO
SURFACE_NAG_LR, SURFACE_NAG_MOMENTUM, SURFACE_NAG_WD = 0.1, 0.9, 1e-4
SURFACE_LABEL_SMOOTHING, SURFACE_EVAL_MICRO = 0.1, 32
#: a rule's update on the card against the same update on the CPU, the
#: card's weights and gradients fed to both: within ATOL + RTOL |w| (the
#: norms of LAMB / LARS / LANS summed in another order)
SURFACE_UPD_ATOL, SURFACE_UPD_RTOL = 1e-6, 1e-5
#: metrics updated on the card against the same metrics fed numpy copies
#: (float32 sums on the card, float64 on the host)
SURFACE_METRIC_RTOL = 1e-5
#: (c) every registered rule, with a setting other than its default
#: where it has one, SURFACE_SWEEP_STEPS captured steps of phase 8b's
#: Dense-only model against an eager twin and a CPU copy
SURFACE_SWEEP_STEPS = 3
SURFACE_SWEEP = (
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("signum", {"learning_rate": 1e-3, "momentum": 0.0}),
    ("sgld", {"learning_rate": 1e-4}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-3, "wd": 1e-3}),
    ("adamw", {"learning_rate": 1e-3, "wd": 1e-2}),
    ("adabelief", {"learning_rate": 1e-3}),
    ("adamax", {"learning_rate": 2e-3, "beta2": 0.99}),
    ("nadam", {"learning_rate": 1e-3, "schedule_decay": 0.01}),
    ("adagrad", {"learning_rate": 1e-2, "wd": 1e-3}),
    ("groupadagrad", {"learning_rate": 1e-2}),
    ("adadelta", {"rho": 0.95}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True,
                 "clip_weights": 2.0}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 1e-3}),
    ("ftml", {"learning_rate": 2.5e-3}),
    ("lars", {"learning_rate": 0.1, "eta": 0.01, "wd": 1e-4}),
    ("lamb", {"learning_rate": 1e-3, "wd": 0.01, "lower_bound": 1e-3,
              "upper_bound": 10.0}),
    ("lans", {"learning_rate": 1e-3, "wd": 0.01}))
#: SGLD's noise std against sqrt(lr)
SURFACE_SGLD_STD_RTOL = 0.05
#: (d) each loss and its input gradients on the card against a CPU copy,
#: the largest error over the largest value; CTC over a character-level
#: speech batch (T frames x N rows x C classes, labels of up to L)
SURFACE_LOSS_RTOL, SURFACE_CTC_RTOL = 1e-5, 1e-4
SURFACE_CTC = (200, 32, 29, 50)


def no_wd_on_norms_and_biases(params):
    """wd_mult 0 on every gamma, beta and bias (GluonNLP's and gluon-cv's
    scripts); returns how many."""
    n = 0
    for name, p in params.items():
        if name.endswith(("gamma", "beta", "bias")):
            p.wd_mult = 0.0
            n += 1
    return n


def cpu_twin(torch, trainer, name, kw):
    """A CPU copy of ``trainer``'s parameters (their current weights,
    lr_mult and wd_mult) under a fresh ``Trainer(..., name, kw)``."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.nn import init_param
    cpu = {}
    for i, p in enumerate(trainer._params):
        c = torch.nn.Parameter(p.detach().to("cpu", copy=True))
        # names that sort as the parameters do
        cpu[f"{i:06d}"] = init_param(c, wd_mult=p.wd_mult,
                                     lr_mult=p.lr_mult)
    return Trainer(cpu, name, dict(kw))


def update_vs_cpu(torch, trainer, twin, grads, batch):
    """One update of ``trainer``'s parameters (on the card) against the
    same update of its CPU ``twin``, both fed ``grads`` (the card's
    gradients): {largest |card - cpu|, its excess over SURFACE_UPD_ATOL +
    SURFACE_UPD_RTOL |cpu| (<= 0 passes), elements}."""
    for p, c, g in zip(trainer._params, twin._params, grads):
        p.grad, p.fresh_grad = g, True
        c.grad, c.fresh_grad = g.detach().cpu(), True
    trainer.step(batch)
    twin.step(batch)
    return twin_gap(trainer, twin)


def twin_gap(trainer, twin):
    """``trainer``'s weights (on the card) against its CPU ``twin``'s
    after the same update: {largest |card - cpu|, its excess over
    SURFACE_UPD_ATOL + SURFACE_UPD_RTOL |cpu| (<= 0 passes), elements}."""
    worst, excess, n = 0.0, -1.0, 0
    for p, c in zip(trainer._params, twin._params):
        ref = c.detach()
        err = (p.detach().cpu() - ref).abs()
        worst = max(worst, float(err.max()))
        excess = max(excess, float((err - SURFACE_UPD_ATOL
                                    - SURFACE_UPD_RTOL * ref.abs()).max()))
        n += ref.numel()
    return {"max_abs_err": worst, "excess_over_bound": excess,
            "atol": SURFACE_UPD_ATOL, "rtol": SURFACE_UPD_RTOL,
            "elements": n, "ok": excess <= 0.0}


def time_rule_update(torch, K, dev, what, params, opt, lr, wd, batch,
                     per_elem, library=None, library_name=None):
    """The whole update of ``params`` as the captured step runs it
    (``Optimizer.whole_step_fn``, hyperparameters in a device block) for
    a rule the ``opt_update`` kernel does not take: its launches of the
    library (0 expected), its device ms by CUDA-graph replay, beside
    ``library`` where PyTorch has the same function, against the bound of
    ``per_elem`` = (bytes, float32 operations) an element."""
    from mxnet_tpu_torch.optimizer.optimizer import DeviceHParams
    g = torch.Generator(device=dev).manual_seed(11)
    grads = [torch.randn(p.shape, generator=g, device=dev) * 1e-3
             for p in params]
    states = [opt.create_state(i, p) for i, p in enumerate(params)]
    hp = DeviceHParams(len(params), dev)
    hp.stage([lr] * len(params),
             [0.0 if p.dim() == 1 else wd for p in params],
             [1] * len(params), 1.0 / batch, 0.0)
    update = opt.whole_step_fn(params, states, hp)
    K.reset_launch_counts()
    update(grads)
    torch.cuda.synchronize()
    launches = sum(K.launch_counts().values())
    ms, eager_ms = time_ms(torch, lambda: update(grads), [()], iters=5,
                           replays=3)
    library_ms = None
    if library is not None:
        lib_states = [tuple(s.clone() for s in opt.state_tensors(st))
                      for st in states]
        library_ms, _ = time_ms(
            torch, lambda: library(params, grads, lib_states), [()],
            iters=5, replays=3)
    n = sum(p.numel() for p in params)
    b_ms, b_by = bound_ms(per_elem[0] * n, per_elem[1] * n, "float32")
    return {"what": what, "parameters": len(params), "elements": n,
            "library_launches": launches, "ms": ms, "eager_ms": eager_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "library": library_name, "ok": launches == 0}


def surface_bert(torch, np, K, dev, smi, profile=False):
    """Phase 15a: phase 6's BERT-base classifier trained with LAMB
    (:data:`SURFACE_BERT_LR`, no wd on gamma, beta, bias) in phase 6's
    turns; exactly 12 flash_fwd + 12 flash_bwd_fused + 25 layernorm_fwd +
    25 layernorm_bwd and no ``opt_update`` a step; one full-width LAMB
    update (a fresh build's weights and first gradients) against a CPU
    copy (:func:`update_vs_cpu`: the trust ratios' norms over the
    23,440,896-value word embedding among them); a ``metric.Loss`` fed
    ten more captured steps' losses on the card with any sync an error;
    the whole LAMB update timed alone (:func:`time_rule_update`)."""
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.optimizer import LAMB
    kw = {"learning_rate": SURFACE_BERT_LR, "wd": SURFACE_BERT_WD}

    def make(device):
        return BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=0.1,
                                        device=device),
                              num_classes=2, dropout=0.1, device=device)

    net = make(dev)
    init = init_params_numpy(net, seed=2)
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = rs.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    y = rs.randint(0, 2, (TRAIN_BATCH,)).astype(np.float32)
    loss_fn = SoftmaxCrossEntropyLoss()
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    made, no_wd = [net], []
    del net

    def build():
        net = made.pop() if made else make(dev)
        load_jax_params(net, init)
        net.train()
        torch.manual_seed(0)        # the dropout masks
        params = dict(net.named_parameters())
        no_wd.append(no_wd_on_norms_and_biases(params))
        return net, Trainer(params, "lamb", dict(kw)), loss_fn

    turns, (net, trainer, _), gated = train_turns(
        torch, K, build, xt, yt, TRAIN_STEPS, TRAIN_BATCH * TRAIN_SEQ,
        exact=False)
    losses, step_ms, per_step, counts = gated
    expect = {n: 0 for n in K.KERNELS}
    expect.update(flash_fwd=12, flash_bwd_fused=12, layernorm_fwd=25,
                  layernorm_bwd=25)
    launches_ok = all(s == expect for s in per_step)
    losses_ok = all(math.isfinite(v) for v in losses) and \
        losses[-1] < losses[0]
    # ten more captured steps on the trained net, their losses into a
    # metric.Loss on the card with any sync an error
    step = trainer.compile_step(lambda a, b: loss_fn(net(a), b))
    step.aot_compile(xt, yt)
    torch.cuda.synchronize()
    lm, host = metric.Loss(), []
    for _ in range(TRAIN_STEPS):
        loss = step(xt, yt)
        torch.cuda.set_sync_debug_mode("error")
        try:
            lm.update(None, loss)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host.append(loss)
    got = lm.get()[1]
    ref = float(np.mean([l.cpu().numpy() for l in host]))
    metric_rec = {"get": got, "host_mean": ref,
                  "ok": abs(got - ref) <= SURFACE_METRIC_RTOL * abs(ref)}
    if profile:
        profile_captured_step(torch, step, xt, yt,
                              "bert_base classifier 32 x 512, LAMB")
    del step, host, loss
    torch.cuda.empty_cache()
    # one full-width update against the CPU: a fresh build's first step
    t1 = time.perf_counter()
    fresh, ftr, _ = build()
    loss_fn(fresh(xt), yt).sum().backward()
    grads = [p.grad.detach().clone() for p in ftr._params]
    upd = update_vs_cpu(torch, ftr, cpu_twin(torch, ftr, "lamb", kw), grads,
                        TRAIN_BATCH)
    upd["seconds"] = time.perf_counter() - t1
    upd["largest_tensor"] = max(p.numel() for p in ftr._params)
    del fresh, ftr, grads
    torch.cuda.empty_cache()
    timed_net = make(dev)
    tparams = [p.detach() for p in timed_net.parameters()]
    timed = time_rule_update(
        torch, K, dev, "bert_base classifier LAMB update, one card, "
        "float32", tparams, LAMB(**kw), SURFACE_BERT_LR, SURFACE_BERT_WD,
        TRAIN_BATCH, (28, 25.0))
    del timed_net, tparams
    torch.cuda.empty_cache()
    median_ms = statistics.median(step_ms[1:])
    print(smi, flush=True)
    report = {
        "model": "bert_base classifier", "dtype": "float32",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "optimizer": "lamb", "learning_rate": SURFACE_BERT_LR,
        "wd": SURFACE_BERT_WD, "no_wd_params": no_wd[0], "dropout": 0.1,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3),
        "max_memory_allocated": turns["captured_max_memory_allocated"][0],
        "capture_s": turns["capture_s"][0],
        "launches_per_step": per_step[-1],
        "launches_per_step_expected": expect,
        "update_vs_cpu": upd, "loss_metric_no_sync": metric_rec,
        "update_graph": timed, "captured_vs_eager": turns, "card": smi,
        "ok": launches_ok and losses_ok and turns["ok"] and upd["ok"]
        and metric_rec["ok"] and timed["ok"]}
    emit({"surface_bert_lamb": report})
    if not report["ok"]:
        raise SystemExit(f"phase 15a failed: losses {losses}, launches "
                         f"{per_step}, update vs cpu {upd}, metric "
                         f"{metric_rec}, update graph {timed}, captured vs "
                         f"eager {turns}")
    return counts


def smoothed_one_hot(np, labels, classes, eta):
    """gluon-cv's label smoothing: 1 - eta + eta / classes on the label,
    eta / classes elsewhere."""
    out = np.full((len(labels), classes), eta / classes, np.float32)
    out[np.arange(len(labels)), labels.astype(np.int64)] += 1.0 - eta
    return out


def surface_resnet(torch, np, K, dev, smi, profile=False):
    """Phase 15b: phase 14's resnet50_v1, batch and turns under gluon-cv's
    ImageNet recipe: ``initialize(net, MSRAPrelu())`` (each block's last
    gamma then 0), NAG under ``CosineScheduler`` (each replay reads a new
    lr), no wd on beta, gamma, bias, ``SoftmaxCrossEntropyLoss(
    sparse_label=False)`` on smoothed one-hot labels. Phase 14's gates
    but no ``opt_update`` (nothing of the library launched), the
    gradient check of the net after one step (phase 14's, sparse
    labels); then an eval-mode pass in micro-batches with ``Accuracy``,
    ``TopKAccuracy(5)`` and ``CrossEntropy`` updated on the card (any
    sync an error) against the same metrics fed numpy copies; the whole
    NAG update timed alone beside ``torch._fused_sgd_(nesterov=True)``."""
    from mxnet_tpu_torch import initializer, lr_scheduler, metric
    from mxnet_tpu_torch.gluon import Trainer, initialize
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.params import load_jax_params
    from mxnet_tpu_torch.optimizer import NAG
    net = resnet50_v1(classes=RESNET_CLASSES, device=dev)
    initialize(net, initializer.MSRAPrelu(),
               generator=torch.Generator().manual_seed(6))
    last = {f"{name}.{len(m) - 1}.gamma" for name, m in net.named_modules()
            if name.endswith(".body")}
    init = {n: (np.zeros(tuple(p.shape), np.float32) if n in last
                else p.detach().cpu().numpy().copy())
            for n, p in net.named_parameters()}
    rs = np.random.RandomState(7)
    x = rs.uniform(size=(RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE)) \
        .astype(np.float32)
    y = rs.randint(0, RESNET_CLASSES, (RESNET_BATCH,)).astype(np.float32)
    ys = smoothed_one_hot(np, y, RESNET_CLASSES, SURFACE_LABEL_SMOOTHING)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(ys).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss(sparse_label=False)
    kw = {"learning_rate": SURFACE_NAG_LR, "momentum": SURFACE_NAG_MOMENTUM,
          "wd": SURFACE_NAG_WD}
    made = [net]
    del net, x

    def build():
        net = made.pop() if made else resnet50_v1(classes=RESNET_CLASSES,
                                                  device=dev)
        load_jax_params(net, init)
        net.train()
        params = dict(net.named_parameters())
        no_wd_on_norms_and_biases(params)
        sched = lr_scheduler.CosineScheduler(
            RESNET_STEPS + 1, base_lr=SURFACE_NAG_LR, final_lr=0.0)
        return net, Trainer(params, "nag", dict(kw, lr_scheduler=sched)), \
            loss_fn

    turns, (net, trainer, _), gated = train_turns(
        torch, K, build, xt, yt, RESNET_STEPS, RESNET_BATCH, exact=True,
        loop=True, unit="images")
    losses, step_ms, per_step, counts = gated
    expect = {n: 0 for n in K.KERNELS}
    launches_ok = len(trainer._params) == RESNET50_TRAINABLE and \
        all(s == expect for s in per_step)
    losses_ok = all(math.isfinite(v) for v in losses) and \
        losses[-1] < losses[0]
    lrs_read = trainer._optimizer.learning_rate
    if profile:
        profile_captured_step(torch, trainer.compile_step(
            lambda a, b: loss_fn(net(a), b)), xt, yt,
            f"resnet50_v1 {RESNET_BATCH} x {RESNET_SIZE}, NAG")
    # the evaluation: four micro-batches of the trained net in eval mode
    net.eval()
    labels = torch.from_numpy(y).to(dev)
    on_card = [metric.Accuracy(), metric.TopKAccuracy(5),
               metric.CrossEntropy()]
    probs = []
    with torch.inference_mode():
        for i in range(0, RESNET_BATCH, SURFACE_EVAL_MICRO):
            p = torch.softmax(net(xt[i:i + SURFACE_EVAL_MICRO]), dim=-1)
            lab = labels[i:i + SURFACE_EVAL_MICRO]
            torch.cuda.set_sync_debug_mode("error")
            try:
                for m in on_card:
                    m.update(lab, p)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            probs.append(p)
    on_host = [metric.Accuracy(), metric.TopKAccuracy(5),
               metric.CrossEntropy()]
    for i, p in enumerate(probs):
        rows = slice(i * SURFACE_EVAL_MICRO, (i + 1) * SURFACE_EVAL_MICRO)
        for m in on_host:
            m.update(y[rows], p.cpu().numpy())
    metrics = {m.get()[0]: {"card": m.get()[1], "numpy": h.get()[1]}
               for m, h in zip(on_card, on_host)}
    metrics_ok = all(abs(v["card"] - v["numpy"]) <= SURFACE_METRIC_RTOL
                     * max(abs(v["numpy"]), 1e-12) for v in metrics.values())
    del net, trainer, probs
    torch.cuda.empty_cache()
    first, first_trainer, _ = build()
    plain_step(first, first_trainer, loss_fn)(xt, yt)
    del xt, yt, first_trainer
    grads = resnet_grad_check(torch, np, first, SoftmaxCrossEntropyLoss(),
                              False)
    del first
    torch.cuda.empty_cache()
    timed_net = resnet50_v1(classes=RESNET_CLASSES, device=dev)
    tparams = [p.detach() for p in timed_net.parameters()
               if getattr(p, "grad_req", "write") != "null"]

    def library(params, grads, states):
        torch._fused_sgd_(params, grads, [s[0] for s in states],
                          weight_decay=0.0, momentum=SURFACE_NAG_MOMENTUM,
                          lr=SURFACE_NAG_LR, dampening=0.0, nesterov=True,
                          maximize=False, is_first_step=False)

    timed = time_rule_update(
        torch, K, dev, "resnet50_v1 NAG update, one card, float32", tparams,
        NAG(learning_rate=SURFACE_NAG_LR, momentum=SURFACE_NAG_MOMENTUM),
        SURFACE_NAG_LR, 0.0, RESNET_BATCH, (20, 7.0), library,
        "torch._fused_sgd_(nesterov=True) over the same list")
    del timed_net, tparams
    torch.cuda.empty_cache()
    median_ms = statistics.median(step_ms[1:])
    print(smi, flush=True)
    report = {
        "model": "resnet50_v1", "classes": RESNET_CLASSES,
        "dtype": "float32", "init": "initialize(MSRAPrelu()), last gamma 0",
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "batch": RESNET_BATCH, "size": RESNET_SIZE, "steps": RESNET_STEPS,
        "optimizer": "nag", **kw, "lr_scheduler": "CosineScheduler",
        "lr_after_run": lrs_read,
        "label_smoothing": SURFACE_LABEL_SMOOTHING,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_ms,
        "images_per_s": RESNET_BATCH / (median_ms / 1e3),
        "max_memory_allocated": turns["captured_max_memory_allocated"][0],
        "max_memory_reserved": turns["captured_max_memory_reserved"][0],
        "capture_s": turns["capture_s"][0],
        "launches_per_step": per_step[-1],
        "launches_per_step_expected": expect, "grad_check": grads,
        "eval_metrics": dict(metrics, micro_batch=SURFACE_EVAL_MICRO,
                             rtol=SURFACE_METRIC_RTOL, ok=metrics_ok),
        "update_graph": timed, "captured_vs_eager": turns, "card": smi,
        "ok": launches_ok and losses_ok and grads["ok"] and turns["ok"]
        and metrics_ok and timed["ok"]}
    emit({"surface_resnet_nag": report})
    if not report["ok"]:
        raise SystemExit(f"phase 15b failed: losses {losses}, launches "
                         f"{per_step}, gradients {grads}, metrics "
                         f"{metrics}, update graph {timed}, captured vs "
                         f"eager {turns}")
    return counts


def surface_sweep(torch, np, K, dev, smi):
    """Phase 15c: each rule of :data:`SURFACE_SWEEP` on phase 8b's
    Dense-only model: SURFACE_SWEEP_STEPS captured steps against as many
    eager ``Trainer.step``s from the same weights (the rms gap within
    CAPTURED_EAGER_RTOL of how far the eager run moved; SGLD from the
    same generator state, bit for bit), the eager run against a CPU
    copy (:func:`cpu_twin`) fed the card's gradients of each step, after
    each step (:func:`update_vs_cpu`; SGLD's noise instead held to its
    law: the std of its moves within SURFACE_SGLD_STD_RTOL of sqrt(lr)),
    and ``opt_update`` launched once a step for exact SGD and Adam only,
    never for the others."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.nn import Dense
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(DENSE_ROWS, 768, generator=g, device=dev)
    y = torch.randint(0, 2, (DENSE_ROWS,), generator=g, device=dev).float()
    loss_fn = SoftmaxCrossEntropyLoss()

    def make():
        init = torch.Generator().manual_seed(5)
        return torch.nn.Sequential(
            Dense(3072, activation="relu", in_units=768, device=dev,
                  generator=init),
            Dense(768, in_units=3072, device=dev, generator=init),
            Dense(2, in_units=768, device=dev, generator=init))

    rows, t0 = [], time.perf_counter()
    for name, kw in SURFACE_SWEEP:
        kinds = {}
        for kind in ("captured", "eager"):
            net = make()
            w0 = flat_weights(torch, net)
            kwargs = dict(kw)
            if name == "sgld":
                kwargs["generator"] = torch.Generator(device=dev) \
                    .manual_seed(8)
            tr = Trainer(dict(net.named_parameters()), name, kwargs)
            cpu_checks = []
            if kind == "captured":
                step = tr.compile_step(
                    lambda a, b, net=net: loss_fn(net(a), b))
                step.aot_compile(x, y)
                torch.cuda.synchronize()
                K.reset_launch_counts()
                for _ in range(SURFACE_SWEEP_STEPS):
                    step(x, y)
                mode, traces = step.mode, step.n_traces
                del step
            else:
                twin = None if name == "sgld" else \
                    cpu_twin(torch, tr, name, kw)
                K.reset_launch_counts()
                mode, traces = "eager", 0
                for _ in range(SURFACE_SWEEP_STEPS):
                    loss_fn(net(x), y).sum().backward()
                    if twin is None:
                        tr.step(DENSE_ROWS)
                        continue
                    grads = [p.grad.detach().clone() for p in tr._params]
                    cpu_checks.append(update_vs_cpu(torch, tr, twin, grads,
                                                    DENSE_ROWS))
            torch.cuda.synchronize()
            kinds[kind] = {"w": flat_weights(torch, net), "w0": w0,
                           "launches": K.launch_counts()["opt_update"],
                           "mode": mode, "n_traces": traces,
                           "cpu": cpu_checks}
            del net, tr
        cap, eag = kinds["captured"], kinds["eager"]
        gap = rms_dist(cap["w"], eag["w"])
        moved = rms_dist(eag["w"], eag["w0"])
        rec = {"optimizer": name, "settings": kw,
               "captured_vs_eager": {"gap_rms": gap, "moved_rms": moved,
                                     "limit": CAPTURED_EAGER_RTOL * moved,
                                     "bit_equal": bool(torch.equal(
                                         cap["w"], eag["w"]))},
               "opt_update_launches": {"captured": cap["launches"],
                                       "eager": eag["launches"]},
               "mode": cap["mode"], "n_traces": cap["n_traces"]}
        want = SURFACE_SWEEP_STEPS if name in ("sgd", "adam") else 0
        ok = cap["mode"] == "fused" and cap["n_traces"] == 1 and \
            cap["launches"] == want and eag["launches"] == want and \
            gap <= CAPTURED_EAGER_RTOL * moved and moved > 0
        if name == "sgld":
            std = float((cap["w"] - cap["w0"]).std()) / \
                math.sqrt(SURFACE_SWEEP_STEPS)
            want_std = math.sqrt(kw["learning_rate"])
            rec["noise_std"] = {"measured": std, "sqrt_lr": want_std}
            ok = ok and rec["captured_vs_eager"]["bit_equal"] and \
                abs(std / want_std - 1) <= SURFACE_SGLD_STD_RTOL
        else:
            rec["update_vs_cpu"] = {
                "max_abs_err": max(c["max_abs_err"] for c in eag["cpu"]),
                "excess_over_bound": max(c["excess_over_bound"]
                                         for c in eag["cpu"]),
                "steps": len(eag["cpu"])}
            ok = ok and all(c["ok"] for c in eag["cpu"])
        rec["ok"] = ok
        rows.append(rec)
        del kinds, cap, eag
    print(smi, flush=True)
    report = {"model": "Dense 768 -> 3072 -> 768 -> 2", "rows": DENSE_ROWS,
              "steps": SURFACE_SWEEP_STEPS, "optimizers": rows,
              "seconds": time.perf_counter() - t0, "card": smi,
              "ok": len(rows) == 19 and all(r["ok"] for r in rows)}
    emit({"surface_sweep": report})
    if not report["ok"]:
        raise SystemExit("phase 15c failed: "
                         f"{[r for r in rows if not r['ok']]}")
    return report


def surface_loss_cases(np):
    """Phase 15d's inputs: (loss class name, constructor keywords, numpy
    inputs, the indices of the inputs to differentiate, keyword inputs)."""
    rs = np.random.RandomState(31)

    def f(*shape):
        return rs.randn(*shape).astype(np.float32)

    def sign(*shape):
        return np.sign(f(*shape)).astype(np.float32)

    def bits(*shape):
        return rs.randint(0, 2, shape).astype(np.float32)

    reg, cls = (512, 256), (256, 1000)
    # a confident teacher's distribution (distillation): a softmax of
    # logits with std 4
    t = 4.0 * rs.randn(*cls)
    dist = np.exp(t - t.max(-1, keepdims=True))
    dist = (dist / dist.sum(-1, keepdims=True)).astype(np.float32)
    t_len, n, c, l_max = SURFACE_CTC
    label_len = rs.randint(10, l_max + 1, n)
    labels = np.zeros((n, l_max), np.float32)
    for i, k in enumerate(label_len):
        labels[i, :k] = rs.randint(1, c, k)
    pred_len = rs.randint(int(0.75 * t_len), t_len + 1, n)
    return [
        ("L2Loss", {}, [f(*reg), f(*reg)], [0], {}),
        ("L1Loss", {}, [f(*reg), f(*reg)], [0], {}),
        ("HuberLoss", {"rho": 0.5}, [f(*reg), f(*reg)], [0], {}),
        ("HingeLoss", {}, [f(*reg), sign(*reg)], [0], {}),
        ("SquaredHingeLoss", {}, [f(*reg), sign(*reg)], [0], {}),
        ("LogisticLoss", {}, [f(*reg), sign(*reg)], [0], {}),
        ("SigmoidBinaryCrossEntropyLoss", {}, [f(*reg), bits(*reg)], [0],
         {}),
        ("SoftmaxCrossEntropyLoss", {},
         [f(*cls), rs.randint(0, cls[1], cls[0]).astype(np.float32)], [0],
         {}),
        ("KLDivLoss", {"from_logits": False}, [f(*cls), dist], [0], {}),
        ("TripletLoss", {}, [f(512, 128), f(512, 128), f(512, 128)],
         [0, 1, 2], {}),
        ("CosineEmbeddingLoss", {"margin": 0.1},
         [f(512, 128), f(512, 128), sign(512)], [0, 1], {}),
        ("PoissonNLLLoss", {"compute_full": True},
         [f(*reg), rs.poisson(3.0, reg).astype(np.float32)], [0], {}),
        ("CTCLoss", {}, [f(n, t_len, c), labels], [0],
         {"pred_lengths": pred_len.astype(np.float32),
          "label_lengths": label_len.astype(np.float32)}),
        ("SDMLLoss", {}, [f(256, 128), f(256, 128)], [0, 1], {})]


def surface_losses(torch, np, dev, smi):
    """Phase 15d: every loss of ``gluon.loss`` forward and backward on the
    card against a CPU copy of the same inputs: the per-sample losses
    and each input gradient within SURFACE_LOSS_RTOL of the largest
    value (CTC SURFACE_CTC_RTOL; its batch a character-level speech
    batch, ragged ``pred_lengths`` / ``label_lengths``)."""
    from mxnet_tpu_torch.gluon import loss as L
    rows = []
    for name, kw, inputs, diff, kw_in in surface_loss_cases(np):
        outs = []
        for device in (dev, torch.device("cpu")):
            ins = [torch.from_numpy(a).to(device) for a in inputs]
            for i in diff:
                ins[i].requires_grad_()
            kws = {k: torch.from_numpy(v).to(device)
                   for k, v in kw_in.items()}
            t0 = time.perf_counter()
            out = getattr(L, name)(**kw)(*ins, **kws)
            out.sum().backward()
            if device != torch.device("cpu"):
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            outs.append(([out.detach().cpu()] + [ins[i].grad.cpu()
                                                  for i in diff], ms))
        rtol = SURFACE_CTC_RTOL if name == "CTCLoss" else SURFACE_LOSS_RTOL
        errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(outs[0][0], outs[1][0])]
        finite = all(bool(torch.isfinite(a).all()) for a in outs[0][0])
        rows.append({"loss": name, "shapes": [list(a.shape) for a in inputs],
                     "rel_err_value_then_grads": errs, "rtol": rtol,
                     "card_ms_wall": outs[0][1],
                     "ok": finite and max(errs) <= rtol})
    print(smi, flush=True)
    report = {"losses": rows, "card": smi,
              "ok": len(rows) == 14 and all(r["ok"] for r in rows)}
    emit({"surface_losses": report})
    if not report["ok"]:
        raise SystemExit(f"phase 15d failed: "
                         f"{[r for r in rows if not r['ok']]}")
    return report


def surface_phase(torch, np, K, dev, smi, profile=False):
    """Phase 15, training's surface: (a) BERT-base with LAMB, (b)
    ResNet-50 with gluon-cv's recipe (under ``cudnn.deterministic``, as
    phase 14's training), (c) the sweep of every optimizer, (d) the
    losses. Returns (a)'s and (b)'s launches."""
    torch.cuda.empty_cache()
    bert = surface_bert(torch, np, K, dev, smi, profile)
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        resnet = surface_resnet(torch, np, K, dev, smi, profile)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    surface_sweep(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    surface_losses(torch, np, dev, smi)
    torch.cuda.empty_cache()
    return {"bert_base_lamb": {n: c for n, c in bert.items() if c},
            "resnet50_nag": {n: c for n, c in resnet.items() if c}}


#: phase 16: the recurrent cells, the contrib cells and layers, the
#: Estimator. (a) phase 8's word LM (LM_* widths, batch, steps and lr)
#: built from two ``LSTMCell``s unrolled over the merged NTC batch; (b)
#: the step loop at those widths: Zoneout(LSTM 650) 0.1 / 0.1, Dropout
#: 0.5 (Zaremba et al. 2014's medium LM), Residual(LSTM 650), 35 steps
#: at batch 64; (c) ConvLSTM at Shi et al. 2015's Moving-MNIST widths
#: (arXiv:1506.04214 §4.1: 64 x 64 frames as 4 x 4 patches, three
#: Conv2DLSTMCells of 128, 64 and 64 channels, 5 x 5 kernels, ten input
#: frames, RMSProp at lr 1e-3 and decay 0.9, batch 16), cut to one
#: predicted frame and moving squares for digits; (d) ``Estimator.fit``
#: on (c)'s model with a checkpoint resume; (e) the layers at realistic
#: sizes
CELLS_LSTMP = 256
CELLS_ZONEOUT, CELLS_DROPOUT = 0.1, 0.5
CONV_BATCH, CONV_FRAMES, CONV_SIZE, CONV_PATCH = 16, 10, 64, 4
CONV_HIDDEN, CONV_KERNEL, CONV_STEPS = (128, 64, 64), 5, 10
CONV_SQUARE = 12
#: the ConvLSTM's gradient check runs at this batch (a float64-summed CPU
#: copy of ten frames of three cells)
CONV_GRAD_BATCH = 2
RMSPROP = {"learning_rate": 1e-3, "rho": 0.9, "momentum": 0.0}
#: (d): epochs of ESTIMATOR_BATCHES batches, then one resumed epoch
ESTIMATOR_EPOCHS, ESTIMATOR_BATCHES = 2, 4
CELLS_CKPT_DIR = os.path.join("build", "chip_cells_ckpt")
#: (a): the cell LM's first loss and gradients against phase 8's layer
#: model on the same batch: bit for bit, or within this relative error
CELLS_VS_LAYER_RTOL = 1e-6
#: (e): the layers' shapes
GN_SHAPE, GN_GROUPS = (32, 256, 56, 56), 32
IN_SHAPE = (4, 64, 256, 256)
PS_SHAPE, PS_FACTOR = (1, 9, 224, 224), 3
ACT_SHAPE = (4096, 3072)
CONCAT_ROWS, CONCAT_UNITS = 4096, 768


def cell_lm(torch, dev):
    """Phase 8's word LM built from cells: Embedding, ``l0`` and ``l1``
    (LSTMCells, each unrolled over the merged NTC batch), a Dense head."""
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon import rnn
    vocab, embed, hidden = LM_VOCAB, LM_EMBED, LM_HIDDEN

    class CellLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = gnn.Embedding(vocab, embed, device=dev)
            self.l0 = rnn.LSTMCell(hidden, input_size=embed, device=dev)
            self.l1 = rnn.LSTMCell(hidden, input_size=hidden, device=dev)
            self.head = gnn.Dense(vocab, flatten=False, in_units=hidden,
                                  device=dev)

        def forward(self, tokens):
            h = self.emb(tokens)
            h, _ = self.l0.unroll(h.shape[1], h, layout="NTC",
                                  merge_outputs=True)
            h, _ = self.l1.unroll(h.shape[1], h, layout="NTC",
                                  merge_outputs=True)
            return self.head(h)

    return CellLM()


def cell_lm_params(layer_init):
    """``WordLM``'s parameter dict under the cell LM's names: layer k's
    ``lstm.l{k}_<name>`` is cell ``l{k}``'s ``<name>``."""
    out = {}
    for k, v in layer_init.items():
        if k.startswith("lstm.l"):
            layer, name = k[len("lstm.l"):].split("_", 1)
            k = f"l{layer}.{name}"
        out[k] = v
    return out


def loss_and_grads(torch, net, loss_fn, x, y):
    """The mean loss and every parameter's gradient (on the CPU) of one
    backward at (x, y) (numpy) in eval mode."""
    net.eval()
    dev = next(net.parameters()).device
    for p in net.parameters():
        p.grad = None
    loss = loss_fn(net(torch.from_numpy(x).to(dev)),
                   torch.from_numpy(y).to(dev))
    loss.sum().backward()
    return loss.detach().cpu(), {n: p.grad.detach().cpu()
                                 for n, p in net.named_parameters()}


def unroll_check(torch, K, cell, cpu_cell, x, what, smi, **kw):
    """One eval unroll of ``cell`` over ``x`` (merged) on the card and of
    its CPU copy: the launches (from 0), ms (one more eager call timed by
    events) and outputs and states against the CPU copy (TOLS)."""
    cell.eval()
    cpu_cell.eval()
    with torch.no_grad():
        K.reset_launch_counts()
        y, st = cell.unroll(x.shape[1], x, merge_outputs=True, **kw)
        torch.cuda.synchronize()
        counts = {n: c for n, c in K.launch_counts().items() if c}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cell.unroll(x.shape[1], x, merge_outputs=True, **kw)
        end.record()
        torch.cuda.synchronize()
        cpu_kw = {k: v.cpu() for k, v in kw.items()}
        ry, rst = cpu_cell.unroll(x.shape[1], x.cpu(), merge_outputs=True,
                                  **cpu_kw)
    checks = [compare(torch, a.cpu(), b, *TOLS["float32"])
              for a, b in zip([y] + list(st), [ry] + list(rst))]
    rec = {"what": what, "shape": list(x.shape), "launches": counts,
           "ms": start.elapsed_time(end),
           "max_abs_err": max(c[1] for c in checks),
           "tol": TOLS["float32"], "card": smi,
           "ok": all(c[0] for c in checks)}
    return rec


def cells_lm(torch, np, K, dev, smi):
    """Phase 16a: phase 8's word LM built from LSTMCells. Its first loss
    and one step's 11 gradients against phase 8's layer model on the same
    batch and weights (bit for bit, or within CELLS_VS_LAYER_RTOL); ten
    SGD-momentum steps through ``compile_step`` in turns against the
    eager loop (the replays bit-equal to the body runs), exactly
    LM_LAYERS ``rnn_scan_fwd`` + LM_LAYERS ``rnn_scan_bwd`` + one
    ``opt_update`` a step, a falling loss, the gradients at batch 4
    against a CPU copy; the layer model's captured step in the same
    call; then GRUCell and RNNCell (tanh, relu) unrolls at 650 in eval
    mode, one ``rnn_scan_fwd`` each, against CPU copies. Returns the
    launches of the ten gated steps."""
    from mxnet_tpu_torch.gluon import Trainer, rnn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import WordLM
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params

    layer_net = WordLM(LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS, device=dev)
    init = init_params_numpy(layer_net, seed=6)
    load_jax_params(layer_net, init)
    cinit = cell_lm_params(init)
    rs = np.random.RandomState(7)
    x = rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT)).astype(np.int64)
    y = rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT)).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    net = cell_lm(torch, dev)
    load_jax_params(net, cinit)
    l_loss, l_grads = loss_and_grads(torch, layer_net, loss_fn, x, y)
    c_loss, c_grads = loss_and_grads(torch, net, loss_fn, x, y)
    names = {n: cell_lm_params({n: None}).popitem()[0] for n in l_grads}
    vs_layer = {"loss_bit_equal": bool(torch.equal(c_loss, l_loss)),
                "loss_rel_err": rel_errs(torch, c_loss, l_loss.double())[0],
                "grads": len(c_grads),
                "grads_bit_equal": sum(bool(torch.equal(c_grads[names[n]], g))
                                       for n, g in l_grads.items()),
                "grad_max_rel_err": max(
                    rel_errs(torch, c_grads[names[n]], g.double())[0]
                    for n, g in l_grads.items()),
                "rtol": CELLS_VS_LAYER_RTOL}
    vs_layer["ok"] = len(c_grads) == len(l_grads) == 3 + 4 * LM_LAYERS \
        and vs_layer["loss_rel_err"] <= CELLS_VS_LAYER_RTOL \
        and vs_layer["grad_max_rel_err"] <= CELLS_VS_LAYER_RTOL
    made = [net]
    del net

    def build():
        net = made.pop() if made else cell_lm(torch, dev)
        load_jax_params(net, cinit)
        net.train()
        return net, Trainer(dict(net.named_parameters()), "sgd",
                            {"learning_rate": LM_LR, "momentum": 0.9}), \
            loss_fn

    tokens = LM_BATCH * LM_BPTT
    turns, (net, _, _), gated = train_turns(
        torch, K, build, xt, yt, LM_STEPS, tokens, exact=True)
    losses, step_ms, per_step, counts = gated
    expect = {n: 0 for n in K.KERNELS}
    expect.update(rnn_scan_fwd=LM_LAYERS, rnn_scan_bwd=LM_LAYERS,
                  opt_update=1)
    launches_ok = all(s == expect for s in per_step)
    losses_ok = all(math.isfinite(v) for v in losses) and \
        losses[-1] < losses[0]
    cpu_net = copy_to_cpu(lambda: cell_lm(torch, "cpu"), net,
                          load_jax_params)
    grads = grad_check(torch, net, cpu_net, loss_fn, x[:LM_GRAD_BATCH],
                       y[:LM_GRAD_BATCH])
    del cpu_net
    # phase 8's layer model, captured, in the same call
    load_jax_params(layer_net, init)
    layer_net.train()
    tr = Trainer(dict(layer_net.named_parameters()), "sgd",
                 {"learning_rate": LM_LR, "momentum": 0.9})
    lstep = tr.compile_step(lambda a, b: loss_fn(layer_net(a), b))
    lstep.aot_compile(xt, yt)
    layer_run = run_train_steps(torch, K, lstep, xt, yt, LM_STEPS)
    layer_ms = statistics.median(layer_run[1][1:])
    del lstep, tr, layer_net
    report = {
        "model": "word LM of LSTMCells (phase 8's widths)",
        "vocab": LM_VOCAB, "hidden": LM_HIDDEN, "cells": LM_LAYERS,
        "batch": LM_BATCH, "bptt": LM_BPTT, "steps": LM_STEPS,
        "vs_layer_model": vs_layer, "losses": losses, "step_ms": step_ms,
        "median_step_ms": statistics.median(step_ms[1:]),
        "layer_model_median_step_ms": layer_ms,
        "layer_model_losses": layer_run[0],
        "tokens_per_s": tokens / (statistics.median(step_ms[1:]) / 1e3),
        "launches": counts, "launches_per_step": per_step[-1],
        "launches_per_step_expected": expect, "grad_check": grads,
        "captured_vs_eager": turns, "card": smi,
        "ok": vs_layer["ok"] and launches_ok and losses_ok and grads["ok"]
        and turns["ok"]}
    emit({"cells_lm": report})
    if not report["ok"]:
        raise SystemExit(f"phase 16a failed: {report}")
    del net

    # GRU and Elman cells at the LM's width, eval mode
    rows = []
    xs = torch.from_numpy(np.random.RandomState(8).randn(
        LM_BATCH, LM_BPTT, LM_HIDDEN).astype(np.float32)).to(dev)
    for what, make in (
            ("GRUCell", lambda d: rnn.GRUCell(LM_HIDDEN, input_size=LM_HIDDEN,
                                              device=d)),
            ("RNNCell(tanh)", lambda d: rnn.RNNCell(
                LM_HIDDEN, activation="tanh", input_size=LM_HIDDEN,
                device=d)),
            ("RNNCell(relu)", lambda d: rnn.RNNCell(
                LM_HIDDEN, activation="relu", input_size=LM_HIDDEN,
                device=d))):
        cell = make(dev)
        load_jax_params(cell, init_params_numpy(cell, seed=9))
        rec = unroll_check(torch, K, cell, copy_to_cpu(
            lambda: make("cpu"), cell, load_jax_params), xs, what, smi)
        rec["ok"] = rec["ok"] and rec["launches"] == {"rnn_scan_fwd": 1}
        rows.append(rec)
    emit({"cells_unrolls": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit(f"phase 16a's unrolls failed: {rows}")
    return counts


def loop_lm(torch, dev, seed):
    """Phase 16b's model: the embedding and head of phase 8, between
    them Zoneout(LSTMCell) -> DropoutCell -> Residual(LSTMCell) in a
    HybridSequentialRNNCell stepped by the loop (masks from CUDA
    generators seeded with ``seed``); the forward resets the cells
    first, as the captured rule asks."""
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon import rnn

    def gen(k):
        if torch.device(dev).type != "cuda":
            return torch.Generator().manual_seed(seed + k)
        return torch.Generator(dev).manual_seed(seed + k)

    class LoopLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = gnn.Embedding(LM_VOCAB, LM_EMBED, device=dev)
            self.cells = rnn.HybridSequentialRNNCell()
            self.cells.add(rnn.ZoneoutCell(
                rnn.LSTMCell(LM_HIDDEN, input_size=LM_EMBED, device=dev),
                CELLS_ZONEOUT, CELLS_ZONEOUT, generator=gen(0)))
            self.cells.add(rnn.DropoutCell(CELLS_DROPOUT, generator=gen(1)))
            self.cells.add(rnn.ResidualCell(
                rnn.LSTMCell(LM_HIDDEN, input_size=LM_HIDDEN, device=dev)))
            self.head = gnn.Dense(LM_VOCAB, flatten=False,
                                  in_units=LM_HIDDEN, device=dev)

        def forward(self, tokens):
            self.cells.reset()
            h, _ = self.cells.unroll(tokens.shape[1], self.emb(tokens),
                                     layout="NTC", merge_outputs=True)
            return self.head(h)

    return LoopLM()


def cells_loop(torch, np, K, dev, smi):
    """Phase 16b: the step loop at the LM's widths (``loop_lm``): ten
    SGD-momentum steps eagerly and through ``compile_step`` in turns (one
    graph of 2 x LM_BPTT cell steps, masks drawn anew each replay, the
    replays bit-equal to the body runs), zero ``rnn_scan`` launches and
    one ``opt_update`` a step; the trained net in eval mode against a CPU
    copy; then BidirectionalCell(LSTMCell, LSTMCell) over ragged lengths
    (LM_BPTT down to 1) and LSTMPCell(LM_HIDDEN, CELLS_LSTMP) against CPU
    copies."""
    from mxnet_tpu_torch.gluon import Trainer, rnn
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params

    rs = np.random.RandomState(7)
    x = rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT)).astype(np.int64)
    y = rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT)).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    net = loop_lm(torch, dev, 10)
    init = init_params_numpy(net, seed=10)
    made = [net]
    del net

    def build():
        net = made.pop() if made else loop_lm(torch, dev, 10)
        load_jax_params(net, init)
        net.train()
        return net, Trainer(dict(net.named_parameters()), "sgd",
                            {"learning_rate": LM_LR, "momentum": 0.9}), \
            loss_fn

    tokens = LM_BATCH * LM_BPTT
    turns, (net, _, _), gated = train_turns(
        torch, K, build, xt, yt, LM_STEPS, tokens, exact=True)
    losses, step_ms, per_step, counts = gated
    expect = {n: 0 for n in K.KERNELS}
    expect.update(opt_update=1)
    launches_ok = all(s == expect for s in per_step)
    net.eval()
    cpu_net = copy_to_cpu(lambda: loop_lm(torch, "cpu", 10), net,
                          load_jax_params)
    cpu_net.eval()
    with torch.no_grad():
        got = net(xt[:LM_GRAD_BATCH]).cpu()
        ref = cpu_net(torch.from_numpy(x[:LM_GRAD_BATCH]))
    eval_err = float((got - ref).abs().max())
    del cpu_net
    report = {
        "model": "Zoneout(LSTMCell) -> DropoutCell -> Residual(LSTMCell), "
                 "the step loop", "hidden": LM_HIDDEN,
        "zoneout": CELLS_ZONEOUT, "dropout": CELLS_DROPOUT,
        "batch": LM_BATCH, "bptt": LM_BPTT, "steps": LM_STEPS,
        "cell_steps_a_graph": 2 * LM_BPTT, "losses": losses,
        "step_ms": step_ms, "median_step_ms": statistics.median(step_ms[1:]),
        "tokens_per_s": tokens / (statistics.median(step_ms[1:]) / 1e3),
        "launches": counts, "launches_per_step": per_step[-1],
        "eval_vs_cpu_max_abs_err": eval_err, "atol": LOGIT_ATOL,
        "captured_vs_eager": turns, "card": smi,
        "ok": launches_ok and turns["ok"] and eval_err <= LOGIT_ATOL
        and all(math.isfinite(v) for v in losses)}
    emit({"cells_loop": report})
    if not report["ok"]:
        raise SystemExit(f"phase 16b failed: {report}")
    del net

    rows = []
    n = LM_BPTT
    xb = torch.from_numpy(np.random.RandomState(11).randn(
        n, LM_BPTT, LM_HIDDEN).astype(np.float32)).to(dev)
    vl = torch.arange(LM_BPTT, LM_BPTT - n, -1, device=dev)

    def bidi(d):
        return rnn.BidirectionalCell(
            rnn.LSTMCell(LM_HIDDEN, input_size=LM_HIDDEN, device=d),
            rnn.LSTMCell(LM_HIDDEN, input_size=LM_HIDDEN, device=d))

    def lstmp(d):
        return crnn.LSTMPCell(LM_HIDDEN, CELLS_LSTMP, input_size=LM_HIDDEN,
                              device=d)

    for what, make, inp, kw in (
            ("BidirectionalCell(LSTMCell, LSTMCell), valid_length "
             f"{LM_BPTT}..{LM_BPTT - n + 1}", bidi, xb, {"valid_length": vl}),
            (f"LSTMPCell({LM_HIDDEN}, {CELLS_LSTMP})", lstmp,
             torch.from_numpy(np.random.RandomState(12).randn(
                 LM_BATCH, LM_BPTT, LM_HIDDEN).astype(np.float32)).to(dev),
             {})):
        cell = make(dev)
        load_jax_params(cell, init_params_numpy(cell, seed=13))
        rec = unroll_check(torch, K, cell, copy_to_cpu(
            lambda: make("cpu"), cell, load_jax_params), inp, what, smi,
            **kw)
        rec["ok"] = rec["ok"] and not rec["launches"]
        rows.append(rec)
    emit({"cells_loop_unrolls": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit(f"phase 16b's unrolls failed: {rows}")
    return counts


def moving_squares(np, rs, batch):
    """Clips of CONV_FRAMES + 1 frames of a bright square moving at a
    constant velocity, bouncing off the edges
    (``examples/convlstm_video.py``'s data at Moving MNIST's frame size),
    as (batch, frames, CONV_PATCH**2, CONV_SIZE / CONV_PATCH, CONV_SIZE /
    CONV_PATCH) patch stacks (Shi et al. 2015 §4.1)."""
    frames, size, square, patch = CONV_FRAMES + 1, CONV_SIZE, CONV_SQUARE, \
        CONV_PATCH
    clips = np.zeros((batch, frames, size, size), np.float32)
    span = size - square
    for b in range(batch):
        pos = rs.randint(0, span, 2)
        vel = rs.choice([-3, -2, 2, 3], 2)
        for t in range(frames):
            yy, xx = pos
            clips[b, t, yy:yy + square, xx:xx + square] = 1.0
            pos = pos + vel
            for k in range(2):
                if pos[k] < 0 or pos[k] > span:
                    vel[k] = -vel[k]
                    pos[k] = min(max(pos[k], 0), span)
    g = size // patch
    return clips.reshape(batch, frames, g, patch, g, patch) \
        .transpose(0, 1, 3, 5, 2, 4).reshape(batch, frames, patch * patch,
                                             g, g)


def conv_lstm(torch, dev):
    """Phase 16c's model: three Conv2DLSTMCells (CONV_HIDDEN channels,
    CONV_KERNEL kernels, SAME padding) in a HybridSequentialRNNCell over
    the patch stacks, a 1 x 1 Conv2D head to the next frame's patches
    (``examples/convlstm_video.py``'s NextFrame at Shi et al.'s
    widths)."""
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon import rnn
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn
    g, c = CONV_SIZE // CONV_PATCH, CONV_PATCH ** 2

    class NextFrame(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cells = rnn.HybridSequentialRNNCell()
            cin = c
            for h in CONV_HIDDEN:
                self.cells.add(crnn.Conv2DLSTMCell(
                    (cin, g, g), h, CONV_KERNEL, CONV_KERNEL,
                    i2h_pad=CONV_KERNEL // 2, device=dev))
                cin = h
            self.head = gnn.Conv2D(c, 1, in_channels=cin, device=dev)

        def forward(self, clip):
            outs, _ = self.cells.unroll(clip.shape[1], clip, layout="NTC")
            return self.head(outs[-1])

    return NextFrame()


def conv_lstm_init(torch, net):
    """Xavier (magnitude 2.5, as ``examples/convlstm_video.py``) from a
    seeded generator, as a numpy dict under the net's names."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon import initialize
    initialize(net, initializer.Xavier(magnitude=2.5), force_reinit=True,
               generator=torch.Generator().manual_seed(14))
    return {n: p.detach().cpu().numpy().copy()
            for n, p in net.named_parameters()}


def cells_conv(torch, np, K, dev, smi):
    """Phase 16c: the ConvLSTM (``conv_lstm``) trained with RMSProp
    through ``compile_step`` in turns against the eager loop
    (CONV_STEPS steps on one batch, under ``cudnn.deterministic``: the
    replays bit-equal to the body runs), a falling loss, one step's
    gradients at CONV_GRAD_BATCH against a CPU copy, the step's ms and
    frames/s; then Conv1DGRUCell and Conv3DRNNCell steps against CPU
    copies. Returns (the init dict, the batch) for (d)."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn
    from mxnet_tpu_torch.gluon.loss import SigmoidBinaryCrossEntropyLoss
    from mxnet_tpu_torch.gluon.params import load_jax_params

    clips = moving_squares(np, np.random.RandomState(15), CONV_BATCH)
    x, y = clips[:, :CONV_FRAMES], clips[:, CONV_FRAMES]
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    loss_fn = SigmoidBinaryCrossEntropyLoss()
    net = conv_lstm(torch, dev)
    init = conv_lstm_init(torch, net)
    made = [net]
    del net

    def build():
        net = made.pop() if made else conv_lstm(torch, dev)
        load_jax_params(net, init)
        net.train()
        return net, Trainer(dict(net.named_parameters()), "rmsprop",
                            dict(RMSPROP)), loss_fn

    frames = CONV_BATCH * CONV_FRAMES
    turns, (net, _, _), gated = train_turns(
        torch, K, build, xt, yt, CONV_STEPS, frames, exact=True,
        unit="frames")
    losses, step_ms, per_step, counts = gated
    losses_ok = all(math.isfinite(v) for v in losses) and \
        losses[-1] < losses[0]
    launches_ok = all(not any(s.values()) for s in per_step)
    cpu_net = copy_to_cpu(lambda: conv_lstm(torch, "cpu"), net,
                          load_jax_params)
    t0 = time.perf_counter()
    grads = grad_check(torch, net, cpu_net, loss_fn, x[:CONV_GRAD_BATCH],
                       y[:CONV_GRAD_BATCH])
    grad_s = time.perf_counter() - t0
    del cpu_net, net
    med = statistics.median(step_ms[1:])
    report = {
        "model": "ConvLSTM (3 x Conv2DLSTMCell) + 1x1 Conv2D head",
        "source": "Shi et al. 2015, arXiv:1506.04214 §4.1",
        "hidden": list(CONV_HIDDEN), "kernel": CONV_KERNEL,
        "input": [CONV_PATCH ** 2, CONV_SIZE // CONV_PATCH,
                  CONV_SIZE // CONV_PATCH],
        "frames_in": CONV_FRAMES, "batch": CONV_BATCH,
        "reduced": ["one predicted frame (the paper: ten)",
                    "moving squares, not Moving MNIST digits"],
        "optimizer": dict(RMSPROP, name="rmsprop"), "steps": CONV_STEPS,
        "losses": losses, "step_ms": step_ms, "median_step_ms": med,
        "frames_per_s": frames / (med / 1e3), "launches": counts,
        "grad_check": dict(grads, batch=CONV_GRAD_BATCH, seconds=grad_s),
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "captured_vs_eager": turns, "card": smi,
        "ok": losses_ok and launches_ok and grads["ok"] and turns["ok"]}
    emit({"cells_convlstm": report})
    if not report["ok"]:
        raise SystemExit(f"phase 16c failed: {report}")

    rows = []
    for what, make, shape in (
            ("Conv1DGRUCell", lambda d: crnn.Conv1DGRUCell(
                (16, 64), 32, 3, 3, i2h_pad=1, device=d), (16, 16, 64)),
            ("Conv3DRNNCell", lambda d: crnn.Conv3DRNNCell(
                (8, 8, 16, 16), 16, 3, 3, i2h_pad=1, device=d),
             (4, 8, 8, 16, 16))):
        cell = make(dev)
        cpu = copy_to_cpu(lambda: make("cpu"), cell, load_jax_params)
        rs = np.random.RandomState(16)
        xs = torch.from_numpy(rs.randn(*shape).astype(np.float32))
        st = [torch.from_numpy(rs.randn(*i["shape"]).astype(np.float32))
              for i in cell.state_info(shape[0])]
        with torch.no_grad():
            out, nst = cell(xs.to(dev), [s.to(dev) for s in st])
            torch.cuda.synchronize()
            ref, rst = cpu(xs, st)
        checks = [compare(torch, a.cpu(), b, *TOLS["float32"])
                  for a, b in zip([out] + nst, [ref] + rst)]
        rows.append({"what": what, "input": list(shape),
                     "max_abs_err": max(c[1] for c in checks),
                     "tol": TOLS["float32"], "card": smi,
                     "ok": all(c[0] for c in checks)})
    emit({"cells_conv_steps": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit(f"phase 16c's conv cell steps failed: {rows}")
    return init


def cells_estimator(torch, np, dev, smi, init):
    """Phase 16d: ``Estimator.fit`` on (c)'s ConvLSTM (RMSProp) over
    ESTIMATOR_EPOCHS epochs of ESTIMATOR_BATCHES batches with
    ``CheckpointHandler(save_trainer_states=True)``,
    ``ValidationHandler`` and ``EarlyStoppingHandler``; then a new net,
    trainer and Estimator with ``resume_from_checkpoint=True`` for one
    more epoch, held bit for bit against an uninterrupted run of
    ESTIMATOR_EPOCHS + 1 epochs. The checkpoint directory is removed at
    the end."""
    import shutil
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.contrib import estimator as E
    from mxnet_tpu_torch.gluon.loss import SigmoidBinaryCrossEntropyLoss
    from mxnet_tpu_torch.gluon.params import load_jax_params

    rs = np.random.RandomState(17)

    def batches(n):
        out = []
        for _ in range(n):
            c = moving_squares(np, rs, CONV_BATCH)
            out.append((torch.from_numpy(c[:, :CONV_FRAMES]).to(dev),
                        torch.from_numpy(c[:, CONV_FRAMES]).to(dev)))
        return out

    train, val = batches(ESTIMATOR_BATCHES), batches(1)
    shutil.rmtree(CELLS_CKPT_DIR, ignore_errors=True)

    def estimator():
        net = conv_lstm(torch, dev)
        load_jax_params(net, init)
        tr = Trainer(dict(net.named_parameters()), "rmsprop", dict(RMSPROP))
        return net, E.Estimator(net, SigmoidBinaryCrossEntropyLoss(),
                                train_metrics=[], trainer=tr)

    def fit(est, epochs, ckpt):
        val_loss = metric.Loss("val_loss")
        stop = E.EarlyStoppingHandler(val_loss, patience=ESTIMATOR_EPOCHS + 1)
        handlers = [E.ValidationHandler(
            val, lambda v: est.evaluate(v, [val_loss])), stop]
        if ckpt is not None:
            handlers.append(ckpt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.fit(train, epochs=epochs, event_handlers=handlers)
        torch.cuda.synchronize()
        return {"epochs": epochs, "s": time.perf_counter() - t0,
                "train_loss": est.train_loss_metric.get()[1],
                "val_loss": val_loss.get()[1],
                "stopped_early": stop.stop_training}

    try:
        _, est = estimator()
        first = fit(est, ESTIMATOR_EPOCHS, E.CheckpointHandler(
            CELLS_CKPT_DIR, save_trainer_states=True))
        resumed_net, est = estimator()
        ck = E.CheckpointHandler(CELLS_CKPT_DIR, save_trainer_states=True,
                                 resume_from_checkpoint=True)
        resumed = fit(est, 1, ck)
        whole_net, est = estimator()
        whole = fit(est, ESTIMATOR_EPOCHS + 1, None)
        files = sorted(os.listdir(CELLS_CKPT_DIR))
    finally:
        shutil.rmtree(CELLS_CKPT_DIR, ignore_errors=True)
    equal = all(bool(torch.equal(a, b)) for a, b in
                zip(resumed_net.parameters(), whole_net.parameters()))
    report = {"model": "phase 16c's ConvLSTM", "batches": ESTIMATOR_BATCHES,
              "batch": CONV_BATCH, "first": first, "resumed": resumed,
              "uninterrupted": whole, "resumed_epoch": ck.current_epoch,
              "files": files, "resumed_bit_equal": equal, "card": smi,
              "ok": equal and ck.current_epoch == ESTIMATOR_EPOCHS + 1
              and not whole["stopped_early"]}
    emit({"cells_estimator": report})
    if not report["ok"]:
        raise SystemExit(f"phase 16d failed: {report}")


def layer_case(torch, what, make, shapes, dev, smi, backward=False,
               seed=18):
    """One layer at a realistic size on the card against its CPU copy:
    the forward within TOLS float32 of each element, and with
    ``backward`` the gradients of the input and the parameters of a
    weighted sum within GRAD_ATOL + GRAD_RTOL x the tensor's largest
    (phase 6's gradient bound: a gradient summed over thousands of rows,
    a Dense weight's or a norm's gamma, carries float32 rounding of the
    whole sum in its small elements); the forward's device ms by graph
    replay."""
    from mxnet_tpu_torch.gluon.params import load_jax_params
    layer = make(dev)
    if list(layer.parameters()):
        g = torch.Generator().manual_seed(seed)
        load_jax_params(layer, {n: (torch.randn(p.shape, generator=g)
                                    * 0.5 + 1.0).numpy()
                                for n, p in layer.named_parameters()})
    cpu = make("cpu")
    if list(layer.parameters()):
        load_jax_params(cpu, {n: p.detach().cpu().numpy()
                              for n, p in layer.named_parameters()})
    g = torch.Generator().manual_seed(seed + 1)
    xs = [torch.randn(s, generator=g) * 2 + 0.5 for s in shapes]
    outs = []
    for m, d in ((layer, dev), (cpu, torch.device("cpu"))):
        xd = [t.to(d).requires_grad_(backward) for t in xs]
        y = m(*xd)
        rec = [y.detach()]
        if backward:
            dy = torch.randn(y.shape, generator=torch.Generator()
                             .manual_seed(seed + 2)).to(d)
            (y * dy).sum().backward()
            rec += [t.grad for t in xd] + [p.grad for p in m.parameters()
                                           if p.grad is not None]
        outs.append(rec)
    fwd = compare(torch, outs[0][0].cpu(), outs[1][0], *TOLS["float32"])
    grad_ratio = 0.0
    for a, b in zip(outs[0][1:], outs[1][1:]):
        err = float((a.cpu().double() - b.double()).abs().max())
        grad_ratio = max(grad_ratio, err / (GRAD_ATOL + GRAD_RTOL
                                            * float(b.abs().max())))
    with torch.no_grad():
        xd = [t.to(dev) for t in xs]
        ms, eager_ms = time_ms(torch, layer, [xd], iters=10)
    return {"what": what, "shapes": [list(s) for s in shapes],
            "fwd_ms": ms, "fwd_eager_ms": eager_ms, "fwd_max_abs_err": fwd[1],
            "fwd_tol": TOLS["float32"], "grads": len(outs[0]) - 1,
            "grad_err_over_bound": grad_ratio,
            "grad_bound": [GRAD_ATOL, GRAD_RTOL], "card": smi,
            "ok": fwd[0] and grad_ratio <= 1.0}


def cells_layers(torch, dev, smi):
    """Phase 16e: GroupNorm(32) at Wu & He 2018's ResNet-50 setting,
    InstanceNorm, ESPCN's PixelShuffle2D(3), the activation layers and a
    HybridConcatenate of two Dense(768), each against a CPU copy."""
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.contrib import nn as cnn

    def concat(d):
        c = gnn.HybridConcatenate()
        c.add(gnn.Dense(CONCAT_UNITS, in_units=CONCAT_UNITS, device=d),
              gnn.Dense(CONCAT_UNITS, in_units=CONCAT_UNITS, device=d))
        return c

    cases = [
        (f"GroupNorm({GN_GROUPS})", lambda d: gnn.GroupNorm(
            GN_GROUPS, in_channels=GN_SHAPE[1], device=d), [GN_SHAPE], True),
        ("InstanceNorm", lambda d: gnn.InstanceNorm(
            in_channels=IN_SHAPE[1], device=d), [IN_SHAPE], True),
        (f"PixelShuffle2D({PS_FACTOR})",
         lambda d: cnn.PixelShuffle2D(PS_FACTOR), [PS_SHAPE], False),
        ("PReLU", lambda d: gnn.PReLU(device=d), [ACT_SHAPE], True),
        ("ELU", lambda d: gnn.ELU(), [ACT_SHAPE], True),
        ("SELU", lambda d: gnn.SELU(), [ACT_SHAPE], True),
        ("GELU(erf)", lambda d: gnn.GELU(), [ACT_SHAPE], True),
        ("GELU(tanh)", lambda d: gnn.GELU("tanh"), [ACT_SHAPE], True),
        ("Swish", lambda d: gnn.Swish(), [ACT_SHAPE], True),
        ("LeakyReLU", lambda d: gnn.LeakyReLU(0.1), [ACT_SHAPE], True),
        (f"HybridConcatenate(Dense({CONCAT_UNITS}) x 2)", concat,
         [(CONCAT_ROWS, CONCAT_UNITS)], True),
    ]
    rows = []
    for what, make, shapes, backward in cases:
        rows.append(layer_case(torch, what, make, shapes, dev, smi,
                               backward))
        torch.cuda.empty_cache()
    emit({"cells_layers": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit(f"phase 16e failed: "
                         f"{[r for r in rows if not r['ok']]}")


def cells_phase(torch, np, K, dev, smi):
    """Phase 16: (a) the cell-built LM, (b) the step loop, (c) ConvLSTM
    and (d) the Estimator (both under ``cudnn.deterministic``, restored
    after), (e) the layers. Returns (a)'s launches, counted from 0 just
    before its gated steps."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    lm = cells_lm(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    cells_loop(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        init = cells_conv(torch, np, K, dev, smi)
        torch.cuda.empty_cache()
        cells_estimator(torch, np, dev, smi, init)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    cells_layers(torch, dev, smi)
    torch.cuda.empty_cache()
    emit({"cells_phase_s": time.perf_counter() - t0, "card": smi})
    return lm


#: phase 17: BERT-base served through the supervisor and the fleet.
#: Phase 4's widths and traffic (8 clients, 96 requests of 1-8 rows at
#: sequence 128), its rows drawn from a pool of FLEET_POOL token rows so
#: a CPU copy can answer every row of every request; buckets 1-32; the
#: open loop at FLEET_OPEN_FACTOR times the closed loop's req/s with a
#: deadline of FLEET_DEADLINE_FACTOR times the closed loop's p99;
#: FLEET_SEEDS: the served weights, then the swapped-in ones; every wait
#: bounded by FLEET_WAIT_S
FLEET_BUCKETS = (1, 2, 4, 8, 16, 32)
#: the kernels every fleet replica launches on its card (rows 1 and 5)
FLEET_KERNELS = ("flash_fwd", "layernorm_fwd")
FLEET_POOL = 48
FLEET_OPEN_FACTOR = 2.0
FLEET_OPEN_REQUESTS = 2 * SERVE_REQUESTS
FLEET_DEADLINE_FACTOR = 2.0
FLEET_SEEDS = (0, 1)
FLEET_WAIT_S = 120.0
FLEET_CKPT_DIR = os.path.join("build", "chip_fleet_ckpt")
#: phase 17b's victim (its device is revoked at its second dispatch)
FLEET_VICTIM = 1
#: the float32 fused backward of A2: one case at BERT training's head
#: dim, launched on cuda:0 then cuda:1 from this process
FUSED_TWO_CARDS = (2, 12, 256, 256, 64)


def fleet_traffic(np, vocab, seed=0):
    """(pool, requests): FLEET_POOL token rows and SERVE_REQUESTS
    (start, rows) slices of 1-8 consecutive pool rows."""
    rs = np.random.RandomState(seed)
    pool = rs.randint(0, vocab, (FLEET_POOL, SERVE_SEQ)).astype(np.int64)
    reqs = []
    for _ in range(SERVE_REQUESTS):
        n = int(rs.randint(1, 9))
        reqs.append((int(rs.randint(0, FLEET_POOL - n + 1)), n))
    return pool, reqs


def fleet_build(dtype, params):
    """A supervisor's / fleet's ``build()``: BERT-base on the current
    device (the caller's ``Context``) with ``params``, served at
    ``dtype``."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import load_jax_params
    from mxnet_tpu_torch.serving import predictor_for

    def build():
        net = BERTClassifier(bert_base(), num_classes=2)
        load_jax_params(net, params)
        return predictor_for(net, dtype=dtype, bucket_sizes=FLEET_BUCKETS)
    return build


def fleet_cpu_refs(torch, np, params, pool):
    """Every pool row's logits from a float32 CPU copy, in eval mode."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import load_jax_params
    net = BERTClassifier(bert_base(device="cpu"), num_classes=2,
                         device="cpu")
    load_jax_params(net, params)
    net.eval()
    outs = []
    with torch.inference_mode():
        for i in range(0, len(pool), 16):
            outs.append(net(torch.from_numpy(pool[i:i + 16])).numpy())
    return np.concatenate(outs)


def fleet_answer_err(np, out, ref_rows):
    """|logits - the CPU copy's| at most (inf for a bad shape or a
    non-finite value)."""
    out = np.asarray(out, dtype=np.float64)
    if out.shape != ref_rows.shape or not np.isfinite(out).all():
        return math.inf
    return float(np.abs(out - ref_rows).max())


def retrying_submit(submit, args, budget_s=FLEET_WAIT_S, **kw):
    """A client's posture: a typed ``Overloaded`` (breaker open, fleet
    failing over) or ``ServingShutdown`` (arrived during a failover) at
    admission is retryable: back off and resubmit, within a budget."""
    from mxnet_tpu_torch.serving import Overloaded, ServingShutdown
    end = time.perf_counter() + budget_s
    while True:
        try:
            return submit(*args, **kw)
        except (Overloaded, ServingShutdown):
            if time.perf_counter() >= end:
                raise
            time.sleep(0.005)


def serving_launch_gate(counts, batches, what):
    """Rows 1 and 5 on a served BERT-base path: exactly 12 flash_fwd and
    25 layernorm_fwd launches a dispatched micro-batch."""
    if counts["flash_fwd"] != 12 * batches or \
            counts["layernorm_fwd"] != 25 * batches or batches < 1:
        raise SystemExit(f"{what}: launches {counts} do not match 12 "
                         f"flash_fwd and 25 layernorm_fwd a micro-batch "
                         f"({batches} micro-batches)")


def fleet_one_card(torch, np, K, dev, smi, dtype, params, refs, pool,
                   reqs, ckpt):
    """Phase 17a at ``dtype`` on one card: (1) a ServingSupervisor under a
    ``serving.dispatch`` transient fault (retried in place, no accepted
    request lost, rows 1 and 5 at 12 and 25 launches a micro-batch); (2)
    an open loop at FLEET_OPEN_FACTOR x the closed loop's req/s with a
    per-request deadline: every request ok, rejected or deadline_missed,
    no error, no wait past FLEET_WAIT_S; (3) an open breaker fast-fails
    submit; (4) a drain under traffic: every accepted request finishes;
    (5) a one-replica fleet's ``swap_weights`` from ``ckpt`` (seed 1's
    weights, written by TrainCheckpointManager): outputs bit-equal to a
    fresh predictor built on those weights, ``n_traces`` unchanged, and a
    corrupted copy of the checkpoint aborting typed with the swapped
    weights still answering bit for bit. Float32 answers are held
    against the CPU copies (``refs``: {seed: logits of every pool row})
    within LOGIT_ATOL. Returns the supervised run's launches."""
    import shutil
    import threading
    from mxnet_tpu_torch.checkpoint import CheckpointCorruptError
    from mxnet_tpu_torch.context import Context
    from mxnet_tpu_torch.serving import (FleetController, Overloaded,
                                         ServingShutdown, ServingSupervisor,
                                         loadgen)
    from mxnet_tpu_torch.testing import faults
    f32 = dtype == "float32"
    report = {"dtype": dtype, "card": smi}
    ref0 = refs[FLEET_SEEDS[0]]

    def check(i, out):
        s, n = reqs[i]
        return fleet_answer_err(np, out, ref0[s:s + n]) if f32 else (
            0.0 if out.shape == (n, 2) and np.isfinite(out).all()
            else math.inf)

    t0 = time.perf_counter()
    sup = ServingSupervisor(fleet_build(dtype, params[FLEET_SEEDS[0]]),
                            example=(pool[:1],), max_batch=SERVE_MAX_BATCH,
                            timeout_ms=2.0, backoff_base=0.01)
    report["supervisor_setup_s"] = time.perf_counter() - t0
    errs = [math.inf] * SERVE_REQUESTS
    try:
        # (1) the supervised closed loop; the third dispatch fails once
        faults.configure("serving.dispatch:before=3:error")
        K.reset_launch_counts()

        def issue(i):
            s, n = reqs[i]
            out = sup.submit(pool[s:s + n]).result(FLEET_WAIT_S)
            errs[i] = check(i, out.float().cpu().numpy())

        closed = loadgen.run_closed_loop(issue, SERVE_CLIENTS,
                                         SERVE_REQUESTS)
        faults.configure(None)
        counts = K.launch_counts()
        nb = sup.batcher.stats["batches"]
        serving_launch_gate(counts, nb, f"phase 17a supervisor {dtype}")
        report["supervised"] = {
            "req_per_s": closed["requests"] / closed["wall_s"],
            "p50_ms": closed["p50_ms"], "p99_ms": closed["p99_ms"],
            "outcomes": closed["outcomes"], "retried": sup.stats["retried"],
            "recoveries": sup.stats["recoveries"],
            "failed_requeues": sup.stats["failed_requeues"],
            "micro_batches": nb, "launches": {
                k: counts[k] for k in ("flash_fwd", "layernorm_fwd")},
            "max_abs_err_vs_cpu": max(errs) if f32 else None,
            "atol": LOGIT_ATOL if f32 else None}
        if closed["outcomes"]["ok"] != SERVE_REQUESTS or \
                sup.stats["retried"] < 1 or sup.stats["recoveries"] or \
                sup.stats["failed_requeues"] or \
                max(errs) > (LOGIT_ATOL if f32 else 0.0):
            raise SystemExit(f"phase 17a supervisor {dtype}: {report}")
        # (2) the open loop at twice the closed loop's rate, deadlines on
        rate = FLEET_OPEN_FACTOR * closed["requests"] / closed["wall_s"]
        deadline_ms = FLEET_DEADLINE_FACTOR * closed["p99_ms"]

        def submit(i):
            s, n = reqs[i % SERVE_REQUESTS]
            return sup.submit(pool[s:s + n], deadline_ms=deadline_ms).result

        opened = loadgen.run_open_loop(submit, rate, FLEET_OPEN_REQUESTS,
                                       seed=1, timeout=FLEET_WAIT_S,
                                       deadline_s=deadline_ms / 1e3)
        report["open_loop"] = {
            "rate_qps": rate, "deadline_ms": deadline_ms,
            "outcomes": opened["outcomes"], "qps": opened["qps"],
            "goodput_qps": opened["goodput_qps"],
            "reject_rate": opened["reject_rate"],
            "deadline_miss_rate": opened["deadline_miss_rate"],
            "p50_ms": opened["p50_ms"], "p99_ms": opened["p99_ms"],
            "first_error": opened["first_error"],
            "shed_at_admission": sup.batcher.stats["rejected"],
            "dropped_at_dequeue": sup.batcher.stats["deadline_missed"]}
        if opened["errors"] or \
                sum(opened["outcomes"].values()) != FLEET_OPEN_REQUESTS:
            raise SystemExit(f"phase 17a open loop {dtype}: {report}")
        # (3) an open breaker fails submit fast, queueing nothing
        sup.breaker.trip("chip check")
        queued = sup.batcher._queue.qsize()
        try:
            sup.submit(pool[:1])
            breaker = None
        except Overloaded as e:
            breaker = e.reason
        report["open_breaker"] = {"reason": breaker,
                                  "queued_after": sup.batcher._queue.qsize()
                                  - queued}
        sup.breaker.close()
        if breaker != "breaker" or report["open_breaker"]["queued_after"]:
            raise SystemExit(f"phase 17a breaker {dtype}: {report}")
        # (4) a drain under traffic: what was accepted finishes
        accepted, refused, mu = [], [], threading.Lock()
        going = threading.Event()

        def client(c):
            for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                s, n = reqs[i]
                try:
                    fut = sup.submit(pool[s:s + n])
                except (Overloaded, ServingShutdown) as e:
                    with mu:
                        refused.append(type(e).__name__)
                    return
                with mu:
                    accepted.append((i, fut))
                    if len(accepted) >= 2 * SERVE_CLIENTS:
                        going.set()

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        going.wait(FLEET_WAIT_S)
        t1 = time.perf_counter()
        sup.drain()
        drain_s = time.perf_counter() - t1
        for t in threads:
            t.join(FLEET_WAIT_S)
        hung = sum(t.is_alive() for t in threads)
        drained = []
        for i, fut in accepted:
            try:
                drained.append(check(i, fut.result(FLEET_WAIT_S).float()
                                     .cpu().numpy()))
            except Exception as e:     # noqa: BLE001 - the gate reports it
                drained.append(f"{type(e).__name__}: {e}")
        bad = [d for d in drained if not isinstance(d, float) or
               d > (LOGIT_ATOL if f32 else 0.0)]
        report["drain"] = {"accepted": len(accepted),
                           "refused": sorted(set(refused)),
                           "drain_s": drain_s, "lost": len(bad),
                           "hung_clients": hung}
        if bad or hung or not accepted:
            raise SystemExit(f"phase 17a drain {dtype}: {report} {bad[:3]}")
    finally:
        faults.configure(None)
        sup.close()
        del sup
    torch.cuda.empty_cache()
    # (5) a one-replica fleet's rolling swap, and a corrupt checkpoint
    fleet = FleetController(fleet_build(dtype, params[FLEET_SEEDS[0]]),
                            example=(pool[:1],), replicas=1,
                            max_batch=SERVE_MAX_BATCH, timeout_ms=2.0)
    bad_ckpt = os.path.join(FLEET_CKPT_DIR, "corrupt")
    try:
        rep = fleet.replicas[0]
        traces = rep.sup.predictor.n_traces
        x = pool[:8]
        swap = fleet.swap_weights(ckpt)
        out = fleet.router.submit(x).result(FLEET_WAIT_S)
        with Context("gpu" if dev.type == "cuda" else "cpu",
                     dev.index or 0):
            fresh = fleet_build(dtype, params[FLEET_SEEDS[1]])()
        ref = fresh.predict(x)
        fresh_equal = bool(torch.equal(out, ref))
        del fresh, ref
        swap_err = fleet_answer_err(np, out.float().cpu().numpy(),
                                    refs[FLEET_SEEDS[1]][:8]) if f32 else None
        shutil.rmtree(bad_ckpt, ignore_errors=True)
        shutil.copytree(ckpt, bad_ckpt)
        arrays = os.path.join(bad_ckpt, "arrays")
        with open(os.path.join(arrays, sorted(os.listdir(arrays))[0]),
                  "r+b") as f:
            f.seek(-4, os.SEEK_END)
            f.write(b"\xde\xad\xbe\xef")
        try:
            fleet.swap_weights(bad_ckpt)
            aborted = None
        except CheckpointCorruptError as e:
            aborted = type(e).__name__
        again = fleet.router.submit(x).result(FLEET_WAIT_S)
        report["swap"] = {
            "duration_s": swap["duration_s"], "version": fleet.version,
            "bit_equal_to_fresh_predictor": fresh_equal,
            "max_abs_err_vs_cpu": swap_err,
            "n_traces_before": traces,
            "n_traces_after": rep.sup.predictor.n_traces,
            "corrupt_checkpoint": aborted,
            "old_weights_answer_bit_equal": bool(torch.equal(out, again)),
            "version_after_corrupt": fleet.version}
    finally:
        fleet.close()
        shutil.rmtree(bad_ckpt, ignore_errors=True)
    sw = report["swap"]
    if not (sw["bit_equal_to_fresh_predictor"] and sw["version"] == 1
            and sw["n_traces_after"] == sw["n_traces_before"]
            and sw["corrupt_checkpoint"] == "CheckpointCorruptError"
            and sw["old_weights_answer_bit_equal"]
            and sw["version_after_corrupt"] == 1
            and (not f32 or sw["max_abs_err_vs_cpu"] <= LOGIT_ATOL)):
        raise SystemExit(f"phase 17a swap {dtype}: {report}")
    emit({"fleet_one_card": report})
    return counts


def fleet_devices_ok(torch, fleet):
    """Every serving replica's predictor, parameters and captured
    programs' static buffers on its own device (on the CPU's virtual
    devices, on the CPU)."""
    def on(t_dev, dev):
        return t_dev == dev if dev.type == "cuda" else t_dev.type == dev.type

    out = {}
    for r in fleet.replicas:
        if r.state != "serving":
            continue
        pred = r.sup.predictor
        tensors = list(pred.net.parameters())
        for prog in pred._programs._progs.values():
            tensors += list(prog.inputs)
            if prog.outputs is not None:
                tensors += [t for t in (prog.outputs if isinstance(
                    prog.outputs, (tuple, list)) else [prog.outputs])
                    if isinstance(t, torch.Tensor)]
        out[r.name] = {"device": str(r.device),
                       "programs": len(pred._programs),
                       "on_its_device": on(pred.device, r.device) and all(
                           on(t.device, r.device) for t in tensors)}
    return out


def round_robin(fleet):
    """``submit(i, *args)`` to replica ``i % N`` directly (not through the
    router), its future stamped as the router stamps one."""
    reps = list(fleet.replicas)

    def submit(i, *args):
        rep = reps[i % len(reps)]
        fut = rep.sup.submit(*args)
        fut.replica, fut.version = rep.name, rep.version
        return fut
    return submit


def fleet_burst(torch, np, fleet, pool, reqs, refs, lost, submit=None):
    """Phase 4's traffic through the router (or ``submit(i, *args)``),
    clients retrying typed admission failures (``retrying_submit``):
    (loadgen report, per-request (error vs the CPU copy of its version,
    replica, version, output device)). An accepted request whose future
    fails typed is appended to ``lost`` and submitted again."""
    from mxnet_tpu_torch.serving import Overloaded, ServingShutdown, \
        loadgen
    got = [None] * SERVE_REQUESTS
    if submit is None:
        submit = lambda i, *args: fleet.router.submit(*args)  # noqa: E731

    def issue(i):
        s, n = reqs[i]
        while True:
            fut = retrying_submit(lambda *a: submit(i, *a),
                                  (pool[s:s + n],))
            try:
                out = fut.result(FLEET_WAIT_S)
                break
            except (Overloaded, ServingShutdown) as e:
                lost.append(f"{type(e).__name__}: {e}")
        v = fut.version
        got[i] = (fleet_answer_err(np, out.float().cpu().numpy(),
                                   refs[FLEET_SEEDS[v]][s:s + n]),
                  fut.replica, v, str(out.device))
        return {"replica": fut.replica}

    rep = loadgen.run_closed_loop(issue, SERVE_CLIENTS, SERVE_REQUESTS)
    return rep, got


def fleet_multi_card(torch, np, K, smi, params, refs, pool, reqs, ckpt):
    """Phase 17b on N >= 3 cards: a float32 fleet of N - 1 replicas, one
    on each card but the last (the spare). (1) A burst of phase 4's
    traffic; (2) the same burst with ``serving.dispatch@replica-1`` set
    to revoke replica-1's device at its second dispatch: no accepted
    request lost, no hang, exactly one failover and one restart, onto
    the spare card, every answer within LOGIT_ATOL of the CPU copy, every
    output and captured program of a replica on its own card; the time
    from the fault to the restarted replica serving, and the req/s
    before, during and after (3); (4) a rolling ``swap_weights`` under
    the burst: none dropped, at most one weight version of skew at any
    time, each answer within LOGIT_ATOL of the CPU copy of the version
    its ``fut.version`` names (the two versions' logits part by far
    more), ``n_traces`` unchanged. The device loss is simulated: the
    card stays healthy and ``available_devices()`` leaves it out."""
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.serving import FleetController
    from mxnet_tpu_torch.testing import faults
    n_cards = torch.cuda.device_count()
    spare = str(dist.available_devices()[-1])
    t0 = time.perf_counter()
    fleet = FleetController(fleet_build("float32", params[FLEET_SEEDS[0]]),
                            example=(pool[:1],), replicas=n_cards - 1,
                            max_batch=SERVE_MAX_BATCH, timeout_ms=2.0)
    report = {"cards": n_cards, "replicas": n_cards - 1,
              "setup_s": time.perf_counter() - t0, "card": smi}
    try:
        placed = fleet_devices_ok(torch, fleet)
        report["placement"] = placed
        victim = fleet.replicas[FLEET_VICTIM]
        lost_dev = victim.device
        batchers = [(r.sup.batcher, str(r.device)) for r in fleet.replicas]
        lost_reqs = []
        K.reset_launch_counts()
        # round robin over the replicas first: the router sends an idle
        # fleet's traffic to the least estimate (the lowest index on a
        # tie), and every card is to serve
        before, got0 = fleet_burst(torch, np, fleet, pool, reqs, refs,
                                   lost_reqs, round_robin(fleet))
        # the burst's head steered at the victim (a near-zero service
        # EWMA makes its projected wait the least), so the fault fires
        victim.sup.batcher._ewma_service = 1e-6
        faults.configure(f"serving.dispatch@{victim.name}:before=2"
                         f":revoke:d{lost_dev.index}")
        during, got1 = fleet_burst(torch, np, fleet, pool, reqs, refs,
                                   lost_reqs)
        restarted = fleet.wait_restarts(600.0)
        for r in fleet.replicas:
            if all(r.sup.batcher is not b for b, _d in batchers):
                batchers.append((r.sup.batcher, str(r.device)))
        # the head of the next burst steered at the restarted replica, so
        # it serves on the spare card
        victim.sup.batcher._ewma_service = 1e-6
        after, got2 = fleet_burst(torch, np, fleet, pool, reqs, refs,
                                  lost_reqs)
        counts = K.launch_counts()
        ev = {e.kind: e for e in fleet.events}
        lost, back = ev.get("replica_lost"), ev.get("restart")
        per_card = {}
        for b, d in batchers:
            per_card[d] = per_card.get(d, 0) + b.stats["batches"]
        # a restarted replica's warm-up, inside the counted window: on a
        # card WARMUP_RUNS eager runs a bucket before each capture, then
        # one timed replay of its largest bucket (the service-time seed)
        from mxnet_tpu_torch.captured import WARMUP_RUNS
        runs = (WARMUP_RUNS * len(FLEET_BUCKETS)
                if victim.device.type == "cuda" else 0) + 1
        warm = {str(victim.device): runs * fleet.stats["restarts"]}
        nb = sum(per_card.values()) + sum(warm.values())
        runs_per_card = {d: b + warm.get(d, 0) for d, b in per_card.items()}
        answers = got0 + got1 + got2
        worst = max(a[0] if a else math.inf for a in answers)
        moved = {r.name: str(r.device) for r in fleet.replicas}
        on_card = (lambda d, want: d == want) if lost_dev.type == "cuda" \
            else (lambda d, want: d.split(":")[0] == want.split(":")[0])
        by_dev = all(a is not None and (on_card(a[3], moved[a[1]]) or (
            a[1] == victim.name and on_card(a[3], str(lost_dev))))
                     for a in answers)
        report["failover"] = {
            "rule": f"serving.dispatch@{victim.name}:before=2:revoke:"
                    f"d{lost_dev.index}",
            "simulated": "revoke: the card stays healthy; "
                         "available_devices() leaves it out",
            "req_per_s_before_round_robin":
                before["requests"] / before["wall_s"],
            "req_per_s_during": during["requests"] / during["wall_s"],
            "req_per_s_after": after["requests"] / after["wall_s"],
            "p99_ms_before": before["p99_ms"],
            "p99_ms_during": during["p99_ms"],
            "p99_ms_after": after["p99_ms"],
            "outcomes": [r["outcomes"] for r in (before, during, after)],
            "per_replica_during": during.get("replicas"),
            "failovers": fleet.stats["failovers"],
            "restarts": fleet.stats["restarts"],
            "requeued": fleet.stats["requeued"],
            "failed_requeues": fleet.stats["failed_requeues"],
            "accepted_then_failed": lost_reqs[:4],
            "accepted_then_failed_count": len(lost_reqs),
            "victim": victim.name, "lost_device": str(lost_dev),
            "restarted_on": str(victim.device),
            "time_to_recover_s": (back.t - lost.t) if lost and back
            else None,
            "restart_build_s": back.detail.get("restart_s") if back
            else None,
            "restarts_done": restarted,
            "max_abs_err_vs_cpu": worst, "atol": LOGIT_ATOL,
            "answers_on_their_replicas_card": by_dev,
            "placement_after": fleet_devices_ok(torch, fleet),
            "launches": {k: counts[k] for k in ("flash_fwd",
                                                "layernorm_fwd")},
            "micro_batches_per_card": per_card,
            "warm_up_runs_per_card": warm,
            "flash_fwd_per_card": {d: 12 * b
                                   for d, b in runs_per_card.items()},
            "layernorm_fwd_per_card": {d: 25 * b
                                       for d, b in runs_per_card.items()}}
        fo = report["failover"]
        serving_launch_gate(counts, nb, "phase 17b fleet")
        if not (all(r["outcomes"]["ok"] == SERVE_REQUESTS
                    for r in (before, during, after))
                and fo["failovers"] == 1 and fo["restarts"] == 1
                and fo["failed_requeues"] == 0 and restarted
                and not lost_reqs
                and fo["restarted_on"] == spare
                and worst <= LOGIT_ATOL and by_dev
                and all(p["on_its_device"] for p in placed.values())
                and all(p["on_its_device"]
                        for p in fo["placement_after"].values())
                and all(c > 0 for c in per_card.values())
                and len(per_card) == n_cards):
            raise SystemExit(f"phase 17b failover: {report}")
        faults.configure(None)
        # (4) the rolling swap under bursts of traffic, until it is done
        import threading
        traces = {r.name: r.sup.predictor.n_traces for r in fleet.replicas}
        box = {}

        def do_swap():
            time.sleep(0.1)
            try:
                box["swap"] = fleet.swap_weights(ckpt)
            except Exception as e:     # noqa: BLE001 - the gate reports it
                box["error"] = f"{type(e).__name__}: {e}"

        th = threading.Thread(target=do_swap, daemon=True)
        th.start()
        bursts, got = [], []
        while len(bursts) < 40 and (th.is_alive() or len(bursts) < 2):
            r_, g_ = fleet_burst(torch, np, fleet, pool, reqs, refs,
                                 lost_reqs)
            bursts.append(r_)
            got += g_
        th.join(FLEET_WAIT_S)
        swap = box.get("swap") or {"duration_s": None, "replicas": None}
        # the replicas' versions after every swap event: at most two
        # versions in service, at most one replica out of rotation
        versions = {r.name: 0 for r in fleet.replicas}
        skew_ok, draining = True, 0
        for e in fleet.events:
            if e.kind == "swap_drain":
                draining += 1
            elif e.kind == "swap_done":
                draining -= 1
                versions[e.replica] = e.detail["version"]
            skew_ok = skew_ok and draining <= 1 and \
                max(versions.values()) - min(versions.values()) <= 1
        v_rows = refs[FLEET_SEEDS[0]] - refs[FLEET_SEEDS[1]]
        report["swap"] = {
            "duration_s": swap["duration_s"], "replicas": swap["replicas"],
            "error": box.get("error"), "bursts": len(bursts),
            "outcomes": [b["outcomes"] for b in bursts],
            "req_per_s": [b["requests"] / b["wall_s"] for b in bursts],
            "accepted_then_failed_count": len(lost_reqs),
            "versions_served": sorted({a[2] for a in got if a}),
            "max_abs_err_vs_cpu_of_its_version":
                max(a[0] if a else math.inf for a in got),
            "versions_part_by_at_least": float(np.abs(v_rows).max(axis=1)
                                               .min()),
            "at_most_one_version_of_skew": skew_ok,
            "n_traces_before": traces,
            "n_traces_after": {r.name: r.sup.predictor.n_traces
                               for r in fleet.replicas}}
        sw = report["swap"]
        if not (all(b["outcomes"]["ok"] == SERVE_REQUESTS for b in bursts)
                and "swap" in box and not th.is_alive() and skew_ok
                and not lost_reqs and sw["versions_served"] == [0, 1]
                and sw["max_abs_err_vs_cpu_of_its_version"] <= LOGIT_ATOL
                and sw["versions_part_by_at_least"] > 10 * LOGIT_ATOL
                and sw["n_traces_after"] == sw["n_traces_before"]
                and fleet.version == 1):
            raise SystemExit(f"phase 17b swap: {report}")
    finally:
        faults.configure(None)
        faults.restore_devices()
        fleet.close()
    emit({"fleet_multi_card": report})
    return report


def fused_bwd_two_cards(torch, ATT, K):
    """A2: the float32 fused flash backward launched on cuda:0 and then on
    cuda:1 from this one process, each against its plain version
    (TOLS float32)."""
    out = []
    b, h, s, d = FUSED_TWO_CARDS[0], FUSED_TWO_CARDS[1], \
        FUSED_TWO_CARDS[2], FUSED_TWO_CARDS[4]
    atol, rtol = TOLS["float32"]
    for idx in (0, 1):
        dev = torch.device("cuda", idx)
        g = torch.Generator(device="cpu").manual_seed(idx)
        q, k, v, do = (torch.randn(b, h, s, d, generator=g).to(dev)
                       for _ in range(4))
        o, lse = ATT.flash_attention_fwd_plain(q, k, v, False)
        K.reset_launch_counts()
        rec = {"device": str(dev), "shape": [b, h, s, s, d]}
        try:
            got = ATT.flash_attention_bwd(q, k, v, o, lse, do, False)
            torch.cuda.synchronize(dev)
            ref = ATT.flash_attention_bwd_plain(q, k, v, o, lse, do, False)
            rec["launches"] = K.launch_counts()["flash_bwd_fused"]
            rec["max_abs_err"] = max(float((a - r).abs().max())
                                     for a, r in zip(got, ref))
            rec["ok"] = rec["launches"] == 1 and all(
                bool(torch.allclose(a, r, atol=atol, rtol=rtol))
                for a, r in zip(got, ref)) and \
                all(a.device == dev for a in got)
        except Exception as e:     # noqa: BLE001 - the gate reports it
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["ok"] = False
        out.append(rec)
    emit({"fused_bwd_two_cards": {"cases": out, "atol": atol, "rtol": rtol}})
    if not all(r["ok"] for r in out):
        raise SystemExit(f"float32 fused backward on a second card: {out}")
    return out


def fleet_phase(torch, np, K, ATT, dev, smi, multi=True):
    """Phase 17: (a) :func:`fleet_one_card` in float32 and bf16; (b) with
    three or more cards :func:`fleet_multi_card`, and with two or more
    A2's :func:`fused_bwd_two_cards`. The checkpoint the swaps roll out
    is seed 1's BERT-base written by ``TrainCheckpointManager`` under
    FLEET_CKPT_DIR (removed at the end). Returns 17a's float32
    launches."""
    import shutil
    from mxnet_tpu_torch.checkpoint import TrainCheckpointManager
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    t0 = time.perf_counter()
    net = BERTClassifier(bert_base(device=dev), num_classes=2, device=dev)
    params = {s: init_params_numpy(net, seed=s) for s in FLEET_SEEDS}
    load_jax_params(net, params[FLEET_SEEDS[1]])
    shutil.rmtree(FLEET_CKPT_DIR, ignore_errors=True)
    mgr = TrainCheckpointManager(os.path.join(FLEET_CKPT_DIR, "train"),
                                 keep_last=1)
    mgr.save(1, net=net, block=True)
    ckpt = mgr.latest_path()
    vocab = net.bert.word_embed.weight.shape[0]
    del net
    torch.cuda.empty_cache()
    pool, reqs = fleet_traffic(np, vocab)
    refs = {s: fleet_cpu_refs(torch, np, params[s], pool)
            for s in FLEET_SEEDS}
    emit({"fleet_setup": {"setup_s": time.perf_counter() - t0,
                          "checkpoint": ckpt, "pool_rows": FLEET_POOL,
                          "requests": SERVE_REQUESTS,
                          "rows": sum(n for _s, n in reqs)}})
    try:
        counts = fleet_one_card(torch, np, K, dev, smi, "float32", params,
                                refs, pool, reqs, ckpt)
        torch.cuda.empty_cache()
        fleet_one_card(torch, np, K, dev, smi, "bfloat16", params, refs,
                       pool, reqs, ckpt)
        torch.cuda.empty_cache()
        n = torch.cuda.device_count()
        if multi and n >= 3:
            fleet_multi_card(torch, np, K, smi, params, refs, pool, reqs,
                             ckpt)
        elif multi:
            print(f"phase 17b's failover needs >= 3 GPUs (a survivor and a "
                  f"spare); {n} visible, so it did not run", flush=True)
        if multi and n >= 2:
            fused_bwd_two_cards(torch, ATT, K)
        elif multi:
            print(f"A2's second-card launch needs >= 2 GPUs; {n} visible, "
                  "so it did not run", flush=True)
    finally:
        shutil.rmtree(FLEET_CKPT_DIR, ignore_errors=True)
    emit({"fleet_phase_s": time.perf_counter() - t0, "card": smi})
    return counts


#: the ZeRO dp leg of A1: resnet50_v1 at phase 14's 128 x 224 x 224
#: (seeded images and init, ``cudnn.deterministic``), split over the
#: ranks, ZERO_BN_STEPS plain-SGD steps at ZERO_BN_LR (no momentum, no
#: weight decay, so a step's gradient is (w_t - w_t+1) / lr), held
#: against the same steps on one card over the whole batch (phase 14's
#: captured step, float32): losses within ZERO_BN_LOSS_ATOL, each
#: running statistic within ZERO_BN_STAT_RTOL of its largest, and the
#: running statistics bit-identical on every rank. Gradients: float32
#: ResNet-50 sums with heavy cancellation (the per-channel means that
#: BatchNorm's backward subtracts), so two float32 orders of one sum part
#: far beyond rounding of the result; each step's gradients of the dp
#: run and of the one-card float32 step are both held against a float64
#: run of the same steps on the card (the largest error of any tensor
#: over its largest |value|), and the dp run's must be within
#: ZERO_BN_SPREAD times the one-card step's. The same steps with each
#: rank's own statistics (the parent's behaviour: ``split_mesh`` made to
#: return None) are printed beside them.
ZERO_BN_STEPS = 3
ZERO_BN_LR = 0.1
ZERO_BN_LOSS_ATOL = 1e-4
ZERO_BN_STAT_RTOL = 1e-4
ZERO_BN_SPREAD = 4.0
ZERO_BN_REF = os.path.join("build", "zero_bn_ref.npz")


def zero_bn_data(np, batch=RESNET_BATCH, size=RESNET_SIZE):
    """Phase 14's seeded images and labels."""
    rs = np.random.RandomState(7)
    x = rs.uniform(size=(batch, 3, size, size)).astype(np.float32)
    y = rs.randint(0, RESNET_CLASSES, (batch,)).astype(np.float32)
    return x, y


def zero_bn_names(net):
    return [n for n, p in net.named_parameters() if p.requires_grad
            and not n.endswith(("running_mean", "running_var"))]


def zero_bn_stats(net):
    return {n: p.detach().cpu().numpy().copy()
            for n, p in net.named_parameters()
            if n.endswith(("running_mean", "running_var"))}


def zero_bn_steps(torch, np, dev, step, net, x, y, steps):
    """(losses, {name: [gradient a step]}, {name: running statistic at
    the end}) of ``steps`` SGD steps through ``step``."""
    names = zero_bn_names(net)
    params = dict(net.named_parameters())
    losses, grads = [], {n: [] for n in names}
    for _ in range(steps):
        before = {n: params[n].detach().clone() for n in names}
        losses.append(step(x, y).float().cpu().numpy())
        for n in names:
            grads[n].append(((before[n] - params[n].detach())
                             / ZERO_BN_LR).cpu().numpy())
        del before
    return losses, grads, zero_bn_stats(net)


def zero_bn_float64(torch, np, dev, x, y, steps):
    """The same SGD steps in float64, eager on the card: the gradient
    each step (divided by the batch, as the step's rescale does) and the
    losses."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    net = zero_bn_net(torch, np, dev).double()
    lf = SoftmaxCrossEntropyLoss()
    params = dict(net.named_parameters())
    names = zero_bn_names(net)
    xt = torch.from_numpy(x).to(dev).double()
    yt = torch.from_numpy(y).to(dev).double()
    losses, grads = [], {n: [] for n in names}
    for _ in range(steps):
        for p in net.parameters():
            p.grad = None
        loss = lf(net(xt), yt)
        loss.sum().backward()
        losses.append(loss.detach().cpu().numpy())
        with torch.no_grad():
            for n in names:
                g = params[n].grad / x.shape[0]
                grads[n].append(g.cpu().numpy())
                params[n].sub_(ZERO_BN_LR * g)
    return losses, grads, zero_bn_stats(net)


def zero_bn_net(torch, np, dev, classes=RESNET_CLASSES):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.params import load_jax_params
    net = resnet50_v1(classes=classes, device=dev)
    load_jax_params(net, resnet_init(np, net, seed=6))
    net.train()
    return net


def zero_bn_grad_errs(np, grads, ref, steps):
    """Each step's largest gradient error of any tensor over that
    tensor's largest |value| in ``ref``, and the tensor."""
    err, worst = [0.0] * steps, [None] * steps
    for n, gs in grads.items():
        for i in range(steps):
            r = ref[n][i]
            e = float(np.abs(gs[i] - r).max()) / max(float(np.abs(r).max()),
                                                     1e-30)
            if e > err[i]:
                err[i], worst[i] = e, n
    return err, worst


def zero_bn_one_card(torch, np, dev, batch=RESNET_BATCH, size=RESNET_SIZE,
                     steps=ZERO_BN_STEPS, path=ZERO_BN_REF):
    """The one-card references, written to ``path`` for the ranks: phase
    14's captured float32 step over the whole batch, and the same steps
    in float64. Returns the float32 step's gradient errors to
    float64."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    x, y = zero_bn_data(np, batch, size)
    try:
        net = zero_bn_net(torch, np, dev)
        tr = Trainer(dict(net.named_parameters()), "sgd",
                     {"learning_rate": ZERO_BN_LR})
        lf = SoftmaxCrossEntropyLoss()
        step = tr.compile_step(lambda a, b: lf(net(a), b))
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        losses, grads, stats = zero_bn_steps(torch, np, dev, step, net, xt,
                                             yt, steps)
        del net, step, tr, xt, yt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        losses64, grads64, _stats64 = zero_bn_float64(torch, np, dev, x, y,
                                                      steps)
    finally:
        torch.backends.cudnn.deterministic = det
    errs = zero_bn_grad_errs(np, grads, grads64, steps)
    arrays = {f"loss/{i}": l for i, l in enumerate(losses)}
    arrays.update({f"grad64/{i}/{n}": g[i] for n, g in grads64.items()
                   for i in range(steps)})
    arrays.update({f"stat/{n}": s for n, s in stats.items()})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **arrays)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return errs, [float(np.abs(a - b).max())
                  for a, b in zip(losses, losses64)]


def zero_bn_errors(np, ref, losses, grads, stats, steps):
    """Against the one-card references: the largest loss error and
    running-statistic error (over each one's largest) to the float32
    step, and each step's gradient error to float64."""
    loss_err = max(float(np.abs(losses[i] - ref[f"loss/{i}"]).max())
                   for i in range(steps))
    g64 = {n: [ref[f"grad64/{i}/{n}"] for i in range(steps)]
           for n in grads}
    g_err, g_worst = zero_bn_grad_errs(np, grads, g64, steps)
    s_err = max(float(np.abs(s - ref[f"stat/{n}"]).max())
                / max(float(np.abs(ref[f"stat/{n}"]).max()), 1e-30)
                for n, s in stats.items())
    return {"loss_max_abs_err": loss_err,
            "grad_max_rel_err_vs_float64": g_err, "grad_worst": g_worst,
            "stat_max_rel_err": s_err}


def zero_bn_rank(batch, size, steps, ref_path):
    """One rank: the ResNet-50 step through ``compile_step`` under
    ``make_mesh({"dp": world})`` on the global batch, first with the
    statistics of the global batch (A1), then with each rank's own
    (``split_mesh`` made to return None: the parent's BatchNorm). Rank 0
    compares both with the one-card reference; every rank returns its
    running statistics."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.nn import basic_layers
    from mxnet_tpu_torch.parallel import dist, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = dist.device()
    x, y = zero_bn_data(np, batch, size)
    ref = np.load(ref_path) if dist.rank() == 0 else None
    out = {"rank": dist.rank()}
    split = basic_layers.split_mesh
    for leg in ("global_statistics", "local_statistics"):
        if leg == "local_statistics":
            basic_layers.split_mesh = lambda: None
        try:
            net = zero_bn_net(torch, np, dev)
            tr = Trainer(dict(net.named_parameters()), "sgd",
                         {"learning_rate": ZERO_BN_LR})
            lf = SoftmaxCrossEntropyLoss()
            step = tr.compile_step(lambda a, b: lf(net(a), b))
            with make_mesh({"dp": dist.size()}):
                t0 = time.perf_counter()
                losses, grads, stats = zero_bn_steps(torch, np, dev, step,
                                                     net, x, y, steps)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
        finally:
            basic_layers.split_mesh = split
        rec = {"mode": step.mode, "stats": stats, "wall_s": wall}
        if ref is not None:
            rec.update(zero_bn_errors(np, ref, losses, grads, stats, steps))
            rec["losses_mean"] = [float(l.mean()) for l in losses]
        out[leg] = rec
        del net, step, tr, grads
        torch.cuda.empty_cache()
    return out


def zero_batchnorm(torch, np, smi, device="cuda", world=None,
                   batch=RESNET_BATCH, size=RESNET_SIZE,
                   steps=ZERO_BN_STEPS, timeout_s=900):
    """A1 across the visible cards: :func:`zero_bn_rank` on every card
    against :func:`zero_bn_one_card` on the first."""
    from mxnet_tpu_torch.parallel import dist
    world = world or torch.cuda.device_count()
    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device("cpu")
    t0 = time.perf_counter()
    (one_err, one_worst), one_loss64 = zero_bn_one_card(torch, np, dev,
                                                        batch, size, steps)
    try:
        ranks = dist.spawn(zero_bn_rank, world, device,
                           (batch, size, steps, os.path.abspath(
                               ZERO_BN_REF)), timeout_s=timeout_s)
    finally:
        os.remove(ZERO_BN_REF)
    report = {"model": "resnet50_v1", "world": world, "batch": batch,
              "rows_per_rank": batch // world, "size": size,
              "steps": steps, "optimizer": "sgd", "lr": ZERO_BN_LR,
              "loss_atol": ZERO_BN_LOSS_ATOL, "stat_rtol": ZERO_BN_STAT_RTOL,
              "grad_spread_factor": ZERO_BN_SPREAD,
              "one_card_float32_grad_max_rel_err_vs_float64": one_err,
              "one_card_float32_grad_worst": one_worst,
              "one_card_float32_loss_max_abs_err_vs_float64": one_loss64,
              "card": smi, "phase_s": None}
    for leg in ("global_statistics", "local_statistics"):
        r0 = ranks[0][leg]
        same = all(np.array_equal(r[leg]["stats"][n], r0["stats"][n])
                   for r in ranks for n in r0["stats"])
        report[leg] = {k: r0[k] for k in (
            "mode", "loss_max_abs_err", "grad_max_rel_err_vs_float64",
            "grad_worst", "stat_max_rel_err", "losses_mean", "wall_s")}
        report[leg]["grad_err_over_one_card"] = [
            e / max(o, 1e-30) for e, o in zip(
                r0["grad_max_rel_err_vs_float64"], one_err)]
        report[leg]["running_stats_bit_identical_on_every_rank"] = same
    report["phase_s"] = time.perf_counter() - t0
    g = report["global_statistics"]
    report["ok"] = (g["mode"] == "zero"
                    and g["running_stats_bit_identical_on_every_rank"]
                    and g["loss_max_abs_err"] <= ZERO_BN_LOSS_ATOL
                    and all(r <= ZERO_BN_SPREAD
                            for r in g["grad_err_over_one_card"])
                    and g["stat_max_rel_err"] <= ZERO_BN_STAT_RTOL)
    emit({"zero_batchnorm": report})
    if not report["ok"]:
        raise SystemExit(f"BatchNorm over the dp group failed: {report}")
    return report


#: phase 18: the input pipeline at full width. (a) gluon-cv's ImageNet
#: input path (scripts/classification/imagenet/train_imagenet.py) into
#: phase 14's captured float32 step (resnet50_v1, SGD momentum 0.9, lr
#: 0.1, under ``cudnn.deterministic``): DATA_RECORDS synthetic images of
#: DATA_SHAPE (480 the shorter side of im2rec's ``--resize 480``) as raw
#: CHW uint8 records, labels in 0-999, made from DATA_SEED in a temporary
#: directory the phase removes; ``RecordFileDataset`` → decode
#: (``recordio.unpack``, ``image.imdecode_or_raw``) → the recipe's
#: augmentation → ``DataLoader(batch RESNET_BATCH, shuffle,
#: last_batch="discard", DATA_WORKERS threads, staged DATA_DEPTH batches
#: ahead on the card)`` for DATA_EPOCHS epochs of DATA_RECORDS //
#: RESNET_BATCH steps; then, with PIL, DATA_JPEG_RECORDS images as JPEG
#: (quality DATA_JPEG_QUALITY, im2rec's default) read by
#: ``io.ImageRecordIter`` (decoded, resized to 224 x 224 through
#: ``imresize_np``, mirrored, the ImageNet mean and std in 0-255) for
#: DATA_ITER_BATCHES batches through the same step, and by
#: ``ImageRecordDataset`` for one batch. (b) MXNet's example/gluon/word_language_model/train.py loop
#: on phase 8's WordLM: the bptt-long (data, target) windows of a stream
#: of LM_BATCH x LM_BPTT x DATA_LM_WINDOWS + 1 tokens, ``IntervalSampler``,
#: ``loss.backward()``, ``clip_global_norm`` at DATA_LM_CLIP x bptt x
#: batch, SGD without momentum, ``step(1)`` (lr DATA_LM_LR: phase 8's on
#: the batch's mean, the loss here being the batch's sum)
DATA_RECORDS, DATA_SHAPE, DATA_LABELS = 1536, (3, 480, 640), 1000
DATA_EPOCHS, DATA_WORKERS, DATA_DEPTH, DATA_SEED = 2, 8, 2, 18
DATA_MEAN, DATA_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
DATA_MEAN_255, DATA_STD_255 = (123.68, 116.28, 103.53), \
    (58.395, 57.12, 57.375)
DATA_ITER_BATCHES, DATA_JPEG_QUALITY = 2, 95
DATA_JPEG_RECORDS = DATA_ITER_BATCHES * RESNET_BATCH
#: the captured step timed on a resident batch, beside the fed steps
DATA_RESIDENT_STEPS = 5
DATA_LM_WINDOWS, DATA_LM_CLIP, DATA_LM_LR = 10, 0.25, LM_LR / LM_BATCH
#: 18b's eager steps without the clip, timed after the clipped run
DATA_LM_PLAIN_STEPS = 3
#: 18b: each step's returned norm against a float64 CPU norm of the same
#: card gradients (relative); a clipped global norm at most max_norm x
#: (1 + DATA_NORM_RTOL)
DATA_NORM_RTOL = 1e-5
#: the kernels of phase 18's paths
DATA_KERNELS = {"opt_update": ("resnet50_records", "lstm_lm_clipped"),
                "rnn_scan_fwd": ("lstm_lm_clipped",),
                "rnn_scan_bwd": ("lstm_lm_clipped",)}


class DataWindows:
    """The ``bptt``-long (data, target) windows of a token stream, one a
    sample (the word LM example's batchified corpus)."""

    def __init__(self, stream, bptt):
        self.stream, self.bptt = stream, bptt

    def __len__(self):
        return (len(self.stream) - 1) // self.bptt

    def __getitem__(self, i):
        s = self.stream[i * self.bptt:(i + 1) * self.bptt + 1]
        return s[:-1], s[1:]


class TimedDataset:
    """``dataset`` with the wall ms of each read kept (a loader's
    workers read it from several threads)."""

    def __init__(self, dataset):
        import threading
        self._dataset = dataset
        self._mu = threading.Lock()
        self.ms = []

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, i):
        t0 = time.perf_counter()
        out = self._dataset[i]
        with self._mu:
            self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def data_seed(np, seed):
    """Seed the generators the pipeline draws from (numpy's, for the
    sampler and the transforms; Python's)."""
    import random
    random.seed(seed)
    np.random.seed(seed)


def data_images(np, n, seed=DATA_SEED):
    """(labels, iterator of ``n`` CHW uint8 images of DATA_SHAPE)."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, DATA_LABELS, n)
    size = int(np.prod(DATA_SHAPE))

    def images():
        for _ in range(n):
            yield np.frombuffer(rs.bytes(size), np.uint8).reshape(DATA_SHAPE)
    return labels, images()


def data_records(np, path):
    """Write the DATA_RECORDS records of phase 18a (raw payloads, header
    id the record's index) with ``MXIndexedRecordIO``; returns their
    labels."""
    from mxnet_tpu_torch import recordio
    labels, images = data_images(np, DATA_RECORDS)
    w = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx", path,
                                   "w")
    for i, img in enumerate(images):
        w.write_idx(i, recordio.pack(
            recordio.IRHeader(0, float(labels[i]), i, 0), img.tobytes()))
    w.close()
    return labels


def data_decode(rec):
    """A raw record as (HWC float32 image, label, record id)."""
    from mxnet_tpu_torch import image, recordio
    head, payload = recordio.unpack(rec)
    return image.imdecode_or_raw(payload, DATA_SHAPE), head.label, head.id


def data_augment():
    """gluon-cv's ImageNet training augmentation."""
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    return T.Compose([T.RandomResizedCrop(RESNET_SIZE),
                      T.RandomFlipLeftRight(),
                      T.RandomColorJitter(0.4, 0.4, 0.4),
                      T.RandomLighting(0.1), T.ToTensor(),
                      T.Normalize(DATA_MEAN, DATA_STD)])


def step_launches(K, before):
    after = K.launch_counts()
    return {n: after[n] - before[n] for n in after}


def data_resnet(torch, np, K, dev, smi):
    """Phase 18a. Gates: the first staged batch bit-equal to the same
    loader's first batch on the host without workers, from the same
    seeds; every batch's labels those of its records; finite losses;
    exactly one ``opt_update`` a step and nothing else of the library;
    one capture, made before the steps. Returns the launches of the
    loader's steps (counted from 0)."""
    import shutil
    import tempfile
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.data import DataLoader, RecordFileDataset
    from mxnet_tpu_torch.gluon.data import default_batchify_fn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.params import load_jax_params
    tmp = tempfile.mkdtemp(prefix="mxt-records-")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rec = os.path.join(tmp, "train.rec")
        t0 = time.perf_counter()
        labels = data_records(np, rec)
        write_s = time.perf_counter() - t0
        rec_bytes = os.path.getsize(rec)
        ds = RecordFileDataset(rec).transform(data_decode) \
            .transform_first(data_augment())

        # the host reference: the first batch without workers
        batchify_ms = []

        def timed_batchify(samples):
            t = time.perf_counter()
            out = default_batchify_fn(samples)
            batchify_ms.append((time.perf_counter() - t) * 1e3)
            return out
        host_ds = TimedDataset(ds)
        data_seed(np, DATA_SEED)
        host = next(iter(DataLoader(host_ds, RESNET_BATCH, shuffle=True,
                                    last_batch="discard",
                                    batchify_fn=timed_batchify)))

        net = resnet50_v1(classes=RESNET_CLASSES, device=dev)
        load_jax_params(net, resnet_init(np, net, seed=6))
        net.train()
        trainer = Trainer(dict(net.named_parameters()), "sgd",
                          {"learning_rate": RESNET_LR,
                           "momentum": RESNET_MOMENTUM})
        loss_fn = SoftmaxCrossEntropyLoss()
        step = trainer.compile_step(lambda a, b: loss_fn(net(a), b))
        hx, hy = host[0].to(dev), host[1].to(dev)
        t0 = time.perf_counter()
        step.aot_compile(hx, hy)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        n_warm = step.n_traces

        card_ds = TimedDataset(ds)
        loader = DataLoader(card_ds, RESNET_BATCH, shuffle=True,
                            last_batch="discard", num_workers=DATA_WORKERS,
                            device=dev, prefetch_to_device=DATA_DEPTH)
        expect = {n: 0 for n in K.KERNELS}
        expect.update(opt_update=1)
        losses, step_ms, per_step, starts = [], [], [], []
        first_equal, labels_ok = None, True
        wait_ms, starved = 0.0, 0
        data_seed(np, DATA_SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t_prev = time.perf_counter()
        for _ in range(DATA_EPOCHS):
            starts.append(len(step_ms))
            for x, y, ids in loader:
                before = K.launch_counts()
                loss = step(x, y)
                torch.cuda.synchronize()
                now = time.perf_counter()
                step_ms.append((now - t_prev) * 1e3)
                t_prev = now
                per_step.append(step_launches(K, before))
                losses.append(float(loss.mean()))
                if first_equal is None:
                    first_equal = all(bool(torch.equal(a.cpu(), b))
                                      for a, b in zip((x, y, ids), host))
                ids_np = ids.cpu().numpy()
                labels_ok &= bool(np.array_equal(
                    y.cpu().numpy(), labels[ids_np].astype(np.float32)))
            stats = loader.device_prefetch_stats
            wait_ms += stats["input_wait_ms"]
            starved += stats["starvation_count"]
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        n_after = step.n_traces

        resident_ms = []
        for _ in range(DATA_RESIDENT_STEPS):
            t0 = time.perf_counter()
            step(hx, hy)
            torch.cuda.synchronize()
            resident_ms.append((time.perf_counter() - t0) * 1e3)

        jpeg = data_jpeg(torch, np, K, dev, tmp, step, expect)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    fed = step_ms[1:]
    within = [ms for i, ms in enumerate(step_ms) if i not in starts]
    resident = statistics.median(resident_ms[1:])
    n_host = len(host_ds.ms)
    report = {
        "model": "resnet50_v1", "records": DATA_RECORDS,
        "record_shape": list(DATA_SHAPE), "file_bytes": rec_bytes,
        "write_s": write_s, "batch": RESNET_BATCH, "epochs": DATA_EPOCHS,
        "workers": DATA_WORKERS, "prefetch_to_device": DATA_DEPTH,
        "steps": len(losses), "losses": losses, "step_ms": step_ms,
        "images_per_s_steps_2_on": RESNET_BATCH * len(fed) / (sum(fed) / 1e3),
        "images_per_s_within_epochs":
            RESNET_BATCH * len(within) / (sum(within) / 1e3),
        "epoch_start_ms": [step_ms[i] for i in starts],
        "resident_step_ms": resident_ms,
        "resident_images_per_s": RESNET_BATCH / (resident / 1e3),
        "input_wait_ms": wait_ms, "starvation_count": starved,
        "host_sample_ms": statistics.median(host_ds.ms),
        "host_sample_ms_mean": sum(host_ds.ms) / n_host,
        "host_samples": n_host,
        "worker_sample_ms": statistics.median(card_ds.ms),
        "worker_sample_ms_mean": statistics.mean(card_ds.ms),
        "worker_samples": len(card_ds.ms),
        "batchify_ms": batchify_ms[0],
        "first_batch_bit_equal_to_host": first_equal,
        "labels_match_records": labels_ok, "capture_s": capture_s,
        "n_traces_after_warmup": n_warm, "n_traces_after_steps": n_after,
        "launches": counts, "launches_per_step": per_step[-1],
        "launches_per_step_expected": expect,
        "max_memory_allocated": peak, "jpeg": jpeg, "card": smi}
    report["ok"] = bool(
        first_equal and labels_ok and all(math.isfinite(v) for v in losses)
        and all(s == expect for s in per_step)
        and n_warm == n_after == 1
        and len(losses) == DATA_EPOCHS * (DATA_RECORDS // RESNET_BATCH)
        and (jpeg is None or jpeg["ok"]))
    print(smi, flush=True)
    emit({"data_records_resnet": report})
    if not report["ok"]:
        raise SystemExit(f"phase 18a failed: {report}")
    return counts


def data_jpeg(torch, np, K, dev, tmp, step, expect):
    """Phase 18a's JPEG leg: DATA_JPEG_RECORDS images written with
    ``recordio.pack_img``, read by ``io.ImageRecordIter`` for
    DATA_ITER_BATCHES steps and by ``ImageRecordDataset`` for one (a
    batch sampler of one seeded batch, so one worker builds it alone);
    None (and a line saying so) without PIL."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        print("phase 18a's JPEG leg (io.ImageRecordIter, "
              "ImageRecordDataset) did not run: PIL is not installed on "
              "this host (recordio.pack_img and image.imdecode need it)",
              flush=True)
        return None
    from mxnet_tpu_torch import io as mxio
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset
    path = os.path.join(tmp, "jpeg.rec")
    labels, images = data_images(np, DATA_JPEG_RECORDS)
    t0 = time.perf_counter()
    w = recordio.MXIndexedRecordIO(os.path.join(tmp, "jpeg.idx"), path, "w")
    for i, img in enumerate(images):
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(labels[i]), i, 0),
            img.transpose(1, 2, 0), quality=DATA_JPEG_QUALITY))
    w.close()
    encode_s = time.perf_counter() - t0

    it = mxio.ImageRecordIter(
        path, (3, RESNET_SIZE, RESNET_SIZE), RESNET_BATCH, rand_mirror=True,
        mean_r=DATA_MEAN_255[0], mean_g=DATA_MEAN_255[1],
        mean_b=DATA_MEAN_255[2], std_r=DATA_STD_255[0],
        std_g=DATA_STD_255[1], std_b=DATA_STD_255[2])
    iter_losses, iter_steps, read_s, iter_labels_ok = [], [], 0.0, True
    data_seed(np, DATA_SEED)
    for b in range(DATA_ITER_BATCHES):
        t0 = time.perf_counter()
        batch = it.next()
        read_s += time.perf_counter() - t0
        y = batch.label[0]
        iter_labels_ok &= bool(np.array_equal(
            y.numpy(), labels[b * RESNET_BATCH:(b + 1) * RESNET_BATCH]
            .astype(np.float32)))
        before = K.launch_counts()
        loss = step(batch.data[0].to(dev), y.to(dev))
        torch.cuda.synchronize()
        iter_steps.append(step_launches(K, before))
        iter_losses.append(float(loss.mean()))
    it.close()

    ds = ImageRecordDataset(path).transform_first(data_augment())
    data_seed(np, DATA_SEED)
    one = [np.random.permutation(len(ds))[:RESNET_BATCH].tolist()]
    loader = DataLoader(ds, batch_sampler=one, num_workers=DATA_WORKERS,
                        device=dev, prefetch_to_device=DATA_DEPTH)
    t0 = time.perf_counter()
    x, y = next(iter(loader))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    loss = float(step(x, y.float()).mean())
    return {"records": DATA_JPEG_RECORDS, "quality": DATA_JPEG_QUALITY,
            "bytes": os.path.getsize(path), "encode_s": encode_s,
            "image_record_iter": {
                "batches": DATA_ITER_BATCHES, "losses": iter_losses,
                "records_per_s": DATA_ITER_BATCHES * RESNET_BATCH / read_s,
                "read_s": read_s, "labels_match_records": iter_labels_ok,
                "launches_per_step": iter_steps[-1]},
            "dataset_first_batch_s": batch_s, "dataset_loss": loss,
            "ok": bool(
                iter_labels_ok and all(s == expect for s in iter_steps)
                and all(math.isfinite(v) for v in iter_losses + [loss])
                and tuple(x.shape) == (
                    RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE))}


def data_lm(torch, np, K, dev, smi):
    """Phase 18b. Gates: each staged batch equal to its host batch; each
    step's returned norm within DATA_NORM_RTOL of a float64 CPU norm of
    the same card gradients; after a clip, the global norm at most
    max_norm x (1 + DATA_NORM_RTOL); the update fed the clipped
    gradients within SURFACE_UPD_ATOL + SURFACE_UPD_RTOL |w| of a CPU
    copy's; exactly LM_LAYERS ``rnn_scan_fwd`` and ``rnn_scan_bwd`` and
    one ``opt_update`` a step; finite losses. When no step clips at the
    example's value, one more step (the first batch) clips at half the
    last step's norm. Returns the launches of the clipped run's steps."""
    from mxnet_tpu_torch.gluon import Trainer, clip_global_norm
    from mxnet_tpu_torch.gluon.data import (DataLoader, IntervalSampler,
                                            SimpleDataset)
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import WordLM
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    net = WordLM(LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS, device=dev)
    load_jax_params(net, init_params_numpy(net, seed=6))
    net.train()
    stream = np.random.RandomState(DATA_SEED).randint(
        0, LM_VOCAB, LM_BATCH * LM_BPTT * DATA_LM_WINDOWS + 1)
    windows = DataWindows(stream.astype(np.int64), LM_BPTT)
    nbatch = len(windows) // LM_BATCH

    def loader(**kw):
        return DataLoader(SimpleDataset(windows), batch_size=LM_BATCH,
                          sampler=IntervalSampler(len(windows), nbatch),
                          last_batch="discard", **kw)
    host = list(loader())
    kw = {"learning_rate": DATA_LM_LR}
    trainer = Trainer(dict(net.named_parameters()), "sgd", dict(kw))
    params = trainer._params
    loss_fn = SoftmaxCrossEntropyLoss()
    max_norm = DATA_LM_CLIP * LM_BPTT * LM_BATCH
    expect = {n: 0 for n in K.KERNELS}
    expect.update(rnn_scan_fwd=LM_LAYERS, rnn_scan_bwd=LM_LAYERS,
                  opt_update=1)

    def cpu_norm(grads):
        return math.sqrt(sum(float(g.detach().cpu().double().square().sum())
                             for g in grads))

    def one_step(x, y, limit):
        rec = {"max_norm": limit}
        before = K.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(net(x), y)
        loss.sum().backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = [p.grad for p in params]
        ref = cpu_norm(grads)
        t2 = time.perf_counter()
        total = clip_global_norm(grads, limit)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rec.update(total=total, total_float64_cpu=ref,
                   total_rel_err=abs(total - ref) / ref,
                   clipped=limit / (total + 1e-8) < 1.0)
        if rec["clipped"]:
            rec["norm_after_clip"] = cpu_norm(grads)
        twin = cpu_twin(torch, trainer, "sgd", kw)
        for p, c in zip(params, twin._params):
            c.grad, c.fresh_grad = p.grad.detach().cpu(), True
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        trainer.step(1)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        twin.step(1)
        rec.update(update_vs_cpu=twin_gap(trainer, twin),
                   launches=step_launches(K, before),
                   loss=float(loss.detach().mean()),
                   fwd_bwd_ms=(t1 - t0) * 1e3, clip_ms=(t3 - t2) * 1e3,
                   update_ms=(t5 - t4) * 1e3,
                   step_ms=(t1 - t0 + t3 - t2 + t5 - t4) * 1e3)
        rec["ok"] = (rec["total_rel_err"] <= DATA_NORM_RTOL
                     and rec.get("norm_after_clip", 0.0)
                     <= limit * (1 + DATA_NORM_RTOL)
                     and rec["update_vs_cpu"]["ok"]
                     and rec["launches"] == expect
                     and math.isfinite(rec["loss"]))
        return rec

    steps, staged_ok = [], True
    K.reset_launch_counts()
    for i, (x, y) in enumerate(loader(device=dev,
                                      prefetch_to_device=DATA_DEPTH)):
        staged_ok &= bool(torch.equal(x.cpu(), host[i][0])
                          and torch.equal(y.cpu(), host[i][1]))
        steps.append(one_step(x, y, max_norm))
    if not any(s["clipped"] for s in steps):
        x, y = (t.to(dev) for t in host[0])
        steps.append(one_step(x, y, steps[-1]["total"] / 2.0))
    counts = K.launch_counts()

    plain_ms = []
    for x, y in host[:DATA_LM_PLAIN_STEPS]:
        x, y = x.to(dev), y.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_fn(net(x), y).sum().backward()
        trainer.step(1)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(s["step_ms"] for s in steps[1:])
    report = {
        "model": "WordLM (LSTM LM)", "vocab": LM_VOCAB, "hidden": LM_HIDDEN,
        "layers": LM_LAYERS, "batch": LM_BATCH, "bptt": LM_BPTT,
        "tokens": len(stream), "optimizer": "sgd", "learning_rate":
        DATA_LM_LR, "max_norm": max_norm, "steps": steps,
        "extra_clipping_step": len(steps) > nbatch,
        "staged_equal_host": staged_ok, "median_step_ms": med,
        "tokens_per_s": LM_BATCH * LM_BPTT / (med / 1e3),
        "median_clip_ms": statistics.median(s["clip_ms"] for s in steps[1:]),
        "plain_eager_step_ms": plain_ms, "launches": counts, "card": smi}
    report["ok"] = bool(staged_ok and len(host) == nbatch
                        and all(s["ok"] for s in steps)
                        and any(s["clipped"] for s in steps))
    print(smi, flush=True)
    emit({"data_lm_clipped": report})
    if not report["ok"]:
        raise SystemExit(f"phase 18b failed: {report}")
    return counts


def data_phase(torch, np, K, dev, smi):
    """Phase 18 (18a, then 18b): {path: its launches}."""
    t0 = time.perf_counter()
    out = {"resnet50_records": data_resnet(torch, np, K, dev, smi)}
    torch.cuda.empty_cache()
    out["lstm_lm_clipped"] = data_lm(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    emit({"data_phase_s": time.perf_counter() - t0})
    return out


#: --kernel-times: the kernels' shapes, each on its path (the flash
#: forward served and in BERT training; the long-sequence backward's dq
#: and dkv at phase 7's; the LM's LSTM layer; decode_wide's step)
AB_FLASH = ((32, 12, 128, 128, 64), (32, 12, 512, 512, 64))
AB_FLASH_BWD = (LONG_BATCH, 12, LONG_SEQ, LONG_SEQ, 64)
#: --kernel-times: the fused backward at BERT training's shape
AB_FUSED_BWD = (TRAIN_BATCH, 12, TRAIN_SEQ, TRAIN_SEQ, 64)
#: --kernel-times: the LayerNorm forward served (both dtypes) and at BERT
#: training's 16384 x 768 (float32, its dtype there also under amp)
AB_LN_FWD = {"float32": ((4096, 768), (TRAIN_BATCH * TRAIN_SEQ, 768)),
             "bfloat16": ((4096, 768),)}
#: --kernel-times: bf16 amp BERT-base steps (32 x 512) timed after a
#: warm-up step, where the checkout has amp
AB_BF16_STEPS = 5
#: --kernel-times: phase 7's training steps timed after one warm-up step
AB_LONG_STEPS = 5
#: --kernel-times: bucket-32 micro-batches timed after the predictor's
#: warm-up, and decode_wide's bucket-8 steps after seating 8 requests
AB_SERVE_ITERS, AB_DECODE_ITERS = 20, 10
#: --kernel-times: one LSTM shape each recurrence wrapper refused before
#: this slice: (wrapper, T or None for decode, N, H)
AB_REFUSED = (("rnn_scan_fwd",) + RNN_REFUSED["forward"],
              ("rnn_scan_bwd",) + RNN_REFUSED["walk"],
              ("rnn_decode_step", None, 128, 650))


def serve_times(torch, np, dev, dtype, iters=AB_SERVE_ITERS):
    """``--kernel-times``: BERT-base (seeded weights) through
    ``serving.predictor_for(net, dtype)`` after its warm-up: the median
    wall ms of a bucket-32 micro-batch from an idle device (to the
    synchronize) and its median host ms (the predict call alone), then
    phase 4's traffic (8 clients, 96 requests of 1-8 rows) through
    ``DynamicBatcher``: req/s; and the peak memory of the warm-up and
    these calls. Only what both checkouts' APIs have is used."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.serving import DynamicBatcher, loadgen, \
        predictor_for
    net = BERTClassifier(bert_base(device=dev), num_classes=2, device=dev)
    load_jax_params(net, init_params_numpy(net, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pred = predictor_for(net, dtype=dtype, device=dev)
    rs = np.random.RandomState(0)
    vocab = net.bert.word_embed.weight.shape[0]
    pred.warmup(rs.randint(0, vocab, (1, SERVE_SEQ)).astype(np.int64))
    x = rs.randint(0, vocab, (SERVE_MAX_BATCH, SERVE_SEQ)).astype(np.int64)
    wall, host = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict(x)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
    reqs = [rs.randint(0, vocab, (int(rs.randint(1, 9)), SERVE_SEQ))
            .astype(np.int64) for _ in range(SERVE_REQUESTS)]
    with DynamicBatcher(pred, max_batch=SERVE_MAX_BATCH,
                        timeout_ms=2.0) as batcher:
        rep = loadgen.run_closed_loop(
            lambda i: batcher.submit(reqs[i]).result(120).cpu(),
            SERVE_CLIENTS, SERVE_REQUESTS)
    torch.cuda.synchronize()
    return (statistics.median(wall), statistics.median(host),
            rep["requests"] / rep["wall_s"] if not rep["errors"] else
            f"errors: {rep['first_error']}",
            torch.cuda.max_memory_allocated())


def decode_wide_times(torch, np, dev, iters=AB_DECODE_ITERS):
    """``--kernel-times``: decode_wide (``TinyDecoder`` at the word LM's
    widths, seed 0): a warmed engine's prefill chunk ms and bucket-8
    decode step ms and host ms (:func:`seat_and_step`, medians) with the
    peak memory of the warm-up and these steps, then phase 9's continuous
    ``run_decode`` over the decode mix: decode tokens/s."""
    from mxnet_tpu_torch import serving
    model = serving.TinyDecoder(**DECODE_WIDE, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = serving.DecodeEngine(model, ladder=DECODE_LADDER,
                               page_size=DECODE_PAGE, max_context=80,
                               start=False)
    try:
        eng.warmup()
        prefill, step, host = seat_and_step(torch, np, eng, model.vocab,
                                            iters=iters)
    finally:
        eng.close()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    prompts, mns, _ = decode_mix(np, DECODE_WIDE["vocab"], DECODE_REQUESTS,
                                 DECODE_PAGE)
    rep = serving.run_decode(model, prompts, mns, ladder=DECODE_LADDER,
                             page_size=DECODE_PAGE)
    return (statistics.median(prefill), statistics.median(step),
            statistics.median(host), rep["decode_tokens_per_sec"], peak)


def kernel_times(root):
    """``--kernel-times ROOT``: build the kernels of the package under
    ROOT (another checkout, for an A/B on one card) and print one
    ``{"kernel_times": ...}`` line: device ms by CUDA-graph replay of the
    flash forward, the long-sequence backward's dq and dkv kernels, the
    recurrence forward and backward, the LayerNorm backward at BERT
    training's 16384 x 768, the LayerNorm forward at AB_LN_FWD, the
    bias-GELU backward at 4096 x 3072 and the decode step at
    decode_wide's and decode_leg's shapes, float32 and bfloat16, with an
    empty kernel of the decode, LayerNorm forward and bias-GELU backward
    plans' grids (the launch floor; only where the checkout has the
    plan), the median wall ms of phase 7's training step (host clock,
    each step ends in a synchronize),
    and what each wrapper does at the AB_REFUSED shapes (ran, then timed
    the same way, or the error it raised: a probe, not a path); then the
    served bucket-32 micro-batch's wall and host ms, served req/s and
    the serving peak memory in float32 and bf16 (:func:`serve_times`),
    and decode_wide's prefill chunk and bucket-8 step ms, decode
    tokens/s and peak memory (:func:`decode_wide_times`)."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from mxnet_tpu_torch.ops import attention as ATT
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.ops.kernels import norm as KN
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
        b, h, sq, sk, d = AB_FUSED_BWD
        q, do = rnd(b, h, sq, d, dtype=dtype), rnd(b, h, sq, d, dtype=dtype)
        k, v = rnd(b, h, sk, d, dtype=dtype), rnd(b, h, sk, d, dtype=dtype)
        o, lse = ATT.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        sets = [tuple(t.clone() for t in (q, k, v, do)) + (lse, delta)
                for _ in range(n_sets(torch, (q, k, v, do, q, k, v)))]
        times[f"flash_bwd_fused {dn} {[b * h, sq, sk, d]}"] = time_ms(
            torch, lambda *a: ATT.flash_bwd_fused(*a, False, d ** -0.5),
            sets)[0]
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
        rows, c = LN_BWD_CASES[0]
        x, dy = rnd(rows, c, dtype=dtype), rnd(rows, c, dtype=dtype)
        gam = rnd(c)
        sets = [(x.clone(), gam, dy.clone())
                for _ in range(n_sets(torch, (x, x, x)))]
        times[f"layernorm_bwd {dn} {[rows, c]}"] = time_ms(
            torch, lambda *a: KN.layer_norm_bwd(*a), sets)[0]
        del x, dy, sets
        for rows, c in AB_LN_FWD[dn]:
            x = rnd(rows, c, dtype=dtype)
            sets = [(x.clone(), rnd(c), rnd(c))
                    for _ in range(n_sets(torch, (x, x)))]
            times[f"layernorm_fwd {dn} {[rows, c]}"] = time_ms(
                torch, lambda *a: KN.layer_norm(*a), sets)[0]
            del x, sets
        rows, c = BG_BWD_CASES[0]
        x, dy = rnd(rows, c, dtype=dtype), rnd(rows, c, dtype=dtype)
        sets = [(x.clone(), rnd(c, dtype=dtype), dy.clone())
                for _ in range(n_sets(torch, (x, x, x)))]
        times[f"bias_gelu_bwd {dn} {[rows, c]}"] = time_ms(
            torch, lambda *a: KN.bias_gelu_bwd(*a), sets)[0]
        del x, dy, sets
        for n, h in DECODE_TIMED:
            xw, hh, cc = (rnd(n, 4 * h, dtype=dtype, s=0.5),
                          rnd(n, h, dtype=dtype, s=0.5),
                          rnd(n, h, dtype=dtype, s=0.5))
            w = rnd(4 * h, h, dtype=dtype, s=0.5 * h ** -0.5)
            b = rnd(4 * h, dtype=dtype, s=0.1)
            sets = [(xw, hh, cc, w.clone(), b)
                    for _ in range(n_sets(torch, (w,)))]
            times[f"rnn_decode {dn} {[n, h]}"] = time_ms(
                torch, lambda *a: KR.rnn_decode_step(*a, "lstm"), sets,
                iters=50)[0]
            del w, sets
    if hasattr(K, "launch_empty"):
        # the launch floor under the decode step, and where the checkout
        # plans them under the LayerNorm forward and the bias-GELU
        # backward: an empty kernel of each plan's grid (a checkout
        # without the query has no floor line)
        plans = [KR.rnn_decode_plan(n, h, "lstm", torch.float32, dev)
                 for n, h in DECODE_TIMED]
        for query, shapes in (("ln_fwd_plan", AB_LN_FWD),
                              ("bg_bwd_plan", {dn: (BG_BWD_CASES[0],)
                                               for dn in AB_LN_FWD})):
            if hasattr(KN, query):
                plans += [getattr(KN, query)(rows, c, getattr(torch, dn), dev)
                          for dn, cases in shapes.items()
                          for rows, c in cases]
        for plan in plans:
            times[f"empty kernel {plan['blocks']} x {plan['threads']}"] = \
                time_ms(torch, lambda: K.launch_empty(
                    dev, plan["blocks"], plan["threads"]), [()],
                    iters=50)[0]
    out["device_ms"] = times
    _, _, x, y, _, step = long_setup(torch, np, dev)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    wall = run_train_steps(torch, K, step, x, y, AB_LONG_STEPS + 1)[1]
    out["wall_ms"] = {"train_long step (median of "
                      f"{AB_LONG_STEPS} after a warm-up)":
                      statistics.median(wall[1:])}
    del step, x, y
    torch.cuda.empty_cache()
    key = f"bert_base bf16 amp step 32 x 512 (median of {AB_BF16_STEPS} " \
        "after a warm-up)"
    try:
        from mxnet_tpu_torch import amp
    except ImportError:
        out["wall_ms"][key] = "not measured: the checkout has no amp"
    else:
        out["wall_ms"][key] = bf16_bert_step_ms(torch, np, K, dev, amp)
    torch.cuda.empty_cache()
    out["per_s"], out["max_memory_allocated"] = {}, {}
    for dn in ("float32", "bfloat16"):
        wall, host, rps, peak = serve_times(torch, np, dev, dn)
        tag = f"served {dn} bucket {SERVE_MAX_BATCH} x {SERVE_SEQ}"
        out["wall_ms"][f"{tag} micro-batch (median of {AB_SERVE_ITERS})"] \
            = wall
        out["wall_ms"][f"{tag} micro-batch host"] = host
        out["per_s"][f"served {dn} req/s (phase 4's traffic)"] = rps
        out["max_memory_allocated"][f"serving {dn} (7 buckets)"] = peak
        torch.cuda.empty_cache()
    prefill, step, host, tps, peak = decode_wide_times(torch, np, dev)
    out["wall_ms"]["decode_wide prefill chunk (median)"] = prefill
    out["wall_ms"][f"decode_wide bucket-8 decode step (median of "
                   f"{AB_DECODE_ITERS})"] = step
    out["wall_ms"]["decode_wide bucket-8 decode step host"] = host
    out["per_s"]["decode_wide continuous decode tokens/s"] = tps
    out["max_memory_allocated"]["decode_wide engine (ladder 1-8)"] = peak
    emit({"kernel_times": out})
    return 0


def bf16_bert_step_ms(torch, np, K, dev, amp):
    """Median wall ms of BERT-base training steps (32 x 512, Adam, dropout
    0.1) under ``amp.init()``, after one warm-up step (--kernel-times)."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    torch.manual_seed(0)
    net = BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=0.1,
                                   device=dev), num_classes=2, dropout=0.1,
                         device=dev)
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randint(0, 30522, (TRAIN_BATCH, TRAIN_SEQ))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (TRAIN_BATCH,))
                         .astype(np.float32)).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    trainer = Trainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": TRAIN_LR})
    step = trainer.compile_step(lambda a, b: loss_fn(net(a), b))
    amp.init("bfloat16")
    try:
        wall = run_train_steps(torch, K, step, x, y, AB_BF16_STEPS + 1)[1]
    finally:
        amp.uninit()
    return statistics.median(wall[1:])


#: --step-times: steps a run (the first a warm-up, out of the median)
AB_STEP_RUNS = 6


def step_times(root):
    """``--step-times ROOT``: with the package under ROOT, the median wall
    ms (host clock, each step ends in a synchronize) of the captured step
    (``compile_step`` after ``aot_compile``) and of the eager loop
    (forward, ``backward``, ``Trainer.step``) of BERT-base at 32 x 512
    (Adam, dropout 0) in float32 and under bf16 amp, and of resnet50_v1
    at RESNET_BATCH x RESNET_SIZE (SGD momentum) in float32, each from
    fresh seeded weights; prints one ``{"step_times": ...}`` line. What
    the whole update's form moves end to end, for ``--compare-steps``."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.ops import kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.build_library()
    dev = torch.device("cuda", 0)
    loss_fn = SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(3)
    bx = torch.from_numpy(rs.randint(0, BERT_VOCAB, (TRAIN_BATCH, TRAIN_SEQ))
                          .astype(np.int64)).to(dev)
    by = torch.from_numpy(rs.randint(0, 2, (TRAIN_BATCH,))
                          .astype(np.float32)).to(dev)
    rx = torch.from_numpy(rs.uniform(size=(RESNET_BATCH, 3, RESNET_SIZE,
                                           RESNET_SIZE)).astype(np.float32)
                          ).to(dev)
    ry = torch.from_numpy(rs.randint(0, RESNET_CLASSES, (RESNET_BATCH,))
                          .astype(np.float32)).to(dev)

    def bert():
        net = bert_base_classifier(torch, TRAIN_SEQ, dev)
        load_jax_params(net, init_params_numpy(net, seed=2))
        return net, Trainer(dict(net.named_parameters()), "adam",
                            {"learning_rate": TRAIN_LR}), bx, by

    def resnet():
        net = resnet50_v1(classes=RESNET_CLASSES, device=dev)
        load_jax_params(net, resnet_init(np, net, seed=6))
        return net, Trainer(dict(net.named_parameters()), "sgd",
                            {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM}), rx, ry

    out = {"root": root, "package": os.path.dirname(K.__file__)}
    for what, build, bf16 in (("bert_base 32 x 512 float32", bert, False),
                              ("bert_base 32 x 512 bf16 amp", bert, True),
                              (f"resnet50_v1 {RESNET_BATCH} x {RESNET_SIZE} "
                               "float32", resnet, False)):
        for kind in ("captured", "eager"):
            net, trainer, x, y = build()
            if bf16:
                amp.init("bfloat16")
            try:
                if kind == "captured":
                    fn = trainer.compile_step(
                        lambda a, b, net=net: loss_fn(net(a), b))
                    fn.aot_compile(x, y)
                else:
                    fn = plain_step(net, trainer, loss_fn)
                wall = run_train_steps(torch, K, fn, x, y, AB_STEP_RUNS)[1]
            finally:
                if bf16:
                    amp.uninit()
            out[f"{what} {kind} step (median of {AB_STEP_RUNS - 1} after "
                "a warm-up)"] = statistics.median(wall[1:])
            del net, trainer, fn
            torch.cuda.empty_cache()
    emit({"step_times": out})
    return 0


def compare_checkouts(parent, flag="--kernel-times", key="kernel_times"):
    """``--compare PARENT``: ``--kernel-times`` of PARENT (a checkout of
    the parent commit, unpacked under build/) and of this checkout, in
    turns on this card (parent, change, change, parent), each in its own
    process; prints one ``{"compare": ...}`` line with both runs of each.
    ``--compare-steps PARENT``: the same of ``--step-times``."""
    runs = []
    for root in (parent, ".", ".", parent):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              flag, root], capture_output=True, text=True)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith('{"%s"' % key)]
        if res.returncode != 0 or not line:
            raise SystemExit(f"{flag} {root} failed:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        runs.append((root, json.loads(line[0])[key]))
    if key == "step_times":
        table = {}
        for root, r in runs:
            side = "parent" if root == parent else "change"
            for k, ms in r.items():
                if k not in ("root", "package"):
                    table.setdefault(k, {"parent": [], "change": []})[
                        side].append(ms)
        emit({"compare_steps": {"order": [root for root, _ in runs],
                                "wall_ms": table}})
        return 0
    table = {}
    for root, r in runs:
        side = "parent" if root == parent else "change"
        for kind in ("device_ms", "wall_ms", "per_s",
                     "max_memory_allocated"):
            for key, ms in r.get(kind, {}).items():
                table.setdefault(kind, {}).setdefault(
                    key, {"parent": [], "change": []})[side].append(ms)
    emit({"compare": {"order": [root for root, _ in runs], **table,
                      "refused_shapes": {("parent" if root == parent
                                          else "change"): r["refused_shapes"]
                                         for root, r in runs}}})
    return 0


# ---------------------------------------------------------------------------
# phase 19: the telemetry layer at full width
# ---------------------------------------------------------------------------

#: 19a: steps a run after its capture; the run with the checkpoint writes
#: one at TELE_CKPT_AT; the NaN run poisons one weight before step
#: TELE_NAN_AT; the stall run sleeps at the retire of step TELE_STALL_AT
TELE_STEPS, TELE_CKPT_AT, TELE_NAN_AT, TELE_STALL_AT = 6, 4, 4, 8
#: the stall leg's steps (the detector arms after 5 retires) and its delay
TELE_STALL_STEPS, TELE_STALL_MS = 10, 2000
#: 19a turns of the step ms with telemetry and numerics on against off
TELE_TIMED_STEPS = 5
#: 19a: the reported norms against float64 on the card
TELE_NORM_RTOL = 1e-5
#: 19a: BERT's runs repeat only within the fused flash backward's dq
#: atomics (float32 adds in no fixed order): a numerics run is held within
#: this factor of two numerics-off runs' own distance (losses and weights,
#: rms); the Dense leg, deterministic, is held bit for bit
TELE_SPREAD_FACTOR = 2.0
#: 19a: the FLOPs a step against the analytic count, relative
TELE_FLOPS_RTOL = 0.05
#: the kernels phase 19's paths launch (rows 1, 2, 5, 6, 11, 12)
TELE_KERNELS = ("flash_fwd", "flash_bwd_fused", "layernorm_fwd",
                "layernorm_bwd", "rnn_decode", "opt_update")
#: where phase 19 writes its checkpoints, dumps, Prometheus file and trace
BUILD_TELE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_telemetry")


def _tele_make(dev, dropout=0.1):
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    return BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=dropout,
                                    device=dev),
                          num_classes=2, dropout=dropout, device=dev)


def _tele_run(torch, K, dev, build, xt, yt, mode, steps, before_step=None,
              ckpt=None, sync_check=True):
    """One TrainLoop run of ``build()``'s (net, trainer, loss) with
    ``numerics=mode``, captured first (``aot_compile``), then ``steps``
    steps from a prefetcher under ``set_sync_debug_mode("error")`` (the
    retire and the checkpoint are the designed waits); the kernel counts
    set to 0 just before the steps. Returns the loop, the losses, the
    last step's numerics (read at its retire through the monitor) and
    the launches."""
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.gluon import TrainLoop
    net, tr, loss_fn = build()
    loop = TrainLoop(net, tr, loss_fn, numerics=mode, inflight=2,
                     checkpoint_dir=ckpt, checkpoint_every=TELE_CKPT_AT
                     if ckpt else None, resume=False)
    loop.compiled_step.aot_compile(xt, yt)
    losses = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    if sync_check:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for i, (x, y) in enumerate(loop.prefetch(
                ((xt, yt) for _ in range(steps)), depth=2)):
            if before_step is not None:
                before_step(i + 1, net)
            losses.append(loop.step(x, y))
        loop.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loop.wait()
    # the last step's statistics, read at its retire
    last = tel.numerics.monitor().last() if mode is not None else None
    return loop, [l.float().cpu() for l in losses], last, K.launch_counts()


def _tele_dist(a, b):
    """The rms difference of two lists of tensors over all their elements
    (0 when equal): one element with a tiny Adam denominator decides the
    largest difference, the rms is steady (phase 6c)."""
    sq = sum(float((x.double() - y.double()).square().sum())
             for x, y in zip(a, b))
    return math.sqrt(sq / sum(x.numel() for x in a))


def tele_train(torch, np, K, dev, smi, bf16=False):
    """Phase 19a: BERT-base training (phase 6's model, shape and seeds)
    through ``TrainLoop`` with ``prefetch``, numerics off (twice), global
    and per_layer, one checkpoint, ``arm_mfu``; the Dense leg bit for bit;
    the norms against float64; one injected NaN, one injected stall; the
    step with telemetry and numerics on against off, in turns."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.nn import Dense
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.testing import faults
    dt = "bfloat16" if bf16 else "float32"
    if bf16:
        amp.init("bfloat16")
    try:
        net0 = _tele_make(dev)
        init = init_params_numpy(net0, seed=2)
        n_all = sum(p.numel() for p in net0.parameters())
        embed = sum(p.numel() for n, p in net0.named_parameters()
                    if "embed" in n and "embed_ln" not in n)
        n_layers = sum(1 for n, _ in net0.named_parameters()
                       if n.endswith("attention.query_proj.weight"))
        vocab, units = net0.bert.word_embed.weight.shape
        del net0
        rs = np.random.RandomState(3)     # phase 6's batch
        x = rs.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
        y = rs.randint(0, 2, (TRAIN_BATCH,)).astype(np.float32)
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        loss_fn = SoftmaxCrossEntropyLoss()

        def build():
            net = _tele_make(dev)
            load_jax_params(net, init)
            net.train()
            torch.manual_seed(0)            # the dropout masks
            return net, Trainer(dict(net.named_parameters()), "adam",
                                {"learning_rate": TRAIN_LR}), loss_fn

        expect = {n: 0 for n in K.KERNELS}
        expect.update(flash_fwd=12, flash_bwd_fused=12, layernorm_fwd=25,
                      layernorm_bwd=25, opt_update=1)
        runs, report = {}, {"dtype": dt}

        def leg(key, value):
            report[key] = value
            emit({"telemetry_leg": {"dtype": dt, key: value}})

        ckdir = os.path.join(BUILD_TELE, f"ckpt_{dt}")
        for name, mode in (("off_a", None), ("off_b", None),
                           ("global", "global"), ("per_layer", "per_layer")):
            tel.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loop, losses, vals, counts = _tele_run(
                torch, K, dev, build, xt, yt, mode, TELE_STEPS,
                ckpt=ckdir if name == "global" else None)
            per_step = {n: c / TELE_STEPS for n, c in counts.items()}
            runs[name] = {"losses": losses, "weights": [
                p.detach().clone() for p in loop.trainer._params],
                "vals": vals, "launches": per_step,
                "n_traces": loop.compiled_step.n_traces,
                "peak": torch.cuda.max_memory_allocated(),
                "anomalies": len(tel.watchdog().anomalies())}
            if name == "global":
                report["checkpoint"] = {
                    "saves": tel.value(tel.names.CHECKPOINT_SAVES),
                    "capture_count": tel.value(
                        tel.names.CHECKPOINT_CAPTURE_SECONDS),
                    "prefetch_batches": tel.value(
                        tel.names.PREFETCH_BATCHES),
                    "train_steps": tel.value(tel.names.TRAIN_STEPS)}
            emit({"telemetry_run": {"dtype": dt, "run": name, **{
                k: v for k, v in runs[name].items()
                if k in ("launches", "n_traces", "peak", "anomalies")}}})
            if name == "off_b":
                leg("turns", tele_turns(torch, loop, xt, yt))
            if name == "per_layer" and not bf16:
                # the run without a checkpoint manager: no capture in
                # flight during the memory leg
                leg("norms_vs_float64", tele_norm_check(
                    torch, dev, build, loop, xt, yt, TRAIN_BATCH))
                leg("flops", tele_flops(torch, K, loop, xt, yt,
                                        n_all - embed, n_layers, units))
                leg("memory", tele_memory(torch, dev, loop, xt, yt))
            del loop
            torch.cuda.empty_cache()
        spread = (_tele_dist(runs["off_a"]["losses"],
                             runs["off_b"]["losses"]),
                  _tele_dist(runs["off_a"]["weights"],
                             runs["off_b"]["weights"]))
        eq = {}
        for name in ("global", "per_layer"):
            d = (_tele_dist(runs[name]["losses"], runs["off_a"]["losses"]),
                 _tele_dist(runs[name]["weights"], runs["off_a"]["weights"]))
            eq[name] = {"loss_dist": d[0], "weight_dist": d[1],
                        "bit_equal": d == (0.0, 0.0),
                        "ok": d[0] <= TELE_SPREAD_FACTOR * spread[0] and
                        d[1] <= TELE_SPREAD_FACTOR * spread[1]}
        report["vs_numerics_off"] = dict(eq, off_vs_off={
            "loss_dist": spread[0], "weight_dist": spread[1]},
            factor=TELE_SPREAD_FACTOR)
        report["launches_per_step"] = {n: {k: v for k, v in
                                           r["launches"].items() if v}
                                       for n, r in runs.items()}
        report["n_traces"] = {n: r["n_traces"] for n, r in runs.items()}
        report["peak_bytes"] = {n: r["peak"] for n, r in runs.items()}
        report["numerics_last"] = {n: {k: v for k, v in r["vals"].items()
                                       if k != "layer_grad_norm"}
                                   for n, r in runs.items() if r["vals"]}
        report["per_layer_top"] = sorted(
            runs["per_layer"]["vals"]["layer_grad_norm"].items(),
            key=lambda kv: -kv[1])[:4]
        leg("dense", tele_dense(torch, K, dev))
        if not bf16:
            # the anomaly channel does not depend on the dtype
            leg("nan", tele_nan(torch, K, dev, build, xt, yt,
                                int(x[0, 0])))
            leg("stall", tele_stall(torch, K, dev, build, xt, yt, faults))
        emit({"telemetry_train": report, "smi": smi})
        fails = [n for n, r in runs.items()
                 if r["launches"] != expect or r["n_traces"] != 1
                 or r["anomalies"]]
        fails += [n for n, e in eq.items() if not e["ok"]]
        if not all(r["vals"] and r["vals"]["step"] == TELE_STEPS
                   and r["vals"]["nonfinite_total"] == 0
                   for n, r in runs.items() if n in ("global",
                                                     "per_layer")):
            fails.append("numerics values missing")
        if report["checkpoint"]["saves"] != 1 or \
                report["checkpoint"]["prefetch_batches"] != TELE_STEPS:
            fails.append(f"checkpoint/prefetch {report['checkpoint']}")
        for leg in ("norms_vs_float64", "flops", "memory", "dense", "nan",
                    "stall", "turns"):
            if leg in report and not report[leg]["ok"]:
                fails.append(leg)
        if fails:
            raise SystemExit(f"phase 19a ({dt}) failed: {fails}")
        return {n: int(c * TELE_STEPS) for n, c in
                runs["global"]["launches"].items()}
    finally:
        if bf16:
            amp.uninit()


def tele_norm_check(torch, dev, build, loop, xt, yt, batch):
    """The reported norms of one more step against float64 on the card:
    the weights before it (param norm), the gradients an eager backward
    computes from those weights with the step's random state restored
    (grad norm: a replay draws what the eager step draws), and the
    weights' float64 difference across it (update norm)."""
    from mxnet_tpu_torch import telemetry as tel
    named = dict(loop._net.named_parameters())
    before = {n: p.detach().double().clone() for n, p in named.items()}
    rng = torch.cuda.get_rng_state(dev)
    loop.step(xt, yt)
    loop.synchronize()
    vals = tel.numerics.monitor().last()
    after_rng = torch.cuda.get_rng_state(dev)
    ref_net, _, loss_fn = build()
    with torch.no_grad():
        for n, p in ref_net.named_parameters():
            p.copy_(before[n])
    torch.cuda.set_rng_state(rng, dev)
    g = torch.autograd.grad(loss_fn(ref_net(xt), yt).sum(),
                            list(ref_net.parameters()))
    torch.cuda.set_rng_state(after_rng, dev)

    def norm(ts):
        return float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t.double()) for t in ts])))

    ref = {"grad_norm": norm(g) / batch,
           "param_norm": norm(before.values()),
           "update_norm": norm([p.detach().double() - before[n]
                                for n, p in named.items()])}
    rel = {k: abs(vals[k] - v) / v for k, v in ref.items()}
    del ref_net, g
    return {"reported": {k: vals[k] for k in ref}, "float64": ref,
            "rel_err": rel, "rtol": TELE_NORM_RTOL,
            "ok": rel["grad_norm"] <= TELE_NORM_RTOL
            and rel["param_norm"] <= TELE_NORM_RTOL}


def tele_flops(torch, K, loop, xt, yt, n_weights, n_layers, units):
    """``arm_mfu``'s FLOPs a step against 6 x non-embedding weights x
    tokens + 12 x layers x tokens x S x d_model."""
    from mxnet_tpu_torch import telemetry as tel
    flops = loop.arm_mfu(xt, yt, peak_flops=PEAK_FLOPS["float32"])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    analytic = 6.0 * n_weights * tokens + 12.0 * n_layers * tokens * \
        TRAIN_SEQ * units
    # the gauge is set at each retire from the retire-to-retire time: read
    # it while the loop is pipelined (the drain's retires follow each other
    # at once)
    for _ in range(TELE_STEPS):
        loop.step(xt, yt)
    mfu = tel.value(tel.names.MFU)
    fps = tel.value(tel.names.MODEL_FLOPS_PER_SEC)
    loop.synchronize()
    return {"step_flops": flops, "analytic": analytic,
            "rel": abs(flops - analytic) / analytic,
            "peak_flops": PEAK_FLOPS["float32"],
            "flops_per_sec": fps, "mfu": mfu,
            "ok": abs(flops - analytic) <= TELE_FLOPS_RTOL * analytic
            and mfu is not None and 0 < mfu <= 1}


def tele_memory(torch, dev, loop, xt, yt):
    """Phase 19b: the census against the allocator with a live loop; a
    budget below use gives exactly one ``memory_budget`` anomaly; an
    allocation past the free bytes inside an ``oom_guard`` seam exactly
    one ``oom`` anomaly and one dump naming the largest pool, the same
    error re-raised and the process carrying on."""
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.telemetry import memory as tmem
    tr = loop.trainer
    loop.compiled_step.optimizer_state_bytes()        # (re)files the states
    rec = tmem.census().publish()
    by = tmem.census().device_bytes_by_pool(dev)
    params = sum(tmem.device_bytes(p) for p in tr._all_params)
    states = sum(tmem.device_bytes(s) for st in tr._updater.states.values()
                 for s in tr._optimizer.state_tensors(st))
    alloc = torch.cuda.memory_allocated(dev)
    out = {"by_pool": by, "allocated": alloc,
           "untracked_bytes": tel.value(tel.names.MEM_UNTRACKED_BYTES),
           "devices": rec["devices"],
           "memory_report": (loop.compiled_step.memory_report().to_dict()
                             if loop.compiled_step.memory_report() else None),
           "census_ok": by["params"] == params and
           by["optimizer"] == states and
           rec["devices"].get(str(dev), {"tracked": 0})["tracked"] <= alloc}
    tel.reset()
    os.environ["MXNET_MEMORY_BUDGET"] = str(alloc // 2)
    try:
        for _ in range(3):
            loop.step(xt, yt)
        loop.synchronize()
    finally:
        del os.environ["MXNET_MEMORY_BUDGET"]
    out["budget_anomalies"] = len(tel.watchdog().anomalies("memory_budget"))
    tel.reset()
    dump = os.path.join(BUILD_TELE, "oom")
    os.environ["MXNET_MEMORY_DUMP_DIR"] = dump
    # past the free bytes and the allocator's cached ones: the card's total
    free, total = torch.cuda.mem_get_info(dev)
    err = None
    try:
        with tmem.oom_guard("phase 19b"), tmem.oom_guard("inner seam"):
            torch.empty(int(total) + (1 << 30), dtype=torch.uint8,
                        device=dev)
    except torch.cuda.OutOfMemoryError as e:
        err = e
    finally:
        del os.environ["MXNET_MEMORY_DUMP_DIR"]
    files = sorted(os.listdir(dump)) if os.path.isdir(dump) else []
    named = None
    if files:
        with open(os.path.join(dump, files[0])) as f:
            named = json.load(f).get("largest_pool")
    torch.zeros(1, device=dev).add_(1)
    torch.cuda.synchronize()
    out.update(oom_anomalies=len(tel.watchdog().anomalies("oom")),
               oom_dumps=len(files), oom_largest_pool=named,
               oom_reraised=isinstance(err, torch.cuda.OutOfMemoryError))
    out["ok"] = out["census_ok"] and out["budget_anomalies"] == 1 and \
        out["oom_anomalies"] == 1 and out["oom_dumps"] == 1 and \
        named == max(by, key=by.get) and out["oom_reraised"]
    tel.reset()
    return out


def tele_dense(torch, K, dev):
    """The Dense leg (phase 8b's model, every kernel deterministic): the
    losses and weights with numerics global and per_layer bit-equal to
    numerics off, one ``opt_update`` a step, nothing captured after the
    warm-up."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.nn import Dense
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(DENSE_ROWS, 768, generator=g, device=dev)
    y = torch.randint(0, 2, (DENSE_ROWS,), generator=g, device=dev).float()

    def build():
        init = torch.Generator().manual_seed(5)
        net = torch.nn.Sequential(
            Dense(3072, activation="relu", in_units=768, device=dev,
                  generator=init),
            Dense(768, in_units=3072, device=dev, generator=init),
            Dense(2, in_units=768, device=dev, generator=init))
        return net, Trainer(dict(net.named_parameters()), "adam",
                            {"learning_rate": 1e-3}), \
            SoftmaxCrossEntropyLoss()

    res = {}
    for mode in (None, "global", "per_layer"):
        loop, losses, vals, counts = _tele_run(torch, K, dev, build, x, y,
                                               mode, TELE_STEPS)
        res[mode] = (losses, [p.detach().clone()
                              for p in loop.trainer._params], counts,
                     loop.compiled_step.n_traces)
        del loop
    ref = res[None]
    out = {m: {"bit_equal": all(torch.equal(a, b) for a, b in
                                zip(r[0] + r[1], ref[0] + ref[1])),
               "opt_update": r[2]["opt_update"], "n_traces": r[3]}
           for m, r in res.items() if m}
    out["ok"] = all(v["bit_equal"] and v["opt_update"] == TELE_STEPS and
                    v["n_traces"] == 1 for v in out.values())
    return out


def tele_nan(torch, K, dev, build, xt, yt, token):
    """One non-finite weight planted before step TELE_NAN_AT (a word
    embedding row the batch reads): exactly one ``nan_loss`` anomaly at
    that step, one ``nonfinite_grad`` episode and one numerics dump."""
    from mxnet_tpu_torch import telemetry as tel
    tel.reset()
    dump = os.path.join(BUILD_TELE, "numerics")
    os.environ["MXNET_NUMERICS_DUMP_DIR"] = dump

    def poison(i, net):
        if i == TELE_NAN_AT:
            with torch.no_grad():
                net.bert.word_embed.weight[token].fill_(float("nan"))

    try:
        loop, _, _, _ = _tele_run(torch, K, dev, build, xt, yt, "global",
                                  TELE_STEPS, before_step=poison)
    finally:
        del os.environ["MXNET_NUMERICS_DUMP_DIR"]
    nan = tel.watchdog().anomalies("nan_loss")
    nfg = tel.watchdog().anomalies("nonfinite_grad")
    files = os.listdir(dump) if os.path.isdir(dump) else []
    op = None
    if files:
        with open(os.path.join(dump, files[0])) as f:
            op = json.load(f).get("offending_op")
    del loop
    torch.cuda.empty_cache()
    out = {"nan_loss": [e["step"] for e in nan],
           "nonfinite_grad": [e["step"] for e in nfg], "dumps": len(files),
           "offending_op": op}
    out["ok"] = out["nan_loss"] == [TELE_NAN_AT] and \
        out["nonfinite_grad"] == [TELE_NAN_AT] and out["dumps"] == 1
    tel.reset()
    return out


def tele_stall(torch, K, dev, build, xt, yt, faults):
    """One slow retire (``testing/faults.py``: a delay at the retire of
    step TELE_STALL_AT): exactly one ``stall`` anomaly, at that step."""
    from mxnet_tpu_torch import telemetry as tel
    tel.reset()
    # the retire of step s is the window's (s - 1)th hit + the capture's
    # none: TrainLoop's window retires step s at push s + 2 (inflight 2)
    faults.configure(f"window.retire:before={TELE_STALL_AT}:delay:"
                     f"{TELE_STALL_MS}")
    try:
        loop, _, _, _ = _tele_run(torch, K, dev, build, xt, yt, None,
                                  TELE_STALL_STEPS, sync_check=False)
    finally:
        faults.configure(None)
    ev = tel.watchdog().anomalies("stall")
    del loop
    torch.cuda.empty_cache()
    out = {"stall": [e["step"] for e in ev],
           "messages": [e["message"] for e in ev]}
    out["ok"] = out["stall"] == [TELE_STALL_AT]
    tel.reset()
    return out


def tele_turns(torch, loop, xt, yt):
    """Step ms (wall, synchronized, median of TELE_TIMED_STEPS) of one
    numerics-off loop with telemetry and numerics ``global`` on
    (``set_numerics``: a program of its own, captured first, in the same
    graph pool) against both off, in turns (off, on, on, off), each
    turn's peak memory beside it; printed, not gated."""
    from mxnet_tpu_torch import telemetry as tel
    step = loop.compiled_step
    step.set_numerics("global")
    step.aot_compile(xt, yt)
    out = []
    for on in (False, True, True, False):
        tel.enable(on)
        step.set_numerics("global" if on else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(TELE_TIMED_STEPS):
            t0 = time.perf_counter()
            loop.step(xt, yt)
            loop.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out.append({"telemetry_numerics": on,
                    "step_ms": statistics.median(ms),
                    "max_memory_allocated": torch.cuda.max_memory_allocated()})
    tel.enable(True)
    on = [t["step_ms"] for t in out if t["telemetry_numerics"]]
    off = [t["step_ms"] for t in out if not t["telemetry_numerics"]]
    return {"turns": out, "n_traces": step.n_traces,
            "overhead_ms": statistics.mean(on) - statistics.mean(off),
            "overhead_rel": statistics.mean(on) / statistics.mean(off) - 1,
            "ok": step.n_traces == 2}


def tele_serving(torch, np, K, dev, smi):
    """Phase 19c: phase 4's closed loop through ``DynamicBatcher`` (the
    ``mx_serving_*`` series against the batcher's own counts), then
    decode_wide through ``run_decode`` (``rnn_decode`` launched, the
    decode series against the run's tokens, the KV cache's census bytes
    against the allocator's blocks)."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.serving import loadgen
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.serving import decode as sdecode
    from mxnet_tpu_torch.telemetry import memory as tmem
    net = BERTClassifier(bert_base(device=dev), num_classes=2, device=dev)
    load_jax_params(net, init_params_numpy(net, seed=0))
    pred = serving.predictor_for(net, dtype="float32", device=dev)
    rs = np.random.RandomState(0)
    vocab = net.bert.word_embed.weight.shape[0]
    pred.warmup(rs.randint(0, vocab, (1, SERVE_SEQ)).astype(np.int64))
    reqs = [rs.randint(0, vocab, (int(rs.randint(1, 9)), SERVE_SEQ))
            .astype(np.int64) for _ in range(SERVE_REQUESTS)]
    tel.reset()
    K.reset_launch_counts()
    with serving.DynamicBatcher(pred, max_batch=SERVE_MAX_BATCH,
                                timeout_ms=2.0) as b:
        rep = loadgen.run_closed_loop(
            lambda i: b.submit(reqs[i]).result(120), SERVE_CLIENTS,
            SERVE_REQUESTS)
        stats = dict(b.stats)
    srv = {"requests": tel.value(tel.names.SERVING_REQUESTS),
           "batches": tel.value(tel.names.SERVING_BATCHES),
           "batcher_batches": stats["batches"],
           "request_seconds_count": tel.value(tel.names.SERVING_LATENCY),
           "p99_ms": rep["p99_ms"], "errors": rep["errors"],
           "flash_fwd": K.launch_counts()["flash_fwd"]}
    srv["ok"] = srv["requests"] == SERVE_REQUESTS == \
        srv["request_seconds_count"] and \
        srv["batches"] == srv["batcher_batches"] and not rep["errors"] \
        and srv["flash_fwd"] == 12 * stats["batches"]
    del pred, net
    torch.cuda.empty_cache()

    caches = []

    class Recorded(sdecode.PagedKVCache):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            caches.append(self)

    model = serving.TinyDecoder(**DECODE_WIDE, seed=0, device=dev)
    prompts, mns, _ = decode_mix(np, DECODE_WIDE["vocab"], DECODE_REQUESTS,
                                 DECODE_PAGE)
    tel.reset()
    sdecode.PagedKVCache = Recorded
    try:
        drep, counts = decode_run(torch, K, model, prompts, mns)
    finally:
        sdecode.PagedKVCache = Recorded.__mro__[1]
    kv = caches[-1]
    blocks = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for blk in seg["blocks"]:
            addr = blk.get("address", addr)
            blocks[addr] = blk
            addr += blk["size"]
    pools = {}
    for name, t in (("k_pages", kv.k_pages), ("v_pages", kv.v_pages)):
        blk = blocks.get(t.data_ptr(), {})
        pools[name] = {"census": tmem.device_bytes(t),
                       "allocator_requested": blk.get("requested_size"),
                       "allocator_block": blk.get("size")}
    census_kv = tmem.census().device_bytes_by_pool(dev)["kvcache"]
    dec = {"tokens": drep["tokens"], "rnn_decode": counts["rnn_decode"],
           "decode_tokens_total": tel.value(tel.names.DECODE_TOKENS),
           "kv_pages": tel.registry().gauge(tel.names.DECODE_KV_PAGES)
           .values(), "pools": pools, "census_kvcache": census_kv,
           "kv_total_bytes": kv.total_bytes(), "errors": drep["errors"]}
    # the allocator's record of each pool: the bytes it was asked for
    # (its block rounds them up to 512-byte multiples)
    dec["ok"] = dec["rnn_decode"] > 0 and not drep["errors"] and \
        dec["decode_tokens_total"] == drep["tokens"] and \
        census_kv == kv.total_bytes() and all(
            p["census"] == p["allocator_requested"]
            for p in pools.values())
    emit({"telemetry_serving": {"batcher": srv, "decode_wide": dec},
          "smi": smi})
    if not (srv["ok"] and dec["ok"]):
        raise SystemExit(f"phase 19c failed: {srv} {dec}")
    return {"flash_fwd": srv["flash_fwd"], "rnn_decode": dec["rnn_decode"]}


def tele_export(torch, np, K, dev, smi):
    """Phase 19d: ``write_prometheus`` holds every catalog series; a
    profiler Chrome trace of two captured BERT steps holds the ops of the
    funnel and the ``step`` spans."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.gluon import Trainer, TrainLoop
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    path = tel.write_prometheus(os.path.join(BUILD_TELE, "mx.prom"))
    with open(path) as f:
        text = f.read()
    missing = [n for n in tel.names.CATALOG if f"# TYPE {n} " not in text]
    net = _tele_make(dev)
    tr = Trainer(dict(net.named_parameters()), "adam",
                 {"learning_rate": TRAIN_LR})
    loop = TrainLoop(net, tr, SoftmaxCrossEntropyLoss(), inflight=2)
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = torch.from_numpy(rs.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ))) \
        .to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (TRAIN_BATCH,)).astype(
        np.float32)).to(dev)
    trace = os.path.join(BUILD_TELE, "profile.json")
    profiler.set_config(filename=trace)
    # the first step captures its program inside the trace: its warm-up
    # runs the funnel's ops; the second replays it
    profiler.set_state("run")
    try:
        for _ in range(2):
            loop.step(x, y)
        loop.synchronize()
    finally:
        profiler.set_state("stop")
    profiler.dump()
    with open(trace) as f:
        evs = json.load(f)["traceEvents"]
    steps = sorted({e["args"]["step"] for e in evs if e["cat"] == "step"})
    ops = sorted({e["name"] for e in evs if e["cat"] == "operator"})
    spans = sorted({e["args"]["phase"] for e in evs if e["cat"] == "step"})
    out = {"prometheus_series": len(tel.names.CATALOG) - len(missing),
           "catalog": len(tel.names.CATALOG), "missing": missing,
           "trace_events": len(evs), "step_span_steps": steps,
           "step_spans": spans, "ops": ops}
    out["ok"] = not missing and steps == [1, 2] and bool(ops) and \
        spans == ["dispatch", "retire", "window"]
    emit({"telemetry_export": out, "smi": smi})
    del loop, net, tr
    if not out["ok"]:
        raise SystemExit(f"phase 19d failed: {out}")


def telemetry_phase(torch, np, K, dev, smi):
    """Phase 19: the telemetry layer with telemetry on: 19a BERT-base
    training in float32 then bf16 amp, 19b memory (inside 19a's float32
    run), 19c serving and decode_wide, 19d export. Returns the launches of
    its paths by kernel."""
    import shutil
    from mxnet_tpu_torch import telemetry as tel
    t0 = time.perf_counter()
    shutil.rmtree(BUILD_TELE, ignore_errors=True)
    os.makedirs(BUILD_TELE)
    tel.enable(True)
    try:
        launches = tele_train(torch, np, K, dev, smi)
        torch.cuda.empty_cache()
        bf = tele_train(torch, np, K, dev, smi, bf16=True)
        torch.cuda.empty_cache()
        for k, v in bf.items():
            launches[k] = launches.get(k, 0) + v
        for k, v in tele_serving(torch, np, K, dev, smi).items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
        tele_export(torch, np, K, dev, smi)
    finally:
        tel.enable(None)
        shutil.rmtree(BUILD_TELE, ignore_errors=True)
    emit({"telemetry_phase_s": time.perf_counter() - t0,
          "telemetry_launch_counts": {k: v for k, v in launches.items()
                                      if v}})
    return launches


# ---------------------------------------------------------------------------
# phase 20: the autotuner (tuning/) at full width
# ---------------------------------------------------------------------------

TUNE_DIR = os.path.join("build", "chip_tuning")
TUNE_BERT_BUDGET = 8        # trials of the BERT-base search
TUNE_LM_BUDGET = 8          # trials of the LM search
TUNE_SERVE_BUDGET = 48      # trials of the serving search
TUNE_TURN_STEPS = 5         # steps a timed turn, tuned and untuned
TUNE_SERVE_REQUESTS = 64    # requests a closed-loop turn
#: decode_leg's non-default point of the decode.* space
TUNE_DECODE_POINT = {"decode.prefill_chunk": 32, "decode.spec_k": 2,
                     "decode.prefix_share": 0}
TUNE_KERNELS = ("flash_fwd", "flash_bwd_fused", "layernorm_fwd",
                "layernorm_bwd", "rnn_scan_fwd", "rnn_scan_bwd",
                "rnn_decode", "opt_update")


class _TuneEnv:
    """The tuner's env for one leg (its cache file and trial budget), put
    back on exit; the tuned overrides are cleared on both sides."""

    def __init__(self, budget):
        self._set = {"MXNET_AUTOTUNE_CACHE": os.path.join(TUNE_DIR,
                                                          "autotune.json"),
                     "MXNET_AUTOTUNE_BUDGET_TRIALS": str(budget)}

    def __enter__(self):
        from mxnet_tpu_torch.tuning import space
        space.clear_overrides()
        self._old = {k: os.environ.get(k) for k in self._set}
        os.environ.update(self._set)
        for k in ("MXNET_AUTOTUNE", "MXNET_AUTOTUNE_BACKEND"):
            os.environ.pop(k, None)
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.tuning import space
        space.clear_overrides()
        for k, v in self._old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def tune_counts(tel, backend):
    return {"trials": tel.value(tel.names.AUTOTUNE_TRIALS, backend) or 0.0,
            "hits": tel.value(tel.names.AUTOTUNE_CACHE_HITS) or 0.0,
            "misses": tel.value(tel.names.AUTOTUNE_CACHE_MISSES) or 0.0}


def tune_gates(out, budget, counted, rec):
    """The search's own gates: it ran on the card's timed backend (no
    fallback to the defaults), within the budget, and its trial count is
    the counter's and the kept record's."""
    return {"source_search": out.source == "search",
            "backend_timed": out.backend == "timed",
            "within_budget": 1 <= out.trials <= budget,
            "trials_counted": out.trials == counted
            == len(rec["trial_log"])}


def window_ms(torch, step, xt, yt, steps):
    """Wall ms a step over ``steps`` steps pushed through a dispatch
    window of the depth in force (``engine.inflight_steps``), timed to
    its drain."""
    from mxnet_tpu_torch import engine
    torch.cuda.synchronize()
    window = engine.DispatchWindow(lambda loss: loss.cpu(),
                                   max_inflight=engine.inflight_steps())
    t0 = time.perf_counter()
    for i in range(steps):
        window.push(step(xt, yt), tag=i)
    window.drain()
    return (time.perf_counter() - t0) * 1e3 / steps


def tuning_bert(torch, np, K, dev, smi):
    """Phase 20a: BERT-base training (32 x 512, Adam, float32) through
    ``compile_step(autotune="on")``; the search runs on the timed backend
    within TUNE_BERT_BUDGET trials. Gates: the search's own
    (:func:`tune_gates`); weights, Adam states, update counts and the
    card's generator bit-equal to the snapshot taken before it; 12 / 12 /
    25 / 25 / 1 launches a step of the tuned step; then step ms tuned and
    untuned (the defaults in force) in turns; then a second step of the
    same signature under ``autotune="cached"``: source "cache", no trial,
    the same config, one cache hit. Returns the launches of the tuned
    step's steps."""
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch import tuning
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.tuning import space

    def make():
        net = BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=0.1,
                                       device=dev),
                             num_classes=2, dropout=0.1, device=dev)
        load_jax_params(net, init)
        net.train()
        return net, Trainer(dict(net.named_parameters()), "adam",
                            {"learning_rate": TRAIN_LR})

    t0 = time.perf_counter()
    net = BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=0.1,
                                   device=dev),
                         num_classes=2, dropout=0.1, device=dev)
    init = init_params_numpy(net, seed=2)
    del net
    rs = np.random.RandomState(3)
    x = rs.randint(0, BERT_VOCAB, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    y = rs.randint(0, 2, (TRAIN_BATCH,)).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    with _TuneEnv(TUNE_BERT_BUDGET):
        net, tr = make()
        step = tr.compile_step(lambda a, b: loss_fn(net(a), b),
                               autotune="on")
        torch.manual_seed(0)
        opt = tr._optimizer
        states = [tr._updater._state_for(i, p)
                  for i, p in enumerate(tr._params)]
        before = ([p.detach().clone() for p in net.parameters()],
                  [s.clone() for st in states for s in opt.state_tensors(st)],
                  (opt.num_update, dict(opt._index_update_count)),
                  torch.cuda.get_rng_state(dev))
        c0 = tune_counts(tel, "timed")
        t1 = time.perf_counter()
        out = step.autotune(xt, yt)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t1
        c1 = tune_counts(tel, "timed")
        rec = tuning.default_cache().get(out.key)
        after = ([p.detach() for p in net.parameters()],
                 [s for st in states for s in opt.state_tensors(st)],
                 (opt.num_update, dict(opt._index_update_count)),
                 torch.cuda.get_rng_state(dev))
        restored = {
            "weights": all(torch.equal(a, b)
                           for a, b in zip(before[0], after[0])),
            "optimizer_states": all(torch.equal(a, b)
                                    for a, b in zip(before[1], after[1])),
            "update_counts": before[2] == after[2],
            "rng": torch.equal(before[3], after[3])}
        del before
        gates = tune_gates(out, TUNE_BERT_BUDGET,
                           c1["trials"] - c0["trials"], rec)
        # the tuned step: captured, then counted a step
        step.aot_compile(xt, yt)
        per_step = []
        K.reset_launch_counts()
        for _ in range(2):
            b0 = K.launch_counts()
            step(xt, yt)
            torch.cuda.synchronize()
            per_step.append({n: c for n, c in step_launches(K, b0).items()
                             if c})
        expect = {"flash_fwd": 12, "flash_bwd_fused": 12,
                  "layernorm_fwd": 25, "layernorm_bwd": 25, "opt_update": 1}
        launches = dict(K.launch_counts())     # the two steps'
        # step ms, tuned and untuned (the defaults in force), in turns
        net0, tr0 = make()
        step0 = tr0.compile_step(lambda a, b: loss_fn(net0(a), b),
                                 autotune="off")
        defaults = space.SearchSpace("train").defaults()
        with space.trial(defaults):
            step0.aot_compile(xt, yt)
        turns = {"tuned": [], "untuned": []}
        for what in ("tuned", "untuned", "untuned", "tuned"):
            if what == "tuned":
                turns[what].append(window_ms(torch, step, xt, yt,
                                             TUNE_TURN_STEPS))
            else:
                with space.trial(defaults):
                    turns[what].append(window_ms(torch, step0, xt, yt,
                                                 TUNE_TURN_STEPS))
        # a second step of the same signature replays the kept winner
        space.clear_overrides()
        cached = tr0.compile_step(lambda a, b: loss_fn(net0(a), b),
                                  autotune="cached")
        h0 = tune_counts(tel, "timed")
        out_c = cached.autotune(xt, yt)
        h1 = tune_counts(tel, "timed")
        cache_ok = (out_c.source == "cache" and out_c.trials == 0
                    and out_c.config == out.config
                    and h1["hits"] - h0["hits"] == 1
                    and h1["trials"] == h0["trials"])
    report = {
        "outcome": out.to_dict(), "score_s": out.score,
        "default_score_s": out.default_score, "delta_pct": out.delta_pct,
        "trials": out.trials, "budget": TUNE_BERT_BUDGET,
        "trial_counter": c1["trials"] - c0["trials"],
        "trial_log": [(t["config"].get("engine.inflight_steps"),
                       t["score"], t["fidelity"]) for t in rec["trial_log"]],
        "search_s": search_s, "restored": restored,
        "launches_per_step": per_step, "launches_expected": expect,
        "step_ms_turns": turns,
        "tuned_ms": statistics.median(turns["tuned"]),
        "untuned_ms": statistics.median(turns["untuned"]),
        "cached": out_c.to_dict(), "cached_ok": cache_ok,
        "setup_s": time.perf_counter() - t0, "card": smi}
    ok = all(gates.values()) and all(restored.values()) and \
        all(s == expect for s in per_step) and cache_ok
    report.update(gates=gates, ok=ok)
    emit({"tuning_bert": report})
    del step, step0, cached, net, net0, tr, tr0
    if not ok:
        raise SystemExit(f"phase 20a failed: {report}")
    return launches


def tuning_lm(torch, np, K, dev, smi):
    """Phase 20b: the LSTM LM (phase 8's widths, SGD momentum) tuned on
    the timed backend, then LM_STEPS steps; the same steps from the same
    weights and generator untuned (the defaults in force) and under a
    kernel budget that moves the recurrence forward's plan
    (``kernels.vmem_tile_budget`` 96 KiB). Replays are deterministic, so
    losses and weights must be bit-equal across the three. Returns the
    launches of the tuned run's steps."""
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch import tuning
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import WordLM
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.ops.kernels import rnn_scan as KR
    from mxnet_tpu_torch.tuning import space

    net = WordLM(LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS, device=dev)
    init = init_params_numpy(net, seed=6)
    rs = np.random.RandomState(7)
    x = rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT)).astype(np.int64)
    y = rs.randint(0, LM_VOCAB, (LM_BATCH, LM_BPTT)).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    budget_point = {"kernels.vmem_tile_budget": 96 * 1024}

    def run(autotune):
        load_jax_params(net, init)
        net.train()
        tr = Trainer(dict(net.named_parameters()), "sgd",
                     {"learning_rate": LM_LR, "momentum": 0.9})
        step = tr.compile_step(lambda a, b: loss_fn(net(a), b),
                               autotune=autotune)
        torch.manual_seed(0)
        out = step.autotune(xt, yt) if autotune == "on" else None
        step.aot_compile(xt, yt)
        b0 = K.launch_counts()
        losses = [step(xt, yt) for _ in range(LM_STEPS)]
        torch.cuda.synchronize()
        counts = step_launches(K, b0)
        return (out, [l.cpu() for l in losses],
                [p.detach().clone() for p in net.parameters()], counts)

    with _TuneEnv(TUNE_LM_BUDGET):
        c0 = tune_counts(tel, "timed")
        out, l_t, w_t, counts = run("on")
        c1 = tune_counts(tel, "timed")
        rec = tuning.default_cache().get(out.key)
        tuned = dict(out.config)
        defaults = space.SearchSpace("train").defaults()
        with space.trial(defaults):
            _, l_d, w_d, _ = run("off")
            plan_d = KR.rnn_fwd_plan(LM_BATCH, LM_HIDDEN, "lstm", device=dev)
        with space.trial(dict(defaults, **budget_point)):
            _, l_b, w_b, _ = run("off")
            plan_b = KR.rnn_fwd_plan(LM_BATCH, LM_HIDDEN, "lstm", device=dev)
    gates = tune_gates(out, TUNE_LM_BUDGET, c1["trials"] - c0["trials"], rec)

    def equal(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    expect = {"rnn_scan_fwd": LM_LAYERS * LM_STEPS,
              "rnn_scan_bwd": LM_LAYERS * LM_STEPS, "opt_update": LM_STEPS}
    report = {"outcome": out.to_dict(), "tuned": tuned,
              "delta_pct": out.delta_pct, "score_s": out.score,
              "default_score_s": out.default_score,
              "losses": [float(l.mean()) for l in l_t],
              "tuned_vs_default": {"losses": equal(l_t, l_d),
                                   "weights": equal(w_t, w_d)},
              "budget_point": budget_point,
              "budget_vs_default": {"losses": equal(l_b, l_d),
                                    "weights": equal(w_b, w_d)},
              "fwd_plan_default": plan_d, "fwd_plan_budget": plan_b,
              "launches": {n: c for n, c in counts.items() if c},
              "launches_expected": expect, "card": smi}
    ok = all(gates.values()) and \
        all(report["tuned_vs_default"].values()) and \
        all(report["budget_vs_default"].values()) and \
        {n: c for n, c in counts.items() if c} == expect
    report.update(gates=gates, ok=ok)
    emit({"tuning_lm": report})
    if not ok:
        raise SystemExit(f"phase 20b failed: {report}")
    return counts


def served_req_s(np, batcher, reqs):
    from mxnet_tpu_torch.serving import loadgen

    def issue(i):
        batcher.submit(reqs[i]).result(120)

    rep = loadgen.run_closed_loop(issue, SERVE_CLIENTS, len(reqs))
    if rep["errors"]:
        raise SystemExit(f"phase 20c: serving failed: {rep}")
    return rep["requests"] / rep["wall_s"]


def tuning_serving(torch, np, K, dev, smi):
    """Phase 20c: BERT-base served at sequence 128 through
    ``CompiledPredictor.warmup(autotune="on")`` (the timed backend, within
    TUNE_SERVE_BUDGET trials), then a ``DynamicBatcher`` built on the
    tuned knobs. Gates: the search's own; one micro-batch of ``max_batch``
    one-row requests through the tuned batcher bit-equal to an untuned
    predictor's replay of the same bucket; served req/s on the tuned
    batcher and on the default one (max_batch 32, 2 ms) in turns. Returns
    the launches of the micro-batch."""
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch import tuning
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.serving import (CompiledPredictor, DynamicBatcher,
                                         batcher as tbatcher)

    net = BERTClassifier(bert_base(device=dev), num_classes=2, device=dev)
    load_jax_params(net, init_params_numpy(net, seed=0))
    rs = np.random.RandomState(0)
    example = rs.randint(0, BERT_VOCAB, (1, SERVE_SEQ)).astype(np.int64)
    with _TuneEnv(TUNE_SERVE_BUDGET):
        pred = CompiledPredictor(net, device=dev)
        c0 = tune_counts(tel, "timed")
        t1 = time.perf_counter()
        flops = pred.warmup(example, autotune="on")
        warm_s = time.perf_counter() - t1
        c1 = tune_counts(tel, "timed")
        out = pred.autotune_result
        rec = tuning.default_cache().get(out.key)
        gates = tune_gates(out, TUNE_SERVE_BUDGET,
                           c1["trials"] - c0["trials"], rec)
        m, timeout_s = tbatcher.max_batch_rows(), tbatcher.batch_timeout_s()
        # one micro-batch of m one-row requests, against an untuned
        # predictor's replay of the same bucket
        reqs = [rs.randint(0, BERT_VOCAB, (1, SERVE_SEQ)).astype(np.int64)
                for _ in range(m)]
        plain = CompiledPredictor(net, device=dev)
        bucket = plain.bucket_for(m)
        plain.warmup(example, buckets=(bucket,), autotune="off")
        ref = plain.predict(*plain.pad_to_bucket(np.concatenate(reqs))[0])
        ref = ref[:m].cpu()
        b = DynamicBatcher(pred, start=False)
        K.reset_launch_counts()
        futs = [b.submit(r) for r in reqs]
        b.flush()
        got = torch.cat([f.result(60).cpu() for f in futs])
        launches = dict(K.launch_counts())
        b.close()
        bit_equal = bool(torch.equal(got, ref))
        traffic = [rs.randint(0, BERT_VOCAB, (int(rs.randint(1, 9)),
                                              SERVE_SEQ)).astype(np.int64)
                   for _ in range(TUNE_SERVE_REQUESTS)]
        turns = {"tuned": [], "default": []}
        for what in ("tuned", "default", "default", "tuned"):
            kw = {} if what == "tuned" else {"max_batch": SERVE_MAX_BATCH,
                                             "timeout_ms": 2.0}
            with DynamicBatcher(pred, **kw) as bb:
                turns[what].append(served_req_s(np, bb, traffic))
    report = {"outcome": out.to_dict(), "score_s": out.score,
              "default_score_s": out.default_score,
              "delta_pct": out.delta_pct, "max_batch": m,
              "timeout_ms": timeout_s * 1e3, "warmup_s": warm_s,
              "bucket_flops": {str(k): v for k, v in flops.items()},
              "micro_batch_bit_equal_untuned": bit_equal,
              "micro_batch_launches": {n: c for n, c in launches.items()
                                       if c},
              "req_per_s_turns": turns,
              "tuned_req_per_s": statistics.median(turns["tuned"]),
              "default_req_per_s": statistics.median(turns["default"]),
              "card": smi}
    ok = all(gates.values()) and bit_equal and \
        launches.get("flash_fwd") == 12 and \
        launches.get("layernorm_fwd") == 25
    report.update(gates=gates, ok=ok)
    emit({"tuning_serving": report})
    del pred, plain, net
    if not ok:
        raise SystemExit(f"phase 20c failed: {report}")
    return launches


def tuning_decode(torch, np, K, ATT, dev, smi):
    """Phase 20d: decode_leg (continuous) under TUNE_DECODE_POINT, a
    non-default point of the decode.* space that ``space.trial`` reaches
    (a 32-token prefill chunk, 2 draft tokens a step, no prefix sharing):
    its tokens against a CPU copy run under the same point, as phase 9
    holds them, and its rnn_decode launches (spec_k + 1 a step, the chunk
    width a prefill chunk). Returns the launches of the run."""
    from mxnet_tpu_torch.serving import TinyDecoder, decode
    from mxnet_tpu_torch.tuning import space
    model = TinyDecoder(**DECODE_LEG, seed=0, device=dev)
    cpu_model = TinyDecoder(**DECODE_LEG, seed=0, device="cpu")
    prompts, mns, _ = decode_mix(np, DECODE_LEG["vocab"], DECODE_REQUESTS,
                                 DECODE_PAGE)
    with space.trial(TUNE_DECODE_POINT):
        knobs = {"prefill_chunk": decode.prefill_chunk(),
                 "spec_k": decode.spec_k(),
                 "prefix_share": decode.prefix_share()}
        rep, counts = decode_run(torch, K, model, prompts, mns)
        ref = run_cpu_decode(cpu_model, prompts, mns)
    late = check_tokens(torch, ATT, "decode_leg at a tuned point vs CPU copy",
                        rep["tokens_by_request"], ref, cpu_model, prompts)
    want = (knobs["spec_k"] + 1) * rep["steps"] + \
        knobs["prefill_chunk"] * rep["prefill_chunks"]
    ok = rep["errors"] == 0 and rep["n_traces"] == 0 and \
        rep["launches"]["rnn_decode"] == want and late is None and \
        knobs == {"prefill_chunk": 32, "spec_k": 2, "prefix_share": False}
    decode_line("decode_tuned_point", rep, smi,
                {"point": TUNE_DECODE_POINT, "knobs": knobs,
                 "launches_expected": want,
                 "tokens_equal_cpu_copy": late is None, "ok": ok})
    if not ok:
        raise SystemExit(f"phase 20d failed: {rep['launches']} (expected "
                         f"{want}), knobs {knobs}, errors {rep['errors']}")
    return counts


def tuning_phase(torch, np, K, ATT, dev, smi):
    """Phase 20: the autotuner at full width: 20a BERT-base training,
    20b the LSTM LM, 20c BERT-base serving, 20d decode_leg at a tuned
    point. Returns the launches of its paths by kernel."""
    import shutil
    t0 = time.perf_counter()
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    os.makedirs(TUNE_DIR)
    launches = {}
    try:
        for part in (tuning_bert(torch, np, K, dev, smi),
                     tuning_lm(torch, np, K, dev, smi),
                     tuning_serving(torch, np, K, dev, smi),
                     tuning_decode(torch, np, K, ATT, dev, smi)):
            torch.cuda.empty_cache()
            for k, v in part.items():
                launches[k] = launches.get(k, 0) + v
    finally:
        shutil.rmtree(TUNE_DIR, ignore_errors=True)
    emit({"tuning_phase_s": time.perf_counter() - t0,
          "tuning_launch_counts": {k: v for k, v in launches.items() if v}})
    return launches


# ---------------------------------------------------------------------------
# phase 21: analysis/ at full width
# ---------------------------------------------------------------------------

#: the census's FLOPs against ``step_flops`` (the FlopCounterMode count
#: plus the kernels' own): the census adds the elementwise work and
#: counts the update at the JAX rule's 10 FLOPs an element (20 there)
ANALYSIS_FLOPS_RTOL = 0.05
ANALYSIS_TOP_CHAINS = 15    # stranded chains printed, by bytes
ANALYSIS_STEPS = 2          # captured steps counted after the analysis
#: per step of BERT-base training: its kernels' launches
ANALYSIS_EXPECT = {"flash_fwd": 12, "flash_bwd_fused": 12,
                   "layernorm_fwd": 25, "layernorm_bwd": 25,
                   "opt_update": 1}
ANALYSIS_KERNELS = ("flash_fwd", "flash_bwd_fused", "layernorm_fwd",
                    "layernorm_bwd", "rnn_decode", "opt_update")
ANALYSIS_ZERO_WORLD = 4     # 21c's cards
ANALYSIS_ZERO_TURNS = 6     # 21c's timed turns of each layout
ANALYSIS_ZERO_TURN_STEPS = 3   # steps a turn
LOCK_HIERARCHY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "fixtures",
                              "torch_lock_hierarchy.json")


def report_facts(rep):
    """A ProgramReport's gated numbers."""
    return {"ok": rep.ok,
            "collectives": rep.collectives.by_kind,
            "host_transfers": len([f for f in rep.host_transfers
                                   if not f.blessed]),
            "dtype_drift_unblessed": len([f for f in rep.dtype_drift
                                          if not f.blessed]),
            "dtype_drift_blessed": len([f for f in rep.dtype_drift
                                        if f.blessed]),
            "donation": rep.donation.to_dict() | {"copied":
                                                  len(rep.donation.copied)},
            "n_traces": rep.n_traces,
            "error_findings": [str(f) for f in
                               rep.all_findings(min_severity="error")]}


def census_facts(fr):
    """The kernel census's headline numbers and its largest stranded
    chains by bytes (the split of a step's elementwise 'other' time)."""
    by_name = {}
    for s in fr.stranded:
        by_name[s.opcode] = by_name.get(s.opcode, 0) + s.bytes
    return {"kernels": fr.n_kernels, "by_kind": fr.by_kind(),
            "flops": fr.total_flops, "flops_by_kind": fr.flops_by_kind(),
            "stranded": len(fr.stranded),
            "stranded_bytes": fr.stranded_bytes,
            "boundary_bytes": fr.boundary_bytes,
            "stranded_bytes_by_op": dict(sorted(
                by_name.items(), key=lambda kv: -kv[1])[:12]),
            "top_stranded_chains": fr.stranded_chains(ANALYSIS_TOP_CHAINS)}


def analysis_bert(torch, np, K, dev, smi, bf16=False):
    """Phase 21a: BERT-base training (TRAIN_BATCH x TRAIN_SEQ, Adam),
    float32 or under bf16 amp, through ``compile_step(analyze="raise")``.
    The step is captured (``aot_compile``), then ``step.analyze`` records
    one run of the step's body before the first step; the weights, Adam
    states, update counts, the card's generator and ``n_traces`` are
    held equal to a copy taken before it. Gates: the
    report clean (no collective, no host transfer, no unblessed dtype
    drift, all 201 parameters and their 402 Adam states updated in
    place); the census's FLOPs within ANALYSIS_FLOPS_RTOL of
    ``step_flops``; the first call's ``analyze="raise"`` finding
    nothing, ``n_traces`` 1 and ANALYSIS_EXPECT launches a step. Printed, not gated: the census's kernels, stranded
    ops and chains, and the record's kernel nodes beside the captured
    graph's. Returns the phase's launches."""
    from mxnet_tpu_torch import amp
    if bf16:
        amp.init("bfloat16")
        try:
            return analysis_bert(torch, np, K, dev, smi)
        finally:
            amp.uninit()
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    name = "analysis_bert_bf16" if amp.is_enabled() else "analysis_bert"
    t0 = time.perf_counter()
    net = BERTClassifier(bert_base(max_length=TRAIN_SEQ, dropout=0.1,
                                   device=dev),
                         num_classes=2, dropout=0.1, device=dev)
    load_jax_params(net, init_params_numpy(net, seed=2))
    net.train()
    rs = np.random.RandomState(3)
    x = rs.randint(0, BERT_VOCAB, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    y = rs.randint(0, 2, (TRAIN_BATCH,)).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    tr = Trainer(dict(net.named_parameters()), "adam",
                 {"learning_rate": TRAIN_LR})
    step = tr.compile_step(lambda a, b: loss_fn(net(a), b),
                           analyze="raise")
    torch.manual_seed(0)
    # the captured step first (its graph kept for debug_dump), then the
    # analysis before its first call
    step.aot_compile(xt, yt, debug_graph=True)
    opt = tr._optimizer
    states = [tr._updater._state_for(i, p) for i, p in enumerate(tr._params)]
    before = ([p.detach().clone() for p in net.parameters()],
              [s.clone() for st in states for s in opt.state_tensors(st)],
              (opt.num_update, dict(opt._index_update_count)),
              torch.cuda.get_rng_state(dev))
    K.reset_launch_counts()
    t1 = time.perf_counter()
    rep = step.analyze(xt, yt)
    torch.cuda.synchronize()
    analyze_s = time.perf_counter() - t1
    after = ([p.detach() for p in net.parameters()],
             [s for st in states for s in opt.state_tensors(st)],
             (opt.num_update, dict(opt._index_update_count)),
             torch.cuda.get_rng_state(dev))
    restored = {
        "weights": all(torch.equal(a, b)
                       for a, b in zip(before[0], after[0])),
        "optimizer_states": all(torch.equal(a, b)
                                for a, b in zip(before[1], after[1])),
        "update_counts": before[2] == after[2],
        "rng": torch.equal(before[3], after[3]),
        "n_traces_unmoved": step.n_traces == 1}
    del before, after
    launches = dict(K.launch_counts())
    flops = step.step_flops(xt, yt)
    census = rep.fusion.total_flops
    per_step = []
    K.reset_launch_counts()
    for _ in range(ANALYSIS_STEPS):
        b0 = K.launch_counts()
        step(xt, yt)
        torch.cuda.synchronize()
        per_step.append({n: c for n, c in step_launches(K, b0).items()
                         if c})
    for n, c in K.launch_counts().items():
        launches[n] = launches.get(n, 0) + c
    prog = next(iter(step._programs.programs()))
    graph_nodes = prog.graph_nodes(os.path.abspath(
        os.path.join("build", f"{name}_graph.dot")))
    facts = report_facts(rep)
    n_params = len(tr._params)
    n_states = sum(len(opt.state_tensors(st)) for st in states)
    d = rep.donation
    gates = {"clean": facts["ok"] and not facts["collectives"]
             and facts["host_transfers"] == 0
             and facts["dtype_drift_unblessed"] == 0,
             "donated_all": d.declared == d.aliased == n_params + n_states
             and not d.copied,
             "restored": all(restored.values()),
             "flops_vs_step_flops": abs(census / flops - 1.0)
             <= ANALYSIS_FLOPS_RTOL,
             "first_step_analysis": step.analysis_report is rep,
             "n_traces_1": step.n_traces == 1,
             "launches_per_step": all(s == ANALYSIS_EXPECT
                                      for s in per_step)}
    record = rep.fusion
    out = {"report": facts, "summary": rep.summary().splitlines()[:9],
           "census": census_facts(record),
           "census_flops": census, "step_flops": flops,
           "flops_ratio": census / flops, "restored": restored,
           "analyze_s": analyze_s, "n_params": n_params,
           "n_states": n_states, "launches_per_step": per_step,
           "launches_expected": ANALYSIS_EXPECT,
           "record_kernel_nodes": record.n_kernels,
           "record_hand_written": record.by_kind().get("custom", 0),
           "graph_nodes": graph_nodes,
           "setup_s": time.perf_counter() - t0, "card": smi,
           "gates": gates, "ok": all(gates.values())}
    emit({name: out})
    del step, net, tr, states, prog
    if not out["ok"]:
        raise SystemExit(f"phase 21a failed ({name}): {gates}")
    return launches


def analysis_serving(torch, np, K, dev, smi):
    """Phase 21b: served BERT-base at bucket SERVE_MAX_BATCH
    (``CompiledPredictor(analyze="raise")``: its first request records the
    bucket's forward and lints it) and decode_wide's bucket-8 decode step
    (``DecodeEngine.analyze``), each clean under the ``predict``
    expectations: no collective, no host transfer, no unblessed dtype
    drift, no error finding. Returns the phase's launches."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTClassifier, bert_base
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.serving import (CompiledPredictor, DecodeEngine,
                                         TinyDecoder)
    net = BERTClassifier(bert_base(device=dev), num_classes=2, device=dev)
    load_jax_params(net, init_params_numpy(net, seed=0))
    rs = np.random.RandomState(0)
    x = rs.randint(0, BERT_VOCAB, (SERVE_MAX_BATCH, SERVE_SEQ)) \
        .astype(np.int64)
    pred = CompiledPredictor(net, device=dev, analyze="raise")
    pred.warmup(x[:1], buckets=(SERVE_MAX_BATCH,))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    pred.predict(x)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    rep = pred.analysis_report
    model = TinyDecoder(**DECODE_WIDE, seed=0, device=dev)
    eng = DecodeEngine(model, start=False)
    t1 = time.perf_counter()
    drep = eng.analyze(batch_size=8)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    launches = dict(K.launch_counts())
    out = {}
    for what, r in (("serving_bucket_%d" % SERVE_MAX_BATCH, rep),
                    ("decode_wide_bucket_8", drep)):
        facts = report_facts(r)
        facts["clean"] = facts["ok"] and not facts["collectives"] and \
            facts["host_transfers"] == 0 and \
            facts["dtype_drift_unblessed"] == 0 and \
            not facts["error_findings"]
        facts["census"] = census_facts(r.fusion)
        out[what] = facts
    out.update(first_request_s=serve_s, decode_analyze_s=decode_s,
               launches={n: c for n, c in launches.items() if c}, card=smi)
    out["ok"] = all(v["clean"] for k, v in out.items()
                    if isinstance(v, dict) and "clean" in v) and \
        launches.get("rnn_decode", 0) > 0
    emit({"analysis_serving": out})
    eng.close()
    del pred, net, eng, model
    if not out["ok"]:
        raise SystemExit(f"phase 21b failed: {out}")
    return launches


def analysis_guard(torch, np, K, dev, smi):
    """Phase 21d, its first half: a loss with a planted ``.item()`` under
    ``MXNET_TRANSFER_GUARD=raise`` raises ``MXNetError`` naming the
    line; a clean ``TrainLoop`` stays quiet there, its only host syncs
    the window's retires, which ``mx_guard_host_syncs_total`` counts."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.analysis import guard
    from mxnet_tpu_torch.gluon import Trainer, TrainLoop
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.nn import Dense

    def make():
        torch.manual_seed(0)
        net = torch.nn.Sequential(Dense(64, in_units=32, activation="relu",
                                        device=dev),
                                  Dense(4, in_units=64, device=dev))
        return net, Trainer(dict(net.named_parameters()), "sgd",
                            {"learning_rate": 0.1})

    loss_fn = SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(0)
    xt = torch.from_numpy(rs.randn(16, 32).astype(np.float32)).to(dev)
    yt = torch.from_numpy(rs.randint(0, 4, (16,)).astype(np.float32)) \
        .to(dev)
    net, tr = make()

    def planted(a, b):
        loss = loss_fn(net(a), b)
        peek = loss.sum().item()   # the planted host sync
        return loss * (peek == peek)

    line = planted.__code__.co_firstlineno + 2
    prev = os.environ.get("MXNET_TRANSFER_GUARD")
    os.environ["MXNET_TRANSFER_GUARD"] = "raise"
    try:
        step = tr.compile_step(planted)
        raised = None
        try:
            step(xt, yt)
        except MXNetError as e:
            raised = str(e)
        net2, tr2 = make()
        loop = TrainLoop(net2, tr2, loss_fn, inflight=1)
        guard.reset_sync_counts()
        c0 = tel.value(tel.names.HOST_SYNCS, "window_retire") or 0.0
        for _ in range(4):
            loop.step(xt, yt)
        loop.synchronize()
        counts = guard.sync_counts()
        c1 = tel.value(tel.names.HOST_SYNCS, "window_retire") or 0.0
    finally:
        if prev is None:
            os.environ.pop("MXNET_TRANSFER_GUARD", None)
        else:
            os.environ["MXNET_TRANSFER_GUARD"] = prev
    where = f"chip_smoke.py:{line}"
    out = {"planted_raised": raised is not None,
           "names_line": raised is not None and where in raised,
           "message": (raised or "")[:240], "clean_loop_syncs": counts,
           "host_syncs_counted": c1 - c0, "card": smi}
    out["ok"] = (out["planted_raised"] and out["names_line"]
                 and set(counts) == {"window_retire"}
                 and counts["window_retire"] == c1 - c0 >= 4)
    emit({"analysis_guard": out})
    if not out["ok"]:
        raise SystemExit(f"phase 21d (guard) failed: {out}")


def analysis_locks(smi):
    """Phase 21d, its second half, after the whole run: the audited
    locks' order graph has no cycle and no edge outside
    ``tests/fixtures/torch_lock_hierarchy.json``."""
    from mxnet_tpu_torch.analysis import threads
    base = threads.load_baseline(LOCK_HIERARCHY)
    findings = threads.check_hierarchy(base)
    cycles = threads.find_cycles()
    out = {"locks": sorted({lk["name"] for lk in threads.describe_locks()}),
           "edges": sorted((e["from"], e["to"], e["count"])
                           for e in threads.graph().edges()),
           "cycles": cycles, "findings": [str(f) for f in findings],
           "card": smi}
    out["ok"] = not cycles and not findings
    emit({"analysis_locks": out})
    if not out["ok"]:
        raise SystemExit(f"phase 21d (lock order) failed: {out}")


def analysis_zero_rank(widths, batch, seq, lr, trace_dir, bucket_bytes,
                       turns=ANALYSIS_ZERO_TURNS):
    """Phase 21c, one rank: BERT-base (phase 11's model) under the dp
    mesh, serial (MXNET_ZERO_BUCKET_BYTES=0) and at ``bucket_bytes``
    (None: the default bucket), each layout its own net and step: one
    step, then ``step.analyze`` (the census, the overlap census), the
    plan's buckets and gathers, the analytical backend's score. Then the
    two layouts' whole steps timed in alternating turns (serial,
    bucketed, bucketed, serial, ...; ANALYSIS_ZERO_TURN_STEPS steps a
    turn, the card synchronized around each), and a ``torch.profiler``
    trace of one step of each on every rank: each NCCL kernel's time and
    the part of it no compute kernel of that rank overlaps, in issue
    order, so :func:`analysis_zero` can take each collective's least
    time over the ranks (its transfer; the rest of a rank's kernel is
    waiting for its peers)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.parallel import dist, make_mesh
    from mxnet_tpu_torch.tuning.measure import AnalyticalStepBackend

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dist.device()
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rank, world = dist.rank(), dist.size()
    net = bert_base_classifier(torch, seq, dev, widths)
    init = init_params_numpy(net, seed=2)
    rs = np.random.RandomState(3)
    vocab = net.bert.word_embed.weight.shape[0]
    x = torch.from_numpy(rs.randint(0, vocab, (batch, seq))
                         .astype(np.int64)).to(dev)
    y = torch.from_numpy(rs.randint(0, 2, (batch,))
                         .astype(np.float32)).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    runs, steps = {}, {}

    def traced(step, mode):
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as prof_cm
        with prof_cm(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(x, y)
            sync()
        path = os.path.join(trace_dir, f"analysis_{mode}_r{rank}.json")
        prof.export_chrome_trace(path)
        ivs = kernel_intervals(path)
        os.remove(path)
        nccl = sorted((a, b) for n, a, b in ivs if "nccl" in n.lower())
        compute = union([(a, b) for n, a, b in ivs
                         if "nccl" not in n.lower()])
        busy = union([(a, b) for _, a, b in ivs])
        span = (busy[-1][1] - busy[0][0]) if busy else 0.0
        # [kernel us, us no compute kernel overlaps] each, issue order;
        # the compute kernels' busy ms, and the ms from the first kernel
        # to the last in which no kernel ran (the card idle)
        return {"nccl": [[b - a, b - a - overlap_us([(a, b)], compute)]
                         for a, b in nccl],
                "compute_kernels": len(ivs) - len(nccl),
                "compute_busy_ms": sum(b - a for a, b in compute) / 1e3,
                "span_ms": span / 1e3,
                "idle_ms": (span - sum(b - a for a, b in busy)) / 1e3}

    for mode, bb in (("serial", "0"), ("bucketed", bucket_bytes)):
        if bb is None:
            os.environ.pop("MXNET_ZERO_BUCKET_BYTES", None)
        else:
            os.environ["MXNET_ZERO_BUCKET_BYTES"] = str(bb)
        if mode != "serial":
            net = bert_base_classifier(torch, seq, dev, widths)
        load_jax_params(net, init)
        tr = Trainer(dict(net.named_parameters()), "adam",
                     {"learning_rate": lr})
        step = tr.compile_step(
            lambda a, b, net=net: loss_fn(net(a), b))
        with make_mesh({"dp": world}):
            step(x, y)
            sync()
            t0 = time.perf_counter()
            rep = step.analyze(x, y)
            analyze_s = time.perf_counter() - t0
            plan = step.zero_plan
            bucket_rows = [sum(plan.units[k]["padded"] // world for k in b)
                           for b in step.buckets]
            gathers = step._zero_gather_sizes()
            score = AnalyticalStepBackend(step, (x, y)).measure({})
            # one more step under this layout's setting (the score's
            # probe may have rebuilt the plan)
            step(x, y)
            sync()
        steps[mode] = step
        ops = rep.collectives.ops
        runs[mode] = {
            "bucket_bytes": rep.overlap.zero_bucket_bytes,
            "census": rep.collectives.by_kind,
            "reduce_scatter_elements": [o.elements for o in ops
                                        if o.kind == "reduce_scatter"],
            "all_gather_elements": [o.elements for o in ops
                                    if o.kind == "all_gather"],
            "plan_bucket_rows": bucket_rows, "plan_gather_sizes": gathers,
            "units": len(plan.units), "buckets": len(step.buckets),
            "global_batch_loss_gather": batch,
            "overlap": rep.overlap.brief(),
            "exposed_comm_s": rep.overlap.exposed_comm_s,
            "comm_cost_s": rep.sharding.cost.total_s,
            "report_ok": rep.ok,
            "error_findings": [str(f) for f in
                               rep.all_findings(min_severity="error")],
            "donation": rep.donation.to_dict() | {"copied":
                                                  len(rep.donation.copied)},
            "analytical_score_s": score.score,
            "analytical_exposed_comm_s": score.detail.get("exposed_comm_s"),
            "analyze_s": analyze_s}
        del step, tr
    os.environ.pop("MXNET_ZERO_BUCKET_BYTES", None)
    with make_mesh({"dp": world}):
        step_ms = {m: [] for m in steps}
        issue_ms = {m: [] for m in steps}
        for t in range(turns):
            for mode in (("serial", "bucketed") if t % 2 == 0
                         else ("bucketed", "serial")):
                sync()
                t0 = time.perf_counter()
                for _ in range(ANALYSIS_ZERO_TURN_STEPS):
                    steps[mode](x, y)
                # the host's time to issue the turn (before the card is
                # waited for): near the step's own time when host-bound
                t1 = time.perf_counter()
                sync()
                n = ANALYSIS_ZERO_TURN_STEPS
                step_ms[mode].append((time.perf_counter() - t0) * 1e3 / n)
                issue_ms[mode].append((t1 - t0) * 1e3 / n)
        for mode, step in steps.items():
            runs[mode]["step_ms"] = step_ms[mode]
            runs[mode]["issue_ms"] = issue_ms[mode]
            runs[mode]["buckets_after_turns"] = len(step.buckets)
            runs[mode]["trace"] = traced(step, mode) if cuda else None
    del steps
    if cuda:
        torch.cuda.empty_cache()
    return {"rank": rank, "world": world, "runs": runs}


def zero_trace_split(runs):
    """One layout's measurement over the ranks (``runs``: each rank's
    run of :func:`analysis_zero_rank`): the median step ms of each rank
    and of the slowest rank a turn; per rank the NCCL kernel ms and the
    part no compute kernel overlaps; and, where every rank traced the
    same number of NCCL kernels, each collective's least time over the
    ranks summed (``transfer_ms``: the last rank to arrive waits for no
    one) and its least unhidden time (``exposed_transfer_ms``), the rest
    of the ranks' NCCL time being waiting; the host's issue ms a step
    (host-bound where it nears the step's), and each rank's traced step:
    compute busy ms, the span from its first kernel to its last, and the
    ms of that span no kernel ran."""
    import statistics
    turns = list(zip(*[r["step_ms"] for r in runs]))
    out = {"step_ms_median_by_rank": [statistics.median(r["step_ms"])
                                      for r in runs],
           "step_ms_slowest_rank_median": statistics.median(
               max(t) for t in turns),
           "step_ms_turns_rank0": runs[0]["step_ms"],
           "issue_ms_median_by_rank": [statistics.median(r["issue_ms"])
                                       for r in runs],
           "buckets_after_turns": [r["buckets_after_turns"] for r in runs]}
    traces = [r.get("trace") for r in runs]
    if any(t is None for t in traces):
        return out
    out["nccl_kernels_by_rank"] = [len(t["nccl"]) for t in traces]
    out["nccl_kernel_ms_by_rank"] = [sum(k for k, _ in t["nccl"]) / 1e3
                                     for t in traces]
    out["nccl_exposed_ms_by_rank"] = [sum(e for _, e in t["nccl"]) / 1e3
                                      for t in traces]
    for k in ("compute_busy_ms", "span_ms", "idle_ms"):
        out[f"traced_{k}_by_rank"] = [t[k] for t in traces]
    if len({len(t["nccl"]) for t in traces}) == 1:
        per = list(zip(*[t["nccl"] for t in traces]))
        out["transfer_ms"] = sum(min(k for k, _ in c) for c in per) / 1e3
        out["exposed_transfer_ms"] = sum(min(e for _, e in c)
                                         for c in per) / 1e3
    return out


def analysis_zero(torch, np, smi, device="cuda", world=ANALYSIS_ZERO_WORLD,
                  widths=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                  bucket_bytes=None, timeout_s=900):
    """Phase 21c: ZeRO dp 4 on four cards (:func:`analysis_zero_rank`).
    Gates, each rank: the census one reduce-scatter a bucket with the
    plan's row, one all-gather a run of buckets of one dtype with the
    plan's payload plus the global batch's loss, the report clean; the
    serial overlap_fraction <= 0.05 and the bucketed one above it; the
    analytical backend scores serial worse than bucketed. Printed beside
    each, not gated (:func:`zero_trace_split`): the exposed comm seconds,
    the two layouts' step ms timed in alternating turns, and from a trace
    of every rank the NCCL time no compute kernel overlapped, split into
    transfer and waiting."""
    from mxnet_tpu_torch.parallel import dist
    trace_dir = os.path.abspath(os.path.join("build", "chip_trace"))
    os.makedirs(trace_dir, exist_ok=True)
    ranks = dist.spawn(analysis_zero_rank, world, device,
                       (widths, batch, seq, TRAIN_LR, trace_dir,
                        bucket_bytes),
                       timeout_s=timeout_s)

    def census_ok(run):
        rs_ok = run["reduce_scatter_elements"] == run["plan_bucket_rows"]
        ag = sorted(run["all_gather_elements"])
        ag_ok = ag == sorted(run["plan_gather_sizes"]
                             + [run["global_batch_loss_gather"]])
        return rs_ok and ag_ok and run["report_ok"] and \
            run["donation"]["copied"] == 0

    r0 = ranks[0]["runs"]
    serial, buck = r0["serial"], r0["bucketed"]
    measured = {m: zero_trace_split([r["runs"][m] for r in ranks])
                for m in r0}
    gates = {
        "census_matches_plan": all(census_ok(r["runs"][m])
                                   for r in ranks for m in r["runs"]),
        "serial_fraction_le_0.05":
            serial["overlap"]["overlap_fraction"] <= 0.05,
        "bucketed_above_serial": buck["overlap"]["overlap_fraction"]
        > serial["overlap"]["overlap_fraction"],
        "serial_exposed_positive": serial["exposed_comm_s"] > 0,
        "analytical_serial_worse": all(
            r["runs"]["serial"]["analytical_score_s"]
            > r["runs"]["bucketed"]["analytical_score_s"] for r in ranks)}
    for r in ranks:
        for run in r["runs"].values():
            run.pop("trace", None)
    out = {"world": world, "batch": batch, "seq": seq,
           "rank0": r0, "measured": measured, "gates": gates, "card": smi,
           "ok": all(gates.values())}
    emit({"analysis_zero": out})
    if not out["ok"]:
        raise SystemExit(f"phase 21c failed: {gates}")
    return out


def analysis_phase(torch, np, K, ATT, dev, smi):
    """Phase 21 on one card: 21a (float32, bf16 amp), 21b and the guard
    half of 21d. Returns the phase's launches by kernel."""
    t0 = time.perf_counter()
    launches = {}
    for part in (analysis_bert(torch, np, K, dev, smi),
                 analysis_bert(torch, np, K, dev, smi, bf16=True),
                 analysis_serving(torch, np, K, dev, smi)):
        torch.cuda.empty_cache()
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    analysis_guard(torch, np, K, dev, smi)
    emit({"analysis_phase_s": time.perf_counter() - t0,
          "analysis_launch_counts": {k: v for k, v in launches.items()
                                     if v}})
    return launches


#: phase 22: bench.py bench_ssd's leg (bench.py:590-706; BASELINE.md row 5,
#: "SSD-ResNet50 object detection (gluon-cv, multi-loss, NMS on device)"):
#: bench.py's _SSDResNet50 (bench.py:528-581) on the port's layers:
#: resnet50_v1's features less their global pool, two extra stride-2
#: scales (Conv2D 512 and 256, 3 x 3, ReLU), 3 x 3 class and box heads a
#: scale with SSD_ANCHORS anchors of SSD_SIZES x SSD_RATIOS and
#: SSD_CLASSES + 1 classes; batch SSD_BATCH x 3 x SSD_SIZE x SSD_SIZE
#: numpy-uniform images, one random box a image as bench_ssd makes it;
#: SGD momentum 0.9 at lr 1e-3 through ``compile_step`` (SSD_WARMUP +
#: SSD_STEPS steps a run, the median of the last SSD_STEPS), float32 and
#: under bf16 amp; each block's last BatchNorm gamma 0 (phase 14's
#: weights). Feature maps 10 x 10, 5 x 5, 3 x 3 at 300: 536 anchors
SSD_SIZES = ((0.2, 0.272), (0.37, 0.447), (0.54, 0.619))
SSD_RATIOS = (1.0, 2.0, 0.5)
SSD_ANCHORS = len(SSD_SIZES[0]) + len(SSD_RATIOS) - 1
SSD_CLASSES, SSD_BATCH, SSD_SIZE = 20, 32, 300
SSD_WARMUP, SSD_STEPS, SSD_LR, SSD_MOMENTUM = 3, 10, 1e-3, 0.9
#: the backbone's last stage, extra1 and extra2: the heads' in_channels
SSD_CHANNELS = (2048, 512, 256)
#: the gradient check (phase 14's, on a fresh build after one eager step):
#: SSD_GRAD_BATCH images of SSD_GRAD_SIZE pixels (feature maps 5 x 5,
#: 3 x 3, 2 x 2)
SSD_GRAD_BATCH, SSD_GRAD_SIZE = 2, 160
#: MultiBoxTarget and box_nms on the card against the CPU: SSD_OPS_OBJECTS
#: label rows an image (some padding, a planted duplicate best anchor),
#: SSD_BATCH images over the 536 anchors; box targets within
#: SSD_TARGET_RTOL relative; NMS pairs within SSD_NMS_NEAR of the
#: threshold are counted and may differ
SSD_OPS_OBJECTS, SSD_TARGET_RTOL, SSD_NMS_NEAR = 4, 1e-5, 1e-6
#: the eval (bench.py:675-699): the trained net in eval mode on
#: SSD_EVAL_BATCH images, softmax over the classes, MultiBoxDetection at
#: nms_threshold 0.45 and threshold 0.01, captured through
#: ``CompiledPredictor`` at one bucket of SSD_EVAL_BATCH; SSD_EVAL_ITERS
#: replays and eager calls timed
SSD_EVAL_BATCH, SSD_NMS_THRESHOLD, SSD_EVAL_THRESHOLD = 4, 0.45, 0.01
SSD_EVAL_ITERS = 10
#: the fed run: SSD_FED_STEPS float32 steps fed by ``ImageDetIter`` over
#: SSD_FED_RECORDS raw 3 x 300 x 300 records of 1 to SSD_FED_OBJECTS boxes
#: (written with ``recordio`` in a temporary directory the phase removes),
#: rand_crop, rand_pad and rand_mirror on, labels padded to
#: SSD_FED_OBJECTS rows
SSD_FED_RECORDS, SSD_FED_OBJECTS, SSD_FED_STEPS, SSD_FED_SEED = 64, 3, 3, 22
#: phase 22's paths, in the order ``ssd_phase`` returns their launches
SSD_PATHS = ("ssd_resnet50_training", "ssd_resnet50_training_bf16",
             "ssd_resnet50_records")


def ssd_maps(size):
    """The three feature maps' sides at ``size``: five stride-2 stages
    (each ceil(n / 2)) to the backbone's, then the two extra scales."""
    n = size
    for _ in range(5):
        n = (n + 1) // 2
    return n, (n + 1) // 2, ((n + 1) // 2 + 1) // 2


def ssd_resnet50(torch, device=None, num_classes=SSD_CLASSES):
    """bench.py's ``_SSDResNet50.build()`` on the port's layers, its
    parameters named as the JAX ``collect_params()`` names them. The
    layers take their ``in_channels``: the port infers no shapes."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ndarray import contrib

    class SSD(torch.nn.Module):
        def __init__(self):
            super().__init__()
            base = vision.resnet50_v1(device=device)
            self.backbone = nn.Sequential(*list(base.features)[:-1])
            self.extra1 = nn.Sequential(nn.Conv2D(
                512, 3, strides=2, padding=1, activation="relu",
                in_channels=SSD_CHANNELS[0], device=device))
            self.extra2 = nn.Sequential(nn.Conv2D(
                256, 3, strides=2, padding=1, activation="relu",
                in_channels=SSD_CHANNELS[1], device=device))
            for i, ch in enumerate(SSD_CHANNELS):
                setattr(self, f"cls{i}", nn.Conv2D(
                    SSD_ANCHORS * (num_classes + 1), 3, padding=1,
                    in_channels=ch, device=device))
                setattr(self, f"loc{i}", nn.Conv2D(
                    SSD_ANCHORS * 4, 3, padding=1, in_channels=ch,
                    device=device))

        def forward(self, x):
            feats = [self.backbone(x)]
            feats.append(self.extra1(feats[-1]))
            feats.append(self.extra2(feats[-1]))
            anchors, clses, locs = [], [], []
            for i, f in enumerate(feats):
                anchors.append(contrib.MultiBoxPrior(
                    f, sizes=SSD_SIZES[i], ratios=SSD_RATIOS))
                c = getattr(self, f"cls{i}")(f)
                b, _, h, w = c.shape
                clses.append(c.permute(0, 2, 3, 1).reshape(
                    b, h * w * SSD_ANCHORS, num_classes + 1))
                locs.append(getattr(self, f"loc{i}")(f).permute(
                    0, 2, 3, 1).reshape(b, -1))
            return (torch.cat(anchors, 1), torch.cat(clses, 1),
                    torch.cat(locs, 1))

    return SSD()


def ssd_loss(torch):
    """bench_ssd's loss (bench.py:618-636) a image: ``MultiBoxTarget`` on
    the detached anchors and class scores, then the image's softmax
    cross-entropy over its anchors / N plus its masked L1 / (N x 4). The
    batch's mean is bench's loss (the summed cross-entropy / B / N plus
    the mean L1), so ``compile_step``'s update (the sum's gradient / B)
    is bench's. The cross-entropy runs through the op funnel as
    ``"softmax_cross_entropy"`` (float32 under amp, as the JAX op)."""
    from mxnet_tpu_torch.ndarray import contrib
    from mxnet_tpu_torch.ops.registry import invoke

    def image_ce(x, y):
        logp = torch.log_softmax(x, dim=-1)
        return -torch.gather(logp, -1, y.long()[..., None]).sum((1, 2))

    def loss(out, labels):
        anchors, cls, loc = out
        with torch.no_grad():
            loc_t, loc_mask, cls_t = contrib.MultiBoxTarget(
                anchors.detach(), labels, cls.detach().transpose(1, 2))
        ce = invoke("softmax_cross_entropy", image_ce, cls, cls_t)
        l1 = (loc * loc_mask - loc_t * loc_mask).abs()
        return ce / cls.shape[1] + l1.sum(1) / l1.shape[1]

    return loss


def ssd_batch(np, rs, batch, size):
    """``batch`` uniform images and one box a image, as bench_ssd makes
    them: labels (batch, 1, 5) [class, x0, y0, x0 + 0.3, y0 + 0.3]."""
    x = rs.uniform(size=(batch, 3, size, size)).astype(np.float32)
    lab = np.zeros((batch, 1, 5), np.float32)
    lab[:, 0, 0] = rs.randint(0, SSD_CLASSES, size=batch)
    x0 = rs.uniform(0, 0.6, size=(batch, 2)).astype(np.float32)
    lab[:, 0, 1:3] = x0
    lab[:, 0, 3:5] = x0 + 0.3
    return x, lab


def ssd_grad_check(torch, np, net, loss_fn, amp_on):
    """:func:`resnet_grad_check`'s check on the SSD: a card copy of
    ``net`` against a CPU copy (float32; under amp a float64 one, and a
    float32 CPU copy under amp beside it) at SSD_GRAD_BATCH x
    SSD_GRAD_SIZE, one training-mode backward each; then the running
    statistics it wrote."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.params import load_jax_params
    t0 = time.perf_counter()

    def copy(device):
        return copy_to_cpu(lambda: ssd_resnet50(torch, device), net,
                           load_jax_params)

    card, cpu = copy(net.cls0.weight.device), copy("cpu")
    x, y = ssd_batch(np, np.random.RandomState(23), SSD_GRAD_BATCH,
                     SSD_GRAD_SIZE)
    g_card = train_grads(torch, card, loss_fn, x, y)
    if not amp_on:
        check = grad_check(torch, None, None, loss_fn, x, y,
                           grads=(g_card, train_grads(torch, cpu, loss_fn,
                                                      x, y)))
    else:
        g_amp = train_grads(torch, copy("cpu"), loss_fn, x, y)
        amp.uninit()
        try:
            g64 = train_grads(torch, cpu.double(), loss_fn, x, y)
        finally:
            amp.init("bfloat16")
        rms = grad_errors(g_card, g64, bias_scale, rms=True)
        worst = max(rms, key=rms.get)
        check = {
            "params": len(rms), "worst_param": worst,
            "worst_rms_err_over_scale": rms[worst],
            "rtol_of_param_max": GRAD_RTOL_BF16,
            "largest_err_over_scale": {
                side: max(grad_errors(g, g64, bias_scale).values())
                for side, g in (("card_amp", g_card), ("cpu_amp", g_amp))},
            "ok": rms[worst] <= GRAD_RTOL_BF16}
    stats = grad_check(torch, None, None, loss_fn, None, None,
                       rtol=GRAD_RTOL_BF16 if amp_on else GRAD_RTOL,
                       grads=(running_stats(card), running_stats(cpu)))
    return {"batch": SSD_GRAD_BATCH, "size": SSD_GRAD_SIZE,
            "grads": check, "running_stats": stats,
            "cpu_dtype": "float64" if amp_on else "float32",
            "seconds": time.perf_counter() - t0,
            "ok": check["ok"] and stats["ok"]}


def ssd_target_ms(torch, anchors, labels, cls):
    """Device ms of bench's ``MultiBoxTarget`` call at the step's shapes,
    by graph replay (:func:`time_ms`)."""
    from mxnet_tpu_torch.ndarray import contrib
    cp = cls.detach().transpose(1, 2)
    return time_ms(torch, lambda a, b, c: contrib.MultiBoxTarget(a, b, c),
                   [(anchors.detach(), labels, cp)], iters=10)[0]


def ssd_train(torch, np, K, dev, smi, bf16=False):
    """Phase 22's training: the SSD through ``compile_step`` in the turns
    of :func:`train_turns` (replays held bit-equal to the body run
    eagerly: the caller sets ``cudnn.deterministic``). Gates: finite
    falling losses, exactly one ``opt_update`` a step and nothing else of
    the library, one capture a step object, the gradient check of
    :func:`ssd_grad_check`, and the step's ``analyze()`` report naming no
    host transfer. Printed: median step ms of the last SSD_STEPS and
    images/s, peak memory, capture s, MultiBoxTarget's device ms and its
    share of the step. ``bf16``: the same under ``amp.init()``. Returns
    (launches of the gated run, the trained net)."""
    from mxnet_tpu_torch import amp
    if bf16:
        amp.init("bfloat16")
        try:
            return ssd_train(torch, np, K, dev, smi)
        finally:
            amp.uninit()
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.params import load_jax_params
    amp_on = amp.is_enabled()
    name = "ssd_train_bf16" if amp_on else "ssd_train"
    t0 = time.perf_counter()
    net = ssd_resnet50(torch, dev)
    init = resnet_init(np, net, seed=24)
    x, lab = ssd_batch(np, np.random.RandomState(25), SSD_BATCH, SSD_SIZE)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(lab).to(dev)
    loss_fn = ssd_loss(torch)
    made = [net]
    del net, x

    def build():
        net = made.pop() if made else ssd_resnet50(torch, dev)
        load_jax_params(net, init)
        net.train()
        return net, Trainer(dict(net.named_parameters()), "sgd",
                            {"learning_rate": SSD_LR,
                             "momentum": SSD_MOMENTUM}), loss_fn

    setup_s = time.perf_counter() - t0
    steps = SSD_WARMUP + SSD_STEPS
    turns, (net, trainer, _), gated = train_turns(
        torch, K, build, xt, yt, steps, SSD_BATCH, exact=True,
        by_dtype=True, unit="images")
    losses, step_ms, per_step, counts, per_step_dt = gated
    n_params = len(trainer._params)
    n_trainable = sum(p.requires_grad for p in net.parameters())
    expect = {n: 0 for n in K.KERNELS}
    expect.update(opt_update=1)
    expect_dt = {"opt_update": {"float32": 1}}
    launches_ok = n_params == n_trainable and \
        all(s == expect for s in per_step) and \
        all(s == expect_dt for s in per_step_dt)
    losses_ok = all(math.isfinite(v) for v in losses) and \
        losses[-1] < losses[0]
    master_ok = all(p.dtype == torch.float32 for p in net.parameters())
    median_ms = statistics.median(step_ms[SSD_WARMUP:])
    with torch.no_grad():
        anchors, cls, _ = net(xt)
    target_ms = ssd_target_ms(torch, anchors, yt, cls)
    n_anchors = anchors.shape[1]
    del anchors, cls, trainer

    # the step's analysis report: one eager run of the captured body
    first, first_trainer, _ = build()
    step = first_trainer.compile_step(
        lambda a, b: loss_fn(first(a), b))
    step.aot_compile(xt, yt)
    rep = step.analyze(xt, yt)
    torch.cuda.synchronize()
    facts = report_facts(rep)
    del step, rep
    # the gradient check on a fresh build after one eager step
    first, first_trainer, _ = build()
    plain_step(first, first_trainer, loss_fn)(xt, yt)
    del xt, yt, first_trainer
    torch.cuda.empty_cache()
    grads = ssd_grad_check(torch, np, first, loss_fn, amp_on)
    del first
    print(smi, flush=True)
    report = {
        "model": "ssd_resnet50 (bench.py _SSDResNet50)",
        "classes": SSD_CLASSES, "anchors": n_anchors,
        "dtype": "bfloat16 amp, float32 parameters" if amp_on
        else "float32",
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "batch": SSD_BATCH, "size": SSD_SIZE, "warmup": SSD_WARMUP,
        "steps": SSD_STEPS, "optimizer": "sgd", "learning_rate": SSD_LR,
        "momentum": SSD_MOMENTUM, "losses": losses, "step_ms": step_ms,
        "median_step_ms": median_ms,
        "images_per_s": SSD_BATCH / (median_ms / 1e3),
        "max_memory_allocated": turns["captured_max_memory_allocated"][0],
        "max_memory_reserved": turns["captured_max_memory_reserved"][0],
        "setup_s": setup_s, "capture_s": turns["capture_s"][0],
        "n_traces_after_warmup": turns["turns"][0]["n_traces_after_warmup"],
        "n_traces_after_steps": turns["turns"][0]["n_traces_after_steps"],
        "multibox_target_ms": target_ms,
        "multibox_target_share": target_ms / median_ms,
        "trainable": n_params, "launches": counts,
        "launches_per_step": per_step[-1],
        "launches_per_step_expected": expect,
        "launches_per_step_by_dtype": per_step_dt[-1],
        "parameters_float32": master_ok, "analysis": facts,
        "grad_check": grads, "captured_vs_eager": turns, "card": smi}
    gates = {"launches": launches_ok, "losses": losses_ok,
             "float32_masters": master_ok, "turns": turns["ok"],
             "grad_check": grads["ok"],
             "no_host_transfer": facts["host_transfers"] == 0}
    report.update(gates=gates, ok=all(gates.values()))
    emit({name: report})
    if not report["ok"]:
        raise SystemExit(f"phase 22 training failed ({name}): {gates}; "
                         f"losses {losses}, launches {per_step} "
                         f"{per_step_dt}, gradients {grads}, analysis "
                         f"{facts}")
    return counts, net


def ssd_ops_inputs(torch, np, rs):
    """MultiBoxTarget's inputs at the step's anchors: SSD_BATCH images of
    SSD_OPS_OBJECTS label rows (1 to SSD_OPS_OBJECTS valid, padding rows
    -1, one padding row over a real box), image 0's first two truths the
    same box of two classes (a duplicate best anchor), random class
    scores; and box_nms rows at the eval's shape."""
    from mxnet_tpu_torch.ndarray import contrib
    anchors = torch.cat([contrib.MultiBoxPrior(
        torch.zeros((1, 1, m, m)), sizes=s, ratios=SSD_RATIOS)
        for m, s in zip(ssd_maps(SSD_SIZE), SSD_SIZES)], 1).numpy()
    n = anchors.shape[1]
    b, m = SSD_BATCH, SSD_OPS_OBJECTS
    lab = np.full((b, m, 5), -1.0, np.float32)
    for i in range(b):
        k = 1 + i % m
        lab[i, :k, 0] = rs.randint(0, SSD_CLASSES, k)
        xy = rs.uniform(0, 0.6, (k, 2))
        wh = rs.uniform(0.05, 0.4, (k, 2))
        lab[i, :k, 1:] = np.concatenate([xy, xy + wh], 1)
    lab[0, 1] = lab[0, 0]
    lab[0, 1, 0] = (lab[0, 0, 0] + 1) % SSD_CLASSES
    lab[1, 3, 1:] = lab[1, 0, 1:]
    cls = rs.standard_normal((b, SSD_CLASSES + 1, n)).astype(np.float32)
    xy = rs.uniform(0.1, 0.5, (SSD_EVAL_BATCH, n, 2))
    wh = rs.uniform(0.1, 0.4, (SSD_EVAL_BATCH, n, 2))
    rows = np.concatenate([
        rs.randint(0, SSD_CLASSES, (SSD_EVAL_BATCH, n, 1)),
        rs.uniform(0, 1, (SSD_EVAL_BATCH, n, 1)), xy, xy + wh], 2) \
        .astype(np.float32)
    return anchors, lab, cls, rows


def ssd_ops_vs_cpu(torch, np, dev, smi):
    """Phase 22's box ops on the card against the CPU on the same inputs
    (:func:`ssd_ops_inputs`): ``MultiBoxTarget`` as bench calls it and
    with hard-negative mining at ratio 3 (cls_target and box_mask equal,
    box_target within SSD_TARGET_RTOL), ``box_nms`` as MultiBoxDetection
    calls it (every row equal, but for rows of a pair whose IoU is within
    SSD_NMS_NEAR of the threshold: counted and printed, and 0 expected)."""
    from mxnet_tpu_torch.ndarray import contrib
    anchors, lab, cls, rows = ssd_ops_inputs(
        torch, np, np.random.RandomState(26))
    out = {}
    for case, kw in (("bench", {}),
                     ("mining", dict(negative_mining_ratio=3.0))):
        got = contrib.MultiBoxTarget(*(torch.from_numpy(a).to(dev)
                                       for a in (anchors, lab, cls)), **kw)
        ref = contrib.MultiBoxTarget(*(torch.from_numpy(a)
                                       for a in (anchors, lab, cls)), **kw)
        got = [g.cpu() for g in got]
        ok, err, _ = compare(torch, got[0], ref[0], 0.0, SSD_TARGET_RTOL)
        out[case] = {"cls_target_equal": bool(torch.equal(got[2], ref[2])),
                     "box_mask_equal": bool(torch.equal(got[1], ref[1])),
                     "box_target_max_abs_err": err,
                     "box_target_bit_equal": bool(torch.equal(got[0],
                                                              ref[0])),
                     "matched": int((ref[2] > 0).sum()),
                     "ignored": int((ref[2] < 0).sum()),
                     "ok": ok and bool(torch.equal(got[2], ref[2]))
                     and bool(torch.equal(got[1], ref[1]))}
    kw = dict(overlap_thresh=SSD_NMS_THRESHOLD,
              valid_thresh=SSD_EVAL_THRESHOLD, coord_start=2, score_index=1,
              id_index=0)
    got = contrib.box_nms(torch.from_numpy(rows).to(dev), **kw).cpu()
    ref = contrib.box_nms(torch.from_numpy(rows), **kw)
    # pairs of the same class whose IoU sits within SSD_NMS_NEAR of the
    # threshold, by position in the sorted rows
    order = np.argsort(-np.where(rows[..., 1] > SSD_EVAL_THRESHOLD,
                                 rows[..., 1], -np.inf), 1, kind="stable")
    srt = np.take_along_axis(rows, order[..., None], 1)
    iou = contrib.box_iou(torch.from_numpy(srt[..., 2:6]),
                          torch.from_numpy(srt[..., 2:6])).numpy()
    same = srt[..., 0][:, :, None] == srt[..., 0][:, None, :]
    near = np.triu(same & (np.abs(iou - SSD_NMS_THRESHOLD) <= SSD_NMS_NEAR),
                   1)
    near_rows = np.zeros(rows.shape[:2], bool)
    b_i, i_i, j_i = np.nonzero(near)
    near_rows[b_i, i_i] = near_rows[b_i, j_i] = True
    differ = (got != ref).any(-1).numpy()
    out["box_nms"] = {"rows": list(rows.shape), "kept": int(
        (ref[..., 0] >= 0).sum()), "near_threshold_pairs": int(near.sum()),
        "rows_differing": int(differ.sum()),
        "bit_equal": bool(torch.equal(got, ref)),
        "ok": bool((~differ | near_rows).all())}
    report = {**out, "card": smi,
              "ok": all(v["ok"] for v in out.values())}
    emit({"ssd_ops_vs_cpu": report})
    if not report["ok"]:
        raise SystemExit(f"phase 22's box ops on the card differ from the "
                         f"CPU: {report}")
    return report


def ssd_detector(torch, net):
    """bench.py's eval program (bench.py:675-699) as a module: the net's
    forward, softmax over the classes, ``MultiBoxDetection``."""
    from mxnet_tpu_torch.ndarray import contrib
    from mxnet_tpu_torch.ops import nn as ops_nn

    class Detect(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x):
            anchors, cls, loc = self.net(x)
            probs = ops_nn.softmax(cls.transpose(1, 2), axis=1)
            return contrib.MultiBoxDetection(
                probs, loc, anchors, nms_threshold=SSD_NMS_THRESHOLD,
                threshold=SSD_EVAL_THRESHOLD)

    return Detect()


def ssd_eval(torch, np, dev, smi, net, what):
    """Phase 22's eval: :func:`ssd_detector` of the trained ``net``
    (eval mode) through ``CompiledPredictor`` at one bucket of
    SSD_EVAL_BATCH: one capture, the replay bit-equal to the program
    called eagerly on the card, rows of shape (SSD_EVAL_BATCH, N, 6),
    suppressed rows all -1, kept scores non-increasing down each image;
    replay and eager ms over SSD_EVAL_ITERS calls, and ``MultiBoxDetection``
    alone (decode and NMS) by graph replay (:func:`time_ms`)."""
    from mxnet_tpu_torch.ndarray import contrib
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.serving import CompiledPredictor
    det = ssd_detector(torch, net)
    pred = CompiledPredictor(det, bucket_sizes=(SSD_EVAL_BATCH,),
                             device=dev)
    x = torch.from_numpy(np.random.RandomState(27).uniform(
        size=(SSD_EVAL_BATCH, 3, SSD_SIZE, SSD_SIZE)).astype(np.float32)) \
        .to(dev)
    pred.warmup(x[:1])
    got = pred.predict(x)
    with torch.inference_mode():
        eager = det(x)
    torch.cuda.synchronize()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SSD_EVAL_ITERS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SSD_EVAL_ITERS

    def eager_call():
        with torch.inference_mode():
            det(x)

    replay_ms = timed(lambda: pred.predict(x))
    eager_ms = timed(eager_call)
    with torch.inference_mode():
        anchors, cls, loc = net(x)
        probs = ops_nn.softmax(cls.transpose(1, 2), axis=1)
    nms_ms, nms_eager_ms = time_ms(
        torch, lambda p, l, a: contrib.MultiBoxDetection(
            p, l, a, nms_threshold=SSD_NMS_THRESHOLD,
            threshold=SSD_EVAL_THRESHOLD), [(probs, loc, anchors)], iters=3)
    rows = got.cpu()
    kept = rows[..., 0] >= 0
    supp = ~kept
    scores = rows[..., 1]
    mono = all(bool((s[k][1:] <= s[k][:-1]).all())
               for s, k in zip(scores, kept))
    n = rows.shape[1]
    report = {
        "net": what, "batch": SSD_EVAL_BATCH, "size": SSD_SIZE,
        "program": "CompiledPredictor, one bucket",
        "capture_s": pred.capture_s[SSD_EVAL_BATCH],
        "n_traces": pred.n_traces, "shape": list(rows.shape),
        "kept_per_image": kept.sum(1).tolist(),
        "replay_ms": replay_ms, "eager_ms": eager_ms,
        "detection_ms": nms_ms, "detection_eager_ms": nms_eager_ms,
        "detection_share": nms_ms / replay_ms,
        "graph_bit_equal_to_eager": bool(torch.equal(got, eager)),
        "card": smi}
    gates = {"shape": list(rows.shape) == [SSD_EVAL_BATCH, n, 6]
             and n == SSD_ANCHORS * sum(m * m for m in ssd_maps(SSD_SIZE)),
             "suppressed_rows_minus_one": bool((rows[supp] == -1).all()),
             "kept_scores_non_increasing": mono,
             "kept_some": bool(kept.any()),
             "one_capture": pred.n_traces == 1,
             "graph_vs_eager": report["graph_bit_equal_to_eager"]}
    report.update(gates=gates, ok=all(gates.values()))
    emit({"ssd_eval": report})
    del pred, det
    if not report["ok"]:
        raise SystemExit(f"phase 22's eval failed: {gates}")
    return report


def ssd_records(np, path, rs):
    """SSD_FED_RECORDS raw CHW uint8 records of 3 x SSD_SIZE x SSD_SIZE,
    each with 1 to SSD_FED_OBJECTS boxes in the flat label form
    ``[2, 5, objects...]``."""
    from mxnet_tpu_torch import recordio
    w = recordio.MXRecordIO(path, "w")
    for i in range(SSD_FED_RECORDS):
        k = 1 + i % SSD_FED_OBJECTS
        obj = np.zeros((k, 5), np.float32)
        obj[:, 0] = rs.randint(0, SSD_CLASSES, k)
        xy = rs.uniform(0, 0.6, (k, 2))
        obj[:, 1:3] = xy
        obj[:, 3:5] = xy + rs.uniform(0.15, 0.4, (k, 2))
        img = rs.randint(0, 256, (3, SSD_SIZE, SSD_SIZE)).astype(np.uint8)
        w.write(recordio.pack(recordio.IRHeader(
            0, np.concatenate([[2, 5], obj.ravel()]).astype(np.float32),
            i, 0), img.tobytes()))
    w.close()


def ssd_fed(torch, np, K, dev, smi):
    """Phase 22's fed run: SSD_FED_STEPS float32 steps of a fresh SSD
    fed by ``ImageDetIter`` over :func:`ssd_records` (rand_crop,
    rand_pad, rand_mirror, a ``random.Random`` of SSD_FED_SEED). Gates:
    finite losses, one ``opt_update`` a step and nothing else of the
    library, one capture (the label shape is fixed), the batches
    (SSD_BATCH, 3, SSD_SIZE, SSD_SIZE) and (SSD_BATCH, SSD_FED_OBJECTS,
    5). Printed: images/s, ``input_wait_ms`` (the host's time in
    ``next``), step ms. Returns the run's launches."""
    import random
    import shutil
    import tempfile
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.params import load_jax_params
    from mxnet_tpu_torch.image import ImageDetIter
    tmp = tempfile.mkdtemp(prefix="mxt-det-records-")
    try:
        path = os.path.join(tmp, "det.rec")
        t0 = time.perf_counter()
        ssd_records(np, path, np.random.RandomState(SSD_FED_SEED))
        write_s = time.perf_counter() - t0
        it = ImageDetIter(SSD_BATCH, (3, SSD_SIZE, SSD_SIZE),
                          path_imgrec=path, shuffle=True, rand_crop=1,
                          rand_pad=0.5, rand_mirror=True,
                          label_shape=(SSD_FED_OBJECTS, 5),
                          rng=random.Random(SSD_FED_SEED))
        net = ssd_resnet50(torch, dev)
        load_jax_params(net, resnet_init(np, net, seed=24))
        net.train()
        trainer = Trainer(dict(net.named_parameters()), "sgd",
                          {"learning_rate": SSD_LR,
                           "momentum": SSD_MOMENTUM})
        loss_fn = ssd_loss(torch)
        step = trainer.compile_step(lambda a, b: loss_fn(net(a), b))

        def batch():
            t = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                it.reset()
                b = next(it)
            x, y = b.data[0].to(dev), b.label[0].to(dev)
            return x, y, (time.perf_counter() - t) * 1e3

        x, y, wait0 = batch()
        shapes = {(tuple(x.shape), tuple(y.shape))}
        t0 = time.perf_counter()
        step.aot_compile(x, y)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        expect = {n: 0 for n in K.KERNELS}
        expect.update(opt_update=1)
        losses, step_ms, waits, per_step = [], [], [wait0], []
        K.reset_launch_counts()
        t_prev = time.perf_counter()
        for i in range(SSD_FED_STEPS):
            if i:
                x, y, w = batch()
                waits.append(w)
                shapes.add((tuple(x.shape), tuple(y.shape)))
            before = K.launch_counts()
            losses.append(float(step(x, y).mean()))
            torch.cuda.synchronize()
            now = time.perf_counter()
            step_ms.append((now - t_prev) * 1e3)
            t_prev = now
            per_step.append(step_launches(K, before))
        counts = K.launch_counts()
        n_traces = step.n_traces
        del step, trainer, net
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report = {"records": SSD_FED_RECORDS, "write_s": write_s,
              "batch": SSD_BATCH, "steps": SSD_FED_STEPS,
              "augmenters": "rand_crop 1, rand_pad 0.5, rand_mirror",
              "shapes": sorted(shapes), "losses": losses, "step_ms": step_ms,
              "images_per_s": SSD_BATCH * len(step_ms) /
              (sum(step_ms) / 1e3),
              "input_wait_ms": sum(waits[1:]),
              "input_wait_ms_per_batch": waits,
              "capture_s": capture_s, "n_traces": n_traces,
              "launches": counts, "launches_per_step": per_step,
              "card": smi}
    gates = {"losses": all(math.isfinite(v) for v in losses),
             "launches": all(s == expect for s in per_step),
             "one_capture": n_traces == 1,
             "shapes": shapes == {((SSD_BATCH, 3, SSD_SIZE, SSD_SIZE),
                                   (SSD_BATCH, SSD_FED_OBJECTS, 5))}}
    report.update(gates=gates, ok=all(gates.values()))
    emit({"ssd_fed": report})
    if not report["ok"]:
        raise SystemExit(f"phase 22's fed run failed: {gates}")
    return counts


def ssd_phase(torch, np, K, dev, smi):
    """Phase 22: the box ops on the card against the CPU, the SSD trained
    in float32 and under bf16 amp (under ``cudnn.deterministic``, so the
    replays are held bit-equal to the body run), the NMS eval of the
    float32-trained net, and the fed run. Returns the launches of the
    float32, bf16 and fed runs."""
    ssd_ops_vs_cpu(torch, np, dev, smi)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        counts, net = ssd_train(torch, np, K, dev, smi)
        torch.cuda.empty_cache()
        ssd_eval(torch, np, dev, smi, net, "float32-trained")
        del net
        torch.cuda.empty_cache()
        counts_bf16, _ = ssd_train(torch, np, K, dev, smi, bf16=True)
        torch.cuda.empty_cache()
        fed = ssd_fed(torch, np, K, dev, smi)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    return counts, counts_bf16, fed


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
    if "--step-times" in argv:
        return step_times(argv[argv.index("--step-times") + 1])
    if "--compare-steps" in argv:
        return compare_checkouts(argv[argv.index("--compare-steps") + 1],
                                 "--step-times", "step_times")
    try:
        import mxnet_tpu_torch as mx
    except ImportError as e:
        # the script alone, without the repo around it, has no port to run
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "this script from the root of a checkout of the repo",
              file=sys.stderr)
        return 1
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
    if "--checkpoint" in argv:
        resumed = checkpoint_phase(torch, np, K, dev, smi)
        serve_loaded(torch, np, dev, smi, resumed)
        del resumed
        torch.cuda.empty_cache()
        checkpoint_phase(torch, np, K, dev, smi, bf16=True)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--elastic" in argv:
        elastic_one_card(torch, np, K, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--dist-kv" in argv:
        dist_kv_one_card(torch, np, K, dev, smi)
        torch.cuda.empty_cache()
        if torch.cuda.device_count() >= 2:
            dist_kv_multi(torch, np, smi)
        else:
            print("phase 13 across cards needs >= 2 GPUs; "
                  f"{torch.cuda.device_count()} visible, so it did not run",
                  flush=True)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--resnet" in argv:
        resnet_phase(torch, np, K, dev, smi, "--profile" in argv)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--surface" in argv:
        surface_phase(torch, np, K, dev, smi, "--profile" in argv)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--cells" in argv:
        cells_phase(torch, np, K, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--fleet" in argv:
        fleet_phase(torch, np, K, ATT, dev, smi, multi=True)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--data" in argv:
        data_phase(torch, np, K, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--tuning" in argv:
        tuning_phase(torch, np, K, ATT, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--analysis-zero" in argv:
        # phase 21c alone: the four-card part
        if torch.cuda.device_count() < ANALYSIS_ZERO_WORLD:
            raise SystemExit(f"--analysis-zero needs {ANALYSIS_ZERO_WORLD} "
                             "cards")
        analysis_zero(torch, np, smi)
        analysis_locks(smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--analysis" in argv:
        analysis_phase(torch, np, K, ATT, dev, smi)
        if torch.cuda.device_count() >= ANALYSIS_ZERO_WORLD:
            analysis_zero(torch, np, smi)
        else:
            print(f"phase 21c needs {ANALYSIS_ZERO_WORLD} GPUs; "
                  f"{torch.cuda.device_count()} visible, so it did not run",
                  flush=True)
        analysis_locks(smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--ssd" in argv:
        ssd_phase(torch, np, K, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--telemetry" in argv:
        telemetry_phase(torch, np, K, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--opt" in argv:
        # kernel 12 alone: its checks, its times, the two whole updates
        time_opt_kernel(torch, KO, check_opt_kernel(torch, KO, dev))
        time_bert_update(torch, K, KO, dev)
        time_resnet_update(torch, K, KO, dev)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--zero-train" in argv:
        if torch.cuda.device_count() < 2:
            raise SystemExit("--zero-train needs two or more cards")
        zero_train_multi(torch, np, smi)
        zero_overlap(torch, np, smi)
        zero_elastic(torch, np, smi)
        zero_batchnorm(torch, np, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap: each phase's share of the run."""
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    served_args = check_kernels(torch, ATT, K, KN, dev)
    timing = time_kernels(torch, F, ATT, K, KN, served_args)
    del served_args
    bwd_args = check_bwd_kernels(torch, ATT, K, KN, dev)
    timing.update(time_bwd_kernels(torch, F, ATT, KN, bwd_args))
    del bwd_args
    new_args = check_new_kernels(torch, K, KR, KN, dev)
    timing.update(time_new_kernels(torch, F, K, KR, KN, new_args))
    del new_args
    dec_args = check_decode_kernel(torch, K, KR, dev)
    dec_timing = time_decode_kernel(torch, K, KR, dec_args)
    del dec_args
    # the kernels line's row: the decode_wide shape (bucket 8, H 650)
    for dn in ("float32", "bfloat16"):
        timing[("rnn_decode", dn)] = dec_timing[("rnn_decode", dn)
                                                + DECODE_TIMED[0]]
    opt_timed = check_opt_kernel(torch, KO, dev)
    timing.update(time_opt_kernel(torch, KO, opt_timed))
    del opt_timed
    time_bert_update(torch, K, KO, dev)
    torch.cuda.empty_cache()
    lap("kernels (phase 3)")
    served, pred = serve_bert(torch, np, K, dev)
    if "--profile" in argv:
        profile_bucket(torch, np, pred, smi)
    del pred
    torch.cuda.empty_cache()
    served_bf16, pred = serve_bert(torch, np, K, dev, dtype="bfloat16")
    if "--profile" in argv:
        profile_bucket(torch, np, pred, smi)
    del pred
    torch.cuda.empty_cache()
    lap("serving (phases 4, 4b)")
    encoder = run_encoder(torch, np, K, dev)
    lap("encoder (phase 5)")
    trained = train_bert(torch, np, K, dev, smi, "--profile" in argv)
    torch.cuda.empty_cache()
    trained_bf16 = train_bert(torch, np, K, dev, smi, "--profile" in argv,
                              bf16=True)
    torch.cuda.empty_cache()
    lap("train_bert (phases 6, 6b)")
    resumed = checkpoint_phase(torch, np, K, dev, smi)
    serve_loaded(torch, np, dev, smi, resumed)
    del resumed
    torch.cuda.empty_cache()
    checkpoint_phase(torch, np, K, dev, smi, bf16=True)
    torch.cuda.empty_cache()
    lap("checkpoint (phase 6c)")
    trained_long = train_long(torch, np, K, dev)
    lstm = train_lstm(torch, np, K, dev, smi, "--profile" in argv)
    train_dense(torch, K, dev, smi)
    torch.cuda.empty_cache()
    lap("long, lstm, dense (phases 7, 8, 8b)")
    serve_decode(torch, np, K, ATT, dev, smi, DECODE_LEG, leg=True)
    decode_wide, wide_model = serve_decode(torch, np, K, ATT, dev, smi,
                                           DECODE_WIDE, leg=False)
    if "--profile" in argv:
        profile_decode_step(torch, np, wide_model, smi)
    del wide_model
    lap("decode (phase 9)")
    zero_layout(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    zero_layout_mp(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    lap("zero layout (phase 10)")
    elastic_one_card(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    lap("elastic (phase 12)")
    dist_kv = dist_kv_one_card(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    lap("dist kv (phase 13)")
    resnet = resnet_phase(torch, np, K, dev, smi, "--profile" in argv)
    torch.cuda.empty_cache()
    lap("resnet (phase 14)")
    surface = surface_phase(torch, np, K, dev, smi, "--profile" in argv)
    torch.cuda.empty_cache()
    lap("surface (phase 15)")
    cells = cells_phase(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    lap("cells (phase 16)")
    fleet = fleet_phase(torch, np, K, ATT, dev, smi,
                        multi=torch.cuda.device_count() >= 2)
    torch.cuda.empty_cache()
    lap("fleet (phase 17)")
    data = data_phase(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    lap("data (phase 18)")
    tele = telemetry_phase(torch, np, K, dev, smi)
    torch.cuda.empty_cache()
    lap("telemetry (phase 19)")
    tune = tuning_phase(torch, np, K, ATT, dev, smi)
    lap("tuning (phase 20)")
    analysis = analysis_phase(torch, np, K, ATT, dev, smi)
    torch.cuda.empty_cache()
    lap("analysis (phase 21)")
    ssd = ssd_phase(torch, np, K, dev, smi)
    lap("ssd (phase 22)")
    if torch.cuda.device_count() >= 2:
        zero_train_multi(torch, np, smi)
        zero_overlap(torch, np, smi)
        zero_elastic(torch, np, smi)
        zero_batchnorm(torch, np, smi)
        dist_kv_multi(torch, np, smi)
        if torch.cuda.device_count() >= ANALYSIS_ZERO_WORLD:
            analysis_zero(torch, np, smi)
        else:
            print(f"phase 21c needs {ANALYSIS_ZERO_WORLD} GPUs; "
                  f"{torch.cuda.device_count()} visible, so it did not run",
                  flush=True)
    else:
        print("phase 11 (ZeRO training across cards, with A1's BatchNorm "
              "leg), phase 13 across cards, phase 17b and phase 21c need "
              f">= 2 GPUs; {torch.cuda.device_count()} visible, so they "
              "did not run", flush=True)
    lap("across cards (phases 11, 13, 17b, 21c)")
    analysis_locks(smi)
    emit({"phase_times_s": laps})

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
            "opt_update": "bert_base_training"}
    counts_of = {"bert_base_serving": served,
                 "transformer_encoder_gelu": encoder,
                 "bert_base_training": trained,
                 "bert_width_training_seq1024": trained_long,
                 "lstm_lm_training": lstm,
                 "decode_wide": decode_wide}
    launches = {name: counts_of[path[name]][name] for name in K.KERNELS}
    # the bf16 paths and what each launched there (the LayerNorm
    # backward runs in float32 under amp; opt_update updates float32
    # masters; the others have no bf16 path)
    bf16_path = {"flash_fwd": "bert_base_serving_bf16",
                 "layernorm_fwd": "bert_base_serving_bf16",
                 "flash_bwd_fused": "bert_base_training_bf16"}
    bf16_counts = {"bert_base_serving_bf16": served_bf16,
                   "bert_base_training_bf16": trained_bf16}
    bf16_launches = {name: bf16_counts[p][name]
                     for name, p in bf16_path.items()}
    # phase 14's path (resnet50_v1 training, float32 and bf16 amp) runs
    # one kernel of the library, opt_update
    resnet_launches = {path: {n: c for n, c in counts.items() if c}
                       for path, counts in zip(("resnet50_training",
                                                "resnet50_training_bf16"),
                                               resnet)}
    emit({"launch_counts": launches, "bf16_launch_counts": bf16_launches,
          "dist_kv_launch_counts": {n: c for n, c in dist_kv.items() if c},
          "resnet_launch_counts": resnet_launches,
          "surface_launch_counts": surface,
          "cells_launch_counts": {n: c for n, c in cells.items() if c},
          "fleet_launch_counts": {n: fleet[n] for n in FLEET_KERNELS},
          "data_launch_counts": {p: {n: c for n, c in counts.items() if c}
                                 for p, counts in data.items()},
          "telemetry_launch_counts": {n: c for n, c in tele.items() if c},
          "tuning_launch_counts": {n: c for n, c in tune.items() if c},
          "analysis_launch_counts": {n: c for n, c in analysis.items()
                                     if c},
          "ssd_launch_counts": {p: {n: c for n, c in counts.items() if c}
                                for p, counts in zip(SSD_PATHS, ssd)}})
    if not all(n > 0 for n in launches.values()) or \
            not all(cells[n] > 0 for n in ("rnn_scan_fwd",
                                           "rnn_scan_bwd")) or \
            not all(n > 0 for n in bf16_launches.values()) or \
            not all(c.get("opt_update", 0) > 0
                    for c in resnet_launches.values()) or \
            not all(fleet[n] > 0 for n in FLEET_KERNELS) or \
            not all(data[p][n] > 0 for n, paths in DATA_KERNELS.items()
                    for p in paths) or \
            not all(tele.get(n, 0) > 0 for n in TELE_KERNELS) or \
            not all(tune.get(n, 0) > 0 for n in TUNE_KERNELS) or \
            not all(analysis.get(n, 0) > 0 for n in ANALYSIS_KERNELS) or \
            not all(c.get("opt_update", 0) > 0 for c in ssd):
        raise SystemExit(f"a kernel never launched on its path: {launches}"
                         f" {bf16_launches} {resnet_launches} {cells}")
    rows = []
    for name, info in K.KERNELS.items():
        # the float32 path's numbers; the bf16 ones beside them
        t, tb = timing[(name, "float32")], timing[(name, "bfloat16")]
        rows.append({"name": name, "route": "cuda", "source": info.source,
                     "replaces": info.replaces, "launches": launches[name],
                     "path": path[name], "max_abs_err": t["max_abs_err"],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "shape": t["shape"],
                     "dtype": "float32",
                     "bf16_path": bf16_path.get(name),
                     "bf16_launches": bf16_launches.get(name),
                     "bf16_max_abs_err": tb["max_abs_err"],
                     "bf16_ms": tb["ms"], "bf16_plain_ms": tb["plain_ms"],
                     "bf16_bound_ms": tb["bound_ms"],
                     "bf16_bound_by": tb["bound_by"],
                     "bf16_library_ms": tb["library_ms"],
                     "empty_kernel_ms": t.get("empty_kernel_ms"),
                     "bf16_empty_kernel_ms": tb.get("empty_kernel_ms")})
        if name == "opt_update":
            rows[-1].update(
                resnet50_launches=resnet_launches["resnet50_training"]
                ["opt_update"],
                resnet50_bf16_launches=resnet_launches[
                    "resnet50_training_bf16"]["opt_update"])
        if name in ("rnn_scan_fwd", "rnn_scan_bwd"):
            rows[-1].update(cells_launches=cells[name],
                            cells_path="cell_lm_training")
        if name in FLEET_KERNELS:
            rows[-1].update(fleet_launches=fleet[name],
                            fleet_path="bert_base_supervised_serving")
        if name in DATA_KERNELS:
            rows[-1].update(data_launches={p: data[p][name]
                                           for p in DATA_KERNELS[name]},
                            data_path=list(DATA_KERNELS[name]))
        if name in TELE_KERNELS:
            rows[-1].update(telemetry_launches=tele[name])
        if name in TUNE_KERNELS:
            rows[-1].update(tuning_launches=tune[name])
        if name in ANALYSIS_KERNELS:
            rows[-1].update(analysis_launches=analysis[name])
        if name == "opt_update":
            rows[-1].update(ssd_launches=dict(zip(
                SSD_PATHS, (c["opt_update"] for c in ssd))))
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
