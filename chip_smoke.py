#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases (any failure raises and the script exits non-zero). Phases 1-3
run alone; then phases 11-14, 16, 19 and 21 run in that order in a
second process, the lane (``--lane``), beside phases 4-10, 15 and 22 in
this one: the ranks of the lane's phases mostly wait on the host (start-ups,
gloo) and leave the card idle, so the two share it. The lane's lines are
printed, on the script's clock, when this process has ended phase 15 and
joined it; phase 20 runs after both, alone, since its drills time ejects
and readmissions. Host-clock times of either lane's phases are taken
beside the other's work; the kernel times of phase 3 are taken alone.
Every process the script starts ends with the process that started it
(a watcher thread in each), and the script's last act stops whatever a
failure left running.

  1. device — requires ``torch.cuda.is_available()``; prints the card's
     name and power limit (nvidia-smi). TF32 is switched off for matmuls
     and cuDNN, so f32 references are full f32.
  2. build — compiles every kernel under
     ``distributed_tensorflow_framework_torch/ops/csrc/`` (one nvcc per
     source, in parallel) and prints the build seconds, then per kernel
     function its registers and spill bytes (ptxas) and its count of
     tensor-core instructions (HMMA/HGMMA in ``cuobjdump -sass``). The
     bf16 tensor-core kernels (``*_tc_kernel``: the forward, the two-pass
     pair and the fused one-pass kernel) must have some, and none may
     spill at D = 64. A line per (D, segmented) sets the fused kernel's
     count beside the dK/dV kernel's (five products against four).
  3. kernel parity — the forward kernel against its plain PyTorch version
     on the card, bf16 and f32, at (B,H,S,D) = (8,12,512,64), (2,4,128,32),
     (2,4,64,32), (2,2,256,128) and the ragged (2,3,96,32): no mask,
     trailing padding, packed segment ids, one fully-masked row (whose o
     must be V's mean); a second launch must give the same bits (no
     atomics). Then q and k as views that break the 16-byte rule (a 2-byte
     storage offset, an odd sequence stride): the wrapper copies them, and
     the outputs equal the aligned operands'. At the serving shape, times
     the kernel (with its TFLOP/s) and
     ``torch.nn.functional.scaled_dot_product_attention`` (the yardstick;
     the port never calls it) by their device kernel time, since the host
     work of each call outlasts its kernel, and the plain version by CUDA
     events, beside the bound.
  3b. backward kernel parity — the dQ and dK/dV kernels against their
     plain versions (dq, dk, dv, dbias_h) at the same five shapes, bf16 and
     f32, the same four cases; on the fully-masked row each key's dv must
     be the row's summed dO (p = 1, the TPU semantics), and a second launch
     of each kernel must give the same bits (no atomics). The fused
     one-pass kernel in the same cases: its dk, dv and dbias_h equal the
     pair's bit for bit (one key-block body in each dtype) and a relaunch's,
     its dq lies within GRAD_RTOL of the pair's and of the plain version's
     (dq is summed by f32 atomics, so its last bits may vary). Then the
     misaligned q and k views of phase 3, through the pair and through the
     fused kernel. Times
     each kernel (device time, with CUDA events beside it), its plain
     version and the backward of ``scaled_dot_product_attention`` (the
     yardstick for the pair) at (8,12,512,64) bf16 with padding, beside
     the bounds.
  3c. long-context kernel parity — at the streaming lengths (1,2,8192,64)
     and (1,2,16384,64), bf16 and f32, with padding and with segment ids:
     the forward kernel against the streaming forward's plain version, and
     the two-pass dQ/dK/dV kernels and the fused one-pass kernel each
     against the plain backward and the fused kernel against the two-pass
     kernels, whose dk, dv and dbias_h it must equal bit for bit. Then the
     fused kernel on the ragged (2,3,96,32), bf16 and f32, and at
     (2,2,2048,64) bf16 (where it takes over the whole-K pair), all four
     cases. The forward's o is held relative to the case's largest |o|.
     Times the forward, dQ and dK/dV at (1,12,16384,64) and the fused
     kernel at (1,12,8192,64), bf16, with their TFLOP/s, beside their plain
     versions, their bounds and SDPA's forward or backward device time;
     then the fused kernel against the two-pass pair in turns at
     (1,12,8192,64) and in the whole-K takeover band, (4,12,2048,64) and
     (2,12,4096,64) bf16, where auto must pick the fused kernel on a card
     listed in FUSED_BWD_VERIFIED_DEVICES and the pair elsewhere.
  4. serve — full-width BERT-base (12 x 768, 12 heads, MLP 3072, vocab
     30522, max_seq_len 512, bf16, fused QKV, attention_impl pallas) with
     weights from a seed, written as a port artifact; the server is started
     through ``cli/serve.py``'s ``main`` (port 0, seq buckets 128/256/512)
     and answers concurrent ``POST /predict`` requests of different
     lengths; a 512-token request goes through ``engine.predict``. Each
     run checks HTTP 200, shapes, finiteness, that the kernel launched 12
     times per batch, and one request's logits against the same model run
     with the kernel's plain version. The server runs with
     ``decode.enabled`` (DECODE_OVERRIDES), and one ``POST /generate``
     (phase 17a) and phase 18b's traced requests follow the requests.
     SIGTERM drains the server.
  5. train — ``cli/train.py``'s ``main`` on ``configs/bert_base_mlm.yaml``
     at full width and depth (dropout 0.1, AdamW, clip 1.0) for 30 steps,
     its checkpoint and resilience sections live: the recovery ladder
     armed, the background prefetcher, an async final save. Only
     ``checkpoint.directory`` is moved into the script's temporary workdir,
     so no earlier run's checkpoint is restored. The batch goes from 256
     to 32 x 512 so that activations and the f32 logits fit one card.
     Checks rc 0, finite metrics, one committed checkpoint at step 30 and
     the launch counts: forward 12 x (30 steps + 2 eval batches), dQ and
     dK/dV 12 x 30, fused 0. Prints the steady step time (and the first
     window's, which holds the kernel builds and the ladder's baseline
     snapshot), tokens/s, peak memory, the save's ``ckpt_save_blocked_ms``
     and ``ckpt_save_total_ms``, then one profiled step by kernel class,
     the device idle share and the ladder snapshot's device-to-host time.
  5b. training parity and learning — one step's gradients at 8 x 512
     through the kernels against the same model and dropout stream with
     the kernels' plain versions; every leaf within MODEL_GRAD_RTOL and a
     non-zero QKV weight gradient. Then 30 steps on one repeated batch at
     a constant lr of 1e-4: the loss at step 30 must be below 0.9 x the
     loss at step 1 (the first runs went 10.490 → 7.219 on an NVIDIA H100
     80GB HBM3 at 700 W).
  5c. resume — phase 5's run in two legs: 15 steps and a save into a
     fresh directory, then a new run restores step 15 and trains to 30.
     The losses at steps 10, 20 and 30 and every tensor of the step-30
     checkpoint (parameters, AdamW slots and steps, the dropout
     generator) must equal phase 5's bit for bit. Then ``--eval-only`` on
     that directory must print phase 5's eval exactly.
  5d. recovery ladder — at 8 x 512 through ``cli.train.main``:
     ``DTF_FAULTS=nan_grads:7`` (a snapshot every 2 steps) gives exactly
     one rollback, finite metrics to step 12, and a final checkpoint whose
     data state is past the skipped batches; ``repeat_nan`` on every
     replay of step 3 returns 85 after ``max_rollbacks`` rollbacks; a
     SIGTERM at step 4, once the CLI's handler is armed, returns 83 with a
     committed checkpoint at step 4 that a new trainer restores.
  5e. export — phase 5's step-30 checkpoint through ``cli/export.py`` into
     an artifact, loaded by the serving engine: one 512-token request's
     logits against the trained model's forward within LOGIT_MAX_ATOL and
     LOGIT_MEAN_ATOL.
  5f. packed training from records — ``data/progression.py`` authors a
     TFRecord corpus in the workdir (seq_len 512; 8,192 training documents
     of 32-224 real tokens in 8 shards; 1,000 eval documents, so the last
     eval batch of 32 is padded; seed 0). ``cli/train.py``'s ``main``
     trains ``configs/bert_base_mlm.yaml`` from it as written (packed 4:1,
     a 10,000-record shuffle buffer, dropout 0.1, AdamW, the ladder and
     the prefetcher live) at 32 x 512 for 30 steps, then evaluates the
     whole eval set once. Checks rc 0, finite metrics, the launch counts
     (forward 12 x 30 with segment ids plus 12 x 32 eval batches without,
     dQ and dK/dV 12 x 30 all with segment ids, fused 0), the last
     ``data_packing`` event against a host replay of the packed stream,
     and ``eval_examples`` against the masked positions of a host replay
     of the eval stream (integer equality: the exact-eval contract).
     Prints the steady step time, tokens/s, the packing efficiency, real
     tokens/s, the median ``time_infeed_ms``, peak memory and a profiled
     step by kernel class with the idle share. Then the same corpus
     unpacked (``pack_factor=1``, 30 steps) beside it, and one packed
     8 x 512 step's gradients through the segmented kernels against their
     plain versions, every leaf within MODEL_GRAD_RTOL.
  6. long-context training — ``cli/train.py``'s ``main`` on
     ``configs/bert_long_ring.yaml`` at its width (768, remat, dropout
     0.1, bf16), its depth cut from 12 layers to LONG_LAYERS (the
     script's time limit), on one card: ``mesh.seq=1`` and
     ``attention_impl pallas`` (ring attention is not ported), the
     config's checkpoint and resilience sections live (the directory in
     the workdir), 3 steps of the config's 8 rows in 8 micro-batches of
     one row. FUSED_BWD stays on auto and must pick the two-pass kernels
     at S = 16384 (above FUSED_BWD_MAX), and at S = 8192 the fused kernel
     on a card listed in FUSED_BWD_VERIFIED_DEVICES (the H100 80GB HBM3
     is), else the two-pass kernels. Checks rc 0, finite metrics and the
     launch counts per micro-batch: forward twice a layer (forward and
     recompute), dQ and dK/dV or fused once a layer. Prints the steady
     step time, tokens/s, peak
     memory, the final save's costs and one profiled step by kernel class.
  6b. fused vs two-pass at S = 8192 — one micro-step's gradients (dropout
     and remat on) with the fused backward forced on against the two-pass
     kernels, every leaf within MODEL_GRAD_RTOL; then the phase-6 step
     timed on each route in turns (host clock) and profiled once on each
     (kernel time, which the host's speed does not move). This drives each
     route through a full-width model step whichever one auto picks.
  7. image classification (no attention kernel on this path: cuDNN and
     cuBLAS through PyTorch). 7a: ``configs/lenet_mnist.yaml`` as written
     (2,000 steps of 128, f32, SGD with momentum) from a seeded
     ``mnist.npz`` of 6,000 + 1,000 learnable 28x28 images in the
     workdir; the loss must fall below half its first logged value, the
     exact eval must cover the 1,000 test images once and equal a CPU
     replay of the step-2000 checkpoint. 7b: ``configs/resnet50_cifar10.yaml``
     on one card as written (global batch 1024, bf16, SGD with momentum,
     lr 0.4, cosine with 500 warmup steps, weight decay 1e-4) for 30
     steps from a seeded ``cifar-10-batches-py`` (5 x 2,048 train, 2,000
     test images), then its exact eval (2,000 images); then the step on a
     resident batch, profiled by kernel class (convolutions, BatchNorm,
     GEMM kernels, the optimizer, the rest) with the idle share. 7c:
     ``configs/resnet50_imagenet.yaml``'s model on its synthetic fallback
     (224, the s2d stem, label smoothing 0.1, staircase, bf16 images), 20
     steps with the global batch cut from 4,096 to 256, and the same with
     the 7x7 stem; then each step alone on a resident batch, in turns, and
     profiled. Each run prints the steady ms/step, images/s, the median
     ``time_infeed_ms`` and peak memory beside the card's name and power
     limit. 7d: LeNet and small ResNets (CIFAR, 7x7 and s2d stems) on the
     card in f32 and bf16 against the same weights in f32 on the CPU (one
     train step's logits, gradients and running statistics, IMAGE_RTOL and
     IMAGE_GRAD_RTOL); then 7b's run under
     ``torch.use_deterministic_algorithms``, 30 steps straight against 15,
     a save, a restore and 15 more: the restored tensors equal the step-15
     checkpoint, and the step-30 checkpoints (parameters, BN buffers,
     momentum) and the losses after the split are bit-equal.
  8. data parallel (train/step.py under DDP, core/mesh.py). The card is
     one, and NCCL refuses two ranks on one device, so: 8a runs
     ``cli/train.py`` in a child process with the gang environment of a
     world of 1 (an NCCL group, the model under DDP) at phase 5's cut;
     its run_meta must name the NCCL group and DDP, its losses at the log
     steps must equal phase 5's bit for bit and the three attention
     kernels must have launched as in phase 5; its steady ms/step is
     printed beside phase 5's (DDP's cost at one rank). 8b: the same for
     7d's deterministic ResNet-50/CIFAR-10 run, whose losses it must equal
     bit for bit, after 8a in the same child (a group of its own, under
     deterministic algorithms). 8c: two child ranks of a gloo group on
     the one card (gloo carries all_reduce and broadcast of CUDA tensors),
     each feeding its block of the global batch, against one process
     taking the whole batch: ResNet-50 with the CIFAR stem in f32 at
     2 x 128 (the only run of the cross-rank BatchNorm on the card) and
     BERT at full width, 2 layers, f32, dropout 0, at 2 x (4 x 512) with
     different masked-token counts in the two blocks; losses and
     grad_norm at every step within
     DP_TOL; BERT's parameters after 3 steps within DP_TOL of the one
     process's; ResNet's parameters and running statistics after step 1
     no further from an f64 step of the same batch than DP_F64_RATIO
     times the one process's (the f32 step is itself ~6e-4 of its
     largest gradient from exact). The children are this script run as
     ``chip_smoke.py --child SPEC``; a child that fails fails the phase.
     Each wave of children logs its seconds: the slowest child's start-up
     (imports, CUDA), its work, and the rest (interpreter start and exit).
     The children of 8c, 10b, 13c and 13d start up held while the work
     before them in their phase runs, and start their own when released.

  9. ImageNet from records and Inception-v3 (no attention kernel on this
     path). First the JPEG toolchain (``jpeglib.h``, ``libjpeg.so*``,
     nvJPEG in the CUDA toolkit, the CPU count) and the native reader's
     build with the codec it found (libjpeg, else nvJPEG); where that is
     not libjpeg, its transforms of the committed libjpeg reference
     (``native/jpeg_reference.npz``) within CODEC_MEAN_TOL, and an
     encode/decode round trip within CODEC_ROUND_TRIP_TOL. 9a: the TF-free
     writer authors 4,096 train and 1,000 validation JPEG records in the
     workdir (seconds printed). 9b: the reader alone, images/s by path
     (native: DCT-scaled decode and bilinear; tf.data: the window at full
     scale and TF's bicubic) at 4 threads and at every CPU. 9c: config 3
     as written from the records (tf.data path, then the native path),
     RECORD_OVERRIDES' steps of 256 (cut from 4,096), each with its exact
     eval over the 1,000 validation images (eval_examples must be 1,000);
     9d: config 4 as written, the same steps of 256 (cut from 2,048), its
     exact eval too; then
     each model's step alone on a resident batch of its records,
     profiled by kernel class with the idle share and the peak memory.
     9e: Inception-v3 in f32 on the card against the CPU: eval logits
     within INCEPTION_EVAL_RTOL, train-mode logits, aux logits and
     gradients no further from an f64 run than INCEPTION_RATIO times the
     CPU's. 9f: ResNet-50's f32 step after one step against an f64 step
     with the port's BatchNorm, PyTorch's and Flax's formula (the port's
     no further than DP_F64_RATIO times Flax's formula's), then config
     3's step alone with the port's BN and Flax's formula in turns.
     ``--only 9abcdef`` (any of the letters) runs the toolchain check and
     those parts alone, a development run that prints no kernels line
     and no last line.
  10. explicit collectives (``train.spmd_mode: shard_map``,
     parallel/collectives.py). 10a: ``cli/train.py`` in a child with the
     gang environment of a world of 1 (an NCCL group) on
     ``configs/bert_base_mlm.yaml`` at phase 5's cut, under shard_map with
     the int8 error-feedback wire (block 256): its run_meta must name the
     NCCL group, shard_map, int8, error feedback and the native transport;
     the ``collectives`` tally of its train_step events must hold the
     int8 scatter and gather bytes, with the wire bytes at most a third of
     the logical; its losses must be finite, the last below the first, and
     within COLL_LOSS_TOL of phase 5's at the log steps; the attention
     kernels must launch as in phase 5. Prints its steady ms/step beside
     phase 5's and 8a's, its peak memory and the residual's size (4 bytes
     a parameter, read from its step-30 checkpoint), then the same step in
     this process profiled by kernel class. 10a': the same for 10
     steps with no wire, whose losses must be phase 5's bit for bit, after
     10a in the same child. 10b:
     two child ranks of a gloo group on the card run every function of
     parallel/collectives.py in every wire mode on seeded tensors of
     BERT-base leaf shapes, on CUDA tensors (gloo's all_reduce transport)
     and on CPU tensors (gloo's native ops): bit-equal, with equal
     tallies; then config 1's LeNet under shard_map at 2 x 64: 10 steps
     with the int8 error-feedback wire within COLL_LOSS_TOL of the f32
     run, and 5 steps, a save, a restore and 5 more under
     ``torch.use_deterministic_algorithms`` bit-equal to 10 straight steps
     (parameters, momentum and residual). Prints the phase's seconds.
  11. ZeRO and FSDP (``optimizer.zero_sharding``, ``mesh.fsdp``;
     parallel/zero.py, parallel/sharding.py), two child ranks of a gloo
     group on the card. 11a: ``configs/bert_base_mlm.yaml`` at full width,
     its depth cut to ZERO_LAYERS, through the Trainer, ZERO_STEPS steps
     of 32 x 512 (16 rows a rank, synthetic), ZERO_OVERRIDES (clipping off
     so that every mode runs the same config), in three modes: (i) the
     replicated shard_map step, (ii) ZeRO on the f32 wire, (iii) ZeRO on
     the int8 error-feedback wire. (ii)'s losses and last-step parameters
     must equal (i)'s (bit for bit
     expected; else within ZERO_LOSS_RTOL and the run's largest lr times
     its steps, the first differing leaf named); (iii)'s losses within
     COLL_LOSS_TOL of (ii)'s; the tally's ``zero_*`` wire bytes at least
     3x fewer on int8; (ii)'s checkpoint slots stacked as (2, chunk) rows;
     each rank's slots halved; the attention kernels launched
     ZERO_LAYERS x ZERO_STEPS times a kernel by each rank in each mode.
     Prints per rank the bytes of the parameters, slots and residual at
     rest, the peak memory, and the ms/step (gloo moves CUDA tensors
     through the host: not a scaling figure). 11b, in the same children
     after 11a: 8c's cut (2 layers, f32) under deterministic algorithms:
     explicit FSDP against the replicated shard_map step, jit FSDP and
     ZeRO-1 against DDP at ``mesh.data=2``, each bit-equal,
     parameters (FSDP) or slots (ZeRO-1) halved at rest. 11c: ZeRO on the
     int8 wire at that cut, 2 steps, a save, a restore into a state from
     another seed and 2 more, bit-equal to 4 straight steps (parameters,
     slots, residual). ``--only 11`` runs the kernels' build and phase 11
     alone, a development run that prints no kernels line and no last
     line.
  12. tensor parallelism (``mesh.model``; parallel/tensor_parallel.py),
     two child ranks of a gloo group on the card at ``{data: 1, model:
     2}``, both on the same rows. 12a: ``configs/bert_base_mlm.yaml`` as
     written (bf16, the flash kernels, fused QKV, dropout 0.1, clipping
     1.0) but for its depth, cut to TP_LAYERS, through the Trainer,
     TP_STEPS steps of 16 x 512: the
     losses finite and equal on both ranks at every step; every replicated
     leaf (LayerNorms, biases, ``pos_embedding``, the MLM head) bit-equal
     across the ranks after the last step (the data and the dropout masks
     are shared); each split leaf at its part's shape; each attention
     kernel launched TP_LAYERS x TP_STEPS times by each rank, on 6 heads.
     Prints
     per rank the parameter and slot bytes at rest (against one
     process's), the peak memory and the ms/step (gloo through the host,
     not a scaling figure). 12b: 12a at dropout 0 against one process
     without TP on the same batches, losses and grad_norm at every step
     within TP_LOSS_TOL, the leaf that differs most at the last step
     named. 12c: 8c's cut (2 layers, f32) under deterministic algorithms:
     TP against one process within TP_F32_RTOL; 2 steps, a save, a
     restore into a state from another seed and 2 more, bit-equal to 4
     straight steps; the checkpoint read by one process gives the
     gathered whole parameters bit for bit. ``--only 12`` runs the
     kernels' build and phase 12 alone (no kernels line, no last line).

  13. sequence parallelism (``mesh.seq``, ``attention_impl: ring``;
     parallel/ring.py), children of gloo groups on the card. 13a: the
     kernels where the ring puts an lse cotangent, at (1,12,2048,64) and
     (1,12,8192,64), bf16 and f32: q's segment ids from one chunk of a
     packed row and the keys' from the chunk before (most query rows see
     no key), a key bias, a random dO and dlse; the forward kernel against
     its plain version, the pair (whole-K at 2048, streaming at 8192) and
     the fused kernel against the plain backward, phase 3b's tolerances.
     13b: ``configs/bert_long_ring.yaml`` as written (bf16, remat,
     dropout 0.1, ring at ``mesh.seq`` 8: 2048-token chunks) but for its
     depth, cut from 12 layers to RING_LAYERS, through the Trainer on
     eight ranks, RING_STEPS steps of 8 rows, one row per micro-batch:
     losses finite and equal on every rank, the parameters bit-equal
     across the ranks after the last step (a digest each), each rank's
     attention kernels launched the layers x 8 chunks x
     the micro-batches times (twice for the forward: the remat
     recompute); per rank the peak memory and step times (gloo through
     the host, not a scaling figure). 13c: ``{data: 1, seq: 2}`` at 16384
     (8192-token chunks), 2 layers, dropout 0, RING_PAIR_STEPS steps,
     against one process (seq 1, pallas) within RING_LOSS_TOL, the leaf
     that differs most named. 13d:
     four ranks at ``{data: 2, seq: 2}``, 8c's cut in f32 with ring
     attention, packed 4:1 from a corpus of data/progression.py, under
     deterministic algorithms, on the kernel route (FLASH_CHUNK_MIN 0) and
     the plain chain, each against one process within DP_TOL; 1 step, a
     save, a restore into another seed's state and 2 more, bit-equal to
     the kernel route's 3 steps; the checkpoint read by one process bit
     for bit.
     ``--only 13`` runs the kernels' build and phase 13 alone (no kernels
     line, no last line).
  14. pipeline parallelism (``mesh.pipe``, ``model.pipeline_stages``;
     parallel/pipeline.py), four children of one gloo group on the card.
     14a: ``configs/bert_base_mlm.yaml`` at full width (12 layers, bf16,
     pallas, fused QKV) at ``{data: 1, pipe: 4}``, 8 microbatches of the
     32-row global batch, dropout 0, through the Trainer for PIPE_STEPS
     steps under gpipe, 1f1b and interleaved (v 3, one layer a chunk):
     losses finite and equal on the four ranks and across the schedules
     at the first step, the embedding and head bit-equal across the ranks
     after the last step (a digest each), each rank's launches as
     predicted (3 layers x 8 microbatches a step of the forward, twice
     under 1f1b for the recompute, and of dQ and dK/dV), the first step's
     loss within PIPE_LOSS_TOL of one process's ``BertForMLM`` on the same
     weights and batch; per rank the peak memory and ms/step (gloo through
     the host, not a scaling figure). 14b: f32 at ``{data: 2, pipe: 2}``,
     8c's cut (2 layers, one a stage), 4 microbatches, gpipe and 1f1b
     against one process within DP_TOL; a 1f1b run with dropout 0.1 under
     deterministic algorithms: 2 steps, a save, a restore into another
     seed's state and 2 more, bit-equal to 4 straight steps; the checkpoint
     read by one process bit for bit. ``--only 14`` runs the kernels'
     build and phase 14 alone (no kernels line, no last line).
  15. Mixture-of-Experts (``model.num_experts``, ``mesh.expert``;
     models/moe.py, parallel/expert.py): ``configs/bert_base_mlm.yaml`` at
     full width with MOE (4 experts in layers 1, 3, ..., 11, top-2,
     capacity 1.25, the sorted dispatch). 15a: an artifact from the seed
     served through ``cli/serve.py``'s main, one 512-token request: 12
     forward launches a batch, its logits against the same model with the
     kernel's plain version (tokens whose route, every MoE layer's two
     choices and their placement, is the same on both sides within the
     serving tolerances; the share of tokens routed otherwise at most
     MOE_ROUTE_FLIPS). 15b: ``cli/train.py``'s main at full width and
     depth, 32 x 512, dropout 0.1, MOE_STEPS steps with the ladder and the
     prefetcher live: rc 0, finite losses, ``moe_aux_loss`` and
     ``moe_drop_frac`` in [0, 1], the launches, the MoE collapse hook
     armed; the steady ms/step, tokens/s, peak memory and one profiled
     step by kernel class with the dispatch's sort, gather and scatter
     kernels in a class of their own. 15c: 2 layers in f32, one step's
     gradients through the kernels against their plain versions (every
     leaf within MODEL_GRAD_RTOL), the sorted and dense dispatchers at
     (8, 512) giving the same tables and the same layer output, the router
     z-loss armed once. 15d: two gloo children at ``{data: 1, expert: 2}``:
     MOE_EP_LAYERS layers in bf16 through the Trainer, each rank holding
     two of every MoE layer's four experts (bytes at rest, peak, ms/step,
     the ranks' losses equal); then 8c's cut in f32 against one process
     within DP_TOL, and its checkpoint (written at ``expert: 2``) read by
     one process bit for bit. ``--only 15`` runs the kernels' build and
     phase 15 alone (no kernels line, no last line).
  16. precision and remat (``precision.*``, ``model.remat``;
     models/remat.py, models/layers.py's int8 codec, parallel/zero.py's
     fused walk), through the StepBuilder on synthetic streams of each
     config's shapes. 16a: ``configs/bert_base_mlm.yaml`` at full width
     and depth, 32 x 512, without remat and with ``model.remat`` under
     ``precision.remat_policy`` none, save_nothing and dots_saveable:
     one step under deterministic algorithms, whose parameters must equal
     the no-remat arm's bit for bit, then REMAT_STEPS steps timed (ms/step
     and peak memory per arm), the launches as predicted (the forward
     twice a layer under remat). 16a': ``activation_dtype: f32`` over the
     bf16 config at 2 layers, the compute in f32 and the f32 kernels
     launched. 16b: ``configs/bert_long_ring.yaml`` as written at 8192
     (12 layers, remat, one row a micro-batch), its remat against
     dots_saveable, peak and step time. 16c: ResNet-50/CIFAR-10 (config
     2, 1024 rows, bf16) without remat, full, conv_saved and save_nothing:
     two deterministic steps whose parameters and BatchNorm statistics
     must equal the no-remat arm's bit for bit, then timed steps. 16d:
     ``quantized_matmul`` on the card against the same function on the
     CPU (its plain version: the forward bit for bit, the gradients within
     INT8_GRAD_RTOL) and its forward time beside a bf16 matmul; LeNet-5
     (config 1) and ResNet-50/CIFAR-10 at INT8_RESNET_ROWS
     rows with ``matmul_dtype: int8`` beside the same runs in bf16:
     finite losses, f32 masters, ms/step and peak. 16e (two children of
     its own): at 11a's cut, ZeRO unfused
     and fused on the f32 and int8 wires (FUSED_STEPS steps), the fused
     parameters and slots bit-equal to the unfused on f32 (the int8 gap
     printed), and a fused checkpoint restored into an unfused run
     refused. ``--only 16`` runs the
     kernels' build and phase 16 alone (no kernels line, no last line).
  17. serving beyond the forward: the decode engine (serve/decode.py, the
     f32 walk of models/bert.py), classification artifacts, live reload
     and the registries. No flash kernel lies on these paths (the JAX
     decode forward attends in plain jnp), so the record's launches are
     unchanged. 17a, right after phase 4 in its process: phase 4's server
     answers ``POST /generate`` with a chunked NDJSON stream
     (DECODE_HTTP_NEW token lines, a done line, the step header); then on
     phase 4's artifact with 16-token pages, 8 streams and 257 pages,
     continuous against static over DECODE_PROMPTS seeded prompts of
     16-256 tokens at DECODE_NEW new tokens each (tokens/s, TTFT p50/p99,
     per-step ms p50, mean occupancy, pages in use); a probe stream alone
     against the same stream among neighbours (bit-equal logits, or the
     largest gap with the tokens held equal); the two longest prompts in
     a pool too small for both, which must evict and still give the
     uncontended tokens; int8 pages against f32 (DECODE_INT8_RTOL); the
     probe's prefill and first two decode steps against the same walk in
     f64 on the CPU (DECODE_F64_RTOL); one decode step and one prefill
     timed and profiled by kernel class beside the step's bound. 17c: a
     model and a dataset registered by name train REGISTRY_STEPS steps on
     the card through the Trainer. 17b, at the end of phase 7:
     ResNet-50/CIFAR-10 (config 2) exported from phase 7d's step-15 and
     step-30 checkpoints; ``POST /predict`` of 32x32x3 rows against the
     model called directly (CLASSIFY_RTOL, bf16); ``POST /reload`` to the
     step-30 artifact while two clients keep sending requests: none may
     fail, every reply before the reload says step 15 and every reply
     after it step 30, and after the swap a request alone equals a cold
     engine's reply on the step-30 artifact (bits, or the gap within
     CLASSIFY_RTOL). ``--only 17`` builds the kernels and runs phase 4,
     17a, 17c and 17b on two checkpoints of a short config-2 run (no
     kernels line, no last line).
  18. observability (core/profiling.py, core/trace_analysis.py,
     core/memstats.py, core/goodput.py, core/tracing.py; no flash kernel
     of its own). 18a, after phase 5f: ``cli/train.py``'s ``main`` on
     phase 5's run (BERT-base at full width and depth, 32 x 512, the
     config's checkpoint and resilience sections live) for 9 steps with
     ``train.profile_start=6``/``profile_stop=9`` and
     ``train.memory_analysis`` (OBS_OVERRIDES). The window's Kineto trace
     goes through the port's analyzer, whose report is printed; the
     forward, dQ and dK/dV kernels must appear in the trace exactly as
     often as their launch counters rose over the window's 3 steps (36
     each), the coverage lie within OBS_COVERAGE_TOL of 1, the
     optimizer_update time be nonzero; the launch gap's share is printed
     beside phase 5's idle share, and the ``trace_summary`` event must
     validate. The first step's memory analysis must lie between the
     state's bytes (the step-9 checkpoint's) and the card's capacity, the
     card's capacity equal core/roofline.py's, every memory sample read
     the card's allocator, every event validate and the final goodput
     buckets sum to the wall within OBS_GOODPUT_RTOL. Prints the
     profiler's cost (ms/step inside the window against steps 4-6) and
     phase 5's steady ms/step with spans, goodput and memory sampling on.
     18b, on phase 4's server: TRACED_REQUESTS ``/predict`` requests with
     an ``X-DTF-Trace`` header each must give ``serve.request`` →
     ``engine.queue``/``engine.batch`` → ``engine.compute`` under the
     client's trace id, one with a malformed header answers 200 untraced,
     ``/healthz``'s ``memory`` must read the card's allocator, and a
     SIGUSR1 must write the flight recorder's ``dtf-flightrec/1`` dump
     holding the traced spans. ``--only 18`` builds the kernels and runs
     phase 4 with 18b, then 18a (no kernels line, no last line).
  19. elastic and gang resilience (cli/train_cluster.py,
     cli/launch_local_cluster.py, core/cluster.py, core/supervision.py,
     ckpt/reshard.py, core/faults.py; the flash kernels in every rank).
     The port's gang supervisor, each a process of this script under
     ``--gang-supervisor``, runs ``configs/bert_base_mlm.yaml`` at full
     width and GANG_LAYERS layers, 8 x 512 on two gloo ranks of the card
     at ``{data: 2}`` with a checkpoint every 2 steps (GANG_OVERRIDES);
     each rank is this script under ``--rank-worker`` (``cli.train.main``
     under torch.use_deterministic_algorithms, phase 7d's settings, its
     launch counts written when it ends). 19a: a control gang of
     GANG_STEPS steps beside the same run under ``kill_worker:1:2``
     (GANG_TICK_S ticks): the attempts must be ``crashed`` (worker 1, rc
     137) then ``done``, the last step's loss and every parameter tensor
     of the last checkpoint equal the control's bit for bit, and each
     relaunched rank must have launched the forward, dQ and dK/dV
     kernels. 19b, from the control's step-2 checkpoint once it commits,
     DROP_STEPS more steps under ``drop_worker:1:2`` with
     ``--max-attempts 1``: ``gang_refit`` then ``done``, ``mesh_resized``
     with process_count 1, dropped [1], ``data`` 1, the effective batch
     kept ((global_batch, grad_accum) (4, 2)), and the survivor's
     ``ckpt_resharded`` from ``{data: 2}``, with the kernels launched.
     19c: the control's checkpoint in one process without
     ``checkpoint.allow_reshard`` raises MeshTopologyError naming both
     meshes, its export without ``serve.allow_reshard`` names that knob;
     the restore's seconds with the reshard and on the same mesh (the
     survivor's checkpoint) are printed. Each run prints its start-up and
     step seconds and the restart gap. ``--only 19`` builds the kernels
     and runs phase 19 alone (no kernels line, no last line).
  20. the serving fleet (serve/fleet.py, serve/autoscale.py, cli/fleet.py,
     core/faults.py's fleet kinds; the forward kernel in every replica). The
     router runs in this process over FLEET_REPLICAS replicas of a BERT-base
     artifact at full width and depth (weights from a seed; buckets
     128/256/512, max batch 8, ``serve.data=-1``, DECODE_OVERRIDES), each
     this script under ``--replica-worker`` (``cli.serve.main``, its
     launches written when it ends), started held while phase 15 runs and
     the lane ends; FLEET_KNOBS cut the router's timeouts. FLEET_CLIENTS
     stdlib client threads send ``/predict`` of FLEET_ROWS rows of
     FLEET_TOKENS tokens (see FLEET_TOKENS for why so short). 20a:
     FLEET_CHECKS answers through the fleet, both replicas routed, each
     bit-equal to the same request sent alone to the replica that served it.
     20b: ``kill_replica:0`` at the fleet_chaos point under traffic: no
     failed request, the eject, the supervised restart and the readmit with
     their seconds, the router's flight-recorder dump naming r0. 20c:
     ``stall_replica:1`` for FLEET_STALL_S with a request in flight on it:
     no failed request, r1 ejected and readmitted after the SIGCONT. 20d:
     ``POST /reload`` to a second artifact under traffic: no failed request,
     its digest on both replicas, then a request alone bit-equal to a cold
     engine on it; a ``corrupt_reload`` roll refused at r0 (409) with the
     digest kept everywhere. 20e: ``/generate`` with ``X-DTF-Session`` lands
     on one replica, gets 409 + Retry-After while it drains in 20d's roll
     and lands there again. 20f: ``python -m ...cli.fleet --device cuda
     --replicas 1`` (run as ``-m`` runs it, by this script's
     ``--watched-module``) through its endpoint (role fleet, 20a's first
     answer bit for bit), then SIGTERM: exit 0 and its replica gone. Every
     replica that ended 0 must have launched the forward kernel. ``--only
     20`` builds the kernels and runs phase 20 alone (no kernels line, no
     last line).
  21. the composed training meshes — one wave of four gloo ranks on the
     card (started held during phase 19). 21a: MoE BERT-base (phase 15's
     setting: 4 experts every second layer, top-2, the flash kernels) at
     full width and COMPOSE_LAYERS layers, bf16, through the Trainer at
     ``{data: 1, expert: 2, model: 2}``: each rank holds 2 of each MoE
     layer's experts at F/2 and 6 of the 12 heads; then 8c's cut with MoE
     in f32 at that mesh against one process within DP_TOL. 21b:
     BERT-base at full width, rows of 4096 tokens, ring attention at
     ``{data: 1, fsdp: 2, seq: 2}`` with ZeRO-1, bf16, through the
     Trainer: each rank's 2048-token chunks take the flash kernels with
     their lse; then the same in f32 at a cut against one process on
     the same batches (pallas at 4096) within DP_TOL, a resume bit-equal
     to straight steps and the checkpoint read by one process (the
     one-process references computed while the ranks work). 21c: the
     A10 path, 6 heads at ``{data: 1, model: 4}``, f32 at 384 wide,
     against one process within DP_TOL. The launches of the ranks'
     main-path runs (21a's and 21b's Trainer runs, 21c's) join the
     record. ``--only 21`` builds the kernels and runs phase 21 alone (no
     kernels line, no last line).
  22. data-parallel serving (serve/engine.py ``serving_devices`` and the
     sharded batch, serve/decode.py, core/memstats.py; the forward kernel
     in every shard), in this lane after 17b. 22a: ``serving_devices``
     gives every card for -1 and 0 and cuda:0 for 1; ``serve.data=2`` on
     one visible card raises MeshSizeError. 22b: phase 4's BERT-base
     artifact in engines at ``devices`` [cuda:0] x DP_SERVE and [cuda:0],
     on a request of each DP_SERVE_REQUESTS (1, 3 and 5 rows, one batch
     each; the last row of each with trailing padding): the ladders and
     padded rows, the forward kernel launched 12 x DP_SERVE a batch (12
     at one replica) with no plain version called (its functions wrapped
     with a counter), the shards on DP_SERVE streams, each launch's o
     against ``flash_attention_reference`` within O_RTOL of its max|o|
     (phase 3c's measure: the layers' o exceeds 1), and the logits
     against one replica's within LOGIT_MAX_ATOL/LOGIT_MEAN_ATOL (bit
     equality printed); then the engines' compute ms per 8 x 512 batch in
     turns and the peak memory. 22c: a reload to a second artifact (weights
     from a seed) while two clients send 3 x 128 requests: no failed
     request, every answer before it the old weights' and after it the
     new's, every replica holding the new tensors, and a 4 x 256 request
     (two shards) against a cold engine at DP_SERVE. 22d: 17b's ResNet-50
     artifact at DP_SERVE replicas against one on 1, 3 and 5 rows within
     CLASSIFY_RTOL, the BatchNorm statistics on every replica, ms per
     8-row batch. 22e: the decode engine at DP_SERVE devices has the
     ladder of DP_SERVE multiples and one device's tokens. Two replicas on
     one card show the split, not a speed-up. The launches of 22b's and
     22c's engines join the record, and 22b's o error its max_abs_err.
     ``--only 22`` builds the kernels and runs phase 22 alone on
     artifacts from seeds (no kernels line, no last line).

Every count is set to 0 just before a main-path run (the serve runs, the
training runs, the resumed, rolled-back, preempted, evaluated and
exported runs, the packed and unpacked runs, the runs of 8a, 10a, 10a',
11a, 12a, 13b, 14a, 15a, 15b, 15d, 16a, 16a', 16b, 16e, 18a, 19, 20,
21 and 22, whose children and replicas set and read their own counts)
and read just after; launches made to compare or time a kernel do not
count. The record's ``launches`` are those of phases 4, 5, 5f, 6, 8a,
10a, 10a', 11a, 12a, 13b, 14a, 15a, 15b, 15d, 16a, 16a', 16b, 16e, 18a,
19 (the relaunched ranks of 19a and 19b's survivor), 20 (the replicas
that ended 0), 21 (21a, 21b and 21c on each rank) and 22 (22b and 22c),
and its ``max_abs_err`` covers phases 3, 3b, 3c, 13a and 22b; its
``segmented_launches`` (launches with segment ids) those of phase 5f. Where auto picks the fused kernel nowhere on this
card, its ``launches`` in the record are those of phase 6b's forced
micro-step, marked ``launches_forced``. The line before the last is the
card's ``nvidia-smi`` name and power limit; the line before that the
per-kernel JSON record; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

SEED = 0
H100_BF16_FLOPS = 989e12   # dense tensor-core peak (H100 SXM data sheet)
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
_CSRC = "distributed_tensorflow_framework_torch/ops/csrc/"
SOURCES = {"fwd": _CSRC + "flash_attn_fwd.cu", "dq": _CSRC + "flash_attn_bwd.cu",
           "dkv": _CSRC + "flash_attn_bwd.cu",
           "fused": _CSRC + "flash_attn_bwd_fused.cu"}
# The TPU kernels each one replaces (def lines): whole-K and streaming.
_TPU = "distributed_tensorflow_framework_tpu/ops/flash_attention.py:"
REPLACES = {"fwd": [_TPU + "140", _TPU + "254"],
            "dq": [_TPU + "179", _TPU + "304"],
            "dkv": [_TPU + "213", _TPU + "347"], "fused": [_TPU + "403"]}
# Phases 3 and 3b: the serving and training shape, two small ones, D = 128
# and a length that is not a multiple of the kernels' 64-row tiles (rows and
# keys past S must contribute nothing).
PARITY_SHAPES = ((8, 12, 512, 64), (2, 4, 128, 32), (2, 4, 64, 32),
                 (2, 2, 256, 128), (2, 3, 96, 32))
# Phase 3c: the streaming lengths of the long-context runs, two heads.
LONG_SHAPES = ((1, 2, 8192, 64), (1, 2, 16384, 64))
KERNEL_NAMES = {"fwd": "flash_attn_fwd", "dq": "flash_attn_bwd_dq",
                "dkv": "flash_attn_bwd_dkv", "fused": "flash_attn_bwd_fused"}
# S x S x D products per kernel (attention_bound, attention_bwd_bounds).
PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4, "fused": 5}
# Kernel vs plain version, same inputs on the card. o: bf16 allows two ulps
# near 1 (the kernel rounds p against a running max, the plain version
# against the row max, so one rounding can differ); f32 sums the same
# products in another order. lse: relative, its terms are unrounded f32.
O_ATOL = {"bfloat16": 1.6e-2, "float32": 2e-5}
LSE_RTOL = 1e-5
# Phase 3c: o as max|err| over the case's max|o|. Over 8k-16k keys each o
# averages thousands of values (max|o| ~0.1), so an absolute limit near 1
# would pass an o that is 20% off. bf16: four ulps at the largest value
# (the output's rounding and p's rounding against another running max);
# f32: the same products summed in another order.
O_RTOL = {"bfloat16": 1.6e-2, "float32": 2e-5}
# Backward kernels vs their plain versions, as max|err| / max|ref| per
# output. dq, dk, dv in bf16: four bf16 ulps at the largest value, one for
# the output's own rounding and three for ds and p roundings that an f32
# summation-order difference in s or dp flips by one ulp. f32: 2e-5, the
# same products summed in another order. dbias_h sums unrounded f32 ds in
# both dtypes: 1e-5.
GRAD_RTOL = {"bfloat16": 1.6e-2, "float32": 2e-5}
DBIAS_RTOL = 1e-5
# Served logits vs the same model with the kernel's plain version: bf16
# activations through 12 layers, where a flipped bf16 rounding in one
# attention output propagates; logits have std ~0.55 at this init.
LOGIT_MAX_ATOL = 0.15
LOGIT_MEAN_ATOL = 1e-2
HTTP_LENGTHS = (4, 8, 12, 16, 24, 32)
# Phase 18b: requests to phase 4's server under a trace context each.
TRACED_REQUESTS = 3
# Phase 5: BERT-base training at full width and depth, with the config's
# checkpoint and resilience sections live; only checkpoint.directory moves
# into the script's temporary workdir (the config's /tmp path could hold
# an earlier run's checkpoints, which a run would restore). The batch goes
# from the config's 256 to 32 rows of 512 tokens so that activations and
# the f32 logits (32 x 512 x 30522) fit one card.
TRAIN_OVERRIDES = (
    "data.global_batch_size=32", "train.total_steps=30",
    "train.log_interval=10", "train.eval_steps=2", "train.eval_interval=0")
# Phase 5c: the same run in two legs, 15 steps, a save and a restore. The
# 10,000-step warm-up covers both legs, so the split does not move the
# schedule (which depends on train.total_steps).
RESUME_SPLIT = 15
# Phase 5d: the recovery ladder at 8 x 512. A snapshot every 2 steps and a
# fetch every 2 steps; nan_grads at step 7 is seen at step 8 and rolls back
# to 6, skipping batches 7 and 8. Then repeat_nan poisons step 3 on every
# replay until max_rollbacks is spent (rc 85), and a SIGTERM at step 4
# stops a run for a final save (rc 83).
LADDER_OVERRIDES = (
    "data.global_batch_size=8", "train.total_steps=12",
    "train.log_interval=2", "train.eval_steps=0",
    "resilience.snapshot_interval_steps=2")
NAN_STEP = 7
SIGTERM_STEP = 4
# Phase 5b: one step at 8 x 512, kernels against their plain versions.
# Gradients differ where the forward kernel's online softmax rounds a bf16
# p one ulp away from the plain version's (phase 3), and 12 bf16
# layers carry such flips into every gradient: tolerance per leaf, as
# max|err| over the leaf's max|grad|.
PARITY_OVERRIDES = ("data.global_batch_size=8",)
MODEL_GRAD_RTOL = 5e-2
# Then 30 steps on that one batch at a constant lr of 1e-4, no warmup: the
# loss at step 30 must be below LEARN_RATIO x the loss at step 1.
LEARN_OVERRIDES = ("optimizer.schedule=constant", "optimizer.warmup_steps=0",
                   "optimizer.learning_rate=1e-4", "train.total_steps=30")
LEARN_RATIO = 0.9
# Phase 5f: configs/bert_base_mlm.yaml trained from TFRecords, packed 4:1
# and shuffled from a 10,000-record buffer as written, 32 x 512 as in
# phase 5. The corpus is authored in the workdir by data/progression.py:
# 8,192 training documents of 32-224 real tokens (a quarter of a 512-token
# row on average, so 4:1 packing fits) in 8 shards (a full interleave
# cycle), and 1,000 eval documents in 4 shards, which is 31.25 batches of
# 32: the exact eval pads its 32nd batch.
PACKED_CORPUS = ("--seq-len", "512", "--train-seqs", "8192",
                 "--eval-seqs", "1000", "--shards", "8", "--min-doc", "32",
                 "--max-doc", "224", "--seed", str(SEED))
PACKED_EVAL_BATCHES = 32
PACKED_OVERRIDES = (
    "data.global_batch_size=32", "train.total_steps=30",
    "train.log_interval=10", "train.eval_interval=0")
# Phase 6: configs/bert_long_ring.yaml on one card, its checkpoint and
# resilience sections live (checkpoint.directory in the workdir). Ring
# attention (A11) is not ported, so the same model runs attention_impl
# pallas on a mesh of one. The config's global batch of 8 rows goes
# through in 8 micro-batches of one row, so that a 16k-token row's f32
# logits (2 GB) are the largest activation; the run is cut to 3 steps.
LONG_CONFIG = "configs/bert_long_ring.yaml"
LONG_OVERRIDES = (
    "mesh.seq=1", "model.attention_impl=pallas", "train.grad_accum_steps=8",
    "train.total_steps=3", "train.log_interval=1", "train.eval_steps=0")
# Phases 6 and 6b run the config at this depth, cut from its 12 layers to
# keep the script inside its time limit (their runs and four profiled
# steps took ~130 s at 12 layers); long_config checks the config as
# written.
LONG_LAYERS = 2
# Phase 6's sequence lengths. Both runs leave FUSED_BWD on auto, the choice
# users get: the two-pass pair at 16384 (above FUSED_BWD_MAX), and at 8192
# the fused kernel on a card listed in FUSED_BWD_VERIFIED_DEVICES, else the
# streaming two-pass pair (long_runs).
LONG_SEQS = (16384, 8192)
# The whole-K takeover band (bf16, 2048 <= S <= 4096), where auto picks the
# fused kernel over the two-pass pair on a listed card: both timed at 8192
# tokens per call.
BAND_SHAPES = ((4, 12, 2048, 64), (2, 12, 4096, 64))
# Phase 7: the image-classification configs. Their datasets are written in
# the workdir with numpy from SEED: each class is a fixed random template,
# and an image is its class's template at a random contrast under heavy
# noise (std 80 of 255), so the labels can be learnt, but not at once.
LENET_CONFIG = "configs/lenet_mnist.yaml"
CIFAR_CONFIG = "configs/resnet50_cifar10.yaml"
IMAGENET_CONFIG = "configs/resnet50_imagenet.yaml"
MNIST_SIZES = (6000, 1000)            # train, test
CIFAR_SIZES = (5, 2048, 2000)         # train batches x images, test
# 7a runs config 1 whole (2,000 steps). 7b runs config 2 as written but for
# the run length (30 of 20,000 steps) and a log every 10 steps (when the
# host syncs; the steady window needs more than one). 7c cuts config 3's
# pod-wide global batch of 4,096 to 256 and runs 10 steps on its synthetic
# fallback (IMAGENET_SYNTH_OVERRIDES), with the s2d stem as written and
# with the 7x7 stem beside it; 9c's record runs take 8.
CIFAR_OVERRIDES = ("train.total_steps=30", "train.log_interval=10")
CIFAR_RESUME_SPLIT = 15
IMAGENET_OVERRIDES = ("data.global_batch_size=256", "train.total_steps=20",
                      "train.log_interval=10")
# 7c's synthetic runs, cut to 6 steps (logged every 3) with a 2-batch
# eval, to keep the script inside its time limit.
IMAGENET_SYNTH_OVERRIDES = (*IMAGENET_OVERRIDES, "train.total_steps=6",
                            "train.log_interval=3", "train.eval_steps=2")
# 7a: the trainer's exact eval against a CPU replay of the same weights
# over the same 1,000 images, f32 on both sides (TF32 is off): the loss
# within 1e-4 relative (cuDNN and the CPU sum the products in other
# orders) and top-1/top-5 within one image (a logit near a tie may flip).
LENET_EVAL_RTOL = 1e-4
# 7d: the models on the card against the same model and weights on the
# CPU, one train step: logits and running statistics as max|err| over the
# largest reference value, gradients over the largest gradient. f32 (TF32
# off): other summation orders and algorithms, BN dividing by a batch std.
# bf16 on the card against f32 on the CPU: bf16 activations (8 bits of
# mantissa, 0.4% per rounding) through every conv and BN of the model.
IMAGE_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
IMAGE_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1.5e-1}


_START = time.perf_counter()
# The lane's log lines count from the script's start: its _START, on the
# machine's monotonic clock (perf_counter), which every process shares.
START_ENV = "CHIP_SMOKE_START"
# Every process this script starts, and every process those start, ends
# with the process that started it, whatever ended that one (a failure, a
# signal, a time limit): each runs :func:`watch_parent`, which reads its
# starter's pid here, and the script's last act stops what is left of its
# tree (:func:`stop_descendants`).
PARENT_ENV = "CHIP_SMOKE_PARENT"


def log(msg: str) -> None:
    """A line of the report, after the seconds since the script started
    (where the time limit goes)."""
    print(f"[{time.perf_counter() - _START:6.1f} s] {msg}", flush=True)


def _proc_stat(pid: int) -> tuple[str, int] | None:
    """(state, parent pid) of ``pid`` from /proc, or None if it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return None
    return fields[0], int(fields[1])


def _running(pid: int) -> bool:
    stat = _proc_stat(pid)
    return stat is not None and stat[0] not in ("Z", "X")


def watch_parent() -> None:
    """End this process as soon as the process that started it is gone:
    a daemon thread polls the parent pid, and on a change kills this
    process, with its process group when it leads one (cli/fleet.py's
    session: its replica too). The starter's pid comes from PARENT_ENV,
    so a starter that is already gone is seen; this process then puts
    its own pid there for what it starts."""
    parent = os.getppid()
    try:
        starter = int(os.environ.get(PARENT_ENV, ""))
    except ValueError:
        starter = parent
    os.environ[PARENT_ENV] = str(os.getpid())

    def end() -> None:
        if os.getpgrp() == os.getpid():
            with contextlib.suppress(OSError):
                os.killpg(os.getpid(), signal.SIGKILL)
        os.kill(os.getpid(), signal.SIGKILL)

    if starter != parent and not _running(starter):
        end()

    def watch() -> None:
        while os.getppid() == parent:
            time.sleep(0.2)
        end()

    threading.Thread(target=watch, name="chip-smoke-watch",
                     daemon=True).start()


def descendants(root: int | None = None) -> list[int]:
    """Every process below ``root`` (this one), from /proc's parent pids."""
    below: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            stat = _proc_stat(int(entry))
            if stat is not None:
                below.setdefault(stat[1], []).append(int(entry))
    out, todo = [], [os.getpid() if root is None else root]
    while todo:
        for pid in below.get(todo.pop(), []):
            out.append(pid)
            todo.append(pid)
    return out


def terminated(signum, frame) -> None:
    """SIGTERM in the script's own processes: exit through the cleanup
    (the ``finally`` at the end of the file) rather than at once."""
    del frame
    raise SystemExit(128 + signum)


def stop_descendants(timeout: float = 10.0) -> list[int]:
    """Kill every process below this one and wait until none runs; what
    the phases stop on their own is gone by then, so this finds only what
    a failure left. Returns the pids it found."""
    found = pids = descendants()
    for pid in pids:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + timeout
    while pids and time.monotonic() < deadline:
        with contextlib.suppress(ChildProcessError):
            while os.waitpid(-1, os.WNOHANG)[0] > 0:
                pass
        pids = [pid for pid in pids if _running(pid)]
        time.sleep(0.05)
    return found


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline_ms(moved_bytes: float, flops: float, elem_bytes: int):
    """Least time for the work: the bytes at the memory rate, the
    operations at the peak rate of the input type, whichever is longer.
    Returns (ms, "bytes" | "operations")."""
    peak = H100_BF16_FLOPS if elem_bytes == 2 else H100_F32_FLOPS
    t_bytes = moved_bytes / H100_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_flops(name: str, b, h, s, d) -> int:
    """Operations of kernel ``name``: PRODUCTS[name] S x S x D products of
    2*B*H*S^2*D each."""
    return PRODUCTS[name] * 2 * b * h * s * s * d


def tflops(name: str, b, h, s, d, ms: float) -> float:
    """Achieved TFLOP/s of kernel ``name`` at (b, h, s, d) in ``ms``."""
    return attention_flops(name, b, h, s, d) / (ms * 1e-3) / 1e12


def attention_bound(b, h, s, d, elem_bytes, segmented):
    """Forward kernel: q, k, v, bias (and segment ids) read once, o and lse
    written once; two products."""
    moved = 4 * b * s * h * d * elem_bytes + b * s * 4 + b * s * h * 4
    moved += 2 * b * s * 4 if segmented else 0
    return roofline_ms(moved, attention_flops("fwd", b, h, s, d), elem_bytes)


def attention_bwd_bounds(b, h, s, d, elem_bytes, segmented) -> dict:
    """dQ reads q, k, v, dO, bias, lse and delta and writes dq: three
    S x S x D products. dK/dV reads the same and writes dk, dv and the f32
    per-head dbias: four products. The fused kernel reads the same and
    writes dq, dk, dv and dbias: five products."""
    head = b * s * h * d * elem_bytes
    common = 4 * head + b * s * 4 + 2 * b * s * h * 4
    common += 2 * b * s * 4 if segmented else 0
    dbias = b * h * s * 4
    moved = {"dq": common + head, "dkv": common + 2 * head + dbias,
             "fused": common + 3 * head + dbias}
    return {name: roofline_ms(bytes_, attention_flops(name, b, h, s, d),
                              elem_bytes)
            for name, bytes_ in moved.items()}


# ---------------------------------------------------------------- phase 2

def ptxas_usage(log_text: str) -> dict:
    """{mangled kernel: (registers, spill store bytes, spill load bytes)}
    from ``nvcc -Xptxas -v`` output, where a "Compiling entry function"
    line names the function of the next "Used N registers" line and a
    "Function properties for" line the function of the next spill line."""
    regs, spills, name, props = {}, {}, None, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props is not None:
            spills[props] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            regs[name] = int(m.group(1))
    return {fn: (n, *spills.get(fn, (0, 0))) for fn, n in regs.items()}


def sass_tensor_ops(tools: str, library) -> dict:
    """{mangled kernel: count of HMMA and HGMMA instructions} from
    ``cuobjdump -sass`` of a built library."""
    sass = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass",
                           str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\b(HMMA|HGMMA)\.", line):
            counts[name] += 1
    return counts


def build_report(_build, result) -> dict:
    """Phase 2's lines for one built library: per kernel function its
    registers and spill bytes (ptxas) and its tensor-core instructions
    (cuobjdump). The bf16 tensor-core kernels must run on the tensor cores,
    and at D = 64, the main path's width, must not spill. Returns
    {short name: (registers, spill stores, spill loads, HMMA/HGMMA)}."""
    tools = os.path.dirname(_build.find_nvcc())
    usage = ptxas_usage(result.log)
    mma = sass_tensor_ops(tools, result.library)
    names = sorted(set(usage) | set(mma))
    demangled = subprocess.run([os.path.join(tools, "cu++filt")],
                               input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    log(f"  {result.source.name}: {result.seconds:.2f} s, "
        f"{sum(mma.values())} HMMA/HGMMA in {len(mma)} kernels")
    report = {}
    for mangled, full in zip(names, demangled):
        short = re.search(r"flash_attn_\w+(<[^>]*>)?", full).group(0)
        regs, stores, loads = usage.get(mangled, (None, None, None))
        report[short] = (regs, stores, loads, mma.get(mangled, 0))
        log(f"    {short}: {regs} registers, spill stores {stores} B, "
            f"spill loads {loads} B, {mma.get(mangled, 0)} HMMA/HGMMA")
        # cu++filt writes template arguments as "<(int)64, (bool)0>".
        d64 = re.search(r"<(\(int\))?64,", short) is not None
        if "_tc_kernel" in short and (
                not mma.get(mangled) or (d64 and (stores or loads))):
            raise AssertionError(f"{short}: expected tensor-core "
                                 f"instructions and, at D = 64, no spills")
    return report


def fused_beside_pair(report: dict) -> None:
    """One phase-2 line per variant of the fused tensor-core kernel, beside
    the two-pass dK/dV kernel with the same template arguments: registers,
    spill bytes and HMMA counts (the fused kernel's five products against
    the dK/dV kernel's four)."""
    for short, (regs, stores, loads, hmma) in sorted(report.items()):
        if not short.startswith("flash_attn_bwd_fused_tc_kernel"):
            continue
        args = short[short.index("<"):]
        pair = report.get("flash_attn_bwd_dkv_tc_kernel" + args)
        if pair is None:
            raise AssertionError(f"no dK/dV kernel beside {short}")
        log(f"  fused vs dK/dV {args}: registers {regs} / {pair[0]}, spill "
            f"bytes {stores + loads} / {pair[1] + pair[2]}, HMMA {hmma} / "
            f"{pair[3]} (ratio {hmma / pair[3]:.3f}, five products against "
            f"four: 1.25)")


# ---------------------------------------------------------------- phase 3

def attention_cases(torch, fa, gen, b: int, s: int) -> dict:
    """The masking cases every parity check runs: (key bias, segment ids
    or None) for no mask, trailing padding in row 0, three packed segments
    per row over that padding, and (where b > 1) row 1 fully masked."""
    zero = torch.zeros(b, s, device="cuda")
    pad = zero.clone()
    pad[0, s - s // 4:] = fa.NEG_INF
    seg = torch.zeros(b, s, device="cuda")
    for row in range(b):
        cuts = torch.randperm(s - 1, device="cuda",
                              generator=gen)[:2].sort().values + 1
        seg[row, cuts[0]:] = 1
        seg[row, cuts[1]:] = 2
    cases = {"none": (zero, None), "padding": (pad, None),
             "segments": (pad, seg)}
    if b > 1:
        dead = pad.clone()
        dead[1, :] = fa.NEG_INF
        cases["masked_row"] = (dead, None)
    return cases


def kernel_parity(torch, fa) -> dict:
    """The forward kernel against its plain version on the same inputs, at
    every PARITY_SHAPES shape, bf16 and f32, in the four masking cases; a
    second launch must give the same bits (each block owns its rows, no
    atomics). Then the misaligned views (misaligned_view_parity)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, h, s, d in PARITY_SHAPES:
            q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            for case, (bias, sg) in attention_cases(torch, fa, gen,
                                                    b, s).items():
                o, lse = fa.flash_attention_kernel(q, k, v, bias, sg, sg)
                o2, lse2 = fa.flash_attention_kernel(q, k, v, bias, sg, sg)
                torch.cuda.synchronize()
                ro, rlse = fa.flash_attention_reference(q, k, v, bias, sg, sg)
                o_err = (o.float() - ro.float()).abs().max().item()
                lse_err = ((lse - rlse).abs()
                           / rlse.abs().clamp(min=1.0)).max().item()
                finite = bool(torch.isfinite(o).all() and
                              torch.isfinite(lse).all())
                stable = torch.equal(o, o2) and torch.equal(lse, lse2)
                ok = (finite and stable and o_err <= O_ATOL[name]
                      and lse_err <= LSE_RTOL)
                if case == "masked_row":
                    uniform = v[1].float().mean(dim=0, keepdim=True)
                    ok = ok and bool(
                        (o[1].float() - uniform).abs().max()
                        <= O_ATOL[name] + 1e-6)
                    ok = ok and bool((lse[1] <= 0.99 * fa.NEG_INF).all())
                worst = max(worst, o_err)
                log(f"parity {name} (B,H,S,D)=({b},{h},{s},{d}) {case}: "
                    f"o max|err| {o_err:.3e} (tol {O_ATOL[name]}), lse "
                    f"rel err {lse_err:.3e} (tol {LSE_RTOL}), finite "
                    f"{finite}, two launches equal {stable} -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"kernel disagrees with its plain version: {name} "
                        f"({b},{h},{s},{d}) {case}")
    misaligned_view_parity(torch, fa, gen, "fwd")
    return {"max_abs_err": worst}


def kernel_timing(torch, fa) -> dict:
    """At the serving shape (B=8, H=12, S=512, D=64, bf16, padding mask):
    the kernel and SDPA on the same inputs by their device kernel time, the
    plain version by CUDA events. The kernel is shorter than its wrapper's
    host work, so CUDA events around back-to-back calls time the host; that
    figure is logged beside it. The 25 MB of inputs stay in the 50 MB L2
    between launches."""
    import torch.nn.functional as F

    b, h, s, d = PARITY_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    keep = torch.ones(b, s, dtype=torch.bool, device="cuda")
    keep[:, s - s // 4:] = False
    bias = torch.where(keep, 0.0, fa.NEG_INF)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask4 = keep[:, None, None, :]
    def kernel():
        return fa.flash_attention_kernel(q, k, v, bias)

    out = {
        "ms": device_ms(torch, kernel, iters=50),
        "events_ms": time_ms(torch, kernel),
        "plain_ms": time_ms(
            torch, lambda: fa.flash_attention_reference(q, k, v, bias)),
        "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4)),
    }
    out["bound_ms"], out["bound_by"] = attention_bound(b, h, s, d, 2, False)
    rate = {key: tflops("fwd", b, h, s, d, out[key])
            for key in ("ms", "library_ms")}
    log(f"timing flash_attn_fwd (B,H,S,D)=({b},{h},{s},{d}) bf16: kernel "
        f"(device) {out['ms']:.4f} ms ({rate['ms']:.1f} TFLOP/s; CUDA events"
        f" over back-to-back calls {out['events_ms']:.4f} ms), plain "
        f"{out['plain_ms']:.4f} ms, sdpa (device) {out['library_ms']:.4f} ms"
        f" ({rate['library_ms']:.1f} TFLOP/s), bound {out['bound_ms']:.4f} "
        f"ms ({out['bound_by']})")
    return out


# --------------------------------------------------------------- phase 3b

def rel_err(got, ref) -> float:
    """max|got - ref| over max|ref| (at least 1e-6), in f32."""
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp(min=1e-6)).item()


def bwd_kernel_parity(torch, fa) -> dict:
    """dQ and dK/dV kernels against their plain versions on the same
    inputs: o and lse from the forward's plain version, a random dO, delta
    from (o, dO); then the fused kernel against both (fused_parity).
    Returns the worst absolute error of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {"dq": 0.0, "dkv": 0.0, "fused": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, h, s, d in PARITY_SHAPES:
            q, k, v, do = (torch.randn(b, s, h, d, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(4))
            for case, (bias, sg) in attention_cases(torch, fa, gen,
                                                    b, s).items():
                o, lse = fa.flash_attention_reference(q, k, v, bias, sg, sg)
                args = (q, k, v, bias, sg, sg, lse, do,
                        fa.attention_delta(o, do))
                got, again = two_pass_kernels(fa, args), two_pass_kernels(
                    fa, args)
                torch.cuda.synchronize()
                ref = {"dq": fa.flash_attention_dq_reference(*args)}
                ref["dk"], ref["dv"], ref["dbias_h"] = (
                    fa.flash_attention_dkv_reference(*args))
                errs = {key: rel_err(got[key], ref[key]) for key in got}
                tols = {key: GRAD_RTOL[name] for key in ("dq", "dk", "dv")}
                tols["dbias_h"] = DBIAS_RTOL
                finite = all(bool(torch.isfinite(t).all())
                             for t in got.values())
                # No atomics: a second launch gives the same bits.
                stable = all(torch.equal(got[key], again[key]) for key in got)
                ok = finite and stable and all(errs[key] <= tols[key]
                                               for key in errs)
                if case == "masked_row":
                    # TPU semantics: p = exp(s - lse) = 1 for every key of
                    # a fully-masked row, so each key's dv is the sum of dO
                    # over the row's queries, not its mean.
                    want = do[1].float().sum(dim=0, keepdim=True)
                    ok = ok and rel_err(got["dv"][1], want.expand_as(
                        got["dv"][1])) <= GRAD_RTOL[name]
                for key, kernel in (("dq", "dq"), ("dk", "dkv"),
                                    ("dv", "dkv"), ("dbias_h", "dkv")):
                    worst[kernel] = max(worst[kernel], (
                        got[key].float() - ref[key].float()).abs().max()
                        .item())
                log(f"bwd parity {name} (B,H,S,D)=({b},{h},{s},{d}) {case}: "
                    + ", ".join(f"{key} {errs[key]:.2e} (tol {tols[key]})"
                                for key in errs)
                    + f", finite {finite}, two launches equal {stable} -> "
                    + ("ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError(
                        f"backward kernels disagree with their plain "
                        f"versions: {name} ({b},{h},{s},{d}) {case}")
                fused_parity(torch, fa, args, got, ref, do, name, case,
                             f"({b},{h},{s},{d})", worst)
    misaligned_view_parity(torch, fa, gen, "bwd")
    misaligned_view_parity(torch, fa, gen, "fused")
    return worst


def fused_kernel(fa, args) -> dict:
    """dq, dk, dv and dbias_h from one launch of the fused kernel."""
    return dict(zip(("dq", "dk", "dv", "dbias_h"),
                    fa.flash_attention_bwd_fused_kernel(*args)))


def fused_parity(torch, fa, args, pair, ref, do, name, case, shape,
                 worst) -> None:
    """The fused kernel on one phase-3b case: dk, dv and dbias_h equal to
    the pair's bit for bit and to a relaunch's; dq within GRAD_RTOL of the
    pair's and of the plain version's; finite; on the fully-masked row each
    key's dv is the row's summed dO."""
    got, again = fused_kernel(fa, args), fused_kernel(fa, args)
    torch.cuda.synchronize()
    keys = ("dk", "dv", "dbias_h")
    bits = all(torch.equal(got[key], pair[key]) for key in keys)
    stable = all(torch.equal(got[key], again[key]) for key in keys)
    errs = {"dq vs pair": rel_err(got["dq"], pair["dq"]),
            "dq vs plain": rel_err(got["dq"], ref["dq"]),
            "relaunch dq": rel_err(again["dq"], got["dq"])}
    finite = all(bool(torch.isfinite(t).all()) for t in got.values())
    ok = finite and bits and stable and all(
        e <= GRAD_RTOL[name] for e in errs.values())
    if case == "masked_row":
        want = do[1].float().sum(dim=0, keepdim=True)
        ok = ok and rel_err(got["dv"][1], want.expand_as(
            got["dv"][1])) <= GRAD_RTOL[name]
    for key in got:
        worst["fused"] = max(worst["fused"], (
            got[key].float() - ref[key].float()).abs().max().item())
    log(f"fused parity {name} (B,H,S,D)={shape} {case}: dk, dv, dbias_h "
        f"equal to the pair's {bits}, to a relaunch's {stable}; "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (tol {GRAD_RTOL[name]}), finite {finite} -> "
        + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"fused kernel disagrees with the pair or the "
                             f"plain backward: {name} {shape} {case}")


def two_pass_kernels(fa, args) -> dict:
    """dq, dk, dv and dbias_h from one launch of each two-pass kernel."""
    out = {"dq": fa.flash_attention_dq_kernel(*args)}
    out["dk"], out["dv"], out["dbias_h"] = fa.flash_attention_dkv_kernel(*args)
    return out


def misaligned_view_parity(torch, fa, gen, which: str) -> None:
    """At (8,12,512,64) bf16 with padding: q as a view that starts 2 bytes
    past a 16-byte boundary and k as a view with a sequence stride of
    H·D + 1 elements. The wrappers must copy both once (the kernels' 16-byte
    copies need aligned rows), so the outputs equal those of the aligned
    tensors bit for bit. ``which``: "fwd" (the forward kernel) or "bwd"
    (the two-pass pair) or "fused" (the fused kernel, whose dq is summed
    by atomics and held within GRAD_RTOL; its other outputs bit for
    bit)."""
    b, h, s, d = PARITY_SHAPES[0]
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    bias = attention_cases(torch, fa, gen, b, s)["padding"][0]
    q_off = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:]
    q_off = q_off.view(q.shape).copy_(q)
    k_wide = torch.empty(b, s, h * d + 1, dtype=k.dtype, device="cuda")
    k_str = k_wide[..., :h * d].view(k.shape).copy_(k)
    if fa._aligned_16(q_off) or fa._aligned_16(k_str):
        raise AssertionError("the misaligned views came out aligned")
    if which == "fwd":
        def run(q_, k_):
            return dict(zip(("o", "lse"),
                            fa.flash_attention_kernel(q_, k_, v, bias)))
    else:
        o, lse = fa.flash_attention_reference(q, k, v, bias)
        rest = (v, bias, None, None, lse, do, fa.attention_delta(o, do))
        kernels = two_pass_kernels if which == "bwd" else fused_kernel

        def run(q_, k_):
            return kernels(fa, (q_, k_) + rest)
    want = run(q, k)
    got = run(q_off, k_str)
    torch.cuda.synchronize()
    atomic = {"dq"} if which == "fused" else set()
    equal = all(torch.equal(got[key], want[key]) for key in want
                if key not in atomic) and all(
        rel_err(got[key], want[key]) <= GRAD_RTOL["bfloat16"]
        for key in atomic)
    log(f"{which} misaligned views bfloat16 (B,H,S,D)=({b},{h},{s},{d}) "
        f"padding: q 2 bytes past 16, k sequence stride {k_str.stride(1)} "
        f"elements; outputs equal to the aligned operands' {equal}"
        + (" (dq within GRAD_RTOL)" if atomic else "") + " -> "
        + ("ok" if equal else "FAIL"))
    if not equal:
        raise AssertionError(f"misaligned operand views changed the {which} "
                             f"kernels' outputs")


def bwd_kernel_timing(torch, fa) -> dict:
    """At the training shape (B=8, H=12, S=512, D=64, bf16, padding mask):
    each backward kernel by its device kernel time (CUDA events around
    back-to-back calls time the wrapper's host work, which outlasts the
    kernel; that figure is logged beside it), its plain version by CUDA
    events, and the backward of ``scaled_dot_product_attention`` on the
    same inputs by device time (the yardstick for the pair; the port never
    calls it)."""
    import torch.nn.functional as F

    b, h, s, d = PARITY_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    keep = torch.ones(b, s, dtype=torch.bool, device="cuda")
    keep[:, s - s // 4:] = False
    bias = torch.where(keep, 0.0, fa.NEG_INF)
    o, lse = fa.flash_attention_kernel(q, k, v, bias)
    args = (q, k, v, bias, None, None, lse, do, fa.attention_delta(o, do))
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves,
                                         attn_mask=keep[:, None, None, :])
    grad_out = do.transpose(1, 2)
    library_ms = device_ms(torch, lambda: torch.autograd.grad(
        out, leaves, grad_out, retain_graph=True))
    bounds = attention_bwd_bounds(b, h, s, d, 2, False)
    timing = {}
    for name, kernel, plain in (
            ("dq", fa.flash_attention_dq_kernel,
             fa.flash_attention_dq_reference),
            ("dkv", fa.flash_attention_dkv_kernel,
             fa.flash_attention_dkv_reference)):
        rec = {"ms": device_ms(torch, lambda: kernel(*args), iters=50),
               "events_ms": time_ms(torch, lambda: kernel(*args)),
               "plain_ms": time_ms(torch, lambda: plain(*args)),
               "library_ms": library_ms}
        rec["bound_ms"], rec["bound_by"] = bounds[name]
        log(f"timing flash_attn_bwd_{name} (B,H,S,D)=({b},{h},{s},{d}) bf16: "
            f"kernel (device) {rec['ms']:.4f} ms "
            f"({tflops(name, b, h, s, d, rec['ms']):.1f} TFLOP/s; CUDA events"
            f" over back-to-back calls {rec['events_ms']:.4f} ms), plain "
            f"{rec['plain_ms']:.4f} ms, sdpa backward (both, device) "
            f"{library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
        timing[name] = rec
    return timing


# --------------------------------------------------------------- phase 3c

def bwd_results(torch, fa, args) -> dict:
    """Every backward kernel and the plain backward on the same inputs:
    {"two_pass": ..., "fused": ..., "plain": ...}, each a dict of dq, dk,
    dv and dbias_h."""
    names = ("dq", "dk", "dv", "dbias_h")
    two = (fa.flash_attention_dq_kernel(*args),
           *fa.flash_attention_dkv_kernel(*args))
    fused = fa.flash_attention_bwd_fused_kernel(*args)
    torch.cuda.synchronize()
    plain = (fa.flash_attention_dq_reference(*args),
             *fa.flash_attention_dkv_reference(*args))
    return {route: dict(zip(names, outs)) for route, outs in (
        ("two_pass", two), ("fused", fused), ("plain", plain))}


def check_bwd(torch, res: dict, do, name: str, case: str, what: str,
              worst: dict) -> None:
    """Hold the fused kernel against the plain backward and against the
    two-pass kernels, and the two-pass kernels against the plain backward,
    with phase 3b's tolerances; the fused kernel's dk, dv and dbias_h must
    equal the two-pass ones bit for bit (one key-block body in each dtype);
    on the fully-masked row each key's dv must be the row's summed dO.
    Updates ``worst`` (max |err| per kernel)."""
    tols = {key: GRAD_RTOL[name] for key in ("dq", "dk", "dv")}
    tols["dbias_h"] = DBIAS_RTOL
    checks = (("fused vs plain", "fused", "plain"),
              ("two-pass vs plain", "two_pass", "plain"),
              ("fused vs two-pass", "fused", "two_pass"))
    ok = all(bool(torch.isfinite(t).all())
             for route in ("two_pass", "fused") for t in res[route].values())
    bits = all(torch.equal(res["fused"][key], res["two_pass"][key])
               for key in ("dk", "dv", "dbias_h"))
    ok = ok and bits
    parts = [f"fused dk, dv, dbias_h equal to the two-pass ones {bits}"]
    for label, got, ref in checks:
        errs = {key: rel_err(res[got][key], res[ref][key]) for key in tols}
        ok = ok and all(errs[key] <= tols[key] for key in tols)
        parts.append(label + " " + ", ".join(
            f"{key} {errs[key]:.2e}" for key in tols))
    if case == "masked_row":
        want = do[1].float().sum(dim=0, keepdim=True)
        for route in ("two_pass", "fused"):
            dv = res[route]["dv"][1]
            ok = ok and rel_err(dv, want.expand_as(dv)) <= GRAD_RTOL[name]
    for key, kernel in (("dq", "dq"), ("dk", "dkv"), ("dv", "dkv"),
                        ("dbias_h", "dkv")):
        plain = res["plain"][key].float()
        worst[kernel] = max(worst[kernel], (
            res["two_pass"][key].float() - plain).abs().max().item())
        worst["fused"] = max(worst["fused"], (
            res["fused"][key].float() - plain).abs().max().item())
    log(f"{what} {case}: " + "; ".join(parts)
        + f" (tol {GRAD_RTOL[name]}, dbias_h {DBIAS_RTOL}) -> "
        + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"backward kernels disagree: {what} {case}")


def long_kernel_parity(torch, fa) -> dict:
    """Phase 3c: the kernels at the streaming lengths, with padding and
    with segment ids, bf16 and f32. The forward kernel against the
    streaming forward's plain version; the two-pass and the fused backward
    against the plain backward and against each other, on the plain
    forward's o and lse. Then the fused kernel on the ragged (2,3,96,32)
    and in the whole-K takeover band (2,2,2048,64) bf16, all four cases.
    Returns the worst absolute error of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "fused": 0.0}
    runs = [(shape, dtype, ("padding", "segments"))
            for shape in LONG_SHAPES
            for dtype in (torch.bfloat16, torch.float32)]
    runs += [((2, 3, 96, 32), dtype, None)
             for dtype in (torch.bfloat16, torch.float32)]
    runs += [((2, 2, 2048, 64), torch.bfloat16, None)]
    for (b, h, s, d), dtype, wanted in runs:
        name = str(dtype).split(".")[-1]
        what = f"{name} (B,H,S,D)=({b},{h},{s},{d})"
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda",
                                   generator=gen).to(dtype)
                       for _ in range(4))
        for case, (bias, sg) in attention_cases(torch, fa, gen, b,
                                                s).items():
            if wanted is not None and case not in wanted:
                continue
            o, lse = fa.flash_attention_kb_reference(q, k, v, bias, sg, sg)
            if s > fa.MAX_SEQ_VMEM:
                ko, klse = fa.flash_attention_kernel(q, k, v, bias, sg, sg)
                torch.cuda.synchronize()
                o_err = (ko.float() - o.float()).abs().max().item()
                o_rel = rel_err(ko, o)
                lse_err = ((klse - lse).abs()
                           / lse.abs().clamp(min=1.0)).max().item()
                ok = (bool(torch.isfinite(ko).all()) and o_rel <= O_RTOL[name]
                      and lse_err <= LSE_RTOL)
                worst["fwd"] = max(worst["fwd"], o_err)
                log(f"long parity fwd {what} {case}: o max|err| {o_err:.3e} "
                    f"= {o_rel:.3e} of max|o| {o.float().abs().max().item():.3e}"
                    f" (tol {O_RTOL[name]}), lse rel err {lse_err:.3e} (tol "
                    f"{LSE_RTOL}) -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"forward kernel disagrees with the "
                                         f"streaming plain version: {what} "
                                         f"{case}")
            args = (q, k, v, bias, sg, sg, lse, do, fa.attention_delta(o, do))
            check_bwd(torch, bwd_results(torch, fa, args), do, name, case,
                      f"long parity bwd {what}", worst)
            del args
        del q, k, v, do
        torch.cuda.empty_cache()
    return worst


def long_kernel_timing(torch, fa) -> dict:
    """At the long-context runs' shapes (B=1, H=12, D=64, bf16, no mask, as
    the synthetic stream's rows): the forward and the two-pass pair at
    S = 16384, the fused kernel at S = 8192, each beside its plain version,
    the bound, and SDPA's forward or backward device time on the same
    inputs (the yardstick; the port never calls it)."""
    import torch.nn.functional as F

    out = {}
    for s, names in ((16384, ("fwd", "dq", "dkv")), (8192, ("fused",))):
        b, h, d = 1, 12, 64
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        bias = torch.zeros(b, s, device="cuda")
        o, lse = fa.flash_attention_kernel(q, k, v, bias)
        args = (q, k, v, bias, None, None, lse, do, fa.attention_delta(o, do))
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        sdpa = {"fwd": device_ms(torch, lambda: F.scaled_dot_product_attention(
                    *(t.detach() for t in leaves)), iters=3, warmup=1),
                "bwd": device_ms(torch, lambda: torch.autograd.grad(
                    sdpa_out, leaves, do.transpose(1, 2), retain_graph=True),
                    iters=3, warmup=1)}
        bounds = attention_bwd_bounds(b, h, s, d, 2, False)
        bounds["fwd"] = attention_bound(b, h, s, d, 2, False)
        calls = {
            "fwd": (lambda: fa.flash_attention_kernel(q, k, v, bias),
                    lambda: fa.flash_attention_kb_reference(q, k, v, bias)),
            "dq": (lambda: fa.flash_attention_dq_kernel(*args),
                   lambda: fa.flash_attention_dq_reference(*args)),
            "dkv": (lambda: fa.flash_attention_dkv_kernel(*args),
                    lambda: fa.flash_attention_dkv_reference(*args)),
            "fused": (lambda: fa.flash_attention_bwd_fused_kernel(*args),
                      lambda: fa.flash_attention_bwd_reference(
                          q, k, v, bias, None, None, o, lse, do, args[-1])),
        }
        for name in names:
            kernel, plain = calls[name]
            rec = {"plain_ms": time_ms(torch, plain, iters=2, warmup=1),
                   "library_ms": sdpa["fwd" if name == "fwd" else "bwd"]}
            if name == "fused":  # in turns with the pair, as in the band
                turns = fused_vs_pair_timing(torch, fa, (b, h, s, d), args)
                rec["ms"], rec["two_pass_ms"] = (turns["fused_ms"],
                                                 turns["two_pass_ms"])
            else:
                rec["ms"] = time_ms(torch, kernel, iters=3, warmup=1)
            rec["tflops"] = tflops(name, b, h, s, d, rec["ms"])
            rec["bound_ms"], rec["bound_by"] = bounds[name]
            log(f"timing {KERNEL_NAMES[name]} (B,H,S,D)=({b},{h},{s},{d}) "
                f"bf16: kernel {rec['ms']:.4f} ms ({rec['tflops']:.1f} "
                f"TFLOP/s), plain {rec['plain_ms']:.4f} ms, sdpa "
                f"{'forward' if name == 'fwd' else 'backward (dq+dk+dv)'} "
                f"(device) {rec['library_ms']:.4f} ms, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
            out[name] = rec
        del q, k, v, do, o, lse, args, leaves, sdpa_out
        torch.cuda.empty_cache()
    out["fused"]["takeover_band"] = [fused_vs_pair_timing(torch, fa, shape)
                                     for shape in BAND_SHAPES]
    return out


def fused_listed(torch, fa) -> bool:
    """Whether this card is in FUSED_BWD_VERIFIED_DEVICES, where auto takes
    the fused backward wherever the JAX package would."""
    name = torch.cuda.get_device_name(0).lower()
    return any(p in name for p in fa.FUSED_BWD_VERIFIED_DEVICES)


def long_runs(torch, fa) -> list[tuple[int, str]]:
    """(sequence length, the backward route auto must pick) of phase 6."""
    return [(seq, "fused" if seq <= fa.FUSED_BWD_MAX and fused_listed(
        torch, fa) else "stream") for seq in LONG_SEQS]


def fused_vs_pair_timing(torch, fa, shape, args=None) -> dict:
    """The fused kernel against the two-pass pair at one shape (bf16, no
    mask) where auto must pick the fused kernel on a listed card and the
    pair elsewhere: (1,12,8192,64) and the whole-K takeover band. Timed in
    turns (fused, pair, pair, fused), CUDA events; ``args`` are the kernels'
    inputs when the caller has them."""
    b, h, s, d = shape
    want = "fused" if fused_listed(torch, fa) else (
        "whole_k" if s <= fa.MAX_SEQ_VMEM else "stream")
    probe = torch.empty(b, s, h, d, device="cuda", dtype=torch.bfloat16)
    with fused_bwd(fa, None):
        if fa.backward_route(probe, probe) != want:
            raise AssertionError(f"auto does not pick the {want} backward "
                                 f"at {shape} bf16")
    del probe
    if args is None:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        bias = torch.zeros(b, s, device="cuda")
        o, lse = fa.flash_attention_kernel(q, k, v, bias)
        args = (q, k, v, bias, None, None, lse, do, fa.attention_delta(o, do))
    calls = {"fused": lambda: fa.flash_attention_bwd_fused_kernel(*args),
             "two_pass": lambda: (fa.flash_attention_dq_kernel(*args),
                                  fa.flash_attention_dkv_kernel(*args))}
    times = {"fused": [], "two_pass": []}
    for route in ("fused", "two_pass", "two_pass", "fused"):
        times[route].append(time_ms(torch, calls[route], iters=10, warmup=2))
    rec = {"shape": list(shape), "fused_ms": statistics.mean(times["fused"]),
           "two_pass_ms": statistics.mean(times["two_pass"]), "auto": want}
    log(f"timing fused vs two-pass (B,H,S,D)=({b},{h},{s},{d}) bf16, auto "
        f"{want}: fused "
        f"{', '.join(f'{t:.4f}' for t in times['fused'])} ms "
        f"({tflops('fused', b, h, s, d, rec['fused_ms']):.1f} TFLOP/s), "
        f"two-pass (dq + dkv) "
        f"{', '.join(f'{t:.4f}' for t in times['two_pass'])} ms; fused / "
        f"two-pass {rec['fused_ms'] / rec['two_pass_ms']:.3f}")
    return rec


# ---------------------------------------------------------------- phase 4

def kernel_wrappers(fa) -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    return {"fwd": fa.flash_attention, "dq": fa.flash_attention_dq_kernel,
            "dkv": fa.flash_attention_dkv_kernel,
            "fused": fa.flash_attention_bwd_fused_kernel}


def reset_counts(fa) -> None:
    """Set every kernel's launch counts (all launches, and those with
    segment ids) to 0, just before a main-path run."""
    for wrapper in kernel_wrappers(fa).values():
        wrapper.launches = 0
        wrapper.segmented_launches = 0


def read_segmented(fa) -> dict:
    """The launches with segment ids (packed rows) just after a run."""
    return {name: wrapper.segmented_launches
            for name, wrapper in kernel_wrappers(fa).items()}


def read_counts(fa, serving: bool = False) -> dict:
    """The launch counts just after a main-path run; a serving run must
    have launched no backward kernel."""
    counts = {name: wrapper.launches
              for name, wrapper in kernel_wrappers(fa).items()}
    if serving and (counts["dq"] or counts["dkv"] or counts["fused"]):
        raise AssertionError(f"serving launched backward kernels: {counts}")
    return counts


def check_traced(traced: dict, health: dict, log_dir: str) -> None:
    """Phase 18b: every traced request's spans in the server's events
    (which must all validate) form ``serve.request`` → ``engine.queue`` /
    ``engine.batch`` → ``engine.compute`` under the client's trace id, the
    malformed header was answered 200 untraced, ``/healthz``'s memory
    reads the card's allocator, and SIGUSR1 wrote the flight recorder's
    dump."""
    import torch

    from distributed_tensorflow_framework_torch.core import telemetry
    from distributed_tensorflow_framework_torch.core.tracing import (
        FLIGHTREC_SCHEMA,
    )

    if traced["statuses"] != [200] * (TRACED_REQUESTS + 1):
        raise AssertionError(f"18b statuses {traced['statuses']}")
    traces: dict = {}
    for ev in telemetry.read_events(os.path.join(log_dir, "events.jsonl"),
                                    kind=telemetry.KIND_SPAN):
        traces.setdefault(ev["extra"]["trace"], []).append(ev)
    if sorted(traces) != sorted(traced["trace_ids"]):
        raise AssertionError(f"18b: spans under {sorted(traces)}, sent "
                             f"{sorted(traced['trace_ids'])}")
    for trace_id, group in traces.items():
        by_id = {e["extra"]["span"]: e["extra"] for e in group}
        tree = {}
        for x in by_id.values():
            parent = by_id.get(x["parent"], {}).get("name")
            tree.setdefault(parent, []).append(x["name"])
        want = {None: ["serve.request"],
                "serve.request": ["engine.batch", "engine.queue"],
                "engine.batch": ["engine.compute"]}
        if {k: sorted(v) for k, v in tree.items()} != want or any(
                x["status"] != "ok" for x in by_id.values()):
            raise AssertionError(f"18b trace {trace_id}: {tree}")
    ms = {x["name"]: e["metrics"]["dur_ms"] for e in traces[trace_id]
          for x in [e["extra"]]}
    log(f"18b traced serve: {len(traces)} traces of 4 spans each under the "
        f"clients' trace ids, a malformed X-DTF-Trace answered 200 "
        f"untraced; the last: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in sorted(ms.items())))
    mem, good = health["memory"], health["goodput"]
    name = torch.cuda.get_device_name(0)
    if (mem["source_kind"] != "device_memory_stats"
            or [d["kind"] for d in mem["devices"]] != [name]
            or not 0 < mem["bytes_in_use"] <= mem["peak_bytes_in_use"]
            or not 0 < good["compute_frac"] < 1):
        raise AssertionError(f"18b /healthz memory {mem}, goodput {good}")
    log(f"18b /healthz memory: {mem['source_kind']} on {name}, "
        f"{mem['bytes_in_use'] / 1e9:.3f} GB in use, peak "
        f"{mem['peak_bytes_in_use'] / 1e9:.3f} GB; goodput: compute "
        f"{good['compute_ms_total']:.1f} ms of {good['uptime_s']:.1f} s up "
        f"(compute_frac {good['compute_frac']:.4f})")
    dump = traced["dump"]
    spans = [e["extra"]["name"] for e in dump["events"]
             if e["kind"] == telemetry.KIND_SPAN]
    if (dump["schema"] != FLIGHTREC_SCHEMA or dump["reason"] != "SIGUSR1"
            or spans.count("serve.request") != TRACED_REQUESTS):
        raise AssertionError(f"18b flight recorder dump: {dump['schema']}, "
                             f"{dump['reason']}, spans {spans}")
    log(f"18b SIGUSR1: flight recorder dump {dump['schema']} with "
        f"{dump['event_count']} events ({len(spans)} spans), "
        f"{len(dump['open_spans'])} open spans")


def reference_model(torch, fa, model_config, state_dict):
    """The served model with every attention call swapped for the
    kernel's plain version, on the card."""
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.models.bert import (
        MultiHeadAttention,
    )

    def plain_attention(q, k, v, *, mask=None, segment_ids=None):
        b, s = q.shape[:2]
        bias = fa.attention_bias(mask, b, s, q.device)
        seg = None if segment_ids is None else segment_ids.float()
        return fa.flash_attention_reference(q, k, v, bias, seg, seg)[0]

    model = get_model(model_config, device="cuda")
    model.load_state_dict(state_dict)
    for module in model.modules():
        if isinstance(module, MultiHeadAttention):
            module.attention_fn = plain_attention
    return model


def check_logits(torch, ref_model, ids, got, bucket: int, what: str,
                 ref_name: str = "plain-attention model") -> dict:
    """``got`` (len, vocab) against ``ref_model`` (the plain-attention
    model) on the same padded row the engine ran."""
    n = len(ids)
    pad_ids = torch.zeros(1, bucket, dtype=torch.int64, device="cuda")
    pad_ids[0, :n] = torch.tensor(ids, device="cuda")
    mask = torch.zeros(1, bucket, dtype=torch.int64, device="cuda")
    mask[0, :n] = 1
    with torch.inference_mode():
        ref = ref_model(pad_ids, mask)[0, :n].float().cpu()
    got = torch.as_tensor(got, dtype=torch.float32).reshape(ref.shape)
    diff = (got - ref).abs()
    res = {"max": diff.max().item(), "mean": diff.mean().item(),
           "ref_std": ref.std().item()}
    log(f"{what}: logits vs {ref_name} max|err| "
        f"{res['max']:.4e} (tol {LOGIT_MAX_ATOL}), mean {res['mean']:.4e} "
        f"(tol {LOGIT_MEAN_ATOL}), ref std {res['ref_std']:.4f}")
    if not (res["max"] <= LOGIT_MAX_ATOL and res["mean"] <= LOGIT_MEAN_ATOL):
        raise AssertionError(f"{what}: served logits disagree with "
                             f"{ref_name}")
    return res


class HttpClient(threading.Thread):
    """Waits for the server's endpoint.json, sends concurrent
    ``POST /predict`` requests, then with ``generate`` one ``POST
    /generate`` of that many new tokens, with ``traced`` phase 18b's
    requests (:meth:`_traced`), reads ``/healthz``, then SIGTERMs this
    process so ``cli.serve.main`` drains and returns."""

    def __init__(self, log_dir: str, vocab: int,
                 lengths: tuple = HTTP_LENGTHS, generate: int = 0,
                 traced: bool = False):
        super().__init__(name="chip-smoke-client", daemon=True)
        self.log_dir = log_dir
        self.vocab = vocab
        self.lengths = lengths
        self.generate = generate
        self.traced = traced
        self.results: dict = {}
        self.error: BaseException | None = None

    def _generate(self, url: str, prompt: list[int]) -> dict:
        """One streamed decode: the status, headers and NDJSON lines."""
        body = json.dumps({"prompt": prompt,
                           "max_new_tokens": self.generate}).encode()
        req = urllib.request.Request(
            url + "/generate", data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            lines = [json.loads(line) for line in resp.read().splitlines()
                     if line.strip()]
            return {"status": resp.status, "headers": dict(resp.headers),
                    "lines": lines, "prompt": prompt,
                    "ms": (time.perf_counter() - t0) * 1e3}

    def _endpoint(self, timeout_s: float = 600.0) -> str:
        path = os.path.join(self.log_dir, "endpoint.json")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if os.path.isfile(path):
                with open(path) as fh:
                    return json.load(fh)["url"]
            time.sleep(0.2)
        raise TimeoutError(f"server wrote no {path} in {timeout_s} s")

    def _post(self, url: str, ids: list[int],
              trace: str | None = None) -> tuple[int, dict, float]:
        body = json.dumps({"inputs": {"input_ids": ids,
                                      "attention_mask": [1] * len(ids)}})
        headers = {"Content-Type": "application/json"}
        if trace is not None:
            from distributed_tensorflow_framework_torch.core import tracing

            headers[tracing.TRACE_HEADER] = trace
        req = urllib.request.Request(url + "/predict", data=body.encode(),
                                     headers=headers)
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            payload = json.loads(resp.read())
            return resp.status, payload, (time.perf_counter() - t0) * 1e3

    def run(self) -> None:
        try:
            import numpy as np

            url = self._endpoint()
            rng = np.random.default_rng(SEED)
            reqs = [rng.integers(0, self.vocab, n).tolist()
                    for n in self.lengths]
            replies: list = [None] * len(reqs)

            def send(i):
                try:
                    replies[i] = self._post(url, reqs[i])
                except Exception as e:  # noqa: BLE001 — re-raised below
                    replies[i] = e

            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            for i, reply in enumerate(replies):
                if not isinstance(reply, tuple):
                    raise RuntimeError(
                        f"/predict of {self.lengths[i]} tokens failed: "
                        f"{reply!r}")
            generated = (self._generate(url, reqs[-1]) if self.generate
                         else None)
            traced = self._traced(url, reqs[0]) if self.traced else None
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            self.results = {"requests": reqs, "replies": replies,
                            "health": health, "generate": generated,
                            "traced": traced}
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            self.error = e
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    def _traced(self, url: str, ids: list[int]) -> dict:
        """Phase 18b: TRACED_REQUESTS requests, each under a fresh trace
        context in ``X-DTF-Trace`` (a client with no span of its own, as
        scripts/load_gen.py sends), one with a malformed header, then a
        SIGUSR1 to this process (the server's flight recorder) and a wait
        for its dump."""
        import uuid

        ids_sent, statuses = [], []
        for _ in range(TRACED_REQUESTS):
            trace_id = uuid.uuid4().hex[:16]
            status, _, _ = self._post(url, ids,
                                      f"{trace_id}::{time.time():.6f}")
            ids_sent.append(trace_id)
            statuses.append(status)
        statuses.append(self._post(url, ids, "not-a-trace")[0])
        dump = os.path.join(self.log_dir, f"flightrec-{os.getpid()}.json")
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 30
        while not os.path.isfile(dump) and time.monotonic() < deadline:
            time.sleep(0.1)
        with open(dump) as fh:
            return {"trace_ids": ids_sent, "statuses": statuses,
                    "dump": json.load(fh)}


# ---------------------------------------------------------------- phase 9

def jpeg_toolchain() -> dict:
    """What the native reader's build needs from the machine: ``jpeglib.h``
    (the path the compiler finds and its ``JPEG_LIB_VERSION``), the
    ``libjpeg.so*`` the linker sees, nvJPEG in the CUDA toolkit, and the
    host's CPU count (the decode threads)."""
    import glob

    out = {"cpu_count": os.cpu_count(), "jpeglib_h": None,
           "JPEG_LIB_VERSION": None, "LIBJPEG_TURBO_VERSION": None}
    probe = ("#include <stdio.h>\n#include <jpeglib.h>\n"
             "JPEG_LIB_VERSION\nLIBJPEG_TURBO_VERSION_NUMBER\n")
    cxx = shutil.which("g++")
    if cxx is not None:
        proc = subprocess.run([cxx, "-H", "-E", "-x", "c++", "-"],
                              input=probe, capture_output=True, text=True)
        if proc.returncode == 0:
            heads = re.findall(r"^\.+ (\S*jpeglib\.h)$", proc.stderr,
                               re.MULTILINE)
            out["jpeglib_h"] = heads[0] if heads else "found"
            tail = [ln for ln in proc.stdout.splitlines() if ln.strip()]
            out["JPEG_LIB_VERSION"] = tail[-2].strip()
            out["LIBJPEG_TURBO_VERSION"] = tail[-1].strip()
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        listing = subprocess.run([ldconfig, "-p"], capture_output=True,
                                 text=True).stdout
    except OSError:
        listing = ""
    out["libjpeg_so"] = sorted({ln.split("=>")[-1].strip()
                                for ln in listing.splitlines()
                                if "libjpeg.so" in ln})
    cuda = "/usr/local/cuda"
    out["nvjpeg_h"] = [p for p in glob.glob(f"{cuda}/include/nvjpeg.h")
                       + glob.glob(f"{cuda}/targets/*/include/nvjpeg.h")]
    out["libnvjpeg"] = sorted(glob.glob(f"{cuda}/lib64/libnvjpeg*")
                              + glob.glob(f"{cuda}/targets/*/lib/libnvjpeg*"))
    return out


# Phase 9f: the one-device BatchNorm (ROADMAP.md queue C, settled in
# "Deliberate differences"). 8c's ResNet-50 case (f32, TF32 off, the CIFAR
# stem, 256 images in one process) after one step, against its f64 step,
# under each way of computing the training statistics: the port's
# BatchNorm (F.batch_norm; on the card PyTorch's native channels_last
# kernels) and the cross-rank Function's E[x²] − E[x]² over f32 sums
# (Flax's formula) with no group.
BN_VARIANTS = ("port", "function")


@contextlib.contextmanager
def batchnorm_variant(torch, which: str):
    """Swap the training statistics of every port BatchNorm for the
    duration: ``port`` leaves the class as it is, ``function`` computes
    them with the cross-rank Function, collectives skipped (no group)."""
    from distributed_tensorflow_framework_torch.models import layers

    saved = layers.BatchNorm.forward

    def function_forward(self, x):
        if not self.training:
            return saved(self, x)
        y, mean, var = layers._CrossRankBatchNorm.apply(
            x, self.weight, self.bias, self.eps, self.group)
        with torch.no_grad():
            keep = self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            self.running_var.mul_(keep).add_(var, alpha=1.0 - keep)
        return y.to(self.dtype)

    if which == "function":
        layers.BatchNorm.forward = function_forward
    try:
        yield
    finally:
        layers.BatchNorm.forward = saved


def batchnorm_phase(torch, workdir: str, smi: str) -> dict:
    """9f: each BN variant's ResNet-50 step against the f64 step (the
    distances of 8c): the port's may sit no further from it than
    DP_F64_RATIO times the Function's, or within DP_F64_FLOOR. Then
    config 3's step alone on a resident batch with the port's BN and the
    Function's in turns, and one profiled step of each: what the switch
    to Flax's formula would cost."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    truth = dp_f64_step(torch, *DP_RESNET)
    torch.cuda.empty_cache()
    far = {}
    for which in BN_VARIANTS:
        with batchnorm_variant(torch, which):
            res = dp_case(torch, *DP_RESNET, DP_HOLD["resnet"])
        far[which] = dp_distance(res["tensors"], truth)
        torch.cuda.empty_cache()
    log("9f batchnorm, ResNet-50 f32 at 256 after one step, from an f64 "
        "step (parameters over the largest update, statistics over the "
        "leaf's largest value): " + "; ".join(
            f"{w} " + ", ".join(f"{k} {v:.3e} ({leaf})"
                                for k, (v, leaf) in far[w].items())
            for w in BN_VARIANTS) + f" [{smi}]")
    if any(far["port"][k][0] > DP_F64_RATIO * far["function"][k][0]
           + DP_F64_FLOOR for k in far["port"]):
        raise AssertionError("9f: the port's BatchNorm is further from the "
                             "f64 step than Flax's formula")
    cfg = load_config(IMAGENET_CONFIG, overrides=[
        *IMAGENET_OVERRIDES, "checkpoint.directory="])
    _, step = image_step(torch, cfg)
    turns = {"port": [], "function": []}
    for which in ("port", "function", "function", "port"):
        with batchnorm_variant(torch, which):
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            turns[which].append((time.perf_counter() - t0) * 1e3 / 5)
    kernel = {}
    for which in turns:
        with batchnorm_variant(torch, which):
            kernel[which] = image_profile(
                torch, step, statistics.mean(turns[which]),
                f"9f resnet50-imagenet 256, {which} BatchNorm")
    log("9f resnet50-imagenet 256 step alone (host clock, 5 synced steps "
        "per turn, port/function/function/port): " + "; ".join(
            f"{w} BN " + ", ".join(f"{t:.3f}" for t in ts) + " ms"
            for w, ts in turns.items())
        + f"; kernel time per step: port BN {kernel['port']:.3f} ms, "
        f"function BN {kernel['function']:.3f} ms [{smi}]")
    del step
    torch.cuda.empty_cache()
    return {"far": far, "turns": turns, "kernel_ms": kernel}


# Phase 9: ImageNet from records (configs 3 and 4). 9a authors the corpus
# with the port's TF-free writer (data/imagenet_records.py) in the
# workdir: 4,096 train images in 8 shards, 1,000 validation images in 2
# (not a multiple of the batch, so the exact eval pads its 4th batch).
RECORD_CORPUS = ("--train-images", "4096", "--validation-images", "1000",
                 "--train-shards", "8", "--validation-shards", "2",
                 "--num-classes", "1000", "--seed", str(SEED))
RECORD_EVAL_IMAGES = 1000
# 9c/9d: configs 3 and 4 as written from the corpus, the global batch cut
# to 256 (config 3: 4,096 on the pod; config 4: 2,048) and the run to 8
# steps (cut from 20, then 12, for the script's time limit), a
# log every 4; each ends with its exact eval over the 1,000 validation
# images (the eval_steps of both configs exceed the 4 batches, so the
# whole set).
RECORD_OVERRIDES = ("data.global_batch_size=256", "train.total_steps=8",
                    "train.log_interval=4")
INCEPTION_CONFIG = "configs/inception_v3.yaml"
# 9b: batches timed per reader path and thread count, and of config 3's
# pipeline (an epoch of the corpus is 16 batches).
READER_BATCHES = 4
PIPELINE_BATCHES = 8
# The codec reference (native/jpeg_reference.npz, written by the libjpeg
# build with data/imagenet_records.py --decode-reference): where this
# machine builds the reader with nvJPEG (it has no libjpeg), each
# transform of the reference JPEGs, raw [0, 255] pixels at 48 x 48, is
# held to the libjpeg build's as a mean |difference| over the pixels:
# nvJPEG's IDCT and chroma upsampling are not libjpeg's, and the native
# path's DCT-scaled decode becomes a full decode averaged over blocks.
CODEC_REFERENCE = ("distributed_tensorflow_framework_torch/native/"
                   "jpeg_reference.npz")
CODEC_MEAN_TOL = {"native_train": 6.0, "native_eval": 6.0,
                  "tf_train": 4.0, "tf_eval": 4.0}
# And a round trip through the build's own encoder and decoder (quality
# 90) of smooth colour ramps: a libjpeg(-turbo) build's mean |decoded -
# source|, and the bound for any build (the libjpeg figure and then some:
# another encoder's quantisation).
CODEC_ROUND_TRIP_LIBJPEG = 0.68
CODEC_ROUND_TRIP_TOL = 2.0
# 9e: Inception-v3 in f32 on the card (TF32 off) against the same weights
# on the CPU at 299 x 299, batch 4, with the same loss on both heads. Eval
# logits (BN on running statistics) within INCEPTION_EVAL_RTOL of the
# largest |logit|. Train mode sums rounding through 94 BatchNorms over few
# samples (tests/test_torch_inception.py: Flax's own f32 pass lands 2-9%
# of the largest gradient from f64), so the card's logits, aux logits and
# gradients are held to the model in f64 on the card, no further from it
# than INCEPTION_RATIO times the CPU's f32 pass, or within 1e-5.
INCEPTION_EVAL_RTOL = 1e-4
INCEPTION_RATIO = 3.0


def codec_phase(torch) -> None:
    """The native reader's build and its JPEG codec; where that is
    not libjpeg, its transforms of the reference JPEGs against the libjpeg
    build's, and an encode/decode round trip."""
    import numpy as np

    from distributed_tensorflow_framework_torch.data import (
        imagenet_records,
        native_reader,
    )

    t0 = time.perf_counter()
    native_reader.load_library()
    codec = native_reader.jpeg_backend()
    log(f"9 native reader built in {time.perf_counter() - t0:.2f} s "
        f"({native_reader.library_path().name}); JPEG codec {codec}")
    if codec == "none":
        raise AssertionError("the native reader has no JPEG codec here")
    jpegs, want = imagenet_records.load_reference(CODEC_REFERENCE)
    got = imagenet_records.reference_transforms(jpegs)
    line = []
    for key in imagenet_records.REFERENCE_TRANSFORMS:
        err = np.abs(got[key] - want[key])
        line.append(f"{key} mean {err.mean():.3f}, p99 "
                    f"{np.percentile(err, 99):.2f}, max {err.max():.2f} "
                    f"(tol mean {CODEC_MEAN_TOL[key]})")
        if codec == "libjpeg" and not np.array_equal(
                got[key].astype(np.float16).astype(np.float32), want[key]):
            raise AssertionError(f"9 codec: the libjpeg build differs "
                                 f"from its reference on {key}")
        if err.mean() > CODEC_MEAN_TOL[key]:
            raise AssertionError(f"9 codec: {codec} {key} differs from "
                                 f"libjpeg by {err.mean():.3f} on average")
    log(f"9 codec {codec} vs the libjpeg reference (grey levels over 48x48 "
        f"x 3 x {len(jpegs)} pixels): " + "; ".join(line))
    # A round trip through this build's encoder and decoder: the eval
    # transform at the frame's own size with the whole frame is the
    # decoded frame (the bicubic weights at the pixel centres are 0, 1,
    # 0, 0).
    errs = []
    for w, h in imagenet_records.REFERENCE_FRAMES:
        img = np.broadcast_to(
            np.linspace(30, 220, w)[None, :, None]
            + np.linspace(0, 40, h)[:, None, None]
            + np.asarray([0.0, 10.0, -10.0]), (h, w, 3)).astype(np.uint8)
        record = imagenet_records.example({
            imagenet_records.IMAGE_KEY: imagenet_records.bytes_feature(
                native_reader.encode_jpeg(img, 90)),
            imagenet_records.LABEL_KEY: imagenet_records.int64_feature([1])})
        back, _ = native_reader.decode_images([record], *img.shape[:2],
                                              central_frac=1.0)
        errs.append(np.abs(back[0] - img).mean())
    log(f"9 codec {codec} round trip (quality 90, {len(errs)} colour "
        f"ramps): mean |decoded - source| "
        f"{statistics.mean(errs):.3f} grey levels (max over images "
        f"{max(errs):.3f}; a libjpeg build {CODEC_ROUND_TRIP_LIBJPEG}, tol "
        f"{CODEC_ROUND_TRIP_TOL})")
    if max(errs) > CODEC_ROUND_TRIP_TOL:
        raise AssertionError("9 codec: the round trip is off")


def author_corpus(workdir: str) -> str:
    """9a: the corpus, authored by the port's TF-free writer."""
    from distributed_tensorflow_framework_torch.data import imagenet_records

    out = os.path.join(workdir, "imagenet")
    t0 = time.perf_counter()
    if imagenet_records.main([out, *RECORD_CORPUS]) != 0:
        raise AssertionError("9a: the corpus writer failed")
    size = sum(os.path.getsize(os.path.join(out, f))
               for f in os.listdir(out))
    log(f"9a corpus: 4,096 + 1,000 JPEG records ({size / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.2f} s ({os.cpu_count()} CPUs)")
    return out


def reader_throughput(corpus: str, smi: str) -> None:
    """9b: images/s of each reader path alone (config 3's 224 x 224 train
    transforms, standardised, batches of 256) per thread count."""
    import itertools

    import numpy as np

    from distributed_tensorflow_framework_torch.data import tfdata
    from distributed_tensorflow_framework_torch.data.imagenet import (
        CYCLE_LENGTH,
        MEAN_RGB,
        STDDEV_RGB,
    )
    from distributed_tensorflow_framework_torch.data.native_reader import (
        NativeRecordReader,
        decode_images,
    )

    files = sorted(os.path.join(corpus, f) for f in os.listdir(corpus)
                   if f.startswith("train-"))
    mean, std = (np.asarray(v, np.float32) for v in (MEAN_RGB, STDDEV_RGB))
    b, n = 256, READER_BATCHES
    seeds = np.arange(b, dtype=np.uint64)
    # One thread is left out for the script's time limit: 4 and
    # every CPU.
    counts = sorted({4, os.cpu_count() or 1})
    rates = {}
    for threads in counts:
        reader = NativeRecordReader(files)
        try:
            it = reader.batches_images(b, 224, 224, threads=threads,
                                       crop_seeds=itertools.repeat(seeds),
                                       mean=mean, std=std)
            next(it)
            t0 = time.perf_counter()
            for _ in range(n):
                next(it)
            rates[("native (DCT-scaled, bilinear)", threads)] = (
                n * b / (time.perf_counter() - t0))
        finally:
            reader.close()
        records = tfdata.interleave(files, tfdata.file_records, CYCLE_LENGTH)
        chunks = [list(itertools.islice(records, b)) for _ in range(n + 1)]
        decode_images(chunks[0], 224, 224, crop_seeds=seeds, mean=mean,
                      std=std, threads=threads)
        t0 = time.perf_counter()
        for chunk in chunks[1:]:
            decode_images(chunk, 224, 224, crop_seeds=seeds, mean=mean,
                          std=std, threads=threads)
        rates[("tf (full-scale window, bicubic)", threads)] = (
            n * b / (time.perf_counter() - t0))
    log(f"9b reader alone, {n} x {b} train images at 224 ({os.cpu_count()} "
        f"CPUs): " + "; ".join(f"{path} {threads} threads {r:.0f} images/s"
                              for (path, threads), r in rates.items())
        + f" [{smi}]")
    # The whole pipeline as config 3 builds it (shuffle buffer, crop
    # seeds, the bf16 cast), without a trainer: its first batch (which
    # fills the shuffle buffer) apart, then PIPELINE_BATCHES within the
    # epoch.
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data.imagenet import (
        make_imagenet,
    )

    line = []
    for native in (False, True):
        cfg = load_config(IMAGENET_CONFIG, overrides=[
            f"data.data_dir={corpus}", "data.global_batch_size=256",
            f"data.use_native_reader={native}"]).data
        ds = make_imagenet(cfg, 0, 1)
        t0 = time.perf_counter()
        next(ds)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(PIPELINE_BATCHES):
            next(ds)
        rate = PIPELINE_BATCHES * 256 / (time.perf_counter() - t0)
        line.append(f"{'native' if native else 'tf.data'} path first batch "
                    f"{first:.2f} s, then {rate:.0f} images/s")
    log(f"9b config 3's pipeline alone (shuffle buffer "
        f"{cfg.shuffle_buffer}, bf16 images, {PIPELINE_BATCHES} batches of "
        f"256): " + "; ".join(line) + f" [{smi}]")


def record_run(torch, config_path: str, over, what: str, workdir: str,
               smi: str) -> dict:
    """One config from the corpus through ``cli.train.main``: the run line
    and the exact eval over the validation images."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    cfg = load_config(config_path, overrides=list(over))
    run = image_run(torch, config_path, over, what,
                    os.path.join(workdir, what.replace(" ", "_") + "_logs"))
    log_image_run(run, what, cfg.data.global_batch_size, smi)
    for e in run["train"]:
        log(f"{what} step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items()))
    evals = [e["metrics"] for e in run["evals"]]
    log(f"{what} exact eval: " + ", ".join(
        f"{k} {v:.6g}" for k, v in (evals[-1] if evals else {}).items()))
    if len(evals) != 1 or evals[0]["eval_examples"] != RECORD_EVAL_IMAGES:
        raise AssertionError(f"{what}: expected one eval over "
                             f"{RECORD_EVAL_IMAGES} images, got {evals}")
    return {"config": cfg, "run": run}


def records_phase(torch, workdir: str, corpus: str, smi: str) -> None:
    """9c and 9d: configs 3 and 4 as written from the corpus, then each
    model's step alone on a resident batch of its records, profiled."""
    data = [f"data.data_dir={corpus}", *RECORD_OVERRIDES]
    runs = {}
    for native in (False, True):
        what = (f"resnet50-imagenet records "
                f"({'native' if native else 'tf.data'} path)")
        runs[what] = record_run(torch, IMAGENET_CONFIG, [
            *data, f"data.use_native_reader={native}",
            f"checkpoint.directory={os.path.join(workdir, 'ck_rn' + str(native))}"],
            what, workdir, smi)
        torch.cuda.empty_cache()
    runs["inception-v3 records"] = record_run(
        torch, INCEPTION_CONFIG, [
            *data, f"checkpoint.directory={os.path.join(workdir, 'ck_inc')}"],
        "inception-v3 records", workdir, smi)
    torch.cuda.empty_cache()
    for what in (f"resnet50-imagenet records (native path)",
                 "inception-v3 records"):
        cfg = runs[what]["config"]
        torch.cuda.reset_peak_memory_stats()
        step_ms, step = image_step(torch, cfg)
        b = cfg.data.global_batch_size
        log(f"{what.split()[0]} step alone (a resident batch of {b} from the "
            f"records): {step_ms:.3f} ms, {1e3 * b / step_ms:.1f} images/s "
            f"(host clock, 5 synced steps), peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{smi}]")
        image_profile(torch, step, step_ms, f"one {what.split()[0]} step")
        del step
        torch.cuda.empty_cache()


def inception_parity(torch) -> None:
    """9e: Inception-v3 in f32 on the card against the CPU (see
    INCEPTION_EVAL_RTOL and INCEPTION_RATIO)."""
    import numpy as np

    from distributed_tensorflow_framework_torch.models.inception import (
        InceptionV3,
    )

    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(4, 299, 299, 3, generator=gen)
    w = torch.randn(2, 4, 1000, generator=gen)
    base = InceptionV3(1000, dropout_rate=0.0, dtype=torch.float32)
    base.init_weights(torch.Generator().manual_seed(SEED))
    state = {k: v.clone() for k, v in base.state_dict().items()}

    def run(device, dtype):
        model = InceptionV3(1000, dropout_rate=0.0, dtype=dtype,
                            device=device)
        model.load_state_dict(state)
        model = model.to(device=device, dtype=dtype)
        if device == "cuda":
            model = model.to(memory_format=torch.channels_last)
        model.train()
        out = model(x.to(device, dtype))
        ((out["logits"] * w[0].to(device, dtype)).sum()
         + (out["aux_logits"] * w[1].to(device, dtype)).sum()).backward()
        model.load_state_dict(state)
        model.eval()
        with torch.no_grad():
            evals = model(x.to(device, dtype))
        as64 = lambda t: t.detach().to("cpu", torch.float64).numpy()  # noqa: E731
        return {"logits": as64(out["logits"]),
                "aux_logits": as64(out["aux_logits"]),
                "grads": {k: as64(p.grad) for k, p in
                          model.named_parameters()},
                "eval": as64(evals)}

    card, cpu = run("cuda", torch.float32), run("cpu", torch.float32)
    truth = run("cuda", torch.float64)

    def distance(got):
        out = {k: np.abs(got[k] - truth[k]).max() / np.abs(truth[k]).max()
               for k in ("logits", "aux_logits")}
        top = max(np.abs(g).max() for g in truth["grads"].values())
        out["grads"] = max(np.abs(got["grads"][k] - g).max() / top
                           for k, g in truth["grads"].items())
        return out

    far_card, far_cpu = distance(card), distance(cpu)
    eval_err = (np.abs(card["eval"] - cpu["eval"]).max()
                / np.abs(cpu["eval"]).max())
    log("9e inception-v3 f32 at 4 x 299 x 299 (TF32 off), train mode, "
        "distance from the model in f64 on the card: " + ", ".join(
            f"{k} card {far_card[k]:.3e} / CPU {far_cpu[k]:.3e}"
            for k in far_card)
        + f" (tol {INCEPTION_RATIO}x the CPU's); eval logits card vs CPU "
        f"{eval_err:.3e} of the largest (tol {INCEPTION_EVAL_RTOL})")
    if (eval_err > INCEPTION_EVAL_RTOL
            or any(far_card[k] > INCEPTION_RATIO * far_cpu[k] + 1e-5
                   for k in far_card)):
        raise AssertionError("9e: Inception-v3 on the card differs from "
                             "the CPU")


def image_records_phase(torch, workdir: str, smi: str, parts: str,
                        before_e=None) -> None:
    """Phase 9 (the parts named in ``parts``: a-f); ``before_e()`` is
    called after 9d."""
    log("9 jpeg toolchain: " + json.dumps(jpeg_toolchain()))
    codec_phase(torch)
    corpus = None
    if set(parts) & set("abcd"):
        log("phase 9a corpus from the TF-free writer")
        corpus = author_corpus(workdir)
    if "b" in parts:
        log("phase 9b the reader alone")
        reader_throughput(corpus, smi)
    if set(parts) & set("cd"):
        log("phase 9c/9d configs 3 and 4 from records")
        records_phase(torch, workdir, corpus, smi)
    if before_e is not None:
        before_e()
    if "e" in parts:
        log("phase 9e Inception-v3 on the card vs the CPU")
        inception_parity(torch)
    if "f" in parts:
        log("phase 9f one-device BatchNorm against an f64 step")
        batchnorm_phase(torch, workdir, smi)


def kernel_class(name: str) -> str:
    name = name.lower()
    for kernel in ("flash_attn_bwd_fused", "flash_attn_bwd_dq",
                   "flash_attn_bwd_dkv", "flash_attn_fwd"):
        if kernel in name:
            return kernel
    if any(t in name for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "gemm"
    if "multi_tensor" in name:  # the foreach ops: grad norm, clip, AdamW
        return "optimizer"
    return "elementwise"


def device_kernels(prof) -> list[tuple[float, int, str]]:
    """(ms, launches, name) of each device kernel in a profile: device-side
    records only (the CPU ops that launched them carry the same time
    again), without user annotation ranges (``Optimizer.step#AdamW.step``
    spans kernels that are counted on their own)."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.key_averages():
        if (getattr(ev, "device_type", None) != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if ms > 0:
            out.append((ms, ev.count, ev.key))
    return out


def device_ms(torch, fn, iters: int = 10, warmup: int = 3) -> float:
    """Device kernel time of one call of ``fn``, from the profiler. For a
    call whose host work outlasts its kernels (an autograd backward over a
    small graph), CUDA events around back-to-back calls would time the
    host instead."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(ms for ms, _, _ in device_kernels(prof))
    if total > 0:
        return total / iters
    # Now and then the profiler records no kernel at all in its window on
    # the H100 machine (a call's device time of 0.0000 ms): CUDA events
    # around the same calls instead.
    log("device_ms: the profiler recorded no kernel; CUDA events instead")
    return time_ms(torch, fn, iters=iters, warmup=0)


def log_profile(prof, what: str, top: int, classify=None) -> float:
    """Sum a profile's device kernel time by class (``classify``, default
    :func:`kernel_class`), log it with the ``top`` longest kernels, and
    return the total in ms (0 when the profiler saw no device time)."""
    classes: dict[str, float] = {}
    kernels = []
    for ms, count, key in device_kernels(prof):
        cls = (classify or kernel_class)(key)
        classes[cls] = classes.get(cls, 0.0) + ms
        kernels.append((ms, count, cls, key[:70]))
    total = sum(classes.values())
    if not total:
        log(f"profile ({what}): torch.profiler saw no device time")
        return 0.0
    log(f"profile ({what}, kernel time by class): " + ", ".join(
        f"{c} {ms:.3f} ms ({100 * ms / total:.1f}%)"
        for c, ms in sorted(classes.items(), key=lambda kv: -kv[1]))
        + f"; total {total:.3f} ms")
    for ms, count, cls, key in sorted(kernels, reverse=True)[:top]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {cls:<11s} {key}")
    return total


def forward_breakdown(torch, model, plain_model, vocab: int) -> None:
    """Where one full batch's device time goes: the served forward at the
    largest bucket (8 rows x 512 tokens) timed against the same model
    with the kernel's plain version, then one profiled forward summed by
    kernel class. Measurement only; runs after the launch counts are
    read."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    ids = torch.randint(0, vocab, (8, 512), device="cuda", generator=gen)
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        t_kernel = time_ms(torch, lambda: model(ids, mask), iters=5)
        t_plain = time_ms(torch, lambda: plain_model(ids, mask), iters=5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(ids, mask)
            torch.cuda.synchronize()
    log(f"forward 8x512 bf16: {t_kernel:.3f} ms with the kernel, "
        f"{t_plain:.3f} ms with its plain version (CUDA events, 5 runs)")
    log_profile(prof, "one forward", top=8)


def serve_phase(torch, fa, workdir: str) -> tuple[int, dict]:
    import numpy as np

    from distributed_tensorflow_framework_torch.cli import serve as cli_serve
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.models.convert import to_flax
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        input_spec_for,
        load_artifact,
        save_artifact,
    )

    config_path = "configs/bert_base_mlm.yaml"
    overrides = ["serve.port=0", "serve.seq_buckets=[128,256,512]",
                 f"serve.log_dir={workdir}/logs", *DECODE_OVERRIDES]
    cfg = load_config(config_path, overrides=overrides)
    m = cfg.model
    if (m.name, m.num_layers, m.hidden_size, m.num_heads, m.mlp_dim,
            m.vocab_size, m.max_seq_len, m.dtype, m.fused_qkv,
            m.attention_impl) != ("bert", 12, 768, 12, 3072, 30522, 512,
                                  "bfloat16", True, "pallas"):
        raise AssertionError(f"{config_path} is no longer BERT-base: {m}")
    t0 = time.perf_counter()
    model = get_model(m, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(SEED))
    artifact_dir = os.path.join(workdir, "artifact")
    save_artifact(artifact_dir, model_config=m, task="mlm",
                  params=to_flax(model), step=0,
                  input_spec=input_spec_for(cfg, "mlm"),
                  source={"seed": SEED, "made_by": "chip_smoke.py"})
    del model
    log(f"serve: BERT-base artifact from seed {SEED} written in "
        f"{time.perf_counter() - t0:.1f} s")

    # 4a: the HTTP server through cli/serve.py's main.
    client = HttpClient(os.path.join(workdir, "logs"), m.vocab_size,
                        generate=DECODE_HTTP_NEW, traced=True)
    reset_counts(fa)
    client.start()
    rc = cli_serve.main(["--artifact", artifact_dir, "--config", config_path,
                         "--device", "cuda", *sum(
                             (["--set", o] for o in overrides), [])])
    http_launches = read_counts(fa, serving=True)["fwd"]
    client.join(60)
    if client.error is not None:
        raise client.error
    if rc != 0:
        raise AssertionError(f"cli.serve.main returned {rc}")
    res = client.results
    latencies = []
    for ids, (status, payload, ms) in zip(res["requests"], res["replies"]):
        out = payload["outputs"]
        shape = (len(out), len(out[0]), len(out[0][0]))
        if status != 200 or shape != (1, len(ids), m.vocab_size):
            raise AssertionError(f"/predict of {len(ids)} tokens: HTTP "
                                 f"{status}, outputs {shape}")
        latencies.append(ms)
    http_batches = res["health"]["engine"]["batches"]
    log(f"serve http: {len(latencies)} requests of lengths "
        f"{list(HTTP_LENGTHS)}, p50 {statistics.median(latencies):.1f} ms, "
        f"max {max(latencies):.1f} ms, batches {http_batches}, kernel "
        f"launches {http_launches}")
    if http_launches != 12 * http_batches or http_batches < 1:
        raise AssertionError(f"expected {12 * http_batches} kernel launches "
                             f"(12 layers x {http_batches} batches), saw "
                             f"{http_launches}")
    check_generate(res["generate"], res["health"], m.vocab_size)
    check_traced(res["traced"], res["health"], os.path.join(workdir, "logs"))

    # 4b: a 512-token and a 300-token request through engine.predict.
    artifact = load_artifact(artifact_dir)
    engine = InferenceEngine(artifact, cfg.serve, device="cuda")
    rng = np.random.default_rng(SEED + 2)
    long_ids = [rng.integers(0, m.vocab_size, n).tolist() for n in (512, 300)]
    reset_counts(fa)
    outs = [engine.predict({"input_ids": ids}, timeout=600)
            for ids in long_ids]
    engine_launches = read_counts(fa, serving=True)["fwd"]
    engine_batches = engine.stats()["batches"]
    engine.drain(60)
    for ids, out in zip(long_ids, outs):
        if out.shape != (1, len(ids), m.vocab_size) or not (
                np.isfinite(out).all()):
            raise AssertionError(f"engine.predict of {len(ids)} tokens gave "
                                 f"{out.shape}")
    log(f"serve engine.predict: lengths {[len(i) for i in long_ids]}, "
        f"batches {engine_batches}, kernel launches {engine_launches}")
    if engine_launches != 12 * engine_batches or engine_batches < 1:
        raise AssertionError(f"expected {12 * engine_batches} launches, "
                             f"saw {engine_launches}")

    ref = reference_model(torch, fa, m, artifact.state_dict)
    i24 = HTTP_LENGTHS.index(24)
    check_logits(torch, ref, res["requests"][i24],
                 res["replies"][i24][1]["outputs"], 128, "http 24 tokens")
    check_logits(torch, ref, long_ids[0], outs[0], 512,
                 "engine 512 tokens")
    forward_breakdown(torch, engine.model, ref, m.vocab_size)
    return http_launches + engine_launches, {
        "requests": len(latencies), "batches": http_batches + engine_batches,
        "artifact": artifact, "config": cfg}


# ---------------------------------------------------------------- phase 5

def train_breakdown(torch, config, warmup: int = 2, steps: int = 5,
                    classify=None) -> float | None:
    """One training step at a main-path run's shape, after the launch
    counts are read: step time over ``steps`` synced steps after
    ``warmup`` (host clock), then one profiled step summed by kernel class;
    idle = 1 − kernel time / step time, returned in % (None when the
    profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    builder = StepBuilder(config, device="cuda")
    state = builder.init_state(SEED)
    batch = to_device(next(get_dataset(config.data)), torch.device("cuda"))
    for _ in range(warmup):
        builder.train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        builder.train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        builder.train_step(state, batch)
        torch.cuda.synchronize()
    log(f"train step {config.data.global_batch_size}x{config.data.seq_len} "
        f"bf16: {step_ms:.3f} ms (host clock, {steps} synced steps)")
    total = log_profile(prof, "one train step", top=12, classify=classify)
    idle = None
    if total:
        idle = 100 * max(0.0, 1 - total / step_ms)
        log(f"train step device idle {idle:.1f}% of the step")
    snapshot_cost(torch, state, f"{config.data.global_batch_size}x"
                                f"{config.data.seq_len}")
    return idle


def snapshot_cost(torch, state, what: str) -> None:
    """The recovery ladder's snapshot of a train state (a host copy of its
    tensors, train/anomaly.py), timed alone on the host clock: the copy
    the trainer takes before its first step and at clean fetches."""
    from distributed_tensorflow_framework_torch.train import anomaly

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = anomaly.snapshot_state(state)
        times.append((time.perf_counter() - t0) * 1e3)
    size = sum(t.numel() * t.element_size() for t in tensor_leaves(host))
    log(f"ladder snapshot {what}: {size / 1e9:.3f} GB device -> host in "
        f"{', '.join(f'{t:.1f}' for t in times)} ms (host clock)")


def tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)
    elif hasattr(tree, "element_size"):
        yield tree


def read_events(directory: str) -> list[dict]:
    with open(os.path.join(directory, "events.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def log_saves(events: list[dict], what: str) -> None:
    """One line per committed save of a run: the time the training thread
    was blocked and the time to the landed commit."""
    saves = [e for e in events if e["kind"] == "ckpt_save"]
    if not saves:
        raise AssertionError(f"{what}: no ckpt_save event")
    for e in saves:
        m = e["metrics"]
        log(f"{what} checkpoint save at step {e['step']} "
            f"({'async' if e['extra']['async_save'] else 'sync'}): "
            f"ckpt_save_blocked_ms {m['ckpt_save_blocked_ms']}, "
            f"ckpt_save_total_ms {m['ckpt_save_total_ms']}")


def run_cli_train(config_path: str, overrides, *extra) -> int:
    from distributed_tensorflow_framework_torch.cli import train as cli_train

    return cli_train.main(["--config", config_path, "--device", "cuda",
                           *extra, *sum((["--set", o] for o in overrides),
                                        [])])


def train_phase(torch, fa, workdir: str) -> tuple[dict, dict]:
    """``cli.train.main`` on BERT-base at full width; returns the launch
    counts of the run, and its checkpoint directory, losses and eval."""
    from distributed_tensorflow_framework_torch.ckpt import manifest as mf
    from distributed_tensorflow_framework_torch.core.config import load_config

    config_path = "configs/bert_base_mlm.yaml"
    ckpt_dir = os.path.join(workdir, "ckpt_512")
    overrides = [*TRAIN_OVERRIDES, f"checkpoint.directory={ckpt_dir}"]
    cfg = load_config(config_path, overrides=overrides)
    m, o = cfg.model, cfg.optimizer
    if (m.name, m.num_layers, m.hidden_size, m.num_heads, m.mlp_dim,
            m.vocab_size, m.max_seq_len, m.dtype, m.fused_qkv,
            m.attention_impl, m.dropout_rate, o.name, o.grad_clip_norm) != (
            "bert", 12, 768, 12, 3072, 30522, 512, "bfloat16", True,
            "pallas", 0.1, "adamw", 1.0):
        raise AssertionError(f"{config_path} is no longer BERT-base MLM "
                             f"training: {m}, {o}")
    log_dir = os.path.join(workdir, "train_logs")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    t0 = time.perf_counter()
    rc = run_cli_train(config_path, overrides, "--log-dir", log_dir)
    counts = read_counts(fa)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise AssertionError(f"cli.train.main returned {rc}")
    events = read_events(log_dir)
    train = [e for e in events if e["kind"] == "train_step"]
    evals = [e for e in events if e["kind"] == "eval"]
    steps, micro = cfg.train.total_steps, cfg.train.total_steps * max(
        1, cfg.train.grad_accum_steps)
    want = {"fwd": 12 * (micro + cfg.train.eval_steps), "dq": 12 * micro,
            "dkv": 12 * micro, "fused": 0}
    for e in train:
        log(f"train step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items())
            + f", {e['throughput']['examples_per_sec']:.2f} examples/s")
    for e in evals:
        log(f"train eval at step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items()))
    values = [v for e in train + evals for v in e["metrics"].values()]
    if ([e["step"] for e in train] != list(range(
            cfg.train.log_interval, steps + 1, cfg.train.log_interval))
            or len(evals) != 1
            or not all(math.isfinite(v) for v in values)):
        raise AssertionError("training metrics missing or not finite")
    # Steady window: the logging windows after the first, which builds
    # the kernels and holds the ladder's baseline snapshot; the throughput
    # meter restarts at every synced log.
    b = cfg.data.global_batch_size
    eps = [e["throughput"]["examples_per_sec"] for e in train[1:]]
    rate = statistics.mean(eps)
    tokens = rate * cfg.data.seq_len
    log(f"train: {steps} steps of {b}x"
        f"{cfg.data.seq_len} in {wall:.1f} s; steady (steps "
        f"{train[0]['step'] + 1}-{steps}) {1e3 * b / rate:.2f}"
        f" ms/step, {tokens:.0f} tokens/s (first window "
        f"{1e3 * b / train[0]['throughput']['examples_per_sec']:.2f} ms/step,"
        f" with the kernel builds and the baseline snapshot); peak memory "
        f"{peak_gb:.2f} GB; kernel launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"expected launches {want}, saw {counts}")
    log_saves(events, "train")
    if mf.committed_steps(ckpt_dir) != [steps]:
        raise AssertionError(f"expected one committed checkpoint at step "
                             f"{steps} in {ckpt_dir}, found "
                             f"{mf.committed_steps(ckpt_dir)}")
    idle = train_breakdown(torch, cfg)
    return counts, {"ckpt": ckpt_dir, "config": config_path,
                    "losses": {e["step"]: e["metrics"]["loss"]
                               for e in train},
                    "eval": evals[0]["metrics"], "ms_per_step": 1e3 * b / rate,
                    "want": want, "idle": idle}


# --------------------------------------------------------------- phase 5c

def resume_phase(torch, fa, workdir: str, full: dict) -> None:
    """Phase 5's run in two legs: 15 steps and a final save into a fresh
    directory, then a new run restores step 15 and trains to 30. The
    step-30 losses and checkpoints must equal phase 5's bit for bit; then
    ``--eval-only`` on the directory must give phase 5's eval."""
    from distributed_tensorflow_framework_torch.ckpt import manifest as mf

    ckpt_dir = os.path.join(workdir, "ckpt_resume")
    over = [*TRAIN_OVERRIDES, f"checkpoint.directory={ckpt_dir}"]
    layers, steps = 12, 30
    legs = (([f"train.total_steps={RESUME_SPLIT}", "train.eval_steps=0"],
             {"fwd": layers * RESUME_SPLIT, "dq": layers * RESUME_SPLIT,
              "dkv": layers * RESUME_SPLIT, "fused": 0}),
            ([], {"fwd": layers * (steps - RESUME_SPLIT + 2),
                  "dq": layers * (steps - RESUME_SPLIT),
                  "dkv": layers * (steps - RESUME_SPLIT), "fused": 0}))
    for i, (extra, want) in enumerate(legs):
        reset_counts(fa)
        rc = run_cli_train(full["config"], over + extra)
        counts = read_counts(fa)
        if rc != 0 or counts != want:
            raise AssertionError(f"resume leg {i + 1}: rc {rc}, launches "
                                 f"{counts}, expected {want}")
        if i == 0 and mf.committed_steps(ckpt_dir) != [RESUME_SPLIT]:
            raise AssertionError(f"leg 1 committed "
                                 f"{mf.committed_steps(ckpt_dir)}")
    events = read_events(ckpt_dir)
    starts = [e for e in events if e["kind"] == "startup"]
    restored = starts[-1]["extra"]["restored_step"]
    losses = {e["step"]: e["metrics"]["loss"] for e in events
              if e["kind"] == "train_step"}
    log(f"resume: leg 1 trained steps 1-{RESUME_SPLIT} and saved, leg 2 "
        f"restored step {restored} and trained to {steps}; losses "
        + ", ".join(f"step {k} {v!r} (phase 5 {full['losses'][k]!r})"
                    for k, v in sorted(losses.items()) if k in full["losses"]))
    common = sorted(set(losses) & set(full["losses"]))
    if (restored != RESUME_SPLIT or common != [10, 20, 30]
            or any(losses[k] != full["losses"][k] for k in common)):
        raise AssertionError("the resumed run's losses differ from phase 5's")
    ours = torch.load(os.path.join(ckpt_dir, str(steps), "state.pt"),
                      map_location="cpu", weights_only=True)
    ref = torch.load(os.path.join(full["ckpt"], str(steps), "state.pt"),
                     map_location="cpu", weights_only=True)
    ours_t, ref_t = list(tensor_leaves(ours)), list(tensor_leaves(ref))
    unequal = [i for i, (a, b) in enumerate(zip(ours_t, ref_t))
               if not torch.equal(a, b)]
    log(f"resume: step-{steps} checkpoint vs phase 5's, {len(ref_t)} tensors "
        f"(parameters, AdamW slots and steps, dropout generator): "
        f"{len(ref_t) - len(unequal)} bit-equal, {len(unequal)} differ")
    if len(ours_t) != len(ref_t) or unequal:
        worst = max(((ours_t[i].float() - ref_t[i].float()).abs().max()
                     .item() for i in unequal), default=0.0)
        raise AssertionError(f"resumed state differs from phase 5's in "
                             f"{len(unequal)} tensors (max |diff| {worst})")
    del ours, ref, ours_t, ref_t
    reset_counts(fa)
    rc = run_cli_train(full["config"], over, "--eval-only")
    counts = read_counts(fa)
    evals = [e for e in read_events(ckpt_dir) if e["kind"] == "eval"]
    got = evals[-1]["metrics"]
    log(f"eval-only at step {evals[-1]['step']}: " + ", ".join(
        f"{k} {v!r}" for k, v in got.items()) + f" (phase 5: "
        + ", ".join(f"{k} {v!r}" for k, v in full["eval"].items())
        + f"); kernel launches {counts}")
    if rc != 0 or got != full["eval"] or counts["fwd"] != layers * 2:
        raise AssertionError("--eval-only does not reproduce phase 5's eval")
    shutil.rmtree(ckpt_dir)


# --------------------------------------------------------------- phase 5d

@contextlib.contextmanager
def fault_env(spec: str):
    """``DTF_FAULTS=spec`` for the block, read by the port's fault plan."""
    from distributed_tensorflow_framework_torch.core import faults

    os.environ["DTF_FAULTS"] = spec
    faults.install(None)
    try:
        yield
    finally:
        del os.environ["DTF_FAULTS"]
        faults.install(None)


def ladder_phase(torch, fa, workdir: str) -> None:
    """The recovery ladder and the SIGTERM contract on the card, through
    ``cli.train.main`` at 8 x 512."""
    from distributed_tensorflow_framework_torch.ckpt import manifest as mf
    from distributed_tensorflow_framework_torch.core import supervision
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.hooks import BaseHook
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    config_path = "configs/bert_base_mlm.yaml"

    def overrides(name, *extra):
        return [*LADDER_OVERRIDES, *extra,
                f"checkpoint.directory={os.path.join(workdir, name)}"]

    # One nan_grads step: exactly one rollback, and the run finishes.
    over = overrides("ckpt_nan")
    cfg = load_config(config_path, overrides=over)
    steps = cfg.train.total_steps
    reset_counts(fa)
    with fault_env(f"nan_grads:{NAN_STEP}"):
        rc = run_cli_train(config_path, over)
    counts = read_counts(fa)
    events = read_events(cfg.checkpoint.directory)
    rollbacks = [e["health"] for e in events if e["kind"] == "rollback"]
    skipped = [e["health"] for e in events if e["kind"] == "batch_skipped"]
    train = [e for e in events if e["kind"] == "train_step"]
    with open(os.path.join(cfg.checkpoint.directory, str(steps),
                           "data_iter.json")) as fh:
        data_state = json.load(fh)
    log(f"ladder: nan_grads at step {NAN_STEP}: rc {rc}, rollbacks "
        f"{rollbacks}, skipped {skipped}, logged steps "
        f"{[e['step'] for e in train]}, losses "
        f"{[round(e['metrics']['loss'], 4) for e in train]}; final "
        f"checkpoint's data state {data_state}; kernel launches {counts}")
    n_skip = sum(s["batches"] for s in skipped)
    if (rc != 0 or len(rollbacks) != 1 or n_skip < 1
            or [e["step"] for e in train] != list(range(2, steps + 1, 2))
            or not all(math.isfinite(v) for e in train
                       for v in e["metrics"].values())
            or data_state["consumed"] != steps + n_skip
            or mf.committed_steps(cfg.checkpoint.directory) != [steps]
            or not counts["fwd"] or not counts["dq"] or not counts["dkv"]):
        raise AssertionError("the nan_grads rollback did not recover")
    shutil.rmtree(cfg.checkpoint.directory)

    # repeat_nan over max_rollbacks + 1 replays of step 3: rc 85.
    over = overrides("ckpt_repeat", "train.log_interval=1",
                     "resilience.snapshot_interval_steps=1",
                     "train.total_steps=6")
    cfg = load_config(config_path, overrides=over)
    tries = cfg.resilience.max_rollbacks + 1
    reset_counts(fa)
    with fault_env(f"repeat_nan:3:{tries}"):
        rc = run_cli_train(config_path, over)
    counts = read_counts(fa)
    rollbacks = [e for e in read_events(cfg.checkpoint.directory)
                 if e["kind"] == "rollback"]
    log(f"ladder: repeat_nan:3:{tries}: rc {rc} after {len(rollbacks)} "
        f"rollbacks (max_rollbacks {cfg.resilience.max_rollbacks}); kernel "
        f"launches {counts}")
    if (rc != supervision.ANOMALY_ESCALATION_RC
            or len(rollbacks) != cfg.resilience.max_rollbacks
            or not counts["fwd"]):
        raise AssertionError("the exhausted ladder did not escalate rc 85")
    shutil.rmtree(cfg.checkpoint.directory)

    # SIGTERM at step 4 once the CLI's handler is armed: rc 83 and a
    # committed checkpoint at step 4 that a new trainer restores.
    class SigtermAt(BaseHook):
        def after_step(self, trainer, step, metrics):
            if step == SIGTERM_STEP:
                if signal.getsignal(signal.SIGTERM) is not \
                        supervision._on_sigterm:
                    raise AssertionError("the SIGTERM handler is not armed")
                os.kill(os.getpid(), signal.SIGTERM)

    over = overrides("ckpt_sigterm")
    cfg = load_config(config_path, overrides=over)
    hooks = Trainer.default_hooks
    Trainer.default_hooks = lambda self: hooks(self) + [SigtermAt()]
    try:
        reset_counts(fa)
        rc = run_cli_train(config_path, over)
        counts = read_counts(fa)
    finally:
        Trainer.default_hooks = hooks
        supervision.reset_preemption()
    committed = mf.committed_steps(cfg.checkpoint.directory)
    trainer = Trainer(cfg, device="cuda")
    trainer.build()
    trainer.writer.close()
    log(f"ladder: SIGTERM at step {SIGTERM_STEP}: rc {rc}, committed "
        f"{committed}, a new trainer restored step {trainer.restored_step}; "
        f"kernel launches {counts}")
    if (rc != supervision.GRACEFUL_PREEMPT_RC or committed != [SIGTERM_STEP]
            or trainer.restored_step != SIGTERM_STEP
            or counts["fwd"] != 12 * SIGTERM_STEP):
        raise AssertionError("the SIGTERM contract failed")
    del trainer
    shutil.rmtree(cfg.checkpoint.directory)


# --------------------------------------------------------------- phase 5e

def export_phase(torch, fa, workdir: str, full: dict) -> None:
    """Phase 5's step-30 checkpoint through ``cli/export.py`` into an
    artifact, served by the engine on the card: its logits for one
    512-token request against the trained model's forward."""
    import numpy as np

    from distributed_tensorflow_framework_torch.cli import export as cli_export
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        load_artifact,
    )

    over = [*TRAIN_OVERRIDES, f"checkpoint.directory={full['ckpt']}",
            "serve.seq_buckets=[128,256,512]"]
    out = os.path.join(workdir, "artifact_trained")
    t0 = time.perf_counter()
    rc = cli_export.main(["--config", full["config"], "--output", out,
                          "--device", "cuda",
                          *sum((["--set", o] for o in over), [])])
    export_s = time.perf_counter() - t0
    cfg = load_config(full["config"], overrides=over)
    artifact = load_artifact(out)
    engine = InferenceEngine(artifact, cfg.serve, device="cuda")
    ids = np.random.default_rng(SEED + 5).integers(
        0, cfg.model.vocab_size, 512).tolist()
    reset_counts(fa)
    try:
        got = engine.predict({"input_ids": ids}, timeout=600)
    finally:
        launches = read_counts(fa, serving=True)["fwd"]
        engine.drain(60)
    trained = get_model(cfg.model, device="cuda")
    trained.load_state_dict(torch.load(
        os.path.join(full["ckpt"], "30", "state.pt"), map_location="cpu",
        weights_only=True)["model"])
    log(f"export: step {artifact.step} of {full['ckpt']} -> {out} in "
        f"{export_s:.1f} s (rc {rc}); engine kernel launches {launches}")
    if rc != 0 or artifact.step != 30 or launches != 12:
        raise AssertionError("export or serving of the trained checkpoint "
                             "failed")
    check_logits(torch, trained, ids, got, 512,
                 "exported step-30 artifact, 512 tokens",
                 ref_name="the trained model")
    del trained, engine
    shutil.rmtree(out)


# --------------------------------------------------------------- phase 5b

def plain_attention_fn(torch, fa):
    """``flash_attention`` with the kernels' plain versions on the card:
    the forward reference, and the dQ/dK/dV references in the backward."""

    class PlainFlashAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, bias, seg):
            o, lse = fa.flash_attention_reference(q, k, v, bias, seg, seg)
            ctx.save_for_backward(q, k, v, bias, seg, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, bias, seg, o, lse = ctx.saved_tensors
            dq, dk, dv, _ = fa.flash_attention_bwd_reference(
                q, k, v, bias, seg, seg, o, lse, do)
            return dq, dk, dv, None, None

    def plain_attention(q, k, v, *, mask=None, segment_ids=None):
        b, s = q.shape[:2]
        bias = fa.attention_bias(mask, b, s, q.device)
        seg = None if segment_ids is None else segment_ids.float()
        return PlainFlashAttention.apply(q, k, v, bias, seg)

    return plain_attention


def train_parity_phase(torch, fa) -> None:
    """One step's gradients through the kernels against the same model
    with their plain versions, then learning on one repeated batch."""
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    cfg = load_config("configs/bert_base_mlm.yaml",
                      overrides=list(PARITY_OVERRIDES))
    builder = StepBuilder(cfg, device="cuda")
    batch = to_device(next(get_dataset(cfg.data)), torch.device("cuda"))
    gradient_parity(torch, fa, builder, batch, "train parity")

    # Learning: the same batch over and over at a constant lr.
    cfg = load_config("configs/bert_base_mlm.yaml",
                      overrides=list(PARITY_OVERRIDES) + list(LEARN_OVERRIDES))
    builder = StepBuilder(cfg, device="cuda")
    state = builder.init_state(SEED)
    trajectory = [float(builder.train_step(state, batch)["loss"])
                  for _ in range(cfg.train.total_steps)]
    log("learning on one repeated batch (8x512, lr 1e-4 constant): loss "
        + " ".join(f"{v:.3f}" for v in trajectory))
    if not trajectory[-1] < LEARN_RATIO * trajectory[0]:
        raise AssertionError(
            f"loss at step {len(trajectory)} ({trajectory[-1]:.4f}) is not "
            f"below {LEARN_RATIO} x the loss at step 1 ({trajectory[0]:.4f})")


def gradient_parity(torch, fa, builder, batch, what: str,
                    layers: int = 12) -> None:
    """One step's gradients on ``batch`` through the kernels against the
    same model, weights and dropout stream with their plain versions:
    every leaf within MODEL_GRAD_RTOL of its largest gradient, and a
    non-zero QKV weight gradient. The kernel route must launch forward, dQ
    and dK/dV once per layer (all with segment ids for a packed batch),
    the plain route none."""
    from distributed_tensorflow_framework_torch.models.bert import (
        MultiHeadAttention,
    )

    packed = "segment_ids" in batch
    grads = {}
    for route in ("kernel", "plain"):
        state = builder.init_state(SEED)  # same weights, same dropout seed
        if route == "plain":
            plain = plain_attention_fn(torch, fa)
            for module in state.model.modules():
                if isinstance(module, MultiHeadAttention):
                    module.attention_fn = plain
        state.optimizer.zero_grad()
        reset_counts(fa)
        builder._micro_step(state, batch, 1.0)
        counts, segmented = read_counts(fa), read_segmented(fa)
        want = {"fwd": layers, "dq": layers, "dkv": layers, "fused": 0}
        if route == "kernel" and (counts != want or segmented != (
                want if packed else dict.fromkeys(want, 0))):
            raise AssertionError(f"kernel route launched {counts}, with "
                                 f"segment ids {segmented}")
        if route == "plain" and any(counts.values()):
            raise AssertionError(f"plain route launched kernels: {counts}")
        grads[route] = {k: p.grad.float().clone()
                        for k, p in state.model.named_parameters()}
        del state
    worst_key, worst = "", 0.0
    for key, ref in grads["plain"].items():
        err = rel_err(grads["kernel"][key], ref)
        if err > worst:
            worst_key, worst = key, err
    qkv = [f"layer{i}.attn.qkv.weight" for i in range(layers)]
    qkv_norms = [grads["kernel"][k].norm().item() for k in qkv]
    qkv_err = max(rel_err(grads["kernel"][k], grads["plain"][k]) for k in qkv)
    log(f"{what}: gradients through the kernels vs their plain "
        f"versions, worst leaf {worst_key} {worst:.3e} of its max (tol "
        f"{MODEL_GRAD_RTOL}); QKV weight gradient norms {min(qkv_norms):.4e}"
        f"..{max(qkv_norms):.4e}, worst QKV error {qkv_err:.3e}")
    if worst > MODEL_GRAD_RTOL or not all(
            n > 0 and math.isfinite(n) for n in qkv_norms):
        raise AssertionError("kernel-path gradients disagree with the "
                             "plain-attention model, or the QKV projection "
                             "got no gradient")


# --------------------------------------------------------------- phase 5f

def census(events: list[dict]) -> dict:
    """The last ``data_packing`` event's metrics: the cumulative packing
    census of the run's train stream."""
    packs = [e for e in events if e["kind"] == "data_packing"]
    if not packs:
        raise AssertionError("no data_packing event")
    return packs[-1]["metrics"]


def packed_run(torch, fa, workdir: str, corpus: str, name: str,
               extra) -> dict:
    """``cli.train.main`` on BERT-base from the corpus's records, with
    ``extra`` overrides; checks rc 0, finite metrics and the launch counts
    (all and with segment ids), and returns the run's numbers."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    config_path = "configs/bert_base_mlm.yaml"
    log_dir = os.path.join(workdir, f"{name}_logs")
    over = [*PACKED_OVERRIDES, f"data.data_dir={corpus}/train",
            f"checkpoint.directory={workdir}/ckpt_{name}", *extra]
    cfg = load_config(config_path, overrides=over)
    steps, layers = cfg.train.total_steps, 12
    evals = (PACKED_EVAL_BATCHES if cfg.train.eval_steps else 0)
    packed = cfg.data.pack_factor > 1
    want = {"fwd": layers * (steps + evals), "dq": layers * steps,
            "dkv": layers * steps, "fused": 0}
    want_seg = ({"fwd": layers * steps, "dq": layers * steps,
                 "dkv": layers * steps, "fused": 0} if packed
                else dict.fromkeys(want, 0))
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    t0 = time.perf_counter()
    rc = run_cli_train(config_path, over, "--log-dir", log_dir)
    counts, segmented = read_counts(fa), read_segmented(fa)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise AssertionError(f"{name}: cli.train.main returned {rc}")
    events = read_events(log_dir)
    train = [e for e in events if e["kind"] == "train_step"]
    eval_events = [e for e in events if e["kind"] == "eval"]
    for e in train + eval_events:
        log(f"{name} {e['kind']} at step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items()))
    values = [v for e in train + eval_events for v in e["metrics"].values()]
    if ([e["step"] for e in train] != list(range(
            cfg.train.log_interval, steps + 1, cfg.train.log_interval))
            or len(eval_events) != (1 if evals else 0)
            or not all(math.isfinite(v) for v in values)):
        raise AssertionError(f"{name}: training metrics missing or not "
                             f"finite")
    if counts != want or segmented != want_seg:
        raise AssertionError(f"{name}: launches {counts} (with segment ids "
                             f"{segmented}), expected {want} ({want_seg})")
    # Steady window: the logging windows after the first, as in phase 5.
    b, seq = cfg.data.global_batch_size, cfg.data.seq_len
    rate = statistics.mean(e["throughput"]["examples_per_sec"]
                           for e in train[1:])
    efficiency = census(events)["packing_efficiency"]
    run = {"cfg": cfg, "events": events, "counts": counts,
           "segmented": segmented, "ms": 1e3 * b / rate,
           "tokens_s": rate * seq, "real_tokens_s": rate * seq * efficiency,
           "efficiency": efficiency,
           "infeed_ms": statistics.median(e["phases"]["infeed"]
                                          for e in train[1:]),
           "eval": eval_events[0]["metrics"] if evals else None}
    log(f"{name}: {steps} steps of {b}x{seq} in {wall:.1f} s; steady (steps "
        f"{train[0]['step'] + 1}-{steps}) {run['ms']:.2f} ms/step, "
        f"{run['tokens_s']:.0f} tokens/s, packing efficiency "
        f"{efficiency:.4f}, real tokens/s {run['real_tokens_s']:.0f}; "
        f"median time_infeed_ms {run['infeed_ms']:.3f} (windows: "
        + ", ".join(f"{e['phases']['infeed']:.3f}" for e in train)
        + f"); peak memory {peak_gb:.2f} GB; kernel launches {counts}, with "
        f"segment ids {segmented}")
    log_saves(events, name)
    return run


def packed_phase(torch, fa, workdir: str) -> dict:
    """``configs/bert_base_mlm.yaml`` trained from TFRecords packed 4:1 as
    written, then exactly evaluated; the same corpus unpacked beside it.
    Returns the launch counts of both runs, all and with segment ids."""
    import numpy as np

    from distributed_tensorflow_framework_torch.data import (
        get_dataset,
        packing,
        progression,
    )
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    corpus = os.path.join(workdir, "corpus")
    t0 = time.perf_counter()
    progression.main([corpus, *PACKED_CORPUS])
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(corpus) for f in files)
    log(f"packed corpus: {size / 1e6:.2f} MB of records authored in "
        f"{time.perf_counter() - t0:.2f} s")
    packed = packed_run(torch, fa, workdir, corpus, "packed", [
        "eval_data.name=text_mlm", f"eval_data.data_dir={corpus}/eval",
        "eval_data.seq_len=512", "eval_data.global_batch_size=32"])
    cfg = packed["cfg"]
    if (cfg.data.pack_factor, cfg.data.shuffle_buffer) != (4, 10_000):
        raise AssertionError(f"configs/bert_base_mlm.yaml no longer packs "
                             f"4:1 from a 10,000-record buffer: {cfg.data}")

    # The census against a host replay of the same packed stream: the
    # real and padded positions of the batches the run trained on.
    ds = get_dataset(cfg.data)
    real = padded = 0
    for _ in range(cfg.train.total_steps):
        mask = next(ds)["attention_mask"]
        real += int(mask.sum())
        padded += int(mask.size - mask.sum())
    replay = packing.packing_stats(real, padded)
    got = census(packed["events"])
    log(f"packed census: last data_packing event {got}; host replay "
        f"{replay}")
    if got != replay:
        raise AssertionError("the packing census differs from the replay")

    # Exact eval: every eval record once, so eval_examples is the count of
    # positions the masker selects over the 1,000 records.
    eval_ds = get_dataset(cfg.eval_data, train=False)
    masked = sum(int((next(eval_ds)["targets"] >= 0).sum())
                 for _ in range(PACKED_EVAL_BATCHES))
    examples = packed["eval"]["eval_examples"]
    log(f"packed exact eval: {eval_ds.cardinality} batches, eval_examples "
        f"{examples!r}; host replay of the masking over the "
        f"{PACKED_CORPUS[PACKED_CORPUS.index('--eval-seqs') + 1]} records: "
        f"{masked} masked positions")
    if eval_ds.cardinality != PACKED_EVAL_BATCHES or examples != masked:
        raise AssertionError("the eval did not walk every record once")

    train_breakdown(torch, cfg)
    unpacked = packed_run(torch, fa, workdir, corpus, "unpacked",
                          ["data.pack_factor=1", "train.eval_steps=0"])
    log(f"packed vs unpacked, same corpus: {packed['ms']:.2f} vs "
        f"{unpacked['ms']:.2f} ms/step, packing efficiency "
        f"{packed['efficiency']:.4f} vs {unpacked['efficiency']:.4f}, real "
        f"tokens/s {packed['real_tokens_s']:.0f} vs "
        f"{unpacked['real_tokens_s']:.0f}: ratio "
        f"{packed['real_tokens_s'] / unpacked['real_tokens_s']:.3f}")

    # One packed 8 x 512 step through the segmented kernels against their
    # plain versions.
    cfg8 = load_config("configs/bert_base_mlm.yaml", overrides=[
        *PARITY_OVERRIDES, f"data.data_dir={corpus}/train"])
    batch = next(get_dataset(cfg8.data))
    log(f"packed parity batch: {int(np.max(batch['segment_ids']))} documents "
        f"in the fullest row, {int(batch['attention_mask'].sum())} real "
        f"tokens of {batch['attention_mask'].size}")
    gradient_parity(torch, fa, StepBuilder(cfg8, device="cuda"),
                    to_device(batch, torch.device("cuda")),
                    "packed train parity")
    for name in ("packed", "unpacked"):
        shutil.rmtree(os.path.join(workdir, f"ckpt_{name}"))
    return {key: {k: packed[key][k] + unpacked[key][k]
                  for k in KERNEL_NAMES}
            for key in ("counts", "segmented")}

# --------------------------------------------------------------- phase 18a

# Phase 18a: phase 5's run (configs/bert_base_mlm.yaml at full width and
# depth, 32 x 512, the checkpoint and resilience sections live) for 9
# steps logged every 3, a profile window over steps (6, 9] (steps 1-3 hold
# the kernel builds and the baseline snapshot, 4-6 are the steady steps
# outside the window) and the first step's memory analysis; memory is
# sampled and the goodput ledger written at every fetch.
OBS_ROWS, OBS_STEPS, OBS_WINDOW = 32, 9, (6, 9)
OBS_OVERRIDES = (
    f"data.global_batch_size={OBS_ROWS}", f"train.total_steps={OBS_STEPS}",
    "train.log_interval=3", "train.eval_steps=0", "train.eval_interval=0",
    f"train.profile_start={OBS_WINDOW[0]}",
    f"train.profile_stop={OBS_WINDOW[1]}",
    "train.memory_analysis=true", "train.memory_interval_s=0",
    "train.goodput_interval_s=0")
# The window's flash kernels, counted in the trace by name.
OBS_KERNELS = ("fwd", "dq", "dkv")
# Coverage: the analyzer's categories and launch gap over its window.
OBS_COVERAGE_TOL = 0.01
# The final goodput event's buckets against its wall.
OBS_GOODPUT_RTOL = 0.01


def observability_phase(torch, fa, workdir: str, full: dict,
                        smi: str) -> dict:
    """Phase 18a through ``cli.train.main``: the profile window's Kineto
    trace read by core/trace_analysis.py (its report; the flash kernels
    counted against the launch counters' rise over the window's steps;
    coverage; optimizer time; the launch gap beside phase 5's idle share;
    the trace_summary event), the first step's memory analysis between
    the state's bytes and the card's capacity, the memory samples from
    the card's allocator, the final goodput event, every event valid, and
    the profiler's cost (ms/step inside the window against the steps
    before it). Returns the run's launches (a main-path run)."""
    from distributed_tensorflow_framework_torch.core import (
        memstats,
        profiling,
        roofline,
        telemetry,
    )
    from distributed_tensorflow_framework_torch.core import (
        trace_analysis as ta,
    )

    config_path = "configs/bert_base_mlm.yaml"
    ckpt = os.path.join(workdir, "ckpt_obs")
    log_dir = os.path.join(workdir, "obs_logs")
    overrides = [*OBS_OVERRIDES, f"checkpoint.directory={ckpt}"]
    # The launch counters when the window opens and when it closes (the
    # ProfileHook synchronizes the card before each).
    window: dict = {}
    start_trace, stop_trace = profiling.start_trace, profiling.stop_trace

    def counted_start():
        window["before"] = read_counts(fa)
        return start_trace()

    def counted_stop(prof, logdir):
        window["path"] = stop_trace(prof, logdir)
        window["after"] = read_counts(fa)
        return window["path"]

    profiling.start_trace, profiling.stop_trace = counted_start, counted_stop
    reset_counts(fa)
    t0 = time.perf_counter()
    try:
        rc = run_cli_train(config_path, overrides, "--log-dir", log_dir)
    finally:
        profiling.start_trace, profiling.stop_trace = start_trace, stop_trace
    counts = read_counts(fa)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"18a: cli.train.main returned {rc}")
    events = list(telemetry.read_events(os.path.join(log_dir,
                                                     "events.jsonl")))
    steps = OBS_STEPS
    want = {"fwd": 12 * steps, "dq": 12 * steps, "dkv": 12 * steps,
            "fused": 0}
    if counts != want:
        raise AssertionError(f"18a: launches {counts}, expected {want}")

    t1 = time.perf_counter()
    trace_events = ta.parse_kineto(ta.load_kineto(window["path"]))
    report = ta.analyze(trace_events)
    report["trace_path"] = window["path"]
    parse_s = time.perf_counter() - t1
    log(f"18a: {steps} steps in {wall:.1f} s, the window's trace "
        f"{os.path.getsize(window['path']) / 1e6:.1f} MB, "
        f"{len(trace_events)} timed events read and analyzed in "
        f"{parse_s:.1f} s")
    for line in ta.format_report(report).splitlines():
        log(f"18a | {line}")
    device = [e for e in trace_events if e.line.startswith("Stream")]
    seen = {k: sum(KERNEL_NAMES[k] in e.name for e in device)
            for k in OBS_KERNELS}
    rose = {k: window["after"][k] - window["before"][k] for k in OBS_KERNELS}
    window_steps = OBS_WINDOW[1] - OBS_WINDOW[0]
    log(f"18a flash kernels in the trace {seen}; launch counters over the "
        f"window's {window_steps} steps {rose}")
    if seen != rose or rose != {k: 12 * window_steps for k in OBS_KERNELS}:
        raise AssertionError(f"18a: trace {seen} against counters {rose}")
    b = report["breakdown"]
    if abs(report["coverage"] - 1) > OBS_COVERAGE_TOL:
        raise AssertionError(f"18a coverage {report['coverage']}")
    if not b["optimizer_update"]["time_ps"] > 0:
        raise AssertionError("18a: no optimizer_update time in the trace")
    idle = full.get("idle")
    log(f"18a launch_gap {100 * b['launch_gap']['fraction_of_window']:.2f}% "
        f"of the window ({b['launch_gap']['time_ps'] / 1e9:.3f} ms of "
        f"{report['window_ps'] / 1e9:.3f}); phase 5's profiled step idle "
        + ("not measured" if idle is None else f"{idle:.2f}%")
        + f"; optimizer_update "
        f"{100 * b['optimizer_update']['fraction_of_window']:.2f}%; "
        f"coverage {report['coverage']:.6f} ({smi})")
    summary = ta.write_summary_event(
        report, os.path.join(log_dir, "trace_summary.jsonl"),
        run_id=events[0]["run_id"])
    if telemetry.validate_event(summary):
        raise AssertionError(f"18a: trace_summary {summary}")

    memory = [e for e in events if e["kind"] == telemetry.KIND_MEMORY]
    [analysis] = [e["extra"]["analysis"] for e in memory
                  if e["extra"]["source_kind"] == "memory_analysis"]
    samples = [e for e in memory
               if e["extra"]["source_kind"] != "memory_analysis"]
    state = torch.load(os.path.join(ckpt, str(steps), "state.pt"),
                       map_location="cpu", weights_only=True, mmap=True)
    state_bytes = memstats.tensor_bytes(state["model"], state["optimizer"])
    name = torch.cuda.get_device_name(0)
    capacity = torch.cuda.get_device_properties(0).total_memory
    table = roofline.CHIP_PEAKS.get(name)
    log(f"18a memory analysis of the first step: argument "
        f"{analysis['argument_bytes'] / 1e9:.3f} GB, temp "
        f"{analysis['temp_bytes'] / 1e9:.3f} GB, peak_bytes_est "
        f"{analysis['peak_bytes_est'] / 1e9:.3f} GB; the state "
        f"{state_bytes / 1e9:.3f} GB; the card {capacity} bytes "
        f"(roofline table: {None if table is None else table[2]}); "
        f"{len(samples)} samples, the last "
        f"{samples[-1]['metrics']['peak_bytes_in_use'] / 1e9:.3f} GB peak")
    if not state_bytes < analysis["peak_bytes_est"] < capacity:
        raise AssertionError(f"18a: peak_bytes_est {analysis} against "
                             f"{state_bytes} and {capacity}")
    if table is not None and table[2] != capacity:
        raise AssertionError(f"18a: core/roofline.py gives {name} "
                             f"{table[2]} bytes, the card has {capacity}")
    if not samples or any(e["extra"]["source_kind"] != "device_memory_stats"
                          for e in samples):
        raise AssertionError(f"18a memory samples {samples}")

    goodput = [e for e in events if e["kind"] == telemetry.KIND_GOODPUT]
    final = goodput[-1]
    buckets, wall_s = final["extra"]["buckets"], final["metrics"]["wall_s"]
    log(f"18a goodput (final): wall {wall_s:.2f} s, goodput_frac "
        f"{final['metrics']['goodput_frac']:.4f}; " + ", ".join(
            f"{k} {v:.2f}" for k, v in buckets.items()))
    if (not final["extra"]["final"]
            or abs(sum(buckets.values()) - wall_s) > OBS_GOODPUT_RTOL
            * wall_s):
        raise AssertionError(f"18a goodput {final}")
    ms = {e["step"]: 1e3 * OBS_ROWS / e["throughput"]["examples_per_sec"]
          for e in events if e["kind"] == telemetry.KIND_TRAIN_STEP}
    inside, outside = ms[OBS_WINDOW[1]], ms[OBS_WINDOW[0]]
    log(f"18a profiler cost: {inside:.2f} ms/step inside the window (steps "
        f"7-9) against {outside:.2f} outside it (steps 4-6), ratio "
        f"{inside / outside:.3f}; phase 5's steady "
        + ("not measured" if full.get("ms_per_step") is None else
           f"{full['ms_per_step']:.2f}")
        + " ms/step with spans, goodput and memory sampling in every "
        "trainer")
    return counts


# ---------------------------------------------------------------- phase 6

def long_config(torch, seq: int, extra=()):
    """``configs/bert_long_ring.yaml`` at ``seq`` tokens on one card, with
    its width and depth checked, cut to LONG_LAYERS layers."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    over = list(LONG_OVERRIDES) + list(extra)
    if seq != 16384:
        over += [f"model.max_seq_len={seq}", f"data.seq_len={seq}"]
    m = load_config(LONG_CONFIG, overrides=over).model
    if (m.name, m.num_layers, m.hidden_size, m.num_heads, m.mlp_dim,
            m.vocab_size, m.dtype, m.remat, m.dropout_rate) != (
            "bert", 12, 768, 12, 3072, 30522, "bfloat16", True, 0.1):
        raise AssertionError(f"{LONG_CONFIG} is no longer long-context "
                             f"BERT-base with remat: {m}")
    over.append(f"model.num_layers={LONG_LAYERS}")
    return load_config(LONG_CONFIG, overrides=over), over


@contextlib.contextmanager
def fused_bwd(fa, value):
    """``fa.FUSED_BWD`` set to ``value`` (None = auto) for the block, as the
    JAX package's scripts assign it, and restored after."""
    saved = fa.FUSED_BWD
    fa.FUSED_BWD = value
    try:
        yield
    finally:
        fa.FUSED_BWD = saved


def long_train_phase(torch, fa, workdir: str, seq: int, route: str) -> dict:
    """``cli.train.main`` on the long-context config at ``seq`` tokens with
    FUSED_BWD on auto, which must pick ``route`` ("fused" or "stream");
    returns the run's launch counts."""
    cfg, over = long_config(torch, seq)
    log_dir = os.path.join(workdir, f"long_{seq}")
    ckpt_dir = os.path.join(workdir, f"ckpt_long_{seq}")
    over = [*over, f"checkpoint.directory={ckpt_dir}"]
    steps = cfg.train.total_steps
    micro = steps * max(1, cfg.train.grad_accum_steps)
    layers = cfg.model.num_layers
    fused = route == "fused"
    # With remat the forward kernel runs twice per layer and micro-batch
    # (forward and recompute), and once per layer for an eval batch.
    want = {"fwd": 2 * layers * micro + layers * cfg.train.eval_steps,
            "dq": 0 if fused else layers * micro,
            "dkv": 0 if fused else layers * micro,
            "fused": layers * micro if fused else 0}
    with fused_bwd(fa, None):
        auto = fa.backward_route(*(torch.empty(1, seq, 1, 64, device="cuda",
                                               dtype=torch.bfloat16),) * 2)
        if auto != route:
            raise AssertionError(
                f"S={seq}: auto picks the {auto} backward on "
                f"{torch.cuda.get_device_name(0)}, expected {route}")
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa)
        t0 = time.perf_counter()
        rc = run_cli_train(LONG_CONFIG, over, "--log-dir", log_dir)
        counts = read_counts(fa)
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise AssertionError(f"cli.train.main returned {rc} at S={seq}")
    events = read_events(log_dir)
    train = [e for e in events if e["kind"] == "train_step"]
    for e in train:
        log(f"long S={seq} step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items()))
    if [e["step"] for e in train] != list(range(1, steps + 1)) or not all(
            math.isfinite(v) for e in train for v in e["metrics"].values()):
        raise AssertionError(f"S={seq}: training metrics missing or not "
                             f"finite")
    # Steady window: the steps after the first; the throughput meter
    # restarts at every synced log step.
    rate = statistics.mean(e["throughput"]["examples_per_sec"]
                           for e in train[1:])
    b = cfg.data.global_batch_size
    log(f"long S={seq}: {steps} steps of {b}x{seq} (grad accum "
        f"{cfg.train.grad_accum_steps}, remat, "
        f"{'fused' if fused else 'two-pass'} backward) in {wall:.1f} s; "
        f"steady (steps 2-{steps}) {1e3 * b / rate:.1f} ms/step, "
        f"{rate * seq:.0f} tokens/s; peak memory {peak_gb:.2f} GB; kernel "
        f"launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"S={seq}: expected launches {want}, saw "
                             f"{counts}")
    log_saves(events, f"long S={seq}")
    shutil.rmtree(ckpt_dir)
    with fused_bwd(fa, None):
        train_breakdown(torch, cfg, warmup=1, steps=1)
    return counts


# --------------------------------------------------------------- phase 6b

def long_fused_parity_phase(torch, fa) -> tuple[dict, int]:
    """At S = 8192 with dropout and remat: one micro-step's gradients with
    the fused backward against the same model, weights, batch and dropout
    stream with the two-pass kernels (a plain-attention model would hold
    12 layers of 3 GB score tensors); then the full phase-6 step timed on
    each route, in turns (host clock), and its kernel time in one profiled
    step per route. Returns the step times and the fused kernel's launches
    in the forced micro-step."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    cfg, _ = long_config(torch, 8192, ("data.global_batch_size=1",
                                       "train.grad_accum_steps=1"))
    builder = StepBuilder(cfg, device="cuda")
    batch = to_device(next(get_dataset(cfg.data)), torch.device("cuda"))
    grads = {}
    for fused in (True, False):
        state = builder.init_state(SEED)
        state.optimizer.zero_grad()
        reset_counts(fa)
        with fused_bwd(fa, fused):
            builder._micro_step(state, batch, 1.0)
        counts = read_counts(fa)
        layers = cfg.model.num_layers
        want = {"fwd": 2 * layers, "dq": 0 if fused else layers,
                "dkv": 0 if fused else layers,
                "fused": layers if fused else 0}
        if counts != want:
            raise AssertionError(f"fused={fused}: launched {counts}, "
                                 f"expected {want}")
        if fused:
            forced_launches = counts["fused"]
        grads[fused] = {k: p.grad.float().clone()
                        for k, p in state.model.named_parameters()}
        del state
    # The key projection's bias has a gradient that is zero in exact
    # arithmetic (softmax ignores the per-row constant q·b_k), so both
    # routes hold only f32 noise there: it is measured against the
    # model's largest gradient, every other leaf against its own.
    top = max(g.abs().max().item() for g in grads[False].values())
    worst_key, worst, noise = "", 0.0, 0.0
    for key, ref in grads[False].items():
        if key.endswith("attn.key.bias"):
            noise = max(noise, (grads[True][key] - ref).abs().max()
                        .item() / top)
            continue
        err = rel_err(grads[True][key], ref)
        if err > worst:
            worst_key, worst = key, err
    log(f"long fused parity S=8192 (dropout 0.1, remat): gradients with "
        f"the fused backward vs the two-pass kernels, worst leaf "
        f"{worst_key} {worst:.3e} of its max (tol {MODEL_GRAD_RTOL}); "
        f"key-projection biases {noise:.3e} of the largest gradient")
    if not (worst <= MODEL_GRAD_RTOL and noise <= MODEL_GRAD_RTOL):
        raise AssertionError("fused-backward gradients disagree with the "
                             "two-pass kernels at S=8192")
    del grads

    cfg, _ = long_config(torch, 8192)
    builder = StepBuilder(cfg, device="cuda")
    batch = to_device(next(get_dataset(cfg.data)), torch.device("cuda"))
    state = builder.init_state(SEED)
    times = {False: [], True: []}
    for i, fused in enumerate((False, True, False, True, True, False,
                               False, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fused_bwd(fa, fused):
            builder.train_step(state, batch)
        torch.cuda.synchronize()
        if i >= 2:  # the first step of each route warms up
            times[fused].append((time.perf_counter() - t0) * 1e3)
    out = {"two_pass_ms": statistics.mean(times[False]),
           "fused_ms": statistics.mean(times[True])}
    log(f"long step S=8192 {cfg.data.global_batch_size}x8192 (grad accum "
        f"{cfg.train.grad_accum_steps}), host clock, synced, in turns: "
        f"two-pass {', '.join(f'{t:.1f}' for t in times[False])} ms, "
        f"fused {', '.join(f'{t:.1f}' for t in times[True])} ms; means "
        f"{out['two_pass_ms']:.1f} / {out['fused_ms']:.1f} ms")
    # The host clock also counts the host's dispatch, which varies from
    # machine to machine; the kernel time of one profiled step per route
    # does not.
    for fused, route in ((False, "two_pass"), (True, "fused")):
        with fused_bwd(fa, fused), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            builder.train_step(state, batch)
            torch.cuda.synchronize()
        out[f"{route}_kernel_ms"] = log_profile(
            prof, f"one 8x8192 step, {route.replace('_', '-')} backward",
            top=0)
    log(f"long step S=8192 kernel time per step: two-pass "
        f"{out['two_pass_kernel_ms']:.1f} ms, fused "
        f"{out['fused_kernel_ms']:.1f} ms")
    return out, forced_launches


# ---------------------------------------------------------------- phase 7

def write_mnist(root: str) -> None:
    """A keras-layout ``mnist.npz``: 28x28 uint8 images of ten learnable
    classes, MNIST_SIZES train and test."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    templates = rng.random((10, 28, 28))

    def split(n):
        y = rng.integers(0, 10, n)
        x = (78 + 100 * templates[y] * rng.uniform(0.5, 1.0, (n, 1, 1))
             + rng.normal(0.0, 80.0, (n, 28, 28)))
        return np.clip(x, 0, 255).astype(np.uint8), y.astype(np.uint8)

    (xt, yt), (xe, ye) = split(MNIST_SIZES[0]), split(MNIST_SIZES[1])
    np.savez(os.path.join(root, "mnist.npz"), x_train=xt, y_train=yt,
             x_test=xe, y_test=ye)


def write_cifar(root: str) -> None:
    """A ``cifar-10-batches-py`` directory: CIFAR_SIZES pickled batches of
    32x32x3 uint8 images (stored channel-major, as CIFAR-10 stores them)
    of ten learnable classes."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    templates = rng.random((10, 32, 32, 3))
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    batches, per_batch, n_test = CIFAR_SIZES
    names = [(f"data_batch_{i}", per_batch) for i in range(1, batches + 1)]
    for name, n in names + [("test_batch", n_test)]:
        y = rng.integers(0, 10, n)
        x = (78 + 100 * templates[y] * rng.uniform(0.5, 1.0, (n, 1, 1, 1))
             + rng.normal(0.0, 80.0, (n, 32, 32, 3)))
        x = np.clip(x, 0, 255).astype(np.uint8).transpose(0, 3, 1, 2)
        with open(os.path.join(base, name), "wb") as fh:
            pickle.dump({b"data": x.reshape(n, -1), b"labels": y.tolist()},
                        fh)


def image_kernel_class(name: str) -> str:
    """cuDNN convolutions, BatchNorm, GEMMs, the optimizer's foreach ops,
    and the rest (ReLU, adds, pooling, casts, the loss)."""
    n = name.lower()
    if any(t in n for t in ("bn_fw", "bn_bw", "batch_norm", "batchnorm")):
        return "batchnorm"
    if any(t in n for t in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                            "cudnn")):
        return "conv"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "gemm"
    if "multi_tensor" in n:
        return "optimizer"
    return "elementwise"


def image_step(torch, config, steps: int = 5):
    """The train step of ``config`` alone, on one batch resident on the
    card: a builder, its state and the batch, timed over ``steps`` synced
    steps after two (host clock); returns (ms per step, the step function)."""
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    builder = StepBuilder(config, device="cuda")
    state = builder.init_state(SEED)
    batch = to_device(next(get_dataset(config.data)), torch.device("cuda"))

    def step():
        builder.train_step(state, batch)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, step


def image_profile(torch, step, step_ms: float, what: str) -> float:
    """One profiled step by kernel class, and the device idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    total = log_profile(prof, what, top=12, classify=image_kernel_class)
    if total:
        log(f"{what}: device idle {100 * max(0.0, 1 - total / step_ms):.1f}%"
            f" of the {step_ms:.3f} ms step")
    return total


def image_run(torch, config_path: str, overrides, what: str,
              log_dir: str) -> dict:
    """``cli.train.main`` on an image config: rc 0, finite metrics, the
    steady window's ms/step and images/s (the windows after the first,
    which builds and autotunes), the median ``time_infeed_ms`` over them
    and the peak memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = run_cli_train(config_path, overrides, "--log-dir", log_dir)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise AssertionError(f"{what}: cli.train.main returned {rc}")
    events = read_events(log_dir)
    train = [e for e in events if e["kind"] == "train_step"]
    evals = [e for e in events if e["kind"] == "eval"]
    values = [v for e in train + evals for v in e["metrics"].values()]
    if len(train) < 2 or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{what}: metrics missing or not finite")
    rate = statistics.mean(e["throughput"]["examples_per_sec"]
                           for e in train[1:])
    infeed = statistics.median(e["phases"]["infeed"]
                               for e in train[1:])
    return {"events": events, "train": train, "evals": evals,
            "rate": rate, "infeed_ms": infeed, "peak_gb": peak_gb,
            "wall": wall, "first": train[0]["throughput"]["examples_per_sec"]}


def log_image_run(run: dict, what: str, batch: int, smi: str) -> None:
    steps = run["train"][-1]["step"]
    log(f"{what}: {steps} steps of {batch} images in {run['wall']:.1f} s; "
        f"steady (steps {run['train'][0]['step'] + 1}-{steps}) "
        f"{1e3 * batch / run['rate']:.3f} ms/step, {run['rate']:.1f} "
        f"images/s (first window {1e3 * batch / run['first']:.3f} ms/step, "
        f"with the first step's autotuning); median time_infeed_ms "
        f"{run['infeed_ms']:.3f}; peak memory {run['peak_gb']:.2f} GB "
        f"[{smi}]")


def lenet_phase(torch, workdir: str, smi: str) -> None:
    """7a: configs/lenet_mnist.yaml as written (2,000 steps of 128, SGD
    with momentum, f32) from a seeded mnist.npz, its checkpoints in the
    workdir. The loss must fall, the exact eval must cover the 1,000 test
    images once, and equal a CPU replay of the saved weights."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.train import losses

    data = os.path.join(workdir, "mnist")
    os.makedirs(data)
    write_mnist(data)
    ckpt = os.path.join(workdir, "ckpt_lenet")
    over = [f"data.data_dir={data}", f"checkpoint.directory={ckpt}"]
    cfg = load_config(LENET_CONFIG, overrides=over)
    m, d, o, t = cfg.model, cfg.data, cfg.optimizer, cfg.train
    got = (m.name, m.dtype, d.name, d.global_batch_size, o.name,
           o.learning_rate, t.total_steps)
    if got != ("lenet5", "float32", "mnist", 128, "sgd_momentum", 0.01,
               2000):
        raise AssertionError(f"{LENET_CONFIG} is no longer config 1: {got}")
    run = image_run(torch, LENET_CONFIG, over, "lenet",
                    os.path.join(workdir, "lenet_logs"))
    train, evals = run["train"], run["evals"]
    first, last = train[0]["metrics"]["loss"], train[-1]["metrics"]["loss"]
    log(f"lenet loss: step {train[0]['step']} {first:.5f} -> step "
        f"{train[-1]['step']} {last:.5f}; top1 "
        f"{train[-1]['metrics']['top1']:.4f}")
    if [e["step"] for e in train] != list(range(100, 2001, 100)):
        raise AssertionError("lenet: train_step events missing")
    if not last < 0.5 * first:
        raise AssertionError(f"lenet: the loss did not fall ({first} -> "
                             f"{last})")
    if len(evals) != 1 or evals[0]["metrics"]["eval_examples"] != \
            MNIST_SIZES[1]:
        raise AssertionError(f"lenet: expected one eval over "
                             f"{MNIST_SIZES[1]} images, got {evals}")
    log_image_run(run, "lenet", d.global_batch_size, smi)
    # The CPU replay: the step-2000 weights, the same eval stream.
    model = get_model(m, device="cpu")
    manager = CheckpointManager(dataclasses.replace(cfg.checkpoint,
                                                    async_save=False))
    try:
        step, _ = manager.restore_model(model, step=t.total_steps)
    finally:
        manager.close()
    totals: dict[str, float] = {}
    with torch.no_grad():
        for batch in get_dataset(d, train=False):
            batch = to_device(batch, torch.device("cpu"))
            sums = losses.classification_metrics_sums(
                model(batch["image"]), batch["label"], batch["weight"])
            for k, v in sums.items():
                totals[k] = totals.get(k, 0.0) + float(v)
    n = totals.pop("weight_sum")
    replay = {f"eval_{k[:-4]}": v / n for k, v in totals.items()}
    got = evals[0]["metrics"]
    log(f"lenet exact eval at step {step}: " + ", ".join(
        f"{k} {got[k]!r} (CPU replay {replay[k]!r})" for k in replay)
        + f"; eval_examples {got['eval_examples']} (replay {n})")
    if (n != got["eval_examples"]
            or abs(got["eval_loss"] - replay["eval_loss"])
            > LENET_EVAL_RTOL * abs(replay["eval_loss"])
            or any(abs(got[k] - replay[k]) > 1.5 / n
                   for k in ("eval_top1", "eval_top5"))):
        raise AssertionError("lenet: the eval differs from the CPU replay")


def cifar_phase(torch, workdir: str, smi: str) -> tuple[str, float]:
    """7b: configs/resnet50_cifar10.yaml as written on one card (mesh.data
    -1, global batch 1024, bf16, SGD momentum lr 0.4 cosine with 500
    warmup steps, weight decay 1e-4) for 30 steps from a seeded
    cifar-10-batches-py, then the exact eval over its 2,000 test images;
    then one step on a resident batch, profiled. Returns the data dir and
    the steady ms/step."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    data = os.path.join(workdir, "cifar")
    os.makedirs(data)
    write_cifar(data)
    ckpt = os.path.join(workdir, "ckpt_cifar")
    over = [f"data.data_dir={data}", f"checkpoint.directory={ckpt}",
            *CIFAR_OVERRIDES]
    cfg = load_config(CIFAR_CONFIG, overrides=over)
    m, d, o = cfg.model, cfg.data, cfg.optimizer
    got = (m.name, m.dtype, d.global_batch_size, o.name, o.learning_rate,
           o.schedule, o.warmup_steps, o.weight_decay, cfg.mesh.data)
    if got != ("resnet50_cifar", "bfloat16", 1024, "sgd_momentum", 0.4,
               "cosine", 500, 1e-4, -1):
        raise AssertionError(f"{CIFAR_CONFIG} is no longer config 2: {got}")
    run = image_run(torch, CIFAR_CONFIG, over, "resnet50-cifar10",
                    os.path.join(workdir, "cifar_logs"))
    for e in run["train"]:
        log(f"resnet50-cifar10 step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items()))
    if (len(run["evals"]) != 1 or run["evals"][0]["metrics"][
            "eval_examples"] != CIFAR_SIZES[2]):
        raise AssertionError(f"resnet50-cifar10: expected one eval over "
                             f"{CIFAR_SIZES[2]} images")
    log("resnet50-cifar10 eval: " + ", ".join(
        f"{k} {v:.6g}" for k, v in run["evals"][0]["metrics"].items()))
    log_image_run(run, "resnet50-cifar10", d.global_batch_size, smi)
    log_saves(run["events"], "resnet50-cifar10")
    step_ms, step = image_step(torch, cfg)
    log(f"resnet50-cifar10 step alone (a resident batch): {step_ms:.3f} "
        f"ms, {1e3 * d.global_batch_size / step_ms:.1f} images/s (host "
        f"clock, 5 synced steps) [{smi}]")
    image_profile(torch, step, step_ms, "one resnet50-cifar10 step")
    return data, 1e3 * d.global_batch_size / run["rate"]


@contextlib.contextmanager
def deterministic(torch):
    """torch.use_deterministic_algorithms for the block (with cuBLAS's
    fixed workspace), then back as it was."""
    saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if saved_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env


def cifar_resume_phase(torch, workdir: str, data: str) -> dict:
    """7d, resume: phase 7b's run under torch.use_deterministic_algorithms
    — 30 steps straight, and 15 steps saved, restored and trained to 30.
    The restored tensors equal the step-15 checkpoint, and the step-30
    checkpoints of the two runs are bit-equal (parameters, BN buffers,
    momentum), as are the losses logged after the split. The 500-step
    warmup covers both legs, so the split does not move the schedule."""
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.loop import Trainer
    from distributed_tensorflow_framework_torch.train.state import host_copy

    total = 2 * CIFAR_RESUME_SPLIT

    def over(name, steps):
        return [f"data.data_dir={data}",
                f"checkpoint.directory={os.path.join(workdir, name)}",
                "train.log_interval=10", f"train.total_steps={steps}",
                "train.eval_steps=0"]

    def tensors(name, step):
        return torch.load(os.path.join(workdir, name, str(step), "state.pt"),
                          map_location="cpu", weights_only=True)

    def compare(a, b):
        a, b = list(tensor_leaves(a)), list(tensor_leaves(b))
        if len(a) != len(b):
            raise AssertionError(f"{len(a)} tensors against {len(b)}")
        return [i for i, (x, y) in enumerate(zip(a, b))
                if not torch.equal(x, y)], len(a)

    with deterministic(torch):
        for name, steps in (("det_straight", total),
                            ("det_resumed", CIFAR_RESUME_SPLIT)):
            if run_cli_train(CIFAR_CONFIG, over(name, steps)) != 0:
                raise AssertionError(f"resume run {name} to {steps} failed")
        trainer = Trainer(load_config(CIFAR_CONFIG, overrides=over(
            "det_resumed", total)), device="cuda")
        try:
            trainer.build()
            restored = trainer.restored_step
            host_state = host_copy(trainer.state.state_dict())
        finally:
            if trainer._ckpt_manager is not None:
                trainer._ckpt_manager.close()
            trainer.writer.close()
        saved = tensors("det_resumed", CIFAR_RESUME_SPLIT)
        differ, n = compare(
            {k: host_state[k] for k in saved}, saved)
        log(f"resume: restored step {restored}; {n} tensors against the "
            f"step-{CIFAR_RESUME_SPLIT} checkpoint: {n - len(differ)} "
            f"bit-equal, {len(differ)} differ")
        if restored != CIFAR_RESUME_SPLIT or differ:
            raise AssertionError("resume: the restored state differs")
        del trainer, host_state
        if run_cli_train(CIFAR_CONFIG, over("det_resumed", total)) != 0:
            raise AssertionError("resume leg 2 failed")
    losses = {}
    for name in ("det_straight", "det_resumed"):
        losses[name] = {e["step"]: e["metrics"]["loss"]
                        for e in read_events(os.path.join(workdir, name))
                        if e["kind"] == "train_step"}
    a, b = losses["det_straight"], losses["det_resumed"]
    straight_over = over("det_straight", total)
    after = sorted(k for k in set(a) & set(b) if k > CIFAR_RESUME_SPLIT)
    differ, n = compare(tensors("det_resumed", total),
                        tensors("det_straight", total))
    log(f"resume (deterministic algorithms): losses " + ", ".join(
        f"step {k} {b[k]!r} (straight {a[k]!r})" for k in after)
        + f"; step-{total} checkpoints, {n} tensors (parameters, BN "
        f"buffers, momentum): {n - len(differ)} bit-equal, {len(differ)} "
        f"differ")
    if differ or not after or any(a[k] != b[k] for k in after):
        raise AssertionError("resume: the resumed run differs from the "
                             "straight one")
    return {"losses": a, "overrides": straight_over,
            "ms_per_step": steady_ms(read_events(os.path.join(
                workdir, "det_straight")))}


def steady_ms(events: list[dict]) -> float:
    """ms/step over a run's logging windows after the first (which holds
    the builds and the autotuning), from the trainer's throughput."""
    train = [e for e in events if e["kind"] == "train_step"]
    meta = next(e for e in events if e["kind"] == "run_meta")
    rate = statistics.mean(e["throughput"]["examples_per_sec"]
                           for e in train[1:])
    return 1e3 * meta["extra"]["global_batch_size"] / rate


def imagenet_phase(torch, workdir: str, smi: str) -> None:
    """7c: config 3's model (ResNet-50 at 224, the s2d stem, label
    smoothing 0.1, the staircase schedule, bf16 images) on its synthetic
    fallback, 10 steps of 256 (cut from 4,096), beside the same with the
    7x7 stem; then the step alone on a resident batch, the two stems in
    turns, each profiled once."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    stems = {"s2d": [], "7x7": ["model.space_to_depth_stem=false"]}
    configs = {}
    for stem, extra in stems.items():
        over = [f"checkpoint.directory="
                f"{os.path.join(workdir, 'ckpt_imagenet_' + stem)}",
                *IMAGENET_SYNTH_OVERRIDES, *extra]
        cfg = load_config(IMAGENET_CONFIG, overrides=over)
        m, d, o = cfg.model, cfg.data, cfg.optimizer
        got = (m.name, m.num_classes, m.dtype, d.image_size, d.image_dtype,
               d.data_dir, o.schedule, cfg.train.label_smoothing)
        if got != ("resnet50", 1000, "bfloat16", 224, "bfloat16", "",
                   "staircase", 0.1):
            raise AssertionError(f"{IMAGENET_CONFIG} is no longer config "
                                 f"3: {got}")
        if m.space_to_depth_stem != (stem == "s2d"):
            raise AssertionError(f"{stem}: space_to_depth_stem is "
                                 f"{m.space_to_depth_stem}")
        configs[stem] = cfg
        run = image_run(torch, IMAGENET_CONFIG, over, f"resnet50-imagenet "
                        f"{stem}", os.path.join(workdir, "imagenet_logs_"
                                                + stem))
        log_image_run(run, f"resnet50-imagenet {stem} stem (synthetic "
                      f"fallback)", d.global_batch_size, smi)
    steps = {stem: image_step(torch, cfg) for stem, cfg in configs.items()}
    turns = {stem: [] for stem in steps}
    for _ in range(2):
        for stem, (_, step) in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            turns[stem].append((time.perf_counter() - t0) * 1e3 / 5)
    b = configs["s2d"].data.global_batch_size
    log(f"resnet50-imagenet step alone (a resident batch of {b}, host "
        f"clock, 5 synced steps per turn, in turns): " + "; ".join(
            f"{stem} stem " + ", ".join(f"{t:.3f}" for t in ts)
            + f" ms ({1e3 * b / statistics.mean(ts):.1f} images/s)"
            for stem, ts in turns.items()) + f" [{smi}]")
    kernel = {stem: image_profile(torch, step, statistics.mean(turns[stem]),
                                  f"one resnet50-imagenet step, {stem} stem")
              for stem, (_, step) in steps.items()}
    log(f"resnet50-imagenet kernel time per step: s2d stem "
        f"{kernel['s2d']:.3f} ms, 7x7 stem {kernel['7x7']:.3f} ms")


def image_parity_phase(torch) -> None:
    """7d: LeNet and a small ResNet (stages (1, 1), width 16) with the
    CIFAR, 7x7 and s2d stems, on the card in f32 and in bf16 against the
    same model and weights in f32 on the CPU: one train step's logits,
    gradients and running statistics (IMAGE_RTOL, IMAGE_GRAD_RTOL)."""
    import numpy as np

    from distributed_tensorflow_framework_torch.models.lenet import LeNet5
    from distributed_tensorflow_framework_torch.models.resnet import ResNet
    from distributed_tensorflow_framework_torch.train import losses

    cases = {
        "lenet": (lambda dt: LeNet5(10, dtype=dt), (8, 28, 28, 1)),
        "resnet cifar stem": (lambda dt: ResNet(
            (1, 1), 10, width=16, cifar_stem=True, dtype=dt), (8, 32, 32, 3)),
        "resnet 7x7 stem": (lambda dt: ResNet((1, 1), 10, width=16, dtype=dt),
                            (8, 64, 64, 3)),
        "resnet s2d stem": (lambda dt: ResNet(
            (1, 1), 10, width=16, space_to_depth_stem=True, dtype=dt),
            (8, 64, 64, 3)),
    }
    rng = np.random.default_rng(SEED)

    def one_step(model, image, labels):
        model.train()
        logits = model(image)
        losses.classification_loss(logits, labels)[0].backward()
        return (logits.detach().float().cpu(),
                {k: p.grad.float().cpu() for k, p in
                 model.named_parameters()},
                {k: b.cpu() for k, b in model.named_buffers()})

    for name, (make, shape) in cases.items():
        image = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
        labels = torch.from_numpy(rng.integers(0, 10, shape[0]))
        ref_model = make(torch.float32)
        ref_model.init_weights(torch.Generator().manual_seed(SEED))
        weights = {k: v.clone() for k, v in ref_model.state_dict().items()}
        ref = one_step(ref_model, image, labels)
        for dtype in ("float32", "bfloat16"):
            model = make(getattr(torch, dtype))
            model.load_state_dict(weights)
            model = model.to("cuda", memory_format=torch.channels_last)
            got = one_step(model, image.cuda(), labels.cuda())
            logit_err = ((got[0] - ref[0]).abs().max()
                         / ref[0].abs().max()).item()
            top = max(g.abs().max() for g in ref[1].values())
            grad_err = max(((got[1][k] - g).abs().max() / top).item()
                           for k, g in ref[1].items())
            stat_err = max((((got[2][k] - b).abs().max()
                             / b.abs().max().clamp(min=1e-12)).item()
                            for k, b in ref[2].items()), default=0.0)
            log(f"image parity {name} {dtype} on the card vs f32 on the "
                f"CPU: logits {logit_err:.3e}, gradients {grad_err:.3e} of "
                f"the largest, running statistics {stat_err:.3e} (tol "
                f"{IMAGE_RTOL[dtype]}, {IMAGE_GRAD_RTOL[dtype]}, "
                f"{IMAGE_RTOL[dtype]})")
            if (logit_err > IMAGE_RTOL[dtype] or stat_err > IMAGE_RTOL[dtype]
                    or grad_err > IMAGE_GRAD_RTOL[dtype]):
                raise AssertionError(f"image parity {name} {dtype}")


# ---------------------------------------------------------------- phase 8

# 8c: two ranks of a gloo group on the one card, each taking its block of
# a global batch, against one process taking the whole batch; f32, TF32
# off, no warmup (so that 3 steps move the parameters by the full rate).
# ResNet-50 with the CIFAR stem at 2 x 128 (BN over the two blocks), at
# the config's lr scaled linearly to the batch (0.4 x 256 / 1024); BERT
# at full width, depth cut to 2, dropout 0, at 2 x (4 x 512), whose halves
# hold different masked-token counts.
DP_STEPS = 3
DP_RESNET = (CIFAR_CONFIG, (
    "model.dtype=float32", "data.name=synthetic_images",
    "data.global_batch_size=256", "optimizer.learning_rate=0.1",
    "optimizer.warmup_steps=0",
    f"train.total_steps={DP_STEPS}", "checkpoint.directory="))
DP_BERT = ("configs/bert_base_mlm.yaml", (
    "model.num_layers=2", "model.dtype=float32", "model.dropout_rate=0.0",
    "data.global_batch_size=8", "optimizer.warmup_steps=0",
    f"train.total_steps={DP_STEPS}", "checkpoint.directory="))
# Two ranks against one whole batch: the same f32 arithmetic summed in
# other orders (DDP's average of two half-batch gradients; BN statistics
# as E[x²] − E[x]² over all-reduced sums against cuDNN's). Losses and
# grad_norm relative to one process. ResNet-50's f32 step is itself far
# from exact arithmetic (the line prints each path's distance from an
# f64 step of the same batch: ~6e-4 of the largest update for one process
# on the H100), so the two paths are not held to each other but to that
# f64 step, after the first step (later steps amplify every rounding):
# the ranks' parameters (over the largest update) and running statistics
# (over the leaf's largest value) may sit no further from it than
# DP_F64_RATIO times the one process's, or within DP_F64_FLOOR. BERT
# (no BatchNorm) is held to the one process: AdamW divides a gradient by
# its root mean square, so a gradient that is zero in exact arithmetic
# (the key bias: softmax ignores a score shift shared by every key)
# moves by up to noise/ε × lr a step (1e-2 × lr seen on the CPU), and its
# parameters after 3 steps are held to an absolute 5e-2 × lr.
DP_TOL = {"resnet": {"loss": 1e-4, "grad_norm": 1e-4},
          "bert": {"loss": 1e-5, "grad_norm": 1e-4, "params": 5e-2}}
DP_F64_RATIO = 2.0
DP_F64_FLOOR = 1e-5
# After which step the tensors are held (see above).
DP_HOLD = {"resnet": 1, "bert": DP_STEPS}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def gang_env(port: int, world: int, rank: int) -> dict:
    """The gang environment of core/cluster.py for one rank; a world of 1
    keeps it (cluster.worker_env would drop it), so a group is formed."""
    return {**os.environ, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank)}


# Waves of children spawned and not yet joined: a failure on the way to
# their phase stops them with the script.
_WAVES: list[dict] = []


def spawn_children(specs: list[dict], workdir: str, name: str,
                   hold: bool = False) -> dict:
    """Start ``python chip_smoke.py --child <spec>`` once per spec, all
    together, each with its own environment and log file. With ``hold``
    each child stops after its start-up (imports, CUDA) until
    :func:`join_children` releases it, so that the start-up overlaps the
    work before it."""
    wave = {"name": name, "procs": [], "hold": hold,
            "t0": time.perf_counter()}
    _WAVES.append(wave)
    for i, spec in enumerate(specs):
        path = os.path.join(workdir, f"{name}_{i}.json")
        spec = {**spec, "out": path, "hold": hold}
        env = spec.pop("env")
        with open(path + ".spec", "w") as fh:
            json.dump(spec, fh)
        logf = open(os.path.join(workdir, f"{name}_{i}.log"), "w")
        wave["procs"].append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             path + ".spec"], env=env, stdout=logf,
            stderr=subprocess.STDOUT), logf, path))
    return wave


def stop_children(wave: dict) -> None:
    """Kill what is left of ``wave`` and close its logs."""
    for proc, logf, _ in wave["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
    if wave in _WAVES:
        _WAVES.remove(wave)


def release_children(wave: dict) -> None:
    """Release a held ``wave`` now, so that its work overlaps what the
    caller does before :func:`join_children`."""
    if wave["hold"] and "released" not in wave:
        for _, _, path in wave["procs"]:
            open(path + ".go", "w").close()
        wave["released"] = time.perf_counter()


def join_children(wave: dict, timeout: float = 600.0) -> list[dict]:
    """Release ``wave`` if it was held, wait for every child and return
    what each wrote. A child that fails or times out fails the phase,
    with the end of every child's log; every child is stopped on the way
    out. Logs where the wave's time went: the slowest child's start-up
    (imports, CUDA), wait for its release and work on its own clock, and
    the rest of its life (the interpreter's start and exit)."""
    name, procs = wave["name"], wave["procs"]
    release_children(wave)
    t0, ended = wave.get("released", time.perf_counter()), {}
    try:
        # Poll them all: a rank that fails leaves its peers blocked in a
        # collective, so the first failure stops the rest.
        deadline = time.monotonic() + timeout
        while any(proc.poll() is None for proc, _, _ in procs):
            if (time.monotonic() > deadline
                    or any(proc.poll() not in (None, 0)
                           for proc, _, _ in procs)):
                break
            for i, (proc, _, _) in enumerate(procs):
                if proc.poll() is not None:
                    ended.setdefault(i, time.perf_counter() - wave["t0"])
            time.sleep(0.1)
    finally:
        stop_children(wave)
    codes = [proc.returncode for proc, _, _ in procs]
    if any(codes) or not all(os.path.exists(path) for _, _, path in procs):
        for i, (_, logf, _) in enumerate(procs):
            with open(logf.name) as fh:
                print(f"{name} child {i}:\n{fh.read()[-4000:]}",
                      file=sys.stderr)
        raise AssertionError(f"{name} children exited {codes} (a child "
                             f"killed after a peer failed shows -9)")
    out, clocks = [], []
    for i, (_, _, path) in enumerate(procs):
        with open(path) as fh:
            out.append(json.load(fh))
        with open(path + ".t") as fh:
            clocks.append(json.load(fh))
        clocks[-1]["life"] = ended.get(i, time.perf_counter() - wave["t0"])
    slow = max(clocks, key=lambda c: c["life"])
    log(f"{name}: {len(procs)} children in {time.perf_counter() - t0:.1f} s"
        + (f" from their release ({t0 - wave['t0']:.1f} s after their "
           f"start)" if wave["hold"] else "")
        + f"; the slowest: start-up {slow['ready']:.1f} s, held "
        f"{slow['start'] - slow['ready']:.1f} s, work "
        f"{slow['done'] - slow['start']:.1f} s, the rest "
        f"{slow['life'] - slow['done']:.1f} s")
    return out


def run_children(specs: list[dict], workdir: str, name: str,
                 timeout: float = 600.0) -> list[dict]:
    """:func:`spawn_children` and :func:`join_children` in one."""
    return join_children(spawn_children(specs, workdir, name), timeout)


def cli_runs(*runs: tuple[list, bool]) -> dict:
    """The spec of a ``cli`` child that runs ``cli.train.main`` once for
    each (argv, deterministic) in turn, each in a world of 1 of its own."""
    return {"kind": "cli", "env": gang_env(free_port(), 1, 0),
            "runs": [{"argv": argv, "deterministic": det,
                      "port": free_port()} for argv, det in runs]}


def cli_run(torch, fa, run: dict) -> dict:
    """One run of a ``cli`` child: ``cli.train.main`` on the gang port of
    its own (the run forms its group and shuts it down), with the launch
    counts set to 0 just before and read just after (under
    ``torch.use_deterministic_algorithms`` when asked), and its peak
    device memory."""
    from distributed_tensorflow_framework_torch.cli import train as cli_train

    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{run['port']}"
    reset_counts(fa)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with (deterministic(torch) if run["deterministic"]
          else contextlib.nullcontext()):
        rc = cli_train.main(run["argv"])
    return {"rc": rc, "counts": read_counts(fa),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def child_main(spec_path: str) -> int:
    """One child of phases 8 and 10-16: ``cli`` runs ``cli.train.main``
    once or more (:func:`cli_run`); ``rank`` is one rank of 8c, ``coll``
    one rank of 10b, ``zero`` one rank of 11a, 11b and 11c,
    ``tp`` one of phase 12, ``ring`` one of 13b, 13c or 13d, ``pipe``
    one of phase 14, ``moe`` one of 15d, ``fused`` one of 16e and
    ``compose`` one of phase 21.
    Writes its result as JSON to the spec's ``out``."""
    import torch

    from distributed_tensorflow_framework_torch.ops import (
        flash_attention as fa,
    )

    with open(spec_path) as fh:
        spec = json.load(fh)
    torch.cuda.init()
    ready = time.perf_counter() - _START
    go = spec["out"] + ".go"
    while spec["hold"] and not os.path.exists(go):
        time.sleep(0.05)  # a script that is gone ends this child (watcher)
    start = time.perf_counter() - _START
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec.get("deterministic"):
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
    if spec["kind"] == "cli":
        result = [cli_run(torch, fa, run) for run in spec["runs"]]
    elif spec["kind"] == "coll":
        result = coll_rank(torch, os.path.dirname(spec["out"]))
    elif spec["kind"] == "zero":
        result = zero_rank(torch, fa, os.path.dirname(spec["out"]))
    elif spec["kind"] == "tp":
        result = tp_rank(torch, fa, os.path.dirname(spec["out"]))
    elif spec["kind"] == "ring":
        result = ring_rank(torch, fa, spec)
    elif spec["kind"] == "pipe":
        result = pipe_rank(torch, fa, spec)
    elif spec["kind"] == "moe":
        result = moe_rank(torch, fa, os.path.dirname(spec["out"]))
    elif spec["kind"] == "fused":
        result = fused_rank(torch, fa, os.path.dirname(spec["out"]))
    elif spec["kind"] == "compose":
        result = compose_rank(torch, fa, os.path.dirname(spec["out"]))
    else:
        result = dp_rank(torch, os.path.dirname(spec["out"]))
    with open(spec["out"], "w") as fh:
        json.dump(result, fh)
    with open(spec["out"] + ".t", "w") as fh:
        json.dump({"ready": ready, "start": start,
                   "done": time.perf_counter() - _START}, fh)
    return 0


def dp_case(torch, config_path: str, overrides, hold: int,
            runtime=None) -> dict:
    """DP_STEPS steps of a StepBuilder on the global batches of
    ``config``'s stream (drawn whole, at one process), each rank taking
    its block: the global metrics of every step, the initial parameters
    and the parameters and buffers after step ``hold``."""
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    cfg = load_config(config_path, overrides=list(overrides))
    builder = StepBuilder(cfg, device="cuda", runtime=runtime)
    state = builder.init_state(SEED)
    init = {k: p.detach().cpu().clone()
            for k, p in state.model.named_parameters()}
    world = 1 if runtime is None else runtime.process_count
    rank = 0 if runtime is None else runtime.process_index
    ds = get_dataset(cfg.data)
    steps, masked = [], []
    b, half = (cfg.data.global_batch_size // world,
               cfg.data.global_batch_size // 2)
    for step in range(1, DP_STEPS + 1):
        batch = next(ds)
        if "targets" in batch:
            masked.append([int((batch["targets"][:half] >= 0).sum()),
                           int((batch["targets"][half:] >= 0).sum())])
        block = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        metrics = builder.global_metrics(builder.train_step(
            state, to_device(block, torch.device("cuda"))))
        steps.append({k: float(v) for k, v in metrics.items()})
        if step == hold:
            tensors = {k: v.detach().cpu().clone() for k, v in
                       state.model.state_dict().items()}
    return {"steps": steps, "masked": masked, "tensors": tensors,
            "params": init, "lr": cfg.optimizer.learning_rate}


def dp_rank(torch, out_dir: str) -> dict:
    """One rank of 8c: a gloo group (with CUDA tensors) on the one card;
    the ResNet case and then the BERT case in the same group, their held
    tensors saved in ``out_dir``."""
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    runtime = initialize_runtime(MeshConfig(), "cuda", backend="gloo")
    try:
        out = {"backend": runtime.backend, "rank": runtime.process_index}
        for name, (path, over) in (("resnet", DP_RESNET),
                                   ("bert", DP_BERT)):
            res = dp_case(torch, path, over, DP_HOLD[name], runtime)
            tensor_path = os.path.join(
                out_dir, f"dp_{name}_rank{runtime.process_index}.pt")
            torch.save(res.pop("tensors"), tensor_path)
            del res["params"]
            out[name] = {**res, "tensors": tensor_path}
        return out
    finally:
        runtime.shutdown()


def dp_f64_step(torch, config_path: str, overrides) -> dict:
    """The first step of ``dp_case``'s stream in float64 in one process:
    the model, its casts, the loss and the optimizer's update all in f64.
    Returns the tensors after it and the initial parameters."""
    import torch.nn.functional as F

    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.optimizers import (
        global_norm,
    )
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    cfg = load_config(config_path, overrides=list(overrides))
    state = StepBuilder(cfg, device="cuda").init_state(SEED)
    model = state.model.double()
    for module in model.modules():
        if isinstance(getattr(module, "dtype", None), torch.dtype):
            module.dtype = torch.float64
    init = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
    batch = to_device(next(get_dataset(cfg.data)), torch.device("cuda"))
    loss = F.cross_entropy(model(batch["image"].double()),
                           batch["label"].long(),
                           label_smoothing=cfg.train.label_smoothing)
    loss.backward()
    state.optimizer.step(global_norm([p.grad for p in model.parameters()]))
    return {"tensors": {k: v.detach().cpu() for k, v in
                        model.state_dict().items()}, "params": init}


def dp_distance(tensors: dict, truth: dict) -> dict:
    """(distance, worst leaf) of held tensors from the f64 step's:
    parameters over the largest update it made, running statistics over
    each leaf's largest value."""
    init = truth["params"]
    top = max((truth["tensors"][k] - v).abs().max().item()
              for k, v in init.items())
    out = {"params": (0.0, ""), "buffers": (0.0, "")}
    for key, want in truth["tensors"].items():
        err = (tensors[key].double() - want).abs().max().item()
        kind = "params" if key in init else "buffers"
        den = top if kind == "params" else max(want.abs().max().item(),
                                                1e-30)
        out[kind] = max(out[kind], (err / den, key))
    return out


def dp_compare(torch, name: str, ranks: list[dict], ref: dict,
               truth: dict | None = None) -> None:
    """8c: each rank's global metrics against the whole batch's in one
    process, and its held tensors against the one process's (BERT) or
    against the f64 step's beside the one process's (ResNet)."""
    tol = DP_TOL[name]
    worst = {k: (0.0, "") for k in tol}
    ref_far = (dp_distance(ref["tensors"], truth) if truth is not None
               else None)
    far = {"params": (0.0, ""), "buffers": (0.0, "")}
    for r in ranks:
        res = r[name]
        for got, want in zip(res["steps"], ref["steps"]):
            for key in ("loss", "grad_norm"):
                err = abs(got[key] - want[key]) / abs(want[key])
                worst[key] = max(worst[key], (err, key))
        tensors = torch.load(res["tensors"], weights_only=True)
        if truth is not None:
            dist = dp_distance(tensors, truth)
            far = {k: max(far[k], dist[k]) for k in far}
            continue
        for key, want in ref["tensors"].items():
            if key in ref["params"]:
                err = (tensors[key].float() - want.float()).abs().max()
                worst["params"] = max(worst["params"],
                                      (err.item() / ref["lr"], key))
    line = ", ".join(f"{k} {v:.3e} (tol {tol[k]})"
                     for k, (v, _) in worst.items() if k != "params")
    if truth is None:
        line += (f", parameters {worst['params'][0]:.3e} of lr (tol "
                 f"{tol['params']}, {worst['params'][1]})")
    else:
        line += "; after step 1, from an f64 step: " + ", ".join(
            f"{k} two ranks {far[k][0]:.3e} ({far[k][1]}), one process "
            f"{ref_far[k][0]:.3e} ({ref_far[k][1]})" for k in far)
        line += (f" (parameters over the largest update, statistics over "
                 f"the leaf's largest value; tol {DP_F64_RATIO}x the one "
                 f"process's or {DP_F64_FLOOR})")
    log(f"8c {name}: 2 ranks (gloo, CUDA tensors, one card) vs the whole "
        f"batch in one process, {DP_STEPS} steps: {line}; losses "
        + ", ".join(f"{s['loss']!r}" for s in ref["steps"]))
    if any(worst[k][0] > tol[k] for k in tol):
        raise AssertionError(f"8c {name}: two ranks differ from one")
    if truth is not None and any(
            far[k][0] > max(DP_F64_RATIO * ref_far[k][0], DP_F64_FLOOR)
            for k in far):
        raise AssertionError(f"8c {name}: two ranks are further from the "
                             f"f64 step than one process is")


def dp_world1_wave(workdir: str, full: dict, cifar: dict,
                   hold: bool = False) -> dict:
    """8a and 8b's child: BERT-base at world 1 over NCCL, phase 5's cut;
    ResNet-50/CIFAR-10 at world 1 over NCCL, 7d's deterministic cut."""
    log_dir = os.path.join(workdir, "dp_bert_logs")
    argv = ["--config", full["config"], "--device", "cuda", "--log-dir",
            log_dir, *sum((["--set", o] for o in (
                *TRAIN_OVERRIDES,
                f"checkpoint.directory={os.path.join(workdir, 'dp_bert')}")),
                [])]
    cifar_dir = os.path.join(workdir, "dp_cifar")
    over = [o for o in cifar["overrides"]
            if not o.startswith("checkpoint.directory=")]
    cifar_argv = ["--config", CIFAR_CONFIG, "--device", "cuda", *sum(
        (["--set", o] for o in (*over, f"checkpoint.directory={cifar_dir}")),
        [])]
    return spawn_children([cli_runs((argv, False), (cifar_argv, True))],
                          workdir, "dp_world1", hold=hold)


def data_parallel_phase(torch, fa, workdir: str, full: dict,
                        cifar: dict, cifar_ms: float, smi: str,
                        world1=None) -> dict:
    """Phase 8: 8a and 8b run ``cli.train`` one after the other in a child
    process (``world1``, started held earlier, or started here), each with
    the gang environment of a world of 1 (an NCCL group, the model under
    DDP), at phase 5's and phase 7d's cuts, whose losses must be phase
    5's and the deterministic 7d run's bit for bit; 8c runs two gloo
    ranks on the one card against one process. Returns 8a's launch
    counts (the main path's run of this phase) and its steady ms/step."""
    # 8c's ranks start up while 8a and 8b run.
    dp_ranks = spawn_children([{"kind": "rank", "env": gang_env(port, 2, r)}
                               for port in [free_port()] for r in range(2)],
                              workdir, "dp_ranks", hold=True)
    log_dir = os.path.join(workdir, "dp_bert_logs")
    (runs,) = join_children(world1 or dp_world1_wave(workdir, full, cifar))
    res = runs[0]
    events = read_events(log_dir)
    meta = next(e for e in events if e["kind"] == "run_meta")["extra"]
    losses = {e["step"]: e["metrics"]["loss"] for e in events
              if e["kind"] == "train_step"}
    ms = bert_ms = steady_ms(events)
    log(f"8a bert world 1: group {meta['process_group']}, ddp "
        f"{meta['ddp']}, rc {res['rc']}; losses " + ", ".join(
            f"step {k} {v!r} (phase 5 {full['losses'][k]!r})"
            for k, v in sorted(losses.items()))
        + f"; steady {ms:.2f} ms/step against phase 5's "
        f"{full['ms_per_step']:.2f} "
        f"({100 * (ms / full['ms_per_step'] - 1):+.2f}%); kernel launches "
        f"{res['counts']} [{smi}]")
    if (res["rc"] != 0 or meta["process_group"] != "nccl" or not meta["ddp"]
            or losses != full["losses"] or res["counts"] != full["want"]):
        raise AssertionError("8a: the world-1 NCCL run differs from phase 5")
    counts = res["counts"]
    res = runs[1]
    events = read_events(os.path.join(workdir, "dp_cifar"))
    meta = next(e for e in events if e["kind"] == "run_meta")["extra"]
    losses = {e["step"]: e["metrics"]["loss"] for e in events
              if e["kind"] == "train_step"}
    ms = steady_ms(events)
    log(f"8b resnet50-cifar10 world 1 (deterministic algorithms): group "
        f"{meta['process_group']}, ddp {meta['ddp']}, rc {res['rc']}; "
        f"losses " + ", ".join(
            f"step {k} {v!r} (no group {cifar['losses'][k]!r})"
            for k, v in sorted(losses.items()))
        + f"; steady {ms:.3f} ms/step against {cifar['ms_per_step']:.3f} "
        f"without a group ({100 * (ms / cifar['ms_per_step'] - 1):+.2f}%) "
        f"and phase 7b's {cifar_ms:.3f} [{smi}]")
    if (res["rc"] != 0 or meta["process_group"] != "nccl" or not meta["ddp"]
            or losses != cifar["losses"]):
        raise AssertionError("8b: the world-1 NCCL run differs from the run "
                             "without a group")
    # 8c: two gloo ranks on the one card against one process.
    torch.cuda.empty_cache()
    refs = {}
    for name, (path, over) in (("resnet", DP_RESNET), ("bert", DP_BERT)):
        refs[name] = dp_case(torch, path, over, DP_HOLD[name])
        torch.cuda.empty_cache()
    truth = dp_f64_step(torch, *DP_RESNET)
    torch.cuda.empty_cache()
    ranks = join_children(dp_ranks)
    if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
        raise AssertionError(f"8c: backends {ranks}")
    masked = ranks[0]["bert"]["masked"]
    log(f"8c bert masked tokens per rank block, per step: {masked}")
    if any(m[0] == m[1] for m in masked):
        raise AssertionError("8c: the ranks' blocks hold equal masked counts")
    dp_compare(torch, "resnet", ranks, refs["resnet"], truth)
    dp_compare(torch, "bert", ranks, refs["bert"])
    return counts, bert_ms


# --------------------------------------------------------------- phase 10

# 10a: phase 5's cut at world 1 over NCCL, the explicit-collective step on
# the int8 error-feedback wire (block 256, the default); 10a': the same
# with no wire for 10 steps, whose losses must be phase 5's bit for bit.
COLL_OVERRIDES = ("train.spmd_mode=shard_map",
                  "parallel.collective_dtype=int8")
COLL_PLAIN_STEPS = 10
# 10a's child: the int8 error-feedback wire at full width (10a), and
# shard_map with no wire, bit-equal to phase 5's first steps (10a'; no
# checkpoint: nothing reads it, and its save costs seconds).
COLL_WORLD1 = {"coll_int8": COLL_OVERRIDES,
               "coll_plain": ("train.spmd_mode=shard_map",
                              f"train.total_steps={COLL_PLAIN_STEPS}",
                              "checkpoint.directory=")}
# The int8 run's losses against phase 5's at the log steps, and 10b's
# int8 LeNet against its f32 run: the tolerance of
# tests/test_compressed_allreduce.py::test_int8_ef_dp_loss_parity.
COLL_LOSS_TOL = {"rtol": 0.02, "atol": 2e-3}
# 10b: every function of parallel/collectives.py on seeded tensors of
# BERT-base leaf shapes (the word embedding, the fused QKV, a bias and a
# 3-element leaf), on CUDA tensors (gloo's all_reduce transport) and on
# CPU tensors (gloo's native ops). The same f32 operations in the same
# order on both devices (IEEE division, round half to even, the fused
# multiply-adds of collectives.py), so the results must be bit-equal.
COLL_LEAVES = {"embedding": (30522, 768), "qkv": (768, 2304),
               "bias": (768,), "tiny": (3,)}
COLL_WIRES = ("", "bfloat16", "int8")
# 10b's LeNet: config 1's model under shard_map at 2 x 64, 10 steps (5, a
# save, a restore and 5 more under deterministic algorithms).
COLL_LENET = ("data.global_batch_size=128", "train.spmd_mode=shard_map",
              "checkpoint.directory=", "checkpoint.async_save=false")
COLL_STEPS, COLL_SPLIT = 10, 5


def coll_inputs(torch, rank: int) -> dict:
    """This rank's seeded leaves (gradient-sized, of another magnitude on
    each rank) and a residual of each leaf's shape."""
    gen = torch.Generator().manual_seed(SEED * 1000 + rank)
    scale = (1e-3, 1e-1)[rank % 2]
    return {"g": {k: torch.randn(s, generator=gen) * scale
                  for k, s in COLL_LEAVES.items()},
            "r": {k: torch.randn(s, generator=gen) * 1e-5
                  for k, s in COLL_LEAVES.items()}}


def coll_cases(coll, inp: dict, rt) -> dict:
    """Every function of parallel/collectives.py in every wire mode, as
    {case: call}."""
    import functools

    g, r = inp["g"], inp["r"]
    cases = {
        "allreduce_f32": lambda: coll.allreduce_gradients(g, rt),
        "allreduce_bf16_f32": lambda: coll.allreduce_gradients(
            g, rt, compute_dtype="bfloat16"),
        "allreduce_bf16_wire": lambda: coll.allreduce_gradients(
            g, rt, compute_dtype="bfloat16", accumulate_f32=False),
        "allreduce_int8": lambda: coll.allreduce_gradients(
            g, rt, compute_dtype="int8"),
        "allreduce_int8_ef": lambda: list(coll.allreduce_gradients_ef(
            g, r, rt)),
        "psum": lambda: coll.psum(g, rt),
        "pmean": lambda: coll.pmean(g, rt),
    }
    for name, x in g.items():
        for w in COLL_WIRES:
            cases[f"all_gather_{name}_{w or 'f32'}"] = functools.partial(
                coll.all_gather, x, rt, wire_dtype=w)
            if x.shape[0] % rt.process_count == 0:
                cases[f"reduce_scatter_{name}_{w or 'f32'}"] = (
                    functools.partial(coll.reduce_scatter, x, rt,
                                      wire_dtype=w))
    return cases


def coll_functions(torch, rt) -> dict:
    """10b part 1 on one rank: each case on CUDA tensors and on CPU
    tensors, compared here. A native CPU op that this torch's gloo lacks
    is reported, and that case's CUDA result is held against the same
    protocol on CPU tensors through the all_reduce transport (which the
    CPU tests hold bit-equal to the native ops)."""
    from distributed_tensorflow_framework_torch.parallel import (
        collectives as coll,
    )

    host = coll_inputs(torch, rt.process_index)
    dev = {k: {n: t.cuda() for n, t in v.items()} for k, v in host.items()}
    cuda_calls, cpu_calls = coll_cases(coll, dev, rt), coll_cases(
        coll, host, rt)
    out = {}
    for name in cuda_calls:
        t0 = time.perf_counter()
        with coll.tally() as tc:
            got = [t.cpu() for t in tensor_leaves(cuda_calls[name]())]
        torch.cuda.synchronize()
        missing = None
        try:
            with coll.tally() as th:
                want = list(tensor_leaves(cpu_calls[name]()))
        except (RuntimeError, NotImplementedError) as e:
            missing = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            rt.collective_transport = lambda device: "all_reduce"
            try:
                with coll.tally() as th:
                    want = list(tensor_leaves(cpu_calls[name]()))
            finally:
                del rt.collective_transport
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(got, want))
        out[name] = {
            "equal": len(got) == len(want) and all(
                torch.equal(a, b) for a, b in zip(got, want)),
            "max_abs_diff": diff, "tally_equal": tc.summary() == th.summary(),
            "cpu_missing": missing, "s": time.perf_counter() - t0}
    return out


def coll_lenet(torch, rt, out_dir: str) -> dict:
    """10b part 2 on one rank: config 1's LeNet under shard_map at 2 x 64
    on this rank's blocks of 10 global batches: the f32 run, the int8
    error-feedback run, and the int8 run in two legs of 5 around a save
    (the chief's) and a restore into a state built from another seed."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    def build(wire: str, seed: int = SEED):
        cfg = load_config(LENET_CONFIG, overrides=[*COLL_LENET, *(
            [f"parallel.collective_dtype={wire}"] if wire else [])])
        builder = StepBuilder(cfg, device="cuda", runtime=rt)
        return builder, builder.init_state(seed)

    def steps(builder, state, batches) -> list[float]:
        b = builder.config.data.global_batch_size // rt.process_count
        out = []
        for batch in batches:
            block = {k: v[rt.process_index * b:(rt.process_index + 1) * b]
                     for k, v in batch.items()}
            m = builder.train_step(state, to_device(block,
                                                    torch.device("cuda")))
            out.append(float(m["loss"]))
        return out

    ds = get_dataset(build("")[0].config.data)
    batches = [next(ds) for _ in range(COLL_STEPS)]
    f32 = steps(*build(""), batches)
    builder, straight = build("int8")
    q8 = steps(builder, straight, batches)
    builder, legs = build("int8")
    steps(builder, legs, batches[:COLL_SPLIT])
    manager = CheckpointManager(dataclasses.replace(
        builder.config.checkpoint, directory=os.path.join(
            out_dir, "coll_ckpt")), runtime=rt)
    manager.save(COLL_SPLIT, legs)
    builder, resumed = build("int8", seed=SEED + 1)
    restored = manager.restore(resumed)
    manager.close()
    tail = steps(builder, resumed, batches[COLL_SPLIT:])
    want = list(tensor_leaves(straight.state_dict()))
    got = list(tensor_leaves(resumed.state_dict()))
    return {"f32": f32, "int8": q8, "resumed_tail": tail,
            "restored": restored, "tensors": len(want),
            "equal": sum(torch.equal(a, b) for a, b in zip(got, want)),
            "residual_nonzero": any(
                bool(v.any()) for v in straight.collective_residual.values())}


def coll_rank(torch, out_dir: str) -> dict:
    """One rank of 10b: a gloo group (CUDA and CPU tensors) on the one
    card."""
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    runtime = initialize_runtime(MeshConfig(), "cuda", backend="gloo")
    try:
        t0 = time.perf_counter()
        functions = coll_functions(torch, runtime)
        t1 = time.perf_counter()
        lenet = coll_lenet(torch, runtime, out_dir)
        return {"backend": runtime.backend, "rank": runtime.process_index,
                "transport": {d: runtime.collective_transport(d)
                              for d in ("cuda", "cpu")},
                "functions": functions, "lenet": lenet,
                "s": {"functions": t1 - t0,
                      "lenet": time.perf_counter() - t1}}
    finally:
        runtime.shutdown()


def coll_world1_wave(workdir: str, full: dict, hold: bool = False) -> dict:
    """The child of :func:`coll_cli_runs`: ``cli.train.main`` at phase
    5's cut plus each of COLL_WORLD1's extra overrides, one after the
    other, each in a world of 1 (NCCL)."""
    argvs = []
    for name, extra in COLL_WORLD1.items():
        log_dir, ckpt = (os.path.join(workdir, f"{name}_logs"),
                         os.path.join(workdir, name))
        over = (*TRAIN_OVERRIDES, f"checkpoint.directory={ckpt}", *extra)
        argvs.append((["--config", full["config"], "--device", "cuda",
                       "--log-dir", log_dir,
                       *sum((["--set", o] for o in over), [])], False))
    return spawn_children([cli_runs(*argvs)], workdir, "coll_world1",
                          hold=hold)


def coll_cli_runs(workdir: str, full: dict, wave=None) -> dict:
    """The runs of :func:`coll_world1_wave` (``wave``, started held
    earlier, or started here): {name: (result, events, checkpoint
    directory)}."""
    dirs = {name: (os.path.join(workdir, f"{name}_logs"),
                   os.path.join(workdir, name)) for name in COLL_WORLD1}
    (results,) = join_children(wave or coll_world1_wave(workdir, full))
    out = {}
    for (name, (log_dir, ckpt)), res in zip(dirs.items(), results):
        if res["rc"] != 0:
            raise AssertionError(f"{name}: cli.train.main returned "
                                 f"{res['rc']}")
        out[name] = (res, read_events(log_dir), ckpt)
    return out


def collectives_phase(torch, workdir: str, full: dict, ms_8a: float,
                      smi: str, world1=None) -> dict:
    """Phase 10: 10a/10a' (BERT-base at world 1 over NCCL under shard_map,
    int8 and no wire; ``world1``: their child, started held earlier) and
    10b (two gloo ranks on the card). Returns the attention kernels'
    launches of 10a and 10a' (main-path runs)."""
    t0 = time.perf_counter()
    # 10b's ranks start up while 10a and 10a' run.
    coll_ranks = spawn_children([{"kind": "coll", "env": gang_env(port, 2, r),
                                  "deterministic": True}
                                 for port in [free_port()] for r in range(2)],
                                workdir, "coll_ranks", hold=True)
    # 10a: the int8 error-feedback wire at full width; 10a': shard_map with
    # no wire, bit-equal to phase 5's first steps. One child runs both.
    world1 = coll_cli_runs(workdir, full, wave=world1)
    res, events, ckpt = world1["coll_int8"]
    meta = next(e for e in events if e["kind"] == "run_meta")["extra"]
    train = [e for e in events if e["kind"] == "train_step"]
    losses = {e["step"]: e["metrics"]["loss"] for e in train}
    tally = train[-1]["collectives"]
    ms = steady_ms(events)
    state = torch.load(os.path.join(ckpt, "30", "state.pt"),
                       map_location="cpu", weights_only=True, mmap=True)
    rows = state["collective_residual"]
    n_params = sum(v[0].numel() for v in rows.values())
    log(f"10a bert-base int8 shard_map world 1: group "
        f"{meta['process_group']}, spmd_mode {meta['spmd_mode']}, wire "
        f"{meta['collective_dtype']!r} block {meta['collective_block_size']}"
        f", error feedback {meta['error_feedback']}, transport "
        f"{meta['collective_transport']}, ddp {meta['ddp']}; losses "
        + ", ".join(f"step {k} {v!r} (phase 5 {full['losses'][k]!r}, gap "
                    f"{v - full['losses'][k]:+.3e})"
                    for k, v in sorted(losses.items()))
        + f" (tol rtol {COLL_LOSS_TOL['rtol']} atol {COLL_LOSS_TOL['atol']})"
        f"; kernel launches {res['counts']} [{smi}]")
    log(f"10a tally per step: wire {tally['total_bytes']} bytes, logical "
        f"{tally['total_logical_bytes']} "
        f"({tally['total_logical_bytes'] / tally['total_bytes']:.3f}x); "
        + ", ".join(f"{k} {v}" for k, v in tally.items()
                    if k.startswith("allreduce_grads")))
    rel = 100 * (ms / full["ms_per_step"] - 1)
    log(f"10a steady {ms:.2f} ms/step against phase 5's "
        f"{full['ms_per_step']:.2f} ({rel:+.2f}%) and 8a's {ms_8a:.2f}; "
        f"peak memory {res['peak_gb']:.2f} GB "
        f"(the residual: {n_params} parameters x 4 bytes = "
        f"{4 * n_params / 1e9:.3f} GB, saved as {len(rows)} rows of 1 rank) "
        f"[{smi}]")
    ok = (meta["process_group"] == "nccl" and meta["spmd_mode"] == "shard_map"
          and meta["collective_dtype"] == "int8" and meta["error_feedback"]
          and meta["collective_transport"] == "native" and not meta["ddp"])
    if not ok:
        raise AssertionError(f"10a: run_meta {meta}")
    if ("allreduce_grads_q8_scatter_bytes" not in tally
            or "allreduce_grads_q8_gather_bytes" not in tally
            or tally["total_bytes"] * 3 > tally["total_logical_bytes"]):
        raise AssertionError(f"10a: the tally shows no 3x compression: "
                             f"{tally}")
    steps = sorted(losses)
    if (steps != sorted(full["losses"])
            or not all(math.isfinite(v) for v in losses.values())
            or not losses[steps[-1]] < losses[steps[0]]
            or any(abs(losses[k] - full["losses"][k]) > COLL_LOSS_TOL["atol"]
                   + COLL_LOSS_TOL["rtol"] * abs(full["losses"][k])
                   for k in steps)):
        raise AssertionError("10a: the int8 losses are not finite, falling "
                             "and within the tolerance of phase 5's")
    if res["counts"] != full["want"]:
        raise AssertionError(f"10a: launches {res['counts']}, phase 5 "
                             f"{full['want']}")
    counts = dict(res["counts"])
    # Where the codec's time goes: the same step in this process (no
    # group, so the collectives are the codec alone), profiled.
    from distributed_tensorflow_framework_torch.core.config import load_config

    train_breakdown(torch, load_config(full["config"], overrides=[
        *TRAIN_OVERRIDES, *COLL_OVERRIDES]))
    torch.cuda.empty_cache()
    # 10a'.
    res, events, _ = world1["coll_plain"]
    meta = next(e for e in events if e["kind"] == "run_meta")["extra"]
    train = [e for e in events if e["kind"] == "train_step"]
    losses = {e["step"]: e["metrics"]["loss"] for e in train}
    tally = train[-1]["collectives"]
    want_losses = {k: v for k, v in full["losses"].items()
                   if k <= COLL_PLAIN_STEPS}
    layers = 12
    want = {"fwd": layers * (COLL_PLAIN_STEPS + 2),
            "dq": layers * COLL_PLAIN_STEPS, "dkv": layers * COLL_PLAIN_STEPS,
            "fused": 0}
    log(f"10a' bert-base shard_map, no wire, world 1: group "
        f"{meta['process_group']}, transport {meta['collective_transport']};"
        f" losses " + ", ".join(f"step {k} {v!r} (phase 5 "
                               f"{full['losses'][k]!r})"
                               for k, v in sorted(losses.items()))
        + f"; tally {tally}; kernel launches {res['counts']} (expected "
        f"{want})")
    if (losses != want_losses or res["counts"] != want
            or "allreduce_grads_pmean_bytes" not in tally):
        raise AssertionError("10a': the shard_map run without a wire "
                             "differs from phase 5")
    counts = {k: counts[k] + res["counts"][k] for k in counts}
    # 10b: two gloo ranks on the one card.
    torch.cuda.empty_cache()
    ranks = join_children(coll_ranks)
    for r in ranks:
        if r["backend"] != "gloo" or r["transport"] != {
                "cuda": "all_reduce", "cpu": "native"}:
            raise AssertionError(f"10b: rank {r['rank']}: backend "
                                 f"{r['backend']}, transport {r['transport']}")
    bad = []
    for name in ranks[0]["functions"]:
        per = [r["functions"][name] for r in ranks]
        missing = {p["cpu_missing"] for p in per} - {None}
        log(f"10b {name}: CUDA (all_reduce transport) vs CPU ("
            + (f"MISSING native op: {missing}; the all_reduce transport on "
               f"CPU tensors" if missing else "gloo native ops")
            + f"): equal {[p['equal'] for p in per]}, max |diff| "
            f"{max(p['max_abs_diff'] for p in per):.3e}, tallies equal "
            f"{[p['tally_equal'] for p in per]}, "
            f"{max(p['s'] for p in per):.2f} s")
        if not all(p["equal"] and p["tally_equal"] for p in per):
            bad.append(name)
    lenet = [r["lenet"] for r in ranks]
    f32, q8 = lenet[0]["f32"], lenet[0]["int8"]
    gap = max(abs(a - b) - COLL_LOSS_TOL["rtol"] * abs(b)
              for a, b in zip(q8, f32))
    log(f"10b lenet 2 x 64 shard_map, {COLL_STEPS} steps: f32 losses "
        f"{[round(v, 6) for v in f32]}; int8 error feedback "
        f"{[round(v, 6) for v in q8]} (worst |gap| - rtol|f32| {gap:.3e}, "
        f"tol atol {COLL_LOSS_TOL['atol']})")
    log(f"10b lenet int8 resume (deterministic algorithms): restored step "
        + ", ".join(f"rank {i} {x['restored']}: {x['equal']} of "
                    f"{x['tensors']} tensors bit-equal to {COLL_STEPS} "
                    f"straight steps, losses after the restore equal "
                    f"{x['resumed_tail'] == x['int8'][COLL_SPLIT:]}"
                    for i, x in enumerate(lenet))
        + "; seconds " + ", ".join(
            f"rank {r['rank']} functions {r['s']['functions']:.2f} lenet "
            f"{r['s']['lenet']:.2f}" for r in ranks))
    if bad:
        raise AssertionError(f"10b: CUDA and CPU differ in {bad}")
    if (gap > COLL_LOSS_TOL["atol"] or not all(map(math.isfinite, q8))
            or lenet[0]["int8"] != lenet[1]["int8"]):
        raise AssertionError("10b: the int8 LeNet run misses the f32 run")
    if not all(x["restored"] == COLL_SPLIT and x["equal"] == x["tensors"]
               and x["residual_nonzero"]
               and x["resumed_tail"] == x["int8"][COLL_SPLIT:]
               for x in lenet):
        raise AssertionError("10b: the resumed int8 run differs from the "
                             "straight one")
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    return counts


# --------------------------------------------------------------- phase 11

# 11a: configs/bert_base_mlm.yaml at its full width (bf16, fused QKV, the
# flash kernels, dropout 0.1), its depth cut to ZERO_LAYERS (12 until PR
# 16, the script's time limit), on two gloo ranks of the
# one card, through the Trainer, each rank taking 16 of the global batch's
# 32 rows of 512 tokens (the synthetic stream), ZERO_STEPS steps (cut from
# 10 in PR 16, to keep the script inside its time limit), in three modes:
# (i) the replicated shard_map step (phase 10's path at two ranks), (ii)
# ZeRO on the f32 wire, (iii) ZeRO on the int8 error-feedback wire. Every
# run of the phase takes optimizer.grad_clip_norm=0, so that each mode can
# run the same config: ZeRO and explicit FSDP refuse clipping (their update
# sees only shards). The ladder is off and the eval skipped; the final save
# at the last step holds the parameters held here. gloo moves CUDA tensors
# through the host, so the ms/step says nothing about scaling.
ZERO_CONFIG = "configs/bert_base_mlm.yaml"
ZERO_STEPS = 4
# 11a's depth, cut from 12 layers (the script's time limit).
ZERO_LAYERS = 2
ZERO_OVERRIDES = ("data.global_batch_size=32",
                  f"model.num_layers={ZERO_LAYERS}",
                  f"train.total_steps={ZERO_STEPS}",
                  f"train.log_interval={ZERO_STEPS // 2}",
                  "train.eval_steps=0",
                  "train.eval_interval=0", "optimizer.grad_clip_norm=0",
                  "resilience.rollback=false", "train.spmd_mode=shard_map")
ZERO_MODES = {
    "replicated": (),
    "zero_f32": ("optimizer.zero_sharding=shard_map",),
    "zero_int8": ("optimizer.zero_sharding=shard_map",
                  "parallel.collective_dtype=int8")}
# (ii) against (i): the same parameters and losses bit for bit are
# expected at two ranks (the update is elementwise, the shards are cut
# from the same reduced gradients). Written before the first run, should
# they differ: the losses within 1e-6 relative and the parameters within
# the largest learning rate of the run times the steps (an AdamW step
# moves a cell by about lr at most).
ZERO_LOSS_RTOL = 1e-6
# 11b: 8c's cut (2 layers, full width, f32, dropout 0, 2 x (4 x 512), no
# warmup) with clipping off, DP_STEPS steps under deterministic
# algorithms: explicit FSDP (shard_map, mesh.fsdp=2) against the
# replicated shard_map step, jit FSDP (mesh.fsdp=2) and ZeRO-1
# (optimizer.zero_sharding=jit, mesh.fsdp=2) against DDP at mesh.data=2;
# each pair bit for bit (exact gathers, elementwise updates on the parts).
ZERO_CUT = (*DP_BERT[1], "optimizer.grad_clip_norm=0")
FSDP2 = ("mesh.data=1", "mesh.fsdp=2")
ZERO_CUT_MODES = {
    "replicated": ("train.spmd_mode=shard_map",),
    "fsdp_explicit": ("train.spmd_mode=shard_map", *FSDP2),
    "ddp": (),
    "fsdp_jit": FSDP2,
    "zero1": (*FSDP2, "optimizer.zero_sharding=jit")}
ZERO_CUT_PAIRS = (("fsdp_explicit", "replicated"), ("fsdp_jit", "ddp"),
                  ("zero1", "ddp"))
# 11c: ZeRO on the int8 wire at that cut, 4 steps straight against 2, a
# save by the chief, a restore into a state built from another seed and 2
# more (deterministic algorithms): every tensor bit-equal.
ZERO_RESUME = ("train.spmd_mode=shard_map", "optimizer.zero_sharding=shard_map",
               "parallel.collective_dtype=int8", "checkpoint.async_save=false")
ZERO_RESUME_STEPS, ZERO_RESUME_SPLIT = 4, 2


def state_bytes(torch, state) -> dict:
    """This rank's bytes at rest: the model's parameters (FSDP's parts
    under FSDP), the optimizer slots (ZeRO's and ZeRO-1's parts), the
    error-feedback residual."""
    slots = [t for s in slot_tensors(torch, state).values()
             for t in s.values()]
    return {"params": sum(p.numel() * p.element_size()
                          for p in state.model.parameters()),
            "slots": sum(t.numel() * t.element_size() for t in slots),
            "residual": sum(t.numel() * t.element_size() for t in
                            state.collective_residual.values())}


def zero_rank(torch, fa, out_dir: str) -> dict:
    """One rank of phase 11, a gloo group on the card: 11a
    (:func:`zero_trainer_rank`), then 11b and 11c under deterministic
    algorithms (:func:`zero_parity_rank`)."""
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    runtime = initialize_runtime(MeshConfig(), "cuda", backend="gloo")
    try:
        t0 = time.perf_counter()
        out = zero_trainer_rank(torch, fa, runtime, out_dir)
        out["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        with deterministic(torch):
            out["parity"] = zero_parity_rank(torch, runtime, out_dir)
        return out
    finally:
        runtime.shutdown()


def zero_trainer_rank(torch, fa, runtime, out_dir: str) -> dict:
    """11a on one rank: the three modes in turn through the Trainer, each
    with the launch counts set to 0 just before and read just after, its
    peak memory and its bytes at rest."""
    import gc

    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    out = {"rank": runtime.process_index, "backend": runtime.backend,
           "modes": {}}
    for name, extra in ZERO_MODES.items():
        ckpt = os.path.join(out_dir, f"zero_{name}")
        cfg = load_config(ZERO_CONFIG, overrides=[
            *ZERO_OVERRIDES, *extra, f"checkpoint.directory={ckpt}"])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa)
        trainer = Trainer(cfg, log_dir=ckpt + "_logs", runtime=runtime)
        t0 = time.perf_counter()
        try:
            trainer.train()
        finally:
            if trainer._ckpt_manager is not None:
                trainer._ckpt_manager.close()
            trainer.writer.close()
        out["modes"][name] = {
            "counts": read_counts(fa), "s": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "bytes": state_bytes(torch, trainer.state),
            "ckpt": ckpt, "logs": ckpt + "_logs"}
        del trainer
    return out


def zero_cut_case(torch, overrides, runtime, steps: int,
                  seed: int = SEED, state=None, builder=None,
                  skip: int = 0, config_path: str = ZERO_CONFIG) -> dict:
    """``steps`` steps of 11b's cut (or ``state`` onward, after ``skip``
    batches; of ``config_path`` with ``overrides``) on this rank's blocks
    of the global batches (the ranks along ``seq`` take the same block and
    split its rows): the losses, the whole tensors after them, the bytes
    at rest."""
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.parallel.sharding import (
        DimSharding,
    )
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    cfg = load_config(config_path, overrides=list(overrides))
    if builder is None:
        builder = StepBuilder(cfg, device="cuda", runtime=runtime)
        state = builder.init_state(seed)
    ds = get_dataset(cfg.data)
    # Each data-parallel rank takes its block; the ranks along mesh.model
    # take the same one. The step builder's runtime: a runtime formed for
    # another mesh is re-formed for this one.
    dp = (1, 0) if runtime is None else (builder.data_group.size,
                                         builder.data_group.index)
    b = cfg.data.global_batch_size // dp[0]
    r = dp[1]
    losses, grad_norms = [], []
    for i in range(skip + steps):
        batch = next(ds)
        if i < skip:
            continue
        block = {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
        m = builder.global_metrics(builder.train_step(
            state, to_device(block, builder.device)))
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
    whole = contextlib.nullcontext()
    if isinstance(state.layout, DimSharding):
        whole = state.layout.whole_params(state.model)
    with whole:
        tensors = state.model.state_dict()
        # The inverse of the cuts' order (tensor, then expert).
        if state.ep is not None:
            tensors = state.ep.whole(tensors)  # every rank of the line
        if state.tp is not None:
            tensors = state.tp.whole(tensors)  # every rank of the group
        if state.pipe is not None:
            tensors = state.pipe.whole(tensors)  # every stage of the line
        tensors = {k: v.detach().cpu().clone() for k, v in tensors.items()}
    return {"losses": losses, "grad_norms": grad_norms, "tensors": tensors,
            "bytes": state_bytes(torch, state), "builder": builder,
            "state": state}


def zero_resume(torch, runtime, out_dir: str) -> dict:
    """11c on one rank: ZeRO on the int8 wire, straight and around a save
    and a restore."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    over = (*ZERO_CUT, *ZERO_RESUME)
    straight = zero_cut_case(torch, over, runtime, ZERO_RESUME_STEPS)
    legs = zero_cut_case(torch, over, runtime, ZERO_RESUME_SPLIT)
    manager = CheckpointManager(dataclasses.replace(
        legs["builder"].config.checkpoint,
        directory=os.path.join(out_dir, "zero_resume")), runtime=runtime)
    manager.save(ZERO_RESUME_SPLIT, legs["state"])
    fresh = zero_cut_case(torch, over, runtime, 0, seed=SEED + 1)
    restored = manager.restore(fresh["state"])
    manager.close()
    tail = zero_cut_case(
        torch, over, runtime, ZERO_RESUME_STEPS - ZERO_RESUME_SPLIT,
        state=fresh["state"], builder=fresh["builder"],
        skip=ZERO_RESUME_SPLIT)
    a, b = straight["state"], tail["state"]
    want, got = (list(tensor_leaves(x.state_dict())) for x in (a, b))
    return {"restored": restored,
            "losses_equal": tail["losses"] == straight["losses"][
                ZERO_RESUME_SPLIT:],
            "tensors": len(want),
            "equal": sum(torch.equal(x, y) for x, y in zip(got, want)),
            "residual_nonzero": any(bool(v.any()) for v in
                                    a.collective_residual.values())}


def zero_parity_rank(torch, runtime, out_dir: str) -> dict:
    """11b and 11c on one rank."""
    out = {"rank": runtime.process_index, "modes": {}}
    t0 = time.perf_counter()
    for name, extra in ZERO_CUT_MODES.items():
        res = zero_cut_case(torch, (*ZERO_CUT, *extra), runtime,
                            DP_STEPS)
        path = os.path.join(
            out_dir, f"zero_cut_{name}_rank{runtime.process_index}.pt")
        torch.save(res["tensors"], path)
        out["modes"][name] = {"losses": res["losses"],
                              "bytes": res["bytes"], "tensors": path}
        del res
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["resume"] = zero_resume(torch, runtime, out_dir)
    out["s"] = {"11b": t1 - t0, "11c": time.perf_counter() - t1}
    return out


def gb(nbytes: float) -> str:
    return f"{nbytes / 1e9:.3f} GB"


def zero_wave(workdir: str, hold: bool = False) -> dict:
    """Phase 11's two ranks."""
    return spawn_children([{"kind": "zero", "env": gang_env(port, 2, r)}
                           for port in [free_port()] for r in range(2)],
                          workdir, "zero_ranks", hold=hold)


def zero_phase(torch, workdir: str, smi: str, wave=None) -> dict:
    """Phase 11 on two gloo ranks (``wave``, when started held earlier):
    11a (BERT-base, the Trainer: replicated, ZeRO f32, ZeRO int8), then
    11b/11c (FSDP and ZeRO-1 at 8c's cut, a ZeRO resume) in the same
    children. Returns 11a's attention-kernel launches, both ranks and the
    three modes (main-path runs)."""
    t0 = time.perf_counter()
    ranks = join_children(wave or zero_wave(workdir), timeout=900)
    if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
        raise AssertionError(f"11a: backends {ranks}")
    runs = {}
    for name in ZERO_MODES:
        mode = ranks[0]["modes"][name]
        events = read_events(mode["logs"])
        train = [e for e in events if e["kind"] == "train_step"]
        runs[name] = {
            "meta": next(e for e in events if e["kind"] == "run_meta")[
                "extra"],
            "losses": {e["step"]: e["metrics"]["loss"] for e in train},
            "lrs": [e["metrics"]["learning_rate"] for e in train],
            "tally": train[-1]["collectives"], "ms": steady_ms(events),
            "zero_update": next((e["extra"] for e in events
                                 if e["kind"] == "zero_update"), None),
            "state": torch.load(os.path.join(mode["ckpt"], str(ZERO_STEPS),
                                             "state.pt"), map_location="cpu",
                                weights_only=True, mmap=True)}
        per_rank = "; ".join(
            f"rank {r['rank']}: parameters {gb(r['modes'][name]['bytes']['params'])}"
            f", slots {gb(r['modes'][name]['bytes']['slots'])}, residual "
            f"{gb(r['modes'][name]['bytes']['residual'])}, peak "
            f"{r['modes'][name]['peak_gb']:.2f} GB, launches "
            f"{r['modes'][name]['counts']}" for r in ranks)
        meta = runs[name]["meta"]
        log(f"11a bert-base {name}, 2 gloo ranks on the card, {ZERO_STEPS} "
            f"steps of 32x512: zero_sharding {meta['zero_sharding']}, wire "
            f"{meta['collective_dtype']!r}, transport "
            f"{meta['collective_transport']}, buckets "
            f"{meta['zero_buckets']}; losses "
            + ", ".join(f"step {k} {v!r}" for k, v in
                        sorted(runs[name]["losses"].items()))
            + f"; {runs[name]['ms']:.1f} ms/step (steps "
            f"{ZERO_STEPS // 2 + 1}-{ZERO_STEPS}; gloo through "
            f"the host, not a scaling figure); {per_rank} [{smi}]")
    rep, z32, z8 = (runs[k] for k in ZERO_MODES)
    log(f"11a zero_update event (f32): {z32['zero_update']}; tally per step "
        f"f32: " + ", ".join(f"{k} {v}" for k, v in z32["tally"].items()
                             if k.startswith("zero_"))
        + "; int8: " + ", ".join(f"{k} {v}" for k, v in z8["tally"].items()
                                 if k.startswith("zero_")))
    # (ii) against (i): the parameters of the step-10 checkpoints.
    a, b = rep["state"]["model"], z32["state"]["model"]
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    worst = max(((a[k].float() - b[k].float()).abs().max().item(), k)
                for k in a)
    param_atol = max(rep["lrs"]) * ZERO_STEPS
    log(f"11a (ii) ZeRO f32 vs (i) replicated: losses equal "
        f"{z32['losses'] == rep['losses']}; {len(a) - len(differ)} of "
        f"{len(a)} parameter tensors bit-equal"
        + (f", first differing {differ[0]}, worst |diff| {worst[0]:.3e} "
           f"({worst[1]}; tol {param_atol:.3e})" if differ else ""))
    if differ or z32["losses"] != rep["losses"]:
        if (worst[0] > param_atol or any(
                abs(z32["losses"][k] - v) > ZERO_LOSS_RTOL * abs(v)
                for k, v in rep["losses"].items())):
            raise AssertionError("11a: ZeRO f32 differs from the replicated "
                                 "step beyond the tolerance")
    slots = z32["state"]["optimizer"]["inner"]["state"]
    stacked = all(t.dim() == 2 and t.shape[0] == 2 for s in slots.values()
                  for t in s.values() if t.dim())
    gap = max(abs(z8["losses"][k] - v) - COLL_LOSS_TOL["rtol"] * abs(v)
              for k, v in z32["losses"].items())
    raw = max(abs(z8["losses"][k] - v) for k, v in z32["losses"].items())
    ratio = {k: z32["tally"][f"zero_{k}_bytes"] / z8["tally"][
        f"zero_{k}_bytes"] for k in ("reduce_scatter", "all_gather")}
    log(f"11a (iii) int8 vs (ii) f32: largest |gap| {raw:.3e}, worst "
        f"|gap| - rtol|f32| {gap:.3e} "
        f"(tol atol {COLL_LOSS_TOL['atol']}); zero_* wire bytes f32/int8 "
        f"{ratio}; checkpoint slots stacked (2, chunk): {stacked}")
    if (gap > COLL_LOSS_TOL["atol"] or min(ratio.values()) < 3
            or not stacked
            or set(rep["losses"]) != {ZERO_STEPS // 2, ZERO_STEPS}
            or not all(math.isfinite(v) for v in z8["losses"].values())):
        raise AssertionError("11a: the int8 run, the tally or the stacked "
                             "slots miss their checks")
    halves = {}
    for r in ranks:
        m = r["modes"]
        halves[r["rank"]] = (m["zero_f32"]["bytes"]["slots"]
                             / m["replicated"]["bytes"]["slots"])
    log(f"11a slots per rank, ZeRO over replicated: "
        + ", ".join(f"rank {k} {v:.4f}" for k, v in halves.items()))
    if any(not 0.49 < v <= 0.5 + 1e-3 for v in halves.values()):
        raise AssertionError("11a: ZeRO did not halve the slots per rank")
    want = {"fwd": ZERO_LAYERS * ZERO_STEPS, "dq": ZERO_LAYERS * ZERO_STEPS,
            "dkv": ZERO_LAYERS * ZERO_STEPS, "fused": 0}
    counts = {k: 0 for k in want}
    for r in ranks:
        for name in ZERO_MODES:
            got = r["modes"][name]["counts"]
            if got != want:
                raise AssertionError(f"11a: rank {r['rank']} {name} "
                                     f"launches {got}, expected {want}")
            counts = {k: counts[k] + got[k] for k in counts}
    # 11b and 11c.
    parity = [r["parity"] for r in ranks]
    bad = []
    for r in parity:
        modes = r["modes"]
        for got, ref in ZERO_CUT_PAIRS:
            x = torch.load(modes[got]["tensors"], weights_only=True)
            y = torch.load(modes[ref]["tensors"], weights_only=True)
            equal = sum(torch.equal(x[k], y[k]) for k in y)
            same = modes[got]["losses"] == modes[ref]["losses"]
            log(f"11b rank {r['rank']} {got} vs {ref} ({DP_STEPS} steps, "
                f"2 layers, f32): losses equal {same}, {equal} of {len(y)} "
                f"tensors bit-equal; parameters at rest "
                f"{gb(modes[got]['bytes']['params'])} against "
                f"{gb(modes[ref]['bytes']['params'])}, slots "
                f"{gb(modes[got]['bytes']['slots'])} against "
                f"{gb(modes[ref]['bytes']['slots'])}")
            if not same or equal != len(y):
                bad.append((r["rank"], got))
        rb = modes
        if not (rb["fsdp_explicit"]["bytes"]["params"]
                < 0.51 * rb["replicated"]["bytes"]["params"]
                and rb["fsdp_jit"]["bytes"]["params"]
                < 0.51 * rb["ddp"]["bytes"]["params"]
                and rb["zero1"]["bytes"]["slots"]
                < 0.51 * rb["ddp"]["bytes"]["slots"]):
            bad.append((r["rank"], "bytes at rest"))
        res = r["resume"]
        log(f"11c rank {r['rank']} ZeRO int8 resume (deterministic "
            f"algorithms): restored step {res['restored']}; losses after the "
            f"restore equal {res['losses_equal']}; {res['equal']} of "
            f"{res['tensors']} tensors (parameters, slots, residual) "
            f"bit-equal to {ZERO_RESUME_STEPS} straight steps; 11b "
            f"{r['s']['11b']:.1f} s, 11c {r['s']['11c']:.1f} s")
        if not (res["restored"] == ZERO_RESUME_SPLIT and res["losses_equal"]
                and res["equal"] == res["tensors"]
                and res["residual_nonzero"]):
            bad.append((r["rank"], "resume"))
    if bad:
        raise AssertionError(f"11b/11c: {bad}")
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s (11a "
        f"{max(r['s'] for r in ranks):.1f} s in the children)")
    return counts

# --------------------------------------------------------------- phase 12

# Phase 12: tensor parallelism (mesh.model=2; parallel/tensor_parallel.py)
# on two gloo ranks of the one card at {data: 1, model: 2}, so both ranks
# take the same rows. 12a: configs/bert_base_mlm.yaml as written (12
# layers, bf16, the flash kernels, fused QKV, dropout 0.1, clipping 1.0)
# through the Trainer, TP_STEPS steps of 16 x 512 (the synthetic stream).
# gloo moves CUDA tensors through the host, so the ms/step says nothing
# about scaling.
TP_CONFIG = "configs/bert_base_mlm.yaml"
TP_MESH = ("mesh.data=1", "mesh.model=2")
TP_STEPS = 3  # cut from 10, to keep the script inside its time limit
TP_LAYERS = 2  # cut from 12, for the same reason
TP_OVERRIDES = ("data.global_batch_size=16", f"model.num_layers={TP_LAYERS}",
                f"train.total_steps={TP_STEPS}",
                "train.log_interval=1", "train.eval_steps=0",
                "train.eval_interval=0", "resilience.rollback=false",
                "checkpoint.directory=")
# 12b: 12a at dropout 0 (TP_STEPS steps of the StepBuilder) against one
# process without TP on the same batches. In bf16 a row-parallel output is
# the sum of two bf16-rounded partials, rounded again, where one process
# rounds one product; at the config's warmup the parameters barely move
# in 10 steps, so the losses differ by the forward's rounding. Written
# before the first run: the losses within 2e-3 and grad_norm within 2e-2,
# relative, at every step.
TP_LOSS_TOL = {"loss": 2e-3, "grad_norm": 2e-2}
# 12c: 8c's cut (2 layers, full width, f32, dropout 0, 8 rows, no warmup,
# clipping 1.0) under deterministic algorithms. TP against one process
# over DP_STEPS steps: the row-parallel sums reorder f32 additions, so
# bit-equality is not expected. Written before the first run, as DP_TOL
# holds two data-parallel ranks: losses within 1e-5 and grad_norm within
# 1e-4, relative; the parameters within 5e-2 x lr (AdamW divides a
# gradient by its root mean square, so a gradient that is zero in exact
# arithmetic moves by its noise).
TP_F32_RTOL = {"loss": 1e-5, "grad_norm": 1e-4, "params": 5e-2}
TP_CUT = DP_BERT[1]
TP_RESUME = ("checkpoint.async_save=false",)
TP_RESUME_STEPS, TP_RESUME_SPLIT = 4, 2


class StepRecord:
    """A trainer hook that keeps the loss and grad_norm of every logged
    step, and the host clock at the start and at each step's end."""

    def __init__(self):
        self.steps, self.ends = {}, []

    def on_start(self, trainer) -> None:
        self.ends = [time.perf_counter()]

    def after_step(self, trainer, step, metrics) -> None:
        self.ends.append(time.perf_counter())
        if metrics is not None:
            self.steps[step] = {"loss": metrics["loss"],
                                "grad_norm": metrics["grad_norm"]}

    def on_end(self, trainer) -> None:
        pass


def heads_seen(fn, seen: set):
    """``fn`` (an attention function), noting the head count of each
    call's q in ``seen``."""
    def wrapped(q, k, v, **kwargs):
        seen.add(int(q.shape[2]))
        return fn(q, k, v, **kwargs)
    return wrapped


def tp_trainer_run(torch, fa, runtime, out_dir: str) -> dict:
    """12a on one rank: the Trainer with the launch counts set to 0 just
    before and read just after, the heads each attention call saw, the
    replicated leaves after the last step, the parts' shapes, the bytes
    at rest and the peak memory."""
    import gc

    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.models.bert import (
        MultiHeadAttention,
    )
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    logs = os.path.join(out_dir, "tp_logs")
    cfg = load_config(TP_CONFIG, overrides=[*TP_OVERRIDES, *TP_MESH])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, log_dir=logs, runtime=runtime)
    trainer.build()
    heads = set()
    for module in trainer.state.model.modules():
        if isinstance(module, MultiHeadAttention):
            module.attention_fn = heads_seen(module.attention_fn, heads)
    record = StepRecord()
    reset_counts(fa)
    t0 = time.perf_counter()
    try:
        trainer.train(hooks=trainer.default_hooks() + [record])
    finally:
        trainer.writer.close()
    counts = read_counts(fa)
    seconds = time.perf_counter() - t0
    state = trainer.state
    named = dict(state.model.named_parameters())
    path = os.path.join(out_dir,
                        f"tp_replicated_rank{runtime.process_index}.pt")
    torch.save({k: p.detach().cpu() for k, p in named.items()
                if state.tp.leaves[k] is None}, path)
    return {"counts": counts, "heads": sorted(heads), "steps": record.steps,
            "s": seconds, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "bytes": state_bytes(torch, state), "replicated": path,
            "parts": {k: [list(named[k].shape), list(leaf.part_shape)]
                      for k, leaf in state.tp.leaves.items()
                      if leaf is not None},
            "logs": logs}


def tp_rank(torch, fa, out_dir: str) -> dict:
    """One rank of phase 12: a gloo group on the card at {data: 1,
    model: 2}; 12a, the TP legs of 12b and 12c, and 12c's resume."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    runtime = initialize_runtime(MeshConfig(data=1, model=2), "cuda",
                                 backend="gloo")
    rank = runtime.process_index
    try:
        out = {"rank": rank, "backend": runtime.backend, "s": {}}
        t0 = time.perf_counter()
        out["12a"] = tp_trainer_run(torch, fa, runtime, out_dir)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        b = zero_cut_case(torch, (*TP_OVERRIDES, *TP_MESH,
                                  "model.dropout_rate=0.0"), runtime,
                          TP_STEPS)
        path = os.path.join(out_dir, f"tp_b_rank{rank}.pt")
        torch.save(b["tensors"], path)
        out["12b"] = {"losses": b["losses"], "grad_norms": b["grad_norms"],
                      "tensors": path}
        del b
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        torch.use_deterministic_algorithms(True)
        c = zero_cut_case(torch, (*TP_CUT, *TP_MESH), runtime, DP_STEPS)
        path = os.path.join(out_dir, f"tp_c_rank{rank}.pt")
        torch.save(c["tensors"], path)
        out["12c"] = {"losses": c["losses"], "grad_norms": c["grad_norms"],
                      "tensors": path}
        del c
        over = (*TP_CUT, *TP_MESH, *TP_RESUME)
        straight = zero_cut_case(torch, over, runtime, TP_RESUME_STEPS)
        legs = zero_cut_case(torch, over, runtime, TP_RESUME_SPLIT)
        ckpt = os.path.join(out_dir, "tp_resume")
        manager = CheckpointManager(dataclasses.replace(
            legs["builder"].config.checkpoint, directory=ckpt),
            runtime=runtime)
        manager.save(TP_RESUME_SPLIT, legs["state"])
        whole = os.path.join(out_dir, f"tp_saved_whole_rank{rank}.pt")
        torch.save(legs["tensors"], whole)
        fresh = zero_cut_case(torch, over, runtime, 0, seed=SEED + 1)
        restored = manager.restore(fresh["state"])
        manager.close()
        tail = zero_cut_case(
            torch, over, runtime, TP_RESUME_STEPS - TP_RESUME_SPLIT,
            state=fresh["state"], builder=fresh["builder"],
            skip=TP_RESUME_SPLIT)
        want, got = (list(tensor_leaves(x["state"].state_dict()))
                     for x in (straight, tail))
        out["resume"] = {
            "restored": restored, "ckpt": ckpt, "whole": whole,
            "losses_equal": tail["losses"] == straight["losses"][
                TP_RESUME_SPLIT:],
            "tensors": len(want),
            "equal": sum(torch.equal(x, y) for x, y in zip(got, want))}
        out["s"] = {"12a": t1 - t0, "12b": t2 - t1,
                    "12c": time.perf_counter() - t2}
        return out
    finally:
        torch.use_deterministic_algorithms(False)
        runtime.shutdown()


def worst_leaf(torch, got: dict, want: dict) -> tuple[float, str]:
    """The largest |got − want| over the leaves, and its leaf."""
    return max(((got[k].float() - v.float()).abs().max().item(), k)
               for k, v in want.items())


def tp_wave(workdir: str, hold: bool = False) -> dict:
    """Phase 12's two ranks."""
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}  # for 12c's determinism
    return spawn_children([{"kind": "tp", "env": {**gang_env(port, 2, r),
                                                  **env}}
                           for port in [free_port()] for r in range(2)],
                          workdir, "tp_ranks", hold=hold)


def tp_phase(torch, workdir: str, smi: str, wave=None) -> dict:
    """Phase 12: 12a (BERT-base through the Trainer, two gloo ranks at
    {data: 1, model: 2}), 12b (12a at dropout 0 against one process) and
    12c (8c's cut in f32 against one process, a resume, the checkpoint
    read by one process), on ``wave`` (started held earlier) or on ranks
    started here. Returns 12a's attention-kernel launches, both ranks
    (main-path runs)."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    t0 = time.perf_counter()
    ranks = join_children(wave or tp_wave(workdir), timeout=900)
    if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
        raise AssertionError(f"12a: backends {ranks}")
    bad = []
    # 12a.
    a0, a1 = (r["12a"] for r in ranks)
    events = read_events(a0["logs"])
    meta = next(e for e in events if e["kind"] == "run_meta")["extra"]
    ms = steady_ms(events)
    losses = {int(k): v["loss"] for k, v in a0["steps"].items()}
    same = a0["steps"] == a1["steps"]
    finite = (sorted(losses) == list(range(1, TP_STEPS + 1))
              and all(math.isfinite(v["loss"]) and math.isfinite(
                  v["grad_norm"]) for v in a0["steps"].values()))
    x, y = (torch.load(a["replicated"], weights_only=True) for a in (a0, a1))
    equal = sum(torch.equal(x[k], y[k]) for k in x)
    parts_ok = all(got == want for a in (a0, a1)
                   for got, want in a["parts"].values())
    log(f"12a bert-base, mesh {meta['mesh']}, {meta['tp_sharded_leaves']} "
        f"leaves split over model, 2 gloo ranks on the card, {TP_STEPS} "
        f"steps of 16x512 (dropout 0.1, clipping 1.0), both ranks on the "
        f"same rows: losses " + ", ".join(
            f"step {k} {v!r}" for k, v in sorted(losses.items()))
        + f"; losses and grad_norm equal on both ranks {same}, finite "
        f"{finite}; {equal} of {len(x)} replicated leaves bit-equal across "
        f"the ranks after step {TP_STEPS}; every split leaf at its part's "
        f"shape {parts_ok} [{smi}]")
    want = {"fwd": TP_LAYERS * TP_STEPS, "dq": TP_LAYERS * TP_STEPS,
            "dkv": TP_LAYERS * TP_STEPS, "fused": 0}
    counts = {k: 0 for k in want}
    for r in ranks:
        a = r["12a"]
        log(f"12a rank {r['rank']}: parameters {gb(a['bytes']['params'])}, "
            f"slots {gb(a['bytes']['slots'])} at rest, peak "
            f"{a['peak_gb']:.2f} GB, attention on {a['heads']} heads, "
            f"launches {a['counts']}; {ms:.1f} ms/step (steps 2-{TP_STEPS}, "
            f"chief's clock; gloo through the host, not a scaling figure); "
            f"12a {r['s']['12a']:.1f} s, 12b {r['s']['12b']:.1f} s, 12c "
            f"{r['s']['12c']:.1f} s [{smi}]")
        if a["counts"] != want or a["heads"] != [6]:
            bad.append((r["rank"], "12a launches or heads"))
        counts = {k: counts[k] + a["counts"][k] for k in counts}
    if not (same and finite and equal == len(x) and parts_ok):
        bad.append(("12a", same, finite, equal, parts_ok))
    # 12b: one process without TP on the same batches.
    torch.cuda.empty_cache()
    ref = zero_cut_case(torch, (*TP_OVERRIDES, "model.dropout_rate=0.0"),
                        None, TP_STEPS)
    whole = state_bytes(torch, ref["state"])
    for r in ranks:
        a = r["12a"]
        log(f"12a rank {r['rank']} at rest over one process's: parameters "
            f"{a['bytes']['params'] / whole['params']:.4f}, slots "
            f"{a['bytes']['slots'] / whole['slots']:.4f} (one process: "
            f"{gb(whole['params'])}, {gb(whole['slots'])})")
        if not (a["bytes"]["params"] < 0.52 * whole["params"]
                and a["bytes"]["slots"] < 0.52 * whole["slots"]):
            bad.append((r["rank"], "12a bytes at rest"))
    b = ranks[0]["12b"]
    gaps = {key: max(abs(g - w) / abs(w) for g, w in zip(b[name], ref[name]))
            for key, name in (("loss", "losses"),
                              ("grad_norm", "grad_norms"))}
    tensors = torch.load(b["tensors"], weights_only=True)
    diff, leaf = worst_leaf(torch, tensors, ref["tensors"])
    log(f"12b bert-base bf16 dropout 0, TP on 2 ranks vs one process, "
        f"{TP_STEPS} steps of 16x512: losses {b['losses']} vs "
        f"{ref['losses']}; grad_norm {b['grad_norms']} vs "
        f"{ref['grad_norms']}; largest relative gap loss "
        f"{gaps['loss']:.3e}, grad_norm {gaps['grad_norm']:.3e} (tol "
        f"{TP_LOSS_TOL}); the leaf that differs most at step {TP_STEPS}: "
        f"{leaf} ({diff:.3e})")
    if any(gaps[k] > TP_LOSS_TOL[k] for k in gaps) or \
            ranks[1]["12b"]["losses"] != b["losses"]:
        bad.append(("12b", gaps))
    del ref, tensors
    torch.cuda.empty_cache()
    # 12c: f32 against one process, the resume, the checkpoint read whole.
    ref = zero_cut_case(torch, TP_CUT, None, DP_STEPS)
    c = ranks[0]["12c"]
    lr = load_config(TP_CONFIG, overrides=list(TP_CUT)).optimizer.learning_rate
    gaps = {key: max(abs(g - w) / abs(w) for g, w in zip(c[name], ref[name]))
            for key, name in (("loss", "losses"),
                              ("grad_norm", "grad_norms"))}
    tensors = torch.load(c["tensors"], weights_only=True)
    diff, leaf = worst_leaf(torch, tensors, ref["tensors"])
    log(f"12c 2 layers f32, TP on 2 ranks vs one process, {DP_STEPS} "
        f"steps of 8x512: largest relative gap loss {gaps['loss']:.3e}, "
        f"grad_norm {gaps['grad_norm']:.3e}; worst parameter |diff| "
        f"{diff:.3e} = {diff / lr:.3e} x lr ({leaf}); tol {TP_F32_RTOL}")
    if (gaps["loss"] > TP_F32_RTOL["loss"]
            or gaps["grad_norm"] > TP_F32_RTOL["grad_norm"]
            or diff > TP_F32_RTOL["params"] * lr):
        bad.append(("12c parity", gaps, diff))
    for r in ranks:
        res = r["resume"]
        log(f"12c rank {r['rank']} TP resume (deterministic algorithms): "
            f"restored step {res['restored']}; losses after the restore "
            f"equal {res['losses_equal']}; {res['equal']} of "
            f"{res['tensors']} tensors (parameter and slot parts) bit-equal "
            f"to {TP_RESUME_STEPS} straight steps")
        if not (res["restored"] == TP_RESUME_SPLIT and res["losses_equal"]
                and res["equal"] == res["tensors"]):
            bad.append((r["rank"], "12c resume"))
    res = ranks[0]["resume"]
    cfg = load_config(TP_CONFIG, overrides=[*TP_CUT, *TP_RESUME])
    one = StepBuilder(cfg, device="cuda").init_state(SEED + 1)
    manager = CheckpointManager(dataclasses.replace(
        cfg.checkpoint, directory=res["ckpt"], allow_reshard=True))
    restored = manager.restore(one)
    manager.close()
    saved = torch.load(res["whole"], weights_only=True)
    loaded = {k: v.cpu() for k, v in one.model.state_dict().items()}
    equal = sum(torch.equal(loaded[k], v) for k, v in saved.items())
    log(f"12c the TP checkpoint read by one process: restored step "
        f"{restored}; {equal} of {len(saved)} model tensors bit-equal to "
        f"the parts gathered whole at the save")
    if restored != TP_RESUME_SPLIT or equal != len(saved):
        bad.append(("12c one-process restore", restored, equal))
    if bad:
        raise AssertionError(f"phase 12: {bad}")
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    return counts


# --------------------------------------------------------------- phase 13

# Phase 13: sequence parallelism with ring attention (mesh.seq,
# attention_impl: ring; parallel/ring.py). The card is one, so the ranks
# are gloo children on it, and every K/V rotation goes through the host:
# the ms/step says nothing about scaling.
# 13a: the kernels with an lse cotangent, where the ring's merge puts one:
# at each shape and dtype, q's segment ids from one chunk of a packed
# row and the keys' from the chunk before it (a document crosses the
# boundary, so most query rows see no key at all: lse ~ NEG_INF), a key
# bias that masks the chunk's last eighth, a random dO and a random dlse.
# The forward kernel against its plain version, then the pair (whole-K at
# 2048, streaming at 8192) and the fused kernel against the plain
# backward with phase 3b's tolerances.
RING_SHAPES = ((1, 12, 2048, 64), (1, 12, 8192, 64))
# 13b: configs/bert_long_ring.yaml as written (bf16, remat, dropout 0.1,
# ring attention at mesh.seq 8: 2048-token chunks), its depth cut to
# RING_LAYERS, through the Trainer on eight ranks, RING_STEPS steps of its
# 8 rows, one row per micro-batch as phase 6 takes them; no checkpoint
# directory (13d holds the checkpoints).
RING_RANKS = 8
RING_STEPS = 2
RING_OVERRIDES = ("train.grad_accum_steps=8", f"train.total_steps={RING_STEPS}",
                  "train.log_interval=1", "train.eval_steps=0",
                  "resilience.rollback=false", "checkpoint.directory=")
# 13b's depth, cut from the recipe's 12 layers (with RING_STEPS from 3)
# to keep the script inside its time limit: 13b took 93-164 s at full
# depth, the rotations through the host dominating it.
RING_LAYERS = ("model.num_layers=2",)
# 13c: 13b at {data: 1, seq: 2} (8192-token chunks: the forward kernel on
# the streaming lengths and, on a listed card, the fused backward) at
# dropout 0, against one process without the ring (phase 6's cut: seq 1,
# pallas) on the same batches; depth cut to 2 layers to keep the phase's
# time. Written before the first run: the ring rounds each chunk's o to
# bf16 before the f32 merge, where one process rounds one o, so the
# losses within 2e-3 and grad_norm within 2e-2, relative, as 12b holds
# tensor parallelism.
RING_PAIR = ("mesh.data=1", "mesh.seq=2", "model.num_layers=2",
             "model.dropout_rate=0.0")
RING_PAIR_ONE = ("mesh.seq=1", "model.attention_impl=pallas",
                 "model.num_layers=2", "model.dropout_rate=0.0")
# 13c's steps, cut from RING_STEPS (2) to keep the script inside its time
# limit beside phase 21.
RING_PAIR_STEPS = 1
RING_LOSS_TOL = {"loss": 2e-3, "grad_norm": 2e-2}
# 13d: four ranks at {data: 2, seq: 2}: configs/bert_base_mlm.yaml at 8c's
# cut (2 layers, full width, f32, dropout 0, 8 rows, clipping 1.0) with
# ring attention, packed 4:1 from a corpus of data/progression.py (the
# documents cross the 256-token chunks), under deterministic algorithms.
# Once with FLASH_CHUNK_MIN = 0 (the kernels take the chunks) and once at
# its default (the plain chain), each against one process with the same
# attention on the same batches, within DP_TOL's BERT tolerances (f32
# sums in other orders). Then 1 step, a save, a restore into a state from
# another seed and 2 more, bit-equal to the kernel route's own DP_STEPS
# steps (cut from 2 + 2 against 4 straight steps, for the script's time
# limit), and the checkpoint read by one process bit for bit.
RING_CORPUS = ("--seq-len", "512", "--train-seqs", "512", "--eval-seqs",
               "8", "--shards", "2", "--min-doc", "32", "--max-doc", "224",
               "--seed", str(SEED))
RING_F32 = (*DP_BERT[1], "model.attention_impl=ring",
            "checkpoint.async_save=false")
RING_F32_MESH = ("mesh.data=2", "mesh.seq=2")
RING_RESUME_STEPS, RING_RESUME_SPLIT = DP_STEPS, 1


def ring_kernel_parity(torch, fa) -> dict:
    """13a. Returns the worst absolute error of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "fused": 0.0}
    for b, h, s, d in RING_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, do = (torch.randn(b, s, h, d, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(4))
            dlse = torch.randn(b, s, h, 1, device="cuda", generator=gen)
            row = torch.zeros(b, 2 * s, device="cuda")
            row[:, s // 2:] = 1
            row[:, s + s // 4:] = 2
            q_seg, kv_seg = row[:, s:], row[:, :s]
            bias = torch.zeros(b, s, device="cuda")
            bias[:, s - s // 8:] = fa.NEG_INF
            plain = (fa.flash_attention_reference if s <= fa.MAX_SEQ_VMEM
                     else fa.flash_attention_kb_reference)
            o, lse = plain(q, k, v, bias, q_seg, kv_seg)
            ko, klse = fa.flash_attention_kernel(q, k, v, bias, q_seg,
                                                 kv_seg)
            torch.cuda.synchronize()
            empty = int((lse < fa.NEG_INF / 2).sum())
            o_rel = rel_err(ko, o)
            lse_err = ((klse - lse).abs()
                       / lse.abs().clamp(min=1.0)).max().item()
            ok = (bool(torch.isfinite(ko).all()) and o_rel <= O_RTOL[name]
                  and lse_err <= LSE_RTOL and empty > 0)
            worst["fwd"] = max(worst["fwd"],
                               (ko.float() - o.float()).abs().max().item())
            pair = "whole-K" if s <= fa.MAX_SEQ_VMEM else "streaming"
            what = f"13a {name} (B,H,S,D)=({b},{h},{s},{d})"
            log(f"{what} forward, q and kv segment ids from different "
                f"chunks ({empty} of {b * s * h} query rows see no key): o "
                f"{o_rel:.3e} of max|o| (tol {O_RTOL[name]}), lse rel err "
                f"{lse_err:.3e} (tol {LSE_RTOL}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{what}: forward kernel disagrees")
            args = (q, k, v, bias, q_seg, kv_seg, lse, do,
                    fa.attention_delta(o, do, dlse))
            check_bwd(torch, bwd_results(torch, fa, args), do, name,
                      f"dlse != 0 (max|dlse| "
                      f"{dlse.abs().max().item():.2f})",
                      f"{what} {pair} pair and fused backward", worst)
            del q, k, v, do, dlse, args, o, lse, ko, klse
            torch.cuda.empty_cache()
    return worst


def digest(torch, tensors: dict) -> str:
    """One sha256 over the tensors' bytes, in key order."""
    import hashlib

    h = hashlib.sha256()
    for key in sorted(tensors):
        t = tensors[key].detach().contiguous().cpu()
        h.update(key.encode())
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def ring_trainer_rank(torch, fa, runtime, out_dir: str) -> dict:
    """13b on one rank: the Trainer with the launch counts set to 0 just
    before and read just after, the step clock, the peak memory and a
    digest of the parameters after the last step."""
    import gc

    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    logs = os.path.join(out_dir, "ring_logs")
    cfg = load_config(LONG_CONFIG, overrides=[*RING_OVERRIDES, *RING_LAYERS])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, log_dir=logs, runtime=runtime)
    trainer.build()
    clock = StepRecord()
    reset_counts(fa)
    t0 = time.perf_counter()
    try:
        trainer.train(hooks=trainer.default_hooks() + [clock])
    finally:
        trainer.writer.close()
    counts = read_counts(fa)
    steps = [1e3 * (b - a) for a, b in zip(clock.ends, clock.ends[1:])]
    return {"counts": counts, "steps": clock.steps, "step_ms": steps,
            "s": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "digest": digest(torch, dict(trainer.state.model.named_parameters())),
            "seq": trainer.builder.seq_parallel,
            "transport": runtime.p2p_transport(trainer.device),
            "logs": logs}


def ring_f32_rank(torch, fa, runtime, out_dir: str, corpus: str) -> dict:
    """13d on one rank: both chunk routes at 8c's cut, then the resume."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.parallel import ring

    rank = runtime.process_index
    over = (*RING_F32, *RING_F32_MESH, f"data.data_dir={corpus}/train")
    out = {"routes": {}}
    default = ring.FLASH_CHUNK_MIN
    torch.use_deterministic_algorithms(True)
    try:
        for route, chunk_min in (("kernels", 0), ("plain", default)):
            ring.FLASH_CHUNK_MIN = chunk_min
            reset_counts(fa)
            res = zero_cut_case(torch, over, runtime, DP_STEPS,
                                config_path=DP_BERT[0])
            path = os.path.join(out_dir, f"ring_d_{route}_rank{rank}.pt")
            torch.save(res["tensors"], path)
            out["routes"][route] = {"losses": res["losses"],
                                    "grad_norms": res["grad_norms"],
                                    "counts": read_counts(fa),
                                    "segmented": read_segmented(fa),
                                    "tensors": path}
            if route == "kernels":
                straight = res  # the resume's straight steps
            del res
        ring.FLASH_CHUNK_MIN = 0
        kw = {"config_path": DP_BERT[0]}
        legs = zero_cut_case(torch, over, runtime, RING_RESUME_SPLIT, **kw)
        ckpt = os.path.join(out_dir, "ring_resume")
        manager = CheckpointManager(dataclasses.replace(
            legs["builder"].config.checkpoint, directory=ckpt),
            runtime=runtime)
        manager.save(RING_RESUME_SPLIT, legs["state"])
        whole = os.path.join(out_dir, f"ring_saved_rank{rank}.pt")
        torch.save(legs["tensors"], whole)
        fresh = zero_cut_case(torch, over, runtime, 0, seed=SEED + 1, **kw)
        restored = manager.restore(fresh["state"])
        manager.close()
        tail = zero_cut_case(
            torch, over, runtime, RING_RESUME_STEPS - RING_RESUME_SPLIT,
            state=fresh["state"], builder=fresh["builder"],
            skip=RING_RESUME_SPLIT, **kw)
        want, got = (list(tensor_leaves(x["state"].state_dict()))
                     for x in (straight, tail))
        out["resume"] = {
            "restored": restored, "ckpt": ckpt, "whole": whole,
            "losses_equal": tail["losses"] == straight["losses"][
                RING_RESUME_SPLIT:],
            "tensors": len(want),
            "equal": sum(torch.equal(x, y) for x, y in zip(got, want))}
        return out
    finally:
        ring.FLASH_CHUNK_MIN = default
        torch.use_deterministic_algorithms(False)


def ring_rank(torch, fa, spec: dict) -> dict:
    """One rank of phase 13: 13b (``part`` "b"), 13c ("c") or 13d ("d"),
    in a gloo group on the card."""
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    out_dir = os.path.dirname(spec["out"])
    runtime = initialize_runtime(MeshConfig(**spec["mesh"]), "cuda",
                                 backend="gloo")
    t0 = time.perf_counter()
    try:
        out = {"rank": runtime.process_index, "backend": runtime.backend,
               "seq": [runtime.seq_group.index, runtime.seq_group.size]}
        if spec["part"] == "b":
            out["b"] = ring_trainer_rank(torch, fa, runtime, out_dir)
        elif spec["part"] == "c":
            torch.cuda.reset_peak_memory_stats()
            reset_counts(fa)
            res = zero_cut_case(torch, (*RING_OVERRIDES, *RING_PAIR),
                                runtime, RING_PAIR_STEPS,
                                config_path=LONG_CONFIG)
            path = os.path.join(out_dir,
                                f"ring_c_rank{runtime.process_index}.pt")
            torch.save(res["tensors"], path)
            out["c"] = {"losses": res["losses"],
                        "grad_norms": res["grad_norms"],
                        "counts": read_counts(fa), "tensors": path,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        else:
            out["d"] = ring_f32_rank(torch, fa, runtime, out_dir,
                                     spec["corpus"])
        out["s"] = time.perf_counter() - t0
        return out
    finally:
        runtime.shutdown()


def ring_b_wave(workdir: str, hold: bool = False) -> dict:
    """13b's eight ranks."""
    return spawn_children([{"kind": "ring", "part": "b",
                            "mesh": {"data": -1, "seq": RING_RANKS},
                            "env": gang_env(port, RING_RANKS, r)}
                           for port in [free_port()]
                           for r in range(RING_RANKS)],
                          workdir, "ring_b", hold=hold)


def ring_phase(torch, fa, workdir: str, smi: str,
               after_b=None, b_wave=None) -> tuple[dict, dict]:
    """Phase 13; ``after_b()`` is called once 13b's ranks have ended;
    ``b_wave``: 13b's ranks, started held earlier in ``workdir`` (else
    they start here). Returns 13a's worst errors and 13b's
    attention-kernel launches, every rank's (main-path runs)."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data import progression
    from distributed_tensorflow_framework_torch.parallel import ring
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    t0 = time.perf_counter()
    bad = []
    # 13c's and 13d's ranks start up while 13a and 13b run.
    ring_c = spawn_children([{"kind": "ring", "part": "c",
                              "mesh": {"data": 1, "seq": 2},
                              "env": gang_env(port, 2, r)}
                             for port in [free_port()] for r in range(2)],
                            workdir, "ring_c", hold=True)
    corpus = os.path.join(workdir, "ring_corpus")
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    ring_d = spawn_children([{"kind": "ring", "part": "d",
                              "mesh": {"data": 2, "seq": 2}, "corpus": corpus,
                              "env": {**gang_env(port, 4, r), **env}}
                             for port in [free_port()] for r in range(4)],
                            workdir, "ring_d", hold=True)
    # 13a.
    worst = ring_kernel_parity(torch, fa)
    t1 = time.perf_counter()
    log(f"13a took {t1 - t0:.1f} s")

    # 13b.
    cfg = load_config(LONG_CONFIG, overrides=list(RING_OVERRIDES))
    m = cfg.model
    if (m.num_layers, m.hidden_size, m.num_heads, m.dtype, m.remat,
            m.dropout_rate, m.attention_impl, cfg.mesh.seq,
            cfg.data.seq_len) != (12, 768, 12, "bfloat16", True, 0.1, "ring",
                                  RING_RANKS, 16384):
        raise AssertionError(f"{LONG_CONFIG} is no longer the 16k ring "
                             f"recipe at seq {RING_RANKS}: {cfg}")
    chunk = cfg.data.seq_len // RING_RANKS
    route = fa.backward_route(*(torch.empty(1, chunk, 1, 64, device="cuda",
                                            dtype=torch.bfloat16),) * 2)
    micro = RING_STEPS * cfg.train.grad_accum_steps
    layers = load_config(LONG_CONFIG, overrides=[
        *RING_OVERRIDES, *RING_LAYERS]).model.num_layers
    calls = layers * RING_RANKS * micro
    fused = route == "fused"
    want = {"fwd": 2 * calls, "dq": 0 if fused else calls,
            "dkv": 0 if fused else calls, "fused": calls if fused else 0}
    ranks = join_children(b_wave or ring_b_wave(workdir), timeout=900)
    if after_b is not None:
        after_b()
    b0 = ranks[0]["b"]
    losses = {int(k): v["loss"] for k, v in b0["steps"].items()}
    same = all(r["b"]["steps"] == b0["steps"] for r in ranks)
    finite = (sorted(losses) == list(range(1, RING_STEPS + 1))
              and all(math.isfinite(v["loss"]) and math.isfinite(
                  v["grad_norm"]) for v in b0["steps"].values()))
    equal = sum(r["b"]["digest"] == b0["digest"] for r in ranks)
    events = read_events(b0["logs"])
    meta = next(e for e in events if e["kind"] == "run_meta")["extra"]
    ms = steady_ms(events)
    tally = next(e for e in events if e["kind"] == "train_step").get(
        "collectives") or {}
    log(f"13b {LONG_CONFIG} as written: mesh {meta['mesh']}, "
        f"sequence_parallel {meta['sequence_parallel']}, {RING_RANKS} gloo "
        f"ranks on the card ({meta['p2p_transport']} transport), "
        f"{chunk}-token chunks, depth cut to {layers} of 12 layers, "
        f"{RING_STEPS} steps of 8x16384 (one row per "
        f"micro-batch, remat, dropout 0.1, {route} backward): losses "
        + ", ".join(f"step {k} {v!r}" for k, v in sorted(losses.items()))
        + f"; equal on every rank {same}, finite {finite}; parameters "
        f"bit-equal across the ranks after step {RING_STEPS}: {equal} of "
        f"{len(ranks)}; {ms:.1f} ms/step (steps 2-{RING_STEPS}, chief's "
        f"clock; gloo through the host, not a scaling figure); the first "
        f"step's ppermute tally a rank (forward and recompute, the "
        f"backward's returns not tallied): {tally.get('ppermute_calls')} "
        f"leaves, {tally.get('ppermute_bytes')} bytes [{smi}]")
    counts = {k: 0 for k in want}
    for r in ranks:
        b = r["b"]
        log(f"13b rank {r['rank']} (seq index {r['seq'][0]} of "
            f"{r['seq'][1]}): peak {b['peak_gb']:.2f} GB (phase 6, one "
            f"process at 16384: 11.09 GB), step times "
            + ", ".join(f"{x:.0f}" for x in b["step_ms"])
            + f" ms, launches {b['counts']} (expected {want}), "
            f"{b['s']:.1f} s [{smi}]")
        if b["counts"] != want or not b["seq"]:
            bad.append((r["rank"], "13b launches", b["counts"]))
        counts = {k: counts[k] + b["counts"][k] for k in counts}
    if not (same and finite and equal == len(ranks)
            and meta["sequence_parallel"] == RING_RANKS):
        bad.append(("13b", same, finite, equal))
    t2 = time.perf_counter()
    log(f"13b took {t2 - t1:.1f} s")

    # 13c: one process on the same batches while the ranks work.
    release_children(ring_c)
    torch.cuda.empty_cache()
    ref = zero_cut_case(torch, (*RING_OVERRIDES, *RING_PAIR_ONE), None,
                        RING_PAIR_STEPS, config_path=LONG_CONFIG)
    ranks = join_children(ring_c)
    c = ranks[0]["c"]
    gaps = {key: max(abs(g - w) / abs(w) for g, w in zip(c[name], ref[name]))
            for key, name in (("loss", "losses"),
                              ("grad_norm", "grad_norms"))}
    tensors = torch.load(c["tensors"], weights_only=True)
    diff, leaf = worst_leaf(torch, tensors, ref["tensors"])
    lr = load_config(LONG_CONFIG).optimizer.learning_rate
    pair_layers = load_config(LONG_CONFIG, overrides=list(
        RING_PAIR)).model.num_layers
    log(f"13c ring at {{data: 1, seq: 2}} (8192-token chunks, {pair_layers} "
        f"of 12 layers, dropout 0) vs one process (seq 1, pallas), "
        f"{RING_PAIR_STEPS} "
        f"steps of 8x16384: losses {c['losses']} vs {ref['losses']}; "
        f"grad_norm {c['grad_norms']} vs {ref['grad_norms']}; largest "
        f"relative gap loss {gaps['loss']:.3e}, grad_norm "
        f"{gaps['grad_norm']:.3e} (tol {RING_LOSS_TOL}); the leaf that "
        f"differs most at step {RING_PAIR_STEPS}: {leaf} ({diff:.3e} = "
        f"{diff / lr:.3e} x lr); launches per rank "
        f"{[r['c']['counts'] for r in ranks]}, peak "
        f"{[round(r['c']['peak_gb'], 2) for r in ranks]} GB [{smi}]")
    if (any(gaps[k] > RING_LOSS_TOL[k] for k in gaps)
            or ranks[1]["c"]["losses"] != c["losses"]
            or not ranks[0]["c"]["counts"]["fwd"]):
        bad.append(("13c", gaps))
    del ref, tensors
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    log(f"13c took {t3 - t2:.1f} s")

    # 13d.
    progression.main([corpus, *RING_CORPUS])
    ranks = join_children(ring_d)
    default = ring.FLASH_CHUNK_MIN
    one_over = (*RING_F32, f"data.data_dir={corpus}/train")
    lr = load_config(DP_BERT[0], overrides=list(one_over)) \
        .optimizer.learning_rate
    tol = DP_TOL["bert"]
    try:
        for route, chunk_min in (("kernels", 0), ("plain", default)):
            ring.FLASH_CHUNK_MIN = chunk_min
            reset_counts(fa)
            ref = zero_cut_case(torch, one_over, None, DP_STEPS,
                                config_path=DP_BERT[0])
            one_counts = read_counts(fa)
            d = ranks[0]["d"]["routes"][route]
            gaps = {key: max(abs(g - w) / abs(w)
                             for g, w in zip(d[name], ref[name]))
                    for key, name in (("loss", "losses"),
                                      ("grad_norm", "grad_norms"))}
            tensors = torch.load(d["tensors"], weights_only=True)
            diff, leaf = worst_leaf(torch, tensors, ref["tensors"])
            same = all(r["d"]["routes"][route]["losses"] == d["losses"]
                       for r in ranks)
            log(f"13d {route} route (FLASH_CHUNK_MIN {chunk_min}), 2 layers "
                f"f32 packed 4:1, ring at {{data: 2, seq: 2}} (256-token "
                f"chunks) vs one process, {DP_STEPS} steps of 8x512: "
                f"losses {d['losses']} vs {ref['losses']}; largest relative "
                f"gap loss {gaps['loss']:.3e}, grad_norm "
                f"{gaps['grad_norm']:.3e}; worst parameter |diff| "
                f"{diff:.3e} = {diff / lr:.3e} x lr ({leaf}); tol {tol}; "
                f"equal on every rank {same}; launches rank 0 {d['counts']}"
                f" (segment ids {d['segmented']}), one process "
                f"{one_counts}")
            kernels = d["counts"]["fwd"] > 0 and d["segmented"]["fwd"] > 0
            if (gaps["loss"] > tol["loss"] or gaps["grad_norm"] > tol[
                    "grad_norm"] or diff > tol["params"] * lr or not same
                    or kernels != (route == "kernels")):
                bad.append(("13d", route, gaps, diff, kernels))
            del ref, tensors
    finally:
        ring.FLASH_CHUNK_MIN = default
    for r in ranks:
        res = r["d"]["resume"]
        log(f"13d rank {r['rank']} resume (deterministic algorithms, "
            f"kernel route): restored step {res['restored']}; losses after "
            f"the restore equal {res['losses_equal']}; {res['equal']} of "
            f"{res['tensors']} tensors (parameters, slots, dropout stream) "
            f"bit-equal to {RING_RESUME_STEPS} straight steps")
        if not (res["restored"] == RING_RESUME_SPLIT and res["losses_equal"]
                and res["equal"] == res["tensors"]):
            bad.append((r["rank"], "13d resume"))
    res = ranks[0]["d"]["resume"]
    cfg = load_config(DP_BERT[0], overrides=list(one_over))
    one = StepBuilder(cfg, device="cuda").init_state(SEED + 1)
    manager = CheckpointManager(dataclasses.replace(
        cfg.checkpoint, directory=res["ckpt"], allow_reshard=True))
    restored = manager.restore(one)
    manager.close()
    saved = torch.load(res["whole"], weights_only=True)
    loaded = {k: v.cpu() for k, v in one.model.state_dict().items()}
    equal = sum(torch.equal(loaded[k], v) for k, v in saved.items())
    log(f"13d the seq checkpoint read by one process: restored step "
        f"{restored}; {equal} of {len(saved)} model tensors bit-equal to "
        f"the ranks' at the save")
    if restored != RING_RESUME_SPLIT or equal != len(saved):
        bad.append(("13d one-process restore", restored, equal))
    t4 = time.perf_counter()
    log(f"13d took {t4 - t3:.1f} s")
    if bad:
        raise AssertionError(f"phase 13: {bad}")
    log(f"phase 13 took {t4 - t0:.1f} s (13a {t1 - t0:.1f}, 13b "
        f"{t2 - t1:.1f}, 13c {t3 - t2:.1f}, 13d {t4 - t3:.1f})")
    return worst, counts


# --------------------------------------------------------------- phase 14

# Phase 14: pipeline parallelism (mesh.pipe, model.pipeline_stages;
# parallel/pipeline.py). The card is one, so the stages are gloo children
# on it, and every activation and gradient hop goes through the host: the
# ms/step says nothing about scaling.
# 14a: configs/bert_base_mlm.yaml at full width through the Trainer on
# four stages of three layers, 8 microbatches of 4 rows; dropout 0, so
# that the first step's loss compares with one process's BertForMLM on
# the same weights and batch (bf16: the stages run 4-row GEMMs where one
# process runs 32-row ones, so the loss within 2e-3 relative, as 12b holds
# tensor parallelism).
PIPE_CONFIG = "configs/bert_base_mlm.yaml"
PIPE_RANKS = 4
PIPE_STEPS = 3
PIPE_MICRO = 8
PIPE_MESH = ("mesh.data=1", f"mesh.pipe={PIPE_RANKS}",
             f"model.pipeline_stages={PIPE_RANKS}",
             f"model.pipeline_microbatches={PIPE_MICRO}")
PIPE_OVERRIDES = ("data.global_batch_size=32",
                  f"train.total_steps={PIPE_STEPS}",
                  "train.log_interval=1", "train.eval_steps=0",
                  "train.eval_interval=0", "resilience.rollback=false",
                  "checkpoint.directory=", "model.dropout_rate=0.0")
PIPE_SCHEDULES = (("gpipe", 0), ("1f1b", 0), ("interleaved", 3))
PIPE_LOSS_TOL = 2e-3
# 14b: 8c's cut in f32 (2 layers, one a stage, 8 rows, clipping 1.0) at
# {data: 2, pipe: 2} with 4 microbatches of one row, against one process
# within DP_TOL's BERT tolerances; the resume under 1f1b with dropout 0.1.
PIPE_F32_MESH = ("mesh.data=2", "mesh.pipe=2", "model.pipeline_stages=2",
                 "model.pipeline_microbatches=4")
PIPE_F32_STEPS = 2
PIPE_RESUME = ("model.dropout_rate=0.1", "checkpoint.async_save=false",
               "model.pipeline_schedule=1f1b")
PIPE_RESUME_STEPS, PIPE_RESUME_SPLIT = 4, 2


def pipe_schedule(name: str, v: int) -> tuple:
    return (f"model.pipeline_schedule={name}",
            f"model.pipeline_virtual_stages={v}")


def pipe_trainer_run(torch, fa, runtime, out_dir: str, name: str,
                     v: int) -> dict:
    """14a on one rank under one schedule: the Trainer with the launch
    counts set to 0 just before and read just after, the step clock, the
    peak memory and a digest of the embedding and head after the last
    step."""
    import gc

    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    logs = os.path.join(out_dir, f"pipe_logs_{name}")
    cfg = load_config(PIPE_CONFIG, overrides=[
        *PIPE_OVERRIDES, *PIPE_MESH, *pipe_schedule(name, v)])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, log_dir=logs, runtime=runtime)
    trainer.build()
    clock = StepRecord()
    reset_counts(fa)
    t0 = time.perf_counter()
    try:
        trainer.train(hooks=trainer.default_hooks() + [clock])
    finally:
        trainer.writer.close()
    counts = read_counts(fa)
    model = trainer.state.model
    steps = [1e3 * (b - a) for a, b in zip(clock.ends, clock.ends[1:])]
    out = {"counts": counts, "steps": clock.steps, "step_ms": steps,
           "s": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "digest": digest(torch, {k: p for k, p in model.named_parameters()
                                    if not model.is_stage_key(k)}),
           "layers": model.layer_ids, "stage": model.stage,
           "bytes": state_bytes(torch, trainer.state), "logs": logs}
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipe_f32_rank(torch, runtime, out_dir: str) -> dict:
    """14b on one rank: gpipe and 1f1b at 8c's cut, then the resume."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    rank = runtime.process_index
    out = {"schedules": {}}
    torch.use_deterministic_algorithms(True)
    try:
        for name in ("gpipe", "1f1b"):
            res = zero_cut_case(torch, (*DP_BERT[1], *PIPE_F32_MESH,
                                        *pipe_schedule(name, 0)),
                                runtime, PIPE_F32_STEPS,
                                config_path=DP_BERT[0])
            path = os.path.join(out_dir, f"pipe_b_{name}_rank{rank}.pt")
            torch.save(res["tensors"], path)
            out["schedules"][name] = {"losses": res["losses"],
                                      "grad_norms": res["grad_norms"],
                                      "tensors": path}
            del res
        over = (*DP_BERT[1], *PIPE_F32_MESH, *PIPE_RESUME)
        kw = {"config_path": DP_BERT[0]}
        straight = zero_cut_case(torch, over, runtime, PIPE_RESUME_STEPS,
                                 **kw)
        legs = zero_cut_case(torch, over, runtime, PIPE_RESUME_SPLIT, **kw)
        ckpt = os.path.join(out_dir, "pipe_resume")
        manager = CheckpointManager(dataclasses.replace(
            legs["builder"].config.checkpoint, directory=ckpt),
            runtime=runtime)
        manager.save(PIPE_RESUME_SPLIT, legs["state"])
        whole = os.path.join(out_dir, f"pipe_saved_rank{rank}.pt")
        torch.save(legs["tensors"], whole)
        fresh = zero_cut_case(torch, over, runtime, 0, seed=SEED + 1, **kw)
        restored = manager.restore(fresh["state"])
        manager.close()
        tail = zero_cut_case(
            torch, over, runtime, PIPE_RESUME_STEPS - PIPE_RESUME_SPLIT,
            state=fresh["state"], builder=fresh["builder"],
            skip=PIPE_RESUME_SPLIT, **kw)
        want, got = (list(tensor_leaves(x["state"].state_dict()))
                     for x in (straight, tail))
        out["resume"] = {
            "restored": restored, "ckpt": ckpt, "whole": whole,
            "losses_equal": tail["losses"] == straight["losses"][
                PIPE_RESUME_SPLIT:],
            "tensors": len(want),
            "equal": sum(torch.equal(x, y) for x, y in zip(got, want))}
        return out
    finally:
        torch.use_deterministic_algorithms(False)


def pipe_rank(torch, fa, spec: dict) -> dict:
    """One rank of phase 14: a gloo group of four on the card; 14a under
    each schedule at {data: 1, pipe: 4}, then 14b at {data: 2, pipe: 2}
    (the builders re-form the subgroups)."""
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    out_dir = os.path.dirname(spec["out"])
    runtime = initialize_runtime(MeshConfig(data=1, pipe=PIPE_RANKS), "cuda",
                                 backend="gloo")
    try:
        out = {"rank": runtime.process_index, "backend": runtime.backend,
               "a": {}, "s": {}}
        for name, v in PIPE_SCHEDULES:
            t0 = time.perf_counter()
            out["a"][name] = pipe_trainer_run(torch, fa, runtime, out_dir,
                                              name, v)
            out["s"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["b"] = pipe_f32_rank(torch, runtime, out_dir)
        out["s"]["14b"] = time.perf_counter() - t0
        return out
    finally:
        runtime.shutdown()


def pipe_wave(workdir: str, hold: bool = False) -> dict:
    """Phase 14's four ranks."""
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}  # for 14b's determinism
    return spawn_children([{"kind": "pipe", "env": {
                               **gang_env(port, PIPE_RANKS, r), **env}}
                           for port in [free_port()]
                           for r in range(PIPE_RANKS)],
                          workdir, "pipe_ranks", hold=hold)


def pipe_phase(torch, workdir: str, smi: str, wave=None) -> dict:
    """Phase 14 on four gloo ranks (``wave``, when started held earlier):
    14a (BERT-base through the Trainer on four stages under gpipe, 1f1b
    and interleaved, against one process at the first step) and 14b (8c's
    cut in f32 at {data: 2, pipe: 2} against one process, a resume, the
    checkpoint read by one process). Returns 14a's attention-kernel
    launches, every rank under every schedule (main-path runs)."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    t0 = time.perf_counter()
    cfg = load_config(PIPE_CONFIG, overrides=[*PIPE_OVERRIDES, *PIPE_MESH])
    m = cfg.model
    if (m.num_layers, m.hidden_size, m.num_heads, m.dtype, m.attention_impl,
            m.fused_qkv, cfg.data.seq_len) != (12, 768, 12, "bfloat16",
                                               "pallas", True, 512):
        raise AssertionError(f"{PIPE_CONFIG} is no longer BERT-base at 512: "
                             f"{cfg}")
    layers = m.num_layers // PIPE_RANKS
    ranks = join_children(wave or pipe_wave(workdir), timeout=900)
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"14: backends {ranks}")
    t1 = time.perf_counter()
    bad = []
    # 14a.
    torch.cuda.empty_cache()
    # The Trainer draws its weights from train.seed: so does the reference.
    ref = zero_cut_case(torch, PIPE_OVERRIDES, None, 1, seed=cfg.train.seed,
                        config_path=PIPE_CONFIG)
    one_loss = ref["losses"][0]
    del ref
    torch.cuda.empty_cache()
    counts = {k: 0 for k in KERNEL_NAMES}
    firsts = {}
    for name, v in PIPE_SCHEDULES:
        a0 = ranks[0]["a"][name]
        events = read_events(a0["logs"])
        meta = next(e for e in events if e["kind"] == "run_meta")["extra"]
        sched_event = next(e for e in events
                           if e["kind"] == "pipeline_schedule")["extra"]
        ms = steady_ms(events)
        losses = {int(k): x["loss"] for k, x in a0["steps"].items()}
        same = all(r["a"][name]["steps"] == a0["steps"] for r in ranks)
        finite = (sorted(losses) == list(range(1, PIPE_STEPS + 1))
                  and all(math.isfinite(x["loss"]) and math.isfinite(
                      x["grad_norm"]) for x in a0["steps"].values()))
        equal = sum(r["a"][name]["digest"] == a0["digest"] for r in ranks)
        firsts[name] = losses.get(1, float("nan"))
        gap = abs(firsts[name] - one_loss) / abs(one_loss)
        factor = 2 if name == "1f1b" else 1
        want = {"fwd": factor * layers * PIPE_MICRO * PIPE_STEPS,
                "dq": layers * PIPE_MICRO * PIPE_STEPS,
                "dkv": layers * PIPE_MICRO * PIPE_STEPS, "fused": 0}
        log(f"14a {PIPE_CONFIG} {name} (virtual stages "
            f"{sched_event['virtual_stages']}, bubble "
            f"{sched_event['bubble_frac']:.4f}, peak in flight "
            f"{sched_event['peak_inflight']}), mesh {meta['mesh']}, "
            f"{PIPE_RANKS} gloo ranks on the card ({meta['p2p_transport']} "
            f"transport), {PIPE_STEPS} steps of 32x512 in {PIPE_MICRO} "
            f"microbatches (dropout 0, clipping 1.0): losses "
            + ", ".join(f"step {k} {x!r}" for k, x in sorted(losses.items()))
            + f"; equal on every rank {same}, finite {finite}; embedding and "
            f"head bit-equal across the ranks after step {PIPE_STEPS}: "
            f"{equal} of {len(ranks)}; the first step's loss vs one "
            f"process's BertForMLM {one_loss!r}: relative gap {gap:.3e} "
            f"(tol {PIPE_LOSS_TOL}); {ms:.1f} ms/step (steps 2-"
            f"{PIPE_STEPS}, chief's clock; gloo through the host, not a "
            f"scaling figure) [{smi}]")
        for r in ranks:
            a = r["a"][name]
            log(f"14a {name} rank {r['rank']} (stage {a['stage']}, layers "
                f"{a['layers']}): parameters {gb(a['bytes']['params'])}, "
                f"slots {gb(a['bytes']['slots'])} at rest, peak "
                f"{a['peak_gb']:.2f} GB, step times "
                + ", ".join(f"{x:.0f}" for x in a["step_ms"])
                + f" ms, launches {a['counts']} (expected {want}), "
                f"{r['s'][name]:.1f} s [{smi}]")
            if a["counts"] != want:
                bad.append((r["rank"], name, "14a launches", a["counts"]))
            counts = {k: counts[k] + a["counts"][k] for k in counts}
        if not (same and finite and equal == len(ranks)
                and gap <= PIPE_LOSS_TOL and meta["mesh"]["pipe"] == 4):
            bad.append(("14a", name, same, finite, equal, gap))
    if len(set(firsts.values())) != 1:
        bad.append(("14a first-step losses across the schedules", firsts))
    t2 = time.perf_counter()
    # 14b: one process on the same batches.
    lr = load_config(DP_BERT[0], overrides=list(DP_BERT[1])) \
        .optimizer.learning_rate
    tol = DP_TOL["bert"]
    ref = zero_cut_case(torch, DP_BERT[1], None, PIPE_F32_STEPS,
                        config_path=DP_BERT[0])
    for name in ("gpipe", "1f1b"):
        b = ranks[0]["b"]["schedules"][name]
        gaps = {key: max(abs(g - w) / abs(w) for g, w in zip(b[k], ref[k]))
                for key, k in (("loss", "losses"),
                               ("grad_norm", "grad_norms"))}
        tensors = torch.load(b["tensors"], weights_only=True)
        diff, leaf = worst_leaf(torch, tensors, ref["tensors"])
        same = all(r["b"]["schedules"][name]["losses"] == b["losses"]
                   for r in ranks)
        log(f"14b {name} 2 layers f32 at {{data: 2, pipe: 2}} (one layer a "
            f"stage, 4 microbatches) vs one process, {PIPE_F32_STEPS} steps "
            f"of 8x512: losses {b['losses']} vs {ref['losses']}; largest "
            f"relative gap loss {gaps['loss']:.3e}, grad_norm "
            f"{gaps['grad_norm']:.3e}; worst parameter |diff| {diff:.3e} = "
            f"{diff / lr:.3e} x lr ({leaf}); tol {tol}; equal on every rank "
            f"{same}")
        if (gaps["loss"] > tol["loss"] or gaps["grad_norm"] > tol[
                "grad_norm"] or diff > tol["params"] * lr or not same):
            bad.append(("14b", name, gaps, diff))
        del tensors
    del ref
    for r in ranks:
        res = r["b"]["resume"]
        log(f"14b rank {r['rank']} 1f1b resume with dropout 0.1 "
            f"(deterministic algorithms): restored step {res['restored']}; "
            f"losses after the restore equal {res['losses_equal']}; "
            f"{res['equal']} of {res['tensors']} tensors (parameters, "
            f"slots, dropout stream) bit-equal to {PIPE_RESUME_STEPS} "
            f"straight steps")
        if not (res["restored"] == PIPE_RESUME_SPLIT and res["losses_equal"]
                and res["equal"] == res["tensors"]):
            bad.append((r["rank"], "14b resume"))
    res = ranks[0]["b"]["resume"]
    over = [o for o in (*DP_BERT[1], *PIPE_RESUME)
            if not o.startswith("model.pipeline")]
    one_cfg = load_config(DP_BERT[0], overrides=over)
    one = StepBuilder(one_cfg, device="cuda").init_state(SEED + 1)
    manager = CheckpointManager(dataclasses.replace(
        one_cfg.checkpoint, directory=res["ckpt"], allow_reshard=True))
    restored = manager.restore(one)
    manager.close()
    saved = torch.load(res["whole"], weights_only=True)
    loaded = {k: x.cpu() for k, x in one.model.state_dict().items()}
    equal = sum(torch.equal(loaded[k], x) for k, x in saved.items())
    log(f"14b the pipelined checkpoint read by one process: restored step "
        f"{restored}; {equal} of {len(saved)} model tensors bit-equal to "
        f"the stages' gathered whole at the save; its optimizer at count "
        f"{one.optimizer.count}")
    if (restored != PIPE_RESUME_SPLIT or equal != len(saved)
            or set(saved) != set(loaded)):
        bad.append(("14b one-process restore", restored, equal))
    t3 = time.perf_counter()
    if bad:
        raise AssertionError(f"phase 14: {bad}")
    log(f"phase 14 took {t3 - t0:.1f} s (children {t1 - t0:.1f}: "
        + ", ".join(f"{k} {x:.1f}" for k, x in ranks[0]["s"].items())
        + f"; the parent's 14a {t2 - t1:.1f}, 14b {t3 - t2:.1f})")
    return counts


# --------------------------------------------------------------- phase 15

# Phase 15: Mixture-of-Experts. configs/bert_base_mlm.yaml at full width
# with the slice's MoE overrides: 4 experts in every second layer (1, 3,
# ..., 11), top-2, capacity 1.25 (C = 320 slots per expert and 512-token
# row), the sorted dispatch.
MOE_CONFIG = "configs/bert_base_mlm.yaml"
MOE = ("model.num_experts=4", "model.moe_every=2", "model.expert_topk=2",
       "model.capacity_factor=1.25", "model.moe_dispatch=sorted")
MOE_LAYERS = (1, 3, 5, 7, 9, 11)
# 15a: the served logits against the plain-attention model, both in bf16.
# A token whose gate probabilities nearly tie can take another expert when
# the attention output moves by a bf16 rounding, and its logits then move
# wholesale; such tokens are counted (their share at most
# MOE_ROUTE_FLIPS), the others held to the serving tolerances. Written
# before the first run.
MOE_ROUTE_FLIPS = 0.05
# 15b: phase 5's run with MoE layers, MOE_STEPS steps (20 of them: the
# script's time limit), the eval of 2 batches.
MOE_STEPS = 20
MOE_TRAIN = (*MOE, "data.global_batch_size=32",
             f"train.total_steps={MOE_STEPS}", "train.log_interval=10",
             "train.eval_steps=2", "train.eval_interval=0")
# 15c: 2 layers (layer 1 MoE) in f32, dropout 0, 8 x 512.
MOE_CUT = (*MOE, "model.num_layers=2", "model.dtype=float32",
           "model.dropout_rate=0.0", "data.global_batch_size=8")
# 15d: two gloo ranks at {data: 1, expert: 2}; the Trainer at 4 layers
# (the fewest with 2 MoE layers), bf16, dropout 0.1, clipping 1.0,
# MOE_EP_STEPS steps of 32 x 512 (16 rows a rank); then 8c's cut (2
# layers, f32, dropout 0, 8 rows, no warmup) with MOE against one process
# within DP_TOL["bert"], and its checkpoint read by one process.
MOE_EP_MESH = ("mesh.data=1", "mesh.expert=2")
MOE_EP_LAYERS = 4
MOE_EP_STEPS = 4
MOE_EP_OVERRIDES = (*MOE, "data.global_batch_size=32",
                    f"model.num_layers={MOE_EP_LAYERS}",
                    f"train.total_steps={MOE_EP_STEPS}",
                    "train.log_interval=1", "train.eval_steps=0",
                    "train.eval_interval=0", "resilience.rollback=false",
                    "checkpoint.directory=")
MOE_DP_CUT = (*DP_BERT[1], *MOE, "checkpoint.async_save=false")


def moe_kernel_class(name: str) -> str:
    """:func:`kernel_class`, with the MoE dispatch's sort, gather and
    scatter kernels (the argsort, the index tables, the token gather and
    its scatter-add backward, the combine's gather) as ``dispatch``."""
    low = name.lower()
    if any(t in low for t in ("sort", "gather", "scatter", "index")):
        return "dispatch"
    return kernel_class(name)


@contextlib.contextmanager
def moe_routes(seen: list):
    """Inside, every MoE layer's sorted dispatch appends (its choices
    (B, K, S), which of them were placed) to ``seen``."""
    from distributed_tensorflow_framework_torch.models import moe as moe_mod

    tables = moe_mod.sorted_tables

    def recorded(probs, expert_a, topk, capacity, *base):
        out = tables(probs, expert_a, topk, capacity, *base)
        seen.append((expert_a.cpu(), (out[3] > 0).cpu()))
        return out

    moe_mod.sorted_tables = recorded
    try:
        yield
    finally:
        moe_mod.sorted_tables = tables


def token_routes(torch, seen: list) -> "torch.Tensor":
    """(B, S, layers x K x 2): each token's route through every MoE layer
    of the last forward recorded by :func:`moe_routes`."""
    return torch.cat([torch.stack([c, p.long()], -1).permute(0, 2, 1, 3)
                      .flatten(2) for c, p in seen[-len(MOE_LAYERS):]], -1)


def moe_check(torch, ref_model, ids: list, got, routes, bucket: int,
              what: str) -> None:
    """Served logits (len, vocab) and their routes against the
    plain-attention model on the same padded row (15a's criterion)."""
    n = len(ids)
    pad = torch.zeros(1, bucket, dtype=torch.int64, device="cuda")
    pad[0, :n] = torch.tensor(ids, device="cuda")
    mask = torch.zeros_like(pad)
    mask[0, :n] = 1
    seen: list = []
    with torch.inference_mode(), moe_routes(seen):
        ref = ref_model(pad, mask)["logits"][0, :n].float().cpu()
    got = torch.as_tensor(got, dtype=torch.float32).reshape(ref.shape)
    same = (token_routes(torch, seen) == routes).all(-1)[0, :n]
    diff = (got - ref).abs()
    flips = 1.0 - same.float().mean().item()
    kept = diff[same].max().item() if same.any() else float("nan")
    log(f"{what}: logits vs the plain-attention model on the same "
        f"{bucket}-token row: {int((~same).sum())} of {n} tokens routed "
        f"otherwise in some MoE layer (share {flips:.4f}, tol "
        f"{MOE_ROUTE_FLIPS}); max|err| over the others {kept:.4e} (tol "
        f"{LOGIT_MAX_ATOL}), over all {diff.max().item():.4e}; mean|err| "
        f"{diff.mean().item():.4e} (tol {LOGIT_MEAN_ATOL}); ref std "
        f"{ref.std().item():.4f}")
    if not (flips <= MOE_ROUTE_FLIPS and kept <= LOGIT_MAX_ATOL
            and diff.mean().item() <= LOGIT_MEAN_ATOL):
        raise AssertionError(f"{what}: served MoE logits disagree with the "
                             f"plain-attention model")


def moe_serve(torch, fa, workdir: str, smi: str) -> int:
    """15a: the MoE artifact through cli/serve.py's main (a 32-token
    request over HTTP, in the 128 bucket), then a 512-token request
    through the engine (over HTTP its JSON body, 512 x 30522 floats, takes
    ~30 s to write and read); returns their forward launches."""
    import numpy as np

    from distributed_tensorflow_framework_torch.cli import serve as cli_serve
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.models.convert import to_flax
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        input_spec_for,
        load_artifact,
        save_artifact,
    )

    logs = os.path.join(workdir, "moe_serve_logs")
    overrides = [*MOE, "serve.port=0", "serve.seq_buckets=[128,512]",
                 f"serve.log_dir={logs}"]
    cfg = load_config(MOE_CONFIG, overrides=overrides)
    m = cfg.model
    model = get_model(m, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    if model.moe_layers != list(MOE_LAYERS):
        raise AssertionError(f"15a: MoE layers {model.moe_layers}")
    params = sum(p.numel() for p in model.parameters())
    artifact_dir = os.path.join(workdir, "moe_artifact")
    save_artifact(artifact_dir, model_config=m, task="mlm",
                  params=to_flax(model), step=0,
                  input_spec=input_spec_for(cfg, "mlm"),
                  source={"seed": SEED, "made_by": "chip_smoke.py"})
    del model
    client = HttpClient(logs, m.vocab_size, lengths=(32,))
    http_seen: list = []
    reset_counts(fa)
    client.start()
    with moe_routes(http_seen):
        rc = cli_serve.main(["--artifact", artifact_dir, "--config",
                             MOE_CONFIG, "--device", "cuda", *sum(
                                 (["--set", o] for o in overrides), [])])
    http_launches = read_counts(fa, serving=True)["fwd"]
    client.join(60)
    if client.error is not None:
        raise client.error
    res = client.results
    status, payload, ms = res["replies"][0]
    http_batches = res["health"]["engine"]["batches"]
    out = payload["outputs"]
    log(f"15a serve MoE bert-base ({params / 1e6:.1f} M parameters, MoE "
        f"layers {list(MOE_LAYERS)}) through cli/serve.py: rc {rc}, HTTP "
        f"{status}, one 32-token request in {ms:.1f} ms, batches "
        f"{http_batches}, kernel launches {http_launches} [{smi}]")
    if (rc != 0 or status != 200 or http_batches != 1
            or http_launches != 12 * http_batches
            or (len(out), len(out[0]), len(out[0][0])) != (
                1, 32, m.vocab_size)):
        raise AssertionError(f"15a http: rc {rc}, HTTP {status}, launches "
                             f"{http_launches}, batches {http_batches}")
    artifact = load_artifact(artifact_dir)
    engine = InferenceEngine(artifact, cfg.serve, device="cuda")
    ids = np.random.default_rng(SEED + 15).integers(
        0, m.vocab_size, 512).tolist()
    seen: list = []
    reset_counts(fa)
    with moe_routes(seen):
        got = engine.predict({"input_ids": ids}, timeout=600)
    launches = read_counts(fa, serving=True)["fwd"]
    batches = engine.stats()["batches"]
    engine.drain(60)
    log(f"15a engine.predict of 512 tokens: batches {batches}, kernel "
        f"launches {launches}, finite {bool(np.isfinite(got).all())}")
    if (got.shape != (1, 512, m.vocab_size) or not np.isfinite(got).all()
            or launches != 12 * batches or batches != 1):
        raise AssertionError(f"15a engine: {got.shape}, launches {launches}")
    ref_model = reference_model(torch, fa, m, artifact.state_dict)
    moe_check(torch, ref_model, res["requests"][0], out[0],
              token_routes(torch, http_seen), 128, "15a http 32 tokens")
    moe_check(torch, ref_model, ids, got[0], token_routes(torch, seen), 512,
              "15a engine 512 tokens")
    del ref_model, engine
    torch.cuda.empty_cache()
    return http_launches + launches


def moe_train(torch, fa, workdir: str, smi: str) -> dict:
    """15b: cli/train.py's main at full width and depth; returns the
    launch counts."""
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train import hooks as hooks_lib

    ckpt = os.path.join(workdir, "moe_ckpt")
    logs = os.path.join(workdir, "moe_train_logs")
    overrides = [*MOE_TRAIN, f"checkpoint.directory={ckpt}"]
    cfg = load_config(MOE_CONFIG, overrides=overrides)
    armed = []
    hook_cls = hooks_lib.MoECollapseHook

    class Armed(hook_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            armed.append(self)

    hooks_lib.MoECollapseHook = Armed
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    t0 = time.perf_counter()
    try:
        rc = run_cli_train(MOE_CONFIG, overrides, "--log-dir", logs)
    finally:
        hooks_lib.MoECollapseHook = hook_cls
    counts = read_counts(fa)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = read_events(logs)
    train = [e for e in events if e["kind"] == "train_step"]
    evals = [e for e in events if e["kind"] == "eval"]
    for e in train:
        log(f"15b train step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items()))
    for e in evals:
        log(f"15b eval at step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items()))
    want = {"fwd": 12 * (MOE_STEPS + cfg.train.eval_steps),
            "dq": 12 * MOE_STEPS, "dkv": 12 * MOE_STEPS, "fused": 0}
    b = cfg.data.global_batch_size
    eps = [e["throughput"]["examples_per_sec"] for e in train[1:]]
    rate = statistics.mean(eps) if eps else float("nan")
    log(f"15b MoE bert-base train: rc {rc}, {MOE_STEPS} steps of {b}x"
        f"{cfg.data.seq_len} in {wall:.1f} s; steady (steps "
        f"{train[0]['step'] + 1}-{MOE_STEPS}) {1e3 * b / rate:.2f} ms/step, "
        f"{rate * cfg.data.seq_len:.0f} tokens/s (first window "
        f"{1e3 * b / train[0]['throughput']['examples_per_sec']:.2f} "
        f"ms/step); peak memory {peak_gb:.2f} GB; kernel launches {counts} "
        f"(expected {want}); MoE collapse hooks armed {len(armed)} [{smi}]")
    metrics = [e["metrics"] for e in train]
    ok = (rc == 0 and len(train) == MOE_STEPS // 10 and len(evals) == 1
          and all(math.isfinite(x[k]) for x in metrics
                  for k in ("loss", "moe_aux_loss", "total_loss",
                            "moe_drop_frac", "grad_norm"))
          and all(0.0 <= x["moe_drop_frac"] <= 1.0 for x in metrics)
          and len(armed) == 1 and counts == want)
    if not ok:
        raise AssertionError(f"15b: rc {rc}, metrics {metrics}, launches "
                             f"{counts}, hooks {len(armed)}")
    log_saves(events, "15b")
    shutil.rmtree(ckpt, ignore_errors=True)
    train_breakdown(torch, cfg, classify=moe_kernel_class)
    return counts


def moe_correctness(torch, fa) -> None:
    """15c: gradients through the kernels against their plain versions at
    2 layers in f32, the two dispatchers on the card, the z-loss armed."""
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.models import moe as moe_mod
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    cfg = load_config(MOE_CONFIG, overrides=list(MOE_CUT))
    builder = StepBuilder(cfg, device="cuda")
    batch = to_device(next(get_dataset(cfg.data)), torch.device("cuda"))
    gradient_parity(torch, fa, builder, batch, "15c MoE 2 layers f32",
                    layers=2)
    # The two dispatchers at the slice's shape.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    b, s, e, k = 8, 512, 4, 2
    cap = moe_mod.capacity_for(s, e, k, 1.25)
    logits = torch.randn(b, s, e, device="cuda", generator=gen)
    table, valid, expert_a, pos_a, comb_w, aux_s = \
        moe_mod.topk_dispatch_sorted(logits, k, cap)
    dispatch, combine, aux_d = moe_mod.topk_dispatch(logits, k, cap)
    rebuilt = torch.zeros_like(dispatch)
    bi, ei, ci = valid.nonzero(as_tuple=True)
    rebuilt[bi, table[bi, ei, ci], ei, ci] = 1.0
    comb = torch.zeros_like(combine)
    for r in range(k):
        w = comb_w[:, r]
        bb, ss = (w > 0).nonzero(as_tuple=True)
        comb[bb, ss, expert_a[:, r][bb, ss], pos_a[:, r][bb, ss]] = w[bb, ss]
    layers = {}
    for impl in ("sorted", "dense"):
        layers[impl] = moe_mod.MoEMlp(768, e, 3072, dispatch_impl=impl,
                                      dtype=torch.float32, device="cuda")
    layers["sorted"].reset_parameters(gen)
    layers["sorted"].gate.reset_parameters(gen)
    layers["dense"].load_state_dict(layers["sorted"].state_dict())
    x = torch.randn(b, s, 768, device="cuda", generator=gen)
    with torch.no_grad():
        (o_s, a_s), (o_d, a_d) = (layers[i](x) for i in ("sorted", "dense"))
    out_err = rel_err(o_s, o_d)
    tables_equal = torch.equal(rebuilt, dispatch)
    comb_err = (comb - combine).abs().max().item()
    log(f"15c dispatchers at ({b}, {s}) E {e} top-{k} C {cap}: sorted tables "
        f"rebuilt equal the dense one-hots {tables_equal} ({int(valid.sum())}"
        f" of {b * s * k} placed), combine max|diff| {comb_err:.3e}, aux "
        f"{aux_s.item():.7f} vs {aux_d.item():.7f}; the layer (768 -> 3072, "
        f"f32): outputs {out_err:.3e} of the largest, aux_loss "
        f"{a_s['aux_loss'].item():.7f} vs {a_d['aux_loss'].item():.7f}, "
        f"drop_frac {a_s['drop_frac'].item():.5f} vs "
        f"{a_d['drop_frac'].item():.5f}")
    if not (tables_equal and comb_err <= 1e-6 and out_err <= 1e-5
            and abs(aux_s.item() - aux_d.item()) <= 1e-6
            and a_s["drop_frac"].item() == a_d["drop_frac"].item()):
        raise AssertionError("15c: the sorted and dense dispatchers differ")
    del layers, x
    # The router z-loss, armed.
    cfg = load_config(MOE_CONFIG, overrides=[*MOE_CUT,
                                             "model.moe_zloss_weight=0.1"])
    builder = StepBuilder(cfg, device="cuda")
    state = builder.init_state(SEED)
    state.optimizer.zero_grad()
    m = builder._micro_step(state, batch, 1.0)
    total = m["loss"] + cfg.train.moe_aux_weight * m["moe_aux_loss"]
    log(f"15c z-loss armed (weight 0.1): moe_zloss {m['moe_zloss'].item():.6f},"
        f" moe_aux_loss {m['moe_aux_loss'].item():.6f}, total_loss "
        f"{m['total_loss'].item():.6f} (loss + {cfg.train.moe_aux_weight} x "
        f"aux {total.item():.6f})")
    if not (m["moe_zloss"].item() > 0 and math.isfinite(
            m["moe_zloss"].item()) and abs(
            m["total_loss"].item() - total.item()) <= 1e-5):
        raise AssertionError("15c: z-loss")
    torch.cuda.empty_cache()


def moe_trainer_run(torch, fa, runtime, out_dir: str) -> dict:
    """15d on one rank: the Trainer with the launch counts set to 0 just
    before and read just after, the experts it holds, the bytes at rest
    and the peak memory."""
    import gc

    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    logs = os.path.join(out_dir, "moe_logs")
    cfg = load_config(MOE_CONFIG, overrides=[*MOE_EP_OVERRIDES,
                                             *MOE_EP_MESH])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, log_dir=logs, runtime=runtime)
    trainer.build()
    record = StepRecord()
    reset_counts(fa)
    t0 = time.perf_counter()
    try:
        trainer.train(hooks=trainer.default_hooks() + [record])
    finally:
        trainer.writer.close()
    counts = read_counts(fa)
    state = trainer.state
    named = dict(state.model.named_parameters())
    return {"counts": counts, "steps": record.steps,
            "s": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "bytes": state_bytes(torch, state), "logs": logs,
            "parts": {k: list(named[k].shape) for k in state.ep.part_keys()},
            "experts": sum(named[k].numel() * named[k].element_size()
                           for k in state.ep.part_keys())}


def moe_rank(torch, fa, out_dir: str) -> dict:
    """One rank of 15d: a gloo group on the card at {data: 1, expert:
    2}."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    runtime = initialize_runtime(MeshConfig(data=1, expert=2), "cuda",
                                 backend="gloo")
    rank = runtime.process_index
    try:
        out = {"rank": rank, "backend": runtime.backend, "s": {}}
        t0 = time.perf_counter()
        out["a"] = moe_trainer_run(torch, fa, runtime, out_dir)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        c = zero_cut_case(torch, (*MOE_DP_CUT, *MOE_EP_MESH), runtime,
                          DP_STEPS, config_path=MOE_CONFIG)
        ckpt = os.path.join(out_dir, "moe_ckpt")
        manager = CheckpointManager(dataclasses.replace(
            c["builder"].config.checkpoint, directory=ckpt), runtime=runtime)
        manager.save(DP_STEPS, c["state"])
        manager.close()
        path = os.path.join(out_dir, f"moe_c_rank{rank}.pt")
        torch.save(c["tensors"], path)
        out["b"] = {"losses": c["losses"], "grad_norms": c["grad_norms"],
                    "tensors": path, "ckpt": ckpt, "bytes": c["bytes"],
                    "parts": {k: list(p.shape) for k, p in
                              c["state"].model.named_parameters()
                              if ".moe.w" in k}}
        out["s"] = {"a": t1 - t0, "b": time.perf_counter() - t1}
        return out
    finally:
        runtime.shutdown()


def moe_phase(torch, fa, workdir: str, smi: str) -> dict:
    """Phase 15: 15a (serve), 15b (train at full depth), 15c (f32
    correctness), 15d (expert parallel on two gloo ranks). Returns the
    attention-kernel launches of 15a, 15b and both ranks of 15d's
    Trainer run (main-path runs)."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    t0 = time.perf_counter()
    # 15d's two ranks start up (held) while 15a serves: 15b's ms/step is
    # measured after their start-up.
    held = spawn_children([{"kind": "moe", "env": gang_env(port, 2, r)}
                           for port in [free_port()] for r in range(2)],
                          workdir, "moe_ranks", hold=True)
    serve_launches = moe_serve(torch, fa, workdir, smi)
    t1 = time.perf_counter()
    counts = moe_train(torch, fa, workdir, smi)
    counts = {**counts, "fwd": counts["fwd"] + serve_launches}
    t2 = time.perf_counter()
    moe_correctness(torch, fa)
    t3 = time.perf_counter()
    ranks = join_children(held, timeout=900)
    bad = []
    if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
        bad.append(("15d backends", ranks))
    a0, a1 = (r["a"] for r in ranks)
    events = read_events(a0["logs"])
    meta = next(e for e in events if e["kind"] == "run_meta")["extra"]
    ms = steady_ms(events)
    losses = {int(k): v["loss"] for k, v in a0["steps"].items()}
    same = a0["steps"] == a1["steps"]
    finite = (sorted(losses) == list(range(1, MOE_EP_STEPS + 1))
              and all(math.isfinite(v["loss"]) and math.isfinite(
                  v["grad_norm"]) for v in a0["steps"].values()))
    log(f"15d MoE bert-base {MOE_EP_LAYERS} layers bf16, mesh {meta['mesh']}"
        f", {meta['ep_sharded_leaves']} leaves split over expert, 2 gloo "
        f"ranks on the card, {MOE_EP_STEPS} steps of 32x512 (16 rows a "
        f"rank; dropout 0.1, clipping 1.0): losses " + ", ".join(
            f"step {k} {v!r}" for k, v in sorted(losses.items()))
        + f"; equal on both ranks {same}, finite {finite}; {ms:.1f} ms/step "
        f"(steps 2-{MOE_EP_STEPS}, chief's clock; gloo through the host, "
        f"not a scaling figure) [{smi}]")
    want = {"fwd": MOE_EP_LAYERS * MOE_EP_STEPS,
            "dq": MOE_EP_LAYERS * MOE_EP_STEPS,
            "dkv": MOE_EP_LAYERS * MOE_EP_STEPS, "fused": 0}
    for r in ranks:
        a = r["a"]
        log(f"15d rank {r['rank']}: experts held {a['parts']} (2 of each "
            f"layer's 4), parameters {gb(a['bytes']['params'])} at rest (of "
            f"them the expert parts {gb(a['experts'])}, half of the "
            f"layers' {gb(2 * a['experts'])}), slots "
            f"{gb(a['bytes']['slots'])}, peak {a['peak_gb']:.2f} GB, "
            f"launches {a['counts']}; 15d Trainer {r['s']['a']:.1f} s, "
            f"f32 cut {r['s']['b']:.1f} s [{smi}]")
        if a["counts"] != want or sorted(a["parts"]) != [
                f"layer{i}.moe.{w}" for i in (1, 3) for w in ("wi", "wo")
                ] or any(v[0] != 2 for v in a["parts"].values()):
            bad.append((r["rank"], "15d launches or parts", a["counts"],
                        a["parts"]))
        counts = {k: counts[k] + a["counts"][k] for k in counts}
    if not (same and finite and meta["mesh"]["expert"] == 2
            and meta["ep_sharded_leaves"] == 2 * (MOE_EP_LAYERS // 2)):
        bad.append(("15d", same, finite, meta["mesh"]))
    # The f32 cut against one process on the same batches.
    torch.cuda.empty_cache()
    ref = zero_cut_case(torch, MOE_DP_CUT, None, DP_STEPS,
                        config_path=MOE_CONFIG)
    one_bytes = ref["bytes"]
    b = ranks[0]["b"]
    lr = load_config(MOE_CONFIG, overrides=list(MOE_DP_CUT)) \
        .optimizer.learning_rate
    tol = DP_TOL["bert"]
    gaps = {key: max(abs(g - w) / abs(w) for g, w in zip(b[k], ref[k]))
            for key, k in (("loss", "losses"), ("grad_norm", "grad_norms"))}
    tensors = torch.load(b["tensors"], weights_only=True)
    diff, leaf = worst_leaf(torch, tensors, ref["tensors"])
    log(f"15d f32 2 layers at {{data: 1, expert: 2}} vs one process, "
        f"{DP_STEPS} steps of 8x512: losses {b['losses']} vs "
        f"{ref['losses']}; largest relative gap loss {gaps['loss']:.3e}, "
        f"grad_norm {gaps['grad_norm']:.3e}; worst parameter |diff| "
        f"{diff:.3e} = {diff / lr:.3e} x lr ({leaf}); tol {tol}; "
        f"parameters at rest per rank {gb(b['bytes']['params'])} against "
        f"one process's {gb(one_bytes['params'])} (expert parts "
        f"{b['parts']})")
    if (gaps["loss"] > tol["loss"] or gaps["grad_norm"] > tol["grad_norm"]
            or diff > tol["params"] * lr
            or ranks[1]["b"]["losses"] != b["losses"]):
        bad.append(("15d f32 vs one process", gaps, diff))
    del ref
    # The checkpoint written at expert 2, read by one process (expert 1).
    cfg = load_config(MOE_CONFIG, overrides=list(MOE_DP_CUT))
    one = StepBuilder(cfg, device="cuda").init_state(SEED + 1)
    manager = CheckpointManager(dataclasses.replace(
        cfg.checkpoint, directory=b["ckpt"], allow_reshard=True))
    restored = manager.restore(one)
    manager.close()
    loaded = {k: v.cpu() for k, v in one.model.state_dict().items()}
    equal = sum(torch.equal(loaded[k], v) for k, v in tensors.items())
    log(f"15d the checkpoint written at expert 2 read by one process: "
        f"restored step {restored}; {equal} of {len(tensors)} model tensors "
        f"bit-equal to the experts gathered whole at the save "
        f"(layer1.moe.wi {list(loaded['layer1.moe.wi'].shape)})")
    if restored != DP_STEPS or equal != len(tensors):
        bad.append(("15d one-process restore", restored, equal))
    if bad:
        raise AssertionError(f"phase 15: {bad}")
    t4 = time.perf_counter()
    log(f"phase 15 took {t4 - t0:.1f} s (15a {t1 - t0:.1f}, 15b "
        f"{t2 - t1:.1f}, 15c {t3 - t2:.1f}, 15d {t4 - t3:.1f})")
    return counts


# --------------------------------------------------------------- phase 16

# 16a: configs/bert_base_mlm.yaml at full width and depth (bf16, fused QKV,
# the flash kernels, dropout 0.1, AdamW, clipping), 32 x 512 on a
# synthetic stream, without remat and with model.remat under
# precision.remat_policy none (the per-layer checkpoint that keeps
# nothing), save_nothing and dots_saveable. Each arm: one step from the
# seed under torch.use_deterministic_algorithms, whose parameters must
# equal the arm without remat's bit for bit (the recompute runs the same
# kernels on the same inputs, and the two-pass kernels at 512 have no
# atomics), a warm-up step, REMAT_STEPS steps timed (host clock, synced)
# with the peak memory of those steps, and one step profiled.
REMAT_CONFIG = "configs/bert_base_mlm.yaml"
REMAT_BASE = ("data.global_batch_size=32", "checkpoint.directory=",
              "resilience.rollback=false")
REMAT_ARMS = {
    "no_remat": (),
    "remat": ("model.remat=true",),
    "save_nothing": ("model.remat=true",
                     "precision.remat_policy=save_nothing"),
    "dots_saveable": ("model.remat=true",
                      "precision.remat_policy=dots_saveable")}
REMAT_STEPS = 5
# The arms profiled (kernel time by class, idle share): one that replays
# the whole layer, one that keeps the products. 16c profiles its two
# ResNet arms of each kind; 16b none (its traces take the longest).
REMAT_PROFILED = ("remat", "dots_saveable")
IMAGE_REMAT_PROFILED = ("full", "conv_saved")
# 16a': precision.activation_dtype=f32 over the bf16 config: the flash
# kernels' f32 variants, at 2 layers (the depth changes nothing the f32
# route exercises), a warm-up step and F32_STEPS timed.
F32_ACTIVATIONS = ("precision.activation_dtype=f32", "model.num_layers=2")
F32_STEPS = 3
# 16b: configs/bert_long_ring.yaml as written (12 layers, remat, dropout
# 0.1) at 8192 tokens on one card (mesh.seq 1, pallas), the config's 8
# rows in 8 micro-batches of one: its remat (no policy) against
# dots_saveable, a warm-up step and LONG_REMAT_STEPS timed.
# FUSED_BWD on auto.
LONG_REMAT_SEQ = 8192
LONG_REMAT_STEPS = 3
LONG_REMAT_ARMS = {"remat": (),
                   "dots_saveable": ("precision.remat_policy=dots_saveable",)}
# 16c: configs/resnet50_cifar10.yaml as written (1024 rows, bf16, SGD with
# momentum) on a resident synthetic batch of its shape, without remat,
# with model.remat (full and conv_saved) and with precision.remat_policy
# save_nothing: IMAGE_REMAT_STEPS steps under deterministic algorithms,
# whose parameters and BatchNorm statistics must equal the arm without
# remat's bit for bit, then a warm-up step (cuDNN plans its
# non-deterministic algorithms) and IMAGE_REMAT_TIMED steps timed.
IMAGE_REMAT_ARMS = {
    "no_remat": (),
    "full": ("model.remat=true",),
    "conv_saved": ("model.remat=true", "model.remat_policy=conv_saved"),
    "save_nothing": ("model.remat=true",
                     "precision.remat_policy=save_nothing")}
IMAGE_REMAT_STEPS = 2
IMAGE_REMAT_TIMED = 5
SYNTHETIC = ("data.name=synthetic_images", "checkpoint.directory=",
             "resilience.rollback=false")
# 16d: the int8 products. quantized_matmul on the card at shapes of the
# int8 paths below (LeNet's fc1 and fc2, a ResNet-50 3x3 conv's patches
# at 256 rows) against the same function on the CPU: the forward bit for
# bit (exact integer block sums, the same rescale) and the gradients
# within INT8_GRAD_RTOL of their largest (the backward sums over N and M
# in other orders on the two devices). Then LeNet-5 config 1 on its
# synthetic fallback with activation_dtype bf16 and with int8 beside it
# (JAX's own pairing), INT8_LENET_STEPS steps timed after a warm-up; and
# ResNet-50/CIFAR-10 at INT8_RESNET_ROWS rows, cut from 1024 (its im2col
# path holds about 8.6 M padded patch elements and 6.4 M block sums an
# image, ~70 GB at 1024), INT8_RESNET_STEPS steps timed.
INT8_SHAPES = ((128, 400, 120), (128, 120, 84), (256 * 16 * 16, 128 * 9, 128))
INT8_GRAD_RTOL = 1e-5
INT8_LENET_STEPS = 30
INT8_RESNET_ROWS = 256
INT8_RESNET_STEPS = 3
INT8 = ("precision.activation_dtype=bf16", "precision.matmul_dtype=int8")
# 16e: ZeRO shard_map on two gloo ranks at 11a's cut (BERT-base, 2 layers,
# 32 x 512, bf16), FUSED_STEPS steps: the fused update against the
# unfused one on the f32 wire (parameters and slots bit for bit) and the
# int8 wire (the gap stated), then a resume that toggles
# precision.fused_update, which must be refused. Two children of its own,
# under deterministic algorithms.
FUSED_STEPS = 2
FUSED_MODES = {
    "zero_f32": (),
    "fused_f32": ("precision.fused_update=true",),
    "zero_int8": ("parallel.collective_dtype=int8",),
    "fused_int8": ("parallel.collective_dtype=int8",
                   "precision.fused_update=true")}


def precision_arm(torch, fa, cfg, det_steps: int, steps: int,
                  profile: str | None = None, classify=None) -> dict:
    """One arm of 16a-16d on the card through the StepBuilder: a builder
    from the seed, ``det_steps`` steps under deterministic algorithms
    (the whole tensors after them on the host), one step to warm up
    (cuDNN plans its non-deterministic algorithms, the allocator grows),
    then ``steps`` steps timed one by one (host clock, synced after each;
    ``ms`` their median, ``step_ms`` each) with their peak memory, and
    with ``profile`` one more step profiled by kernel class
    (``classify``) beside its idle share. Returns the launch counts of
    all of them, every loss and the model's int8 layers (``quant``)."""
    import gc

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.models import layers as L
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    gc.collect()
    torch.cuda.empty_cache()
    reset_counts(fa)
    builder = StepBuilder(cfg, device="cuda")
    state = builder.init_state(SEED)
    ds = get_dataset(cfg.data)
    dev = torch.device("cuda")
    losses, tensors = [], None

    def step(batch):
        losses.append(builder.train_step(state, batch)["loss"])

    if det_steps:
        with deterministic(torch):
            for _ in range(det_steps):
                step(to_device(next(ds), dev))
        tensors = {k: v.detach().cpu().clone()
                   for k, v in state.model.state_dict().items()}
    step(to_device(next(ds), dev))
    batches = [to_device(next(ds), dev) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for batch in batches[:steps]:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(step_ms)
    out = {"ms": ms, "step_ms": step_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if profile is not None:
        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            step(batches[steps])
            torch.cuda.synchronize()
        total = log_profile(prof, profile, top=6, classify=classify)
        out["kernel_ms"] = total
        if total:
            log(f"{profile}: device idle {100 * max(0.0, 1 - total / ms):.1f}"
                f"% of the {ms:.3f} ms step")
    out.update(
        counts=read_counts(fa), losses=[float(x) for x in losses],
        tensors=tensors,
        params={str(p.dtype) for p in state.model.parameters()},
        quant=sum(isinstance(m, (L.QuantDense, L.QuantConv))
                  for m in state.model.modules()),
        compute=sorted({str(m.dtype) for m in state.model.modules()
                        if isinstance(getattr(m, "dtype", None),
                                      torch.dtype)}))
    del builder, state, batches
    return out


def spread(run: dict) -> str:
    """An arm's step time: the median and the range of its timed steps."""
    t = run["step_ms"]
    return (f"{run['ms']:.2f} ms/step (median of {len(t)} steps, "
            f"{min(t):.2f}-{max(t):.2f})")


def tensor_gap(torch, got: dict, want: dict) -> tuple[int, float, str]:
    """How many of ``want``'s tensors ``got`` equals bit for bit, and the
    largest difference with the leaf that holds it (:func:`worst_leaf`)."""
    equal = sum(torch.equal(got[k], v) for k, v in want.items())
    return (equal, *worst_leaf(torch, got, want))


def remat_bert_phase(torch, fa, smi: str) -> dict:
    """16a and 16a'. Returns the launch counts of their runs."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    total = dict.fromkeys(KERNEL_NAMES, 0)
    runs = {}
    for name, extra in REMAT_ARMS.items():
        cfg = load_config(REMAT_CONFIG, overrides=[*REMAT_BASE, *extra])
        m = cfg.model
        if (m.num_layers, m.hidden_size, m.dtype, m.attention_impl,
                m.dropout_rate) != (12, 768, "bfloat16", "pallas", 0.1):
            raise AssertionError(f"{REMAT_CONFIG} is no longer BERT-base: "
                                 f"{m}")
        profile = name in REMAT_PROFILED
        run = precision_arm(torch, fa, cfg, 1, REMAT_STEPS,
                            profile=f"16a {name}" if profile else None)
        steps = 2 + REMAT_STEPS + profile  # deterministic, warm-up, timed
        want = {"fwd": 12 * steps * (2 if m.remat else 1),
                "dq": 12 * steps, "dkv": 12 * steps, "fused": 0}
        if run["counts"] != want:
            raise AssertionError(f"16a {name}: launches {run['counts']}, "
                                 f"expected {want}")
        if not all(math.isfinite(x) for x in run["losses"]):
            raise AssertionError(f"16a {name}: losses {run['losses']}")
        for k in total:
            total[k] += run["counts"][k]
        if name == "no_remat":
            ref = run["tensors"]
            gap = "the reference"
        else:
            equal, worst, where = tensor_gap(torch, run["tensors"], ref)
            gap = (f"{equal} of {len(ref)} tensors bit-equal to no_remat's"
                   + (f", largest gap {worst:.3e} at {where}"
                      if equal != len(ref) else ""))
            if equal != len(ref):
                raise AssertionError(f"16a {name}: {gap}")
        runs[name] = run
        log(f"16a bert-base 32x512 {name}: losses "
            + ", ".join(f"{x:.6f}" for x in run["losses"])
            + f"; {spread(run)}, peak "
            f"memory {run['peak_gb']:.2f} GB; launches {run['counts']}; "
            f"after one deterministic step {gap} [{smi}]")
    base = runs["no_remat"]
    log("16a peak memory " + ", ".join(
        f"{k} {r['peak_gb']:.2f} GB ({r['peak_gb'] / base['peak_gb']:.3f}x)"
        for k, r in runs.items()) + "; ms/step " + ", ".join(
        f"{k} {r['ms']:.2f} ({r['ms'] / base['ms']:.3f}x)"
        for k, r in runs.items()))
    cfg = load_config(REMAT_CONFIG, overrides=[*REMAT_BASE,
                                               *F32_ACTIVATIONS])
    run = precision_arm(torch, fa, cfg, 0, F32_STEPS)
    steps = 1 + F32_STEPS
    want = {"fwd": 2 * steps, "dq": 2 * steps, "dkv": 2 * steps, "fused": 0}
    if (run["counts"] != want or run["compute"] != ["torch.float32"]
            or not all(math.isfinite(x) for x in run["losses"])):
        raise AssertionError(f"16a' f32 activations: {run['counts']} "
                             f"(expected {want}), compute dtypes "
                             f"{run['compute']}, losses {run['losses']}")
    log(f"16a' activation_dtype f32 over the bf16 config, 2 layers: losses "
        + ", ".join(f"{x:.6f}" for x in run["losses"])
        + f"; compute dtypes {run['compute']} (model.dtype "
        f"{cfg.model.dtype}); the f32 kernels launched {run['counts']}; "
        f"{spread(run)}, peak {run['peak_gb']:.2f} GB [{smi}]")
    for k in total:
        total[k] += run["counts"][k]
    return total


def remat_long_phase(torch, fa, smi: str) -> dict:
    """16b. Returns the launch counts of its runs."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    total = dict.fromkeys(KERNEL_NAMES, 0)
    runs = {}
    seq = LONG_REMAT_SEQ
    for name, extra in LONG_REMAT_ARMS.items():
        cfg = load_config(LONG_CONFIG, overrides=[
            *LONG_OVERRIDES, f"model.max_seq_len={seq}", f"data.seq_len={seq}",
            "checkpoint.directory=", "resilience.rollback=false", *extra])
        m = cfg.model
        if (m.num_layers, m.remat, m.dtype) != (12, True, "bfloat16"):
            raise AssertionError(f"{LONG_CONFIG} is no longer 12 layers with "
                                 f"remat: {m}")
        run = precision_arm(torch, fa, cfg, 0, LONG_REMAT_STEPS)
        micro = 8 * (1 + LONG_REMAT_STEPS)  # warm-up, timed
        fused = fa.fused_bwd_enabled("cuda")
        want = {"fwd": 2 * 12 * micro, "dq": 0 if fused else 12 * micro,
                "dkv": 0 if fused else 12 * micro,
                "fused": 12 * micro if fused else 0}
        if (run["counts"] != want
                or not all(math.isfinite(x) for x in run["losses"])):
            raise AssertionError(f"16b {name}: launches {run['counts']} "
                                 f"(expected {want}), losses "
                                 f"{run['losses']}")
        for k in total:
            total[k] += run["counts"][k]
        runs[name] = run
        log(f"16b bert_long_ring S={seq} 12 layers {name}: losses "
            + ", ".join(f"{x:.6f}" for x in run["losses"])
            + f"; {spread(run)}, peak "
            f"{run['peak_gb']:.2f} GB; launches {run['counts']} [{smi}]")
    a, b = runs["remat"], runs["dots_saveable"]
    log(f"16b dots_saveable over remat: peak {b['peak_gb'] / a['peak_gb']:.3f}"
        f"x, ms/step {b['ms'] / a['ms']:.3f}x")
    return total


def remat_image_phase(torch, fa, smi: str) -> None:
    """16c (no attention kernel on this path: its runs must launch
    none)."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    runs = {}
    for name, extra in IMAGE_REMAT_ARMS.items():
        cfg = load_config(CIFAR_CONFIG, overrides=[*SYNTHETIC, *extra])
        if (cfg.model.name, cfg.data.global_batch_size, cfg.model.dtype) != (
                "resnet50_cifar", 1024, "bfloat16"):
            raise AssertionError(f"{CIFAR_CONFIG} is no longer config 2")
        run = precision_arm(
            torch, fa, cfg, IMAGE_REMAT_STEPS, IMAGE_REMAT_TIMED,
            profile=(f"16c {name}" if name in IMAGE_REMAT_PROFILED
                     else None), classify=image_kernel_class)
        if (not all(math.isfinite(x) for x in run["losses"])
                or any(run["counts"].values())):
            raise AssertionError(f"16c {name}: losses {run['losses']}, "
                                 f"launches {run['counts']}")
        if name == "no_remat":
            ref, gap = run["tensors"], "the reference"
        else:
            equal, worst, where = tensor_gap(torch, run["tensors"], ref)
            gap = (f"{equal} of {len(ref)} tensors (parameters, BN "
                   f"statistics) bit-equal to no_remat's"
                   + (f", largest gap {worst:.3e} at {where}"
                      if equal != len(ref) else ""))
            if equal != len(ref):
                raise AssertionError(f"16c {name}: {gap}")
        runs[name] = run
        log(f"16c resnet50-cifar10 1024 {name}: losses "
            + ", ".join(f"{x:.6f}" for x in run["losses"])
            + f"; {spread(run)}, "
            f"peak {run['peak_gb']:.2f} GB; after {IMAGE_REMAT_STEPS} "
            f"deterministic steps {gap} [{smi}]")
    base = runs["no_remat"]
    log("16c peak memory " + ", ".join(
        f"{k} {r['peak_gb']:.2f} GB ({r['peak_gb'] / base['peak_gb']:.3f}x)"
        for k, r in runs.items()) + "; ms/step " + ", ".join(
        f"{k} {r['ms']:.2f} ({r['ms'] / base['ms']:.3f}x)"
        for k, r in runs.items()))


def int8_products_phase(torch, smi: str) -> None:
    """16d (i): quantized_matmul on the card against its plain version,
    the same function on the CPU."""
    from distributed_tensorflow_framework_torch.models import layers as L

    gen = torch.Generator().manual_seed(SEED)
    for m, k, n in INT8_SHAPES:
        x = torch.randn(m, k, generator=gen)
        w = torch.randn(k, n, generator=gen) * 0.05
        g = torch.randn(m, n, generator=gen)
        results = {}
        for dev in ("cuda", "cpu"):
            xt = x.to(dev).requires_grad_()
            wt = w.to(dev).requires_grad_()
            y = L.quantized_matmul(xt, wt)
            (y * g.to(dev)).sum().backward()
            results[dev] = [t.detach().cpu() for t in (y, xt.grad, wt.grad)]
        card, cpu = results["cuda"], results["cpu"]
        same = torch.equal(card[0], cpu[0])
        grad_gap = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(card[1:], cpu[1:]))
        nnz = (card[1] != 0).sum(1).float().mean().item()
        log(f"16d quantized_matmul ({m}x{k}) @ ({k}x{n}), the card vs the "
            f"CPU: y equal {same}, gradients within {grad_gap:.2e} of their "
            f"largest; dx nonzero per row {nnz:.2f} ({-(-k // 256)} blocks)")
        if not same or grad_gap > INT8_GRAD_RTOL:
            raise AssertionError("16d: quantized_matmul on the card differs "
                                 "from its plain version")
    x = torch.randn(INT8_SHAPES[2][:2], device="cuda")
    w = torch.randn(INT8_SHAPES[2][1:], device="cuda")
    q = time_ms(torch, lambda: L.quantized_matmul(x, w), iters=5, warmup=2)
    b = time_ms(torch, lambda: x.bfloat16() @ w.bfloat16(), iters=5,
                warmup=2)
    log(f"16d quantized_matmul forward at {INT8_SHAPES[2]}: {q:.3f} ms, a "
        f"plain bf16 matmul {b:.3f} ms (CUDA events) [{smi}]")


def int8_models_phase(torch, fa, smi: str) -> None:
    """16d (ii) and (iii): LeNet-5 config 1 and ResNet-50/CIFAR-10 at 256
    rows, with and without int8."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    cases = (("lenet", LENET_CONFIG, (), INT8_LENET_STEPS),
             ("resnet50-cifar10", CIFAR_CONFIG,
              (f"data.global_batch_size={INT8_RESNET_ROWS}",),
              INT8_RESNET_STEPS))
    for what, path, cut, steps in cases:
        runs = {}
        for arm, extra in (("bf16", INT8[:1]), ("int8", INT8)):
            cfg = load_config(path, overrides=[*SYNTHETIC, *cut, *extra])
            run = precision_arm(torch, fa, cfg, 0, steps)
            if (not all(math.isfinite(x) for x in run["losses"])
                    or run["params"] != {"torch.float32"}
                    or any(run["counts"].values())
                    or (run["quant"] > 0) != (arm == "int8")):
                raise AssertionError(f"16d {what} {arm}: losses "
                                     f"{run['losses']}, {run['quant']} int8 "
                                     f"layers, params {run['params']}")
            runs[arm] = run
            log(f"16d {what} {arm} ({cfg.data.global_batch_size} rows): "
                f"losses {run['losses'][0]:.6f} -> {run['losses'][-1]:.6f}; "
                f"{spread(run)}, peak {run['peak_gb']:.2f} GB; "
                f"{run['quant']} int8 layers; masters {run['params']} "
                f"[{smi}]")
        a, b = runs["bf16"], runs["int8"]
        log(f"16d {what} int8 over bf16: {b['ms'] / a['ms']:.2f}x the "
            f"ms/step, {b['peak_gb'] / a['peak_gb']:.2f}x the peak")


def slot_tensors(torch, state) -> dict:
    """The optimizer's slots by parameter key, {key: {slot: tensor}},
    whether one optimizer holds them or one a ZeRO bucket."""
    sd = state.optimizer.state_dict()
    parts, names = ((sd["buckets"], state.optimizer.names)
                    if "buckets" in sd else ([sd], [state.optimizer.names]))
    return {part_names[i]: {k: v for k, v in slots.items()
                            if torch.is_tensor(v) and v.dim() >= 1}
            for part, part_names in zip(parts, names)
            for i, slots in part["inner"]["state"].items()}


def fused_rank(torch, fa, out_dir: str) -> dict:
    """One rank of 16e: a gloo group on the card and
    :func:`fused_cases`."""
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    runtime = initialize_runtime(MeshConfig(), "cuda", backend="gloo")
    try:
        return fused_cases(torch, fa, runtime, out_dir)
    finally:
        runtime.shutdown()


def fused_cases(torch, fa, runtime, out_dir: str) -> dict:
    """16e on one rank of a gloo group: the four modes through the
    StepBuilder, each with its launch counts, the fused modes held to the
    unfused ones, then the toggle across a resume."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    out = {"rank": runtime.process_index, "modes": {}}
    kept = {}
    for name, extra in FUSED_MODES.items():
        reset_counts(fa)
        t0 = time.perf_counter()
        res = zero_cut_case(torch, (*ZERO_OVERRIDES,
                                    "optimizer.zero_sharding=shard_map",
                                    *extra), runtime, FUSED_STEPS)
        slots = {k: {s: t.detach().cpu().clone() for s, t in v.items()}
                 for k, v in slot_tensors(torch, res["state"]).items()}
        out["modes"][name] = {"losses": res["losses"],
                              "counts": read_counts(fa),
                              "s": time.perf_counter() - t0}
        kept[name] = (res["tensors"], slots, res)
        if name.startswith("fused"):
            t_base, s_base, _ = kept[name.replace("fused", "zero")]
            t_eq, t_gap, t_where = tensor_gap(torch, res["tensors"],
                                              t_base)
            s_flat = {f"{k}.{s}": t for k, v in slots.items()
                      for s, t in v.items()}
            b_flat = {f"{k}.{s}": t for k, v in s_base.items()
                      for s, t in v.items()}
            s_eq, s_gap, s_where = tensor_gap(torch, s_flat, b_flat)
            out["modes"][name].update(
                params=[t_eq, len(t_base), t_gap, t_where],
                slots=[s_eq, len(b_flat), s_gap, s_where],
                buckets=len(res["state"].optimizer.opts))
        if name != "fused_int8":
            del kept[name][2]["state"], kept[name][2]["builder"]
    state = kept["fused_int8"][2]["state"]
    config = kept["fused_int8"][2]["builder"].config
    manager = CheckpointManager(dataclasses.replace(
        config.checkpoint, directory=os.path.join(out_dir, "fused_ck"),
        async_save=False), runtime=runtime)
    manager.save(FUSED_STEPS, state)
    manager.close()
    target = zero_cut_case(torch, (*ZERO_OVERRIDES,
                                   "optimizer.zero_sharding=shard_map",
                                   *FUSED_MODES["zero_int8"]),
                           runtime, 0, seed=SEED + 1)
    manager = CheckpointManager(dataclasses.replace(
        config.checkpoint, directory=os.path.join(out_dir, "fused_ck"),
        async_save=False), runtime=runtime)
    try:
        manager.restore(target["state"])
        out["toggle"] = None
    except ValueError as e:
        out["toggle"] = str(e)
    finally:
        manager.close()
    return out


def fused_wave(workdir: str, hold: bool = False) -> dict:
    """16e's two children, under deterministic algorithms."""
    return spawn_children([{"kind": "fused", "env": gang_env(port, 2, r),
                            "deterministic": True}
                           for port in [free_port()] for r in range(2)],
                          workdir, "fused_ranks", hold=hold)


def fused_phase(torch, workdir: str, smi: str, wave=None) -> dict:
    """16e on two children (``wave``, started held earlier, or started
    here). Returns the launch counts of both ranks' runs."""
    ranks = join_children(wave or fused_wave(workdir))
    total = dict.fromkeys(KERNEL_NAMES, 0)
    want = {"fwd": 2 * FUSED_STEPS, "dq": 2 * FUSED_STEPS,
            "dkv": 2 * FUSED_STEPS, "fused": 0}
    for r in ranks:
        for name, mode in r["modes"].items():
            if mode["counts"] != want:
                raise AssertionError(f"16e rank {r['rank']} {name}: launches "
                                     f"{mode['counts']}, expected {want}")
            for k in total:
                total[k] += mode["counts"][k]
        for wire in ("f32", "int8"):
            f, z = r["modes"][f"fused_{wire}"], r["modes"][f"zero_{wire}"]
            p, s = f["params"], f["slots"]
            log(f"16e rank {r['rank']} {wire} wire: fused losses "
                f"{f['losses']} (unfused {z['losses']}); {p[0]} of {p[1]} "
                f"parameter tensors and {s[0]} of {s[1]} slot tensors "
                f"bit-equal to the unfused update's"
                + (f" (largest gaps {p[2]:.3e} at {p[3]}, {s[2]:.3e} at "
                   f"{s[3]})" if p[0] != p[1] or s[0] != s[1] else "")
                + f"; {f['buckets']} buckets; {f['s']:.1f} s against "
                f"{z['s']:.1f} s through the host, each mode's build and "
                f"steps [{smi}]")
            if wire == "f32" and (p[0] != p[1] or s[0] != s[1]
                                  or f["losses"] != z["losses"]):
                raise AssertionError("16e: the fused update differs from "
                                     "the unfused one on the f32 wire")
        if not r["toggle"] or "precision.fused_update" not in r["toggle"]:
            raise AssertionError(f"16e: a fused checkpoint restored into an "
                                 f"unfused run: {r['toggle']}")
    log(f"16e a fused checkpoint into an unfused ZeRO run: refused "
        f"(ValueError: {ranks[0]['toggle'][:120]}...)")
    return total


def precision_phase(torch, fa, workdir: str, smi: str) -> dict:
    """Phase 16: 16a-16e. Returns the attention kernels' launches of 16a,
    16a', 16b and both ranks of 16e (main-path runs)."""
    t0 = time.perf_counter()
    parts = []

    def part(name: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        parts.append(f"{name} {time.perf_counter() - t:.1f}")
        return out

    counts = [part("16a", remat_bert_phase, torch, fa, smi)]
    # 16e's two ranks start up (held) while 16b-16d run: after 16a, whose
    # host-bound policies the start-up would slow.
    held = fused_wave(workdir, hold=True)
    counts.append(part("16b", remat_long_phase, torch, fa, smi))
    part("16c", remat_image_phase, torch, fa, smi)
    part("16d", lambda: (int8_products_phase(torch, smi),
                         int8_models_phase(torch, fa, smi)))
    counts.append(part("16e", fused_phase, torch, workdir, smi, held))
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s ("
        + ", ".join(parts) + ")")
    return {k: sum(c[k] for c in counts) for k in KERNEL_NAMES}


# --------------------------------------------------------------- phase 17

# The decode engine at BERT-base width (17a): phase 4's artifact, 16-token
# pages, 8 streams, 257 pages (8 streams x 32 pages of a 512-token stream,
# plus the scratch page). The f32 pool is 12 x 257 x 16 x 768 x 4 B x 2
# (K and V) = 303 MB.
DECODE_OVERRIDES = ("decode.enabled=true", "decode.page_size=16",
                    "decode.max_streams=8", "decode.num_pages=257",
                    "decode.max_new_tokens=64")
DECODE_HTTP_NEW = 16
DECODE_PROMPTS = 16
DECODE_PROMPT_LENS = (16, 256)
DECODE_NEW = 64
DECODE_PROBE = 64            # the probe stream's prompt length
DECODE_PROBE_NEW = 8
DECODE_NEIGHBOURS = 7
# The f32 walk on the card against the same walk in f64 on the CPU, over
# the prefill's and the first two decode steps' logits: the largest gap
# relative to the largest |logit| of the f64 walk. An f32 dot of K <= 3072
# terms carries ~sqrt(K) x 2^-24 ~ 3e-6 relative error; twelve
# LayerNorm-renormalised layers keep it near that, so 1e-3 leaves two
# orders of margin and still catches a wrong operation.
DECODE_F64_RTOL = 1e-3
# int8 pages against f32 pages, same stream: the largest logit gap,
# relative to the largest |logit|. The JAX package bounds it at 0.05
# absolute on its tiny model; a broken codec moves logits by O(1).
DECODE_INT8_RTOL = 0.05
# 17b: ResNet-50/CIFAR-10 (config 2) served from two of phase 7d's
# checkpoints; the logits against the model called directly, in bf16.
CLASSIFY_ROWS = 8
CLASSIFY_CLIENT_ROWS = 4
CLASSIFY_RTOL = 5e-2         # of the largest |logit|, bf16 (IMAGE_RTOL)
CLASSIFY_TRAFFIC_S = 1.0     # client traffic before and after the reload
# 17c: a registered model and dataset through the Trainer on the card.
REGISTRY_STEPS = 3


def check_generate(gen: dict, health: dict, vocab: int) -> None:
    """4a's ``POST /generate`` through ``cli/serve.py`` with
    ``decode.enabled``: a chunked NDJSON stream of DECODE_HTTP_NEW token
    lines and a done line, the step header, and the decode section of
    ``/healthz``."""
    lines = gen["lines"]
    tokens = [ln["token"] for ln in lines if "token" in ln]
    done = lines[-1]
    log(f"17a http /generate: status {gen['status']}, "
        f"{gen['headers'].get('Content-Type')}, X-DTF-Step "
        f"{gen['headers'].get('X-DTF-Step')}, {len(tokens)} token lines + "
        f"done (finish {done.get('finish')}, ttft {done.get('ttft_ms')} ms)"
        f" in {gen['ms']:.1f} ms for a {len(gen['prompt'])}-token prompt; "
        f"healthz decode: {health['decode']['streams_done']} streams, "
        f"{health['decode']['tokens']} tokens, kv "
        f"{health['decode']['kv_dtype']}")
    if (gen["status"] != 200
            or gen["headers"].get("Content-Type") != "application/x-ndjson"
            or gen["headers"].get("X-DTF-Step") != "0"
            or len(tokens) != DECODE_HTTP_NEW or done.get("done") is not True
            or done.get("tokens") != tokens
            or [ln["index"] for ln in lines[:-1]] != list(range(len(tokens)))
            or not all(0 <= t < vocab for t in tokens)
            or health["decode"]["streams_done"] != 1):
        raise AssertionError(f"/generate: a malformed stream: {gen}")


def decode_prompts(vocab: int) -> tuple[list, list]:
    import numpy as np

    rng = np.random.default_rng(SEED + 17)
    lengths = rng.integers(DECODE_PROMPT_LENS[0], DECODE_PROMPT_LENS[1] + 1,
                           DECODE_PROMPTS)
    prompts = [rng.integers(0, vocab, n).tolist() for n in lengths]
    return prompts, rng.integers(0, vocab, DECODE_PROBE).tolist()


def percentile(values: list, q: float) -> float:
    values = sorted(values)
    return values[min(len(values) - 1, int(q * len(values)))]


def decode_arm(torch, artifact, cfg, prompts, workdir: str, name: str,
               **decode) -> dict:
    """One engine over ``prompts`` at DECODE_NEW tokens each, after a
    warm-up of short streams that fills every row bucket (the first runs
    of its shapes): tokens/s on the host clock, TTFT p50/p99, per-step ms
    p50 and mean occupancy from its ``decode_step`` events, pages in use
    from its ``kv_cache`` events."""
    import dataclasses

    from distributed_tensorflow_framework_torch.core.telemetry import (
        TelemetryWriter,
    )
    from distributed_tensorflow_framework_torch.serve.decode import (
        DecodeEngine,
    )

    path = os.path.join(workdir, f"decode_{name}.jsonl")
    writer = TelemetryWriter(path)
    serve = dataclasses.replace(cfg.serve, report_interval_s=0.02)
    eng = DecodeEngine(artifact, dataclasses.replace(cfg.decode, **decode),
                       serve, device="cuda", telemetry_writer=writer)
    try:
        warm = [eng.submit(p[:DECODE_PROMPT_LENS[0]], max_new_tokens=4)
                for p in prompts[:eng.max_rows]]
        for st in warm:
            st.result(300)
        warm = eng.stats()["steps"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=DECODE_NEW) for p in prompts]
        outs = [st.result(600) for st in streams]
        wall = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        drained = eng.drain(60)
        writer.close()
    with open(path) as fh:
        events = [json.loads(line) for line in fh]
    steps = [e["metrics"] for e in events if e["kind"] == "decode_step"]
    steps = steps[warm:]
    kv = [e["metrics"]["pages_used"] for e in events
          if e["kind"] == "kv_cache"]
    tokens = sum(len(o["tokens"]) for o in outs)
    ttft = [o["ttft_ms"] for o in outs]
    res = {"tokens": [o["tokens"] for o in outs], "wall": wall,
           "tokens_per_s": tokens / wall,
           "ttft_p50": percentile(ttft, 0.5),
           "ttft_p99": percentile(ttft, 0.99),
           "step_p50": percentile([m["step_ms"] for m in steps], 0.5),
           "occupancy": statistics.mean(m["occupancy"] for m in steps),
           "steps": len(steps), "pages_max": max(kv), "pages_mean":
           statistics.mean(kv), "evictions": stats["evictions"],
           "prefills": stats["prefills"] - min(len(prompts), eng.max_rows),
           "pages": stats["pages"]["allocatable"], "drained": drained}
    if (not drained or tokens != DECODE_NEW * len(prompts)
            or not all(len(o["tokens"]) == DECODE_NEW for o in outs)):
        raise AssertionError(f"decode {name}: {tokens} tokens, drained "
                             f"{drained}")
    return res


def probe_logits(artifact, cfg, probe, neighbours=(), **decode):
    """The probe stream's per-token logits on a fresh engine, alone or
    submitted beside ``neighbours`` (DECODE_NEW tokens each)."""
    import dataclasses

    from distributed_tensorflow_framework_torch.serve.decode import (
        DecodeEngine,
    )

    eng = DecodeEngine(artifact, dataclasses.replace(cfg.decode, **decode),
                       cfg.serve, device="cuda")
    try:
        stream = eng.submit(probe, max_new_tokens=DECODE_PROBE_NEW,
                            return_logits=True)
        others = [eng.submit(p, max_new_tokens=DECODE_NEW)
                  for p in neighbours]
        events = [ev for kind, ev in stream.events(timeout=600)
                  if kind == "token"]
        for other in others:
            other.result(600)
        rows = eng.stats()["row_buckets"]
    finally:
        if not eng.drain(60):
            raise AssertionError("decode probe: the engine did not drain")
    return [ev["token"] for ev in events], [ev["logits"] for ev in events], \
        rows


def decode_f64(torch, artifact, probe, tokens) -> list:
    """The probe's prefill and its first two decode steps (fed the card's
    tokens) through the same walk in f64 on the CPU."""
    from distributed_tensorflow_framework_torch.models.bert import (
        decode_params,
    )
    from distributed_tensorflow_framework_torch.serve.decode import (
        decode_step,
        make_kv_pool,
        prefill,
    )

    def f64(tree):
        if isinstance(tree, dict):
            return {k: f64(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(f64(v) for v in tree)
        return tree.double()

    mc = artifact.model_config
    params = f64(decode_params(artifact.state_dict, "cpu"))
    page = 16
    pages = -(-(len(probe) + 2) // page)
    pool = {k: v.double() for k, v in make_kv_pool(
        mc.num_layers, pages + 1, page, mc.hidden_size, "float32",
        "cpu").items()}
    kw = dict(num_heads=mc.num_heads, page_size=page, kv_dtype="float32")
    table = torch.arange(1, pages + 1)
    out = [prefill(params, pool, torch.tensor([probe]),
                   torch.tensor([len(probe)]), table, **kw)]
    for i in range(2):
        pos = len(probe) + i
        out.append(decode_step(params, pool, torch.tensor([tokens[i]]),
                               torch.tensor([pos]), table[None], **kw)[0])
    return [o.numpy() for o in out]


def decode_kernel_class(name: str) -> str:
    name = name.lower()
    if any(t in name for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                               "gemv")):
        return "gemm"
    if any(t in name for t in ("index", "gather", "scatter")):
        return "index"
    if "reduce" in name or "softmax" in name:
        return "reduce"
    return "elementwise"


def decode_breakdown(torch, artifact, smi: str) -> None:
    """Where a decode step's time goes: one step of 8 rows, each at a
    512-token context (32 pages), and one prefill of a 256-token prompt
    (the 512 bucket), on the host clock around synchronised calls; the
    step's kernels by class from the profiler, their count and the
    device's idle share; the step's bound (the weights and the pages read
    once, the logits written once, at 3.35 TB/s)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_framework_torch.models.bert import (
        decode_params,
    )
    from distributed_tensorflow_framework_torch.serve.decode import (
        decode_step,
        make_kv_pool,
        prefill,
    )

    mc = artifact.model_config
    rows, pages = 8, mc.max_seq_len // 16
    params = decode_params(artifact.state_dict, "cuda")
    pool = make_kv_pool(mc.num_layers, 1 + rows * pages, 16, mc.hidden_size,
                        "float32", "cuda")
    kw = dict(num_heads=mc.num_heads, page_size=16, kv_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(0, mc.vocab_size, (rows,), device="cuda",
                        generator=gen)
    pos = torch.full((rows,), 16 * pages - 1, device="cuda")
    table = 1 + torch.arange(rows * pages, device="cuda").view(rows, pages)

    def step():
        return decode_step(params, pool, ids, pos, table, **kw).cpu()

    def timed(fn, n=10):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    step_ms = timed(step)
    prompt = torch.randint(0, mc.vocab_size, (1, mc.max_seq_len),
                           device="cuda", generator=gen)
    prefill_ms = timed(lambda: prefill(
        params, pool, prompt, torch.tensor([mc.max_seq_len // 2],
                                           device="cuda"),
        table[0, :pages // 2], **kw).cpu())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    launches = sum(count for _, count, _ in device_kernels(prof))
    kernel_ms = log_profile(
        prof, f"one decode step, {rows} rows x {16 * pages} keys", 6,
        decode_kernel_class)
    weights = sum(t.numel() for t in params["layers"][0].values()
                  for t in t) * mc.num_layers + params["head"][
                      "projection"].numel()
    moved = 4 * (weights + 2 * mc.num_layers * rows * pages * 16
                 * mc.hidden_size + rows * mc.vocab_size)
    log(f"17a decode step {rows} rows x {16 * pages} keys: {step_ms:.3f} "
        f"ms host clock, "
        f"kernels {kernel_ms:.3f} ms in {launches} launches (device idle "
        f"{100 * (1 - kernel_ms / step_ms):.1f}%), bound "
        f"{moved / 3.35e12 * 1e3:.3f} ms ({moved / 1e9:.3f} GB at 3.35 "
        f"TB/s); prefill of {mc.max_seq_len // 2} tokens "
        f"({mc.max_seq_len} bucket) {prefill_ms:.3f} ms "
        f"[{smi}]")
    del params, pool


def decode_phase(torch, artifact, cfg, workdir: str, smi: str) -> None:
    """17a: the decode engine at BERT-base width (phase 4's artifact, f32
    walk), continuous against static over 16 seeded prompts of 16-256
    tokens at 64 new tokens each; a probe stream alone against the same
    stream among neighbours (bits, or the largest gap with the tokens
    held equal); a tight pool's eviction giving the uncontended tokens;
    int8 pages against f32; the first steps against the walk in f64 on
    the CPU."""
    import numpy as np

    vocab = artifact.model_config.vocab_size
    prompts, probe = decode_prompts(vocab)
    arms = {}
    for name in ("continuous", "static"):
        arms[name] = run = decode_arm(torch, artifact, cfg, prompts,
                                      workdir, name, scheduler=name)
        log(f"17a decode {name}: {DECODE_PROMPTS} streams of "
            f"{DECODE_PROMPT_LENS[0]}-{DECODE_PROMPT_LENS[1]} prompt tokens "
            f"x {DECODE_NEW} new in {run['wall']:.3f} s: "
            f"{run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{run['ttft_p50']:.1f} ms p99 {run['ttft_p99']:.1f} ms, step "
            f"p50 {run['step_p50']:.3f} ms over {run['steps']} steps, mean "
            f"occupancy {run['occupancy']:.3f}, pages in use max "
            f"{run['pages_max']} mean {run['pages_mean']:.1f} of "
            f"{run['pages']}, "
            f"{run['prefills']} prefills, {run['evictions']} evictions "
            f"[{smi}]")
    same = sum(a == b for a, b in zip(arms["continuous"]["tokens"],
                                      arms["static"]["tokens"]))
    ratio = arms["continuous"]["tokens_per_s"] / arms["static"][
        "tokens_per_s"]
    log(f"17a continuous / static tokens/s {ratio:.3f};"
        f" {same} of {DECODE_PROMPTS} streams' tokens equal across the arms")

    solo_tokens, solo, rows = probe_logits(artifact, cfg, probe)
    batched_tokens, batched, _ = probe_logits(
        artifact, cfg, probe, prompts[:DECODE_NEIGHBOURS])
    gaps = [float(np.abs(a - b).max()) for a, b in zip(solo, batched)]
    equal = all(np.array_equal(a, b) for a, b in zip(solo, batched))
    log(f"17a probe ({DECODE_PROBE} tokens, {DECODE_PROBE_NEW} new) alone "
        f"vs among {DECODE_NEIGHBOURS} neighbours (row buckets {rows}): "
        f"logits bit-equal {equal}, largest gap {max(gaps):.3e} (per token "
        f"{[f'{g:.1e}' for g in gaps]}), tokens equal "
        f"{solo_tokens == batched_tokens}")
    if solo_tokens != batched_tokens:
        raise AssertionError("decode: the probe's tokens change among "
                             "neighbours")

    # Eviction: the two longest prompts in a pool that admits both (their
    # prompts' pages and one page of headroom) but cannot grow both to
    # their last token.
    pair = sorted(range(DECODE_PROMPTS), key=lambda i: -len(prompts[i]))[:2]
    need = [-(-(len(prompts[i]) + DECODE_NEW) // 16) for i in pair]
    pages = 2 + sum(-(-len(prompts[i]) // 16) for i in pair)
    t0 = time.perf_counter()
    tight = decode_arm(torch, artifact, cfg, [prompts[i] for i in pair],
                       workdir, "evict", max_streams=2, num_pages=pages)
    want = [arms["continuous"]["tokens"][i] for i in pair]
    log(f"17a eviction: prompts of {[len(prompts[i]) for i in pair]} tokens "
        f"in {pages} pages (they need {need}): {tight['evictions']} "
        f"evictions, {tight['prefills']} prefills, tokens equal to the "
        f"uncontended run {tight['tokens'] == want} "
        f"({time.perf_counter() - t0:.1f} s)")
    if tight["evictions"] < 1 or tight["tokens"] != want:
        raise AssertionError("decode: eviction lost the uncontended tokens")

    int8_tokens, int8, _ = probe_logits(artifact, cfg, probe,
                                        kv_dtype="int8")
    scale = max(float(np.abs(lg).max()) for lg in solo)
    gap = max(float(np.abs(a - b).max()) for a, b in zip(int8, solo))
    log(f"17a int8 pages vs f32: largest logit gap {gap:.4e} (tol "
        f"{DECODE_INT8_RTOL} x max|logit| {scale:.4f}), tokens equal "
        f"{sum(a == b for a, b in zip(int8_tokens, solo_tokens))} of "
        f"{DECODE_PROBE_NEW}")
    if not gap <= DECODE_INT8_RTOL * scale:
        raise AssertionError("decode: int8 pages drift from f32")

    ref = decode_f64(torch, artifact, probe, solo_tokens)
    worst = max(float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(solo[:3], ref))
    log(f"17a f32 walk on the card vs f64 on the CPU (prefill + 2 decode "
        f"steps): largest gap {worst:.3e} of max|logit| (tol "
        f"{DECODE_F64_RTOL})")
    if not worst <= DECODE_F64_RTOL:
        raise AssertionError("decode: the card's walk drifts from f64")
    decode_breakdown(torch, artifact, smi)


def classify_phase(torch, ckpt_dir: str, steps: tuple, workdir: str,
                   smi: str) -> None:
    """17b: ResNet-50/CIFAR-10 (config 2, bf16) exported from two
    checkpoints of ``ckpt_dir``; ``POST /predict`` of 32x32x3 rows against
    the model called directly in eval mode; ``POST /reload`` to the second
    artifact while a client keeps sending requests: zero failures, the
    step switches, and after the swap the reply equals a cold engine's on
    the new artifact at the same batch composition."""
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        export_checkpoint,
        load_artifact,
    )
    from distributed_tensorflow_framework_torch.serve.server import (
        ServingServer,
    )
    import numpy as np

    cfg = load_config(CIFAR_CONFIG, overrides=[
        f"checkpoint.directory={ckpt_dir}", "serve.port=0",
        "serve.max_batch_size=16", "serve.max_wait_ms=2",
        "serve.report_interval_s=60"])
    t0 = time.perf_counter()
    dirs = [export_checkpoint(cfg, os.path.join(workdir, f"art_{s}"),
                              step=s, device="cuda") for s in steps]
    arts = [load_artifact(d) for d in dirs]
    log(f"17b exported steps {steps} of {ckpt_dir} "
        f"({arts[0].model_config.name}, {arts[0].model_config.dtype}, "
        f"{len(arts[0].state_dict)} tensors with the BN statistics) in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 18)
    rows = rng.normal(size=(CLASSIFY_ROWS, 32, 32, 3)).astype(np.float32)
    engine = InferenceEngine(arts[0], cfg.serve, device="cuda")
    server = ServingServer(engine, cfg.serve)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://{server.host}:{server.port}"

    def post(path, body):
        req = urllib.request.Request(
            url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())

    try:
        status, reply = post("/predict", {"inputs": {"image": rows.tolist()}})
        model = get_model(arts[0].model_config, device="cuda")
        model.load_state_dict(arts[0].state_dict)
        with torch.inference_mode():
            direct = model(torch.from_numpy(rows).cuda()).float().cpu().numpy()
        got = np.asarray(reply["outputs"])
        gap = float(np.abs(got - direct).max() / np.abs(direct).max())
        log(f"17b /predict {CLASSIFY_ROWS} rows of 32x32x3: status {status}, "
            f"step {reply['step']}, logits vs the model called directly: "
            f"largest gap {gap:.3e} of max|logit| (bf16 tol {CLASSIFY_RTOL})")
        if status != 200 or got.shape != (CLASSIFY_ROWS, 10) or not (
                gap <= CLASSIFY_RTOL):
            raise AssertionError("/predict disagrees with the model")

        stop = threading.Event()
        seen: list = []
        failures: list = []
        sample = rows[:CLASSIFY_CLIENT_ROWS].tolist()

        def client():
            while not stop.is_set():
                try:
                    code, rep = post("/predict",
                                     {"inputs": {"image": sample}})
                    seen.append((time.perf_counter(), code, rep["step"]))
                    if code != 200:
                        failures.append(code)
                except Exception as e:  # noqa: BLE001 — counted below
                    failures.append(repr(e))

        clients = [threading.Thread(target=client) for _ in range(2)]
        for c in clients:
            c.start()
        time.sleep(CLASSIFY_TRAFFIC_S)
        t_reload = time.perf_counter()
        status, reloaded = post("/reload", {"artifact_dir": dirs[1]})
        t_done = time.perf_counter()
        time.sleep(CLASSIFY_TRAFFIC_S)
        stop.set()
        for c in clients:
            c.join(60)
        before = [s for t, _, s in seen if t < t_reload]
        after = [s for t, _, s in seen if t > t_done]
        log(f"17b reload under traffic: /reload status {status} "
            f"({reloaded.get('from_step')} -> {reloaded.get('to_step')}, "
            f"{reloaded.get('reload_ms', 0):.1f} ms); {len(seen)} requests "
            f"from 2 clients, {len(failures)} failed; steps before "
            f"{sorted(set(before))}, after {sorted(set(after))}")
        if (status != 200 or failures or set(before) != {steps[0]}
                or set(after) != {steps[1]}):
            raise AssertionError(f"reload under traffic: {failures}")
        _, alone = post("/predict", {"inputs": {"image": sample}})
    finally:
        server.shutdown("chip_smoke")
        thread.join(30)
    cold = InferenceEngine(arts[1], cfg.serve, device="cuda")
    try:
        want = cold.predict({"image": np.asarray(sample, np.float32)},
                            timeout=120)
    finally:
        cold.drain(30)
    got = np.asarray(alone["outputs"], np.float32)
    gap = float(np.abs(got - want).max())
    log(f"17b after the swap, one request alone vs a cold engine on step "
        f"{steps[1]}: bit-equal {np.array_equal(got, want)}, largest gap "
        f"{gap:.3e} [{smi}]")
    if not gap <= CLASSIFY_RTOL * float(np.abs(want).max()):
        raise AssertionError("the reloaded engine disagrees with a cold one")


def registry_phase(torch) -> None:
    """17c: a model and a dataset registered by name train REGISTRY_STEPS
    steps on the card through the Trainer."""
    from torch import nn

    from distributed_tensorflow_framework_torch import data, models
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data.pipeline import (
        HostDataset,
    )
    from distributed_tensorflow_framework_torch.models.layers import Dense
    from distributed_tensorflow_framework_torch.train.loop import Trainer
    import numpy as np

    class TinyMLP(nn.Module):
        def __init__(self, classes, device, generator):
            super().__init__()
            self.hidden = Dense(64, 32, dtype=torch.float32, device=device)
            self.out = Dense(32, classes, dtype=torch.float32, device=device)
            for layer in (self.hidden, self.out):
                layer.reset_parameters(generator)

        def forward(self, x, *, train=True):
            return self.out(torch.relu(self.hidden(x.reshape(len(x), -1))))

    @models.register_model("chip_smoke_mlp")
    def build(config, *, device=None, generator=None):
        return TinyMLP(config.num_classes, device, generator)

    @data.register_dataset("chip_smoke_blobs")
    def blobs(config, process_index, process_count, *, train=True):
        b = config.global_batch_size // process_count

        def make_iter(state):
            while True:
                rng = np.random.default_rng((SEED, state.get("i", 0)))
                x = rng.normal(size=(b, 8, 8, 1)).astype(np.float32)
                state["i"] = state.get("i", 0) + 1
                yield {"image": x,
                       "label": (x.mean(axis=(1, 2, 3)) > 0).astype(np.int32)}

        return HostDataset(make_iter, element_spec={
            "image": ((b, 8, 8, 1), np.float32), "label": ((b,), np.int32)})

    cfg = load_config(overrides=[
        "model.name=chip_smoke_mlp", "model.num_classes=2",
        "data.name=chip_smoke_blobs", "data.global_batch_size=64",
        "data.image_size=8", "data.channels=1", "mesh.data=1",
        f"train.total_steps={REGISTRY_STEPS}", "train.log_interval=1",
        "checkpoint.directory=", "optimizer.name=sgd_momentum",
        "optimizer.learning_rate=0.1"])
    trainer = Trainer(cfg, device="cuda")
    metrics = trainer.train()
    where = {p.device.type for p in trainer.state.model.parameters()}
    log(f"17c registered model + dataset: {REGISTRY_STEPS} steps through the "
        f"Trainer on {where}: loss {metrics['loss']:.6f}, grad_norm "
        f"{metrics['grad_norm']:.6f}")
    if where != {"cuda"} or not math.isfinite(metrics["loss"]):
        raise AssertionError("17c: the registered pair did not train on the "
                             "card")


# Phase 19: the port's gang supervisor (cli/train_cluster.py) on
# BERT-base at full width (hidden 768, 12 heads, S = 512), cut to 2
# layers and GANG_STEPS steps, on two gloo ranks of the card at
# {data: 2} with a checkpoint every 2 steps. Each supervisor is this
# script under ``--gang-supervisor`` (train_cluster's main, its ranks
# this script under ``--rank-worker``: cli.train's main under
# torch.use_deterministic_algorithms, phase 7d's settings for a bit-equal
# resume, its launch counts written to GANG_COUNTS_ENV's directory when
# it ends). The drills fire at the second chaos tick of GANG_TICK_S,
# early in the run: a kill before the first save relaunches from
# scratch, as bit-equal as one after it; the drop drill starts from the
# control's step-2 checkpoint (DROP_STEPS more steps), so that its
# survivor always has a two-rank checkpoint to reshard. A rank's start-up
# on the H100 machine is ~23 s (importing torch alone takes ~10 s there,
# measured on one H100), so the kill drill runs beside the control gang,
# and the drop drill starts as soon as the control's step 2 commits.
GANG_LAYERS = 2
GANG_STEPS = 8
DROP_STEPS = 6
GANG_TICK_S = 1.0
GANG_OVERRIDES = (
    "data.global_batch_size=8", f"model.num_layers={GANG_LAYERS}",
    "train.log_interval=1", "train.eval_steps=0", "train.eval_interval=0",
    "checkpoint.save_interval_steps=2", "resilience.rollback=false",
    "mesh.data=2")
GANG_COUNTS_ENV = "CHIP_SMOKE_GANG_COUNTS"


def rank_worker(argv: list[str]) -> int:
    """One rank of a phase-19 gang: ``cli.train.main(argv)``, deterministic
    and with TF32 off, its launch counts set to 0 before and written with
    its rank and exit code after (to GANG_COUNTS_ENV's directory)."""
    import torch

    from distributed_tensorflow_framework_torch.cli import train as cli_train
    from distributed_tensorflow_framework_torch.ops import (
        flash_attention as fa,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    reset_counts(fa)
    rc = 1
    try:
        rc = cli_train.main(argv)
    finally:
        out = os.environ.get(GANG_COUNTS_ENV)
        if out:
            with open(os.path.join(out, f"launches-{os.getpid()}.json"),
                      "w") as fh:
                json.dump({"rank": int(os.environ.get("JAX_PROCESS_ID", 0)),
                           "rc": rc, "counts": read_counts(fa)}, fh)
    return rc


def gang_supervisor(argv: list[str]) -> int:
    """cli/train_cluster.py's ``main(argv)`` with this script's
    ``--rank-worker`` as each rank (DTF_FAULTS from the environment)."""
    from distributed_tensorflow_framework_torch.cli import (
        launch_local_cluster as llc,
    )
    from distributed_tensorflow_framework_torch.cli import train_cluster

    llc.TRAIN_ENTRY = (os.path.abspath(__file__), "--rank-worker")
    return train_cluster.main(argv)


def gang_start(workdir: str, name: str, *flags: str, faults_spec: str = "",
               device: str = "cuda",
               config: str = "configs/bert_base_mlm.yaml",
               overrides=GANG_OVERRIDES) -> dict:
    """Start ``--gang-supervisor`` over two ranks (``faults_spec`` its
    DTF_FAULTS) in a process of its own; :func:`gang_join` waits for it."""
    ckpt = os.path.join(workdir, name)
    counts = os.path.join(workdir, f"{name}_launches")
    os.makedirs(counts)
    argv = ["--config", config, "--device", device, *sum(
        (["--set", o] for o in (*overrides, f"checkpoint.directory={ckpt}")),
        [])]
    env = {k: v for k, v in os.environ.items()
           if k not in ("DTF_FAULTS", "DTF_FAULTS_STATE")}
    env.update({GANG_COUNTS_ENV: counts, "DTF_FAULTS": faults_spec})
    logf = open(os.path.join(workdir, f"{name}_supervisor.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gang-supervisor",
         "--procs", "2", "--workdir", os.path.join(workdir, f"{name}_logs"),
         "--retry-sleep", "0.2", "--jitter", "0", *flags, "--", *argv],
        env=env, stdout=logf, stderr=subprocess.STDOUT)
    return {"name": name, "ckpt": ckpt, "counts": counts, "proc": proc,
            "log": logf, "t0": time.perf_counter(), "workdir": workdir}


def gang_join(run: dict, timeout: float = 300.0) -> dict:
    """Wait for a :func:`gang_start` run: the supervisor's and the chief's
    events, the ranks' launch counts and its seconds. A failed run prints
    the supervisor's and the ranks' log tails and fails the phase."""
    name, proc = run["name"], run["proc"]
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    seconds = time.perf_counter() - run["t0"]
    run["log"].close()
    if rc != 0:
        logs = os.path.join(run["workdir"], f"{name}_logs")
        for path in [run["log"].name] + sorted(
                os.path.join(logs, f) for f in os.listdir(logs)):
            with open(path) as fh:
                print(f"19 {name} {os.path.basename(path)}:\n"
                      f"{fh.read()[-4000:]}", file=sys.stderr)
        raise AssertionError(f"19 {name}: the supervisor exited {rc}")
    ranks = []
    for path in sorted(os.listdir(run["counts"])):
        with open(os.path.join(run["counts"], path)) as fh:
            ranks.append(json.load(fh))

    def events(path: str) -> list[dict]:
        with open(path) as fh:
            return [json.loads(line) for line in fh]

    sup = events(os.path.join(run["ckpt"], "supervisor_events.jsonl"))
    return {"ckpt": run["ckpt"], "seconds": seconds, "ranks": ranks,
            "events": events(os.path.join(run["ckpt"], "events.jsonl")),
            "attempts": [e["extra"] for e in sup
                         if e["kind"] == "supervisor_attempt"],
            "resized": [e["extra"] for e in sup
                        if e["kind"] == "mesh_resized"],
            "spans": [e["extra"] for e in sup if e["kind"] == "span"]}


def gang_times(run: dict) -> dict:
    """Where a gang run's seconds went, from the chief's and the
    supervisor's events: per attempt its start-up (the supervisor's
    attempt span start to the chief's first step) and its steps (first
    to last step), and the restart gap (the first attempt's last step to
    the relaunched gang's first)."""
    starts = sorted(s["t_start"] for s in run["spans"]
                    if s["name"] == "supervisor.attempt")
    steps = []
    for t0, t1 in zip(starts, starts[1:] + [float("inf")]):
        steps.append(sorted(ev["t"] for ev in run["events"]
                            if ev["kind"] == "train_step"
                            and t0 <= ev["t"] < t1))
    out = {"startup_s": [round(s[0] - t, 2) if s else None
                         for s, t in zip(steps, starts)],
           "steps_s": [round(s[-1] - s[0], 2) if s else None
                       for s in steps]}
    if len(steps) > 1 and steps[1]:
        first = steps[0][-1] if steps[0] else starts[0]
        out["restart_gap_s"] = round(steps[1][0] - first, 2)
    return out


def gang_launches(run: dict, device: str) -> dict:
    """The summed launch counts of the ranks that ended 0 (a rank killed
    by a drill writes none, its peer in the stopped gang ends nonzero);
    on the card each of them must have launched the forward, dQ and
    dK/dV kernels."""
    done = [r for r in run["ranks"] if r["rc"] == 0]
    if device == "cuda":
        for r in done:
            if not all(r["counts"][k] > 0 for k in ("fwd", "dq", "dkv")):
                raise AssertionError(f"19: rank {r['rank']} launched "
                                     f"{r['counts']}")
    return {k: sum(r["counts"][k] for r in done) for k in KERNEL_NAMES}


def gang_phase(torch, workdir: str, smi: str, device: str = "cuda",
               config: str = "configs/bert_base_mlm.yaml",
               overrides=GANG_OVERRIDES) -> dict:
    """Phase 19 (its text in the module docstring): the control gang
    beside 19a's kill drill, 19b's drop drill from the control's step-2
    checkpoint, then 19c, the gate in one process. Returns the flash kernels' launches of the ranks that
    ended 0 in the drills (the relaunched gang and the survivor)."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt import reshard
    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import (
        load_config,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        export_checkpoint,
    )
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    t_phase = time.perf_counter()
    kw = {"device": device, "config": config}
    steps = (*overrides, f"train.total_steps={GANG_STEPS}")
    tick = ("--chaos-tick", str(GANG_TICK_S))
    ctrl = gang_start(workdir, "control", "--max-attempts", "1",
                      "--chaos-tick", "0", overrides=steps, **kw)
    kill = gang_start(workdir, "kill", "--max-attempts", "3", *tick,
                      faults_spec="kill_worker:1:2", overrides=steps, **kw)
    # The drop drill resumes the control's step 2 for DROP_STEPS more, as
    # soon as its commit record is written (manifest.json, last).
    committed = os.path.join(ctrl["ckpt"], "2", "manifest.json")
    while not os.path.exists(committed) and ctrl["proc"].poll() is None:
        time.sleep(0.2)
    if os.path.exists(committed):
        shutil.copytree(os.path.dirname(committed),
                        os.path.join(workdir, "drop", "2"))
    drop = gang_start(workdir, "drop", "--max-attempts", "1", *tick,
                      faults_spec="drop_worker:1:2", overrides=(
                          *overrides, f"train.total_steps={2 + DROP_STEPS}"),
                      **kw)
    ctrl = gang_join(ctrl)
    log(f"19 control gang (beside 19a's): {ctrl['seconds']:.1f} s, "
        f"{gang_times(ctrl)}")
    kill, drop = gang_join(kill), gang_join(drop)
    classes = [(a["classification"], a.get("process_id"), a["rc"])
               for a in kill["attempts"]]
    if classes != [("crashed", 1, 137), ("done", 0, 0)]:
        raise AssertionError(f"19a: attempts {classes}")

    def last_loss(run):
        return [ev["metrics"]["loss"] for ev in run["events"]
                if ev["kind"] == "train_step"
                and ev["step"] == GANG_STEPS][-1]

    final = {n: torch.load(os.path.join(r["ckpt"], str(GANG_STEPS),
                                        "state.pt"), weights_only=True)
             for n, r in (("ctrl", ctrl), ("kill", kill))}
    same = [torch.equal(t, final["kill"]["model"][k])
            for k, t in final["ctrl"]["model"].items()]
    del final
    restored = [ev["extra"]["restored_step"] for ev in kill["events"]
                if ev["kind"] == "startup"]
    kill_counts = gang_launches(kill, device)
    log(f"19a kill_worker:1:2 (tick {GANG_TICK_S} s): attempts {classes}, "
        f"the relaunched gang from step {restored[-1]}; step-{GANG_STEPS} "
        f"loss {last_loss(kill)!r} vs the control's {last_loss(ctrl)!r}; "
        f"{sum(same)} of {len(same)} parameter tensors bit-equal; the "
        f"relaunched ranks' launches {kill_counts}; {kill['seconds']:.1f} "
        f"s, {gang_times(kill)}")
    if last_loss(kill) != last_loss(ctrl) or not all(same):
        raise AssertionError("19a: the relaunched gang is not bit-equal to "
                             "the control")
    classes = [a["classification"] for a in drop["attempts"]]
    (resize,) = drop["resized"]
    resharded = [ev for ev in drop["events"]
                 if ev["kind"] == "ckpt_resharded"]
    drop_counts = gang_launches(drop, device)
    log(f"19b drop_worker:1:2 from the control's step 2: "
        f"attempts {classes}; mesh_resized process_count "
        f"{resize['process_count']}, dropped {resize['dropped_workers']}, "
        f"to {reshard.describe_axes(resize['to_axes'])}, (global_batch, "
        f"grad_accum) ({resize['global_batch']}, {resize['grad_accum']}), "
        f"effective batch kept {resize['effective_batch_preserved']}; "
        f"ckpt_resharded (step, leaves, respec agreement) "
        f"{[(e['step'], e['extra']['leaf_count'], e['extra']['respec_agreement']) for e in resharded]}; "
        f"the survivor's launches {drop_counts}; {drop['seconds']:.1f} s, "
        f"{gang_times(drop)}")
    if (classes != ["gang_refit", "done"] or resize["process_count"] != 1
            or resize["dropped_workers"] != [1]
            or resize["to_axes"]["data"] != 1
            or not resize["effective_batch_preserved"]
            or (resize["global_batch"], resize["grad_accum"]) != (4, 2)
            or len(resharded) != 1
            or resharded[0]["extra"]["from_axes"]["data"] != 2):
        raise AssertionError("19b: the refit is not the one asked for")
    # 19c: the control's {data: 2} checkpoint in one process: one state,
    # refused, then restored resharded, then restored from the drop
    # drill's survivor's checkpoint, saved under one process's mesh.
    cfg = load_config(config, overrides=[
        o for o in steps if not o.startswith("mesh.")])
    state = StepBuilder(cfg, device=device).init_state(SEED)

    def restore(ckpt, allow):
        manager = CheckpointManager(dataclasses.replace(
            cfg.checkpoint, directory=ckpt, allow_reshard=allow))
        try:
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            step = manager.restore(state)
            if device == "cuda":
                torch.cuda.synchronize()
            return step, round(time.perf_counter() - t0, 3)
        finally:
            manager.close()

    try:
        restore(ctrl["ckpt"], False)
        raise AssertionError("19c: the {data:2} checkpoint restored in one "
                             "process without checkpoint.allow_reshard")
    except reshard.MeshTopologyError as e:
        refused = str(e)
    try:
        export_checkpoint(dataclasses.replace(
            cfg, checkpoint=dataclasses.replace(cfg.checkpoint,
                                                directory=ctrl["ckpt"])),
            os.path.join(workdir, "gate_art"), device=device)
        raise AssertionError("19c: exported without serve.allow_reshard")
    except reshard.MeshTopologyError as e:
        export_refused = str(e)
    if not ("{data:2}" in refused and "{1 device}" in refused
            and "checkpoint.allow_reshard" in refused
            and "serve.allow_reshard" in export_refused):
        raise AssertionError(f"19c: {refused} / {export_refused}")
    restore_s = {"resharded {data:2} -> {1 device}": restore(ctrl["ckpt"],
                                                             True),
                 "same mesh {1 device}": restore(drop["ckpt"], False)}
    del state
    log(f"19c one process: the restore refused ({refused[:110]}...); the "
        f"export refused naming serve.allow_reshard; restore (step, s) "
        f"{restore_s} (a warm read) [{smi}]")
    log(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return {k: kill_counts[k] + drop_counts[k] for k in KERNEL_NAMES}


# Phase 20: the serving fleet (serve/fleet.py, serve/autoscale.py,
# cli/fleet.py; the flash forward in every replica). The router runs in
# this process; it fronts FLEET_REPLICAS replicas of a BERT-base artifact
# at full width and depth (configs/bert_base_mlm.yaml's model, weights
# from a seed), each this script under ``--replica-worker``
# (``cli.serve.main`` with its launch counts set to 0 before and written
# to FLEET_COUNTS_ENV's directory when it ends). The replicas start held
# (imports, CUDA) while phase 19 runs. The router's knobs (FLEET_KNOBS)
# are cut from their 10 s defaults so that a stalled replica's attempts
# give up inside the drill, and one failed attempt ejects a replica, so
# that the stall's one request in flight shows the eject and the
# readmission; the attempt cap stays ten times a reply's time on the
# card, so that a slow answer does not eject the one replica left during
# the kill or the stall. An MLM ``/predict`` answers with the whole
# (rows, tokens, 30522) f32 logits as JSON, which the stdlib router
# parses and writes again under its one interpreter lock (a row of 128
# tokens is 3.9 M floats), and clients that send without a pause hold
# that lock and slow the prober's ticks (readmission 3 s after a
# SIGCONT, against 0.02 s with the pause, on the H100 machine). The
# clients' rows are therefore FLEET_TOKENS tokens long (the 128 bucket on
# the card), FLEET_ROWS of them to a request, each client pausing
# FLEET_PAUSE_S between its requests.
FLEET_REPLICAS = 2
FLEET_OVERRIDES = ("serve.seq_buckets=[128,256,512]", "serve.max_batch_size=8",
                   "serve.data=-1", *DECODE_OVERRIDES)
FLEET_KNOBS = {"fleet_probe_interval_s": 0.25, "fleet_attempt_timeout_s": 5.0,
               "fleet_healthz_stale_s": 6.0, "fleet_deadline_s": 60.0,
               "fleet_retries": 3, "fleet_retry_backoff_ms": 50.0,
               "fleet_eject_failures": 1}
FLEET_CLIENTS = 8
FLEET_ROWS = (1, 8)
FLEET_TOKENS = (1, 1)
FLEET_PAUSE_S = 1.5
FLEET_CHECKS = 8
FLEET_KILL_TICKS = 2
FLEET_STALL_S = 6.0
FLEET_NEW_TOKENS = 4
FLEET_COUNTS_ENV = "CHIP_SMOKE_FLEET_COUNTS"
FLEET_GO_ENV = "CHIP_SMOKE_FLEET_GO"
# Every process phase 20 starts, stopped when the script ends; cli/fleet.py
# runs in a session of its own, whose process group (its replicas too) is
# killed with it.
_FLEET_PROCS: list = []


def stop_fleet_procs() -> None:
    for proc in _FLEET_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if getattr(proc, "own_session", False):
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(proc.pid, signal.SIGKILL)


def replica_worker(argv: list[str]) -> int:
    """One replica of phase 20: ``cli.serve.main(argv)`` with TF32 off (as
    this script's own engines), started held while FLEET_GO_ENV names a
    file that does not exist yet; its launch counts are set to 0 before
    and written with its exit code after, to FLEET_COUNTS_ENV's
    directory. A replica killed by a drill writes none."""
    import torch

    from distributed_tensorflow_framework_torch.cli import serve as cli_serve
    from distributed_tensorflow_framework_torch.ops import (
        flash_attention as fa,
    )
    from distributed_tensorflow_framework_torch.serve import (  # noqa: F401
        decode,
        engine,
        server,
    )

    if torch.cuda.is_available():
        torch.cuda.init()
    go = os.environ.get(FLEET_GO_ENV)
    while go and not os.path.exists(go):
        time.sleep(0.05)  # a script that is gone ends this one (watcher)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts(fa)
    rc = 1
    try:
        rc = cli_serve.main(argv)
    finally:
        out = os.environ.get(FLEET_COUNTS_ENV)
        if out:
            with open(os.path.join(out, f"launches-{os.getpid()}.json"),
                      "w") as fh:
                json.dump({"replica": os.environ.get("DTF_REPLICA_ID"),
                           "rc": rc, "counts": read_counts(fa, serving=True)},
                          fh)
    return rc


def fleet_launcher(workdir: str, device: str = "cuda", overrides=()):
    """cli/fleet.py's replica launcher with this script's
    ``--replica-worker`` as the replica, over ``<workdir>/v1``."""
    from distributed_tensorflow_framework_torch.cli import fleet as cli_fleet

    counts = os.path.join(workdir, "launches")
    os.makedirs(counts, exist_ok=True)
    os.environ[FLEET_COUNTS_ENV] = counts
    inner = cli_fleet.make_replica_launcher(
        os.path.join(workdir, "v1"), os.path.join(workdir, "replicas"),
        [*FLEET_OVERRIDES, *overrides], device,
        entry=(os.path.abspath(__file__), "--replica-worker"))

    def launch(index: int):
        proc, endpoint = inner(index)
        _FLEET_PROCS.append(proc)
        return proc, endpoint

    return launch


def fleet_wave(workdir: str, device: str = "cuda", overrides=()) -> dict:
    """Phase 20's first FLEET_REPLICAS replicas, started held: they import
    torch and the serving stack and reach the card, then wait for
    ``go``."""
    held = {"go": os.path.join(workdir, "replicas.go"),
            "t0": time.perf_counter(),
            "launch": fleet_launcher(workdir, device, overrides)}
    os.environ[FLEET_GO_ENV] = held["go"]
    try:
        held["procs"] = [held["launch"](i) for i in range(FLEET_REPLICAS)]
    finally:
        del os.environ[FLEET_GO_ENV]
    return held


def bert_artifact(torch, cfg, path: str, seed: int,
                  device: str = "cuda") -> str:
    """A port artifact of ``cfg``'s model with weights made from ``seed``
    on ``device``."""
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.models.convert import to_flax
    from distributed_tensorflow_framework_torch.serve.export import (
        input_spec_for,
        save_artifact,
    )

    model = get_model(cfg.model, device=device, generator=torch.Generator(
        device=device).manual_seed(seed))
    out = save_artifact(path, model_config=cfg.model, task="mlm",
                        params=to_flax(model), step=seed,
                        input_spec=input_spec_for(cfg, "mlm"),
                        source={"seed": seed, "made_by": "chip_smoke.py"})
    del model
    return out


def fleet_post(url: str, path: str, body: dict, headers=None,
               timeout: float = 300.0) -> tuple[int, bytes, dict]:
    """One POST: the status, the raw body and the headers."""
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


class FleetTraffic:
    """FLEET_CLIENTS stdlib threads, each sending ``POST /predict`` of
    FLEET_ROWS rows of FLEET_TOKENS tokens to the fleet, FLEET_PAUSE_S
    apart, until stopped.
    Every request is recorded (sent, answered, status, replica); one that
    is not answered 200 is a failed request."""

    def __init__(self, url: str, vocab: int):
        self.url, self.vocab = url, vocab
        self.stop = threading.Event()
        self.seen: list = []
        self.threads = [threading.Thread(target=self._run, args=(i,),
                                         daemon=True)
                        for i in range(FLEET_CLIENTS)]
        for t in self.threads:
            t.start()

    def _run(self, i: int) -> None:
        import numpy as np

        rng = np.random.default_rng(SEED + 200 + i)
        while not self.stop.is_set():
            rows = int(rng.integers(FLEET_ROWS[0], FLEET_ROWS[1] + 1))
            n = int(rng.integers(FLEET_TOKENS[0], FLEET_TOKENS[1] + 1))
            ids = rng.integers(0, self.vocab, (rows, n)).tolist()
            t0 = time.time()
            try:
                status, _, headers = fleet_post(
                    self.url, "/predict", {"inputs": {"input_ids": ids}})
            except Exception as e:  # noqa: BLE001 — a failed request
                status, headers = repr(e), {}
            self.seen.append((t0, time.time(), status,
                              headers.get("X-DTF-Replica")))
            self.stop.wait(FLEET_PAUSE_S)

    def finish(self) -> None:
        self.stop.set()
        for t in self.threads:
            t.join(300)

    def window(self, t0: float, t1: float) -> tuple[int, list]:
        """The requests in flight at any time in [t0, t1], and those of
        them that failed."""
        inside = [s for s in self.seen if s[0] <= t1 and s[1] >= t0]
        return len(inside), [s[2] for s in inside if s[2] != 200]


def fleet_phase(torch, fa, workdir: str, smi: str, held: dict,
                device: str = "cuda", overrides=()) -> dict:
    """Phase 20 (its text in the module docstring): 20a routing, 20b
    ``kill_replica:0``, 20c ``stall_replica:1``, 20d the rolling reload and
    the ``corrupt_reload`` roll, 20e the session's 409, 20f cli/fleet.py
    itself. Returns the flash kernels' launches of the replicas that
    ended 0. ``device`` and model ``overrides`` (held's own) run it small
    on the CPU, where no kernel launches."""
    import dataclasses

    import numpy as np

    from distributed_tensorflow_framework_torch.core import (
        faults,
        telemetry,
        tracing,
    )
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        load_artifact,
    )
    from distributed_tensorflow_framework_torch.serve.fleet import (
        SESSION_HEADER,
        FleetRouter,
    )

    t_phase = time.perf_counter()
    overrides = [*FLEET_OVERRIDES, *overrides]
    cfg = load_config("configs/bert_base_mlm.yaml", overrides=overrides)
    m = cfg.model
    if device == "cuda" and (m.num_layers, m.hidden_size, m.num_heads,
                             m.attention_impl) != (12, 768, 12, "pallas"):
        raise AssertionError(f"20: the config is no longer BERT-base: {m}")
    v1 = bert_artifact(torch, cfg, os.path.join(workdir, "v1"), SEED, device)
    t_release, held_s = time.time(), time.perf_counter() - held["t0"]
    v1_s = time.perf_counter() - t_phase
    open(held["go"], "w").close()
    # 20f's fleet starts now: its replica's start-up runs beside 20a-20e.
    cli_dir = os.path.join(workdir, "cli")
    cli_log = open(os.path.join(workdir, "cli_fleet.log"), "w")
    env = {k: v for k, v in os.environ.items()
           if k not in ("DTF_FAULTS", "DTF_FAULTS_STATE", FLEET_GO_ENV,
                        FLEET_COUNTS_ENV)}
    # ``python -m`` under this script's watcher (``--watched-module``).
    cli_proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--watched-module",
         "distributed_tensorflow_framework_torch.cli.fleet", "--artifact",
         v1, "--device", device, "--replicas", "1",
         *sum((["--set", o] for o in (*overrides, "serve.port=0",
                                      f"serve.log_dir={cli_dir}")), [])],
        env=env, stdout=cli_log, stderr=subprocess.STDOUT,
        start_new_session=True)
    cli_proc.own_session = True
    _FLEET_PROCS.append(cli_proc)
    t_v2 = time.perf_counter()
    v2 = bert_artifact(torch, cfg, os.path.join(workdir, "v2"), SEED + 1,
                       device)
    v2_s = time.perf_counter() - t_v2
    digests = {v: load_artifact(v).content_digest for v in (v1, v2)}

    pending = list(held["procs"])

    def launcher(index: int):
        if index < len(pending) and pending[index] is not None:
            out, pending[index] = pending[index], None
            return out  # a held first start, released above
        return held["launch"](index)

    router_dir = os.path.join(workdir, "router")
    os.makedirs(router_dir)
    events = os.path.join(router_dir, "events.jsonl")
    writer = telemetry.TelemetryWriter(events)
    recorder = tracing.FlightRecorder(cfg.trace.ring_size,
                                      dump_dir=router_dir).attach(writer)
    router = FleetRouter(dataclasses.replace(cfg.serve, port=0,
                                             **FLEET_KNOBS),
                         telemetry_writer=writer, launcher=launcher,
                         flight_recorder=recorder)
    thread = threading.Thread(target=router.serve_forever, daemon=True)
    thread.start()
    router.spawn_replicas(FLEET_REPLICAS)
    router.start()
    url = f"http://{router.host}:{router.port}"
    traffic = None

    def replicas() -> dict:
        return {r["replica"]: r for r in
                router.fleet_healthz()["fleet"]["replicas"]}

    def wait_for(what: str, predicate, timeout: float = 240.0):
        deadline = time.monotonic() + timeout
        while not predicate():
            if time.monotonic() > deadline:
                raise AssertionError(f"20: timed out waiting for {what}: "
                                     f"{replicas()}")
            time.sleep(0.05)

    def ejects(label: str, action: str, after: float) -> list:
        writer.flush()
        return [e["t"] for e in telemetry.read_events(
                    events, kind=telemetry.KIND_SERVE_EJECT)
                if e["extra"].get("replica") == label
                and e["extra"].get("action") == action
                and e["t"] >= after]

    try:
        if not router.wait_ready(timeout=300.0):
            raise AssertionError(f"20: the replicas never came up: "
                                 f"{replicas()}")
        startup = {r: round(ejects(r, "readmit", t_release)[0] - t_release, 2)
                   for r in ("r0", "r1")}
        log(f"20 fleet of {FLEET_REPLICAS} replicas (BERT-base, serve.data=-1,"
            f" decode on) admitted; started held {held_s:.1f} s before their "
            f"release, release to admission {startup} s; the artifacts "
            f"written in {v1_s:.1f} s (v1, before the release) and "
            f"{v2_s:.1f} s (v2, beside the start-up)")

        # 20a: each answer through the fleet against the same request sent
        # to the replica that served it, alone.
        rng = np.random.default_rng(SEED + 20)
        urls = {k: r["url"] for k, r in replicas().items()}
        checks, first = [], None
        for _ in range(FLEET_CHECKS):
            rows = int(rng.integers(FLEET_ROWS[0], FLEET_ROWS[1] + 1))
            n = int(rng.integers(FLEET_TOKENS[0], FLEET_TOKENS[1] + 1))
            body = {"inputs": {"input_ids": rng.integers(
                0, m.vocab_size, (rows, n)).tolist()}}
            status, raw, headers = fleet_post(url, "/predict", body)
            label = headers.get("X-DTF-Replica")
            d_status, d_raw, _ = fleet_post(urls[label], "/predict", body)
            got = json.loads(raw)["outputs"]
            arr = np.asarray(got, np.float32)
            checks.append((status, d_status, label, got == json.loads(d_raw)[
                "outputs"], arr.shape == (rows, n, m.vocab_size)
                and bool(np.isfinite(arr).all())))
            first = first or (body, got)
        log(f"20a routing: {len(checks)} requests of {FLEET_ROWS} rows x "
            f"{FLEET_TOKENS} tokens; (fleet, direct) statuses "
            f"{sorted({c[:2] for c in checks})}, served by "
            f"{[c[2] for c in checks]}, bit-equal to the serving replica "
            f"alone {sum(c[3] for c in checks)}/{len(checks)}, shapes and "
            f"finite {sum(c[4] for c in checks)}/{len(checks)}")
        if not all(c[:2] == (200, 200) and c[3] and c[4] for c in checks) or {
                c[2] for c in checks} != {"r0", "r1"}:
            raise AssertionError(f"20a: {checks}")

        # 20b: kill_replica:0 at the fleet_chaos point, under traffic.
        traffic = FleetTraffic(url, m.vocab_size)
        with router._lock:
            tick = router._chaos_tick + FLEET_KILL_TICKS
        t_kill = time.time()
        faults.install(f"kill_replica:0:{tick}")
        wait_for("r0's restart and readmission", lambda: (
            replicas()["r0"]["restarts"] == 1
            and replicas()["r0"]["state"] == "admitted"), 300.0)
        dead, restart = ejects("r0", "eject", t_kill), ejects(
            "r0", "restart", t_kill)
        readmit = ejects("r0", "readmit", t_kill)
        dumps = [json.load(open(os.path.join(router_dir, f)))
                 for f in os.listdir(router_dir)
                 if f.startswith("flightrec-")]
        n_req, failed = traffic.window(t_kill, readmit[0])
        log(f"20b kill_replica:0 at chaos tick {tick}: eject (dead) "
            f"{dead[0] - t_kill:.2f} s after the plan, supervised restart "
            f"{restart[0] - dead[0]:.2f} s later, readmitted "
            f"{readmit[0] - restart[0]:.2f} s after the restart (its "
            f"start-up), eject to readmit {readmit[0] - dead[0]:.2f} s; "
            f"{n_req} requests in the window, {len(failed)} failed; flight "
            f"recorder dumps {[d['reason'] for d in dumps]} "
            f"({[d['event_count'] for d in dumps]} events) [{smi}]")
        if failed or [d["reason"] for d in dumps] != [
                "replica r0 dead (rc=-9)"]:
            raise AssertionError(f"20b: failed {failed}, dumps "
                                 f"{[d['reason'] for d in dumps]}")

        # 20c: stall_replica:1 while a request is in flight on it.
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            with router._lock:
                if router._replicas[1].inflight >= 1:
                    break
            time.sleep(0.005)
        with router._lock:
            inflight = router._replicas[1].inflight
        t_stall = time.time()
        router._apply_chaos(faults.FaultPlan.parse(
            f"stall_replica:1:{FLEET_STALL_S:g}s").faults[0])
        time.sleep(FLEET_STALL_S)
        wait_for("r1's SIGCONT and admission", lambda: (
            router._replicas[1].stalled_until == 0.0
            and replicas()["r1"]["state"] == "admitted"), 120.0)
        eject = ejects("r1", "eject", t_stall)
        readmit = ejects("r1", "readmit", t_stall) or [float("nan")]
        n_req, failed = traffic.window(t_stall, max(readmit[0], time.time()))
        log(f"20c stall_replica:1:{FLEET_STALL_S:g}s with {inflight} requests "
            f"in flight on r1: ejected {[round(t - t_stall, 2) for t in eject]}"
            f" s after the SIGSTOP, readmitted {readmit[0] - t_stall:.2f} s "
            f"after it ({readmit[0] - t_stall - FLEET_STALL_S:.2f} s after "
            f"the SIGCONT); {n_req} requests in the window, {len(failed)} "
            f"failed [{smi}]")
        if failed or not eject:
            raise AssertionError(f"20c: failed {failed}, ejects {eject}")

        # 20d and 20e: the rolling reload to v2 under traffic, while a
        # decode session pinned to one replica keeps asking.
        gen = {"prompt": rng.integers(0, m.vocab_size, 8).tolist(),
               "max_new_tokens": FLEET_NEW_TOKENS}
        session = {SESSION_HEADER: "chip-smoke"}
        status, raw, headers = fleet_post(url, "/generate", gen, session)
        pinned = headers.get("X-DTF-Replica")
        if status != 200 or json.loads(raw.splitlines()[-1]).get(
                "done") is not True:
            raise AssertionError(f"20e: /generate {status} {raw[-200:]}")
        asks, stop_asking = [], threading.Event()

        def ask():
            while not stop_asking.is_set():
                st, _, hd = fleet_post(url, "/generate", gen, session)
                asks.append((time.time(), st, hd.get("X-DTF-Replica"),
                             hd.get("Retry-After")))
                time.sleep(0.05)

        asker = threading.Thread(target=ask, daemon=True)
        asker.start()
        # The cold engine on v2 (for after the roll) is built beside it.
        cold: list = []
        warming = threading.Thread(target=lambda: cold.append(
            InferenceEngine(load_artifact(v2), cfg.serve, device=device)),
            daemon=True)
        warming.start()
        t_roll = time.time()
        status, raw, _ = fleet_post(url, "/reload", {"artifact_dir": v2})
        t_rolled = time.time()
        # The session lands again once its replica is readmitted.
        wait_for("the session's answer after its 409s", lambda: any(
            a[1] == 200 and a[0] > max([b[0] for b in asks if b[1] == 409],
                                       default=t_rolled) for a in asks), 60)
        stop_asking.set()
        asker.join(60)
        traffic.finish()
        rolled = json.loads(raw)
        n_req, failed = traffic.window(t_roll, t_rolled)
        now = {k: r["artifact"].get("content_digest")
               for k, r in replicas().items()}
        log(f"20d rolling reload to v2 under traffic: status {status}, "
            f"{[(r['replica'], r['ok'], round(r['reload_ms'])) for r in rolled.get('replicas', [])]}"
            f" (replica, ok, ms), {t_rolled - t_roll:.2f} s; {n_req} requests "
            f"in the roll, {len(failed)} failed; digests {now} (v2 "
            f"{digests[v2][:12]})")
        if status != 200 or not rolled.get("reloaded") or set(
                now.values()) != {digests[v2]} or failed:
            raise AssertionError(f"20d: {rolled}, failed {failed}")
        statuses = [a[1] for a in asks]
        conflict = [a for a in asks if a[1] == 409]
        after = [a for a in asks if a[1] == 200 and conflict
                 and a[0] > conflict[-1][0]]
        log(f"20e /generate with {SESSION_HEADER}: pinned to {pinned}; "
            f"during the roll {len(asks)} asks, statuses "
            f"{sorted(set(statuses))}, {len(conflict)} x 409 with "
            f"Retry-After {sorted({a[3] for a in conflict})} while it "
            f"drained, then 200 on {sorted({a[2] for a in after})}")
        if not conflict or not all(a[3] and float(a[3]) > 0
                                   for a in conflict) or not after or {
                a[2] for a in after} != {pinned} or set(statuses) - {
                200, 409}:
            raise AssertionError(f"20e: {asks}")

        # After the roll: a request alone against a cold engine on v2.
        body = first[0]
        status, raw, _ = fleet_post(url, "/predict", body)
        got = np.asarray(json.loads(raw)["outputs"], np.float32)
        warming.join(300)
        try:
            want = cold[0].predict({"input_ids": np.asarray(
                body["inputs"]["input_ids"], np.int32)}, timeout=300)
        finally:
            cold[0].drain(30)
        log(f"20d after the roll, one request alone vs a cold engine on v2: "
            f"bit-equal {np.array_equal(got, want)}, largest gap "
            f"{float(np.abs(got - want).max()):.3e} [{smi}]")
        if status != 200 or not np.array_equal(got, want):
            raise AssertionError("20d: the rolled fleet disagrees with a "
                                 "cold engine on v2")
        # The corrupt_reload roll: refused at r0, v2 kept everywhere.
        bad = os.path.join(workdir, "v1_corrupt")
        shutil.copytree(v1, bad)
        faults.install("corrupt_reload:chip-smoke")
        status, raw, _ = fleet_post(url, "/reload", {"artifact_dir": bad})
        rolled = json.loads(raw)
        kept = {k: r["artifact"].get("content_digest")
                for k, r in replicas().items()}
        log(f"20d corrupt_reload roll: status {status}, "
            f"{[(r['replica'], r['status']) for r in rolled.get('replicas', [])]}"
            f"; digests kept {set(kept.values()) == {digests[v2]}}")
        if status != 409 or [(r["replica"], r["status"])
                             for r in rolled["replicas"]] != [("r0", 409)] \
                or set(kept.values()) != {digests[v2]}:
            raise AssertionError(f"20d corrupt_reload: {rolled}")

        # 20f: cli/fleet.py itself through its endpoint, then SIGTERM.
        endpoint = os.path.join(cli_dir, "endpoint.json")
        wait_for("cli/fleet.py's endpoint.json", lambda: os.path.exists(
            endpoint) or cli_proc.poll() is not None, 240.0)
        time.sleep(0.2)
        with open(endpoint) as fh:
            record = json.load(fh)
        status, raw, headers = fleet_post(record["url"], "/predict",
                                          first[0])
        same = status == 200 and json.loads(raw)["outputs"] == first[1]
        with open(os.path.join(cli_dir, "r0", "endpoint.json")) as fh:
            cli_replica = json.load(fh)["pid"]
        t_term = time.perf_counter()
        cli_proc.send_signal(signal.SIGTERM)
        rc = cli_proc.wait(120)
        try:
            os.kill(cli_replica, 0)
            replica_gone = False
        except ProcessLookupError:
            replica_gone = True
        log(f"20f cli/fleet.py --device {device} --replicas 1: role "
            f"{record['role']}, /predict {status} bit-equal to 20a's answer "
            f"on v1 {same}; SIGTERM: exit {rc} in "
            f"{time.perf_counter() - t_term:.2f} s, its replica ended "
            f"{replica_gone}")
        if record["role"] != "fleet" or not same or rc != 0 or (
                not replica_gone):
            raise AssertionError("20f: cli/fleet.py")
    finally:
        if traffic is not None:
            traffic.finish()
        faults.install(faults.FaultPlan())
        router.shutdown("chip_smoke")
        thread.join(60)
        writer.close()
        stop_fleet_procs()
        cli_log.close()
    summary = telemetry.summarize_events(events)["fleet"]
    ended = []
    for name in sorted(os.listdir(os.path.join(workdir, "launches"))):
        with open(os.path.join(workdir, "launches", name)) as fh:
            ended.append(json.load(fh))
    done = [r for r in ended if r["rc"] == 0]
    log(f"20 router: {summary['requests']} proxied, routed "
        f"{summary['routed']}, retries {summary['retries']}, shed "
        f"{summary['shed']}, readmits {summary['readmits']}, restarts "
        f"{summary['restarts']}; replicas that wrote counts "
        f"{[(r['replica'], r['rc'], r['counts']['fwd']) for r in ended]} "
        f"(replica, rc, forward launches)")
    if len(done) != FLEET_REPLICAS or not all(
            r["counts"]["fwd"] > 0 or device != "cuda" for r in done):
        raise AssertionError(f"20: replicas ended {ended}")
    log(f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(r["counts"][k] for r in done) for k in KERNEL_NAMES}


# --------------------------------------------------------------- phase 21

# Phase 21: the composed training meshes, four gloo ranks on the card.
# 21a: phase 15's MoE setting (MOE, the flash kernels, bf16, dropout 0.1,
# clipping 1.0) at full width through the Trainer at COMPOSE_MOE_MESH:
# the batch is split over expert (16 rows a data-parallel rank), each
# rank holds E/2 experts of F/2 and 6 of the 12 heads. Depth cut to
# COMPOSE_LAYERS (the fewest with a MoE layer) and COMPOSE_STEPS steps to
# keep the script inside its time limit.
COMPOSE_RANKS = 4
COMPOSE_LAYERS = 2
COMPOSE_STEPS = 3
COMPOSE_TRAIN = (f"model.num_layers={COMPOSE_LAYERS}",
                 f"train.total_steps={COMPOSE_STEPS}",
                 "train.log_interval=1", "train.eval_steps=0",
                 "train.eval_interval=0", "resilience.rollback=false",
                 "checkpoint.directory=")
COMPOSE_MOE_MESH = ("mesh.data=1", "mesh.expert=2", "mesh.model=2")
COMPOSE_MOE = (*MOE, "data.global_batch_size=32", *COMPOSE_TRAIN)
# 21b: BERT-base with ring attention at rows of 4096 tokens: each seq
# rank's 2048-token chunks take the flash kernels with their lse
# (parallel/ring.py FLASH_CHUNK_MIN), at COMPOSE_RING_MESH with ZeRO-1.
COMPOSE_SEQ = 4096
COMPOSE_RING_MESH = ("mesh.data=1", "mesh.fsdp=2", "mesh.seq=2",
                     "optimizer.zero_sharding=jit")
COMPOSE_LONG = ("model.attention_impl=ring", f"model.max_seq_len={COMPOSE_SEQ}",
                f"data.seq_len={COMPOSE_SEQ}")
COMPOSE_RING = (*COMPOSE_LONG, "data.global_batch_size=4", *COMPOSE_TRAIN)
# The f32 cuts, each against one process on the same batches within
# DP_TOL["bert"] (f32 sums in other orders: the row- and expert-parallel
# reductions, the ring's merge), written before the first run. 21a: 8c's
# cut with MOE. 21b: 8c's cut at 4 rows of 4096 (one process: pallas at
# 4096), under deterministic algorithms with the two-pass backward (the
# fused kernel sums dq by atomics), then a resume: 1 step, a save, a
# restore into a state from another seed and 2 more, bit-equal to the
# cut's own DP_STEPS steps, and the checkpoint read by one process. 21c: 8c's cut
# at 384 wide with 6 heads of 64 over model 4 (the QKV columns split
# inside a head: Q, K and V gathered whole), against one process.
COMPOSE_MOE_CUT = (*DP_BERT[1], *MOE)
COMPOSE_RING_CUT = (*DP_BERT[1], f"model.max_seq_len={COMPOSE_SEQ}",
                    f"data.seq_len={COMPOSE_SEQ}", "data.global_batch_size=4",
                    "checkpoint.async_save=false")
COMPOSE_HEADS_CUT = (*DP_BERT[1], "model.hidden_size=384", "model.num_heads=6",
                     "model.mlp_dim=1536")
COMPOSE_HEADS_MESH = ("mesh.data=1", "mesh.model=4")
COMPOSE_RESUME_STEPS, COMPOSE_RESUME_SPLIT = DP_STEPS, 1


def compose_trainer_run(torch, fa, runtime, out_dir: str, name: str,
                        over) -> dict:
    """21a or 21b on one rank: the Trainer with the launch counts set to 0
    just before and read just after, the heads each attention call saw,
    the parts' shapes, the bytes at rest and the peak memory."""
    import gc

    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.models.bert import (
        MultiHeadAttention,
    )
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    logs = os.path.join(out_dir, f"compose_{name}_logs")
    cfg = load_config(DP_BERT[0], overrides=list(over))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, log_dir=logs, runtime=runtime)
    trainer.build()
    heads = set()
    for module in trainer.state.model.modules():
        if isinstance(module, MultiHeadAttention):
            module.attention_fn = heads_seen(module.attention_fn, heads)
    record = StepRecord()
    reset_counts(fa)
    t0 = time.perf_counter()
    try:
        trainer.train(hooks=trainer.default_hooks() + [record])
    finally:
        trainer.writer.close()
    counts = read_counts(fa)
    seconds = time.perf_counter() - t0
    state = trainer.state
    held = (state.layout.params if state.layout is not None
            else dict(state.model.named_parameters()))
    return {"counts": counts, "heads": sorted(heads), "steps": record.steps,
            "s": seconds, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "bytes": state_bytes(torch, state), "logs": logs,
            "parts": {k: list(held[k].shape) for k in (
                "layer1.moe.wi", "layer1.moe.wo", "layer0.attn.qkv.weight",
                "embed_block.embed.weight") if k in held}}


def compose_cut(torch, fa, runtime, out_dir: str, name: str, over,
                keep: bool = False) -> dict:
    """An f32 cut of DP_STEPS steps on one rank: the losses, grad_norms,
    the whole tensors (saved under ``out_dir``) and the launches; with
    ``keep`` the run itself under ``run``."""
    reset_counts(fa)
    res = zero_cut_case(torch, over, runtime, DP_STEPS,
                        config_path=DP_BERT[0])
    counts = read_counts(fa)
    path = os.path.join(out_dir,
                        f"compose_{name}_rank{runtime.process_index}.pt")
    torch.save(res["tensors"], path)
    return {"losses": res["losses"], "grad_norms": res["grad_norms"],
            "tensors": path, "counts": counts, "bytes": res["bytes"],
            **({"run": res} if keep else {})}


def compose_resume(torch, runtime, out_dir: str, over, straight) -> dict:
    """21b's resume: two legs across a save and a restore into a state
    from another seed against ``straight``, the cut's own run of the
    same steps."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    rank = runtime.process_index
    kw = {"config_path": DP_BERT[0]}
    legs = zero_cut_case(torch, over, runtime, COMPOSE_RESUME_SPLIT, **kw)
    ckpt = os.path.join(out_dir, "compose_resume")
    manager = CheckpointManager(dataclasses.replace(
        legs["builder"].config.checkpoint, directory=ckpt), runtime=runtime)
    manager.save(COMPOSE_RESUME_SPLIT, legs["state"])
    whole = os.path.join(out_dir, f"compose_saved_rank{rank}.pt")
    torch.save(legs["tensors"], whole)
    fresh = zero_cut_case(torch, over, runtime, 0, seed=SEED + 1, **kw)
    restored = manager.restore(fresh["state"])
    manager.close()
    tail = zero_cut_case(
        torch, over, runtime, COMPOSE_RESUME_STEPS - COMPOSE_RESUME_SPLIT,
        state=fresh["state"], builder=fresh["builder"],
        skip=COMPOSE_RESUME_SPLIT, **kw)
    want, got = (list(tensor_leaves(x["state"].state_dict()))
                 for x in (straight, tail))
    return {"restored": restored, "ckpt": ckpt, "whole": whole,
            "losses_equal": tail["losses"] == straight["losses"][
                COMPOSE_RESUME_SPLIT:],
            "tensors": len(want),
            "equal": sum(torch.equal(x, y) for x, y in zip(got, want))}


def compose_rank(torch, fa, out_dir: str) -> dict:
    """One rank of phase 21: a gloo group of four on the card, its
    subgroups formed for each of the phase's meshes
    (``MeshRuntime.remesh``)."""
    from distributed_tensorflow_framework_torch.core.config import (
        MeshConfig,
        load_config,
    )
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
        resolve_mesh,
    )

    runtime = initialize_runtime(MeshConfig(data=-1), "cuda",
                                 backend="gloo")
    rank = runtime.process_index
    # Each mesh's subgroups formed once, not by every step builder.
    rt = {k: runtime.remesh(resolve_mesh(load_config(
        DP_BERT[0], overrides=list(mesh)).mesh, runtime.process_count))
        for k, mesh in (("a", COMPOSE_MOE_MESH), ("b", COMPOSE_RING_MESH),
                        ("c", COMPOSE_HEADS_MESH))}
    try:
        out = {"rank": rank, "backend": runtime.backend, "s": {}}
        t = [time.perf_counter()]
        out["a"] = compose_trainer_run(torch, fa, rt["a"], out_dir, "a",
                                       (*COMPOSE_MOE, *COMPOSE_MOE_MESH))
        torch.cuda.empty_cache()
        out["a_cut"] = compose_cut(torch, fa, rt["a"], out_dir, "a_cut",
                                   (*COMPOSE_MOE_CUT, *COMPOSE_MOE_MESH))
        t.append(time.perf_counter())
        out["b"] = compose_trainer_run(torch, fa, rt["b"], out_dir, "b",
                                       (*COMPOSE_RING, *COMPOSE_RING_MESH))
        torch.cuda.empty_cache()
        over = (*COMPOSE_RING_CUT, *COMPOSE_LONG[:1], *COMPOSE_RING_MESH)
        torch.use_deterministic_algorithms(True)
        try:
            with fused_bwd(fa, False):
                cut = compose_cut(torch, fa, rt["b"], out_dir, "b_cut", over,
                                  keep=True)
                out["resume"] = compose_resume(torch, rt["b"], out_dir, over,
                                               cut.pop("run"))
                out["b_cut"] = cut
        finally:
            torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()
        t.append(time.perf_counter())
        out["c"] = compose_cut(torch, fa, rt["c"], out_dir, "c",
                               (*COMPOSE_HEADS_CUT, *COMPOSE_HEADS_MESH))
        t.append(time.perf_counter())
        out["s"] = {k: t[i + 1] - t[i] for i, k in enumerate("abc")}
        return out
    finally:
        runtime.shutdown()


def compose_wave(workdir: str, hold: bool = False) -> dict:
    """Phase 21's four ranks."""
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}  # for 21b's determinism
    return spawn_children([{"kind": "compose",
                            "env": {**gang_env(port, COMPOSE_RANKS, r), **env}}
                           for port in [free_port()]
                           for r in range(COMPOSE_RANKS)],
                          workdir, "compose_ranks", hold=hold)


def compose_gaps(torch, got: dict, ref: dict, lr: float) -> tuple:
    """The largest relative gaps of the losses and grad_norms, and the
    worst parameter's |diff| (over lr) and leaf, of a cut against one
    process."""
    gaps = {key: max(abs(g - w) / abs(w) for g, w in zip(got[k], ref[k]))
            for key, k in (("loss", "losses"), ("grad_norm", "grad_norms"))}
    tensors = torch.load(got["tensors"], weights_only=True)
    diff, leaf = worst_leaf(torch, tensors, ref["tensors"])
    return gaps, diff / lr, leaf


def compose_phase(torch, fa, workdir: str, smi: str, wave=None) -> dict:
    """Phase 21 (see the module docstring) on ``wave`` (started held
    earlier) or on ranks started here. Returns the attention-kernel
    launches of 21a's and 21b's Trainer runs and 21c, every rank
    (main-path runs)."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    t0 = time.perf_counter()
    wave = wave or compose_wave(workdir)
    release_children(wave)
    # The f32 cuts' one-process references, on the same batches, while
    # the ranks work.
    refs = {}
    for part, one_over in (
            ("a_cut", COMPOSE_MOE_CUT),
            ("b_cut", (*COMPOSE_RING_CUT, "model.attention_impl=pallas")),
            ("c", COMPOSE_HEADS_CUT)):
        with (fused_bwd(fa, False) if part == "b_cut"
              else contextlib.nullcontext()):
            ref = zero_cut_case(torch, one_over, None, DP_STEPS,
                                config_path=DP_BERT[0])
        refs[part] = {k: ref[k] for k in ("losses", "grad_norms", "tensors",
                                          "bytes")}
        refs[part]["lr"] = ref["builder"].config.optimizer.learning_rate
        del ref
        torch.cuda.empty_cache()
    ranks = join_children(wave, timeout=900)
    bad = []
    if [r["backend"] for r in ranks] != ["gloo"] * COMPOSE_RANKS:
        bad.append(("21 backends", [r["backend"] for r in ranks]))
    counts = {k: 0 for k in KERNEL_NAMES}
    tol = DP_TOL["bert"]
    for part, what in (("a", "MoE bert-base bf16 at {data: 1, expert: 2, "
                             "model: 2}, 32x512 (16 rows a data-parallel "
                             "rank)"),
                       ("b", f"bert-base bf16, ring attention at {{data: 1, "
                             f"fsdp: 2, seq: 2}} with ZeRO-1, 4x"
                             f"{COMPOSE_SEQ} (2048-token chunks)")):
        runs = [r[part] for r in ranks]
        events = read_events(runs[0]["logs"])
        meta = next(e for e in events if e["kind"] == "run_meta")["extra"]
        ms = steady_ms(events)
        steps = runs[0]["steps"]
        finite = (sorted(int(k) for k in steps)
                  == list(range(1, COMPOSE_STEPS + 1))
                  and all(math.isfinite(v["loss"])
                          and math.isfinite(v["grad_norm"])
                          for v in steps.values()))
        same = all(r["steps"] == steps for r in runs)
        log(f"21{part} {what}, {COMPOSE_LAYERS} layers, mesh {meta['mesh']}"
            f" (tp leaves {meta.get('tp_sharded_leaves')}, ep leaves "
            f"{meta.get('ep_sharded_leaves')}, zero {meta.get('zero_sharding')})"
            f", {COMPOSE_STEPS} steps through the Trainer: losses " + ", ".join(
                f"step {k} {v['loss']!r}" for k, v in sorted(
                    steps.items(), key=lambda kv: int(kv[0])))
            + f"; equal on every rank {same}, finite {finite}; {ms:.1f} "
            f"ms/step (steps 2-{COMPOSE_STEPS}, chief's clock; gloo through "
            f"the host, not a scaling figure) [{smi}]")
        if not (same and finite):
            bad.append((f"21{part}", same, finite))
        for r in ranks:
            a = r[part]
            log(f"21{part} rank {r['rank']}: parts {a['parts']}, parameters "
                f"{gb(a['bytes']['params'])}, slots {gb(a['bytes']['slots'])}"
                f" at rest, peak {a['peak_gb']:.2f} GB, attention on "
                f"{a['heads']} heads, launches {a['counts']} [{smi}]")
            counts = {k: counts[k] + a["counts"][k] for k in counts}
    moe_want = {"fwd": COMPOSE_LAYERS * COMPOSE_STEPS,
                "dq": COMPOSE_LAYERS * COMPOSE_STEPS,
                "dkv": COMPOSE_LAYERS * COMPOSE_STEPS, "fused": 0}
    # 21b: each layer's forward runs the kernel on the two chunks (its
    # own and the one the ring brings), its backward on both again.
    chunks = 2 * COMPOSE_LAYERS * COMPOSE_STEPS
    for r in ranks:
        a, b = r["a"], r["b"]
        if (a["counts"] != moe_want or a["heads"] != [6]
                or a["parts"].get("layer1.moe.wi") != [2, 768, 1536]):
            bad.append((r["rank"], "21a launches, heads or parts",
                        a["counts"], a["heads"], a["parts"]))
        if (b["counts"]["fwd"] != chunks
                or b["counts"]["fused"] + b["counts"]["dq"] != chunks
                or b["counts"]["dq"] != b["counts"]["dkv"]
                or b["heads"] != [12]):
            bad.append((r["rank"], "21b launches or heads", b["counts"]))
        counts = {k: counts[k] + r["c"]["counts"][k] for k in counts}
    # The f32 cuts against one process on the same batches.
    for part, label in (
            ("a_cut", "21a f32 MoE 2 layers at {data: 1, expert: 2, model: "
             "2}, 8x512"),
            ("b_cut", f"21b f32 2 layers, ring at {{data: 1, fsdp: 2, seq: "
             f"2}} with ZeRO-1 (two-pass backward), 4x{COMPOSE_SEQ}"),
            ("c", "21c f32 2 layers 384 wide, 6 heads at {data: 1, model: "
             "4} (columns split inside a head), 8x512")):
        ref = refs.pop(part)
        got = ranks[0][part]
        gaps, diff, leaf = compose_gaps(torch, got, ref, ref["lr"])
        log(f"{label} vs one process, {DP_STEPS} steps: losses "
            f"{got['losses']} vs {ref['losses']}; largest relative gap loss "
            f"{gaps['loss']:.3e}, grad_norm {gaps['grad_norm']:.3e}; worst "
            f"parameter |diff| {diff:.3e} x lr ({leaf}); tol {tol}; "
            f"launches {got['counts']}; parameters at rest per rank "
            f"{gb(got['bytes']['params'])} against one process's "
            f"{gb(ref['bytes']['params'])}")
        if (gaps["loss"] > tol["loss"] or gaps["grad_norm"] > tol["grad_norm"]
                or diff > tol["params"]
                or any(r[part]["losses"] != got["losses"] for r in ranks)):
            bad.append((part, gaps, diff))
    for r in ranks:
        res = r["resume"]
        log(f"21b rank {r['rank']} resume (deterministic algorithms): "
            f"restored step {res['restored']}; losses after the restore equal"
            f" {res['losses_equal']}; {res['equal']} of {res['tensors']} "
            f"tensors (parameters and ZeRO-1 slot parts) bit-equal to "
            f"{COMPOSE_RESUME_STEPS} straight steps")
        if not (res["restored"] == COMPOSE_RESUME_SPLIT and res["losses_equal"]
                and res["equal"] == res["tensors"]):
            bad.append((r["rank"], "21b resume"))
    res = ranks[0]["resume"]
    cfg = load_config(DP_BERT[0], overrides=[*COMPOSE_RING_CUT,
                                             "model.attention_impl=pallas"])
    one = StepBuilder(cfg, device="cuda").init_state(SEED + 1)
    manager = CheckpointManager(dataclasses.replace(
        cfg.checkpoint, directory=res["ckpt"], allow_reshard=True))
    restored = manager.restore(one)
    manager.close()
    saved = torch.load(res["whole"], weights_only=True)
    loaded = {k: v.cpu() for k, v in one.model.state_dict().items()}
    equal = sum(torch.equal(loaded[k], v) for k, v in saved.items())
    log(f"21b the checkpoint written at {{fsdp: 2, seq: 2}} with ZeRO-1 read "
        f"by one process: restored step {restored}; {equal} of {len(saved)} "
        f"model tensors bit-equal to the parameters at the save")
    if restored != COMPOSE_RESUME_SPLIT or equal != len(saved):
        bad.append(("21b one-process restore", restored, equal))
    if bad:
        raise AssertionError(f"phase 21: {bad}")
    s = ranks[0]["s"]
    log(f"phase 21 took {time.perf_counter() - t0:.1f} s (on rank 0: 21a "
        f"{s['a']:.1f}, 21b {s['b']:.1f}, 21c {s['c']:.1f})")
    return counts



# The lane: phases 11-14, 16, 19 and 21, in this order, in a process of
# their own (``--lane OUT``) beside the main one's phases 4-10 and 15. Its
# waves start held during its phase before theirs, as in the main lane;
# its lines (on the script's clock) are printed when the main lane joins
# it, and what its phases return is read from OUT: the launches of their
# main-path runs (LANE_COUNTS) and 13a's worst errors.
# ---------------------------------------------------------------- phase 22

# Data-parallel serving: DP_SERVE replicas of phase 4's BERT-base artifact
# on the one card (devices [cuda:0, cuda:0]) against one replica, on a
# request of each DP_SERVE_REQUESTS (rows, tokens): odd row counts pad
# with copies of row 0, so each shard holds real and filler rows. Logits
# held to one replica's within the served-logit tolerance of phase 4 (bf16
# activations through 12 layers: a shard's GEMMs run on other row counts),
# each shard's flash forward to its plain version within O_RTOL. Two
# replicas on one card show that the split works, not a speed-up: the
# machine has one card, so no scaling figure exists.
DP_SERVE = 2
DP_SERVE_REQUESTS = ((1, 512), (3, 300), (5, 128))
DP_SERVE_TIMED = 5           # 8 x 512 batches timed per engine and turn
DP_SERVE_TRAFFIC_S = 1.0     # 22c: client traffic before and after reload
DP_DECODE_PROMPTS = 3        # 22e: 17a's first prompts (an odd count)
DP_DECODE_NEW = 8


def engine_ms(engine, request: dict, batches: int) -> float:
    """The engine's compute ms per batch (host clock around the shards'
    forwards and the logits' copy to the host) over ``batches`` requests
    of ``request`` sent one at a time."""
    before = engine.stats()
    for _ in range(batches):
        engine.predict(request, timeout=600)
    after = engine.stats()
    if after["batches"] - before["batches"] != batches:
        raise AssertionError("a timed request did not run as one batch")
    return (after["compute_ms_total"] - before["compute_ms_total"]) / batches


def held_weights(torch, engine, artifact) -> bool:
    """Every replica of ``engine`` holds ``artifact``'s tensors, in the
    replica's dtype."""
    for model in engine.replicas:
        state = model.state_dict()
        for key, want in artifact.state_dict.items():
            got = state[key]
            if not torch.equal(got, want.to(got.device, got.dtype)):
                return False
    return True


def dp_shards(torch, fa, artifact, cfg, smi: str) -> tuple[int, float]:
    """22a and 22b; returns the forward kernel's main-path launches (the
    requests and the timed batches of both engines) and the shards' worst
    o error against the plain version."""
    import dataclasses

    import numpy as np

    from distributed_tensorflow_framework_torch.core.mesh import (
        MeshSizeError,
    )
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
        serving_devices,
    )

    count = torch.cuda.device_count()
    every = [torch.device("cuda", i) for i in range(count)]
    if (serving_devices(-1, "cuda") != every
            or serving_devices(0, "cuda") != every
            or serving_devices(1, "cuda") != every[:1]):
        raise AssertionError("22a: serving_devices disagrees")
    refused = "not tried: more than one card visible"
    if count == 1:
        try:
            InferenceEngine(artifact, dataclasses.replace(cfg.serve, data=2),
                            device="cuda")
        except MeshSizeError as e:
            refused = f"MeshSizeError: {e}"
        else:
            raise AssertionError("22a: serve.data=2 on one card served")
    log(f"22a serving_devices on {count} card(s): -1 and 0 give "
        f"{[str(d) for d in every]}, 1 gives cuda:0; serve.data=2: "
        f"{refused}")

    vocab = artifact.model_config.vocab_size
    rng = np.random.default_rng(SEED + 22)
    requests = []
    for rows, tokens in DP_SERVE_REQUESTS:
        ids = rng.integers(0, vocab, (rows, tokens)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[-1, tokens // 2:] = 0  # the last row's trailing padding
        requests.append({"input_ids": ids, "attention_mask": mask})
    cuda = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    two = InferenceEngine(artifact, cfg.serve, devices=[cuda] * DP_SERVE)
    one = InferenceEngine(artifact, cfg.serve, devices=[cuda])
    kernel = fa.flash_attention_kernel
    plains = {"flash_attention_reference": fa.flash_attention_reference,
              "flash_attention_kb_reference": fa.flash_attention_kb_reference}
    calls, plain = [], []

    def recorded(q, k, v, bias, q_seg=None, kv_seg=None):
        o, lse = kernel(q, k, v, bias, q_seg, kv_seg)
        calls.append((torch.cuda.current_stream(q.device).cuda_stream,
                      (q, k, v, bias, q_seg, kv_seg), o))
        return o, lse

    def counted(name):
        def run(*args, **kwargs):
            plain.append(name)
            return plains[name](*args, **kwargs)
        return run

    try:
        for name in plains:
            setattr(fa, name, counted(name))
        fa.flash_attention_kernel = recorded
        reset_counts(fa)
        got = [two.predict(r, timeout=600) for r in requests]
        two_launches = read_counts(fa, serving=True)["fwd"]
        fa.flash_attention_kernel = kernel
        reset_counts(fa)
        want = [one.predict(r, timeout=600) for r in requests]
        one_launches = read_counts(fa, serving=True)["fwd"]
    finally:
        fa.flash_attention_kernel = kernel
        for name, fn in plains.items():
            setattr(fa, name, fn)
    s2, s1 = two.stats(), one.stats()
    n = len(requests)
    log(f"22b BERT-base at devices [cuda:0] x {DP_SERVE} and [cuda:0]: row "
        f"ladders {s2['row_buckets']} and {s1['row_buckets']}; requests of "
        f"{[list(r) for r in DP_SERVE_REQUESTS]} (rows, tokens), one batch "
        f"each: padded rows {s2['padded_rows']} and {s1['padded_rows']}; "
        f"forward launches {two_launches} ({s2['batches']} batches) and "
        f"{one_launches} ({s1['batches']}); plain versions called {plain}")
    if (s2["batches"], s1["batches"]) != (n, n) or plain or (
            two_launches != 12 * DP_SERVE * n
            or one_launches != 12 * n):
        raise AssertionError("22b: not every shard went through the kernel")
    streams = {stream for stream, _, _ in calls}
    worst = rel = 0.0
    for _, args, o in calls:
        ref, _ = plains["flash_attention_reference"](*args)
        err = (o.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        rel = max(rel, err / ref.float().abs().max().item())
    tol = O_RTOL[str(calls[0][2].dtype).split(".")[-1]]
    log(f"22b each shard's flash forward ({len(calls)} launches on "
        f"{len(streams)} streams, shapes "
        f"{sorted({tuple(args[0].shape) for _, args, _ in calls})}) vs "
        f"flash_attention_reference: o max|err| {worst:.3e}, over the "
        f"launch's max|o| {rel:.3e} (tol {tol}: the layers' o exceeds 1, "
        f"where a bf16 ulp is 2^-7 or more)")
    if rel > tol or len(streams) != DP_SERVE:
        raise AssertionError("22b: a shard's forward disagrees or the "
                             "shards shared a stream")
    del calls
    for (rows, tokens), g, w in zip(DP_SERVE_REQUESTS, got, want):
        gap = np.abs(g - w)
        log(f"22b {rows} x {tokens}: logits {DP_SERVE} replicas vs one: "
            f"bit-equal {np.array_equal(g, w)}, max|gap| {gap.max():.4e} "
            f"(tol {LOGIT_MAX_ATOL}), mean {gap.mean():.4e} (tol "
            f"{LOGIT_MEAN_ATOL}), finite {bool(np.isfinite(g).all())}")
        if g.shape != (rows, tokens, vocab) or not (
                np.isfinite(g).all() and gap.max() <= LOGIT_MAX_ATOL
                and gap.mean() <= LOGIT_MEAN_ATOL):
            raise AssertionError("22b: two replicas disagree with one")

    full = {"input_ids": rng.integers(0, vocab, (8, 512)).astype(np.int32)}
    two.predict(full, timeout=600)  # each engine's 8 x 512 bucket, once
    one.predict(full, timeout=600)
    reset_counts(fa)
    turns = [("one", one), ("two", two), ("two", two), ("one", one)]
    ms = {"one": [], "two": []}
    for name, eng in turns:
        ms[name].append(engine_ms(eng, full, DP_SERVE_TIMED))
    timed = read_counts(fa, serving=True)["fwd"]
    if timed != 12 * (1 + DP_SERVE) * 2 * DP_SERVE_TIMED:
        raise AssertionError(f"22b: {timed} launches in the timed batches")
    peak = torch.cuda.max_memory_allocated()
    log(f"22b engine compute ms per 8 x 512 batch (host clock: the shards' "
        f"forwards and the 8 x 512 x {vocab} f32 logits' copy to the host; "
        f"turns one, two, two, one, {DP_SERVE_TIMED} batches each): one "
        f"replica {[round(x, 3) for x in ms['one']]}, {DP_SERVE} replicas "
        f"{[round(x, 3) for x in ms['two']]}; peak memory of this process "
        f"{peak / 1e9:.3f} GB with three BERT-base replicas up; two "
        f"replicas on one card, not a scaling figure [{smi}]")
    one.drain(60)
    two.drain(60)
    return two_launches + one_launches + timed, worst


def dp_reload(torch, fa, artifact, cfg, workdir: str, smi: str) -> int:
    """22c; returns the forward kernel's launches of the engine under
    traffic (the requests before, during and after the reload)."""
    import numpy as np

    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        load_artifact,
    )

    cuda = torch.device("cuda", 0)
    new_dir = bert_artifact(torch, cfg, os.path.join(workdir, "dp_reload"),
                            SEED + 23)
    new = load_artifact(new_dir)
    vocab = artifact.model_config.vocab_size
    rng = np.random.default_rng(SEED + 23)
    sample = {"input_ids": rng.integers(0, vocab, (3, 128)).astype(np.int32)}
    split = {"input_ids": rng.integers(0, vocab, (4, 256)).astype(np.int32)}
    eng = InferenceEngine(artifact, cfg.serve, devices=[cuda] * DP_SERVE)
    cold = InferenceEngine(new, cfg.serve, devices=[cuda] * DP_SERVE)
    try:
        refs = {"old": eng.predict(sample, timeout=600),
                "new": cold.predict(sample, timeout=600)}
        cold_split = cold.predict(split, timeout=600)
    finally:
        cold.drain(60)
    stop = threading.Event()
    seen: list = []
    failures: list = []

    def client():
        while not stop.is_set():
            t_submit = time.perf_counter()
            try:
                out = eng.predict(sample, timeout=600)
            except Exception as e:  # noqa: BLE001 — counted below
                failures.append(repr(e))
                continue
            gaps = {k: float(np.abs(out - v).max()) for k, v in refs.items()}
            which = min(gaps, key=gaps.get)
            seen.append((t_submit, time.perf_counter(), which, gaps[which]))

    reset_counts(fa)
    batches0 = eng.stats()["batches"]
    clients = [threading.Thread(target=client) for _ in range(2)]
    for c in clients:
        c.start()
    time.sleep(DP_SERVE_TRAFFIC_S)
    t_reload = time.perf_counter()
    result = eng.reload(new_dir, timeout=600)
    t_done = time.perf_counter()
    time.sleep(DP_SERVE_TRAFFIC_S)
    stop.set()
    for c in clients:
        c.join(600)
    got_split = eng.predict(split, timeout=600)
    launches = read_counts(fa, serving=True)["fwd"]
    batches = eng.stats()["batches"] - batches0
    held = held_weights(torch, eng, new)
    eng.drain(60)
    before = {w for _, t, w, _ in seen if t < t_reload}
    after = {w for t, _, w, _ in seen if t > t_done}
    worst = max(g for _, _, _, g in seen)
    gap = float(np.abs(got_split - cold_split).max())
    log(f"22c reload under traffic at {DP_SERVE} replicas: "
        f"{result['reload_ms']:.1f} ms ({result['from_step']} -> "
        f"{result['to_step']}); {len(seen)} requests of 3 x 128 from 2 "
        f"clients, {len(failures)} failed; weights answered before "
        f"{sorted(before)}, after {sorted(after)}, each within "
        f"{worst:.4e} of its cold answer (tol {LOGIT_MAX_ATOL}); every "
        f"replica holds the new tensors {held}; 4 x 256 after the swap "
        f"(two shards) vs a cold engine: bit-equal "
        f"{np.array_equal(got_split, cold_split)}, max|gap| {gap:.4e}; "
        f"{launches} forward launches in {batches} batches [{smi}]")
    if (failures or before != {"old"} or after != {"new"} or not held
            or worst > LOGIT_MAX_ATOL or gap > LOGIT_MAX_ATOL
            or launches != 12 * DP_SERVE * batches):
        raise AssertionError(f"22c: the reload under traffic failed "
                             f"({failures[:3]})")
    return launches


def dp_classify(torch, cifar_dir: str, smi: str) -> None:
    """22d: ResNet-50/CIFAR-10 (17b's artifact, bf16, its BatchNorm
    statistics) at DP_SERVE replicas against one."""
    import numpy as np

    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        load_artifact,
    )

    art = load_artifact(cifar_dir)
    serve = load_config(CIFAR_CONFIG, overrides=[
        "serve.max_batch_size=8", "serve.report_interval_s=60"]).serve
    cuda = torch.device("cuda", 0)
    two = InferenceEngine(art, serve, devices=[cuda] * DP_SERVE)
    one = InferenceEngine(art, serve, devices=[cuda])
    rng = np.random.default_rng(SEED + 24)
    try:
        held = held_weights(torch, two, art)
        for rows in (1, 3, 5):
            images = rng.normal(size=(rows, 32, 32, 3)).astype(np.float32)
            g = two.predict({"image": images}, timeout=600)
            w = one.predict({"image": images}, timeout=600)
            gap = float(np.abs(g - w).max()
                        / max(float(np.abs(w).max()), 1e-30))
            log(f"22d {art.model_config.name} step {art.step}, {rows} rows: "
                f"{DP_SERVE} replicas vs one: bit-equal "
                f"{np.array_equal(g, w)}, largest gap {gap:.3e} of "
                f"max|logit| (bf16 tol {CLASSIFY_RTOL})")
            if g.shape != (rows, 10) or not gap <= CLASSIFY_RTOL:
                raise AssertionError("22d: two replicas disagree with one")
        full = {"image": rng.normal(size=(8, 32, 32, 3)).astype(np.float32)}
        two.predict(full, timeout=600)
        one.predict(full, timeout=600)
        ms = {"one": [], "two": []}
        for name, eng in (("one", one), ("two", two), ("two", two),
                          ("one", one)):
            ms[name].append(engine_ms(eng, full, DP_SERVE_TIMED))
    finally:
        two.drain(60)
        one.drain(60)
    log(f"22d every replica holds the artifact's tensors (BatchNorm "
        f"statistics included) {held}; engine compute ms per 8-row batch "
        f"(turns one, two, two, one): one replica "
        f"{[round(x, 3) for x in ms['one']]}, {DP_SERVE} replicas "
        f"{[round(x, 3) for x in ms['two']]} [{smi}]")
    if not held:
        raise AssertionError("22d: a replica lacks the artifact's tensors")


def dp_decode(torch, artifact, cfg) -> None:
    """22e: the decode engine at DP_SERVE devices: JAX's ladder of dp
    multiples, and one replica's tokens."""
    from distributed_tensorflow_framework_torch.serve.decode import (
        DecodeEngine,
    )
    from distributed_tensorflow_framework_torch.serve.engine import (
        batch_buckets,
    )

    cuda = torch.device("cuda", 0)
    prompts = decode_prompts(artifact.model_config.vocab_size)[0][
        :DP_DECODE_PROMPTS]
    out = {}
    for dp in (DP_SERVE, 1):
        eng = DecodeEngine(artifact, cfg.decode, cfg.serve,
                           devices=[cuda] * dp)
        try:
            streams = [eng.submit(p, max_new_tokens=DP_DECODE_NEW)
                       for p in prompts]
            out[dp] = (eng.row_buckets,
                       [st.result(600)["tokens"] for st in streams])
        finally:
            eng.drain(60)
    ladder = batch_buckets(cfg.decode.max_streams, DP_SERVE)
    log(f"22e decode at devices [cuda:0] x {DP_SERVE}: row ladder "
        f"{out[DP_SERVE][0]} (one device {out[1][0]}); {len(prompts)} "
        f"prompts of {[len(p) for p in prompts]} tokens x {DP_DECODE_NEW} "
        f"new: tokens equal to one device's "
        f"{out[DP_SERVE][1] == out[1][1]}")
    if out[DP_SERVE][0] != ladder or out[DP_SERVE][1] != out[1][1]:
        raise AssertionError("22e: decode at dp disagrees with one device")


def dp_serve_artifacts(torch, workdir: str) -> tuple:
    """``--only 22``'s inputs: phase 4's config and a BERT-base artifact
    from SEED, and a ResNet-50/CIFAR-10 artifact from SEED whose BatchNorm
    statistics are perturbed; returns (the loaded BERT artifact, the
    config, the ResNet artifact's directory)."""
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.models.convert import (
        batch_stats_to_flax,
        to_flax,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        input_spec_for,
        load_artifact,
        save_artifact,
    )

    cfg = load_config("configs/bert_base_mlm.yaml", overrides=[
        "serve.seq_buckets=[128,256,512]", *DECODE_OVERRIDES])
    artifact = load_artifact(bert_artifact(
        torch, cfg, os.path.join(workdir, "bert"), SEED))
    ccfg = load_config(CIFAR_CONFIG)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = get_model(ccfg.model, device="cuda", in_channels=3,
                      generator=gen)
    with torch.no_grad():  # no zero-initialised head: nonzero logits
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, device="cuda", generator=gen))
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.add_(torch.rand(buf.shape, device="cuda", generator=gen))
    cifar_dir = save_artifact(
        os.path.join(workdir, "resnet"), model_config=ccfg.model,
        task="classification", params=to_flax(model),
        batch_stats=batch_stats_to_flax(model), step=SEED,
        input_spec=input_spec_for(ccfg, "classification"),
        source={"seed": SEED, "made_by": "chip_smoke.py"})
    return artifact, cfg, cifar_dir


def dp_serve_phase(torch, fa, artifact, cfg, cifar_dir: str, workdir: str,
                   smi: str) -> tuple[int, float]:
    """Phase 22 (see the module docstring); returns the forward kernel's
    main-path launches and the shards' worst o error."""
    launches, worst = dp_shards(torch, fa, artifact, cfg, smi)
    launches += dp_reload(torch, fa, artifact, cfg, workdir, smi)
    dp_classify(torch, cifar_dir, smi)
    dp_decode(torch, artifact, cfg)
    return launches, worst


LANE_COUNTS = ("zero", "tp", "ring", "pipe", "prec", "gang", "compose")


def lane_main(torch, fa, gpu: str) -> dict:
    """Phases 11-14, 16, 19 and 21 (each described in the module
    docstring); returns their launches by LANE_COUNTS and ``ring_worst``."""
    out = {}
    # Phase 11: ZeRO and FSDP. 11a runs BERT-base through the attention
    # kernels on two ranks in three modes, so its launches join the record.
    zero_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_zero_")
    zero_ranks = zero_wave(zero_dir.name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tp_dir:
        # Phase 12's two ranks start up (held) while phase 11 runs.
        tp_held = tp_wave(tp_dir, hold=True)
        with zero_dir:
            log("phase 11 ZeRO and FSDP: BERT-base on two gloo ranks of the "
                "card through the Trainer, replicated, ZeRO f32 and ZeRO "
                "int8 (11a); FSDP and ZeRO-1 at 8c's cut (11b); a ZeRO "
                "resume (11c)")
            out["zero"] = zero_phase(torch, zero_dir.name, gpu,
                                     wave=zero_ranks)

        # Phase 12: tensor parallelism. 12a runs BERT-base through the
        # attention kernels on two ranks, each on 6 of the 12 heads, so
        # its launches join the record.
        torch.cuda.empty_cache()
        # 13b's eight ranks start up (held) while phase 12 runs.
        ring_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_ring_")
        ring_b_held = ring_b_wave(ring_dir.name, hold=True)
        log("phase 12 tensor parallelism: BERT-base split over two gloo "
            "ranks of the card at {data: 1, model: 2} through the Trainer "
            "(12a); against one process in bf16 (12b) and f32 at 8c's cut "
            "with a resume (12c)")
        out["tp"] = tp_phase(torch, tp_dir, gpu, wave=tp_held)

    # Phase 13: sequence parallelism. 13b runs the long-context recipe as
    # written through the attention kernels on eight ranks, so its
    # launches join the record, and 13a's errors its max_abs_err.
    torch.cuda.empty_cache()
    pipe_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_pipe_")
    # Phase 14's four ranks start up (held) while 13c and 13d run, after
    # 13b, whose eight ranks' start-up they would slow.
    pipe_held = []
    with ring_dir as workdir:
        log("phase 13 sequence parallelism: the kernels with an lse "
            "cotangent (13a); configs/bert_long_ring.yaml as written on "
            "eight gloo ranks of the card (13b); seq 2 at 16384 against one "
            "process (13c); four ranks at {data: 2, seq: 2} in f32, packed, "
            "both chunk routes, with a resume (13d)")
        out["ring_worst"], out["ring"] = ring_phase(
            torch, fa, workdir, gpu, after_b=lambda: pipe_held.append(
                pipe_wave(pipe_dir.name, hold=True)), b_wave=ring_b_held)

    # Phase 14: pipeline parallelism. 14a runs BERT-base through the
    # attention kernels on four stages under three schedules, so its
    # launches join the record.
    torch.cuda.empty_cache()
    with pipe_dir:
        log("phase 14 pipeline parallelism: BERT-base on four gloo stages "
            "of the card at {data: 1, pipe: 4} through the Trainer under "
            "gpipe, 1f1b and interleaved (14a); f32 at {data: 2, pipe: 2} "
            "against one process with a resume (14b)")
        out["pipe"] = pipe_phase(torch, pipe_dir.name, gpu,
                                 wave=pipe_held[0])

    # Phase 16: the precision pack and remat. 16a, 16a' and 16b train
    # BERT through the attention kernels (16a' on their f32 variants), and
    # 16e's two ranks run ZeRO with and without the fused update, so their
    # launches join the record.
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prec_") as workdir:
        log("phase 16 precision and remat: BERT-base under remat policies "
            "(16a) and f32 activations (16a'); the long-context config at "
            "8192 with dots_saveable (16b); ResNet-50/CIFAR-10 under remat "
            "(16c); the int8 products, LeNet-5 and ResNet-50 on them (16d); "
            "the fused ZeRO update on two gloo ranks (16e)")
        out["prec"] = precision_phase(torch, fa, workdir, gpu)

    # Phase 19: the gang supervisor. Its relaunched ranks and the refit
    # survivor run BERT-base through the attention kernels, so their
    # launches join the record.
    torch.cuda.empty_cache()
    compose_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_compose_")
    # Phase 21's four ranks start up (held) while phase 19 runs.
    compose_held = compose_wave(compose_dir.name, hold=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gang_") as workdir:
        log("phase 19 elastic and gang resilience: cli/train_cluster.py "
            "over two gloo ranks of the card at {data: 2}, BERT-base at "
            "full width and 2 layers; kill_worker against a control gang "
            "(19a), drop_worker and the refit (19b), the mesh gate in one "
            "process (19c)")
        out["gang"] = gang_phase(torch, workdir, gpu)

    # Phase 21: the composed training meshes. 21a and 21b train BERT-base
    # through the attention kernels on four ranks, 21c at a cut, so their
    # launches join the record.
    torch.cuda.empty_cache()
    with compose_dir:
        log("phase 21 the composed training meshes: MoE BERT-base at {data: "
            "1, expert: 2, model: 2} (21a), BERT-base with ring attention at "
            "4096 tokens on {data: 1, fsdp: 2, seq: 2} with ZeRO-1 (21b), "
            "6 heads over model 4 (21c), on four gloo ranks of the card")
        out["compose"] = compose_phase(torch, fa, compose_dir.name, gpu,
                                       compose_held)
    return out


def start_lane(workdir: str) -> dict:
    """Start ``--lane`` in ``workdir``: its stdout and stderr go to files
    there until :func:`join_lane`."""
    out = os.path.join(workdir, "lane.json")
    logs = [open(os.path.join(workdir, f"lane.{n}"), "w")
            for n in ("out", "err")]
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--lane", out],
        env={**os.environ, START_ENV: repr(_START)}, stdout=logs[0],
        stderr=logs[1])
    return {"proc": proc, "logs": logs, "out": out,
            "t0": time.perf_counter()}


def join_lane(lane: dict, timeout: float = 1500.0) -> dict:
    """Wait for the lane, print its lines (its stdout here, its stderr to
    this stderr) and return what it wrote; a lane that failed fails the
    script."""
    t0 = time.perf_counter()
    try:
        rc = lane["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        lane["proc"].kill()
        rc = lane["proc"].wait()
    for fh, dest in zip(lane["logs"], (sys.stdout, sys.stderr)):
        fh.close()
        with open(fh.name) as src:
            dest.write(src.read())
        dest.flush()
    log(f"the lane (phases 11-14, 16, 19, 21): exit {rc} after "
        f"{time.perf_counter() - lane['t0']:.1f} s, the main lane's wait "
        f"for it {time.perf_counter() - t0:.1f} s")
    if rc != 0 or not os.path.exists(lane["out"]):
        raise AssertionError(f"the lane exited {rc}")
    with open(lane["out"]) as fh:
        return json.load(fh)


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else None
    if mode in ("--gang-supervisor", "--rank-worker", "--replica-worker",
                "--child", "--lane", "--watched-module"):
        watch_parent()
    else:
        os.environ[PARENT_ENV] = str(os.getpid())
    if mode == "--gang-supervisor":
        # A phase-19 supervisor (stdlib only: no torch in this process).
        return gang_supervisor(sys.argv[2:])
    if mode == "--watched-module":
        # 20f's cli/fleet.py: the module run as ``python -m`` runs it, in
        # a process that ends, with its session (its replica), when the
        # script does.
        import runpy

        sys.argv = sys.argv[2:]
        runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
        return 0
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if mode == "--rank-worker":
        # One rank of a phase-19 gang, started by cli/train_cluster.py.
        return rank_worker(sys.argv[2:])
    if mode == "--replica-worker":
        # One replica of phase 20's fleet, started by its router.
        return replica_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    if mode == "--child":
        # A child ends as soon as its result is written: its process
        # groups are shut down and its files closed, and the interpreter's
        # exit (CUDA's teardown) would only hold up its wave.
        rc = child_main(sys.argv[2])
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    try:
        from distributed_tensorflow_framework_torch.core.device import (
            gpu_name_and_power_limit,
        )
        from distributed_tensorflow_framework_torch.ops import _build
        from distributed_tensorflow_framework_torch.ops import (
            flash_attention as fa,
        )
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable ({e}) — "
              f"run from the repository root", file=sys.stderr)
        return 2
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    signal.signal(signal.SIGTERM, terminated)
    if mode == "--lane":
        global _START
        _START = float(os.environ.get(START_ENV, _START))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build_all()  # the main lane's build, reused
        out = lane_main(torch, fa, gpu_name_and_power_limit().splitlines()[0])
        with open(sys.argv[2] + ".tmp", "w") as fh:
            json.dump(out, fh, default=float)
        os.replace(sys.argv[2] + ".tmp", sys.argv[2])
        return 0
    only = sys.argv[2] if mode == "--only" else None

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power_limit()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")

    if only == "11":
        # A development run of phase 11 alone (``--only 11``), after the
        # kernels' build: no kernels line and no last line.
        gpu = smi.splitlines()[0]
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_zero_") as wd:
            zero_phase(torch, wd, gpu)
        return 0
    if only == "12":
        # A development run of phase 12 alone (``--only 12``), after the
        # kernels' build: no kernels line and no last line.
        gpu = smi.splitlines()[0]
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as wd:
            tp_phase(torch, wd, gpu)
        return 0
    if only == "13":
        # A development run of phase 13 alone (``--only 13``), after the
        # kernels' build: no kernels line and no last line.
        gpu = smi.splitlines()[0]
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ring_") as wd:
            ring_phase(torch, fa, wd, gpu)
        return 0
    if only == "14":
        # A development run of phase 14 alone (``--only 14``), after the
        # kernels' build: no kernels line and no last line.
        gpu = smi.splitlines()[0]
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_pipe_") as wd:
            pipe_phase(torch, wd, gpu)
        return 0
    if only == "15":
        # A development run of phase 15 alone (``--only 15``), after the
        # kernels' build: no kernels line and no last line.
        gpu = smi.splitlines()[0]
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as wd:
            moe_phase(torch, fa, wd, gpu)
        return 0
    if only == "16":
        # A development run of phase 16 alone (``--only 16``), after the
        # kernels' build: no kernels line and no last line.
        gpu = smi.splitlines()[0]
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_prec_") as wd:
            precision_phase(torch, fa, wd, gpu)
        return 0
    if only == "17":
        # A development run of phase 17 alone (``--only 17``): phase 4 for
        # its artifact and its decode-enabled server, then 17a, 17c, and
        # 17b on two checkpoints of a short config-2 run.
        gpu = smi.splitlines()[0]
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p17_") as wd:
            _, served = serve_phase(torch, fa, wd)
            decode_phase(torch, served["artifact"], served["config"], wd, gpu)
            registry_phase(torch)
            data = os.path.join(wd, "cifar")
            os.makedirs(data)
            write_cifar(data)
            ckpt = os.path.join(wd, "ckpt_cifar")
            for steps in (2, 4):
                if run_cli_train(CIFAR_CONFIG, [
                        f"data.data_dir={data}",
                        f"checkpoint.directory={ckpt}",
                        f"train.total_steps={steps}", "train.log_interval=1",
                        "train.eval_steps=0"]) != 0:
                    raise AssertionError("17b: the config-2 run failed")
            classify_phase(torch, ckpt, (2, 4), wd, gpu)
        return 0
    if only == "18":
        # A development run of phase 18 alone (``--only 18``): phase 4 for
        # 18b, then 18a (no kernels line, no last line).
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p18_") as wd:
            serve_phase(torch, fa, wd)
            observability_phase(torch, fa, wd, {}, smi.splitlines()[0])
        return 0
    if only == "19":
        # A development run of phase 19 alone (``--only 19``), after the
        # kernels' build: no kernels line and no last line.
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_gang_") as wd:
            gang_phase(torch, wd, smi.splitlines()[0])
        return 0
    if only == "20":
        # A development run of phase 20 alone (``--only 20``), after the
        # kernels' build: no kernels line and no last line.
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as wd:
            fleet_phase(torch, fa, wd, smi.splitlines()[0], fleet_wave(wd))
        return 0
    if only == "21":
        # A development run of phase 21 alone (``--only 21``), after the
        # kernels' build: no kernels line and no last line.
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_compose_") as wd:
            compose_phase(torch, fa, wd, smi.splitlines()[0])
        return 0
    if only == "22":
        # A development run of phase 22 alone (``--only 22``), after the
        # kernels' build, on a BERT-base artifact and a ResNet-50/CIFAR-10
        # one with perturbed BatchNorm statistics, both from seeds: no
        # kernels line and no last line.
        _build.build_all()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p22_") as wd:
            artifact, cfg, cifar_dir = dp_serve_artifacts(torch, wd)
            dp_serve_phase(torch, fa, artifact, cfg, cifar_dir, wd,
                           smi.splitlines()[0])
        return 0
    if only is not None:
        # A development run of phase 9's parts alone (``--only 9bf``): no
        # kernels line and no last line, which only a whole run prints.
        gpu = smi.splitlines()[0]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_rec_") as workdir:
            image_records_phase(torch, workdir, gpu, only.lstrip("9"))
        return 0

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"phase 2 build: {len(built)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    report = {}
    for result in built:
        report.update(build_report(_build, result))
    fused_beside_pair(report)

    stamp = time.perf_counter()
    lanes = []

    def took(what: str) -> None:
        nonlocal stamp
        now = time.perf_counter()
        log(f"{what} took {now - stamp:.1f} s")
        stamp = now
        for lane in lanes:  # a lane that failed fails the script now
            if lane["proc"].poll() not in (None, 0):
                join_lane(lane)

    log("phase 3 kernel parity")
    parity = kernel_parity(torch, fa)
    timing = kernel_timing(torch, fa)
    log("phase 3b backward kernel parity")
    bwd_worst = bwd_kernel_parity(torch, fa)
    bwd_timing = bwd_kernel_timing(torch, fa)
    log("phase 3c long-context kernel parity")
    long_worst = long_kernel_parity(torch, fa)
    long_timing = long_kernel_timing(torch, fa)
    took("phases 2-3c")
    # Phases 11-14, 16, 19 and 21 run in a process of their own, the lane,
    # beside phases 4-10 and 15 in this one: their ranks wait on the host
    # (gloo, start-ups) and leave the card idle much of the time. Phase
    # 20, whose drills time their ejects and readmissions, runs after both.
    lane_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_lane_")
    lane = start_lane(lane_dir.name)
    lanes.append(lane)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        log("phase 4 serve")
        launches, served = serve_phase(torch, fa, workdir)
        log(f"serve summary: {served['requests']} HTTP requests + 2 engine "
            f"requests, {served['batches']} batches, {launches} kernel "
            f"launches")
        took("phase 4")
        t17 = time.perf_counter()
        log("phase 17a decode at BERT-base width, phase 4's artifact")
        decode_phase(torch, served["artifact"], served["config"], workdir,
                     smi.splitlines()[0])
        bert = {k: served[k] for k in ("artifact", "config")}  # phase 22's
        del served
        log("phase 17c a registered model and dataset through the Trainer")
        registry_phase(torch)
        p17 = {"17a+17c": time.perf_counter() - t17}
        took("phases 17a, 17c")
        log("phase 5 train")
        train_counts, full = train_phase(torch, fa, workdir)
        log("phase 5b training parity and learning")
        train_parity_phase(torch, fa)
        log("phase 5c resume and --eval-only")
        resume_phase(torch, fa, workdir, full)
        log("phase 5d recovery ladder and SIGTERM")
        ladder_phase(torch, fa, workdir)
        log("phase 5e export to serve")
        export_phase(torch, fa, workdir, full)
        shutil.rmtree(full["ckpt"])
        took("phases 5-5e")
        log("phase 5f packed training from records")
        packed_counts = packed_phase(torch, fa, workdir)
        took("phase 5f")
        log("phase 18a the profile window, memory analysis and goodput of "
            "BERT-base training through cli.train")
        obs_counts = observability_phase(torch, fa, workdir, full,
                                         smi.splitlines()[0])
        took("phase 18a")
        log("phase 6 long-context training")
        long_counts = [long_train_phase(torch, fa, workdir, seq, route)
                       for seq, route in long_runs(torch, fa)]
    log("phase 6b fused vs two-pass backward at S=8192")
    step_8192, forced_launches = long_fused_parity_phase(torch, fa)
    took("phases 6-6b")

    # Phase 7: image classification. No attention kernel lies on this
    # path; its convolutions, BatchNorm and GEMMs are cuDNN and cuBLAS.
    torch.cuda.empty_cache()
    gpu = smi.splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_img_") as workdir:
        log("phase 7a LeNet-5 on MNIST, config 1 as written")
        lenet_phase(torch, workdir, gpu)
        log("phase 7b ResNet-50 on CIFAR-10, config 2 on one card")
        cifar_data, cifar_ms = cifar_phase(torch, workdir, gpu)
        log("phase 7c ResNet-50 at 224, config 3's model on its synthetic "
            "fallback")
        imagenet_phase(torch, workdir, gpu)
        log("phase 7d image models on the card vs the CPU, and resume")
        image_parity_phase(torch)
        cifar_det = cifar_resume_phase(torch, workdir, cifar_data)
        took("phase 7")
        # 8a and 8b's child starts up (held) while 17b runs.
        dp_world1 = dp_world1_wave(workdir, full, cifar_det, hold=True)
        t17 = time.perf_counter()
        log("phase 17b ResNet-50/CIFAR-10 served from phase 7d's step-15 "
            "and step-30 checkpoints, reloaded under traffic")
        classify_phase(torch, os.path.join(workdir, "det_resumed"),
                       (CIFAR_RESUME_SPLIT, 2 * CIFAR_RESUME_SPLIT), workdir,
                       gpu)
        p17["17b"] = time.perf_counter() - t17
        took("phase 17b")
        log("phase 22 data-parallel serving: serving_devices (22a); phase "
            f"4's BERT-base artifact at devices [cuda:0] x {DP_SERVE} "
            "against one (22b), reloaded under traffic (22c); 17b's "
            "ResNet-50 artifact (22d); decode (22e)")
        dp_launches, dp_worst = dp_serve_phase(
            torch, fa, bert["artifact"], bert["config"], os.path.join(
                workdir, f"art_{2 * CIFAR_RESUME_SPLIT}"), workdir, gpu)
        del bert
        took("phase 22")
        log(f"phase 17 took {sum(p17.values()):.1f} s (" + ", ".join(
            f"{k} {v:.1f}" for k, v in p17.items()) + ")")
        log("phase 8 data parallel: world 1 over NCCL (8a BERT-base, 8b "
            "ResNet-50/CIFAR-10), two gloo ranks on the card (8c)")
        dp_counts, ms_8a = data_parallel_phase(torch, fa, workdir, full,
                                               cifar_det, cifar_ms, gpu,
                                               world1=dp_world1)
        took("phase 8")

    # Phase 9: ImageNet from records, Inception-v3, the one-device BN. No
    # attention kernel lies on this path either.
    torch.cuda.empty_cache()
    coll_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_coll_")
    coll_held = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rec_") as workdir:
        # 10a's child starts up (held) while 9e and 9f run.
        image_records_phase(
            torch, workdir, gpu, "abcdef", before_e=lambda: coll_held.append(
                coll_world1_wave(coll_dir.name, full, hold=True)))
    took("phase 9")

    # Phase 10: explicit collectives. 10a and 10a' run BERT-base through
    # the attention kernels, so their launches join the record.
    torch.cuda.empty_cache()
    with coll_dir as workdir:
        log("phase 10 explicit collectives: BERT-base under shard_map at "
            "world 1 over NCCL, int8 (10a) and no wire (10a'); two gloo "
            "ranks on the card (10b)")
        coll_counts = collectives_phase(torch, workdir, full, ms_8a, gpu,
                                        world1=coll_held[0])

    # Phase 15: Mixture-of-Experts. 15a serves, 15b trains BERT-base with
    # MoE layers through the attention kernels, and 15d's two ranks run
    # the Trainer expert-parallel, so their launches join the record.
    torch.cuda.empty_cache()
    fleet_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    # Phase 20's replicas start up (held) while phase 15 runs and the
    # lane ends.
    fleet_held = fleet_wave(fleet_dir.name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as workdir:
        log("phase 15 Mixture-of-Experts: BERT-base with 4 experts in every"
            " second layer, top-2, served (15a) and trained at full depth "
            "(15b); f32 correctness at 2 layers (15c); expert parallel on "
            "two gloo ranks of the card at {data: 1, expert: 2} (15d)")
        moe_counts = moe_phase(torch, fa, workdir, gpu)
    took("phases 10 and 15")
    log(f"the main lane (phases 4-10, 15 and 22) took "
        f"{time.perf_counter() - lane['t0']:.1f} s")

    lane_out = join_lane(lane)
    lane_dir.cleanup()
    took("the wait for the lane")

    # Phase 20: the serving fleet. Its replicas serve BERT-base through
    # the forward kernel, so their launches join the record.
    torch.cuda.empty_cache()
    with fleet_dir:
        log("phase 20 the serving fleet: the router in this process over two"
            " BERT-base replicas of the card; routing (20a), kill_replica "
            "(20b), stall_replica (20c), the rolling reload and a "
            "corrupt_reload roll under traffic (20d), a decode session's 409"
            " (20e), cli/fleet.py and its SIGTERM (20f)")
        fleet_counts = fleet_phase(torch, fa, fleet_dir.name, gpu,
                                   fleet_held)
    ring_worst = lane_out["ring_worst"]

    # Launches on the main path: serving, the S=512 training runs (phase 5,
    # phase 5f's packed and unpacked runs, phase 18a's profiled run,
    # phase 8a's world-1 DDP run,
    # phase 10's shard_map runs, phase 11a's and 12a's two-rank runs, both
    # ranks of each), the two long-context runs, 13b's eight ranks and
    # 14a's four stages under each schedule, 15a, 15b and 15d's two ranks,
    # 16a, 16a', 16b and 16e's two ranks, 19's relaunched ranks and its
    # refit survivor, 20's replicas that ended 0, 21's four ranks (21a,
    # 21b, 21c), 22's engines (22b, 22c); those with
    # segment ids all come from phase 5f. Times, bounds and the plain and
    # library times are those at the long-context shapes (phase 3c); "s512" keeps the
    # S=512 ones of phases 3 and 3b. Where auto does not pick the fused
    # kernel on this card, its launches are those of phase 6b's micro-step
    # with FUSED_BWD forced on, and say so.
    launched = {name: train_counts[name] + packed_counts["counts"][name]
                + obs_counts[name]
                + sum(c[name] for c in long_counts) + dp_counts[name]
                + coll_counts[name] + moe_counts[name] + fleet_counts[name]
                + sum(lane_out[phase][name] for phase in LANE_COUNTS)
                for name in KERNEL_NAMES}
    launched["fwd"] += launches + dp_launches
    forced = launched["fused"] == 0
    if forced:
        launched["fused"] = forced_launches
    short = {"fwd": timing, **bwd_timing}
    worst = {"fwd": max(parity["max_abs_err"], dp_worst), **bwd_worst}
    extra = {"fused": {"launches_forced": forced, "step_8192": step_8192}}
    record = {"kernels": [
        {"name": KERNEL_NAMES[name], "route": "cuda", "source": SOURCES[name],
         "units": "bf16 on the tensor cores (mma.sync.m16n8k16), f32 on the "
                  "CUDA cores",
         "replaces": REPLACES[name], "launches": launched[name],
         "segmented_launches": packed_counts["segmented"][name],
         "max_abs_err": max(worst[name], long_worst[name],
                            ring_worst[name]),
         **long_timing[name],
         **({"s512": short[name]} if name in short else {}),
         **extra.get(name, {})}
        for name in KERNEL_NAMES]}
    for k in record["kernels"]:
        log(f"kernel {k['name']}: max_abs_err {k['max_abs_err']}, kernel_ms "
            f"{k['ms']} ({k['tflops']:.1f} TFLOP/s), plain_ms {k['plain_ms']}, "
            f"library_ms "
            f"{k['library_ms']}, bound_ms {k['bound_ms']} ({k['bound_by']}), "
            f"launches {k['launches']}")
    print(json.dumps(record))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for wave in list(_WAVES):
            stop_children(wave)
        stop_fleet_procs()
        if len(sys.argv) < 2 or sys.argv[1] in ("--only", "--lane"):
            left = stop_descendants()
            if left:
                print(f"chip_smoke: stopped {len(left)} process(es) a "
                      f"failure left behind", file=sys.stderr)
    sys.exit(code)
