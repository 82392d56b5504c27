#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`incubator_mxnet_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py [--out results.json] [--profile]

Run from the repository root, on a machine with one CUDA card and `nvcc`.
Each phase fails the run (non-zero exit) on any error:

  1. setup: the card's name and power limit; every CUDA kernel of the
     port is built from `incubator_mxnet_tpu_torch/ops/csrc` (one `nvcc`
     per source, all started together; timed).
  2. paged attention against its plain version on the card at the serving
     shapes (16 lanes, 12 heads x 64, 2048 positions, 12 layers), float32,
     bfloat16 and float16, one query (decode), 4 (the speculative verify) and 256
     (chunk prefill), ragged lengths, and a slab view cut on the position
     axis that must read bit-equal to the full slab; every read must go to
     the route `kernels.paged_route` names (split, wgmma, cuda_cores: the
     launch counters show it); then each case's time against its bound,
     the plain version's time and one PyTorch library call's time. The
     float16 chunk (C = 256, on the tensor cores) must also refuse planted
     truncating and pair-swapping float16 stores and P.V with P in one
     float16 term (emulated), and is timed beside its earlier CUDA-core
     time.
  3. serving at full width: `ContinuousEngine` over a 12-layer, 768-wide
     `CachedDecoder` (vocab 32000, 2048 positions, random weights from a
     seed) answers 16 greedy requests with prompts of 16-1500 tokens, in
     bfloat16 (timed; the paged-attention launch counter must move by
     exactly layers x (decode_steps x decode waves + chunk waves), every
     decode read on the split route and every chunk read on the tensor
     cores), in float16 (the same counts and routes; agreement with the
     1-slot reference read, TTFT and TPOT beside bfloat16's) and in float32
     with TF32 off (decode on split, chunks on the CUDA cores), where every
     request's tokens must equal the 1-slot `reference_generate`.
  4. the training kernels against their plain versions on the card: the
     scale/shift/activation apply at every (rows, channels, activation,
     residual) shape ResNet-50 v1 gives it at batch 32 and 224x224, in
     float32, bfloat16 and float16 (a 16-bit output within one step of its
     type of the plain version's), plus sigmoid, tanh, silu and gelu at one
     shape, then each float32 apply's and the float16 stem apply's time
     against its bound, the plain version's time and, where one PyTorch
     call computes the same function (torch.addcmul in the type), that
     call's time; the NHWC average pool's forward and backward at the global 7x7
     pool of (32, 7, 7, 2048) and a 2x2 pool of (32, 56, 56, 256), in
     float32, bfloat16 and float16, each on the route `kernels.pool_route`
     names: a float32 forward within 1e-5, a 16-bit one at most one step of
     its type from the plain version in at most 0.1% of the elements, and
     the limit must refuse three planted bfloat16 faults (a truncating
     store, the divisor ph*pw - 1, a dropped window position); every
     backward bit-equal. Each pass is timed cold (inputs rotated over
     copies that with their outputs exceed 128 MB, past the 50 MB L2) and
     warm (one input, as the main path finds it), beside the empty-launch
     floor (`torch.cuda._sleep`), its bound, the plain version and the
     library calls (F.avg_pool2d, and torch.mean for the global pool;
     aten.avg_pool2d_backward).
  5. training at full width: `FusedTrainStep` over `resnet50_v1(layout=
     "NHWC")` (1000 classes, random weights from a seed), batch 32 of
     224x224 images made with numpy from a seed, bf16 AMP, SGD momentum
     0.9, lr 0.05, rescale 1/32: 2 warm-up steps, then 10 timed steps with
     finite losses and exactly 53 apply, 1 pool-forward and 1
     pool-backward launches a step; the shapes the apply kernel was given
     must be ResNet-50's; then, in float32 with TF32 off at batch 8, two
     fused steps against two unfused steps from the same weights: the
     losses, and each weight's and running stat's update relative to its
     own norm, must agree. `--profile` adds a
     `torch.profiler` pass over 3 steps (device time by kernel).
  6. the flash-attention kernels (B5 forward, B6 forward + log-sum-exp,
     B7 dq sweep, B8 dk/dv sweep) against their plain versions on the
     card at the BERT path's shape (bh 192 = 16 x 12 heads, T 512, d 64)
     in bfloat16 and float32 (and float16, all four on the tensor cores,
     timed there and at the causal (48, 2048, 128) shape, both also with
     dO scaled by 2^-10 and 2^12, its limits bfloat16's scaled to its
     step, 2^-11 against 2^-8, the planted store faults refused in
     float16 too and its one-term P read, plus a ragged T = 500, d = 384
     and d = 12, the CUDA-core kernels), causal and not,
     plus Tq != Tk causal (rows
     that see no key), a ragged T = 500, head dims 12 (the CUDA-core
     kernels in bf16 too), 32, 40, 96 and 128, 136, 192 and 256 (the
     capacity-256 instances, causal and not, ragged T = 300), and bh 65600
     (T 16, d 16), and head dims 264, 384 and 512 (128-column slices;
     causal and not, ragged T, Tq != Tk; (8, 256, 384) timed); then at the
     path's shape (bf16, no mask) and at a
     causal (48, 2048, 128) bf16 shape each kernel's time against its
     bound, the plain version's time and one SDPA call's (forward for
     B5/B6, backward for B7/B8). All four kernels take bf16 and float16
     at d % 8 == 0 up to 128 on the tensor cores (wgmma, TMA); the launch
     counters must show every such shape there and no other. A bf16 output is held
     to limits relative to its own size, and they must refuse two planted
     store faults (a truncating store, a swapped pair) of o, dq, dk and dv
     at both timed shapes, and a swapped pair of each tensor-core kernel's
     own output; beside them, the readings of a one-term bf16 P in the
     forward (bf16 and float16) and of one-term and plain two-term P and
     dS in the backward (emulated in PyTorch, and in float16 the
     kernels' own scheme: P shifted by 2^15, dS scaled per output row),
     which the kernels' operands avoid.
  7. BERT-base at full width: 12 `TransformerEncoderCell(768, 3072, 12,
     dropout 0.1, gelu, use_flash=True)` between token and positional
     embeddings (vocab 30522, 512 positions) and a LayerNorm + Dense head
     over the vocabulary, random weights from a seed, batch 16 x 512
     tokens and random labels from numpy, bf16 AMP, Adam lr 1e-4: 2
     warm-up and 10 timed steps with finite losses and exactly 12 B6, 12
     B7 and 12 B8 launches a step, every one on the tensor cores,
     then one plain inference forward `net(x)` outside `record()` (no
     `torch.no_grad()`) with exactly 12 B5 launches, all on the tensor
     cores, no B6, nothing taped, and finite logits;
     then, in float32 with TF32 off, dropout 0, 2 layers at full width
     and batch 4, two flash SGD steps against two SDPA-composition steps
     from the same weights: the losses, and each weight's update relative
     to its own norm, must agree, and the same check must refuse a run
     whose flash backward drops delta.

  8. B4's int8 variant and mixed types against the plain version on the
     card at phase 9's shapes (16 lanes over 21 pool rows, 12 layers, 12
     heads x 64, 2048 positions, a non-zero layer, ragged lengths with 0
     and T - C): q float32, bfloat16 and float16 over int8 (codes and
     scales from the engine's quantizer), bfloat16, float16 and float32
     slabs, C in (1, 4 =
     the speculative verify at draft 3, 256 = the chunk), each also on a
     slab and scale view cut on the position axis; float32 outputs within
     phase 2's limit, 16-bit ones within phase 6's limits relative to
     their size; every read on its route, extent views bit-equal. The
     check must refuse two planted faults each run: the kernel fed scales
     one position off, and what a wrong combine of the split pieces would
     give, a lane whose prefix crosses piece boundaries read one position
     long. Then, for bf16 and float16 q over int8 at
     each C, the kernel's time against its bound, the plain version's
     time and SDPA's over the prefix dequantized to q's type beforehand;
     and float16 q at C = 256 on the tensor cores at a peaked softmax (q x
     8) over the float16 and the int8 slab and over int8 with v_scale x
     2^-12, each within float16's limits and timed beside SDPA.
  9. the full decode engine at full width: phase 3's model in bfloat16
     behind `ContinuousEngine(kv_dtype="int8", draft_tokens=3,
     prefix_cache_slots=4, prefix_block=64, max_slots=16,
     prefill_window=256, decode_steps=4)`: one request of a 512-token
     system prefix + 16 tokens (it publishes the prefix), then 15 that
     share the prefix (suffixes of 16-400 tokens) together, then 8 of
     their own (16-1500 tokens); every other request sampled
     (temperature 0.8, top_k 50, top_p 0.95, seed = its index), 64 new
     tokens each. It must show 15 prefix hits, exactly layers x
     (decode_steps x decode waves + chunk waves) int8 launches and no
     float one, every verify read on the split route and every chunk read
     on the tensor cores (float32: split and CUDA cores). Then the same run in float32 with TF32 off: every reply
     must equal the 1-slot `reference_generate` with the same knobs (the
     hits at `cached_prefix_len=512`), and every greedy reply the
     `draft_tokens=0` reference.
 10. the off-flagship shapes the kernels cover (ROADMAP C1), each through
     its kernel, as the launch counters show: `ContinuousEngine(
     CachedDecoder(DecoderConfig(max_len=64)))`, float32, at head_dim 16
     and at 2 heads x 256 and x 384, token-exact against
     `reference_generate`; the paged kernel at head_dim 256, 320 and 512
     over bfloat16 and int8 pools (1, 9 and 40 queries) against its plain
     version; `MultiHeadAttention(384, 2)` and `(768, 2, use_flash=True)`
     (head_dim 192 and 384) forward and gradients against the SDPA
     composition in float32;
     one fused `Dense(10, "relu")` float32 training step equal to the
     unfused one, and one under float16 AMP (the apply's float16 instance)
     within 2^-9; a float16 engine (`DecoderConfig(max_len=64,
     dtype="float16")`, a float16 pool on the card, a 32-position prefill
     window) answering every request with every read on the kernel in
     float16, decode on split and chunks on the tensor cores; the NHWC
     pool at 12 channels (float32, bfloat16 and
     float16), over a 14x14 window, at 70000 x 5 x 5 and 4 x 4096 x 4096
     (past the grid's 65535 rows) and over inputs off 16-byte alignment,
     and the apply at 10 float32 and 4 bfloat16 channels, against their
     plain versions.
 11. the imperative Gluon loop at full width, each step `with
     autograd.record(): loss = L(net(x), y)`, `autograd.backward(loss)`,
     `trainer.step(batch)`, 2 warm-up and 10 timed steps, ms a step and
     tokens or images a second: (a) phase 7's BERT-base built without the
     final LayerNorm's and the head's widths (resolved at the first
     forward), bf16 AMP, batch 16 x 512, `Trainer(..., "lamb", lr 1e-4,
     wd 0.01, epsilon 1e-6, PolyScheduler(max_update 12, pwr 1, warmup
     4))` with wd_mult 0 on beta, gamma and bias: finite losses, exactly
     12 B6, 12 B7 and 12 B8 launches a step on the tensor cores, the
     trainer's learning rate the scheduler's at every step, and the
     gradient copies a step that writing each gradient into its
     Parameter's buffer adds (one per trainable Parameter); (b) ResNet-50
     v1 NHWC, batch 32, bf16 AMP, `fused.set_fusion_default(True)`, NAG
     momentum 0.9, wd 1e-4, lr 0.1 x 32 / 256 with a warmed-up
     CosineScheduler: exactly 53, 1 and 1 launches a step; (c) (a)'s model
     and batch under float16 AMP (`amp.init_trainer`, `amp.scale_loss`,
     `amp.step_with_overflow_check`), 2 + 3 steps, every B6, B7 and B8 on
     its float16 tensor-core kernel, one plain inference forward `net(x)`
     (12 float16 B5 on the tensor cores, no B6),
     then a step with an inf planted in one gradient, which must leave
     every weight bit-equal and halve the scale, its 12 layers' backward
     inputs (the loss scaler's magnitudes) held against the plain
     versions within phase 6's float16 limits; (d) float32, TF32 off,
     dropout 0, 2 layers at full width, batch 4: two Trainer-loop Adam
     steps against two FusedTrainStep Adam steps, and grad_req "add" over
     two half-batches against "write" over the batch (SGD with momentum),
     held as phase 7 holds flash against SDPA.
 12. the Gluon script surface at full width: (a) GluonCV's
     train_imagenet.py recipe on `resnet50_v2(layout="NHWC")` (1000
     classes): `initialize(initializer.MSRAPrelu())` (each convolution
     weight's std within 3% of MXNet's fan formula on the card), bf16 AMP,
     `fused.set_fusion_default(True)`, wd_mult 0 on beta, gamma and bias,
     phase 11 (b)'s NAG and cosine schedule over 12 steps, one-hot labels
     smoothed by 0.1 through `SoftmaxCrossEntropyLoss(sparse_label=False)`,
     `gluon.utils.split_and_load` from the host and `metric.RMSE` on the
     softmax every step, batch 32 x 224^2: finite losses, the apply
     kernel given the 51 predicted shapes, exactly 51 apply, 1
     pool-forward and 1 pool-backward launches a step; (b)
     `FusedInferStep` on (a)'s net, 8 chained calls at batch 32: exactly
     51 apply and 1 pool-forward launches a call, no pool backward,
     nothing taped, `Accuracy` and `TopKAccuracy(5)` over the logits; (c)
     one float32 ResNet-50 v2 step (TF32 off) fused against unfused from
     the same MSRAPrelu weights at batch 4, phase 5's limits; (d) the
     apply kernel against its plain version at every shape of (a) in
     float32 and bfloat16 (phase 4's limits), the data BN's C = 3 and the
     final BN's (1568, 2048) timed against the bound and torch.addcmul;
     (e) the new layers (1-D and 3-D convolutions, the transposed ones,
     the pools, the norms, the activations, ReflectionPad2D, a
     concatenation) forward and backward on the card in float32 against
     the CPU (1e-5, TF32 off) and in bfloat16 within two steps of the type,
     MobileNet v2's inference forward in float32, and Conv1D NWC / Conv3D
     NDHWC with relu in a fusion scope on the apply kernel (the NC layouts
     not).
 13. detection and the rest of the zoo at full width: (a) GluonCV's
     ssd_300_vgg16_atrous + train_ssd.py: `ssd_300_vgg16(classes=20,
     layout="NHWC")`, bf16 AMP, the fusion default on, the imperative
     loop, SGD lr 0.001 momentum 0.9 wd 5e-4, examples/ssd_amp.py's loss
     (targets with hard negatives at ratio 3, cross-entropy ignoring -1,
     Huber on loc x mask), batch 32 x 300^2 with 1-8 synthetic boxes an
     image: 2 warm-up and 8 timed steps, finite losses, exactly 23 apply
     launches a step at the 23 predicted shapes (bf16, bias + ReLU) and no
     other launch, `multibox_target`'s ms, B1 (bias + ReLU) against its
     plain version in float32 and bfloat16 at every distinct shape of the
     step and at the families' (32, 4096), and at conv1's (2880000, 64)
     bf16 against its bound and its plain version, timed; (b) `net.detect` on the
     batch (NMS 0.45, threshold 0.01): one NMS-sweep launch, its keep mask
     bit-equal to the plain sweep's on the same sorted rows (IoU tests
     counted), the decoded ids, scores and boxes bit-equal with the plain
     sweep, `box_nms` at (32, 8732, 6) with and without force_suppress
     bit-equal, a planted fault (a kept row nudged to just over the
     threshold against an earlier kept row of its class) refused, and the
     kernel on it bit-equal; the kernels bit-equal to the plain sweep at
     A = 1, 63, 64, 65 and 8732 (with classes, one class and none); the
     kernels' (and, by torch.profiler, the mask pass's and the sweep's),
     the plain sweep's and detect()'s times beside the earlier one-block
     kernel's, the mask pass's IoU tests and bytes and the workspace's
     bytes, and VOC07 mAP; (c) `alexnet`, `vgg16_bn`, `squeezenet1.1`,
     `densenet121` (224^2) and `inceptionv3` (299^2) at batch 32, bf16 AMP:
     FusedTrainStep steps and an inference `net(x)`, exactly 2/2/0/0/0
     apply launches a step and a call, no pool launch; (d) phase 7's
     BERT-base through `FusedTrainStep(remat=None | "full" | "dots")`: peak
     memory, ms a step, exactly 12 / 24 / 24 B6 and 12 B7 and B8 launches
     a step, all on the tensor cores; then one float32 SGD step (lr 1)
     under each policy of 2 BERT layers (dropout 0.1) and VGG-11 with BN
     (dropout) from the same weights and dropout seed: losses, updates and
     running statistics within 1e-6 of remat=None's; (e)
     `Embedding(32000, 768, sparse_grad=True)` through the Trainer with
     Adam on 16 x 512 token ids: untouched rows bit-equal, touched rows
     bit-equal to a dense Adam step's, the update's time beside a dense
     update's.

 14. the array frontend (`mx.np`, `mx.npx`, NDArray) on the card: (a)
     bench.py's eager step as the JAX package writes it (`mx.np.array`
     inputs, `loss_fn(net(x), y).mean()`, `L.backward()`,
     `trainer.step(32, ignore_stale_grad=True)`, `L.wait_to_read()`,
     `mx.waitall()`) on ResNet-50 v1 NHWC at batch 32 x 224^2, bf16 AMP,
     the fusion default on, SGD momentum 0.9: 4 warm-up and 8 timed
     steps, images/s and ms a step, exactly phase 11 (b)'s B1/B2/B3
     launches a step, the NDArray dispatches a step (`engine.stats()`),
     no host fallback; beside it the host µs an eager op takes to issue
     (a chained `x + 1.0` through NDArray and on the bare tensor, and the
     dispatch alone: `invoke` of a function that launches nothing); then in
     float32 (TF32 off, deterministic algorithms) the NDArray step and the
     tensor loop from the same weights and batches, bit-equal after 2
     steps; (b) `npx.flash_attention` on NDArrays at (192, 512, 64) bf16
     and float16 and causal (48, 2048, 128) bf16: B5 outside `record()`,
     B6 + B7 + B8 under it with `attach_grad` / `backward`, every launch on
     the tensor-core counters, bit-equal to `ops.attention.flash_attention`
     on the same tensors and within phase 6's limits of the plain versions,
     and float32 NDArrays under bf16 AMP reaching B5 as bf16; (c)
     `npx.paged_attention` at phase 2's serving shapes, C = 1 (split) and
     C = 256 (wgmma), over a bf16 slab and an int8 slab with scales,
     bit-equal to `ops.fused.paged_attention`; (d) the npx fused ops at the
     ResNet-50 stem's and global pool's shapes in float32, bfloat16 and
     float16 (B1 once an op, B2 and B3 for the pool), each within phase
     4's limits of its plain version, the pool's backward bit-equal; (e)
     `npx.box_nms` at (32, 8732, 6): one NMS launch, bit-equal to
     `ops.contrib.box_nms`, its keep mask bit-equal to the plain sweep's,
     then by class with and without force_suppress, one launch each;
     (f) every registered np / npx name on the card against the same call
     on the CPU (per-dtype limits, TF32 off), with no host fallback; (g)
     out-of-range gathers (ROADMAP C7): `ContinuousEngine` over a small
     float32 decoder answers a prompt with a token past the vocabulary
     (equal to the prompt with the last row, the clamped gather) and then
     the next request, NDArray indexing clamps and `np.take` fills, and
     the context still runs.
     Every kernel entry of the JSON line gains `npx_launches`: its
     launches through NDArray / npx in (a)-(e), counted around those calls
     only.
 15. the input path: (0) the machine's host facts (CPU count, PIL,
     libjpeg's header, the decode route); (a) a .rec of 1024 records
     written from a seed (256-320 x 256-352 JPEGs at quality 85 with PIL;
     without it the 12 small payloads of tests/data/tiny_imagerec.rec
     cycled, and a "reduced" line); (b) the augment kernel
     (`ops/csrc/image_augment.cu`) against its plain version on the same
     draws, bit-equal, at (32, 224, 224, 3) uint8 to bfloat16, float32
     and float16, (32, 256, 256, 3) cropped to 224 with a mirror and
     (256, 224, 224, 3) (each timed against its bytes bound and the plain
     version, GB/s beside it), a float32 input with its gradient (equal to
     the CPU's), and `AUGMENT_ROWS`: every other input type (int8, bool,
     int16, int32, int64), C = 1 under a 3-entry mean, C = 4 under a cut,
     an unaligned view, 5 channels, a 70-entry mean, rows too wide for a
     stage, a pixel too wide to stage, ragged tails; each on the route
     `kernels.augment_route` names, by its counter; a changed flip bit
     must be refused, and on the "table" route the table emulated in
     plain torch must equal the kernel and one entry one unit in the last
     place off must be refused; then the empty-launch floor, `copy_` of a
     bf16 tensor of the output's size and (`--profile`) the kernel's
     device time at batch 32 and 256; (c) ResNet-50 v1 NHWC at batch 32,
     bf16 AMP, phase 5's `FusedTrainStep` SGD, fed by `ImageRecordIter` (shuffled,
     random crop from a 256 shorter side, mirror, ImageNet mean/std,
     uint8 handoff, the augment kernel on the card, bf16, shared-memory
     decode workers): 4 warm-up and 12 timed steps, images/s and ms a
     step beside phase 5's synthetic-batch step, `io_stats()` a batch,
     exactly 1 augment launch a batch (on "table") and 53/1/1 B1/B2/B3
     launches a step (`--profile`: device ms, idle share, H2D copies overlapping
     kernels); without any JPEG decoder the step is fed from a
     `DataLoader` through the device feed instead; (d) decoded images/s
     on the host with workers=0 and with min(8, cpu_count) workers, and
     `DataLoader(num_workers=2)` in spawned processes equal to
     `num_workers=0` on the card, its workers without a CUDA context;
     (e) (c)'s first batch: the staged uint8 half bit-equal to a CPU
     iterator's from the same file and seed, the fed batch bit-equal to
     the kernel and the plain augment on the same draws.

 16. crash-consistent training (`fault`, `checkpoint`, `run_resilient`):
     (a) the flagship LM (`models.transformer`, `TransformerConfig()`:
     vocab 32000, 12 x 768, 12 x 64 heads, d_ff 3072, bf16 compute,
     float32 masters, tied embeddings) takes its AdamW step at batch 8 x
     2048 on one fixed batch: 3 warm-up and 10 timed steps, ms a step,
     tokens/s and peak memory (`--profile`: device ms, idle share); the
     loss must fall; a float32 step (2 layers, batch 2 x 512, TF32 off)
     equals the plain composition (autograd, then AdamW leaf by leaf)
     within 1e-6 of each leaf's norm; (b) with TF32 off and deterministic
     algorithms, `run_resilient` over (a)'s step with the depth cut to 2,
     10 steps, a save every 3: an injected `resilient.step:6:error` and a
     resume from step 3 bit-equal (params and both moments) to the
     uninterrupted run, `resilient.loss:2:nan` skipped (the state equal to
     steps 0, 2, 3), `resilient.step:4:ioerror` retried once (equal to the
     uninterrupted step 6), `resilient.step:5:stall:30` aborted by a 2 s
     watchdog, each save's seconds and bytes; then
     `tools/torch_crashtest.py --device cuda --model lm` at that width
     (batch 2 x 2048): real SIGKILLs at the 7th step and inside the 2nd
     save, each resumed in a fresh process bit-equal, no partial step
     visible; (c) phase 11 (b)'s ResNet-50 loop (deterministic): 6 steps
     against 3, `checkpoint.save_checkpoint(net, trainer=)`, a fresh net
     and Trainer through `load_checkpoint(net=, trainer=)` and 3 more:
     values, optimizer states and `num_update` bit-equal, 53/1/1 launches
     a step; (d) phase 3's engine (depth cut to 2) one request at a time:
     `serve.execute:3:error` fails the third request only and the others
     equal a clean engine's tokens, `serve.enqueue:1:ioerror` fails one
     submit only, B4 launches; (e) `ImageRecordIter` (256 records, 4 shm
     workers, the augment kernel) with `io.imagerec:2:ioerror` and
     `DeviceFeed` with `io.device_feed:2:ioerror`: batches bit-equal to a
     clean epoch, one restart counted, one augment launch a batch; a
     persistent rule (`2+`) raises the original error. The kernels' JSON
     entries gain `resilient_launches`: B1-B3 over (c)'s resumed steps, B4
     over (d)'s faulted run, the augment over (e)'s faulted epoch.
 17. serving through the deployment path (`deploy`, `serve.Server`,
     `serve.Fleet`): (a) `BucketedModel.export_block` of ResNet-50 v1
     (NHWC, random weights from a seed) at buckets 1, 8 and 32 under bf16
     AMP, seconds and bytes a bucket; each bucket's `torch.export` graph
     holds exactly 53 `mxtorch.scale_shift_act` and 1
     `mxtorch.avg_pool2d_fwd` nodes, and a run moves B1 by 53 and B2 by 1;
     (b) `serve.Server` over it: 8 client threads submit 96 single images
     made from a seed, each reply within 8 bf16 steps (2^-8) of its
     image's largest logit from the eager forward at batch 1; p50/p99,
     rows by bucket, images/s beside phase 12 (b)'s ms a batch, and the
     bucket-32 program alone against the eager forward; the same export
     and server in float32 with TF32 off, within 1e-4; (c) `serve.Fleet`
     of 2 replica processes on the one card at phase 3's width: 16
     float32 greedy requests (16-1500 tokens, 8 new) token-exact against
     `reference_generate`, a SIGKILL of replica 0 with all 16 in flight
     (every one answered token-exact by the survivor, the respawn
     observed), a rolling `swap` to a bf16 "v2" under load with nothing
     lost, bf16 TTFT (a 1-token request's latency) and TPOT through the
     router beside phase 3's engine, and B4's launches in every replica
     process, read from the `replica <i> launches` line of its log. The
     kernels' JSON entries of B1 and B2 gain `deploy_<dtype>_launches`
     ((b)'s servers), B4's `fleet_launches` (the replicas' sum).
 18. telemetry (`telemetry`, `profiler`, `inspect.memory`): (a) phase 5's
     ResNet-50 step (bf16 AMP, batch 32 of 224x224) 10 steps with
     MXNET_TELEMETRY=0, then 10 with it on, each under a
     `telemetry.StepTimeline` whose MFU is `block_fwd_flops` x 3 over
     `device_peak_flops()` (53/1/1 launches a step in both); 2 more steps
     between `profiler.start()` and `stop()`, whose dumped Chrome trace must
     hold the CUDA kernels of B1, B2 and B3 (torch.profiler's records) as
     many times as their launch counters moved; (b) phase 3's engine in
     bfloat16 with MXNET_TRACE_SAMPLE=1 and the profiler on (host events):
     16 greedy requests, each with one `serve.request` span and its own
     trace id, `prefill` / `decode` spans in the same trace,
     `metrics_text()` holding the `serve.*` families under the JAX
     package's names, B4 launched; TTFT / TPOT beside phase 3's; (c) a
     census across the step (parameters, optimizer state and the device
     feed's batches tagged), `leakcheck` over 4 steps (no leak), an
     allocation larger than the card's free memory (`is_oom_error`, and an
     `on_oom` dump holding `torch.cuda.memory_stats()`), and a
     flight-recorder dump written and read back. The kernels' JSON entries
     of B1-B3 gain `telemetry_launches` ((a)'s 20 steps), B4's (b)'s.
 19. the Estimator and the roofline report (`gluon.contrib.estimator`,
     `inspect`): (a) `Estimator.fit` over ResNet-50 v1 (NHWC, 1000
     classes, random weights from a seed, bf16 AMP, the fused Gluon path)
     on a prefetching `gluon.data.DataLoader` of synthetic batches (32 x
     224x224, numpy from a seed), SGD momentum 0.9, 2 epochs x 4 batches,
     with CheckpointHandler, StepTimelineHandler(auto_flops=True),
     validation over 2 batches, LoggingHandler and EarlyStoppingHandler:
     the first step's loss and parameters bit-equal to a hand-written
     record / backward / `trainer.step` from the same weights and batch
     (deterministic cuDNN for that step), exactly 689 / 13 / 8 launches
     (53/1/1 a step, 53/1/0 a validation or FLOPs forward), a finite
     loss; the step time, images/s, MFU and stall share; (b) a fresh net
     resumed from the epoch-2 checkpoint, bit-equal, with 0 more epochs of
     the 2-epoch budget, and a transient fault at `estimator.checkpoint`
     retried until the file lands; (c) `inspect.inspect_step` over one
     training step of the fitted Estimator and over phase 17's bf16
     bucket-32 program (exported afresh when phase 17 did not run): the
     B1-B3 kernel records in the profiled window equal to the launch
     counters, the apply's units at ResNet-50's 53 shapes with
     `kernel_cost`'s flops and bytes, no unit over 105% of its roofline,
     the unattributed share, the top classes and `est_step_mfu_ceiling`.
     The kernels' JSON entries of B1-B3 gain `estimator_launches` ((a)'s
     fit).

The last three lines are the card's name and power limit, one JSON object
with the kernels' numbers (one entry a wrapper, one for each tensor-core
backward sweep, one for each route of the paged kernel, one for each
kernel's float16 instances, their launches from the path that runs them
in float16, the NMS sweep, port-only, its launches from (b), and the
augment kernel, port-only, its launches from phase 15 (c); each with its
phase-14 `npx_launches`), and
`{"ok": true, "device": {...}}`. Without a
card the script exits non-zero and prints no result. It imports nothing of
JAX. Its run time on the card is in the root `PERF.md`.
"""
import argparse
import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import (amp, autograd, gluon, initializer,
                                       lr_scheduler, metric, optimizer,
                                       random, serve)
from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep
from incubator_mxnet_tpu_torch.gluon.model_zoo import detection, vision
from incubator_mxnet_tpu_torch.inspect import roofline
from incubator_mxnet_tpu_torch.ops import attention, contrib, fused, kernels
from incubator_mxnet_tpu_torch.ops import nn as ops_nn

# the H100's published rates (`inspect.roofline`'s spec row): every bound
# below is `roofline.kernel_cost` of the launch over them
H100 = roofline.DEFAULT_CALIBRATIONS["gpu"]
HBM_BYTES_PER_S = H100["peak_bytes_per_sec"]   # 3.35e12
# a 16-bit type's step (unit in the last place, relative): every 16-bit
# limit below is bfloat16's scaled by STEP16[t] / STEP16[bfloat16]
STEP16 = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
TOL = {torch.float32: 1e-4,               # f32 sums in another order
       torch.bfloat16: 2e-2,              # bf16 output rounding dominates
       torch.float16: 2e-2 / 8}
FULL = dict(vocab=32000, embed=768, layers=12, heads=12, head_dim=64,
            mlp_hidden=3072, max_len=2048)
SLOTS, WINDOW, DECODE_STEPS, NEW_TOKENS = 16, 256, 4, 64


def log(*a):
    print(*a, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


HOLD_CYCLES = 50_000_000                  # ~25 ms of the card's clock


def median_ms(fn, reps, warmup=2):
    """Median of `reps` CUDA-event timings of fn(i) (i = repetition). The
    stream is held by a sleep kernel while the host queues every timed
    call, so a short kernel's time is its device time, not the host's
    launch overhead."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    evs = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


# ---------------------------------------------------------------------------
# phase 2: paged attention against its plain version
# ---------------------------------------------------------------------------
def bound_ms(name, **shape):
    """(least ms, "bytes" or "operations") of one launch of kernel `name`
    at `shape`: `roofline.kernel_cost` over the H100's rates."""
    sec, by, _, _ = roofline.unit_bound(roofline.kernel_cost(name, **shape),
                                        H100)
    return sec * 1e3, by


def library_call(q, k_slab, v_slab, lens, layer):
    """One scaled_dot_product_attention call over each lane's gathered
    live prefix with the same mask (the yardstick; the port never calls
    it). Returns (fn, reference output)."""
    S, C, H, D = q.shape
    tmax = min(k_slab.shape[2], int(lens.max()) + C)
    kk = k_slab[:S, layer, :tmax].transpose(1, 2).contiguous()
    vv = v_slab[:S, layer, :tmax].transpose(1, 2).contiguous()
    qq = q.transpose(1, 2).contiguous()
    pos = torch.arange(tmax, device=q.device)
    lim = lens.long()[:, None] + torch.arange(C, device=q.device)[None]
    mask = (pos[None, None, :] <= lim[:, :, None])[:, None]   # (S,1,C,T)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fn(_i):
        return sdpa(qq, kk, vv, attn_mask=mask)
    return fn, fn(0).transpose(1, 2)


PAGED_CS = (1, 4, WINDOW)           # decode, verify (draft 3), chunk
# B4's float16 chunk (C = 256) before it took the tensor cores: the
# cuda_cores route's times by slab type (PERF.md section 6 row 4c,
# `chip_smoke.py --profile` on NVIDIA H100 80GB HBM3, 700.00 W), logged
# beside this run's; a recorded reading, so it stays out of the kernels line
CUDA_CORES_F16_CHUNK_MS = {"float16": 0.6177, "int8": 0.6235}
# the phase 2 case each route's JSON entry reads
PAGED_ROUTE_SHAPES = {"split": ("bfloat16", 1), "wgmma": ("bfloat16", WINDOW),
                      "cuda_cores": ("float32", WINDOW)}


def paged_checked(q, k, v, lens, layer, **sc):
    """One kernel read that must have launched once, on the kernel
    `kernels.paged_route` names, and counted in its type's counter.
    Returns (out, route)."""
    route = kernels.paged_route(q.dtype, k.dtype, q.shape[3], q.shape[1])
    before = kernels.launch_counts()
    out = kernels.paged_attention_cuda(q, k, v, lens, layer, **sc)
    after = kernels.launch_counts()
    moved = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    kind = ("paged_attention_int8" if sc.get("k_scale") is not None
            else "paged_attention")
    assert moved == {kind: 1, f"paged_attention_{route}": 1}, \
        f"paged launches {moved}, expected one on route {route}"
    return out, route


def paged_term_readings(q, k, v, lens, layer, ref):
    """What the limits of q's 16-bit type read if P went into P.V as one
    term of that type, and as the two terms (hi + lo) the tensor-core route
    issues (P from one softmax over each row's live prefix, products and
    sums in f32), against the plain version's output `ref`; emulated in
    PyTorch on the card over a float slab."""
    S, C, H, D = q.shape
    T = k.shape[2]
    kk, vv = k[:S, layer].float(), v[:S, layer].float()
    s = torch.einsum("schd,sthd->shct", q.float(), kk) / math.sqrt(D)
    pos = torch.arange(T, device=q.device)
    lim = lens.long()[:, None] + torch.arange(C, device=q.device)[None]
    live = (pos[None, None, :] <= lim[:, :, None])[:, None]   # (S,1,C,T)
    s = s.masked_fill(~live, float("-inf"))   # position 0 is always live
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    den = p.sum(-1).permute(0, 2, 1)[..., None]               # (S,C,H,1)
    hi = p.to(q.dtype).float()
    out = {}
    for name, pp in (("one_term", hi),
                     ("two_term", hi + (p - hi).to(q.dtype).float())):
        o = (torch.einsum("shct,sthd->schd", pp, vv) / den).to(q.dtype)
        _, ok, read = paged_err(o, ref)
        out[name] = dict(read, ok=ok)
    del p, hi
    return out


def paged_store_faults(q, k, v, lens, layer, ref):
    """The 16-bit limits against planted store faults of the chunk's
    output: the plain version in f32 on the same inputs gives the values a
    16-bit store rounds, `store_faults16` writes them as a faulty store
    would, and the check must refuse each. Returns the readings."""
    out32 = fused.paged_attention_ref(q.float(), k, v, lens, layer)
    readings = {}
    for fault, bad in store_faults16(out32, q.dtype).items():
        _, ok, read = paged_err(bad, ref)
        readings[fault] = read
        assert not ok, f"the {_dtype_name(q.dtype)} paged check passes a " \
            f"{fault}"
    return readings


def check_f16_chunk(q, k_slab, v_slab, lens, layer, ref, rec):
    """Phase 2's float16 chunk on the tensor cores: planted store faults
    refused, the one-term P refused and the two terms within the limits
    (emulated), and the time beside the CUDA cores' earlier one."""
    assert rec["kernel_route"] == "wgmma", rec
    rec["planted_store_faults"] = paged_store_faults(q, k_slab, v_slab,
                                                     lens, layer, ref)
    terms = paged_term_readings(q, k_slab, v_slab, lens, layer, ref)
    rec["p_terms_emulated"] = terms
    max_tol, rms_tol = limits16(q.dtype)
    log(f"[kernels] paged_attention float16 C={WINDOW} (wgmma): planted "
        f"store faults refused {rec['planted_store_faults']}; P.V with P in "
        f"float16 (emulated): one term {terms['one_term']}, two terms "
        f"{terms['two_term']} (limits max_rel {max_tol:.3e}, rms_rel "
        f"{rms_tol:.3e}); {rec['ms']:.4f} ms against "
        f"{CUDA_CORES_F16_CHUNK_MS['float16']} on the CUDA cores before "
        f"(recorded: PERF.md section 6 row 4c), sdpa "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms")
    assert not terms["one_term"]["ok"], \
        "the float16 check passes P.V with one float16 term of P"


def phase_kernels(dev):
    S, H, D, T, L = SLOTS, FULL["heads"], FULL["head_dim"], \
        FULL["max_len"], FULL["layers"]
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (S + 1, L, T, H, D)
    k32 = torch.randn(shape, generator=gen, device=dev)
    v32 = torch.randn(shape, generator=gen, device=dev)
    rng = np.random.RandomState(0)
    lens_np = np.concatenate([[0, 1, 255, 1000, 2047],
                              rng.randint(0, T, S - 5)]).astype(np.int32)
    lens = torch.as_tensor(lens_np, device=dev)
    layer = 5
    variants = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        k_slab, v_slab = k32.to(dtype), v32.to(dtype)
        for C in PAGED_CS:
            q = torch.randn((S, C, H, D), generator=gen, device=dev).to(dtype)
            out, route = paged_checked(q, k_slab, v_slab, lens, layer)
            ref = fused.paged_attention_ref(q, k_slab, v_slab, lens, layer)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            _, ok, read = paged_err(out, ref)
            # a view cut on the position axis, lengths inside the cut:
            # against the plain version on the view, and bit-equal to the
            # full-slab read (the engine's extent ladder relies on it)
            ext = 1280
            lens_e = torch.clamp(lens, max=ext - C)
            out_v, _ = paged_checked(q, k_slab[:, :, :ext],
                                     v_slab[:, :, :ext], lens_e, layer)
            ref_v = fused.paged_attention_ref(
                q, k_slab[:, :, :ext], v_slab[:, :, :ext], lens_e, layer)
            out_f, _ = paged_checked(q, k_slab, v_slab, lens_e, layer)
            torch.cuda.synchronize()
            err_v = (out_v.float() - ref_v.float()).abs().max().item()
            _, ok_v, read_v = paged_err(out_v, ref_v)
            same = torch.equal(out_v, out_f)
            assert torch.isfinite(out.float()).all(), "non-finite output"
            name = f"{str(dtype).split('.')[-1]} C={C} ({route})"
            log(f"[kernels] paged_attention {name}: max_abs_err {err:.3e} "
                f"{read} (view {err_v:.3e} {read_v}, view == full: {same}) "
                f"tol {TOL[dtype]:.0e}")
            # phase 2's absolute limit, and for 16-bit types also phase
            # 6's limits relative to the output's size
            assert err <= TOL[dtype] and err_v <= TOL[dtype] and ok \
                and ok_v, \
                f"paged_attention {name} disagrees with its plain version"
            assert same, f"paged_attention {name}: extent view != full read"
            # timing: rotate over the 12 layers so the live prefix comes
            # from device memory, as in the engine's layer loop
            ms = median_ms(lambda i: kernels.paged_attention_cuda(
                q, k_slab, v_slab, lens, i % L), reps=24)
            plain_ms = median_ms(lambda i: fused.paged_attention_ref(
                q, k_slab, v_slab, lens, i % L), reps=5, warmup=1)
            lib_fn, lib_out = library_call(q, k_slab, v_slab, lens, layer)
            lib_err = (lib_out.float() - ref.float()).abs().max().item()
            lib_ms = median_ms(lib_fn, reps=24)
            bound, bound_by = bound_ms("paged_attention", lengths=lens_np,
                                       C=C, T=T, H=H, D=D, dtype=dtype)
            log(f"[kernels] paged_attention {name}: {ms:.4f} ms, bound "
                f"{bound:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
                f"sdpa {lib_ms:.4f} ms (sdpa max_abs_err {lib_err:.2e})")
            variants.append({
                "dtype": str(dtype).split(".")[-1], "C": C,
                "kernel_route": route, "max_abs_err": err, "tol": TOL[dtype],
                **read,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": lib_ms})
            if dtype == torch.float16 and C == WINDOW:
                check_f16_chunk(q, k_slab, v_slab, lens, layer, ref,
                                variants[-1])
        del k_slab, v_slab
    kernels.reset_launch_counts()   # comparison launches do not count
    return variants, lens_np.tolist()


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------
def make_prompts():
    rng = np.random.RandomState(1)
    sizes = np.linspace(16, 1500, SLOTS).astype(int)
    rng.shuffle(sizes)
    return [rng.randint(1, FULL["vocab"], size=int(n)).tolist()
            for n in sizes]


def serve_run(dtype, prompts):
    cfg = serve.DecoderConfig(**FULL, dtype=dtype)
    model = serve.CachedDecoder(cfg, seed=0)
    eng = serve.ContinuousEngine(model, max_slots=SLOTS,
                                 prefill_window=WINDOW,
                                 decode_steps=DECODE_STEPS)
    eng.start()
    log(f"[serve {dtype}] warmup (kernel load, library init) "
        f"{eng.warmup_s:.3f} s")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    outs = [f.result(timeout=300) for f in futs]
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = eng.stats()
    eng.close()
    for p, o in zip(prompts, outs):
        assert o.dtype == np.int32 and o.shape == (NEW_TOKENS,), \
            f"prompt of {len(p)} tokens gave {o.shape} tokens"
        assert ((o >= 0) & (o < cfg.vocab)).all(), "token id out of range"
    want = cfg.layers * (eng.decode_steps * st["decode_iterations"]
                         + st["chunk_batches"])
    got = launches["paged_attention"]
    log(f"[serve {dtype}] paged_attention launches {got} (expected "
        f"{cfg.layers} layers x ({eng.decode_steps} steps x "
        f"{st['decode_iterations']} decode waves + {st['chunk_batches']} "
        f"chunk waves) = {want})")
    assert got == want and got > 0, "kernel launch count off the main path"
    check_routes(f"serve {dtype}", dtype, cfg, eng, st, launches)
    return model, outs, st, wall, launches


def check_routes(tag, dtype, cfg, eng, st, launches):
    """Every decode (C = 1) or verify (C = draft + 1) read on the split
    route; every chunk read (C = the window) on the tensor cores in
    bfloat16 and float16, on the CUDA cores in float32."""
    reads = cfg.layers * eng.decode_steps * st["decode_iterations"]
    chunks = cfg.layers * st["chunk_batches"]
    chunk_route = "wgmma" if dtype in ("bfloat16", "float16") \
        else "cuda_cores"
    want = {"split": reads, "wgmma": 0, "cuda_cores": 0}
    want[chunk_route] += chunks
    got = {r: launches[f"paged_attention_{r}"] for r in want}
    log(f"[{tag}] paged routes {got} (expected {want})")
    assert got == want, f"{tag}: paged reads off their routes"


def phase_serve(card):
    prompts = make_prompts()
    log(f"[serve] {len(prompts)} greedy requests, prompt lengths "
        f"{sorted(len(p) for p in prompts)}, {NEW_TOKENS} new tokens each")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, outs, st, wall, launches = serve_run("bfloat16", prompts)
    gen_tokens = len(prompts) * NEW_TOKENS
    log(f"[serve bfloat16] {card}: {wall:.3f} s for {gen_tokens} tokens "
        f"({gen_tokens / wall:.1f} tokens/s end to end), decode "
        f"{st['decode_tokens_per_sec']} tokens/s; TTFT p50 "
        f"{st['ttft_p50_ms']} ms p99 {st['ttft_p99_ms']} ms; TPOT p50 "
        f"{st['tpot_p50_ms']} ms p99 {st['tpot_p99_ms']} ms; "
        f"{st['decode_iterations']} decode waves, {st['chunk_batches']} "
        f"chunk waves, {st['prefill_batches']} prefill waves")
    # finite logits of the expected shape from the windowed prefill
    pool = model.new_pool(1)
    toks = torch.as_tensor(np.asarray(prompts[0][:WINDOW] + [0] * max(
        0, WINDOW - len(prompts[0])), dtype=np.int32)[None], device="cuda")
    n = torch.as_tensor([min(WINDOW, len(prompts[0]))], dtype=torch.int32,
                        device="cuda")
    logits = model.prefill_program(WINDOW)(
        model.params, *pool.buffers(), toks, n,
        torch.zeros(1, dtype=torch.int32, device="cuda"))
    assert logits.shape == (1, FULL["vocab"]) and \
        torch.isfinite(logits.float()).all(), "prefill logits not finite"
    bf16_exact = sum(int(np.array_equal(
        o, model.reference_generate(p, NEW_TOKENS, window=WINDOW)))
        for p, o in zip(prompts, outs))
    log(f"[serve bfloat16] {bf16_exact}/{len(prompts)} requests equal the "
        f"1-slot reference (bf16 greedy may part at near-ties; the exact "
        f"check is the float32 run)")
    del model, pool
    torch.cuda.empty_cache()
    f16 = serve_f16(card, prompts, st)
    model32, outs32, st32, wall32, launches32 = serve_run("float32", prompts)
    bad = [len(p) for p, o in zip(prompts, outs32) if not np.array_equal(
        o, model32.reference_generate(p, NEW_TOKENS, window=WINDOW))]
    log(f"[serve float32] {len(prompts) - len(bad)}/{len(prompts)} requests "
        f"token-exact against the 1-slot reference_generate "
        f"({wall32:.3f} s)")
    assert not bad, f"engine != reference for prompts of lengths {bad}"
    return {"wall_s": wall, "tokens": gen_tokens, "launches": launches,
            "float32_launches": launches32,
            "float16_launches": f16["launches"], "float16": f16,
            "stats": st, "bf16_exact": bf16_exact,
            "float32_exact": len(prompts)}


def serve_f16(card, prompts, st_bf16):
    """Phase 3's model and requests in float16: every chunk read on the
    tensor cores, every decode read on the split route (`serve_run`'s
    counts); agreement with the 1-slot reference read, not held (float16
    greedy may part at near-ties, as bfloat16's); TTFT and TPOT beside
    bfloat16's."""
    model, outs, st, wall, launches = serve_run("float16", prompts)
    equal = sum(int(np.array_equal(
        o, model.reference_generate(p, NEW_TOKENS, window=WINDOW)))
        for p, o in zip(prompts, outs))
    tokens = len(prompts) * NEW_TOKENS
    log(f"[serve float16] {card}: {wall:.3f} s for {tokens} tokens "
        f"({tokens / wall:.1f} tokens/s end to end); TTFT p50 "
        f"{st['ttft_p50_ms']} ms p99 {st['ttft_p99_ms']} ms (bfloat16 "
        f"{st_bf16['ttft_p50_ms']} / {st_bf16['ttft_p99_ms']}); TPOT p50 "
        f"{st['tpot_p50_ms']} ms p99 {st['tpot_p99_ms']} ms (bfloat16 "
        f"{st_bf16['tpot_p50_ms']} / {st_bf16['tpot_p99_ms']}); "
        f"{equal}/{len(prompts)} requests equal the 1-slot reference "
        f"(read, not held)")
    del model
    torch.cuda.empty_cache()
    return {"wall_s": wall, "tokens": tokens, "launches": launches,
            "stats": st, "equal": equal}


# ---------------------------------------------------------------------------
# phase 4: the training kernels against their plain versions
# ---------------------------------------------------------------------------
BATCH, IMAGE, CLASSES = 32, 224, 1000
TRAIN_WARMUP, TRAIN_STEPS, CHECK_BATCH, CHECK_STEPS = 2, 10, 8, 2
# elementwise kernels compute in f32 on the CUDA cores whatever the storage
# kernel against plain version: f32 differs only where a transcendental
# rounds differently; bf16 may part by one output rounding step
KTOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2),
        torch.float16: (1e-2 / 8, 1e-2 / 8)}
# fused against unfused float32 training (TF32 off, deterministic cuDNN):
# a random-init ResNet-50 in training mode is ill-conditioned (the two
# paths' BN applies round differently, and 53 batch-statistic BN layers
# amplify that: their step-1 gradients part by a few percent, as the
# unfused float32 gradients part from a float64 run's on the CPU), so the
# check takes two small steps (lr 1e-5) and holds the losses, and each
# leaf's update (value after the steps minus the initial value, weights
# and running stats alike) against the unfused one relative to that
# update's own norm: a dropped update reads 1, a reversed one 2. Sound
# runs on an H100 read a median of 0.08 over the 267 leaves and at most
# 0.20 (the stage-3 bn3 gammas), the same in every run (deterministic
# cuDNN), so the limit is twice that
CHECK_LR = 1e-5
CHECK_LOSS_RTOL = 1e-3
CHECK_UPDATE_RTOL = 0.4
# ResNet-50's global pool and a 2x2 pool, (N, H, W, C) and window
POOL_GLOBAL = ((BATCH, 7, 7, 2048), (7, 7))
POOL_2X2 = ((BATCH, 56, 56, 256), (2, 2))


def resnet50_apply_rows(batch, image):
    """Every launch of the apply kernel in one ResNet-50 v1 forward at
    (batch, image, image, 3), NHWC, as (rows M, channels C, act,
    residual): the stem BN (its relu is a separate Activation), then per
    bottleneck bn1 and bn2 (+relu), the downsample BN of each stage's
    first block, and bn3 (+residual +relu). 53 in all."""
    s = image // 4                      # stem conv s2, then max pool s2
    rows = [(batch * (image // 2) ** 2, 64, None, False)]
    in_c = 64
    for stage, (n, c) in enumerate(zip((3, 4, 6, 3),
                                       (256, 512, 1024, 2048))):
        for b in range(n):
            if b == 0 and stage > 0:
                s //= 2
            m = batch * s * s
            rows += [(m, c // 4, "relu", False)] * 2
            if b == 0 and c != in_c:
                rows.append((m, c, None, False))
            rows.append((m, c, "relu", True))
        in_c = c
    return rows


def _dtype_name(dtype):
    return str(dtype).split(".")[-1]


def _err_ok(out, ref, dtype):
    rtol, atol = KTOL[dtype]
    d = (out.float() - ref.float()).abs()
    return d.max().item(), bool((d <= atol + rtol * ref.float().abs()).all())


def apply_inputs(m, c, residual, dtype, gen, dev):
    x = torch.randn((m, c), generator=gen, device=dev).to(dtype)
    scale = 1.0 + 0.2 * torch.randn((c,), generator=gen, device=dev)
    shift = 0.2 * torch.randn((c,), generator=gen, device=dev)
    res = torch.randn((m, c), generator=gen, device=dev).to(dtype) \
        if residual else None
    return x, scale, shift, res


def check_apply(m, c, act, residual, dtype, gen, dev, timed):
    x, scale, shift, res = apply_inputs(m, c, residual, dtype, gen, dev)
    out = kernels.scale_shift_act_cuda(x, scale, shift, res, act)
    ref = fused.apply_ref(x, scale, shift, res, act)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all(), "non-finite apply output"
    err, ok = _err_ok(out, ref, dtype)
    name = (f"scale_shift_act M={m} C={c} act={act} res={residual} "
            f"{_dtype_name(dtype)}")
    row = {"M": m, "C": c, "act": act, "residual": residual,
           "dtype": _dtype_name(dtype), "max_abs_err": err,
           "tol": KTOL[dtype]}
    if timed:
        row["ms"] = median_ms(lambda i: kernels.scale_shift_act_cuda(
            x, scale, shift, res, act), reps=20)
        row["plain_ms"] = median_ms(lambda i: fused.apply_ref(
            x, scale, shift, res, act), reps=5, warmup=1)
        row["bound_ms"], row["bound_by"] = bound_ms(
            "scale_shift_act", M=m, C=c, dtype=dtype, act=act,
            residual=residual)
        row["library_ms"] = None
        if act is None and not residual and dtype != torch.bfloat16:
            # the rows in x's type beforehand, so the call's output is too
            sh, sc = shift.to(dtype), scale.to(dtype)
            lib = torch.addcmul(sh, x, sc)
            row["library_max_abs_err"] = (lib.float() - ref.float()).abs() \
                .max().item()
            row["library_ms"] = median_ms(
                lambda i: torch.addcmul(sh, x, sc), reps=20)
    log(f"[train kernels] {name}: max_abs_err {err:.3e} "
        + (f"{row['ms']:.4f} ms (bound {row['bound_ms']:.4f} ms, plain "
           f"{row['plain_ms']:.4f} ms, library {row['library_ms']})"
           if timed else ""))
    assert ok, f"{name} disagrees with its plain version"
    return row


# phase 4's pool limits. Forward: float32 within KTOL; a bfloat16 or
# float16 output at most one step of its type (one unit in the last place)
# from the plain version's, in at most POOL_OFF_SHARE of the elements (both
# sum in f32 and round once; two sums in other orders seldom straddle a
# rounding point). Backward: bit-equal in every type (one multiply by
# float32(1 / (ph*pw)) and one rounding on both sides).
POOL_OFF_SHARE = 1e-3
# a cold timing rotates over copies of the inputs, each output kept until
# its copy comes round again, so that a call's inputs and outputs
# together exceed this (the L2 cache holds 50 MB)
COLD_BYTES = 128e6
# the empty-launch floor: torch.cuda._sleep of this many cycles
EMPTY_CYCLES = 1


def _ordered(t):
    """A 16-bit float tensor's values as int32 in value order (+0 and -0
    both 0): neighbouring values of the type differ by one."""
    i = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def pool_fwd_err(out, ref, dtype):
    """(max abs error, ok, readings) of a pool forward against its plain
    version, by the limits above; a 16-bit output is read as
    {"max_steps", "share_off"} (steps of its type, share of elements that
    differ)."""
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        rtol, atol = KTOL[dtype]
        ok = bool((diff <= atol + rtol * ref.float().abs()).all())
        return diff.max().item(), ok, {}
    steps = (_ordered(out) - _ordered(ref)).abs()
    read = {"max_steps": int(steps.max()),
            "share_off": float((steps > 0).float().mean())}
    ok = bool(torch.isfinite(out.float()).all()) and \
        read["max_steps"] <= 1 and read["share_off"] <= POOL_OFF_SHARE
    return diff.max().item(), ok, read


def pool_planted_faults(x, ph, pw):
    """What three faulty bfloat16 forwards would write for x: a truncating
    store of the right f32 mean, a divisor of ph*pw - 1, and a window that
    drops its last position."""
    n, h, w, c = x.shape
    win = x.float().reshape(n, h // ph, ph, w // pw, pw, c)
    total, k = win.sum(dim=(2, 4)), ph * pw
    return {"truncating store": store_faults16(total / k)[
                "truncating store"],
            "divisor ph*pw - 1": (total / (k - 1)).to(x.dtype),
            "dropped window position": ((total - win[:, :, -1, :, -1]) / k)
            .to(x.dtype)}


def cold_ms(fn, inputs, reps=20):
    """median_ms of fn over `inputs` in turn, each output kept until its
    copy comes round again: neither is in L2 when the call starts. The
    warm-up makes one round, so the caching allocator holds every output
    block before the timed calls (a device allocation among them would
    stall the queue)."""
    turn = itertools.count()
    keep = [None] * len(inputs)

    def call(_):
        j = next(turn) % len(inputs)
        keep[j] = fn(inputs[j])
    return median_ms(call, reps, warmup=len(inputs) + 1)


def cold_copies(t, out_numel):
    """Copies of t, enough that they and the outputs of a pass over them
    exceed COLD_BYTES (at least 2)."""
    nbytes = (t.numel() + out_numel) * t.element_size()
    return [t.clone() for _ in range(max(2, -(-int(COLD_BYTES) // nbytes)))]


def check_pool(shape, pool, dtype, gen, dev, timed, floor_ms=None,
               offset=0):
    """The pool's forward and backward against their plain versions (the
    limits above; bfloat16 forwards must also refuse
    `pool_planted_faults`), x read `offset` elements into its buffer (off
    16-byte alignment: one channel a thread), and when `timed`, each pass
    cold and warm against its bound, the plain version and the library
    calls: for the forward F.avg_pool2d on the channels-last view and, for
    the global pool, torch.mean over (1, 2) (the faster is the yardstick);
    for the backward aten.avg_pool2d_backward."""
    n, h, w, c = shape
    ph, pw = pool
    x = torch.randn(n * h * w * c + offset, generator=gen,
                    device=dev).to(dtype)[offset:].view(shape)
    y = kernels.avg_pool2d_fwd_cuda(x, ph, pw)
    y_ref = fused.avg_pool2d_ref(x, (ph, pw))
    dy = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    dx = kernels.avg_pool2d_bwd_cuda(dy, h, w, ph, pw)
    dx_ref = fused.avg_pool2d_bwd_ref(dy, h, w, ph, pw)
    torch.cuda.synchronize()
    err_f, ok_f, read = pool_fwd_err(y, y_ref, dtype)
    err_b = (dx.float() - dx_ref.float()).abs().max().item()
    bit_equal = torch.equal(dx, dx_ref)
    routes = [kernels.pool_route(ph, pw, c, dtype, a.data_ptr() % 16 == 0
                                 and b.data_ptr() % 16 == 0)
              for a, b in ((x, y), (dy, dx))]
    name = f"avg_pool2d {shape} pool {ph}x{pw} {_dtype_name(dtype)}" + \
        (f" at offset {offset}" if offset else "")
    refused = {}
    if dtype == torch.bfloat16:
        refused = {fault: not pool_fwd_err(bad, y_ref, dtype)[1]
                   for fault, bad in pool_planted_faults(x, ph, pw).items()}
    log(f"[train kernels] {name} (routes, channels a thread: forward "
        f"{routes[0]}, backward {routes[1]}): forward max_abs_err "
        f"{err_f:.3e} {read}, backward {err_b:.3e} (bit-equal {bit_equal}); "
        f"planted faults refused: {refused}")
    assert ok_f, f"{name}: the forward disagrees with its plain version"
    assert bit_equal, f"{name}: the backward is not bit-equal to its plain " \
        f"version"
    assert all(refused.values()), f"{name}: a planted fault passed {refused}"
    fwd = {"shape": list(shape), "pool": [ph, pw],
           "dtype": _dtype_name(dtype), "kernel_route": routes[0][0],
           "vec": routes[0][1], "max_abs_err": err_f, **read,
           "planted_refused": refused}
    bwd = {"shape": list(shape), "pool": [ph, pw],
           "dtype": _dtype_name(dtype), "kernel_route": routes[1][0],
           "vec": routes[1][1], "max_abs_err": err_b, "bit_equal": bit_equal}
    if not timed:
        return fwd, bwd
    F = torch.nn.functional
    aten_bwd = torch.ops.aten.avg_pool2d_backward
    xs, dys = cold_copies(x, y.numel()), cold_copies(dy, dx.numel())
    libs = {"F.avg_pool2d": lambda t: F.avg_pool2d(t.permute(0, 3, 1, 2),
                                                   (ph, pw))}
    if (ph, pw) == (h, w):
        libs["torch.mean"] = lambda t: torch.mean(t, dim=(1, 2),
                                                  keepdim=True)

    def lib_bwd(t):
        return aten_bwd(t.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
                        [ph, pw], [ph, pw], [0, 0], False, True, None)
    for row, kernel, plain, cands, inputs, src, ref, out in (
            (fwd, lambda t: kernels.avg_pool2d_fwd_cuda(t, ph, pw),
             lambda t: fused.avg_pool2d_ref(t, (ph, pw)), libs, xs, x,
             y_ref, y),
            (bwd, lambda t: kernels.avg_pool2d_bwd_cuda(t, h, w, ph, pw),
             lambda t: fused.avg_pool2d_bwd_ref(t, h, w, ph, pw),
             {"aten.avg_pool2d_backward": lib_bwd}, dys, dy, dx_ref, dx)):
        row["ms"] = cold_ms(kernel, inputs)
        row["warm_ms"] = median_ms(lambda i: kernel(src), reps=20)
        row["plain_ms"] = median_ms(lambda i: plain(src), reps=5, warmup=1)
        row["bound_ms"], row["bound_by"] = bound_ms(
            "avg_pool2d_fwd", N=n, H=h, W=w, C=c, ph=ph, pw=pw,
            dtype=src.dtype)
        row["floor_ms"] = floor_ms
        row["libraries"] = {}
        for lib, call in cands.items():
            got = call(src) if lib == "torch.mean" \
                else call(src).permute(0, 2, 3, 1)
            row["libraries"][lib] = {
                "ms": cold_ms(call, inputs),
                "warm_ms": median_ms(lambda i: call(src), reps=20),
                "max_abs_err": (got.float() - ref.float()).abs().max()
                .item()}
        row["library"] = min(row["libraries"],
                             key=lambda k: row["libraries"][k]["ms"])
        row["library_ms"] = row["libraries"][row["library"]]["ms"]
        row["library_warm_ms"] = row["libraries"][row["library"]]["warm_ms"]
    for tag, row in (("forward", fwd), ("backward", bwd)):
        log(f"[train kernels] {name} {tag}: cold {row['ms']:.4f} ms, warm "
            f"{row['warm_ms']:.4f} (bound {row['bound_ms']:.4f}, "
            f"{100 * row['bound_ms'] / row['ms']:.0f}% of it cold; empty "
            f"launch {floor_ms:.4f}; plain {row['plain_ms']:.4f}); library "
            + ", ".join(f"{k} cold {v['ms']:.4f} warm {v['warm_ms']:.4f} "
                        f"(max_abs_err {v['max_abs_err']:.2e})"
                        for k, v in row["libraries"].items()))
    return fwd, bwd


def phase_train_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = resnet50_apply_rows(BATCH, IMAGE)
    assert len(rows) == 53, len(rows)
    distinct = sorted(set(rows), key=lambda r: (-r[0], r[1], str(r[2]),
                                                r[3]))
    apply_rows = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for m, c, act, residual in distinct:
            # the main path runs the apply in float32 (the JAX package's
            # AMP class for batch norm): time those shapes; float16 at the
            # stem shape
            apply_rows.append(check_apply(
                m, c, act, residual, dtype, gen, dev,
                dtype == torch.float32 or (dtype == torch.float16
                                           and (m, c, act, residual)
                                           == rows[0])))
        for act in ("sigmoid", "tanh", "silu", "gelu"):
            apply_rows.append(check_apply(25088, 512, act, True, dtype, gen,
                                          dev, False))
    floor_ms = median_ms(lambda i: torch.cuda._sleep(EMPTY_CYCLES), reps=20)
    log(f"[train kernels] empty-launch floor (torch.cuda._sleep("
        f"{EMPTY_CYCLES}), timed as the kernels): {floor_ms:.4f} ms")
    pools = []
    # the main path pools (32, 7, 7, 2048) in bf16, the first row
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for shape, pool in (POOL_GLOBAL, POOL_2X2):
            pools.append(check_pool(shape, pool, dtype, gen, dev, True,
                                    floor_ms))
    kernels.reset_launch_counts()   # comparison launches do not count
    return {"rows": rows, "apply": apply_rows, "pools": pools}


# ---------------------------------------------------------------------------
# phase 5: ResNet-50 v1 training at full width
# ---------------------------------------------------------------------------
def make_batches(n, batch, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, IMAGE, IMAGE, 3).astype(np.float32),
             rng.randint(0, CLASSES, size=batch).astype(np.int32))
            for _ in range(n)]


def new_step(net, batch, use_fusion, lr=0.05):
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    opt = optimizer.create("sgd", learning_rate=lr, momentum=0.9,
                           rescale_grad=1.0 / batch)
    return FusedTrainStep(net, lambda n, x, y: loss_fn(n(x), y).sum(), opt,
                          use_fusion=use_fusion)


def record_apply_shapes(step, x, y):
    """Run one step with the apply wrapper wrapped to record the (M, C,
    act, residual, dtype) of each launch."""
    seen = []
    orig = kernels.scale_shift_act_cuda

    def recording(x2d, scale, shift, residual, act_type):
        seen.append((x2d.shape[0], x2d.shape[1], act_type,
                     residual is not None, x2d.dtype))
        return orig(x2d, scale, shift, residual, act_type)
    kernels.scale_shift_act_cuda = recording
    try:
        step(x, y)
    finally:
        kernels.scale_shift_act_cuda = orig
    return seen


PROFILE_STEPS = 3
# the training kernels' names as the profiler lists them
KERNEL_SYMBOLS = {"scale_shift_act": "scale_shift_act_kernel",
                  "avg_pool2d_fwd": "mx_pool_fwd_",
                  "avg_pool2d_bwd": "mx_pool_bwd_"}


def profile_steps(step, batches, step_ms, symbols=KERNEL_SYMBOLS,
                  tag="train"):
    """torch.profiler over PROFILE_STEPS steps: device time by kernel (the
    rows of device-side events only; operator rows repeat their kernels'
    time), the named kernels' device time per step (`symbols`: {name:
    substring of the kernel's symbol}), and the card's idle share of a
    timed step (one stream: busy time is the sum of kernel times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILE_STEPS):
            step(*batches[i % len(batches)])
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    per_step = total_ms / PROFILE_STEPS
    ours = {name: sum(us for us, key, _ in rows if sym in key) / 1e3
            / PROFILE_STEPS for name, sym in symbols.items()}
    idle = 1.0 - per_step / step_ms
    log(f"[{tag} profile] device time {per_step:.3f} ms per step in "
        f"{len(rows)} kernel names; idle share of a {step_ms:.3f} ms step "
        f"{100 * idle:.1f}%; the port's kernels per step (ms): {ours}; "
        f"top 15 over {PROFILE_STEPS} steps:")
    for us, key, count in rows[:15]:
        log(f"[{tag} profile]   {us / 1e3:9.3f} ms "
            f"{100 * us / 1e3 / max(total_ms, 1e-9):5.1f}% x{count:<5d} "
            f"{key[:90]}")
    return {"device_ms_per_step": per_step, "idle_share": idle,
            "kernels_ms_per_step": ours,
            "top": [{"ms": us / 1e3, "name": key, "count": count}
                    for us, key, count in rows[:40]]}


def phase_train(card, kernel_rows, profile, dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b)
               for b in make_batches(2, BATCH, seed=11)]
    amp.init("bfloat16")
    try:
        net = vision.resnet50_v1(layout="NHWC", classes=CLASSES,
                                 device=dev, seed=0)
        step = new_step(net, BATCH, use_fusion=True)
        t0 = time.perf_counter()
        seen = record_apply_shapes(step, *batches[0])
        for i in range(1, TRAIN_WARMUP):
            step(*batches[i % 2])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        want = [(m, c, a, r, torch.float32) for m, c, a, r in kernel_rows]
        assert sorted(seen, key=str) == sorted(want, key=str), \
            f"apply launches of a step differ from ResNet-50's: {seen}"
        log(f"[train] warm-up {TRAIN_WARMUP} steps {warm_s:.3f} s; one step "
            f"gave the apply kernel ResNet-50's 53 shapes, all float32")
        kernels.reset_launch_counts()
        fused.reset_layout_copies()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step(*batches[i % 2]) for i in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        copies = fused.layout_copies()
        step_ms = wall / TRAIN_STEPS * 1e3
        prof = profile_steps(step, batches, step_ms) if profile else None
    finally:
        amp.uninit()
    losses = [float(v) for v in losses]
    ips = BATCH * TRAIN_STEPS / wall
    log(f"[train bf16] {card}: {TRAIN_STEPS} steps of batch {BATCH} in "
        f"{wall:.3f} s: {step_ms:.3f} ms/step, {ips:.1f} images/s; losses "
        f"{[round(v, 4) for v in losses]}")
    log(f"[train bf16] launches {launches} (expected 53, 1, 1 per step x "
        f"{TRAIN_STEPS}); layout copies made for the kernels: {copies}")
    assert all(np.isfinite(losses)), "non-finite training loss"
    assert launches["scale_shift_act"] == 53 * TRAIN_STEPS \
        and launches["avg_pool2d_fwd"] == TRAIN_STEPS \
        and launches["avg_pool2d_bwd"] == TRAIN_STEPS, \
        "kernel launch count off the main path"
    del net, step
    torch.cuda.empty_cache()
    check = train_f32_check(dev)
    return {"step_ms": step_ms, "images_per_s": ips, "losses": losses,
            "launches": launches, "layout_copies": copies,
            "warmup_s": warm_s, "f32_check": check, "profile": prof}


def _value(v):
    """A `gluon.Parameter`'s tensor, or the tensor itself."""
    return v.data() if isinstance(v, gluon.Parameter) else v


def update_parting(init, a, b):
    """{name: |dA - dB| / |dB|} with dA = a[name] - init[name] and dB the
    same for b: how far one run's update of each value parts from
    another's, relative to the update itself."""
    rel = {}
    for name, w0 in init.items():
        w0, wa, wb = (_value(v) for v in (w0, a[name], b[name]))
        ua = wa.double() - w0.double()
        ub = wb.double() - w0.double()
        norm = ub.norm().item()
        diff = (ua - ub).norm().item()
        rel[name] = diff / norm if norm > 0 else (0.0 if diff == 0 else
                                                  float("inf"))
    return rel


def train_f32_check(dev, build=None, launches_per_step=55,
                    batch=CHECK_BATCH, steps=CHECK_STEPS, tag="train float32"):
    """`steps` fused against `steps` unfused float32 steps (TF32 off, cuDNN
    deterministic) from the same weights and data, at full resolution, lr
    CHECK_LR; `build()` makes the net (default: phase 5's ResNet-50 v1 from
    seed 1), the same weights at every call."""
    if build is None:
        def build():
            return vision.resnet50_v1(layout="NHWC", classes=CLASSES,
                                      device=dev, seed=1)
    x, y = [torch.from_numpy(a).to(dev)
            for a in make_batches(1, batch, seed=12)[0]]
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    nets, losses = [], []
    try:
        for use_fusion in (True, False):
            net = build()
            step = new_step(net, batch, use_fusion, lr=CHECK_LR)
            kernels.reset_launch_counts()
            losses.append([float(step(x, y)) for _ in range(steps)])
            n_launch = sum(kernels.launch_counts().values())
            assert n_launch == (steps * launches_per_step
                                if use_fusion else 0), \
                f"fusion={use_fusion}: {n_launch} launches"
            nets.append(net)
    finally:
        torch.backends.cudnn.deterministic = prev_det
    kernels.reset_launch_counts()
    init = build().collect_params()
    rel = update_parting(init, *(n.collect_params() for n in nets))
    order = sorted(rel, key=rel.get, reverse=True)
    worst = order[0]
    loss_rel = max(abs(p - q) / max(abs(q), 1e-6)
                   for p, q in zip(*losses))
    log(f"[{tag}] fused losses {losses[0]} unfused {losses[1]} "
        f"(max rel {loss_rel:.2e}, tol {CHECK_LOSS_RTOL}); the update of "
        f"each of {len(rel)} weights and stats against the unfused one, "
        f"|dA - dB| / |dB|: median {float(np.median(list(rel.values()))):.3e}"
        f", largest {[(n, f'{rel[n]:.3e}') for n in order[:5]]} (tol "
        f"{CHECK_UPDATE_RTOL})")
    assert all(np.isfinite(losses[0])), "non-finite float32 loss"
    assert loss_rel <= CHECK_LOSS_RTOL, "fused and unfused losses part"
    assert rel[worst] <= CHECK_UPDATE_RTOL, \
        f"fused and unfused updates part at {worst}: {rel[worst]:.3e}"
    return {"lr": CHECK_LR, "batch": batch, "steps": steps,
            "fused_losses": losses[0],
            "unfused_losses": losses[1], "loss_max_rel": loss_rel,
            "update_rel_median": float(np.median(list(rel.values()))),
            "update_rel_worst": rel[worst], "worst_at": worst,
            "update_rel": rel}


def train_entries(tk, train):
    """The kernels' JSON entries for the training path."""
    timed = [r for r in tk["apply"] if "ms" in r and r["dtype"] == "float32"]
    key = {(r["M"], r["C"], r["act"], r["residual"]): r for r in timed}
    per_step = {f: sum(key[row][f] for row in tk["rows"])
                for f in ("ms", "plain_ms", "bound_ms")}
    stem = key[tk["rows"][0]]
    fwd, bwd = tk["pools"][0]
    f32_err = max(r["max_abs_err"] for r in tk["apply"]
                  if r["dtype"] == "float32")
    share = (per_step["ms"] + fwd["ms"] + bwd["ms"]) / train["step_ms"]
    base = "incubator_mxnet_tpu"
    entries = [
        {"name": "scale_shift_act", "route": "cuda",
         "source": "incubator_mxnet_tpu_torch/ops/csrc/scale_shift_act.cu",
         "replaces": f"{base}/ops/pallas_kernels.py:112",
         "launches": train["launches"]["scale_shift_act"],
         "max_abs_err": f32_err, "ms": stem["ms"],
         "plain_ms": stem["plain_ms"], "bound_ms": stem["bound_ms"],
         "bound_by": stem["bound_by"], "library_ms": stem["library_ms"],
         "shape": f"M={stem['M']} C={stem['C']} act=None float32 (the stem "
                  f"BN; library: torch.addcmul)",
         "step_ms": per_step["ms"], "step_plain_ms": per_step["plain_ms"],
         "step_bound_ms": per_step["bound_ms"],
         "variants": tk["apply"]},
        {"name": "avg_pool2d_fwd", "route": "cuda",
         "source": "incubator_mxnet_tpu_torch/ops/csrc/avg_pool2d.cu",
         "replaces": f"{base}/ops/pallas_kernels.py:186",
         "launches": train["launches"]["avg_pool2d_fwd"],
         "max_abs_err": fwd["max_abs_err"], "ms": fwd["ms"],
         "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
         "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
         "warm_ms": fwd["warm_ms"], "floor_ms": fwd["floor_ms"],
         "library_warm_ms": fwd["library_warm_ms"],
         "kernel_route": fwd["kernel_route"],
         "shape": f"{fwd['shape']} pool {fwd['pool']} bfloat16, cold (warm "
                  f"in warm_ms; library: {fwd['library']}, the faster of "
                  f"{sorted(fwd['libraries'])})",
         "variants": [p[0] for p in tk["pools"]]},
        {"name": "avg_pool2d_bwd", "route": "cuda",
         "source": "incubator_mxnet_tpu_torch/ops/csrc/avg_pool2d.cu",
         "replaces": f"{base}/ops/pallas_kernels.py:364",
         "launches": train["launches"]["avg_pool2d_bwd"],
         "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
         "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"],
         "warm_ms": bwd["warm_ms"], "floor_ms": bwd["floor_ms"],
         "library_warm_ms": bwd["library_warm_ms"],
         "kernel_route": bwd["kernel_route"],
         "shape": f"{bwd['shape']} pool {bwd['pool']} bfloat16, cold (warm "
                  f"in warm_ms; library: {bwd['library']})",
         "variants": [p[1] for p in tk["pools"]]},
    ]
    log(f"[train] the three training kernels take {per_step['ms']:.3f} + "
        f"{fwd['ms']:.4f} + {bwd['ms']:.4f} ms of a {train['step_ms']:.3f} "
        f"ms step: {100 * share:.1f}% (bound of the 53 apply launches "
        f"{per_step['bound_ms']:.3f} ms)")
    return entries, share


# ---------------------------------------------------------------------------
# phase 6: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------
# BERT-base (Devlin et al. 2018, sec. 3; GluonNLP's bert_12_768_12): 12
# layers, 768 wide, 12 heads x 64, FFN 3072 (exact-erf GELU), 512
# positions, WordPiece vocabulary 30522, dropout 0.1
BERT = dict(vocab=30522, units=768, layers=12, heads=12, hidden=3072,
            max_len=512, dropout=0.1)
BERT_BATCH, BERT_SEQ = 16, 512
# (bh, T, d) of every flash launch on the path: batch x heads, T, 64
FLASH_MAIN = (BERT_BATCH * BERT["heads"], BERT_SEQ,
              BERT["units"] // BERT["heads"])
# further (bh, tq, tk, d, causal) each kernel must take: Tq != Tk causal
# (rows with no live key when Tq > Tk), a ragged length, the other head dims
FLASH_EXTRA = [(24, 384, 512, 64, True), (24, 512, 384, 64, True),
               (24, 500, 500, 64, False), (24, 500, 500, 64, True),
               (24, 256, 256, 32, True), (24, 256, 200, 128, False),
               (24, 256, 256, 12, True), (24, 300, 300, 40, False),
               (24, 256, 256, 96, True), (24, 256, 256, 128, True),
               (65600, 16, 16, 16, False)]
# head dims over 128 (the CUDA-core capacity-256 instances of all four
# kernels, in both types): causal and not, a ragged T = 300, Tq != Tk
FLASH_WIDE = [(12, 256, 256, 136, False), (12, 300, 300, 192, True),
              (12, 256, 200, 256, True), (12, 256, 256, 256, False)]
# head dims over 256 (128-column slices of the capacity-128 CUDA-core
# instances): causal and not, ragged T, Tq != Tk; the d = 384 one is timed
FLASH_HUGE = [(8, 300, 300, 264, True), (8, 300, 300, 264, False),
              (8, 256, 256, 384, False), (8, 300, 260, 384, True),
              (8, 300, 300, 512, True), (8, 256, 256, 512, False)]
FLASH_HUGE_TIMED = (8, 256, 256, 384, False)
# float16's further shapes: a ragged T (the tensor cores), a head dim over
# 256 and d = 12 (d % 8 != 0): the float16 CUDA-core kernels, held beside
# the tensor-core ones
FLASH_F16_EXTRA = [(24, 500, 500, 64, True), (8, 300, 260, 384, True),
                   (24, 256, 256, 12, True)]
# the second timed shape: a long causal sequence at the widest head dim the
# tensor cores take
FLASH_LONG = (48, 2048, 2048, 128, True)
# dO's magnitudes (powers of two) the float16 backward is held at besides
# 1: a gradient without loss scaling, and one under a loss scale
FLASH_F16_DO_EXPS = (-10, 12)
FLASH_KERNELS = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                 "flash_bwd_dkv")
FLASH_SYMBOLS = {"flash_fwd": "flash_fwd_kernel",
                 "flash_fwd_wgmma": "flash_fwd_wgmma_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                 "flash_bwd_dq_wgmma": "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma": "flash_bwd_dkv_wgmma_kernel"}
# the tensor-core counter of each wrapper's launches
FLASH_WGMMA = {n: n + "_wgmma" for n in FLASH_KERNELS}


# a bfloat16 output is one rounding of float32 values that part from the
# plain version's only by summation order, so isolated elements part by one
# rounding step (at most 2^-7 = 7.8e-3 of the value) and the rest not at
# all; both limits are relative to the output's own size: the largest error
# to max |ref|, the rms error to rms |ref|. A store that truncates instead
# of rounding moves about half the elements by a step, which only the rms
# reading sees; a swapped pair moves elements by their own size. On an
# H100 sound outputs read max_rel <= 2.0e-3 and rms_rel <= 5.1e-5 (o; dq,
# dk and dv <= 2.7e-5), a truncating store rms_rel 4.05e-3
FLASH_BF16_MAX_TOL = 1e-2
FLASH_BF16_RMS_TOL = 5e-4


def limits16(dtype):
    """(max_rel, rms_rel) limits of a 16-bit output: bfloat16's above,
    scaled to the type's step (float16: 2^-11 against 2^-8)."""
    f = STEP16[dtype] / STEP16[torch.bfloat16]
    return FLASH_BF16_MAX_TOL * f, FLASH_BF16_RMS_TOL * f


def _flash_err(out, ref, dtype):
    """(max abs error, ok, readings): float32 outputs must lie within
    TOL[float32] x (1 + |ref|) everywhere; 16-bit ones within the two
    limits of `limits16`, read as {"max_rel", "rms_rel"}. The plain
    version's output must not be all zero."""
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    nonzero = bool(r.abs().max() > 0)
    if dtype == torch.float32:
        ok = bool((diff <= TOL[dtype] * (1.0 + r.abs())).all())
        return diff.max().item(), ok and nonzero, {}
    read = {"max_rel": (diff.max() / r.abs().max()).item(),
            "rms_rel": (diff.square().mean().sqrt()
                        / r.square().mean().sqrt()).item()}
    max_tol, rms_tol = limits16(dtype)
    ok = read["max_rel"] <= max_tol and read["rms_rel"] <= rms_tol
    return diff.max().item(), ok and nonzero, read


def store_faults16(out32, dtype=torch.bfloat16):
    """What two faulty 16-bit stores would write from float32 values: one
    that truncates (rounds toward zero: for bfloat16 the low 16 bits
    dropped) and one that swaps each pair of neighbours."""
    if dtype == torch.bfloat16:
        trunc = (out32.contiguous().view(torch.int32) & -65536).view(
            torch.float32).to(torch.bfloat16)
    else:
        # rounded to nearest, then one step toward zero where that rounded
        # away from zero (the raw bits of a 16-bit float order by size)
        near = out32.to(dtype)
        away = near.float().abs() > out32.abs()
        trunc = torch.where(away, (near.view(torch.int16) - 1).view(dtype),
                            near)
    swapped = out32.to(dtype).reshape(-1, 2).flip(-1).reshape(out32.shape)
    return {"truncating store": trunc, "swapped pair": swapped}


def flash_planted_faults(bwd_args, refs):
    """The 16-bit limits against planted store faults: each kernel's
    float32 instance on the same (16-bit-valued) inputs gives the values
    the 16-bit instance rounds, `store_faults16` writes them as a faulty
    store would, and the check must refuse every one. Returns the
    readings."""
    q, k, v, do, lse, delta, causal, scale = bwd_args
    dtype = q.dtype
    max_tol, rms_tol = limits16(dtype)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    args32 = (q32, k32, v32, do32, lse, delta, causal, scale)
    dk32, dv32 = kernels.flash_bwd_dkv_cuda(*args32)
    out32 = {"o": kernels.flash_fwd_cuda(q32, k32, v32, causal, scale,
                                         False),
             "dq": kernels.flash_bwd_dq_cuda(*args32), "dk": dk32,
             "dv": dv32}
    readings = {}
    for name, x32 in out32.items():
        for fault, bad in store_faults16(x32, dtype).items():
            _, ok, read = _flash_err(bad, refs[name], dtype)
            readings[f"{name}, {fault}"] = read
            assert not ok, f"the 16-bit check passes a {fault} of {name}"
    log(f"[flash kernels] planted {_dtype_name(dtype)} store faults (must "
        f"fail: max_rel > {max_tol:.3e} or rms_rel > {rms_tol:.3e}): "
        + "; ".join(f"{n} max_rel {r['max_rel']:.3e} rms_rel "
                    f"{r['rms_rel']:.3e}" for n, r in readings.items()))
    return readings


def check_flash(bh, tq, tk, d, causal, dtype, gen, dev, timed, faults=True,
                do_exp=0):
    """The four kernels against their plain versions on the same inputs
    (the backward ones from the plain forward's lse and delta), dO scaled
    by 2^do_exp; with `timed`, each kernel's time, bound, plain time and
    library time, and with `faults` too the planted faults and one-term
    readings (the backward's also at every do_exp in float16)."""
    q, k, v, do = (torch.randn((bh, n, d), generator=gen, device=dev)
                   for n in (tq, tk, tk, tq))
    do = do * 2.0 ** do_exp
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    scale = 1.0 / np.sqrt(d)
    before = kernels.launch_counts()
    o5 = kernels.flash_fwd_cuda(q, k, v, causal, scale, False)
    o6, lse = kernels.flash_fwd_cuda(q, k, v, causal, scale, True)
    o_ref, lse_ref = attention.flash_forward_lse_ref(q, k, v, causal, scale)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    bwd_args = (q, k, v, do, lse_ref, delta, causal, scale)
    dq = kernels.flash_bwd_dq_cuda(*bwd_args)
    dk, dv = kernels.flash_bwd_dkv_cuda(*bwd_args)
    dq_ref = attention.flash_bwd_dq_ref(*bwd_args)
    dk_ref, dv_ref = attention.flash_bwd_dkv_ref(*bwd_args)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    # every kernel ran once, on the tensor cores exactly where its route
    # says so
    route = {"flash_fwd": kernels.flash_fwd_route(dtype, d),
             "flash_fwd_lse": kernels.flash_fwd_route(dtype, d),
             "flash_bwd_dq": kernels.flash_bwd_route(dtype, d),
             "flash_bwd_dkv": kernels.flash_bwd_route(dtype, d)}
    moved = {n: after[n] - before[n] for n in after}
    assert all(moved[n] == 1 and moved[FLASH_WGMMA[n]]
               == (route[n] == "wgmma") for n in FLASH_KERNELS), \
        f"flash launches {moved} off the routes {route}"
    outputs = {"flash_fwd": {"o": (o5, o_ref, dtype)},
               "flash_fwd_lse": {"o": (o6, o_ref, dtype),
                                 "lse": (lse, lse_ref, torch.float32)},
               "flash_bwd_dq": {"dq": (dq, dq_ref, dtype)},
               "flash_bwd_dkv": {"dk": (dk, dk_ref, dtype),
                                 "dv": (dv, dv_ref, dtype)}}
    checks = {n: {o: _flash_err(*a) for o, a in c.items()}
              for n, c in outputs.items()}
    case = {"bh": bh, "tq": tq, "tk": tk, "d": d, "causal": causal,
            "dtype": _dtype_name(dtype)}
    if do_exp:
        case["do_scale"] = f"2^{do_exp}"
    tol = ({"elementwise": TOL[dtype]} if dtype == torch.float32 else
           dict(zip(("max_rel", "rms_rel"), limits16(dtype))))
    rows = {n: dict(case, max_abs_err=max(e for e, _, _ in c.values()),
                    tol=tol, readings={o: r for o, (_, _, r) in c.items()
                                       if r})
            for n, c in checks.items()}
    for n in FLASH_KERNELS:
        rows[n]["route"] = route[n]
    # an f32 product that accumulates in the plain version's order (the
    # dq and dk/dv sweeps at d = 64 against cuBLAS) can agree to the bit
    if dtype == torch.float32:
        how = f"tol {TOL[dtype]:.0e} x (1 + |ref|)"
    else:
        how = f"{_dtype_name(dtype)} " + ", ".join(
            f"{o} max_rel {r['max_rel']:.3e} rms_rel {r['rms_rel']:.3e}"
            for o, r in ((o, c[o][2]) for c in checks.values() for o in c)
            if r) + " (tol {:.2e} / {:.2e})".format(*limits16(dtype))
    log(f"[flash kernels] {case} forward and backward on "
        f"{route['flash_fwd']}: max_abs_err "
        + ", ".join(f"{n} {r['max_abs_err']:.3e}" for n, r in rows.items())
        + f"; {how}; max |ref| o "
        f"{o_ref.float().abs().max().item():.3f} dq "
        f"{dq_ref.float().abs().max().item():.3f} dk "
        f"{dk_ref.float().abs().max().item():.3f} dv "
        f"{dv_ref.float().abs().max().item():.3f}")
    assert all(torch.isfinite(t.float()).all()
               for t in (o5, o6, dq, dk, dv)), "non-finite flash output"
    for n, c in checks.items():
        assert all(ok for _, ok, _ in c.values()), \
            f"{n} {case} disagrees with its plain version"
    if timed:
        time_flash(rows, q, k, v, do, lse_ref, delta, causal, scale, dtype,
                   o_ref)
    if timed and faults:
        planted = flash_planted_faults(
            bwd_args, {"o": o_ref, "dq": dq_ref, "dk": dk_ref, "dv": dv_ref})
        for name, own, ref in (("o", o5, o_ref), ("dq", dq, dq_ref),
                               ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            planted[f"{name}, swapped pair of the kernel's own output"] = \
                swapped_own(name, own, ref)
        rows["flash_fwd"]["planted"] = planted
    if timed and faults and dtype != torch.float32:
        rows["flash_fwd"]["one_term_p"] = one_term_reading(q, k, v, causal,
                                                           scale, o_ref)
    if faults and dtype != torch.float32 and (timed or do_exp):
        rows["flash_bwd_dq"]["one_term"] = bwd_term_readings(
            bwd_args, {"dq": dq_ref, "dk": dk_ref, "dv": dv_ref})
    return rows


def swapped_own(name, out, ref):
    """The 16-bit limits against a kernel's own output `name` with each
    pair of neighbours swapped (a store that writes a pair the wrong way
    round): must be refused."""
    bad = out.reshape(-1, 2).flip(-1).reshape(out.shape)
    _, ok, read = _flash_err(bad, ref, out.dtype)
    log(f"[flash kernels] planted fault, the kernel's own {name} with pairs "
        f"swapped: max_rel {read['max_rel']:.3e} rms_rel "
        f"{read['rms_rel']:.3e}")
    assert not ok, f"the 16-bit check passes a swapped pair of {name}"
    return read


def one_term_reading(q, k, v, causal, scale, o_ref):
    """What the limits of q's 16-bit type read if P went into P.V as one
    term of that type (P rounded to it, products and sums in f32, as a
    single wgmma would take it), against the two terms P_hi + P_lo the
    tensor-core forward issues; emulated in PyTorch on the card. Recorded,
    not asserted: it says why the forward splits P in both types."""
    dtype = q.dtype
    s, live = attention._scores(q, k, scale, causal)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if live is not None:
        p = p * live
    den = p.sum(-1, keepdim=True)
    den = torch.where(den == 0, 1.0, den)
    hi = p.to(dtype).float()
    out = {}
    for name, pp in (("one_term", hi),
                     ("two_term", hi + (p - hi).to(dtype).float())):
        o = (torch.einsum("bqk,bkd->bqd", pp, v.float()) / den).to(dtype)
        out[name] = _flash_err(o, o_ref, dtype)[2]
    del s, p, hi
    max_tol, rms_tol = limits16(dtype)
    log(f"[flash kernels] P.V with P in {_dtype_name(dtype)} (emulated): "
        f"one term {out['one_term']}, two terms {out['two_term']} (limits "
        f"max_rel {max_tol:.3e}, rms_rel {rms_tol:.3e})")
    return out


def bwd_term_readings(bwd_args, refs):
    """What the limits of q's 16-bit type read if P and dS went into the
    backward's products as one term of that type (P^T dO for dv; dS K for
    dq and dS^T Q for dk; products and sums in f32, as a single wgmma
    would take them), as two plain terms x_hi + x_lo (the bfloat16
    sweeps), and (float16) as the float16 sweeps take them: P shifted by
    2^15, dS scaled per output row (`attention.flash_bwd_split_ref`);
    emulated in PyTorch on the card. Recorded, not asserted: it says why
    the sweeps split both operands, and why float16's rescale them."""
    dtype = bwd_args[0].dtype
    splits = ("one_term", "two_term") + (
        ("kernel",) if dtype == torch.float16 else ())
    out = {}
    for split in splits:
        got = attention.flash_bwd_split_ref(*bwd_args, split=split)
        out[split] = {n: _flash_err(g, refs[n], dtype)[2]
                      for n, g in zip(("dq", "dk", "dv"), got)}
        del got
    max_tol, rms_tol = limits16(dtype)
    log(f"[flash kernels] the backward with P and dS in "
        f"{_dtype_name(dtype)} (emulated), max |dO| "
        f"{bwd_args[3].float().abs().max().item():.3e}: "
        + "; ".join(f"{n} {r}" for n, r in out.items())
        + f" (limits max_rel {max_tol:.3e}, rms_rel {rms_tol:.3e})")
    return out


def time_flash(rows, q, k, v, do, lse, delta, causal, scale, dtype, o_ref):
    """Kernel, plain and library (one PyTorch SDPA call: its forward for
    B5/B6, its backward, which gives dq, dk and dv at once, for B7/B8)
    times, and the bound, into `rows`."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    bwd = (q, k, v, do, lse, delta, causal, scale)
    run = {"flash_fwd": (
               lambda i: kernels.flash_fwd_cuda(q, k, v, causal, scale,
                                                False),
               lambda i: attention.flash_attention_ref(q, k, v, causal,
                                                       scale)),
           "flash_fwd_lse": (
               lambda i: kernels.flash_fwd_cuda(q, k, v, causal, scale,
                                                True),
               lambda i: attention.flash_forward_lse_ref(q, k, v, causal,
                                                         scale)),
           "flash_bwd_dq": (lambda i: kernels.flash_bwd_dq_cuda(*bwd),
                            lambda i: attention.flash_bwd_dq_ref(*bwd)),
           "flash_bwd_dkv": (lambda i: kernels.flash_bwd_dkv_cuda(*bwd),
                             lambda i: attention.flash_bwd_dkv_ref(*bwd))}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.detach().unsqueeze(0).requires_grad_()
                  for t in (q, k, v))
    lib_out = sdpa(q4, k4, v4, is_causal=causal and tq == tk)
    lib_err = (lib_out[0].float() - o_ref.float()).abs().max().item()
    lib_fwd = median_ms(lambda i: sdpa(q4, k4, v4,
                                       is_causal=causal and tq == tk),
                        reps=20)
    do4 = do.unsqueeze(0)
    lib_bwd = median_ms(lambda i: torch.autograd.grad(
        lib_out, (q4, k4, v4), do4, retain_graph=True), reps=20)
    for name, (kern, plain) in run.items():
        r = rows[name]
        r["ms"] = median_ms(kern, reps=20)
        r["plain_ms"] = median_ms(plain, reps=5, warmup=1)
        r["bound_ms"], r["bound_by"] = bound_ms(
            name, bh=bh, tq=tq, tk=tk, d=d, causal=causal, dtype=dtype)
        r["library_ms"] = lib_fwd if name in ("flash_fwd",
                                              "flash_fwd_lse") else lib_bwd
        r["library_max_abs_err"] = lib_err
        log(f"[flash kernels] {name} {(bh, tq, tk, d)} "
            f"{_dtype_name(dtype)} causal={causal}: {r['ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, sdpa "
            f"{'forward' if name.startswith('flash_fwd') else 'backward'} "
            f"{r['library_ms']:.4f} ms (sdpa forward max_abs_err "
            f"{lib_err:.2e})")


def phase_flash_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    bh, t, d = FLASH_MAIN
    variants = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (False, True):
            # the main path runs (192, 512, 64) bf16 without a mask: time it
            timed = dtype == torch.bfloat16 and not causal
            variants.append(check_flash(bh, t, t, d, causal, dtype, gen,
                                        dev, timed))
        for bh_, tq, tk, d_, causal in FLASH_EXTRA + FLASH_WIDE:
            variants.append(check_flash(bh_, tq, tk, d_, causal, dtype, gen,
                                        dev, False))
        for shape in FLASH_HUGE:
            timed = shape == FLASH_HUGE_TIMED and dtype == torch.bfloat16
            variants.append(check_flash(*shape, dtype, gen, dev, timed,
                                        faults=False))
        variants.append(check_flash(*FLASH_LONG, dtype, gen, dev,
                                    dtype == torch.bfloat16))
    # float16: the path's shape and the causal long one (all four on the
    # tensor cores), timed, with the planted store faults and the one-term
    # readings, then at dO 2^-10 and 2^12; a ragged T, a head dim over 256
    # and d = 12 (the CUDA-core kernels)
    f16 = torch.float16
    for shape in ((bh, t, t, d, False), FLASH_LONG):
        variants.append(check_flash(*shape, f16, gen, dev, True))
        for e in FLASH_F16_DO_EXPS:
            variants.append(check_flash(*shape, f16, gen, dev, False,
                                        do_exp=e))
    for shape in FLASH_F16_EXTRA:
        variants.append(check_flash(*shape, f16, gen, dev, False))
    kernels.reset_launch_counts()   # comparison launches do not count
    return variants


# ---------------------------------------------------------------------------
# phase 7: BERT-base encoder training and inference at full width
# ---------------------------------------------------------------------------
BERT_WARMUP, BERT_STEPS, BERT_LR = 2, 10, 1e-4
# flash (B5-B8) against the SDPA composition, float32, TF32 off, dropout 0,
# 2 layers at full width, batch 4, two SGD steps from the same weights: the
# losses, and each leaf's update against the composition's relative to its
# own norm (SGD, so an update is lr x its gradient). The key projection's
# bias is left out of the limit: its gradient is zero in exact arithmetic
# (softmax is shift-invariant along each query's row), so both runs hand it
# roundoff, whose parting says nothing of the kernels
FLASH_CHECK_LAYERS, FLASH_CHECK_BATCH, FLASH_CHECK_STEPS = 2, 4, 2
FLASH_CHECK_LR = 1e-3
# sound runs on an H100 read a median of 8.9e-7 over the 36 held weights
# and at most 3.4e-4 (cells.1.attention.query_proj.weight), the losses
# equal to the last digit. A planted fault, the flash backward without
# delta (the softmax normaliser's term), is run at this very configuration
# every time, and must read over the update limit
FLASH_CHECK_LOSS_RTOL = 1e-4
FLASH_CHECK_UPDATE_RTOL = 1e-3
FLASH_CHECK_SKIP = "attention.key_proj.bias"


class BertEncoderLM(gluon.HybridBlock):
    """BERT-base's encoder stack from the public Gluon blocks: token and
    learned positional embeddings, pre-norm encoder cells (exact-erf
    GELU, flash attention), a final LayerNorm (the block's epsilon, 1e-5)
    and a dense head over the vocabulary at every position."""

    def __init__(self, layers, use_flash, dropout, cfg=BERT, deferred=False):
        super().__init__()
        nn = gluon.nn
        u = cfg["units"]
        # deferred: the final LayerNorm and the head take their width from
        # the first input (no in_channels / in_units)
        width = 0 if deferred else u
        self.emb = nn.Embedding(cfg["vocab"], u)
        self.pos = nn.PositionalEmbedding(cfg["max_len"], u)
        self.cells = nn.HybridSequential(*[
            nn.TransformerEncoderCell(u, cfg["hidden"], cfg["heads"],
                                      dropout=dropout, activation="gelu",
                                      use_flash=use_flash)
            for _ in range(layers)])
        self.ln = nn.LayerNorm(in_channels=width)
        self.head = nn.Dense(cfg["vocab"], flatten=False, in_units=width)

    def forward(self, x):
        return self.head(self.ln(self.cells(self.pos(self.emb(x)))))


def token_batches(n, batch, seed, dev):
    rng = np.random.RandomState(seed)
    shape = (batch, BERT_SEQ)
    return [tuple(torch.from_numpy(rng.randint(0, BERT["vocab"], size=shape)
                                   .astype(np.int32)).to(dev)
                  for _ in range(2)) for _ in range(n)]


def bert_step(net, opt):
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    return FusedTrainStep(net, lambda n, x, y: loss_fn(n(x), y).mean(), opt)


def phase_bert(card, profile, dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = token_batches(2, BERT_BATCH, seed=21, dev=dev)
    L = BERT["layers"]
    amp.init("bfloat16")
    try:
        t0 = time.perf_counter()
        net = BertEncoderLM(L, True, BERT["dropout"]).initialize(
            device=dev, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_weights = sum(p.data().numel()
                        for p in net.collect_params().values())
        step = bert_step(net, optimizer.create("adam",
                                               learning_rate=BERT_LR))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(BERT_WARMUP):
            step(*batches[i % 2])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [step(*batches[i % 2]) for i in range(BERT_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        step_ms = wall / BERT_STEPS * 1e3
        # inference: one plain forward outside record(), on the same counts;
        # nothing is taped, so flash takes B5
        t0 = time.perf_counter()
        logits = net(batches[0][0])
        torch.cuda.synchronize()
        infer_ms = (time.perf_counter() - t0) * 1e3
        total = kernels.launch_counts()
        prof = profile_steps(step, batches, step_ms, FLASH_SYMBOLS,
                             "bert") if profile else None
    finally:
        amp.uninit()
    if prof is not None:
        ms = prof["kernels_ms_per_step"]
        log(f"[bert profile] B7 {ms['flash_bwd_dq_wgmma']:.3f} ms and B8 "
            f"{ms['flash_bwd_dkv_wgmma']:.3f} ms a step on the tensor cores "
            f"(CUDA-core sweeps {ms['flash_bwd_dq']:.3f} / "
            f"{ms['flash_bwd_dkv']:.3f}), B6 {ms['flash_fwd_wgmma']:.3f} ms, "
            f"of {prof['device_ms_per_step']:.3f} device ms a step")
    losses = [float(v) for v in losses]
    tokens_s = BERT_BATCH * BERT_SEQ * BERT_STEPS / wall
    infer = {n: total[n] - launches[n] for n in total}
    log(f"[bert] {L} layers x {BERT['units']} wide, {n_weights} weights "
        f"(initialized in {init_s:.3f} s), batch {BERT_BATCH} x {BERT_SEQ} "
        f"tokens, bf16 AMP, Adam lr {BERT_LR}: warm-up {BERT_WARMUP} steps "
        f"{warm_s:.3f} s")
    log(f"[bert] {card}: {BERT_STEPS} steps in {wall:.3f} s: {step_ms:.3f} "
        f"ms/step, {tokens_s:.1f} tokens/s; peak device memory "
        f"{peak_gb:.2f} GiB; losses {[round(v, 4) for v in losses]}")
    log(f"[bert] training launches {launches} (expected {L} each of "
        f"flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv per step x "
        f"{BERT_STEPS}, every one on the tensor cores); inference "
        f"forward {infer_ms:.3f} ms, launches {infer} (expected {L} "
        f"flash_fwd, all on the tensor cores)")
    assert all(np.isfinite(losses)), "non-finite BERT training loss"
    want = dict.fromkeys(launches, 0)
    want.update({n: L * BERT_STEPS for n in FLASH_KERNELS[1:]})
    want.update({FLASH_WGMMA[n]: L * BERT_STEPS for n in FLASH_KERNELS[1:]})
    assert launches == want, "flash launch count off the training path"
    assert infer == dict(dict.fromkeys(infer, 0), flash_fwd=L,
                         flash_fwd_wgmma=L), \
        "flash launch count off the inference path"
    assert logits.grad_fn is None, "the inference forward was taped"
    assert logits.shape == (BERT_BATCH, BERT_SEQ, BERT["vocab"]) and \
        torch.isfinite(logits.float()).all(), "inference logits not finite"
    del net, step, logits
    torch.cuda.empty_cache()
    check = bert_f32_check(dev)
    return {"step_ms": step_ms, "tokens_per_s": tokens_s, "losses": losses,
            "launches": total, "train_launches": launches,
            "infer_launches": infer, "infer_ms": infer_ms,
            "weights": n_weights, "peak_gib": peak_gb, "warmup_s": warm_s,
            "f32_check": check, "profile": prof}


def bert_f32_check(dev):
    """Two flash against two SDPA-composition float32 SGD steps (TF32 off,
    dropout 0) from the same weights and data, FLASH_CHECK_LAYERS layers
    at full width."""
    x, y = token_batches(1, FLASH_CHECK_BATCH, seed=22, dev=dev)[0]
    nets, losses = [], []
    for use_flash in (True, False):
        net = BertEncoderLM(FLASH_CHECK_LAYERS, use_flash, 0.0).initialize(
            device=dev, seed=1)
        step = bert_step(net, optimizer.create("sgd",
                                               learning_rate=FLASH_CHECK_LR))
        kernels.reset_launch_counts()
        losses.append([float(step(x, y)) for _ in range(FLASH_CHECK_STEPS)])
        n = FLASH_CHECK_LAYERS * FLASH_CHECK_STEPS if use_flash else 0
        assert kernels.launch_counts() == dict(
            dict.fromkeys(kernels.launch_counts(), 0), flash_fwd_lse=n,
            flash_bwd_dq=n, flash_bwd_dkv=n), \
            f"use_flash={use_flash}: {kernels.launch_counts()}"
        nets.append(net)
    planted = planted_no_delta(x, y, dev)
    kernels.reset_launch_counts()
    init = BertEncoderLM(FLASH_CHECK_LAYERS, True, 0.0).initialize(
        device=dev, seed=1).collect_params()
    rel = update_parting(init, *(n.collect_params() for n in nets))
    held = {n: r for n, r in rel.items() if not n.endswith(FLASH_CHECK_SKIP)}
    bad = update_parting(init, planted.collect_params(),
                         nets[1].collect_params())
    bad = {n: r for n, r in bad.items() if not n.endswith(FLASH_CHECK_SKIP)}
    bad_worst = max(bad, key=bad.get)
    order = sorted(held, key=held.get, reverse=True)
    worst = order[0]
    loss_rel = max(abs(p - q) / max(abs(q), 1e-6)
                   for p, q in zip(*losses))
    skipped = {n: f"{r:.3e}" for n, r in rel.items() if n not in held}
    log(f"[bert float32] flash losses {losses[0]} SDPA {losses[1]} (max rel "
        f"{loss_rel:.2e}, tol {FLASH_CHECK_LOSS_RTOL}); the update of each "
        f"of {len(held)} weights against the SDPA one, |dA - dB| / |dB|: "
        f"median {float(np.median(list(held.values()))):.3e}, largest "
        f"{[(n, f'{held[n]:.3e}') for n in order[:5]]} (tol "
        f"{FLASH_CHECK_UPDATE_RTOL}); left out (zero gradient in exact "
        f"arithmetic): {skipped}")
    log(f"[bert float32] planted fault, the flash backward without delta "
        f"(must read over {FLASH_CHECK_UPDATE_RTOL}): median "
        f"{float(np.median(list(bad.values()))):.3e}, worst "
        f"{bad[bad_worst]:.3e} at {bad_worst}")
    assert all(np.isfinite(losses[0])), "non-finite float32 loss"
    assert loss_rel <= FLASH_CHECK_LOSS_RTOL, "flash and SDPA losses part"
    assert held[worst] <= FLASH_CHECK_UPDATE_RTOL, \
        f"flash and SDPA updates part at {worst}: {held[worst]:.3e}"
    assert bad[bad_worst] > FLASH_CHECK_UPDATE_RTOL, \
        "the update check passes a flash backward without delta"
    return {"lr": FLASH_CHECK_LR, "flash_losses": losses[0],
            "sdpa_losses": losses[1], "loss_max_rel": loss_rel,
            "update_rel_median": float(np.median(list(held.values()))),
            "update_rel_worst": held[worst], "worst_at": worst,
            "update_rel": rel,
            "planted_no_delta_median": float(np.median(list(bad.values()))),
            "planted_no_delta_worst": bad[bad_worst]}


def planted_no_delta(x, y, dev):
    """The check's flash run with a planted fault: the backward kernels
    given delta = 0 in place of rowsum(dO * o). Returns the net after
    FLASH_CHECK_STEPS steps from the check's weights."""
    net = BertEncoderLM(FLASH_CHECK_LAYERS, True, 0.0).initialize(
        device=dev, seed=1)
    step = bert_step(net, optimizer.create("sgd",
                                           learning_rate=FLASH_CHECK_LR))
    sound = attention._backward

    def no_delta(q, k, v, do, lse, delta, causal, scale):
        return sound(q, k, v, do, lse, torch.zeros_like(delta), causal,
                     scale)
    attention._backward = no_delta
    try:
        for _ in range(FLASH_CHECK_STEPS):
            step(x, y)
    finally:
        attention._backward = sound
    return net


# ---------------------------------------------------------------------------
# phase 8: B4's int8 variant and mixed types against the plain version
# ---------------------------------------------------------------------------
CACHE_SLOTS = 4                           # phase 9's prefix-cache rows
INT8_CS = (1, 4, WINDOW)                  # decode, verify (draft 3), chunk


def paged_err(out, ref):
    """(max abs error, ok, readings): a float32 output must lie within
    TOL[float32] of the plain version everywhere (phase 2's limit); a
    bfloat16 one within phase 6's two limits relative to its own size."""
    if out.dtype == torch.float32:
        err = (out - ref).abs().max().item()
        return err, err <= TOL[torch.float32], {}
    return _flash_err(out, ref, out.dtype)


def shifted_scales(scale):
    """A view of `scale`'s shape whose position t holds scale[t - 1]:
    what a kernel reading the scales one position off would see."""
    pad = torch.zeros(scale.shape[:2] + (scale.shape[2] + 1,),
                      dtype=scale.dtype, device=scale.device)
    pad[:, :, 1:] = scale
    return pad[:, :, :scale.shape[2]]


def phase_int8_kernels(dev):
    """B4 on int8 slabs (codes and scales made by the engine's own
    quantizer from random K/V) and on mixed q/slab float types, at the
    serving shapes of phase 9: 16 lanes over 21 pool rows, 12 layers, 12
    heads x 64, 2048 positions, a non-zero layer, ragged lengths with 0
    and T - C, C in (1, 4, 256), and a view cut on the position axis."""
    from incubator_mxnet_tpu_torch.serve.continuous import _quantize_kv
    S, H, D, T, L = SLOTS, FULL["heads"], FULL["head_dim"], \
        FULL["max_len"], FULL["layers"]
    rows = SLOTS + CACHE_SLOTS + 1
    gen = torch.Generator(device=dev).manual_seed(8)
    shape = (rows, L, T, H, D)
    k32 = torch.randn(shape, generator=gen, device=dev)
    v32 = torch.randn(shape, generator=gen, device=dev)
    slabs = {torch.float32: (k32, v32, None, None)}
    slabs[torch.bfloat16] = (k32.bfloat16(), v32.bfloat16(), None, None)
    slabs[torch.float16] = (k32.half(), v32.half(), None, None)
    kc, ks = _quantize_kv(k32)
    vc, vs = _quantize_kv(v32)
    slabs[torch.int8] = (kc, vc, ks, vs)
    rng = np.random.RandomState(8)
    layer = min(7, L - 1)           # a non-zero layer
    variants = []
    for C in INT8_CS:
        lens_np = np.concatenate([[0, 1, 255, 1000, T - C],
                                  rng.randint(0, T - C, S - 5)]) \
            .astype(np.int32)
        lens = torch.as_tensor(lens_np, device=dev)
        ext = 1280
        lens_e = torch.clamp(lens, max=ext - C)
        for q_dtype in (torch.float32, torch.bfloat16, torch.float16):
            q = torch.randn((S, C, H, D), generator=gen,
                            device=dev).to(q_dtype)
            for kv_dtype, (k, v, ksc, vsc) in slabs.items():
                sc = dict(k_scale=ksc, v_scale=vsc)
                out, route = paged_checked(q, k, v, lens, layer, **sc)
                ref = fused.paged_attention_ref(q, k, v, lens, layer, **sc)
                cut = {n: t[:, :, :ext] if t is not None else None
                       for n, t in sc.items()}
                out_v, _ = paged_checked(q, k[:, :, :ext], v[:, :, :ext],
                                         lens_e, layer, **cut)
                out_f, _ = paged_checked(q, k, v, lens_e, layer, **sc)
                ref_v = fused.paged_attention_ref(
                    q, k[:, :, :ext], v[:, :, :ext], lens_e, layer, **cut)
                torch.cuda.synchronize()
                assert torch.isfinite(out.float()).all(), "non-finite output"
                err, ok, read = paged_err(out, ref)
                err_v, ok_v, read_v = paged_err(out_v, ref_v)
                same = torch.equal(out_v, out_f)
                name = (f"q {_dtype_name(q_dtype)} slab "
                        f"{_dtype_name(kv_dtype)} C={C} ({route})")
                log(f"[int8] paged_attention {name}: max_abs_err {err:.3e} "
                    f"{read} (view {err_v:.3e} {read_v}, view == full: "
                    f"{same})")
                assert ok and ok_v, \
                    f"paged_attention {name} disagrees with its plain version"
                assert same, f"paged_attention {name}: extent view != full"
                rec = {"q_dtype": _dtype_name(q_dtype),
                       "kv_dtype": _dtype_name(kv_dtype), "C": C,
                       "kernel_route": route, "max_abs_err": err, **read}
                # planted fault: what a combine that took one position too
                # many would give, lane 3 (length 1000: its prefix crosses
                # three piece boundaries) read at length 1001
                lens_bad = lens.clone()
                lens_bad[3] += 1
                bad = kernels.paged_attention_cuda(q, k, v, lens_bad, layer,
                                                   **sc)
                torch.cuda.synchronize()
                c_err, c_ok, c_read = paged_err(bad, ref)
                log(f"[int8] planted fault (lane 3 one position long) {name}:"
                    f" max_abs_err {c_err:.3e} {c_read}: "
                    f"{'ACCEPTED' if c_ok else 'refused'}")
                assert not c_ok, "the check accepted a lane one position long"
                rec["planted_combine_max_abs_err"] = c_err
                if kv_dtype == torch.int8:
                    # planted fault: the kernel fed scales one position off
                    bad = kernels.paged_attention_cuda(
                        q, k, v, lens, layer, k_scale=shifted_scales(ksc),
                        v_scale=shifted_scales(vsc))
                    torch.cuda.synchronize()
                    b_err, b_ok, b_read = paged_err(bad, ref)
                    log(f"[int8] planted fault (scales one position off) "
                        f"{name}: max_abs_err {b_err:.3e} {b_read}: "
                        f"{'ACCEPTED' if b_ok else 'refused'}")
                    assert not b_ok, "the check accepted shifted scales"
                    rec["planted_max_abs_err"] = b_err
                    rec["planted"] = b_read
                if kv_dtype == torch.int8 and q_dtype != torch.float32:
                    rec.update(time_paged(q, k, v, lens, lens_np, layer,
                                          k_scale=ksc, v_scale=vsc))
                    before = (f", {CUDA_CORES_F16_CHUNK_MS['int8']} ms on "
                              f"the CUDA cores before (recorded: PERF.md "
                              f"section 6 row 4c)"
                              if q_dtype == torch.float16 and C == WINDOW
                              else "")
                    log(f"[int8] paged_attention {name}: {rec['ms']:.4f} "
                        f"ms, bound {rec['bound_ms']:.4f} ms "
                        f"({rec['bound_by']}), plain {rec['plain_ms']:.4f} "
                        f"ms, sdpa over the prefix dequantized to q's type "
                        f"{rec['library_ms']:.4f} ms (dequant not timed)"
                        f"{before}")
                variants.append(rec)
    variants += f16_chunk_cases(gen, slabs, lens, lens_np, layer)
    del slabs, k32, v32, kc, vc
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()   # comparison launches do not count
    return variants


# float16 q at C = 256 on the tensor cores, beyond the loop's cases: a
# peaked softmax (q x 8: scores spread ~8 sigma) over the float16 and the
# int8 slab, and the int8 slab with v_scale x 2^-12 (~6e-6: P' = P v_scale
# lies under float16's normal range, where the kernel's per-row shift
# keeps the lo term): (case, slab type, q scale, v_scale scale)
F16_CHUNK_CASES = (("peaked", torch.float16, 8.0, 1.0),
                   ("peaked", torch.int8, 8.0, 1.0),
                   ("v_scale x 2^-12", torch.int8, 1.0, 2.0 ** -12))


def f16_chunk_cases(gen, slabs, lens, lens_np, layer):
    """`F16_CHUNK_CASES` at phase 8's C = 256 shape: each on the wgmma
    route within float16's limits, timed beside SDPA (over the prefix
    dequantized to float16 on int8), the plain version and the bound."""
    S, H, D = SLOTS, FULL["heads"], FULL["head_dim"]
    out = []
    for case, kv_dtype, q_mul, vs_mul in F16_CHUNK_CASES:
        q = (torch.randn((S, WINDOW, H, D), generator=gen,
                         device=lens.device) * q_mul).half()
        k, v, ksc, vsc = slabs[kv_dtype]
        sc = {}
        if kv_dtype == torch.int8:
            sc = dict(k_scale=ksc, v_scale=vsc * vs_mul)
        got, route = paged_checked(q, k, v, lens, layer, **sc)
        ref = fused.paged_attention_ref(q, k, v, lens, layer, **sc)
        torch.cuda.synchronize()
        assert route == "wgmma" and torch.isfinite(got.float()).all(), route
        err, ok, read = paged_err(got, ref)
        name = f"q float16 slab {_dtype_name(kv_dtype)} C={WINDOW} {case}"
        rec = {"q_dtype": "float16", "kv_dtype": _dtype_name(kv_dtype),
               "C": WINDOW, "case": case, "kernel_route": route,
               "max_abs_err": err, **read,
               **time_paged(q, k, v, lens, lens_np, layer, **sc)}
        log(f"[int8] paged_attention {name} ({route}): max_abs_err "
            f"{err:.3e} {read}; {rec['ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
            f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms")
        assert ok, f"paged_attention {name} disagrees with its plain version"
        out.append(rec)
    return out


def time_paged(q, k, v, lens, lens_np, layer, k_scale=None, v_scale=None):
    """Kernel, plain and library times of one read, rotating over the
    layers as the engine's layer loop does; the library call is SDPA over
    the lanes' prefix, on an int8 slab dequantized and gathered into q's
    type beforehand (the dequant is not in its time)."""
    S, C, H, D = q.shape
    T, L = k.shape[2], k.shape[1]
    sc = dict(k_scale=k_scale, v_scale=v_scale) if k_scale is not None \
        else {}
    ms = median_ms(lambda i: kernels.paged_attention_cuda(
        q, k, v, lens, i % L, **sc), reps=24)
    plain_ms = median_ms(lambda i: fused.paged_attention_ref(
        q, k, v, lens, i % L, **sc), reps=5, warmup=1)
    if k_scale is not None:
        lk = (k[:, layer:layer + 1].float()
              * k_scale[:, layer:layer + 1, :, None, None]).to(q.dtype)
        lv = (v[:, layer:layer + 1].float()
              * v_scale[:, layer:layer + 1, :, None, None]).to(q.dtype)
        lib_fn, _ = library_call(q, lk, lv, lens, 0)
        del lk, lv
    else:
        lib_fn, _ = library_call(q, k, v, lens, layer)
    lib_ms = median_ms(lib_fn, reps=24)
    bound, bound_by = bound_ms("paged_attention", lengths=lens_np, C=C, T=T,
                               H=H, D=D, dtype=q.dtype, kv_dtype=k.dtype)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": bound_by}


# ---------------------------------------------------------------------------
# phase 9: the full decode engine at full width
# ---------------------------------------------------------------------------
SYSTEM_LEN, PREFIX_BLOCK, DRAFT = 512, 64, 3
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def engine_traffic():
    """(prompt, sampling kwargs, cached prefix length) of each request:
    one 512-token system prefix + 16 tokens (published), then 15 prompts
    sharing that prefix with suffixes of 16-400 tokens, then 8 prompts of
    their own of 16-1500 tokens; every other request sampled with seed =
    its index."""
    rng = np.random.RandomState(9)
    vocab = FULL["vocab"]
    system = rng.randint(1, vocab, SYSTEM_LEN).tolist()
    prompts = [system + rng.randint(1, vocab, 16).tolist()]
    for n in np.linspace(16, 400, 15).astype(int):
        prompts.append(system + rng.randint(1, vocab, int(n)).tolist())
    for n in np.linspace(16, 1500, 8).astype(int):
        prompts.append(rng.randint(1, vocab, int(n)).tolist())
    out = []
    for i, p in enumerate(prompts):
        samp = dict(SAMPLED, seed=i) if i % 2 else {}
        out.append((p, samp, SYSTEM_LEN if 1 <= i <= 15 else 0))
    return out


def engine_run(dtype, traffic):
    cfg = serve.DecoderConfig(**FULL, dtype=dtype)
    model = serve.CachedDecoder(cfg, seed=0)
    eng = serve.ContinuousEngine(
        model, max_slots=SLOTS, prefill_window=WINDOW,
        decode_steps=DECODE_STEPS, kv_dtype="int8",
        prefix_cache_slots=CACHE_SLOTS, prefix_block=PREFIX_BLOCK,
        draft_tokens=DRAFT)
    eng.start()
    log(f"[engine {dtype}] warmup {eng.warmup_s:.3f} s")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [eng.generate(traffic[0][0], NEW_TOKENS, timeout=300,
                         **traffic[0][1])]
    for group in (traffic[1:16], traffic[16:]):
        futs = [eng.submit(p, NEW_TOKENS, **samp) for p, samp, _ in group]
        outs += [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = eng.stats()
    eng.close()
    for (p, _, _), o in zip(traffic, outs):
        assert o.dtype == np.int32 and o.shape == (NEW_TOKENS,), \
            f"prompt of {len(p)} tokens gave {o.shape} tokens"
        assert ((o >= 0) & (o < cfg.vocab)).all(), "token id out of range"
    want = cfg.layers * (eng.decode_steps * st["decode_iterations"]
                         + st["chunk_batches"])
    got = launches["paged_attention_int8"]
    log(f"[engine {dtype}] paged_attention_int8 launches {got} (expected "
        f"{cfg.layers} layers x ({eng.decode_steps} speculative "
        f"micro-steps x {st['decode_iterations']} decode waves + "
        f"{st['chunk_batches']} chunk waves) = {want}); float "
        f"paged_attention launches {launches['paged_attention']}; prefix "
        f"hits {st['prefix_hits']}")
    assert got == want and got > 0, "int8 launch count off the main path"
    assert launches["paged_attention"] == 0, "a float read on an int8 pool"
    check_routes(f"engine {dtype}", dtype, cfg, eng, st, launches)
    assert st["prefix_hits"] == 15, "the 15 shared-prefix requests missed"
    return model, eng, outs, st, wall, launches


def phase_engine(card):
    traffic = engine_traffic()
    log(f"[engine] {len(traffic)} requests ({sum(1 for t in traffic if t[1])}"
        f" sampled: {SAMPLED}), prompt lengths "
        f"{[len(p) for p, _, _ in traffic]}, {NEW_TOKENS} new tokens each; "
        f"kv int8, draft {DRAFT}, {CACHE_SLOTS} prefix-cache rows, block "
        f"{PREFIX_BLOCK}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, eng, outs, st, wall, launches = engine_run("bfloat16", traffic)
    tokens = len(traffic) * NEW_TOKENS
    bf16_pool = serve.KVCachePool(
        eng.pool.max_slots, layers=FULL["layers"], max_len=FULL["max_len"],
        heads=FULL["heads"], head_dim=FULL["head_dim"], dtype="bfloat16",
        device=model.device, allocate=False)
    log(f"[engine bfloat16] {card}: {wall:.3f} s for {tokens} tokens "
        f"({tokens / wall:.1f} tokens/s end to end), decode "
        f"{st['decode_tokens_per_sec']} tokens/s; TTFT p50 "
        f"{st['ttft_p50_ms']} ms p99 {st['ttft_p99_ms']} ms; TPOT p50 "
        f"{st['tpot_p50_ms']} ms p99 {st['tpot_p99_ms']} ms; draft "
        f"acceptance {st.get('draft_acceptance')} ({st['draft_accepted']} "
        f"accepted, {st['draft_rejected']} rejected); prefix hit rate "
        f"{st.get('prefix_hit_rate')}; {st['decode_iterations']} decode "
        f"waves, {st['chunk_batches']} chunk waves; int8 pool "
        f"{eng.pool.slots_per_gb()} slots/GiB against bf16 "
        f"{bf16_pool.slots_per_gb()}")
    # finite logits of the expected shape from a prefill into an int8 pool
    pool = model.new_pool(1, dtype="int8")
    p0 = np.asarray(traffic[0][0][:WINDOW], np.int32)[None]
    logits = model.prefill_program(WINDOW)(
        model.params, *pool.buffers(),
        torch.as_tensor(p0, device=model.device),
        torch.full((1,), WINDOW, dtype=torch.int32, device=model.device),
        torch.zeros(1, dtype=torch.int32, device=model.device))
    assert logits.shape == (1, FULL["vocab"]) and \
        torch.isfinite(logits.float()).all(), "prefill logits not finite"
    del model, pool
    torch.cuda.empty_cache()
    model32, _, outs32, st32, wall32, launches32 = engine_run("float32",
                                                              traffic)
    bad, spec_bad = [], []
    t0 = time.perf_counter()
    for i, ((p, samp, cached), o) in enumerate(zip(traffic, outs32)):
        ref = model32.reference_generate(
            p, NEW_TOKENS, window=WINDOW, draft_tokens=DRAFT,
            kv_dtype="int8", cached_prefix_len=cached, **samp)
        if not np.array_equal(o, ref):
            bad.append(i)
        if not samp and not np.array_equal(o, model32.reference_generate(
                p, NEW_TOKENS, window=WINDOW, kv_dtype="int8",
                cached_prefix_len=cached)):
            spec_bad.append(i)
    log(f"[engine float32] {len(traffic) - len(bad)}/{len(traffic)} requests "
        f"token-exact against the 1-slot reference_generate (draft "
        f"{DRAFT}, int8, the hits at cached_prefix_len {SYSTEM_LEN}); "
        f"{len(traffic) // 2 - len(spec_bad)}/{len(traffic) // 2} greedy "
        f"requests equal the draft_tokens=0 reference ({wall32:.3f} s "
        f"served, references {time.perf_counter() - t0:.3f} s)")
    assert not bad, f"engine != reference for requests {bad}"
    assert not spec_bad, f"speculation changed greedy requests {spec_bad}"
    return {"wall_s": wall, "tokens": tokens, "launches": launches,
            "float32_launches": launches32,
            "stats": st, "float32_stats": st32,
            "slots_per_gib": eng.pool.slots_per_gb(),
            "bf16_slots_per_gib": bf16_pool.slots_per_gb()}


# ---------------------------------------------------------------------------
# phase 10: the off-flagship shapes the kernels cover (ROADMAP C1)
# ---------------------------------------------------------------------------
COVER_NEW_TOKENS = 24
# fused against unfused Dense(10, "relu"), float32, TF32 off, one SGD step:
# the bias add rounds once in both (in the kernel, or in cuBLAS's addmm
# epilogue), so the loss and every updated weight agree to a few ulps
DENSE_RTOL = 1e-5


def _counted(fn, **want):
    """Run fn() on counts set to 0 and assert the launches it made are
    exactly `want` (every other counter 0). Returns fn's result."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    expect = dict(dict.fromkeys(got, 0), **want)
    assert got == expect, f"launches {got}, expected {want}"
    return out


# float32 decoders behind the engine's default knobs: DecoderConfig's
# defaults (head_dim 16, 4 heads, 2 layers, vocab 256) at max_len 64, the
# port's own docstring example; 2 heads x 256 (the capacity-256 instance of
# the paged kernel); and 2 heads x 384 (its 128-column slices)
COVER_CONFIGS = (dict(max_len=64),
                 dict(max_len=64, embed=512, heads=2, head_dim=256),
                 dict(max_len=64, embed=768, heads=2, head_dim=384))


def cover_engine(dev, cfg):
    """`ContinuousEngine` over `CachedDecoder(DecoderConfig(**cfg))`, float32,
    token-exact against `reference_generate`, every paged read on the
    kernel."""
    model = serve.CachedDecoder(serve.DecoderConfig(**cfg), seed=0,
                                device=dev)
    rng = np.random.RandomState(10)
    prompts = [rng.randint(1, model.config.vocab, size=int(n)).tolist()
               for n in np.linspace(3, 36, 6).astype(int)]
    with serve.ContinuousEngine(model, max_slots=8) as eng:
        kernels.reset_launch_counts()
        futs = [eng.submit(p, COVER_NEW_TOKENS) for p in prompts]
        outs = [f.result(timeout=300) for f in futs]
        launches = kernels.launch_counts()
        st = eng.stats()
        window = eng.prefill_window
        want = model.config.layers * (eng.decode_steps
                                      * st["decode_iterations"]
                                      + st["chunk_batches"])
    exact = sum(int(np.array_equal(o, model.reference_generate(
        p, COVER_NEW_TOKENS, window=window))) for p, o in zip(prompts, outs))
    log(f"[cover] engine at head_dim {model.config.head_dim} float32: "
        f"{exact}/{len(prompts)} requests token-exact against "
        f"reference_generate; paged_attention launches "
        f"{launches['paged_attention']} (expected {want})")
    hd = model.config.head_dim
    assert launches["paged_attention"] == want > 0, \
        f"head_dim {hd} engine off the kernel"
    # float32: decode on the split route, chunks (if any) on the CUDA cores
    assert launches["paged_attention_wgmma"] == 0 and \
        launches["paged_attention_split"] + \
        launches["paged_attention_cuda_cores"] == want, \
        f"head_dim {hd} engine off its routes {launches}"
    assert exact == len(prompts), f"head_dim {hd} engine != reference"
    return {"head_dim": hd, "requests": len(prompts),
            "token_exact": exact, "launches": launches["paged_attention"]}


# phase 10's float16 engine streams prompts in 32-position windows, so the
# longest (36 tokens) reads a chunk (C = 32) through the paged kernel
COVER_F16_WINDOW = 32


def cover_engine_f16(dev):
    """`ContinuousEngine` over a float16 `CachedDecoder(DecoderConfig(
    max_len=64))` (a float16 pool on the card, head_dim 16) with a
    COVER_F16_WINDOW prefill window: every request answered, every paged
    read on the kernel with float16 q and slab, decode on the split route
    and chunks on the tensor cores, as bfloat16's (`check_routes`). Token equality with
    `reference_generate` is read, not held: float16 greedy may part at
    near-ties, as bfloat16 in phase 3."""
    model = serve.CachedDecoder(serve.DecoderConfig(max_len=64,
                                                    dtype="float16"),
                                seed=0, device=dev)
    rng = np.random.RandomState(13)
    prompts = [rng.randint(1, model.config.vocab, size=int(n)).tolist()
               for n in np.linspace(3, 36, 6).astype(int)]
    with serve.ContinuousEngine(model, max_slots=8,
                                prefill_window=COVER_F16_WINDOW) as eng:
        assert eng.pool.k.dtype == torch.float16 and \
            eng.pool.k.device.type == dev.type
        kernels.reset_launch_counts()
        futs = [eng.submit(p, COVER_NEW_TOKENS) for p in prompts]
        outs = [f.result(timeout=300) for f in futs]
        launches = kernels.launch_counts()
        by_dtype = kernels.launch_counts_by_dtype()
        st = eng.stats()
        window = eng.prefill_window
        want = model.config.layers * (eng.decode_steps
                                      * st["decode_iterations"]
                                      + st["chunk_batches"])
        check_routes("cover float16", "float16", model.config, eng, st,
                     launches)
    for p, o in zip(prompts, outs):
        assert o.shape == (COVER_NEW_TOKENS,) and \
            ((o >= 0) & (o < model.config.vocab)).all(), \
            f"float16 engine: prompt of {len(p)} tokens gave {o}"
    exact = sum(int(np.array_equal(o, model.reference_generate(
        p, COVER_NEW_TOKENS, window=window))) for p, o in zip(prompts, outs))
    f16 = (by_dtype.get(("paged_attention_q", "float16"), 0),
           by_dtype.get(("paged_attention_kv", "float16"), 0))
    log(f"[cover] float16 engine (head_dim {model.config.head_dim}, float16 "
        f"pool on the card): {len(outs)}/{len(prompts)} requests answered, "
        f"{exact} equal to reference_generate; paged launches "
        f"{launches['paged_attention']} (expected {want}), float16 q / slab "
        f"{f16}, routes split {launches['paged_attention_split']} "
        f"wgmma {launches['paged_attention_wgmma']}")
    assert launches["paged_attention"] == want > 0 and f16 == (want, want), \
        "float16 engine off the kernel"
    assert launches["paged_attention_wgmma"] > 0, \
        f"float16 engine ran no chunk on the tensor cores {launches}"
    return {"requests": len(prompts), "answered": len(outs),
            "token_equal": exact, "launches": launches}


# fused against unfused Dense(10, "relu") under float16 AMP, one SGD step:
# the fused path rounds the product to float16 and then the bias + relu
# once more, the unfused one rounds the product with its bias once, so
# outputs part by up to one float16 step; the loss and the updated weights
# are held to four of them (2^-9)
DENSE16_RTOL = 2.0 ** -9


def cover_dense_f16(dev):
    """`cover_dense` under `amp.init("float16")`: the fused Dense takes
    the apply kernel's float16 instance (`bias_act` is an AMP `safe` op),
    one launch a step."""
    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.randn(64, 32).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 10, 64).astype(np.int32)).to(dev)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    amp.init("float16")
    try:
        for use_fusion in (True, False):
            net = gluon.nn.Dense(10, activation="relu").initialize(
                device=dev, seed=3)
            net(x)                                  # resolve in_units
            step = FusedTrainStep(
                net, lambda n, a, b: loss_fn(n(a), b).sum(),
                optimizer.create("sgd", learning_rate=0.1,
                                 rescale_grad=1.0 / 64),
                use_fusion=use_fusion)
            kernels.reset_launch_counts()
            loss = float(step(x, y))
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            by_dtype = kernels.launch_counts_by_dtype()
            runs.append((loss, {n: p.data().detach().clone() for n, p in
                                net.collect_params().items()}, launches,
                         by_dtype))
    finally:
        amp.uninit()
    (fl, fw, fla, fby), (ul, uw, ula, _) = runs
    rel = {n: ((fw[n] - uw[n]).abs().max() / uw[n].abs().max()).item()
           for n in uw}
    loss_rel = abs(fl - ul) / abs(ul)
    log(f"[cover] Dense(10, relu) float16-AMP step fused {fl!r} unfused "
        f"{ul!r} (rel {loss_rel:.2e}); weights, max |fused - unfused| / "
        f"max |unfused|: {rel} (tol {DENSE16_RTOL:.2e}); fused launches "
        f"{fby}")
    assert fby == {("scale_shift_act", "float16"): 1} and \
        fla["scale_shift_act"] == 1 and ula["scale_shift_act"] == 0, \
        "the float16 Dense step off the apply kernel"
    assert loss_rel <= DENSE16_RTOL and all(r <= DENSE16_RTOL
                                            for r in rel.values()), \
        "fused Dense(10) float16 step != unfused"
    return {"loss_fused": fl, "loss_unfused": ul, "loss_rel": loss_rel,
            "weight_rel": rel, "launches": fla["scale_shift_act"]}


def cover_paged_wide(dev, gen):
    """The paged kernel at head_dim 256, 320 and 512 against its plain
    version: bfloat16 and int8 pools (codes and scales from the engine's
    quantizer) under float32 and bfloat16 queries, one query, a 9-row and a
    40-row chunk (split and CUDA-core routes), ragged lengths with 0 and
    T - C; phase 2's and phase 8's limits."""
    from incubator_mxnet_tpu_torch.serve.continuous import _quantize_kv
    S, L, T, H = 4, 2, 80, 2
    out = []
    for D, kv, C, qd in itertools.product(
            (256, 320, 512), ("bfloat16", "int8"), (1, 9, 40),
            (torch.float32, torch.bfloat16)):
        q = torch.randn((S, C, H, D), generator=gen, device=dev).to(qd)
        k, v = (torch.randn((S + 1, L, T, H, D), generator=gen,
                            device=dev) for _ in range(2))
        sc = {}
        if kv == "int8":
            (k, ks), (v, vs) = (_quantize_kv(x) for x in (k, v))
            sc = dict(k_scale=ks, v_scale=vs)
        else:
            k, v = k.bfloat16(), v.bfloat16()
        lens = torch.tensor([0, 5, 40, T - C], dtype=torch.int32,
                            device=dev)
        route = kernels.paged_route(qd, k.dtype, D, C)
        got = _counted(lambda: kernels.paged_attention_cuda(
            q, k, v, lens, 1, **sc), **{
                "paged_attention_int8" if sc else "paged_attention":
                    1, f"paged_attention_{route}": 1})
        err, ok, read = paged_err(
            got, fused.paged_attention_ref(q, k, v, lens, 1, **sc))
        rec = {"head_dim": D, "kv": kv, "C": C, "q": _dtype_name(qd),
               "kernel_route": route, "max_abs_err": err, **read}
        log(f"[cover] paged attention head_dim {D}: {rec}")
        assert ok, f"paged attention at head_dim {D} {rec}"
        out.append(rec)
    return out


# MultiHeadAttention(use_flash=True) at head_dim 192 (384 units, 2 heads)
# and 384 (768 units, 2 heads: 128-column slices):
# the forward and the input and weight gradients against use_flash=False
# (the SDPA composition) from the same weights, float32, TF32 off, each
# relative to its own size; the key projection's bias is left out, as in
# phase 7 (its gradient is zero in exact arithmetic)
MHA_RTOL = 1e-4
MHA_SKIP = "key_proj.bias"


def cover_mha(dev, units):
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(2, 96, units).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(2, 96, units).astype(np.float32)).to(dev)
    runs = []
    for use_flash in (True, False):
        net = gluon.nn.MultiHeadAttention(units, 2, use_flash=use_flash)
        net.initialize(device=dev, seed=4)
        xi = x.clone().requires_grad_()
        named = {n: p.data() for n, p in net.collect_params().items()
                 if p.grad_req != "null" and n != MHA_SKIP}

        def run():
            with autograd.record(train_mode=False):
                y = net(xi, causal=True)
            grads = torch.autograd.grad(y, [xi] + list(named.values()), g,
                                        allow_unused=True)
            return dict(zip(["out", "x"] + list(named), (y,) + grads))
        want = dict(flash_fwd_lse=1, flash_bwd_dq=1, flash_bwd_dkv=1) \
            if use_flash else {}
        runs.append(_counted(run, **want))
    rel = {n: ((a - runs[1][n]).abs().max() / runs[1][n].abs().max())
           .item() for n, a in runs[0].items()}
    worst = max(rel, key=rel.get)
    hd = units // 2
    log(f"[cover] MultiHeadAttention({units}, 2) head_dim {hd} causal, "
        f"flash against SDPA, float32: output and gradients, max |a - b| / "
        f"max |b|: worst {rel[worst]:.3e} at {worst} (tol {MHA_RTOL})")
    assert rel[worst] <= MHA_RTOL, f"head_dim {hd} flash attention != SDPA"
    return {"head_dim": hd, "rel": rel}


def cover_dense(dev):
    """One FusedTrainStep SGD step of `Dense(10, "relu")` on float32 data
    with fusion on (the bias and relu in the apply kernel, rows of 40
    bytes) and off, from the same weights and batch."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(64, 32).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 10, 64).astype(np.int32)).to(dev)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    for use_fusion in (True, False):
        net = gluon.nn.Dense(10, activation="relu", in_units=32).initialize(
            device=dev, seed=3)
        step = FusedTrainStep(
            net, lambda n, a, b: loss_fn(n(a), b).sum(),
            optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                             rescale_grad=1.0 / 64), use_fusion=use_fusion)
        loss = _counted(lambda: float(step(x, y)),
                        **({"scale_shift_act": 1} if use_fusion else {}))
        runs.append((loss, {n: p.data().detach().clone() for n, p in
                            net.collect_params().items()}))
    (fl, fw), (ul, uw) = runs
    rel = {n: ((fw[n] - uw[n]).abs().max() / uw[n].abs().max()).item()
           for n in uw}
    loss_rel = abs(fl - ul) / abs(ul)
    log(f"[cover] Dense(10, relu) float32 step fused {fl!r} unfused {ul!r} "
        f"(rel {loss_rel:.2e}); weights after the step, max |fused - "
        f"unfused| / max |unfused|: {rel} (tol {DENSE_RTOL})")
    assert loss_rel <= DENSE_RTOL and all(r <= DENSE_RTOL
                                          for r in rel.values()), \
        "fused Dense(10) step != unfused"
    return {"loss_fused": fl, "loss_unfused": ul, "loss_rel": loss_rel,
            "weight_rel": rel}


# pools off the flagship, as (shape, window, dtype, offset of x): float32
# channels no multiple of 4 (one channel a thread), a window of more than
# 64 positions (a slice of the window route loads it in more than one
# batch), pixel counts past the grid's 65535 rows (the grid-stride loops of
# both routes), inputs off 16-byte alignment (one channel a thread)
COVER_POOLS = (((8, 14, 14, 10), (2, 2), torch.float32, 0),
               ((4, 14, 14, 16), (14, 14), torch.bfloat16, 0),
               ((70000, 5, 5, 8), (5, 5), torch.float32, 0),
               ((4, 4096, 4096, 1), (2, 2), torch.bfloat16, 0),
               ((8, 14, 14, 64), (2, 2), torch.bfloat16, 1),
               ((8, 7, 7, 64), (7, 7), torch.float32, 1))


def phase_coverage(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(10)
    engines = [cover_engine(dev, cfg) for cfg in COVER_CONFIGS]
    paged_wide = cover_paged_wide(dev, gen)
    mha = [cover_mha(dev, units) for units in (384, 768)]
    dense = cover_dense(dev)
    engine16 = cover_engine_f16(dev)
    dense16 = cover_dense_f16(dev)
    pools = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for shape, pool in (((8, 14, 14, 12), (2, 2)),
                            ((8, 7, 7, 12), (7, 7))):
            pools.append(_counted(
                lambda: check_pool(shape, pool, dtype, gen, dev, False),
                avg_pool2d_fwd=1, avg_pool2d_bwd=1))
    for shape, pool, dtype, offset in COVER_POOLS:
        pools.append(_counted(
            lambda: check_pool(shape, pool, dtype, gen, dev, False,
                               offset=offset),
            avg_pool2d_fwd=1, avg_pool2d_bwd=1))
    applies = []
    for c, dtype in ((10, torch.float32), (4, torch.bfloat16)):
        for act, residual in ((None, False), ("relu", True),
                              ("gelu", False)):
            applies.append(_counted(
                lambda: check_apply(6000, c, act, residual, dtype, gen, dev,
                                    False), scale_shift_act=1))
    kernels.reset_launch_counts()
    return {"engine": engines[0], "engines": engines,
            "paged_wide": paged_wide, "mha": mha, "dense": dense,
            "engine_f16": engine16, "dense_f16": dense16,
            "pools": pools, "applies": applies}


# ---------------------------------------------------------------------------
# phase 11: the imperative Gluon training loop at full width
# ---------------------------------------------------------------------------
LOOP_WARMUP, LOOP_STEPS, LOOP_F16_STEPS = 2, 10, 3
# GluonNLP's BERT pretraining: LAMB (You et al. 2019, arXiv:1904.00962)
# with poly decay after a linear warmup, no weight decay on LayerNorm's
# beta and gamma and on the biases
NO_DECAY = ".*beta|.*gamma|.*bias"
LAMB = dict(learning_rate=1e-4, wd=0.01, epsilon=1e-6)
POLY = dict(max_update=LOOP_WARMUP + LOOP_STEPS, base_lr=1e-4, pwr=1,
            warmup_steps=4)
# GluonCV's train_imagenet.py: NAG, momentum 0.9, wd 1e-4, lr 0.1 per 256
# images, cosine decay after a linear warmup
NAG = dict(learning_rate=0.1 * BATCH / 256, momentum=0.9, wd=1e-4)
COSINE = dict(max_update=LOOP_WARMUP + LOOP_STEPS, base_lr=NAG[
    "learning_rate"], warmup_steps=2)
# the float32 checks of (d): phase 7's limits (2 layers at full width,
# batch 4, dropout 0, TF32 off, the key projection's bias left out)
LOOP_CHECK_STEPS = 2


def loop_step(net, trainer, loss_fn, x, y):
    """One step as a Gluon script writes it: record, backward from the
    per-sample loss (seeded with ones), `trainer.step(batch)`."""
    with autograd.record():
        loss = loss_fn(net(x), y)
    autograd.backward(loss)
    trainer.step(x.shape[0])
    return loss.detach()


def c4_copies(net, steps):
    """The elementwise launches a step that writing each gradient into its
    Parameter's own buffer (ROADMAP C4) adds: one copy per overwritten
    gradient, read from `autograd.buffer_copies` over `steps` steps. With
    grad_req "write" it is one per trainable Parameter a step."""
    per_step = autograd.buffer_copies() / steps
    trainable = sum(p.grad_req != "null"
                    for p in net.collect_params().values())
    return {"copies_per_step": per_step, "trainable_parameters": trainable}


def _timed_loop(step, batches, warmup, steps):
    """(losses, wall seconds) of `steps` calls of step(*batch) after
    `warmup` untimed ones, the counts (and `autograd.buffer_copies`) set to
    0 in between."""
    for i in range(warmup):
        step(*batches[i % len(batches)])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    autograd.buffer_copies(reset=True)
    t0 = time.perf_counter()
    out = [step(*batches[i % len(batches)]) for i in range(steps)]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def loop_bert(card, dev, profile):
    """(a) BERT-base, built without the head's and final LayerNorm's
    widths, through LAMB + PolyScheduler under bf16 AMP."""
    L = BERT["layers"]
    batches = token_batches(2, BERT_BATCH, seed=31, dev=dev)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    amp.init("bfloat16")
    try:
        net = BertEncoderLM(L, True, BERT["dropout"], deferred=True) \
            .initialize(device=dev, seed=0)
        params = net.collect_params()
        pending = sorted(n for n, p in params.items() if p._data is None)
        assert pending == ["head.weight", "ln.beta", "ln.gamma"], pending
        for p in net.collect_params(NO_DECAY).values():
            p.wd_mult = 0.0
        trainer = gluon.Trainer(params, "lamb", dict(
            LAMB, lr_scheduler=lr_scheduler.PolyScheduler(**POLY)))
        rates = []

        def step(x, y):
            rates.append(trainer.learning_rate)
            return loop_step(net, trainer, loss_fn, x, y)
        losses, wall = _timed_loop(step, batches, LOOP_WARMUP, LOOP_STEPS)
        launches = kernels.launch_counts()
        c4 = c4_copies(net, LOOP_STEPS)
        prof = profile_steps(
            lambda x, y: loop_step(net, trainer, loss_fn, x, y), batches,
            wall / LOOP_STEPS * 1e3, FLASH_SYMBOLS, "loop bert") \
            if profile else None
    finally:
        amp.uninit()
    shapes = {n: params[n].shape for n in pending}
    want_rates = [lr_scheduler.PolyScheduler(**POLY)(k)
                  for k in range(LOOP_WARMUP + LOOP_STEPS)]
    losses = [float(v.float().mean()) for v in losses]
    step_ms = wall / LOOP_STEPS * 1e3
    tokens_s = BERT_BATCH * BERT_SEQ * LOOP_STEPS / wall
    log(f"[loop bert] deferred {pending} resolved at the first forward to "
        f"{shapes}; {len(net.collect_params(NO_DECAY))} values without "
        f"weight decay; LAMB {LAMB} with PolyScheduler {POLY}")
    log(f"[loop bert] {card}: {LOOP_STEPS} imperative steps (record, "
        f"autograd.backward, trainer.step) of batch {BERT_BATCH} x "
        f"{BERT_SEQ}, bf16 AMP, in {wall:.3f} s: {step_ms:.3f} ms/step, "
        f"{tokens_s:.1f} tokens/s; losses {[round(v, 4) for v in losses]}; "
        f"learning rates {rates}")
    log(f"[loop bert] launches {launches} (expected {L} each of "
        f"flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv a step, all on the "
        f"tensor cores)")
    log(f"[loop bert] gradient buffers (C4): the backward writes each "
        f"gradient into its Parameter's buffer, {c4['copies_per_step']:.1f} "
        f"copies (elementwise launches) a step over "
        f"{c4['trainable_parameters']} trainable Parameters")
    assert all(np.isfinite(losses)), "non-finite BERT loop loss"
    assert shapes == {"head.weight": (BERT["vocab"], BERT["units"]),
                      "ln.beta": (BERT["units"],),
                      "ln.gamma": (BERT["units"],)}, shapes
    assert rates == want_rates, f"learning rates {rates} != {want_rates}"
    want = dict.fromkeys(launches, 0)
    for n in FLASH_KERNELS[1:]:
        want[n] = want[FLASH_WGMMA[n]] = L * LOOP_STEPS
    assert launches == want, "flash launch count off the imperative loop"
    assert c4["copies_per_step"] == c4["trainable_parameters"], \
        f"gradient copies a step {c4}"
    return net, batches, {"step_ms": step_ms, "tokens_per_s": tokens_s,
                          "losses": losses, "rates": rates,
                          "launches": launches, "deferred": shapes,
                          "c4": c4, "profile": prof}


def loop_resnet(card, dev, profile):
    """(b) ResNet-50 v1 NHWC through NAG + CosineScheduler under bf16 AMP
    with the fusion default on: the eager loop takes the fused ops."""
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b)
               for b in make_batches(2, BATCH, seed=41)]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    amp.init("bfloat16")
    prev = fused.set_fusion_default(True)
    try:
        net = vision.resnet50_v1(layout="NHWC", classes=CLASSES,
                                 device=dev, seed=0)
        trainer = gluon.Trainer(net.collect_params(), "nag", dict(
            NAG, lr_scheduler=lr_scheduler.CosineScheduler(**COSINE)))
        step = lambda x, y: loop_step(net, trainer, loss_fn, x, y)
        losses, wall = _timed_loop(step, batches, LOOP_WARMUP, LOOP_STEPS)
        launches = kernels.launch_counts()
        c4 = c4_copies(net, LOOP_STEPS)
        prof = profile_steps(step, batches, wall / LOOP_STEPS * 1e3,
                             KERNEL_SYMBOLS, "loop resnet") \
            if profile else None
    finally:
        fused.set_fusion_default(prev)
        amp.uninit()
    losses = [float(v.float().mean()) for v in losses]
    step_ms = wall / LOOP_STEPS * 1e3
    ips = BATCH * LOOP_STEPS / wall
    log(f"[loop resnet] {card}: {LOOP_STEPS} imperative steps of batch "
        f"{BATCH} x {IMAGE}^2, bf16 AMP, fusion default on, NAG {NAG} with "
        f"CosineScheduler {COSINE}, in {wall:.3f} s: {step_ms:.3f} ms/step, "
        f"{ips:.1f} images/s; losses {[round(v, 4) for v in losses]}; "
        f"launches {launches} (expected 53, 1, 1 a step); gradient "
        f"buffers (C4): {c4['copies_per_step']:.1f} copies a step over "
        f"{c4['trainable_parameters']} trainable Parameters")
    assert all(np.isfinite(losses)), "non-finite ResNet loop loss"
    assert launches["scale_shift_act"] == 53 * LOOP_STEPS \
        and launches["avg_pool2d_fwd"] == LOOP_STEPS \
        and launches["avg_pool2d_bwd"] == LOOP_STEPS, \
        "kernel launch count off the imperative loop"
    del net, trainer
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "images_per_s": ips, "losses": losses,
            "launches": launches, "c4": c4, "profile": prof}


def captured_backward(calls):
    """The float16 sweeps against their plain versions on the backward
    inputs (q, k, v, dO, lse, delta) each layer handed B7/B8 in a training
    step under the loss scaler: the path's own magnitudes, phase 6's
    limits. Returns the worst readings and the largest |dO| and |dS|."""
    worst, max_do, max_ds = {}, 0.0, 0.0
    for args in calls:
        q, k, v, do, lse, delta, causal, scale = args
        dq = kernels.flash_bwd_dq_cuda(*args)
        dk, dv = kernels.flash_bwd_dkv_cuda(*args)
        refs = dict(zip(("dq", "dk", "dv"), (
            attention.flash_bwd_dq_ref(*args),
            *attention.flash_bwd_dkv_ref(*args))))
        p = attention._probs(q, k, lse, causal, scale)
        ds = p * (torch.einsum("bqd,bkd->bqk", do.float(), v.float())
                  - delta)
        max_do = max(max_do, do.float().abs().max().item())
        max_ds = max(max_ds, ds.abs().max().item())
        del p, ds
        for name, out in (("dq", dq), ("dk", dk), ("dv", dv)):
            assert torch.isfinite(out.float()).all(), \
                f"non-finite captured float16 {name}"
            _, ok, read = _flash_err(out, refs[name], q.dtype)
            assert ok, f"captured float16 {name} off its plain version: " \
                       f"{read}"
            for key, val in read.items():
                worst[f"{name} {key}"] = max(worst.get(f"{name} {key}", 0.0),
                                             val)
    return {"layers": len(calls), "worst": worst, "max_abs_do": max_do,
            "max_abs_ds": max_ds}


def loop_f16(card, dev, net, batches, profile):
    """(c) (a)'s model and batch under float16 AMP with dynamic loss
    scaling; every flash kernel (B6 forward, B7/B8 backward) on its float16
    tensor-core instance; then one plain inference forward `net(x)` (B5 in
    float16 on the tensor cores, nothing taped) and one step with an inf
    planted in a gradient, which must be skipped; the backward inputs of
    that step's layers, the loss scaler's magnitudes, are held against the
    plain versions (`captured_backward`)."""
    L = BERT["layers"]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    amp.init("float16")
    try:
        trainer = gluon.Trainer(net.collect_params(), "lamb", dict(
            LAMB, lr_scheduler=lr_scheduler.PolyScheduler(**POLY)))
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler

        def step(x, y):
            with autograd.record():
                loss = loss_fn(net(x), y)
            with amp.scale_loss(loss, trainer) as scaled:
                autograd.backward(scaled)
            ran = amp.step_with_overflow_check(trainer, x.shape[0])
            return loss.detach(), ran, scaler.loss_scale
        out, wall = _timed_loop(step, batches, LOOP_WARMUP, LOOP_F16_STEPS)
        launches = kernels.launch_counts()
        by_dtype = kernels.launch_counts_by_dtype()
        prof = profile_steps(step, batches, wall / LOOP_F16_STEPS * 1e3,
                             FLASH_SYMBOLS, "loop f16") if profile else None
        kernels.reset_launch_counts()
        logits = net(batches[0][0])
        torch.cuda.synchronize()
        infer = kernels.launch_counts_by_dtype()
        infer_counts = kernels.launch_counts()
        # the planted overflow, its backward's flash inputs captured
        x, y = batches[0]
        calls = []
        backward = attention._backward

        def capture(*args):
            calls.append(tuple(a.detach().clone() if torch.is_tensor(a)
                               else a for a in args))
            return backward(*args)
        attention._backward = capture
        try:
            with autograd.record():
                loss = loss_fn(net(x), y)
            with amp.scale_loss(loss, trainer) as scaled:
                autograd.backward(scaled)
        finally:
            attention._backward = backward
        victim = net.collect_params()["cells.3.ffn1.weight"]
        g = victim.grad().view(-1)
        g[g.numel() // 3] = float("inf")
        before = {n: p.data().clone()
                  for n, p in net.collect_params().items()}
        scale0 = scaler.loss_scale
        ran = amp.step_with_overflow_check(trainer, x.shape[0])
        torch.cuda.synchronize()
        unchanged = all(torch.equal(p.data(), before[n])
                        for n, p in net.collect_params().items())
    finally:
        amp.uninit()
    captured = captured_backward(calls)
    del calls
    kernels.reset_launch_counts()   # comparison launches do not count
    losses = [float(v.float().mean()) for v, _, _ in out]
    ran_steps = [r for _, r, _ in out]
    scales = [sc for _, _, sc in out]
    step_ms = wall / LOOP_F16_STEPS * 1e3
    tokens_s = BERT_BATCH * BERT_SEQ * LOOP_F16_STEPS / wall
    log(f"[loop f16] {card}: {LOOP_F16_STEPS} float16-AMP steps (scale_loss,"
        f" step_with_overflow_check) in {wall:.3f} s: {step_ms:.3f} ms/step,"
        f" {tokens_s:.1f} tokens/s; losses {[round(v, 4) for v in losses]};"
        f" updates ran {ran_steps}, loss scales {scales}; flash launches by "
        f"type {by_dtype}; inference forward {infer}")
    log(f"[loop f16] planted inf in cells.3.ffn1.weight's gradient: step ran "
        f"{ran}, weights unchanged {unchanged}, scale {scale0} -> "
        f"{scaler.loss_scale}")
    max_tol, rms_tol = limits16(torch.float16)
    log(f"[loop f16] that step's backward inputs, {captured['layers']} "
        f"layers under loss scale {scale0}: max |dO| "
        f"{captured['max_abs_do']:.3e}, max |dS| "
        f"{captured['max_abs_ds']:.3e}; the float16 tensor-core sweeps "
        f"against their plain versions, worst {captured['worst']} (limits "
        f"max_rel {max_tol:.3e}, rms_rel {rms_tol:.3e})")
    if prof is not None:
        ms = prof["kernels_ms_per_step"]
        log(f"[loop f16 profile] flash device ms a step: B6 "
            f"{ms['flash_fwd_wgmma']:.3f}, B7 {ms['flash_bwd_dq_wgmma']:.3f}"
            f", B8 {ms['flash_bwd_dkv_wgmma']:.3f} on the tensor cores "
            f"(CUDA-core kernels {ms['flash_fwd']:.3f} / "
            f"{ms['flash_bwd_dq']:.3f} / {ms['flash_bwd_dkv']:.3f}), of "
            f"{prof['device_ms_per_step']:.3f} device ms")
    assert all(np.isfinite(losses)), "non-finite float16 loop loss"
    assert captured["layers"] == L, f"captured {captured['layers']} layers"
    n = L * LOOP_F16_STEPS
    # B6, B7 and B8 all on their float16 tensor-core instances
    tc = [FLASH_WGMMA[k] for k in FLASH_KERNELS[1:]]
    assert by_dtype == {(k, "float16"): n for k in
                        list(FLASH_KERNELS[1:]) + tc} and \
        all(launches[k] == n for k in list(FLASH_KERNELS[1:]) + tc), \
        "float16 flash launches off their routes"
    assert infer == {("flash_fwd", "float16"): L,
                     ("flash_fwd_wgmma", "float16"): L} and \
        infer_counts["flash_fwd_wgmma"] == L and \
        infer_counts["flash_fwd_lse"] == 0, \
        f"float16 inference launches {infer} {infer_counts}"
    assert logits.grad_fn is None, "the float16 inference forward was taped"
    assert logits.shape == (BERT_BATCH, BERT_SEQ, BERT["vocab"]) and \
        torch.isfinite(logits.float()).all(), "float16 logits not finite"
    assert not ran and unchanged and scaler.loss_scale == scale0 / 2, \
        "the planted overflow was not skipped"
    return {"step_ms": step_ms, "tokens_per_s": tokens_s, "losses": losses,
            "updates_ran": ran_steps, "loss_scales": scales,
            "launches": launches, "by_dtype": {f"{k}/{d}": v for (k, d), v
                                              in by_dtype.items()},
            "infer_launches": infer[("flash_fwd", "float16")],
            "infer_wgmma_launches": infer_counts["flash_fwd_wgmma"],
            "profile": prof, "captured_backward": captured,
            "planted_scale": [scale0, scaler.loss_scale]}


def loop_f32_checks(dev):
    """(d) float32, TF32 off, dropout 0, FLASH_CHECK_LAYERS layers at full
    width, batch FLASH_CHECK_BATCH: two Trainer-loop Adam steps against two
    FusedTrainStep Adam steps, and grad_req "add" over two half-batches
    against "write" over the batch (SGD with momentum), from the same
    weights; phase 7's limits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y = token_batches(1, FLASH_CHECK_BATCH, seed=42, dev=dev)[0]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def new_net():
        return BertEncoderLM(FLASH_CHECK_LAYERS, True, 0.0).initialize(
            device=dev, seed=1)
    init = new_net().collect_params()
    out = {}
    # Trainer loop against FusedTrainStep, Adam
    a = new_net()
    tr = gluon.Trainer(a.collect_params(), "adam",
                       {"learning_rate": BERT_LR})
    la = [float(loop_step(a, tr, loss_fn, x, y).mean())
          for _ in range(LOOP_CHECK_STEPS)]
    b = new_net()
    step = bert_step(b, optimizer.create("adam", learning_rate=BERT_LR))
    lb = [float(step(x, y)) for _ in range(LOOP_CHECK_STEPS)]
    # grad_req "add" over two half-batches against "write"
    c, d = new_net(), new_net()
    c.setattr("grad_req", "add")
    sgd = {"learning_rate": FLASH_CHECK_LR, "momentum": 0.9}
    trc = gluon.Trainer(c.collect_params(), "sgd", dict(sgd))
    trd = gluon.Trainer(d.collect_params(), "sgd", dict(sgd))
    half = FLASH_CHECK_BATCH // 2
    for _ in range(LOOP_CHECK_STEPS):
        for part in (slice(0, half), slice(half, None)):
            with autograd.record():
                loss = loss_fn(c(x[part]), y[part])
            autograd.backward(loss)
        trc.step(FLASH_CHECK_BATCH)
        loop_step(d, trd, loss_fn, x, y)
    kernels.reset_launch_counts()
    for tag, (p, q), losses in (("Trainer against FusedTrainStep (Adam)",
                                 (a, b), (la, lb)),
                                ("add over halves against write (SGD)",
                                 (c, d), None)):
        rel = update_parting(init, p.collect_params(), q.collect_params())
        held = {n: r for n, r in rel.items()
                if not n.endswith(FLASH_CHECK_SKIP)}
        worst = max(held, key=held.get)
        loss_rel = 0.0 if losses is None else max(
            abs(u - v) / max(abs(v), 1e-6) for u, v in zip(*losses))
        log(f"[loop float32] {tag}: losses {losses}, max rel {loss_rel:.2e}"
            f" (tol {FLASH_CHECK_LOSS_RTOL}); update parting |dA - dB| / "
            f"|dB| over {len(held)} weights: median "
            f"{float(np.median(list(held.values()))):.3e}, worst "
            f"{held[worst]:.3e} at {worst} (tol {FLASH_CHECK_UPDATE_RTOL})")
        assert loss_rel <= FLASH_CHECK_LOSS_RTOL, f"{tag}: losses part"
        assert held[worst] <= FLASH_CHECK_UPDATE_RTOL, \
            f"{tag}: updates part at {worst}: {held[worst]:.3e}"
        out[tag] = {"loss_max_rel": loss_rel, "update_rel_worst":
                    held[worst], "worst_at": worst,
                    "update_rel_median": float(np.median(
                        list(held.values())))}
    return out


def phase_loop(card, dev, profile):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    net, batches, bert = loop_bert(card, dev, profile)
    resnet = loop_resnet(card, dev, profile)
    f16 = loop_f16(card, dev, net, batches, profile)
    del net, batches
    torch.cuda.empty_cache()
    checks = loop_f32_checks(dev)
    log(f"[loop] phase 11 took {time.perf_counter() - t0:.1f} s")
    return {"bert": bert, "resnet": resnet, "f16": f16, "f32": checks}


# ---------------------------------------------------------------------------
# phase 12: the Gluon script surface, GluonCV's recipe on ResNet-50 v2
# ---------------------------------------------------------------------------
# GluonCV's scripts/classification/imagenet/train_imagenet.py with
# --label-smoothing: MSRAPrelu init, NAG (phase 11 b's schedule), no weight
# decay on beta / gamma / bias, one-hot labels smoothed by 0.1 through
# SoftmaxCrossEntropyLoss(sparse_label=False), split_and_load, and
# RMSE against the softmax as its training metric
SMOOTHING = 0.1
INFER_CALLS = 8
V2_CHECK_BATCH, V2_CHECK_STEPS = 4, 1
# MSRAPrelu's draws on the card: each convolution weight's std within this
# share of sqrt(magnitude / ((fan_in + fan_out) / 2)), MXNet's fans (the
# smallest ResNet-50 v2 convolution has 4096 values: a sampling error of
# 1.1%)
MSRA_STD_RTOL = 0.03
# the layer sweep of (e): float32 on the card against the CPU within
# SWEEP_RTOL relative plus SWEEP_RTOL times the output's largest value
# (TF32 off: only the summation order differs); a 16-bit run within two
# steps of its type of the CPU's float32 result on the same rounded
# values, relative to the largest value
SWEEP_RTOL = 1e-5
SWEEP_STEPS16 = 2


def resnet50_v2_apply_rows(batch, image):
    """Every launch of the apply kernel in one ResNet-50 v2 forward at
    (batch, image, image, 3), NHWC, as (rows M, channels C, act,
    residual): the data BN (3 channels, no scale or centre), the stem BN
    (its relu a separate Activation), per bottleneck bn1 (+relu) on the
    block's input, bn2 (+relu) on conv1's output and bn3 (+relu) on the
    strided conv2's output, then the final BN (its relu separate). 51 in
    all."""
    rows = [(batch * image * image, 3, None, False),
            (batch * (image // 2) ** 2, 64, None, False)]
    s, in_c = image // 4, 64
    for stage, (n, c) in enumerate(zip((3, 4, 6, 3),
                                       (256, 512, 1024, 2048))):
        for b in range(n):
            s_out = s // 2 if (b == 0 and stage > 0) else s
            rows += [(batch * s * s, in_c if b == 0 else c, "relu", False),
                     (batch * s * s, c // 4, "relu", False),
                     (batch * s_out * s_out, c // 4, "relu", False)]
            s = s_out
        in_c = c
    rows.append((batch * s * s, 2048, None, False))
    return rows


def _train_counts(launches):
    return {k: launches[k] for k in ("scale_shift_act", "avg_pool2d_fwd",
                                     "avg_pool2d_bwd")}


def smooth_labels(y, classes, eta=SMOOTHING):
    """GluonCV's `smooth`: one-hot with 1 - eta + eta / classes on, eta /
    classes off."""
    out = torch.full((len(y), classes), eta / classes, device=y.device)
    return out.scatter_(1, y.long()[:, None], 1 - eta + eta / classes)


def msra_check(net, tag):
    """Each 4-D (convolution) weight's std against MSRAPrelu's formula with
    the fans of its (O, I, kh, kw) storage."""
    mag = 2.0 / (1 + 0.25 ** 2)
    worst, n = 0.0, 0
    for name, p in net.collect_params().items():
        w = p.data()
        if w.dim() != 4:
            continue
        hw = w.shape[2] * w.shape[3]
        want = (mag / ((w.shape[0] + w.shape[1]) * hw / 2.0)) ** 0.5
        rel = abs(float(w.detach().float().std()) / want - 1)
        n += 1
        if rel > worst:
            worst, at = rel, name
    log(f"[{tag}] MSRAPrelu on the card: {n} convolution weights, the "
        f"largest std departure from MXNet's fan formula {worst:.4f} at "
        f"{at} (limit {MSRA_STD_RTOL})")
    assert worst <= MSRA_STD_RTOL, f"MSRAPrelu std off at {at}: {worst}"
    return {"convs": n, "worst_rel": worst, "worst_at": at}


def recipe_v2(card, dev, profile):
    """(a) the GluonCV recipe at full width, then (b) FusedInferStep on its
    trained net, under bf16 AMP with the fusion default on."""
    batches = make_batches(2, BATCH, seed=51)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)
    amp.init("bfloat16")
    prev = fused.set_fusion_default(True)
    try:
        net = vision.resnet50_v2(layout="NHWC", classes=CLASSES, device=dev,
                                 seed=0)
        net.initialize(initializer.MSRAPrelu(), device=dev,
                       force_reinit=True)
        net(torch.zeros((1, IMAGE, IMAGE, 3), device=dev))   # deferred shapes
        init_check = msra_check(net, "recipe v2")
        for p in net.collect_params(NO_DECAY).values():
            p.wd_mult = 0.0
        trainer = gluon.Trainer(net.collect_params(), "nag", dict(
            NAG, lr_scheduler=lr_scheduler.CosineScheduler(**COSINE)))
        train_metric = metric.RMSE()

        def step(x, y):
            data = gluon.utils.split_and_load(x, [dev])[0]
            label = smooth_labels(gluon.utils.split_and_load(y, [dev])[0],
                                  CLASSES)
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            autograd.backward(loss)
            trainer.step(BATCH)
            train_metric.update(label, torch.softmax(out.float(), dim=-1))
            return loss.detach()
        seen = record_apply_shapes(step, *batches[0])
        want = [(m, c, a, r, torch.float32)
                for m, c, a, r in resnet50_v2_apply_rows(BATCH, IMAGE)]
        assert len(want) == 51
        assert sorted(seen, key=str) == sorted(want, key=str), \
            f"apply launches of a v2 step differ from the prediction: {seen}"
        losses, wall = _timed_loop(step, batches, LOOP_WARMUP - 1,
                                   LOOP_STEPS)
        launches = kernels.launch_counts()
        rmse = train_metric.get()[1]
        step_ms = wall / LOOP_STEPS * 1e3
        prof = profile_steps(step, batches, step_ms, KERNEL_SYMBOLS,
                             "recipe v2") if profile else None
        infer = infer_v2(card, net, batches, dev)
    finally:
        fused.set_fusion_default(prev)
        amp.uninit()
    losses = [float(v.float().mean()) for v in losses]
    ips = BATCH * LOOP_STEPS / wall
    log(f"[recipe v2] {card}: resnet50_v2 NHWC, MSRAPrelu, bf16 AMP, "
        f"fusion default on, NAG {NAG} with CosineScheduler {COSINE}, "
        f"{len(net.collect_params(NO_DECAY))} values without weight decay, "
        f"labels smoothed by {SMOOTHING}: {LOOP_STEPS} steps of batch "
        f"{BATCH} x {IMAGE}^2 (split_and_load from the host, RMSE updated "
        f"every step) in {wall:.3f} s: {step_ms:.3f} ms/step, {ips:.1f} "
        f"images/s; losses {[round(v, 4) for v in losses]}; RMSE {rmse:.5f}"
        f"; launches {_train_counts(launches)} (predicted 51, 1, 1 a "
        f"step)")
    assert all(np.isfinite(losses)), "non-finite recipe loss"
    assert np.isfinite(rmse), "non-finite RMSE"
    assert launches["scale_shift_act"] == 51 * LOOP_STEPS \
        and launches["avg_pool2d_fwd"] == LOOP_STEPS \
        and launches["avg_pool2d_bwd"] == LOOP_STEPS, \
        "kernel launch count off the recipe's path"
    del net, trainer
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "images_per_s": ips, "losses": losses,
            "rmse": rmse, "launches": launches, "init": init_check,
            "apply_rows": [list(r[:4]) for r in seen], "profile": prof,
            "infer": infer}


def infer_v2(card, net, batches, dev):
    """(b) FusedInferStep: INFER_CALLS chained calls at batch 32, timed;
    then Accuracy and TopKAccuracy(5) over each call's logits."""
    x0, y = (torch.from_numpy(a).to(dev) for a in batches[0])
    step = gluon.contrib.FusedInferStep(net)
    step(x0)                                # warm-up call
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits = [step(x0)] + [step() for _ in range(INFER_CALLS - 1)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    acc, top5 = metric.Accuracy(), metric.TopKAccuracy(5)
    for out in logits:
        acc.update(y, out)
        top5.update(y, out)
    ms = wall / INFER_CALLS * 1e3
    log(f"[infer v2] {card}: FusedInferStep, {INFER_CALLS} chained calls "
        f"of batch {BATCH}: {ms:.3f} ms a batch, {BATCH / ms * 1e3:.1f} "
        f"images/s; logits {logits[-1].dtype}; {acc.get()} {top5.get()} "
        f"(random labels); launches {_train_counts(launches)} (predicted "
        f"51, 1, 0 a call)")
    assert all(torch.isfinite(o.float()).all() for o in logits)
    assert all(o.grad_fn is None for o in logits), "the inference taped"
    assert launches["scale_shift_act"] == 51 * INFER_CALLS \
        and launches["avg_pool2d_fwd"] == INFER_CALLS \
        and launches["avg_pool2d_bwd"] == 0, \
        "kernel launch count off the inference path"
    return {"ms_per_batch": ms, "launches": launches,
            "accuracy": acc.get()[1], "top5": top5.get()[1]}


def v2_f32_check(dev):
    """(c) one float32 ResNet-50 v2 step fused against unfused from the
    same MSRAPrelu weights, phase 5's form and limits."""
    def build():
        net = vision.resnet50_v2(layout="NHWC", classes=CLASSES, device=dev,
                                 seed=1)
        net.initialize(initializer.MSRAPrelu(), device=dev, seed=1,
                       force_reinit=True)
        net(torch.zeros((1, IMAGE, IMAGE, 3), device=dev))   # deferred shapes
        return net
    return train_f32_check(dev, build, launches_per_step=53,
                           batch=V2_CHECK_BATCH, steps=V2_CHECK_STEPS,
                           tag="v2 float32")


def v2_apply_kernels(card, rows, dev):
    """(d) B1 against its plain version at every apply shape of (a) (in
    launch order), in float32 and bfloat16; the data BN's (the first: C =
    3) and the final BN's (the last: (1568, 2048)) timed in float32."""
    gen = torch.Generator(device=dev).manual_seed(12)
    distinct = sorted({tuple(r) for r in rows},
                      key=lambda r: (-r[0], r[1], str(r[2])))
    timed = {tuple(rows[0]), tuple(rows[-1])}
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, c, act, res in distinct:
            out.append(check_apply(m, c, act, res, dtype, gen, dev,
                                   dtype == torch.float32
                                   and (m, c, act, res) in timed))
    for r in out:
        if "ms" in r:
            log(f"[v2 kernels] {card}: B1 at M={r['M']} C={r['C']} "
                f"act={r['act']} float32: {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.4f} ms, torch.addcmul {r['library_ms']}")
    kernels.reset_launch_counts()   # comparison launches do not count
    return out


def _sweep_blocks():
    """(name, constructor, input shape) of the sweep: each layer family
    of the slice at a narrow width."""
    nn = gluon.nn
    return [
        ("Conv1D NCW", lambda: nn.Conv1D(16, 3, padding=1, layout="NCW",
                                         activation="relu"), (4, 8, 33)),
        ("Conv1D NWC", lambda: nn.Conv1D(16, 3, padding=1, layout="NWC",
                                         activation="relu"), (4, 33, 8)),
        ("Conv3D NCDHW", lambda: nn.Conv3D(16, 3, padding=1, layout="NCDHW",
                                           activation="relu"),
         (2, 8, 6, 10, 10)),
        ("Conv3D NDHWC", lambda: nn.Conv3D(16, 3, padding=1, layout="NDHWC",
                                           activation="relu"),
         (2, 6, 10, 10, 8)),
        ("Conv1DTranspose NWC", lambda: nn.Conv1DTranspose(
            8, 3, strides=2, padding=1, output_padding=1, layout="NWC"),
         (4, 17, 16)),
        ("Conv2DTranspose NCHW", lambda: nn.Conv2DTranspose(
            8, 4, strides=2, padding=1, groups=2), (2, 16, 12, 12)),
        ("Conv3DTranspose NDHWC", lambda: nn.Conv3DTranspose(
            8, 2, strides=2, layout="NDHWC"), (2, 4, 6, 6, 16)),
        ("MaxPool1D", lambda: nn.MaxPool1D(3, 2, 1, ceil_mode=True),
         (4, 8, 33)),
        ("AvgPool3D NDHWC", lambda: nn.AvgPool3D(
            3, 2, 1, layout="NDHWC", count_include_pad=False),
         (2, 6, 10, 10, 8)),
        ("GlobalMaxPool2D", lambda: nn.GlobalMaxPool2D(), (4, 8, 9, 9)),
        ("GlobalAvgPool3D", lambda: nn.GlobalAvgPool3D(), (2, 8, 4, 5, 6)),
        ("GroupNorm", lambda: nn.GroupNorm(4), (4, 16, 9, 9)),
        ("InstanceNorm", lambda: nn.InstanceNorm(), (4, 16, 9, 9)),
        ("RMSNorm", lambda: nn.RMSNorm(), (4, 12, 64)),
        ("LayerNorm axis 1", lambda: nn.LayerNorm(axis=1), (4, 16, 9)),
        ("LeakyReLU", lambda: nn.LeakyReLU(0.1), (8, 256)),
        ("PReLU", lambda: nn.PReLU(in_channels=256), (8, 256)),
        ("ELU", lambda: nn.ELU(), (8, 256)),
        ("SELU", lambda: nn.SELU(), (8, 256)),
        ("GELU tanh", lambda: nn.GELU("tanh"), (8, 256)),
        ("Swish", lambda: nn.Swish(2.0), (8, 256)),
        ("Activation mish", lambda: nn.Activation("mish"), (8, 256)),
        ("ReflectionPad2D", lambda: nn.ReflectionPad2D(2), (2, 8, 9, 9)),
        ("HybridConcatenate", lambda: _concat_block(), (8, 64)),
    ]


def _concat_block():
    blk = gluon.nn.HybridConcatenate(axis=1)
    blk.add(gluon.nn.Dense(32, activation="tanh"), gluon.nn.Identity())
    return blk


def _run_block(blk, x, ct_dtype=torch.float32):
    """Output, input gradient and Parameter gradients of one recorded
    forward and backward, as float32 on the host. The backward is seeded
    with a cotangent drawn from a fixed seed and rounded to `ct_dtype`
    (ones would give a norm's input an exact zero gradient, all
    rounding)."""
    x = x.detach().requires_grad_()
    with autograd.record():
        out = blk(x)
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    out.backward(ct.to(ct_dtype).to(out.device, out.dtype))
    assert out.device == x.device, f"output on {out.device}"
    grads = {n: p.data().grad.float().cpu()
             for n, p in blk.collect_params().items()
             if p.grad_req != "null"}
    return out.detach().float().cpu(), x.grad.float().cpu(), grads


def _sweep_err(got, want, dtype):
    """(largest |got - want| / max|want|, limit) of one tensor."""
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    if dtype == torch.float32:
        # relative plus absolute, elementwise, as SWEEP_RTOL states
        ok = bool(((got - want).abs()
                   <= SWEEP_RTOL * (want.abs() + scale)).all())
        return err, ok
    return err, err <= SWEEP_STEPS16 * STEP16[dtype]


def layer_sweep(card, dev):
    """(e) every block of `_sweep_blocks` forward and backward on the card
    in float32 and bfloat16 against the same block on the CPU; then the
    fused routing of Conv1D / Conv3D by layout on the launch counter."""
    rows = []
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for seed, (name, make, shape) in enumerate(_sweep_blocks()):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
        for dtype in (torch.float32, torch.bfloat16):
            ref_blk = make().initialize(device="cpu", seed=seed)
            blk = make().initialize(device=dev, seed=seed)
            xr = x.to(dtype).float()
            ref_blk(xr)                     # resolve the deferred shapes
            blk(xr.to(dev))
            if dtype != torch.float32:
                blk.cast(dtype)
                ref_blk.cast(dtype)
                ref_blk.cast("float32")     # the same rounded values
            want = _run_block(ref_blk, xr, dtype)
            got = _run_block(blk, xr.to(dev, dtype), dtype)
            errs = {"out": _sweep_err(got[0], want[0], dtype),
                    "dx": _sweep_err(got[1], want[1], dtype)}
            for n in want[2]:
                errs[n] = _sweep_err(got[2][n], want[2][n], dtype)
            bad = [k for k, (_, ok) in errs.items() if not ok]
            top = max(e for e, _ in errs.values())
            worst[dtype] = max(worst[dtype], top)
            rows.append({"block": name, "dtype": _dtype_name(dtype),
                         "max_rel": top, "ok": not bad})
            assert not bad, f"{name} {dtype} on the card: {bad} {errs}"
    # MobileNet v2's depthwise convolutions (cuDNN): an inference forward
    # in float32 (running statistics; a training forward's batch
    # statistics over 2 x 2 x 2 values would amplify the summation order)
    x = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(
        99))
    ref_net = vision.MobileNetV2(0.25, classes=10).initialize(device="cpu",
                                                              seed=3)
    net = vision.MobileNetV2(0.25, classes=10).initialize(device=dev, seed=3)
    err, ok = _sweep_err(net(x.to(dev)).cpu(), ref_net(x), torch.float32)
    rows.append({"block": "MobileNetV2 0.25 inference", "dtype": "float32",
                 "max_rel": err, "ok": ok})
    assert ok, f"MobileNetV2 on the card: {err}"
    worst[torch.float32] = max(worst[torch.float32], err)
    fused_counts = {}
    for name, layout, shape in (("Conv1D", "NWC", (4, 33, 8)),
                                ("Conv1D", "NCW", (4, 8, 33)),
                                ("Conv3D", "NDHWC", (2, 6, 10, 10, 8)),
                                ("Conv3D", "NCDHW", (2, 8, 6, 10, 10))):
        blk = getattr(gluon.nn, name)(16, 3, padding=1, layout=layout,
                                      activation="relu",
                                      in_channels=8).initialize(device=dev)
        x = torch.randn(shape, device=dev)
        kernels.reset_launch_counts()
        with fused.fusion_scope(True):
            _run_block(blk, x)
        n = kernels.launch_counts()["scale_shift_act"]
        fused_counts[f"{name} {layout}"] = n
        assert n == (0 if layout.startswith("NC") else 1), \
            f"{name} {layout} in a fusion scope: {n} apply launches"
    kernels.reset_launch_counts()
    log(f"[sweep] {card}: {len(_sweep_blocks())} blocks forward and "
        f"backward (and MobileNetV2 0.25's inference forward) on the card "
        f"against the CPU: worst float32 {worst[torch.float32]:.2e}"
        f" (limit {SWEEP_RTOL} relative + absolute of the largest value), "
        f"bfloat16 {worst[torch.bfloat16]:.2e} (limit {SWEEP_STEPS16} "
        f"steps, {SWEEP_STEPS16 * STEP16[torch.bfloat16]:.2e}); apply "
        f"launches in a fusion scope {fused_counts}")
    return {"rows": rows, "worst_float32": worst[torch.float32],
            "worst_bfloat16": worst[torch.bfloat16],
            "fused_launches": fused_counts}


def phase_script(card, dev, profile):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    recipe = recipe_v2(card, dev, profile)
    check = v2_f32_check(dev)
    applies = v2_apply_kernels(card, recipe["apply_rows"], dev)
    sweep = layer_sweep(card, dev)
    log(f"[script] phase 12 took {time.perf_counter() - t0:.1f} s")
    return {"recipe": recipe, "f32_check": check, "applies": applies,
            "sweep": sweep}


# ---------------------------------------------------------------------------
# phase 13: SSD300 detection, the other vision families, remat, sparse
# Embedding
# ---------------------------------------------------------------------------
# SSD300 by GluonCV's ssd_300_vgg16_atrous + train_ssd.py: 20 VOC classes,
# 300x300, batch 32, SGD lr 0.001 momentum 0.9 wd 5e-4; synthetic boxes,
# 1-8 an image, padded with -1 rows to 8
SSD_BATCH, SSD_IMAGE, SSD_CLASSES, SSD_GT = 32, 300, 20, 8
SSD_WARMUP, SSD_STEPS = 2, 8
SSD_SGD = dict(learning_rate=0.001, momentum=0.9, wd=5e-4)
SSD_NMS, SSD_THRESH = 0.45, 0.01
SSD_ANCHORS = 8732
NMS_REPS = 5
DETECT_REPS = 5     # detect() is host-timed: a median of this many calls
# the NMS sweep's time at detect()'s (32, 8732) before the bitmask
# redesign: one block an image, a barrier a kept row (PERF.md section 6
# row 9, `chip_smoke.py --profile` on NVIDIA H100 80GB HBM3, 700.00 W);
# logged beside this run's, a recorded reading, so not in the kernels line
NMS_ONE_BLOCK_MS = 4.9298
# the kernels at the edges of a 64-row word and at SSD300's anchors:
# (images, rows, ids: "classes" (20), "one class", None, "chain": each
# box overlapping the next alone, so the greedy keeps every other row, or
# "dense": larger boxes in a third of the frame, no classes, so most pairs
# overlap and take the IoU); 12000 rows pass the words the sweep's warps
# load a step ahead (31 x 5 = 155 words, 9920 rows)
NMS_SHAPES = ((4, 1, "classes"), (4, 63, None), (4, 64, None),
              (4, 65, "classes"), (4, 65, None), (2, SSD_ANCHORS, "classes"),
              (1, SSD_ANCHORS, "one class"), (1, SSD_ANCHORS, None),
              (1, SSD_ANCHORS, "chain"), (2, SSD_ANCHORS, "dense"),
              (2, 12000, None))
# (c): each family's name, input size and B1 launches a step (and a call)
FAMILIES = (("alexnet", 224, 2), ("vgg16_bn", 224, 2),
            ("squeezenet1.1", 224, 0), ("densenet121", 224, 0),
            ("inceptionv3", 299, 0))
FAMILY_STEPS, FAMILY_LR = 2, 1e-3
# GluonCV train_imagenet.py's initializer (the default Uniform(0.07) lets
# AlexNet's and VGG's activations, which no norm rescales, overflow)
FAMILY_INIT = initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                 magnitude=2)
# (d): BERT-base through FusedTrainStep under each remat policy
REMAT_POLICIES = (None, "full", "dots")
REMAT_STEPS = 3
# flash forward launches a step (B6) under each policy: the recompute runs
# the forward again, flash included ("dots" saves only the outputs of
# products and convolutions, and the flash kernels are neither)
REMAT_B6 = {None: 1, "full": 2, "dots": 2}
REMAT_CHECK_RTOL = 1e-6
# (e): the flagship LM's table, Adam, a batch of 16 x 512 token ids
SPARSE_VOCAB, SPARSE_DIM = FULL["vocab"], FULL["embed"]
SPARSE_ADAM = dict(learning_rate=1e-3, wd=0.01)
SPARSE_STEPS = 5


def ssd_apply_rows(batch, image):
    """The (M, C) of every B1 launch in one SSD300 forward at (batch,
    image, image, 3), NHWC: the 23 convolutions with ReLU (conv1-conv5,
    fc6, fc7, the extras), in order."""
    rows, s = [], image
    for blocks, ch, ceil in ((2, 64, False), (2, 128, False),
                             (3, 256, True)):
        rows += [(batch * s * s, ch)] * blocks
        s = -(-s // 2) if ceil else s // 2
    rows += [(batch * s * s, 512)] * 3                      # conv4: 38
    s //= 2
    rows += [(batch * s * s, 512)] * 3 + [(batch * s * s, 1024)] * 2
    for mid, out, stride, pad in ((256, 512, 2, 1), (128, 256, 2, 1),
                                  (128, 256, 1, 0), (128, 256, 1, 0)):
        rows.append((batch * s * s, mid))
        s = (s + 2 * pad - 3) // stride + 1
        rows.append((batch * s * s, out))
    return rows


def ssd_batches(n, seed, dev):
    """n (images (32, 300, 300, 3), labels (32, 8, 5)) on the card: 1-8
    boxes [class, x1, y1, x2, y2] an image, -1 rows after them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.rand(SSD_BATCH, SSD_IMAGE, SSD_IMAGE, 3).astype(np.float32)
        lab = -np.ones((SSD_BATCH, SSD_GT, 5), np.float32)
        for b in range(SSD_BATCH):
            for g in range(rng.randint(1, SSD_GT + 1)):
                xy = rng.rand(2) * 0.7
                lab[b, g] = [rng.randint(0, SSD_CLASSES), *xy,
                             *(xy + 0.05 + rng.rand(2) * 0.25)]
        out.append(tuple(torch.from_numpy(a).to(dev) for a in (x, lab)))
    return out


def ssd_loss(net, x, labels):
    """examples/ssd_amp.py's loss: targets with hard negatives at ratio 3,
    cross-entropy over the class targets ignoring -1, Huber on loc x
    mask."""
    anchors, cls, box = net(x)
    loc_t, loc_m, cls_t = net.targets(anchors, labels, cls,
                                      negative_mining_ratio=3.0)
    valid = (cls_t >= 0).float()
    nll = -ops_nn.pick(ops_nn.log_softmax(cls, axis=-1), cls_t.clamp(min=0))
    lcls = (nll * valid).sum() / valid.sum().clamp(min=1)
    huber = gluon.loss.HuberLoss()
    return lcls + huber(box * loc_m, loc_t * loc_m).mean() * 4.0


def ssd_apply_kernels(dev):
    """B1 against its plain version with bias + ReLU (scale absent), as
    the paths run it, in float32 and bfloat16 at every distinct shape of
    an SSD300 step and at the families' Dense(4096, relu) (BATCH, 4096);
    conv1's bfloat16 call timed. Returns conv1's row, with every check
    under "checked"."""
    rows = ssd_apply_rows(SSD_BATCH, SSD_IMAGE)
    shapes = sorted(set(rows) | {(BATCH, 4096)}, reverse=True)
    gen = torch.Generator(device=dev).manual_seed(13)
    checked, conv1 = [], None
    for dtype in (torch.float32, torch.bfloat16):
        for m, c in shapes:
            x = torch.randn((m, c), generator=gen, device=dev).to(dtype)
            bias = 0.2 * torch.randn((c,), generator=gen, device=dev)
            out = kernels.scale_shift_act_cuda(x, None, bias, None, "relu")
            ref = fused.apply_ref(x, None, bias, None, "relu")
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), \
                "non-finite apply output"
            err, ok = _err_ok(out, ref, dtype)
            assert ok, (f"B1 at ({m}, {c}) {_dtype_name(dtype)} relu "
                        f"disagrees with its plain version")
            checked.append({"M": m, "C": c, "dtype": _dtype_name(dtype),
                            "max_abs_err": err, "tol": KTOL[dtype]})
            if dtype == torch.bfloat16 and (m, c) == rows[0]:
                conv1 = ssd_conv1_timing(x, bias, err)
            del x, out, ref
    kernels.reset_launch_counts()   # comparison launches do not count
    conv1["checked"] = checked
    return conv1


def ssd_conv1_timing(x, bias, err):
    """B1's reading at conv1's shape: ms, its plain version's, the bound,
    and the library's: torch.addcmul of the bias row and a row of ones in
    x's type (phase 4's yardstick: the affine part in one call, the ReLU
    not in it)."""
    m, c = x.shape
    bound, by = bound_ms("scale_shift_act", M=m, C=c, dtype=x.dtype,
                         act="relu", scale=False, shift=True)
    sh = bias.to(x.dtype)
    sc = torch.ones(c, dtype=x.dtype, device=x.device)
    return {"M": m, "C": c, "act": "relu", "dtype": "bfloat16",
            "max_abs_err": err,
            "ms": median_ms(lambda i: kernels.scale_shift_act_cuda(
                x, None, bias, None, "relu"), reps=20),
            "plain_ms": median_ms(lambda i: fused.apply_ref(
                x, None, bias, None, "relu"), reps=5, warmup=1),
            "bound_ms": bound, "bound_by": by,
            "library_ms": median_ms(lambda i: torch.addcmul(sh, x, sc),
                                    reps=20)}


def ssd_train(card, dev, profile):
    """(a) SSD300 NHWC at batch 32 x 300^2, bf16 AMP, the imperative loop
    with the fusion default on, GluonCV's SGD."""
    batches = ssd_batches(2, seed=131, dev=dev)
    amp.init("bfloat16")
    prev = fused.set_fusion_default(True)
    try:
        net = detection.ssd_300_vgg16(classes=SSD_CLASSES, layout="NHWC",
                                      device=dev, seed=0)
        net(torch.zeros((1, SSD_IMAGE, SSD_IMAGE, 3), device=dev))
        trainer = gluon.Trainer(net.collect_params(), "sgd", SSD_SGD)

        def step(x, labels):
            with autograd.record():
                loss = ssd_loss(net, x, labels)
            autograd.backward(loss)
            trainer.step(1)
            return loss.detach()
        seen = record_apply_shapes(step, *batches[0])
        want = [(m, c, "relu", False, torch.bfloat16)
                for m, c in ssd_apply_rows(SSD_BATCH, SSD_IMAGE)]
        assert len(want) == 23
        assert seen == want, \
            f"apply launches of an SSD step differ from the prediction: {seen}"
        losses, wall = _timed_loop(step, batches, SSD_WARMUP - 1, SSD_STEPS)
        launches = kernels.launch_counts()
        step_ms = wall / SSD_STEPS * 1e3
        x, labels = batches[0]
        anchors, cls, _ = net(x)
        tgt_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.targets(anchors, labels, cls, negative_mining_ratio=3.0)
            torch.cuda.synchronize()
            tgt_ms.append((time.perf_counter() - t0) * 1e3)
        prof = profile_steps(step, batches, step_ms, KERNEL_SYMBOLS,
                             "ssd") if profile else None
        detect = ssd_detect(card, net, x, labels, dev)
    finally:
        fused.set_fusion_default(prev)
        amp.uninit()
    losses = [float(v) for v in losses]
    ips = SSD_BATCH * SSD_STEPS / wall
    target_ms = float(np.median(tgt_ms))
    log(f"[ssd] {card}: ssd_300_vgg16(classes={SSD_CLASSES}, NHWC), bf16 "
        f"AMP, fusion default on, SGD {SSD_SGD}, targets with hard "
        f"negatives at ratio 3: {SSD_STEPS} steps of batch {SSD_BATCH} x "
        f"{SSD_IMAGE}^2 in {wall:.3f} s: {step_ms:.3f} ms/step, {ips:.1f} "
        f"images/s; multibox_target {target_ms:.3f} ms a step; losses "
        f"{[round(v, 4) for v in losses]}; launches "
        f"{_train_counts(launches)} (predicted 23, 0, 0 a step), nms_sweep "
        f"{launches['nms_sweep']}")
    assert all(np.isfinite(losses)), "non-finite SSD loss"
    assert launches == dict(dict.fromkeys(launches, 0),
                            scale_shift_act=23 * SSD_STEPS), \
        f"kernel launch count off the SSD path: {launches}"
    conv1 = ssd_apply_kernels(dev)
    worst = {d: max(r["max_abs_err"] for r in conv1["checked"]
                    if r["dtype"] == d) for d in ("float32", "bfloat16")}
    log(f"[ssd] {card}: B1 (bias + relu) against its plain version at "
        f"{len(conv1['checked']) // 2} shapes (every distinct SSD step shape "
        f"and ({BATCH}, 4096)) in float32 and bfloat16: largest max abs err "
        f"{worst}; at conv1 ({conv1['M']}, {conv1['C']}) bf16: "
        f"{conv1['ms']:.4f} ms, bound {conv1['bound_ms']:.4f} ms "
        f"({conv1['bound_by']}), plain {conv1['plain_ms']:.4f} ms, "
        f"torch.addcmul {conv1['library_ms']:.4f} ms, max abs "
        f"err {conv1['max_abs_err']:.3e}")
    del net, trainer
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "images_per_s": ips, "losses": losses,
            "launches": launches, "target_ms": target_ms,
            "apply_rows": [list(r[:2]) for r in seen], "conv1": conv1,
            "profile": prof, "detect": detect}


def counted_sweep(boxes, ids, keep, thresh):
    """The plain greedy sweep, counting as it goes the IoU tests it makes:
    for each row alive when its turn comes, the later alive rows of its
    class. Returns (the count, the keep mask)."""
    keep = keep.clone()
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    cols = torch.arange(boxes.shape[1], device=boxes.device)
    tests = torch.zeros((), dtype=torch.int64, device=boxes.device)
    for i in range(boxes.shape[1] - 1):
        s = slice(i, i + 1)
        live = (cols > i) & keep[:, s] & keep & (ids == ids[:, s])
        tests += live.sum()
        iw = (torch.minimum(x2[:, s], x2)
              - torch.maximum(x1[:, s], x1)).clamp(min=0)
        ih = (torch.minimum(y2[:, s], y2)
              - torch.maximum(y1[:, s], y1)).clamp(min=0)
        inter = iw * ih
        union = area[:, s] + area - inter
        iou = torch.where(union > 0, inter / union, 0.0)
        keep &= ~(live & (iou > thresh))
    return int(tests), keep


def nudged_fault(boxes, ids, kept, thresh):
    """A planted fault: in image 0, the kept pair (i < j, one class) of
    largest IoU, row j's box moved toward row i's by the least step
    (bisected on the CPU in float32, box_iou's arithmetic) that puts their
    IoU just above the threshold. Returns (boxes with the nudge, j, the
    IoU before and after)."""
    b = boxes[0].cpu()
    k = kept[0].cpu().nonzero().flatten()
    kid = ids[0].cpu()[k]
    iou = contrib.box_iou(b[k], b[k])
    iou = torch.where((kid[:, None] == kid[None, :])
                      & torch.ones_like(iou, dtype=torch.bool).triu(1),
                      iou, -1.0)
    flat = int(iou.argmax())
    i, j = int(k[flat // len(k)]), int(k[flat % len(k)])
    before = float(iou.flatten()[flat])
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        cand = b[j] + mid * (b[i] - b[j])
        if float(contrib.box_iou(b[i:i + 1], cand[None])[0, 0]) > thresh:
            hi = mid
        else:
            lo = mid
    moved = b[j] + hi * (b[i] - b[j])
    after = float(contrib.box_iou(b[i:i + 1], moved[None])[0, 0])
    out = boxes.clone()
    out[0, j] = moved.to(boxes.device)
    return out, j, before, after


def nms_mask_work(keep):
    """What the mask pass does for the rows alive at the start: its IoU
    tests (each alive row against every later row) and the bytes of mask
    it writes (a 64-bit word for each alive row and each 64-row word from
    the row's own on)."""
    A = keep.shape[1]
    rows = torch.arange(A, device=keep.device)
    tests = int(((A - 1 - rows) * keep).sum())
    words = int(((-(-A // 64) - rows // 64) * keep).sum())
    return tests, 8 * words


def nms_shapes(dev):
    """The kernel against the plain sweep, bit for bit, at NMS_SHAPES:
    random boxes (SSD-like sizes), a fifth of the rows dead at the start,
    threshold 0.45; the chain at threshold 0.2 (IoU 0.25 with the next
    box), every row alive; the two-image SSD case also one image a group."""
    gen = torch.Generator(device=dev).manual_seed(16)
    rows = []
    for B, A, kind in NMS_SHAPES:
        xy = torch.rand((B, A, 2), generator=gen, device=dev) * 0.8
        wh = 0.02 + torch.rand((B, A, 2), generator=gen, device=dev) * 0.2
        boxes = torch.cat([xy, xy + wh], -1).contiguous()
        ids = None if kind is None else (
            torch.zeros((B, A), device=dev) if kind == "one class" else
            torch.randint(0, SSD_CLASSES, (B, A), generator=gen,
                          device=dev).float())
        keep = torch.rand((B, A), generator=gen, device=dev) > 0.2
        thresh = SSD_NMS
        if kind == "dense":
            xy = torch.rand((B, A, 2), generator=gen, device=dev) * 0.3
            wh = 0.02 + torch.rand((B, A, 2), generator=gen, device=dev) * 0.3
            boxes = torch.cat([xy, xy + wh], -1).contiguous()
            ids = None
        if kind == "chain":
            x = torch.arange(A, device=dev, dtype=torch.float32) * 0.6
            boxes = torch.stack([x, torch.zeros_like(x), x + 1,
                                 torch.ones_like(x)], -1)[None].contiguous()
            ids, keep, thresh = None, torch.ones_like(keep), 0.2
        got = kernels.nms_sweep_cuda(boxes, ids, keep, thresh)
        want = contrib.nms_sweep_ref(boxes, ids, keep, thresh)
        same = torch.equal(got, want)
        if B > 1 and A == SSD_ANCHORS and kind == "classes":
            # the images in groups of one, past a lowered workspace cap
            cap = kernels.NMS_MASK_CAP_BYTES
            kernels.NMS_MASK_CAP_BYTES = kernels.nms_mask_bytes(1, A)
            try:
                same &= torch.equal(
                    kernels.nms_sweep_cuda(boxes, ids, keep, thresh), want)
            finally:
                kernels.NMS_MASK_CAP_BYTES = cap
        rows.append({"images": B, "rows": A, "ids": kind, "bit_equal": same,
                     "alive": int(keep.sum()), "kept": int(got.sum())})
        assert same, f"the NMS kernels part from the plain sweep at " \
            f"({B}, {A}), ids {kind}"
    log(f"[detect] the NMS kernels bit-equal to the plain sweep at "
        + "; ".join(f"({r['images']}, {r['rows']}) ids {r['ids']}: "
                    f"{r['kept']} of {r['alive']} kept" for r in rows))
    return rows


def ssd_detect(card, net, x, labels, dev):
    """(b) `net.detect(x)` on the batch of 32: the sweep kernel against
    the plain sweep on the same sorted rows (bit-equal keep masks, then
    ids, scores and boxes), `box_nms` at (32, 8732, 6) with and without
    force_suppress, a planted near-threshold fault, the times, and
    VOC07MApMetric over the detections against the batch's boxes (random
    weights: near 0)."""
    net.detect(x, nms_threshold=SSD_NMS, threshold=SSD_THRESH)   # warm-up
    torch.cuda.synchronize()
    captured = []
    orig = kernels.nms_sweep_cuda

    def capturing(boxes, ids, keep, thresh):
        out = orig(boxes, ids, keep, thresh)
        captured.append((boxes, ids, keep, thresh, out))
        return out
    kernels.reset_launch_counts()
    kernels.nms_sweep_cuda = capturing
    try:
        t0 = time.perf_counter()
        dets = net.detect(x, nms_threshold=SSD_NMS, threshold=SSD_THRESH)
        torch.cuda.synchronize()
        detect_ms = (time.perf_counter() - t0) * 1e3
    finally:
        kernels.nms_sweep_cuda = orig
    launches = kernels.launch_counts()
    assert launches["nms_sweep"] == 1 and len(captured) == 1, launches
    boxes, ids, keep0, thresh, kept = captured[0]
    assert dets.shape == (SSD_BATCH, SSD_ANCHORS, 6) \
        and torch.isfinite(dets).all(), "detections not finite"
    alive = int(keep0.sum())
    # the kernel against the plain sweep on the same rows
    tests, plain = counted_sweep(boxes, ids, keep0, thresh)
    assert torch.equal(kept, plain), "the NMS kernel's keep mask is not " \
        "the plain sweep's"
    # the whole decode: ids, scores and boxes bit-equal with the plain sweep
    anchors, cls, loc = net(x)
    probs = ops_nn.softmax(cls, axis=-1).transpose(1, 2)
    args = (probs, loc, anchors)
    kw = dict(nms_threshold=SSD_NMS, threshold=SSD_THRESH)
    nms_data = torch.cat([
        torch.randint(0, SSD_CLASSES, (SSD_BATCH, SSD_ANCHORS, 1),
                      generator=torch.Generator(device=dev).manual_seed(14),
                      device=dev).float(),
        torch.rand((SSD_BATCH, SSD_ANCHORS, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(15)),
        boxes], dim=-1)
    got = {"detection": contrib.multibox_detection(*args, **kw)}
    before_nms = kernels.launch_counts()["nms_sweep"]
    for fs in (False, True):
        got[f"box_nms_force{fs}"] = contrib.box_nms(
            nms_data, SSD_NMS, id_index=0, force_suppress=fs)
    box_nms_launches = kernels.launch_counts()["nms_sweep"] - before_nms
    swept = contrib.nms_sweep
    contrib.nms_sweep = contrib.nms_sweep_ref
    try:
        want = {"detection": contrib.multibox_detection(*args, **kw)}
        for fs in (False, True):
            want[f"box_nms_force{fs}"] = contrib.box_nms(
                nms_data, SSD_NMS, id_index=0, force_suppress=fs)
    finally:
        contrib.nms_sweep = swept
    for name in got:
        assert torch.equal(got[name], want[name]), \
            f"{name}: the kernel's result is not the plain sweep's"
    # the largest difference seen: keep flags, then the decoded rows
    err = max([float((kept.int() - plain.int()).abs().max())]
              + [float((got[n] - want[n]).abs().max()) for n in got])
    assert box_nms_launches == 2, box_nms_launches
    kept_box_nms = {n: int((g[..., 1] >= 0).sum()) for n, g in got.items()
                    if n.startswith("box_nms")}
    # a planted fault near the threshold must be refused
    nudged, j, before, after = nudged_fault(boxes, ids, kept, thresh)
    fault_plain = contrib.nms_sweep_ref(nudged, ids, keep0, thresh)
    fault_kernel = kernels.nms_sweep_cuda(nudged, ids, keep0, thresh)
    refused = not torch.equal(kept, fault_plain)
    assert refused and not bool(fault_plain[0, j]), \
        "the check passes a keep mask with a nudged row"
    assert torch.equal(fault_kernel, fault_plain), \
        "the kernel parts from the plain sweep at the nudged row"
    shapes = nms_shapes(dev)
    # times: the kernel, the plain sweep, the whole detect()
    ms = median_ms(lambda i: kernels.nms_sweep_cuda(boxes, ids, keep0,
                                                    thresh), NMS_REPS)
    mask_tests, mask_bytes = nms_mask_work(keep0)
    ws_bytes = kernels.nms_mask_bytes(*keep0.shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = contrib.nms_sweep_ref(boxes, ids, keep0, thresh)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert torch.equal(kept, ref), "the NMS kernel's keep mask is not " \
        "nms_sweep_ref's"
    detect_runs = []
    for _ in range(DETECT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.detect(x, nms_threshold=SSD_NMS, threshold=SSD_THRESH)
        torch.cuda.synchronize()
        detect_runs.append((time.perf_counter() - t0) * 1e3)
    detect_median = float(np.median(detect_runs))
    kernels.reset_launch_counts()   # comparison launches do not count
    nms_bound, nms_by = bound_ms("nms_sweep", B=boxes.shape[0],
                                 A=boxes.shape[1], iou_tests=tests,
                                 ids=ids is not None)
    voc = metric.VOC07MApMetric(iou_thresh=0.5)
    voc.update(labels, dets)
    mean_ap = voc.get()[1]
    log(f"[detect] {card}: net.detect on {SSD_BATCH} x {SSD_IMAGE}^2 "
        f"(nms {SSD_NMS}, threshold {SSD_THRESH}): {detect_ms:.3f} ms "
        f"(median of {DETECT_REPS} more {detect_median:.3f} ms); "
        f"{alive} of {SSD_BATCH * SSD_ANCHORS} rows alive into the sweep, "
        f"{int(kept.sum())} kept, {tests} IoU tests; the kernels "
        f"{ms:.4f} ms (one block an image before: {NMS_ONE_BLOCK_MS} ms, "
        f"recorded: PERF.md section 6 row 9; bound "
        f"{nms_bound:.4f} ms by {nms_by}; mask pass "
        f"{mask_tests} IoU tests, {mask_bytes} bytes of mask written into "
        f"a {ws_bytes}-byte workspace), the plain "
        f"sweep {plain_ms:.3f} ms; keep mask, ids, scores and boxes "
        f"bit-equal; box_nms ({SSD_BATCH}, {SSD_ANCHORS}, 6) kept "
        f"{kept_box_nms}, bit-equal; "
        f"planted fault (row {j} of image 0 nudged from IoU {before:.7f} to "
        f"{after:.7f} over {thresh}) refused, the kernel on it bit-equal; "
        f"VOC07 mAP {mean_ap}")
    return {"detect_ms": detect_ms, "detect_median_ms": detect_median,
            "detect_runs_ms": detect_runs,
            "launches": launches, "alive": alive,
            "kept": int(kept.sum()), "iou_tests": tests, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": nms_bound,
            "bound_by": nms_by,
            "max_abs_err": err, "box_nms_kept": kept_box_nms,
            "mask_iou_tests": mask_tests, "mask_bytes": mask_bytes,
            "workspace_bytes": ws_bytes, "shapes": shapes,
            "fault": {"row": j, "iou_before": before, "iou_after": after,
                      "refused": refused},
            "voc07_map": mean_ap}


def family_runs(card, dev):
    """(c) one warm-up and FAMILY_STEPS timed FusedTrainStep steps and one
    inference `net(x)` of each family (FAMILY_INIT's weights) at batch 32,
    bf16 AMP, the fusion default on: finite losses and logits, exactly the
    predicted B1 launches, no pool launch."""
    out = {}
    amp.init("bfloat16")
    prev = fused.set_fusion_default(True)
    try:
        for name, image, b1 in FAMILIES:
            rng = np.random.RandomState(61)
            x = torch.from_numpy(rng.randn(BATCH, 3, image, image).astype(
                np.float32)).to(dev)
            y = torch.from_numpy(rng.randint(0, CLASSES, BATCH).astype(
                np.int32)).to(dev)
            net = vision.get_model(name, classes=CLASSES, device=dev, seed=0)
            net.initialize(FAMILY_INIT, device=dev, force_reinit=True)
            net(x[:1])                                  # deferred shapes
            step = new_step(net, BATCH, use_fusion=True, lr=FAMILY_LR)
            losses, wall = _timed_loop(step, [(x, y)], 1, FAMILY_STEPS)
            train = kernels.launch_counts()
            net(x)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            logits = net(x)
            torch.cuda.synchronize()
            infer_ms = (time.perf_counter() - t0) * 1e3
            infer = kernels.launch_counts()
            losses = [float(v) for v in losses]
            row = {"step_ms": wall / FAMILY_STEPS * 1e3, "infer_ms": infer_ms,
                   "losses": losses, "train_launches": train,
                   "infer_launches": infer}
            log(f"[families] {card}: {name} at {BATCH} x {image}^2: "
                f"{row['step_ms']:.3f} ms a step, inference {infer_ms:.3f} "
                f"ms; losses {[round(v, 4) for v in losses]}; launches a "
                f"step {_train_counts(train)} / {FAMILY_STEPS}, inference "
                f"{_train_counts(infer)} (predicted {b1}, 0, 0)")
            assert all(np.isfinite(losses)), f"{name}: non-finite loss"
            assert logits.shape == (BATCH, CLASSES) \
                and torch.isfinite(logits.float()).all()
            assert train == dict(dict.fromkeys(train, 0),
                                 scale_shift_act=b1 * FAMILY_STEPS), \
                f"{name}: training launches {train}"
            assert infer == dict(dict.fromkeys(infer, 0),
                                 scale_shift_act=b1), \
                f"{name}: inference launches {infer}"
            out[name] = row
            del net, step, logits
            torch.cuda.empty_cache()
    finally:
        fused.set_fusion_default(prev)
        amp.uninit()
    return out


def remat_runs(card, dev):
    """(d) phase 7's BERT-base through FusedTrainStep(remat=...): peak
    device memory, ms a step and the flash launches a step of each policy,
    then the float32 check."""
    batches = token_batches(2, BERT_BATCH, seed=71, dev=dev)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    L = BERT["layers"]
    rows = {}
    amp.init("bfloat16")
    try:
        net = BertEncoderLM(L, True, BERT["dropout"]).initialize(
            device=dev, seed=0)
        for policy in REMAT_POLICIES:
            step = FusedTrainStep(
                net, lambda n, x, y: loss_fn(n(x), y).mean(),
                optimizer.create("adam", learning_rate=BERT_LR),
                remat=policy)
            step(*batches[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, wall = _timed_loop(step, batches, 0, REMAT_STEPS)
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            per_step = {k: v / REMAT_STEPS for k, v in launches.items() if v}
            rows[str(policy)] = {
                "step_ms": wall / REMAT_STEPS * 1e3, "peak_gib": peak,
                "launches_per_step": per_step,
                "losses": [float(v) for v in losses]}
            log(f"[remat] {card}: BERT-base bf16 Adam, remat={policy}: "
                f"{wall / REMAT_STEPS * 1e3:.3f} ms a step, peak "
                f"{peak:.2f} GiB, flash launches a step {per_step}")
            assert all(np.isfinite(rows[str(policy)]["losses"]))
            b6 = REMAT_B6[policy] * L
            assert per_step == {"flash_fwd_lse": b6,
                                "flash_fwd_lse_wgmma": b6,
                                "flash_bwd_dq": L, "flash_bwd_dq_wgmma": L,
                                "flash_bwd_dkv": L,
                                "flash_bwd_dkv_wgmma": L}, \
                f"remat={policy}: flash launches {per_step}"
            del step
        del net
    finally:
        amp.uninit()
    torch.cuda.empty_cache()
    return {"bert": rows, "f32_check": remat_f32_check(dev)}


def remat_f32_check(dev):
    """One float32 SGD step (lr 1: the update is the gradient; TF32 off,
    cuDNN deterministic) under each policy from the same weights and
    dropout seed: 2 BERT layers at full width (dropout 0.1) and VGG-11
    with BN (BN, dropout) at batch 8 x 64^2; the losses, every update and
    every running statistic against remat=None's."""
    x, y = token_batches(1, FLASH_CHECK_BATCH, seed=72, dev=dev)[0]
    rng = np.random.RandomState(73)
    img = torch.from_numpy(rng.randn(8, 3, 64, 64).astype(np.float32)).to(dev)
    lab = torch.from_numpy(rng.randint(0, 10, 8).astype(np.int32)).to(dev)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    builds = {
        "bert2": (lambda: BertEncoderLM(FLASH_CHECK_LAYERS, True,
                                        BERT["dropout"]).initialize(
                                            device=dev, seed=1),
                  lambda n, a, b: loss_fn(n(a), b).mean(), (x, y)),
        "vgg11_bn": (lambda: vision.vgg11_bn(classes=10, device=dev,
                                             seed=1),
                     lambda n, a, b: loss_fn(n(a), b).sum(), (img, lab))}
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for tag, (build, fn, data) in builds.items():
            nets, losses = {}, {}
            for policy in REMAT_POLICIES:
                random.seed(74)
                net = build()
                net(data[0][:1])
                step = FusedTrainStep(net, fn, optimizer.create(
                    "sgd", learning_rate=1.0), remat=policy)
                losses[policy] = float(step(*data))
                nets[policy] = net
            random.seed(74)
            init = build()
            init(data[0][:1])
            init = init.collect_params()
            worst = {}
            for policy in ("full", "dots"):
                rel = update_parting(init, nets[policy].collect_params(),
                                     nets[None].collect_params())
                rel = {n: r for n, r in rel.items()
                       if not n.endswith(FLASH_CHECK_SKIP)}
                at = max(rel, key=rel.get)
                loss_rel = abs(losses[policy] - losses[None]) \
                    / abs(losses[None])
                worst[policy] = {"loss_rel": loss_rel, "update_rel": rel[at],
                                 "at": at}
                log(f"[remat float32] {tag} remat={policy}: loss "
                    f"{losses[policy]} against {losses[None]} (rel "
                    f"{loss_rel:.2e}); the largest update or running-stat "
                    f"parting {rel[at]:.3e} at {at} (tol {REMAT_CHECK_RTOL})")
                assert loss_rel <= REMAT_CHECK_RTOL \
                    and rel[at] <= REMAT_CHECK_RTOL, \
                    f"{tag}: remat={policy} parts from remat=None"
            out[tag] = worst
            del nets, init
    finally:
        torch.backends.cudnn.deterministic = prev_det
        kernels.reset_launch_counts()
    torch.cuda.empty_cache()
    return out


def sparse_embedding_run(card, dev):
    """(e) Embedding(32000, 768, sparse_grad=True) with Adam through the
    Trainer on 16 x 512 token ids: untouched rows bit-equal, touched rows
    equal to a dense Adam step's, and the update's time."""
    emb = gluon.nn.Embedding(SPARSE_VOCAB, SPARSE_DIM, sparse_grad=True) \
        .initialize(device=dev, seed=0)
    param = emb.collect_params()["weight"]
    trainer = gluon.Trainer(emb.collect_params(), "adam", SPARSE_ADAM)
    rng = np.random.RandomState(81)
    gen = torch.Generator(device=dev).manual_seed(82)
    times = []
    for k in range(SPARSE_STEPS):
        tokens = torch.from_numpy(rng.randint(
            0, SPARSE_VOCAB, (BERT_BATCH, BERT_SEQ)).astype(np.int32)).to(dev)
        coef = torch.randn((BERT_BATCH, BERT_SEQ, SPARSE_DIM), device=dev,
                           generator=gen)
        w0 = emb.weight.detach().clone()
        with autograd.record():
            loss = (emb(tokens) * coef).sum()
        autograd.backward(loss)
        grad = param.grad().clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if k == 0:
            w1 = emb.weight.detach()
            touched = torch.zeros(SPARSE_VOCAB, dtype=torch.bool, device=dev)
            touched[tokens.long().flatten()] = True
            assert torch.equal(w1[~touched], w0[~touched]), \
                "the sparse update moved an untouched row"
            dense = w0.clone()
            opt = optimizer.create("adam", **SPARSE_ADAM)
            opt.update(0, dense, grad, opt.create_state(0, dense))
            err = (w1[touched] - dense[touched]).abs().max().item()
            n_touched = int(touched.sum())
            assert err == 0.0, \
                f"touched rows part from a dense Adam step by {err}"
    dense = emb.weight.detach().clone()
    opt = optimizer.create("adam", **SPARSE_ADAM)
    state = opt.create_state(0, dense)
    dense_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.update(0, dense, grad, state)
        torch.cuda.synchronize()
        dense_ms.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times[1:]))
    log(f"[sparse] {card}: Embedding({SPARSE_VOCAB}, {SPARSE_DIM}, "
        f"sparse_grad=True), Adam {SPARSE_ADAM}, {BERT_BATCH} x {BERT_SEQ} "
        f"token ids ({n_touched} rows touched in the first step): untouched "
        f"rows bit-equal, touched rows bit-equal to a dense Adam step; the "
        f"touched-rows update {ms:.3f} ms (median of {SPARSE_STEPS - 1}), "
        f"a dense Adam update of the table {float(np.median(dense_ms)):.3f} "
        f"ms")
    return {"update_ms": ms, "dense_update_ms": float(np.median(dense_ms)),
            "touched_rows": n_touched}


def phase_detection(card, dev, profile):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ssd = ssd_train(card, dev, profile)
    families = family_runs(card, dev)
    remat = remat_runs(card, dev)
    sparse = sparse_embedding_run(card, dev)
    took = time.perf_counter() - t0
    log(f"[detection] phase 13 took {took:.1f} s")
    return {"ssd": ssd, "families": families, "remat": remat,
            "sparse": sparse, "seconds": took}


def nms_entry(ssd):
    d = ssd["detect"]
    return {"name": "nms_sweep", "route": "cuda",
            "source": "incubator_mxnet_tpu_torch/ops/csrc/nms.cu",
            "replaces": None, "launches": d["launches"]["nms_sweep"],
            "max_abs_err": d["max_abs_err"], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None,
            "mask_iou_tests": d["mask_iou_tests"],
            "mask_bytes": d["mask_bytes"],
            "workspace_bytes": d["workspace_bytes"],
            "detect_ms": d["detect_ms"],
            "detect_median_ms": d["detect_median_ms"],
            "shape": f"B={SSD_BATCH} A={SSD_ANCHORS} float32 boxes and "
                     f"class ids, IoU {SSD_NMS}, {d['alive']} rows alive, "
                     f"{d['iou_tests']} IoU tests (no PyTorch call computes "
                     f"greedy NMS)"}


def int8_entry(variants, engine):
    """The int8 variant's JSON entry, at the speculative verify shape the
    engine's decode waves launch (bf16 q, int8 slab, C = draft + 1)."""
    timed = [v for v in variants if "ms" in v]
    head = next(v for v in timed if v["C"] == DRAFT + 1
                and v["q_dtype"] == "bfloat16")
    return {
        "name": "paged_attention_int8", "route": "cuda",
        "source": "incubator_mxnet_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "incubator_mxnet_tpu/ops/pallas_kernels.py:292",
        "launches": engine["launches"]["paged_attention_int8"],
        "max_abs_err": max(v["max_abs_err"] for v in variants
                           if v["kv_dtype"] == "int8"),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"S={SLOTS} C={DRAFT + 1} H={FULL['heads']} "
                 f"D={FULL['head_dim']} T={FULL['max_len']} bfloat16 q, "
                 f"int8 slab (library: SDPA over the prefix dequantized to "
                 f"q's type beforehand, dequant not timed)",
        # the chunk (C = 256) over int8: bf16 and float16 q on the tensor
        # cores, each beside SDPA in q's type; then phase 8's float16 cases
        # (a peaked softmax, v_scale x 2^-12)
        **{f"chunk_C{WINDOW}_{q}_q": {
            k: v[k] for k in ("kernel_route", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}
           for q in ("bfloat16", "float16")
           for v in timed if v["C"] == WINDOW and v["q_dtype"] == q
           and "case" not in v},
        "float16_cases": [
            {k: v[k] for k in ("kv_dtype", "case", "kernel_route", "ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "max_rel", "rms_rel")}
            for v in timed if "case" in v],
        "variants": variants,
    }


FLASH_REPLACES = {"flash_fwd": 279, "flash_fwd_lse": 313,
                  "flash_bwd_dq": 366, "flash_bwd_dkv": 385}


def flash_entries(variants, bert):
    """The kernels' JSON entries for the transformer path: the numbers at
    the path's shape, the causal (48, 2048, 128) timing beside them. One
    entry a wrapper (its launches on either route), then one for each
    tensor-core backward sweep, the kernel the path's bf16 shape runs
    (its launches from its own counter)."""
    timed = [v for v in variants if "ms" in v["flash_fwd"]
             and v["flash_fwd"]["dtype"] == "bfloat16"]
    main, = [v for v in timed if v["flash_fwd"]["tq"] == FLASH_MAIN[1]]
    long_, = [v for v in timed if v["flash_fwd"]["tq"] == FLASH_LONG[1]]
    huge, = [v for v in timed if v["flash_fwd"]["d"] == FLASH_HUGE_TIMED[3]]
    entries = []
    for name in FLASH_KERNELS + ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"):
        wrapper = name.replace("_wgmma", "")
        r = main[wrapper]
        timed_long = {k: long_[wrapper][k] for k in
                      ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "max_abs_err")}
        # "route" is the build route (hand-written CUDA); which of a
        # wrapper's two kernels the shape took is "kernel_route"
        extra = {"kernel_route": r["route"]}
        if name == wrapper:
            extra["tensor_core_launches"] = bert["launches"][
                FLASH_WGMMA[name]]
        entries.append({
            "name": name, "route": "cuda",
            "source": "incubator_mxnet_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "incubator_mxnet_tpu/ops/pallas_attention.py:"
                        f"{FLASH_REPLACES[wrapper]}",
            "launches": bert["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"(bh, T, d) = ({r['bh']}, {r['tq']}, {r['d']}) "
                     f"{r['dtype']}, no mask (library: "
                     f"F.scaled_dot_product_attention "
                     f"{'forward' if name.startswith('flash_fwd') else 'backward (dq, dk, dv at once)'})",
            **extra, "causal_48x2048x128": timed_long,
            "d384_8x256": {k: huge[wrapper][k] for k in
                           ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "max_abs_err")},
            "variants": [v[wrapper] for v in variants
                         if v[wrapper]["route"] == r["route"]
                         or name == wrapper]})
    per_step = sum(main[n]["ms"] for n in FLASH_KERNELS[1:]) \
        * BERT["layers"]
    share = per_step / bert["step_ms"]
    log(f"[bert] the flash kernels take about {per_step:.3f} ms of a "
        f"{bert['step_ms']:.3f} ms step ({BERT['layers']} x (B6 + B7 + B8) "
        f"from phase 6): {100 * share:.1f}%")
    return entries, share


def f16_entries(tk, paged, flash, coverage, loop, serve_f16):
    """The float16 instances' JSON entries (ROADMAP C3), each with the
    launches of the path that runs it in float16, counted on counts set to
    0 just before that run: the apply in phase 10's float16-AMP Dense step,
    the paged read in phase 3's float16 arm (beside phase 10's float16
    engine), the flash kernels in phase 11 (c)."""
    base = "incubator_mxnet_tpu"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    stem = next(r for r in tk["apply"]
                if r["dtype"] == "float16" and "ms" in r)
    out = [dict({k: stem[k] for k in keys},
                name="scale_shift_act_float16", route="cuda",
                source="incubator_mxnet_tpu_torch/ops/csrc/scale_shift_act.cu",
                replaces=f"{base}/ops/pallas_kernels.py:112",
                launches=coverage["dense_f16"]["launches"],
                max_abs_err=max(r["max_abs_err"] for r in tk["apply"]
                                if r["dtype"] == "float16"),
                shape=f"M={stem['M']} C={stem['C']} act=None float16 (the "
                      f"stem BN's shape; library: torch.addcmul in float16)")]
    split = next(v for v in paged if v["dtype"] == "float16" and v["C"] == 1)
    chunk = next(v for v in paged if v["dtype"] == "float16"
                 and v["C"] == WINDOW)
    eng = coverage["engine_f16"]["launches"]
    arm = serve_f16["launches"]
    out.append(dict(
        {k: split[k] for k in keys}, name="paged_attention_float16",
        route="cuda",
        source="incubator_mxnet_tpu_torch/ops/csrc/paged_attention.cu",
        replaces=f"{base}/ops/pallas_kernels.py:292",
        launches=arm["paged_attention"], kernel_route="split",
        route_launches={r: arm[f"paged_attention_{r}"]
                        for r in ("split", "wgmma", "cuda_cores")},
        cover_launches=eng["paged_attention"],
        cover_route_launches={r: eng[f"paged_attention_{r}"]
                              for r in ("split", "wgmma", "cuda_cores")},
        shape=f"S={SLOTS} C=1 H={FULL['heads']} D={FULL['head_dim']} "
              f"T={FULL['max_len']} float16 q and slab (launches: phase "
              f"3's float16 arm; cover: phase 10's float16 engine)",
        chunk_C256={k: chunk[k] for k in keys + ("kernel_route",)}))
    timed = [v for v in flash if "ms" in v["flash_fwd"]
             and v["flash_fwd"]["dtype"] == "float16"]
    main, = [v for v in timed if v["flash_fwd"]["tq"] == FLASH_MAIN[1]]
    long_, = [v for v in timed if v["flash_fwd"]["tq"] == FLASH_LONG[1]]
    for name in FLASH_KERNELS:
        r = main[name]
        f16 = loop["f16"]
        # B5 runs in (c)'s inference forward, the others in its steps;
        # "kernel_route" is the route the path's shape takes (all four on
        # the tensor cores)
        if name == "flash_fwd":
            launches, tc = f16["infer_launches"], f16["infer_wgmma_launches"]
        else:
            launches = f16["launches"][name]
            tc = f16["launches"][FLASH_WGMMA[name]]
        out.append(dict(
            {k: r[k] for k in keys}, name=f"{name}_float16", route="cuda",
            source="incubator_mxnet_tpu_torch/ops/csrc/flash_attention.cu",
            replaces="incubator_mxnet_tpu/ops/pallas_attention.py:"
                     f"{FLASH_REPLACES[name]}",
            launches=launches, kernel_route=r["route"],
            tensor_core_launches=tc,
            shape=f"(bh, T, d) = ({r['bh']}, {r['tq']}, {r['d']}) float16, "
                  f"no mask (library: F.scaled_dot_product_attention "
                  f"{'forward' if name.startswith('flash_fwd') else 'backward'}"
                  f" in float16)",
            causal_48x2048x128={k: long_[name][k] for k in keys}))
    for e in out:
        assert e["launches"] > 0, f"{e['name']} never ran on its path"
    return out


def spill_report(ptxas_log):
    """(instances compiled, [(instance, ptxas line)] of those that spill)
    from `nvcc -Xptxas -v` output."""
    fn, n, spilled = None, 0, []
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            n += 1
        elif "spill stores" in line and not (
                " 0 bytes spill stores" in line
                and " 0 bytes spill loads" in line):
            spilled.append((fn, line.strip()))
    return n, spilled


BWD_WGMMA_SYMBOL = re.compile(
    r"(flash_bwd_d(?:q|kv)_wgmma_kernel)I(6__half|13__nv_bfloat16)Li(\d+)E")


def bwd_wgmma_usage(ptxas_log):
    """{"flash_bwd_dq_wgmma_kernel<float16, 64>": "168 registers; 0 bytes
    stack frame, 0 bytes spill stores, 0 bytes spill loads", ...}: the
    registers and spills of the tensor-core backward sweeps' instances
    from `nvcc -Xptxas -v` output."""
    types = {"6__half": "float16", "13__nv_bfloat16": "bfloat16"}
    usage, fn = {}, None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            m = BWD_WGMMA_SYMBOL.search(line)
            fn = m and f"{m[1]}<{types[m[2]]}, {m[3]}>"
            if fn:
                usage[fn] = ""
        elif fn and "spill stores" in line:
            usage[fn] = line.strip()
        elif fn and "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split("registers")[0].strip()
            usage[fn] = f"{regs} registers; {usage[fn]}"
            fn = None
    return usage


# ---------------------------------------------------------------------------
# phase 14: the array frontend (NDArray, mx.np, mx.npx) on the card
# ---------------------------------------------------------------------------
ARRAY_WARMUP, ARRAY_STEPS = 4, 8
ARRAY_SGD = {"learning_rate": 0.05, "momentum": 0.9}
ARRAY_CHECK_BATCH = 8
# the float32 check's rate: small enough that a random ResNet-50 in
# training mode stays finite over its 2 steps
ARRAY_CHECK_SGD = {"learning_rate": 1e-3, "momentum": 0.9}
CHAIN_OPS = 2000
ARRAY_FLASH = ((192, 512, 64, False, torch.bfloat16),
               (192, 512, 64, False, torch.float16),
               (48, 2048, 128, True, torch.bfloat16))
ARRAY_NMS = (BATCH, SSD_ANCHORS, 6)
# per-dtype limits of the sweep's card-against-CPU comparison: float32
# sums and libm in another order (TF32 off), integers and bools exact
SWEEP_TOL = {"float32": (1e-4, 1e-5), "float16": (2e-3, 1e-3),
             "bfloat16": (1.6e-2, 1e-2)}
# names whose card result may part further from the CPU's: LAPACK against
# cuSOLVER / cuBLAS, a fit through lstsq
SWEEP_LOOSE = {"np.polyfit": (1e-3, 1e-3), "np.corrcoef": (1e-4, 1e-4),
               "np.cov": (1e-4, 1e-4)}


class _Tally:
    """The launches the array frontend made in phase 14, by counter and by
    (counter, dtype): only the moves around its own calls are added, so
    the launches that compare a kernel with its plain version do not
    count."""

    def __init__(self):
        self.counts, self.by_dtype = {}, {}

    def run(self, fn):
        before, bd = kernels.launch_counts(), kernels.launch_counts_by_dtype()
        out = fn()
        torch.cuda.synchronize()
        after, ad = kernels.launch_counts(), kernels.launch_counts_by_dtype()
        moved = {n: after[n] - before[n] for n in after
                 if after[n] != before[n]}
        for n, v in moved.items():
            self.counts[n] = self.counts.get(n, 0) + v
        for k, v in ad.items():
            d = v - bd.get(k, 0)
            if d:
                self.by_dtype[k] = self.by_dtype.get(k, 0) + d
        return out, moved


def array_step(net, trainer, loss_fn, x, y):
    """bench.py's eager step (`bench_resnet50_train_eager`), as the JAX
    package writes it: NDArray inputs, a mean loss, `L.backward()`."""
    with mx.autograd.record():
        L = loss_fn(net(x), y).mean()
    L.backward()
    trainer.step(x.shape[0], ignore_stale_grad=True)
    return L


DISPATCH_REPEATS = 5


def _first(a, b):
    return a


def dispatch_cost(dev):
    """Host µs an eager op takes, medians of DISPATCH_REPEATS chains of
    CHAIN_OPS ops on a 1024-element card array: `x + 1.0` through the
    NDArray dispatch and on the bare tensor, each timed from the first
    issue to the last (then the stream drained: `wall`), and the dispatch
    alone, `ops.registry.invoke` of a function that launches nothing
    (unwrap, AMP and grad tests, wrap)."""
    def chain(kind):
        x = mx.np.ones((1024,), device=dev) if kind != "tensor" \
            else torch.ones(1024, device=dev)
        issued, walls = [], []
        for _ in range(DISPATCH_REPEATS):
            y = x
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "dispatch_only":
                for _ in range(CHAIN_OPS):
                    y = mx.ops.registry.invoke(_first, (y, 1.0), name="add")
            else:
                for _ in range(CHAIN_OPS):
                    y = y + 1.0
            issued.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        val = float(y[0]) if kind == "tensor" else y[0].item()
        assert val == (1.0 if kind == "dispatch_only" else 1.0 + CHAIN_OPS), \
            (kind, val)
        return {"host_us_per_op": float(np.median(issued)) / CHAIN_OPS * 1e6,
                "wall_us_per_op": float(np.median(walls)) / CHAIN_OPS * 1e6}
    out = {kind: chain(kind) for kind in ("ndarray", "tensor",
                                          "dispatch_only")}
    out["wrapper_us_per_op"] = (out["ndarray"]["host_us_per_op"]
                                - out["tensor"]["host_us_per_op"])
    return out


def array_resnet(card, dev, profile, tally, loop_per_step):
    """(a) bench.py's eager step at full width: ResNet-50 v1 NHWC, batch
    32 x 224^2, bf16 AMP, fusion default on, SGD momentum 0.9, inputs from
    mx.np.array."""
    batches = [(mx.np.array(x, device=dev), mx.np.array(y, device=dev))
               for x, y in make_batches(2, BATCH, seed=41)]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    amp.init("bfloat16")
    prev = fused.set_fusion_default(True)
    try:
        net = vision.resnet50_v1(layout="NHWC", classes=CLASSES, device=dev,
                                 seed=0)
        trainer = gluon.Trainer(net.collect_params(), "sgd", ARRAY_SGD)
        step = lambda x, y: array_step(net, trainer, loss_fn, x, y)  # noqa
        for i in range(ARRAY_WARMUP):
            step(*batches[i % 2]).wait_to_read()
        mx.waitall()
        mx.engine.stats(reset=True)
        mx.np.fallback_calls(reset=True)

        def timed():
            t0 = time.perf_counter()
            for i in range(ARRAY_STEPS):
                L = step(*batches[i % 2])
            L.wait_to_read()
            mx.waitall()
            return time.perf_counter() - t0, L
        (wall, L), moved = tally.run(timed)
        stats = mx.engine.stats()
        fallbacks = mx.np.fallback_calls()
        step_ms = wall / ARRAY_STEPS * 1e3
        prof = profile_steps(step, batches, step_ms, KERNEL_SYMBOLS,
                             "array resnet") if profile else None
    finally:
        fused.set_fusion_default(prev)
        amp.uninit()
    per_step = {n: moved.get(n, 0) / ARRAY_STEPS for n in
                ("scale_shift_act", "avg_pool2d_fwd", "avg_pool2d_bwd")}
    ips = BATCH * ARRAY_STEPS / wall
    loss = float(L.asnumpy())
    disp = stats["dispatch"] / ARRAY_STEPS
    log(f"[array resnet] {card}: {ARRAY_STEPS} eager steps (NDArray "
        f"inputs, loss_fn(net(x), y).mean(), L.backward(), trainer.step) of "
        f"batch {BATCH} x {IMAGE}^2, bf16 AMP, fusion default on, SGD "
        f"{ARRAY_SGD}: {step_ms:.3f} ms/step, {ips:.1f} images/s, last "
        f"loss {loss:.4f}; launches a step {per_step} (phase 11 (b)'s "
        f"tensor loop: {loop_per_step}); {disp:.1f} NDArray dispatches a "
        f"step ({stats}); host fallbacks {fallbacks}")
    assert np.isfinite(loss), "non-finite eager-step loss"
    assert per_step == loop_per_step, \
        "the NDArray step's launches differ from the tensor loop's"
    assert fallbacks == {}, f"host fallbacks on the card's path {fallbacks}"
    del net, trainer
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "images_per_s": ips, "loss": loss,
            "launches_per_step": per_step, "dispatch": stats,
            "dispatches_per_step": disp, "profile": prof}


def array_f32_check(dev):
    """The NDArray step and the tensor loop (`autograd.backward` on
    tensors) from the same weights and batches, float32, TF32 off,
    deterministic algorithms: bit-equal losses, weights and running
    statistics after 2 steps."""
    batches = make_batches(2, ARRAY_CHECK_BATCH, seed=43)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    prev = fused.set_fusion_default(True)
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        nets, losses = [], []
        for kind in ("ndarray", "tensor"):
            net = vision.resnet50_v1(layout="NHWC", classes=CLASSES,
                                     device=dev, seed=0)
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    ARRAY_CHECK_SGD)
            ls = []
            for x, y in batches:
                if kind == "ndarray":
                    L = array_step(net, trainer, loss_fn,
                                   mx.np.array(x, device=dev),
                                   mx.np.array(y, device=dev))
                    ls.append(L.asnumpy())
                else:
                    xt = torch.from_numpy(x).to(dev)
                    yt = torch.from_numpy(y).to(dev)
                    with autograd.record():
                        L = loss_fn(net(xt), yt).mean()
                    autograd.backward(L)
                    trainer.step(x.shape[0], ignore_stale_grad=True)
                    ls.append(L.detach().cpu().numpy())
            nets.append(net)
            losses.append(ls)
        a, b = (n.collect_params() for n in nets)
        parted = [name for name in a
                  if not torch.equal(a[name].data(), b[name].data())]
    finally:
        fused.set_fusion_default(prev)
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det[0], det[1]
        torch.use_deterministic_algorithms(det[2])
    same_loss = all(np.array_equal(p, q) and np.isfinite(p)
                    for p, q in zip(*losses))
    log(f"[array f32 check] NDArray step against the tensor loop, "
        f"ResNet-50 batch {ARRAY_CHECK_BATCH}, 2 steps, float32: losses "
        f"{[float(v) for v in losses[0]]} vs {[float(v) for v in losses[1]]}"
        f" (equal: {same_loss}); values parted: {len(parted)} of {len(a)}"
        f" {parted[:4]}")
    assert same_loss and not parted, \
        "the NDArray step is not bit-equal to the tensor loop"
    del nets
    torch.cuda.empty_cache()
    return {"losses": [float(v) for v in losses[0]], "values": len(a),
            "parted": parted}


def array_flash(dev, tally):
    """(b) npx.flash_attention on NDArrays: B5 outside record(), B6 + B7 +
    B8 under record() and backward(), each launch on the route the kernels
    name; bit-equal to ops.attention.flash_attention on the same tensors,
    and within phase 6's limits of the plain versions; a float32 NDArray
    under bf16 AMP reaches the kernel as bf16."""
    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for bh, t, d, causal, dtype in ARRAY_FLASH:
        q, k, v, do = (torch.randn((bh, t, d), generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        route = kernels.flash_fwd_route(dtype, d)
        o5, m5 = tally.run(lambda: mx.npx.flash_attention(
            mx.np.array(q), mx.np.array(k), mx.np.array(v), causal=causal))
        want5 = {"flash_fwd": 1}
        if route == "wgmma":
            want5["flash_fwd_wgmma"] = 1
        assert m5 == want5, f"flash forward launches {m5}, want {want5}"
        nd = [mx.np.array(a.clone()) for a in (q, k, v)]
        for a in nd:
            a.attach_grad()

        def recorded():
            with mx.autograd.record():
                o = mx.npx.flash_attention(*nd, causal=causal)
            o.backward(out_grad=mx.np.array(do))
            return o
        o6, m6 = tally.run(recorded)
        want6 = {"flash_fwd_lse": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
        if route == "wgmma":
            want6.update({n + "_wgmma": 1 for n in want6})
        assert m6 == want6, f"flash training launches {m6}, want {want6}"
        # the same tensors through the ops wrapper: bit-equal
        with torch.no_grad():
            ref5 = attention.flash_attention(q, k, v, causal=causal)
        qt, kt, vt = (a.clone().requires_grad_() for a in (q, k, v))
        with torch.enable_grad():
            ot = attention.flash_attention(qt, kt, vt, causal=causal)
            gq, gk, gv = torch.autograd.grad(ot, (qt, kt, vt), do)
        same = (torch.equal(o5._t, ref5) and torch.equal(o6._t, ot)
                and torch.equal(nd[0].grad._t, gq)
                and torch.equal(nd[1].grad._t, gk)
                and torch.equal(nd[2].grad._t, gv))
        # the plain versions, phase 6's limits
        scale = 1.0 / np.sqrt(d)
        o_ref, lse_ref = attention.flash_forward_lse_ref(q, k, v, causal,
                                                         scale)
        delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
        bwd = (q, k, v, do, lse_ref, delta, causal, scale)
        dq_ref = attention.flash_bwd_dq_ref(*bwd)
        dk_ref, dv_ref = attention.flash_bwd_dkv_ref(*bwd)
        errs = {n: _flash_err(g, r, dtype) for n, g, r in (
            ("o", o6._t, o_ref), ("dq", nd[0].grad._t, dq_ref),
            ("dk", nd[1].grad._t, dk_ref), ("dv", nd[2].grad._t, dv_ref))}
        ok = all(e[1] for e in errs.values())
        row = {"bh": bh, "t": t, "d": d, "causal": causal,
               "dtype": _dtype_name(dtype), "route": route,
               "bit_equal_to_ops": same,
               "max_abs_err": max(e[0] for e in errs.values()),
               "readings": {n: e[2] for n, e in errs.items()}}
        log(f"[array flash] {row}")
        assert same, "npx.flash_attention differs from ops.attention"
        assert ok, "npx.flash_attention outside phase 6's limits"
        rows.append(row)
    # AMP at dispatch: a float32 array reaches the kernel as bf16
    q32 = torch.randn((192, 512, 64), generator=gen, device=dev)
    amp.init("bfloat16")
    try:
        before = kernels.launch_counts_by_dtype()
        o, moved = tally.run(lambda: mx.npx.flash_attention(
            mx.np.array(q32), mx.np.array(q32), mx.np.array(q32)))
        after = kernels.launch_counts_by_dtype()
    finally:
        amp.uninit()
    bf16 = after.get(("flash_fwd", "bfloat16"), 0) - before.get(
        ("flash_fwd", "bfloat16"), 0)
    log(f"[array flash] float32 NDArrays under bf16 AMP: out {o.dtype}, "
        f"launches {moved}, bf16 B5 launches {bf16}")
    assert o.dtype == "bfloat16" and bf16 == 1, \
        "a float32 NDArray did not reach flash as bf16 under AMP"
    return rows


def array_paged(dev, tally):
    """(c) npx.paged_attention at phase 2's serving shapes, C = 1 (split)
    and C = 256 (wgmma), over a bf16 slab and an int8 slab with scales:
    one launch on the predicted route each, bit-equal to
    ops.fused.paged_attention on the same tensors."""
    from incubator_mxnet_tpu_torch.serve.continuous import _quantize_kv
    S, H, D, T, L = SLOTS, FULL["heads"], FULL["head_dim"], \
        FULL["max_len"], FULL["layers"]
    gen = torch.Generator(device=dev).manual_seed(15)
    k32 = torch.randn((S + 1, L, T, H, D), generator=gen, device=dev)
    v32 = torch.randn((S + 1, L, T, H, D), generator=gen, device=dev)
    rng = np.random.RandomState(0)
    lens = torch.as_tensor(np.concatenate(
        [[0, 1, 255, 1000, 2047 - WINDOW], rng.randint(0, T - WINDOW, S - 5)]
    ).astype(np.int32), device=dev)
    kc, ks = _quantize_kv(k32)
    vc, vs = _quantize_kv(v32)
    slabs = {"bfloat16": (k32.to(torch.bfloat16), v32.to(torch.bfloat16), {}),
             "int8": (kc, vc, {"k_scale": ks, "v_scale": vs})}
    del k32, v32
    rows = []
    layer = 5
    for kind, (k, v, sc) in slabs.items():
        for C in (1, WINDOW):
            q = torch.randn((S, C, H, D), generator=gen,
                            device=dev).to(torch.bfloat16)
            route = kernels.paged_route(q.dtype, k.dtype, D, C)
            out, moved = tally.run(lambda: mx.npx.paged_attention(
                mx.np.array(q), mx.np.array(k), mx.np.array(v),
                mx.np.array(lens), layer,
                **{n: mx.np.array(s) for n, s in sc.items()}))
            counter = "paged_attention_int8" if sc else "paged_attention"
            want = {counter: 1, f"paged_attention_{route}": 1}
            ref = fused.paged_attention(q, k, v, lens, layer,
                                        sc.get("k_scale"), sc.get("v_scale"))
            same = torch.equal(out._t, ref)
            row = {"slab": kind, "C": C, "route": route, "launches": moved,
                   "bit_equal_to_ops": same}
            log(f"[array paged] {row}")
            assert moved == want, f"paged launches {moved}, want {want}"
            assert route == ("split" if C == 1 else "wgmma"), route
            assert same, "npx.paged_attention differs from ops.fused"
            rows.append(row)
    del slabs
    torch.cuda.empty_cache()
    return rows


def array_fused(dev, tally):
    """(d) the npx fused ops at the ResNet-50 stem's (32 x 112^2, 64) and
    the global pool's (32, 7, 7, 2048) shapes, float32, bfloat16 and
    float16: one B1 launch an apply op, B2 and B3 for the pool's forward
    and backward; each within its plain version's limits of phase 4 (the
    pool's backward bit-equal)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    n, hw, c = BATCH, IMAGE // 2, 64
    rows = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = torch.randn((n, hw, hw, c), generator=gen, device=dev).to(dtype)
        r = torch.randn((n, hw, hw, c), generator=gen, device=dev).to(dtype)
        g = 1.0 + 0.2 * torch.randn((c,), generator=gen, device=dev)
        b = 0.2 * torch.randn((c,), generator=gen, device=dev)
        rm = 0.1 * torch.randn((c,), generator=gen, device=dev)
        rv = 1.0 + 0.2 * torch.rand((c,), generator=gen, device=dev)
        X, R_, G, B, RM, RV = (mx.np.array(t) for t in (x, r, g, b, rm, rv))
        # fused_batch_norm's plain version: its batch moments, folded,
        # then the plain apply
        xf = x.float()
        mean = xf.mean(dim=(0, 1, 2))
        var = (xf * xf).mean(dim=(0, 1, 2)) - mean * mean
        scale, shift = fused._fold_bn(g, b, mean, var, 1e-5)
        del xf
        cases = {
            "fused_bias_act": (lambda: mx.npx.fused_bias_act(
                X, B, act_type="relu"), fused.bias_act_ref(x, b, "relu")),
            "fused_norm_act_residual": (
                lambda: mx.npx.fused_norm_act_residual(X, G, B, R_,
                                                       act_type="relu"),
                fused.norm_act_residual_ref(x, g, b, r, "relu")),
            "fused_bn_inference": (
                lambda: mx.npx.fused_bn_inference(X, G, B, RM, RV,
                                                  act_type="relu"),
                fused.bn_inference_ref(x, g, b, rm, rv, act_type="relu")),
            "fused_batch_norm": (
                lambda: mx.npx.fused_batch_norm(
                    X, G, B, mx.np.array(rm.clone()), mx.np.array(rv.clone()),
                    axis=-1, training=True, act_type="relu"),
                fused.apply_ref(x, scale, shift, None, "relu", -1)),
        }
        for name, (call, ref) in cases.items():
            out, moved = tally.run(call)
            err, ok = _err_ok(out._t, ref, dtype)
            rows.append({"op": name, "dtype": _dtype_name(dtype),
                         "launches": moved, "max_abs_err": err})
            log(f"[array fused] {name} {_dtype_name(dtype)} "
                f"{tuple(x.shape)}: launches {moved}, max_abs_err "
                f"{err:.3e}")
            assert moved == {"scale_shift_act": 1}, (name, moved)
            assert ok, f"npx.{name} outside its plain version's limits"
        del x, r, X, R_
        # the global pool, forward (B2) and backward (B3)
        p = torch.randn(POOL_GLOBAL[0], generator=gen, device=dev).to(dtype)
        dy = torch.randn((BATCH, 1, 1, 2048), generator=gen,
                         device=dev).to(dtype)
        P = mx.np.array(p.clone())
        P.attach_grad()

        def pooled():
            with mx.autograd.record():
                y = mx.npx.fused_avg_pool2d(P, POOL_GLOBAL[1])
            y.backward(out_grad=mx.np.array(dy))
            return y
        y, moved = tally.run(pooled)
        ref = fused.avg_pool2d_ref(p, POOL_GLOBAL[1])
        err, ok, read = pool_fwd_err(y._t, ref, dtype)
        gref = fused.avg_pool2d_bwd_ref(dy, 7, 7, 7, 7)
        same = torch.equal(P.grad._t, gref)
        rows.append({"op": "fused_avg_pool2d", "dtype": _dtype_name(dtype),
                     "launches": moved, "max_abs_err": err, **read,
                     "backward_bit_equal": same})
        log(f"[array fused] fused_avg_pool2d {_dtype_name(dtype)} "
            f"{POOL_GLOBAL}: launches {moved}, max_abs_err {err:.3e} {read},"
            f" backward bit-equal {same}")
        assert moved == {"avg_pool2d_fwd": 1, "avg_pool2d_bwd": 1}, moved
        assert ok and same, "npx.fused_avg_pool2d off its plain version"
    torch.cuda.empty_cache()
    return rows


def array_nms(dev, tally):
    """(e) npx.box_nms at (32, 8732, 6): the NMS kernels once, bit-equal to
    ops.contrib.box_nms on the same tensor, its keep mask bit-equal to the
    plain sweep's on the same sorted rows; then by class (id_index 0) with
    and without force_suppress, each once and bit-equal to box_nms."""
    rng = np.random.RandomState(17)
    B, A, K = ARRAY_NMS
    xy = rng.rand(B, A, 2) * 0.8
    wh = 0.02 + rng.rand(B, A, 2) * 0.2
    data = np.concatenate([rng.randint(0, 20, (B, A, 1)), rng.rand(B, A, 1),
                           xy, xy + wh], -1).astype(np.float32)
    t = torch.from_numpy(data).to(dev)
    kw = dict(overlap_thresh=0.45, valid_thresh=0.5, topk=400)
    seen = []
    orig = contrib.nms_sweep

    def capture(boxes, ids, keep, thresh):
        seen.append((boxes.clone(), None if ids is None else ids.clone(),
                     keep.clone(), thresh))
        out = orig(boxes, ids, keep, thresh)
        seen.append(out.clone())
        return out
    contrib.nms_sweep = capture
    try:
        out, moved = tally.run(lambda: mx.npx.box_nms(mx.np.array(t), **kw))
    finally:
        contrib.nms_sweep = orig
    ref = contrib.box_nms(t, **kw)
    same = torch.equal(out._t, ref)
    (boxes, ids, keep, thresh), kept = seen
    plain = contrib.nms_sweep_ref(boxes, ids, keep, thresh)
    same_keep = torch.equal(plain, kept)
    row = {"shape": list(ARRAY_NMS), "launches": moved,
           "bit_equal_to_ops": same, "keep_equal_to_plain": same_keep,
           "alive": int(keep.sum()), "kept": int(kept.sum()),
           "workspace_bytes": kernels.nms_mask_bytes(B, A)}
    assert moved == {"nms_sweep": 1}, moved
    assert same and same_keep, "npx.box_nms off the kernel or the plain sweep"
    for fs in (False, True):
        kw_id = dict(kw, id_index=0, force_suppress=fs)
        out, moved = tally.run(lambda: mx.npx.box_nms(mx.np.array(t),
                                                      **kw_id))
        same = torch.equal(out._t, contrib.box_nms(t, **kw_id))
        row[f"by_class_force{fs}"] = {"launches": moved, "bit_equal": same}
        assert moved == {"nms_sweep": 1} and same, \
            f"npx.box_nms(force_suppress={fs}) off the kernel or box_nms"
    log(f"[array nms] {row}")
    return row


def sweep_cases():
    """(args, kwargs) of the sweep for the names a generic signature does
    not fit (numpy values: each run makes its own arrays)."""
    r = np.random.RandomState(18)
    A = r.randn(3, 4).astype(np.float32)
    B = r.randn(3, 4).astype(np.float32)
    A3 = r.randn(2, 3, 4).astype(np.float32)
    M = r.randn(4, 5).astype(np.float32)
    V = r.randn(6).astype(np.float32)
    W3 = r.randn(3).astype(np.float32)
    X4 = r.randn(2, 3, 4, 5).astype(np.float32)
    NHWC = r.randn(2, 4, 4, 8).astype(np.float32)
    g3, b3 = (1 + 0.2 * r.randn(3)).astype(np.float32), \
        (0.1 * r.randn(3)).astype(np.float32)
    g4, b4 = (1 + 0.2 * r.randn(4)).astype(np.float32), \
        (0.1 * r.randn(4)).astype(np.float32)
    g8, b8 = (1 + 0.2 * r.randn(8)).astype(np.float32), \
        (0.1 * r.randn(8)).astype(np.float32)
    rv8 = (1 + 0.2 * r.rand(8)).astype(np.float32)
    xy = r.rand(2, 12, 2) * 0.6
    boxes = np.concatenate([r.randint(0, 3, (2, 12, 1)), r.rand(2, 12, 1),
                            xy, xy + 0.1 + 0.3 * r.rand(2, 12, 2)],
                           -1).astype(np.float32)
    feat = r.randn(1, 4, 3, 3).astype(np.float32)
    anchors = np.asarray(contrib.multibox_prior(
        torch.from_numpy(feat), sizes=(0.3, 0.5), ratios=(1.0, 2.0)))
    na = anchors.shape[1]
    label = np.full((2, 3, 5), -1.0, np.float32)
    label[0, :2] = [[0, 0.1, 0.1, 0.4, 0.5], [2, 0.5, 0.4, 0.9, 0.8]]
    label[1, :1] = [[1, 0.2, 0.3, 0.6, 0.7]]
    logits = r.randn(2, 4, na).astype(np.float32)
    prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
            ).astype(np.float32)
    slab = r.randn(4, 2, 12, 2, 8).astype(np.float32)
    i32 = lambda *v: np.array(v, np.int32)                      # noqa: E731
    return {
        "np.bartlett": ((5,), {}), "np.blackman": ((5,), {}),
        "np.hamming": ((5,), {}), "np.hanning": ((5,), {}),
        "np.kaiser": ((5, 2.0), {}),
        "np.broadcast_to": ((W3[:, None], (3, 4)), {}),
        "np.can_cast": (("int32", "float32"), {}),
        "np.choose": ((i32(0, 1, 1, 0), [A, B]), {}),
        "np.cross": ((A[:, :3].copy(), B[:, :3].copy()), {}),
        "np.digitize": ((V, np.sort(V)[1:4].copy()), {}),
        "np.dsplit": ((A3, 2), {}), "np.einsum": (("ij,jk->ik", A, M), {}),
        "np.eye": ((3,), {"k": 1}), "np.identity": ((3,), {}),
        "np.geomspace": ((1.0, 1000.0, 4), {}),
        "np.linspace": ((0.0, 1.0, 7), {}),
        "np.logspace": ((0.0, 2.0, 4), {}), "np.indices": (((2, 3),), {}),
        "np.interp": ((V, np.sort(V), W3.repeat(2)), {}),
        "np.matmul": ((A, M), {}), "np.meshgrid": ((W3, V), {}),
        "np.moveaxis": ((A3, 0, -1), {}), "np.swapaxes": ((A3, 0, 2), {}),
        "np.nanquantile": ((A, 0.7), {"axis": 0}),
        "np.quantile": ((A, 0.3), {}), "np.polyder": ((V,), {}),
        "np.polyint": ((W3,), {}), "np.polyval": ((W3, V), {}),
        "np.polyfit": ((V, V * V - 2 * V, 2), {}),
        "np.promote_types": (("int32", "float16"), {}),
        "np.put_along_axis": ((A, i32(0, 2, 1)[:, None], 9.0, 1), {}),
        "np.ravel_multi_index": (((i32(0, 2), i32(1, 3)), (3, 4)), {}),
        "np.reshape": ((A, (4, 3)), {}), "np.split": ((A, 2), {"axis": 1}),
        "np.vsplit": ((M, 2), {}),
        "np.take_along_axis": ((A, np.argsort(A, 1).astype(np.int32)),
                               {"axis": 1}),
        "np.tri": ((3,), {}), "np.tril_indices": ((4,), {}),
        "np.triu_indices": ((4, 1), {}),
        "np.unravel_index": ((i32(1, 5, 11), (3, 4)), {}),
        "np.vander": ((W3,), {}),
        "npx.activation": ((A,), {"act_type": "softrelu"}),
        "npx.batch_norm": ((X4, g3, b3, 0.1 * b3, 1 + g3 * g3),
                           {"training": True}),
        "npx.box_nms": ((boxes,), {"overlap_thresh": 0.3}),
        "npx.convolution": ((X4, (r.randn(4, 3, 3, 3) / 3).astype(
            np.float32), b4), {"pad": 1}),
        "npx.deconvolution": ((X4, (r.randn(3, 2, 3, 3) / 3).astype(
            np.float32)), {"stride": 2}),
        "npx.flash_attention": ((A3, A3 * 0.5, A3[::-1].copy()),
                                {"causal": True}),
        "npx.fused_avg_pool2d": ((NHWC,), {"pool_size": 2}),
        "npx.fused_batch_norm": ((NHWC, g8, b8, 0.1 * b8, rv8),
                                 {"axis": -1, "training": True}),
        "npx.fused_bias_act": ((NHWC, b8), {}),
        "npx.fused_bn_inference": ((NHWC, g8, b8, 0.1 * b8, rv8),
                                   {"act_type": "relu"}),
        "npx.fused_norm_act_residual": ((NHWC, g8, b8, NHWC[::-1].copy()),
                                        {}),
        "npx.group_norm": ((X4, g3, b3), {"num_groups": 1}),
        "npx.instance_norm": ((X4, g3, b3), {}),
        "npx.layer_norm": ((A, g4, b4), {}),
        "npx.masked_softmax": ((A, A > 0), {}),
        "npx.multibox_detection": ((prob, (0.1 * r.randn(2, na * 4)).astype(
            np.float32), anchors), {}),
        "npx.multibox_prior": ((feat,), {"sizes": (0.3, 0.5),
                                         "ratios": (1.0, 2.0)}),
        "npx.multibox_target": ((anchors, label, logits), {}),
        "npx.paged_attention": ((r.randn(3, 2, 2, 8).astype(np.float32),
                                 slab, slab[::-1].copy(), i32(0, 4, 9), 1),
                                {}),
        "npx.pick": ((A, i32(0, 3, 1)), {}),
        "npx.embedding": ((i32(0, 2, 5), r.randn(7, 4).astype(np.float32)),
                          {}),
        "npx.pooling": ((X4,), {"kernel": 2, "stride": 2}),
        "npx.scaled_dot_product_attention": ((X4, X4 * 0.5, X4[::-1].copy()),
                                             {}),
        # no crop and no mirror: the result does not depend on the draws
        "npx.fused_image_augment": ((r.randint(0, 256, (2, 4, 4, 3)).astype(
            np.uint8), (3, 1)), {"mean": (0.4, 0.5, 0.6),
                                 "std": (0.2, 0.25, 0.3)}),
    }


def _sweep_generic():
    r = np.random.RandomState(19)
    A = r.randn(3, 4).astype(np.float32)
    B = r.randn(3, 4).astype(np.float32)
    return [((A,), {}), ((A, B), {}), ((np.abs(A) + 0.5,), {}),
            ((r.randint(1, 9, (3, 4)).astype(np.int32),
              r.randint(1, 4, (3, 4)).astype(np.int32)), {}),
            ((A > 0,), {}), ((A, 2), {})]


def _sweep_fn(name):
    ns, _, short = name.partition(".")
    return getattr(mx.np if ns == "np" else mx.npx, short)


def _sweep_args(obj, device):
    if isinstance(obj, np.ndarray):
        return mx.np.array(obj, device=device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_sweep_args(v, device) for v in obj)
    return obj


def _sweep_compare(got, want, tol, where, card):
    """(ok, worst error) of the card's result (on `card`) against the
    CPU's."""
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return False, where
        res = [_sweep_compare(g, w, tol, where, card)
               for g, w in zip(got, want)]
        return all(r[0] for r in res), max((r[1] for r in res
                                            if not isinstance(r[1], str)),
                                           default=0.0)
    if isinstance(want, mx.NDArray):
        if not isinstance(got, mx.NDArray) or got.shape != want.shape \
                or str(got.dtype) != str(want.dtype) \
                or got.device != card:
            return False, where
        g, w = got.asnumpy(), want.asnumpy()
        if w.dtype.kind in "fc":
            rtol, atol = tol.get(str(want.dtype), (1e-4, 1e-5))
            err = float(np.nanmax(np.abs(g - w), initial=0.0))
            ok = bool(np.allclose(g, w, rtol=rtol, atol=atol,
                                  equal_nan=True))
            return ok, err
        return bool(np.array_equal(g, w)), 0.0
    return got == want, 0.0


def array_sweep(dev):
    """(f) every registered np / npx name on the card against the same call
    on the CPU, with per-dtype limits (SWEEP_TOL); the host fallbacks the
    table's names made must be none."""
    special = sweep_cases()
    generic = _sweep_generic()
    card = mx.context.Device("gpu", dev.index or 0) if dev.type == "cuda" \
        else mx.cpu()
    names = [n for n in mx.ops.registry.list_ops()
             if n.split(".")[0] in ("np", "npx")]
    mx.np.fallback_calls(reset=True)
    swept, failed, unswept = [], [], []
    worst = {}
    for name in names:
        fn = _sweep_fn(name)
        tries = [special[name]] if name in special else generic
        want = None
        for args, kw in tries:
            try:
                with mx.cpu():
                    want = fn(*_sweep_args(args, "cpu"), **kw)
                case = (args, kw)
                break
            except Exception:       # another generic signature fits
                continue
        if want is None:
            unswept.append(name)
            continue
        args, kw = case
        with card:
            got = fn(*_sweep_args(args, dev), **kw)
        torch.cuda.synchronize()
        tol = dict(SWEEP_TOL)
        if name in SWEEP_LOOSE:
            tol["float32"] = SWEEP_LOOSE[name]
        ok, err = _sweep_compare(got, want, tol, name, card)
        worst[name] = err
        (swept if ok else failed).append(name)
    fallbacks = mx.np.fallback_calls()
    log(f"[array sweep] {len(swept)} of {len(names)} registered np/npx "
        f"names on the card equal to the CPU within {SWEEP_TOL}; failed "
        f"{failed}; no case {unswept}; host fallbacks {fallbacks} (the "
        f"host-numpy names {mx.np.fallback_names()} are not registered)")
    assert not failed and not unswept, (failed, unswept)
    assert fallbacks == {}, f"host fallbacks in the sweep {fallbacks}"
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:8]
    return {"names": len(names), "swept": len(swept), "worst": top,
            "fallbacks": fallbacks}


def array_out_of_range(dev):
    """(g) Out-of-range gathers on the card (ROADMAP C7): a prompt token past
    the vocabulary is served by `ContinuousEngine` (it reads the last
    embedding row, as XLA's clamping gather does), the next request is
    served too, and NDArray indexing and `np.take` clamp and fill without a
    device-side assert; the context then still runs."""
    model = serve.CachedDecoder(serve.DecoderConfig(max_len=64), seed=0,
                                device=dev)
    V = model.config.vocab
    bad, clamped, good = [3, V + 7, 11, 5], [3, V - 1, 11, 5], [4, 9, 2, 8]
    with serve.ContinuousEngine(model, max_slots=4) as eng:
        out_bad = eng.submit(bad, 8).result(timeout=300)
        out_good = eng.submit(good, 8).result(timeout=300)
        window = eng.prefill_window
    served = (np.array_equal(out_bad, model.reference_generate(
        clamped, 8, window=window)) and np.array_equal(
        out_good, model.reference_generate(good, 8, window=window)))
    card = mx.Device("gpu", dev.index or 0)
    with card:
        a = mx.np.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        rows = a[mx.np.array([5, -9])].asnumpy()
        take = mx.np.take(a, mx.np.array([0, 7])).asnumpy()
    after = float((torch.ones(64, 64, device=dev) @ torch.ones(
        64, 64, device=dev)).sum())
    torch.cuda.synchronize()
    ok = (served and rows.tolist() == [[3, 4, 5], [0, 1, 2]]
          and take[0] == 0 and np.isnan(take[1]) and after == 64.0 ** 3)
    log(f"[array out-of-range] prompt token {V + 7} (vocab {V}) served as "
        f"the clamped row and the next request served: {served}; a[[5, -9]] "
        f"rows {rows.tolist()}, take([0, 7]) {take.tolist()}; the context "
        f"runs after: {after == 64.0 ** 3}")
    assert ok, "out-of-range gathers on the card"
    return {"served": served, "rows": rows.tolist(),
            "take": [None if np.isnan(v) else float(v) for v in take]}


def phase_array(card, dev, profile, loop_per_step):
    """Phase 14: the array frontend on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    tally = _Tally()
    cost = dispatch_cost(dev)
    log(f"[array dispatch] {card}: chained x + 1.0 on a 1024-element "
        f"array, {CHAIN_OPS} ops: NDArray "
        f"{cost['ndarray']['host_us_per_op']:.2f} µs host / "
        f"{cost['ndarray']['wall_us_per_op']:.2f} µs wall an op, tensor "
        f"{cost['tensor']['host_us_per_op']:.2f} / "
        f"{cost['tensor']['wall_us_per_op']:.2f}; the wrapper "
        f"{cost['wrapper_us_per_op']:.2f} µs an op; the dispatch alone "
        f"(invoke of a function that launches nothing) "
        f"{cost['dispatch_only']['host_us_per_op']:.2f} µs")
    resnet = array_resnet(card, dev, profile, tally, loop_per_step)
    resnet["dispatch_host_ms_per_step"] = (
        resnet["dispatches_per_step"] * cost["ndarray"]["host_us_per_op"]
        / 1e3)
    log(f"[array resnet] {resnet['dispatches_per_step']:.1f} NDArray "
        f"dispatches a step at {cost['ndarray']['host_us_per_op']:.2f} µs: "
        f"{resnet['dispatch_host_ms_per_step']:.4f} host ms of a "
        f"{resnet['step_ms']:.3f} ms step")
    f32 = array_f32_check(dev)
    flash_rows = array_flash(dev, tally)
    paged_rows = array_paged(dev, tally)
    fused_rows = array_fused(dev, tally)
    nms = array_nms(dev, tally)
    oor = array_out_of_range(dev)
    sweep = array_sweep(dev)
    took = time.perf_counter() - t0
    log(f"[array] phase 14 took {took:.1f} s; npx launches "
        f"{tally.counts}")
    return {"dispatch_cost": cost, "resnet": resnet, "f32_check": f32,
            "flash": flash_rows, "paged": paged_rows, "fused": fused_rows,
            "nms": nms, "out_of_range": oor, "sweep": sweep,
            "npx_launches": tally.counts,
            "npx_launches_by_dtype": {f"{k[0]}:{k[1]}": v for k, v in
                                      tally.by_dtype.items()},
            "seconds": took}


# ---------------------------------------------------------------------------
# phase 15: the input path
# ---------------------------------------------------------------------------
IO_RECORDS, IO_SIDE, IO_QUALITY = 1024, 256, 85
IO_WARMUP, IO_STEPS = 4, 12
# ImageNet's mean and std in pixel units (benchmark/io_bench.py:95)
IO_NORM = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939,
               std_r=58.393, std_g=57.12, std_b=57.375)
IO_ITER = dict(data_shape=(IMAGE, IMAGE, 3), batch_size=BATCH, shuffle=True,
               rand_crop=True, rand_mirror=True, resize=256, seed=3,
               round_batch=False)
IO_MEAN = tuple(v / 255.0 for v in (123.68, 116.779, 103.939))
IO_STD = tuple(v / 255.0 for v in (58.393, 57.12, 57.375))
IO_HOST_BATCHES = 6
LOADER_IMAGES, LOADER_SIDE, LOADER_BATCH = 64, 64, 16


def host_facts():
    """(0) The card machine's decoders: PIL, libjpeg's header, and the route
    the port's reader takes (the native library needs g++ and libjpeg)."""
    from incubator_mxnet_tpu_torch import native
    try:
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    jpeglib = os.path.isfile("/usr/include/jpeglib.h")
    has_native = native.load_imagerec() is not None
    route = "native" if has_native else ("python (PIL)" if has_pil
                                         else "none")
    facts = {"cpu_count": os.cpu_count(), "PIL": has_pil,
             "jpeglib_h": jpeglib, "native_imagerec": has_native,
             "decode_route": route}
    log(f"[io host] cpu_count {facts['cpu_count']}; import PIL: "
        f"{'yes' if has_pil else 'no'}; /usr/include/jpeglib.h: "
        f"{'yes' if jpeglib else 'no'}; decode route: {route}")
    return facts


def write_records(path, facts):
    """(a) A .rec of IO_RECORDS records: with PIL, 256-320 x 256-352 JPEGs
    at quality 85 from a seed (smooth waves plus noise, as
    benchmark/io_bench.py:59-75 makes them); without it, the 12 JPEG
    payloads of tests/data/tiny_imagerec.rec cycled under new ids and
    labels."""
    from incubator_mxnet_tpu_torch import recordio
    t0 = time.perf_counter()
    w = recordio.MXRecordIO(path, "w")
    reduced = None
    if facts["PIL"]:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            jpegs = list(pool.map(_jpeg_record, range(IO_RECORDS)))
        for i, jpeg in enumerate(jpegs):
            w.write(recordio.pack(recordio.IRHeader(0, float(i % CLASSES),
                                                    i, 0), jpeg))
    else:
        reduced = "decode sources 44-66 px, not 256 px"
        r = recordio.MXRecordIO(os.path.join("tests", "data",
                                             "tiny_imagerec.rec"), "r")
        payloads = []
        while (rec := r.read()) is not None:
            payloads.append(recordio.unpack(rec)[1])
        r.close()
        for i in range(IO_RECORDS):
            w.write(recordio.pack(recordio.IRHeader(0, float(i % CLASSES),
                                                    i, 0),
                                  payloads[i % len(payloads)]))
        log(f'[io records] reduced: "{reduced}"')
    w.close()
    took = time.perf_counter() - t0
    log(f"[io records] wrote {IO_RECORDS} records "
        f"({os.path.getsize(path) / 2 ** 20:.1f} MiB) in {took:.2f} s")
    return {"seconds": took, "bytes": os.path.getsize(path),
            "reduced": reduced}


def _jpeg_record(i):
    """Record i's JPEG, from its own seed (numpy and PIL release the GIL,
    so threads make them in parallel)."""
    import io as pyio

    from PIL import Image
    rng = np.random.default_rng(i)
    h = IO_SIDE + int(rng.integers(0, 64))
    wd = IO_SIDE + int(rng.integers(0, 96))
    base = (127 + 80 * np.sin(np.arange(h) / 23.0 + i)[:, None]
            + 40 * np.cos(np.arange(wd) / 17.0)[None, :])
    img = np.stack([base, base * 0.8, base * 1.1], -1)
    img += rng.standard_normal((h, wd, 3), dtype=np.float32) * 12
    buf = pyio.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=IO_QUALITY)
    return buf.getvalue()


def augment_images(dev, gen, shape, in_dtype, view):
    """Seeded pixels of `in_dtype` over its range (int64 past int32's);
    `view`: an unaligned view one element into a larger buffer."""
    n = int(np.prod(shape)) + (1 if view else 0)
    if in_dtype == torch.bool:
        flat = torch.randint(0, 2, (n,), generator=gen, device=dev).bool()
    elif in_dtype == torch.float32:
        flat = torch.rand((n,), generator=gen, device=dev)
    elif in_dtype == torch.int64:
        flat = torch.randint(-2 ** 40, 2 ** 40, (n,), generator=gen,
                             device=dev, dtype=torch.int64)
    else:
        lo, hi = (0, 256) if in_dtype == torch.uint8 else \
            (torch.iinfo(in_dtype).min, torch.iinfo(in_dtype).max + 1)
        flat = torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int64).to(in_dtype)
    return (flat[1:] if view else flat).view(shape)


def table_bytes(x, draws, crop, cout):
    """The bytes the table route reads: each output element's pixel byte
    after the crop (first 3 channels when it cuts), the mirror and the
    channel broadcast; `fused.augment_table_ref`'s table gathered at them
    (`table[arange(cout), bytes]`) emulates the route."""
    y0, x0, flips = draws
    n, h, w, c = x.shape
    b = x.to(torch.uint8) if x.dtype == torch.bool else x.view(torch.uint8)
    ch, cw = crop or (h, w)
    if (ch, cw) != (h, w):
        dev = x.device
        rows = fused._start(y0, h, ch)[:, None] + torch.arange(ch, device=dev)
        cols = fused._start(x0, w, cw)[:, None] + torch.arange(cw, device=dev)
        b = b[torch.arange(n, device=dev)[:, None, None], rows[:, :, None],
              cols[:, None, :], :3]
    b = torch.where(flips.bool()[:, None, None, None], b.flip(2), b)
    return b.expand(*b.shape[:3], cout).long()


def check_augment(dev, gen, shape, out_dtype, crop, fl=False, timed=False,
                  in_dtype=torch.uint8, mean=IO_MEAN, std=IO_STD,
                  view=False, reps=50):
    """(b) The augment kernel against its plain version on the same draws:
    bit-equal, on the route `kernels.augment_route` names; with a mirror,
    one flip bit changed must be refused; on the table route, the table
    emulated in plain torch (`fused.augment_table_ref`, gathered) must
    equal the kernel, and the same table with one entry one unit in the
    last place off must be refused."""
    n, h, w, c = shape
    x = augment_images(dev, gen, shape, in_dtype, view)
    if fl:
        x = (x.float() / 255.0).requires_grad_()
    draws = fused.augment_draws((11, 5), n, (h, w), crop, True, dev)
    ch, cw = crop or (h, w)
    cr, cout = kernels.augment_channels(
        c, (ch, cw) != (h, w), None if mean is None else len(mean),
        None if std is None else len(std))
    kernel_in = {torch.int64: torch.int32}.get(x.dtype, x.dtype)
    route = kernels.augment_route(kernel_in, c, cout, cw)
    kernels.reset_launch_counts()
    out = fused._augment_apply(x, *draws, crop, mean, std, out_dtype)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches = counts["image_augment"]
    with torch.no_grad():
        ref = fused.image_augment_ref(x.detach(), *draws, crop, mean, std,
                                      out_dtype)
    err = float((out.detach().float() - ref.float()).abs().max())
    equal = torch.equal(out.detach(), ref)
    flips = draws[2].clone()
    flips[0] ^= 1
    planted = fused._augment_apply(x.detach(), draws[0], draws[1], flips,
                                   crop, mean, std, out_dtype)
    refused = not torch.equal(planted, ref)
    row = {"shape": list(shape), "crop": [ch, cw],
           "in": _dtype_name(x.dtype), "out": _dtype_name(out_dtype),
           "channels": [c, cr, cout],
           "mean_std": [None if v is None else len(v) for v in (mean, std)],
           "view": view, "route": route, "route_launches": counts[
               f"image_augment_{route}"],
           "launches": launches, "equal": equal, "max_abs_err": err,
           "planted_refused": refused}
    if route == "table":
        table = fused.augment_table_ref(kernel_in, cout, mean, std,
                                        out_dtype, dev)
        b = table_bytes(x.detach(), draws, crop, cout)
        chans = torch.arange(cout, device=dev)
        row["table_emulation_equal"] = torch.equal(table[chans, b], out)
        v = int(b[0, 0, 0, 0])      # an entry the output reads
        bad = table.clone()
        if out_dtype == torch.float32:
            bad[0, v] = torch.nextafter(bad[0, v], torch.tensor(
                float("inf"), device=dev))
        else:
            bad[0, v] = (bad[0, v].view(torch.int16) + 1).view(out_dtype)
        row["table_fault_refused"] = not torch.equal(bad[chans, b], ref)
    if fl:
        ct = torch.randn(out.shape, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        (out.float() * ct).sum().backward()
        xc = x.detach().cpu().requires_grad_()
        oc = fused._augment_apply(xc, *(d.cpu() for d in draws), crop,
                                  mean, std, out_dtype)
        (oc.float() * ct.cpu()).sum().backward()
        row["grad_equal_to_cpu"] = torch.equal(x.grad.cpu(), xc.grad)
    if timed:
        xi = x.detach()
        row["ms"] = median_ms(lambda i: fused._augment_apply(
            xi, *draws, crop, mean, std, out_dtype), reps)
        row["plain_ms"] = median_ms(lambda i: fused.image_augment_ref(
            xi, *draws, crop, mean, std, out_dtype), 20)
        row["bound_ms"], row["bound_by"] = bound_ms(
            "image_augment", N=n, ch=ch, cw=cw, in_dtype=kernel_in,
            out_dtype=out_dtype, cr=cr, cout=cout)
        row["gb_per_s"] = row["bound_ms"] * HBM_BYTES_PER_S / 1e9 \
            / row["ms"]
    log(f"[io augment] {tuple(shape)}{' view' if view else ''} {row['in']}"
        f" -> {row['out']} crop {row['crop']} channels {row['channels']} "
        f"mean/std {row['mean_std']}: {launches} launch on {route} "
        f"({row['route_launches']}), bit-equal {equal} (max abs {err}), "
        f"planted flip refused {refused}"
        + (f", table emulation equal {row['table_emulation_equal']}, "
           f"table entry one ulp off refused {row['table_fault_refused']}"
           if route == "table" else "")
        + (f", gradient equal to the CPU's {row['grad_equal_to_cpu']}"
           if fl else "")
        + (f"; {row['ms']:.4f} ms against a bound of {row['bound_ms']:.4f}"
           f" ms (bytes), {row['gb_per_s']:.0f} GB/s, plain "
           f"{row['plain_ms']:.4f} ms" if timed else ""))
    assert launches == 1 and row["route_launches"] == 1, \
        f"the augment did not launch its kernel on {route}: {counts}"
    assert equal and refused, f"augment kernel against plain: {row}"
    assert route != "table" or (row["table_emulation_equal"]
                                and row["table_fault_refused"]), \
        f"augment table route: {row}"
    assert not fl or row["grad_equal_to_cpu"], "augment gradient"
    return row


# phase 15 (b)'s rows beyond the main shapes: (shape, out dtype, crop,
# keywords of check_augment); every type, channel case and route
AUGMENT_BATCH = 256
AUGMENT_ROWS = [
    *(((BATCH, IMAGE, IMAGE, 3), torch.bfloat16, None,
       dict(in_dtype=dt, timed=True))
      for dt in (torch.int8, torch.bool, torch.int16, torch.int32,
                 torch.int64)),
    ((BATCH, IMAGE, IMAGE, 1), torch.bfloat16, None, dict(timed=True)),
    ((BATCH, 256, 256, 4), torch.bfloat16, (IMAGE, IMAGE),
     dict(timed=True)),
    ((BATCH, IMAGE, IMAGE, 3), torch.bfloat16, None,
     dict(view=True, timed=True)),
    ((8, 64, 64, 5), torch.float16, None, dict(mean=(0.5,), std=(0.25,))),
    ((4, 16, 16, 1), torch.float32, None,
     dict(mean=tuple(0.01 * i for i in range(70)),
          std=tuple(0.5 + 0.01 * i for i in range(70)))),
    ((4, 12, 5000, 3), torch.bfloat16, (9, 4500), {}),
    ((2, 8, 1200, 3), torch.float32, None, dict(in_dtype=torch.float32)),
    ((2, 4, 4, 3100), torch.float32, None,
     dict(in_dtype=torch.float32, mean=(0.5,), std=None)),
    ((3, 7, 5, 3), torch.bfloat16, (5, 3), {}),
    ((3, 7, 5, 3), torch.float32, None, dict(in_dtype=torch.int16)),
]


def augment_context(dev, gen, profile):
    """(b)'s yardsticks on this card: the empty-launch floor of `median_ms`,
    PyTorch's own `copy_` of a bfloat16 tensor of the output's size at
    batch BATCH and AUGMENT_BATCH (the rate a plain copy reaches there,
    reading and writing the same bytes), and with --profile the augment
    kernel's device time at both batches (torch.profiler, no events
    around it)."""
    out = {"floor_ms": median_ms(lambda i: torch.cuda._sleep(1), 20)}
    for n in (BATCH, AUGMENT_BATCH):
        src = torch.empty((n, IMAGE, IMAGE, 3), dtype=torch.bfloat16,
                          device=dev)
        dst = torch.empty_like(src)
        ms = median_ms(lambda i: dst.copy_(src), 50)
        row = {"copy_ms": ms,
               "copy_gb_per_s": 2 * src.numel() * 2 / ms / 1e6}
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_
            x = torch.randint(0, 256, (n, IMAGE, IMAGE, 3), generator=gen,
                              dtype=torch.uint8, device=dev)
            draws = fused.augment_draws((11, 5), n, (IMAGE, IMAGE), None,
                                        True, dev)
            torch.cuda.synchronize()
            with prof_(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fused._augment_apply(x, *draws, None, IO_MEAN, IO_STD,
                                         torch.bfloat16)
                torch.cuda.synchronize()
            # the mean over the launches the profiler kept (inside this long
            # process it may keep only some of the 20)
            ev = [e for e in prof.key_averages() if "augment" in e.key]
            calls = sum(e.count for e in ev)
            row["kernel_profiled_calls"] = calls
            row["kernel_device_ms"] = sum(
                getattr(e, "device_time_total", 0) or e.cuda_time_total
                for e in ev) / 1e3 / calls if calls else None
        out[f"batch_{n}"] = row
        log(f"[io augment] batch {n}: copy_ of a bf16 tensor of the "
            f"output's size {ms:.4f} ms ({row['copy_gb_per_s']:.0f} GB/s)"
            + (f"; the augment kernel's device time "
               f"{row['kernel_device_ms']} ms (torch.profiler, "
               f"{row['kernel_profiled_calls']} launches kept)"
               if profile else ""))
    log(f"[io augment] empty-launch floor (torch.cuda._sleep(1), timed as "
        f"the kernels): {out['floor_ms']:.4f} ms")
    return out


def _io_iter(dev, **kw):
    from incubator_mxnet_tpu_torch import io as mxio
    return mxio.ImageRecordIter(kw.pop("path"), device=dev,
                                **dict(IO_ITER, **kw))


class _Probed:
    """A dataset's samples with the CUDA environment of the process that
    made them: [card hidden, CUDA context made]."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i] + (np.array(
            [os.environ.get("CUDA_VISIBLE_DEVICES") == "",
             torch.cuda.is_initialized()], np.int32),)


def loader_images():
    rng = np.random.RandomState(21)
    x = rng.randint(0, 256, (LOADER_IMAGES, LOADER_SIDE, LOADER_SIDE, 3))
    return (x.astype(np.uint8),
            rng.randint(0, CLASSES, LOADER_IMAGES).astype(np.int32))


def dataloader_check(dev):
    """(d) `DataLoader(num_workers=2)` (spawned processes) gives
    `num_workers=0`'s batches on the card, with no CUDA context in the
    workers; so does `prefetch_to_device=True` over thread workers (the
    device feed's pinned ring and side stream)."""
    from incubator_mxnet_tpu_torch.gluon import data as gdata
    ds = _Probed(gdata.ArrayDataset(*loader_images()))
    card = mx.Device("gpu", dev.index or 0)
    with card:
        want = [tuple(t.asnumpy() for t in b)
                for b in gdata.DataLoader(ds, batch_size=LOADER_BATCH)]
        t0 = time.perf_counter()
        got = [tuple(t for t in b) for b in gdata.DataLoader(
            ds, batch_size=LOADER_BATCH, num_workers=2, thread_pool=False)]
        took = time.perf_counter() - t0
        on_card = all(t._t.is_cuda for b in got for t in b)
        got = [tuple(t.asnumpy() for t in b) for b in got]
        # thread workers through the device feed (pinned ring, side stream)
        fed = [tuple(t.asnumpy() for t in b) for b in gdata.DataLoader(
            ds, batch_size=LOADER_BATCH, num_workers=2,
            prefetch_to_device=True)]
    equal = len(got) == len(want) == len(fed) and all(
        np.array_equal(a, c) for x, y, z in zip(got, want, fed)
        for a, c in zip(x[:2] + z[:2], y[:2] + y[:2]))
    hidden = all(p.tolist() == [1, 0] for b in got for p in b[2])
    log(f"[io loader] DataLoader(num_workers=2, spawned) on the card, and "
        f"with 2 threads through the device feed: {len(got)} batches each, "
        f"equal to num_workers=0's: {equal}, on the card: {on_card} "
        f"({took:.2f} s with the workers' start); the spawned workers saw "
        f"CUDA_VISIBLE_DEVICES empty and no CUDA context: {hidden}")
    assert equal and on_card and hidden, "DataLoader workers"
    return {"equal": equal, "workers_hidden": hidden, "seconds": took}


def host_throughput(path, facts):
    """(d) Decoded images/s on the host (uint8 handoff onto the CPU, so the
    card is not in it), native threads or the PIL path with workers=0, and
    min(8, cpu_count) shm workers; the first batch is the warm-up."""
    rows = {}
    for workers in (0, min(8, os.cpu_count() or 1)):
        it = _io_iter("cpu", path=path, handoff="uint8", workers=workers)
        route = it.decode_route
        b = iter(it)
        next(b)
        t0 = time.perf_counter()
        n = 0
        for _ in range(IO_HOST_BATCHES):
            n += next(b).data[0].shape[0]
        took = time.perf_counter() - t0
        it.close()
        rows[f"workers_{workers}"] = {"route": route,
                                      "images_per_s": n / took}
        log(f"[io host] workers={workers} ({route}): {n / took:.1f} decoded "
            f"images/s ({n} images of {IMAGE}^2 from ~{IO_SIDE} px JPEGs)")
    return rows


def io_profile(next_step, step_ms):
    """torch.profiler over PROFILE_STEPS fed steps: device ms a step, the
    idle share, and whether the input copies (Memcpy HtoD) overlap the
    step's kernels on the card's timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            next_step()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev_events if "HtoD" in e.name]
    kernels_ = [e for e in dev_events if "Memcpy" not in e.name
                and "Memset" not in e.name]
    busy = sum(e.time_range.end - e.time_range.start
               for e in kernels_) / 1e3 / PROFILE_STEPS
    overlapped = sum(1 for c in copies if any(
        k.time_range.start < c.time_range.end
        and c.time_range.start < k.time_range.end for k in kernels_))
    copy_ms = sum(c.time_range.end - c.time_range.start
                  for c in copies) / 1e3 / PROFILE_STEPS
    out = {"device_ms_per_step": busy, "idle_share": 1.0 - busy / step_ms,
           "h2d_copies": len(copies), "h2d_ms_per_step": copy_ms,
           "h2d_overlapping_kernels": overlapped}
    log(f"[io profile] {busy:.3f} device ms a step of {step_ms:.3f} ms "
        f"(idle {100 * out['idle_share']:.1f}%); {len(copies)} H2D copies "
        f"({copy_ms:.3f} ms a step), {overlapped} of them overlapping a "
        f"kernel")
    return out


def feed_train(card, dev, path, profile, synthetic_ms, facts,
               predecoded=False):
    """(c) ResNet-50 v1 NHWC, batch 32, bf16 AMP, phase 5's FusedTrainStep
    SGD, fed by ImageRecordIter (uint8 handoff, the augment kernel on the
    card); without a JPEG decoder, or as the control with `predecoded`
    (the same step and augment with no decode work on the host), by a
    DataLoader over seeded uint8 images through the device feed and
    npx.fused_image_augment."""
    from incubator_mxnet_tpu_torch import io as mxio
    workers = max(1, (os.cpu_count() or 1) - 2)
    tag = "io control" if predecoded else "io train"
    if predecoded or facts["decode_route"] == "none":
        if not predecoded:
            log("[io train] no JPEG decoder on this machine: (c) feeds the "
                "step from gluon.data.DataLoader over an ArrayDataset of "
                "seeded uint8 images (prefetch_to_device, "
                "npx.fused_image_augment)")
        source = predecoded_source(dev) if predecoded else \
            loader_source(dev)
        route = ("DeviceFeed over pre-decoded uint8 (no decode)"
                 if predecoded else "DataLoader")
        workers = 0
    else:
        it = _io_iter(dev, path=path, handoff="uint8", device_augment=True,
                      dtype="bfloat16", workers=workers, **IO_NORM)
        route = f"ImageRecordIter ({it.decode_route}, {workers} workers)"
        source = ((b.data[0], b.label[0]) for b in _forever(it))
    amp.init("bfloat16")
    try:
        net = vision.resnet50_v1(layout="NHWC", classes=CLASSES, device=dev,
                                 seed=0)
        step = new_step(net, BATCH, use_fusion=True)
        first = {}

        def next_step():
            x, y = next(source)
            if not first:
                first["x"] = x._t.clone()
            return step(x, y._t.reshape(-1).to(torch.int32))
        for _ in range(IO_WARMUP):
            next_step()
        torch.cuda.synchronize()
        mxio.io_stats(reset=True)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [next_step() for _ in range(IO_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        stats = mxio.io_stats()
        step_ms = wall / IO_STEPS * 1e3
        prof = io_profile(next_step, step_ms) if profile else None
    finally:
        amp.uninit()
    losses = [float(v) for v in losses]
    ips = BATCH * IO_STEPS / wall
    per_batch = {k: stats[k] / max(stats["batches"], 1)
                 for k in ("wait_us", "stage_us", "bytes_staged")}
    fed = "" if predecoded else (
        f"a batch waited {per_batch['wait_us']:.0f} us on the decoders, "
        f"staged in {per_batch['stage_us']:.0f} us, "
        f"{per_batch['bytes_staged']:.0f} bytes; ")
    log(f"[{tag}] {card}: {IO_STEPS} steps of ResNet-50 v1 (batch "
        f"{BATCH} x {IMAGE}^2, bf16 AMP, FusedTrainStep SGD) fed by {route}:"
        f" {step_ms:.3f} ms a step, {ips:.1f} images/s (phase 5's synthetic "
        f"batches in this run: {synthetic_ms:.3f} ms a step); {fed}"
        f"launches {launches} (expected {IO_STEPS} augment, "
        f"53/1/1 x {IO_STEPS} B1/B2/B3); losses "
        f"{[round(v, 3) for v in losses[:4]]}...")
    assert all(np.isfinite(losses)), "non-finite fed training loss"
    assert launches["image_augment"] == IO_STEPS, "augment launches"
    assert launches["image_augment_table"] == IO_STEPS, "augment route"
    assert launches["scale_shift_act"] == 53 * IO_STEPS \
        and launches["avg_pool2d_fwd"] == IO_STEPS \
        and launches["avg_pool2d_bwd"] == IO_STEPS, "B1/B2/B3 launches"
    del net, step
    torch.cuda.empty_cache()
    return {"route": route, "workers": workers, "step_ms": step_ms,
            "images_per_s": ips, "synthetic_step_ms": synthetic_ms,
            "io_stats": stats, "per_batch": per_batch, "launches": launches,
            "losses": losses, "profile": prof, "first": first["x"]}


def _forever(it):
    while True:
        for b in it:
            yield b
        it.reset()


def loader_source(dev):
    """(c)'s source without a JPEG decoder: seeded uint8 images through
    DataLoader(prefetch_to_device) and npx.fused_image_augment."""
    from incubator_mxnet_tpu_torch.gluon import data as gdata
    x, y = loader_images()
    x = np.resize(x, (LOADER_IMAGES, IMAGE, IMAGE, 3))
    ds = gdata.ArrayDataset(x, y)
    card = mx.Device("gpu", dev.index or 0)
    batch_no = 0
    while True:
        with card:
            loader = gdata.DataLoader(ds, batch_size=BATCH, shuffle=True,
                                      last_batch="discard", num_workers=2,
                                      prefetch_to_device=True)
            batches = list(loader)
        for u8, lab in batches:
            out = mx.npx.fused_image_augment(
                u8, (3, batch_no), mean=IO_MEAN, std=IO_STD,
                rand_mirror=True, out_dtype="bfloat16")
            batch_no += 1
            yield out, lab


def predecoded_source(dev):
    """(c)'s control: uint8 batches of (c)'s shape made once on the host (no
    decode), staged by the device feed (pinned ring, side stream) and
    augmented by npx.fused_image_augment."""
    from incubator_mxnet_tpu_torch import io as mxio
    x, y = loader_images()
    x = np.resize(x, (LOADER_IMAGES, IMAGE, IMAGE, 3))
    batches = [(x[i:i + BATCH], y[i:i + BATCH])
               for i in range(0, LOADER_IMAGES - BATCH + 1, BATCH)]

    def host():
        while True:
            yield from batches
    feed = mxio.DeviceFeed(host(), device=mx.Device("gpu", dev.index or 0))
    try:
        for batch_no, (u8, lab) in enumerate(feed):
            yield mx.npx.fused_image_augment(
                u8, (3, batch_no), mean=IO_MEAN, std=IO_STD,
                rand_mirror=True, out_dtype="bfloat16"), lab
    finally:
        feed.close()


def first_batch_check(dev, path, first):
    """(e) The first batch of (c): its host half (decoded uint8, staged to
    the card) bit-equal to a CPU ImageRecordIter's from the same file and
    seed, and on the card bit-equal to the plain augment on its draws."""
    kw = dict(path=path, handoff="uint8", rand_mirror=False)
    card_it = _io_iter(dev, **kw)
    cpu_it = _io_iter("cpu", **kw)
    u8_card = next(iter(card_it)).data[0]._t
    u8_cpu = next(iter(cpu_it)).data[0]._t
    key = card_it.augment_key(0)
    card_it.close()
    cpu_it.close()
    host_equal = torch.equal(u8_card.cpu(), u8_cpu)
    draws = fused.augment_draws(key, BATCH, (IMAGE, IMAGE), None, True, dev)
    kernels.reset_launch_counts()
    kernel_out = fused._augment_apply(u8_card, *draws, None, IO_MEAN, IO_STD,
                                      torch.bfloat16)
    plain = fused.image_augment_ref(u8_card, *draws, None, IO_MEAN, IO_STD,
                                    torch.bfloat16)
    torch.cuda.synchronize()
    equal = torch.equal(first, kernel_out) and torch.equal(kernel_out, plain)
    log(f"[io first batch] host half bit-equal to the CPU iterator's: "
        f"{host_equal}; the fed batch bit-equal to the kernel and to the "
        f"plain augment on the same draws: {equal}")
    assert host_equal and equal, "(e) first batch"
    return {"host_equal": host_equal, "card_equal": equal,
            "max_abs_err": float((kernel_out.float()
                                  - plain.float()).abs().max())}


def phase_input(card, dev, profile, synthetic_ms):
    """Phase 15: the input path."""
    import tempfile
    t0 = time.perf_counter()
    facts = host_facts()
    gen = torch.Generator(device=dev).manual_seed(15)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.rec")
        records = write_records(path, facts)
        aug = [check_augment(dev, gen, (BATCH, IMAGE, IMAGE, 3), dt, None,
                             timed=True)
               for dt in (torch.bfloat16, torch.float32, torch.float16)]
        aug.append(check_augment(dev, gen, (BATCH, 256, 256, 3),
                                 torch.bfloat16, (IMAGE, IMAGE), timed=True))
        aug.append(check_augment(dev, gen, (8, 64, 64, 3), torch.float32,
                                 (56, 48), fl=True))
        aug.append(check_augment(dev, gen, (AUGMENT_BATCH, IMAGE, IMAGE, 3),
                                 torch.bfloat16, None, timed=True))
        aug += [check_augment(dev, gen, shape, dt, crop, **kw)
                for shape, dt, crop, kw in AUGMENT_ROWS]
        routes = {r["route"] for r in aug}
        assert routes == {"table", "direct", "scalar"}, routes
        aug_context = augment_context(dev, gen, profile)
        train = feed_train(card, dev, path, profile, synthetic_ms, facts)
        first = first_batch_check(dev, path, train.pop("first")) \
            if facts["decode_route"] != "none" else None
        # the same step fed with no decode work on the host: parts the
        # decoders' share of (c)'s time from the feed's and the augment's
        control = feed_train(card, dev, path, False, synthetic_ms, facts,
                             predecoded=True) \
            if facts["decode_route"] != "none" else None
        if control:
            control.pop("first")
        host = host_throughput(path, facts) \
            if facts["decode_route"] != "none" else None
        loader = dataloader_check(dev)
    took = time.perf_counter() - t0
    log(f"[io] phase 15 took {took:.1f} s")
    return {"facts": facts, "records": records, "augment": aug,
            "augment_context": aug_context,
            "train": train, "control": control, "first_batch": first,
            "host": host,
            "loader": loader, "seconds": took}


def augment_entry(io):
    head = io["augment"][0]
    return {"name": "image_augment", "route": "cuda",
            "source": "incubator_mxnet_tpu_torch/ops/csrc/image_augment.cu",
            "replaces": "none (port-only; ops/fused.py:500)",
            "launches": io["train"]["launches"]["image_augment"],
            "route_launches": {
                r: io["train"]["launches"][f"image_augment_{r}"]
                for r in ("table", "direct", "scalar")},
            "max_abs_err": max(r["max_abs_err"] for r in io["augment"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "shape": f"N={BATCH} {IMAGE}x{IMAGE}x3 uint8 -> bfloat16, "
                     f"mirror, ImageNet mean/std (no PyTorch call computes "
                     f"crop, mirror, normalize and cast in one)",
            "context": io["augment_context"],
            "variants": [{k: v for k, v in r.items()} for r in io["augment"]]}


def npx_launches(entry, array):
    """An entry's launches through NDArray / npx in phase 14: its counter's,
    a float16 instance's by its dtype."""
    name = entry["name"]
    if name.endswith("_float16"):
        base = name[:-len("_float16")]
        key = "paged_attention_q" if base == "paged_attention" else base
        return sum(v for k, v in array["npx_launches_by_dtype"].items()
                   if k == f"{key}:float16")
    return array["npx_launches"].get(name, 0)


# ---------------------------------------------------------------------------
# phase 16: crash-consistent training (fault, checkpoint, run_resilient)
# ---------------------------------------------------------------------------
LM_BATCH, LM_SEQ = 8, 2048                # (a)'s batch: 8 x 2048 tokens
LM_WARMUP, LM_STEPS = 3, 10
LM_CHECK = dict(num_layers=2, batch=2, seq=512)   # (a)'s float32 check
RES_LAYERS, RES_STEPS, RES_EVERY = 2, 10, 3        # (b): depth cut to 2
CRASH_ARGS = ["--steps", "8", "--ckpt-every", "3", "--kill-at", "7",
              "--lm-layers", str(RES_LAYERS), "--lm-batch", "2"]
SERVE_LAYERS = 2                                   # (d): depth cut to 2
SERVE_PROMPTS, SERVE_NEW = 6, 16
FAULT_RECORDS, FAULT_WORKERS = 256, 4              # (e)


def _lm_tokens(seed, batch, seq, vocab, dev):
    r = np.random.RandomState(seed)
    return torch.from_numpy(r.randint(0, vocab, (batch, seq + 1))
                            .astype(np.int32)).to(dev)


def _det_on():
    """TF32 off, deterministic cuDNN and algorithms (warnings only where an
    op has no deterministic form); returns the previous settings."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    return prev


def _det_off(prev):
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = prev[:4]
    torch.use_deterministic_algorithms(prev[4])


def _trees_equal(a, b):
    """True when two trees of tensors / numpy arrays are bit-equal."""
    from incubator_mxnet_tpu_torch.models import transformer as tf
    la, lb = tf._leaves(a), tf._leaves(b)
    return len(la) == len(lb) and all(
        (torch.equal(x, y) if isinstance(x, torch.Tensor)
         else np.array_equal(x, y)) for x, y in zip(la, lb))


def lm_full_step(card, dev, profile):
    """(a) The flagship LM's AdamW step at full width (TransformerConfig()
    defaults: vocab 32000, 12 x 768, 12 x 64 heads, d_ff 3072, bf16 compute,
    float32 masters, tied embeddings), batch 8 x 2048, on one fixed batch:
    3 warm-up and 10 timed steps; the loss must fall."""
    from incubator_mxnet_tpu_torch.models import transformer as tf
    cfg = tf.TransformerConfig()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = tf.init_params(0, cfg, device=dev)
    opt = tf.init_opt_state(params)
    n_params = sum(t.numel() for t in tf._leaves(params))
    step = tf.make_train_step(cfg)
    tokens = _lm_tokens(16, LM_BATCH, LM_SEQ, cfg.vocab_size, dev)
    state = {"p": params, "o": opt, "i": 0}
    del params, opt

    def run(tok):
        state["p"], state["o"], loss = step(state["p"], state["o"],
                                            {"tokens": tok}, state["i"])
        state["i"] += 1
        return loss

    losses = [run(tokens) for _ in range(LM_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses += [run(tokens) for _ in range(LM_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = wall / LM_STEPS * 1e3
    prof = profile_steps(run, [(tokens,)], step_ms, {}, "lm") \
        if profile else None
    losses = [float(v) for v in losses]
    tok_s = LM_BATCH * LM_SEQ * LM_STEPS / wall
    log(f"[resilient lm] {card}: TransformerConfig() ({n_params} params, "
        f"bf16 compute, float32 masters), batch {LM_BATCH} x {LM_SEQ}: "
        f"{step_ms:.3f} ms a step, {tok_s:.0f} tokens/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; losses {[round(v, 4) for v in losses]}")
    assert all(np.isfinite(losses)), "non-finite LM loss"
    assert losses[-1] < losses[0], "the LM loss did not fall"
    del state
    torch.cuda.empty_cache()
    check = lm_f32_check(dev)
    return {"params": n_params, "batch": LM_BATCH, "seq": LM_SEQ,
            "step_ms": step_ms, "tokens_per_s": tok_s,
            "peak_bytes": peak, "losses": losses, "profile": prof,
            "f32_check": check}


def plain_adamw_step(cfg, params, opt, batch, step, lr=3e-4, wd=0.01,
                     b1=0.9, b2=0.95, eps=1e-8):
    """The plain composition: `loss_fn`, torch.autograd.grad, then AdamW
    leaf by leaf in per-tensor ops (no multi-tensor kernels)."""
    from incubator_mxnet_tpu_torch.models import transformer as tf
    leaves = [p.detach().requires_grad_(True) for p in tf._leaves(params)]
    loss = tf.loss_fn(tf._unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    t = torch.tensor(float(step + 1), device=loss.device)
    bc1 = 1 - torch.tensor(b1, device=loss.device) ** t
    bc2 = 1 - torch.tensor(b2, device=loss.device) ** t
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(tf._leaves(params), grads, tf._leaves(opt[0]),
                          tf._leaves(opt[1])):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        new_p.append(p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                               + wd * p))
        new_m.append(m)
        new_v.append(v)
    return (tf._unflatten(params, new_p), (tf._unflatten(params, new_m),
                                           tf._unflatten(params, new_v)),
            loss.detach())


def lm_f32_check(dev):
    """(a) A float32 step of `make_train_step` against the plain
    composition of the same functions on the card (TF32 off; 2 layers at
    full width, batch 2 x 512): the same loss, params and moments within
    1e-6 of each leaf's norm."""
    from incubator_mxnet_tpu_torch.models import transformer as tf
    cfg = tf.TransformerConfig(num_layers=LM_CHECK["num_layers"],
                               dtype="float32")
    params = tf.init_params(1, cfg, device=dev)
    opt = tf.init_opt_state(params)
    batch = {"tokens": _lm_tokens(17, LM_CHECK["batch"], LM_CHECK["seq"],
                                  cfg.vocab_size, dev)}
    p1, o1, l1 = tf.make_train_step(cfg)(params, opt, batch, 0)
    p2, o2, l2 = plain_adamw_step(cfg, params, opt, batch, 0)
    worst = 0.0
    for a, b in zip(tf._leaves((p1, o1)), tf._leaves((p2, o2))):
        worst = max(worst, float((a - b).norm() / b.norm().clamp_min(
            1e-30)))
    log(f"[resilient lm f32] make_train_step against the plain composition"
        f" (2 layers, batch {LM_CHECK['batch']} x {LM_CHECK['seq']}, "
        f"float32, TF32 off): losses {float(l1):.6f} / {float(l2):.6f}, "
        f"worst leaf ||diff|| / ||plain|| {worst:.3g} (limit 1e-6)")
    assert float(l1) == float(l2) and worst <= 1e-6, "(a) float32 check"
    del params, opt, p1, o1, p2, o2
    torch.cuda.empty_cache()
    return {"loss": float(l1), "worst_norm_rel": worst}


def _lm_resilient_parts(dev):
    from incubator_mxnet_tpu_torch.models import transformer as tf
    cfg = tf.TransformerConfig(num_layers=RES_LAYERS)
    train = tf.make_train_step(cfg)
    batches = {}

    def step_fn(state, i):
        if i not in batches:
            batches[i] = _lm_tokens(1000 + i, LM_BATCH, LM_SEQ,
                                    cfg.vocab_size, dev)
        p, (m, v), loss = train(state["params"], (state["mu"], state["nu"]),
                                {"tokens": batches[i]}, i)
        return {"params": p, "mu": m, "nu": v}, loss

    def init():
        params = tf.init_params(2, cfg, device=dev)
        mu, nu = tf.init_opt_state(params)
        return {"params": params, "mu": mu, "nu": nu}
    return cfg, step_fn, init


def lm_resilient(card, dev, root):
    """(b) run_resilient over (a)'s step at full width, depth cut to 2,
    ckpt_every 3, TF32 off, deterministic algorithms: an injected error and
    a resume, the skip, the retry, the watchdog, and real SIGKILLs through
    tools/torch_crashtest.py."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    from incubator_mxnet_tpu_torch import fault
    cfg, step_fn, init = _lm_resilient_parts(dev)
    saves = []
    real_save = ckpt.save_sharded

    def timed_save(directory, tree, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = real_save(directory, tree, **kw)
        took = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        saves.append((took, size))
        return path
    ckpt.save_sharded = timed_save
    out = {}
    try:
        fault.clear()
        t0 = time.perf_counter()
        ref_dir = os.path.join(root, "ref")
        ref = fault.run_resilient(step_fn, init(), ref_dir, RES_STEPS,
                                  ckpt_every=RES_EVERY)
        torch.cuda.synchronize()
        out["ref_s"] = time.perf_counter() - t0
        # an injected error at the 6th step, then a resume
        d = os.path.join(root, "crash")
        fault.install("resilient.step", "error", at=6)
        try:
            fault.run_resilient(step_fn, init(), d, RES_STEPS,
                                ckpt_every=RES_EVERY, max_step_retries=0)
            raise AssertionError("the injected error did not surface")
        except fault.InjectedFault:
            pass
        fault.clear()
        latest = ckpt.latest_step(d)
        res = fault.run_resilient(step_fn, init(), d, RES_STEPS,
                                  ckpt_every=RES_EVERY)
        equal = _trees_equal(res.state, ref.state)
        out["resume"] = {"latest_after_crash": latest,
                         "resumed_from": res.resumed_from,
                         "bit_equal": equal}
        log(f"[resilient lm] resilient.step:6:error: latest committed step "
            f"{latest}, resumed from {res.resumed_from}; params and both "
            f"Adam moments bit-equal to the uninterrupted run: {equal}")
        assert latest == 3 and res.resumed_from == 3 and equal, "(b) resume"
        del res
        shutil.rmtree(d)
        # the skip: step 1's loss poisoned; the state equals steps 0, 2, 3
        fault.install("resilient.loss", "nan", at=2)
        skip = fault.run_resilient(step_fn, init(), os.path.join(root, "s"),
                                   4, ckpt_every=100)
        fault.clear()
        st = init()
        for i in (0, 2, 3):
            st, _ = step_fn(st, i)
        skip_equal = _trees_equal(skip.state, st)
        out["skip"] = {"skipped_nonfinite": skip.skipped_nonfinite,
                       "bit_equal": skip_equal}
        log(f"[resilient lm] resilient.loss:2:nan: skipped_nonfinite "
            f"{skip.skipped_nonfinite}, state bit-equal to steps 0, 2, 3: "
            f"{skip_equal}")
        assert skip.skipped_nonfinite == 1 and skip_equal, "(b) skip"
        del skip, st
        # the retry: an IOError at the 4th step is retried once; the state
        # after 6 steps equals the uninterrupted run's step-6 checkpoint
        fault.install("resilient.step", "ioerror", at=4)
        rt = fault.run_resilient(step_fn, init(), os.path.join(root, "r"),
                                 6, ckpt_every=100, retry_backoff=0.001)
        fault.clear()
        ref6, _ = ckpt.load_sharded(ref_dir, step=6, target=rt.state)
        retry_equal = _trees_equal(rt.state, ref6)
        out["retry"] = {"step_retries": rt.step_retries,
                        "bit_equal": retry_equal}
        log(f"[resilient lm] resilient.step:4:ioerror: step_retries "
            f"{rt.step_retries}, state bit-equal to the uninterrupted "
            f"run's step 6: {retry_equal}")
        assert rt.step_retries == 1 and retry_equal, "(b) retry"
        del rt, ref6, ref
        # the watchdog: a 30 s stall at the 5th step under a 2 s watchdog
        fault.install("resilient.step", "stall", at=5, arg=30)
        t0 = time.perf_counter()
        fired_after = None
        try:
            fault.run_resilient(step_fn, init(), os.path.join(root, "w"), 6,
                                ckpt_every=100, watchdog_seconds=2,
                                max_step_retries=0)
        except fault.WatchdogTimeout:
            fired_after = time.perf_counter() - t0
        fault.clear()
        out["watchdog_s"] = fired_after
        log(f"[resilient lm] resilient.step:5:stall:30 under a 2 s watchdog:"
            f" WatchdogTimeout after {fired_after} s (4 steps, then the "
            f"stall)")
        assert fired_after is not None and fired_after < 10, "(b) watchdog"
    finally:
        ckpt.save_sharded = real_save
        fault.clear()
    out["saves"] = [{"seconds": s, "bytes": b} for s, b in saves]
    log(f"[resilient lm] {len(saves)} saves of the 2-layer state (params, "
        f"mu, nu): {saves[0][1] / 2 ** 20:.1f} MiB each, seconds "
        f"{[round(s, 3) for s, _ in saves]}")
    for sub in os.listdir(root):        # ~0.5 GB a save: free the disk
        shutil.rmtree(os.path.join(root, sub))
    torch.cuda.empty_cache()
    return out


def crashtest_start(root):
    """(b) 3. A real SIGKILL through tools/torch_crashtest.py at the LM's
    full width (depth 2, batch 2 x 2048): at the 7th step and inside the
    2nd save; each resumed in a fresh process, bit-equal. Started here, its
    processes run beside (b)-(e) in this one (they share nothing but the
    card and the disk); `crashtest_wait` collects them."""
    d = os.path.join(root, "crashtest")
    rec = os.path.join(root, "crashtest.json")
    cmd = [sys.executable, os.path.join("tools", "torch_crashtest.py"),
           "--device", "cuda", "--model", "lm", "--dir", d, "--json", rec,
           "--lm-vocab", "32000", "--lm-d", "768", "--lm-heads", "12",
           "--lm-ff", "3072", "--lm-seq", str(LM_SEQ),
           "--lm-dtype", "bfloat16"] + CRASH_ARGS
    env = {k: v for k, v in os.environ.items() if k != "MXNET_FAULT_SPEC"}
    # a session of its own: its children go with it if it is stopped
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    return proc, cmd, rec, d, time.perf_counter()


def crashtest_wait(started, ok=True):
    """The crash test's result; with `ok` False (a part beside it failed)
    its processes are stopped instead."""
    proc, cmd, rec, d, t0 = started
    if not ok:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        return None
    stdout, stderr = proc.communicate(timeout=400)
    took = time.perf_counter() - t0
    for line in stdout.splitlines():
        log(f"[resilient crashtest] {line}")
    if proc.returncode != 0:
        print(stderr[-4000:], file=sys.stderr)
    assert proc.returncode == 0 and "parity OK" in stdout, \
        "(b) torch_crashtest.py"
    with open(rec) as f:
        records = json.load(f)
    shutil.rmtree(d, ignore_errors=True)
    log(f"[resilient crashtest] {' '.join(cmd[1:])}: {took:.1f} s from its "
        f"start, beside (b)-(e)")
    return {"seconds": took, "records": records}


def resnet_resume(card, dev):
    """(c) Phase 11 (b)'s ResNet-50 v1 loop (NHWC, batch 32 x 224^2, bf16
    AMP, NAG + cosine through gluon.Trainer): 6 steps uninterrupted against
    3 steps, save_checkpoint(net, trainer=), a fresh net and Trainer
    through load_checkpoint(net=, trainer=), then 3 more; deterministic."""
    import tempfile
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    from incubator_mxnet_tpu_torch import optimizer as opt_mod
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b)
               for b in make_batches(2, BATCH, seed=41)]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def build(seed):
        net = vision.resnet50_v1(layout="NHWC", classes=CLASSES, device=dev,
                                 seed=seed)
        tr = gluon.Trainer(net.collect_params(), "nag", dict(
            NAG, lr_scheduler=lr_scheduler.CosineScheduler(**COSINE)))
        return net, tr

    def steps(net, tr, first, last):
        for i in range(first, last):
            loop_step(net, tr, loss_fn, *batches[i % 2])
        torch.cuda.synchronize()

    def states(tr):
        return [opt_mod.state_to_numpy(s) for s in tr._states]

    prev = _det_on()
    amp.init("bfloat16")
    fprev = fused.set_fusion_default(True)
    try:
        net_a, tr_a = build(0)
        kernels.reset_launch_counts()
        steps(net_a, tr_a, 0, 6)
        launches_a = kernels.launch_counts()
        net_b, tr_b = build(0)
        steps(net_b, tr_b, 0, 3)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "resnet")
            t0 = time.perf_counter()
            path = ckpt.save_checkpoint(path, net_b, step=3, trainer=tr_b)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path) + os.path.getsize(path + ".trainer")
            del net_b, tr_b
            net_c, tr_c = build(7)
            t0 = time.perf_counter()
            _, step = ckpt.load_checkpoint(path, net=net_c, trainer=tr_c,
                                           as_numpy=True)
            load_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        steps(net_c, tr_c, 3, 6)
        launches_c = kernels.launch_counts()
        pa, pc = net_a.collect_params(), net_c.collect_params()
        parted = [n for n in pa if not torch.equal(pa[n].data(),
                                                   pc[n].data())]
        sa, sc = states(tr_a), states(tr_c)
        states_equal = len(sa) == len(sc) and all(
            _trees_equal(x, y) for x, y in zip(sa, sc))
        updates = (tr_a.optimizer.num_update, tr_c.optimizer.num_update)
    finally:
        fused.set_fusion_default(fprev)
        amp.uninit()
        _det_off(prev)
    log(f"[resilient resnet] {card}: 6 steps against 3 + save + load into a "
        f"fresh net and Trainer + 3 (step {step}); checkpoint "
        f"{size / 2 ** 20:.1f} MiB saved in {save_s:.3f} s, loaded in "
        f"{load_s:.3f} s; values parted {len(parted)} of {len(pa)} "
        f"{parted[:3]}; optimizer states equal {states_equal}; num_update "
        f"{updates}; B1/B2/B3 launches uninterrupted {_b123(launches_a)}, "
        f"resumed {_b123(launches_c)} (expected 53/1/1 a step)")
    assert step == 3 and not parted and states_equal \
        and updates == (6, 6), "(c) resumed ResNet-50 not bit-equal"
    for launches, n in ((launches_a, 6), (launches_c, 3)):
        assert launches["scale_shift_act"] == 53 * n \
            and launches["avg_pool2d_fwd"] == n \
            and launches["avg_pool2d_bwd"] == n, "(c) B1/B2/B3 launches"
    del net_a, net_c, tr_a, tr_c
    torch.cuda.empty_cache()
    return {"parted": parted, "values": len(pa),
            "states_equal": states_equal, "num_update": updates,
            "save_s": save_s, "load_s": load_s, "bytes": size,
            "launches": launches_c, "launches_uninterrupted": launches_a}


def _b123(launches):
    return "/".join(str(launches[n]) for n in ("scale_shift_act",
                                                "avg_pool2d_fwd",
                                                "avg_pool2d_bwd"))


def serve_faults(card):
    """(d) Phase 3's engine (flagship width, random weights, depth cut to
    2) under faults: serve.execute:3:error fails the third request's wave
    and the engine serves the next ones token-equal to a clean engine;
    serve.enqueue:1:ioerror fails one submit and nothing else."""
    from incubator_mxnet_tpu_torch import fault
    cfg = serve.DecoderConfig(**dict(FULL, layers=SERVE_LAYERS),
                              dtype="bfloat16")
    model = serve.CachedDecoder(cfg, seed=0)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, FULL["vocab"], size=int(n)).tolist()
               for n in np.linspace(16, WINDOW - 16, SERVE_PROMPTS)]

    def one_by_one(spec):
        outs = []
        with serve.ContinuousEngine(model, max_slots=SLOTS,
                                    prefill_window=WINDOW,
                                    decode_steps=DECODE_STEPS) as eng:
            with fault.scope(spec):
                for p in prompts:
                    try:
                        outs.append(eng.submit(p, SERVE_NEW)
                                    .result(timeout=120))
                    except Exception as e:
                        outs.append(e)
                hits = fault.hits("serve.execute")
            st = eng.stats()
        return outs, hits, st

    clean, _, _ = one_by_one("")
    kernels.reset_launch_counts()
    got, hits, st = one_by_one("serve.execute:3:error")
    launches = kernels.launch_counts()
    failed = [i for i, o in enumerate(got) if isinstance(o, Exception)]
    same = [i for i, o in enumerate(got) if not isinstance(o, Exception)
            and np.array_equal(o, clean[i])]
    log(f"[resilient serve] {card}: {len(prompts)} requests one at a time, "
        f"serve.execute:3:error: {hits} execute hits, request(s) {failed} "
        f"failed ({type(got[2]).__name__}: {got[2]}), {len(same)} of "
        f"{len(prompts) - len(failed)} others token-equal to a clean "
        f"engine; errors {st['errors']}; paged_attention launches "
        f"{launches['paged_attention']}")
    assert failed == [2] and isinstance(got[2], fault.InjectedFault) \
        and len(same) == len(prompts) - 1, "(d) serve.execute"
    assert launches["paged_attention"] > 0, "(d) B4 did not launch"
    with serve.ContinuousEngine(model, max_slots=SLOTS,
                                prefill_window=WINDOW,
                                decode_steps=DECODE_STEPS) as eng:
        with fault.scope("serve.enqueue:1:ioerror"):
            try:
                eng.submit(prompts[0], SERVE_NEW)
                raise AssertionError("serve.enqueue did not fail")
            except IOError:
                pass
            outs = [eng.submit(p, SERVE_NEW).result(timeout=120)
                    for p in prompts[:2]]
        errors = eng.stats()["errors"]
    enq_ok = errors == 0 and all(np.array_equal(o, c)
                                 for o, c in zip(outs, clean))
    log(f"[resilient serve] serve.enqueue:1:ioerror: the first submit "
        f"raised IOError, the next {len(outs)} served token-equal: "
        f"{enq_ok}")
    assert enq_ok, "(d) serve.enqueue"
    del model
    torch.cuda.empty_cache()
    return {"failed": failed, "token_equal": len(same), "hits": hits,
            "launches": launches, "enqueue_ok": enq_ok}


def input_faults(card, dev, facts):
    """(e) Phase 15's ImageRecordIter (shm workers, uint8 handoff, the
    augment kernel) with io.imagerec:2:ioerror and DeviceFeed with
    io.device_feed:2:ioerror: batches bit-equal to a clean epoch, the
    restarts counted; a persistent rule raises the original error."""
    import tempfile
    from incubator_mxnet_tpu_torch import fault
    from incubator_mxnet_tpu_torch import io as mxio
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "faults.rec")
        w = recordio_writer(path, facts)
        kw = dict(path=path, handoff="uint8", device_augment=True,
                  dtype="bfloat16", workers=FAULT_WORKERS, max_restarts=2,
                  **IO_NORM)

        def epoch():
            it = _io_iter(dev, **kw)
            try:
                return [(b.data[0]._t.clone(), b.label[0]._t.clone())
                        for b in it]
            finally:
                it.close()

        kernels.reset_launch_counts()
        clean = epoch()
        clean_launches = kernels.launch_counts()["image_augment"]
        mxio.io_stats(reset=True)
        kernels.reset_launch_counts()
        with fault.scope("io.imagerec:2:ioerror"):
            got = epoch()
        launches = kernels.launch_counts()["image_augment"]
        restarts = mxio.io_stats()["submit_restarts"]
        equal = len(got) == len(clean) and all(
            torch.equal(a, c) and torch.equal(b, d)
            for (a, b), (c, d) in zip(got, clean))
        with fault.scope("io.imagerec:2+:ioerror"):
            try:
                epoch()
                raised = None
            except IOError as e:
                raised = str(e)
        out["imagerec"] = {"batches": len(got), "bit_equal": equal,
                           "submit_restarts": restarts,
                           "launches": launches,
                           "persistent_raised": raised,
                           "records": w}
        log(f"[resilient io] {card}: ImageRecordIter ({FAULT_RECORDS} "
            f"records, {FAULT_WORKERS} workers) with io.imagerec:2:ioerror: "
            f"{len(got)} batches bit-equal to a clean epoch: {equal}; "
            f"submit_restarts {restarts}; augment launches {launches} "
            f"(clean {clean_launches}); io.imagerec:2+ raised: {raised}")
        assert equal and restarts == 1 and launches == len(got) \
            and clean_launches == len(clean) \
            and raised and "io.imagerec" in raised, "(e) ImageRecordIter"
    x, y = loader_images()
    x = np.resize(x, (LOADER_IMAGES, IMAGE, IMAGE, 3))
    host = [(x[i:i + BATCH], y[i:i + BATCH])
            for i in range(0, LOADER_IMAGES - BATCH + 1, BATCH)] * 2
    card_dev = mx.Device("gpu", dev.index or 0)

    def fed():
        feed = mxio.DeviceFeed(list(host), device=card_dev, max_restarts=2)
        try:
            return [(mx.npx.fused_image_augment(
                u8, (3, n), mean=IO_MEAN, std=IO_STD, rand_mirror=True,
                out_dtype="bfloat16")._t.clone(), lab._t.clone())
                for n, (u8, lab) in enumerate(feed)]
        finally:
            feed.close()

    clean = fed()
    mxio.feed_stats(reset=True)
    kernels.reset_launch_counts()
    with fault.scope("io.device_feed:2:ioerror"):
        got = fed()
    launches = kernels.launch_counts()["image_augment"]
    restarts = mxio.feed_stats()["restarts"]
    equal = len(got) == len(clean) == len(host) and all(
        torch.equal(a, c) and torch.equal(b, d)
        for (a, b), (c, d) in zip(got, clean))
    with fault.scope("io.device_feed:2+:ioerror"):
        try:
            fed()
            raised = None
        except IOError as e:
            raised = str(e)
    out["device_feed"] = {"batches": len(got), "bit_equal": equal,
                          "restarts": restarts, "launches": launches,
                          "persistent_raised": raised}
    log(f"[resilient io] DeviceFeed with io.device_feed:2:ioerror: "
        f"{len(got)} batches (augmented on the card) bit-equal to a clean "
        f"pass: {equal}; restarts {restarts}; augment launches {launches}; "
        f"io.device_feed:2+ raised: {raised}")
    assert equal and restarts == 1 and launches == len(got) \
        and raised and "io.device_feed" in raised, "(e) DeviceFeed"
    return out


def recordio_writer(path, facts):
    """FAULT_RECORDS records as phase 15 (a) writes them."""
    from incubator_mxnet_tpu_torch import recordio
    t0 = time.perf_counter()
    w = recordio.MXRecordIO(path, "w")
    if facts["PIL"]:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            jpegs = list(pool.map(_jpeg_record, range(FAULT_RECORDS)))
    else:
        r = recordio.MXRecordIO(os.path.join("tests", "data",
                                             "tiny_imagerec.rec"), "r")
        payloads = []
        while (rec := r.read()) is not None:
            payloads.append(recordio.unpack(rec)[1])
        r.close()
        jpegs = [payloads[i % len(payloads)] for i in range(FAULT_RECORDS)]
    for i, jpeg in enumerate(jpegs):
        w.write(recordio.pack(recordio.IRHeader(0, float(i % CLASSES), i, 0),
                              jpeg))
    w.close()
    return {"records": FAULT_RECORDS, "seconds": time.perf_counter() - t0}


def phase_resilient(card, dev, profile):
    """Phase 16: crash-consistent training."""
    import tempfile
    t0 = time.perf_counter()
    lm = lm_full_step(card, dev, profile)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as crash_root:
        crash = crashtest_start(crash_root)
        ok = False
        try:
            with tempfile.TemporaryDirectory() as root:
                prev = _det_on()
                try:
                    resilient = lm_resilient(card, dev, root)
                finally:
                    _det_off(prev)
            resnet = resnet_resume(card, dev)
            served = serve_faults(card)
            inputs = input_faults(card, dev, host_facts())
            ok = True
        finally:
            resilient_crash = crashtest_wait(crash, ok)
    resilient["crashtest"] = resilient_crash
    took = time.perf_counter() - t0
    log(f"[resilient] phase 16 took {took:.1f} s")
    return {"lm": lm, "resilient": resilient, "resnet": resnet,
            "serve": served, "io": inputs, "seconds": took}


# phase 17: export + Server over ResNet-50, and a two-replica Fleet
DEPLOY_BUCKETS = (1, 8, 32)
DEPLOY_REQUESTS, DEPLOY_CLIENTS = 96, 8
DEPLOY_TIMEOUT_MS = 5.0       # the Server's batch timeout
# a bf16 reply against the eager bf16 forward of its image at batch 1:
# each logit within DEPLOY_BF16_STEPS bfloat16 steps (2^-8) of the image's
# largest |logit| (the bucket programs run other convolution algorithms
# than batch 1, over 53 rounded layers); a float32 reply (TF32 off) within
# DEPLOY_F32_RTOL of the largest |logit|
DEPLOY_BF16_STEPS = 8
DEPLOY_F32_RTOL = 1e-4
B1_PER_BATCH, B2_PER_BATCH = 53, 1
# programs a later phase reuses: phase 17's bfloat16 bucket-32 ResNet-50
LIVE = {}
FLEET_REPLICAS, FLEET_NEW = 2, 8
FLEET_LOAD_NEW = 4            # the requests of the swap's background load


def _artifact_bytes(prefix):
    return {ext: os.path.getsize(f"{prefix}{ext}")
            for ext in (".pt2", ".params.npz", ".deploy.json")}


def export_buckets(net, root, tag, dtype_name, dev):
    """(a) `BucketedModel.export_block` of `net` at each bucket (timed one
    bucket at a time), each bucket's graph holding 53 B1 and 1 B2 nodes."""
    models, rows = {}, []
    for b in DEPLOY_BUCKETS:
        t0 = time.perf_counter()
        one = serve.BucketedModel.export_block(
            net, (IMAGE, IMAGE, 3), (b,), root, name=tag,
            dtype="float32", device=dev)
        took = time.perf_counter() - t0
        m = one.model(b)
        nodes = [str(n.target) for n in m.lowered().graph.nodes]
        n_b1 = sum("mxtorch.scale_shift_act" in n for n in nodes)
        n_b2 = sum("mxtorch.avg_pool2d_fwd" in n for n in nodes)
        size = _artifact_bytes(os.path.join(root, f"{tag}-b{b}-0000"))
        log(f"[deploy {dtype_name}] export bucket {b}: {took:.2f} s, "
            f"{len(nodes)} nodes ({n_b1} scale_shift_act, {n_b2} "
            f"avg_pool2d_fwd), artifacts {size} bytes")
        assert (n_b1, n_b2) == (B1_PER_BATCH, B2_PER_BATCH), \
            f"bucket {b}: {n_b1} B1 / {n_b2} B2 nodes"
        kernels.reset_launch_counts()
        x = np.random.RandomState(b).rand(b, IMAGE, IMAGE, 3) \
            .astype(np.float32)
        out = m.run(x)
        launches = kernels.launch_counts()
        assert out.shape == (b, CLASSES) and np.isfinite(out).all()
        assert launches["scale_shift_act"] == B1_PER_BATCH \
            and launches["avg_pool2d_fwd"] == B2_PER_BATCH \
            and launches["avg_pool2d_bwd"] == 0, \
            f"bucket {b} launches {_b123(launches)}"
        models[b] = m
        if b == BATCH and dtype_name == "bfloat16":
            LIVE["deploy_b32"] = m       # phase 19 inspects it
        rows.append({"bucket": b, "export_s": took, "nodes": len(nodes),
                     "b1_nodes": n_b1, "b2_nodes": n_b2, "bytes": size})
    return serve.BucketedModel(models), rows


def serve_images(card, model, net, dtype_name, infer_ms, dev):
    """(b) 8 client threads submit 96 single images (each its 12 at once,
    then wait); every reply against the eager forward of its image."""
    rng = np.random.RandomState(17)
    images = rng.rand(DEPLOY_REQUESTS, IMAGE, IMAGE, 3).astype(np.float32)
    per = DEPLOY_REQUESTS // DEPLOY_CLIENTS
    replies = [None] * DEPLOY_REQUESTS
    srv = serve.Server(model, batch_timeout_ms=DEPLOY_TIMEOUT_MS,
                       max_queue=DEPLOY_REQUESTS,
                       name=f"resnet50-{dtype_name}").start()
    errors = []

    def client(c):
        try:
            idx = range(c * per, (c + 1) * per)
            futs = [(i, srv.submit(images[i])) for i in idx]
            for i, f in futs:
                replies[i] = f.result(timeout=300)
        except Exception as e:              # noqa: BLE001 - re-raised
            errors.append(e)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(DEPLOY_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    srv.close()
    st = srv.stats()
    assert not errors, f"(b) {dtype_name}: {errors[:3]}"
    assert all(r is not None for r in replies), "(b) a request unanswered"
    assert launches["scale_shift_act"] == B1_PER_BATCH * st["batches"] \
        and launches["avg_pool2d_fwd"] == B2_PER_BATCH * st["batches"], \
        f"(b) launches {_b123(launches)} over {st['batches']} batches"
    worst = 0.0
    with torch.no_grad():
        for i in range(DEPLOY_REQUESTS):
            ref = net(torch.from_numpy(images[i:i + 1]).to(dev)).float()
            ref = ref.cpu().numpy()[0]
            err = float(np.abs(replies[i] - ref).max())
            worst = max(worst, err / float(np.abs(ref).max()))
    limit = DEPLOY_BF16_STEPS * 2.0 ** -8 if dtype_name == "bfloat16" \
        else DEPLOY_F32_RTOL
    # where a batch's time goes: the bucket-32 program alone (numpy in and
    # out, so it ends synchronised) against the eager forward on the card
    top = DEPLOY_BUCKETS[-1]
    batch = images[np.arange(top) % len(images)]
    xb = torch.from_numpy(batch).to(dev)
    program_ms = host_median_ms(lambda: model.run_batch(top, [batch]))
    with torch.no_grad():
        eager_ms = host_median_ms(lambda: (net(xb), _sync(dev)))
    occ = {b: r["rows"] for b, r in st["batch_occupancy"].items()}
    log(f"[deploy {dtype_name}] {card}: Server, {DEPLOY_REQUESTS} requests "
        f"from {DEPLOY_CLIENTS} threads: {DEPLOY_REQUESTS / wall:.1f} "
        f"images/s, latency p50 {st['p50_ms']} ms p99 {st['p99_ms']} ms, "
        f"{st['batches']} batches, rows by bucket {occ} (padded "
        f"{st['padded_rows']}), queue wait {st['timeline']['queue_wait_pct']}"
        f"% / execute {st['timeline']['exec_pct']}%; phase 12 (b)'s "
        f"FusedInferStep {infer_ms:.3f} ms a batch of {BATCH}; worst reply "
        f"vs eager batch-1 forward {worst:.3e} of the largest |logit| "
        f"(limit {limit:.3e}); launches {_b123(launches)}; a batch of "
        f"{top}: the program alone (numpy in and out) {program_ms:.3f} ms, "
        f"the eager forward {eager_ms:.3f} ms")
    assert worst <= limit, f"(b) {dtype_name} reply off the eager forward"
    return {"wall_s": wall, "images_per_s": DEPLOY_REQUESTS / wall,
            "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
            "batches": st["batches"], "occupancy": st["batch_occupancy"],
            "timeline": {k: v for k, v in st["timeline"].items()
                         if k != "slowest"},
            "worst_rel_err": worst, "limit": limit, "launches": launches,
            "program_ms": program_ms, "eager_ms": eager_ms}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_median_ms(fn, reps=5):
    """Median host ms of fn() over `reps` calls after one warm-up; fn
    must end synchronised."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def deploy_resnet(card, dev, root, infer_ms):
    """(a)-(b) under bf16 AMP, then the float32 arm with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for dtype_name in ("bfloat16", "float32"):
        if dtype_name == "bfloat16":
            amp.init("bfloat16")
        try:
            with fused.fusion_scope(True):
                net = vision.resnet50_v1(layout="NHWC", classes=CLASSES,
                                         device=dev, seed=0)
                t0 = time.perf_counter()
                model, rows = export_buckets(net, root, f"r50-{dtype_name}",
                                             dtype_name, dev)
                export_s = time.perf_counter() - t0
                served = serve_images(card, model, net, dtype_name, infer_ms,
                                      dev)
        finally:
            if dtype_name == "bfloat16":
                amp.uninit()
        out[dtype_name] = {"export": rows, "export_s": export_s,
                           "serve": served}
        del net, model
        torch.cuda.empty_cache()
    return out


def _fleet_launches(workdir):
    """{replica index: [B4 launches of each logged process]} from the
    replicas' `replica <i> launches {...}` lines."""
    out = {}
    for i in range(FLEET_REPLICAS):
        path = os.path.join(workdir, f"replica{i}.log")
        with open(path) as f:
            for line in f:
                m = re.search(rf"replica {i} launches (\{{.*\}})", line)
                if m:
                    counts = json.loads(m.group(1))
                    out.setdefault(i, []).append(sum(
                        n for k, n in counts.items()
                        if k.startswith("paged_attention_q:")))
    return out


def _fleet_round(fleet, prompts, new):
    t0 = time.perf_counter()
    futs = [(fleet.submit(p, max_new_tokens=new), time.perf_counter())
            for p in prompts]
    lat, outs = [], []
    for f, ts in futs:
        outs.append(f.result(timeout=300))
        lat.append((time.perf_counter() - ts) * 1e3)
    return outs, lat, time.perf_counter() - t0


def fleet_run(card, root, engine_st, dev):
    """(c) Two replicas at phase 3's width on the one card: float32 exact
    against reference_generate, a SIGKILL drill, a swap to bfloat16 under
    load, then bfloat16 traffic timed through the router."""
    import signal
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts = make_prompts()
    cfg32 = dict(FULL, dtype="float32")
    engine = {"max_slots": SLOTS, "prefill_window": WINDOW,
              "decode_steps": DECODE_STEPS}
    ref_model = serve.CachedDecoder(serve.DecoderConfig(**cfg32), seed=0,
                                    device=dev)
    want = [ref_model.reference_generate(p, FLEET_NEW, window=WINDOW)
            for p in prompts]
    del ref_model
    torch.cuda.empty_cache()
    spec = {"version": "v1", "config": cfg32, "seed": 0, "engine": engine,
            "device": dev.type}
    workdir = os.path.join(root, "fleet")
    before = serve.fleet_stats()
    t0 = time.perf_counter()
    fleet = serve.Fleet(spec, replicas=FLEET_REPLICAS, heartbeat_ms=500,
                        workdir=workdir, spawn_timeout=300)
    try:
        fleet.start()
        start_s = time.perf_counter() - t0
        warm = [r["warmup_s"] for r in fleet.stats()["replicas"]]
        outs, lat, wall = _fleet_round(fleet, prompts, FLEET_NEW)
        bad = [len(p) for p, o, w in zip(prompts, outs, want)
               if not np.array_equal(o, w)]
        log(f"[fleet float32] {card}: {FLEET_REPLICAS} replicas up in "
            f"{start_s:.2f} s (engine warmups {warm} s); {len(prompts)} "
            f"requests, {FLEET_NEW} tokens each, {wall:.3f} s; "
            f"{len(prompts) - len(bad)}/{len(prompts)} token-exact against "
            f"reference_generate")
        assert not bad, f"(c) fleet != reference for prompts {bad}"
        # SIGKILL replica 0 with the whole round in flight
        pid0 = fleet.stats()["replicas"][0]["pid"]
        futs = [fleet.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
        os.kill(pid0, signal.SIGKILL)
        t_kill = time.perf_counter()
        killed = [f.result(timeout=300) for f in futs]
        answered_s = time.perf_counter() - t_kill
        lost = [len(p) for p, o, w in zip(prompts, killed, want)
                if not np.array_equal(o, w)]
        deadline = time.perf_counter() + 300
        while time.perf_counter() < deadline:
            reps = fleet.stats()["replicas"]
            if reps[0]["state"] == "serving" and reps[0]["pid"] != pid0:
                break
            time.sleep(0.2)
        respawn_s = time.perf_counter() - t_kill
        mid = serve.fleet_stats()
        log(f"[fleet float32] SIGKILL of replica 0 (pid {pid0}) with "
            f"{len(prompts)} requests in flight: all answered in "
            f"{answered_s:.2f} s, {len(prompts) - len(lost)} token-exact; "
            f"respawned in {respawn_s:.2f} s (failovers "
            f"{mid['failovers'] - before['failovers']}, retries "
            f"{mid['retries'] - before['retries']}, respawns "
            f"{mid['respawns'] - before['respawns']})")
        assert not lost, f"(c) SIGKILL drill changed prompts {lost}"
        assert mid["respawns"] > before["respawns"] \
            and fleet.stats()["replicas"][0]["state"] == "serving", \
            "(c) the respawn was not observed"
        # rolling swap onto version v2 (bfloat16) under load
        stop, load_errors, load_outs = threading.Event(), [], []

        def pump(k):
            i = k
            while not stop.is_set():
                try:
                    load_outs.append(fleet.submit(
                        prompts[i % len(prompts)][:64],
                        max_new_tokens=FLEET_LOAD_NEW).result(timeout=300))
                except Exception as e:      # noqa: BLE001 - re-raised
                    load_errors.append(e)
                i += 2

        pumps = [threading.Thread(target=pump, args=(k,)) for k in range(2)]
        for t in pumps:
            t.start()
        t_swap = time.perf_counter()
        try:
            fleet.swap(dict(spec, version="v2",
                            config=dict(FULL, dtype="bfloat16")))
        finally:
            stop.set()
            for t in pumps:
                t.join(timeout=300)
        swap_s = time.perf_counter() - t_swap
        log(f"[fleet] swap to v2 (bfloat16) under load: {swap_s:.2f} s, "
            f"{len(load_outs)} requests answered, {len(load_errors)} lost, "
            f"versions {[r['version'] for r in fleet.stats()['replicas']]}")
        assert not load_errors, f"(c) swap lost {load_errors[:3]}"
        assert load_outs and all(o.shape == (FLEET_LOAD_NEW,)
                                 for o in load_outs)
        assert fleet.version == "v2" and all(
            r["version"] == "v2" for r in fleet.stats()["replicas"])
        # bfloat16 through the router: TTFT is a 1-token request's latency,
        # TPOT the extra latency of FLEET_NEW tokens over FLEET_NEW - 1
        _, ttft, _ = _fleet_round(fleet, prompts, 1)
        outs16, e2e, wall16 = _fleet_round(fleet, prompts, FLEET_NEW)
        tpot = [(e - t) / (FLEET_NEW - 1) for e, t in zip(e2e, ttft)]
        assert all(o.shape == (FLEET_NEW,) and (o >= 0).all()
                   and (o < FULL["vocab"]).all() for o in outs16)
        stats = {}
        for nm, vals in (("ttft", ttft), ("tpot", tpot), ("e2e", e2e)):
            v = sorted(vals)
            for q in (50, 99):
                stats[f"{nm}_p{q}_ms"] = serve.percentile(v, q)
        log(f"[fleet bfloat16] {card}: {len(prompts)} requests through the "
            f"router, {wall16:.3f} s; TTFT p50 {stats['ttft_p50_ms']:.3f} "
            f"ms p99 {stats['ttft_p99_ms']:.3f} ms, TPOT p50 "
            f"{stats['tpot_p50_ms']:.3f} ms p99 {stats['tpot_p99_ms']:.3f} "
            f"ms; phase 3's in-process engine TTFT p50 "
            f"{engine_st['ttft_p50_ms']} ms p99 {engine_st['ttft_p99_ms']} "
            f"ms, TPOT p50 {engine_st['tpot_p50_ms']} ms p99 "
            f"{engine_st['tpot_p99_ms']} ms")
    finally:
        fleet.close()
        for h in fleet._replicas:
            if h.proc is not None and h.proc.poll() is None:
                h.proc.kill()
                h.proc.wait(timeout=30)
    launches = _fleet_launches(workdir)
    log(f"[fleet] B4 launches by replica process, from the replicas' logs: "
        f"{launches}")
    assert sorted(launches) == list(range(FLEET_REPLICAS)) and all(
        n > 0 for v in launches.values() for n in v), \
        "(c) a replica logged no B4 launch"
    after = serve.fleet_stats()
    return {"start_s": start_s, "warmup_s": warm, "float32_exact":
            len(prompts), "kill_answered_s": answered_s,
            "respawn_s": respawn_s, "swap_s": swap_s,
            "swap_load_answered": len(load_outs), "bf16": stats,
            "bf16_wall_s": wall16, "b4_launches": launches,
            "b4_launches_total": sum(sum(v) for v in launches.values()),
            "counters": {k: after[k] - before[k] for k in after
                         if k != "replicas_live"}}


def phase_deploy_serve(card, dev, infer_ms, engine_st):
    """Phase 17: export + Server over ResNet-50, and a Fleet."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        resnet = deploy_resnet(card, dev, root, infer_ms)
        fleet = fleet_run(card, root, engine_st, dev)
    took = time.perf_counter() - t0
    log(f"[deploy] phase 17 took {took:.1f} s")
    return {"resnet": resnet, "fleet": fleet, "seconds": took}


# ---------------------------------------------------------------------------
# phase 18: telemetry over the training and serving paths
# ---------------------------------------------------------------------------
TEL_STEPS = 10
TEL_PROFILE_STEPS = 2
# B1-B3's kernel symbols as torch.profiler names them (the apply's vector
# and scalar kernels both start "scale_shift_act")
TEL_SYMBOLS = {"scale_shift_act": "scale_shift_act",
               "avg_pool2d_fwd": "mx_pool_fwd_",
               "avg_pool2d_bwd": "mx_pool_bwd_"}


def _set_telemetry(on):
    from incubator_mxnet_tpu_torch.telemetry import trace as ttrace
    os.environ["MXNET_TELEMETRY"] = "1" if on else "0"
    ttrace._expire_env_memo()


def telemetry_train(card, dev, tmpdir):
    """(a): the same steps with telemetry off and on, MFU, and a profiled
    window whose kernel records match the launch counters; (c)'s census
    and leak check ride on the same net and step."""
    from incubator_mxnet_tpu_torch import profiler, telemetry
    from incubator_mxnet_tpu_torch.inspect import memory as mem
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b)
               for b in make_batches(2, BATCH, seed=11)]
    amp.init("bfloat16")
    try:
        net = vision.resnet50_v1(layout="NHWC", classes=CLASSES,
                                 device=dev, seed=0)
        step = new_step(net, BATCH, use_fusion=True)
        for i in range(TRAIN_WARMUP):
            step(*batches[i % 2])
        flops = 3 * telemetry.block_fwd_flops(net, batches[0][0])
        peak = telemetry.device_peak_flops()
        torch.cuda.synchronize()
        runs = {}
        kernels.reset_launch_counts()
        for on in (False, True):
            _set_telemetry(on)
            tl = telemetry.StepTimeline(flops_per_step=flops,
                                        peak_flops=peak)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(TEL_STEPS):
                with tl.step():
                    step(*batches[i % 2])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs["on" if on else "off"] = {
                "ms_per_step": wall / TEL_STEPS * 1e3, "report": tl.report()}
        launches = kernels.launch_counts()
        for name, per in (("scale_shift_act", 53), ("avg_pool2d_fwd", 1),
                          ("avg_pool2d_bwd", 1)):
            assert launches[name] == per * 2 * TEL_STEPS, \
                f"{name}: {launches[name]} launches off the main path"
        off, on = runs["off"]["ms_per_step"], runs["on"]["ms_per_step"]
        rep = runs["on"]["report"]
        assert rep["steps"] == TEL_STEPS and rep["mfu"] > 0
        assert runs["off"]["report"].get("mfu") is None, \
            "a disabled timeline reported MFU"
        log(f"[telemetry train] {card}: {TEL_STEPS} steps telemetry off "
            f"{off:.3f} ms/step, on {on:.3f} ms/step (difference "
            f"{on - off:+.3f} ms, {100 * (on - off) / off:+.2f}%); flops a "
            f"step {flops:.4e} (block_fwd_flops x 3), peak {peak:.3e}, MFU "
            f"{rep['mfu']}")
        log(f"[telemetry train] StepTimeline.report() {json.dumps(rep)}")
        # a profiled window: the trace's kernel records against the
        # launch counters
        profiler.set_config(profile_device=True)
        kernels.reset_launch_counts()
        profiler.start()
        for i in range(TEL_PROFILE_STEPS):
            with telemetry.span("train.step", step=i):
                step(*batches[i % 2])
        profiler.stop()
        moved = kernels.launch_counts()
        path = profiler.dump(filename=os.path.join(tmpdir, "trace.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        in_trace = {n: sum(1 for e in events if e.get("cat") == "kernel"
                           and sym in e["name"])
                    for n, sym in TEL_SYMBOLS.items()}
        spans = sum(1 for e in events if e["name"] == "train.step")
        log(f"[telemetry train] profiled {TEL_PROFILE_STEPS} steps: kernel "
            f"records {in_trace}, launch counters "
            f"{ {n: moved[n] for n in TEL_SYMBOLS} }, {spans} train.step "
            f"spans, {len(events)} events")
        for n in TEL_SYMBOLS:
            assert in_trace[n] == moved[n] > 0, \
                f"{n}: {in_trace[n]} records in the trace, {moved[n]} launches"
        assert spans == TEL_PROFILE_STEPS
        profiler._events.clear()
        census = telemetry_memory(net, step, batches, dev)
        kernels.reset_launch_counts()
    finally:
        amp.uninit()
        _set_telemetry(True)
    del net, step
    torch.cuda.empty_cache()
    return {"ms_per_step_off": off, "ms_per_step_on": on,
            "overhead_ms": on - off, "flops_per_step": flops,
            "peak_flops": peak, "mfu": rep["mfu"], "report": rep,
            "report_off": runs["off"]["report"], "launches": launches,
            "profiled": {"kernel_records": in_trace, "spans": spans},
            "memory": census}


def telemetry_memory(net, step, batches, dev):
    """(c): a tagged census across the step, a leak check over 4 steps,
    a provoked OOM and its dump, a flight-recorder dump read back."""
    import tempfile
    from incubator_mxnet_tpu_torch import telemetry
    from incubator_mxnet_tpu_torch.inspect import memory as mem
    mem.register(net.collect_params(), owner="params")
    mem.register(step._states, owner="optimizer_state")
    host = [tuple(t.cpu().numpy() for t in b) for b in batches]
    feed = mx.io.DeviceFeed(iter(host * 2), depth=2, device=dev)
    fed = list(feed)                  # staged batches, "device_feed"
    for x, y in fed:
        step(x, y)
    torch.cuda.synchronize()
    c = mem.census(device=dev)
    own = {k: (v["count"], v["bytes"]) for k, v in c["owners"].items()}
    log(f"[telemetry memory] census on {c['device']}: {own}; total "
        f"{c['total_bytes'] / 2**20:.1f} MiB, tagged "
        f"{100 * c['tagged_fraction']:.1f}%")
    for owner in ("params", "optimizer_state", "device_feed"):
        assert c["owners"].get(owner, {}).get("bytes", 0) > 0, \
            f"census lacks {owner}"
    x, y = fed[0]
    leak = mem.leakcheck(lambda: step(x, y), rounds=4, device=dev)
    log(f"[telemetry memory] leakcheck over 4 steps: untagged MiB "
        f"{[round(b / 2**20, 3) for b in leak['untagged_bytes']]}, growth "
        f"{leak['growth_bytes']} bytes, leak {leak['leak']}")
    assert not leak["leak"]
    del fed, feed, x, y
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        os.environ["MXNET_MEM_OOM_DUMP"] = d
        free, total = torch.cuda.mem_get_info(dev)
        err = None
        try:
            torch.empty(int(free * 1.5), dtype=torch.uint8, device=dev)
        except torch.OutOfMemoryError as e:
            err = e
        assert err is not None, "an allocation past free memory succeeded"
        assert mem.is_oom_error(err)
        path = telemetry.mem_on_oom(err, where="phase18")
        with open(path) as f:
            dump = json.load(f)
        del os.environ["MXNET_MEM_OOM_DUMP"]
        assert dump["memory_stats"]["allocated_bytes.all.current"] > 0
        assert dump["device_memory"]["total"] == total
        err = None
        torch.cuda.empty_cache()
        rec = telemetry.flightrec_dump(path=os.path.join(d, "flightrec.json"),
                                       reason="phase18")
        with open(rec) as f:
            ring = json.load(f)
    kinds = sorted({e["kind"] for e in ring["events"]})
    log(f"[telemetry memory] OOM of {free * 1.5 / 2**30:.2f} GiB past "
        f"{free / 2**30:.2f} GiB free: is_oom_error True, dump with "
        f"{len(dump['memory_stats'])} memory_stats keys (allocated "
        f"{dump['memory_stats']['allocated_bytes.all.current'] / 2**20:.1f}"
        f" MiB); flight recorder dump read back: {ring['n_events']} events, "
        f"kinds {kinds}")
    assert ring["reason"] == "phase18" and "oom" in kinds
    return {"census": {k: {"count": v["count"], "bytes": v["bytes"]}
                       for k, v in c["owners"].items()},
            "total_bytes": c["total_bytes"],
            "tagged_fraction": c["tagged_fraction"],
            "leakcheck": {k: leak[k] for k in ("untagged_bytes",
                                               "growth_bytes", "leak")},
            "oom_free_bytes": free, "flightrec_events": ring["n_events"],
            "flightrec_kinds": kinds}


def telemetry_serve(card, phase3):
    """(b): phase 3's engine in bfloat16 with every request traced."""
    from incubator_mxnet_tpu_torch import profiler, telemetry
    from incubator_mxnet_tpu_torch.telemetry import trace as ttrace
    prompts = make_prompts()
    os.environ["MXNET_TRACE_SAMPLE"] = "1"
    ttrace._expire_env_memo()
    profiler.set_config(profile_device=False)
    profiler._events.clear()
    try:
        cfg = serve.DecoderConfig(**FULL, dtype="bfloat16")
        eng = serve.ContinuousEngine(serve.CachedDecoder(cfg, seed=0),
                                     max_slots=SLOTS, prefill_window=WINDOW,
                                     decode_steps=DECODE_STEPS)
        eng.start()
        kernels.reset_launch_counts()
        profiler.start()
        outs = [f.result(timeout=300)
                for f in [eng.submit(p, NEW_TOKENS) for p in prompts]]
        profiler.stop()
        launches = kernels.launch_counts()
        st = eng.stats()
        eng.close()
    finally:
        del os.environ["MXNET_TRACE_SAMPLE"]
        ttrace._expire_env_memo()
        profiler.set_config(profile_device=True)
    assert all(o.shape == (NEW_TOKENS,) for o in outs)
    ev = profiler._events
    reqs = [e for e in ev if e["name"] == "serve.request"]
    ids = {e["args"].get("trace_id") for e in reqs}
    kids = {n: [e for e in ev if e["name"] == n]
            for n in ("serve.prefill", "serve.decode")}
    log(f"[telemetry serve] {len(reqs)} serve.request spans, {len(ids)} "
        f"trace ids, prefill {len(kids['serve.prefill'])} / decode "
        f"{len(kids['serve.decode'])} child spans, "
        f"{sum(e['name'] == 'serve.decode_batch' for e in ev)} decode-batch "
        f"spans; paged_attention launches {launches['paged_attention']}")
    assert len(reqs) == len(prompts) and len(ids) == len(prompts) \
        and None not in ids, "a request without its span or trace id"
    for n, spans in kids.items():
        assert {e["args"]["trace_id"] for e in spans} == ids, n
    assert launches["paged_attention"] > 0, "B4 off the traced path"
    text = telemetry.metrics_text()
    fams = ("mx_serve_requests", "mx_serve_replies", "mx_serve_decode_tokens",
            "mx_serve_decode_iterations", 'mx_span_duration_us_count'
            '{name="serve.request"}', 'mx_span_count{name="serve.decode_batch"}',
            "mx_trace_traces", "mx_flightrec_events")
    missing = [f for f in fams if f not in text]
    assert not missing, f"metrics_text lacks {missing}"
    p3 = phase3["stats"]
    log(f"[telemetry serve] {card}: traced TTFT p50 {st['ttft_p50_ms']} ms "
        f"(phase 3 {p3['ttft_p50_ms']}), TPOT p50 {st['tpot_p50_ms']} ms "
        f"(phase 3 {p3['tpot_p50_ms']}); metrics_text holds {fams}")
    profiler._events.clear()
    return {"launches": launches, "requests": len(reqs),
            "trace_ids": len(ids), "ttft_p50_ms": st["ttft_p50_ms"],
            "tpot_p50_ms": st["tpot_p50_ms"],
            "phase3_ttft_p50_ms": p3["ttft_p50_ms"],
            "phase3_tpot_p50_ms": p3["tpot_p50_ms"]}


def phase_telemetry(card, dev, phase3):
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        train = telemetry_train(card, dev, d)
    srv = telemetry_serve(card, phase3)
    took = time.perf_counter() - t0
    log(f"[telemetry] phase 18 took {took:.1f} s")
    return {"train": train, "serve": srv, "seconds": took}


# ---------------------------------------------------------------------------
# phase 19: the Estimator's fit and the roofline report over its step
# ---------------------------------------------------------------------------
EST_EPOCHS, EST_BATCHES, EST_VAL_BATCHES = 2, 4, 2
EST_SGD = dict(learning_rate=0.05, momentum=0.9)
EST_PATIENCE = 2            # early stopping: lets both epochs run
EST_INSPECT_STEPS = 2       # profiled calls of each inspected step
ROOFLINE_LIMIT = 1.05       # a unit over its bound reads a cost-model fault
B123 = ("scale_shift_act", "avg_pool2d_fwd", "avg_pool2d_bwd")


def _device_scope(dev):
    return mx.gpu(dev.index or 0) if dev.type == "cuda" else mx.cpu()


def estimator_loader(n, seed):
    """A DataLoader over n batches of seeded synthetic images and labels
    (made with numpy; no shuffling, so batch i is rows i*BATCH on)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n * BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, size=n * BATCH).astype(np.int32)
    return gluon.data.DataLoader(gluon.data.ArrayDataset(x, y),
                                 batch_size=BATCH), x, y


def _param_values(net):
    return {n: p.data().detach().clone()
            for n, p in net.collect_params().items()}


def _est_net(dev, seed):
    net = vision.resnet50_v1(layout="NHWC", classes=CLASSES, device=dev,
                             seed=seed)
    return net, gluon.Trainer(net.collect_params(), "sgd", dict(EST_SGD))


def _cudnn_det(on, prev=None):
    """Deterministic cuDNN (benchmark off) for one comparison; returns the
    settings to put back."""
    if on:
        prev = (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        return prev
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    return None


def estimator_fit(card, dev, root):
    """(a) `Estimator.fit` over ResNet-50 v1 (NHWC, bf16 AMP, batch 32 x
    224^2), SGD momentum 0.9, a prefetching DataLoader, 2 epochs x 4
    batches, with CheckpointHandler, StepTimelineHandler(auto_flops=True),
    validation over 2 batches, LoggingHandler and EarlyStoppingHandler;
    the first step against a hand-written one, bit for bit."""
    from incubator_mxnet_tpu_torch.gluon.contrib import estimator as est
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loader, x_np, y_np = estimator_loader(EST_BATCHES, seed=23)
    val, _, _ = estimator_loader(EST_VAL_BATCHES, seed=29)
    x0 = torch.from_numpy(x_np[:BATCH]).to(dev)
    y0 = torch.from_numpy(y_np[:BATCH]).to(dev)
    first = {}

    class FirstStep(est.BatchEnd):
        """Snapshots the first step's loss and parameters, then puts the
        cuDNN settings back."""

        def batch_end(self, estimator, loss=None, **kw):
            if "loss" not in first:
                first["loss"] = getattr(loss, "_t", loss).detach().clone()
                first["params"] = _param_values(estimator.net)
                _cudnn_det(False, first.pop("prev"))

    class SteadyClock(est.EpochBegin, est.BatchBegin, est.BatchEnd):
        """Synchronised time of each epoch's batches after its first (no
        checkpoint or validation falls between them)."""
        spans, i, t0 = [], 0, 0.0

        def epoch_begin(self, estimator, *a, **kw):
            self.i = 0

        def batch_begin(self, estimator, *a, **kw):
            if self.i == 1:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()

        def batch_end(self, estimator, *a, **kw):
            self.i += 1
            if self.i == EST_BATCHES:
                torch.cuda.synchronize()
                self.spans.append((time.perf_counter() - self.t0)
                                  / (EST_BATCHES - 1))

    prev = _cudnn_det(True)
    # the hand-written step from the same weights and batch
    ref_net, ref_tr = _est_net(dev, seed=0)
    with autograd.record():
        ref_loss = loss_fn(ref_net(x0), y0).mean()
    ref_loss.backward()
    ref_tr.step(BATCH)
    ref_loss = getattr(ref_loss, "_t", ref_loss).detach().clone()
    ref_params = _param_values(ref_net)
    del ref_net, ref_tr
    net, tr = _est_net(dev, seed=0)
    e = est.Estimator(net, loss_fn, trainer=tr,
                      train_metrics=metric.Accuracy())
    timeline = est.StepTimelineHandler(auto_flops=True)
    early = est.EarlyStoppingHandler(e.train_metrics[-1], mode="min",
                                     patience=EST_PATIENCE)
    handlers = [est.CheckpointHandler(root, model_prefix="r50"), timeline,
                est.LoggingHandler(metrics=e.train_metrics), early,
                FirstStep(), SteadyClock()]
    first["prev"] = prev
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e.fit(loader, val_data=val, epochs=EST_EPOCHS, event_handlers=handlers)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if "prev" in first:
        _cudnn_det(False, first.pop("prev"))
    loss_equal = torch.equal(first["loss"], ref_loss)
    parted = [n for n in ref_params
              if not torch.equal(ref_params[n], first["params"][n])]
    rep = e.step_timeline
    steps = EST_EPOCHS * EST_BATCHES
    # per training step 53 / 1 / 1; each validation forward and the one
    # forward that counts the FLOPs (auto_flops) 53 / 1 / 0
    forwards = EST_EPOCHS * EST_VAL_BATCHES + 1
    want = {"scale_shift_act": 53 * (steps + forwards),
            "avg_pool2d_fwd": steps + forwards, "avg_pool2d_bwd": steps}
    files = sorted(os.listdir(root))
    loss_final = float(e.train_metrics[-1].get()[1])
    step_ms = rep["step_mean_us"] / 1e3
    flops = timeline._tl.flops_per_step
    peak = timeline._tl.peak_flops
    steady_ms = float(np.mean(handlers[-1].spans)) * 1e3
    steady_mfu = flops / (steady_ms / 1e3) / peak if peak else None
    log(f"[estimator fit] {card}: {EST_EPOCHS} epochs x {EST_BATCHES} "
        f"batches of {BATCH} in {fit_s:.2f} s (validation over "
        f"{EST_VAL_BATCHES} batches an epoch, two checkpoints); "
        f"StepTimeline: step {step_ms:.3f} ms ({BATCH / step_ms * 1e3:.1f} "
        f"images/s), MFU {rep.get('mfu')} of {peak} (flops a step "
        f"{flops:.4e}; over the whole fit, saves and validation "
        f"included), stall {rep['stall_pct']:.2f}%; steady steps (each "
        f"epoch's last {EST_BATCHES - 1}, synchronised) {steady_ms:.3f} ms "
        f"({BATCH / steady_ms * 1e3:.1f} images/s, MFU {steady_mfu}); "
        f"launches {_b123(launches)} (want "
        f"{_b123(want)}: 53/1/1 a step x {steps} + 53/1/0 a forward x "
        f"{forwards}); first step against the hand-written one: loss "
        f"equal {loss_equal} ({float(first['loss'])} / "
        f"{float(ref_loss)}), parameters parted {len(parted)} of "
        f"{len(ref_params)} {parted[:3]}; train loss {loss_final:.4f}, "
        f"accuracy {e.train_metrics[0].get()[1]}, validation "
        f"{e.val_metrics[0].get()}; early stopping at epoch "
        f"{early.stopped_epoch}; files {files}")
    assert loss_equal and not parted, \
        "(a) the fit's first step is not the hand-written step, bit for bit"
    assert all(launches[n] == want[n] for n in B123), \
        f"(a) launches {_b123(launches)}, want {_b123(want)}"
    assert math.isfinite(loss_final), "(a) non-finite loss"
    assert rep["steps"] == steps and early.stopped_epoch == 0
    assert "r50-epoch2.params.npz" in files \
        and "r50-epoch2.params.npz.states" in files
    return e, loader, {
        "fit_s": fit_s, "step_ms": step_ms,
        "images_per_s": BATCH / step_ms * 1e3, "mfu": rep.get("mfu"),
        "steady_step_ms": steady_ms,
        "steady_images_per_s": BATCH / steady_ms * 1e3,
        "steady_mfu": steady_mfu,
        "stall_pct": rep["stall_pct"],
        "flops_per_step": timeline._tl.flops_per_step, "timeline": rep,
        "launches": {n: launches[n] for n in B123}, "want": want,
        "first_step_equal": loss_equal and not parted, "files": files,
        "loss": loss_final}


def estimator_resume(card, dev, root, e, loader):
    """(b) a fresh net resumed from the fit's epoch-2 checkpoint (bit for
    bit, 0 more epochs of a 2-epoch budget), and a transient fault at
    `estimator.checkpoint` retried until the file lands."""
    from incubator_mxnet_tpu_torch import fault
    from incubator_mxnet_tpu_torch import optimizer as opt_mod
    from incubator_mxnet_tpu_torch.gluon.contrib import estimator as est
    net2, tr2 = _est_net(dev, seed=5)
    e2 = est.Estimator(net2, gluon.loss.SoftmaxCrossEntropyLoss(),
                       trainer=tr2)

    class Epochs(est.EpochEnd):
        n = 0

        def epoch_end(self, estimator, *a, **kw):
            self.n += 1
    count = Epochs()
    h = est.CheckpointHandler(root, model_prefix="r50",
                              resume_from_checkpoint=True)
    e2.fit(loader, epochs=EST_EPOCHS, event_handlers=[h, count])
    pa, pb = e.net.collect_params(), net2.collect_params()
    parted = [n for n in pa if not torch.equal(pa[n].data(), pb[n].data())]
    sa = [opt_mod.state_to_numpy(s) for s in e.trainer._states]
    sb = [opt_mod.state_to_numpy(s) for s in tr2._states]
    states_equal = len(sa) == len(sb) and all(
        _trees_equal(x, y) for x, y in zip(sa, sb))
    # a transient I/O fault at the checkpoint's save: retried, lands
    h3 = est.CheckpointHandler(root, model_prefix="r50f")
    h3.train_begin(e)
    fault.reset_hits()
    t0 = time.perf_counter()
    with fault.scope("estimator.checkpoint:1:ioerror"):
        h3.epoch_end(e)
        hits = fault.hits("estimator.checkpoint")
    save_s = time.perf_counter() - t0
    landed = os.path.exists(os.path.join(root, "r50f-epoch1.params.npz"))
    log(f"[estimator resume] {card}: resumed at epoch {e2._resume_epoch}, "
        f"{count.n} more epochs of a {EST_EPOCHS}-epoch budget; parameters "
        f"parted {len(parted)} of {len(pa)}, trainer states equal "
        f"{states_equal}; a transient fault at estimator.checkpoint: "
        f"{hits} attempts, the file landed {landed} ({save_s:.2f} s)")
    assert e2._resume_epoch == EST_EPOCHS and count.n == 0, "(b) resume"
    assert not parted and states_equal, "(b) resume not bit-equal"
    assert hits >= 2 and landed, "(b) the faulted save was not retried"
    del e2, net2, tr2
    return {"resume_epoch": EST_EPOCHS, "more_epochs": count.n,
            "parted": parted, "states_equal": states_equal,
            "fault_attempts": hits, "fault_landed": landed,
            "fault_save_s": save_s}


def _inspected(card, tag, rep, want_b123):
    """Checks of one measured report: the hand-written kernels' records in
    the window against the launch counters; the apply's units at the
    shapes ResNet-50 gives it, each hand-written kernel's unit with
    `kernel_cost`'s flops and bytes at its shapes and its bound exactly
    that cost's cold bound; no unit over ROOFLINE_LIMIT of its floor
    (`roofline.floor_bound`: every byte through the L2 at its rate,
    measured in this run, and device memory spared at most what the L2
    holds at the unit's start and end). The units over their cold bound are
    counted and listed apart, each with both shares."""
    from incubator_mxnet_tpu_torch.inspect import report as mxreport
    win = rep["window"]
    records = {n: win["kernel_records"].get(n, 0) for n in B123}
    counted = {n: win["launch_counts"].get(n, 0) for n in B123}
    units = rep["units"]
    bad_bound = []
    applies = []
    for u in units:
        if u["opcode"] != "mx_kernel":
            continue
        shape = dict(u["shape"])
        for k in ("dtype", "in_dtype", "out_dtype", "kv_dtype"):
            if k in shape:
                shape[k] = getattr(torch, shape[k])
        cost = roofline.kernel_cost(u["kernel"], **shape)
        cold = roofline.unit_bound(cost, rep["calibration"])[0]
        if (u["flops"], u["bytes"], u["est_time_s"]) != (
                cost["flops"], cost["bytes"], cold):
            bad_bound.append(u["name"])
        if u["kernel"] == "scale_shift_act":
            applies.append((shape["M"], shape["C"], shape["act"],
                            shape["residual"]))
    rows = resnet50_apply_rows(BATCH, IMAGE)
    assert rep["platform"] != "gpu" or sorted(applies, key=repr) == sorted(
        rows, key=repr), f"({tag}) the apply's units are not ResNet-50's " \
        f"53 shapes"
    over = [(u["name"], u["class"], u["floor_share"], u["roofline_share"])
            for u in units if u["floor_share"] is not None
            and u["floor_share"] > ROOFLINE_LIMIT]
    read = sorted((u for u in units if u["floor_share"] is not None),
                  key=lambda u: -u["floor_share"])
    top = read[0]
    t = rep["totals"]
    l2 = rep["l2_resident"]
    cold_over = sum(1 for u in read if u["roofline_share"] > ROOFLINE_LIMIT)
    cold_max = max((u["roofline_share"] for u in read), default=0.0)
    log(f"[inspect {tag}] highest floor shares: " + "; ".join(
        f"{u['name']} {u['class'][:40]} {u['floor_share']:.3f} "
        f"({u['floor_by']}; cold {u['roofline_share']:.3f}; "
        f"{u['bytes'] / 1e6:.2f} MB, {u['device_ms'] * 1e3:.1f} us)"
        for u in read[:12]))
    log(f"[inspect {tag}] over their cold bound: {l2['over_cold_bound']} "
        f"units: " + "; ".join(
            f"{u['name']} cold {u['roofline_share']:.3f} floor "
            f"{u['floor_share']:.3f} ({u['floor_by']})"
            for u in l2["units"]))
    log(f"[inspect {tag}] {card}: {rep['n_units']} units in "
        f"{rep['n_groups']} classes over {win['calls']} calls; kernel "
        f"records {records}, launch counters "
        f"{counted} (want {want_b123} a call); device {t['device_ms']:.3f} "
        f"ms a call in units, {t['unattributed_ms']:.3f} ms unattributed "
        f"({100 * (t['unattributed_share'] or 0):.2f}%, "
        f"{rep['unattributed']['classes']}); est_step_mfu_ceiling "
        f"{rep['est_step_mfu_ceiling']} (cold bounds, least time "
        f"{t['est_time_s'] * 1e3:.3f} ms; floors {t['floor_time_s'] * 1e3:.3f}"
        f" ms); bytes a call {t['bytes']:.4e}; the L2's rate "
        f"{rep['calibration']['l2_bytes_per_sec']:.4e} B/s "
        f"({rep['calibration']['l2_source']}); highest floor share "
        f"{top['floor_share']} ({top['name']}, {top['class'][:60]}); units "
        f"over {ROOFLINE_LIMIT} of their floor: {over[:5]}; of their cold "
        f"bound {cold_over} of {len(read)}, the highest {cold_max:.3f}")
    for line in mxreport.render_markdown(dict(
            rep, offender_groups=rep["offender_groups"][:10])).splitlines():
        log(f"[inspect {tag}]   {line}")
    assert records == counted and all(
        counted[n] == want_b123[n] * win["calls"] for n in B123), \
        f"({tag}) kernel records {records} against counters {counted}"
    assert not bad_bound, f"({tag}) unit bounds off kernel_cost: {bad_bound}"
    assert not over, f"({tag}) units over their floor: {over[:5]}"
    return {"n_units": rep["n_units"], "n_groups": rep["n_groups"],
            "kernel_records": records, "launch_counts": counted,
            "device_ms": t["device_ms"], "bytes": t["bytes"],
            "flops": t["flops"],
            "est_time_s": t["est_time_s"],
            "floor_time_s": t["floor_time_s"],
            "l2_bytes_per_sec": rep["calibration"]["l2_bytes_per_sec"],
            "l2_resident": l2, "cold_over": cold_over,
            "cold_max_share": cold_max,
            "unattributed_ms":
            t["unattributed_ms"], "unattributed_share":
            t["unattributed_share"], "est_step_mfu_ceiling":
            rep["est_step_mfu_ceiling"], "max_floor_share":
            top["floor_share"], "top_groups": [
                {k: g[k] for k in ("class", "count", "est_time_s",
                                   "floor_time_s", "device_ms",
                                   "roofline_share", "floor_share", "bound")}
                for g in rep["offender_groups"][:10]],
            "b1_roofline_share": next(
                (g["roofline_share"] for g in rep["offender_groups"]
                 if g["class"] == "scale_shift_act_kernel"), None),
            "measured_wall_ms": rep["measured_wall_ms"]}


def estimator_report(card, dev, e, loader):
    """(c) `inspect_step` over one training step of the fitted Estimator
    on a batch of its loader, then over phase 17's exported bucket-32
    program (exported afresh when phase 17 did not run in this process)."""
    from incubator_mxnet_tpu_torch import inspect as mxinspect
    with _device_scope(dev):
        x, y = next(iter(loader))
    rep = mxinspect.inspect_step(e, x, y, name="resnet50_estimator_step",
                                 measured=True, steps=EST_INSPECT_STEPS)
    train = _inspected(card, "train", rep,
                       {"scale_shift_act": 53, "avg_pool2d_fwd": 1,
                        "avg_pool2d_bwd": 1})
    model = LIVE.get("deploy_b32")
    fresh = model is None
    if fresh:
        import tempfile
        # under the phase's bf16 AMP, as phase 17 exports its bf16 arm
        # (float32 inputs, cast inside the program)
        assert amp.is_active() and amp.target_dtype() == "bfloat16"
        with tempfile.TemporaryDirectory() as root, \
                fused.fusion_scope(True):
            bm = serve.BucketedModel.export_block(
                e.net, (IMAGE, IMAGE, 3), (BATCH,), root, name="r50-b32",
                dtype="float32", device=dev)
            model = bm.model(BATCH)
    xb = np.random.RandomState(31).rand(BATCH, IMAGE, IMAGE, 3) \
        .astype(np.float32)
    rep_b = mxinspect.inspect_step(model, xb, name="resnet50_bucket32",
                                   measured=True, steps=EST_INSPECT_STEPS)
    bucket = _inspected(card, "bucket32", rep_b,
                        {"scale_shift_act": 53, "avg_pool2d_fwd": 1,
                         "avg_pool2d_bwd": 0})
    bucket["exported_afresh"] = fresh
    return {"train": train, "bucket32": bucket}


def phase_estimator(card, dev):
    import tempfile
    t0 = time.perf_counter()
    prev_env = os.environ.get("MXNET_PREFETCH_TO_DEVICE")
    os.environ["MXNET_PREFETCH_TO_DEVICE"] = "1"
    amp.init("bfloat16")
    fprev = fused.set_fusion_default(True)      # the fused Gluon path
    try:
        with tempfile.TemporaryDirectory() as root, _device_scope(dev):
            e, loader, fit = estimator_fit(card, dev, root)
            resume = estimator_resume(card, dev, root, e, loader)
        kernels.reset_launch_counts()
        report = estimator_report(card, dev, e, loader)
        kernels.reset_launch_counts()
    finally:
        fused.set_fusion_default(fprev)
        amp.uninit()
        if prev_env is None:
            os.environ.pop("MXNET_PREFETCH_TO_DEVICE", None)
        else:
            os.environ["MXNET_PREFETCH_TO_DEVICE"] = prev_env
    LIVE.clear()
    del e, loader
    torch.cuda.empty_cache()
    took = time.perf_counter() - t0
    log(f"[estimator] phase 19 took {took:.1f} s")
    return {"fit": fit, "resume": resume, "report": report, "seconds": took}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every result to this JSON "
                    "file")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler pass over 3 training steps "
                         "of ResNet-50, BERT-base and SSD300 (phases 5, 7, "
                         "11, 12 and 13)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[setup] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = kernels.build()
    build_s = time.perf_counter() - t0
    log(f"[setup] kernel build {build_s:.2f} s "
        f"({', '.join(built) or 'up to date'})")
    for name, text in kernels.BUILD_LOG.items():
        print(f"[setup] nvcc {name}:\n{text}", file=sys.stderr)
        n_fn, spilled = spill_report(text)
        log(f"[setup] {name}: {n_fn} kernel instances, spilling: "
            f"{spilled or 'none'}")
    bwd_usage = bwd_wgmma_usage(kernels.BUILD_LOG.get("flash_attention", ""))
    for fn, use in bwd_usage.items():
        log(f"[setup] {fn}: {use}")

    seconds = {}

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[phase] = time.perf_counter() - t0
        log(f"[timing] {phase}: {seconds[phase]:.1f} s")
        return out
    variants, lens = timed("2 kernels", phase_kernels, dev)
    result = timed("3 serve", phase_serve, card)
    train_kernels = timed("4 train kernels", phase_train_kernels, dev)
    train = timed("5 train", phase_train, card, train_kernels["rows"],
                  args.profile, dev)
    flash = timed("6 flash kernels", phase_flash_kernels, dev)
    bert = timed("7 bert", phase_bert, card, args.profile, dev)
    int8_variants = timed("8 int8 kernels", phase_int8_kernels, dev)
    engine = timed("9 engine", phase_engine, card)
    coverage = timed("10 coverage", phase_coverage, dev)
    loop = timed("11 loop", phase_loop, card, dev, args.profile)
    script = timed("12 script", phase_script, card, dev, args.profile)
    detect = timed("13 detection", phase_detection, card, dev, args.profile)
    array = timed("14 array", phase_array, card, dev, args.profile, {
        n: loop["resnet"]["launches"][n] / LOOP_STEPS
        for n in ("scale_shift_act", "avg_pool2d_fwd", "avg_pool2d_bwd")})
    io = timed("15 input", phase_input, card, dev, args.profile,
               train["step_ms"])
    resilient = timed("16 resilient", phase_resilient, card, dev,
                      args.profile)
    deploy = timed("17 deploy", phase_deploy_serve, card, dev,
                   script["recipe"]["infer"]["ms_per_batch"],
                   result["stats"])
    tel = timed("18 telemetry", phase_telemetry, card, dev, result)
    estimator = timed("19 estimator", phase_estimator, card, dev)
    log(f"[timing] build {build_s:.1f} s, phases "
        f"{sum(seconds.values()):.1f} s: " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items()))

    head = next(v for v in variants if v["dtype"] == "bfloat16"
                and v["C"] == 1)
    entry = {
        "name": "paged_attention", "route": "cuda",
        "source": "incubator_mxnet_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "incubator_mxnet_tpu/ops/pallas_kernels.py:292",
        "launches": result["launches"]["paged_attention"],
        "max_abs_err": max(v["max_abs_err"] for v in variants
                           if v["dtype"] == "bfloat16"),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "kernel_route": "split",
        "shape": f"S={SLOTS} C=1 H={FULL['heads']} D={FULL['head_dim']} "
                 f"T={FULL['max_len']} bfloat16, lengths {lens}",
        "variants": variants,
        "coverage": coverage["engine"],
    }
    # one entry per route of B4, timed at phase 2's serving shapes; its
    # launches are the route's over the serving runs of phases 3 and 9
    # (bfloat16, float16 and float32 engines)
    route_runs = (result["launches"], result["float16_launches"],
                  result["float32_launches"], engine["launches"],
                  engine["float32_launches"])
    route_entries = []
    for route, (dt, C) in PAGED_ROUTE_SHAPES.items():
        v = next(x for x in variants if x["dtype"] == dt and x["C"] == C)
        assert v["kernel_route"] == route, (route, v)
        launches = sum(r[f"paged_attention_{route}"] for r in route_runs)
        assert launches > 0, f"route {route} never ran on the main path"
        route_entries.append({
            "name": f"paged_attention_{route}", "route": "cuda",
            "source": "incubator_mxnet_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "incubator_mxnet_tpu/ops/pallas_kernels.py:292",
            "launches": launches, "max_abs_err": v["max_abs_err"],
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": v["library_ms"], "kernel_route": route,
            "shape": f"S={SLOTS} C={C} H={FULL['heads']} "
                     f"D={FULL['head_dim']} T={FULL['max_len']} {dt}"})
    entries, share = train_entries(train_kernels, train)
    entries[0]["coverage"] = coverage["applies"] + [coverage["dense"]]
    entries[1]["coverage"] = [p[0] for p in coverage["pools"]]
    entries[2]["coverage"] = [p[1] for p in coverage["pools"]]
    train["kernel_share"] = share
    fentries, bert["flash_share"] = flash_entries(flash, bert)
    entries += fentries
    entries.append(int8_entry(int8_variants, engine))
    entries += route_entries
    entries += f16_entries(train_kernels, variants, flash, coverage, loop,
                           result["float16"])
    # phase 12's path (ResNet-50 v2 through the GluonCV recipe and
    # FusedInferStep), counted on counts set to 0 before each run
    recipe, infer = script["recipe"], script["recipe"]["infer"]
    for e, name in zip(entries[:3], ("scale_shift_act", "avg_pool2d_fwd",
                                     "avg_pool2d_bwd")):
        e["recipe_v2_launches"] = recipe["launches"][name]
        e["infer_v2_launches"] = infer["launches"][name]
    keys = ("M", "C", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    entries[0]["v2_timed"] = [{k: r[k] for k in keys}
                              for r in script["applies"] if "ms" in r]
    # phase 13's paths, each counted on counts set to 0 just before it: B1
    # on the SSD300 steps and on each family's steps, the flash kernels a
    # step under each remat policy, the NMS sweep in detect()
    ssd = detect["ssd"]
    entries[0]["ssd_launches"] = ssd["launches"]["scale_shift_act"]
    entries[0]["ssd_conv1"] = ssd["conv1"]
    entries[0]["families_launches"] = {
        n: r["train_launches"]["scale_shift_act"]
        for n, r in detect["families"].items()}
    for e in fentries:
        e["remat_launches_per_step"] = {
            p: r["launches_per_step"].get(e["name"], 0)
            for p, r in detect["remat"]["bert"].items()}
    entries.append(nms_entry(ssd))
    # phase 15's path: the augment kernel's launches on the fed steps
    entries.append(augment_entry(io))
    # phase 16's paths, each counted on counts set to 0 just before it: the
    # ResNet-50 loop resumed from a checkpoint (B1-B3), the engine under
    # faults (B4), the input path under faults (the augment kernel)
    for e, name in zip(entries[:3], ("scale_shift_act", "avg_pool2d_fwd",
                                     "avg_pool2d_bwd")):
        e["resilient_launches"] = resilient["resnet"]["launches"][name]
    entry["resilient_launches"] = \
        resilient["serve"]["launches"]["paged_attention"]
    entries[-1]["resilient_launches"] = \
        resilient["io"]["imagerec"]["launches"]
    # phase 17's paths, each counted on counts set to 0 just before it: B1
    # and B2 over the Server's bucket programs (bfloat16 and float32 arms),
    # B4 in the fleet's replica processes (from their logs)
    for e, name in zip(entries[:2], ("scale_shift_act", "avg_pool2d_fwd")):
        for dt, r in deploy["resnet"].items():
            e[f"deploy_{dt}_launches"] = r["serve"]["launches"][name]
    entry["fleet_launches"] = deploy["fleet"]["b4_launches_total"]
    # phase 18's paths, each counted on counts set to 0 just before it: B1
    # to B3 over (a)'s 20 steps, B4 over (b)'s traced serving
    for e, name in zip(entries[:3], ("scale_shift_act", "avg_pool2d_fwd",
                                     "avg_pool2d_bwd")):
        e["telemetry_launches"] = tel["train"]["launches"][name]
    entry["telemetry_launches"] = tel["serve"]["launches"]["paged_attention"]
    # phase 19's path, counted on counts set to 0 just before it: B1 to B3
    # over the Estimator's fit (8 steps, 4 validation forwards, the FLOPs
    # forward)
    for e, name in zip(entries[:3], B123):
        e["estimator_launches"] = estimator["fit"]["launches"][name]
    # phase 14's launches through NDArray / npx, counted around its own
    # calls only (the comparisons with plain versions and the sweep's card
    # calls do not count)
    for e in [entry] + entries:
        e["npx_launches"] = npx_launches(e, array)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s,
                       "phase_seconds": seconds,
                       "build_each_s": built, "build_log": kernels.BUILD_LOG,
                       "bwd_wgmma_ptxas": bwd_usage,
                       "kernels": [entry] + entries,
                       "serve": result, "train": train, "bert": bert,
                       "engine": engine, "coverage": coverage,
                       "loop": loop, "script": script,
                       "detection": detect, "array": array, "io": io,
                       "resilient": resilient, "deploy": deploy,
                       "telemetry": tel, "estimator": estimator}, f,
                      indent=1, default=str)
    print(card)
    print(json.dumps({"kernels": [entry] + [
        {k: v for k, v in e.items() if k != "variants"} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
