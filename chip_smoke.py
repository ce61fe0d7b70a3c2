"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sam2-gradients   # the SAM2 gradient check alone

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, started together), holds each against its plain PyTorch version
at the shapes of the main paths, then drives those paths, each with the
kernels' launch counters set to 0 just before it and read just after:

- the K9 and K2b entry points, which no model path calls:
  ``fused_attention_qkv`` on ViT-B/16's and ViT-H/14's packed qkv and
  ``fused_attention(..., bias=)`` on SAM-B's and SAM-H's windows with a full
  fp32 bias, forward and backward, counted (2 launches each way);
- eval: full-width ViT-B/16 (bf16, global-pool head, fused attention)
  through the work-dir eval CLI on seeded random weights and seeded
  synthetic images, and full-width ViT-H/14 at reduced depth through
  init_model -> make_classification_eval_step -> the DataLoader;
- training: full-width, full-depth ViT-B/16 through the work-dir train CLI
  with the port's train config on the seeded synthetic dataset (two epochs,
  then the same command resumed for a third), its best.pth through the eval
  CLI; gradients and a 20-step one-batch run with the kernels against plain
  attention and plain LayerNorm; full-width ViT-H/14 at reduced depth
  through init_model -> build_optimizer -> make_train_step; ViT-B/16 with
  the fused LayerNorm (use_fused_norm); timed train and eval steps;
- the fused attention block (use_fused_block, kernel K8): ViT-B/16 through
  the work-dir eval CLI with every block through K8, its logits against the
  plain ops, eval steps timed with and without the flag; the train CLI with
  the port's train config and the flag (two epochs, then resumed for a
  third; at drop-path 0.1 only block 0 takes K8 in training); the gradients
  of one micro-batch at drop-path 0 (all 12 blocks through K8) against the
  plain ops, and with use_gradient_checkpoint against the unchecked ones;
  timed train steps at drop-path 0, 4 x 64 and 1 x 256, with and without
  the flag, with peak memory;
- SAM interactive segmentation: full-width, full-depth SAM-B (1024^2, bf16,
  batch 8, seeded random weights) through the prediction tool on the
  synthetic image, encoding once and decoding a point, a box and both;
  the same model with the kernels and with plain attention; the encoder
  and decoder timed; the same again on two images with the attention
  weights redrawn so that attention is sharp; full-width SAM-H at reduced
  depth through the tool;
- SAM training: full-width, full-depth SAM-B (1024^2, bf16, batch 8)
  through the work-dir train CLI with the port's SAM-B config (gradient
  checkpointing, 4 extra decoder passes with error clicks) on the seeded
  synthetic dataset (one epoch of 2 steps, then resumed for a second);
  SAM-B's gradients with sharp attention, kernels against plain attention;
  timed train steps with and without checkpointing; full-width SAM-H at
  reduced depth, its gradients likewise;
- SAM2 video tracking: full-width, full-depth SAM2-B+ (1024^2, bf16, batch
  1, the 14.1 training configs' settings: high-res skips, Hiera heads
  padded to 64; seeded random weights) through the video prediction tool
  on an 8-frame synthetic clip, frame 0 prompted with a point and 7 frames
  tracked from the memory (K1 18 and K6 3 launches an encoded frame, K6 8
  a tracked frame); one more encoded and tracked frame under
  ``torch.cuda.set_sync_debug_mode("error")``, which fails the run if
  either makes a host sync; encode and track ms, frames/s and the share of
  the bf16 peak; the same weights with sharpened attention, kernels against
  plain attention on every frame, with a control; a reference-width
  (head_dim_padding=0) SAM2-B+ at reduced depth, whose windows take K2 and
  whose global block takes K6 at d = 56, compared likewise;
- SAM2 training: full-width, full-depth SAM2-B+ (1024^2, bf16, batch 1)
  through the work-dir train CLI with the port's stage-2 config (gradient
  checkpointing, condition frames, 2 point-iteration frames refined by
  error clicks, two condition slots) on seeded synthetic 8-frame clips (one
  epoch of 2 steps, then resumed for a second); timed train steps at the
  JAX package's ``bench_sam2_train.py`` recipe (4 frames, frame 0 prompted,
  frames 1-2 refined) with the kernels and with plain attention; the
  gradients of that step, refinement off, with sharpened attention,
  kernels against plain attention, with a control;
- ImageNet classification from JPEG files (phases 10f-10l): the native
  libjpeg core built from the checkout (``[native jpeg]``: the libjpeg it
  linked, the committed fixtures ``tests/torch_port_data/jpeg`` decoded,
  each per-channel mean within JPEG_MEAN_TOL of the recorded one, decode
  rates on one thread and on every core); the ResNet-50 config's train
  transforms through the loader alone on 4,096 symlinks to the fixtures
  (16 batches: 2 a worker at the config's workers, capped at the cores; 3
  without workers), the rate read after each worker's first batch;
  full-width, full-depth ResNet-50 through the work-dir train CLI with the
  port's ``imagenet/resnet50`` config on a folder of 512 train and 256
  val symlinks in 8 classes (bf16, batch 256: one epoch of 2 steps, then
  resumed for a second; each epoch's loader wait, split into the workers'
  start, the first batch and the later batches, and step time), its best.pth through the eval CLI over the 256 val images;
  ViT-B/16 through the eval CLI over the JPEG val folder (K1 12 a batch);
  a timed ResNet-50 train step at batch 256 with channels_last activations
  and in NCHW, and a step with a NaN in one of two micro-batches that must
  skip and leave every parameter, the optimizer state and every BatchNorm
  buffer bit for bit; ResNet-18 (CIFAR) through the train CLI with its
  config on a seeded CIFAR-100 pickle (one epoch of 4 steps at 128, then
  resumed for a second); ResNet-50 through the ImageNet-21K train CLI with
  its config on a two-level tree (one epoch of 2 steps), the semantic
  softmax loss finite. The ResNet paths launch no hand-written kernel
  (their counts read 0). Where libjpeg cannot be built, the JPEG phases'
  lines say ``unavailable`` with the reason instead;
- MAE pretraining, distillation, Muon and the configs (phases 26-33,
  a-h): K1 and K2 at the MAE shapes (K1 over the ViT-B/16 and L/16
  encoders' 50 tokens, K2 over the decoders' 197 tokens at head dim 32 and
  ViT-H/14's 65 at 80), forward and backward against their plain
  versions, timed beside SDPA; full-width, full-depth MAE ViT-B/16 through
  the MAE train CLI with the port's ``vit_b_16_224_mae_pretrain`` config
  (batch 1024, bf16) on 1,024 symlinks to the fixtures: one epoch of 1
  step, the same command resumed for a second, and an uninterrupted
  two-epoch run over the same batches (recorded and replayed) that must
  end bit for bit where the resumed one does (K1 12 and K2 8 a step each
  way); the MAE step alone at batch 1024 (ms, images/s, peak memory, share
  of the bf16 peak at 3x ``utils/flops.py``'s forward count), a 20-step
  run on one batch with the mask held fixed whose loss must fall, and the
  gradients of one micro-batch with sharpened attention against the bf16
  floor with a control; MAE ViT-L/16 and ViT-H/14 at 4 encoder blocks
  and the full decoder, a few steps each (ViT-H/14 checkpointed: K2 24 and
  12 a step); the self-train ViT-B/16 config from the MAE ``best.pth``
  through the classification train CLI (one epoch), loading what the CPU
  test says JAX loads (nothing); ResNet-152 -> ResNet-50 KD and DML (with
  RandAugment and Mixup/CutMix) through the distillation train CLI at
  batch 256 (one epoch, then resumed; the frozen teacher bit for bit as
  its seeded init, both DML networks moved) and the KD step alone; Muon
  against AdamW on the ViT-B/16 fine-tune config (the Muon losses must
  fall; its split 49 Muon / 103 AdamW tensors); every ResNet and ViT
  config of the slice built on the card, one train step at its batch (a
  batch above 256 images in micro-batches of 256; ViT-L/H at 4 blocks);
  ResNet-50's test-CLI line of parameters and FLOPs against
  ``utils/flops.py``'s count;
- data parallelism, the last backbones and encoder distillation (phases
  35-39): the training BatchNorm of one process, and the global one of a
  larger world (``_global_batch_norm``) in an NCCL group of this process,
  against ``F.batch_norm``; the classification train CLI on
  ``cifar100/resnet18cifar`` with ``use_zero1`` (two epochs of 4 steps)
  run without torchrun and under ``torchrun --nproc_per_node=1`` (NCCL at
  world size 1: the gradient all-reduce and ZeRO-1's all-gather run),
  every logged loss and the final parameters,
  buffers and moments bit for bit equal; K2 at DINOv3's shapes
  ([64, 12, 1024, 64] and [32, 16, 1024, 64], bf16, forward and backward)
  against its plain version, timed beside SDPA, with the bound; DINOv3
  ViT-B/16 and ViT-L/16 at 512^2 with ``use_fused_attention`` (full width
  and depth, bf16): K2 12 and 24 launches a forward, the gradients of one
  train micro-batch with sharpened attention against the plain ops at the
  bf16 floor with a control; DINOv3 ViT-B/16 at 1024^2, K2 0; the 11
  DarkNet, VAN and ConvFormer ImageNet configs at full width and depth,
  one train step each at the config's batch (micro-batches of 256 images
  of 224^2), DarkNet-53, VAN-B0 and ConvFormer-M36 timed (images/s, peak
  memory) and through the eval CLI over the JPEG val folder, whose
  parameter and FLOP line must equal ``utils/flops.py``'s; the 13.0
  (SAM-H -> DINOv3 ViT-B/16) and 14.0 (Hiera-L -> DINOv3 ViT-B/16)
  encoder-distillation configs through their CLIs at 1024^2, full width
  and depth, fp32 as in JAX, on seeded synthetic SAM images at batch
  DISTILL_BATCH (cut from 64: what fits beside the teacher), two epochs of
  2 steps and a resumed third, the teacher of every checkpoint bit for bit
  as first loaded, then a 10-step one-batch run whose loss must fall, its
  step's ms and peak memory.

Cuts of the earlier phases that keep this run within its limit, each of
depth, epochs or batch (every kernel check, control and ``kernels`` row
kept): the kernels build and their SASS is read in the background while
the untimed checks of phases 35, 38 and 39, which launch no hand-written
kernel, run (their timed steps wait for the build's end); the
loader alone over 4,096 files (was 8,192); the ViT-B/16 train CLIs on
512 images, 2 steps an epoch (was 768, 3); the ResNet-50 train CLI, the
KD and DML CLIs and the self-train ViT-B/16 on 512 JPEG files, 2 steps an
epoch (was 1,024, 4), the ResNet-50, ResNet-18 CIFAR, KD and DML CLIs one
epoch and a resumed second (was two and a third); the MAE CLI on 1,024
files, one step an epoch, one epoch and a resumed second against an
uninterrupted two (was 4,096, 4 steps, two and a third against three);
the SAM-B train CLI 2 steps an epoch (was 4) and the SAM2-B+ train CLI 2
clips an epoch (was 3), each one epoch and a resumed second (was two and
a third).

Prints one line per phase, each phase's wall seconds (``[phase N seconds]
t``, when it ends), the ``kernels`` JSON line, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is not 0 and the last line is not printed. Without
CUDA it exits at once with a message.

Tolerances. Attention kernel vs plain version, forward and each of dq, dk,
dv: bf16 atol 2e-2 (a few bf16 ulps at |x| <= 4, from rounding P, dS and the
output in another order); fp32 atol 1e-4; every backward (K1, K2, K9) run
twice gives the same bits. The bf16 kernels of K1, K2 and K9 (and K8's
attention core) must show HGMMA (``wgmma``) in the SASS of the built
libraries, both backward kernels and the forward's no-bias mode at every
chunk shape and head dim instantiated, and so must both backward kernels
of K2b, K3 and K4 (the biased modes); ``fused_attention.cu``'s library
must hold no bf16 (``mma.sync``) backward at all. LayerNorm kernel vs plain version:
bf16 y and dx atol 6.25e-2 (two ulps at |y| <= 8), fp32 1e-4; dgamma and
dbeta, fp32 sums over all rows in another order, 1e-3 of the largest sum.
Model logits, bf16, kernels vs plain ops on the same weights: max |diff| <=
0.02 * max(1, std of the logits), and top-1 agreement >= 99%; for that
comparison the fc head is set to per-class feature prototypes
(``fit_head``), so top-1 is decided by the features and not by near-ties.
Gradients of one bf16 train micro-batch, kernels vs plain ops: relative L2
error per parameter <= 5e-2 and |loss diff| <= 2e-2. Rel-pos attention
kernels (K3, K4, K5) vs plain version: bf16 atol 2e-2, fp32 1e-4; K5's
log-sum-exp 1e-3 of its scale. SAM, kernels vs plain attention on the same
weights: mask logits max |diff| <= 0.02 * max(1, std), binarised masks
(logit > 0) equal on >= 99% of pixels, IoU predictions within 2e-2. The
image embedding (8.4 million values of unit std after the neck's
LayerNorm) is held against the bf16 rounding floor of the model: the same
model in fp32 with plain attention is run too, and the kernels' embedding
may lie no further (max |diff|) from the plain bf16 embedding than that
lies from the fp32 one (or 0.02 * max(1, std), whichever is larger), and
its root-mean-square difference from the fp32 one may be at most 1.25
times the plain bf16 embedding's. (A flat 0.02 * std is below that floor:
SAM-B's plain bf16 embedding lies 0.034-0.037 from its fp32 one.) Under the
seeded init the encoder's attention nearly averages (scores of std ~0.35),
so SAM-B is compared once more with the qkv weights and rel-pos tables
redrawn to give scores and rel terms of unit std (``sharpen_attention_``;
the run fails if the logits' std is below 1, or if zeroing the rel-pos
tables leaves the bf16 embedding within the RMS bound below of the fp32
one, so that the check could not see a missing bias). There the masks and IoU
predictions are held against the floor as well: mask max |diff| from the
plain path within the larger of the flat bound and the plain path's own
from fp32, mask RMS difference from fp32 within 1.25 times the plain
path's, binarised masks apart from fp32's on at most the larger of 1% and
1.25 times the plain path's share of pixels, IoU within the larger of 2e-2
and the plain path's difference from fp32.

Rel-pos attention backward kernels (K3, K4, K5) vs their plain versions:
drel_h and drel_w (fp32 sums of dS0) within the attention tolerance's
fraction (bf16 2e-2, fp32 1e-4) of the larger of their largest plain
values; both runs of the backward bit for bit equal. dq, dk, dv (K3: the
packed dqkv) are held to the plain version's floor, since a flat 2e-2 is
about a third of a typical gradient element at SAM-B's global blocks
(scores of std ~1.7 over 4,096 keys): by ``key_bias_reading`` (bf16: RMS
distance from the plain version's fp32 computation of the same inputs at
most 1.25x the plain bf16 version's, max distance at most the plain
version's plus one bf16 ulp of the largest value; fp32: 1e-4 of the plain
RMS, and for K3 and K4 also max |kernel - plain| <= 1e-4); a control that
runs the backward kernels with rel_w zeroed on one 64-row query tile (K5
with the forward's output and log-sum-exp kept; K3 and K4, whose backward
recomputes the softmax, after a forward of the same inputs) fails the run
unless it fails that reading; in bf16 each of K5's two walks' device ms
(``split_ms``, from torch.profiler). K5's bf16 backward (``flash_relpos_bwd.cu``) must show
HGMMA (``wgmma``) in the SASS of both walks' kernels at every head-dim
shape and KW mode, no kernel of it may spill or have its ``wgmma``
pipeline serialized by ptxas, and ``flash_attention.cu``'s library must
hold no bf16 kernel. SAM
training: the train CLI's loss finite on every step and its last epoch's
mean below its first's; K3 16 forward and 8 backward launches and K5 8
and 4 a step (checkpointing runs each block's forward twice). SAM
gradients (one bf16 micro-batch of 2 images, the first decoder pass, the
qkv weights and rel-pos tables sharpened as above): per parameter,
relative L2 distance from the same model's fp32 gradients with plain
attention at most the larger of 5e-2 and 1.25 times the plain bf16 path's
(every rel-pos table included, whose gradient comes through drel alone;
the mask decoder's attention key biases, whose exact gradient is zero, left
out by ``zero_gradient_leaves``), and the loss's relative distance
likewise.

K6 (key-bias streaming attention) vs its plain version at SAM2-B+'s
shapes (the memory cross-attention with the memory bias of frame 7 and of
frame 1, the memory self-attention, the Hiera global block at d = 64 with
the 56-wide scale and at d = 56), held to the plain version's own floor,
since a flat 2e-2 is about twice a typical output there (outputs of std
~sqrt(e / valid keys), 0.0097 with 28,704 valid keys): bf16, against the
plain version's computation of the same inputs in fp32, the kernel's RMS
difference at most 1.25x the plain bf16 version's and its max |difference|
at most the plain version's plus one bf16 ulp of the largest output; fp32,
max |kernel - plain| at most 1e-4 of the output's RMS (and, in either
dtype, within the flat atol of the other kernels); the log-sum-exp
within 1e-3 of its scale. A control masks the first 64 valid keys too and
fails the run unless that breaks the same check. In bf16 a second run of
the forward gives the same bits, out and lse (the key splits of SAM2's
memory attention merge in a fixed order), and where keys are masked a run
with the masked keys' k and v replaced by noise does too (the empty slots'
key tiles are skipped, the other masked keys weigh exactly 0). The bf16
forward kernels of K5 and K6 (``flash_attention_fwd.cu``) must show HGMMA
(``wgmma``) in the SASS of the built library, every walk kernel at every
head-dim shape, no kernel of it may spill or have its ``wgmma``
pipeline serialized by ptxas (C7511, C7515, C7519 in its ``-v`` output,
where the run compiled it). K1 with Hiera's scale and K2 at
d = 56 at Hiera's four window shapes: as K1 and K2 above. SAM2 tracking,
kernels vs plain attention on the same sharpened weights (Hiera's qkv and
the memory attention's q and k projections LeCun-normal, the memory
cross-attention's key projections scaled so that the first layer's scores
have unit std over a row's valid keys), over every
frame's mask logits, IoU predictions and object logits: mask max |diff|
within the larger of 0.02 * max(1, std) and the plain bf16 path's from the
fp32 path, mask RMS from fp32 within 1.25x the plain path's, binarised
masks apart from fp32's on at most the larger of 1% and 1.25x the plain
path's share, IoU and object logits within the larger of 2e-2 and the
plain path's difference from fp32. The control runs the kernels with the
memory key bias zeroed, so that empty slots are attended to, and the run
fails unless its mask RMS from fp32 exceeds the bound.

K8 (the fused attention block) vs its plain version at ViT-B/16's shapes
(the train micro-batch and the eval batch at d = 64, d = 128, N = 50 and N
= 1024), each in bf16 and fp32, held to the plain version's floor, since
the plain version (the JAX ``_reference_block``) rounds qkv + bias and
proj + bias before the residual add where the kernel rounds once: in bf16,
against the plain version's computation of the same inputs in fp32, y's
and dx's RMS difference at most 1.25x the plain bf16 version's, and each of
dWqkv, dbqkv (its key third, whose exact gradient is 0, left out), dWproj,
dbproj, dgamma and dbeta (fp32 sums over 12,608 to 50,432 rows) within a
relative L2 difference of the larger of 1e-2 and 1.25x the plain version's;
in fp32, max |kernel - plain| at most 1e-4 of the plain result's RMS; two
backward runs bit for bit equal; a control runs the forward with gamma set
to ones and fails the run unless that fails the same check. ViT-B/16 with
use_fused_block: logits by the rule above; K8 12 launches an eval batch
and none of K1; the train CLI K8 1 and K1 11 forward and backward a
micro-batch (K8 12 an eval batch), and its last epoch's mean loss below
its first's; the gradients of one micro-batch at drop-path 0 (K8 12 and
K7 12 forward and backward) by the rule above, and with
use_gradient_checkpoint (K8 24 forward, 12 backward) by the same rule
against the unchecked kernels' gradients. K8's GEMM alone
(``attn_block.gemm``), each of its six products (qkv, proj, dattn, dxn,
dWproj, dWqkv, each at its operand layout and epilogue) at ViT-B/16's train
micro-batch (M = 12,608, C = 768) and at a ragged shape (C = 192, M = 591),
against its plain version (``gemm_reference``: an fp32 product of the same
bf16 operands, the epilogue in fp32, rounded once): fp32 outputs max
|kernel - plain| at most 1e-4 of the plain result's RMS (sum-order noise is
~1e-6 of it); bf16 outputs, where an fp32 sum-order difference can move the
rounding by one bf16 ulp, |kernel - plain| at most 2^-7 of the larger of the
two plus 1e-4 of the plain result's RMS at every element. Every
``attn_block_gemm_bf16`` kernel must show HGMMA (``wgmma``) in the SASS of
``attn_block``'s library, no kernel of that library HMMA (``mma.sync``),
and, where the run compiled it, ptxas must report no spill and no
serialized ``wgmma`` pipeline in the GEMM's kernels.

K9 (attention over a packed [B, N, 3, H, D] qkv) vs its plain version,
forward and packed dqkv, at ViT-B/16's and ViT-H/14's shapes, n_real 150,
fp32 and d = 35: as K1 and K2 (bf16 atol 2e-2, fp32 1e-4), and at d = 64 (and
128) its output and gradient bit for bit K1's on the same memory. K2b (K2
with a full score bias) vs its plain version at SAM-B's windows (bias std
0.3 and 3), SAM-H's, a bias shared over the windows [1, H, N, N], n_real
150, fp32, a bf16 bias, d = 35 and N = 1024, held to the plain version's
floor as K6 is, since a flat 2e-2 can be twice an output: out, dq, dk, dv by
``key_bias_reading`` (bf16: RMS distance from the plain version's fp32
computation at most 1.25x the plain bf16 version's, max at most the plain
version's plus one bf16 ulp; fp32: max |kernel - plain| at most 1e-4 of the
plain RMS); dbias in the bias's shape and dtype, a bf16 dbias by the same
reading, an fp32 dbias (whose plain floor is 0: the plain version rounds
nothing on the way to dS0) within a relative L2 distance of 1e-4 of the
plain one; two backward runs bit for bit equal. A control raises one row of
the bias by 4 on half its keys and fails the run unless that fails the
forward's reading and one gradient's. On K3's SAM-B inputs, K2b with the
rel-pos bias materialised matches K3's output by the same reading (K3 as
the plain version) and its dbias, summed by key-grid row and column, K3's
drel_h and drel_w within a relative L2 distance of 1e-4.

K6's backward vs its plain version at the SAM2 train step's shapes (the
memory cross-attention with frame 7's bias and with frames 1-3's, whose
empty slots the bf16 backward skips, the self-attention, the Hiera global
blocks of 4 frames at d = 64 with the 56-wide scale and at d = 56; fp32 at
the self-attention): each of dq, dk and dv by the forward's reading
(``key_bias_reading``, against the plain backward's fp32 computation of
the same inputs), masked keys' dk and dv exactly 0, in bf16 the keys' sum
of dk (0 but for rounding, since each row of dS0 sums to 0; over the
keys' sum of |dk|) at most 1.25 times the plain version's, two runs of the
backward equal bit for bit, and a control that masks 64 more valid keys
and must fail the reading. The bf16 backward's kernels must show HGMMA
(``wgmma``) in the SASS of the built library. SAM2
training: the train CLI's loss finite on every step and its last epoch's
mean below its first's, K1 36 / 18 and K6 62 / 59 forward / backward
launches a step at 8 frames (30 / 27 at 4); SAM2 gradients (one bf16
micro-batch of the 4-frame recipe, refinement off since a click drawn from
one run's own predictions would differ between runs, Hiera's qkv and the
memory attention's q and k sharpened as for the tracker) held like SAM's:
per parameter, relative L2 distance from the fp32 plain path at most the
larger of 5e-2 and 1.25 times the plain bf16 path's, read both through
the model's plain attention and through the kernels' plain versions (the
same math summed in another order, which lands up to ~2x apart on a
gradient that is a small residue) and the larger taken, the loss
likewise, and a control with the memory key bias zeroed that must fail.
Left out, by a rule on the fp32 gradients (``zero_gradient_leaves``), are
the biases whose gradient is zero up to rounding: the mask decoder's
attention key biases, which softmax cancels. The memory attention's 8 key
biases, rotated by RoPE after the projection, have a real gradient, a
small residue of a cancellation, whose distance from the fp32 model moved
with other layers' atomics from run to run; each is held on its own
layer's inputs and output gradient, recorded in the kernel run: its
relative L2 distance from that layer's gradient recomputed at float64
with plain attention at most the larger of 5e-2 and 1.25 times the plain
bf16 paths' (the module's plain attention and the kernels' plain
versions, run on the same recorded inputs). Every parameter of layer 3's
self-attention (``HELD_LAYERS``), whose q_proj bias came within its
whole-model floor's noise when K1 moved to wgmma, is held the same way.
The control must fail the reading of the other parameters.

K1 and K2 at the MAE shapes, and K2 at DINOv3's: the kernel phase's
tolerances (bf16 atol 2e-2, two backward runs bit for bit equal). The
training BatchNorm on a bf16 channels_last map against ``F.batch_norm`` in
fp32: y within BN_ATOL (a few bf16 ulps at |y| <= 4), dx, dgamma and dbeta
within a relative L2 distance of BN_GRAD_REL, the running variance Flax's
(biased) within 1e-4. DINOv3 ViT gradients (one bf16 micro-batch, the RoPE
rescale held at one draw, the qkv weights redrawn LeCun-normal): as MAE's,
by ``gradient_reading``, with a control that drops every K2 call's last
DINOV3_CONTROL_KEYS keys. MAE ViT-B/16 gradients (one
bf16 micro-batch of 32 images, the blocks' qkv weights redrawn
LeCun-normal so that scores have unit std, the masking noise fixed): per
parameter, relative L2 distance from the same model's fp32 gradients with
plain attention at most the larger of 5e-2 and 1.25 times the plain bf16
path's, and the loss likewise (``gradient_reading``); the control drops
every attention's last 8 keys in the kernels and must fail that reading.
"""

import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SMOKE_DIR = REPO / "build" / "smoke"

# One H100 SXM at its 700 W limit (NVIDIA data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor cores / FMA
BF16_ATOL, FP32_ATOL = 2e-2, 1e-4
LN_BF16_ATOL, LN_SUM_RTOL = 6.25e-2, 1e-3
GRAD_REL_L2, GRAD_LOSS_ATOL = 5e-2, 2e-2
VIT_B_BATCHES, BATCH = 2, 256
VIT_H_DEPTH = 4
SAM_BATCH = 8
SAM_H_DEPTH, SAM_H_GLOBAL = 4, (3,)   # of 32 blocks, global (7, 15, 23, 31)
SAM_ATOL_SCALE, SAM_AGREE, SAM_IOU_ATOL = 0.02, 0.99, 2e-2
SAM_FLOOR_RATIO = 1.25
# SAM2's memory attention layers whose every parameter is held on the
# layer's own recorded inputs against a float64 recompute (as the 8 key
# biases are), not against the fp32 model: layer 3's self-attention, whose
# q_proj bias read 0.0594 against its whole-model floor of 0.0523 (plain
# bf16 paths 0.0418) with K1's wgmma kernels, where the mma.sync ones' worst
# reading was 0.090 against 0.105 on another parameter
HELD_LAYERS = ("memory_attention.layers.3.self_attn",)
ZERO_GRADIENT_RATIO = 1e-4  # a bias's gradient norm over its weight's
K6_FLOOR_RATIO, K6_FP32_RTOL, K6_CONTROL_KEYS = 1.25, 1e-4, 64
K2B_DBIAS_RTOL, K2B_CONTROL_UNITS = 1e-4, 4.0
K8_FLOOR_RATIO, K8_FP32_RTOL, K8_GRAD_REL = 1.25, 1e-4, 1e-2
K8_GEMM_RTOL, K8_GEMM_BF16_ULP = 1e-4, 2.0 ** -7
K8_GEMM_KERNELS = 5   # attn_block_gemm_bf16's layout and epilogue templates
SAM_SHARP_BATCH, SAM_SHARP_SEED, SAM_SHARP_MIN_STD = 2, 1, 1.0
SAM_TRAIN_IMAGES = 16       # 2 steps an epoch at SAM_BATCH
SAM_GRAD_BATCH = 2          # images of the SAM gradient checks
SAM_GRAD_SEED = 3
MICRO_BATCHES = 4           # the train config's accumulation_steps
TRAIN_IMAGES, EVAL_IMAGES = 512, 256
SAM2_FRAMES = 8             # 1 prompted + 7 tracked: every memory slot valid
SAM2_SHARP_SEED = 5
# the head_dim_padding=0 tracker's cut Hiera: blocks 0, 2, 5 windowed (K2),
# 4 global (K6 at d = 56), 1, 3, 6 pooled
SAM2_D56_BLOCKS, SAM2_D56_GLOBAL = (1, 2, 3, 1), (4,)
SAM2_TRAIN_FRAMES, SAM2_TRAIN_CLIPS = 8, 2   # the CLI: 2 steps an epoch
SAM2_STEP_FRAMES = 4        # the timed step: bench_sam2_train.py's recipe
SAM2_GRAD_SEED = 7
PACKAGE = "simpleaicv_pytorch_training_examples_tpu_torch"
# phases a-g (10f-10l): the JPEG fixtures and the ImageNet slice's sizes
JPEG_FIXTURES = REPO / "tests" / "torch_port_data" / "jpeg"
JPEG_MEAN_TOL = 1.0         # libjpeg builds may round the IDCT differently
JPEG_DECODE_ROUNDS = 8
JPEG_CLASSES = 8
RESNET_TRAIN_IMAGES, RESNET_EVAL_IMAGES = 512, 256    # 2 steps at 256
LOADER_IMAGES = 4096           # phase b: 16 batches of 256, 2 per worker
LOADER_BATCHES_NO_WORKERS = 3
CIFAR_TRAIN_IMAGES, CIFAR_TEST_IMAGES = 512, 256      # 4 steps at 128
IN21K_TRAIN_IMAGES = 512                              # 2 steps at 256
IN21K_CLASSES, IN21K_ROOTS = 10450, 100   # the config's classes, two levels
# phases a-h of the MAE and distillation slice (26-33)
MAE_BATCH = 1024                # the MAE configs' batch
MAE_IMAGES = 1024               # phase b: 1 step an epoch
MAE_ONE_BATCH = 64              # phase c's one-batch run
MAE_GRAD_BATCH, MAE_GRAD_SEED = 32, 9
MAE_CONTROL_KEYS = 8            # keys the gradient control drops
MAE_DEPTH = 4                   # ViT-L/16 and ViT-H/14 encoder blocks kept
IMAGENET_STEPS = 1251           # ImageNet-1K's train steps at batch 1024
MUON_PARAMS = {"lr": 4e-3, "weight_decay": 5e-2}
MUON_STEPS = 8
CONFIG_MICRO_CAP = 256          # phase h: images of 224^2 a micro-batch
CONFIGS_OF_THIS_SLICE = (
    *(f"imagenet/resnet{n}" for n in (18, 34, 101, 152)),
    *(f"imagenet/resnet{n}_vit_aug_imagenet21k_pretrain"
      for n in (50, 101, 152)),
    *(f"cifar100/resnet{n}cifar" for n in (34, 50, 101, 152)),
    *(f"imagenet21k/resnet{n}_semantic_softmax_1k_pretrain"
      for n in (101, 152)),
    *(f"imagenet/{net}_for_official_mae_pretrain"
      for net in ("vit_large_patch16", "vit_huge_patch14")),
    *(f"imagenet/{net}_for_self_train_mae_pretrain"
      for net in ("vit_base_patch16", "vit_large_patch16",
                  "vit_huge_patch14")))

VIT_B_CONFIG = """
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
    SyntheticClassificationDataset)


class config:
    network = "vit_base_patch16"
    num_classes = 1000
    input_image_size = 224
    model = backbones.__dict__[network](
        image_size=input_image_size, global_pool=True,
        num_classes=num_classes, dtype=torch.bfloat16,
        use_fused_attention=True)
    test_dataset = SyntheticClassificationDataset(
        n={n}, image_size=input_image_size, num_classes=num_classes, seed=0)
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = {batch}
    num_workers = 0
"""

# The port's train config (experiments/imagenet/
# vit_base_patch16_for_official_mae_pretrain/train_config.py) with the seeded
# synthetic dataset in place of ImageNet, without the transforms that need
# PIL or cv2, and with the number of epochs cut.
VIT_B_TRAIN_CONFIG = """
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones, losses
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, RandomErasing, TorchRandomHorizontalFlip,
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
    SyntheticClassificationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.mixupcutmixclassificationcollator import (
    MixupCutmixClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose


class config:
    network = "vit_base_patch16"
    num_classes = 1000
    input_image_size = 224
    model = backbones.__dict__[network](
        image_size=input_image_size, drop_path_prob=0.1, global_pool=True,
        num_classes=num_classes, dtype=torch.bfloat16,
        use_fused_attention=True)
    load_state_dict("{trained_model_path}", model)
    train_criterion = losses.OneHotLabelCELoss()
    test_criterion = losses.CELoss()
    train_dataset = SyntheticClassificationDataset(
        n={n_train}, image_size=input_image_size, num_classes=num_classes,
        seed=2, transform=Compose([TorchRandomHorizontalFlip(prob=0.5),
                                   RandomErasing(prob=0.25)]))
    test_dataset = SyntheticClassificationDataset(
        n={n_eval}, image_size=input_image_size, num_classes=num_classes,
        seed=3)
    train_collater = MixupCutmixClassificationCollater(
        use_mixup=True, mixup_alpha=0.8, cutmix_alpha=1.0,
        mixup_cutmix_prob=1.0, switch_to_cutmix_prob=0.5, mode="batch",
        correct_lam=True, label_smoothing=0.1, num_classes=num_classes)
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = 256
    num_workers = 0
    accumulation_steps = 4
    optimizer = ("AdamW", {{
        "lr": 4e-3, "global_weight_decay": False, "weight_decay": 5e-2,
        "lr_layer_decay": 0.65, "lr_layer_decay_block": 12,
        "block_name": "blocks.",
        "no_weight_decay_layer_name_list": ["pos_embed", "cls_token"]}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 5, "min_lr": 1e-6}})
    epochs = {epochs}
    print_interval = 1
    use_amp = True
    use_ema_model = False
    ema_model_decay = 0.9999
"""

# The port's SAM-B train config (experiments/interactive_segmentation/
# sam_b_training/train_config.py) with the seeded synthetic dataset in place
# of SA-1B, batch 8 without worker processes, and the epochs cut.
SAM_B_TRAIN_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation import losses
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.sam_segmentation_dataset import (
    SAMCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.syntheticdataset import (
    SyntheticSAMDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models import (
    sam_b)


class config:
    network = "sam_b"
    input_image_size = 1024
    model = sam_b(image_size=input_image_size, use_gradient_checkpoint=True,
                  use_flash_attention=True)
    load_state_dict("", model)
    train_criterion = losses.SAMLoss(
        alpha=0.25, gamma=2, focal_loss_weight=20, dice_loss_weight=1,
        iou_predict_loss_weight=1, supervise_all_iou=True,
        mask_threshold=0.0)
    train_dataset = SyntheticSAMDataset(n={n_train}, image_size=(768, 1024),
                                        seed=4)
    test_dataset = None
    train_collater = SAMCollater(resize=input_image_size, n_points=9,
                                 prompt_probs=(0.5, 0.25, 0.25))
    decoder_iters = 4
    seed = 0
    batch_size = {batch}
    num_workers = 0
    accumulation_steps = 1
    optimizer = ("AdamW", {{
        "lr": 1e-4, "global_weight_decay": False, "weight_decay": 1e-4,
        "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 0, "min_lr": 1e-6}})
    epochs = {epochs}
    print_interval = 1
    save_interval = 1
    use_amp = True
    use_ema_model = False
"""


# The port's SAM2-B+ stage-2 train config (experiments/
# video_interactive_segmentation/hiera_b_plus_stage2/train_config.py) with
# seeded synthetic clips in place of SA-V, batch 1 without worker processes,
# no stage-1 checkpoint, and the epochs cut.
SAM2_B_TRAIN_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation import losses
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets.sam2_video_segmentation_dataset import (
    SAM2VideoBatchCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets.syntheticdataset import (
    SyntheticSAM2VideoDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models import (
    sam2_hiera_base_plus_video)


class config:
    network = "sam2_hiera_base_plus_video"
    input_image_size = 1024
    frame_nums = {frames}
    model = sam2_hiera_base_plus_video(
        image_size=input_image_size, use_gradient_checkpoint=True,
        use_scan=True, use_high_res_features=True, use_flash_attention=True,
        head_dim_padding=64, memory_cond_slots=2)
    train_criterion = losses.SAM2Loss()
    train_dataset = SyntheticSAM2VideoDataset(
        n={n_train}, frame_nums=frame_nums, image_size=(768, 1024), seed=6)
    test_dataset = None
    train_collater = SAM2VideoBatchCollater(
        resize=input_image_size, frame_nums=frame_nums, n_points=2,
        prompt_probs=(0.5, 0.25, 0.25), extra_cond_frames=1,
        point_iter_frame_num=2)
    decoder_point_iters = 2
    seed = 0
    batch_size = 1
    num_workers = 0
    accumulation_steps = 1
    optimizer = ("AdamW", {{
        "lr": 5e-5, "global_weight_decay": False, "weight_decay": 1e-4,
        "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 1, "min_lr": 1e-6}})
    epochs = {epochs}
    print_interval = 1
    save_interval = 1
    use_amp = True
    use_ema_model = False
"""


class OneBatchConfig:
    """Constant-lr AdamW for the one-batch runs (no warm-up, no decay)."""
    optimizer = ("AdamW", {"lr": 1e-3, "weight_decay": 0.0})
    scheduler = ("MultiStepLR", {"warm_up_epochs": 0, "gamma": 1.0,
                                 "milestones": []})
    epochs = 1


def log(phase, **fields):
    """One line per phase, ending with the card's name once it is known."""
    if log.card is not None:
        fields["card"] = log.card
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


log.card = None


def phase_start(name):
    """Close the running phase, printing its wall seconds on a line of its
    own, and start ``name`` (None: none)."""
    now = time.perf_counter()
    if phase_start.current is not None:
        label, t0 = phase_start.current
        print(f"[phase {label} seconds] {now - t0:.1f}", flush=True)
    phase_start.current = None if name is None else (name, now)


phase_start.current = None


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3, device_only=True):
    """Milliseconds per call of ``fn`` between two CUDA events. With
    ``device_only`` the card first spins for ~0.1 s, so the host queues the
    calls ahead of it and the events bracket device time alone, however slow
    the host is at launching; without, the host's pace counts, as it does
    for a user's train or eval step."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if device_only:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, h, n, d, n_real, dtype_name, element_size):
    """Least time (ms) of one attention launch on this card, and what bounds
    it: q and the output in full, k and v for the n_real keys that count,
    against 4*b*h*n*n_real*d operations."""
    nbytes = element_size * b * h * d * (2 * n + 2 * n_real)
    flops = 4.0 * b * h * n * n_real * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernel(torch, F, fa, name, case, results):
    """Hold one kernel against its plain version at one shape; time both
    and SDPA; append the record to results[name]."""
    dtype = case["dtype"]
    n_real = case.get("n_real")
    _, qkv, (q, k, v), (b, h, n, d) = attention_inputs(torch, name, case)
    scale = case.get("sm_scale")   # Hiera's 56^-0.5 on 64-wide heads
    if name == "K1":
        kernel = lambda: fa.fused_attention_dense(qkv, h, n_real, scale)
        plain = lambda: fa.fused_attention_dense_reference(qkv, h, n_real,
                                                           scale)
    else:
        kernel = lambda: fa.fused_attention(q, k, v, n_real)
        plain = lambda: fa.fused_attention_reference(q, k, v, n_real)
    mask = None
    if n_real is not None:
        mask = (torch.arange(n, device="cuda") < n_real)[None, :]
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                     scale=scale)

    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = (out.float() - ref.float()).abs().max().item()
    tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
    dtype_name = str(dtype).split(".")[-1]
    bound_ms, bound_by = attention_bound(b, h, n, d,
                                         n if n_real is None else n_real,
                                         dtype_name, out.element_size())
    record = {"case": case["label"], "shape": list(case["shape"]),
              "dtype": dtype_name, "n_real": n_real, "sm_scale": scale,
              "max_abs_err": err, "tol": tol,
              "finite": bool(torch.isfinite(out).all()),
              "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
              "library_ms": time_ms(torch, library), "bound_ms": bound_ms,
              "bound_by": bound_by}
    log(f"{name} {case['label']}", **record)
    if not (record["finite"] and err <= tol):
        raise AssertionError(f"{name} {case['label']}: max |kernel - plain| "
                             f"{err} > {tol} or non-finite output")
    results.setdefault(name, []).append(record)


def attention_backward_bound(b, h, n, d, n_real, dtype_name, element_size):
    """Least time (ms) of one attention backward on this card: q, dout, dq,
    dk and dv in full and k, v for the n_real keys that count, against the
    five products, 10*b*h*n*n_real*d operations."""
    nbytes = element_size * b * h * d * (5 * n + 2 * n_real)
    flops = 10.0 * b * h * n * n_real * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def attention_inputs(torch, name, case):
    """qkv and its [B, H, N, D] views q, k, v for one case, from its seed."""
    dtype = case["dtype"]
    gen = torch.Generator(device="cuda").manual_seed(case["seed"])
    if name == "K1":
        b, n, h, d = case["shape"]
    else:
        b, h, n, d = case["shape"]
    if name == "K1" or case.get("packed"):
        qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen,
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        qkv = None
        q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen,
                               dtype=torch.float32).to(dtype)
                   for _ in range(3))
    return gen, qkv, (q, k, v), (b, h, n, d)


def check_backward_kernel(torch, F, fa, name, case, results):
    """Hold one attention backward kernel against its plain version at one
    shape with a seeded dout; time both and SDPA's backward alone (its
    forward is run once, outside the timed loop); append the record to
    results[name + " bwd"]."""
    dtype = case["dtype"]
    n_real = case.get("n_real")
    gen, qkv, (q, k, v), (b, h, n, d) = attention_inputs(torch, name, case)
    if name == "K1":
        dout = torch.randn(b, n, h * d, device="cuda", generator=gen,
                           dtype=torch.float32).to(dtype)
        dout_heads = dout.view(b, n, h, d).transpose(1, 2)
        leaf = qkv.detach().requires_grad_()
        out = fa.fused_attention_dense(leaf, h, n_real)
        kernel_bwd = lambda: torch.autograd.grad(out, leaf, dout,
                                                 retain_graph=True)
        plain = lambda: (fa.fused_attention_dense_backward_reference(
            qkv, dout, h, n_real),)
        names = ("dqkv",)
    else:
        # the gradient of the attention module's transpose back to [B, N, C]
        dout_heads = torch.randn(b, n, h, d, device="cuda", generator=gen,
                                 dtype=torch.float32).to(dtype).transpose(1, 2)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fa.fused_attention(*leaves, n_real)
        kernel_bwd = lambda: torch.autograd.grad(out, leaves, dout_heads,
                                                 retain_graph=True)
        plain = lambda: fa.fused_attention_backward_reference(
            q, k, v, dout_heads, n_real)
        names = ("dq", "dk", "dv")
    mask = None
    if n_real is not None:
        mask = (torch.arange(n, device="cuda") < n_real)[None, :]
    lib_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask)
    library = lambda: torch.autograd.grad(lib_out, lib_leaves, dout_heads,
                                          retain_graph=True)

    before = getattr(fa, "fused_attention_dense" if name == "K1"
                     else "fused_attention").backward_launches
    got = kernel_bwd()
    again = kernel_bwd()
    torch.cuda.synchronize()
    reproducible = all(torch.equal(g, g2) for g, g2 in zip(got, again))
    ref = plain()
    errs = {nm: (g.float() - r.float()).abs().max().item()
            for nm, g, r in zip(names, got, ref)}
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    after = getattr(fa, "fused_attention_dense" if name == "K1"
                    else "fused_attention").backward_launches - 1
    tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
    dtype_name = str(dtype).split(".")[-1]
    bound_ms, bound_by = attention_backward_bound(
        b, h, n, d, n if n_real is None else n_real, dtype_name,
        q.element_size())
    record = {"case": case["label"], "shape": list(case["shape"]),
              "dtype": dtype_name, "n_real": n_real,
              "max_abs_err": max(errs.values()), "errs": errs, "tol": tol,
              "grad_scale": max(r.float().abs().max().item() for r in ref),
              "finite": finite, "reproducible": reproducible,
              "ms": time_ms(torch, kernel_bwd),
              "plain_ms": time_ms(torch, plain, iters=5, warmup=1),
              "library_ms": time_ms(torch, library), "bound_ms": bound_ms,
              "bound_by": bound_by}
    log(f"{name} bwd {case['label']}", **record)
    if after != before + 1:
        raise AssertionError(f"{name} bwd {case['label']}: the autograd "
                             f"backward launched its kernel {after - before} "
                             "times, expected 1")
    if not (finite and record["max_abs_err"] <= tol):
        raise AssertionError(f"{name} bwd {case['label']}: max |kernel - "
                             f"plain| {errs} > {tol} or non-finite output")
    if not reproducible:
        raise AssertionError(f"{name} bwd {case['label']}: two runs differ")
    results.setdefault(name + " bwd", []).append(record)


def check_layer_norm(torch, F, ln, case, results):
    """Hold K7 forward and backward against their plain versions at one
    shape; time both and F.layer_norm (with gamma and beta rounded to the
    activation dtype, which K7 never does: a yardstick only)."""
    dtype = case["dtype"]
    rows, c = case["shape"]
    gen = torch.Generator(device="cuda").manual_seed(case["seed"])
    rand = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    x = (2.0 * rand(rows, c) + 0.5).to(dtype)
    gamma = 1.0 + 0.1 * rand(c)
    beta = 0.1 * rand(c)
    dy = rand(rows, c).to(dtype)

    leaves = [t.detach().requires_grad_() for t in (x, gamma, beta)]
    counts = (ln.layer_norm.launches, ln.layer_norm.backward_launches)
    y = ln.layer_norm(*leaves)
    kernel_bwd = lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)
    dx, dgamma, dbeta = kernel_bwd()
    torch.cuda.synchronize()
    counts = (ln.layer_norm.launches - counts[0],
              ln.layer_norm.backward_launches - counts[1])
    y_ref = ln.layer_norm_reference(x, gamma, beta)
    dx_ref, dgamma_ref, dbeta_ref = ln.layer_norm_backward_reference(
        x, gamma, dy)
    err = lambda a, r: (a.float() - r.float()).abs().max().item()
    sum_scale = max(dgamma_ref.abs().max().item(),
                    dbeta_ref.abs().max().item())
    tol = LN_BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
    errs = {"y": err(y, y_ref), "dx": err(dx, dx_ref),
            "dgamma": err(dgamma, dgamma_ref), "dbeta": err(dbeta, dbeta_ref)}
    again = kernel_bwd()
    reproducible = all(torch.equal(a, b)
                       for a, b in zip(again, (dx, dgamma, dbeta)))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (y, dx, dgamma, dbeta))

    lib_dtype_params = [gamma.to(dtype).requires_grad_(),
                        beta.to(dtype).requires_grad_()]
    lib_x = x.detach().requires_grad_()
    library_fwd = lambda: F.layer_norm(lib_x, (c,), *lib_dtype_params, 1e-6)
    lib_y = library_fwd()
    library_bwd = lambda: torch.autograd.grad(
        lib_y, [lib_x] + lib_dtype_params, dy, retain_graph=True)
    element_size = x.element_size()
    common = {"case": case["label"], "shape": [rows, c],
              "dtype": str(dtype).split(".")[-1], "tol": tol,
              "finite": finite, "bound_by": "bytes"}
    fwd = dict(common, max_abs_err=errs["y"],
               ms=time_ms(torch, lambda: ln.layer_norm(x, gamma, beta)),
               plain_ms=time_ms(torch, lambda: ln.layer_norm_reference(
                   x, gamma, beta), iters=5, warmup=1),
               library_ms=time_ms(torch, library_fwd),
               bound_ms=1e3 * (2 * rows * c * element_size
                               + 8 * (rows + c)) / HBM_BYTES_PER_S)
    bwd = dict(common, max_abs_err=max(errs["dx"], errs["dgamma"],
                                       errs["dbeta"]),
               errs=errs, sum_scale=sum_scale, reproducible=reproducible,
               ms=time_ms(torch, kernel_bwd),
               plain_ms=time_ms(torch, lambda: ln.layer_norm_backward_reference(
                   x, gamma, dy), iters=5, warmup=1),
               library_ms=time_ms(torch, library_bwd),
               bound_ms=1e3 * (3 * rows * c * element_size
                               + 8 * rows + 12 * c) / HBM_BYTES_PER_S)
    log(f"K7 fwd {case['label']}", **fwd)
    log(f"K7 bwd {case['label']}", **bwd)
    if counts != (1, 1):
        raise AssertionError(f"K7 {case['label']}: launched {counts}, "
                             "expected one forward and one backward")
    sums_ok = max(errs["dgamma"], errs["dbeta"]) <= LN_SUM_RTOL * sum_scale
    if not (finite and reproducible and errs["y"] <= tol
            and errs["dx"] <= tol and sums_ok):
        raise AssertionError(f"K7 {case['label']}: {errs} against tol {tol} "
                             f"(sums: {LN_SUM_RTOL} of {sum_scale}), "
                             f"finite {finite}, reproducible {reproducible}")
    results.setdefault("K7", []).append(fwd)
    results.setdefault("K7 bwd", []).append(bwd)


def rel_attention_bound(b, h, n, n_keys, d, kh, kw, dtype_name,
                        element_size, lse=False):
    """Least time (ms) of one rel-pos attention launch on this card, and what
    bounds it: q and the output in full, k and v for the keys that count,
    the fp32 rel_h and rel_w (and K5's fp32 log-sum-exp) once, against
    4*b*h*n*n_keys*d operations."""
    nbytes = (element_size * b * h * d * (2 * n + 2 * n_keys)
              + 4 * b * h * n * (kh + kw + (1 if lse else 0)))
    flops = 4.0 * b * h * n * n_keys * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_rel_kernel(torch, F, name, case, results):
    """Hold K3, K4 or K5 against its plain version at one shape; time the
    kernel, the plain version and SDPA with the bias expanded to
    [B, H, N, N] in the input dtype outside the timed region (a yardstick,
    never used by the port); append the record to results[name]."""
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        flash_attention as fl, fused_attention as fa)
    dtype = case["dtype"]
    b, h, kh, kw, d = case["shape"]
    n = kh * kw
    n_real = case.get("n_real")
    gen = torch.Generator(device="cuda").manual_seed(case["seed"])
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    if name == "K3" or case.get("packed"):
        qkv = randn(b, n, 3 * h * d).to(dtype)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (randn(b, h, n, d).to(dtype) for _ in range(3))
    if name == "K3":    # [B, N, H, K], as the attention module makes them
        rel_h, rel_w = randn(b, n, h, kh), randn(b, n, h, kw)
        kernel = lambda: fa.fused_attention_relwin_dense(qkv, rel_h, rel_w, h)
        plain = lambda: fa.fused_attention_relwin_dense_reference(
            qkv, rel_h, rel_w, h)
        heads_h, heads_w = rel_h.transpose(1, 2), rel_w.transpose(1, 2)
    else:
        rel_h, rel_w = randn(b, h, n, kh), randn(b, h, n, kw)
        heads_h, heads_w = rel_h, rel_w
        if name == "K4":
            kernel = lambda: fa.fused_attention_relwin(q, k, v, rel_h, rel_w,
                                                       n_real)
            plain = lambda: fa.fused_attention_relwin_reference(
                q, k, v, rel_h, rel_w, n_real)
        else:
            kernel = lambda: fl.flash_attention_relpos(q, k, v, rel_h, rel_w,
                                                       return_lse=True)
            plain = lambda: fl.flash_attention_relpos_reference(
                q, k, v, rel_h, rel_w, return_lse=True)
    with torch.no_grad():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        out, ref = (got[0], want[0]) if name == "K5" else (got, want)
        if name == "K3":
            ref = ref.view(b, n, h, d).transpose(1, 2)
            out = out.view(b, n, h, d).transpose(1, 2)
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
        record = {"case": case["label"], "shape": list(case["shape"]),
                  "dtype": str(dtype).split(".")[-1], "n_real": n_real,
                  "max_abs_err": err, "tol": tol,
                  "finite": bool(torch.isfinite(out).all())}
        if name == "K5":
            record["lse_err"] = (got[1] - want[1]).abs().max().item()
            record["lse_scale"] = want[1].abs().max().item()
            record["finite"] &= bool(torch.isfinite(got[1]).all())
        del got, want, out, ref
        iters = 3 if n > 1024 else 20
        record["ms"] = time_ms(torch, kernel, iters=5 * iters)
        record["plain_ms"] = time_ms(torch, plain, iters=iters, warmup=1)
        bias = (heads_h[..., :, None] + heads_w[..., None, :]).reshape(
            b, h, n, n)
        if n_real is not None:
            bias[..., n_real:] = -1e9
        bias = bias.to(dtype)
        record["library_ms"] = time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias), iters=iters)
        del bias
    record["bound_ms"], record["bound_by"] = rel_attention_bound(
        b, h, n, n if n_real is None else n_real, d, kh, kw,
        record["dtype"], q.element_size(), lse=name == "K5")
    log(f"{name} {case['label']}", **record)
    lse_ok = name != "K5" or record["lse_err"] <= 1e-3 * max(
        1.0, record["lse_scale"])
    if not (record["finite"] and err <= tol and lse_ok):
        raise AssertionError(f"{name} {case['label']}: max |kernel - plain| "
                             f"{err} > {tol}, non-finite output or LSE off")
    results.setdefault(name, []).append(record)


def rel_attention_backward_bound(b, h, n, n_keys, d, kh, kw, dtype_name,
                                 element_size, flash=False):
    """Least time (ms) of one rel-pos attention backward on this card: q,
    dout, dq, dk, dv in full and k, v for the keys that count (K5 also reads
    the output and the fp32 log-sum-exp), the fp32 rel_h and rel_w read and
    their gradients written once, against the five products,
    10*b*h*n*n_keys*d operations."""
    rows = 5 * n + 2 * n_keys + (n if flash else 0)
    nbytes = (element_size * b * h * d * rows
              + 4 * b * h * n * (2 * (kh + kw) + (1 if flash else 0)))
    flops = 10.0 * b * h * n * n_keys * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_rel_backward_kernel(torch, F, name, case, results):
    """Hold the backward of K3, K4 or K5 against its plain version at one
    shape with a seeded dout: drel_h and drel_w within the attention
    tolerance's fraction of their largest plain value; dq, dk, dv (K3: the
    packed dqkv) at the plain version's floor (``key_bias_reading``: bf16
    against the plain version's fp32 computation of the same inputs; K3's
    and K4's fp32 also within the flat fp32 tolerance), and a control that
    runs the backward kernels with rel_w zeroed on one 64-row query tile
    (K5: the forward's output and lse kept; K3 and K4, whose backward
    recomputes the softmax, after a forward of the same inputs) must fail
    that reading; two backward runs bit for bit equal. Time the backward
    kernels alone (the graph is kept; K5 in bf16 also each of its two
    kernels' device ms, ``kernel_split_ms``), the plain backward and SDPA's
    backward with the bias expanded to [B, H, N, N] and requiring grad (a
    yardstick, never used by the port; the bias gradient is not reduced to
    drel); append the record to results[name + " bwd"]."""
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        flash_attention as fl, fused_attention as fa)
    dtype = case["dtype"]
    b, h, kh, kw, d = case["shape"]
    n = kh * kw
    n_real = case.get("n_real")
    gen = torch.Generator(device="cuda").manual_seed(case["seed"] + 100)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    if name == "K3" or case.get("packed"):
        qkv = randn(b, n, 3 * h * d).to(dtype)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (randn(b, h, n, d).to(dtype) for _ in range(3))
    if name == "K3":
        rel_h, rel_w = randn(b, n, h, kh), randn(b, n, h, kw)
        dout = randn(b, n, h * d).to(dtype)
        leaves = [t.detach().requires_grad_() for t in (qkv, rel_h, rel_w)]
        out = fa.fused_attention_relwin_dense(*leaves, h)
        plain = lambda: fa.fused_attention_relwin_dense_backward_reference(
            qkv, rel_h, rel_w, dout, h)
        heads = lambda t: t.transpose(1, 2)
        dout_heads = dout.view(b, n, h, d).transpose(1, 2)
        wrapper = fa.fused_attention_relwin_dense
    else:
        rel_h, rel_w = randn(b, h, n, kh), randn(b, h, n, kw)
        dout = dout_heads = randn(b, n, h, d).to(dtype).transpose(1, 2)
        leaves = [t.detach().requires_grad_()
                  for t in (q, k, v, rel_h, rel_w)]
        heads = lambda t: t
        if name == "K4":
            out = fa.fused_attention_relwin(*leaves, n_real)
            plain = lambda: fa.fused_attention_relwin_backward_reference(
                q, k, v, rel_h, rel_w, dout, n_real)
            wrapper = fa.fused_attention_relwin
        else:
            out, lse = fl.flash_attention_relpos(*leaves, return_lse=True)
            plain = lambda: fl.flash_attention_relpos_backward_reference(
                q, k, v, rel_h, rel_w, dout)
            wrapper = fl.flash_attention_relpos
    kernel_bwd = lambda: torch.autograd.grad(out, leaves, dout,
                                             retain_graph=True)
    before = wrapper.backward_launches
    got = kernel_bwd()
    torch.cuda.synchronize()
    launched = wrapper.backward_launches - before
    again = kernel_bwd()
    reproducible = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    bf16 = dtype == torch.bfloat16
    # the control: rel_w zeroed on one query tile, in both walks' logits
    rows = slice(64 * (n // 128), 64 * (n // 128) + 64)
    dropped = rel_w.clone()
    if name == "K3":    # [B, N, H, KW]
        dropped[:, rows] = 0.0
    else:               # [B, H, N, KW]
        dropped[:, :, rows] = 0.0
    if name == "K5":
        control = fl.flash_attention_relpos_backward(
            q, k, v, rel_h, dropped, dout, out.detach(), lse)
    else:
        inputs = (qkv, rel_h, dropped) if name == "K3" else (
            q, k, v, rel_h, dropped)
        c_leaves = [t.detach().requires_grad_() for t in inputs]
        c_out = wrapper(*c_leaves, h if name == "K3" else n_real)
        control = torch.autograd.grad(c_out, c_leaves, dout)
        del c_out, c_leaves
    del dropped
    want = plain()
    if name == "K3":   # the packed dqkv against the plain one
        names, got_att, want_att = ("dqkv",), got[:1], want[:1]
    else:
        names, got_att, want_att = ("dq", "dk", "dv"), got[:3], want[:3]
    err = lambda a, r: (a.float() - r.float()).abs().max().item()
    errs = {nm: err(g, r) for nm, g, r in zip(names, got_att, want_att)}
    drel_scale = max(r.abs().max().item() for r in want[-2:])
    drel_errs = {nm: err(g, r) for nm, g, r in zip(
        ("drel_h", "drel_w"), got[-2:], want[-2:])}
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    readings, control_readings, floor_ok, control_ok = {}, {}, True, True
    with torch.no_grad():
        if not bf16:
            exact = (None,) * 3
        elif name == "K3":
            exact = fa.fused_attention_relwin_dense_backward_reference(
                qkv.float(), rel_h, rel_w, dout.float(), h)
        elif name == "K4":
            exact = fa.fused_attention_relwin_backward_reference(
                q.float(), k.float(), v.float(), rel_h, rel_w, dout.float(),
                n_real)
        else:
            exact = fl.flash_attention_relpos_backward_reference(
                q.float(), k.float(), v.float(), rel_h, rel_w, dout.float())
        for nm, g, r, e, c in zip(names, got_att, want_att, exact, control):
            ok, readings[nm] = key_bias_reading(torch, g, r, e)
            c_ok, control_readings[nm] = key_bias_reading(torch, c, r, e)
            floor_ok &= ok
            control_ok &= c_ok
    del exact, control, got, want
    tol = BF16_ATOL if bf16 else FP32_ATOL
    dtype_name = str(dtype).split(".")[-1]
    big = n > 1024
    record = {"case": case["label"], "shape": list(case["shape"]),
              "dtype": dtype_name, "n_real": n_real,
              "max_abs_err": max(errs.values()), "errs": errs, "tol": tol,
              "drel_errs": drel_errs, "drel_scale": drel_scale,
              "drel_tol": tol * drel_scale, "finite": finite,
              "reproducible": reproducible,
              "ms": time_ms(torch, kernel_bwd, iters=10 if big else 20),
              "plain_ms": time_ms(torch, plain, iters=2 if big else 5,
                                  warmup=1),
              "readings": readings, "control": control_readings}
    if name == "K5" and bf16:   # the dQ walk and the dK/dV walk, device ms
        record["split_ms"] = {
            kernel.replace("flash_relpos_bwd_", ""): value
            for kernel, value in kernel_split_ms(
                torch, kernel_bwd, K5_BWD_KERNELS).items()}
    lib_q, lib_k, lib_v = (t.detach().requires_grad_() for t in (q, k, v))
    bias = (heads(rel_h)[..., :, None] + heads(rel_w)[..., None, :]).reshape(
        b, h, n, n)
    if n_real is not None:
        bias[..., n_real:] = -1e9
    bias = bias.to(dtype).requires_grad_()
    lib_out = F.scaled_dot_product_attention(lib_q, lib_k, lib_v,
                                             attn_mask=bias)
    record["library_ms"] = time_ms(
        torch, lambda: torch.autograd.grad(
            lib_out, (lib_q, lib_k, lib_v, bias), dout_heads,
            retain_graph=True), iters=3 if big else 20, warmup=1)
    del lib_out, bias
    record["bound_ms"], record["bound_by"] = rel_attention_backward_bound(
        b, h, n, n if n_real is None else n_real, d, kh, kw, dtype_name,
        q.element_size(), flash=name == "K5")
    log(f"{name} bwd {case['label']}", **record)
    if launched != 1:
        raise AssertionError(f"{name} bwd {case['label']}: the autograd "
                             f"backward launched its kernels {launched} "
                             "times, expected 1")
    # K3's and K4's fp32 gradients keep the flat fp32 tolerance too
    attention_ok = floor_ok and (name == "K5" or bf16
                                 or record["max_abs_err"] <= tol)
    if not (finite and reproducible and attention_ok
            and max(drel_errs.values()) <= tol * drel_scale):
        raise AssertionError(f"{name} bwd {case['label']}: max |kernel - "
                             f"plain| {errs}, readings {readings}, drel "
                             f"{drel_errs} (scale {drel_scale}), tol {tol}, "
                             f"finite {finite}, reproducible {reproducible}")
    if control_ok:
        raise AssertionError(f"{name} bwd {case['label']}: rel_w zeroed on "
                             f"one query tile passes the check "
                             f"({control_readings})")
    results.setdefault(name + " bwd", []).append(record)


def slot_bias(torch, b, slots, slot_tokens, valid_slots, pointers,
              pointer_tokens, valid_pointers):
    """SAM2's key bias [B, slots * slot_tokens + pointers * pointer_tokens]:
    0 on the first ``valid_slots`` memory slots and ``valid_pointers``
    pointer slots, -1e9 on the empty ones."""
    bias = torch.full((b, slots * slot_tokens + pointers * pointer_tokens),
                      -1e9, device="cuda")
    bias[:, :valid_slots * slot_tokens] = 0.0
    start = slots * slot_tokens
    bias[:, start:start + valid_pointers * pointer_tokens] = 0.0
    return bias


def key_bias_attention_bound(b, h, nq, n_keys, n_valid, d, dtype_name,
                             element_size):
    """Least time (ms) of one K6 launch on this card, and what bounds it: q,
    k, v and the output once, the fp32 bias and log-sum-exp once, against
    4*b*h*nq*d operations for each key that is not masked (a masked key's
    weight is exactly 0 unless a row's keys are all masked)."""
    nbytes = (element_size * b * h * d * (2 * nq + 2 * n_keys)
              + 4 * b * n_keys + 4 * b * h * nq)
    flops = 4.0 * b * h * nq * n_valid * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def key_bias_reading(torch, out, plain, exact):
    """K6's output held to its plain version's own floor. In bf16 against
    ``exact``, the plain version's computation of the same inputs in fp32:
    the RMS difference at most K6_FLOOR_RATIO times the plain bf16
    version's, and the max |difference| at most the plain version's plus
    one bf16 ulp of the largest output (where the two round a value to
    neighbouring bf16 numbers). In fp32 (``exact`` None): max |out - plain|
    at most K6_FP32_RTOL of the plain output's RMS. Returns (ok, readings)."""
    rms = lambda t: t.float().pow(2).mean().sqrt().item()
    if exact is None:
        err = (out - plain).abs().max().item()
        bound = K6_FP32_RTOL * rms(plain)
        return err <= bound, {"max_err": err, "max_bound": bound}
    d_out, d_plain = out.float() - exact, plain.float() - exact
    ulp = 2.0 ** (math.floor(math.log2(exact.abs().max().item())) - 7)
    reading = {"rms_err": rms(d_out), "plain_rms_err": rms(d_plain),
               "max_err": d_out.abs().max().item(),
               "plain_max_err": d_plain.abs().max().item(), "ulp": ulp}
    ok = (reading["rms_err"] <= K6_FLOOR_RATIO * reading["plain_rms_err"]
          and reading["max_err"] <= reading["plain_max_err"] + ulp)
    return ok, reading


def key_bias_inputs(torch, case):
    """q, k, v of one K6 case in its caller's layout (Hiera's packed qkv,
    or SAM2's RoPEAttention with q and v transposed views), its bias and
    scale, from the case's seed."""
    dtype = case["dtype"]
    b, h, nq, nk, d = case["shape"]
    gen = torch.Generator(device="cuda").manual_seed(case["seed"])
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(dtype)
    if case["layout"] == "packed":      # Hiera's global block
        qkv = randn(b, nq, 3 * h * d)
        q, k, v = qkv.view(b, nq, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:                               # SAM2's RoPEAttention
        q = randn(b, nq, h, d).transpose(1, 2)
        k = randn(b, h, nk, d)
        v = randn(b, nk, h, d).transpose(1, 2)
    return gen, (q, k, v), case.get("bias"), case.get("sm_scale")


def check_key_bias_kernel(torch, F, case, results):
    """Hold K6 against its plain version at one shape: the output by
    ``key_bias_reading``, the log-sum-exp within 1e-3 of its scale; a
    control runs the kernel with the first K6_CONTROL_KEYS valid keys
    masked too, which must fail the same reading. In bf16 a second run must
    give the same bits, out and lse (the key splits merge in a fixed order),
    and where keys are masked, a run with the masked keys' k and v replaced
    by noise must too (empty tiles skipped, masked keys at P = 0); the
    record takes the forward's kernels' device ms (``kernel_split_ms``:
    the walk and the splits' merge). Time the kernel, the plain version and
    SDPA with the bias as a broadcast [B, 1, 1, Nk] mask in the input dtype
    (a yardstick, never used by the port); append the record to
    results["K6"]."""
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        flash_attention as fl)
    dtype = case["dtype"]
    b, h, nq, nk, d = case["shape"]
    _, (q, k, v), bias, scale = key_bias_inputs(torch, case)
    kernel = lambda: fl.flash_attention(q, k, v, bias, scale, return_lse=True)
    plain = lambda: fl.flash_attention_reference(q, k, v, bias, scale,
                                                 return_lse=True)
    mask = None if bias is None else bias[:, None, None, :].to(dtype)
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                     scale=scale)
    # every case's first keys are valid (slot 0 of the memory)
    dropped = (torch.zeros(b, nk, device="cuda") if bias is None
               else bias.clone())
    dropped[:, :K6_CONTROL_KEYS] = -1e9
    with torch.no_grad():
        out, lse = kernel()
        control = fl.flash_attention(q, k, v, dropped, scale)
        torch.cuda.synchronize()
        ref, ref_lse = plain()
        exact = (fl.flash_attention_reference(q.float(), k.float(), v.float(),
                                              bias, scale)
                 if dtype == torch.bfloat16 else None)
        ok, reading = key_bias_reading(torch, out, ref, exact)
        control_ok, control_reading = key_bias_reading(torch, control, ref,
                                                       exact)
        record = {"case": case["label"], "shape": list(case["shape"]),
                  "dtype": str(dtype).split(".")[-1], "sm_scale": scale,
                  "masked_keys": 0 if bias is None
                  else int((bias[0] < -1e8).sum()),
                  "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                  **reading, "control": control_reading,
                  "lse_err": (lse - ref_lse).abs().max().item(),
                  "lse_scale": ref_lse.abs().max().item(),
                  "finite": bool(torch.isfinite(out).all()
                                 and torch.isfinite(lse).all())}
        fast = dtype == torch.bfloat16
        if fast:
            again = kernel()
            record["reproducible"] = (torch.equal(out, again[0])
                                      and torch.equal(lse, again[1]))
            if record["masked_keys"]:
                masked = bias[0] < -1e8
                noise_gen = torch.Generator(device="cuda").manual_seed(
                    case["seed"] + 1)
                noise = lambda t: t.masked_fill(
                    masked[None, None, :, None], 0) + 100 * torch.randn(
                        t.shape, device="cuda", generator=noise_gen).to(
                            dtype) * masked[None, None, :, None]
                noisy = fl.flash_attention(q, noise(k), noise(v), bias, scale,
                                           return_lse=True)
                record["masked_noise_same_bits"] = (
                    torch.equal(out, noisy[0]) and torch.equal(lse, noisy[1]))
                del noisy
            record["split_ms"] = {
                name.replace("flash_", ""): value for name, value in
                kernel_split_ms(torch, kernel, K6_FWD_KERNELS).items()}
            del again
        del out, lse, ref, ref_lse, exact, control
        record["ms"] = time_ms(torch, kernel, iters=20 if fast else 2,
                               warmup=3 if fast else 1)
        record["plain_ms"] = time_ms(torch, plain, iters=5 if fast else 2,
                                     warmup=1)
        record["library_ms"] = time_ms(torch, library, iters=20 if fast else 2,
                                       warmup=3 if fast else 1)
    n_valid = nk - record["masked_keys"]
    record["bound_ms"], record["bound_by"] = key_bias_attention_bound(
        b, h, nq, nk, n_valid, d, record["dtype"], q.element_size())
    log(f"K6 {case['label']}", **record)
    lse_ok = record["lse_err"] <= 1e-3 * max(1.0, record["lse_scale"])
    flat = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
    if not (record["finite"] and ok and record["max_abs_err"] <= flat
            and lse_ok):
        raise AssertionError(f"K6 {case['label']}: output off its plain "
                             f"version's floor ({reading}), non-finite "
                             "output or LSE off")
    if not (record.get("reproducible", True)
            and record.get("masked_noise_same_bits", True)):
        raise AssertionError(f"K6 {case['label']}: a second run, or one with "
                             "the masked keys' k and v replaced by noise, "
                             "changed the output's or the lse's bits")
    if control_ok:
        raise AssertionError(f"K6 {case['label']}: masking {K6_CONTROL_KEYS} "
                             f"more keys passes the check ({control_reading})"
                             "; it cannot see a lost key tile")
    results.setdefault("K6", []).append(record)


def key_bias_backward_bound(b, h, nq, n_keys, n_valid, d, dtype_name,
                            element_size):
    """Least time (ms) of one K6 backward on this card, and what bounds it:
    q, dout, the output and dq over the queries and k, v, dk, dv over the
    keys once, the fp32 bias and log-sum-exp once, against the five
    products, 10*b*h*nq*d operations for each key that is not masked (a
    masked key's P is exactly 0, so it adds nothing)."""
    nbytes = (element_size * b * h * d * (4 * nq + 4 * n_keys)
              + 4 * b * n_keys + 4 * b * h * nq)
    flops = 10.0 * b * h * nq * n_valid * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# the forward's kNoBias kernels end their mangled names with MODE 0 and
# the params type; 18 of them (six chunk shapes, three head-dim tails), and
# the backward's 20 (17 dQ kernels, no 5-chunk one at D > 80, and 3 dK/dV);
# the backward's biased modes (MODE 1, kRelBias: K3/K4; 2, kFullBias: K2b)
# 20 each
NO_BIAS_FWD = "ELi0EEEvNS1_9FwdParamsE"
SHORT_NO_BIAS_KERNELS = 18 + 20
SHORT_BIASED_BWD_KERNELS = 2 * 20
K6_BWD_KERNELS = ("flash_keybias_bwd_delta", "flash_keybias_bwd_dq",
                  "flash_keybias_bwd_dkv", "flash_keybias_bwd_reduce")
# K5's bf16 backward (flash_relpos_bwd.cu): the dQ and the dK/dV walk, each
# at 7 shapes (D <= 64 and D = 80 with and without the key-grid mode, D =
# 128, 192, 256)
K5_BWD_KERNELS = ("flash_relpos_bwd_dq", "flash_relpos_bwd_dkv")
K5_BWD_SHAPES = 7
# the bf16 forward (flash_attention_fwd.cu): K6's walk at 5 head-dim shapes,
# with and without P's residual; K5's at 3 with rel_w in registers (D <=
# 128) and at 5 with both rel terms read each score; and the splits' merge
K6_FWD_KERNELS = ("flash_keybias_fwd", "flash_fwd_merge")
FLASH_FWD_KERNELS = {"flash_keybias_fwd": 10, "flash_relpos_fwd": 8}


def hgmma_counts(library, op="HGMMA"):
    """{kernel: HGMMA instructions} (or instructions of another opcode
    ``op``) in the SASS of a built library, by ``cuobjdump -sass`` from the
    CUDA toolkit that built it."""
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        build)
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = 0
        elif name is not None and re.search(rf"\b{op}\b", line):
            counts[name] += 1
    return counts


def kernel_split_ms(torch, fn, names, iters=3):
    """{name: (device ms a call of fn, launches a call)} of the kernels named
    in ``names``, from torch.profiler over ``iters`` calls, each
    synchronised, after a warm-up step that the profiler records and drops
    (without it the first call's first kernels can go unrecorded)."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=iters,
                                       repeat=1)
    with torch.profiler.profile(activities=activities,
                                schedule=schedule) as prof:
        for _ in range(1 + iters):
            fn()
            torch.cuda.synchronize()
            prof.step()
    split = {n: [0.0, 0] for n in names}
    for event in prof.key_averages():
        found = re.search(r"\b(\w+)(<[^>]*>)?\(", event.key)
        if found and found.group(1) in split:
            us = getattr(event, "device_time_total", None)
            if us is None:
                us = event.cuda_time_total
            split[found.group(1)][0] += us / 1e3 / iters
            split[found.group(1)][1] += event.count / iters
    return {n: (ms, launches) for n, (ms, launches) in split.items()}


def check_key_bias_backward_kernel(torch, F, case, results):
    """Hold K6's backward against its plain version at one shape with a
    seeded dout (a transposed view, as autograd hands it through the
    module's transpose back to tokens): each of dq, dk, dv, and the output
    of the forward a gradient follows (P.V at fp32 precision of P), by
    ``key_bias_reading`` against the plain version's fp32 computation of
    the same inputs, and masked keys' dk and dv exactly 0; in bf16 the
    keys' sum of dk, 0 but for rounding (each row of dS0 sums to 0), its
    norm over the keys' sum of |dk| at most K6_FLOOR_RATIO times the plain
    version's; a control runs forward and backward with the first
    K6_CONTROL_KEYS valid keys masked too, which must fail the same
    reading; in bf16 a second run of the backward must equal the first bit
    for bit, and the record takes each of the backward's kernels' device ms
    (``kernel_split_ms``). Time the backward alone (the
    forward run once, outside the timed loop), the plain backward and
    SDPA's backward with the bias as a [B, 1, 1, Nk] mask (a yardstick,
    never used by the port), and the forward at the same shape with a
    gradient to follow (P.V at fp32 precision of P in bf16) and without,
    beside the forward's bound; append the record to results["K6 bwd"]."""
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        flash_attention as fl)
    dtype = case["dtype"]
    b, h, nq, nk, d = case["shape"]
    gen, (q, k, v), bias, scale = key_bias_inputs(torch, case)
    dout = torch.randn(b, nq, h, d, device="cuda", generator=gen).to(
        dtype).transpose(1, 2)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fl.flash_attention(*leaves, bias, scale)
    kernel = lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
    plain = lambda: fl.flash_attention_backward_reference(q, k, v, bias, dout,
                                                          scale)
    dropped = (torch.zeros(b, nk, device="cuda") if bias is None
               else bias.clone())
    dropped[:, :K6_CONTROL_KEYS] = -1e9
    before = fl.flash_attention.backward_launches
    got = kernel()
    torch.cuda.synchronize()
    launched = fl.flash_attention.backward_launches - before
    reproducible = all(torch.equal(x, y) for x, y in zip(got, kernel()))
    control = torch.autograd.grad(fl.flash_attention(*leaves, dropped, scale),
                                  leaves, dout)
    with torch.no_grad():
        ref = plain()
        exact = (fl.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), bias, dout.float(), scale)
                 if dtype == torch.bfloat16 else (None,) * 3)
        out_exact = (fl.flash_attention_reference(
            q.float(), k.float(), v.float(), bias, scale)
                     if dtype == torch.bfloat16 else None)
        out_ok, out_reading = key_bias_reading(
            torch, out.detach(), fl.flash_attention_reference(q, k, v, bias,
                                                              scale),
            out_exact)
    names = ("dq", "dk", "dv")
    readings, control_readings, oks, control_oks = {"out": out_reading}, {}, \
        [out_ok], []
    for name, g, r, e, c in zip(names, got, ref, exact, control):
        ok, readings[name] = key_bias_reading(torch, g, r, e)
        control_ok, control_readings[name] = key_bias_reading(torch, c, r, e)
        oks.append(ok)
        control_oks.append(control_ok)
    if dtype == torch.bfloat16:
        key_sum = lambda dk: (dk.float().sum(dim=2).norm()
                              / dk.float().abs().sum(dim=2).norm()).item()
        readings["dk_key_sum"] = {"kernel": key_sum(got[1]),
                                  "plain": key_sum(ref[1])}
        oks.append(readings["dk_key_sum"]["kernel"]
                   <= K6_FLOOR_RATIO * readings["dk_key_sum"]["plain"])
    masked = (bias[0] < -1e8) if bias is not None else None
    masked_zero = masked is None or all(
        not bool(g[:, :, masked].any()) for g in got[1:])
    record = {"case": case["label"], "shape": list(case["shape"]),
              "dtype": str(dtype).split(".")[-1], "sm_scale": scale,
              "masked_keys": 0 if masked is None else int(masked.sum()),
              "max_abs_err": max((g.float() - r.float()).abs().max().item()
                                 for g, r in zip(got, ref)),
              "readings": readings, "control": control_readings,
              "masked_keys_zero": masked_zero, "launches": launched,
              "reproducible": reproducible,
              "finite": all(bool(torch.isfinite(g).all()) for g in got)}
    del ref, exact, control, out_exact
    lib_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    mask = None if bias is None else bias[:, None, None, :].to(dtype)
    lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask,
                                             scale=scale)
    library = lambda: torch.autograd.grad(lib_out, lib_leaves, dout,
                                          retain_graph=True)
    fast = dtype == torch.bfloat16
    record["ms"] = time_ms(torch, kernel, iters=10 if fast else 2,
                           warmup=2 if fast else 1)
    record["plain_ms"] = time_ms(torch, plain, iters=3, warmup=1)
    record["library_ms"] = time_ms(torch, library, iters=10 if fast else 2,
                                   warmup=2 if fast else 1)
    n_valid = nk - record["masked_keys"]
    record["bound_ms"], record["bound_by"] = key_bias_backward_bound(
        b, h, nq, nk, n_valid, d, record["dtype"], q.element_size())
    # the forward at the same shape, with a gradient to follow (bf16: P.V
    # at fp32 precision of P, one more product) and without
    record["fwd_grad_ms"] = time_ms(
        torch, lambda: fl.flash_attention(*leaves, bias, scale),
        iters=10 if fast else 2, warmup=2 if fast else 1)
    with torch.no_grad():
        record["fwd_ms"] = time_ms(
            torch, lambda: fl.flash_attention(q, k, v, bias, scale),
            iters=10 if fast else 2, warmup=2 if fast else 1)
    record["fwd_bound_ms"], _ = key_bias_attention_bound(
        b, h, nq, nk, n_valid, d, record["dtype"], q.element_size())
    if fast:    # the bf16 backward's kernels, device ms and launches a call
        record["split_ms"] = {
            name.replace("flash_keybias_bwd_", ""): value
            for name, value in kernel_split_ms(torch, kernel,
                                               K6_BWD_KERNELS).items()}
    log(f"K6 bwd {case['label']}", **record)
    del out, lib_out, got
    if not (record["finite"] and all(oks) and masked_zero and launched == 1
            and reproducible):
        raise AssertionError(f"K6 bwd {case['label']}: gradients off the "
                             f"plain version's floor ({readings}), masked "
                             f"keys with a gradient ({not masked_zero}), "
                             f"{launched} launches, not reproducible "
                             f"({not reproducible}) or non-finite")
    if all(control_oks):
        raise AssertionError(f"K6 bwd {case['label']}: masking "
                             f"{K6_CONTROL_KEYS} more keys passes the check "
                             f"({control_readings})")
    results.setdefault("K6 bwd", []).append(record)


def attn_block_bound(b, n, c, dtype_name, element_size, backward=False):
    """Least time (ms) of one K8 call on this card, and what bounds it. The
    forward's products are 8NC^2 + 4N^2C a sample (qkv, proj, Q.K^T, P.V).
    The backward, given x and dy alone, computes qkv, the scores and the
    attention output again (6NC^2 + 4N^2C) besides its own 16NC^2 + 8N^2C
    (dattn, dWproj, the four attention products, dWqkv, dxn): 22NC^2 +
    12N^2C. Bytes: x (and dy) in and y (dx) out, the weights and biases in
    (and their gradients out), gamma and beta in fp32, each once."""
    if backward:
        flops = b * (22.0 * n * c * c + 12.0 * n * n * c)
        nbytes = element_size * (3 * b * n * c + 2 * (4 * c * c + 4 * c)) \
            + 4 * 4 * c
    else:
        flops = b * (8.0 * n * c * c + 4.0 * n * n * c)
        nbytes = element_size * (2 * b * n * c + 4 * c * c + 4 * c) + 4 * 2 * c
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def attn_block_inputs(torch, case):
    """x, wqkv, bqkv, wproj, bproj, gamma, beta and dy of one K8 case from
    its seed: x and dy of unit scale, Linear weights that keep qkv and the
    scores at unit scale, small biases, gamma near 1, beta near 0."""
    b, n, h, d = case["shape"]
    c = h * d
    dtype = case["dtype"]
    gen = torch.Generator(device="cuda").manual_seed(case["seed"])
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    inputs = [randn(b, n, c).to(dtype),
              (randn(3 * c, c) * c ** -0.5).to(dtype),
              (0.02 * randn(3 * c)).to(dtype),
              (randn(c, c) * c ** -0.5).to(dtype),
              (0.02 * randn(c)).to(dtype),
              1.0 + 0.1 * randn(c), 0.1 * randn(c)]
    return inputs, randn(b, n, c).to(dtype)


def unfused_block(fa, ln, F, h):
    """The port's unfused block on K8's inputs: K7, cuBLAS, K1, cuBLAS and
    an add (a yardstick: no single PyTorch call computes the block)."""
    def block(x, wqkv, bqkv, wproj, bproj, gamma, beta):
        qkv = F.linear(ln.layer_norm(x, gamma, beta, 1e-6), wqkv, bqkv)
        return x + F.linear(fa.fused_attention_dense(qkv, h), wproj, bproj)
    return block


def attn_block_reading(torch, got, plain, exact, relative=False):
    """K8 held to its plain version's floor. fp32 (``exact`` None): max
    |got - plain| at most K8_FP32_RTOL of the plain result's RMS. bf16,
    against ``exact``, the plain version's computation of the same inputs
    in fp32: for y and dx the RMS difference at most K8_FLOOR_RATIO times
    the plain bf16 version's; for a gradient summed over the rows
    (``relative``) the relative L2 difference at most the larger of
    K8_GRAD_REL and K8_FLOOR_RATIO times the plain version's. Returns (ok,
    readings)."""
    rms = lambda t: t.float().pow(2).mean().sqrt().item()
    if exact is None:
        err = (got.float() - plain.float()).abs().max().item()
        bound = K8_FP32_RTOL * rms(plain)
        return err <= bound, {"max_err": err, "bound": bound}
    if relative:
        rel = lambda t: ((t.float() - exact).norm() / exact.norm()).item()
        reading = {"rel_l2": rel(got), "plain_rel_l2": rel(plain)}
        bound = max(K8_GRAD_REL, K8_FLOOR_RATIO * reading["plain_rel_l2"])
        return reading["rel_l2"] <= bound, dict(reading, bound=bound)
    reading = {"rms_err": rms(got.float() - exact),
               "plain_rms_err": rms(plain.float() - exact)}
    return (reading["rms_err"] <= K8_FLOOR_RATIO * reading["plain_rms_err"],
            reading)


def ptxas_findings(text, scope):
    """One library's ``ptxas -v`` output, for the kernels whose names hold
    ``scope``: (their count, their registers, their spills as {kernel:
    line}, the lines that report their ``wgmma`` pipeline serialized (C7511,
    C7515, C7519)), and for the library's other kernels the count of those
    that spill and of such serialization lines."""
    lines = text.splitlines()
    entries = [m.group(1) for m in (re.search(
        r"Compiling entry function '(\S+)'", line) for line in lines) if m]
    registers, spills, kernel = set(), {}, None
    for line in lines:
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            kernel = found.group(1)
        used = re.search(r"Used (\d+) registers", line)
        if used and kernel and scope in kernel:
            registers.add(int(used.group(1)))
        if ("spill" in line and kernel and
                " 0 bytes spill stores, 0 bytes spill loads" not in line):
            spills[kernel] = line.strip()
    warned = [line.strip() for line in lines
              if re.search(r"C75(11|15|19)", line)]
    return ({"kernels": sum(scope in e for e in entries),
             "registers": sorted(registers),
             "spills": {k: v for k, v in spills.items() if scope in k},
             "serialized": [w for w in warned if scope in w]},
            {"kernels": sum(scope not in e for e in entries),
             "spilling": sum(scope not in k for k in spills),
             "serialization_lines": sum(scope not in w for w in warned)})


def attn_block_gemm_operands(torch, m, c, seed):
    """Operands of K8's six products at M rows and width C, from a seed:
    xn, attn, dy, x and dqkv [M, 3C] of unit scale, Wqkv [3C, C] and Wproj
    [C, C] at C^-0.5 (as a Linear's), biases at 0.02; all bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s, scale=1.0: (scale * torch.randn(
        *s, device="cuda", generator=gen)).to(torch.bfloat16)
    xn, attn, dy, x = (randn(m, c) for _ in range(4))
    dqkv = randn(m, 3 * c)
    wqkv, wproj = randn(3 * c, c, scale=c ** -0.5), randn(c, c,
                                                          scale=c ** -0.5)
    bqkv, bproj = randn(3 * c, scale=0.02), randn(c, scale=0.02)
    return {"qkv": ((xn, wqkv), dict(bias=bqkv)),
            "proj": ((attn, wproj), dict(bias=bproj, resid=x)),
            "dattn": ((dy, wproj), {}),
            "dxn": ((dqkv, wqkv), {}),
            "dwproj": ((dy, attn), {}),
            "dwqkv": ((dqkv, xn), {})}


def check_attn_block_gemms(torch, results):
    """Hold each of K8's six bf16 products, run alone through
    ``attn_block.gemm`` at its operand layout and epilogue, against its
    plain version at ViT-B/16's train micro-batch and a ragged shape (C =
    192, M = 591); time each (device ms, TFLOP/s); append the records to
    results["K8 gemm"]."""
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        attn_block as ab)
    shapes = (("vit_b16_train", BATCH // MICRO_BATCHES * 197, 768, 90),
              ("ragged_c192", 3 * 197, 192, 91))
    for label, m, c, seed in shapes:
        for name, ((a, b), extra) in attn_block_gemm_operands(
                torch, m, c, seed).items():
            a_k, b_k, epilogue = ab.GEMM_PRODUCTS[name]
            run = lambda: ab.gemm(a, b, a_k, b_k, epilogue, **extra)
            before = ab.gemm.launches
            got = run()
            torch.cuda.synchronize()
            launched = ab.gemm.launches - before
            plain = ab.gemm_reference(a, b, a_k, b_k, epilogue, **extra)
            rms = plain.float().pow(2).mean().sqrt().item()
            diff = (got.float() - plain.float()).abs()
            if got.dtype == torch.float32:
                bound = K8_GEMM_RTOL * rms
                ok = diff.max().item() <= bound
            else:
                bound = (K8_GEMM_BF16_ULP * torch.maximum(
                    got.float().abs(), plain.float().abs())
                    + K8_GEMM_RTOL * rms)
                ok = bool((diff <= bound).all())
                bound = (bound - diff).min().item()   # the smallest margin
            dims = ab.gemm_shape(a, b, a_k, b_k, epilogue,
                                 extra.get("bias"), extra.get("resid"))
            ms = time_ms(torch, run)
            record = {"product": name, "case": label, "mnk": list(dims),
                      "a_kmajor": a_k, "b_kmajor": b_k, "epilogue": epilogue,
                      "dtype": str(got.dtype).split(".")[-1],
                      "max_abs_err": diff.max().item(), "plain_rms": rms,
                      ("bound" if got.dtype == torch.float32 else
                       "least_margin"): bound,
                      "differing": int((diff > 0).sum().item()),
                      "finite": bool(torch.isfinite(got).all()),
                      "ms": ms, "tflops": 2.0 * math.prod(dims) / ms / 1e9,
                      "launched": launched}
            log(f"K8 gemm {name} {label}", **record)
            if not (ok and record["finite"] and record["launched"] == 1):
                raise AssertionError(f"K8 gemm {name} {label}: off its "
                                     f"plain version ({record})")
            results.setdefault("K8 gemm", []).append(record)
            del got, plain, diff
        torch.cuda.empty_cache()


def check_attn_block(torch, F, fa, ln, case, results):
    """Hold K8 forward and backward against their plain versions at one
    shape (``attn_block_reading``; the key third of dbqkv, whose exact
    gradient is 0, left out in bf16), two backward runs bit for bit equal,
    and a control: the forward with gamma set to ones must fail the same
    reading. Time the kernel, the plain version and the port's unfused
    block (``library_ms``); append the records to results["K8"] and
    results["K8 bwd"]."""
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        attn_block as ab)
    dtype = case["dtype"]
    b, n, h, d = case["shape"]
    c = h * d
    inputs, dy = attn_block_inputs(torch, case)
    names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dgamma", "dbeta")
    bf16 = dtype == torch.bfloat16
    with torch.no_grad():
        y = ab.attn_block(*inputs, h)
        control = ab.attn_block(*inputs[:5], torch.ones_like(inputs[5]),
                                inputs[6], h)
        torch.cuda.synchronize()
        plain_y = ab.attn_block_reference(*inputs, h)
        exact_in = [t.float() for t in inputs]
        exact_y = ab.attn_block_reference(*exact_in, h) if bf16 else None
    ok_y, reading_y = attn_block_reading(torch, y, plain_y, exact_y)
    control_ok, control_reading = attn_block_reading(torch, control, plain_y,
                                                     exact_y)
    del control

    leaves = [t.detach().requires_grad_() for t in inputs]
    out = ab.attn_block(*leaves, h)
    before = ab.attn_block.backward_launches
    grads = torch.autograd.grad(out, leaves, dy, retain_graph=True)
    again = torch.autograd.grad(out, leaves, dy, retain_graph=True)
    torch.cuda.synchronize()
    launched = ab.attn_block.backward_launches - before
    repeatable = all(torch.equal(g, g2) for g, g2 in zip(grads, again))
    del again
    plain = ab.attn_block_backward_reference(*inputs, dy, h)
    exact = (ab.attn_block_backward_reference(*exact_in, dy.float(), h)
             if bf16 else (None,) * 7)
    readings, grad_ok = {}, True
    for i, (name, g, p, e) in enumerate(zip(names, grads, plain, exact)):
        if bf16 and name == "dbqkv":   # the key third's exact gradient is 0
            g, p, e = (torch.cat([t[:c], t[2 * c:]]) for t in (g, p, e))
        ok, readings[name] = attn_block_reading(torch, g, p, e,
                                                relative=i > 0)
        grad_ok = grad_ok and ok and bool(torch.isfinite(g).all())
    grad_err = max((g.float() - p.float()).abs().max().item()
                   for g, p in zip(grads, plain))
    del plain, exact, exact_in

    dtype_name = str(dtype).split(".")[-1]
    iters, warmup = (20, 3) if bf16 else (3, 1)
    library = unfused_block(fa, ln, F, h)
    with torch.no_grad():
        fwd = {"ms": time_ms(torch, lambda: ab.attn_block(*inputs, h),
                             iters=iters, warmup=warmup),
               "plain_ms": time_ms(torch, lambda: ab.attn_block_reference(
                   *inputs, h), iters=iters, warmup=warmup),
               "library_ms": time_ms(torch, lambda: library(*inputs),
                                     iters=iters, warmup=warmup)}
    lib_leaves = [t.detach().requires_grad_() for t in inputs]
    lib_out = library(*lib_leaves)
    bwd = {"ms": time_ms(torch, lambda: torch.autograd.grad(
               out, leaves, dy, retain_graph=True), iters=iters,
               warmup=warmup),
           "plain_ms": time_ms(torch, lambda: ab.attn_block_backward_reference(
               *inputs, dy, h), iters=max(2, iters // 4), warmup=1),
           "library_ms": time_ms(torch, lambda: torch.autograd.grad(
               lib_out, lib_leaves, dy, retain_graph=True), iters=iters,
               warmup=warmup)}
    del out, lib_out, grads
    common = {"case": case["label"], "shape": list(case["shape"]),
              "dtype": dtype_name,
              "library": "the port's unfused block (K7, cuBLAS, K1, cuBLAS, "
                         "add); no single PyTorch call computes it"}
    fwd_bound = attn_block_bound(b, n, c, dtype_name, inputs[0].element_size())
    bwd_bound = attn_block_bound(b, n, c, dtype_name,
                                 inputs[0].element_size(), backward=True)
    record = dict(common, **fwd, max_abs_err=(y.float() - plain_y.float())
                  .abs().max().item(), reading=reading_y,
                  control_gamma_ones=control_reading,
                  finite=bool(torch.isfinite(y).all()),
                  bound_ms=fwd_bound[0], bound_by=fwd_bound[1])
    log(f"K8 {case['label']}", **record)
    record_bwd = dict(common, **bwd, max_abs_err=grad_err,
                      readings=readings, bit_equal_rerun=repeatable,
                      bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                      counted="22NC^2 + 12N^2C (the recompute included)")
    log(f"K8 bwd {case['label']}", **record_bwd)
    if not (ok_y and record["finite"]):
        raise AssertionError(f"K8 {case['label']}: y off its plain "
                             f"version's floor ({reading_y}) or non-finite")
    if control_ok:
        raise AssertionError(f"K8 {case['label']}: gamma set to ones passes "
                             f"the check ({control_reading}); it cannot see "
                             "a lost LayerNorm scale")
    if not (grad_ok and repeatable and launched == 2):
        raise AssertionError(f"K8 bwd {case['label']}: gradients off their "
                             f"floor ({readings}), not bit for bit equal on "
                             f"a rerun ({repeatable}) or {launched} backward "
                             "launches for 2 calls")
    results.setdefault("K8", []).append(record)
    results.setdefault("K8 bwd", []).append(record_bwd)


def check_qkv_kernel(torch, F, fa, case, results):
    """Hold K9 forward and backward against their plain versions at one
    shape, with the tolerances of K1 and K2; at d = 64 and 128 its output
    and packed gradient must equal K1's on the same memory bit for bit.
    Time both directions, the plain versions and SDPA on the packed views
    with its output copied back to [B, N, H, D] (its backward alone, into
    the packed gradient); append the records to results["K9"] and
    results["K9 bwd"]."""
    dtype = case["dtype"]
    b, n, h, d = case["shape"]
    n_real = case.get("n_real")
    gen = torch.Generator(device="cuda").manual_seed(case["seed"])
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(dtype)
    qkv, dout = randn(b, n, 3, h, d), randn(b, n, h, d)
    leaf = qkv.clone().requires_grad_()
    out = fa.fused_attention_qkv(leaf, n_real)
    kernel_bwd = lambda: torch.autograd.grad(out, leaf, dout,
                                             retain_graph=True)
    before = fa.fused_attention_qkv.backward_launches
    (grad,) = kernel_bwd()
    torch.cuda.synchronize()
    launched = fa.fused_attention_qkv.backward_launches - before
    reproducible = torch.equal(grad, kernel_bwd()[0])
    with torch.no_grad():
        plain = fa.fused_attention_qkv_reference(qkv, n_real)
        plain_grad = fa.fused_attention_qkv_backward_reference(qkv, dout,
                                                               n_real)
    err = (out.float() - plain.float()).abs().max().item()
    grad_err = (grad.float() - plain_grad.float()).abs().max().item()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(grad).all())
    del plain, plain_grad
    same_as_k1 = None
    if d in fa.DENSE_HEAD_DIMS:
        dense = qkv.view(b, n, 3 * h * d).clone().requires_grad_()
        out_dense = fa.fused_attention_dense(dense, h, n_real)
        (grad_dense,) = torch.autograd.grad(out_dense, dense,
                                            dout.view(b, n, h * d))
        same_as_k1 = (torch.equal(out.view(b, n, h * d), out_dense)
                      and torch.equal(grad.view(b, n, 3 * h * d), grad_dense))
        del dense, out_dense, grad_dense
    mask = None
    if n_real is not None:
        mask = (torch.arange(n, device="cuda") < n_real)[None, :]
    sdpa = lambda t: F.scaled_dot_product_attention(
        *t.permute(2, 0, 3, 1, 4).unbind(0), attn_mask=mask).transpose(
            1, 2).contiguous()
    lib_leaf = qkv.clone().requires_grad_()
    lib_out = sdpa(lib_leaf)
    fast = dtype == torch.bfloat16
    iters, warmup = (20, 3) if fast else (5, 1)
    with torch.no_grad():
        fwd_times = {
            "ms": time_ms(torch, lambda: fa.fused_attention_qkv(qkv, n_real),
                          iters=iters, warmup=warmup),
            "plain_ms": time_ms(
                torch, lambda: fa.fused_attention_qkv_reference(qkv, n_real),
                iters=5, warmup=1),
            "library_ms": time_ms(torch, lambda: sdpa(qkv), iters=iters,
                                  warmup=warmup)}
    bwd_times = {
        "ms": time_ms(torch, kernel_bwd, iters=iters, warmup=warmup),
        "plain_ms": time_ms(
            torch, lambda: fa.fused_attention_qkv_backward_reference(
                qkv, dout, n_real), iters=3, warmup=1),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib_leaf, dout, retain_graph=True), iters=iters,
            warmup=warmup)}
    del out, lib_out, grad
    dtype_name = str(dtype).split(".")[-1]
    n_keys = n if n_real is None else n_real
    tol = BF16_ATOL if fast else FP32_ATOL
    common = {"case": case["label"], "shape": [b, n, 3, h, d],
              "dtype": dtype_name, "n_real": n_real, "tol": tol,
              "finite": finite, "same_as_k1": same_as_k1}
    record = dict(common, max_abs_err=err, **fwd_times)
    record["bound_ms"], record["bound_by"] = attention_bound(
        b, h, n, d, n_keys, dtype_name, qkv.element_size())
    record_bwd = dict(common, max_abs_err=grad_err, launches=launched,
                      reproducible=reproducible, **bwd_times)
    record_bwd["bound_ms"], record_bwd["bound_by"] = attention_backward_bound(
        b, h, n, d, n_keys, dtype_name, qkv.element_size())
    log(f"K9 {case['label']}", **record)
    log(f"K9 bwd {case['label']}", **record_bwd)
    if not (finite and err <= tol and grad_err <= tol and launched == 1
            and same_as_k1 is not False and reproducible):
        raise AssertionError(f"K9 {case['label']}: max |kernel - plain| "
                             f"{err} / {grad_err} > {tol}, non-finite, "
                             f"{launched} backward launches, not K1 bit "
                             f"for bit ({same_as_k1}) or two backward runs "
                             f"differ ({reproducible})")
    results.setdefault("K9", []).append(record)
    results.setdefault("K9 bwd", []).append(record_bwd)


def bias_attention_bound(b, h, n, n_keys, d, bias, dtype_name, element_size,
                         backward=False):
    """Least time (ms) of one K2b call on this card, and what bounds it. The
    forward reads q and writes the output in full, reads k, v and the bias
    (its own elements, at its own size) for the n_keys keys that count, and
    does 4*b*h*n*n_keys*d operations; the backward reads q and dout and
    writes dq, dk, dv in full, reads k, v and the bias for the keys that
    count, writes dbias (the bias's shape and dtype) in full, and does the
    five products, 10*b*h*n*n_keys*d."""
    bias_bytes = bias.numel() * bias.element_size()
    rows = (5 * n if backward else 2 * n) + 2 * n_keys
    nbytes = (element_size * b * h * d * rows + bias_bytes * n_keys / n
              + (bias_bytes if backward else 0))
    flops = (10.0 if backward else 4.0) * b * h * n * n_keys * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def dbias_reading(torch, got, plain, exact):
    """K2b's dbias held to its plain version. A bf16 dbias (bf16 inputs) by
    ``key_bias_reading`` against ``exact``, the plain version's fp32
    computation: both round the same fp32 sums to bf16. An fp32 dbias: the
    plain version rounds nothing on the way to dS0 but the inputs, so its
    floor against fp32 is 0; the kernel's relative L2 distance from it at
    most K2B_DBIAS_RTOL (fp32 sums in another order, and the card's exp2
    and log2 approximations). Returns (ok, readings)."""
    if got.dtype == torch.bfloat16 and exact is not None:
        return key_bias_reading(torch, got, plain, exact)
    rel = ((got.float() - plain.float()).norm() / plain.float().norm()).item()
    return rel <= K2B_DBIAS_RTOL, {"rel_l2": rel, "bound": K2B_DBIAS_RTOL}


def sdpa_backend(torch, fn):
    """The SDPA backend one call of ``fn`` ran, read from the operators that
    ``torch.profiler`` records (``aten::_scaled_dot_product_<backend>_...``
    and their autograd nodes), or "not measured" where it records none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if "scaleddotproduct" in e.key.lower().replace("_", "")})
    for backend in ("flash", "efficient", "cudnn", "math"):
        hits = [nm for nm in names if backend in nm.lower()]
        if hits:
            return f"{backend} ({', '.join(hits)})"
    return "not measured"


def bias_inputs(torch, case):
    """q, k, v [B, H, N, D], the bias (the case's shape, dtype and spread),
    dout (a transposed view, as autograd hands it through a module's
    transpose back to tokens) and the control's bias (the first row's
    first N/2 keys raised by K2B_CONTROL_UNITS) of one K2b case."""
    dtype = case["dtype"]
    b, h, n, d = case["shape"]
    gen = torch.Generator(device="cuda").manual_seed(case["seed"])
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    q, k, v = (randn(b, h, n, d).to(dtype) for _ in range(3))
    bias = (case["spread"] * randn(*case["bias_shape"])).to(
        case.get("bias_dtype", torch.float32))
    dout = randn(b, n, h, d).to(dtype).transpose(1, 2)
    control = bias.clone()
    control[(0,) * (bias.dim() - 1)][:n // 2] += K2B_CONTROL_UNITS
    return (q, k, v), bias, dout, control


def check_bias_kernel(torch, F, fa, case, results):
    """Hold K2b forward and backward against their plain versions at one
    shape, at the plain version's floor: out, dq, dk and dv by
    ``key_bias_reading`` (bf16: against the plain version's fp32
    computation of the same inputs), dbias by ``dbias_reading``, in the
    bias's shape and dtype; two backward runs bit for bit equal; a control
    that raises one row of the bias on half its keys must fail the forward's
    reading and one of the gradients'. Time both directions, the plain
    versions and SDPA with the bias (cast to the input dtype, the n_real key
    mask folded in) as its mask, the backward with the mask requiring grad,
    and name the SDPA backend that ran; append the records to
    results["K2b"] and results["K2b bwd"]."""
    dtype = case["dtype"]
    b, h, n, d = case["shape"]
    n_real = case.get("n_real")
    (q, k, v), bias, dout, control_bias = bias_inputs(torch, case)
    bf16 = dtype == torch.bfloat16
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    out = fa.fused_attention(*leaves[:3], n_real, bias=leaves[3])
    kernel_bwd = lambda: torch.autograd.grad(out, leaves, dout,
                                             retain_graph=True)
    before = fa.fused_attention_bias.backward_launches
    grads = kernel_bwd()
    again = kernel_bwd()
    torch.cuda.synchronize()
    launched = fa.fused_attention_bias.backward_launches - before
    reproducible = all(torch.equal(g, g2) for g, g2 in zip(grads, again))
    del again
    control_leaves = [t.detach().requires_grad_()
                      for t in (q, k, v, control_bias)]
    control_out = fa.fused_attention(*control_leaves[:3], n_real,
                                     bias=control_leaves[3])
    control_grads = torch.autograd.grad(control_out, control_leaves, dout)
    names = ("dq", "dk", "dv", "dbias")
    with torch.no_grad():
        plain = fa.fused_attention_bias_reference(q, k, v, bias, n_real)
        plain_grads = fa.fused_attention_bias_backward_reference(
            q, k, v, bias, dout, n_real)
        exact_in = [t.float() for t in (q, k, v, bias)]
        exact = (fa.fused_attention_bias_reference(*exact_in, n_real)
                 if bf16 else None)
        exact_grads = (fa.fused_attention_bias_backward_reference(
            *exact_in, dout.float(), n_real) if bf16 else (None,) * 4)
        del exact_in
        ok, reading = key_bias_reading(torch, out.detach(), plain, exact)
        control_ok, control_reading = key_bias_reading(
            torch, control_out.detach(), plain, exact)
        readings, control_readings, grads_ok, control_grads_ok = {}, {}, \
            True, True
        for name, g, p, e, c in zip(names, grads, plain_grads, exact_grads,
                                    control_grads):
            read = dbias_reading if name == "dbias" else key_bias_reading
            g_ok, readings[name] = read(torch, g, p, e)
            c_ok, control_readings[name] = read(torch, c, p, e)
            grads_ok &= g_ok and g.shape == p.shape and g.dtype == p.dtype
            control_grads_ok &= c_ok
        errs = {"out": (out.float() - plain.float()).abs().max().item(),
                **{nm: (g.float() - p.float()).abs().max().item()
                   for nm, g, p in zip(names, grads, plain_grads)}}
        finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    del plain, plain_grads, exact, exact_grads, control_out, control_grads
    del control_leaves, grads

    lib_bias = bias.to(dtype)
    if n_real is not None:
        lib_bias = lib_bias.masked_fill(
            torch.arange(n, device="cuda") >= n_real, -1e9)
    lib_leaves = [t.detach().requires_grad_() for t in (q, k, v, lib_bias)]
    library = lambda: F.scaled_dot_product_attention(q, k, v,
                                                     attn_mask=lib_bias)
    lib_out = F.scaled_dot_product_attention(*lib_leaves[:3],
                                             attn_mask=lib_leaves[3])
    library_bwd = lambda: torch.autograd.grad(lib_out, lib_leaves, dout,
                                              retain_graph=True)
    iters, warmup = (20, 3) if bf16 else (5, 1)
    with torch.no_grad():
        fwd_times = {
            "ms": time_ms(torch, lambda: fa.fused_attention(
                q, k, v, n_real, bias=bias), iters=iters, warmup=warmup),
            "plain_ms": time_ms(
                torch, lambda: fa.fused_attention_bias_reference(
                    q, k, v, bias, n_real), iters=5, warmup=1),
            "library_ms": time_ms(torch, library, iters=iters, warmup=warmup),
            "library_backend": sdpa_backend(torch, library)}
    bwd_times = {
        "ms": time_ms(torch, kernel_bwd, iters=iters, warmup=warmup),
        "plain_ms": time_ms(
            torch, lambda: fa.fused_attention_bias_backward_reference(
                q, k, v, bias, dout, n_real), iters=3, warmup=1),
        "library_ms": time_ms(torch, library_bwd, iters=iters, warmup=warmup),
        "library_backend": sdpa_backend(torch, library_bwd)}
    del out, lib_out, lib_leaves, leaves
    dtype_name = str(dtype).split(".")[-1]
    n_keys = n if n_real is None else n_real
    common = {"case": case["label"], "shape": [b, h, n, d],
              "bias_shape": list(bias.shape),
              "bias_dtype": str(bias.dtype).split(".")[-1],
              "bias_std": case["spread"], "dtype": dtype_name,
              "n_real": n_real, "finite": finite}
    record = dict(common, max_abs_err=errs["out"], reading=reading,
                  control=control_reading, **fwd_times)
    record["bound_ms"], record["bound_by"] = bias_attention_bound(
        b, h, n, n_keys, d, bias, dtype_name, q.element_size())
    record_bwd = dict(common, max_abs_err=max(errs[nm] for nm in names),
                      errs=errs, readings=readings, control=control_readings,
                      reproducible=reproducible, launches=launched,
                      **bwd_times)
    record_bwd["bound_ms"], record_bwd["bound_by"] = bias_attention_bound(
        b, h, n, n_keys, d, bias, dtype_name, q.element_size(), backward=True)
    log(f"K2b {case['label']}", **record)
    log(f"K2b bwd {case['label']}", **record_bwd)
    if not (finite and ok and grads_ok and reproducible and launched == 2):
        raise AssertionError(f"K2b {case['label']}: off the plain version's "
                             f"floor (out {reading}, grads {readings}), "
                             f"non-finite, not reproducible or {launched} "
                             "backward launches for 2 calls")
    if control_ok or control_grads_ok:
        raise AssertionError(f"K2b {case['label']}: a bias raised by "
                             f"{K2B_CONTROL_UNITS} on half of one row passes "
                             f"the check (out {control_reading}, grads "
                             f"{control_readings})")
    results.setdefault("K2b", []).append(record)
    results.setdefault("K2b bwd", []).append(record_bwd)


def check_bias_against_k3(torch, fa, case, results):
    """K2b with SAM's rel-pos bias materialised (``rel_bias``) against K3 on
    K3's inputs of ``case`` (drawn as ``check_rel_kernel`` draws them): the
    output by ``key_bias_reading`` with K3's output as the plain version
    (against the fp32 plain K3), and dbias summed over each key-grid row
    and column against K3's drel_h and drel_w, relative L2 at most
    K2B_DBIAS_RTOL."""
    dtype = case["dtype"]
    b, h, kh, kw, d = case["shape"]
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(case["seed"])
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    qkv = randn(b, n, 3 * h * d).to(dtype)
    rel_h, rel_w = randn(b, n, h, kh), randn(b, n, h, kw)
    dout = randn(b, n, h * d).to(dtype)
    k3_leaves = [t.detach().requires_grad_() for t in (qkv, rel_h, rel_w)]
    k3_out = fa.fused_attention_relwin_dense(*k3_leaves, h)
    _, drel_h, drel_w = torch.autograd.grad(k3_out, k3_leaves, dout)
    leaf = qkv.detach().requires_grad_()
    q, k, v = leaf.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    bias = fa.rel_bias(rel_h.transpose(1, 2),
                       rel_w.transpose(1, 2)).requires_grad_()
    out = fa.fused_attention(q, k, v, bias=bias).transpose(1, 2).reshape(
        b, n, h * d)
    (dbias,) = torch.autograd.grad(out, bias, dout)
    with torch.no_grad():
        exact = fa.fused_attention_relwin_dense_reference(qkv.float(), rel_h,
                                                          rel_w, h)
        ok, reading = key_bias_reading(torch, out, k3_out, exact)
        grid = dbias.unflatten(-1, (kh, kw))
        rel = lambda a, r: ((a - r).norm() / r.norm()).item()
        drel = {"drel_h_rel_l2": rel(grid.sum(-1).transpose(1, 2), drel_h),
                "drel_w_rel_l2": rel(grid.sum(-2).transpose(1, 2), drel_w)}
    record = {"case": case["label"], "shape": list(case["shape"]),
              "reading": reading, **drel, "drel_bound": K2B_DBIAS_RTOL}
    log(f"K2b vs K3 {case['label']}", **record)
    if not (ok and max(drel.values()) <= K2B_DBIAS_RTOL):
        raise AssertionError(f"K2b with the rel-pos bias disagrees with K3: "
                             f"{record}")
    results.setdefault("K2b vs K3", []).append(record)


def drive_qkv_and_bias(torch, fa):
    """This slice's path: no model calls K9 or K2b, so their entry points
    are driven as a user would call them, forward and backward, K9 at
    ViT-B/16's and ViT-H/14's packed qkv and K2b at SAM-B's and SAM-H's
    windows with a full fp32 bias; each output and gradient finite, of its
    input's shape, and within the attention tolerance of its plain version
    on the first sample. Returns nothing; the caller reads the counters."""
    gen = torch.Generator(device="cuda").manual_seed(90)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    for b, n, h, d in ((BATCH, 197, 12, 64), (BATCH, 257, 16, 80)):
        qkv = randn(b, n, 3, h, d).to(torch.bfloat16).requires_grad_()
        dout = randn(b, n, h, d).to(torch.bfloat16)
        out = fa.fused_attention_qkv(qkv)
        out.backward(dout)
        with torch.no_grad():
            err = max((out[:1].float() - fa.fused_attention_qkv_reference(
                qkv[:1]).float()).abs().max().item(),
                      (qkv.grad[:1].float()
                       - fa.fused_attention_qkv_backward_reference(
                           qkv[:1], dout[:1]).float()).abs().max().item())
        if not (out.shape == (b, n, h, d) and qkv.grad.shape == qkv.shape
                and torch.isfinite(out).all()
                and torch.isfinite(qkv.grad).all() and err <= BF16_ATOL):
            raise AssertionError(f"K9 entry point at {(b, n, h, d)}: "
                                 f"{err} from the plain version or non-finite")
        log("K9 entry point", shape=[b, n, 3, h, d], max_abs_err_sample0=err)
    for b, h, n, d in ((25 * SAM_BATCH, 12, 196, 64),
                       (25 * SAM_BATCH, 16, 196, 80)):
        leaves = [randn(b, h, n, d).to(torch.bfloat16).requires_grad_()
                  for _ in range(3)]
        bias = (0.3 * randn(b, h, n, n)).requires_grad_()
        dout = randn(b, h, n, d).to(torch.bfloat16)
        out = fa.fused_attention(*leaves, bias=bias)
        out.backward(dout)
        with torch.no_grad():
            first = [t[:1] for t in (*leaves, bias)]
            want = (fa.fused_attention_bias_reference(*first),
                    *fa.fused_attention_bias_backward_reference(
                        *first, dout[:1]))
            got = (out[:1], *(t.grad[:1] for t in (*leaves, bias)))
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
        if not (bias.grad.shape == bias.shape and err <= BF16_ATOL
                and all(torch.isfinite(t).all() for t in got)):
            raise AssertionError(f"K2b entry point at {(b, h, n, d)}: {err} "
                                 "from the plain version or non-finite")
        log("K2b entry point", shape=[b, h, n, d], bias_shape=[b, h, n, n],
            max_abs_err_sample0=err)


def sam_encoder_flops(model):
    """Operations of one SAM encoder forward of one image, counted from the
    model's shapes: the patch embedding, each block's qkv, proj, lin1 and
    lin2 Linears (qkv and proj over the padded windows), the attention
    products Q.K^T and P.V, the rel-pos products q.R, and the neck's two
    convolutions. LayerNorm, GELU, softmax and the adds are not counted."""
    enc = model.image_encoder
    c = enc.pos_embed.shape[-1]
    grid = enc.pos_embed.shape[1]
    patch = enc.patch_embed.patch_size
    out = enc.neck[0].out_channels
    total = 2 * grid * grid * 3 * patch * patch * c
    for block in enc.blocks:
        ws = block.window_size
        if ws:
            side = -(-grid // ws) * ws          # padded grid
            tokens, keys, k_side = side * side, ws * ws, ws
        else:
            tokens, keys, k_side = grid * grid, grid * grid, grid
        hidden = block.mlp.lin1.out_features
        total += 2 * tokens * c * 4 * c + 2 * grid * grid * c * 2 * hidden
        total += 4 * tokens * keys * c + 2 * tokens * c * 2 * k_side
    total += 2 * grid * grid * (c * out + 9 * out * out)
    return total


def sam_decoder_flops(torch, model, images, prompts):
    """Operations of one prompt-decoder pass of one image (the first of
    ``images``), counted on a forward with hooks: the prompt encoder's and
    the mask decoder's Linears and convolutions and the attention products
    of its cross attentions (the upsampling of the masks, norms and softmax
    are not counted)."""
    from torch import nn
    from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models.segment_anything.transformer import (
        SAMCrossAttention)
    total = [0]

    def count(module, args, out):
        if isinstance(module, nn.Linear):
            total[0] += 2 * out.numel() * module.in_features
        elif isinstance(module, nn.Conv2d):
            k = module.kernel_size[0] * module.kernel_size[1]
            total[0] += 2 * out.numel() * module.in_channels * k
        elif isinstance(module, nn.ConvTranspose2d):
            k = module.kernel_size[0] * module.kernel_size[1]
            total[0] += 2 * args[0].numel() * module.out_channels * k
        elif isinstance(module, SAMCrossAttention):
            q, k = args[0], args[1]
            total[0] += 4 * q.shape[1] * k.shape[1] * \
                module.q_proj.out_features * q.shape[0]
    hooks = [m.register_forward_hook(count) for part in (
        model.prompt_encoder, model.mask_decoder) for m in part.modules()]
    with torch.inference_mode():
        embedding = model.forward_image_encoder(images[:1])
        model.forward_prompt_encoder_mask_decoder(embedding, {
            k: v[:1] for k, v in prompts.items()})
    for hook in hooks:
        hook.remove()
    return total[0]


def sam_loss_and_gradients(torch, model, batch, criterion, use_amp):
    """Loss and fp32 parameter gradients of one SAM train micro-batch: the
    train tool's loss with the first decoder pass only (the clicks of later
    passes depend on each run's own predictions)."""
    from types import SimpleNamespace
    from simpleaicv_pytorch_training_examples_tpu_torch.tools.train_interactive_segmentation_model import (
        build_loss_fn)
    loss_fn = build_loss_fn(model, SimpleNamespace(
        train_criterion=criterion, decoder_iters=0, use_amp=use_amp))
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch, None)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def zero_gradient_leaves(grads_f):
    """The biases whose fp32 gradient is zero up to rounding, by a rule on
    ``grads_f``: its norm above 0 and below ZERO_GRADIENT_RATIO times its
    layer's weight gradient's. A bias's gradient sums the output gradients
    over the tokens that the weight's weighs by each token's input: where
    softmax cancels the bias (a key bias that every key of a query row
    shares), that sum is 0 but for rounding, some 1e-7 of the weight's; a
    real one is 1e-2 of it or more (the RoPE-rotated key biases of SAM2's
    memory attention included). Returns (names, the largest ratio among
    them, the smallest among the biases held)."""
    out, left, held = [], 0.0, math.inf
    for name, grad in grads_f.items():
        weight = grads_f.get(name[:-len("bias")] + "weight")
        if not name.endswith(".bias") or weight is None:
            continue
        norm = grad.norm().item()
        ratio = norm / max(weight.norm().item(), 1e-30)
        if 0 < norm and ratio < ZERO_GRADIENT_RATIO:
            out.append(name)
            left = max(left, ratio)
        elif norm > 0:
            held = min(held, ratio)
    return out, left, held


def relative_errors(grads, grads_f):
    """Per parameter, the relative L2 distance of ``grads`` from
    ``grads_f`` (0 where both are exactly 0)."""
    out = {}
    for name, ref in grads_f.items():
        diff, scale = (grads[name] - ref).norm().item(), ref.norm().item()
        out[name] = diff / scale if scale > 0 else (0.0 if diff == 0
                                                    else math.inf)
    return out


def gradient_reading(grads_k, grads_p, grads_f, losses, left_out=(),
                     held_apart=()):
    """Gradients of the kernels (``grads_k``) and of plain attention
    (``grads_p``: a list of plain bf16 paths, which compute the same math
    and may sum in other orders), held against the fp32 plain path's
    (``grads_f``): per parameter the kernels' relative L2 error may be at
    most max(GRAD_REL_L2, 1.25 x the largest plain bf16 path's), and so may
    the relative error of the loss (``losses``: kernels, the plain paths'
    as a list, fp32).
    ``left_out``: parameters whose exact gradient is 0
    (``zero_gradient_leaves``), where both paths compute rounding noise
    with no scale to hold it to; ``held_apart``: parameters the caller holds
    by a reading of its own. Returns (ok, fields, the kernels' and the
    plain path's relative errors, the floors)."""
    loss_k, plain_losses, loss_f = losses
    rel_k = relative_errors(grads_k, grads_f)
    rel_ps = [relative_errors(g, grads_f) for g in grads_p]
    for name in (*left_out, *held_apart):
        del rel_k[name]
    rel_p = {n: max(r[n] for r in rel_ps) for n in rel_k}
    floor = {n: max(GRAD_REL_L2, SAM_FLOOR_RATIO * rel_p[n]) for n in rel_k}
    worst = max(rel_k, key=lambda n: rel_k[n] / floor[n])
    loss_err = lambda x: abs(x - loss_f) / max(abs(loss_f), 1e-30)
    loss_floor = max(GRAD_REL_L2, SAM_FLOOR_RATIO * max(
        loss_err(x) for x in plain_losses))
    fields = dict(
        loss_kernels=loss_k, loss_plain=plain_losses, loss_fp32=loss_f,
        loss_rel_err=loss_err(loss_k), loss_floor=loss_floor,
        parameters=len(rel_k), left_out_zero_gradient=len(left_out),
        held_apart=len(held_apart),
        worst_parameter=worst, worst_rel_l2=rel_k[worst],
        worst_floor=floor[worst], worst_plain_rel_l2=rel_p[worst],
        median_rel_l2=sorted(rel_k.values())[len(rel_k) // 2],
        nearest={n: (rel_k[n], floor[n]) for n in sorted(
            rel_k, key=lambda n: -rel_k[n] / floor[n])[:5]})
    ok = (set(grads_k) == set(grads_f)
          and all(rel_k[n] <= floor[n] for n in rel_k)
          and loss_err(loss_k) <= loss_floor)
    return ok, fields, rel_k, rel_p, floor


def check_sam_gradients(torch, fa, ln, model, batch, criterion, label):
    """Gradients of one bf16 micro-batch with the kernels and with plain
    attention, each held against the same model in fp32 with plain
    attention (``gradient_reading``), every rel-pos table included.
    Returns the kernel run's launch counts."""
    reset_counts(fa, ln)
    loss_k, grads_k = sam_loss_and_gradients(torch, model, batch, criterion,
                                             True)
    torch.cuda.synchronize()
    counts = read_counts(fa, ln)
    model.set_flash_attention(False)
    loss_p, grads_p = sam_loss_and_gradients(torch, model, batch, criterion,
                                             True)
    loss_f, grads_f = sam_loss_and_gradients(torch, model, batch, criterion,
                                             False)
    model.set_flash_attention(True)
    # the decoder attentions' key biases add one constant to a query row's
    # scores, which softmax ignores: their exact gradient is 0
    noise_only, left_ratio, held_ratio = zero_gradient_leaves(grads_f)
    ok, fields, rel_k, rel_p, floor = gradient_reading(
        grads_k, [grads_p], grads_f, (loss_k, [loss_p], loss_f), noise_only)
    rel_pos = [n for n in rel_k if "rel_pos" in n]
    worst_rel_pos = max(rel_pos, key=lambda n: rel_k[n] / floor[n])
    log(f"{label} gradients vs plain attention", batch=len(batch["image"]),
        **fields, left_out=noise_only, left_out_max_ratio=left_ratio,
        held_min_ratio=held_ratio,
        rel_pos_tables=len(rel_pos), worst_rel_pos=worst_rel_pos,
        worst_rel_pos_rel_l2=rel_k[worst_rel_pos],
        worst_rel_pos_plain=rel_p[worst_rel_pos], launches=counts)
    if not (ok and rel_pos and noise_only
            and all(grads_f[n].norm() > 0 for n in rel_pos)):
        raise AssertionError(f"{label}: gradients with the kernels disagree "
                             f"with plain attention: {fields}")
    return counts


def sam2_loss_and_gradients(torch, model, batch, config, use_amp):
    """Loss and fp32 parameter gradients of one SAM2 train micro-batch
    through the video train tool's loss, refinement off (a click drawn
    from one run's own predictions would differ between runs)."""
    from types import SimpleNamespace
    from simpleaicv_pytorch_training_examples_tpu_torch.tools.train_video_interactive_segmentation_model import (
        build_loss_fn)
    loss_fn = build_loss_fn(model, SimpleNamespace(
        train_criterion=config.train_criterion, decoder_point_iters=0,
        use_amp=use_amp))
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch, None)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.eval()
    return loss.item(), grads


def memory_attention_calls(torch, model):
    """A context that records, for every attention of SAM2's memory
    attention (each layer's self- and cross-attention), the inputs of each
    call whose output takes a gradient and that output's gradient. Yields
    {the attention's module name: (the module, [(args, kwargs, dout),
    ...])}."""
    import contextlib
    from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2.memory import (
        RoPEAttention)

    def keep(x):
        return x.detach().clone() if torch.is_tensor(x) else x

    @contextlib.contextmanager
    def ctx():
        calls, handles = {}, []
        for name, module in model.named_modules():
            if not (name.startswith("memory_attention.")
                    and isinstance(module, RoPEAttention)):
                continue
            record = calls[name] = (module, [])

            def hook(mod, args, kwargs, out, record=record):
                if not (torch.is_grad_enabled() and out.requires_grad):
                    return
                saved = ([keep(a) for a in args],
                         {k: keep(v) for k, v in kwargs.items()})
                out.register_hook(lambda g, saved=saved: record[1].append(
                    (*saved, g.detach().clone())))
            handles.append(module.register_forward_hook(hook,
                                                        with_kwargs=True))
        try:
            yield calls
        finally:
            for handle in handles:
                handle.remove()
    return ctx()


def layer_gradients_f64(torch, module, calls):
    """The gradients of a memory attention's parameters summed over its
    recorded calls, at float64 with plain attention: the module's function
    (projections, RoPE of q and of the rotated keys, softmax attention with
    the key bias, the output projection) written out on float64 copies of
    its weights, RoPE tables and the calls' inputs and output gradients.
    Returns {parameter name in the module: gradient}."""
    from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2.memory import (
        apply_rope)
    f64 = torch.float64
    w = {n: p.detach().to(f64).requires_grad_()
         for n, p in module.named_parameters()}
    linear = lambda x, name: x @ w[name + ".weight"].T + w[name + ".bias"]
    total = {n: torch.zeros_like(t) for n, t in w.items()}
    for (q, k, v), kwargs, dout in calls:
        with torch.autocast("cuda", enabled=False):
            qp = linear(q.to(f64), "q_proj")
            kp = linear(k.to(f64), "k_proj")
            vp = linear(v.to(f64), "v_proj")
            b, nq, inter = qp.shape
            nk, nh = kp.shape[1], module.head_nums
            hd = inter // nh
            qp, kp, vp = (x.reshape(b, -1, nh, hd).transpose(1, 2)
                          for x in (qp, kp, vp))
            cos, sin = module.rope_cos.to(f64), module.rope_sin.to(f64)
            qp = apply_rope(qp, cos, sin)
            n_rope = nk - kwargs.get("num_k_exclude_rope", 0)
            if n_rope > 0:
                if module.rope_k_repeat:
                    repeat = n_rope // cos.shape[0]
                    cos, sin = cos.repeat(repeat, 1), sin.repeat(repeat, 1)
                kp = torch.cat([apply_rope(kp[:, :, :n_rope], cos, sin),
                                kp[:, :, n_rope:]], dim=2)
            s = torch.einsum("bhqd,bhkd->bhqk", qp, kp) * hd ** -0.5
            if kwargs.get("key_bias") is not None:
                s = s + kwargs["key_bias"].to(f64)[:, None, None, :]
            out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vp)
            out = linear(out.transpose(1, 2).reshape(b, nq, inter), "out_proj")
            grads = torch.autograd.grad(out, list(w.values()), dout.to(f64))
        for n, g in zip(w, grads):
            total[n] += g
    return total


def layer_gradients_bf16(torch, module, calls, use_flash):
    """The same gradients through the module itself in bf16 autocast, as the
    train step runs it: its plain attention (``use_flash`` False) or its
    attention route (the kernels, or their plain versions inside
    ``kernels_as_plain_versions``), on the recorded inputs."""
    saved = module.use_flash
    module.use_flash = use_flash
    params = dict(module.named_parameters())
    total = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    try:
        for args, kwargs, dout in calls:
            with torch.autocast("cuda", dtype=torch.bfloat16):
                out = module(*args, **kwargs)
            grads = torch.autograd.grad(out, list(params.values()), dout)
            for n, g in zip(params, grads):
                total[n] += g.float()
    finally:
        module.use_flash = saved
    return total


def held_readings(torch, calls, grads_k, held):
    """Memory attention parameters (``held``, full names), each held on its
    own layer's inputs: the kernel run's gradient (``grads_k``), whose layer
    inputs and output gradients ``calls`` recorded, against that layer's
    gradient recomputed once at float64 with plain attention on the same
    inputs (``layer_gradients_f64``); the floor is gradient_reading's rule
    over the plain bf16 paths' gradients of the same layer on the same
    inputs, the module's plain attention and the kernels' plain versions.
    Returns {name: (ok, fields)}."""
    out = {}
    for layer, (module, recorded) in calls.items():
        names = [n for n in held if n.startswith(layer + ".")]
        if not names:
            continue
        exact = layer_gradients_f64(torch, module, recorded)
        plain_attention = layer_gradients_bf16(torch, module, recorded, False)
        with kernels_as_plain_versions():
            plain_versions = layer_gradients_bf16(torch, module, recorded,
                                                  True)
        for name in names:
            key = name[len(layer) + 1:]
            rel = lambda g: ((g.double() - exact[key]).norm()
                             / exact[key].norm()).item()
            pa, pv = rel(plain_attention[key]), rel(plain_versions[key])
            floor = max(GRAD_REL_L2, SAM_FLOOR_RATIO * max(pa, pv))
            kernels = rel(grads_k[name])
            out[name] = (kernels <= floor, dict(
                calls=len(recorded), rel_l2=kernels, floor=floor,
                plain_attention=pa, plain_versions=pv))
    return out


def check_sam2_gradients(torch, fa, ln, model, batch, config, label):
    """SAM2's gradients of one bf16 micro-batch with the kernels and with
    plain attention, each held against the same model in fp32 with plain
    attention (``gradient_reading``). The plain bf16 path is read twice:
    through the model's plain attention and through the kernels' plain
    versions (``kernels_as_plain_versions``), the same math summed in
    another order, and each parameter's floor takes the larger. The memory
    attention's 8 key biases, whose gradient is a small residue of a
    cancellation (each row of dS sums to 0) and whose floor moved from run
    to run with other layers' atomics, are held apart, each on its own
    layer's inputs (``held_readings``: against a float64 recompute of
    that layer, the floor from the plain bf16 paths of the same layer on
    the same inputs), and so is every parameter of ``HELD_LAYERS``. A
    control runs the kernels with the memory key bias
    zeroed, so that the empty slots are attended to, and the run fails
    unless that would fail the check. Returns the kernel run's launch
    counts."""
    reset_counts(fa, ln)
    with memory_attention_calls(torch, model) as calls:
        loss_k, grads_k = sam2_loss_and_gradients(torch, model, batch,
                                                  config, True)
    torch.cuda.synchronize()
    counts = read_counts(fa, ln)
    with without_key_bias(model):
        loss_c, grads_c = sam2_loss_and_gradients(torch, model, batch,
                                                  config, True)
    with kernels_as_plain_versions():
        loss_r, grads_r = sam2_loss_and_gradients(torch, model, batch,
                                                  config, True)
    model.set_flash_attention(False)
    loss_p, grads_p = sam2_loss_and_gradients(torch, model, batch, config,
                                              True)
    loss_f, grads_f = sam2_loss_and_gradients(torch, model, batch, config,
                                              False)
    model.set_flash_attention(True)
    # softmax cancels a key bias that every key of a row shares: the mask
    # decoder's get an exact gradient of 0 and are left out by the rule;
    # the memory attention's, rotated by RoPE after the projection, keep a
    # real gradient (a residue of that cancellation, as exact as each row
    # of dS sums to 0) and are held like every other parameter
    left_out, left_ratio, held_ratio = zero_gradient_leaves(grads_f)
    memory_kb = sorted(f"{layer}.k_proj.bias" for layer in calls)
    held_layer = [f"{layer}.{n}" for layer in HELD_LAYERS
                  for n, _ in calls[layer][0].named_parameters()]
    held = sorted(set(memory_kb + held_layer))
    plain, plain_losses = [grads_p, grads_r], [loss_p, loss_r]
    ok, fields, rel_k, rel_p, floor = gradient_reading(
        grads_k, plain, grads_f, (loss_k, plain_losses, loss_f), left_out,
        held)
    control_ok, control, *_ = gradient_reading(
        grads_c, plain, grads_f, (loss_c, plain_losses, loss_f), left_out,
        held)
    rel_pa = relative_errors(grads_p, grads_f)
    rel_pr = relative_errors(grads_r, grads_f)
    spread = max(rel_k, key=lambda n: max(rel_pa[n], rel_pr[n])
                 / max(min(rel_pa[n], rel_pr[n]), 1e-30))
    readings = held_readings(torch, calls, grads_k, held)
    kb = {n: readings[n] for n in memory_kb}
    layer_readings = {n: readings[n] for n in held_layer}
    held_ok = all(k_ok for k_ok, _ in readings.values())
    worst_kb = max(kb, key=lambda n: kb[n][1]["rel_l2"] / kb[n][1]["floor"])
    worst_layer = max(layer_readings, key=lambda n: (
        layer_readings[n][1]["rel_l2"] / layer_readings[n][1]["floor"]))
    full_model_rel = relative_errors(grads_k, grads_f)
    log(f"{label} gradients vs plain attention",
        frames=batch["image"].shape[1], **fields, left_out=left_out,
        left_out_max_ratio=left_ratio, held_min_ratio=held_ratio,
        plain_draws_widest=spread, plain_draws_widest_rel_l2=(
            rel_pa[spread], rel_pr[spread]), launches=counts)
    log(f"{label} memory key biases on their layers' inputs vs float64",
        held=len(kb), worst=worst_kb, **kb[worst_kb][1],
        all={n: {k: r[k] for k in ("rel_l2", "floor")}
             for n, (_, r) in kb.items()},
        worst_against_the_fp32_model=full_model_rel[worst_kb])
    log(f"{label} held layers' parameters on their inputs vs float64",
        layers=HELD_LAYERS, held=len(layer_readings), worst=worst_layer,
        **layer_readings[worst_layer][1],
        all={n: {k: r[k] for k in ("rel_l2", "floor")}
             for n, (_, r) in layer_readings.items()},
        against_the_fp32_model={n: full_model_rel[n] for n in held_layer})
    log(f"{label} gradients, key bias zeroed",
        worst_parameter=control["worst_parameter"],
        worst_rel_l2=control["worst_rel_l2"],
        worst_floor=control["worst_floor"], loss=loss_c)
    if not (ok and held_ok and left_out and len(memory_kb) == 8
            and all(r["calls"] > 0 for _, r in readings.values())):
        raise AssertionError(f"{label}: gradients with the kernels disagree "
                             f"with plain attention: {fields}, held "
                             f"parameters {readings}")
    if control_ok:
        raise AssertionError(f"{label}: the gradient check cannot see a "
                             f"missing key bias: {control}")
    return counts


def sharpen_attention_(torch, model, seed):
    """Redraw every encoder attention's qkv weight from LeCun's normal
    N(0, 1/C) (Flax's default for Dense) and its rel-pos tables from
    N(0, 1/hd). norm1's tokens have unit variance, so q and k then have unit
    std, and so have q.k/sqrt(hd) and each rel term: attention is sharp
    enough that a wrong or missing bias, or a wrong softmax, moves the
    outputs far more than bf16 rounding does."""
    from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models.segment_anything.image_encoder import (
        SAMAttention)
    generator = torch.Generator(device=next(model.parameters()).device)
    generator.manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SAMAttention):
                hd = m.rel_pos_h.shape[1]
                m.qkv.weight.normal_(0.0, m.qkv.in_features ** -0.5,
                                     generator=generator)
                m.rel_pos_h.normal_(0.0, hd ** -0.5, generator=generator)
                m.rel_pos_w.normal_(0.0, hd ** -0.5, generator=generator)


def rms_without_rel_bias(torch, model, images):
    """What the embedding check reads for a kernel that drops the rel-pos
    bias: the RMS distance between the embedding of the same model in fp32
    with plain attention and the bf16 embedding with the kernels and every
    rel-pos table zeroed."""
    from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models.segment_anything.image_encoder import (
        SAMAttention)
    from simpleaicv_pytorch_training_examples_tpu_torch.tools.predict_interactive_segmentation import (
        compute_context)
    attns = [m for m in model.modules() if isinstance(m, SAMAttention)]
    model.set_flash_attention(False)
    with torch.inference_mode():
        reference = model.forward_image_encoder(images)
    model.set_flash_attention(True)
    with torch.no_grad():
        tables = [(m.rel_pos_h.clone(), m.rel_pos_w.clone()) for m in attns]
        for m in attns:
            m.rel_pos_h.zero_()
            m.rel_pos_w.zero_()
    with compute_context(images.device):
        without = model.forward_image_encoder(images).float()
    with torch.no_grad():
        for m, (rel_h, rel_w) in zip(attns, tables):
            m.rel_pos_h.copy_(rel_h)
            m.rel_pos_w.copy_(rel_w)
    return (reference - without).pow(2).mean().sqrt().item()


def attention_logit_stats(torch, model, image):
    """How sharp the encoder's attention is, on one image in fp32 with plain
    attention (the kernels are on again after), in its first windowed and
    its first global block: the std over a query row's keys, averaged over
    the rows, of the scaled scores q.k/sqrt(hd), of the rel bias rel_h +
    rel_w and of their sum, and the mean over the rows of the largest
    softmax weight times the number of keys (1 for attention that
    averages)."""
    from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models.segment_anything.image_encoder import (
        get_rel_pos)
    blocks = model.image_encoder.blocks
    picks = {"windowed": next(b for b in blocks if b.window_size),
             "global": next(b for b in blocks if not b.window_size)}
    inputs = {}
    hooks = [block.attn.register_forward_pre_hook(
        lambda _, args, key=key: inputs.setdefault(key, args[0]))
        for key, block in picks.items()]
    stats = {}
    with torch.inference_mode():
        model.set_flash_attention(False)
        model.forward_image_encoder(image)
        model.set_flash_attention(True)
        for handle in hooks:
            handle.remove()
        for key, block in picks.items():
            attn, x = block.attn, inputs[key].float()
            b, h, w, c = x.shape
            nh = attn.head_nums
            hd = c // nh
            q, k, _ = attn.qkv(x).reshape(b, h * w, 3, nh, hd).permute(
                2, 0, 3, 1, 4)
            scores = q @ k.transpose(-1, -2) * hd ** -0.5
            rq = q.reshape(b, nh, h, w, hd)
            rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq,
                                 get_rel_pos(h, h, attn.rel_pos_h.float()))
            rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq,
                                 get_rel_pos(w, w, attn.rel_pos_w.float()))
            rel = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
                b, nh, h * w, h * w)
            logits = scores + rel
            top = logits.softmax(-1).amax(-1).mean().item() * h * w
            row_std = lambda t: t.std(-1).mean().item()
            stats[key] = {"score_std": row_std(scores),
                          "rel_std": row_std(rel),
                          "logit_std": row_std(logits),
                          "top_weight_x_keys": top}
            del scores, rel, logits
    return stats


def sam_compare(torch, model, images, sets, label, floor_masks=False):
    """The image embedding and every prompt set's mask logits and IoU
    predictions with the kernels and with plain attention on the same
    weights; raises if they disagree. The embedding is held against the
    bf16 rounding floor, the distance of the plain bf16 run from the same
    model in fp32 with plain attention; with ``floor_masks`` the masks and
    IoU predictions are too (see the module docstring), else they keep the
    flat bounds. Returns the logged fields."""
    from simpleaicv_pytorch_training_examples_tpu_torch.tools.predict_interactive_segmentation import (
        predict)
    model.set_flash_attention(True)
    emb_k, out_k, _, _ = predict(model, images, sets, warmup=0)
    model.set_flash_attention(False)
    emb_p, out_p, _, _ = predict(model, images, sets, warmup=0)
    with torch.inference_mode():   # fp32, plain attention: the floor
        emb_f = model.forward_image_encoder(images)
        out_f = {name: model.forward_prompt_encoder_mask_decoder(emb_f, p)
                 for name, p in sets.items()} if floor_masks else {}
    model.set_flash_attention(True)
    diff = lambda a, b: (a.float() - b.float()).abs().max().item()
    rms = lambda a, b: (a.float() - b.float()).pow(2).mean().sqrt().item()
    emb_std = emb_p.float().std().item()
    fields = {"embedding_max_abs_diff": diff(emb_k, emb_p),
              "embedding_std": emb_std,
              "fp32_max_abs_diff_kernels": diff(emb_k, emb_f),
              "fp32_max_abs_diff_plain": diff(emb_p, emb_f),
              "fp32_rms_diff_kernels": rms(emb_k, emb_f),
              "fp32_rms_diff_plain": rms(emb_p, emb_f),
              "finite": bool(torch.isfinite(emb_k).all())}
    del emb_f
    ok = (fields["finite"] and fields["embedding_max_abs_diff"] <= max(
        SAM_ATOL_SCALE * max(1.0, emb_std), fields["fp32_max_abs_diff_plain"])
        and fields["fp32_rms_diff_kernels"]
        <= SAM_FLOOR_RATIO * fields["fp32_rms_diff_plain"])
    for name in sets:
        (mk, ik), (mp, ip) = out_k[name], out_p[name]
        f = fields[name] = {
            "mask_max_abs_diff": diff(mk, mp),
            "mask_std": mp.float().std().item(),
            "binary_agreement": ((mk > 0) == (mp > 0)).float().mean().item(),
            "iou_max_abs_diff": diff(ik, ip),
            "finite": bool(torch.isfinite(mk).all() and torch.isfinite(ik).all())}
        mask_bound = SAM_ATOL_SCALE * max(1.0, f["mask_std"])
        iou_bound = SAM_IOU_ATOL
        masks_ok = f["binary_agreement"] >= SAM_AGREE
        if floor_masks:
            mf, i_f = out_f[name]
            apart = lambda m: ((m > 0) != (mf > 0)).float().mean().item()
            f.update(fp32_mask_max_abs_diff_plain=diff(mp, mf),
                     fp32_mask_rms_diff_kernels=rms(mk, mf),
                     fp32_mask_rms_diff_plain=rms(mp, mf),
                     fp32_binary_disagreement_kernels=apart(mk),
                     fp32_binary_disagreement_plain=apart(mp),
                     fp32_iou_max_abs_diff_plain=diff(ip, i_f))
            mask_bound = max(mask_bound, f["fp32_mask_max_abs_diff_plain"])
            iou_bound = max(iou_bound, f["fp32_iou_max_abs_diff_plain"])
            masks_ok = (f["fp32_mask_rms_diff_kernels"] <= SAM_FLOOR_RATIO
                        * f["fp32_mask_rms_diff_plain"]
                        and f["fp32_binary_disagreement_kernels"] <= max(
                            1.0 - SAM_AGREE, SAM_FLOOR_RATIO
                            * f["fp32_binary_disagreement_plain"]))
        ok &= (f["finite"] and f["mask_max_abs_diff"] <= mask_bound
               and masks_ok and f["iou_max_abs_diff"] <= iou_bound)
    log(f"{label} kernels vs plain attention", **fields)
    if not ok:
        raise AssertionError(f"{label}: kernels disagree with plain "
                             f"attention: {fields}")
    return fields


def sam2_products(model):
    """A context that counts the operations of the SAM2 forwards run inside
    it with forward hooks, the way ``sam_encoder_flops`` and
    ``sam_decoder_flops`` count: every Linear, convolution (per group) and
    transposed convolution, and the attention products Q.K^T and P.V
    (Hiera's windows, pooled queries and global blocks; memory attention
    over every key, masked or not; the decoder's cross attentions). Norms,
    softmax, RoPE, the mask upsampling and the adds are not counted. Yields
    a one-element list holding the running count."""
    import contextlib

    from torch import nn
    from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models.segment_anything.transformer import (
        SAMCrossAttention)
    from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2.image_encoder import (
        MultiScaleAttention)
    from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2.memory import (
        RoPEAttention)
    total = [0]

    def count(module, args, out):
        if isinstance(module, nn.Linear):
            total[0] += 2 * out.numel() * module.in_features
        elif isinstance(module, nn.Conv2d):
            k = module.kernel_size[0] * module.kernel_size[1]
            total[0] += (2 * out.numel() * module.in_channels // module.groups
                         * k)
        elif isinstance(module, nn.ConvTranspose2d):
            k = module.kernel_size[0] * module.kernel_size[1]
            total[0] += 2 * args[0].numel() * module.out_channels * k
        elif isinstance(module, MultiScaleAttention):
            b, h, w, _ = args[0].shape
            s = module.pool_stride or 1
            total[0] += (4 * b * module.head_nums * module.padded_head_dim
                         * (h // s) * (w // s) * h * w)
        elif isinstance(module, (RoPEAttention, SAMCrossAttention)):
            q, k = args[0], args[1]
            total[0] += (4 * q.shape[0] * q.shape[1] * k.shape[1]
                         * module.q_proj.out_features)

    @contextlib.contextmanager
    def ctx():
        hooks = [m.register_forward_hook(count) for m in model.modules()]
        try:
            yield total
        finally:
            for hook in hooks:
                hook.remove()
    return ctx()


def sam2_step_flops(torch, model, frames, prompts):
    """Operations of SAM2's ``encode_frame`` and of one ``track_frame`` with
    every memory slot filled (``sam2_products``). Returns (encode,
    track) operations."""
    with sam2_products(model) as total, torch.inference_mode(), \
            torch.autocast("cuda", torch.bfloat16):
        feat, pos, hr = model.encode_frame(frames[:1])
        encode = total[0]
        _, carry = model.start_track(feat, prompts, highres=hr)
        for _ in range(model.memory_mask_nums):
            _, carry = model.track_frame(feat, pos, carry, highres=hr)
        total[0] = 0
        model.track_frame(feat, pos, carry, highres=hr)
    return encode, total[0]


def sam2_train_flops(torch, model, batch, config):
    """Operations of one SAM2 train step on ``batch``: 3x the products
    (``sam2_products``) of the train tool's forward, which are the encoder
    on the B x T frames, the tracking and every refinement decoder pass;
    the recompute of checkpointing not counted."""
    from simpleaicv_pytorch_training_examples_tpu_torch.tools.train_video_interactive_segmentation_model import (
        build_loss_fn)
    loss_fn = build_loss_fn(model, config)
    with sam2_products(model) as total, torch.inference_mode():
        loss_fn(model, batch, torch.Generator(device="cuda").manual_seed(0))
    return 3 * total[0]


def sharpen_sam2_attention_(torch, model, seed):
    """Redraw every Hiera qkv weight and every memory-attention q_proj and
    k_proj weight from LeCun's normal N(0, 1/C_in) (Flax's default for
    Dense): tokens after a LayerNorm have unit variance, so q and k have
    unit std and so have their scaled scores, and attention is sharp
    enough that a wrong or missing key bias, or a wrong softmax, moves the
    outputs far more than bf16 rounding does."""
    from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2.image_encoder import (
        MultiScaleAttention)
    from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2.memory import (
        RoPEAttention)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            linears = ((m.qkv,) if isinstance(m, MultiScaleAttention) else
                       (m.q_proj, m.k_proj) if isinstance(m, RoPEAttention)
                       else ())
            for lin in linears:
                lin.weight.normal_(0.0, lin.in_features ** -0.5,
                                   generator=generator)


def sam2_memory_logit_stats(torch, model, frames, prompts):
    """How sharp the memory cross-attention is on the last of ``frames``,
    tracked in fp32 with plain attention (the kernels are on again after):
    in the first layer, the std over a query row's valid keys of the
    scaled scores, averaged over the rows, and the mean largest softmax
    weight times the number of valid keys (1 for attention that
    averages)."""
    layer = model.memory_attention.layers[0].cross_attn_image
    seen = {}
    hook = layer.register_forward_hook(
        lambda mod, args, kwargs, out: seen.update(args=args, kwargs=kwargs),
        with_kwargs=True)
    model.set_flash_attention(False)
    try:
        run_track(torch, model, frames, prompts, autocast=False)
    finally:
        hook.remove()
        model.set_flash_attention(True)
    q, k, _ = seen["args"]
    bias = seen["kwargs"]["key_bias"]
    with torch.inference_mode():
        qp, kp = layer.q_proj(q), layer.k_proj(k)
        scores = qp @ kp.transpose(1, 2) * qp.shape[-1] ** -0.5
        valid = bias[0] > -1e8
        scores = scores[..., valid]
        top = scores.softmax(-1).amax(-1).mean().item() * int(valid.sum())
        return {"score_std": scores.std(-1).mean().item(),
                "valid_keys": int(valid.sum()), "top_weight_x_keys": top}


def sharpen_memory_keys_(torch, model, frames, prompts):
    """After ``sharpen_sam2_attention_``: scale every memory
    cross-attention's key projection so that the first layer's scores have
    unit std over a row's valid keys on ``frames`` (the memory features, the
    keys' input, are not normalised, so LeCun's draw alone leaves them
    flatter). Returns the stats after."""
    gain = 1.0 / sam2_memory_logit_stats(torch, model, frames,
                                         prompts)["score_std"]
    with torch.no_grad():
        for layer in model.memory_attention.layers:
            layer.cross_attn_image.k_proj.weight.mul_(gain)
    return sam2_memory_logit_stats(torch, model, frames, prompts)


def run_track(torch, model, frames, prompts, autocast=True):
    """SAM2's stream over ``frames`` [T, 3, S, S]: start_track on frame 0,
    track_frame after; bf16 autocast or fp32. Returns (masks [T, 4, S, S],
    ious [T, 4], object logits [T, 1]) in fp32."""
    outs = []
    carry = None
    with torch.inference_mode(), torch.autocast(
            "cuda", torch.bfloat16, enabled=autocast):
        for i in range(frames.shape[0]):
            feat, pos, hr = model.encode_frame(frames[i:i + 1])
            if carry is None:
                out, carry = model.start_track(feat, prompts, highres=hr)
            else:
                out, carry = model.track_frame(feat, pos, carry, highres=hr)
            outs.append(out)
    return tuple(torch.cat([o[j].float() for o in outs]) for j in range(3))


def sam2_step_launches(frames):
    """Launches of one SAM2-B+ train step of ``frames`` frames: K1 on 18
    windowed blocks and K6 on 3 global blocks, each twice (checkpointing
    recomputes them), with one backward; 8 K6 a tracked frame (4 memory
    layers' self- and cross-attention), with one backward each."""
    return dict(K1=2 * 18, K1_bwd=18, K6=2 * 3 + 8 * (frames - 1),
                K6_bwd=3 + 8 * (frames - 1))


def sam2_gradient_phase(torch, fa, ln):
    """Phase 24 of ``main``: SAM2-B+ at the stage-2 config's settings on its
    seeded init, with sharp attention (Hiera's qkv and the memory
    attention's q and k redrawn as in 21): the gradients of the timed
    step's batch, kernels against plain attention, both held against the
    fp32 model; a control shows the check would fail without the key bias.
    Returns the model, its train step, the batch and the config."""
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        profile_video_interactive_segmentation_train as sam2_profile)
    model, train_step, sam2_config = sam2_profile.build_train_step()
    batch4 = sam2_profile.to_device(sam2_profile.recipe_batch(
        frames=SAM2_STEP_FRAMES))
    sharpen_sam2_attention_(torch, model, SAM2_GRAD_SEED)
    sharp = sharpen_memory_keys_(
        torch, model, batch4["image"][0],
        {"prompt_point": batch4["prompt_point"][:, 0, :1]})
    log("sam2_b+ train memory attention, sharpened", **sharp)
    grad_counts = check_sam2_gradients(torch, fa, ln, model, batch4,
                                       sam2_config, "sam2_b+ sharp attention")
    expect_counts("SAM2-B+ gradients", grad_counts,
                  **sam2_step_launches(SAM2_STEP_FRAMES))
    return model, train_step, batch4, sam2_config


def kernels_as_plain_versions():
    """A context in which SAM2's attention routes (with the kernels on) run
    each kernel's plain version instead: the differentiable PyTorch
    references that the kernels are held against and that the CPU runs."""
    import contextlib
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        flash_attention as fl, fused_attention as fa)
    from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2 import (
        image_encoder as enc, memory as mem)
    plain = {(enc, "fused_attention_dense"): fa.fused_attention_dense_reference,
             (enc, "fused_attention"): fa.fused_attention_reference,
             (enc, "flash_attention"): fl.flash_attention_reference,
             (mem, "flash_attention"): fl.flash_attention_reference}

    @contextlib.contextmanager
    def ctx():
        saved = {key: getattr(*key) for key in plain}
        for (module, name), fn in plain.items():
            setattr(module, name, fn)
        try:
            yield
        finally:
            for (module, name), fn in saved.items():
                setattr(module, name, fn)
    return ctx()


def without_key_bias(model):
    """A context in which the tracker's memory key bias is zero, so that the
    empty slots are attended to (the control of ``sam2_compare``)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        tokens = model._memory_tokens

        def zeroed(carry, b):
            memory, pos, bias = tokens(carry, b)
            return memory, pos, bias * 0.0
        model._memory_tokens = zeroed
        try:
            yield
        finally:
            del model._memory_tokens
    return ctx()


def sam2_compare(torch, model, frames, prompts, label, control=False):
    """Track ``frames`` with the kernels and with plain attention in bf16,
    and with plain attention in fp32 (the floor), on the same weights;
    every frame's mask logits, IoU predictions and object logits of the
    kernels are held against the floor (see the module docstring). With
    ``control`` the kernels run once more with the key bias zeroed, and the
    run fails unless that would fail the mask check. Returns the logged
    fields."""
    model.set_flash_attention(True)
    got = run_track(torch, model, frames, prompts)
    model.set_flash_attention(False)
    plain = run_track(torch, model, frames, prompts)
    fp32 = run_track(torch, model, frames, prompts, autocast=False)
    model.set_flash_attention(True)
    diff = lambda a, b: (a - b).abs().max().item()
    rms = lambda a, b: (a - b).pow(2).mean().sqrt().item()
    apart = lambda a, b: ((a > 0) != (b > 0)).float().mean().item()
    (mk, ik, ok), (mp, ip, op), (mf, i_f, of) = got, plain, fp32
    fields = {
        "frames": frames.shape[0],
        "mask_max_abs_diff": diff(mk, mp), "mask_std": mp.std().item(),
        "fp32_mask_max_abs_diff_plain": diff(mp, mf),
        "fp32_mask_rms_diff_kernels": rms(mk, mf),
        "fp32_mask_rms_diff_plain": rms(mp, mf),
        "fp32_binary_disagreement_kernels": apart(mk, mf),
        "fp32_binary_disagreement_plain": apart(mp, mf),
        "iou_max_abs_diff": diff(ik, ip), "fp32_iou_max_abs_diff_plain":
        diff(ip, i_f), "object_max_abs_diff": diff(ok, op),
        "fp32_object_max_abs_diff_plain": diff(op, of),
        "object_logits": [round(v, 4) for v in ok[:, 0].tolist()],
        "finite": bool(all(torch.isfinite(t).all() for t in got))}
    mask_bound = max(SAM_ATOL_SCALE * max(1.0, fields["mask_std"]),
                     fields["fp32_mask_max_abs_diff_plain"])
    rms_bound = SAM_FLOOR_RATIO * fields["fp32_mask_rms_diff_plain"]
    ok_all = (fields["finite"] and fields["mask_max_abs_diff"] <= mask_bound
              and fields["fp32_mask_rms_diff_kernels"] <= rms_bound
              and fields["fp32_binary_disagreement_kernels"] <= max(
                  1.0 - SAM_AGREE, SAM_FLOOR_RATIO
                  * fields["fp32_binary_disagreement_plain"])
              and fields["iou_max_abs_diff"] <= max(
                  SAM_IOU_ATOL, fields["fp32_iou_max_abs_diff_plain"])
              and fields["object_max_abs_diff"] <= max(
                  SAM_IOU_ATOL, fields["fp32_object_max_abs_diff_plain"]))
    log(f"{label} kernels vs plain attention", **fields)
    if not ok_all:
        raise AssertionError(f"{label}: kernels disagree with plain "
                             f"attention: {fields}")
    if control:
        with without_key_bias(model):
            mc, _, _ = run_track(torch, model, frames, prompts)
        fields["control_fp32_mask_rms_diff_without_key_bias"] = rms(mc, mf)
        log(f"{label}, key bias zeroed",
            fp32_mask_rms_diff_without_key_bias=rms(mc, mf),
            check_bound=rms_bound)
        if not rms(mc, mf) > rms_bound:
            raise AssertionError(f"{label}: the mask check cannot see a "
                                 f"missing key bias ({rms(mc, mf)} <= "
                                 f"{rms_bound})")
    return fields


def first_of(sets, n):
    """The prompt sets of the first ``n`` images."""
    return {name: {k: v[:n] for k, v in prompts.items()}
            for name, prompts in sets.items()}


def set_fused(model, attention=None, norm=None, block=None):
    """Switch the model's blocks between the kernels and the plain ops."""
    from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.vit import (
        TransformerEncoderLayer)
    from simpleaicv_pytorch_training_examples_tpu_torch.models.common import (
        FusedLayerNorm, MultiHeadSelfAttention)
    for blk in model.blocks:
        for m in blk.modules():
            if isinstance(m, MultiHeadSelfAttention) and attention is not None:
                m.use_fused_attention = attention
            if isinstance(m, FusedLayerNorm) and norm is not None:
                m.use_fused = norm
            if isinstance(m, TransformerEncoderLayer) and block is not None:
                m.use_fused_block = block


def set_fused_attention(model, on):
    set_fused(model, attention=on)


def set_fused_block(model, on):
    """K8 and K1 on, or the plain ops."""
    set_fused(model, attention=on, block=on)


def counted_wrappers(fa, ln):
    """{label: wrapper} of every kernel's launch counters."""
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        attn_block as ab, flash_attention as fl)
    return {"K1": fa.fused_attention_dense, "K2": fa.fused_attention,
            "K7": ln.layer_norm, "K3": fa.fused_attention_relwin_dense,
            "K4": fa.fused_attention_relwin, "K5": fl.flash_attention_relpos,
            "K6": fl.flash_attention, "K8": ab.attn_block,
            "K9": fa.fused_attention_qkv, "K2b": fa.fused_attention_bias}


def reset_counts(fa, ln):
    for wrapper in counted_wrappers(fa, ln).values():
        wrapper.launches = 0
        wrapper.backward_launches = 0


def read_counts(fa, ln):
    counts = {}
    for label, wrapper in counted_wrappers(fa, ln).items():
        counts[label] = wrapper.launches
        counts[label + " bwd"] = wrapper.backward_launches
    return counts


def expect_counts(label, counts, **expected):
    wanted = dict.fromkeys(counts, 0)
    wanted.update({k.replace("_", " "): v for k, v in expected.items()})
    if counts != wanted:
        raise AssertionError(f"{label}: kernel launches {counts}, "
                             f"expected {wanted}")


def run_vit_train_cli(fa, ln, train_cli, train_dir, model_kwargs, label,
                      expected):
    """ViT-B/16 through the work-dir train CLI with the port's train config
    (``model_kwargs`` added to the model's), two epochs, then the same
    command resumed for a third; ``expected(n_epochs)`` gives each run's
    launch counts. Returns the first run's counts and both runs' epochs."""
    shutil.rmtree(train_dir, ignore_errors=True)
    train_dir.mkdir(parents=True)
    first_counts, epochs_run = None, []
    for epochs, first_epoch in ((2, 1), (3, 3)):
        (train_dir / "train_config.py").write_text(VIT_B_TRAIN_CONFIG.format(
            n_train=TRAIN_IMAGES, n_eval=EVAL_IMAGES, epochs=epochs,
            trained_model_path="").replace(
                "use_fused_attention=True)",
                f"use_fused_attention=True{model_kwargs})"))
        reset_counts(fa, ln)
        t0 = time.perf_counter()
        run = train_cli.main(["--work-dir", str(train_dir)])
        seconds = time.perf_counter() - t0
        counts = read_counts(fa, ln)
        n_epochs = epochs - first_epoch + 1
        log(f"{label} epochs {first_epoch}-{epochs}",
            resumed_from=run["resumed_from"], epochs=run["epochs"],
            seconds=round(seconds, 2), launches=counts)
        expect_counts(f"{label} to epoch {epochs}", counts,
                      **expected(n_epochs))
        ran = [e["epoch"] for e in run["epochs"]]
        if (ran != list(range(first_epoch, epochs + 1))
                or run["resumed_from"] != (first_epoch - 1 or None)
                or any(e["skipped"] or not math.isfinite(e["loss_avg"])
                       for e in run["epochs"])):
            raise AssertionError(f"{label} to epoch {epochs}: {run}")
        first_counts = first_counts or counts
        epochs_run += run["epochs"]
    return first_counts, epochs_run


def vit_loss_and_grads(torch, model, batch, criterion):
    """One bf16 micro-batch's loss and every parameter's gradient."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss = criterion(model(batch["image"].to(torch.bfloat16)), batch["label"])
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def check_vit_gradients(torch, fa, ln, model, batch, criterion, label, switch,
                        expected, reference=None):
    """Gradients of one micro-batch with the kernels (``switch(True)``)
    against the plain ops (``switch(False)``), or against ``reference``
    (loss, gradients) when given: per parameter, relative L2 at most
    GRAD_REL_L2, |loss difference| at most GRAD_LOSS_ATOL; the kernel run's
    launch counts as ``expected``. Returns the kernel run's (loss,
    gradients)."""
    reset_counts(fa, ln)
    loss_kernel, grads_kernel = vit_loss_and_grads(torch, model, batch,
                                                   criterion)
    counts = read_counts(fa, ln)
    if reference is None:
        switch(False)
        reference = vit_loss_and_grads(torch, model, batch, criterion)
        switch(True)
    loss_plain, grads_plain = reference
    rel = {n: ((grads_kernel[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in grads_plain.items()}
    worst = max(rel, key=rel.get)
    log(label, batch=len(batch["label"]), loss_kernels=loss_kernel,
        loss_plain=loss_plain, max_rel_l2=rel[worst], worst_parameter=worst,
        median_rel_l2=sorted(rel.values())[len(rel) // 2], launches=counts)
    expect_counts(label, counts, **expected)
    if not (abs(loss_kernel - loss_plain) <= GRAD_LOSS_ATOL
            and rel[worst] <= GRAD_REL_L2
            and all(map(math.isfinite, rel.values()))):
        raise AssertionError(f"{label}: gradients disagree: loss "
                             f"{loss_kernel} vs {loss_plain}, rel L2 "
                             f"{rel[worst]} at {worst}")
    return loss_kernel, grads_kernel


def train_flops_per_image(model, image_size):
    """Operations of one training image, counted from the model's shapes:
    3x (forward + backward) the forward's matrix products, which are the
    patch embedding, the blocks' qkv, proj, fc1 and fc2 Linears, the
    attention products Q.K^T and P.V, and the head. Softmax, LayerNorm, GELU
    and the optimizer are not counted."""
    c = model.pos_embed.shape[-1]
    n = model.pos_embed.shape[1]
    patch = model.patch_embed.patch_size
    hidden = model.blocks[0].mlp.fc1.out_features
    per_block = 2 * n * c * (3 * c + c + 2 * hidden) + 4 * n * n * c
    forward = (2 * (n - 1) * 3 * patch * patch * c
               + len(model.blocks) * per_block
               + 2 * c * model.fc.out_features)
    assert image_size // patch * (image_size // patch) == n - 1
    return 3 * forward


def logits_of(torch, eval_step, loader):
    out = [eval_step(batch)[2] for batch in loader]
    torch.cuda.synchronize()
    return torch.cat(out)


def compare_paths(torch, model, loader, label, switch=set_fused_attention):
    """Logits with the kernels and with plain attention (``switch`` off) on
    the same weights; returns the kernel logits after checking the
    agreement."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_classification_eval_step)
    eval_step = make_classification_eval_step(model)
    switch(model, True)
    fused = logits_of(torch, eval_step, loader)
    switch(model, False)
    plain = logits_of(torch, eval_step, loader)
    switch(model, True)
    diff = (fused - plain).abs().max().item()
    scale = max(1.0, plain.std().item())
    agree = (fused.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"{label} vs plain attention", max_abs_logit_diff=diff,
        logit_std=plain.std().item(), top1_agreement=agree,
        shape=list(fused.shape), finite=bool(torch.isfinite(fused).all()))
    if not (torch.isfinite(fused).all() and diff <= 0.02 * scale
            and agree >= 0.99):
        raise AssertionError(f"{label}: kernel logits disagree with plain "
                             f"attention (max diff {diff}, top-1 {agree})")
    return fused


def fit_head(torch, model, loader):
    """Set the fc head to one prototype per class: the unit-length mean of
    that class's pooled features (the global-pool LayerNorm's output, plain
    attention) less the mean over all images, with the bias that subtracts
    that mean; classes without images get zero. Each image's top-1 is then
    decided by its own features with a wide margin, where the seeded init's
    2e-5 head leaves all 1000 logits within 1e-3 of each other and top-1 is
    a coin toss between near-ties."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_classification_eval_step)
    feats, labels = [], []
    hook = model.norm.register_forward_hook(
        lambda module, args, out: feats.append(out.float()))
    set_fused_attention(model, False)
    eval_step = make_classification_eval_step(model)
    for batch in loader:
        eval_step(batch)
        labels.append(batch["label"].cuda())
    hook.remove()
    set_fused_attention(model, True)
    feats, labels = torch.cat(feats), torch.cat(labels)
    mean = feats.mean(dim=0)
    protos = torch.zeros_like(model.fc.weight)
    protos.index_add_(0, labels, feats - mean)
    protos = torch.nn.functional.normalize(protos, dim=1)
    with torch.no_grad():
        model.fc.weight.copy_(protos)
        model.fc.bias.copy_(-(protos @ mean))


def sam2_training_slice(torch, fa, ln, results):
    """The SAM2 training phases (23-25 of ``main``); returns the train CLI's
    launch counts of its first run."""
    # 23. the SAM2 training slice: SAM2-B+ at full width and depth through
    #     the work-dir train CLI with the port's stage-2 config
    #     (checkpointing, condition frames, 2 point-iteration frames, bf16)
    #     on seeded synthetic clips of 8 frames, one epoch, then the same
    #     command resumed for a second. A step encodes the 8 frames in one
    #     call: K1 on 18 windowed blocks and K6 on 3 global blocks, each
    #     twice (checkpointing recomputes them), with one backward; the 7
    #     tracked frames' memory attention (4 layers of self- and
    #     cross-attention) runs K6 8 times a frame, with one backward each
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        profile_video_interactive_segmentation_train as sam2_profile,
        train_video_interactive_segmentation_model as sam2_train_cli)

    sam2_dir = SMOKE_DIR / "sam2_b+_train"
    shutil.rmtree(sam2_dir, ignore_errors=True)
    sam2_dir.mkdir(parents=True)
    sam2_train_counts = {}
    for epochs, first_epoch in ((1, 1), (2, 2)):
        (sam2_dir / "train_config.py").write_text(SAM2_B_TRAIN_CONFIG.format(
            frames=SAM2_TRAIN_FRAMES, n_train=SAM2_TRAIN_CLIPS, epochs=epochs))
        reset_counts(fa, ln)
        t0 = time.perf_counter()
        run = sam2_train_cli.main(["--work-dir", str(sam2_dir)])
        seconds = time.perf_counter() - t0
        counts = read_counts(fa, ln)
        steps = (epochs - first_epoch + 1) * SAM2_TRAIN_CLIPS
        log(f"sam2_b+ train cli epochs {first_epoch}-{epochs}",
            resumed_from=run["resumed_from"], batch=1,
            frames=SAM2_TRAIN_FRAMES, epochs=run["epochs"],
            seconds=round(seconds, 2), launches=counts,
            launches_per_step={k: v / steps for k, v in counts.items() if v})
        expect_counts(f"SAM2-B+ train CLI to epoch {epochs}", counts, **{
            k: v * steps
            for k, v in sam2_step_launches(SAM2_TRAIN_FRAMES).items()})
        ran = [e["epoch"] for e in run["epochs"]]
        if (ran != list(range(first_epoch, epochs + 1))
                or run["resumed_from"] != (first_epoch - 1 or None)
                or any(e["skipped"] or not math.isfinite(e["loss_avg"])
                       for e in run["epochs"])):
            raise AssertionError(f"SAM2-B+ train CLI to epoch {epochs}: {run}")
        if not sam2_train_counts:
            sam2_train_counts = counts
        del run
    sam2_log = (sam2_dir / "log" / "train.log").read_text()
    sam2_losses = [float(x) for x in re.findall(r" loss ([-\w.]+) avg ",
                                                sam2_log)]
    epoch_avgs = [float(x) for x in re.findall(
        r"epoch \d+: train loss avg ([-\w.]+)", sam2_log)]
    log("sam2_b+ train cli losses", iteration_losses=sam2_losses,
        epoch_loss_avgs=epoch_avgs)
    if (len(sam2_losses) != 2 * SAM2_TRAIN_CLIPS
            or not all(map(math.isfinite, sam2_losses))
            or not epoch_avgs[-1] < epoch_avgs[0]
            or "resumed from epoch 1" not in sam2_log):
        raise AssertionError(f"SAM2-B+ train log: losses {sam2_losses}, "
                             f"epoch averages {epoch_avgs}")
    if not ((sam2_dir / "checkpoints" / "latest.pth").is_file()
            and (sam2_dir / "checkpoints" / "best.pth").is_file()):
        raise AssertionError("the SAM2 train CLI left no latest.pth / "
                             "best.pth")
    torch.cuda.empty_cache()

    # 24. SAM2-B+ gradients with sharp attention (sam2_gradient_phase)
    model, train_step, batch4, sam2_config = sam2_gradient_phase(torch, fa,
                                                                 ln)

    # 25. timed SAM2-B+ train steps at bench_sam2_train.py's recipe (batch
    #     1, 4 frames at 1024^2, frame 0 prompted, 2 refined frames, the
    #     stage-2 config's settings), with the kernels and with plain
    #     attention; frames/s, peak memory and the share of the bf16 peak
    # K6's backward a step: 4 memory layers' cross- and self-attention on
    # each tracked frame t (the cross-attention timed at frame t's own
    # bias: t valid slots and pointers, the rest skipped) and the 3 global
    # blocks of the 4 frames
    k6_bwd = {r["case"]: r["ms"] for r in results["K6 bwd"]}
    k6_bwd_ms = (sum(4 * (k6_bwd[f"sam2_memory_cross_frame{t}"]
                          + k6_bwd["sam2_memory_self"])
                     for t in range(1, SAM2_STEP_FRAMES))
                 + 3 * k6_bwd["hiera_global"])
    reset_counts(fa, ln)
    first = train_step(batch4, 0)
    torch.cuda.synchronize()
    step_counts = read_counts(fa, ln)
    expect_counts("SAM2-B+ train step", step_counts,
                  **sam2_step_launches(SAM2_STEP_FRAMES))
    if first["skipped"].item() or not math.isfinite(first["loss"].item()):
        raise AssertionError(f"SAM2-B+ train step skipped: {first}")
    step = iter(range(1, 10 ** 6))
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, lambda: train_step(batch4, next(step)), iters=5,
                      warmup=1, device_only=False)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_flops = sam2_train_flops(torch, model, batch4, sam2_config)
    model.set_flash_attention(False)
    torch.cuda.reset_peak_memory_stats()
    plain_step_ms = time_ms(torch, lambda: train_step(batch4, next(step)),
                            iters=2, warmup=1, device_only=False)
    plain_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    model.set_flash_attention(True)
    frames_per_step = SAM2_STEP_FRAMES * batch4["image"].shape[0]
    log("sam2_b+ train step", batch=1, frames=SAM2_STEP_FRAMES,
        refined_frames=list(sam2_profile.ITER_FRAMES),
        decoder_point_iters=sam2_config.decoder_point_iters,
        launches_per_step=step_counts, ms=step_ms,
        frames_per_s=frames_per_step / step_ms * 1e3,
        tflops=step_flops / step_ms / 1e9,
        share_of_bf16_peak=step_flops / step_ms / 1e9 / 989.0,
        counted="3x the forward's products: the encoder on 4 frames, the "
                "tracking, every decoder pass; no recompute",
        gflop_per_step=step_flops / 1e9, peak_memory_gb=peak_gb,
        plain_attention_ms=plain_step_ms,
        plain_attention_peak_memory_gb=plain_peak_gb,
        k6_bwd_share=k6_bwd_ms / step_ms)
    del model, train_step, batch4, first
    torch.cuda.empty_cache()

    return sam2_train_counts


def config_text(path, **replacements):
    """A port config's text with each ``old -> new`` line replaced; raises
    if a line is not there (the config drifted from what a phase expects)."""
    text = path.read_text()
    for old, new in replacements.items():
        if old not in text:
            raise AssertionError(f"{path}: no line {old!r}")
        text = text.replace(old, new)
    return text


def jpeg_folder(root, per_set):
    """root/{set}/n0000000c/*.JPEG for each set: ``per_set[set]`` images over
    ``JPEG_CLASSES`` class folders, each a symlink to a fixture in turn."""
    fixtures = sorted(JPEG_FIXTURES.glob("*.jpg"))
    for set_name, n in per_set.items():
        for i in range(n):
            folder = root / set_name / f"n{i % JPEG_CLASSES:08d}"
            folder.mkdir(parents=True, exist_ok=True)
            link = folder / f"{set_name}_{i:05d}.JPEG"
            if not link.is_symlink():
                link.symlink_to(fixtures[i % len(fixtures)])


def native_jpeg_phase():
    """Phase a: build the libjpeg core, decode the fixtures (shape, dtype,
    per-channel means within JPEG_MEAN_TOL of the recorded ones) and time
    ``decode_jpeg`` on one thread and ``decode_jpeg_batch`` on every core.
    Returns None, or why libjpeg is unavailable."""
    import os

    import numpy as np

    from simpleaicv_pytorch_training_examples_tpu_torch import native
    from simpleaicv_pytorch_training_examples_tpu_torch.data.native_jpeg import (
        decode_jpeg, decode_jpeg_batch)
    try:
        native.lib()
    except RuntimeError as exc:
        return " ".join(str(exc).split())[:600]
    record = json.loads((JPEG_FIXTURES / "means.json").read_text())
    names = sorted(record["images"])
    blobs = [(JPEG_FIXTURES / name).read_bytes() for name in names]
    worst = 0.0
    for name, blob in zip(names, blobs):
        pixels = decode_jpeg(blob, name=name)
        want = record["images"][name]
        if (pixels is None or pixels.dtype != np.uint8
                or list(pixels.shape) != want["shape"]):
            raise AssertionError(f"{name}: decoded to " + (
                "nothing" if pixels is None else
                f"{pixels.dtype} {pixels.shape}"))
        means = pixels.reshape(-1, 3).mean(axis=0)
        worst = max(worst, float(np.abs(means - want["channel_means"]).max()))
    t0 = time.perf_counter()
    for _ in range(JPEG_DECODE_ROUNDS):
        for blob in blobs:
            decode_jpeg(blob)
    one_thread = JPEG_DECODE_ROUNDS * len(blobs) / (time.perf_counter() - t0)
    threads = os.cpu_count()
    many = blobs * (4 * JPEG_DECODE_ROUNDS)
    decode_jpeg_batch(many[:threads], n_threads=threads)
    t0 = time.perf_counter()
    decoded = decode_jpeg_batch(many, n_threads=threads)
    batched = len(many) / (time.perf_counter() - t0)
    path, version = native.linked_libjpeg()
    log("native jpeg", libjpeg=path, libjpeg_version=version,
        images=len(blobs), shape=list(pixels.shape), bytes_per_image=round(
            sum(map(len, blobs)) / len(blobs)),
        max_channel_mean_diff=worst, tol=JPEG_MEAN_TOL,
        recorded_by=record["decoded_by"],
        decode_jpeg_images_per_s_1_thread=one_thread,
        decode_jpeg_batch_images_per_s=batched, batch_threads=threads,
        cpu_count=os.cpu_count())
    if worst > JPEG_MEAN_TOL or any(d is None for d in decoded):
        raise AssertionError(f"fixture means off by {worst} (tol "
                             f"{JPEG_MEAN_TOL}) or a batch decode failed")
    return None


def loader_phase(config, root):
    """Phase b: the ResNet-50 config's train transforms through the train
    loader alone over ``LOADER_IMAGES`` files in ``root``, at the config's
    workers (capped at the cores) and without workers. The rate is read
    after the first round (the first batch of each worker, which the
    workers build at once): the images of the later batches over the time
    from that round's end to the last batch. The round's time, the workers'
    start and first batch, is given apart."""
    import os

    from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.ilsvrc2012dataset import (
        ILSVRC2012Dataset)
    from simpleaicv_pytorch_training_examples_tpu_torch.data import TrainLoader
    dataset = ILSVRC2012Dataset(root_dir=str(root), set_name="train",
                                transform=config.train_dataset.transform)
    fields = {"cpu_count": os.cpu_count(), "train_images": len(dataset),
              "batch": config.batch_size}
    for workers in (min(config.num_workers, os.cpu_count()), 0):
        loader = TrainLoader(dataset, config.batch_size,
                             config.train_collater, "cuda", seed=config.seed,
                             num_workers=workers)
        loader.set_epoch(1)
        batches = len(loader) if workers else LOADER_BATCHES_NO_WORKERS
        round_batches = max(workers, 1)
        images, t0 = 0, time.perf_counter()
        for i, batch in enumerate(loader):
            images += batch["label"].shape[0]
            if i + 1 == round_batches:
                round_end, round_images = time.perf_counter(), images
            if i + 1 == batches:
                break
        seconds = time.perf_counter() - t0
        if tuple(batch["image"].shape) != (config.batch_size, 3, 224, 224):
            raise AssertionError(f"loader batch {tuple(batch['image'].shape)}")
        fields[f"workers_{workers}"] = {
            "batches": batches, "images": images, "seconds": seconds,
            "first_round_batches": round_batches,
            "first_round_s": round_end - t0,
            "images_per_s_after_first_round": (images - round_images)
            / (seconds - (round_end - t0)),
            "images_per_s_whole": images / seconds}
        del loader
    log("loader ilsvrc jpeg", timed="host clock, files in the page cache "
        "(warm)", **fields)


def run_train_cli(cli, work_dir, config_path, label, passes, replacements,
                  fa, ln, expected=None):
    """A port config through a train CLI in ``work_dir``: for each
    (epochs, first epoch) of ``passes`` the config with ``epochs`` (and
    ``replacements``), run, resumed after the first; every epoch's loss
    finite and no step skipped, the kernels' launches ``expected(n_epochs
    run)`` (no hand-written kernel launched without ``expected``). Returns
    the runs; a run's ``model``, where the CLI returns one, is dropped when
    the next run starts (two full-size models need not fit at once)."""
    shutil.rmtree(work_dir, ignore_errors=True)
    work_dir.mkdir(parents=True)
    runs = []
    for epochs, first_epoch in passes:
        (work_dir / "train_config.py").write_text(config_text(
            config_path, **{k: v.format(epochs=epochs)
                            for k, v in replacements.items()}))
        if runs:
            runs[-1].pop("model", None)
            torch_empty_cache()
        reset_counts(fa, ln)
        t0 = time.perf_counter()
        run = cli.main(["--work-dir", str(work_dir)])
        seconds = time.perf_counter() - t0
        counts = read_counts(fa, ln)
        for e in run["epochs"]:
            log(f"{label} epoch {e['epoch']}", resumed_from=run["resumed_from"],
                loss_avg=e["loss_avg"], skipped=e["skipped"],
                seconds=e["seconds"], loader_wait_seconds=e[
                    "loader_wait_seconds"],
                loader_start_seconds=e["loader_start_seconds"],
                first_batch_wait_seconds=e["first_batch_wait_seconds"],
                later_batches_wait_seconds=e["loader_wait_seconds"]
                - e["loader_start_seconds"] - e["first_batch_wait_seconds"],
                step_seconds=e["step_seconds"],
                train_images_per_s=e["train_images_per_s"],
                top1=e.get("top1"), top5=e.get("top5"),
                timed="host clock; the loop waits for each step's loss "
                "(print_interval 1)")
        log(f"{label} run to epoch {epochs}", seconds=seconds,
            launches=counts)
        expect_counts(f"{label} to epoch {epochs}", counts, **(
            expected(epochs - first_epoch + 1) if expected else {}))
        ran = [e["epoch"] for e in run["epochs"]]
        if (ran != list(range(first_epoch, epochs + 1))
                or run["resumed_from"] != (first_epoch - 1 or None)
                or any(e["skipped"] or not math.isfinite(e["loss_avg"])
                       for e in run["epochs"])):
            raise AssertionError(f"{label} to epoch {epochs}: {run}")
        runs.append(run)
    return runs


def torch_empty_cache():
    import torch
    torch.cuda.empty_cache()


def conv_fc_flops(torch, model, image_size):
    """Multiply-adds x 2 of one image's forward through every convolution
    and Linear, counted from the shapes (hooks on one eval forward)."""
    flops = []

    def hook(module, inputs, output):
        if isinstance(module, torch.nn.Conv2d):
            kh, kw = module.kernel_size
            flops.append(2 * output[0].numel() * kh * kw
                         * module.in_channels // module.groups)
        else:
            flops.append(2 * module.in_features * module.out_features)
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model.eval()(torch.zeros(1, 3, image_size, image_size,
                                 device="cuda"))
    for h in hooks:
        h.remove()
    return sum(flops)


def resnet50_step_phase(torch, config):
    """Phase e: ResNet-50 train steps at batch 256 as the config runs them
    (bf16, SGD), timed with the model's channels_last activations and in
    NCHW, with peak memory and the share of the bf16 peak at 3x the
    forward's convolution and fc FLOPs; then a step at 2 micro-batches with
    a NaN in the second's input must skip and leave every parameter, the
    optimizer state and every BatchNorm buffer bit for bit as they were."""
    from simpleaicv_pytorch_training_examples_tpu_torch.classification import losses
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        init_model, make_train_step)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import build_optimizer
    batch_size = config.batch_size
    model = init_model(config.model, config.seed)
    optimizer, _ = build_optimizer(config, model, 5005)
    gen = torch.Generator(device="cuda").manual_seed(11)
    batch = {"image": torch.randn(batch_size, 3, 224, 224, device="cuda",
                                  generator=gen),
             "label": torch.randint(0, 1000, (batch_size,), device="cuda",
                                    generator=gen)}
    flops = 3 * batch_size * conv_fc_flops(torch, model, 224)
    fields = {}
    step = iter(range(10 ** 6))
    train_step = make_train_step(model, losses.CELoss(), optimizer)
    # the model's own layout (channels_last activations), then NCHW
    for layout in (model.memory_format, torch.contiguous_format):
        model.memory_format = layout
        first = train_step(batch, next(step))
        if first["skipped"].item() or not math.isfinite(first["loss"].item()):
            raise AssertionError(f"ResNet-50 train step: {first}")
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: train_step(batch, next(step)), iters=10,
                     warmup=2, device_only=False)
        fields[str(layout).split(".")[-1]] = {
            "ms": ms, "images_per_s": batch_size / ms * 1e3,
            "tflops": flops / ms / 1e9,
            "share_of_bf16_peak": flops / ms / 1e9 / 989.0,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    del model.memory_format   # back to the class's
    log(f"resnet50 train step {batch_size}", batch=batch_size, dtype="bf16",
        gflop_per_image=flops / 3 / batch_size / 1e9,
        counted="3x the forward's convolution and fc FLOPs", **fields)

    train_step = make_train_step(model, losses.CELoss(), optimizer,
                                 accumulation_steps=2)
    params = [p.detach().clone() for p in model.parameters()]
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    state = optimizer.state_dict()
    poisoned = dict(batch, image=batch["image"].clone())
    poisoned["image"][batch_size - 1, 0, 100, 100] = float("nan")
    metrics = train_step(poisoned, next(step))
    after = optimizer.state_dict()
    same = {
        "parameters": all(torch.equal(p, q)
                          for p, q in zip(model.parameters(), params)),
        "buffers": all(torch.equal(b, buffers[n])
                       for n, b in model.named_buffers()),
        "optimizer": int(after["step"]) == int(state["step"]) and all(
            torch.equal(t, state["momentum_buf"][n])
            for n, t in after["momentum_buf"].items())}
    log(f"resnet50 train step {batch_size} nan", micro_batches=2,
        skipped=metrics["skipped"].item(), loss=metrics["loss"].item(),
        bn_buffers=len(buffers), unchanged=same)
    if metrics["skipped"].item() != 1.0 or not all(same.values()):
        raise AssertionError(f"NaN step: skipped {metrics['skipped']}, "
                             f"unchanged {same}")


def imagenet_slice(torch, fa, ln, eval_cli, train_cli):
    """Phases a-g (``main``'s 10f-10l): ImageNet classification from real
    JPEG files and the ResNets, on a data root under ``SMOKE_DIR``."""
    import os

    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        train_imagenet21k_classification_model as in21k_cli)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
        load_config_from_work_dir)
    data_root = SMOKE_DIR / "data"
    os.environ["SIMPLEAICV_DATA_ROOT"] = str(data_root)
    experiments = REPO / PACKAGE / "experiments"
    resnet50_dir = experiments / "imagenet" / "resnet50"

    phase_start("10f")
    # a. the libjpeg core; without libjpeg phases a-d (and g) say why
    unavailable = native_jpeg_phase()
    if unavailable is not None:
        for phase in ("native jpeg", "loader ilsvrc jpeg",
                      "resnet50 train cli", "vit_b16 eval cli jpeg",
                      "resnet50 in21k train cli"):
            log(phase, unavailable=unavailable)
    else:
        phase_start("10g")
        # b. the loader alone on an ILSVRC folder of the fixtures
        jpeg_folder(data_root / "ILSVRC2012",
                    {"train": RESNET_TRAIN_IMAGES, "val": RESNET_EVAL_IMAGES})
        loader_root = SMOKE_DIR / "loader_data"
        jpeg_folder(loader_root, {"train": LOADER_IMAGES})
        loader_phase(load_config_from_work_dir(str(resnet50_dir),
                                               "train_config"), loader_root)
        phase_start("10h")
        # c. ResNet-50 through the train CLI, one epoch and a resume, then
        #    best.pth through the eval CLI
        train_dir = SMOKE_DIR / "resnet50_train"
        runs = run_train_cli(
            train_cli, train_dir, resnet50_dir / "train_config.py",
            "resnet50 train cli", ((1, 1), (2, 2)),
            {"    epochs = 100\n": "    epochs = {epochs}\n",
             "    print_interval = 100\n": "    print_interval = 1\n"},
            fa, ln)
        best = train_dir / "checkpoints" / "best.pth"
        (train_dir / "test_config.py").write_text(config_text(
            resnet50_dir / "test_config.py", **{
                '    trained_model_path = ""\n':
                f"    trained_model_path = {str(best)!r}\n"}))
        values = eval_cli.main(["--work-dir", str(train_dir)])
        test_log = (train_dir / "log" / "test.log").read_text()
        log("resnet50 best.pth eval cli", images=values["images"],
            top1=values["top1"], top5=values["top5"],
            images_per_s=values["images_per_s"],
            best_top1=runs[-1]["best_top1"])
        if (values["images"] != RESNET_EVAL_IMAGES
                or "pretrained load: 320/320 tensors" not in test_log):
            raise AssertionError(f"ResNet-50 best.pth eval: {values}")
        phase_start("10i")
        # d. ViT-B/16 through the eval CLI over the JPEG val folder
        vit_dir = SMOKE_DIR / "vit_base_patch16_jpeg"
        vit_dir.mkdir(parents=True, exist_ok=True)
        (vit_dir / "test_config.py").write_text(
            (experiments / "imagenet" / "vit_base_patch16_for_official_mae_"
             "pretrain" / "test_config.py").read_text())
        reset_counts(fa, ln)
        values = eval_cli.main(["--work-dir", str(vit_dir)])
        counts = read_counts(fa, ln)
        batches = -(-RESNET_EVAL_IMAGES // 256)
        log("vit_b16 eval cli jpeg", images=values["images"],
            top1=values["top1"], images_per_s=values["images_per_s"],
            launches=counts)
        expect_counts("ViT-B/16 eval over JPEG files", counts,
                      K1=12 * batches)
        if values["images"] != RESNET_EVAL_IMAGES:
            raise AssertionError(f"ViT-B/16 JPEG eval: {values}")

    phase_start("10j")
    # e. the timed ResNet-50 train step and the NaN step
    resnet50_step_phase(torch, load_config_from_work_dir(
        str(resnet50_dir), "train_config"))
    torch.cuda.empty_cache()

    phase_start("10k")
    # f. ResNet-18 (CIFAR) through the train CLI on a seeded CIFAR-100
    write_cifar(data_root)
    run_train_cli(train_cli, SMOKE_DIR / "resnet18cifar_train",
                  experiments / "cifar100" / "resnet18cifar" /
                  "train_config.py", "resnet18cifar train cli",
                  ((1, 1), (2, 2)),
                  {"    epochs = 200\n": "    epochs = {epochs}\n",
                   "    print_interval = 50\n": "    print_interval = 1\n"},
                  fa, ln)

    phase_start("10l")
    # g. ResNet-50 on ImageNet-21K's semantic softmax, a two-level tree
    if unavailable is None:
        in21k = data_root / "ImageNet21K"
        jpeg_folder(in21k, {"train": IN21K_TRAIN_IMAGES,
                            "val": RESNET_EVAL_IMAGES})
        roots = IN21K_CLASSES - IN21K_ROOTS   # classes past it are roots
        tree = [[roots + c % IN21K_ROOTS, c] if c < roots else [c]
                for c in range(IN21K_CLASSES)]
        torch.save({"class_tree_list": tree},
                   in21k / "imagenet21k_miil_tree.pth")
        run = run_train_cli(
            in21k_cli, SMOKE_DIR / "resnet50_in21k_train",
            experiments / "imagenet21k" /
            "resnet50_semantic_softmax_1k_pretrain" / "train_config.py",
            "resnet50 in21k train cli", ((1, 1),),
            {"    epochs = 80\n": "    epochs = {epochs}\n",
             "    print_interval = 100\n": "    print_interval = 1\n"},
            fa, ln)[0]
        log("resnet50 in21k train cli", levels=2, classes=IN21K_CLASSES,
            train_images=IN21K_TRAIN_IMAGES,
            semantic_softmax_loss=run["epochs"][0]["loss_avg"],
            top1=run["epochs"][0]["top1"])


def qkv_and_bias_slice(torch, F, fa, ln, results):
    """Phases 3a-3b of ``main``: K9 and K2b against their plain versions,
    then their entry points driven and counted; returns the counts."""
    bf16, fp32 = torch.bfloat16, torch.float32
    # 3a. K9 (a packed [B, N, 3, H, D] qkv; shape (B, N, H, D)) and K2b (a
    #     full score bias; shape (B, H, N, D)), forward and backward, against
    #     their plain versions; K9 against K1 bit for bit at d = 64 and 128,
    #     K2b at its plain version's floor with a control, and against K3
    for case in (
            dict(label="vit_b16", shape=(BATCH, 197, 12, 64), dtype=bf16,
                 seed=80),
            dict(label="vit_h14", shape=(BATCH, 257, 16, 80), dtype=bf16,
                 seed=81),
            dict(label="n_real_150", shape=(BATCH, 197, 12, 64), dtype=bf16,
                 seed=82, n_real=150),
            dict(label="fp32", shape=(8, 197, 12, 64), dtype=fp32, seed=83),
            dict(label="head_dim_35", shape=(8, 50, 4, 35), dtype=bf16,
                 seed=84)):
        check_qkv_kernel(torch, F, fa, case, results)
    sam_windows = 25 * SAM_BATCH      # SAM's 14 x 14 windows of 8 images
    window_bias = lambda h: (sam_windows, h, 196, 196)
    for case in (
            dict(label="sam_b", shape=(sam_windows, 12, 196, 64), dtype=bf16,
                 seed=85, bias_shape=window_bias(12), spread=0.3),
            dict(label="sam_b_sharp", shape=(sam_windows, 12, 196, 64),
                 dtype=bf16, seed=86, bias_shape=window_bias(12), spread=3.0),
            dict(label="sam_h", shape=(sam_windows, 16, 196, 80), dtype=bf16,
                 seed=87, bias_shape=window_bias(16), spread=3.0),
            dict(label="shared_bias", shape=(sam_windows, 12, 196, 64),
                 dtype=bf16, seed=88, bias_shape=(1, 12, 196, 196),
                 spread=0.3),
            dict(label="n_real_150", shape=(sam_windows, 12, 196, 64),
                 dtype=bf16, seed=89, bias_shape=window_bias(12), spread=3.0,
                 n_real=150),
            dict(label="fp32", shape=(8, 12, 196, 64), dtype=fp32, seed=90,
                 bias_shape=(8, 12, 196, 196), spread=3.0),
            dict(label="bf16_bias", shape=(sam_windows, 12, 196, 64),
                 dtype=bf16, seed=91, bias_shape=window_bias(12), spread=3.0,
                 bias_dtype=bf16),
            dict(label="head_dim_35", shape=(8, 4, 50, 35), dtype=bf16,
                 seed=92, bias_shape=(8, 4, 50, 50), spread=0.3),
            # K/V too large to stay in shared memory: walked in chunks
            dict(label="streamed_n1024", shape=(8, 2, 1024, 128), dtype=bf16,
                 seed=93, bias_shape=(8, 2, 1024, 1024), spread=3.0)):
        check_bias_kernel(torch, F, fa, case, results)
    check_bias_against_k3(torch, fa, dict(
        label="sam_b", shape=(sam_windows, 12, 14, 14, 64), dtype=bf16,
        seed=20), results)
    torch.cuda.empty_cache()

    # 3b. this slice's path: the K9 and K2b entry points as a user calls
    #     them (no model calls either), counted
    reset_counts(fa, ln)
    drive_qkv_and_bias(torch, fa)
    torch.cuda.synchronize()
    entry_counts = read_counts(fa, ln)
    log("K9 and K2b entry points", launches=entry_counts)
    expect_counts("K9 and K2b entry points", entry_counts, K9=2, K9_bwd=2,
                  K2b=2, K2b_bwd=2)
    torch.cuda.empty_cache()
    return entry_counts


class recorded_epochs:
    """Within the block, each train-loader epoch of ``batches`` (epoch ->
    list of batches) is replayed from it where it is there, and otherwise
    loaded and recorded into it: a second run over the same epochs then
    costs no JPEG decoding."""

    def __init__(self, batches):
        self.batches = batches

    def __enter__(self):
        from simpleaicv_pytorch_training_examples_tpu_torch.data import (
            loader)
        self.loader, self.real = loader, loader.TrainLoader.__iter__
        batches, real = self.batches, self.real

        def epoch_iter(train_loader):
            epoch = train_loader.epoch
            if epoch not in batches:
                batches[epoch] = [{k: v.clone() for k, v in b.items()}
                                  for b in real(train_loader)]
            return iter(batches[epoch])

        loader.TrainLoader.__iter__ = epoch_iter
        return self

    def __exit__(self, *exc):
        self.loader.TrainLoader.__iter__ = self.real


def mae_attention_phase(torch, F, fa, results):
    """Phase a: K1 and K2 at the MAE pretraining shapes, bf16, forward and
    backward, each against its plain version (``check_kernel``,
    ``check_backward_kernel``: the kernel phase's tolerances), timed beside
    the plain versions and SDPA; one summary line with each shape's
    launches in a ViT MAE step."""
    bf16 = torch.bfloat16
    cases = (
        ("K1", dict(label="mae_vit_b16_encoder", shape=(MAE_BATCH, 50, 12, 64),
                    dtype=bf16, seed=100), "ViT-B/16 encoder: 12 a step"),
        ("K1", dict(label="mae_vit_l16_encoder", shape=(MAE_BATCH, 50, 16, 64),
                    dtype=bf16, seed=101), "ViT-L/16 encoder: 24 a step"),
        ("K2", dict(label="mae_decoder_d32", shape=(MAE_BATCH, 16, 197, 32),
                    dtype=bf16, seed=102, packed=True),
         "ViT-B/16 and L/16 decoders: 8 a step"),
        ("K2", dict(label="mae_vit_h14_encoder_d80",
                    shape=(MAE_BATCH, 16, 65, 80), dtype=bf16, seed=103,
                    packed=True), "ViT-H/14 encoder: 32 a step"))
    summary = {}
    for name, case, per_step in cases:
        check_kernel(torch, F, fa, name, case, results)
        check_backward_kernel(torch, F, fa, name, case, results)
        fwd, bwd = results[name][-1], results[name + " bwd"][-1]
        summary[case["label"]] = {
            "kernel": name, "shape": list(case["shape"]),
            "launches_per_step": per_step,
            "fwd": {k: fwd[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "max_abs_err")},
            "bwd": {k: bwd[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "max_abs_err")}}
        torch.cuda.empty_cache()
    log("mae attention shapes", library="SDPA", timed="CUDA events, device "
        "only", **summary)


def mae_loss_and_gradients(torch, model, images, label, noise):
    """Loss and fp32 gradients of one MAE micro-batch at the given noise,
    in the dtype the model's layers compute in."""
    from simpleaicv_pytorch_training_examples_tpu_torch.masked_image_modeling.losses import (
        MSELoss)
    dtype = model.encoder.patch_embed.compute_dtype
    model.train()
    model.zero_grad(set_to_none=True)
    pred, mask = model(images.to(dtype), noise=noise)
    loss = MSELoss()(pred, label, mask)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


class computing_in:
    """Within the block, every layer of ``model`` that casts for itself
    computes in ``dtype``."""

    def __init__(self, model, dtype):
        self.saved = [(m, m.compute_dtype) for m in model.modules()
                      if hasattr(m, "compute_dtype")]
        self.dtype = dtype

    def __enter__(self):
        for m, _ in self.saved:
            m.compute_dtype = self.dtype
        return self

    def __exit__(self, *exc):
        for m, dtype in self.saved:
            m.compute_dtype = dtype


def mae_attention_switch(model, on):
    from simpleaicv_pytorch_training_examples_tpu_torch.models.common import (
        MultiHeadSelfAttention)
    for m in model.modules():
        if isinstance(m, MultiHeadSelfAttention):
            m.use_fused_attention = on


class keys_dropped:
    """Within the block, every K1 and K2 call of the model layers drops its
    last ``n`` keys (``n_real = N - n``): the control of the gradient
    reading."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        from simpleaicv_pytorch_training_examples_tpu_torch.models import (
            common)
        self.common = common
        self.saved = common.fused_attention_dense, common.fused_attention
        dense, short = self.saved
        n = self.n
        common.fused_attention_dense = (
            lambda qkv, h, n_real=None, sm_scale=None:
            dense(qkv, h, qkv.shape[1] - n, sm_scale))
        common.fused_attention = (
            lambda q, k, v, n_real=None, bias=None:
            short(q, k, v, q.shape[2] - n))
        return self

    def __exit__(self, *exc):
        (self.common.fused_attention_dense,
         self.common.fused_attention) = self.saved


def check_mae_gradients(torch, fa, ln, model, seed):
    """Phase c's gradients: one bf16 micro-batch of MAE_GRAD_BATCH images,
    the blocks' qkv weights redrawn LeCun-normal so that attention is sharp
    (scores of unit std), the masking noise fixed. The kernels' gradients
    and the plain bf16 attention's, each against the same model in fp32
    with plain attention, by ``gradient_reading`` (the model's bf16 floor);
    then a control, the kernels with every attention's last
    MAE_CONTROL_KEYS keys dropped, must fail that reading."""
    from simpleaicv_pytorch_training_examples_tpu_torch.models.common import (
        MultiHeadSelfAttention)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MultiHeadSelfAttention):
                m.qkv.weight.normal_(0.0, m.qkv.in_features ** -0.5,
                                     generator=gen)
    b = MAE_GRAD_BATCH
    images = torch.rand(b, 3, 224, 224, device="cuda", generator=gen)
    label = torch.randn(b, 196, 768, device="cuda", generator=gen)
    noise = torch.rand(b, 196, device="cuda", generator=gen)
    reset_counts(fa, ln)
    loss_k, grads_k = mae_loss_and_gradients(torch, model, images, label,
                                             noise)
    torch.cuda.synchronize()
    counts = read_counts(fa, ln)
    expect_counts("MAE gradients", counts, K1=12, K1_bwd=12, K2=8, K2_bwd=8)
    with keys_dropped(MAE_CONTROL_KEYS):
        loss_c, grads_c = mae_loss_and_gradients(torch, model, images, label,
                                                 noise)
    mae_attention_switch(model, False)
    loss_p, grads_p = mae_loss_and_gradients(torch, model, images, label,
                                             noise)
    with computing_in(model, torch.float32):
        loss_f, grads_f = mae_loss_and_gradients(torch, model, images, label,
                                                 noise)
    mae_attention_switch(model, True)
    noise_only, left_ratio, held_ratio = zero_gradient_leaves(grads_f)
    ok, fields, _, _, _ = gradient_reading(
        grads_k, [grads_p], grads_f, (loss_k, [loss_p], loss_f), noise_only)
    control_ok, control, _, _, _ = gradient_reading(
        grads_c, [grads_p], grads_f, (loss_c, [loss_p], loss_f), noise_only)
    log("mae_vit_b16 sharp attention gradients vs plain attention", batch=b,
        **fields, left_out=noise_only, left_out_max_ratio=left_ratio,
        held_min_ratio=held_ratio, launches=counts,
        control=f"last {MAE_CONTROL_KEYS} keys of every attention dropped",
        control_worst_parameter=control["worst_parameter"],
        control_worst_rel_l2=control["worst_rel_l2"],
        control_worst_floor=control["worst_floor"],
        control_fails=not control_ok)
    if not ok:
        raise AssertionError(f"MAE gradients with the kernels disagree with "
                             f"plain attention: {fields}")
    if control_ok:
        raise AssertionError(f"the MAE gradient reading passes with "
                             f"{MAE_CONTROL_KEYS} keys dropped: {control}")


def device_batch(torch, batch, size, labels, seed, classes=1000):
    """A batch on the card from a seed: images [batch, 3, size, size] and
    labels: "int" class indices, "soft" one-hot rows, or a shape tuple of
    normal values (MAE's patch targets)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn(batch, 3, size, size, device="cuda", generator=gen)
    if isinstance(labels, tuple):
        label = torch.randn(batch, *labels, device="cuda", generator=gen)
    else:
        label = torch.randint(0, classes, (batch,), device="cuda",
                              generator=gen)
        if labels == "soft":
            label = torch.nn.functional.one_hot(label, classes).float()
    return {"image": images, "label": label}


def config_on_card(torch, directory, cut=None, module="train_config"):
    """A port config loaded with its model built on the meta device,
    ``cut(model)`` applied (a depth cut), then materialised on the CPU,
    initialised from the config's seed and moved to the card by
    ``init_model``."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import init_model
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
        load_config_from_work_dir)
    with torch.device("meta"):
        config = load_config_from_work_dir(str(directory), module)
    if cut is not None:
        cut(config.model)
    config.model = init_model(config.model.to_empty(device="cpu"),
                              config.seed)
    return config


def timed_steps(torch, train_step, batch, steps, first_iteration=0):
    """``steps`` train steps on one batch (iterations from
    ``first_iteration``), each read back; returns (losses, ms a step on the
    host clock after the first, peak GB)."""
    losses = [train_step(batch, first_iteration)["loss"].item()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(1, steps):
        losses.append(train_step(batch, first_iteration + i)["loss"].item())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / max(steps - 1, 1)
    return losses, ms, torch.cuda.max_memory_allocated() / 2 ** 30


def mae_step_phase(torch, fa, ln, mae_dir):
    """Phase c: the MAE ViT-B/16 train step alone at the config's batch on
    device-side random images; a 20-step run on one small batch with the
    mask held fixed (one iteration index, so one noise draw), whose loss
    must fall; the sharp-attention gradient check and its control."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_train_step)
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        train_mae_self_supervised_model as mae_cli)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import build_optimizer
    from simpleaicv_pytorch_training_examples_tpu_torch.utils.flops import (
        compute_flops_and_params)
    config = config_on_card(torch, mae_dir)
    model = config.model
    optimizer, _ = build_optimizer(config, model, IMAGENET_STEPS)
    train_step = make_train_step(
        model, None, optimizer, seed=config.seed,
        loss_fn=mae_cli.build_loss_fn(model, config))
    batch = device_batch(torch, config.batch_size, 224, (196, 768), 12)
    reset_counts(fa, ln)
    train_step(batch, 0)
    torch.cuda.synchronize()
    counts = read_counts(fa, ln)
    expect_counts("MAE ViT-B/16 train step", counts, K1=12, K1_bwd=12, K2=8,
                  K2_bwd=8)
    torch.cuda.reset_peak_memory_stats()
    step = iter(range(1, 10 ** 6))
    ms = time_ms(torch, lambda: train_step(batch, next(step)), iters=5,
                 warmup=2, device_only=False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flops, n_params = compute_flops_and_params(model, (1, 3, 224, 224))
    step_flops = 3 * config.batch_size * flops
    log(f"mae_vit_b16 train step {config.batch_size}",
        batch=config.batch_size, dtype="bf16", launches_per_step=counts,
        ms=ms, images_per_s=config.batch_size / ms * 1e3,
        tflops=step_flops / ms / 1e9,
        share_of_bf16_peak=step_flops / ms / 1e9 / 989.0,
        gflop_per_image_forward=flops / 1e9, params=n_params,
        counted="3x the forward's FlopCounterMode count (utils/flops.py)",
        peak_memory_gb=peak, timed="host clock, each step read back")

    one = {k: v[:MAE_ONE_BATCH] for k, v in batch.items()}
    optimizer, _ = build_optimizer(OneBatchConfig, model, 20)
    train_step = make_train_step(
        model, None, optimizer, seed=config.seed,
        loss_fn=mae_cli.build_loss_fn(model, config))
    losses = [train_step(one, 0)["loss"].item() for _ in range(20)]
    log("mae_vit_b16 one-batch run", batch=MAE_ONE_BATCH, steps=20,
        mask="held fixed (iteration 0 each step)", first_loss=losses[0],
        last_loss=losses[-1], losses=losses)
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"MAE one-batch losses did not fall: {losses}")
    check_mae_gradients(torch, fa, ln, model, MAE_GRAD_SEED)
    return {"ms": ms, "peak_memory_gb": peak, "gflop_per_image": flops / 1e9}


def mae_large_phase(torch, fa, ln, experiments):
    """Phase d: MAE ViT-L/16 and ViT-H/14 at full width, MAE_DEPTH encoder
    blocks and the full 8-block decoder, through init_model ->
    build_optimizer -> make_train_step at the config's batch: a few steps,
    finite losses, the launches counted (ViT-H/14's config checkpoints each
    block, so each forward runs twice)."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_train_step)
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        train_mae_self_supervised_model as mae_cli)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import build_optimizer
    d = MAE_DEPTH
    for name, label, patches, expected in (
            ("mae_vit_large_patch16_224", "mae_vit_l16", (196, 768),
             dict(K1=d, K1_bwd=d, K2=8, K2_bwd=8)),
            ("mae_vit_huge_patch14_224", "mae_vit_h14", (256, 588),
             dict(K2=2 * (d + 8), K2_bwd=d + 8))):
        def cut(model):
            model.encoder.blocks = model.encoder.blocks[:d]
        config = config_on_card(
            torch, experiments / "masked_image_modeling" / "imagenet" / name,
            cut)
        model = config.model
        optimizer, _ = build_optimizer(config, model, IMAGENET_STEPS)
        train_step = make_train_step(
            model, None, optimizer, seed=config.seed,
            loss_fn=mae_cli.build_loss_fn(model, config))
        batch = device_batch(torch, config.batch_size, 224, patches, 13)
        reset_counts(fa, ln)
        train_step(batch, 0)
        torch.cuda.synchronize()
        counts = read_counts(fa, ln)
        expect_counts(f"{label} train step", counts, **expected)
        losses, ms, peak = timed_steps(torch, train_step, batch, 3, 1)
        log(f"{label} train steps", reduced=f"encoder blocks {d}",
            batch=config.batch_size,
            gradient_checkpoint=model.encoder.use_gradient_checkpoint,
            launches_per_step=counts, losses=losses, ms=ms,
            images_per_s=config.batch_size / ms * 1e3, peak_memory_gb=peak,
            timed="host clock, each step read back")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{label}: non-finite losses {losses}")
        del config, model, optimizer, train_step, batch
        torch.cuda.empty_cache()


def distill_step_phase(torch, directory):
    """Phase f's step: the KD config's train step alone at its batch on
    device-side random images, with peak memory."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_train_step)
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        train_distill_classification_model as distill_cli)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import build_optimizer
    config = distill_cli.freeze_teacher_lr(config_on_card(torch, directory))
    model = config.model
    optimizer, _ = build_optimizer(config, model, IMAGENET_STEPS // 4)
    train_step = make_train_step(
        model, None, optimizer, seed=config.seed,
        loss_fn=distill_cli.build_loss_fn(model, config))
    batch = device_batch(torch, config.batch_size, 224, "int", 14)
    losses, ms, peak = timed_steps(torch, train_step, batch, 6)
    log(f"resnet_152_kd_50 train step {config.batch_size}",
        batch=config.batch_size, dtype="bf16", ms=ms,
        images_per_s=config.batch_size / ms * 1e3, peak_memory_gb=peak,
        losses=losses, timed="host clock, each step read back")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"KD step: non-finite losses {losses}")
    return {"ms": ms, "peak_memory_gb": peak}


def distill_phase(torch, fa, ln, experiments):
    """Phase f: ResNet-152 -> ResNet-50 through the distillation train CLI
    at full width and depth, batch 256, bf16, on the JPEG folder of the
    ImageNet phases: the KD config (a frozen teacher) and the DML config
    with ViT-style augmentation (RandAugment through Pillow, Mixup/CutMix),
    one epoch of 2 steps each, then resumed for a second; the student
    scored each epoch. The frozen teacher ends bit for bit as its seeded
    init, parameters and BatchNorm buffers; both DML networks move."""
    from simpleaicv_pytorch_training_examples_tpu_torch.distillation import KDModel
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import init_model
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        train_distill_classification_model as distill_cli)
    root = experiments / "distillation" / "imagenet"
    for name, freeze in (("resnet_152_kd_50", True),
                         ("resnet_152_dml_50_vit_aug", False)):
        work_dir = SMOKE_DIR / f"distill_{name}"
        runs = run_train_cli(
            distill_cli, work_dir, root / name / "train_config.py",
            f"{name} distill cli", ((1, 1), (2, 2)),
            {"    epochs = 100\n": "    epochs = {epochs}\n"}, fa, ln)
        state = torch.load(work_dir / "checkpoints" / "latest.pth",
                           map_location="cpu",
                           weights_only=False)["model_state_dict"]
        seeded = init_model(KDModel("resnet152", "resnet50",
                                    freeze_teacher=freeze,
                                    dtype=torch.bfloat16), 0,
                            "cpu").state_dict()
        moved = {part: sum(not torch.equal(t, seeded[n])
                           for n, t in state.items() if n.startswith(part))
                 for part in ("teacher.", "student.")}
        log(f"{name} distill cli state", freeze_teacher=freeze,
            tensors_moved=moved,
            tensors={p: sum(n.startswith(p) for n in state)
                     for p in ("teacher.", "student.")},
            student_top1=[e["top1"] for r in runs for e in r["epochs"]],
            losses={k: [e[k] for r in runs for e in r["epochs"]]
                    for k in runs[0]["epochs"][0] if k.endswith("Loss_avg")})
        if moved["student."] == 0 or (moved["teacher."] == 0) != freeze:
            raise AssertionError(f"{name}: tensors moved {moved}")


def muon_phase(torch, experiments):
    """Phase g: the ViT-B/16 fine-tune config's copy with Muon, a few steps
    on one batch through make_train_step (finite, falling losses), timed
    against the same steps with the config's AdamW (finite losses); the
    Muon/AdamW split is the JAX report's (49 and 103 tensors, held on the
    CPU against the JAX package)."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_train_step)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import build_optimizer
    directory = (experiments / "imagenet" /
                 "vit_base_patch16_for_official_mae_pretrain")
    fields = {}
    for name in ("Muon", "AdamW"):
        config = config_on_card(torch, directory)
        if name == "Muon":
            config.optimizer = ("Muon", MUON_PARAMS)
        # one step an epoch: the 5 warm-up epochs are the first 5 steps
        optimizer, report = build_optimizer(config, config.model, 1)
        train_step = make_train_step(
            config.model, config.train_criterion, optimizer,
            accumulation_steps=config.accumulation_steps, seed=config.seed)
        batch = device_batch(torch, config.batch_size, 224, "soft", 15)
        losses, ms, peak = timed_steps(torch, train_step, batch, MUON_STEPS)
        fields[name] = {"ms": ms, "losses": losses, "peak_memory_gb": peak}
        if name == "Muon":
            fields["split"] = {g["optimizer"]: len(g["name"]) for g in report}
        if not all(map(math.isfinite, losses)) or (
                name == "Muon" and losses[-1] >= losses[0]):
            raise AssertionError(f"{name} steps: losses {losses}")
        del config, optimizer, train_step, batch
        torch.cuda.empty_cache()
    log("vit_b16 muon train steps", batch=256, micro_batches=4,
        muon=MUON_PARAMS, timed="host clock, each step read back", **fields)
    if fields["split"] != {"Muon": 49, "AdamW": 103}:
        raise AssertionError(f"Muon/AdamW split {fields['split']}")


def every_config_phase(torch, experiments):
    """Phase h: every ResNet and ViT config of this slice built on the card
    at full width and depth (the ViT-L/H ones at MAE_DEPTH blocks), one
    train step at the config's batch on device-side random images with a
    finite loss (``config_train_step``)."""
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        train_imagenet21k_classification_model as in21k_cli)
    readings = {}
    for rel in CONFIGS_OF_THIS_SLICE:
        def cut(model):
            if "vit_large" in rel or "vit_huge" in rel:
                model.blocks = model.blocks[:MAE_DEPTH]
        config = config_on_card(torch, experiments / rel, cut)
        _, _, readings[rel] = config_train_step(torch, config, rel, in21k_cli)
        del config
        torch.cuda.empty_cache()
    log("configs of this slice, one train step each",
        reduced=f"ViT-L/16 and ViT-H/14 at {MAE_DEPTH} blocks",
        configs=len(readings), **readings)


def mae_distill_slice(torch, F, fa, ln, results, train_cli):
    """Phases a-h (``main``'s 26-33): MAE pretraining, the step from MAE to
    classification, distillation, Muon and every config of this slice.
    Returns phase c's and f's step readings."""
    import os

    from simpleaicv_pytorch_training_examples_tpu_torch import native
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        train_mae_self_supervised_model as mae_cli)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils.flops import (
        compute_flops_and_params)
    experiments = REPO / PACKAGE / "experiments"
    mae_dir = experiments / "masked_image_modeling" / "imagenet" / \
        "vit_b_16_224_mae_pretrain"
    data_root = SMOKE_DIR / "data"
    os.environ["SIMPLEAICV_DATA_ROOT"] = str(data_root)
    native.lib()   # the JPEG phases need libjpeg; raises where it is missing
    jpeg_folder(data_root / "ILSVRC2012",
                {"train": RESNET_TRAIN_IMAGES, "val": RESNET_EVAL_IMAGES})

    phase_start("26")
    # a. K1 and K2 at the MAE shapes against their plain versions
    mae_attention_phase(torch, F, fa, results)

    phase_start("27")
    # b. MAE ViT-B/16 through the MAE train CLI: one epoch, then the same
    #    command resumed for a second, and an uninterrupted run of two
    #    epochs over the same batches (recorded from the first runs' loader
    #    and replayed: the loader's resume is exact by its seeds, held on
    #    the CPU), which must end bit for bit where the resumed one does
    #    (cuDNN's deterministic algorithms, for the patch embedding's
    #    convolution, within this phase; the warm-up cut to 3 epochs keeps
    #    both runs' lr the same, where a cosine past it would follow the
    #    epochs each run was given)
    mae_root = SMOKE_DIR / "mae_data"
    jpeg_folder(mae_root / "ILSVRC2012", {"train": MAE_IMAGES})
    changes = {
        '    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), '
        '"ILSVRC2012")\n': f'    {str(mae_root)!r}, "ILSVRC2012")\n',
        "    epochs = 400\n": "    epochs = {epochs}\n",
        '            "warm_up_epochs": 40,\n':
        '            "warm_up_epochs": 3,\n'}
    steps = MAE_IMAGES // MAE_BATCH
    expected = lambda n: dict(K1=12 * steps * n, K1_bwd=12 * steps * n,
                              K2=8 * steps * n, K2_bwd=8 * steps * n)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with recorded_epochs({}):
            parts = run_train_cli(mae_cli, SMOKE_DIR / "mae_parts",
                                  mae_dir / "train_config.py",
                                  "mae_vit_b16 train cli", ((1, 1), (2, 2)),
                                  changes, fa, ln, expected)
            whole = run_train_cli(mae_cli, SMOKE_DIR / "mae_whole",
                                  mae_dir / "train_config.py",
                                  "mae_vit_b16 train cli uninterrupted, "
                                  "the same batches replayed", ((2, 1),),
                                  changes, fa, ln, expected)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = (torch.load(SMOKE_DIR / d / "checkpoints" / "latest.pth",
                       map_location="cpu", weights_only=False)
            for d in ("mae_whole", "mae_parts"))
    same_model = all(torch.equal(t, b["model_state_dict"][n])
                     for n, t in a["model_state_dict"].items())
    same_optimizer = all(
        torch.equal(t, b["optimizer_state_dict"][slot][n])
        for slot in ("mu", "nu")
        for n, t in a["optimizer_state_dict"][slot].items())
    resumed, uninterrupted = parts[1]["epochs"][0], whole[0]["epochs"][1]
    log("mae_vit_b16 train cli", batch=MAE_BATCH, train_images=MAE_IMAGES,
        config_changes=["data root: " + str(mae_root), "epochs: 400 -> 2",
                        "warm_up_epochs: 40 -> 3 (every epoch of both runs in the "
                        "linear warm-up, whose lr does not depend on the "
                        "epochs set)"],
        launches_per_step=dict(K1=12, K1_bwd=12, K2=8, K2_bwd=8),
        resumed_epoch_loss=resumed["loss_avg"],
        uninterrupted_epoch_loss=uninterrupted["loss_avg"],
        same_model_bits=same_model, same_optimizer_bits=same_optimizer,
        losses=[e["loss_avg"] for r in whole for e in r["epochs"]])
    if not (same_model and same_optimizer
            and resumed["loss_avg"] == uninterrupted["loss_avg"]):
        raise AssertionError("the resumed MAE epoch differs from the "
                             "uninterrupted one")
    torch.cuda.empty_cache()

    phase_start("28")
    # c. the MAE step alone, a one-batch run and the gradient check
    mae_step = mae_step_phase(torch, fa, ln, mae_dir)
    torch.cuda.empty_cache()

    phase_start("29")
    # d. MAE ViT-L/16 and ViT-H/14 at reduced encoder depth
    mae_large_phase(torch, fa, ln, experiments)

    phase_start("30")
    # e. from MAE to classification: the self-train ViT-B/16 config from
    #    phase b's best.pth, one epoch of 2 steps through the classification
    #    train CLI; its load reads as the CPU test of that mapping says (no
    #    tensor of the encoder.-named checkpoint loads, none is skipped)
    best = SMOKE_DIR / "mae_parts" / "checkpoints" / "best.pth"
    vit_dir = SMOKE_DIR / "vit_b16_self_train"
    micro = 4 * RESNET_TRAIN_IMAGES // 256
    run_train_cli(
        train_cli, vit_dir, experiments / "imagenet" /
        "vit_base_patch16_for_self_train_mae_pretrain" / "train_config.py",
        "vit_b16 self-train cli", ((1, 1),),
        {"    epochs = 100\n": "    epochs = {epochs}\n",
         '    trained_model_path = ""\n':
         f"    trained_model_path = {str(best)!r}\n"}, fa, ln,
        lambda n: dict(K1=12 * micro * n + 12, K1_bwd=12 * micro * n))
    train_log = (vit_dir / "log" / "train.log").read_text()
    loaded = re.search(r"pretrained load: (\d+)/(\d+) tensors", train_log)
    skipped = len(re.findall(r"INFO: skip \S+: shape", train_log))
    log("vit_b16 self-train load", checkpoint=str(best),
        loaded=int(loaded.group(1)), total=int(loaded.group(2)),
        skipped=skipped, cpu_test="0 loaded, 0 skipped "
        "(test_an_mae_checkpoint_loads_into_the_self_train_vit_as_in_jax)")
    if (int(loaded.group(1)), skipped) != (0, 0):
        raise AssertionError(f"MAE -> ViT load: {loaded.group(0)}, "
                             f"{skipped} skipped")

    phase_start("31")
    # f. distillation through the distill train CLI, and the KD step alone
    distill_phase(torch, fa, ln, experiments)
    kd_step = distill_step_phase(torch, experiments / "distillation" /
                                 "imagenet" / "resnet_152_kd_50")
    torch.cuda.empty_cache()

    phase_start("32")
    # g. Muon against AdamW on the ViT-B/16 fine-tune config
    muon_phase(torch, experiments)

    phase_start("33")
    # h. every ResNet and ViT config of this slice; ResNet-50's test-CLI
    #    line (phase 10h's best.pth eval) with the FLOP and parameter count
    every_config_phase(torch, experiments)
    test_log = SMOKE_DIR / "resnet50_train" / "log" / "test.log"
    line = re.search(r"model params: [\d.]+ M, flops: [\d.]+ G",
                     test_log.read_text())
    config = config_on_card(torch, experiments / "imagenet" / "resnet50")
    flops, n_params = compute_flops_and_params(config.model,
                                               (1, 3, 224, 224))
    want = f"model params: {n_params / 1e6:.3f} M, flops: {flops / 1e9:.3f} G"
    log("resnet50 test cli line", line=line and line.group(0), counted=want)
    if line is None or line.group(0) != want:
        raise AssertionError(f"ResNet-50 test CLI line {line}: want {want}")
    return {"mae_step": mae_step, "kd_step": kd_step}



# phases a-g of the data-parallel, backbone and encoder-distillation slice
# (35-41)
DINOV3_K2_CASES = (("vit_b16", (64, 12, 1024, 64), "ViT-B/16 at 512^2"),
                   ("vit_l16", (32, 16, 1024, 64), "ViT-L/16 at 512^2"))
DINOV3_GRAD_BATCH = {"vit_b16": 4, "vit_l16": 2}
DINOV3_SEED, DINOV3_CONTROL_KEYS = 13, 8
DINOV3_RESCALE_DRAW = 0.3          # log of the RoPE rescale, held fixed
BACKBONE_CONFIGS = ("darknettiny", "darknet19", "darknet53", "van_b0",
                    "van_b1", "van_b2", "van_b3", "convformer_s18",
                    "convformer_s36", "convformer_m36", "convformer_b36")
TIMED_BACKBONE_CONFIGS = ("darknet53", "van_b0", "convformer_m36")
DISTILL_BATCH = 2                  # of the configs' 64: fits beside the teacher
DISTILL_ONE_BATCH_STEPS = 10
BN_ATOL = 2e-2                     # bf16 y of |y| <= 4, a few ulps
BN_GRAD_REL = 1e-2

# the train CLI with cuDNN's deterministic algorithms, so that two runs of
# one config can be held bit for bit (phase a)
DDP_LAUNCHER = """
import sys

import torch

from simpleaicv_pytorch_training_examples_tpu_torch.tools.train_classification_model import main

if __name__ == "__main__":   # the loader's workers come from a forkserver
    torch.backends.cudnn.deterministic = True
    main(sys.argv[1:])
"""


def batch_norm_reading(torch, bn, forward):
    """A training BatchNorm, ``forward(x)`` with ``bn``'s weight and bias
    (drawn here), against ``F.batch_norm`` in fp32 on a bf16 channels_last
    map: y within BN_ATOL, dx, dgamma and dbeta within a relative L2
    distance of BN_GRAD_REL. Returns (ok, reading, x)."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = (torch.randn(64, 96, 28, 28, device="cuda", generator=gen) * 2 + 0.5
         ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape, device="cuda", generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
    bn.weight.grad = bn.bias.grad = None
    leaf = x.detach().requires_grad_()
    y = forward(leaf)
    y.backward(dy)
    ref_leaf = x.detach().float().requires_grad_()
    w = bn.weight.detach().clone().requires_grad_()
    b = bn.bias.detach().clone().requires_grad_()
    ref = torch.nn.functional.batch_norm(ref_leaf, None, None, w, b, True,
                                         0.0, 1e-5)
    ref.backward(dy.float())
    rel = lambda g, r: ((g.float() - r).norm() / r.norm()).item()
    reading = {"y_max_abs_err": (y.float() - ref).abs().max().item(),
               "dx_rel_l2": rel(leaf.grad, ref_leaf.grad),
               "dgamma_rel_l2": rel(bn.weight.grad, w.grad),
               "dbeta_rel_l2": rel(bn.bias.grad, b.grad)}
    ok = (reading["y_max_abs_err"] <= BN_ATOL
          and max(reading[k] for k in reading if k.endswith("rel_l2"))
          <= BN_GRAD_REL)
    return ok, reading, x


def batch_norm_phase(torch):
    """Phase a's BatchNorm checks (``batch_norm_reading``): the port's
    ``BatchNorm2d`` in one process (``native_batch_norm``), its running
    variance Flax's (biased) within 1e-4; then ``_global_batch_norm``, the
    path of a world of more than one process, in an NCCL group of this one
    process, so that its forward's and backward's ``all_reduce`` run on the
    card. The merge over several ranks is held only by the CPU tests' two
    ``gloo`` processes, on the same code: this machine has one GPU."""
    import socket

    import torch.distributed as dist

    from simpleaicv_pytorch_training_examples_tpu_torch.models import common
    bn = common.BatchNorm2d(96, dtype=torch.bfloat16).cuda().train()
    ok, reading, x = batch_norm_reading(torch, bn, bn)
    var = x.float().var(dim=(0, 2, 3), unbiased=False)
    reading["running_var_err"] = (bn.running_var - (0.9 + 0.1 * var)
                                  ).abs().max().item()
    log("BatchNorm2d one process vs F.batch_norm", shape=list(x.shape),
        dtype="bf16 channels_last", **reading, y_tol=BN_ATOL,
        grad_tol=BN_GRAD_REL)
    if not (ok and reading["running_var_err"] <= 1e-4):
        raise AssertionError(f"BatchNorm2d: {reading}")
    with socket.socket() as free:
        free.bind(("localhost", 0))
        port = free.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        ok, reading, _ = batch_norm_reading(
            torch, bn,
            lambda t: common._global_batch_norm(t, bn.weight, bn.bias,
                                                bn.eps)[0])
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    log("_global_batch_norm in an NCCL group vs F.batch_norm",
        world_size=1, shape=list(x.shape), dtype="bf16 channels_last",
        **reading, y_tol=BN_ATOL, grad_tol=BN_GRAD_REL)
    if not ok:
        raise AssertionError(f"_global_batch_norm: {reading}")


def ddp_phase(torch, experiments):
    """Phase a: the classification train CLI on ``cifar100/resnet18cifar``
    (two epochs of 4 steps, ``use_zero1``) without torchrun and under
    ``torchrun --nproc_per_node=1`` (NCCL, world size 1: the gradient
    all-reduce and ZeRO-1's all-gather run; BatchNorm, in a world of one,
    runs ``native_batch_norm`` as the run without torchrun does), each
    through a launcher that sets cuDNN's deterministic algorithms, the two
    at once on the card; every logged loss and the final parameters,
    BatchNorm buffers and optimizer moments must be equal bit for bit.
    First the training BatchNorm's checks (``batch_norm_phase``)."""
    import os

    batch_norm_phase(torch)
    launcher = SMOKE_DIR / "ddp_launch.py"
    launcher.write_text(DDP_LAUNCHER)
    text = config_text(
        experiments / "cifar100" / "resnet18cifar" / "train_config.py",
        **{"    epochs = 200\n": "    epochs = 2\n    use_zero1 = True\n",
           "    print_interval = 50\n": "    print_interval = 1\n",
           "    num_workers = 16\n": "    num_workers = 2\n"})
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs, runs = {}, {}
    t0 = time.perf_counter()
    for label, prefix in (   # both at once, on the one card
            ("plain", [sys.executable]),
            ("torchrun", [sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc_per_node=1"])):
        work_dir = SMOKE_DIR / f"ddp_{label}"
        shutil.rmtree(work_dir, ignore_errors=True)
        work_dir.mkdir(parents=True)
        (work_dir / "train_config.py").write_text(text)
        procs[label] = (work_dir, subprocess.Popen(
            prefix + [str(launcher), "--work-dir", str(work_dir)], env=env,
            cwd=str(work_dir), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for label, (work_dir, proc) in procs.items():
        output = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise AssertionError(f"{label} run: {output[-6000:]}")
        train_log = (work_dir / "log" / "train.log").read_text()
        state = torch.load(work_dir / "checkpoints" / "latest.pth",
                           map_location="cpu", weights_only=False)
        runs[label] = {"losses": re.findall(r"epoch \d+ iter \d+/\d+ .*",
                                            train_log),
                       "log": train_log, "state": state,
                       "seconds": time.perf_counter() - t0}
    a, b = runs["plain"], runs["torchrun"]
    same_losses = a["losses"] == b["losses"] and len(a["losses"]) == 8
    same_model = all(torch.equal(t, b["state"]["model_state_dict"][n])
                     for n, t in a["state"]["model_state_dict"].items())
    same_moments = all(
        torch.equal(t, b["state"]["optimizer_state_dict"][slot][n])
        for slot in ("momentum_buf",)
        for n, t in a["state"]["optimizer_state_dict"][slot].items())
    lines = {k: [ln_ for ln_ in r["log"].splitlines()
                 if "mesh:" in ln_ or "device:" in ln_ or "zero1" in ln_]
             for k, r in runs.items()}
    log("resnet18cifar torchrun world 1 vs one process",
        steps=len(a["losses"]), same_losses=same_losses,
        same_model_bits=same_model, same_moment_bits=same_moments,
        seconds={k: r["seconds"] for k, r in runs.items()},
        last_loss_line=b["losses"][-1] if b["losses"] else None,
        setup_lines=lines, launcher="cudnn.deterministic in both runs")
    if not ("device: cuda:0" in " ".join(lines["torchrun"])
            and "mesh: 1 devices" in " ".join(lines["torchrun"])
            and "zero1" in " ".join(lines["torchrun"])):
        raise AssertionError(f"torchrun run's setup: {lines['torchrun']}")
    if not (same_losses and same_model and same_moments):
        raise AssertionError("the torchrun run differs from the one-process "
                             f"run: losses {a['losses']} / {b['losses']}")


def dinov3_attention_phase(torch, F, fa, results):
    """Phase b: K2 at DINOv3's shapes (q and k rotated, contiguous [B, H,
    1024, 64]: ViT-B/16 and ViT-L/16 at 512^2), bf16, forward and backward
    against the plain version (``check_kernel``, ``check_backward_kernel``),
    timed beside SDPA, with the bound; one summary line."""
    summary = {}
    for i, (label, shape, model) in enumerate(DINOV3_K2_CASES):
        case = dict(label=f"dinov3_{label}_512", shape=shape,
                    dtype=torch.bfloat16, seed=110 + i)
        check_kernel(torch, F, fa, "K2", case, results)
        check_backward_kernel(torch, F, fa, "K2", case, results)
        fwd, bwd = results["K2"][-1], results["K2 bwd"][-1]
        summary[case["label"]] = {
            "model": model, "shape": list(shape),
            "fwd": {k: fwd[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "max_abs_err")},
            "bwd": {k: bwd[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "max_abs_err")}}
        torch.cuda.empty_cache()
    log("dinov3 attention shapes", library="SDPA",
        timed="CUDA events, device only", **summary)


def dinov3_loss_and_gradients(torch, model, images, target):
    """Loss (mean of the grid features times ``target``) and fp32 gradients
    of one train micro-batch at the fixed RoPE draw."""
    draws = {"rescale": torch.tensor([DINOV3_RESCALE_DRAW], device="cuda")}
    dtype = model.patch_embed.compute_dtype
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(images.to(dtype), rope_draws=draws)
    loss = (out.float() * target).mean()
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


class dinov3_keys_dropped:
    """Within the block, every K2 call of the DINOv3 blocks drops its last
    ``n`` keys: the gradient reading's control."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import (
            dinov3_vit)
        self.module, self.saved = dinov3_vit, dinov3_vit.fused_attention
        short, n = self.saved, self.n
        dinov3_vit.fused_attention = lambda q, k, v: short(q, k, v,
                                                           q.shape[2] - n)
        return self

    def __exit__(self, *exc):
        self.module.fused_attention = self.saved


def dinov3_switch(model, on):
    for block in model.blocks:
        block.attn.use_fused_attention = on


def dinov3_phase(torch, fa, ln):
    """Phases c and d: DINOv3 ViT-B/16 and ViT-L/16 (full width and depth,
    bf16, ``use_fused_attention``) at 512^2, N = 1024: an eval forward with
    K2 counted at 12 and 24; the gradients of one train micro-batch (the
    RoPE rescale held at one draw) with the qkv weights redrawn LeCun-normal
    (scores of unit std), the kernels' and the plain bf16 path's against
    the fp32 plain path by ``gradient_reading``, and a control that drops
    every K2 call's last DINOV3_CONTROL_KEYS keys and must fail it. Then
    ViT-B/16 at 1024^2 (N = 4096): the plain path, K2 counted at 0."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import init_model
    from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import (
        dinov3_vit)
    gen = torch.Generator(device="cuda").manual_seed(DINOV3_SEED)
    for label, factory, depth in (
            ("vit_b16", dinov3_vit.dinov3_vit_base_patch16_backbone, 12),
            ("vit_l16", dinov3_vit.dinov3_vit_large_patch16_backbone, 24)):
        model = init_model(factory(dtype=torch.bfloat16,
                                   use_fused_attention=True), DINOV3_SEED)
        b = DINOV3_GRAD_BATCH[label]
        images = torch.randn(b, 3, 512, 512, device="cuda", generator=gen)
        reset_counts(fa, ln)
        with torch.no_grad():
            out = model(images.to(torch.bfloat16))
        torch.cuda.synchronize()
        counts = read_counts(fa, ln)
        log(f"dinov3_{label} eval 512", batch=b, shape=list(out.shape),
            finite=bool(torch.isfinite(out).all()), launches=counts)
        expect_counts(f"DINOv3 {label} at 512^2", counts, K2=depth)
        if tuple(out.shape) != (b, model.embedding_planes, 32, 32) \
                or not torch.isfinite(out).all():
            raise AssertionError(f"DINOv3 {label} output {out.shape}")
        with torch.no_grad():
            for block in model.blocks:
                qkv = block.attn.qkv
                qkv.weight.normal_(0.0, qkv.in_features ** -0.5,
                                   generator=gen)
        target = torch.randn(out.shape, device="cuda", generator=gen)
        reset_counts(fa, ln)
        loss_k, grads_k = dinov3_loss_and_gradients(torch, model, images,
                                                    target)
        torch.cuda.synchronize()
        grad_counts = read_counts(fa, ln)
        expect_counts(f"DINOv3 {label} gradients", grad_counts, K2=depth,
                      K2_bwd=depth)
        with dinov3_keys_dropped(DINOV3_CONTROL_KEYS):
            loss_c, grads_c = dinov3_loss_and_gradients(torch, model, images,
                                                        target)
        dinov3_switch(model, False)
        loss_p, grads_p = dinov3_loss_and_gradients(torch, model, images,
                                                    target)
        with computing_in(model, torch.float32):
            loss_f, grads_f = dinov3_loss_and_gradients(torch, model, images,
                                                        target)
        dinov3_switch(model, True)
        noise_only, left_ratio, held_ratio = zero_gradient_leaves(grads_f)
        ok, fields, _, _, _ = gradient_reading(
            grads_k, [grads_p], grads_f, (loss_k, [loss_p], loss_f),
            noise_only)
        control_ok, control, _, _, _ = gradient_reading(
            grads_c, [grads_p], grads_f, (loss_c, [loss_p], loss_f),
            noise_only)
        log(f"dinov3_{label} sharp attention gradients vs plain attention",
            batch=b, **fields, left_out=noise_only,
            left_out_max_ratio=left_ratio, held_min_ratio=held_ratio,
            launches=grad_counts,
            control=f"last {DINOV3_CONTROL_KEYS} keys of every K2 dropped",
            control_worst_parameter=control["worst_parameter"],
            control_worst_rel_l2=control["worst_rel_l2"],
            control_worst_floor=control["worst_floor"],
            control_fails=not control_ok)
        if not ok:
            raise AssertionError(f"DINOv3 {label} gradients with K2 disagree "
                                 f"with plain attention: {fields}")
        if control_ok:
            raise AssertionError(f"the DINOv3 {label} gradient reading passes "
                                 f"with keys dropped: {control}")
        if label == "vit_b16":
            images = torch.randn(2, 3, 1024, 1024, device="cuda",
                                 generator=gen)
            reset_counts(fa, ln)
            model.eval()
            with torch.no_grad():
                out = model(images.to(torch.bfloat16))
            torch.cuda.synchronize()
            counts = read_counts(fa, ln)
            log("dinov3_vit_b16 eval 1024", batch=2, tokens=4096,
                shape=list(out.shape), finite=bool(torch.isfinite(out).all()),
                launches=counts, route="plain (N > 1024)")
            expect_counts("DINOv3 ViT-B/16 at 1024^2", counts)
            if not torch.isfinite(out).all():
                raise AssertionError("DINOv3 ViT-B/16 at 1024^2: non-finite")
        del model, grads_k, grads_c, grads_p, grads_f
        torch.cuda.empty_cache()


def config_train_step(torch, config, rel, in21k_cli=None):
    """One train step of a config's model at the config's batch on
    device-side random images (a batch above CONFIG_MICRO_CAP images of
    224^2 in micro-batches of that many pixels); returns (train_step, batch,
    metrics, seconds)."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_train_step)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import build_optimizer
    model = config.model
    optimizer, _ = build_optimizer(config, model, 100)
    size = config.input_image_size
    micro = config.batch_size // config.accumulation_steps
    accumulation = config.accumulation_steps * max(
        1, micro * size * size // (CONFIG_MICRO_CAP * 224 * 224))
    loss_fn = in21k_cli.build_loss_fn(model, config) \
        if rel.startswith("imagenet21k/") else None
    soft = type(config.train_criterion).__name__ == "OneHotLabelCELoss"
    train_step = make_train_step(
        model, config.train_criterion, optimizer,
        accumulation_steps=accumulation,
        clip_max_norm=getattr(config, "clip_max_norm", 0.0),
        clip_grad_value=getattr(config, "clip_grad_value", 0.0),
        seed=config.seed, loss_fn=loss_fn)
    batch = device_batch(torch, config.batch_size, size,
                         "soft" if soft else "int", 16, config.num_classes)
    t0 = time.perf_counter()
    metrics = train_step(batch, 0)
    loss = metrics["loss"].item()
    seconds = time.perf_counter() - t0
    if not math.isfinite(loss) or metrics["skipped"].item():
        raise AssertionError(f"{rel}: loss {loss}, skipped "
                             f"{metrics['skipped'].item()}")
    return train_step, batch, {"batch": config.batch_size,
                               "micro_batches": accumulation, "loss": loss,
                               "seconds": seconds}


def backbone_configs_phase(torch, fa, ln, experiments, eval_cli):
    """Phase e: the 11 DarkNet, VAN and ConvFormer ImageNet configs built on
    the card at full width and depth, one train step each at the config's
    batch (``config_train_step``), no hand-written kernel launched;
    DarkNet-53, VAN-B0 and ConvFormer-M36 through the eval CLI over the
    JPEG val folder, whose parameter and FLOP line must equal
    ``utils/flops.py``'s count. Returns, for those three, what
    ``backbone_steps_phase`` times once the kernels' build has ended."""
    from simpleaicv_pytorch_training_examples_tpu_torch.utils.flops import (
        compute_flops_and_params)
    readings, held = {}, {}
    reset_counts(fa, ln)
    for name in BACKBONE_CONFIGS:
        rel = f"imagenet/{name}"
        config = config_on_card(torch, experiments / rel)
        train_step, batch, readings[name] = config_train_step(torch, config,
                                                              rel)
        if name in TIMED_BACKBONE_CONFIGS:
            held[name] = (train_step, batch, config.batch_size)
            work_dir = SMOKE_DIR / f"{name}_eval"
            work_dir.mkdir(parents=True, exist_ok=True)
            for f in ("train_config.py", "test_config.py"):
                (work_dir / f).write_text((experiments / rel / f).read_text())
            # the test config imports train_config by name: this dir's
            sys.modules.pop("train_config", None)
            values = eval_cli.main(["--work-dir", str(work_dir)])
            line = re.search(r"model params: [\d.]+ M, flops: [\d.]+ G",
                             (work_dir / "log" / "test.log").read_text())
            size = config.input_image_size
            flops, n_params = compute_flops_and_params(
                config.model, (1, 3, size, size))
            want = (f"model params: {n_params / 1e6:.3f} M, flops: "
                    f"{flops / 1e9:.3f} G")
            readings[name].update(test_cli_line=line and line.group(0),
                                  counted=want, eval_images=values["images"],
                                  eval_images_per_s=values["images_per_s"],
                                  eval_timed="during the kernels' build")
            if line is None or line.group(0) != want \
                    or values["images"] != RESNET_EVAL_IMAGES:
                raise AssertionError(f"{name} test CLI: {readings[name]}")
        del config, train_step, batch
        torch.cuda.empty_cache()
    counts = read_counts(fa, ln)
    log("backbone configs, one train step each", configs=len(readings),
        launches=counts, **readings)
    expect_counts("DarkNet, VAN and ConvFormer configs", counts)
    return held


def resident_gb(torch):
    """GB the card still holds for other phases' objects: subtracted from a
    timed step's peak, read once that step's model, optimizer and batch are
    freed, so that the peak is the step's own."""
    return torch.cuda.memory_allocated() / 2 ** 30


def backbone_steps_phase(torch, fa, ln, held):
    """Phase e's timed part, once the kernels' build has ended: the train
    step of each config ``backbone_configs_phase`` kept, at its batch
    (images/s, peak memory), no hand-written kernel launched."""
    readings = {}
    reset_counts(fa, ln)
    while held:
        name, (train_step, batch, batch_size) = held.popitem()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, peak = timed_steps(torch, train_step, batch, 3, 1)
        del train_step, batch
        torch.cuda.empty_cache()
        readings[name] = dict(
            batch=batch_size, step_ms=ms, images_per_s=batch_size / ms * 1e3,
            peak_memory_gb=peak - resident_gb(torch), losses=losses,
            timed="host clock, each step read back, after the build")
    counts = read_counts(fa, ln)
    log("backbone configs, timed train steps", launches=counts,
        peak_memory="the step's, less what stays resident once its model, "
        "optimizer and batch are freed", **readings)
    expect_counts("DarkNet, VAN and ConvFormer timed steps", counts)


class teacher_watch:
    """Within the block, the runner's first model load (init and pretrained
    weights) records the distill model's teacher, and every checkpoint that
    the runner saves is compared with it bit for bit (``equal``: one bool a
    save)."""

    def __enter__(self):
        from simpleaicv_pytorch_training_examples_tpu_torch.engine import runner
        from simpleaicv_pytorch_training_examples_tpu_torch.utils.checkpoint import (
            CheckpointStore)
        self.runner, self.store = runner, CheckpointStore
        self.saved = runner.apply_pretrained, CheckpointStore.save_latest
        self.first, self.equal = None, []
        apply, save = self.saved

        def applied(model, logger=None):
            model = apply(model, logger)
            if self.first is None:
                self.first = {n: t.clone() for n, t in
                              model.state_dict().items()
                              if n.startswith("teacher.")}
            return model

        def saving(store, payload):
            state = payload["model_state_dict"]
            self.equal.append(all(torch_equal(t, state[n])
                                  for n, t in self.first.items()))
            return save(store, payload)

        runner.apply_pretrained = applied
        CheckpointStore.save_latest = saving
        return self

    def __exit__(self, *exc):
        self.runner.apply_pretrained, self.store.save_latest = self.saved


def torch_equal(a, b):
    return bool((a == b.to(a.device)).all()) and a.shape == b.shape


SYNTHETIC_SAM_IMPORT = (
    "from simpleaicv_pytorch_training_examples_tpu_torch.interactive_"
    "segmentation.datasets.syntheticdataset import SyntheticSAMDataset\n")


def encoder_distill_phase(torch, fa, ln, experiments):
    """Phase f: the 13.0 (SAM-H -> DINOv3 ViT-B/16) and 14.0 (Hiera-L ->
    DINOv3 ViT-B/16) configs through their train CLIs at 1024^2, full width
    and depth, fp32 as in JAX, on seeded synthetic SAM images (cut: batch
    64 -> DISTILL_BATCH, what fits beside the teacher; 2 steps an epoch):
    two epochs, then resumed for a third, no hand-written kernel launched
    (the teachers' attention is plain, the student's N = 4096 too); the
    teacher of every checkpoint saved bit for bit the teacher the first run
    loaded (``teacher_watch``). Returns, for each config, what
    ``encoder_distill_step_phase`` needs: the trained model stays on the
    card."""
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        train_interactive_segmentation_distill_encoder_model as sam_cli,
        train_video_interactive_segmentation_distill_encoder_model as sam2_cli)
    dataset_block = (
        "    train_dataset = SamSegmentationDataset(\n"
        "        interactive_segmentation_dataset_path,\n"
        "        set_name_list=[\"sa_000020\", \"sa_000021\", \"sa_000022\"],\n"
        "        set_type=\"train\")\n")
    changes = {
        "import os\n": "import os\n\n" + SYNTHETIC_SAM_IMPORT,
        dataset_block: (f"    train_dataset = SyntheticSAMDataset(n="
                        f"{2 * DISTILL_BATCH}, image_size=(768, 1024), "
                        "seed=4)\n"),
        "    batch_size = 64\n": f"    batch_size = {DISTILL_BATCH}\n",
        "    num_workers = 32\n": "    num_workers = 0\n",
        "    epochs = 4\n": "    epochs = {epochs}\n",
        "    print_interval = 50\n": "    print_interval = 1\n"}
    trained = []
    for label, cli, rel in (
            ("sam_h_distill_dinov3_vit_b16", sam_cli,
             "interactive_segmentation/sam_h_encoder_distill_dinov3_vit_"
             "base_patch16_encoder"),
            ("hiera_l_distill_dinov3_vit_b16", sam2_cli,
             "video_interactive_segmentation/hiera_l_encoder_distill_"
             "dinov3_vit_base_patch16_encoder")):
        work_dir = SMOKE_DIR / label
        path = experiments / rel / "train_config.py"
        with teacher_watch() as watch:
            runs = run_train_cli(cli, work_dir, path, f"{label} cli",
                                 ((2, 1), (3, 3)), changes, fa, ln)
        trained.append(dict(
            label=label, model=runs[-1].pop("model"),
            as_loaded=watch.equal,
            epoch_losses=[e["loss_avg"] for r in runs for e in r["epochs"]]))
        del runs
    return trained


def encoder_distill_step_phase(torch, fa, ln, trained):
    """Phase f's timed part, once the kernels' build has ended: for each
    model that ``encoder_distill_phase`` trained, DISTILL_ONE_BATCH_STEPS
    steps of constant-lr AdamW (the teacher's lr 0) on one batch, whose
    loss must fall, the teacher unchanged and no hand-written kernel
    launched, with the step's ms and peak memory; the teacher of every
    checkpoint the CLIs saved must have been the one first loaded."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_train_step)
    from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.sam_segmentation_dataset import (
        SAMCollater)
    from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.syntheticdataset import (
        SyntheticSAMDataset)
    from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.distill_losses import (
        MSELoss)
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        train_interactive_segmentation_distill_encoder_model as sam_cli)
    from simpleaicv_pytorch_training_examples_tpu_torch.tools.train_distill_classification_model import (
        freeze_teacher_lr)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
        build_optimizer)
    while trained:
        run = trained.pop(0)
        label, model, as_loaded = run["label"], run["model"], run["as_loaded"]
        config = freeze_teacher_lr(OneBatchConfig())
        config.train_criterion, config.use_amp = MSELoss(), True
        optimizer, _ = build_optimizer(config, model, 1)
        train_step = make_train_step(
            model, None, optimizer, seed=0,
            loss_fn=sam_cli.build_loss_fn(model, config))
        samples = [SyntheticSAMDataset(n=DISTILL_BATCH, image_size=(768, 1024),
                                       seed=9)[i]
                   for i in range(DISTILL_BATCH)]
        batch = {"image": SAMCollater(resize=1024, n_points=1,
                                      prompt_probs=(1.0, 0.0, 0.0))(
                                          samples)["image"].cuda()}
        before = {n: t.clone() for n, t in model.state_dict().items()
                  if n.startswith("teacher.")}
        reset_counts(fa, ln)
        losses, ms, peak = timed_steps(torch, train_step, batch,
                                       DISTILL_ONE_BATCH_STEPS)
        expect_counts(f"{label} one batch", read_counts(fa, ln))
        after = model.state_dict()
        teacher_kept = all(torch.equal(t, after[n]) for n, t in
                           before.items())
        epoch_losses = run["epoch_losses"]
        del run, model, train_step, optimizer, batch, after
        torch.cuda.empty_cache()
        peak -= resident_gb(torch)
        log(f"{label} one batch", batch=DISTILL_BATCH,
            reduced=f"batch 64 -> {DISTILL_BATCH}", dtype="fp32 (as JAX)",
            steps=DISTILL_ONE_BATCH_STEPS, losses=losses, step_ms=ms,
            images_per_s=DISTILL_BATCH / ms * 1e3, peak_memory_gb=peak,
            teacher_tensors=len(before),
            teacher_as_loaded_in_every_checkpoint=as_loaded,
            teacher_unchanged=teacher_kept, epoch_losses=epoch_losses,
            timed="host clock, each step read back, after the build",
            peak_memory="the step's, less what stays resident once its "
            "model, optimizer and batch are freed")
        if not (as_loaded and all(as_loaded) and teacher_kept
                and losses[-1] < losses[0]
                and all(map(math.isfinite, losses))):
            raise AssertionError(f"{label}: teacher as loaded {as_loaded}, "
                                 f"unchanged {teacher_kept}, losses {losses}")


class in_background:
    """``fn(*args)`` in a thread, started at once; ``join()`` waits for it,
    prints its wall seconds as a phase's and raises what it raised."""

    def __init__(self, label, fn, *args):
        import threading
        self.error = None

        def run():
            t0 = time.perf_counter()
            try:
                fn(*args)
            except BaseException as error:   # re-raised by join()
                self.error = error
            print(f"[phase {label} seconds] {time.perf_counter() - t0:.1f}",
                  flush=True)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error


def write_cifar(data_root):
    """A seeded CIFAR-100 in the pickle layout under ``data_root``."""
    import pickle

    import numpy as np
    rs = np.random.RandomState(0)
    cifar = data_root / "CIFAR100" / "cifar-100-python"
    cifar.mkdir(parents=True, exist_ok=True)
    for name, n in (("train", CIFAR_TRAIN_IMAGES), ("test", CIFAR_TEST_IMAGES)):
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (n, 3072)).astype(
                np.uint8), b"fine_labels": rs.randint(0, 100, n).tolist()}, f)


def no_kernel_slice(torch, fa, ln, eval_cli):
    """The untimed checks of phases 35, 38 and 39, which launch no
    hand-written kernel (their counts say so), run while the kernels build:
    data parallelism at world size 1, the DarkNet / VAN / ConvFormer
    configs that are not timed and the SAM / SAM2 encoder-distillation
    CLIs onto DINOv3 ViT-B/16, on the JPEG folder and the CIFAR-100 pickles
    of the ImageNet phases, written first. Returns the train steps and
    the trained distill models that ``no_kernel_timed_slice`` times."""
    import os

    from simpleaicv_pytorch_training_examples_tpu_torch import native
    experiments = REPO / PACKAGE / "experiments"
    data_root = SMOKE_DIR / "data"
    os.environ["SIMPLEAICV_DATA_ROOT"] = str(data_root)
    native.lib()
    jpeg_folder(data_root / "ILSVRC2012",
                {"train": RESNET_TRAIN_IMAGES, "val": RESNET_EVAL_IMAGES})
    write_cifar(data_root)
    phase_start("35")
    ddp_phase(torch, experiments)
    phase_start("38")
    held = backbone_configs_phase(torch, fa, ln, experiments, eval_cli)
    phase_start("39")
    return held, encoder_distill_phase(torch, fa, ln, experiments)


def no_kernel_timed_slice(torch, fa, ln, held, trained):
    """The timed steps of phases 38 and 39, once the kernels' build has
    ended, so that no compiler shares the host with them: the three timed
    configs' train steps, and the one-batch distill steps."""
    phase_start("38 timed")
    backbone_steps_phase(torch, fa, ln, held)
    phase_start("39 timed")
    encoder_distill_step_phase(torch, fa, ln, trained)


def dinov3_kernel_slice(torch, F, fa, ln, results):
    """Phases 36 and 37: K2 at DINOv3's shapes, DINOv3 ViT-B/16 and L/16."""
    phase_start("36")
    dinov3_attention_phase(torch, F, fa, results)
    phase_start("37")
    dinov3_phase(torch, fa, ln)


def build_and_read_kernels(build):
    """Phase 2: build every kernel from the sources in this checkout and
    read what was compiled: HGMMA (``wgmma``) in the SASS of every kernel
    that must have it, no ``mma.sync`` left, and, where this run compiled
    them, no spill and no serialized ``wgmma`` in ptxas's output. Raises
    on a failed check."""
    t0 = time.perf_counter()
    build_logs = build.build()
    built = {n: build.library_path(n).name for n in build.SOURCES}
    # ptxas's "Used N registers" line of each kernel (its notes on wgmma
    # also name registers)
    ptxas = [line.strip() for text in build_logs.values()
             for line in text.splitlines() if "Used " in line
             and "registers" in line]
    log("build", seconds=round(time.perf_counter() - t0, 2), libraries=built,
        kernels_compiled=len(ptxas),
        max_registers=max((int(l.split("Used ")[1].split()[0])
                           for l in ptxas), default="cached"))
    # K6's bf16 backward runs its products on wgmma: HGMMA in each of its
    # three walks' kernels, at every head dim
    hgmma = {name: n for name, n in hgmma_counts(
        build.library_path("flash_keybias_bwd")).items()
        if any(k in name for k in K6_BWD_KERNELS[:3])}
    log("sass flash_keybias_bwd", hgmma=hgmma)
    if len(hgmma) != 9 or not all(hgmma.values()):
        raise AssertionError(f"K6 backward kernels without HGMMA: {hgmma}")
    # K5's and K6's bf16 forward on wgmma: HGMMA in every walk kernel of
    # flash_attention_fwd.cu, and no bf16 (mma.sync) forward left in
    # flash_attention.cu's library
    hgmma = {name: n for name, n in hgmma_counts(
        build.library_path("flash_attention_fwd")).items()
        if any(k in name for k in FLASH_FWD_KERNELS)}
    log("sass flash_attention_fwd", hgmma=hgmma)
    walks = {k: sum(k in name for name in hgmma) for k in FLASH_FWD_KERNELS}
    if walks != FLASH_FWD_KERNELS or not all(hgmma.values()):
        raise AssertionError(f"K5/K6 forward kernels without HGMMA: {hgmma}")
    # ptxas -v of the new forward where this run compiled it: no kernel
    # spills, and none has its wgmma pipeline serialized (C7511, C7515,
    # C7519)
    fwd_log = build_logs.get("flash_attention_fwd")
    if fwd_log is not None:
        lines = fwd_log.splitlines()
        spills = [line.strip() for line in lines if "spill" in line and
                  " 0 bytes spill stores, 0 bytes spill loads" not in line]
        serialized = [line.strip() for line in lines
                      if re.search(r"C75(11|15|19)", line)]
        log("ptxas flash_attention_fwd", kernels=sum(
            "Compiling entry" in line for line in lines), spills=spills,
            serialized=serialized)
        if spills or serialized:
            raise AssertionError(f"flash_attention_fwd.cu: spills {spills}, "
                                 f"serialized wgmma {serialized}")
    # K5's bf16 backward on wgmma: HGMMA in both walks' kernels at every
    # shape; where this run compiled them, ptxas -v shows no spill and no
    # serialized wgmma pipeline; flash_attention.cu's library holds no bf16
    # kernel at all
    hgmma = {name: n for name, n in hgmma_counts(
        build.library_path("flash_relpos_bwd")).items()
        if any(k in name for k in K5_BWD_KERNELS)}
    log("sass flash_relpos_bwd", hgmma=hgmma)
    walks = {k: sum(k + "I" in name for name in hgmma)
             for k in K5_BWD_KERNELS}
    if (set(walks.values()) != {K5_BWD_SHAPES}
            or not all(hgmma.values())):
        raise AssertionError(f"K5 backward kernels without HGMMA: {hgmma}")
    bwd_log = build_logs.get("flash_relpos_bwd")
    if bwd_log is not None:
        lines = bwd_log.splitlines()
        registers = sorted({int(m.group(1)) for m in (
            re.search(r"Used (\d+) registers", line) for line in lines)
            if m})
        spills = [line.strip() for line in lines if "spill" in line and
                  " 0 bytes spill stores, 0 bytes spill loads" not in line]
        serialized = [line.strip() for line in lines
                      if re.search(r"C75(11|15|19)", line)]
        log("ptxas flash_relpos_bwd", kernels=sum(
            "Compiling entry" in line for line in lines),
            registers=registers, spills=spills, serialized=serialized)
        if spills or serialized:
            raise AssertionError(f"flash_relpos_bwd.cu: spills {spills}, "
                                 f"serialized wgmma {serialized}")
    old_bf16 = [name for name in hgmma_counts(
        build.library_path("flash_attention")) if "_bf16" in name]
    if old_bf16:
        raise AssertionError(f"mma.sync bf16 kernels left: {old_bf16}")
    # K1/K2/K9 on wgmma: HGMMA in both backward kernels and in the forward's
    # kNoBias mode at every chunk shape and head dim they instantiate; K2b,
    # K3 and K4 likewise in both backward kernels of the biased modes (the
    # last template value, MODE, 1 or 2); no bf16 backward of any mode
    # left in fused_attention.cu
    mode_of = lambda name: int(re.search(r"Li(\d)EEEv", name).group(1))
    short_bwd = {name: n for name, n in hgmma_counts(
        build.library_path("short_attention_bwd")).items()
        if "short_attention_bwd_d" in name}
    hgmma = {name: n for name, n in short_bwd.items() if mode_of(name) == 0}
    hgmma.update({name: n for name, n in hgmma_counts(
        build.library_path("short_attention_fwd")).items()
        if "short_attention_fwd" in name and name.endswith(NO_BIAS_FWD)})
    log("sass short_attention no bias", hgmma=hgmma)
    if len(hgmma) != SHORT_NO_BIAS_KERNELS or not all(hgmma.values()):
        raise AssertionError(f"K1/K2/K9 kernels without HGMMA: {hgmma}")
    hgmma = {name: n for name, n in short_bwd.items() if mode_of(name) != 0}
    log("sass short_attention_bwd biased", hgmma=hgmma)
    if len(hgmma) != SHORT_BIASED_BWD_KERNELS or not all(hgmma.values()):
        raise AssertionError(f"K2b/K3/K4 backward kernels without HGMMA: "
                             f"{hgmma}")
    old_bwd = [name for name in hgmma_counts(
        build.library_path("fused_attention")) if re.search(
            r"attention_bwd_(dq|dkv)_bf16", name)]
    if old_bwd:
        raise AssertionError(f"mma.sync bf16 backward left: {old_bwd}")
    # K8's GEMM on wgmma: HGMMA in every attn_block_gemm_bf16 template, no
    # HMMA (mma.sync) in any kernel of attn_block's library; where this run
    # compiled it, ptxas -v shows no spill and no serialized wgmma pipeline
    # in the GEMM (the line also counts those of the library's other
    # kernels: K1's device code and the fp32 attention, as in their own
    # libraries)
    library = build.library_path("attn_block")
    hgmma = {name: n for name, n in hgmma_counts(library).items()
             if "attn_block_gemm_bf16" in name}
    hmma = {name: n for name, n in hgmma_counts(library, "HMMA").items()
            if n}
    log("sass attn_block", hgmma=hgmma, hmma=hmma)
    if len(hgmma) != K8_GEMM_KERNELS or not all(hgmma.values()) or hmma:
        raise AssertionError(f"K8 GEMM kernels without HGMMA ({hgmma}) or "
                             f"mma.sync left in attn_block ({hmma})")
    k8_log = build_logs.get("attn_block")
    if k8_log is not None:
        gemm, others = ptxas_findings(k8_log, "attn_block_gemm_bf16")
        log("ptxas attn_block", gemm=gemm,
            included_attention_and_fp32_kernels=others)
        if gemm["spills"] or gemm["serialized"]:
            raise AssertionError(f"attn_block.cu's GEMM: spills "
                                 f"{gemm['spills']}, serialized wgmma "
                                 f"{gemm['serialized']}")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs an NVIDIA GPU")
    import torch.nn.functional as F

    from simpleaicv_pytorch_training_examples_tpu_torch.classification import losses
    from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
        SyntheticClassificationDataset)
    from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
        ClassificationCollater)
    from simpleaicv_pytorch_training_examples_tpu_torch.data import build_loader
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        init_model, make_classification_eval_step, make_train_step)
    from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.vit import ViT
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        build, fused_attention as fa, layer_norm as ln)
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        predict_interactive_segmentation as predict_cli,
        test_classification_model as eval_cli,
        train_classification_model as train_cli)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
        build_optimizer, load_config_from_work_dir)

    # plain fp32 references in full fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_start("1")
    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log("device", name=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    log.card = kind
    print(smi, flush=True)

    phase_start("2")
    # 2. build every kernel from the sources in this checkout and read their
    #    SASS, in the background, while the untimed checks of phases 35, 38
    #    and 39, which launch no hand-written kernel, run on the card
    kernels_built = in_background("2 build and sass", build_and_read_kernels,
                                  build)
    held, trained = no_kernel_slice(torch, fa, ln, eval_cli)
    phase_start("2 wait")
    kernels_built.join()
    no_kernel_timed_slice(torch, fa, ln, held, trained)

    phase_start("3")
    # 3. each kernel against its plain version at the main paths' shapes
    bf16, fp32 = torch.bfloat16, torch.float32
    results = {}
    k1_cases = (
        dict(label="vit_b16", shape=(BATCH, 197, 12, 64), dtype=bf16, seed=1),
        dict(label="head_dim_128", shape=(BATCH, 197, 6, 128), dtype=bf16,
             seed=2),
        dict(label="n_real_150", shape=(BATCH, 197, 12, 64), dtype=bf16,
             seed=3, n_real=150),
        dict(label="fp32", shape=(8, 197, 12, 64), dtype=fp32, seed=4),
        # K/V too large to stay in shared memory: walked in chunks
        dict(label="streamed_n1024", shape=(8, 1024, 2, 128), dtype=bf16,
             seed=8))
    k2_cases = (
        dict(label="vit_h14", shape=(BATCH, 16, 257, 80), dtype=bf16, seed=5,
             packed=True),
        dict(label="n_real_200", shape=(BATCH, 16, 257, 80), dtype=bf16,
             seed=6, n_real=200),
        dict(label="fp32", shape=(8, 16, 257, 80), dtype=fp32, seed=7),
        # odd head dim: element-wise loads and stores
        dict(label="head_dim_35", shape=(8, 4, 50, 35), dtype=bf16, seed=9))
    for name, cases in (("K1", k1_cases), ("K2", k2_cases)):
        for case in cases:
            check_kernel(torch, F, fa, name, case, results)
        for case in cases:
            check_backward_kernel(torch, F, fa, name, case, results)
    phase_start("3a-3b")
    # 3a-3b. K9 and K2b against their plain versions, then their entry
    #        points driven and counted
    entry_counts = qkv_and_bias_slice(torch, F, fa, ln, results)

    for case in (
            dict(label="vit_b16", shape=(BATCH * 197, 768), dtype=bf16,
                 seed=10),
            dict(label="vit_h14", shape=(BATCH * 257, 1280), dtype=bf16,
                 seed=11),
            # C a multiple of 4 and not of 8: fp32 vectors
            dict(label="fp32_c100", shape=(1000, 100), dtype=fp32, seed=12),
            # odd C: the element-wise kernels
            dict(label="fp32_c77", shape=(777, 77), dtype=fp32, seed=13),
            dict(label="bf16_c100", shape=(777, 100), dtype=bf16, seed=14)):
        check_layer_norm(torch, F, ln, case, results)
    # K3/K4/K5: (B, H, KH, KW, D); SAM-B windows: 25 a 1024^2 image
    rel_cases = {
        "K3": (dict(label="sam_b", shape=(25 * SAM_BATCH, 12, 14, 14, 64),
                    dtype=bf16, seed=20),
               dict(label="head_dim_128", shape=(50, 8, 14, 14, 128),
                    dtype=bf16, seed=21),
               dict(label="kh12_kw16", shape=(16, 12, 12, 16, 64),
                    dtype=bf16, seed=22),
               dict(label="fp32", shape=(8, 12, 14, 14, 64), dtype=fp32,
                    seed=23)),
        "K4": (dict(label="sam_h", shape=(25 * SAM_BATCH, 16, 14, 14, 80),
                    dtype=bf16, seed=24, packed=True),
               dict(label="n_real_150", shape=(50, 16, 14, 14, 80),
                    dtype=bf16, seed=25, packed=True, n_real=150),
               dict(label="kh8_kw20", shape=(16, 4, 8, 20, 80), dtype=bf16,
                    seed=26),
               dict(label="head_dim_35", shape=(8, 4, 7, 9, 35), dtype=bf16,
                    seed=27),
               dict(label="fp32", shape=(8, 16, 14, 14, 80), dtype=fp32,
                    seed=28, packed=True)),
        "K5": (dict(label="sam_b", shape=(SAM_BATCH, 12, 64, 64, 64),
                    dtype=bf16, seed=30, packed=True),
               dict(label="sam_h_d80", shape=(2, 16, 64, 64, 80),
                    dtype=bf16, seed=31, packed=True),
               dict(label="head_dim_160", shape=(1, 2, 32, 32, 160),
                    dtype=bf16, seed=32),
               dict(label="n1050_kh30_kw35", shape=(1, 4, 30, 35, 64),
                    dtype=bf16, seed=33),
               dict(label="kh48_kw80", shape=(2, 4, 48, 80, 64), dtype=bf16,
                    seed=34),
               dict(label="fp32", shape=(1, 2, 32, 32, 64), dtype=fp32,
                    seed=35)),
    }
    for name, cases in rel_cases.items():
        for case in cases:
            check_rel_kernel(torch, F, name, case, results)
    for name, cases in rel_cases.items():
        for case in cases:
            check_rel_backward_kernel(torch, F, name, case, results)
    # SAM2-B+ at 1024^2: Hiera's windows (K1 with the 56-wide scale on
    # heads padded to 64; K2 at d = 56 without the padding) and K6 at the
    # memory attention's and the global blocks' shapes; the memory bias of
    # frame 7 (every slot valid, 8 of 16 pointers) and of frame 1 (6 of 7
    # slots and 15 of 16 pointers masked)
    hiera = 56 ** -0.5
    windows = (("hiera_stage1", 1024, 64, 2), ("hiera_stage2", 1024, 16, 4),
               ("hiera_stage3", 25, 196, 8), ("hiera_stage4", 25, 49, 16))
    for i, (label, b, n, h) in enumerate(windows):
        check_kernel(torch, F, fa, "K1", dict(
            label=label, shape=(b, n, h, 64), dtype=bf16, seed=40 + i,
            sm_scale=hiera), results)
        check_kernel(torch, F, fa, "K2", dict(
            label=f"{label}_d56", shape=(b, h, n, 56), dtype=bf16,
            seed=44 + i, packed=True), results)
    memory_bias = lambda slots, pointers: slot_bias(torch, 1, 7, 4096, slots,
                                                    16, 4, pointers)
    cross, self_shape = (1, 1, 4096, 7 * 4096 + 64, 256), (1, 1, 4096, 4096,
                                                           256)
    for case in (
            dict(label="sam2_memory_cross_frame7", shape=cross, dtype=bf16,
                 seed=50, layout="memory", bias=memory_bias(7, 8)),
            dict(label="sam2_memory_cross_frame1", shape=cross, dtype=bf16,
                 seed=51, layout="memory", bias=memory_bias(1, 1)),
            dict(label="sam2_memory_self", shape=self_shape, dtype=bf16,
                 seed=52, layout="memory"),
            dict(label="hiera_global", shape=(1, 8, 4096, 4096, 64),
                 dtype=bf16, seed=53, layout="packed", sm_scale=hiera),
            dict(label="hiera_global_d56", shape=(1, 8, 4096, 4096, 56),
                 dtype=bf16, seed=54, layout="packed"),
            dict(label="fp32_memory_cross_frame1", shape=cross, dtype=fp32,
                 seed=55, layout="memory", bias=memory_bias(1, 1)),
            dict(label="fp32_memory_self", shape=self_shape, dtype=fp32,
                 seed=56, layout="memory"),
            dict(label="fp32_hiera_global", shape=(1, 8, 4096, 4096, 64),
                 dtype=fp32, seed=57, layout="packed", sm_scale=hiera)):
        check_key_bias_kernel(torch, F, case, results)
    # K6's backward at the SAM2 train step's shapes: the memory attention
    # (frame 7's bias, and those of the 4-frame recipe's tracked frames
    # 1-3: t valid slots and t pointers) and the Hiera global blocks of a
    # 4-frame clip
    hiera4 = (SAM2_STEP_FRAMES, 8, 4096, 4096)
    for case in (
            dict(label="sam2_memory_cross_frame7", shape=cross, dtype=bf16,
                 seed=60, layout="memory", bias=memory_bias(7, 8)),
            *(dict(label=f"sam2_memory_cross_frame{t}", shape=cross,
                   dtype=bf16, seed=64 + t, layout="memory",
                   bias=memory_bias(t, t)) for t in (1, 2, 3)),
            dict(label="sam2_memory_self", shape=self_shape, dtype=bf16,
                 seed=61, layout="memory"),
            dict(label="hiera_global", shape=(*hiera4, 64), dtype=bf16,
                 seed=62, layout="packed", sm_scale=hiera),
            dict(label="hiera_global_d56", shape=(*hiera4, 56), dtype=bf16,
                 seed=63, layout="packed"),
            dict(label="fp32_memory_self", shape=self_shape, dtype=fp32,
                 seed=64, layout="memory")):
        check_key_bias_backward_kernel(torch, F, case, results)

    phase_start("4")
    # 4. eval slice: ViT-B/16 through the work-dir eval CLI
    work_dir = SMOKE_DIR / "vit_base_patch16"
    work_dir.mkdir(parents=True, exist_ok=True)
    (work_dir / "test_config.py").write_text(VIT_B_CONFIG.format(
        n=VIT_B_BATCHES * BATCH, batch=BATCH))
    reset_counts(fa, ln)
    summary = eval_cli.main(["--work-dir", str(work_dir)])
    eval_counts = read_counts(fa, ln)
    log("vit_b16 eval cli", images=summary["images"],
        images_per_s=summary["images_per_s"], top1=summary["top1"],
        launches=eval_counts)
    expect_counts("ViT-B/16 eval", eval_counts, K1=12 * VIT_B_BATCHES)

    config = load_config_from_work_dir(str(work_dir), "test_config")
    model = init_model(config.model, config.seed)
    loader = build_loader(config.test_dataset, BATCH, config.test_collater,
                          "cuda")
    fit_head(torch, model, loader)
    compare_paths(torch, model, loader, "vit_b16 logits")
    batch = {k: v.cuda() for k, v in next(iter(loader)).items()}
    eval_step = make_classification_eval_step(model)
    step_ms = time_ms(torch, lambda: eval_step(batch), iters=10,
                      device_only=False)
    set_fused_attention(model, False)
    plain_step_ms = time_ms(torch, lambda: eval_step(batch), iters=10,
                      device_only=False)
    set_fused_attention(model, True)
    log("vit_b16 eval step", batch=BATCH, ms=step_ms,
        images_per_s=BATCH / step_ms * 1e3, plain_attention_ms=plain_step_ms,
        k1_share=12 * results["K1"][0]["ms"] / step_ms)

    phase_start("5")
    # 5. use_fused_norm: the same model's blocks through K7
    set_fused(model, norm=True)
    reset_counts(fa, ln)
    fused_norm_logits = logits_of(torch, eval_step, loader)
    norm_counts = read_counts(fa, ln)
    set_fused(model, norm=False)
    plain_norm_logits = logits_of(torch, eval_step, loader)
    diff = (fused_norm_logits - plain_norm_logits).abs().max().item()
    agree = (fused_norm_logits.argmax(-1)
             == plain_norm_logits.argmax(-1)).float().mean().item()
    set_fused(model, norm=True)
    norm_step_ms = time_ms(torch, lambda: eval_step(batch), iters=10,
                      device_only=False)
    set_fused(model, norm=False)
    log("vit_b16 eval use_fused_norm", max_abs_logit_diff=diff,
        logit_std=plain_norm_logits.std().item(), top1_agreement=agree,
        launches=norm_counts, ms=norm_step_ms, plain_norm_ms=step_ms,
        images_per_s=BATCH / norm_step_ms * 1e3)
    expect_counts("ViT-B/16 eval with K7", norm_counts,
                  K1=12 * VIT_B_BATCHES, K7=24 * VIT_B_BATCHES)
    if not (diff <= 0.02 * max(1.0, plain_norm_logits.std().item())
            and agree >= 0.99):
        raise AssertionError(f"use_fused_norm logits disagree with the plain "
                             f"LayerNorm (max diff {diff}, top-1 {agree})")
    del model, config, eval_step

    phase_start("6")
    # 6. ViT-H/14 eval at full width, reduced depth, through the engine
    vit_h = ViT(14, 1280, VIT_H_DEPTH, 16, 4, image_size=224,
                global_pool=True, num_classes=1000, dtype=bf16,
                use_fused_attention=True)
    vit_h = init_model(vit_h, 0)
    loader_h = build_loader(
        SyntheticClassificationDataset(n=BATCH, image_size=224,
                                       num_classes=1000, seed=1),
        BATCH, ClassificationCollater(), "cuda")
    reset_counts(fa, ln)
    eval_step = make_classification_eval_step(vit_h)
    for batch_h in loader_h:
        _, _, logits = eval_step(batch_h)
    torch.cuda.synchronize()
    eval_counts_h = read_counts(fa, ln)
    log("vit_h14 eval", reduced=f"depth {VIT_H_DEPTH} of 32 blocks",
        batch=BATCH, launches=eval_counts_h, logits=list(logits.shape))
    expect_counts("ViT-H/14 eval", eval_counts_h, K2=VIT_H_DEPTH)
    fit_head(torch, vit_h, loader_h)
    compare_paths(torch, vit_h, loader_h, "vit_h14 logits")

    phase_start("7")
    # 7. ViT-H/14 training, same width and depth, through the engine
    vit_h = init_model(ViT(14, 1280, VIT_H_DEPTH, 16, 4, image_size=224,
                           drop_path_prob=0.1, global_pool=True,
                           num_classes=1000, dtype=bf16,
                           use_fused_attention=True), 0)
    optimizer, _ = build_optimizer(OneBatchConfig, vit_h, 2)
    train_step = make_train_step(vit_h, losses.CELoss(), optimizer,
                                 accumulation_steps=MICRO_BATCHES)
    reset_counts(fa, ln)
    metrics_h = [train_step(batch_h, i) for i in range(2)]
    torch.cuda.synchronize()
    train_counts_h = read_counts(fa, ln)
    losses_h = [m["loss"].item() for m in metrics_h]
    skipped_h = sum(m["skipped"].item() for m in metrics_h)
    log("vit_h14 train", reduced=f"depth {VIT_H_DEPTH} of 32 blocks",
        batch=BATCH, micro_batches=MICRO_BATCHES, steps=2, losses=losses_h,
        skipped=skipped_h, launches=train_counts_h)
    expect_counts("ViT-H/14 train", train_counts_h,
                  K2=VIT_H_DEPTH * MICRO_BATCHES * 2,
                  K2_bwd=VIT_H_DEPTH * MICRO_BATCHES * 2)
    if skipped_h or not all(map(math.isfinite, losses_h)):
        raise AssertionError(f"ViT-H/14 train: losses {losses_h}, skipped "
                             f"{skipped_h}")
    del vit_h, optimizer, train_step, eval_step

    phase_start("8")
    # 8. the training slice: ViT-B/16 through the work-dir train CLI, two
    #    epochs, then the same command resumed for a third
    train_dir = SMOKE_DIR / "vit_base_patch16_train"
    iters = TRAIN_IMAGES // BATCH
    eval_batches = -(-EVAL_IMAGES // BATCH)
    train_counts, _ = run_vit_train_cli(
        fa, ln, train_cli, train_dir, "", "vit_b16 train cli",
        lambda n_epochs: dict(
            K1=12 * n_epochs * (iters * MICRO_BATCHES + eval_batches),
            K1_bwd=12 * n_epochs * iters * MICRO_BATCHES))
    train_log = (train_dir / "log" / "train.log").read_text()
    iter_losses = [float(x) for x in re.findall(r" loss ([-\w.]+) avg ",
                                                train_log)]
    if (len(iter_losses) != 3 * iters
            or not all(map(math.isfinite, iter_losses))
            or "resumed from epoch 2" not in train_log):
        raise AssertionError(f"train log: losses {iter_losses}")
    checkpoints = train_dir / "checkpoints"
    if not ((checkpoints / "latest.pth").is_file()
            and (checkpoints / "best.pth").is_file()):
        raise AssertionError("the train CLI left no latest.pth / best.pth")
    (train_dir / "test_config.py").write_text(
        VIT_B_CONFIG.format(n=EVAL_IMAGES, batch=BATCH).replace(
            "    test_dataset =",
            "    from simpleaicv_pytorch_training_examples_tpu_torch."
            "classification.common import load_state_dict\n"
            f"    load_state_dict({str(checkpoints / 'best.pth')!r}, model)\n"
            "    test_dataset ="))
    best = eval_cli.main(["--work-dir", str(train_dir)])
    eval_log = (train_dir / "log" / "test.log").read_text()
    log("vit_b16 best.pth eval cli", images=best["images"], top1=best["top1"],
        top5=best["top5"], iteration_losses=iter_losses)
    if "pretrained load: 152/152 tensors" not in eval_log:
        raise AssertionError("best.pth did not load through the eval CLI")

    phase_start("9")
    # 9. gradients and a 20-step one-batch run, kernels against plain ops
    config = load_config_from_work_dir(str(train_dir), "train_config")
    model = init_model(config.model, config.seed)
    set_fused(model, norm=True)
    for block in model.blocks:
        block.drop_path.drop_path_prob = 0.0
    with torch.no_grad():  # the seeded init's 2e-5 head hides the backbone
        model.fc.weight.normal_(0.0, 0.02, generator=torch.Generator(
            device="cuda").manual_seed(5))
    batch64 = {k: v[:BATCH // MICRO_BATCHES] for k, v in batch.items()}
    criterion = losses.CELoss()

    check_vit_gradients(
        torch, fa, ln, model, batch64, criterion,
        "vit_b16 gradients vs plain attention and LayerNorm",
        lambda on: set_fused(model, attention=on, norm=on),
        dict(K1=12, K1_bwd=12, K7=24, K7_bwd=24))
    optimizer, _ = build_optimizer(OneBatchConfig, model, 20)
    train_step = make_train_step(model, criterion, optimizer)
    overfit = [train_step(batch64, i)["loss"].item() for i in range(20)]
    log("vit_b16 one-batch run with the kernels", steps=20, lr=1e-3,
        first_loss=overfit[0], last_loss=overfit[-1], losses=overfit)
    if not (all(map(math.isfinite, overfit))
            and overfit[-1] < 0.7 * overfit[0]):
        raise AssertionError(f"one-batch loss did not fall: {overfit}")
    del model, optimizer, train_step

    phase_start("10")
    # 10. timed train steps: as the config runs them (4 x 64) and unsplit,
    #     with plain LayerNorm and with K7
    timed = {}
    for fused_norm in (False, True):
        for micro in (MICRO_BATCHES, 1):
            config = load_config_from_work_dir(str(train_dir), "train_config")
            model = init_model(config.model, config.seed)
            set_fused(model, norm=fused_norm)
            optimizer, _ = build_optimizer(config, model, 5004)
            train_step = make_train_step(model, losses.OneHotLabelCELoss(),
                                         optimizer, accumulation_steps=micro)
            soft = {"image": batch["image"],
                    "label": F.one_hot(batch["label"], 1000).float()}
            reset_counts(fa, ln)
            first = train_step(soft, 0)
            torch.cuda.synchronize()
            step_counts = read_counts(fa, ln)
            k7 = 24 * micro if fused_norm else 0
            expect_counts(f"ViT-B/16 train step {micro} micro-batches",
                          step_counts, K1=12 * micro, K1_bwd=12 * micro,
                          K7=k7, K7_bwd=k7)
            if first["skipped"].item() or not math.isfinite(
                    first["loss"].item()):
                raise AssertionError(f"train step skipped: {first}")
            if fused_norm and micro == MICRO_BATCHES:
                norm_train_counts = step_counts
            torch.cuda.reset_peak_memory_stats()
            step = iter(range(1, 10 ** 6))
            ms = time_ms(torch, lambda: train_step(soft, next(step)), iters=5,
                         warmup=2, device_only=False)
            flops = BATCH * train_flops_per_image(model, 224)
            key = f"{micro}x{BATCH // micro}" + ("_k7" if fused_norm else "")
            timed[key] = ms
            log(f"vit_b16 train step {key}", batch=BATCH, micro_batches=micro,
                use_fused_norm=fused_norm, launches_per_step=step_counts, ms=ms,
                images_per_s=BATCH / ms * 1e3, tflops=flops / ms / 1e9,
                share_of_bf16_peak=flops / ms / 1e9 / 989.0,
                counted="3x the forward's GEMM and attention products",
                peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
            del model, optimizer, train_step

    phase_start("10a")
    # 10a. K8, the fused attention block, against its plain version,
    #      forward and backward, bf16 and fp32: ViT-B/16's train micro-batch
    #      (the first case: the kernels line's) and eval batch, heads of 128,
    #      a ragged N and the largest N
    k8_shapes = (("vit_b16_train", (BATCH // MICRO_BATCHES, 197, 12, 64)),
                 ("vit_b16_eval", (BATCH, 197, 12, 64)),
                 ("head_dim_128", (BATCH // MICRO_BATCHES, 197, 6, 128)),
                 ("n50", (BATCH // MICRO_BATCHES, 50, 12, 64)),
                 ("n1024", (4, 1024, 12, 64)))
    check_attn_block_gemms(torch, results)
    for dtype, prefix in ((bf16, ""), (fp32, "fp32_")):
        for i, (label, shape) in enumerate(k8_shapes):
            check_attn_block(torch, F, fa, ln, dict(
                label=prefix + label, shape=shape, dtype=dtype,
                seed=70 + i), results)
    torch.cuda.empty_cache()

    phase_start("10b")
    # 10b. use_fused_block: ViT-B/16 through the work-dir eval CLI, every
    #      block through K8; logits against the plain ops; timed eval steps
    #      with and without the flag
    block_dir = SMOKE_DIR / "vit_base_patch16_fused_block"
    block_dir.mkdir(parents=True, exist_ok=True)
    (block_dir / "test_config.py").write_text(VIT_B_CONFIG.format(
        n=VIT_B_BATCHES * BATCH, batch=BATCH).replace(
            "use_fused_attention=True)",
            "use_fused_attention=True, use_fused_block=True)"))
    reset_counts(fa, ln)
    summary = eval_cli.main(["--work-dir", str(block_dir)])
    block_eval_counts = read_counts(fa, ln)
    log("vit_b16 eval cli use_fused_block", images=summary["images"],
        images_per_s=summary["images_per_s"], top1=summary["top1"],
        launches=block_eval_counts)
    expect_counts("ViT-B/16 eval with K8", block_eval_counts,
                  K8=12 * VIT_B_BATCHES)
    config = load_config_from_work_dir(str(block_dir), "test_config")
    model = init_model(config.model, config.seed)
    loader = build_loader(config.test_dataset, BATCH, config.test_collater,
                          "cuda")
    fit_head(torch, model, loader)
    compare_paths(torch, model, loader, "vit_b16 use_fused_block logits",
                  switch=set_fused_block)
    eval_step = make_classification_eval_step(model)
    block_ms = time_ms(torch, lambda: eval_step(batch), iters=10,
                       device_only=False)
    set_fused(model, block=False)
    unfused_ms = time_ms(torch, lambda: eval_step(batch), iters=10,
                         device_only=False)
    set_fused(model, block=True)
    log("vit_b16 eval step use_fused_block", batch=BATCH, ms=block_ms,
        images_per_s=BATCH / block_ms * 1e3, without_flag_ms=unfused_ms,
        without_flag_images_per_s=BATCH / unfused_ms * 1e3,
        k8_share=12 * results["K8"][1]["ms"] / block_ms)
    del model, config, eval_step

    phase_start("10c")
    # 10c. the training slice with use_fused_block: ViT-B/16 through the
    #      work-dir train CLI with the port's train config and the flag, two
    #      epochs, then resumed for a third. At drop-path 0.1 only block 0
    #      (whose own probability is 0) takes K8 in training, the others K1;
    #      every block takes K8 in the epochs' eval
    block_train_dir = SMOKE_DIR / "vit_base_patch16_fused_block_train"
    block_train_counts, block_epochs = run_vit_train_cli(
        fa, ln, train_cli, block_train_dir, ", use_fused_block=True",
        "vit_b16 use_fused_block train cli",
        lambda n_epochs: dict(
            K1=11 * n_epochs * iters * MICRO_BATCHES,
            K1_bwd=11 * n_epochs * iters * MICRO_BATCHES,
            K8=n_epochs * (iters * MICRO_BATCHES + 12 * eval_batches),
            K8_bwd=n_epochs * iters * MICRO_BATCHES))
    epoch_losses = [e["loss_avg"] for e in block_epochs]
    log("vit_b16 use_fused_block train cli losses", epoch_losses=epoch_losses)
    if not epoch_losses[-1] < epoch_losses[0]:
        raise AssertionError(f"use_fused_block train CLI: the loss did not "
                             f"fall over the epochs: {epoch_losses}")

    phase_start("10d")
    # 10d. gradients at drop-path 0 (all 12 blocks through K8, norm2
    #      through K7) against the plain ops; then with
    #      use_gradient_checkpoint (K8 twice a block) against the unchecked
    #      kernels' gradients
    config = load_config_from_work_dir(str(block_train_dir), "train_config")
    model = init_model(config.model, config.seed)
    set_fused(model, norm=True)
    for blk in model.blocks:
        blk.drop_path.drop_path_prob = 0.0
    with torch.no_grad():  # the seeded init's 2e-5 head hides the backbone
        model.fc.weight.normal_(0.0, 0.02, generator=torch.Generator(
            device="cuda").manual_seed(5))
    unchecked = check_vit_gradients(
        torch, fa, ln, model, batch64, criterion,
        "vit_b16 use_fused_block gradients vs plain ops",
        lambda on: set_fused(model, attention=on, norm=on, block=on),
        dict(K8=12, K8_bwd=12, K7=12, K7_bwd=12))
    model.use_gradient_checkpoint = True
    check_vit_gradients(
        torch, fa, ln, model, batch64, criterion,
        "vit_b16 use_fused_block use_gradient_checkpoint vs unchecked", None,
        dict(K8=24, K8_bwd=12, K7=24, K7_bwd=12), reference=unchecked)
    del model, config, unchecked

    phase_start("10e")
    # 10e. timed train steps at drop-path 0, 4 x 64 and 1 x 256, with and
    #      without use_fused_block: ms, images/s, share of the peak, peak
    #      memory
    soft = {"image": batch["image"],
            "label": F.one_hot(batch["label"], 1000).float()}
    for fused_block in (False, True):
        for micro in (MICRO_BATCHES, 1):
            config = load_config_from_work_dir(str(block_train_dir),
                                               "train_config")
            model = init_model(config.model, config.seed)
            for blk in model.blocks:
                blk.drop_path.drop_path_prob = 0.0
            set_fused(model, block=fused_block)
            optimizer, _ = build_optimizer(config, model, 5004)
            train_step = make_train_step(model, losses.OneHotLabelCELoss(),
                                         optimizer, accumulation_steps=micro)
            reset_counts(fa, ln)
            first = train_step(soft, 0)
            torch.cuda.synchronize()
            step_counts = read_counts(fa, ln)
            kernel = "K8" if fused_block else "K1"
            expect_counts(f"ViT-B/16 drop-path 0 train step {micro} "
                          f"micro-batches", step_counts,
                          **{kernel: 12 * micro, kernel + "_bwd": 12 * micro})
            if first["skipped"].item() or not math.isfinite(
                    first["loss"].item()):
                raise AssertionError(f"train step skipped: {first}")
            torch.cuda.reset_peak_memory_stats()
            step = iter(range(1, 10 ** 6))
            ms = time_ms(torch, lambda: train_step(soft, next(step)), iters=5,
                         warmup=2, device_only=False)
            flops = BATCH * train_flops_per_image(model, 224)
            key = (f"{micro}x{BATCH // micro}_drop_path_0"
                   + ("_fused_block" if fused_block else ""))
            log(f"vit_b16 train step {key}", batch=BATCH, micro_batches=micro,
                use_fused_block=fused_block, launches_per_step=step_counts,
                ms=ms, images_per_s=BATCH / ms * 1e3,
                tflops=flops / ms / 1e9,
                share_of_bf16_peak=flops / ms / 1e9 / 989.0,
                counted="3x the forward's GEMM and attention products",
                peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
            del model, optimizer, train_step
    torch.cuda.empty_cache()

    # 10f-10l. ImageNet classification from JPEG files and the ResNets
    #          (phases a-g: native jpeg, the loader, the ResNet-50 train
    #          and eval CLIs, ViT-B/16 eval over JPEG files, the timed
    #          ResNet-50 step and its NaN step, ResNet-18 CIFAR, ResNet-50
    #          ImageNet-21K)
    imagenet_slice(torch, fa, ln, eval_cli, train_cli)
    torch.cuda.empty_cache()

    phase_start("11")
    # 11. SAM-B through the prediction tool: full width and depth, 1024^2,
    #     bf16, encode once, decode a point, a box and both
    reset_counts(fa, ln)
    run = predict_cli.main(["--network", "sam_b", "--synthetic",
                            "--batch-size", str(SAM_BATCH)])
    torch.cuda.synchronize()
    sam_counts = read_counts(fa, ln)
    encoder_runs = run["encoder_runs"]
    emb = run["embedding"]
    log("sam_b predict tool", batch=SAM_BATCH, encoder_runs=encoder_runs,
        decoder_runs=run["decoder_runs"], launches=sam_counts,
        embedding=list(emb.shape), finite=bool(torch.isfinite(emb).all()),
        iou_image0={line["prompt"]: line["iou_predictions"][0]
                    for line in run["lines"]})
    expect_counts("SAM-B predict tool", sam_counts, K3=8 * encoder_runs,
                  K5=4 * encoder_runs)
    if not (emb.shape == (SAM_BATCH, 256, 64, 64)
            and torch.isfinite(emb).all()
            and all(torch.isfinite(m).all() and torch.isfinite(i).all()
                    and m.shape == (SAM_BATCH, 4, 1024, 1024)
                    for m, i in run["outputs"].values())):
        raise AssertionError("SAM-B: non-finite or misshapen outputs")

    phase_start("12")
    # 12. the same model and inputs with plain attention
    sam, images, sets = run["model"], run["images"], run["prompts"]
    sam_compare(torch, sam, images, sets, "sam_b")

    phase_start("13")
    # 13. timed: the encoder and each prompt set's decoder, bf16, batch 8
    from simpleaicv_pytorch_training_examples_tpu_torch.tools.predict_interactive_segmentation import (
        compute_context)
    with compute_context(images.device):
        torch.cuda.reset_peak_memory_stats()
        encoder_ms = time_ms(torch, lambda: sam.forward_image_encoder(images),
                             iters=5, warmup=1, device_only=False)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        decoder_ms = {name: time_ms(
            torch, lambda: sam.forward_prompt_encoder_mask_decoder(emb, p),
            iters=10, warmup=2, device_only=False)
            for name, p in sets.items()}
        sam.set_flash_attention(False)
        plain_encoder_ms = time_ms(torch,
                                   lambda: sam.forward_image_encoder(images),
                                   iters=2, warmup=1, device_only=False)
        sam.set_flash_attention(True)
    flops = SAM_BATCH * sam_encoder_flops(sam)
    log("sam_b encoder", batch=SAM_BATCH, ms=encoder_ms,
        images_per_s=SAM_BATCH / encoder_ms * 1e3,
        tflops=flops / encoder_ms / 1e9,
        share_of_bf16_peak=flops / encoder_ms / 1e9 / 989.0,
        counted="GEMMs, attention and rel-pos products, convolutions",
        gflop_per_image=flops / SAM_BATCH / 1e9,
        plain_attention_ms=plain_encoder_ms, peak_memory_gb=peak_gb,
        k3_share=8 * results["K3"][0]["ms"] / encoder_ms,
        k5_share=4 * results["K5"][0]["ms"] / encoder_ms)
    log("sam_b decoder", batch=SAM_BATCH, ms_per_prompt_set=decoder_ms)

    phase_start("14")
    # 14. the same model with sharp attention (scores and rel terms of unit
    #     std), two images: kernels against plain attention, the masks and
    #     IoU predictions held against the fp32 floor as well; a control
    #     shows that the check would fail without the rel bias
    sharp_images = images[:SAM_SHARP_BATCH]
    log("sam_b attention, seeded init",
        fp32_rms_diff_without_rel_bias=rms_without_rel_bias(
            torch, sam, sharp_images),
        **attention_logit_stats(torch, sam, images[:1]))
    sharpen_attention_(torch, sam, SAM_SHARP_SEED)
    sharp = attention_logit_stats(torch, sam, images[:1])
    log("sam_b attention, sharpened", **sharp)
    if min(v["logit_std"] for v in sharp.values()) < SAM_SHARP_MIN_STD:
        raise AssertionError(f"SAM-B attention not sharpened: {sharp}")
    fields = sam_compare(torch, sam, sharp_images,
                         first_of(sets, SAM_SHARP_BATCH),
                         "sam_b sharp attention", floor_masks=True)
    without = rms_without_rel_bias(torch, sam, sharp_images)
    bound = SAM_FLOOR_RATIO * fields["fp32_rms_diff_plain"]
    log("sam_b sharp attention, rel bias dropped",
        fp32_rms_diff_without_rel_bias=without, check_bound=bound)
    if not without > bound:
        raise AssertionError("SAM-B sharp attention: the embedding check "
                             f"cannot see a missing rel bias ({without} <= "
                             f"{bound})")
    del run, sam, images, sets, emb

    phase_start("15")
    # 15. SAM-H at full width (C = 1280, 16 heads of 80), reduced depth:
    #     windowed blocks through K4, the global block through K5
    reset_counts(fa, ln)
    run_h = predict_cli.main(
        ["--network", "sam_h", "--synthetic", "--batch-size",
         str(SAM_BATCH)],
        model_kw=dict(image_encoder_block_nums=SAM_H_DEPTH,
                      image_encoder_global_attn_indexes=SAM_H_GLOBAL))
    torch.cuda.synchronize()
    sam_h_counts = read_counts(fa, ln)
    runs_h = run_h["encoder_runs"]
    log("sam_h predict tool", reduced=f"depth {SAM_H_DEPTH} of 32 blocks, "
        f"global {SAM_H_GLOBAL}", batch=SAM_BATCH, encoder_runs=runs_h,
        launches=sam_h_counts,
        finite=bool(torch.isfinite(run_h["embedding"]).all()))
    n_global = len(SAM_H_GLOBAL)
    expect_counts("SAM-H predict tool", sam_h_counts,
                  K4=(SAM_H_DEPTH - n_global) * runs_h, K5=n_global * runs_h)
    sam_compare(torch, run_h["model"], run_h["images"][:2],
                first_of(run_h["prompts"], 2), "sam_h")
    del run_h

    phase_start("16")
    # 16. the SAM training slice: SAM-B at full width and depth through the
    #     work-dir train CLI with the port's config (checkpointing, 4 extra
    #     decoder passes, bf16), one epoch, then the same command resumed
    #     for a second
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        profile_interactive_segmentation_train as sam_train_profile,
        train_interactive_segmentation_model as sam_train_cli)
    sam_dir = SMOKE_DIR / "sam_b_train"
    shutil.rmtree(sam_dir, ignore_errors=True)
    sam_dir.mkdir(parents=True)
    sam_iters = SAM_TRAIN_IMAGES // SAM_BATCH
    sam_train_counts = {}
    for epochs, first_epoch in ((1, 1), (2, 2)):
        (sam_dir / "train_config.py").write_text(SAM_B_TRAIN_CONFIG.format(
            n_train=SAM_TRAIN_IMAGES, batch=SAM_BATCH, epochs=epochs))
        reset_counts(fa, ln)
        t0 = time.perf_counter()
        run = sam_train_cli.main(["--work-dir", str(sam_dir)])
        seconds = time.perf_counter() - t0
        counts = read_counts(fa, ln)
        steps = (epochs - first_epoch + 1) * sam_iters
        log(f"sam_b train cli epochs {first_epoch}-{epochs}",
            resumed_from=run["resumed_from"], batch=SAM_BATCH,
            epochs=run["epochs"], seconds=round(seconds, 2), launches=counts,
            launches_per_step={k: v / steps for k, v in counts.items() if v})
        expect_counts(f"SAM-B train CLI to epoch {epochs}", counts,
                      K3=16 * steps, K3_bwd=8 * steps, K5=8 * steps,
                      K5_bwd=4 * steps)
        ran = [e["epoch"] for e in run["epochs"]]
        if (ran != list(range(first_epoch, epochs + 1))
                or run["resumed_from"] != (first_epoch - 1 or None)
                or any(e["skipped"] or not math.isfinite(e["loss_avg"])
                       for e in run["epochs"])):
            raise AssertionError(f"SAM-B train CLI to epoch {epochs}: {run}")
        if not sam_train_counts:
            sam_train_counts = counts
        del run
    sam_log = (sam_dir / "log" / "train.log").read_text()
    sam_losses = [float(x) for x in re.findall(r" loss ([-\w.]+) avg ",
                                               sam_log)]
    epoch_avgs = [float(x) for x in re.findall(
        r"epoch \d+: train loss avg ([-\w.]+)", sam_log)]
    log("sam_b train cli losses", iteration_losses=sam_losses,
        epoch_loss_avgs=epoch_avgs)
    if (len(sam_losses) != 2 * sam_iters
            or not all(map(math.isfinite, sam_losses))
            or not epoch_avgs[-1] < epoch_avgs[0]
            or "resumed from epoch 1" not in sam_log):
        raise AssertionError(f"SAM-B train log: losses {sam_losses}, epoch "
                             f"averages {epoch_avgs}")
    if not ((sam_dir / "checkpoints" / "latest.pth").is_file()
            and (sam_dir / "checkpoints" / "best.pth").is_file()):
        raise AssertionError("the SAM train CLI left no latest.pth / best.pth")

    phase_start("17")
    # 17. SAM-B gradients with sharp attention: kernels against plain
    #     attention, both held against the fp32 model (rel-pos tables
    #     included: their gradient comes only through drel)
    from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models import (
        sam_b, sam_h)
    sam_config = load_config_from_work_dir(str(sam_dir), "train_config")
    batch8 = {k: v.cuda() for k, v in sam_train_profile.synthetic_batch(
        sam_config, SAM_BATCH).items()}
    grad_batch = {k: v[:SAM_GRAD_BATCH] for k, v in batch8.items()}
    model = init_model(sam_b(use_gradient_checkpoint=True,
                             use_flash_attention=True), 0)
    sharpen_attention_(torch, model, SAM_GRAD_SEED)
    grad_counts = check_sam_gradients(torch, fa, ln, model, grad_batch,
                                      sam_config.train_criterion,
                                      "sam_b sharp attention")
    expect_counts("SAM-B gradients", grad_counts, K3=16, K3_bwd=8, K5=8,
                  K5_bwd=4)
    dec_flops = sam_decoder_flops(
        torch, model, batch8["image"],
        {k: batch8[k] for k in ("prompt_point", "prompt_box",
                                "prompt_box_valid", "prompt_mask",
                                "prompt_mask_valid")})
    enc_flops = sam_encoder_flops(model)
    del model

    phase_start("18")
    # 18. timed SAM-B train steps at batch 8, with the config's
    #     checkpointing and without; plain attention if it fits
    passes = 1 + sam_config.decoder_iters
    step_flops = SAM_BATCH * 3 * (enc_flops + passes * dec_flops)
    for remat in (True, False):
        model, train_step, _ = sam_train_profile.build_train_step(
            use_gradient_checkpoint=remat)
        reset_counts(fa, ln)
        first = train_step(batch8, 0)
        torch.cuda.synchronize()
        counts = read_counts(fa, ln)
        expect_counts(f"SAM-B train step, checkpointing {remat}", counts,
                      K3=16 if remat else 8, K3_bwd=8, K5=8 if remat else 4,
                      K5_bwd=4)
        if first["skipped"].item() or not math.isfinite(first["loss"].item()):
            raise AssertionError(f"SAM-B train step skipped: {first}")
        step = iter(range(1, 10 ** 6))
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: train_step(batch8, next(step)), iters=5,
                     warmup=1, device_only=False)
        fields = dict(batch=SAM_BATCH, gradient_checkpoint=remat,
                      decoder_passes=passes, launches_per_step=counts, ms=ms,
                      images_per_s=SAM_BATCH / ms * 1e3,
                      tflops=step_flops / ms / 1e9,
                      share_of_bf16_peak=step_flops / ms / 1e9 / 989.0,
                      counted="3x the forward: the encoder's products and "
                              f"{passes} decoder passes, no recompute",
                      gflop_per_image=step_flops / SAM_BATCH / 1e9,
                      decoder_gflop_per_pass=dec_flops / 1e9,
                      peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
        if remat:
            model.set_flash_attention(False)
            try:
                fields["plain_attention_ms"] = time_ms(
                    torch, lambda: train_step(batch8, next(step)), iters=2,
                    warmup=1, device_only=False)
            except torch.cuda.OutOfMemoryError:
                fields["plain_attention_ms"] = "does not fit in memory"
            model.set_flash_attention(True)
        log(f"sam_b train step {SAM_BATCH}", **fields)
        del model, train_step, first
        torch.cuda.empty_cache()

    phase_start("19")
    # 19. SAM-H training at full width, reduced depth: the windowed blocks'
    #     K4 and the global block's K5 at head dim 80, forward and backward,
    #     gradients against plain attention
    model = init_model(sam_h(image_encoder_block_nums=SAM_H_DEPTH,
                             image_encoder_global_attn_indexes=SAM_H_GLOBAL,
                             use_gradient_checkpoint=True,
                             use_flash_attention=True), 0)
    sharpen_attention_(torch, model, SAM_GRAD_SEED)
    sam_h_train_counts = check_sam_gradients(
        torch, fa, ln, model, grad_batch, sam_config.train_criterion,
        f"sam_h sharp attention, depth {SAM_H_DEPTH} of 32")
    n_global = len(SAM_H_GLOBAL)
    n_window = SAM_H_DEPTH - n_global
    expect_counts("SAM-H gradients", sam_h_train_counts, K4=2 * n_window,
                  K4_bwd=n_window, K5=2 * n_global, K5_bwd=n_global)
    del model, batch8, grad_batch

    phase_start("20")
    # 20. SAM2 video tracking: SAM2-B+ at full width and depth (1024^2,
    #     batch 1, bf16, the 14.1 configs' settings, seeded random weights)
    #     through the predict tool on the synthetic clip: frame 0 prompted,
    #     7 tracked, the last with every memory slot valid
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        predict_video_interactive_segmentation as video_cli)
    torch.cuda.empty_cache()
    reset_counts(fa, ln)
    video = video_cli.main(["--synthetic", "--max-frames", str(SAM2_FRAMES)])
    torch.cuda.synchronize()
    sam2_counts = read_counts(fa, ln)
    expect_counts("SAM2-B+ predict tool", sam2_counts, K1=18 * SAM2_FRAMES,
                  K6=3 * SAM2_FRAMES + 8 * (SAM2_FRAMES - 1))
    carry = video["carry"]
    if not (len(video["outputs"]) == SAM2_FRAMES
            and all(m.shape == (1, 4, 1024, 1024) and torch.isfinite(m).all()
                    and torch.isfinite(i).all() and torch.isfinite(o).all()
                    for m, i, o in video["outputs"])
            and int(carry["frame_idx"]) == SAM2_FRAMES
            and bool((carry["mem_valid"] == 1).all())):
        raise AssertionError("SAM2-B+: non-finite or misshapen outputs, or a "
                             "memory slot left empty")
    sam2, frames, prompts = video["model"], video["frames"], video["prompts"]
    # a tracked frame makes no host sync: torch raises on one in this mode
    with video_cli.compute_context(frames.device):
        feat, pos, hr = sam2.encode_frame(frames[-1:])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sam2.encode_frame(frames[-1:])
            sam2.track_frame(feat, pos, carry, highres=hr)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        del feat, pos, hr
    steady = video["lines"][2:]
    median = lambda xs: sorted(xs)[len(xs) // 2]
    encode_ms = median([line["encode_ms"] for line in steady])
    track_ms = median([line["track_ms"] for line in steady])
    encode_flops, track_flops = sam2_step_flops(torch, sam2, frames, prompts)
    # the window's whole time over its frames, so that a stall counts
    frame_ms = sum(line["encode_ms"] + line["track_ms"]
                   for line in steady) / len(steady)
    log("sam2_b+ predict tool", frames=SAM2_FRAMES, launches=sam2_counts,
        launches_per_encode={"K1": 18, "K6": 3}, launches_per_track={"K6": 8},
        encode_ms=encode_ms, track_ms=track_ms, frame_ms=frame_ms,
        frames_per_s=1e3 / frame_ms,
        tflops=(encode_flops + track_flops) / frame_ms / 1e9,
        share_of_bf16_peak=(encode_flops + track_flops) / frame_ms / 1e9
        / 989.0, encode_gflop=encode_flops / 1e9,
        track_gflop=track_flops / 1e9,
        counted="Linears, convolutions and attention products",
        timed="host clock to a synchronise; frames/s and the peak share "
        "from the mean encode + track ms over frames 2-7, encode_ms and "
        "track_ms their medians",
        per_frame_ms=[(round(l["encode_ms"], 3), round(l["track_ms"], 3))
                      for l in video["lines"]],
        object_scores=[round(l["object_score"], 4) for l in video["lines"]],
        mask_areas=[l["mask_area"] for l in video["lines"]])

    phase_start("21")
    # 21. the same weights and clip with sharp attention: the kernels
    #     against plain attention, held to the model's bf16 floor on every
    #     frame; a control shows that the check would fail without the key
    #     bias (the empty memory slots attended to)
    log("sam2_b+ memory attention, seeded init",
        **sam2_memory_logit_stats(torch, sam2, frames, prompts))
    sharpen_sam2_attention_(torch, sam2, SAM2_SHARP_SEED)
    sharp = sharpen_memory_keys_(torch, sam2, frames, prompts)
    log("sam2_b+ memory attention, sharpened", **sharp)
    if sharp["score_std"] < SAM_SHARP_MIN_STD / 2:
        raise AssertionError(f"SAM2-B+ memory attention not sharpened: "
                             f"{sharp}")
    sam2_compare(torch, sam2, frames, prompts, "sam2_b+ sharp attention",
                 control=True)
    del video, sam2, carry
    torch.cuda.empty_cache()

    phase_start("22")
    # 22. head_dim_padding=0 (reference-width heads) at full width, reduced
    #     depth: Hiera's windows through K2 at d = 56, its global block
    #     through K6 at d = 56, the memory through K6
    sam2 = video_cli.build_model(
        "sam2_hiera_base_plus_video", device="cuda", head_dim_padding=0,
        block_nums=SAM2_D56_BLOCKS, global_attention_blocks=SAM2_D56_GLOBAL)
    sharpen_sam2_attention_(torch, sam2, SAM2_SHARP_SEED)
    sharpen_memory_keys_(torch, sam2, frames, prompts)
    reset_counts(fa, ln)
    run_track(torch, sam2, frames[:2], prompts)
    torch.cuda.synchronize()
    d56_counts = read_counts(fa, ln)
    log("sam2_b+ head_dim_padding 0", reduced=f"Hiera blocks "
        f"{SAM2_D56_BLOCKS} of (2, 3, 16, 3), global {SAM2_D56_GLOBAL}",
        launches_two_frames=d56_counts)
    expect_counts("SAM2-B+ head_dim_padding 0, two frames", d56_counts,
                  K2=2 * 3, K6=2 * 1 + 8)
    sam2_compare(torch, sam2, frames, prompts,
                 "sam2_b+ head_dim_padding 0 sharp attention")
    del sam2, frames, prompts
    torch.cuda.empty_cache()

    phase_start("23-25")
    # 23-25. the SAM2 training slice
    sam2_train_counts = sam2_training_slice(torch, fa, ln, results)
    torch.cuda.empty_cache()

    # 26-33. MAE pretraining, distillation, Muon and this slice's configs
    #        (phases a-h)
    mae_distill_slice(torch, F, fa, ln, results, train_cli)
    torch.cuda.empty_cache()

    # 36-37. K2 at DINOv3's shapes and the DINOv3 ViTs (35, 38 and 39 ran
    #        while the kernels built)
    dinov3_kernel_slice(torch, F, fa, ln, results)
    torch.cuda.empty_cache()
    phase_start(None)

    # 40. kernels line
    source = PACKAGE + "/csrc/"
    pallas = "simpleaicv_pytorch_training_examples_tpu/ops/pallas/"

    def entry(key, label, file, replaces, launches, **extra):
        main_case = results[key][0]
        return {"name": label, "route": "cuda", "source": source + file,
                "replaces": pallas + replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in results[key]),
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"], **extra}
    no_model = {"caller": "no model path; launches of the K9 and K2b "
                          "entry-point phase"}
    kernels = [
        entry("K1", "K1 fused_attention_dense fwd", "short_attention_fwd.cu",
              "fused_attention.py:536", train_counts["K1"]),
        entry("K2", "K2 fused_attention fwd", "short_attention_fwd.cu",
              "fused_attention.py:121", train_counts_h["K2"]),
        entry("K1 bwd", "K1 fused_attention_dense bwd",
              "short_attention_bwd.cu", "fused_attention.py:550",
              train_counts["K1 bwd"]),
        entry("K2 bwd", "K2 fused_attention bwd", "short_attention_bwd.cu",
              "fused_attention.py:136", train_counts_h["K2 bwd"]),
        entry("K7", "K7 layer_norm fwd", "layer_norm.cu",
              "layer_norm.py:101", norm_train_counts["K7"]),
        entry("K7 bwd", "K7 layer_norm bwd", "layer_norm.cu",
              "layer_norm.py:120", norm_train_counts["K7 bwd"]),
        entry("K3", "K3 fused_attention_relwin_dense fwd",
              "short_attention_fwd.cu", "fused_attention.py:1146",
              sam_counts["K3"]),
        entry("K4", "K4 fused_attention_relwin fwd",
              "short_attention_fwd.cu", "fused_attention.py:901",
              sam_h_counts["K4"]),
        entry("K5", "K5 flash_attention_relpos fwd", "flash_attention_fwd.cu",
              "flash_attention.py:505", sam_counts["K5"]),
        entry("K3 bwd", "K3 fused_attention_relwin_dense bwd",
              "short_attention_bwd.cu", "fused_attention.py:1163",
              sam_train_counts["K3 bwd"]),
        entry("K4 bwd", "K4 fused_attention_relwin bwd",
              "short_attention_bwd.cu",
              "fused_attention.py:924", sam_h_train_counts["K4 bwd"]),
        entry("K5 bwd", "K5 flash_attention_relpos bwd",
              "flash_relpos_bwd.cu", "flash_attention.py:541",
              sam_train_counts["K5 bwd"]),
        entry("K6", "K6 flash_attention fwd", "flash_attention_fwd.cu",
              "flash_attention.py:113", sam2_counts["K6"]),
        entry("K6 bwd", "K6 flash_attention bwd", "flash_keybias_bwd.cu",
              "flash_attention.py:206", sam2_train_counts["K6 bwd"]),
        entry("K8", "K8 attn_block fwd", "attn_block.cu",
              "attn_block.py:272", block_train_counts["K8"]),
        entry("K8 bwd", "K8 attn_block bwd", "attn_block.cu",
              "attn_block.py:291", block_train_counts["K8 bwd"]),
        entry("K9", "K9 fused_attention_qkv fwd", "short_attention_fwd.cu",
              "fused_attention.py:718", entry_counts["K9"], **no_model),
        entry("K9 bwd", "K9 fused_attention_qkv bwd",
              "short_attention_bwd.cu", "fused_attention.py:734",
              entry_counts["K9 bwd"], **no_model),
        entry("K2b", "K2b fused_attention bias fwd",
              "short_attention_fwd.cu", "fused_attention.py:321",
              entry_counts["K2b"], **no_model),
        entry("K2b bwd", "K2b fused_attention bias bwd",
              "short_attention_bwd.cu", "fused_attention.py:338",
              entry_counts["K2b bwd"], **no_model),
    ]
    if len(kernels) != 20:
        raise AssertionError(f"{len(kernels)} rows in the kernels line, "
                             "expected every kernel of the table, 20")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def sam2_gradients_only():
    """``python3 chip_smoke.py --sam2-gradients``: the kernels' build and
    phase 24 alone (SAM2-B+'s gradient check and its control), for
    repeated readings of the check on one tree."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs an NVIDIA GPU")
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        build, fused_attention as fa, layer_norm as ln)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(nvidia_smi_line(), flush=True)
    log.card = torch.cuda.get_device_name(0)
    build.build()
    sam2_gradient_phase(torch, fa, ln)
    log("sam2 gradients only", ok=True)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    if sys.argv[1:] == ["--sam2-gradients"]:
        sam2_gradients_only()
    else:
        main()
