#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

Five paths in bf16, then the shipped configurations in their own fp32,
with random weights from a seed; the tokenizer's at ViT-VQGAN-Base's full
widths and depth (256 px, 8x8 patches, width 768, 12 heads of 64, MLP
3072, 12 + 12 layers, 8192 codes of 32):

- serving: the tokenizer round trip ``encode_codes`` -> ``decode_codes``;
- training: ``Trainer.fit`` on ``configs/fake_vitvq_base.yaml`` (held
  here as a dict, since the card's machine has no pyyaml): AE + StyleGAN
  discriminator steps at batch 8 with random-init LPIPS, step 0 with R1;
- stage-2 sampling: class-conditional ``CondTransformer.sample`` of the
  GPT prior of ``configs/imagenet_gpt_vitvq_base.yaml`` (also held as a
  dict) at batch 8;
- int8 serving of that prior, as the JAX package's
  ``scripts/serve_continuous.py --int8`` builds it: int8 weights
  (``quantize_decode_params``, ``drop_quantized_kernels``) and an int8 KV
  cache;
- fused serving: the tokenizer round trip with the JAX package's two
  opt-in fusions, ``ENHANCING_TPU_ATTN_PROJ=1`` and ``ffn_impl: fused``
  in the encoder and decoder configs;
- the shipped configs in fp32: ``configs/imagenet_vitvq_base.yaml`` and
  ``imagenet_vitvq_large.yaml`` (and Large with heads of 80 in the
  decoder, fp32 and bf16) round trips, a ``fake_vitvq_base`` training step
  with ``dtype: float32``, and the fp32 prior of
  ``imagenet_gpt_vitvq_base.yaml``'s prefill and decode steps;
- stage-2 training: ``Trainer.fit`` on ``imagenet_gpt_vitvq_base.yaml``'s
  prior at its published widths (depth cut to 4 in bf16 and 2 in its own
  fp32) over its frozen tokenizer, batch 4 of FakeImages at 256 px;
- RQ serving: the RQ-VAE tokenizer of ``imagenet_rqvae_base.yaml`` and
  the RQ prior of ``imagenet_rqtransformer_base.yaml`` over it (both held
  as dicts) at full width and depth, in bf16, fp32 and int8;
- RQ training: ``Trainer.fit`` on that RQ prior at full width and depth
  over its frozen RQ-VAE tokenizer, batch 4 of FakeImages at 256 px;
- Gumbel training: ``Trainer.fit`` on the model of
  ``configs/imagenet_vitvq_gumbel_base.yaml`` as shipped (fp32), LPIPS
  read through ``lpips_weights``;
- the split GAN step, ``reuse_xrec`` and gradient accumulation on
  ``configs/convergence_vitvq_base.yaml``;
- text conditioning: both CLIP towers at ViT-L/14 width, the CLIP
  conditioners on a checkpoint they read, and ``ViTVQ(path=...)`` on a
  reference checkpoint of the Base tokenizer;
- the command line: ``python -m enhancing_tpu_torch.main`` trains
  ``fake_vitvq_base.yaml`` with per-epoch checkpoints and ``--resume``,
  and the scripts reconstruct, evaluate and sample from config files.

Phases, each of which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of ``enhancing_tpu_torch/csrc`` by ``nvcc`` for
   sm_90a, with the ptxas register and shared-memory report; the SASS of
   the bf16 LN -> GEMM, the fused FFN, attention -> projection, the
   attention forwards (head dims up to 128, and the prior's 384), the
   attention backward (and at the prior's 384), their fp32 counterparts
   (fp32 attention -> projection, FFN and LN -> GEMM among them), the int8
   decode kernels, the LN -> shift -> GEMM and the VQ search must hold
   wgmma (HGMMA) and TMA loads (UTMALDG) and no mma.sync (``cuobjdump``),
   the fp32 kernels' wgmma (the VQ search's among them) must all be bf16
   (exact pieces; no TF32), and the FIR blur must hold TMA loads;
3. each kernel against its plain PyTorch version on the card at the main
   paths' shapes, with the tolerance stated on its line; the int8 decode
   MLP and its plain version are also held (logged) against an fp64
   evaluation of the same function;
4. each kernel's time (CUDA events; the serving kernels at batch 128, the
   training kernels at the training batch 8), beside its plain version,
   one PyTorch library call computing the same function (timed only; the
   port never calls it) and its bound on an H100 SXM; B5's and B15's
   kernel and library times are medians of 5 loops, their spread logged;
   B2 on the qkv buffer and B8 on its three lane slices run one kernel
   and must give the same output bit for bit; B9 is timed at cur_len 1,
   256, 512 and 1024 (512 in the ``kernels`` line); B3, its library call
   and B14 (fp32 and bf16 x) also as device time (``torch.profiler``);
5. serving through the public entry points: requests of batch 1, 8 and
   128 with launch counters reset just before and read just after,
   outputs checked, the kernels compared with the plain path on one small
   batch, images/s and peak memory at batch 128, and the device time of
   one round trip by kernel group (``torch.profiler``);
6. training through ``Trainer.fit``: counters reset just before and read
   just after, exact launches per step and per kernel asserted (the
   blur's backward on its kernel, ``fir_vjp``, among them; and the R1
   step's plain-routed calls), finite losses, moved parameters, code
   perplexity; one step's losses and per-tensor gradients through the
   kernels against the plain path; ms per step, images/s, peak memory and
   the device time of one step by kernel group;
7. stage-2 sampling: ``CondTransformer.sample`` of the published prior of
   ``configs/imagenet_gpt_vitvq_base.yaml`` at full width and depth (24
   layers of 6144, 16 heads of 384, 1024 codes) over the ViT-VQGAN-Base
   tokenizer, bf16, random weights drawn on the card, 8 class labels:
   counters reset just before and read just after one call and its
   launches asserted exactly; codes, pixels and a second seed checked;
   tokens/s, images/s, ms per decode step against its bound, peak
   memory; the sampler's per-step logits against the teacher-forced full
   forward on its codes; the kernels against the plain path on the full
   forward and 32 decode steps; one decode step's device time by kernel
   group;
8. int8 serving on phase 7's prior: 32 decode steps under
   ENHANCING_TPU_DECODE_LNFUSE=all (B11 and B1 launches per step asserted,
   logits held to the default path's; one LNFUSE step's device time by
   kernel group and its copy kernels); then ``quantize_decode_params``,
   int8 against bf16 (teacher-forced on phase 7's codes), the drop and the
   memory it frees, ``kv_int8``; one ``CondTransformer.sample`` with its
   launches asserted exactly; tokens/s, ms per decode step against its
   bound, peak memory; the kernels against the plain path on 32 decode
   steps; one decode step's device time by kernel group;
9. fused serving: requests of batch 1, 8 and 128 through
   ``encode_codes`` -> ``decode_codes`` of a model built with ``ffn_impl:
   fused`` under ENHANCING_TPU_ATTN_PROJ=1, counters reset just before
   and read just after, launches per round trip asserted exactly (B1 24,
   B15 24, B3 26, B16 24, B4 1); codes and reconstructions held to the
   default path (same seed) and to the plain path at batch 8 with phase
   5's limits; images/s and peak memory at batch 128 and one round
   trip's device time by kernel group; then batch-8 trips of
   ``imagenet_vitvq_small.yaml`` as shipped (fp32, 8 + 8 blocks of 512:
   fp32 B15 16, fp32 B16 16, no unfused call), of the same Base model in
   fp32 (fp32 B15 24, its FFN unfused as in JAX) and of
   ``imagenet_vitvq_large.yaml`` in bf16 with the decoder's heads of 80,
   launches, fp32 launches, unfused calls and each tower's routes asserted
   exactly, held to the plain path at phase 10's limits, each fp32 trip's
   host time beside its model's default trip and its device time by
   kernel group;
10. shipped configs: the two tokenizer configs through ``load_config`` +
    ``initialize_from_config(device="cuda")`` in their own fp32, and the
    Large config with the decoder's ``dim_head`` set to 80 (1280 / 16) in
    fp32 and bf16, a round trip each at batch 8 with launches a trip
    asserted exactly (Base B1 48, B2 24, B3 2, B4 1; Large B1 80, B2 40,
    B3 2, B4 1; every attention launch fp32 in fp32), codes and
    reconstructions against the plain path, time and peak memory;
11. the fp32 training step: ``fake_vitvq_base`` with ``dtype: float32``,
    one AE and D step with its launches asserted (phase 6's, every
    attention and attention backward launch fp32), steps 1-2 timed after
    it and one step's device time by kernel group, one step's losses and
    gradients against the plain path (1e-4 relative, cosines 0.99999);
12. the fp32 prior: ``imagenet_gpt_vitvq_base.yaml``'s GPT at full width
    and depth (24 x 6144, 16 heads of 384) in fp32, prefill (B8 fp32) and
    16 teacher-forced decode steps, launches asserted, logits against the
    plain path within 1e-3 and argmax equal at 99% of positions;
13. prior training: that config's prior through ``Trainer.fit`` at full
    width (6144, 16 heads of 384, 8192 codes, 1025 tokens), the depth cut
    for 7.25 GB of training state a layer: 4 layers in bf16 (fp32 master
    weights) for 3 steps, 2 layers in fp32 for 1 step, each then one
    validation batch; batch 4 of FakeImages (256 px, 1000 classes) over
    the frozen fp32 ViT-VQGAN-Base tokenizer with random weights. First
    one step's loss and per-leaf gradients through the kernels against
    ``plain_versions()`` on the same weights and codes (5e-3 relative and
    cosine 0.999 in bf16, 1e-4 and 0.99999 in fp32; the key biases, whose
    gradient is zero in exact arithmetic, held near zero instead); then
    the launches of each step (B1 24, fp32 B2 12, B3 1, B4 1, B8 and B5 at
    D = 384 once a layer) and of the validation batch asserted exactly,
    finite losses, every prior parameter moved, ms a step, peak memory and
    one step's device time by kernel group;
14. RQ serving: (a) RQ-VAE round trips in bf16 at batch 1, 8 and 128
    (launches a trip asserted: B1 48, B2 24, B3 2, B4 4; codes (B, 1024,
    4)), its codes held to the plain path depth by depth on the
    positions where every shallower depth agrees (95%) and its
    reconstructions (0.1) at batch 8, images/s and peak memory at batch
    128; (b) the RQ prior in bf16 with random weights, 8 class labels:
    one ``CondTransformer.sample`` with its launches asserted exactly
    (B8 24, B9 24 x 1023, B10 2 x 1023, 16 384 depth attentions on the
    short route, ``ops.SHORT_CALLS``, and the tokenizer's decode), codes
    and pixels checked, the sampler alone on a second seed with its
    logits against the teacher-forced forward, the kernels against the
    plain path on that forward and on 32 spatial positions with their
    depth loops (phase 7's limits), codes/s, images/s, ms per spatial
    position, peak memory and one position's device time by kernel
    group; (c) the prior in its own fp32 over the prefill and 16 spatial
    steps with every position's depth loop, launches asserted, against
    the plain path (phase 12's limits); (d) (b)'s prior in int8,
    teacher-forced on (b)'s codes over the prefill and 32 spatial
    positions with their depth loops: ``kv_int8`` alone (bf16 weights,
    bf16 q on the int8 cache) against the plain path (phase 7's limits),
    launches asserted; ``quantize_decode_params``, int8 against bf16
    (argmax equal on more than half of the positions) and the int8
    kernels against the int8 plain path (limits of their own: bf16 logits
    of the depth stack and head); one int8
    ``CondTransformer.sample`` of 8 labels with its launches asserted
    exactly (B8 24, B9 24 x 1023, B10 2 x 1023, B12 24 x 1025, B13 24 x
    1023, B14 24 x 1024, 16 384 short-route depth attentions, the
    tokenizer's decode), codes/s, ms per spatial position, peak memory and
    one position's device time by kernel group (its idle share);
15. RQ training: ``configs/imagenet_rqtransformer_base.yaml``'s prior
    through ``Trainer.fit`` at its published widths and full depth (24
    spatial layers of 1536, 16 heads of 96; 4 depth layers, 8 heads of
    192; 8192 codes, 1025 tokens x 4 depths) over its frozen fp32 RQ-VAE
    (random weights), batch 4 of FakeImages: bf16 with fp32 master
    weights for 3 steps, its own fp32 for 2, each then one validation
    batch; as phase 13, one step's loss and per-leaf gradients against
    the plain path first (codes encoded once), then the launches of each
    step (B1 24, fp32 B2 12, B3 1, B4 4, B8 24 and B5 at D = 96 24, 4
    depth attentions on the short route) and of the validation batch (no
    B5) asserted exactly, finite losses, every prior parameter moved, ms a
    step, peak memory and one step's device time by kernel group;
16. Gumbel training: the model block of
    ``configs/imagenet_vitvq_gumbel_base.yaml`` as shipped (``ViTVQGumbel``
    at ViT-VQGAN-Base widths in fp32, 8192 codes, its
    ``ExponentialDecayScheduler`` and loss weights) through
    ``Trainer.fit`` on FakeImages at 256 px, batch 8, its LPIPS read
    through ``lpips_weights`` from a file of seeded random VGG16 and lin
    weights in the torchvision / lpips layout that the phase writes; 3
    steps (R1 on step 0) and a validation batch, each step's temperature
    equal to the scheduler's and its launches asserted exactly (fp32 B1
    96, fp32 B2 48, B3 4, fp32 B5 24, B6 36 + 36, B7 45; no B4), code
    usage finite; one step's losses and gradients through the kernels
    against the plain path on the same weights and noise (one CUDA
    generator seed) at phase 6's limits; ms a step, peak memory and one
    step's device time by kernel group (its busy share);
17. the split step, ``reuse_xrec`` and accumulation:
    ``configs/convergence_vitvq_base.yaml`` (bf16, batch 8) from one saved
    state through ``Trainer.fit`` with the fused step, ``split_gan_step``
    and ``reuse_xrec`` (3 steps each) and ``accumulate_grad_batches=2`` (4
    micro-steps) on the kernels and on the plain versions: split against
    fused at phase 6's limits on the logged losses, the AdamW first
    moments and the parameter movements, with phase 6's launches a step;
    reuse_xrec one generator round trip (B1 48, B2 24, B3 2, B4 1) fewer a
    step than split; accumulation's parameters bit-equal after micro-steps
    1 and 3 and moved after 2 and 4, its first moments against its plain
    run at phase 6's limits; ms a step of each run;
18. text conditioning and released checkpoints, fp32 with seeded weights:
    (a) both CLIP towers at ViT-L/14 width (text 12 x 768, 12 heads of 64,
    77 tokens; vision 24 x 1024, 16 heads of 64, 257 tokens at 224 px),
    batch 8: captions tokenized by the port's ``SimpleTokenizer``, phase
    5's 256 px images through ``preprocess_images``; B8 launches a
    forward asserted (text 12, vision 24, all fp32), features against the
    plain path (each row's cosine >= 0.99999, max abs difference <= 1e-3
    of its norm), then the text tower in bf16 (cosine >= 0.999, the bf16
    prior step's bar; its B8 calls phase 4 holds to phase 3's limits);
    (b) an OpenAI-layout checkpoint of seeded ViT-B/32 towers written to
    a temporary directory and read back by ``ClipTextCond`` and
    ``ClipImageCond`` (``clip_params_path``): features bit-equal to the
    towers'; (c) a Lightning-layout checkpoint of a seeded
    ``imagenet_vitvq_base.yaml`` model (the reference's key names,
    ``loss.discriminator.*`` included) restored by ``ViTVQ(path=...,
    ignore_keys=[...])`` of another seed: every parameter equal, the
    ignored prefix the restored model's own, codes and reconstructions
    bit-equal, B1 48, B2 24, B3 2, B4 1 a trip; the files deleted; the
    forwards' and loads' times;
19. the command line and the user scripts, from ``configs/*.yaml`` cut
    to size and written by the port's YAML writer into a temporary
    working directory (deleted after): (a) ``enhancing_tpu_torch.main``
    on ``fake_vitvq_base.yaml`` as shipped (bf16, batch 8, B1-B7) with 2
    train and 2 validation steps an epoch: run A two epochs, run B one
    epoch then ``--resume`` to two; each run's launches asserted (phase
    6's per step and validation batch, plus the image logger's round trip
    on each epoch's first validation batch), the restored state held to
    the saved checkpoint tensor by tensor, run B's last checkpoint to run
    A's (bit-equal, else the AdamW first moments at phase 6's cosines),
    step times, checkpoint sizes and save / restore seconds; (b)
    ``scripts.reconstruct`` (4 PNGs) and ``scripts.evaluate`` (2 batches
    of 8 from a folder of PNGs in the ImageNet layout) on
    ``imagenet_vitvq_base.yaml`` restored through ``--ckpt`` from a
    reference checkpoint of another seed's model: codes equal to that
    model's, B1 48, B2 24, B3 2, B4 1 a trip; (c) ``scripts.sample`` and
    ``scripts.eval_samples`` (8 images, Inception weights read from a
    seeded torchvision-layout file) on ``imagenet_gpt_vitvq_base.yaml``'s
    prior at its published width, 2 layers, fp32, over that tokenizer: B8
    2, B9 2 046, B10 2 046 and the decode's B1 24, B2 12, B3 1 a sample,
    the Inception features on the card against the CPU's.

Phase 4 also holds and times fp32 B8 at phase 18's CLIP shapes (text 77
causal tokens, vision 257), beside SDPA fp32, logged apart from the
kernels line.
Phases 3 and 4 hold and time B8 and B9 at the RQ prior's head dim 96 and
B10 on its (24, 8, 1032, 1536) stack (and the int8 cache), on generators
of their own; and at the shapes phases 14 (d) and 15 give the kernels, on
generators of their own too: B5 at the RQ training batch's (4, 1025, 16,
96) in bf16 and fp32, fp32 B8 there, B9 at D = 96 on the (24, 8, 1152,
1536) int8 cache with fp32 and bf16 q, B10's int8 rows into that cache,
B12 (qkv and proj), B13 (qkv with the shift) and B14 at width 1536; and
B8 at both priors' training shapes 300 times, each call's bits equal to
the first's. B10's phase-4 rows are also timed by CUDA-graph replay
(device time: its eager calls are host-bound), given in the kernels line
as ``graph_ms`` and ``library_graph_ms`` beside the events times in
``ms`` and ``library_ms``, which keep the meaning they have for every
kernel and in earlier runs.
Phases 3 and 4 hold and time fp32 B1 (``csrc/ln_gemm_f32.cu``: each
fp32 product as six bf16 wgmma products of exact pieces, three with a bf16
weight read as stored) at the fp32 towers' batch-8 shapes, Base's fc1 also
against an fp64 evaluation (logged), and B11's kernel
(``csrc/ln_shift_gemm.cu``) at the LNFUSE qkv and, without the shift, at
the mlp and head sites, where fp32 B1's few rows run it.
Phases 3 and 4 hold and time the fp32 attention kernels
(``csrc/attention_f32.cu``: B2, B8 at 384, B5, B17-B19 in fp32, each
fp32 product as six bf16 wgmma products of exact pieces; two bounds each,
the pieces' at the bf16 rate and fp32 SIMT's), the fp32 fusions on the
same pieces (``csrc/attn_proj_f32.cu``, B15 at head dims 32, 64 and 128;
``csrc/ffn_f32.cu``, B16; each also beside the unfused form) and the bf16
forward and backward at heads of 80 (the 128 tile).
Phases 3 and 4 also hold and time B5 at the prior's head dim 384 in bf16
and fp32 (``csrc/attention_bwd_wide.cu``), its library column the
fastest ``scaled_dot_product_attention`` backward that takes D = 384.
Phases 3 and 4 also hold and time B17-B19, which no driven path runs
(their JAX counterparts are a public op, a function with no caller and a
kernel only a test reaches).
Phases 3 and 4 hold and time the VQ search B4 (``csrc/vq.cu``: fp32
scores as six bf16 wgmma products of exact pieces; two bounds, the
pieces' and fp32 SIMT's) and the FIR blur B6 (``csrc/fir.cu``, rows
streamed through a TMA ring) forward and as the VJP its backward
launches (``fir_vjp``), against autograd of the plain version and of the
library's depthwise convolution.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. With no card, or run
from a directory that does not hold the package, it fails before printing
any result.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# configs/fake_vitvq_base.yaml after load_config's target remap (a CPU
# test holds the two equal)
_TOWER = {"dim": 768, "depth": 12, "heads": 12, "mlp_dim": 3072}
_FAKE = "enhancing_tpu_torch.data.fake.FakeImages"
FAKE_VITVQ_BASE = {
    "model": {
        "target": "enhancing_tpu_torch.models.stage1.vitvqgan.ViTVQ",
        "params": {
            "image_key": "image", "image_size": 256, "patch_size": 8,
            "dtype": "bfloat16", "scan_layers": True, "remat": True,
            "encoder": dict(_TOWER), "decoder": dict(_TOWER),
            "quantizer": {"embed_dim": 32, "n_embed": 8192},
            "loss": {
                "target": "enhancing_tpu_torch.losses.vqperceptual."
                          "VQLPIPSWithDiscriminator",
                "params": {"loglaplace_weight": 0.0,
                           "loggaussian_weight": 1.0,
                           "perceptual_weight": 0.1,
                           "allow_random_lpips": True,
                           "adversarial_weight": 0.1}},
        }},
    "dataset": {
        "target": "enhancing_tpu_torch.data.DataModuleFromConfig",
        "params": {
            "batch_size": 8, "num_workers": 4,
            "train": {"target": _FAKE, "params": {
                "length": 4096, "resolution": 256, "seed": 1}},
            "validation": {"target": _FAKE, "params": {
                "length": 64, "resolution": 256, "seed": 2}},
        }},
}
BASE = {k: FAKE_VITVQ_BASE["model"]["params"][k]
        for k in ("image_size", "patch_size", "encoder", "decoder",
                  "quantizer")}
TOKENS, WIDTH, HEADS, HEAD_DIM, MLP, CODES, EMBED = 1024, 768, 12, 64, 3072, 8192, 32
CHECK_BATCH, TIME_BATCH, TRAIN_BATCH = 8, 128, 8
ROUND_TRIP = {"ln_gemm": 48, "attention": 24, "layernorm": 2, "vq": 1}
# the round trip with ENHANCING_TPU_ATTN_PROJ=1 and ffn_impl='fused', per
# block of the 12 + 12: B1 at LN1 -> qkv, B15 for attention -> to_out ->
# + residual, B3 at LN2, B16 for fc1 -> tanh -> fc2; then B3 at each
# stack's final LayerNorm and B4 once
FUSED_TRIP = {"ln_gemm": 24, "attn_proj": 24, "layernorm": 26, "ffn": 24,
              "vq": 1}
# per training step of fake_vitvq_base: two AE forwards (the AE update and
# the D update's fresh reconstruction), one AE backward, three D forwards
# (D on xrec in the AE phase, on x and xrec in the D phase) of 12 blurs
# and 15 bias + leaky ReLUs each, and their three backwards (the blur's
# VJP on the blur's kernel, fir_vjp)
TRAIN_STEP = {"ln_gemm": 96, "attention": 48, "layernorm": 4, "vq": 2,
              "attention_bwd": 24, "fir": 36, "fir_vjp": 36,
              "fused_act": 45}
# the R1 step also runs one D forward on the plain versions
R1_PLAIN = {"fir": 12, "fused_act": 15}
# a validation batch: one AE round trip and three D forwards
EVAL_STEP = {"ln_gemm": 48, "attention": 24, "layernorm": 2, "vq": 1,
             "attention_bwd": 0, "fir": 36, "fused_act": 45}
TRAIN_STEPS = 3
REPLACES = {
    "ln_gemm": "enhancing_tpu/ops/ln_gemm.py:65",
    "attention": "enhancing_tpu/ops/attention.py:334",
    "layernorm": "enhancing_tpu/ops/ln_gemm.py:385",
    "vq": "enhancing_tpu/ops/vq.py:48",
    "attention_bwd": "enhancing_tpu/ops/attention.py:904",
    "fir": "enhancing_tpu/ops/upfirdn2d.py:74",
    # the blur's VJP, which the JAX package computes as the blur of the
    # gradient (_fir_fused_bwd, XLA) and the port on B6's kernel
    "fir_vjp": "enhancing_tpu/ops/upfirdn2d.py:74",
    "fused_act": "enhancing_tpu/ops/fused_act.py:36",
    # the pallas_call sites (B8's kernel body is B2's _attn_kernel_packed)
    "attention_bnhd": "enhancing_tpu/ops/attention.py:626",
    "decode_attention": "enhancing_tpu/ops/attention.py:1593",
    "cache_row_update": "enhancing_tpu/ops/cache.py:71",
    "ln_shift_gemm": "enhancing_tpu/ops/ln_gemm.py:265",
    "int8_gemm": "enhancing_tpu/ops/int8.py:246",
    "int8_ln_gemm": "enhancing_tpu/ops/int8.py:373",
    "int8_mlp": "enhancing_tpu/ops/int8.py:506",
    "attn_proj": "enhancing_tpu/ops/attention.py:1164",
    "ffn": "enhancing_tpu/ops/ffn.py:88",
    "attention_bhnd": "enhancing_tpu/ops/attention.py:107",
    "attention_fused_bnhd": "enhancing_tpu/ops/attention.py:838",
    "attention_gridchunk": "enhancing_tpu/ops/attention.py:540",
}
# configs/imagenet_gpt_vitvq_base.yaml's model after load_config's target
# remap (a CPU test holds the two equal), less the stage-1 checkpoint path:
# the released weights are not in the repository
_BASE_TOWER = {"dim": 768, "depth": 12, "heads": 12, "mlp_dim": 3072}
GPT_VITVQ_BASE = {
    "target": "enhancing_tpu_torch.models.stage2.transformer.CondTransformer",
    "params": {
        "cond_key": "class",
        "cond": {
            "target": "enhancing_tpu_torch.models.cond.dummycond.ClassCond",
            "params": {"image_size": 256,
                       "class_name": "assets/class/imagenet.txt"}},
        "stage1": {
            "target": "enhancing_tpu_torch.models.stage1.vitvqgan.ViTVQ",
            "params": {
                "image_key": "image", "image_size": 256, "patch_size": 8,
                "encoder": dict(_BASE_TOWER), "decoder": dict(_BASE_TOWER),
                "quantizer": {"embed_dim": 32, "n_embed": 8192},
                "loss": {"target": "enhancing_tpu_torch.losses.vqperceptual."
                                   "DummyLoss"}}},
        "transformer": {
            "target": "enhancing_tpu_torch.models.stage2.layers.GPT",
            "params": {
                "vocab_cond_size": 1000, "vocab_img_size": 8192,
                "embed_dim": 6144, "cond_num_tokens": 1,
                "img_num_tokens": 1024, "n_heads": 16, "n_layers": 24,
                "scan_layers": True, "remat": True}},
    }}
PRIOR = GPT_VITVQ_BASE["params"]["transformer"]["params"]
P_LAYERS, P_WIDTH, P_HEADS = (PRIOR["n_layers"], PRIOR["embed_dim"],
                              PRIOR["n_heads"])
P_HEAD_DIM, P_CTX = P_WIDTH // P_HEADS, PRIOR["cond_num_tokens"] + 1024
P_CTX_PAD = -(-P_CTX // 8) * 8
P_VOCAB, SAMPLE_BATCH, P_STEPS = PRIOR["vocab_img_size"], 8, 1023
# per CondTransformer.sample of 8 images: the prefill (one B8 launch per
# layer), 1023 decode steps (one B9 launch per layer, two B10 launches),
# then the tokenizer's decode of the codes (12 layers)
SAMPLE_CALL = {"attention_bnhd": P_LAYERS,
               "decode_attention": P_LAYERS * P_STEPS,
               "cache_row_update": 2 * P_STEPS,
               "ln_gemm": 24, "attention": 12, "layernorm": 1}
# per CondTransformer.sample of the int8 prior: the prefill (int8 qkv and
# projection GEMMs, the int8 MLP, per layer; the int8 vocab head), then per
# decode step and layer the int8 LN + shift + qkv, the int8 projection,
# the int8 MLP and B9, the int8 head once, two B10 row writes; no B11
INT8_SAMPLE_CALL = {"int8_gemm": 2 * P_LAYERS + P_LAYERS * P_STEPS,
                    "int8_ln_gemm": 1 + (P_LAYERS + 1) * P_STEPS,
                    "int8_mlp": P_LAYERS + P_LAYERS * P_STEPS,
                    "attention_bnhd": P_LAYERS,
                    "decode_attention": P_LAYERS * P_STEPS,
                    "cache_row_update": 2 * P_STEPS,
                    "ln_gemm": 24, "attention": 12, "layernorm": 1}
# per decode step under ENHANCING_TPU_DECODE_LNFUSE=all: B11 at each
# layer's qkv, B1 at each MLP and at the head
LNFUSE_STEP = {"ln_shift_gemm": P_LAYERS, "ln_gemm": P_LAYERS + 1,
               "decode_attention": P_LAYERS, "cache_row_update": 2}
CHECK_STEPS = 32
CLASSES = (1, 7, 42, 99, 207, 388, 812, 980)
# configs/imagenet_rqvae_base.yaml's model after load_config's target remap,
# its loss DummyLoss as the RQ prior's stage 1 holds it, and
# configs/imagenet_rqtransformer_base.yaml's model less the stage-1
# checkpoint path (a CPU test holds them equal to the files): the RQ-VAE
# tokenizer (ViT-VQGAN-Base, a residual quantizer of depth 4) and the RQ
# prior over its (1024, 4) codes
RQVAE_BASE = {
    "target": "enhancing_tpu_torch.models.stage1.vitvqgan.ViTVQ",
    "params": {
        "image_key": "image", "image_size": 256, "patch_size": 8,
        "encoder": dict(_BASE_TOWER), "decoder": dict(_BASE_TOWER),
        "quantizer": {"embed_dim": 32, "n_embed": 8192,
                      "use_residual": True, "num_quantizers": 4},
        "loss": {"target": "enhancing_tpu_torch.losses.vqperceptual."
                           "DummyLoss"}}}
RQ_TRANSFORMER_BASE = {
    "target": "enhancing_tpu_torch.models.stage2.transformer.CondTransformer",
    "params": {
        "cond_key": "class", "code_shape": [1024, 4],
        "cond": {
            "target": "enhancing_tpu_torch.models.cond.dummycond.ClassCond",
            "params": {"image_size": 256,
                       "class_name": "assets/class/imagenet.txt"}},
        "stage1": json.loads(json.dumps(RQVAE_BASE)),
        "transformer": {
            "target": "enhancing_tpu_torch.models.stage2.layers."
                      "RQTransformer",
            "params": {
                "vocab_cond_size": 1000, "vocab_img_size": 8192,
                "embed_dim": 1536, "cond_num_tokens": 1,
                "img_num_tokens": 1024, "depth_num_tokens": 4,
                "spatial_n_heads": 16, "depth_n_heads": 8,
                "spatial_n_layers": 24, "depth_n_layers": 4}},
    }}
RQ_PRIOR = RQ_TRANSFORMER_BASE["params"]["transformer"]["params"]
RQ_LAYERS, RQ_WIDTH = RQ_PRIOR["spatial_n_layers"], RQ_PRIOR["embed_dim"]
RQ_HEADS, RQ_DEPTH = RQ_PRIOR["spatial_n_heads"], RQ_PRIOR["depth_num_tokens"]
RQ_HEAD_DIM = RQ_WIDTH // RQ_HEADS
RQ_DEPTH_LAYERS = RQ_PRIOR["depth_n_layers"]
# per RQ-VAE round trip: the ViT-VQGAN-Base towers' launches (phase 5) and
# the residual quantizer's four searches
RQ_TRIP = {"ln_gemm": 48, "attention": 24, "layernorm": 2, "vq": RQ_DEPTH}
# per CondTransformer.sample of the RQ prior, 8 images: the spatial
# prefill (one B8 launch a layer, N = 1, D = 96), 1023 spatial steps (one
# B9 launch a layer, two B10 launches), then the tokenizer's decode of the
# codes (12 layers); the depth windows of 4 tokens at head dim 192 take
# the short route (ops.SHORT_CALLS), 4 depth layers in each of 4 depth
# forwards at each of the 1024 positions
RQ_SAMPLE_CALL = {"attention_bnhd": RQ_LAYERS,
                  "decode_attention": RQ_LAYERS * P_STEPS,
                  "cache_row_update": 2 * P_STEPS,
                  "ln_gemm": 24, "attention": 12, "layernorm": 1}
RQ_SAMPLE_SHORT = 1024 * RQ_DEPTH * RQ_DEPTH_LAYERS
# configs/imagenet_rqtransformer_base.yaml's dataset batch_size (a CPU test
# holds it), the batch phase 15 trains the RQ prior at
RQ_TRAIN_BATCH = 4
# the RQ prior's int8 spatial cache pads its context to a multiple of 128,
# as the JAX module pads it (1025 -> 1152)
RQ_INT8_CTX = -(-P_CTX // 128) * 128
# per CondTransformer.sample of the int8 RQ prior, 8 images: the spatial
# prefill (the int8 qkv and projection GEMMs and the int8 MLP a layer, B8
# at N = 1), then per spatial step and layer the int8 LN + shift + qkv,
# the int8 projection, the int8 MLP and B9 (fp32 q on the int8 cache), two
# B10 row writes a step; no int8 head (the head is the depth path's, in
# bf16), and the depth windows on the short route as in the bf16 sample
RQ_INT8_SAMPLE_CALL = {"int8_gemm": 2 * RQ_LAYERS + RQ_LAYERS * P_STEPS,
                       "int8_ln_gemm": RQ_LAYERS * P_STEPS,
                       "int8_mlp": RQ_LAYERS + RQ_LAYERS * P_STEPS,
                       "attention_bnhd": RQ_LAYERS,
                       "decode_attention": RQ_LAYERS * P_STEPS,
                       "cache_row_update": 2 * P_STEPS,
                       "ln_gemm": 24, "attention": 12, "layernorm": 1}
# the discriminator's activations at 256 px, batch 8: its 12 blur inputs
# (each blurred with pads (2, 2) and (1, 1)) and its 15 bias + leaky ReLU
# inputs, the last one the final linear's
D_BLURS = [((TRAIN_BATCH, s, s, c), pad)
           for s, c in ((256, 128), (128, 256), (64, 512), (32, 512),
                        (16, 512), (8, 512)) for pad in ((2, 2), (1, 1))]
D_ACTS = ([(TRAIN_BATCH, 256, 256, 128)] * 2
          + [(TRAIN_BATCH, 128, 128, 256)] * 2 + [(TRAIN_BATCH, 64, 64, 512)] * 2
          + [(TRAIN_BATCH, s, s, 512) for s in (32, 32, 16, 16, 8, 8, 4, 4)]
          + [(TRAIN_BATCH, 512)])
# the fp32 attention kernels (csrc/attention_f32.cu), each beside the bf16
# kernel whose launch counter it shares (ops.F32_LAUNCHES tells them apart)
# and the fp32 fusions on the same pieces (csrc/attn_proj_f32.cu,
# csrc/ffn_f32.cu)
F32_OF = {"attention_f32": "attention", "attention_bnhd_f32": "attention_bnhd",
          "attention_bwd_f32": "attention_bwd",
          "attention_bhnd_f32": "attention_bhnd",
          "attention_fused_bnhd_f32": "attention_fused_bnhd",
          "attention_gridchunk_f32": "attention_gridchunk",
          "attn_proj_f32": "attn_proj", "ffn_f32": "ffn"}
REPLACES.update({name: REPLACES[bf16] for name, bf16 in F32_OF.items()})
# B5 at the prior's head dim 384, bf16 and fp32: kernels of their own
# (csrc/attention_bwd_wide.cu), counted under attention_bwd too and told
# apart by ops.WIDE_LAUNCHES (kernel_counts)
WIDE_BWD = {"attention_bwd_wide": "attn_bwd_wide",
            "attention_bwd_wide_f32": "attn_f32_bwd_wide"}
REPLACES.update({name: REPLACES["attention_bwd"] for name in WIDE_BWD})
# fp32 B1: csrc/ln_gemm_f32.cu's tiles, and at a decode step's few rows B11's
# kernel without the shift (ops.ln_gemm.ln_gemm_route), counted under
# ln_gemm and told apart by ops.LN_GEMM_ROUTES (kernel_counts)
REPLACES["ln_gemm_f32"] = REPLACES["ln_gemm"]
# B2, B8 and B17-B19 run the attention forwards of one source, their fp32
# forms another
SOURCES = {name: "enhancing_tpu_torch/csrc/" + {
    "attention": "attention_bnhd", "attention_bhnd": "attention_bnhd",
    "attention_fused_bnhd": "attention_bnhd",
    "attention_gridchunk": "attention_bnhd", "attn_proj_f32": "attn_proj_f32",
    "ffn_f32": "ffn_f32", "attention_bwd_wide_f32": "attention_bwd_wide",
    "ln_gemm_f32": "ln_gemm_f32", "fir_vjp": "fir"}.get(
        name, "attention_f32" if name in F32_OF else name) + ".cu"
    for name in REPLACES}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
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


def device_ms(fn, calls: int = 20) -> float:
    """Device ms per call of ``fn``, summed over its kernels
    (torch.profiler): back-to-back CUDA-event times of a short call are
    the host's launch time. A trace that holds no device time (seen late
    in a long run, for a call that launches kernels) is taken once more,
    and a second empty one reads as not measured (nan)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / calls
    return float("nan")


def graph_ms(fn, calls: int = 100, replays: int = 20) -> float:
    """Device ms per call of ``fn``: a CUDA graph of ``calls`` calls
    replayed ``replays`` times between CUDA events (no host work; the
    launch gaps inside the graph counted). For short kernels whose eager
    calls are host-bound, where the profiler's sums read low."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions on CUDA tensors: the reference path
    of this script only. The package itself sends CUDA tensors to the
    kernels and has no such switch (``force_plain_ops`` aside, which R1
    alone uses)."""
    from enhancing_tpu_torch.ops import (attention, cache, ffn, fused_act,
                                         int8, ln_gemm, upfirdn2d, vq)
    mods = (attention, ln_gemm, vq, upfirdn2d, fused_act, cache, int8, ffn)
    saved = [m.use_kernel for m in mods]
    for m in mods:
        m.use_kernel = lambda *tensors, **kw: False
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.use_kernel = fn


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}"
        f"; count {torch.cuda.device_count()}")
    log(smi.stdout.strip().splitlines()[0])
    return name


def phase_build() -> None:
    from enhancing_tpu_torch.ops import cuda_lib
    cuda_lib.lib()
    info = cuda_lib.build_info
    log(f"[build] {info['path']} in {info['seconds']:.1f} s "
        f"(cached: {info['cached']})")
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line \
                or line.startswith("=="):
            log("  " + line.strip())
    check_sass(info["path"])


# the bf16 LN -> GEMM (B1), the fused FFN (B16), attention -> projection
# (B15), the attention forwards (B2, B8 at head dims up to 128, B17-B19;
# B8 at the prior's 384), the attention backward's two kernels (B5; and
# at the prior's 384, csrc/attention_bwd_wide.cu), their fp32
# counterparts on exact bf16 pieces (B15, B16 and B1 among them), the int8
# decode kernels (B12-B14) and B11 on their core run
# on Hopper's warpgroup MMA fed by TMA: their SASS holds HGMMA and
# UTMALDG, and no mma.sync (HMMA). Each family by its demangled or mangled
# name; the first family whose fragment a name holds takes it, so the
# longer names come first (int8_ln_gemm, ln_shift_gemm and ln_gemm_f32
# before ln_gemm).
SM90_KERNELS = {"int8_gemm": ("int8_gemm_kernel",),
                "int8_ln_gemm": ("int8_ln_gemm_kernel",),
                "ln_shift_gemm": ("ln_shift_gemm_kernel",),
                "ln_gemm f32": ("ln_gemm_f32_kernel",),
                "ln_gemm": ("ln_gemm_kernel<", "ln_gemm_kernelI"),
                "ffn": ("ffn_kernel<", "ffn_kernelI"),
                "attn_proj": ("attn_proj_kernel",),
                "attention fwd": ("attn_fwd_kernel",),
                "attention fwd D=384": ("attn_wide_kernel",),
                "attention_bwd rows": ("attn_bwd_rows_kernel",),
                "attention_bwd cols": ("attn_bwd_cols_kernel",),
                "attention fwd f32": ("attn_f32_fwd_kernel",),
                "attention fwd f32 D=384": ("attn_f32_wide_kernel",),
                "attention_bwd f32 rows": ("attn_f32_bwd_rows_kernel",),
                "attention_bwd f32 cols": ("attn_f32_bwd_cols_kernel",),
                "attn_proj f32": ("attn_proj_f32_kernel",),
                "ffn f32": ("ffn_f32_kernel",),
                "int8_mlp": ("int8_mlp_kernel",),
                "attention_bwd D=384 rows": ("attn_bwd_wide_rows_kernel",),
                "attention_bwd D=384 cols": ("attn_bwd_wide_cols_kernel",),
                "vq": ("vq_nearest_kernel",)}
# the fp32 kernels (csrc/attention_f32.cu, attn_proj_f32.cu, ffn_f32.cu,
# and csrc/attention_bwd_wide.cu, whose bf16 and fp32 forms share a
# template) compute fp32 products as six bf16 products of exact pieces,
# and the decode kernels on int8_wgmma.cuh (B12-B14, B11) int8 weights
# widened to bf16, bf16 weights or fp32 weights' exact pieces times exact
# bf16 pieces, as fp32 B1 (ln_gemm_f32.cu) does: every HGMMA of theirs is
# BF16, and none is TF32 (a single TF32 pass misses the fp32 limits) or
# int8 by int8
F32_PIECE_FAMILIES = ("attention fwd f32", "attention fwd f32 D=384",
                      "attention_bwd f32 rows", "attention_bwd f32 cols",
                      "attn_proj f32", "ffn f32", "attention_bwd D=384 rows",
                      "attention_bwd D=384 cols", "int8_mlp", "int8_gemm",
                      "int8_ln_gemm", "ln_shift_gemm", "ln_gemm f32", "vq")
# kernels fed by TMA that compute without the tensor cores: their SASS
# holds UTMALDG and no HGMMA or HMMA (the FIR blur, forward and VJP)
TMA_KERNELS = {"fir": ("fir_kernel",)}


def check_sass(lib_path: str) -> None:
    """Count HGMMA, UTMALDG and HMMA in the SASS of the sm90 kernels."""
    from pathlib import Path
    from torch.utils.cpp_extension import CUDA_HOME
    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    if not tool.exists():
        log("[build] cuobjdump not found: SASS not checked")
        return
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    demangled = subprocess.run(["c++filt"], input=sass, capture_output=True,
                               text=True).stdout or sass
    found = set()
    for block in demangled.split("Function : ")[1:]:
        name = block.split("\n", 1)[0]
        family = next((f for f, frags in {**SM90_KERNELS,
                                          **TMA_KERNELS}.items()
                       if any(k in name for k in frags)), None)
        if family is None:
            continue
        found.add(family)
        counts = {op: block.count(op) for op in ("HGMMA", "UTMALDG",
                                                 "UTMASTG", "HMMA")}
        hgmma = [ln for ln in block.splitlines() if "HGMMA" in ln]
        kinds = sorted({ln.split("HGMMA", 1)[1].split()[0] for ln in hgmma})
        log(f"[build] SASS {name[:70]}: {counts} {kinds}")
        if family in TMA_KERNELS:
            check(counts["UTMALDG"] > 0 and counts["HGMMA"] == 0
                  and counts["HMMA"] == 0,
                  f"{name}: expected TMA loads and no tensor-core product")
            continue
        check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
              and counts["HMMA"] == 0,
              f"{name}: expected wgmma fed by TMA and no mma.sync")
        if family in F32_PIECE_FAMILIES:
            check(all(k.endswith(".F32.BF16") for k in kinds),
                  f"{name}: expected bf16 wgmma of exact pieces into fp32, "
                  "no TF32 or int8")
    want = set(SM90_KERNELS) | set(TMA_KERNELS)
    check(found == want, f"kernels missing from the SASS: {want - found}")


def rand(shape, gen, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def kernel_inputs(batch: int, gen: torch.Generator) -> dict:
    """Main-path shapes at ``batch`` images, from seeded random numbers."""
    m = batch * TOKENS
    d = WIDTH
    w_scale = (2.0 / (d + 3 * d)) ** 0.5
    return {
        "x": rand((m, d), gen),
        "gamma": 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda"),
        "beta": 0.1 * torch.randn(d, generator=gen, device="cuda"),
        "w_qkv": rand((3 * d, d), gen, scale=w_scale),
        "w_fc1": rand((MLP, d), gen, scale=w_scale),
        "b_fc1": 0.02 * torch.randn(MLP, generator=gen, device="cuda"),
        "qkv": rand((batch, TOKENS, 3 * HEADS * HEAD_DIM), gen),
        "z": F.normalize(torch.randn((m, EMBED), generator=gen,
                                     device="cuda"), dim=-1),
        "codebook": F.normalize(torch.randn((CODES, EMBED), generator=gen,
                                            device="cuda"), dim=-1),
    }


def vq_scores(z, codebook):
    return -2.0 * (z @ codebook.t()) + (codebook * codebook).sum(-1)[None]


def near_tie_rows(scores, rel=1e-5):
    """Rows whose two best plain scores lie within ``rel`` of each other."""
    top2 = torch.topk(scores, 2, dim=-1, largest=False).values
    gap = top2[:, 1] - top2[:, 0]
    return gap <= rel * top2[:, 0].abs().clamp(min=1e-6)


def phase_compare() -> dict:
    """Kernel vs plain on the card; returns max_abs_err per kernel."""
    from enhancing_tpu_torch.ops import LAUNCHES
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import fused_act as fa
    from enhancing_tpu_torch.ops import ln_gemm as lg
    from enhancing_tpu_torch.ops import upfirdn2d as fir
    from enhancing_tpu_torch.ops import vq
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = kernel_inputs(CHECK_BATCH, gen)
    errs = {}

    def close(name, label, got, want, atol, rtol):
        """atol: a number, or a (rows, 1) tensor of per-row limits."""
        err = (got.float() - want.float()).abs()
        worst = float((err - rtol * want.float().abs() - atol).max())
        ok = worst <= 0 and bool(torch.isfinite(got).all())
        mae = float(err.max())
        errs[name] = max(errs.get(name, 0.0), mae)
        lim = (f"per-row atol {float(atol.min()):.3g}..{float(atol.max()):.3g}"
               if torch.is_tensor(atol) else f"atol {atol:g}")
        log(f"[compare] {label}: max_abs_err {mae:.3e} tol {lim} + "
            f"rtol {rtol:g}*|plain| -> {'pass' if ok else 'FAIL'}")
        check(ok, f"{label} disagrees with its plain version")

    # bf16 outputs: one bf16 rounding (2^-8 relative) on each side, plus
    # the normalised row rounding to bf16 at a different place in a few
    # elements, so two bf16 steps
    tol = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
    for label, w, b, act in (("ln_gemm qkv n=2304", t["w_qkv"], None, None),
                             ("ln_gemm fc1 n=3072 tanh", t["w_fc1"],
                              t["b_fc1"], "tanh")):
        got = lg.ln_gemm_kernel(t["x"], t["gamma"], t["beta"], w, b, act)
        want = lg.ln_gemm_plain(t["x"], t["gamma"], t["beta"], w, b, act)
        close("ln_gemm", label + " bf16 M=8192", got, want, **tol)
    # the wgmma tiles' ragged edges: m past a 128-row block (and m = 1),
    # n past a 128- or 256-column tile, d % 64 == 32 (a half k tile)
    for (m, d, n, act) in ((1000, 1280, 2312, "sqrelu"), (1, 32, 8, "gelu"),
                           (100, 256, 136, "tanh")):
        x = rand((m, d), gen)
        g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        bt = 0.1 * torch.randn(d, generator=gen, device="cuda")
        w = rand((n, d), gen, scale=d ** -0.5)
        b = 0.1 * torch.randn(n, generator=gen, device="cuda")
        close("ln_gemm", f"ln_gemm bf16 ragged M={m} d={d} n={n} {act}",
              lg.ln_gemm_kernel(x, g, bt, w, b, act),
              lg.ln_gemm_plain(x, g, bt, w, b, act), **tol)
    # fp32 (csrc/ln_gemm_f32.cu): the same products on exact bf16 pieces,
    # another summation order
    x32, w32 = t["x"][:2048].float(), t["w_qkv"].float()
    close("ln_gemm_f32", "ln_gemm f32 M=2048 n=2304",
          lg.ln_gemm_kernel(x32, t["gamma"], t["beta"], w32, None, "gelu"),
          lg.ln_gemm_plain(x32, t["gamma"], t["beta"], w32, None, "gelu"),
          atol=1e-4, rtol=1e-5)
    compare_f32_ln_gemm(t, close)

    got = lg.layernorm_kernel(t["x"], t["gamma"], t["beta"])
    want = lg.layernorm(t["x"], t["gamma"], t["beta"])
    close("layernorm", "layernorm bf16 M=8192 d=768", got, want, **tol)

    # attention: P is rounded to bf16 against the running row max in the
    # kernel and the final row max in the plain version
    atol_att = dict(atol=1e-2, rtol=2.0 ** -7)
    got = att.attention_packed_qkv_kernel(t["qkv"], HEADS, HEAD_DIM,
                                          HEAD_DIM ** -0.5)
    want = att.attention_packed_qkv_plain(t["qkv"], HEADS, HEAD_DIM,
                                          HEAD_DIM ** -0.5)
    close("attention", "attention none B=8 N=1024 H=12 D=64", got, want,
          **atol_att)
    # ... and at one token, at one row past a 64-row box, and at each head
    # dim of the Hopper forward
    for (b, n, h, d, mode, cl) in ((2, 1025, 4, 64, "prefix_causal", 5),
                                   (2, 1025, 12, 64, "none", 0),
                                   (1, 200, 4, 32, "prefix_causal", 17),
                                   (1, 300, 2, 128, "none", 0),
                                   (3, 1, 4, 64, "none", 0),
                                   (2, 65, 4, 64, "prefix_causal", 3),
                                   (2, 65, 2, 128, "none", 0)):
        qkv = rand((b, n, 3 * h * d), gen)
        got = att.attention_packed_qkv_kernel(qkv, h, d, d ** -0.5, mode, cl)
        want = att.attention_packed_qkv_plain(qkv, h, d, d ** -0.5, mode, cl)
        close("attention", f"attention {mode} B={b} N={n} H={h} D={d}",
              got, want, **atol_att)

    got = vq.nearest_kernel(t["z"], t["codebook"])
    want = vq.nearest_plain(t["z"], t["codebook"])
    scores = vq_scores(t["z"], t["codebook"])
    ties = near_tie_rows(scores)
    diff = got != want
    bad = int((diff & ~ties).sum())
    # the error of a code is the gap between the plain scores it and the
    # plain version's code get: 0 where they agree
    rows = torch.arange(len(got), device=got.device)
    errs["vq"] = float((scores[rows, got.long()]
                        - scores[rows, want.long()]).abs().max())
    log(f"[compare] vq M=8192 n=8192 D=32: {int(diff.sum())} mismatches, "
        f"{int(ties.sum())} near-tie rows (best two plain scores within "
        f"1e-5 relative), {bad} mismatches outside near-ties (tol 0) -> "
        f"{'pass' if bad == 0 else 'FAIL'}")
    check(bad == 0, "vq kernel disagrees outside near-ties")
    dup = torch.cat([t["codebook"][:64], t["codebook"][:64]])
    check(bool((vq.nearest_kernel(t["z"][:4096], dup) < 64).all()),
          "vq kernel: duplicated codes must resolve to the lowest index")
    # the two row tiles a warpgroup of large batches at D = 32, the other
    # head dims (D = 16 runs as 32 with zero columns), ragged codebooks and
    # rows past a block; inputs of their own
    gq = torch.Generator(device="cuda").manual_seed(19)
    for m, n, d in ((TIME_BATCH * TOKENS + 37, CODES - 1, EMBED),
                    (CHECK_BATCH * TOKENS + 37, CODES, 64),
                    (CHECK_BATCH * TOKENS, 100, 16)):
        z = F.normalize(torch.randn((m, d), generator=gq, device="cuda"),
                        dim=-1)
        cb = F.normalize(torch.randn((n, d), generator=gq, device="cuda"),
                         dim=-1)
        got, want = vq.nearest_kernel(z, cb), vq.nearest_plain(z, cb)
        ties = near_tie_rows(vq_scores(z, cb))
        bad = int(((got != want) & ~ties).sum())
        log(f"[compare] vq M={m} n={n} D={d}: {int((got != want).sum())} "
            f"mismatches, {bad} outside near-ties (tol 0) -> "
            f"{'pass' if bad == 0 else 'FAIL'}")
        check(bad == 0, f"vq kernel disagrees outside near-ties at D={d}")
        del z, cb, got, want, ties

    # attention backward: the kernel rounds dS to bf16 before its
    # products, autograd of the plain version rounds dP instead; one bf16
    # step on terms summed over N keys, held to 2^-6 of the largest plain
    # value plus 2^-6 relative
    for (b, n, h, d, mode, cl) in ((TRAIN_BATCH, TOKENS, HEADS, HEAD_DIM,
                                    "none", 0),
                                   (2, 1025, 4, 64, "prefix_causal", 5)):
        qkv = rand((b, n, 3 * h * d), gen)
        q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
        do = rand((b, n, h * d), gen)
        got = att.attention_bwd_kernel(q3, k3, v3, do, h, d, mode, cl)
        want = att.attention_bwd_plain(q3, k3, v3, do, h, d, mode, cl)
        for name, g, w in zip("qkv", got, want):
            close("attention_bwd", f"attention_bwd d{name} {mode} B={b} "
                  f"N={n} H={h} D={d}", g, w,
                  atol=2.0 ** -6 * float(w.float().abs().max()),
                  rtol=2.0 ** -6)

    # FIR blur, f32: the same 16 products in another order
    blur = fir.make_blur_kernel([1, 3, 3, 1])
    for shape, pad in D_BLURS:
        x = torch.randn(shape, generator=gen, device="cuda")
        close("fir", f"fir f32 {shape} pad {pad}", fir.upfirdn2d(x, blur,
                                                                pad=pad),
              fir.upfirdn2d_plain(x, blur, 1, 1, pad), atol=1e-5, rtol=1e-5)
    x = torch.randn((2, 19, 23, 64), generator=gen, device="cuda")
    k = torch.tensor([[1.0, 2.0, 0.0], [0.5, -1.0, 3.0]])
    close("fir", "fir f32 (2, 19, 23, 64) 2x3 taps pad (-1, 2, 0, -2)",
          fir.upfirdn2d(x, k, pad=(-1, 2, 0, -2)),
          fir.upfirdn2d_plain(x, k, 1, 1, (-1, 2, 0, -2)), atol=1e-5,
          rtol=1e-5)

    # the blur's VJP (fir_vjp): the backward launches B6's kernel on the
    # output's gradient with the unflipped taps at the mirrored pads;
    # against autograd of the plain version, f32 the same 16 products in
    # another order, bf16 one rounding of an fp32 sum on each side; inputs
    # of their own
    gb = torch.Generator(device="cuda").manual_seed(20)
    cases = ([(shape, pad, blur, torch.float32) for shape, pad in D_BLURS]
             + [(D_BLURS[0][0], (2, 2), blur, torch.bfloat16),
                (D_BLURS[-2][0], (2, 2), blur, torch.bfloat16)]
             + [((2, 19, 23, 64), (-1, 2, 0, -2), k, dt)
                for dt in (torch.float32, torch.bfloat16)])
    for shape, pad, taps, dtype in cases:
        x = torch.randn(shape, generator=gb, device="cuda").to(dtype)
        xk = x.clone().requires_grad_()
        out = fir.upfirdn2d(xk, taps, pad=pad)
        g = torch.randn(out.shape, generator=gb, device="cuda").to(dtype)
        n_vjp = LAUNCHES["fir_vjp"]
        (got,) = torch.autograd.grad(out, xk, g)
        check(LAUNCHES["fir_vjp"] == n_vjp + 1, "fir's backward did not "
              "launch the kernel once")
        xp = x.clone().requires_grad_()
        (want,) = torch.autograd.grad(
            fir.upfirdn2d_plain(xp, taps, 1, 1, pad), xp, g)
        tol = (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
               else dict(atol=2.0 ** -7, rtol=2.0 ** -7))
        close("fir_vjp", f"fir_vjp {str(dtype)[6:]} {shape} "
              f"{tuple(taps.shape)} taps pad {pad}", got, want, **tol)
    del x, xk, xp, out, g, got, want

    # bias + leaky ReLU: the same roundings in the same order, exact
    for shape, dtype in ((D_ACTS[0], torch.float32), (D_ACTS[-1],
                                                      torch.float32),
                         (D_ACTS[0], torch.bfloat16)):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        bias = 0.3 * torch.randn(shape[-1], generator=gen, device="cuda")
        close("fused_act", f"fused_act {dtype} {shape}",
              fa.fused_leaky_relu(x, bias), fa.fused_act_plain(x, bias),
              atol=0.0, rtol=0.0)

    compare_prior_kernels(gen, close, errs)
    compare_int8_kernels(gen, close, errs)
    compare_fused_kernels(gen, close, errs)
    compare_f32_kernels(gen, close, errs)
    compare_f32_fusions(gen, close, errs)
    compare_wide_bwd(gen, close, errs)
    compare_rq_kernels(close)
    compare_rq_slice_kernels(close)
    compare_repeats()
    torch.cuda.synchronize()
    return errs


def ln_gemm_f64(x, gamma, beta, w, b, activation, eps=1e-5):
    """LN -> GEMM in fp64 on fp32 operands (no rounding of its own): what
    fp32 B1's products, summed exactly, give."""
    from enhancing_tpu_torch.ops import ln_gemm as lg
    x64 = x.double()
    mean = x64.mean(-1, keepdim=True)
    var = ((x64 * x64).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn = (x64 - mean) * (torch.rsqrt(var + eps) * gamma.double()) \
        + beta.double()
    h = xn @ w.double().t()
    return lg._act(h if b is None else h + b.double(), activation)


def compare_f32_ln_gemm(t, close) -> None:
    """fp32 B1 (csrc/ln_gemm_f32.cu) at the fp32 towers' batch-8 shapes:
    ViT-VQGAN-Base's fc1 (768 -> 3072, tanh) and imagenet_vitvq_large.yaml's
    decoder qkv and fc1 (1280 -> 3840, 5120), fp32 W; Base's qkv with the
    bf16 weight read as stored; at the first line's limits (the same
    products, another summation order). The fc1 line is also held (logged)
    against an fp64 evaluation. Its own random numbers: the lines after it
    draw the same inputs from phase 3's generator as before it was added."""
    from enhancing_tpu_torch.ops import ln_gemm as lg
    gen = torch.Generator(device="cuda").manual_seed(18)
    x, g, bt = t["x"].float(), t["gamma"], t["beta"]
    w, b = t["w_fc1"].float(), t["b_fc1"]
    got = lg.ln_gemm_kernel(x, g, bt, w, b, "tanh")
    want = lg.ln_gemm_plain(x, g, bt, w, b, "tanh")
    close("ln_gemm_f32", "ln_gemm f32 Base fc1 M=8192 768 -> 3072 tanh", got,
          want, atol=1e-4, rtol=1e-5)
    exact = ln_gemm_f64(x, g, bt, w, b, "tanh")
    log("[compare] ln_gemm f32 Base fc1 M=8192 against an fp64 evaluation "
        f"(|fp64| max {float(exact.abs().max()):.4f}): kernel max_abs_err "
        f"{float((got.double() - exact).abs().max()):.3e}, plain "
        f"{float((want.double() - exact).abs().max()):.3e} (logged)")
    del got, want, exact
    w16 = t["w_qkv"]
    close("ln_gemm_f32", "ln_gemm f32 Base qkv M=8192 768 -> 2304, bf16 W "
          "as stored", lg.ln_gemm_kernel(x, g, bt, w16, None, None),
          lg.ln_gemm_plain(x, g, bt, w16, None, None), atol=1e-4, rtol=1e-5)
    d = 1280
    xl = torch.randn((CHECK_BATCH * TOKENS, d), generator=gen, device="cuda")
    gl = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    bl = 0.1 * torch.randn(d, generator=gen, device="cuda")
    for n, label, act in ((3 * d, "qkv", None), (4 * d, "fc1", "tanh")):
        wl = torch.randn((n, d), generator=gen, device="cuda") * d ** -0.5
        bias = 0.02 * torch.randn(n, generator=gen, device="cuda")
        close("ln_gemm_f32", f"ln_gemm f32 Large decoder {label} M=8192 "
              f"{d} -> {n}", lg.ln_gemm_kernel(xl, gl, bl, wl, bias, act),
              lg.ln_gemm_plain(xl, gl, bl, wl, bias, act), atol=1e-4,
              rtol=1e-5)
        del wl


def prior_stack(gen, cur, width=P_WIDTH, ctx=P_CTX_PAD):
    """The prior's (L, B, ctx, C) k and v stacks at batch 8, bf16, with
    every row at or past each batch row's cur_len set to 1e6: a kernel that
    read one would show it. ``width``: C (the RQ prior's 1536); ``ctx``:
    the padded context (the RQ prior's int8 cache: 1152)."""
    shape = (P_LAYERS, SAMPLE_BATCH, ctx, width)
    dead = (torch.arange(ctx, device="cuda")[None, :]
            >= torch.as_tensor(cur, device="cuda").reshape(-1, 1))
    out = []
    for _ in range(2):
        t = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        t.masked_fill_(dead[None, :, :, None], 1e6)
        out.append(t)
    return out


def compare_prior_kernels(gen, close, errs) -> None:
    """B8-B10 against their plain versions at the prior's shapes."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import cache
    # B8: as B2, P rounds to bf16 against the running row max
    atol_att = dict(atol=1e-2, rtol=2.0 ** -7)
    for (b, n, h, d, mode, cl) in ((2, P_CTX, P_HEADS, P_HEAD_DIM,
                                    "prefix_causal", 1),
                                   (2, P_CTX, P_HEADS, P_HEAD_DIM,
                                    "prefix_causal", 3),
                                   (SAMPLE_BATCH, 1, P_HEADS, P_HEAD_DIM,
                                    "prefix_causal", 1),
                                   (2, 300, 4, 64, "prefix_causal", 5)):
        q, k, v = (rand((b, n, h, d), gen) for _ in range(3))
        close("attention_bnhd", f"attention_bnhd {mode} cond_len {cl} B={b} "
              f"N={n} H={h} D={d}",
              att.attention_bnhd_kernel(q, k, v, d ** -0.5, mode, cl),
              att.attention_bnhd_plain(q, k, v, d ** -0.5, mode, cl),
              **atol_att)

    # B9 on the prior's stack, each batch row held to its own output's
    # scale (|out| falls as about (e / cur_len)^0.5, so a ragged line's rows
    # differ by 30x). Against the plain version: it rounds the weights,
    # their sum with V and the quotient to bf16, the kernel sums in fp32
    # and rounds once: two bf16 steps of an element x (at most 2^-6 x) in
    # a row whose largest |plain| is M lie within 2^-7 M + 2^-7 x; atol
    # 2^-7 of the row's M, never more than 2^-8 of the line's largest
    # (enough where M is near it), + rtol 2^-7. Against the
    # same function in fp32 on the same inputs, the tight gate: one bf16
    # rounding of the kernel's output, rtol 2^-8, + atol 2^-12 of the row's
    # largest |fp32| for fp32 sums in another order. A dropped key or
    # new-token term moves an output by about |v| / cur_len, several times
    # the fp32 limits at every cur_len here.
    hd, layer = P_WIDTH, 17
    ragged = torch.tensor([1, 100, 255, 256, 511, 513, 900, 1024],
                          dtype=torch.int32, device="cuda")
    # ragged rows outside [0, ctx) clamp, as _decode_xla's mask does
    outside = torch.tensor([-3, 0, 1, 513, P_CTX_PAD, P_CTX_PAD + 9, 1024,
                            1031], dtype=torch.int32, device="cuda")
    q3 = rand((SAMPLE_BATCH, hd), gen, scale=P_HEAD_DIM ** -0.5)
    kn, vn = rand((SAMPLE_BATCH, hd), gen), rand((SAMPLE_BATCH, hd), gen)
    for cur, label in ((1, 1), (255, 255), (256, 256), (513, 513),
                       (1024, 1024), (ragged, "ragged"),
                       (outside, "ragged, rows outside [0, ctx)")):
        kc, vc = prior_stack(gen, cur)
        got = att.decode_attention_kernel(q3, kc, vc, kn, vn, cur, layer,
                                          P_HEAD_DIM)
        want = att.decode_attention_plain(q3, kc[layer], vc[layer], kn, vn,
                                          cur, P_HEAD_DIM)
        what = (f"decode_attention bf16 stack {tuple(kc.shape)} layer "
                f"{layer} cur_len {label} (rows past cur_len = 1e6)")
        close("decode_attention", what + " vs plain", got, want,
              atol=row_atol(want, 2.0 ** -7).clamp(
                  max=2.0 ** -8 * float(want.float().abs().max())),
              rtol=2.0 ** -7)
        want32 = att.decode_attention_plain(
            q3.float(), kc[layer].float(), vc[layer].float(), kn.float(),
            vn.float(), cur, P_HEAD_DIM)
        close("decode_attention", what + " vs fp32", got, want32,
              atol=row_atol(want32, 2.0 ** -12), rtol=2.0 ** -8)
        del kc, vc, want32

    # B10: a copy, exact; a ragged row outside [0, ctx) is left unwritten
    stack = rand((P_LAYERS, SAMPLE_BATCH, P_CTX_PAD, P_WIDTH), gen)
    news = rand((P_LAYERS, SAMPLE_BATCH, 1, P_WIDTH), gen)
    for cur, label in ((513, 513), (ragged, "ragged"),
                       (outside, "ragged, rows outside [0, ctx)")):
        want = cache.cache_row_update_plain(stack.clone(), news, cur)
        got = cache.cache_row_update_kernel(stack, news, cur)
        close("cache_row_update", f"cache_row_update bf16 {tuple(stack.shape)}"
              f" cur_len {label}", got, want, atol=0.0, rtol=0.0)
        del want


def compare_rq_kernels(close) -> None:
    """B8 and B9 at the RQ prior's head dim 96 (B8 on the 128 tile) and
    B10 on its (24, 8, 1032, 1536) stack and on the int8 cache of the GPT
    prior's, against their plain versions at phase 3's limits, on a
    generator of their own."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import cache
    gen = torch.Generator(device="cuda").manual_seed(21)
    h, d = RQ_HEADS, RQ_HEAD_DIM
    for b, n in ((2, P_CTX), (SAMPLE_BATCH, 1)):
        q, k, v = (rand((b, n, h, d), gen) for _ in range(3))
        close("attention_bnhd", f"attention_bnhd prefix_causal cond_len 1 "
              f"B={b} N={n} H={h} D={d} (the 128 tile)",
              att.attention_bnhd_kernel(q, k, v, d ** -0.5, "prefix_causal",
                                        1),
              att.attention_bnhd_plain(q, k, v, d ** -0.5, "prefix_causal",
                                       1),
              atol=1e-2, rtol=2.0 ** -7)
    del q, k, v
    layer = 5
    ragged = torch.tensor([1, 100, 255, 256, 511, 513, 900, 1024],
                          dtype=torch.int32, device="cuda")
    outside = torch.tensor([-3, 0, 1, 513, P_CTX_PAD, P_CTX_PAD + 9, 1024,
                            1031], dtype=torch.int32, device="cuda")
    q3 = rand((SAMPLE_BATCH, RQ_WIDTH), gen, scale=d ** -0.5)
    kn, vn = rand((SAMPLE_BATCH, RQ_WIDTH), gen), rand((SAMPLE_BATCH,
                                                        RQ_WIDTH), gen)
    for cur, label in ((1, 1), (513, 513), (1024, 1024), (ragged, "ragged"),
                       (outside, "ragged, rows outside [0, ctx)")):
        kc, vc = prior_stack(gen, cur, RQ_WIDTH)
        got = att.decode_attention_kernel(q3, kc, vc, kn, vn, cur, layer, d)
        want = att.decode_attention_plain(q3, kc[layer], vc[layer], kn, vn,
                                          cur, d)
        what = (f"decode_attention bf16 stack {tuple(kc.shape)} D={d} layer "
                f"{layer} cur_len {label} (rows past cur_len = 1e6)")
        close("decode_attention", what + " vs plain", got, want,
              atol=row_atol(want, 2.0 ** -7).clamp(
                  max=2.0 ** -8 * float(want.float().abs().max())),
              rtol=2.0 ** -7)
        want32 = att.decode_attention_plain(
            q3.float(), kc[layer].float(), vc[layer].float(), kn.float(),
            vn.float(), cur, d)
        close("decode_attention", what + " vs fp32", got, want32,
              atol=row_atol(want32, 2.0 ** -12), rtol=2.0 ** -8)
        del kc, vc, want32
    for width, dtype in ((RQ_WIDTH, torch.bfloat16), (P_WIDTH, torch.int8)):
        shape = (P_LAYERS, SAMPLE_BATCH, P_CTX_PAD, width)
        if dtype == torch.int8:
            stack, news = (torch.randint(-127, 128, sh, generator=gen,
                                         device="cuda", dtype=dtype)
                           for sh in (shape, shape[:2] + (1, width)))
        else:
            stack, news = rand(shape, gen), rand(shape[:2] + (1, width), gen)
        for cur, label in ((513, 513), (ragged, "ragged"),
                           (outside, "ragged, rows outside [0, ctx)")):
            want = cache.cache_row_update_plain(stack.clone(), news, cur)
            got = cache.cache_row_update_kernel(stack, news, cur)
            close("cache_row_update", f"cache_row_update {str(dtype)[6:]} "
                  f"{shape} cur_len {label}", got, want, atol=0.0, rtol=0.0)
            del want
        del stack, news


def row_atol(want, frac: float) -> torch.Tensor:
    """``frac`` of each row's own largest |want|, (rows, 1): a decode
    attention row at cur_len 1024 (|out| ~ 0.2) is held to its scale, not
    to that of a row at cur_len 1 (~3) in the same ragged batch."""
    return frac * want.float().abs().amax(dim=-1, keepdim=True)


def own_limits(want, bf16: bool) -> dict:
    """The limit of an int8-serving line, from its own output: fp32 sums
    over thousands of terms in another order, 1e-5 of the largest |plain|
    + 1e-5 relative; bf16 (an output or an operand rounded to bf16 on one
    side only), one bf16 step: 2^-8 of the largest |plain| + 2^-7
    relative."""
    top = float(want.float().abs().max())
    if bf16:
        return dict(atol=2.0 ** -8 * top, rtol=2.0 ** -7)
    return dict(atol=1e-5 * top, rtol=1e-5)


def prior_int8_inputs(gen, c=P_WIDTH) -> dict:
    """The int8 decode step's operands at batch 8 on the prior's widths
    (``c``: the RQ prior's 1536): the fp32 residual stream, LayerNorm and
    time_mix, the bf16 shift state, int8 twins of seeded bf16 weights (std
    0.02, as the prior draws them) and their biases."""
    from enhancing_tpu_torch.ops import int8
    b = SAMPLE_BATCH

    def twin(n, d):
        w = rand((n, d), gen, scale=0.02)
        return (w,) + int8.quantize_channelwise(w)

    t = {"x": torch.randn((b, c), generator=gen, device="cuda"),
         "x16": rand((b, c), gen),
         "gamma": 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
         "beta": 0.1 * torch.randn(c, generator=gen, device="cuda"),
         "tm": torch.linspace(0, 1, c, device="cuda"),
         "prev": rand((b, c), gen)}
    for name, n, d in (("qkv", 3 * c, c), ("proj", c, c), ("p0", 4 * c, c),
                       ("p1", c, 4 * c), ("head", P_VOCAB, c)):
        t[name], t[name + "_q"], t[name + "_s"] = twin(n, d)
        t[name + "_b"] = rand((n,), gen, scale=0.02)
    return t


def int8_mlp_f64(x, gamma, beta, w0_q, s0, b0, w1_q, s1, b1, residual,
                 activation="sqrelu", eps=1e-5):
    """The int8 decode MLP in fp64, with the roundings the function itself
    makes (LN(x) and the hidden to x's dtype) and no others."""
    from enhancing_tpu_torch.ops import ln_gemm as lg
    x64 = x.double()
    mean = x64.mean(-1, keepdim=True)
    var = ((x64 * x64).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn = ((x64 - mean) * (torch.rsqrt(var + eps) * gamma.double())
          + beta.double()).to(x.dtype).double()
    h = xn @ w0_q.double().t() * s0.double()
    if b0 is not None:
        h = h + b0.double()
    h = lg._act(h, activation).to(x.dtype).double()
    res = residual.double() + (0.0 if b1 is None else b1.double())
    return (h @ w1_q.double().t()) * s1.double() + res


def compare_int8_kernels(gen, close, errs) -> None:
    """B11-B14 and B9's new dtype pairs against their plain versions at the
    int8 serving path's shapes, each line with the limit of its output;
    B1 at the LNFUSE sites and B10 on int8 rows."""
    from enhancing_tpu_torch.ops import cache, int8
    from enhancing_tpu_torch.ops import ln_gemm as lg
    t = prior_int8_inputs(gen)
    x, x16, g, bt, tm, prev = (t[k] for k in ("x", "x16", "gamma", "beta",
                                              "tm", "prev"))

    def line(name, label, got, want, bf16=False):
        close(name, label, got, want, **own_limits(want, bf16))

    line("int8_gemm", "int8_gemm decode proj f32 x (8, 6144) -> 6144",
         int8.int8_gemm_kernel(x, t["proj_q"], t["proj_s"], t["proj_b"]),
         int8.int8_gemm_plain(x, t["proj_q"], t["proj_s"], t["proj_b"]))
    line("int8_gemm", "int8_gemm prefill qkv bf16 x (8, 6144) -> 18432",
         int8.int8_gemm_kernel(x16, t["qkv_q"], t["qkv_s"], t["qkv_b"]),
         int8.int8_gemm_plain(x16, t["qkv_q"], t["qkv_s"], t["qkv_b"]),
         bf16=True)
    for label, args in (
            ("qkv with shift f32 x (8, 6144) -> 18432",
             (x, g, bt, tm, prev, t["qkv_q"], t["qkv_s"], t["qkv_b"])),
            ("head f32 x (8, 6144) -> 8192",
             (x, g, bt, None, None, t["head_q"], t["head_s"], None))):
        got, got_xn = int8.int8_ln_gemm_kernel(*args)
        want, want_xn = int8.int8_ln_gemm_plain(*args)
        line("int8_ln_gemm", "int8_ln_gemm " + label, got, want)
        line("int8_ln_gemm", "int8_ln_gemm " + label + ", LN(x)", got_xn,
             want_xn)
    mlp = (x, g, bt, t["p0_q"], t["p0_s"], t["p0_b"], t["p1_q"], t["p1_s"],
           t["p1_b"], x)
    got, want = int8.int8_mlp_kernel(*mlp), int8.int8_mlp_plain(*mlp)
    line("int8_mlp", "int8_mlp f32 x (8, 6144), hidden 24576", got, want)
    exact = int8_mlp_f64(*mlp)
    log("[compare] int8_mlp f32 x (8, 6144), hidden 24576, against an fp64 "
        f"evaluation (|fp64| max {float(exact.abs().max()):.4f}): kernel "
        f"max_abs_err {float((got.double() - exact).abs().max()):.3e}, "
        f"plain {float((want.double() - exact).abs().max()):.3e} (logged)")
    del got, want, exact
    got, got_xn = lg.ln_shift_gemm_kernel(x, g, bt, tm, prev, t["qkv"],
                                          t["qkv_b"])
    want, want_xn = lg.ln_shift_gemm_plain(x, g, bt, tm, prev, t["qkv"],
                                           t["qkv_b"])
    line("ln_shift_gemm", "ln_shift_gemm qkv f32 x, bf16 W (18432, 6144)",
         got, want)
    line("ln_shift_gemm", "ln_shift_gemm qkv f32 x, LN(x)", got_xn, want_xn)
    # B1 at the LNFUSE mlp and head sites: fp32 x of 8 rows, so B11's
    # kernel without the shift (ops.ln_gemm.ln_gemm_route), on the bf16
    # weight as stored (as fused_ln_gemm hands it over) and on its fp32
    # widening
    for label, w, b, act in (("mlp p0 sqrelu", t["p0"], t["p0_b"], "sqrelu"),
                             ("head", t["head"], None, None)):
        b32 = None if b is None else b.float()
        check(lg.ln_gemm_route(x.shape[0], x.dtype, w.dtype) == "decode",
              "the LNFUSE sites' rows do not take the decode route")
        for wk in (w, w.float()):
            line("ln_gemm_f32", f"ln_gemm LNFUSE {label} f32 x (8, 6144) -> "
                 f"{w.shape[0]}, {str(wk.dtype)[6:]} W",
                 lg.ln_gemm_kernel(x, g, bt, wk, b32, act),
                 lg.ln_gemm_plain(x, g, bt, wk, b32, act))
            del wk
    del t, mlp

    # B10 on the int8 cache: 6144-byte rows, exact; scalar, ragged, and
    # ragged rows outside [0, ctx) left unwritten
    shape = (P_LAYERS, SAMPLE_BATCH, P_CTX_PAD, P_WIDTH)
    stack = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
    news = torch.randint(-127, 128, shape[:2] + (1, P_WIDTH), generator=gen,
                         device="cuda", dtype=torch.int8)
    ragged = torch.tensor([1, 100, 255, 256, 511, 513, 900, 1024],
                          dtype=torch.int32, device="cuda")
    outside = torch.tensor([-3, 0, 1, 513, P_CTX_PAD, P_CTX_PAD + 9, 1024,
                            1031], dtype=torch.int32, device="cuda")
    for cur, label in ((513, 513), (ragged, "ragged"),
                       (outside, "ragged, rows outside [0, ctx)")):
        want = cache.cache_row_update_plain(stack.clone(), news, cur)
        got = cache.cache_row_update_kernel(stack, news, cur)
        close("cache_row_update", f"cache_row_update int8 {shape} cur_len "
              f"{label}", got, want, atol=0.0, rtol=0.0)
        del want
    del stack, news

    # B9's new (q, cache) pairs on the prior's stack, scalar and ragged
    # cur_len
    compare_decode_pairs(gen, close, ragged, P_WIDTH, P_HEAD_DIM, P_CTX_PAD,
                         17, DECODE_PAIRS)


# B9's (q, cache) pairs beside the bf16 pair: fp32 q on a bf16 cache (the
# fp32 decode), fp32 and bf16 q on an int8 cache (int8 weights and not)
DECODE_PAIRS = ((torch.float32, "bf16"), (torch.float32, "int8"),
                (torch.bfloat16, "int8"))


def compare_decode_pairs(gen, close, ragged, width, head_dim, ctx, layer,
                         pairs) -> None:
    """B9 on a (24, 8, ctx, width) stack at heads of ``head_dim`` for each
    (q dtype, cache) of ``pairs``, at cur_len 513, 1024 and ``ragged``,
    against its plain version and against the same function in fp32; every
    row at or past cur_len is 1e6 (bf16) or 127 at a scale of 1e6
    (int8)."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import int8
    for cur, label in ((513, 513), (1024, 1024), (ragged, "ragged")):
        kc, vc = prior_stack(gen, cur, width, ctx)
        k8, ks = int8.quantize_channelwise(kc)
        v8, vs = int8.quantize_channelwise(vc)
        dead = (torch.arange(ctx, device="cuda")[None, :]
                >= torch.as_tensor(cur, device="cuda").reshape(-1, 1))
        for q8, sc in ((k8, ks), (v8, vs)):
            q8.masked_fill_(dead[None, :, :, None], 127)
            sc.masked_fill_(dead[None], 1e6)
        for q_dtype, kv in pairs:
            q3 = rand((SAMPLE_BATCH, width), gen, q_dtype,
                      head_dim ** -0.5)
            new_dtype = q_dtype if kv == "int8" else torch.bfloat16
            kn, vn = (rand((SAMPLE_BATCH, width), gen, new_dtype)
                      for _ in range(2))
            stacks = ((kc, vc, None, None) if kv == "bf16"
                      else (k8, v8, ks, vs))
            got = att.decode_attention_kernel(q3, stacks[0], stacks[1], kn,
                                              vn, cur, layer, head_dim,
                                              stacks[2], stacks[3])
            what = (f"decode_attention q {q_dtype} cache {kv} stack "
                    f"{tuple(kc.shape)} layer {layer} cur_len {label}")
            kp, vp = stacks[0][layer], stacks[1][layer]
            k32, v32 = kp.float(), vp.float()
            if stacks[2] is not None:
                k32, v32 = att.dequant_cache(kp, vp, stacks[2][layer],
                                             stacks[3][layer], torch.float32)
                kp, vp = att.dequant_cache(kp, vp, stacks[2][layer],
                                           stacks[3][layer], q_dtype)
            want = att.decode_attention_plain(q3, kp, vp, kn, vn, cur,
                                              head_dim)
            want32 = att.decode_attention_plain(
                q3.float(), k32, v32, kn.float(), vn.float(), cur,
                head_dim)
            # every limit from each batch row's own largest |plain| (as
            # in compare_prior_kernels)
            if torch.bfloat16 in (q_dtype, kp.dtype):
                # the plain version rounds PV's unnormalised sum, its sum
                # with the new term and the quotient to bf16, and a bf16 q
                # also the dequantised rows; the kernel sums in fp32 and
                # rounds once: two bf16 steps of the row's largest |plain|
                # + 2^-7 relative (one step, 2^-8, is exceeded at cur_len
                # 1024 with a bf16 q)
                close("decode_attention", what + " vs plain", got, want,
                      atol=row_atol(want, 2.0 ** -7), rtol=2.0 ** -7)
            else:
                close("decode_attention", what + " vs plain", got, want,
                      atol=row_atol(want, 1e-5), rtol=1e-5)
            # the gate that sees a dropped tail key: the same function in
            # fp32 on the same (dequantised) values, sums in another order
            # and one bf16 rounding of a bf16 output
            f32 = q_dtype == torch.float32
            close("decode_attention", what + " vs fp32", got, want32,
                  atol=row_atol(want32, 1e-5 if f32 else 2.0 ** -12),
                  rtol=1e-5 if f32 else 2.0 ** -8)
            del want, want32, k32, v32
        del kc, vc, k8, v8, ks, vs


def phase_times() -> dict:
    """ms of kernel, plain version and library call: the serving kernels
    at batch 128, the training kernels at batch 8. Returns the rows of
    each kernel, one per main-path shape."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import fused_act as fa
    from enhancing_tpu_torch.ops import ln_gemm as lg
    from enhancing_tpu_torch.ops import upfirdn2d as fir
    from enhancing_tpu_torch.ops import vq
    gen = torch.Generator(device="cuda").manual_seed(1)
    t = kernel_inputs(TIME_BATCH, gen)
    m, d = TIME_BATCH * TOKENS, WIDTH
    rows: dict = {name: [] for name in REPLACES}

    def row(name, label, kernel, plain, library, flops, nbytes, peak, iters,
            reps=1, graph=False):
        """reps > 1: kernel and library loops in turns, each number the
        median of ``reps`` loops, their min-max logged. ``graph``: kernel
        and library are also timed by CUDA-graph replay (:func:`graph_ms`,
        device time for short kernels whose eager calls are host-bound),
        kept as ``graph_ms`` and ``library_graph_ms`` beside the events
        times, which stay in ``ms`` and ``library_ms`` as in every row of
        the kernels line. The fp32 attention
        kernels (``peak`` PEAK_F32; fp32 B1 and B4 among them) compute six
        bf16 products of exact pieces for each fp32 one: their bound is
        those products at the bf16 peak (989 / 6 = 165 TFLOP/s), and the
        fp32 SIMT bound (67 TFLOP/s) is logged and kept beside it."""
        simt = None
        if name in F32_OF or name in ("attention_bwd_wide_f32",
                                      "ln_gemm_f32", "vq"):
            simt = bound(flops, nbytes, PEAK_F32)[0]
            flops, peak = 6 * flops, PEAK_BF16
        b_ms, b_by = bound(flops, nbytes, peak)
        ks, ls = [], []
        for _ in range(reps):
            ks.append(time_ms(kernel, iters))
            if library is not None:
                ls.append(time_ms(library, iters))
        r = dict(ms=statistics.median(ks),
                 plain_ms=time_ms(plain, 3, warmup=1),
                 library_ms=statistics.median(ls) if ls else None,
                 bound_ms=b_ms, bound_by=b_by)
        if simt is not None:
            r["bound_f32_simt_ms"] = simt
        graph_note = ""
        if graph:
            r["graph_ms"] = graph_ms(kernel)
            r["library_graph_ms"] = (None if library is None
                                     else graph_ms(library))
            graph_note = (f"; by graph replay: kernel_ms {r['graph_ms']:.5f}"
                          + ("" if library is None else
                             f" library_ms {r['library_graph_ms']:.5f}"))
        rows[name].append(r)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        spread = "" if reps == 1 else (
            f" (medians of {reps} loops: kernel {min(ks):.4f}-{max(ks):.4f}"
            + (f", library {min(ls):.4f}-{max(ls):.4f}" if ls else "") + ")")
        simt_note = ("" if simt is None else
                     f", fp32 SIMT bound {simt:.4f} ms (67 TFLOP/s), "
                     f"{flops / 6 / r['ms'] / 1e9:.1f} fp32 TFLOP/s")
        log(f"[time] {label}: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {lib} bound_ms {b_ms:.4f} "
            f"({b_by}); {flops / r['ms'] / 1e9:.1f} TFLOP/s, "
            f"{nbytes / r['ms'] / 1e6:.1f} GB/s{simt_note}{spread}"
            f"{graph_note}")

    x, g, b = t["x"], t["gamma"], t["beta"]
    for label, w, bias, act in (("ln_gemm qkv", t["w_qkv"], None, None),
                                ("ln_gemm fc1", t["w_fc1"], t["b_fc1"],
                                 "tanh")):
        n = w.shape[0]
        lib_bias = None if bias is None else bias.to(torch.bfloat16)
        row("ln_gemm", f"{label} B={TIME_BATCH}",
            lambda: lg.ln_gemm_kernel(x, g, b, w, bias, act),
            lambda: lg.ln_gemm_plain(x, g, b, w, bias, act),
            lambda: lg._act(F.linear(F.layer_norm(x, (d,), g.to(x.dtype),
                                                  b.to(x.dtype), 1e-5),
                                     w, lib_bias), act),
            2.0 * m * d * n, (m * d + n * d + m * n) * 2 + (2 * d + n) * 4,
            PEAK_BF16, 20)

    qkv = t["qkv"]
    q, k, v = qkv.view(TIME_BATCH, TOKENS, 3, HEADS, HEAD_DIM).permute(
        2, 0, 3, 1, 4)
    hd = HEADS * HEAD_DIM
    row("attention", f"attention B={TIME_BATCH}",
        lambda: att.attention_packed_qkv_kernel(qkv, HEADS, HEAD_DIM,
                                                HEAD_DIM ** -0.5),
        lambda: att.attention_packed_qkv_plain(qkv, HEADS, HEAD_DIM,
                                               HEAD_DIM ** -0.5),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4.0 * TIME_BATCH * HEADS * TOKENS * TOKENS * HEAD_DIM,
        (TIME_BATCH * TOKENS * 4 * hd) * 2, PEAK_BF16, 10)
    # B8 on the same buffer's three lane slices runs B2's kernel through
    # the same tensor maps: the outputs must be equal bit for bit. B2, B8,
    # B8, B2 in turn
    q_s, k_s, v_s = (u.view(TIME_BATCH, TOKENS, HEADS, HEAD_DIM)
                     for u in qkv.split(hd, dim=-1))
    b2 = lambda: att.attention_packed_qkv_kernel(  # noqa: E731
        qkv, HEADS, HEAD_DIM, HEAD_DIM ** -0.5)
    b8 = lambda: att.attention_bnhd_kernel(  # noqa: E731
        q_s, k_s, v_s, HEAD_DIM ** -0.5)
    equal = torch.equal(b2(), b8().view(TIME_BATCH, TOKENS, hd))
    ab = [time_ms(fn, 10) for fn in (b2, b8, b8, b2)]
    log(f"[time] attention B={TIME_BATCH} N={TOKENS} H={HEADS} D={HEAD_DIM}"
        f" none: B2 on the qkv buffer {ab[0]:.4f} / {ab[3]:.4f} ms, B8 on "
        f"its lane slices {ab[1]:.4f} / {ab[2]:.4f} ms; outputs "
        f"{'bit-equal' if equal else 'DIFFER'}")
    check(equal, "B2 and B8 on the same lane slices differ")

    row("layernorm", f"layernorm B={TIME_BATCH}",
        lambda: lg.layernorm_kernel(x, g, b),
        lambda: lg.layernorm(x, g, b),
        lambda: F.layer_norm(x, (d,), g.to(x.dtype), b.to(x.dtype), 1e-5),
        8.0 * m * d, 2 * m * d * 2 + 2 * d * 4, PEAK_BF16, 50)
    g16, b16 = g.to(x.dtype), b.to(x.dtype)
    log(f"[time] layernorm B={TIME_BATCH} device ms (torch.profiler, 20 "
        f"calls): kernel {device_ms(lambda: lg.layernorm_kernel(x, g, b)):.4f}"
        f", library {device_ms(lambda: F.layer_norm(x, (d,), g16, b16)):.4f}")

    z, cb = t["z"], t["codebook"]
    row("vq", f"vq B={TIME_BATCH}",
        lambda: vq.nearest_kernel(z, cb),
        lambda: vq.nearest_plain(z, cb),
        lambda: torch.cdist(z, cb).argmin(-1),
        2.0 * m * CODES * EMBED + 2.0 * CODES * EMBED,
        (m * EMBED + CODES * EMBED) * 4 + m * 4, PEAK_F32, 10)
    del t, x, qkv, q, k, v

    # attention backward at the training batch: S, dP, dV, dQ and dK,
    # five products of 2 N^2 D per (batch, head); q, k, v, dO read and
    # dq, dk, dv written
    bt = TRAIN_BATCH
    qkv = rand((bt, TOKENS, 3 * hd), gen)
    q3, k3, v3 = att.split_qkv_scaled(qkv, HEAD_DIM ** -0.5)
    do = rand((bt, TOKENS, hd), gen)
    ql, kl, vl = (u.reshape(bt, TOKENS, HEADS, HEAD_DIM).transpose(1, 2)
                  .detach().requires_grad_() for u in (q3, k3, v3))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=1.0)
    lib_do = do.reshape(bt, TOKENS, HEADS, HEAD_DIM).transpose(1, 2)
    row("attention_bwd", f"attention_bwd B={bt}",
        lambda: att.attention_bwd_kernel(q3, k3, v3, do, HEADS, HEAD_DIM),
        lambda: att.attention_bwd_plain(q3, k3, v3, do, HEADS, HEAD_DIM),
        lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_do,
                                    retain_graph=True),
        10.0 * bt * HEADS * TOKENS * TOKENS * HEAD_DIM,
        7 * bt * TOKENS * hd * 2, PEAK_BF16, 10, reps=5)
    del qkv, q3, k3, v3, do, ql, kl, vl, lib_out

    # the 12 blurs of one discriminator forward, f32: 2 flops per tap
    blur = fir.make_blur_kernel([1, 3, 3, 1])
    for shape, pad in D_BLURS:
        xb = torch.randn(shape, generator=gen, device="cuda")
        bsz, h, w, c = shape
        out_elems = bsz * (h + 2 * pad[0] - 3) * (w + 2 * pad[0] - 3) * c
        weight = torch.flip(blur, (0, 1)).cuda()[None, None].expand(
            c, 1, 4, 4)
        xn = xb.permute(0, 3, 1, 2)
        row("fir", f"fir {shape} pad {pad}",
            lambda: fir.upfirdn2d(xb, blur, pad=pad),
            lambda: fir.upfirdn2d_plain(xb, blur, 1, 1, pad),
            lambda: F.conv2d(xn, weight, padding=pad[0], groups=c),
            2.0 * 16 * out_elems, (xb.numel() + out_elems) * 4, PEAK_F32,
            20)
    del xb, xn

    # the 12 VJP blurs of one discriminator backward, f32: the kernel as
    # the backward launches it (the unflipped taps at the mirrored pads),
    # the plain version of that blur, and the library's gradient of x:
    # autograd of F.conv2d(groups=C)
    taps = blur.tolist()
    for shape, pad in D_BLURS:
        bsz, h, w, c = shape
        ho = h + 2 * pad[0] - 3
        g = torch.randn((bsz, ho, ho, c), generator=gen, device="cuda")
        vjp_pad = fir.fir_vjp_pad(pad + pad, 4, 4)
        flipped = torch.flip(blur, (0, 1))
        weight = flipped.cuda()[None, None].expand(c, 1, 4, 4)
        xn = torch.randn(shape, generator=gen, device="cuda").permute(
            0, 3, 1, 2).requires_grad_()
        lib_out = F.conv2d(xn, weight, padding=pad[0], groups=c)
        gn = g.permute(0, 3, 1, 2)
        row("fir_vjp", f"fir_vjp {shape} pad {pad}",
            lambda: fir.fir_kernel(g, taps, vjp_pad, counter="fir_vjp"),
            lambda: fir.upfirdn2d_plain(g, flipped, 1, 1, vjp_pad),
            lambda: torch.autograd.grad(lib_out, xn, gn, retain_graph=True),
            2.0 * 16 * xn.numel(), (g.numel() + xn.numel()) * 4, PEAK_F32,
            20)
    del g, xn, lib_out, gn

    # the 15 bias + leaky ReLUs of one discriminator forward, f32; no
    # single library call computes bias + leaky ReLU + gain
    for shape in D_ACTS:
        xa = torch.randn(shape, generator=gen, device="cuda")
        bias = torch.randn(shape[-1], generator=gen, device="cuda")
        row("fused_act", f"fused_act {shape}",
            lambda: fa.fused_leaky_relu(xa, bias),
            lambda: fa.fused_act_plain(xa, bias), None,
            3.0 * xa.numel(), (2 * xa.numel() + bias.numel()) * 4, PEAK_F32,
            20)
    del xa
    time_prior_kernels(gen, row)
    time_int8_kernels(gen, row)
    time_fused_kernels(gen, row)
    time_f32_kernels(gen, row)
    time_f32_ln_gemm(gen, row)
    time_f32_fusions(gen, row)
    time_wide_bwd(gen, row)
    time_rq_kernels(row)
    time_rq_slice_kernels(row)
    time_clip_attention(gen)
    return rows


def time_clip_attention(gen) -> None:
    """fp32 B8 at the ViT-L/14 CLIP towers' shapes (phase 18), batch 8,
    on lane slices of a qkv buffer as the towers give it: the text tower's
    77 causal tokens (12 heads of 64) and the vision tower's 257 tokens
    (16 heads of 64); each held to its plain version at F32_TOL (and in
    bf16 at phase 3's bf16 B8 limits), and timed beside it, SDPA fp32 (TF32
    off; both also as device time, ``torch.profiler``) and its two bounds (six bf16 products of exact pieces at 989 TFLOP/s;
    fp32 SIMT at 67). Logged only: the kernels line keeps B8's rows."""
    from enhancing_tpu_torch.ops import attention as att
    for label, n, h, mode in (("text", 77, 12, "prefix_causal"),
                              ("vision", 257, 16, "none")):
        b, d = CHECK_BATCH, HEAD_DIM
        qkv = rand((b, n, 3 * h * d), gen, torch.float32)
        q, k, v = (u.reshape(b, n, h, d) for u in qkv.split(h * d, -1))
        qt, kt, vt = (u.transpose(1, 2) for u in (q, k, v))
        causal = mode == "prefix_causal"
        pairs = b * h * (n * (n + 1) / 2 if causal else n * n)
        flops, nbytes = 4.0 * pairs * d, 4 * b * n * h * d * 4
        pieces, by = bound(6 * flops, nbytes, PEAK_BF16)
        simt = bound(flops, nbytes, PEAK_F32)[0]
        got = att.attention_bnhd_kernel(q, k, v, d ** -0.5, mode, 0)
        want = att.attention_bnhd_plain(q, k, v, d ** -0.5, mode, 0)
        worst = float(((got - want).abs() - F32_TOL["rtol"] * want.abs()
                       - F32_TOL["atol"]).max())
        log(f"[time] attention_bnhd f32 CLIP {label} vs plain: max_abs_err "
            f"{float((got - want).abs().max()):.3e} (F32_TOL) -> "
            f"{'pass' if worst <= 0 else 'FAIL'}")
        check(worst <= 0 and bool(torch.isfinite(got).all()),
              f"B8 at the CLIP {label} shape disagrees with its plain version")
        q16, k16, v16 = (u.to(torch.bfloat16) for u in (q, k, v))
        got = att.attention_bnhd_kernel(q16, k16, v16, d ** -0.5, mode, 0)
        want = att.attention_bnhd_plain(q16, k16, v16, d ** -0.5, mode, 0)
        err = (got.float() - want.float()).abs()
        worst = float((err - 2.0 ** -7 * want.float().abs() - 1e-2).max())
        log(f"[time] attention_bnhd bf16 CLIP {label} vs plain: max_abs_err "
            f"{float(err.max()):.3e} (phase 3's atol 1e-2 + rtol 2^-7) -> "
            f"{'pass' if worst <= 0 else 'FAIL'}")
        check(worst <= 0, f"bf16 B8 at the CLIP {label} shape disagrees")
        def kernel():
            return att.attention_bnhd_kernel(q, k, v, d ** -0.5, mode, 0)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=d ** -0.5)

        ms, lib = time_ms(kernel, 20), time_ms(library, 20)
        plain = time_ms(lambda: att.attention_bnhd_plain(q, k, v, d ** -0.5,
                                                         mode, 0), 3, 1)
        log(f"[time] attention_bnhd f32 CLIP {label} {mode} B={b} N={n} "
            f"H={h} D={d} (lane slices of qkv): kernel_ms {ms:.5f} "
            f"(device {device_ms(kernel):.5f}) plain_ms {plain:.5f} "
            f"library_ms {lib:.5f} (device {device_ms(library):.5f}; SDPA "
            f"fp32) bound_ms {pieces:.5f} ({by}; fp32 SIMT {simt:.5f})")
    del qkv, q, k, v, qt, kt, vt, got, want, q16, k16, v16


def kernel_names(fn) -> list:
    """The CUDA kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:70] for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def time_prior_kernels(gen, row) -> None:
    """B8-B10 at the sampler's shapes (batch 8): B8 at the teacher-forced
    full forward's N = 1025 and the prefill's N = 1, B9 at cur_len 1, 256,
    512 and 1024 (512, the mean over a sample's steps, is the row of the
    ``kernels`` line; three layers in turn, so that L2 holds none of a
    call's K and V), B10 on the prior's stack at cur_len 512."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import cache
    b, h, d, hd = SAMPLE_BATCH, P_HEADS, P_HEAD_DIM, P_WIDTH
    scale = d ** -0.5
    for n in (P_CTX, 1):
        q, k, v = (rand((b, n, h, d), gen) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, scale=scale)
        if n > 1:
            log(f"[time] SDPA is_causal at (B, H, N, D) = {(b, h, n, d)} "
                f"launches: {kernel_names(sdpa)}")
        # causal: each row i sees i + 1 keys (cond_len 1 adds none)
        pairs = b * h * n * (n + 1) / 2
        row("attention_bnhd", f"attention_bnhd prefix_causal B={b} N={n} "
            f"H={h} D={d}",
            lambda: att.attention_bnhd_kernel(q, k, v, scale,
                                              "prefix_causal", 1),
            lambda: att.attention_bnhd_plain(q, k, v, scale, "prefix_causal",
                                             1),
            sdpa, 4.0 * pairs * d, 4 * b * n * hd * 2, PEAK_BF16,
            10 if n > 1 else 50)
        del q, k, v, qt, kt, vt

    layer = 11
    layers = [layer, (layer + 7) % P_LAYERS, (layer + 14) % P_LAYERS]
    kc, vc = prior_stack(gen, 1024)
    q3 = rand((b, hd), gen, scale=scale)
    kn, vn = rand((b, hd), gen), rand((b, hd), gen)
    split = lambda t: t.view(b, -1, h, d).transpose(1, 2)  # noqa: E731
    q_l = split(q3[:, None])
    for cur in (1, 256, 512, 1024):
        k_cat = torch.cat([split(kc[layer, :, :cur]), split(kn[:, None])], 2)
        v_cat = torch.cat([split(vc[layer, :, :cur]), split(vn[:, None])], 2)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q_l, k_cat, v_cat, scale=1.0)
        kernel = cycling(lambda li: att.decode_attention_kernel(  # noqa: B023
            q3, kc, vc, kn, vn, cur, li, d), layers)
        flops, nbytes = 4.0 * b * hd * (cur + 1), (2 * b * cur * hd
                                                   + 4 * b * hd) * 2
        if cur != 512:
            ms, lib_ms = time_ms(kernel, 50), time_ms(sdpa, 50)
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
            log(f"[time] decode_attention B={b} cur_len {cur} of the "
                f"{tuple(kc.shape)} stack, 3 layers in turn: kernel_ms "
                f"{ms:.4f} library_ms {lib_ms:.4f} (SDPA on the concatenated"
                f" k, v) bound_ms {b_ms:.4f} ({b_by}); "
                f"{nbytes / ms / 1e6:.1f} GB/s")
            continue
        log(f"[time] SDPA at q (B, H, 1, D) against {tuple(k_cat.shape)} "
            f"launches: {kernel_names(sdpa)}")
        row("decode_attention", f"decode_attention B={b} cur_len {cur} of "
            f"the {tuple(kc.shape)} stack, 3 layers in turn (SDPA on the "
            "concatenated k, v: concatenation not timed)", kernel,
            lambda: att.decode_attention_plain(q3, kc[layer], vc[layer], kn,
                                               vn, cur, d),
            sdpa, flops, nbytes, PEAK_BF16, 50)
    del k_cat, v_cat

    cur = 512
    news = rand((P_LAYERS, b, 1, hd), gen)
    rows_b = torch.arange(b, device="cuda")
    cur_b = torch.full((b,), cur, device="cuda")
    row("cache_row_update", f"cache_row_update {tuple(kc.shape)} cur_len "
        f"{cur} (library: cache[:, arange(B), cur] = news)",
        lambda: cache.cache_row_update_kernel(kc, news, cur),
        lambda: cache.cache_row_update_plain(kc, news, cur),
        lambda: kc.__setitem__((slice(None), rows_b, cur_b), news[:, :, 0]),
        0.0, 2 * news.numel() * 2, PEAK_BF16, 50, graph=True)


def time_rq_kernels(row) -> None:
    """B8-B10 at the RQ prior's sampling shapes (batch 8, heads of 96 over
    its width of 1536), on a generator of their own: B8 at the
    teacher-forced forward's N = 1025 and the spatial prefill's N = 1 (the
    128 tile), B9 at cur_len 512 on its (24, 8, 1032, 1536) stack (three
    layers in turn), B10 on that stack at cur_len 512 (also by
    CUDA-graph replay)."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import cache
    gen = torch.Generator(device="cuda").manual_seed(22)
    b, h, d, hd = SAMPLE_BATCH, RQ_HEADS, RQ_HEAD_DIM, RQ_WIDTH
    scale = d ** -0.5
    for n in (P_CTX, 1):
        q, k, v = (rand((b, n, h, d), gen) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = b * h * n * (n + 1) / 2
        row("attention_bnhd", f"attention_bnhd prefix_causal B={b} N={n} "
            f"H={h} D={d} (the RQ prior)",
            lambda: att.attention_bnhd_kernel(q, k, v, scale,
                                              "prefix_causal", 1),
            lambda: att.attention_bnhd_plain(q, k, v, scale, "prefix_causal",
                                             1),
            lambda: F.scaled_dot_product_attention(  # noqa: B023
                qt, kt, vt, is_causal=True, scale=scale),
            4.0 * pairs * d, 4 * b * n * hd * 2, PEAK_BF16,
            10 if n > 1 else 50)
        del q, k, v, qt, kt, vt
    layers = [3, 10, 17]
    cur = 512
    kc, vc = prior_stack(gen, 1024, RQ_WIDTH)
    q3 = rand((b, hd), gen, scale=scale)
    kn, vn = rand((b, hd), gen), rand((b, hd), gen)
    split = lambda t: t.view(b, -1, h, d).transpose(1, 2)  # noqa: E731
    k_cat = torch.cat([split(kc[layers[0], :, :cur]), split(kn[:, None])], 2)
    v_cat = torch.cat([split(vc[layers[0], :, :cur]), split(vn[:, None])], 2)
    q_l = split(q3[:, None])
    row("decode_attention", f"decode_attention B={b} D={d} cur_len {cur} of "
        f"the {tuple(kc.shape)} stack (the RQ prior), 3 layers in turn",
        cycling(lambda li: att.decode_attention_kernel(
            q3, kc, vc, kn, vn, cur, li, d), layers),
        lambda: att.decode_attention_plain(q3, kc[layers[0]], vc[layers[0]],
                                           kn, vn, cur, d),
        lambda: F.scaled_dot_product_attention(q_l, k_cat, v_cat, scale=1.0),
        4.0 * b * hd * (cur + 1), (2 * b * cur * hd + 4 * b * hd) * 2,
        PEAK_BF16, 50)
    del k_cat, v_cat, vc
    news = rand((P_LAYERS, b, 1, hd), gen)
    rows_b = torch.arange(b, device="cuda")
    cur_b = torch.full((b,), cur, device="cuda")
    row("cache_row_update", f"cache_row_update {tuple(kc.shape)} cur_len "
        f"{cur} (the RQ prior; library: cache[:, arange(B), cur] = news)",
        lambda: cache.cache_row_update_kernel(kc, news, cur),
        lambda: cache.cache_row_update_plain(kc, news, cur),
        lambda: kc.__setitem__((slice(None), rows_b, cur_b), news[:, :, 0]),
        0.0, 2 * news.numel() * 2, PEAK_BF16, 50, graph=True)


# calls of the attention forwards at the priors' training shapes that must
# give the same bits as the first: attn_f32_wide_kernel once read a ring
# stage before its load had landed, in about one call of 200
REPEAT_CALLS = 300


def compare_repeats() -> None:
    """B8 at the priors' training shapes, each REPEAT_CALLS times on the
    same inputs (a generator of its own): every call's output equal to the
    first bit for bit. fp32 and bf16 at the GPT prior's (4, 1025, 16, 384)
    and the RQ prior's (4, 1025, 16, 96), prefix-causal with cond_len 1."""
    from enhancing_tpu_torch.ops import attention as att
    gen = torch.Generator(device="cuda").manual_seed(25)
    for d, h in ((P_HEAD_DIM, P_HEADS), (RQ_HEAD_DIM, RQ_HEADS)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (rand((PRIOR_TRAIN_BATCH, P_CTX, h, d), gen, dtype)
                       for _ in range(3))
            first = att.attention_bnhd_kernel(q, k, v, d ** -0.5,
                                              "prefix_causal", 1)
            differ = sum(not torch.equal(first, att.attention_bnhd_kernel(
                q, k, v, d ** -0.5, "prefix_causal", 1))
                for _ in range(REPEAT_CALLS))
            label = (f"attention_bnhd {str(dtype)[6:]} prefix_causal B="
                     f"{PRIOR_TRAIN_BATCH} N={P_CTX} H={h} D={d}")
            verdict = "FAIL" if differ else "pass"
            log(f"[compare] {label}: {differ} of {REPEAT_CALLS} calls differ "
                f"from the first (tol 0) -> {verdict}")
            check(not differ, f"{label}: calls on the same inputs differ")
            del q, k, v, first


def compare_rq_slice_kernels(close) -> None:
    """The kernels at the shapes the RQ prior's training (phase 15) and int8
    serving (phase 14 (d)) give them, against their plain versions at
    phase 3's limits, on a generator of their own: B5 at the training
    batch's (4, 1025, 16, 96), prefix-causal with cond_len 1, bf16 and fp32
    (:func:`hold_bwd`); B8 at that shape in fp32; B9 at D = 96 on the
    (24, 8, 1152, 1536) int8 cache, fp32 and bf16 q; B10's int8 rows into
    that cache; B12 (qkv and proj), B13 (qkv with the shift) and B14 at
    width 1536."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import cache, int8
    gen = torch.Generator(device="cuda").manual_seed(23)
    b, n, h, d = RQ_TRAIN_BATCH, P_CTX, RQ_HEADS, RQ_HEAD_DIM
    for dtype, name in ((torch.bfloat16, "attention_bwd"),
                        (torch.float32, "attention_bwd_f32")):
        hold_bwd(gen, close, name, dtype, b, n, h, d, "prefix_causal", 1)
    q, k, v = (rand((b, n, h, d), gen, torch.float32) for _ in range(3))
    close("attention_bnhd_f32", f"attention_bnhd f32 prefix_causal cond_len "
          f"1 B={b} N={n} H={h} D={d} (the RQ prior's training)",
          att.attention_bnhd_kernel(q, k, v, d ** -0.5, "prefix_causal", 1),
          att.attention_bnhd_plain(q, k, v, d ** -0.5, "prefix_causal", 1),
          **F32_TOL)
    del q, k, v
    gc_cuda()

    ragged = torch.tensor([1, 100, 255, 256, 511, 513, 900, 1024],
                          dtype=torch.int32, device="cuda")
    compare_decode_pairs(gen, close, ragged, RQ_WIDTH, d, RQ_INT8_CTX, 5,
                         DECODE_PAIRS[1:])
    shape = (RQ_LAYERS, SAMPLE_BATCH, RQ_INT8_CTX, RQ_WIDTH)
    stack = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
    news = torch.randint(-127, 128, shape[:2] + (1, RQ_WIDTH), generator=gen,
                         device="cuda", dtype=torch.int8)
    outside = torch.tensor([-3, 0, 1, 513, RQ_INT8_CTX, RQ_INT8_CTX + 9,
                            1024, 1031], dtype=torch.int32, device="cuda")
    for cur, label in ((513, 513), (ragged, "ragged"),
                       (outside, "ragged, rows outside [0, ctx)")):
        want = cache.cache_row_update_plain(stack.clone(), news, cur)
        got = cache.cache_row_update_kernel(stack, news, cur)
        close("cache_row_update", f"cache_row_update int8 {shape} cur_len "
              f"{label} (the RQ prior)", got, want, atol=0.0, rtol=0.0)
        del want
    del stack, news

    t = prior_int8_inputs(gen, RQ_WIDTH)
    x, x16 = t["x"], t["x16"]
    c = RQ_WIDTH

    def line(name, label, got, want, bf16=False):
        close(name, label + " (the RQ prior)", got, want,
              **own_limits(want, bf16))

    line("int8_gemm", f"int8_gemm prefill qkv bf16 x (8, {c}) -> {3 * c}",
         int8.int8_gemm_kernel(x16, t["qkv_q"], t["qkv_s"], t["qkv_b"]),
         int8.int8_gemm_plain(x16, t["qkv_q"], t["qkv_s"], t["qkv_b"]),
         bf16=True)
    line("int8_gemm", f"int8_gemm decode proj f32 x (8, {c}) -> {c}",
         int8.int8_gemm_kernel(x, t["proj_q"], t["proj_s"], t["proj_b"]),
         int8.int8_gemm_plain(x, t["proj_q"], t["proj_s"], t["proj_b"]))
    args = (x, t["gamma"], t["beta"], t["tm"], t["prev"], t["qkv_q"],
            t["qkv_s"], t["qkv_b"])
    got, got_xn = int8.int8_ln_gemm_kernel(*args)
    want, want_xn = int8.int8_ln_gemm_plain(*args)
    label = f"int8_ln_gemm qkv with shift f32 x (8, {c}) -> {3 * c}"
    line("int8_ln_gemm", label, got, want)
    line("int8_ln_gemm", label + ", LN(x)", got_xn, want_xn)
    mlp = (x, t["gamma"], t["beta"], t["p0_q"], t["p0_s"], t["p0_b"],
           t["p1_q"], t["p1_s"], t["p1_b"], x)
    line("int8_mlp", f"int8_mlp f32 x (8, {c}), hidden {4 * c}",
         int8.int8_mlp_kernel(*mlp), int8.int8_mlp_plain(*mlp))
    del t, mlp, got, want, got_xn, want_xn
    gc_cuda()


def time_rq_slice_kernels(row) -> None:
    """The kernels at the RQ prior's training and int8 serving shapes (those
    of :func:`compare_rq_slice_kernels`), on a generator of their own: B5
    bf16 and fp32 (:func:`time_bwd`), fp32 B8 (library: fp32 SDPA
    ``is_causal``), B9 at cur_len 512 of the int8 cache with fp32 and bf16
    q, three layers in turn (library: SDPA on the cache dequantised and
    concatenated beforehand, neither timed), B10's int8 rows (also by
    CUDA-graph replay), B12-B14 (library: F.linear on the weights
    dequantised beforehand; B14 F.linear, squared ReLU, F.linear)."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import cache, int8
    gen = torch.Generator(device="cuda").manual_seed(24)
    b, n, h, d = RQ_TRAIN_BATCH, P_CTX, RQ_HEADS, RQ_HEAD_DIM
    c = RQ_WIDTH
    for dtype, name, iters in ((torch.bfloat16, "attention_bwd", 10),
                               (torch.float32, "attention_bwd_f32", 5)):
        time_bwd(gen, row, name, dtype, b, n, h, d, iters)
    q, k, v = (rand((b, n, h, d), gen, torch.float32) for _ in range(3))
    qt, kt, vt = (u.transpose(1, 2) for u in (q, k, v))
    pairs = b * h * n * (n + 1) / 2
    row("attention_bnhd_f32", f"attention_bnhd f32 prefix_causal B={b} N={n} "
        f"H={h} D={d} (the RQ prior's training; library: SDPA fp32 "
        "is_causal)",
        lambda: att.attention_bnhd_kernel(q, k, v, d ** -0.5,
                                          "prefix_causal", 1),
        lambda: att.attention_bnhd_plain(q, k, v, d ** -0.5, "prefix_causal",
                                         1),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               scale=d ** -0.5),
        4.0 * pairs * d, 4 * b * n * c * 4, PEAK_F32, 10)
    del q, k, v, qt, kt, vt
    gc_cuda()

    bs, cur, layers = SAMPLE_BATCH, 512, [3, 10, 17]
    kc, vc = prior_stack(gen, 1024, c, RQ_INT8_CTX)
    k8, ks = int8.quantize_channelwise(kc)
    v8, vs = int8.quantize_channelwise(vc)
    del kc, vc
    split = lambda u: u.view(bs, -1, h, d).transpose(1, 2)  # noqa: E731
    for q_dtype, peak in ((torch.float32, PEAK_F32),
                          (torch.bfloat16, PEAK_BF16)):
        q3 = rand((bs, c), gen, q_dtype, d ** -0.5)
        kn, vn = (rand((bs, c), gen, q_dtype) for _ in range(2))
        kd, vd = att.dequant_cache(k8[layers[0], :, :cur],
                                   v8[layers[0], :, :cur],
                                   ks[layers[0], :, :cur],
                                   vs[layers[0], :, :cur], q_dtype)
        k_cat = torch.cat([split(kd), split(kn[:, None])], 2)
        v_cat = torch.cat([split(vd), split(vn[:, None])], 2)
        q_l = split(q3[:, None])
        size = q_dtype.itemsize
        row("decode_attention", f"decode_attention int8 cache, "
            f"{str(q_dtype)[6:]} q, B={bs} D={d} cur_len {cur} of the "
            f"{tuple(k8.shape)} stack (the RQ prior), 3 layers in turn (SDPA"
            " on the dequantised, concatenated k, v: neither timed)",
            cycling(lambda li: att.decode_attention_kernel(  # noqa: B023
                q3, k8, v8, kn, vn, cur, li, d, ks, vs), layers),
            lambda: att.decode_attention_plain(  # noqa: B023
                q3, *att.dequant_cache(k8[layers[0]], v8[layers[0]],
                                       ks[layers[0]], vs[layers[0]],
                                       q_dtype), kn, vn, cur, d),
            lambda: F.scaled_dot_product_attention(  # noqa: B023
                q_l, k_cat, v_cat, scale=1.0),
            4.0 * bs * c * (cur + 1),
            2 * bs * cur * c + 2 * bs * cur * 4 + 4 * bs * c * size, peak, 50)
        del kd, vd, k_cat, v_cat
    news = torch.randint(-127, 128, (RQ_LAYERS, bs, 1, c), generator=gen,
                         device="cuda", dtype=torch.int8)
    rows_b = torch.arange(bs, device="cuda")
    cur_b = torch.full((bs,), cur, device="cuda")
    row("cache_row_update", f"cache_row_update int8 {tuple(k8.shape)} "
        f"cur_len {cur} (the RQ prior; library: cache[:, arange(B), cur] = "
        "news)",
        lambda: cache.cache_row_update_kernel(k8, news, cur),
        lambda: cache.cache_row_update_plain(k8, news, cur),
        lambda: k8.__setitem__((slice(None), rows_b, cur_b), news[:, :, 0]),
        0.0, 2 * news.numel(), PEAK_BF16, 50, graph=True)
    del k8, v8, ks, vs, news
    gc_cuda()

    t = prior_int8_inputs(gen, c)
    x, x16 = t["x"], t["x16"]
    f4, h2 = bs * c * 4, bs * c * 2  # an fp32 / bf16 (8, 1536) activation

    def deq(name, dtype):
        return (t[name + "_q"].float() * t[name + "_s"][:, None]).to(dtype)

    copies = [(t["proj_q"].clone(), t["proj_s"].clone()) for _ in range(3)]
    w32 = deq("proj", torch.float32)
    row("int8_gemm", f"int8_gemm decode proj f32 x (8, {c}) -> {c} (the RQ "
        "prior; 3 weight copies in turn)",
        cycling(lambda w: int8.int8_gemm_kernel(x, w[0], w[1], t["proj_b"]),
                copies),
        lambda: int8.int8_gemm_plain(x, t["proj_q"], t["proj_s"],
                                     t["proj_b"]),
        lambda: F.linear(x, w32, t["proj_b"].float()),
        2.0 * bs * c * c, 2 * f4 + c * c + c * 6, PEAK_F32, 50)
    w16 = deq("qkv", torch.bfloat16)
    row("int8_gemm", f"int8_gemm prefill qkv bf16 x (8, {c}) -> {3 * c} (the"
        " RQ prior)",
        lambda: int8.int8_gemm_kernel(x16, t["qkv_q"], t["qkv_s"],
                                      t["qkv_b"]),
        lambda: int8.int8_gemm_plain(x16, t["qkv_q"], t["qkv_s"], t["qkv_b"]),
        lambda: F.linear(x16, w16, t["qkv_b"]),
        2.0 * bs * c * 3 * c, h2 * 4 + 3 * c * c + 3 * c * 6, PEAK_F32, 50)
    w32 = deq("qkv", torch.float32)
    row("int8_ln_gemm", f"int8_ln_gemm decode qkv + shift f32 x (8, {c}) -> "
        f"{3 * c} (the RQ prior)",
        lambda: int8.int8_ln_gemm_kernel(x, t["gamma"], t["beta"], t["tm"],
                                         t["prev"], t["qkv_q"], t["qkv_s"],
                                         t["qkv_b"]),
        lambda: int8.int8_ln_gemm_plain(x, t["gamma"], t["beta"], t["tm"],
                                        t["prev"], t["qkv_q"], t["qkv_s"],
                                        t["qkv_b"]),
        lambda: F.linear(x, w32, t["qkv_b"].float()),
        2.0 * bs * c * 3 * c,
        2 * f4 + 3 * c * 4 + h2 + 3 * c * c + 3 * c * 6 + 3 * f4, PEAK_F32,
        50)
    mlp = (x, t["gamma"], t["beta"], t["p0_q"], t["p0_s"], t["p0_b"],
           t["p1_q"], t["p1_s"], t["p1_b"], x)
    w0, w1 = deq("p0", torch.float32), deq("p1", torch.float32)
    b0, b1 = t["p0_b"].float(), t["p1_b"].float()
    row("int8_mlp", f"int8_mlp f32 x (8, {c}), hidden {4 * c} (the RQ prior;"
        " library: F.linear, squared ReLU, F.linear on the dequantised "
        "weights)",
        lambda: int8.int8_mlp_kernel(*mlp), lambda: int8.int8_mlp_plain(*mlp),
        lambda: F.linear(torch.square(torch.relu(F.linear(x, w0, b0))), w1,
                         b1),
        4.0 * bs * c * 4 * c,
        2 * f4 + 2 * c * 4 + 8 * c * c + 4 * c * 6 + c * 6, PEAK_F32, 50)
    ln_gemm = (x, t["gamma"], t["beta"], t["tm"], t["prev"], t["qkv_q"],
               t["qkv_s"], t["qkv_b"])
    dev = {"proj": device_ms(lambda: int8.int8_gemm_kernel(
               x, t["proj_q"], t["proj_s"], t["proj_b"])),
           "qkv + shift": device_ms(
               lambda: int8.int8_ln_gemm_kernel(*ln_gemm)),
           "mlp": device_ms(lambda: int8.int8_mlp_kernel(*mlp))}
    log("[time] the RQ prior's int8 decode calls, device ms (torch.profiler,"
        " 20 calls): " + ", ".join(f"{k} {v:.4f}" for k, v in dev.items()))
    del t, mlp, copies, w32, w16, w0, w1
    gc_cuda()


def cycling(fn, copies):
    """A call of ``fn`` on the next of ``copies`` in turn: weights that fit
    the 50 MB L2 cache are then read from device memory, as a decode
    step's layers find them."""
    state = {"i": 0}

    def call():
        state["i"] = (state["i"] + 1) % len(copies)
        return fn(copies[state["i"]])
    return call


def time_int8_kernels(gen, row) -> None:
    """B11-B14 and B9 over an int8 cache at the int8 decode step's shapes
    (batch 8, the prior's widths), fp32 x as the step gives it (B12 also at
    the prefill's bf16 qkv). Library: one F.linear on the weight
    dequantised beforehand, in x's dtype (dequantisation, LayerNorm and
    shift not timed)."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import int8
    from enhancing_tpu_torch.ops import ln_gemm as lg
    t = prior_int8_inputs(gen)
    b, c = SAMPLE_BATCH, P_WIDTH
    x, x16, g, bt, tm, prev = (t[k] for k in ("x", "x16", "gamma", "beta",
                                              "tm", "prev"))
    f4, h2 = b * c * 4, b * c * 2  # an fp32 / bf16 (8, 6144) activation

    def deq(name, dtype):
        return (t[name + "_q"].float() * t[name + "_s"][:, None]).to(dtype)

    try:
        torch._weight_int8pack_mm(x16, t["proj_q"], t["proj_s"].to(x16.dtype))
        torch.cuda.synchronize()
        packed = time_ms(lambda: torch._weight_int8pack_mm(
            x16, t["proj_q"], t["proj_s"].to(x16.dtype)), 50)
        log(f"[time] torch._weight_int8pack_mm bf16 x (8, 6144) -> 6144: "
            f"{packed:.4f} ms")
    except (RuntimeError, NotImplementedError) as exc:
        log(f"[time] torch._weight_int8pack_mm does not run on CUDA here: "
            f"{str(exc).splitlines()[0][:120]}")

    dev = []  # device ms of B12 and B13 (torch.profiler, 20 calls)
    copies = [(t["proj_q"].clone(), t["proj_s"].clone()) for _ in range(3)]
    w32 = deq("proj", torch.float32)
    proj = cycling(lambda w: int8.int8_gemm_kernel(x, w[0], w[1],
                                                   t["proj_b"]), copies)
    dev.append(("proj f32", device_ms(proj)))
    row("int8_gemm", "int8_gemm decode proj f32 x (8, 6144) -> 6144 (3 "
        "weight copies in turn)",
        proj,
        lambda: int8.int8_gemm_plain(x, t["proj_q"], t["proj_s"],
                                     t["proj_b"]),
        lambda: F.linear(x, w32, t["proj_b"].float()),
        2.0 * b * c * c, 2 * f4 + c * c + c * 6, PEAK_F32, 50)
    del copies, w32
    w16 = deq("qkv", torch.bfloat16)
    dev.append(("prefill qkv bf16", device_ms(
        lambda: int8.int8_gemm_kernel(x16, t["qkv_q"], t["qkv_s"],
                                      t["qkv_b"]))))
    row("int8_gemm", "int8_gemm prefill qkv bf16 x (8, 6144) -> 18432",
        lambda: int8.int8_gemm_kernel(x16, t["qkv_q"], t["qkv_s"],
                                      t["qkv_b"]),
        lambda: int8.int8_gemm_plain(x16, t["qkv_q"], t["qkv_s"], t["qkv_b"]),
        lambda: F.linear(x16, w16, t["qkv_b"]),
        2.0 * b * c * 3 * c, h2 * 4 + 3 * c * c + 3 * c * 6, PEAK_F32, 30)
    del w16
    w32 = deq("qkv", torch.float32)
    dev.append(("qkv + shift f32", device_ms(
        lambda: int8.int8_ln_gemm_kernel(x, g, bt, tm, prev, t["qkv_q"],
                                         t["qkv_s"], t["qkv_b"]))))
    row("int8_ln_gemm", "int8_ln_gemm decode qkv + shift f32 x (8, 6144) -> "
        "18432",
        lambda: int8.int8_ln_gemm_kernel(x, g, bt, tm, prev, t["qkv_q"],
                                         t["qkv_s"], t["qkv_b"]),
        lambda: int8.int8_ln_gemm_plain(x, g, bt, tm, prev, t["qkv_q"],
                                        t["qkv_s"], t["qkv_b"]),
        lambda: F.linear(x, w32, t["qkv_b"].float()),
        2.0 * b * c * 3 * c,
        2 * f4 + 3 * c * 4 + h2 + 3 * c * c + 3 * c * 6 + 3 * f4, PEAK_F32,
        30)
    del w32
    copies = [(t["head_q"].clone(), t["head_s"].clone()) for _ in range(3)]
    w32 = deq("head", torch.float32)
    head = cycling(lambda w: int8.int8_ln_gemm_kernel(x, g, bt, None, None,
                                                      w[0], w[1]), copies)
    dev.append(("head f32", device_ms(head)))
    log("[time] int8_gemm, int8_ln_gemm device ms (torch.profiler, 20 "
        "calls): " + ", ".join(f"{k} {v:.4f}" for k, v in dev))
    row("int8_ln_gemm", "int8_ln_gemm vocab head f32 x (8, 6144) -> 8192 (3 "
        "weight copies in turn)",
        head,
        lambda: int8.int8_ln_gemm_plain(x, g, bt, None, None, t["head_q"],
                                        t["head_s"]),
        lambda: F.linear(x, w32),
        2.0 * b * c * P_VOCAB,
        2 * f4 + 2 * c * 4 + P_VOCAB * c + P_VOCAB * 4 + b * P_VOCAB * 4,
        PEAK_F32, 50)
    del copies, w32
    mlp = (x, g, bt, t["p0_q"], t["p0_s"], t["p0_b"], t["p1_q"], t["p1_s"],
           t["p1_b"], x)
    w0, w1 = deq("p0", torch.float32), deq("p1", torch.float32)
    b0, b1 = t["p0_b"].float(), t["p1_b"].float()
    row("int8_mlp", "int8_mlp f32 x (8, 6144), hidden 24576 (library: "
        "F.linear, squared ReLU, F.linear on the dequantised weights)",
        lambda: int8.int8_mlp_kernel(*mlp), lambda: int8.int8_mlp_plain(*mlp),
        lambda: F.linear(torch.square(torch.relu(F.linear(x, w0, b0))), w1,
                         b1),
        4.0 * b * c * 4 * c,
        2 * f4 + 2 * c * 4 + 8 * c * c + 4 * c * 6 + c * 6, PEAK_F32, 20)
    mlp16 = (x16,) + mlp[1:]
    log("[time] int8_mlp device ms (torch.profiler, 20 calls): f32 x "
        f"{device_ms(lambda: int8.int8_mlp_kernel(*mlp)):.4f}, bf16 x "
        f"{device_ms(lambda: int8.int8_mlp_kernel(*mlp16)):.4f}; bf16 x by "
        f"events {time_ms(lambda: int8.int8_mlp_kernel(*mlp16), 20):.4f}")
    del w0, w1, mlp
    w32 = t["qkv"].float()
    row("ln_shift_gemm", "ln_shift_gemm LNFUSE qkv f32 x (8, 6144), bf16 W "
        "-> 18432",
        lambda: lg.ln_shift_gemm_kernel(x, g, bt, tm, prev, t["qkv"],
                                        t["qkv_b"]),
        lambda: lg.ln_shift_gemm_plain(x, g, bt, tm, prev, t["qkv"],
                                       t["qkv_b"]),
        lambda: F.linear(x, w32, t["qkv_b"].float()),
        2.0 * b * c * 3 * c,
        2 * f4 + 3 * c * 4 + h2 + 6 * c * c + 3 * c * 2 + 3 * f4, PEAK_F32,
        30)
    del w32
    # B11 by device time, and fp32 B1 at the LNFUSE mlp and head sites on
    # the bf16 weights as stored (the decode route: B11's kernel without
    # the shift), two weight copies in turn, beside each call's bound (the
    # bf16 weight bytes)
    qkv = cycling(lambda w: lg.ln_shift_gemm_kernel(x, g, bt, tm, prev, w,
                                                    t["qkv_b"]),
                  [t["qkv"], t["qkv"].clone()])
    dev = [("ln_shift_gemm qkv", device_ms(qkv), 3 * c * c * 2)]
    for label, w, bias, act in (("mlp p0 sqrelu", t["p0"], t["p0_b"],
                                 "sqrelu"), ("head", t["head"], None, None)):
        b32 = None if bias is None else bias.float()
        call = cycling(lambda wk: lg.ln_gemm_kernel(  # noqa: B023
            x, g, bt, wk, b32, act), [w, w.clone()])  # noqa: B023
        dev.append((f"ln_gemm LNFUSE {label}", device_ms(call),
                    w.numel() * 2))
    log("[time] LNFUSE decode calls f32 x (8, 6144), bf16 W, device ms "
        "(torch.profiler, 20 calls, two weight copies in turn): "
        + ", ".join(f"{k} {v:.4f} (bound {nb / PEAK_BYTES * 1e3:.4f}, "
                    f"{nb / PEAK_BYTES * 1e3 / v:.0%})"
                    for k, v, nb in dev))
    del qkv, t

    # B9 over an int8 cache, fp32 q (the int8 decode step), at cur_len 1,
    # 256, 512 and 1024; 512 is the row of the kernels line
    layer, d = 11, P_HEAD_DIM
    kc, vc = prior_stack(gen, 1024)
    k8, ks = int8.quantize_channelwise(kc)
    v8, vs = int8.quantize_channelwise(vc)
    del kc, vc
    q3 = torch.randn((b, c), generator=gen, device="cuda") * d ** -0.5
    kn, vn = (torch.randn((b, c), generator=gen, device="cuda")
              for _ in range(2))
    split = lambda u: u.view(b, -1, P_HEADS, d).transpose(1, 2)  # noqa: E731
    q_l = split(q3[:, None])
    layers = [layer, (layer + 7) % P_LAYERS, (layer + 14) % P_LAYERS]
    for cur in (1, 256, 512, 1024):
        kd, vd = att.dequant_cache(k8[layer, :, :cur], v8[layer, :, :cur],
                                   ks[layer, :, :cur], vs[layer, :, :cur],
                                   torch.float32)
        k_cat = torch.cat([split(kd), split(kn[:, None])], 2)
        v_cat = torch.cat([split(vd), split(vn[:, None])], 2)
        del kd, vd
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q_l, k_cat, v_cat, scale=1.0)
        kernel = cycling(lambda li: att.decode_attention_kernel(  # noqa: B023
            q3, k8, v8, kn, vn, cur, li, d, ks, vs), layers)
        flops, nbytes = 4.0 * b * c * (cur + 1), (2 * b * cur * c
                                                  + 2 * b * cur * 4 + 4 * f4)
        if cur != 512:
            ms, lib_ms = time_ms(kernel, 50), time_ms(sdpa, 50)
            b_ms, b_by = bound(flops, nbytes, PEAK_F32)
            log(f"[time] decode_attention int8 cache, f32 q, B={b} cur_len "
                f"{cur}, 3 layers in turn: kernel_ms {ms:.4f} library_ms "
                f"{lib_ms:.4f} (SDPA on the dequantised, concatenated k, v)"
                f" bound_ms {b_ms:.4f} ({b_by}); {nbytes / ms / 1e6:.1f} "
                "GB/s")
            continue
        row("decode_attention", f"decode_attention int8 cache, f32 q, B={b} "
            f"cur_len {cur} of the {tuple(k8.shape)} stack, 3 layers in turn "
            "(SDPA on the dequantised, concatenated k, v: neither timed)",
            kernel,
            lambda: att.decode_attention_plain(
                q3, *att.dequant_cache(k8[layer], v8[layer], ks[layer],
                                       vs[layer], torch.float32), kn, vn,
                cur, d),
            sdpa, flops, nbytes, PEAK_F32, 50)
    del k8, v8, ks, vs, k_cat, v_cat


def proj_inputs(gen, b, n, heads, ho):
    """B15's operands: the lane slices of a bf16 (B, N, 3 * H * 64) qkv
    buffer as (B, N, H, 64) views, a Xavier-scaled bf16 to_out weight
    (HO, H * 64), an fp32 bias and a bf16 residual."""
    hd = heads * HEAD_DIM
    qkv = rand((b, n, 3 * hd), gen)
    q, k, v = (t.unflatten(-1, (heads, HEAD_DIM)) for t in qkv.chunk(3, -1))
    wp = rand((ho, hd), gen, scale=(2.0 / (hd + ho)) ** 0.5)
    bp = 0.02 * torch.randn(ho, generator=gen, device="cuda")
    return q, k, v, wp, bp, rand((b, n, ho), gen)


def ffn_inputs(gen, m, d, h, dtype=torch.bfloat16):
    """B16's operands: x (m, d), Xavier-scaled fc1 (h, d) and fc2 (d, h)
    weights in ``dtype``, fp32 biases."""
    scale = (2.0 / (d + h)) ** 0.5
    return (rand((m, d), gen, dtype), rand((h, d), gen, dtype, scale),
            0.02 * torch.randn(h, generator=gen, device="cuda"),
            rand((d, h), gen, dtype, scale),
            0.02 * torch.randn(d, generator=gen, device="cuda"))


def compare_fused_kernels(gen, close, errs) -> None:
    """B15-B19 against their plain versions: B15 and B16 at the fused
    round trip's Base shapes (batch 8), a ragged prefix-causal case and
    imagenet_vitvq_large's decoder widths; B17 and B18 at ViT-Base's
    attention shape and at M != N; B19 at the stage-2 training shape."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import ffn
    # B15 and B16: bf16 outputs of O(1) (the residual; the FFN), each side
    # rounding its fp32 sum once; the attention tile's P rounds against the
    # running row max in the kernel, which moves a projected output by
    # ~1e-4 (768 terms of weights ~0.04). One bf16 step of each element
    # (rtol 2^-7) + 2^-8 of its row's largest |plain| (row_atol)
    for (b, n, heads, ho, mode, cl) in (
            (CHECK_BATCH, TOKENS, HEADS, WIDTH, "none", 0),
            (2, TOKENS + 1, HEADS, WIDTH, "prefix_causal", 5),
            (1, TOKENS, 16, 1280, "none", 0)):
        q, k, v, wp, bp, res = proj_inputs(gen, b, n, heads, ho)
        scale = HEAD_DIM ** -0.5
        got = att.attn_proj_kernel(q, k, v, wp, bp, res, scale, mode, cl)
        want = att.attention_proj_plain(q, k, v, wp, bp, res, scale, mode,
                                        cl).view(-1, ho)
        close("attn_proj", f"attn_proj {mode} B={b} N={n} H={heads} D=64 "
              f"HO={ho} (lane slices of qkv)", got.view(-1, ho), want,
              atol=row_atol(want, 2.0 ** -8), rtol=2.0 ** -7)
    # the cluster plans (ops/ffn.py::ffn_plan): C = 4 with two group
    # buffers, 8, 2, 1, 4 with one buffer, 2 with 160-column slabs; h = 3008
    # leaves the last group of 4 chunks short
    for (m, d, h, act) in ((CHECK_BATCH * TOKENS, WIDTH, MLP, "tanh"),
                           (1000, 1280, 5120, "tanh"),
                           (1000, 512, 2048, "gelu"),
                           (333, 64, 128, "sqrelu"),
                           (1000, 1024, 4096, "gelu"),
                           (300, 320, 640, "tanh"),
                           (129, WIDTH, 3008, "tanh")):
        args = ffn_inputs(gen, m, d, h)
        want = ffn.ffn_plain(*args, act)
        close("ffn", f"ffn {act} M={m} d={d} h={h}",
              ffn.ffn_kernel(*args, act), want,
              atol=row_atol(want, 2.0 ** -8), rtol=2.0 ** -7)

    # B17-B19: as B2 and B8, P rounds to bf16 against the running row max
    atol_att = dict(atol=1e-2, rtol=2.0 ** -7)
    for (b, h, n, m, mode, cl) in (
            (CHECK_BATCH, HEADS, TOKENS, TOKENS, "none", 0),
            (2, 4, 300, 517, "prefix_causal", 5),
            (2, 4, 517, 300, "none", 0),
            (2, 4, 1, 65, "none", 0),
            (2, 4, 65, 1, "prefix_causal", 0),
            (1, 4, 65, 130, "prefix_causal", 2)):
        q = rand((b, h, n, HEAD_DIM), gen)
        k, v = (rand((b, h, m, HEAD_DIM), gen) for _ in range(2))
        close("attention_bhnd", f"attention_bhnd (B, H, N, D) {mode} B={b} "
              f"H={h} N={n} M={m} D=64",
              att.attention_bhnd_kernel(q, k, v, 0.125, mode, cl),
              att.attention_plain(q, k, v, 0.125, mode, cl), **atol_att)
    for (b, n, h, mode, cl) in ((CHECK_BATCH, TOKENS, HEADS, "none", 0),
                                (2, TOKENS + 1, 4, "prefix_causal", 9)):
        q, k, v = (rand((b, n, h, HEAD_DIM), gen) for _ in range(3))
        close("attention_fused_bnhd", f"attention_fused_bnhd (B, N, H, D) "
              f"{mode} B={b} N={n} H={h} D=64",
              att.attention_strided_kernel("attention_fused_bnhd", q, k, v,
                                           0.125, mode, cl,
                                           score_scale=True),
              att.attention_fused_bnhd_plain(q, k, v, 0.125, mode, cl),
              **atol_att)
    for cl in (1, 100):
        q3 = rand((SAMPLE_BATCH, TOKENS + 1, 16 * HEAD_DIM), gen, scale=0.125)
        k3, v3 = (rand(q3.shape, gen) for _ in range(2))
        close("attention_gridchunk", f"attention_gridchunk prefix_causal "
              f"cond_len {cl} B=8 H=16 N=1025 D=64 (packed, q pre-scaled)",
              att.attention_packed_gridchunk(q3, k3, v3, "prefix_causal", cl,
                                             HEAD_DIM),
              att.attention_packed_plain(q3, k3, v3, "prefix_causal", cl,
                                         HEAD_DIM), **atol_att)


def time_fused_kernels(gen, row) -> None:
    """B15-B18 at the serving batch 128 (B17 and B18 at ViT-Base's
    attention shape), B19 at the stage-2 training shape (batch 8)."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import ffn
    b, n, h, d, hd = TIME_BATCH, TOKENS, HEADS, HEAD_DIM, HEADS * HEAD_DIM
    scale = d ** -0.5
    q, k, v, wp, bp, res = proj_inputs(gen, b, n, h, WIDTH)
    bp16 = bp.to(torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row("attn_proj", f"attn_proj B={b} N={n} H={h} D={d} HO={WIDTH} "
        "(library: SDPA, F.linear, + residual)",
        lambda: att.attn_proj_kernel(q, k, v, wp, bp, res, scale),
        lambda: att.attention_proj_plain(q, k, v, wp, bp, res, scale),
        lambda: F.linear(F.scaled_dot_product_attention(qt, kt, vt)
                         .transpose(1, 2).reshape(b, n, hd), wp, bp16) + res,
        4.0 * b * h * n * n * d + 2.0 * b * n * hd * WIDTH,
        (3 * b * n * hd + 2 * b * n * WIDTH + WIDTH * hd) * 2 + WIDTH * 4,
        PEAK_BF16, 10, reps=5)
    del q, k, v, qt, kt, vt, res

    m = b * TOKENS
    x, w1, b1, w2, b2 = ffn_inputs(gen, m, WIDTH, MLP)
    b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
    row("ffn", f"ffn tanh M={m} d={WIDTH} h={MLP} (library: F.linear, "
        "tanh, F.linear)",
        lambda: ffn.ffn_kernel(x, w1, b1, w2, b2, "tanh"),
        lambda: ffn.ffn_plain(x, w1, b1, w2, b2, "tanh"),
        lambda: F.linear(torch.tanh(F.linear(x, w1, b1h)), w2, b2h),
        4.0 * m * WIDTH * MLP,
        (2 * m * WIDTH + 2 * WIDTH * MLP) * 2 + (WIDTH + MLP) * 4,
        PEAK_BF16, 10)
    del x, w1, w2

    flops = 4.0 * b * h * n * n * d
    nbytes = 4 * b * h * n * d * 2
    q, k, v = (rand((b, h, n, d), gen) for _ in range(3))
    row("attention_bhnd", f"attention_bhnd (B, H, N, D) none B={b} H={h} "
        f"N={n} D={d} (library: SDPA)",
        lambda: att.attention_bhnd_kernel(q, k, v, scale),
        lambda: att.attention_plain(q, k, v, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
        flops, nbytes, PEAK_BF16, 10)
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row("attention_fused_bnhd", f"attention_fused_bnhd (B, N, H, D) none "
        f"B={b} N={n} H={h} D={d} (library: SDPA on the transposed views)",
        lambda: att.attention_strided_kernel("attention_fused_bnhd", q, k, v,
                                             scale, score_scale=True),
        lambda: att.attention_fused_bnhd_plain(q, k, v, scale),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
        flops, nbytes, PEAK_BF16, 10)
    del q, k, v, qt, kt, vt

    bs, hs, ns = SAMPLE_BATCH, 16, TOKENS + 1
    q3 = rand((bs, ns, hs * d), gen, scale=0.125)
    k3, v3 = (rand(q3.shape, gen) for _ in range(2))
    qt, kt, vt = (t.view(bs, ns, hs, d).transpose(1, 2) for t in (q3, k3, v3))
    # causal with cond_len 1: row i sees i + 1 keys
    pairs = bs * hs * ns * (ns + 1) / 2
    row("attention_gridchunk", f"attention_gridchunk prefix_causal cond_len "
        f"1 B={bs} H={hs} N={ns} D={d} (library: SDPA is_causal)",
        lambda: att.attention_packed_gridchunk(q3, k3, v3, "prefix_causal",
                                               1, d),
        lambda: att.attention_packed_plain(q3, k3, v3, "prefix_causal", 1,
                                           d),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               scale=1.0),
        4.0 * pairs * d, 4 * bs * ns * hs * d * 2, PEAK_BF16, 20)



# -- fp32 attention and head dims between the tiles (csrc/attention_f32.cu,
# the bf16 kernels' next tile) ----------------------------------------------

F32_TOL = dict(atol=1e-4, rtol=1e-5)  # tests/test_torch_cuda.py's
F32_BWD_TOL = dict(atol=1e-4, rtol=1e-4)
# a 1280-wide tower over 16 heads: heads of 80 lanes (a config that sets
# dim_head to dim / heads; the shipped Large config leaves it at 64)
D80_HEADS, D80 = 16, 80


def compare_f32_kernels(gen, close, errs) -> None:
    """The fp32 attention kernels against their plain versions (fp32 sums
    in another order: F32_TOL forward, 1e-4 + 1e-4 relative backward, over
    N-term sums): B2 at ViT-VQGAN-Base's shape (batch 8) and at heads of
    80, ragged and causal cases; B8 at the prior's prefill (N = 1025 and
    1); B17-B19; B5 at the training shape. And the bf16 Hopper kernels at
    heads of 80 (the 128 tile), at phase 3's bf16 limits."""
    from enhancing_tpu_torch.ops import attention as att
    f32 = torch.float32
    for (b, n, h, d, mode, cl) in ((CHECK_BATCH, TOKENS, HEADS, HEAD_DIM,
                                    "none", 0),
                                   (CHECK_BATCH, TOKENS, D80_HEADS, D80,
                                    "none", 0),
                                   (2, 1025, 4, 64, "prefix_causal", 5),
                                   (1, 300, 2, 128, "none", 0),
                                   (3, 1, 4, 64, "none", 0),
                                   (2, 65, 3, 48, "prefix_causal", 70)):
        qkv = rand((b, n, 3 * h * d), gen, f32)
        close("attention_f32", f"attention f32 {mode} B={b} N={n} H={h} "
              f"D={d}",
              att.attention_packed_qkv_kernel(qkv, h, d, d ** -0.5, mode, cl),
              att.attention_packed_qkv_plain(qkv, h, d, d ** -0.5, mode, cl),
              **F32_TOL)
    for (b, n, h, d, cl) in ((SAMPLE_BATCH, P_CTX, P_HEADS, P_HEAD_DIM, 1),
                             (SAMPLE_BATCH, 1, P_HEADS, P_HEAD_DIM, 1),
                             (2, 300, 4, 64, 5)):
        q, k, v = (rand((b, n, h, d), gen, f32) for _ in range(3))
        close("attention_bnhd_f32", f"attention_bnhd f32 prefix_causal "
              f"cond_len {cl} B={b} N={n} H={h} D={d}",
              att.attention_bnhd_kernel(q, k, v, d ** -0.5, "prefix_causal",
                                        cl),
              att.attention_bnhd_plain(q, k, v, d ** -0.5, "prefix_causal",
                                       cl), **F32_TOL)
    for (n, m, d, mode) in ((300, 257, 64, "none"), (65, 130, 80,
                                                    "prefix_causal")):
        q = rand((2, 4, n, d), gen, f32)
        k, v = rand((2, 4, m, d), gen, f32), rand((2, 4, m, d), gen, f32)
        close("attention_bhnd_f32", f"attention_bhnd f32 {mode} N={n} M={m}"
              f" D={d}", att.attention_bhnd_kernel(q, k, v, d ** -0.5, mode,
                                                   3),
              att.attention_plain(q, k, v, d ** -0.5, mode, 3), **F32_TOL)
        qb, kb, vb = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        close("attention_fused_bnhd_f32", f"attention_fused_bnhd f32 {mode} "
              f"N={n} M={m} D={d}",
              att.attention_strided_kernel("attention_fused_bnhd", qb, kb, vb,
                                           d ** -0.5, mode, 3,
                                           score_scale=True),
              att.attention_fused_bnhd_plain(qb, kb, vb, d ** -0.5, mode, 3),
              **F32_TOL)
    q3, k3, v3 = (rand((2, 1025, 16 * 64), gen, f32, 0.5) for _ in range(3))
    close("attention_gridchunk_f32", "attention_gridchunk f32 prefix_causal "
          "cond_len 1 B=2 N=1025 H=16 D=64",
          att.attention_packed_gridchunk(q3, k3, v3, "prefix_causal", 1, 64),
          att.attention_packed_plain(q3, k3, v3, "prefix_causal", 1, 64),
          **F32_TOL)
    for (b, n, h, d, mode, cl) in ((TRAIN_BATCH, TOKENS, HEADS, HEAD_DIM,
                                    "none", 0),
                                   (TRAIN_BATCH, TOKENS, D80_HEADS, D80,
                                    "none", 0),
                                   (2, 1025, 4, 64, "prefix_causal", 5)):
        qkv = rand((b, n, 3 * h * d), gen, f32)
        q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
        do = rand((b, n, h * d), gen, f32)
        got = att.attention_bwd_kernel(q3, k3, v3, do, h, d, mode, cl)
        want = att.attention_bwd_plain(q3, k3, v3, do, h, d, mode, cl)
        for name, g, w in zip("qkv", got, want):
            close("attention_bwd_f32", f"attention_bwd f32 d{name} {mode} "
                  f"B={b} N={n} H={h} D={d}", g, w, **F32_BWD_TOL)
    del qkv, q3, k3, v3, do, got, want

    # bf16 at heads of 80: B2 and B8 on the same lane slices bit-equal,
    # B5 at phase 3's backward limit
    b, n, h, d = CHECK_BATCH, TOKENS, D80_HEADS, D80
    qkv = rand((b, n, 3 * h * d), gen)
    got = att.attention_packed_qkv_kernel(qkv, h, d, d ** -0.5)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    equal = torch.equal(got, att.attention_bnhd_kernel(q, k, v, d ** -0.5)
                        .view(b, n, h * d))
    log(f"[compare] attention bf16 D={d}: B2 and B8 on its lane slices "
        f"{'bit-equal' if equal else 'DIFFER'}")
    check(equal, "B2 and B8 differ at D = 80")
    close("attention", f"attention bf16 none B={b} N={n} H={h} D={d} (the "
          "128 tile)", got,
          att.attention_packed_qkv_plain(qkv, h, d, d ** -0.5),
          atol=1e-2, rtol=2.0 ** -7)
    q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
    do = rand((b, n, h * d), gen)
    got = att.attention_bwd_kernel(q3, k3, v3, do, h, d)
    want = att.attention_bwd_plain(q3, k3, v3, do, h, d)
    for name, g, w in zip("qkv", got, want):
        close("attention_bwd", f"attention_bwd bf16 d{name} none B={b} N={n}"
              f" H={h} D={d} (the 128 tile)", g, w,
              atol=2.0 ** -6 * float(w.float().abs().max()), rtol=2.0 ** -6)


def time_f32_kernels(gen, row) -> None:
    """The fp32 kernels at the shipped fp32 configs' shapes: B2 at
    ViT-VQGAN-Base's batch 8 (the shipped-configs phase's batch), B5 at
    the training batch 8, B8 at the prior's teacher-forced prefill, B17-B19
    at their bf16 rows' shapes but batch 8; two bounds (row(): six bf16
    products at 989 TFLOP/s, and the fp32 SIMT rate of 67); the library
    call SDPA in fp32 with TF32 off. Then, logged, heads of 80 in bf16 and
    fp32 beside heads of 64 at the same width, each with SDPA in its dtype
    (forward and autograd backward)."""
    from enhancing_tpu_torch.ops import attention as att
    f32 = torch.float32
    b, n, h, d = CHECK_BATCH, TOKENS, HEADS, HEAD_DIM
    qkv = rand((b, n, 3 * h * d), gen, f32)
    q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
    row("attention_f32", f"attention f32 B={b} N={n} H={h} D={d} (library: "
        "SDPA fp32, TF32 off)",
        lambda: att.attention_packed_qkv_kernel(qkv, h, d, d ** -0.5),
        lambda: att.attention_packed_qkv_plain(qkv, h, d, d ** -0.5),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4.0 * b * h * n * n * d, 4 * b * n * h * d * 4, PEAK_F32, 5)
    q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
    do = rand((b, n, h * d), gen, f32)
    ql, kl, vl = (u.reshape(b, n, h, d).transpose(1, 2).detach()
                  .requires_grad_() for u in (q3, k3, v3))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=1.0)
    lib_do = do.reshape(b, n, h, d).transpose(1, 2)
    row("attention_bwd_f32", f"attention_bwd f32 B={b} N={n} H={h} D={d} "
        "(library: autograd of SDPA fp32)",
        lambda: att.attention_bwd_kernel(q3, k3, v3, do, h, d),
        lambda: att.attention_bwd_plain(q3, k3, v3, do, h, d),
        lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_do,
                                    retain_graph=True),
        10.0 * b * h * n * n * d, 7 * b * n * h * d * 4, PEAK_F32, 5)
    del qkv, q, k, v, q3, k3, v3, do, ql, kl, vl, lib_out

    bs, ns, hs, ds = SAMPLE_BATCH, P_CTX, P_HEADS, P_HEAD_DIM
    q, k, v = (rand((bs, ns, hs, ds), gen, f32) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = bs * hs * ns * (ns + 1) / 2
    row("attention_bnhd_f32", f"attention_bnhd f32 prefix_causal B={bs} "
        f"N={ns} H={hs} D={ds} (library: SDPA fp32 is_causal)",
        lambda: att.attention_bnhd_kernel(q, k, v, ds ** -0.5,
                                          "prefix_causal", 1),
        lambda: att.attention_bnhd_plain(q, k, v, ds ** -0.5,
                                         "prefix_causal", 1),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               scale=ds ** -0.5),
        4.0 * pairs * ds, 4 * bs * ns * hs * ds * 4, PEAK_F32, 3)
    del q, k, v, qt, kt, vt

    scale = d ** -0.5
    q, k, v = (rand((b, h, n, d), gen, f32) for _ in range(3))
    row("attention_bhnd_f32", f"attention_bhnd f32 (B, H, N, D) none B={b} "
        f"H={h} N={n} D={d} (library: SDPA fp32)",
        lambda: att.attention_bhnd_kernel(q, k, v, scale),
        lambda: att.attention_plain(q, k, v, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
        4.0 * b * h * n * n * d, 4 * b * h * n * d * 4, PEAK_F32, 5)
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row("attention_fused_bnhd_f32", f"attention_fused_bnhd f32 (B, N, H, D) "
        f"none B={b} N={n} H={h} D={d} (library: SDPA fp32 on the "
        "transposed views)",
        lambda: att.attention_strided_kernel("attention_fused_bnhd", q, k, v,
                                             scale, score_scale=True),
        lambda: att.attention_fused_bnhd_plain(q, k, v, scale),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
        4.0 * b * h * n * n * d, 4 * b * h * n * d * 4, PEAK_F32, 5)
    del q, k, v, qt, kt, vt
    ns, hs = TOKENS + 1, 16
    q3 = rand((bs, ns, hs * d), gen, f32, 0.125)
    k3, v3 = (rand(q3.shape, gen, f32) for _ in range(2))
    qt, kt, vt = (t.view(bs, ns, hs, d).transpose(1, 2) for t in (q3, k3, v3))
    pairs = bs * hs * ns * (ns + 1) / 2
    row("attention_gridchunk_f32", f"attention_gridchunk f32 prefix_causal "
        f"cond_len 1 B={bs} H={hs} N={ns} D={d} (library: SDPA fp32 "
        "is_causal)",
        lambda: att.attention_packed_gridchunk(q3, k3, v3, "prefix_causal", 1,
                                               d),
        lambda: att.attention_packed_plain(q3, k3, v3, "prefix_causal", 1, d),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               scale=1.0),
        4.0 * pairs * d, 4 * bs * ns * hs * d * 4, PEAK_F32, 5)
    del q3, k3, v3, qt, kt, vt

    # heads of 80 beside heads of 64 at the width of 16 heads, batch 8:
    # forward and backward, bf16 and fp32, each with its bound
    for dtype, peak in ((torch.bfloat16, PEAK_BF16), (f32, PEAK_F32)):
        for d in (64, D80):
            h = D80_HEADS
            qkv = rand((b, n, 3 * h * d), gen, dtype)
            q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
            do = rand((b, n, h * d), gen, dtype)
            fwd = time_ms(lambda: att.attention_packed_qkv_kernel(
                qkv, h, d, d ** -0.5), 5)
            bwd = time_ms(lambda: att.attention_bwd_kernel(  # noqa: B023
                q3, k3, v3, do, h, d), 5)
            size = dtype.itemsize
            fb, _ = bound(4.0 * b * h * n * n * d, 4 * b * n * h * d * size,
                          peak)
            bb, _ = bound(10.0 * b * h * n * n * d, 7 * b * n * h * d * size,
                          peak)
            if dtype == f32:  # the pieces' bound
                fb, _ = bound(6 * 4.0 * b * h * n * n * d,
                              4 * b * n * h * d * size, PEAK_BF16)
                bb, _ = bound(6 * 10.0 * b * h * n * n * d,
                              7 * b * n * h * d * size, PEAK_BF16)
            # SDPA in the same dtype beside them (fp32: TF32 off)
            ql, kl, vl = (u.reshape(b, n, h, d).transpose(1, 2).detach()
                          .requires_grad_() for u in (q3, k3, v3))
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, scale=1.0), 5)  # noqa: B023
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=1.0)
            lib_do = do.reshape(b, n, h, d).transpose(1, 2)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), lib_do,  # noqa: B023
                retain_graph=True), 5)
            log(f"[time] attention {str(dtype)[6:]} B={b} N={n} H={h} D={d}:"
                f" forward {fwd:.4f} ms (bound {fb:.4f}), backward "
                f"{bwd:.4f} ms (bound {bb:.4f}); SDPA {str(dtype)[6:]} "
                f"forward {lib_fwd:.4f} ms, autograd backward {lib_bwd:.4f}"
                " ms")
            del qkv, q3, k3, v3, do, ql, kl, vl, lib_out


# the fp32 towers' LN -> GEMM calls at batch 8 (M = 8192): (label, d, n,
# activation), ViT-VQGAN-Base's qkv and fc1 and imagenet_vitvq_large.yaml's
# decoder qkv and fc1
F32_LN_GEMM = (("Base qkv", 768, 2304, None), ("Base fc1", 768, 3072, "tanh"),
               ("Large decoder qkv", 1280, 3840, None),
               ("Large decoder fc1", 1280, 5120, "tanh"))


def time_f32_ln_gemm(gen, row) -> None:
    """fp32 B1 (csrc/ln_gemm_f32.cu) at F32_LN_GEMM, fp32 W: kernel ms
    beside the pieces' bound (six bf16 products at 989 TFLOP/s) and the
    fp32 SIMT bound (67), the plain version and one library call
    (F.layer_norm, F.linear and the activation in fp32, TF32 off)."""
    from enhancing_tpu_torch.ops import ln_gemm as lg
    m = CHECK_BATCH * TOKENS
    for label, d, n, act in F32_LN_GEMM:
        x = torch.randn((m, d), generator=gen, device="cuda")
        g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        bt = 0.1 * torch.randn(d, generator=gen, device="cuda")
        w = torch.randn((n, d), generator=gen, device="cuda") * d ** -0.5
        b = (None if act is None
             else 0.02 * torch.randn(n, generator=gen, device="cuda"))
        row("ln_gemm_f32", f"ln_gemm f32 {label} B={CHECK_BATCH} M={m} {d} -> "
            f"{n}",
            lambda: lg.ln_gemm_kernel(x, g, bt, w, b, act),  # noqa: B023
            lambda: lg.ln_gemm_plain(x, g, bt, w, b, act),  # noqa: B023
            lambda: lg._act(F.linear(F.layer_norm(  # noqa: B023
                x, (d,), g, bt, 1e-5), w, b), act),  # noqa: B023
            2.0 * m * d * n, (m * d + n * d + m * n) * 4 + (2 * d + n) * 4,
            PEAK_F32, 20)
        del x, w


# -- the fp32 fusions on exact bf16 pieces (csrc/attn_proj_f32.cu, B15;
# csrc/ffn_f32.cu, B16) ---------------------------------------------------

# the towers of the shipped stage-1 configs: (heads, head dim, H*D = HO):
# imagenet_vitvq_small (and Large's encoder), imagenet_vitvq_base, and
# Large's decoder (16 heads of 64 into a 1280-wide residual)
PROJ_F32_TOWERS = ((8, 64, 512), (12, 64, 768), (16, 64, 1280))
SMALL_WIDTH, SMALL_MLP = 512, 2048


def proj_inputs_f32(gen, b, n, m, heads, d, ho):
    """fp32 B15's operands: q a (B, N, H, D) view of an fp32 (B, N, H * D)
    buffer, k and v the lane slices of an fp32 (B, M, 2 * H * D) buffer,
    a Xavier-scaled fp32 to_out weight (HO, H * D), an fp32 bias and an
    fp32 residual."""
    f32 = torch.float32
    hd = heads * d
    q = rand((b, n, hd), gen, f32).unflatten(-1, (heads, d))
    k, v = (t.unflatten(-1, (heads, d))
            for t in rand((b, m, 2 * hd), gen, f32).chunk(2, -1))
    wp = rand((ho, hd), gen, f32, scale=(2.0 / (hd + ho)) ** 0.5)
    bp = 0.02 * torch.randn(ho, generator=gen, device="cuda")
    return q, k, v, wp, bp, rand((b, n, ho), gen, f32)


def compare_f32_fusions(gen, close, errs) -> None:
    """fp32 B15 and B16 against their plain versions at the fp32 attention
    forward's limits (F32_TOL: fp32 sums in another order): B15 at head
    dims 32, 64 and 128, odd N and M, both masks, the shipped towers'
    (H*D, HO); B16 at Small's shape and other fused fp32 shapes (a short
    last hidden group, the 64-column slab), the three activations. Two
    calls of each are bit-equal (no atomics)."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import ffn
    f32 = torch.float32
    cases = [(CHECK_BATCH, TOKENS, TOKENS, h, d, ho, "none", 0)
             for h, d, ho in PROJ_F32_TOWERS]
    cases += [(2, 77, 77, 16, 32, 512, "prefix_causal", 5),
              (2, 77, 130, 8, 64, 512, "none", 0),
              (1, 130, 77, 4, 128, 512, "prefix_causal", 70),
              (3, 17, 17, 2, 128, 256, "none", 0),
              (2, 65, 65, 24, 32, 768, "none", 0)]
    for (b, n, m, h, d, ho, mode, cl) in cases:
        q, k, v, wp, bp, res = proj_inputs_f32(gen, b, n, m, h, d, ho)
        scale = d ** -0.5
        got = att.attn_proj_kernel(q, k, v, wp, bp, res, scale, mode, cl)
        want = att.attention_proj_plain(q, k, v, wp, bp, res, scale, mode, cl)
        close("attn_proj_f32", f"attn_proj f32 {mode} B={b} N={n} M={m} "
              f"H={h} D={d} HO={ho}", got, want, **F32_TOL)
    same = torch.equal(got, att.attn_proj_kernel(q, k, v, wp, bp, res, scale,
                                                 mode, cl))
    log(f"[compare] attn_proj f32: two calls {'bit-equal' if same else 'DIFFER'}")
    check(same, "fp32 B15: two calls differ")
    # the cluster plans (ops/ffn.py::ffn_f32_plan): C = 4 (Small), 6, 2
    # with a short last group of 1 chunk (h = 1088: 17 chunks), 1 with a
    # 64-column slab, 8
    for (m, d, h, act) in ((CHECK_BATCH * TOKENS, SMALL_WIDTH, SMALL_MLP,
                            "tanh"),
                           (1000, 768, 2048, "gelu"),
                           (333, 256, 1088, "sqrelu"),
                           (129, 64, 256, "tanh"),
                           (200, 1024, 1024, "gelu")):
        args = ffn_inputs(gen, m, d, h, torch.float32)
        want = ffn.ffn_plain(*args, act)
        got = ffn.ffn_kernel(*args, act)
        close("ffn_f32", f"ffn f32 {act} M={m} d={d} h={h}", got, want,
              **F32_TOL)
    same = torch.equal(got, ffn.ffn_kernel(*args, act))
    log(f"[compare] ffn f32: two calls {'bit-equal' if same else 'DIFFER'}")
    check(same, "fp32 B16: two calls differ")


def time_f32_fusions(gen, row) -> None:
    """fp32 B15 at imagenet_vitvq_small's and ViT-VQGAN-Base's towers and
    fp32 B16 at Small's, batch 8 (phase 9's fp32 trips): two bounds
    (row(): the pieces' at the bf16 rate, fp32 SIMT's at 67); the library
    call computes the same function in PyTorch (SDPA fp32, F.linear, +
    residual; F.linear, the activation, F.linear; TF32 off). Logged
    beside them: the unfused form the route ran before this kernel (B8
    fp32, then the fp32 projection)."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import ffn
    b, n = CHECK_BATCH, TOKENS
    for h, d, ho in PROJ_F32_TOWERS[:2]:
        hd = h * d
        q, k, v, wp, bp, res = proj_inputs_f32(gen, b, n, n, h, d, ho)
        scale = d ** -0.5
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row("attn_proj_f32", f"attn_proj f32 B={b} N={n} H={h} D={d} HO={ho}"
            " (library: SDPA fp32, F.linear, + residual)",
            lambda: att.attn_proj_kernel(q, k, v, wp, bp, res, scale),
            lambda: att.attention_proj_plain(q, k, v, wp, bp, res, scale),
            lambda: F.linear(F.scaled_dot_product_attention(qt, kt, vt)
                             .transpose(1, 2).reshape(b, n, hd), wp, bp) + res,
            4.0 * b * h * n * n * d + 2.0 * b * n * hd * ho,
            (3 * b * n * hd + 2 * b * n * ho + ho * hd + ho) * 4, PEAK_F32, 5,
            reps=3)
        unfused = time_ms(lambda: att.attention_proj_unfused(
            q, k, v, wp, bp, res, scale), 5)
        log(f"[time] attn_proj f32 H={h} HO={ho}: the unfused form (B8 fp32,"
            f" then the fp32 projection) {unfused:.4f} ms")
        del q, k, v, wp, bp, res, qt, kt, vt
    m = b * n
    x, w1, b1, w2, b2 = ffn_inputs(gen, m, SMALL_WIDTH, SMALL_MLP,
                                   torch.float32)
    row("ffn_f32", f"ffn f32 tanh M={m} d={SMALL_WIDTH} h={SMALL_MLP} "
        "(library: F.linear, tanh, F.linear in fp32; the unfused form)",
        lambda: ffn.ffn_kernel(x, w1, b1, w2, b2, "tanh"),
        lambda: ffn.ffn_plain(x, w1, b1, w2, b2, "tanh"),
        lambda: ffn.ffn_unfused(x, w1, b1, w2, b2, "tanh"),
        4.0 * m * SMALL_WIDTH * SMALL_MLP,
        (2 * m * SMALL_WIDTH + 2 * SMALL_WIDTH * SMALL_MLP + SMALL_WIDTH
         + SMALL_MLP) * 4, PEAK_F32, 5, reps=3)
    del x, w1, w2


# -- B5 at the prior's head dim 384 (csrc/attention_bwd_wide.cu) -----------

# the prior's training batch (configs/imagenet_gpt_vitvq_base.yaml's
# dataset batch_size) and its attention: 16 heads of 384 over 1 + 1024
# tokens, prefix-causal with the one condition token
PRIOR_TRAIN_BATCH = 4


# B5 at D = 384: ||kernel - plain|| / ||plain|| over each (batch, head,
# band of BAND rows, the ragged tail joining the last) block of dq, dk and
# dv, against the plain version computed in fp32 on the same inputs. The
# elementwise limit of bf16 scales with the largest |dq|, which the first
# prefix-causal rows (a few keys visible) make ~70x the median, so it alone
# would pass most rows wrong by a few per cent; this one scales with no row
# outside its band. The bf16 plain version is no reference here: in a
# band of few rows its own roundings can outweigh the kernel's.
BAND, BAND_REL = 64, {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -13}


def worst_band_rel(got, want, h, d) -> float:
    """The largest ||got - want|| / ||want|| over (batch, head, band)
    blocks of (B, N, H*D) tensors: bands of BAND rows, the last taking
    the ragged tail."""
    b, n = want.shape[:2]
    nb = max(n // BAND, 1)
    band = (torch.arange(n, device=want.device) // BAND).clamp_max(nb - 1)
    err, ref = (torch.zeros(b, nb, h, dtype=torch.float64,
                            device=want.device).index_add_(
        1, band, t.double().reshape(b, n, h, d).square().sum(-1)).sqrt()
        for t in (got.double() - want.double(), want))
    return float((err / ref.clamp_min(1e-300)).max())


def compare_wide_bwd(gen, close, errs) -> None:
    """B5 at D = 384 against autograd of its plain version
    (:func:`hold_bwd`): B 2, H 16, N 1025 and a ragged 77, both masks
    (prefix-causal with cond_len 1), bf16 and fp32."""
    for dtype, name in ((torch.bfloat16, "attention_bwd_wide"),
                        (torch.float32, "attention_bwd_wide_f32")):
        for (b, n, mode, cl) in ((2, P_CTX, "prefix_causal", 1),
                                 (2, P_CTX, "none", 0),
                                 (2, 77, "prefix_causal", 1),
                                 (2, 77, "none", 0)):
            hold_bwd(gen, close, name, dtype, b, n, P_HEADS, P_HEAD_DIM,
                     mode, cl)


def hold_bwd(gen, close, name, dtype, b, n, h, d, mode, cl) -> None:
    """B5 on the lane slices of a (B, N, 3 H D) qkv buffer against autograd
    of its plain version: bf16 at B5's D <= 128 limit (2^-6 of the largest
    |plain| + 2^-6 relative), fp32 at the fp32 backward's (F32_BWD_TOL);
    besides, every (batch, head, 64-row) band within BAND_REL of the plain
    version in fp32 (worst_band_rel), and a dq made wrong past the first
    band failed by it; two calls give the same bits."""
    from enhancing_tpu_torch.ops import attention as att
    qkv = rand((b, n, 3 * h * d), gen, dtype)
    q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
    do = rand((b, n, h * d), gen, dtype)
    got = att.attention_bwd_kernel(q3, k3, v3, do, h, d, mode, cl)
    again = att.attention_bwd_kernel(q3, k3, v3, do, h, d, mode, cl)
    want = att.attention_bwd_plain(q3, k3, v3, do, h, d, mode, cl)
    want32 = (want if dtype == torch.float32 else
              att.attention_bwd_plain(*(t.float() for t in (
                  q3, k3, v3, do)), h, d, mode, cl))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    check(same, f"{name} N={n} {mode}: two calls differ")
    for gname, g, w, w32 in zip("qkv", got, want, want32):
        tol = (F32_BWD_TOL if dtype == torch.float32 else
               dict(atol=2.0 ** -6 * float(w.float().abs().max()),
                    rtol=2.0 ** -6))
        label = (f"{name} {str(dtype)[6:]} d{gname} {mode} "
                 f"B={b} N={n} H={h} D={d}")
        close(name, label + " (two calls bit-equal)", g, w, **tol)
        rel = worst_band_rel(g, w32, h, d)
        ok = rel <= BAND_REL[dtype]
        log(f"[compare] {label}: median |plain| "
            f"{float(w.float().abs().median()):.3e}, largest "
            f"{float(w.float().abs().max()):.3e}; worst {BAND}-row "
            f"band ||err||/||fp32 plain|| {rel:.3e} limit "
            f"{BAND_REL[dtype]:g} -> {'pass' if ok else 'FAIL'}")
        check(ok, f"{label}: a {BAND}-row band disagrees")
        if gname == "q" and n >= 2 * BAND:
            # the band limit fails a dq twice its limit off past the
            # first band, however the elementwise one takes it
            bad = g.clone()
            bad[:, BAND:] *= 1.0 + 2.0 * BAND_REL[dtype]
            err = (bad.float() - w.float()).abs()
            elem = bool((err <= tol["atol"] + tol["rtol"]
                         * w.float().abs()).all())
            rel = worst_band_rel(bad, w32, h, d)
            log(f"[compare] {label}, dq x{1 + 2 * BAND_REL[dtype]:g} "
                f"past row {BAND}: elementwise limit "
                f"{'passes' if elem else 'fails'} it, band "
                f"{rel:.3e} fails it: {rel > BAND_REL[dtype]}")
            check(rel > BAND_REL[dtype], f"{label}: the band limit "
                  "passes a dq off past the first band")
    del qkv, q3, k3, v3, do, got, again, want, want32


def fastest_sdpa_backward(q, k, v, do, iters):
    """(backward call, backend name, backends that refused) of the fastest
    SDPA backward (causal, scale 1) on (B, H, N, D) q, k, v that some
    backend takes, each backend tried alone; the call reruns the backward
    of a graph recorded under that backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    best, refused = None, []
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        bname = backend.name
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                     scale=1.0)
            torch.autograd.grad(out, leaves, do, retain_graph=True)
        except RuntimeError:
            refused.append(bname)
            continue
        fn = (lambda o, ls: lambda: torch.autograd.grad(
            o, ls, do, retain_graph=True))(out, leaves)
        ms = time_ms(fn, iters)
        if best is None or ms < best[0]:
            best = (ms, fn, bname)
    return best[1], best[2], refused


def time_wide_bwd(gen, row) -> None:
    """B5 at D = 384, bf16 and fp32, at the prior's training batch (B 4,
    H 16, N 1025): :func:`time_bwd`."""
    for dtype, name, iters in ((torch.bfloat16, "attention_bwd_wide", 10),
                               (torch.float32, "attention_bwd_wide_f32", 3)):
        time_bwd(gen, row, name, dtype, PRIOR_TRAIN_BATCH, P_CTX, P_HEADS,
                 P_HEAD_DIM, iters)


def time_bwd(gen, row, name, dtype, b, n, h, d, iters) -> None:
    """B5 prefix-causal with cond_len 1 (which is causal) on (B, N, H*D)
    lane slices: the bound as B5's row computes it, on the causal half of
    the score tile (N (N + 1) / 2 pairs a (batch, head): this run's work);
    the library call is the fastest SDPA backward that takes the head dim
    (is_causal, one backend at a time; the backend named on the line)."""
    from enhancing_tpu_torch.ops import attention as att
    pairs = b * h * n * (n + 1) / 2
    qkv = rand((b, n, 3 * h * d), gen, dtype)
    q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
    do = rand((b, n, h * d), gen, dtype)
    qt, kt, vt, dot = (t.reshape(b, n, h, d).transpose(1, 2)
                       for t in (q3, k3, v3, do))
    lib, backend, refused = fastest_sdpa_backward(qt, kt, vt, dot, iters)
    row(name, f"{name} {str(dtype)[6:]} prefix_causal cond_len 1 B={b} "
        f"N={n} H={h} D={d} (library: SDPA backward, backend {backend}; "
        f"refused at D={d}: {', '.join(refused) or 'none'})",
        lambda: att.attention_bwd_kernel(q3, k3, v3, do, h, d,
                                         "prefix_causal", 1),
        lambda: att.attention_bwd_plain(q3, k3, v3, do, h, d,
                                        "prefix_causal", 1),
        lib, 10.0 * pairs * d, 7 * b * n * h * d * dtype.itemsize,
        PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32, iters)
    del qkv, q3, k3, v3, do, qt, kt, vt, dot, lib
    gc_cuda()


def kernel_counts() -> dict:
    """The launches since the last reset by kernels-line name: each bf16
    kernel's (its LAUNCHES less the fp32 ones counted under its name) and
    each fp32 kernel's (fp32 B1: its two fp32 routes)."""
    from enhancing_tpu_torch.ops import (F32_LAUNCHES, LAUNCHES,
                                         LN_GEMM_ROUTES, WIDE_LAUNCHES)
    out = {k: v - F32_LAUNCHES[k] for k, v in LAUNCHES.items()}
    out.update({k: F32_LAUNCHES[v] for k, v in F32_OF.items()})
    out.update({k: WIDE_LAUNCHES[v] for k, v in WIDE_BWD.items()})
    out["attention_bwd"] -= out["attention_bwd_wide"]
    out["attention_bwd_f32"] -= out["attention_bwd_wide_f32"]
    out["ln_gemm_f32"] = LN_GEMM_ROUTES["f32"] + LN_GEMM_ROUTES["decode"]
    out["ln_gemm"] -= out["ln_gemm_f32"]
    return out


# configs/*.yaml as shipped, their own dtype (fp32): launches a round trip
SHIPPED = {"imagenet_vitvq_base": {"ln_gemm": 48, "attention": 24,
                                   "layernorm": 2, "vq": 1},
           "imagenet_vitvq_large": {"ln_gemm": 80, "attention": 40,
                                    "layernorm": 2, "vq": 1}}
# kernels against the plain path at batch 8: codes equal at 99% of tokens
# (the rest near-ties of random weights); reconstructions from the same
# codes within 1e-3 in fp32 (sums in another order over 12 or 32 layers)
# and phase 5's limits in bf16
SHIPPED_MATCH, SHIPPED_REC_ATOL = {"float32": 99.0, "bfloat16": 95.0}, {
    "float32": 1e-3, "bfloat16": 0.1}


def phase_shipped_configs(x8, codes_bf16) -> dict:
    """configs/imagenet_vitvq_base.yaml and imagenet_vitvq_large.yaml
    through load_config + initialize_from_config(device='cuda'), in their
    own fp32; then the Large config with the decoder's dim_head set to
    1280 / 16 = 80, in fp32 and bf16, which puts heads of 80 on the path.
    Each: a round trip at batch 8 with its launches asserted, against the
    plain path, its time and peak memory. Returns the launches by
    kernels-line name."""
    from pathlib import Path

    from enhancing_tpu_torch.ops import F32_LAUNCHES, LAUNCHES, reset_launches
    from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                                  load_config)
    configs = Path(__file__).resolve().parent / "configs"
    total: dict = {}
    variants = [(name, {}) for name in SHIPPED] + [
        ("imagenet_vitvq_large", {"dim_head": D80}),
        ("imagenet_vitvq_large", {"dim_head": D80, "dtype": "bfloat16"})]
    for name, change in variants:
        cfg = load_config(configs / f"{name}.yaml")
        params = cfg.model.params
        if "dtype" in change:
            params["dtype"] = change["dtype"]
        if "dim_head" in change:
            params.decoder["dim_head"] = change["dim_head"]
        dtype = params.get("dtype", "float32")
        label = f"{name}{' dec dim_head 80' if change else ''} {dtype}"
        gc_cuda()
        t0 = time.perf_counter()
        model = initialize_from_config(cfg.model, device="cuda")
        torch.cuda.synchronize()
        enc, dec = params.encoder, params.decoder
        log(f"[shipped] {label}: encoder {enc.depth} x {enc.dim} ({enc.heads} "
            f"heads of {enc.get('dim_head', 64)}), decoder {dec.depth} x "
            f"{dec.dim} ({dec.heads} heads of {dec.get('dim_head', 64)}), "
            f"built in {time.perf_counter() - t0:.1f} s")
        reset_launches()
        codes = model.encode_codes(x8)
        rec = model.decode_codes(codes)
        torch.cuda.synchronize()
        got = {k: v for k, v in LAUNCHES.items() if v}
        want = SHIPPED[name]
        f32 = F32_LAUNCHES["attention"]
        log(f"[shipped] {label}: launches a round trip {got}, fp32 attention"
            f" launches {f32}")
        check(got == want, f"{label}: launches {got}, expected {want}")
        check(f32 == (want["attention"] if dtype == "float32" else 0),
              f"{label}: {f32} fp32 attention launches")
        for k, v in kernel_counts().items():
            total[k] = total.get(k, 0) + v
        check(codes.shape == (CHECK_BATCH, TOKENS)
              and bool(((codes >= 0) & (codes < CODES)).all()),
              f"{label}: codes {codes.shape}")
        check(rec.shape == (CHECK_BATCH, 256, 256, 3)
              and rec.dtype == model.dtype and bool(torch.isfinite(rec).all()),
              f"{label}: reconstruction {rec.shape} {rec.dtype}")
        before = dict(LAUNCHES)
        with plain_versions():
            codes_p = model.encode_codes(x8)
            rec_p = model.decode_codes(codes)
        check(LAUNCHES == before, "the plain path launched a kernel")
        match = float((codes == codes_p).float().mean()) * 100
        err = float((rec.float() - rec_p.float()).abs().max())
        log(f"[shipped] {label}, kernels vs plain at batch {CHECK_BATCH}: "
            f"code match {match:.3f}% (threshold {SHIPPED_MATCH[dtype]}%), "
            f"reconstruction from the same codes max_abs_err {err:.4e} "
            f"(|plain| max {float(rec_p.float().abs().max()):.3f}, threshold"
            f" {SHIPPED_REC_ATOL[dtype]})")
        check(match >= SHIPPED_MATCH[dtype], f"{label}: codes disagree")
        check(err <= SHIPPED_REC_ATOL[dtype], f"{label}: reconstructions "
              "disagree")
        if name == "imagenet_vitvq_base" and not change:
            # phase 5's bf16 model has this config's widths and seed
            log(f"[shipped] bf16 kernels (phase 5) vs f32 kernels, batch "
                f"{CHECK_BATCH}: code match "
                f"{float((codes_bf16 == codes).float().mean()) * 100:.3f}%; "
                f"vs f32 plain "
                f"{float((codes_bf16 == codes_p).float().mean()) * 100:.3f}%")
        del codes_p, rec_p
        torch.cuda.reset_peak_memory_stats()
        model.decode_codes(model.encode_codes(x8))
        torch.cuda.synchronize()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            model.decode_codes(model.encode_codes(x8))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        log(f"[shipped] {label} round trip batch {CHECK_BATCH}: "
            f"{dt * 1e3:.2f} ms, {CHECK_BATCH / dt:.1f} images/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, codes, rec
    gc_cuda()
    return total


# limits of the fp32 training step, kernels against the plain path: fp32
# sums in another order
F32_LOSS_RTOL_LIMIT, F32_COS_LIMIT = 1e-4, 0.99999


def phase_train_f32() -> dict:
    """configs/fake_vitvq_base.yaml with dtype float32: one train step (AE
    update, then D update, no R1) with its launches asserted; one step's
    losses and gradients through the kernels against the plain path."""
    from enhancing_tpu_torch.ops import F32_LAUNCHES, reset_launches
    from enhancing_tpu_torch.train import Trainer
    from enhancing_tpu_torch.utils.config import initialize_from_config
    gc_cuda()
    cfg = json.loads(json.dumps(FAKE_VITVQ_BASE))
    cfg["model"]["params"]["dtype"] = "float32"
    model = initialize_from_config(cfg["model"], device="cuda")
    data = initialize_from_config(cfg["dataset"])
    data.setup()
    module, disc = model.module, model.loss.discriminator
    x = model.get_input(next(iter(data.val_dataloader())), "image")
    state, train_step, _ = Trainer(max_steps=1)._build_stage1(model)
    module.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    metrics = train_step(state, x, do_r1=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernel_counts()
    got = {k: v for k, v in counts.items() if v}
    want = dict(TRAIN_STEP, ln_gemm=0, attention=0, attention_bwd=0,
                ln_gemm_f32=TRAIN_STEP["ln_gemm"], attention_f32=48,
                attention_bwd_f32=24)
    want = {k: v for k, v in want.items() if v}
    log(f"[train32] fake_vitvq_base float32, one step (no R1) batch "
        f"{TRAIN_BATCH}: {ms:.1f} ms (first call), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{got}; fp32 attention {dict(F32_LAUNCHES)['attention']}")
    check(got == want, f"fp32 step launches {got}, expected {want}")
    bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
    check(not bad, f"fp32 step: non-finite {bad}")
    # steps 1-2 after that warm-up, then one step's device time by group
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        train_step(state, x, do_r1=False)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    log(f"[train32] steps 1-2 after the first: {warm[0]:.1f}, {warm[1]:.1f} "
        f"ms")
    profile_device("one fp32 training step (no R1)",
                   lambda: train_step(state, x, do_r1=False))

    k_logs, k_ae, k_d, k_codes = one_step_grads(model, x)
    with plain_versions():
        p_logs, p_ae, p_d, p_codes = one_step_grads(model, x)
    module.eval()
    rel = {k: abs(k_logs[k] - p_logs[k]) / max(abs(p_logs[k]), 1e-6)
           for k in p_logs}
    worst = max(rel.items(), key=lambda kv: kv[1])
    ae_cos = worst_cosine([n for n, _ in module.named_parameters()], k_ae,
                          p_ae)
    d_cos = worst_cosine([n for n, _ in disc.named_parameters()], k_d, p_d)
    match = float((k_codes == p_codes).float().mean()) * 100
    log(f"[train32] one step, fp32 kernels vs fp32 plain: code match "
        f"{match:.3f}%; largest loss difference {worst[1]:.3e} relative "
        f"({worst[0]}; limit {F32_LOSS_RTOL_LIMIT}); least gradient cosine "
        f"AE {ae_cos[0]:.7f} ({ae_cos[1]}), D {d_cos[0]:.7f} ({d_cos[1]}) "
        f"(limit {F32_COS_LIMIT})")
    check(worst[1] <= F32_LOSS_RTOL_LIMIT, "fp32 losses disagree")
    check(min(ae_cos[0], d_cos[0]) >= F32_COS_LIMIT,
          "fp32 gradients disagree")
    del model, k_ae, k_d, p_ae, p_d, state
    gc_cuda()
    return counts


# the fp32 prior of configs/imagenet_gpt_vitvq_base.yaml (CondTransformer's
# own dtype) at full width; its layers, and the teacher-forced decode steps
# after the prefill
PRIOR_F32_LAYERS, PRIOR_F32_STEPS = 24, 16
PRIOR_F32_ATOL, PRIOR_F32_ARGMAX = 1e-3, 0.99


def phase_prior_f32() -> dict:
    """The fp32 GPT prior at full width (6144, 16 heads of 384), its
    prefill (B8 fp32) plus 16 decode steps (B9 and B10 on an fp32 cache)
    teacher-forced on random codes, against the plain path."""
    from enhancing_tpu_torch.ops import F32_LAUNCHES, reset_launches
    from enhancing_tpu_torch.utils.config import initialize_from_config
    gc_cuda()
    cfg = json.loads(json.dumps(GPT_VITVQ_BASE))
    cfg["params"]["transformer"]["params"]["n_layers"] = PRIOR_F32_LAYERS
    t0 = time.perf_counter()
    model = initialize_from_config(cfg, device="cuda")
    gpt = model.transformer
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in gpt.parameters())
    log(f"[prior32] prior {PRIOR_F32_LAYERS} x {P_WIDTH} float32, "
        f"{n_params / 1e9:.3f} G parameters, built on the card in "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    conds = torch.tensor(CLASSES, device="cuda")[:, None]
    gen = torch.Generator(device="cuda").manual_seed(4)
    codes = torch.randint(0, P_VOCAB, (SAMPLE_BATCH, PRIOR_F32_STEPS + 1),
                          generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = teacher_forced(gpt, codes, conds, PRIOR_F32_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (PRIOR_F32_STEPS + 1) * 1e3
    counts = kernel_counts()
    launches = {k: v for k, v in counts.items() if v}
    want = {"attention_bnhd_f32": PRIOR_F32_LAYERS,
            "decode_attention": PRIOR_F32_LAYERS * PRIOR_F32_STEPS,
            "cache_row_update": 2 * PRIOR_F32_STEPS}
    log(f"[prior32] prefill + {PRIOR_F32_STEPS} decode steps batch "
        f"{SAMPLE_BATCH}: {ms:.2f} ms a step (host clock, prefill counted "
        f"as a step), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}; fp32 B8 {F32_LAUNCHES['attention_bnhd']}")
    check(launches == want, f"fp32 prior launches {launches}, expected "
          f"{want}")
    check(bool(torch.isfinite(got).all()), "fp32 prior logits not finite")
    with plain_versions():
        want_logits = teacher_forced(gpt, codes, conds, PRIOR_F32_STEPS)
    agreement(f"fp32 prior, prefill + {PRIOR_F32_STEPS} decode steps batch "
              f"{SAMPLE_BATCH}, kernels vs plain", got, want_logits,
              PRIOR_F32_ATOL, PRIOR_F32_ARGMAX)
    del model, gpt, got, want_logits
    gc_cuda()
    return counts


def phase_main_path() -> tuple:
    """The tokenizer round trip through the public entry points; returns
    the launches, the batch-8 images and their bf16 kernel codes."""
    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    from enhancing_tpu_torch.ops import LAUNCHES, reset_launches
    log(f"[main] allow_tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    model = ViTVQ(dtype="bfloat16", seed=0, device="cuda", **BASE)
    log(f"[main] ViT-VQGAN-Base bf16 built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    images = {b: rng.random((b, 256, 256, 3), dtype=np.float32)
              for b in (1, CHECK_BATCH, TIME_BATCH)}
    inputs = {b: torch.from_numpy(x).cuda() for b, x in images.items()}
    torch.cuda.synchronize()

    reset_launches()
    outs = {}
    for b in (1, CHECK_BATCH, TIME_BATCH):
        codes = model.encode_codes(inputs[b])
        outs[b] = (codes, model.decode_codes(codes))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    trips = len(outs)
    log(f"[main] launches over {trips} round trips: {launches}; per round "
        f"trip {({k: v / trips for k, v in launches.items()})}")
    for name in LAUNCHES:
        want = trips * ROUND_TRIP.get(name, 0)
        check(launches[name] == want,
              f"{name}: {launches[name]} launches, expected {want}")

    for b, (codes, rec) in outs.items():
        check(codes.shape == (b, TOKENS) and codes.dtype == torch.int32,
              f"codes of batch {b}: {codes.shape} {codes.dtype}")
        check(bool(((codes >= 0) & (codes < CODES)).all()),
              f"codes of batch {b} out of range")
        check(rec.shape == (b, 256, 256, 3) and rec.dtype == torch.bfloat16,
              f"reconstruction of batch {b}: {rec.shape} {rec.dtype}")
        check(bool(torch.isfinite(rec).all()), f"batch {b}: non-finite")
    log("[main] requests of batch 1, 8, 128: codes int32 in [0, 8192), "
        "reconstructions finite (B, 256, 256, 3) bf16")

    # the plain path on the card, same weights, one small batch
    codes_k, rec_k = outs[CHECK_BATCH]
    before = dict(LAUNCHES)
    with plain_versions():
        codes_p = model.encode_codes(inputs[CHECK_BATCH])
        rec_p = model.decode_codes(codes_k)
    check(LAUNCHES == before, "the plain path launched a kernel")
    match = float((codes_k == codes_p).float().mean()) * 100
    rec_err = float((rec_k.float() - rec_p.float()).abs().max())
    rec_scale = float(rec_p.float().abs().max())
    log(f"[main] bf16 kernels vs bf16 plain, batch {CHECK_BATCH}: code match "
        f"{match:.3f}% (threshold 95%), reconstruction from the same codes "
        f"max_abs_err {rec_err:.4e} (|plain| max {rec_scale:.3f}, "
        f"threshold 0.1)")
    check(match >= 95.0, "bf16 kernel codes disagree with the plain path")
    check(rec_err <= 0.1, "reconstructions disagree with the plain path")

    torch.cuda.reset_peak_memory_stats()
    x = inputs[TIME_BATCH]
    for _ in range(2):
        model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] round trip batch {TIME_BATCH}: {dt * 1e3:.2f} ms, "
        f"{TIME_BATCH / dt:.1f} images/s, peak memory {peak / 2**30:.2f} GiB")
    profile_device(f"one round trip batch {TIME_BATCH}",
                   lambda: model.decode_codes(model.encode_codes(x)))
    return launches, inputs[CHECK_BATCH], codes_k


def phase_fused_serving() -> dict:
    """The tokenizer round trip with both of the JAX package's opt-in
    fusions: ENHANCING_TPU_ATTN_PROJ=1 and ``ffn_impl: fused`` in the
    encoder and decoder configs, through the public entry points."""
    import os

    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    from enhancing_tpu_torch.ops import LAUNCHES, reset_launches
    fused_cfg = dict(BASE, encoder=dict(BASE["encoder"], ffn_impl="fused"),
                     decoder=dict(BASE["decoder"], ffn_impl="fused"))
    t0 = time.perf_counter()
    model = ViTVQ(dtype="bfloat16", seed=0, device="cuda", **fused_cfg)
    default = ViTVQ(dtype="bfloat16", seed=0, device="cuda", **BASE)
    log(f"[fused] ViT-VQGAN-Base bf16 with ffn_impl 'fused', and the default"
        f" model from the same seed, built in {time.perf_counter() - t0:.1f}"
        " s")
    rng = np.random.default_rng(3)
    inputs = {b: torch.from_numpy(rng.random((b, 256, 256, 3),
                                             dtype=np.float32)).cuda()
              for b in (1, CHECK_BATCH, TIME_BATCH)}
    saved = os.environ.get("ENHANCING_TPU_ATTN_PROJ")
    os.environ["ENHANCING_TPU_ATTN_PROJ"] = "1"
    try:
        torch.cuda.synchronize()
        reset_launches()
        outs = {}
        for b in (1, CHECK_BATCH, TIME_BATCH):
            codes = model.encode_codes(inputs[b])
            outs[b] = (codes, model.decode_codes(codes))
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        trips = len(outs)
        log(f"[fused] launches over {trips} round trips: {launches}")
        want = {k: trips * FUSED_TRIP.get(k, 0) for k in LAUNCHES}
        check(launches == want, f"fused round trips: launches {launches}, "
              f"expected {want}")
        for b, (codes, rec) in outs.items():
            check(codes.shape == (b, TOKENS) and codes.dtype == torch.int32
                  and bool(((codes >= 0) & (codes < CODES)).all()),
                  f"fused codes of batch {b}: {codes.shape} {codes.dtype}")
            check(rec.shape == (b, 256, 256, 3)
                  and rec.dtype == torch.bfloat16
                  and bool(torch.isfinite(rec).all()),
                  f"fused reconstruction of batch {b}")
        log("[fused] requests of batch 1, 8, 128: codes int32 in [0, 8192),"
            " reconstructions finite (B, 256, 256, 3) bf16")

        # against the default path (its kernels), and against the plain
        # path on the same fused model: phase 5's limits
        codes_f, rec_f = outs[CHECK_BATCH]
        x8 = inputs[CHECK_BATCH]
        os.environ.pop("ENHANCING_TPU_ATTN_PROJ")
        codes_d = default.encode_codes(x8)
        rec_d = default.decode_codes(codes_f)
        os.environ["ENHANCING_TPU_ATTN_PROJ"] = "1"
        before = dict(LAUNCHES)
        with plain_versions():
            codes_p = model.encode_codes(x8)
            rec_p = model.decode_codes(codes_f)
        check(LAUNCHES == before, "the plain path launched a kernel")
        for label, codes_o, rec_o in (("the default path", codes_d, rec_d),
                                      ("the plain path", codes_p, rec_p)):
            match = float((codes_f == codes_o).float().mean()) * 100
            err = float((rec_f.float() - rec_o.float()).abs().max())
            log(f"[fused] batch {CHECK_BATCH}, fused kernels vs {label}: "
                f"code match {match:.3f}% (threshold 95%), reconstruction "
                f"from the same codes max_abs_err {err:.4e} (|other| max "
                f"{float(rec_o.float().abs().max()):.3f}, threshold 0.1)")
            check(match >= 95.0, f"fused codes disagree with {label}")
            check(err <= 0.1, f"fused reconstructions disagree with {label}")
        del default, rec_d, rec_p

        torch.cuda.reset_peak_memory_stats()
        x = inputs[TIME_BATCH]
        for _ in range(2):
            model.decode_codes(model.encode_codes(x))
        torch.cuda.synchronize()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            model.decode_codes(model.encode_codes(x))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        peak = torch.cuda.max_memory_allocated()
        log(f"[fused] round trip batch {TIME_BATCH}: {dt * 1e3:.2f} ms, "
            f"{TIME_BATCH / dt:.1f} images/s, peak memory "
            f"{peak / 2**30:.2f} GiB")
        profile_device(f"one fused round trip batch {TIME_BATCH}",
                       lambda: model.decode_codes(model.encode_codes(x)))
    finally:
        if saved is None:
            os.environ.pop("ENHANCING_TPU_ATTN_PROJ", None)
        else:
            os.environ["ENHANCING_TPU_ATTN_PROJ"] = saved
    del model
    gc_cuda()
    return launches


# the opt-in fusions in the shipped configs' own fp32, and where their
# routes (ops.attention.attn_proj_route, ops.ffn.ffn_route) send a block to
# the unfused form, a round trip at batch 8: imagenet_vitvq_small.yaml as
# shipped (fp32, 8 + 8 blocks of 512, 8 heads of 64, MLP 2048: every block
# on fp32 B15 and fp32 B16, csrc/attn_proj_f32.cu and csrc/ffn_f32.cu);
# ViT-VQGAN-Base in fp32 (fp32 B15; its FFN, 18.9 MB of fp32 weights, on
# two fp32 library products, as the JAX package computes it above 12 MiB);
# and imagenet_vitvq_large.yaml in bf16 with the decoder's heads of 80 (its
# 8 encoder blocks on B15, its 32 decoder blocks on B8 at D = 80 + the
# projection, unfused in the JAX package too; every FFN on B16):
# (launches, fp32 launches, unfused calls, the routes of each tower's
# attention -> to_out and FFN).
FUSED_ROUTES = {
    "small float32": ({"ln_gemm": 16, "attn_proj": 16, "layernorm": 18,
                       "ffn": 16, "vq": 1}, {"attn_proj": 16, "ffn": 16},
                      {"attn_proj": 0, "ffn": 0},
                      {"encoder": ("attn_proj", "ffn"),
                       "decoder": ("attn_proj", "ffn")}),
    "base float32": ({"ln_gemm": 24, "attn_proj": 24, "layernorm": 26,
                      "vq": 1}, {"attn_proj": 24},
                     {"attn_proj": 0, "ffn": 24},
                     {"encoder": ("attn_proj", "unfused"),
                      "decoder": ("attn_proj", "unfused")}),
    "large dec dim_head 80 bfloat16": (
        {"ln_gemm": 40, "attn_proj": 8, "attention_bnhd": 32,
         "layernorm": 42, "ffn": 40, "vq": 1}, {},
        {"attn_proj": 32, "ffn": 0},
        {"encoder": ("attn_proj", "ffn"), "decoder": ("unfused", "ffn")})}


def trip_ms(model, x, iters: int = 3) -> float:
    """Host ms of one encode_codes -> decode_codes round trip, after one
    warm-up trip."""
    model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_fused_routes(x8) -> dict:
    """Phase 9's fp32 and heads-of-80 fused round trips under
    ENHANCING_TPU_ATTN_PROJ=1 and ``ffn_impl: fused``: launches, fp32
    launches and unfused calls a trip asserted exactly, codes and
    reconstructions held to the plain path at phase 10's limits, the host
    time of a trip (in fp32 beside the same model's default trip: the same
    config and seed without the fusions, and the fused trip's device time
    by kernel group); each tower's routes asserted. Returns the launches
    by kernels-line name."""
    import os
    from pathlib import Path

    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    from enhancing_tpu_torch.ops import (F32_LAUNCHES, LAUNCHES,
                                         UNFUSED_CALLS, reset_launches)
    from enhancing_tpu_torch.ops.attention import attn_proj_route
    from enhancing_tpu_torch.ops.ffn import ffn_route
    from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                                  load_config)
    total: dict = {}
    saved = os.environ.get("ENHANCING_TPU_ATTN_PROJ")
    os.environ["ENHANCING_TPU_ATTN_PROJ"] = "1"
    try:
        for label, (want, want32, want_unf, want_routes) in \
                FUSED_ROUTES.items():
            gc_cuda()
            default = None
            if label.startswith("base"):
                cfg = dict(BASE, encoder=dict(BASE["encoder"],
                                              ffn_impl="fused"),
                           decoder=dict(BASE["decoder"], ffn_impl="fused"))
                model = ViTVQ(dtype="float32", seed=0, device="cuda", **cfg)
                default = ViTVQ(dtype="float32", seed=0, device="cuda",
                                **BASE)
                towers = cfg
            else:
                name = label.split()[0]
                cfg = load_config(Path(__file__).resolve().parent /
                                  "configs" / f"imagenet_vitvq_{name}.yaml")
                params = cfg.model.params
                if name == "large":
                    params["dtype"] = "bfloat16"
                    params.decoder["dim_head"] = D80
                else:
                    default = initialize_from_config(cfg.model,
                                                     device="cuda")
                for tower in (params.encoder, params.decoder):
                    tower["ffn_impl"] = "fused"
                model = initialize_from_config(cfg.model, device="cuda")
                towers = params
            dtype = str(model.dtype)[6:]
            routes = {
                name: (attn_proj_route(model.dtype, t["heads"],
                                       t.get("dim_head", 64), t["dim"],
                                       TOKENS, TOKENS),
                       ffn_route(model.dtype, CHECK_BATCH * TOKENS,
                                 t["dim"], t["mlp_dim"]))
                for name, t in (("encoder", towers["encoder"]),
                                ("decoder", towers["decoder"]))}
            log(f"[fused] {label}: routes (attention -> to_out, FFN) "
                f"{routes}")
            check(routes == want_routes,
                  f"{label}: routes {routes}, expected {want_routes}")
            torch.cuda.synchronize()
            reset_launches()
            codes = model.encode_codes(x8)
            rec = model.decode_codes(codes)
            torch.cuda.synchronize()
            got = {k: v for k, v in LAUNCHES.items() if v}
            got32 = {k: v for k, v in F32_LAUNCHES.items() if v}
            unf = dict(UNFUSED_CALLS)
            log(f"[fused] {label} batch {CHECK_BATCH}: launches a round trip "
                f"{got}, fp32 {got32}, unfused calls {unf}")
            check(got == want and got32 == want32 and unf == want_unf,
                  f"{label}: launches {got}, fp32 {got32}, unfused {unf}; "
                  f"expected {want}, {want32}, {want_unf}")
            for k, v in kernel_counts().items():
                total[k] = total.get(k, 0) + v
            check(codes.shape == (CHECK_BATCH, TOKENS)
                  and bool(((codes >= 0) & (codes < CODES)).all())
                  and bool(torch.isfinite(rec).all()),
                  f"{label}: codes {codes.shape}, reconstruction not finite")
            before = dict(LAUNCHES)
            with plain_versions():
                codes_p = model.encode_codes(x8)
                rec_p = model.decode_codes(codes)
            check(LAUNCHES == before, "the plain path launched a kernel")
            match = float((codes == codes_p).float().mean()) * 100
            err = float((rec.float() - rec_p.float()).abs().max())
            log(f"[fused] {label}, kernels vs plain: code match {match:.3f}% "
                f"(threshold {SHIPPED_MATCH[dtype]}%), reconstruction from "
                f"the same codes max_abs_err {err:.4e} (threshold "
                f"{SHIPPED_REC_ATOL[dtype]})")
            check(match >= SHIPPED_MATCH[dtype], f"{label}: codes disagree")
            check(err <= SHIPPED_REC_ATOL[dtype],
                  f"{label}: reconstructions disagree")
            trip = trip_ms(model, x8)
            if default is None:
                log(f"[fused] {label} round trip batch {CHECK_BATCH}: "
                    f"{trip:.2f} ms")
            else:
                os.environ.pop("ENHANCING_TPU_ATTN_PROJ")
                plain_trip = trip_ms(default, x8)
                os.environ["ENHANCING_TPU_ATTN_PROJ"] = "1"
                log(f"[fused] {label} round trip batch {CHECK_BATCH}: "
                    f"{trip:.2f} ms; the same model's default trip (same "
                    f"config and seed, no fusions) {plain_trip:.2f} ms")
                profile_device(f"one {label} fused round trip batch "
                               f"{CHECK_BATCH}", lambda: model.decode_codes(
                                   model.encode_codes(x8)))
            del model, default, codes, rec, codes_p, rec_p
    finally:
        if saved is None:
            os.environ.pop("ENHANCING_TPU_ATTN_PROJ", None)
        else:
            os.environ["ENHANCING_TPU_ATTN_PROJ"] = saved
    gc_cuda()
    return total


class StepRecorder:
    """The trainer's metrics logger: at each log call (after every step
    and once after validation) it keeps the launch counts (raw and by
    kernels-line name), the short-route attentions and plain-call counts,
    the host clock, the metrics and (given the trainer) the temperature
    of the last step."""

    def __init__(self, trainer=None) -> None:
        self.records: list = []
        self.trainer = trainer

    def log_metrics(self, metrics: dict, step: int) -> None:
        from enhancing_tpu_torch.ops import (LAUNCHES, PLAIN_CALLS,
                                             SHORT_CALLS)
        torch.cuda.synchronize()
        self.records.append(dict(step=step, t=time.perf_counter(),
                                 launches=dict(LAUNCHES),
                                 counts=kernel_counts(),
                                 short=SHORT_CALLS["attention_bnhd"],
                                 plain=dict(PLAIN_CALLS), metrics=metrics,
                                 temp=getattr(self.trainer, "last_temp",
                                              None)))


def one_step_grads(model, x, temp=None, key=None):
    """Losses and gradients of one AE phase and one D phase on the same
    batch and weights, without an update; a Gumbel tokenizer draws its
    noise on the card from a generator seeded with ``key`` (the same
    draws on either path) at ``temp``."""
    module, loss = model.module, model.loss
    ae_params = list(module.parameters())
    d_params = list(loss.discriminator.parameters())
    if key is None:
        xrec, qloss, _, codes = module.forward_training(x)
    else:
        xrec, qloss, _, codes = module.forward_training(
            x, temp, False, torch.Generator(device="cuda").manual_seed(key))
    ae_loss, glog = loss.generator_loss(qloss, x, xrec, 1.0)
    ae_grads = torch.autograd.grad(ae_loss, ae_params, allow_unused=True,
                                   materialize_grads=True)
    d_loss, dlog = loss.discriminator_loss(x, xrec.detach(), 1.0)
    d_grads = torch.autograd.grad(d_loss, d_params)
    logs = {k: float(v.detach()) for k, v in {**glog, **dlog}.items()}
    return logs, ae_grads, d_grads, codes


def worst_cosine(names, got, want):
    """(cosine, name) of the least aligned gradient tensor pair."""
    worst = (1.0, "")
    for name, a, b in zip(names, got, want):
        a, b = a.double().flatten(), b.double().flatten()
        na, nb = float(a.norm()), float(b.norm())
        if na == 0.0 and nb == 0.0:
            continue
        cos = float(a @ b) / (na * nb) if na and nb else 0.0
        worst = min(worst, (cos, name))
    return worst


# limits of the kernel path against the plain path on one training step,
# set from the first measurement on the card (largest loss difference
# 3.3e-4 relative, least gradient cosine AE 0.999997, D 0.99996; NVIDIA
# H100 80GB HBM3, 700 W) with a margin of 10-30x on 1 - cosine
LOSS_RTOL_LIMIT = 5e-3
AE_COS_LIMIT = 0.9999
D_COS_LIMIT = 0.999


def phase_train() -> dict:
    """ViT-VQGAN-Base GAN training through Trainer.fit."""
    from enhancing_tpu_torch.ops import (LAUNCHES, PLAIN_CALLS,
                                         reset_launches)
    from enhancing_tpu_torch.train import Trainer, make_vitvq_train_step
    from enhancing_tpu_torch.utils.config import initialize_from_config
    t0 = time.perf_counter()
    model = initialize_from_config(FAKE_VITVQ_BASE["model"], device="cuda")
    data = initialize_from_config(FAKE_VITVQ_BASE["dataset"])
    module, disc = model.module, model.loss.discriminator
    count = lambda mod: sum(p.numel() for p in mod.parameters())  # noqa: E731
    log(f"[train] fake_vitvq_base built in {time.perf_counter() - t0:.1f} s:"
        f" AE {count(module) / 1e6:.1f} M parameters (fp32, bf16 compute),"
        f" StyleGAN D at 256 px {count(disc) / 1e6:.1f} M (fp32), LPIPS "
        f"{count(model.loss.perceptual) / 1e6:.1f} M (random, frozen)")
    before = {"AE": [p.detach().clone() for p in module.parameters()],
              "D": [p.detach().clone() for p in disc.parameters()]}
    recorder = StepRecorder()
    trainer = Trainer(max_steps=TRAIN_STEPS, log_every=1,
                      metrics_logger=recorder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_fit = time.perf_counter()
    trainer.fit(model, data)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    n_val = -(-len(data.datasets["validation"]) // TRAIN_BATCH)
    check(len(recorder.records) == TRAIN_STEPS + 1,
          f"{len(recorder.records)} log calls, expected {TRAIN_STEPS} steps"
          " and one validation")
    prev = dict(t=t_fit, launches={k: 0 for k in LAUNCHES},
                plain={k: 0 for k in PLAIN_CALLS})
    step_ms = []
    for i, r in enumerate(recorder.records):
        got = {k: r["launches"][k] - prev["launches"][k] for k in LAUNCHES}
        plain = {k: r["plain"][k] - prev["plain"][k] for k in PLAIN_CALLS
                 if r["plain"][k] != prev["plain"][k]}
        ms = (r["t"] - prev["t"]) * 1e3
        if i < TRAIN_STEPS:
            label = f"step {i} ({'R1' if i == 0 else 'no R1'})"
            want, want_plain = TRAIN_STEP, (R1_PLAIN if i == 0 else {})
            step_ms.append(ms)
        else:
            label = f"validation ({n_val} batches)"
            want = {k: n_val * v for k, v in EVAL_STEP.items()}
            want_plain = {}
        want = {k: want.get(k, 0) for k in LAUNCHES}
        log(f"[train] {label}: {ms:.1f} ms, launches {got}, plain-routed "
            f"{plain}")
        check(got == want, f"{label}: launches {got}, expected {want}")
        check(plain == want_plain, f"{label}: plain-routed {plain}, "
              f"expected {want_plain}")
        bad = [k for k, v in r["metrics"].items() if not np.isfinite(v)]
        check(not bad, f"{label}: non-finite {bad}")
        prev = r
    for group, params in (("AE", module.parameters()),
                          ("D", disc.parameters())):
        moved = sum(not torch.equal(p, q) for p, q in zip(params,
                                                          before[group]))
        log(f"[train] {group}: {moved} of {len(before[group])} parameter "
            "tensors moved")
        check(moved == len(before[group]), f"{group} parameters did not move")
    last = recorder.records[TRAIN_STEPS - 1]["metrics"]
    steady = float(np.mean(step_ms[1:]))
    log(f"[train] after {TRAIN_STEPS} steps: "
        + " ".join(f"{k}={v:.5g}" for k, v in sorted(last.items())))
    log(f"[train] code perplexity {last['train/code_perplexity']:.2f} "
        f"({last['train/codes_used']:.0f} codes used); step 0 (R1, first "
        f"calls) {step_ms[0]:.1f} ms, steps 1-{TRAIN_STEPS - 1} mean "
        f"{steady:.1f} ms = {TRAIN_BATCH / steady * 1e3:.2f} images/s, peak "
        f"memory {peak / 2**30:.2f} GiB (wall clock around each step, "
        "logging included)")

    # one step's losses and gradients: kernels against the plain path
    x = model.get_input(next(iter(data.val_dataloader())), "image")
    module.train()
    k_logs, k_ae, k_d, k_codes = one_step_grads(model, x)
    mid = dict(LAUNCHES)
    with plain_versions():
        p_logs, p_ae, p_d, p_codes = one_step_grads(model, x)
    check(LAUNCHES == mid, "the plain path launched a kernel")
    module.eval()
    rel = {k: abs(k_logs[k] - p_logs[k]) / max(abs(p_logs[k]), 1e-6)
           for k in p_logs}
    log("[train] one step, bf16 kernels vs bf16 plain: " + "; ".join(
        f"{k} {k_logs[k]:.6g} vs {p_logs[k]:.6g}" for k in sorted(p_logs)))
    worst_loss = max(rel.items(), key=lambda kv: kv[1])
    ae_cos = worst_cosine([n for n, _ in module.named_parameters()], k_ae,
                          p_ae)
    d_cos = worst_cosine([n for n, _ in disc.named_parameters()], k_d, p_d)
    match = float((k_codes == p_codes).float().mean()) * 100
    log(f"[train] code match {match:.3f}%; largest loss difference "
        f"{worst_loss[1]:.3e} relative ({worst_loss[0]}; limit "
        f"{LOSS_RTOL_LIMIT}); least gradient cosine AE {ae_cos[0]:.6f} "
        f"({ae_cos[1]}; limit {AE_COS_LIMIT}), D {d_cos[0]:.6f} "
        f"({d_cos[1]}; limit {D_COS_LIMIT})")
    check(worst_loss[1] <= LOSS_RTOL_LIMIT, "losses disagree with the plain "
          "path")
    check(ae_cos[0] >= AE_COS_LIMIT, "AE gradients disagree with the plain "
          "path")
    check(d_cos[0] >= D_COS_LIMIT, "D gradients disagree with the plain "
          "path")
    del k_ae, k_d, p_ae, p_d

    step = make_vitvq_train_step(model, model.loss)
    module.train()
    profile_device(f"one training step (no R1) batch {TRAIN_BATCH}",
                   lambda: step(trainer.final_state, x, do_r1=False))
    module.eval()
    return launches


# limits of phase 7: the sampler's step logits (B9 + B10) against the
# teacher-forced full forward (B8) on the sampled codes, and the kernel
# path against the plain path. bf16 roundings at other places (GEMMs at
# other row counts, P in B8, the weights in B9's plain version) compound
# over 24 layers; the logits, up to ~9, have a bf16 spacing of 2^-5 there.
# Set from the first measurement on the card (largest differences 0.148,
# 0.141 and 0.156; argmax equal at 96.3-97.0% of positions, the rest
# near-ties of random weights; NVIDIA H100 80GB HBM3, 700 W) with a margin
# of 3x on the difference.
STEP_VS_FULL_ATOL, STEP_VS_FULL_ARGMAX = 0.5, 0.9
KERNEL_VS_PLAIN_ATOL, KERNEL_VS_PLAIN_ARGMAX = 0.5, 0.9


def sampling_model():
    """The prior and the tokenizer of the config with ``dtype: bfloat16``,
    every weight drawn on the card: the prior's GEMM weights in bf16, the
    dtype they are used in, its embeddings and LayerNorms in fp32."""
    from enhancing_tpu_torch.utils.config import initialize_from_config
    cfg = json.loads(json.dumps(GPT_VITVQ_BASE))
    cfg["params"]["dtype"] = "bfloat16"
    cfg["params"]["stage1"]["params"]["dtype"] = "bfloat16"
    return initialize_from_config(cfg, device="cuda")


def teacher_forced(gpt, codes, conds, steps):
    """Prefill + ``steps`` decode steps fed the given codes: (B, 1 + steps,
    V) fp32 logits."""
    with torch.inference_mode():
        cache = gpt.init_cache(codes.shape[0])
        logits, cache = gpt.prefill(conds, cache)
        out = [logits]
        for step in range(1, steps + 1):
            logits, cache = gpt.decode_step(codes[:, step - 1], step, cache)
            out.append(logits)
    return torch.stack(out, 1).float()


def full_forward(gpt, codes, conds):
    with torch.inference_mode():
        return gpt(codes, conds).float()


def agreement(label, got, want, atol, argmax_min) -> float:
    err = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"[sample] {label}: logits max_abs_diff {err:.4e} (|logits| max "
        f"{float(want.abs().max()):.3f}; limit {atol}), argmax equal at "
        f"{agree:.2%} of positions (limit {argmax_min:.0%})")
    check(err <= atol and agree >= argmax_min, f"{label}: disagree")
    return err


def phase_sampling():
    """Class-conditional sampling of the published GPT prior; returns the
    launches, the model (for phase 8) and the sampled codes."""
    from enhancing_tpu_torch.models.stage2.sampling import sample_gpt
    from enhancing_tpu_torch.ops import LAUNCHES, reset_launches
    gc_cuda()
    t0 = time.perf_counter()
    model = sampling_model()
    gpt = model.transformer
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in gpt.parameters())
    # the bytes a decode step reads: every parameter but the embedding
    # tables, of which it reads one row each
    w_bytes = sum(p.numel() * p.element_size() for name, p in
                  gpt.named_parameters() if not name.startswith(
                      ("tok_emb", "pos_emb")))
    log(f"[sample] prior {P_LAYERS} x {P_WIDTH}, {P_HEADS} heads of "
        f"{P_HEAD_DIM}, built on the card in {time.perf_counter() - t0:.1f} "
        f"s: {n_params / 1e9:.3f} G parameters, {w_bytes / 1e9:.2f} GB read "
        f"per decode step (bf16 GEMM weights); allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    conds = torch.tensor(CLASSES, device="cuda")[:, None]

    # (a) the entry point, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pixels, codes = model.sample(conds, top_k=100, seed=0,
                                 return_codes=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {k: SAMPLE_CALL.get(k, 0) for k in LAUNCHES}
    log(f"[sample] CondTransformer.sample(8 classes, top_k=100): {dt:.2f} s,"
        f" launches {launches}")
    check(launches == want, f"sample launches {launches}, expected {want}")
    check(codes.shape == (SAMPLE_BATCH, 1024) and codes.dtype == torch.int32,
          f"codes {codes.shape} {codes.dtype}")
    check(bool(((codes >= 0) & (codes < P_VOCAB)).all()), "codes range")
    check(pixels.shape == (SAMPLE_BATCH, 256, 256, 3), f"{pixels.shape}")
    check(bool(torch.isfinite(pixels).all()) and float(pixels.min()) >= 0.0
          and float(pixels.max()) <= 1.0, "pixels not finite in [0, 1]")
    _, codes_1 = model.sample(conds, top_k=100, seed=1, return_codes=True)
    differ = float((codes_1 != codes).float().mean())
    log(f"[sample] codes int32 in [0, {P_VOCAB}), pixels finite in [0, 1]; "
        f"seed 1 differs from seed 0 at {differ:.2%} of codes; "
        f"{len(torch.unique(codes))} distinct codes")
    check(differ > 0.5, "two seeds gave (nearly) the same codes")

    # the sampler alone: prefill + 1023 steps, timed on the host clock
    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, codes_s = sample_gpt(gpt, conds, gen, top_k=100,
                                 with_logits=True)
    torch.cuda.synchronize()
    t_sampler = time.perf_counter() - t0
    log(f"[sample] sample_gpt with seed 0 repeats CondTransformer.sample's"
        f" codes: {bool(torch.equal(codes_s, codes))}")
    step_ms = t_sampler / (P_STEPS + 1) * 1e3
    cache_bytes = 2 * P_LAYERS * SAMPLE_BATCH * 512 * P_WIDTH * 2
    step_bound = (w_bytes + cache_bytes) / PEAK_BYTES * 1e3
    tokens = SAMPLE_BATCH * 1024
    log(f"[sample] end to end {tokens / dt:.1f} tokens/s, "
        f"{SAMPLE_BATCH / dt:.3f} images/s ({dt:.2f} s per call); sampler "
        f"alone {t_sampler:.2f} s = {step_ms:.3f} ms per token step "
        f"(prefill counted as a step); bound {step_bound:.3f} ms per step "
        f"({(w_bytes + cache_bytes) / 1e9:.2f} GB: weights + the mean "
        f"cache read at cur_len 512) -> {step_bound / step_ms:.1%} of "
        f"3.35 TB/s; peak memory {peak / 2**30:.2f} GiB")

    # (b) B9 + B10 against B8 at full length
    full = full_forward(gpt, codes_s, conds)
    agreement("sampler step logits vs teacher-forced full forward, 8 x 1024",
              logits, full, STEP_VS_FULL_ATOL, STEP_VS_FULL_ARGMAX)
    del logits, full

    # (c) the kernels against the plain path
    before = dict(LAUNCHES)
    k_full = full_forward(gpt, codes[:2], conds[:2])
    k_dec = teacher_forced(gpt, codes[:2], conds[:2], 32)
    with plain_versions():
        p_full = full_forward(gpt, codes[:2], conds[:2])
        p_dec = teacher_forced(gpt, codes[:2], conds[:2], 32)
    check(LAUNCHES["attention_bnhd"] == before["attention_bnhd"] + 2 * P_LAYERS
          and LAUNCHES["decode_attention"] == before["decode_attention"]
          + 32 * P_LAYERS, "the plain path launched a kernel")
    agreement("full forward batch 2, kernels vs plain", k_full, p_full,
              KERNEL_VS_PLAIN_ATOL, KERNEL_VS_PLAIN_ARGMAX)
    agreement("prefill + 32 decode steps batch 2, kernels vs plain", k_dec,
              p_dec, KERNEL_VS_PLAIN_ATOL, KERNEL_VS_PLAIN_ARGMAX)
    del k_full, p_full, k_dec, p_dec

    # (d) one decode step at cur_len 512: host clock over 20 steps, then
    # its device time by kernel group; the idle share is read against the
    # unprofiled step, since the profiler slows the host
    with torch.inference_mode():
        cache = gpt.init_cache(SAMPLE_BATCH)
        tok = codes[:, 0]
        for _ in range(2):
            gpt.decode_step(tok, 512, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            gpt.decode_step(tok, 512, cache)
        torch.cuda.synchronize()
        step_512 = (time.perf_counter() - t0) / 20 * 1e3
        busy = profile_device(f"one decode step batch {SAMPLE_BATCH} at "
                              "cur_len 512",
                              lambda: gpt.decode_step(tok, 512, cache))
    if busy is not None:
        log(f"[sample] decode step at cur_len 512: {step_512:.3f} ms on the "
            f"host clock, device busy {busy:.3f} ms -> device idle "
            f"{1 - busy / step_512:.1%} of the unprofiled step")
    del cache, gpt
    gc_cuda()
    return launches, model, codes


# limits of phase 8. int8 against bf16 (the same weights before and after
# quantisation, teacher-forced): argmax equal on more than half of the
# positions, the JAX package's own bar (tests/test_stage2.py:355). The
# LNFUSE path against the default one: phase 7's limits (bf16 GEMMs and
# fp32 LNFUSE products round at other places). The int8 kernels against
# the int8 plain path: fp32 products in another order, which move a cache
# row's int8 rounding now and then; set from the first measurement on the
# card (0.0174, argmax equal at 99.62%: one position of 264; NVIDIA H100
# 80GB HBM3, 700 W) with a margin of 3x on the difference.
INT8_VS_BF16_ARGMAX = 0.5
INT8_KERNEL_VS_PLAIN_ATOL, INT8_KERNEL_VS_PLAIN_ARGMAX = 0.05, 0.97


def counted(fn):
    """(fn(), the launches it made)."""
    from enhancing_tpu_torch.ops import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in LAUNCHES.items() if v}


def phase_int8(model, codes7) -> dict:
    """Int8 serving of phase 7's prior, as the JAX package's
    ``scripts/serve_continuous.py --int8`` builds it (quantize, drop,
    kv_int8)."""
    import os
    from enhancing_tpu_torch.models.stage2 import (drop_quantized_kernels,
                                                   quantize_decode_params)
    from enhancing_tpu_torch.models.stage2.sampling import sample_gpt
    from enhancing_tpu_torch.ops import LAUNCHES, reset_launches
    gpt = model.transformer
    conds = torch.tensor(CLASSES, device="cuda")[:, None]
    steps = CHECK_STEPS

    # (a) the bf16 prior, default decode and LNFUSE=all (host clock of
    # each, prefill counted as a step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref16 = teacher_forced(gpt, codes7, conds, steps)
    torch.cuda.synchronize()
    t_default = (time.perf_counter() - t0) / (steps + 1) * 1e3
    os.environ["ENHANCING_TPU_DECODE_LNFUSE"] = "all"
    try:
        t0 = time.perf_counter()
        fused, lnfuse = counted(
            lambda: teacher_forced(gpt, codes7, conds, steps))
        t_fused = (time.perf_counter() - t0) / (steps + 1) * 1e3
        lnfuse_counts = kernel_counts()
        # one LNFUSE step at cur_len 512 by kernel group, and its weight
        # casts: the mlp's p1 (a cuBLAS product's operand) is cast, p0 and
        # the head go to B1 as stored
        with torch.inference_mode():
            cache = gpt.init_cache(SAMPLE_BATCH)
            tok = codes7[:, 0]
            gpt.decode_step(tok, 512, cache)
            profile_device(f"one LNFUSE decode step batch {SAMPLE_BATCH} at "
                           "cur_len 512",
                           lambda: gpt.decode_step(tok, 512, cache))
            casts = copy_kernels(lambda: gpt.decode_step(tok, 512, cache))
        del cache
        log(f"[int8] LNFUSE decode step: {casts[0]} copy kernels, "
            f"{casts[1]:.3f} device ms (the {P_LAYERS} layers' p1 casts "
            "expected; no cast of p0 or the head)")
    finally:
        del os.environ["ENHANCING_TPU_DECODE_LNFUSE"]
    # the prefill runs no LNFUSE site: its launches are the default ones
    want = {k: steps * v for k, v in LNFUSE_STEP.items()}
    want["attention_bnhd"] = P_LAYERS
    log(f"[int8] LNFUSE=all, prefill + {steps} decode steps batch "
        f"{SAMPLE_BATCH}: {t_fused:.3f} ms a step against the default "
        f"decode's {t_default:.3f} (host clock); launches {lnfuse}")
    check(lnfuse == want, f"LNFUSE launches {lnfuse}, expected {want}")
    agreement(f"LNFUSE=all vs default decode, prefill + {steps} steps",
              fused, ref16, STEP_VS_FULL_ATOL, STEP_VS_FULL_ARGMAX)
    del fused

    # (b) quantise; int8 against bf16 while the bf16 weights exist
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    quantize_decode_params(gpt)
    torch.cuda.synchronize()
    twins = torch.cuda.memory_allocated() - before
    log(f"[int8] quantize_decode_params: {time.perf_counter() - t0:.2f} s, "
        f"int8 twins {twins / 2**30:.2f} GiB")
    q_logits = teacher_forced(gpt, codes7, conds, steps)
    agree = float((q_logits.argmax(-1) == ref16.argmax(-1)).float().mean())
    err = float((q_logits - ref16).abs().max())
    log(f"[int8] int8 weights vs bf16 weights, teacher-forced on phase 7's "
        f"codes, prefill + {steps} steps: argmax equal at {agree:.2%} "
        f"(limit > {INT8_VS_BF16_ARGMAX:.0%}), logits max_abs_diff "
        f"{err:.4f} (|logits| max {float(ref16.abs().max()):.3f})")
    check(agree > INT8_VS_BF16_ARGMAX, "int8 and bf16 argmax disagree")
    del q_logits, ref16

    # (c) drop the bf16 weights, int8 cache
    gc_cuda()
    before = torch.cuda.memory_allocated()
    freed = drop_quantized_kernels(gpt)
    gc_cuda()
    log(f"[int8] drop_quantized_kernels freed {freed / 2**30:.2f} GiB of "
        f"bf16 GEMM weights; allocated {before / 2**30:.2f} -> "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    check(before - torch.cuda.memory_allocated() >= freed,
          "the dropped weights were not freed")
    # as serve_continuous.py's tfm.clone(kv_int8=True): the cache that
    # init_cache makes from now on is int8
    gpt.kv_int8 = True
    w_bytes = sum(t.numel() * t.element_size() for name, t in
                  list(gpt.named_parameters()) + list(gpt.named_buffers())
                  if not name.startswith(("tok_emb", "pos_emb"))
                  and not (name.endswith(("weight_q", "scale"))
                           and ".attn." in name
                           and name.split(".")[-2] in ("query", "key",
                                                       "value")))
    cache_bytes = 2 * P_LAYERS * SAMPLE_BATCH * 512 * (P_WIDTH + 4)
    step_bound = (w_bytes + cache_bytes) / PEAK_BYTES * 1e3

    # (d) the entry point, counted
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pixels, codes = model.sample(conds, top_k=100, seed=0, return_codes=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {k: INT8_SAMPLE_CALL.get(k, 0) for k in LAUNCHES}
    log(f"[int8] CondTransformer.sample(8 classes, top_k=100), int8 weights"
        f" and cache: {dt:.2f} s, launches {launches}")
    check(launches == want, f"int8 sample launches {launches}, expected "
          f"{want}")
    check(codes.shape == (SAMPLE_BATCH, 1024) and codes.dtype == torch.int32,
          f"codes {codes.shape} {codes.dtype}")
    check(bool(((codes >= 0) & (codes < P_VOCAB)).all()), "codes range")
    check(bool(torch.isfinite(pixels).all()) and float(pixels.min()) >= 0.0
          and float(pixels.max()) <= 1.0, "pixels not finite in [0, 1]")
    match7 = float((codes == codes7).float().mean())
    log(f"[int8] codes int32 in [0, {P_VOCAB}), pixels finite in [0, 1]; "
        f"{len(torch.unique(codes))} distinct codes; equal to phase 7's bf16"
        f" sample (same seed) at {match7:.2%}")

    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_gpt(gpt, conds, gen, top_k=100, with_logits=False)
    torch.cuda.synchronize()
    t_sampler = time.perf_counter() - t0
    step_ms = t_sampler / (P_STEPS + 1) * 1e3
    tokens = SAMPLE_BATCH * 1024
    log(f"[int8] end to end {tokens / dt:.1f} tokens/s, "
        f"{SAMPLE_BATCH / dt:.3f} images/s ({dt:.2f} s per call); sampler "
        f"alone {t_sampler:.2f} s = {step_ms:.3f} ms per token step; bound "
        f"{step_bound:.3f} ms per step ({(w_bytes + cache_bytes) / 1e9:.2f} "
        f"GB: int8 weights, scales and the rest + the mean int8 cache read "
        f"at cur_len 512) -> {step_bound / step_ms:.1%} of 3.35 TB/s; peak "
        f"memory {peak / 2**30:.2f} GiB")

    # (e) the kernels against the plain path, 32 steps of the int8 model
    k_dec = teacher_forced(gpt, codes[:, :steps + 1], conds, steps)
    mid = dict(LAUNCHES)
    with plain_versions():
        p_dec = teacher_forced(gpt, codes[:, :steps + 1], conds, steps)
    check(LAUNCHES == mid, "the plain path launched a kernel")
    agreement(f"int8 prefill + {steps} decode steps batch {SAMPLE_BATCH}, "
              "kernels vs plain", k_dec, p_dec, INT8_KERNEL_VS_PLAIN_ATOL,
              INT8_KERNEL_VS_PLAIN_ARGMAX)
    del k_dec, p_dec

    # (f) one decode step at cur_len 512
    with torch.inference_mode():
        cache = gpt.init_cache(SAMPLE_BATCH)
        tok = codes[:, 0]
        for _ in range(2):
            gpt.decode_step(tok, 512, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            gpt.decode_step(tok, 512, cache)
        torch.cuda.synchronize()
        step_512 = (time.perf_counter() - t0) / 20 * 1e3
        busy = profile_device(f"one int8 decode step batch {SAMPLE_BATCH} at "
                              "cur_len 512",
                              lambda: gpt.decode_step(tok, 512, cache))
    if busy is not None:
        log(f"[int8] decode step at cur_len 512: {step_512:.3f} ms on the "
            f"host clock (bound {step_bound:.3f} ms), device busy "
            f"{busy:.3f} ms -> device idle {1 - busy / step_512:.1%} of the "
            "unprofiled step")
    del cache, gpt, model
    gc_cuda()
    # the kernels line counts both paths: the int8 sample and the LNFUSE
    # decode (B11's only path)
    return {k: launches.get(k, 0) + lnfuse_counts.get(k, 0)
            for k in set(launches) | set(lnfuse_counts)}


def gc_cuda() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


# kernel-name fragments -> the group of device time they belong to
KERNEL_GROUPS = (("attn_proj_kernel", "attn_proj"), ("ffn_kernel", "ffn"),
                 ("attn_proj_f32", "attn_proj f32"), ("ffn_f32", "ffn f32"),
                 ("attn_f32_fwd", "attention f32"),
                 ("attn_f32_wide", "attention f32"),
                 ("attn_f32_bwd", "attention_bwd f32"),
                 ("f32_split", "fp32 split pass"),
                 ("int8_ln_gemm_kernel", "int8_ln_gemm"),
                 ("ln_shift_gemm_kernel", "ln_shift_gemm"),
                 ("ln_gemm_stats_kernel<float", "ln_gemm f32"),
                 ("ln_gemm_f32", "ln_gemm f32"),
                 ("int8_gemm_kernel", "int8_gemm"),
                 ("mlp_kernel", "int8_mlp"),
                 ("attn_bwd", "attention_bwd"),
                 ("attn_wide", "attention_bnhd"),
                 ("decode_kernel", "decode_attention"),
                 ("row_write", "cache_row_update"),
                 ("layer_norm", "LayerNorm (PyTorch)"),
                 ("gemv", "cuBLAS"), ("ln_gemm", "ln_gemm"),
                 ("attn_fwd", "attention"), ("layernorm_kernel", "layernorm"),
                 ("vq_nearest", "vq"), ("vq_split", "vq"),
                 ("fir_kernel", "fir"),
                 ("fused_act", "fused_act"),
                 # depthwise convolutions, what autograd of the blur's
                 # plain version runs (its forward again, then the dgrad)
                 ("conv2d_grouped_direct", "depthwise conv"),
                 ("dgrad2d_c1_k1", "depthwise conv"),
                 ("conv", "cuDNN conv"),
                 ("dgrad", "cuDNN conv"), ("wgrad", "cuDNN conv"),
                 ("implicit", "cuDNN conv"), ("gemm", "cuBLAS"),
                 ("xmma", "cuBLAS"), ("cutlass", "cuBLAS"),
                 ("nvjet", "cuBLAS"), ("multi_tensor", "optimizer"),
                 ("elementwise", "elementwise"), ("reduce", "reductions"))


def copy_kernels(fn) -> tuple:
    """(number, device ms) of the copy kernels (casts among them) that one
    call of ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "copy" in e.key]
    return (sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3)


def profile_device(label: str, fn):
    """Device time by kernel group over one call of ``fn``,
    torch.profiler; returns the device's busy ms, None if not measured."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    others = []
    for event in prof.key_averages():
        # a user annotation's GPU range (the optimizer's step) spans
        # kernels that are counted on their own
        if (event.device_type != torch.autograd.DeviceType.CUDA
                or getattr(event, "is_user_annotation", False)
                or event.key.startswith("Optimizer.")):
            continue
        ms = event.self_device_time_total / 1e3
        group = next((g for frag, g in KERNEL_GROUPS if frag in event.key),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
        if group == "other":
            others.append((ms, event.key[:60]))
    busy = sum(groups.values())
    if busy == 0:
        log("[profile] no device time in the trace: not measured")
        return None
    shares = ", ".join(f"{g} {ms:.2f} ms ({ms / busy:.1%})" for g, ms in
                       sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"[profile] {label}: device busy {busy:.2f} ms of {wall_ms:.2f} ms "
        f"wall under the profiler (idle {1 - busy / wall_ms:.1%}); {shares}")
    log("[profile] largest 'other' kernels: " + "; ".join(
        f"{name} {ms:.2f} ms" for ms, name in sorted(others)[::-1][:4]))
    return busy


# -- training the prior at its published widths -------------------------------

# configs/imagenet_gpt_vitvq_base.yaml's prior trained through Trainer.fit
# at full width (6144, 16 heads of 384, 8192 codes, 1 + 1024 tokens) over
# its frozen ViT-VQGAN-Base tokenizer (fp32, the config's dtype; random
# weights): 453 M parameters a layer hold 7.25 GB of training state (an
# fp32 master weight, its gradient and two Adam moments), 174 GB at the
# config's 24 layers, so the depth is cut to fit one 80 GB card beside a
# plain reference step: (prior dtype, layers, steps)
PRIOR_RUNS = (("bfloat16", 4, 3), ("float32", 2, 1))
PRIOR_DEPTH_REASON = ("7.25 GB of training state a layer (453 M fp32 master "
                      "weights, gradients and two Adam moments)")


def prior_train_config(dtype: str, layers: int) -> dict:
    """The config's model and a FakeImages dataset in place of ImageNet
    (256 px, 1000 classes, the config's batch 4): the prior's dtype and
    depth are the only changes to the model (and no stage-1 path: the
    released weights are not in the repository)."""
    model = json.loads(json.dumps(GPT_VITVQ_BASE))
    prior = model["params"]["transformer"]["params"]
    prior["n_layers"], prior["dtype"] = layers, dtype
    return {"model": model, "dataset": fake_imagenet(PRIOR_TRAIN_BATCH)}


def fake_imagenet(batch: int) -> dict:
    """A FakeImages dataset in place of ImageNet: 256 px, 1000 classes, a
    validation split of one batch."""
    fake = {"target": _FAKE, "params": {"resolution": 256,
                                        "num_classes": 1000}}
    return {"target": "enhancing_tpu_torch.data.DataModuleFromConfig",
            "params": {"batch_size": batch, "num_workers": 2,
                       "train": {**fake, "params": {**fake["params"],
                                                    "length": 64, "seed": 1}},
                       "validation": {**fake, "params": {
                           **fake["params"], "length": batch, "seed": 2}}}}


def prior_step_launches(dtype: str, layers: int, backward: bool) -> dict:
    """Launches a prior step (backward) or validation batch makes, by
    kernels-line name: the frozen fp32 tokenizer's encode (fp32 B1 24, fp32
    B2 12, B3 1, B4 1), then B8 once a layer and B5 once a layer at D =
    384."""
    f32 = "_f32" if dtype == "float32" else ""
    want = {"ln_gemm_f32": 24, "attention_f32": 12, "layernorm": 1, "vq": 1,
            "attention_bnhd" + f32: layers}
    if backward:
        want["attention_bwd_wide" + f32] = layers
    return want


# Every layer's key bias adds one vector to every key, which moves each
# score row by a constant, which the softmax removes: its gradient is zero
# in exact arithmetic, and both paths return rounding residue, whose
# cosine means nothing. Those leaves are held instead to a small fraction
# of the gradient norm of the same layer's query bias (bf16, fp32).
# Set from the first measurement on the card (4.3e-4 bf16, 1.1e-6 fp32;
# NVIDIA H100 80GB HBM3, 700 W) with a margin of about 25x.
PRIOR_KEY_BIAS_LIMIT = (1e-2, 3e-5)


def prior_agreement(names, got, want):
    """The leaves' gradient cosines, least first, but the key biases'; and
    (the largest norm of a key bias's gradient on either path over its
    layer's query-bias gradient norm, that key bias)."""
    grads = dict(zip(names, zip(got, want)))
    cosines, bias = [], (0.0, "")
    for name, (a, b) in grads.items():
        if name.endswith("attn.key.bias"):
            ref = float(grads[name.replace("key", "query")][1].norm())
            ratio = max(float(a.norm()), float(b.norm())) / ref
            bias = max(bias, (ratio, name))
            continue
        cosines.append(worst_cosine([name], [a], [b]))
    return sorted(cosines), bias


def prior_grads(model, codes, conds):
    """The prior's loss and per-parameter gradients on one batch of codes,
    without an update."""
    params = list(model.transformer.parameters())
    loss = model.loss_fn(codes, conds)
    return float(loss.detach()), torch.autograd.grad(loss, params)


def phase_prior_train() -> dict:
    """PRIOR_RUNS through Trainer.fit (:func:`train_prior`)."""
    total: dict = {}
    for dtype, layers, steps in PRIOR_RUNS:
        counts = train_prior(
            f"[prior-train {dtype[:4]}]", prior_train_config(dtype, layers),
            dtype, steps,
            lambda backward: prior_step_launches(  # noqa: B023
                dtype, layers, backward), 0,
            f"imagenet_gpt_vitvq_base.yaml: n_layers 24 -> {layers} "
            f"({PRIOR_DEPTH_REASON}); width {P_WIDTH}, {P_HEADS} heads of "
            f"{P_HEAD_DIM}, {P_VOCAB} codes, {P_CTX} tokens; prior compute "
            f"{dtype}, fp32 master weights; frozen ViT-VQGAN-Base tokenizer "
            f"fp32, random weights; FakeImages 256 px, 1000 classes, batch "
            f"{PRIOR_TRAIN_BATCH}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def train_prior(tag, cfg, dtype, steps, launches, short, what) -> dict:
    """One prior (``cfg``: the config's model with the prior's ``dtype``, and
    a dataset) through Trainer.fit: first one step's loss and gradients
    through the kernels against the plain path from the same weights and
    codes (the tokenizer's, through its kernels, encoded once); then
    ``steps`` steps and a validation batch with their launches asserted
    exactly (``launches(backward)`` by kernels-line name, and ``short``
    short-route attentions each), finite losses, every prior parameter
    moved, ms a step and peak memory, one more step's device time by
    group. Returns the launches of the steps and the validation."""
    from enhancing_tpu_torch.models.stage2 import fp32_master_weights
    from enhancing_tpu_torch.ops import reset_launches
    from enhancing_tpu_torch.train import (Trainer,
                                           make_cond_transformer_train_step)
    from enhancing_tpu_torch.utils.config import initialize_from_config
    limits = {"bfloat16": (LOSS_RTOL_LIMIT, 0.999, PRIOR_KEY_BIAS_LIMIT[0]),
              "float32": (F32_LOSS_RTOL_LIMIT, F32_COS_LIMIT,
                          PRIOR_KEY_BIAS_LIMIT[1])}
    gc_cuda()
    t0 = time.perf_counter()
    model = initialize_from_config(cfg["model"], device="cuda")
    data = initialize_from_config(cfg["dataset"])
    data.setup()
    prior = fp32_master_weights(model.transformer)
    names = [n for n, _ in prior.named_parameters()]
    n_params = sum(p.numel() for p in prior.parameters())
    log(f"{tag} {what}; {n_params / 1e9:.3f} G prior parameters; built in "
        f"{time.perf_counter() - t0:.1f} s")

    # one step's loss and gradients, kernels against the plain path, on
    # the same weights and codes (the tokenizer's, through its kernels)
    batch = next(iter(data.train_dataloader()))
    stage1 = model.stage1_model
    codes = stage1.encode_codes(stage1.get_input(batch, "image")).clone()
    conds = model.condition_codes(batch)
    k_loss, k_grads = prior_grads(model, codes, conds)
    with plain_versions():
        p_loss, p_grads = prior_grads(model, codes, conds)
    rel = abs(k_loss - p_loss) / abs(p_loss)
    loss_lim, cos_lim, bias_lim = limits[dtype]
    cos, bias = prior_agreement(names, k_grads, p_grads)
    log(f"{tag} one step, kernels vs plain: loss {k_loss:.6f} vs "
        f"{p_loss:.6f} ({rel:.3e} relative, limit {loss_lim}); least "
        f"gradient cosine {cos[0][0]:.7f} ({cos[0][1]}; limit {cos_lim})"
        f" over {len(cos)} leaves, next "
        + ", ".join(f"{c:.7f} ({n})" for c, n in cos[1:4])
        + f"; key biases (zero in exact arithmetic): largest |grad| "
        f"{bias[0]:.3e} of the layer's query-bias |grad| ({bias[1]}; "
        f"limit {bias_lim})")
    check(rel <= loss_lim, f"{tag} loss disagrees with the plain path")
    check(cos[0][0] >= cos_lim, f"{tag} gradients disagree with the "
          "plain path")
    check(bias[0] <= bias_lim, f"{tag} key-bias gradients not near 0")
    del k_grads, p_grads
    gc_cuda()

    before = [p.detach().clone() for p in prior.parameters()]
    recorder = StepRecorder()
    trainer = Trainer(max_steps=steps, log_every=1, metrics_logger=recorder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    prev = dict(t=time.perf_counter(), counts=kernel_counts(), short=0)
    trainer.fit(model, data)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(len(recorder.records) == steps + 1,
          f"{tag} {len(recorder.records)} log calls, expected {steps} "
          "steps and one validation")
    for i, r in enumerate(recorder.records):
        got = {k: r["counts"][k] - prev["counts"][k] for k in r["counts"]
               if r["counts"][k] != prev["counts"][k]}
        n_short = r["short"] - prev["short"]
        label = f"step {i}" if i < steps else "validation (1 batch)"
        want = launches(i < steps)
        ms = (r["t"] - prev["t"]) * 1e3
        log(f"{tag} {label}: {ms:.1f} ms (host clock, synchronised), "
            f"launches {got}, short-route attentions {n_short}; " + " ".join(
                f"{k}={v:.5g}" for k, v in sorted(r["metrics"].items())))
        check(got == want and n_short == short, f"{tag} {label}: launches "
              f"{got} and {n_short} short, expected {want} and {short}")
        bad = [k for k, v in r["metrics"].items() if not np.isfinite(v)]
        check(not bad, f"{tag} {label}: non-finite {bad}")
        prev = r
    moved = sum(not torch.equal(p, q)
                for p, q in zip(prior.parameters(), before))
    log(f"{tag} {moved} of {len(before)} prior parameter tensors moved; "
        f"peak memory {peak / 2**30:.2f} GiB")
    check(moved == len(before), f"{tag} prior parameters did not move")
    del before
    gc_cuda()
    images = stage1.get_input(batch, "image")
    step = make_cond_transformer_train_step(model)
    profile_device(f"{tag} one training step, batch {images.shape[0]}",
                   lambda: step(trainer.final_state, images, conds))
    counts = recorder.records[-1]["counts"]
    del model, prior, trainer, step, data
    gc_cuda()
    return counts


# -- the RQ prior and its RQ-VAE tokenizer at their published widths ----------

# limits of phase 14 (a): phase 5's, the codes compared depth by depth on
# the positions where every shallower depth agrees (a residual changed by
# one differing code changes every deeper search)
RQ_CODE_MATCH = 95.0
# (c): the fp32 RQ prior, prefill and the spatial steps after it, each
# position's depth loop teacher-forced on random codes; phase 12's limits
RQ_F32_STEPS = 16


def rq_full(rq, codes, conds):
    """The teacher-forced forward's (B * T, D, V) logits in fp32."""
    with torch.inference_mode():
        return rq(codes, conds).float()


def rq_teacher_forced(rq, codes, conds, steps):
    """The spatial prefill and ``steps`` spatial steps fed the (B, T, D)
    codes, each of the 1 + steps positions' depth loops fed them too:
    (B * (1 + steps), D, V) fp32 logits, the full forward's layout."""
    b = codes.shape[0]
    out = []
    with torch.inference_mode():
        cache = rq.init_cache(b)
        hidden, cache = rq.spatial_prefill(conds, cache)
        for pos in range(steps + 1):
            if pos:
                hidden, cache = rq.spatial_step(codes[:, pos - 1], pos,
                                                cache)
            out.append(torch.stack([rq.depth_forward(hidden, codes[:, pos], d)
                                    for d in range(RQ_DEPTH)], 1))
    return torch.stack(out, 1).reshape(b * (steps + 1), RQ_DEPTH,
                                       -1).float()


def rq_vae_trips() -> dict:
    """Phase 14 (a): round trips of the RQ-VAE tokenizer in bf16 at batch
    1, 8 and 128, launches asserted; the kernels against the plain path at
    batch 8; images/s and peak memory at batch 128."""
    from enhancing_tpu_torch.ops import reset_launches
    from enhancing_tpu_torch.utils.config import initialize_from_config
    gc_cuda()
    cfg = json.loads(json.dumps(RQVAE_BASE))
    cfg["params"]["dtype"] = "bfloat16"
    model = initialize_from_config(cfg, device="cuda")
    rng = np.random.default_rng(14)
    inputs = {b: torch.from_numpy(rng.random((b, 256, 256, 3),
                                             dtype=np.float32)).cuda()
              for b in (1, CHECK_BATCH, TIME_BATCH)}
    torch.cuda.synchronize()
    reset_launches()
    outs = {}
    for b, x in inputs.items():
        codes = model.encode_codes(x)
        outs[b] = (codes, model.decode_codes(codes))
    torch.cuda.synchronize()
    counts = kernel_counts()
    launches = {k: v for k, v in counts.items() if v}
    want = {k: len(outs) * v for k, v in RQ_TRIP.items()}
    log(f"[rq] RQ-VAE bf16 round trips at batch 1, 8, 128: launches "
        f"{launches}")
    check(launches == want, f"RQ-VAE launches {launches}, expected {want}")
    for b, (codes, rec) in outs.items():
        check(codes.shape == (b, TOKENS, RQ_DEPTH)
              and codes.dtype == torch.int32, f"RQ codes {codes.shape}")
        check(bool(((codes >= 0) & (codes < CODES)).all()), "RQ code range")
        check(rec.shape == (b, 256, 256, 3) and bool(torch.isfinite(rec).all()),
              f"RQ reconstruction of batch {b}")
    codes_k, rec_k = outs[CHECK_BATCH]
    with plain_versions():
        codes_p = model.encode_codes(inputs[CHECK_BATCH])
        rec_p = model.decode_codes(codes_k)
    matches = []
    for d in range(RQ_DEPTH):
        agree = (codes_k[..., :d] == codes_p[..., :d]).all(-1)
        same = (codes_k[..., d] == codes_p[..., d])[agree]
        matches.append(float(same.float().mean()) * 100)
    rec_err = float((rec_k.float() - rec_p.float()).abs().max())
    log(f"[rq] RQ-VAE kernels vs plain, batch {CHECK_BATCH}: code match by "
        f"depth {', '.join(f'{m:.3f}%' for m in matches)} on the positions "
        f"where every shallower depth agrees (threshold {RQ_CODE_MATCH}%), "
        f"reconstruction from the same codes max_abs_err {rec_err:.4e} "
        f"(threshold 0.1)")
    check(min(matches) >= RQ_CODE_MATCH, "RQ-VAE codes disagree")
    check(rec_err <= 0.1, "RQ-VAE reconstructions disagree")
    x = inputs[TIME_BATCH]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    log(f"[rq] RQ-VAE round trip batch {TIME_BATCH}: {dt * 1e3:.2f} ms, "
        f"{TIME_BATCH / dt:.1f} images/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, outs, inputs, x
    gc_cuda()
    return counts


def rq_sampling() -> tuple:
    """Phase 14 (b): the bf16 RQ prior over the RQ-VAE tokenizer, one
    ``CondTransformer.sample`` of 8 images with its launches asserted, the
    sampler alone on another seed, the agreement checks and one position's
    device time by kernel group. Returns the launches, the model (for
    (d)) and its codes."""
    from enhancing_tpu_torch.models.stage2.sampling import sample_rq
    from enhancing_tpu_torch.ops import LAUNCHES, SHORT_CALLS, reset_launches
    from enhancing_tpu_torch.utils.config import initialize_from_config
    gc_cuda()
    cfg = json.loads(json.dumps(RQ_TRANSFORMER_BASE))
    cfg["params"]["dtype"] = "bfloat16"
    cfg["params"]["stage1"]["params"]["dtype"] = "bfloat16"
    t0 = time.perf_counter()
    model = initialize_from_config(cfg, device="cuda")
    rq = model.transformer
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in rq.parameters())
    log(f"[rq] RQ prior {RQ_LAYERS} spatial layers x {RQ_WIDTH} ({RQ_HEADS} "
        f"heads of {RQ_HEAD_DIM}) + {RQ_DEPTH_LAYERS} depth layers "
        f"({RQ_PRIOR['depth_n_heads']} heads of "
        f"{RQ_WIDTH // RQ_PRIOR['depth_n_heads']}), bf16, built on the card "
        f"in {time.perf_counter() - t0:.1f} s: {n_params / 1e9:.3f} G "
        f"parameters; allocated {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB")
    conds = torch.tensor(CLASSES, device="cuda")[:, None]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pixels, codes = model.sample(conds, top_k=100, seed=0, return_codes=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_counts()
    launches = {k: v for k, v in counts.items() if v}
    short = SHORT_CALLS["attention_bnhd"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[rq] CondTransformer.sample(8 classes, top_k=100): {dt:.2f} s, "
        f"launches {launches}; short-route attention calls {short}")
    check(launches == RQ_SAMPLE_CALL, f"RQ sample launches {launches}, "
          f"expected {RQ_SAMPLE_CALL}")
    check(short == RQ_SAMPLE_SHORT, f"short-route calls {short}, expected "
          f"{RQ_SAMPLE_SHORT}")
    check(codes.shape == (SAMPLE_BATCH, 1024, RQ_DEPTH)
          and codes.dtype == torch.int32, f"RQ codes {codes.shape}")
    check(bool(((codes >= 0) & (codes < P_VOCAB)).all()), "RQ code range")
    check(pixels.shape == (SAMPLE_BATCH, 256, 256, 3)
          and bool(torch.isfinite(pixels).all())
          and float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0,
          "RQ pixels not finite in [0, 1]")

    gen = torch.Generator("cuda").manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, codes_1 = sample_rq(rq, conds, gen, top_k=100, with_logits=True)
    torch.cuda.synchronize()
    t_sampler = time.perf_counter() - t0
    differ = float((codes_1 != codes).float().mean())
    n_codes = SAMPLE_BATCH * 1024 * RQ_DEPTH
    log(f"[rq] codes int32 in [0, {P_VOCAB}), pixels finite in [0, 1]; seed 1 "
        f"differs from seed 0 at {differ:.2%} of codes; end to end "
        f"{n_codes / dt:.1f} codes/s, {SAMPLE_BATCH / dt:.3f} images/s; "
        f"sampler alone {t_sampler:.2f} s = {t_sampler / 1024 * 1e3:.3f} ms "
        f"per spatial position (a spatial step, {RQ_DEPTH} depth forwards "
        f"and draws; the prefill counted in the first); peak memory "
        f"{peak / 2**30:.2f} GiB")
    check(differ > 0.5, "two seeds gave (nearly) the same RQ codes")
    full = rq_full(rq, codes_1, conds)
    agreement(f"RQ sampler logits vs teacher-forced forward, 8 x 1024 x "
              f"{RQ_DEPTH}", logits, full, STEP_VS_FULL_ATOL,
              STEP_VS_FULL_ARGMAX)
    del logits, full

    before = dict(LAUNCHES)
    k_full = rq_full(rq, codes[:2], conds[:2])
    k_dec = rq_teacher_forced(rq, codes[:2], conds[:2], CHECK_STEPS)
    with plain_versions():
        p_full = rq_full(rq, codes[:2], conds[:2])
        p_dec = rq_teacher_forced(rq, codes[:2], conds[:2], CHECK_STEPS)
    check(LAUNCHES["attention_bnhd"] == before["attention_bnhd"]
          + 2 * RQ_LAYERS and LAUNCHES["decode_attention"]
          == before["decode_attention"] + CHECK_STEPS * RQ_LAYERS,
          "the plain path launched a kernel")
    agreement("RQ full forward batch 2, kernels vs plain", k_full, p_full,
              KERNEL_VS_PLAIN_ATOL, KERNEL_VS_PLAIN_ARGMAX)
    agreement(f"RQ prefill + {CHECK_STEPS} spatial positions with their depth"
              " loops batch 2, kernels vs plain", k_dec, p_dec,
              KERNEL_VS_PLAIN_ATOL, KERNEL_VS_PLAIN_ARGMAX)
    del k_full, p_full, k_dec, p_dec

    time_rq_position(rq, codes[:, 510], gen, "bf16")
    del rq
    gc_cuda()
    return counts, model, codes


def time_rq_position(rq, prev, gen, label) -> None:
    """One spatial position of the sampler at position 512 (a spatial step,
    then RQ_DEPTH depth forwards and draws) on the host clock over 20
    positions, and its device time by kernel group: the idle share."""
    from enhancing_tpu_torch.models.stage2.sampling import _draw

    def position(cache):
        hidden, _ = rq.spatial_step(prev, 512, cache)
        depth_codes = torch.zeros_like(prev)
        for d in range(RQ_DEPTH):
            logits = rq.depth_forward(hidden, depth_codes, d)
            depth_codes[:, d] = _draw(gen, logits, 1.0, 100, None)
        return depth_codes

    with torch.inference_mode():
        cache = rq.init_cache(SAMPLE_BATCH)
        for _ in range(2):
            position(cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            position(cache)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / 20 * 1e3
        busy = profile_device(f"one {label} RQ spatial position batch "
                              f"{SAMPLE_BATCH} at position 512 (a spatial "
                              f"step, {RQ_DEPTH} depth forwards and draws)",
                              lambda: position(cache))
    if busy is not None:
        log(f"[rq] one {label} spatial position at 512: {host:.3f} ms on the "
            f"host clock, device busy {busy:.3f} ms -> device idle "
            f"{1 - busy / host:.1%} of the unprofiled position")
    del cache


def rq_prior_f32() -> dict:
    """Phase 14 (c): configs/imagenet_rqtransformer_base.yaml's prior in
    its own fp32, the spatial prefill and RQ_F32_STEPS spatial steps with
    every position's depth loop, teacher-forced on random codes, launches
    asserted, against the plain path."""
    from enhancing_tpu_torch.ops import SHORT_CALLS, reset_launches
    from enhancing_tpu_torch.utils.config import initialize_from_config
    gc_cuda()
    model = initialize_from_config(json.loads(json.dumps(RQ_TRANSFORMER_BASE)),
                                   device="cuda")
    rq = model.transformer
    conds = torch.tensor(CLASSES, device="cuda")[:, None]
    gen = torch.Generator(device="cuda").manual_seed(14)
    codes = torch.randint(0, P_VOCAB, (SAMPLE_BATCH, RQ_F32_STEPS + 1,
                                       RQ_DEPTH), generator=gen,
                          device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = rq_teacher_forced(rq, codes, conds, RQ_F32_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (RQ_F32_STEPS + 1) * 1e3
    counts = kernel_counts()
    launches = {k: v for k, v in counts.items() if v}
    short = SHORT_CALLS["attention_bnhd"]
    want = {"attention_bnhd_f32": RQ_LAYERS,
            "decode_attention": RQ_LAYERS * RQ_F32_STEPS,
            "cache_row_update": 2 * RQ_F32_STEPS}
    want_short = (RQ_F32_STEPS + 1) * RQ_DEPTH * RQ_DEPTH_LAYERS
    log(f"[rq] fp32 RQ prior, prefill + {RQ_F32_STEPS} spatial steps batch "
        f"{SAMPLE_BATCH}, each position's depth loop: {ms:.2f} ms a position"
        f" (host clock); launches {launches}; short-route calls {short}")
    check(launches == want and short == want_short,
          f"fp32 RQ prior launches {launches} and {short} short, expected "
          f"{want} and {want_short}")
    with plain_versions():
        want_logits = rq_teacher_forced(rq, codes, conds, RQ_F32_STEPS)
    agreement(f"fp32 RQ prior, prefill + {RQ_F32_STEPS} spatial positions "
              "with their depth loops, kernels vs plain", got, want_logits,
              PRIOR_F32_ATOL, PRIOR_F32_ARGMAX)
    del model, rq, got, want_logits
    gc_cuda()
    return counts


# limits of phase 14 (d). int8 against bf16: phase 8's bar (argmax equal on
# more than half of the positions). The int8 cache alone (bf16 weights,
# bf16 q) against its plain path: phase 7's. The int8 kernels against the
# int8 plain path: the RQ prior's logits come out of its bf16 depth stack
# and head, which re-round the spatial hidden's fp32 differences (the int8
# products summed in another order) at its bf16 LayerNorm and in every
# depth layer, where phase 8's logits are B13's fp32 products; set from the
# first measurements on the card (largest differences 0.039-0.047, argmax
# equal at 96.6-99.6% of positions over eight sets of random codes, batch
# 8 and 2; NVIDIA H100 80GB HBM3, 700 W) with a margin of 3x on the
# difference and on the argmax disagreement.
RQ_INT8_KERNEL_VS_PLAIN_ATOL, RQ_INT8_KERNEL_VS_PLAIN_ARGMAX = 0.15, 0.9


def rq_int8(model, codes) -> dict:
    """Phase 14 (d): int8 serving of (b)'s bf16 RQ prior, teacher-forced on
    its codes over the prefill and CHECK_STEPS spatial positions with
    their depth loops: ``kv_int8`` alone (bf16 weights, bf16 q on the int8
    cache) against the plain path, its launches asserted; then
    ``quantize_decode_params``, int8 against bf16 and the int8 kernels
    against the int8 plain path; one int8 ``CondTransformer.sample`` of 8
    labels with its launches asserted exactly, codes/s, ms per spatial
    position, peak memory and one position's device time by kernel group.
    Returns the sample's launches by kernels-line name."""
    from enhancing_tpu_torch.models.stage2 import quantize_decode_params
    from enhancing_tpu_torch.ops import LAUNCHES, SHORT_CALLS, reset_launches
    gc_cuda()
    rq = model.transformer
    conds = torch.tensor(CLASSES, device="cuda")[:, None]
    steps, b = CHECK_STEPS, SAMPLE_BATCH
    what = (f"prefill + {steps} spatial positions with their depth loops "
            f"batch {b}, teacher-forced on (b)'s codes")
    ref16 = rq_teacher_forced(rq, codes, conds, steps)

    # the int8 cache alone: as a config's kv_int8, init_cache now makes an
    # int8 cache; bf16 weights, so bf16 q
    rq.kv_int8 = True
    torch.cuda.synchronize()
    reset_launches()
    k_kv = rq_teacher_forced(rq, codes, conds, steps)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernel_counts().items() if v}
    want = {"attention_bnhd": RQ_LAYERS, "decode_attention": RQ_LAYERS * steps,
            "cache_row_update": 2 * steps}
    log(f"[rq-int8] kv_int8, bf16 weights, {what}: launches {launches}")
    check(launches == want, f"kv_int8 launches {launches}, expected {want}")
    mid = dict(LAUNCHES)
    with plain_versions():
        p_kv = rq_teacher_forced(rq, codes, conds, steps)
    check(LAUNCHES == mid, "the plain path launched a kernel")
    agreement(f"RQ kv_int8 (bf16 weights, bf16 q on the int8 cache), {what}"
              ", kernels vs plain", k_kv, p_kv, KERNEL_VS_PLAIN_ATOL,
              KERNEL_VS_PLAIN_ARGMAX)
    del k_kv, p_kv

    # int8 weights beside the full-precision ones (the depth stack and the
    # head read those)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    quantize_decode_params(model)
    torch.cuda.synchronize()
    log(f"[rq-int8] quantize_decode_params: {time.perf_counter() - t0:.2f} "
        f"s, int8 twins {(torch.cuda.memory_allocated() - before) / 2**30:.3f}"
        " GiB")
    k_q = rq_teacher_forced(rq, codes, conds, steps)
    agree = float((k_q.argmax(-1) == ref16.argmax(-1)).float().mean())
    log(f"[rq-int8] int8 weights and cache vs bf16 weights and cache, {what}"
        f": argmax equal at {agree:.2%} (limit > {INT8_VS_BF16_ARGMAX:.0%}), "
        f"logits max_abs_diff {float((k_q - ref16).abs().max()):.4f} "
        f"(|logits| max {float(ref16.abs().max()):.3f})")
    check(agree > INT8_VS_BF16_ARGMAX, "RQ int8 and bf16 argmax disagree")
    mid = dict(LAUNCHES)
    with plain_versions():
        p_q = rq_teacher_forced(rq, codes, conds, steps)
    check(LAUNCHES == mid, "the plain path launched a kernel")
    agreement(f"RQ int8 weights and cache, {what}, kernels vs plain", k_q,
              p_q, RQ_INT8_KERNEL_VS_PLAIN_ATOL,
              RQ_INT8_KERNEL_VS_PLAIN_ARGMAX)
    del ref16, k_q, p_q

    # the entry point, counted
    gc_cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pixels, codes_q = model.sample(conds, top_k=100, seed=0,
                                   return_codes=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_counts()
    launches = {k: v for k, v in counts.items() if v}
    short = SHORT_CALLS["attention_bnhd"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[rq-int8] CondTransformer.sample(8 classes, top_k=100), int8 "
        f"weights and cache: {dt:.2f} s, launches {launches}; short-route "
        f"attention calls {short}")
    check(launches == RQ_INT8_SAMPLE_CALL, f"RQ int8 sample launches "
          f"{launches}, expected {RQ_INT8_SAMPLE_CALL}")
    check(short == RQ_SAMPLE_SHORT, f"short-route calls {short}, expected "
          f"{RQ_SAMPLE_SHORT}")
    check(codes_q.shape == (b, 1024, RQ_DEPTH)
          and codes_q.dtype == torch.int32, f"RQ codes {codes_q.shape}")
    check(bool(((codes_q >= 0) & (codes_q < P_VOCAB)).all()),
          "RQ code range")
    check(pixels.shape == (b, 256, 256, 3)
          and bool(torch.isfinite(pixels).all())
          and float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0,
          "RQ pixels not finite in [0, 1]")
    n_codes = b * 1024 * RQ_DEPTH
    log(f"[rq-int8] codes int32 in [0, {P_VOCAB}), pixels finite in [0, 1]; "
        f"equal to (b)'s bf16 sample (same seed) at "
        f"{float((codes_q == codes).float().mean()):.2%} of codes; end to "
        f"end {n_codes / dt:.1f} codes/s, {b / dt:.3f} images/s, "
        f"{dt / 1024 * 1e3:.3f} ms per spatial position (the tokenizer's "
        f"decode included); peak memory {peak / 2**30:.2f} GiB")
    time_rq_position(rq, codes_q[:, 510],
                     torch.Generator("cuda").manual_seed(2), "int8")
    del rq, pixels, codes_q
    gc_cuda()
    return counts


def phase_rq() -> dict:
    """Phase 14, RQ serving: (a) the RQ-VAE round trip, (b) the bf16 RQ
    prior's sample, (c) the RQ prior in its own fp32, (d) (b)'s prior in
    int8. Returns the launches by kernels-line name."""
    t0 = time.perf_counter()
    total = dict(rq_vae_trips())
    sampled, model, codes = rq_sampling()
    for part in (sampled, rq_prior_f32(), rq_int8(model, codes)):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    del model, codes
    gc_cuda()
    log(f"[rq] phase 14 took {time.perf_counter() - t0:.1f} s")
    return total


# -- training the RQ prior at its published widths and depth -----------------

# configs/imagenet_rqtransformer_base.yaml's RQ prior trained through
# Trainer.fit at its published widths and full depth (24 spatial layers of
# 1536, 16 heads of 96; 4 depth layers, 8 heads of 192; 8192 codes, 1025
# tokens x 4 depths) over its frozen RQ-VAE tokenizer (fp32, the config's
# dtype; random weights): ~821 M parameters, ~13.1 GB of fp32 masters,
# gradients and two Adam moments, so the whole depth fits one 80 GB card:
# (prior dtype, steps)
RQ_TRAIN_RUNS = (("bfloat16", 3), ("float32", 2))


def rq_train_config(dtype: str) -> dict:
    """The config's model with the prior's dtype set (the only change; no
    stage-1 path: the released weights are not in the repository) and a
    FakeImages dataset in place of ImageNet at the config's batch 4."""
    model = json.loads(json.dumps(RQ_TRANSFORMER_BASE))
    model["params"]["transformer"]["params"]["dtype"] = dtype
    return {"model": model, "dataset": fake_imagenet(RQ_TRAIN_BATCH)}


def rq_step_launches(dtype: str, backward: bool) -> dict:
    """Launches an RQ prior step (backward) or validation batch makes, by
    kernels-line name: the frozen fp32 RQ-VAE's encode (fp32 B1 24, fp32
    B2 12, B3 1, B4 once a depth), then B8 once a spatial layer and B5 at
    D = 96 once a spatial layer. The depth layers' attention (4 tokens at
    D = 192) takes the short route, counted apart."""
    f32 = "_f32" if dtype == "float32" else ""
    want = {"ln_gemm_f32": 24, "attention_f32": 12, "layernorm": 1,
            "vq": RQ_DEPTH, "attention_bnhd" + f32: RQ_LAYERS}
    if backward:
        want["attention_bwd" + f32] = RQ_LAYERS
    return want


def phase_rq_train() -> dict:
    """Phase 15: RQ_TRAIN_RUNS through Trainer.fit (:func:`train_prior`)
    at full width and depth. Returns the launches by kernels-line name."""
    t0 = time.perf_counter()
    total: dict = {}
    for dtype, steps in RQ_TRAIN_RUNS:
        counts = train_prior(
            f"[rq-train {dtype[:4]}]", rq_train_config(dtype), dtype, steps,
            lambda backward: rq_step_launches(dtype, backward),  # noqa: B023
            RQ_DEPTH_LAYERS,
            f"imagenet_rqtransformer_base.yaml at full depth: {RQ_LAYERS} "
            f"spatial layers x {RQ_WIDTH} ({RQ_HEADS} heads of "
            f"{RQ_HEAD_DIM}), {RQ_DEPTH_LAYERS} depth layers "
            f"({RQ_PRIOR['depth_n_heads']} heads of "
            f"{RQ_WIDTH // RQ_PRIOR['depth_n_heads']}), {P_VOCAB} codes, "
            f"{P_CTX} tokens x {RQ_DEPTH} depths; prior compute {dtype}, "
            f"fp32 master weights; frozen RQ-VAE tokenizer fp32, random "
            f"weights; FakeImages 256 px, 1000 classes, batch "
            f"{RQ_TRAIN_BATCH}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    log(f"[rq-train] phase 15 took {time.perf_counter() - t0:.1f} s")
    return total


# -- phase 16: the Gumbel tokenizer's GAN training at its published widths --

# configs/imagenet_vitvq_gumbel_base.yaml's model after load_config's target
# remap (a CPU test holds the two equal): ViT-VQGAN-Base in fp32 with the
# Gumbel-softmax quantizer, its temperature schedule and its loss weights
GUMBEL_VITVQ_BASE = {
    "target": "enhancing_tpu_torch.models.stage1.vitvqgan.ViTVQGumbel",
    "params": {
        "image_key": "image", "image_size": 256, "patch_size": 8,
        "encoder": dict(_TOWER), "decoder": dict(_TOWER),
        "quantizer": {"embed_dim": 32, "n_embed": 8192, "temp_init": 1.0},
        "temperature_scheduler": {
            "target": "enhancing_tpu_torch.train.optim."
                      "ExponentialDecayScheduler",
            "params": {"start": 1.0, "end": 0.0625, "decay_every_step": 1,
                       "scale_factor": 0.00001}},
        "loss": {
            "target": "enhancing_tpu_torch.losses.vqperceptual."
                      "VQLPIPSWithDiscriminator",
            "params": {"loglaplace_weight": 0.0, "loggaussian_weight": 1.0,
                       "perceptual_weight": 0.1,
                       "adversarial_weight": 0.1}},
    }}
GUMBEL_STEPS = 3
# per fp32 Gumbel step: phase 11's fp32 step less its two VQ searches (the
# Gumbel quantizer takes the argmax of its softmax over the full distance
# matrix, a library product); a validation batch: one fp32 round trip and
# three D forwards
GUMBEL_STEP = {"ln_gemm_f32": 96, "attention_f32": 48, "layernorm": 4,
               "attention_bwd_f32": 24, "fir": 36, "fir_vjp": 36,
               "fused_act": 45}
GUMBEL_EVAL = {"ln_gemm_f32": 48, "attention_f32": 24, "layernorm": 2,
               "fir": 36, "fused_act": 45}
# torchvision's VGG16 convs (features.{i}) and the lpips package's lin
# heads: the layout lpips_weights is read in
VGG16_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
               (14, 256), (17, 512), (19, 512), (21, 512), (24, 512),
               (26, 512), (28, 512))
LPIPS_LINS = (64, 128, 256, 512, 512)


def write_lpips_file(path: str, seed: int = 16) -> str:
    """Seeded random VGG16 conv weights (He-scaled) and non-negative lin
    heads in the torchvision + lpips key layout, torch.save'd to ``path``:
    no pretrained file is in the repository, so the weight loader runs on
    this one."""
    import os
    gen = torch.Generator().manual_seed(seed)
    sd, in_ch = {}, 3
    for idx, width in VGG16_CONVS:
        sd[f"features.{idx}.weight"] = (torch.randn(
            width, in_ch, 3, 3, generator=gen) * (2.0 / (9 * in_ch)) ** 0.5)
        sd[f"features.{idx}.bias"] = torch.zeros(width)
        in_ch = width
    for i, width in enumerate(LPIPS_LINS):
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, width, 1, 1,
                                                  generator=gen) * 0.1
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)
    return path


def phase_gumbel_train() -> dict:
    """Phase 16: configs/imagenet_vitvq_gumbel_base.yaml's model as shipped
    (fp32) through Trainer.fit on FakeImages at 256 px, batch 8, LPIPS read
    through lpips_weights from a file written here; GUMBEL_STEPS steps (R1
    on step 0) and a validation batch, each step's temperature against the
    scheduler's and its launches asserted exactly; one step's losses and
    gradients through the kernels against the plain path on the same
    weights and noise; ms a step, peak memory, one step's device time."""
    from enhancing_tpu_torch.ops import (LAUNCHES, PLAIN_CALLS,
                                         reset_launches)
    from enhancing_tpu_torch.train import Trainer, make_vitvq_train_step
    from enhancing_tpu_torch.utils.config import initialize_from_config
    gc_cuda()
    t0 = time.perf_counter()
    cfg = json.loads(json.dumps(GUMBEL_VITVQ_BASE))
    cfg["params"]["loss"]["params"]["lpips_weights"] = write_lpips_file(
        "build/lpips_vgg16_random.pt")
    model = initialize_from_config(cfg, device="cuda")
    data = initialize_from_config(fake_imagenet(TRAIN_BATCH))
    module, disc = model.module, model.loss.discriminator
    check(not model.loss.lpips_is_random, "LPIPS did not load its file")
    log(f"[gumbel] imagenet_vitvq_gumbel_base.yaml as shipped (ViTVQGumbel,"
        f" fp32, {CODES} codes of {EMBED}, ExponentialDecayScheduler, "
        f"VQLPIPSWithDiscriminator), LPIPS from lpips_weights (seeded random"
        f" VGG16 + lin heads in the torchvision / lpips layout), FakeImages "
        f"256 px batch {TRAIN_BATCH}: built in "
        f"{time.perf_counter() - t0:.1f} s")
    before = {"AE": [p.detach().clone() for p in module.parameters()],
              "D": [p.detach().clone() for p in disc.parameters()]}
    trainer = Trainer(max_steps=GUMBEL_STEPS, log_every=1)
    recorder = StepRecorder(trainer)
    trainer.metrics_logger = recorder
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    prev = dict(t=time.perf_counter(), counts=kernel_counts(),
                plain={k: 0 for k in PLAIN_CALLS})
    trainer.fit(model, data)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(len(recorder.records) == GUMBEL_STEPS + 1,
          f"{len(recorder.records)} log calls, expected {GUMBEL_STEPS} steps "
          "and one validation")
    step_ms = []
    for i, r in enumerate(recorder.records):
        got = {k: r["counts"][k] - prev["counts"][k] for k in r["counts"]
               if r["counts"][k] != prev["counts"][k]}
        plain = {k: r["plain"][k] - prev["plain"][k] for k in PLAIN_CALLS
                 if r["plain"][k] != prev["plain"][k]}
        ms = (r["t"] - prev["t"]) * 1e3
        if i < GUMBEL_STEPS:
            want_temp = model.temperature_scheduler(i)
            label = (f"step {i} ({'R1' if i == 0 else 'no R1'}, temperature "
                     f"{r['temp']!r})")
            want, want_plain = GUMBEL_STEP, (R1_PLAIN if i == 0 else {})
            check(r["temp"] == want_temp, f"step {i}: temperature "
                  f"{r['temp']!r}, the scheduler's {want_temp!r}")
            step_ms.append(ms)
        else:
            label, want, want_plain = "validation (1 batch)", GUMBEL_EVAL, {}
        log(f"[gumbel] {label}: {ms:.1f} ms, launches {got}, plain-routed "
            f"{plain}")
        check(got == want, f"gumbel {label}: launches {got}, expected {want}")
        check(plain == want_plain, f"gumbel {label}: plain-routed {plain}")
        bad = [k for k, v in r["metrics"].items() if not np.isfinite(v)]
        check(not bad, f"gumbel {label}: non-finite {bad}")
        prev = r
    for group, params in (("AE", module.parameters()),
                          ("D", disc.parameters())):
        moved = sum(not torch.equal(p, q) for p, q in zip(params,
                                                          before[group]))
        check(moved == len(before[group]), f"gumbel {group} parameters did "
              "not all move")
    del before
    last = recorder.records[GUMBEL_STEPS - 1]["metrics"]
    steady = float(np.mean(step_ms[1:]))
    log(f"[gumbel] after {GUMBEL_STEPS} steps: " + " ".join(
        f"{k}={v:.5g}" for k, v in sorted(last.items())))
    log(f"[gumbel] code perplexity {last['train/code_perplexity']:.2f} "
        f"({last['train/codes_used']:.0f} codes used); step 0 (R1, first "
        f"calls) {step_ms[0]:.1f} ms, steps 1-{GUMBEL_STEPS - 1} mean "
        f"{steady:.1f} ms = {TRAIN_BATCH / steady * 1e3:.2f} images/s, peak "
        f"memory {peak / 2**30:.2f} GiB (wall clock around each step, "
        "logging included)")
    check(np.isfinite(last["train/code_perplexity"])
          and last["train/codes_used"] > 0, "gumbel code usage")

    # one step's losses and gradients, kernels against the plain path, on
    # the same weights and the same draws (one CUDA generator seed); the
    # model is fp32, so phase 11's fp32 limits hold it
    x = model.get_input(next(iter(data.val_dataloader())), "image")
    temp = model.temperature_scheduler(GUMBEL_STEPS)
    module.train()
    k_logs, k_ae, k_d, k_codes = one_step_grads(model, x, temp, key=16)
    mid = dict(LAUNCHES)
    with plain_versions():
        p_logs, p_ae, p_d, p_codes = one_step_grads(model, x, temp, key=16)
    check(LAUNCHES == mid, "gumbel: the plain path launched a kernel")
    rel = {k: abs(k_logs[k] - p_logs[k]) / max(abs(p_logs[k]), 1e-6)
           for k in p_logs}
    worst = max(rel.items(), key=lambda kv: kv[1])
    ae_cos = worst_cosine([n for n, _ in module.named_parameters()], k_ae,
                          p_ae)
    d_cos = worst_cosine([n for n, _ in disc.named_parameters()], k_d, p_d)
    match = float((k_codes == p_codes).float().mean()) * 100
    log(f"[gumbel] one step at temperature {temp:.6f}, fp32 kernels vs fp32"
        f" plain, same noise: code match {match:.3f}%; largest loss "
        f"difference {worst[1]:.3e} relative ({worst[0]}; limit "
        f"{F32_LOSS_RTOL_LIMIT}); least gradient cosine AE {ae_cos[0]:.7f} "
        f"({ae_cos[1]}), D {d_cos[0]:.7f} ({d_cos[1]}) (limit "
        f"{F32_COS_LIMIT})")
    check(worst[1] <= F32_LOSS_RTOL_LIMIT, "gumbel losses disagree")
    check(min(ae_cos[0], d_cos[0]) >= F32_COS_LIMIT,
          "gumbel gradients disagree")
    del k_ae, k_d, p_ae, p_d
    step = make_vitvq_train_step(model, model.loss)
    busy = profile_device(
        f"one fp32 Gumbel training step (no R1) batch {TRAIN_BATCH}",
        lambda: step(trainer.final_state, x, rng=7, temp=temp))
    module.eval()
    if busy is not None:
        log(f"[gumbel] device busy {busy:.2f} ms in one step against "
            f"{steady:.1f} ms a step unprofiled: {busy / steady:.1%} busy")
    counts = recorder.records[-1]["counts"]
    del model, trainer, step, data
    gc_cuda()
    return counts


# -- phase 17: the split GAN step, reuse_xrec and gradient accumulation -----

# configs/convergence_vitvq_base.yaml after load_config's target remap (a
# CPU test holds the two equal): ViT-VQGAN-Base bf16, perceptual weight 0,
# the GAN term from step 100
CONVERGENCE_VITVQ_BASE = {
    "model": {
        "target": "enhancing_tpu_torch.models.stage1.vitvqgan.ViTVQ",
        "params": {
            "image_key": "image", "image_size": 256, "patch_size": 8,
            "dtype": "bfloat16", "scan_layers": True, "remat": True,
            "encoder": dict(_TOWER), "decoder": dict(_TOWER),
            "quantizer": {"embed_dim": 32, "n_embed": 8192},
            "loss": {
                "target": "enhancing_tpu_torch.losses.vqperceptual."
                          "VQLPIPSWithDiscriminator",
                "params": {"loglaplace_weight": 1.0,
                           "loggaussian_weight": 1.0,
                           "perceptual_weight": 0.0,
                           "adversarial_weight": 0.1,
                           "disc_start": 100}},
        }},
    "dataset": {
        "target": "enhancing_tpu_torch.data.DataModuleFromConfig",
        "params": {
            "batch_size": 8, "num_workers": 4,
            "train": {"target": _FAKE, "params": {
                "length": 4096, "resolution": 256, "seed": 1}},
            "validation": {"target": _FAKE, "params": {
                "length": 64, "resolution": 256, "seed": 2}},
        }},
}
SPLIT_STEPS, ACCUM_STEPS = 3, 4
# a generator round trip: what reuse_xrec saves a step
ROUND_TRIP_SAVED = {"ln_gemm": 48, "attention": 24, "layernorm": 2, "vq": 1}


def adam_moments(opt, which: str) -> list:
    """The AdamW moments ``which`` ("exp_avg", the running means of the
    gradients, or "exp_avg_sq", of their squares) of the optimizer a
    MultiSteps wraps, in parameter order."""
    inner = opt.opt
    return [inner.state[p][which].detach().clone()
            for g in inner.param_groups for p in g["params"]]


class ParamWatch(StepRecorder):
    """StepRecorder that also records, at every log call, whether the AE
    and D parameters are bit-equal to the last call's."""

    def __init__(self, trainer, tensors) -> None:
        super().__init__(trainer)
        self.tensors = tensors
        self.last = [t.detach().clone() for t in tensors]

    def log_metrics(self, metrics: dict, step: int) -> None:
        super().log_metrics(metrics, step)
        now = [t.detach().clone() for t in self.tensors]
        self.records[-1]["same"] = all(torch.equal(a, b)
                                       for a, b in zip(self.last, now))
        self.last = now


def phase_split_accumulate() -> dict:
    """Phase 17: configs/convergence_vitvq_base.yaml (bf16, batch 8, no
    validation split) from one initial state through Trainer.fit five
    ways: the fused step, split_gan_step, reuse_xrec (SPLIT_STEPS steps
    each), accumulate_grad_batches=2 (ACCUM_STEPS micro-steps), and that
    accumulation on the plain versions. The split step against the fused
    one, and the accumulation's kernels against its plain run: logged
    losses within phase 6's 5e-3, AdamW first and second moments (the
    running means of the gradients and their squares) to phase 6's
    cosines, and the split step's parameter movements too; reuse
    launches one generator round trip fewer a step than split;
    accumulation leaves every parameter bit-equal after odd micro-steps.
    Returns the launches by kernels-line name."""
    from enhancing_tpu_torch.ops import LAUNCHES, reset_launches
    from enhancing_tpu_torch.train import Trainer
    from enhancing_tpu_torch.utils.config import initialize_from_config
    gc_cuda()
    t0 = time.perf_counter()
    model = initialize_from_config(CONVERGENCE_VITVQ_BASE["model"],
                                   device="cuda")
    module, disc = model.module, model.loss.discriminator
    tensors = [*module.parameters(), *disc.parameters()]
    n_ae = len(list(module.parameters()))
    init = [t.detach().clone() for t in tensors]
    log(f"[split] convergence_vitvq_base.yaml (bf16, perceptual weight 0, "
        f"disc_start 100) built in {time.perf_counter() - t0:.1f} s")
    dataset = json.loads(json.dumps(CONVERGENCE_VITVQ_BASE["dataset"]))
    del dataset["params"]["validation"]
    total: dict = {}

    def run(label, steps, plain=False, **kw):
        with torch.no_grad():
            for t, v in zip(tensors, init):
                t.copy_(v)
        trainer = Trainer(max_steps=steps, log_every=1, **kw)
        watch = ParamWatch(trainer, tensors)
        trainer.metrics_logger = watch
        data = initialize_from_config(dataset)
        torch.cuda.synchronize()
        reset_launches()
        start = dict(t=time.perf_counter(), launches=dict(LAUNCHES),
                     counts=kernel_counts())
        with plain_versions() if plain else contextlib.nullcontext():
            trainer.fit(model, data)
        torch.cuda.synchronize()
        check(len(watch.records) == steps, f"{label}: {len(watch.records)}"
              f" log calls, expected {steps}")
        check(not plain or not any(LAUNCHES.values()),
              f"{label}: the plain path launched a kernel")
        per_step, prev = [], start
        for r in watch.records:
            per_step.append(({k: r["launches"][k] - prev["launches"][k]
                              for k in LAUNCHES},
                             (r["t"] - prev["t"]) * 1e3))
            prev = r
        counts = watch.records[-1]["counts"]
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        ms = [m for _, m in per_step]
        log(f"[split] {label}: {steps} steps, ms a step "
            + ", ".join(f"{m:.1f}" for m in ms) + f" (step 0 R1; mean of "
            f"steps 1-{steps - 1} {float(np.mean(ms[1:])):.1f} ms), losses "
            + " ".join(f"{k}={v:.5g}" for k, v in sorted(
                watch.records[-1]["metrics"].items()) if "loss" in k))
        state = trainer.final_state
        return dict(records=watch.records, launches=per_step,
                    after=[t.detach().clone() for t in tensors],
                    moments={which: adam_moments(state.ae_opt, which)
                             + adam_moments(state.disc_opt, which)
                             for which in ("exp_avg", "exp_avg_sq")},
                    state=state)

    def agree(label, got, want, movements: bool):
        """Logged losses, AdamW first and second moments and, where
        ``movements``, parameter movements of two runs from the same
        state, checked against phase 6's limits. Without ``movements``
        those are logged unchecked: the same AdamW code turns moments that
        agree into movements of ~lr a step that need not (a code one path
        chose and the other did not moves its codebook row, and a
        near-zero gradient's sign decides its entry's step)."""
        names = ([f"AE {n}" for n, _ in module.named_parameters()]
                 + [f"D {n}" for n, _ in disc.named_parameters()])
        worst_loss = (0.0, "")
        for rg, rw in zip(got["records"], want["records"]):
            for k, v in rw["metrics"].items():
                if "loss" in k:
                    rel = abs(rg["metrics"][k] - v) / max(abs(v), 1e-6)
                    worst_loss = max(worst_loss, (rel, k))
        pairs = {"first moments": (got["moments"]["exp_avg"],
                                   want["moments"]["exp_avg"]),
                 "second moments": (got["moments"]["exp_avg_sq"],
                                    want["moments"]["exp_avg_sq"]),
                 "parameter movements": (
                     [a - b for a, b in zip(got["after"], init)],
                     [a - b for a, b in zip(want["after"], init)])}
        out = {what: (worst_cosine(names[:n_ae], g[:n_ae], w[:n_ae]),
                      worst_cosine(names[n_ae:], g[n_ae:], w[n_ae:]))
               for what, (g, w) in pairs.items()}
        checked = [w for w in out if movements or w != "parameter movements"]

        def reading(what: str) -> str:
            (ae, ae_name), (d, d_name) = out[what]
            return (f"least {what} cosine AE {ae:.7f} ({ae_name}), D "
                    f"{d:.7f} ({d_name})")

        log(f"[split] {label}: largest loss difference {worst_loss[0]:.3e} "
            f"relative ({worst_loss[1]}; limit {LOSS_RTOL_LIMIT}); "
            + "; ".join(reading(w) for w in checked)
            + f" (limits AE {AE_COS_LIMIT}, D {D_COS_LIMIT})"
            + ("" if movements else
               f"; not checked: {reading('parameter movements')}"))
        check(worst_loss[0] <= LOSS_RTOL_LIMIT, f"{label}: losses disagree")
        for what in checked:
            (ae, _), (d, _) = out[what]
            check(ae >= AE_COS_LIMIT and d >= D_COS_LIMIT,
                  f"{label}: {what} disagree")

    fused = run("fused step", SPLIT_STEPS)
    split = run("split_gan_step", SPLIT_STEPS, split_gan_step=True)
    agree("split vs fused", split, fused, movements=True)
    for i, ((lf, _), (ls, _)) in enumerate(zip(fused["launches"],
                                               split["launches"])):
        check(lf == ls, f"step {i}: split launches {ls}, fused {lf}")
        want = dict(TRAIN_STEP)
        check({k: v for k, v in ls.items() if v} == want,
              f"split step {i}: launches {ls}, expected {want}")
    del fused
    reuse = run("reuse_xrec", SPLIT_STEPS, reuse_xrec=True)
    for i, ((ls, _), (lr, _)) in enumerate(zip(split["launches"],
                                               reuse["launches"])):
        fewer = {k: ls[k] - lr[k] for k in ls if ls[k] != lr[k]}
        log(f"[split] step {i}: reuse_xrec launches {fewer} fewer than "
            "split_gan_step")
        check(fewer == ROUND_TRIP_SAVED, f"reuse_xrec step {i}: {fewer} "
              f"fewer, expected {ROUND_TRIP_SAVED}")
    del split, reuse

    accum = run("accumulate_grad_batches=2", ACCUM_STEPS,
                accumulate_grad_batches=2)
    check(accum["state"].ae_opt.every_k == 2
          and accum["state"].ae_opt.sched.last_epoch == ACCUM_STEPS // 2,
          "accumulation: not every 2 calls, or the schedule miscounted")
    same = [r["same"] for r in accum["records"]]
    log(f"[split] accumulation: parameters bit-equal to the previous "
        f"micro-step's after micro-steps 1-{ACCUM_STEPS}: {same}")
    check(same == [i % 2 == 0 for i in range(ACCUM_STEPS)],
          "accumulation moved parameters on a non-final micro-step, or "
          "none on a final one")
    accum_plain = run("accumulate_grad_batches=2 on the plain versions",
                      ACCUM_STEPS, plain=True, accumulate_grad_batches=2)
    agree("accumulation, kernels vs plain", accum, accum_plain,
          movements=False)
    del accum, accum_plain, model, tensors, init
    gc_cuda()
    return total


# -- phase 18: text conditioning and released checkpoints --------------------

CLIP_CAPTIONS = (
    "a photo of a red double-decker bus crossing a bridge at night",
    "two cats asleep on a sofa in the afternoon sun",
    "Café au lait & croissants on a marble table, 2 plates",
    "an aerial view of a coastline with white cliffs",
    "a watercolor painting of a lighthouse in a storm",
    "東京の夜景 from a rooftop bar",
    "a close-up of a hummingbird drinking from a flower",
    "an old map of the world, ½ scale, with sea monsters")
# shipped fp32 against the plain path (PERF.md section 2): each feature
# row's cosine, and its max abs difference over the row's norm
CLIP_COS_LIMIT, CLIP_REL_LIMIT = 0.99999, 1e-3
# bf16 (the bf16 prior step's per-leaf bar): 12 blocks whose bf16
# roundings fall in other places on the two paths put the features as far
# apart as bf16 is from fp32 (measured on an H100: cosine 0.999925 kernels
# vs plain, 0.999920 bf16 vs fp32; max abs difference 0.039 at |feature|
# <= 3.9, past phase 3's one-call limits, which phase 4 holds B8 to at
# this shape)
CLIP_BF16_COS_LIMIT = 0.999
# B8 launches of one forward: a block each
CLIP_TEXT_LAUNCHES, CLIP_VISION_LAUNCHES = 12, 24
# phase 18 (c): the prefix the restored ViTVQ drops and keeps its own values
CKPT_IGNORE = "loss.discriminator.final_linear"
CKPT_LOSS_SEED = 5


def openai_clip_state_dict(text, vision) -> dict:
    """The OpenAI CLIP state dict (``clip.load(...)``'s names and layouts)
    of a port text and vision tower: the inverse of
    ``models.cond.clip.load_torch_clip``'s map. The port's Dense weights
    are torch's (out, in) already."""
    sd = {}

    def blocks(tower, prefix):
        for i in range(tower.layers):
            blk = getattr(tower, f"resblocks_{i}")
            pre = f"{prefix}transformer.resblocks.{i}."
            for src, dst in (("ln_1", "ln_1"), ("ln_2", "ln_2"),
                             ("out_proj", "attn.out_proj"),
                             ("c_fc", "mlp.c_fc"), ("c_proj", "mlp.c_proj")):
                sd[pre + dst + ".weight"] = getattr(blk, src).weight
                sd[pre + dst + ".bias"] = getattr(blk, src).bias
            sd[pre + "attn.in_proj_weight"] = blk.in_proj.weight
            sd[pre + "attn.in_proj_bias"] = blk.in_proj.bias

    blocks(vision, "visual.")
    for name in ("conv1.weight", "class_embedding", "positional_embedding",
                 "proj", "ln_pre.weight", "ln_pre.bias", "ln_post.weight",
                 "ln_post.bias"):
        sd["visual." + name] = vision.get_parameter(name)
    blocks(text, "")
    for name in ("token_embedding.weight", "positional_embedding",
                 "text_projection", "ln_final.weight", "ln_final.bias"):
        sd[name] = text.get_parameter(name)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def reference_vitvq_state_dict(model) -> dict:
    """The reference (Lightning) state dict of a port ``ViTVQ`` and its
    loss's StyleGAN discriminator: the inverse of
    ``compat.torch_loader.load_vitvq_params`` and
    ``load_style_discriminator_params``. The reference's pixel bias is one
    per channel: the model's must repeat each over a patch."""
    import math
    m, p = model.module, model.patch_size
    sd = {}
    w = m.encoder.patch_embed.weight                      # (dim, c*p*p)
    sd["encoder.to_patch_embedding.0.weight"] = w.reshape(w.shape[0], -1, p, p)
    sd["encoder.to_patch_embedding.0.bias"] = m.encoder.patch_embed.bias
    w, b = m.decoder.to_pixel.weight, m.decoder.to_pixel.bias  # (c*p*p, dim)
    check(torch.equal(b, b[::p * p].repeat_interleave(p * p)),
          "the pixel bias is not one per channel")
    sd["decoder.to_pixel.1.weight"] = w.T.reshape(w.shape[1], -1, p, p)
    sd["decoder.to_pixel.1.bias"] = b[::p * p]
    block = (("0.norm", "norm1"), ("0.fn.to_qkv", "attn.to_qkv"),
             ("0.fn.to_out", "attn.to_out"), ("1.norm", "norm2"),
             ("1.fn.net.0", "ff.fc1"), ("1.fn.net.2", "ff.fc2"))
    for tower in ("encoder", "decoder"):
        t = getattr(m, tower).transformer
        for i in range(t.depth):
            for dst, src in block:
                layer = t.get_submodule(f"layers_{i}.{src}")
                sd[f"{tower}.transformer.layers.{i}.{dst}.weight"] = \
                    layer.weight
                if layer.bias is not None:
                    sd[f"{tower}.transformer.layers.{i}.{dst}.bias"] = \
                        layer.bias
        sd[f"{tower}.transformer.norm.weight"] = t.norm.weight
        sd[f"{tower}.transformer.norm.bias"] = t.norm.bias
    for name in ("pre_quant", "post_quant"):
        sd[f"{name}.weight"] = getattr(m, name).weight
        sd[f"{name}.bias"] = getattr(m, name).bias
    sd["quantizer.embedding.weight"] = m.quantizer.embedding
    log_size = int(math.log2(model.image_size))
    names = {"stem.conv.weight": "blocks.0.0.weight",
             "stem.act_bias": "blocks.0.1.bias",
             "final_conv.conv.weight": "final_conv.0.weight",
             "final_conv.act_bias": "final_conv.1.bias"}
    for j in range(1, log_size - 1):
        res = log_size - (j - 1)
        names.update({
            f"block_{res}.conv1.conv.weight": f"blocks.{j}.conv1.0.weight",
            f"block_{res}.conv1.act_bias": f"blocks.{j}.conv1.1.bias",
            f"block_{res}.conv2.conv.weight": f"blocks.{j}.conv2.1.weight",
            f"block_{res}.conv2.act_bias": f"blocks.{j}.conv2.2.bias",
            f"block_{res}.skip.conv.weight": f"blocks.{j}.skip.1.weight"})
    for i in (1, 2):
        for leaf in ("weight", "bias"):
            names[f"final_linear{i}.{leaf}"] = f"final_linear.{i - 1}.{leaf}"
    for name, param in model.loss.discriminator.named_parameters():
        sd["loss.discriminator." + names[name]] = param
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def feature_agreement(label, got, want) -> None:
    """Each row's cosine and max abs difference over its norm, against the
    shipped-fp32 limits."""
    got, want = got.double(), want.double()
    cos = float(F.cosine_similarity(got, want, dim=-1).min())
    rel = float(((got - want).abs().amax(-1) / want.norm(dim=-1)).max())
    ok = cos >= CLIP_COS_LIMIT and rel <= CLIP_REL_LIMIT
    log(f"[text] {label}, kernels vs plain: worst row cosine {cos:.9f} "
        f"(limit {CLIP_COS_LIMIT}), max abs diff / row norm {rel:.3e} "
        f"(limit {CLIP_REL_LIMIT:g}) -> {'pass' if ok else 'FAIL'}")
    check(ok and bool(torch.isfinite(got).all()), f"{label} disagrees")


def counted_forward(label, fn, want: dict):
    """``fn()`` with the launch counters reset just before and read just
    after; its launches must be ``want`` exactly."""
    from enhancing_tpu_torch.ops import LAUNCHES, reset_launches
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in LAUNCHES.items() if v}
    log(f"[text] {label}: launches {got}")
    check(got == want, f"{label}: launches {got}, expected {want}")
    return out, kernel_counts()


def clip_towers(x8) -> dict:
    """(a) Both CLIP towers at ViT-L/14 width in fp32 on captions of the
    port's tokenizer and (b) ``load_torch_clip`` at ViT-B/32 through the
    conditioners. Returns the launches by kernels-line name."""
    from enhancing_tpu_torch.models.cond import ClipImageCond, ClipTextCond
    from enhancing_tpu_torch.models.cond.clip import (CLIP_CONFIGS,
                                                      CLIPTextTransformer,
                                                      CLIPVisionTransformer,
                                                      preprocess_images)
    from enhancing_tpu_torch.ops import F32_LAUNCHES, LAUNCHES
    from enhancing_tpu_torch.utils.tokenizer import SimpleTokenizer
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    cfg = CLIP_CONFIGS["ViT-L/14"]
    t0 = time.perf_counter()
    tokens_np = SimpleTokenizer().tokenize(list(CLIP_CAPTIONS),
                                           cfg.context_length)
    log(f"[text] tokenized {len(CLIP_CAPTIONS)} captions in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms: "
        f"{int((tokens_np > 0).sum(1).max())} tokens at most")
    tokens = torch.from_numpy(tokens_np).long().cuda()
    images = torch.as_tensor(x8, device="cuda")
    t0 = time.perf_counter()
    text = CLIPTextTransformer(cfg, seed=18, device="cuda")
    torch.cuda.synchronize()
    t_text = time.perf_counter() - t0
    vision = CLIPVisionTransformer(cfg, seed=19, device="cuda")
    torch.cuda.synchronize()
    log(f"[text] ViT-L/14 towers: text {cfg.transformer_layers} x "
        f"{cfg.transformer_width} ({cfg.transformer_heads} heads of 64, "
        f"{cfg.context_length} tokens), vision {cfg.vision_layers} x "
        f"{cfg.vision_width} ({cfg.vision_heads} heads of 64, "
        f"{(cfg.image_resolution // cfg.vision_patch_size) ** 2 + 1} tokens"
        f" at {cfg.image_resolution} px), fp32, drawn on the card in "
        f"{t_text:.1f} + {time.perf_counter() - t0 - t_text:.1f} s")
    with torch.inference_mode():
        pixels = preprocess_images(images, cfg.image_resolution)
        res = cfg.image_resolution
        check(pixels.shape == (CHECK_BATCH, res, res, 3)
              and bool(torch.isfinite(pixels).all()), "preprocess_images")
        ft, counts = counted_forward(
            "ViT-L/14 text forward, batch 8", lambda: text(tokens),
            {"attention_bnhd": CLIP_TEXT_LAUNCHES})
        check(F32_LAUNCHES["attention_bnhd"] == CLIP_TEXT_LAUNCHES,
              "text tower: B8 launches not fp32")
        add(counts)
        fv, counts = counted_forward(
            "ViT-L/14 vision forward, batch 8", lambda: vision(pixels),
            {"attention_bnhd": CLIP_VISION_LAUNCHES})
        check(F32_LAUNCHES["attention_bnhd"] == CLIP_VISION_LAUNCHES,
              "vision tower: B8 launches not fp32")
        add(counts)
        check(ft.shape == fv.shape == (CHECK_BATCH, cfg.embed_dim),
              f"features {ft.shape} {fv.shape}")
        before = dict(LAUNCHES)
        with plain_versions():
            ft_p, fv_p = text(tokens), vision(pixels)
            text_plain_ms = time_ms(lambda: text(tokens), 3, warmup=1)
            vision_plain_ms = time_ms(lambda: vision(pixels), 3, warmup=1)
        check(LAUNCHES == before, "the plain path launched a kernel")
        feature_agreement("ViT-L/14 text features fp32", ft, ft_p)
        feature_agreement("ViT-L/14 image features fp32", fv, fv_p)
        text_ms = time_ms(lambda: text(tokens), 10)
        vision_ms = time_ms(lambda: vision(pixels), 10)
        log(f"[text] ViT-L/14 fp32 forward, batch 8: text {text_ms:.3f} ms "
            f"(plain {text_plain_ms:.3f}), vision {vision_ms:.3f} ms (plain"
            f" {vision_plain_ms:.3f}), preprocessing 256 -> {res} px "
            f"{time_ms(lambda: preprocess_images(images, res), 10):.3f} ms")
        del vision, fv, fv_p, pixels
        gc_cuda()

        # the text tower in bf16 (phase 4 holds its B8 calls to phase 3's
        # bf16 limits): features at the bf16 cosine bar of section 2
        t0 = time.perf_counter()
        text16 = CLIPTextTransformer(cfg, dtype="bfloat16", seed=18,
                                     device="cuda")
        torch.cuda.synchronize()
        log(f"[text] ViT-L/14 text tower in bf16 drawn in "
            f"{time.perf_counter() - t0:.1f} s")
        f16, counts = counted_forward(
            "ViT-L/14 text forward bf16, batch 8", lambda: text16(tokens),
            {"attention_bnhd": CLIP_TEXT_LAUNCHES})
        check(F32_LAUNCHES["attention_bnhd"] == 0,
              "bf16 text tower: fp32 B8 launches")
        add(counts)
        with plain_versions():
            f16_p = text16(tokens)
        def worst_cos(a, b):
            return float(F.cosine_similarity(a.float(), b.float(),
                                             dim=-1).min())

        err = float((f16.float() - f16_p.float()).abs().max())
        cos = worst_cos(f16, f16_p)
        ok = cos >= CLIP_BF16_COS_LIMIT
        log(f"[text] ViT-L/14 text features bf16, kernels vs plain: worst "
            f"row cosine {cos:.6f} (limit {CLIP_BF16_COS_LIMIT}), max_abs_err"
            f" {err:.3e} (|plain| max {float(f16_p.float().abs().max()):.3f})"
            f"; bf16 vs fp32: kernels {worst_cos(f16, ft):.6f}, plain "
            f"{worst_cos(f16_p, ft_p):.6f} -> {'pass' if ok else 'FAIL'}")
        check(ok and bool(torch.isfinite(f16).all()),
              "bf16 text features disagree")
        log(f"[text] ViT-L/14 bf16 text forward, batch 8: "
            f"{time_ms(lambda: text16(tokens), 10):.3f} ms")
        del text, text16, ft, ft_p, f16, f16_p
        gc_cuda()

    # (b) an OpenAI-layout checkpoint of seeded ViT-B/32 towers, read back
    # by the conditioners: features bit for bit the towers' own
    import os
    import shutil
    import tempfile
    b32 = CLIP_CONFIGS["ViT-B/32"]
    text = CLIPTextTransformer(b32, seed=20, device="cuda")
    vision = CLIPVisionTransformer(b32, seed=21, device="cuda")
    tmp = tempfile.mkdtemp(prefix="clip_ckpt_")
    try:
        path = os.path.join(tmp, "clip_vit_b32.pt")
        t0 = time.perf_counter()
        torch.save(openai_clip_state_dict(text, vision), path)
        log(f"[text] ViT-B/32 OpenAI-layout checkpoint: "
            f"{os.path.getsize(path) / 2**20:.0f} MiB written in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        text_cond = ClipTextCond(image_size=256, clip_model="ViT-B/32",
                                 clip_params_path=path, device="cuda")
        t_text = time.perf_counter() - t0
        t0 = time.perf_counter()
        image_cond = ClipImageCond(clip_model="ViT-B/32",
                                   clip_params_path=path, device="cuda")
        t_image = time.perf_counter() - t0
        log(f"[text] load_torch_clip through ClipTextCond {t_text:.2f} s, "
            f"ClipImageCond {t_image:.2f} s")
        with torch.inference_mode():
            want_t = text(tokens)
            want_i = vision(preprocess_images(images, b32.image_resolution))
        got_t, counts = counted_forward(
            "ClipTextCond.encode_codes ViT-B/32, batch 8",
            lambda: text_cond.encode_codes(tokens_np),
            {"attention_bnhd": b32.transformer_layers})
        add(counts)
        got_i, counts = counted_forward(
            "ClipImageCond.encode_codes ViT-B/32, batch 8",
            lambda: image_cond.encode_codes(images),
            {"attention_bnhd": b32.vision_layers})
        add(counts)
        equal = torch.equal(got_t, want_t) and torch.equal(got_i, want_i)
        log(f"[text] conditioners' features vs the seeded towers': "
            f"{'bit-equal' if equal else 'DIFFERENT'} (text "
            f"{tuple(got_t.shape)}, image {tuple(got_i.shape)}, no grad "
            f"{not got_t.requires_grad and not got_i.requires_grad})")
        check(equal and not got_t.requires_grad,
              "loaded CLIP features differ from the source towers'")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del text, vision, text_cond, image_cond
    gc_cuda()
    return total


def vitvq_checkpoint(x8) -> dict:
    """(c) ``ViTVQ(path=..., ignore_keys=...)`` at full width: a Lightning
    checkpoint of a seeded ``imagenet_vitvq_base.yaml`` model (its loss's
    discriminator included) restores codes and reconstructions bit for
    bit; the ignored prefix keeps the restored model's own values. Returns
    the launches by kernels-line name."""
    import copy
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from enhancing_tpu_torch.losses.discriminator import StyleDiscriminator
    from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                                  load_config)
    cfg = load_config(Path(__file__).resolve().parent / "configs"
                      / "imagenet_vitvq_base.yaml").model
    t0 = time.perf_counter()
    source = initialize_from_config(cfg, device="cuda")
    pp = source.patch_size ** 2
    bias = source.module.decoder.to_pixel.bias
    with torch.no_grad():   # a random bias, one per channel as saved
        bias.copy_(torch.randn(bias.numel() // pp,
                               generator=torch.Generator().manual_seed(3))
                   .repeat_interleave(pp).cuda())
    log(f"[ckpt] source imagenet_vitvq_base fp32 built in "
        f"{time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="vitvq_ckpt_")
    try:
        path = os.path.join(tmp, "vitvq_base.ckpt")
        t0 = time.perf_counter()
        torch.save({"state_dict": reference_vitvq_state_dict(source)}, path)
        log(f"[ckpt] Lightning-layout checkpoint: "
            f"{os.path.getsize(path) / 2**20:.0f} MiB written in "
            f"{time.perf_counter() - t0:.1f} s")
        restored_cfg = copy.deepcopy(cfg.to_dict())
        restored_cfg["params"].update(seed=1, path=path,
                                      ignore_keys=[CKPT_IGNORE])
        restored_cfg["params"]["loss"]["params"]["seed"] = CKPT_LOSS_SEED
        t0 = time.perf_counter()
        restored = initialize_from_config(restored_cfg, device="cuda")
        torch.cuda.synchronize()
        log(f"[ckpt] ViTVQ(path=..., ignore_keys=[{CKPT_IGNORE!r}]) built "
            f"and restored in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the discriminator: the source's, but for the ignored prefix, which
    # keeps the restored loss's own draw (seed + 1)
    fresh = dict(StyleDiscriminator(
        size=256, generator=torch.Generator().manual_seed(
            CKPT_LOSS_SEED + 1)).named_parameters())
    src_disc = dict(source.loss.discriminator.named_parameters())
    kept = differ = 0
    for name, got in restored.loss.discriminator.named_parameters():
        ignored = ("loss.discriminator." + name).startswith(CKPT_IGNORE)
        want = fresh[name].cuda() if ignored else src_disc[name]
        kept += ignored
        differ += ignored and not torch.equal(got, src_disc[name])
        check(torch.equal(got, want), f"discriminator {name} not as expected")
    check(differ > 0, "the ignored prefix holds the source's values")
    for name, got in restored.module.named_parameters():
        check(torch.equal(got, source.module.get_parameter(name)),
              f"{name} not restored")
    log(f"[ckpt] every tokenizer and discriminator parameter equal to the "
        f"source's, the {kept} of {CKPT_IGNORE!r} the restored model's own "
        f"({differ} of them unlike the source's)")
    with torch.inference_mode():
        want_codes = source.encode_codes(x8)
        want_rec = source.decode_codes(want_codes)
    (codes, rec), counts = counted_forward(
        "restored imagenet_vitvq_base round trip, batch 8",
        lambda: (lambda c: (c, restored.decode_codes(c)))(
            restored.encode_codes(x8)),
        SHIPPED["imagenet_vitvq_base"])
    equal = torch.equal(codes, want_codes) and torch.equal(rec, want_rec)
    log(f"[ckpt] restored codes and reconstructions vs the source's: "
        f"{'bit-equal' if equal else 'DIFFERENT'}")
    check(equal, "the restored model's round trip differs")
    del source, restored, fresh, src_disc
    gc_cuda()
    return counts


def phase_text_and_checkpoints(x8) -> dict:
    """Phase 18; returns its launches by kernels-line name."""
    t0 = time.perf_counter()
    total = clip_towers(x8)
    for k, v in vitvq_checkpoint(x8).items():
        total[k] = total.get(k, 0) + v
    log(f"[text] phase 18 took {time.perf_counter() - t0:.1f} s")
    return total


# -- phase 19: the CLI, checkpoints and resume, and the user scripts ---------

# (a) the train and validation steps an epoch the CLI runs take, cut from
# fake_vitvq_base.yaml's 512 and 8
CLI_STEPS = 2
# (b), (c): the PNG images of the evaluation folder (two batches of 8), the
# images reconstruct takes, the prior's depth (cut as phase 13 cuts it) and
# the classes sampled, two images each
CLI_IMAGES, CLI_RECON, CLI_PRIOR_LAYERS = 16, 4, 2
CLI_CLASSES = (1, 7, 42, 99)
CLI_TOP_K = 100
# a round trip of the shipped fp32 Base tokenizer, raw LAUNCHES names
DECODE_F32 = {"ln_gemm": 24, "attention": 12, "layernorm": 1}
# the fp32 prior's sample of 8 images at CLI_PRIOR_LAYERS layers, and the
# tokenizer's decode of its codes
CLI_SAMPLE_CALL = {"attention_bnhd": CLI_PRIOR_LAYERS,
                   "decode_attention": CLI_PRIOR_LAYERS * P_STEPS,
                   "cache_row_update": 2 * P_STEPS, **DECODE_F32}


def cli_configs(workdir, ckpt: str) -> None:
    """``workdir/configs``: the shipped configs as the CLI and scripts read
    them, cut to this phase's size and written by the port's YAML writer,
    and ``workdir/imagenet/val``: an ImageNet-layout folder of PNGs."""
    from pathlib import Path

    from enhancing_tpu_torch.utils import yaml_io
    from enhancing_tpu_torch.utils.logging import encode_png
    repo = Path(__file__).resolve().parent
    (workdir / "configs").mkdir()
    train = yaml_io.load(repo / "configs" / "fake_vitvq_base.yaml")
    for split in ("train", "validation"):
        train["dataset"]["params"][split]["params"]["length"] = \
            CLI_STEPS * TRAIN_BATCH
    yaml_io.dump(train, workdir / "configs" / "fake_vitvq_base_cli.yaml")

    folder = {"target": "enhancing_tpu.data.imagenet.ImageNetValidation",
              "params": {"root": str(workdir / "imagenet"),
                         "resolution": 256}}
    recon = yaml_io.load(repo / "configs" / "imagenet_vitvq_base.yaml")
    recon["dataset"]["params"].pop("train")
    recon["dataset"]["params"]["validation"] = folder
    yaml_io.dump(recon, workdir / "configs" / "imagenet_vitvq_base_cli.yaml")
    prior = yaml_io.load(repo / "configs" / "imagenet_gpt_vitvq_base.yaml")
    p = prior["model"]["params"]
    p["transformer"]["params"]["n_layers"] = CLI_PRIOR_LAYERS
    p["stage1"]["params"]["path"] = ckpt
    p["cond"]["params"]["class_name"] = str(repo / p["cond"]["params"][
        "class_name"])
    prior["dataset"]["params"].pop("train")
    prior["dataset"]["params"]["validation"] = folder
    prior["dataset"]["params"]["batch_size"] = SAMPLE_BATCH
    yaml_io.dump(prior, workdir / "configs" /
                 "imagenet_gpt_vitvq_base_cli.yaml")

    rng = np.random.default_rng(19)
    for i in range(CLI_IMAGES):
        d = workdir / "imagenet" / "val" / f"n{i % 2:08d}"
        d.mkdir(parents=True, exist_ok=True)
        low = rng.random((36 + i % 3, 40 - i % 4, 3))
        img = np.repeat(np.repeat(low, 8, axis=0), 8, axis=1)
        (d / f"img{i:02d}.png").write_bytes(encode_png(
            (img * 255).astype(np.uint8)))


def payload_tensors(tree, prefix=""):
    """(path, leaf) of a checkpoint payload, depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from payload_tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from payload_tensors(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def payload_diff(got, want) -> list:
    """The paths where two payloads differ (tensors bit for bit)."""
    got, want = dict(payload_tensors(got)), dict(payload_tensors(want))
    if got.keys() != want.keys():
        return sorted(set(got) ^ set(want))
    return [k for k, v in want.items()
            if not (torch.equal(got[k].cpu(), v.cpu())
                    if isinstance(v, torch.Tensor) else got[k] == v)]


def moments_cosine(got, want, group: str) -> float:
    """The least cosine between two payloads' AdamW first moments of one
    optimizer (``ae_opt`` or ``disc_opt``), phase 17's measure."""
    a = got[group]["opt"]["state"]
    b = want[group]["opt"]["state"]
    return min(float(F.cosine_similarity(a[i]["exp_avg"].double().flatten(),
                                         b[i]["exp_avg"].double().flatten(),
                                         dim=0)) for i in b)


def cli_train_resume(workdir) -> dict:
    """(a) ``main(argv)`` on the cut fake_vitvq_base: run A two epochs
    straight, run B one epoch then ``--resume`` to two; launches asserted
    per run, the restored state held to the saved one, run B's last
    checkpoint to run A's. Returns the launches by kernels-line name."""
    import os

    from enhancing_tpu_torch import main as cli
    from enhancing_tpu_torch.ops import LAUNCHES, reset_launches
    from enhancing_tpu_torch.train import Trainer
    from enhancing_tpu_torch.train.checkpoint import CheckpointDir
    total: dict = {}
    epoch = {k: CLI_STEPS * (TRAIN_STEP.get(k, 0) + EVAL_STEP.get(k, 0))
             + ROUND_TRIP.get(k, 0) for k in LAUNCHES}
    restore_check = {}
    resume = Trainer._maybe_resume

    def checked_resume(self, model, state):
        start = resume(self, model, state)
        if start == 0:
            return start
        t0 = time.perf_counter()
        bad = payload_diff(self._payload(model, state),
                           self.restore(start - 1))
        restore_check.update(bad=bad, seconds=time.perf_counter() - t0)
        return start

    def run(tag, argv, epochs):
        reset_launches()
        t0 = time.perf_counter()
        trainer = cli.main(["-c", "fake_vitvq_base_cli", "--log_every", "1",
                            *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in LAUNCHES.items() if v}
        want = {k: epochs * v for k, v in epoch.items() if v}
        steps = np.diff(trainer.step_ends) * 1e3
        saves = ", ".join(f"epoch {e} {os.path.getsize(p) / 1e9:.3f} GB in "
                          f"{s:.2f} s" for e, p, s in trainer.saves)
        log(f"[cli] run {tag}: {wall:.1f} s, global step "
            f"{trainer.global_step}, steps after the first "
            f"{', '.join(f'{v:.1f}' for v in steps)} ms (host clock between "
            f"step ends, logging every step; the epochs' validation and "
            f"saves fall between steps 2 and 3), saves: {saves}, launches "
            f"{got}")
        check(got == want, f"run {tag}: launches {got}, expected {want}")
        for k, v in kernel_counts().items():
            total[k] = total.get(k, 0) + v
        return trainer

    Trainer._maybe_resume = checked_resume
    try:
        run_a = workdir / "run_a"
        a = run("A (-e 2)", ["-e", "2", "--run_dir", str(run_a)], 2)
        run_b = workdir / "run_b"
        run("B (-e 1)", ["-e", "1", "--run_dir", str(run_b)], 1)
        b = run("B (--resume -e 2)", ["-e", "2", "--resume", "--run_dir",
                                      str(run_b)], 1)
    finally:
        Trainer._maybe_resume = resume
    check(a.global_step == b.global_step == 2 * CLI_STEPS,
          f"global steps {a.global_step}, {b.global_step}")
    log(f"[cli] restore of the epoch-0 checkpoint: {b.restore_seconds:.2f} s;"
        f" the restored state vs the saved one, tensor by tensor: "
        f"{'bit-equal' if not restore_check['bad'] else restore_check['bad']}"
        f" (compared in {restore_check['seconds']:.2f} s)")
    check(not restore_check["bad"], "the restored state differs")
    # the two runs' first epochs, both uninterrupted on the same inputs:
    # whether the path repeats its own bits from run to run
    first = payload_diff(CheckpointDir(run_b / "ckpt").load(0),
                         CheckpointDir(run_a / "ckpt").load(0))
    log(f"[cli] runs A and B after their first epoch (both uninterrupted): "
        f"{'bit-equal' if not first else f'{len(first)} leaves differ'}")
    got = CheckpointDir(run_b / "ckpt").load(1)
    want = CheckpointDir(run_a / "ckpt").load(1)
    bad = payload_diff(got, want)
    if bad:
        cos = {g: moments_cosine(got, want, g) for g in ("ae_opt", "disc_opt")}
        log(f"[cli] run B's last checkpoint vs run A's: {len(bad)} of "
            f"{len(dict(payload_tensors(want)))} leaves differ (e.g. "
            f"{bad[:3]}); AdamW first moments' least cosine AE "
            f"{cos['ae_opt']:.6f} (limit {AE_COS_LIMIT}), D "
            f"{cos['disc_opt']:.6f} (limit {D_COS_LIMIT}) -> within phase "
            f"17's limits")
        check(cos["ae_opt"] >= AE_COS_LIMIT and cos["disc_opt"] >= D_COS_LIMIT,
              "the resumed run departs from the uninterrupted one")
    else:
        log("[cli] run B's last checkpoint vs run A's: bit-equal (parameters, "
            "buffers, AdamW moments, LR schedules, step counters)")
    for d in (run_a, run_b):
        import shutil
        shutil.rmtree(d / "ckpt")
    return total


def cli_scripts(workdir, ckpt: str, source) -> dict:
    """(b) reconstruct and evaluate on the reference checkpoint ``ckpt`` of
    ``source``; (c) sample and eval_samples on the cut prior over it.
    Returns the launches by kernels-line name."""
    from enhancing_tpu_torch.eval.inception import (fid_feature_fn,
                                                    init_inception)
    from enhancing_tpu_torch.ops import LAUNCHES, reset_launches
    from enhancing_tpu_torch.scripts import (eval_samples, evaluate,
                                             reconstruct, sample)
    total: dict = {}

    def counted(label, fn, want):
        gc_cuda()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in LAUNCHES.items() if v}
        log(f"[cli] {label}: {time.perf_counter() - t0:.1f} s (model build "
            f"and restore included), launches {got}")
        check(got == want, f"{label}: launches {got}, expected {want}")
        for k, v in kernel_counts().items():
            total[k] = total.get(k, 0) + v
        return out

    images = sorted(str(p) for p in (workdir / "imagenet").glob("*/*/*.png"))
    rec = counted(f"reconstruct, {CLI_RECON} images", lambda: reconstruct.main(
        ["-c", "imagenet_vitvq_base_cli", "--ckpt", ckpt,
         *images[:CLI_RECON], "-o", str(workdir / "recon")]),
        SHIPPED["imagenet_vitvq_base"])
    with torch.inference_mode():
        want = source.encode_codes(rec["images"]).cpu().numpy()
    equal = np.array_equal(rec["codes"], want)
    log(f"[cli] reconstruct: codes {rec['codes'].shape} "
        f"{'equal to' if equal else 'DIFFERENT from'} the source model's, "
        f"MSE {rec['mse']:.5f}, grids "
        f"{sorted(p.name for p in (workdir / 'recon').iterdir())[:3]}...")
    check(equal and np.isfinite(rec["reconstructions"]).all(),
          "reconstruct disagrees with the source model")
    res = counted("evaluate --max-batches 2", lambda: evaluate.main(
        ["-c", "imagenet_vitvq_base_cli", "--ckpt", ckpt, "--max-batches",
         "2"]), {k: 2 * v for k, v in SHIPPED["imagenet_vitvq_base"].items()})
    log(f"[cli] evaluate: {json.dumps(res)}")
    check(res["num_images"] == CLI_IMAGES and all(
        np.isfinite(v) for v in res.values()), "evaluate's result")

    path = str(workdir / "pt_inception_random.pth")
    net = init_inception(seed=19, device="cpu")
    sd = dict(net.state_dict(), **{"fc.weight": torch.zeros(1008, 2048),
                                   "fc.bias": torch.zeros(1008)})
    torch.save(sd, path)
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(7))
    want = fid_feature_fn(net)(x)
    got = fid_feature_fn(init_inception(path, device="cuda"))(x.cuda()).cpu()
    err = float((got - want).abs().max() / want.abs().max())
    log(f"[cli] InceptionV3 pool3 from the torchvision-layout file, card "
        f"(cuDNN, no TF32) vs CPU at batch 2: max abs difference over the "
        f"largest |feature| {err:.3e} (|CPU| max "
        f"{float(want.abs().max()):.3e}; limit 1e-4)")
    check(err <= 1e-4, "Inception features on the card disagree")

    argv = ["-c", "imagenet_gpt_vitvq_base_cli", "--top_k", str(CLI_TOP_K)]
    out = counted(f"sample, {len(CLI_CLASSES)} classes x 2, fp32 prior "
                  f"{CLI_PRIOR_LAYERS} x {P_WIDTH}", lambda: sample.main(
                      [*argv, "--classes", *map(str, CLI_CLASSES), "-n", "2",
                       "-o", str(workdir / "samples")]), CLI_SAMPLE_CALL)
    px, codes = out["pixels"], out["codes"]
    check(px.shape == (SAMPLE_BATCH, 256, 256, 3) and np.isfinite(px).all()
          and codes.shape == (SAMPLE_BATCH, 1024) and codes.min() >= 0
          and codes.max() < P_VOCAB, f"samples {px.shape} {codes.shape}")
    res = counted("eval_samples, 8 samples, Inception weights from a file",
                  lambda: eval_samples.main(
                      [*argv, "--num_samples", str(SAMPLE_BATCH), "--batch",
                       str(SAMPLE_BATCH), "--inception_weights", path]),
                  CLI_SAMPLE_CALL)
    log(f"[cli] eval_samples: {json.dumps(res)}")
    check(res["feature_trunk"] == "inception_pool3"
          and res["num_real"] == SAMPLE_BATCH
          and np.isfinite(res["frechet_distance"]), "eval_samples' result")
    return total


def phase_cli() -> dict:
    """Phase 19: the CLI and the user scripts from config files, in a
    temporary working directory (deleted after). Returns its launches by
    kernels-line name."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                                  load_config)
    t0 = time.perf_counter()
    # wandb, where it imports, logs nowhere
    os.environ["WANDB_MODE"] = "disabled"
    workdir = Path(tempfile.mkdtemp(prefix="cli_"))
    cwd = os.getcwd()
    try:
        ckpt = str(workdir / "imagenet_vitvq_base_reference.ckpt")
        cli_configs(workdir, ckpt)
        os.chdir(workdir)
        total = cli_train_resume(workdir)
        gc_cuda()
        # seed 1: the scripts build the config's seed 0, so only the
        # checkpoint can give them the source's weights
        cfg = load_config(Path(__file__).resolve().parent / "configs"
                          / "imagenet_vitvq_base.yaml").model
        cfg.params.seed = 1
        source = initialize_from_config(cfg, device="cuda")
        t1 = time.perf_counter()
        torch.save({"state_dict": reference_vitvq_state_dict(source)}, ckpt)
        log(f"[cli] reference checkpoint of imagenet_vitvq_base at seed 1: "
            f"{os.path.getsize(ckpt) / 2**20:.0f} MiB written in "
            f"{time.perf_counter() - t1:.2f} s")
        for k, v in cli_scripts(workdir, ckpt, source).items():
            total[k] = total.get(k, 0) + v
        del source
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    gc_cuda()
    log(f"[cli] phase 19 took {time.perf_counter() - t0:.1f} s")
    return total


def main() -> int:
    import enhancing_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    errs = phase_compare()
    times = phase_times()
    serving, x8, codes8 = phase_main_path()
    training = phase_train()
    sampling, prior, codes = phase_sampling()
    serving8 = phase_int8(prior, codes)
    del prior
    fused = phase_fused_serving()
    fused_routes = phase_fused_routes(x8)
    shipped = phase_shipped_configs(x8, codes8)
    training32 = phase_train_f32()
    prior32 = phase_prior_f32()
    prior_train = phase_prior_train()
    rq = phase_rq()
    rq_train = phase_rq_train()
    gumbel = phase_gumbel_train()
    split = phase_split_accumulate()
    text = phase_text_and_checkpoints(x8)
    cli = phase_cli()
    phases = (serving, training, sampling, serving8, fused, fused_routes,
              shipped, training32, prior32, prior_train, rq, rq_train,
              gumbel, split, text, cli)
    kernels = []
    for kname in REPLACES:
        rows = times[kname]
        # a kernel with several main-path shapes (ln_gemm: qkv and fc1 of a
        # block; fir and fused_act: every call of one discriminator
        # forward) sums them, as do its bound, plain and library times
        agg = {key: sum(r[key] for r in rows)
               for key in ("ms", "plain_ms", "bound_ms")}
        agg["library_ms"] = (None if rows[0]["library_ms"] is None
                             else sum(r["library_ms"] for r in rows))
        for key in ("bound_f32_simt_ms", "graph_ms", "library_graph_ms"):
            if key in rows[0]:
                agg[key] = (None if rows[0][key] is None
                            else sum(r[key] for r in rows))
        kernels.append(dict(name=kname, route="cuda", source=SOURCES[kname],
                            replaces=REPLACES[kname],
                            launches=sum(p.get(kname, 0) for p in phases),
                            max_abs_err=errs[kname],
                            bound_by=rows[0]["bound_by"], **agg))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
