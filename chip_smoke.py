#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccv_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --slow-profiles  # also ICF's, BBF's and TLD's
                                           # profiles (~110 s more)
    python3 chip_smoke.py --nccl-cards 4   # phase 32 (b) alone over NCCL,
                                           # a rank a card

Builds every kernel from ccv_tpu_torch/csrc with nvcc (one nvcc per source,
started together) and drives the port's main paths:

- SCD face detection (phases 3-5): the cascade kernel K1 (phase planes,
  distinct corners, survivor compaction) against its plain PyTorch version,
  then ``ccv_tpu_torch.detectors.scd.detect`` with the
  repository's face cascade (tests/data/face_low.sqlite3): the crop180
  window sets against the C goldens, and a 640x480 and a 1920x1080 frame
  against the same path with the plain evaluator;
- transformer-LM training (phases 6-7): the flash-attention kernels K2a
  (forward), K2b (dq) and K2c (dk, dv) against their plain versions at the
  parity tests' shapes and the LM's, each launch checked for its design
  ("wgmma-tma" at bf16 and float16 and head dim 32, 64 or 128; in float32
  "tc-f32" for all three, D 32 on operands zero-padded to 64; the D 32
  shapes in float16 too), timed at the LM shape and, in bf16 and float16,
  at 16 x 16 heads of 32 (T 1024, causal; beside the D 64 kernels on the
  same tensors zero-padded to 64 and the exp2 floor) in turns with the
  PyTorch calls that compute the same functions (yardsticks only: SDPA's
  flash forward, the flash backward op); a 2-layer
  step at the LM's widths with the kernels against
  one with plain attention, then ``ccv_tpu_torch.bin.lm_bench.measure`` at
  its defaults (GPT-2-medium shape, 24 layers) for a warm-up step and a few
  timed steps;
- the staged SCD cascade (phases 8-9): the phase kernel K3 against its
  plain version on the phase-A and phase-B1 tables of synthetic cascades
  (one of SCD's three box layouts, one whose stage 0 holds 20 features and
  one of 1,100, past a 512-feature run of records) and of the face cascade
  at the 1080p level-0 SAT, then K3 timed alone on both face tables off
  one plane copy, the copy alone and the plain version; then
  ``detect(form="pallas")`` on crop180 against the C goldens with K3's
  launches (phases A and B1 of every octave and overflow rerun) counted,
  at 640x480 and 1920x1080 against ``form="pallas_full"`` with both timed
  in turns, and ``detect_batch`` of four 1080p frames in both forms
  against per-image ``detect``;
- phase 10: the 1080p ``detect`` in both forms under torch.profiler, for
  the card's busy time per image, K1's share of the default form's and
  K3's and the B2 gathers' share of the staged form's;
- phase 11: the up-scaled ``detect`` (``ScdParams(size=(24, 24))``, so the
  1080p frame becomes 3840x2160 by INTER_CUBIC before the pyramid) in both
  forms, with K1's and K3's launches counted, against K1's plain version
  and each other, the up-scale on the card against the CPU's;
- phase 12: ``ccv_tpu_torch.serve.server`` on the card in a thread, its
  ``/scd/detect.objects`` answers (1080p frame as PNG, raw and multipart,
  and crop180) against direct ``detect`` calls, its error paths, JPEG
  bodies (libjpeg where its header is found, else PIL, as ``ccv_tpu``'s
  read: the 1080p frame as a JPEG against direct ``detect``, a truncated
  one 400), and its request latency at 1080p;
- phase 13: image classification (no kernel of its own: cuDNN's
  convolutions and cuBLAS's matmuls): a narrow ``Sequential`` and VGG-D
  (10 classes, 64 x 64) on the card against the CPU in float32 and bf16,
  the reference-written tiny convnets (float32 and half-precision files)
  classifying text_test.png on the card as on the CPU, the cnnclassify CLI
  on the card, ``ccv_tpu_torch.bin.vgg_bench.measure`` at bench.py's size
  (VGG-D, B 32, 224 x 224, bf16: images/s, ms a batch, MFU; two images
  of that batch against the CPU, and the logits' distance from a forward
  that rounds each convolution once, as ccv_tpu does), and last, 3
  batches under torch.profiler (busy, idle share, the convolutions' and
  the dtype casts' shares). No JPEG is decoded here;
- phases 14-18, the encoder-decoder at wmt.c's widths (6 + 6 layers, d
  512, 8 heads of 64, ff 2048, max_len 128, vocab 32,768 a side) and the
  encoder classifier: K2 at head dim 16 (the demos', zero-padded to 32
  inside ``flash_attention``) and at the decode's and the wmt step's
  shapes against its plain versions, K2a timed at the decode shape beside
  SDPA's flash forward (CUDA events, and the profiler's device time); both
  forwards at 2 layers on the card against the CPU; ``greedy_decode`` on
  32 source rows of 128 (6 K2a launches a step, no K2b or K2c; each
  chosen token held to a teacher-forced pass with plain attention); the
  wmt step at B 16 x 128 at dropout 0 (6 K2a, K2b and K2c a step) and 0.1
  (none), and its gate against plain attention in float32 and bf16; the
  imdb demo at its CLI defaults and its classifier through K2 against
  plain attention; ``Model.fit`` through ScaledDotProductAttention(16, 32)
  in bf16 (the D 32 kernels' main path, one launch each) against the plain
  route; last, their profiles (busy, idle share, device ms by kind of
  kernel);
- phases 19-21, ICF, SWT and SIFT (torch ops, no kernel of their own, as
  ``ccv_tpu`` runs XLA ops): ICF at 1080p with a seeded synthetic cascade
  of 2,000 depth-2 trees (pedestrian.icf's count; 10 channels on an RGB
  frame tiled from crop180.png, and an 8-channel one on the gray frame),
  written with ``write_cascade`` and read back, thresholds near the
  running sums' quantiles so that windows end in phases A, B1 and B2, the
  card's windows against the port's CPU path (margin as SCD's; on the
  frame's top-left 540 x 960 quarter), ms per
  image at default ``IcfParams``, ``bin/icfdetect`` and
  ``/icf/detect.objects``; SWT on text_test.png (edges, sobels and stroke
  maps bit for bit the CPU's, words against text_test.swt.txt at IoU >=
  0.7) and the 1080p frame (words equal the CPU's, ms per image, the stage
  breakdown), ``bin/swtdetect`` and ``/swt/detect.words``; SIFT's
  siftmatch (a 480x360 object in the 1080p scene: >= 97% of keypoints
  card = CPU within 0.5 px, 5% of scale and 0.05 rad both ways, their
  descriptors within 1e-3; ``match_pair`` = ``sift`` + ``match``; ms per
  pair), ``bin/siftmatch`` and ``/sift``; their profiles last (ICF's
  colour cascade alone, with ``--slow-profiles``);
- phases 22-26, BBF, DPM with HOG, MSER / MSCR, DAISY and TLD (torch ops,
  the host C++ of MSER / MSCR and numpy; no kernel of their own, as
  ``ccv_tpu`` runs no Pallas kernel there): BBF on the 1080p gray frame
  with a seeded 24x24 cascade of 16 stages (written with
  ``write_cascade`` and read back, thresholds graded on the frame's stage
  sums so that windows end at every stage), the card's windows against
  the port's CPU path on a 480x270 crop (the CPU's dense gathers at 1080p
  would take minutes), grouped rects equal, ms per 1080p image,
  ``bin/bbfdetect`` and ``/bbf/detect.objects``; DPM on the 1080p RGB
  frame with a seeded 2-root, 8-part model (12x5 cells) in the text
  format, card against CPU at 1080p with interval 0 and at 640x480 with
  the defaults, ms per image, ``bin/dpmdetect`` and
  ``/dpm/detect.objects``; msermatch on the gray frame and MSCR on the RGB
  one, card against CPU, ``bin/msermatch`` and ``/mser``; DAISY card
  against CPU on a 256x256 crop and timed at 1080p; TLD over 3 frames of
  1920x1080 (crop180.png pasted on the text at known shifts), IoU >= 0.7,
  card against CPU (the CPU path in a spawned child process from the
  script's start, beside the card's phases), ms per frame, ``bin/tld``, ``/tld/track.object`` and
  ``/convnet/classify``; their profiles last (BBF's and TLD's with
  ``--slow-profiles``);
- phase 27, ccv's classic surface (torch ops and the host siphash; no
  kernel): with the cache on, the 17 ``compat`` ops and ``ccv_otsu`` on the
  1080p gray and RGB frames against the same calls on the CPU (integer
  outputs equal, float within 1e-5 of the largest, contrast within 1 at
  <= 0.1% of the pixels), each again as a hit (same signature and tensor,
  no CUDA kernel under torch.profiler, in a window that must also show
  its HIT_CONTROL control kernels), a CPU matrix of the same bytes
  answered on the CPU, eviction, drain and disable, PNG and CCVBINDM
  writes read back, ``core.numeric`` on the card against the CPU (FFT
  filter, distance transform at (270, 480), invert / solve / eigen at
  256x256, a torch COO product) and ``bin/msermatch``'s out.png at 1080p,
  ms per op first call and hit;
- phase 28, SWT with ``letters="device"``: on text_test.png and the 1080p
  frame the card's letter rows equal the CPU's and the words the compact
  route's; both routes' stage timings and counts (painted cells,
  candidates, kept letters, overflows to the compact route), the device
  stage at 1080p with the caps raised (a diagnostic), and each route's
  profile last;
- phase 29, the graph model (``nn/functional.Model``; no kernel of the
  port's own: cuDNN's convolutions, torch ops): ResNet50-v1d + FPN with the
  shared RPN head (``models/resnet.py``) at full width, seeded weights, at
  COCO's inference scale 800 x 1344: one image in float32 on the card
  against the CPU (P2..P6 and the RPN maps), B 2 in bf16 against float32
  on the card (beside a control with batch norm in bf16), the bf16
  forward timed (ms a batch, images/s, MFU from the built graph's
  convolution FLOPs), its profile last (busy, idle share, the top four
  device ops; the events of three batches three times one's, busy within
  the CUDA events' span, and the same batches without the profiler);
- phase 30, the rest of nn on the card against the CPU: a graph model
  with ``ScaledDotProductAttention`` (16 heads of 64, B 4 x T 1024, bf16),
  whose attention launches K2a (counted by the wrapper, and by kernel name
  under torch.profiler, last); LSTM (one way and both) and GRU at B 32 x
  T 64 x 256; ConvolutionTranspose, the three norms, upsample, nms on 2000
  boxes and roi_align; the MoE forward (8 experts, top 2, 1024 / 4096, 4096
  tokens); ``depalettize_device`` on the three goldens; LSSC; while_loop
  and case_of;
- phase 31, training: path B, phase 30's attention model trained through
  ``Model.fit`` under compile(adamw, "mse") (K2a forward, K2b and K2c
  backward, one launch each a step, counted by the wrappers and by kernel
  name under torch.profiler): one fit in float32 with the kernels against
  one on the plain route (``layers.attention_route`` patched, a control)
  from the same weights and batch (loss, gradients; every fit's update
  against AdamW's first step of its own gradients), the bf16 fit's
  gradients held to the float32 fit's within 1.5x the bf16 plain route's
  distance, the bf16 fit timed beside the plain route's, and K2 alone at
  its attention shape; path A, the coco trainer
  (``ccv_tpu_torch.bin.coco``: ResNet50-v1d-FPN + RPN, batch norm in
  training, sgd with clipping) on the card against the CPU at B 1 x 256 x
  256 in float64 (loss, every gradient, batch-norm statistics) and float32
  (loss, batch-norm statistics, each gradient's distance from float64
  printed), timed at B 2 x 800 x 1344 in float32 (ms a step, images/s, MFU over
  the float32 peak, peak memory, the host's batch assembly) and profiled
  last (busy, idle share, the top four device ops); ``coco --demo`` on the
  card (20 steps at 96 x 96, twice under deterministic algorithms, equal
  to the bit, the loss under 1.25); an imdb_lstm fit,
  ``DynamicGraph.minimize``, a micro ``Combine`` forward and backward and
  ``Dataframe.iter(prefetch=2)`` onto the card, each against the CPU;
  and the float32 coco loss's distance from float64 at
  tests/test_torch_coco.py's input;
- phase 32, parallelism on torch.distributed (``ccv_tpu_torch.parallel``),
  its ranks spawned in child processes: (a) one NCCL rank, the world-1
  ``--data-parallel 1`` wmt step at wmt.c's widths against the un-parallel
  step (loss, parameters and Adam's moments to the bit), K2a/b/c 6 / 6 / 6
  counted and by name in a profiled step, ms against the un-parallel step,
  busy and idle, the allreduce's ms, and the CLI with and without
  ``--data-parallel 1``; (b) two gloo ranks on the one card: a probe of
  the collectives on CUDA tensors (allreduce, all_gather, and send / recv,
  which ``ppermute`` stages through pinned host memory; each required),
  then data parallelism at B 16, tp 2 against tp 1 at lm_bench's widths
  (float64, and float32 through K2), ring attention at sp 2 and GPipe over
  2 stages (ms a step and the staging copies);
- phase 33, K2 at head dim 128: the bf16 kernels ("wgmma-tma", m64n128
  products over two 64-column halves) and the f32 ones ("tc-f32")
  against their plain versions at phase 6's parity shapes at D 128 and at
  the LM step's (B 4 x H 16, T 1024), D 96 zero-padded to 128 through
  ``flash_attention``, and the three kernels timed at the LM step's shape
  in turns with the library calls;
- phase 34, the LM at head dim 128 (d 2048 = 16 heads of 128, ff 8192, 2
  layers, B 4 x T 1024, bf16): ``lm_bench.measure``'s step through K2 at
  D 128 (launches by design, ms a step), and the forward's logits against
  the CPU port's float32 forward within 3e-2 of the largest;
- phase 35, SCD training (``train.scd``) at the published 40 x 40 patch
  and 1,631 features, 2 stages of at most 6 features, on seeded patches
  from crop180.png, crop120.png and text_test.png: the card against the CPU
  port from the same draws (the same features, thresholds within 1e-4),
  seconds a stage, an Adam step's ms and the card's idle share; the
  cascade written, loaded and run by ``detect`` on the 1080p RGB frame
  through K1 (launches counted) against the plain route;
- phase 36, ICF training (``train.icf``) at the published 30 x 60 patch
  and 2,000 random features, 8 trees: the card's cascade equal to the CPU
  port's;
- phases 37-39, BBF, SWT and DPM training (``train.{bbf,swt,dpm}``; no
  kernel on their paths): BBF's cascade on the card equal to the CPU
  port's to the bit, then bbfcreate's defaults on 4,000 gray patches
  (seconds a stage, ms a generation, the idle share) and the trained
  cascade's windows on the card against the CPU port's; SWT's search over
  text_test.png and the 1080p frame, the same parameters on both; DPM on
  the card within 1e-3 of the CPU port, then dpmcreate's published setting
  on 24 + 24 seeded 640 x 480 scenes, depth cut (seconds a relabel and a
  data mining, the SVM fit's ms, the idle share), and the model's 1080p
  ``detect``;
- phase 40, the legacy convnet's trainer (``models.convnet.
  supervised_train``): bin/cifar-10's net at its published geometry and
  settings on 2,048 seeded images for 2 epochs (ms a step, the losses), one
  step in float64 on the card against the CPU port within 1e-9 of each
  leaf's largest; bin/image-net's MattNet-C at full width (225 x 225, 1000
  classes) at B 64, 5 steps in float32 (ms a step, FLOPs and the rate,
  busy and idle under the profiler), its working file written, read back
  on the card and classifying; bin/cnnvldtr on its answers;
- phase 41, ``nn.autotune`` from an empty store: SCD's ``form="auto"`` on
  the 1080p frame (per octave the recorded choice of K1's and K3's octave
  programs with both times on zeros and on the frame; K1 and K3 launched
  by the measurement; the detections equal to pallas_full's; a second call
  measures nothing), and ``sat_auto`` at ICF's colour 1080p level shapes
  (choice and times), ICF on the card held against the CPU port on the
  same SAT forms by phase 19's gate on the frame's top-left quarter (every
  other phase pins
  ``CCV_TPU_SAT=sat``, the form they always ran);
- phase 42, the explicit forms at 1080p: SCD's ``slices``, ``xla`` and
  ``matmul`` against ``pallas_full``, ICF's fused ``slices`` and ``matmul``
  against its staged form, ms of each;
- phase 43, K2 at head dims above 128 and in float16: the wgmma-tma
  kernels at D 256 in bf16 and float16, the tc-f32 kernels (float32: K2a
  from D 64 to 256, K2b and K2c from D 64 up: 3xTF32 mma.sync; timed at D
  64, 128, 256 and 576) and the tc-wide kernels (above D 256: K2a in every
  type, K2b and K2c in 16-bit; mma.sync, native 16-bit products, q and do
  or k and v resident where they fit and streamed above; timed at bf16 D
  320 and 512, K2a also at float32 D 576) against their plain versions,
  each launch's design checked, and timed beside SDPA's calls;
  the LM at Gemma-2B's widths (d 2048 = 8 heads of 256, ff 16384, vocab
  256,000, 2 layers, B 4 x 1024): one step with the kernels against one
  with plain attention in float32 and bf16, the float32 training step
  timed, then ``lm_bench.measure``; greedy decoding at d 1024 = 4 heads
  of 256; ``Model.fit`` through ``ScaledDotProductAttention(8, 256)`` in
  float32 and bf16 against the plain route, and through
  ``ScaledDotProductAttention(8, 320)`` in bf16 (tc-wide, all three).

Prints one line per phase, then a JSON line of kernel results (time, plain
and library time, the bound from ``ops/kernels/roofline.py`` for this run's
inputs, launches on the main path, design), the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Any failed check raises and the exit code is not 0. Needs a CUDA
device; imports no JAX.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import sqlite3
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
STEP = 4
MARGIN = 1e-4           # stage sums this close to a threshold may flip
ATOL, RTOL = 2e-4, 1e-5  # final-stage confidence, kernel vs plain
# K2 against its plain version. float32: 1e-4 + 1e-4 * max|plain| (both sum
# exact f32 products in another order; ccv_tpu's own gates are 2e-2 forward
# and 5e-3 backward). bfloat16: 2e-2 * max|plain|: p and ds are rounded to
# bf16 before their products on both sides, but relative to the running
# max in the kernel and the final max in the plain version (2^-8 each).
K2_F32 = 1e-4
K2_BF16 = 2e-2
# and beside it, for every (BH, T, D) output (o, dq, dk, dv) in either type:
# ||kernel - plain||_F <= 1e-2 ||plain||_F over each 64-row tile of each
# head. The max-magnitude gate is loose where a row's values are small (o
# and dv of late rows at T 1024); this one holds every tile to its own size,
# so a skipped or misplaced key or query tile fails it, while bf16 rounding
# (8-bit mantissas) moves a tile by a few parts in a thousand
K2_TILE_REL = 1e-2
# K2 shapes (BH, Tq, Tk, D, causal): the parity tests' (B 2 x H 3 at D 64,
# B 2 x H 2 at D 32 and 64), ragged D 32 ones, then the LM's (B 8 x H 16, T
# 1024, D 64, causal); the D 32 ones run in float16 too
K2_SHAPES = ([(6, t, t, 64, c) for t in (128, 100, 257) for c in (False, True)]
             + [(4, 72, 136, d, c) for d in (32, 64) for c in (False, True)]
             + [(4, 64, 64, 32, True), (4, 100, 100, 32, True),
                (2, 257, 257, 32, False)])
K2_LM = (128, 1024, 1024, 64, True)
# 16-bit D 32 (wgmma-tma: one warpgroup a block on 64-row tiles in each
# kernel, K2a through a 3-stage ring): checked and timed at B 16 x 16 heads
# of 32, T 1024, causal, beside SDPA's flash calls and the D 64 kernels on
# the same tensors zero-padded to 64; and Model.fit of phase 31's graph
# model with ScaledDotProductAttention(16, 32) (B, T, d_model, heads, head
# dim), the D 32 kernels' main path
K2_D32 = (256, 1024, 1024, 32, True)
SDPA_D32 = (4, 1024, 512, 16, 32)
# the exponentials' floor of a K2 kernel: one exp2 a counted pair, at the
# SFU's 16 a clock on each SM (the roofline leaves it out)
SFU_EXP2_PER_CLOCK = 16
# the 2-layer LM step with the kernels against plain attention (bf16):
# loss within 1e-3 relative; each gradient within 1e-1 of its largest
# magnitude (the plain path's backward runs through bf16 einsums, so it
# rounds the probabilities' and dP's gradients to bf16 where the kernels
# keep f32, and at initialisation the attention weights' gradients are
# small sums of such terms); after one Adam step (rate 1e-4: each
# parameter moves by rate * g / (|g| + eps), within [-rate, rate]) every
# parameter within 2 * rate, and at least 98% of them equal to 1e-6 (the
# same sign of update; gradients near 0 may take either sign)
LM_LOSS_REL, LM_GRAD_REL, LM_SAME_SIGN = 1e-3, 1e-1, 0.98
# the wmt step at 6 + 6 layers in bf16: the kernel step's gradients against
# a float32 step, at most this many times the bf16 plain step's worst
# distance from it (or LM_GRAD_REL); see wmt_gate
BF16_GRAD_RATIO = 1.5
LM_STEPS = 4  # timed steps of the full-depth run, after one warm-up
# phase 13, the image-classification path, card against the CPU on the same
# weights and inputs: float32 logits within CLS_F32 of their largest
# magnitude (TF32 off on both; the same sums in another order), bf16 within
# CLS_BF16 (the parity tests' fraction: every layer rounds to bf16, and
# cuDNN and the CPU may round a sum either way); the legacy convnet's
# confidences within CLS_CONF, its top-5 ids equal
CLS_F32, CLS_BF16, CLS_CONF = 1e-4, 3e-2, 1e-5
# phases 14-18, the encoder-decoder at wmt.c's widths (Transformer-base: 6 +
# 6 layers, d 512 = 8 heads of 64, ff 2048, max_len 128) with a usual WMT
# BPE vocabulary on each side, and the encoder classifier at bin/imdb.py's
# defaults. Synthetic tokens from seeded generators
# (wmt_grad_trial.synthetic_batch: 8-120 pads a row)
S2S = dict(vocab_size=32768, tgt_vocab_size=32768, layers=6, heads=8,
           head_dim=64, ff=2048, max_len=128)
DECODE_B = 32             # iwslt.py decodes at most 32 lines of a test file
WMT_B, WMT_STEPS = 16, 8  # the wmt step: batch, timed steps after a warm-up
IMDB_ARGS = ["--demo", "--epochs", "3"]  # 8 batches of 32 an epoch: 24 steps
# card against CPU at 2 layers of the full widths: (B, Ts, Tt)
S2S_CPU = (2, 40, 33)
# greedy decoding, teacher-forced through plain attention: the token the
# kernel path chose has a plain logit within DECODE_TOL of the row's
# largest logit, as a fraction of that row's largest magnitude (the bf16
# tolerance of the card-against-CPU gates)
DECODE_TOL = 3e-2
# K2 at this slice's shapes (BH, Tq, Tk, D, causal): the decode's decoder
# self-attention (B 32 x H 8, T 128), the wmt step's (B 16 x H 8); and the
# demos' head dim 16 (dim 128 over 8 heads), zero-padded to 32, as (B, T,
# H, D, causal) through flash_attention
K2_DECODE = (256, 128, 128, 64, True)
K2_WMT = (128, 128, 128, 64, True)
K2_PADDED = [(2, t, 8, 16, c) for t in (16, 128) for c in (False, True)]
# phase 29, the graph model's path: ResNet50-v1d + FPN + RPN at COCO's
# inference scale (short side 800, the long side 1333 padded to a multiple
# of 32: every FPN merge an exact 2x), seeded weights and batch-norm
# statistics. Card against CPU in float32: each level's and RPN map's
# largest difference within RESNET_F32 of its largest magnitude (53
# convolutions deep; cuDNN's and oneDNN's float32 sums in other orders,
# TF32 off). bf16 at B 2 against float32 on the card: within RESNET_BF16,
# the bf16 gate of the other card-vs-CPU checks (every layer rounds to
# bf16). It catches gross faults only: the control printed beside it, batch
# norm in bf16 instead of float32, lies about as far from float32 (0.0140
# against 0.0131 at the largest, NVIDIA H100 80GB HBM3, 700 W)
RESNET_HW = (800, 1344)
RESNET_B = 2
RESNET_F32, RESNET_BF16 = 1e-3, 3e-2
RESNET_REPS = 10
# phase 30, the rest of the slice on the card against the CPU: float32
# within NN_F32 of the largest magnitude (the same arithmetic in another
# order), bf16 attention within CLS_BF16; integer results and the LSSC
# codes equal; the MoE forward (8 experts, top 2, dim 1024, ff 4096, 4096
# tokens) with at least MOE_AGREE of its tokens within NN_F32 (a token
# whose two best experts' probabilities lie within float32 noise of a tie
# may route otherwise on the card), the rest counted
NN_F32 = 1e-4
MOE_AGREE = 0.999
SDPA_SHAPE = (4, 1024, 1024, 16, 64)  # B, T, d_model, heads, head dim
RNN_SHAPE = (32, 64, 256)             # B, T, width
FMAP_SHAPE = (2, 100, 168, 256)       # the FPN's P3 at 800 x 1344, B 2
NMS_BOXES, ROIS = 2000, 64
MOE = dict(dim=1024, ff=4096, experts=8, top_k=2)
MOE_TOKENS = 4096
LSSC_SHAPE = (2, 200, 336, 64)
# phase 31, training. Path B: phase 30's attention graph model (SDPA_SHAPE)
# trained through Model.fit under compile(adamw, "mse"), its attention on
# K2a forward and K2b + K2c backward (one launch each a step). Gates, from
# the same carried weights and batch, the kernels against the plain route
# (``layers.attention_route`` patched within the check, a control only): in
# float32 ("tc-f32") the loss within
# TRAIN_LOSS_REL and every gradient
# within TRAIN_GRAD_REL of its largest magnitude. Every fit's update is held
# to AdamW's first step (``optimizers.adamw_step``, the command form) of that
# fit's own gradients from the parameters before it, within TRAIN_PARAM_REL
# of each tensor's largest magnitude; at TRAIN_RATE every tensor moves by
# more than that, so an update skipped or of the wrong sign fails. In bf16
# K2's backward and the plain one each round differently, so the bf16
# kernel fit's gradients are held to the float32 plain fit's: no farther
# than BF16_GRAD_RATIO times the bf16 plain fit's worst distance, or
# K2_BF16, the larger (wmt_gate's rule for the wmt step)
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_PARAM_REL = 1e-5, 1e-4, 1e-4
TRAIN_RATE = 1e-3
TRAIN_STEPS = 5      # timed fit steps after a warm-up
# path A: the coco trainer (ResNet50-v1d-FPN + RPN at its published widths,
# TF32 off). Card against the CPU at COCO_CPU (B 1 x 256 x 256) from the
# same weights and batch, in float64 and in float32: the loss within
# COCO_LOSS_REL and every batch-norm running statistic within COCO_BN_REL of
# its tensor's largest magnitude, in each; every gradient, leaf by leaf,
# within COCO_GRAD_REL of its largest magnitude in float64 (the norms,
# pools and upsample keep float64: ``ops._wide``). At initialisation
# float32's gradients lie several percent of a leaf's largest magnitude
# from float64's on the CPU itself (printed: the CPU's worst, and how many
# leaves lie beyond COCO_GRAD_REL); so float64 holds the card's step to
# the CPU's, and float32's distances from float64 are printed leaf by
# leaf, card beside CPU. Timed at COCO's training scale, B 2 x 800 x 1344 in float32,
# COCO_SELECT anchors an image; the demo as tests/test_bin_coco.py runs
# bin/coco.py, its loss under DEMO_LOSS at the end. The demo runs twice
# under torch's deterministic algorithms and the two runs' losses must be
# equal to the bit: with cuDNN's default algorithms and atomics the 20
# steps differ from run to run (on an H100, 16 runs ended 0.911-1.176 and
# one 1.258; deterministic, 1.1414 each time; the port on the CPU 0.9749)
COCO_CPU = (1, 256, 256)
COCO_LOSS_REL, COCO_GRAD_REL, COCO_BN_REL = 1e-4, 1e-3, 1e-5
COCO_B, COCO_HW, COCO_SELECT, COCO_STEPS = 2, (800, 1344), 256, 5
DEMO_ARGS = ["--demo", "--steps", "20", "--size", "96", "--batch", "2"]
DEMO_LOSS = 1.25

# phase 32, parallelism on torch.distributed (ccv_tpu_torch/parallel), each
# group of ranks spawned in child processes (the main process and phases
# 1-31 untouched; a failed rank fails the run). (a) One NCCL rank, a mesh
# of 1 on every axis: the wmt step at phases 14-18's widths (bf16, B 16 x
# 128, source mask, dropout 0) through --data-parallel 1's path (the world
# group, which splits nothing: ``parallel.data`` drops a group of one rank,
# so no allreduce is launched and world 1 pays nothing) against the
# un-parallel step from the same seed: parameters and Adam's moments equal
# to the bit, or no farther apart than a second un-parallel step (the
# control) lies; the loss likewise and within PAR_LOSS_CAP of the
# un-parallel loss whatever the control shows; K2a / K2b / K2c launched
# 6 / 6 / 6 as in the un-parallel step, and by name in a profiled window
# beside NCCL's kernels; the CLI (``wmt --data-parallel 1 --dist-backend nccl`` on a
# generated corpus at the same widths, dropout 0.1) against the CLI without
# it, to the bit. (b) Two gloo ranks on the one card (NCCL takes one rank a
# device), float32: a probe pair first tries each collective the checks use
# on CUDA tensors (PAR_COLLECTIVES). A wrong answer fails the run, and so
# does a refusal of one of PAR_REQUIRED: gloo takes allreduce and all_gather
# on CUDA tensors, and ``ppermute`` stages its send / recv through pinned
# host memory on a gloo group (gloo itself refuses CUDA tensors there:
# "writev ... Bad address", or the rank aborts). Then every check runs:
# --data-parallel
# 2 against the one-rank step at 2 + 2 layers of the same widths, B 16,
# dropout 0.1 (the global batch's masks); the LM at lm_bench's widths
# (PAR_LM) under tp 2 against tp 1; ring attention at sp 2 and gpipe over
# 2 stages against their one-rank versions. float32 splits a sum in two
# and adds the halves: losses within PAR_LOSS_REL, gradients and outputs
# within PAR_GRAD_REL of the largest. The LM at lm_bench's widths is not so
# tame: at initialisation the float32 one-rank step's gradients lie 3.1e-3
# and 4.6e-3 of the largest from the float64 step's (f32_tp1_from_f64 on
# ranks 1 and 0, an H100 80GB HBM3 at 700 W), and any other order of the
# same float32 sums lies as far, so tp 2 is held to tp 1 in float64
# (PAR_F64_REL; 6.1e-10 and 1.2e-9 on that card: the float64 order
# amplified as float32's is, and far below float32's 6e-8 rounding, so no
# float32 step is on the path), and in float32 by its distance from
# float64 against the float32 tp 1 step's (PAR_F32_RATIO; 0.53 and 1.0
# there). ``chip_smoke.py --nccl-cards N`` runs (b)'s checks
# alone over N NCCL ranks, a rank a card, ring attention and GPipe too
PAR_TIMED = 4          # alternated timed steps, parallel and un-parallel
PAR_TIMEOUT = 420      # seconds for a group of ranks, start-up included
PAR_LOSS_REL, PAR_GRAD_REL = 1e-5, 1e-4
PAR_LOSS_CAP = 1e-3    # (a): |loss difference| / loss, whatever the control
PAR_F64_REL, PAR_F32_RATIO = 1e-8, 2.0
PAR_LM = dict(vocab_size=32768, layers=2, heads=16, head_dim=64, ff=4096,
              max_len=1024)
PAR_LM_BT = (8, 1024)
PAR_COLLECTIVES = ("allreduce", "all_gather", "send/recv")
PAR_REQUIRED = PAR_COLLECTIVES  # gloo must take these (send / recv staged)
PAR_REPS = 5           # timed ring-attention and GPipe steps a rank
# phase 33, K2 at head dim 128: the kernels (bf16 "wgmma-tma" as an
# m64n128 design; f32 "tc-f32") against their
# plain versions within phase 6's gates at the parity shapes and the LM
# step's (B 4 x H 16, T 1024, D 128), and head dim 96 zero-padded to 128
# inside ``flash_attention`` as (B, T, H, D, causal); then K2 timed at
# K2_D128 in turns with the library calls, as phase 6 times the LM shape
K2_D128_SHAPES = ([(6, t, t, 128, c) for t in (128, 100, 257)
                   for c in (False, True)]
                  + [(4, 72, 136, 128, c) for c in (False, True)])
K2_D128 = (64, 1024, 1024, 128, True)
# float32 K2's designs at D 64 and 128 (phases 6 and 33): all three on
# tc-f32; k2_compare holds every launch to ``_design``
F32_DESIGNS = {"fwd": "tc-f32", "dq": "tc-f32", "dkv": "tc-f32"}
K2_D96 = [(2, t, 4, 96, c) for t in (100, 1024) for c in (False, True)]
# phase 34, the LM at head dim 128: d 2048 = 16 heads of 128 (the size of
# GPT-3 XL's width), ff 8192, 2 layers, B 4 x T 1024, bf16, remat dots: the
# step through K2 at D 128 (launches by design), and its forward's logits
# on the card against the CPU port's float32 forward from the same
# parameters within LM_D128_REL of the largest logit (CLS_BF16's gate)
LM_D128 = dict(vocab=32768, layers=2, dim=2048, heads=16, ff=8192, batch=4,
               seq=1024)
LM_D128_REL = 3e-2
# and a seq2seq model at d 1024 = 8 heads of 128 (Transformer-big's width
# and ff with heads of 128), 2 + 2 layers, bf16: the forward's logits at
# S2S_CPU unmasked (K2a on the encoder's and the decoder's self-attention)
# on the card against the CPU port's float32 forward within LM_D128_REL of
# the largest; then the wmt step (B WMT_B x 128, source mask, dropout 0)
# through K2 at D 128, launches by design
S2S_D128 = dict(S2S, layers=2, heads=8, head_dim=128, ff=4096)
# phase 43, K2 at head dims above 128 and in float16. The wgmma-tma kernels
# at D 256 in bf16 and float16 against their plain versions within phase
# 6's gates at K2_D256_SHAPES and at K2_D256 (B 4 x 8 heads, T 1024: the
# attention of Gemma-2B's width); the tc-f32 and tc-wide kernels at
# K2_WIDE_SHAPES (float32 D 64, 128, 256, 320, 512, 576 and 640, the last
# with K2b in two slices of dq and K2c in three of dk and dv; bf16 D 320
# and 512, float16 D 320 at a ragged T and D 512, and bf16 D 896, where
# K2b's q and do and K2c's k and v stream; bf16 D 320 also at SDPA_D320's
# attention, BH 32 x T 1024, the shape its fit gives the kernels) and
# flash_attention at head dims padded inside
# (K2_WIDE_PADDED), every launch checked for its design; K2 timed at
# K2_D256 in bf16 and float16 in turns with SDPA's flash calls, and in
# float32 (D 256, and D 64 and 128 at the same operations, all on tc-f32;
# D 576: K2a tc-wide, K2b and K2c tc-f32) and at bf16 D 320 and 512
# (tc-wide) (K2_WIDE_TIMED) beside the memory-efficient calls
K2_D256_SHAPES = [(6, 100, 100, 256, True), (4, 72, 136, 256, False),
                  (2, 257, 257, 256, True)]
K2_D256 = (32, 1024, 1024, 256, True)
K2_WIDE_SHAPES = [(torch.float32, (3, 100, 100, 64, True)),
                  (torch.float32, (2, 257, 257, 128, True)),
                  (torch.float32, (3, 100, 100, 256, True)),
                  (torch.float32, (2, 72, 136, 256, False)),
                  (torch.float32, (2, 130, 130, 320, True)),
                  (torch.float32, (2, 72, 136, 512, True)),
                  (torch.float32, (1, 100, 100, 576, True)),
                  (torch.float32, (1, 130, 130, 640, True)),
                  (torch.bfloat16, (3, 100, 100, 320, True)),
                  (torch.bfloat16, (2, 72, 136, 320, False)),
                  (torch.float16, (2, 130, 130, 320, True)),
                  (torch.bfloat16, (3, 100, 100, 512, True)),
                  (torch.float16, (2, 257, 257, 512, False)),
                  (torch.bfloat16, (2, 72, 136, 896, False)),
                  (torch.bfloat16, (32, 1024, 1024, 320, True))]
K2_WIDE_PADDED = [(torch.bfloat16, (2, 100, 4, 160, True)),
                  (torch.float16, (2, 100, 4, 200, False)),
                  (torch.float32, (2, 72, 2, 300, True))]
K2_WIDE_TIMED = [(torch.float32, K2_D256), (torch.bfloat16,
                                            (32, 1024, 1024, 512, True)),
                 (torch.float32, (128, 1024, 1024, 64, True)),
                 (torch.float32, K2_D128),
                 (torch.bfloat16, (32, 1024, 1024, 320, True)),
                 (torch.float32, (32, 1024, 1024, 576, True))]
# the LM at Gemma-2B's widths: d 2048 = 8 heads of 256, ff 16384, vocab
# 256,000, 2 of its 18 layers (depth cut to the script's time), B 4 x T
# 1024. One step from the same parameters and batch with the kernels and
# with plain attention (wmt_gate's two gates: in float32, every
# gradient within LM_GRAD_REL of the plain step's
# largest magnitude; in bf16, the kernel step's gradients no farther from
# the float32 plain step than BF16_GRAD_RATIO times the bf16 plain step's
# worst distance, or LM_GRAD_REL; the loss within LM_LOSS_REL in both);
# then lm_bench.measure (remat dots) in float32 and in bf16, a warm-up and
# LM_D256_STEPS each, K2's launches by design
LM_D256 = dict(vocab=256000, layers=2, dim=2048, heads=8, ff=16384, batch=4,
               seq=1024)
LM_D256_STEPS = 3
# greedy decoding (phase 16's check) of a seq2seq model at d 1024 = 4
# heads of 256 (Transformer-big's width and ff with heads of 256), 2 + 2
# layers, bf16; and Model.fit of phase 31's graph model with
# ScaledDotProductAttention(8, 256) at B 4 x T 1024 (SDPA_D256), float32
# (tc-f32) and bf16 (wgmma-tma)
# against the plain route by phase 31's gates, and with heads of 320 in
# bf16 (SDPA_D320: tc-wide for all three) by phase 31's bf16 gate against
# the float32 plain fit at that width. No published model in the
# repository's sources has heads of 320: it is the narrowest head dim above
# 256 that pads to itself, chosen so that a user-facing path runs the
# 16-bit kernels above 256
S2S_D256 = dict(S2S, layers=2, heads=4, head_dim=256, ff=4096)
SDPA_D256 = (4, 1024, 2048, 8, 256)
SDPA_D320 = (4, 1024, 2560, 8, 320)
# phase 35, SCD training (ccv_tpu_torch/train/scd.py) at the published 40 x
# 40 patch and all 1,631 stump features; depth cut: 2 stages of at most 6
# features, 200 Adam steps a round. Seeded patches (``train_patches``):
# positives from the repository's face crops (crop180.png, crop120.png:
# jittered, flipped, relit), negatives from text_test.png, from parts of
# the same faces and from the faces upside down.
# Parity at SCD_TRAIN_N (the CPU port takes seconds there): the card and
# the CPU port from the same draws (``uniform_init``), in float32: the same
# features and stage sizes, thresholds within SCD_THRESHOLD_TOL. Timed on
# the card at SCD_TRAIN_FULL_N, 4,000 examples: a (F, N, 32) table of 0.84
# GB, of the order of the face sets scdcreate trains on (FDDB holds 5,171
# faces); depth alone is cut. That cascade is written,
# loaded and run by ``detect`` (K1, counted) on the 1080p RGB frame against
# the plain route, windows within phase 5's margin
SCD_TRAIN = dict(size=(40, 40), boosting=2, maximum_feature=6,
                 prune_feature=6, train_steps=200, seed=0)
SCD_TRAIN_N = (120, 240)   # positives, negatives
SCD_TRAIN_FULL_N = (1333, 2667)
SCD_THRESHOLD_TOL = 1e-4
# phase 36, ICF training (ccv_tpu_torch/train/icf.py) at the published 30
# x 60 patch and 2,000 random features; depth cut to ICF_WEAK trees. At
# ICF_TRAIN_N the card's cascade equals the CPU port's: features and splits
# equal, votes and thresholds within 1e-5. Timed on the card at
# ICF_TRAIN_FULL_N, SCD's 4,000 examples
ICF_TRAIN = dict(size=(30, 60), feature_size=2000, weak_classifier=8,
                 seed=0)
ICF_TRAIN_N = (150, 300)
ICF_TRAIN_FULL_N = SCD_TRAIN_FULL_N
# phase 37, BBF training (ccv_tpu_torch/train/bbf.py) at the published 24 x
# 24 on gray ``train_patches``. Parity at BBF_TRAIN_N with
# tests/test_train_bbf.py's small setting: the card's cascade equals the CPU
# port's to the bit (the draws, the errors and the thresholds are host
# numpy; the card computes the pyramids and the responses, integers). Then
# bbfcreate's defaults (8 stages of at most 32 features, population 256, 4
# generations) on the card at BBF_TRAIN_FULL_N; its cascade's 1080p
# ``detect_objects`` on the card against the CPU port's
BBF_TRAIN = dict(population=128, generations=3, max_features_per_stage=8,
                 n_stages=3, seed=2)
BBF_TRAIN_N = (120, 300)
BBF_TRAIN_FULL_N = (1000, 3000)
BBF_TRAIN_FULL = dict(n_stages=8, max_features_per_stage=32)
BBF_TRAIN_CROP = (136, 240)   # the card-against-CPU crop of the 1080p frame
# phase 38, the SWT parameter search (ccv_tpu_torch/train/swt.py) over
# text_test.png and the 1080p tiled frame with their annotated lines, two
# ranges, two iterations, from a min_height that finds nothing: the card
# and the CPU port pick the same parameters
SWT_SEARCH = dict(min_height=(8, 26, 34), low_thresh=(100, 24, 124))
SWT_SEARCH_START = dict(min_height=60)
# phase 39, DPM training (ccv_tpu_torch/train/dpm.py). Parity at
# tests/test_train_dpm.py's configuration (DPM_TRAIN_TEST, six 160 x 160
# scenes and five backgrounds): the card's model within DPM_TRAIN_TOL of
# the CPU port's largest weight. Then bin/dpmcreate's published setting (1
# component, 8 parts, symmetric, C 0.002, a negative cache of 2,000, root
# area 3000-5000) on DPM_TRAIN_SCENES 640 x 480 positive and background
# scenes, depth cut to DPM_TRAIN_DEPTH (published: relabels 10, data
# minings 50, iterations 1000); the trained model's 1080p ``detect``
DPM_TRAIN_TEST = dict(components=1, parts=4, min_area=1200, max_area=2500,
                      symmetric=True, relabels=1, data_minings=1,
                      iterations=6, negative_cache_size=20,
                      include_overlap=0.6, seed=3)
DPM_TRAIN_TOL = 1e-3
DPM_TRAIN_SCENES = 24
DPM_TRAIN_NEGNUM = 200
DPM_TRAIN_DEPTH = dict(relabels=1, data_minings=2, iterations=10)
DPM_PROFILED = 4
PAR_NEEDS = {"data_parallel": ("allreduce",),
             "lm_tp": ("allreduce", "all_gather"),
             "ring_sp": ("send/recv",),
             "gpipe": ("send/recv", "allreduce")}



PHASE_S = {}     # seconds from the previous log line, by the phase logging
_LAST_LOG = []


def log(phase, msg):
    now = time.perf_counter()
    if _LAST_LOG:
        PHASE_S[phase] = PHASE_S.get(phase, 0.0) + now - _LAST_LOG[0]
    _LAST_LOG[:] = [now]
    print(f"[{phase}] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def frame_1080p(read):
    """A 1920x1080 gray frame: text_test.png (640x480) tiled 3x3, cropped."""
    tt = read(os.path.join(DATA, "text_test.png"), device="cpu").numpy()
    return np.ascontiguousarray(np.tile(tt, (3, 3))[:1080, :1920])


def synth_cascade(scd, rng, feats_per_stage=(2, 3, 4, 5), wh=16,
                  layouts=False):
    """A random cascade for the kernel checks; with ``layouts``, every
    feature has one of the box layouts of SCD's feature generator (4 boxes
    in a column, in a row or in a 2 x 2 grid, in the generator's box
    order), the kernels' distinct-corner paths."""
    F = sum(feats_per_stage)
    sx = rng.integers(0, wh - 4, (F, 4))
    sy = rng.integers(0, wh - 4, (F, 4))
    dx, dy = sx + rng.integers(2, 5, (F, 4)), sy + rng.integers(2, 5, (F, 4))
    for f in range(F if layouts else 0):
        q, a, b = (int(v) for v in rng.integers(1, 4, 3))
        x, y = (int(v) for v in rng.integers(0, wh - 12, 2))
        if f % 3 == 0:    # 1x4: a column of boxes q high, a + 1 wide
            boxes = [(x, y + i * q, x + a + 1, y + (i + 1) * q)
                     for i in range(4)]
        elif f % 3 == 1:  # 4x1: a row of boxes q wide, a + 1 high
            boxes = [(x + i * q, y, x + (i + 1) * q, y + a + 1)
                     for i in range(4)]
        else:             # 2x2 of a x b boxes
            boxes = [(x, y, x + a, y + b), (x, y + b, x + a, y + 2 * b),
                     (x + a, y, x + 2 * a, y + b),
                     (x + a, y + b, x + 2 * a, y + 2 * b)]
        sx[f], sy[f], dx[f], dy[f] = (np.array(v) for v in zip(*boxes))
    return scd.cascade_from_numpy(dict(
        width=wh, height=wh, margin=(0, 0, 0, 0),
        stage_counts=feats_per_stage,
        thresholds=np.zeros(len(feats_per_stage)),
        sx=sx, sy=sy, dx=dx, dy=dy,
        bias=rng.normal(0, 0.5, F), w=rng.normal(0, 1, (F, 32)),
        stage_of=np.repeat(np.arange(len(feats_per_stage)), feats_per_stage)))


def with_median_thresholds(scd, k1, cascade, sat_l, dims):
    """The cascade with every stage threshold near the median of the plain
    version's stage sums over the real windows, so stages kill real windows
    and the early exit runs. Flat image regions give many windows the same
    sum, so the threshold goes in a gap between distinct sums at least
    4 * MARGIN wide (none of them lies near it), the one whose pass share is
    closest to one half; failing that, in the widest gap."""
    vs = k1.cascade_stage_sums_ref(sat_l, scd.cascade_tables(cascade), STEP,
                                   dims)
    th = []
    for s in range(cascade.n_stages):
        vals = torch.cat([vs[li, s, :ny, :nx].reshape(-1)
                          for li, (ny, nx) in enumerate(dims)]).sort().values
        u = torch.unique(vals)
        mids, gaps = (u[1:] + u[:-1]) / 2, u[1:] - u[:-1]
        frac = 1 - torch.searchsorted(vals, mids, right=True) / vals.numel()
        wide = gaps > 4 * MARGIN
        i = (int(torch.where(wide, (frac - 0.5).abs(), 2.0).argmin())
             if bool(wide.any()) else int(gaps.argmax()))
        th.append(float(mids[i]))
    return dataclasses.replace(cascade, thresholds=np.asarray(th, np.float32))


def kernel_vs_plain(scd, k1, cascade, sat_l, dims):
    """K1 and its plain version on the same SAT stack. Returns (max |conf
    difference| where both pass, windows passed, windows in the margin)."""
    tables = scd.cascade_tables(cascade)
    vs = k1.cascade_stage_sums_ref(sat_l, tables, STEP, dims)
    conf0, pass0 = k1.cascade_eval_levels_ref(sat_l, tables, STEP, dims)
    conf1, pass1 = k1.cascade_eval_levels(sat_l, tables, STEP, dims)
    torch.cuda.synchronize()
    th = torch.as_tensor(tables.thresholds, device=sat_l.device)
    margin_ok = ((vs - th[None, :, None, None]).abs() > MARGIN).all(dim=1)
    differ = int(((pass0 != pass1) & margin_ok).sum())
    check(differ == 0, f"K1 and plain disagree on {differ} windows outside "
                       f"the {MARGIN} margin")
    both = pass0 & pass1
    check(bool(both.any()), "no window passed: the comparison is vacuous")
    err = (conf0 - conf1)[both].abs()
    bound = ATOL + RTOL * conf0[both].abs()
    check(bool((err <= bound).all()),
          f"conf differs by up to {float(err.max())}")
    return float(err.max()), int(pass0.sum()), int((~margin_ok).sum())


# every profiled window opens with PROFILE_HEAD spin kernels
# (torch.cuda._sleep, named HEAD_KERNEL in the profiler), left out of every
# figure: see profile_head
PROFILE_HEAD = 1000
HEAD_KERNEL = "spin_kernel"
PROFILED_IMAGES = 2  # phase 10's 1080p detects a form (3 before PR 19)


def time_cuda(fn, reps):
    """Mean ms per call on the card: CUDA events around `reps` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, n):
    """(device-busy ms per call, {kernel name: device ms per call}, wall ms
    per call) over the same ``n`` calls of ``fn`` under torch.profiler:
    busy is the sum of the device-side events (the host-side ops carry
    their kernels' time too); wall is the host clock around the calls,
    ending in a synchronize, profiler overhead included."""
    w = device_window(fn, n)
    return w["busy"], w["by_name"], w["wall"]


def device_window(fn, n):
    """``device_ms``'s window as a dict: ``busy``, ``by_name`` and ``wall``
    (ms per call) and besides ``span``, the CUDA events' ms per call from
    before the first call to after the last (the device's own clock over
    the same window), ``counts``, the device events the profiler kept by
    name, and ``events``, their sum. The window opens with
    ``profile_head``, whose kernels no figure counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profile_head()
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000 / n
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and HEAD_KERNEL not in e.key]
    by_name = {e.key: e.self_device_time_total / 1e3 / n for e in events}
    counts = {e.key: e.count for e in events}
    return dict(busy=sum(by_name.values()), by_name=by_name, wall=wall,
                span=start.elapsed_time(end) / n, counts=counts,
                events=sum(counts.values()))


def profile_head():
    """Open a profiled window with PROFILE_HEAD spin kernels (named
    HEAD_KERNEL) and a synchronize. Late in a process torch.profiler loses
    the first device records of each window: two of 1, 2, 8, 24 or 96
    matmuls (``python -m ccv_tpu_torch.bin.profiler_windows``), three of
    phase 29's 705 a batch, all 24 of phase 30's attention window in two
    whole runs of this script. Those lost are then the head's, which no
    figure counts."""
    for _ in range(PROFILE_HEAD):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def k2_inputs(shape, dtype, dev, rng):
    bh, tq, tk, d, _causal = shape
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, t, d),
                                                        np.float32))
                   .to(dev, dtype) for t in (tq, tk, tk, tq))
    return q, k, v, do


def tile_rel_err(got, ref, rows=64):
    """max over heads and `rows`-row tiles of ||got - ref||_F / ||ref||_F,
    for (BH, T, D) tensors (a ragged last tile counts as it is)."""
    bh, t, d = ref.shape
    pad = (-t) % rows
    diff = torch.nn.functional.pad(got.float() - ref.float(), (0, 0, 0, pad))
    ref = torch.nn.functional.pad(ref.float(), (0, 0, 0, pad))
    num = diff.view(bh, -1, rows * d).norm(dim=-1)
    den = ref.view(bh, -1, rows * d).norm(dim=-1)
    return float((num / den.clamp_min(1e-30)).max())


def k2_compare(k2, shape, dtype, dev, rng):
    """K2a/b/c and their plain versions on the same inputs. Returns the max
    abs error of each kernel's outputs (fwd: o and lse; dkv: dk and dv) and
    the largest tile-relative error of each (o; dq; dk and dv).
    Checks that each kernel ran the design ``k2._design`` names."""
    q, k, v, do = k2_inputs(shape, dtype, dev, rng)
    causal, scale = shape[4], 1.0 / np.sqrt(shape[3])
    want = {key: k2._design(key, dtype, shape[3])
            for key in ("fwd", "dq", "dkv")}
    before = {key: dict(c) for key, c in k2.DESIGN_LAUNCHES.items()}
    o0, lse0 = k2.flash_fwd_ref(q, k, v, scale, causal)
    delta = (do.float() * o0.float()).sum(-1)
    dq0 = k2.flash_dq_ref(q, k, v, do, lse0, delta, scale, causal)
    dk0, dv0 = k2.flash_dkv_ref(q, k, v, do, lse0, delta, scale, causal)
    o1, lse1 = k2.flash_fwd(q, k, v, scale, causal)
    dq1 = k2.flash_dq(q, k, v, do, lse0, delta, scale, causal)
    dk1, dv1 = k2.flash_dkv(q, k, v, do, lse0, delta, scale, causal)
    torch.cuda.synchronize()
    ran = {key: {d: n - before[key][d] for d, n in c.items() if n > before[key][d]}
           for key, c in k2.DESIGN_LAUNCHES.items()}
    check(ran == {key: {d: 1} for key, d in want.items()},
          f"K2 at {shape} {dtype} ran the designs {ran}, expected {want}")
    errs, rels = {}, {}
    for key, name, got, ref in (("fwd", "o", o1, o0), ("fwd", "lse", lse1, lse0),
                                ("dq", "dq", dq1, dq0), ("dkv", "dk", dk1, dk0),
                                ("dkv", "dv", dv1, dv0)):
        err = float((got.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        bound = (K2_F32 + K2_F32 * top if ref.dtype == torch.float32
                 else K2_BF16 * top)
        check(bool(torch.isfinite(got).all()) and err <= bound,
              f"K2 {name} at {shape} {dtype}: max error {err:.3g} > "
              f"{bound:.3g} (max |plain| {top:.3g})")
        errs[key] = max(errs.get(key, 0.0), err)
        if name != "lse":
            rel = tile_rel_err(got, ref)
            check(rel <= K2_TILE_REL, f"K2 {name} at {shape} {dtype}: a 64-row "
                  f"tile is off by {rel:.3g} of its norm (> {K2_TILE_REL})")
            rels[key] = max(rels.get(key, 0.0), rel)
    return errs, rels


def f32_designs_checked(k2, d):
    """Checks that ``_design`` sends float32 K2 at head dim ``d`` where
    F32_DESIGNS says, and returns that map."""
    got = {key: k2._design(key, torch.float32, d) for key in F32_DESIGNS}
    check(got == F32_DESIGNS, f"float32 K2 at D {d} routes to {got}, "
                              f"expected {F32_DESIGNS}")
    return got


def k2_vs_plain(k2, roofline, dev, card):
    rng = np.random.default_rng(17)
    f32 = f32_designs_checked(k2, 64)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        worst, worst_rel = {}, {}
        shapes = [s for s in K2_SHAPES
                  if dtype != torch.float16 or s[3] == 32]
        for shape in shapes:
            errs, rels = k2_compare(k2, shape, dtype, dev, rng)
            for key in errs:
                worst[key] = max(worst.get(key, 0.0), errs[key])
                worst_rel[key] = max(worst_rel.get(key, 0.0), rels[key])
        log(6, f"K2 vs plain, {dtype}, {len(shapes)} shapes ("
               + ("" if dtype == torch.float16 else
                  "T 128/100/257 causal and not at D 64; 72x136 causal and "
                  "not at D 64; ")
               + f"at D 32 72x136 causal and not, 64 and 100 causal, 257 "
               f"not): max abs error "
               f"{ {k: f'{e:.3g}' for k, e in worst.items()} }; worst "
               f"64-row tile error / tile norm "
               f"{ {k: f'{e:.3g}' for k, e in worst_rel.items()} }; designs "
               f"checked per shape"
               + (f" (D 64: {f32})" if dtype == torch.float32 else ""))
    errs, rels = k2_compare(k2, K2_LM, torch.bfloat16, dev, rng)
    log(6, f"K2 vs plain at the LM shape {K2_LM} bf16 (K2a, K2b and K2c "
           f"wgmma-tma): max abs error "
           f"{ {k: f'{e:.3g}' for k, e in errs.items()} }; worst 64-row "
           f"tile error / tile norm "
           f"{ {k: f'{e:.3g}' for k, e in rels.items()} }")
    out, lib_err = k2_timed(k2, roofline, K2_LM, dev, rng)
    log(6, "K2 at the LM shape (CUDA events, 2 x 20 launches in turns with "
        "the library call; plain 5): " + k2_timing_note(out, lib_err)
        + f"; {card}")
    return errs, out


def exp_floor_ms(shape):
    """The least ms in which the card's SFUs compute one exp2 for each
    counted pair of a causal (BH, Tq, Tk, D, causal) ``shape``, at
    SFU_EXP2_PER_CLOCK a clock on each SM and the SMs' largest clock
    (nvidia-smi's clocks.max.sm)."""
    bh, t_q, t_k, _d, causal = shape
    from ccv_tpu_torch.ops.kernels import flash_attention as k2
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exps = bh * k2.causal_pairs(t_q, t_k, causal)
    return exps / (SFU_EXP2_PER_CLOCK * sms * mhz * 1e6) * 1e3


def k2_padded_ms(k2, shape, dtype, dev, rng, reps=20):
    """{kernel: ms} of K2a, K2b and K2c on a causal ``shape``'s q, k, v and
    do zero-padded along D to 64 by the caller, with D's scale: the D 64
    kernels doing D's work (CUDA events, ``reps`` calls each; the pad
    copies are not in the times)."""
    q, k, v, do = (torch.nn.functional.pad(x, (0, 64 - shape[3]))
                   for x in k2_inputs(shape, dtype, dev, rng))
    scale, causal = 1.0 / np.sqrt(shape[3]), shape[4]
    o, lse = k2.flash_fwd(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale, causal)
    return {"fwd": time_cuda(lambda: k2.flash_fwd(q, k, v, scale, causal),
                             reps),
            "dq": time_cuda(lambda: k2.flash_dq(*bwd), reps),
            "dkv": time_cuda(lambda: k2.flash_dkv(*bwd), reps)}


def k2_d32_path(k2, roofline, dev, card):
    """Phase 6, 16-bit D 32 at K2_D32: K2a, K2b and K2c against their plain
    versions in bf16 and float16 (the wgmma-tma design checked), timed in
    turns with SDPA's flash calls (``k2_timed``), and the D 64 kernels on
    the same tensors zero-padded to 64 (``k2_padded_ms``). Returns {"bfloat16",
    "float16": {"err": {kernel: max abs error}, "timed": {kernel: timing},
    "pad64_ms": {kernel: ms}}, "exp_floor_ms": ms}."""
    rng = np.random.default_rng(32)
    out = {"exp_floor_ms": exp_floor_ms(K2_D32)}
    for dtype in (torch.bfloat16, torch.float16):
        errs, rels = k2_compare(k2, K2_D32, dtype, dev, rng)
        timed, lib_err = k2_timed(k2, roofline, K2_D32, dev, rng, dtype=dtype)
        pad = k2_padded_ms(k2, K2_D32, dtype, dev, rng)
        name = str(dtype).split(".")[1]
        out[name] = dict(err=errs, timed=timed, pad64_ms=pad)
        log(6, f"K2 at {K2_D32} {name} (wgmma-tma at D 32) vs plain: max "
               f"abs error { {k: f'{e:.3g}' for k, e in errs.items()} }; "
               f"worst 64-row tile error / tile norm "
               f"{ {k: f'{e:.3g}' for k, e in rels.items()} }; timed (CUDA "
               f"events, 2 x 20 launches in turns with the library call; "
               f"plain 5): " + k2_timing_note(timed, lib_err)
               + f"; the exp2 floor {out['exp_floor_ms']:.4f} ms a kernel; "
               f"the D 64 kernels on the same tensors zero-padded to 64 "
               f"{ {k: round(v, 4) for k, v in pad.items()} } ms; {card}")
    return out


def k2_timing_note(out, lib_err, backend="flash"):
    return "; ".join(
        f"{key} {r['ms']:.4f} ms = {r['tflops']:.1f} TFLOP/s, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
        f"{r['bound_ms'] / r['ms']:.3f} of it; library "
        f"{r['library_ms']:.4f} ms; plain {r['plain_ms']:.3f} ms"
        for key, r in out.items()) + (
        f"; library = SDPA {backend} forward, and for dq and dkv the "
        f"{backend} backward op (dq, dk and dv in one call); library vs "
        f"plain max error / max|plain| (o, dq, dk, dv) "
        f"{[f'{e:.3g}' for e in lib_err]}")


def k2_timed(k2, roofline, shape, dev, rng, dtype=torch.bfloat16,
             backend="flash", reps=20):
    """K2a, K2b and K2c at a causal ``shape`` in ``dtype`` (BH = B x 16
    heads), each timed in turns with the library call that computes the
    same function (kernel, library, library, kernel; ``reps`` calls each)
    and its plain version (5 calls), with the bound for these inputs."""
    q, k, v, do = k2_inputs(shape, dtype, dev, rng)
    scale = 1.0 / np.sqrt(shape[3])
    o, lse = k2.flash_fwd(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale, True)
    from ccv_tpu_torch.bin.k2_trial import library_calls
    lib_fwd, lib_bwd = library_calls(q, k, v, do, scale, b=shape[0] // 16,
                                     backend=backend)
    # the library against the plain versions, logged (a yardstick, no gate)
    o_ref = k2.flash_fwd_ref(q, k, v, scale, True)[0]
    g_ref = k2.flash_bwd_ref(*bwd)
    lib_err = [float((a.reshape(b.shape).float() - b.float()).abs().max()
                     / b.float().abs().max())
               for a, b in zip((lib_fwd(), *lib_bwd()), (o_ref, *g_ref))]
    out = {}
    for key, kern, plain, lib in (
            ("fwd", lambda: k2.flash_fwd(q, k, v, scale, True),
             lambda: k2.flash_fwd_ref(q, k, v, scale, True), lib_fwd),
            ("dq", lambda: k2.flash_dq(*bwd), lambda: k2.flash_dq_ref(*bwd),
             lib_bwd),
            ("dkv", lambda: k2.flash_dkv(*bwd),
             lambda: k2.flash_dkv_ref(*bwd), lib_bwd)):
        # in turns: kernel, library, library, kernel (reps calls each)
        ms = [time_cuda(kern, reps), time_cuda(lib, reps),
              time_cuda(lib, reps), time_cuda(kern, reps)]
        flop, nbytes = k2.flash_work(key, *shape, dtype)
        kind = k2.roofline_kind(key, dtype, shape[3])
        bound, by = roofline.bound_ms(flop, nbytes, kind)
        out[key] = dict(ms=(ms[0] + ms[3]) / 2, library_ms=(ms[1] + ms[2]) / 2,
                        plain_ms=time_cuda(plain, 5), bound_ms=bound,
                        bound_by=by, kind=kind,
                        tflops=flop / ((ms[0] + ms[3]) / 2) / 1e9)
    return out, lib_err


def lm_two_layers(k2, dev):
    """One step at the LM's widths, 2 layers, from the same parameters and
    batch: with the kernels, and with plain attention."""
    from ccv_tpu_torch.bin import lm_bench
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.nn import optimizers

    cfg = tfm.TransformerConfig(vocab_size=32768, layers=2, heads=16,
                                head_dim=64, ff=4096, max_len=1024,
                                dropout=0.0, dtype=torch.bfloat16, remat=True,
                                remat_policy="dots")
    ids = torch.randint(0, cfg.vocab_size, (8, 1025), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    runs = []
    for plain in (False, True):
        params = tfm.init_lm(torch.Generator(device=dev).manual_seed(2), cfg)
        opt = optimizers.adam(rate=1e-4)
        state = opt.init(params)
        before = dict(k2.LAUNCHES)
        with lm_bench.plain_attention(plain):
            loss = float(lm_bench.train_step(params, opt, state, cfg, ids))
        used = {k: v - before[k] for k, v in k2.LAUNCHES.items()}
        check(used == ({"fwd": 0, "dq": 0, "dkv": 0} if plain else
                       {"fwd": 4, "dq": 2, "dkv": 2}),
              f"2-layer step (plain={plain}) launched K2 {used}")
        runs.append((loss, named_leaves(params)))
    (loss_k, p_k), (loss_p, p_p) = runs
    # the key bias bk is left out of the gradient check: adding q.bk to
    # every score of a row leaves the softmax unchanged, so its true
    # gradient is 0 and both sides give rounding noise
    g_rel = {name: float((p_k[name].grad - p_p[name].grad).abs().max()
                         / p_p[name].grad.abs().max().clamp_min(1e-30))
             for name in p_k if not name.endswith(".bk")}
    worst = max(g_rel, key=g_rel.get)
    diffs = torch.cat([(p_k[n].detach() - p_p[n].detach()).abs().flatten()
                       for n in p_k])
    same = float((diffs <= 1e-6).float().mean())
    log(7, f"2-layer step at the LM widths (B 8, T 1024, bf16, remat dots): "
           f"loss {loss_k:.5f} with the kernels, {loss_p:.5f} plain; "
           f"gradients within {g_rel[worst]:.3g} of their largest magnitude "
           f"(worst {worst}); after Adam {same:.5f} of parameters equal, max "
           f"diff {float(diffs.max()):.3g}")
    check(np.isfinite(loss_k) and abs(loss_k - loss_p) <= LM_LOSS_REL * abs(
        loss_p), f"2-layer loss {loss_k} with the kernels, {loss_p} plain")
    check(g_rel[worst] <= LM_GRAD_REL, f"2-layer gradient {worst} differs by "
                                       f"{g_rel[worst]:.3g} of its largest "
                                       f"magnitude")
    check(float(diffs.max()) <= 2e-4 and same >= LM_SAME_SIGN,
          f"2-layer parameters after Adam: max diff {float(diffs.max()):.3g}, "
          f"{same:.4f} equal")


def named_leaves(tree, prefix=""):
    """{dotted name: tensor} of a nested dict/list of parameters."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), sub) for i, sub in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(named_leaves(sub, f"{prefix}.{key}" if prefix else key))
    return out


def rect_set(comps):
    return {(c.x, c.y, c.width, c.height) for c in comps}


def golden_rects(name):
    out = {}
    with open(os.path.join(DATA, name)) as f:
        for line in f:
            x, y, w, h, conf = line.split()
            out[(int(x), int(y), int(w), int(h))] = float(conf)
    return out


def margin_rects(scd, k1, img, cascade, params, dev):
    """Rects of the windows whose plain stage sums lie within MARGIN of a
    threshold in some stage: the only ones allowed to differ."""
    tables = scd.cascade_tables(cascade)
    th = torch.as_tensor(tables.thresholds, device=dev)
    specs, octaves = scd.octave_sats(img, cascade, params, dev)
    outs = []
    for _lspecs, sat_l, dims in octaves:
        vs = k1.cascade_stage_sums_ref(sat_l, tables, STEP, dims)
        near = ((vs - th[None, :, None, None]).abs() <= MARGIN).any(dim=1)
        outs += [(near[li, :ny, :nx].cpu().numpy(), np.zeros((ny, nx)))
                 for li, (ny, nx) in enumerate(dims)]
    eff_w = cascade.width - cascade.margin[0] - cascade.margin[2]
    eff_h = cascade.height - cascade.margin[1] - cascade.margin[3]
    return rect_set(scd._comps_from_levels(
        outs, specs, scd.up_ratio(cascade, params), eff_w, eff_h, STEP))


def phase_a_vs_plain(k1, k3, tables, sat_l, dims):
    """K3 and its plain version on the same SAT stack, for a phase's tables
    (A or B1). Returns (max |conf difference| over every window, windows
    passed, windows in the margin). K3's conf is the phase's last stage's
    sum for every window, so it is compared everywhere, passed or not."""
    vs = k1.cascade_stage_sums_ref(sat_l, tables, STEP, dims)
    conf0, pass0 = k3.phase_a_ref(sat_l, tables, STEP, dims)
    conf1, pass1 = k3.phase_a(sat_l, tables, STEP, dims)
    torch.cuda.synchronize()
    th = torch.as_tensor(tables.thresholds, device=sat_l.device)
    margin_ok = ((vs - th[None, :, None, None]).abs() > MARGIN).all(dim=1)
    differ = int(((pass0 != pass1) & margin_ok).sum())
    check(differ == 0, f"K3 and plain disagree on {differ} windows outside "
                       f"the {MARGIN} margin")
    check(bool(pass0.any()), "no window passed: the comparison is vacuous")
    err = (conf0 - conf1).abs()
    check(bool((err <= ATOL + RTOL * conf0.abs()).all()),
          f"K3 conf differs by up to {float(err.max())}")
    return float(err.max()), int(pass0.sum()), int((~margin_ok).sum())


def k3_vs_plain(scd, k1, k3, roofline, dev, card, sat0, dims0, face,
                face_med):
    """Phase 8: K3 against its plain version on the phase-A and phase-B1
    tables of synthetic cascades at the dims K1 is checked on (random boxes;
    SCD's three box layouts; a stage 0 of 20 features, which phase A takes
    past its 16; a stage 0 of 1,100, past a 512-feature run of records) and
    of the face cascade at the 1080p level-0 SAT with near-median and open
    thresholds. Then, there, K3 timed alone on the face's A and B1 tables
    (planes, tables and dims already on the card, in turns), the plane copy
    that serves both, and the plain version on both (in turns)."""
    max_err = 0.0
    rng = np.random.default_rng(8)
    for counts, dims, layouts in (
            ((2, 3, 4, 5, 6), [[11, 21]], False),
            ((2, 3, 4, 5, 6), [[8, 128]], False),
            ((2, 3, 4, 5, 6), [[17, 140]], False),
            ((2, 3, 4, 5, 6), [[13, 140], [9, 100], [5, 60]], False),
            ((20, 3, 4), [[17, 140]], False),
            ((4, 4, 4, 30), [[13, 140], [9, 100]], True),
            ((1100, 3, 4), [[9, 37], [6, 20]], False)):
        dims = np.asarray(dims)
        cascade = synth_cascade(scd, rng, counts, 24 if layouts else 16,
                                layouts)
        H1 = (dims[:, 0].max() - 1) * STEP + cascade.height + 1
        W1 = (dims[:, 1].max() - 1) * STEP + cascade.width + 1
        sat_l = torch.from_numpy(rng.normal(0, 10, (len(dims), 8, H1, W1))
                                 .astype(np.float32)).to(dev)
        cascade = with_median_thresholds(scd, k1, cascade, sat_l, dims)
        staged = scd.staged_tables(cascade)
        for phase in ("phase_a", "phase_b1"):
            tables = getattr(staged, phase)
            err, n, near = phase_a_vs_plain(k1, k3, tables, sat_l, dims)
            max_err = max(max_err, err)
            log(8, f"stages {counts}{' (SCD box layouts)' if layouts else ''}"
                   f", {phase} {tables.n_stages} stages / "
                   f"{tables.n_features} features, dims {dims.tolist()}: {n} "
                   f"passed, {near} in the margin, max conf diff {err:.3g}")
    for name, cascade in (("near-median", face_med), ("open", face)):
        staged = scd.staged_tables(cascade)
        for phase in ("phase_a", "phase_b1"):
            tables = getattr(staged, phase)
            err, n, near = phase_a_vs_plain(k1, k3, tables, sat0, dims0)
            max_err = max(max_err, err)
            log(8, f"face cascade {phase} ({tables.n_stages} stages, "
                   f"{tables.n_features} features), {name} thresholds, 1080p "
                   f"level-0 SAT {tuple(sat0.shape)} dims {dims0.tolist()}: "
                   f"{n} passed, {near} in the margin, max conf diff "
                   f"{err:.3g}")
    staged = scd.staged_tables(face_med)
    tabs = {"a": staged.phase_a, "b1": staged.phase_b1}
    planes = k1.kernel_planes(sat0, tabs["a"], STEP, dims0, tabs["b1"])
    runs = {key: k3.launcher(sat0, t, STEP, dims0, planes)[0]
            for key, t in tabs.items()}
    ms = {key: [] for key in tabs}
    plain = {key: [] for key in tabs}
    for key in ("a", "b1", "b1", "a"):
        ms[key].append(time_cuda(runs[key], 50))
    for key in ("a", "b1", "b1", "a"):
        plain[key].append(time_cuda(
            lambda t=tabs[key]: k3.phase_a_ref(sat0, t, STEP, dims0), 2))
    copy_ms = time_cuda(
        lambda: k1.kernel_planes(sat0, tabs["a"], STEP, dims0, tabs["b1"]),
        20)
    out = dict(max_err=max_err, plane_copy_ms=copy_ms)
    for key, t in tabs.items():
        bound, by = roofline.bound_ms(
            *k3.phase_a_work(sat0, t, STEP, dims0), "f32")
        out[key] = dict(ms=float(np.mean(ms[key])),
                        plain_ms=float(np.mean(plain[key])), bound_ms=bound,
                        bound_by=by)
    log(8, f"K3 alone at the 1080p level-0 shape, near-median thresholds "
           f"(CUDA events, 2 x 50 launches in turns; planes {tuple(planes.shape)}"
           f" made once for both): " + "; ".join(
               f"phase {key.upper()} ({tabs[key].n_features} features) "
               f"{r['ms']:.4f} ms ({', '.join(f'{x:.4f}' for x in ms[key])}),"
               f" bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
               f"{r['bound_ms'] / r['ms']:.3f} of it; plain "
               f"{r['plain_ms']:.3f} ms"
               for key, r in ((k, out[k]) for k in tabs))
           + f"; the plane copy {copy_ms:.4f} ms; {card}")
    return out


def detect_ms(scd, img, cascade, params, form, n):
    """Per-image ms of ``n`` detects, the host synchronised with the card
    inside each timed window."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scd.detect(img, cascade, params, form=form)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1000)
    return out


def staged_path(scd, k1, k3, dev, card, crop, tt, frame, face, face_med):
    """Phase 9, the staged form's main path (K3 for phases A and B1, B2 on
    the first K2 survivors, the overflow rerun) and detect_batch in both
    forms. Returns K3's launches in it."""
    def levels(H, W, cascade, params):
        specs = scd._level_specs(H, W, cascade, params)[0]
        return specs, len({s[0] for s in specs})

    # K3 launches of one staged octave or rerun: phase A, and B1 if any
    per = 1 + (scd.staged_tables(face).phase_b1 is not None)

    k3.LAUNCHES = 0
    # crop180 against the C goldens. face_low's thresholds are open: every
    # window survives, so every level with more windows than K2 is rerun
    for interval, golden, tol in ((1, "crop180.scd_i1.txt", 6e-3),
                                  (5, "crop180.scd_open.txt", 2e-2)):
        params = scd.ScdParams(min_neighbors=0, interval=interval)
        specs, n_oct = levels(180, 180, face, params)
        want_reruns = sum(s[4] * s[5] > scd._level_capacity2(s[4] * s[5])
                          for s in specs)
        before, reruns = k3.LAUNCHES, scd.RERUNS
        out = scd.detect(crop, face, params, form="pallas")
        launched, reruns = k3.LAUNCHES - before, scd.RERUNS - reruns
        check(reruns == want_reruns > 0, f"crop180 interval={interval}: "
              f"{reruns} levels rerun, {want_reruns} overflow K2")
        check(launched == per * (n_oct + reruns), f"crop180 interval="
              f"{interval}: K3 launched {launched} times for {n_oct} octaves "
              f"and {reruns} reruns, {per} a dispatch")
        ref = golden_rects(golden)
        mine = {(c.x, c.y, c.width, c.height): c.confidence for c in out}
        check(set(mine) == set(ref), f"crop180 interval={interval}, staged: "
              f"{len(mine)} windows vs {len(ref)} in {golden}")
        diff = max(abs(mine[r] - ref[r]) for r in ref)
        check(diff < tol, f"crop180 interval={interval}, staged: conf diff "
                          f"{diff}")
        log(9, f"crop180 interval={interval}, form pallas: {len(mine)} "
               f"windows = {golden}, max conf diff {diff:.3g} (< {tol}); K3 "
               f"{launched} launches = {per} x ({n_oct} octaves + {reruns} "
               f"reruns)")

    # real sizes: the staged form against the full-cascade form
    params = scd.ScdParams(min_neighbors=0)
    for name, img, cascade, reps in (
            ("640x480", tt.tensor.to(dev), face, 3),
            ("1920x1080", torch.from_numpy(frame).to(dev), face_med, 3)):
        H, W = img.shape
        _specs, n_oct = levels(H, W, cascade, params)
        before, reruns = k3.LAUNCHES, scd.RERUNS
        got = rect_set(scd.detect(img, cascade, params, form="pallas"))
        launched, reruns = k3.LAUNCHES - before, scd.RERUNS - reruns
        check(launched == per * (n_oct + reruns), f"{name}: K3 launched "
              f"{launched} times for {n_oct} octaves and {reruns} reruns, "
              f"{per} a dispatch")
        want = rect_set(scd.detect(img, cascade, params))
        check(len(want) > 0, f"{name}: no windows passed")
        odd = got ^ want
        if odd:
            near = margin_rects(scd, k1, img, cascade, params, dev)
            check(odd <= near, f"{name}: the forms differ on "
                               f"{len(odd - near)} windows outside the margin")
        full, staged = [], []
        for _ in range(reps):  # in turns
            full += detect_ms(scd, img, cascade, params, "pallas_full", 1)
            staged += detect_ms(scd, img, cascade, params, "pallas", 1)
        log(9, f"{name}: {len(got)} windows, form pallas = pallas_full "
               f"({len(odd)} in the margin); K3 {launched} launches = {per} x "
               f"({n_oct} octaves + {reruns} reruns); median ms/image (n={reps}, in "
               f"turns): pallas {float(np.median(staged)):.2f}, pallas_full "
               f"{float(np.median(full)):.2f}; {card}")

    # detect_batch: 4 different 1080p frames, one dispatch per octave
    frames = np.stack([frame, frame[:, ::-1], frame[::-1],
                       np.roll(frame, 200, axis=1)])
    batch = torch.from_numpy(frames).to(dev)
    _specs, n_oct = levels(*frame.shape, face_med, params)
    for form, kern in (("pallas_full", k1), ("pallas", k3)):
        before, reruns = kern.LAUNCHES, scd.RERUNS
        got = scd.detect_batch(batch, face_med, params, form=form)
        launched, reruns = kern.LAUNCHES - before, scd.RERUNS - reruns
        check(launched == (per * (n_oct + reruns) if form == "pallas"
                           else n_oct),
              f"detect_batch {form}: {launched} launches for {n_oct} "
              f"octaves and {reruns} reruns")
        single = [scd.detect(batch[b], face_med, params, form=form)
                  for b in range(len(frames))]
        n_odd = 0
        for b, (g, s) in enumerate(zip(got, single)):
            odd = rect_set(g) ^ rect_set(s)
            if odd:
                near = margin_rects(scd, k1, batch[b], face_med, params, dev)
                check(odd <= near, f"detect_batch {form}, frame {b}: "
                      f"{len(odd - near)} windows differ from detect outside "
                      f"the margin")
            n_odd += len(odd)
        check(all(len(g) > 0 for g in got), f"detect_batch {form}: a frame "
                                            f"found nothing")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scd.detect_batch(batch, face_med, params, form=form)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1000 / len(frames)
        single_ms = float(np.mean([detect_ms(scd, batch[b], face_med, params,
                                             form, 1)[0]
                                   for b in range(len(frames))]))
        log(9, f"detect_batch of {len(frames)} 1080p frames, form {form}: "
               f"{[len(g) for g in got]} windows = per-image detect "
               f"({n_odd} in the margin); {launched} launches for {n_oct} "
               f"octaves and {reruns} reruns; {batch_ms:.2f} ms/image "
               f"batched, {single_ms:.2f} ms/image one at a time; {card}")
    return k3.LAUNCHES


def upscaled_path(scd, k1, k3, dev, card, frame, face):
    """Phase 11: detect with ScdParams(size=(24, 24)) on the 1080p frame,
    which the 48x48 cascade scales up 2x (INTER_CUBIC, 3840x2160) before
    its pyramid, with thresholds near the median of the up-scaled level 0's
    stage sums. Returns (K1 launches, K3 launches, params)."""
    params = scd.ScdParams(size=(24, 24), min_neighbors=0)
    ratio = scd.up_ratio(face, params)
    frame_t = torch.from_numpy(frame).to(dev)
    up = scd._image(frame_t, face, params, dev)
    cpu = scd._image(torch.from_numpy(frame), face, params, "cpu")
    check(up.dtype == torch.uint8 and torch.equal(up.cpu(), cpu),
          "the up-scaled frame differs between the card and the CPU")
    H, W = up.shape[:2]
    specs = scd._level_specs(H, W, face, params)[0]
    n_oct = len({s[0] for s in specs})
    dims0 = np.array([specs[0][4:6]])
    sat0 = scd._sat_cf8(scd.scd_map_cf8(up))[None].contiguous()
    face_up = with_median_thresholds(scd, k1, face, sat0, dims0)
    del sat0
    per = 1 + (scd.staged_tables(face_up).phase_b1 is not None)
    log(11, f"1080p frame up-scaled {ratio}x by INTER_CUBIC to {W}x{H}: "
            f"bit-equal on the card and the CPU (whole frame); {len(specs)} "
            f"levels in {n_oct} octaves; thresholds near the median of the "
            f"up-scaled level 0 ({dims0.tolist()} windows): "
            f"{face_up.thresholds.tolist()}")

    # the main path: the counts set to 0 just before, read just after
    k1.LAUNCHES, k3.LAUNCHES = 0, 0
    reruns = scd.RERUNS
    full = rect_set(scd.detect(frame_t, face_up, params))
    k1_n = k1.LAUNCHES
    staged = rect_set(scd.detect(frame_t, face_up, params, form="pallas"))
    k3_n, reruns = k3.LAUNCHES, scd.RERUNS - reruns
    check(k1_n == n_oct, f"up-scaled detect launched K1 {k1_n} times for "
                         f"{n_oct} octaves")
    check(k3_n == per * (n_oct + reruns), f"up-scaled staged detect "
          f"launched K3 {k3_n} times for {n_oct} octaves and {reruns} "
          f"reruns, {per} a dispatch")
    check(len(full) > 0, "up-scaled: no windows passed")
    plain = rect_set(scd.detect(frame_t, face_up, params,
                                evaluate=k1.cascade_eval_levels_ref))
    odd_plain, odd_forms = full ^ plain, full ^ staged
    if odd_plain or odd_forms:
        near = margin_rects(scd, k1, frame_t, face_up, params, dev)
        check(odd_plain <= near, f"up-scaled: K1 and its plain version "
              f"differ on {len(odd_plain - near)} windows outside the margin")
        check(odd_forms <= near, f"up-scaled: the forms differ on "
              f"{len(odd_forms - near)} windows outside the margin")
    check(min(r[2] for r in full) < face.width,
          "up-scaled: no window finer than the cascade")
    ms_full = detect_ms(scd, frame_t, face_up, params, "pallas_full", 5)
    ms_staged = detect_ms(scd, frame_t, face_up, params, "pallas", 3)
    log(11, f"up-scaled 1080p detect: {len(full)} windows out, smallest "
            f"{min(r[2] for r in full)} px; pallas_full = K1's plain version"
            f" ({len(odd_plain)} in the margin), pallas = pallas_full "
            f"({len(odd_forms)} in the margin); K1 {k1_n} launches = "
            f"{n_oct} octaves; K3 {k3_n} = {per} x ({n_oct} octaves + "
            f"{reruns} reruns); median ms/image: pallas_full "
            f"{float(np.median(ms_full)):.2f} (n=5: "
            f"{', '.join(f'{x:.2f}' for x in ms_full)}), pallas "
            f"{float(np.median(ms_staged)):.2f} (n=3: "
            f"{', '.join(f'{x:.2f}' for x in ms_staged)}); {card}")
    return k1_n, k3_n, params


def cubic_device_ms(scd, dev, card, frame, face, params):
    """Phase 11's INTER_CUBIC step (1080p -> 3840x2160, uint8, float64
    sums) under torch.profiler: the card's busy ms per call, its kernels,
    and the wall of the same calls (the host builds the weight matrices)."""
    frame_t = torch.from_numpy(frame).to(dev)
    scd._image(frame_t, face, params, dev)  # warm-up
    busy, by_name, wall = device_ms(
        lambda: scd._image(frame_t, face, params, dev), 5)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(11, f"INTER_CUBIC up-scale of the 1080p frame under torch.profiler "
            f"(5 calls): device busy {busy:.3f} ms per call over a wall of "
            f"{wall:.2f} ms (host weight matrices included); largest: "
            + "; ".join(f"{k} {v:.3f}" for k, v in top) + f"; {card}")
    return busy


def png_bytes(img):
    """An 8-bit gray or RGB PNG of ``img`` (filter 0 on every row), made
    with the standard library."""
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    rows = b"".join(b"\x00" + row.tobytes()
                    for row in np.ascontiguousarray(img).reshape(h, -1))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows, 6)) + chunk(b"IEND", b""))


def http(url, data=None, headers=None):
    """(status, JSON body) of a GET (no data) or POST to ``url``."""
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def served_path(scd, k1, dev, card, frame, face_med):
    """Phase 12: ccv_tpu_torch.serve.server on the card, in a thread, with a
    models directory whose face.sqlite3 holds face_med's thresholds and a
    last stage raised so that a few hundred 1080p windows pass before the
    merge (an O(n^2) Python loop). Its answers against direct detect calls,
    its error paths, its request ms at 1080p. Returns K1's launches."""
    from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
    from ccv_tpu_torch.serve import server

    frame_t = torch.from_numpy(frame).to(dev)
    params = scd.ScdParams(min_neighbors=0)
    confs = np.sort([c.confidence for c in
                     scd.detect(frame_t, face_med, params)])[::-1]
    sums = (confs - (face_med.n_stages - 1)) * float(face_med.stage_counts[-1])
    lo = 150  # the widest gap between the 150th and 400th largest sums
    i = lo + int(np.argmax(sums[lo:400] - sums[lo + 1:401]))
    last = float((sums[i] + sums[i + 1]) / 2)
    thresholds = list(face_med.thresholds[:-1]) + [last]
    tmp = tempfile.mkdtemp(prefix="ccv_serve_")
    srv = None
    try:
        path = os.path.join(tmp, "face.sqlite3")
        shutil.copy(os.path.join(DATA, "face_low.sqlite3"), path)
        con = sqlite3.connect(path)
        con.executemany("UPDATE classifier_params SET threshold = ? WHERE "
                        "classifier = ?",
                        [(float(t), s) for s, t in enumerate(thresholds)])
        con.commit()
        con.close()
        cascade = scd.load_cascade(path)
        n_pass = len(scd.detect(frame_t, cascade, params))
        check(50 <= n_pass <= 2000, f"the served cascade passes {n_pass} "
                                    f"1080p windows before the merge")
        srv = server.Server(("127.0.0.1", 0), tmp)  # the card by default
        check(srv.device.type == "cuda", f"the server runs on {srv.device}")
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        rgb = np.repeat(frame[..., None], 3, axis=-1)  # decoded as RGB
        crop = read(os.path.join(DATA, "crop180.png"), IO_RGB_COLOR,
                    device=dev)
        with open(os.path.join(DATA, "crop180.png"), "rb") as f:
            crop_png = f.read()
        frame_png = png_bytes(frame)
        boundary = "chipsmoke"
        form = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f"name=\"source\"; filename=\"f.png\"\r\n\r\n").encode() \
            + frame_png + f"\r\n--{boundary}--\r\n".encode()
        k1.LAUNCHES = 0  # the served main path: set just before, read after
        answers = {
            "1080p raw": http(url + "/scd/detect.objects", frame_png),
            "1080p multipart": http(url + "/scd/detect.objects", form, {
                "Content-Type": f"multipart/form-data; boundary={boundary}"}),
            "crop180": http(url + "/scd/detect.objects", crop_png)}
        launches = k1.LAUNCHES
        n_oct = sum(len({s[0] for s in scd._level_specs(
            h, w, cascade, scd.ScdParams())[0]})
            for h, w in (frame.shape, frame.shape, (180, 180)))
        check(launches == n_oct, f"3 requests launched K1 {launches} times "
                                 f"for {n_oct} octaves")
        for name, img in (("1080p raw", rgb), ("1080p multipart", rgb),
                          ("crop180", crop.tensor)):
            code, out = answers[name]
            want = server._rects(scd.detect(
                torch.as_tensor(img).to(dev), cascade))
            check(code == 200 and out == want, f"/scd {name}: {code}, "
                  f"{len(out)} rects against {len(want)} from detect")
        check(len(answers["1080p raw"][1]) > 0, "/scd found nothing at 1080p")
        errors = {
            "get /": (http(url + "/"), 200),
            "unknown": (http(url + "/nope"), 404),
            "junk": (http(url + "/scd/detect.objects", b"junk"), 400),
            "empty": (http(url + "/scd/detect.objects", b""), 400),
            "too large": (http(url + "/scd/detect.objects", b"x", {
                "Content-Length": str(server.MAX_BODY_BYTES + 1)}), 413)}
        for name, ((code, out), want_code) in errors.items():
            check(code == want_code, f"/scd {name}: {code}, not {want_code}")
        check(errors["get /"][0][1] == server.endpoints()
              and len(server.endpoints()) == 9,
              f"GET / lists {errors['get /'][0][1]}")
        jpeg_note = served_jpeg(scd, server, url, dev, frame, cascade)
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            code, _out = http(url + "/scd/detect.objects", frame_png)
            ms.append((time.perf_counter() - t0) * 1000)
            check(code == 200, f"/scd 1080p: {code}")
        log(12, f"/scd/detect.objects on {srv.device}: 1080p PNG "
                f"({len(frame_png)} bytes) raw and multipart and crop180 "
                f"equal direct detect ({len(answers['1080p raw'][1])}, "
                f"{len(answers['1080p multipart'][1])} and "
                f"{len(answers['crop180'][1])} rects; {n_pass} windows "
                f"before the merge at 1080p, last-stage threshold {last:.4f});"
                f" K1 {launches} launches = {n_oct} octaves over the 3 "
                f"requests; 404, 400 (junk, empty) and 413 answered; "
                f"{jpeg_note}; "
                f"request ms at 1080p, median of 5: "
                f"{float(np.median(ms)):.2f} "
                f"({', '.join(f'{x:.2f}' for x in ms)}); {card}")
        return launches
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)


def served_jpeg(scd, server, url, dev, frame, cascade):
    """/scd with JPEG bodies: a truncated one answers 400, and the 1080p
    frame as a JPEG answers the rects of a direct ``detect`` on the same
    decode. Where libjpeg's header is missing (the card's machine) the
    decode is PIL's, as ``ccv_tpu``'s read falls back to PIL, and
    ``core.io.DECODED`` must count it there; else it is libjpeg's."""
    import io as _io
    from PIL import Image
    from ccv_tpu_torch import _native_build
    from ccv_tpu_torch.core import io as tio
    before = dict(tio.DECODED)
    head = b"\xff\xd8\xff\xe0" + bytes(64)  # a JPEG's first bytes only
    code, out = http(url + "/scd/detect.objects", head)
    check(code == 400, f"/scd truncated JPEG: {code} {out}")
    buf = _io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=90)
    data = buf.getvalue()
    code, out = http(url + "/scd/detect.objects", data)
    want = server._rects(scd.detect(
        torch.from_numpy(tio.decode(data, tio.IO_RGB_COLOR)).to(dev),
        cascade))
    check(code == 200 and out == want, f"/scd 1080p JPEG: {code}, "
          f"{len(out)} rects against {len(want)} from detect")
    no_libjpeg = "image_decode" in _native_build._failed
    route = "pil" if no_libjpeg else "native"
    used = {k: v - before[k] for k, v in tio.DECODED.items()}
    check(used[route] >= 2 and (no_libjpeg or used["pil"] == 0),
          f"/scd JPEG decodes by route {used} (libjpeg "
          f"{'missing' if no_libjpeg else 'built'})")
    return (f"1080p JPEG ({len(data)} bytes) = direct detect ({len(out)} "
            f"rects), truncated JPEG 400; decoded by "
            f"{'PIL (no jpeglib.h)' if no_libjpeg else 'libjpeg'}: {used}")


def narrow_layers(L):
    """conv, ReLU, 3x3 max-pool "SAME" at stride 2 (uneven pads), a stride-2
    conv, BatchNorm, 2x2 average pool "SAME", flatten at 2 x 2 x 16,
    dense."""
    return [L.Convolution(8, (3, 3), padding="SAME", name="c0"), L.ReLU(),
            L.MaxPool((3, 3), (2, 2), "SAME"),
            L.Convolution(16, (3, 3), stride=(2, 2), padding="SAME",
                          name="c1"),
            L.BatchNorm(name="bn"), L.AvgPool((2, 2), (2, 2), "SAME"),
            L.Flatten(), L.Dense(10, name="fc")]


def model_card_vs_cpu(name, layers, shape, dev, card):
    """A Sequential built from seed 0 with seeded biases and BN statistics,
    as numpy arrays copied to the CPU and to the card by params_from_jax;
    the card's float32 and bf16 logits against the CPU's. Returns the
    errors over the largest logit."""
    from ccv_tpu_torch.nn.model import Sequential, params_from_jax
    cpu = Sequential(layers)
    cpu.build(shape, device="cpu")
    rng = np.random.default_rng(13)
    params = [{k: (rng.normal(0, 0.5, tuple(v.shape)).astype(np.float32)
                   if k in ("b", "bias") else v.numpy())
               for k, v in p.items()} for p in cpu.params]
    state = [{"mean": rng.normal(0, 0.5, tuple(s["mean"].shape)).astype(
                  np.float32),
              "var": rng.uniform(0.5, 1.5, tuple(s["var"].shape)).astype(
                  np.float32)} if s else {} for s in cpu.state]
    gpu = Sequential(layers)
    gpu.build(shape, device=dev)
    for m, d in ((cpu, "cpu"), (gpu, dev)):
        m.set_parameters(params_from_jax(params, d))
        m.state = params_from_jax(state, d)
    x = rng.normal(0, 50, shape).astype(np.float32)
    errs = {}
    for dtype, frac in ((torch.float32, CLS_F32), (torch.bfloat16, CLS_BF16)):
        want = cpu.evaluate(torch.from_numpy(x).to(dtype)).float()
        got = gpu.evaluate(torch.from_numpy(x).to(dev, dtype))
        check(got.is_cuda and got.dtype == dtype, f"{name}: {got.device}, "
                                                  f"{got.dtype}")
        got = got.float().cpu()
        check(bool(torch.isfinite(got).all()), f"{name}: logits not finite")
        rel = float((got - want).abs().max() / want.abs().max())
        check(rel <= frac, f"{name} {dtype}: card - CPU {rel:.3g} of the "
                           f"largest logit (limit {frac})")
        errs[str(dtype).split(".")[1]] = rel
    log(13, f"{name} {tuple(shape)} -> {tuple(got.shape)}: card against "
            f"CPU, max |diff| over the largest logit: float32 "
            f"{errs['float32']:.3g} (limit {CLS_F32}), bfloat16 "
            f"{errs['bfloat16']:.3g} (limit {CLS_BF16}); {card}")
    return errs


def classification_path(dev, card):
    """Phase 13: the image-classification path on the card. The narrow
    model and VGG-D (10 classes, 64 x 64, B 2) against the CPU; the
    reference-written tiny convnets classify text_test.png on the card as
    on the CPU, and through the cnnclassify CLI; then bench_vgg's twin at
    full size (VGG-D, B 32, 224 x 224, bf16). Returns the VGG-D model, its
    batch and the measurement."""
    import contextlib
    import io as _io
    from ccv_tpu_torch.bin import cnnclassify, vgg_bench
    from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
    from ccv_tpu_torch.models import vgg
    from ccv_tpu_torch.models.convnet import Convnet
    from ccv_tpu_torch.nn import layers as L

    model_card_vs_cpu("narrow model", narrow_layers(L), (2, 15, 13, 3), dev,
                      card)
    model_card_vs_cpu("VGG-D (10 classes)", vgg.vgg_d(num_classes=10).layers,
                      (2, 64, 64, 3), dev, card)

    png = os.path.join(DATA, "text_test.png")
    img = read(png, IO_RGB_COLOR, device="cpu").tensor
    for kind in ("f32", "f16"):
        path = os.path.join(DATA, f"tiny_convnet_{kind}.sqlite3")
        want = Convnet.read(path, device="cpu").classify(img, tops=5)
        net = Convnet.read(path, device=dev)
        check(net.layers[0].w.is_cuda, "the convnet's weights are not on "
                                       "the card")
        t0 = time.perf_counter()
        got = net.classify(img.to(dev), tops=5)
        ms = (time.perf_counter() - t0) * 1000
        err = max(abs(c - w) for (_, c), (_, w) in zip(got, want))
        check([i for i, _ in got] == [i for i, _ in want],
              f"tiny convnet {kind}: card top 5 {got}, CPU {want}")
        check(err <= CLS_CONF, f"tiny convnet {kind}: confidences differ by "
                               f"{err:.3g}")
        log(13, f"tiny_convnet_{kind}.sqlite3 on text_test.png (10 patches, "
                f"a 2-partition convolution): top 5 {got} on the card = the "
                f"CPU's ids, confidences within {err:.3g}; {ms:.2f} ms")
        if kind == "f32":
            ids = [i for i, _ in want]
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        cnnclassify.main([png, os.path.join(DATA, "tiny_convnet_f32.sqlite3")])
    line = out.getvalue().strip()
    cli_ids = [int(p.split()[0]) - 1 for p in line.split(" | ")[:-1]]
    check(cli_ids == ids, f"cnnclassify printed {line!r}, the CPU's ids are "
                          f"{ids}")
    log(13, f"python -m ccv_tpu_torch.bin.cnnclassify text_test.png "
            f"tiny_convnet_f32.sqlite3 (default device, the card): {line}")

    model, x = vgg_bench.build()
    res = vgg_bench.measure(model, x)
    check(res["logits_finite"], "VGG-D logits not finite")
    check(round(res["gflops_per_image"], 2) == 30.94,
          f"VGG-D GFLOP per image {res['gflops_per_image']}")
    log(13, f"vgg_bench: VGG-D ({res['params_m']:.1f} M parameters, float32,"
            f" cast to bf16 in each op), batch {res['batch']} x "
            f"{res['res']}x{res['res']}x3 bf16: {res['ms_per_batch']:.3f} ms "
            f"a batch (mean of {vgg_bench.STEPS} after a warm-up of "
            f"{res['warmup_s']:.2f} s), {res['images_per_s']:.1f} images/s, "
            f"{res['gflops_per_image']:.2f} GFLOP an image, MFU "
            f"{res['mfu']:.4f} of {res['peak_tflops']:.0f} TFLOP/s; {card}")
    vgg_timed_vs_cpu(model, x, card)
    return model, x, res


def single_rounding_logits(model, x):
    """The model's forward in x's type with every convolution rounded once,
    as ccv_tpu rounds it: x and the weights rounded to x's type, convolved
    in float32 (TF32 off: exact products, float32 sums), the float32 bias
    added, one rounding. The other layers run as in the port."""
    from ccv_tpu_torch.nn import layers as L
    from ccv_tpu_torch.nn import ops
    with torch.no_grad():
        for layer, p, s in zip(model.layers, model.params, model.state):
            if isinstance(layer, L.Convolution):
                x = ops.conv2d(x.float(), p["w"].to(x.dtype).float(),
                               p.get("b"), layer.stride, layer.padding,
                               layer.dilation, layer.groups).to(x.dtype)
            else:
                x, _ = layer.apply(p, s, x)
    return x


def vgg_timed_vs_cpu(model, x, card):
    """The timed configuration held against the CPU: the card's logits of
    the first two images of the B 32 x 224 bf16 batch (computed at B 32,
    as measured) against the CPU's forward of those two images on the same
    weights, within CLS_BF16 of the largest logit; once with vgg_bench's
    weights (zero biases, as initialised), once with seeded biases. Beside
    it, how far the card's two roundings of each convolution's bias move
    the logits: the card's and the CPU's logits against
    ``single_rounding_logits`` on the card, the largest and the mean
    |difference| over the largest logit."""
    from ccv_tpu_torch.models import vgg
    from ccv_tpu_torch.nn.model import Sequential
    rng = np.random.default_rng(17)
    biased = [{k: (torch.from_numpy(rng.normal(0, 0.5, tuple(v.shape)).astype(
        np.float32)).to(v.device) if k == "b" else v) for k, v in p.items()}
        for p in model.params]
    cpu = vgg.vgg_d()
    cpu.build((2, *x.shape[1:]), device="cpu")
    notes = []
    for name, params in (("vgg_bench's weights (zero biases)", model.params),
                         ("seeded biases N(0, 0.5)", biased)):
        card_m = Sequential(model.layers)
        card_m.set_parameters(params)
        card_m.state = model.state
        with torch.no_grad():
            got = card_m.evaluate(x)[:2].float().cpu()
        cpu.set_parameters([{k: v.cpu() for k, v in p.items()}
                            for p in params])
        t0 = time.perf_counter()
        want = cpu.evaluate(x[:2].cpu()).float()
        cpu_s = time.perf_counter() - t0
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
              f"VGG-D {name}: logits not finite")
        once = single_rounding_logits(card_m, x[:2]).float().cpu()
        top = float(once.abs().max())

        def gap(a, b):
            d = (a - b).abs()
            return float(d.max()) / top, float(d.mean()) / top

        rel = gap(got, want)
        check(rel[0] <= CLS_BF16, f"VGG-D B {x.shape[0]} bf16, {name}: card "
                                  f"- CPU {rel[0]:.3g} of the largest logit "
                                  f"(limit {CLS_BF16})")
        g_card, g_cpu = gap(got, once), gap(want, once)
        notes.append(f"{name}: card - CPU {rel[0]:.3g} (mean {rel[1]:.3g}; "
                     f"CPU forward {cpu_s:.1f} s); against one rounding, "
                     f"the card {g_card[0]:.3g} (mean {g_card[1]:.3g}), the "
                     f"CPU {g_cpu[0]:.3g} (mean {g_cpu[1]:.3g})")
    log(13, f"VGG-D at the timed size (B {x.shape[0]} x {x.shape[1]}^2 "
            f"bf16, images 0-1), max |diff| over the largest logit (limit "
            f"{CLS_BF16}), and against one rounding of each convolution on "
            f"the card (float32 sums, float32 bias, as ccv_tpu): "
            + "; ".join(notes) + f"; {card}")


def vgg_profiled(model, x, card):
    """Phase 13's profile, last: three VGG-D batches under torch.profiler."""
    from ccv_tpu_torch.bin import vgg_bench
    prof = vgg_bench.profile(model, x, 3)
    busy = prof["device_busy_ms"]
    check(busy > 0, "the profiler saw no device time in VGG-D's forwards")
    log(13, f"VGG-D B {x.shape[0]} bf16 under torch.profiler (3 batches): "
            f"device busy {busy:.3f} ms a batch over a wall of "
            f"{prof['wall_ms']:.3f} ms (profiler overhead included): idle "
            f"share {prof['idle_share']:.3f}; convolutions "
            f"{prof['conv_ms']:.3f} ms ({prof['conv_ms'] / busy:.3f}), "
            f"matmuls {prof['gemm_ms']:.3f} ({prof['gemm_ms'] / busy:.3f}), "
            f"dtype-cast copies {prof['cast_ms']:.3f} "
            f"({prof['cast_ms'] / busy:.3f}), the rest "
            f"{prof['other_ms']:.3f}; the largest kernels: "
            + "; ".join(f"{k} {v:.3f}" for k, v in prof["top"])
            + "; by torch op: "
            + "; ".join(f"{k} {v:.3f}" for k, v in prof["top_ops"])
            + f"; {card}")


def to_device(tree, dev):
    """A copy of a nested dict/list of parameters on ``dev``, leaf tensors
    that require grad."""
    if isinstance(tree, dict):
        return {key: to_device(val, dev) for key, val in tree.items()}
    if isinstance(tree, list):
        return [to_device(val, dev) for val in tree]
    return tree.detach().to(dev).requires_grad_(True)


def s2s_config(layers=None, dtype=torch.bfloat16, dropout=0.0):
    from ccv_tpu_torch.models import transformer as tfm
    return tfm.TransformerConfig(**{**S2S, "layers": layers or S2S["layers"]},
                                 dtype=dtype, dropout=dropout)


def s2s_name(cfg):
    return (f"{cfg.layers} + {cfg.layers} layers, d {cfg.dim} = "
            f"{cfg.heads} heads of {cfg.head_dim}, ff {cfg.ff}, vocab "
            f"{cfg.vocab_size} / {cfg.tgt_vocab_size}")


def k2_padded_compare(k2, shape, dtype, dev, rng):
    """flash_attention at a head dim the kernels are not built for (zero-
    padded inside: at D 1-32 to 32 for the 16-bit "wgmma-tma" kernels and
    to 64 for float32's tc-f32 ones) against the plain versions on the same
    padded operands: o from the forward, dq, dk and dv from autograd's
    backward, with the K2 gates."""
    b, t, h, d, causal = shape
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, t, h, d),
                                                        np.float32))
                   .to(dev, dtype) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    before = {key: dict(c) for key, c in k2.DESIGN_LAUNCHES.items()}
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = k2.flash_attention(*leaves, scale=scale, is_causal=causal)
    o.backward(do)
    torch.cuda.synchronize()
    ran = {key: {n: c - before[key][n] for n, c in cs.items()
                 if c > before[key][n]}
           for key, cs in k2.DESIGN_LAUNCHES.items()}
    pad = k2.padded_dim(d)
    check(ran == {key: {k2._design(key, dtype, pad): 1} for key in ran},
          f"flash_attention at {shape} {dtype} ran the designs {ran}")
    qp, kp, vp, dop = (k2._to_bthd(x, pad) for x in (q, k, v, do))
    o0, lse0 = k2.flash_fwd_ref(qp, kp, vp, scale, causal)
    delta = (dop.float() * o0.float()).sum(-1)
    dq0 = k2.flash_dq_ref(qp, kp, vp, dop, lse0, delta, scale, causal)
    dk0, dv0 = k2.flash_dkv_ref(qp, kp, vp, dop, lse0, delta, scale, causal)
    errs, rels = {}, {}
    for key, name, got, ref in (("fwd", "o", o, o0),
                                ("dq", "dq", leaves[0].grad, dq0),
                                ("dkv", "dk", leaves[1].grad, dk0),
                                ("dkv", "dv", leaves[2].grad, dv0)):
        got, ref = k2._to_bthd(got.detach(), d), ref[..., :d]
        err = float((got.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        bound = (K2_F32 + K2_F32 * top if dtype == torch.float32
                 else K2_BF16 * top)
        check(bool(torch.isfinite(got).all()) and err <= bound,
              f"padded K2 {name} at {shape} {dtype}: max error {err:.3g} > "
              f"{bound:.3g}")
        rel = tile_rel_err(got, ref)
        check(rel <= K2_TILE_REL, f"padded K2 {name} at {shape} {dtype}: a "
              f"64-row tile is off by {rel:.3g} of its norm")
        errs[key] = max(errs.get(key, 0.0), err)
        rels[key] = max(rels.get(key, 0.0), rel)
    return errs, rels


def k2_slice_shapes(k2, roofline, dev, card):
    """Phase 14: K2 at this slice's shapes against its plain versions, and
    K2a timed at the decode shape beside SDPA's flash forward."""
    rng = np.random.default_rng(19)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in K2_PADDED:
            errs, rels = k2_padded_compare(k2, shape, dtype, dev, rng)
            for key in errs:
                worst[key] = max(worst.get(key, 0.0), errs[key])
            pad = k2.padded_dim(shape[3], dtype)
            log(14, f"flash_attention at (B, T, H, D, causal) {shape} "
                    f"{dtype}, D padded to {pad} "
                    f"({k2._design('fwd', dtype, pad)}): max abs error "
                    f"{ {k: f'{e:.3g}' for k, e in errs.items()} }; worst "
                    f"64-row tile error / tile norm "
                    f"{ {k: f'{e:.3g}' for k, e in rels.items()} }")
    for shape in (K2_DECODE, K2_WMT):
        errs, rels = k2_compare(k2, shape, torch.bfloat16, dev, rng)
        for key in errs:
            worst[key] = max(worst.get(key, 0.0), errs[key])
        log(14, f"K2 vs plain at {shape} bf16 (wgmma-tma): max abs error "
                f"{ {k: f'{e:.3g}' for k, e in errs.items()} }; worst 64-row "
                f"tile error / tile norm "
                f"{ {k: f'{e:.3g}' for k, e in rels.items()} }")
    q, k, v, do = k2_inputs(K2_DECODE, torch.bfloat16, dev, rng)
    scale = 1.0 / np.sqrt(K2_DECODE[3])
    from ccv_tpu_torch.bin.k2_trial import library_calls
    lib_fwd, _ = library_calls(q, k, v, do, scale, b=DECODE_B)
    kern = lambda: k2.flash_fwd(q, k, v, scale, True)  # noqa: E731
    # in turns: kernel, library, library, kernel (50 calls each)
    ms = [time_cuda(kern, 50), time_cuda(lib_fwd, 50), time_cuda(lib_fwd, 50),
          time_cuda(kern, 50)]
    flop, nbytes = k2.flash_work("fwd", *K2_DECODE, torch.bfloat16)
    bound, by = roofline.bound_ms(flop, nbytes, "bf16")
    # the kernels' own device time (the profiler's), beside the event
    # times above, which a few microseconds of work leaves to the host's
    # launch rate
    dev_k = device_ms(kern, 50)[0]
    dev_lib = device_ms(lib_fwd, 50)[0]
    res = dict(ms=(ms[0] + ms[3]) / 2, library_ms=(ms[1] + ms[2]) / 2,
               plain_ms=time_cuda(lambda: k2.flash_fwd_ref(q, k, v, scale,
                                                           True), 5),
               bound_ms=bound, bound_by=by, device_ms=dev_k,
               library_device_ms=dev_lib)
    log(14, f"K2a at the decode shape {K2_DECODE} bf16 (CUDA events, 2 x 50 "
            f"launches in turns with SDPA's flash forward): "
            f"{res['ms']:.4f} ms (runs {[round(x, 4) for x in ms]}), "
            f"library {res['library_ms']:.4f} ms, plain "
            f"{res['plain_ms']:.3f} ms, bound {bound:.4f} ms ({by}: "
            f"{flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
            f"{bound / res['ms']:.3f} of it; device time per launch "
            f"(torch.profiler, 50 launches): kernel {dev_k:.4f} ms, library "
            f"{dev_lib:.4f} ms; {card}")
    return worst, res


def seq2seq_card_vs_cpu(dev, card):
    """Phase 15: encoder_decoder_forward and encoder_classifier_forward at 2
    layers of the full widths on the card against the CPU, from the same
    parameters, masked and unmasked, in float32 and bf16."""
    from ccv_tpu_torch.bin.wmt_grad_trial import synthetic_batch
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.ops.kernels import flash_attention as k2
    b, ts, tt = S2S_CPU
    rng = np.random.default_rng(23)
    src, tgt, _ = synthetic_batch(rng, b, max(ts, tt), S2S["vocab_size"],
                                S2S["tgt_vocab_size"])
    src, tgt = torch.from_numpy(src[:, :ts]), torch.from_numpy(tgt[:, :tt])
    smask = src != S2S["vocab_size"] - 1
    tmask = tgt != S2S["tgt_vocab_size"] - 1
    out = {}
    for dtype, frac in ((torch.float32, CLS_F32), (torch.bfloat16, CLS_BF16)):
        cfg = s2s_config(layers=2, dtype=dtype)
        gen = torch.Generator().manual_seed(8)
        cpu_models = {"seq2seq": tfm.init_encoder_decoder(gen, cfg),
                      "classifier": tfm.init_encoder_classifier(gen, cfg, 2)}
        for masked in (False, True):
            for name, params in cpu_models.items():
                if name == "seq2seq":
                    def fwd(p, d, masked=masked):
                        return tfm.encoder_decoder_forward(
                            p, cfg, src.to(d), tgt.to(d),
                            *((smask.to(d), tmask.to(d)) if masked
                              else (None, None)))
                    # unmasked: the encoder's (Ts x Ts) and the decoder's
                    # causal (Tt x Tt) self-attention take K2; Ts != Tt
                    # keeps the cross-attention on the plain SDPA
                    launches = 0 if masked else 4
                else:
                    def fwd(p, d, masked=masked):
                        return tfm.encoder_classifier_forward(
                            p, cfg, src.to(d), smask.to(d) if masked
                            else None)
                    launches = 0 if masked else 2
                with torch.no_grad():
                    want = fwd(params, "cpu").float()
                    k2.reset_launches()
                    got = fwd(to_device(params, dev), dev)
                    torch.cuda.synchronize()
                check(k2.LAUNCHES == {"fwd": launches, "dq": 0, "dkv": 0},
                      f"{name} masked={masked}: K2 launches {k2.LAUNCHES}")
                check(got.is_cuda and got.dtype == (
                    torch.float32 if name == "seq2seq" else dtype),
                      f"{name}: {got.device} {got.dtype}")
                got = got.float().cpu()
                rel = float((got - want).abs().max() / want.abs().max())
                check(bool(torch.isfinite(got).all()) and rel <= frac,
                      f"{name} {dtype} masked={masked}: card - CPU {rel:.3g} "
                      f"of the largest logit (limit {frac})")
                out[(name, str(dtype).split(".")[1], masked)] = rel
    log(15, f"encoder-decoder and classifier, 2 layers of the full widths, "
            f"B {b}, Ts {ts}, Tt {tt}: card against CPU, max |diff| over "
            f"the largest logit: "
            + "; ".join(f"{n} {dt} {'masked' if m else 'unmasked'} {e:.3g}"
                        for (n, dt, m), e in out.items())
            + f" (limits {CLS_F32} f32, {CLS_BF16} bf16); {card}")


def decode_steps(dec, end):
    """(steps the greedy loop ran, (B, T) bool: position t holds a token the
    model chose) from greedy_decode's output."""
    is_end = dec[:, 1:] == end
    ended = is_end.any(1)
    steps = (int(is_end.argmax(1).max()) + 1 if ended.all()
             else dec.shape[1] - 1)
    chosen = np.zeros(dec.shape, bool)
    # a row's position t >= 1 was chosen unless an end came before it
    before = np.concatenate([np.zeros((dec.shape[0], 1), bool),
                             np.cumsum(is_end, 1)[:, :-1] > 0], 1)
    chosen[:, 1:steps + 1] = ~before[:, :steps]
    return steps, chosen


def decode_path(dev, card):
    """Phase 16: greedy_decode, the serving path, at the full widths: B 32
    source rows of 128, max_len 128, bf16. K2a launches once per decoder
    layer per step; the decoded rows are then teacher-forced through the
    same model with plain attention."""
    from ccv_tpu_torch.bin.wmt_grad_trial import synthetic_batch
    from ccv_tpu_torch.bin import iwslt, lm_bench
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.ops.kernels import flash_attention as k2
    cfg = s2s_config()
    params = tfm.init_encoder_decoder(
        torch.Generator(device=dev).manual_seed(5), cfg)
    T, tv = S2S["max_len"], S2S["tgt_vocab_size"]
    src, _, _ = synthetic_batch(np.random.default_rng(29), DECODE_B, T,
                              S2S["vocab_size"], tv)
    src = torch.from_numpy(src).to(dev)
    spad, tpad = S2S["vocab_size"] - 1, tv - 1
    iwslt.greedy_decode(params, cfg, src, spad, tpad, 4)  # warm-up
    torch.cuda.synchronize()
    k2.reset_launches()
    t0 = time.perf_counter()
    dec = iwslt.greedy_decode(params, cfg, src, spad, tpad, T)
    wall = (time.perf_counter() - t0) * 1000
    launches = dict(k2.LAUNCHES)
    steps, chosen = decode_steps(dec, tv - 2)
    check(launches == {"fwd": cfg.layers * steps, "dq": 0, "dkv": 0},
          f"greedy_decode ran {steps} steps and launched K2 {launches}; "
          f"expected {cfg.layers} K2a a step and no K2b or K2c")
    with torch.no_grad(), lm_bench.plain_attention():
        logits = tfm.encoder_decoder_forward(
            params, cfg, src, torch.from_numpy(dec).to(dev),
            src_mask=src != spad)
    check(bool(torch.isfinite(logits).all()),
          "teacher-forced logits not finite")
    rows, ts = np.nonzero(chosen)
    # the logits of the step that chose dec[r, t]
    at = logits[torch.from_numpy(rows).to(dev),
                torch.from_numpy(ts - 1).to(dev)].float().cpu().numpy()
    picked = at[np.arange(len(rows)), dec[rows, ts]]
    gap = (at.max(1) - picked) / np.abs(at).max(1)
    same = float((at.argmax(1) == dec[rows, ts]).mean())
    check(float(gap.max()) <= DECODE_TOL, f"greedy_decode chose a token "
          f"{float(gap.max()):.3g} of the row's largest logit below the "
          f"plain path's best (limit {DECODE_TOL})")
    tokens = len(rows)
    res = dict(steps=steps, tokens=tokens, ms=wall, launches=launches["fwd"],
               ms_per_step=wall / steps, ms_per_token=wall / tokens)
    log(16, f"greedy_decode (iwslt), {s2s_name(cfg)}, B {DECODE_B} x Ts "
            f"{T}, max_len "
            f"{T}, bf16, random weights (seed 5): {steps} steps, {tokens} "
            f"tokens chosen, {wall:.1f} ms a batch = {wall / steps:.3f} ms a "
            f"step = {wall / tokens:.4f} ms a decoded token (host clock, "
            f"one run after a 3-step warm-up); K2 launches {launches} = "
            f"{cfg.layers} K2a a step; teacher-forced through plain "
            f"attention: the chosen token's logit within "
            f"{float(gap.max()):.3g} of the row's best (limit {DECODE_TOL}, "
            f"as a fraction of its largest magnitude), argmax equal at "
            f"{same:.4f} of {tokens} steps; {card}")
    tgt = torch.from_numpy(dec).to(dev)
    src_mask = src != spad

    def one_step(t=T // 2):
        # one pass of greedy_decode's loop at its shapes: the whole model
        # on (B, max_len) source and target rows, the argmax of step t
        with torch.no_grad():
            logits = tfm.encoder_decoder_forward(params, cfg, src, tgt,
                                                 src_mask=src_mask)
            return logits[:, t - 1].argmax(-1)
    return res, one_step


def wmt_step_path(dev, card):
    """Phase 17: the wmt training step at the full widths, B 16 x T 128,
    bf16, with the source mask: at dropout 0.0 (K2a, K2b and K2c in each
    decoder layer's self-attention) and 0.1 (wmt's real mode: attention
    dropout keeps every attention on the plain SDPA). Then the gate: one
    step at dropout 0 with the kernels against one with plain attention
    from the same parameters and batch."""
    from ccv_tpu_torch.bin.wmt_grad_trial import synthetic_batch
    from ccv_tpu_torch.bin import lm_bench, wmt
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.nn import optimizers
    from ccv_tpu_torch.ops.kernels import flash_attention as k2
    T, sv, tv = S2S["max_len"], S2S["vocab_size"], S2S["tgt_vocab_size"]
    batch = tuple(torch.from_numpy(x).to(dev) for x in synthetic_batch(
        np.random.default_rng(31), WMT_B, T, sv, tv))
    spad, tpad = sv - 1, tv - 1
    res, profiled = {}, {}
    for dropout in (0.0, 0.1):
        cfg = s2s_config(dropout=dropout)
        params = tfm.init_encoder_decoder(
            torch.Generator(device=dev).manual_seed(6), cfg)
        n_params = sum(p.numel() for p in optimizers.leaves(params))
        opt = optimizers.adam(rate=1e-4)
        state = opt.init(params)
        key = torch.Generator(device=dev).manual_seed(7)

        def step(params=params, opt=opt, state=state, cfg=cfg, key=key):
            return wmt.train_step(params, opt, state, cfg, batch, spad,
                                  tpad, key)
        losses = [float(step())]
        torch.cuda.synchronize()
        k2.reset_launches()
        t0 = time.perf_counter()
        losses += [step() for _ in range(WMT_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000 / WMT_STEPS
        losses = [float(x) for x in losses]
        n = cfg.layers * WMT_STEPS if dropout == 0.0 else 0
        check(k2.LAUNCHES == {"fwd": n, "dq": n, "dkv": n},
              f"wmt step at dropout {dropout}: K2 launches {k2.LAUNCHES} "
              f"over {WMT_STEPS} steps, expected {n} each")
        check(all(np.isfinite(losses)), f"wmt losses {losses}")
        res[dropout] = dict(ms=ms, tokens_per_s=WMT_B * T / ms * 1000,
                            launches=dict(k2.LAUNCHES), losses=losses)
        profiled[dropout] = step
        log(17, f"wmt step, {s2s_name(cfg)}, "
                f"{n_params / 1e6:.1f} M params, B {WMT_B} x T {T}, bf16, "
                f"source mask, dropout {dropout}: {ms:.2f} ms a step (host "
                f"clock, mean of {WMT_STEPS} after a warm-up), "
                f"{WMT_B * T / ms * 1000:.0f} target tokens/s; K2 launches "
                f"{k2.LAUNCHES} ({n // WMT_STEPS} each a step); losses "
                f"{[round(x, 4) for x in losses]}; {card}")

    gate = wmt_gate(batch, spad, tpad, dev)
    return res, profiled, gate


def wmt_gate_step(batch, spad, tpad, dev, dtype, plain):
    """One wmt step at dropout 0 from the parameters of seed 9, with the
    kernels or with plain attention: (loss, {name: parameter after Adam},
    {name: the step's gradient})."""
    from ccv_tpu_torch.bin import lm_bench, wmt, wmt_grad_trial
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.nn import optimizers
    from ccv_tpu_torch.ops.kernels import flash_attention as k2
    cfg = s2s_config(dtype=dtype)
    params = tfm.init_encoder_decoder(
        torch.Generator(device=dev).manual_seed(9), cfg)
    opt = optimizers.adam(rate=1e-4)
    state = opt.init(params)
    k2.reset_launches()
    with lm_bench.plain_attention(plain):
        loss = float(wmt.train_step(params, opt, state, cfg, batch, spad,
                                    tpad, None))
    n = 0 if plain else cfg.layers
    check(k2.LAUNCHES == {"fwd": n, "dq": n, "dkv": n},
          f"wmt gate step ({dtype}, plain={plain}) launched K2 "
          f"{k2.LAUNCHES}")
    return loss, named_leaves(params), wmt_grad_trial.named_grads(params)


def wmt_gate(batch, spad, tpad, dev):
    """Phase 17's gate: one step at dropout 0 with the kernels against one
    with plain attention, from the same parameters and batch, in float32
    ("tc-f32") and in bf16 ("wgmma-tma", the
    main path's).

    Both: loss within LM_LOSS_REL, parameters after Adam as lm_two_layers
    checks them. Gradients: in float32, every one within LM_GRAD_REL of its
    largest magnitude. In bf16 the plain step is no yardstick for that
    bound at this depth: the decoder's query and key weights' gradients
    cancel the keys' (and queries') common component across a row, as
    bk's does, and both bf16 steps land 0.1-0.15 of their largest magnitude
    from the float32 step there, the plain one included. So the bf16
    kernel step is held to the float32 step: no gradient farther from it
    than LM_GRAD_REL or BF16_GRAD_RATIO times the bf16 plain step's worst
    distance, the larger (``python -m ccv_tpu_torch.bin.wmt_grad_trial``
    measures those distances over several seeds). The key biases bk and
    xbk are left out of every gradient comparison: adding q.bk to every
    score of a row leaves the softmax unchanged, so their true gradient is
    0 and both sides give rounding noise."""
    from ccv_tpu_torch.bin.wmt_grad_trial import grad_dist
    f32 = wmt_gate_step(batch, spad, tpad, dev, torch.float32, True)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        loss_k, p_k, g_k = wmt_gate_step(batch, spad, tpad, dev, dtype,
                                         False)
        loss_p, p_p, g_p = (f32 if dtype == torch.float32 else
                            wmt_gate_step(batch, spad, tpad, dev, dtype,
                                          True))
        name = str(dtype).split(".")[1]
        kp = grad_dist(g_k, g_p)
        worst = max(kp, key=kp.get)
        diffs = torch.cat([(p_k[n].detach() - p_p[n].detach()).abs()
                           .flatten() for n in p_k])
        same = float((diffs <= 1e-6).float().mean())
        msg = (f"wmt step at dropout 0, {name}, kernels against plain "
               f"attention (same parameters and batch): loss {loss_k:.6f} "
               f"/ {loss_p:.6f}; gradients within {kp[worst]:.3g} of their "
               f"largest magnitude (worst {worst}); after Adam {same:.5f} "
               f"of parameters equal, max diff {float(diffs.max()):.3g}")
        check(np.isfinite(loss_k) and abs(loss_k - loss_p)
              <= LM_LOSS_REL * abs(loss_p),
              f"wmt {name} loss {loss_k} with the kernels, {loss_p} plain")
        check(float(diffs.max()) <= 2e-4 and same >= LM_SAME_SIGN,
              f"wmt {name} parameters after Adam: max diff "
              f"{float(diffs.max()):.3g}, {same:.4f} equal")
        if dtype == torch.float32:
            check(kp[worst] <= LM_GRAD_REL, f"wmt float32 gradient {worst} "
                  f"differs by {kp[worst]:.3g} of its largest magnitude")
            log(17, msg)
        else:
            kf, pf = grad_dist(g_k, f32[2]), grad_dist(g_p, f32[2])
            wk, wp = max(kf, key=kf.get), max(pf, key=pf.get)
            bound = max(LM_GRAD_REL, BF16_GRAD_RATIO * pf[wp])
            log(17, msg + f"; against the float32 plain step: kernels "
                    f"{kf[wk]:.3g} (worst {wk}), plain {pf[wp]:.3g} (worst "
                    f"{wp}), bound {bound:.3g}")
            check(kf[wk] <= bound, f"wmt bf16 kernel step: gradient {wk} "
                  f"{kf[wk]:.3g} of its largest magnitude from the float32 "
                  f"step (bound {bound:.3g})")
        out[name] = dict(loss=(loss_k, loss_p), grad=kp[worst],
                         same=same)
    return out


def imdb_path(dev, card):
    """Phase 18: bin/imdb.py's demo on the card at its CLI defaults (2
    layers, d 128, 4 heads of 32, T 64, B 32, bf16; every step masked, so
    plain SDPA), then one unmasked encoder_classifier_forward of the
    trained model through K2 (non-causal, D 32) against plain attention:
    in the demo's bf16 (wgmma-tma) and in float32 (tc-f32, the heads
    zero-padded to 64)."""
    from ccv_tpu_torch.bin import bin_imdb_shared, imdb, lm_bench
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.ops.kernels import flash_attention as k2
    args = imdb.parser().parse_args(IMDB_ARGS)
    res = imdb.train(args)
    check(np.isfinite(res["loss"]) and res["acc"] >= 0.9,
          f"imdb demo: loss {res['loss']}, accuracy {res['acc']}")
    xs, _, _, _ = bin_imdb_shared.load_corpus(args)
    ids = torch.from_numpy(xs[:args.batch].astype(np.int64)).to(dev)
    cfg, params = res["cfg"], res["params"]
    rels, designs = {}, {}
    for dtype, limit in ((torch.bfloat16, CLS_BF16),
                         (torch.float32, CLS_F32)):
        run_cfg = dataclasses.replace(cfg, dtype=dtype)
        with torch.no_grad():
            k2.reset_launches()
            got = tfm.encoder_classifier_forward(params, run_cfg, ids)
            name = str(dtype).split(".")[1]
            designs[name] = {d: n for d, n in k2.DESIGN_LAUNCHES["fwd"].items()
                             if n}
            check(k2.LAUNCHES == {"fwd": cfg.layers, "dq": 0, "dkv": 0}
                  and designs[name] == {k2._design(
                      "fwd", dtype, k2.padded_dim(cfg.head_dim, dtype)):
                      cfg.layers},
                  f"unmasked {name} classifier forward launched K2 "
                  f"{k2.LAUNCHES}, by design {designs[name]}")
            with lm_bench.plain_attention():
                want = tfm.encoder_classifier_forward(params, run_cfg, ids)
        got, want = got.float(), want.float()
        rels[name] = float((got - want).abs().max() / want.abs().max())
        check(bool(torch.isfinite(got).all()) and rels[name] <= limit,
              f"{name} classifier through K2 - plain {rels[name]:.3g} of "
              f"the largest logit (limit {limit})")
    log(18, f"imdb demo on the card (2 layers, d 128, 4 heads, T 64, B 32, "
            f"bf16, dropout 0.1): {res['iters']} steps, "
            f"{res['ms_per_iter']:.2f} ms a step (host clock, first step "
            f"included), final loss {res['loss']:.4f}, accuracy "
            f"{res['acc']:.3f}; unmasked forward through K2 ({cfg.layers} "
            f"launches each, D {cfg.head_dim}: bf16 {designs['bfloat16']}, "
            f"float32 {designs['float32']}) against plain attention: bf16 "
            f"{rels['bfloat16']:.3g} of the largest logit (limit "
            f"{CLS_BF16}), float32 {rels['float32']:.3g} (limit "
            f"{CLS_F32}); {card}")
    return res


def fit_d32_path(k2, dev, card):
    """Phase 18, last: Model.fit of phase 31's graph model with
    ScaledDotProductAttention(16, 32) (SDPA_D32), the 16-bit D 32 kernels'
    main path: one bf16 fit through K2 (K2a, K2b and K2c one wgmma-tma
    launch each, the counts set to 0 just before the fit and read just
    after), held with phase 31's bf16 gate against the plain route and the
    float32 plain fit. Returns K2's launches in the fit, by kernel."""
    B, T, D, heads, hd = SDPA_D32
    kern = fit_gate_run(k2, dev, torch.bfloat16, False, SDPA_D32)
    launches = dict(k2.LAUNCHES)
    designs = {key: {d: c for d, c in cs.items() if c}
               for key, cs in k2.DESIGN_LAUNCHES.items()}
    plain = fit_gate_run(k2, dev, torch.bfloat16, True, SDPA_D32)
    f32 = fit_gate_run(k2, dev, torch.float32, True, SDPA_D32)[1]
    k, wk, p, wp, bound = bf16_fit_gate("D 32", kern, plain, f32)
    log(18, f"Model(LayerNorm, ScaledDotProductAttention({heads}, {hd}, "
            f"causal), Add) B {B} x T {T} x {D}, bf16, one fit: loss "
            f"{kern[0]:.6f} with K2 / {plain[0]:.6f} plain (limit "
            f"{LM_LOSS_REL} relative), gradients from the float32 plain fit: "
            f"K2 {k:.3g} (worst {wk}), plain {p:.3g} (worst {wp}), bound "
            f"{bound:.3g}; K2 launches in the fit {launches}, by design "
            f"{designs}; {card}")
    return launches


def d32_kernel_entries(sources, k2_d32, fit_d32):
    """The ``kernels`` line's entries of K2a/b/c at 16-bit head dim 32 on
    wgmma-tma: launches of phase 18's bf16 fit at heads of 32 (checked
    there), times at K2_D32 in bf16 with float16's beside, the D 64 kernels
    on the same tensors padded to 64, and the exp2 floor."""
    out = []
    for key, (name, line, src, design) in sources.items():
        r = k2_d32["bfloat16"]["timed"][key]
        r16 = k2_d32["float16"]["timed"][key]
        out.append({
            "name": f"{name}_d32", "route": "cuda",
            "source": f"ccv_tpu_torch/csrc/{src}",
            "replaces": f"ccv_tpu/ops/pallas/{line}",
            "launches": fit_d32[key],
            "max_abs_err": max(k2_d32["bfloat16"]["err"][key],
                               k2_d32["float16"]["err"][key]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "design": design,
            "shape": list(K2_D32), "exp_floor_ms": k2_d32["exp_floor_ms"],
            "pad64_ms": k2_d32["bfloat16"]["pad64_ms"][key],
            "f16_ms": r16["ms"], "f16_plain_ms": r16["plain_ms"],
            "f16_bound_ms": r16["bound_ms"],
            "f16_library_ms": r16["library_ms"],
            "f16_pad64_ms": k2_d32["float16"]["pad64_ms"][key],
            **({} if key == "fwd" else {
                "library_note": "one flash backward call: dq, dk and dv"})})
    return out


# device kernels by kind, for the seq2seq profiles: the first pattern a
# kernel's name holds names its kind
KERNEL_KINDS = (("K2", ("sm90_kernel", "_tc_kernel<", "_res_kernel<")),
                ("matmul", ("nvjet", "gemm", "xmma", "cutlass")),
                ("adam", ("multi_tensor_apply",)),
                ("softmax", ("softmax",)),
                ("reduce", ("reduce_kernel",)),
                ("index", ("index", "gather", "scatter", "embedding")),
                ("elementwise", ("elementwise",)))


def by_kind(by_name):
    """{kind: device ms} of a profile's {kernel name: device ms}."""
    out = {}
    for name, ms in by_name.items():
        kind = next((k for k, pats in KERNEL_KINDS
                     if any(p in name for p in pats)), "other")
        out[kind] = out.get(kind, 0.0) + ms
    return out


def seq2seq_profiled(decode_step, decode_ms_step, wmt_steps, card):
    """Phases 16 and 17 under torch.profiler, last: 5 decode steps (one
    pass of greedy_decode's loop each) and 3 wmt steps at each dropout;
    device busy, idle share, device ms by kind of kernel."""
    out = {}
    for name, fn, n in [("decode", decode_step, 5)] + [
            (f"wmt dropout {d}", step, 3) for d, step in wmt_steps.items()]:
        busy, by_name, wall = device_ms(fn, n)
        check(busy > 0, f"the profiler saw no device time in the {name} "
                        f"step")
        kinds = by_kind(by_name)
        extra = (f"; against the unprofiled decode's {decode_ms_step:.3f} ms "
                 f"a step: idle share {1 - busy / decode_ms_step:.3f}"
                 if name == "decode" else "")
        log(16 if name == "decode" else 17,
            f"{name} under torch.profiler ({n} steps): device busy "
            f"{busy:.3f} ms a step over a wall of {wall:.3f} ms (profiler "
            f"overhead included): idle share {1 - busy / wall:.3f}{extra}; "
            f"device ms a step by kind: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                kinds.items(), key=lambda kv: -kv[1]))
            + "; the largest kernels: "
            + "; ".join(f"{key[:50]} {v:.3f}" for key, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:4])
            + f"; {card}")
        out[name] = dict(busy_ms=busy, wall_ms=wall, kinds=kinds)
    return out


# -- phases 19-21: ICF, SWT and SIFT (torch ops, no kernel of the port's) ----

ICF_TREES = 2000  # the trained pedestrian.icf's count (ccv_tpu icf.py:142)
ICF_HELD = (540, 960)  # phases 19 and 41's card-vs-CPU crop
SIFT_FRACTION = 0.97


# profiles left out unless the script runs with --slow-profiles: ICF, BBF
# and TLD have no kernel of their own, and torch.profiler's processing of
# their windows took ~110 s of the script's 1200 s on an H100 host (ICF
# ~50 s an image, TLD's step 36 s, BBF's image 25 s)
SLOW_PROFILES = ("icf_path", "bbf_path", "tld_path")

# references that need nothing from the card run in one spawned child
# process beside the card's phases (spawned: it never touches the card);
# main closes it, so no process outlives the script
CPU_POOL = []
CPU_REFS = {}


def cpu_pool():
    """The CPU child, started on first use."""
    if not CPU_POOL:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        CPU_POOL.append(ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")))
    return CPU_POOL[0]


def close_cpu_pool():
    for pool in CPU_POOL:
        pool.shutdown(cancel_futures=True)
    CPU_POOL.clear()
    CPU_REFS.clear()


def median_ms(fn, reps):
    """(median, all) host ms of ``reps`` synchronised calls after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000)
    return float(np.median(ms)), ms


def short_kernel(name):
    """A readable key for a profiler kernel name: its function and the
    functor it applies."""
    import re
    base = re.sub(r"^void\s+", "", name).split("<")[0].split("(")[0]
    op = re.search(r"(\w*Functor\w*|direct_copy\w*)(<[\w:]+>)?", name)
    return base.split("::")[-1] + (f"[{op.group(1)}{op.group(2) or ''}]"
                                   if op else "")


def top_kernels(by_name, n=4):
    """The n largest device ms per call, by short_kernel (names merged)."""
    merged = {}
    for k, v in by_name.items():
        merged[short_kernel(k)] = merged.get(short_kernel(k), 0.0) + v
    return "; ".join(f"{k} {v:.2f}" for k, v in sorted(
        merged.items(), key=lambda kv: -kv[1])[:n])


def captured(main, argv):
    """(exit code, stdout lines) of a CLI's main(argv)."""
    import contextlib
    import io as _io
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue().strip().splitlines()


def serving(models_dir):
    """A server on the card in a thread: (server, url)."""
    from ccv_tpu_torch.serve import server
    srv = server.Server(("127.0.0.1", 0), models_dir)
    check(srv.device.type == "cuda", f"the server runs on {srv.device}")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def rgb_frame_1080p(read):
    """A 1920x1080 RGB frame: crop180.png (the repository's colour image)
    tiled 6 x 11, cropped."""
    from ccv_tpu_torch.core.io import IO_RGB_COLOR
    crop = read(os.path.join(DATA, "crop180.png"), IO_RGB_COLOR, device="cpu")
    return np.ascontiguousarray(np.tile(crop.numpy(), (6, 11, 1))[:1080,
                                                                   :1920])


def icf_synth(icf, rng, n, gray, w=32, h=80, margin=(3, 2, 4, 2)):
    """n random depth-2 trees over a 32 x 80 window (an effective 25 x 76,
    pedestrian.icf's size), 10 channels (8 gray), thresholds open."""
    nch = 8 if gray else 10
    x0, y0 = rng.integers(0, w - 4, (n, 3, 2)), rng.integers(0, h - 4,
                                                             (n, 3, 2))
    x1 = np.minimum(x0 + rng.integers(1, 12, (n, 3, 2)), w - 1)
    y1 = np.minimum(y0 + rng.integers(1, 24, (n, 3, 2)), h - 1)
    pass_bits = rng.integers(0, 4, n).astype(np.uint32)
    alpha = rng.normal(0, 1, (n, 3, 2)) / ((x1 - x0 + 1) * (y1 - y0 + 1))
    alpha[:, :, 1] *= rng.integers(0, 2, (n, 3))
    # as the file format reads them back: node 1 only with bit 1, node 2
    # only with bit 0, and a node of one box has a second box of zeros
    node = np.stack([np.ones(n, bool), (pass_bits & 2) != 0,
                     (pass_bits & 1) != 0], 1)
    alpha *= node[..., None]
    x0, y0, x1, y1 = (np.where(alpha != 0, v, 0) for v in (x0, y0, x1, y1))
    return icf.IcfCascade(
        width=w, height=h, grayscale=int(gray), margin=margin, n_weak=n,
        pass_bits=pass_bits,
        weigh=rng.normal(0, 1, (n, 2)).astype(np.float32),
        thresholds=np.full(n, -1e9, np.float32),
        channel=np.where(alpha != 0, rng.integers(0, nch, (n, 3, 2)),
                         0).astype(np.int32),
        alpha=alpha.astype(np.float32),
        beta=(rng.normal(0, 0.5, (n, 3)) * node).astype(np.float32),
        sat0=np.stack([x0, y0], -1).astype(np.int32),
        sat1=np.stack([x1, y1], -1).astype(np.int32))


def icf_sums(icf, casc, img, params, every=1, wins=None):
    """(running sums (windows, trees), octave of each window) by the port's
    SAT and trees on img's device: of every ``every``-th window of every
    level of every octave, or of the windows ``wins`` given as (octave,
    level, wy, wx)."""
    from ccv_tpu_torch.ops import resample
    full = icf._tables(casc, img.device)["full"]
    img = img if img.dim() == 3 else img[..., None]
    groups = {}
    for (octave, li, wy, wx) in (wins or []):
        groups.setdefault(octave, []).append((li, wy, wx))
    pyr, out, octs = [img], [], []
    for octave in range(8):
        if octave:
            pyr.append(resample.sample_down(pyr[-1]))
        lvls = icf._octave_levels(pyr[octave].shape, casc, params)
        if not lvls or (wins and octave not in groups):
            continue
        flat, base, W1, C = icf._octave_windows(pyr[octave], casc, lvls,
                                                params.step_through)
        if wins:
            start = np.cumsum([0] + [ny * nx for (*_r, ny, nx) in lvls])
            base = base[torch.tensor([int(start[li]) + wy * lvls[li][5] + wx
                                      for li, wy, wx in groups[octave]],
                                     device=img.device)]
        else:
            base = base[::every]
        octs.append(np.full(base.numel(), octave))
        for s in range(0, base.numel(), 256):
            out.append(torch.cumsum(icf._node_votes(icf._gather(
                flat, base[s:s + 256], full, W1, C), full), 1).cpu())
    return torch.cat(out).numpy(), np.concatenate(octs)


def graded_thresholds(cs, survive):
    """Per-tree thresholds near the running sums' quantiles, each in the
    middle of a gap of the alive windows' sums at least 8 x MARGIN wide,
    so that the alive share falls geometrically to ``survive`` (the share
    alive at the end of phases A, B1 and the cascade); each tree aims at
    what its phase still has to kill (early sums take few values)."""
    n, T = cs.shape
    alive = np.ones(n, bool)
    th = np.full(T, -1e9, np.float32)
    lo = 0
    for hi, frac in survive:
        hi = T if hi is None else hi
        for t in range(lo, hi):
            v = np.sort(cs[alive, t])
            if len(v) < 4 or alive.mean() <= frac:
                continue
            kill = 1 - (frac / alive.mean()) ** (1 / (hi - t))
            u = np.unique(v)
            mids = (u[1:] + u[:-1]) / 2
            wide = (u[1:] - u[:-1]) > 8 * MARGIN * np.maximum(1, np.abs(mids))
            if not wide.any():
                continue
            share = np.searchsorted(v, mids) / len(v)
            i = int(np.argmin(np.where(wide, np.abs(share - kill), np.inf)))
            if share[i] <= max(3 * kill, 0.5):
                th[t] = mids[i]
                alive &= cs[:, t] >= th[t]
        lo = hi
    return th


def icf_windows(comps):
    return {(c.x, c.y, c.width, c.height): c.confidence for c in comps}


def icf_gate(icf, casc, img, a, b, what, atol=ATOL):
    """Two runs' windows (min_neighbors 0, rect -> conf) on the same image:
    windows may differ only where a running sum (the port's SAT and trees,
    on img's device) lies within MARGIN * max(1, |sum|) of its threshold;
    confidences where both pass within ``atol`` (None: not checked).
    Returns (windows in both, differing, max conf diff)."""
    params = icf.IcfParams(min_neighbors=0)
    odd = set(a) ^ set(b)
    if odd:  # where each odd window lies: (octave, level, wy, wx)
        lvl_of = icf_rect_windows(icf, casc, img, params, odd)
        wins = [lvl_of[r] for r in sorted(odd)]
        sums, _ = icf_sums(icf, casc, img, params, wins=wins)
        th = casc.thresholds
        near = (np.abs(sums - th) <= MARGIN * np.maximum(1, np.abs(sums))
                ).any(1)
        check(bool(near.all()), f"{what}: {int((~near).sum())} windows "
                                f"differ outside the margin")
    both = set(a) & set(b)
    check(len(both) > 0, f"{what}: no window passed")
    diff = max(abs(a[r] - b[r]) for r in both)
    check(atol is None or diff <= atol, f"{what}: conf differs by {diff}")
    return len(both), len(odd), diff


def icf_rect_windows(icf, casc, img, params, rects):
    """{rect: (octave, level, wy, wx)}: the window of an image like ``img``
    that each of ``rects`` draws (detect_collect's rect arithmetic)."""
    shape = tuple(img.shape) if img.dim() == 3 else tuple(img.shape) + (1,)
    step = params.step_through
    eff_w = casc.width - casc.margin[0] - casc.margin[2]
    eff_h = casc.height - casc.margin[1] - casc.margin[3]
    by_size = {}
    for r in rects:
        by_size.setdefault((r[2], r[3]), []).append(r)
    out = {}
    for octave in range(8):
        for li, (_k, sc, _r, _c, ny, nx) in enumerate(
                icf._octave_levels(shape, casc, params)):
            s = sc * (1 << octave)
            for r in by_size.get((int(eff_w * s), int(eff_h * s)), ()):
                xs = ((np.arange(nx) * step + 0.5) * s - 0.5).astype(np.int64)
                ys = ((np.arange(ny) * step + 0.5) * s - 0.5).astype(np.int64)
                wx, wy = np.flatnonzero(xs == r[0]), np.flatnonzero(ys == r[1])
                if len(wx) and len(wy):
                    out[r] = (octave, li, int(wy[0]), int(wx[0]))
        shape = (shape[0] // 2, shape[1] // 2) + shape[2:]
    return out


def icf_corners(icf, casc, img, params, wins):
    """(n, trees * 24) SAT corner values (the port's SAT, on img's device)
    of the windows ``wins`` ((octave, level, wy, wx)), in that order."""
    from ccv_tpu_torch.ops import resample
    full = icf._tables(casc, img.device)["full"]
    img = img if img.dim() == 3 else img[..., None]
    out = [None] * len(wins)
    src = img
    for octave in range(max(w[0] for w in wins) + 1):
        if octave:
            src = resample.sample_down(src)
        mine = [i for i, w in enumerate(wins) if w[0] == octave]
        if not mine:
            continue
        lvls = icf._octave_levels(src.shape, casc, params)
        flat, base, W1, C = icf._octave_windows(src, casc, lvls,
                                                params.step_through)
        start = np.cumsum([0] + [ny * nx for (*_r, ny, nx) in lvls])
        sel = torch.tensor([int(start[wins[i][1]]) + wins[i][2]
                            * lvls[wins[i][1]][5] + wins[i][3] for i in mine],
                           device=img.device)
        g = icf._gather(flat, base[sel], full, W1, C)
        for k, i in enumerate(mine):
            out[i] = g[k]
    return torch.stack(out)


def icf_matmul_gate(icf, casc, img, got, base):
    """Phase 42's gate of ICF's matmul form against its staged form on the
    same image: windows found by one only, or whose confidences differ by
    more than ATOL, are each recomputed here from their SAT corners in two
    ways, node values by the staged form's float32 corner arithmetic and
    by exact (float64) box sums rounded once, as the matmul form's float64
    products give them. Each side must be its way's result (its windows and
    confidences, outside the margin), and every node the two ways put on
    opposite sides of 0 must lie within float32 rounding of its corners
    (4 ulps of their summed magnitude). Returns (windows recomputed, nodes
    flipped)."""
    params = icf.IcfParams(min_neighbors=0)
    rects = sorted((set(got) ^ set(base)) | {
        r for r in set(got) & set(base) if abs(got[r] - base[r]) > ATOL})
    if not rects:
        return 0, 0
    where = icf_rect_windows(icf, casc, img, params, rects)
    g = icf_corners(icf, casc, img, params, [where[r] for r in rects])
    full = icf._tables(casc, img.device)["full"]
    n = len(rects)
    q = g.reshape(n, -1, 4)
    box = ((q[..., 0] - q[..., 1]) - q[..., 2]) + q[..., 3]
    f32 = (box * full["alpha"]).reshape(n, -1, 3, 2).sum(-1) + full["beta"]
    q64 = q.double()
    box64 = ((q64[..., 0] - q64[..., 1]) - q64[..., 2]) + q64[..., 3]
    f64 = ((box64 * full["alpha"].double()).reshape(n, -1, 3, 2).sum(-1)
           .float() + full["beta"])
    bound = 2.0 ** -22 * ((q.abs().sum(-1) * full["alpha"].abs())
                          .reshape(n, -1, 3, 2).sum(-1) + f32.abs())
    flip = (f32 > 0) != (f64 > 0)
    check(bool(((f32 - f64).abs() <= bound)[flip].all()),
          "ICF matmul: a node changes sign beyond float32 rounding")
    th = torch.as_tensor(casc.thresholds, device=img.device)
    for name, fval, mine in (("staged", f32, base), ("matmul", f64, got)):
        cs = torch.cumsum(icf._decide(fval, full), 1)
        passed = (cs >= th).all(1).tolist()
        near = ((cs - th).abs() <= MARGIN * torch.clamp(cs.abs(), min=1)
                ).any(1).tolist()
        last = cs[:, -1].tolist()
        for i, r in enumerate(rects):
            check(near[i] or ((r in mine) == passed[i]), f"ICF {name}: "
                  f"window {r} {'found' if r in mine else 'not found'} "
                  f"against its recomputed running sums")
            check(r not in mine or not passed[i]
                  or abs(mine[r] - last[i]) <= ATOL,
                  f"ICF {name}: window {r} conf {mine.get(r)} against "
                  f"{last[i]} recomputed")
    return n, int(flip.sum())


def icf_card_vs_cpu(icf, casc, img_cpu, dev, name):
    """Phase 19's gate: the card's windows (min_neighbors 0) against the
    port's CPU path on the same image. Windows may differ only where a
    running sum lies within MARGIN * max(1, |sum|) of its threshold;
    confidences where both pass within ATOL. Returns (windows, differing,
    max conf diff, cpu s)."""
    params = icf.IcfParams(min_neighbors=0)
    card = icf_windows(icf.detect_objects(img_cpu.to(dev), casc, params))
    t0 = time.perf_counter()
    cpu = icf_windows(icf.detect_objects(img_cpu, casc, params))
    cpu_s = time.perf_counter() - t0
    n, odd, diff = icf_gate(icf, casc, img_cpu, card, cpu,
                            f"ICF {name}: card vs CPU")
    return n, odd, diff, cpu_s


def icf_path(dev, card, read):
    """Phase 19, ICF at 1080p: a seeded synthetic cascade of 2,000 trees
    (10 channels) on an RGB frame tiled from crop180.png and a gray one (8
    channels) on frame_1080p, both written with write_cascade and read back,
    thresholds near the running sums' quantiles so that windows end in
    phases A, B1 and B2; card against the port's CPU path; ms per image at
    default IcfParams (thresholds from every 29th window of every level);
    bin/icfdetect and /icf/detect.objects on the card (the gray cascade:
    it finds objects at default params).
    Returns the profile to run last."""
    from ccv_tpu_torch.bin import icfdetect
    from ccv_tpu_torch.detectors import icf
    from ccv_tpu_torch.serve import server
    rgb = torch.from_numpy(rgb_frame_1080p(read))
    gray = torch.from_numpy(frame_1080p(read))
    tmp = tempfile.mkdtemp(prefix="ccv_icf_")
    srv = None
    out = {}
    try:
        rng = np.random.default_rng(19)
        params = icf.IcfParams()
        cascades = {}
        for name, img, is_gray in (("colour", rgb, False),
                                   ("gray", gray, True)):
            casc = icf_synth(icf, rng, ICF_TREES, is_gray)
            t0 = time.perf_counter()
            cs, octs = icf_sums(icf, casc, img.to(dev), params, every=29)
            # survivors after A and B1 as ccv_tpu's pedestrian.png run saw
            # them, halved until every octave's sample keeps under half of
            # K1's and K2's shares (1/5 and 1/32): no overflow rerun
            survive = np.array([0.064, 0.002, 0.0001])
            for _ in range(6):
                casc.thresholds[:] = graded_thresholds(
                    cs, tuple(zip((64, 320, None), survive)))
                alive = np.minimum.accumulate(cs >= casc.thresholds, axis=1)
                worst = [max(alive[octs == o, t].mean() for o in set(octs))
                         for t in (63, 319)]
                if worst[0] <= 0.1 and worst[1] <= 0.5 / 32:
                    break
                survive /= 2
            th_s = time.perf_counter() - t0
            path = os.path.join(tmp, f"{name}.icf")
            icf.write_cascade(casc, path)
            back = icf.load_cascade(path)
            for f in ("pass_bits", "weigh", "thresholds", "channel", "alpha",
                      "beta", "sat0", "sat1"):
                check(np.array_equal(getattr(back, f), getattr(casc, f)),
                      f"ICF {name}: {f} changed in write_cascade/load")
            ends = [int(len(cs) - alive[:, 63].sum()),
                    int(alive[:, 63].sum() - alive[:, 319].sum()),
                    int(alive[:, 319].sum() - alive[:, -1].sum()),
                    int(alive[:, -1].sum())]
            check(min(ends) > 0, f"ICF {name}: sampled windows ending in A, "
                                 f"B1, B2 and passing: {ends}")
            cascades[name] = (back, img, path)
            # each cascade is held card = CPU on the frame's top-left
            # quarter (depth cut: the CPU port's pass over a 1080p frame
            # takes 36-57 s in colour; gray in PR 18, colour in PR 19)
            held = img[:ICF_HELD[0], :ICF_HELD[1]]
            n, odd, diff, cpu_s = icf_card_vs_cpu(icf, back, held, dev, name)
            img_d = img.to(dev)
            before = icf.RERUNS
            med, ms = median_ms(lambda: icf.detect_objects(img_d, back), 3)
            reruns = icf.RERUNS - before
            found = icf.detect_objects(img_d, back)
            out[name] = dict(ms=med, found=len(found), windows=n,
                             cascade=back, image=img)
            log(19, f"ICF {name} {tuple(img.shape)}, {ICF_TREES} trees "
                    f"(thresholds from {len(cs)} sampled windows in "
                    f"{th_s:.1f} s: they end in A / B1 / B2 / pass {ends}; "
                    f"the most alive octave keeps {worst[0]:.4f} after A, "
                    f"{worst[1]:.5f} after B1); "
                    f"write_cascade + load_cascade round trip equal; "
                    f"min_neighbors 0 on {tuple(held.shape[:2])}: card = CPU "
                    f"on {n} windows ({odd} "
                    f"differ, all in the margin), max conf diff {diff:.3g} "
                    f"(CPU path {cpu_s:.1f} s); default IcfParams: "
                    f"{len(found)} detections, median {med:.2f} ms/image "
                    f"({', '.join(f'{x:.2f}' for x in ms)}; {reruns} "
                    f"overflow reruns in {len(ms) + 1} calls); {card}")
        # the CLI and the server read the PNG as RGB; the gray cascade
        # takes its gray conversion, which gives back the gray frame
        casc, img, path = cascades["gray"]
        png = os.path.join(tmp, "frame.png")
        with open(png, "wb") as f:
            f.write(png_bytes(img.numpy()))
        want = icf.detect_objects(img.to(dev), casc)
        check(len(want) > 0, "ICF gray: no detection at default params")
        code, lines = captured(icfdetect.main, [png, path])
        check(code == 0 and lines[:-1] == [
            f"{int(c.x)} {int(c.y)} {int(c.width)} {int(c.height)} "
            f"{c.confidence:f}" for c in want]
            and lines[-1].startswith(f"total : {len(want)} in time "),
            f"bin/icfdetect printed {lines[-1:]} for {len(want)} rects")
        models = os.path.join(tmp, "models")
        os.makedirs(models)
        srv, url = serving(models)
        with open(png, "rb") as f:
            body = f.read()
        code, missing = http(url + "/icf/detect.objects", body)
        check(code == 500 and "pedestrian.icf" in missing["error"],
              f"/icf without pedestrian.icf: {code} {missing}")
        shutil.copy(path, os.path.join(models, "pedestrian.icf"))
        code, got = http(url + "/icf/detect.objects", body)
        check(code == 200 and got == server._rects(want),
              f"/icf: {code}, {len(got)} rects against {len(want)}")
        log(19, f"bin/icfdetect on the card, the gray cascade on the "
                f"gray frame's PNG: {len(want)} lines = direct detect_objects"
                f" ({lines[-1]}); /icf/detect.objects: 500 naming "
                f"pedestrian.icf before it is there, then the same PNG = "
                f"direct detect_objects ({len(got)} rects); {card}")
        # the colour cascade alone under the profiler (depth cut: the
        # profiler's processing of one 1080p ICF image takes ~40 s on an
        # H100 host; the gray one read busy 342.97 ms, idle share 0.796,
        # beside the colour one's 346.42 ms, 0.807)
        on_card = {name: (c, im.to(dev)) for name, (c, im, _p) in
                   cascades.items() if name == "colour"}

        def profile():
            for name, (c, im) in on_card.items():
                busy, by_name, wall = device_ms(
                    lambda: icf.detect_objects(im, c), 1)
                log(19, f"ICF {name} 1080p under torch.profiler (1 image): "
                        f"device busy {busy:.2f} ms per image over a wall of "
                        f"{wall:.2f} ms: idle share {1 - busy / wall:.3f}; "
                        f"largest: {top_kernels(by_name)}; {card}")
        return out, profile
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)


def iou(a, b):
    ix = max(0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union else 0.0


def word_rects(words):
    return [(int(w.x), int(w.y), int(w.width), int(w.height)) for w in words]


def swt_path(dev, card, read):
    """Phase 20, SWT: text_test.png on the card (its stroke maps and words
    equal the CPU's, the words the C golden's by tests/test_swt.py's rule),
    the 1080p frame in gray (words equal the CPU's, ms per image, the stage
    breakdown), bin/swtdetect and /swt/detect.words on the card. Returns
    the profile to run last."""
    from ccv_tpu_torch.bin import swtdetect
    from ccv_tpu_torch.detectors import swt
    from ccv_tpu_torch.serve import server
    tt_path = os.path.join(DATA, "text_test.png")
    from ccv_tpu_torch.core.io import IO_GRAY
    tt = read(tt_path, IO_GRAY, device="cpu").tensor
    maps = []
    for d in ("cpu", dev):
        c, dx, dy, g = swt._frontend(tt.to(d), 3, 124, 204)
        maps.append((c.cpu(), dx.cpu(), dy.cpu(), swt._rays(c, dx, dy).cpu()))
    for name, a, b in zip(("edges", "dx", "dy", "stroke maps"), *maps):
        check(torch.equal(a, b), f"SWT text_test.png {name}: card != CPU")
    words = word_rects(swt.detect_words(tt.to(dev)))
    check(words == word_rects(swt.detect_words(tt)),
          f"SWT text_test.png words card {words} != CPU")
    with open(os.path.join(DATA, "text_test.swt.txt")) as f:
        ref = [tuple(int(v) for v in line.split()) for line in f]
    check(len(words) == len(ref) and all(
        max(iou(r, m) for m in words) >= 0.7 for r in ref),
        f"SWT text_test.png {words} against the golden {ref}")
    tt_d = tt.to(dev)
    tt_ms, _ = median_ms(lambda: swt.detect_words(tt_d), 10)
    frame = torch.from_numpy(frame_1080p(read))
    frame_d = frame.to(dev)
    t0 = time.perf_counter()
    cpu_words = word_rects(swt.detect_words(frame))
    cpu_s = time.perf_counter() - t0
    card_words = word_rects(swt.detect_words(frame_d))
    check(card_words == cpu_words and len(card_words) > 0,
          f"SWT 1080p: card {len(card_words)} words, CPU {len(cpu_words)}")
    med, ms = median_ms(lambda: swt.detect_words(frame_d), 5)
    timings = {}
    swt.detect_words(frame_d, timings=timings)
    strokes = int((maps[1][3] > 0).sum())
    log(20, f"SWT text_test.png (640x480) on the card: edges, sobels and "
            f"both stroke maps ({strokes} stroke cells) = CPU bit for bit; "
            f"words {words} = CPU, against text_test.swt.txt {ref} at IoU "
            f">= 0.7; median {tt_ms:.2f} ms/image (n=10); 1080p gray: "
            f"{len(card_words)} words = CPU ({cpu_s:.1f} s on the CPU), "
            f"median {med:.2f} ms/image ({', '.join(f'{x:.2f}' for x in ms)})"
            f"; one 1080p call by stage (each ends in a synchronize): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in timings.items())
            + f"; {card}")
    code, lines = captured(swtdetect.main, [tt_path])
    check(code == 0 and lines[:-1] == [" ".join(map(str, w)) for w in words]
          and lines[-1].startswith(f"total : {len(words)} in time "),
          f"bin/swtdetect printed {lines}")
    tmp = tempfile.mkdtemp(prefix="ccv_swt_")
    srv = None
    try:
        srv, url = serving(tmp)
        with open(tt_path, "rb") as f:
            code, got = http(url + "/swt/detect.words", f.read())
        check(code == 200 and got == server._rects(swt.detect_words(tt_d)),
              f"/swt/detect.words: {code} {got}")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(20, f"bin/swtdetect on the card: {lines}; /swt/detect.words on "
            f"text_test.png = direct detect_words; {card}")

    def profile():
        for name, img in (("text_test.png", tt_d), ("1080p", frame_d)):
            busy, by_name, wall = device_ms(
                lambda: swt.detect_words(img), 3)
            log(20, f"SWT {name} under torch.profiler (3 images): device "
                    f"busy {busy:.2f} ms per image over a wall of {wall:.2f}"
                    f" ms: idle share {1 - busy / wall:.3f}; largest: "
                    f"{top_kernels(by_name)}; {card}")
    return dict(ms=med, text_ms=tt_ms, words=len(card_words)), profile


def sift_pairs(ka, kb):
    """(i, j) of ka's keypoints with a kb keypoint within 0.5 px, 5% of the
    scale and 0.05 rad of the angle (a keypoint appears once per
    orientation peak), the nearest such."""
    if not ka or not kb:
        return []
    B = np.array([[k["x"], k["y"], k["scale"], k["angle"]] for k in kb])
    out = []
    for i, k in enumerate(ka):
        da = np.abs((B[:, 3] - k["angle"] + np.pi) % (2 * np.pi) - np.pi)
        ok = ((np.abs(B[:, 0] - k["x"]) <= 0.5)
              & (np.abs(B[:, 1] - k["y"]) <= 0.5)
              & (np.abs(B[:, 2] - k["scale"]) <= 0.05 * k["scale"])
              & (da <= 0.05))
        if ok.any():
            d = np.hypot(B[:, 0] - k["x"], B[:, 1] - k["y"]) + da
            out.append((i, int(np.argmin(np.where(ok, d, np.inf)))))
    return out


def sift_path(dev, card, read):
    """Phase 21, bin/siftmatch at default SiftParams: the 1080p frame in
    gray as the scene, a 480x360 crop of it as the object; card against
    the port's CPU path (>= 97% of keypoints within 0.5 px, 5% of scale and
    0.05 rad, both ways; matched descriptors within 1e-3, unit norm), match_pair
    against sift + match, ms per pair, bin/siftmatch and /sift on the card.
    Returns the profile to run last."""
    from ccv_tpu_torch.bin import siftmatch
    from ccv_tpu_torch.detectors import sift
    scene = torch.from_numpy(frame_1080p(read))
    obj = scene[360:720, 720:1200].contiguous()
    t0 = time.perf_counter()
    cpu = sift.sift_many([obj, scene], device="cpu")
    cpu_s = time.perf_counter() - t0
    card_res = sift.sift_many([obj, scene], device=dev)
    notes = []
    for name, (kc, dc), (kg, dg) in zip(("object", "scene"), cpu, card_res):
        fwd, back = sift_pairs(kc, kg), sift_pairs(kg, kc)
        check(len(fwd) >= SIFT_FRACTION * len(kc) and
              len(back) >= SIFT_FRACTION * len(kg) and len(kc) > 20,
              f"SIFT {name}: {len(fwd)} of {len(kc)} CPU keypoints and "
              f"{len(back)} of {len(kg)} card keypoints matched")
        i, j = np.array(fwd).T
        err = float(np.abs(dg[j] - dc[i]).max())
        check(err <= 1e-3, f"SIFT {name}: descriptors differ by {err}")
        notes.append(f"{name} {len(kg)} keypoints (CPU {len(kc)}; "
                     f"{len(fwd) / len(kc):.4f} / {len(back) / len(kg):.4f} "
                     f"matched both ways, descriptors within {err:.2g})")
    obj_d, scene_d = obj.to(dev), scene.to(dev)
    k1, k2, pairs = sift.match_pair(obj_d, scene_d)
    (kg1, dg1), (kg2, dg2) = card_res
    idx, ok = sift.match(dg1, dg2, device=dev)
    want = [(i, int(j)) for i, (j, m) in enumerate(zip(idx, ok)) if m]
    check(k1 == kg1 and k2 == kg2 and pairs == want and len(pairs) > 20,
          f"SIFT match_pair {len(pairs)} pairs against sift + match "
          f"{len(want)}")
    idx_c, ok_c = sift.match(cpu[0][1], cpu[1][1], device="cpu")
    med, ms = median_ms(lambda: sift.match_pair(obj_d, scene_d), 5)
    scene_ms, _ = median_ms(lambda: sift.sift(scene_d), 3)
    log(21, f"SIFT siftmatch, object 480x360 in the 1080p scene: "
            + "; ".join(notes) + f"; card = CPU by the gate (CPU path "
            f"{cpu_s:.1f} s); {len(pairs)} of {len(k1)} object keypoints "
            f"matched on the card ({int(ok_c.sum())} on the CPU), "
            f"match_pair = sift + match; match_pair median {med:.2f} ms per "
            f"pair ({', '.join(f'{x:.2f}' for x in ms)}), sift of the scene "
            f"alone {scene_ms:.2f} ms; {card}")
    tmp = tempfile.mkdtemp(prefix="ccv_sift_")
    srv = None
    try:
        paths = [os.path.join(tmp, f"{n}.png") for n in ("object", "scene")]
        for p, img in zip(paths, (obj, scene)):
            with open(p, "wb") as f:
                f.write(png_bytes(img.numpy()))
        code, lines = captured(siftmatch.main, paths)
        check(code == 0 and lines[-2] ==
              f"{len(pairs)} keypoints out of {len(k1)} are matched"
              and len(lines) == len(pairs) + 2,
              f"bin/siftmatch printed {lines[-2:]}")
        srv, url = serving(tmp)
        with open(paths[0], "rb") as f:
            code, got = http(url + "/sift", f.read())
        kps, _ = sift.sift(obj_d, want_desc=False)
        check(code == 200 and got == [
            {k: float(kp[k]) for k in ("x", "y", "scale", "angle")}
            for kp in kps], f"/sift: {code}, {len(got)} keypoints against "
                            f"{len(kps)}")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(21, f"bin/siftmatch on the card: {lines[-2]}; /sift on the object "
            f"PNG = direct sift ({len(got)} keypoints); {card}")

    def profile():
        busy, by_name, wall = device_ms(
            lambda: sift.match_pair(obj_d, scene_d), 2)
        log(21, f"SIFT match_pair under torch.profiler (2 pairs): device "
                f"busy {busy:.2f} ms per pair over a wall of {wall:.2f} ms: "
                f"idle share {1 - busy / wall:.3f}; largest: "
                f"{top_kernels(by_name)}; {card}")
    return dict(ms=med, scene_ms=scene_ms, pairs=len(pairs)), profile


# -- phases 22-26: BBF, DPM, MSER / MSCR, DAISY, TLD ------------------------

BBF_STAGES = 16
BBF_FEATURES = (20, 41)   # features per stage, drawn from [20, 40]
BBF_PASS = 600            # 1080p windows the graded thresholds let through
BBF_CROP = (270, 480)     # the card-against-CPU crop of the 1080p frame
DPM_ROOT = (12, 5)        # root filter cells (rows, cols), parts 6 x 6
DPM_PARTS = 8
DPM_PASS = 150            # 1080p windows (default params) above 0.6
DAISY_CROP = 256
DAISY_AT = (120, 200)
TLD_BOX = (820, 420, 180, 180)
# 3 frames, the CPU path on 2, bin/tld on 2 (depth cut from 8 and 3 when
# phases 33-36 were added, to 4 frames with phase 43, and to 3 when phase
# 43 grew, to keep the script inside its time limit on slower hosts)
TLD_SHIFTS = [(0, 0), (6, 4), (12, 8)]
TLD_CPU_FRAMES = 2        # frames of the CPU path held against the card's
                          # (its host loops take ~15-20 s a 1080p frame)


def multipart(fields):
    """(body, headers) of a multipart form: bytes are file parts."""
    boundary = "smokeboundary26"
    out = []
    for name, val in fields.items():
        out.append(f"--{boundary}\r\n".encode())
        if isinstance(val, bytes):
            out.append(f'Content-Disposition: form-data; name="{name}"; '
                       f'filename="{name}.png"\r\n\r\n'.encode() + val
                       + b"\r\n")
        else:
            out.append(f'Content-Disposition: form-data; name="{name}"'
                       f"\r\n\r\n{val}\r\n".encode())
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), {
        "Content-Type": f"multipart/form-data; boundary={boundary}"}


def bbf_synth(bbf, rng):
    """A 24x24 cascade of BBF_STAGES stages of random features (1-3 point
    pairs over the full, half and quarter levels), thresholds open."""
    cols = {k: [] for k in ("px", "py", "pz", "nx", "ny", "nz")}
    stage_of, alphas = [], []
    for s in range(BBF_STAGES):
        for _ in range(int(rng.integers(*BBF_FEATURES))):
            size = int(rng.integers(1, 4))
            for sign in "pn":
                z = rng.integers(0, 3, 8)
                side = np.array([24, 12, 6])[z]
                x = rng.integers(0, 24, 8) % side
                y = rng.integers(0, 24, 8) % side
                x[size:], y[size:], z[size:] = -1, 0, -1
                for k, v in zip("xyz", (x, y, z)):
                    cols[sign + k].append(v)
            alphas.append(rng.normal(0, 1, 2))
            stage_of.append(s)
    return bbf.BbfCascade(
        24, 24, np.array(stage_of, np.int32), BBF_STAGES,
        np.full(BBF_STAGES, -1e9, np.float32), np.array(alphas, np.float32),
        **{k: np.array(v, np.int32) for k, v in cols.items()})


def bbf_graded(sums, survive):
    """Per-stage thresholds, each in the middle of a gap of the alive
    windows' sums wider than 8 x MARGIN, near the quantile that keeps
    ``survive`` ** (1 / stages) of them: windows end at every stage."""
    keep = survive ** (1 / sums.shape[1])
    alive = np.ones(len(sums), bool)
    th = np.zeros(sums.shape[1], np.float32)
    for s in range(sums.shape[1]):
        u = np.unique(sums[alive, s])
        mids = (u[1:] + u[:-1]) / 2
        wide = (u[1:] - u[:-1]) > 8 * MARGIN * np.maximum(1, np.abs(mids))
        kill = np.searchsorted(np.sort(sums[alive, s]), mids) / alive.sum()
        i = int(np.argmin(np.where(wide, np.abs(kill - (1 - keep)), np.inf)))
        th[s] = mids[i]
        alive &= sums[:, s] >= th[s]
    return th


def rect_conf(comps):
    return {(int(c.x), int(c.y), int(c.width), int(c.height)): c.confidence
            for c in comps}


def bbf_path(dev, card, read):
    """Phase 22, BBF: a seeded 24x24 cascade (BBF_STAGES stages) written
    with write_cascade and read back, thresholds graded on the 1080p gray
    frame's stage sums; the card's windows (min_neighbors 0) against the
    port's CPU path on a crop, equal outside MARGIN, grouped rects equal;
    ms per 1080p image at default BbfParams (accurate, interval 5);
    bin/bbfdetect and /bbf/detect.objects. Returns the profile."""
    from ccv_tpu_torch.bin import bbfdetect
    from ccv_tpu_torch.detectors import bbf
    from ccv_tpu_torch.serve import server
    gray = torch.from_numpy(frame_1080p(read))
    g_d = gray.to(dev)
    casc = bbf_synth(bbf, np.random.default_rng(22))
    params = bbf.BbfParams()
    t0 = time.perf_counter()
    _, sums = bbf.window_sums(g_d, casc, params)
    casc.thresholds[:] = bbf_graded(sums, BBF_PASS / len(sums))
    alive = np.minimum.accumulate(sums >= casc.thresholds, axis=1)
    ends = np.diff(np.concatenate([[len(sums)], alive.sum(0)]))
    check(bool((ends < 0).all()), f"BBF: windows end at stages {-ends}")
    th_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="ccv_bbf_")
    srv = None
    try:
        face = os.path.join(tmp, "face")
        bbf.write_cascade(casc, face)
        back = bbf.load_cascade(face)
        for f in ("stage_of", "thresholds", "alphas", "px", "py", "pz",
                  "nx", "ny", "nz"):
            check(np.array_equal(getattr(back, f), getattr(casc, f)),
                  f"BBF: {f} changed in write_cascade/load_cascade")
        # the crop of the frame (origin on the 8-pixel grid, so its level 0
        # and half and quarter planes are the frame's) that holds the most
        # of the frame's passing windows
        raw = bbf.BbfParams(min_neighbors=0)
        h, w = BBF_CROP
        corners = np.array([(c.y, c.x) for c in bbf.detect_objects(
            g_d, back, raw) if c.width == back.width]).reshape(-1, 2)
        oy, ox = max(((y, x) for y in range(0, gray.shape[0] - h + 1, 8)
                      for x in range(0, gray.shape[1] - w + 1, 8)),
                     key=lambda o: int(((corners >= o) & (corners < (
                         o[0] + h - 24, o[1] + w - 24))).all(1).sum()))
        crop = gray[oy:oy + h, ox:ox + w].contiguous()
        card_raw = bbf.detect_objects(crop.to(dev), back, raw)
        t0 = time.perf_counter()
        cpu_raw = bbf.detect_objects(crop, back, raw)
        cpu_s = time.perf_counter() - t0
        got, want = rect_conf(card_raw), rect_conf(cpu_raw)
        odd = set(got) ^ set(want)
        if odd:
            rects, csums = bbf.window_sums(crop, back, raw)
            near = (np.abs(csums - back.thresholds)
                    <= MARGIN * np.maximum(1, np.abs(csums))).any(1)
            at = {tuple(int(v) for v in r): n for r, n in zip(rects, near)}
            check(all(at[r] for r in odd), f"BBF crop: {len(odd)} windows "
                  f"differ card vs CPU, not all in the margin")
        both = set(got) & set(want)
        check(len(both) >= 10, f"BBF crop: {len(both)} windows passed")
        diff = max(abs(got[r] - want[r]) for r in both)
        check(diff <= ATOL, f"BBF crop: confidences differ by {diff}")
        grouped_card = bbf.detect_objects(crop.to(dev), back)
        grouped_cpu = bbf._group(cpu_raw, params.min_neighbors, 0)
        check([(c.x, c.y, c.width, c.height, c.neighbors)
               for c in grouped_card] ==
              [(c.x, c.y, c.width, c.height, c.neighbors)
               for c in grouped_cpu] and len(grouped_cpu) > 0,
              f"BBF crop: grouped rects differ ({len(grouped_card)} on the "
              f"card, {len(grouped_cpu)} on the CPU)")
        med, ms = median_ms(lambda: bbf.detect_objects(g_d, back), 3)
        found = bbf.detect_objects(g_d, back)
        n_raw = len(bbf.detect_objects(g_d, back, raw))
        log(22, f"BBF 1080p gray, {BBF_STAGES} stages, "
                f"{len(back.stage_of)} features (thresholds graded on "
                f"{len(sums)} windows' stage sums in {th_s:.1f} s; they end "
                f"at each stage {(-ends).tolist()}, {int(alive[:, -1].sum())}"
                f" pass); write_cascade + load_cascade equal; crop "
                f"{w}x{h} at ({ox}, {oy}): card = CPU on {len(both)} "
                f"windows ({len(odd)} differ, in the margin), conf diff "
                f"{diff:.3g}, grouped {len(grouped_card)} rects equal (CPU path {cpu_s:.1f} s); "
                f"default BbfParams at 1080p: {n_raw} windows, {len(found)} "
                f"grouped, median {med:.2f} ms/image "
                f"({', '.join(f'{x:.2f}' for x in ms)}); {card}")
        png = os.path.join(tmp, "frame.png")
        with open(png, "wb") as f:
            f.write(png_bytes(gray.numpy()))
        code, lines = captured(bbfdetect.main, [png, face])
        check(code == 0 and lines[:-1] == [
            f"{int(c.x)} {int(c.y)} {int(c.width)} {int(c.height)} "
            f"{c.confidence:f}" for c in found]
            and lines[-1].startswith(f"total : {len(found)} in time "),
            f"bin/bbfdetect printed {lines[-1:]} for {len(found)} rects")
        srv, url = serving(tmp)
        with open(png, "rb") as f:
            code, out = http(url + "/bbf/detect.objects", f.read())
        check(code == 200 and out == server._rects(found),
              f"/bbf: {code}, {len(out)} rects against {len(found)}")
        log(22, f"bin/bbfdetect on the card: {lines[-1]}; "
                f"/bbf/detect.objects on the 1080p PNG = direct "
                f"detect_objects ({len(out)} rects); {card}")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)

    def profile():
        busy, by_name, wall = device_ms(lambda: bbf.detect_objects(g_d, back),
                                        1)
        log(22, f"BBF 1080p under torch.profiler (1 image): device busy "
                f"{busy:.2f} ms per image over a wall of {wall:.2f} ms: idle "
                f"share {1 - busy / wall:.3f}; largest: "
                f"{top_kernels(by_name)}; {card}")
    return dict(ms=med, found=len(found)), profile


def dpm_synth(dpm, rng):
    """DPM_PARTS 6x6 parts on each of two DPM_ROOT roots (the second the
    first's mirror-sized twin), random filters, convex deformations."""
    rows, cols = DPM_ROOT
    roots = []
    for _ in range(2):
        parts = [dpm.DpmPartClassifier(
            int(rng.integers(0, 2 * cols - 5)),
            int(rng.integers(0, 2 * rows - 5)), 0,
            float(rng.normal(0, 0.01)), float(rng.normal(0, 0.01)),
            float(rng.uniform(0.02, 0.1)), float(rng.uniform(0.02, 0.1)),
            rng.normal(0, 0.02, 6).astype(np.float32),
            rng.normal(0, 0.03, (6, 6, 31)).astype(np.float32), 0)
            for _ in range(DPM_PARTS)]
        roots.append(dpm.DpmRootClassifier(
            0.0, rng.normal(0, 0.02, 3).astype(np.float32),
            rng.normal(0, 0.03, (rows, cols, 31)).astype(np.float32),
            parts))
    return dpm.DpmMixtureModel(roots)


def dpm_scores(dpm, a, model, params):
    """Every valid window's root score (before beta), per root, by the
    port's level programs on ``a``'s device."""
    H, W = a.shape[0], a.shape[1]
    up = dpm._scale_upto(H, W, [model], params.interval)
    pyr = dpm._feature_pyramid(a, up, params.interval)
    nxt = params.interval + 1
    out = [[] for _ in model.roots]
    for i in range(nxt, up + nxt * 2):
        for k, root in enumerate(model.roots):
            s = dpm._level(root, pyr[i], pyr[i - nxt])[0].cpu().numpy()
            rr, rc = root.w.shape[0], root.w.shape[1]
            out[k].append(s[(rr - 1) // 2:s.shape[0] - rr // 2,
                            (rc - 1) // 2:s.shape[1] - rc // 2].ravel())
    return [np.concatenate(v) for v in out]


def dpm_match(name, got, want, threshold):
    """Phase 23's gate: the same detections outside a margin of 1e-3 of the
    largest |confidence| around the threshold, confidences within it, part
    rects equal. Returns (matched, differing, max conf diff)."""
    tol = 1e-3 * max([1.0] + [abs(r.confidence) for r in want])

    def key(r):
        return (r.x, r.y, r.width, r.height)

    g = sorted(got, key=lambda r: (key(r), r.confidence))
    w = sorted(want, key=lambda r: (key(r), r.confidence))
    gk, wk = [key(r) for r in g], [key(r) for r in w]
    odd = [r for r in g + w if (key(r) in gk) != (key(r) in wk)]
    check(all(abs(r.confidence - threshold) <= tol for r in odd),
          f"DPM {name}: {len(odd)} detections differ outside the margin")
    pairs = [(a, b) for a, b in zip(g, w)] if not odd else [
        (a, w[wk.index(key(a))]) for a in g if key(a) in wk]
    diff = 0.0
    for a, b in pairs:
        diff = max(diff, abs(a.confidence - b.confidence))
        check([key(p) for p in a.parts] == [key(p) for p in b.parts],
              f"DPM {name}: part rects differ at {key(a)}")
    check(diff <= tol and len(pairs) > 0,
          f"DPM {name}: {len(pairs)} matched, conf diff {diff}")
    return len(pairs), len(odd), diff


def dpm_path(dev, card, read):
    """Phase 23, DPM: a seeded 2-root model (DPM_ROOT cells, DPM_PARTS
    parts of 6x6) in the text format, beta set so that about DPM_PASS
    windows of the 1080p RGB frame pass 0.6 at default DpmParams; card
    against the port's CPU path at 1080p with interval 0 and at 640x480
    with the defaults; ms per 1080p image (interval 8); bin/dpmdetect and
    /dpm/detect.objects. Returns the profile."""
    from ccv_tpu_torch.bin import dpmdetect
    from ccv_tpu_torch.detectors import dpm
    from ccv_tpu_torch.serve import server
    rgb = torch.from_numpy(rgb_frame_1080p(read))
    r_d = rgb.to(dev)
    model = dpm_synth(dpm, np.random.default_rng(23))
    params = dpm.DpmParams()
    scores = np.concatenate(dpm_scores(dpm, r_d, model, params))
    beta = params.threshold - float(np.sort(scores)[-DPM_PASS])
    for root in model.roots:
        root.beta = beta + 1e-4   # off any window's exact score
    tmp = tempfile.mkdtemp(prefix="ccv_dpm_")
    srv = None
    try:
        path = os.path.join(tmp, "pedestrian.m")
        dpm.write_mixture_model(model, path)
        back = dpm.read_mixture_model(path)
        notes = []
        for name, img, p in (
                ("1080p interval 0", rgb,
                 dpm.DpmParams(interval=0, min_neighbors=0)),
                ("640x480 default", rgb[:480, :640].contiguous(),
                 dpm.DpmParams())):
            got = dpm.detect(img.to(dev), back, p)
            t0 = time.perf_counter()
            want = dpm.detect(img, back, p)
            cpu_s = time.perf_counter() - t0
            n, odd, diff = dpm_match(name, got, want, p.threshold)
            notes.append(f"{name}: card = CPU on {n} detections ({odd} "
                         f"differ, in the margin), conf diff {diff:.3g}, "
                         f"part rects equal (CPU path {cpu_s:.1f} s)")
        med, ms = median_ms(lambda: dpm.detect(r_d, back), 3)
        found = dpm.detect(r_d, back)
        n_raw = len(dpm.detect(r_d, back, dpm.DpmParams(min_neighbors=0)))
        check(len(found) > 0, "DPM 1080p: nothing found at default params")
        log(23, f"DPM 1080p RGB, 2 roots of {DPM_ROOT[0]}x{DPM_ROOT[1]} "
                f"cells with {DPM_PARTS} parts of 6x6, beta {beta:.4f}; "
                + "; ".join(notes) + f"; default DpmParams at 1080p: "
                f"{n_raw} windows, {len(found)} grouped, median {med:.2f} "
                f"ms/image ({', '.join(f'{x:.2f}' for x in ms)}); {card}")
        png = os.path.join(tmp, "frame.png")
        with open(png, "wb") as f:
            f.write(png_bytes(rgb.numpy()))
        code, lines = captured(dpmdetect.main, [png, path])
        want_lines = []
        for c in found:
            want_lines.append(f"{c.x} {c.y} {c.width} {c.height} "
                              f"{c.confidence:f}")
            want_lines += [f"| {q.x} {q.y} {q.width} {q.height} "
                           f"{q.confidence:f}" for q in c.parts]
        check(code == 0 and lines[:-1] == want_lines
              and lines[-1].startswith(f"total : {len(found)} in time "),
              f"bin/dpmdetect printed {lines[-1:]} for {len(found)} rects")
        srv, url = serving(tmp)
        with open(png, "rb") as f:
            code, out = http(url + "/dpm/detect.objects", f.read())
        check(code == 200 and out == server._rects(found),
              f"/dpm: {code}, {len(out)} rects against {len(found)}")
        log(23, f"bin/dpmdetect on the card: {lines[-1]}; "
                f"/dpm/detect.objects on the 1080p PNG = direct detect "
                f"({len(out)} rects); {card}")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)

    def profile():
        busy, by_name, wall = device_ms(lambda: dpm.detect(r_d, back), 1)
        log(23, f"DPM 1080p under torch.profiler (1 image): device busy "
                f"{busy:.2f} ms per image over a wall of {wall:.2f} ms: idle "
                f"share {1 - busy / wall:.3f}; largest: "
                f"{top_kernels(by_name)}; {card}")
    return dict(ms=med, found=len(found)), profile


def mser_rows(kps):
    return [(k.size, *k.keypoint, k.x, k.y, k.width, k.height) for k in kps]


def mser_path(dev, card, read):
    """Phase 24, MSER and MSCR: msermatch (canny and close_outline on the
    card, the masked MSER's C++ on the host) on the 1080p gray frame, card
    against CPU (keypoints and labels identical); MSCR with msermatch's
    params on the 1080p RGB frame (chi maps on the card, the C++ on the
    host) against the CPU; ms per image; bin/msermatch and /mser. Returns
    the profile."""
    import math
    from ccv_tpu_torch.bin import msermatch
    from ccv_tpu_torch.detectors import mser
    gray = torch.from_numpy(frame_1080p(read))
    g_d = gray.to(dev)
    kc, lc = msermatch.msermatch(gray)
    kg, lg = msermatch.msermatch(g_d)
    check(mser_rows(kg) == mser_rows(kc) and np.array_equal(lg, lc)
          and len(kc) > 0, f"msermatch 1080p: {len(kg)} regions on the "
                           f"card, {len(kc)} on the CPU")
    med, ms = median_ms(lambda: msermatch.msermatch(g_d), 3)
    rgb = torch.from_numpy(rgb_frame_1080p(read))
    r_d = rgb.to(dev)
    mp = mser.MserParams(
        min_area=60, max_area=int(rgb.shape[0] * rgb.shape[1] * 0.3 + 0.5),
        min_diversity=0.2, area_threshold=1.01, min_margin=0.003,
        max_evolution=200, edge_blur_sigma=math.sqrt(3.0))
    chi_c = mser._chi_maps(rgb, mp.edge_blur_sigma)
    chi_g = mser._chi_maps(r_d, mp.edge_blur_sigma)
    chi_diff = max(float(np.abs(a - b).max()) for a, b in zip(chi_c, chi_g))
    chi_odd = sum(int((a != b).sum()) for a, b in zip(chi_c, chi_g))
    mc, mlc = mser.mscr(rgb, mp)
    mg, mlg = mser.mscr(r_d, mp)
    same = mser_rows(mg) == mser_rows(mc) and np.array_equal(mlg, mlc)
    check(same or chi_odd > 0, "MSCR: keypoints differ on equal chi maps")
    check(len(mc) > 0, "MSCR 1080p: no region")
    mscr_med, mscr_ms = median_ms(lambda: mser.mscr(r_d, mp), 3)
    log(24, f"msermatch 1080p gray: {len(kg)} regions, keypoints and label "
            f"map card = CPU, median {med:.2f} ms/image "
            f"({', '.join(f'{x:.2f}' for x in ms)}); MSCR 1080p RGB "
            f"(msermatch's params): chi maps card vs CPU {chi_odd} values "
            f"differ, by at most {chi_diff:.3g}; {len(mg)} regions on the "
            f"card, {len(mc)} on the CPU, keypoints and labels "
            f"{'identical' if same else 'differ (chi maps differ)'}; median "
            f"{mscr_med:.2f} ms/image "
            f"({', '.join(f'{x:.2f}' for x in mscr_ms)}); {card}")
    tmp = tempfile.mkdtemp(prefix="ccv_mser_")
    srv = None
    try:
        png = os.path.join(tmp, "frame.png")
        with open(png, "wb") as f:
            f.write(png_bytes(gray.numpy()))
        code, lines = captured(msermatch.main, [png])
        check(code == 0 and lines[-1].startswith(
            f"total : {len(kg)} in time "), f"bin/msermatch: {lines}")
        srv, url = serving(tmp)
        with open(png, "rb") as f:
            code, out = http(url + "/mser", f.read())
        kps, _ = mser.mser(g_d)
        check(code == 200 and out == [
            {"x": k.x, "y": k.y, "width": k.width, "height": k.height,
             "size": k.size} for k in kps], f"/mser: {code}, {len(out)} "
                                            f"regions against {len(kps)}")
        log(24, f"bin/msermatch on the card: {lines[-1]}; /mser on the 1080p "
                f"PNG = direct mser ({len(out)} regions); {card}")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)

    def profile():
        busy, by_name, wall = device_ms(lambda: msermatch.msermatch(g_d), 1)
        log(24, f"msermatch 1080p under torch.profiler (1 image): device "
                f"busy {busy:.2f} ms over a wall of {wall:.2f} ms: idle share "
                f"{1 - busy / wall:.3f}; largest: {top_kernels(by_name)}")
        busy, by_name, wall = device_ms(lambda: mser.mscr(r_d, mp), 1)
        log(24, f"MSCR 1080p under torch.profiler (1 image): device busy "
                f"{busy:.2f} ms over a wall of {wall:.2f} ms: idle share "
                f"{1 - busy / wall:.3f}; largest: {top_kernels(by_name)}; "
                f"{card}")
    return dict(ms=med, mscr_ms=mscr_med), profile


def daisy_path(dev, card, read):
    """Phase 25, DAISY at default DaisyParams: card against the port's CPU
    path on a 256x256 crop (within 1e-4 of the largest value), the 1080p
    gray frame on the card (finite, (H, W, 200)), ms per image. Returns
    the profile."""
    from ccv_tpu_torch.detectors import daisy
    gray = torch.from_numpy(frame_1080p(read))
    y0, x0 = DAISY_AT   # a 256x256 window of text, not the white margin
    crop = gray[y0:y0 + DAISY_CROP, x0:x0 + DAISY_CROP].contiguous()
    want = daisy.daisy(crop)
    got = daisy.daisy(crop.to(dev)).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(scale > 0 and err <= 1e-4 * scale,
          f"DAISY crop: card vs CPU {err} of {scale}")
    g_d = gray.to(dev)
    out = daisy.daisy(g_d)
    check(tuple(out.shape) == (*gray.shape, 200)
          and bool(torch.isfinite(out).all()), "DAISY 1080p: bad output")
    del out
    med, ms = median_ms(lambda: daisy.daisy(g_d), 3)
    log(25, f"DAISY {DAISY_CROP}x{DAISY_CROP} crop: card vs CPU max diff "
            f"{err:.3g} (largest value {scale:.3g}); 1080p (1080, 1920, 200) "
            f"finite; median {med:.2f} ms/image "
            f"({', '.join(f'{x:.2f}' for x in ms)}); {card}")

    def profile():
        busy, by_name, wall = device_ms(lambda: daisy.daisy(g_d), 1)
        log(25, f"DAISY 1080p under torch.profiler (1 image): device busy "
                f"{busy:.2f} ms over a wall of {wall:.2f} ms: idle share "
                f"{1 - busy / wall:.3f}; largest: {top_kernels(by_name)}; "
                f"{card}")
    return dict(ms=med), profile


def tld_frames(read):
    """TLD_SHIFTS frames of 1920x1080: frame_1080p's text as the
    background, crop180.png in gray pasted as the target at TLD_BOX moved by
    each shift (a target on self-similar texture cannot be told apart by
    any detector)."""
    from ccv_tpu_torch.core.io import IO_GRAY
    bg = frame_1080p(read)
    target = read(os.path.join(DATA, "crop180.png"), IO_GRAY,
                  device="cpu").numpy()
    x, y, w, h = TLD_BOX
    frames = []
    for dx, dy in TLD_SHIFTS:
        f = bg.copy()
        f[y + dy:y + dy + h, x + dx:x + dx + w] = target
        frames.append(torch.from_numpy(f))
    return frames


def tld_track(tld, frames, dev, n):
    """(boxes, confidences, ms per step) of a seeded tracker over the first
    ``n`` frames on ``dev``."""
    on = [f.to(dev) for f in frames[:n]]
    t = tld.Tld(on[0], TLD_BOX, seed=26)
    boxes, confs, ms = [], [], []
    for i in range(1, n):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        box, conf = t.track_object(on[i - 1], on[i])
        ms.append((time.perf_counter() - t0) * 1000)
        boxes.append(box)
        confs.append(conf)
    return boxes, confs, ms


def tld_cpu_reference():
    """Phase 26's reference: (boxes, confidences, seconds) of the port's
    CPU path over the first TLD_CPU_FRAMES frames of tld_frames. It needs
    nothing from the card, so main starts it in the CPU child with the
    script (``cpu_pool``) and phase 26 collects it."""
    from ccv_tpu_torch.core.io import read
    from ccv_tpu_torch.detectors import tld
    frames = tld_frames(read)
    t0 = time.perf_counter()
    boxes, confs, _ = tld_track(tld, frames, torch.device("cpu"),
                                TLD_CPU_FRAMES)
    return boxes, confs, time.perf_counter() - t0


def tld_path(dev, card, read):
    """Phase 26, TLD on 3 frames of 1920x1080 (tld_frames): track IoU >= 0.7
    against the known boxes on the card, card against the port's CPU path
    (boxes within 1 px, confidence within 1e-3; ``tld_cpu_reference``, in
    the CPU child), ms per frame; bin/tld,
    /tld/track.object, and /convnet/classify with tiny_convnet_f32.sqlite3.
    Returns the profile."""
    from ccv_tpu_torch.bin import tld as tldcli
    from ccv_tpu_torch.core.io import IO_RGB_COLOR
    from ccv_tpu_torch.detectors import tld
    from ccv_tpu_torch.models.convnet import Convnet
    cpu_ref = CPU_REFS.pop("tld", None) or cpu_pool().submit(
        tld_cpu_reference)
    frames = tld_frames(read)
    t0 = time.perf_counter()
    boxes, confs, ms = tld_track(tld, frames, dev, len(frames))
    card_s = time.perf_counter() - t0
    x, y, w, h = TLD_BOX
    ious = [iou(b, (x + dx, y + dy, w, h)) if b is not None else 0.0
            for b, (dx, dy) in zip(boxes, TLD_SHIFTS[1:])]
    check(min(ious) >= 0.7, f"TLD: IoU {ious}")
    cb, cc, cpu_s = cpu_ref.result()
    px = max(abs(a - b) for p, q in zip(boxes, cb) for a, b in zip(p, q))
    cdiff = max(abs(a - b) for a, b in zip(confs, cc))
    check(px <= 1 and cdiff <= 1e-3, f"TLD card vs CPU: {px} px, conf "
                                     f"{cdiff}: {boxes} {cb}")
    log(26, f"TLD {len(frames)} frames of 1920x1080, target {w}x{h}: IoU "
            f"against the known boxes {[round(v, 3) for v in ious]}; "
            f"card = CPU over {TLD_CPU_FRAMES} frames (boxes within {px} px, "
            f"conf within {cdiff:.3g}; CPU path {cpu_s:.1f} s in the CPU "
            f"child); per step "
            f"on the card {', '.join(f'{v:.1f}' for v in ms)} ms (median "
            f"{float(np.median(ms)):.1f}; init and all steps {card_s:.1f} "
            f"s); {card}")
    tmp = tempfile.mkdtemp(prefix="ccv_tld_")
    srv = None
    try:
        pngs = []
        for i, f in enumerate(frames[:2]):
            pngs.append(os.path.join(tmp, f"{i}.png"))
            with open(pngs[-1], "wb") as fh:
                fh.write(png_bytes(f.numpy()))
        code, lines = captured(tldcli.main, pngs + [str(v) for v in TLD_BOX])
        on = [f.to(dev) for f in frames[:3]]
        t = tld.Tld(on[0], TLD_BOX)
        want = [f"00000: {x} {y} {w} {h} 1.000000"]
        for i in (1,):
            nb, conf = t.track_object(on[i - 1], on[i])
            want.append(f"{i:05d}: {nb[0]} {nb[1]} {nb[2]} {nb[3]} "
                        f"{conf:f}")
        check(code == 0 and lines == want, f"bin/tld printed {lines}")
        shutil.copy(os.path.join(DATA, "tiny_convnet_f32.sqlite3"),
                    os.path.join(tmp, "tiny.sqlite3"))
        srv, url = serving(tmp)
        with open(pngs[0], "rb") as f0, open(pngs[1], "rb") as f1:
            fields = {"previous": f0.read(), "source": f1.read(),
                      "x": str(x), "y": str(y), "width": str(w),
                      "height": str(h)}
        code, out = http(url + "/tld/track.object", *multipart(fields))
        check(code == 200 and (out["x"], out["y"], out["width"],
                               out["height"]) == tuple(int(v) for v in
                                                        want[1].split()[1:5]),
              f"/tld: {code} {out} against {want[1]}")
        del fields["height"]
        code, missing = http(url + "/tld/track.object", *multipart(fields))
        check(code == 400 and "height" in missing["error"],
              f"/tld without height: {code} {missing}")
        crop_png = open(os.path.join(DATA, "crop180.png"), "rb").read()
        code, ranks = http(url + "/convnet/classify", *multipart(
            {"source": crop_png, "model": "tiny.sqlite3"}))
        net = Convnet.read(os.path.join(tmp, "tiny.sqlite3"), dev)
        direct = net.classify(read(os.path.join(DATA, "crop180.png"),
                                   IO_RGB_COLOR, device=dev).tensor, tops=5)
        check(code == 200 and [(r["id"], r["confidence"]) for r in ranks]
              == [(i + 1, c) for i, c in direct], f"/convnet: {code} {ranks}")
        code, esc = http(url + "/convnet/classify", *multipart(
            {"source": crop_png, "model": "../tiny.sqlite3"}))
        check(code == 400, f"/convnet with ../: {code} {esc}")
        log(26, f"bin/tld on the card over 2 frames = direct track_object "
                f"({lines[-1]}); /tld/track.object = a direct step, 400 "
                f"without height; /convnet/classify (tiny_convnet_f32, "
                f"crop180) = direct classify {[r['id'] for r in ranks]}, "
                f"400 for a model outside the models directory; {card}")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)

    def profile():   # the bin/tld check's tracker, one step further
        busy, by_name, wall = device_ms(
            lambda: t.track_object(on[1], on[2]), 1)
        log(26, f"TLD 1080p step under torch.profiler (1 frame): device busy "
                f"{busy:.2f} ms over a wall of {wall:.2f} ms: idle share "
                f"{1 - busy / wall:.3f}; largest: {top_kernels(by_name)}; "
                f"{card}")
    return dict(ms=float(np.median(ms))), profile


# ops of phase 27, as tests/test_torch_compat.py drives them (1080p sizes)
CLASSIC_PERSPECTIVE = dict(zip(("m00", "m01", "m02", "m10", "m11", "m12",
                                "m20", "m21", "m22"),
                               (0.9, 0.05, -10.0, -0.04, 1.1, 5.0, 1e-4,
                                2e-4, 1.0)))
CLASSIC_COMMON = [
    ("ccv_sobel", dict(dx=1, dy=0)), ("ccv_sobel", dict(dx=0, dy=3)),
    ("ccv_sobel", dict(dx=5, dy=5)), ("ccv_gradient", dict(dx=1, dy=1)),
    ("ccv_flip", dict(ftype=1)), ("ccv_flip", dict(ftype=2)),
    ("ccv_flip", dict(ftype=3)), ("ccv_blur", dict(sigma=1.5)),
    ("ccv_erode", dict(fsz=3)), ("ccv_erode", dict(fsz=5)),
    ("ccv_dilate", dict(fsz=3)), ("ccv_dilate", dict(fsz=5)),
    ("ccv_resample", dict(rows=720, cols=1280, rows_scale=720 / 1080,
                          cols_scale=1280 / 1920, interp=1)),
    ("ccv_sample_down", {}), ("ccv_sample_up", {}),
    ("ccv_decimal_slice", dict(y=10.5, x=5.25, rows=500, cols=600)),
    ("ccv_perspective_transform", CLASSIC_PERSPECTIVE),
    ("ccv_sat", dict(padding=1))]
CLASSIC_GRAY = CLASSIC_COMMON + [
    ("ccv_canny", dict(size=3, low_thresh=36, high_thresh=108)),
    ("ccv_close_outline", None)]   # on the canny result: a derived input
CLASSIC_RGB = CLASSIC_COMMON + [
    ("ccv_color_transform", {}), ("ccv_saturation", dict(ds=0.5)),
    ("ccv_saturation", dict(ds=1.5)), ("ccv_contrast", dict(ds=0.5)),
    ("ccv_contrast", dict(ds=1.5))]
SWT_CAPS_RAISED = (4096, 1024)  # phase 28's uncapped timing, diagnostic
HIT_CONTROL = 1000  # control kernels in the window of phase 27's hits
CLASSIC_CACHE_BYTES = 2 << 30


def classic_same(name, got, want):
    """Card result ``got`` against the CPU's ``want``: equal for integer
    outputs, within 1e-5 of the largest for float ones, contrast within
    tests/test_torch_compat.py's tolerance (1 in value at <= 0.1% of the
    pixels). Returns the max difference."""
    g, w = got.cpu(), want
    check(g.shape == w.shape and g.dtype == w.dtype,
          f"{name}: card {g.dtype} {tuple(g.shape)}, CPU {w.dtype} "
          f"{tuple(w.shape)}")
    diff = (g.to(torch.float64) - w.to(torch.float64)).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if name == "ccv_contrast":
        check(err <= 1 and float((diff > 0).to(torch.float64).mean())
              <= 1e-3, f"{name}: card vs CPU {err}")
    elif w.dtype.is_floating_point:
        check(err <= 1e-5 * max(float(w.abs().max()), 1.0),
              f"{name}: card vs CPU {err}")
    else:
        check(err == 0, f"{name}: card vs CPU differ by {err}")
    return err


def classic_path(dev, card, read):
    """Phase 27, ccv's classic surface on the card: with the cache on, the
    17 compat ops (and ccv_otsu) on the 1080p gray and RGB frames against
    the same calls on the CPU; each op again as a hit (same sig, same
    tensor, hits + 1, no CUDA kernel under torch.profiler); a CPU matrix of
    the same bytes gets a CPU result; eviction, drain and disable; PNG and
    CCVBINDM writes of card results read back; numeric on the card against
    the CPU; bin/msermatch's out.png at 1080p. Returns the profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ccv_tpu_torch import compat as ccv
    from ccv_tpu_torch.bin import msermatch
    from ccv_tpu_torch.core import cache, io as tio, numeric, util
    from ccv_tpu_torch.core.dense_matrix import from_numpy
    gray_np, rgb_np = frame_1080p(read), rgb_frame_1080p(read)
    # a budget that holds a frame's every result (the RGB frame's come to
    # ~0.5 GB): the default 256 MB would evict the first before the sweep
    # of hits below
    cache.enable(max_bytes=CLASSIC_CACHE_BYTES)
    cache.drain()
    rows, hits_ms, maxerr = [], [], 0.0
    for label, arr, ops in (("gray", gray_np, CLASSIC_GRAY),
                            ("rgb", rgb_np, CLASSIC_RGB)):
        on_card = from_numpy(arr, device=dev)
        on_cpu = from_numpy(arr, device="cpu")
        check(on_card.sig == on_cpu.sig != 0, "one signature on both devices")
        prev = (None, None)
        for name, kw in ops:
            fn = getattr(ccv, name)
            src_d, src_c = ((prev[0], prev[1]) if kw is None
                            else (on_card, on_cpu))
            kw = kw or {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(src_d, **kw)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1000
            want = fn(src_c, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            wants = want if isinstance(want, tuple) else (want,)
            for o, w in zip(outs, wants):
                check(o.tensor.device.type == "cuda"
                      and w.tensor.device.type == "cpu" and o.sig == w.sig,
                      f"{name}: devices or signatures")
                maxerr = max(maxerr, classic_same(name, o.tensor, w.tensor))
            h0 = cache.hits
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = fn(src_d, **kw)
            torch.cuda.synchronize()
            hit = (time.perf_counter() - t0) * 1000
            agains = again if isinstance(again, tuple) else (again,)
            check(cache.hits == h0 + len(outs) and all(
                a.sig == o.sig and a.tensor.data_ptr() == o.tensor.data_ptr()
                for a, o in zip(agains, outs)), f"{name}: no hit")
            hits_ms.append(hit)
            rows.append(f"{label} {name}{'' if not kw else ' ' + ','.join(f'{k}={v}' for k, v in list(kw.items())[:2])}"
                        f" {first:.3f}/{hit:.4f}")
            if name == "ccv_canny":
                prev = (out, want)
        # every hit again, under the profiler: no CUDA kernel at all
        calls = []
        prev = (None, None)
        for name, kw in ops:
            src = prev[0] if kw is None else on_card
            calls.append((getattr(ccv, name), src, kw or {}))
            if name == "ccv_canny":
                prev = (getattr(ccv, name)(on_card, **kw), None)
        # after the head (profile_head) and the hits, HIT_CONTROL
        # bitwise_not kernels that the window must show (a window that lost
        # its device records would show no kernel)
        ctrl = torch.zeros(64, dtype=torch.uint8, device=dev)
        torch.cuda.synchronize()
        h0 = cache.hits
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profile_head()
            for fn, src, kw in calls:
                fn(src, **kw)
            for _ in range(HIT_CONTROL):
                ctrl.bitwise_not_()
            torch.cuda.synchronize()
        n_ctrl = n_cuda = 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or HEAD_KERNEL in e.key:
                continue
            if "bitwise_not" in e.key:
                n_ctrl += e.count
            else:
                n_cuda += e.count
        check(n_ctrl == HIT_CONTROL, f"{label}: the profiler kept {n_ctrl} "
                                     f"of the {HIT_CONTROL} control kernels")
        check(n_cuda == 0, f"{label}: the hits launched {n_cuda} kernels")
        held = cache._cur_bytes
        check(cache.hits - h0 == sum(2 if fn is ccv.ccv_gradient else 1
                                     for fn, _, _ in calls),
              f"{label}: the profiled calls were not all hits")
        t, v = ccv.ccv_otsu(on_card)
        check((t, v) == ccv.ccv_otsu(on_cpu) or (
            t == ccv.ccv_otsu(on_cpu)[0]
            and abs(v - ccv.ccv_otsu(on_cpu)[1]) <= 1e-5 * abs(v)),
            f"ccv_otsu {label}: card {(t, v)}, CPU {ccv.ccv_otsu(on_cpu)}")
    log(27, f"classic surface at 1080p, cache on: {len(rows)} op calls "
            f"card = CPU (integer outputs equal, float within 1e-5 of the "
            f"largest, contrast within 1 at <= 0.1%; largest difference "
            f"{maxerr:.3g}); every second call a "
            f"hit on the same tensor, and the hits of each frame launched 0 "
            f"CUDA kernels under torch.profiler (beside the window's "
            f"{HIT_CONTROL} control kernels, all kept; "
            f"{held / 2 ** 20:.1f} MiB cached); ms first call / hit "
            f"(synchronised): " + "; ".join(rows) + f"; {card}")
    # a CPU matrix of the card's bytes gets a CPU result, never the card's
    on_cpu = from_numpy(gray_np, device="cpu")
    on_card = from_numpy(gray_np, device=dev)
    card_out = ccv.ccv_blur(on_card, sigma=1.5)   # cached on the card above
    h0 = cache.hits
    cpu_out = ccv.ccv_blur(on_cpu, sigma=1.5)
    check(cpu_out.tensor.device.type == "cpu" and cache.hits == h0 + 1
          and cpu_out.tensor.data_ptr() != card_out.tensor.data_ptr(),
          "a CPU matrix was answered from the card's entry")
    # eviction at a small budget, drain, disable
    cache.enable(max_bytes=gray_np.size * 4 + 1024)   # one int32 plane
    cache.drain()
    ccv.ccv_sobel(on_card, dx=1, dy=0)
    ccv.ccv_sobel(on_card, dx=0, dy=1)                # evicts dx=1
    h0 = cache.hits
    ccv.ccv_sobel(on_card, dx=1, dy=0)
    check(cache.hits == h0, "eviction: the evicted entry answered")
    ccv.ccv_sobel(on_card, dx=1, dy=0)
    check(cache.hits == h0 + 1, "eviction: the kept entry missed")
    cache.drain()
    ccv.ccv_sobel(on_card, dx=1, dy=0)
    check(cache.hits == h0 + 1 and cache.is_enabled(), "drain")
    ccv.ccv_disable_cache()
    ccv.ccv_sobel(on_card, dx=1, dy=0)
    check(cache.hits == h0 + 1 and not cache.is_enabled(), "disable")
    # writes of card results
    tmp = tempfile.mkdtemp(prefix="ccv_classic_")
    try:
        flipped = ccv.ccv_flip(from_numpy(rgb_np, device=dev), ftype=3)
        png = os.path.join(tmp, "flip.png")
        t0 = time.perf_counter()
        tio.write(flipped, png)
        png_ms = (time.perf_counter() - t0) * 1000
        back = tio.read(png, device="cpu").tensor
        check(torch.equal(back, flipped.tensor.cpu()), "PNG round trip")
        sob = ccv.ccv_sobel(on_card, dx=1, dy=0)
        binp = os.path.join(tmp, "sobel.bin")
        t0 = time.perf_counter()
        tio.write(sob, binp)
        bin_ms = (time.perf_counter() - t0) * 1000
        check(torch.equal(tio.read(binp, device="cpu").tensor,
                          sob.tensor.cpu()), "CCVBINDM round trip")
        # bin/msermatch's out.png at 1080p on the card
        gray_png = os.path.join(tmp, "gray.png")
        tio.write(gray_np, gray_png)
        out_png = os.path.join(tmp, "out.png")
        code, lines = captured(msermatch.main, [gray_png, out_png])
        painted = tio.read(out_png, device="cpu").tensor
        check(code == 0 and tuple(painted.shape) == (*gray_np.shape, 3)
              and bool((painted[..., 0] != painted[..., 1]).any()),
              f"msermatch out.png: {code} {lines} {tuple(painted.shape)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(27, f"a CPU matrix of the same bytes got a CPU result; eviction at "
            f"one plane's budget, drain and disable as ccv_tpu's; 1080p RGB "
            f"PNG write {png_ms:.1f} ms (zlib, host), int32 CCVBINDM write "
            f"{bin_ms:.1f} ms, both read back equal; bin/msermatch "
            f"gray.png out.png on the card: {lines}, out.png (1080, 1920, "
            f"3); {card}")
    # numeric on the card against the CPU
    g32 = torch.from_numpy(gray_np.astype(np.float32))
    yy = np.arange(15) - 7
    kern = torch.from_numpy(np.exp(-(yy[:, None] ** 2 + yy[None] ** 2)
                                   / (2 * 2.0 ** 2)).astype(np.float32))
    kern /= kern.sum()
    f_cpu = numeric.filter(g32, kern)
    f_ms, _ = median_ms(lambda: numeric.filter(g32.to(dev), kern.to(dev)), 3)
    f_err = float((numeric.filter(g32.to(dev), kern.to(dev)).cpu()
                   - f_cpu).abs().max())
    check(f_err <= 1e-5 * float(f_cpu.abs().max()), f"filter: {f_err}")
    plane = g32[:270, :480].contiguous()
    dt_cpu = numeric.distance_transform(plane, 0.1, -0.2, 0.5, 0.8)
    dt_ms, _ = median_ms(lambda: numeric.distance_transform(
        plane.to(dev), 0.1, -0.2, 0.5, 0.8), 3)
    dt_card = numeric.distance_transform(plane.to(dev), 0.1, -0.2, 0.5, 0.8)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(dt_card, dt_cpu)),
          "distance_transform: card != CPU (values or offsets)")
    rng = np.random.default_rng(27)
    m = rng.standard_normal((256, 256)).astype(np.float32)
    spd = torch.from_numpy(m @ m.T / 256 + np.eye(256, dtype=np.float32))
    rhs = torch.from_numpy(rng.standard_normal((256, 4)).astype(np.float32))
    eye = torch.eye(256)
    inv_d = numeric.invert(spd.to(dev)).cpu()
    inv_c = numeric.invert(spd)
    x_d = numeric.solve(spd.to(dev), rhs.to(dev)).cpu()
    vec_d, lam_d = (t.cpu() for t in numeric.eigen(spd.to(dev)))
    vec_c, lam_c = numeric.eigen(spd)
    la = dict(
        inv=float((inv_d @ spd - eye).abs().max()),
        inv_cpu=float((inv_c @ spd - eye).abs().max()),
        solve=float((spd @ x_d - rhs).abs().max()),
        eig_vals=float((lam_d - lam_c).abs().max() / lam_c.abs().max()),
        eig_res=float((vec_d @ spd - lam_d[:, None] * vec_d).abs().max()))
    # float32 eigensolvers are backward stable to O(n eps |a|): the card's
    # (cuSOLVER) and the CPU's (LAPACK) eigenvalues within 16 n eps of the
    # largest
    check(la["inv"] <= 1e-3 and la["solve"] <= 1e-3 and la["eig_vals"]
          <= 16 * 256 * 2.0 ** -24 and la["eig_res"] <= 1e-3,
          f"linear algebra: {la}")
    sp = util.SparseMatrix(1024, 1024)
    idx = rng.choice(1024 * 1024, 10000, replace=False)
    vals = rng.standard_normal(10000).astype(np.float32)
    for k, v in zip(idx.tolist(), vals.tolist()):
        sp.set(k // 1024, k % 1024, v)
    dense_rhs = torch.from_numpy(rng.standard_normal((1024, 64))
                                 .astype(np.float32))
    coo = util.sparse_to_bcoo(sp, device=dev)
    prod = torch.sparse.mm(coo, dense_rhs.to(dev)).cpu()
    want = torch.from_numpy(sp.to_dense()) @ dense_rhs
    sp_err = float((prod - want).abs().max())
    check(coo.device.type == "cuda" and sp_err <= 1e-4 * float(
        want.abs().max()), f"sparse product: {sp_err}")
    log(27, f"numeric on the card against the CPU: filter of the 1080p gray "
            f"frame with a 15x15 Gaussian max diff {f_err:.3g} (largest "
            f"{float(f_cpu.abs().max()):.1f}), {f_ms:.2f} ms; "
            f"distance_transform at (270, 480) values and both offsets "
            f"equal, {dt_ms:.2f} ms; 256x256 SPD: |inv a - I| {la['inv']:.3g} "
            f"(CPU {la['inv_cpu']:.3g}), |a x - b| {la['solve']:.3g}, "
            f"eigenvalues card vs CPU {la['eig_vals']:.3g} of the largest, "
            f"|v a - lam v| {la['eig_res']:.3g}; sparse_to_bcoo (torch COO, "
            f"10,000 of 1024x1024) @ (1024, 64) = the dense product within "
            f"{sp_err:.3g}; {card}")

    def profile():
        ccv.ccv_enable_default_cache()
        cache.drain()
        img = from_numpy(gray_np, device=dev)
        busy, by_name, wall = device_ms(
            lambda: ccv.ccv_blur(img, sigma=1.5), 1)
        hit_busy, _, hit_wall = device_ms(
            lambda: ccv.ccv_blur(img, sigma=1.5), 3)
        ccv.ccv_disable_cache()
        log(27, f"ccv_blur 1080p under torch.profiler: first call device "
                f"busy {busy:.3f} ms over a wall of {wall:.3f} ms (largest: "
                f"{top_kernels(by_name)}); hits {hit_busy:.3f} ms busy over "
                f"{hit_wall:.3f} ms; {card}")
    return dict(ops=len(rows), hit_ms=max(hits_ms), png_ms=png_ms), profile


def swt_route_ms(swt, img, letters, n=3):
    """(median ms, per-stage median ms) of ``n`` timed calls after a
    warm-up."""
    swt.detect_words(img, letters=letters)
    walls, stages = [], {}
    for _ in range(n):
        tm = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        swt.detect_words(img, letters=letters, timings=tm)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1000)
        for k, v in tm.items():
            stages.setdefault(k, []).append(v)
    return float(np.median(walls)), {k: float(np.median(v))
                                     for k, v in stages.items()}


def swt_device_path(dev, card, read):
    """Phase 28, SWT with letters="device": on text_test.png and the 1080p
    gray frame the words equal letters="compact"'s on the card and the
    card's letter rows equal the CPU's; both routes' stage timings (median
    of 3) and the counts (painted cells, candidate components, kept
    letters, overflows); the device stage timed once more with the caps
    raised (a diagnostic: what the stage costs at 1080p without the
    compact fallback). Returns the profile."""
    from ccv_tpu_torch.core.io import IO_GRAY
    from ccv_tpu_torch.detectors import swt
    tt = read(os.path.join(DATA, "text_test.png"), IO_GRAY,
              device="cpu").tensor
    frame = torch.from_numpy(frame_1080p(read))
    params = swt.SwtParams()
    lines, res = [], {}
    for name, img in (("text_test.png", tt), ("1080p", frame)):
        img_d = img.to(dev)
        c, dx, dy, gray = swt._frontend(img_d, 3, 124, 204)
        maps = swt._rays(c, dx, dy)
        rows_d, counts = swt._letters_device(maps, gray, params)
        rows_c, counts_c = swt._letters_device(maps.cpu(), gray.cpu(),
                                               params)
        check(counts == counts_c and np.array_equal(rows_d, rows_c),
              f"SWT {name}: the card's letter rows differ from the CPU's")
        before = swt.LETTER_OVERFLOWS
        compact = word_rects(swt.detect_words(img_d))
        device_words = word_rects(swt.detect_words(img_d, letters="device"))
        check(device_words == compact and compact,
              f"SWT {name}: device words {device_words} != compact "
              f"{compact}")
        overflows = swt.LETTER_OVERFLOWS - before
        c_ms, c_st = swt_route_ms(swt, img_d, "compact")
        d_ms, d_st = swt_route_ms(swt, img_d, "device")
        res[name] = dict(compact=c_ms, device=d_ms, counts=counts,
                         overflows=overflows)
        lines.append(
            f"{name}: {len(compact)} words equal; letter rows card = CPU; "
            f"painted {counts[0]}, candidates {counts[1]}, kept {counts[2]} "
            f"(caps {swt._LETTER_CAP} / {swt._KEPT_CAP}), overflows "
            f"{overflows} of 1 call; compact median {c_ms:.2f} ms ("
            + ", ".join(f"{k} {v:.2f}" for k, v in c_st.items())
            + f"); device median {d_ms:.2f} ms ("
            + ", ".join(f"{k} {v:.2f}" for k, v in d_st.items()) + ")")
    log(28, "; ".join(lines) + f"; {card}")
    frame_d = frame.to(dev)
    caps = (swt._LETTER_CAP, swt._KEPT_CAP)
    swt._LETTER_CAP, swt._KEPT_CAP = SWT_CAPS_RAISED
    try:
        before = swt.LETTER_OVERFLOWS
        raised_words = word_rects(swt.detect_words(frame_d, letters="device"))
        r_ms, r_st = swt_route_ms(swt, frame_d, "device")
        check(swt.LETTER_OVERFLOWS == before and raised_words == word_rects(
            swt.detect_words(frame_d)), "SWT 1080p, caps raised: words "
            "differ from compact or overflowed")
    finally:
        swt._LETTER_CAP, swt._KEPT_CAP = caps
    log(28, f"diagnostic, 1080p with the caps raised to {SWT_CAPS_RAISED} "
            f"(no fallback; words = compact): median {r_ms:.2f} ms ("
            + ", ".join(f"{k} {v:.2f}" for k, v in r_st.items())
            + f"); {card}")

    def profile():
        for route in ("compact", "device"):
            busy, by_name, wall = device_ms(
                lambda: swt.detect_words(frame_d, letters=route), 1)
            log(28, f"SWT 1080p letters={route!r} under torch.profiler (1 "
                    f"image): device busy {busy:.2f} ms over a wall of "
                    f"{wall:.2f} ms: idle share {1 - busy / wall:.3f}; "
                    f"largest: {top_kernels(by_name)}; {card}")
    return res, profile


def seeded_stats(model, seed):
    """Batch-norm affine terms and statistics and the convolution biases
    from a seed, node by node (the initialisers leave them constant)."""
    rng = np.random.default_rng(seed)
    for node in model.order:
        uid = str(node.uid)
        for tree in (model.params, model.state):
            for k in sorted(tree[uid]):
                v = tree[uid][k]
                if k in ("scale", "var"):
                    a = rng.uniform(0.5, 1.0, tuple(v.shape))
                elif k in ("b", "bias", "mean"):
                    a = rng.normal(0, 0.1, tuple(v.shape))
                else:
                    continue
                tree[uid][k] = torch.from_numpy(a.astype(np.float32)).to(
                    v.device)


@contextlib.contextmanager
def bf16_batch_norm():
    """Phase 29's control: ``ops.batch_norm`` in the activation's type
    (bf16) instead of float32, for as long as the context lasts."""
    from ccv_tpu_torch.nn import ops
    saved = ops.batch_norm

    def in_x_type(x, scale, bias, mean, var, epsilon=1e-5, format=None):
        assert format is None
        t = x.dtype
        return ((x - mean.to(t)) * torch.rsqrt(var + epsilon).to(t)
                * scale.to(t) + bias.to(t))
    ops.batch_norm = in_x_type
    try:
        yield
    finally:
        ops.batch_norm = saved


def rel_err(got, want):
    """max |got - want| over max |want|, in float32 on the CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), "not finite")
    return float((got - want).abs().max() / want.abs().max())


def resnet_path(dev, card):
    """Phase 29: ``resnet.resnet50_v1d_fpn()`` -> ``Model.build`` ->
    ``Model.evaluate`` -> ``resnet.rpn_apply`` on the card at full width;
    one 800x1344 image in float32 against the CPU (P2..P6 and the RPN
    maps), B 2 in bf16 against float32 on the card, then the bf16 forward
    timed (median of RESNET_REPS synchronised batches after a warm-up):
    ms a batch, images/s, MFU from the built graph's convolution FLOPs.
    Returns (result, profile)."""
    from ccv_tpu_torch.bin.lm_bench import peak_tflops
    from ccv_tpu_torch.models import resnet
    H, W = RESNET_HW
    t0 = time.perf_counter()
    models = {}
    for where in ("cpu", dev):
        m = resnet.resnet50_v1d_fpn()
        m.build((RESNET_B, H, W, 3), torch.Generator().manual_seed(0),
                device=where)
        seeded_stats(m, 1)
        models[str(where)] = m
    cpu_m, card_m = models["cpu"], models[str(dev)]
    rpn_cpu = resnet.rpn_init(torch.Generator().manual_seed(2),
                              device="cpu")
    rpn_cpu["b"] = torch.linspace(-0.1, 0.1, resnet.RPN_CHANNELS)
    rpn = {k: v.to(dev) for k, v in rpn_cpu.items()}
    build_s = time.perf_counter() - t0
    levels = [tuple(s[1:3]) for s in card_m.output_shape]
    check(levels == [(200, 336), (100, 168), (50, 84), (25, 42), (12, 21)],
          f"levels {levels}")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (RESNET_B, H, W, 3)).astype(np.float32))

    def forward(model, inp, params):
        feats = model.evaluate(inp)
        with torch.no_grad():
            return feats + resnet.rpn_apply(params, feats)

    t0 = time.perf_counter()
    want = forward(cpu_m, x[:1], rpn_cpu)
    cpu_s = time.perf_counter() - t0
    got = forward(card_m, x[:1].to(dev), rpn)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    check(max(errs) <= RESNET_F32, f"ResNet-FPN float32 card vs CPU: "
                                   f"{errs} > {RESNET_F32}")
    xb = x.to(dev)
    f32 = forward(card_m, xb, rpn)
    xh = xb.to(torch.bfloat16)
    bf16 = forward(card_m, xh, rpn)
    check(all(o.dtype == torch.bfloat16 for o in bf16), "bf16 outputs")
    errs16 = [rel_err(g, w) for g, w in zip(bf16, f32)]
    # the control: batch norm in bf16 instead of float32
    with bf16_batch_norm():
        ctrl = forward(card_m, xh, rpn)
    errs_ctrl = [rel_err(g, w) for g, w in zip(ctrl, f32)]
    check(max(errs16) <= RESNET_BF16, f"ResNet-FPN bf16 vs float32: "
                                      f"{errs16} > {RESNET_BF16}")
    del f32, bf16, got, ctrl
    ms, all_ms = median_ms(lambda: forward(card_m, xh, rpn), RESNET_REPS)
    flops = resnet.conv_flops(card_m)
    peak = peak_tflops(dev) * 1e12
    res = dict(ms=ms, images_s=RESNET_B * 1e3 / ms, gflop=flops / 1e9,
               mfu=flops / (ms / 1e3) / peak, f32_err=errs, bf16_err=errs16,
               bf16_bn_err=errs_ctrl,
               params_m=card_m.parameter_count() / 1e6)
    names = ["P2", "P3", "P4", "P5", "P6"] + [f"RPN{i}" for i in range(2, 7)]
    log(29, f"ResNet50-v1d-FPN + RPN ({res['params_m']:.2f} M params, "
            f"{len(card_m.order)} graph nodes, built twice in {build_s:.1f} "
            f"s), levels {levels}: float32 1 x {H} x {W} card vs CPU (CPU "
            f"{cpu_s:.1f} s) max rel err "
            + ", ".join(f"{n} {e:.3g}" for n, e in zip(names, errs))
            + f" (limit {RESNET_F32}); bf16 B {RESNET_B} vs float32 on the "
            f"card: " + ", ".join(f"{n} {e:.3g}" for n, e in
                                  zip(names, errs16))
            + f" (limit {RESNET_BF16}); the control, batch norm in bf16: "
            + ", ".join(f"{n} {e:.3g}" for n, e in zip(names, errs_ctrl)))
    log(29, f"bf16 B {RESNET_B} x {H} x {W} forward (graph + RPN): median "
            f"{ms:.3f} ms a batch (min {min(all_ms):.3f}, max "
            f"{max(all_ms):.3f}, n={RESNET_REPS}), {res['images_s']:.1f} "
            f"images/s, {flops / 1e9:.1f} GFLOP a batch (2 Ho Wo Cout Cin "
            f"kh kw over its convolutions and the RPN), MFU "
            f"{res['mfu']:.4f} of {peak / 1e12:.0f} TFLOP/s; {card}")

    def profile():
        def batch():
            return forward(card_m, xh, rpn)
        one, w = device_window(batch, 1), device_window(batch, 3)
        # the profiler keeps every batch's device events (one window of
        # three against one of one), and its busy time fits in the CUDA
        # events' span of the same window
        check(w["events"] == 3 * one["events"] > 0, f"the profiler kept "
              f"{w['events']} device events in 3 batches, {one['events']} "
              f"in 1")
        check(w["busy"] <= 1.01 * w["span"], f"busy {w['busy']:.3f} ms a "
              f"batch past the CUDA events' {w['span']:.3f}")
        # the same three batches without the profiler, host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            batch()
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1000 / 3
        busy = w["busy"]
        res.update(busy_ms=busy, wall_ms=w["wall"], idle=1 - busy / w["wall"],
                   span_ms=w["span"], events=w["events"], wall_plain_ms=plain,
                   idle_plain=1 - busy / plain)
        log(29, f"bf16 B {RESNET_B} forward under torch.profiler (3 "
                f"batches, {w['events']} device events, {one['events']} in "
                f"a window of one): device busy {busy:.3f} ms a batch over "
                f"a wall of {w['wall']:.3f} ms: idle share "
                f"{1 - busy / w['wall']:.3f}; CUDA events over the same "
                f"window {w['span']:.3f} ms a batch (idle "
                f"{1 - busy / w['span']:.3f}); the same batches without the "
                f"profiler {plain:.3f} ms a batch (idle against the "
                f"profiled busy {1 - busy / plain:.3f}); largest: "
                f"{top_kernels(w['by_name'])}; {card}")
    return res, profile


def card_vs_cpu(name, fn, inputs, dev, limit=NN_F32):
    """fn on the CPU inputs and on their copies on the card: (relative
    error of each output, card ms median of 3). Raises past ``limit``."""
    want = fn(*inputs)
    card_in = [t.to(dev) if isinstance(t, torch.Tensor) else t
               for t in inputs]
    got = fn(*card_in)
    want = want if isinstance(want, (tuple, list)) else [want]
    got = got if isinstance(got, (tuple, list)) else [got]
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    check(max(errs) <= limit, f"{name}: card vs CPU {errs} > {limit}")
    ms, _ = median_ms(lambda: fn(*card_in), 3)
    return errs, ms


def nn_rest_path(dev, card, k2):
    """Phase 30: the rest of the slice on the card against the CPU. A
    graph model with ScaledDotProductAttention at T 1024 in bf16 (its
    attention runs K2a: counted by the wrapper and, by kernel name, under
    torch.profiler); LSTM and GRU; ConvolutionTranspose, the three norms,
    upsample, nms on 2000 boxes, roi_align; the MoE forward;
    depalettize_device on the goldens; LSSC; while_loop and case_of.
    Returns (K2a's launches on the layer's run, the profile, which counts
    fwd_sm90_kernel in one evaluate under torch.profiler)."""
    from ccv_tpu_torch.nn import compression, control_flow, moe, palettize
    from ccv_tpu_torch.nn import functional as F
    from ccv_tpu_torch.nn import layers as L
    from ccv_tpu_torch.nn import ops
    rng = np.random.default_rng(30)
    lines = []

    # the attention model through the graph API: K2 from the layer
    B, T, D, heads, hd = SDPA_SHAPE
    model, x = attention_model(dev)
    cpu_m, _ = attention_model("cpu")
    want = cpu_m.evaluate(x)
    xd = x.to(dev)
    k2.reset_launches()
    got = model.evaluate(xd)
    torch.cuda.synchronize()
    launches = dict(k2.LAUNCHES)
    check(launches == {"fwd": 1, "dq": 0, "dkv": 0},
          f"the attention layer launched K2 {launches}")
    err = rel_err(got, want)
    check(err <= CLS_BF16, f"attention model bf16 card vs CPU {err}")
    ms, _ = median_ms(lambda: model.evaluate(xd), 5)
    lines.append(f"Model(LayerNorm, ScaledDotProductAttention({heads}, {hd},"
                 f" causal), Add) B {B} x T {T} x {D} bf16: K2 launches "
                 f"{launches}, card vs CPU {err:.3g} (limit {CLS_BF16}), "
                 f"{ms:.3f} ms")

    # the recurrences
    Bn, Tn, Wn = RNN_SHAPE
    xr = torch.from_numpy(rng.normal(0, 1, (Bn, Tn, Wn)).astype(np.float32))
    for layer in (L.LSTM(Wn), L.LSTM(Wn, bidirectional=True), F.GRU(Wn)):
        p, s, _ = layer.init(torch.Generator().manual_seed(5), (Bn, Tn, Wn))

        def run(t, layer=layer, p=p, s=s):
            pd = {k: v.to(t.device) for k, v in p.items()}
            with torch.no_grad():
                return layer.apply(pd, s, t)[0]
        errs, ms = card_vs_cpu(layer.name, run, [xr], dev)
        lines.append(f"{type(layer).__name__}"
                     f"{'(bi)' if getattr(layer, 'bidirectional', 0) else ''}"
                     f" {Bn} x {Tn} x {Wn}: {errs[0]:.3g} ({ms:.2f} ms)")

    # convolution transpose, norms, upsample, roi_align
    c = FMAP_SHAPE[-1]
    fm = torch.from_numpy(rng.normal(0, 1, FMAP_SHAPE).astype(np.float32))
    wt = torch.from_numpy(rng.normal(0, 0.05, (c, 3, 3, c)).astype(
        np.float32))
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    bi = torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32))
    cases = {
        "conv2d_transpose s2": lambda t, w: ops.conv2d_transpose(
            t, w, stride=(2, 2)),
        "layer_norm": lambda t, s, b: ops.layer_norm(t, s, b),
        "group_norm(32)": lambda t, s, b: ops.group_norm(t, s, b, 32),
        "rmsnorm": lambda t, s: ops.rmsnorm(t, s),
        "upsample bilinear 2x": lambda t: ops.upsample(t, 2.0, 2.0),
        "upsample nearest 1.5x": lambda t: ops.upsample(t, 1.5, 1.5,
                                                        "nearest"),
    }
    args = {"conv2d_transpose s2": [fm, wt], "layer_norm": [fm, sc, bi],
            "group_norm(32)": [fm, sc, bi], "rmsnorm": [fm, sc],
            "upsample bilinear 2x": [fm], "upsample nearest 1.5x": [fm]}
    for name, fn in cases.items():
        errs, ms = card_vs_cpu(name, fn, args[name], dev)
        lines.append(f"{name} {FMAP_SHAPE}: {errs[0]:.3g} ({ms:.3f} ms)")
    rois = torch.from_numpy(np.concatenate([
        rng.uniform(0, 0.7, (ROIS, 2)), rng.uniform(0.05, 0.3, (ROIS, 2))],
        1).astype(np.float32))
    errs, ms = card_vs_cpu("roi_align", lambda t, r: ops.roi_align(
        t, r, 7, 7), [fm[0], rois], dev)
    lines.append(f"roi_align {ROIS} rois 7x7 of {FMAP_SHAPE[1:]}: "
                 f"{errs[0]:.3g} ({ms:.2f} ms)")
    boxes = torch.from_numpy(np.concatenate([
        rng.uniform(0, 1300, (NMS_BOXES, 2)),
        rng.uniform(10, 200, (NMS_BOXES, 2))], 1).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, NMS_BOXES).astype(
        np.float32))
    order, keep = ops.nms(boxes, scores, 0.5)
    order_d, keep_d = ops.nms(boxes.to(dev), scores.to(dev), 0.5)
    check(torch.equal(order, order_d.cpu()) and torch.equal(
        keep, keep_d.cpu()), "nms: the card's order or keep differs")
    ms, _ = median_ms(lambda: ops.nms(boxes.to(dev), scores.to(dev), 0.5), 3)
    lines.append(f"nms {NMS_BOXES} boxes: order and keep equal "
                 f"({int(keep.sum())} kept, {ms:.2f} ms)")

    # the MoE forward
    cfg = moe.MoEConfig(**MOE)
    mp = moe.init(torch.Generator().manual_seed(7), cfg, device="cpu")
    xt = torch.from_numpy(rng.normal(0, 1, (MOE_TOKENS, cfg.dim)).astype(
        np.float32))
    out_c, aux_c = moe.forward(mp, cfg, xt)
    mpd = {k: v.to(dev) for k, v in mp.items()}
    out_d, aux_d = moe.forward(mpd, cfg, xt.to(dev))
    tok = ((out_d.cpu() - out_c).abs().amax(-1)
           <= NN_F32 * float(out_c.abs().max()))
    agree = float(tok.float().mean())
    aux_err = abs(float(aux_d) - float(aux_c)) / abs(float(aux_c))
    check(agree >= MOE_AGREE and aux_err <= NN_F32,
          f"MoE: {agree:.5f} of tokens agree, aux err {aux_err:.3g}")
    ms, _ = median_ms(lambda: moe.forward(mpd, cfg, xt.to(dev)), 3)
    lines.append(f"MoE {MOE}, {MOE_TOKENS} tokens: {int(tok.sum())} "
                 f"tokens within {NN_F32} (limit {MOE_AGREE} of them), aux "
                 f"err {aux_err:.3g} ({ms:.2f} ms)")

    # depalettize on the card, LSSC
    for gname in ("palettize_f32_q4.bin", "palettize_f32_q5.bin",
                  "palettize_f16_q8.bin"):
        raw = open(os.path.join(DATA, gname), "rb").read()
        datatype, qbits, nb, n = struct.unpack("<4i", raw[:16])
        (sz,) = struct.unpack("<q", raw[16:24])
        ref = np.frombuffer(raw[24 + sz:], {0x20000: np.float16,
                                            0x04000: np.float32}[datatype])
        dec = palettize.depalettize_device(raw[24:24 + sz], datatype, n,
                                           qbits, nb, device=dev)
        check(dec.device.type == "cuda" and np.array_equal(
            dec.cpu().numpy(), ref), f"depalettize_device {gname}")
    lines.append("depalettize_device: the three goldens equal the C output")
    act = torch.from_numpy(rng.normal(0, 2, LSSC_SHAPE).astype(np.float32))
    codes_c = compression.lssc_compress(act)
    codes_d = compression.lssc_compress(act.to(dev))
    check(all(torch.equal(c, d.cpu()) for c, d in zip(codes_c, codes_d)),
          "LSSC codes differ between the card and the CPU")
    back_c = compression.lssc_decompress(*codes_c, act.shape)
    back_d = compression.lssc_decompress(*codes_d, act.shape)
    check(torch.equal(back_c, back_d.cpu()), "LSSC decompress differs")
    lines.append(f"LSSC {LSSC_SHAPE}: codes and decompressed values card = "
                 f"CPU")

    # control flow
    def newton(v):
        return control_flow.while_loop(
            lambda c: bool((c[0] * c[0] - v).abs().max() > 1e-4 * v.max())
            and int(c[1]) < 50,
            lambda c: ((c[0] + v / c[0]) / 2, c[1] + 1),
            (torch.ones_like(v), torch.zeros((), dtype=torch.int64,
                                             device=v.device)))
    v = torch.from_numpy(rng.uniform(1, 100, 1000).astype(np.float32))
    (r_c, n_c), (r_d, n_d) = newton(v), newton(v.to(dev))
    check(int(n_c) == int(n_d) and rel_err(r_d, r_c) <= NN_F32,
          "while_loop: the card's iterations or roots differ")
    branches = [lambda t: t + 1, lambda t: t * t, lambda t: -t]
    for i in (-1, 1, 5):
        check(torch.equal(control_flow.case_of(torch.tensor(i, device=dev),
                                               branches, v.to(dev)).cpu(),
                          control_flow.case_of(i, branches, v)),
              f"case_of({i}) differs")
    lines.append(f"while_loop (Newton, {int(n_d)} steps) and case_of: card "
                 f"= CPU")
    log(30, "; ".join(lines) + f"; float32 limit {NN_F32}; {card}")

    def profile():
        k2.reset_launches()
        w = device_window(lambda: model.evaluate(xd), 1)
        fwd = sum(c for k, c in w["counts"].items() if "fwd_sm90_kernel" in k)
        check(fwd == 1 and k2.LAUNCHES["fwd"] == 1, f"the attention layer's "
              f"evaluate under torch.profiler: {fwd} fwd_sm90_kernel "
              f"launches among {w['events']} device events, K2 launches "
              f"{dict(k2.LAUNCHES)}")
        log(30, f"the attention model's evaluate under torch.profiler: "
                f"{fwd} fwd_sm90_kernel launch among {w['events']} device "
                f"events, K2 launches {dict(k2.LAUNCHES)}; {card}")
    return launches["fwd"], profile


def attention_model(dev, shape=SDPA_SHAPE):
    """Phase 30's graph model: LayerNorm, causal ScaledDotProductAttention
    and a residual Add at ``shape`` (B, T, d_model, heads, head dim),
    seeded, built on ``dev``."""
    from ccv_tpu_torch.nn import functional as F
    from ccv_tpu_torch.nn import layers as L
    B, T, D, heads, hd = shape
    inp = F.Input()
    h = L.LayerNorm(name="ln")(inp)
    a = L.ScaledDotProductAttention(heads, hd, is_causal=True)(h)
    model = F.Model([inp], [F.Add()(inp, a)], name="attention")
    model.build((B, T, D), torch.Generator().manual_seed(4), device=dev)
    x = torch.from_numpy(np.random.default_rng(30).normal(
        0, 1, (B, T, D)).astype(np.float32)).to(torch.bfloat16)
    return model, x


def fit_model(dev, dtype, plain, rate=TRAIN_RATE, shape=SDPA_SHAPE):
    """Phase 31's path B model: attention_model's weights and a layer norm
    bias from seed 31, compiled with adamw(rate) and "mse". With ``plain``
    the attention takes the plain route (the control). Returns (model,
    inputs in ``dtype``, float32 fits)."""
    from ccv_tpu_torch.nn import optimizers
    B, T, D, _, _ = shape
    model, _ = attention_model(dev, shape)
    ln = str(model.order[0].uid)
    rng = np.random.default_rng(31)
    model.params[ln]["bias"] = torch.from_numpy(rng.uniform(
        -0.1, 0.1, D).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(0, 1, (B, T, D)).astype(np.float32))
    y = torch.from_numpy(rng.normal(0, 1, (B, T, D)).astype(np.float32))
    model.compile(optimizers.adamw(rate=rate), "mse")
    return model, x.to(dev, dtype), y.to(dev)


@contextlib.contextmanager
def plain_attention_route(plain):
    """Within the block, with ``plain``, the attention layer takes the
    plain route on the card: ``layers.attention_route`` is patched (the
    package has no switch for it; the control of the checks only)."""
    from ccv_tpu_torch.nn import layers
    route = layers.attention_route
    if plain:
        layers.attention_route = lambda device_type, t: "plain"
    try:
        yield
    finally:
        layers.attention_route = route


def fit_gate_run(k2, dev, dtype, plain, shape=SDPA_SHAPE):
    """One path B fit from the carried weights: (loss, {name: the fit's
    gradient}, (worst update distance from AdamW's first step, its leaf,
    the smallest move of a leaf), all by max |.| over a tensor's largest
    magnitude); checks the K2 launches of the fit (1 / 1 / 1 in the design
    of ``dtype`` at the shape's head dim, none on the plain route)."""
    from ccv_tpu_torch.nn import optimizers
    model, x, y = fit_model(dev, dtype, plain, shape=shape)
    pos = {str(n.uid): i for i, n in enumerate(model.order)}
    keys = [f"{pos[u]}/{model.order[pos[u]].layer.name}/{k}"  # leaves order
            for u in sorted(model.params) for k in sorted(model.params[u])]
    seen, update = {}, model.opt.update

    def spy(grads, state, params):
        seen["grads"] = [g.clone() for g in grads]
        seen["before"] = [p.clone() for p in optimizers.leaves(params)]
        return update(grads, state, params)
    model.opt = dataclasses.replace(model.opt, update=spy)
    with plain_attention_route(plain):
        k2.reset_launches()
        loss = model.fit(x, y)
        torch.cuda.synchronize()
    n = 0 if plain else 1
    check(k2.LAUNCHES == {"fwd": n, "dq": n, "dkv": n} and all(
        k2.DESIGN_LAUNCHES[key][k2._design(key, dtype, shape[4])] == n
        for key in k2.LAUNCHES),
        f"path B fit ({dtype}, plain={plain}) launched K2 {k2.LAUNCHES}, "
        f"by design {k2.DESIGN_LAUNCHES}")
    h = model.opt.hyper
    want = {k: optimizers.adamw_step(
        g, p, torch.zeros_like(p), torch.zeros_like(p), 1, rate=h["rate"],
        scale=h["scale"], beta1=h["beta1"], beta2=h["beta2"],
        decay=h["decay"], epsilon=h["epsilon"])[0]
        for k, g, p in zip(keys, seen["grads"], seen["before"])}
    upd = rel_dist(dict(zip(keys, optimizers.leaves(model.params))), want)
    moved = rel_dist(dict(zip(keys, seen["before"])), want)
    wu, wm = max(upd, key=upd.get), min(moved, key=moved.get)
    check(moved[wm] > TRAIN_PARAM_REL, f"path B fit ({dtype}, plain={plain})"
          f": {wm} moves {moved[wm]:.3g} of its largest magnitude, within "
          f"the update gate {TRAIN_PARAM_REL}")
    check(upd[wu] <= TRAIN_PARAM_REL, f"path B fit ({dtype}, plain={plain})"
          f": {wu} {upd[wu]:.3g} of its largest magnitude from AdamW's "
          f"first step of the fit's gradients")
    return loss, dict(zip(keys, seen["grads"])), (upd[wu], wu, moved[wm])


def rel_dist(a, b):
    """{name: max |a - b| / max |b|}, in float64 on the CPU."""
    out = {}
    for n, want in b.items():
        want = want.detach().double().cpu()
        got = a[n].detach().double().cpu()
        out[n] = float((got - want).abs().max()
                       / want.abs().max().clamp_min(1e-300))
    return out


def bf16_fit_gate(what, kernel_run, plain_run, f32_grads):
    """Phase 31's bf16 gate on two ``fit_gate_run`` results, the bf16 fit
    through K2 and on the plain route: the losses within LM_LOSS_REL, and
    the kernel fit's gradients no farther from the float32 plain fit's
    (``f32_grads``) than BF16_GRAD_RATIO times the plain bf16 fit's worst
    distance, or K2_BF16. Returns (the kernel fit's worst distance, its
    leaf, the plain fit's worst distance, its leaf, the bound)."""
    (lk, gk, _), (lp, gp, _) = kernel_run, plain_run
    kf, pf = rel_dist(gk, f32_grads), rel_dist(gp, f32_grads)
    wk, wp = max(kf, key=kf.get), max(pf, key=pf.get)
    bound = max(K2_BF16, BF16_GRAD_RATIO * pf[wp])
    check(np.isfinite(lk) and abs(lk - lp) <= LM_LOSS_REL * abs(lp),
          f"{what} bf16 fit loss {lk} with K2, {lp} plain")
    check(kf[wk] <= bound, f"{what} bf16 kernel fit: gradient {wk} "
          f"{kf[wk]:.3g} of its largest magnitude from the float32 fit "
          f"(bound {bound:.3g})")
    return kf[wk], wk, pf[wp], wp, bound


def fit_path(dev, card, k2, roofline):
    """Phase 31, path B: ``Model.fit`` of the attention model. Gates in
    float32 and bf16 (kernels against the plain route), then the bf16 fit
    timed (the main path: its K2 launches counted from 0), the plain
    route's beside it, and K2 alone at the model's shape. Returns (result,
    profile)."""
    B, T, D, heads, hd = SDPA_SHAPE
    runs, f32_ran = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        for plain in (False, True):
            runs[(dt, plain)] = fit_gate_run(k2, dev, dt, plain)
            if dt == torch.float32 and not plain:  # its launches by design
                f32_ran = {key: {d: n for d, n in c.items() if n}
                           for key, c in k2.DESIGN_LAUNCHES.items()}
    (lk, gk, _), (lp, gp, _) = (runs[(torch.float32, False)],
                                runs[(torch.float32, True)])
    g_rel = rel_dist(gk, gp)
    wg = max(g_rel, key=g_rel.get)
    upd = max(r[2] for r in runs.values())
    step = min(r[2][2] for r in runs.values())
    loss_rel = abs(lk - lp) / abs(lp)
    check(np.isfinite(lk) and loss_rel <= TRAIN_LOSS_REL, f"path B float32 "
          f"fit loss {lk} with K2, {lp} plain")
    check(g_rel[wg] <= TRAIN_GRAD_REL, f"path B float32 gradient {wg} "
          f"{g_rel[wg]:.3g} of its largest magnitude from the plain route's")
    lk16, lp16 = runs[(torch.bfloat16, False)][0], runs[(torch.bfloat16,
                                                            True)][0]
    k16, wk16, p16, wp16, bound = bf16_fit_gate(
        "path B", runs[(torch.bfloat16, False)], runs[(torch.bfloat16, True)],
        gp)
    log(31, f"path B, Model(LayerNorm, ScaledDotProductAttention({heads}, "
            f"{hd}, causal), Add) B {B} x T {T} x {D} under compile(adamw, "
            f"'mse'), one fit from the same weights and batch, K2 against "
            f"the plain route: float32 ({f32_ran}) loss {lk:.7f} / {lp:.7f} "
            f"(rel {loss_rel:.3g}, limit {TRAIN_LOSS_REL}), gradients within "
            f"{g_rel[wg]:.3g} of their largest magnitude (worst {wg}, limit "
            f"{TRAIN_GRAD_REL}); each of the four fits' updates within "
            f"{upd[0]:.3g} of AdamW's first step of its gradients (worst "
            f"{upd[1]}, limit {TRAIN_PARAM_REL}; rate {TRAIN_RATE}, every "
            f"tensor moves at least {step:.3g}); bf16 "
            f"(wgmma-tma) loss {lk16:.6f} / {lp16:.6f}, gradients from the "
            f"float32 plain fit: K2 {k16:.3g} (worst {wk16}), plain "
            f"{p16:.3g} (worst {wp16}), bound {bound:.3g}; K2 launches "
            f"a fit 1 / 1 / 1, none on the plain route")

    # the main path: bf16 fits timed, K2's launches counted from 0
    model, x, y = fit_model(dev, torch.bfloat16, False, rate=1e-4)
    k2.reset_launches()
    ms, all_ms = median_ms(lambda: model.fit(x, y), TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(k2.LAUNCHES)
    n = TRAIN_STEPS + 1
    check(launches == {"fwd": n, "dq": n, "dkv": n} and all(
        k2.DESIGN_LAUNCHES[k]["wgmma-tma"] == n for k in launches),
        f"path B's {n} fits launched K2 {launches}, by design "
        f"{k2.DESIGN_LAUNCHES}")
    plain_model, _, _ = fit_model(dev, torch.bfloat16, True, rate=1e-4)
    with plain_attention_route(True):
        plain_ms, _ = median_ms(lambda: plain_model.fit(x, y), TRAIN_STEPS)
    del plain_model
    # K2 alone at the model's attention shape, in turns with the library
    shape = (B * heads, T, T, hd, True)
    rng = np.random.default_rng(31)
    q, k, v, do = k2_inputs(shape, torch.bfloat16, dev, rng)
    scale = 1.0 / np.sqrt(hd)
    o, lse = k2.flash_fwd(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale, True)
    from ccv_tpu_torch.bin.k2_trial import library_calls
    lib_fwd, lib_bwd = library_calls(q, k, v, do, scale, b=B)
    kern = {}
    for key, fn, plain_fn, lib in (
            ("fwd", lambda: k2.flash_fwd(q, k, v, scale, True),
             lambda: k2.flash_fwd_ref(q, k, v, scale, True), lib_fwd),
            ("dq", lambda: k2.flash_dq(*bwd), lambda: k2.flash_dq_ref(*bwd),
             lib_bwd),
            ("dkv", lambda: k2.flash_dkv(*bwd),
             lambda: k2.flash_dkv_ref(*bwd), lib_bwd)):
        t = [time_cuda(fn, 20), time_cuda(lib, 20), time_cuda(lib, 20),
             time_cuda(fn, 20)]
        flop, nbytes = k2.flash_work(key, *shape, torch.bfloat16)
        bound_ms, by = roofline.bound_ms(flop, nbytes, "bf16")
        kern[key] = dict(ms=(t[0] + t[3]) / 2, library_ms=(t[1] + t[2]) / 2,
                         plain_ms=time_cuda(plain_fn, 3), bound_ms=bound_ms,
                         bound_by=by)
    res = dict(ms=ms, plain_ms=plain_ms, launches=launches, steps=n,
               kernels=kern, shape=list(shape), f32_grad=g_rel[wg],
               bf16_grad=k16, bf16_plain_grad=p16, f32_launches=f32_ran)
    log(31, f"path B bf16 fit (adamw 1e-4): median {ms:.3f} ms a step (min "
            f"{min(all_ms):.3f}, max {max(all_ms):.3f}, n={TRAIN_STEPS} after "
            f"a warm-up), the plain route {plain_ms:.3f} ms; K2 launches over "
            f"the {n} fits {launches} (wgmma-tma); K2 alone at {shape} bf16 "
            f"(CUDA events, 2 x 20 in turns with the library): " + "; ".join(
                f"{key} {r['ms']:.4f} ms (library {r['library_ms']:.4f}, "
                f"plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} by "
                f"{r['bound_by']})" for key, r in kern.items()) + f"; {card}")

    def profile():
        w = device_window(lambda: model.fit(x, y), 1)
        got = {key: sum(c for name, c in w["counts"].items()
                        if f"{key}_sm90_kernel" in name)
               for key in ("fwd", "dq", "dkv")}
        check(got == {"fwd": 1, "dq": 1, "dkv": 1}, f"path B's fit under "
              f"torch.profiler: K2 kernels by name {got} among "
              f"{w['events']} device events")
        res.update(busy_ms=w["busy"], wall_ms=w["wall"],
                   idle=1 - w["busy"] / w["wall"])
        log(31, f"path B bf16 fit under torch.profiler: fwd_sm90_kernel, "
                f"dq_sm90_kernel, dkv_sm90_kernel {got} among {w['events']} "
                f"device events; busy {w['busy']:.3f} ms of a {w['wall']:.3f} "
                f"ms wall (idle {1 - w['busy'] / w['wall']:.3f}); largest: "
                f"{top_kernels(w['by_name'])}; {card}")
    return res, profile


def coco_leaf_names(trainer):
    """Names of a coco Trainer's parameter and batch-norm state leaves, in
    ``leaves()`` order, by topological position (node uids, and so the
    order of their sorted keys, differ from build to build)."""
    fpn = trainer.fpn
    pos = {str(n.uid): i for i, n in enumerate(fpn.order)}
    params = [f"fpn/{pos[u]}/{fpn.order[pos[u]].layer.name}/{k}"
              for u in sorted(fpn.params) for k in sorted(fpn.params[u])]
    params += [f"rpn/{k}" for k in sorted(trainer.params["rpn"])]
    states = [f"{pos[u]}/{k}" for u in sorted(trainer.state)
              for k in sorted(trainer.state[u])]
    return params, states


def coco_step_grads(dtype, device):
    """(loss, {name: gradient}, {name: batch-norm statistic after the
    step}) of one coco step at COCO_CPU on ``device`` in ``dtype``
    (``Trainer.grads``): the weights drawn in float32 from the trainer's
    seeds, then cast; scenes from seed 31, the anchor selection from seed
    32."""
    from ccv_tpu_torch.bin import coco
    from ccv_tpu_torch.nn import optimizers
    b, h, w = COCO_CPU
    rng = np.random.default_rng(31)
    scenes = [coco.synthetic_scene(rng, h, w) for _ in range(b)]
    t = coco.Trainer(b, h, w, select_count=COCO_SELECT, device=device,
                     dtype=dtype)
    host = t.batch(scenes, np.random.default_rng(32))
    loss, _acc, grads, state = t.grads(*t.to_device(*host))
    pnames, snames = coco_leaf_names(t)
    return (float(loss), dict(zip(pnames, grads)),
            dict(zip(snames, optimizers.leaves(state))))


def coco_card_vs_cpu(dev, card):
    """Phase 31, path A's gate: the coco step at COCO_CPU, card against the
    CPU from the same weights (seeded on the CPU) and batch, in float64
    (loss, every gradient leaf by leaf, batch-norm statistics) and in
    float32 (loss, batch-norm statistics; each leaf's gradient distance
    from the CPU's float64 one printed, card beside CPU)."""
    check(not (torch.backends.cuda.matmul.allow_tf32
               or torch.backends.cudnn.allow_tf32), "TF32 is on")
    runs = {}
    for dtype in (torch.float64, torch.float32):
        for where in ("cpu", dev):
            t0 = time.perf_counter()
            runs[(dtype, str(where))] = coco_step_grads(dtype, where)
            if where == "cpu" and dtype == torch.float32:
                cpu_s = time.perf_counter() - t0
    res = {}
    for dtype in (torch.float64, torch.float32):
        (lc, gc, sc), (ld, gd, sd) = (runs[(dtype, "cpu")],
                                      runs[(dtype, str(dev))])
        loss_rel = abs(ld - lc) / abs(lc)
        s_err = max(rel_dist(sd, sc).values())
        check(np.isfinite(ld) and loss_rel <= COCO_LOSS_REL, f"coco step "
              f"({dtype}) loss {ld} on the card, {lc} on the CPU")
        check(all(bool(torch.isfinite(g).all()) for g in gd.values()),
              f"coco step ({dtype}) gradients on the card not finite")
        check(s_err <= COCO_BN_REL, f"coco step ({dtype}) batch-norm "
              f"statistics: card vs CPU {s_err:.3g} > {COCO_BN_REL}")
        res[dtype] = dict(loss=ld, loss_cpu=lc, loss_rel=loss_rel, bn=s_err,
                          grads=gd, grads_cpu=gc, n_stats=len(sd))
    r64, r32 = res[torch.float64], res[torch.float32]
    d64 = rel_dist(r64["grads"], r64["grads_cpu"])
    w64 = max(d64, key=d64.get)
    check(d64[w64] <= COCO_GRAD_REL, f"coco step (float64) gradient {w64} on "
          f"the card {d64[w64]:.3g} of its largest magnitude from the CPU's")
    g64 = r64["grads_cpu"]
    d_card = rel_dist(r32["grads"], g64)
    d_cpu = rel_dist(r32["grads_cpu"], g64)
    wd, wc = max(d_card, key=d_card.get), max(d_cpu, key=d_cpu.get)
    ratio = {n: d_card[n] / max(d_cpu[n], 1e-300) for n in g64}
    wr = max(ratio, key=ratio.get)
    over = sum(d > COCO_GRAD_REL for d in d_card.values())
    over_cpu = sum(d > COCO_GRAD_REL for d in d_cpu.values())
    card_cpu = max(rel_dist(r32["grads"], r32["grads_cpu"]).values())
    log(31, f"path A, the coco step (ResNet50-v1d-FPN + RPN, training batch "
            f"norm, {COCO_SELECT} anchors) at {COCO_CPU}, card against the "
            f"CPU from the same weights and batch. float64: loss "
            f"{r64['loss']:.12f} / {r64['loss_cpu']:.12f} (rel "
            f"{r64['loss_rel']:.3g}, limit {COCO_LOSS_REL}), {len(d64)} "
            f"gradients each within {d64[w64]:.3g} of its largest magnitude "
            f"(worst {w64}, limit {COCO_GRAD_REL}), {r64['n_stats']} "
            f"batch-norm statistics within {r64['bn']:.3g} (limit "
            f"{COCO_BN_REL}). float32 (CPU {cpu_s:.1f} s): loss "
            f"{r32['loss']:.6f} / {r32['loss_cpu']:.6f} (rel "
            f"{r32['loss_rel']:.3g}, limit {COCO_LOSS_REL}), batch-norm "
            f"statistics within {r32['bn']:.3g} (limit {COCO_BN_REL}); each "
            f"leaf's gradient from the CPU's float64 one, by max |diff| over "
            f"that leaf's largest magnitude: card worst {d_card[wd]:.3g} "
            f"({wd}; the CPU there {d_cpu[wd]:.3g}), CPU worst "
            f"{d_cpu[wc]:.3g} ({wc}; the card there {d_card[wc]:.3g}), "
            f"largest ratio card / CPU {ratio[wr]:.3g} ({wr}: "
            f"{d_card[wr]:.3g} / {d_cpu[wr]:.3g}), leaves beyond "
            f"{COCO_GRAD_REL}: card {over}, CPU {over_cpu} of {len(g64)}; "
            f"card against CPU float32 {card_cpu:.3g}; {card}")


def coco_f32_gap(dev, card):
    """Phase 31: how far the float32 coco step's loss lies from the float64
    one on the card, at tests/test_torch_coco.py::test_trainer_float64_step's
    input (64 x 64, B 1, 32 anchors, scene seed 31, selection seed 32),
    beside which that test's F32_LOSS_GAP was set."""
    from ccv_tpu_torch.bin import coco
    scene = coco.synthetic_scene(np.random.default_rng(31), 64, 64)
    loss = {}
    for dtype in (torch.float32, torch.float64):
        t = coco.Trainer(1, 64, 64, select_count=32, device=dev, dtype=dtype)
        args = t.to_device(*t.batch([scene], np.random.default_rng(32)))
        loss[dtype] = float(t.grads(*args)[0])
    f32, f64 = loss[torch.float32], loss[torch.float64]
    gap = abs(f32 - f64) / abs(f64)
    check(np.isfinite(gap), f"coco float32 loss {f32}, float64 {f64}")
    log(31, f"coco step at tests/test_torch_coco.py's float64 input (64 x 64,"
            f" B 1) on the card: float32 loss {f32!r} against float64 "
            f"{f64!r}, {gap:.4g} of it; {card}")
    return gap


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms, cuDNN's included, inside the block;
    the earlier settings come back after it. cuBLAS on one stream gives the
    same bits run after run, so its warning that CUBLAS_WORKSPACE_CONFIG is
    unset is not shown; the caller checks that two runs agree."""
    import warnings
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="(?s).*CUBLAS_WORKSPACE_CONFIG")
            yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = before[2]
        torch.backends.cudnn.benchmark = before[3]


def coco_path(dev, card):
    """Phase 31, path A timed: the coco step at B 2 x 800 x 1344, float32,
    from batches already on the card (median of COCO_STEPS after a
    warm-up), the host's batch assembly alone, and whole iterations
    (assembly, copy, step, loss read); peak memory; then the demo on the
    card, twice under deterministic algorithms. Returns (result, profile)."""
    from ccv_tpu_torch.bin import coco
    from ccv_tpu_torch.bin.lm_bench import peak_tflops
    from ccv_tpu_torch.models import resnet
    from ccv_tpu_torch.ops.kernels import roofline
    h, w = COCO_HW
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    t = coco.Trainer(COCO_B, h, w, select_count=COCO_SELECT, device=dev)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(33)
    scenes = [coco.synthetic_scene(rng, h, w) for _ in range(2 * COCO_B)]
    host_ms = []
    for i in range(3):
        t0 = time.perf_counter()
        host = t.batch(scenes[(i % 2) * COCO_B:(i % 2 + 1) * COCO_B], rng)
        host_ms.append((time.perf_counter() - t0) * 1000)
    batch = t.to_device(*host)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    ms, all_ms = median_ms(lambda: losses.append(t.step(*batch)[0]),
                           COCO_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"coco step losses {losses}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(COCO_STEPS):
        host = t.batch(scenes[(i % 2) * COCO_B:(i % 2 + 1) * COCO_B], rng)
        loss, _ = t.step(*t.to_device(*host))
        float(loss)
    e2e_ms = (time.perf_counter() - t0) * 1000 / COCO_STEPS
    flops = 3 * resnet.conv_flops(t.fpn)
    peak = roofline.PEAK_OPS_PER_S["f32"]
    res = dict(ms=ms, images_s=COCO_B * 1e3 / ms, mfu=flops / (ms / 1e3) / peak,
               mfu_bf16_peak=flops / (ms / 1e3) / (peak_tflops(dev) * 1e12),
               tflop=flops / 1e12, peak_gb=peak_gb,
               host_ms=float(np.median(host_ms)), e2e_ms=e2e_ms)
    log(31, f"path A, the coco step at B {COCO_B} x {h} x {w} float32 "
            f"({COCO_SELECT} anchors an image; built in {build_s:.1f} s): "
            f"median {ms:.2f} ms a step (min {min(all_ms):.2f}, max "
            f"{max(all_ms):.2f}, n={COCO_STEPS} after a warm-up, batch on the "
            f"card), {res['images_s']:.2f} images/s, {flops / 1e12:.3f} TFLOP "
            f"a step (3 x resnet.conv_flops), MFU {res['mfu']:.4f} of the "
            f"float32 ALU peak {peak / 1e12:.0f} TFLOP/s "
            f"(ops/kernels/roofline.py); peak memory {peak_gb:.2f} GiB "
            f"(max_memory_allocated); the host's batch assembly (rpn_gt, "
            f"select_anchors) median {res['host_ms']:.1f} ms; whole "
            f"iterations (assembly, copy, step, loss read) {e2e_ms:.2f} ms; "
            f"losses {[round(x, 4) for x in losses]}; {card}")

    # the demo, on the card, as tests/test_bin_coco.py runs bin/coco.py,
    # twice under deterministic algorithms
    runs = []
    with deterministic():
        for _ in range(2):
            t0 = time.perf_counter()
            code, lines = captured(lambda argv: coco.main(argv), DEMO_ARGS)
            runs.append(coco.main.losses)
            demo_s = time.perf_counter() - t0
    demo = runs[0]
    check(runs[1] == demo, f"coco --demo under deterministic algorithms: "
                           f"{demo} in one run, {runs[1]} in the next")
    check(len(demo) == 20 and all(np.isfinite(demo)) and demo[-1] < DEMO_LOSS,
          f"coco --demo losses {demo}")
    res.update(demo_losses=demo, demo_s=demo_s)
    log(31, f"python -m ccv_tpu_torch.bin.coco {' '.join(DEMO_ARGS)} on the "
            f"card under deterministic algorithms, twice: {demo_s:.1f} s a "
            f"run, losses {demo[0]:.4f} -> {demo[-1]:.4f} in both, equal to "
            f"the bit (limit {DEMO_LOSS}), '{lines[-1]}'")

    def profile():
        win = device_window(lambda: t.step(*batch), 1)
        res.update(busy_ms=win["busy"], wall_ms=win["wall"],
                   idle=1 - win["busy"] / win["wall"], span_ms=win["span"])
        log(31, f"the coco step at B {COCO_B} x {h} x {w} float32 under "
                f"torch.profiler (1 step, {win['events']} device events): "
                f"busy {win['busy']:.2f} ms over a wall of {win['wall']:.2f} "
                f"ms: idle share {1 - win['busy'] / win['wall']:.3f} (CUDA "
                f"events' span {win['span']:.2f} ms); largest: "
                f"{top_kernels(win['by_name'])}; {card}")
    return res, profile


def train_rest_path(dev, card):
    """Phase 31, the rest on the card against the CPU: an imdb_lstm fit,
    DynamicGraph.minimize, a micro Combine forward and backward, and
    Dataframe.iter(prefetch=2) onto the card."""
    from ccv_tpu_torch.bin import imdb_lstm
    from ccv_tpu_torch.bin.bin_imdb_shared import synthetic_corpus
    from ccv_tpu_torch.nn import micro, optimizers
    from ccv_tpu_torch.nn.dataframe import Dataframe
    from ccv_tpu_torch.nn.dynamic import DynamicGraph
    lines = []
    # imdb_lstm: one fit at the CLI's widths on the demo corpus; its
    # gradients within NN_F32, then Adam's first step as lm_two_layers
    # checks it (a gradient within float32 noise of 0 may take either sign)
    xs, ys = synthetic_corpus(np.random.default_rng(0), max_len=64)
    rate = 1e-3
    runs = {}
    for where in ("cpu", dev):
        net = imdb_lstm.build(200, 64, 32, 64, rate, torch.device(where))
        x = torch.from_numpy(xs[:32].astype(np.int64)).to(where)
        y = torch.from_numpy(ys[:32].astype(np.int64)).to(where)
        _, grads, _ = net._step(x, y)
        net._step_key[:] = 0
        runs[str(where)] = (net.fit(x, y), grads,
                            optimizers.leaves(net.params))
    (lc, gc, pc), (ld, gd, pd) = runs["cpu"], runs[str(dev)]
    g_err = max(rel_err(a, b) for a, b in zip(gd, gc))
    diffs = torch.cat([(a.cpu() - b).abs().flatten() for a, b in zip(pd, pc)])
    same = float((diffs <= 1e-6).float().mean())
    check(abs(ld - lc) <= NN_F32 * abs(lc) and g_err <= NN_F32,
          f"imdb_lstm fit: loss {ld} / {lc}, gradients {g_err:.3g}")
    check(float(diffs.max()) <= 2 * rate and same >= LM_SAME_SIGN,
          f"imdb_lstm parameters after Adam: max diff "
          f"{float(diffs.max()):.3g}, {same:.4f} equal")
    lines.append(f"imdb_lstm fit (B 32 x 64, dim 64): loss {ld:.6f} / "
                 f"{lc:.6f}, gradients within {g_err:.3g}, after Adam "
                 f"{same:.5f} of parameters equal (max diff "
                 f"{float(diffs.max()):.3g}, limit {2 * rate})")
    # DynamicGraph.minimize: two layers, three sgd steps (linear in the
    # gradients, so float32 noise stays noise)
    rng = np.random.default_rng(34)
    arrs = [rng.normal(0, s, shape).astype(np.float32) for s, shape in (
        (1, (64, 128)), (0.1, (128, 256)), (0.1, (256, 10)))]
    vals = {}
    for where in ("cpu", dev):
        g = DynamicGraph(device=where)
        x = g.constant(arrs[0])
        a, b = g.variable(arrs[1]), g.variable(arrs[2])
        opt, state = optimizers.sgd(rate=0.05, momentum=0.9), None
        for _ in range(3):
            g.reset_tape()
            hid = g.exec(lambda u, v: torch.tanh(u @ v), x, a)
            out = g.exec(lambda u, v: u @ v, hid, b)
            loss = g.exec(lambda v: (v * v).mean(), out)
            state = g.minimize(loss, opt, (a, b), state)
        vals[str(where)] = (a.value, b.value)
    d_err = max(rel_err(u, v) for u, v in zip(vals[str(dev)], vals["cpu"]))
    check(d_err <= NN_F32, f"DynamicGraph.minimize card vs CPU {d_err:.3g}")
    lines.append(f"DynamicGraph.minimize (64x128 @ 128x256 @ 256x10, 3 sgd "
                 f"steps): {d_err:.3g}")
    # micro: the reference's convolution from reindex / mul / sum
    xm, wm = micro.input(4), micro.input(4)
    shape = ["dA0", "dA1 - $kh + 1", "dA2 - $kw + 1", "$kh", "$kw", "dA3",
             "$kc"]
    yy = micro.reduce(micro.REDUCE_OP_SUM, [3, 4, 5], micro.binary(
        micro.BINARY_OP_MUL,
        micro.reindex(shape, [xm], ["i0", "i1 + i3", "i2 + i4", "i5"], xm),
        micro.reindex(shape, [xm], ["i6", "i3", "i4", "i5"], wm)))
    comb = micro.Combine([xm, wm], ["$kh", "$kw", "$kc"], [yy],
                         [micro.grad(yy), xm, wm],
                         [micro.grad(xm), micro.grad(wm)])
    xin = rng.random((2, 32, 32, 16), np.float32)
    win = rng.random((8, 3, 3, 16), np.float32)
    (fc,) = comb.interpret("forward", [xin, win], [3, 3, 8], device="cpu")
    (fd,) = comb.interpret("forward", [xin, win], [3, 3, 8], device=dev)
    dy = rng.normal(0, 1, tuple(fc.shape)).astype(np.float32)
    bc = comb.interpret("backward", [dy, xin, win], [3, 3, 8], device="cpu")
    bd = comb.interpret("backward", [dy, xin, win], [3, 3, 8], device=dev)
    m_err = max(rel_err(u, v) for u, v in zip([fd, *bd], [fc, *bc]))
    check(fd.device.type == "cuda" and m_err <= NN_F32,
          f"micro Combine card vs CPU {m_err:.3g}")
    lines.append(f"micro convolution Combine (2 x 32 x 32 x 16, 8 filters "
                 f"of 3 x 3) forward and backward: {m_err:.3g}")
    # Dataframe.iter(prefetch=2) onto the card
    imgs = rng.integers(0, 256, (64, 32, 32, 3)).astype(np.uint8)
    df = Dataframe.from_arrays(img=imgs, y=np.arange(64) % 10)
    df.map("f", lambda v: v.astype(np.float32) / 255, ["img"])
    df.one_hot("yh", "y", 10)
    df.shuffle(seed=5)
    want = list(df.batch(["f", "yh"], 16))
    got = list(df.iter(["f", "yh"], 16, prefetch=2, device=dev))
    check(len(got) == len(want) == 4 and all(
        g.device.type == "cuda" and np.array_equal(g.cpu().numpy(), w)
        for gb, wb in zip(got, want) for g, w in zip(gb, wb)),
        "Dataframe.iter onto the card: batches differ from the CPU's")
    lines.append("Dataframe.iter(prefetch=2) onto the card: 4 batches of 16 "
                 "bytes equal to the CPU's")
    log(31, "; ".join(lines) + f"; float32 limit {NN_F32}; {card}")


# -- phase 32: parallelism on torch.distributed -----------------------------

def par_entry(rank, fn, world, store, args):
    """A spawned rank: fn(rank, world, store, *args), its result saved for
    the parent."""
    sys.path.insert(0, ROOT)
    torch.save(fn(rank, world, store, *args), f"{store}.out{rank}")


def par_spawn(fn, world, tmp, *args):
    """fn on ``world`` spawned ranks; their results in rank order. A rank
    that raises or dies fails the run."""
    import torch.multiprocessing as mp
    store = os.path.join(tmp, fn.__name__)
    ctx = mp.start_processes(par_entry, args=(fn, world, store, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + PAR_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"phase 32: {fn.__name__} on {world} ranks "
                                 f"did not end in {PAR_TIMEOUT} s")
    return [torch.load(f"{store}.out{r}", weights_only=False)
            for r in range(world)]


def par_max_diff(a, b):
    """The largest |a - b| over two lists of tensors (0.0: equal bits)."""
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(a, b))


def par_wmt_corpus(tmp, sv, tv, n, max_len, rng):
    """wmt CLI arguments for a generated corpus of ``n`` sentence pairs of
    2 to ``max_len`` - 8 words and vocabularies of sv - 4 and tv - 4
    words (so the model's vocabularies are sv and tv)."""
    paths = {k: os.path.join(tmp, k) for k in ("sv", "tv", "src", "tgt")}
    for key, size, p in (("sv", sv, "s"), ("tv", tv, "t")):
        with open(paths[key], "w") as f:
            f.write("\n".join(f"{p}{i}" for i in range(size - 4)))
    for key, size, p in (("src", sv, "s"), ("tgt", tv, "t")):
        with open(paths[key], "w") as f:
            for _ in range(n):
                words = rng.integers(0, size - 4, rng.integers(2, max_len - 8))
                f.write(" ".join(f"{p}{w}" for w in words) + "\n")
    return ["--src", paths["src"], "--tgt", paths["tgt"], "--src-vocab",
            paths["sv"], "--tgt-vocab", paths["tv"]]


def par_nccl_one_rank(rank, world, store):
    """Phase 32 (a), in the one NCCL rank: see the comment at PAR_TIMED."""
    from ccv_tpu_torch.bin import wmt
    from ccv_tpu_torch.bin.wmt_grad_trial import synthetic_batch
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.nn import optimizers
    from ccv_tpu_torch.ops.kernels import flash_attention as k2
    from ccv_tpu_torch.parallel import distributed
    from ccv_tpu_torch.parallel import mesh as pmesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    check(distributed.init("nccl", f"file://{store}", 1, 0),
          "no NCCL process group")
    mesh = pmesh.make_mesh({"data": 1, "model": 1, "seq": 1}, dev)
    group = mesh.get_group("data")
    k2.build()
    T, sv, tv = S2S["max_len"], S2S["vocab_size"], S2S["tgt_vocab_size"]
    spad, tpad = sv - 1, tv - 1
    batch = tuple(torch.from_numpy(x).to(dev) for x in synthetic_batch(
        np.random.default_rng(31), WMT_B, T, sv, tv))
    cfg = s2s_config(dropout=0.0)

    def fresh():
        params = tfm.init_encoder_decoder(
            torch.Generator(device=dev).manual_seed(6), cfg)
        opt = optimizers.adam(rate=1e-4)
        return params, opt, opt.init(params)

    runs = {}
    for name, grp in (("plain", None), ("parallel", group),
                      ("control", None)):
        params, opt, state = fresh()
        k2.reset_launches()
        loss = wmt.train_step(params, opt, state, cfg, batch, spad, tpad,
                              None, group=grp)
        torch.cuda.synchronize()
        runs[name] = dict(
            loss=float(loss), launches=dict(k2.LAUNCHES),
            leaves=optimizers.leaves(params) + state.m + state.v,
            step=(lambda p=params, o=opt, s=state, g=grp: wmt.train_step(
                p, o, s, cfg, batch, spad, tpad, None, group=g)))
    plain, par, ctl = runs["plain"], runs["parallel"], runs["control"]
    res = dict(loss=plain["loss"], loss_parallel=par["loss"],
               loss_control=ctl["loss"],
               diff=par_max_diff(par["leaves"], plain["leaves"]),
               control=par_max_diff(ctl["leaves"], plain["leaves"]),
               launches=plain["launches"],
               launches_parallel=par["launches"],
               n_leaves=len(plain["leaves"]))
    for run in runs.values():
        del run["leaves"]

    # timed in turns: the un-parallel and the parallel step, each on its
    # own parameters
    ms = {"plain": [], "parallel": []}
    for _ in range(PAR_TIMED):
        for name in ms:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]["step"]()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1000)
    res.update(ms_plain=float(np.median(ms["plain"])),
               ms_parallel=float(np.median(ms["parallel"])))
    for name in ("parallel", "plain"):
        w = device_window(runs[name]["step"], 1)
        nccl = {k: v for k, v in w["by_name"].items() if "nccl" in k.lower()}
        res[name + "_window"] = dict(
            busy=w["busy"], wall=w["wall"],
            k2={key: sum(c for n, c in w["counts"].items()
                         if f"{key}_sm90_kernel" in n)
                for key in ("fwd", "dq", "dkv")},
            nccl_ms=sum(nccl.values()),
            nccl={k[:60]: w["counts"][k] for k in nccl},
            memcpy_ms=sum(v for k, v in w["by_name"].items()
                          if "memcpy" in k.lower()))

    # the CLI at the same widths on a generated corpus (dropout 0.1), with
    # and without --data-parallel 1
    argv = par_wmt_corpus(os.path.dirname(store), sv, tv, WMT_B, T,
                          np.random.default_rng(33))
    cli = {}
    for name, extra in (("plain", []), ("parallel", [
            "--data-parallel", "1", "--dist-backend", "nccl"])):
        loss, params = wmt.run(argv + extra)
        cli[name] = (loss, optimizers.leaves(params))
    res.update(cli_loss=cli["plain"][0], cli_loss_parallel=cli["parallel"][0],
               cli_diff=par_max_diff(cli["parallel"][1], cli["plain"][1]))
    torch.distributed.destroy_process_group()
    return res


def par_probe(rank, world, store):
    """Phase 32 (b)'s probe: each collective of PAR_COLLECTIVES on CUDA
    tensors over gloo, in turn: "ok", or what gloo raised (a rank that
    dies leaves its last "trying" line in ``store``.rank<r>.log)."""
    import datetime
    from ccv_tpu_torch.parallel import mesh as pmesh
    dist = torch.distributed
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", 0)
    x = torch.full((4,), rank + 1.0, device=dev)
    ops = {
        "allreduce": lambda: pmesh.comm_allreduce(x),
        "all_gather": lambda: pmesh.all_gather(x).reshape(-1),
        "send/recv": lambda: pmesh.ppermute(x, None, [(0, 1), (1, 0)]),
    }
    want = {"allreduce": [3.0] * 4, "all_gather": [1.0] * 4 + [2.0] * 4,
            "send/recv": [2.0 - rank] * 4}
    out = {}
    with open(f"{store}.rank{rank}.log", "w") as logf:
        for name in PAR_COLLECTIVES:
            logf.write(f"trying {name}\n")
            logf.flush()
            try:
                got = ops[name]().cpu().tolist()
                torch.cuda.synchronize()
            except RuntimeError as e:  # the backend's refusal, reported
                out[name] = f"{type(e).__name__}: {str(e)[:160]}"
            else:
                out[name] = "ok" if got == want[name] else f"wrong: {got}"
            logf.write(f"{name}: {out[name]}\n")
            logf.flush()
    dist.destroy_process_group()
    return out


def par_probe_pair(tmp):
    """The probe pair's answers, one dict a rank. A rank that dies in a
    collective (a backend reading a CUDA pointer on the host) names it in
    its log: that collective is answered with the death, those after it
    "not tried"."""
    import torch.multiprocessing as mp
    try:
        return par_spawn(par_probe, 2, tmp)
    except mp.ProcessExitedException as e:
        store = os.path.join(tmp, "par_probe")
        out = []
        for r in range(2):
            with open(f"{store}.rank{r}.log") as f:
                lines = f.read().splitlines()
            got = dict(line.split(": ", 1) for line in lines
                       if not line.startswith("trying "))
            for name in PAR_COLLECTIVES:
                if name not in got:
                    got[name] = (f"rank {e.error_index} died in it ({e})"
                                 if f"trying {name}" in lines
                                 else "not tried")
            out.append(got)
        return out


def par_stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def par_rel(got, want):
    """max |got - want| over max |want|, over lists of tensors."""
    return (max(float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want))
            / max(float(w.float().abs().max()) for w in want))


def par_timed(step, pmesh):
    """ms a step (forward and backward, host clock, synchronised, the mean
    of PAR_REPS after the checked one) and ``ppermute``'s staging copies a
    step (card to host and back; 0 on NCCL)."""
    pmesh.STAGED.update(copies=0, bytes=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_REPS):
        step()
    torch.cuda.synchronize()
    return dict(ms=(time.perf_counter() - t0) * 1000 / PAR_REPS,
                staged_copies=pmesh.STAGED["copies"] // PAR_REPS,
                staged_mb=pmesh.STAGED["bytes"] / PAR_REPS / 2 ** 20)


def par_checks(rank, world, store, taken, backend="gloo"):
    """Phase 32 (b)'s checks on ``world`` ranks, those whose collectives
    the backend took (``taken``); each returns its distances from the
    one-rank result, computed on every rank. gloo: every rank on the card
    0; nccl: rank r on card r (``--nccl-cards``), where the data-parallel
    step is also profiled for NCCL's allreduce."""
    from ccv_tpu_torch.bin import wmt
    from ccv_tpu_torch.bin.wmt_grad_trial import named_grads, synthetic_batch
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.nn import optimizers
    from ccv_tpu_torch.nn.model import _unflatten
    from ccv_tpu_torch.ops.kernels import flash_attention as k2
    from ccv_tpu_torch.parallel import distributed, pipeline
    from ccv_tpu_torch.parallel import mesh as pmesh
    from ccv_tpu_torch.parallel.sequence import ring_attention
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    check(distributed.init(backend, f"file://{store}", world, rank),
          f"no {backend} process group")
    k2.build()
    out = {}

    def data_parallel():
        mesh = pmesh.make_mesh({"data": world}, dev)
        T, sv, tv = S2S["max_len"], S2S["vocab_size"], S2S["tgt_vocab_size"]
        batch = tuple(torch.from_numpy(x).to(dev) for x in synthetic_batch(
            np.random.default_rng(31), WMT_B, T, sv, tv))
        cfg = s2s_config(layers=2, dtype=torch.float32, dropout=0.1)
        got = {}
        for name, grp in (("one", None), ("all", mesh.get_group("data"))):
            params = tfm.init_encoder_decoder(
                torch.Generator(device=dev).manual_seed(6), cfg)
            opt = optimizers.adam(rate=1e-4)
            state = opt.init(params)
            rows = batch if grp is None else tuple(
                x.chunk(world)[rank] for x in batch)
            loss = wmt.train_step(
                params, opt, state, cfg, rows, sv - 1, tv - 1,
                torch.Generator(device=dev).manual_seed(7), group=grp)
            got[name] = (float(loss), named_grads(params))
        (l1, g1), (l2, g2) = got["one"], got["all"]
        res = dict(loss=l1, loss_rel=abs(l2 - l1) / abs(l1),
                   grad_rel=par_rel(list(g2.values()), list(g1.values())))
        if backend == "nccl":  # NCCL's allreduce in a profiled step
            w = device_window(lambda: wmt.train_step(
                params, opt, state, cfg, rows, sv - 1, tv - 1,
                torch.Generator(device=dev).manual_seed(7), group=grp), 1)
            res.update(busy_ms=w["busy"], wall_ms=w["wall"], nccl_ms=sum(
                v for k, v in w["by_name"].items() if "nccl" in k.lower()))
        return res

    def lm_tp():
        """tp ``world`` against tp 1, from the same weights and ids: in float64
        (plain attention, as a control: K2 takes f32 and bf16) within
        PAR_F64_REL, and in float32 through K2 (2 / 2 / 2 launches a rank)
        no farther from the float64 step than PAR_F32_RATIO times the
        float32 tp 1 step lies."""
        from ccv_tpu_torch.bin import lm_bench
        mesh = pmesh.make_mesh({"model": world}, dev)
        B, T = PAR_LM_BT
        ids = torch.randint(0, PAR_LM["vocab_size"], (B, T + 1),
                            generator=torch.Generator().manual_seed(12)
                            ).to(dev)
        got = {}
        for dtype in (torch.float64, torch.float32):
            cfg = tfm.TransformerConfig(**PAR_LM, dropout=0.0, dtype=dtype)
            params = optimizers.tree_map(
                lambda p: p.detach().to(dtype).requires_grad_(True),
                tfm.init_lm(torch.Generator(device=dev).manual_seed(11),
                            cfg))
            places = tfm.shardings(params, mesh, cfg)
            with lm_bench.plain_attention(dtype == torch.float64):
                loss1 = tfm.cross_entropy(tfm.lm_forward(
                    params, cfg, ids[:, :-1]), ids[:, 1:])
                g1 = torch.autograd.grad(loss1, optimizers.leaves(params))
                local = tfm.shard_params(params, mesh, cfg)
                k2.reset_launches()
                loss2 = tfm.cross_entropy(tfm.lm_forward(
                    local, cfg, ids[:, :-1],
                    tensor=tfm.TensorSpec(mesh, "model")), ids[:, 1:])
                g2 = torch.autograd.grad(loss2, optimizers.leaves(local))
                launches = dict(k2.LAUNCHES)
            g1 = optimizers.leaves(optimizers.tree_zip(
                lambda g, pl: pmesh.local_shard(g, mesh, pl),
                _unflatten(params, iter(g1)), places))
            got[dtype] = (float(loss1.detach()), float(loss2.detach()),
                          [g.detach() for g in g1],
                          [g.detach() for g in g2], launches)
            del params, local, loss1, loss2
            torch.cuda.empty_cache()
        l1, l2, t1, t2, _ = got[torch.float64]
        f1, f2, s1, s2, launches = got[torch.float32]
        d1, d2 = par_rel(s1, t1), par_rel(s2, t1)
        return dict(loss=l1, loss_rel=abs(l2 - l1) / abs(l1),
                    grad_rel=par_rel(t2, t1),
                    f32_loss_rel=abs(f2 - f1) / abs(f1),
                    f32_tp1_from_f64=d1, f32_tp_from_f64=d2,
                    f32_ratio=d2 / d1, launches=launches)

    def ring_sp():
        mesh = pmesh.make_mesh({"seq": world}, dev)
        B, T = PAR_LM_BT
        H, D = PAR_LM["heads"], PAR_LM["head_dim"]
        gen = torch.Generator().manual_seed(13)
        q, k, v, w = (torch.randn((B, T, H, D), generator=gen).to(dev)
                      for _ in range(4))
        q, k, v = (a.requires_grad_(True) for a in (q, k, v))
        scale = 1.0 / D ** 0.5
        ref = tfm._sdpa_plain(q, k, v, scale, True, None, 0.0, None, False)
        g1 = torch.autograd.grad((ref * w).sum(), (q, k, v))
        half = slice(rank * T // world, (rank + 1) * T // world)
        ql, kl, vl = (a.detach()[:, half].clone().requires_grad_(True)
                      for a in (q, k, v))

        def step():
            got = ring_attention(ql, kl, vl, mesh, "seq", is_causal=True)
            return got, torch.autograd.grad((got * w[:, half]).sum(),
                                            (ql, kl, vl))
        got, g2 = step()
        return dict(out_rel=par_rel([got], [ref[:, half]]),
                    grad_rel=max(par_rel([a], [b[:, half]])
                                 for a, b in zip(g2, g1)),
                    **par_timed(step, pmesh))

    def gpipe():
        mesh = pmesh.make_mesh({"stage": world}, dev)
        gen = torch.Generator().manual_seed(14)
        d = PAR_LM["heads"] * PAR_LM["head_dim"]
        params = {"w": (torch.randn((world, d, d), generator=gen) * 0.03),
                  "b": (torch.randn((world, d), generator=gen) * 0.1)}
        params = {k: v.to(dev).requires_grad_(True)
                  for k, v in params.items()}
        x_mb = torch.randn((4, PAR_LM_BT[0], d), generator=gen).to(dev)
        ref = x_mb
        for s in range(world):
            ref = par_stage_fn({k: v[s] for k, v in params.items()}, ref)
        g1 = torch.autograd.grad((ref ** 2).sum(), list(params.values()))
        local = {k: v.detach()[rank:rank + 1].clone().requires_grad_(True)
                 for k, v in params.items()}
        def step():
            got = pipeline.gpipe(par_stage_fn, local, x_mb, mesh, "stage")
            return got, torch.autograd.grad((got ** 2).sum(),
                                            list(local.values()))
        got, g2 = step()
        return dict(out_rel=par_rel([got], [ref]),
                    grad_rel=par_rel(g2, [g[rank:rank + 1] for g in g1]),
                    **par_timed(step, pmesh))

    checks = dict(data_parallel=data_parallel, lm_tp=lm_tp, ring_sp=ring_sp,
                  gpipe=gpipe)
    for name, needs in PAR_NEEDS.items():
        if all(n in taken for n in needs):
            t0 = time.perf_counter()
            out[name] = checks[name]()
            out[name]["s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return out


def par_report(res, refused, where, card):
    """Log each phase 32 (b) check of ``res`` (the ranks' results) or its
    refusal, then fail if any check missed its gate."""
    failed = []
    for name, needs in PAR_NEEDS.items():
        if name not in res[0]:
            log(32, f"(b) {name}: refused by gloo on CUDA tensors ("
                    + ", ".join(c for c in needs if c in refused)
                    + "); left to a machine with two cards")
            continue
        if name == "lm_tp":
            n = PAR_LM["layers"]
            ok = all(g[name]["loss_rel"] <= PAR_F64_REL
                     and g[name]["grad_rel"] <= PAR_F64_REL
                     and g[name]["f32_ratio"] <= PAR_F32_RATIO
                     and g[name]["launches"] == {"fwd": n, "dq": n, "dkv": n}
                     for g in res)
        else:
            ok = all(g[name].get("loss_rel", 0.0) <= PAR_LOSS_REL
                     and g[name].get("out_rel", 0.0) <= PAR_GRAD_REL
                     and g[name]["grad_rel"] <= PAR_GRAD_REL for g in res)
        log(32, f"(b) {name} over {len(res)}, {where}, float32: "
                + "; ".join(", ".join(
                    f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in g[name].items()) for g in res)
                + f" (ranks 0 to {len(res) - 1}): "
                f"{'passed' if ok else 'FAILED'}; {card}")
        if not ok:
            failed.append(name)
    check(not failed, f"phase 32 (b): {failed} failed its gates")


def parallel_cards(n, card):
    """``chip_smoke.py --nccl-cards n``: phase 32 (b)'s checks on n NCCL
    ranks, one a card (the checks a single card's gloo ranks cannot run:
    ring attention and GPipe need send / recv), and NCCL's allreduce time
    in the data-parallel step."""
    check(torch.cuda.device_count() >= n, f"--nccl-cards {n}: "
          f"{torch.cuda.device_count()} card(s)")
    tmp = tempfile.mkdtemp(prefix="phase32-cards-")
    try:
        t0 = time.perf_counter()
        res = par_spawn(par_checks, n, tmp, list(PAR_COLLECTIVES), "nccl")
        par_report(res, {}, "NCCL ranks, one a card", card)
        log(32, f"(b) {time.perf_counter() - t0:.1f} s with the ranks' "
                f"start")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parallel_path(dev, card):
    """Phase 32: (a) one NCCL rank, (b) the probe and the checks on two
    gloo ranks (see the comment at PAR_TIMED); returns (a)'s results."""
    tmp = tempfile.mkdtemp(prefix="phase32-")
    try:
        t0 = time.perf_counter()
        (a,) = par_spawn(par_nccl_one_rank, 1, tmp)
        a_s = time.perf_counter() - t0
        dl = abs(a["loss_parallel"] - a["loss"])
        check(dl <= abs(a["loss_control"] - a["loss"])
              and dl <= PAR_LOSS_CAP * abs(a["loss"]),
              f"phase 32 (a): the world-1 wmt step's loss "
              f"{a['loss_parallel']} against {a['loss']} (control "
              f"{a['loss_control']})")
        check(a["diff"] <= a["control"], f"phase 32 (a): parameters and "
              f"moments {a['diff']} from the un-parallel step's, beyond the "
              f"control's {a['control']}")
        n = S2S["layers"]
        check(a["launches"] == a["launches_parallel"] == {
            "fwd": n, "dq": n, "dkv": n}, f"phase 32 (a): K2 launches "
              f"{a['launches_parallel']} (un-parallel {a['launches']})")
        win = a["parallel_window"]
        check(win["k2"] == {"fwd": n, "dq": n, "dkv": n},
              f"phase 32 (a): K2 by name in the profiled step {win['k2']}")
        check(a["cli_loss"] == a["cli_loss_parallel"]
              and a["cli_diff"] == 0.0, f"phase 32 (a): wmt --data-parallel "
              f"1 loss {a['cli_loss_parallel']} against {a['cli_loss']}, "
              f"parameters {a['cli_diff']} apart")
        plain_win = a["plain_window"]
        log(32, f"(a) one NCCL rank, mesh data 1 x model 1 x seq 1, the wmt "
                f"step at {s2s_name(s2s_config())}, B {WMT_B} x T "
                f"{S2S['max_len']}, bf16, dropout 0: --data-parallel 1 "
                f"against the un-parallel step: loss {a['loss_parallel']!r} "
                f"against {a['loss']!r} (control {a['loss_control']!r}), "
                f"{a['n_leaves']} parameter and Adam moment "
                f"tensors {'equal to the bit' if a['diff'] == 0 else 'max diff ' + repr(a['diff'])}"
                f" (control, a second un-parallel step: {a['control']!r}); K2 "
                f"launches {a['launches_parallel']} (un-parallel "
                f"{a['launches']}); the CLI, wmt --data-parallel 1 "
                f"--dist-backend nccl on a generated corpus (dropout 0.1): "
                f"loss {a['cli_loss_parallel']!r} = {a['cli_loss']!r}, "
                f"parameters equal to the bit; {card}")
        log(32, f"(a) step ms (host clock, median of {PAR_TIMED} in turns): "
                f"--data-parallel 1 {a['ms_parallel']:.3f}, un-parallel "
                f"{a['ms_plain']:.3f}; under torch.profiler (1 step): device "
                f"busy {win['busy']:.3f} ms of a {win['wall']:.3f} ms wall, "
                f"idle {1 - win['busy'] / win['wall']:.3f} (un-parallel: busy "
                f"{plain_win['busy']:.3f} of {plain_win['wall']:.3f}, idle "
                f"{1 - plain_win['busy'] / plain_win['wall']:.3f}); the "
                f"allreduce: none at world 1 (a group of one rank splits "
                f"nothing), NCCL kernels in the window {win['nccl'] or 'none'}"
                f" {win['nccl_ms']:.3f} ms a step, copies {win['memcpy_ms']:.3f}"
                f" ms (un-parallel {plain_win['memcpy_ms']:.3f}); K2 by name "
                f"{win['k2']}; {a_s:.1f} s with the rank's start; {card}")

        t0 = time.perf_counter()
        probe = par_probe_pair(tmp)
        taken = [c for c in PAR_COLLECTIVES
                 if all(p[c] == "ok" for p in probe)]
        refused = {c: probe[0][c] if probe[0][c] != "ok" else probe[1][c]
                   for c in PAR_COLLECTIVES if c not in taken}
        log(32, f"(b) gloo on CUDA tensors, two ranks on the card: " + "; ".join(
            f"{c} {'taken' if c in taken else 'refused: ' + refused[c]}"
            for c in PAR_COLLECTIVES))
        wrong = {c: p[c] for p in probe for c in PAR_COLLECTIVES
                 if p[c].startswith("wrong")}
        check(not wrong, f"phase 32 (b): collectives gave wrong answers on "
              f"CUDA tensors: {wrong}")
        missing = [c for c in PAR_REQUIRED if c not in taken]
        check(not missing, f"phase 32 (b): gloo did not take {missing} on "
              f"CUDA tensors: {[refused[c] for c in missing]}")
        res = par_spawn(par_checks, 2, tmp, taken)
        par_report(res, refused, "two gloo ranks on the card", card)
        log(32, f"(b) {time.perf_counter() - t0:.1f} s with the ranks' "
                f"start")
        return a
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phases 33-36: K2 at head dim 128, the LM at head dim 128, SCD and ICF
# training ------------------------------------------------------------------

def k2_d128_path(k2, roofline, dev, card):
    """Phase 33: K2 at head dim 128 (and 96, padded) against its plain
    versions in both types, and timed at K2_D128. Returns the worst errors
    by kernel and the timing."""
    rng = np.random.default_rng(33)
    worst = {}
    f32_designs_checked(k2, 128)
    for dtype in (torch.float32, torch.bfloat16):
        w, wr = {}, {}
        for shape in K2_D128_SHAPES + ([K2_D128] if dtype == torch.bfloat16
                                       else []):
            errs, rels = k2_compare(k2, shape, dtype, dev, rng)
            for key in errs:
                w[key] = max(w.get(key, 0.0), errs[key])
                wr[key] = max(wr.get(key, 0.0), rels[key])
        for shape in K2_D96:
            errs, rels = k2_padded_compare(k2, shape, dtype, dev, rng)
            for key in errs:
                w[key] = max(w.get(key, 0.0), errs[key])
                wr[key] = max(wr.get(key, 0.0), rels[key])
        for key in w:
            worst[key] = max(worst.get(key, 0.0), w[key])
        log(33, f"K2 at head dim 128 vs plain, {dtype} "
                f"({ {key: k2._design(key, dtype, 128) for key in w} }), "
                f"{len(K2_D128_SHAPES)} shapes (T 128/100/257 causal and not, "
                f"72x136 causal and not)"
                + (f" and {K2_D128}" if dtype == torch.bfloat16 else "")
                + f", and flash_attention at D 96 padded to 128 at (B, T, H, "
                f"D, causal) {K2_D96}: max abs error "
                f"{ {k: f'{e:.3g}' for k, e in w.items()} }; worst 64-row "
                f"tile error / tile norm "
                f"{ {k: f'{e:.3g}' for k, e in wr.items()} }; designs "
                f"checked per shape")
    out, lib_err = k2_timed(k2, roofline, K2_D128, dev, rng)
    log(33, f"K2 at {K2_D128} bf16 (CUDA events, 2 x 20 launches in turns "
            f"with the library call; plain 5): "
            + k2_timing_note(out, lib_err) + f"; {card}")
    return worst, out


def lm_d128_path(k2, dev, card):
    """Phase 34: the LM at d 2048 = 16 heads of 128 (LM_D128): the
    training step through K2 at D 128 (lm_bench.measure: one warm-up and 3
    timed steps, launches by design), then the forward's logits on the card
    (bf16, K2a) against the CPU port's float32 forward from the same
    parameters. Returns K2's launches in the step run."""
    from ccv_tpu_torch.bin import lm_bench
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.nn import optimizers
    c = LM_D128
    k2.reset_launches()
    res = lm_bench.measure(layers=c["layers"], dim=c["dim"], heads=c["heads"],
                           ff=c["ff"], batch=c["batch"], seq=c["seq"],
                           vocab=c["vocab"], steps=3)
    launches = dict(k2.LAUNCHES)
    designs = {key: dict(v) for key, v in k2.DESIGN_LAUNCHES.items()}
    n = c["layers"] * 4   # a warm-up and 3 steps; remat runs the forward twice
    want = {"fwd": 2 * n, "dq": n, "dkv": n}
    check(launches == want and all(
        designs[key] == {**dict.fromkeys(k2.DESIGNS, 0),
                         "wgmma-tma": want[key]}
        for key in want), f"the D 128 LM step launched K2 {designs}")
    check(all(np.isfinite(res["losses"])), f"D 128 LM losses {res['losses']}")
    cfg = tfm.TransformerConfig(
        vocab_size=c["vocab"], layers=c["layers"], heads=c["heads"],
        head_dim=c["dim"] // c["heads"], ff=c["ff"], max_len=c["seq"],
        dropout=0.0, dtype=torch.bfloat16)
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(4), cfg)
    ids = torch.randint(0, c["vocab"], (c["batch"], c["seq"]),
                        generator=torch.Generator().manual_seed(5))
    k2.reset_launches()
    with torch.no_grad():
        got = tfm.lm_forward(params, cfg, ids.to(dev)).float().cpu()
        fwd = k2.LAUNCHES["fwd"]
        check(fwd == c["layers"], f"the D 128 forward launched K2a {fwd}")
        cpu = optimizers.tree_map(lambda p: p.detach().float().cpu(), params)
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        want_l = tfm.lm_forward(cpu, dataclasses.replace(
            cfg, dtype=torch.float32), ids)
        cpu_s = time.perf_counter() - t0
    top = float(want_l.abs().max())
    err = float((got - want_l).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= LM_D128_REL * top,
          f"D 128 LM logits: card (bf16) {err:.3g} from the CPU's float32, "
          f"largest {top:.3g}")
    log(34, f"LM at head dim 128 ({res['model']}, {res['params_m']} M "
            f"params, B {c['batch']} x T {c['seq']}, bf16, remat dots): step "
            f"{res['step_ms']:.2f} ms (mean of 3 after a warm-up of "
            f"{res['warmup_s']:.2f} s), {res['tokens_per_s']:.0f} tokens/s, "
            f"MFU {res['mfu']:.4f}, peak memory {res['peak_mem_gb']:.2f} GB, "
            f"losses {[round(x, 4) for x in res['losses']]}; K2 launches by "
            f"design {designs}; the forward's logits (bf16 on the card, K2a "
            f"{fwd}) against the CPU port's float32 forward ({cpu_s:.1f} s): "
            f"max diff {err:.3g} = {err / top:.3g} of the largest "
            f"{top:.3g} (gate {LM_D128_REL}); {card}")
    return launches, res


def s2s_d128_path(k2, dev, card):
    """Phase 34's seq2seq model at head dim 128 (S2S_D128): the forward's
    logits on the card against the CPU port's float32 forward from the same
    parameters, then the wmt step timed. Returns K2's launches a step."""
    from ccv_tpu_torch.bin import wmt
    from ccv_tpu_torch.bin.wmt_grad_trial import synthetic_batch
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.nn import optimizers
    cfg = tfm.TransformerConfig(**S2S_D128, dtype=torch.bfloat16,
                                dropout=0.0)
    T, sv, tv = cfg.max_len, cfg.vocab_size, cfg.tgt_vocab_size
    cpu = tfm.init_encoder_decoder(torch.Generator().manual_seed(11), cfg)
    params = to_device(cpu, dev)
    cpu = optimizers.tree_map(lambda p: p.detach().float(), cpu)
    b, ts, tt = S2S_CPU
    src, tgt, _ = synthetic_batch(np.random.default_rng(34), b, max(ts, tt),
                                  sv, tv)
    src, tgt = torch.from_numpy(src[:, :ts]), torch.from_numpy(tgt[:, :tt])
    with torch.no_grad():
        want = tfm.encoder_decoder_forward(
            cpu, dataclasses.replace(cfg, dtype=torch.float32), src, tgt)
        k2.reset_launches()
        got = tfm.encoder_decoder_forward(params, cfg, src.to(dev),
                                          tgt.to(dev)).float().cpu()
    check(k2.LAUNCHES == {"fwd": 2 * cfg.layers, "dq": 0, "dkv": 0},
          f"the D 128 seq2seq forward launched K2 {k2.LAUNCHES}")
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= LM_D128_REL * top,
          f"D 128 seq2seq logits: card (bf16) {err:.3g} from the CPU's "
          f"float32, largest {top:.3g}")
    batch = tuple(torch.from_numpy(x).to(dev) for x in synthetic_batch(
        np.random.default_rng(35), WMT_B, T, sv, tv))
    opt = optimizers.adam(rate=1e-4)
    state = opt.init(params)

    def step():
        return wmt.train_step(params, opt, state, cfg, batch, sv - 1, tv - 1,
                              None)
    losses = [float(step())]
    torch.cuda.synchronize()
    k2.reset_launches()
    before = {key: dict(c) for key, c in k2.DESIGN_LAUNCHES.items()}
    t0 = time.perf_counter()
    losses += [step() for _ in range(3)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000 / 3
    losses = [float(x) for x in losses]
    n = cfg.layers * 3
    ran = {key: {d: c - before[key][d] for d, c in cs.items()
                 if c > before[key][d]}
           for key, cs in k2.DESIGN_LAUNCHES.items()}
    check(k2.LAUNCHES == {"fwd": n, "dq": n, "dkv": n}
          and ran == {key: {"wgmma-tma": n} for key in ("fwd", "dq", "dkv")}
          and all(np.isfinite(losses)),
          f"D 128 wmt step: K2 {k2.LAUNCHES} by design {ran} over 3 steps "
          f"(expected {n} each, wgmma-tma), losses {losses}")
    log(34, f"seq2seq at head dim 128 ({s2s_name(cfg)}), bf16: the "
            f"forward's logits at (B, Ts, Tt) {S2S_CPU} unmasked (K2a "
            f"{2 * cfg.layers}) against the CPU port's float32 forward: max "
            f"diff {err:.3g} = {err / top:.3g} of the largest {top:.3g} "
            f"(gate {LM_D128_REL}); the wmt step at B {WMT_B} x T {T}, source "
            f"mask: {ms:.2f} ms a step (host clock, mean of 3 after a "
            f"warm-up), K2 {cfg.layers} / {cfg.layers} / {cfg.layers} a "
            f"step by design {ran}, losses "
            f"{[round(x, 4) for x in losses]}; {card}")
    return {key: v // 3 for key, v in k2.LAUNCHES.items()}


def merge_worst(worst, errs):
    """``worst`` updated in place with the larger value of each key."""
    for key, v in errs.items():
        worst[key] = max(worst.get(key, 0.0), v)


def fmt_errs(d):
    return "{" + ", ".join(f"{k}: {v:.3g}" for k, v in d.items()) + "}"


def k2_d256_path(k2, roofline, dev, card):
    """Phase 43, the kernels: K2 at head dim 256 in bf16 and float16
    (wgmma-tma), the tc-f32 and the tc-wide kernels against their plain
    versions, then timed.
    Returns {"bfloat16" / "float16": dict(err={kernel: worst max abs error}, timed=...), "wide": dict(
    err={design: {kernel: worst max abs error}}, timed=[(dtype, shape,
    timing)])}."""
    rng = np.random.default_rng(43)
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[1]
        w, wr = {}, {}
        for shape in K2_D256_SHAPES + [K2_D256]:
            errs, rels = k2_compare(k2, shape, dtype, dev, rng)
            merge_worst(w, errs)
            merge_worst(wr, rels)
        timed, lib_err = k2_timed(k2, roofline, K2_D256, dev, rng, dtype)
        log(43, f"K2 at head dim 256 vs plain, {name} "
                f"({k2._design('fwd', dtype, 256)}), {K2_D256_SHAPES} and "
                f"{K2_D256}: max abs error {fmt_errs(w)}; worst 64-row tile "
                f"error / tile norm {fmt_errs(wr)}; designs checked per "
                f"shape")
        log(43, f"K2 at {K2_D256} {name} (CUDA events, 2 x 20 launches in "
                f"turns with the library call; plain 5): "
                + k2_timing_note(timed, lib_err) + f"; {card}")
        out[name] = dict(err=w, timed=timed)
    w, wr = {}, {}  # {design: {kernel: worst}}
    for compare, shapes in ((k2_compare, K2_WIDE_SHAPES),
                            (k2_padded_compare, K2_WIDE_PADDED)):
        for dtype, shape in shapes:
            errs, rels = compare(k2, shape, dtype, dev, rng)
            for key in errs:
                design = k2._design(key, dtype, k2.padded_dim(shape[3]))
                merge_worst(w.setdefault(design, {}), {key: errs[key]})
                merge_worst(wr.setdefault(design, {}), {key: rels[key]})
    log(43, f"K2's tc-f32 and tc-wide kernels vs plain at "
            f"(dtype, (BH, Tq, Tk, D, causal)) "
            f"{[(str(d).split('.')[1], s) for d, s in K2_WIDE_SHAPES]}, and "
            f"flash_attention padded inside at (dtype, (B, T, H, D, causal)) "
            f"{[(str(d).split('.')[1], s) for d, s in K2_WIDE_PADDED]}: max "
            f"abs error by design "
            f"{ {d: fmt_errs(e) for d, e in w.items()} }; worst 64-row tile "
            f"error / tile norm { {d: fmt_errs(e) for d, e in wr.items()} }; "
            f"designs checked per shape")
    timed = []
    for dtype, shape in K2_WIDE_TIMED:
        t, lib_err = k2_timed(k2, roofline, shape, dev, rng, dtype,
                              backend="efficient", reps=5)
        timed.append((dtype, shape, t))
        designs = {key: k2._design(key, dtype, shape[3]) for key in t}
        log(43, f"K2 at {shape} {str(dtype).split('.')[1]} (designs "
                f"{designs}; CUDA events, 2 x 5 launches in turns with the "
                f"library call; plain 5; bound kinds "
                f"{ {key: r['kind'] for key, r in t.items()} }): "
                + k2_timing_note(t, lib_err, "memory-efficient") + f"; {card}")
    out["wide"] = dict(err=w, timed=timed)
    return out


def lm_d256_config(dtype):
    from ccv_tpu_torch.models import transformer as tfm
    c = LM_D256
    return tfm.TransformerConfig(
        vocab_size=c["vocab"], layers=c["layers"], heads=c["heads"],
        head_dim=c["dim"] // c["heads"], ff=c["ff"], max_len=c["seq"],
        dropout=0.0, dtype=dtype, remat=True, remat_policy="dots")


def lm_d256_step(k2, dev, dtype, plain, ids):
    """One LM step at LM_D256's widths in ``dtype`` from the parameters of
    seed 6, with the kernels or with plain attention: (loss, {name: its
    gradient}, K2's launches by kernel and design). Checks the launches by
    design (the forward twice a layer: remat runs it again; none on the
    plain route)."""
    from ccv_tpu_torch.bin import lm_bench
    from ccv_tpu_torch.bin.wmt_grad_trial import named_grads
    from ccv_tpu_torch.models import transformer as tfm
    cfg = lm_d256_config(dtype)
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(6), cfg)
    k2.reset_launches()
    with lm_bench.plain_attention(plain):
        loss = lm_bench.loss_fn(params, cfg, ids)
        loss.backward()
    torch.cuda.synchronize()
    ran = {key: {d: n for d, n in c.items() if n}
           for key, c in k2.DESIGN_LAUNCHES.items()}
    n = 0 if plain else cfg.layers
    want = {key: ({k2._design(key, dtype, cfg.head_dim): m} if m else {})
            for key, m in (("fwd", 2 * n), ("dq", n), ("dkv", n))}
    check(ran == want, f"the Gemma-width LM step ({dtype}, plain={plain}) "
                       f"launched K2 {ran}, expected {want}")
    grads = named_grads(params)
    del params
    torch.cuda.empty_cache()
    return float(loss.detach()), grads, ran


def lm_d256_path(k2, dev, card):
    """Phase 43, the LM at Gemma-2B's widths (LM_D256): the kernel steps
    against the plain route in float32 and bf16 (see LM_D256), then
    lm_bench.measure in float32 and in bf16. Returns the launches of the
    float32 kernel step (tc-f32 and tc-wide) and of the bf16
    measured run (wgmma-tma)."""
    from ccv_tpu_torch.bin import lm_bench
    from ccv_tpu_torch.bin.wmt_grad_trial import grad_dist
    c = LM_D256
    ids = torch.randint(0, c["vocab"], (c["batch"], c["seq"] + 1),
                        generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)
    loss_f, g_f, _ = lm_d256_step(k2, dev, torch.float32, True, ids)
    loss_k, g_k, f32_launches = lm_d256_step(k2, dev, torch.float32, False,
                                              ids)
    kp = grad_dist(g_k, g_f)
    wk32 = max(kp, key=kp.get)
    del g_k
    loss_b, g_b, _ = lm_d256_step(k2, dev, torch.bfloat16, False, ids)
    kf = grad_dist(g_b, g_f)
    del g_b
    loss_bp, g_bp, _ = lm_d256_step(k2, dev, torch.bfloat16, True, ids)
    pf = grad_dist(g_bp, g_f)
    del g_bp, g_f
    torch.cuda.empty_cache()
    wk, wp = max(kf, key=kf.get), max(pf, key=pf.get)
    bound = max(LM_GRAD_REL, BF16_GRAD_RATIO * pf[wp])
    log(43, f"LM at Gemma-2B's widths (d {c['dim']} = {c['heads']} heads of "
            f"{c['dim'] // c['heads']}, ff {c['ff']}, vocab {c['vocab']}, "
            f"{c['layers']} layers, B {c['batch']} x T {c['seq']}, remat "
            f"dots), one step from the same parameters and batch: float32 "
            f"loss {loss_k:.6f} / plain {loss_f:.6f}, "
            f"gradients within {kp[wk32]:.3g} of their largest magnitude "
            f"(worst {wk32}, limit {LM_GRAD_REL}), K2 by design "
            f"{f32_launches}; bf16 "
            f"(wgmma-tma) loss {loss_b:.6f} / plain {loss_bp:.6f}, "
            f"gradients from the float32 plain step: kernels {kf[wk]:.3g} "
            f"(worst {wk}), plain {pf[wp]:.3g} (worst {wp}), bound "
            f"{bound:.3g}")
    check(np.isfinite(loss_k) and abs(loss_k - loss_f) <= LM_LOSS_REL * abs(
        loss_f), f"Gemma-width float32 loss {loss_k} with K2, {loss_f} plain")
    check(kp[wk32] <= LM_GRAD_REL, f"Gemma-width float32 gradient {wk32} "
          f"{kp[wk32]:.3g} of its largest magnitude from the plain step's")
    check(np.isfinite(loss_b) and abs(loss_b - loss_bp) <= LM_LOSS_REL * abs(
        loss_bp), f"Gemma-width bf16 loss {loss_b} with K2, {loss_bp} plain")
    check(kf[wk] <= bound, f"Gemma-width bf16 kernel step: gradient {wk} "
          f"{kf[wk]:.3g} of its largest magnitude from the float32 step "
          f"(bound {bound:.3g})")
    n = c["layers"] * (1 + LM_D256_STEPS)   # remat runs the forward twice
    want = {"fwd": 2 * n, "dq": n, "dkv": n}
    for dtype in (torch.float32, torch.bfloat16):
        k2.reset_launches()
        res = lm_bench.measure(
            layers=c["layers"], dim=c["dim"], heads=c["heads"], ff=c["ff"],
            batch=c["batch"], seq=c["seq"], vocab=c["vocab"],
            steps=LM_D256_STEPS, dtype=dtype)   # bf16 last: returned
        torch.cuda.empty_cache()
        launches = dict(k2.LAUNCHES)
        designs = {key: {d: m for d, m in v.items() if m}
                   for key, v in k2.DESIGN_LAUNCHES.items()}
        check(launches == want and designs == {
            key: {k2._design(key, dtype, c["dim"] // c["heads"]): want[key]}
            for key in want}, f"the Gemma-width LM run ({dtype}) launched K2 "
                              f"{designs}")
        check(all(np.isfinite(res["losses"])),
              f"Gemma-width LM losses ({dtype}) {res['losses']}")
        log(43, f"lm_bench.measure at Gemma-2B's widths ({res['model']}, "
                f"vocab {c['vocab']}, {res['params_m']} M params, B "
                f"{c['batch']} x T {c['seq']}, {res['dtype']}, remat dots): "
                f"step {res['step_ms']:.2f} ms (mean of {LM_D256_STEPS} after "
                f"a warm-up of {res['warmup_s']:.2f} s), "
                f"{res['tokens_per_s']:.0f} tokens/s, MFU {res['mfu']:.4f} "
                f"of {res['peak_tflops']:.0f} TFLOP/s (lm_bench's count: 6 "
                f"N a token, N with the input embedding, which does no "
                f"products), peak memory "
                f"{res['peak_mem_gb']:.2f} GB, losses "
                f"{[round(x, 4) for x in res['losses']]}; K2 launches by "
                f"design {designs}; {card}")
    return dict(launches=launches, f32_launches=f32_launches, res=res)


def decode_d256_path(k2, dev, card):
    """Phase 43, greedy_decode at S2S_D256 (d 1024 = 4 heads of 256), B
    DECODE_B, bf16: K2a (wgmma-tma, D 256) once per decoder layer per
    step, the chosen tokens held to a teacher-forced plain pass as phase
    16 holds them. Returns K2a's launches and the steps."""
    from ccv_tpu_torch.bin import iwslt, lm_bench
    from ccv_tpu_torch.bin.wmt_grad_trial import synthetic_batch
    from ccv_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(**S2S_D256, dtype=torch.bfloat16,
                                dropout=0.0)
    params = tfm.init_encoder_decoder(
        torch.Generator(device=dev).manual_seed(5), cfg)
    T, tv = cfg.max_len, cfg.tgt_vocab_size
    src, _, _ = synthetic_batch(np.random.default_rng(43), DECODE_B, T,
                                cfg.vocab_size, tv)
    src = torch.from_numpy(src).to(dev)
    spad, tpad = cfg.vocab_size - 1, tv - 1
    iwslt.greedy_decode(params, cfg, src, spad, tpad, 4)  # warm-up
    torch.cuda.synchronize()
    k2.reset_launches()
    t0 = time.perf_counter()
    dec = iwslt.greedy_decode(params, cfg, src, spad, tpad, T)
    wall = (time.perf_counter() - t0) * 1000
    launches = dict(k2.LAUNCHES)
    on_wgmma = k2.DESIGN_LAUNCHES["fwd"]["wgmma-tma"]
    steps, chosen = decode_steps(dec, tv - 2)
    n = cfg.layers * steps
    check(launches == {"fwd": n, "dq": 0, "dkv": 0} and on_wgmma == n,
          f"the D 256 greedy_decode ran {steps} steps and launched K2 "
          f"{launches} ({on_wgmma} wgmma-tma); expected {cfg.layers} K2a a "
          f"step")
    with torch.no_grad(), lm_bench.plain_attention():
        logits = tfm.encoder_decoder_forward(
            params, cfg, src, torch.from_numpy(dec).to(dev),
            src_mask=src != spad)
    check(bool(torch.isfinite(logits).all()),
          "D 256 teacher-forced logits not finite")
    rows, ts = np.nonzero(chosen)
    at = logits[torch.from_numpy(rows).to(dev),
                torch.from_numpy(ts - 1).to(dev)].float().cpu().numpy()
    picked = at[np.arange(len(rows)), dec[rows, ts]]
    gap = (at.max(1) - picked) / np.abs(at).max(1)
    check(float(gap.max()) <= DECODE_TOL, f"the D 256 greedy_decode chose a "
          f"token {float(gap.max()):.3g} of the row's largest logit below "
          f"the plain path's best (limit {DECODE_TOL})")
    log(43, f"greedy_decode, {s2s_name(cfg)}, B {DECODE_B} x Ts {T}, bf16, "
            f"random weights (seed 5): {steps} steps, {len(rows)} tokens "
            f"chosen, {wall:.1f} ms a batch = {wall / steps:.3f} ms a step "
            f"(host clock, one run after a warm-up); K2a {launches['fwd']} "
            f"= {cfg.layers} a step, wgmma-tma at D 256; teacher-forced "
            f"through plain attention: the chosen token's logit within "
            f"{float(gap.max()):.3g} of the row's best (limit {DECODE_TOL}); "
            f"{card}")
    return launches["fwd"], steps


def fit_d256_path(k2, dev, card):
    """Phase 43, Model.fit of phase 31's graph model with
    ScaledDotProductAttention(8, 256) (SDPA_D256): K2 against the plain
    route by phase 31's gates, float32 (tc-f32) and bf16 (wgmma-tma); then
    with heads of 320 (SDPA_D320) in bf16, tc-wide for all three, by the
    same bf16 gate against the float32 plain fit at that width. Returns K2's launches a fit by design:
    {"float32", "bfloat16", "bfloat16_d320": {kernel: {design: n}}}."""
    B, T, D, heads, hd = SDPA_D256
    runs = {}
    for dt in (torch.float32, torch.bfloat16):
        for plain in (False, True):
            runs[(dt, plain)] = fit_gate_run(k2, dev, dt, plain, SDPA_D256)
            if not plain:
                by = {key: {d: c for d, c in cs.items() if c}
                      for key, cs in k2.DESIGN_LAUNCHES.items()}
                runs[(dt, "designs")] = by
    (lk, gk, _), (lp, gp, _) = (runs[(torch.float32, False)],
                                runs[(torch.float32, True)])
    g_rel = rel_dist(gk, gp)
    wg = max(g_rel, key=g_rel.get)
    loss_rel = abs(lk - lp) / abs(lp)
    check(np.isfinite(lk) and loss_rel <= TRAIN_LOSS_REL, f"D 256 float32 "
          f"fit loss {lk} with K2, {lp} plain")
    check(g_rel[wg] <= TRAIN_GRAD_REL, f"D 256 float32 fit gradient {wg} "
          f"{g_rel[wg]:.3g} of its largest magnitude from the plain route's")
    lk16, lp16 = runs[(torch.bfloat16, False)][0], runs[(torch.bfloat16,
                                                            True)][0]
    k16, wk16, p16, _, bound = bf16_fit_gate(
        "D 256", runs[(torch.bfloat16, False)], runs[(torch.bfloat16, True)],
        gp)
    log(43, f"Model(LayerNorm, ScaledDotProductAttention({heads}, {hd}, "
            f"causal), Add) B {B} x T {T} x {D} under compile(adamw, 'mse'), "
            f"one fit from the same weights and batch, K2 against the plain "
            f"route: float32 loss {lk:.7f} / {lp:.7f} "
            f"(rel {loss_rel:.3g}, limit {TRAIN_LOSS_REL}), gradients within "
            f"{g_rel[wg]:.3g} (worst {wg}, limit {TRAIN_GRAD_REL}); bf16 "
            f"(wgmma-tma) loss {lk16:.6f} / {lp16:.6f}, gradients from the "
            f"float32 plain fit: K2 {k16:.3g} (worst {wk16}), plain "
            f"{p16:.3g}, bound {bound:.3g}; K2 a fit by design: float32 "
            f"{runs[(torch.float32, 'designs')]}, bf16 "
            f"{runs[(torch.bfloat16, 'designs')]}; {card}")
    out = {str(dt).split(".")[1]: runs[(dt, "designs")]
           for dt in (torch.float32, torch.bfloat16)}
    k320 = fit_gate_run(k2, dev, torch.bfloat16, False, SDPA_D320)
    out["bfloat16_d320"] = {key: {d: c for d, c in cs.items() if c}
                            for key, cs in k2.DESIGN_LAUNCHES.items()}
    p320 = fit_gate_run(k2, dev, torch.bfloat16, True, SDPA_D320)
    f320 = fit_gate_run(k2, dev, torch.float32, True, SDPA_D320)[1]
    k, wk, p, wp, bound = bf16_fit_gate("D 320", k320, p320, f320)
    log(43, f"Model(LayerNorm, ScaledDotProductAttention({SDPA_D320[3]}, "
            f"{SDPA_D320[4]}, causal), Add) B {SDPA_D320[0]} x T "
            f"{SDPA_D320[1]} x {SDPA_D320[2]}, bf16, one fit: loss "
            f"{k320[0]:.6f} with K2 / {p320[0]:.6f} plain (limit "
            f"{LM_LOSS_REL} relative), gradients from the float32 plain fit: "
            f"K2 {k:.3g} (worst {wk}), plain {p:.3g} (worst {wp}), bound "
            f"{bound:.3g}; K2 a fit by design {out['bfloat16_d320']}; {card}")
    return out


def d256_kernel_entries(k2, sources, k2_wide, lm_d256, decode_d256,
                        fit_d256, fit_f32):
    """The ``kernels`` line's entries of phase 43: K2a/b/c at head dim 256
    on wgmma-tma in bf16 (launches of the Gemma-width LM run; times at
    K2_D256) with float16's times beside; K2a/b/c on tc-f32 (float32 from
    D 64, K2a to 256) and on tc-wide (above D 256: K2a in every type, K2b
    and K2c in 16-bit) (launches of the
    float32 Gemma-width kernel step, of the bf16 fit at heads of 320 and,
    for tc-f32, of phase 31's float32 fit at heads of 64, ``fit_f32``, by
    kernel and design; times at K2_WIDE_TIMED, where each form runs: the
    first timed shape's numbers plain, the next ones' with a suffix _2,
    _3). Checks that each entry's kernel ran on those paths."""
    out = []
    for key, (name, line, src, design) in sources.items():
        r = k2_wide["bfloat16"]["timed"][key]
        r16 = k2_wide["float16"]["timed"][key]
        out.append({
            "name": f"{name}_d256", "route": "cuda",
            "source": f"ccv_tpu_torch/csrc/{src}",
            "replaces": f"ccv_tpu/ops/pallas/{line}",
            "launches": lm_d256["launches"][key],
            "max_abs_err": max(k2_wide["bfloat16"]["err"][key],
                               k2_wide["float16"]["err"][key]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "design": design,
            "shape": list(K2_D256), "f16_ms": r16["ms"],
            "f16_plain_ms": r16["plain_ms"], "f16_bound_ms": r16["bound_ms"],
            "f16_library_ms": r16["library_ms"],
            "launches_fit_bf16": fit_d256["bfloat16"][key]["wgmma-tma"],
            **({"launches_decode": decode_d256} if key == "fwd" else {})})
    ranges = {"tc-f32": "float32 from head dim 32 (as 64): K2a to 256, K2b "
                        "and K2c at every multiple of 64",
              "tc-wide": "above head dim 256: K2a in every type, K2b and "
                         "K2c in bf16 and float16"}
    for design, suffix in (("tc-f32", "tc_f32"), ("tc-wide", "tc_wide")):
        for key, (name, line, _src, _design) in sources.items():
            timed = [(dt, shape, t[key])
                     for dt, shape, t in k2_wide["wide"]["timed"]
                     if k2._design(key, dt, shape[3]) == design]
            main = {part: runs.get(key, {}).get(design, 0)
                    for part, runs in (("step", lm_d256["f32_launches"]),
                                       ("fit", fit_d256["bfloat16_d320"]),
                                       ("fit_d64", fit_f32 if design ==
                                        "tc-f32" else {}))}
            entry = {
                "name": f"{name}_{suffix}", "route": "cuda",
                "source": "ccv_tpu_torch/csrc/flash_attention_tf32.cu",
                "replaces": f"ccv_tpu/ops/pallas/{line}",
                "launches": main["step"] + main["fit"] + main["fit_d64"],
                "launches_f32_step": main["step"],
                "launches_fit_bf16_d320": main["fit"],
                "launches_fit_f32": fit_d256["float32"][key].get(design, 0),
                "launches_fit_f32_d64": main["fit_d64"],
                "max_abs_err": k2_wide["wide"]["err"][design][key],
                "design": design,
                "range": ranges[design]}
            for i, (dt, shape, r) in enumerate(timed, 1):
                tag = "" if i == 1 else f"_{i}"
                entry.update({
                    f"ms{tag}": r["ms"], f"plain_ms{tag}": r["plain_ms"],
                    f"bound_ms{tag}": r["bound_ms"],
                    f"bound_by{tag}": r["bound_by"],
                    f"bound_kind{tag}": r["kind"],
                    f"library_ms{tag}": r["library_ms"],
                    f"shape{tag}": list(shape),
                    f"dtype{tag}": str(dt).split(".")[1]})
            out.append(entry)
    for entry in out:
        check(entry["launches"] > 0, f"{entry['name']} ({entry['design']}) "
                                     f"was launched no time on its paths")
    return out


def train_patches(rng, n_pos, n_neg, size):
    """Seeded (N, H, W, 3) uint8 patches of ``size`` (W, H) from the
    repository's images: positives are the faces of crop180.png and
    crop120.png, cut at a random scale (0.7-0.95 of the side) and place,
    resized by INTER_AREA, half mirrored, relit by up to +-30; negatives
    are, in turn, crops of text_test.png (as RGB) at a random scale
    (0.15-0.5 of each side) and place, parts of the same faces (0.3-0.5 of
    the side: an eye, a cheek) and the faces upside down (the hard
    negatives), resized likewise (by INTER_CUBIC where a part is smaller
    than the patch)."""
    from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
    from ccv_tpu_torch.ops import resample
    W, H = size
    faces = [read(os.path.join(DATA, n), IO_RGB_COLOR, device="cpu").numpy()
             for n in ("crop180.png", "crop120.png")]
    text = read(os.path.join(DATA, "text_test.png"), IO_RGB_COLOR,
                device="cpu").numpy()

    def cut(img, frac):
        h, w = img.shape[:2]
        ch, cw = int(h * frac), int(w * frac)
        y = int(rng.integers(0, h - ch + 1))
        x = int(rng.integers(0, w - cw + 1))
        patch = torch.from_numpy(np.ascontiguousarray(img[y:y + ch,
                                                          x:x + cw]))
        up = ch < H or cw < W   # a small face part: INTER_CUBIC
        return resample.resample(
            patch, rows=H, cols=W, rows_scale=H / ch, cols_scale=W / cw,
            interp=resample.INTER_CUBIC if up else
            resample.INTER_AREA).numpy()

    pos = []
    for i in range(n_pos):
        p = cut(faces[i % 2], rng.uniform(0.7, 0.95)).astype(np.int32)
        if rng.random() < 0.5:
            p = p[:, ::-1]
        pos.append(np.clip(p + int(rng.integers(-30, 31)), 0, 255))
    neg = [cut(text, rng.uniform(0.15, 0.5)) if i % 3 == 0 else
           cut(faces[i // 3 % 2], rng.uniform(0.3, 0.5)) if i % 3 == 1 else
           cut(faces[i // 3 % 2], rng.uniform(0.7, 0.95))[::-1]
           for i in range(n_neg)]
    return (np.stack(pos).astype(np.uint8), np.stack(neg).astype(np.uint8))


def scd_adam_step(tscd, params, pos, neg, dev):
    """One round's Adam steps alone at this table: (ms a step by CUDA
    events over 3 rounds, the profiler's window over one round, the table's
    bytes, seconds to build the table on the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fvt = tscd.precompute_feature_vectors(
        np.concatenate([pos, neg]), tscd.stump_features(params),
        dev).transpose(0, 1).contiguous()      # the trainer's layout
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    y = tscd._labels(len(pos), len(neg), dev)
    w = torch.full((len(y),), 1.0 / len(y), device=dev)
    init = tscd.uniform_init(1)(fvt.shape[0])
    steps = params.train_steps

    def one_round():
        return tscd._train_all_stumps(fvt, y, w, params.C, steps,
                                      params.learning_rate, init)
    step_ms = time_cuda(one_round, 3) / steps
    win = device_window(one_round, 1)
    nbytes = fvt.numel() * 4
    del fvt
    torch.cuda.empty_cache()
    return step_ms, win, nbytes, table_s


def scd_train_path(scd, k1, dev, card, read):
    """Phase 35: SCD training on the card against the CPU port at
    SCD_TRAIN_N, then timed on the card at SCD_TRAIN_FULL_N, whose
    cascade's 1080p detect runs through K1 against the plain route.
    Returns K1's launches in that detect."""
    from ccv_tpu_torch.ops.kernels import roofline
    from ccv_tpu_torch.train import scd as tscd
    rng = np.random.default_rng(35)
    pos, neg = train_patches(rng, *SCD_TRAIN_N, SCD_TRAIN["size"])
    params = tscd.ScdTrainParams(**SCD_TRAIN)
    n_feat = len(tscd.stump_features(params))
    steps = params.train_steps
    runs = {}
    for where in (dev, torch.device("cpu")):
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[where.type] = (tscd.train_cascade(pos, neg, params, where,
                                               timings=timings),
                            time.perf_counter() - t0, timings)
    (card_c, card_s, card_t), (cpu_c, cpu_s, cpu_t) = runs["cuda"], runs["cpu"]
    same = (np.array_equal(card_c.stage_counts, cpu_c.stage_counts)
            and all(np.array_equal(getattr(card_c, k), getattr(cpu_c, k))
                    for k in ("sx", "sy", "dx", "dy")))
    th_diff = (float(np.abs(card_c.thresholds - cpu_c.thresholds).max())
               if same else float("inf"))
    w_diff = float(np.abs(card_c.w - cpu_c.w).max()) if same else float("inf")
    check(same and th_diff <= SCD_THRESHOLD_TOL,
          f"SCD training: card stages {card_c.stage_counts.tolist()} "
          f"thresholds {card_c.thresholds.tolist()}, CPU "
          f"{cpu_c.stage_counts.tolist()} {cpu_c.thresholds.tolist()}; "
          f"features equal: {same}")
    step_ms, win, nbytes, _ = scd_adam_step(tscd, params, pos, neg, dev)
    log(35, f"SCD training at {SCD_TRAIN['size']} ({n_feat} features, "
            f"{len(pos)} positives, {len(neg)} negatives: a (F, N, 32) table "
            f"of {nbytes / 2**20:.1f} MiB), {params.boosting} stages "
            f"of at most {params.maximum_feature} features, {steps} Adam "
            f"steps a round: card {card_s:.2f} s ({card_t['adam_steps']} "
            f"steps; stages {[round(x, 3) for x in card_t['stage_s']]} s), "
            f"CPU {cpu_s:.2f} s (stages "
            f"{[round(x, 3) for x in cpu_t['stage_s']]} s); stages "
            f"{card_c.stage_counts.tolist()} with the same features on both, "
            f"thresholds {card_c.thresholds.tolist()} (card - CPU max "
            f"{th_diff:.3g}, gate {SCD_THRESHOLD_TOL}), weights max diff "
            f"{w_diff:.3g}; an Adam step at this table {step_ms:.4f} ms "
            f"(CUDA events, {steps} steps x 3); under torch.profiler one "
            f"round: busy {win['busy']:.2f} ms of {win['wall']:.2f} ms, idle "
            f"{1 - win['busy'] / win['wall']:.3f}; {card}")

    # the card alone at SCD_TRAIN_FULL_N
    pos, neg = train_patches(rng, *SCD_TRAIN_FULL_N, SCD_TRAIN["size"])
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cascade_t = tscd.train_cascade(pos, neg, params, dev, timings=timings)
    full_s = time.perf_counter() - t0
    step_ms, win, nbytes, table_s = scd_adam_step(tscd, params, pos, neg,
                                                  dev)
    bound = nbytes / roofline.PEAK_BYTES_PER_S * 1e3
    top = sorted(win["by_name"].items(), key=lambda kv: -kv[1])[:4]
    log(35, f"SCD training on the card at {SCD_TRAIN['size']}, "
            f"{len(pos)} positives, {len(neg)} negatives (a (F, N, 32) "
            f"table of {nbytes / 2**30:.3f} GiB, built in {table_s:.3f} s): "
            f"{full_s:.2f} s ({timings['adam_steps']} Adam steps; stages "
            f"{[round(x, 3) for x in timings['stage_s']]} s), stages "
            f"{cascade_t.stage_counts.tolist()}, thresholds "
            f"{cascade_t.thresholds.tolist()}; an Adam step at the whole "
            f"table {step_ms:.4f} ms (CUDA events, {steps} steps x 3), "
            f"against one read of the table {bound:.4f} ms at "
            f"{roofline.PEAK_BYTES_PER_S / 1e12} TB/s (the step reads it "
            f"twice); under torch.profiler one round: busy "
            f"{win['busy']:.2f} ms of {win['wall']:.2f} ms, idle "
            f"{1 - win['busy'] / win['wall']:.3f}, "
            f"{win['events'] / steps:.1f} device events a step; the largest "
            f"device ms a round: "
            + "; ".join(f"{k[:60]} {v:.2f}" for k, v in top) + f"; {card}")
    tmp = tempfile.mkdtemp(prefix="phase35-")
    try:
        path = os.path.join(tmp, "trained.sqlite3")
        tscd.write_cascade(cascade_t, path)
        cascade = scd.load_cascade(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(np.array_equal(cascade.w, cascade_t.w)
          and np.array_equal(cascade.thresholds, cascade_t.thresholds),
          "the trained SCD cascade does not read back as written")
    img = torch.from_numpy(rgb_frame_1080p(read)).to(dev)
    dparams = scd.ScdParams(min_neighbors=0, size=SCD_TRAIN["size"])
    n_oct = len({s_[0] for s_ in scd._level_specs(
        1080, 1920, cascade, dparams)[0]})
    scd.detect(img, cascade, dparams)   # the cascade's tables, warm-up
    k1.LAUNCHES = 0
    got = rect_set(scd.detect(img, cascade, dparams))
    launches = k1.LAUNCHES
    check(launches == n_oct, f"the trained cascade's detect launched K1 "
          f"{launches} times for {n_oct} octaves")
    want = rect_set(scd.detect(img, cascade, dparams,
                               evaluate=k1.cascade_eval_levels_ref))
    odd = got ^ want
    if odd:
        near = margin_rects(scd, k1, img, cascade, dparams, dev)
        check(odd <= near, f"trained cascade at 1080p: {len(odd - near)} "
                           f"windows differ from the plain route outside "
                           f"the margin")
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scd.detect(img, cascade, dparams)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000)
    dwin = device_window(lambda: scd.detect(img, cascade, dparams), 2)
    log(35, f"the {len(pos) + len(neg)}-example cascade written, loaded "
            f"and run by detect on the 1920x1080 RGB frame (size "
            f"{SCD_TRAIN['size']}, min_neighbors 0): {len(got)} windows = "
            f"the plain route's ({len(odd)} in the margin); K1 {launches} "
            f"launches ({n_oct} octaves); detect median "
            f"{float(np.median(ms)):.2f} ms/image (n=5); under "
            f"torch.profiler (2 images) busy {dwin['busy']:.2f} ms of "
            f"{dwin['wall']:.2f} ms an image, idle "
            f"{1 - dwin['busy'] / dwin['wall']:.3f}; {card}")
    return launches


def icf_train_path(dev, card):
    """Phase 36: ICF training on the card against the CPU port at
    ICF_TRAIN_N, then timed on the card at ICF_TRAIN_FULL_N."""
    from ccv_tpu_torch.train import icf as ticf
    rng = np.random.default_rng(36)
    pos, neg = train_patches(rng, *ICF_TRAIN_N, ICF_TRAIN["size"])
    params = ticf.IcfTrainParams(**ICF_TRAIN)
    runs = {}
    for where in (dev, torch.device("cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[where.type] = (ticf.train_cascade(pos, neg, params, where),
                            time.perf_counter() - t0)
    (a, card_s), (b, cpu_s) = runs["cuda"], runs["cpu"]
    equal = all(np.array_equal(getattr(a, k), getattr(b, k))
                for k in ("pass_bits", "channel", "sat0", "sat1"))
    diffs = {k: float(np.abs(getattr(a, k) - getattr(b, k)).max())
             for k in ("weigh", "thresholds", "alpha", "beta")}
    check(equal and all(d <= 1e-5 * max(1.0, float(np.abs(
        getattr(b, k)).max())) for k, d in diffs.items()),
          f"ICF training: card and CPU cascades differ (structure equal: "
          f"{equal}; value diffs {diffs})")
    log(36, f"ICF training at {ICF_TRAIN['size']} ({ICF_TRAIN['feature_size']}"
            f" random features, {len(pos)} positives, {len(neg)} negatives, "
            f"{a.n_weak} depth-2 trees, {int(np.count_nonzero(a.pass_bits))} "
            f"with leaf splits): card {card_s:.2f} s, CPU {cpu_s:.2f} s; "
            f"features and splits equal, value diffs {diffs}; {card}")

    # the card alone at ICF_TRAIN_FULL_N
    pos, neg = train_patches(rng, *ICF_TRAIN_FULL_N, ICF_TRAIN["size"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = ticf.train_cascade(pos, neg, params, dev)
    full_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = ticf.random_features(params, np.random.default_rng(params.seed))
    values = ticf.precompute_feature_values(np.concatenate([pos, neg]),
                                            feats, dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    y = np.concatenate([np.ones(len(pos), bool), np.zeros(len(neg), bool)])
    wts = np.where(y, 0.5 / len(pos), 0.5 / len(neg))
    split_ms = time_cuda(lambda: ticf._best_split(values, wts, y), 3)
    win = device_window(lambda: ticf.train_cascade(pos, neg, params, dev), 1)
    log(36, f"ICF training on the card at {ICF_TRAIN['size']}, {len(pos)} "
            f"positives, {len(neg)} negatives ({tuple(values.shape)} "
            f"values): {full_s:.2f} s, {full.n_weak} trees, "
            f"{int(np.count_nonzero(full.pass_bits))} with leaf splits; the "
            f"values built in {table_s:.3f} s (features drawn on the host "
            f"included), a root split {split_ms:.3f} ms (CUDA events, mean "
            f"of 3); under torch.profiler one training: busy "
            f"{win['busy']:.2f} ms of {win['wall']:.2f} ms, idle "
            f"{1 - win['busy'] / win['wall']:.3f}; {card}")
    return card_s


def gray_train_patches(rng, n_pos, n_neg, size):
    """``train_patches`` in gray (libjpeg's coefficients, as ``read`` with
    IO_GRAY), (N, H, W) uint8."""
    from ccv_tpu_torch.core.io import rgb_to_gray_u8
    return tuple(rgb_to_gray_u8(p) for p in train_patches(rng, n_pos, n_neg,
                                                          size))


def bbf_fields_equal(a, b):
    return (a.n_stages == b.n_stages and all(
        getattr(a, k).tobytes() == getattr(b, k).tobytes()
        for k in ("stage_of", "thresholds", "alphas", "px", "py", "pz",
                  "nx", "ny", "nz")))


def bbf_train_path(dev, card, read):
    """Phase 37: BBF training on the card equal to the CPU port's at
    BBF_TRAIN_N, then bbfcreate's defaults on the card at
    BBF_TRAIN_FULL_N (seconds a stage, ms a generation, one stage under the
    profiler), and that cascade's 1080p detect_objects on the card against
    the CPU port's."""
    from ccv_tpu_torch.detectors import bbf
    from ccv_tpu_torch.train import bbf as tbbf
    rng = np.random.default_rng(37)
    pos, neg = gray_train_patches(rng, *BBF_TRAIN_N, (24, 24))
    params = tbbf.BbfTrainParams(**BBF_TRAIN)
    runs = []
    for where in (dev, torch.device("cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append((tbbf.train_cascade(pos, neg, params, where),
                     time.perf_counter() - t0))
    (a, card_s), (b, cpu_s) = runs
    check(bbf_fields_equal(a, b), f"BBF training: the card's cascade "
          f"({len(a.stage_of)} features, thresholds {a.thresholds}) differs "
          f"from the CPU port's ({len(b.stage_of)}, {b.thresholds})")
    log(37, f"BBF training at 24 x 24, {len(pos)} positives, {len(neg)} "
            f"negatives, {BBF_TRAIN}: card {card_s:.2f} s, CPU {cpu_s:.2f} s;"
            f" the same cascade to the bit ({a.n_stages} stages, "
            f"{len(a.stage_of)} features, thresholds "
            f"{a.thresholds.tolist()}); {card}")

    pos, neg = gray_train_patches(rng, *BBF_TRAIN_FULL_N, (24, 24))
    params = tbbf.BbfTrainParams(**BBF_TRAIN_FULL)
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cas = tbbf.train_cascade(pos, neg, params, dev, timings=timings)
    full_s = time.perf_counter() - t0
    gen_ms = timings["generation_s"] / max(timings["generations"], 1) * 1e3
    one = dataclasses.replace(params, n_stages=1)
    win = device_window(lambda: tbbf.train_cascade(pos, neg, one, dev), 1)
    flat = tbbf.flatten_pyramids(np.concatenate([pos, neg]), params.size,
                                 dev)
    feats = tbbf._random_features(params.population, params.size,
                                  np.random.default_rng(0))
    resp_ms = time_cuda(lambda: tbbf.feature_responses(flat, *feats,
                                                       params.size), 10)
    log(37, f"BBF training on the card at bbfcreate's defaults "
            f"({params.n_stages} stages of at most "
            f"{params.max_features_per_stage} features, "
            f"population {params.population}, {params.generations} "
            f"generations), {len(pos)} positives, {len(neg)} negatives: "
            f"{full_s:.2f} s, {cas.n_stages} stages, {len(cas.stage_of)} "
            f"features (a stage: {[round(x, 3) for x in timings['stage_s']]}"
            f" s); {timings['generations']} generations at {gen_ms:.2f} ms "
            f"each (the responses, the errors, the sort and the mutation), "
            f"of which the responses of the population (one gather of "
            f"({len(pos) + len(neg)}, {params.population}, 8) a side, the "
            f"booleans to the host) {resp_ms:.3f} ms (CUDA events, mean of "
            f"10); one stage under torch.profiler: busy {win['busy']:.2f} ms "
            f"of {win['wall']:.2f} ms, idle "
            f"{1 - win['busy'] / win['wall']:.3f}; {card}")

    tmp = tempfile.mkdtemp(prefix="phase37-")
    try:
        tbbf.write_cascade(cas, os.path.join(tmp, "face"))
        back = bbf.load_cascade(os.path.join(tmp, "face"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the CPU port's pass over every window at 1080p takes minutes at this
    # feature count, and the trained thresholds let most windows of the
    # text frame through (too many for the O(n^2) grouping): the windows
    # (min_neighbors 0) are held card against CPU on a crop, and the card's
    # 1080p pass is timed
    gray = torch.from_numpy(frame_1080p(read))
    g_d = gray.to(dev)
    raw = bbf.BbfParams(min_neighbors=0)
    h, w = BBF_TRAIN_CROP
    crop = gray[:h, :w].contiguous()
    got_r = rect_conf(bbf.detect_objects(crop.to(dev), back, raw))
    t0 = time.perf_counter()
    want_r = rect_conf(bbf.detect_objects(crop, back, raw))
    cpu_s = time.perf_counter() - t0
    odd = set(got_r) ^ set(want_r)
    if odd:
        # phase 22's rule: the card and the CPU sum a stage in another
        # order, so a window within MARGIN of a threshold may flip
        rects, sums = bbf.window_sums(crop, back, raw)
        near = (np.abs(sums - back.thresholds)
                <= MARGIN * np.maximum(1, np.abs(sums))).any(1)
        at = {tuple(int(v) for v in r): n for r, n in zip(rects, near)}
        check(all(at[r] for r in odd), f"the trained BBF cascade on the "
              f"crop: {len(odd)} windows differ card vs CPU, not all in "
              f"the margin")
    both = set(got_r) & set(want_r)
    diff = max((abs(got_r[r] - want_r[r]) for r in both), default=0.0)
    check(len(both) > 0 and diff <= ATOL, f"the trained BBF cascade on the "
          f"crop: {len(both)} windows in common, conf diff {diff}")
    n_1080 = len(bbf.detect_objects(g_d, back, raw))   # and the warm-up
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bbf.detect_objects(g_d, back, raw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000)
    med = float(np.median(ms))
    log(37, f"the trained cascade written, loaded and run by detect_objects "
            f"(accurate, interval 5, min_neighbors 0): on the {w}x{h} crop "
            f"of the gray frame {len(both)} windows = the CPU port's "
            f"({len(odd)} in the margin, conf diff {diff:.3g}; {cpu_s:.1f} s "
            f"on the CPU); on the 1920x1080 frame {n_1080} windows, mean "
            f"{med:.2f} ms/image ({', '.join(f'{x:.2f}' for x in ms)}); "
            f"{card}")
    return full_s


def swt_truth_1080p():
    """text_test.swt.txt's lines in every tile of ``frame_1080p`` that
    holds them whole."""
    with open(os.path.join(DATA, "text_test.swt.txt")) as f:
        lines = [tuple(int(v) for v in line.split()) for line in f
                 if line.strip()]
    return [(x + ox, y + oy, w, h) for oy in (0, 480, 960)
            for ox in (0, 640, 1280) for x, y, w, h in lines
            if y + oy + h <= 1080 and x + ox + w <= 1920]


def swt_train_path(dev, card, read):
    """Phase 38: the SWT parameter search over text_test.png and the 1080p
    frame on the card and the CPU port, the same parameters picked;
    seconds, and the ms of a detect_words with them."""
    from ccv_tpu_torch.core.io import IO_GRAY
    from ccv_tpu_torch.detectors import swt
    from ccv_tpu_torch.train import swt as tswt
    tt = read(os.path.join(DATA, "text_test.png"), IO_GRAY,
              device="cpu").tensor
    with open(os.path.join(DATA, "text_test.swt.txt")) as f:
        tt_truth = [tuple(int(v) for v in line.split()) for line in f
                    if line.strip()]
    frame = torch.from_numpy(frame_1080p(read))
    ranges = {k: tswt.Range(*v) for k, v in SWT_SEARCH.items()}
    base = swt.SwtParams(**SWT_SEARCH_START)
    runs = []
    for where in (dev, torch.device("cpu")):
        calls = []
        detect = swt.detect_words

        def counted(*a, **k):
            calls.append(1)
            return detect(*a, **k)
        swt.detect_words = counted
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            best = tswt.optimize_params(
                [tt, frame], [tt_truth, swt_truth_1080p()], ranges,
                base=base, iterations=2, integer_fields=tuple(SWT_SEARCH),
                device=where)
            runs.append((best, time.perf_counter() - t0, len(calls)))
        finally:
            swt.detect_words = detect
    (a, card_s, n_calls), (b, cpu_s, _) = runs
    check(a == b and a != base, f"SWT search: the card picked {a}, the CPU "
          f"port {b}")
    picked = {k: getattr(a, k) for k in SWT_SEARCH}
    f_d = frame.to(dev)
    med, _ = median_ms(lambda: swt.detect_words(f_d, a), 3)
    tt_med, _ = median_ms(lambda: swt.detect_words(tt.to(dev), a), 5)
    words = swt.detect_words(f_d, a)
    log(38, f"SWT parameter search over text_test.png and the 1080p frame "
            f"({len(tt_truth)} and {len(swt_truth_1080p())} annotated "
            f"lines), ranges {SWT_SEARCH}, 2 iterations from "
            f"{SWT_SEARCH_START}: card {card_s:.2f} s, CPU {cpu_s:.2f} s "
            f"({n_calls} detect_words calls each); both picked {picked}; "
            f"with them detect_words takes {tt_med:.2f} ms on text_test.png "
            f"and {med:.2f} ms on the 1080p frame ({len(words)} words; "
            f"median); {card}")
    return card_s


def dpm_scene(rng, obj=True, shape=(160, 160), osize=48):
    """tests/test_train_dpm.py's scene: noise, and on a positive a bright
    H-shaped object (strong, horizontally symmetric HOG) at a random
    place; (uint8 image, its box or None)."""
    img = rng.normal(70, 12, shape + (3,))
    bbox = None
    if obj:
        y = int(rng.integers(4, shape[0] - osize - 4))
        x = int(rng.integers(4, shape[1] - osize - 4))
        t = max(4, osize // 7)
        img[y:y + osize, x:x + t] += 120
        img[y:y + osize, x + osize - t:x + osize] += 120
        img[y + osize // 2 - t // 2:y + osize // 2 + t // 2,
            x:x + osize] += 120
        bbox = (x, y, osize, osize)
    return np.clip(img, 0, 255).astype(np.uint8), bbox


def dpm_scenes(rng, n_pos, n_bg, **kw):
    pos = [dpm_scene(rng, True, **kw) for _ in range(n_pos)]
    return ([p[0] for p in pos], [p[1] for p in pos],
            [dpm_scene(rng, False, **kw)[0] for _ in range(n_bg)])


def dpm_model_gap(a, b):
    """The largest difference of a's weights and deformations from b's,
    over b's largest weight; inf where the structure differs."""
    gaps = []
    for r, q in zip(a.roots, b.roots):
        if r.w.shape != q.w.shape or [(p.x, p.y, p.w.shape, p.counterpart)
                                      for p in r.parts] != [
                (p.x, p.y, p.w.shape, p.counterpart) for p in q.parts]:
            return float("inf")
        scale = float(np.abs(q.w).max())
        gaps += [np.abs(r.w - q.w).max() / scale,
                 abs(r.beta - q.beta) / max(1.0, abs(q.beta))]
        for p, s in zip(r.parts, q.parts):
            gaps += [np.abs(p.w - s.w).max() / scale,
                     max(abs(u - v) for u, v in zip(
                         (p.dx, p.dy, p.dxx, p.dyy),
                         (s.dx, s.dy, s.dxx, s.dyy)))]
    return float(max(gaps)) if len(a.roots) == len(b.roots) else float("inf")


def dpm_train_path(dev, card, read):
    """Phase 39: DPM training on the card against the CPU port at
    DPM_TRAIN_TEST, then bin/dpmcreate's published setting on
    DPM_TRAIN_SCENES scenes cut to DPM_TRAIN_DEPTH (the seconds of a
    relabel's latent pass and of a data mining, the SVM fit's ms, the
    latent pass under the profiler), and the model's 1080p detect."""
    from ccv_tpu_torch.detectors import dpm
    from ccv_tpu_torch.train import dpm as tdpm
    rng = np.random.default_rng(39)
    posimgs, bboxes, bgimgs = dpm_scenes(rng, 6, 5)
    params = tdpm.DpmTrainParams(
        detector=tdpm.DpmParams(interval=2, threshold=0.0), **DPM_TRAIN_TEST)
    runs = []
    for where in (dev, torch.device("cpu")):
        tmp = tempfile.mkdtemp(prefix="phase39-")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append((tdpm.mixture_model_new(
                posimgs, bboxes, bgimgs, 16, tmp, params, log=lambda *a: None,
                device=where), time.perf_counter() - t0))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    (a, card_s), (b, cpu_s) = runs
    gap = dpm_model_gap(a, b)
    check(gap <= DPM_TRAIN_TOL, f"DPM training: the card's model lies "
          f"{gap:.3g} of the largest weight from the CPU port's")
    log(39, f"DPM training at tests/test_train_dpm.py's configuration (6 "
            f"positive 160x160 scenes, 5 backgrounds, {DPM_TRAIN_TEST}): "
            f"card {card_s:.2f} s, CPU {cpu_s:.2f} s; the same parts, the "
            f"card's model within {gap:.3g} of the CPU port's largest weight "
            f"(gate {DPM_TRAIN_TOL}); {card}")

    posimgs, bboxes, bgimgs = dpm_scenes(
        rng, DPM_TRAIN_SCENES, DPM_TRAIN_SCENES, shape=(480, 640), osize=56)
    params = tdpm.DpmTrainParams(**DPM_TRAIN_DEPTH)
    timings = {}
    tmp = tempfile.mkdtemp(prefix="phase39-")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = tdpm.mixture_model_new(posimgs, bboxes, bgimgs,
                                       DPM_TRAIN_NEGNUM, tmp, params,
                                       log=lambda *a: None, device=dev,
                                       timings=timings)
        full_s = time.perf_counter() - t0
        back = dpm.read_mixture_model(os.path.join(tmp, "model"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(dpm_model_gap(back, model) == 0.0,
          "the trained DPM model does not read back as written")
    detector = dataclasses.replace(params.detector, threshold=0.0)
    # the profiler's window over DPM_PROFILED positives: its post-processing
    # grows with the device events (~2,000 a positive)
    win = device_window(lambda: [tdpm._collect_best(
        img, model, bbox, params.include_overlap, detector, dev)
        for img, bbox in zip(posimgs[:DPM_PROFILED], bboxes)], 1)
    root = model.roots[0]
    log(39, f"DPM training on the card at bin/dpmcreate's published "
            f"setting (1 component, {params.parts} parts, symmetric, C "
            f"{params.C}, negative cache {params.negative_cache_size}, area "
            f"{params.min_area}-{params.max_area}) on {len(posimgs)} "
            f"positive and {len(bgimgs)} background 640x480 scenes, "
            f"{DPM_TRAIN_NEGNUM} random negatives; depth cut to "
            f"{DPM_TRAIN_DEPTH} (published: relabels 10, data minings 50, "
            f"iterations 1000): {full_s:.2f} s; root {root.w.shape[:2]}, "
            f"{len(root.parts)} parts; initialisation {timings['init_s']:.2f}"
            f" s (the SVM fit {[round(x, 2) for x in timings['svm_fit_ms']]}"
            f" ms, 400 steps, synchronised); a relabel's latent pass "
            f"{[round(x, 2) for x in timings['relabel_s']]} s; a data mining "
            f"{[round(x, 2) for x in timings['mining_s']]} s, of which the "
            f"negatives' collection "
            f"{[round(x, 2) for x in timings['collect_s']]} s and the SGD "
            f"{[round(x, 2) for x in timings['sgd_s']]} s; the "
            f"latent pass over {DPM_PROFILED} positives under torch.profiler: "
            f"{win['events']} device events, busy {win['busy']:.2f} ms of "
            f"{win['wall']:.2f} ms, idle {1 - win['busy'] / win['wall']:.3f};"
            f" {card}")
    # a held-out 1080p scene of the task: one object in the noise
    scene, (x, y, w, h) = dpm_scene(rng, True, shape=(1080, 1920), osize=56)
    img = torch.from_numpy(scene).to(dev)
    dparams = dpm.DpmParams(threshold=0.0)
    found = dpm.detect(img, back, dparams)
    best = max((iou((c.x, c.y, c.width, c.height), (x, y, w, h))
                for c in found), default=0.0)
    check(best > 0.3, f"the trained DPM model at 1080p: {len(found)} rects, "
          f"the best at IoU {best:.3f} with the object")
    med, ms = median_ms(lambda: dpm.detect(img, back, dparams), 3)
    log(39, f"the trained model read back and run by detect on a held-out "
            f"1920x1080 scene (threshold 0): {len(found)} rects, the object "
            f"found at IoU {best:.3f}; median {med:.2f} ms/image "
            f"({', '.join(f'{x:.2f}' for x in ms)}); {card}")
    return full_s


# phase 40, the legacy convnet's trainer (models/convnet.supervised_train)
CIFAR_N = 2048            # seeded 31 x 31 x 3 images, bin/cifar-10's width
CIFAR_EPOCHS = 2
CIFAR_F64_TOL = 1e-9      # the card's float64 step against the CPU's
MATT_B = 64               # bin/image-net's mini-batch, 225 x 225, 1000 classes
MATT_STEPS = 5
MATT_RATE = 1e-4
CNNVLDTR_IMAGES = 8
FP32_PEAK = 67e12         # the H100's float32 ALU peak (TF32 is off)


def conv_train_flops(net, batch):
    """FLOPs of one training step of a wire-format net: 3 x the forward's
    multiply-adds (forward, input gradient, weight gradient) of its
    convolutions and full-connect layers, 2 FLOPs each; pools, LRN and the
    update are left out."""
    fwd, r, c = 0, net.rows, net.cols
    for lay in net.layers:
        if lay.type == 1:   # CONVOLUTIONAL
            r2, c2 = lay.out_shape(r, c)
            fwd += (2 * r2 * c2 * lay.count * lay.rows * lay.cols
                    * lay.channels // lay.partition)
        elif lay.type == 2:  # FULL_CONNECT
            fwd += 2 * lay.node_count * lay.count
        if lay.type != 2:
            r, c = lay.out_shape(r, c)
    return 3 * fwd * batch


def convnet_train_path(dev, card):
    """Phase 40: supervised_train on the card. (a) bin/cifar-10's net at its
    published geometry and settings on 2,048 seeded images, 2 epochs, and
    one step in float64 against the CPU port's; (b) bin/image-net's
    MattNet-C at full width (225 x 225, 1000 classes) at B 64, 5 steps in
    float32: ms a step, its FLOPs and rate, busy and idle under the
    profiler; the working file written, read back on the card and
    classifying; (c) bin/cnnvldtr on (b)'s net's top-5 answers."""
    from ccv_tpu_torch.bin import cifar_10, cnnvldtr, image_net
    from ccv_tpu_torch.models import convnet
    rng = np.random.default_rng(40)
    # (a) the float64 step, card against the CPU
    x = rng.integers(0, 256, (CIFAR_N, 31, 31, 3), dtype=np.uint8)
    y = (x.mean(axis=(1, 2, 3)) > 127.5).astype(np.int64)
    nets = {}
    for where in ("cpu", dev):
        net = cifar_10.cifar10_net(seed=1, device=where)
        for lay in net.layers:
            if lay.w is not None:
                lay.w, lay.bias = lay.w.double(), lay.bias.double()
        convnet.supervised_train(net, x[:128], y[:128],
                                 cifar_10.published_params(1))
        nets[str(where)] = [l for lay in net.layers if lay.w is not None
                            for l in (lay.w, lay.bias)]
    worst = max(float((a.cpu() - b).abs().max() / b.abs().max())
                for a, b in zip(nets[str(dev)], nets["cpu"]))
    check(worst <= CIFAR_F64_TOL, f"cifar-10's float64 step: the card lies "
          f"{worst:.3g} of a leaf's largest from the CPU")
    # the published run
    warm = cifar_10.cifar10_net(seed=2, device=dev)
    convnet.supervised_train(warm, x[:256], y[:256],
                             cifar_10.published_params(1))
    net = cifar_10.cifar10_net(device=dev)
    steps = CIFAR_EPOCHS * (CIFAR_N // 128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = convnet.supervised_train(net, x, y,
                                    cifar_10.published_params(CIFAR_EPOCHS),
                                    tests=(x[:512], y[:512]))
    torch.cuda.synchronize()
    cifar_s = time.perf_counter() - t0
    check(all(np.isfinite(h[0]) for h in hist) and hist[-1][0] < hist[0][0],
          f"cifar-10's loss does not fall: {hist}")
    cifar_flops = conv_train_flops(net, 128)
    log(40, f"(a) bin/cifar-10's net (31 x 31 x 3, 32 / 32 / 64 channels) at "
            f"its published settings (B 128, rate 5e-4, momentum 0.9, decay "
            f"5e-4, flips), {CIFAR_N} seeded images, {CIFAR_EPOCHS} epochs: "
            f"{cifar_s * 1000 / steps:.2f} ms a step ({steps} steps, the "
            f"epochs' test passes on 512 images included), losses "
            f"{[round(h[0], 4) for h in hist]}, test accuracy "
            f"{[h[1] for h in hist]}; a step {cifar_flops / 1e9:.2f} GFLOP; "
            f"one float64 step card = CPU port within {worst:.3g} of each "
            f"leaf's largest (gate {CIFAR_F64_TOL}); {card}")
    # (b) MattNet-C at full width
    t0 = time.perf_counter()
    net = image_net.matt_c_net(device=dev)
    draw_s = time.perf_counter() - t0
    # the seeded pixels' mean image (127.5) comes off, and the rate is
    # MATT_RATE: at bin/image-net's 0.01 on raw pixels the loss leaves
    # float32's range within two steps (on the CPU port too)
    net.mean_activity = torch.full((225, 225, 3), 127.5, device=dev)
    xm = rng.integers(0, 256, ((MATT_STEPS + 1) * MATT_B, 225, 225, 3),
                      dtype=np.uint8)
    ym = rng.integers(0, 1000, len(xm))
    params = convnet.ConvnetTrainParams(max_epoch=1, mini_batch=MATT_B,
                                        learn_rate=MATT_RATE)
    convnet.supervised_train(net, xm[:MATT_B], ym[:MATT_B], params)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = convnet.supervised_train(net, xm[MATT_B:], ym[MATT_B:], params)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1000 / MATT_STEPS
    check(np.isfinite(hist[0][0]), f"MattNet-C's loss {hist}")
    flops = conv_train_flops(net, MATT_B)
    profile_head()
    w = device_window(lambda: convnet.supervised_train(
        net, xm[:2 * MATT_B], ym[:2 * MATT_B], params), 1)
    tmp = tempfile.mkdtemp(prefix="ccv_convnet_")
    try:
        path = os.path.join(tmp, "image-net.sqlite3")
        t0 = time.perf_counter()
        net.write(path)
        write_s = time.perf_counter() - t0
        back = convnet.Convnet.read(path, device=dev)
        check(all(torch.equal(a.w, b.w) for a, b in zip(net.layers,
                                                        back.layers)
                  if a.w is not None), "MattNet-C's working file changed it")
        img = torch.from_numpy(rng.integers(0, 256, (256, 256, 3),
                                            dtype=np.uint8)).to(dev)
        top = back.classify(img)
        mine = net.classify(img)
        check(len(top) == 5 and [c for c, _p in top] == [c for c, _p in mine]
              and max(abs(p - q) for (_c, p), (_d, q) in zip(top, mine))
              <= 1e-6 and 0 < sum(p for _c, p in top) <= 1.0 + 1e-6,
              f"MattNet-C read back classifies {top}, in memory {mine}")
        # (c) cnnvldtr on its answers for training images
        with open(os.path.join(tmp, "truth.txt"), "w") as f:
            f.writelines(f"{int(v)}\n" for v in ym[:CNNVLDTR_IMAGES])
        with open(os.path.join(tmp, "result.txt"), "w") as f:
            for i in range(CNNVLDTR_IMAGES):
                ranks = back.classify(torch.from_numpy(xm[i]).to(dev))
                f.write(" ".join(f"{c} {p:f}" for c, p in ranks) + "\n")
        code, lines = captured(cnnvldtr.main, [
            os.path.join(tmp, "truth.txt"), os.path.join(tmp, "result.txt")])
        check(code == 0 and len(lines) == 1 and lines[0].endswith("% (5)"),
              f"cnnvldtr printed {lines}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(40, f"(b) bin/image-net's MattNet-C at full width (225 x 225 x 3, "
            f"1000 classes, scale 1.0; weights drawn in {draw_s:.1f} s), B "
            f"{MATT_B}, float32, rate {MATT_RATE}, the mean image 127.5 "
            f"taken off: {step_ms:.2f} ms a step (mean of "
            f"{MATT_STEPS} after a warm-up step), loss {hist[0][0]:.4f}; a "
            f"step {flops / 1e12:.3f} TFLOP (3 x the convolutions' and "
            f"full-connect layers' forward) = {flops / step_ms / 1e9:.2f} "
            f"TFLOP/s, {flops / step_ms / 1e-3 / FP32_PEAK:.3f} of the "
            f"float32 peak; 2 steps under torch.profiler: busy "
            f"{w['busy']:.2f} ms of a {w['wall']:.2f} ms wall, idle share "
            f"{1 - w['busy'] / w['wall']:.3f}, largest: "
            f"{top_kernels(w['by_name'])}; the working file "
            f"written in {write_s:.2f} s, read back on the card (weights "
            f"equal) and classifying a 256 x 256 image as the net does "
            f"({top[0]}); (c) bin/cnnvldtr on its top 5 for "
            f"{CNNVLDTR_IMAGES} training images: {lines[0]}; {card}")
    return dict(cifar_ms=cifar_s * 1000 / steps, matt_ms=step_ms,
                matt_tflops=flops / step_ms / 1e9, idle=1 - w["busy"] / w[
                    "wall"], f64=worst)


@contextlib.contextmanager
def cpu_sat_forms(algebra, autotune):
    """While open, ``algebra.sat_auto`` on a CPU tensor takes the form the
    card recorded for the same shape, dtype and padding (else ``sat``), so
    the CPU port runs the card's SAT forms (``sat_mxu`` rounds its float64
    sums once: the card's and the CPU's bits agree)."""
    recs = {}
    for key, rec in autotune.decisions().items():
        op, kind, sig, extra = key.split("|")
        if op == "sat" and kind != "cpu":
            recs[sig, extra] = rec["choice"]
    auto = algebra.sat_auto

    def follow(a, padding=algebra.NO_PADDING):
        if (a.device.type == "cpu" and recs.get(
                (autotune._sig_of(a), f"pad{padding}")) == "sat_mxu"):
            return algebra.sat_mxu(a, padding)
        return auto(a, padding)

    algebra.sat_auto = follow
    try:
        yield recs
    finally:
        algebra.sat_auto = auto


def autotune_path(scd, k1, k3, dev, card, frame, face_med, icf_res):
    """Phase 41: nn/autotune on the card, from an empty store. SCD's
    form="auto" on the 1080p frame (face_low at phase 5's near-median
    thresholds): per octave the recorded choice between K1's and K3's
    octave programs and both times on zeros, both forms' times on the real
    octave, K1 and K3 launched by the measurement, the detections equal to
    form="pallas_full"'s (windows only in the margin may differ), a second
    call measuring nothing. Then sat_auto at ICF's colour 1080p level
    shapes (the choice and both times per shape) under phase 19's colour
    cascade, held against the CPU port on the card's SAT forms by phase
    19's gate. Returns (K1, K3) launches in the first auto call."""
    from ccv_tpu_torch.core import algebra
    from ccv_tpu_torch.detectors import icf
    from ccv_tpu_torch.nn import autotune
    tmp = tempfile.mkdtemp(prefix="ccv_autotune_")
    saved = {k: os.environ.pop(k, None) for k in ("CCV_TPU_SAT",
                                                  "CCV_TPU_AUTOTUNE")}
    os.environ["CCV_TPU_AUTOTUNE_CACHE"] = os.path.join(tmp, "at.json")
    autotune.clear()
    try:
        img = torch.from_numpy(frame).to(dev)
        params = scd.ScdParams(min_neighbors=0)
        specs, scale_upto = scd._level_specs(*frame.shape, face_med, params)
        before = autotune.stats()
        k1.LAUNCHES = k3.LAUNCHES = 0
        t0 = time.perf_counter()
        handle = scd.detect_async(img, face_med, params, form="auto")
        got = scd.detect_collect(handle)
        first_s = time.perf_counter() - t0
        launches = (k1.LAUNCHES, k3.LAUNCHES)
        measured = autotune.stats_delta(before)
        n_oct = len(handle.layout)
        check(measured == {"hits": 0, "measured": n_oct},
              f"auto's first call: {measured} for {n_oct} octaves")
        check(launches[0] > 0 and launches[1] > 0, f"auto's measurement "
              f"launched K1 {launches[0]} and K3 {launches[1]} times")
        want = scd.detect(img, face_med, params)
        odd = rect_set(got) ^ rect_set(want)
        if odd:
            near = margin_rects(scd, k1, img, face_med, params, dev)
            check(odd <= near, f"auto: {len(odd - near)} windows differ "
                               f"from pallas_full's outside the margin")
        before = autotune.stats()
        again = scd.detect(img, face_med, params, form="auto")
        check(autotune.stats_delta(before) == {"hits": n_oct, "measured": 0}
              and again == got, f"auto's second call: "
              f"{autotune.stats_delta(before)}")
        rows, findings = [], []
        zero = torch.zeros((), device=dev)
        for (octave, src, lspecs, _sat, _dims), entry in zip(
                scd._octaves(img[None, ..., None], specs, scale_upto,
                             face_med.margin), handle.layout):
            args = (torch.zeros(tuple(src.shape[1:]), dtype=src.dtype,
                                device=dev), zero)
            extra = scd._octave_extra(lspecs, face_med, STEP, False)
            rec = autotune.decisions()[autotune._key(scd.OCTAVE_OP, args,
                                                     extra)]
            check(rec["choice"] == entry[0] and all(
                v is not None for v in rec["ms"].values()),
                f"octave {octave}: record {rec}, ran {entry[0]}")
            real = {f: time_cuda(lambda f=f: scd._octave_program(
                f, lspecs, face_med, STEP)(src[0], zero), 5)
                for f in scd.AUTO_FORMS}
            faster = min(real, key=real.get)
            if faster != rec["choice"]:
                findings.append(octave)
            rows.append(f"octave {octave} ({len(lspecs)} levels, "
                        f"{tuple(src.shape[1:3])}): chose {rec['choice']}; "
                        f"on zeros " + ", ".join(
                            f"{k} {v:.4f}" for k, v in rec["ms"].items())
                        + " ms; on the frame " + ", ".join(
                            f"{k} {v:.4f}" for k, v in real.items()) + " ms")
        auto_ms = detect_ms(scd, img, face_med, params, "auto", 3)
        full_ms = detect_ms(scd, img, face_med, params, "pallas_full", 3)
        log(41, f"SCD form='auto' on the 1920x1080 frame, face_low at "
                f"near-median thresholds, from an empty store: the first "
                f"call {first_s:.2f} s ({n_oct} octaves measured, K1 "
                f"{launches[0]} and K3 {launches[1]} launches in it); "
                f"{len(got)} windows = pallas_full's ({len(odd)} in the "
                f"margin); the second call hit {n_oct} records, measured "
                f"none; per octave program (1 + 2 x 8 calls on zeros, then 5 "
                f"on the frame's octave, CUDA events): " + "; ".join(rows)
                + f"; detect median ms/image (n=3): auto "
                f"{float(np.median(auto_ms)):.2f}, pallas_full "
                f"{float(np.median(full_ms)):.2f}; {card}")
        if findings:
            log(41, f"FINDING: on octaves {findings} the measurement on "
                    f"zeros chose the form that is slower on the frame's "
                    f"octave (the rule is kept)")
        # sat_auto at ICF's colour 1080p levels
        res = icf_res["colour"]
        casc, rgb = res["cascade"], res["image"]
        before = autotune.stats()
        t0 = time.perf_counter()
        icf.detect_objects(rgb.to(dev), casc)
        icf_s = time.perf_counter() - t0
        sat_measured = autotune.stats_delta(before)["measured"]
        recs = {k: v for k, v in autotune.decisions().items()
                if k.startswith("sat|")}
        check(len(recs) == sat_measured > 0 and all(
            all(ms is not None for ms in r["ms"].values())
            for r in recs.values()), f"sat_auto recorded {recs}")
        mxu = sum(r["choice"] == "sat_mxu" for r in recs.values())
        log(41, f"ICF colour 1080p detect_objects with sat_auto measuring "
                f"{len(recs)} level shapes: {icf_s:.2f} s; sat_mxu chosen at "
                f"{mxu}")
        # card = CPU on the top-left quarter (depth cut in PR 19: at 1080p
        # the CPU run took 61-103 s), its level shapes' forms measured on
        # the card first, so the CPU port follows them
        held = rgb[:ICF_HELD[0], :ICF_HELD[1]]
        icf.detect_objects(held.to(dev), casc)
        with cpu_sat_forms(algebra, autotune):
            n, odd_i, diff, cpu_s = icf_card_vs_cpu(
                icf, casc, held, dev, "colour, sat_auto")
        shapes = "; ".join(
            f"{k.split('|')[2]} {k.split('|')[3]}: {r['choice']} (sat "
            f"{r['ms']['sat']:.3f}, sat_mxu {r['ms']['sat_mxu']:.3f} ms)"
            for k, r in sorted(recs.items(), key=lambda kv: kv[0]))
        log(41, f"sat_auto in ICF's colour 1080p detect_objects (phase 19's "
                f"cascade): {len(recs)} level shapes measured in "
                f"{icf_s:.2f} s, sat_mxu chosen at {mxu}: {shapes}; card = "
                f"the CPU port on the card's SAT forms on "
                f"{tuple(held.shape[:2])}: {n} windows ({odd_i} differ, all "
                f"in the margin), max conf diff {diff:.3g} (the CPU run "
                f"{cpu_s:.1f} s); {card}")
        return launches
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
        os.environ.pop("CCV_TPU_AUTOTUNE_CACHE", None)
        autotune._MEM = None
        shutil.rmtree(tmp, ignore_errors=True)


def forms_path(scd, k1, dev, card, frame, face_med, icf_res):
    """Phase 42: the explicit forms at 1080p on the card. SCD's plain staged
    forms (slices, xla, matmul; dense B1 on the card) against the default
    pallas_full (windows only in the margin may differ) and ICF's fused
    forms (slices, matmul) against its default staged form (phase 19's
    colour cascade; windows only near a threshold may differ), with ms of
    each."""
    from ccv_tpu_torch.detectors import icf
    img = torch.from_numpy(frame).to(dev)
    params = scd.ScdParams(min_neighbors=0)
    want = rect_set(scd.detect(img, face_med, params))
    near = None
    rows = []
    for form in scd.PLAIN_FORMS:
        reruns = scd.RERUNS
        got = rect_set(scd.detect(img, face_med, params, form=form))
        reruns = scd.RERUNS - reruns
        odd = got ^ want
        if odd:
            near = near or margin_rects(scd, k1, img, face_med, params, dev)
            check(odd <= near, f"SCD {form}: {len(odd - near)} windows "
                               f"differ from pallas_full's outside the "
                               f"margin")
        ms = detect_ms(scd, img, face_med, params, form, 1)
        rows.append(f"{form} {ms[0]:.2f} ms ({len(odd)} in the margin, "
                    f"{reruns} reruns)")
        log(42, f"SCD form {form}: {rows[-1]}")
    full = detect_ms(scd, img, face_med, params, "pallas_full", 1)
    log(42, f"SCD's plain staged forms at 1920x1080 (face_low at near-median "
            f"thresholds, min_neighbors 0), {len(want)} windows each = "
            f"pallas_full's, ms of one image after the checked one: "
            + "; ".join(rows) + f"; pallas_full {full[0]:.2f} ms; {card}")
    res = icf_res["colour"]
    casc, rgb = res["cascade"], res["image"].to(dev)
    iparams = icf.IcfParams(min_neighbors=0)
    t0 = time.perf_counter()
    base = icf_windows(icf.detect_objects(rgb, casc, iparams))
    log(42, f"ICF staged form: {len(base)} windows in "
            f"{time.perf_counter() - t0:.2f} s")
    rows = []
    for form in ("slices", "matmul"):
        reruns = icf.RERUNS
        t0 = time.perf_counter()
        got = icf_windows(icf.detect_objects(rgb, casc, iparams, form=form))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000
        # slices: the staged form's node arithmetic; matmul: node values
        # from float64 products, where a node within the SAT's float32
        # rounding of 0 may vote the other way (a whole vote, |w1 - w0|)
        both = set(got) & set(base)
        diff = max((abs(got[r] - base[r]) for r in both), default=0.0)
        if form == "slices":  # the staged form's node arithmetic
            n, odd, diff = icf_gate(icf, casc, rgb, got, base,
                                    "ICF slices vs staged")
            note = f"{odd} in the margin"
        else:
            n, flips = icf_matmul_gate(icf, casc, rgb, got, base)
            check(len(both) > 0, "ICF matmul: no window passed")
            note = (f"{len(set(got) ^ set(base))} found by one form only; "
                    f"{n} windows recomputed, {flips} nodes on the other "
                    f"side of 0 by rounding")
        rows.append(f"{form} {ms:.2f} ms ({len(got)} windows, {note}, "
                    f"{icf.RERUNS - reruns} reruns, max conf diff "
                    f"{diff:.3g})")
        log(42, f"ICF form {form}: {rows[-1]}")
    staged_ms = median_ms(lambda: icf.detect_objects(rgb, casc, iparams), 2)[0]
    log(42, f"ICF's fused forms at 1920x1080 (phase 19's colour cascade, "
            f"{ICF_TREES} trees, min_neighbors 0) against the staged form's "
            f"{len(base)} windows: " + "; ".join(rows) + f"; staged "
            f"{staged_ms:.2f} ms; {card}")


def main():
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--nccl-cards"]:
        # phase 32 (b) alone over NCCL, a rank a card: a four-card machine
        from ccv_tpu_torch.device import default_device
        default_device()  # raises without a card: no result is printed
        card = "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines())
        parallel_cards(int(sys.argv[2]), card)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    from ccv_tpu_torch.core.io import IO_RGB_COLOR, read
    from ccv_tpu_torch.detectors import scd
    from ccv_tpu_torch.device import default_device
    from ccv_tpu_torch.ops import resample
    from ccv_tpu_torch.ops.kernels import flash_attention as k2
    from ccv_tpu_torch.ops.kernels import roofline
    from ccv_tpu_torch.ops.kernels import scd_cascade as k1
    from ccv_tpu_torch.ops.kernels import scd_phase as k3

    dev = default_device()  # raises without a card: no result is printed
    # every phase but 41 runs ICF's SAT as "sat", as before sat_auto: phase
    # 41 lets the card measure its forms
    os.environ["CCV_TPU_SAT"] = "sat"
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(1, f"device {kind}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}; nvidia-smi: {card}")
    # phase 26's CPU reference runs in the CPU child from here on
    CPU_REFS["tld"] = cpu_pool().submit(tld_cpu_reference)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        for fut in [ex.submit(k.build) for k in (k1, k2, k3)]:
            fut.result()
    log(2, f"K1, K2 and K3 built and loaded in "
           f"{time.perf_counter() - t0:.2f} s from ccv_tpu_torch/csrc/"
           f"{{scd_cascade,flash_attention_sm90,"
           f"flash_attention_tf32,scd_phase}}.cu for sm_90a")

    # -- 3: K1 against its plain version on the card ------------------------
    max_err = 0.0
    rng = np.random.default_rng(7)
    # the last: 1,100 features, past the 512 whose records a block holds at
    # once, so the kernel stages them in runs
    for dims, counts in (([[11, 21]], (2, 3, 4, 5)), ([[8, 128]], (2, 3, 4, 5)),
                         ([[17, 140]], (2, 3, 4, 5)),
                         ([[13, 140], [9, 100], [5, 60]], (2, 3, 4, 5)),
                         ([[9, 37], [6, 20]], (100, 700, 300))):
        dims = np.asarray(dims)
        cascade = synth_cascade(scd, rng, counts)
        H1 = (dims[:, 0].max() - 1) * STEP + cascade.height + 1
        W1 = (dims[:, 1].max() - 1) * STEP + cascade.width + 1
        sat_l = torch.from_numpy(rng.normal(0, 10, (len(dims), 8, H1, W1))
                                 .astype(np.float32)).to(dev)
        cascade = with_median_thresholds(scd, k1, cascade, sat_l, dims)
        err, n, near = kernel_vs_plain(scd, k1, cascade, sat_l, dims)
        max_err = max(max_err, err)
        log(3, f"synthetic, stages {counts}, dims {dims.tolist()}: {n} "
               f"passed, {near} in the margin, max conf diff {err:.3g}")
    face = scd.load_cascade(os.path.join(DATA, "face_low.sqlite3"))
    frame = frame_1080p(read)
    frame_t = torch.from_numpy(frame).to(dev)[..., None]
    specs, _ = scd._level_specs(*frame.shape, face, scd.ScdParams())
    dims0 = np.array([specs[0][4:6]])
    sat0 = scd._sat_cf8(scd.scd_map_cf8(frame_t))[None].contiguous()
    face_med = with_median_thresholds(scd, k1, face, sat0, dims0)
    err, n, near = kernel_vs_plain(scd, k1, face_med, sat0, dims0)
    max_err = max(max_err, err)
    log(3, f"face cascade, median thresholds {face_med.thresholds.tolist()},"
           f" 1080p level-0 SAT {tuple(sat0.shape)} dims {dims0.tolist()}: "
           f"{n} passed, {near} in the margin, max conf diff {err:.3g}")
    err_open, n_open, _ = kernel_vs_plain(scd, k1, face, sat0, dims0)
    max_err = max(max_err, err_open)
    log(3, f"face cascade, open thresholds, same SAT: {n_open} passed, max "
           f"conf diff {err_open:.3g}")
    tabs_med, tabs_open = scd.cascade_tables(face_med), scd.cascade_tables(face)
    ms = time_cuda(lambda: k1.cascade_eval_levels(sat0, tabs_med, STEP, dims0),
                   20)
    planes_ms = time_cuda(
        lambda: k1.kernel_planes(sat0, tabs_med, STEP, dims0), 20)
    plain_ms = time_cuda(
        lambda: k1.cascade_eval_levels_ref(sat0, tabs_med, STEP, dims0), 3)
    ms_open = time_cuda(
        lambda: k1.cascade_eval_levels(sat0, tabs_open, STEP, dims0), 5)
    plain_open = time_cuda(
        lambda: k1.cascade_eval_levels_ref(sat0, tabs_open, STEP, dims0), 2)
    # the bound: the features each window reaches, from the plain sums
    k1_bound, k1_by = roofline.bound_ms(
        *k1.cascade_work(sat0, tabs_med, STEP, dims0), "f32")
    open_bound, open_by = roofline.bound_ms(
        *k1.cascade_work(sat0, tabs_open, STEP, dims0), "f32")
    log(3, f"K1 at the 1080p level-0 shape on {card}: median thresholds "
           f"{ms:.3f} ms (plain {plain_ms:.3f} ms, bound {k1_bound:.4f} ms "
           f"by {k1_by}); open thresholds {ms_open:.3f} ms (plain "
           f"{plain_open:.3f} ms, bound {open_bound:.4f} ms by {open_by}); "
           f"of each, the phase-plane copy {planes_ms:.4f} ms")

    # -- the prolog on the card against the CPU ----------------------------
    tt = read(os.path.join(DATA, "text_test.png"), device="cpu")
    for name, img in (("640x480", tt.tensor), ("1080p", torch.from_numpy(
            frame))):
        H, W = img.shape
        for (o, k, rows, cols, *_r) in scd._level_specs(
                H, W, face, scd.ScdParams())[0]:
            if o == 0 and k > 0:
                args = dict(rows=rows, cols=cols, rows_scale=rows / H,
                            cols_scale=cols / W)
                cpu = resample.resample(img, **args)
                gpu = resample.resample(img.to(dev), **args).cpu()
                check(torch.equal(cpu, gpu), f"{name} INTER_AREA to "
                      f"{rows}x{cols} differs between the card and the CPU")
        check(torch.equal(resample.sample_down(img),
                          resample.sample_down(img.to(dev)).cpu()),
              f"{name} sample_down differs between the card and the CPU")
        m_cpu = scd.scd_map_cf8(img[..., None])
        m_gpu = scd.scd_map_cf8(img.to(dev)[..., None])
        check(torch.equal(m_cpu, m_gpu.cpu()),
              f"{name} scd_map_cf8 differs between the card and the CPU")
        s_cpu, s_gpu = scd._sat_cf8(m_cpu), scd._sat_cf8(m_gpu).cpu()
        rel = float((s_cpu - s_gpu).abs().max() / s_cpu.abs().max())
        log(3, f"{name} prolog: INTER_AREA levels, sample_down and "
               f"scd_map_cf8 bit-exact card vs CPU; SAT max diff {rel:.3g} "
               f"of its largest value")

    # -- 4: the main path, crop180 against the C goldens --------------------
    k1.LAUNCHES = 0
    crop = read(os.path.join(DATA, "crop180.png"), IO_RGB_COLOR, device=dev)
    for interval, golden, tol in ((1, "crop180.scd_i1.txt", 6e-3),
                                  (5, "crop180.scd_open.txt", 2e-2)):
        params = scd.ScdParams(min_neighbors=0, interval=interval)
        n_oct = len({s[0] for s in scd._level_specs(180, 180, face, params)[0]})
        before = k1.LAUNCHES
        out = scd.detect(crop, face, params)
        check(k1.LAUNCHES - before == n_oct,
              f"detect launched K1 {k1.LAUNCHES - before} times for "
              f"{n_oct} octaves")
        ref = golden_rects(golden)
        mine = {(c.x, c.y, c.width, c.height): c.confidence for c in out}
        check(set(mine) == set(ref), f"crop180 interval={interval}: "
              f"{len(mine)} windows vs {len(ref)} in {golden}")
        diff = max(abs(mine[r] - ref[r]) for r in ref)
        check(diff < tol, f"crop180 interval={interval}: conf diff {diff}")
        log(4, f"crop180 interval={interval}: {len(mine)} windows = "
               f"{golden}, max conf diff {diff:.3g} (< {tol}), {n_oct} "
               f"K1 launches")

    # -- 5: real sizes, kernel against the plain evaluator ------------------
    params = scd.ScdParams(min_neighbors=0)
    for name, img, cascade, reps in (
            ("640x480", tt.tensor.to(dev), face, 6),
            ("1920x1080", torch.from_numpy(frame).to(dev), face_med, 6)):
        H, W = img.shape
        n_oct = len({s[0] for s in scd._level_specs(H, W, cascade,
                                                    params)[0]})
        before = k1.LAUNCHES
        got = rect_set(scd.detect(img, cascade, params))
        check(k1.LAUNCHES - before == n_oct, f"{name}: detect launched K1 "
              f"{k1.LAUNCHES - before} times for {n_oct} octaves")
        want = rect_set(scd.detect(img, cascade, params,
                                   evaluate=k1.cascade_eval_levels_ref))
        check(len(want) > 0, f"{name}: no windows passed")
        odd = got ^ want
        if odd:
            near = margin_rects(scd, k1, img, cascade, params, dev)
            check(odd <= near, f"{name}: {len(odd - near)} windows differ "
                               f"outside the margin")
        timings = []  # per-image ms: (kernel, plain)
        for evaluate, n in ((None, reps), (k1.cascade_eval_levels_ref, 2)):
            scd.detect(img, cascade, params, evaluate=evaluate)  # warm-up
            ms_each = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scd.detect(img, cascade, params, evaluate=evaluate)
                torch.cuda.synchronize()
                ms_each.append((time.perf_counter() - t0) * 1000)
            timings.append(ms_each)
        med, worst = float(np.median(timings[0])), max(timings[0])
        log(5, f"{name}: {len(got)} windows, kernel = plain ({len(odd)} in "
               f"the margin); detect with K1: median {med:.2f} ms/image "
               f"(max {worst:.2f}, n={reps}) = {H * W / 1e3 / med:.3f} MP/s; "
               f"with the plain evaluator: median "
               f"{float(np.median(timings[1])):.2f} ms/image (n=2); {card}")
    profiled = (img, cascade, params)  # the 1080p frame, phase 10
    # the crop180 open-threshold windows against the C golden, scored by
    # the ported vldtr scorer (Pascal VOC, IoU >= 0.5)
    from ccv_tpu_torch.utils import deteval
    est = [dict(x=float(c.x), y=float(c.y), width=float(c.width),
                height=float(c.height)) for c in scd.detect(crop, face,
                                                            params)]
    truth = [dict(x=float(x), y=float(y), width=float(w), height=float(h))
             for (x, y, w, h) in golden_rects("crop180.scd_open.txt")]
    precision, recall = deteval.pascal_score({"crop180": truth},
                                             {"crop180": est})
    check(precision == recall == 1.0, f"crop180 against its golden: "
          f"precision {precision}, recall {recall}")
    log(5, f"crop180 open thresholds (interval 5) against "
           f"crop180.scd_open.txt, utils.deteval.pascal_score: precision "
           f"{precision:.4f}, recall {recall:.4f} ({len(est)} windows, "
           f"{len(truth)} in the golden)")
    launches = k1.LAUNCHES
    check(launches > 0, "the main path launched K1 no time")
    kernels = [{
        "name": "scd_cascade", "route": "cuda",
        "source": "ccv_tpu_torch/csrc/scd_cascade.cu",
        "replaces": "ccv_tpu/ops/pallas/scd_cascade.py:58",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": k1_bound,
        "bound_by": k1_by, "library_ms": None, "design": "planes-compact",
        "open_ms": ms_open, "open_bound_ms": open_bound,
        "planes_ms": planes_ms}]

    # -- 6: K2 against its plain version on the card -----------------------
    k2_err, k2_res = k2_vs_plain(k2, roofline, dev, card)
    k2_d32 = k2_d32_path(k2, roofline, dev, card)

    # -- 7: the LM training step -------------------------------------------
    lm_two_layers(k2, dev)
    from ccv_tpu_torch.bin import lm_bench, staged_profile
    k2.reset_launches()
    res = lm_bench.measure(steps=LM_STEPS)
    k2_launches = dict(k2.LAUNCHES)
    k2_designs = {key: dict(c) for key, c in k2.DESIGN_LAUNCHES.items()}
    steps, layers = 1 + LM_STEPS, 24
    want = {"fwd": 2 * layers * steps, "dq": layers * steps,
            "dkv": layers * steps}  # remat recomputes the forward
    check(k2_launches == want, f"lm_bench launched K2 {k2_launches}, "
                               f"expected {want}")
    check(k2_designs == {key: {**dict.fromkeys(k2.DESIGNS, 0),
                               "wgmma-tma": n} for key, n in want.items()},
          f"lm_bench ran the K2 designs {k2_designs}")
    losses = res["losses"]
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"loss does not fall: {losses}")
    log(7, f"lm_bench {res['model']} ({res['params_m']} M params), batch "
           f"{res['batch']} x seq {res['seq']}, bf16, remat "
           f"{res['remat_policy']}, flash: step {res['step_ms']:.2f} ms "
           f"(mean of {LM_STEPS} after a warm-up of {res['warmup_s']:.2f} s), "
           f"{res['tokens_per_s']:.0f} tokens/s, "
           f"{res['model_tflops_per_s']:.2f} model TFLOP/s, MFU "
           f"{res['mfu']:.4f} of {res['peak_tflops']:.0f} TFLOP/s; peak "
           f"memory {res['peak_mem_gb']:.2f} GB; losses "
           f"{[round(x, 4) for x in losses]}; K2 launches by design "
           f"{k2_designs}; {card}")

    sources = {"fwd": ("flash_attention_fwd", "flash_attention.py:36",
                       "flash_attention_sm90.cu", "wgmma-tma"),
               "dq": ("flash_attention_dq", "flash_attention.py:173",
                      "flash_attention_sm90.cu", "wgmma-tma"),
               "dkv": ("flash_attention_dkv", "flash_attention.py:210",
                       "flash_attention_sm90.cu", "wgmma-tma")}
    for key, (name, line, src, design) in sources.items():
        r = k2_res[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ccv_tpu_torch/csrc/{src}",
            "replaces": f"ccv_tpu/ops/pallas/{line}",
            "launches": k2_launches[key], "max_abs_err": k2_err[key],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "design": design,
            **({} if key == "fwd" else {
                "library_note": "one flash backward call: dq, dk and dv"})})

    # -- 8: K3 against its plain version on the card -----------------------
    k3_res = k3_vs_plain(scd, k1, k3, roofline, dev, card, sat0, dims0, face,
                         face_med)

    # -- 9: the staged cascade and detect_batch -----------------------------
    k3_launches = staged_path(scd, k1, k3, dev, card, crop, tt, frame, face,
                              face_med)
    check(k3_launches > 0, "the staged path launched K3 no time")

    # -- 11: the up-scaled detect, both forms; 12: the server on the card
    # (before 10, whose profiler may slow the host for what follows) -------
    k1_up, k3_up, up_params = upscaled_path(
        scd, k1, k3, dev, card, frame, face)
    k1_served = served_path(scd, k1, dev, card, frame, face_med)

    # -- 13: image classification on the card (its profile comes last) ----
    vgg_model, vgg_x, _ = classification_path(dev, card)

    # -- 14-18: the encoder-decoder and the encoder classifier (their
    # profiles come last) ---------------------------------------------------
    k2_slice_err, k2_decode = k2_slice_shapes(k2, roofline, dev, card)
    seq2seq_card_vs_cpu(dev, card)
    decode_res, decode_step = decode_path(dev, card)
    wmt_res, wmt_steps, _ = wmt_step_path(dev, card)
    imdb_path(dev, card)
    fit_d32 = fit_d32_path(k2, dev, card)

    # -- 19-21: ICF, SWT and SIFT (their profiles come last) ---------------
    icf_res, icf_profile = icf_path(dev, card, read)
    _swt_res, swt_profile = swt_path(dev, card, read)
    _sift_res, sift_profile = sift_path(dev, card, read)

    # -- 22-26: BBF, DPM, MSER / MSCR, DAISY, TLD (their profiles come
    # last) -----------------------------------------------------------------
    slice_profiles = [path(dev, card, read)[1] for path in (
        bbf_path, dpm_path, mser_path, daisy_path, tld_path)]

    # -- 27-28: ccv's classic surface and SWT's device letter route (their
    # profiles come last) ---------------------------------------------------
    slice_profiles += [path(dev, card, read)[1] for path in (
        classic_path, swt_device_path)]

    # -- 29-30: the graph model's ResNet50-v1d-FPN + RPN path, and the rest
    # of nn on the card against the CPU (29's profile comes last) ----------
    _resnet_res, resnet_profile = resnet_path(dev, card)
    k2_layer, nn_rest_profile = nn_rest_path(dev, card, k2)

    # -- 31: training: Model.fit through K2 (path B), the coco trainer (path
    # A) and the rest of the slice (their profiles come last) ---------------
    fit_res, fit_profile = fit_path(dev, card, k2, roofline)
    coco_card_vs_cpu(dev, card)
    coco_f32_gap(dev, card)
    _coco_res, coco_profile = coco_path(dev, card)
    train_rest_path(dev, card)

    # -- 32: parallelism on torch.distributed, in child processes ---------
    par = parallel_path(dev, card)

    # -- 33-34: K2 at head dim 128, and the LM at head dim 128 -------------
    k2_d128_err, k2_d128 = k2_d128_path(k2, roofline, dev, card)
    k2_d128_launches, _lm_d128 = lm_d128_path(k2, dev, card)
    k2_d128_s2s = s2s_d128_path(k2, dev, card)

    # -- 35-36: SCD training (its cascade on K1) and ICF training ---------
    k1_trained = scd_train_path(scd, k1, dev, card, read)
    icf_train_path(dev, card)

    # -- 37-39: BBF, SWT and DPM training (no kernel on their paths) -------
    t0 = time.perf_counter()
    bbf_train_path(dev, card, read)
    swt_train_path(dev, card, read)
    dpm_train_path(dev, card, read)
    log(39, f"phases 37-39 took {time.perf_counter() - t0:.1f} s")

    # -- 40-42: the legacy convnet's trainer, autotune's measured choices
    # (K1 against K3 per SCD octave, the SAT forms) and the explicit forms -
    t0 = time.perf_counter()
    convnet_train_path(dev, card)
    k1_auto, k3_auto = autotune_path(scd, k1, k3, dev, card, frame, face_med,
                                     icf_res)
    forms_path(scd, k1, dev, card, frame, face_med, icf_res)
    log(42, f"phases 40-42 took {time.perf_counter() - t0:.1f} s")

    # -- 43: K2 at head dims above 128 and in float16: the kernels, the LM
    # at Gemma-2B's widths, greedy decoding and Model.fit at D 256 ---------
    t0 = time.perf_counter()
    k2_wide = k2_d256_path(k2, roofline, dev, card)
    lm_d256 = lm_d256_path(k2, dev, card)
    decode_d256, _ = decode_d256_path(k2, dev, card)
    fit_d256 = fit_d256_path(k2, dev, card)
    log(43, f"phase 43 took {time.perf_counter() - t0:.1f} s")

    # -- 10: the card's busy time in a 1080p detect, both forms (last: the
    # profiler may leave the host slower for what follows) -----------------
    img, cascade, params = profiled
    busy, by_name, wall = device_ms(lambda: scd.detect(img, cascade, params),
                                    PROFILED_IMAGES)
    k1_dev = sum(v for key, v in by_name.items()
                 if "scd_cascade_kernel" in key)
    log(10, f"1920x1080 detect under torch.profiler ({PROFILED_IMAGES} "
            f"images): device busy "
            f"{busy:.2f} ms per image over a wall of {wall:.2f} ms per image "
            f"in the same window (profiler overhead included): idle share "
            f"{1 - busy / wall:.3f}; K1 {k1_dev:.3f} ms of it; {card}")
    busy, by_name, wall = device_ms(
        lambda: scd.detect(img, cascade, params, form="pallas"),
        PROFILED_IMAGES)
    part = staged_profile.split(by_name)
    log(10, f"1920x1080 detect(form='pallas') under torch.profiler "
            f"({PROFILED_IMAGES} images): device busy {busy:.2f} ms per image over a wall of "
            f"{wall:.2f} ms per image: idle share {1 - busy / wall:.3f}; K3 "
            f"{part['k3_ms']:.3f} ms of it, the B2 gathers "
            f"{part['gather_ms']:.3f} ms; the largest device ms per image: "
            + "; ".join(f"{key} {v:.3f}" for key, v in part["top"])
            + f"; {card}")
    cubic_device_ms(scd, dev, card, frame, face, up_params)
    vgg_profiled(vgg_model, vgg_x, card)
    seq2seq_profiled(decode_step, decode_res["ms_per_step"], wmt_steps, card)
    for profile in (icf_profile, swt_profile, sift_profile, *slice_profiles,
                    resnet_profile, nn_rest_profile, fit_profile,
                    coco_profile):
        if (profile.__qualname__.split(".")[0] not in SLOW_PROFILES
                or "--slow-profiles" in sys.argv[1:]):
            profile()
    for entry, key in zip(kernels[1:4], ("fwd", "dq", "dkv")):
        # launches on the wmt step (dropout 0) over its timed steps, and
        # errors at this slice's shapes
        entry.update(launches_wmt=wmt_res[0.0]["launches"][key],
                     wmt_steps=WMT_STEPS,
                     max_abs_err_seq2seq=k2_slice_err[key])
    kernels[1].update(
        launches_decode=decode_res["launches"],
        decode_steps=decode_res["steps"], decode_shape=list(K2_DECODE),
        **{f"decode_{k}": v for k, v in k2_decode.items()})
    kernels[0].update(launches_upscaled=k1_up, launches_served=k1_served)
    # K2a from the graph model's ScaledDotProductAttention (phase 30)
    kernels[1].update(launches_layer=k2_layer)
    # K2a/b/c in Model.fit of the attention model (phase 31): launches a
    # step, and the kernels timed at its attention shape
    for entry, key in zip(kernels[1:4], ("fwd", "dq", "dkv")):
        r = fit_res["kernels"][key]
        entry.update(launches_fit=fit_res["launches"][key] // fit_res["steps"],
                     fit_steps=fit_res["steps"], fit_shape=fit_res["shape"],
                     fit_ms=r["ms"], fit_plain_ms=r["plain_ms"],
                     fit_bound_ms=r["bound_ms"], fit_bound_by=r["bound_by"],
                     fit_library_ms=r["library_ms"])
    # K2a/b/c in the world-1 NCCL wmt step under --data-parallel 1 (phase
    # 32 (a)): launches a step
    for entry, key in zip(kernels[1:4], ("fwd", "dq", "dkv")):
        entry.update(launches_wmt_data_parallel=par["launches_parallel"][key])
    # K2a/b/c at head dim 128 (phases 33-34): the launches of the D 128 LM
    # step, errors and times at K2_D128
    for key, (name, line, src, design) in sources.items():
        r = k2_d128[key]
        kernels.append({
            "name": f"{name}_d128", "route": "cuda",
            "source": f"ccv_tpu_torch/csrc/{src}",
            "replaces": f"ccv_tpu/ops/pallas/{line}",
            "launches": k2_d128_launches[key],
            "max_abs_err": k2_d128_err[key], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "design": design, "shape": list(K2_D128),
            "launches_seq2seq_step": k2_d128_s2s[key]})
    kernels += d32_kernel_entries(sources, k2_d32, fit_d32)
    kernels += d256_kernel_entries(k2, sources, k2_wide, lm_d256,
                                   decode_d256, fit_d256,
                                   fit_res["f32_launches"])
    # K1 on the trained SCD cascade's 1080p detect (phase 35), and in the
    # first form="auto" detect, its measurement included (phase 41)
    kernels[0].update(launches_trained=k1_trained, launches_auto=k1_auto)
    kernels.append({
        "name": "scd_phase_a", "route": "cuda",
        "source": "ccv_tpu_torch/csrc/scd_phase.cu",
        "replaces": "ccv_tpu/ops/pallas/scd_phase.py:44",
        "launches": k3_launches, "max_abs_err": k3_res["max_err"],
        "ms": k3_res["a"]["ms"], "plain_ms": k3_res["a"]["plain_ms"],
        "bound_ms": k3_res["a"]["bound_ms"],
        "bound_by": k3_res["a"]["bound_by"], "library_ms": None,
        "design": "planes-dense", "ms_b1": k3_res["b1"]["ms"],
        "plain_ms_b1": k3_res["b1"]["plain_ms"],
        "bound_ms_b1": k3_res["b1"]["bound_ms"],
        "bound_by_b1": k3_res["b1"]["bound_by"],
        "plane_copy_ms": k3_res["plane_copy_ms"],
        "launches_upscaled": k3_up, "launches_auto": k3_auto})
    print("seconds by phase (from each log line to the next): "
          + json.dumps({str(k): round(v, 1) for k, v in PHASE_S.items()}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        close_cpu_pool()
