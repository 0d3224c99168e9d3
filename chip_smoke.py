"""Smoke test of the PyTorch port (axcnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
drives the port's serving and training paths through their normal entry
points and checks them:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles axcnn_torch/csrc/*.cu with nvcc (sm_90a), one nvcc per
   source, in parallel;
3. kernel_check: each hand-written kernel against its plain PyTorch version
   on the card, bit for bit: the BlurPool forward and backward at the
   paths' shapes and batch 128, the TMA route's tile edges and odd extents, C at the
   smallest TMA-legal width and at widths only the per-thread route takes,
   and a tensor at a misaligned storage offset, fp32 and bf16, each
   asserting the route it took; the BlurPool autograd Function against
   autograd through the plain forward; the DropBlock mask at 14x14 and
   7x7 (bs 7) and 15x17 (bs 5) for three drop rates; and the DropBlock
   apply, forward and backward, fp32 and bf16, with inf, -inf and NaN at a
   dropped and a kept pixel, bit for bit (NaNs included), at the R50 sites
   at batch 128, at C = 8, 6 and 4 (the per-element route where C * itemsize
   is not a multiple of 16 bytes) and at a misaligned storage offset, and
   its autograd Function against autograd through the plain apply; the
   fused DropBlock kernel (mask and forward apply in one cooperative launch)
   against the plain mask then the plain apply, bit for bit (NaNs included),
   at the R50 sites at batch 128, at N = 1, at N = 1,500 (past the
   cooperative grid), at C = 6 and at a misaligned offset, fp32 and bf16,
   its mask and counts against the mask kernel's, and its autograd Function
   against autograd through the plain versions;
4. big_sites: the DropBlock op (mask, apply and its gradient) at sites past
   the fused kernel's line and the kernels' old limits: 2x160x160x64 bf16
   (H*W = 25,600) and 400x245x245x4 fp32 (N*H*W and the kept count past
   2^24), bit for bit; the path on which the standalone mask kernel and the
   forward apply launch (2 + 2 + 2 launches);
5. kernel_time: each kernel, its plain version and (BlurPool) the cuDNN call
   for the same function, and (BlurPool, the apply) a device copy of the
   same bytes, at batch 128, bf16 (BlurPool at the R50 step's three shapes
   and the two a Big-Little step adds), beside its bound (bytes over the card's
   memory rate or operations over its fp32 rate), the BlurPool kernels and
   the apply on inputs rotated through 256 MB so they read device memory;
   the fused kernel beside the mask kernel then the apply (the two
   launches it replaces) and the apply alone, in the same run; each of
   these kernels' output on the timed input is held bit for bit against its
   plain version's;
6. serve: ``axcnn_torch.cli.predict.main`` with --config=assemble_resnet50
   (full width, 1001 classes, 224x224, bf16) on 1, 8 and 32 generated JPEGs;
   every request must print a well-formed top-5 line per image and launch
   the forward kernel exactly 3 times (the stride-2 block of stages 2-4);
7. parity: a seeded full-width assembled R50 with perturbed BN, on the card
   through the kernel against the CPU through the plain version;
8. throughput: served images/s at batch 128 in bf16;
9. train: ``axcnn_torch.cli.main_classification.main`` with the assembled
   preset at full width, batch 128, bf16, on synthetic data; every logged
   loss finite, the kernels launched 3 + 3 + 9 + 9 times per step
   (BlurPool forward and backward, the fused DropBlock kernel, the apply
   backward; no standalone mask or forward apply; plus the end-of-run eval's
   forwards), all BlurPool launches on the TMA route, no DropBlock tensor
   copied into channels_last; step time, images/s, peak memory, and the
   calls whose tensor was not channels_last (BlurPool backward, DropBlock);
10. train_parity: one full-width train step in fp32 (TF32 off), batch 4,
   with DropBlock and mixup active, on the card through the kernels against
   the CPU through the plain versions, from the same state and seeds;
11. checkpoint: a full-width assembled R50 state after 3 b128 bf16 steps is
    saved and restored into a fresh state; every tensor must come back bit
    for bit with the fresh state's strides; the save's blocking seconds (the
    snapshot), the writer's seconds after it, restore seconds, MB;
12. resume: the training CLI at full width, b128, bf16, 5 steps with a
    checkpoint at step 5, the hang watchdog armed and steps 1-2 profiled,
    then the same command to 10 steps: it must log ``restore`` at step 5,
    only finite losses, 3 + 3 + 9 + 9 launches per step, and a trace;
13. serve_ckpt: ``predict`` on what the resumed run saved; its top-5 lines
    must equal those of the restored state's own EMA ``eval_logits``;
14. kd: the training CLI with ``--config=assemble_resnet152_kd`` at full
    width, the resumed R50 run as the teacher, global batch 1024 as 8
    micro-batches of 128, bf16, 3 steps; finite losses, the launches per
    step (per micro-batch: the student's 3 forward and 3 backward BlurPool
    launches, the teacher's 3 forward launches, 39 fused DropBlock launches
    and 39 apply backwards), step time, images/s and peak memory;
15. dp: two ranks on card 0, joined over Gloo (NCCL takes one rank per
    card: the test's topology, not a route of the program), each with 8
    images of a b16 batch. One fp32 step (TF32 off, DropBlock at keep-prob
    1.0, mixup off) of the two ranks against one single-process b16 step
    from the same state, each held to the float64 CPU step as
    ``train_parity`` holds the card; then one step with DropBlock and mixup
    active: finite losses, the ranks' parameters equal element for
    element, the kernels' launches on each rank;
16. remat: one b128 bf16 step with ``model.remat=blocks`` beside one
    without, from the same state and batch: the BN moving statistics alike
    (printed), BlurPool's forward launched 6 times (3 by the replay), the
    DropBlock kernels 9 times each way (fused, apply backward); then the
    training CLI with ``--model.remat=blocks`` at full width, b128, bf16, 5
    steps: finite losses, the launches per step, peak memory beside the run
    without;
17. bl_train: ``--config=bl_resnet50`` (Big-Little R50) through the training
    CLI at full width, 224x224, 1001 classes, b128, bf16, synthetic data, 20
    steps, ``--data.echo_factor=2`` and a save every 5 steps (deferred to the
    echo groups' ends: steps 6, 10, 16, 20): finite losses, 10 fresh batches,
    each save's blocking time below its writer thread's time, each
    checkpoint restored bit for bit equal to the state at its step; step
    walls, peak memory;
18. bl_serve: ``predict`` on that checkpoint: its top-5 lines must equal the
    restored EMA model's; that model's served img/s at b128 and latency at
    b1, bf16;
19. bl_parity: BL logits, card against CPU, from one seeded model with
    perturbed BN, fp32 (TF32 off) <= 1e-3 and bf16 <= 5e-2 relative L2;
20. bl_assembled: one b128 bf16 train step of BL with ResNet-D, SE, SK as
    one 5x5 conv, BlurPool sconv and DropBlock: the BlurPool kernels 5 + 5
    times and the fused DropBlock kernel and the apply backward 4 + 4
    times, at the expected shapes (two of BlurPool's are BL's own);
21. blur_sizes: BlurPool filter sizes 1-7 at stride 2 (and 3 at stride 1)
    on fp32 and bf16 maps of odd and even extents: the general route
    (cuDNN's depthwise conv) against its plain version on the card, and
    (3, 2) still on the kernel;
22. aa_parity: each device AutoAugment op on the card against the same op
    on the CPU for the same inputs, magnitudes and signs, on integer and
    fractional images at 224x224: the integer ops, Equalize and AutoContrast
    bit for bit, the warps and enhances within 1e-4 (of 255); the
    applicator on a b128 batch with the same draws within 1e-4;
23. aa_time: the augmentation alone (v0, 8 groups) on a b128 224x224 batch:
    device ms per call (events) and the host's enqueue ms per call;
24. aa_train: the training CLI on TFRecords of 256 JPEGs at 256x256 (the
    port's writer), full width, b128, bf16, 12 steps, AutoAugment v0 on the
    card (``--data.autoaugment_device=true``), then the same run with host
    AutoAugment: step walls, the loop's wait for each batch, peak memory,
    and the device-AA run's launches, 3 + 3 + 9 + 9 per step;
25. int8_check: every conv of an int8 R50 forward at b128 (the seeded
    model): the ``torch._int_mm`` route's int32 accumulators against the
    plain version's (float64 ``F.conv2d``) on the card, bit for bit, at each
    distinct shape (stride 2, dilation 2 and the stem's k = 27 among them);
26. int8_serve: served img/s at b128 and b1 under int8 beside bf16; the
    int8 logits' relative L2 to the fp32 logits (< 0.05) and their top-1
    agreement; an int8 forward launches the BlurPool forward 3 times and
    ``_int_mm`` 71 times;
27. export: the ``train`` run's EMA exported on the card (``torch.export``)
    in bf16 (b128 and b1) and int8 (b128), each reloaded with
    ``load_serving``: logits bit for bit the direct forward's, the BlurPool
    forward kernel launched 3 times (TMA route) by a reloaded forward,
    served img/s, export and load seconds; ``predict --export`` prints the
    same lines as ``predict`` from the checkpoint on 128 JPEGs;
28. mce: 8 clean 256x256 JPEGs labelled with the ``train`` run's own
    predictions, ``build_imagenet_c`` for all 15 corruptions at severities
    1-2, ``main_classification --runtime.eval_imagenet_c`` on the card in
    fp32 from that run's checkpoint: the mce line equals ``compute_mce`` of
    the per-set lines, and each set's top-1 equals the port's CPU run;
29. tf_import: a full-width ``assemble_resnet50`` TF1 checkpoint (1001
    classes; every variable under its TF-official name, EMA shadows,
    Momentum slots, ``global_step``) written as TF's V2 bundle in two data
    shards (``_write_tf_bundle``), imported on the host without TensorFlow
    with and without ``use_ema``: every tensor bit for bit what was written;
    seconds and MB/s of each import; the EMA import in a channels_last
    model on the card gives b128 bf16 logits bit for bit those of a model
    that took the same tensors through ``load_weights``, with 3 BlurPool
    launches a forward; saved as a port checkpoint, ``predict`` serves it
    (``tf_import_serve``: its top-5 lines equal the restored EMA's);
30. fgvc_finetune: a Food-101-layout tree (101 classes, 3 train and 1 test
    JPEG a class, up to 512 px on the long side) built into ``train`` and
    ``validation`` shards by ``python -m axcnn_torch.data.build_tfrecords
    --layout=food101`` and read back (counts, labels), then
    ``main_classification --config=finetune_fgvc`` at full width, b256,
    bf16, 12 steps and its eval, warm-started from the imported checkpoint:
    before the first update every non-head tensor equals the imported EMA
    and the 101-way head its fresh init; finite losses; 3 + 3 + 9 + 9
    launches a step; step walls, img/s, peak memory;
31. dp_nccl: the training CLI with ``--runtime.num_devices=2`` (one rank a
    card, NCCL), global b256, bf16, 10 steps: finite losses, img/s per card
    and in total. On a machine with one card it prints ``"ran": false``;
32. spatial_kernel_check (with kernel_check): the kernels' spatial forms,
    bit for bit against their plain versions, fp32 and bf16: BlurPool with
    top padding 0 (a shard with its halo row on top) forward and backward
    at the 448x448 shards' shapes, on both routes, the forward's rows also
    against the unsharded kernel's; the mask over a window of rows (row0 >
    0, windows that cut a block, bs 7 and 5) against the plain window and
    the whole-map kernel's rows; the apply with the global batch's counts
    and element count, forward and backward, NaNs included; the fused
    window kernel (a window's rows of the global batch's mask, its counts
    drawn over the whole map by every rank, the apply, in one launch) at
    those windows, one and two data shards at both offsets, fp32 and bf16,
    16-byte and per-element units: its output (bit patterns), mask and
    counts against its plain version and against today's route past the
    fused line (the windowed mask of each window of the map, the counts
    summed, the apply);
    kernel_time also times those kernels at the 448x448 S = 2 shards'
    shapes, b128 bf16, beside the same yardsticks, and the fused window
    kernel there beside the windowed mask and apply it replaces (outside
    the summary's sums of the older kernels, which stay one R50 step's;
    the fused window kernel's are those two sites');
33. spatial_parity (needs two cards): a seeded full-width assembled R50,
    fp32 with TF32 off, b4 at 128x128, one train step with DropBlock and
    mixup active on ``(D, S) = (1, 2)`` over NCCL, beside the one-card step
    and the CPU's float64 step from the same state, batch and draws: the
    spatial step as near the float64 step as the one-card step is (loss,
    every parameter, every BN statistic), the eval's counts equal; the
    spatial kernels' launches; a rank's all-reduce and all-gather calls in
    the step, and in the same step with the fused line moved to 0 (the
    route every site took before the fused window kernel): 9 all-reduces
    fewer, one a DropBlock site; that step's launches (the windowed mask
    and the forward apply 9 each, no fused window kernel), and its
    DropBlock sites' outputs and loss, bit for bit the fused step's (not
    its end state: cuDNN's wgrad need not be deterministic run to run);
34. spatial_448: ``--config=finetune_fgvc`` at 448x448 on synthetic data,
    bf16: on one card at b128 (peak memory, step wall), then (two cards)
    the CLI's ranks with ``--runtime.spatial_partitions=2`` at b128 and b256:
    finite losses, each card's peak memory, step walls, img/s, and the
    launches of each kernel by path (BlurPool with top padding 0 3 + 3 a
    step, the fused window kernel and the apply backward 9 each, no
    windowed mask, forward apply or fused kernel). On a machine with one
    card the two-card parts print
    ``"ran": false``;
35. drive_convergence: ``axcnn_torch.drives.convergence`` at the reference's
    full budget: config 4 (``bn_momentum`` 0.9, ``ema_decay`` 0.99) at full
    width, b64, 224x224, bf16, 300 steps on 4 x 64 generated JPEGs through
    the native loader with AutoAugment v0, then the raw and EMA evals; the
    drive asserts the reference's bars (raw top-1 >= 90, EMA >= raw - 1);
    the kernels 3 + 3 + 9 + 9 times a step and 3 BlurPool forwards an eval
    batch, on the TMA route; the training wall and median step;
36. drives_cut: ``convergence_full``, ``ablation`` and ``kd`` through their
    entry points at full width, b64, 224x224, bf16, cut to ``CUT`` (steps,
    images a class, 3 corruptions at one severity), the bars not asserted
    (``"bars_asserted": false``): every leg runs, every logged loss is
    finite, each summary has the reference's keys, the ablation restores
    the pretrain, and the kernels launch as each leg's steps and evals say
    (R152 students 3 + 3 + 39 + 39 a step, the KD student's teacher 3 more
    forwards a step); the KD drive's CLI legs run in processes of their own,
    which report their counts and whether they loaded a teacher (only the
    KD student does);
37. spatial_options_parity: two ranks on card 0 joined over Gloo (so it runs
    on one card; the topology of the check, not a route of the program),
    ``(D, S) = (1, 2)``, the seeded full-width assembled R50, fp32 with TF32
    off, b4 at 128x128, step 5 of 10 with DropBlock and mixup active: one
    leg for each option of the step under spatial partitioning (gradient
    accumulation with A = 2, ``remat="blocks"``, device AutoAugment with
    injected draws, a KD teacher (an R50), Big-Little stages), each held,
    as ``spatial_parity`` is, to the CPU's float64 step with the same
    option beside the one-card step (loss within 1e-4; the per-leaf
    distance at most 3x the one-card step's); the int8 eval's counts equal
    to the one-card int8 eval's and every conv's int32 accumulators before
    the first pooled sum the one-card ones' rows, bit for bit; each leg's
    kernel launches on each rank; each rank's all-reduce and all-gather
    calls in the plain and the accumulating leg, and in the same legs with
    the fused line moved to 0: one all-reduce a DropBlock site fewer (9 a
    step, 18 at A = 2), and those legs' launches (the windowed mask and the
    forward apply once a site, no fused window kernel), DropBlock site
    outputs and losses, bit for bit the fused legs';
38. spatial_448_options: ``--config=finetune_fgvc`` at 448x448, bf16,
    through the CLI with ``--runtime.spatial_partitions=2
    --model.remat=blocks --train.grad_accum_steps=2
    --data.autoaugment_device=true`` on TFRecords of 256 generated 512x512
    JPEGs (device AutoAugment is off on synthetic data), 3 steps at b128 and
    at b256, as two Gloo ranks on card 0 and, where there are two cards,
    over NCCL a card a rank: finite losses, each rank's peak memory, rank
    0's record-gap step walls, the augmentation alone (events and enqueue
    ms, as ``aa_time``; every rank of a row runs it), and the launches (a step: BlurPool 12 + 6,
    the fused window kernel and the apply backward 18 each);
39. drives_cut_more (after drives_cut, on its root): ``convergence_scale``
    (20 steps, echo 2, on drives_cut's 50-class set), ``finetune`` (three
    ``run()`` calls of 5 steps, 22 images a class), ``convergence_1k`` (the
    1001-way head with label offset 1 through the training CLI, 1 train and
    1 held-out image a class, 10 steps, echo 4), ``bl`` (``bl_resnet50``
    through the CLI, 10 steps, then its step, its ablation's and the
    assembled R50's, 5 warm-up and 5 timed steps each) and ``int8_serving`` (drives_cut's
    ``convergence_full`` pretrain, 2 + 5 served forwards a batch) through
    their entry points at full width, b64, 224x224, bf16, cut to
    ``CUT_MORE``, the bars not asserted: every training set fills a batch,
    every leg runs, every logged loss is finite, each summary has the
    reference's keys, the 1k leg evaluates its 1,000 held-out images and
    its stored labels pass the loader's check under the 1001-way head, and
    the kernels launch as each leg's steps and evals say
    (``_cut_more_launches``; the CLI legs through ``_COUNTING_CLI``,
    ``bl_resnet50`` none);
40. acceptance_cut (after drives_cut, on its 50-class set):
    ``axcnn_torch.drives.acceptance`` through its entry point, the bars not
    asserted: config 4's recipe (``train_assemble_from_scratch``, with an
    export), ``predict --export`` on the card, config 3's ``eval`` recipe at
    b256, config 2's setup and b128 ``eval_only``, config 1's setup and
    ``predict --cpu`` in fp32, at full width, 224x224, b64, bf16,
    ``ACCEPT_CUT['steps']`` steps each; config 5 (R152 + KD, config 4 as
    the teacher) on ``ACCEPT_CUT['kd_ranks']`` (4) Gloo CPU ranks at 64x64,
    b16, 3 steps (the full drive's 8), more ranks than the set's 2
    validation files, so the eval deals records out to ranks. Every leg exits
    0, the export serves five well-formed top-5 entries, configs 3 and 2
    count the 100 held-out images, config 1's five posteriors are
    well-formed, config 5's losses are finite with its eval present; config
    3's top-1 difference from config 4 is reported; each leg runs through
    ``_COUNTING_MAIN`` and launches the kernels as ``_accept_launches``
    says;
41. kd_diag_cut (after drives_cut, on its KD root): ``kd_probe`` on the KD
    drive's teacher (b32: 2 clean, 2 augmented and 1 mixed batch, each
    statistic finite), then ``kd_sweep`` at ``ACCEPT_CUT['sweep_steps']``
    student steps a leg (three R152 legs through the CLI, full width,
    224x224, b64): every logged loss finite, each leg's hyperparameters, and
    the launches (the probe's 5 teacher forwards; a leg's 3 + 3 + 3 BlurPool
    and 39 + 39 DropBlock launches a step, 3 an eval batch).
42. measurement_scripts: the six measurement modules (``axcnn_torch.cli``'s
    ports of the reference's ``scripts/``) through their ``main()`` at
    their smallest settings (``MEASURE_ARGV``): ``latency_bench`` (the
    assembled R50 served at b1 and b8, bf16, 10 timed forwards each way),
    ``remat_bench`` (R50 b16, ``none`` and ``blocks``, 3 timed steps),
    ``capacity_probe`` (config 5's R152 + R50 KD step at b8, ``blocks``),
    ``loader_bench`` (512 generated JPEGs, 2 measured batches a real row,
    the card feed included) and ``echo_bench`` (R50 b128 on those JPEGs,
    host AA, factor 2 for 4 steps: 2 host batches), ``opt_experiments``
    (the batch sweep at b16); each row's keys and finite values, and each
    module's launches (``_measure_launches``);
43. roofline (with the timed phases): ``calibrate_roofline`` at its
    defaults (the card's STREAM and bf16 GEMM walls, each at most 1.05x
    the data sheet's), then ``profile_roofline`` for the R50 b128 bf16
    train step and serving forward (``ROOFLINE_ARGV``): the step's
    ``mfu``, fraction of the speed of light and HBM share finite and in
    (0, 1.05], unattributed device time at most 1% of busy time, the
    table's FLOPs equal to ``FlopCounterMode``'s, each hand-written
    kernel's bytes in the step equal to the bytes ``kernel_time`` bounds
    for the same shapes, the two traced windows' busy time within 10% of
    each other, and the launches those of plain steps (a step 3 + 3 + 9 +
    9, a forward 3), in the table and on the wrappers' counts.

Every phase prints one JSON line, stamped with the script's elapsed
seconds; any failure raises and exits non-zero. The last two lines are the
kernels' summary and the result line.

Order: the kernel phases (1-5) run alone, so the timings see an idle card;
then ``spatial_448`` (its one-card 448x448 step peaks at 54 GiB); then,
alone too, the phases that time the program (train, checkpoint, kd, remat,
bl_train, bl_serve, aa_time, aa_train, int8_serve, tf_import,
fgvc_finetune, roofline, dp_nccl, and resume and serve_ckpt, whose run kd
reads).
Then the drive phases 36 and 39-41 (``drives_group``: drives_cut, then
acceptance_cut in a process of its own beside drives_cut_more and
kd_diag_cut) run in a process of their own beside the phases that check
results in this one (train_parity, dp, bl_parity, bl_assembled,
blur_sizes, aa_parity, int8_check, export, mce, drive_convergence,
spatial_parity, spatial_options_parity, spatial_448_options,
measurement_scripts; the walls
and img/s that export, drive_convergence and spatial_448_options print are
read under that load). They share no files and count their launches in
their own processes; their host work (CLI processes starting, CPU ranks)
and their card work overlap, and the card's memory holds them all (each
of those phases peaks at 30 GiB or less, a drive leg at less). A group's
lines are printed when it ends, with the launches it counted.
"""

import contextlib
import dataclasses
import functools
import glob
import importlib
import io
import itertools
import json
import os
import signal
import struct
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from axcnn_torch.kernels import blurpool as kblur
from axcnn_torch.kernels import dropblock as kdrop

TIME_BATCH = 128
# the BlurPool inputs of an R50 step at the main path's batch
SLICE_SHAPES = [(TIME_BATCH, 56, 56, 128), (TIME_BATCH, 28, 28, 256),
                (TIME_BATCH, 14, 14, 512)]
# the two BlurPool inputs a Big-Little R50 step adds (the big branches'
# first blocks of stages 2-3): checked and timed beside the R50 shapes
BL_SHAPES = [(TIME_BATCH, 28, 28, 128), (TIME_BATCH, 14, 14, 256)]
# tile edges of the TMA route: a last row band shorter than the rest and odd
# extents on one sample (57x58), column bands (W 199), a channel block half
# outside C (96); C at the smallest TMA-legal widths (8; 4 for fp32 only);
# C only the per-thread route takes (6; 4 in bf16)
EDGE_SHAPES = [(1, 57, 58, 128), (2, 9, 199, 64), (3, 15, 17, 96), (3, 15, 17, 8),
               (2, 13, 11, 4), (2, 7, 9, 6)]
CHECK_SHAPES = SLICE_SHAPES + BL_SHAPES + [(8, 112, 112, 64)] + EDGE_SHAPES
# BlurPool backward: the forward INPUT extents (gradients are half-size)
BWD_CHECK_SHAPES = SLICE_SHAPES + BL_SHAPES + [(2, 8, 9, 8)] + EDGE_SHAPES
# a channels_last tensor at a storage offset that is not 16-byte aligned
MISALIGNED_SHAPE = (2, 15, 17, 64)
# DropBlock sites of the assembled R50 at 224x224: (H, W, block size)
MASK_SHAPES = [(14, 14, 7), (7, 7, 7), (15, 17, 5)]
MASK_TIME_SHAPES = MASK_SHAPES[:2]
# DropBlock apply, NHWC: the R50 sites at batch 128, then C = 8, 6 and 4
APPLY_TIME_SHAPES = [(TIME_BATCH, 14, 14, 1024), (TIME_BATCH, 7, 7, 2048)]
APPLY_CHECK_SHAPES = APPLY_TIME_SHAPES + [(4, 15, 17, 8), (4, 15, 17, 6), (4, 15, 17, 4)]
APPLY_MISALIGNED_SHAPE = (2, 14, 14, 64)
APPLY_GAMMA = 0.1
# the fused kernel, NHWC: the R50 sites at batch 128; N = 1; N past the
# cooperative grid (7x7x8: one CTA's units cover many samples); C = 6, the
# per-element route
FUSED_CHECK_SHAPES = APPLY_TIME_SHAPES + [(1, 14, 14, 1024), (1500, 7, 7, 8), (4, 15, 17, 6)]
# the DropBlock op past the kernels' old limits (H*W <= 16,384, N*H*W <= 2^24):
# (NHWC, dtype, block size)
BIG_SITES = [((2, 160, 160, 64), torch.bfloat16, 7), ((400, 245, 245, 4), torch.float32, 7)]
GAMMAS = (0.0, 0.02, 0.1)
TRAIN_STEPS = 20
REMAT_STEPS = 5
DP_RANKS, DP_LOCAL_BATCH = 2, 8
DP_NCCL_BATCH, DP_NCCL_STEPS = 256, 10
RESUME_STEPS = (5, 10)  # the first run's steps, then the resumed run's end
KD_BATCH, KD_ACCUM, KD_STEPS = 1024, 8, 3
BL_ECHO, BL_SAVE_EVERY = 2, 5
# the general BlurPool route's check maps: odd and even extents, C that is
# and is not a multiple of 8
BLUR_SIZE_SHAPES = [(4, 28, 28, 64), (3, 15, 17, 24), (2, 9, 8, 6)]
AA_STEPS, AA_IMAGES = 12, 256  # device-AA training: steps, 256^2 JPEGs in the train set
INT8_CONVS = 71  # convs of an assembled R50 forward: stem 3, 16 blocks x 4, 4 projections
MCE_IMAGES, MCE_SEVERITIES = 8, (1, 2)
TF_GLOBAL_STEP = 400_000  # the step a published model.ckpt-* carries
TF_SHARDS = 2
FGVC_CLASSES, FGVC_TRAIN, FGVC_TEST = 101, 3, 1  # Food-101's classes; images a class
FGVC_STEPS, FGVC_BATCH = 12, 256  # finetune_fgvc's batch
FGVC_LONG_SIDE = 512  # the published Food-101 images' longest side
# spatial partitioning: the BlurPool inputs of a 448x448 R50 step's shard at
# S = 2, with the halo row on top (56 + 1 rows of 112, ...), and a shape the
# per-thread route takes
SPATIAL_BLUR_SHAPES = [(TIME_BATCH, 57, 112, 128), (TIME_BATCH, 29, 56, 256),
                       (TIME_BATCH, 15, 28, 512)]
SPATIAL_BLUR_CHECKS = [(8,) + s[1:] for s in SPATIAL_BLUR_SHAPES] + [(3, 15, 17, 6)]
# (H, W, bs, row0, rows): windows of a map; each cuts a block (the 448x448
# sites' S = 2 shards first)
SPATIAL_MASK_WINDOWS = [(28, 28, 7, 14, 14), (14, 14, 7, 7, 7), (28, 28, 5, 9, 7),
                        (15, 17, 5, 4, 6)]
# the 448x448 DropBlock sites' S = 2 shards: (N, rows, W, C), the map's H
SPATIAL_APPLY_SHAPES = [((TIME_BATCH, 14, 28, 1024), 28), ((TIME_BATCH, 7, 14, 2048), 14)]
SPATIAL_SIZE, SPATIAL_STEPS, SPATIAL_BATCHES = 448, 5, (128, 256)
SPATIAL_PARITY_SIZE, SPATIAL_PARITY_BATCH = 128, 4
L2_FLUSH_BYTES = 256 << 20  # timing inputs cycle through at least this much (H100 L2: 50 MB)
# drives_cut: the three long drives through their entry points, cut to
# these sizes, bars not asserted (drive_convergence runs at its full budget)
CUT = dict(pretrain_steps=40, ft_steps=10, n_train=32, n_eval=8, ft_n_train=16, ft_n_eval=8,
           corruptions=("gaussian_noise", "fog", "contrast"), severities=(2,),
           teacher_steps=40, student_steps=10, n_subset=12, scale_n_train=12, scale_n_eval=2)
# drives_cut_more: the five later drives through their entry points on
# drives_cut's root (its 50-class set and convergence_full's pretrain), cut
# to these sizes, bars not asserted; every training set holds a batch
CUT_MORE = dict(scale_steps=20, ft_steps=5, ft_n_per_class=22, k1_steps=10,
                k1_n_train=1, k1_n_eval=1, bl_steps=10, bl_probe_steps=5, int8_iters=(2, 5))
DRIVE_BATCH = 64  # every drive's batch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory bandwidth (datasheet)
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 peak outside the tensor cores (datasheet)
SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's clock: longer than enqueueing 50 calls
SEED = 0


# the script's start on the host's clock; a process of the script's own
# (``drives_group``) takes it from the environment
_T0 = float(os.environ.get("CHIP_SMOKE_T0", time.time()))


def emit(phase, **fields):
    """One JSON line for ``phase``; ``elapsed_s`` is the script's wall time
    when the phase ended, so the lines show where the time goes."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.time() - _T0, 3)}), flush=True)


def device_phase():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi.splitlines()[0]


def build_phase():
    from axcnn_torch.kernels.build import load_library

    t0 = time.perf_counter()
    lib = load_library()
    emit("build", seconds=time.perf_counter() - t0, library=os.path.relpath(lib._name))


def _nchw_input(shape, dtype, gen, offset=0):
    """An NCHW view of NHWC memory (channels_last), ``offset`` elements into
    its storage."""
    n, h, w, c = shape
    flat = torch.randn(offset + n * h * w * c, generator=gen, device="cuda").to(dtype)
    return flat[offset:].view(n, h, w, c).permute(0, 3, 1, 2)


def _tma_legal(c, dtype):
    """The C entry points' rule for an aligned channels_last tensor: TMA
    when C * itemsize is a multiple of 16 bytes (blurpool.cu tma_route)."""
    return c * torch.tensor([], dtype=dtype).element_size() % 16 == 0


def _route_of(kind, before):
    """The route of the one launch of ``kind`` since ``before``."""
    new = {k: v - before[k] for k, v in kblur.ROUTES.items() if k.startswith(kind)}
    assert sum(new.values()) == 1, new
    return next(k for k, v in new.items() if v)[len(kind) + 1:]


def _bf16_ulp(v):
    """Spacing of bf16 numbers at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _time_ms(fn, xs, iters=50):
    """Mean device ms per call, cycling through the inputs ``xs``. A sleep
    kernel queued first holds the card while the host enqueues every call,
    so the calls run back to back and the events time the device, not the
    host's launch overhead."""
    for x in xs[:3]:
        fn(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(xs[i % len(xs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bits(t):
    """The bit patterns of ``t``: equal bits hold NaNs and signed zeros too."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _check_equal(kernel, shape, case, got, want, bits=False):
    """Emit one kernel_check line; raise unless ``got`` equals ``want`` (with
    ``bits``, bit for bit, NaNs included; the error is over the elements
    that are finite in both). ``case`` names the dtype or the drop rate."""
    assert got.shape == want.shape and got.dtype == want.dtype
    finite = torch.isfinite(got) & torch.isfinite(want)
    diff = torch.where(finite, got.float() - want.float(), 0.0).abs()
    err = diff.max().item() if diff.numel() else 0.0
    same = _bits(got) == _bits(want) if bits else got == want
    ok = bool(same.all())
    emit("kernel_check", kernel=kernel, shape=list(shape), case=str(case),
         max_abs_err=err, n_differ=int((~same).sum()), numel=got.numel(),
         tolerance="bit-exact, NaNs included" if bits else "bit-exact", ok=ok)
    if not ok:
        raise AssertionError(f"{kernel} disagrees with its plain version at {shape} {case}")
    return err


def _expected_drop_fraction(h, w, bs, gamma):
    """E[dropped share]: pixel p is dropped with probability 1-(1-gamma)^k(p),
    k(p) the number of valid centres whose block covers p."""
    half0, half1 = (bs - 1) // 2, bs // 2
    valid = np.zeros((h, w))
    valid[half0:h - half1, half0:w - half1] = 1
    k = np.array([[valid[max(r - half0, 0):r + half1 + 1,
                         max(c - half0, 0):c + half1 + 1].sum()
                   for c in range(w)] for r in range(h)])
    return float((1 - (1 - gamma) ** k).mean())


def _seeds(n, gen):
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)


def _with_specials(x, mask):
    """``x`` with inf, -inf and NaN at a dropped and at a kept pixel of
    ``mask`` (as many channels as it has)."""
    for keep in (0.0, 1.0):
        hit = (mask == keep).nonzero()
        if len(hit):
            s, r, col = hit[0].tolist()
            x[s, :3, r, col] = torch.tensor([float("inf"), -float("inf"), float("nan")],
                                            device=x.device)[:x.shape[1]].to(x.dtype)
    return x


def _apply_inputs(shape, dtype, gen, offset=0, specials=True):
    """A channels_last NCHW input (NHWC ``shape``), with inf, -inf and NaN at
    a dropped and at a kept pixel unless ``specials`` is false, its seeds,
    and the mask kernel's mask (drop rate APPLY_GAMMA, block size up to 7)
    and counts for them."""
    n, h, w, _ = shape
    x = _nchw_input(shape, dtype, gen, offset)
    seeds = _seeds(n, gen)
    mask, counts = kdrop.dropblock_mask_cuda(seeds, APPLY_GAMMA, h, w, min(7, h, w))
    if specials:
        x = _with_specials(x, mask)
    return x, seeds, mask, counts


def _apply_fns(mask, counts, backward, numel=None):
    """The apply kernel and its plain version, as functions of the input;
    ``numel`` with the global batch's counts."""
    def kernel(t):
        return kdrop.dropblock_apply_cuda(t, mask, counts, backward=backward, numel=numel)

    def plain(t):
        ref = kdrop.dropblock_apply_bwd_reference if backward else kdrop.dropblock_apply_reference
        return ref(t, mask, counts, numel)

    return kernel, plain


def kernel_check_phase():
    """Each kernel against its plain version; returns max abs error by kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"fwd": 0.0, "bwd": 0.0, "mask": 0.0, "apply": 0.0, "fused": 0.0, "fused_window": 0.0}
    routes = set()

    def check_route(kind, before, shape, dtype, want):
        route = _route_of(kind, before)
        emit("kernel_route", kernel=kind, shape=list(shape), case=str(dtype), route=route,
             expected=want, ok=route == want)
        if route != want:
            raise AssertionError(f"{kind} took the {route} route at {shape} {dtype}")
        routes.add((kind, route))

    cases = [(s, 0) for s in CHECK_SHAPES] + [(MISALIGNED_SHAPE, 1)]
    for shape, offset in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = _nchw_input(shape, dtype, gen, offset)
            before = dict(kblur.ROUTES)
            got = kblur.blur_pool_cuda(x)
            torch.cuda.synchronize()
            assert got.is_contiguous(memory_format=torch.channels_last)
            case = f"{dtype}, offset {offset}" if offset else dtype
            errs["fwd"] = max(errs["fwd"], _check_equal(
                "blur_pool3_s2_fwd", shape, case, got, kblur.blur_pool_reference(x)))
            check_route("fwd", before, shape, case,
                        "tma" if _tma_legal(shape[3], dtype) and not offset else "thread")
    for shape, offset in [(s, 0) for s in BWD_CHECK_SHAPES] + [(MISALIGNED_SHAPE, 1)]:
        n, h, w, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            g = _nchw_input((n, (h + 1) // 2, (w + 1) // 2, c), dtype, gen, offset)
            before = dict(kblur.ROUTES)
            got = kblur.blur_pool_bwd_cuda(g, (h, w))
            torch.cuda.synchronize()
            want = kblur.blur_pool_bwd_reference(g, (h, w))
            case = f"{dtype}, offset {offset}" if offset else dtype
            errs["bwd"] = max(errs["bwd"], _check_equal(
                "blur_pool3_s2_bwd", shape, case, got, want))
            check_route("bwd", before, shape, case,
                        "tma" if _tma_legal(c, dtype) and not offset else "thread")
            if offset:
                continue
            # the autograd Function against autograd through the plain forward
            x = _nchw_input((n, h, w, c), dtype, gen).requires_grad_()
            kblur.BlurPool3S2.apply(x).backward(g)
            x2 = x.detach().clone().requires_grad_()
            kblur.blur_pool_reference(x2).backward(g)
            torch.cuda.synchronize()
            _check_equal("BlurPool3S2.backward", (n, h, w, c), dtype, x.grad, x2.grad)
    if routes != {(k, r) for k in ("fwd", "bwd") for r in ("tma", "thread")}:
        raise AssertionError(f"kernel_check did not exercise both routes: {routes}")
    for h, w, bs in MASK_SHAPES:
        for gamma in GAMMAS:
            seeds = _seeds(TIME_BATCH, gen)
            mask, counts = kdrop.dropblock_mask_cuda(seeds, gamma, h, w, bs)
            torch.cuda.synchronize()
            want_m, want_c = kdrop.dropblock_mask_reference(seeds, gamma, h, w, bs)
            shape = (TIME_BATCH, h, w, bs)
            errs["mask"] = max(errs["mask"], _check_equal(
                "dropblock_mask", shape, "gamma=%g" % gamma, mask, want_m),
                _check_equal("dropblock_mask.counts", shape, "gamma=%g" % gamma,
                             counts, want_c))
            emit("mask_stats", hw_bs=[h, w, bs], gamma=gamma, samples=TIME_BATCH,
                 drop_fraction=1 - mask.mean().item(),
                 expected=_expected_drop_fraction(h, w, bs, gamma))
    for shape, offset in [(s, 0) for s in APPLY_CHECK_SHAPES] + [(APPLY_MISALIGNED_SHAPE, 1)]:
        for dtype in (torch.float32, torch.bfloat16):
            x, _, mask, counts = _apply_inputs(shape, dtype, gen, offset)
            case = f"{dtype}, offset {offset}" if offset else dtype
            for backward in (False, True):
                kernel, plain = _apply_fns(mask, counts, backward)
                got = kernel(x)
                torch.cuda.synchronize()
                assert got.is_contiguous(memory_format=torch.channels_last)
                errs["apply"] = max(errs["apply"], _check_equal(
                    f"dropblock_apply_{'bwd' if backward else 'fwd'}", shape, case, got,
                    plain(x), bits=True))
            if shape != APPLY_TIME_SHAPES[0]:
                continue
            # the autograd Function against autograd through the plain apply
            g = _nchw_input(shape, dtype, gen)
            x1, x2 = x.detach().clone().requires_grad_(), x.detach().clone().requires_grad_()
            (got,) = torch.autograd.grad(kdrop.DropBlockApply.apply(x1, mask, counts), x1, g)
            (want,) = torch.autograd.grad(kdrop.dropblock_apply_reference(x2, mask, counts),
                                          x2, g)
            torch.cuda.synchronize()
            _check_equal("DropBlockApply.backward", shape, dtype, got, want, bits=True)
    for shape, offset in [(s, 0) for s in FUSED_CHECK_SHAPES] + [(APPLY_MISALIGNED_SHAPE, 1)]:
        n, h, w, c = shape
        bs = min(7, h, w)
        for dtype in (torch.float32, torch.bfloat16):
            x, seeds, mask, counts = _apply_inputs(shape, dtype, gen, offset)
            case = f"{dtype}, offset {offset}" if offset else dtype
            y, got_m, got_c = kdrop.dropblock_fused_cuda(x, seeds, APPLY_GAMMA, bs)
            torch.cuda.synchronize()
            assert y.is_contiguous(memory_format=torch.channels_last)
            want_y, want_m, want_c = kdrop.dropblock_fused_reference(x, seeds, APPLY_GAMMA, bs)
            errs["fused"] = max(errs["fused"], _check_equal(
                "dropblock_fused", shape, case, y, want_y, bits=True))
            # the mask and counts equal the mask kernel's and the plain mask's
            for name, got, kernel, plain in (("mask", got_m, mask, want_m),
                                             ("counts", got_c, counts, want_c)):
                _check_equal(f"dropblock_fused.{name}", shape, f"{case}, vs mask kernel", got,
                             kernel)
                _check_equal(f"dropblock_fused.{name}", shape, f"{case}, vs plain", got, plain)
            if shape != APPLY_TIME_SHAPES[0]:
                continue
            # the autograd Function against autograd through the plain versions
            g = _nchw_input(shape, dtype, gen)
            x1, x2 = x.detach().clone().requires_grad_(), x.detach().clone().requires_grad_()
            (got,) = torch.autograd.grad(
                kdrop.DropBlockFused.apply(x1, seeds, APPLY_GAMMA, bs), x1, g)
            (want,) = torch.autograd.grad(
                kdrop.dropblock_fused_reference(x2, seeds, APPLY_GAMMA, bs)[0], x2, g)
            torch.cuda.synchronize()
            _check_equal("DropBlockFused.backward", shape, dtype, got, want, bits=True)
    return errs


def big_sites_phase(errs):
    """The DropBlock op past the fused kernel's line (H*W > 16,384: the mask
    kernel, its tiled form, then the apply kernel each way) and past the
    kernels' old limits, at BIG_SITES: the path on which the standalone mask
    and forward apply launch. The counts are zeroed before the op's runs and
    read after them, before the comparisons' own launches. Each site bit for
    bit against the plain mask and autograd through the plain apply; errs
    takes the largest mask and apply errors. Returns the path's counts."""
    from axcnn_torch.ops.dropblock import dropblock, dropblock_gamma

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    kp, runs = 0.9, []
    _zero_counts()
    for shape, dtype, bs in BIG_SITES:
        n, h, w, c = shape
        assert not kdrop.fused_route(h, w), shape
        x = _nchw_input(shape, dtype, gen).detach().requires_grad_()
        g = _nchw_input(shape, dtype, gen)
        seeds = _seeds(n, gen)
        y = dropblock(x, seeds, keep_prob=kp, block_size=bs, train=True)
        (dx,) = torch.autograd.grad(y, x, g)
        runs.append((shape, dtype, bs, x, g, seeds, y, dx))
    torch.cuda.synchronize()
    counts = _counts()
    want = {"fwd": 0, "bwd": 0, "mask": len(BIG_SITES), "apply": len(BIG_SITES),
            "apply_bwd": len(BIG_SITES), "fused": 0, "fused_window": 0}
    for shape, dtype, bs, x, g, seeds, y, dx in runs:
        n, h, w, c = shape
        gamma = float(dropblock_gamma(kp, bs, h, w))
        mask, counts_k = kdrop.dropblock_mask_cuda(seeds, gamma, h, w, bs)
        want_m, want_c = kdrop.dropblock_mask_reference(seeds, gamma, h, w, bs)
        x2 = x.detach().clone().requires_grad_()
        y2 = kdrop.dropblock_apply_reference(x2, want_m, want_c)
        (dx2,) = torch.autograd.grad(y2, x2, g)
        torch.cuda.synchronize()
        case = f"{dtype}, bs {bs}, kept {int(want_c.sum().item())}"
        errs["mask"] = max(errs["mask"],
                           _check_equal("dropblock_mask", shape, case, mask, want_m),
                           _check_equal("dropblock_mask.counts", shape, case, counts_k, want_c))
        errs["apply"] = max(errs["apply"],
                            _check_equal("dropblock_op_fwd", shape, case, y, y2, bits=True),
                            _check_equal("dropblock_op_bwd", shape, case, dx, dx2, bits=True))
        del x2, y2, dx2
    emit("big_sites", sites=[list(s) for s, *_ in BIG_SITES], launches=counts, expected=want,
         ok=counts == want)
    if counts != want:
        raise AssertionError(f"big sites launched {counts}, expected {want}")
    return counts


def _time_set(fns, xs, inputs=None):
    """Each of ``fns`` (name -> callable) timed twice on the inputs ``xs``
    (or ``inputs[name]``), in the order a, b, ..., ..., b, a, so the two
    orders bracket any drift; name -> (mean ms, [both runs])."""
    names = list(fns)
    runs = {k: [] for k in names}
    for k in names + names[::-1]:
        runs[k].append(_time_ms(fns[k], (inputs or {}).get(k, xs)))
    return {k: (sum(v) / len(v), v) for k, v in runs.items()}


def _rotating(x):
    # copies whose sum exceeds the L2 cache several times over, so each call
    # reads its input from device memory
    return [x] + [x.clone() for _ in range(-(-L2_FLUSH_BYTES // x.nbytes) - 1)]


def _copy_yardstick(nbytes, gen):
    """A device copy that reads nbytes / 2 and writes as much: the time the
    card takes to move a kernel's bytes with no arithmetic. Returns the
    callable and its rotating sources."""
    numel = nbytes // 4  # bf16 elements in half the bytes
    dst = torch.empty(numel, dtype=torch.bfloat16, device="cuda")
    srcs = _rotating(torch.randn(numel, generator=gen, device="cuda").to(torch.bfloat16))
    return (lambda src: dst.copy_(src)), srcs


def _bound_us(nbytes, ops):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the fp32 operations over the fp32 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e6, ops / FP32_OPS_PER_S * 1e6
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _blur_bytes(n, h, w, c, itemsize=2, pad_top=1):
    """BlurPool's bytes at an input of N x H x W x C: the input read and the
    output written once (the backward moves as many, from the output's
    extent to the input's)."""
    return (n * h * w * c + n * kblur.out_rows(h, pad_top) * ((w + 1) // 2) * c) * itemsize


def _apply_bytes(n, h, w, c, itemsize=2, counts=None):
    """The DropBlock apply's bytes: the activation in and out once, the fp32
    mask and the ``counts`` (N by default) fp32 counts read once."""
    return 2 * n * h * w * c * itemsize + n * h * w * 4 + (n if counts is None else counts) * 4


def _fused_bytes(n, h, w, c, itemsize=2, seeds=None):
    """The fused DropBlock kernel's bytes: the activation in and out once,
    the ``seeds`` (N by default) int32 seeds read, the fp32 mask and as many
    fp32 counts as seeds written once."""
    seeds = n if seeds is None else seeds
    return 2 * n * h * w * c * itemsize + seeds * 4 + n * h * w * 4 + seeds * 4


def _blur_library(kind, c, hw, dtype, pad_top=1):
    """One PyTorch call for the same function, used only as a yardstick:
    cuDNN's depthwise conv with the fixed binomial filter (exact in bf16),
    or its transpose for the backward; with ``pad_top=0`` no padding along
    H (a shard's halo row is its top padding)."""
    import torch.nn.functional as F

    k = torch.tensor([1.0, 2.0, 1.0], device="cuda") / 4
    wgt = (k[:, None] * k[None, :]).expand(c, 1, 3, 3).contiguous().to(dtype)
    padding = (pad_top, 1)
    if kind == "fwd":
        return lambda x: F.conv2d(x, wgt, stride=2, padding=padding, groups=c)
    h, w = hw
    ho = kblur.out_rows(h, pad_top)
    pad = (h - (2 * ho + 1 - 2 * pad_top), w - (2 * ((w + 1) // 2) - 1))
    return lambda g: F.conv_transpose2d(g, wgt, stride=2, padding=padding, output_padding=pad,
                                        groups=c)


def kernel_time_phase(errs):
    """Each kernel, its plain version and (BlurPool) the cuDNN call for the
    same function and a device copy of the same bytes at batch 128, bf16,
    beside its bound; sums per step's worth of shapes, by kernel, as the
    summary line's fields. Each BlurPool kernel's output on the timed input
    must equal its plain version's; ``errs`` takes the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": set(),
                  "library_ms": 0.0}
              for k in ("fwd", "bwd", "mask", "apply", "fused", "fused_window")}
    totals["fused"]["pair_ms"] = totals["fused_window"]["pair_ms"] = 0.0

    def add(kind, k, p, bound, bound_by, lib):
        tot = totals[kind]
        tot["ms"] += k
        tot["plain_ms"] += p
        tot["bound_ms"] += bound / 1e3
        tot["bound_by"].add(bound_by)
        tot["library_ms"] = None if lib is None else tot["library_ms"] + lib

    # top padding 1, and 0 at the spatial shards' shapes (the halo row on top)
    for (n, h, w, c), pt in ([(s, 1) for s in SLICE_SHAPES + BL_SHAPES]
                             + [(s, 0) for s in SPATIAL_BLUR_SHAPES]):
        ho, wo = kblur.out_rows(h, pt), (w + 1) // 2
        for kind in ("fwd", "bwd"):
            if kind == "fwd":
                shape = (TIME_BATCH, h, w, c)
                kernel = lambda x, pt=pt: kblur.blur_pool_cuda(x, pad_top=pt)  # noqa: E731
                plain = lambda x, pt=pt: kblur.blur_pool_reference(x, pt)  # noqa: E731
                out_elems = TIME_BATCH * ho * wo * c
                ops = 16 * out_elems  # 3 row sums and 1 column sum of 4 ops each
            else:
                shape = (TIME_BATCH, ho, wo, c)
                kernel = lambda g, hw=(h, w), pt=pt: kblur.blur_pool_bwd_cuda(  # noqa: E731
                    g, hw, pt)
                plain = lambda g, hw=(h, w), pt=pt: kblur.blur_pool_bwd_reference(  # noqa: E731
                    g, hw, pt)
                out_elems = TIME_BATCH * h * w * c
                ops = 3 * out_elems  # 12 ops per 2x2 block of dx
            library = _blur_library(kind, c, (h, w), torch.bfloat16, pt)
            xs = _rotating(_nchw_input(shape, torch.bfloat16, gen))
            nbytes = _blur_bytes(TIME_BATCH, h, w, c, xs[0].element_size(), pt)
            bound, bound_by = _bound_us(nbytes, ops)
            want = plain(xs[0])
            lib_err = (library(xs[0]).float() - want.float()).abs().max().item()
            before = dict(kblur.ROUTES)
            got = kernel(xs[0])
            route = _route_of(kind, before)
            errs[kind] = max(errs[kind], _check_equal(
                f"blur_pool3_s2_{kind}", shape, f"bf16, pad_top {pt}, timed input", got, want))
            del want, got
            copy, srcs = _copy_yardstick(nbytes, gen)
            t = _time_set({"plain": plain, "kernel": kernel, "library": library, "copy": copy},
                          xs, inputs={"copy": srcs})
            k, p, lib, cp = (t[n][0] for n in ("kernel", "plain", "library", "copy"))
            emit("kernel_time", kernel=kind, shape_nhwc=list(shape), pad_top=pt, dtype="bf16",
                 route=route, kernel_us=k * 1e3, plain_us=p * 1e3, library_us=lib * 1e3,
                 copy_us=cp * 1e3,
                 bound_us=bound, bound_by=bound_by, pct_of_bound=100 * bound / (k * 1e3),
                 library_pct_of_bound=100 * bound / (lib * 1e3),
                 copy_pct_of_bound=100 * bound / (cp * 1e3), kernel_over_copy=k / cp,
                 kernel_runs_us=[v * 1e3 for v in t["kernel"][1]],
                 plain_runs_us=[v * 1e3 for v in t["plain"][1]],
                 library_runs_us=[v * 1e3 for v in t["library"][1]],
                 copy_runs_us=[v * 1e3 for v in t["copy"][1]],
                 library_max_abs_err_vs_plain=lib_err, bytes=nbytes, ops=ops,
                 rotating_inputs=len(xs), kernel_gb_per_s=nbytes / (k * 1e-3) / 1e9)
            del xs, srcs
            if pt and (n, h, w, c) in SLICE_SHAPES:  # the summary sums one R50 step's shapes
                add(kind, k, p, bound, bound_by, lib)
    # whole maps, then the spatial shards' windows of rows
    for h, w, bs, row0, rows in ([(h, w, bs, 0, h) for h, w, bs in MASK_TIME_SHAPES]
                                 + SPATIAL_MASK_WINDOWS[:2]):
        # the mask kernel reads 512 bytes of seeds: there is no L2 to flush
        seeds = [_seeds(TIME_BATCH, gen) for _ in range(16)]
        window = dict(row0=row0, h_global=h)
        t = _time_set({
            "plain": lambda sd: kdrop.dropblock_mask_reference(sd, 0.02, rows, w, bs, **window),
            "kernel": lambda sd: kdrop.dropblock_mask_cuda(sd, 0.02, rows, w, bs, **window)},
            seeds)
        k, p = t["kernel"][0], t["plain"][0]
        # seeds in; the fp32 mask and counts out. About 14 ops (the fmix32
        # hash, the uniform, the compare) for each centre the rows read (a
        # window's and up to bs - 1 more, within the map), plus 2 * bs per
        # pixel for the dilation
        centres = min(row0 + rows + bs // 2, h) - max(row0 - (bs - 1) // 2, 0)
        nbytes = TIME_BATCH * 4 + TIME_BATCH * rows * w * 4 + TIME_BATCH * 4
        bound, bound_by = _bound_us(nbytes, TIME_BATCH * w * (14 * centres + 2 * bs * rows))
        emit("kernel_time", kernel="mask", shape=[TIME_BATCH, h, w, bs],
             rows=[row0, row0 + rows - 1], gamma=0.02, kernel_us=k * 1e3, plain_us=p * 1e3,
             library_us=None, bound_us=bound, bound_by=bound_by,
             pct_of_bound=100 * bound / (k * 1e3),
             kernel_runs_us=[v * 1e3 for v in t["kernel"][1]],
             plain_runs_us=[v * 1e3 for v in t["plain"][1]], bytes=nbytes)
        if rows == h:
            add("mask", k, p, bound, bound_by, None)
    # this batch's counts, then (the spatial shards) a global batch of two
    # data shards' counts and four shards' elements
    for shape, shards in ([(s, 1) for s in APPLY_TIME_SHAPES]
                          + [(s, 2) for s, _ in SPATIAL_APPLY_SHAPES]):
        n, h, w, c = shape
        x, _, mask, counts = _apply_inputs(shape, torch.bfloat16, gen, specials=False)
        numel = None
        if shards > 1:
            counts, numel = torch.cat([counts] * shards), 2 * shards * x.numel()
        xs = _rotating(x)
        elems = x.numel()
        # bf16 in and out once each, the fp32 mask and counts read once; two
        # fp32 multiplies per element
        nbytes = _apply_bytes(n, h, w, c, x.element_size(), counts.numel())
        bound, bound_by = _bound_us(nbytes, 2 * elems)
        copy, srcs = _copy_yardstick(nbytes, gen)
        for backward in (False, True):
            kernel, plain = _apply_fns(mask, counts, backward, numel)
            kind = "apply_bwd" if backward else "apply_fwd"
            errs["apply"] = max(errs["apply"], _check_equal(
                f"dropblock_{kind}", shape, "bf16, timed input", kernel(xs[0]), plain(xs[0]),
                bits=True))
            t = _time_set({"plain": plain, "kernel": kernel, "copy": copy}, xs,
                          inputs={"copy": srcs})
            k, p, cp = (t[n][0] for n in ("kernel", "plain", "copy"))
            emit("kernel_time", kernel=kind, shape_nhwc=list(shape), dtype="bf16",
                 counts=counts.numel(), numel=numel or elems, kernel_us=k * 1e3,
                 plain_us=p * 1e3, library_us=None, copy_us=cp * 1e3,
                 bound_us=bound, bound_by=bound_by, pct_of_bound=100 * bound / (k * 1e3),
                 copy_pct_of_bound=100 * bound / (cp * 1e3), kernel_over_copy=k / cp,
                 kernel_runs_us=[v * 1e3 for v in t["kernel"][1]],
                 plain_runs_us=[v * 1e3 for v in t["plain"][1]],
                 copy_runs_us=[v * 1e3 for v in t["copy"][1]], bytes=nbytes, ops=2 * elems,
                 rotating_inputs=len(xs), kernel_gb_per_s=nbytes / (k * 1e-3) / 1e9)
            if shards == 1:
                add("apply", k, p, bound, bound_by, None)
        del xs, srcs
    for shape in APPLY_TIME_SHAPES:
        n, h, w, c = shape
        bs = 7
        x, seeds, mask, counts = _apply_inputs(shape, torch.bfloat16, gen, specials=False)
        xs = _rotating(x)
        elems = x.numel()
        # bf16 in and out once each, the seeds read, the fp32 mask and counts
        # written once; two fp32 multiplies per element and the mask's ops
        nbytes = _fused_bytes(n, h, w, c, x.element_size())
        ops = 2 * elems + n * h * w * (14 + 2 * bs)
        bound, bound_by = _bound_us(nbytes, ops)
        fns = {
            "plain": lambda t: kdrop.dropblock_fused_reference(t, seeds, APPLY_GAMMA, bs),
            "kernel": lambda t: kdrop.dropblock_fused_cuda(t, seeds, APPLY_GAMMA, bs),
            # the two launches the fused kernel replaces, and the apply alone
            "pair": lambda t: kdrop.dropblock_apply_cuda(
                t, *kdrop.dropblock_mask_cuda(seeds, APPLY_GAMMA, h, w, bs)),
            "apply": lambda t: kdrop.dropblock_apply_cuda(t, mask, counts)}
        got, want = fns["kernel"](xs[0])[0], fns["plain"](xs[0])[0]
        errs["fused"] = max(errs["fused"], _check_equal(
            "dropblock_fused", shape, "bf16, timed input", got, want, bits=True))
        del got, want
        t = _time_set(fns, xs)
        k, p, pair, alone = (t[n][0] for n in ("kernel", "plain", "pair", "apply"))
        emit("kernel_time", kernel="fused", shape_nhwc=list(shape), dtype="bf16", bs=bs,
             gamma=APPLY_GAMMA, kernel_us=k * 1e3, plain_us=p * 1e3, library_us=None,
             mask_then_apply_us=pair * 1e3, apply_alone_us=alone * 1e3, bound_us=bound,
             bound_by=bound_by, pct_of_bound=100 * bound / (k * 1e3),
             pair_pct_of_bound=100 * bound / (pair * 1e3),
             kernel_runs_us=[v * 1e3 for v in t["kernel"][1]],
             plain_runs_us=[v * 1e3 for v in t["plain"][1]],
             mask_then_apply_runs_us=[v * 1e3 for v in t["pair"][1]],
             apply_alone_runs_us=[v * 1e3 for v in t["apply"][1]], bytes=nbytes, ops=ops,
             rotating_inputs=len(xs), kernel_gb_per_s=nbytes / (k * 1e-3) / 1e9)
        add("fused", k, p, bound, bound_by, None)
        totals["fused"]["pair_ms"] += pair
        del xs
    # the fused window kernel at the 448x448 S = 2 shards' sites (the second
    # shard, D = 1: every rank draws the 128 samples' whole maps)
    for (n, rows, w, c), h in SPATIAL_APPLY_SHAPES:
        bs, shape = 7, (n, rows, w, c)
        window = dict(row0=rows, h_global=h, first=0, numel=2 * n * rows * w * c)
        x = _nchw_input(shape, torch.bfloat16, gen)
        seeds = _seeds(n, gen)
        xs = _rotating(x)
        elems = x.numel()
        # bf16 in and out once each, the global seeds read, the window's fp32
        # mask and the global counts written once; two fp32 multiplies per
        # element and the mask's ops over every global sample's whole map
        nbytes = _fused_bytes(n, rows, w, c, x.element_size(), seeds=n)
        ops = 2 * elems + n * h * w * (14 + 2 * bs)
        bound, bound_by = _bound_us(nbytes, ops)
        mask, counts = kdrop.dropblock_mask_cuda(seeds, APPLY_GAMMA, rows, w, bs, row0=rows,
                                                 h_global=h)
        fns = {
            "plain": lambda t: kdrop.dropblock_fused_window_reference(
                t, seeds, APPLY_GAMMA, bs, **window),
            "kernel": lambda t: kdrop.dropblock_fused_window_cuda(t, seeds, APPLY_GAMMA, bs,
                                                                  **window),
            # the two launches it replaces (the counts' collective between
            # them is not timed: one card), and the apply alone
            "pair": lambda t: kdrop.dropblock_apply_cuda(
                t, *kdrop.dropblock_mask_cuda(seeds, APPLY_GAMMA, rows, w, bs, row0=rows,
                                              h_global=h), numel=window["numel"]),
            "apply": lambda t: kdrop.dropblock_apply_cuda(t, mask, counts,
                                                          numel=window["numel"])}
        errs["fused_window"] = max(errs["fused_window"], _check_equal(
            "dropblock_fused_window", shape, "bf16, timed input", fns["kernel"](xs[0])[0],
            fns["plain"](xs[0])[0], bits=True))
        copy, srcs = _copy_yardstick(nbytes, gen)
        fns["copy"] = copy
        t = _time_set(fns, xs, inputs={"copy": srcs})
        k, p, pair, alone, cp = (t[n][0] for n in ("kernel", "plain", "pair", "apply", "copy"))
        emit("kernel_time", kernel="fused_window", shape_nhwc=list(shape), h_global=h,
             rows=[rows, 2 * rows - 1], n_global=n, dtype="bf16", bs=bs, gamma=APPLY_GAMMA,
             kernel_us=k * 1e3, plain_us=p * 1e3, library_us=None, copy_us=cp * 1e3,
             mask_then_apply_us=pair * 1e3, apply_alone_us=alone * 1e3, bound_us=bound,
             bound_by=bound_by, pct_of_bound=100 * bound / (k * 1e3),
             pair_pct_of_bound=100 * bound / (pair * 1e3),
             copy_pct_of_bound=100 * bound / (cp * 1e3), kernel_over_copy=k / cp,
             kernel_runs_us=[v * 1e3 for v in t["kernel"][1]],
             plain_runs_us=[v * 1e3 for v in t["plain"][1]],
             mask_then_apply_runs_us=[v * 1e3 for v in t["pair"][1]],
             apply_alone_runs_us=[v * 1e3 for v in t["apply"][1]],
             copy_runs_us=[v * 1e3 for v in t["copy"][1]], bytes=nbytes, ops=ops,
             rotating_inputs=len(xs), kernel_gb_per_s=nbytes / (k * 1e-3) / 1e9)
        add("fused_window", k, p, bound, bound_by, None)
        totals["fused_window"]["pair_ms"] += pair
        del xs, srcs
    for tot in totals.values():
        tot["bound_by"] = "/".join(sorted(tot["bound_by"]))
    return totals


def _write_jpegs(directory, count):
    from PIL import Image

    rng = np.random.default_rng(SEED)
    paths = []
    for i in range(count):
        h, w = int(rng.integers(200, 400)), int(rng.integers(200, 400))
        p = os.path.join(directory, f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def _zero_counts():
    kblur.LAUNCHES = kblur.BWD_LAUNCHES = kdrop.LAUNCHES = 0
    kdrop.APPLY_LAUNCHES = kdrop.APPLY_BWD_LAUNCHES = kdrop.FUSED_LAUNCHES = 0
    kdrop.FUSED_WINDOW_LAUNCHES = 0
    kblur.BWD_G_NOT_CHANNELS_LAST = kdrop.APPLY_NOT_CHANNELS_LAST = 0
    kblur.ROUTES.update(dict.fromkeys(kblur.ROUTES, 0))


def _counts():
    return {"fwd": kblur.LAUNCHES, "bwd": kblur.BWD_LAUNCHES, "mask": kdrop.LAUNCHES,
            "apply": kdrop.APPLY_LAUNCHES, "apply_bwd": kdrop.APPLY_BWD_LAUNCHES,
            "fused": kdrop.FUSED_LAUNCHES, "fused_window": kdrop.FUSED_WINDOW_LAUNCHES}


def _launches(fwd, bwd, sites):
    """Expected counts: BlurPool forward and backward launches, and
    ``sites`` DropBlock sites of the presets' maps (14x14, 7x7), each the
    fused kernel forward and the apply backward; the standalone mask and
    forward apply launch only past the fused line (``big_sites``), the fused
    window kernel only under spatial partitioning."""
    return {"fwd": fwd, "bwd": bwd, "mask": 0, "apply": 0, "apply_bwd": sites, "fused": sites,
            "fused_window": 0}


def serve_phase():
    from axcnn_torch.cli import predict

    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_jpegs(tmp, 32)
        # a model_dir of its own, without checkpoints: the seeded random init
        model_dir = os.path.join(tmp, "no_checkpoints")
        _zero_counts()
        for n in (1, 8, 32):
            before = kblur.LAUNCHES
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = predict.main([*(f"--image={p}" for p in paths[:n]),
                                   "--config=assemble_resnet50",
                                   f"--runtime.model_dir={model_dir}"])
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"predict exited {rc}: {err.getvalue()}")
            if "random init" not in err.getvalue():
                raise AssertionError(f"predict did not serve the random init: {err.getvalue()}")
            lines = [json.loads(line) for line in out.getvalue().splitlines()]
            assert [line["image"] for line in lines] == paths[:n], lines
            for line in lines:
                top5 = line["top5"]
                probs = [p for _, p in top5]
                assert len(top5) == 5 and len({c for c, _ in top5}) == 5, line
                assert all(isinstance(c, int) and 0 <= c < 1001 for c, _ in top5), line
                assert probs == sorted(probs, reverse=True) and sum(probs) <= 1 + 1e-4
            launched = kblur.LAUNCHES - before
            emit("serve", images=n, lines=len(lines), launches=launched,
                 seconds=seconds, first=lines[0])
            if launched != 3:
                raise AssertionError(f"expected 3 BlurPool launches, got {launched}")
        if _counts() != _launches(9, 0, 0):
            raise AssertionError(f"serving launched training kernels: {_counts()}")
        return _counts()


def _assembled_cfg():
    from axcnn_torch.utils.config import load_preset

    return dataclasses.replace(load_preset("assemble_resnet50").model, num_classes=1001)


def _perturb_bn(model, seed):
    from axcnn_torch.ops.norm import BatchNorm

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                lo, hi = (0.1, 0.3) if name.endswith("bn3") else (0.5, 1.5)
                m.weight.copy_(torch.from_numpy(rng.uniform(lo, hi, c)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))


def parity_phase():
    from axcnn_torch.core.dtypes import BF16_POLICY, DEFAULT_POLICY, set_fp32_precision
    from axcnn_torch.data.preprocessing import normalize_device
    from axcnn_torch.models.resnet import ResNet

    set_fp32_precision(DEFAULT_POLICY)
    model = ResNet(_assembled_cfg(), generator=torch.Generator().manual_seed(SEED))
    _perturb_bn(model, SEED)
    model.eval()
    u8 = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (2, 224, 224, 3), dtype=np.uint8))
    with torch.inference_mode():
        ref = model(normalize_device(u8)).numpy()
    model.to("cuda", memory_format=torch.channels_last)
    x = normalize_device(u8.cuda())
    before = kblur.LAUNCHES
    with torch.inference_mode():
        fp32 = model(x).cpu().numpy()
        bf16 = model(x, policy=BF16_POLICY).cpu().numpy()
        launched = kblur.LAUNCHES - before
    assert np.isfinite(fp32).all() and np.isfinite(bf16).all()
    rel = lambda a: float(np.linalg.norm(a - ref) / np.linalg.norm(ref))  # noqa: E731
    e32, e16 = rel(fp32), rel(bf16)
    ok = e32 <= 1e-3 and e16 <= 5e-2 and launched == 6
    emit("parity", batch=2, logits_shape=list(fp32.shape), ref_norm=float(np.linalg.norm(ref)),
         fp32_rel_l2=e32, fp32_tol=1e-3, bf16_rel_l2=e16, bf16_tol=5e-2,
         kernel_launches=launched, top1_agree_bf16=bool((bf16.argmax(1) == ref.argmax(1)).all()),
         ok=ok)
    if not ok:
        raise AssertionError("card-vs-CPU logits parity failed")


def throughput_phase(smi):
    from axcnn_torch.train.train_step import create_train_state, load_ema

    # the model predict serves: the preset's EMA weights, loaded once
    state = create_train_state(_assembled_cfg(), generator=torch.Generator().manual_seed(SEED),
                               device="cuda", use_ema=True)
    load_ema(state)
    for batch, rate in _served(state).items():
        emit("throughput", model="assemble_resnet50", batch=batch, dtype="bf16", **rate,
             card=smi)


def _served(state, policy=None):
    """The served forward of ``state``'s model (``eval_logits``, bf16 unless
    ``policy``) on random uint8 images: {batch: img/s, ms a batch, iters} at
    b128 (20 forwards) and b1 (50), each ending in a synchronize."""
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.train.train_step import eval_logits

    policy = policy or BF16_POLICY
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for batch, iters in ((TIME_BATCH, 20), (1, 50)):
        u8 = torch.randint(0, 256, (batch, 224, 224, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
        fwd = functools.partial(eval_logits, state, u8, policy=policy)
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            logits = fwd()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        assert torch.isfinite(logits).all() and logits.shape == (batch, 1001)
        out[batch] = {"img_per_s": batch / dt, "ms_per_batch": dt * 1e3, "iters": iters}
    return out


def _run_cli(argv):
    """``main_classification.main(argv)`` with the kernel counts zeroed just
    before; returns (metrics, counts, seconds, peak bytes, records)."""
    from axcnn_torch.cli import main_classification

    model_dir = next(a.split("=", 1)[1] for a in argv if a.startswith("--runtime.model_dir="))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, err = io.StringIO(), io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        metrics = main_classification.main(argv)
    seconds = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return metrics, counts, seconds, peak, records


def _step_walls(train):
    """log_every=1: each record follows a host sync on the step's loss, so
    the gaps between records are CUDA-synchronized step walls."""
    return np.diff([r["time"] for r in train])


def train_phase(smi, model_dir=None):
    """The training CLI at full width, b128, bf16, on synthetic data; its
    checkpoint stays in ``model_dir`` when given (``export`` and ``mce``
    serve it)."""
    with contextlib.ExitStack() as stack:
        if model_dir is None:
            model_dir = stack.enter_context(tempfile.TemporaryDirectory())
        argv = ["--config=assemble_resnet50", "--data.use_synthetic_data",
                f"--train.train_steps={TRAIN_STEPS}", f"--train.batch_size={TIME_BATCH}",
                "--train.log_every=1", "--runtime.num_devices=1",
                f"--runtime.model_dir={model_dir}"]
        metrics, counts, seconds, peak, records = _run_cli(argv)
    routes, g_not_cl = dict(kblur.ROUTES), kblur.BWD_G_NOT_CHANNELS_LAST
    apply_not_cl = kdrop.APPLY_NOT_CHANNELS_LAST
    train = [r for r in records if r["tag"] == "train"]
    losses = [r["loss"] for r in train]
    assert [r["step"] for r in train] == list(range(1, TRAIN_STEPS + 1)), records
    assert all(np.isfinite(losses)), losses
    assert metrics["count"] == 4 * TIME_BATCH, metrics  # the synthetic eval set
    walls = _step_walls(train)
    step_s = float(walls.mean())
    eval_batches = 4
    want = _launches(3 * TRAIN_STEPS + 3 * eval_batches, 3 * TRAIN_STEPS, 9 * TRAIN_STEPS)
    emit("train", model="assemble_resnet50", batch=TIME_BATCH, dtype="bf16",
         steps=TRAIN_STEPS, first_loss=losses[0], last_loss=losses[-1],
         mean_step_ms=step_s * 1e3, step_ms_min=float(walls.min()) * 1e3,
         step_ms_max=float(walls.max()) * 1e3, train_img_per_s=TIME_BATCH / step_s,
         max_memory_allocated_gib=peak / 2 ** 30, launches=counts, expected=want,
         routes=routes, bwd_g_not_channels_last=g_not_cl,
         apply_not_channels_last=apply_not_cl, eval=metrics, seconds=seconds, card=smi)
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    if apply_not_cl:
        raise AssertionError(f"{apply_not_cl} DropBlock tensors were copied into channels_last")
    if routes["fwd_thread"] or routes["bwd_thread"]:
        raise AssertionError(f"the train path left the TMA route: {routes}")
    return counts, {"img_per_s": TIME_BATCH / step_s, "peak_gib": peak / 2 ** 30}


def _state_copy(state, device):
    """A copy of a train state on ``device`` (channels_last weights)."""
    import copy

    new = copy.deepcopy(state)
    new.model.to(device, memory_format=torch.channels_last)
    new.velocity = {k: v.to(device) for k, v in new.velocity.items()}
    new.ema = {k: v.to(device) for k, v in new.ema.items()}
    return new


def _update_errors(old, new, ref):
    """Per-parameter relative L2 of the update ``new - old`` against
    ``ref - old``, in float64."""
    errs = {}
    for k, p0 in old.items():
        want = (ref[k] - p0).double()
        errs[k] = float(((new[k] - p0).double() - want).norm() / want.norm().clamp_min(1e-30))
    return errs


def train_parity_phase():
    """One full-width train step, fp32 with TF32 off, batch 4, DropBlock and
    mixup active, from one state, batch and seeds: on the card through the
    kernels, on the CPU through the plain versions, and on the CPU in
    float64 (every fp32 cast of the port re-pointed to float64). At batch 4
    fp32 rounding flips ReLU and max-pool ties, so two fp32 runs differ by
    ~1e-2 per leaf whatever their device; the check is that the card's fp32
    step is as near the float64 step as the CPU's own fp32 step is."""
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, Policy, set_fp32_precision
    from axcnn_torch.train.schedules import make_lr_schedule
    from axcnn_torch.train.train_step import create_train_state, make_train_step

    set_fp32_precision(DEFAULT_POLICY)
    n, step, total = 4, 5, 10
    cfg = _assembled_cfg()
    cpu = create_train_state(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu", use_ema=True)
    _perturb_bn(cpu.model, SEED)
    cpu.step = step  # keep-prob 0.95: DropBlock drops
    card, cpu64 = _state_copy(cpu, "cuda"), _state_copy(cpu, "cpu")
    cpu64.model.double()
    cpu64.velocity = {k: v.double() for k, v in cpu64.velocity.items()}
    cpu64.ema = {k: v.double() for k, v in cpu64.ema.items()}
    kw = dict(lr_schedule=make_lr_schedule(base_lr=0.1 * n / 256, total_steps=total,
                                           warmup_steps=2),
              total_steps=total, label_smoothing=0.1, mixup_alpha=0.2)
    train_step = make_train_step(cfg, **kw)
    rng = np.random.default_rng(SEED)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, 1001, n).astype(np.int64))}
    old = {k: p.detach().clone() for k, p in cpu.model.named_parameters()}

    _zero_counts()
    card, m_card = train_step(card, {k: v.cuda() for k, v in batch.items()}, SEED + 1)
    torch.cuda.synchronize()
    launched = _counts()
    cpu, m_cpu = train_step(cpu, batch, SEED + 1)
    to_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        step64 = make_train_step(cfg, policy=Policy(torch.float64, torch.float64), **kw)
        cpu64, m_64 = step64(cpu64, batch, SEED + 1)
    finally:
        torch.Tensor.float = to_float

    params = lambda st: {k: p.detach().cpu() for k, p in st.model.named_parameters()}  # noqa: E731
    ref = params(cpu64)
    e_card = _update_errors(old, params(card), ref)
    e_cpu = _update_errors(old, params(cpu), ref)
    e_pair = _update_errors(old, params(card), params(cpu))
    med = lambda e: float(np.median(list(e.values())))  # noqa: E731
    loss_rel = abs(m_card["loss"].item() - m_64["loss"].item()) / abs(m_64["loss"].item())
    tol = dict(loss_rel=1e-4, median_vs_cpu_fp32=3.0, worst_vs_cpu_fp32=3.0)
    ok = (loss_rel <= tol["loss_rel"]
          and med(e_card) <= tol["median_vs_cpu_fp32"] * med(e_cpu)
          and max(e_card.values()) <= tol["worst_vs_cpu_fp32"] * max(e_cpu.values())
          and launched == _launches(3, 3, 9))
    emit("train_parity", batch=n, step=step, dtype="fp32", tf32=False,
         loss_card=m_card["loss"].item(), loss_cpu=m_cpu["loss"].item(),
         loss_fp64=m_64["loss"].item(), loss_rel_card_vs_fp64=loss_rel,
         mixup_lam=m_cpu["mixup_lam"],
         card_vs_fp64={"median": med(e_card), "worst": max(e_card.values()),
                       "worst_leaf": max(e_card, key=e_card.get)},
         cpu_fp32_vs_fp64={"median": med(e_cpu), "worst": max(e_cpu.values())},
         card_vs_cpu_fp32={"median": med(e_pair), "worst": max(e_pair.values())},
         leaves=len(e_card), tolerance=tol, launches_per_step=launched, ok=ok)
    if not ok:
        raise AssertionError("card-vs-CPU train step parity failed")


def _state_tensors(state):
    return {"model": state.model.state_dict(), "velocity": state.velocity,
            "ema": state.ema}


def checkpoint_phase(smi, tmp):
    """A full-width assembled R50 state after 3 b128 bf16 train steps, saved
    and restored into a fresh state: bit for bit, in the fresh strides."""
    from axcnn_torch.ckpt.checkpoint import CheckpointManager
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.train.schedules import make_lr_schedule
    from axcnn_torch.train.train_step import create_train_state, make_train_step

    cfg = _assembled_cfg()
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(SEED),
                               device="cuda", use_ema=True)
    step = make_train_step(cfg, lr_schedule=make_lr_schedule(
        base_lr=0.05, total_steps=10, warmup_steps=0), total_steps=10,
        policy=BF16_POLICY, label_smoothing=0.1, mixup_alpha=0.2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"images": torch.randint(0, 256, (TIME_BATCH, 224, 224, 3), generator=gen,
                                     device="cuda", dtype=torch.uint8),
             "labels": torch.randint(0, 1001, (TIME_BATCH,), generator=gen, device="cuda")}
    _zero_counts()
    for _ in range(3):
        state, metrics = step(state, batch, SEED + 1)
    torch.cuda.synchronize()
    counts = _counts()
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), max_to_keep=1)
    t0 = time.perf_counter()
    mgr.save(state)
    save_s = time.perf_counter() - t0  # the loop's pause: the snapshot
    mgr.wait()
    write_s = time.perf_counter() - t0 - save_s
    fresh = create_train_state(cfg, generator=torch.Generator().manual_seed(SEED + 9),
                               device="cuda", use_ema=True)
    strides = {f: {k: t.stride() for k, t in d.items()}
               for f, d in _state_tensors(fresh).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, _, _ = mgr.restore(fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    n, bad = 0, []
    for field, want in _state_tensors(state).items():
        got = _state_tensors(restored)[field]
        for k, t in want.items():
            n += 1
            if not (torch.equal(got[k], t) and got[k].stride() == strides[field][k]
                    and got[k].device == t.device):
                bad.append(f"{field}/{k}")
    ok = not bad and restored.step == 3 and counts == _launches(9, 9, 27)
    emit("checkpoint", model="assemble_resnet50", steps=3, batch=TIME_BATCH, dtype="bf16",
         loss=metrics["loss"].item(), tensors=n, differ=bad[:5],
         file_mb=os.path.getsize(mgr.path(3)) / 1e6, save_s=save_s, write_s=write_s,
         restore_s=restore_s,
         launches=counts, card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"checkpoint round trip failed: {bad[:5]} {counts}")
    return counts


def _resume_argv(model_dir, steps):
    return ["--config=assemble_resnet50", "--data.use_synthetic_data",
            f"--train.train_steps={steps}", f"--train.batch_size={TIME_BATCH}",
            "--train.log_every=1", f"--runtime.save_checkpoint_steps={RESUME_STEPS[0]}",
            "--runtime.hang_watchdog_s=300", "--runtime.profile_steps=2",
            "--runtime.num_devices=1", f"--runtime.model_dir={model_dir}"]


def resume_phase(smi, model_dir):
    """The CLI for 5 steps, then the same command to 10: the second run
    restores step 5 and trains 6-10 through the kernels."""
    first, second = RESUME_STEPS
    eval_fwd = 3 * 4  # the end-of-run eval: 4 synthetic batches
    runs = []
    for start, end in ((0, first), (first, second)):
        metrics, counts, seconds, peak, records = _run_cli(_resume_argv(model_dir, end))
        n = end - start
        want = _launches(3 * n + eval_fwd, 3 * n, 9 * n)
        new = records[sum(len(r["records"]) for r in runs):]
        train = [r for r in new if r["tag"] == "train"]
        runs.append(dict(records=new, counts=counts, want=want, seconds=seconds,
                         steps=[r["step"] for r in train],
                         losses=[r["loss"] for r in train], walls=_step_walls(train)))
    r1, r2 = runs
    restore = [r for r in r2["records"] if r["tag"] == "restore"]
    traces = glob.glob(os.path.join(model_dir, "profile", "*.json"))
    ok = (r1["steps"] == list(range(1, first + 1))
          and r2["steps"] == list(range(first + 1, second + 1))
          and [r["step"] for r in restore] == [first]
          and all(np.isfinite(r1["losses"] + r2["losses"]))
          and all(r["counts"] == r["want"] for r in runs) and bool(traces))
    emit("resume", model="assemble_resnet50", batch=TIME_BATCH, dtype="bf16",
         restored_at=[r["step"] for r in restore], losses=r1["losses"] + r2["losses"],
         launches=[r["counts"] for r in runs], expected=[r["want"] for r in runs],
         resumed_mean_step_ms=float(r2["walls"].mean()) * 1e3,
         seconds=[r["seconds"] for r in runs], traces=[os.path.basename(t) for t in traces],
         checkpoints=sorted(os.listdir(os.path.join(model_dir, "checkpoints"))),
         card=smi, ok=ok)
    if not ok:
        raise AssertionError("resume phase failed")
    return r2["counts"]


def _predict_lines(logits, paths):
    """predict's output lines for fp32 ``logits``, computed as it does."""
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    return [{"image": p, "top5": [[int(i), round(float(pr[i]), 5)]
                                  for i in np.argsort(pr)[::-1][:5]]}
            for p, pr in zip(paths, probs)]


def serve_ckpt_phase(model_dir, tmp, phase="serve_ckpt"):
    """``predict`` on the checkpoint in ``model_dir`` (the resumed run's; in
    ``tf_import``, the imported one's) against the restored EMA state's own
    ``eval_logits`` on the same decoded batch."""
    from axcnn_torch.ckpt.checkpoint import CheckpointManager
    from axcnn_torch.cli import predict
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.data.datasets import get_dataset
    from axcnn_torch.data.preprocessing import preprocess_eval
    from axcnn_torch.train.train_step import create_train_state, eval_logits

    paths = _write_jpegs(tmp, 8)
    out, err = io.StringIO(), io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = predict.main([*(f"--image={p}" for p in paths), "--config=assemble_resnet50",
                           f"--runtime.model_dir={model_dir}"])
    counts = _counts()
    if rc != 0:
        raise AssertionError(f"predict exited {rc}: {err.getvalue()}")
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    state = create_train_state(_assembled_cfg(), generator=torch.Generator(),
                               device="cuda", use_ema=True)
    state, _, _ = CheckpointManager(os.path.join(model_dir, "checkpoints")).restore(state)
    u8 = np.stack([preprocess_eval(open(p, "rb").read(), image_size=224, resize_min=256)
                   for p in paths])
    info = get_dataset("imagenet")
    logits = eval_logits(state, torch.from_numpy(u8).cuda(), policy=BF16_POLICY, use_ema=True,
                         mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    want = _predict_lines(logits.cpu().numpy(), paths)
    ok = (got == want and "random init" not in err.getvalue()
          and counts == _launches(3, 0, 0))
    emit(phase, images=len(paths), step=state.step, launches=counts,
         top5_equal=got == want, first=got[0], want_first=want[0], ok=ok)
    if not ok:
        raise AssertionError("serving the checkpoint disagrees with its restored state")
    return counts


def kd_phase(smi, teacher_dir, model_dir):
    """Assemble-ResNet-152 distilled from the resumed R50 run, global batch
    1024 as 8 micro-batches of 128, bf16, through the CLI."""
    argv = ["--config=assemble_resnet152_kd", "--data.use_synthetic_data",
            f"--train.batch_size={KD_BATCH}", f"--train.grad_accum_steps={KD_ACCUM}",
            f"--train.train_steps={KD_STEPS}", "--train.log_every=1",
            f"--train.kd_teacher_checkpoint={teacher_dir}/checkpoints",
            "--runtime.num_devices=1", f"--runtime.model_dir={model_dir}"]
    metrics, counts, seconds, peak, records = _run_cli(argv)
    train = [r for r in records if r["tag"] == "train"]
    losses = [r["loss"] for r in train]
    walls = _step_walls(train)
    step_s = float(walls.mean())
    micro = KD_STEPS * KD_ACCUM
    want = _launches(micro * (3 + 3) + 3 * 4, micro * 3, micro * 39)
    ok = ([r["step"] for r in train] == list(range(1, KD_STEPS + 1))
          and all(np.isfinite(losses)) and counts == want
          and metrics["count"] == 4 * KD_BATCH)
    emit("kd", model="assemble_resnet152_kd", teacher="assemble_resnet50",
         batch=KD_BATCH, grad_accum_steps=KD_ACCUM, micro_batch=KD_BATCH // KD_ACCUM,
         dtype="bf16", steps=KD_STEPS, losses=losses, step_ms=[w * 1e3 for w in walls],
         mean_step_ms=step_s * 1e3, train_img_per_s=KD_BATCH / step_s,
         max_memory_allocated_gib=peak / 2 ** 30, launches=counts, expected=want,
         eval=metrics, seconds=seconds, card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"KD phase failed: launches {counts}, expected {want}")
    return counts


def _dp_steps(cfg, total, mixup_alpha, **kw):
    """The fp32 step of ``dp`` and ``train_parity``'s kind: label smoothing,
    the LR of a b128 run; ``kw`` passes the policy or the process group."""
    from axcnn_torch.train.schedules import make_lr_schedule
    from axcnn_torch.train.train_step import make_train_step

    return make_train_step(
        cfg, lr_schedule=make_lr_schedule(base_lr=0.05, total_steps=total, warmup_steps=0),
        total_steps=total, label_smoothing=0.1, mixup_alpha=mixup_alpha, **kw)


def _dp_rank(rank, world, coordinator, workdir):
    """One rank of ``dp``, in its own process on card 0, over Gloo: the
    parity step on its half of the batch, then one step with DropBlock and
    mixup active; rank 0 saves the parameters after the first."""
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, set_fp32_precision
    from axcnn_torch.parallel import mesh
    from axcnn_torch.train.train_step import create_train_state

    set_fp32_precision(DEFAULT_POLICY)
    device = torch.device("cuda", 0)
    mesh.init_distributed(device, rank=rank, world_size=world, coordinator=coordinator,
                          backend="gloo")
    try:
        payload = torch.load(os.path.join(workdir, "dp_in.pt"), weights_only=False)
        cfg = _assembled_cfg()
        state = create_train_state(cfg, generator=torch.Generator(), device=device)
        state.model.load_state_dict(payload["model"])
        state.velocity = {k: v.to(device) for k, v in payload["velocity"].items()}
        state.ema = {k: v.to(device) for k, v in payload["ema"].items()}
        group = mesh.data_group()
        part = slice(rank * DP_LOCAL_BATCH, (rank + 1) * DP_LOCAL_BATCH)
        batch = {k: v[part].to(device) for k, v in payload["batch"].items()}
        # step 0 of 2: keep-prob 1.0, so DropBlock's kernels launch and drop nothing
        state, m1 = _dp_steps(cfg, 2, 0.0, group=group)(state, batch, SEED + 1)
        if rank == 0:
            torch.save({k: p.detach().cpu() for k, p in state.model.named_parameters()},
                       os.path.join(workdir, "dp_params.pt"))
        # step 1 of 2: keep-prob 0.95 and mixup
        _zero_counts()
        state, m2 = _dp_steps(cfg, 2, 0.2, group=group)(state, batch, SEED + 1)
        torch.cuda.synchronize()
        counts = _counts()
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        hi, lo = flat.clone(), flat.clone()
        torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
        torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
        differ = int((hi != lo).sum())
    finally:
        mesh.shutdown()
    with open(os.path.join(workdir, f"dp_rank{rank}.json"), "w") as f:
        json.dump({"loss_parity_step": m1["loss"].item(), "loss_active_step": m2["loss"].item(),
                   "mixup_lam": float(m2["mixup_lam"]), "params_differ_across_ranks": differ,
                   "params": flat.numel(), "launches": counts}, f)


def dp_phase(smi, tmp):
    """Two Gloo ranks on card 0 against one process, each held to the
    float64 CPU step (``train_parity``'s measure): the ranks' step must be as
    near the float64 step as the single-process card step is."""
    import torch.multiprocessing as mp

    from axcnn_torch.cli.main_classification import _free_port
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, Policy, set_fp32_precision
    from axcnn_torch.train.train_step import create_train_state

    set_fp32_precision(DEFAULT_POLICY)
    n = DP_RANKS * DP_LOCAL_BATCH
    cfg = _assembled_cfg()
    cpu = create_train_state(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu", use_ema=True)
    _perturb_bn(cpu.model, SEED)
    rng = np.random.default_rng(SEED + 3)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, 1001, n).astype(np.int64))}
    old = {k: p.detach().clone() for k, p in cpu.model.named_parameters()}
    torch.save({"model": cpu.model.state_dict(), "velocity": cpu.velocity, "ema": cpu.ema,
                "batch": batch}, os.path.join(tmp, "dp_in.pt"))

    card = _state_copy(cpu, "cuda")
    card, m_card = _dp_steps(cfg, 2, 0.0)(card, {k: v.cuda() for k, v in batch.items()},
                                          SEED + 1)
    single = {k: p.detach().cpu() for k, p in card.model.named_parameters()}
    del card
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mp.start_processes(_dp_rank, nprocs=DP_RANKS, start_method="spawn",
                       args=(DP_RANKS, f"127.0.0.1:{_free_port()}", tmp))
    dp_s = time.perf_counter() - t0
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(tmp, f"dp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    dp = torch.load(os.path.join(tmp, "dp_params.pt"))

    # the float64 step on the CPU; remat keeps its activations to one block
    t0 = time.perf_counter()
    cfg64 = dataclasses.replace(cfg, remat="blocks")
    cpu64 = create_train_state(cfg64, generator=torch.Generator(), device="cpu")
    cpu64.model.load_state_dict(cpu.model.state_dict())
    cpu64.model.double()
    cpu64.velocity = {k: v.double() for k, v in cpu.velocity.items()}
    cpu64.ema = {k: v.double() for k, v in cpu.ema.items()}
    to_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        cpu64, m_64 = _dp_steps(cfg64, 2, 0.0, policy=Policy(torch.float64, torch.float64))(
            cpu64, batch, SEED + 1)
    finally:
        torch.Tensor.float = to_float
    fp64_s = time.perf_counter() - t0
    ref = {k: p.detach() for k, p in cpu64.model.named_parameters()}

    e_dp, e_single = _update_errors(old, dp, ref), _update_errors(old, single, ref)
    med = lambda e: float(np.median(list(e.values())))  # noqa: E731
    loss64 = m_64["loss"].item()
    loss_rel = abs(ranks[0]["loss_parity_step"] - loss64) / abs(loss64)
    tol = dict(loss_rel=1e-4, median_vs_single=3.0, worst_vs_single=3.0)
    want = _launches(3, 3, 9)
    ok = (loss_rel <= tol["loss_rel"]
          and med(e_dp) <= tol["median_vs_single"] * med(e_single)
          and max(e_dp.values()) <= tol["worst_vs_single"] * max(e_single.values())
          and all(np.isfinite([r["loss_parity_step"], r["loss_active_step"]]).all()
                  for r in ranks)
          and all(r["params_differ_across_ranks"] == 0 for r in ranks)
          and all(r["launches"] == want for r in ranks))
    emit("dp", ranks=DP_RANKS, backend="gloo", card="0 (both ranks)", batch_per_rank=DP_LOCAL_BATCH,
         dtype="fp32", tf32=False, loss_dp=ranks[0]["loss_parity_step"],
         loss_single=m_card["loss"].item(), loss_fp64=loss64, loss_rel_dp_vs_fp64=loss_rel,
         dp_vs_fp64={"median": med(e_dp), "worst": max(e_dp.values()),
                     "worst_leaf": max(e_dp, key=e_dp.get)},
         single_vs_fp64={"median": med(e_single), "worst": max(e_single.values())},
         active_step=[{k: r[k] for k in ("loss_active_step", "mixup_lam",
                                         "params_differ_across_ranks", "params")}
                      for r in ranks],
         launches_per_rank=[r["launches"] for r in ranks], expected=want, tolerance=tol,
         ranks_seconds=dp_s, fp64_cpu_seconds=fp64_s, nvidia_smi=smi, ok=ok)
    if not ok:
        raise AssertionError("dp phase failed")
    return ranks[0]["launches"]


def remat_phase(smi, tmp, without):
    """``model.remat=blocks``: one step beside one without from the same
    state and batch (BN moving statistics, launches), then the CLI for 5
    steps (losses, launches, peak memory beside the train phase's)."""
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.train.train_step import create_train_state

    cfg = _assembled_cfg()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"images": torch.randint(0, 256, (TIME_BATCH, 224, 224, 3), generator=gen,
                                     device="cuda", dtype=torch.uint8),
             "labels": torch.randint(0, 1001, (TIME_BATCH,), generator=gen, device="cuda")}
    stats, counts = {}, {}
    for remat in ("none", "blocks"):
        c = dataclasses.replace(cfg, remat=remat)
        state = create_train_state(c, generator=torch.Generator().manual_seed(SEED),
                                   device="cuda")
        state.step = 1  # step 1 of 2: keep-prob 0.95, DropBlock drops
        start = {k: b.clone() for k, b in state.model.named_buffers()}
        _zero_counts()
        state, _ = _dp_steps(c, 2, 0.2, policy=BF16_POLICY)(state, batch, SEED + 1)
        torch.cuda.synchronize()
        counts[remat] = _counts()
        stats[remat] = ({k: b.clone() for k, b in state.model.named_buffers()}, start)
        del state
    (plain, start), (rem, _) = stats["none"], stats["blocks"]
    same = sum(torch.equal(plain[k], rem[k]) for k in plain)
    diff = max((plain[k] - rem[k]).abs().max().item() for k in plain)
    # how far each statistic moved from its start, remat over plain: 1 for
    # one update; a second update would move it about twice as far
    moved = [((rem[k] - start[k]).abs().sum() / (plain[k] - start[k]).abs().sum()).item()
             for k in plain if not torch.equal(plain[k], start[k])]
    step_want = _launches(6, 3, 9)

    argv = ["--config=assemble_resnet50", "--data.use_synthetic_data", "--model.remat=blocks",
            f"--train.train_steps={REMAT_STEPS}", f"--train.batch_size={TIME_BATCH}",
            "--train.log_every=1", "--runtime.num_devices=1",
            f"--runtime.model_dir={os.path.join(tmp, 'remat')}"]
    metrics, cli_counts, seconds, peak, records = _run_cli(argv)
    train = [r for r in records if r["tag"] == "train"]
    losses = [r["loss"] for r in train]
    walls = _step_walls(train)
    cli_want = _launches(6 * REMAT_STEPS + 3 * 4, 3 * REMAT_STEPS, 9 * REMAT_STEPS)
    ok = (counts["blocks"] == step_want and counts["none"] == _launches(3, 3, 9)
          and max(abs(r - 1.0) for r in moved) < 0.25
          and [r["step"] for r in train] == list(range(1, REMAT_STEPS + 1))
          and all(np.isfinite(losses)) and cli_counts == cli_want)
    emit("remat", model="assemble_resnet50", remat="blocks", batch=TIME_BATCH, dtype="bf16",
         bn_stats_bit_equal=f"{same}/{len(plain)}", bn_stats_max_abs_diff=diff,
         bn_moved_remat_over_plain={"min": min(moved), "max": max(moved)},
         launches_one_step=counts, expected_one_step=step_want, losses=losses,
         mean_step_ms=float(walls.mean()) * 1e3, step_ms_min=float(walls.min()) * 1e3,
         train_img_per_s=TIME_BATCH / float(walls.mean()),
         max_memory_allocated_gib=peak / 2 ** 30,
         without_remat={"max_memory_allocated_gib": without["peak_gib"],
                        "train_img_per_s": without["img_per_s"]},
         launches=cli_counts, expected=cli_want, seconds=seconds, card=smi, ok=ok)
    if not ok:
        raise AssertionError("remat phase failed")
    return cli_counts


def dp_nccl_phase(smi, tmp, single):
    """The training CLI on two cards, one rank each over NCCL."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("dp_nccl", ran=False, reason=f"{cards} card")
        return
    argv = ["--config=assemble_resnet50", "--data.use_synthetic_data",
            f"--train.train_steps={DP_NCCL_STEPS}", f"--train.batch_size={DP_NCCL_BATCH}",
            "--train.log_every=1", "--runtime.num_devices=2",
            f"--runtime.model_dir={os.path.join(tmp, 'dp_nccl')}"]
    metrics, _, seconds, _, records = _run_cli(argv)
    train = [r for r in records if r["tag"] == "train"]
    losses = [r["loss"] for r in train]
    walls = _step_walls(train)
    total = DP_NCCL_BATCH / float(walls.mean())
    ok = ([r["step"] for r in train] == list(range(1, DP_NCCL_STEPS + 1))
          and all(np.isfinite(losses)) and metrics["count"] == 4 * DP_NCCL_BATCH)
    emit("dp_nccl", ran=True, ranks=2, backend="nccl", cards=cards, batch=DP_NCCL_BATCH,
         batch_per_card=DP_NCCL_BATCH // 2, dtype="bf16", steps=DP_NCCL_STEPS, losses=losses,
         mean_step_ms=float(walls.mean()) * 1e3, step_ms_min=float(walls.min()) * 1e3,
         step_ms=[w * 1e3 for w in walls], img_per_s_total=total, img_per_s_per_card=total / 2,
         single_card_img_per_s=single["img_per_s"],
         per_card_over_single=total / 2 / single["img_per_s"], eval=metrics, seconds=seconds,
         card=smi, ok=ok)
    if not ok:
        raise AssertionError("dp_nccl phase failed")


def _bl_cfg(**changes):
    from axcnn_torch.utils.config import load_preset

    return dataclasses.replace(load_preset("bl_resnet50").model, num_classes=1001, **changes)


def _state_snapshot(state):
    """Copies, on the card, of every tensor a checkpoint holds."""
    return {f: {k: t.detach().clone() for k, t in d.items()}
            for f, d in _state_tensors(state).items()}


class _SaveClock:
    """Wraps ``CheckpointManager`` while a CLI run trains: each save's
    blocking time (the loop's pause: the snapshot), the writer thread's time
    (pickle, write, fsync, rename, retention), and a copy of the state at the
    moment of each save, taken before the save is timed."""

    def __init__(self):
        from axcnn_torch.ckpt.checkpoint import CheckpointManager

        self.cls, self.saves, self.states, self.writer_s = CheckpointManager, [], {}, {}
        self.save, self.write = CheckpointManager.save, CheckpointManager._write_step

    def __enter__(self):
        clock = self

        def save(mgr, state, **kw):
            states = _state_snapshot(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wrote = clock.save(mgr, state, **kw)
            blocking = time.perf_counter() - t0
            if wrote:
                clock.states[int(state.step)] = states
                clock.saves.append({"step": int(state.step), "blocking_s": blocking})
            return wrote

        def write(mgr, step, payload):
            t0 = time.perf_counter()
            clock.write(mgr, step, payload)
            clock.writer_s[step] = time.perf_counter() - t0

        self.cls.save, self.cls._write_step = save, write
        return self

    def __exit__(self, *exc):
        self.cls.save, self.cls._write_step = self.save, self.write


def bl_train_phase(smi, model_dir):
    """``bl_resnet50`` through the training CLI at full width, b128, bf16,
    20 steps, each synthetic batch echoed twice, a save every 5 steps; then
    each checkpoint restored and held bit for bit against the state at its
    step. Returns the path's counts (the preset launches no hand kernel)."""
    from axcnn_torch.ckpt.checkpoint import CheckpointManager
    from axcnn_torch.data.pipeline import EchoIterator
    from axcnn_torch.train import loop
    from axcnn_torch.train.train_step import create_train_state

    class CountingEcho(EchoIterator):
        fresh = 0

        def __next__(self):
            CountingEcho.fresh += self.at_boundary
            return super().__next__()

    argv = ["--config=bl_resnet50", "--data.use_synthetic_data",
            f"--train.train_steps={TRAIN_STEPS}", f"--train.batch_size={TIME_BATCH}",
            "--train.log_every=1", f"--data.echo_factor={BL_ECHO}",
            f"--runtime.save_checkpoint_steps={BL_SAVE_EVERY}", "--runtime.num_devices=1",
            f"--runtime.model_dir={model_dir}"]
    loop.EchoIterator = CountingEcho
    try:
        with _SaveClock() as clock:
            metrics, counts, seconds, peak, records = _run_cli(argv)
    finally:
        loop.EchoIterator = EchoIterator
    train = [r for r in records if r["tag"] == "train"]
    losses = [r["loss"] for r in train]
    walls = _step_walls(train)
    # saves every 5 steps wait for the end of an echo group (even steps)
    want_steps = sorted({s + s % BL_ECHO for s in range(BL_SAVE_EVERY, TRAIN_STEPS + 1,
                                                         BL_SAVE_EVERY)} | {TRAIN_STEPS})
    mgr = CheckpointManager(os.path.join(model_dir, "checkpoints"))
    differ, restored_s = [], []
    for step in want_steps:
        fresh = create_train_state(_bl_cfg(), generator=torch.Generator().manual_seed(SEED + 9),
                                   device="cuda", use_ema=True)
        t0 = time.perf_counter()
        fresh, _, _ = mgr.restore(fresh, step=step)
        torch.cuda.synchronize()
        restored_s.append(time.perf_counter() - t0)
        got = _state_snapshot(fresh)
        for field, want in clock.states[step].items():
            differ += [f"{step}/{field}/{k}" for k, t in want.items()
                       if not torch.equal(got[field][k], t)]
        del fresh, got
    saves = [{**r, "writer_s": clock.writer_s[r["step"]]} for r in clock.saves]
    ok = ([r["step"] for r in train] == list(range(1, TRAIN_STEPS + 1))
          and all(np.isfinite(losses)) and counts == _launches(0, 0, 0)
          and CountingEcho.fresh == TRAIN_STEPS // BL_ECHO
          and [r["step"] for r in saves] == want_steps == mgr.all_steps()
          and all(r["blocking_s"] < r["writer_s"] for r in saves) and not differ
          and metrics["count"] == 4 * TIME_BATCH)
    emit("bl_train", model="bl_resnet50", batch=TIME_BATCH, dtype="bf16", steps=TRAIN_STEPS,
         echo_factor=BL_ECHO, fresh_batches=CountingEcho.fresh, losses=losses,
         step_ms=[w * 1e3 for w in walls], mean_step_ms=float(walls.mean()) * 1e3,
         step_ms_min=float(walls.min()) * 1e3, train_img_per_s=TIME_BATCH / float(walls.mean()),
         max_memory_allocated_gib=peak / 2 ** 30, saves=saves,
         file_mb=os.path.getsize(mgr.path(want_steps[-1])) / 1e6, restore_s=restored_s,
         restored_differ=differ[:5], launches=counts, expected=_launches(0, 0, 0), eval=metrics,
         seconds=seconds, card=smi, ok=ok)
    if not ok:
        raise AssertionError("bl_train phase failed")
    return counts


def bl_serve_phase(smi, model_dir, tmp):
    """``predict`` on the ``bl_train`` run's checkpoint against its restored
    EMA state's own ``eval_logits``; then that model's served img/s at b128
    and latency at b1, bf16."""
    from axcnn_torch.ckpt.checkpoint import CheckpointManager
    from axcnn_torch.cli import predict
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.data.datasets import get_dataset
    from axcnn_torch.data.preprocessing import preprocess_eval
    from axcnn_torch.train.train_step import create_train_state, eval_logits, load_ema

    paths = _write_jpegs(tmp, 8)
    out, err = io.StringIO(), io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = predict.main([*(f"--image={p}" for p in paths), "--config=bl_resnet50",
                           f"--runtime.model_dir={model_dir}"])
    counts = _counts()
    if rc != 0:
        raise AssertionError(f"predict exited {rc}: {err.getvalue()}")
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    state = create_train_state(_bl_cfg(), generator=torch.Generator(), device="cuda",
                               use_ema=True)
    state, _, _ = CheckpointManager(os.path.join(model_dir, "checkpoints")).restore(state)
    u8 = np.stack([preprocess_eval(open(p, "rb").read(), image_size=224, resize_min=256)
                   for p in paths])
    info = get_dataset("imagenet")
    logits = eval_logits(state, torch.from_numpy(u8).cuda(), policy=BF16_POLICY, use_ema=True,
                         mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    want = _predict_lines(logits.cpu().numpy(), paths)
    load_ema(state)  # the model predict serves
    served = _served(state)
    ok = got == want and "random init" not in err.getvalue() and counts == _launches(0, 0, 0)
    emit("bl_serve", model="bl_resnet50", images=len(paths), step=state.step,
         top5_equal=got == want, first=got[0], want_first=want[0], launches=counts,
         served_b128=served[TIME_BATCH], served_b1=served[1], dtype="bf16", card=smi, ok=ok)
    if not ok:
        raise AssertionError("serving the BL checkpoint disagrees with its restored state")
    return counts


def bl_parity_phase():
    """BL-preset logits, card against CPU, from the same seeded weights with
    perturbed BN: fp32 (TF32 off) and bf16, at ``parity``'s bounds."""
    from axcnn_torch.core.dtypes import BF16_POLICY, DEFAULT_POLICY, set_fp32_precision
    from axcnn_torch.data.preprocessing import normalize_device
    from axcnn_torch.models.resnet import ResNet

    set_fp32_precision(DEFAULT_POLICY)
    model = ResNet(_bl_cfg(), generator=torch.Generator().manual_seed(SEED))
    _perturb_bn(model, SEED)
    model.eval()
    u8 = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (2, 224, 224, 3), dtype=np.uint8))
    with torch.inference_mode():
        ref = model(normalize_device(u8)).numpy()
    model.to("cuda", memory_format=torch.channels_last)
    x = normalize_device(u8.cuda())
    with torch.inference_mode():
        fp32 = model(x).cpu().numpy()
        bf16 = model(x, policy=BF16_POLICY).cpu().numpy()
    assert np.isfinite(fp32).all() and np.isfinite(bf16).all()
    rel = lambda a: float(np.linalg.norm(a - ref) / np.linalg.norm(ref))  # noqa: E731
    e32, e16 = rel(fp32), rel(bf16)
    ok = e32 <= 1e-3 and e16 <= 5e-2
    emit("bl_parity", model="bl_resnet50", batch=2, logits_shape=list(fp32.shape),
         ref_norm=float(np.linalg.norm(ref)), fp32_rel_l2=e32, fp32_tol=1e-3, bf16_rel_l2=e16,
         bf16_tol=5e-2, top1_agree_bf16=bool((bf16.argmax(1) == ref.argmax(1)).all()), ok=ok)
    if not ok:
        raise AssertionError("BL card-vs-CPU logits parity failed")


def bl_assembled_phase(smi):
    """One full-width b128 bf16 train step of Big-Little with the
    reference's assembly (ResNet-D, SE, SK as one 5x5 conv, BlurPool sconv,
    DropBlock), DropBlock at keep-prob 0.95: finite loss, and the hand
    kernels' launches and input shapes. BlurPool runs at the stride-2 mid
    conv of stages 2-3's entry and big block0 and of stage 4's block0 (5
    forwards and 5 backwards: 56x56x128, 28x28x128, 28x28x256, 14x14x256,
    14x14x512); DropBlock at stage 3's output (14x14x1024) and after each of
    stage 4's three blocks (7x7x2048): 4 fused launches and 4 apply
    backwards."""
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.train.train_step import create_train_state

    cfg = _bl_cfg(use_se_block=True, use_sk_block=True, sk_merged_conv=True,
                  anti_alias_type="sconv", use_dropblock=True)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(SEED),
                               device="cuda")
    state.step = 1  # step 1 of 2: keep-prob 0.95, DropBlock drops
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"images": torch.randint(0, 256, (TIME_BATCH, 224, 224, 3), generator=gen,
                                     device="cuda", dtype=torch.uint8),
             "labels": torch.randint(0, 1001, (TIME_BATCH,), generator=gen, device="cuda")}
    shapes = {"blur_fwd": [], "fused": []}
    blur, fused = kblur.blur_pool_cuda, kdrop.dropblock_fused_cuda

    def blur_rec(x, **kw):
        n, c, h, w = x.shape
        shapes["blur_fwd"].append([n, h, w, c])
        return blur(x, **kw)

    def fused_rec(x, *a):
        n, c, h, w = x.shape
        shapes["fused"].append([n, h, w, c])
        return fused(x, *a)

    kblur.blur_pool_cuda, kdrop.dropblock_fused_cuda = blur_rec, fused_rec
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        state, metrics = _dp_steps(cfg, 2, 0.2, policy=BF16_POLICY)(state, batch, SEED + 1)
        loss = metrics["loss"].item()
        seconds = time.perf_counter() - t0
        counts = _counts()
        routes = dict(kblur.ROUTES)
    finally:
        kblur.blur_pool_cuda, kdrop.dropblock_fused_cuda = blur, fused
    want = _launches(5, 5, 4)
    want_shapes = {"blur_fwd": [[TIME_BATCH, 56, 56, 128], [TIME_BATCH, 28, 28, 128],
                                [TIME_BATCH, 28, 28, 256], [TIME_BATCH, 14, 14, 256],
                                [TIME_BATCH, 14, 14, 512]],
                   "fused": [[TIME_BATCH, 14, 14, 1024]] + [[TIME_BATCH, 7, 7, 2048]] * 3}
    ok = (np.isfinite(loss) and counts == want and shapes == want_shapes
          and routes["fwd_thread"] == routes["bwd_thread"] == routes["general"] == 0)
    emit("bl_assembled", model="bl_resnet50 + resnet_d, se, sk (merged 5x5), sconv, dropblock",
         batch=TIME_BATCH, dtype="bf16", loss=loss, first_step_s=seconds,
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=counts, expected=want, shapes_nhwc=shapes, expected_shapes=want_shapes,
         routes=routes, card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"bl_assembled launched {counts} at {shapes}, expected {want} "
                             f"at {want_shapes}")
    return counts


def blur_sizes_phase():
    """BlurPool's general route (filter sizes 1-7 but 3, and 3 at stride 1:
    cuDNN's depthwise conv) on the card against its plain version on the
    card, forward for fp32 and bf16 maps of odd and even extents and the
    fp32 gradient against autograd through the plain version; the (3, 2)
    call must still take the kernel. Tolerance: fp32 max abs error <= 1e-6
    of the largest output; bf16 within one bf16 ulp of the plain value."""
    from axcnn_torch.ops.blurpool import blur_pool, blur_pool_general_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases, worst = [], {"fp32": 0.0, "bf16_ulps": 0.0, "fp32_grad": 0.0}
    for fs, stride in [(f, 2) for f in range(1, 8)] + [(3, 1)]:
        for shape in BLUR_SIZE_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                x = _nchw_input(shape, dtype, gen).detach().requires_grad_(dtype == torch.float32)
                before = dict(kblur.ROUTES)
                got = blur_pool(x, stride=stride, filter_size=fs)
                new = {k: v - before[k] for k, v in kblur.ROUTES.items() if v != before[k]}
                want = blur_pool_general_reference(x.detach(), stride=stride, filter_size=fs)
                kernel = "fwd_tma" if _tma_legal(shape[3], dtype) else "fwd_thread"
                routes_ok = new == ({kernel: 1} if (fs, stride) == (3, 2) else {"general": 1})
                diff = (got.detach().float() - want.float()).abs()
                if dtype == torch.float32:
                    err = diff.max().item() / want.abs().max().item()
                    g = torch.randn(got.shape, generator=gen, device="cuda")
                    (dx,) = torch.autograd.grad(got, x, g)
                    x2 = x.detach().clone().requires_grad_()
                    (dx2,) = torch.autograd.grad(
                        blur_pool_general_reference(x2, stride=stride, filter_size=fs), x2, g)
                    gerr = (dx - dx2).abs().max().item() / dx2.abs().max().item()
                    ok = err <= 1e-6 and gerr <= 1e-6
                    worst["fp32"], worst["fp32_grad"] = (max(worst["fp32"], err),
                                                         max(worst["fp32_grad"], gerr))
                else:
                    err = (diff / _bf16_ulp(want)).max().item()
                    ok = err <= 1.0
                    worst["bf16_ulps"] = max(worst["bf16_ulps"], err)
                ok = ok and routes_ok and got.shape == want.shape
                cases.append(ok)
                if not ok:
                    emit("blur_sizes_case", filter_size=fs, stride=stride, shape=list(shape),
                         dtype=str(dtype), err=err, routes=new, ok=False)
    ok = all(cases)
    emit("blur_sizes", filter_sizes=list(range(1, 8)), shapes_nhwc=BLUR_SIZE_SHAPES,
         cases=len(cases), failed=cases.count(False), worst=worst,
         tolerance={"fp32": 1e-6, "fp32_grad": 1e-6, "bf16_ulps": 1.0},
         kernel_route_for_3_2="the kernel (fwd_tma or fwd_thread by C)", ok=ok)
    if not ok:
        raise AssertionError("BlurPool's general route disagrees with its plain version")


# ---------------------------------------------------------------------------
# device AutoAugment, int8 serving, the serving export, ImageNet-C
# ---------------------------------------------------------------------------

def _write_records(directory, split, count, seed, *, shards=1, size=256, labels=None):
    """``count`` seeded JPEGs of ``size``^2 (gradients, stripes and noise) in
    ``shards`` TFRecord shards ``<split>-*`` of the port's writer; labels
    ``labels[i]`` or seeded in [0, 1001)."""
    from PIL import Image

    from axcnn_torch.data.tfrecord import TFRecordWriter, make_example

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    per = -(-count // shards)
    for s in range(shards):
        with TFRecordWriter(os.path.join(directory, f"{split}-{s:05d}-of-{shards:05d}")) as w:
            for i in range(s * per, min(count, (s + 1) * per)):
                a, b, p = rng.uniform(0.2, 1.0, 3)
                base = np.stack([yy * a, xx * b, ((yy + xx) // max(int(p * 16), 2)) % 2 * 200],
                                -1) * 255 / size
                img = np.clip(base + rng.integers(0, 48, base.shape), 0, 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "JPEG", quality=90)
                label = int(rng.integers(0, 1001))  # drawn either way: the same images
                if labels is not None:
                    label = int(labels[i])
                w.write(make_example({"image/encoded": [buf.getvalue()],
                                      "image/class/label": [label]}))


def _timed_prefetch(waits):
    """``loop.device_prefetch`` whose iterators record how long the loop
    waits for each batch (one list a call: the train stream, then the
    eval's)."""
    from axcnn_torch.train import loop

    make = loop.device_prefetch

    class Timed:
        def __init__(self, it, times):
            self._it, self._times = it, times

        def __iter__(self):
            return self

        def __next__(self):
            t0 = time.perf_counter()
            batch = next(self._it)
            self._times.append(time.perf_counter() - t0)
            return batch

        def __getattr__(self, name):
            return getattr(self._it, name)

    def timed(*args, **kwargs):
        waits.append([])
        return Timed(make(*args, **kwargs), waits[-1])

    return timed


def aa_parity_phase():
    """Each device AutoAugment op on the card against the same op on the CPU,
    same inputs, magnitudes and signs, on integer images (an op's first
    input) and on fractional ones (a second op's): the integer ops, Equalize
    and AutoContrast bit for bit, the warps and enhances within 1e-4 on the
    [0, 255] scale; then the applicator on a b128 batch with the same draws,
    within 1e-4."""
    from axcnn_torch.data.autoaugment import POLICIES
    from axcnn_torch.data.autoaugment_device import (OP_FNS, draw_autoaugment,
                                                     make_device_autoaugment)

    exact = {"Posterize", "Solarize", "SolarizeAdd", "Invert", "Equalize", "AutoContrast",
             "Cutout"}
    rng = np.random.default_rng(SEED)
    ints = rng.integers(0, 256, (8, 224, 224, 3)).astype(np.float32)
    inputs = {"integer": ints,
              "fractional": np.clip(ints * 0.7 + rng.random(ints.shape, np.float32) * 60,
                                    0, 255).astype(np.float32)}
    signs = np.where(rng.random(8) < 0.5, -1.0, 1.0).astype(np.float32)
    worst, bad = {}, []
    for name, op in OP_FNS.items():
        for kind, imgs in inputs.items():
            for mag in (2, 7, 10):
                got = op(torch.from_numpy(imgs).cuda(), mag, signs).cpu()
                want = op(torch.from_numpy(imgs), mag, signs)
                err = (got - want).abs().max().item()
                worst[name] = max(worst.get(name, 0.0), err)
                if err > (0.0 if name in exact else 1e-4):
                    bad.append((name, kind, mag, err))
    u8 = torch.from_numpy(rng.integers(0, 256, (TIME_BATCH, 224, 224, 3), dtype=np.uint8))
    fn = make_device_autoaugment("v0", num_groups=8)
    draws = draw_autoaugment(np.random.default_rng(SEED + 1), len(POLICIES["v0"]), 8,
                             TIME_BATCH // 8)
    got = fn(u8.cuda(), draws=draws).cpu()
    want = fn(u8, draws=draws)
    batch_err = (got - want).abs().max().item()
    changed = float((want != u8.float()).any(dim=(1, 2, 3)).float().mean())
    ok = not bad and batch_err <= 1e-4 and changed > 0
    emit("aa_parity", ops=len(OP_FNS), exact_ops=sorted(exact), tolerance=1e-4,
         max_abs_err_by_op=worst, failed=bad[:5], batch_max_abs_err=batch_err,
         batch_images_changed=changed, ok=ok)
    if not ok:
        raise AssertionError(f"device AutoAugment card-vs-CPU parity failed: {bad[:5]}")


def _aa_ms(batch, image):
    """The augmentation alone (v0, 8 groups) on a ``batch`` x ``image``^2
    uint8 batch on the card: device ms per call (events, the calls queued
    behind a sleep kernel, 20 draws) and the host's enqueue ms per call."""
    from axcnn_torch.data.autoaugment import POLICIES
    from axcnn_torch.data.autoaugment_device import draw_autoaugment, make_device_autoaugment

    fn = make_device_autoaugment("v0", num_groups=8)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    u8 = torch.randint(0, 256, (batch, image, image, 3), generator=gen, device="cuda",
                       dtype=torch.uint8)
    rng = np.random.default_rng(SEED)
    draws = [draw_autoaugment(rng, len(POLICIES["v0"]), 8, batch // 8) for _ in range(20)]
    device_ms = _time_ms(lambda d: fn(u8, draws=d), draws, iters=20)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for d in draws:
        fn(u8, draws=d)
    enqueue_ms = (time.perf_counter() - t0) / len(draws) * 1e3
    torch.cuda.synchronize()
    return {"device_ms": device_ms, "enqueue_ms": enqueue_ms}


def aa_time_phase(smi):
    """The augmentation alone on a b128 224^2 batch (``_aa_ms``)."""
    times = _aa_ms(TIME_BATCH, 224)
    emit("aa_time", policy="v0", groups=8, batch=TIME_BATCH, image=224, **times, card=smi)
    return times


def aa_train_phase(smi, tmp, aa_time):
    """The training CLI on TFRecords of 256^2 JPEGs (written here with the
    port's writer), full width, b128, bf16, AA_STEPS steps, with AutoAugment
    v0 on the card, then the same run with it in the loader (host PIL): the
    step walls, the loop's wait for each batch, peak memory, and the kernel
    launches of the device-AA run per step."""
    from axcnn_torch.train import loop

    data_dir = os.path.join(tmp, "aa_records")
    _write_records(data_dir, "train", AA_IMAGES, SEED, shards=4)
    _write_records(data_dir, "validation", TIME_BATCH, SEED + 1)
    runs = {}
    for where in ("device", "host"):
        argv = ["--config=assemble_resnet50", f"--data.data_dir={data_dir}",
                "--data.dataset_name=custom", "--data.num_classes=1001",
                f"--data.num_train_examples={AA_IMAGES}",
                f"--data.num_eval_examples={TIME_BATCH}", "--data.autoaugment_type=v0",
                f"--data.autoaugment_device={str(where == 'device').lower()}",
                f"--train.train_steps={AA_STEPS}", f"--train.batch_size={TIME_BATCH}",
                "--train.log_every=1", "--runtime.num_devices=1",
                f"--runtime.model_dir={os.path.join(tmp, 'aa_' + where)}"]
        waits = []
        with mock.patch.object(loop, "device_prefetch", _timed_prefetch(waits)):
            metrics, counts, seconds, peak, records = _run_cli(argv)
        train = [r for r in records if r["tag"] == "train"]
        losses = [r["loss"] for r in train]
        walls = _step_walls(train)
        assert [r["step"] for r in train] == list(range(1, AA_STEPS + 1)), records
        assert all(np.isfinite(losses)), losses
        assert metrics["count"] == TIME_BATCH, metrics
        train_waits = np.array(waits[0][1:]) * 1e3  # after the first batch's warm-up
        runs[where] = dict(
            counts=counts, mean_step_ms=float(walls.mean()) * 1e3,
            step_ms_min=float(walls.min()) * 1e3, step_ms_max=float(walls.max()) * 1e3,
            train_img_per_s=TIME_BATCH / float(walls.mean()),
            loader_wait_ms_mean=float(train_waits.mean()),
            loader_wait_ms_max=float(train_waits.max()),
            first_batch_wait_s=waits[0][0], max_memory_allocated_gib=peak / 2 ** 30,
            first_loss=losses[0], last_loss=losses[-1], seconds=seconds)
    want = _launches(3 * AA_STEPS + 3, 3 * AA_STEPS, 9 * AA_STEPS)
    got = runs["device"]["counts"]
    ok = got == want and runs["host"]["counts"] == want
    emit("aa_train", model="assemble_resnet50", batch=TIME_BATCH, dtype="bf16",
         steps=AA_STEPS, images=AA_IMAGES, jpeg=256, policy="v0",
         launches_per_step={k: v / AA_STEPS for k, v in got.items()}, launches=got,
         expected=want, device_aa=runs["device"], host_aa=runs["host"],
         aa_device_ms=aa_time["device_ms"], aa_enqueue_ms=aa_time["enqueue_ms"],
         card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"aa_train launches {got}, expected {want}")
    return got


def _seeded_model():
    """The parity phase's seeded full-width assembled R50 with perturbed BN,
    on the card, channels_last, in eval mode."""
    from axcnn_torch.models.resnet import ResNet

    model = ResNet(_assembled_cfg(), generator=torch.Generator().manual_seed(SEED))
    _perturb_bn(model, SEED)
    return model.to("cuda", memory_format=torch.channels_last).eval()


def int8_check_phase():
    """Every int8 conv of an R50 forward at b128 (the seeded model, int8
    policy): the card's ``torch._int_mm`` route against the plain version
    (float64 ``F.conv2d`` on the card) on the same int8 operands, bit for bit
    on the int32 accumulators, once for each distinct shape."""
    from axcnn_torch.core.dtypes import INT8_SERVING_POLICY
    from axcnn_torch.data.preprocessing import normalize_device
    from axcnn_torch.ops import conv as kconv

    model = _seeded_model()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    u8 = torch.randint(0, 256, (TIME_BATCH, 224, 224, 3), generator=gen, device="cuda",
                       dtype=torch.uint8)
    route = kconv.int8_conv_acc_cuda
    shapes, calls = {}, [0]

    def checked(xq, wq, *, stride, dilation, padding):
        acc = route(xq, wq, stride=stride, dilation=dilation, padding=padding)
        calls[0] += 1
        key = (tuple(xq.shape), tuple(wq.shape), stride, dilation, padding)
        if key not in shapes:
            want = kconv.int8_conv_acc_reference(xq, wq, stride=stride, dilation=dilation,
                                                 padding=padding)
            shapes[key] = int((acc.long() - want.long()).abs().max().item())
        return acc

    with mock.patch.object(kconv, "int8_conv_acc_cuda", checked), torch.inference_mode():
        logits = model(normalize_device(u8), policy=INT8_SERVING_POLICY)
    torch.cuda.synchronize()
    worst = max(shapes.values())
    ks = {w[1] * w[2] * w[3] for _, w, *_ in shapes}
    # why the route builds its own patch matrix: does F.unfold take int8 here?
    try:
        torch.nn.functional.unfold(torch.zeros((1, 8, 4, 4), dtype=torch.int8, device="cuda"), 3)
        unfold_int8 = "ran"
    except (RuntimeError, NotImplementedError) as e:
        unfold_int8 = str(e).splitlines()[0][:160]
    ok = (worst == 0 and bool(torch.isfinite(logits).all()) and 27 in ks
          and any(k[2] == 2 for k in shapes) and any(k[3] == 2 for k in shapes))
    emit("int8_check", batch=TIME_BATCH, convs=calls[0], distinct_shapes=len(shapes),
         stride2=sum(k[2] == 2 for k in shapes), dilation2=sum(k[3] == 2 for k in shapes),
         k27=27 in ks, max_abs_err=worst, tolerance=0, f_unfold_int8_cuda=unfold_int8,
         shapes=[{"x": list(k[0]), "w": list(k[1]), "stride": k[2], "dilation": k[3],
                  "err": e} for k, e in shapes.items()], ok=ok)
    if not ok:
        raise AssertionError("the int8 conv route disagrees with its plain version")
    return worst


def int8_serve_phase(smi):
    """The seeded model served under int8 beside bf16 (img/s at b128 and b1),
    and the int8 logits against the fp32 ones (TF32 off) on the phase's b128
    images: relative L2, top-1 agreement; one int8 forward's launches."""
    from axcnn_torch.core.dtypes import (BF16_POLICY, DEFAULT_POLICY, INT8_SERVING_POLICY,
                                         set_fp32_precision)
    from axcnn_torch.ops import conv as kconv
    from axcnn_torch.train.train_step import TrainState, eval_logits

    state = TrainState(model=_seeded_model(), ema=None)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    u8 = torch.randint(0, 256, (TIME_BATCH, 224, 224, 3), generator=gen, device="cuda",
                       dtype=torch.uint8)
    set_fp32_precision(DEFAULT_POLICY)
    fp32 = eval_logits(state, u8, policy=DEFAULT_POLICY)
    _zero_counts()
    mm0 = kconv.INT8_MM_CALLS
    int8 = eval_logits(state, u8, policy=INT8_SERVING_POLICY)
    torch.cuda.synchronize()
    counts, mm = _counts(), kconv.INT8_MM_CALLS - mm0
    rel = float((int8 - fp32).norm() / fp32.norm())
    agree = float((int8.argmax(-1) == fp32.argmax(-1)).float().mean())
    served = {"int8": _served(state, INT8_SERVING_POLICY), "bf16": _served(state, BF16_POLICY)}
    ok = (counts == _launches(3, 0, 0) and mm == INT8_CONVS and rel < 0.05
          and bool(torch.isfinite(int8).all()))
    emit("int8_serve", model="assemble_resnet50", rel_l2_to_fp32=rel, rel_l2_bound=0.05,
         top1_agreement=agree, launches=counts, int8_mm_calls=mm,
         served={p: {str(b): v for b, v in r.items()} for p, r in served.items()},
         card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"int8 serving failed: rel {rel}, launches {counts}, mm {mm}")
    return counts, served


def _predict(argv):
    from axcnn_torch.cli import predict

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = predict.main(argv)
    if rc != 0:
        raise AssertionError(f"predict exited {rc}: {err.getvalue()}")
    return [json.loads(line) for line in out.getvalue().splitlines()]


def export_phase(smi, model_dir, tmp):
    """The ``train`` run's EMA exported on the card in bf16 and int8 at
    b128 (bf16 also at b1), each reloaded with ``load_serving``: its logits
    bit for bit those of the direct forward on the same input, the BlurPool
    kernel launched 3 times (TMA route) by a reloaded forward, served img/s;
    then ``predict --export`` against ``predict`` from the checkpoint on 128
    JPEGs (the export's batch, so neither pads)."""
    from axcnn_torch.ckpt.checkpoint import CheckpointManager, model_from_payload
    from axcnn_torch.ckpt.export import export_serving, load_serving
    from axcnn_torch.core.dtypes import BF16_POLICY, INT8_SERVING_POLICY
    from axcnn_torch.data.datasets import get_dataset
    from axcnn_torch.data.preprocessing import normalize_device

    info = get_dataset("imagenet")
    cfg = _assembled_cfg()
    raw = CheckpointManager(os.path.join(model_dir, "checkpoints")).load(device="cuda")
    model = model_from_payload(raw, cfg, device="cuda", use_ema=True, where="train run")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    results, dirs, counts = {}, {}, None
    for name, policy, batches in (("bf16", BF16_POLICY, (TIME_BATCH, 1)),
                                  ("int8", INT8_SERVING_POLICY, (TIME_BATCH,))):
        for batch in batches:
            d = dirs[name, batch] = os.path.join(tmp, f"export_{name}_{batch}")
            t0 = time.perf_counter()
            export_serving(d, cfg, model, batch_size=batch, image_size=224, policy=policy,
                           mean=info.mean_rgb, std=info.stddev_rgb)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fn, meta = load_serving(d)
            load_s = time.perf_counter() - t0
            u8 = torch.randint(0, 256, (batch, 224, 224, 3), generator=gen, device="cuda",
                               dtype=torch.uint8)
            _zero_counts()
            tma0 = kblur.ROUTES["fwd_tma"]
            got = fn(u8)
            torch.cuda.synchronize()
            tma = kblur.ROUTES["fwd_tma"] - tma0
            if (name, batch) == ("bf16", TIME_BATCH):
                counts = _counts()
            with torch.inference_mode():
                want = model(normalize_device(u8, info.mean_rgb, info.stddev_rgb),
                             policy=policy)
            iters = 20 if batch > 1 else 50
            for _ in range(3):
                fn(u8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(u8)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
            results[f"{name}_b{batch}"] = dict(
                equal=bool(torch.equal(got, want)),
                max_abs_diff=float((got - want).abs().max()), blur_fwd_tma_launches=tma,
                img_per_s=batch / dt, ms_per_batch=dt * 1e3, export_s=export_s,
                load_s=load_s, pt2_mb=os.path.getsize(os.path.join(d, "serving.pt2")) / 1e6,
                quantized_int8=meta["quantized_int8"])
    paths = _write_jpegs(tmp, TIME_BATCH)
    images = [f"--image={p}" for p in paths]
    ckpt_args = ["--config=assemble_resnet50", f"--runtime.model_dir={model_dir}"]
    top5 = {}
    for name in ("bf16", "int8"):
        from_export = _predict([*images, f"--export={dirs[name, TIME_BATCH]}"])
        from_ckpt = _predict([*images, *ckpt_args, f"--train.dtype={name}"])
        top5[name] = {"equal": from_export == from_ckpt,
                      "first": from_export[0], "ckpt_first": from_ckpt[0]}
    ok = (all(r["equal"] and r["blur_fwd_tma_launches"] == 3 for r in results.values())
          and all(t["equal"] for t in top5.values()))
    emit("export", model="assemble_resnet50", weights="train run EMA", results=results,
         predict_top5=top5, card=smi, ok=ok)
    if not ok:
        raise AssertionError("the reloaded export disagrees with the direct forward")
    return counts


def mce_phase(smi, model_dir, tmp):
    """ImageNet-C end to end: MCE_IMAGES clean 256^2 JPEGs labelled with the
    ``train`` run's own fp32 predictions, ``build_imagenet_c`` for all 15
    corruptions at MCE_SEVERITIES, then ``main_classification
    --runtime.eval_imagenet_c`` on the card (fp32, TF32 off) from that run's
    checkpoint: the mce line equals ``compute_mce`` of the per-set lines,
    and each set's top-1 equals the port's on the CPU (fp32) on the same
    shards."""
    from axcnn_torch.ckpt.checkpoint import CheckpointManager, model_from_payload
    from axcnn_torch.cli import main_classification
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, set_fp32_precision
    from axcnn_torch.data.build_imagenet_c import build_corrupted_set
    from axcnn_torch.data.datasets import get_dataset
    from axcnn_torch.data.preprocessing import normalize_device, preprocess_eval
    from axcnn_torch.data.tfrecord import TFRecordReader, list_shards, parse_example
    from axcnn_torch.eval.imagenet_c import CORRUPTIONS, compute_mce

    t_start = time.perf_counter()
    info = get_dataset("imagenet_c")
    clean = os.path.join(tmp, "mce_clean")
    _write_records(clean, "validation", MCE_IMAGES, SEED + 5, shards=2)
    # labels: the model's own predictions on the clean pixels (the records
    # hold head indices), so top-1 on the corrupted sets is not 0
    u8 = np.stack([preprocess_eval(bytes(parse_example(p)["image/encoded"][0]))
                   for shard in list_shards(clean, "validation") for p in TFRecordReader(shard)])
    raw = CheckpointManager(os.path.join(model_dir, "checkpoints")).load(device="cuda")
    model = model_from_payload(raw, _assembled_cfg(), device="cuda", use_ema=True, where="x")
    set_fp32_precision(DEFAULT_POLICY)
    with torch.inference_mode():
        preds = model(normalize_device(torch.from_numpy(u8).cuda(), info.mean_rgb,
                                       info.stddev_rgb)).argmax(-1).cpu().numpy()
    _write_records(clean, "validation", MCE_IMAGES, SEED + 5, shards=2,
                   labels=preds)
    corrupted = os.path.join(tmp, "mce_c")
    t0 = time.perf_counter()
    build_corrupted_set(clean, corrupted, severities=MCE_SEVERITIES,
                        progress=lambda _: None)
    build_s = time.perf_counter() - t0
    common = ["--config=assemble_resnet50", f"--data.data_dir={corrupted}",
              "--runtime.eval_imagenet_c=true", f"--train.batch_size={MCE_IMAGES}",
              "--train.dtype=fp32", "--data.num_workers=2"]
    runs = {}
    for where, extra in (("card", ["--runtime.num_devices=1"]),
                         ("cpu", ["--runtime.platform=cpu"])):
        run_dir = os.path.join(tmp, f"mce_{where}")
        argv = [*common, *extra, f"--runtime.model_dir={run_dir}",
                f"--train.pretrained_checkpoint={model_dir}/checkpoints",
                "--train.warm_start_exclude_head=false"]
        _zero_counts()
        t0 = time.perf_counter()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            result = main_classification.main(argv)
        seconds = time.perf_counter() - t0
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        sets = {(r["corruption"], r["severity"]): r["top1"]
                for r in records if r["tag"] == "imagenet_c"}
        mce_line = [r for r in records if r["tag"] == "mce"][-1]
        runs[where] = dict(result=result, sets=sets, mce_line=mce_line, seconds=seconds,
                           counts=_counts())
    card = runs["card"]
    errs = {c: np.mean([1.0 - card["sets"][c, s] / 100.0 for s in MCE_SEVERITIES])
            for c in CORRUPTIONS}
    recomputed = compute_mce(errs)
    line_ok = all(abs(card["mce_line"][k] - v) <= 1e-9 * max(1.0, abs(v))
                  for k, v in recomputed.items())
    sets_equal = card["sets"] == runs["cpu"]["sets"]
    n_sets = len(CORRUPTIONS) * len(MCE_SEVERITIES)
    top1_mean = float(np.mean(list(card["sets"].values())))
    ok = (line_ok and sets_equal and len(card["sets"]) == n_sets and top1_mean > 0
          and card["counts"]["fwd"] == 3 * n_sets)
    emit("mce", model="assemble_resnet50", images=MCE_IMAGES, severities=list(MCE_SEVERITIES),
         sets=n_sets, mce=card["result"]["mce"], mce_cpu=runs["cpu"]["result"]["mce"],
         mce_line_equals_compute_mce=line_ok, top1_card_equals_cpu=sets_equal,
         top1_mean=top1_mean, build_s=build_s,
         card_s=card["seconds"], cpu_s=runs["cpu"]["seconds"], launches=card["counts"],
         phase_s=time.perf_counter() - t_start, card_name=smi, ok=ok)
    if not ok:
        raise AssertionError("the mCE phase failed")
    return card["counts"]


def _proto_field(out, number, value):
    """Append protobuf field ``number``: a varint for an int, else bytes."""
    from axcnn_torch.data.tfrecord import _write_varint

    if isinstance(value, int):
        _write_varint(out, number << 3)
        _write_varint(out, value)
    else:
        _write_varint(out, number << 3 | 2)
        _write_varint(out, len(value))
        out.extend(value)


def _table_bytes(entries):
    """A LevelDB-style table of ``entries`` (sorted ``(key, value)`` bytes),
    as TF writes a bundle's index: one uncompressed data block (keys
    prefix-compressed, a restart every 16 entries), an empty metaindex block,
    an index block holding the data block's handle under its last key, each
    block followed by its type byte and masked CRC32C, then the 48-byte
    footer. Scaffolding for ``tf_import`` and the tests, not a package
    feature."""
    from axcnn_torch.ckpt.tf_bundle import TABLE_MAGIC
    from axcnn_torch.data.tfrecord import _write_varint, masked_crc32c

    def block(items):
        out, restarts, prev = bytearray(), [], b""
        for i, (key, value) in enumerate(items):
            shared = 0
            if i % 16:
                while shared < min(len(prev), len(key)) and prev[shared] == key[shared]:
                    shared += 1
            else:
                restarts.append(len(out))
            for n in (shared, len(key) - shared, len(value)):
                _write_varint(out, n)
            out += key[shared:] + value
            prev = key
        restarts = restarts or [0]
        return bytes(out) + struct.pack(f"<{len(restarts) + 1}I", *restarts, len(restarts))

    table = bytearray()

    def put(contents):
        handle = bytearray()
        _write_varint(handle, len(table))
        _write_varint(handle, len(contents))
        table.extend(contents + b"\0" + struct.pack("<I", masked_crc32c(contents + b"\0")))
        return bytes(handle)

    data = put(block(entries))
    meta = put(block([]))
    index = put(block([(entries[-1][0], data)]))
    return bytes(table) + (meta + index).ljust(40, b"\0") + struct.pack("<Q", TABLE_MAGIC)


def _write_tf_bundle(prefix, tensors, *, shards=TF_SHARDS, header=None):
    """``tensors`` ({name: float32 or int64 array}) as TF's V2 checkpoint
    bundle: ``<prefix>.index`` and ``shards`` data files, the tensors dealt
    to the shards in name order, each with its masked CRC32C. ``header``
    replaces the ``BundleHeaderProto`` bytes (tests). Scaffolding for
    ``tf_import`` and the tests, not a package feature."""
    from axcnn_torch.data.tfrecord import masked_crc32c

    dtypes = {np.dtype(np.float32): 1, np.dtype(np.int64): 9}
    if header is None:
        header = bytearray()
        _proto_field(header, 1, shards)  # num_shards; endianness 0: little
        _proto_field(header, 3, bytes([0x08, 0x01]))  # version {producer: 1}
    entries = [(b"", bytes(header))]
    files = [open(f"{prefix}.data-{s:05d}-of-{shards:05d}", "wb") for s in range(shards)]
    try:
        for i, name in enumerate(sorted(tensors, key=str.encode)):
            a = np.ascontiguousarray(tensors[name])
            data = a.astype(a.dtype.newbyteorder("<")).tobytes()
            shard, f = i % shards, files[i % shards]
            shape = bytearray()
            for d in a.shape:
                dim = bytearray()
                _proto_field(dim, 1, d)
                _proto_field(shape, 2, bytes(dim))
            entry = bytearray()
            _proto_field(entry, 1, dtypes[a.dtype])
            _proto_field(entry, 2, bytes(shape))
            _proto_field(entry, 3, shard)
            _proto_field(entry, 4, f.tell())
            _proto_field(entry, 5, len(data))
            entry += b"\x35" + struct.pack("<I", masked_crc32c(data))  # 6: fixed32
            f.write(data)
            entries.append((name.encode(), bytes(entry)))
    finally:
        for f in files:
            f.close()
    with open(prefix + ".index", "wb") as f:
        f.write(_table_bytes(entries))


def _tf_values(cfg, seed):
    """Seeded values, in TF's layouts, for every variable of ``cfg``'s model
    under its TF-official name (He-scaled kernels, BN scales in [0.5, 1.5],
    bn3's in [0.1, 0.3]), an EMA shadow of each trainable one that differs
    from it, its ``Momentum`` slot, and ``global_step`` (int64): what a
    reference ``Saver`` checkpoint holds."""
    from axcnn_torch.ckpt.tf_import import EMA_SUFFIX, expected_tf_names

    rng = np.random.default_rng(seed)
    out = {"global_step": np.array(TF_GLOBAL_STEP, np.int64)}
    for tf_name, key, shape in expected_tf_names(cfg):
        leaf = tf_name.rsplit("/", 1)[1]
        if leaf == "kernel":
            v = rng.standard_normal(shape, np.float32) * np.float32(
                (2.0 / np.prod(shape[:-1])) ** 0.5)
        elif leaf == "gamma":
            lo, hi = (0.1, 0.3) if key.endswith("bn3.weight") else (0.5, 1.5)
            v = rng.uniform(lo, hi, shape).astype(np.float32)
        elif leaf == "moving_variance":
            v = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:  # beta, moving_mean, bias
            v = 0.1 * rng.standard_normal(shape, np.float32)
        out[tf_name] = v
        if not leaf.startswith("moving_"):
            out[tf_name + EMA_SUFFIX] = v * np.float32(0.98) + np.float32(0.01) * np.sign(v)
            out[tf_name + "/Momentum"] = 0.01 * rng.standard_normal(shape, np.float32)
    return out


def tf_import_phase(smi, import_dir, tmp):
    """A reference TF1 checkpoint to the port's serving and fine-tuning: a
    full-width ``assemble_resnet50`` bundle (1001 classes) written under
    TF-official names (``_write_tf_bundle``: TF_SHARDS data shards, EMA
    shadows, Momentum slots, ``global_step``) is imported on the host with
    and without ``use_ema``: every tensor equal to what was written, bit for
    bit. The EMA import, loaded into a channels_last model on the card, gives
    b128 bf16 logits bit for bit those of a model that took the same tensors
    through ``load_weights``, with 3 BlurPool launches a forward. Saved as a
    port checkpoint (the raw import as the parameters, the EMA import as the
    EMA) in ``import_dir``, it serves through ``predict``
    (``serve_ckpt_phase``)."""
    from axcnn_torch.ckpt.checkpoint import CheckpointManager, load_weights
    from axcnn_torch.ckpt.convert import _to_torch_layout
    from axcnn_torch.ckpt.tf_import import EMA_SUFFIX, expected_tf_names, import_tf_checkpoint
    from axcnn_torch.core.dtypes import BF16_POLICY
    from axcnn_torch.data.datasets import get_dataset
    from axcnn_torch.data.preprocessing import normalize_device
    from axcnn_torch.models.resnet import ResNet
    from axcnn_torch.train.ema import ema_init
    from axcnn_torch.train.optimizer import momentum_init
    from axcnn_torch.train.train_step import TrainState

    t_start = time.perf_counter()
    cfg = _assembled_cfg()
    values = _tf_values(cfg, SEED + 11)
    bundle = os.path.join(tmp, "tf_ckpt")
    os.makedirs(bundle, exist_ok=True)
    prefix = os.path.join(bundle, f"model.ckpt-{TF_GLOBAL_STEP}")
    t0 = time.perf_counter()
    _write_tf_bundle(prefix, values)
    write_s = time.perf_counter() - t0
    with open(os.path.join(bundle, "checkpoint"), "w") as f:
        f.write(f'model_checkpoint_path: "{os.path.basename(prefix)}"\n')
    with torch.device("meta"):
        template = ResNet(cfg).state_dict()
    names = expected_tf_names(cfg)

    def empty_model():
        with torch.device("meta"):
            model = ResNet(cfg)
        return model.to_empty(device="cuda").to(memory_format=torch.channels_last).eval()

    imports, exact = {}, {}
    for use_ema in (False, True):
        host = {k: torch.empty(v.shape) for k, v in template.items()}
        t0 = time.perf_counter()
        sd, missing = import_tf_checkpoint(bundle, cfg, host, use_ema=use_ema)
        seconds = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in sd.values())
        exact[use_ema] = not missing and all(
            torch.equal(sd[key], torch.from_numpy(np.ascontiguousarray(_to_torch_layout(
                values[tf_name + EMA_SUFFIX if use_ema and tf_name + EMA_SUFFIX in values
                       else tf_name]))))
            for tf_name, key, _ in names)
        imports[use_ema] = (sd, seconds, nbytes)
    raw_sd, ema_sd = imports[False][0], imports[True][0]
    ema_differs = any(not torch.equal(raw_sd[k], ema_sd[k]) for k in raw_sd)

    info = get_dataset("imagenet")
    direct, through = empty_model(), empty_model()
    direct.load_state_dict(ema_sd)
    params = {k for k, _ in through.named_parameters()}
    load_weights(through, {k: v for k, v in ema_sd.items() if k in params},
                 {k: v for k, v in ema_sd.items() if k not in params}, "the TF import")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    u8 = torch.randint(0, 256, (TIME_BATCH, 224, 224, 3), generator=gen, device="cuda",
                       dtype=torch.uint8)
    _zero_counts()
    with torch.inference_mode():
        x = normalize_device(u8, info.mean_rgb, info.stddev_rgb)
        logits = [m(x, policy=BF16_POLICY) for m in (direct, through)]
    torch.cuda.synchronize()
    counts = _counts()
    logits_equal = torch.equal(*logits)
    finite = bool(torch.isfinite(logits[0]).all()) and logits[0].shape == (TIME_BATCH, 1001)

    raw_model = empty_model()
    raw_model.load_state_dict(raw_sd)
    weights = dict(raw_model.named_parameters())
    state = TrainState(model=raw_model, step=TF_GLOBAL_STEP, velocity=momentum_init(weights),
                       ema=ema_init({k: p for k, p in direct.named_parameters()}))
    mgr = CheckpointManager(os.path.join(import_dir, "checkpoints"),
                            model_config=dataclasses.asdict(cfg))
    mgr.save(state)
    mgr.close()
    served = serve_ckpt_phase(import_dir, tmp, phase="tf_import_serve")
    (_, ema_s, ema_bytes), (_, raw_s, raw_bytes) = imports[True], imports[False]
    ok = (all(exact.values()) and ema_differs and logits_equal and finite
          and counts == _launches(6, 0, 0))
    emit("tf_import", model="assemble_resnet50", classes=1001, tensors=len(values),
         bundle_mb=sum(os.path.getsize(p) for p in glob.glob(prefix + ".*")) / 1e6,
         shards=TF_SHARDS, write_s=write_s, import_ema_s=ema_s,
         import_ema_mb_per_s=ema_bytes / 1e6 / ema_s, import_raw_s=raw_s,
         import_raw_mb_per_s=raw_bytes / 1e6 / raw_s, exact=exact, ema_differs=ema_differs,
         logits_equal=logits_equal, launches=counts, served=served,
         phase_s=time.perf_counter() - t_start, card=smi, ok=ok)
    if not ok:
        raise AssertionError("the TF import phase failed")
    return counts, served, ema_sd


def _food101_tree(root, seed):
    """A tree in the published Food-101 archive's layout:
    ``images/<class>/<id>.jpg`` (seeded JPEGs up to FGVC_LONG_SIDE px on the
    long side), ``meta/classes.txt``, ``meta/train.txt`` and ``meta/test.txt``
    (``<class>/<id>`` lines); FGVC_CLASSES classes of FGVC_TRAIN train and
    FGVC_TEST test images. Returns the class names."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    classes = [f"dish_{i:03d}" for i in range(FGVC_CLASSES)]
    split = {"train": [], "test": []}
    os.makedirs(os.path.join(root, "meta"), exist_ok=True)
    for c in classes:
        os.makedirs(os.path.join(root, "images", c))
        for i in range(FGVC_TRAIN + FGVC_TEST):
            long, short = FGVC_LONG_SIDE, int(rng.integers(FGVC_LONG_SIDE // 2, FGVC_LONG_SIDE + 1))
            h, w = (long, short) if rng.integers(2) else (short, long)
            yy, xx = np.mgrid[0:h, 0:w]
            a, b = rng.uniform(0.2, 1.0, 2)
            base = np.stack([yy * a * 255 / h, xx * b * 255 / w,
                             np.full((h, w), rng.uniform(0, 255))], -1)
            img = np.clip(base + rng.integers(0, 48, base.shape), 0, 255).astype(np.uint8)
            image_id = f"{int(rng.integers(1 << 20)):07d}"
            Image.fromarray(img).save(os.path.join(root, "images", c, image_id + ".jpg"),
                                      quality=90)
            split["train" if i < FGVC_TRAIN else "test"].append(f"{c}/{image_id}")
    for name, lines in (("classes", classes), *split.items()):
        with open(os.path.join(root, "meta", f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return classes


def fgvc_finetune_phase(smi, import_dir, imported, tmp):
    """The warm-started fine-tune of the imported checkpoint: a Food-101
    tree (``_food101_tree``), its ``train`` and ``validation`` shards built
    by ``python -m axcnn_torch.data.build_tfrecords --layout=food101
    --dataset=food101`` and read back (record counts, labels), then
    ``main_classification --config=finetune_fgvc`` at full width, b256,
    bf16, FGVC_STEPS steps and its eval, from the import's checkpoint. Before
    the first update every non-head weight and BN statistic must equal the
    imported EMA (``imported``) and the 101-way head its fresh init (the
    warm start skips ``head.``, as the reference's ``_warm_start`` does);
    every loss finite; the kernels 3 + 3 + 9 + 9 times a step."""
    from axcnn_torch.data.datasets import get_dataset
    from axcnn_torch.data.tfrecord import (
        TFRecordReader, count_records, list_shards, parse_example)
    from axcnn_torch.train import loop

    t_start = time.perf_counter()
    tree, records = os.path.join(tmp, "food101"), os.path.join(tmp, "food101_records")
    t0 = time.perf_counter()
    classes = _food101_tree(tree, SEED + 12)
    tree_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for split, shards in (("train", 4), ("test", 2)):
        subprocess.run([sys.executable, "-m", "axcnn_torch.data.build_tfrecords",
                        "--layout=food101", "--dataset=food101", f"--input_dir={tree}",
                        f"--output_dir={records}", f"--split={split}",
                        f"--num_shards={shards}"], check=True, capture_output=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    build_s = time.perf_counter() - t0
    read = {}
    for prefix, per_class in (("train", FGVC_TRAIN), ("validation", FGVC_TEST)):
        shards = list_shards(records, prefix)
        labels = []
        for shard in shards:
            for payload in TFRecordReader(shard, verify_crc=True):
                ex = parse_example(payload)
                label, text = ex["image/class/label"][0], ex["image/class/text"][0].decode()
                assert classes[label] == text, (label, text)
                labels.append(label)
        counts_ok = (sum(count_records(p) for p in shards) == len(labels)
                     and sorted(labels) == sorted(list(range(FGVC_CLASSES)) * per_class))
        read[prefix] = dict(shards=len(shards), records=len(labels), labels_ok=counts_ok)

    warm = {}
    real_warm_start = loop._warm_start

    def spy(state, cfg):
        warm["head"] = {k: v.detach().cpu().clone()
                        for k, v in state.model.head.state_dict().items()}
        state = real_warm_start(state, cfg)
        warm["after"] = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        return state

    run_dir = os.path.join(tmp, "fgvc")
    argv = ["--config=finetune_fgvc", f"--data.data_dir={records}",
            f"--train.pretrained_checkpoint={os.path.join(import_dir, 'checkpoints')}",
            f"--train.train_steps={FGVC_STEPS}", f"--train.batch_size={FGVC_BATCH}",
            "--train.log_every=1", "--runtime.num_devices=1", f"--runtime.model_dir={run_dir}"]
    with mock.patch.object(loop, "_warm_start", spy):
        metrics, counts, seconds, peak, logged = _run_cli(argv)
    after = warm["after"]
    warm_equal = all(torch.equal(after[k], imported[k].cpu()) for k in after
                     if not k.startswith("head."))
    head_fresh = (after["head.weight"].shape[0] == get_dataset("food101").num_classes
                  and all(torch.equal(after[f"head.{k}"], v) for k, v in warm["head"].items()))
    train = [r for r in logged if r["tag"] == "train"]
    losses = [r["loss"] for r in train]
    walls = _step_walls(train)
    eval_batches = -(-FGVC_CLASSES * FGVC_TEST // FGVC_BATCH)
    want = _launches(3 * FGVC_STEPS + 3 * eval_batches, 3 * FGVC_STEPS, 9 * FGVC_STEPS)
    ok = ([r["step"] for r in train] == list(range(1, FGVC_STEPS + 1))
          and all(np.isfinite(losses)) and metrics["count"] == FGVC_CLASSES * FGVC_TEST
          and all(r["labels_ok"] for r in read.values()) and warm_equal and head_fresh
          and counts == want)
    emit("fgvc_finetune", model="assemble_resnet50", preset="finetune_fgvc", dataset="food101",
         classes=FGVC_CLASSES, batch=FGVC_BATCH, dtype="bf16", steps=FGVC_STEPS,
         records=read, tree_s=tree_s, build_s=build_s, warm_start_equals_import=warm_equal,
         head_fresh=head_fresh, first_loss=losses[0], last_loss=losses[-1],
         mean_step_ms=float(walls.mean()) * 1e3, step_ms_min=float(walls.min()) * 1e3,
         step_ms_max=float(walls.max()) * 1e3, train_img_per_s=FGVC_BATCH / float(walls.mean()),
         max_memory_allocated_gib=peak / 2 ** 30,
         launches_per_step={k: v / FGVC_STEPS for k, v in counts.items()}, launches=counts,
         expected=want, eval=metrics, seconds=seconds, phase_s=time.perf_counter() - t_start,
         card=smi, ok=ok)
    if not ok:
        raise AssertionError("the FGVC fine-tune phase failed")
    return counts


def spatial_kernel_check_phase(errs):
    """The kernels' spatial forms against their plain versions, bit for bit
    (module docstring, 32); ``errs`` takes the largest errors."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    cases = [(s, 0) for s in SPATIAL_BLUR_CHECKS] + [(MISALIGNED_SHAPE, 1)]
    for shape, offset in cases:
        n, h, w, c = shape  # h: the shard's rows with the halo row on top
        for dtype in (torch.float32, torch.bfloat16):
            case = f"{dtype}, pad_top 0" + (f", offset {offset}" if offset else "")
            route = "tma" if _tma_legal(c, dtype) and not offset else "thread"
            x = _nchw_input(shape, dtype, gen, offset)
            before = dict(kblur.ROUTES)
            got = kblur.blur_pool_cuda(x, pad_top=0)
            torch.cuda.synchronize()
            errs["fwd"] = max(errs["fwd"], _check_equal(
                "blur_pool3_s2_fwd", shape, case, got, kblur.blur_pool_reference(x, pad_top=0)))
            assert _route_of("fwd", before) == route, (shape, case)
            g = _nchw_input((n, (h - 1) // 2, (w + 1) // 2, c), dtype, gen, offset)
            before = dict(kblur.ROUTES)
            got = kblur.blur_pool_bwd_cuda(g, (h, w), pad_top=0)
            torch.cuda.synchronize()
            errs["bwd"] = max(errs["bwd"], _check_equal(
                "blur_pool3_s2_bwd", shape, case, got,
                kblur.blur_pool_bwd_reference(g, (h, w), pad_top=0)))
            assert _route_of("bwd", before) == route, (shape, case)
            emit("kernel_route", kernel="fwd, bwd", shape=list(shape), case=case, route=route,
                 expected=route, ok=True)
            if offset or h % 2 == 0:
                continue
            # the second of two shards of a map of 2 * (h - 1) rows: its rows
            # are the unsharded kernel's
            full = _nchw_input((n, 2 * (h - 1), w, c), dtype, gen)
            shard = full[:, :, h - 2:].contiguous(memory_format=torch.channels_last)
            _check_equal("blur_pool3_s2_fwd", shape, f"{dtype}, pad_top 0 vs unsharded rows",
                         kblur.blur_pool_cuda(shard, pad_top=0),
                         kblur.blur_pool_cuda(full)[:, :, (h - 1) // 2:])
    for h, w, bs, row0, rows in SPATIAL_MASK_WINDOWS:
        for gamma in GAMMAS[1:]:
            seeds = _seeds(TIME_BATCH, gen)
            window = dict(row0=row0, h_global=h)
            mask, counts = kdrop.dropblock_mask_cuda(seeds, gamma, rows, w, bs, **window)
            whole, _ = kdrop.dropblock_mask_cuda(seeds, gamma, h, w, bs)
            torch.cuda.synchronize()
            want_m, want_c = kdrop.dropblock_mask_reference(seeds, gamma, rows, w, bs, **window)
            shape, case = (TIME_BATCH, h, w, bs), f"rows {row0}-{row0 + rows - 1}, gamma={gamma}"
            errs["mask"] = max(errs["mask"], _check_equal(
                "dropblock_mask", shape, case, mask, want_m),
                _check_equal("dropblock_mask.counts", shape, case, counts, want_c))
            _check_equal("dropblock_mask", shape, f"{case}, vs the whole map's rows", mask,
                         whole[:, row0:row0 + rows].contiguous())
    for (shape, hg), offset in [(s, 0) for s in SPATIAL_APPLY_SHAPES] + [
            (((4, 15, 17, 6), 30), 0), ((APPLY_MISALIGNED_SHAPE, 28), 1)]:
        for dtype in (torch.float32, torch.bfloat16):
            x, _, mask, counts = _apply_inputs(shape, dtype, gen, offset)
            # the global batch: (D, S) = (2, 2), the other data shard's counts
            counts = torch.cat([counts, counts.flip(0)]) * 2
            numel = 4 * x.numel()
            case = f"{dtype}, global counts" + (f", offset {offset}" if offset else "")
            for backward in (False, True):
                ref = (kdrop.dropblock_apply_bwd_reference if backward
                       else kdrop.dropblock_apply_reference)
                got = kdrop.dropblock_apply_cuda(x, mask, counts, backward=backward, numel=numel)
                torch.cuda.synchronize()
                errs["apply"] = max(errs["apply"], _check_equal(
                    f"dropblock_apply_{'bwd' if backward else 'fwd'}", shape, case, got,
                    ref(x, mask, counts, numel), bits=True))
    _fused_window_check(errs, gen)


def _fused_window_check(errs, gen, n=8, gamma=APPLY_GAMMA):
    """The fused window kernel at each of ``SPATIAL_MASK_WINDOWS`` on a rank
    of one and of two data shards (both offsets), fp32 and bf16, C = 64
    (16-byte units) and 6 (per element): output bits, mask and counts
    against its plain version, then against today's route past the fused
    line: the windowed mask kernel over every window that covers the map,
    the window counts summed and the data shards' in data order, the apply
    kernel with them."""
    for h, w, bs, row0, rows in SPATIAL_MASK_WINDOWS:
        cover = [(r0, r1 - r0) for r0, r1 in ((0, row0), (row0, row0 + rows),
                                             (row0 + rows, h)) if r1 > r0]
        for data, dtype, c in itertools.product((1, 2), (torch.float32, torch.bfloat16), (64, 6)):
            seeds = _seeds(n * data, gen)
            today = torch.cat([sum(kdrop.dropblock_mask_cuda(
                seeds[d * n:(d + 1) * n], gamma, r, w, bs, row0=r0, h_global=h)[1]
                for r0, r in cover) for d in range(data)])
            for d in range(data):
                window = dict(row0=row0, h_global=h, first=d * n, numel=data * n * h * w * c)
                x = _nchw_input((n, rows, w, c), dtype, gen)
                _, mask, _ = kdrop.dropblock_fused_window_reference(x, seeds, gamma, bs,
                                                                    **window)
                x = _with_specials(x, mask)
                got = kdrop.dropblock_fused_window_cuda(x, seeds, gamma, bs, **window)
                want = kdrop.dropblock_fused_window_reference(x, seeds, gamma, bs, **window)
                mask_k, counts_k = kdrop.dropblock_mask_cuda(
                    seeds[d * n:(d + 1) * n], gamma, rows, w, bs, row0=row0, h_global=h)
                before = kdrop.dropblock_apply_cuda(x, mask_k, today, numel=window["numel"])
                torch.cuda.synchronize()
                shape = (n, rows, w, c)
                case = (f"{dtype}, rows {row0}-{row0 + rows - 1} of {h}, bs {bs}, D{data} "
                        f"first {d * n}")
                errs["fused_window"] = max(
                    errs["fused_window"],
                    _check_equal("dropblock_fused_window", shape, case, got[0], want[0],
                                 bits=True),
                    _check_equal("dropblock_fused_window.mask", shape, case, got[1], want[1]),
                    _check_equal("dropblock_fused_window.counts", shape, case, got[2],
                                 want[2]))
                _check_equal("dropblock_fused_window", shape, f"{case}, vs the windowed mask, "
                             "the counts summed, the apply", got[0], before, bits=True)
                _check_equal("dropblock_fused_window.mask", shape, f"{case}, vs the windowed "
                             "mask", got[1], mask_k)
                _check_equal("dropblock_fused_window.counts", shape, f"{case}, vs the windows' "
                             "sum", got[2], today)


def _spatial_launches(fwd, bwd, sites):
    """Expected counts on a spatial path: BlurPool with top padding 0
    forward and backward, and per DropBlock site (every map within the
    fused line) the fused window kernel and the apply backward; no windowed
    mask, forward apply or fused kernel."""
    return {"fwd": fwd, "bwd": bwd, "mask": 0, "apply": 0, "apply_bwd": sites, "fused": 0,
            "fused_window": sites}


@contextlib.contextmanager
def _counting_collectives():
    """The calls of ``torch.distributed.all_reduce`` and ``all_gather`` in
    the block, by name."""
    import torch.distributed as dist

    calls = {"all_reduce": 0, "all_gather": 0}

    def counted(name):
        fn = getattr(dist, name)

        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    with mock.patch.object(dist, "all_reduce", counted("all_reduce")), \
            mock.patch.object(dist, "all_gather", counted("all_gather")):
        yield calls


def _past_line(launches):
    """The launches of a spatial path's counts with the fused line moved to
    0: each site's fused window launch becomes the windowed mask and the
    forward apply."""
    sites = launches["fused_window"]
    return {**launches, "mask": sites, "apply": sites, "fused_window": 0}


@contextlib.contextmanager
def _site_outputs():
    """The forward outputs of the spatial DropBlock sites run in the block,
    in call order, copied to the CPU, whichever route each site takes."""
    from axcnn_torch.ops import dropblock as op_dropblock

    outs = []

    def recorded(function):
        class Recorded:
            @staticmethod
            def apply(*args):
                y = function.apply(*args)
                outs.append(y.detach().cpu())
                return y
        return Recorded

    with mock.patch.object(op_dropblock, "DropBlockFusedWindow",
                           recorded(kdrop.DropBlockFusedWindow)), \
            mock.patch.object(op_dropblock, "DropBlockApply", recorded(kdrop.DropBlockApply)):
        yield outs


def _same_sites(now, past, sites):
    """Whether two runs' ``sites`` DropBlock site outputs are equal bit for
    bit (a step's end state is not: cuDNN's wgrad need not be deterministic
    run to run, but the forward up to each site is)."""
    def bits(t):
        return t.contiguous().view(torch.uint8)
    return len(now) == len(past) == sites and all(
        a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))
        for a, b in zip(now, past))


def _collective_drop(now, past, sites, data=1):
    """Whether a step issued one all-reduce a DropBlock site fewer (and, with
    ``data`` > 1 shards, one all-gather a site fewer) than the same step with
    the fused line moved to 0."""
    return (past["all_reduce"] - now["all_reduce"] == sites
            and past["all_gather"] - now["all_gather"] == (sites if data > 1 else 0))


def _spatial_parity_rank(rank, world, coordinator, workdir):
    """One rank of ``spatial_parity`` on card ``rank`` over NCCL: the
    spatial step from the payload's state, then the eval on its batch."""
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, set_fp32_precision
    from axcnn_torch.parallel import mesh
    from axcnn_torch.parallel.spatial import make_spatial_context
    from axcnn_torch.train.train_step import create_train_state, make_eval_step

    set_fp32_precision(DEFAULT_POLICY)
    device = torch.device("cuda", rank)
    mesh.init_distributed(device, rank=rank, world_size=world, coordinator=coordinator)
    try:
        ctx = make_spatial_context(world)
        payload = torch.load(os.path.join(workdir, "spatial_in.pt"), weights_only=False)
        cfg = _assembled_cfg()
        batch = {k: v.to(device) for k, v in payload["batch"].items()}
        group = mesh.data_group()

        def step():
            state = create_train_state(cfg, generator=torch.Generator(), device=device)
            state.model.load_state_dict(payload["model"])
            # copies: the step updates the velocity and the EMA in place
            state.velocity = {k: v.to(device, copy=True) for k, v in payload["velocity"].items()}
            state.ema = {k: v.to(device, copy=True) for k, v in payload["ema"].items()}
            state.step = payload["step"]
            with _counting_collectives() as calls, _site_outputs() as sites:
                state, metrics = _parity_step(cfg, group=group, spatial=ctx)(state, batch,
                                                                              SEED + 1)
                torch.cuda.synchronize()
            return state, metrics, calls, sites

        # the same step with the fused line moved to 0 first: the route every
        # site took before the fused window kernel
        _zero_counts()
        with mock.patch.object(kdrop, "FUSED_MAX_HW", 0):
            _, past_metrics, past, past_sites = step()
        past_launches = _counts()
        _zero_counts()
        state, metrics, calls, sites = step()
        past_equal = (_same_sites(sites, past_sites, 9)
                      and float(metrics["loss"]) == float(past_metrics["loss"]))
        ev = make_eval_step(cfg, use_ema=True, group=group, spatial=ctx)(state, batch)
        torch.cuda.synchronize()
        out = {"params": {k: p.detach().cpu() for k, p in state.model.named_parameters()},
               "buffers": {k: b.cpu() for k, b in state.model.named_buffers()},
               "metrics": {k: float(v) for k, v in metrics.items()},
               "eval": {k: float(v) for k, v in ev.items()}, "launches": _counts(),
               "collectives": calls, "collectives_past_line": past,
               "launches_past_line": past_launches, "past_line_equal": past_equal}
    finally:
        mesh.shutdown()
    torch.save(out, os.path.join(workdir, f"spatial_rank{rank}.pt"))


def _parity_step(cfg, **kw):
    """``spatial_parity``'s step: step 5 of 10 (keep-prob 0.95), mixup,
    label smoothing; ``kw`` passes the policy, the group, the context."""
    from axcnn_torch.train.schedules import make_lr_schedule
    from axcnn_torch.train.train_step import make_train_step

    n = SPATIAL_PARITY_BATCH
    return make_train_step(
        cfg, lr_schedule=make_lr_schedule(base_lr=0.1 * n / 256, total_steps=10,
                                          warmup_steps=2),
        total_steps=10, label_smoothing=0.1, mixup_alpha=0.2, **kw)


def spatial_parity_phase(smi, tmp):
    """One spatial step on two cards against the one-card step and the
    CPU's float64 step (module docstring, 33). At batch 4 two fp32 runs lie
    ~1e-2 apart per leaf (ReLU and max-pool ties flip), so, as in
    ``train_parity``, the spatial step must be as near the float64 step as
    the one-card step is: loss within 1e-4 of it, the parameters' updates
    and the BN statistics no more than 3x the one-card step's distance
    (median and worst leaf)."""
    import torch.multiprocessing as mp

    from axcnn_torch.cli.main_classification import _free_port
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, Policy, set_fp32_precision
    from axcnn_torch.train.train_step import create_train_state, make_eval_step

    cards = torch.cuda.device_count()
    if cards < 2:
        emit("spatial_parity", ran=False, reason=f"{cards} card")
        return None
    set_fp32_precision(DEFAULT_POLICY)
    n, size = SPATIAL_PARITY_BATCH, SPATIAL_PARITY_SIZE
    cfg = _assembled_cfg()
    cpu = create_train_state(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu", use_ema=True)
    _perturb_bn(cpu.model, SEED)
    cpu.step = 5
    rng = np.random.default_rng(SEED + 5)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (n, size, size, 3),
                                                     dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, 1001, n).astype(np.int64))}
    old = {k: p.detach().clone() for k, p in cpu.model.named_parameters()}
    old_bn = {k: b.clone() for k, b in cpu.model.named_buffers()}
    torch.save({"model": cpu.model.state_dict(), "velocity": cpu.velocity, "ema": cpu.ema,
                "step": cpu.step, "batch": batch}, os.path.join(tmp, "spatial_in.pt"))

    card = _state_copy(cpu, "cuda")
    card_batch = {k: v.cuda() for k, v in batch.items()}
    card, m_card = _parity_step(cfg)(card, card_batch, SEED + 1)
    ev_card = {k: float(v) for k, v in make_eval_step(cfg, use_ema=True)(card, card_batch).items()}
    single = {k: p.detach().cpu() for k, p in card.model.named_parameters()}
    single_bn = {k: b.cpu() for k, b in card.model.named_buffers()}
    del card, card_batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mp.start_processes(_spatial_parity_rank, nprocs=2, start_method="spawn",
                       args=(2, f"127.0.0.1:{_free_port()}", tmp))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"spatial_rank{r}.pt")) for r in range(2)]
    sp = ranks[0]

    cpu64 = _state_copy(cpu, "cpu")
    cpu64.model.double()
    cpu64.velocity = {k: v.double() for k, v in cpu64.velocity.items()}
    cpu64.ema = {k: v.double() for k, v in cpu64.ema.items()}
    to_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        cpu64, m_64 = _parity_step(cfg, policy=Policy(torch.float64, torch.float64))(
            cpu64, batch, SEED + 1)
    finally:
        torch.Tensor.float = to_float
    ref = {k: p.detach() for k, p in cpu64.model.named_parameters()}
    ref_bn = {k: b for k, b in cpu64.model.named_buffers()}

    med = lambda e: float(np.median(list(e.values())))  # noqa: E731
    e_sp, e_one = _update_errors(old, sp["params"], ref), _update_errors(old, single, ref)
    b_sp, b_one = (_update_errors(old_bn, sp["buffers"], ref_bn),
                   _update_errors(old_bn, single_bn, ref_bn))
    e_pair = _update_errors(old, sp["params"], single)
    loss64 = m_64["loss"].item()
    loss_rel = abs(sp["metrics"]["loss"] - loss64) / abs(loss64)
    tol = dict(loss_rel=1e-4, median_vs_one_card=3.0, worst_vs_one_card=3.0)
    want = _spatial_launches(3, 3, 9)
    eval_equal = all(sp["eval"][k] == ev_card[k] for k in ("count", "top1", "top5"))
    want_past = _past_line(want)
    drop_ok = all(_collective_drop(r["collectives"], r["collectives_past_line"], 9)
                  and r["past_line_equal"] and r["launches_past_line"] == want_past
                  for r in ranks)
    emit("spatial_collectives", path="spatial_parity", grid="D1xS2", backend="nccl",
         per_rank_step=[{"fused_line": r["collectives"],
                         "line_at_0": r["collectives_past_line"],
                         "line_at_0_launches": r["launches_past_line"],
                         "line_at_0_sites_and_loss_bit_equal": r["past_line_equal"]}
                        for r in ranks],
         expected_drop={"all_reduce": 9, "all_gather": 0}, expected_line_at_0_launches=want_past,
         ok=drop_ok)
    ok = (loss_rel <= tol["loss_rel"]
          and med(e_sp) <= tol["median_vs_one_card"] * med(e_one)
          and max(e_sp.values()) <= tol["worst_vs_one_card"] * max(e_one.values())
          and max(b_sp.values()) <= tol["worst_vs_one_card"] * max(b_one.values())
          and all(r["params"][k].equal(sp["params"][k]) for r in ranks for k in sp["params"])
          and eval_equal and sp["eval"]["count"] == n and drop_ok
          and all(r["launches"] == {**want, "fwd": 6} for r in ranks))
    emit("spatial_parity", ran=True, ranks=2, grid="D1xS2", backend="nccl", batch=n,
         image_size=size, dtype="fp32", tf32=False, loss_spatial=sp["metrics"]["loss"],
         loss_one_card=m_card["loss"].item(), loss_fp64=loss64, loss_rel_spatial_vs_fp64=loss_rel,
         mixup_lam=sp["metrics"].get("mixup_lam"),
         spatial_vs_fp64={"median": med(e_sp), "worst": max(e_sp.values()),
                          "worst_leaf": max(e_sp, key=e_sp.get)},
         one_card_vs_fp64={"median": med(e_one), "worst": max(e_one.values())},
         spatial_vs_one_card={"median": med(e_pair), "worst": max(e_pair.values())},
         bn_spatial_vs_fp64={"median": med(b_sp), "worst": max(b_sp.values())},
         bn_one_card_vs_fp64={"median": med(b_one), "worst": max(b_one.values())},
         eval_spatial=sp["eval"], eval_one_card=ev_card, eval_counts_equal=eval_equal,
         launches_per_rank=[r["launches"] for r in ranks],
         expected={**want, "fwd": 6}, tolerance=tol, ranks_seconds=ranks_s, card=smi, ok=ok)
    if not ok:
        raise AssertionError("spatial_parity phase failed")
    return sp["launches"]


def _spatial_cli_rank(rank, world, coordinator, argv, workdir, card=None, backend=None):
    """One rank of the training CLI, as ``main_classification`` starts it
    (its card, the process group, the run), that also keeps its card's peak
    memory and its kernels' launches. ``card``: every rank on that card
    (with ``backend="gloo"``: NCCL takes one rank a card) instead of card
    ``rank``."""
    from axcnn_torch.cli import main_classification
    from axcnn_torch.parallel import mesh
    from axcnn_torch.train.loop import resolve_device
    from axcnn_torch.utils.config import parse_cli

    cfg = parse_cli(argv)
    local = rank if card is None else card
    device = resolve_device(cfg.runtime.platform, local)
    mesh.init_distributed(device, rank=rank, world_size=world, coordinator=coordinator,
                          backend=backend)
    try:
        _zero_counts()
        torch.cuda.reset_peak_memory_stats(device)
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            metrics = main_classification._run(cfg, local_rank=local)
        torch.cuda.synchronize(device)
        out = {"metrics": metrics, "launches": _counts(), "routes": dict(kblur.ROUTES),
               "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}
    finally:
        mesh.shutdown()
    with open(os.path.join(workdir, f"cli_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def spatial_448_phase(smi, tmp):
    """``finetune_fgvc`` at 448x448 (module docstring, 34). Returns the
    launches by path."""
    import torch.multiprocessing as mp

    from axcnn_torch.cli.main_classification import _free_port

    def argv(batch, run_dir, *extra):
        return ["--config=finetune_fgvc", "--data.use_synthetic_data",
                f"--data.image_size={SPATIAL_SIZE}", f"--train.train_steps={SPATIAL_STEPS}",
                f"--train.batch_size={batch}", "--train.log_every=1",
                f"--runtime.model_dir={os.path.join(tmp, run_dir)}", *extra]

    def summary(records):
        train = [r for r in records if r["tag"] == "train"]
        walls = _step_walls(train)
        return train, dict(losses=[r["loss"] for r in train],
                           mean_step_ms=float(walls.mean()) * 1e3,
                           step_ms_min=float(walls.min()) * 1e3,
                           step_ms=[w * 1e3 for w in walls])

    paths = {}
    b1 = SPATIAL_BATCHES[0]
    metrics, counts, seconds, peak, records = _run_cli(
        argv(b1, "s448_one", "--runtime.num_devices=1"))
    train, one = summary(records)
    want = _launches(3 * SPATIAL_STEPS + 3 * 4, 3 * SPATIAL_STEPS, 9 * SPATIAL_STEPS)
    ok = (len(train) == SPATIAL_STEPS and all(np.isfinite(one["losses"])) and counts == want)
    one.update(peak_gib=peak / 2 ** 30, img_per_s=b1 / (one["mean_step_ms"] / 1e3))
    emit("spatial_448", part="one card", image_size=SPATIAL_SIZE, batch=b1, dtype="bf16",
         steps=SPATIAL_STEPS, **one, launches=counts, expected=want, eval=metrics,
         seconds=seconds, card=smi, ok=ok)
    if not ok:
        raise AssertionError("spatial_448 (one card) failed")
    paths["spatial_448_one_card"] = counts
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("spatial_448", part="two cards", ran=False, reason=f"{cards} card")
        return paths
    for batch in SPATIAL_BATCHES:
        run = f"s448_s2_b{batch}"
        args = argv(batch, run, "--runtime.num_devices=2", "--runtime.spatial_partitions=2")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.start_processes(_spatial_cli_rank, nprocs=2, start_method="spawn",
                           args=(2, f"127.0.0.1:{_free_port()}", args, tmp))
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"cli_rank{r}.json")) as f:
                ranks.append(json.load(f))
        with open(os.path.join(tmp, run, "metrics.jsonl")) as f:
            train, two = summary([json.loads(line) for line in f])
        want = _spatial_launches(3 * SPATIAL_STEPS + 3 * 4, 3 * SPATIAL_STEPS,
                                 9 * SPATIAL_STEPS)
        peaks = [r["peak_gib"] for r in ranks]
        ok = (len(train) == SPATIAL_STEPS and all(np.isfinite(two["losses"]))
              and all(r["launches"] == want for r in ranks)
              and ranks[0]["metrics"]["count"] == 4 * batch
              and not any(r["routes"]["fwd_thread"] or r["routes"]["bwd_thread"] for r in ranks))
        emit("spatial_448", part="two cards", ran=True, grid="D1xS2", backend="nccl",
             image_size=SPATIAL_SIZE, batch=batch, dtype="bf16", steps=SPATIAL_STEPS, **two,
             img_per_s=batch / (two["mean_step_ms"] / 1e3), peak_gib_per_card=peaks,
             peak_over_one_card_b128=[p / one["peak_gib"] for p in peaks],
             launches_per_rank=[r["launches"] for r in ranks], expected=want,
             routes=ranks[0]["routes"], eval=ranks[0]["metrics"], seconds=seconds, card=smi,
             ok=ok)
        if not ok:
            raise AssertionError(f"spatial_448 (two cards, b{batch}) failed")
        paths[f"spatial_448_s2_b{batch}"] = ranks[0]["launches"]
    return paths


# spatial_options_parity: each option of the one-card step under spatial
# partitioning, on two Gloo ranks on card 0
SPATIAL_OPTION_LEGS = ("accum", "remat", "aa", "kd", "bl")
SPATIAL_OPTION_KD = dict(kd_temp=2.0, kd_alpha=0.5)
# the legs whose collectives are counted past the fused line too: the step
# with device AutoAugment (9 DropBlock sites) and with accumulation (18)
SPATIAL_COLLECTIVE_LEGS = {"aa": 9, "accum": 18}


def _option_cfg(leg):
    cfg = _assembled_cfg()
    if leg == "remat":
        return dataclasses.replace(cfg, remat="blocks")
    if leg == "bl":
        return dataclasses.replace(cfg, bl_alpha=2, bl_beta=4)
    return cfg


def _option_state(payload, leg, device, dtype=torch.float32):
    """The leg's state at step 5 from the payload, on ``device`` in
    ``dtype``."""
    from axcnn_torch.train.train_step import create_train_state

    cfg = _option_cfg(leg)
    saved = payload["states"]["bl" if leg == "bl" else "base"]
    state = create_train_state(cfg, generator=torch.Generator(), device=device)
    state.model.load_state_dict(saved["model"])
    state.model.to(dtype)
    # copies: the step updates the velocity and the EMA in place
    state.velocity = {k: v.to(device, dtype, copy=True) for k, v in saved["velocity"].items()}
    state.ema = {k: v.to(device, dtype, copy=True) for k, v in saved["ema"].items()}
    state.step = 5
    return cfg, state


def _option_step(payload, leg, device, dtype=torch.float32, **kw):
    """``spatial_parity``'s step with the leg's option, from the payload's
    state and batch; ``kw`` passes the policy, the group, the context.
    Returns the state and the metrics."""
    from axcnn_torch.data.autoaugment_device import make_device_autoaugment
    from axcnn_torch.models.resnet import ResNet

    cfg, state = _option_state(payload, leg, device, dtype)
    extra, call = {}, {}
    if leg == "accum":
        extra["grad_accum_steps"] = 2
    if leg == "kd":
        teacher = ResNet(_assembled_cfg())
        teacher.load_state_dict(payload["teacher"])
        extra.update(teacher=teacher.to(device, dtype, memory_format=torch.channels_last)
                     .eval().requires_grad_(False), **SPATIAL_OPTION_KD)
    if leg == "aa":
        extra["autoaugment_fn"] = make_device_autoaugment("v0", num_groups=1)
        call["aa_draws"] = payload["aa_draws"]
    batch = {k: v.to(device) for k, v in payload["batch"].items()}
    return _parity_step(cfg, **extra, **kw)(state, batch, SEED + 1, **call)


def _int8_option_eval(payload, device, group=None, spatial=None):
    """The int8 evaluation (EMA weights) of the payload's batch: its sums
    and every conv's int32 accumulators, in call order."""
    from axcnn_torch.core.dtypes import INT8_SERVING_POLICY
    from axcnn_torch.ops import conv as kconv
    from axcnn_torch.train.train_step import make_eval_step

    cfg, state = _option_state(payload, "int8", device)
    route, accs = kconv.int8_conv_acc_cuda, []

    def kept(xq, wq, **kw):
        acc = route(xq, wq, **kw)
        accs.append(acc.cpu())
        return acc

    batch = {k: v.to(device) for k, v in payload["batch"].items()}
    with mock.patch.object(kconv, "int8_conv_acc_cuda", kept):
        ev = make_eval_step(cfg, policy=INT8_SERVING_POLICY, use_ema=True, group=group,
                            spatial=spatial)(state, batch)
    return {k: float(v) for k, v in ev.items()}, accs


def _spatial_options_rank(rank, world, coordinator, workdir):
    """One rank of ``spatial_options_parity`` in its own process on card 0,
    over Gloo: every leg's spatial step from the payload, then the int8
    eval, each leg's kernel launches counted."""
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, set_fp32_precision
    from axcnn_torch.parallel import mesh
    from axcnn_torch.parallel.spatial import make_spatial_context

    set_fp32_precision(DEFAULT_POLICY)
    device = torch.device("cuda", 0)
    mesh.init_distributed(device, rank=rank, world_size=world, coordinator=coordinator,
                          backend="gloo")
    try:
        ctx = make_spatial_context(world)
        payload = torch.load(os.path.join(workdir, "options_in.pt"), weights_only=False)
        group = mesh.data_group()
        out = {}
        for leg in SPATIAL_OPTION_LEGS:
            _zero_counts()
            with _counting_collectives() as calls, _site_outputs() as sites:
                state, metrics = _option_step(payload, leg, device, group=group, spatial=ctx)
                torch.cuda.synchronize()
            out[leg] = {"params": {k: p.detach().cpu() for k, p in
                                   state.model.named_parameters()},
                        "buffers": {k: b.cpu() for k, b in state.model.named_buffers()},
                        "loss": float(metrics["loss"]), "launches": _counts(),
                        "collectives": calls}
            del state
            if leg in SPATIAL_COLLECTIVE_LEGS:
                out[leg]["sites"] = sites
        # the plain and the accumulating step again with the fused line moved
        # to 0: the route every site took before the fused window kernel
        for leg, n_sites in SPATIAL_COLLECTIVE_LEGS.items():
            _zero_counts()
            with mock.patch.object(kdrop, "FUSED_MAX_HW", 0), _counting_collectives() as calls, \
                    _site_outputs() as sites:
                _, metrics = _option_step(payload, leg, device, group=group, spatial=ctx)
                torch.cuda.synchronize()
            out[leg].update(collectives_past_line=calls, launches_past_line=_counts(),
                            past_line_equal=(_same_sites(out[leg].pop("sites"), sites, n_sites)
                                             and float(metrics["loss"]) == out[leg]["loss"]))
        _zero_counts()
        ev, accs = _int8_option_eval(payload, device, group=group, spatial=ctx)
        torch.cuda.synchronize()
        out["int8"] = {"eval": ev, "accs": accs, "launches": _counts(), "index": ctx.index}
    finally:
        mesh.shutdown()
    torch.save(out, os.path.join(workdir, f"options_rank{rank}.pt"))


def _option_launches():
    """Each leg's launches on a rank: the plain spatial step's 3 + 3 + 9;
    twice that for two micro-batches; the replay's 3 more forwards; the
    teacher's 3 forwards; Big-Little's 5 + 5 with 4 sites; the int8 eval's
    3 forwards."""
    return {"accum": _spatial_launches(6, 6, 18), "remat": _spatial_launches(6, 3, 9),
            "aa": _spatial_launches(3, 3, 9), "kd": _spatial_launches(6, 3, 9),
            "bl": _spatial_launches(5, 5, 4), "int8": _spatial_launches(3, 0, 0)}


def spatial_options_parity_phase(smi, tmp):
    """Each option of the step under spatial partitioning on two Gloo ranks
    on card 0 against the same option's one-card step and the CPU's float64
    step (module docstring, 37), with ``spatial_parity``'s bounds; the int8
    eval against the one-card int8 eval."""
    import torch.multiprocessing as mp

    from axcnn_torch.cli.main_classification import _free_port
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, Policy, set_fp32_precision
    from axcnn_torch.data.autoaugment import POLICIES
    from axcnn_torch.data.autoaugment_device import draw_autoaugment
    from axcnn_torch.models.resnet import ResNet
    from axcnn_torch.train.train_step import create_train_state

    t_start = time.perf_counter()
    set_fp32_precision(DEFAULT_POLICY)
    n, size = SPATIAL_PARITY_BATCH, SPATIAL_PARITY_SIZE
    states = {}
    for key, leg, seed in (("base", "accum", SEED), ("bl", "bl", SEED + 1)):
        s = create_train_state(_option_cfg(leg), generator=torch.Generator().manual_seed(seed),
                               device="cpu")
        _perturb_bn(s.model, seed)
        states[key] = {"model": s.model.state_dict(), "velocity": s.velocity, "ema": s.ema}
    teacher = ResNet(_assembled_cfg(), generator=torch.Generator().manual_seed(SEED + 2))
    _perturb_bn(teacher, SEED + 2)
    rng = np.random.default_rng(SEED + 7)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (n, size, size, 3),
                                                     dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, 1001, n).astype(np.int64))}
    # one AutoAugment group of the whole batch, across both shards' rows
    (_, _, signs), = draw_autoaugment(rng, len(POLICIES["v0"]), 1, n)
    coins = np.array([[0.0, 0.9, 0.0, 0.9], [0.9, 0.0, 0.0, 0.9]], np.float32)
    payload = {"states": states, "teacher": teacher.state_dict(), "batch": batch,
               "aa_draws": [(0, coins, signs)]}
    torch.save(payload, os.path.join(tmp, "options_in.pt"))

    one = {}
    for leg in SPATIAL_OPTION_LEGS:
        state, metrics = _option_step(payload, leg, "cuda")
        one[leg] = {"params": {k: p.detach().cpu() for k, p in state.model.named_parameters()},
                    "buffers": {k: b.cpu() for k, b in state.model.named_buffers()},
                    "loss": float(metrics["loss"])}
        del state
    one_int8, one_accs = _int8_option_eval(payload, "cuda")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mp.start_processes(_spatial_options_rank, nprocs=2, start_method="spawn",
                       args=(2, f"127.0.0.1:{_free_port()}", tmp))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"options_rank{r}.pt")) for r in range(2)]

    t0 = time.perf_counter()
    ref = {}
    to_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        for leg in SPATIAL_OPTION_LEGS:
            state, metrics = _option_step(payload, leg, "cpu", torch.float64,
                                          policy=Policy(torch.float64, torch.float64))
            ref[leg] = {"params": {k: p.detach() for k, p in state.model.named_parameters()},
                        "buffers": dict(state.model.named_buffers()),
                        "loss": metrics["loss"].item()}
    finally:
        torch.Tensor.float = to_float
    fp64_s = time.perf_counter() - t0

    med = lambda e: float(np.median(list(e.values())))  # noqa: E731
    tol = dict(loss_rel=1e-4, median_vs_one_card=3.0, worst_vs_one_card=3.0)
    want = _option_launches()
    legs, ok = {}, True
    for leg in SPATIAL_OPTION_LEGS:
        _, start = _option_state(payload, leg, "cpu")
        old = {k: p.detach() for k, p in start.model.named_parameters()}
        old_bn = dict(start.model.named_buffers())
        sp, o, r = ranks[0][leg], one[leg], ref[leg]
        e_sp, e_one = _update_errors(old, sp["params"], r["params"]), _update_errors(
            old, o["params"], r["params"])
        b_sp, b_one = (_update_errors(old_bn, sp["buffers"], r["buffers"]),
                       _update_errors(old_bn, o["buffers"], r["buffers"]))
        e_pair = _update_errors(old, sp["params"], o["params"])
        loss_rel = abs(sp["loss"] - r["loss"]) / abs(r["loss"])
        leg_ok = (loss_rel <= tol["loss_rel"]
                  and med(e_sp) <= tol["median_vs_one_card"] * med(e_one)
                  and max(e_sp.values()) <= tol["worst_vs_one_card"] * max(e_one.values())
                  and max(b_sp.values()) <= tol["worst_vs_one_card"] * max(b_one.values())
                  and all(x[leg]["params"][k].equal(sp["params"][k]) for x in ranks
                          for k in sp["params"])
                  and all(x[leg]["launches"] == want[leg] for x in ranks))
        legs[leg] = dict(loss_spatial=sp["loss"], loss_one_card=o["loss"], loss_fp64=r["loss"],
                         loss_rel_spatial_vs_fp64=loss_rel,
                         spatial_vs_fp64={"median": med(e_sp), "worst": max(e_sp.values()),
                                          "worst_leaf": max(e_sp, key=e_sp.get)},
                         one_card_vs_fp64={"median": med(e_one), "worst": max(e_one.values())},
                         spatial_vs_one_card={"median": med(e_pair),
                                              "worst": max(e_pair.values())},
                         bn_spatial_vs_fp64=max(b_sp.values()),
                         bn_one_card_vs_fp64=max(b_one.values()),
                         launches=ranks[0][leg]["launches"], expected=want[leg], ok=leg_ok)
        ok = ok and leg_ok
    # int8: the sums equal the one-card eval's; each conv's accumulators
    # before the first pooled sum (the stem's 3, stage 1 block 0's
    # projection, 1x1 and SK convs) are the one-card ones' rows, bit for bit
    sk = 1 if _assembled_cfg().sk_merged_conv else 2
    prefix = 3 + 2 + sk
    matched = []
    for x in ranks:
        s, accs = x["int8"]["index"], x["int8"]["accs"]
        count = 0
        for got, full in zip(accs, one_accs):
            h = full.shape[2] // 2
            if got.shape != full[:, :, s * h:(s + 1) * h].shape or not torch.equal(
                    got, full[:, :, s * h:(s + 1) * h]):
                break
            count += 1
        matched.append(count)
    int8_ok = (all(x["int8"]["eval"][k] == one_int8[k] for x in ranks
                   for k in ("count", "top1", "top5"))
               and one_int8["count"] == n and min(matched) >= prefix
               and all(len(x["int8"]["accs"]) == len(one_accs) == INT8_CONVS for x in ranks)
               and all(x["int8"]["launches"] == want["int8"] for x in ranks))
    legs["int8"] = dict(eval_spatial=ranks[0]["int8"]["eval"], eval_one_card=one_int8,
                        convs=len(one_accs), accumulators_bit_equal_leading=matched,
                        required_leading=prefix, launches=ranks[0]["int8"]["launches"],
                        expected=want["int8"], ok=int8_ok)
    ok = ok and int8_ok
    drop_ok = all(_collective_drop(x[leg]["collectives"], x[leg]["collectives_past_line"], sites)
                  and x[leg]["past_line_equal"]
                  and x[leg]["launches_past_line"] == _past_line(want[leg])
                  for x in ranks for leg, sites in SPATIAL_COLLECTIVE_LEGS.items())
    emit("spatial_collectives", path="spatial_options_parity", grid="D1xS2", backend="gloo",
         per_rank_step={leg: [{"fused_line": x[leg]["collectives"],
                               "line_at_0": x[leg].get("collectives_past_line"),
                               "line_at_0_launches": x[leg].get("launches_past_line"),
                               "line_at_0_sites_and_loss_bit_equal":
                                   x[leg].get("past_line_equal")}
                              for x in ranks]
                        for leg in SPATIAL_OPTION_LEGS},
         expected_drop={leg: {"all_reduce": sites, "all_gather": 0}
                        for leg, sites in SPATIAL_COLLECTIVE_LEGS.items()},
         expected_line_at_0_launches={leg: _past_line(want[leg])
                                      for leg in SPATIAL_COLLECTIVE_LEGS}, ok=drop_ok)
    ok = ok and drop_ok
    emit("spatial_options_parity", ranks=2, grid="D1xS2", backend="gloo",
         card="0 (both ranks)", batch=n, image_size=size, dtype="fp32", tf32=False,
         legs=legs, tolerance=tol, ranks_seconds=ranks_s, fp64_cpu_seconds=fp64_s,
         seconds=time.perf_counter() - t_start, nvidia_smi=smi, ok=ok)
    if not ok:
        raise AssertionError("spatial_options_parity phase failed")
    total = dict.fromkeys(want["accum"], 0)
    for leg in (*SPATIAL_OPTION_LEGS, "int8"):
        total = _add(total, ranks[0][leg]["launches"])
    return total


SPATIAL_OPTIONS_STEPS, SPATIAL_OPTIONS_IMAGES, SPATIAL_OPTIONS_EVAL = 3, 256, 64
SPATIAL_OPTIONS_FLAGS = ("--model.remat=blocks", "--train.grad_accum_steps=2",
                         "--data.autoaugment_device=true")


def spatial_448_options_phase(smi, tmp, backends=("gloo", "nccl")):
    """``finetune_fgvc`` at 448x448 with ``--runtime.spatial_partitions=2``
    and remat, two micro-batches and device AutoAugment (module docstring,
    38): two Gloo ranks on card 0 at each of ``SPATIAL_BATCHES``, then,
    where there are two cards, the CLI's own NCCL ranks (``backends``
    picks). Returns the launches by path."""
    import torch.multiprocessing as mp

    from axcnn_torch.cli.main_classification import _free_port

    t_start = time.perf_counter()
    data_dir = os.path.join(tmp, "s448_records")
    rng = np.random.default_rng(SEED + 8)
    _write_records(data_dir, "train", SPATIAL_OPTIONS_IMAGES, SEED + 8, shards=4,
                   size=FGVC_LONG_SIDE,
                   labels=rng.integers(0, FGVC_CLASSES, SPATIAL_OPTIONS_IMAGES))
    _write_records(data_dir, "validation", SPATIAL_OPTIONS_EVAL, SEED + 9, size=FGVC_LONG_SIDE,
                   labels=rng.integers(0, FGVC_CLASSES, SPATIAL_OPTIONS_EVAL))
    aa_ms = {b: _aa_ms(b, SPATIAL_SIZE) for b in SPATIAL_BATCHES}
    steps = SPATIAL_OPTIONS_STEPS
    want = _spatial_launches(12 * steps + 3, 6 * steps, 18 * steps)
    cards = torch.cuda.device_count()
    runs = [(k, b) for k in backends if k == "gloo" or cards >= 2 for b in SPATIAL_BATCHES]
    paths, ok = {}, True
    for backend, batch in runs:
        run = f"s448_opt_{backend}_b{batch}"
        argv = ["--config=finetune_fgvc", "--data.dataset_name=custom",
                f"--data.data_dir={data_dir}", f"--data.num_classes={FGVC_CLASSES}",
                f"--data.num_train_examples={SPATIAL_OPTIONS_IMAGES}",
                f"--data.num_eval_examples={SPATIAL_OPTIONS_EVAL}",
                f"--data.image_size={SPATIAL_SIZE}", f"--train.train_steps={steps}",
                f"--train.batch_size={batch}", "--train.log_every=1",
                "--runtime.num_devices=2", "--runtime.spatial_partitions=2",
                *SPATIAL_OPTIONS_FLAGS, f"--runtime.model_dir={os.path.join(tmp, run)}"]
        # gloo: both ranks on card 0; nccl: a card each, as the CLI starts them
        card = 0 if backend == "gloo" else None
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.start_processes(_spatial_cli_rank, nprocs=2, start_method="spawn",
                           args=(2, f"127.0.0.1:{_free_port()}", argv, tmp, card, backend))
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"cli_rank{r}.json")) as f:
                ranks.append(json.load(f))
        with open(os.path.join(tmp, run, "metrics.jsonl")) as f:
            train = [r for r in map(json.loads, f) if r["tag"] == "train"]
        walls = _step_walls(train) * 1e3
        losses = [r["loss"] for r in train]
        run_ok = (len(train) == steps and all(np.isfinite(losses))
                  and all(r["launches"] == want for r in ranks)
                  and ranks[0]["metrics"]["count"] == SPATIAL_OPTIONS_EVAL
                  and not any(r["routes"]["fwd_thread"] or r["routes"]["bwd_thread"]
                              for r in ranks))
        emit("spatial_448_options", grid="D1xS2", backend=backend,
             cards="0 (both ranks)" if card == 0 else "0, 1", image_size=SPATIAL_SIZE,
             batch=batch, micro_batch=batch // 2, remat="blocks", grad_accum_steps=2,
             autoaugment="device v0", data=f"{SPATIAL_OPTIONS_IMAGES} JPEGs of "
             f"{FGVC_LONG_SIDE}^2", dtype="bf16", steps=steps, losses=losses,
             step_ms=walls.tolist(), mean_step_ms=float(walls.mean()),
             step_ms_min=float(walls.min()), peak_gib_per_rank=[r["peak_gib"] for r in ranks],
             aa_per_rank=aa_ms[batch], launches_per_rank=[r["launches"] for r in ranks],
             expected=want, routes=ranks[0]["routes"], eval=ranks[0]["metrics"],
             seconds=seconds, card=smi, ok=run_ok)
        ok = ok and run_ok
        paths[f"spatial_448_options_{backend}_b{batch}"] = ranks[0]["launches"]
    if cards < 2 and "nccl" in backends:
        emit("spatial_448_options", backend="nccl", ran=False, reason=f"{cards} card")
    emit("spatial_448_options", part="total", seconds=time.perf_counter() - t_start, ok=ok)
    if not ok:
        raise AssertionError("spatial_448_options phase failed")
    return paths


def _eval_batches(count):
    return -(-int(count) // DRIVE_BATCH)


def drive_convergence_phase(smi, tmp):
    """``axcnn_torch.drives.convergence`` at the reference's full budget
    (config 4 at full width, b64, 224x224, bf16, 300 steps on 4 x 64
    generated JPEGs through the native loader with AutoAugment v0), its bars
    asserted by the drive: raw top-1 >= 90, EMA >= raw - 1. The kernels
    3 + 3 + 9 + 9 times a step, plus 3 BlurPool forwards an eval batch."""
    from axcnn_torch.drives import convergence

    lines = []
    _zero_counts()
    t0 = time.perf_counter()
    summary = convergence.run(os.path.join(tmp, "drive_convergence"), device="cuda",
                              log=lines.append)
    seconds = time.perf_counter() - t0
    counts, routes = _counts(), dict(kblur.ROUTES)
    steps, train = summary["steps"], summary["train"]
    evals = sum(_eval_batches(summary[k]["count"]) for k in ("raw", "ema"))
    want = _launches(3 * steps + 3 * evals, 3 * steps, 9 * steps)
    ok = (counts == want and train["all_finite"] and summary["native_loader"]
          and not (routes["fwd_thread"] or routes["bwd_thread"]))
    emit("drive_convergence", model="assemble_resnet50 (config 4, bn_momentum 0.9)",
         batch=summary["batch"], image_size=summary["image_size"], dtype="bf16", steps=steps,
         raw=summary["raw"], ema=summary["ema"], bars_asserted=True,
         train_s=train["seconds"], median_step_ms=train["median_step_ms"],
         logged_loss=train["logged_loss"], native_loader=summary["native_loader"],
         launches_per_step={k: (v - (3 * evals if k == "fwd" else 0)) / steps
                            for k, v in counts.items()},
         launches=counts, expected=want, routes=routes, seconds=seconds, card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"drive_convergence: launches {counts}, expected {want}")
    return counts


# the training CLI of a KD-drive leg, counting the kernels' launches and the
# teacher it loaded into <model_dir>/kernel_counts.json
_COUNTING_CLI = """
import json, os, sys
from axcnn_torch.kernels import blurpool as kblur, dropblock as kdrop
from axcnn_torch.train import loop
loaded = []
_load = loop._load_teacher
def _counted(cfg, device):
    teacher = _load(cfg, device)
    loaded.append(teacher is not None)
    return teacher
loop._load_teacher = _counted
from axcnn_torch.cli import main_classification
main_classification.main(sys.argv[1:])
model_dir = next(a.split("=", 1)[1] for a in sys.argv if a.startswith("--runtime.model_dir="))
with open(os.path.join(model_dir, "kernel_counts.json"), "w") as f:
    json.dump({"counts": {"fwd": kblur.LAUNCHES, "bwd": kblur.BWD_LAUNCHES,
                          "mask": kdrop.LAUNCHES, "apply": kdrop.APPLY_LAUNCHES,
                          "apply_bwd": kdrop.APPLY_BWD_LAUNCHES, "fused": kdrop.FUSED_LAUNCHES,
                          "fused_window": kdrop.FUSED_WINDOW_LAUNCHES},
               "teacher_loaded": loaded}, f)
"""


def _add(total, counts):
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def drives_cut_phase(smi, tmp):
    """``convergence_full``, ``ablation`` and ``kd`` through their entry
    points (``main(argv)``) on the card, at full width, 224x224, b64, bf16,
    cut to ``CUT``'s steps and image counts, the bars not asserted. Each leg
    runs (the ablation restores ``convergence_full``'s pretrain), every
    logged loss is finite, each summary has the reference's keys, and the
    kernels launch as each leg's steps and evals say: R50 legs 3 + 3 + 9 + 9
    a step, R152 students 3 + 3 + 39 + 39, the KD student 3 more BlurPool
    forwards a step for its teacher, 3 a forward in every eval batch. The KD
    legs are subprocesses (the literal CLI), run through ``_COUNTING_CLI``:
    only the KD student loaded a teacher."""
    from axcnn_torch.drives import ablation, common, convergence_full, kd

    c = CUT
    root = os.path.join(tmp, "drives_cut")
    out, result, total = io.StringIO(), {}, {}
    t_start = time.perf_counter()

    def drive(name, module, argv, want):
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            summary = module.main([*argv, "--no-check"])
        counts = _counts()
        missing = common.missing_keys(summary, module.SUMMARY_KEYS)
        result[name] = dict(summary=summary, seconds=time.perf_counter() - t0, launches=counts,
                            expected=want, missing_keys=missing)
        if missing or counts != want:
            raise AssertionError(f"drives_cut {name}: missing {missing}, launches {counts}, "
                                 f"expected {want}")
        return summary, counts

    full_steps = c["pretrain_steps"] + 2 * c["ft_steps"]
    evals = 2 * _eval_batches(10 * c["n_eval"]) + 2 * _eval_batches(4 * c["ft_n_eval"])
    full, counts = drive("convergence_full", convergence_full, [
        root, f"--steps={c['pretrain_steps']}", f"--ft_steps={c['ft_steps']}",
        f"--n_train={c['n_train']}", f"--n_eval={c['n_eval']}",
        f"--ft_n_train={c['ft_n_train']}", f"--ft_n_eval={c['ft_n_eval']}"],
        _launches(3 * full_steps + 3 * evals, 3 * full_steps, 9 * full_steps))
    total = _add(total, counts)
    records = full["train"]
    assert all(records[k]["all_finite"] for k in ("pretrain", "warm", "cold")), records

    sets = len(c["corruptions"]) * len(c["severities"])
    asm_evals = (1 + sets) * _eval_batches(10 * c["n_eval"])
    abl, counts = drive("ablation", ablation, [
        root, f"--steps={c['pretrain_steps']}", f"--n_train={c['n_train']}",
        f"--n_eval={c['n_eval']}", f"--corruptions={','.join(c['corruptions'])}",
        f"--severities={','.join(map(str, c['severities']))}"],
        _launches(3 * asm_evals, 0, 0))  # the vanilla R50 runs no hand-written kernel
    total = _add(total, counts)
    assert abl["train"]["assembled"] is None, "the ablation did not restore the pretrain"
    assert abl["train"]["vanilla"]["all_finite"], abl["train"]

    def counting(args):
        return [sys.executable, "-c", _COUNTING_CLI, *args]

    t_steps, s_steps = c["teacher_steps"], c["student_steps"]
    k_evals = _eval_batches(50 * c["scale_n_eval"])
    with mock.patch.object(common, "cli_command", counting):
        kd_summary, epilogue = drive("kd", kd, [
            str(s_steps), os.path.join(root, "kd"), str(c["n_subset"]),
            f"--teacher_steps={t_steps}",
            f"--n_train={c['scale_n_train']}", f"--n_eval={c['scale_n_eval']}",
            f"--scale_root={os.path.join(root, 'scale')}"],
            _launches(3 * 2 * k_evals, 0, 0))  # the epilogue's raw and EMA evals
    total = _add(total, epilogue)
    legs = {}
    for path in sorted(glob.glob(os.path.join(root, "kd", "*", "kernel_counts.json"))):
        with open(path) as f:
            legs[os.path.basename(os.path.dirname(path))] = json.load(f)
    leg_want = {"teacher": (_launches(3 * t_steps + 3 * k_evals, 3 * t_steps, 9 * t_steps),
                            [False])}
    for tag in ("control", "kd", "control_lr0.2"):
        fwd = 3 * s_steps * (2 if tag == "kd" else 1) + 3 * k_evals
        leg_want[tag] = (_launches(fwd, 3 * s_steps, 39 * s_steps), [tag == "kd"])
    by_tag = {}
    for name, got in legs.items():
        tag = "teacher" if name == "teacher" else next(
            t for t in ("control_lr0.2", "control", "kd") if name.startswith(f"student_{t}_"))
        by_tag[tag] = got
        total = _add(total, got["counts"])
    losses = kd_summary["train_loss"]
    ok = (sorted(by_tag) == sorted(leg_want)
          and all((by_tag[t]["counts"], by_tag[t]["teacher_loaded"]) == (w[0], w[1])
                  for t, w in leg_want.items())
          and sorted(losses) == sorted(leg_want)
          and all(rec and all(np.isfinite([v for _, v in rec])) for rec in losses.values()))
    result["kd"].update(legs=by_tag, expected_legs={t: w[0] for t, w in leg_want.items()})
    emit("drives_cut", cut=c, bars_asserted=False, width=1.0, batch=DRIVE_BATCH, image_size=224,
         dtype="bf16", drives=result, launches=total, seconds=time.perf_counter() - t_start,
         card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"drives_cut kd legs: {by_tag}, expected {leg_want}")
    return total


def _cut_more_sets(c=CUT_MORE):
    """The training images of each cut set of ``drives_cut_more`` (drives_cut's
    50-class set and pretrain set, the finetune sets, the 1k set)."""
    from axcnn_torch.drives.data import SCALE_CLASSES, classes_1k

    n = c["ft_n_per_class"]
    return {"scale": SCALE_CLASSES * CUT["scale_n_train"], "finetune_colors": 4 * n,
            "finetune_textures": 3 * n, "1k": classes_1k() * c["k1_n_train"]}


def _cut_more_launches(c=CUT_MORE):
    """The launches each leg of ``drives_cut_more`` makes, by the drives'
    steps and eval batches: {leg: counts}; the CLI legs ``1k_cli`` and
    ``bl_cli`` in their own processes."""
    from axcnn_torch.drives import bl
    from axcnn_torch.drives.data import SCALE_CLASSES, classes_1k

    def step(n, evals=0):
        return _launches(3 * n + 3 * evals, 3 * n, 9 * n)

    scale_evals = 2 * _eval_batches(SCALE_CLASSES * CUT["scale_n_eval"])
    n = c["ft_n_per_class"]
    ft_evals = _eval_batches(4 * n) + 2 * _eval_batches(3 * n)
    k1_evals = _eval_batches(classes_1k() * c["k1_n_eval"])
    warm, timed = c["int8_iters"]
    # 4 evals and the agreement's 2 policies over the pretrain's held-out
    # set, then 2 policies x 3 served batches
    int8_forwards = (4 + 2) * _eval_batches(10 * CUT["n_eval"]) + 2 * 3 * (warm + timed)
    return {"scale": step(c["scale_steps"], scale_evals),
            "finetune": step(3 * c["ft_steps"], ft_evals),
            "1k_cli": step(c["k1_steps"], k1_evals),
            "1k": _launches(3 * 2 * k1_evals, 0, 0),  # the epilogue's raw and EMA evals
            "bl_cli": _launches(0, 0, 0),  # bl_resnet50 has no BlurPool or DropBlock
            # the assembled probe (its warm-up included); BL's and the ablation's none
            "bl": step(bl.PROBE_WARMUP + c["bl_probe_steps"]),
            "int8": _launches(3 * int8_forwards, 0, 0)}


def drives_cut_more_phase(smi, tmp):
    """``convergence_scale``, ``finetune``, ``convergence_1k``, ``bl`` and
    ``int8_serving`` through their entry points (``main(argv)``) on the
    card, at full width, 224x224, b64, bf16, cut to ``CUT_MORE``, the bars
    not asserted, on ``drives_cut``'s root: its 50-class set (the scale and
    Big-Little drives) and ``convergence_full``'s pretrain (the int8 drive).
    Every leg runs, every logged loss is finite, each summary has the
    reference's keys, the 1k set's 1,000 held-out images are all evaluated
    and its stored labels pass the loader's check under the 1001-way head
    with ``label_offset=1``, and the kernels launch as each leg's steps and
    evals say (``_cut_more_launches``). The CLI legs (1k, Big-Little) run
    through ``_COUNTING_CLI``."""
    from axcnn_torch.data.tfrecord import TFRecordReader, list_shards, parse_example
    from axcnn_torch.drives import (bl, common, convergence_1k, convergence_scale, finetune,
                                    int8_serving)

    c = CUT_MORE
    root = os.path.join(tmp, "drives_cut")
    scale_root = os.path.join(root, "scale")
    sets = _cut_more_sets(c)
    small = {k: v for k, v in sets.items() if v < DRIVE_BATCH}
    if small:
        raise AssertionError(f"drives_cut_more: sets that cannot fill a batch: {small}")
    want = _cut_more_launches(c)
    out, result, total = io.StringIO(), {}, {}
    t_start = time.perf_counter()

    def drive(name, module, argv):
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            summary = module.main([*argv, "--no-check"])
        counts = _counts()
        missing = common.missing_keys(summary, module.SUMMARY_KEYS)
        result[name] = dict(summary=summary, seconds=time.perf_counter() - t0, launches=counts,
                            expected=want[name], missing_keys=missing)
        if missing or counts != want[name]:
            raise AssertionError(f"drives_cut_more {name}: missing {missing}, launches {counts}, "
                                 f"expected {want[name]}")
        return summary, counts

    def cli_leg(name, model_dir):
        with open(os.path.join(model_dir, "kernel_counts.json")) as f:
            counts = json.load(f)["counts"]
        result[name] = dict(launches=counts, expected=want[name])
        if counts != want[name]:
            raise AssertionError(f"drives_cut_more {name}: launches {counts}, "
                                 f"expected {want[name]}")
        return counts

    def finite(losses):
        return bool(losses) and all(np.isfinite([v for _, v in losses]))

    scale, counts = drive("scale", convergence_scale, [
        scale_root, f"--steps={c['scale_steps']}", f"--n_train={CUT['scale_n_train']}",
        f"--n_eval={CUT['scale_n_eval']}"])
    total = _add(total, counts)
    assert scale["train"]["all_finite"] and finite(scale["train"]["logged_loss"]), scale["train"]

    ft_root = os.path.join(root, "finetune")
    ft, counts = drive("finetune", finetune, [
        ft_root, f"--steps={c['ft_steps']}", f"--n_per_class={c['ft_n_per_class']}"])
    total = _add(total, counts)
    for run_dir in ("run_a", "run_b_ft", "run_b_cold"):
        losses = common.train_losses(os.path.join(ft_root, run_dir))
        assert finite(losses), (run_dir, losses)

    def counting(args):
        return [sys.executable, "-c", _COUNTING_CLI, *args]

    k1_root = os.path.join(root, "k1")
    with mock.patch.object(common, "cli_command", counting):
        k1, counts = drive("1k", convergence_1k, [
            str(c["k1_steps"]), k1_root, str(c["k1_n_train"]), f"--n_eval={c['k1_n_eval']}"])
        total = _add(total, counts)
        k1_dir = os.path.join(k1_root, f"run_{c['k1_steps']}_n{c['k1_n_train']}")
        total = _add(total, cli_leg("1k_cli", k1_dir))
        bl_root = os.path.join(root, "bl")
        bl_summary, counts = drive("bl", bl, [
            bl_root, f"--steps={c['bl_steps']}", f"--probe_steps={c['bl_probe_steps']}",
            f"--n_train={CUT['scale_n_train']}", f"--n_eval={CUT['scale_n_eval']}",
            f"--scale_root={scale_root}"])
        total = _add(total, counts)
        total = _add(total, cli_leg("bl_cli", os.path.join(bl_root, "bl_resnet50")))
    assert finite(k1["train_loss"]) and finite(bl_summary["train_loss"]), (k1, bl_summary)
    # the 1k set: every held-out image evaluated, and the stored labels 0..999
    # in range of the 1001-way head with label_offset=1
    k1_data = os.path.join(k1_root, f"rec_{c['k1_n_train']}_{c['k1_n_eval']}")
    info = convergence_1k.dataset_info(sets["1k"], 1000 * c["k1_n_eval"])
    loader = common.native_loader(k1_data, info, batch=DRIVE_BATCH, image_size=224, train=True)
    labels = {}
    for split in ("train", "validation"):
        labels[split] = np.sort([int(parse_example(bytes(p))["image/class/label"][0])
                                 for sh in list_shards(k1_data, split)
                                 for p in TFRecordReader(sh)])
        loader._check_labels({"labels": labels[split]})
    k1_ok = (k1["eval_count"] == 1000 and k1["cli_eval"]["count"] == 1000
             and np.array_equal(labels["validation"], np.arange(1000))
             and np.array_equal(labels["train"], np.arange(1000)))

    warm, timed = c["int8_iters"]
    i8, counts = drive("int8", int8_serving, [root, f"--warmup_iters={warm}",
                                              f"--iters={timed}"])
    total = _add(total, counts)
    i8_ok = all(np.isfinite(i8[k]) for k in int8_serving.SUMMARY_KEYS)
    ok = k1_ok and i8_ok
    emit("drives_cut_more", cut=c, sets=sets, bars_asserted=False, width=1.0,
         batch=DRIVE_BATCH, image_size=224, dtype="bf16", drives=result,
         k1_labels_ok=k1_ok, launches=total, seconds=time.perf_counter() - t_start,
         card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"drives_cut_more: 1k {k1_ok}, int8 {i8_ok}")
    return total


# acceptance_cut and kd_diag_cut (after drives_cut, on its root): the steps
# of each card training leg, the KD probe's batch (the cut set holds 100
# held-out images, fewer than two batches of 64) and the sweep's steps
# kd_ranks: config 5's Gloo CPU ranks: more than the set's 2 validation
# files, so its eval deals records out to ranks as the drive's 8 do, and a
# divisor of its batch of 16 (on an H100 machine's 8-core host the drive's 8
# took 75 s to start and ~21 s a step, mostly the gradient's all-reduce; 2
# took 52 s and 6 s: ``profile_step --what=kd_ranks``)
ACCEPT_CUT = dict(steps=10, probe_batch=32, sweep_steps=3, kd_ranks=4)
# the entry point of a drive's leg (a module's ``main(args)``), counting the
# kernels' launches into a JSON file: python -c _COUNTING_MAIN PATH MODULE ARGS...
_COUNTING_MAIN = """
import importlib, json, sys
from axcnn_torch.kernels import blurpool as kblur, dropblock as kdrop
path, module, *args = sys.argv[1:]
try:
    code = importlib.import_module(module).main(args)
finally:
    with open(path, "w") as f:
        json.dump({"fwd": kblur.LAUNCHES, "bwd": kblur.BWD_LAUNCHES, "mask": kdrop.LAUNCHES,
                   "apply": kdrop.APPLY_LAUNCHES, "apply_bwd": kdrop.APPLY_BWD_LAUNCHES,
                   "fused": kdrop.FUSED_LAUNCHES, "fused_window": kdrop.FUSED_WINDOW_LAUNCHES}, f)
sys.exit(code if isinstance(code, int) else 0)
"""
# the acceptance drive's legs, in the order it runs them
ACCEPT_LEGS = ("config4", "config4-export", "config3", "config2-setup", "config2",
               "config1-setup", "config1", "config5")


class _CountingCommands:
    """Patches ``drives.common``'s command functions so that each leg runs
    through ``_COUNTING_MAIN`` with a counts file of its own, in call order."""

    def __init__(self, directory):
        self.directory, self.paths = directory, []
        os.makedirs(directory, exist_ok=True)

    def _command(self, module, args):
        path = os.path.join(self.directory, f"{len(self.paths)}.json")
        self.paths.append(path)
        return [sys.executable, "-c", _COUNTING_MAIN, path, module, *args]

    def patches(self):
        from axcnn_torch.drives import common

        return [mock.patch.object(common, "cli_command", lambda args: self._command(
                    "axcnn_torch.cli.main_classification", args)),
                mock.patch.object(common, "recipe_command", lambda recipe, args: self._command(
                    "axcnn_torch.cli.recipes", [recipe, *args])),
                mock.patch.object(common, "predict_command", lambda args: self._command(
                    "axcnn_torch.cli.predict", args))]

    def counts(self):
        out = []
        for path in self.paths:
            with open(path) as f:
                out.append(json.load(f))
        return out


def _accept_launches(c=ACCEPT_CUT):
    """The launches of each leg of ``acceptance_cut`` and ``kd_diag_cut``
    on drives_cut's 50-class set (100 held-out images): {leg: counts}. An
    eval batch is 3 BlurPool forwards, as is a served forward (the export's
    batch of 8 holds the probe); config 1 runs no hand-written kernel, and
    its predict and config 5 run on the CPU."""
    from axcnn_torch.drives.data import SCALE_CLASSES

    held_out = SCALE_CLASSES * CUT["scale_n_eval"]
    evals = _eval_batches(held_out)  # at the training batch, 64
    steps, sweep = c["steps"], c["sweep_steps"]
    none = _launches(0, 0, 0)
    return {"config4": _launches(3 * steps + 3 * evals, 3 * steps, 9 * steps),
            "config4-export": _launches(3, 0, 0),
            "config3": _launches(3 * -(-held_out // 256), 0, 0),
            "config2-setup": _launches(3 * steps + 3 * evals, 3 * steps, 0),  # no DropBlock
            "config2": _launches(3 * -(-held_out // 128), 0, 0),
            "config1-setup": none, "config1": none, "config5": none,
            # the teacher's 5 forwards: 2 clean, 2 augmented, 1 mixed batch
            "kd_probe": _launches(3 * 5, 0, 0),
            # an R152 student with its R50 teacher, then its eval
            **{f"sweep_{tag}": _launches(3 * 2 * sweep + 3 * evals, 3 * sweep, 39 * sweep)
               for tag in ("half_lr", "alpha.3", "temp2")}}


def _top5_ok(top5):
    probs = [p for _, p in top5]
    return (len(top5) == 5 and all(0.0 <= p <= 1.0 for p in probs)
            and probs == sorted(probs, reverse=True) and sum(probs) <= 1.0 + 1e-4)


def acceptance_cut_phase(smi, tmp):
    """``axcnn_torch.drives.acceptance`` through its entry point on
    drives_cut's 50-class set (12 train and 2 held-out images a class), the
    card legs at full width, 224x224, b64, bf16, ``ACCEPT_CUT['steps']``
    steps each, config 3 at b256, config 2's eval at b128, config 5 on
    ``ACCEPT_CUT['kd_ranks']`` Gloo CPU ranks at 64x64, b16, 3 steps, more
    ranks than the set's validation files (checked), so its eval reads every
    file on every rank and deals the records out; the bars not asserted.
    Every leg exits 0, the export serves five
    well-formed top-5 entries, configs 3 and 2 count the 100 held-out
    images, config 1's five posteriors are well-formed, config 5's losses
    are finite with its eval present, and each leg (run through
    ``_COUNTING_MAIN``) launches the kernels as its steps, evals and
    forwards say (``_accept_launches``)."""
    from axcnn_torch.data.tfrecord import list_shards
    from axcnn_torch.drives import acceptance, common
    from axcnn_torch.drives.data import make_scale_set

    c = ACCEPT_CUT
    root = os.path.join(tmp, "drives_cut")
    data_dir, info = make_scale_set(os.path.join(root, "scale"), n_train=CUT["scale_n_train"],
                                    n_eval=CUT["scale_n_eval"], seed=0, log=lambda *a: None)
    eval_files = len(list_shards(data_dir, info.eval_prefix))
    counting = _CountingCommands(os.path.join(tmp, "acceptance_counts"))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in counting.patches():
            stack.enter_context(p)
        with contextlib.redirect_stdout(out):
            summary = acceptance.main([
                os.path.join(root, "acceptance"), f"--steps={c['steps']}",
                f"--n_train={CUT['scale_n_train']}", f"--n_eval={CUT['scale_n_eval']}",
                f"--scale_root={os.path.join(root, 'scale')}", f"--kd_ranks={c['kd_ranks']}",
                "--no-check"])
    seconds = time.perf_counter() - t0
    got = dict(zip(ACCEPT_LEGS, counting.counts()))
    want = {k: v for k, v in _accept_launches(c).items() if k in ACCEPT_LEGS}
    missing = common.missing_keys(summary, acceptance.SUMMARY_KEYS)
    c1, c5, held_out = summary["config1"], summary["config5"], summary["held_out"]
    checks = {"legs": list(got) == list(ACCEPT_LEGS), "launches": got == want,
              "summary_keys": not missing,
              "export_top5": _top5_ok(summary["config4"]["export_top5"]),
              "counts": summary["config3"]["count"] == summary["config2"]["count"] == held_out == 100,
              "config1_top5": len(c1["top5"]) == 5 and all(_top5_ok(t) for t in c1["top5"]),
              "config5": c5["steps"] > 0 and c5["finite"] and c5["eval_count"] == held_out,
              # the eval of more ranks than files (data/pipeline.py) ran
              "config5_ranks_outnumber_eval_files": c["kd_ranks"] > eval_files}
    ok = all(checks.values())
    emit("acceptance_cut", cut=c, bars_asserted=False, width=1.0, batch=DRIVE_BATCH,
         image_size=224, dtype="bf16", summary=summary,
         config3_top1_diff=summary["config3"]["top1_diff"], launches=got, expected=want, checks=checks,
         missing_keys=missing, seconds=seconds, card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"acceptance_cut: {checks}")
    total = {}
    for counts in got.values():
        total = _add(total, counts)
    return total


def kd_diag_cut_phase(smi, tmp):
    """``axcnn_torch.drives.kd_probe`` (batch ``ACCEPT_CUT['probe_batch']``)
    on drives_cut's KD teacher and 50-class set, then
    ``axcnn_torch.drives.kd_sweep`` at ``ACCEPT_CUT['sweep_steps']`` student
    steps a leg (full width, 224x224, b64, bf16) on its root, through their
    entry points, the probe's bar not asserted: each statistic finite, the
    sweep's three legs with their hyperparameters, every logged loss finite,
    and the launches of the probe (5 teacher forwards) and of each sweep leg
    (through ``_COUNTING_MAIN``) as ``_accept_launches`` says."""
    from axcnn_torch.drives import common, kd_probe, kd_sweep

    c = ACCEPT_CUT
    root = os.path.join(tmp, "drives_cut")
    kd_root, scale_root = os.path.join(root, "kd"), os.path.join(root, "scale")
    sizes = [f"--n_train={CUT['scale_n_train']}", f"--n_eval={CUT['scale_n_eval']}",
             f"--scale_root={scale_root}"]
    want = _accept_launches(c)
    out = io.StringIO()
    t0 = time.perf_counter()
    _zero_counts()
    with contextlib.redirect_stdout(out):
        probe = kd_probe.main([kd_root, "--no-check", f"--batch={c['probe_batch']}", *sizes])
    probe_counts, probe_s = _counts(), time.perf_counter() - t0
    counting = _CountingCommands(os.path.join(tmp, "kd_sweep_counts"))
    t1 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in counting.patches():
            stack.enter_context(p)
        with contextlib.redirect_stdout(out):
            sweep = kd_sweep.main([str(c["sweep_steps"]), kd_root, *sizes])
    sweep_s = time.perf_counter() - t1
    tags = [tag for tag, _ in kd_sweep.LEGS]
    legs = dict(zip((f"sweep_{t}" for t in tags), counting.counts()))
    got = {"kd_probe": probe_counts, **legs}
    want = {k: want[k] for k in got}
    losses = {t: common.train_losses(os.path.join(kd_root, f"sweep_{t}_{c['sweep_steps']}"))
              for t in tags}
    checks = {"probe_finite": len(probe) == 5 and all(
                  np.isfinite(v) for s in probe.values() for v in s.values()),
              "sweep_legs": list(sweep) == tags and all(
                  sweep[t] == {**sweep[t], **hp} for t, hp in kd_sweep.LEGS),
              "sweep_finite": all(np.isfinite([sweep[t]["top1"], sweep[t]["loss"]]).all()
                                  for t in tags),
              "losses_finite": all(ls and np.isfinite([v for _, v in ls]).all()
                                   for ls in losses.values()),
              "launches": got == want}
    ok = all(checks.values())
    emit("kd_diag_cut", cut=c, bars_asserted=False, width=1.0, image_size=224, dtype="bf16",
         probe=probe, sweep=sweep, launches=got, expected=want, checks=checks,
         probe_s=probe_s, sweep_s=sweep_s, card=smi, ok=ok)
    if not ok:
        raise AssertionError(f"kd_diag_cut: {checks}")
    total = {}
    for counts in got.values():
        total = _add(total, counts)
    return total


def drives_group(smi, tmp):
    """Phases 36 and 39-41 (each later one reads drives_cut's root):
    drives_cut, then acceptance_cut in a process of its own beside
    drives_cut_more and kd_diag_cut in this one: {path: its launch counts}."""
    paths = {"drives_cut": drives_cut_phase(smi, tmp)}
    accept = _Group(smi, tmp, "acceptance")
    try:
        paths["drives_cut_more"] = drives_cut_more_phase(smi, tmp)
        paths["kd_diag_cut"] = kd_diag_cut_phase(smi, tmp)
    except BaseException:
        accept.stop()
        raise
    paths.update(accept.finish())
    return paths


_GROUPS = {"drives": drives_group,
           "acceptance": lambda smi, tmp: {"acceptance_cut": acceptance_cut_phase(smi, tmp)}}
_GROUP_MAIN = """
import json, sys
import chip_smoke
name, smi, tmp, out = sys.argv[1:]
paths = chip_smoke._GROUPS[name](smi, tmp)
with open(out, "w") as f:
    json.dump(paths, f)
"""


class _Group:
    """``_GROUPS[name](smi, tmp)`` in a process of its own, started now;
    ``finish()`` waits for it, prints its lines and returns its paths'
    launch counts; ``stop()`` ends it (the script stops every process it
    starts). With ``own_session`` the process leads a process group of its
    own, which holds everything it starts (a nested group, its CLI legs,
    their ranks), and both end by ending what is left of that group."""

    def __init__(self, smi, tmp, name, own_session=False):
        self.own_session = own_session
        self.name, self.out = name, os.path.join(tmp, f"{name}_paths.json")
        self.log_path = os.path.join(tmp, f"{name}_output.log")
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _GROUP_MAIN, name, smi, tmp, self.out],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=self.log,
            stderr=subprocess.STDOUT, env={**os.environ, "CHIP_SMOKE_T0": repr(_T0)},
            start_new_session=own_session)

    def stop(self):
        if self.own_session:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGKILL)
        elif self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()

    def finish(self):
        self.proc.wait()
        self.stop()
        with open(self.log_path) as f:
            lines = f.read().splitlines()
        for line in lines:
            print(line, file=sys.stdout if line.startswith('{"phase"') else sys.stderr,
                  flush=True)
        if self.proc.returncode:
            raise AssertionError(f"the {self.name} phases failed (exit {self.proc.returncode}): "
                                 + "\n".join(lines[-40:]))
        with open(self.out) as f:
            return json.load(f)


# each measurement module's smallest setting, and the rows' keys that must be
# finite numbers (the data directory is the phase's own)
MEASURE_ARGV = {
    "latency_bench": ["--batches=1,8", "--dtypes=bf16", "--models=assembled", "--warmup=2",
                      "--timed=10"],
    "remat_bench": ["--batches=16", "--modes=none,blocks", "--warmup=1", "--timed=3"],
    "capacity_probe": ["--batches=8", "--modes=blocks"],
    "loader_bench": ["--n_images=512", "--batches=2"],
    "echo_bench": ["--n_images=512", "--factors=2", "--aa=host", "--warmup=1", "--timed=3",
                   "--windows=1"],
    "opt_experiments": ["--batches=16", "--cases=batch"],
}
MEASURE_KEYS = {
    "latency_bench": ("sync_ms", "pipelined_ms", "pipelined_img_s"),
    "remat_bench": ("ms", "img_s", "gflop", "model_gflop", "gb", "tflops", "mfu", "gbps",
                    "hbm_util", "peak_gib", "loss"),
    "capacity_probe": ("peak_allocated_gib", "peak_reserved_gib", "card_gib", "loss"),
    "loader_bench": ("stub_producer_ips", "stub_with_marshal_ips", "framing_stream_ips",
                     "seed_us_per_record", "real_ips_workers1", "real_ips_workers2",
                     "real_ips_workers4", "serial_us_per_record", "decode_us_per_record_1core",
                     "projected_scaling_limit_cores", "multiproducer_stub_ips_p2",
                     "consumer_us_per_record", "consumer_scaling_limit_cores_vs_decode",
                     "real_to_card_ips_workers4", "host_cores", "affinity_cores"),
    "echo_bench": ("echo2", "steps", "host_batches", "host_cores", "affinity_cores"),
    "opt_experiments": ("step_ms", "images_per_sec", "gflop", "tflops", "mfu"),
}


def _measure_launches():
    """Each module's launches at ``MEASURE_ARGV``: a step's (warm-up, timed
    and counted) or a forward's counts times their number. R50 (remat
    ``none``) 3 + 3 + 9 + 9 a step, ``blocks`` 6 (3 by the replay) + 3 + 9 +
    9; config 5 with ``blocks``: the student's 6 + 3, the teacher's 3, 39 +
    39 a step, 2 steps; latency 2 + 10 + 10 forwards a batch, 3 each;
    remat and opt_experiments count one step more than they time."""
    per = lambda n, fwd, bwd, sites: _launches(n * fwd, n * bwd, n * sites)  # noqa: E731
    plain, rem = per(1 + 3 + 1, 3, 3, 9), per(1 + 3 + 1, 6, 3, 9)
    return {"latency_bench": per(2 * (2 + 10 + 10), 3, 0, 0),
            "remat_bench": {k: plain[k] + rem[k] for k in plain},
            "capacity_probe": per(2, 6 + 3, 3, 39),
            "loader_bench": _launches(0, 0, 0),
            "echo_bench": per(1 + 3, 3, 3, 9),
            "opt_experiments": per(3 + 10 + 1, 3, 3, 9)}


def measurement_scripts_phase(smi, tmp):
    """Phase 42: {module: its launch counts}."""
    paths = {}
    for name, argv in MEASURE_ARGV.items():
        module = importlib.import_module(f"axcnn_torch.cli.{name}")
        if name in ("loader_bench", "echo_bench"):
            argv = argv + [f"--data_dir={os.path.join(tmp, 'measure_data')}"]
        out = io.StringIO()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = module.main(argv)
        torch.cuda.synchronize()
        seconds, counts = time.perf_counter() - t0, _counts()
        rows = [json.loads(line) for line in out.getvalue().splitlines()]
        finite = all(isinstance(r.get(k), (int, float)) and np.isfinite(r[k])
                     for r in rows for k in MEASURE_KEYS[name])
        want = _measure_launches()[name]
        ok = (code == 0 and bool(rows) and finite and counts == want
              and all(r["card"] == smi for r in rows)
              and (name != "echo_bench" or rows[0]["host_batches"] == 2)
              and (name != "capacity_probe" or rows[0]["fits_card"]))
        emit("measurement_scripts", module=name, argv=argv, rows=rows, launches=counts,
             expected=want, seconds=seconds, card=smi, ok=ok)
        if not ok:
            raise AssertionError(f"measurement_scripts {name} failed: exit {code}, "
                                 f"launches {counts}, expected {want}, rows {rows}")
        paths[f"measure_{name}"] = counts
    return paths


ROOFLINE_ARGV = ["--untraced=3"]  # profile_roofline's, beside --mode and --calibration
ROOFLINE_WALL_LIMIT = 1.05  # a measured wall at most this share of the data sheet's
# the accountant's kernel names -> ``_counts`` keys
ROOFLINE_KERNELS = {"blur_pool3_s2_fwd": "fwd", "blur_pool3_s2_bwd": "bwd",
                    "dropblock_mask": "mask", "dropblock_apply": "apply",
                    "dropblock_apply_bwd": "apply_bwd", "dropblock_fused": "fused",
                    "dropblock_fused_window": "fused_window"}


def _roofline_bytes(mode):
    """Each hand-written kernel's bytes a step of ``mode`` (sorted): the
    BlurPool sites' (``SLICE_SHAPES``) and, training, the 9 DropBlock sites'
    (6 at 14x14x1024, 3 at 7x7x2048), as ``kernel_time`` bounds them."""
    blur = sorted(_blur_bytes(*shape) for shape in SLICE_SHAPES)
    if mode == "serve":
        return {"fwd": blur}
    sites = [s for s in APPLY_TIME_SHAPES for _ in range(6 if s[1] == 14 else 3)]
    return {"fwd": blur, "bwd": blur, "fused": sorted(_fused_bytes(*s) for s in sites),
            "apply_bwd": sorted(_apply_bytes(*s) for s in sites)}


def _main_rows(module, argv):
    """``module.main(argv)`` in this process: (exit code, its JSON rows)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = module.main(argv)
    torch.cuda.synchronize()
    return code, [json.loads(line) for line in out.getvalue().splitlines()
                  if line.startswith("{")]


def roofline_phase(smi, tmp):
    """Phase 43: the card's walls, then the per-op roofline of the R50 b128
    train step and serving forward, checked (module docstring)."""
    from axcnn_torch.cli import calibrate_roofline as cal
    from axcnn_torch.cli import profile_roofline as prof

    t0 = time.perf_counter()
    code, (walls,) = _main_rows(cal, [])
    checks = {"exit": code == 0, "card": walls["card"] == smi,
              "hbm_wall": 0 < walls["measured_hbm_gbps"]
              <= ROOFLINE_WALL_LIMIT * cal.SPEC_HBM_GBPS,
              "gemm_wall": 0 < walls["measured_tflops_bf16"]
              <= ROOFLINE_WALL_LIMIT * cal.SPEC_TFLOPS_BF16}
    emit("roofline", what="calibrate", row=walls, seconds=time.perf_counter() - t0,
         checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"roofline calibrate failed: {checks}, {walls}")
    calibration = os.path.join(tmp, "roofline_calibration.json")
    with open(calibration, "w") as f:
        f.write(json.dumps(walls) + "\n")
    for mode in ("train", "serve"):
        t0 = time.perf_counter()
        _zero_counts()
        code, (row,) = _main_rows(prof, [f"--mode={mode}", f"--calibration={calibration}",
                                         *ROOFLINE_ARGV])
        counts = _counts()
        per = _launches(3, 3, 9) if mode == "train" else _launches(3, 0, 0)
        runs = prof.WARMUP + (1 + row["chained_windows"]) * row["untraced"] + 2 * row["steps"]
        kernels = {ROOFLINE_KERNELS[name]: k for name, k in row["kernels"].items()}
        in_step = {key: kernels[key]["launches"] if key in kernels else 0 for key in per}
        checks = {
            "exit": code == 0, "card": row["card"] == smi,
            **{k: np.isfinite(row[k]) and 0 < row[k] <= ROOFLINE_WALL_LIMIT
               for k in ("mfu", "fraction_of_speed_of_light", "hbm_fraction_of_spec",
                         "hbm_fraction_of_measured")},
            "unattributed": row["unattributed_share"] <= 0.01,
            "flops": row["train_gflop_per_step"] == row["flop_counter_gflop_per_step"] > 0,
            "kernel_bytes": all(key in kernels and kernels[key]["bytes"]
                                == sorted(b * row["steps"]) for key, b
                                in _roofline_bytes(mode).items()),
            "windows": abs(row["busy_ratio"] - 1) <= 0.10,
            "launches_in_step": in_step == per,
            "launches": counts == {k: v * runs for k, v in per.items()}}
        summary = {k: row[k] for k in (
            "step_ms", "chained_ms", "smi", "synced_step_ms", "enqueue_ms",
            "train_gflop_per_step", "model_gflop_per_step",
            "gbytes_per_step", "tflops", "mfu", "hbm_gbps", "hbm_fraction_of_measured",
            "speed_of_light_ms", "fraction_of_speed_of_light", "speed_of_light_achievable_ms",
            "fraction_of_achievable", "plain_busy_ms", "plain_idle_share", "accounted_busy_ms",
            "busy_ratio",
            "unattributed_ms", "unattributed_share", "records_per_step",
            "device_events_per_step", "categories", "kernels")}
        emit("roofline", what="profile", mode=mode, **summary, top_ops=row["top_ops"][:5],
             launches=counts, seconds=time.perf_counter() - t0, checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"roofline {mode} failed: {checks}, launches {counts}, "
                                 f"kernels {row['kernels']}")


KERNELS = (  # (key, its launch counts, name, source, the TPU kernel it replaces)
    ("fwd", ("fwd",), "blur_pool3_s2_fwd", "axcnn_torch/csrc/blurpool.cu",
     "axcnn/pallas/blurpool.py:73"),
    ("bwd", ("bwd",), "blur_pool3_s2_bwd", "axcnn_torch/csrc/blurpool.cu",
     "axcnn/pallas/blurpool.py:123"),
    ("mask", ("mask",), "dropblock_mask", "axcnn_torch/csrc/dropblock.cu",
     "axcnn/pallas/dropblock.py:100"),
    ("apply", ("apply", "apply_bwd"), "dropblock_apply", "axcnn_torch/csrc/dropblock.cu",
     "axcnn/pallas/dropblock.py:135"),
    ("fused", ("fused",), "dropblock_fused", "axcnn_torch/csrc/dropblock.cu",
     "axcnn/pallas/dropblock.py:100"),
    ("fused_window", ("fused_window",), "dropblock_fused_window", "axcnn_torch/csrc/dropblock.cu",
     "axcnn/pallas/dropblock.py:100"),
)


def _timed_phases(smi, tmp):
    """The phases after ``throughput`` that time the program (and those
    whose output they read), in their order, but ``spatial_448``; they run
    alone: {path: its launch counts}, the runs the next phases read."""
    paths = {}
    train_dir = os.path.join(tmp, "train")
    paths["train"], single = train_phase(smi, train_dir)
    run_dir = os.path.join(tmp, "resume")
    paths["checkpoint"] = checkpoint_phase(smi, tmp)
    paths["resume"] = resume_phase(smi, run_dir)
    paths["serve_ckpt"] = serve_ckpt_phase(run_dir, tmp)
    paths["kd"] = kd_phase(smi, run_dir, os.path.join(tmp, "kd"))
    paths["remat"] = remat_phase(smi, tmp, single)
    bl_dir = os.path.join(tmp, "bl")
    paths["bl_train"] = bl_train_phase(smi, bl_dir)
    paths["bl_serve"] = bl_serve_phase(smi, bl_dir, tmp)
    paths["aa_train"] = aa_train_phase(smi, tmp, aa_time_phase(smi))
    paths["int8_serve"], _ = int8_serve_phase(smi)
    import_dir = os.path.join(tmp, "tf_import")
    paths["tf_import"], paths["tf_import_serve"], imported = tf_import_phase(
        smi, import_dir, tmp)
    paths["fgvc_finetune"] = fgvc_finetune_phase(smi, import_dir, imported, tmp)
    roofline_phase(smi, tmp)
    dp_nccl_phase(smi, tmp, single)
    return paths, train_dir


def _checked_phases(smi, tmp, train_dir):
    """The other phases after ``throughput``, in their order, beside the
    drive phases: they check results (``export``'s img/s and seconds,
    ``drive_convergence``'s walls and ``spatial_448_options``' Gloo walls
    are read under that load): {path: its launch counts}."""
    paths = {}
    train_parity_phase()
    paths["dp"] = dp_phase(smi, tmp)
    bl_parity_phase()
    paths["bl_assembled"] = bl_assembled_phase(smi)
    blur_sizes_phase()
    aa_parity_phase()
    int8_check_phase()
    paths["export"] = export_phase(smi, train_dir, tmp)
    paths["mce"] = mce_phase(smi, train_dir, tmp)
    paths["drive_convergence"] = drive_convergence_phase(smi, tmp)
    parity = spatial_parity_phase(smi, tmp)
    if parity is not None:
        paths["spatial_parity"] = parity
    torch.cuda.empty_cache()  # what this process holds, for the ranks the next two start
    paths["spatial_options_parity"] = spatial_options_parity_phase(smi, tmp)
    paths.update(spatial_448_options_phase(smi, tmp))
    paths.update(measurement_scripts_phase(smi, tmp))
    return paths


def main():
    smi = device_phase()
    build_phase()
    errs = kernel_check_phase()
    spatial_kernel_check_phase(errs)
    paths = {"big_sites": big_sites_phase(errs)}
    times = kernel_time_phase(errs)
    paths["serve"] = serve_phase()
    parity_phase()
    throughput_phase(smi)
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(spatial_448_phase(smi, tmp))
        torch.cuda.empty_cache()  # the 54 GiB it held
        timed, train_dir = _timed_phases(smi, tmp)
        paths.update(timed)
        torch.cuda.empty_cache()  # for the drive phases
        drives_dir = os.path.join(tmp, "drives_group")
        os.makedirs(drives_dir)
        group = _Group(smi, drives_dir, "drives", own_session=True)
        try:
            paths.update(_checked_phases(smi, tmp, train_dir))
        except BaseException:
            group.stop()
            raise
        paths.update(group.finish())
    for _, keys, name, *_ in KERNELS:
        for k in keys:
            if not any(counts[k] for counts in paths.values()):
                raise AssertionError(f"{name} ({k}) was never launched on the paths")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(counts[k] for counts in paths.values() for k in keys),
        "launches_by_path": {path: {k: counts[k] for k in keys} for path, counts in paths.items()},
        "max_abs_err": errs[key], **times[key]}
        for key, keys, name, source, replaces in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
