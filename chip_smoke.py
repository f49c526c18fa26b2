#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_unet_torch``) once on an NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure, each with its time:

1. Print the card's name and power limit; build the CUDA kernels from
   ``tpu_unet_torch/csrc`` and print the build time; build the native C++
   host tier (``tpu_unet_torch/native``) with g++ and self-check it against
   Pillow.
2. Run each of the four serving kernels and its plain PyTorch version on the
   card at the serving path's own shapes (``fused_conv3x3_scale_relu`` at
   all seven of the served forward's, ``fused_conv3x3_concat_scale_relu``
   at all four and one ragged case, ``fused_double_conv`` at all three,
   with its pooled output), in bf16 and fp32 (TF32 off), and compare them:
   max abs and relative error, the kernel's, the plain version's and one
   library call's times (CUDA events, median), and the kernel's bound (the
   least time the card could take for its bytes or operations). The
   folded-BN convs run on the tensor cores in bf16 and in fp32 (3xTF32)
   (``csrc/tc_conv.cu``; the double conv ``csrc/tc_double_conv.cu``, its
   pool from the same epilogue); a second call of each conv and of the pool
   (both dtypes) must repeat the first bit for bit, and the double conv's
   pooled output must equal ``max_pool2x2_plain`` of its own output. The
   pool runs at down3's output (the forward's one ``max_pool2x2``) and at
   level 0's width, exactly equal to its plain version, with its and the
   library call's time in a CUDA graph of 50 calls beside one call's.
   Beside the double conv's time, in both dtypes: two compositions, two
   ``fused_conv3x3_scale_relu`` calls (mid through device memory, tensor
   cores) and two cuDNN convs with a ReLU between.
   2b. The same for the three train kernels (conv3x3_fwd with its stats,
   conv3x3_dx, conv3x3_dw) at the train step's shapes, all three on the
   tensor cores (``csrc/tc_conv.cu``), in bf16 and in fp32 (3xTF32); a
   second call of each must repeat the first bit for bit. The main bf16
   conv3x3_fwd case's time is split (``fwd_split``): without and with its
   prologue and stats, against the library call.
   2c. ``im2col_conv3x3`` through its own entry point (no model path calls
   it), once in bf16 and once in fp32: each call one launch, on the tensor
   cores; then against its plain version in bf16 and in fp32 (3xTF32), each
   with bf16 and fp32 output; a second call must repeat the first bit for
   bit.
   2d. The train step's clip and RMSprop update (``csrc/multi_tensor.cu``:
   ``grad_sumsq``, ``scale_to_norm``, ``rmsprop_step``) on the full-width
   U-Net's 64 leaves, params fp32 (every train cell's) and bf16, against
   their plain versions: the squared sums and the norm within
   ``UPDATE_NORM_RTOL``, the scaling and the update bit for bit, a second
   call bit for bit the first; each call one launch count; the kernels'
   device time (``torch.profiler``), one call's and the plain version's
   time (CUDA events), and the bound (the bytes each moves at 3.35 TB/s).
3. Build the full-width flagship U-Net (base 64, ConvTranspose decoder, one
   class, 31.0M parameters) from a seed, with a non-trivial BN state, save it
   as a checkpoint and start the port's HTTP server on it in this process
   with ``--kernels cuda`` at its bf16 default.
4. POST synthetic 1918x1280 Carvana-like images (scale 0.5 -> 959x640), some
   at once so a micro-batch forms, and check each PNG mask against the plain
   forward (``--kernels torch``) on the card; check that every kernel was
   launched by the served forwards (the 8 single, 4 concat and 3 double
   convs of each on the tensor cores, the double convs writing 3 of the 4
   pools, one ``max_pool2x2``); print ``/metrics``; hold the fp32 forward
   to the plain one, with the same launches (``FP32_PER_FORWARD``: every
   conv on the tensor cores in 3xTF32, 3 pools from the double convs'
   epilogue, one ``max_pool2x2``); time the bf16 and fp32 forwards, kernels
   against plain.
5. Train the same full-width model from seed 0 with the port's
   ``make_train_step``: one step at 959x640 batch 4, in fp32 and in bf16,
   with ``kernels="cuda"`` against ``kernels=None`` (library convs under
   autograd), comparing loss, gradients, grad norm and BN running stats;
   then time the 572x572 batch-16 step of both, in bf16 and in fp32, with
   their peak memory. Every ``"cuda"`` step must launch each train kernel as
   often as the network has convs for it, every plain step none; every
   call of the three on the tensor cores, in bf16 and in fp32; every step
   the clip and update kernels once each, but the float64 reference step,
   which takes their plain versions (``mt.plain_versions()``). Then a
   ``torch.profiler`` split of one 572x572 batch-16 ``kernels="cuda"`` step
   by kernel, in bf16 and in fp32.
6. Train it through ``tpu_unet_torch.train_cli.main`` on 10 synthetic
   1918x1280 PNG pairs at scale 0.5, batch 4, bf16, 2 epochs, once with
   ``--kernels cuda`` and once with ``--kernels torch``: launch counts, loss
   and val Dice parity, the epoch checkpoints (palette, config, optimizer
   state) rendered by the port's ``predict --kernels cuda``, and a
   ``--resume`` from epoch 1 that starts at epoch 2 with the saved optimizer
   and schedule. Prints each run's wall time, images/s, host time waiting on
   the loader, validation time and peak device memory.
   6b. One 572x572 batch-16 bf16 step with ``remat`` against one without:
   equal loss and gradients, both peak memories and times.
7. The single-GPU predict surface on phase 3's checkpoint (eval forward,
   library convs, no kernel): ``export_pth`` then ``import_pth`` bitwise,
   ``predict -m x.pth`` and ``-m x.npz`` the same PNGs, the checkpoint
   averaged with itself unchanged; the ``predict`` CLI in fp32 on 6 synthetic
   1918x1280 images and 2 of 1280x960 with ``--batch-size 4`` (groups 4, 2,
   2) and ``--batch-size 1``, masks >= 99.99% equal, images/s of both;
   ``tta_logits`` at 959x640 against four hand-flipped forwards (1e-3 of the
   logits' range) and ``predict --tta`` in both modes; the tiled sweep at
   2048² (BASELINE config #4: scale 1.0, tile 512, halo 128) against the
   full-image forward (1e-3 of the range, masks >= 99.99% equal), the padded
   sweep at 959x640 (tile 128) against it away from the padded edge, and
   the 2048² sweep's time per image and per tile with its peak memory, fp32
   and bf16, beside the full-image forward's; ``serve --tile 512 --tta``
   (bf16) on one 2048² request, its mask equal to ``predict_img_tiled``'s;
   ``evaluate --tta`` over phase 6's data within ``CLI_DICE_TOL`` of the
   plain Dice; ``crf_refine_binary`` at 959x640 in [0, 1]. The tiled server
   preprocesses on the card (the default under ``--tile``).
8. The data path at 1918x1280 -> 959x640 (no kernel of the repo; the
   train runs launch the three train kernels): the native C++ tier
   (``tpu_unet_torch/native``) built with g++ and self-checked, its PNG,
   JPEG and GIF decode and BICUBIC/NEAREST resize bitwise equal to PIL's and
   timed beside it (host clock; ``has_jpeg`` printed: JPEG may fall back to
   PIL where the host lacks libjpeg); ``device_preprocess_images`` and
   ``device_preprocess_masks`` on the card bitwise equal to the host path at
   b1 and b4 (CUDA events); ``predict --device-preprocess`` on phase 7's
   files, in turns with the host path, masks equal to phase 7's; one served
   request with ``--device-preprocess`` (``--kernels cuda``), its mask equal
   to the host request's, broken down like phase 4's; ``serve --tile`` on
   device preprocess by default; ``train_cli -s 0.5 -b 4 --amp --kernels
   cuda`` with ``--device-preprocess``, ``--device-dataset`` (first batch
   bitwise the host loader's, losses and val Dice within ``CLI_LOSS_TOL``
   and ``CLI_DICE_TOL`` of phase 6's run, the staged MB) and ``--augment
   --augment-elastic 34 --augment-rot 10`` twice (bitwise equal), each with
   its train-kernel launches.
9. The four other model families at full width (base 64, one class,
   ConvTranspose decoder, t = 2 with per-step recurrent BN, seed 0; UNet++
   upsamples and trains with deep supervision), which run no conv or pool
   kernel of the repo (none launches in this phase; the clip and update
   kernels of phase 2d run in every train step): for each of attention, unetpp, r2u
   and r2attu one ``make_train_step`` step (``kernels=None``) at 959x640
   batch 4 in fp32 and bf16, its loss finite, the second of the timed steps
   (all from the same trees) equal to the first bit for bit or within
   ``STEP_TOL``, with the reason (the pair again in cuDNN's and torch's
   deterministic modes, bitwise or not, and the ops torch names), ms per
   step (CUDA events, median of 3) and peak memory; Attention U-Net's
   folded forward (``backend="torch"``) within 1e-3 of the eval forward's
   logit range at 959x640 fp32 with moved BN statistics, ``backend="cuda"``
   refused, and ``serve --arch attention`` answering one 1918x1280 request
   with ``predict --arch attention``'s mask; ``train_cli --arch r2u -s 0.5 -b
   4 --amp --epochs 1`` on phase 6's images (the checkpoint stores
   ``recur_bn``), ``predict --arch r2u`` and ``evaluate --arch r2u`` on the
   run's validation images within ``CLI_DICE_TOL`` of its last validation;
   ``predict_img_tiled`` for r2u at 2048² with tile 512 taking ``min_halo``
   (352), its logits within 1e-3 of the full image's range.
10. Training quality and observability (after phase 6, whose files it
   uses): ``tools/train_demo.run(preset="arch", arch="unet")``, the JAX
   package's gate at full width (320x480, batch 8, 280 steps, bf16, the
   corpus on the card, deterministic algorithms, so a run repeats bit for
   bit), once with ``kernels=None`` and once with
   ``kernels="cuda"``, each held to the frozen floors (val Dice 0.947,
   held-out 0.939), the second launching only ``.tc`` train kernels, as
   many as its steps need, and the Dice gap between the two printed;
   ``train_cli --wandb --profile DIR --debug-nans --kernels cuda`` for 2
   steps and 1 validation with a stub ``wandb``, whose logs must hold the
   per-step and validation logs with ``Weights/`` and ``Gradients/``
   histograms of at most 2·``_HIST_CAP`` elements, whose trace must name the
   three train kernels (``tools/profile_step.parse_trace``), whose NaN mode
   must have checked backward ops, and whose losses must equal the same
   run's without the flags (cuDNN deterministic for the pair); a
   NaN-poisoned batch through the ``kernels="cuda"`` step under
   ``DebugNans``, in bf16 and fp32, must raise ``FloatingPointError``.

11. Data parallelism (``tpu_unet_torch/parallel/mesh.py``) at full width,
   on phase 6's files and phase 5's parity batch (959x640, global batch 4),
   in at most ``DP_BUDGET_S``: (a) ``torchrun --standalone --nproc-per-node
   1 -m tpu_unet_torch.train_cli --data-parallel --deterministic --kernels
   cuda --amp`` (NCCL, world size 1) for 2 steps and 1 validation, its
   losses, validation and checkpoint bitwise those of the same CLI without
   ``--data-parallel`` in this process, its ``--profile`` trace naming the
   three train kernels; (b) two ranks sharing the card over gloo (NCCL
   takes one rank per device), each running the data-parallel step on its
   2 rows, in fp32 and bf16 on both kernel routes, against the
   single-process full-batch step (loss, grad norm and BN running stats
   within ``STEP_TOL``; each gradient's distance from the float64 step
   within ``GRAD_RATIO`` times the larger of the two routes' full-batch
   distances, plus the floor), the ranks' params
   equal bit for bit after two steps, each rank launching the train kernels
   as often as a plain step does; the data-parallel step's time beside the
   full-batch step's (two ranks on one card share its SMs: no speed claim);
   (c) ``evaluate`` split over the two ranks against the single-process
   ``evaluate`` on (a)'s checkpoint, Dice and IoU within ``DP_EVAL_TOL``.
12. ZeRO, multi-host and halo-sharded predict (``parallel/zero.py``,
   ``parallel/multihost.py``, ``parallel/tiling.py``) at full width, in at
   most ``MH_BUDGET_S``, two "hosts" sharing the card over gloo (each a
   process with ``LOCAL_WORLD_SIZE`` 1 at an explicit TCP rendezvous): (a)
   ``ZERO_STEPS`` steps of the ZeRO step beside the plain data-parallel
   step on phase 5's parity batch, fp32 and bf16, RMSprop and Adam, library
   route, deterministic algorithms: params, BN state, losses, grad norms
   and the gathered optimizer state bitwise equal, each rank's
   optimizer-state MB against the replicated MB (and, printed, whether
   two plain fp32 runs with cuDNN's default algorithms repeat); (b)
   ``train_model`` across the two hosts with ``kernels="cuda"`` and bf16
   on phase 6's files for one epoch (2 steps, 1 validation; deterministic
   algorithms), once with the multi-host host feed (each rank decoding its
   rows, validation on shard-marked batches) and once with
   ``device_dataset``: each history bitwise the ``device_dataset`` run's
   as one host's two ranks, each rank staging about half the corpus and
   launching the train kernels as a plain step does; then
   ``GATHER_PASSES`` passes of gather and train step at 959x640 with the
   corpus staged over the ranks beside the whole corpus staged on each
   rank (host-clock ms, printed); and ``train_cli --data-parallel
   --multihost --coordinator 127.0.0.1:<p>
   --num-processes 1 --process-id 0`` (NCCL) bitwise 11a's run without
   ``--data-parallel``; (c) ``predict_img_halo_sharded`` over the two ranks
   on a 2048² image at scale 0.5 (bands of 512, halo 128), fp32 logits
   within ``RANGE_TOL`` of the range of the one-process full forward's
   (bitwise or not, printed), masks in fp32 and bf16 at least
   ``MASK_AGREEMENT`` equal to ``predict_img``'s, and ``predict
   --tile-sharded`` as one process warning and writing ``predict``'s mask.

13. Spatial parallelism (``parallel/halo.py``, ``parallel/mesh.py::Grid``)
   at full width, in at most ``SP_BUDGET_S``, gloo ranks sharing the card
   at an explicit TCP rendezvous (NCCL takes one rank per device), on the
   library route (JAX refuses its kernels on a spatial mesh), as a 1 x 2
   and a 2 x 2 (data x spatial) grid: (a) one ``make_train_step`` step of
   the flagship (ConvT decoder) at 959x640 global batch 4 in fp32 and bf16,
   each rank on its rows' height bands, against the one-process step from
   the same seeded trees and batch: fp32 loss within 1e-5 relative, grad
   norm 1e-3, BN state 1e-3 absolute, params by JAX's rule (median |diff|
   < 1e-5, at most 1% of a leaf off by more than 1e-3, none by 0.1); bf16
   within ``STEP_TOL``; the ranks' params bitwise equal; (b) the same in
   fp32 for the bilinear U-Net and R2U-Net at batch 2 (R2U-Net's params,
   whose first RMSprop step flips signs on rounding, by PR 17's
   float64-distance rule where JAX's fails: at most twice the one-process
   fp32 step's distance from the float64 step); (c) ``train_cli
   --data-parallel --spatial-parallel 2`` for one epoch on phase 6's pairs
   (the 1 x 2 grid's ranks joining their group), writing
   ``checkpoint_epoch1.npz``; (d) each step's peak device memory a rank
   below the one-process step's (each in a fresh process), and no rank's
   largest conv transient allocation above the largest of the one-process
   steps of its model (``ops/conv.py``'s cuDNN engine rule keeps the
   workspaces from outweighing the activations). No time: the ranks share
   the card.

14. Tensor and pipeline parallelism (``parallel/tensor.py``,
   ``parallel/pipeline.py``) at full width, in at most ``TP_BUDGET_S``, on
   the library route (JAX refuses Pallas on either axis): (a) gloo ranks
   sharing the card as a 1 x 1 x 2 and a 1 x 2 x 2 (data x spatial x model)
   grid, each rank holding its channel shards: one ``make_train_step``
   step of the flagship at 959x640 global batch 4 (fp32 and bf16 on the
   first grid, fp32 on the second) and of R2U-Net at batch 2 fp32 (the
   first grid), against the one-process step from the same seeded trees:
   loss by JAX's ``tests/test_tensor_parallel.py`` tolerances (5e-4, bf16
   2e-2), BN state 2e-2 (bf16 5e-3), the grad norm by ``STEP_TOL``, each
   gathered clipped gradient by phase 11b's rule (its relative L2 distance
   from the float64 one-process step's at most ``GRAD_RATIO`` times the
   one-process step's plus ``STEP_TOL``'s floor) and, for the fp32
   flagship, every element within 1e-6 + 1e-3 relative of the one-process
   step's, JAX's fp32 gradient tolerance (``tests/test_pipeline.py``;
   R2U-Net's recurrent BN amplifies round-off past it), the params within
   one flipped sign's move (2·10·lr: RMSprop normalises each element, so
   only the gradients show a sharded gradient scaled or summed over the
   wrong ranks), the replicated leaves bitwise on every rank, params +
   RMSprop MB a rank beside one process's, and 13d's memory rule, the
   1 x 1 x 2 flagship fp32 ranks also below ``TP_PEAK_GIB``; (b)
   ``PipelineRunner`` with 2 stages (bilinear) and 4 (ConvT) on cuda:0,
   M = 4, 959x640 b4, fp32 and bf16 (deterministic algorithms), against
   ``make_train_step(accum_steps=4)`` by JAX's ``tests/test_pipeline.py``
   tolerances, ``gather`` bitwise the stages' trees, MB a stage, a later
   step's host ms beside the accumulated step's (a record: the stages
   share the card), and each of the ten segments' forward +
   backward ms at one 959x640 image in both dtypes; (c) ``train_cli
   --data-parallel --tensor-parallel 2`` for one epoch on phase 6's pairs
   at scale 0.25 (the first grid's ranks; gloo moves each block's
   activations through host memory, and (a) holds full width), writing the
   whole model and optimizer state,
   and ``train_cli --pipeline-parallel 2`` on one card refused in JAX's
   words ("pipeline needs 2 devices, have 1").

15. The deployment surface, in at most ``DEPLOY_BUDGET_S``, on phase 3's
   checkpoint, 8 of phase 6's 1918x1280 images and a second full-width
   model with the Carvana U-Net's two classes: (a) ``python -m
   tpu_unet_torch.export``, one process a program, running beside (b)-(e):
   bf16 ``.pt2`` programs at 640x959 (symbolic batch; and with ``--tta
   --tta-mode hflip``) and an fp32 one with ``--check``; then a fresh
   process reloads the bf16 ones on the card and holds them against the
   live folded forward (``backend="torch"``) at batch 1 and 4 within
   ``export.CHECK_ATOL``, with its load s, and loads the symbolic one on the
   CPU; the two-class model to ``.pth`` with ``--check``; at the end each
   program's ms a call beside the live forward's; (b) one server with both
   checkpoints under ``--kernels cuda --mask-values 0,255``, each
   ``/predict/<name>`` PNG equal to that model's solo predictor's, the four
   forward kernels launched per routed request as phase 4's forwards launch
   them, the nested ``/healthz`` and ``/metrics``, an unknown name 404; a
   second server with the checkpoint beside the fp32 ``.pt2`` on the
   default eval forward (``--no-amp``), their masks within
   ``BATCH_AGREEMENT``; (c) ``submit`` at batch 4 with and without ``--tta
   --tta-mode hflip``, each RLE row decoding to ``predict_img(amp=False)``'s
   mask, img/s; (d) ``hub.unet_carvana(pretrained=True)`` on (a)'s
   ``.pth``, also through ``torch.hub.load(..., source="local")``, bitwise
   the checkpoint's trees on the card; (e) ``dryrun.entry()`` on the card,
   ``dryrun_multichip(2)`` with budget 0 (core tier; gloo ranks on the CPU,
   the card being one), and ``dryrun_multichip(1)`` on the card (NCCL)
   within ``DRYRUN_CARD_BUDGET_S``, whose extended tier runs the CUDA train
   kernels under data parallelism.

The last two lines are the card (``nvidia-smi``) and the result JSON; the
line before them is the per-kernel JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import hashlib
import io
import json
import multiprocessing as mp
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
from http.client import HTTPConnection
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from tpu_unet_torch import kernels as K
from tpu_unet_torch import native
from tpu_unet_torch.kernels import _build
from tpu_unet_torch.kernels import multi_tensor as mt
from tpu_unet_torch.kernels.pooling import max_pool2x2_plain
from tpu_unet_torch.ops import full_fp32
from tpu_unet_torch.ops.conv import cudnn_engine_rule
from tpu_unet_torch.tools.profile_step import profile_step
from tpu_unet_torch.utils.determinism import Deterministic

ROOT = Path(__file__).resolve().parent

# Per-forward launches of each kernel in the flagship U-Net's bf16 --kernels
# path (tpu_unet_torch/models/infer.py): down3/down4 and the up blocks'
# conv2 run the single conv, the up blocks' conv1 the concat conv,
# inc/down1/down2 the double conv, which also writes the pool after each;
# the pool after down3 is the one max_pool2x2.
PER_FORWARD = {
    "fused_conv3x3_scale_relu": 8,
    "fused_conv3x3_concat_scale_relu": 4,
    "fused_double_conv": 3,
    "max_pool2x2": 1,
}
# Of those, the bf16 calls that must run on the tensor cores (csrc/tc_conv.cu,
# csrc/tc_double_conv.cu), and the double convs that wrote their pool.
TC_PER_FORWARD = {"fused_conv3x3_scale_relu.tc": 8, "fused_conv3x3_concat_scale_relu.tc": 4,
                  "fused_double_conv.tc": 3, "fused_double_conv.pool": 3}
# The launches of one fp32 forward (folded, --kernels cuda --no-amp), every
# other count 0: the same as a bf16 forward's, every conv on the tensor cores
# in 3xTF32, the double convs writing 3 of the 4 pools.
FP32_PER_FORWARD = {**PER_FORWARD, **TC_PER_FORWARD}
SOURCES = {
    "fused_conv3x3_scale_relu": ("tpu_unet_torch/csrc/tc_conv.cu",
                                 "tpu_unet/kernels/fused_conv.py:75"),
    "fused_conv3x3_concat_scale_relu": ("tpu_unet_torch/csrc/tc_conv.cu",
                                        "tpu_unet/kernels/fused_conv.py:192"),
    "fused_double_conv": ("tpu_unet_torch/csrc/tc_double_conv.cu",
                          "tpu_unet/kernels/fused_double_conv.py:94"),
    "max_pool2x2": ("tpu_unet_torch/csrc/pooling.cu", "tpu_unet/kernels/pooling.py:33"),
}
# Kernel vs plain tolerance, |kernel - plain| <= atol + rtol * |plain|.
# fp32: the two differ only in summation order over up to 9*1024 products.
# bf16: both sum exact products in fp32 and round once (twice for the double
# conv's mid), so an output may differ by about one bf16 ulp (2^-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# Served bf16 masks vs the plain bf16 forward. The two differ only in the
# order of fp32 sums, but one-ulp bf16 roundings that this changes compound
# over the 23 convs of a random-weight network, whose logits crowd the
# threshold: measured 99.79-99.85% agreement on the H100. The fp32 forward
# is held to 1e-3 of the logit range, which is where the kernels are checked.
MASK_AGREEMENT = 0.995

TRAIN_SOURCES = {
    "conv3x3_fwd": ("tpu_unet_torch/csrc/tc_conv.cu", "tpu_unet/kernels/train_conv.py:128"),
    "conv3x3_dx": ("tpu_unet_torch/csrc/tc_conv.cu", "tpu_unet/kernels/train_conv.py:289"),
    "conv3x3_dw": ("tpu_unet_torch/csrc/tc_conv.cu", "tpu_unet/kernels/train_conv.py:441"),
}
# Per-step wrapper calls of each train kernel with kernels="cuda": 9
# DoubleConvs of 2 convs each; inc's conv1 computes no dx (the image needs
# no gradient). conv3x3_fwd with stats and conv3x3_dw each make two kernel
# launches per call (the conv, then the fixed-order sum of its partials);
# the count is of calls.
PER_STEP = {"conv3x3_fwd": 18, "conv3x3_dx": 17, "conv3x3_dw": 18}
# Of those, the calls of a step that must run on the tensor cores, by dtype:
# all of them in both (fp32 in 3xTF32).
TC_PER_STEP = {
    "bf16": {"conv3x3_fwd.tc": 18, "conv3x3_dx.tc": 17, "conv3x3_dw.tc": 18},
    "fp32": {"conv3x3_fwd.tc": 18, "conv3x3_dx.tc": 17, "conv3x3_dw.tc": 18},
}
# The train step's clip and RMSprop update (kernels/multi_tensor.py) launch
# on CUDA trees whatever the conv route: the squared sums, the scaling and
# the update, once a step each (none inside mt.plain_versions(), which the
# float64 reference steps enter).
UPDATE_PER_STEP = {"grad_sumsq": 1, "scale_to_norm": 1, "rmsprop_step": 1}
UPDATE_SOURCES = {name: ("tpu_unet_torch/csrc/multi_tensor.cu",
                         "none: the JAX package leaves the clip and the update to XLA")
                  for name in UPDATE_PER_STEP}
# Phase 2d: the squared sums and the norm within this of the plain version's
# (relative); the scaling and the update bit for bit.
UPDATE_NORM_RTOL = 1e-6
# Which implementation runs each kernel in each dtype.
_TC = "tensor cores, mma.sync + TMA (tpu_unet_torch/csrc/tc_conv.cu)"
_TF32X3 = ("tensor cores, 3xTF32 mma.sync m16n8k8 (hi/lo split, fp32 accuracy) + TMA "
           "(tpu_unet_torch/csrc/tc_conv.cu)")
IMPL = {
    "fused_conv3x3_scale_relu": {"bf16": _TC, "fp32": _TF32X3},
    "fused_conv3x3_concat_scale_relu": {"bf16": _TC, "fp32": _TF32X3},
    "fused_double_conv": {
        "bf16": "tensor cores, mma.sync + TMA, mid in shared memory, pool in the epilogue "
                "(tpu_unet_torch/csrc/tc_double_conv.cu)",
        "fp32": "tensor cores, 3xTF32 mma.sync m16n8k8 (hi/lo split, fp32 accuracy) + TMA, fp32 "
                "mid in shared memory, pool in the epilogue "
                "(tpu_unet_torch/csrc/tc_double_conv.cu)"},
    "max_pool2x2": {"bf16": "CUDA cores, no divides, 16-byte loads with no L1 allocation, "
                            "__hmax2_nan on bf16 pairs (tpu_unet_torch/csrc/pooling.cu)",
                    "fp32": "CUDA cores, no divides, 16-byte __ldg loads "
                            "(tpu_unet_torch/csrc/pooling.cu)"},
    "conv3x3_fwd": {"bf16": _TC, "fp32": _TF32X3},
    "conv3x3_dx": {"bf16": _TC, "fp32": _TF32X3},
    "conv3x3_dw": {"bf16": _TC, "fp32": _TF32X3},
    **{name: {dt: "CUDA cores, one launch over a table of (leaf, chunk) blocks, 4-value "
                  "vectors (tpu_unet_torch/csrc/multi_tensor.cu)" for dt in ("bf16", "fp32")}
       for name in UPDATE_PER_STEP},
    "im2col_conv3x3": {"bf16": _TC, "fp32": _TF32X3},
}


def expected_launches(name: str, kernels, amp: bool, steps: int = 1) -> int:
    """Launches of counter ``name`` in ``steps`` RMSprop train steps on the
    card (outside ``mt.plain_versions()``)."""
    if name in UPDATE_PER_STEP:
        return UPDATE_PER_STEP[name] * steps
    if kernels != "cuda":
        return 0
    tc = TC_PER_STEP["bf16" if amp else "fp32"]
    if name in tc:
        return tc[name] * steps
    return PER_STEP.get(name, 0) * steps
# Phase 2b cases: (label, x shape, Cout, prologue) at the 572x572 step's
# shapes (batch 4 instead of 16, to bound chip time) and one odd-width
# case of the 959x640 plan. The main case reported in the kernels line is
# MAIN_TRAIN_CASE, the step's largest-volume conv.
TRAIN_B = 4
TRAIN_CASES = (
    ("inc.conv1", (TRAIN_B, 572, 572, 3), 64, False),
    ("inc.conv2", (TRAIN_B, 572, 572, 64), 64, True),
    ("down4", (16, 35, 35, 512), 1024, True),
    ("down1.conv1@959x640", (4, 320, 479, 64), 128, False),
)
MAIN_TRAIN_CASE = "inc.conv2"
# Phase 5: the flagship at full width from seed 0, its parity batch (the
# Carvana production shape, 959x640) and its timing batch (572x572 b16).
TRAIN_CONFIG = {"n_channels": 3, "n_classes": 1, "bilinear": False, "base_channels": 64}
TRAIN_PARAMS = 31_037_633
PARITY_BATCH = (4, 640, 959)
TIMING_BATCH = (16, 572, 572)
# Train kernel vs plain. z and dx: TOL by output dtype (the kernels stage
# the same rounded values as the plain versions, so fp32 outputs differ
# only in summation order and bf16 ones by about one ulp). The (sum z,
# sum z^2) stats and dw are long sums over N*H*W: their max abs error is
# held to a fraction of the largest |plain| value.
STATS_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
DW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# Train step, kernels="cuda" vs kernels=None: loss and grad norm relative
# error and the largest per-tensor relative L2 error of the new BN running
# statistics (fp32: both paths sum in fp32 in another order; bf16: both
# round to bf16 at the same points, and one-ulp flips of rounded values
# propagate through 23 convs). Gradients are held against a float64 step
# (kernels=None): down4's gradients are ill-conditioned at the random init
# (norms ~5e-6 against a total of 5.6), so rounding alone moves them by
# 0.35% in fp32 and 25% in bf16 in BOTH paths (measured on an H100 80GB
# HBM3). Per tensor, the kernels' distance to float64 must be at most
# GRAD_RATIO times the library path's, plus the floor.
STEP_TOL = {
    "fp32": {"loss": 1e-5, "grad_norm": 1e-4, "bn_state": 1e-4, "grad_floor": 1e-4},
    "bf16": {"loss": 1e-3, "grad_norm": 5e-3, "bn_state": 5e-3, "grad_floor": 2e-2},
}
GRAD_RATIO = 2.0

IM2COL_SOURCE = ("tpu_unet_torch/csrc/tc_conv.cu", "tpu_unet/kernels/im2col_conv.py:84")
# Phase 2c cases: (label, x shape, Cout, ReLU): level 0 of the 572x572 step
# (batch 4, as in phase 2b), up4's concat width, the image's 3 channels, and
# a ragged shape in both ReLU settings. The kernels line reports level0.
IM2COL_CASES = (
    ("level0", (TRAIN_B, 572, 572, 64), 64, False),
    ("up4.concat", (TRAIN_B, 572, 572, 128), 64, False),
    ("inc.conv1", (TRAIN_B, 572, 572, 3), 64, True),
    ("ragged", (2, 13, 20, 16), 8, False),
    ("ragged.relu", (2, 13, 20, 16), 8, True),
)
MAIN_IM2COL_CASE = "level0"

# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the memory
# rate and its operations over the peak rate for the input type. The
# published H100 SXM figures (dense, at 700 W): 3.35 TB/s of HBM; 989
# TFLOP/s bf16 on the tensor cores. fp32 work at fp32 accuracy is fastest
# on the tensor cores in 3xTF32 (three TF32 products for each fp32 one, as
# the port's fp32 conv3x3_fwd and conv3x3_dw run it): 494.7 / 3 TFLOP/s,
# above the 67 TFLOP/s of fp32 FMA outside them, which cuDNN's fp32 convs
# (TF32 off) beat.
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.bfloat16: 989e12, torch.float32: 494.7e12 / 3}


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations")."""
    t_ops, t_bytes = flops / PEAK_FLOP_S[dtype], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def conv_flops(shape, cin: int, cout: int) -> float:
    """2·9·Cin·Cout operations per output pixel of a 3x3 conv."""
    n, h, w = shape[:3]
    return 2.0 * 9 * n * h * w * cin * cout


def nchw(t):
    """A channels-last NCHW view of an NHWC tensor (no copy), as cuDNN takes it."""
    return t.permute(0, 3, 1, 2)


def oihw(w):
    """HWIO weights as a channels-last OIHW tensor (a copy, made once)."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of one call, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _randn(gen, shape, scale=1.0):
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _conv_params(gen, cin, cout):
    w = _randn(gen, (3, 3, cin, cout), (9 * cin) ** -0.5)
    return w, 1.0 + 0.1 * _randn(gen, (cout,)), 0.1 * _randn(gen, (cout,))


def _vec_bytes(c: int) -> int:
    return 4 * c  # an fp32 per-channel vector


def kernel_cases(gen):
    """(kernel name, shape label, kernel fn, plain fn, fp32 inputs, work,
    library) at the shapes the 959x640 forward gives each kernel. ``work``
    maps the inputs in the case's dtype to (operations, bytes) of the
    function; ``library`` maps them to one PyTorch call computing the same
    function (its weights prepared outside the timing), or is None."""
    import torch.nn.functional as F

    from tpu_unet_torch.kernels.fused_conv import (
        fused_conv3x3_concat_scale_relu_plain,
        fused_conv3x3_scale_relu_plain,
    )
    from tpu_unet_torch.kernels.fused_double_conv import fused_double_conv_plain

    def pool_work(x):
        return 3.0 * x.numel() / 4, nbytes(x) * 5 / 4

    def pool_library(x):
        xv = nchw(x)
        return lambda: F.max_pool2d(xv, 2)

    def dc_work(x, w1, s1, b1, w2, s2, b2):
        """Both convs and epilogues, and the pool of y (3 maxima per pooled
        value); bytes: the inputs, y and the pooled output."""
        n, h, wd, cin = x.shape
        cmid, cout = w1.shape[3], w2.shape[3]
        px, pooled = n * h * wd, n * (h // 2) * (wd // 2) * cout
        return (conv_flops(x.shape, cin, cmid) + conv_flops(x.shape, cmid, cout)
                + 3 * px * (cmid + cout) + 3 * pooled,
                nbytes(x, w1, w2, s1, b1, s2, b2) + (px * cout + pooled) * x.element_size())

    def conv_work(*args):
        *xs, w, s, b = args
        px = xs[0].numel() / xs[0].shape[3]
        return (conv_flops(xs[0].shape, w.shape[2], w.shape[3]) + 3 * px * w.shape[3],
                nbytes(*xs, w, s, b) + px * w.shape[3] * xs[0].element_size())

    def conv_library(*args):
        """cuDNN conv with the scale folded into the weights and the bias
        passed; no ReLU. The concat variant's input is concatenated here,
        outside the timing."""
        *xs, w, s, b = args
        xl = nchw(torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0])
        wl, bl = oihw((w.float() * s).to(w.dtype)), b.to(w.dtype)
        return lambda: F.conv2d(xl, wl, bl, padding=1)

    cases = []
    # The served forward's three double convs (inc, down1, down2), each with
    # the pool of its output, as the forward calls them.
    for shape, cmid in (((1, 640, 959, 3), 64), ((1, 320, 479, 64), 128),
                        ((1, 160, 239, 128), 256)):
        w1, s1, b1 = _conv_params(gen, shape[-1], cmid)
        w2, s2, b2 = _conv_params(gen, cmid, cmid)
        cases.append(("fused_double_conv", f"{list(shape)}->{cmid}->{cmid}".replace(" ", ""),
                      functools.partial(K.fused_double_conv, pool=True),
                      functools.partial(fused_double_conv_plain, pool=True),
                      [_randn(gen, shape), w1, s1, b1, w2, s2, b2], dc_work, None))
    # The served forward's eight single convs, the main case (down3.conv2,
    # up1.conv2) first: down3.conv1, down4.conv1/2, up2/3/4.conv2.
    for shape, cout in (((1, 80, 119, 512), 512), ((1, 40, 59, 1024), 1024),
                        ((1, 80, 119, 256), 512), ((1, 40, 59, 512), 1024),
                        ((1, 160, 239, 256), 256), ((1, 320, 479, 128), 128),
                        ((1, 640, 959, 64), 64)):
        w, s, b = _conv_params(gen, shape[-1], cout)
        cases.append(("fused_conv3x3_scale_relu", f"{list(shape)}->{cout}".replace(" ", ""),
                      K.fused_conv3x3_scale_relu, fused_conv3x3_scale_relu_plain,
                      [_randn(gen, shape), w, s, b], conv_work, conv_library))
    # The four decoder blocks' conv1 (skip + upsampled), level 0 first; then
    # a ragged case whose skip ends in a partial 32-channel chunk (Ca = 40).
    for shape, cb, cout in (((1, 640, 959, 64), 64, 64), ((1, 80, 119, 512), 512, 512),
                            ((1, 160, 239, 256), 256, 256), ((1, 320, 479, 128), 128, 128),
                            ((2, 13, 20, 40), 24, 72)):
        w, s, b = _conv_params(gen, shape[-1] + cb, cout)
        cases.append(("fused_conv3x3_concat_scale_relu",
                      f"{list(shape)}+[..{cb}]->{cout}".replace(" ", ""),
                      K.fused_conv3x3_concat_scale_relu, fused_conv3x3_concat_scale_relu_plain,
                      [_randn(gen, shape), _randn(gen, shape[:3] + (cb,)), w, s, b], conv_work,
                      conv_library))
    # The pool at the one shape a forward gives the kernel (down3's output;
    # the first three pools come from the double convs' epilogue), then at
    # level 0's width. Last: one call of a 12 MB pool is mostly host time,
    # which the first calls after the build, on an idle card and host, inflate.
    cases += [("max_pool2x2", f"{list(shape)}".replace(" ", ""), K.max_pool2x2,
               max_pool2x2_plain, [_randn(gen, shape)], pool_work, pool_library)
              for shape in ((1, 80, 119, 512), (1, 640, 959, 64))]
    return cases


# Kernels whose result phase 2 also holds to a second call, bit for bit, by
# dtype.
REPEAT = {"max_pool2x2": ("bf16", "fp32"),
          "fused_conv3x3_scale_relu": ("bf16", "fp32"),
          "fused_conv3x3_concat_scale_relu": ("bf16", "fp32"),
          "fused_double_conv": ("bf16", "fp32")}


def dc_pairs(x, w1, s1, b1, w2, s2, b2) -> dict[str, float]:
    """Two compositions of the double conv's function, timed as one call
    each (``time_ms``): two ``fused_conv3x3_scale_relu`` calls with mid
    through device memory (tensor cores; 3xTF32 in fp32), and two cuDNN
    convs (scales folded into the weights, biases passed; TF32 off
    in fp32) with a ReLU between and after. Neither pools."""
    import torch.nn.functional as F

    xl = nchw(x)
    wl1, wl2 = (oihw((w.float() * s).to(w.dtype)) for w, s in ((w1, s1), (w2, s2)))
    bl1, bl2 = b1.to(x.dtype), b2.to(x.dtype)

    def tc_pair():
        return K.fused_conv3x3_scale_relu(K.fused_conv3x3_scale_relu(x, w1, s1, b1), w2, s2, b2)

    def cudnn_pair():
        return torch.relu(F.conv2d(torch.relu(F.conv2d(xl, wl1, bl1, padding=1)), wl2, bl2,
                                   padding=1))

    return {"tc_pair_ms": time_ms(tc_pair), "cudnn_pair_ms": time_ms(cudnn_pair)}


LIBRARY_CALLS = {
    "max_pool2x2": "F.max_pool2d on a channels-last view",
    "fused_double_conv": "none: two convs and a pool (compositions logged beside bf16)",
    "fused_conv3x3_scale_relu": "F.conv2d, scale folded, bias passed, no ReLU",
    "fused_conv3x3_concat_scale_relu": "F.conv2d on the prebuilt concat, scale folded, no ReLU",
    "conv3x3_fwd": "F.conv2d, no prologue, no stats",
    "conv3x3_dx": "torch.nn.grad.conv2d_input on dz, no cotangent built",
    "conv3x3_dw": "torch.nn.grad.conv2d_weight on x and dz, no prologue or cotangent",
    "im2col_conv3x3": "F.conv2d, scale folded, bias passed, no ReLU",
    **{name: "none: the plain version is PyTorch's per-leaf ops" for name in UPDATE_PER_STEP},
}


def phase_kernels() -> dict[str, dict]:
    """Phase 2: every kernel vs its plain version at the main path's shapes,
    with the library call's time and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results: dict[str, dict] = {}
    failures = []
    for name, label, fn, plain, inputs, work, library in kernel_cases(gen):
        for dtype in (torch.bfloat16, torch.float32):
            args = [t.to(dtype) if t.ndim == 4 else t for t in inputs]
            got = fn(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            pooled, pool_note, pool_ok = None, "", True
            if isinstance(got, tuple):  # (y, pooled): the pool of the kernel's own y, exactly
                (got, pooled), ref = got, ref[0]
                pool_ok = torch.equal(pooled, max_pool2x2_plain(got))
                pool_note = f", pooled == max_pool2x2_plain(y) {pool_ok}"
            diff = (got.float() - ref.float()).abs()
            max_abs = diff.max().item()
            max_rel = max_abs / max(ref.float().abs().max().item(), 1e-30)
            atol, rtol = TOL[dtype]
            ok = bool((diff <= atol + rtol * ref.float().abs()).all().item())
            if name == "max_pool2x2":
                ok = max_abs == 0.0  # a max selects an input: exact
            ok = ok and pool_ok
            repeat = ""
            dt = "bf16" if dtype == torch.bfloat16 else "fp32"
            if dt in REPEAT.get(name, ()):
                again = fn(*args)
                if pooled is not None:  # the double conv: y and its pool
                    same = torch.equal(got, again[0]) and torch.equal(pooled, again[1])
                else:
                    same = torch.equal(got, again)
                ok = ok and same
                repeat = f", bitwise repeat {same}"
                del again
            del got, ref, diff, pooled
            # One call of the served pool is ~0.03 ms of mostly host time, whose
            # jitter a median of 10 does not settle: 50 calls for the pool.
            reps = 50 if name == "max_pool2x2" else 10
            ms = time_ms(lambda: fn(*args), reps)
            plain_ms = time_ms(lambda: plain(*args), reps)
            library_ms = time_ms(library(*args), reps) if library else None
            bound_ms, bound_by = bound(*work(*args), dtype)
            tol = ("exact" if name == "max_pool2x2" else f"{atol:g}+{rtol:g}*|plain|") + repeat
            lib = f"{library_ms:.4f}" if library_ms is not None else "none"
            device = {}
            if name == "max_pool2x2":  # one call of the served pool is mostly host time
                device = {"graph_ms": graph_ms(lambda: fn(*args)),
                          "library_graph_ms": graph_ms(library(*args))}
                lib += (f"; in a CUDA graph: kernel {device['graph_ms']:.4f}, library "
                        f"{device['library_graph_ms']:.4f}")
            pairs = {}
            if name == "fused_double_conv":
                pairs = dc_pairs(*args)
                lib += (f"; compositions: fused-conv pair {pairs['tc_pair_ms']:.4f} ms, cuDNN pair "
                        f"{pairs['cudnn_pair_ms']:.4f} ms")
            log(f"kernel {name} {label} {dt} [{IMPL[name][dt]}]: max_abs_err={max_abs:.3e} "
                f"max_rel_err={max_rel:.3e} (tol {tol}{pool_note}) ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib} ({LIBRARY_CALLS[name]}) "
                f"bound_ms={bound_ms:.4g} ({bound_by}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} {label} {dt}")
            entry = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
            entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
            entry["cases"].append({"shape": label, "dtype": dt, "impl": IMPL[name][dt],
                                   "max_abs_err": max_abs, "max_rel_err": max_rel, "ms": ms,
                                   "plain_ms": plain_ms, "library_ms": library_ms,
                                   "bound_ms": bound_ms, "bound_by": bound_by, **pairs, **device})
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failures}")
    return results


def b2b_ms(fn, reps: int = 20) -> float:
    """Mean CUDA-event time of ``reps`` calls back to back, after two warm-up
    calls: the host's work for one call hides behind the card's for the one
    before, which ``time_ms`` (one call between events) does not hide."""
    for _ in range(2):
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


def graph_ms(fn, reps: int = 50) -> float:
    """Mean CUDA-event time of one call when ``reps`` calls, captured once
    in a CUDA graph, replay back to back: the card's time without the
    host's work between launches, which one call of a few-microsecond
    kernel mostly measures."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch.cuda.graph asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 5) -> dict[str, float]:
    """Device time per call of each kernel that ``fn`` launches, by kernel
    name (``torch.profiler`` over ``reps`` calls after two warm-ups)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        name = ev.key.split("<")[0].split("(")[0].split("::")[-1].strip()[:48]
        out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def fwd_split(x, w, pro) -> dict[str, dict]:
    """Where the time of the main bf16 ``conv3x3_fwd`` case goes: the
    wrapper without and with its prologue and stats, and the library call,
    each timed as one call (as the kernels line times it), as the mean of
    calls back to back, and on the device by kernel."""
    import torch.nn.functional as F

    xl, wl = nchw(x), oihw(w)
    variants = {
        "raw": lambda: K.conv3x3_fwd(x, w),
        "raw+stats": lambda: K.conv3x3_fwd(x, w, stats=True),
        "pro": lambda: K.conv3x3_fwd(x, w, *pro),
        "pro+stats": lambda: K.conv3x3_fwd(x, w, *pro, stats=True),
        "library": lambda: F.conv2d(xl, wl, padding=1),
    }
    out = {}
    for label, fn in variants.items():
        dev = device_ms(fn)
        out[label] = {"one_call_ms": time_ms(fn), "back_to_back_ms": b2b_ms(fn), "device_ms": dev}
        log(f"split conv3x3_fwd {list(x.shape)}->{w.shape[3]} bf16 {label}: one call "
            f"{out[label]['one_call_ms']:.4f} ms, back to back {out[label]['back_to_back_ms']:.4f}"
            f" ms, device " + "; ".join(f"{k} {v:.4f}" for k, v in dev.items()))
    return out


def _compare(got, ref, atol=0.0, rtol=0.0):
    """(max abs error, max abs error over max |ref|, all within atol +
    rtol * |ref|)."""
    diff = (got.float() - ref.float()).abs()
    max_abs = diff.max().item()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all().item())
    return max_abs, max_abs / max(ref.float().abs().max().item(), 1e-30), ok


def phase_train_kernels() -> dict[str, dict]:
    """Phase 2b: each train kernel vs its plain version at the step's shapes.
    dx and dw read the plain forward's z; dx of a prologue conv comes out in
    fp32, as ``ConvStatsPro`` asks for it."""
    import torch.nn.functional as F

    from tpu_unet_torch.kernels.train_conv import (
        conv3x3_dw_plain,
        conv3x3_dx_plain,
        conv3x3_fwd_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    results: dict[str, dict] = {}
    failures = []
    for label, shape, cout, prologue in TRAIN_CASES:
        cin = shape[-1]
        x32 = _randn(gen, shape)
        w32 = _randn(gen, (3, 3, cin, cout), (9 * cin) ** -0.5)
        g32 = _randn(gen, shape[:3] + (cout,))
        coef = torch.stack([torch.ones(cout, device="cuda"), 0.3 * _randn(gen, (cout,)),
                            0.2 * _randn(gen, (cout,))])
        pro = ()
        if prologue:
            c = 0.2 * _randn(gen, (cin,))
            c[0] = 0.7  # relu(c) > 0: the SAME padding must still read zeros
            pro = (1.0 + 0.2 * _randn(gen, (cin,)), c)
        for dtype in (torch.bfloat16, torch.float32):
            dt = "bf16" if dtype == torch.bfloat16 else "fp32"
            x, w, g = x32.to(dtype), w32.to(dtype), g32.to(dtype)
            z = conv3x3_fwd_plain(x, w, *pro)
            dx_dtype = torch.float32 if prologue else dtype
            # The library yardsticks: cuDNN's conv and its two gradients on
            # channels-last views, without the prologue, stats or cotangent.
            xl, gl, wl = nchw(x), nchw(g), oihw(w)
            px = x.numel() / cin
            pro_ops, pro_bytes = (3 * px * cin, 2 * _vec_bytes(cin)) if prologue else (0, 0)
            flops = conv_flops(shape, cin, cout)
            work = {
                "conv3x3_fwd": (flops + pro_ops + 3 * px * cout,
                                nbytes(x, w, z) + pro_bytes + 2 * _vec_bytes(cout)),
                "conv3x3_dx": (flops + 4 * px * cout,
                               nbytes(g, z, coef, w) + px * cin * dx_dtype.itemsize),
                "conv3x3_dw": (flops + pro_ops + 4 * px * cout,
                               nbytes(x, g, z, coef) + pro_bytes + 4 * 9 * cin * cout),
            }
            calls = (
                ("conv3x3_fwd", lambda: K.conv3x3_fwd(x, w, *pro, stats=True),
                 lambda: conv3x3_fwd_plain(x, w, *pro, stats=True),
                 lambda: F.conv2d(xl, wl, padding=1)),
                ("conv3x3_dx", lambda: K.conv3x3_dx(g, z, coef, w, out_dtype=dx_dtype),
                 lambda: conv3x3_dx_plain(g, z, coef, w, out_dtype=dx_dtype),
                 lambda: torch.nn.grad.conv2d_input(xl.shape, wl, gl, padding=1)),
                ("conv3x3_dw", lambda: K.conv3x3_dw(x, g, z, coef, *pro),
                 lambda: conv3x3_dw_plain(x, g, z, coef, *pro),
                 lambda: torch.nn.grad.conv2d_weight(xl, wl.shape, gl, padding=1)),
            )
            for name, fn, plain, library in calls:
                got = fn()
                torch.cuda.synchronize()
                ref = plain()
                case = {"shape": f"{list(shape)}->{cout}".replace(" ", ""), "case": label,
                        "dtype": dt, "prologue": prologue}
                # Every output comes from fixed-order sums: bitwise repeatable.
                again = fn()
                same = all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    again if isinstance(again, tuple) else (again,)))
                del again
                case["bitwise_repeat"] = same
                if name == "conv3x3_fwd":
                    atol, rtol = TOL[dtype]
                    max_abs, max_rel, ok = _compare(got[0], ref[0], atol, rtol)
                    s_abs, s_rel, _ = _compare(got[1], ref[1])
                    ok = ok and s_rel <= STATS_TOL[dtype]
                    case.update(stats_max_abs_err=s_abs, stats_err_over_max=s_rel)
                    tol = (f"z {atol:g}+{rtol:g}*|plain|, stats {STATS_TOL[dtype]:g}*max|plain| "
                           f"(stats err {s_abs:.3e}, {s_rel:.3e} of max)")
                elif name == "conv3x3_dx":
                    atol, rtol = TOL[dx_dtype]
                    max_abs, max_rel, ok = _compare(got, ref, atol, rtol)
                    tol = f"{atol:g}+{rtol:g}*|plain|, out {str(dx_dtype).split('.')[-1]}"
                else:
                    max_abs, max_rel, _ = _compare(got, ref)
                    ok = max_rel <= DW_TOL[dtype]
                    tol = f"{DW_TOL[dtype]:g}*max|plain|"
                ok = ok and same
                tol += f", bitwise repeat {same}"
                del got, ref
                ms = time_ms(fn)
                plain_ms = time_ms(plain)
                library_ms = time_ms(library)
                bound_ms, bound_by = bound(*work[name], dtype)
                log(f"kernel {name} {label} {case['shape']} {dt} [{IMPL[name][dt]}]: "
                    f"max_abs_err={max_abs:.3e} "
                    f"max_rel_err={max_rel:.3e} (tol {tol}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={library_ms:.4f} ({LIBRARY_CALLS[name]}) "
                    f"bound_ms={bound_ms:.4g} ({bound_by}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{name} {label} {dt}")
                case.update(impl=IMPL[name][dt], max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
                entry = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
                entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
                entry["cases"].append(case)
            if label == MAIN_TRAIN_CASE and dtype == torch.bfloat16:
                results["conv3x3_fwd"]["split"] = fwd_split(x, w, pro)
            del x, w, g, z, xl, gl, wl
        del x32, w32, g32
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"chip_smoke: train kernels disagree with their plain versions: "
                         f"{failures}")
    return results


def phase_im2col() -> tuple[dict[str, int], dict]:
    """Phase 2c: ``im2col_conv3x3``, the kernel of its own entry point (no
    model path calls it). One call through that entry point at the main
    case in each input dtype, with the counts reset just before and read
    just after: one launch, on the tensor cores (bf16; fp32 in 3xTF32).
    Then the kernel vs its plain version at every case, bf16 and fp32 x,
    each with bf16 and fp32 output, with the kernel's, the plain version's
    and the library call's times; a second call must repeat the first bit
    for bit. The library call is one cuDNN conv with the scale folded into
    the weights and the bias passed (the ReLU is not in it). Returns (the
    entry-point runs' counts, summed over both, results)."""
    import torch.nn.functional as F

    from tpu_unet_torch.kernels.im2col_conv import im2col_conv3x3_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    results: dict = {"max_abs_err": 0.0, "cases": []}
    failures = []
    runs: dict[str, dict[str, int]] = {}
    for label, shape, cout, relu in IM2COL_CASES:
        cin = shape[-1]
        x32 = _randn(gen, shape)
        w32, s, b = _conv_params(gen, cin, cout)
        for dtype, out_dtype in ((torch.bfloat16, torch.bfloat16),
                                 (torch.bfloat16, torch.float32),
                                 (torch.float32, torch.float32),
                                 (torch.float32, torch.bfloat16)):
            dt = "bf16" if dtype == torch.bfloat16 else "fp32"
            out_dt = "bf16" if out_dtype == torch.bfloat16 else "fp32"
            x, w = x32.to(dtype), w32.to(dtype)

            def fn():
                return K.im2col_conv3x3(x, w, s, b, apply_relu=relu, out_dtype=out_dtype)

            def plain():
                return im2col_conv3x3_plain(x, w, s, b, apply_relu=relu, out_dtype=out_dtype)

            if label == MAIN_IM2COL_CASE and dt not in runs:
                K.reset_launch_counts()
                fn()
                torch.cuda.synchronize()
                runs[dt] = {k: v for k, v in K.launch_counts().items() if k.startswith("im2col")}
            got = fn()
            torch.cuda.synchronize()
            ref = plain()
            atol, rtol = TOL[out_dtype]
            max_abs, max_rel, ok = _compare(got, ref, atol, rtol)
            same = torch.equal(got, fn())
            ok = ok and same
            tol = f"{atol:g}+{rtol:g}*|plain|, bitwise repeat {same}"
            del got, ref
            wl = oihw((w.float() * s).to(dtype))
            bl = b.to(dtype)
            xl = nchw(x)
            ms = time_ms(fn)
            plain_ms = time_ms(plain)
            library_ms = time_ms(lambda: F.conv2d(xl, wl, bl, padding=1))
            bound_ms, bound_by = bound(conv_flops(shape, cin, cout) + 3.0 * x.numel() / cin * cout,
                                       nbytes(x, w, s, b) + x.numel() // cin * cout
                                       * out_dtype.itemsize, dtype)
            case = {"shape": f"{list(shape)}->{cout}".replace(" ", ""), "case": label,
                    "dtype": dt, "out_dtype": out_dt, "impl": IMPL["im2col_conv3x3"][dt],
                    "relu": relu, "max_abs_err": max_abs, "max_rel_err": max_rel, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by}
            log(f"kernel im2col_conv3x3 {label} {case['shape']} {dt} out {out_dt} relu={relu} "
                f"[{case['impl']}]: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
                f"(tol {tol}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={library_ms:.4f} ({LIBRARY_CALLS['im2col_conv3x3']}) "
                f"bound_ms={bound_ms:.4g} ({bound_by}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"im2col_conv3x3 {label} {dt} out {out_dt}")
            results["max_abs_err"] = max(results["max_abs_err"], max_abs)
            results["cases"].append(case)
            del x, w, wl, xl
        del x32
        torch.cuda.empty_cache()
    log(f"im2col_conv3x3 entry-point runs: {json.dumps(runs)}")
    if failures:
        raise SystemExit(f"chip_smoke: im2col_conv3x3 disagrees with its plain version: "
                         f"{failures}")
    one = {"im2col_conv3x3": 1, "im2col_conv3x3.tc": 1}
    if runs != {"bf16": one, "fp32": one}:
        raise SystemExit(f"chip_smoke: the im2col entry point launched {runs}, not one "
                         f"tensor-core launch a dtype")
    return {k: runs["bf16"][k] + runs["fp32"][k] for k in one}, results


def phase_update_kernels() -> dict[str, dict]:
    """Phase 2d: the train step's clip and RMSprop update, each wrapper
    against its plain version on the full-width U-Net's 64 leaves (params
    from seed 0; gradients, square averages and momentum buffers drawn at
    a step's scales), with params fp32 (every train cell's, the main case)
    and bf16. The squared sums and the norm within ``UPDATE_NORM_RTOL`` of
    the plain ones; the scaling (the norm above max_norm, so that the clip
    engages) and the update bit for bit; a second call bit for bit the
    first; each call one launch count. ``ms`` is the device time of the
    kernels one call launches (``torch.profiler``), ``call_ms`` one call
    between CUDA events (the wrapper's host work before its launch
    included), ``plain_ms`` the plain version's call and ``plain_device_ms``
    the device time of its launches; the bound is the bytes each moves at
    ``HBM_BYTES_S``: the gradients read (``grad_sumsq``), read and written
    (``scale_to_norm``), and params, gradients and both state tensors read,
    params and state written (``rmsprop_step``)."""
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.models.unet import tree_leaves

    params32, _ = init_unet(UNetConfig(**TRAIN_CONFIG), np.random.default_rng(0), device="cuda")
    params32 = tree_leaves(params32)
    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {name: {"max_abs_err": 0.0, "cases": []} for name in UPDATE_PER_STEP}
    failures = []
    lr = 1e-4

    def bits(t):
        return t.reshape(-1).view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    def same(a, b):
        return len(a) == len(b) and all(x.dtype == y.dtype and x.shape == y.shape
                                        and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))

    def device_sum(fn):
        return sum(device_ms(fn).values())

    for dtype in (torch.float32, torch.bfloat16):
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        params = [p.to(dtype) for p in params32]
        grads = [_randn(gen, p.shape, 1e-2).to(dtype) for p in params]
        sq = [_randn(gen, p.shape, 1e-2).square() for p in params]
        buf = [_randn(gen, p.shape, 1e-1) for p in params]
        want_sq, want_total = mt.grad_sumsq_plain(grads)
        max_norm = want_total.item() / 3
        want_clip = mt.scale_to_norm_plain(grads, want_total, max_norm)
        calls = {
            "grad_sumsq": (lambda: mt.grad_sumsq(grads), lambda: mt.grad_sumsq_plain(grads),
                           nbytes(*grads)),
            "scale_to_norm": (lambda: mt.scale_to_norm(grads, want_total, max_norm),
                              lambda: mt.scale_to_norm_plain(grads, want_total, max_norm),
                              2 * nbytes(*grads)),
            "rmsprop_step": (lambda: mt.rmsprop_step(params, want_clip, sq, buf, lr),
                             lambda: mt.rmsprop_step_plain(params, want_clip, sq, buf, lr),
                             2 * nbytes(*params, *sq, *buf) + nbytes(*want_clip)),
        }
        for name, (fn, plain, moved) in calls.items():
            before = K.launch_counts()[name]
            got, again = fn(), fn()
            torch.cuda.synchronize()
            launched = K.launch_counts()[name] - before
            want = plain()
            if name == "grad_sumsq":
                err = max(((got[0] - want[0]).abs() / want[0].abs()).max().item(),
                          ((got[1] - want[1]).abs() / want[1].abs()).item())
                ok = err <= UPDATE_NORM_RTOL
                tol = f"{UPDATE_NORM_RTOL:g} relative"
                repeat = same([*again], [*got])
            else:
                got, again, want = ((t,) if name == "scale_to_norm" else t
                                    for t in (got, again, want))
                ok = all(same(a, b) for a, b in zip(got, want))
                err = 0.0 if ok else max((a.float() - b.float()).abs().max().item()
                                         for g, w in zip(got, want) for a, b in zip(g, w))
                tol = "bit for bit"
                repeat = all(same(a, b) for a, b in zip(again, got))
            ok = ok and repeat and launched == 2
            del got, again, want
            ms, call_ms = device_sum(fn), time_ms(fn)
            plain_ms, plain_device_ms = time_ms(plain), device_sum(plain)
            bound_ms = moved / HBM_BYTES_S * 1e3
            case = {"case": "unet.64_leaves", "dtype": dt, "leaves": len(params),
                    "values": sum(p.numel() for p in params), "impl": IMPL[name][dt],
                    "max_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                    "plain_device_ms": plain_device_ms, "library_ms": None,
                    "bound_ms": bound_ms, "bound_by": "bytes", "bytes": moved}
            log(f"kernel {name} unet 64 leaves params {dt} [{case['impl']}]: max err {err:.3e} "
                f"(tol {tol}, bitwise repeat {repeat}, {launched} launches in 2 calls) "
                f"ms={ms:.4f} call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
                f"plain_device_ms={plain_device_ms:.4f} bound_ms={bound_ms:.4g} "
                f"({moved / 1e6:.1f} MB) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} {dt}")
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            results[name]["cases"].append(case)
        del params, grads, sq, buf, want_sq, want_total, want_clip, calls
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"chip_smoke: the clip and update kernels disagree with their plain "
                         f"versions: {failures}")
    return results


def _leaves(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """{key path: tensor} of a nested dict / NamedTuple tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    out: dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _worst(errs: dict[str, float], k: int = 3) -> str:
    return ", ".join(f"{n}={e:.2e}" for n, e in sorted(errs.items(), key=lambda t: -t[1])[:k])


def phase_train() -> tuple[dict[str, int], dict]:
    """Phase 5. Returns the train kernels' launches over the phase and the
    step timings."""
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet, param_count
    from tpu_unet_torch.models.unet import tree_map
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    config = UNetConfig(**TRAIN_CONFIG)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    opt = rmsprop_init(params)
    failures = []
    n_params = param_count(params)
    log(f"train model: {n_params} parameters")
    if n_params != TRAIN_PARAMS:
        failures.append(f"{n_params} parameters, expected {TRAIN_PARAMS}")

    def run(step, kernels, amp, images, masks, trees=(params, state, opt), plain_update=False):
        """One step from the seed's trees; (outputs, device ms). Checks the
        step's launches: PER_STEP with kernels="cuda" (TC_PER_STEP of them
        on the tensor cores in bf16), none without; UPDATE_PER_STEP on
        either route, none with ``plain_update`` (the step inside
        ``mt.plain_versions()``)."""
        before = K.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with mt.plain_versions() if plain_update else contextlib.nullcontext():
            out = step(*trees, images, masks, 1e-4)
        end.record()
        end.synchronize()
        after = K.launch_counts()
        for name in after:
            plain = plain_update and name in UPDATE_PER_STEP
            want = 0 if plain else expected_launches(name, kernels, amp)
            if after[name] - before[name] != want:
                failures.append(f"kernels={kernels}: {name} launched "
                                f"{after[name] - before[name]} times in a step, expected {want}")
        if not torch.isfinite(out[3]).item():
            failures.append(f"kernels={kernels}: loss {out[3].item()}")
        return out, start.elapsed_time(end)

    # The main path's run: every count from 0.
    K.reset_launch_counts()

    # Parity at the Carvana production shape, 959x640 batch 4, against the
    # float64 library step as the reference for the gradients.
    imgs, msks = synth_batch(np.random.default_rng(1), *PARITY_BATCH)
    shape = list(imgs.shape)
    images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
    p64 = tree_map(lambda t: t.double(), params)
    ref, _ = run(make_train_step(config, return_grads=True), None, False, images.double(), masks,
                 trees=(p64, state, rmsprop_init(p64)), plain_update=True)
    g64 = _leaves(ref[5])
    log(f"train step {shape} float64 kernels=None: loss {ref[3].item():.6f} "
        f"grad norm {ref[4].item():.6f}")
    del p64, ref
    for amp, dt in ((False, "fp32"), (True, "bf16")):
        outs = {}
        for kernels in ("cuda", None):
            step = make_train_step(config, amp=amp, kernels=kernels, return_grads=True)
            outs[kernels], ms = run(step, kernels, amp, images, masks)
            log(f"train step {shape} {dt} kernels={kernels}: loss {outs[kernels][3].item():.6f} "
                f"grad norm {outs[kernels][4].item():.6f} ({ms:.1f} ms incl. first-call set-up)")
        c, p = outs["cuda"], outs[None]
        gc, gp = _leaves(c[5]), _leaves(p[5])
        bc, bp = _leaves(c[1]), _leaves(p[1])
        finite = all(bool(torch.isfinite(t).all().item()) for t in (*gc.values(), *bc.values()))
        tol = STEP_TOL[dt]
        errs = {
            "loss": abs(c[3].item() - p[3].item()) / abs(p[3].item()),
            "grad_norm": abs(c[4].item() - p[4].item()) / abs(p[4].item()),
            "bn_state": max(_rel_l2(bc[k], bp[k]) for k in bp),
        }
        e_cuda = {k: _rel_l2(gc[k], g64[k]) for k in g64}
        e_plain = {k: _rel_l2(gp[k], g64[k]) for k in g64}
        e_cross = {k: _rel_l2(gc[k], gp[k]) for k in gp}
        over = [k for k in g64 if not e_cuda[k] <= GRAD_RATIO * e_plain[k] + tol["grad_floor"]]
        log(f"train step parity {dt}, kernels=cuda vs None: loss rel err {errs['loss']:.3e} "
            f"(tol {tol['loss']:g}); grad norm rel err {errs['grad_norm']:.3e} "
            f"(tol {tol['grad_norm']:g}); BN running stats rel L2 err max "
            f"{errs['bn_state']:.3e} over {len(bp)} tensors (tol {tol['bn_state']:g}); "
            f"finite={finite}")
        log(f"train step gradients {dt}, rel L2 err to float64 over {len(g64)} tensors: "
            f"cuda max {max(e_cuda.values()):.3e} ({_worst(e_cuda)}), plain max "
            f"{max(e_plain.values()):.3e} ({_worst(e_plain)}); tol cuda <= {GRAD_RATIO:g} x plain "
            f"+ {tol['grad_floor']:g}, {len(over)} over; cuda vs plain max "
            f"{max(e_cross.values()):.3e} ({_worst(e_cross)})")
        if not finite:
            failures.append(f"{dt}: non-finite gradients or BN state")
        for key, err in errs.items():
            if not err <= tol[key]:
                failures.append(f"{dt} parity: {key} error {err:.3e} > {tol[key]:g}")
        failures += [f"{dt} gradient {k}: {e_cuda[k]:.3e} from float64 vs plain "
                     f"{e_plain[k]:.3e}" for k in over]
        del outs, c, p, gc, gp, bc, bp
        torch.cuda.empty_cache()
    del images, masks, g64

    # Timing at 572x572 batch 16, in turns: plain, cuda, cuda, plain; bf16
    # after 2 warm-ups, fp32 (about 3x the time a step) after 1.
    imgs, msks = synth_batch(np.random.default_rng(2), *TIMING_BATCH)
    n, shape = imgs.shape[0], list(imgs.shape)
    images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
    timing: dict[str, dict] = {}
    for amp, dt, warm in ((True, "bf16", 2), (False, "fp32", 1)):
        steps = {k: make_train_step(config, amp=amp, kernels=k) for k in ("cuda", None)}
        timing[dt] = {"cuda": [], "plain": []}
        for kernels in (None, "cuda", "cuda", None):
            for _ in range(warm):
                run(steps[kernels], kernels, amp, images, masks)
            torch.cuda.reset_peak_memory_stats()
            times = [run(steps[kernels], kernels, amp, images, masks)[1] for _ in range(3)]
            peak = torch.cuda.max_memory_allocated()
            ms = statistics.median(times)
            tag = "cuda" if kernels == "cuda" else "plain"
            timing[dt][tag].append({"ms": ms, "img_s": n * 1e3 / ms, "peak_bytes": peak,
                                    "times_ms": times})
            log(f"train step {shape} {dt} kernels={kernels}: {ms:.2f} ms/step (median of "
                f"{' '.join(f'{t:.2f}' for t in times)}), {n * 1e3 / ms:.2f} img/s, peak memory "
                f"{peak / 2**30:.3f} GiB")
        timing[dt]["profile"] = profile_step(steps["cuda"], (params, state, opt), images, masks,
                                             dt)
        del steps
        torch.cuda.empty_cache()
    launches = K.launch_counts()
    log(f"launches in phase 5: {json.dumps(launches)}")
    if failures:
        raise SystemExit(f"chip_smoke: train checks failed: {failures}")
    return launches, timing


# Phase 6: the train CLI at full width on synthetic Carvana-layout data at
# the production size (1918x1280 PNGs, scale 0.5 -> 959x640), batch 4, bf16.
# 10 images with 20% for validation: 8 train images, 2 steps an epoch, one
# validation an epoch.
CLI_IMAGES = 10
CLI_ARGS = ("-s", "0.5", "-b", "4", "--amp", "--epochs", "2", "--validation", "20",
            "--val-per-epoch", "1", "--save-optimizer")
CLI_STEPS = 4
# --kernels cuda vs --kernels torch runs. The first step's loss is held to
# STEP_TOL["bf16"]["loss"] (the same weights and batch: phase 5's check).
# Later steps start from weights that the two runs' bf16 gradients moved
# apart, at lr 1e-5 by at most 10·lr per RMSprop step and element: their
# losses are held to 5e-3 relative (measured <= 2.3e-5 on the H100). The
# val Dice thresholds the eval-mode logits of a random-weight network (the
# plain forward in both runs) whose weights differ by those updates alone;
# two steps move that Dice by 0.10-0.12, and down4's bf16 gradients differ
# by 14% between the paths (phase 5), which RMSprop's per-element
# normalisation passes on to their updates. Measured: equal at the first
# validation, 2.3e-2 apart at the second; held to 5e-2 absolute, with the
# pixels whose class differs reported beside it.
CLI_LOSS_TOL = 5e-3
CLI_DICE_TOL = 5e-2


class _TimedFeed:
    """A device-side feed (``DevicePipeline``, the resident corpus's batches)
    whose waits are added to ``stats["loader_wait_s"]``; the first batch is
    kept in ``stats["first_batch"]`` (on the host)."""

    def __init__(self, loader, stats: dict):
        self.loader, self.stats = loader, stats

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            self.stats["loader_wait_s"] += time.perf_counter() - t
            if batch is None:
                return
            if "first_batch" not in self.stats:
                self.stats["first_batch"] = {k: v.cpu() for k, v in batch.items()}
            yield batch


def _timed_loop_hooks(train_mod, stats: dict):
    """Wrap the train loop's loader feed (the host prefetch, or a device-side
    feed) and evaluation to time the host's waits on the loader and each
    validation (synchronised: evaluate fetches its sums), and keep the first
    augmented batch in ``stats["first_augmented"]``. Returns a function that
    restores the originals."""
    real_prefetch, real_eval = train_mod.prefetch_to_device, train_mod.evaluate
    real_build, real_augment = train_mod._build_loaders, train_mod.augment_batch

    def prefetch(*a, **k):
        it = real_prefetch(*a, **k)
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            stats["loader_wait_s"] += time.perf_counter() - t
            if batch is None:
                return
            yield batch

    def evaluate(*a, **k):
        t = time.perf_counter()
        out = real_eval(*a, **k)
        stats["val_s"] += time.perf_counter() - t
        return out

    def build_loaders(*a, **k):
        train, val = real_build(*a, **k)
        staged = getattr(getattr(train, "parent", None), "staged_bytes", None)
        if staged is not None:
            stats["staged_mb"] = staged / 1e6
        if isinstance(train, train_mod.DataLoader):  # the host feed: timed in prefetch
            return train, val
        return _TimedFeed(train, stats), val

    def augment_batch(*a, **k):
        out = real_augment(*a, **k)
        if "first_augmented" not in stats:
            stats["first_augmented"] = [t.cpu() for t in out]
        return out

    train_mod.prefetch_to_device, train_mod.evaluate = prefetch, evaluate
    train_mod._build_loaders, train_mod.augment_batch = build_loaders, augment_batch

    def restore():
        train_mod.prefetch_to_device, train_mod.evaluate = real_prefetch, real_eval
        train_mod._build_loaders, train_mod.augment_batch = real_build, real_augment

    return restore


def _cli_run(argv: list[str], tag: str) -> tuple[dict, dict, dict]:
    """One in-process ``train_cli.main`` run with the launch counts reset just
    before it and read just after. Returns (history, launches, stats)."""
    import tpu_unet_torch.train as train_mod
    from tpu_unet_torch import train_cli

    stats = {"loader_wait_s": 0.0, "val_s": 0.0}
    restore = _timed_loop_hooks(train_mod, stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        _, _, history = train_cli.main(argv)
        torch.cuda.synchronize()
    finally:
        restore()
    stats["wall_s"] = time.perf_counter() - t0
    launches = K.launch_counts()
    stats["peak_bytes"] = torch.cuda.max_memory_allocated()
    steps = len(history["train_loss"])
    stats["steps"] = steps
    stats["img_s"] = steps * 4 / stats["wall_s"]
    log(f"train_cli {tag}: {steps} steps, {len(history['val_dice'])} validations in "
        f"{stats['wall_s']:.2f} s wall ({stats['img_s']:.3f} img/s over the whole loop), "
        f"loader wait {stats['loader_wait_s']:.2f} s, validation {stats['val_s']:.2f} s, "
        f"peak device memory {stats['peak_bytes'] / 2**30:.3f} GiB"
        + (f", staged {stats['staged_mb']:.1f} MB" if "staged_mb" in stats else "")
        + "; losses "
        + " ".join(f"{v:.6f}" for v in history["train_loss"])
        + f"; val Dice {' '.join(f'{v:.6f}' for v in history['val_dice'])}; lr {history['lr']}")
    return history, launches, stats


def _compare_val_masks(workdir: Path, config) -> None:
    """Where the two runs' final weights disagree on the validation images:
    the share of pixels whose thresholded class differs, and the largest
    |logit| (of the --kernels torch weights) among them, in the eval-mode
    bf16 forward the validation runs."""
    from tpu_unet_torch.checkpoint import load_checkpoint
    from tpu_unet_torch.data import CarvanaDataset, random_split_indices
    from tpu_unet_torch.models.unet import unet_apply

    ds = CarvanaDataset(workdir / "data" / "imgs", workdir / "data" / "masks", 0.5)
    _, val_idx = random_split_indices(len(ds), 0.2, seed=0)
    x = torch.from_numpy(np.stack([ds[i]["image"] for i in val_idx])).cuda()
    logits = {}
    for k in ("cuda", "torch"):
        params, state, _, _ = load_checkpoint(workdir / f"ck_{k}" / "checkpoint_epoch2.npz",
                                              config, "cuda")
        with torch.no_grad():
            logits[k] = unet_apply(params, state, x, config=config,
                                   compute_dtype=torch.bfloat16)[0][..., 0]
    differ = (logits["cuda"] > 0) != (logits["torch"] > 0)
    margin = logits["torch"][differ].abs().max().item() if differ.any() else 0.0
    log(f"val masks after epoch 2, --kernels cuda vs torch weights: {differ.float().mean().item():.4%} "
        f"of pixels differ, largest |logit| among them {margin:.4f} (|logit| mean "
        f"{logits['torch'].abs().mean().item():.4f}, std {logits['torch'].std().item():.4f})")


def phase_train_cli(workdir: Path) -> tuple[dict[str, int], dict]:
    """Phase 6: ``tpu_unet_torch.train_cli.main`` at full width, with
    ``--kernels cuda`` and ``--kernels torch``, then a ``--resume`` run and
    the port's ``predict`` on the epoch checkpoints. Returns the train
    kernels' launches in the ``--kernels cuda`` run and the runs' numbers."""
    import tpu_unet_torch.train as train_mod
    from tpu_unet_torch import predict
    from tpu_unet_torch.checkpoint import save_checkpoint
    from tpu_unet_torch.data import make_synthetic_carvana
    from tpu_unet_torch.models import UNetConfig, init_unet

    failures = []
    t0 = time.perf_counter()
    img_dir, _ = make_synthetic_carvana(workdir / "data", n=CLI_IMAGES, h=1280, w=1918, seed=0)
    config = UNetConfig(**TRAIN_CONFIG)
    init = workdir / "init.npz"
    save_checkpoint(init, *init_unet(config, np.random.default_rng(0)),
                    extra={"config": config._asdict()})
    log(f"train_cli data: {CLI_IMAGES} 1918x1280 PNG pairs and a full-width checkpoint "
        f"written in {time.perf_counter() - t0:.2f} s")
    common = [*CLI_ARGS, "--data-dir", str(workdir / "data"), "--load", str(init)]
    runs = {}
    for kernels in ("cuda", "torch"):
        ck = workdir / f"ck_{kernels}"
        history, launches, stats = _cli_run(
            common + ["--kernels", kernels, "--checkpoint-dir", str(ck),
                      "--history-out", str(workdir / f"history_{kernels}.json")],
            f"--kernels {kernels}")
        runs[kernels] = (history, launches, stats)
        steps = len(history["train_loss"])
        for name, count in launches.items():
            want = expected_launches(name, kernels, True, steps)
            if count != want:
                failures.append(f"--kernels {kernels}: {name} launched {count} times, "
                                f"expected {want}")
        if steps != CLI_STEPS or len(history["val_dice"]) != 2:
            failures.append(f"--kernels {kernels}: {steps} steps, "
                            f"{len(history['val_dice'])} validations")
        if not all(np.isfinite(history["train_loss"])):
            failures.append(f"--kernels {kernels}: non-finite loss")
        json.loads((workdir / f"history_{kernels}.json").read_text())

    # (b) the two runs agree.
    lc, lt = (np.asarray(runs[k][0]["train_loss"]) for k in ("cuda", "torch"))
    rel = np.abs(lc - lt) / np.abs(lt)
    dc, dtc = (np.asarray(runs[k][0]["val_dice"]) for k in ("cuda", "torch"))
    log(f"train_cli parity, --kernels cuda vs torch: loss rel err per step "
        + " ".join(f"{r:.3e}" for r in rel)
        + f" (tol step 1 {STEP_TOL['bf16']['loss']:g}, later {CLI_LOSS_TOL:g}); val Dice abs "
        f"err {' '.join(f'{d:.3e}' for d in np.abs(dc - dtc))} (tol {CLI_DICE_TOL:g})")
    if not (rel[0] <= STEP_TOL["bf16"]["loss"] and (rel[1:] <= CLI_LOSS_TOL).all()):
        failures.append(f"train_cli losses differ: {rel.tolist()}")
    if not (np.abs(dc - dtc) <= CLI_DICE_TOL).all():
        failures.append(f"train_cli val Dice differ: {dc.tolist()} vs {dtc.tolist()}")
    _compare_val_masks(workdir, config)

    # (c) the epoch checkpoints carry the palette, the config and the
    # optimizer state, and the port's predict renders a mask from each.
    ck = workdir / "ck_cuda"
    for epoch in (1, 2):
        path = ck / f"checkpoint_epoch{epoch}.npz"
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"].tolist()).decode("utf-8"))
            n_opt = sum(k.startswith("opt/square_avg/") for k in z.files)
            n_params = sum(k.startswith("params/") for k in z.files)
        ok = (meta["mask_values"] == [0, 255] and meta["extra"].get("config") == config._asdict()
              and meta["has_opt_state"] and n_opt == n_params)
        out = workdir / f"mask_epoch{epoch}.png"
        K.reset_launch_counts()
        predict.main(["-m", str(path), "-i", str(sorted(img_dir.glob("*.png"))[0]), "-o", str(out),
                      "--kernels", "cuda", "--amp"])
        pl = K.launch_counts()
        mask = np.asarray(Image.open(out))
        log(f"checkpoint_epoch{epoch}.npz: mask_values {meta['mask_values']}, config "
            f"{'stored' if 'config' in meta['extra'] else 'missing'}, optimizer state "
            f"{n_opt} square_avg tensors; predict --kernels cuda -> {out.name} {mask.shape} "
            f"values {np.unique(mask).tolist()}, launches {json.dumps(pl)}")
        if not (ok and mask.shape == (1280, 1918) and set(np.unique(mask).tolist()) <= {0, 255}
                and all(pl[k] == v for k, v in {**PER_FORWARD, **TC_PER_FORWARD}.items())):
            failures.append(f"checkpoint_epoch{epoch}: checkpoint or predict check failed")

    # (d) --resume from epoch 1 starts at epoch 2 with the saved optimizer and
    # scheduler state (read back from what _restore_resume returns).
    seen = {}
    real_restore = train_mod._restore_resume

    def restore(resume, params, bn_state, opt_state, scheduler, **kw):
        out = real_restore(resume, params, bn_state, opt_state, scheduler, **kw)
        seen.update(opt=out[2], start_epoch=out[3], scheduler=scheduler.state_dict())
        return out

    train_mod._restore_resume = restore
    try:
        history, _, _ = _cli_run(common + ["--kernels", "cuda", "--checkpoint-dir",
                                           str(workdir / "ck_resume"), "--resume",
                                           str(ck / "checkpoint_epoch1.npz")], "--resume epoch1")
    finally:
        train_mod._restore_resume = real_restore
    with np.load(ck / "checkpoint_epoch1.npz") as z:
        meta = json.loads(bytes(z["__meta__"].tolist()).decode("utf-8"))
        saved_sched = {k: v for k, v in meta["extra"]["scheduler"].items() if k != "name"}
        opt_equal = all(np.array_equal(t.cpu().numpy(), z["opt" + k])
                        for k, t in _leaves(seen["opt"]).items())
    log(f"resume: start epoch {seen['start_epoch']}, optimizer state equal to the file's: "
        f"{opt_equal}, scheduler {seen['scheduler']} (saved {saved_sched}), "
        f"{len(history['train_loss'])} steps run")
    if not (seen["start_epoch"] == 2 and opt_equal and seen["scheduler"] == saved_sched
            and len(history["train_loss"]) == CLI_STEPS // 2
            and (workdir / "ck_resume" / "checkpoint_epoch2.npz").exists()):
        failures.append("resume from checkpoint_epoch1.npz failed its checks")
    if failures:
        raise SystemExit(f"chip_smoke: train CLI checks failed: {failures}")
    return runs["cuda"][1], {k: v[2] for k, v in runs.items()}


def phase_remat() -> dict:
    """Phase 6b: one 572x572 batch-16 bf16 step with remat against one
    without, both kernels="cuda", from the same trees: loss and gradients
    equal bit for bit (the kernels' sums are fixed-order; cuDNN, which runs
    the transposed convs and the head, is made deterministic here). remat
    runs every block's forward kernels again in the backward pass."""
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    config = UNetConfig(**TRAIN_CONFIG)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    opt = rmsprop_init(params)
    imgs, msks = synth_batch(np.random.default_rng(2), *TIMING_BATCH)
    images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    outs, numbers, failures = {}, {}, []
    try:
        for remat in (False, True):
            step = make_train_step(config, amp=True, kernels="cuda", remat=remat,
                                   return_grads=True)
            step(params, state, opt, images, masks, 1e-4)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs[remat] = step(params, state, opt, images, masks, 1e-4)
            end.record()
            end.synchronize()
            launches = K.launch_counts()
            numbers[remat] = {"ms": start.elapsed_time(end),
                              "peak_bytes": torch.cuda.max_memory_allocated(),
                              "launches": launches}
            want = {k: expected_launches(k, "cuda", True) * (2 if remat and "fwd" in k else 1)
                    for k in launches}
            if any(launches[k] != v for k, v in want.items()):
                failures.append(f"remat={remat}: launches {launches}, expected {want}")
            log(f"train step {list(imgs.shape)} bf16 kernels=cuda remat={remat}: "
                f"{numbers[remat]['ms']:.2f} ms, peak memory "
                f"{numbers[remat]['peak_bytes'] / 2**30:.3f} GiB, launches {json.dumps(launches)}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = outs[False], outs[True]
    ga, gb = _leaves(a[5]), _leaves(b[5])
    same = torch.equal(a[3], b[3]) and all(torch.equal(ga[k], gb[k]) for k in ga)
    worst = max(_rel_l2(gb[k], ga[k]) for k in ga)
    log(f"remat vs no remat: loss {a[3].item():.8f} / {b[3].item():.8f}, gradients bitwise "
        f"equal: {same} (largest per-tensor rel L2 difference {worst:.3e})")
    if not same:
        failures.append(f"remat changed the loss or gradients (rel L2 up to {worst:.3e})")
    if failures:
        raise SystemExit(f"chip_smoke: remat checks failed: {failures}")
    return numbers


def calibrate_bn(params, state, config, x):
    """BN running statistics set to the batch statistics of ``x`` (NHWC fp32
    on the card), layer by layer in plain PyTorch, so that every BN of the
    random-weight model normalises as a trained one would and the logits
    vary over the image instead of collapsing to the head's bias."""
    from tpu_unet_torch.ops import BNState, conv2d, conv_transpose2d, max_pool2d, pad_to_match

    def dc(p, h):
        new = {}
        for i in ("1", "2"):
            z = conv2d(h, p[f"conv{i}"]["w"], padding=1)
            mean, var = z.mean((0, 1, 2)), z.var((0, 1, 2), unbiased=False)
            new[f"bn{i}"] = BNState(mean, var)
            bn = p[f"bn{i}"]
            h = torch.relu((z - mean) * torch.rsqrt(var + 1e-5) * bn["scale"] + bn["bias"])
        return h, new

    new_state = {}
    skips = []
    h = x
    for name in ("inc", "down1", "down2", "down3", "down4"):
        h, new_state[name] = dc(params[name], max_pool2d(h) if name != "inc" else h)
        skips.append(h)
    for i, skip in zip(range(1, 5), skips[-2::-1]):
        up = params[f"up{i}"]["up"]
        u = pad_to_match(conv_transpose2d(h, up["w"], stride=2) + up["b"], skip)
        h, conv_state = dc(params[f"up{i}"]["conv"], torch.cat([skip, u], dim=-1))
        new_state[f"up{i}"] = {"conv": conv_state}
    return new_state


def post(port: int, body: bytes, path: str = "/predict") -> tuple[int, bytes, float]:
    conn = HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, r.read(), time.perf_counter() - t0
    finally:
        conn.close()


def get_json(port: int, path: str) -> dict:
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def phase_serve(workdir: Path) -> dict[str, int]:
    """Phases 3 and 4. Returns each kernel's launches during the served run."""
    from tpu_unet_torch import serve
    from tpu_unet_torch.checkpoint import save_checkpoint
    from tpu_unet_torch.data import make_synthetic_carvana, preprocess
    from tpu_unet_torch.models import UNetConfig, fold_bn, init_unet, param_count, unet_infer_apply
    from tpu_unet_torch.models.unet import tree_map
    from tpu_unet_torch.ops import resize_bilinear
    from tpu_unet_torch.predict import logits_to_mask, mask_to_image

    # Phase 3: the full-width model, checkpointed, served in this process.
    config = UNetConfig(n_channels=3, n_classes=1, bilinear=False, base_channels=64)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    img_dir, _ = make_synthetic_carvana(workdir / "data", n=4, h=1280, w=1918, seed=0)
    paths = sorted(img_dir.glob("*.png"))
    calib = torch.from_numpy(preprocess(Image.open(paths[0]), 0.5))[None].cuda()
    with torch.inference_mode():
        state = calibrate_bn(params, state, config, calib)
    ckpt = workdir / "unet_base64.npz"
    save_checkpoint(ckpt, params, state, [0, 1], {"config": config._asdict()})
    log(f"model: {param_count(params)} parameters, checkpoint {ckpt.stat().st_size} bytes")

    t0 = time.perf_counter()
    server, predictor = serve.make_server(
        ["-m", str(ckpt), "--port", "0", "--kernels", "cuda", "--warmup", "1280x1918"])
    log(f"server: loaded and warmed in {time.perf_counter() - t0:.1f} s "
        f"(kernels={predictor.kernels}, amp={predictor.amp}, device={predictor.device})")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    bodies = [p.read_bytes() for p in paths]
    try:
        # Phase 4: the served run. Sequential requests at the default 5 ms
        # batch window, then all images at once with a window wide enough
        # that they form one micro-batch.
        K.reset_launch_counts()
        responses = []
        for body in bodies:
            responses.append(post(port, body))
        predictor.batch_window = 0.25
        burst: list = [None] * len(bodies)

        def call(k):
            burst[k] = post(port, bodies[k])

        threads = [threading.Thread(target=call, args=(k,)) for k in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        launches = K.launch_counts()
        metrics = get_json(port, "/metrics")
        health = get_json(port, "/healthz")
    finally:
        server.shutdown()
        server.server_close()
        predictor.stop()
        thread.join(timeout=10)
    log(f"healthz: {json.dumps(health)}")
    log(f"metrics: {json.dumps(metrics)}")
    log("sequential request latency ms (client): "
        + " ".join(f"{r[2] * 1e3:.1f}" for r in responses))
    log(f"launches in the served run: {json.dumps(launches)}")

    failures = []
    if any(r is None for r in burst):
        failures.append("a concurrent request did not finish")
    dispatches = metrics.get("dispatches", 0)
    if metrics.get("dispatch_batch_mean", 0) <= 1:
        failures.append("no micro-batch formed")
    for name, per in {**PER_FORWARD, **TC_PER_FORWARD}.items():
        if launches[name] != per * dispatches:
            failures.append(f"{name}: {launches[name]} launches, expected {per} x {dispatches}")

    # Each served mask vs the plain forward (--kernels torch, bf16) on the
    # card, with the largest plain |logit| among the pixels where they differ.
    folded_bf16 = tree_map(lambda t: t.cuda().to(torch.bfloat16), fold_bn(params, state, config))
    served = responses + [r for r in burst if r is not None]
    for k, (status, data, _) in enumerate(served):
        path = paths[k % len(paths)]
        if status != 200:
            failures.append(f"request {k}: HTTP {status}")
            continue
        mask_img = Image.open(io.BytesIO(data))
        mask = np.asarray(mask_img).astype(np.int64)
        img = Image.open(path)
        with torch.inference_mode():
            x = torch.from_numpy(preprocess(img, 0.5))[None].cuda()
            z = unet_infer_apply(folded_bf16, x, config=config, backend="torch",
                                 compute_dtype=torch.bfloat16)
            z = resize_bilinear(z, img.height, img.width, align_corners=False)[0]
            ref = logits_to_mask(z, 1, 0.5).astype(np.int64)
        z = z[..., 0].cpu().numpy()
        differ = mask != ref
        agree = 1.0 - float(differ.mean())
        margin = float(np.abs(z[differ]).max()) if differ.any() else 0.0
        log(f"request {k} ({path.name}): PNG {mask_img.size} mode {mask_img.mode}, "
            f"foreground {mask.mean():.4f}, agreement with --kernels torch {agree:.6f}, "
            f"largest plain |logit| where they differ {margin:.4f} (|logit| std {z.std():.4f})")
        if mask_img.size != (1918, 1280):
            failures.append(f"request {k}: mask size {mask_img.size}")
        if not set(np.unique(mask).tolist()) <= {0, 1}:
            failures.append(f"request {k}: values outside the palette [0, 1]")
        if agree < MASK_AGREEMENT:
            failures.append(f"request {k}: agreement {agree:.6f} < {MASK_AGREEMENT}")

    # Where one sequential request's time goes, by the host clock around
    # synchronised steps (the server does the same steps in this order).
    t = [time.perf_counter()]
    img = Image.open(io.BytesIO(bodies[0]))
    img.load()
    t.append(time.perf_counter())
    arr = preprocess(img, 0.5)
    t.append(time.perf_counter())
    with torch.inference_mode():
        x = torch.from_numpy(arr)[None].cuda()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        logits = predictor.forward(x)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        lg = resize_bilinear(logits, img.height, img.width, align_corners=False)
        mask = logits_to_mask(lg[0], 1, 0.5)
    t.append(time.perf_counter())
    mask_to_image(mask, [0, 1]).save(io.BytesIO(), format="PNG")
    t.append(time.perf_counter())
    steps = ("png_decode", "resize_bicubic", "h2d", "forward", "upscale_threshold_d2h",
             "png_encode")
    log("request breakdown ms: " + " ".join(
        f"{name}={(t[i + 1] - t[i]) * 1e3:.2f}" for i, name in enumerate(steps))
        + f" total={(t[-1] - t[0]) * 1e3:.2f}")

    # The whole forward in fp32, kernels vs plain, with FP32_PER_FORWARD's
    # launches (every conv on the tensor cores in 3xTF32, 3 pools in the
    # double convs' epilogue), and both forwards' times (bf16 and fp32, in
    # turns: torch, cuda, cuda, torch).
    x = torch.from_numpy(preprocess(Image.open(paths[1]), 0.5))[None].cuda()
    folded = tree_map(lambda t: t.cuda(), fold_bn(params, state, config))
    with torch.inference_mode():
        K.reset_launch_counts()
        got = unet_infer_apply(folded, x, config=config, backend="cuda")
        torch.cuda.synchronize()
        fp32_counts = K.launch_counts()
        log(f"launches in one fp32 forward: {json.dumps(fp32_counts)}")
        for name, count in fp32_counts.items():
            if count != FP32_PER_FORWARD.get(name, 0):
                failures.append(f"fp32 forward: {name} {count}, expected "
                                f"{FP32_PER_FORWARD.get(name, 0)}")
        ref = unet_infer_apply(folded, x, config=config, backend="torch")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        finite = bool(torch.isfinite(got).all().item())
        log(f"forward fp32 [1,640,959,3]: logits {tuple(got.shape)} finite={finite} "
            f"max_abs_err={err:.3e} (max |logit| {scale:.3e})")
        if not finite or err > 1e-3 * max(scale, 1.0):
            failures.append(f"fp32 forward: kernels vs plain max_abs_err {err:.3e}")
        fb = tree_map(lambda t: t.to(torch.bfloat16), folded)
        got = unet_infer_apply(fb, x, config=config, backend="cuda", compute_dtype=torch.bfloat16)
        ref = unet_infer_apply(fb, x, config=config, backend="torch", compute_dtype=torch.bfloat16)
        d = (got - ref).abs().flatten()
        log(f"forward bf16 [1,640,959,3]: |logit| std {ref.std().item():.4f}, kernels vs plain "
            f"|diff| mean {d.mean().item():.3e} p99.9 {d.quantile(0.999).item():.3e} "
            f"max {d.max().item():.3e}; sign agreement {((got > 0) == (ref > 0)).float().mean().item():.6f}")
        for dtype in (torch.bfloat16, torch.float32):
            fd = tree_map(lambda t, d=dtype: t.to(d), folded)
            runs = [(b, time_ms(lambda b=b, fd=fd, d=dtype: unet_infer_apply(
                fd, x, config=config, backend=b, compute_dtype=d), reps=5))
                for b in ("torch", "cuda", "cuda", "torch")]
            log(f"forward {str(dtype).split('.')[-1]} [1,640,959,3] ms (median of 5, in turns): "
                + " ".join(f"{b}={ms:.3f}" for b, ms in runs))
    if failures:
        raise SystemExit(f"chip_smoke: serving checks failed: {failures}")
    return launches


# Phase 7: the predict surface. Batched and single predict masks must agree
# on this share of pixels (fp32; cuDNN may pick another algorithm for batch
# 4 than for batch 1, so they agree to rounding, not bit for bit).
BATCH_AGREEMENT = 0.9999
# fp32 logits held to this share of the reference logits' range: TTA
# against four hand-flipped forwards, tiled against full-image.
RANGE_TOL = 1e-3
TILE, HALO, TILE_SIZE = 512, 128, 2048  # BASELINE.json config #4, tools/bench_tiles.py
PADDED_TILE = 128  # the padded sweep at 959x640 (960x640 after padding)


def _mask_agreement(a: np.ndarray, b: np.ndarray) -> tuple[float, int]:
    differ = int((np.asarray(a) != np.asarray(b)).sum())
    return 1.0 - differ / np.asarray(a).size, differ


def _peak_gib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def phase_predict_surface(workdir: Path, ckpt: Path, train_data: Path, card: str) -> dict:
    """Phase 7: the single-GPU predict surface on the phase-3 checkpoint (the
    full-width flagship, BN calibrated): ``.pth`` round trip, batched
    predict, TTA, the tiled sweep (BASELINE config #4 and the padded 959x640
    path), the tiled TTA server, ``evaluate --tta`` and the CRF. Returns its
    numbers."""
    from tpu_unet_torch import evaluate, predict, serve
    from tpu_unet_torch.checkpoint import (
        average_checkpoints,
        export_pth,
        flatten,
        import_pth,
        load_checkpoint,
    )
    from tpu_unet_torch.data import make_synthetic_carvana, preprocess
    from tpu_unet_torch.models import UNetConfig
    from tpu_unet_torch.models.tta import TTA_FLIPS, flip, tta_logits
    from tpu_unet_torch.models.unet import unet_apply
    from tpu_unet_torch.parallel.tiling import (
        predict_img_tiled,
        tiled_forward,
        tiled_forward_padded,
    )
    from tpu_unet_torch.postprocess import crf_refine_binary

    failures: list[str] = []
    numbers: dict = {"card": card}
    cuda = torch.device("cuda")
    config = UNetConfig(n_channels=3, n_classes=1, bilinear=False, base_channels=64)
    params, state, config, _ = predict.load_model(ckpt, config, cuda)
    big, _ = make_synthetic_carvana(workdir / "big", n=6, h=1280, w=1918, seed=7)
    small, _ = make_synthetic_carvana(workdir / "small", n=2, h=960, w=1280, seed=8)
    inputs = [str(p) for d in (big, small) for p in sorted(d.glob("*.png"))]
    one = Image.open(inputs[0])

    # .pth round trip: bitwise arrays, equal predict PNGs, averaging with itself.
    t0 = time.perf_counter()
    pth = workdir / "unet_base64.pth"
    export_pth(pth, params, state, config, mask_values=[0, 1])
    p2, s2, mv = import_pth(pth, config, cuda)
    want, got = flatten(params, state), flatten(p2, s2)
    unequal = [k for k in want if k not in got or not np.array_equal(want[k], got[k])]
    if unequal or set(got) != set(want) or mv != [0, 1]:
        failures.append(f".pth round trip: {len(unequal)} arrays differ, palette {mv}")
    for model in (pth, ckpt):
        predict.main(["-m", str(model), "-i", inputs[0],
                      "-o", str(workdir / f"{model.suffix[1:]}.png")])
    same, differ = _mask_agreement(np.asarray(Image.open(workdir / "pth.png")),
                                   np.asarray(Image.open(workdir / "npz.png")))
    if differ:
        failures.append(f"predict -m x.pth vs x.npz: {differ} pixels differ")
    average_checkpoints([ckpt, ckpt], workdir / "avg.npz")
    ap, as_, _, _ = load_checkpoint(workdir / "avg.npz", config)
    avg_unequal = [k for k, v in flatten(ap, as_).items() if not np.array_equal(v, want[k])]
    if avg_unequal:
        failures.append(f"average_checkpoints(ckpt, ckpt): {len(avg_unequal)} arrays changed")
    log(f"pth: {len(want)} arrays bitwise equal after export/import: {not unequal}; predict "
        f"-m x.pth vs x.npz differing pixels {differ}; average of the checkpoint with itself "
        f"unchanged: {not avg_unequal} ({time.perf_counter() - t0:.1f} s)")

    # Batched predict, fp32: 6 images of 1918x1280 then 2 of 1280x960, so a
    # group of 4 flushes at its size, then at the change of size.
    groups: list[int] = []
    real_forward = predict._forward_full

    def recording(params, state, x, **kw):
        groups.append(int(x.shape[0]))
        return real_forward(params, state, x, **kw)

    predict._forward_full = recording
    try:
        wall = {}
        for rep, bs in enumerate((1, 4, 4, 1)):
            outs = [str(workdir / f"b{bs}_{k}.png") for k in range(len(inputs))]
            groups.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict.main(["-m", str(ckpt), "-i", *inputs, "-o", *outs, "--batch-size", str(bs)])
            torch.cuda.synchronize()
            wall.setdefault(bs, []).append(time.perf_counter() - t0)
            want_groups = [1] * 8 if bs == 1 else [4, 2, 2]
            if groups != want_groups:
                failures.append(f"--batch-size {bs}: groups {groups}, expected {want_groups}")
    finally:
        predict._forward_full = real_forward
    worst, total_differ = 1.0, 0
    for k in range(len(inputs)):
        a, differ = _mask_agreement(np.asarray(Image.open(workdir / f"b4_{k}.png")),
                                    np.asarray(Image.open(workdir / f"b1_{k}.png")))
        worst, total_differ = min(worst, a), total_differ + differ
    if worst < BATCH_AGREEMENT:
        failures.append(f"--batch-size 4 vs 1: agreement {worst:.6f} < {BATCH_AGREEMENT}")
    ips = {bs: [round(len(inputs) / s, 3) for s in v] for bs, v in wall.items()}
    numbers["predict_images_per_s"] = ips
    log(f"batched predict fp32, 8 images (6 of 1918x1280, 2 of 1280x960), scale 0.5, CLI wall "
        f"clock incl. PNG decode/resize/encode, runs in turns b1 b4 b4 b1: images/s "
        f"--batch-size 1 {ips[1]}, --batch-size 4 {ips[4]}; masks b4 vs b1: worst agreement "
        f"{worst:.6f}, {total_differ} pixels differ in all ({card})")

    # TTA at 959x640, fp32: tta_logits against four hand-flipped forwards.
    x = torch.from_numpy(preprocess(one, 0.5))[None].to(cuda)
    with torch.inference_mode():
        got = tta_logits(params, state, x, config=config)
        parts = [flip(unet_apply(params, state, flip(x, fh, fw), config=config)[0], fh, fw)
                 for fh, fw in TTA_FLIPS]
        ref = (parts[0] + parts[1] + parts[2] + parts[3]) / 4
        err = (got - ref).abs().max().item()
        span = (ref.max() - ref.min()).item()
    del parts
    if not err <= RANGE_TOL * span:
        failures.append(f"tta_logits vs four flipped forwards: {err:.3e} > "
                        f"{RANGE_TOL} x {span:.3e}")
    for mode in ("flips", "hflip"):
        predict.main(["-m", str(ckpt), "-i", inputs[0], "-o", str(workdir / f"tta_{mode}.png"),
                      "--tta", "--tta-mode", mode])
        m = np.asarray(Image.open(workdir / f"tta_{mode}.png"))
        if m.shape != (one.height, one.width):
            failures.append(f"predict --tta --tta-mode {mode}: mask {m.shape}")
    log(f"tta fp32 [1,640,959,3]: tta_logits vs four hand-flipped forwards max_abs_err "
        f"{err:.3e} (logit range {span:.3e}); predict --tta and --tta-mode hflip ran")

    # Tiled, BASELINE config #4: 2048² at scale 1.0, tile 512, halo 128.
    timg, _ = make_synthetic_carvana(workdir / "tile", n=1, h=TILE_SIZE, w=TILE_SIZE, seed=9)
    tpath = next(timg.glob("*.png"))
    big_img = Image.open(tpath)
    x = torch.from_numpy(preprocess(big_img, 1.0))[None].to(cuda)
    n_tiles = (TILE_SIZE // TILE) ** 2
    with torch.inference_mode():
        full, _ = unet_apply(params, state, x, config=config)
        tiled = tiled_forward(params, state, x, config=config, tile=TILE, halo=HALO)
        err = (tiled - full).abs().max().item()
        span = (full.max() - full.min()).item()
        agree, differ = _mask_agreement((tiled > 0).cpu().numpy(), (full > 0).cpu().numpy())
        del full, tiled
        if not err <= RANGE_TOL * span:
            failures.append(f"tiled {TILE_SIZE}² vs full: {err:.3e} > {RANGE_TOL} x {span:.3e}")
        if agree < BATCH_AGREEMENT:
            failures.append(f"tiled {TILE_SIZE}² masks: agreement {agree:.6f}")
        log(f"tiled fp32 {tuple(x.shape)} tile {TILE} halo {HALO} ({n_tiles} tiles): max_abs_err "
            f"vs full image {err:.3e} (logit range {span:.3e}), mask agreement {agree:.6f} "
            f"({differ} pixels differ)")
        # The padded sweep at 959x640 (960 after padding), tile 128, against
        # the full-image forward of the unpadded image away from the padded
        # right edge (two halos).
        x959 = torch.from_numpy(preprocess(one, 0.5))[None].to(cuda)
        padded = tiled_forward_padded(params, state, x959, config=config, tile=PADDED_TILE,
                                      halo=HALO)
        full959, _ = unet_apply(params, state, x959, config=config)
        away = x959.shape[2] - 2 * HALO
        perr = (padded[:, :, :away] - full959[:, :, :away]).abs().max().item()
        prng = (full959.max() - full959.min()).item()
        if padded.shape != full959.shape or not perr <= RANGE_TOL * prng:
            failures.append(f"padded tiled 959x640: {tuple(padded.shape)}, {perr:.3e} away from "
                            f"the padded edge (range {prng:.3e})")
        log(f"padded tiled fp32 [1,640,959,3] -> 960, tile {PADDED_TILE}: logits "
            f"{tuple(padded.shape)}, max_abs_err vs full image over columns < {away} "
            f"{perr:.3e} (logit range {prng:.3e})")
        del padded, full959
        torch.cuda.empty_cache()
        times = {}
        for dtype, amp in (("fp32", False), ("bf16", True)):
            cd = torch.bfloat16 if amp else None
            sweep = functools.partial(tiled_forward, params, state, x, config=config, tile=TILE,
                                      halo=HALO, amp=amp)
            whole = functools.partial(unet_apply, params, state, x, config=config,
                                      compute_dtype=cd)
            t_ms, f_ms = time_ms(sweep, reps=5), time_ms(whole, reps=5)
            t_gib, f_gib = _peak_gib(sweep), _peak_gib(whole)
            times[dtype] = {"tiled_ms_per_image": round(t_ms, 3),
                            "tiled_ms_per_tile": round(t_ms / n_tiles, 3),
                            "tiled_peak_gib": round(t_gib, 3), "full_ms": round(f_ms, 3),
                            "full_peak_gib": round(f_gib, 3)}
            torch.cuda.empty_cache()
        numbers[f"tiled_{TILE_SIZE}"] = times
    log(f"tiled sweep {TILE_SIZE}² (CUDA events, median of 5; tile {TILE}, halo {HALO}, 4 windows "
        f"a forward, eval forward, TF32 off) beside the full-image forward: "
        f"{json.dumps(times)} ({card})")

    # Serve --tile 512 --tta (bf16 by default; device preprocess by default
    # under --tile): one 2048² request against predict_img_tiled(tta=True) at
    # bf16, which preprocesses on the host.
    server, predictor = serve.make_server(["-m", str(ckpt), "--port", "0", "--tile", str(TILE),
                                           "--halo", str(HALO), "--tta", "-s", "1.0"])
    if not predictor.device_preprocess:
        failures.append("serve --tile: device preprocess is not on by default")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, body, dt = post(server.server_address[1], tpath.read_bytes())
    finally:
        server.shutdown()
        server.server_close()
        predictor.stop()
        thread.join(timeout=10)
    if status != 200:
        failures.append(f"serve --tile --tta: HTTP {status}")
    else:
        served = np.asarray(Image.open(io.BytesIO(body))).astype(bool)
        want = predict_img_tiled(params, state, config, big_img, tile=TILE, halo=HALO,
                                 scale_factor=1.0, amp=True, tta=True, device=cuda)
        _, differ = _mask_agreement(served, want)
        if served.shape != want.shape or differ:
            failures.append(f"serve --tile --tta vs predict_img_tiled: {served.shape}, "
                            f"{differ} pixels differ")
        log(f"serve --tile {TILE} --tta (bf16, device preprocess) {TILE_SIZE}² request: HTTP 200 in "
            f"{dt * 1e3:.1f} ms "
            f"(cold, client clock), mask vs predict_img_tiled(tta=True, bf16): {differ} "
            f"pixels differ, foreground {served.mean():.4f}")
    torch.cuda.empty_cache()

    # evaluate --tta over phase 6's synthetic data, and the CRF.
    argv = ["-m", str(ckpt), "--data-dir", str(train_data), "-s", "0.5", "-b", "4"]
    dice = evaluate.main(argv)
    dice_tta = evaluate.main(argv + ["--tta"])
    numbers["dice"], numbers["dice_tta"] = dice, dice_tta
    if not abs(dice_tta - dice) <= CLI_DICE_TOL:
        failures.append(f"evaluate --tta Dice {dice_tta:.6f} vs {dice:.6f}")
    with torch.inference_mode():
        logits, _ = unet_apply(params, state, x959, config=config)
        rgb = x959  # preprocess at scale 0.5 is the image the logits are of
        refined = crf_refine_binary(rgb, torch.sigmoid(logits[..., 0]))
        ok = (refined.shape == logits.shape[:3] and bool(torch.isfinite(refined).all())
              and 0 <= refined.min().item() and refined.max().item() <= 1)
    if not ok:
        failures.append(f"crf_refine_binary: {tuple(refined.shape)}, range "
                        f"[{refined.min().item()}, {refined.max().item()}]")
    log(f"evaluate fp32: Dice {dice:.6f}, --tta {dice_tta:.6f} (|diff| <= {CLI_DICE_TOL}); "
        f"crf_refine_binary [1,640,959]: in [0, 1] {ok}")
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"chip_smoke: predict surface checks failed: {failures}")
    return numbers


# Phase 8: the data path (the native host tier, device preprocess, the
# device-resident corpus, augmentation). Host-clock times are medians of
# DATA_REPS calls after one warm-up.
DATA_IMAGES = 4
DATA_REPS = 5
DATA_HW = (1280, 1918)
DATA_OUT_HW = (640, 959)  # scale 0.5


def _host_ms(fn, reps: int = DATA_REPS) -> float:
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32 and b.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    return a.shape == b.shape and np.array_equal(a, b)


def _carvana_formats(png_img_dir: Path, png_mask_dir: Path, out: Path) -> tuple[Path, Path]:
    """The PNG pairs rewritten as Carvana ships them: JPEG images, one-frame
    palette GIF masks with indices 0 and 1."""
    imgs, masks = out / "imgs", out / "masks"
    imgs.mkdir(parents=True)
    masks.mkdir()
    for p in sorted(png_img_dir.glob("*.png")):
        Image.open(p).save(imgs / f"{p.stem}.jpg", quality=90)
    for p in sorted(png_mask_dir.glob("*.png")):
        gif = Image.fromarray((np.asarray(Image.open(p)) > 0).astype(np.uint8), mode="P")
        gif.putpalette([0, 0, 0, 255, 255, 255])
        gif.save(masks / f"{p.stem}.gif")
    return imgs, masks


def phase_data_path(workdir: Path, ckpt: Path, predict_inputs: list[str], surface_dir: Path,
                    train_dir: Path, card: str) -> dict:
    """Phase 8: the data path at 1918x1280 -> 959x640. The native tier
    (built, self-checked, decode and resize against PIL, bitwise, timed);
    ``device_preprocess_images``/``_masks`` on the card against the host
    path, bitwise, at b1 and b4, timed; ``predict --device-preprocess`` on
    phase 7's files (masks equal to phase 7's host masks); one served request
    with ``--device-preprocess`` broken down like phase 4's, its mask equal
    to the host request's, and ``serve --tile`` on by default; the train CLI
    (``--kernels cuda``) with ``--device-preprocess``, ``--device-dataset``
    and ``--augment --augment-elastic 34 --augment-rot 10`` (twice) against
    phase 6's host run. Returns its numbers."""
    from tpu_unet_torch import predict, serve
    from tpu_unet_torch.data import (
        CarvanaDataset,
        DataLoader,
        make_synthetic_carvana,
        preprocess,
        preprocess_mask,
        random_split_indices,
    )
    from tpu_unet_torch.data.device_pipeline import (
        device_preprocess_images,
        device_preprocess_masks,
        raw_u8_for_device,
    )
    from tpu_unet_torch.ops import resize_bilinear
    from tpu_unet_torch.predict import logits_to_mask, mask_to_image

    failures: list[str] = []
    numbers: dict = {"card": card}
    cuda = torch.device("cuda")

    # (a) The native tier (built and self-checked in phase 1): decode and
    # resize against PIL. Without libjpeg on this host, JPEG declines to PIL.
    if not native.available():
        raise SystemExit("chip_smoke: the native tier did not build or failed its self-check")
    has_jpeg = bool(native._load().tu_has_jpeg)
    numbers["has_jpeg"] = has_jpeg
    log(f"native tier: available, has_jpeg={has_jpeg}")
    png_imgs, png_masks = make_synthetic_carvana(workdir / "png", n=DATA_IMAGES, h=DATA_HW[0],
                                                 w=DATA_HW[1], seed=11)
    jpg_imgs, gif_masks = _carvana_formats(png_imgs, png_masks, workdir / "carvana")
    files = {"png image": sorted(png_imgs.glob("*.png"))[0],
             "jpeg image": sorted(jpg_imgs.glob("*.jpg"))[0],
             "gif mask": sorted(gif_masks.glob("*.gif"))[0],
             "png mask": sorted(png_masks.glob("*.png"))[0]}
    decoders = {".png": native.decode_png, ".jpg": native.decode_jpeg, ".gif": native.decode_gif}
    host: dict = {}
    for label, path in files.items():
        data = path.read_bytes()
        ref = np.asarray(Image.open(io.BytesIO(data)))
        got = decoders[path.suffix](data)
        declined = got is None
        if declined and not (path.suffix == ".jpg" and not has_jpeg):
            failures.append(f"native {label} decode declined")
        elif not declined and not _same_bits(got, ref):
            failures.append(f"native {label} decode differs from PIL")
        host[f"{label} decode"] = {
            "native_ms": None if declined else _host_ms(lambda d=data, p=path:
                                                        decoders[p.suffix](d)),
            "pil_ms": _host_ms(lambda d=data: np.asarray(Image.open(io.BytesIO(d))))}
    rgb = np.asarray(Image.open(files["png image"]))
    mask_idx = np.asarray(Image.open(files["gif mask"]))
    out_w_h = DATA_OUT_HW[::-1]
    for label, arr, pil_f, nat_f in (("bicubic image resize", rgb, Image.BICUBIC, native.BICUBIC),
                                     ("nearest mask resize", mask_idx, Image.NEAREST,
                                      native.NEAREST)):
        pil = Image.fromarray(arr)
        ref = np.asarray(pil.resize(out_w_h, resample=pil_f))
        for threads in (1, 8):
            if not _same_bits(native.resize_u8(arr, *DATA_OUT_HW, nat_f, n_threads=threads), ref):
                failures.append(f"native {label} ({threads} threads) differs from PIL")
        host[label] = {"native_ms": _host_ms(lambda a=arr, f=nat_f: native.resize_u8(
                           a, *DATA_OUT_HW, f, n_threads=1)),
                       "native_8_threads_ms": _host_ms(lambda a=arr, f=nat_f: native.resize_u8(
                           a, *DATA_OUT_HW, f, n_threads=8)),
                       "pil_ms": _host_ms(lambda p=pil, f=pil_f: np.asarray(
                           p.resize(out_w_h, resample=f)))}
    host["host preprocess (native resize + /255)"] = {
        "ms": _host_ms(lambda: preprocess(Image.fromarray(rgb), 0.5))}
    numbers["host_ms"] = host
    log(f"native tier vs PIL, {DATA_HW[1]}x{DATA_HW[0]} -> {DATA_OUT_HW[1]}x{DATA_OUT_HW[0]}, "
        f"host clock, median of {DATA_REPS}: {json.dumps(host)}")

    # (b) The device preprocess on the card against the host path, bitwise.
    paths = sorted(png_imgs.glob("*.png"))
    raw = torch.from_numpy(np.stack([raw_u8_for_device(Image.open(p)) for p in paths])).to(cuda)
    want_x = np.stack([preprocess(Image.open(p), 0.5) for p in paths])
    ds_masks = CarvanaDataset(jpg_imgs, gif_masks, 0.5)
    mv = ds_masks.mask_values
    raw_m = torch.from_numpy(np.stack([np.asarray(Image.open(p))
                                       for p in sorted(gif_masks.glob("*.gif"))])).to(cuda)
    want_m = np.stack([preprocess_mask(mv, Image.open(p), 0.5)
                       for p in sorted(gif_masks.glob("*.gif"))])
    mv_t = torch.tensor(mv, device=cuda)
    dev: dict = {}
    with torch.inference_mode():
        for b in (1, DATA_IMAGES):
            xi = device_preprocess_images(raw[:b], out_h=DATA_OUT_HW[0], out_w=DATA_OUT_HW[1])
            xm = device_preprocess_masks(raw_m[:b], mv_t, out_h=DATA_OUT_HW[0],
                                         out_w=DATA_OUT_HW[1])
            if not _same_bits(xi.cpu().numpy(), want_x[:b]):
                failures.append(f"device_preprocess_images b{b} differs from the host path")
            if not np.array_equal(xm.cpu().numpy(), want_m[:b]):
                failures.append(f"device_preprocess_masks b{b} differs from the host path")
            dev[f"b{b}"] = {
                "images_ms": time_ms(lambda b=b: device_preprocess_images(
                    raw[:b], out_h=DATA_OUT_HW[0], out_w=DATA_OUT_HW[1])),
                "masks_ms": time_ms(lambda b=b: device_preprocess_masks(
                    raw_m[:b], mv_t, out_h=DATA_OUT_HW[0], out_w=DATA_OUT_HW[1]))}
    numbers["device_ms"] = dev
    log(f"device preprocess on the card, [b,{DATA_HW[0]},{DATA_HW[1]},3] uint8 -> "
        f"[b,{DATA_OUT_HW[0]},{DATA_OUT_HW[1]},3] fp32 and GIF masks (palette {mv}), bitwise "
        f"equal to the host path at b1 and b{DATA_IMAGES}: "
        f"{not any('device_preprocess' in f for f in failures)}; CUDA events, median of 10: "
        f"{json.dumps(dev)} ({card})")
    del raw, raw_m

    # (c) predict --device-preprocess on phase 7's 8 files, in turns with the
    # host path (b1), then batched; masks equal phase 7's host masks.
    wall: dict = {}
    for tag in ("host", "device", "device", "host"):
        outs = [str(workdir / f"p_{tag}_{k}.png") for k in range(len(predict_inputs))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict.main(["-m", str(ckpt), "-i", *predict_inputs, "-o", *outs]
                     + (["--device-preprocess"] if tag == "device" else []))
        torch.cuda.synchronize()
        wall.setdefault(tag, []).append(time.perf_counter() - t0)
    outs4 = [str(workdir / f"p_b4_{k}.png") for k in range(len(predict_inputs))]
    predict.main(["-m", str(ckpt), "-i", *predict_inputs, "-o", *outs4, "--device-preprocess",
                  "--batch-size", "4"])
    differ = {}
    for k in range(len(predict_inputs)):
        for tag, ref in (("device", f"b1_{k}.png"), ("b4", f"b4_{k}.png")):
            got = np.asarray(Image.open(workdir / f"p_{tag}_{k}.png"))
            n = int((got != np.asarray(Image.open(surface_dir / ref))).sum())
            differ[tag] = differ.get(tag, 0) + n
    if differ["device"] or differ["b4"]:
        failures.append(f"predict --device-preprocess masks differ from phase 7's: {differ}")
    ips = {tag: [round(len(predict_inputs) / t, 3) for t in v] for tag, v in wall.items()}
    numbers["predict_images_per_s"] = ips
    log(f"predict fp32 on phase 7's {len(predict_inputs)} files, CLI wall clock, in turns host "
        f"device device host: images/s host {ips['host']}, --device-preprocess "
        f"{ips['device']}; pixels differing from phase 7's host masks: b1 {differ['device']}, "
        f"--batch-size 4 {differ['b4']} ({card})")

    # (d) One served request with --device-preprocess (--kernels cuda, bf16),
    # its mask against the host request's (the same forward on the host
    # preprocess); its breakdown like phase 4's; serve --tile's default.
    body = paths[0].read_bytes()
    server, predictor = serve.make_server(["-m", str(ckpt), "--port", "0", "--kernels", "cuda",
                                           "--device-preprocess", "--warmup", "1280x1918"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        served = [post(server.server_address[1], body) for _ in range(3)]
        metrics = get_json(server.server_address[1], "/metrics")
        img = Image.open(io.BytesIO(body))
        with torch.inference_mode():
            x = torch.from_numpy(preprocess(img, 0.5))[None].to(cuda)
            lg = resize_bilinear(predictor.forward(x), img.height, img.width,
                                 align_corners=False)
            host_mask = logits_to_mask(lg[0], 1, 0.5)
        t = [time.perf_counter()]
        img = Image.open(io.BytesIO(body))
        img.load()
        t.append(time.perf_counter())
        arr = raw_u8_for_device(img)
        t.append(time.perf_counter())
        with torch.inference_mode():
            xr = torch.from_numpy(arr[None].copy()).to(cuda)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            x = device_preprocess_images(xr, out_h=DATA_OUT_HW[0], out_w=DATA_OUT_HW[1])
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            logits = predictor.forward(x)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            lg = resize_bilinear(logits, img.height, img.width, align_corners=False)
            mask = logits_to_mask(lg[0], 1, 0.5)
        t.append(time.perf_counter())
        mask_to_image(mask, [0, 1]).save(io.BytesIO(), format="PNG")
        t.append(time.perf_counter())
    finally:
        server.shutdown()
        server.server_close()
        predictor.stop()
        thread.join(timeout=10)
    steps = ("png_decode", "raw_u8", "h2d_u8", "device_resize", "forward",
             "upscale_threshold_d2h", "png_encode")
    breakdown = {name: round((t[i + 1] - t[i]) * 1e3, 2) for i, name in enumerate(steps)}
    breakdown["total"] = round((t[-1] - t[0]) * 1e3, 2)
    numbers["serve_breakdown_ms"] = breakdown
    numbers["serve_client_ms"] = [round(r[2] * 1e3, 2) for r in served]
    for k, (status, data, _) in enumerate(served):
        got = np.asarray(Image.open(io.BytesIO(data))).astype(bool) if status == 200 else None
        if got is None or not np.array_equal(got, host_mask.astype(bool)):
            failures.append(f"served --device-preprocess request {k}: HTTP {status}, mask "
                            "differs from the host request's")
    if not np.array_equal(mask, host_mask):
        failures.append("device-preprocess breakdown mask differs from the host request's")
    log("request breakdown ms (--device-preprocess, --kernels cuda, bf16): " + " ".join(
        f"{k}={v:.2f}" for k, v in breakdown.items()) + f"; served client ms "
        f"{numbers['serve_client_ms']}, /metrics p50 {metrics.get('latency_ms', {}).get('p50')}; "
        f"masks equal to the host request's: {not any('served' in f for f in failures)}")
    for argv, want in ((["--tile", str(TILE)], True),
                       (["--tile", str(TILE), "--no-device-preprocess"], False)):
        server, predictor = serve.make_server(["-m", str(ckpt), "--port", "0", *argv])
        server.server_close()
        predictor.stop()
        if predictor.device_preprocess is not want:
            failures.append(f"serve {' '.join(argv)}: device_preprocess "
                            f"{predictor.device_preprocess}, expected {want}")
    log(f"serve --tile {TILE} defaults to device preprocess: "
        f"{not any('serve --tile' in f for f in failures)}")
    torch.cuda.empty_cache()

    # (e) The train CLI with the data flags, --kernels cuda, on phase 6's data
    # and initial checkpoint, against phase 6's --kernels cuda host run.
    ref = json.loads((train_dir / "history_cuda.json").read_text())
    data = train_dir / "data"
    common = [*CLI_ARGS, "--data-dir", str(data), "--load", str(train_dir / "init.npz"),
              "--kernels", "cuda"]
    hds = CarvanaDataset(data / "imgs", data / "masks", 0.5)
    train_idx, _ = random_split_indices(len(hds), 0.2, seed=0)
    first = next(iter(DataLoader(hds, 4, shuffle=True, indices=train_idx, seed=0)))
    augment = ["--augment", "--augment-elastic", "34", "--augment-rot", "10"]
    runs: dict = {}
    for tag, flags in (("device-preprocess", ["--device-preprocess"]),
                       ("device-dataset", ["--device-dataset"]),
                       ("augment", augment), ("augment again", augment)):
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = tag.startswith("augment")
        try:
            history, launches, stats = _cli_run(
                common + flags + ["--checkpoint-dir", str(workdir / f"ck_{tag.replace(' ', '_')}")],
                " ".join(flags) + " --kernels cuda")
        finally:
            torch.backends.cudnn.deterministic = deterministic
        runs[tag] = (history, stats)
        steps = len(history["train_loss"])
        for name, count in launches.items():
            if count != expected_launches(name, "cuda", True, steps):
                failures.append(f"{tag}: {name} launched {count} times, expected "
                                f"{expected_launches(name, 'cuda', True, steps)}")
        if steps != CLI_STEPS or len(history["val_dice"]) != 2:
            failures.append(f"{tag}: {steps} steps, {len(history['val_dice'])} validations")
        if not all(np.isfinite(history["train_loss"])):
            failures.append(f"{tag}: non-finite loss")
        if tag.startswith("device"):
            fb = stats["first_batch"]
            same = (_same_bits(fb["image"].numpy(), first["image"])
                    and np.array_equal(fb["mask"].numpy(), first["mask"]))
            rel = (np.abs(np.asarray(history["train_loss"]) - ref["train_loss"])
                   / np.abs(ref["train_loss"]))
            dice = np.abs(np.asarray(history["val_dice"]) - ref["val_dice"])
            log(f"{tag}: first batch bitwise equal to the host loader's: {same}; loss rel err "
                f"vs phase 6's host run " + " ".join(f"{r:.3e}" for r in rel)
                + f" (tol {CLI_LOSS_TOL:g}); val Dice abs err "
                + " ".join(f"{d:.3e}" for d in dice) + f" (tol {CLI_DICE_TOL:g})")
            if not same:
                failures.append(f"{tag}: first batch differs from the host loader's")
            if not ((rel <= CLI_LOSS_TOL).all() and (dice <= CLI_DICE_TOL).all()):
                failures.append(f"{tag}: losses {rel.tolist()} or val Dice {dice.tolist()} "
                                "off phase 6's host run")
    (ha, sa), (hb, sb) = runs["augment"], runs["augment again"]
    repeat = (ha["train_loss"] == hb["train_loss"] and ha["val_dice"] == hb["val_dice"]
              and all(torch.equal(a, b) for a, b in zip(sa["first_augmented"],
                                                       sb["first_augmented"])))
    log(f"augment: two runs bitwise equal (losses, val Dice, first batch): {repeat}")
    if not repeat:
        failures.append("the augmented train CLI run did not repeat bitwise")
    numbers["train_cli"] = {tag: {k: (round(v, 4) if isinstance(v, float) else v)
                                  for k, v in st.items() if not k.startswith("first_")}
                            for tag, (_, st) in runs.items()}
    if failures:
        raise SystemExit(f"chip_smoke: data path checks failed: {failures}")
    return numbers


# Phase 9: the four other model families at full width (base 64, one class,
# ConvTranspose decoder, t = 2 with per-step recurrent BN, seed 0; UNet++
# upsamples by construction and trains with deep supervision). None runs a
# kernel of the repo: the JAX package refuses its kernel tiers for them.
FAMILIES = ("attention", "unetpp", "r2u", "r2attu")
FAMILY_PARAMS = {"attention": 31_388_201, "unetpp": 36_622_532, "r2u": 35_601_985,
                 "r2attu": 35_952_553}
FAMILY_REPS = 3
# The second timed step (from the same trees) must repeat the first bit for
# bit, or stay within STEP_TOL (phase 5's bound for two summation orders of
# one step; "grads" is the gradients' relative L2 error as one vector, held
# to the grad-norm tolerance) and say why: measured on the H100, cuDNN's
# default fp32 algorithms for these shapes are not run-to-run deterministic,
# and the same pair with cudnn.deterministic is bitwise (bf16 repeats
# bitwise either way).
FAMILY_TILE_HALO = 352  # min_halo for r2u at t = 2: 110·3 + 18, 16-aligned


def family_config(arch: str):
    from tpu_unet_torch.models import UNetConfig

    return UNetConfig(**TRAIN_CONFIG, arch=arch, deep_supervision=arch == "unetpp",
                      recur_t=2, recur_bn="per_step")


def _family_step(arch: str, images, masks) -> tuple[dict, list[str]]:
    """One family's make_train_step (kernels=None) at [4,640,959] in fp32 and
    bf16: loss finite, the repeat check, ms per step (CUDA events, median of
    FAMILY_REPS after a warm-up) and peak memory. Returns (numbers,
    failures)."""
    from tpu_unet_torch.models import init_unet, param_count
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    config = family_config(arch)
    params, state = init_unet(config, np.random.default_rng(0), device=images.device)
    opt = rmsprop_init(params)
    failures = []
    numbers = {"params": param_count(params)}
    if numbers["params"] != FAMILY_PARAMS[arch]:
        failures.append(f"{arch}: {numbers['params']} parameters, expected {FAMILY_PARAMS[arch]}")
    for dt, amp in (("fp32", False), ("bf16", True)):
        step = make_train_step(config, amp=amp, return_grads=True)
        step(params, state, opt, images, masks, 1e-5)  # warm-up (cuDNN's choice)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, host = [], []
        for _ in range(FAMILY_REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(params, state, opt, images, masks, 1e-5)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            if len(host) < 2:  # the first two steps, on the host for the repeat check
                host.append(_step_leaves(out))
            del out
        peak = torch.cuda.max_memory_allocated()
        loss, gnorm = host[0]["loss"].item(), host[0]["grad_norm"].item()
        bitwise = all(torch.equal(v, host[1][k]) for k, v in host[0].items())
        why = ""
        if not bitwise:
            # Held to phase 5's tolerances for two fp32/bf16 summation orders
            # of one step; the pair again in cuDNN's and torch's deterministic
            # modes says why (torch names each op without a deterministic form).
            repeat = _repeat_errors(host[0], host[1])
            tol = {k: STEP_TOL[dt]["grad_norm" if k == "grads" else k] for k in repeat}
            with Deterministic() as det:
                a, b = (_step_leaves(step(params, state, opt, images, masks, 1e-5))
                        for _ in range(2))
            bitwise_det = all(torch.equal(v, b[k]) for k, v in a.items())
            why = (f"; not bitwise with cuDNN's default algorithms ({json.dumps(repeat)}, "
                   f"tol {json.dumps(tol)}); with "
                   f"cudnn.deterministic and torch's deterministic algorithms bitwise "
                   f"{bitwise_det}, ops without a deterministic form: {det.reasons or 'none'}")
            over = [k for k, v in repeat.items() if not v <= tol[k]]
            if over:
                failures.append(f"{arch} {dt}: the repeated step differs beyond STEP_TOL in "
                                f"{over}{why}")
        numbers[dt] = {"ms": statistics.median(times), "ms_reps": times,
                       "peak_gib": peak / 2**30, "loss": loss, "bitwise_repeat": bitwise}
        if not bitwise:
            numbers[dt]["repeat"] = repeat
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            failures.append(f"{arch} {dt}: loss {loss}, grad norm {gnorm}")
        log(f"family {arch} {dt} step {list(images.shape[:3])} kernels=None: "
            f"{numbers[dt]['ms']:.2f} ms (median of {FAMILY_REPS}: "
            f"{' '.join(f'{t:.2f}' for t in times)}), peak memory "
            f"{numbers[dt]['peak_gib']:.3f} GiB, loss {loss:.6f}, second step bitwise equal to "
            f"the first: {bitwise}{why}")
        del step, host
    del params, state, opt
    torch.cuda.empty_cache()
    return numbers, failures


def _repeat_errors(a: dict, b: dict) -> dict[str, float]:
    """Two runs of one step: loss and grad norm relative errors, the
    gradients' relative L2 error as one vector, and the largest per-tensor
    relative L2 error of the new BN running statistics."""
    grads = [k for k in a if k.startswith("grads")]
    diff = sum(float((b[k].double() - a[k].double()).square().sum()) for k in grads)
    norm = sum(float(a[k].double().square().sum()) for k in grads)
    rel = lambda k: abs(b[k].item() - a[k].item()) / max(abs(a[k].item()), 1e-30)  # noqa: E731
    return {"loss": rel("loss"), "grad_norm": rel("grad_norm"),
            "grads": (diff / max(norm, 1e-300)) ** 0.5,
            "bn_state": max(_rel_l2(b[k], a[k]) for k in a if k.startswith("bn"))}


def _step_leaves(out) -> dict[str, torch.Tensor]:
    """A train step's loss, grad norm, params, BN state, optimizer state and
    gradients, copied to the host."""
    leaves = {"loss": out[3], "grad_norm": out[4]}
    for name, i in (("params", 0), ("bn", 1), ("opt", 2), ("grads", 5)):
        leaves.update({f"{name}{k}": v for k, v in _leaves(out[i]).items()})
    return {k: v.detach().cpu() for k, v in leaves.items()}


def _serve_one(ckpt: Path, argv: list[str], body: bytes) -> np.ndarray:
    """The mask that ``serve`` (in this process) returns for one request."""
    from tpu_unet_torch import serve

    server, predictor = serve.make_server(["-m", str(ckpt), "--port", "0", *argv])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, data, _ = post(server.server_address[1], body)
        health = get_json(server.server_address[1], "/healthz")
    finally:
        server.shutdown()
        server.server_close()
        predictor.stop()
        thread.join(timeout=10)
    if status != 200:
        raise SystemExit(f"chip_smoke: serve {argv} answered {status}: {data[:200]!r}")
    log(f"serve {' '.join(argv)}: healthz {json.dumps(health)}")
    return np.asarray(Image.open(io.BytesIO(data)))


def phase_families(workdir: Path, train_data: Path) -> dict:
    """Phase 9: the families' train steps; Attention U-Net's folded forward
    and ``serve --arch attention`` against ``predict --arch attention``; per-
    step R2U-Net through ``train_cli``, ``predict`` and ``evaluate``; its
    tiled sweep at 2048² with the arch-aware halo. Runs no conv or pool
    kernel of the repo (the clip and update kernels run in every train
    step). Returns its numbers."""
    from tpu_unet_torch import evaluate, predict
    from tpu_unet_torch.checkpoint import load_checkpoint, read_checkpoint_meta, save_checkpoint
    from tpu_unet_torch.data import (
        CarvanaDataset,
        make_synthetic_carvana,
        preprocess,
        random_split_indices,
        synth_batch,
    )
    from tpu_unet_torch.models import fold_bn, init_unet, unet_infer_apply
    from tpu_unet_torch.models.unet import unet_apply
    from tpu_unet_torch.parallel import tiling

    failures: list[str] = []
    numbers: dict = {}
    cuda = torch.device("cuda")
    K.reset_launch_counts()  # _cli_run in (d) resets and reads them again

    # (a) the train steps, BASELINE config #2's shape.
    imgs, msks = synth_batch(np.random.default_rng(1), *PARITY_BATCH)
    images, masks = torch.from_numpy(imgs).to(cuda), torch.from_numpy(msks).to(cuda)
    for arch in FAMILIES:
        numbers[arch], fails = _family_step(arch, images, masks)
        failures += fails
    del images, masks

    # (b) Attention U-Net: the folded forward against the eval forward at
    # 959x640 fp32, with running stats moved by three train-mode forwards.
    config = family_config("attention")
    params, state = init_unet(config, np.random.default_rng(0), device=cuda)
    img_path = sorted((train_data / "imgs").glob("*.png"))[0]
    x = torch.from_numpy(preprocess(Image.open(img_path), 0.5))[None].to(cuda)
    with torch.inference_mode():
        for _ in range(3):
            _, state = unet_apply(params, state, x, config=config, train=True)
        ref = unet_apply(params, state, x, config=config)[0]
        folded = fold_bn(params, state, config)
        got = unet_infer_apply(folded, x, config=config, backend="torch")
        err, span = (got - ref).abs().max().item(), (ref.max() - ref.min()).item()
        try:
            unet_infer_apply(folded, x, config=config, backend="cuda")
            failures.append("attention: unet_infer_apply(backend='cuda') did not raise")
        except ValueError as e:
            log(f"attention backend='cuda' refused: {e}")
    numbers["attention"]["folded_max_abs_err"], numbers["attention"]["logit_range"] = err, span
    log(f"attention folded forward (fold_bn, backend='torch') vs unet_apply(train=False), "
        f"fp32 {tuple(x.shape)}: max_abs_err {err:.3e}, logit range {span:.3e}")
    if not err <= RANGE_TOL * span:
        failures.append(f"attention folded forward: {err:.3e} > {RANGE_TOL} x {span:.3e}")

    # (c) serve --arch attention against predict --arch attention, fp32. The
    # random head's logits span about 1e-2 around a bias near 0.1, so every
    # pixel would threshold alike and any forward would agree. The head is
    # rescaled about this image's median logit to a range of 20: about half
    # the mask is foreground, and where it falls depends on the gated forward.
    k, med = 20.0 / span, ref.median().item()
    params["outc"] = {"w": params["outc"]["w"] * k, "b": (params["outc"]["b"] - med) * k}
    att_ckpt = workdir / "attention.npz"
    save_checkpoint(att_ckpt, params, state, [0, 1], {"config": config._asdict()})
    del params, state, folded, got, ref
    out_png = workdir / "attention_mask.png"
    predict.main(["-m", str(att_ckpt), "-i", str(img_path), "-o", str(out_png), "--arch",
                  "attention", "--device", "cuda"])
    want = np.asarray(Image.open(out_png))
    served = _serve_one(att_ckpt, ["--arch", "attention", "--no-amp", "--device", "cuda"],
                        img_path.read_bytes())
    agree, differ = _mask_agreement(served, want)
    fg = float((want > want.min()).mean())
    log(f"serve --arch attention --no-amp, one {'x'.join(map(str, Image.open(img_path).size))} "
        f"request: mask {served.shape} vs predict --arch attention: agreement {agree:.6f} "
        f"({differ} pixels differ); predict's mask is {fg:.4f} foreground")
    if served.shape != want.shape or agree < BATCH_AGREEMENT or not 0.1 <= fg <= 0.9:
        failures.append(f"serve --arch attention vs predict: {served.shape}, {agree:.6f}, "
                        f"foreground {fg:.4f}")
    numbers["attention"]["serve_vs_predict_agreement"] = agree
    numbers["attention"]["mask_foreground"] = fg

    # (d) per-step R2U-Net through the CLIs on phase 6's images.
    ck = workdir / "ck_r2u"
    history, launches, stats = _cli_run(
        ["-s", "0.5", "-b", "4", "--amp", "--epochs", "1", "--validation", "20",
         "--val-per-epoch", "1", "--arch", "r2u", "--data-dir", str(train_data),
         "--checkpoint-dir", str(ck), "--device", "cuda"], "--arch r2u")
    ckpt = ck / "checkpoint_epoch1.npz"
    _, extra = read_checkpoint_meta(ckpt)
    stored = extra.get("config", {})
    if (stored.get("arch"), stored.get("recur_bn")) != ("r2u", "per_step"):
        failures.append(f"r2u checkpoint config {stored}")
    r2u_config = type(family_config("r2u"))(**stored)
    params, state, _, _ = load_checkpoint(ckpt, r2u_config, cuda)
    if set(state["inc"]["rec1"]) != {"bn0", "bn1", "bn2"}:
        failures.append(f"r2u checkpoint state layout {sorted(state['inc']['rec1'])}")
    if not (len(history["train_loss"]) == 2 and np.isfinite(history["train_loss"]).all()
            and len(history["val_dice"]) == 1):
        failures.append(f"train_cli --arch r2u history {history}")
    inputs = sorted((train_data / "imgs").glob("*.png"))[:2]
    outs = [workdir / f"r2u_{k}.png" for k in range(len(inputs))]
    predict.main(["-m", str(ckpt), "--arch", "r2u", "-i", *map(str, inputs),
                  "-o", *map(str, outs), "--device", "cuda"])
    shapes = [np.asarray(Image.open(p)).shape for p in outs]
    if shapes != [Image.open(p).size[::-1] for p in inputs]:
        failures.append(f"predict --arch r2u masks {shapes}")
    # evaluate on the run's validation images alone: its Dice is the run's.
    ds = CarvanaDataset(train_data / "imgs", train_data / "masks", 0.5)
    _, val_idx = random_split_indices(len(ds), 0.2, seed=0)
    val_dir = workdir / "r2u_val"
    for sub in ("imgs", "masks"):
        (val_dir / sub).mkdir(parents=True, exist_ok=True)
    for i in val_idx:
        name = ds.ids[i]
        shutil.copy(train_data / "imgs" / f"{name}.png", val_dir / "imgs")
        shutil.copy(train_data / "masks" / f"{name}_mask.png", val_dir / "masks")
    dice = evaluate.main(["-m", str(ckpt), "--data-dir", str(val_dir), "-s", "0.5", "-b", "4",
                          "--amp", "--arch", "r2u", "--device", "cuda"])
    last = history["val_dice"][-1]
    wrong = {k: v for k, v in launches.items()
             if v != expected_launches(k, None, True, stats["steps"])}
    if wrong:  # no conv or pool kernel; the clip and update kernels once a step
        failures.append(f"train_cli --arch r2u launched {wrong} in {stats['steps']} steps")
    log(f"train_cli --arch r2u: launches {json.dumps(launches)}, checkpoint recur_bn "
        f"{stored.get('recur_bn')!r}; predict --arch r2u masks {shapes}; evaluate --arch r2u on "
        f"the {len(val_idx)} validation images: Dice {dice:.6f} vs the run's last validation "
        f"{last:.6f} (tol {CLI_DICE_TOL:g})")
    if not abs(dice - last) <= CLI_DICE_TOL:
        failures.append(f"evaluate --arch r2u Dice {dice} vs validation {last}")
    numbers["r2u"]["cli"] = {"wall_s": stats["wall_s"], "img_s": stats["img_s"],
                             "peak_gib": stats["peak_bytes"] / 2**30, "val_dice": last,
                             "evaluate_dice": dice}

    # (e) the r2u tiled sweep at 2048², tile 512: predict_img_tiled takes
    # min_halo (352) over the default 128, and its logits match the full image.
    timg, _ = make_synthetic_carvana(workdir / "tile", n=1, h=TILE_SIZE, w=TILE_SIZE, seed=9)
    big = Image.open(next(timg.glob("*.png")))
    seen = {}
    real_sweep = tiling.tiled_forward_padded

    def sweep(*a, **k):
        seen["halo"] = k["halo"]
        seen["logits"] = real_sweep(*a, **k)
        return seen["logits"]

    tiling.tiled_forward_padded = sweep
    try:
        mask = tiling.predict_img_tiled(params, state, r2u_config, big, tile=TILE, halo=HALO,
                                        scale_factor=1.0, device=cuda)
    finally:
        tiling.tiled_forward_padded = real_sweep
    x = torch.from_numpy(preprocess(big, 1.0))[None].to(cuda)
    with torch.inference_mode():
        full = unet_apply(params, state, x, config=r2u_config)[0]
    err = (seen["logits"] - full).abs().max().item()
    span = (full.max() - full.min()).item()
    log(f"r2u tiled {TILE_SIZE}² tile {TILE}: halo {seen.get('halo')} (min_halo "
        f"{tiling.min_halo(r2u_config)}), max_abs_err vs full image {err:.3e} (logit range "
        f"{span:.3e}), mask {mask.shape}")
    if seen.get("halo") != FAMILY_TILE_HALO or tiling.min_halo(r2u_config) != FAMILY_TILE_HALO:
        failures.append(f"r2u tiling halo {seen.get('halo')}, expected {FAMILY_TILE_HALO}")
    if not err <= RANGE_TOL * span:
        failures.append(f"r2u tiled vs full: {err:.3e} > {RANGE_TOL} x {span:.3e}")
    numbers["r2u"]["tiled"] = {"halo": seen.get("halo"), "max_abs_err": err, "range": span}
    del params, state, full, seen

    counts = K.launch_counts()
    if any(v for k, v in counts.items() if k not in UPDATE_PER_STEP):
        failures.append(f"phase 9 launched conv or pool kernels of the repo: {counts}")
    if failures:
        raise SystemExit(f"chip_smoke: phase 9 (families) failed: {failures}")
    return numbers


# Phase 10: the quality gate of the JAX package's arch preset for the U-Net
# (320x480, batch 8, 280 steps, bf16, the corpus on the device; floors
# ARCH_FLOORS["unet"]), run once on library convs and once on the train
# kernels, then the observability flags of the train CLI on phase 6's
# files: 2 steps and 1 validation (8 train images at batch 4, 2 held out),
# the same run without the flags beside it.
QUALITY_KERNELS = (None, "cuda")
OBS_ARGS = ("-s", "0.5", "-b", "4", "--amp", "--epochs", "1", "--validation", "20",
            "--val-per-epoch", "1", "--kernels", "cuda")
OBS_STEPS = 2
# The profile groups (tools/profile_step.py) of the three bf16 train kernels.
TRAIN_KERNEL_GROUPS = {
    "conv3x3_fwd": "tc_conv_kernel (conv3x3_fwd, tensor cores)",
    "conv3x3_dx": "tc_conv_kernel<DzLoad> (conv3x3_dx, tensor cores)",
    "conv3x3_dw": "tc_dw_kernel (conv3x3_dw, tensor cores)",
}
# Phase 10's share of the run's wall time.
QUALITY_BUDGET_S = 120.0


class _StubWandb:
    """A ``wandb`` module in ``sys.modules`` that records every ``log`` call
    (histograms as their sizes); restores the previous entry on exit."""

    def __enter__(self):
        import types

        self.logs: list[dict] = []
        mod = types.ModuleType("wandb")

        class Experiment:
            config = types.SimpleNamespace(update=lambda *a, **k: None)

            def log(_, d):
                self.logs.append(d)

        mod.init = lambda **k: Experiment()
        mod.Histogram = lambda v: ("hist", int(np.asarray(v).size))
        mod.Image = lambda v: ("img", np.asarray(v).shape)
        self._prev = sys.modules.get("wandb")
        sys.modules["wandb"] = mod
        return self

    def __exit__(self, *exc):
        if self._prev is None:
            sys.modules.pop("wandb", None)
        else:
            sys.modules["wandb"] = self._prev
        return False


def phase_quality(workdir: Path, train_dir: Path) -> dict:
    """Phase 10: ``train_demo.run(preset="arch", arch="unet")`` with
    ``kernels=None`` and ``"cuda"``, each held to both frozen floors;
    ``train_cli --wandb --profile DIR --debug-nans`` with a stub ``wandb``
    against the same run without the flags (``train_dir``: phase 6's data
    and initial checkpoint); a NaN-poisoned batch under ``DebugNans``.
    Returns its numbers."""
    from tpu_unet_torch import train_cli
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.tools import train_demo
    from tpu_unet_torch.tools.profile_step import parse_trace
    from tpu_unet_torch.train import make_train_step
    from tpu_unet_torch.train_logging import _HIST_CAP
    from tpu_unet_torch.utils.debug_nans import DebugNans

    failures: list[str] = []
    numbers: dict = {"demo": {}}

    # (a) the quality gate, on library convs and on the train kernels.
    floors = train_demo.ARCH_FLOORS["unet"]
    for kernels in QUALITY_KERNELS:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        r = train_demo.run(preset="arch", arch="unet", kernels=kernels, data_dir=workdir / "demo")
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        numbers["demo"][str(kernels)] = {**r, "run_s": wall, "launches": launches}
        log(f"train_demo arch unet kernels={kernels}: val Dice {r['final_val_dice']} "
            f"(floor {r['dice_floor']}), held-out {r['heldout_dice']} (floor "
            f"{r['heldout_floor']}), TTA {r['heldout_dice_tta']}, hflip TTA "
            f"{r['heldout_dice_tta_hflip']}, loss {r['first_loss']} -> {r['last_loss']} over "
            f"{r['steps']} steps, train {r['train_wall_s']} s, run {wall:.1f} s; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        if not (r["passed"] and (r["dice_floor"], r["heldout_floor"]) == floors
                and r["final_val_dice"] >= floors[0] and r["heldout_dice"] >= floors[1]):
            failures.append(f"kernels={kernels}: the arch/unet gate failed: {r}")
        for name, count in launches.items():
            want = expected_launches(name, kernels, True, r["steps"])
            if count != want:
                failures.append(f"train_demo kernels={kernels}: {name} launched {count} times, "
                                f"expected {want}")
    d0, d1 = (numbers["demo"][str(k)] for k in QUALITY_KERNELS)
    gap = {"val": d1["final_val_dice"] - d0["final_val_dice"],
           "heldout": d1["heldout_dice"] - d0["heldout_dice"]}
    numbers["demo_gap"] = gap
    log(f"train_demo Dice, kernels=cuda minus kernels=None: val {gap['val']:+.4f}, held-out "
        f"{gap['heldout']:+.4f}")

    # (b) the observability flags on phase 6's files, beside the same run
    # without them; cuDNN deterministic so the two can be compared bitwise.
    common = [*OBS_ARGS, "--data-dir", str(train_dir / "data"), "--load",
              str(train_dir / "init.npz")]
    trace_dir = workdir / "trace"
    modes: list = []

    def recording_mode():
        modes.append(DebugNans())
        return modes[-1]

    runs = {}
    with Deterministic():
        for tag, flags in (("flags", ["--wandb", "--profile", str(trace_dir), "--debug-nans"]),
                           ("plain", [])):
            with _StubWandb() as stub:
                train_cli.DebugNans = recording_mode
                try:
                    history, launches, stats = _cli_run(
                        common + ["--checkpoint-dir", str(workdir / f"ck_{tag}")] + flags,
                        f"observability {tag}")
                finally:
                    train_cli.DebugNans = DebugNans
            runs[tag] = (history, launches, stats, stub.logs)
    history, launches, stats, logs = runs["flags"]
    step_logs = [d for d in logs if "train loss" in d]
    val_logs = [d for d in logs if "validation Dice" in d]
    hists = {k: v[1] for d in val_logs for k, v in d.items()
             if isinstance(v, tuple) and v[0] == "hist"}
    w_keys = {k.split("/", 1)[1] for k in hists if k.startswith("Weights/")}
    g_keys = {k.split("/", 1)[1] for k in hists if k.startswith("Gradients/")}
    n_w, n_g = len(w_keys), len(g_keys)
    checked = modes[0].checked if modes else {}
    backward_ops = sorted(k for k in checked if "backward" in k)
    trace = parse_trace(trace_dir)
    in_trace = {name: sum(ms for g, ms in trace["groups_ms"].items() if g == group)
                for name, group in TRAIN_KERNEL_GROUPS.items()}
    same = runs["plain"][0]["train_loss"] == history["train_loss"]
    numbers["observability"] = {
        "wall_s": {t: r[2]["wall_s"] for t, r in runs.items()}, "step_logs": len(step_logs),
        "val_logs": len(val_logs), "weights_hists": n_w, "gradients_hists": n_g,
        "largest_hist": max(hists.values(), default=0), "ops_checked": sum(checked.values()),
        "backward_ops_checked": len(backward_ops), "trace_ms": in_trace,
        "losses_equal": same, "launches": launches}
    log(f"observability: {len(step_logs)} step logs, {len(val_logs)} validation logs with "
        f"{n_w} Weights/ and {n_g} Gradients/ histograms, largest {numbers['observability']['largest_hist']} "
        f"elements (cap 2 x {_HIST_CAP}); --debug-nans checked {sum(checked.values())} ops, "
        f"{len(backward_ops)} backward kinds ({', '.join(backward_ops[:4])}); trace "
        + ", ".join(f"{n} {ms:.2f} ms" for n, ms in in_trace.items())
        + f"; losses {history['train_loss']} vs without the flags "
        f"{runs['plain'][0]['train_loss']}: equal={same}; wall {stats['wall_s']:.2f} vs "
        f"{runs['plain'][2]['wall_s']:.2f} s")
    if not (len(step_logs) == OBS_STEPS and len(val_logs) == 1 and w_keys and g_keys == w_keys
            and max(hists.values()) <= 2 * _HIST_CAP):
        failures.append(f"W&B logs: {len(step_logs)} step, {len(val_logs)} validation, "
                        f"{n_w}/{n_g} histograms")
    if not all(ms > 0 for ms in in_trace.values()):
        failures.append(f"the --profile trace lacks a train kernel: {in_trace}")
    if not (checked and backward_ops):
        failures.append(f"--debug-nans checked no op of the backward pass: {sorted(checked)[:8]}")
    if not same:
        failures.append("the losses with --wandb --profile --debug-nans differ from the run's "
                        "without them")
    for name, count in launches.items():
        if count != expected_launches(name, "cuda", True, OBS_STEPS):
            failures.append(f"observability run: {name} launched {count} times")

    # (c) a NaN-poisoned batch through the kernel step under DebugNans: it
    # must raise, in bf16 (NaN in the image) and in fp32, where the image
    # goes into conv3x3_fwd's kernel without an aten op before it.
    config = UNetConfig(**TRAIN_CONFIG)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    imgs, msks = synth_batch(np.random.default_rng(3), 2, 320, 480)
    imgs[1, 100, 200, 1] = np.nan
    images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
    numbers["nan"] = {}
    for amp, dt in ((True, "bf16"), (False, "fp32")):
        step = make_train_step(config, amp=amp, kernels="cuda")
        try:
            with DebugNans():
                step(params, state, rmsprop_init(params), images, masks, 1e-4)
            failures.append(f"{dt}: a NaN-poisoned batch raised nothing under DebugNans")
            msg = None
        except FloatingPointError as e:
            msg = str(e)
        numbers["nan"][dt] = msg
        log(f"--debug-nans, NaN-poisoned batch, {dt} kernels=cuda: FloatingPointError: {msg}")
    if failures:
        raise SystemExit(f"chip_smoke: quality and observability checks failed: {failures}")
    return numbers

# Phase 11: data parallelism at full width. (a) the train CLI under
# torchrun at world size 1 (NCCL) against the same CLI without
# --data-parallel, both deterministic, on phase 6's files; (b) and (c) two
# ranks on the one card over gloo: the data-parallel step on phase 5's
# parity batch, and the split evaluation on (a)'s checkpoint.
DP_RANKS = 2
DP_ARGS = ("-s", "0.5", "-b", "4", "--amp", "--epochs", "1", "--validation", "20",
           "--val-per-epoch", "1", "--kernels", "cuda", "--save-optimizer", "--deterministic")
DP_STEPS = 2
# Phase 6's first 9 images at batch 4: batches of 4, 4 (split over the two
# ranks) and 1 (whole on each).
DP_EVAL_IMAGES = 9
DP_EVAL_TOL = 1e-6
DP_TIMING_REPS = 3
DP_BUDGET_S = 120.0


def _torchrun(args: list[str], log_path: Path, timeout: float) -> int:
    """``python -m torch.distributed.run --standalone --nproc-per-node 1
    <args>`` from the repository root, its output in ``log_path``; on
    timeout its whole session (the launcher and its worker) is killed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc-per-node", "1", *args], cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT, start_new_session=True)
        try:
            return proc.wait(timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise SystemExit(f"chip_smoke: torchrun did not finish in {timeout:.0f} s "
                             f"(log {log_path})") from None


def _same_files(a: Path, b: Path) -> list[str]:
    """The arrays (the metadata included) of two .npz files that differ."""
    with np.load(a) as za, np.load(b) as zb:
        if sorted(za.files) != sorted(zb.files):
            return ["<keys>"]
        return [k for k in za.files if not np.array_equal(za[k], zb[k])]


def _dp_cli(workdir: Path, train_dir: Path, failures: list) -> dict:
    """11a: the train CLI under torchrun (world size 1) against the same
    CLI without --data-parallel, both deterministic."""
    from tpu_unet_torch.tools.profile_step import parse_trace

    common = [*DP_ARGS, "--data-dir", str(train_dir / "data"), "--load",
              str(train_dir / "init.npz")]
    trace_dir = workdir / "trace"
    t0 = time.perf_counter()
    rc = _torchrun(["-m", "tpu_unet_torch.train_cli", *common, "--data-parallel", "--profile",
                    str(trace_dir), "--checkpoint-dir", str(workdir / "ck_dp"),
                    "--history-out", str(workdir / "history_dp.json")],
                   workdir / "torchrun.log", 300)
    wall = time.perf_counter() - t0
    if rc != 0:
        tail = (workdir / "torchrun.log").read_text().splitlines()[-30:]
        raise SystemExit("chip_smoke: torchrun train_cli --data-parallel exited "
                         f"{rc}:\n" + "\n".join(tail))
    dp_hist = json.loads((workdir / "history_dp.json").read_text())
    history, launches, _ = _cli_run(common + ["--checkpoint-dir", str(workdir / "ck_plain")],
                                    "--deterministic without --data-parallel (11a)")
    (workdir / "history_plain.json").write_text(json.dumps(history))  # 12b's reference
    for name, count in launches.items():
        if count != expected_launches(name, "cuda", True, DP_STEPS):
            failures.append(f"11a plain run: {name} launched {count} times")
    differ = _same_files(workdir / "ck_dp" / "checkpoint_epoch1.npz",
                         workdir / "ck_plain" / "checkpoint_epoch1.npz")
    trace = parse_trace(trace_dir)
    in_trace = {name: trace["groups_ms"].get(group, 0.0)
                for name, group in TRAIN_KERNEL_GROUPS.items()}
    same = dp_hist == history
    log(f"11a torchrun --nproc-per-node 1 train_cli --data-parallel (NCCL): {wall:.1f} s wall "
        f"incl. start; losses {dp_hist['train_loss']} val Dice {dp_hist['val_dice']}; without "
        f"--data-parallel {history['train_loss']} {history['val_dice']}: history bitwise "
        f"equal={same}; checkpoint arrays differing: {differ or 'none'}; trace "
        + ", ".join(f"{n} {ms:.2f} ms" for n, ms in in_trace.items()))
    if not (same and len(history["train_loss"]) == DP_STEPS and len(history["val_dice"]) == 1):
        failures.append(f"11a: the data-parallel history {dp_hist} is not the plain one "
                        f"{history}")
    if differ:
        failures.append(f"11a: checkpoints differ in {differ[:8]}")
    if not all(ms > 0 for ms in in_trace.values()):
        failures.append(f"11a: the --profile trace lacks a train kernel: {in_trace}")
    return {"wall_s": wall, "history_equal": same, "checkpoint_equal": not differ,
            "trace_ms": in_trace}


def _host_step_ms(step, args, reps: int) -> list[float]:
    """Host-clock ms of ``reps`` calls of ``step(*args)``, each ending in a
    device synchronise, after one warm-up call."""
    step(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def _dp_rank(rank: int, rdzv: str, workdir: str, ckpt: str, data_dir: str) -> None:
    """11b and 11c on one of ``DP_RANKS`` gloo ranks sharing cuda:0. Writes
    ``dp_rank<r>.json`` into ``workdir``: its numbers and failures."""
    from datetime import timedelta

    from tpu_unet_torch.checkpoint import load_checkpoint
    from tpu_unet_torch.data import CarvanaDataset, DataLoader, synth_batch
    from tpu_unet_torch.evaluate import evaluate
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.models.unet import tree_leaves, tree_map
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.parallel.mesh import broadcast_tree, init_data_parallel
    from tpu_unet_torch.train import make_train_step

    out: dict = {"rank": rank, "failures": [], "steps": {}, "timing": {}}
    failures = out["failures"]
    full_fp32()
    dp = init_data_parallel(backend="gloo", device="cuda:0", init_method=f"file://{rdzv}",
                            rank=rank, world_size=DP_RANKS, timeout=timedelta(seconds=600))
    try:
        config = UNetConfig(**TRAIN_CONFIG)
        params, state = init_unet(config, np.random.default_rng(0), device="cuda")
        params, state = broadcast_tree(params, dp), broadcast_tree(state, dp)
        imgs, msks = synth_batch(np.random.default_rng(1), *PARITY_BATCH)
        images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
        rows = (dp.rows(images), dp.rows(masks))
        g64 = None
        if rank == 0:  # the float64 full-batch step, the gradients' reference
            p64 = tree_map(lambda t: t.double(), params)
            with mt.plain_versions():  # float64, which the update kernels do not compute
                ref = make_train_step(config, return_grads=True)(
                    p64, state, rmsprop_init(p64), images.double(), masks, 1e-4)
            g64 = _leaves(ref[5])
            del p64, ref
            torch.cuda.empty_cache()
        dp.barrier()
        for amp, dt in ((False, "fp32"), (True, "bf16")):
            tol = STEP_TOL[dt]
            # The single-process full-batch steps of both routes: the
            # reference of each, and each gradient's distance from float64
            # on either route, the rounding noise that tensor carries.
            refs, e_full = {}, {}
            if rank == 0:
                for kernels in ("cuda", None):
                    ref = make_train_step(config, amp=amp, kernels=kernels, return_grads=True)(
                        params, state, rmsprop_init(params), images, masks, 1e-4)
                    gr = _leaves(ref[5])
                    e_full[kernels] = {k: _rel_l2(gr[k], g64[k]) for k in g64}
                    refs[kernels] = (ref[3].item(), ref[4].item(), _leaves(ref[1]))
                    del ref, gr
                torch.cuda.empty_cache()
            dp.barrier()
            for kernels in ("cuda", None):
                tag = f"{dt} kernels={kernels}"
                step = make_train_step(config, mesh=dp, amp=amp, kernels=kernels,
                                       return_grads=True)
                K.reset_launch_counts()
                o1 = step(params, state, rmsprop_init(params), *rows, 1e-4)
                o2 = step(*o1[:3], *rows, 1e-4)
                torch.cuda.synchronize()
                counts = K.launch_counts()
                digest = hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes()
                                                 for t in tree_leaves(o2[0]))).hexdigest()
                rec = {"launches": counts, "params_sha256": digest, "loss": o1[3].item(),
                       "loss2": o2[3].item()}
                for name, count in counts.items():
                    if count != expected_launches(name, kernels, amp, 2):
                        failures.append(f"11b {tag}: {name} launched {count} times in 2 "
                                        f"steps on rank {rank}")
                if rank == 0:
                    loss, gnorm, br = refs[kernels]
                    bd = _leaves(o1[1])
                    errs = {"loss": abs(o1[3].item() - loss) / abs(loss),
                            "grad_norm": abs(o1[4].item() - gnorm) / abs(gnorm),
                            "bn_state": max(_rel_l2(bd[k], br[k]) for k in br)}
                    gd = _leaves(o1[5])
                    e_dp = {k: _rel_l2(gd[k], g64[k]) for k in g64}
                    bound = {k: GRAD_RATIO * max(e_full["cuda"][k], e_full[None][k])
                             + tol["grad_floor"] for k in g64}
                    over = [k for k in g64 if not e_dp[k] <= bound[k]]
                    ratio = {k: e_dp[k] / bound[k] for k in g64}
                    rec.update(errs, grads_dp=max(e_dp.values()),
                               grads_full=max(e_full[kernels].values()), grads_over=over)
                    log(f"11b {DP_RANKS} gloo ranks on cuda:0, {tag}, 2 of {PARITY_BATCH[0]} "
                        f"rows each, vs the full-batch step: loss rel err {errs['loss']:.3e} "
                        f"(tol {tol['loss']:g}), grad norm {errs['grad_norm']:.3e} (tol "
                        f"{tol['grad_norm']:g}), BN running stats rel L2 max "
                        f"{errs['bn_state']:.3e} (tol {tol['bn_state']:g}); gradients rel L2 to "
                        f"float64 max {max(e_dp.values()):.3e} ({_worst(e_dp)}) vs the "
                        f"full-batch step's {max(e_full[kernels].values()):.3e}; per tensor "
                        f"tol <= {GRAD_RATIO:g} x the larger of the two routes' full-batch "
                        f"distance + {tol['grad_floor']:g}, {len(over)} over, nearest "
                        f"{_worst(ratio)} of the bound; launches in 2 steps "
                        f"{json.dumps({k: v for k, v in counts.items() if v})}")
                    failures += [f"11b {tag}: {k} error {e:.3e} > {tol[k]:g}"
                                 for k, e in errs.items() if not e <= tol[k]]
                    failures += [f"11b {tag} gradient {k}: {e_dp[k]:.3e} from float64, bound "
                                 f"{bound[k]:.3e}" for k in over]
                out["steps"][tag] = rec
                del step, o1, o2
                torch.cuda.empty_cache()
        # The data-parallel step's time beside the full-batch step's (kernels="cuda").
        for amp, dt in ((True, "bf16"), (False, "fp32")):
            full = make_train_step(config, amp=amp, kernels="cuda")
            step = make_train_step(config, amp=amp, kernels="cuda", mesh=dp)
            trees = (params, state, rmsprop_init(params))
            full_ms = (_host_step_ms(full, (*trees, images, masks, 1e-4), DP_TIMING_REPS)
                       if rank == 0 else None)
            dp.barrier()
            dp_ms = _host_step_ms(step, (*trees, *rows, 1e-4), DP_TIMING_REPS)
            out["timing"][dt] = {"dp_ms": dp_ms, "full_ms": full_ms}
            del full, step
            torch.cuda.empty_cache()
        # 11c: evaluate split over the ranks against the single-process one.
        cp, cs, _, _ = load_checkpoint(ckpt, config, "cuda")
        ds = CarvanaDataset(Path(data_dir) / "imgs", Path(data_dir) / "masks", 0.5)
        loader = DataLoader(ds, 4, indices=range(DP_EVAL_IMAGES))
        out["eval_split"] = evaluate(cp, cs, loader, config, amp=True, mesh=dp)
        if rank == 0:
            out["eval_whole"] = evaluate(cp, cs, loader, config, amp=True)
    except Exception:
        failures.append(f"rank {rank}: {traceback.format_exc()}")
    finally:
        (Path(workdir) / f"dp_rank{rank}.json").write_text(json.dumps(out))
        torch.distributed.destroy_process_group()


def phase_data_parallel(workdir: Path, train_dir: Path, card: str) -> dict:
    """Phase 11 (module docstring). Returns its numbers."""
    workdir.mkdir(parents=True, exist_ok=True)
    failures: list = []
    numbers = {"cli": _dp_cli(workdir, train_dir, failures)}
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    rdzv = workdir / "rdzv"
    ckpt = workdir / "ck_dp" / "checkpoint_epoch1.npz"
    procs = [ctx.Process(target=_dp_rank, args=(r, str(rdzv), str(workdir), str(ckpt),
                                                str(train_dir / "data")))
             for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
            failures.append(f"11b: rank process {p.pid} still running after 300 s: killed")
    log(f"11b/11c: {DP_RANKS} rank processes in {time.perf_counter() - t0:.1f} s, exit codes "
        f"{[p.exitcode for p in procs]}")
    ranks = []
    for r in range(DP_RANKS):
        path = workdir / f"dp_rank{r}.json"
        if not path.exists():
            failures.append(f"11b: rank {r} wrote no result")
            continue
        ranks.append(json.loads(path.read_text()))
        failures += ranks[-1]["failures"]
    if len(ranks) == DP_RANKS:
        r0, r1 = ranks
        for tag, rec in r0["steps"].items():
            if rec["params_sha256"] != r1["steps"].get(tag, {}).get("params_sha256"):
                failures.append(f"11b {tag}: the ranks' params differ after two steps")
        log("11b ranks' params after two steps bitwise equal: "
            + ", ".join(f"{t}={rec['params_sha256'] == r1['steps'].get(t, {}).get('params_sha256')}"
                        for t, rec in r0["steps"].items()))
    if len(ranks) == DP_RANKS and all("eval_split" in rk for rk in ranks):
        r0, r1 = ranks
        for dt, tm in r0["timing"].items():
            dp_ms, full_ms = statistics.median(tm["dp_ms"]), statistics.median(tm["full_ms"])
            log(f"11b step time {dt} kernels=cuda at {list(PARITY_BATCH)} ({card}): "
                f"{DP_RANKS} ranks on one card, 2 rows each, {dp_ms:.2f} ms (median of "
                f"{' '.join(f'{t:.2f}' for t in tm['dp_ms'])}), the full-batch step "
                f"{full_ms:.2f} ms ({' '.join(f'{t:.2f}' for t in tm['full_ms'])}), ratio "
                f"{dp_ms / full_ms:.3f} (host clock, synchronised; the ranks share the SMs: "
                "not a speed claim)")
            tm.update(dp_median_ms=dp_ms, full_median_ms=full_ms)
        split, whole = r0["eval_split"], r0["eval_whole"]
        err = max(abs(a - b) for a, b in zip(split, whole))
        log(f"11c evaluate over {DP_RANKS} ranks (batches 4, 4 split, 1 whole) vs one process, "
            f"bf16, {DP_EVAL_IMAGES} images: Dice/IoU {split} vs {whole}, max abs err "
            f"{err:.3e} (tol {DP_EVAL_TOL:g}); rank 1 {r1['eval_split']}")
        if not (err <= DP_EVAL_TOL and r1["eval_split"] == split):
            failures.append(f"11c: split evaluation {split} (rank 1 {r1['eval_split']}) vs "
                            f"{whole}")
        numbers.update(steps=r0["steps"], timing=r0["timing"], eval_split=split,
                       eval_whole=whole)
    if failures:
        raise SystemExit(f"chip_smoke: data parallelism checks failed: {failures}")
    return numbers


# Phase 12: ZeRO, multi-host and halo-sharded predict at full width, two
# "hosts" sharing the card over gloo (each a process with LOCAL_WORLD_SIZE
# 1 at an explicit TCP rendezvous); (a) the ZeRO step beside the plain
# data-parallel step; (b) the multi-host trainer with the corpus staged
# over the ranks, and the train CLI's explicit rendezvous through NCCL at
# world size 1; (c) the halo-sharded forward and predict.
MH_RANKS = 2
ZERO_OPTIMIZERS = ("rmsprop", "adam")
ZERO_STEPS = 2
MH_TRAIN = dict(epochs=1, batch_size=4, val_percent=0.2, val_per_epoch=1, amp=True,
                kernels="cuda", device_dataset=True, save_checkpoint_flag=False, seed=0)
HALO_SIDE, HALO_SCALE = 2048, 0.5  # H = W = 1024 at scale 0.5: bands of 512, halo 128
HALO_REPS = 3
GATHER_PASSES = 3  # the first untimed
MH_BUDGET_S = 120.0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _digest(tree) -> str:
    from tpu_unet_torch.models.unet import tree_leaves

    return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes()
                                   for t in tree_leaves(tree))).hexdigest()


def _zero_steps(dp, out: dict) -> None:
    """12a: ``ZERO_STEPS`` steps of the plain data-parallel step and of the
    ZeRO step (``kernels=None``) from the same trees, per dtype and
    optimizer, on the rank's rows of phase 5's parity batch, under
    deterministic algorithms (with cuDNN's default ones two plain fp32 runs
    need not repeat: the control, printed)."""
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.models.unet import tree_leaves
    from tpu_unet_torch.optim import get_optimizer
    from tpu_unet_torch.parallel.zero import gather_opt_state_zero, state_bytes
    from tpu_unet_torch.train import _place_opt_state, make_train_step

    config = UNetConfig(**TRAIN_CONFIG)
    params, state = init_unet(config, np.random.default_rng(0), device=dp.device)
    imgs, msks = synth_batch(np.random.default_rng(1), *PARITY_BATCH)
    rows = tuple(dp.rows(torch.from_numpy(a).to(dp.device)) for a in (imgs, msks))

    def run(amp, opt, zero):
        """(params, BN state and the whole optimizer state as one leaf list,
        losses, grad norms, the state MB this rank holds)."""
        o, sh = _place_opt_state(get_optimizer(opt)[0](params), params, dp, zero=zero)
        step = make_train_step(config, mesh=dp, amp=amp, optimizer=opt, opt_shardings=sh)
        p, s, losses, norms = params, state, [], []
        for _ in range(ZERO_STEPS):
            p, s, o, loss, gnorm = step(p, s, o, *rows, 1e-4)
            losses.append(loss.item())
            norms.append(gnorm.item())
        held = state_bytes(o) / 1e6
        full = gather_opt_state_zero(o, sh) if zero else o
        return tree_leaves((p, s, full)), losses, norms, held

    def same(a, b) -> bool:  # compared on the card
        return (a[1:3] == b[1:3] and len(a[0]) == len(b[0])
                and all(torch.equal(x, y) for x, y in zip(a[0], b[0])))

    control = run(False, "rmsprop", False)  # cuDNN's default algorithms
    out["zero_control_bitwise"] = same(control, run(False, "rmsprop", False))
    del control
    for amp, dt in ((False, "fp32"), (True, "bf16")):
        for opt in ZERO_OPTIMIZERS:
            with Deterministic():
                plain = run(amp, opt, False)
                zero = run(amp, opt, True)
            equal = same(plain, zero)
            n_params = len(tree_leaves(params))
            out["zero"][f"{dt} {opt}"] = {"bitwise": equal, "plain_mb": plain[3],
                                          "zero_mb": zero[3], "loss": zero[1],
                                          "params_sha256": _digest(tuple(zero[0][:n_params]))}
            if not equal:
                out["failures"].append(f"12a {dt} {opt}: the ZeRO step is not bitwise the "
                                       f"plain data-parallel step (losses {plain[1]} vs "
                                       f"{zero[1]}, grad norms {plain[2]} vs {zero[2]})")
            if not zero[3] < 0.55 * plain[3]:
                out["failures"].append(f"12a {dt} {opt}: rank {dp.rank} holds "
                                       f"{zero[3]:.1f} MB of {plain[3]:.1f}")
            del plain, zero
            torch.cuda.empty_cache()


def _multihost_train(dp, train_dir: str, out: dict) -> None:
    """12b: ``train_model`` across the two "hosts" with the host feed and
    with the corpus staged over them, beside the staged run as one host's
    two ranks; then the cost of the staged corpus's gather (``_gather_cost``)."""
    import dataclasses

    import tpu_unet_torch.train as train_mod
    from tpu_unet_torch.checkpoint import load_checkpoint
    from tpu_unet_torch.data import CarvanaDataset, DataLoader
    from tpu_unet_torch.models import UNetConfig

    config = UNetConfig(**TRAIN_CONFIG)
    data = Path(train_dir) / "data"
    ds = CarvanaDataset(data / "imgs", data / "masks", 0.5)
    real_build = train_mod._build_loaders
    feeds = {}

    def build_loaders(*a, **k):
        train, val = real_build(*a, **k)
        if isinstance(train, DataLoader):
            feeds.update(feed="host", train_shard=train.shard, val_shard=val.shard,
                         val_batch=val.batch_size)
        else:
            dd = train.parent
            feeds.update(feed="device", staged_mb=dd.staged_bytes / 1e6, rows=[dd.lo, dd.hi])
        return train, val

    train_mod._build_loaders = build_loaders
    try:
        for tag, mh, device_dataset in (("multihost_host", True, False),
                                        ("multihost", True, True), ("one_host", False, True)):
            params, state, _, _ = load_checkpoint(Path(train_dir) / "init.npz", config, dp.device)
            feeds.clear()
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with Deterministic():
                _, _, hist = train_mod.train_model(
                    params, state, config, dataset=ds,
                    data_parallel=dataclasses.replace(dp, multihost=mh),
                    **{**MH_TRAIN, "device_dataset": device_dataset})
            torch.cuda.synchronize()
            out["train"][tag] = {"history": hist, "launches": K.launch_counts(),
                                 "wall_s": time.perf_counter() - t0, **feeds}
    finally:
        train_mod._build_loaders = real_build
    n = len(ds)
    h, w, c = ds[0]["image"].shape
    out["train"]["whole_mb"] = n * (h * w * c + h * w) / 1e6
    one = out["train"]["one_host"]
    host = out["train"]["multihost_host"]
    if host["feed"] != "host" or host["val_shard"] != (dp.rank, dp.world_size):
        out["failures"].append(f"12b: the multi-host run without device_dataset fed "
                               f"{host['feed']} batches, val shard {host.get('val_shard')}")
    for tag in ("multihost_host", "multihost"):
        rec = out["train"][tag]
        for name, count in rec["launches"].items():
            if count != expected_launches(name, "cuda", True, ZERO_STEPS):
                out["failures"].append(f"12b {tag}: {name} launched {count} times in "
                                       f"{ZERO_STEPS} steps on rank {dp.rank}")
        if rec["history"] != one["history"]:
            out["failures"].append(f"12b {tag}: the history {rec['history']} is not the one "
                                   f"host's {one['history']}")
    if not out["train"]["multihost"]["staged_mb"] <= 0.55 * out["train"]["whole_mb"]:
        out["failures"].append(f"12b: rank {dp.rank} staged "
                               f"{out['train']['multihost']['staged_mb']:.1f} MB of "
                               f"{out['train']['whole_mb']:.1f}")
    _gather_cost(dp, ds, config, Path(train_dir) / "init.npz", out)


def _gather_cost(dp, ds, config, init: Path, out: dict) -> None:
    """12b: host-clock ms of each train batch's gather and of the step on
    it, over ``GATHER_PASSES`` passes of the shuffled corpus (b4, each rank
    its 2 rows, ``kernels="cuda"``, bf16), with the corpus staged over the
    ranks (a global batch by one all-reduce) and whole on each rank (a
    local gather, the layout before per-rank staging). The ranks share the card and gloo moves
    the batch through the host: an upper bound on an NCCL world's cost."""
    from tpu_unet_torch.checkpoint import load_checkpoint
    from tpu_unet_torch.data.device_cache import DeviceResidentData
    from tpu_unet_torch.optim import get_optimizer
    from tpu_unet_torch.train import make_train_step

    params, state, _, _ = load_checkpoint(init, config, dp.device)
    opt = get_optimizer("rmsprop")[0](params)
    step = make_train_step(config, mesh=dp, amp=True, kernels="cuda")
    idx = list(range(len(ds)))
    shard = (dp.rank, dp.world_size)
    for tag, staged in (("per_rank", DeviceResidentData(ds, device=dp.device, dp=dp)),
                        ("whole", DeviceResidentData(ds, device=dp.device))):
        batches = staged.batches(idx, MH_TRAIN["batch_size"], shuffle=True, seed=0,
                                 drop_last=True, shard=shard)
        gather_ms, step_ms = [], []
        for k in range(GATHER_PASSES):
            it = iter(batches)
            while True:
                dp.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                b = next(it, None)
                if b is None:
                    break
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step(params, state, opt, b["image"], b["mask"], 1e-5)
                torch.cuda.synchronize()
                if k:
                    gather_ms.append((t1 - t0) * 1e3)
                    step_ms.append((time.perf_counter() - t1) * 1e3)
        out["gather"][tag] = {"gather_ms": gather_ms, "step_ms": step_ms,
                              "staged_mb": staged.staged_bytes / 1e6}
        del staged, batches
        torch.cuda.empty_cache()


def _halo_sharded(dp, ckpt: str, image: str, out: dict) -> None:
    """12c: the halo-sharded forward and ``predict_img_halo_sharded`` on the
    two ranks against the one-process full-image forward and
    ``predict_img``, fp32 and bf16."""
    from tpu_unet_torch.checkpoint import load_checkpoint
    from tpu_unet_torch.data.loading import preprocess
    from tpu_unet_torch.models import UNetConfig
    from tpu_unet_torch.models.unet import unet_apply
    from tpu_unet_torch.parallel.tiling import make_halo_sharded_forward, min_halo
    from tpu_unet_torch.predict import predict_img, predict_img_halo_sharded

    config = UNetConfig(**TRAIN_CONFIG)
    params, state, _, _ = load_checkpoint(ckpt, config, dp.device)
    img = Image.open(image)
    x = torch.from_numpy(preprocess(img, HALO_SCALE))[None].to(dp.device)
    band = x.shape[1] // dp.world_size
    xb = x[:, dp.rank * band:(dp.rank + 1) * band]
    for amp, dt in ((False, "fp32"), (True, "bf16")):
        fwd = make_halo_sharded_forward(dp, config, halo=min_halo(config), amp=amp)
        with torch.inference_mode():
            sharded = fwd(params, state, xb)
            ms = []
            for _ in range(HALO_REPS):
                dp.barrier()
                torch.cuda.synchronize()
                t = time.perf_counter()
                fwd(params, state, xb)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            rec = {"sharded_ms": ms, "band": band, "halo": min_halo(config)}
            mask = predict_img_halo_sharded(params, state, config, img, dp=dp,
                                            scale_factor=HALO_SCALE, amp=amp, device=dp.device)
            if dp.rank == 0:
                full, _ = unet_apply(params, state, x, config=config, train=False,
                                     compute_dtype=torch.bfloat16 if amp else None)
                rng = (full.max() - full.min()).item()
                rec.update(max_abs_err=(sharded - full).abs().max().item(), range=rng,
                           bitwise=bool(torch.equal(sharded, full)),
                           full_ms=_host_ms_sync(lambda: unet_apply(
                               params, state, x, config=config, train=False,
                               compute_dtype=torch.bfloat16 if amp else None)))
                ref = predict_img(params, state, config, img, scale_factor=HALO_SCALE, amp=amp,
                                  device=dp.device)
                rec["mask_agreement"] = float((mask == ref).mean())
                if dt == "fp32" and not rec["max_abs_err"] <= RANGE_TOL * rng:
                    out["failures"].append(f"12c fp32: sharded logits {rec['max_abs_err']:.3e} "
                                           f"from the full forward's (range {rng:.3f})")
                if not rec["mask_agreement"] >= MASK_AGREEMENT:
                    out["failures"].append(f"12c {dt}: masks {rec['mask_agreement']:.5f} equal")
        out["halo"][dt] = rec


def _host_ms_sync(fn) -> list[float]:
    """Host-clock ms of ``HALO_REPS`` synchronised calls of ``fn`` after one."""
    with torch.inference_mode():
        fn()
        times = []
        for _ in range(HALO_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    return times


def _mh_rank(rank: int, coordinator: str, workdir: str, train_dir: str, ckpt: str,
             image: str, device: str = "cuda:0") -> None:
    """12a-12c on one of ``MH_RANKS`` "hosts" sharing ``device`` over gloo.
    Writes ``mh_rank<r>.json`` into ``workdir``: its numbers and failures."""
    from datetime import timedelta

    from tpu_unet_torch.parallel import multihost
    from tpu_unet_torch.parallel.mesh import init_data_parallel

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(MH_RANKS), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE="1")
    out: dict = {"rank": rank, "failures": [], "zero": {}, "train": {}, "gather": {},
                 "halo": {}}
    full_fp32()
    multihost.initialize(coordinator, MH_RANKS, rank, backend="gloo", device=device,
                         timeout=timedelta(seconds=600))
    try:
        dp = init_data_parallel(device=device)
        out["multihost"] = dp.multihost
        for name, part in (("12a", lambda: _zero_steps(dp, out)),
                           ("12b", lambda: _multihost_train(dp, train_dir, out)),
                           ("12c", lambda: _halo_sharded(dp, ckpt, image, out))):
            t0 = time.perf_counter()
            part()
            torch.cuda.empty_cache()
            out[f"{name}_s"] = time.perf_counter() - t0
    except Exception:
        out["failures"].append(f"rank {rank}: {traceback.format_exc()}")
    finally:
        (Path(workdir) / f"mh_rank{rank}.json").write_text(json.dumps(out))
        torch.distributed.destroy_process_group()


def _mh_cli(workdir: Path, dp_dir: Path, train_dir: Path, failures: list) -> dict:
    """12b: ``train_cli --data-parallel --multihost`` with the explicit
    rendezvous flags at world size 1 (NCCL), against 11a's run without
    ``--data-parallel``: history and checkpoint bitwise."""
    cmd = [sys.executable, "-m", "tpu_unet_torch.train_cli", *DP_ARGS, "--data-dir",
           str(train_dir / "data"), "--load", str(train_dir / "init.npz"), "--data-parallel",
           "--multihost", "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "1",
           "--process-id", "0", "--checkpoint-dir", str(workdir / "ck_mh"), "--history-out",
           str(workdir / "history_mh.json")]
    log_path = workdir / "cli_mh.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                                stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(300)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise SystemExit(f"chip_smoke: train_cli --multihost did not finish in 300 s "
                             f"(log {log_path})") from None
    wall = time.perf_counter() - t0
    if rc != 0:
        tail = log_path.read_text().splitlines()[-30:]
        raise SystemExit(f"chip_smoke: train_cli --multihost exited {rc}:\n" + "\n".join(tail))
    hist = json.loads((workdir / "history_mh.json").read_text())
    plain = json.loads((dp_dir / "history_plain.json").read_text())
    differ = _same_files(workdir / "ck_mh" / "checkpoint_epoch1.npz",
                         dp_dir / "ck_plain" / "checkpoint_epoch1.npz")
    log(f"12b train_cli --data-parallel --multihost --coordinator 127.0.0.1:<port> "
        f"--num-processes 1 --process-id 0 (NCCL): {wall:.1f} s wall incl. start; losses "
        f"{hist['train_loss']} val Dice {hist['val_dice']}; 11a's run without "
        f"--data-parallel {plain['train_loss']} {plain['val_dice']}: history bitwise equal="
        f"{hist == plain}; checkpoint arrays differing: {differ or 'none'}")
    if hist != plain:
        failures.append(f"12b: the --multihost CLI history {hist} is not the plain one {plain}")
    if differ:
        failures.append(f"12b: --multihost checkpoint differs in {differ[:8]}")
    return {"wall_s": wall, "history_equal": hist == plain, "checkpoint_equal": not differ}


def _tile_sharded_cli(workdir: Path, ckpt: Path, image: Path, failures: list) -> dict:
    """12c: ``predict --tile-sharded`` as one process: JAX's fallback warning
    and ``predict``'s mask."""
    import logging

    from tpu_unet_torch import predict

    warned = []

    class Grab(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    grab = Grab(level=logging.WARNING)
    logging.getLogger("tpu_unet_torch.predict").addHandler(grab)
    try:
        outs = {}
        for tag, flags in (("tile_sharded", ["--tile-sharded"]), ("plain", [])):
            outs[tag] = workdir / f"{tag}.png"
            predict.main(["-m", str(ckpt), "-i", str(image), "-o", str(outs[tag]), "-s",
                          str(HALO_SCALE), *flags])
    finally:
        logging.getLogger("tpu_unet_torch.predict").removeHandler(grab)
    warn = any("halo-sharded constraints not met (devices=1" in m for m in warned)
    same = np.array_equal(np.asarray(Image.open(outs["tile_sharded"])),
                          np.asarray(Image.open(outs["plain"])))
    log(f"12c predict --tile-sharded as one process: fallback warning={warn}, mask equal to "
        f"predict's={same}")
    if not (warn and same):
        failures.append(f"12c: one-process --tile-sharded warned={warn}, mask equal={same}")
    return {"warned": warn, "mask_equal": same}


def phase_multihost(workdir: Path, train_dir: Path, dp_dir: Path, ckpt: Path, card: str) -> dict:
    """Phase 12 (module docstring). Returns its numbers."""
    from tpu_unet_torch.data import make_synthetic_carvana

    workdir.mkdir(parents=True, exist_ok=True)
    failures: list = []
    numbers = {"cli": _mh_cli(workdir, dp_dir, train_dir, failures)}
    torch.cuda.empty_cache()
    img_dir, _ = make_synthetic_carvana(workdir / "big", n=1, h=HALO_SIDE, w=HALO_SIDE, seed=3)
    image = sorted(Path(img_dir).glob("*.png"))[0]
    numbers["predict_cli"] = _tile_sharded_cli(workdir, ckpt, image, failures)
    ctx = mp.get_context("spawn")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_mh_rank, args=(r, coordinator, str(workdir), str(train_dir),
                                                str(ckpt), str(image)))
             for r in range(MH_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
            failures.append(f"12: rank process {p.pid} still running after 300 s: killed")
    log(f"12a-12c: {MH_RANKS} host processes in {time.perf_counter() - t0:.1f} s, exit codes "
        f"{[p.exitcode for p in procs]}")
    ranks = []
    for r in range(MH_RANKS):
        path = workdir / f"mh_rank{r}.json"
        if not path.exists():
            failures.append(f"12: rank {r} wrote no result")
            continue
        ranks.append(json.loads(path.read_text()))
        failures += ranks[-1]["failures"]
    if len(ranks) == MH_RANKS and all("12c_s" in rk for rk in ranks):
        r0, r1 = ranks
        log(f"12 ranks' world spans hosts: {[rk['multihost'] for rk in ranks]}; parts "
            + ", ".join(f"{p} {r0[p + '_s']:.1f} s" for p in ("12a", "12b", "12c")))
        log(f"12a control: two plain fp32 RMSprop runs with cuDNN's default algorithms "
            f"bitwise equal={r0['zero_control_bitwise']} (rank 1 "
            f"{r1['zero_control_bitwise']}); the runs below use deterministic algorithms")
        for tag, rec in r0["zero"].items():
            other = r1["zero"][tag]
            log(f"12a {tag}, kernels=None, {ZERO_STEPS} steps, 2 of {PARITY_BATCH[0]} rows a "
                f"rank: ZeRO bitwise the plain data-parallel step={rec['bitwise']} (rank 1 "
                f"{other['bitwise']}); optimizer state a rank {rec['zero_mb']:.1f} / "
                f"{other['zero_mb']:.1f} MB against {rec['plain_mb']:.1f} MB replicated; "
                f"losses {rec['loss']}")
            if rec["params_sha256"] != other["params_sha256"]:
                failures.append(f"12a {tag}: the ranks' params differ")
        one = r0["train"]["one_host"]
        for tag, what in (("multihost_host", "the host feed (shard-marked val batches)"),
                          ("multihost", "--device-dataset")):
            mh, mh1 = r0["train"][tag], r1["train"][tag]
            staged = (f"rows staged {mh['rows']} / {mh1['rows']}, {mh['staged_mb']:.1f} / "
                      f"{mh1['staged_mb']:.1f} MB a rank of {r0['train']['whole_mb']:.1f} MB"
                      if mh["feed"] == "device" else
                      f"train / val shards {mh['train_shard']} / {mh1['train_shard']}, val "
                      f"batch {mh['val_batch']}")
            log(f"12b train_model across 2 hosts, kernels=cuda, bf16, {what}, "
                f"{len(mh['history']['train_loss'])} steps: losses "
                f"{mh['history']['train_loss']} val Dice {mh['history']['val_dice']}; bitwise "
                f"the --device-dataset run as one host's 2 ranks={mh['history'] == one['history']}"
                f"; {staged}; launches rank 0 "
                f"{json.dumps({k: v for k, v in mh['launches'].items() if v})}, rank 1 "
                f"{json.dumps({k: v for k, v in mh1['launches'].items() if v})}; wall "
                f"{mh['wall_s']:.1f} s (one host {one['wall_s']:.1f} s)")
            if mh["history"] != mh1["history"]:
                failures.append(f"12b {tag}: the two hosts' histories differ")
        for tag, rec in r0["gather"].items():
            layout = ("staged over the ranks (all-reduce)" if tag == "per_rank"
                      else "whole on each rank (local gather)")
            log(f"12b gather + step at 959x640 b4 (2 rows a rank), corpus {layout}, "
                f"{rec['staged_mb']:.1f} MB a rank ({card}, 2 gloo ranks on one card, host "
                f"clock): gather median {statistics.median(rec['gather_ms']):.2f} ms "
                f"(rank 1 {statistics.median(r1['gather'][tag]['gather_ms']):.2f}), step median "
                f"{statistics.median(rec['step_ms']):.2f} ms, {len(rec['gather_ms'])} batches")
        for dt, rec in r0["halo"].items():
            log(f"12c predict_img_halo_sharded {dt} at {HALO_SIDE}² scale {HALO_SCALE} "
                f"({card}): {MH_RANKS} ranks, band {rec['band']}, halo {rec['halo']}; logits "
                f"max abs err {rec['max_abs_err']:.3e} against the full forward's (range "
                f"{rec['range']:.3f}, tol {RANGE_TOL:g} x range in fp32), bitwise="
                f"{rec['bitwise']}; masks {rec['mask_agreement']:.5f} equal to predict_img's "
                f"(>= {MASK_AGREEMENT}); sharded forward "
                f"{statistics.median(rec['sharded_ms']):.2f} ms vs full "
                f"{statistics.median(rec['full_ms']):.2f} ms (host clock, ranks share the "
                "card: not a speed claim)")
        numbers.update(zero=r0["zero"], train={k: {kk: vv for kk, vv in v.items()
                                                   if kk != "launches"}
                                               if isinstance(v, dict) else v
                                               for k, v in r0["train"].items()},
                       gather=r0["gather"], halo=r0["halo"],
                       parts_s={p: r0[p + "_s"] for p in ("12a", "12b", "12c")})
    if failures:
        raise SystemExit(f"chip_smoke: ZeRO / multi-host / halo-sharded checks failed: "
                         f"{failures}")
    return numbers


# Phase 13: spatial parallelism at full width (module docstring): gloo ranks
# sharing the card at an explicit TCP rendezvous, as 1 x 2 and 2 x 2 (data x
# spatial) grids; the one-process references in the first grid's rank 0
# before its grid steps, so that the peaks compare fresh processes.
SP_GRIDS = ((2, 2), (4, 2))  # (ranks, S)
# (model, amp, global batch). R2U-Net's fp32 gradients are ill-conditioned
# (PERF.md §6, PR 1-14): RMSprop's first step, 10·lr·sign(g), flips more than
# 1% of some leaves on any change of sum order, so its params are held by
# the float64-distance rule (``SP_FLOAT64``) where JAX's element rule fails.
SP_CASES = (("unet", False, PARITY_BATCH), ("unet", True, PARITY_BATCH),
            ("bilinear", False, (2, 640, 959)), ("r2u", False, (2, 640, 959)))
SP_FLOAT64 = ("r2u",)
SP_LR = 1e-4
SP_CLI_ARGS = ("-s", "0.5", "-b", "4", "--epochs", "1", "--validation", "20",
               "--val-per-epoch", "1", "--data-parallel", "--spatial-parallel", "2",
               "--device", "cuda:0")
SP_BUDGET_S = 120.0


def _sp_tag(model: str, amp: bool) -> str:
    return f"{model} {'bf16' if amp else 'fp32'}"


def _sp_case(model: str, batch, device):
    """(config, params, state, images, masks) of a phase-13 case, from seeds."""
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet

    fields = dict(TRAIN_CONFIG)
    if model == "bilinear":
        fields["bilinear"] = True
    elif model == "r2u":
        fields["arch"] = "r2u"
    config = UNetConfig(**fields)
    params, state = init_unet(config, np.random.default_rng(0), device=device)
    imgs, msks = synth_batch(np.random.default_rng(1), *batch)
    return config, params, state, torch.from_numpy(imgs), torch.from_numpy(msks)


def _sp_step(step, trees, images, masks, lr=SP_LR) -> tuple[tuple, float, list]:
    """(outputs, peak GiB, the conv with the largest transient) of one step.
    Around each conv of it, forward and backward (the ops that take cuDNN
    workspaces), the caching allocator's counters, kept on the host as
    memory is requested: its transient is its peak above the memory
    allocated before it; the step's peak takes every op's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    convs = (torch.ops.aten.convolution, torch.ops.aten.convolution_backward)
    top = [0, "", []]
    peak = [0]

    class ConvPeaks(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket not in convs:
                return func(*args, **(kwargs or {}))
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = func(*args, **(kwargs or {}))
            high = torch.cuda.max_memory_allocated()
            if high - base > top[0]:
                top[:] = [high - base, str(func),
                          [list(a.shape) for a in args if isinstance(a, torch.Tensor)][:2]]
            return out

    torch.cuda.reset_peak_memory_stats()
    with ConvPeaks():
        out = step(*trees, images, masks, lr)
    peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
    return out, peak[0] / 2**30, [top[0] / 2**30, *top[1:]]


def _float64_step(config, params, state, images, masks):
    """The one-process step in float64, its clipped gradients returned: the
    trees and images as float64, ``Tensor.float`` keeping float64 tensors
    (the logits and the loss cast to fp32 by name), and the clip and update
    in their plain versions (``mt.plain_versions()``)."""
    from unittest import mock

    from tpu_unet_torch.models.unet import tree_map
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    fp32 = torch.Tensor.float
    with mock.patch.object(torch.Tensor, "float",
                           lambda t: t if t.dtype == torch.float64 else fp32(t)), \
            mt.plain_versions():
        p64, s64 = (tree_map(lambda t: t.double(), tree) for tree in (params, state))
        return make_train_step(config, return_grads=True)(
            p64, s64, rmsprop_init(p64), images.double(), masks, SP_LR)


def _sp_references(workdir: Path, out: dict) -> None:
    """13a/b's one-process steps (``SP_CASES``), each in this fresh process:
    loss, grad norm, BN state and params to ``sp_ref<i>.pt``, peak and time
    into ``out``; for ``SP_FLOAT64``, the float64 step's params too, and the
    fp32 step's largest per-tensor relative L2 distance from them."""
    from tpu_unet_torch.models.unet import tree_leaves
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    for i, (model, amp, batch) in enumerate(SP_CASES):
        config, params, state, images, masks = _sp_case(model, batch, "cuda")
        images, masks = images.cuda(), masks.cuda()
        step = make_train_step(config, amp=amp)
        o, peak, top = _sp_step(step, (params, state, rmsprop_init(params)), images, masks)
        ref = {"loss": o[3].item(), "gnorm": o[4].item(),
               "bn": [t.cpu() for t in tree_leaves(o[1])],
               "params": [t.cpu() for t in tree_leaves(o[0])]}
        del step, o
        torch.cuda.empty_cache()
        if model in SP_FLOAT64:
            ref["params64"] = [t.float().cpu() for t in tree_leaves(
                _float64_step(config, params, state, images, masks)[0])]
            ref["e_one"] = max(_rel_l2(a, b) for a, b in zip(ref["params"], ref["params64"]))
            torch.cuda.empty_cache()
        torch.save(ref, workdir / f"sp_ref{i}.pt")
        out["ref"][_sp_tag(model, amp)] = {"peak_gib": peak, "top_op": top,
                                           **({"e_one": ref["e_one"]} if "e_one" in ref
                                              else {})}
        del config, params, state, images, masks, ref


def _sp_compare(o, ref: dict, amp: bool) -> dict:
    """A grid step's outputs ``o`` against the one-process step's: loss and
    grad norm relative errors, the BN state's largest absolute and
    per-tensor relative L2 errors, and the params by JAX's rule
    (``tests/test_parallel.py``): median |diff| per leaf, the share of a
    leaf's elements off by more than 1e-3, the largest |diff|; with the
    float64 step's params in ``ref``, PR 17's rule beside it: the largest
    per-tensor relative L2 distance from them at most twice the fp32
    one-process step's, plus 1e-7."""
    from tpu_unet_torch.models.unet import tree_leaves

    bn = tree_leaves(o[1])
    rec = {"loss": abs(o[3].item() - ref["loss"]) / abs(ref["loss"]),
           "grad_norm": abs(o[4].item() - ref["gnorm"]) / abs(ref["gnorm"]),
           "bn_abs": max((a.float().cpu() - b).abs().max().item() for a, b in zip(bn, ref["bn"])),
           "bn_state": max(_rel_l2(a.float().cpu(), b) for a, b in zip(bn, ref["bn"]))}
    med = off = big = 0.0
    for a, b in zip(tree_leaves(o[0]), ref["params"]):
        d = (a.float() - b.to(a.device).float()).abs().reshape(-1)
        med = max(med, d.median().item())
        off = max(off, (d > 1e-3).float().mean().item() if d.numel() > 300 else 0.0)
        big = max(big, d.max().item())
    rec.update(params_median=med, params_off_share=off, params_max=big)
    if amp:
        tol = STEP_TOL["bf16"]
        rec["ok"] = all(rec[k] <= tol[k] for k in ("loss", "grad_norm", "bn_state"))
        return rec
    jax_rule = med < 1e-5 and off <= 0.01 and big < 0.1
    if "params64" in ref:
        rec["e_grid"] = max(_rel_l2(a.cpu(), b) for a, b in
                            zip(tree_leaves(o[0]), ref["params64"]))
        rec["e_one"] = ref["e_one"]
        jax_rule = jax_rule or rec["e_grid"] <= 2 * ref["e_one"] + 1e-7
    rec["ok"] = (rec["loss"] <= 1e-5 and rec["grad_norm"] <= 1e-3 and rec["bn_abs"] <= 1e-3
                 and jax_rule)
    return rec


def _sp_rank(rank: int, world: int, spatial: int, coordinator: str, workdir: str,
             train_dir: str) -> None:
    """13a-13d on one rank of a (world / spatial) x spatial grid sharing
    cuda:0 over gloo. Writes ``sp<world>_rank<r>.json`` into ``workdir``."""
    from datetime import timedelta

    from tpu_unet_torch.models.unet import tree_leaves
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.parallel.mesh import init_data_parallel, make_grid
    from tpu_unet_torch.train import make_train_step

    workdir = Path(workdir)
    out: dict = {"rank": rank, "failures": [], "ref": {}, "grid": {}}
    full_fp32()
    dp = init_data_parallel(backend="gloo", device="cuda:0", init_method=f"tcp://{coordinator}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=600))
    try:
        t0 = time.perf_counter()
        grid = make_grid(dp, spatial)
        if world == SP_GRIDS[0][0] and rank == 0:
            _sp_references(workdir, out)
        dp.barrier()
        for i, (model, amp, batch) in enumerate(SP_CASES):
            config, params, state, images, masks = _sp_case(model, batch, "cuda")
            step = make_train_step(config, amp=amp, mesh=grid)
            bands = (grid.bands(images).cuda(), grid.bands(masks).cuda())
            o, peak, top = _sp_step(step, (params, state, rmsprop_init(params)), *bands)
            rec = {"peak_gib": peak, "top_op": top, "params_sha256": _digest(o[0]),
                   "band": list(bands[0].shape)}
            if rank == 0:
                rec.update(_sp_compare(o, torch.load(workdir / f"sp_ref{i}.pt"), amp))
            out["grid"][_sp_tag(model, amp)] = rec
            del config, params, state, step, o, bands
            torch.cuda.empty_cache()
        out["steps_s"] = time.perf_counter() - t0
        if world == SP_GRIDS[0][0]:
            # 13c: the train CLI on the grid, joining this group (gloo).
            from tpu_unet_torch import train_cli

            t0 = time.perf_counter()
            ck = workdir / "ck_spatial"
            hist = train_cli.main([*SP_CLI_ARGS, "--data-dir", str(Path(train_dir) / "data"),
                                   "--load", str(Path(train_dir) / "init.npz"),
                                   "--checkpoint-dir", str(ck)])[2]
            out["cli"] = {"history": hist, "wall_s": time.perf_counter() - t0,
                          "written": sorted(f.name for f in ck.glob("*.npz"))
                          if ck.exists() else []}
    except Exception:
        out["failures"].append(f"rank {rank} of {world}: {traceback.format_exc()}")
    finally:
        (workdir / f"sp{world}_rank{rank}.json").write_text(json.dumps(out))
        torch.distributed.destroy_process_group()


def _top(op) -> str:
    gib, name, shapes = op
    return f"{gib:.3f} GiB ({name} on {shapes})"


def _rank_memory(case: str, ranks: list, tag: str, refs: dict) -> list[str]:
    """Phases 13d and 14a's memory rule (``ops/conv.py``'s cuDNN engine rule):
    each rank's peak below the one-process step's, and no conv transient of
    a rank above the largest of the one-process steps of its model (either
    dtype; ``refs`` by ``_sp_tag``). Returns the failures, each naming the
    rank's largest transient."""
    one = refs[tag]
    model = tag.split()[0]
    top = max((r["top_op"] for t, r in refs.items() if t.split()[0] == model),
              key=lambda op: op[0])
    failures = []
    for rk in ranks:
        rec = rk["grid"][tag]
        if not rec["peak_gib"] < one["peak_gib"]:
            failures.append(f"{case}: rank {rk['rank']}'s peak {rec['peak_gib']:.3f} GiB is not "
                            f"below one process's {one['peak_gib']:.3f} GiB; its largest conv "
                            f"transient {_top(rec['top_op'])}")
        if not rec["top_op"][0] <= top[0]:
            failures.append(f"{case}: rank {rk['rank']}'s largest conv transient "
                            f"{_top(rec['top_op'])} is above the one-process {model} steps' "
                            f"{_top(top)}")
    return failures


def phase_spatial(workdir: Path, train_dir: Path, card: str) -> dict:
    """Phase 13 (module docstring). Returns its numbers."""
    workdir.mkdir(parents=True, exist_ok=True)
    failures: list = []
    ctx = mp.get_context("spawn")
    grids = {}
    for world, spatial in SP_GRIDS:
        coordinator = f"127.0.0.1:{_free_port()}"
        procs = [ctx.Process(target=_sp_rank, args=(r, world, spatial, coordinator,
                                                    str(workdir), str(train_dir)))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + 300
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
                failures.append(f"13: rank process {p.pid} still running after 300 s: killed")
        shape = f"{world // spatial}x{spatial}"
        log(f"13 {shape} grid: {world} rank processes in {time.perf_counter() - t0:.1f} s, "
            f"exit codes {[p.exitcode for p in procs]}")
        ranks = []
        for r in range(world):
            path = workdir / f"sp{world}_rank{r}.json"
            if not path.exists():
                failures.append(f"13 {shape}: rank {r} wrote no result")
                continue
            ranks.append(json.loads(path.read_text()))
            failures += ranks[-1]["failures"]
        if len(ranks) == world and all(len(rk["grid"]) == len(SP_CASES) for rk in ranks):
            grids[shape] = ranks
    if len(grids) == len(SP_GRIDS):
        ref = grids[f"{SP_GRIDS[0][0] // SP_GRIDS[0][1]}x{SP_GRIDS[0][1]}"][0]["ref"]
        for shape, ranks in grids.items():
            for model, amp, batch in SP_CASES:
                tag = _sp_tag(model, amp)
                rec, one = ranks[0]["grid"][tag], ref[tag]
                same = all(rk["grid"][tag]["params_sha256"] == rec["params_sha256"]
                           for rk in ranks)
                peaks = [rk["grid"][tag]["peak_gib"] for rk in ranks]
                tol = ("loss 1e-5, grad norm 1e-3, BN 1e-3 abs, params median < 1e-5, <= 1% "
                       "off by > 1e-3, max < 0.1" if not amp else
                       "STEP_TOL bf16 on loss, grad norm, BN (params printed)")
                f64 = (f"; params' largest rel L2 from the float64 step {rec['e_grid']:.3e}, "
                       f"the one-process fp32 step's {rec['e_one']:.3e} (tol 2x + 1e-7, where "
                       "JAX's rule fails)" if "e_grid" in rec else "")
                log(f"13a/b {shape} grid, {tag}, global batch {list(batch)}, band "
                    f"{rec['band']} a rank, vs the one-process step: loss rel err "
                    f"{rec['loss']:.3e}, grad norm {rec['grad_norm']:.3e}, BN max abs "
                    f"{rec['bn_abs']:.3e} (rel L2 {rec['bn_state']:.3e}), params median "
                    f"{rec['params_median']:.3e} max {rec['params_max']:.3e} off-share "
                    f"{rec['params_off_share']:.4%} (tol: {tol}){f64}; ok={rec['ok']}; ranks' "
                    f"params bitwise equal={same}; 13d peak a rank "
                    f"{' '.join(f'{p:.3f}' for p in peaks)} GiB vs one process "
                    f"{one['peak_gib']:.3f} GiB (ratio {max(peaks) / one['peak_gib']:.3f}; "
                    f"{card}); the largest conv transient, rank 0 {_top(rec['top_op'])}, "
                    f"one process {_top(one['top_op'])}")
                if not rec["ok"]:
                    failures.append(f"13 {shape} {tag}: the grid step is off the one-process "
                                    f"step: {rec}")
                if not same:
                    failures.append(f"13 {shape} {tag}: the ranks' params differ")
                failures += _rank_memory(f"13 {shape} {tag}", ranks, tag, ref)
        cli = grids[f"{SP_GRIDS[0][0] // SP_GRIDS[0][1]}x{SP_GRIDS[0][1]}"][0].get("cli")
        if cli is None:
            failures.append("13c: no train CLI result")
        else:
            h = cli["history"]
            log(f"13c train_cli {' '.join(SP_CLI_ARGS)} on phase 6's pairs (1x2 grid, gloo): "
                f"losses {h['train_loss']} val Dice {h['val_dice']}, wrote {cli['written']}, "
                f"{cli['wall_s']:.1f} s")
            if not ("checkpoint_epoch1.npz" in cli["written"] and h["train_loss"]
                    and all(np.isfinite(h["train_loss"])) and len(h["val_dice"]) == 1):
                failures.append(f"13c: the spatial train CLI run {cli}")
    if failures:
        raise SystemExit(f"chip_smoke: spatial parallelism checks failed: {failures}")
    return {shape: {"ref": ranks[0]["ref"] if shape == "1x2" else None,
                    "grid": [rk["grid"] for rk in ranks], "steps_s": ranks[0]["steps_s"]}
            for shape, ranks in grids.items()}


# Phase 14: tensor and pipeline parallelism at full width (module docstring).
TP_GRIDS = ((2, 1, 2), (4, 2, 2))  # (ranks, S, T): 1 x 1 x 2 and 1 x 2 x 2
TP_CASES = {2: (("unet", False, PARITY_BATCH), ("unet", True, PARITY_BATCH),
                ("r2u", False, (2, 640, 959))),
            4: (("unet", False, PARITY_BATCH),)}
TP_LR = 1e-3  # JAX's tp and pipeline tests' lr, which their params rules assume
TP_FLIP = 2 * 10 * TP_LR  # one step's params ceiling: a flipped sign's move
TP_CLI_ARGS = ("-s", "0.25", "-b", "4", "--epochs", "1", "--validation", "20",
               "--val-per-epoch", "1", "--data-parallel", "--tensor-parallel", "2",
               "--device", "cuda:0", "--save-optimizer")
PP_CASES = ((2, True), (4, False))  # (S, bilinear), as JAX's tests/test_pipeline.py
PP_M = 4
PP_REPS = 3
PP_HOST_REPS = 2
TP_BUDGET_S = 120.0
# 14a's 1 x 1 x 2 flagship fp32 ranks stay below one process's peak before
# the cuDNN engine rule ("final20": 17.501 GiB; the ranks had 38.818 and
# 14.419).
TP_PEAK_GIB = 17.501


def _tp_tags(world: int) -> list[str]:
    return [_sp_tag(model, amp) for model, amp, _ in TP_CASES[world]]


def _mb(*trees) -> float:
    from tpu_unet_torch.parallel.zero import state_bytes

    return sum(state_bytes(t) for t in trees) / 1e6


def _tp_references(workdir: Path, out: dict) -> None:
    """14a's one-process steps (``TP_CASES[2]``, which hold ``TP_CASES[4]``'s
    too), in this process: loss, grad norm, BN state, params, clipped
    gradients and each gradient's relative L2 distance from the float64
    step's to ``tp_ref<i>.pt``, each model's float64 gradients to
    ``tp_g64_<model>.pt``; the peak and the params + optimizer-state MB
    into ``out``."""
    from tpu_unet_torch.models.unet import tree_leaves
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    g64: dict = {}
    for i, (model, amp, batch) in enumerate(TP_CASES[2]):
        config, params, state, images, masks = _sp_case(model, batch, "cuda")
        if model not in g64:
            o64 = _float64_step(config, params, state, images.cuda(), masks.cuda())
            # fp32 copies: _rel_l2 takes the distance in fp32, 1e-3 of the floors
            g64[model] = {"gnorm": o64[4].item(),
                          "grads": [t.float().cpu() for t in tree_leaves(o64[5])]}
            torch.save(g64[model], workdir / f"tp_g64_{model}.pt")
            del o64
            torch.cuda.empty_cache()
        opt = rmsprop_init(params)
        o, peak, top = _sp_step(make_train_step(config, amp=amp, return_grads=True),
                                (params, state, opt), images.cuda(), masks.cuda(), TP_LR)
        torch.save({"loss": o[3].item(), "gnorm": o[4].item(),
                    "bn": [t.cpu() for t in tree_leaves(o[1])],
                    "params": [t.cpu() for t in tree_leaves(o[0])],
                    "grads": [t.cpu() for t in tree_leaves(o[5])],
                    "e_one": [_rel_l2(a, b.to(a.device))
                              for a, b in zip(tree_leaves(o[5]), g64[model]["grads"])]},
                   workdir / f"tp_ref{i}.pt")
        out["ref"][_sp_tag(model, amp)] = {"peak_gib": peak, "top_op": top,
                                           "mb": _mb(params, opt)}
        del config, params, state, images, masks, opt, o
        gc.collect()  # free what reference cycles still hold before the grid's peaks
        torch.cuda.empty_cache()


def _tp_compare(params, bn, grads, loss: float, gnorm: float, ref: dict, g64: dict,
                element_rule: bool, amp: bool) -> dict:
    """A grid step's gathered outputs against the one-process step's: loss
    within 5e-4 relative (bf16 2e-2) and BN state within 2e-2 (bf16 5e-3),
    JAX's ``test_tp_train_steps_match_single_device``; the grad norm by
    ``STEP_TOL``, or at most ``GRAD_RATIO`` times as far from the float64
    step's as the one-process step's (PR 17's rule); each clipped
    gradient's relative L2 distance from the float64 step's at most
    ``GRAD_RATIO`` times the one-process
    step's plus ``STEP_TOL``'s floor (phase 11b's rule; ``grads_over``
    names those past it); with ``element_rule``, every element within 1e-6
    + 1e-3 of the one-process step's magnitude (``grads_excess`` <= 0); no
    param off by more than one flipped sign's move (``TP_FLIP``)."""
    from tpu_unet_torch.models.unet import tree_leaves

    tol = STEP_TOL["bf16" if amp else "fp32"]
    rec = {"loss": abs(loss - ref["loss"]) / abs(ref["loss"]),
           "grad_norm": abs(gnorm - ref["gnorm"]) / abs(ref["gnorm"]),
           "params_max": 0.0, "grads_excess": -np.inf, "grads_off": 0,
           "bn_abs": max((a.float().cpu() - b).abs().max().item()
                         for a, b in zip(tree_leaves(bn), ref["bn"]))}
    for a, b in zip(tree_leaves(params), ref["params"]):
        rec["params_max"] = max(rec["params_max"],
                                (a.float() - b.to(a.device).float()).abs().max().item())
    names = list(_leaves(grads))
    e_grid, ratio = {}, {}
    for k, (a, b, b64, e_one) in enumerate(zip(tree_leaves(grads), ref["grads"],
                                                g64["grads"], ref["e_one"])):
        b = b.to(a.device).float()
        over = (a.float() - b).abs() - 1e-6 - 1e-3 * b.abs()
        rec["grads_excess"] = max(rec["grads_excess"], over.max().item())
        rec["grads_off"] += int((over > 0).sum())
        e_grid[names[k]] = _rel_l2(a, b64.to(a.device))
        ratio[names[k]] = e_grid[names[k]] / (GRAD_RATIO * e_one + tol["grad_floor"])
    rec.update(grads_f64=max(e_grid.values()), grads_f64_worst=_worst(e_grid),
               grads_one_f64=max(ref["e_one"]), grads_nearest=_worst(ratio),
               grads_over=[k for k, r in ratio.items() if not r <= 1])
    gn64 = g64["gnorm"]
    rec["grad_norm_f64"] = [abs(gnorm - gn64) / gn64, abs(ref["gnorm"] - gn64) / gn64]
    norm_ok = (rec["grad_norm"] <= tol["grad_norm"]
               or rec["grad_norm_f64"][0] <= GRAD_RATIO * rec["grad_norm_f64"][1] + 1e-6)
    rec["ok"] = (rec["loss"] <= (2e-2 if amp else 5e-4) and norm_ok
                 and rec["bn_abs"] <= (5e-3 if amp else 2e-2) and rec["params_max"] <= TP_FLIP
                 and not rec["grads_over"] and (not element_rule or rec["grads_excess"] <= 0))
    return rec


def _wait_for(path: Path, timeout: float = 600.0) -> None:
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout:.0f} s")
        time.sleep(0.05)


def _tp_rank(rank: int, world: int, spatial: int, model: int, coordinator: str,
             workdir: str, train_dir: str, go: str) -> None:
    """14a (and on the 1 x 1 x 2 grid 14c) on one rank of a (world / (S·T))
    x S x T grid sharing cuda:0 over gloo, once the file ``go`` exists (the
    process starts early, beside the work before it). Compares with the
    one-process steps in ``tp_ref<i>.pt``. Writes ``tp<world>_rank<r>.json``."""
    from datetime import timedelta

    from tpu_unet_torch.models.unet import tree_leaves
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.parallel.mesh import init_data_parallel, make_grid
    from tpu_unet_torch.parallel.tensor import (
        dims_in_order,
        gather_model,
        model_specs,
        shard_model,
        shard_opt_state,
    )
    from tpu_unet_torch.train import make_train_step

    workdir = Path(workdir)
    out: dict = {"rank": rank, "failures": [], "grid": {}}
    full_fp32()
    torch.zeros((), device="cuda:0")  # the CUDA context, while the work before this waits
    _wait_for(Path(go))
    dp = init_data_parallel(backend="gloo", device="cuda:0", init_method=f"tcp://{coordinator}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=600))
    try:
        t0 = time.perf_counter()
        grid = make_grid(dp, spatial, model)
        for i, (name, amp, batch) in enumerate(TP_CASES[world]):
            config, params, state, images, masks = _sp_case(name, batch, "cuda")
            opt = rmsprop_init(params)
            sp, ss = shard_model(grid, params, state)
            so = shard_opt_state(grid, opt, params)
            del params, state, opt
            torch.cuda.empty_cache()
            step = make_train_step(config, amp=amp, mesh=grid, return_grads=True)
            bands = (grid.bands(images).cuda(), grid.bands(masks).cuda())
            ts = time.perf_counter()
            o, peak, top = _sp_step(step, (sp, ss, so), *bands, TP_LR)
            wall = time.perf_counter() - ts
            dims = model_specs(config, model)[0]
            rep = [t for t, d in zip(tree_leaves(o[0]), dims_in_order(o[0], dims)) if d is None]
            rec = {"peak_gib": peak, "top_op": top, "mb": _mb(sp, so), "band": list(bands[0].shape),
                   "replicated_sha256": _digest(tuple(rep)), "step_s": wall}
            fp, fs, fg = gather_model(grid, o[0], o[1], config, o[5])
            if rank == 0:
                rec.update(_tp_compare(fp, fs, fg, o[3].item(), o[4].item(),
                                       torch.load(workdir / f"tp_ref{i}.pt"),
                                       torch.load(workdir / f"tp_g64_{name}.pt"),
                                       name == "unet" and not amp, amp))
            out["grid"][_sp_tag(name, amp)] = rec
            del config, sp, ss, so, step, o, bands, fp, fs, fg
            gc.collect()
            torch.cuda.empty_cache()
        out["steps_s"] = time.perf_counter() - t0
        if world == TP_GRIDS[0][0]:
            # 14c: the train CLI on the 1 x 1 x 2 grid, joining this group (gloo).
            from tpu_unet_torch import train_cli

            t0 = time.perf_counter()
            ck = workdir / "ck_tensor"
            hist = train_cli.main([*TP_CLI_ARGS, "--data-dir", str(Path(train_dir) / "data"),
                                   "--load", str(Path(train_dir) / "init.npz"),
                                   "--checkpoint-dir", str(ck)])[2]
            out["cli"] = {"history": hist, "wall_s": time.perf_counter() - t0,
                          "written": sorted(f.name for f in ck.glob("*.npz"))
                          if ck.exists() else []}
            if rank == 0 and (ck / "checkpoint_epoch1.npz").exists():
                with np.load(ck / "checkpoint_epoch1.npz") as z:
                    out["cli"]["shapes"] = {k: list(z[k].shape) for k in
                                            ("params/down2/conv1/w", "opt/square_avg/down2/conv1/w",
                                             "state/down2/bn1/mean")}
    except Exception:
        out["failures"].append(f"rank {rank} of {world}: {traceback.format_exc()}")
    finally:
        (workdir / f"tp{world}_rank{rank}.json").write_text(json.dumps(out))
        torch.distributed.destroy_process_group()


def _pp_tree_bitwise(got, held: list) -> bool:
    """``got`` (a gathered tree) bitwise the stages' trees ``held``, leaf for
    leaf in the U-Net's order."""
    from tpu_unet_torch.models.unet import tree_leaves

    return all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 [t for h in held for t in tree_leaves(h)]))


def _host_ms_autograd(fn) -> list[float]:
    """Host-clock ms of ``PP_HOST_REPS`` synchronised calls of ``fn`` (which
    runs autograd; the caller has run it once)."""
    times = []
    for _ in range(PP_HOST_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def _pp_params_rule(got, want, atol: float) -> dict:
    """tests/test_pipeline.py's params rule as the port's CPU test holds it:
    no element past one flipped sign's move (2·10·lr) or ``atol``, at most
    0.05% of a leaf (or 3) past ``atol``."""
    from tpu_unet_torch.models.unet import tree_leaves

    worst, off = 0.0, 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        d = (a.float() - b.float()).abs()
        worst = max(worst, d.max().item())
        n = int((d > atol).sum())
        off = max(off, 0 if n <= max(3, 5e-4 * d.numel()) else n)
    return {"params_max": worst, "params_off": off,
            "params_ok": worst <= max(atol, 2 * 10 * TP_LR) and off == 0}


def _pp_compare(runner, o, loss, gnorm, amp: bool) -> dict:
    """One pipeline step against ``make_train_step(accum_steps=M)``'s outputs
    ``o`` by JAX's tolerances (``tests/test_pipeline.py``): fp32 loss 1e-5
    relative, grad norm 1e-4, gradients 1e-6 + 1e-3 relative, BN state
    1e-5 + 1e-3, params 1e-4 (the rule above); bf16 loss 2e-2, gradients
    5e-2, BN 5e-3 + 5e-2, params 5e-2."""
    from tpu_unet_torch.models.unet import tree_leaves

    params, state, _ = runner.gather()
    grads = runner.gather_grads()
    g_atol, g_rtol, s_atol, s_rtol, p_atol = ((5e-2, 0.0, 5e-3, 5e-2, 5e-2) if amp
                                              else (1e-6, 1e-3, 1e-5, 1e-3, 1e-4))

    def excess(a_tree, b_tree, atol, rtol):
        return max(((a.float() - b.float()).abs() - atol - rtol * b.float().abs()).max().item()
                   for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))

    rec = {"loss": abs(loss - o[3].item()) / abs(o[3].item()),
           "grad_norm": abs(gnorm - o[4].item()) / abs(o[4].item()),
           "grads_excess": excess(grads, o[5], g_atol, g_rtol),
           "bn_excess": excess(state, o[1], s_atol, s_rtol),
           **_pp_params_rule(params, o[0], p_atol)}
    rec["ok"] = (rec["loss"] <= (2e-2 if amp else 1e-5)
                 and (amp or rec["grad_norm"] <= 1e-4)
                 and rec["grads_excess"] <= 0 and rec["bn_excess"] <= 0 and rec["params_ok"])
    return rec


def _pp_segment_ms(config, params, state, amp: bool) -> dict[str, float]:
    """Each segment's forward + backward at one microbatch (one 959x640
    image), CUDA events, median of ``PP_REPS``: a 10-stage runner on
    cuda:0, each stage one segment, its input payload from one forward
    wave."""
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.parallel.pipeline import SEGMENT_NAMES, PipelineRunner, _put

    runner = PipelineRunner(params, state, config, n_stages=10, microbatches=1, amp=amp,
                            devices=["cuda:0"] * 10)
    imgs, masks = synth_batch(np.random.default_rng(1), 1, *PARITY_BATCH[1:])
    payloads, pl = [], {"x": torch.from_numpy(imgs).cuda()}
    with torch.no_grad():
        for s in range(9):
            payloads.append(pl)
            pl, _ = runner._forward(s, runner.params[s], pl)
    payloads.append(pl)
    _, cots, _, _ = runner._backward(9, payloads[9], masks=torch.from_numpy(masks).cuda())
    cot_in = [None] * 10
    cot_in[8] = cots
    for s in range(8, -1, -1):
        _, c, _, _ = runner._backward(s, payloads[s], cot_in[s])
        if s:
            cot_in[s - 1] = c
    out = {}
    for s, name in enumerate(SEGMENT_NAMES):
        def run(s=s):
            if s == 9:
                runner._backward(9, payloads[9], masks=torch.from_numpy(masks).cuda())
            else:
                runner._backward(s, payloads[s], _put(cot_in[s], "cuda:0"))
        out[name] = time_ms(run, reps=PP_REPS)
    return out


def _pp_parity(out: dict, failures: list) -> list:
    """14b's parity (module docstring), in this process. Returns each case's
    (tag, runner, accumulated step, its trees) for ``_pp_timing``."""
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.parallel.pipeline import PipelineRunner
    from tpu_unet_torch.train import make_train_step

    imgs, msks = synth_batch(np.random.default_rng(1), *PARITY_BATCH)
    images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
    held = []
    for n_stages, bilinear in PP_CASES:
        config = UNetConfig(**{**TRAIN_CONFIG, "bilinear": bilinear})
        for amp in (False, True):
            tag = f"S={n_stages} {'bilinear' if bilinear else 'convt'} {'bf16' if amp else 'fp32'}"
            params, state = init_unet(config, np.random.default_rng(0), device="cuda")
            with Deterministic():
                runner = PipelineRunner(params, state, config, n_stages=n_stages,
                                        microbatches=PP_M, amp=amp,
                                        devices=["cuda:0"] * n_stages)
                runner.keep_grads = True
                loss, gnorm = runner.step(images, masks, TP_LR)
                acc = make_train_step(config, amp=amp, accum_steps=PP_M, return_grads=True)
                o = acc(params, state, rmsprop_init(params), images, masks, TP_LR)
                rec = _pp_compare(runner, o, loss.item(), gnorm.item(), amp)
            runner.keep_grads = False
            p, st, opt = runner.gather()
            rec["gather_bitwise"] = (_pp_tree_bitwise(p, runner.params)
                                     and _pp_tree_bitwise(st, runner.state)
                                     and _pp_tree_bitwise(opt.square_avg,
                                                          [o.square_avg for o in runner.opt])
                                     and _pp_tree_bitwise(opt.momentum_buf,
                                                          [o.momentum_buf for o in runner.opt]))
            rec["stages"] = [f"{seg[0]}..{seg[-1]}" if len(seg) > 1 else seg[0]
                             for seg in runner.stages]
            rec["stage_mb"] = [_mb(runner.params[s], runner.state[s], runner.opt[s])
                               for s in range(n_stages)]
            rec["whole_mb"] = _mb(p, st, opt)
            out[tag] = rec
            if not (rec["ok"] and rec["gather_bitwise"]):
                failures.append(f"14b {tag}: {rec}")
            held.append((tag, runner, acc, o[:3]))
            del p, st, opt, o, params, state
            torch.cuda.empty_cache()
    return held


def _pp_timing(out: dict, held: list) -> None:
    """14b's timings, with the card to itself: a later step of each runner
    and of its accumulated step on the host clock (the stages share one
    card: a record, not a claim), and the segments' times."""
    from tpu_unet_torch.data import synth_batch
    from tpu_unet_torch.models import UNetConfig, init_unet

    imgs, msks = synth_batch(np.random.default_rng(1), *PARITY_BATCH)
    images, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(msks).cuda()
    for tag, runner, acc, trees in held:
        out[tag]["pp_host_ms"] = _host_ms_autograd(
            lambda: runner.step(images, masks, TP_LR))
        out[tag]["acc_host_ms"] = _host_ms_autograd(
            lambda: acc(*trees, images, masks, TP_LR))
    held.clear()
    torch.cuda.empty_cache()
    config = UNetConfig(**TRAIN_CONFIG)
    params, state = init_unet(config, np.random.default_rng(0), device="cuda")
    out["segment_ms"] = {dt: _pp_segment_ms(config, params, state, dt == "bf16")
                         for dt in ("fp32", "bf16")}


def phase_tensor_pipeline(workdir: Path, train_dir: Path, card: str) -> dict:
    """Phase 14 (module docstring). Returns its numbers. Both grids' rank
    processes start at once and wait: the 1 x 1 x 2 grid's for the
    one-process references, the 1 x 2 x 2 grid's for the first grid's end;
    14b's parity runs beside the second grid, its timings after it."""
    workdir.mkdir(parents=True, exist_ok=True)
    failures: list = []
    ctx = mp.get_context("spawn")
    worlds = []
    gos = [workdir / "refs.done", workdir / "grid1.done"]
    for (world, spatial, model), go in zip(TP_GRIDS, gos):
        coordinator = f"127.0.0.1:{_free_port()}"
        procs = [ctx.Process(target=_tp_rank, args=(r, world, spatial, model, coordinator,
                                                    str(workdir), str(train_dir), str(go)))
                 for r in range(world)]
        for p in procs:
            p.start()
        worlds.append(procs)
    t0 = time.perf_counter()
    refs: dict = {"ref": {}}
    try:
        _tp_references(workdir, refs)
    except Exception:
        failures.append(f"14a references: {traceback.format_exc()}")
    log(f"14a one-process references in {time.perf_counter() - t0:.1f} s")
    gos[0].write_text("")
    pp: dict = {}
    held: list = []
    grids = {}
    for k, ((world, spatial, model), procs) in enumerate(zip(TP_GRIDS, worlds)):
        t0 = time.perf_counter()
        if k == 1:
            try:  # 14b's parity beside the second grid's ranks
                held = _pp_parity(pp, failures)
            except Exception:
                failures.append(f"14b: {traceback.format_exc()}")
        deadline = time.monotonic() + 300
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
                failures.append(f"14: rank process {p.pid} still running after 300 s: killed")
        if k == 0:
            gos[1].write_text("")
        shape = f"{world // (spatial * model)}x{spatial}x{model}"
        log(f"14 {shape} grid: {world} rank processes in {time.perf_counter() - t0:.1f} s "
            f"after their start signal, exit codes {[p.exitcode for p in procs]}")
        ranks = []
        for r in range(world):
            path = workdir / f"tp{world}_rank{r}.json"
            if not path.exists():
                failures.append(f"14 {shape}: rank {r} wrote no result")
                continue
            ranks.append(json.loads(path.read_text()))
            failures += ranks[-1]["failures"]
        if len(ranks) == world and all(len(rk["grid"]) == len(TP_CASES[world]) for rk in ranks):
            grids[shape] = ranks
    if len(grids) == len(TP_GRIDS) and len(refs["ref"]) == len(TP_CASES[2]):
        ref = refs["ref"]
        for shape, ranks in grids.items():
            for (model, amp, batch), tag in zip(TP_CASES[len(ranks)], _tp_tags(len(ranks))):
                rec, one = ranks[0]["grid"][tag], ref[tag]
                same = len({rk["grid"][tag]["replicated_sha256"] for rk in ranks}) == 1
                peaks = [rk["grid"][tag]["peak_gib"] for rk in ranks]
                mbs = [rk["grid"][tag]["mb"] for rk in ranks]
                tops = "; ".join(f"rank {rk['rank']} {_top(rk['grid'][tag]['top_op'])}"
                                 for rk in ranks)
                log(f"14a {shape} grid, {tag}, global batch {list(batch)}, {rec['band']} a rank, "
                    f"vs the one-process step: loss rel err {rec['loss']:.3e}, grad norm rel "
                    f"err {rec['grad_norm']:.3e} (from float64: grid {rec['grad_norm_f64'][0]:.3e},"
                    f" one process {rec['grad_norm_f64'][1]:.3e}); gradients rel L2 to float64 max "
                    f"{rec['grads_f64']:.3e} ({rec['grads_f64_worst']}) vs the one-process "
                    f"step's {rec['grads_one_f64']:.3e}, per tensor tol <= {GRAD_RATIO:g} x "
                    f"its + {STEP_TOL['bf16' if amp else 'fp32']['grad_floor']:g}, "
                    f"{len(rec['grads_over'])} over, nearest {rec['grads_nearest']} of the "
                    f"bound; largest excess over 1e-6 + 1e-3 rel of the one-process "
                    f"gradients {rec['grads_excess']:.3e} ({rec['grads_off']} elements past "
                    f"it{', held' if model == 'unet' and not amp else ', a record'}); params "
                    f"max {rec['params_max']:.3e} (ceiling {TP_FLIP:g}), BN max abs "
                    f"{rec['bn_abs']:.3e} ({'bf16' if amp else 'fp32'} rule, _tp_compare); "
                    f"ok={rec['ok']}; replicated leaves bitwise "
                    f"on every rank={same}; params + RMSprop state a rank "
                    f"{' '.join(f'{m:.1f}' for m in mbs)} MB vs one process {one['mb']:.1f} MB "
                    f"(ratio {max(mbs) / one['mb']:.3f}); peak a rank "
                    f"{' '.join(f'{g:.3f}' for g in peaks)} GiB vs one process "
                    f"{one['peak_gib']:.3f} GiB ({card}); the largest conv transient: {tops}, "
                    f"one process {_top(one['top_op'])}; rank 0's step {rec['step_s']:.2f} s "
                    "(host clock, ranks share the card)")
                if not rec["ok"]:
                    failures.append(f"14a {shape} {tag}: off the one-process step: {rec}")
                if not same:
                    failures.append(f"14a {shape} {tag}: the replicated leaves differ")
                failures += _rank_memory(f"14a {shape} {tag}", ranks, tag, ref)
                if (shape, tag) == ("1x1x2", "unet fp32") and not max(peaks) < TP_PEAK_GIB:
                    failures.append(f"14a {shape} {tag}: a rank's peak {max(peaks):.3f} GiB is "
                                    f"not below {TP_PEAK_GIB} GiB, one process's before the "
                                    "cuDNN engine rule")
        cli = grids["1x1x2"][0].get("cli")
        if cli is None:
            failures.append("14c: no tensor-parallel train CLI result")
        else:
            h = cli["history"]
            log(f"14c train_cli {' '.join(TP_CLI_ARGS)} on phase 6's pairs (1x1x2 grid, gloo): "
                f"losses {h['train_loss']} val Dice {h['val_dice']}, wrote {cli['written']}, "
                f"whole shapes {cli.get('shapes')}, {cli['wall_s']:.1f} s")
            if not ("checkpoint_epoch1.npz" in cli["written"] and h["train_loss"]
                    and all(np.isfinite(h["train_loss"])) and len(h["val_dice"]) == 1
                    and cli.get("shapes", {}).get("params/down2/conv1/w") == [3, 3, 128, 256]
                    and cli["shapes"].get("opt/square_avg/down2/conv1/w") == [3, 3, 128, 256]):
                failures.append(f"14c: the tensor-parallel train CLI run {cli}")
    t0 = time.perf_counter()
    try:
        _pp_timing(pp, held)
    except Exception:
        failures.append(f"14b timing: {traceback.format_exc()}")
    del held
    for tag, rec in pp.items():
        if tag == "segment_ms":
            continue
        log(f"14b PipelineRunner {tag}, M={PP_M}, {list(PARITY_BATCH)}, stages {rec['stages']} "
            f"on cuda:0, vs make_train_step(accum_steps={PP_M}): loss rel err {rec['loss']:.3e}, "
            f"grad norm {rec['grad_norm']:.3e}, gradients' excess over tol "
            f"{rec['grads_excess']:.3e}, BN's {rec['bn_excess']:.3e}, params max "
            f"{rec['params_max']:.3e} (leaves off {rec['params_off']}) (tol: JAX's "
            f"tests/test_pipeline.py); ok={rec['ok']}; gather bitwise={rec['gather_bitwise']}; "
            f"params + BN + RMSprop MB a stage {[round(m, 1) for m in rec['stage_mb']]} of "
            f"{rec['whole_mb']:.1f}; a later step's host ms pipeline "
            f"{statistics.median(rec.get('pp_host_ms', [float('nan')])):.1f} vs accumulated "
            f"{statistics.median(rec.get('acc_host_ms', [float('nan')])):.1f} ({card}; stages "
            "share the card)")
    if "segment_ms" in pp:
        for dt, ms in pp["segment_ms"].items():
            log(f"14b segment fwd+bwd ms at one 959x640 image, {dt} ({card}): "
                + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    # 14c: the pipeline CLI on one card meets JAX's device refusal.
    from tpu_unet_torch import train_cli

    try:
        train_cli.main(["--pipeline-parallel", "2", "--data-dir", str(train_dir / "data"),
                        "--checkpoint-dir", str(workdir / "ck_pipeline")])
        failures.append("14c: train_cli --pipeline-parallel 2 trained on one card")
    except SystemExit as e:
        want = f"pipeline needs 2 devices, have {torch.cuda.device_count()}"
        log(f"14c train_cli --pipeline-parallel 2 on {torch.cuda.device_count()} card: {e}")
        if want not in str(e):
            failures.append(f"14c: the pipeline CLI's refusal {e!r}, not {want!r}")
    log(f"14b timings and 14c's refusal: {time.perf_counter() - t0:.1f} s")
    if failures:
        raise SystemExit(f"chip_smoke: tensor / pipeline parallelism checks failed: {failures}")
    return {"grids": {shape: [rk["grid"] for rk in ranks] for shape, ranks in grids.items()},
            "ref": refs["ref"], "pipeline": pp}

# Phase 15: the deployment surface, in at most DEPLOY_BUDGET_S, on phase 3's
# checkpoint, phase 6's images and a second full-width model with the
# Carvana U-Net's two classes (hub.unet_carvana's config).
DEPLOY_BUDGET_S = 120.0
DEPLOY_HW = (640, 959)  # 1918x1280 at scale 0.5: the artifacts' static input
DEPLOY_IMAGES = 8
DEPLOY_BATCH = 4
DEPLOY_TTA_MODE = "hflip"
# The .pt2 programs, exported by the CLI in parallel processes while the
# checkpoint sub-phases run: name -> flags.
DEPLOY_EXPORTS = {"bf16": [], "bf16_tta_hflip": ["--tta", "--tta-mode", DEPLOY_TTA_MODE],
                  "fp32": ["--no-amp", "--check"]}
# A fresh process's reload of a .pt2 against the live folded forward (the
# same ATen ops on the same card): export.CHECK_ATOL. The fp32 .pt2 served
# at its static shape beside the checkpoint's unfolded fp32 eval forward:
# BATCH_AGREEMENT, phase 7's bound for two fp32 forwards that differ in
# rounding (in bf16 BN folded and unfolded round differently at each of
# the 23 convs: 96.8-97.2% agreement on an H100, 700 W, at 1918x1280).
# dryrun_multichip(1) on the card: NCCL, the extended tier within this budget.
DRYRUN_CARD_BUDGET_S = 30.0


def _deploy_reload(art_dir: str, ckpt: str, out: str) -> None:
    """Run in a fresh process: the bf16 .pt2 programs of ``art_dir`` loaded on
    cuda (seconds each) against the live folded forward
    (``export.folded_forward``) at batch 1 and 4 of seeded inputs; the
    symbolic one loaded on the CPU too. Writes the numbers to ``out``."""
    from tpu_unet_torch.export import folded_forward, load_exported, program_shapes
    from tpu_unet_torch.models import UNetConfig
    from tpu_unet_torch.predict import load_model

    full_fp32()
    params, state, config, _ = load_model(ckpt, UNetConfig(), torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((4, *DEPLOY_HW, 3), generator=gen, device="cuda")
    res = {}
    for name in ("bf16", "bf16_tta_hflip"):
        t0 = time.perf_counter()
        ep = load_exported(Path(art_dir) / f"{name}.pt2", "cuda")
        fwd = ep.module()
        load_s = time.perf_counter() - t0
        live = folded_forward(params, state, config, tta="tta" in name, tta_mode=DEPLOY_TTA_MODE,
                              device="cuda")
        with torch.inference_mode():
            errs = {str(b): (fwd(x[:b]) - live(x[:b])).abs().max().item() for b in (1, 4)}
        res[name] = {"shapes": list(program_shapes(ep)), "load_s": round(load_s, 3),
                     "max_abs_err": errs,
                     "devices": sorted({str(t.device) for t in ep.constants.values()})}
    t0 = time.perf_counter()
    ep = load_exported(Path(art_dir) / "bf16.pt2", "cpu")
    res["cpu"] = {"load_s": round(time.perf_counter() - t0, 3),
                  "shapes": list(program_shapes(ep)),
                  "devices": sorted({str(t.device) for t in ep.constants.values()})}
    Path(out).write_text(json.dumps(res))


def _run_logged(cmd: list[str], timeout: float) -> dict:
    """Run ``cmd`` from the repository root: its exit code, wall s and the end
    of its output."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    return {"rc": proc.returncode, "wall_s": round(time.perf_counter() - t0, 2),
            "log": (proc.stdout + proc.stderr)[-4000:]}


def _serve_in_thread(argv: list[str]):
    from tpu_unet_torch import serve

    server, served = serve.make_server(["--port", "0", *argv])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def close():
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        for pr in (served.values() if isinstance(served, dict) else [served]):
            pr.stop()

    return server.server_address[1], served, close


def phase_deploy(workdir: Path, ckpt: Path, image_dir: Path, card: str
                 ) -> tuple[dict[str, int], dict]:
    """Phase 15. Returns the forward kernels' launches in 15b's --kernels cuda
    multi-model server and the phase's numbers."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_unet_torch import export, hub
    from tpu_unet_torch.checkpoint import flatten, load_checkpoint, save_checkpoint
    from tpu_unet_torch.data import preprocess
    from tpu_unet_torch.dryrun import dryrun_multichip, entry
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.models.unet import tree_leaves
    from tpu_unet_torch.predict import load_model, mask_to_image, predict_img
    from tpu_unet_torch.submit import rle_decode, submit

    failures: list[str] = []
    numbers: dict = {"card": card}

    def done(name: str, t0: float) -> None:
        numbers[f"{name}_s"] = round(time.perf_counter() - t0, 2)
        log(f"phase {name}: {numbers[f'{name}_s']:.1f} s")

    def attempt(what: str, fn):
        try:
            return fn()
        except (SystemExit, Exception) as e:  # noqa: BLE001 - every sub-phase reports
            failures.append(f"{what}: {type(e).__name__}: {e}")
            log(f"{what} failed:\n{traceback.format_exc()}")
            return None

    # Setup: 8 of phase 6's 1918x1280 images; the two-class model, its BN
    # state calibrated on one of them.
    t0 = time.perf_counter()
    img_dir = workdir / "imgs"
    img_dir.mkdir(parents=True)
    for src in sorted(image_dir.glob("*.png"))[:DEPLOY_IMAGES]:
        (img_dir / src.name).symlink_to(src.resolve())
    paths = sorted(img_dir.glob("*.png"))
    bodies = [p.read_bytes() for p in paths]
    carvana = UNetConfig(n_channels=3, n_classes=2, bilinear=False)
    p2, s2 = init_unet(carvana, np.random.default_rng(1), device="cuda")
    with torch.inference_mode():
        s2 = calibrate_bn(p2, s2, carvana, torch.from_numpy(
            preprocess(Image.open(paths[0]), 0.5))[None].cuda())
    ckpt2 = workdir / "carvana2.npz"
    save_checkpoint(ckpt2, p2, s2, [0, 1], {"config": carvana._asdict()})
    del p2, s2
    done("15_setup", t0)

    # 15a, in the background: the export CLI, one process a program; then a
    # fresh process reloads the bf16 ones and loads one on the CPU.
    t_export = time.perf_counter()
    art = workdir / "art"
    art.mkdir()
    size = ["--height", str(DEPLOY_HW[0]), "--width", str(DEPLOY_HW[1])]
    pool = ThreadPoolExecutor(max_workers=len(DEPLOY_EXPORTS) + 1)
    export_runs = {name: pool.submit(_run_logged, [
        sys.executable, "-m", "tpu_unet_torch.export", "-m", str(ckpt), "-o",
        str(art / f"{name}.pt2"), *size, *flags], 300) for name, flags in DEPLOY_EXPORTS.items()}
    reload_json = workdir / "reload.json"

    def reload_after_exports() -> dict:
        for f in export_runs.values():
            f.result()
        return _run_logged([sys.executable, "-c", f"import chip_smoke as c; c._deploy_reload("
                            f"{str(art)!r}, {str(ckpt)!r}, {str(reload_json)!r})"], 300)

    reload_run = pool.submit(reload_after_exports)
    attempt("15a export carvana .pth", lambda: export.main(
        ["-m", str(ckpt2), "-o", str(art / "carvana.pth"), "--check"]))

    # 15b (1): two checkpoints behind one --kernels cuda server.
    t0 = time.perf_counter()
    launches: dict[str, int] = {}

    def server_1():
        port, preds, close = _serve_in_thread(
            ["-m", f"unet1={ckpt}", "-m", f"carvana2={ckpt2}", "--kernels", "cuda",
             "--mask-values", "0,255"])
        try:
            K.reset_launch_counts()
            got = {name: [post(port, b, f"/predict/{name}") for b in bodies[:2]] for name in preds}
            launches.update(K.launch_counts())
            health, metrics = get_json(port, "/healthz"), get_json(port, "/metrics")
            status, body, _ = post(port, b"x", "/predict/nope")
        finally:
            close()
        log(f"15b server 1 healthz: {json.dumps(health)}")
        log(f"15b server 1 metrics: {json.dumps(metrics)}")
        n_req = sum(len(v) for v in got.values())
        if status != 404 or b"unknown model 'nope'" not in body:
            failures.append(f"15b: an unknown model answered {status}")
        if set(health.get("models", {})) != {"unet1", "carvana2"} or health["default"] != "unet1":
            failures.append(f"15b: healthz {health}")
        elif [health["models"][n]["n_classes"] for n in ("unet1", "carvana2")] != [1, 2]:
            failures.append(f"15b: healthz classes {health}")
        if any(metrics.get(n, {}).get("requests") != 2 or metrics[n]["errors"] for n in got):
            failures.append(f"15b: metrics {metrics}")
        dispatches = sum(metrics[n].get("dispatches", 0) for n in got)
        log(f"15b launches in {n_req} routed requests ({dispatches} dispatches): "
            f"{json.dumps(launches)}; per request "
            + json.dumps({k: launches.get(k, 0) / n_req for k in PER_FORWARD})
            + f" (phase 3's per forward: {json.dumps(PER_FORWARD)})")
        for name, per in {**PER_FORWARD, **TC_PER_FORWARD}.items():
            if launches.get(name, 0) != per * dispatches or not dispatches:
                failures.append(f"15b {name}: {launches.get(name, 0)} launches, expected "
                                f"{per} x {dispatches}")
        for name, path in (("unet1", ckpt), ("carvana2", ckpt2)):
            _, solo, close1 = _serve_in_thread(["-m", str(path), "--kernels", "cuda",
                                                "--mask-values", "0,255"])
            try:
                for k, (status, data, secs) in enumerate(got[name]):
                    want = np.asarray(mask_to_image(solo.predict_one(
                        Image.open(io.BytesIO(bodies[k]))), [0, 255]))
                    mask = np.asarray(Image.open(io.BytesIO(data))) if status == 200 else None
                    same = mask is not None and np.array_equal(mask, want)
                    fg = "-" if mask is None else f"{(mask > 0).mean():.4f}"
                    log(f"15b /predict/{name} image {k}: HTTP {status}, {secs * 1e3:.1f} ms, "
                        f"foreground {fg}, equal to the solo predictor's: {same}")
                    if not same:
                        failures.append(f"15b /predict/{name} image {k}: not the solo mask")
            finally:
                close1()

    attempt("15b server 1", server_1)
    numbers["serve_launches"] = launches
    done("15b_1", t0)

    # 15c: the RLE submission, each row the mask predict_img gives.
    t0 = time.perf_counter()

    def submission():
        params, state, config, _ = load_model(ckpt, UNetConfig(), torch.device("cuda"))
        rates = {}
        for tta in (False, True):
            csv = workdir / f"submission_tta{int(tta)}.csv"
            t = time.perf_counter()
            submit(ckpt, img_dir, csv, batch_size=DEPLOY_BATCH, tta=tta,
                   tta_mode=DEPLOY_TTA_MODE)
            secs = time.perf_counter() - t
            rates[f"tta_{DEPLOY_TTA_MODE}" if tta else "plain"] = round(DEPLOY_IMAGES / secs, 3)
            rows = csv.read_text().splitlines()
            if rows[0] != "img,rle_mask" or len(rows) != 1 + DEPLOY_IMAGES:
                failures.append(f"15c: {len(rows)} rows")
                continue
            for row in rows[1:]:
                name, rle = row.split(",")
                img = Image.open(img_dir / name)
                want = predict_img(params, state, config, img, scale_factor=0.5, amp=False,
                                   tta=tta, tta_mode=DEPLOY_TTA_MODE)
                got = rle_decode(rle, (img.height, img.width))
                if not np.array_equal(got, want.astype(np.uint8)):
                    failures.append(f"15c tta={tta} {name}: {int((got != want).sum())} pixels "
                                    "differ from predict_img")
        numbers["submit_img_s"] = rates
        log(f"15c submit (fp32, {DEPLOY_IMAGES} images of 1918x1280, batch {DEPLOY_BATCH}, "
            f"PNG decode and resize included, beside 15a's export processes): img/s "
            f"{json.dumps(rates)} ({card})")

    attempt("15c submit", submission)
    done("15c", t0)

    # 15d: the hub entries on 15a's .pth.
    t0 = time.perf_counter()

    def hub_entries():
        want = flatten(*load_checkpoint(ckpt2, carvana, "cuda")[:2])
        pth = str(art / "carvana.pth")
        for how, load in (
                ("hub.unet_carvana", lambda: hub.unet_carvana(pretrained=True, weights_path=pth)),
                ("torch.hub.load", lambda: torch.hub.load(
                    str(ROOT / "tpu_unet_torch"), "unet_carvana", source="local",
                    pretrained=True, weights_path=pth))):
            p, s, cfg, mv = load()
            got = flatten(p, s)
            same = got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
            devices = sorted({str(t.device) for t in tree_leaves((p, s))})
            log(f"15d {how}: config {cfg}, palette {mv}, {len(got)} leaves on {devices}, "
                f"bitwise the checkpoint's: {same}")
            if not same or devices != ["cuda:0"] or cfg != carvana:
                failures.append(f"15d {how}: same={same} devices={devices} config={cfg}")

    attempt("15d hub", hub_entries)
    done("15d", t0)

    # 15e: entry() on the card; dryrun_multichip(2), core only (gloo ranks on
    # the CPU: one GPU), and dryrun_multichip(1) on the card (NCCL).
    t0 = time.perf_counter()

    def dry_runs():
        fn, args = entry()
        out = fn(*args)
        log(f"15e entry(): logits {tuple(out.shape)} on {out.device}, finite "
            f"{bool(torch.isfinite(out).all())}")
        if tuple(out.shape) != (1, 64, 64, 2) or out.device.type != "cuda":
            failures.append(f"15e entry: {tuple(out.shape)} on {out.device}")
        old = os.environ.get("TPU_UNET_DRYRUN_BUDGET_S")
        try:
            for n, budget in ((2, 0.0), (1, DRYRUN_CARD_BUDGET_S)):
                os.environ["TPU_UNET_DRYRUN_BUDGET_S"] = str(budget)
                t = time.perf_counter()
                dryrun_multichip(n)
                numbers[f"dryrun{n}_s"] = round(time.perf_counter() - t, 2)
                log(f"15e dryrun_multichip({n}) budget {budget:.0f} s: ok in "
                    f"{numbers[f'dryrun{n}_s']:.1f} s")
        finally:
            if old is None:
                os.environ.pop("TPU_UNET_DRYRUN_BUDGET_S", None)
            else:
                os.environ["TPU_UNET_DRYRUN_BUDGET_S"] = old

    attempt("15e dry run", dry_runs)
    done("15e", t0)

    # 15a's exports: each CLI process's wall and its own export seconds.
    t0 = time.perf_counter()
    exports = {}
    for name, fut in export_runs.items():
        run = fut.result()
        pt2 = art / f"{name}.pt2"
        m = re.search(r"in ([0-9.]+) s \(", run["log"])
        exports[name] = {"rc": run["rc"], "process_s": run["wall_s"],
                         "export_s": float(m.group(1)) if m else None,
                         "mb": round(pt2.stat().st_size / 1e6, 1) if pt2.exists() else None}
        if run["rc"] != 0:
            failures.append(f"15a export {name}: rc {run['rc']}: {run['log'][-1500:]}")
        if name == "fp32":
            check = re.search(r"Round-trip check OK \(max \|diff\| = ([0-9.e+-]+)\)", run["log"])
            exports[name]["check_max_abs_err"] = float(check.group(1)) if check else None
    numbers["export"] = exports
    log(f"15a exports (the CLI, one process each, beside 15b-15e; all done "
        f"{time.perf_counter() - t_export:.1f} s after their start): {json.dumps(exports)}")

    # 15b (2): the checkpoint beside the fp32 .pt2, on the default eval forward.
    def server_2():
        port, preds, close = _serve_in_thread(["-m", f"ckpt={ckpt}", "-m",
                                               f"art={art / 'fp32.pt2'}", "--no-amp"])
        try:
            art_pred = preds["art"]
            if art_pred.static_hw != DEPLOY_HW or art_pred.fixed_batch is not None:
                failures.append(f"15b artifact: static {art_pred.static_hw}, batch "
                                f"{art_pred.fixed_batch}")
            for k in range(2):
                res = {n: post(port, bodies[k], f"/predict/{n}") for n in ("ckpt", "art")}
                if any(r[0] != 200 for r in res.values()):
                    failures.append(f"15b server 2 image {k}: HTTP {[r[0] for r in res.values()]}")
                    continue
                a, b = (np.asarray(Image.open(io.BytesIO(res[n][1]))) for n in ("ckpt", "art"))
                agree = float((a == b).mean())
                log(f"15b server 2 image {k}: fp32 .pt2 vs checkpoint mask agreement "
                    f"{agree:.6f} (shapes {a.shape} {b.shape}), client ms ckpt "
                    f"{res['ckpt'][2] * 1e3:.1f} art {res['art'][2] * 1e3:.1f}")
                if a.shape != (1280, 1918) or b.shape != a.shape or agree < BATCH_AGREEMENT:
                    failures.append(f"15b server 2 image {k}: agreement {agree:.6f}")
            health, metrics = get_json(port, "/healthz"), get_json(port, "/metrics")
        finally:
            close()
        log(f"15b server 2 healthz: {json.dumps(health)}; metrics: {json.dumps(metrics)}")
        if set(metrics) != {"ckpt", "art"} or metrics["art"].get("requests") != 2:
            failures.append(f"15b server 2 metrics {metrics}")

    attempt("15b server 2", server_2)
    done("15b_2", t0)

    # 15a's reload in a fresh process, then each program's ms a call beside
    # the live folded forward's (batch 1, CUDA events, in turns).
    t0 = time.perf_counter()
    run = reload_run.result()
    pool.shutdown()
    numbers["reload_process_s"] = run["wall_s"]
    if run["rc"] != 0 or not reload_json.exists():
        failures.append(f"15a reload process: rc {run['rc']}: {run['log'][-2000:]}")
    else:
        reload = json.loads(reload_json.read_text())
        numbers["reload"] = reload
        log(f"15a reload in a fresh process ({run['wall_s']:.1f} s with its start): "
            f"{json.dumps(reload)}")
        for name in ("bf16", "bf16_tta_hflip"):
            r = reload[name]
            if r["shapes"] != [None, *DEPLOY_HW, 1]:
                failures.append(f"15a {name}: program shapes {r['shapes']}")
            if r["devices"] != ["cuda:0"]:
                failures.append(f"15a {name}: constants on {r['devices']}")
            worst = max(r["max_abs_err"].values())
            if not worst <= export.CHECK_ATOL:
                failures.append(f"15a {name}: reload vs live max |diff| {worst:.3e} > "
                                f"{export.CHECK_ATOL:.0e}")
        if reload["cpu"]["devices"] != ["cpu"] or reload["cpu"]["shapes"] != [None, *DEPLOY_HW, 1]:
            failures.append(f"15a CPU load: {reload['cpu']}")

    def timing():
        params, state, config, _ = load_model(ckpt, UNetConfig(), torch.device("cuda"))
        x = torch.rand((1, *DEPLOY_HW, 3), generator=torch.Generator(device="cuda").manual_seed(1),
                       device="cuda")
        ms = {}
        for name, flags in DEPLOY_EXPORTS.items():
            fwd = export.load_exported(art / f"{name}.pt2", "cuda").module()
            live = export.folded_forward(params, state, config, amp="--no-amp" not in flags,
                                         tta="--tta" in flags, tta_mode=DEPLOY_TTA_MODE,
                                         device="cuda")
            with torch.inference_mode():
                turns = [(k, time_ms(lambda f=f: f(x), reps=5))
                         for k, f in (("live", live), ("pt2", fwd), ("pt2", fwd), ("live", live))]
            ms[name] = {k: [round(t, 3) for kk, t in turns if kk == k] for k in ("pt2", "live")}
        numbers["ms_b1"] = ms
        log(f"15a ms a batch-1 call at 640x959 (CUDA events, median of 5, in turns live, pt2, "
            f"pt2, live): {json.dumps(ms)} ({card})")

    if not failures:
        attempt("15a timing", timing)
    done("15a_end", t0)
    if failures:
        raise SystemExit(f"chip_smoke: deployment checks failed: {failures}")
    return launches, numbers


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs the port on a CUDA GPU")
    card = gpu_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    full_fp32()
    # Before the first cuDNN conv of this process: phase 2 times library
    # convs of its own (ops/conv.py).
    cudnn_engine_rule()
    t_start = time.perf_counter()

    def phase_done(name: str, t0: float) -> None:
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")

    # Phase 1: build.
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path().relative_to(ROOT)}")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    t1 = time.perf_counter()
    if not native.available():
        raise SystemExit("chip_smoke: the native tier did not build or failed its self-check")
    log(f"native tier: {native.build().relative_to(ROOT)} built with g++ and self-checked "
        f"against Pillow in {time.perf_counter() - t1:.1f} s, has_jpeg="
        f"{bool(native._load().tu_has_jpeg)}")
    phase_done("1 (build)", t0)

    # Phase 2: kernels vs plain; 2b: train kernels; 2c: the im2col conv;
    # 2d: the clip and update kernels.
    t0 = time.perf_counter()
    results = phase_kernels()
    phase_done("2 (serving kernels)", t0)
    t0 = time.perf_counter()
    results.update(phase_train_kernels())
    phase_done("2b (train kernels)", t0)
    t0 = time.perf_counter()
    im2col_counts, results["im2col_conv3x3"] = phase_im2col()
    phase_done("2c (im2col_conv3x3)", t0)
    t0 = time.perf_counter()
    results.update(phase_update_kernels())
    phase_done("2d (clip and update kernels)", t0)
    workdir = ROOT / ".smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        # Phases 3 and 4: serve the full-width model.
        t0 = time.perf_counter()
        launches = phase_serve(workdir / "serve")
        torch.cuda.empty_cache()
        phase_done("3-4 (serve)", t0)
        # Phase 5: the full-width train step.
        t0 = time.perf_counter()
        step_launches, timing = phase_train()
        log(f"train step timing: {json.dumps(timing)}")
        torch.cuda.empty_cache()
        phase_done("5 (train step)", t0)
        # Phase 6: the train CLI, the slice's main path.
        t0 = time.perf_counter()
        cli_launches, cli_numbers = phase_train_cli(workdir / "train")
        log(f"train CLI numbers: {json.dumps(cli_numbers)}")
        torch.cuda.empty_cache()
        phase_done("6 (train CLI)", t0)
        # Phase 7: the predict surface on phase 3's checkpoint.
        t0 = time.perf_counter()
        surface = phase_predict_surface(workdir / "surface", workdir / "serve" / "unet_base64.npz",
                                        workdir / "train" / "data", card)
        log(f"predict surface numbers: {json.dumps(surface)}")
        torch.cuda.empty_cache()
        phase_done("7 (predict surface)", t0)
        # Phase 8: the data path, on phase 3's checkpoint and phase 6's and
        # phase 7's files.
        t0 = time.perf_counter()
        inputs = [str(p) for d in ("big", "small")
                  for p in sorted((workdir / "surface" / d / "imgs").glob("*.png"))]
        data_path = phase_data_path(workdir / "data_path", workdir / "serve" / "unet_base64.npz",
                                    inputs, workdir / "surface", workdir / "train", card)
        log(f"data path numbers: {json.dumps(data_path)}")
        torch.cuda.empty_cache()
        phase_done("8 (data path)", t0)
        # Phase 9: the other model families, on phase 6's files.
        t0 = time.perf_counter()
        families = phase_families(workdir / "families", workdir / "train" / "data")
        log(f"families numbers: {json.dumps(families)}")
        torch.cuda.empty_cache()
        phase_done("9 (families)", t0)
        # Phase 10: training quality and observability, on phase 6's files.
        t0 = time.perf_counter()
        quality = phase_quality(workdir / "quality", workdir / "train")
        log(f"quality numbers: {json.dumps(quality)}")
        torch.cuda.empty_cache()
        phase_done("10 (training quality and observability)", t0)
        if time.perf_counter() - t0 > QUALITY_BUDGET_S:
            log(f"phase 10 took over its {QUALITY_BUDGET_S:.0f} s budget")
        # Phase 11: data parallelism, on phase 6's files.
        t0 = time.perf_counter()
        dp_numbers = phase_data_parallel(workdir / "data_parallel", workdir / "train", card)
        log(f"data parallelism numbers: {json.dumps(dp_numbers)}")
        torch.cuda.empty_cache()
        phase_done("11 (data parallelism)", t0)
        if time.perf_counter() - t0 > DP_BUDGET_S:
            log(f"phase 11 took over its {DP_BUDGET_S:.0f} s budget")
        # Phase 12: ZeRO, multi-host, halo-sharded predict, on phase 6's
        # files, 11a's run and phase 3's checkpoint.
        t0 = time.perf_counter()
        mh_numbers = phase_multihost(workdir / "multihost", workdir / "train",
                                     workdir / "data_parallel",
                                     workdir / "serve" / "unet_base64.npz", card)
        log(f"ZeRO / multi-host / halo-sharded numbers: {json.dumps(mh_numbers)}")
        torch.cuda.empty_cache()
        phase_done("12 (ZeRO, multi-host and halo-sharded predict)", t0)
        if time.perf_counter() - t0 > MH_BUDGET_S:
            log(f"phase 12 took over its {MH_BUDGET_S:.0f} s budget")
        # Phase 13: spatial parallelism, on phase 6's files.
        t0 = time.perf_counter()
        sp_numbers = phase_spatial(workdir / "spatial", workdir / "train", card)
        log(f"spatial parallelism numbers: {json.dumps(sp_numbers)}")
        torch.cuda.empty_cache()
        phase_done("13 (spatial parallelism)", t0)
        if time.perf_counter() - t0 > SP_BUDGET_S:
            log(f"phase 13 took over its {SP_BUDGET_S:.0f} s budget")
        # Phase 14: tensor and pipeline parallelism, on phase 6's files.
        t0 = time.perf_counter()
        tp_numbers = phase_tensor_pipeline(workdir / "tensor", workdir / "train", card)
        log(f"tensor / pipeline parallelism numbers: {json.dumps(tp_numbers)}")
        torch.cuda.empty_cache()
        phase_done("14 (tensor and pipeline parallelism)", t0)
        if time.perf_counter() - t0 > TP_BUDGET_S:
            log(f"phase 14 took over its {TP_BUDGET_S:.0f} s budget")
        # Phase 15: the deployment surface, on phase 3's checkpoint.
        t0 = time.perf_counter()
        deploy_launches, deploy = phase_deploy(workdir / "deploy",
                                               workdir / "serve" / "unet_base64.npz",
                                               workdir / "train" / "data" / "imgs", card)
        log(f"deployment numbers: {json.dumps(deploy)}")
        torch.cuda.empty_cache()
        phase_done("15 (deployment surface)", t0)
        if time.perf_counter() - t0 > DEPLOY_BUDGET_S:
            log(f"phase 15 took over its {DEPLOY_BUDGET_S:.0f} s budget")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # Phase 6b: remat.
    t0 = time.perf_counter()
    remat = phase_remat()
    log(f"remat numbers: {json.dumps({str(k): v for k, v in remat.items()})}")
    phase_done("6b (remat)", t0)
    log(f"launches: serving path {json.dumps(launches)}; train step (phase 5) "
        f"{json.dumps(step_launches)}; train CLI --kernels cuda (phase 6) "
        f"{json.dumps(cli_launches)}; im2col entry point {json.dumps(im2col_counts)}")

    report = []
    for name in (*PER_FORWARD, *PER_STEP, "im2col_conv3x3", *UPDATE_PER_STEP):
        if name in UPDATE_PER_STEP:
            (src, replaces), counts = UPDATE_SOURCES[name], cli_launches
            main_case = next(c for c in results[name]["cases"] if c["dtype"] == "fp32")
        elif name in PER_FORWARD:
            (src, replaces), counts = SOURCES[name], launches
            main_case = results[name]["cases"][0]
        elif name in PER_STEP:
            (src, replaces), counts = TRAIN_SOURCES[name], cli_launches
            main_case = next(c for c in results[name]["cases"]
                             if c["case"] == MAIN_TRAIN_CASE and c["dtype"] == "bf16")
        else:
            (src, replaces), counts = IM2COL_SOURCE, im2col_counts
            main_case = next(c for c in results[name]["cases"]
                             if c["case"] == MAIN_IM2COL_CASE and c["dtype"] == "bf16"
                             and c["out_dtype"] == "bf16")
        count, tc = counts[name], counts.get(f"{name}.tc")
        report.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                       "launches": count, "tc_launches": tc,
                       "deploy_launches": deploy_launches.get(name) if name in PER_FORWARD
                       else None,
                       "pool_launches": counts.get(f"{name}.pool"), "impl": IMPL[name],
                       "max_abs_err": results[name]["max_abs_err"],
                       "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                       "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                       "library_ms": main_case["library_ms"],
                       "library_call": LIBRARY_CALLS[name], "cases": results[name]["cases"]})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
