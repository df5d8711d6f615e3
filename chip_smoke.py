"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

run from the repository root, with no arguments and no install step.  It
drives the port's two paths at full width (FCN_16: 16/32/64/128/128
channels, 192x192x1 slices, 4 classes, bf16 convs) with weights drawn from
a seed, on cardiac-like phantom slices made from a seed: the serving path,
the cooperative FTN+STN predictor (``CooperativePredictor.predict(n_iter=
2)``), and the training path, the cooperative train step with latent
masking (``CooperativeTrainer.train_step``, batch 20, Adam lr 1e-4), with
its fused pass arms (``fused_stn``, ``fused_ftn``: passes stacked to
batches of 40 and 80).  Each path runs in three configurations: the
default; ``conv_s2=True`` (the JAX
package's ``PALLAS_CONV_S2=1``: the encoders' 16->16 and 32->32 stride-2
downsamples on kernel K4, with K4dx and K4dw in the backward); and
``conv_nl=True`` (its ``PALLAS_CONV_NL=1``: the residual stages'
64..128-channel 3x3 convs at 24x24 and 12x12 on kernel K5, with K5 on
flipped weights for dx and K5dw in the backward).  Then it runs the
training augmentation pipeline into the train step, the training loop
through the port's command line, its fused epoch and K-epoch window on
CUDA graphs of the augmentation and the step, the held-out evaluation of the loop's
best checkpoint through the port's test entry, the robustness protocol
(training on ACDC-layout volumes, the ACDC-C generator, the methods x cvals
table), data-parallel training over two ranks sharing the card (the step
against one process, ``cli.train --n_devices 2`` and its resume from a
whole-state checkpoint), the port's ``bench_b8_conv``, the path of the
blocked conv K6 (with its
dx and K6dw), and last the baseline family: ``SegmentationSolver`` on each
network of its registry (the UNets, the FCNs and the residual UNets),
whose 3x3 stride-1 convs of at most 64 channels run on K1, K1 dx and K2.

Phases, each printing its seconds when it ends:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel of the port, compiled by ``nvcc`` from
   ``csrc/``, one process per source, all started together; K1 and the
   tensor-core kernels of K4, K4dx, K4dw, K5, K5dw, K6 and K6dw must report
   0 spill bytes (and the latter seven at most 128 registers);
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the two paths give it (K1 forward at batch 20 and 160, K1
   dx and K2 at batch 20, bf16, plus one f32 shape each; K3 at (20, 128)
   and (20, 144), hard and soft, ties planted; K4, K4dx and K4dw at
   16->16 on 192x192 and 32->32 on 96x96, batch 20 and 160, bf16, and
   batch 20 f32, K4's, K4dx's and K4dw's two launches bitwise equal; K5,
   K5dx and
   K5dw at the four large-channel shapes, batch
   20 and 160, bf16, and batch 20 f32 (K5 and K5dx also batch 160 f32); K6,
   K6dx and K6dw at the five
   stages of ``bench_b8_conv``, batch 20, bf16, and one f32 stage; K6,
   K6dx and K6dw also launched twice, bitwise equal), with the
   tolerance stated; median times from CUDA events
   for the kernel, the plain version and one library call computing the
   same function where there is one (``library_ms``, a yardstick the port
   never calls), and the least time the card could take (``bound_ms``);
   for K1, K1 dx, K2, K4, K4dx, K4dw, K5, K5dx, K5dw, K6, K6dx and K6dw
   (K4's and K4dx's at batch 20 and 160, K4dw's at batch 20) and their
   cuDNN calls, and for K3, also the device
   time alone (``device_ms``, ``library_device_ms``: ``torch.profiler``'s
   kernel durations, without the host time the events hold); for K3 also
   ``floor_ms``, the device time of one elementwise pass over its bytes
   (``torch.add(sal, soft)``, no library time for K3's function), and
   ``host_us``, one wrapper call's host time; and for bf16
   K4dw at batch 20 and K6dw at the bench's stages that of their
   partial-sum and reduce kernels apart.  Then, checked and not timed,
   K1, K1 dx and K2 at every one of those shapes at batch 40 and 80 (the
   fused arms' stacked FTN and STN batches) and K4, K4dx and K4dw at
   batch 40, bf16;
4. serve: 10 requests of 160 slices, then 50 of 20, through ``predict``,
   then 50 of 20 with ``conv_s2=True`` and 50 of 20 with ``conv_nl=True``,
   with the launch counts set to 0 just before each route and read just
   after.  Each request must launch K1 (and K4, or K5) as often as the path
   has such convs and return finite
   values of the right shape.  Latency is on the host clock, as min /
   median / p90 / max: a smoke-level reading, not a benchmark.  Then a
   ``predict`` on the model in train mode must give the eval-mode output
   and leave every buffer and module mode as it was;
5. check: every leaf module of one bf16 and one f32 request on the card
   held against its CPU twin on the very input the card gave it; then the
   f32 and bf16 outputs end to end against the same predictor on the CPU;
   for ``conv_s2=True`` and for ``conv_nl=True`` a bf16 request layer by
   layer and the f32 output end to end against their CPU twins;
6. train: for each of the three configurations, a
   trainer at batch 20, bf16, on one fixed phantom batch: two steps with
   each branch forced on both codes (dropout, spatial, channel), then 10
   under ``mask_type="random"``, with the launch counts set to 0 just
   before and read just after each step.  Each step must launch K1
   forward, K1 dx, K2, K3, K4, K4dx, K4dw, K5, K5dx and K5dw exactly as
   often as the
   branches it drew require, and give finite losses; the standard loss on
   the first step's input must be lower after the steps than before.  Step
   time on the host clock as min / median / p90 / max (smoke-level);
7. train-check: for each configuration, one f32 step on the card against
   the same step on the CPU, same weights and draws, full width, batch 2
   (channel masking on the image code, spatial on the shape code): losses,
   Adam's first moment (0.1 x the gradient, against the CPU step's own
   sensitivity to a rounding-sized move of its input), the running
   statistics and the masks;
7a. variants: the step's other configurations (``separate_training``, the
   ablation network types ``FCN_16_standard_share_code`` and
   ``FCN_16_standard_w_o_filter``, layer dropout at encoder 0.3 and decoder
   0.2, ``remat``, the saliency-BN arm, the fused pass arms ``fused_stn``
   and ``fused_ftn``, and ``fused_ftn`` with ``conv_s2`` and ``conv_nl``)
   at full width: two bf16 steps of
   batch 20 each on the hand kernels (latent DA ``random``; dropout masks
   from ``draw_step``), every wrapper launched exactly as
   ``expected_launches`` says for the drawn branches (``remat``'s recompute
   adds its K1 forwards, printed apart), finite losses, the step time and
   the peak device memory; then each configuration's train-check as in 7;
7b. arms: each of the step's and the augmentation's arms graphed and
   eager through ``cli.train``'s trainer with ``--fused_epoch`` (the
   sequential step, ``--fused_stn``, ``--fused_ftn``, both with
   ``--conv_s2 --conv_nl``, ``--warp two_gather``, ``--warp sequential``):
   the first step captured, ARM_TIMED replays bit for bit equal to a twin
   capturable trainer's eager steps (metrics, then state), the launches at
   capture equal to ``expected_launches``; host ms a step to a
   synchronize graphed and eager (medians), device ms a replayed step
   (the profiler), the graphs' pool and the process's peak reserved
   memory;
8. augment: the port's training augmentation (``ops/augment.py``) on 10
   phantom slices at 224x224: ``make_batch_train_pipeline`` with the
   configuration's policy (ACDC_affine_elastic_intensity; [augmented ||
   original] at 192x192, a batch of 20) on the card against the same
   pipeline on the CPU on the same ``draw_augment`` draws, then the same
   for ACDC_affine_all, Atrial_perturb and elastic_v2 (the bias fields,
   gamma and the coarse elastic field), then the configuration's policy
   with the two other warp arms (``two_gather``, ``sequential``): images
   within 1e-4, labels equal,
   except at pixels whose sample coordinate lies within 1e-3 of the frame's
   edge or (labels) whose CPU class score lies within 1e-3 of 0.5 (for
   ``sequential`` also where the second resample reads a first-resample
   pixel that is unsure, ``augment.unsure_pixels``), at most 0.1 % of the
   pixels (2 % for ``sequential``), every gated stage fired on some slices
   and not on others; one batch timed by CUDA events and by device time
   (``profile_predict.device_time``) with its launches; then three bf16
   train steps with latent DA on batches the card's pipeline has just
   made, each launching the kernels its branches require, losses finite;
9. loop: the training loop through the port's command line
   (``cli.train``'s ``parse_args``, ``load_config`` and ``run``) on
   ``configs/ACDC/cooperative_training.json`` with ``--synthetic --bf16``:
   20 training and 10 validation phantoms, 5 epochs of 2 steps, validation
   with ``predict(n_iter=2)`` every epoch, a periodic checkpoint every 2
   epochs, into a temporary directory, with the launch counts set to 0
   just before and read just after.  Each epoch's train and validation
   seconds and the host milliseconds spent drawing are printed.  It fails
   unless the last epoch's mean standard loss is below the first's, every
   logged Mean IoU is finite, the best epoch is the first argmax of the
   logged IoUs, ``best/`` and the periodic directories hold all five
   modules, a predictor loaded from ``best/`` validates to the loop's
   confusion matrix of that epoch, a snapshot loads back bit for bit, and
   every kernel launched as often as the drawn branches
   (``expected_launches``) and the validations' predicts require;
9a. fused: the fused epoch, the K-epoch window and their CUDA graphs at
   full width (``configs/ACDC/cooperative_training.json``, ``--synthetic
   --bf16``, batch 20): all 9 branch tuples of ``mask_type="random"``
   captured into one pool (``train/graphs.py:StepGraphs``; the gather, the
   augmentation and the step), each eager and captured and then replayed
   once, every step bit for bit equal to a twin capturable trainer's eager
   step on the same draws (metrics; then parameters, BN buffers, Adam's
   step and moments), each graph's launches at capture equal to
   ``expected_launches`` (the counters tick at a capture, not at a
   replay), the graphs' shared pool alone (its segments) with 9 graphs
   under twice that with 1; the host ms a step to a synchronize, graphed
   and eager (medians of 10); the protocol's epoch (2 steps and a
   validation) in steady state, every tuple captured, fused, pipelined
   and in 2-epoch windows (runs of 4 epochs, medians of 3); one traced
   graphed epoch (2 replays and the validation graph) and the same 2
   steps eager, traced, with their idle shares; then 3 epochs through
   ``cli.train``'s functions with ``--fused_epoch``, with ``--fused_epoch
   --pipeline_epoch``, with ``--fused_epoch --multi_epoch 2`` and on the
   streaming path with a capturable trainer, the first three bit for bit
   equal to the fourth (losses, confusion matrices, best epoch and score,
   state), with each run's epoch seconds, captures and replays.  Its
   launches are those the card made (``train/graphs.py:launched``: the
   counters' ticks less the captures' counts, plus each graph's counts
   once a replay);
9b. determinism: the ``--synthetic`` protocol twice through ``cli.train``
   (streaming, 2 epochs, one seed, bf16): the two runs' ``.pth`` files and
   logged losses and Mean IoUs must be identical; then for the default,
   ``conv_s2`` and ``conv_nl`` routes the eager step's device ms (the
   profiler) and host ms to a synchronize on cuDNN's default algorithms
   (the step before every step on the card ran on deterministic cuDNN)
   and on deterministic cuDNN, each after a warm step;
10. eval: the held-out evaluation through the port's test entry
   (``cli.test``'s ``parse_args``, ``load_predictor`` and ``run``) of the
   loop phase's best checkpoint, float32, ``predict(n_iter=2)``, on the
   synthetic ACDC tree's test list that the port's writer
   (``cli.make_synthetic_acdc``) puts in a temporary directory: 20 pids x
   ED/ES, 40 volumes of 10 slices at 224x224, chunks of 10 slices, with the
   launch counts set to 0 just before and read just after.  It fails
   unless ``detail.csv`` holds 40 rows of finite Dice, K1 launched on every
   chunk as often as the predict has stride-1 convs of at most 64 channels
   and no other kernel launched, and the per-volume Dice of 2 volumes,
   recomputed on the CPU with the plain versions, lies within 0.01 of the
   card's for each class; it prints the seconds a volume, K1's launches a
   chunk, the largest Dice gap and the card's ``nvidia-smi`` line;
11. robustness: the paper's protocol through the command lines'
   functions, with the launch counts set to 0 just before and read just
   after each step.  ``cli.make_synthetic_acdc`` writes a tree of the
   "10" policy's 10 training and 5 validation pids of cval 0 and 4 pids of
   the test list, 10 slices at 224x224 a volume; ``cli.train`` trains
   ``configs/ACDC/standard_training.json`` and
   ``cooperative_training.json`` on it (``--root_dir``, ``--bf16``, 1
   epoch of 20 steps, batches of 10 slices augmented and as they are),
   each launching exactly what its drawn
   branches and validation predicts require (no K3 in standard training);
   ``cli.generate_acdc_c`` writes ACDC-C of the 4 test pids x ED/ES x the
   four attacks, seed 0, on the card, launching no kernel, and one volume
   of each attack, recomputed on the CPU with the same draws, must lie
   within 1e-4 of the card's file; ``cli.test --checkpoint_template``
   evaluates both methods on ACDC and the four subsets: 30 rows (LV, MYO
   and RV Dice) of finite means in ``aggregated.csv``, K1 launched 26 times
   a chunk of 10 slices and nothing else.  Where the checkout holds the
   TPU checkpoints of ``saved/train_ACDC_10_n_cls_4``, the same template
   evaluates them and their clean rows are printed beside
   ``saved/robustness_synthetic/aggregated.csv``.  It prints the seconds
   of writing, of each training, of generating and of evaluating;
11a. ddp: data-parallel training (``parallel/mesh.py``) over two gloo
   ranks sharing the card, each started by ``parallel.mesh.launch``.
   First K1, K1 dx, K2 (bf16, every shape of the kernels phase) and K3
   (D 128 and 144, hard and soft) at N = 10, a rank's shard of 20, against
   their plain versions (checked, not timed).  Then, at full width (bf16,
   batch 20 on the phase's phantom slices, so 10 a rank), three steps with
   each latent-DA branch forced once on both codes, every rank's launches
   held to ``expected_launches`` at its batch, the ranks' states (hashes)
   and metrics equal, and after each step the losses, parameters, BN
   running statistics and Adam moments held against one process stepping
   the whole batch from the same state and draws by ``compare_bf16``'s
   rule: their max and mean gaps at most twice the one process's own bf16
   against its f32 twin's; then a ``random`` step timed (host ms, and the
   ms inside collectives with the device synchronized before each: the
   all-reduce's share) and one traced (device busy ms).  In the same start
   of the ranks, ``cli.train --synthetic --bf16 --n_devices 2`` for 2
   epochs of one step (10 training phantoms) through the command line's
   functions (a whole-state checkpoint every epoch), then, started anew, one epoch more by ``--resume_orbax``:
   the runs must cover epochs 0-1 and then 2 alone, rank 1 write nothing and
   rank 0's writes account for every file, the ranks log the same losses
   and confusion matrices, and each rank launch what its steps' branches
   and its validations' predicts require.  It prints the backend, the
   card's ``nvidia-smi`` line and the phase's seconds;
12. b8: one short run of ``bench_b8_conv`` at batch 20, bf16 (the five
   stages, forward and full VJP through K6, K1/K2 and cuDNN, the B8 route
   checked against the CHW route), with the launch counts set to 0 just
   before and read just after; it must launch K6, K6dx and K6dw;
13. baselines: each of the ten networks of ``train/segmentation.py``'s
   registry in a bf16 ``SegmentationSolver`` on the train phase's phantom
   batch (20 slices of 192x192, 4 classes): three train steps and a
   ``predict``, with the launch counts set to 0 just before and read just
   after each; every step must launch K1, K1 dx and K2 exactly as
   ``SegmentationSolver.expected_launches`` counts them from the network's
   conv list (the predict K1 alone), and give a finite loss; it prints
   each step's host ms (to a synchronize), the predict's and the peak
   device memory.  Then K1, K1 dx and K2 against their plain versions at
   every shape the baselines launched that the kernels phase did not
   check (bf16, batch 20, timed as there), and an f32 train-check of
   UNet_16, IN_SN_UNet_16 and ResUNet_16 (AdaAdam, the Adam-bound clip and
   the EMA, two steps) at batch 2, card against CPU
   (``baseline_train_check``).

At the end it prints, per kernel, its launches and times per random step
(per bench pass for K6), and tables of K2, K1, K1 dx, K4, K4 dx, K4dw, K5,
K5 dx and K5dw by shape (K4's launches from the ``conv_s2`` train phase,
K5's from the ``conv_nl`` one; K4dw's partial and reduce apart):
launches per random step, ms, device ms, cuDNN's ms and device ms
(``conv2d_weight``, ``F.conv2d``, ``conv2d_input``) and the bound, with the
per-step totals; K4 and K4 dx by shape at batch 160 too; and K6, K6 dx and
K6dw by stage of ``bench_b8_conv`` the same per bench pass, beside K1's (K1
dx's, K2's) device ms at the same shape, with K6dw's partial and reduce
apart.  The last lines are the card's ``nvidia-smi`` line, one JSON object with a
record per kernel, and ``{"ok": true, "device": {...}}``,
printed only when every phase passed.  Any failure exits non-zero.
Without a CUDA device, or without the port's package beside this file, it
exits non-zero before printing any result.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager, nullcontext

PORT = "cooperative_training_and_latent_space_data_augmentation_tpu_torch"
BATCH = 20           # the reference's eval batch
SERVE_BATCH = 160    # a serving batch
N_REQUESTS = 50      # timed requests at BATCH
N_SERVE_REQUESTS = 10  # timed requests at SERVE_BATCH
N_IMAGES = 4         # distinct request batches, served in turn
REPLAY_SLICES = 4    # slices of a request replayed layer by layer on the CPU
MAX_BF16_MISMATCH = 0.01  # share of a bf16 layer output that may differ from the CPU's
N_ITER = 2           # FTN prediction + one STN refinement
REPS = 25            # timed launches per measurement
K3_HOST_CALLS = 1000  # wrapper calls timed on the host clock for K3's host_us
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 off the tensor cores
JAX_PKG = "cooperative_training_and_latent_space_data_augmentation_tpu"
KERNELS = {  # wrapper name -> (source, the TPU kernel it replaces)
    "conv3x3_chw": (f"{PORT}/csrc/conv3x3_chw.cu", f"{JAX_PKG}/ops/pallas_conv.py:139"),
    "conv3x3_chw_dx": (f"{PORT}/csrc/conv3x3_chw.cu", f"{JAX_PKG}/ops/pallas_conv.py:399"),
    "conv3x3_chw_dw": (f"{PORT}/csrc/conv3x3_chw_dw.cu", f"{JAX_PKG}/ops/pallas_conv.py:215"),
    "percentile_mask": (f"{PORT}/csrc/percentile_mask.cu",
                        f"{JAX_PKG}/ops/pallas_kernels.py:66"),
    "conv3x3s2": (f"{PORT}/csrc/conv3x3s2.cu", f"{JAX_PKG}/ops/pallas_conv.py:499"),
    "conv3x3s2_dx": (f"{PORT}/csrc/conv3x3s2.cu", f"{JAX_PKG}/ops/pallas_conv.py:547"),
    "conv3x3s2_dw": (f"{PORT}/csrc/conv3x3s2.cu", f"{JAX_PKG}/ops/pallas_conv.py:588"),
    "conv3x3_nl": (f"{PORT}/csrc/conv3x3_nl.cu", f"{JAX_PKG}/ops/pallas_conv.py:776"),
    "conv3x3_nl_dx": (f"{PORT}/csrc/conv3x3_nl.cu", f"{JAX_PKG}/ops/pallas_conv.py:930"),
    "conv3x3_nl_dw": (f"{PORT}/csrc/conv3x3_nl.cu", f"{JAX_PKG}/ops/pallas_conv.py:823"),
    "conv3x3_b8": (f"{PORT}/csrc/conv3x3_b8.cu", f"{JAX_PKG}/ops/pallas_conv_blocked.py:136"),
    "conv3x3_b8_dx": (f"{PORT}/csrc/conv3x3_b8.cu",
                      f"{JAX_PKG}/ops/pallas_conv_blocked.py:309"),
    "conv3x3_b8_dw": (f"{PORT}/csrc/conv3x3_b8.cu",
                      f"{JAX_PKG}/ops/pallas_conv_blocked.py:192"),
}
S2_SHAPES = ((16, 16, 192, 192), (32, 32, 96, 96))  # (C_in, C_out, H, W) of the K4 convs
# (C_in, C_out, H, W) of the K5 convs: down3's two, down4's, up1's first
NL_SHAPES = ((64, 128, 24, 24), (128, 128, 24, 24), (128, 128, 12, 12), (128, 64, 24, 24))
B8_REPS = 5          # timed runs per variant in the b8 phase's bench
TRAIN_BATCH = 20     # the reference's training batch
FORCED_STEPS = 2     # steps with each branch forced
RANDOM_STEPS = 10    # steps under mask_type="random"
CHECK_BATCH = 2      # the f32 card-vs-CPU step (the CPU side runs full width)
# the augment phase: configs/ACDC/cooperative_training.json's policy on 10 raw
# 224x224 slices, [augmented || original] cropped to 192x192, a batch of 20
AUG_POLICY = "ACDC_affine_elastic_intensity"
AUG_OTHER_POLICIES = ("ACDC_affine_all", "Atrial_perturb", "elastic_v2")  # bias v2; bias v1
AUG_RAW = TRAIN_BATCH // 2                                               # and gamma; coarse
AUG_PAD = (224, 224)
AUG_CROP = (192, 192)
AUG_IMAGE_ATOL = 1e-4    # on the [0, 1] scale: cuFFT and pocketfft round differently
AUG_UNSURE = 1e-3        # a class score this near 0.5, a coordinate this near the edge
AUG_MAX_UNSURE = 1e-3    # share of a batch's pixels that may be unsure
AUG_MAX_UNSURE_SEQUENTIAL = 2e-2  # the sequential warp: a first-resample flip reaches 9 pixels
AUG_WARPS = ("two_gather", "sequential")  # the warp's arms beside the composed one
AUG_REPS = 20            # timed batches
AUG_TRAIN_STEPS = 3      # train steps on batches the card's pipeline made
# the loop phase: the --synthetic protocol of the port's command line on the
# configuration (20 training and 10 validation phantoms, the command line's
# defaults: 2 steps and 1 validation batch an epoch), 5 epochs, a periodic
# checkpoint every 2
LOOP_CONFIG = os.path.join("configs", "ACDC", "cooperative_training.json")
LOOP_EPOCHS = 5
LOOP_SAVE_EVERY = 2
# the eval phase: the held-out test list (20 pids x ED/ES) of the synthetic
# ACDC tree, 10 slices at 224x224 a volume, evaluated from the loop's best
# checkpoint by the port's test entry (float32, chunks of 10 slices); two
# volumes recomputed on the CPU
EVAL_SLICES = 10
EVAL_CHUNK = 10
EVAL_CPU_VOLUMES = 2
EVAL_DICE_ATOL = 0.01
# the robustness phase: the protocol on ACDC-layout volumes through the
# command lines' functions: a tree of the "10" policy's 10 training and 5
# validation pids of cval 0 and 4 pids of the test list (EVAL_SLICES slices
# each); standard and cooperative training on it, ROBUST_EPOCHS each; ACDC-C
# of the 4 test pids (seed 0, the four attacks) on the card; the template
# evaluation of both methods, and of the TPU checkpoints where the checkout
# holds them
ROBUST_METHODS = ("standard_training", "cooperative_training")
ROBUST_TEST_PIDS = 4
ROBUST_EPOCHS = 1
ACDC_C_ATOL = 1e-4   # card against CPU on the [0, 1] scale: cuFFT against pocketfft
BASELINE_STEPS = 3   # bf16 train steps of each registry network, batch 20
BASELINE_CHECKS = {  # network -> (solver keywords, steps) of its f32 train-check
    "UNet_16": ({}, 1),
    "IN_SN_UNet_16": ({}, 1),
    # two steps: the Adam-bound clip skips the first update
    "ResUNet_16": (dict(optimizer_name="AdaAdam", clip_grad=True, use_ema=True), 2),
}
TPU_RUNS = os.path.join("saved", "train_ACDC_10_n_cls_4")
TPU_TABLE = os.path.join("saved", "robustness_synthetic", "aggregated.csv")


@contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.3f} s", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, flush):
    """Median device time of ``fn`` over REPS launches, each after the L2
    cache was overwritten (the main path meets its inputs cold)."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    for s, e in zip(starts, ends):
        flush.fill_(1.0)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_ms(fn, torch, flush, keep, tries=3):
    """Device time of one call of ``fn`` without the host: ``torch.profiler``
    over REPS calls, each after the L2 cache was overwritten, of the kernels
    whose name ``keep`` takes; per kernel name its median duration times
    its launches per call, summed.  A session now and then delivers no
    device events, so an empty one is run again, up to ``tries`` times;
    None when none saw the kernels (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                flush.fill_(1.0)
                fn()
            torch.cuda.synchronize()
        durations = {}
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA and keep(evt.name):
                durations.setdefault(evt.name, []).append(evt.time_range.elapsed_us())
        if durations:
            return sum(statistics.median(d) * len(d) for d in durations.values()) / REPS / 1e3
    return None


def registers_of(log, kernel):
    """The most registers ptxas gave a function whose mangled name holds
    ``kernel`` (``-Xptxas -v``), or None if the log names none."""
    most = None
    for part in log.split("Function properties for ")[1:]:
        name = part.split(None, 1)[0] if part.strip() else ""
        m = re.search(r"Used (\d+) registers", part)
        if kernel in name and m:
            most = max(most or 0, int(m.group(1)))
    return most


def spill_lines(log, kernel=""):
    """ptxas's spill reports in an nvcc log (``-Xptxas -v``) that are not
    zero, of the functions whose mangled name holds ``kernel``."""
    bad = []
    for part in log.split("Function properties for ")[1:]:
        name = part.split(None, 1)[0] if part.strip() else ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        if kernel in name and m and (int(m.group(1)) or int(m.group(2))):
            bad.append(f"{name}: {m.group(0)}")
    return bad


def k1_shapes(conv_chw, predictor_cpu, image):
    """(C_in, C_out, H, W) of every K1 conv of one predict(n_iter=2), with
    its count, recorded through the plain path of a CPU run."""
    seen = Counter()
    plain = conv_chw.conv3x3_chw_plain

    def record(x, w_all, H, W):
        seen[(x.shape[1], w_all.shape[0], H, W)] += 1
        return plain(x, w_all, H, W)

    conv_chw.conv3x3_chw_plain = record
    try:
        predictor_cpu.predict(image, n_iter=N_ITER)
    finally:
        conv_chw.conv3x3_chw_plain = plain
    return seen


def compare_f32(got, want, what):
    """f32: sums in other orders only, amplified over the ~50 convs of the
    path (two summation orders on the CPU come out 4.4e-5 of the logits'
    scale apart): max |got - want| <= 2e-4 of the scale, and the class
    argmax agrees on >= 99.5 % of the pixels."""
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"  {what}: max_abs_err {err:.4g} (tol {2e-4 * scale:.4g}), argmax "
          f"agreement {agree:.5f} (>= 0.995)", flush=True)
    if not (err <= 2e-4 * scale and agree >= 0.995):
        raise AssertionError(f"{what}: outside tolerance")


def compare_bf16(got, want, want_f32, what):
    """bf16, held to what bf16 itself costs the plain path: |got - want| at
    most twice |want - want_f32| in max and in mean, and argmax flips
    against ``want`` at most twice the flips between ``want`` and
    ``want_f32``, plus 0.5 %.  (With random weights the class scores are
    near-tied on much of the image and the network amplifies one-ulp
    differences in the sums, so this end-to-end bound is loose: it catches
    gross faults only.  ``replay_leaves`` is the tight check of the bf16
    path, and the f32 comparison holds the path to 99.5 %.)"""
    own = (want - want_f32).abs()
    diff = (got - want).abs()
    own_flip = (want.argmax(-1) != want_f32.argmax(-1)).float().mean().item()
    flip = (got.argmax(-1) != want.argmax(-1)).float().mean().item()
    print(f"  {what}: max_abs_err {diff.max().item():.4g} (tol {2 * own.max().item():.4g}), "
          f"mean {diff.mean().item():.4g} (tol {2 * own.mean().item():.4g}), argmax "
          f"agreement {1 - flip:.5f} (>= {1 - 2 * own_flip - 0.005:.5f})", flush=True)
    if not (diff.max() <= 2 * own.max() and diff.mean() <= 2 * own.mean()
            and flip <= 2 * own_flip + 0.005):
        raise AssertionError(f"{what}: outside tolerance")


def replay_leaves(torch, gpu, cpu, image, what):
    """Serve ``image`` on the card with a hook on every leaf module (conv,
    BN, activation) that keeps the first REPLAY_SLICES slices of its input
    and output; then run each module's CPU twin on that same input.  Each
    pair computes one layer from one input, so the card may differ from the
    CPU only by the order of its f32 sums:

    * bf16 outputs: both round nearly the same f32 value once, so they are
      at most one bf16 ulp of the output's scale apart, and equal but for
      the few values whose sum lies next to a rounding boundary: at most
      MAX_BF16_MISMATCH of them may differ (rounding at another point, or
      truncating, makes about half of them differ);
    * f32 outputs: at most 1e-5 of the scale apart (TF32 would be ~5e-4
      off)."""
    records = []
    leaves = [(name, m) for name, m in gpu.named_modules() if not list(m.children())]

    def keep(name):
        def hook(_mod, inp, out):
            records.append((name, inp[0][:REPLAY_SLICES].cpu(),
                            out[:REPLAY_SLICES].cpu()))
        return hook

    hooks = [m.register_forward_hook(keep(name)) for name, m in leaves]
    try:
        gpu.predict(torch.from_numpy(image).to(next(gpu.parameters()).device),
                    n_iter=N_ITER)
    finally:
        for h in hooks:
            h.remove()
    twins = dict(cpu.named_modules())
    worst = (0.0, None)
    mismatch = []
    with torch.inference_mode():
        for name, inp, got in records:
            want = twins[name](inp)
            scale = want.float().abs().max().item()
            if want.dtype == torch.bfloat16:
                tol = 2.0 ** (int(torch.tensor(max(scale, 1e-30)).log2().floor().item()) - 7)
            else:
                tol = 1e-5 * scale
            err = (got.float() - want.float()).abs().max().item()
            frac = (got != want).float().mean().item() if want.dtype == torch.bfloat16 else 0.0
            mismatch.append(frac)
            if got.dtype != want.dtype or err > tol or frac > MAX_BF16_MISMATCH:
                raise AssertionError(f"{what}: {name} on the card is {err:.4g} from its "
                                     f"CPU twin (tol {tol:.4g}), {frac:.4f} of its values "
                                     f"differ (<= {MAX_BF16_MISMATCH}), {got.dtype} vs "
                                     f"{want.dtype}")
            if tol > 0 and err / tol >= worst[0]:
                worst = (err / tol, name)
    print(f"  {what}: {len(records)} leaf calls match their CPU twins; the closest to "
          f"its tolerance is {worst[1]} at {worst[0]:.3f} of it; at most "
          f"{max(mismatch):.5f} of a bf16 output's values differ", flush=True)


def bound(nbytes, flops, dtype_name):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate for their type."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def bf16_tol(torch, scale):
    """One bf16 ulp at magnitude ``scale``."""
    return 2.0 ** (int(torch.tensor(max(scale, 1e-30)).log2().floor().item()) - 7)


def check_k3(torch, pmask, n, d, soft, flush=None, device=None):
    """K3 against its plain version (the sort-based threshold) on one
    (N, D) saliency with ties planted, at p in {0, 0.2, 0.5}: equal
    masks.  With ``flush`` also its times; no single PyTorch call computes
    this function, so there is no library time.  With ``device`` (the
    profiler's row of K3's kernel, the flush's kernel names) also its
    device time (:func:`device_ms`), ``floor_ms``, the device time of one
    elementwise pass over the same bytes (``torch.add(sal, soft)``: reads
    2 N D floats, writes N D) under the same flush, the least time the
    card takes for any one launch that touches them, and ``host_us``, the
    host time of one wrapper call (host clock over K3_HOST_CALLS calls
    after warm-up, no synchronise inside): the ctypes path every port
    kernel shares."""
    gen = torch.Generator(device="cuda").manual_seed(d + int(soft))
    sal = torch.randn((n, d), generator=gen, device="cuda")
    sal[:, 1] = sal[:, 2]                        # a tie
    sal[:, 3:9] = torch.round(sal[:, 3:9])       # more, at 0 and +-1
    sal[0] = sal[0, 0]                           # a row of one value
    vals = (0.5 * torch.rand((n, d), generator=gen, device="cuda") if soft
            else torch.zeros((n, d), device="cuda"))
    ok = True
    for pv in (0.0, 0.2, 0.5):
        p = torch.tensor(pv, device="cuda")
        ok &= bool(torch.equal(pmask.percentile_mask(sal, p, vals),
                               pmask.percentile_mask_plain(sal, p, vals)))
    torch.cuda.synchronize()
    rec = {"shape": [n, d], "soft": soft, "max_abs_err": 0.0 if ok else float("inf"),
           "tol": 0.0, "ok": ok}
    print(f"  K3 {'soft' if soft else 'hard'} ({n}, {d}), ties planted: masks equal {ok}",
          end="" if flush is not None else "\n", flush=True)
    if flush is None:
        return rec
    p = torch.tensor(0.37, device="cuda")
    ms = time_ms(lambda: pmask.percentile_mask(sal, p, vals), torch, flush)
    plain_ms = time_ms(lambda: pmask.percentile_mask_plain(sal, p, vals), torch, flush)
    b, by = bound((3 * n * d + 1) * 4, float(n * d * d), "float32")
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b, bound_by=by)
    line = f" ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null bound_ms {b:.6f} ({by})"
    if device is not None:
        from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
            _group,
        )

        row, flush_names = device
        rec["device_ms"] = device_ms(lambda: pmask.percentile_mask(sal, p, vals), torch, flush,
                                     lambda name: _group(name) == row)
        rec["floor_ms"] = device_ms(lambda: torch.add(sal, vals), torch, flush,
                                    lambda name: name not in flush_names)
        for _ in range(10):
            pmask.percentile_mask(sal, p, vals)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(K3_HOST_CALLS):
            pmask.percentile_mask(sal, p, vals)
        rec["host_us"] = (time.perf_counter() - t0) / K3_HOST_CALLS * 1e6
        torch.cuda.synchronize()
        line += (f" device_ms {fmt(rec['device_ms'], 6)} floor_ms {fmt(rec['floor_ms'], 6)}"
                 f" host_us {rec['host_us']:.2f}")
    print(line, flush=True)
    return rec


CONV_KINDS = {  # kind -> (wrapper name in its module, stride, labels of fwd, dx, dw)
    "chw": ("conv3x3_chw", 1, ("K1", "K1 dx", "K2")),
    "s2": ("conv3x3s2", 2, ("K4", "K4dx", "K4dw")),
    "nl": ("conv3x3_nl", 1, ("K5", "K5dx", "K5dw")),
    "b8": ("conv3x3_b8", 1, ("K6", "K6dx", "K6dw")),
}


def check_conv(torch, F, conv_chw, mod, kind, which, shape, n, dtype_name, flush=None,
               device=None, split=()):
    """One conv kernel of ``kind`` (``CONV_KINDS``; ``mod`` is the module of
    its wrappers): the forward (``which`` "fwd"), the input gradient ("dx")
    or the weight gradient ("dw") against its plain version at one forward
    shape (C_in, C_out, H, W): x (N, C_in, H*W), dy (N, C_out, H/s * W/s)
    for stride s.  The plain dx is the module's own where it has one, else
    the plain forward on the flipped wall (a stride-1 conv's dx is that
    conv).  Forward and dx: bf16 within one ulp of scale (one rounding of
    nearly the same f32 sum), f32 within 1e-5 of scale (another summation
    order); dw (f32 out, the same exact products summed in another order)
    within 1e-5 of scale, and two launches bit for bit equal (K4, K4dx, K6
    and K6dx too: one mma chain per output, no atomics).  With
    ``flush`` also its times and cuDNN's conv, input gradient or weight
    gradient, and the bound.  With ``device`` (the profiler's row of this
    kind's kernel, and the flush kernel's names) also the device times of
    the kernel and the library call (:func:`device_ms`), and with ``split``
    ((label, a substring of kernel names), ...) the device time of the
    kernel's launches whose name holds each substring, under
    ``rec["split_device_ms"][label]``."""
    name, stride, labels = CONV_KINDS[kind]
    c_in, c_out, h, w = shape
    ho, wo = h // stride, w // stride
    dtype = getattr(torch, dtype_name)
    seed = c_in * 1000 + c_out + h + {"fwd": 0, "dx": 7, "dw": 11}[which]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, c_in, h * w), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((n, c_out, ho * wo), generator=gen, device="cuda").to(dtype)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device="cuda")
             / (9 * c_in) ** 0.5).to(dtype)
    x4, dy4 = x.view(n, c_in, h, w), dy.view(n, c_out, ho, wo)
    w4 = w_all.view(c_out, 3, 3, c_in).permute(0, 3, 1, 2).contiguous()
    fwd, fwd_plain = getattr(mod, name), getattr(mod, f"{name}_plain")
    dx_plain = getattr(mod, f"{name}_dx_plain", None) or (
        lambda d, wa, hh, ww: fwd_plain(d, conv_chw.flip_wall(wa).contiguous(), hh, ww))
    dxf, dwf, dw_plain = (getattr(mod, f"{name}_dx"), getattr(mod, f"{name}_dw"),
                          getattr(mod, f"{name}_dw_plain"))
    es = x.element_size()
    fn, plain, library, out_bytes = {
        "fwd": (lambda: fwd(x, w_all, h, w), lambda: fwd_plain(x, w_all, h, w),
                lambda: F.conv2d(x4, w4, None, stride, 1), dy.numel() * es),
        "dx": (lambda: dxf(dy, w_all, h, w), lambda: dx_plain(dy, w_all, h, w),
               lambda: torch.nn.grad.conv2d_input((n, c_in, h, w), w4, dy4, stride=stride,
                                                  padding=1), x.numel() * es),
        "dw": (lambda: dwf(x, dy, h, w), lambda: dw_plain(x, dy, h, w),
               lambda: torch.nn.grad.conv2d_weight(x4, (c_out, c_in, 3, 3), dy4,
                                                   stride=stride, padding=1),
               9 * c_in * c_out * 4),
    }[which]
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = bf16_tol(torch, scale) if dtype_name == "bfloat16" and which != "dw" \
        else 1e-5 * scale
    same = bool(torch.equal(got, again))
    # launches held to be bitwise equal
    repeat = which == "dw" or kind in ("b8", "s2")
    rec = {"shape": [n, c_in, c_out, h, w], "dtype": dtype_name, "max_abs_err": err,
           "tol": tol, "ok": err <= tol and (same or not repeat)}
    label = labels[("fwd", "dx", "dw").index(which)]
    print(f"  {label} {dtype_name} N={n} {c_in}->{c_out} @ {h}x{w}: max_abs_err {err:.3g} "
          f"(tol {tol:.3g})" + (f", two launches bitwise equal: {same}" if repeat
                                else ""), end="" if flush is not None else "\n", flush=True)
    del got, again, want
    if flush is None:
        return rec
    ms = time_ms(fn, torch, flush)
    plain_ms = time_ms(plain, torch, flush)
    with conv_chw.full_f32(dtype):  # an f32 conv in f32, not TF32
        library_ms = time_ms(library, torch, flush)
    in_bytes = {"fwd": x.numel() + w_all.numel(), "dx": dy.numel() + w_all.numel(),
                "dw": x.numel() + dy.numel()}[which] * es
    b, by = bound(in_bytes + out_bytes, 2.0 * n * c_out * 9 * c_in * ho * wo, dtype_name)
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b, bound_by=by)
    line = (f" ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
            f"bound_ms {b:.4f} ({by})")
    if device is not None:
        row, flush_names = device
        from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
            _group,
        )

        rec["device_ms"] = device_ms(fn, torch, flush, lambda name: _group(name) == row)
        with conv_chw.full_f32(dtype):
            rec["library_device_ms"] = device_ms(library, torch, flush,
                                                 lambda name: name not in flush_names)
        line += f" device_ms {fmt(rec['device_ms'])} library_device_ms " \
                f"{fmt(rec['library_device_ms'])}"
        rec["split_device_ms"] = {
            label: device_ms(fn, torch, flush,
                             lambda name, part=part: _group(name) == row and part in name)
            for label, part in split}
        line += "".join(f" {label}_device_ms {fmt(v)}"
                        for label, v in rec["split_device_ms"].items())
    print(line, flush=True)
    return rec


def fmt(v, digits=4):
    """A time for the log: its value, or "not measured"."""
    return "not measured" if v is None else f"{v:.{digits}f}"


def flush_kernels(torch, flush):
    """Names of the kernels ``flush.fill_`` launches, which device_ms drops
    from a library call's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            flush.fill_(1.0)
        torch.cuda.synchronize()
    return {evt.name for evt in prof.events() if evt.device_type == DeviceType.CUDA}


LAUNCH_COUNTERS = ("conv3x3_chw", "conv3x3_chw_dx", "conv3x3_chw_dw", "percentile_mask",
                   "conv3x3s2", "conv3x3s2_dx", "conv3x3s2_dw",
                   "conv3x3_nl", "conv3x3_nl_dx", "conv3x3_nl_dw",
                   "conv3x3_b8", "conv3x3_b8_dx", "conv3x3_b8_dw")


def _homes(conv_chw, pmask):
    """The module each wrapper of LAUNCH_COUNTERS lives in."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        conv_b8,
        conv_nl,
        conv_s2,
    )

    homes = {"percentile_mask": pmask}
    for mod, names in ((conv_chw, LAUNCH_COUNTERS[:3]), (conv_s2, LAUNCH_COUNTERS[4:7]),
                       (conv_nl, LAUNCH_COUNTERS[7:10]), (conv_b8, LAUNCH_COUNTERS[10:])):
        homes.update(dict.fromkeys(names, mod))
    return {name: homes[name] for name in LAUNCH_COUNTERS}


def wrappers_of(conv_chw, pmask):
    """The thirteen kernel wrappers by name (LAUNCH_COUNTERS)."""
    return {name: getattr(home, name) for name, home in _homes(conv_chw, pmask).items()}


@contextmanager
def recording_shapes(conv_chw, pmask, masking, seen):
    """Route the thirteen wrappers through recorders that add each call's
    shape to ``seen[wrapper]`` and call the wrapper itself (which launches
    and counts as before): the convs' forward, dx and dw wrappers by their
    forward conv's (C_in, C_out, H, W), K3 by (N, D)."""
    orig = wrappers_of(conv_chw, pmask)
    fwd = lambda x, w_all, H, W: (x.shape[1], w_all.shape[0], H, W)  # noqa: E731
    dx = lambda dy, w_all, H, W: (w_all.shape[1] // 9, w_all.shape[0], H, W)  # noqa: E731
    dw = lambda x, dy, H, W: (x.shape[1], dy.shape[1], H, W)  # noqa: E731
    keys = {name: (dx if name.endswith("_dx") else dw if name.endswith("_dw") else fwd)
            for name in LAUNCH_COUNTERS}
    keys["percentile_mask"] = lambda sal, p, soft: tuple(sal.shape)
    homes = {k: v for k, v in _homes(conv_chw, pmask).items() if k != "percentile_mask"}

    def recorder(name):
        def call(*args):
            seen[name][keys[name](*args)] += 1
            return orig[name](*args)
        # a wrapper counts through its module-level name, which may now be
        # this recorder: its count starts at 0 here and is added back on exit
        call.launches = 0
        return call

    recorders = {name: recorder(name) for name in LAUNCH_COUNTERS}
    for name, home in homes.items():
        setattr(home, name, recorders[name])
    masking.percentile_mask = recorders["percentile_mask"]
    try:
        yield
    finally:
        for name, home in homes.items():
            setattr(home, name, orig[name])
        masking.percentile_mask = orig["percentile_mask"]
        for name in LAUNCH_COUNTERS:
            orig[name].launches += recorders[name].launches


def train_phase(torch, conv_chw, pmask, masking, cfg, coop, draws_mod, image, label,
                conv_s2=False, conv_nl=False):
    """The train phase (see the module docstring) of one configuration.
    Returns (launches by wrapper over the phase, the random steps' calls by
    wrapper and shape, step times of the random steps)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
        frozen_stats,
    )

    wrappers = wrappers_of(conv_chw, pmask)
    trainer = coop.CooperativeTrainer(cfg.LatentDAConfig(), compute_dtype=torch.bfloat16,
                                      device="cuda", seed=0, conv_s2=conv_s2, conv_nl=conv_nl)
    tag = "S2 " if conv_s2 else "NL " if conv_nl else ""
    img = torch.from_numpy(image).to("cuda")
    lbl = torch.from_numpy(label).to("cuda")
    gen = torch.Generator().manual_seed(0)
    plan = [(t, FORCED_STEPS) for t in ("dropout", "spatial", "channel")] + \
        [("random", RANDOM_STEPS)]
    total = dict.fromkeys(LAUNCH_COUNTERS, 0)
    seen = {k: Counter() for k in LAUNCH_COUNTERS}
    times, first = [], None
    for mask_type, n_steps in plan:
        trainer.latent_da = cfg.LatentDAConfig(image_code=cfg.MaskConfig("mse", mask_type),
                                               shape_code=cfg.MaskConfig("ce", mask_type))
        for _ in range(n_steps):
            draws = draws_mod.draw_step(gen, TRAIN_BATCH, (192, 192), trainer.latent_da,
                                        device="cuda")
            for k in LAUNCH_COUNTERS:
                wrappers[k].launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (recording_shapes(conv_chw, pmask, masking, seen) if mask_type == "random"
                  else nullcontext()):
                metrics = trainer.train_step(img, lbl, draws)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            got = {k: wrappers[k].launches for k in LAUNCH_COUNTERS}
            for k in LAUNCH_COUNTERS:
                total[k] += got[k]
            branches = {"image": draws.image.branch, "shape": draws.shape.branch}
            want = {**dict.fromkeys(LAUNCH_COUNTERS, 0), **trainer.expected_launches(branches)}
            if got != want:
                raise AssertionError(f"{mask_type} step, branches {branches}: launches "
                                     f"{got}, expected {want}")
            values = {k: float(v) for k, v in metrics.items()}
            if not all(math.isfinite(v) for v in values.values()):
                raise AssertionError(f"non-finite loss: {values}")
            if first is None:
                first = (values, draws)
            if mask_type == "random":
                times.append(sec)
            print(f"  {tag}{mask_type:7s} branches image "
                  f"{branches['image']} shape "
                  f"{branches['shape']}: {sec * 1e3:9.3f} ms, launches "
                  f"{[got[k] for k in LAUNCH_COUNTERS]}, loss/total "
                  f"{values['loss/total']:.4f}, loss/standard/total "
                  f"{values['loss/standard/total']:.4f}", flush=True)
    values0, draws0 = first
    with torch.no_grad(), frozen_stats(trainer.model):
        clean = img.permute(0, 3, 1, 2).contiguous()
        noised = torch.clamp(clean + trainer.input_noise_std * draws0.noise, 0.0, 1.0)
        std, _ = trainer.standard_training(clean, lbl.long(), noised)
        after = float(std["seg"] + std["image"] + std["shape"] + std["gt_shape"])
    steps = len(plan) - 1
    print(f"  loss/standard/total on the first step's input: {values0['loss/standard/total']:.5f} "
          f"before, {after:.5f} after {FORCED_STEPS * steps + RANDOM_STEPS} steps", flush=True)
    if not after < values0["loss/standard/total"]:
        raise AssertionError("the standard loss did not fall")
    return total, seen, times


def assert_masks_agree(torch, got_mask, want_mask, got_sal, want_sal, p, what):
    """(N, D) masks equal, or swapped only where the saliency lies within
    twice the row's largest card-vs-CPU saliency difference of the row's
    threshold value (the int(D * p)-th largest)."""
    differ = got_mask != want_mask
    if not bool(differ.any()):
        return 0
    d = want_sal.shape[1]
    idx = int(torch.floor(torch.tensor(p, dtype=torch.float32) * d).clamp(0, d - 1))
    thresh = torch.sort(want_sal, dim=1, descending=True).values[:, idx:idx + 1]
    tol = 2 * (got_sal - want_sal).abs().max(dim=1, keepdim=True).values
    near = (want_sal - thresh).abs() <= tol
    if not bool(near[differ].all()):
        raise AssertionError(f"{what}: masks differ away from the threshold")
    return int(differ.sum())


def train_check(torch, cfg, coop, draws_mod, image, label, **trainer_kw):
    """One f32 step on the card against the same step on the CPU (see the
    module docstring), in the default configuration or with the trainer
    keywords ``trainer_kw`` (``conv_s2=True``, ``conv_nl=True``, or one of
    the step's other configurations, phase 7a).
    Tolerances, f32 sums in other orders:

    * losses: within 1e-4 of their value;
    * running statistics: within 1e-4 of each tensor's scale (40 layers of
      f32 forward at most);
    * Adam's first moment (0.1 x the gradient), in the Frobenius norm:
      this step's gradient is not continuous at f32 rounding (a LeakyReLU
      or ReLU whose input sits within rounding of 0 takes the other slope,
      and at batch 2 a deep layer's weight gradient sums few terms), so the
      yardstick is the CPU step's own sensitivity: the same step on the
      CPU with its input image moved by +-1e-6 of each pixel, twice.  The
      whole model's moment may differ from the CPU's by at most twice the
      larger of the two moves' differences, each tensor's by at most four
      times its own (one tensor's share of the kinks varies more from move
      to move) or 1e-3 of its norm;
    * the masks: equal, or swapped only next to the threshold."""
    lda = cfg.LatentDAConfig(image_code=cfg.MaskConfig("mse", "channel"),
                             shape_code=cfg.MaskConfig("ce", "spatial"))
    img, lbl = torch.from_numpy(image[:CHECK_BATCH]), torch.from_numpy(label[:CHECK_BATCH])
    gpu = coop.CooperativeTrainer(lda, device="cuda", seed=1, **trainer_kw)
    draws = draws_mod.draw_step(torch.Generator().manual_seed(1), CHECK_BATCH, (192, 192), lda,
                                **gpu.draw_kwargs())
    got_m = gpu.train_step(img.to("cuda"), lbl.to("cuda"), draws.to("cuda"))

    def cpu_step(x):
        trainer = coop.CooperativeTrainer(lda, device="cpu", seed=1, **trainer_kw)
        return trainer, trainer.train_step(x, lbl, draws)

    t0 = time.perf_counter()
    cpu, want_m = cpu_step(img)
    signs = [torch.randint(0, 2, img.shape, generator=torch.Generator().manual_seed(k)) * 2 - 1
             for k in (1, 2)]
    moved = [cpu_step(img * (1 + 1e-6 * sg))[0] for sg in signs]
    print(f"  three CPU steps in {time.perf_counter() - t0:.1f} s", flush=True)
    for k, w in want_m.items():
        g, w = float(got_m[k]), float(w)
        if not abs(g - w) <= 1e-4 * abs(w) + 1e-7:
            raise AssertionError(f"train-check: {k} {g} on the card, {w} on the CPU")
    print(f"  losses within 1e-4: loss/total {float(got_m['loss/total']):.6f} card, "
          f"{float(want_m['loss/total']):.6f} CPU", flush=True)
    gsd, csd = gpu.model.state_dict(), cpu.model.state_dict()
    worst = 0.0
    for k, w in csd.items():
        if "running_" in k:
            err = (gsd[k].cpu() - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            worst = max(worst, err)
    if worst > 1e-4:
        raise AssertionError(f"train-check: running statistics {worst:.3g} of scale apart")

    def flat_mu(trainer):
        mu, _ = trainer.adam_moments()
        return {f"{m}.{k}": v.detach().cpu().double() for m in mu for k, v in mu[m].items()}

    g_mu, c_mu = flat_mu(gpu), flat_mu(cpu)
    m_mu = [flat_mu(t) for t in moved]
    top = max(v.abs().max().item() for v in c_mu.values())
    whole = math.sqrt(sum(float((g_mu[k] - v).norm()) ** 2 for k, v in c_mu.items()))
    own_whole = max(math.sqrt(sum(float((m[k] - v).norm()) ** 2 for k, v in c_mu.items()))
                    for m in m_mu)
    ratio = 0.0
    for k, v in c_mu.items():
        own = max(float((m[k] - v).norm()) for m in m_mu)
        bound = max(1e-3 * float(v.norm()), 4 * own, 1e-6 * top * math.sqrt(v.numel()))
        ratio = max(ratio, float((g_mu[k] - v).norm()) / bound)
    norm = math.sqrt(sum(float(v.norm()) ** 2 for v in c_mu.values()))
    print(f"  running statistics within {worst:.3g} of scale; Adam mu: card vs CPU "
          f"{whole / norm:.3g} of the model's norm, CPU vs CPU moved {own_whole / norm:.3g} "
          f"(<= 2x); worst tensor at {ratio:.3f} of its bound", flush=True)
    if not (whole <= 2 * own_whole and ratio <= 1.0):
        raise AssertionError("train-check: Adam's first moments differ")
    swapped = 0
    for key in ("image", "shape"):
        g, c = gpu.generation[key], cpu.generation[key]
        n = g.mask.shape[0]
        if g.branch == 2:
            gm, cm = g.mask[:, :, 0, 0].cpu(), c.mask[:, :, 0, 0]
        else:
            gm, cm = g.mask[:, 0].reshape(n, -1).cpu(), c.mask[:, 0].reshape(n, -1)
        swapped += assert_masks_agree(torch, gm, cm, g.saliency.cpu(), c.saliency,
                                      float(getattr(draws, key).p), key)
    print(f"  masks (channel on the image code, spatial on the shape code): "
          f"{swapped} elements swapped next to the threshold", flush=True)


# phase 7a's configurations of the step (trainer keywords)
STEP_VARIANTS = {
    "separate_training": {"separate_training": True},
    "share_code": {"network_type": "FCN_16_standard_share_code"},
    "w_o_filter": {"network_type": "FCN_16_standard_w_o_filter"},
    "dropout": {"encoder_dropout": 0.3, "decoder_dropout": 0.2},
    "remat": {"remat": True},
    "saliency_bn_update": {"saliency_bn_update": True},
    "fused_stn": {"fused_stn": True},
    "fused_ftn": {"fused_ftn": True},
    "fused_ftn_s2_nl": {"fused_ftn": True, "conv_s2": True, "conv_nl": True},
}
VARIANT_STEPS = 2
STACKED_BATCHES = (40, 80)  # the fused FTN's 2 passes and the fused STN's 4, of 20


def variants_phase(torch, wrappers, cfg, coop, draws_mod, image, label):
    """Phase 7a (see the module docstring).  Returns the launches by wrapper
    over the phase's bf16 steps."""
    img = torch.from_numpy(image).to("cuda")
    lbl = torch.from_numpy(label).to("cuda")
    total = dict.fromkeys(LAUNCH_COUNTERS, 0)
    for name, kw in STEP_VARIANTS.items():
        lda = cfg.LatentDAConfig()
        trainer = coop.CooperativeTrainer(lda, compute_dtype=torch.bfloat16, device="cuda",
                                          seed=0, **kw)
        plain = coop.CooperativeTrainer(lda, compute_dtype=torch.bfloat16, device="cpu")
        gen = torch.Generator().manual_seed(2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(VARIANT_STEPS):
            draws = draws_mod.draw_step(gen, TRAIN_BATCH, (192, 192), lda, device="cuda",
                                        **trainer.draw_kwargs())
            for k in LAUNCH_COUNTERS:
                wrappers[k].launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train_step(img, lbl, draws)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            got = {k: wrappers[k].launches for k in LAUNCH_COUNTERS}
            branches = {"image": draws.image.branch, "shape": draws.shape.branch}
            want = {**dict.fromkeys(LAUNCH_COUNTERS, 0), **trainer.expected_launches(branches)}
            if got != want:
                raise AssertionError(f"{name} step {i}, branches {branches}: launches {got}, "
                                     f"expected {want}")
            for k in LAUNCH_COUNTERS:
                total[k] += got[k]
            values = {k: float(v) for k, v in metrics.items()}
            if not all(math.isfinite(v) for v in values.values()):
                raise AssertionError(f"{name}: non-finite loss: {values}")
            extra = got["conv3x3_chw"] - plain.expected_launches(branches)["conv3x3_chw"]
            masks = len(draws.dropout) if draws.dropout is not None else 0
            print(f"  {name} step {i} branches image {branches['image']} shape "
                  f"{branches['shape']}: {sec * 1e3:.3f} ms, launches K1/K1dx/K2/K3 "
                  f"{[got[k] for k in LAUNCH_COUNTERS[:4]]} (K1 {extra:+d} against the "
                  f"default step), dropout masks {masks}, loss/total "
                  f"{values['loss/total']:.4f}", flush=True)
        print(f"  {name}: peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
              f"GiB", flush=True)
        del trainer
        torch.cuda.empty_cache()
        train_check(torch, cfg, coop, draws_mod, image, label, **kw)
    return total


def per_call(calls, recs, key):
    """Sum over shapes of calls x ``recs[shape][key]``; None if a shape's
    value is None (not measured)."""
    vals = [recs[sh].get(key) for sh in calls]
    if any(v is None for v in vals):
        return None
    return sum(calls[sh] * recs[sh][key] for sh in calls)


def by_shape(calls, recs, total, label, library, unit="random step", beside=None):
    """Print one kernel's table by shape (forward C_in->C_out @ HxW) and its
    totals per ``unit``; ``beside`` is (label, records by shape) of another
    kernel computing the same function, whose device ms is printed too."""
    other = f", {beside[0]} device ms" if beside else ""
    print(f"  {label} by shape (C_in->C_out @ HxW: launches per {unit}, ms, device ms, "
          f"cuDNN {library} ms, cuDNN device ms{other}, bound ms):", flush=True)
    for sh in sorted(calls, key=lambda s: (-s[2], s[0], s[1])):
        r = recs[sh]
        col = f"{fmt(beside[1][sh].get('device_ms'))}, " if beside else ""
        print(f"    {sh[0]}->{sh[1]} @ {sh[2]}x{sh[3]}: {calls[sh]:.1f}, {r['ms']:.4f}, "
              f"{fmt(r.get('device_ms'))}, {r['library_ms']:.4f}, "
              f"{fmt(r.get('library_device_ms'))}, {col}{r['bound_ms']:.4f}", flush=True)
    line = (f"  {label} per {unit}: {total['ms']:.4f} ms, device {fmt(total['device_ms'])} "
            f"ms; cuDNN {library} at the same shapes {total['library_ms']:.4f} ms, device "
            f"{fmt(total['library_device_ms'])} ms")
    if beside:
        line += f"; {beside[0]} device {fmt(per_call(calls, beside[1], 'device_ms'))} ms"
    print(f"{line}; bound {total['bound_ms']:.4f} ms", flush=True)


def compare_augment(torch, got, want, edge, unsure, what, max_unsure=AUG_MAX_UNSURE):
    """A training batch from the card against the CPU's on the same draws:
    images within AUG_IMAGE_ATOL except where the sample coordinate lies
    within AUG_UNSURE of the source frame's edge (``edge``; the in-frame
    test picks the value or 0 there); labels equal except there and where
    a CPU class score lies within AUG_UNSURE of 0.5 (``unsure``); unsure
    pixels at most ``max_unsure`` of the batch's."""
    g_img, g_lbl = got["image"].cpu(), got["label"].cpu()
    w_img, w_lbl = want["image"], want["label"]
    if g_img.shape != w_img.shape or g_lbl.shape != w_lbl.shape or g_lbl.dtype != w_lbl.dtype:
        raise AssertionError(f"{what}: {g_img.shape} {g_lbl.shape} {g_lbl.dtype} from the card, "
                             f"{w_img.shape} {w_lbl.shape} {w_lbl.dtype} on the CPU")
    if not bool(torch.isfinite(g_img).all()):
        raise AssertionError(f"{what}: non-finite image values")
    err = (g_img - w_img).abs()[..., 0]
    worst = float(err[~edge].max())
    bad_img = int(((err > AUG_IMAGE_ATOL) & ~edge).sum())
    differ = g_lbl != w_lbl
    bad_lbl = int((differ & ~unsure).sum())
    share = float(unsure.float().mean())
    print(f"  {what}: image max abs err {worst:.3g} off the edge ({int(edge.sum())} pixels "
          f"within {AUG_UNSURE} of it, {int((err > AUG_IMAGE_ATOL).sum())} beyond "
          f"{AUG_IMAGE_ATOL}); labels differ at {int(differ.sum())}, unsure {int(unsure.sum())} "
          f"of {unsure.numel()} ({share:.2e})", flush=True)
    if bad_img or bad_lbl or share > max_unsure:
        raise AssertionError(f"{what}: {bad_img} image and {bad_lbl} label pixels disagree "
                             f"where the CPU is sure; unsure share {share:.2e}")


def gates_mixed(augment, draws, policy, what):
    """Every stage of probability in (0, 1) applies to some samples and not
    to others: a draw that skips a stage would leave it unchecked."""
    fired = {}
    for gate, prob in augment.GATES.items():
        u, p = getattr(draws, gate), getattr(policy, prob)
        if u is None or p >= 1:
            continue
        fired[gate] = int((u < p).sum())
        if fired[gate] in (0, u.numel()):
            raise AssertionError(f"{what}: stage {gate} fired on {fired[gate]} of {u.numel()}")
    return fired


def augment_phase(torch, augment, profile_predict, cfg, coop, draws_mod, wrappers):
    """The augment phase (see the module docstring).  Returns the launches
    by wrapper of its train steps."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        make_phantom,
    )

    slices = [make_phantom(np.random.RandomState(1000 + s), AUG_PAD) for s in range(AUG_RAW)]
    img_cpu = torch.from_numpy(np.stack([s[0] for s in slices]).astype(np.float32))
    lbl_cpu = torch.from_numpy(np.stack([s[1] for s in slices]).astype(np.int32))
    img, lbl = img_cpu.to("cuda"), lbl_cpu.to("cuda")
    gen = torch.Generator().manual_seed(0)
    drawn = {}
    for name in (AUG_POLICY,) + AUG_OTHER_POLICIES:
        policy = augment.get_policy(name)
        pipe = augment.make_batch_train_pipeline(name, AUG_PAD, AUG_CROP)
        draws = drawn[name] = augment.draw_augment(gen, policy, AUG_RAW, AUG_PAD)
        fired = gates_mixed(augment, draws, policy, name)
        want = pipe(draws, img_cpu, lbl_cpu)
        got = pipe(draws.to("cuda"), img, lbl)
        torch.cuda.synchronize()
        edge, unsure = augment.unsure_pixels(draws, img_cpu, lbl_cpu, name, AUG_PAD, AUG_CROP,
                                             tol=AUG_UNSURE)
        compare_augment(torch, got, want, edge, unsure,
                        f"{name}, {AUG_RAW} raw -> {2 * AUG_RAW} at {AUG_CROP[0]}x"
                        f"{AUG_CROP[1]} (stages fired {fired})")
    # the warp's other arms on the configuration's policy and draws
    for warp in AUG_WARPS:
        pipe = augment.make_batch_train_pipeline(AUG_POLICY, AUG_PAD, AUG_CROP, warp=warp)
        draws = drawn[AUG_POLICY]
        want = pipe(draws, img_cpu, lbl_cpu)
        got = pipe(draws.to("cuda"), img, lbl)
        torch.cuda.synchronize()
        edge, unsure = augment.unsure_pixels(draws, img_cpu, lbl_cpu, AUG_POLICY, AUG_PAD,
                                             AUG_CROP, tol=AUG_UNSURE, warp=warp)
        compare_augment(torch, got, want, edge, unsure, f"{AUG_POLICY}, warp {warp}",
                        AUG_MAX_UNSURE_SEQUENTIAL if warp == "sequential" else AUG_MAX_UNSURE)

    pipe = augment.make_batch_train_pipeline(AUG_POLICY, AUG_PAD, AUG_CROP)
    draws = drawn[AUG_POLICY].to("cuda")
    for _ in range(3):
        pipe(draws, img, lbl)
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(AUG_REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(AUG_REPS)]
    for a, b in zip(starts, ends):
        a.record()
        pipe(draws, img, lbl)
        b.record()
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in zip(starts, ends))
    t0 = time.perf_counter()
    for _ in range(AUG_REPS):
        augment.draw_augment(gen, augment.get_policy(AUG_POLICY), AUG_RAW, AUG_PAD,
                             device="cuda")
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t0) / AUG_REPS * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(AUG_REPS):
            pipe(draws, img, lbl)
        torch.cuda.synchronize()
    by_group, _, kernels = profile_predict.device_time(prof.key_averages())
    device = sum(by_group.values()) / 1e3 / AUG_REPS
    launches = sum(count for _, count, _ in kernels) / AUG_REPS
    if not device > 0:
        raise AssertionError("the profiler saw no device time in the augment pipeline")
    top = sorted(kernels, reverse=True)[:5]
    print(f"  {AUG_POLICY}, one batch ({AUG_RAW} raw -> {2 * AUG_RAW} at {AUG_CROP[0]}x"
          f"{AUG_CROP[1]}), {AUG_REPS} runs: events ms min {ms[0]:.4f} median "
          f"{statistics.median(ms):.4f} max {ms[-1]:.4f}; device ms {device:.4f} a batch "
          f"(busy share of the median {device / statistics.median(ms):.3f}); {launches:.0f} "
          f"launches a batch; draw_augment and the copy to the card {draw_ms:.3f} ms (host "
          f"clock)", flush=True)
    print("  largest device rows a batch (ms, launches): " + "; ".join(
        f"{t / 1e3 / AUG_REPS:.4f} {n // AUG_REPS} {key[:60]}" for t, n, key in top), flush=True)

    lda = cfg.LatentDAConfig()
    trainer = coop.CooperativeTrainer(lda, compute_dtype=torch.bfloat16, device="cuda", seed=0)
    total = dict.fromkeys(LAUNCH_COUNTERS, 0)
    for step in range(AUG_TRAIN_STEPS):
        aug_draws = augment.draw_augment(gen, augment.get_policy(AUG_POLICY), AUG_RAW, AUG_PAD,
                                         device="cuda")
        step_draws = draws_mod.draw_step(gen, TRAIN_BATCH, AUG_CROP, lda, device="cuda")
        for k in LAUNCH_COUNTERS:
            wrappers[k].launches = 0
        batch = pipe(aug_draws, img, lbl)
        metrics = trainer.train_step(batch["image"], batch["label"], step_draws)
        got = {k: wrappers[k].launches for k in LAUNCH_COUNTERS}
        branches = {"image": step_draws.image.branch, "shape": step_draws.shape.branch}
        want = {**dict.fromkeys(LAUNCH_COUNTERS, 0), **trainer.expected_launches(branches)}
        if got != want:
            raise AssertionError(f"augmented step {step}, branches {branches}: launches {got}, "
                                 f"expected {want}")
        for k in LAUNCH_COUNTERS:
            total[k] += got[k]
        values = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"non-finite loss on an augmented batch: {values}")
        print(f"  train step {step} on an augmented batch of {tuple(batch['image'].shape)}, "
              f"branches {branches}: loss/total {values['loss/total']:.4f}, launches "
              f"{[got[k] for k in LAUNCH_COUNTERS]}", flush=True)
    return total


def loop_phase(torch, wrappers, predict_k1, tmp):
    """The loop phase (see the module docstring), its run under the
    directory ``tmp``.  ``predict_k1(model)``: K1 launches of one
    ``predict(n_iter=2)``.  Returns the launches by wrapper over the loop
    and the best checkpoint's directory."""
    import numpy as np

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
        EvalBatcher,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import (
        checkpoint,
        driver,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
        MODULE_NAMES,
        CooperativePredictor,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import (
        checkpoint as whole,
    )

    whole_keep = 3  # save_checkpoint's max_to_keep
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), LOOP_CONFIG)
    argv = ["--json_config_path", config, "--synthetic", "--bf16", "--max_epochs",
            str(LOOP_EPOCHS), "--save_dir", tmp, "--log"]
    args = cli.parse_args(argv)
    cfg, name = cli.load_config(args)
    cfg.output.save_epoch_every_num_epochs = LOOP_SAVE_EVERY
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    trainer, result = cli.run(args, cfg, name)
    loop_sec = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    log_dir, model_dir = driver.experiment_dirs(tmp, cfg.data.dataset_name,
                                                args.data_setting, cfg.data.num_classes,
                                                name, args.cval)
    std = driver.LOSS_KEYS.index("loss/standard/total")
    for e in result.epochs:
        print(f"  epoch {e.epoch}: {e.steps} steps, train {e.train_sec:.4f} s, val "
              f"{e.val_sec:.4f} s, drawing {e.draw_sec * 1e3:.3f} ms on the host "
              f"({e.draw_sec / e.train_sec:.4f} of train); loss/standard/total "
              f"{float(e.losses[:, std].mean()):.5f}, Mean IoU {e.iou:.5f}; branches "
              f"{e.branches}", flush=True)
    print(f"  train_network: {loop_sec:.3f} s for {LOOP_EPOCHS} epochs (host clock, "
          f"trainer build and checkpoints included); best epoch {result.best_epoch}, "
          f"Mean IoU {result.best_score:.5f}", flush=True)
    first = float(result.epochs[0].losses[:, std].mean())
    last = float(result.epochs[-1].losses[:, std].mean())
    if not last < first:
        raise AssertionError(f"the standard loss did not fall: {first} -> {last}")
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        ious = [r["value"] for r in map(json.loads, f) if r["tag"] == "iou/val_iou"]
    if len(ious) != LOOP_EPOCHS or not all(math.isfinite(v) for v in ious):
        raise AssertionError(f"logged Mean IoUs {ious}")
    if result.best_epoch != int(np.argmax(ious)):
        raise AssertionError(f"best epoch {result.best_epoch}, logged IoUs {ious}")
    periodic = [e for e in range(LOOP_EPOCHS) if (e + 1) % LOOP_SAVE_EVERY == 0 or e == 0]
    saved = ["best"] + [str(e) for e in periodic]
    if sorted(d for d in os.listdir(model_dir)
              if d not in ("interrupted", "orbax")) != sorted(saved):
        raise AssertionError(f"checkpoints {sorted(os.listdir(model_dir))}, want {saved}")
    # the whole state at every periodic save (utils/checkpoint.py)
    orbax = whole.all_steps(os.path.join(model_dir, "orbax"))
    if orbax != periodic[-whole_keep:]:
        raise AssertionError(f"whole-state checkpoints of steps {orbax}, want {periodic}")
    for d in saved:
        files = sorted(os.listdir(os.path.join(model_dir, d, "checkpoints")))
        if files != sorted(f"{m}.pth" for m in MODULE_NAMES):
            raise AssertionError(f"{d}/checkpoints holds {files}")
    # the best checkpoint validates as the trainer did at its epoch
    predictor = checkpoint.load_model(
        CooperativePredictor(compute_dtype=torch.bfloat16, device="cuda", seed=1,
                             conv_s2=args.conv_s2, conv_nl=args.conv_nl),
        os.path.join(model_dir, "best", "checkpoints"))
    _, val_set = cli.build_datasets(cfg, args)
    evals = EvalBatcher(val_set, cfg.learning.batch_size, cfg.data.pad_hw, cfg.data.crop_hw,
                        device="cuda")
    confusion = driver.eval_dispatch(predictor, evals).confusion_matrix.cpu().numpy()
    if not np.array_equal(confusion, result.epochs[result.best_epoch].confusion):
        raise AssertionError(f"best checkpoint's validation {confusion.tolist()}, the "
                             f"loop's {result.epochs[result.best_epoch].confusion.tolist()}")
    # a snapshot loads back bit for bit
    path = checkpoint.save_snapshot(trainer, model_dir, result.last_epoch)
    other = cli.build_trainer(cfg, cli.parse_args(argv + ["--seed", str(args.seed + 1)]))
    if checkpoint.load_snapshot(other, path) != result.last_epoch:
        raise AssertionError("the snapshot's epoch")
    same = all(torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                                 other.model.state_dict().values()))
    for p, q in zip(trainer.model.parameters(), other.model.parameters()):
        a, b = trainer.optimizer.state[p], other.optimizer.state[q]
        same &= float(a["step"]) == float(b["step"]) and all(
            torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq"))
    if not same:
        raise AssertionError("the snapshot did not load back bit for bit")
    # every launch of the loop: its steps' and its validations' predicts
    want = Counter()
    for e in result.epochs:
        for branches in e.branches:
            want.update(trainer.expected_launches(branches))
    want["conv3x3_chw"] += LOOP_EPOCHS * len(evals) * predict_k1(trainer.model)
    want = {k: want.get(k, 0) for k in LAUNCH_COUNTERS}
    if got != want:
        raise AssertionError(f"launches over the loop {got}, expected {want}")
    if any(got[k] == 0 for k in LAUNCH_COUNTERS[:3]):
        raise AssertionError(f"the loop did not launch K1, K1 dx and K2: {got}")
    steps = sum(e.steps for e in result.epochs)
    print(f"  launches over the loop ({steps} steps, {LOOP_EPOCHS} validations), as its "
          f"branches and predicts require: {got}", flush=True)
    return got, os.path.join(model_dir, "best", "checkpoints")


FUSED_EPOCHS = 3      # epochs of each fused-phase loop run
FUSED_TIMED = 10      # steps timed graphed and eager
FUSED_TRACED = 2      # steps of the traced graphed epoch
STEADY_EPOCHS = 4     # epochs of a timed steady-state run of each epoch mode
STEADY_RUNS = 3       # timed runs of each mode, in alternating order
MASK_TYPES = ("dropout", "spatial", "channel")


def _same_tree(torch, a, b):
    """Two loaded checkpoints equal: the same keys and items, tensors bit
    for bit (the per-module files, and the whole-state ones with Adam's
    state)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(torch, v, b[k]) for k, v in a.items()))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_tree(torch, x, y) for x, y in zip(a, b)))
    return a == b


def _same_state(torch, a, b):
    """Parameters, BN buffers and Adam's state of two trainers bit for bit."""
    same = all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                 b.model.state_dict().values()))
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        same &= bool(torch.equal(sa["step"], sb["step"])) and all(
            torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq"))
    return same


def fused_phase(torch, wrappers, tmp, smi):
    """The fused phase (see the module docstring), its runs under ``tmp``.
    Returns the launches by wrapper the card made over the phase: the
    eager steps' and each graph's once a replay (``launched``)."""
    import numpy as np

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
        LatentDAConfig,
        MaskConfig,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
        CooperativeBatcher,
        EvalBatcher,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.augment import (
        draw_augment,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
        device_time,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
        StagedDraws,
        draw_step,
        stage_draws,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.driver import (
        GeneratorDraws,
        fetch_to_host,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
        StepGraphs,
        ValidationGraph,
        launched,
        pool_bytes,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
        MODULE_NAMES,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.multi_epoch import (
        WindowRunner,
    )
    from torch.profiler import ProfilerActivity, profile

    for w in wrappers.values():
        w.launches = 0
    t_part = time.perf_counter()

    def part_done(what):
        nonlocal t_part
        print(f"  ({what}: {time.perf_counter() - t_part:.3f} s)", flush=True)
        t_part = time.perf_counter()

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), LOOP_CONFIG)
    argv = ["--json_config_path", config, "--synthetic", "--bf16", "--max_epochs",
            str(FUSED_EPOCHS), "--log"]
    args = cli.parse_args(argv + ["--fused_epoch", "--save_dir", os.path.join(tmp, "fused")])
    cfg, name = cli.load_config(args)
    cfg.output.save_epoch_every_num_epochs = 10
    train_set, val_set = cli.build_datasets(cfg, args)
    lda, data = cfg.latent_DA, cfg.data

    # 1. every branch tuple captured into one pool, each held to a twin
    #    capturable trainer's eager step on the same draws
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainers = [cli.build_trainer(cfg, args) for _ in range(2)]
    batcher = CooperativeBatcher(train_set, cfg.learning.batch_size, data.data_aug_policy,
                                 data.pad_hw, data.crop_hw, keep_orig=True, seed=args.seed,
                                 device="cuda")
    graphs = StepGraphs(trainers[0], batcher.pipeline_idx, *batcher.device_dataset())
    eager = StepGraphs(trainers[1], batcher.pipeline_idx, *batcher.device_dataset())
    torch.cuda.synchronize()
    gen = torch.Generator().manual_seed(args.seed)
    pairs, configs = [], []
    for image_type in MASK_TYPES:
        for shape_type in MASK_TYPES:
            forced = LatentDAConfig(image_code=MaskConfig("mse", image_type),
                                    shape_code=MaskConfig("ce", shape_type))
            for _ in range(2):  # eager and captured, then replayed
                pairs.append((draw_augment(gen, batcher.policy, batcher.raw_bs, data.pad_hw),
                              draw_step(gen, batcher.step_batch, data.crop_hw, forced)))
                configs.append(forced)
    staged = StagedDraws(pairs, "cuda")
    idx = torch.from_numpy(np.stack([batcher.epoch_index_matrix()[0]
                                     for _ in range(len(pairs))])).to("cuda")
    got = torch.empty((len(pairs), 10), device="cuda")
    pool, peak = [], []
    for k, (s, forced) in enumerate(zip(staged.steps, configs)):
        for t in trainers:
            t.latent_da = forced
        graphs.run(idx[k], s, got[k])
        want = eager.body(idx[k], s.augment, s.step)
        if not torch.equal(got[k], want):
            raise AssertionError(f"graphed step {k} (branches {s.branches}): metrics "
                                 f"{got[k].tolist()}, eager {want.tolist()}")
        torch.cuda.synchronize()
        if k % 2 == 0:
            pool.append(pool_bytes(graphs.pool))
            peak.append(torch.cuda.max_memory_reserved())
    if not _same_state(torch, *trainers):
        raise AssertionError("the graphed trainer's state differs from the eager twin's")
    for key, captured in graphs.graphs.items():
        want = trainers[0].expected_launches({"image": key[0], "shape": key[1]})
        if {k: captured.launches[k] for k in want} != want:
            raise AssertionError(f"graph {key}: launches at capture {captured.launches}, "
                                 f"expected {want}")
    if len(graphs.graphs) != 9 or sum(graphs.replays.values()) != 9:
        raise AssertionError(f"{len(graphs.graphs)} graphs, replays {dict(graphs.replays)}")
    print(f"  9 branch tuples captured, each replayed once, bit for bit equal to the eager "
          f"twin's steps (metrics, parameters, BN buffers, Adam's step and moments); "
          f"launches at capture = expected_launches for all 9", flush=True)
    print("  capture s a graph: " + ", ".join(
        f"{key[:2]} {c.seconds:.3f}" for key, c in graphs.graphs.items()), flush=True)
    (r1, a1), (r9, a9) = pool[0], pool[-1]
    print(f"  the graphs' shared pool (its segments; GiB): {r1 / 2**30:.4f} reserved, "
          f"{a1 / 2**30:.4f} live with 1 graph; {r9 / 2**30:.4f}, {a9 / 2**30:.4f} with 9 "
          f"(ratio {r9 / r1:.4f}); the process's max_memory_reserved {peak[0] / 2**30:.4f} / "
          f"{peak[-1] / 2**30:.4f} GiB (the pool, plus the caches of the eager first steps "
          f"and the twin's steps)", flush=True)
    if not (0 < r1 and r9 < 2 * r1):
        raise AssertionError(f"the pool grew with the graphs: {pool}")

    part_done("captures")
    # 2. host ms a step to a synchronize: replays (random draws, every
    #    tuple already captured) against the twin's eager steps
    for t in trainers:
        t.latent_da = lda
    timed = stage_draws(GeneratorDraws(args.seed + 2), [0], FUSED_TIMED, batcher.policy,
                        batcher.raw_bs, data.pad_hw, batcher.step_batch, data.crop_hw, lda,
                        "cuda")
    times = {"graphed": [], "eager": []}
    out = torch.empty(10, device="cuda")
    for s in timed.steps:
        for key, fn in (("graphed", lambda: graphs.run(idx[0], s, out)),
                        ("eager", lambda: out.copy_(eager.body(idx[0], s.augment, s.step)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
    if len(graphs.graphs) != 9:
        raise AssertionError("a timed step captured a new graph")
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"  host ms a step to a synchronize, median of {FUSED_TIMED} (min, max): graphed "
          f"{med['graphed']:.3f} ({min(times['graphed']):.3f}, {max(times['graphed']):.3f}), "
          f"eager {med['eager']:.3f} ({min(times['eager']):.3f}, {max(times['eager']):.3f}); "
          f"{med['eager'] / med['graphed']:.2f}x", flush=True)

    part_done("timed steps")
    # 3. the protocol's epoch (its steps and one validation) in steady
    #    state, every tuple captured, in runs of STEADY_EPOCHS epochs: fused
    #    (staging, replays, validation, the read backs at each epoch's end),
    #    pipelined (the same, each epoch's results and state fetched by the
    #    driver's fetch_to_host and read after the next epoch is dispatched)
    #    and in 2-epoch windows, host clock; then a traced graphed epoch of
    #    FUSED_TRACED replays and the validation graph, and the same steps
    #    eager, traced, for their idle shares
    validate = ValidationGraph(trainers[0].model, *EvalBatcher(
        val_set, cfg.learning.batch_size, data.pad_hw, data.crop_hw, device="cuda"
    ).stacked_epoch(), pool=graphs.pool, stream=graphs.stream)
    confusion = torch.empty((4, 4), dtype=torch.int64, device="cuda")
    validate(confusion)
    window = WindowRunner(graphs.run_epoch, validate, trainers[0].model)
    nb = len(batcher)

    def stage(n_epochs, seed):
        return stage_draws(GeneratorDraws(seed), range(n_epochs), nb, batcher.policy,
                           batcher.raw_bs, data.pad_hw, batcher.step_batch, data.crop_hw, lda,
                           "cuda")

    def one_epoch(seed):
        metrics = graphs.run_epoch(batcher.epoch_index_matrix(), stage(1, seed).steps)
        return metrics, validate(torch.empty((4, 4), dtype=torch.int64, device="cuda"))

    def fused_epochs(seed):
        for e in range(STEADY_EPOCHS):
            metrics, conf = one_epoch(seed + e)
            metrics.cpu(), conf.cpu()

    def pipelined_epochs(seed):
        wait = None
        for e in range(STEADY_EPOCHS):
            metrics, conf = one_epoch(seed + e)
            fetched = fetch_to_host((metrics, conf, {
                name: getattr(trainers[0].model, name).state_dict() for name in MODULE_NAMES}))
            if wait is not None:
                wait()
            wait = fetched[0]
        wait()

    def windowed(seed):
        for e in range(0, STEADY_EPOCHS, 2):
            idx_mats = np.stack([batcher.epoch_index_matrix() for _ in range(2)])
            out = window(idx_mats, stage(2, seed + e).steps, -1e9)
            [out[k].cpu() for k in ("metrics", "confusion", "best_epoch")]

    modes = (("fused", fused_epochs), ("pipelined", pipelined_epochs), ("windowed", windowed))
    epoch_sec = {k: [] for k, _ in modes}
    for r in range(STEADY_RUNS):
        for key, fn in modes if r % 2 == 0 else modes[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(args.seed + 10 + r * STEADY_EPOCHS)
            torch.cuda.synchronize()
            epoch_sec[key].append((time.perf_counter() - t0) / STEADY_EPOCHS)
    if len(graphs.graphs) != 9:
        raise AssertionError("a steady-state epoch captured a new graph")
    med = {k: statistics.median(v) for k, v in epoch_sec.items()}
    print(f"  steady-state epoch s of the protocol ({nb} steps of batch "
          f"{batcher.step_batch}, validation of {len(val_set)} slices), runs of "
          f"{STEADY_EPOCHS} epochs, median of {STEADY_RUNS} runs (min, max): " + "; ".join(
              f"{k} {med[k]:.4f} ({min(v):.4f}, {max(v):.4f})" for k, v in epoch_sec.items())
          + f"; pipelined / fused {med['pipelined'] / med['fused']:.4f}", flush=True)
    traced = stage_draws(GeneratorDraws(args.seed + 3), [0], FUSED_TRACED, batcher.policy,
                         batcher.raw_bs, data.pad_hw, batcher.step_batch, data.crop_hw, lda,
                         "cuda")
    idx_mat = np.stack([batcher.epoch_index_matrix()[0] for _ in range(FUSED_TRACED)])
    runs = {"graphed": lambda: (graphs.run_epoch(idx_mat, traced.steps), validate(confusion)),
            "eager": lambda: [eager.body(idx[0], s.augment, s.step) for s in traced.steps]}
    part_done("steady epochs")
    for key, fn in runs.items():
        torch.cuda.synchronize()
        # the device's activity alone: the host's op events of thousands of
        # eager launches would take the profiler longer to sort than the run
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        by_group, _, _ = device_time(prof.key_averages())
        busy = sum(by_group.values()) / 1e6
        if busy == 0:
            print(f"  the profiler saw no device time ({key}): idle share not measured",
                  flush=True)
            continue
        print(f"  traced {key} epoch ({FUSED_TRACED} steps"
              f"{' and the validation graph' if key == 'graphed' else ''}): "
              f"{span * 1e3:.3f} ms on the host clock, device busy {busy * 1e3:.3f} ms "
              f"({busy * 1e3 / FUSED_TRACED:.3f} a step), idle share {1 - busy / span:.4f}; "
              f"by group (ms): " + ", ".join(
                  f"{g} {us / 1e3:.3f}" for g, us in sorted(by_group.items(),
                                                             key=lambda kv: -kv[1])),
              flush=True)
    if len(graphs.graphs) != 9:
        raise AssertionError("a traced step captured a new graph")
    counted = launched({k: w.launches for k, w in wrappers.items()}, [graphs, eager],
                       [validate])
    del graphs, eager, validate, window, trainers
    torch.cuda.empty_cache()

    part_done("traces")
    # 4. the loop through the command line: fused, pipelined, windowed, and
    #    the streaming loop of a capturable trainer, on the same draws
    def loop(tag, extra):
        a = cli.parse_args(argv + extra + ["--save_dir", os.path.join(tmp, tag)])
        c, n = cli.load_config(a)
        c.output.save_epoch_every_num_epochs = 10
        if "--fused_epoch" in extra:
            return cli.run(a, c, n)
        trainer = cli.build_trainer(c, cli.parse_args(argv + ["--fused_epoch"]))
        return cli.run_trainer(a, c, n, trainer, *cli.build_datasets(c, a))

    runs = {}
    for tag, extra in (("streaming", []), ("fused", ["--fused_epoch"]),
                       ("pipelined", ["--fused_epoch", "--pipeline_epoch"]),
                       ("windowed", ["--fused_epoch", "--multi_epoch", "2"])):
        before = {k: w.launches for k, w in wrappers.items()}
        t0 = time.perf_counter()
        trainer, result = loop(tag, extra)
        torch.cuda.synchronize()
        runs[tag] = (trainer, result, time.perf_counter() - t0,
                     {k: w.launches - before[k] for k, w in wrappers.items()})
        torch.cuda.empty_cache()
    s_tr, s_res = runs["streaming"][:2]
    for tag in ("fused", "pipelined", "windowed"):
        trainer, result = runs[tag][:2]
        if [e.epoch for e in result.epochs] != list(range(FUSED_EPOCHS)):
            raise AssertionError(f"{tag}: epochs {[e.epoch for e in result.epochs]}")
        for a, b in zip(s_res.epochs, result.epochs):
            if not (np.array_equal(a.losses, b.losses) and np.array_equal(a.confusion,
                                                                          b.confusion)):
                raise AssertionError(f"{tag} epoch {b.epoch}: losses or confusion differ from "
                                     f"the streaming loop's")
        if (result.best_epoch, result.best_score) != (s_res.best_epoch, s_res.best_score):
            raise AssertionError(f"{tag}: best {result.best_epoch} {result.best_score}, "
                                 f"streaming {s_res.best_epoch} {s_res.best_score}")
        if not _same_state(torch, s_tr, trainer):
            raise AssertionError(f"{tag}: the state differs from the streaming loop's")
        for key, captured in result.graphs.graphs.items():
            want = trainer.expected_launches({"image": key[0], "shape": key[1]})
            if {k: captured.launches[k] for k in want} != want:
                raise AssertionError(f"{tag} graph {key}: launches {captured.launches}")
    print(f"  {FUSED_EPOCHS} epochs through cli.train: fused, pipelined (--pipeline_epoch) and "
          f"windowed (--multi_epoch 2) bit for bit equal to the streaming loop of a capturable "
          f"trainer on the same draws (losses, confusion matrices, best epoch and score, "
          f"parameters, BN buffers, Adam)", flush=True)
    for tag, (trainer, result, sec, got) in runs.items():
        g = result.graphs
        captures = ", ".join(f"{c.seconds:.3f}" for c in g.graphs.values()) if g else ""
        extra = "" if g is None else (
            f"; {len(g.graphs)} graphs captured ({captures} s), "
            f"{sum(g.replays.values())} step replays, {result.validation.replays} validation "
            f"replays, {g.eager_steps} eager steps")
        print(f"  {tag}: {sec:.3f} s in all; epoch s (train + val): " + ", ".join(
            f"{e.train_sec + e.val_sec:.4f}" for e in result.epochs)
            + f"; draws {', '.join(f'{e.draw_sec * 1e3:.3f}' for e in result.epochs)} ms"
            + extra, flush=True)
        got = launched(got, [] if g is None else [g],
                       [] if result.validation is None else [result.validation])
        for k in counted:
            counted[k] += got[k]
    part_done("loops")
    if any(counted[k] == 0 for k in LAUNCH_COUNTERS[:4]):
        raise AssertionError(f"the fused phase did not launch K1, K1 dx, K2 and K3: {counted}")
    print("  launches on the card over the phase (eager steps, and each graph's counts once "
          "a replay): " + ", ".join(f"{k} {counted[k]}" for k in LAUNCH_COUNTERS[:4]),
          flush=True)
    print(f"  {smi}", flush=True)
    return counted


# phase 7b's arms: cli.train flags of the step's and the augmentation's arms
ARMS = {
    "sequential": [],
    "fused_stn": ["--fused_stn"],
    "fused_ftn": ["--fused_ftn"],
    "sequential conv_s2+conv_nl": ["--conv_s2", "--conv_nl"],
    "fused_ftn conv_s2+conv_nl": ["--fused_ftn", "--conv_s2", "--conv_nl"],
    "warp two_gather": ["--warp", "two_gather"],
    "warp sequential": ["--warp", "sequential"],
}
ARM_TIMED = 3         # replays (and twin eager steps) timed after the capture
ARM_TRACED = 2        # replays traced for the device time


def arms_phase(torch, wrappers, tmp):
    """Phase 7b (see the module docstring).  Returns the launches by
    wrapper the card made (``launched``: eager steps, and each graph's
    counts once a replay)."""
    import numpy as np

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
        LatentDAConfig,
        MaskConfig,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
        CooperativeBatcher,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.augment import (
        draw_augment,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
        device_time,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
        StagedDraws,
        draw_step,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
        StepGraphs,
        launched,
        pool_bytes,
    )
    from torch.profiler import ProfilerActivity, profile

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), LOOP_CONFIG)
    forced = LatentDAConfig(image_code=MaskConfig("mse", "channel"),
                            shape_code=MaskConfig("ce", "spatial"))
    total = dict.fromkeys(LAUNCH_COUNTERS, 0)
    for arm, flags in ARMS.items():
        for w in wrappers.values():
            w.launches = 0
        args = cli.parse_args(["--json_config_path", config, "--synthetic", "--bf16",
                               "--fused_epoch", "--save_dir", tmp] + flags)
        cfg, _ = cli.load_config(args)
        data = cfg.data
        train_set, _ = cli.build_datasets(cfg, args)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainers = [cli.build_trainer(cfg, args) for _ in range(2)]
        for t in trainers:
            t.latent_da = forced
        batcher = CooperativeBatcher(train_set, cfg.learning.batch_size, data.data_aug_policy,
                                     data.pad_hw, data.crop_hw, keep_orig=True, seed=args.seed,
                                     device="cuda", warp=args.warp)
        graphs = StepGraphs(trainers[0], batcher.pipeline_idx, *batcher.device_dataset())
        eager = StepGraphs(trainers[1], batcher.pipeline_idx, *batcher.device_dataset())
        gen = torch.Generator().manual_seed(args.seed)
        n = 1 + ARM_TIMED + ARM_TRACED
        staged = StagedDraws([(draw_augment(gen, batcher.policy, batcher.raw_bs, data.pad_hw),
                               draw_step(gen, batcher.step_batch, data.crop_hw, forced))
                              for _ in range(n)], "cuda")
        idx = torch.from_numpy(np.stack([batcher.epoch_index_matrix()[0]] * n)).to("cuda")
        got = torch.empty((n, 10), device="cuda")
        times = {"graphed": [], "eager": []}
        for k, st in enumerate(staged.steps[:1 + ARM_TIMED]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graphs.run(idx[k], st, got[k])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = eager.body(idx[k], st.augment, st.step)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if k:
                times["graphed"].append((t1 - t0) * 1e3)
                times["eager"].append((t2 - t1) * 1e3)
            if not torch.equal(got[k], want):
                raise AssertionError(f"{arm}: replayed step {k} {got[k].tolist()}, eager "
                                     f"{want.tolist()}")
        if not _same_state(torch, *trainers):
            raise AssertionError(f"{arm}: the graphed trainer's state differs from the twin's")
        if len(graphs.graphs) != 1:
            raise AssertionError(f"{arm}: {len(graphs.graphs)} graphs for one branch tuple")
        (key, captured), = graphs.graphs.items()
        want_l = trainers[0].expected_launches({"image": key[0], "shape": key[1]})
        if {k: captured.launches[k] for k in want_l} != want_l:
            raise AssertionError(f"{arm}: launches at capture {captured.launches}, expected "
                                 f"{want_l}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for k in range(1 + ARM_TIMED, n):
                graphs.run(idx[k], staged.steps[k], got[k])
            torch.cuda.synchronize()
        by_group, _, _ = device_time(prof.key_averages())
        device = sum(by_group.values()) / 1e3 / ARM_TRACED
        if not device > 0:
            raise AssertionError(f"{arm}: the profiler saw no device time in the replays")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{arm}: non-finite metrics {got.tolist()}")
        reserved, live = pool_bytes(graphs.pool)
        card = launched({k: w.launches for k, w in wrappers.items()}, [graphs])
        for k in LAUNCH_COUNTERS:
            total[k] += card.get(k, 0)
        t = trainers[0]
        print(f"  {arm} (fused_stn {t.fused_stn}, fused_ftn {t.fused_ftn}, warp {args.warp}): "
              f"{ARM_TIMED} replays bit for bit equal to the twin's eager steps, state equal, "
              f"launches at capture = expected_launches ({want_l['conv3x3_chw']} K1, "
              f"{want_l['conv3x3_chw_dx']} K1 dx, {want_l['conv3x3_chw_dw']} K2); host ms a "
              f"step, median: graphed {statistics.median(times['graphed']):.3f}, eager "
              f"{statistics.median(times['eager']):.3f}; device ms a replayed step "
              f"{device:.3f}; capture {captured.seconds:.3f} s; pool {reserved / 2**30:.4f} "
              f"GiB reserved ({live / 2**30:.4f} live), process peak reserved "
              f"{torch.cuda.max_memory_reserved() / 2**30:.4f} GiB", flush=True)
        del t, captured, trainers, graphs, eager, batcher, staged, got
        torch.cuda.empty_cache()
    return total


DET_EPOCHS = 2
DET_STEPS = 2         # eager steps of a turn timed on the host clock


def determinism_phase(torch, wrappers, cfg, coop, draws_mod, image, label, tmp):
    """Phase 9b (see the module docstring).  Returns the launches by
    wrapper over the phase."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
        device_time,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import driver
    from torch.profiler import ProfilerActivity, profile

    for w in wrappers.values():
        w.launches = 0
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), LOOP_CONFIG)
    runs = []
    for r in range(2):
        save = os.path.join(tmp, f"determinism{r}")
        args = cli.parse_args(["--json_config_path", config, "--synthetic", "--bf16",
                               "--max_epochs", str(DET_EPOCHS), "--save_dir", save, "--log"])
        c, name = cli.load_config(args)
        t0 = time.perf_counter()
        trainer, result = cli.run(args, c, name)
        sec = time.perf_counter() - t0
        log_dir, model_dir = driver.experiment_dirs(save, c.data.dataset_name,
                                                    args.data_setting, c.data.num_classes,
                                                    name, args.cval)
        with open(os.path.join(log_dir, "scalars.jsonl")) as f:
            logged = [(row["step"], row["tag"], row["value"]) for row in map(json.loads, f)
                      if row["tag"].startswith(("loss/", "iou/", "acc/"))]
        files = {}
        for root, _, names in os.walk(model_dir):
            for fname in names:
                if fname.endswith(".pth"):
                    path = os.path.join(root, fname)
                    files[os.path.relpath(path, model_dir)] = torch.load(
                        path, map_location="cpu", weights_only=True)
        runs.append((logged, files, sec))
        del trainer
    (log_a, files_a, sec_a), (log_b, files_b, sec_b) = runs
    if log_a != log_b or not log_a:
        raise AssertionError(f"two runs of one seed logged other numbers: {log_a} {log_b}")
    if sorted(files_a) != sorted(files_b) or not files_a:
        raise AssertionError(f"two runs wrote other files: {sorted(files_a)} {sorted(files_b)}")
    for rel, sd in files_a.items():
        if not _same_tree(torch, sd, files_b[rel]):
            raise AssertionError(f"{rel} differs between two runs of one seed")
    print(f"  two streaming runs of seed 40 through cli.train, {DET_EPOCHS} epochs ({sec_a:.2f} "
          f"and {sec_b:.2f} s): {len(log_a)} logged losses, IoUs and accuracies identical, "
          f"{len(files_a)} .pth files holding identical tensors", flush=True)
    launches = {k: w.launches for k, w in wrappers.items()}
    for w in wrappers.values():
        w.launches = 0

    # the eager step before and after every card step ran on deterministic
    # cuDNN: cuDNN's default algorithms by a no-op deterministic_cudnn.  Each
    # turn: a warm step, DET_STEPS steps to a synchronize on the host clock,
    # then one traced step (the device's kernels only) for its device ms
    lda = cfg.LatentDAConfig(image_code=cfg.MaskConfig("mse", "channel"),
                             shape_code=cfg.MaskConfig("ce", "spatial"))
    img, lbl = torch.from_numpy(image).to("cuda"), torch.from_numpy(label).to("cuda")
    deterministic = coop.deterministic_cudnn
    for route, kw in (("default", {}), ("conv_s2", {"conv_s2": True}),
                      ("conv_nl", {"conv_nl": True})):
        trainer = coop.CooperativeTrainer(lda, compute_dtype=torch.bfloat16, device="cuda",
                                          seed=0, **kw)
        draws = draws_mod.draw_step(torch.Generator().manual_seed(3), TRAIN_BATCH, (192, 192),
                                    lda, device="cuda")
        dev, host = {}, {}
        # each turn warmed first (its algorithms chosen), then timed
        for turn in ("default", "deterministic"):
            coop.deterministic_cudnn = (deterministic if turn == "deterministic"
                                        else lambda on: nullcontext())
            try:
                trainer.train_step(img, lbl, draws)
                host[turn] = []
                for _ in range(DET_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.train_step(img, lbl, draws)
                    torch.cuda.synchronize()
                    host[turn].append((time.perf_counter() - t0) * 1e3)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    trainer.train_step(img, lbl, draws)
                    torch.cuda.synchronize()
            finally:
                coop.deterministic_cudnn = deterministic
            by_group, _, _ = device_time(prof.key_averages())
            dev[turn] = sum(by_group.values()) / 1e3
        if not all(v > 0 for v in dev.values()):
            raise AssertionError(f"{route}: the profiler saw no device time: {dev}")
        print(f"  {route} eager step, bf16 batch {TRAIN_BATCH} (channel/spatial masks), device "
              f"ms a step: cuDNN default {dev['default']:.3f}, deterministic "
              f"{dev['deterministic']:.3f} ({dev['deterministic'] - dev['default']:+.3f} ms); "
              f"host ms to a synchronize, median of {DET_STEPS}: default "
              f"{statistics.median(host['default']):.3f}, deterministic "
              f"{statistics.median(host['deterministic']):.3f}", flush=True)
        for k in LAUNCH_COUNTERS:
            launches[k] += wrappers[k].launches
        for w in wrappers.values():
            w.launches = 0
        del trainer
        torch.cuda.empty_cache()
    return launches


def eval_phase(torch, wrappers, predict_k1, best_dir, tmp, smi):
    """The eval phase (see the module docstring): the loop's best checkpoint
    ``best_dir`` evaluated on a synthetic tree written under ``tmp``.
    ``predict_k1(model)``: K1 launches of one ``predict(n_iter=2)``.
    Returns the launches by wrapper over the evaluation."""
    import csv

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        make_synthetic_acdc,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        test as cli_test,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.splits import (
        TEST_LIST,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.tester import (
        TestSegmentationNetwork,
    )

    tree, out = os.path.join(tmp, "synthetic_ACDC"), os.path.join(tmp, "eval")
    t0 = time.perf_counter()
    make_synthetic_acdc.main(["--out_root", tree, "--pids", *TEST_LIST,
                              "--n_slices", str(EVAL_SLICES)])
    write_sec = time.perf_counter() - t0
    argv = ["--checkpoint", best_dir, "--acdc_root", tree, "--n_iter", str(N_ITER),
            "--save_dir", out]
    args = cli_test.parse_args(argv)
    predictor = cli_test.load_predictor(args)
    # the predicts' share of the host clock: each call timed to its end
    predict, predict_sec = predictor.predict, []

    def timed_predict(x, **kw):
        t = time.perf_counter()
        out = predict(x, **kw)
        torch.cuda.synchronize()
        predict_sec.append(time.perf_counter() - t)
        return out

    predictor.predict = timed_predict
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    results = cli_test.run(args, predictor)
    torch.cuda.synchronize()
    eval_sec = time.perf_counter() - t0
    del predictor.predict
    got = {k: w.launches for k, w in wrappers.items()}
    with open(os.path.join(out, "ACDC", "detail.csv"), newline="") as f:
        header, *rows = list(csv.reader(f))
    n_volumes = 2 * len(TEST_LIST)
    if header != ["patient_id", "LV_Dice", "MYO_Dice", "RV_Dice"] or len(rows) != n_volumes:
        raise AssertionError(f"detail.csv: {header}, {len(rows)} rows, want {n_volumes}")
    card = {r[0]: [float(v) for v in r[1:]] for r in rows}
    if not all(math.isfinite(v) for dice in card.values() for v in dice):
        raise AssertionError(f"a Dice is not finite: {card}")
    chunks = n_volumes * -(-EVAL_SLICES // EVAL_CHUNK)
    per_chunk = predict_k1(predictor)
    want = dict.fromkeys(LAUNCH_COUNTERS, 0)
    want["conv3x3_chw"] = chunks * per_chunk
    if got != want:
        raise AssertionError(f"launches over the evaluation {got}, expected {want}")
    # EVAL_CPU_VOLUMES volumes again on the CPU: the plain versions, the same
    # checkpoint and preprocessing
    cpu_args = cli_test.parse_args(argv[:-2] + ["--device", "cpu"])
    cpu = cli_test.load_predictor(cpu_args)
    dataset = cli_test.build_datasets(cpu_args, cpu_args.cval)["ACDC"]
    tester = TestSegmentationNetwork(dataset, lambda x: cpu.predict(x, n_iter=N_ITER),
                                     chunk_size=EVAL_CHUNK, device="cpu")
    gaps = []
    for i in range(EVAL_CPU_VOLUMES):
        img, gt = dataset.get_patient_data_for_testing(i)
        pred = tester.predict_volume(img).argmax(dim=-1).to(torch.int32).numpy()
        row = tester.metric.update(dataset.get_id(i), pred, gt,
                                   voxel_spacing=dataset.get_voxel_spacing(i))
        gaps += [abs(a - b) for a, b in zip(row[1:], card[row[0]])]
        print(f"  {row[0]}: Dice card {card[row[0]]}, CPU {[float(v) for v in row[1:]]}",
              flush=True)
    gap = max(gaps)
    print(f"  eval: {n_volumes} volumes of {EVAL_SLICES} slices from the loop's best "
          f"checkpoint, float32, predict(n_iter={N_ITER}): {eval_sec:.3f} s, "
          f"{eval_sec / n_volumes:.4f} s a volume (host clock: reading, preprocessing, "
          f"prediction, metrics), of which predict {sum(predict_sec):.3f} s in "
          f"{len(predict_sec)} calls (median {statistics.median(predict_sec) * 1e3:.3f} ms, "
          f"first {predict_sec[0] * 1e3:.3f} ms; each to a synchronize); writing the tree "
          f"{write_sec:.3f} s; K1 launches "
          f"{got['conv3x3_chw']} over {chunks} chunks of {EVAL_CHUNK} slices, "
          f"{got['conv3x3_chw'] / chunks:g} a chunk; mean Dice " + ", ".join(
              f"{k} {v:.4f}" for k, v in results["ACDC"].items() if k.endswith("_mean"))
          + f"; card against CPU on {EVAL_CPU_VOLUMES} volumes: largest class-volume "
          f"Dice gap {gap:.6f} (bound {EVAL_DICE_ATOL}); {smi}", flush=True)
    if not gap <= EVAL_DICE_ATOL:
        raise AssertionError(f"card against CPU Dice gap {gap} > {EVAL_DICE_ATOL}")
    return got


DDP_RANKS = 2          # data-parallel ranks sharing the one card (gloo)
DDP_EPOCHS = 2         # cli.train epochs over the ranks, then one more by --resume_orbax
DDP_TRAIN_SLICES = 10  # their synthetic training slices: one step of 20 an epoch


def _state_hashes(torch, trainer):
    """sha256 of the parameters, the BN buffers and Adam's moments, in order."""
    import hashlib

    h = hashlib.sha256()
    tensors = list(trainer.model.state_dict().values())
    for p in trainer.model.parameters():
        st = trainer.optimizer.state.get(p, {})
        tensors += [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st]
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _flat_state(torch, trainer):
    """(parameters, running statistics, Adam's exp_avg, exp_avg_sq), each
    one flat float32 host tensor in module order."""
    sd = trainer.model.state_dict()
    params = [v for k, v in sd.items() if "running_" not in k and v.is_floating_point()]
    stats = [v for k, v in sd.items() if "running_" in k]
    mu = [trainer.optimizer.state[p]["exp_avg"] for p in trainer.model.parameters()]
    nu = [trainer.optimizer.state[p]["exp_avg_sq"] for p in trainer.model.parameters()]
    return tuple(torch.cat([t.detach().float().reshape(-1) for t in ts]).cpu()
                 for ts in (params, stats, mu, nu))


def ddp_rank(mesh, state_dicts, image, label, plan, timed_draws, cli_run):
    """One rank of the ddp phase: :func:`ddp_rank_steps`, then its part of
    ``cli.train``'s run ``cli_run`` (args, configuration, name) by
    :func:`ddp_cli_rank`, in one start of the ranks."""
    return (ddp_rank_steps(mesh, state_dicts, image, label, plan, timed_draws),
            ddp_cli_rank(mesh, *cli_run))


def ddp_rank_steps(mesh, state_dicts, image, label, plan, timed_draws):
    """The ddp phase's steps on one rank: a bf16 trainer from
    ``state_dicts`` put in data-parallel mode, one step for each (mask
    type, global draws) of ``plan`` on this rank's rows, each step's
    launches held to ``expected_launches``; then a ``random`` step timed
    with ``mesh.timed`` (host ms to a synchronize, the seconds inside
    collectives) and one traced (device busy ms).  Returns per step (the
    metrics, the state hash, rank 0's flat state), the launches over all
    its steps, and the timings."""
    import torch

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import config as cfg
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        percentile_mask as pmask,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel.mesh import (
        shard_train_step,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
        device_time,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
        CooperativeTrainer,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
        shard_draws,
    )

    wrappers = wrappers_of(conv_chw, pmask)
    trainer = CooperativeTrainer(cfg.LatentDAConfig(), compute_dtype=torch.bfloat16,
                                 device=mesh.device, seed=0)
    trainer.model.load_state_dicts(state_dicts)
    shard_train_step(trainer, mesh)
    img = mesh.rows(torch.from_numpy(image)).to(mesh.device)
    lbl = mesh.rows(torch.from_numpy(label)).to(mesh.device)

    def step(mask_type, draws):
        trainer.latent_da = cfg.LatentDAConfig(image_code=cfg.MaskConfig("mse", mask_type),
                                               shape_code=cfg.MaskConfig("ce", mask_type))
        before = {k: w.launches for k, w in wrappers.items()}
        metrics = trainer.train_step(img, lbl, shard_draws(draws, mesh).to(mesh.device))
        got = {k: w.launches - before[k] for k, w in wrappers.items()}
        branches = {"image": draws.image.branch, "shape": draws.shape.branch}
        want = {**dict.fromkeys(LAUNCH_COUNTERS, 0), **trainer.expected_launches(branches)}
        if got != want:
            raise AssertionError(f"rank {mesh.rank}, {mask_type} step at batch {img.shape[0]}: "
                                 f"launches {got}, expected {want}")
        return {k: float(v) for k, v in metrics.items()}

    for w in wrappers.values():
        w.launches = 0
    steps = []
    for mask_type, draws in plan:
        metrics = step(mask_type, draws)
        steps.append((metrics, _state_hashes(torch, trainer),
                      _flat_state(torch, trainer) if mesh.rank == 0 else None))
    torch.cuda.synchronize()
    mesh.timed, mesh.calls, mesh.seconds = True, 0, 0.0
    t0 = time.perf_counter()
    step("random", timed_draws[0])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    timing = {"host_ms": host_ms, "collective_ms": mesh.seconds * 1e3, "calls": mesh.calls}
    mesh.timed = False
    from torch.profiler import ProfilerActivity, profile

    busy = None
    for _ in range(3):  # a session now and then delivers no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step("random", timed_draws[1])
            torch.cuda.synchronize()
        by_group, _, _ = device_time(prof.key_averages())
        if by_group:
            busy = sum(by_group.values()) / 1e3
            break
    timing["device_ms"] = busy
    return steps, {k: w.launches for k, w in wrappers.items()}, timing


def ddp_cli_rank(mesh, args, cfg, name):
    """One rank of ``cli.train --n_devices``'s run (``cli.train.train_rank``),
    with the launch counts set to 0 just before and read just after."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        percentile_mask as pmask,
    )

    wrappers = wrappers_of(conv_chw, pmask)
    for w in wrappers.values():
        w.launches = 0
    result = cli.train_rank(mesh, args, cfg, name)
    return result, {k: w.launches for k, w in wrappers.items()}


def ddp_phase(torch, F, conv_chw, pmask, wrappers, predict_k1, k1_shapes, tmp, smi):
    """The ddp phase (see the module docstring).  Returns (the launches by
    wrapper over the ranks' steps and runs, the kernel checks at the
    rank's batch by wrapper)."""
    import numpy as np

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import config as cfg
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        phantom_batch,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel import mesh
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
        CooperativeTrainer,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
        draw_step,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
        MODULE_NAMES,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import (
        checkpoint as whole,
    )

    t0 = time.perf_counter()
    b = TRAIN_BATCH // DDP_RANKS
    # K1, K1 dx, K2 and K3 at the rank's batch, against their plain versions
    checks = {"conv3x3_chw": [], "conv3x3_chw_dx": [], "conv3x3_chw_dw": [],
              "percentile_mask": []}
    for which, name in (("fwd", "conv3x3_chw"), ("dx", "conv3x3_chw_dx"),
                        ("dw", "conv3x3_chw_dw")):
        checks[name] = [check_conv(torch, F, conv_chw, conv_chw, "chw", which, sh, b, "bfloat16")
                        for sh in k1_shapes if which != "dx" or sh[0] > 1]
    checks["percentile_mask"] = [check_k3(torch, pmask, b, d, soft) for d in (128, 144)
                                 for soft in (False, True)]
    bad = [r for rs in checks.values() for r in rs if not r["ok"]]
    if bad:
        raise AssertionError(f"a kernel disagrees with its plain version at N = {b}: {bad}")
    print(f"  K1, K1 dx, K2 ({sum(len(checks[k]) for k in LAUNCH_COUNTERS[:3])} shapes) and "
          f"K3 (4) at N = {b} within tolerance; largest errors "
          + ", ".join(f"{k} {max(r['max_abs_err'] for r in v):.3g}" for k, v in checks.items()),
          flush=True)

    # the data-parallel steps against one process on the whole batch
    image, label = phantom_batch(seed=7, n=TRAIN_BATCH)
    gen = torch.Generator().manual_seed(5)
    plan = []
    for mask_type in MASK_TYPES:
        lda = cfg.LatentDAConfig(image_code=cfg.MaskConfig("mse", mask_type),
                                 shape_code=cfg.MaskConfig("ce", mask_type))
        plan.append((mask_type, draw_step(gen, TRAIN_BATCH, (192, 192), lda)))
    timed_draws = [draw_step(gen, TRAIN_BATCH, (192, 192), cfg.LatentDAConfig())
                   for _ in range(2)]
    start = CooperativeTrainer(cfg.LatentDAConfig(), compute_dtype=torch.bfloat16,
                               device="cuda", seed=0)
    sd = {n: {k: v.cpu() for k, v in getattr(start.model, n).state_dict().items()}
          for n in MODULE_NAMES}
    del start
    # cli.train over the ranks (run in the same start of the ranks as the
    # steps), then one epoch more from the whole-state checkpoint
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), LOOP_CONFIG)
    save_dir = os.path.join(tmp, "ddp")
    argv = ["--json_config_path", config, "--synthetic", "--synthetic_train_length",
            str(DDP_TRAIN_SLICES), "--bf16", "--n_devices", str(DDP_RANKS), "--save_dir",
            save_dir, "--log"]
    args = cli.parse_args(argv + ["--max_epochs", str(DDP_EPOCHS)])
    conf, name = cli.load_config(args)
    conf.output.save_epoch_every_num_epochs = 1
    t_ranks = time.perf_counter()
    both = mesh.launch(ddp_rank, DDP_RANKS, "cuda",
                       args=(sd, image, label, plan, timed_draws, (args, conf, name)))
    ranks_sec = time.perf_counter() - t_ranks
    ranks, first = [r[0] for r in both], [r[1] for r in both]
    twins = {}
    for dtype in (torch.bfloat16, None):
        twin = CooperativeTrainer(cfg.LatentDAConfig(), compute_dtype=dtype, device="cuda",
                                  seed=0)
        twin.model.load_state_dicts(sd)
        img, lbl = torch.from_numpy(image).to("cuda"), torch.from_numpy(label).to("cuda")
        twins[dtype] = []
        for mask_type, draws in plan:
            twin.latent_da = cfg.LatentDAConfig(image_code=cfg.MaskConfig("mse", mask_type),
                                                shape_code=cfg.MaskConfig("ce", mask_type))
            m = twin.train_step(img, lbl, draws.to("cuda"))
            twins[dtype].append(({k: float(v) for k, v in m.items()},
                                 _flat_state(torch, twin)))
        del twin
    torch.cuda.empty_cache()
    labels = ("losses", "parameters", "running statistics", "Adam exp_avg", "Adam exp_avg_sq")
    for i, (mask_type, _) in enumerate(plan):
        (m0, h0, flat), (m1, h1, _) = ranks[0][0][i], ranks[1][0][i]
        if h0 != h1 or m0 != m1:
            raise AssertionError(f"step {i}: the ranks' states or metrics differ")
        one, one32 = twins[torch.bfloat16][i], twins[None][i]
        keys = sorted(one[0])
        got = [torch.tensor([m0[k] for k in keys])] + list(flat)
        want = [torch.tensor([one[0][k] for k in keys])] + list(one[1])
        f32 = [torch.tensor([one32[0][k] for k in keys])] + list(one32[1])
        worst = []
        for what, g, w, w32 in zip(labels, got, want, f32):
            diff, own = (g - w).abs(), (w - w32).abs()
            ok = (diff.max() <= 2 * own.max()) and (diff.mean() <= 2 * own.mean())
            worst.append(f"{what} {diff.max().item():.3g} / {diff.mean().item():.3g} "
                         f"(bf16 vs f32 {own.max().item():.3g} / {own.mean().item():.3g})")
            if not ok:
                raise AssertionError(f"ddp step {i} ({mask_type}): {what} {diff.max().item()} "
                                     f"max, {diff.mean().item()} mean from one process; bf16 "
                                     f"itself costs {own.max().item()}, {own.mean().item()}")
        print(f"  step {i} ({mask_type} on both codes), {DDP_RANKS} ranks of {b} against one "
              f"process of {TRAIN_BATCH}, max / mean: " + "; ".join(worst), flush=True)
    timing = [r[2] for r in ranks]
    step_launches = Counter()
    for r in ranks:
        step_launches.update(r[1])
    for rank, t in enumerate(timing):
        share = t["collective_ms"] / t["host_ms"]
        print(f"  rank {rank}: a random step of {b}, {t['host_ms']:.3f} host ms to a "
              f"synchronize, {t['collective_ms']:.3f} ms in {t['calls']} collectives (each "
              f"after a device synchronize): all-reduce share {share:.4f}; device busy "
              f"{fmt(t['device_ms'])} ms (the profiler)", flush=True)
    print(f"  backend gloo, {DDP_RANKS} ranks on one card ({smi}); the ranks' steps and "
          f"first cli.train run {ranks_sec:.1f} s with their start", flush=True)
    t_cli = time.perf_counter()
    resumed = mesh.launch(ddp_cli_rank, DDP_RANKS, "cuda", args=(
        cli.parse_args(argv + ["--max_epochs", str(DDP_EPOCHS + 1), "--resume_orbax"]),
        conf, name))
    cli_sec = time.perf_counter() - t_cli
    epochs = [[[e.epoch for e in r.epochs] for r, _ in run] for run in (first, resumed)]
    if epochs != [[list(range(DDP_EPOCHS))] * DDP_RANKS, [[DDP_EPOCHS]] * DDP_RANKS]:
        raise AssertionError(f"epochs run by the ranks {epochs}")
    for run in (first, resumed):
        (r0, _), (r1, _) = run
        if r1.written or not r0.written:
            raise AssertionError(f"rank 0 wrote {len(r0.written)} files, rank 1 {r1.written}")
        for a, c in zip(r0.epochs, r1.epochs):
            if not (np.array_equal(a.losses, c.losses) and np.array_equal(a.confusion,
                                                                          c.confusion)):
                raise AssertionError(f"the ranks logged other numbers at epoch {a.epoch}")
    on_disk = {os.path.join(d, f) for d, _, fs in os.walk(save_dir) for f in fs}
    writes = first[0][0].written + resumed[0][0].written
    stray = [p for p in on_disk if not any(p == w or p.startswith(w + os.sep) for w in writes)]
    if stray:
        raise AssertionError(f"files no rank 0 write accounts for: {stray}")
    _, model_dir = cli.experiment_dirs(save_dir, conf.data.dataset_name, args.data_setting,
                                       conf.data.num_classes, name, args.cval)
    steps = whole.all_steps(os.path.join(model_dir, "orbax"))
    if steps != list(range(DDP_EPOCHS + 1)):
        raise AssertionError(f"whole-state checkpoints of steps {steps}")
    # every launch of the runs: each rank's steps at its batch and its predicts
    probe = cli.build_trainer(conf, args)  # the ranks' trainer, for its launch counts
    _, val_set = cli.build_datasets(conf, args)
    n_val = -(-len(val_set) // conf.learning.batch_size)
    cli_launches = Counter()
    for run in (first, resumed):
        for result, got in run:
            want = Counter()
            for e in result.epochs:
                for branches in e.branches:
                    want.update(probe.expected_launches(branches))
            want["conv3x3_chw"] += len(result.epochs) * n_val * predict_k1(probe.model)
            want = {k: want.get(k, 0) for k in LAUNCH_COUNTERS}
            if got != want:
                raise AssertionError(f"a rank's launches over cli.train {got}, expected {want}")
            cli_launches.update(got)
    print(f"  cli.train --n_devices {DDP_RANKS}: epochs {epochs[0][0]}, then --resume_orbax "
          f"epoch {epochs[1][0]} (whole-state steps {steps}); rank 0 wrote "
          f"{len(writes)} files and directories, rank 1 none; {cli_sec:.1f} s for the resumed "
          f"run with its start",
          flush=True)
    launches = {k: step_launches[k] + cli_launches[k] for k in LAUNCH_COUNTERS}
    if any(launches[k] == 0 for k in LAUNCH_COUNTERS[:4]):
        raise AssertionError(f"the ranks did not launch K1, K1 dx, K2 and K3: {launches}")
    print(f"  launches over the phase's ranks: {launches}; phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches, checks


def _corrupted_average(rows, method):
    """Mean over the four corruption subsets of the LV, MYO and RV Dice
    means of ``method`` in an aggregated table's rows."""
    vals = [r[3] for r in rows if r[0] != "ACDC" and r[1] == method]
    return sum(vals) / len(vals)


def robustness_phase(torch, wrappers, predict_k1, tmp, smi):
    """The robustness phase (see the module docstring), under the directory
    ``tmp``.  ``predict_k1(model)``: K1 launches of one ``predict(n_iter=2)``.
    Returns the launches by wrapper over the phase."""
    import csv

    import numpy as np

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        generate_acdc_c,
        make_synthetic_acdc,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        test as cli_test,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        train as cli_train,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
        EvalBatcher,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
        read_nrrd,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.splits import (
        TEST_LIST,
        get_ACDC_split_policy,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import corruptions

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, "robustness")
    tree, acdc_c, runs = (os.path.join(root, d) for d in ("ACDC", "ACDC-C", "runs"))
    policy = get_ACDC_split_policy("10", 0)
    test_pids = TEST_LIST[:ROBUST_TEST_PIDS]
    secs, launches = {}, Counter()

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def read():
        return {k: w.launches for k, w in wrappers.items()}

    t0 = time.perf_counter()
    make_synthetic_acdc.main(["--out_root", tree, "--pids", *policy["train"],
                              *policy["validate"], *test_pids, "--n_slices", str(EVAL_SLICES)])
    secs["writing the tree"] = time.perf_counter() - t0

    # both methods on the tree, bf16, into the template's layout
    for method in ROBUST_METHODS:
        argv = ["--json_config_path", os.path.join(here, "configs", "ACDC", f"{method}.json"),
                "--root_dir", tree, "--bf16", "--max_epochs", str(ROBUST_EPOCHS),
                "--save_dir", runs]
        args = cli_train.parse_args(argv)
        cfg, name = cli_train.load_config(args)
        zero()
        t0 = time.perf_counter()
        trainer, result = cli_train.run(args, cfg, name)
        secs[f"training {method}"] = time.perf_counter() - t0
        got = read()
        train_set, val_set = cli_train.build_datasets(cfg, args)
        n_val = len(EvalBatcher(val_set, cfg.learning.batch_size, cfg.data.pad_hw,
                                cfg.data.crop_hw, device="cuda"))
        want = Counter()
        for e in result.epochs:
            for branches in e.branches:
                want.update(trainer.expected_launches(branches))
        want["conv3x3_chw"] += len(result.epochs) * n_val * predict_k1(trainer.model)
        want = {k: want.get(k, 0) for k in LAUNCH_COUNTERS}
        if got != want:
            raise AssertionError(f"{method}: launches {got}, expected {want}")
        if (got["percentile_mask"] > 0) != (method == "cooperative_training"):
            raise AssertionError(f"{method}: K3 launched {got['percentile_mask']} times")
        losses = np.concatenate([e.losses for e in result.epochs])
        if not np.isfinite(losses).all() or not math.isfinite(result.best_score):
            raise AssertionError(f"{method}: losses or Mean IoU not finite")
        steps = sum(e.steps for e in result.epochs)
        print(f"  {method}: {steps} steps on {len(train_set)} "
              f"slices, {len(result.epochs)} epochs, {secs[f'training {method}']:.3f} s; best "
              f"epoch {result.best_epoch}, Mean IoU {result.best_score:.5f}; launches {got}, "
              f"as its branches and {len(result.epochs) * n_val} validation predicts require",
              flush=True)
        launches.update(got)
        del trainer
        torch.cuda.empty_cache()

    # ACDC-C on the card; one volume of each attack again on the CPU
    zero()
    t0 = time.perf_counter()
    written = generate_acdc_c.main(["--acdc_root", tree, "--out_root", acdc_c, "--seeds", "0"])
    secs["generating ACDC-C"] = time.perf_counter() - t0
    if any(read().values()):
        raise AssertionError(f"the generator launched a kernel: {read()}")
    n_written = len(test_pids) * 2 * len(corruptions.NAMES)
    if len(written) != n_written:
        raise AssertionError(f"the generator wrote {len(written)} volumes, want {n_written}")
    pid, frame, crop = test_pids[0], "ED", 192
    vol, _ = read_nrrd(os.path.join(tree, pid, f"{frame}_img.nrrd"))
    cropped, h_s, w_s, _, _ = generate_acdc_c.crop_with_offsets(vol.astype(np.float32), crop)
    cropped = generate_acdc_c.per_slice_minmax(cropped)
    errs = {}
    for attack in corruptions.NAMES:
        draws = generate_acdc_c.crc_draws(attack, pid, frame, 0, *cropped.shape)
        cpu = corruptions.corrupt_volume(draws, torch.from_numpy(cropped)).numpy()
        card, _ = read_nrrd(os.path.join(acdc_c, attack, f"{pid}_0", f"{frame}_img.nrrd"))
        inside = card[:, h_s:h_s + crop, w_s:w_s + crop]
        outside = card.copy()
        outside[:, h_s:h_s + crop, w_s:w_s + crop] = 0.0
        if outside.any() or not np.isfinite(inside).all():
            raise AssertionError(f"{attack}: not pasted onto a zero canvas, or not finite")
        errs[attack] = float(np.abs(inside - cpu).max())
    print(f"  ACDC-C: {len(written)} volumes of {EVAL_SLICES} slices ({len(test_pids)} pids x "
          f"ED/ES x {len(corruptions.NAMES)} attacks, seed 0) in "
          f"{secs['generating ACDC-C']:.3f} s (host clock, reading and writing included); "
          f"{pid} {frame} card against CPU on the same draws, largest difference: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()) + f" (bound {ACDC_C_ATOL})", flush=True)
    if max(errs.values()) > ACDC_C_ATOL:
        raise AssertionError(f"ACDC-C card against CPU {errs} > {ACDC_C_ATOL}")

    n_datasets = 1 + len(corruptions.NAMES)
    n_rows = len(ROBUST_METHODS) * n_datasets * 3
    chunks = len(ROBUST_METHODS) * n_datasets * 2 * len(test_pids) * -(-EVAL_SLICES // EVAL_CHUNK)

    def evaluate(template, out, what):
        args = cli_test.parse_args(["--checkpoint_template", template, "--cvals", "0",
                                    "--acdc_root", tree, "--acdc_c_root", acdc_c,
                                    "--save_dir", out])
        per_chunk = predict_k1(cli_test.load_predictor(args))
        zero()
        t0 = time.perf_counter()
        per_run, rows = cli_test.run_template(args)
        torch.cuda.synchronize()
        secs[f"evaluating {what}"] = time.perf_counter() - t0
        got = read()
        with open(os.path.join(out, "aggregated.csv")) as f:
            lines = f.read().splitlines()
        if (len(rows) != n_rows or len(lines) != n_rows + 1
                or not all(math.isfinite(r[3]) for r in rows)):
            raise AssertionError(f"{what}: {len(rows)} rows ({len(lines)} lines), want {n_rows} "
                                 f"with finite means: {rows}")
        want = dict.fromkeys(LAUNCH_COUNTERS, 0)
        want["conv3x3_chw"] = chunks * per_chunk
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        avg = {m: _corrupted_average(rows, m) for m in ROBUST_METHODS}
        gain = avg[ROBUST_METHODS[1]] - avg[ROBUST_METHODS[0]]
        print(f"  template over {what}: {len(per_run)} runs, {n_rows} rows, "
              f"{secs[f'evaluating {what}']:.3f} s for {chunks} volumes; K1 launches "
              f"{got['conv3x3_chw']}, {got['conv3x3_chw'] / chunks:g} a chunk of {EVAL_CHUNK} "
              f"slices; corrupted average Dice " + ", ".join(
                  f"{m} {v:.4f}" for m, v in avg.items())
              + f", cooperative minus standard {gain:+.4f}",
              flush=True)
        launches.update(got)
        return rows

    evaluate(os.path.join(runs, "train_ACDC_10_n_cls_4", "{method}", "{cval}", "model", "best",
                          "checkpoints"), os.path.join(root, "eval"), "this phase's checkpoints")
    tpu = os.path.join(here, TPU_RUNS, "{method}", "{cval}", "model", "best", "checkpoints")
    if all(os.path.isdir(tpu.format(method=m, cval=0)) for m in ROBUST_METHODS):
        rows = evaluate(tpu, os.path.join(root, "eval_tpu"), "the TPU checkpoints")
        with open(os.path.join(here, TPU_TABLE)) as f:
            saved = {tuple(r[:3]): float(r[3]) for r in list(csv.reader(f))[1:]}
        print(f"  clean rows of the TPU checkpoints, the port on {len(test_pids)} pids beside "
              f"{TPU_TABLE} (20 pids): " + "; ".join(
                  f"{r[1]} {r[2]} {r[3]:.4f} / {saved[tuple(r[:3])]:.4f}"
                  for r in rows if r[0] == "ACDC"), flush=True)
    else:
        print(f"  the TPU checkpoints ({TPU_RUNS}/{{method}}/0/model/best) are not in this "
              f"copy of the repository: not evaluated", flush=True)
    print("  robustness seconds (host clock): " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()) + f"; {smi}", flush=True)
    return {k: launches.get(k, 0) for k in LAUNCH_COUNTERS}


def baseline_train_check(torch, name, image, label, steps=1, device="cuda", **solver_kw):
    """``steps`` f32 train steps of the baseline ``name`` on ``device`` (the
    card) against the same steps on the CPU (``SegmentationSolver``, same seed,
    so the same weights; NHWC ``image``, (N, H, W) ``label``), as
    :func:`train_check` holds the cooperative step:

    * losses within 1e-4 of their value;
    * the last step's gradients: the model's within twice, each tensor's
      within four times, the CPU step's own difference when its input image
      moves by +-1e-6 per pixel and every weight by +-1 float32 ulp (twice,
      random signs: rounding-sized moves in every layer, as the card's sums
      in other orders are), or 1e-3 of the tensor's norm;
    * each parameter's update (and EMA parameter's, with ``use_ema``) in
      the same way, plus, for each step, 2 lr times the root of the number
      of elements whose gradient in that step is no farther from 0 than
      twice its own move (an undetermined sign: Adam moves such an element
      by about lr either way, so a flip moves the update by up to 2 lr);
    * running statistics and spectral-norm ``u``/``sigma`` within 1e-4 of
      each tensor's scale (at least 1), or twice the CPU's own largest move
      relative to scale (after a second step they follow the first step's
      updates)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.segmentation import (
        SegmentationSolver,
    )

    img, lbl = torch.from_numpy(image), torch.from_numpy(label)

    def run(device, x, move=None):
        solver = SegmentationSolver(name, device=device, seed=1, **solver_kw)
        if move is not None:  # every weight moved by one float32 ulp, random signs
            with torch.no_grad():
                gen = torch.Generator().manual_seed(move)
                for p in solver.model.parameters():
                    sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
                    p.mul_(1 + sign * 2.0 ** -23)
        losses, grads = [], []  # the loss and the (clipped) gradients of each step
        for _ in range(steps):
            losses.append(float(solver.train_step(x.to(device), lbl.to(device))["loss/total"]))
            grads.append({k: p.grad.detach().cpu().double()
                          for k, p in solver.model.named_parameters()})
        state = {k: v.detach().cpu().double() for k, v in solver.model.state_dict().items()}
        ema = ({k: v.cpu().double() for k, v in solver.ema_params.items()}
               if solver.use_ema else {})
        return losses, state, grads, ema, solver.learning_rate

    start = {k: v.double() for k, v in SegmentationSolver(
        name, device="cpu", seed=1, **solver_kw).model.state_dict().items()}
    got = run(device, img)
    t0 = time.perf_counter()
    want = run("cpu", img)
    signs = [torch.randint(0, 2, img.shape, generator=torch.Generator().manual_seed(k)) * 2 - 1
             for k in (1, 2)]
    moved = [run("cpu", img * (1 + 1e-6 * sg), k) for k, sg in enumerate(signs)]
    print(f"  {name}: three CPU runs of {steps} step(s) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for g, w in zip(got[0], want[0]):
        if not abs(g - w) <= 1e-4 * abs(w) + 1e-7:
            raise AssertionError(f"{name} train-check: loss {g} on the card, {w} on the CPU")

    def held(g_tree, w_tree, m_trees, what, slack=None):
        whole = math.sqrt(sum(float((g_tree[k] - v).norm()) ** 2 for k, v in w_tree.items()))
        own_whole = max(math.sqrt(sum(float((m[k] - v).norm()) ** 2 for k, v in w_tree.items()))
                        for m in m_trees)
        top = max(float(v.abs().max()) for v in w_tree.values())
        ratio, worst = 0.0, None
        for k, v in w_tree.items():
            own = max(float((m[k] - v).norm()) for m in m_trees)
            bound = max(1e-3 * float(v.norm()), 4 * own, 1e-6 * top * math.sqrt(v.numel()))
            bound += slack[k] if slack else 0.0
            if float((g_tree[k] - v).norm()) / bound > ratio:
                ratio, worst = float((g_tree[k] - v).norm()) / bound, k
        if not (whole <= 2 * own_whole + (sum(slack[k] ** 2 for k in w_tree) ** 0.5
                                          if slack else 0.0) and ratio <= 1.0):
            raise AssertionError(f"{name} train-check: {what} differ ({whole:.3g} against "
                                 f"own {own_whole:.3g}, worst tensor {worst} at {ratio:.3f} "
                                 f"of its bound)")
        return ratio

    last = steps - 1
    r_grad = held(got[2][last], want[2][last], [m[2][last] for m in moved], "gradients")
    lr = want[4]
    flips = {}  # 2 lr x the root of each step's undetermined elements, summed over steps
    for k in want[2][0]:
        flips[k] = 0.0
        for t in range(steps):
            own = torch.stack([(m[2][t][k] - want[2][t][k]).abs() for m in moved]).amax(0)
            flips[k] += 2 * lr * math.sqrt(int((want[2][t][k].abs() <= 2 * own).sum()))

    def delta(tree):
        return {k: tree[k] - start[k] for k in want[2][0]}

    r_upd = held(delta(got[1]), delta(want[1]), [delta(m[1]) for m in moved], "updates", flips)
    r_ema = 0.0
    if got[3]:
        r_ema = held(delta(got[3]), delta(want[3]), [delta(m[3]) for m in moved],
                     "EMA parameters", flips)
    buffers = [k for k in want[1] if k not in want[2][0]]  # BN statistics, SN u and sigma

    def apart(tree, k):
        w = want[1][k]
        return float((tree[k] - w).abs().max()) / max(1.0, float(w.abs().max()))

    worst = max(apart(got[1], k) for k in buffers)
    own_buf = max(apart(m[1], k) for m in moved for k in buffers)
    if worst > max(1e-4, 2 * own_buf):
        raise AssertionError(f"{name} train-check: buffers {worst:.3g} of scale apart (the "
                             f"CPU's own move {own_buf:.3g})")
    print(f"  {name} f32 train-check ({steps} step(s), {solver_kw or 'Adam'}): losses "
          f"{got[0]} card, {want[0]} CPU; worst tensor at {r_grad:.3f} (gradients), "
          f"{r_upd:.3f} (updates), {r_ema:.3f} (EMA) of its bound; buffers within "
          f"{worst:.3g} of scale (the CPU's own move {own_buf:.3g})", flush=True)


def baselines_phase(torch, F, conv_chw, pmask, masking, wrappers, image, label, known):
    """Phase 13 (see the module docstring).  ``known``: the kernels phase's
    records of K1, K1 dx and K2 by shape.  Returns (launches by wrapper over
    the phase, the new shapes' check records by wrapper)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.segmentation import (
        NETWORK_REGISTRY,
        SegmentationSolver,
    )

    img = torch.from_numpy(image).to("cuda")
    lbl = torch.from_numpy(label).to("cuda")
    total = dict.fromkeys(LAUNCH_COUNTERS, 0)
    seen = {k: Counter() for k in LAUNCH_COUNTERS}
    for name in NETWORK_REGISTRY:
        solver = SegmentationSolver(name, compute_dtype=torch.bfloat16, device="cuda", seed=0)
        want = {**dict.fromkeys(LAUNCH_COUNTERS, 0), **solver.expected_launches()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(BASELINE_STEPS):
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recording_shapes(conv_chw, pmask, masking, seen):
                metrics = solver.train_step(img, lbl)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = {k: w.launches for k, w in wrappers.items()}
            if got != want:
                raise AssertionError(f"{name} step {i}: launches {got}, expected {want}")
            for k in LAUNCH_COUNTERS:
                total[k] += got[k]
            losses.append(float(metrics["loss/total"]))
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver.predict(img)
        torch.cuda.synchronize()
        predict_ms = (time.perf_counter() - t0) * 1e3
        got = {k: w.launches for k, w in wrappers.items()}
        if got != {**dict.fromkeys(LAUNCH_COUNTERS, 0), "conv3x3_chw": want["conv3x3_chw"]}:
            raise AssertionError(f"{name} predict: launches {got}")
        total["conv3x3_chw"] += got["conv3x3_chw"]
        if tuple(out.shape) != (TRAIN_BATCH, 192, 192, 4) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} predict: bad output {tuple(out.shape)}")
        print(f"  {name} bf16 batch {TRAIN_BATCH}: steps (host clock to a synchronize) "
              f"{', '.join(f'{t * 1e3:.3f}' for t in times)} ms, predict {predict_ms:.3f} ms, "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
              f"K1/K1 dx/K2 a step {want['conv3x3_chw']}/{want['conv3x3_chw_dx']}/"
              f"{want['conv3x3_chw_dw']}; losses {', '.join(f'{v:.4f}' for v in losses)}",
              flush=True)
        del solver, out
        torch.cuda.empty_cache()
    # K1, K1 dx and K2 at the shapes the baselines launch and the main
    # path's kernels phase did not check, bf16 at batch 20, timed
    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    checked = {}
    for wrapper, which in (("conv3x3_chw", "fwd"), ("conv3x3_chw_dx", "dx"),
                           ("conv3x3_chw_dw", "dw")):
        shapes = sorted(set(seen[wrapper]) - set(known[wrapper]), key=lambda s: (-s[2], s[0], s[1]))
        checked[wrapper] = [check_conv(torch, F, conv_chw, conv_chw, "chw", which, sh,
                                       TRAIN_BATCH, "bfloat16", flush) for sh in shapes]
        print(f"  {wrapper} shapes of the baselines (C_in->C_out @ HxW: launches over the "
              f"phase's steps): " + ", ".join(
                  f"{sh[0]}->{sh[1]} @ {sh[2]}x{sh[3]}: {n}" for sh, n in sorted(
                      seen[wrapper].items(), key=lambda kv: (-kv[0][2], kv[0][0], kv[0][1]))),
              flush=True)
    del flush
    bad = [r for recs in checked.values() for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(f"a kernel disagrees with its plain version at a baseline "
                             f"shape: {bad}")
    torch.cuda.empty_cache()
    for name, (kw, steps) in BASELINE_CHECKS.items():
        baseline_train_check(torch, name, image[:CHECK_BATCH], label[:CHECK_BATCH], steps, **kw)
    return total, checked


def main():
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        phantom_batch,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import config as cfg
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import bench_b8_conv
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import profile_predict
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        augment,
        conv_b8,
        conv_chw,
        conv_nl,
        conv_s2,
        masking,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        percentile_mask as pmask,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import (
        cooperative as coop,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import (
        draws as draws_mod,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
        CooperativePredictor,
    )

    t_start = time.perf_counter()
    # PyTorch's default, stated: the plain K1 version's f32 matmul on the
    # card runs in full f32 (the port pins its own f32 convs, conv_chw.full_f32)
    torch.set_float32_matmul_precision("highest")

    with phase("device"):
        smi = nvidia_smi_line()
        print(f"  nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    with phase("build"):
        built = kernels.build()
        for name, info in built.items():
            ptxas = [ln.strip() for ln in info["log"].splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"  {name}: {info['seconds']:.2f} s; " + " | ".join(ptxas), flush=True)
        # K1 and the tensor-core kernels of K4, K4dx, K4dw, K5, K5dw, K6 and
        # K6dw are built to fit 128 registers a thread (two blocks an SM):
        # they must not spill
        for lib, kernel in (("conv3x3_chw", ""), ("conv3x3s2", "conv3x3s2_mma_kernel"),
                            ("conv3x3s2", "conv3x3s2_dx_mma_kernel"),
                            ("conv3x3s2", "conv3x3s2_dw_mma_kernel"),
                            ("conv3x3_nl", "conv3x3_nl_mma_kernel"),
                            ("conv3x3_nl", "conv3x3_nl_dw_mma_kernel"),
                            ("conv3x3_b8", "conv3x3_b8_mma_kernel"),
                            ("conv3x3_b8", "conv3x3_b8_dw_mma_kernel")):
            log = built.get(lib, {}).get("log", "")
            spills = spill_lines(log, kernel)
            if spills:
                raise AssertionError(f"{lib} spills registers: {spills}")
            regs = registers_of(log, kernel) if kernel else None
            if regs is not None and regs > 128:
                raise AssertionError(f"{lib}: {kernel} uses {regs} registers, more than 128")
        for name in kernels.SOURCES:
            kernels.load(name)

    images = [phantom_batch(seed=r, n=BATCH)[0] for r in range(N_IMAGES)]
    big = phantom_batch(seed=N_IMAGES, n=SERVE_BATCH)[0]
    gpu = CooperativePredictor(compute_dtype=torch.bfloat16, device="cuda", seed=0)
    cpu = CooperativePredictor(compute_dtype=torch.bfloat16, device="cpu", seed=0)
    cpu.load_state_dict(gpu.state_dict())

    with phase("kernels"):
        shapes = k1_shapes(conv_chw, cpu, torch.from_numpy(images[0][:1]))
        per_request = sum(shapes.values())
        print(f"  K1 convs per predict(n_iter={N_ITER}): {per_request} at "
              f"{len(shapes)} shapes: " + ", ".join(
                  f"{ci}->{co} @ {h}x{w} x{k}" for (ci, co, h, w), k in sorted(
                      shapes.items(), key=lambda kv: (-kv[0][2], kv[0][0], kv[0][1]))),
              flush=True)
        flush = torch.empty(64 * 2**20 // 4, device="cuda")
        order = sorted(shapes, key=lambda s: (-s[2], s[0], s[1]))

        from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
            _group,
        )

        flush_names = flush_kernels(torch, flush)
        # the profiler's rows of K1 (forward and dx), K2, K5 (forward and dx)
        # and K5dw, by their own kernel names
        rows = {which: _group(f"void (anonymous namespace)::{name}<1>()")
                for which, name in (("fwd", "conv3x3_chw_kernel"), ("dx", "conv3x3_chw_kernel"),
                                    ("dw", "dw_partial_kernel"))}
        nl_rows = {which: _group(f"void (anonymous namespace)::{name}<1>()")
                   for which, name in (("fwd", "conv3x3_nl_mma_kernel"),
                                       ("dx", "conv3x3_nl_mma_kernel"),
                                       ("dw", "conv3x3_nl_dw_mma_kernel"))}

        def k1(which, shape, n, dtype, timed=True):
            device = (rows[which], flush_names) if timed and dtype == "bfloat16" else None
            return check_conv(torch, F, conv_chw, conv_chw, "chw", which, shape, n, dtype,
                              flush if timed else None, device)

        recs = {s: k1("fwd", s, BATCH, "bfloat16") for s in order}
        f32_rec = k1("fwd", (16, 16, 192, 192), BATCH, "float32")
        # the serving batch meets the same shapes at N = 160 (checked, not timed)
        big_recs = [k1("fwd", s, SERVE_BATCH, "bfloat16", timed=False) for s in order]
        bad = [r for r in list(recs.values()) + [f32_rec] + big_recs if not r["ok"]]
        if bad:
            raise AssertionError(f"K1 disagrees with its plain version: {bad}")
        print("  K1 per predict(n_iter=2) request of 20: " + ", ".join(
            f"{key} {fmt(per_call(shapes, recs, key))}"
            for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                        "library_device_ms")) + " ms", flush=True)
        # the train step runs K1 dx and K2 at the forward's shapes: dx for
        # every conv whose input needs a gradient (all but C_in = 1, the
        # image), K2 for every conv
        dx_recs = {s: k1("dx", s, TRAIN_BATCH, "bfloat16") for s in order if s[0] > 1}
        dx_f32 = k1("dx", (16, 16, 192, 192), TRAIN_BATCH, "float32")
        dw_recs = {s: k1("dw", s, TRAIN_BATCH, "bfloat16") for s in order}
        dw_f32 = k1("dw", (16, 16, 192, 192), TRAIN_BATCH, "float32")
        k3_row = _group("void (anonymous namespace)::percentile_mask_kernel()")
        k3_recs = {(d, soft): check_k3(torch, pmask, TRAIN_BATCH, d, soft,
                                       flush if soft else None, (k3_row, flush_names))
                   for d in (128, 144) for soft in (False, True)}
        # K4, K4dx and K4dw under conv_s2=True: the encoders' two stride-2
        # shapes, timed in bf16 at the training and the serving batch (device
        # times at the training batch, K4's and K4dx's at both, K4dw's
        # partial sums and reduce also apart), checked in f32 at the training
        # batch.  bf16 K4, K4dx and K4dw run on the tensor cores, so their
        # rows are read by those kernels' names
        s2_rows = {which: _group(f"void (anonymous namespace)::{name}<1>()")
                   for which, name in (("fwd", "tc::conv3x3s2_mma_kernel"),
                                       ("dx", "tc::conv3x3s2_dx_mma_kernel"),
                                       ("dw", "tc::conv3x3s2_dw_mma_kernel"))}
        dw_split = (("partial", "conv3x3s2_dw_mma_kernel"), ("reduce", "conv3x3s2_dw_reduce"))
        s2_recs = {(which, n): {sh: check_conv(
            torch, F, conv_chw, conv_s2, "s2", which, sh, n, "bfloat16", flush,
            (s2_rows[which], flush_names) if n == TRAIN_BATCH or which != "dw" else None,
            dw_split if which == "dw" and n == TRAIN_BATCH else ()) for sh in S2_SHAPES}
                   for which in ("fwd", "dx", "dw") for n in (TRAIN_BATCH, SERVE_BATCH)}
        s2_f32 = {which: [check_conv(torch, F, conv_chw, conv_s2, "s2", which, sh,
                                     TRAIN_BATCH, "float32") for sh in S2_SHAPES]
                  for which in ("fwd", "dx", "dw")}
        # K5, K5dx and K5dw under conv_nl=True: the four large-channel
        # shapes, timed in bf16 at the training batch (with device times),
        # checked at the serving batch and in f32 (K5 and K5dx at both)
        nl_recs = {which: {sh: check_conv(torch, F, conv_chw, conv_nl, "nl", which, sh,
                                          TRAIN_BATCH, "bfloat16", flush,
                                          (nl_rows[which], flush_names)) for sh in NL_SHAPES}
                   for which in ("fwd", "dx", "dw")}
        dw_checks = ((SERVE_BATCH, "bfloat16"), (TRAIN_BATCH, "float32"))
        fwd_checks = dw_checks + ((SERVE_BATCH, "float32"),)
        nl_checks = {"fwd": fwd_checks, "dx": fwd_checks, "dw": dw_checks}
        nl_other = {which: [check_conv(torch, F, conv_chw, conv_nl, "nl", which, sh, n, dt)
                            for sh in NL_SHAPES for n, dt in nl_checks[which]]
                    for which in ("fwd", "dx", "dw")}
        # K6, K6dx and K6dw at the five stages of bench_b8_conv, timed in
        # bf16 at its batch (with device times, K6dw's partial sums and
        # reduce also apart), and one stage checked in f32
        b8_shapes = [(ci, co, h, h) for h, ci, co in bench_b8_conv.STAGES]
        b8_rows = {which: _group(f"void (anonymous namespace)::tc::{name}<1>()")
                   for which, name in (("fwd", "conv3x3_b8_mma_kernel"),
                                       ("dx", "conv3x3_b8_mma_kernel"),
                                       ("dw", "conv3x3_b8_dw_mma_kernel"))}
        b8_split = (("partial", "conv3x3_b8_dw_mma_kernel"), ("reduce", "conv3x3_b8_dw_reduce"))
        b8_recs = {which: {sh: check_conv(torch, F, conv_chw, conv_b8, "b8", which, sh,
                                          TRAIN_BATCH, "bfloat16", flush,
                                          (b8_rows[which], flush_names),
                                          b8_split if which == "dw" else ())
                           for sh in b8_shapes}
                   for which in ("fwd", "dx", "dw")}
        b8_f32 = {which: [check_conv(torch, F, conv_chw, conv_b8, "b8", which, b8_shapes[0],
                                     TRAIN_BATCH, "float32")] for which in ("fwd", "dx", "dw")}
        # the fused arms stack passes along the batch: K1, K1 dx and K2 at
        # every shape at N = 40 (FTN) and 80 (STN), K4 and its gradients at
        # 40 (the stacked image encoder under conv_s2), checked
        stacked = {which: [k1(which, sh, n, "bfloat16", timed=False) for n in STACKED_BATCHES
                           for sh in order if which != "dx" or sh[0] > 1]
                   for which in ("fwd", "dx", "dw")}
        stacked_s2 = {which: [check_conv(torch, F, conv_chw, conv_s2, "s2", which, sh,
                                         STACKED_BATCHES[0], "bfloat16") for sh in S2_SHAPES]
                      for which in ("fwd", "dx", "dw")}
        del flush
        bad = [r for r in list(dx_recs.values()) + [dx_f32] + list(dw_recs.values())
               + [dw_f32] + list(k3_recs.values())
               + [r for group in s2_recs.values() for r in group.values()]
               + [r for group in s2_f32.values() for r in group]
               + [r for group in nl_recs.values() for r in group.values()]
               + [r for group in nl_other.values() for r in group]
               + [r for group in b8_recs.values() for r in group.values()]
               + [r for group in b8_f32.values() for r in group]
               + [r for group in stacked.values() for r in group]
               + [r for group in stacked_s2.values() for r in group] if not r["ok"]]
        if bad:
            raise AssertionError(f"a kernel disagrees with its plain version: {bad}")
        torch.cuda.empty_cache()

    wrappers = wrappers_of(conv_chw, pmask)
    gpu_s2 = CooperativePredictor(compute_dtype=torch.bfloat16, device="cuda", seed=0,
                                  conv_s2=True)
    gpu_s2.load_state_dict(gpu.state_dict())
    gpu_nl = CooperativePredictor(compute_dtype=torch.bfloat16, device="cuda", seed=0,
                                  conv_nl=True)
    gpu_nl.load_state_dict(gpu.state_dict())

    def convs_per_request(model, uses):
        """Convs ``uses`` picks in one predict(n_iter=2): the FTN's encoder
        and segmentation decoder once, the STN once per refinement."""
        def count(module):
            return sum(isinstance(c, conv_chw.Conv) and uses(c) for c in module.modules())
        return (count(model.image_encoder) + count(model.segmentation_decoder)
                + (N_ITER - 1) * (count(model.shape_encoder) + count(model.shape_decoder)))

    k4_per_request = convs_per_request(gpu_s2, conv_chw.Conv.uses_k4)
    k5_per_request = convs_per_request(gpu_nl, conv_chw.Conv.uses_k5)

    with phase("serve"):
        def serve(model, img, extra=None):
            """One request; ``extra`` is (wrapper, launches it must make)."""
            before = (conv_chw.conv3x3_chw.launches, extra[0].launches if extra else 0)
            t0 = time.perf_counter()
            out = model.predict(torch.from_numpy(img).to("cuda"), n_iter=N_ITER).cpu()
            sec = time.perf_counter() - t0
            launched = (conv_chw.conv3x3_chw.launches - before[0],
                        extra[0].launches - before[1] if extra else 0)
            want = (per_request, extra[1] if extra else 0)
            if launched != want:
                raise AssertionError(f"K1 and {extra[0].__name__ if extra else 'no other'} "
                                     f"launched {launched} times for one request, "
                                     f"expected {want}")
            if out.shape != (img.shape[0], 192, 192, 4) or not torch.isfinite(out).all():
                raise AssertionError(f"bad output {tuple(out.shape)}")
            return sec

        def report(batch, lat, what=""):
            med = statistics.median(lat)
            p90 = statistics.quantiles(lat, n=10)[-1]
            print(f"  {what}batch {batch}, {len(lat)} requests: latency min "
                  f"{min(lat) * 1e3:.3f} median {med * 1e3:.3f} p90 {p90 * 1e3:.3f} max "
                  f"{max(lat) * 1e3:.3f} ms; {batch / med:.1f} slices/s at the median",
                  flush=True)

        for wrapper in wrappers.values():
            wrapper.launches = 0
        serve(gpu, big)                              # warm-up
        report(SERVE_BATCH, [serve(gpu, big) for _ in range(N_SERVE_REQUESTS)])
        serve(gpu, images[0])                        # warm-up
        serve(gpu, images[1])
        report(BATCH, [serve(gpu, images[r % N_IMAGES]) for r in range(N_REQUESTS)])
        serve_launches = {k: w.launches for k, w in wrappers.items()}
        if serve_launches["conv3x3_chw"] == 0:
            raise AssertionError("K1 never launched on the serving path")
        if any(v for k, v in serve_launches.items() if k != "conv3x3_chw"):
            raise AssertionError(f"serving launched another kernel than K1: {serve_launches}")
        print(f"  K1 launches during the {N_SERVE_REQUESTS + N_REQUESTS + 3} requests "
              f"(warm-ups included): {serve_launches['conv3x3_chw']}", flush=True)

        # conv_s2=True and conv_nl=True: the same requests with the
        # downsamples on K4, or the large-channel convs on K5
        routed = {}
        for name, model, wrapper, k in (("conv_s2", gpu_s2, conv_s2.conv3x3s2, k4_per_request),
                                        ("conv_nl", gpu_nl, conv_nl.conv3x3_nl,
                                         k5_per_request)):
            for w in wrappers.values():
                w.launches = 0
            serve(model, images[0], (wrapper, k))    # warm-up
            serve(model, images[1], (wrapper, k))
            report(BATCH, [serve(model, images[r % N_IMAGES], (wrapper, k))
                           for r in range(N_REQUESTS)], f"{name}: ")
            got = {key: w.launches for key, w in wrappers.items()}
            kname = wrapper.__name__
            if got[kname] != k * (N_REQUESTS + 2) or any(
                    v for key, v in got.items() if key not in ("conv3x3_chw", kname)):
                raise AssertionError(f"{name} serving launches {got}")
            print(f"  {name}: {k} {kname} launches a request; K1 and {kname} launches "
                  f"during the {N_REQUESTS + 2} requests: {got['conv3x3_chw']}, "
                  f"{got[kname]}", flush=True)
            routed[name] = got
        s2_serve_launches, nl_serve_launches = routed["conv_s2"], routed["conv_nl"]

        # a model in train mode predicts in eval mode and leaves its state
        gpu_s2.train()
        buffers = {k: v.clone() for k, v in gpu_s2.named_buffers()}
        x0 = torch.from_numpy(images[0]).to("cuda")
        got = gpu_s2.predict(x0, n_iter=N_ITER)
        kept = all(torch.equal(v, buffers[k]) for k, v in gpu_s2.named_buffers())
        modes = all(m.training for m in gpu_s2.modules())
        gpu_s2.eval()
        same = bool(torch.equal(got, gpu_s2.predict(x0, n_iter=N_ITER)))
        print(f"  predict on the model in train mode: buffers unchanged {kept}, modes "
              f"restored {modes}, output equal to eval mode's {same}", flush=True)
        if not (kept and modes and same):
            raise AssertionError("predict on a model in train mode changed it or its output")

    with phase("check"):
        gpu32 = CooperativePredictor(compute_dtype=None, device="cuda", seed=0)
        cpu32 = CooperativePredictor(compute_dtype=None, device="cpu", seed=0)
        gpu32.load_state_dict(gpu.state_dict())
        cpu32.load_state_dict(gpu.state_dict())
        replay_leaves(torch, gpu, cpu, images[0], "bf16 layer by layer")
        replay_leaves(torch, gpu32, cpu32, images[0], "f32 layer by layer")
        x0 = torch.from_numpy(images[0])
        want32 = cpu32.predict(x0, n_iter=N_ITER)
        compare_f32(gpu32.predict(x0.to("cuda"), n_iter=N_ITER).cpu(), want32,
                    "f32 K1 path vs CPU plain, end to end")
        got16 = gpu.predict(x0.to("cuda"), n_iter=N_ITER).cpu()
        compare_bf16(got16, cpu.predict(x0, n_iter=N_ITER), want32,
                     "bf16 K1 path vs CPU plain, end to end")
        del gpu32, cpu32
        # conv_s2=True and conv_nl=True: the bf16 layers (K4, or K5, among
        # them) and the f32 output
        for name, model, flags in (("conv_s2", gpu_s2, dict(conv_s2=True)),
                                   ("conv_nl", gpu_nl, dict(conv_nl=True))):
            twin = CooperativePredictor(compute_dtype=torch.bfloat16, device="cpu", seed=0,
                                        **flags)
            twin.load_state_dict(gpu.state_dict())
            replay_leaves(torch, model, twin, images[0], f"{name} bf16 layer by layer")
            card32 = CooperativePredictor(device="cuda", seed=0, **flags)
            twin32 = CooperativePredictor(device="cpu", seed=0, **flags)
            card32.load_state_dict(gpu.state_dict())
            twin32.load_state_dict(gpu.state_dict())
            compare_f32(card32.predict(x0.to("cuda"), n_iter=N_ITER).cpu(),
                        twin32.predict(x0, n_iter=N_ITER),
                        f"{name} f32 path vs CPU plain, end to end")
            del twin, card32, twin32

    del gpu, cpu, gpu_s2, gpu_nl
    torch.cuda.empty_cache()
    train_image, train_label = phantom_batch(seed=7, n=TRAIN_BATCH)
    configs = {"default": {}, "conv_s2": dict(conv_s2=True), "conv_nl": dict(conv_nl=True)}

    with phase("train"):
        runs = {}
        for name, flags in configs.items():
            runs[name] = train_phase(torch, conv_chw, pmask, masking, cfg, coop, draws_mod,
                                     train_image, train_label, **flags)
            step_times = runs[name][2]
            med = statistics.median(step_times)
            p90 = statistics.quantiles(step_times, n=10)[-1]
            print(f"  {name}: {RANDOM_STEPS} random steps of batch "
                  f"{TRAIN_BATCH} (host clock, smoke-level): min {min(step_times) * 1e3:.3f} "
                  f"median {med * 1e3:.3f} p90 {p90 * 1e3:.3f} max "
                  f"{max(step_times) * 1e3:.3f} ms; {TRAIN_BATCH / med:.1f} slices/s at the "
                  f"median", flush=True)
            print(f"  launches over the {name} train phase: {runs[name][0]}", flush=True)
            torch.cuda.empty_cache()
        # the configuration whose steps each kernel's per-step numbers come from
        source = {k: "default" for k in LAUNCH_COUNTERS[:4]}
        source.update(dict.fromkeys(LAUNCH_COUNTERS[4:7], "conv_s2"))
        source.update(dict.fromkeys(LAUNCH_COUNTERS[7:10], "conv_nl"))
        missing = [k for k in LAUNCH_COUNTERS[:10] if runs[source[k]][0][k] == 0]
        if missing:
            raise AssertionError(f"never launched on the training paths: {missing}")

    with phase("train-check"):
        for name, flags in configs.items():
            print(f"  {name}:", flush=True)
            train_check(torch, cfg, coop, draws_mod, train_image, train_label, **flags)

    with phase("variants"):
        variant_launches = variants_phase(torch, wrappers, cfg, coop, draws_mod, train_image,
                                          train_label)
        torch.cuda.empty_cache()

    with phase("arms"):
        with tempfile.TemporaryDirectory() as arm_tmp:
            arm_launches = arms_phase(torch, wrappers, arm_tmp)
        torch.cuda.empty_cache()

    with phase("augment"):
        aug_launches = augment_phase(torch, augment, profile_predict, cfg, coop, draws_mod,
                                     wrappers)
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        def k1_per_predict(model):
            return convs_per_request(model, conv_chw.Conv.uses_k1)

        with phase("loop"):
            loop_launches, best_dir = loop_phase(torch, wrappers, k1_per_predict, tmp)
            torch.cuda.empty_cache()

        with phase("fused"):
            fused_launches = fused_phase(torch, wrappers, tmp, smi)
            torch.cuda.empty_cache()

        with phase("determinism"):
            det_launches = determinism_phase(torch, wrappers, cfg, coop, draws_mod,
                                             train_image, train_label, tmp)
            torch.cuda.empty_cache()

        with phase("eval"):
            eval_launches = eval_phase(torch, wrappers, k1_per_predict, best_dir, tmp, smi)
            torch.cuda.empty_cache()

        with phase("robustness"):
            robust_launches = robustness_phase(torch, wrappers, k1_per_predict, tmp, smi)
            torch.cuda.empty_cache()

        with phase("ddp"):
            ddp_launches, ddp_checked = ddp_phase(torch, F, conv_chw, pmask, wrappers,
                                                  k1_per_predict, order, tmp, smi)
            torch.cuda.empty_cache()

    with phase("b8"):
        for w in wrappers.values():
            w.launches = 0
        b8_bench = bench_b8_conv.run(batch=TRAIN_BATCH, dtype="bfloat16", device="cuda",
                                     reps=B8_REPS)
        b8_launches = {k: w.launches for k, w in wrappers.items()}
        if any(b8_launches[k] == 0 for k in LAUNCH_COUNTERS[10:]) or any(
                v for k, v in b8_launches.items()
                if k not in LAUNCH_COUNTERS[10:] + ("conv3x3_chw", "conv3x3_chw_dx",
                                                   "conv3x3_chw_dw")):
            raise AssertionError(f"bench_b8_conv launches {b8_launches}")
        print(f"  launches over the bench: {b8_launches}; B8 forward against cuDNN "
              + ", ".join(f"{r['stage']} {r['b8_vs_cudnn']:.3f}x" for r in b8_bench),
              flush=True)

    with phase("baselines"):
        base_launches, base_checked = baselines_phase(
            torch, F, conv_chw, pmask, masking, wrappers, train_image, train_label,
            {"conv3x3_chw": recs, "conv3x3_chw_dx": dx_recs, "conv3x3_chw_dw": dw_recs})
        torch.cuda.empty_cache()

    total = time.perf_counter() - t_start
    print(f"chip_smoke total {total:.1f} s", flush=True)

    # one record per kernel: ms, plain_ms, bound_ms and library_ms per
    # train step (batch 20, the mean calls per shape over the random steps
    # times each shape's median time at N = 20): K1, K2 and K3 from the
    # default configuration's steps, K4, K4dx and K4dw from conv_s2's, K5,
    # K5dx and K5dw from conv_nl's; K6, K6dx and K6dw per pass of the bench
    # over its five stages (one launch each).  K1's serving numbers per
    # request are printed in the kernels phase
    per_step = {k: {sh: n / RANDOM_STEPS for sh, n in runs[source[k]][1][k].items()}
                for k in LAUNCH_COUNTERS[:10]}
    per_step.update({k: dict.fromkeys(b8_shapes, 1.0) for k in LAUNCH_COUNTERS[10:]})
    timed = {"conv3x3_chw": recs, "conv3x3_chw_dx": dx_recs, "conv3x3_chw_dw": dw_recs,
             "percentile_mask": {(n, d): k3_recs[(d, True)] for (d, soft) in k3_recs if soft
                                 for n in (TRAIN_BATCH,)},
             "conv3x3s2": s2_recs[("fwd", TRAIN_BATCH)],
             "conv3x3s2_dx": s2_recs[("dx", TRAIN_BATCH)],
             "conv3x3s2_dw": s2_recs[("dw", TRAIN_BATCH)],
             "conv3x3_nl": nl_recs["fwd"], "conv3x3_nl_dx": nl_recs["dx"],
             "conv3x3_nl_dw": nl_recs["dw"],
             "conv3x3_b8": b8_recs["fwd"], "conv3x3_b8_dx": b8_recs["dx"],
             "conv3x3_b8_dw": b8_recs["dw"]}
    checked = {"conv3x3_chw": list(recs.values()) + [f32_rec] + big_recs + stacked["fwd"],
               "conv3x3_chw_dx": list(dx_recs.values()) + [dx_f32] + stacked["dx"],
               "conv3x3_chw_dw": list(dw_recs.values()) + [dw_f32] + stacked["dw"],
               "percentile_mask": list(k3_recs.values())}
    for name, extra in list(base_checked.items()) + list(ddp_checked.items()):
        checked[name] += extra
    for name, which in (("conv3x3s2", "fwd"), ("conv3x3s2_dx", "dx"), ("conv3x3s2_dw", "dw")):
        checked[name] = [r for n in (TRAIN_BATCH, SERVE_BATCH)
                         for r in s2_recs[(which, n)].values()] + s2_f32[which] \
            + stacked_s2[which]
    for group, others, base in ((nl_recs, nl_other, "conv3x3_nl"),
                                (b8_recs, b8_f32, "conv3x3_b8")):
        for which, name in (("fwd", base), ("dx", f"{base}_dx"), ("dw", f"{base}_dw")):
            checked[name] = list(group[which].values()) + others[which]
    launches = {k: serve_launches[k] + s2_serve_launches[k] + nl_serve_launches[k]
                + sum(run[0][k] for run in runs.values()) + variant_launches[k]
                + arm_launches[k] + aug_launches[k] + loop_launches[k] + fused_launches[k]
                + det_launches[k]
                + eval_launches[k] + robust_launches[k] + ddp_launches[k] + b8_launches[k]
                + base_launches[k] for k in LAUNCH_COUNTERS}
    records = []
    for name in LAUNCH_COUNTERS:
        calls = per_step[name]
        if set(calls) - set(timed[name]):
            raise AssertionError(f"{name}: shapes on the path were not timed: "
                                 f"{sorted(set(calls) - set(timed[name]))}")

        def total_of(key, name=name, calls=calls):
            return per_call(calls, timed[name], key)

        by = Counter({r["bound_by"]: 0.0 for r in timed[name].values()})
        for sh in calls:
            by[timed[name][sh]["bound_by"]] += calls[sh] * timed[name][sh]["bound_ms"]
        source_file, replaces = KERNELS[name]
        records.append({
            "name": name, "route": "cuda", "source": source_file, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checked[name]),
            "ms": total_of("ms"), "plain_ms": total_of("plain_ms"),
            "bound_ms": total_of("bound_ms"), "bound_by": by.most_common(1)[0][0],
            "library_ms": total_of("library_ms"),
            "device_ms": total_of("device_ms"), "library_device_ms": total_of("library_device_ms"),
        })
        if name == "percentile_mask":  # the floor beside K3's device time
            records[-1].update(floor_ms=total_of("floor_ms"),
                               host_us=max(r["host_us"] for r in timed[name].values()))
        unit = "bench pass" if name in LAUNCH_COUNTERS[10:] else "random step"
        print(f"  {name}: {sum(calls.values()):.1f} calls per {unit} at {len(calls)} "
              f"shapes; per {unit} ms {records[-1]['ms']:.4f} plain "
              f"{records[-1]['plain_ms']:.4f} bound {records[-1]['bound_ms']:.6f} library "
              f"{records[-1]['library_ms']} device {records[-1]['device_ms']} library "
              f"device {records[-1]['library_device_ms']}", flush=True)
    # K2, K1, K1 dx, K4, K4 dx, K4dw, K5, K5 dx and K5dw by shape: launches
    # per random step (the default configuration's, conv_s2's for K4,
    # conv_nl's for K5) beside the kernels phase's times at N = 20, bf16
    for name, label, library in (("conv3x3_chw_dw", "K2", "conv2d_weight"),
                                 ("conv3x3_chw", "K1", "F.conv2d"),
                                 ("conv3x3_chw_dx", "K1 dx", "conv2d_input"),
                                 ("conv3x3s2", "K4", "F.conv2d stride 2"),
                                 ("conv3x3s2_dx", "K4 dx", "conv2d_input stride 2"),
                                 ("conv3x3s2_dw", "K4dw", "conv2d_weight stride 2"),
                                 ("conv3x3_nl", "K5", "F.conv2d"),
                                 ("conv3x3_nl_dx", "K5 dx", "conv2d_input"),
                                 ("conv3x3_nl_dw", "K5dw", "conv2d_weight")):
        by_shape(per_step[name], timed[name], records[LAUNCH_COUNTERS.index(name)], label,
                 library)
    # K6, K6 dx and K6dw by stage of bench_b8_conv: one launch each per
    # bench pass beside K1's (K1 dx's, K2's) device time at the same shape
    # from the kernels phase (every bench stage is a K1 shape of the main
    # path with C_in > 1)
    for name, label, library, beside in (("conv3x3_b8", "K6", "F.conv2d", ("K1", recs)),
                                         ("conv3x3_b8_dx", "K6 dx", "conv2d_input",
                                          ("K1 dx", dx_recs)),
                                         ("conv3x3_b8_dw", "K6dw", "conv2d_weight",
                                          ("K2", dw_recs))):
        by_shape(per_step[name], timed[name], records[LAUNCH_COUNTERS.index(name)], label,
                 library, "bench pass", beside)
    # K4dw's and K6dw's two kernels apart: the partial sums and the slots'
    # reduce
    for name, label, split, unit in (("conv3x3s2_dw", "K4dw", dw_split, "random step"),
                                     ("conv3x3_b8_dw", "K6dw", b8_split, "bench pass")):
        calls = per_step[name]
        for part, _ in split:
            per = {sh: {"device_ms": timed[name][sh]["split_device_ms"][part]} for sh in calls}
            print(f"  {label} {part} device ms by shape: " + ", ".join(
                f"{sh[0]}->{sh[1]} @ {sh[2]}x{sh[3]} {fmt(per[sh]['device_ms'])}"
                for sh in sorted(calls, key=lambda s: (-s[2], s[0], s[1])))
                + f"; per {unit} {fmt(per_call(calls, per, 'device_ms'))}", flush=True)
    # K4 and K4 dx at the serving batch (a launch each, bf16, from the
    # kernels phase)
    for which, label, library in (("fwd", "K4", "F.conv2d"), ("dx", "K4 dx", "conv2d_input")):
        print(f"  {label} at N = {SERVE_BATCH} by shape (ms, device ms, cuDNN {library} "
              f"stride 2 ms, cuDNN device ms, bound ms): " + "; ".join(
                  f"{sh[0]}->{sh[1]} @ {sh[2]}x{sh[3]} {r['ms']:.4f}, "
                  f"{fmt(r.get('device_ms'))}, {r['library_ms']:.4f}, "
                  f"{fmt(r.get('library_device_ms'))}, {r['bound_ms']:.4f}"
                  for sh, r in s2_recs[(which, SERVE_BATCH)].items()), flush=True)
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
