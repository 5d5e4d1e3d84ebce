"""On-card smoke run of the PyTorch/CUDA port (liso_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device  - the card, and its name and power limit from nvidia-smi;
  2. build   - nvcc builds of every kernel source (sm_90a), one nvcc per
               source, all started together; seconds taken;
  3. kernels - each kernel against its plain PyTorch version on the card at
               the full-width shapes of its path: K1 and K2 at the serving
               path's (grid 512, 32768 points, batch 8, bf16), K1 bitwise,
               K2 within one bf16 ulp plus the fp32 sum-order slack of a
               cancelling dot (corr_fused.sum_order_slack), out-of-range
               taps exactly 0; K1, K3-K6 and the fused scatter-max VJP at
               the SLIM train step's (grid 920 over 120 m, 65536 points,
               batch 1, 6 iterations): K1, K4 and the VJP bitwise, K3
               (uniform and skewed bins) and K5 within their
               fp32 sum-order bounds, K6 against the exact search of its
               band (nn_1_sorted_band_plain) on every valid query and
               within its approximation contract against the exact 1-NN
               (knn_banded.contract_report), with the pairs its sweep
               tested (its bound); K4 also at the decoder gather's C = 2
               fp32, with the host time of each step its wrapper shares;
               the eval BatchNorm + ReLU kernel bitwise at CenterPoint's
               stage 0 (bf16 NCHW) and a pillar encoder's norm (fp32
               channel-last, 65536 points), NaN, infinities and -0 in;
               kernel, plain and library
               times (CUDA events, median of 20 calls), for every kernel
               also the kernel alone (torch.profiler, mean of
               20 launches), for K1, K3, K4, K1-add and the VJP the
               wrapper's enqueue time (host_ms), and the bound. K1's and
               K3's library calls allocate a zeroed grid each time, as the
               kernels return a fresh one (the reused, pre-zeroed grid's
               time is kept as library_ms_prezeroed);
  4. path    - the serving path at full width with seeded random weights:
               fused_forward, then an encode and 12 chained fused_streaming
               steps, with every launch count reset just before and read
               just after; ms per step (host clock, each step awaited) and
               frames/s (the warm-up run captures the flow stage's CUDA
               graph, the timed run replays it); launches confirmed by
               torch.profiler (a replay adds the counts its capture
               recorded, so for the flow stage's kernels the count of
               the timed run only repeats the capture's: the profiled
               replay of one streaming step is what checks them, by the
               kernels that ran); K2 held and timed on the six lookups of an
               eager flow stage on a streaming step's features, captured
               by wrapping corr_fused.fused_corr_window (a replay calls no
               wrapper); final flow and box probs
               against the same run through the plain versions;
  5. train   - the SLIM train step (SlimTrainer.train_step, slim_liso flags,
               bf16 compute) at the train shapes above with seeded weights
               and the JAX train benchmark's clouds: 2 warm-up steps, then
               8 timed steps (host clock, each awaited) with every launch
               count reset just before and read just after; one profiled
               step (device time by kernel family, launches held to the
               counts, searchsorted launches); K3 held and timed on the
               histogram of one step at the timed state; one step from the same
               state through the plain versions, compared on loss and
               gradient norm; and K1-add (the grid_gather backward, which
               no path runs) against its plain version at the adjoint of
               K4's check and at the decoder gather's C = 2;
  6. detect_train - the CenterPoint detector's train step
               (DetectorTrainer.train_step, fp32, AdamW + OneCycle) at grid
               512 over 100 m, batch 2, 32768 points per frame, 64 target
               slots, on the mining benchmark's synthetic drive: K1 (fp32,
               C = 64), K4 and the scatter-max VJP held bitwise to their
               plain versions on the drive's cells and timed at this path's
               shapes; 2 warm-up steps, then 8 timed steps with every launch
               count reset just before and read just after; one profiled
               step; one step from the same state through the plain
               versions (loss, gradient norm; cuDNN deterministic for both);
               predict_step timed (median of 10) and its kept boxes held to
               the plain run's;
  7. slim_experiment - the SLIM experiment path
               (train/slim_experiment.py) at slim_liso +
               slim_highest_resolution (grid 920 over 120 m, batch 1, 6
               iterations, fp32, RMSprop), DataCfg(n_max=65536,
               m_max=131072) as slim_cli builds it without --fast-test, on
               a synthetic drive of 65536 background points, 8 frames: K1
               and the fused VJP held bitwise at fp32 C = 64 over the 846400
               cells; SlimExperiment.run for 6 steps through the Prefetcher
               and its fork workers (step and data-wait ms, launches reset
               just before and read just after); a checkpoint saved and
               restored bitwise into a fresh experiment of another seed;
               evaluate on 2 batches (AEE finite); export_flow of 2 samples
               (the 6-pair npz schema); one sample's export against the
               plain versions (flow within FLOW_ATOL, dynamicness within
               PROBS_ATOL, the threshold equal); one train step and one
               predict_step under the profiler;
  8. mining  - LisoSelfTraining.mine (train/liso_loop.py) as `mining_cli -c
               bev_100m_512 centerpoint liso` composes it, on the synthetic
               drive slim_cli builds (64 frames, n_max 65536): round 0 with
               the flow-cluster bootstrap (no kernel), round 1 with the
               detector (seeded random weights, the dims head's bias raised
               by M_DIMS_BIAS) in chunks of 8 frames: K1 held bitwise and
               timed at fp32 C 64, batch 8, 512^2 cells; launches reset
               just before each round and read just after, and confirmed by
               the profiler on one chunk; round 1 against itself through the
               plain versions (cuDNN deterministic: the same detections,
               track ids and boxes within DET_BOX_ATOL); round 0 on the
               first M_CPU_FRAMES frames against the port on the CPU; the
               DBs loaded back bitwise; seconds per round, ms per frame
               (detect, the frame program), tracker host ms, refinement and
               smoothing ms per track, tracks, boxes, DB bytes, the detect
               stage's device busy share; smoothing eager against its CUDA
               graph (bitwise) and the bike model on one track;
  9. eval    - evaluation as `eval_cli -c bev_100m_512 centerpoint liso`
               composes it, on the mining phase's drive with its round-0
               DB and round-1 detector: K1 held bitwise and timed at fp32
               C 64, batch 1, 512^2 cells (predict_step at batch 1), its
               launch confirmed by the profiler; run_val over the round-0
               DB on the 64 train frames (as mining_cli); validate on the 16
               val frames and its val-on-train pass over the 64 train
               frames; eval_cli's flow-cluster and echo_gt predictors in
               this process (echo_gt: every visible iou_bev AP 1); launches
               reset just before each run and read just after; validate
               again through the plain versions (cuDNN deterministic: the
               same kept boxes within DET_BOX_ATOL, metrics within
               EV_METRIC_ATOL); the IoU matrices of validate's first
               samples on the card against the float64 oracle and the CPU;
               every run's card predictions through run_val on the CPU (the
               same keys, values within EV_METRIC_ATOL, IoUs near a
               matching threshold named); a checkpoint of the detector
               restored bitwise, and eval_cli on it in a subprocess, whose
               printed metrics must equal validate's exactly; seconds per
               run, host ms per batch by stage (predict, IoU, banks,
               flow metrics), the predict stage's device busy share.
  10. rounds - the rounds loop as `liso_cli -c bev_100m_512 centerpoint
               liso` runs it, in this process, cut only in its step counts
               (R_KV: rounds of 4 steps, 9 in all, a checkpoint every 4,
               no validate in the loop: liso_cli's own at the end; cut from
               rounds of 8, 17 steps and a validate at 16 to make room for
               the parallel phase), on the 64-frame drive: bootstrap mining
               at step 0, detector mining at 4 and 8, the weight reset at 8,
               copy-paste on; launches reset just before and read just
               after; the reset's weights against init_weights(seed + 3) on
               the CPU (bitwise), AdamW's count 1 in the step-8 checkpoint;
               the first prepared batch's step against the CPU from the
               same initial weights (losses within R_CPU_RTOL); K1 and the
               fused VJP held bitwise and timed at that batch's cells (fp32
               C 64, batch 2, n_max 65536, 512^2 cells); one loop step
               against its plain run (cuDNN deterministic, losses within
               DET_LOSS_RTOL) and under the profiler; the step-8
               checkpoint and DBs restored bitwise into a fresh loop; then
               liso_cli resumed from the step-4 checkpoint in its own
               process, which must mine round 2 and reset at 8 and save 8
               and 9; per round mining seconds, tracks, boxes and the mined
               DB's run_val seconds, per step _prepare_batch and train-step
               ms and the loss, validate seconds, save and restore ms, the
               resume's wall time, the step's device busy share.
  11. detectors - the other detectors, each network's preset at
               `bev_100m_512 <net> liso` (transfusion, pointpillars,
               pointrcnn, and centerpoint with use_baseline_parameters
               False), its trainer built by LisoSelfTraining._make_trainer,
               on a batch of the rounds cell's drive from _prepare_batch
               (batch 2, n_max 65536): K1 and the fused VJP held bitwise
               and timed at its cells; per network one step kernels vs
               plain (cuDNN deterministic, every loss term within
               DET_LOSS_RTOL), the first step card vs the port on the CPU
               from the same state (DT_CPU_TOL), DT_STEPS timed steps after
               DT_WARMUP (median, max, the Hungarian stage's host ms, a
               profiled step's device busy share and launches) and
               DT_PREDICTS timed predict_step calls, whose kept boxes must
               equal the plain run's within DET_BOX_ATOL; then `liso_cli -c
               bev_100m_512 transfusion liso` in this process, cut in step
               counts (DT_CLI_KV: mining at 0, 4, 8, the reset at 8, a
               validate at 8 and at the end, saves at 4, 8, 9), with its
               seconds by stage.
  12. reference_raft - the reference layout of RAFT: a random state_dict
               in the reference's layout (every key the checkpoint
               converter reads) through models/torch_compat.
               load_reference_raft at the train cell's grid (920 over 120
               m), fp32, batch 1, RR_ITERS iterations, on pillar images of
               64 channels: K2 held to its plain version and timed on the
               forward's own lookups; RR_WARMUP + RR_CALLS forwards (launches
               reset just before and read just after, one under the
               profiler); the forward through the plain versions (flow
               within FLOW_ATOL, logits within RR_LOGIT_ATOL); the card
               against the port on the CPU at grid RR_CPU_GRID.
  13. etl    - a KITTI-raw drive of 120800 points a frame (a street
               scene and data/synthetic.py's moving objects; velodyne
               .bin, OXTS packets, calibration), converted by the port's
               create_kitti with ICP (odometry held to the planted
               motion), read by KittiRawDataset, and the `bev_100m_512
               centerpoint liso` detector's predict_step on the card over
               the frames read: K1 held bitwise and timed at their cells,
               DT_PREDICTS timed calls, the kept boxes against the plain
               run's.
  14. parallel - data parallel on the one card (liso_tpu_torch/parallel):
               (a) the SLIM train step at the train phase's point, (b)
               the CenterPoint step at the rounds cell's and (b') the
               TransFusion, PointPillars and PointRCNN steps of their
               presets on the same batch (cuDNN deterministic), each with
               the global batch of P_WORLD split over P_WORLD gloo ranks in
               spawned processes: every rank's first step against the
               one-process step on the full batch (loss terms, grad norm;
               the threshold state; the BN running statistics), P_STEPS
               (P_O_STEPS for b') timed steps after P_WARMUP (1) (median,
               max, host ms in the collectives, launches reset just before
               and read just after on each rank), and rank 0's profiler on
               a step; (c) one CenterPoint and one P_O_NCCL step over an
               nccl group of one rank, whose state must equal bitwise the
               step's without a group; (d) two `liso_cli -c bev_100m_512
               centerpoint liso` processes over one log dir (--world_size
               2), cut in step counts (P_CLI_KV): disjoint mined shards,
               the same merged DB digest on both workers, equal parameter
               digests at every round boundary; beside them
               dryrun_multichip(2) on the card.
Then one {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. A failed check, or any exception, prints one
line {"phase": "failed", "check": "<function>:<line>", "message": "..."}
on stdout and exits non-zero with no result. Details go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

GRID, N_PTS, BATCH, ITERS, STEPS = 512, 32768, 8, 6, 12
# the SLIM train step of benchmarks/slim_920_bench.py
T_GRID, T_RANGE, T_PTS, T_ITERS, T_WARMUP, T_STEPS = 920, 120.0, 65536, 6, 2, 8
# the detector train step: liso + centerpoint at bev_100m_512, batch 2,
# 32768 points per frame (DataCfg.n_max), 64 target slots (k_max_boxes),
# AdamW + OneCycle at max_lr 1e-3 over 30000 x 2 + 2 steps
D_GRID, D_RANGE, D_BATCH, D_PTS, D_SLOTS, D_OBJECTS = 512, 100.0, 2, 32768, 64, 6
D_MAX_LR, D_TOTAL_STEPS, D_PREDICTS = 1e-3, 30000 * 2 + 2, 10
# Kernel step against plain step from the same state, both fp32 (TF32 off):
# K1 and K4 are bitwise, so the forward and the loss agree to cuDNN's
# choice of algorithm; the backward's weight gradients are summed by cuDNN
# in no fixed order, and this random network's gradient amplifies a change
# of summation order (the CPU parity test measures 2.4e-4 on its norm).
DET_LOSS_RTOL = 1e-5
DET_GRAD_NORM_RTOL = 1e-3
DET_BOX_ATOL = 1e-4
# the SLIM experiment path: slim_cli's data capacity without --fast-test
# (n_max 65536), a synthetic drive of 65536 background points and its 2
# default moving objects, E_FRAMES frames; E_STEPS steps, E_EXPORTS exports
E_PTS, E_FRAMES, E_STEPS, E_EXPORTS = 65536, 8, 6, 2
# the mining pass: `mining_cli -c bev_100m_512 centerpoint liso` on the
# synthetic drive slim_cli builds without --fast-test (64 frames, n_max
# 65536, grid 512 over 100 m, 100 boxes after NMS, min_track_age 4, 2000
# smoothing iterations, detector chunks of 8). Round 1's detector: seeded
# random weights with the dims head's bias raised by M_DIMS_BIAS (boxes of
# about 6 m instead of 0.7 m, so that some hold min_points_in_box points
# and round 1 mines tracks).
M_FRAMES, M_PTS, M_CHUNK, M_SMOOTH_ITERS, M_DIMS_BIAS = 64, 65536, 8, 2000, 6.0
# Round 0 on the card against the port on the CPU, on the first M_CPU_FRAMES
# frames: the same tracks and ids; positions and yaw within the smoothing's
# own spread (Adam at lr 0.1 on the jerk does not settle: the JAX function
# moves by up to 0.068 m when its input moves by one ulp,
# tests/test_torch_tracker.py), dims within M_DIMS_ATOL
M_CPU_FRAMES, M_POS_ATOL, M_ROT_ATOL, M_DIMS_ATOL = 16, 0.1, 0.1, 1e-3
# Evaluation (run_val, validate, eval_cli) at the mining phase's config and
# drive: the IoU matrices of run 2's first EV_IOU_SAMPLES samples on the
# card against the float64 oracle (the JAX test's limit,
# tests/test_iou_nms.py) and against the port on the CPU; metric dicts
# (card against the CPU, kernels against plain) within EV_METRIC_ATOL; an
# IoU within EV_NEAR of a matching threshold (EV_THRESHOLDS: the banks'
# iou_matching_thresholds) is named in the result
EV_IOU_SAMPLES, EV_IOU_ORACLE_ATOL, EV_IOU_CPU_ATOL = 4, 2e-4, 1e-5
EV_METRIC_ATOL, EV_NEAR, EV_THRESHOLDS = 1e-6, 1e-5, (0.25, 0.3, 0.4, 0.5, 0.7)
# The rounds loop: `liso_cli -c bev_100m_512 centerpoint liso` on the
# 64-frame drive, cut only in its step counts (R_KV): rounds of R_SPR steps
# instead of 30000, R_STEPS in all instead of 350000, a checkpoint every
# R_SPR steps, no validate inside the loop (R_VAL 0; liso_cli validates at
# the end, and the detectors phase's CLI run validates inside its loop).
# Cut from rounds of 8, 17 steps and a validate at 16, to make room for
# the parallel phase. With the preset's
# drop_net_weights_every_nth_round 2: mining at 0, 4 and 8, the reset at
# 8. The first step's loss terms, card against the CPU, within R_CPU_RTOL
# (the detector step's CPU parity limit, tests/test_torch_detector_train.py)
R_SPR, R_STEPS, R_VAL, R_SNAP_STEP, R_CPU_RTOL = 4, 9, 0, 8, 1e-4
R_KV = [["optimization", "rounds", "steps_per_round", str(R_SPR)],
        ["optimization", "num_training_steps", str(R_STEPS)],
        ["checkpoint", "save_model_every", str(R_SPR)],
        ["validation", "val_every_n_steps", str(R_VAL)]]
# The other detectors: each network's preset at bev_100m_512 + liso (the
# centerpoint one with use_baseline_parameters False), its trainer built by
# LisoSelfTraining._make_trainer, on a batch of the rounds cell's drive as
# _prepare_batch gives it (batch 2, n_max 65536): DT_WARMUP + DT_STEPS
# steps, DT_PREDICTS predict_step calls. Then `liso_cli -c bev_100m_512
# transfusion liso` cut in step counts only (DT_CLI_KV): mining at 0, 4
# and 8, the reset at 8, a validate at 8 (and liso_cli's at the end),
# saves at 4, 8 and 9.
DT_CONFIGS = (
    ("transfusion", "transfusion", []),
    ("pointpillars", "pointpillars", []),
    ("pointrcnn", "pointrcnn", []),
    ("centerpoint_non_baseline", "centerpoint",
     [["network", "centerpoint", "use_baseline_parameters", "False"]]),
)
DT_WARMUP, DT_STEPS, DT_PREDICTS = 2, 8, 10
# The first step, card against the port on the CPU: every loss term within
# DT_CPU_TOL, relative for a term of magnitude 1 or more and absolute below
# (a small loss such as PointPillars' direction CE, 0.29, is a log-softmax
# near certainty: its error is absolute, about that of the logits)
DT_CPU_TOL = 1e-4
DT_SPR, DT_TOTAL, DT_VAL = 4, 9, 8
DT_CLI_KV = [["optimization", "rounds", "steps_per_round", str(DT_SPR)],
             ["optimization", "num_training_steps", str(DT_TOTAL)],
             ["checkpoint", "save_model_every", str(DT_SPR)],
             ["validation", "val_every_n_steps", str(DT_VAL)]]
# Data parallel (the parallel phase): the global batch of P_WORLD
# (batch_size_two, liso_config.yml:489-491) split over P_WORLD gloo ranks,
# one sample a rank, all on the one card (NCCL refuses two ranks on one
# device). SLIM at the train phase's point (bf16), CenterPoint at the rounds
# cell's (fp32, cuDNN deterministic). Each rank: the first step (compared
# with the one-process step on the full batch), P_WARMUP - 1 more warm-up
# steps, P_STEPS timed steps, then up to P_PROFILED steps with rank 0's under
# the profiler, until its profiler sees every launch of the step. Limits against the one-process step: SLIM's loss and grad norm
# as the train phase's kernels vs plain (bf16 noise); its threshold state's
# bias counter (a function of the valid counts) within P_BIAS_RTOL and the
# cumulative importance within P_CUMSUM_REL (dynamicness from the bf16
# forward moves a point's improvement by hundreds of the 1e-5 bins; the
# limit was set before the first card run, which measured 1.85e-2 on an
# H100); the detector's loss terms within DET_LOSS_RTOL
# (4.2e-6 measured on an H100, from batch 1 against batch 2 convolutions
# and flax's two-pass batch statistics against F.batch_norm), its grad norm
# within DET_GRAD_NORM_RTOL and the BN running statistics within
# P_STATS_RTOL. Then two liso_cli workers over one log
# dir, cut in step counts only (P_CLI_KV: rounds of P_CLI_SPR steps,
# P_CLI_STEPS in all).
P_WORLD, P_WARMUP, P_STEPS, P_PROFILED = 2, 2, 8, 2
P_BIAS_RTOL, P_CUMSUM_REL = 1e-6, 2e-2
P_STATS_RTOL = 1e-5
P_CLI_SPR, P_CLI_STEPS = 4, 6
P_CLI_KV = [["optimization", "rounds", "steps_per_round", str(P_CLI_SPR)],
            ["optimization", "num_training_steps", str(P_CLI_STEPS)]]
P_RANKS_TIMEOUT_S, P_CLI_TIMEOUT_S = 300, 300
# The other networks over the same gloo ranks (bev_100m_512 <net> liso, the
# rounds cell's first batch, cuDNN deterministic): the first step against
# the one-process step (loss terms within DET_LOSS_RTOL, the grad norm of
# the gradient the update takes within DET_GRAD_NORM_RTOL, the BN running
# statistics within P_STATS_RTOL, the CenterPoint limits, but the loss
# terms within P_O_LOSS_RTOL: the CPU test's CenterPoint limit, which the
# card held too before CenterPoint measured 4.2e-6 there; stated before
# these networks' first card run), then P_O_STEPS timed steps
# after the first; an nccl group of one rank for P_O_NCCL.
P_OTHERS, P_O_STEPS, P_O_NCCL = ("transfusion", "pointpillars", "pointrcnn"), 4, "transfusion"
P_O_LOSS_RTOL = 5e-5
# The reference-checkpoint RAFT (models/torch_compat.load_reference_raft): a
# random state_dict in the reference's layout (fnet 128, cnet 96 + 64, 4
# levels, radius 3, RR_ITERS iterations) at the train cell's grid, batch 1,
# fp32, on pillar images of 64 channels; RR_WARMUP + RR_CALLS forward
# calls. Limits, stated before the first card run: kernels against plain
# on the card, flow within FLOW_ATOL (K2 rounds a few taps to the other
# bf16 neighbour, as on the serving path) and logits within RR_LOGIT_ATOL;
# the card against the port on the CPU at grid RR_CPU_GRID, flow within
# RR_CPU_FLOW_ATOL and logits within RR_CPU_LOGIT_ATOL (the CPU parity
# test's 2e-3 m and 1e-3 hold 2 iterations; 6 iterations of bf16 tap flips
# and cuDNN's against oneDNN's fp32 sums, x5).
RR_ITERS, RR_WARMUP, RR_CALLS, RR_CPU_GRID = 6, 2, 8, 128
RR_LOGIT_ATOL, RR_CPU_FLOW_ATOL, RR_CPU_LOGIT_ATOL = 2e-2, 1e-2, 5e-3
# The ETL: a KITTI-raw drive at a KITTI velodyne frame's size (about 120k
# points): ETL_FRAMES frames, each ETL_BG static points of a street scene
# (etl_static_scene: a ground plane, building walls and poles) and the 2
# moving objects of data/synthetic.py, as velodyne .bin, OXTS packets and
# an identity IMU-to-velo calibration; converted by the port's create_kitti
# with ICP, read by KittiRawDataset at the `bev_100m_512 centerpoint liso`
# DataCfg, and the detector's predict_step on the card over the frames
# read. The planted ego motion: odometry within ETL_ODOM_ATOL (GPS) and
# ETL_ICP_ATOL (ICP) of ETL_EGO_M per frame. The static scene needs
# surfaces: point-to-point ICP over voxel-downsampled clouds finds the
# motion from walls and poles, and settles near no motion on static points
# that are uniform noise as dense as a real frame.
ETL_FRAMES, ETL_BG, ETL_EGO_M, ETL_ODOM_ATOL, ETL_ICP_ATOL = 6, 120000, 1.2, 2e-3, 0.05
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
# Kernel step against plain step, same state, bf16 compute: K5 sums df1 by
# atomics in no fixed order and K2 rounds a few corr taps to the other bf16
# neighbour, so the losses (before the backward) agree to the forward's
# bf16 noise and the gradient norms to the backward's.
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GRAD_NORM_RTOL = 2e-2
# End-to-end tolerance of the kernel path against the plain path, both on
# the card in bf16. K1 is bitwise, so the images, encoder features and the
# whole detector agree exactly; K2 differs from its plain version by at most
# one bf16 ulp on a few taps (fp32 sums in another order round to the other
# neighbour), and those differences pass through 6 GRU iterations of bf16
# convs: flow (meters, one coarse pixel is 1.5625 m) within FLOW_ATOL.
FLOW_ATOL = 0.05
PROBS_ATOL = 1e-3


# wall seconds of this process in profiler sessions, their processing
# included, by the function that ran them
PROFILER_S = {"profile_window": 0.0, "kernel_only_ms": 0.0}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    """Print which check failed (the calling function and line) as one JSON
    line on stdout, then exit non-zero with the message on stderr."""
    caller = sys._getframe(1)
    emit({"phase": "failed",
          "check": f"{caller.f_code.co_name}:{caller.f_lineno}",
          "message": msg})
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median ms of one call over `reps` calls, each between two events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_only_ms(fn, kernel, reps=20, sessions=6):
    """Mean device ms of one launch of the kernel whose name holds
    `kernel`, over the launches torch.profiler records in `reps` calls of
    `fn` (it may drop some of a run's launches): the kernel alone, without
    the wrapper's host time that CUDA-event timing of a short call holds.
    A profiler session that records no launch at all (one did, of 20 K2
    calls, on an H100; three in a row did, of K4's, in one whole run) is
    repeated, up to `sessions` in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            if kernel in ev.key and ev.self_cpu_time_total == 0 and dev_us:
                us += dev_us
                count += ev.count
        if count:
            PROFILER_S["kernel_only_ms"] += time.perf_counter() - t0
            return us / count / 1e3
    fail(f"the profiler saw no launch of {kernel} in {reps} calls, in "
         f"{sessions} sessions")


def host_ms(fn, reps=20):
    """Mean host ms to enqueue one call of `fn` (no synchronisation
    between the calls): what a short call's event time holds besides the
    kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return t * 1e3


def searchsorted_stats(rows):
    """Launches and device ms of torch.searchsorted in profile rows."""
    hits = [(us, n) for us, n, key in rows if "searchsorted" in key]
    return {"launches": sum(n for _, n in hits),
            "device_ms": sum(us for us, _ in hits) / 1e3}


def bf16_ulp(x):
    import torch

    a = x.abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def clouds(seed, n_frames):
    """The bench's clouds: points uniform in a 90 m square, all valid."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pts = [
        (torch.rand(BATCH, N_PTS, 4, generator=g) * 90 - 45).cuda()
        for _ in range(n_frames)
    ]
    return pts, torch.ones(BATCH, N_PTS, dtype=torch.bool, device="cuda")


def bound(nbytes, nops, rate):
    """(bound ms, what bounds it): bytes over the memory rate or operations
    over `rate`, whichever takes longer."""
    tb, to = nbytes / HBM_BYTES_PER_S, nops / rate
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def dtype_name(dtype) -> str:
    return {"torch.bfloat16": "bf16", "torch.float32": "fp32"}[str(dtype)]


def check_scatter_max(gen, cells, nc, c, dtype, timed=True):
    """K1 against its plain version (bitwise) on signed random features
    (so negative maxima are covered) at the given cells; with timed=False
    only that check (no timing, no profiler)."""
    import torch

    from liso_tpu_torch.ops import grid_scatter

    b, n = cells.shape
    feats = torch.randn(b, n, c, generator=gen, device="cuda").to(dtype)
    got_g, got_o = grid_scatter.grid_scatter_max_occ(feats, cells, nc)
    want_g, want_o = grid_scatter.grid_scatter_max_occ(feats, cells, nc, plain=True)
    torch.cuda.synchronize()
    if not (torch.equal(got_g, want_g) and torch.equal(got_o, want_o)):
        fail(f"K1 grid_scatter_max_occ differs from its plain version at "
             f"feats [{b}, {n}, {c}] {dtype_name(dtype)}")
    if not timed:
        return None
    idx = cells.long().clamp(max=nc).unsqueeze(-1).expand(-1, -1, c)
    lib_out = torch.zeros(b, nc + 1, c, dtype=dtype, device="cuda")

    def library():  # K1's function less occupancy: a fresh grid each call
        out = torch.zeros(b, nc + 1, c, dtype=dtype, device="cuda")
        return out.scatter_reduce_(1, idx, feats, "amax", include_self=False)
    # the kernel reads the features only of the points that reach the grid:
    # the rest (cut by pillarize's |z| < 5 m or outside the grid) sit in the
    # drop bucket past the last cell's range
    in_grid = int((cells < nc).sum())
    es = feats.element_size()
    nbytes = (in_grid * c * es + cells.numel() * 4 + got_g.numel() * es
              + got_o.numel() * 4)
    # one max per point channel
    bms, bby = bound(nbytes, feats.numel(),
                     BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S)
    return {
        "name": "grid_scatter_max_occ",
        "route": "cuda",
        "source": "liso_tpu_torch/kernels/grid_scatter_max.cu",
        "replaces": "liso_tpu/ops/grid_scatter_pallas.py:85",
        "max_abs_err": float((got_g.float() - want_g.float()).abs().max()),
        "ms": cuda_ms(lambda: grid_scatter.grid_scatter_max_occ(feats, cells, nc)),
        "kernel_only_ms": kernel_only_ms(
            lambda: grid_scatter.grid_scatter_max_occ(feats, cells, nc),
            "grid_scatter_max_occ_kernel"),
        "host_ms": host_ms(
            lambda: grid_scatter.grid_scatter_max_occ(feats, cells, nc)),
        "plain_ms": cuda_ms(
            lambda: grid_scatter.grid_scatter_max_occ(feats, cells, nc, plain=True)
        ),
        "bound_ms": bms,
        "bound_by": bby,
        "library_ms": cuda_ms(library),
        "library_call": "torch.zeros [B, nc + 1, C] + scatter_reduce_ amax",
        "library_ms_prezeroed": cuda_ms(
            lambda: lib_out.scatter_reduce_(1, idx, feats, "amax", include_self=False)
        ),
        "bytes": nbytes,
        "points_in_grid": in_grid,
        "shape": f"feats [{b}, {n}, {c}] {dtype_name(dtype)} -> grid "
                 f"[{b}, {nc}, {c}]",
    }


def occupied_cells(cells, nc):
    """Distinct grid cells that ascending ids [B, N] reach (ids >= nc are
    dropped)."""
    return int((cells[:, :1] < nc).sum()) + int(
        ((cells[:, 1:] != cells[:, :-1]) & (cells[:, 1:] < nc)).sum())


def check_gather(gen, cells, nc, c, dtype):
    """K4 against its plain version (bitwise) on a random grid at the given
    cells (drop bucket for the points outside a pillar)."""
    import torch

    from liso_tpu_torch.ops import grid_scatter

    b, n = cells.shape
    grid = torch.randn(b, nc, c, generator=gen, device="cuda").to(dtype)
    got = grid_scatter.grid_gather(grid, cells)
    want = grid_scatter.grid_gather(grid, cells, plain=True)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"K4 grid_gather differs from its plain version at grid "
             f"[{b}, {nc}, {c}] {dtype_name(dtype)}")
    in_grid = int((cells < nc).sum())
    idx = cells.long().clamp(max=nc - 1)[..., None].expand(-1, -1, c)
    es = grid.element_size()
    # read the cells and the grid rows of their (distinct) cells, write out
    nbytes = (cells.numel() * 4 + occupied_cells(cells, nc) * c * es
              + got.numel() * es)
    bms, bby = bound(nbytes, 0, FP32_FLOP_PER_S)
    return {
        "name": "grid_gather", "route": "cuda",
        "source": "liso_tpu_torch/kernels/grid_gather.cu",
        "replaces": "liso_tpu/ops/grid_scatter_pallas.py:210",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": cuda_ms(lambda: grid_scatter.grid_gather(grid, cells)),
        "kernel_only_ms": kernel_only_ms(
            lambda: grid_scatter.grid_gather(grid, cells), "grid_gather_kernel"),
        "host_ms": host_ms(lambda: grid_scatter.grid_gather(grid, cells)),
        "plain_ms": cuda_ms(lambda: grid_scatter.grid_gather(grid, cells, plain=True)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(lambda: torch.gather(grid, 1, idx)),
        "library_call": "torch.gather (no drop-bucket mask)",
        "bytes": nbytes, "points_in_grid": in_grid,
        "occupied_cells": occupied_cells(cells, nc),
        "shape": f"grid [{b}, {nc}, {c}] {dtype_name(dtype)} at cells "
                 f"[{b}, {n}] -> [{b}, {n}, {c}]",
    }


def check_bn_relu_eval(gen, shape, channel_dim, dtype, bn_dtype,
                       layout=None):
    """The eval BatchNorm + ReLU kernel against its plain version (bitwise,
    NaN, infinities and signed zeros spread over the input; the same
    layout) at a path's shape and memory layout; with random running
    statistics, affine and some biases -0."""
    import torch
    import torch.nn.functional as F

    from liso_tpu_torch.models import layers

    c = shape[channel_dim]
    bn = layers.BatchNorm(c, 1e-3, dtype=bn_dtype, channel_dim=channel_dim,
                          device="cuda").eval()
    with torch.no_grad():
        bn.running_mean.normal_(generator=gen)
        bn.running_var.uniform_(1e-3, 2.0, generator=gen)
        bn.weight.normal_(generator=gen)
        bn.bias.normal_(generator=gen).mul_(0.5)[::5] = -0.0
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype)
    idx = torch.randint(0, x.numel(), (35,), generator=gen, device="cuda")
    x.view(-1)[idx] = torch.tensor(
        [float("nan"), float("inf"), -float("inf"), -0.0, 0.0],
        device="cuda").repeat(7).to(dtype)
    x = x.contiguous(memory_format=layout or torch.contiguous_format)
    args = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps,
            channel_dim, bn_dtype)

    def kernel():
        with torch.inference_mode():
            return bn.forward_relu(x)

    def plain():
        with torch.inference_mode():
            return layers.bn_relu_eval_plain(x, *args)

    x2d = x if channel_dim == 1 else x.view(-1, c)
    layout_name = ("channels_last" if layout == torch.channels_last
                   else "contiguous")

    def library():  # one fused PyTorch call and the relu, fp32 statistics
        with torch.inference_mode():
            return torch.relu(F.batch_norm(x2d, bn.running_mean, bn.running_var,
                                           bn.weight, bn.bias, False, 0.0,
                                           bn.eps))

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    if (got.dtype != want.dtype or got.stride() != want.stride()
            or not torch.equal(got.view(bits[got.dtype]),
                               want.view(bits[want.dtype]))):
        fail(f"bn_relu_eval differs from its plain version at {list(shape)} "
             f"{dtype_name(dtype)} {layout_name}")
    nbytes = x.numel() * (x.element_size() + got.element_size())
    bms, bby = bound(nbytes, 0, FP32_FLOP_PER_S)
    out_name = dtype_name(got.dtype)
    return {
        "name": "bn_relu_eval", "route": "cuda",
        "source": "liso_tpu_torch/kernels/bn_relu_eval.cu",
        "replaces": "none (the eval BatchNorm + ReLU composition of "
                    "liso_tpu_torch/models/layers.py)",
        "max_abs_err": 0.0,
        "ms": cuda_ms(kernel),
        "kernel_only_ms": kernel_only_ms(kernel, "bn_relu_eval_kernel"),
        "host_ms": host_ms(kernel),
        "plain_ms": cuda_ms(plain),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(library),
        "library_call": "torch.relu(F.batch_norm(training=False))",
        "bytes": nbytes,
        "shape": f"{list(shape)} {dtype_name(dtype)} -> {out_name}, "
                 f"channel dim {channel_dim}, {layout_name}",
    }


def wrapper_host_steps(grid, cells):
    """Host ms (host_ms, mean of 200 calls) of each step a kernel wrapper
    shares, taken alone at K4's inputs, beside the whole K4 wrapper and
    torch.gather: where a short call's event time goes besides the kernel.
    `torch.cuda.current_stream` is how the wrappers read the stream before
    `kernels.stream`; the entry point called with B = 0 returns before its
    launch (the ctypes call alone)."""
    import torch

    from liso_tpu_torch import kernels
    from liso_tpu_torch.ops import grid_scatter

    dev = grid.device
    idx = cells.long().clamp(max=grid.shape[1] - 1)[..., None].expand(
        -1, -1, grid.shape[2])
    one = torch.zeros(1, device=dev)
    steps = {
        "grid_gather": lambda: grid_scatter.grid_gather(grid, cells),
        "torch.gather": lambda: torch.gather(grid, 1, idx),
        "_check_cuda": lambda: grid_scatter._check_cuda(grid, cells),
        "kernels.function": lambda: kernels.function("grid_gather"),
        "kernels.stream": lambda: kernels.stream(dev),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "kernels.check": lambda: kernels.check(0, "grid_gather"),
        "torch.empty": lambda: torch.empty(*cells.shape, grid.shape[2],
                                           dtype=grid.dtype, device=dev),
        "entry point, B = 0": lambda: kernels.function("grid_gather")(
            grid.data_ptr(), cells.data_ptr(), grid.data_ptr(), 0,
            cells.shape[1], grid.shape[2], grid.shape[1], 1, kernels.stream(dev)),
        "Tensor.zero_, 4 bytes (one launch)": lambda: one.zero_(),
    }
    return {k: host_ms(fn, reps=200) for k, fn in steps.items()}


def check_scatter_max_vjp(gen, cells, nc, c, dtype, timed=True):
    """The fused scatter-max VJP against its plain version (bitwise, as bit
    patterns) at the given cells: features on a coarse lattice (ties that
    all win), the grid from K1, a random cotangent; with timed=False only
    that check."""
    import torch

    from liso_tpu_torch.ops import grid_scatter

    b, n = cells.shape
    feats = (torch.round(2 * torch.randn(b, n, c, generator=gen, device="cuda"))
             / 2).to(dtype)
    grid = grid_scatter.grid_scatter_max_occ(feats, cells, nc)[0]
    g_grid = torch.randn(b, nc, c, generator=gen, device="cuda").to(dtype)
    args = (feats, cells, grid, g_grid)
    got = grid_scatter.scatter_max_vjp(*args)
    want = grid_scatter.scatter_max_vjp(*args, plain=True)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    if not torch.equal(got.view(bits), want.view(bits)):
        fail(f"scatter_max_vjp differs from its plain version at feats "
             f"[{b}, {n}, {c}] {dtype_name(dtype)}")
    if not timed:
        return None
    idx = cells.long().clamp(max=nc - 1)[..., None].expand(-1, -1, c)
    kept = (cells < nc)[..., None]

    def library():  # two gathers, the drop mask, == and where
        win = kept & (feats == torch.gather(grid, 1, idx))
        return torch.where(win, torch.gather(g_grid, 1, idx), 0.0)
    # read the cells, the features of the points in the grid and the grid
    # and cotangent rows of their (distinct) cells; write dfeats
    in_grid = int(kept.sum())
    occupied = occupied_cells(cells, nc)
    es = feats.element_size()
    nbytes = (cells.numel() * 4 + (in_grid + 2 * occupied) * c * es
              + got.numel() * es)
    bms, bby = bound(nbytes, in_grid * c,
                     BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S)
    return {
        "name": "scatter_max_vjp", "route": "cuda",
        "source": "liso_tpu_torch/kernels/scatter_max_vjp.cu",
        "replaces": "liso_tpu/ops/grid_scatter_pallas.py:459",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": cuda_ms(lambda: grid_scatter.scatter_max_vjp(*args)),
        "kernel_only_ms": kernel_only_ms(
            lambda: grid_scatter.scatter_max_vjp(*args), "scatter_max_vjp_kernel"),
        "host_ms": host_ms(lambda: grid_scatter.scatter_max_vjp(*args)),
        "plain_ms": cuda_ms(lambda: grid_scatter.scatter_max_vjp(*args, plain=True)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(library),
        "library_call": "two torch.gather, the drop mask, == and torch.where",
        "bytes": nbytes, "points_in_grid": in_grid,
        "shape": f"feats [{b}, {n}, {c}] {dtype_name(dtype)}, grid and g_grid "
                 f"[{b}, {nc}, {c}] -> dfeats [{b}, {n}, {c}]",
    }


def shape_entry(r):
    """The numbers of a kernel check at a second shape, for the kernels
    line."""
    return {k: r[k] for k in ("shape", "max_abs_err", "max_err_over_bound", "ms",
                              "kernel_only_ms", "host_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "library_ms_prezeroed")
            if k in r}


def check_corr_fwd(f0, f1cat, coords, lv, layout):
    """K2 against its plain version: within one bf16 ulp plus the fp32
    sum-order slack of a cancelling dot (corr_fused.sum_order_slack), and
    every tap outside its level's padded extent exactly 0. Returns (got,
    want, |got - want|, one ulp, slack)."""
    import torch

    from liso_tpu_torch.ops import corr_fused

    got = corr_fused.fused_corr_window(f0, f1cat, coords, lv, 3)
    want = corr_fused.fused_corr_window(f0, f1cat, coords, lv, 3, plain=True)
    torch.cuda.synchronize()
    err = (got - want).abs()
    ulp = bf16_ulp(want) * 1.0001
    slack = corr_fused.sum_order_slack(f0, f1cat, coords, lv, 3)
    if not bool((err <= ulp + slack).all()):
        fail(f"K2 corr_window_fwd differs from its plain version by more than "
             f"one bf16 ulp plus the fp32 sum-order slack on {layout} (max "
             f"abs err {float(err.max())})")
    ok = torch.cat([corr_fused._window_cells(coords, lv, 3, lvl)[1]
                    for lvl in range(len(lv.shapes))], dim=-1).transpose(1, 2)
    if not bool((got[~ok] == 0).all()):
        fail(f"K2 corr_window_fwd: out-of-range taps are not exactly 0 on {layout}")
    return got, want, err, ulp, slack


def corr_lookups(fn, expect, what):
    """The inputs of K2's launches in one call of `fn` (one per RAFT
    iteration), captured by wrapping corr_fused.fused_corr_window; there
    must be `expect` of them."""
    from liso_tpu_torch.ops import corr_fused

    seen = []
    fwd = corr_fused.fused_corr_window

    def keep(f0, f1cat, coords_t, levels, radius, plain=False):
        seen.append((f0.detach().clone(), f1cat.detach().clone(),
                     coords_t.detach().clone(), levels))
        return fwd(f0, f1cat, coords_t, levels, radius, plain)

    corr_fused.fused_corr_window = keep
    try:
        fn()
    finally:
        corr_fused.fused_corr_window = fwd
    if len(seen) != expect:
        fail(f"{what} made {len(seen)} corr lookups, expected {expect}")
    return seen


def k2_lookups_layout(lookups, what):
    """K2 on the coords of a real forward's lookups (a streaming step's,
    the reference RAFT's): each held to the plain version; kernel-only
    (profiler, mean over the launches), event and plain ms of all the
    lookups, per launch; the flow (coords less the pixel grid, px) of each
    lookup; the bound of one lookup: its inputs read once (f0 as given,
    before the wrapper's bf16 rounding) and its taps written once, or its
    in-range dots (2 C operations a tap with a nonzero plain value, this
    run's data) at the bf16 rate, the larger."""
    import torch

    from liso_tpu_torch.ops import corr_fused

    errs, ops = [], 0
    for i, (f0, f1cat, coords, lv) in enumerate(lookups):
        _, want, err, _, _ = check_corr_fwd(f0, f1cat, coords, lv,
                                            f"{what}'s lookup {i}")
        errs.append(float(err.max()))
        ops += int((want != 0).sum()) * 2 * f0.shape[-1]
    n = len(lookups)

    def run(plain=False):
        for f0, f1cat, coords, lv in lookups:
            corr_fused.fused_corr_window(f0, f1cat, coords, lv, 3, plain=plain)

    f0, f1cat, coords, lv = lookups[-1]
    h, w = lv.logical[0]
    grid = torch.stack(torch.meshgrid(
        torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
        indexing="ij")).float().reshape(1, 2, h * w)
    flow_px = [(c - grid).norm(dim=1) for _, _, c, _ in lookups]
    nbytes = (f0.numel() * f0.element_size()
              + f1cat.numel() * f1cat.element_size() + coords.numel() * 4
              + f0.shape[0] * len(lv.shapes) * 64 * f0.shape[1] * 4)
    bms, bby = bound(nbytes, ops / n, BF16_FLOP_PER_S)
    return {
        "lookups": n,
        "shape": f"f0 {list(f0.shape)} {dtype_name(f0.dtype)}, f1cat "
                 f"{list(f1cat.shape)} bf16, {len(lv.shapes)} levels",
        "flow_px_mean": [float(f.mean()) for f in flow_px],
        "flow_px_max": [float(f.max()) for f in flow_px],
        "max_abs_err": max(errs),
        "bound_ms": bms, "bound_by": bby,
        "ms": cuda_ms(run) / n,
        "kernel_only_ms": kernel_only_ms(run, "corr_window_fwd_kernel"),
        "plain_ms": cuda_ms(lambda: run(plain=True)) / n,
    }


def phase_kernels():
    import torch

    from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
    from liso_tpu_torch.ops import corr_fused
    from liso_tpu_torch.ops.bev import BevSetup

    g = torch.Generator(device="cuda").manual_seed(1)
    bev = BevSetup((100.0, 100.0), (GRID, GRID))
    results = []

    # K1 at the fused streaming step's shapes: the real cell ids of a cloud,
    # signed bf16 features (so negative maxima are covered), C = 128
    (pts,), valid = clouds(0, 1)
    cells = prepare_pillar_inputs(pts, valid, bev).cell
    results.append(check_scatter_max(g, cells, bev.num_cells, 128,
                                     torch.bfloat16))

    # K2 at one RAFT lookup's shapes: coarse 64 x 64, C = 128, 4 levels;
    # coords = pixel grid + a random flow, some pixels far out of range
    hc = GRID // 8
    f0 = torch.randn(BATCH, hc * hc, 128, generator=g, device="cuda").to(
        torch.bfloat16
    )
    fmap1 = torch.randn(BATCH, hc, hc, 128, generator=g, device="cuda")
    f1cat, lv = corr_fused.pool_f1_levels(fmap1, 4)
    ii, jj = torch.meshgrid(
        torch.arange(hc, device="cuda"), torch.arange(hc, device="cuda"),
        indexing="ij",
    )
    base = torch.stack([ii, jj]).float().reshape(1, 2, hc * hc)
    coords = base + 4 * torch.randn(BATCH, 2, hc * hc, generator=g, device="cuda")
    coords[:, :, :64] = -1e4  # far out of range
    coords[:, 1, 64:128] = 3e3
    got, want, err, ulp, slack = check_corr_fwd(f0, f1cat, coords, lv,
                                                "the check's layout")
    beyond = err > ulp  # only where a dot cancels: see sum_order_slack
    in_range = want != 0  # taps with a real dot (an in-range dot of 0 is rare)
    k2_bytes = (f0.numel() * 2 + f1cat.numel() * 2 + coords.numel() * 4
                + got.numel() * 4)
    k2_ops = int(in_range.sum()) * 2 * 128
    k2_bound, k2_by = bound(k2_bytes, k2_ops, BF16_FLOP_PER_S)
    results.append({
        "name": "corr_window_fwd",
        "route": "cuda",
        "source": "liso_tpu_torch/kernels/corr_window_fwd.cu",
        "replaces": "liso_tpu/ops/corr_fused_pallas.py:154",
        "max_abs_err": float(err.max()),
        "ms": cuda_ms(lambda: corr_fused.fused_corr_window(f0, f1cat, coords, lv, 3)),
        "kernel_only_ms": kernel_only_ms(
            lambda: corr_fused.fused_corr_window(f0, f1cat, coords, lv, 3),
            "corr_window_fwd_kernel"),
        "plain_ms": cuda_ms(
            lambda: corr_fused.fused_corr_window(f0, f1cat, coords, lv, 3, plain=True)
        ),
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
        "bytes": k2_bytes,
        "flop": k2_ops,
        "taps_beyond_one_ulp": int(beyond.sum()),
        "taps": got.numel(),
        "max_abs_value_where_beyond_one_ulp": float(want[beyond].abs().max())
        if bool(beyond.any()) else 0.0,
        "max_slack_where_beyond_one_ulp": float(slack[beyond].max())
        if bool(beyond.any()) else 0.0,
        "shape": f"f0 [{BATCH}, {hc * hc}, 128] bf16, f1cat {list(f1cat.shape)} "
                 f"bf16 -> taps {list(got.shape)} f32",
    })

    # eval BatchNorm + ReLU at CenterPoint's stage 0 (channels_last, as the
    # path holds it; and NCHW) and a pillar encoder's norm in a streaming
    # step at n_max 65536
    stage0 = (BATCH, 64, GRID // 2, GRID // 2)
    bn_stage0 = check_bn_relu_eval(g, stage0, 1, torch.bfloat16,
                                   torch.bfloat16, torch.channels_last)
    bn_stage0["nchw_shape"] = shape_entry(check_bn_relu_eval(
        g, stage0, 1, torch.bfloat16, torch.bfloat16))
    bn_stage0["pfn_shape"] = shape_entry(check_bn_relu_eval(
        g, (BATCH, 65536, 64), -1, torch.float32, None))
    results.append(bn_stage0)
    return results


def bench_clouds(trainer):
    """The JAX train benchmark's clouds (benchmarks/slim_920_bench.py:58-74):
    numpy RandomState(0), two frames of 65536 points uniform in a cube of
    +-58 m, all valid, identity odometry."""
    import numpy as np
    import torch

    from liso_tpu_torch.data.sample import FlowSample, PointCloud

    rng = np.random.RandomState(0)
    half = 0.5 * T_RANGE - 2.0
    pcs = [PointCloud(
        torch.from_numpy(rng.uniform(-half, half, (1, T_PTS, 4)).astype(np.float32)).cuda(),
        torch.ones(1, T_PTS, dtype=torch.bool, device="cuda")) for _ in range(2)]
    eye = torch.eye(4, device="cuda")[None]
    return FlowSample(pcs[0], pcs[1], eye, eye)


def check_grid_reduce_add(gen, cells, nc, c, dtype):
    """K1-add against its plain version (fp32 sums rounded once) at the
    given cells: within 2 n 2^-24 sum|v| per cell, plus one ulp of a bf16
    output (two fp32 sums may round to neighbouring bf16 values)."""
    import torch

    from liso_tpu_torch.ops import grid_scatter

    b, n = cells.shape
    gv = torch.randn(b, n, c, generator=gen, device="cuda").to(dtype)
    got = grid_scatter.grid_reduce_add(gv, cells, nc)
    want = grid_scatter.grid_reduce_add(gv, cells, nc, plain=True)
    absum = grid_scatter.grid_reduce_add(gv.float().abs(), cells, nc, plain=True)
    cnt = grid_scatter.grid_reduce_add(
        torch.ones(b, n, 1, device="cuda"), cells, nc, plain=True)
    torch.cuda.synchronize()
    tol = 2 * cnt * 2.0**-24 * absum
    if dtype == torch.bfloat16:
        tol = tol + bf16_ulp(want.float())
    err = (got.float() - want.float()).abs()
    if not bool((err <= tol).all()):
        fail(f"K1-add grid_reduce_add (C = {c}) differs from its plain version "
             "beyond the fp32 sum-order bound")
    if not bool((got[(cnt == 0).expand_as(got)] == 0).all()):
        fail("K1-add grid_reduce_add: an empty cell is not 0")
    in_grid = int((cells < nc).sum())
    es = gv.element_size()
    # read the rows that reach the grid and the cells, write the grid
    nbytes = cells.numel() * 4 + in_grid * c * es + got.numel() * es
    bms, bby = bound(nbytes, in_grid * c, FP32_FLOP_PER_S)
    idx = cells[0].long().clamp(max=nc)
    lib_out = torch.zeros(b, nc + 1, c, dtype=dtype, device="cuda")
    return {
        "name": "grid_reduce_add", "route": "cuda",
        "source": "liso_tpu_torch/kernels/grid_reduce_add.cu",
        "replaces": "liso_tpu/ops/grid_scatter_pallas.py:118",
        "max_abs_err": float(err.max()),
        "max_err_over_bound": float((err / tol.clamp(min=1e-30)).max()),
        "ms": cuda_ms(lambda: grid_scatter.grid_reduce_add(gv, cells, nc)),
        "kernel_only_ms": kernel_only_ms(
            lambda: grid_scatter.grid_reduce_add(gv, cells, nc),
            "grid_reduce_add_kernel"),
        "host_ms": host_ms(lambda: grid_scatter.grid_reduce_add(gv, cells, nc)),
        "plain_ms": cuda_ms(
            lambda: grid_scatter.grid_reduce_add(gv, cells, nc, plain=True)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(lambda: lib_out.index_add_(1, idx, gv)),
        "library_call": "index_add_ into a zeroed grid with a drop row",
        "bytes": nbytes, "points_in_grid": in_grid,
        "shape": f"g [{b}, {n}, {c}] {str(dtype).split('.')[-1]} -> "
                 f"[{b}, {nc}, {c}]",
    }


def check_histogram(vals, bins, nb, layout):
    """K3 against its plain version, within the fp32 sum-order bound
    2 cnt 2^-24 sum|v| per bin, empty bins exactly 0; times beside
    `index_add_` into a fresh zeroed histogram with a drop row (K3's
    function) and into a reused one (`library_ms_prezeroed`)."""
    import torch

    from liso_tpu_torch.ops import grid_scatter

    rows, n = vals.shape
    got = grid_scatter.grid_reduce_add_c1(vals, bins, nb)
    want = grid_scatter.grid_reduce_add_c1(vals, bins, nb, plain=True)
    absum = grid_scatter.grid_reduce_add_c1(vals.abs(), bins, nb, plain=True)
    cnt = grid_scatter.grid_reduce_add_c1(torch.ones_like(vals), bins, nb, plain=True)
    torch.cuda.synchronize()
    tol = 2 * cnt * 2.0**-24 * absum
    err = (got - want).abs()
    if not bool((err <= tol).all()):
        fail(f"K3 grid_reduce_add_c1 differs from its plain version beyond the "
             f"fp32 sum-order bound ({layout} bins)")
    if not bool((got[cnt == 0] == 0).all()):
        fail(f"K3 grid_reduce_add_c1: an empty bin is not 0 ({layout} bins)")
    flat = (bins.long().clamp(max=nb)
            + torch.arange(rows, device="cuda")[:, None] * (nb + 1)).reshape(-1)
    lib_out = torch.zeros(rows * (nb + 1), device="cuda")

    def library():  # K3's function: a fresh histogram each call
        return torch.zeros(rows * (nb + 1), device="cuda").index_add_(
            0, flat, vals.reshape(-1))
    # the kernel's work follows the values in its busiest cluster of blocks,
    # a span of 16384 bins (grid_reduce_add_c1.cu)
    per_span = torch.nn.functional.pad(cnt, (0, -nb % 16384)).reshape(
        rows, -1, 16384).sum(-1)
    nbytes = vals.numel() * 4 + bins.numel() * 4 + got.numel() * 4
    bms, bby = bound(nbytes, vals.numel(), FP32_FLOP_PER_S)
    return {
        "name": "grid_reduce_add_c1", "route": "cuda",
        "source": "liso_tpu_torch/kernels/grid_reduce_add_c1.cu",
        "replaces": "liso_tpu/ops/grid_scatter_pallas.py:176",
        "max_abs_err": float(err.max()),
        "max_err_over_bound": float((err / tol.clamp(min=1e-30)).max()),
        "ms": cuda_ms(lambda: grid_scatter.grid_reduce_add_c1(vals, bins, nb)),
        "kernel_only_ms": kernel_only_ms(
            lambda: grid_scatter.grid_reduce_add_c1(vals, bins, nb),
            "grid_reduce_add_c1_kernel"),
        "host_ms": host_ms(lambda: grid_scatter.grid_reduce_add_c1(vals, bins, nb)),
        "plain_ms": cuda_ms(lambda: grid_scatter.grid_reduce_add_c1(vals, bins, nb, plain=True)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(library),
        "library_call": "torch.zeros + index_add_",
        "library_ms_prezeroed": cuda_ms(
            lambda: lib_out.index_add_(0, flat, vals.reshape(-1))),
        "bytes": nbytes,
        "largest_bin": int(cnt.max()),
        "bins_over_32": int((cnt > 32).sum()),
        "fullest_span": int(per_span.max()),
        "shape": f"vals [{rows}, {n}] fp32, {layout} bins sorted -> "
                 f"[{rows}, {nb}] fp32",
    }


def phase_train_kernels(trainer, batch):
    """K1 and K3-K6 at the SLIM train step's shapes."""
    import torch

    from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
    from liso_tpu_torch.models.raft import coarse_size
    from liso_tpu_torch.ops import corr_fused, grid_scatter, knn_banded

    g = torch.Generator(device="cuda").manual_seed(2)
    results = []
    sorted_batch, _ = trainer._sort_batch(batch)
    p0, p1 = sorted_batch.pcl_t0, sorted_batch.pcl_t1

    # K4: the TPU VJP's gather (no path launches it now), grid [1, 846400,
    # 64] bf16 at the cell ids of frame 0 (drop bucket for the points
    # outside a pillar), with the host time of each step its wrapper
    # shares; and at the decoder's gated flow gather, grid [1, 846400, 2]
    # fp32 at the same cells (slim_decoder.py:118-128); the fused VJP at
    # the same cells (their own generators: the later checks keep their
    # inputs)
    nc = trainer.bev.num_cells
    cells = prepare_pillar_inputs(p0.pcl, p0.valid, trainer.bev).cell
    k4 = check_gather(g, cells, nc, 64, torch.bfloat16)
    k4["host_steps_ms"] = wrapper_host_steps(
        torch.zeros(1, nc, 64, dtype=torch.bfloat16, device="cuda"), cells)
    k4["decoder_shape"] = shape_entry(check_gather(
        torch.Generator(device="cuda").manual_seed(8), cells, nc, 2,
        torch.float32))
    results.append(k4)
    results.append(check_scatter_max_vjp(
        torch.Generator(device="cuda").manual_seed(7), cells, nc, 64,
        torch.bfloat16))
    # K1 at this step's own call: the pillar encoder's bf16 scatter of
    # C = 64 features into the 846400 cells (its own generator)
    k1 = check_scatter_max(torch.Generator(device="cuda").manual_seed(5),
                           cells, nc, 64, torch.bfloat16)

    # K1-add, the grid_gather backward: (a) the adjoint of K4's check, g
    # [1, 65536, 64] bf16 into the 846400 cells; (b) the decoder's gated
    # flow gather, C = 2 fp32. No path runs it (slim_decoder.py:120).
    # (its own generator: the later checks keep their inputs)
    g_add = torch.Generator(device="cuda").manual_seed(3)
    k1add = [check_grid_reduce_add(g_add, cells, nc, c, dt)
             for c, dt in ((64, torch.bfloat16), (2, torch.float32))]
    results.append({**k1add[0], "second_shape": shape_entry(k1add[1])})
    results.append(k1)

    # K3: the threshold histogram, 6 iterations x (fw + bw) points, 100000
    # bins padded to 100352, bins sorted per row: dynamicness uniform over
    # the bins, and skewed (every value in 8 bins and 1% dropped, as early
    # in training, when the head's sigmoid of near-random weights crowds
    # the dynamicness; its own generator: the later checks keep their
    # inputs)
    rows, n, nb = T_ITERS, 2 * T_PTS, -(-100_000 // 2048) * 2048
    dyn = torch.rand(rows, n, generator=g, device="cuda")
    bins = torch.sort((dyn * 100_000).int().clamp(0, 99_999), dim=-1).values
    vals = torch.randn(rows, n, generator=g, device="cuda")
    k3 = check_histogram(vals, bins, nb, "uniform")
    g_skew = torch.Generator(device="cuda").manual_seed(6)
    hot = torch.randint(0, 100_000, (8,), generator=g_skew, device="cuda").int()
    skew = hot[torch.randint(0, 8, (rows, n), generator=g_skew, device="cuda")]
    skew[:, -n // 100:] = torch.iinfo(torch.int32).max
    skew = torch.sort(skew, dim=-1).values
    k3["skewed_layout"] = {
        k: v for k, v in check_histogram(vals, skew, nb, "skewed").items()
        if k not in ("name", "route", "source", "replaces")}
    results.append(k3)
    del dyn, bins, vals, skew

    # K5: one corr backward of the 115 x 115 coarse grid, C = 128, 4 levels,
    # f0 in bf16 as the bf16 train step saves it
    hc = coarse_size(T_GRID)  # 115
    f0 = torch.randn(1, hc * hc, 128, generator=g, device="cuda").to(
        torch.bfloat16)
    f1cat, lv = corr_fused.pool_f1_levels(
        torch.randn(1, hc, hc, 128, generator=g, device="cuda"), 4)
    ii, jj = torch.meshgrid(torch.arange(hc, device="cuda"),
                            torch.arange(hc, device="cuda"), indexing="ij")
    coords = torch.stack([ii, jj]).float().reshape(1, 2, hc * hc)
    coords = coords + 2 * torch.randn(1, 2, hc * hc, generator=g, device="cuda")
    coords[:, :, :64] = -1e4  # far out of range: no cotangent
    gt = torch.randn(1, len(lv.shapes) * 64, hc * hc, generator=g, device="cuda")
    args = (f0, f1cat, coords, gt, lv, 3)
    got = corr_fused.corr_window_bwd(*args)
    want = corr_fused.corr_window_bwd(*args, plain=True)
    slack = corr_fused.bwd_sum_order_slack(*args)
    torch.cuda.synchronize()
    ratio = 0.0
    for x, y, sl in zip(got, want, slack):
        if not bool(((x - y).abs() <= sl + 1e-30).all()):
            fail("K5 corr_window_bwd differs from its plain version beyond the "
                 "fp32 sum-order slack")
        ratio = max(ratio, float(((x - y).abs() / sl.clamp(min=1e-30)).max()))
    in_range = sum(int(corr_fused._window_cells(coords, lv, 3, lvl)[1].sum())
                   for lvl in range(len(lv.shapes)))
    nbytes = (f0.numel() * 2 + f1cat.numel() * 2 + coords.numel() * 4
              + gt.numel() * 4 + got[0].numel() * 4 + got[1].numel() * 4)
    # bf16 x bf16 products summed in fp32: the card's bf16 rate bounds them,
    # whatever units the kernel uses
    bms, bby = bound(nbytes, in_range * 128 * 4, BF16_FLOP_PER_S)
    results.append({
        "name": "corr_window_bwd", "route": "cuda",
        "source": "liso_tpu_torch/kernels/corr_window_bwd.cu",
        "replaces": "liso_tpu/ops/corr_fused_pallas.py:192",
        "max_abs_err": max(float((x - y).abs().max()) for x, y in zip(got, want)),
        "max_err_over_slack": ratio,
        "ms": cuda_ms(lambda: corr_fused.corr_window_bwd(*args)),
        "kernel_only_ms": kernel_only_ms(
            lambda: corr_fused.corr_window_bwd(*args), "corr_window_bwd_kernel"),
        "plain_ms": cuda_ms(lambda: corr_fused.corr_window_bwd(*args, plain=True)),
        "bound_ms": bms, "bound_by": bby, "library_ms": None,
        "bytes": nbytes, "flop": in_range * 128 * 4, "in_range_taps": in_range,
        "shape": f"g {list(gt.shape)} fp32, f0 {list(f0.shape)}, f1cat "
                 f"{list(f1cat.shape)} -> df0, df1 fp32",
    })
    del f0, f1cat, gt, got, want, slack

    # K6: one direction's batched 1-NN, 6 iterations x 3 flow types of
    # frame 0 warped by a small random flow, against frame 1
    flows = 0.3 * torch.randn(18, T_PTS, 3, generator=g, device="cuda")
    q = (p0.pcl[0, :, :3][None] + flows).reshape(1, 18 * T_PTS, 3)
    qv = p0.valid.repeat(1, 18)
    refs, rv = p1.pcl[..., :3].contiguous(), p1.valid
    visited = torch.zeros(1, dtype=torch.int64, device="cuda")
    d, ix = knn_banded.nn_1_sorted(q, refs, qv, rv, visited=visited)
    visited_pairs = int(visited)
    # the function the kernel computes: the exact 1-NN over each chunk's
    # band, every valid query (margin inf: no query is out of band)
    db, ib = knn_banded.nn_1_sorted_band_plain(q, refs, qv, rv, 8.0)
    agree = knn_banded.contract_report(q, refs, qv, rv, float("inf"), d, ix,
                                       db, ib)
    if agree["below_exact"] or agree["in_band_mismatch"]:
        fail(f"K6 knn_banded differs from the exact search of its band "
             f"beyond the fp32 slack: {agree}")
    dp, ip = knn_banded.nn_1_sorted(q, refs, qv, rv, plain=True)
    rep = knn_banded.contract_report(q, refs, qv, rv, 8.0, d, ix, dp, ip)
    if rep["below_exact"] or rep["in_band_mismatch"]:
        fail(f"K6 knn_banded breaks its approximation contract: {rep}")
    qpen = torch.where(qv, 0.0, knn_banded.BIG)
    rpen = torch.where(rv, 0.0, knn_banded.BIG)
    ranges = knn_banded.band_ranges(q, qpen, refs, rpen, 8.0)
    tile_pairs = int((ranges[..., 1] - ranges[..., 0]).sum()) * 1024 * 512
    # the work this run's data needs (knn_banded.needed_pairs): per valid
    # query, the valid refs of its band within the kernel's stop radius at
    # the exact answer, 3 FMAs (6 flop) each for the distance. The pairs the
    # kernel tested (visited_pairs, its own count) are reported beside it.
    # The full-band design's bound (band_bound_ms) counted the valid pairs
    # within the 8 m x-band, the tile-band bound every pair of the band's
    # tiles.
    needed = knn_banded.needed_pairs(q, refs, qv, rv, db)
    rx = torch.sort(refs[0, rv[0], 0]).values
    qx = q[0, qv[0], 0]
    pairs = int((torch.searchsorted(rx, qx + 8.0, right=True)
                 - torch.searchsorted(rx, qx - 8.0)).sum())
    nbytes = q.numel() * 4 + refs.numel() * 4 + qv.numel() + rv.numel() + d.numel() * 8
    bms, bby = bound(nbytes, needed * 6, FP32_FLOP_PER_S)
    step = 16384

    def cdist_argmin():
        for s in range(0, q.shape[1], step):
            torch.cdist(q[:, s:s + step], refs).argmin(-1)

    results.append({
        "name": "knn_banded", "route": "cuda",
        "source": "liso_tpu_torch/kernels/knn_banded.cu",
        "replaces": "liso_tpu/ops/knn_pallas.py:33",
        "max_abs_err": float((d - db).abs()[qv].max()),
        "max_abs_err_vs_exact": float((d - dp).abs()[qv].max()),
        "band_agreement": agree,
        "contract": rep,
        "ms": cuda_ms(lambda: knn_banded.nn_1_sorted(q, refs, qv, rv)),
        "kernel_only_ms": kernel_only_ms(
            lambda: knn_banded.nn_1_sorted(q, refs, qv, rv), "knn_banded_kernel"),
        "plain_ms": cuda_ms(lambda: knn_banded.nn_1_sorted(q, refs, qv, rv, plain=True)),
        "bound_ms": bms, "bound_by": bby,
        "needed_pairs": needed, "visited_pairs": visited_pairs,
        "visited_over_needed": visited_pairs / max(needed, 1),
        "band_bound_ms": bound(nbytes, pairs * 6, FP32_FLOP_PER_S)[0],
        "library_ms": cuda_ms(cdist_argmin, reps=5, warmup=1),
        "library_call": f"torch.cdist + argmin, fp32, over {step}-query chunks "
                        "(the whole distance matrix would take 309 GB), median of 5",
        "bytes": nbytes, "flop": needed * 6, "band_pairs": pairs,
        "tile_band_pairs": tile_pairs,
        "tile_band_bound_ms": bound(nbytes, tile_pairs * 6, FP32_FLOP_PER_S)[0],
        "shape": f"q [1, {18 * T_PTS}, 3], refs [1, {T_PTS}, 3] fp32 -> d, idx",
    })
    return results


def step_histogram(trainer, batch):
    """The threshold histogram's inputs in one SLIM train step: the sorted
    values and bins that `models/slim.py:_histograms` hands K3."""
    from liso_tpu_torch.models import slim

    seen = []
    k3 = slim.grid_reduce_add_c1

    def keep(vals, bins, num_bins, plain=False):
        seen.append((vals.clone(), bins.clone(), num_bins))
        return k3(vals, bins, num_bins, plain)

    slim.grid_reduce_add_c1 = keep
    try:
        trainer.train_step(batch)
    finally:
        slim.grid_reduce_add_c1 = k3
    if len(seen) != 1:
        fail(f"a SLIM train step built {len(seen)} histograms, expected 1")
    return seen[0]


def snapshot(trainer, names):
    """A copy of a trainer's model state and of its attributes `names`
    (dicts of tensors, such as optimizer moments, or immutable values)."""
    import copy

    return copy.deepcopy(trainer.model.state_dict()), {
        n: copy.deepcopy(getattr(trainer, n)) for n in names}


def restore(trainer, snap):
    """Put a snapshot back; tensors in dicts are copied in place."""
    import torch

    state, attrs = snap
    trainer.model.load_state_dict(state)
    for n, v in attrs.items():
        if isinstance(v, dict):
            with torch.no_grad():
                for k, t in v.items():
                    getattr(trainer, n)[k].copy_(t)
        else:
            setattr(trainer, n, v)


FAMILIES = (
    ("K5 corr_window_bwd", ("corr_window_bwd",)),
    ("K2 corr_window_fwd", ("corr_window_fwd",)),
    ("K6 knn_banded", ("knn_banded",)),
    ("K1 grid_scatter_max_occ", ("grid_scatter_max",)),
    ("K4 grid_gather", ("grid_gather",)),
    ("K4 scatter_max_vjp", ("scatter_max_vjp",)),
    ("K3 grid_reduce_add_c1", ("grid_reduce_add_c1",)),
    ("K1-add grid_reduce_add", ("grid_reduce_add_kernel",)),
    ("NCHW <-> NHWC layout transforms (cuDNN)", ("nchwToNhwc", "nhwcToNchw")),
    ("GroupNorm / BatchNorm", ("Norm", "norm", "RowwiseMoments",
                               "ComputeInternalGradients",
                               "ComputeFusedParams", "bn_fw", "bn_bw")),
    # cuDNN's fp32 FFT convolutions run complex cuBLAS GEMMs (cf32)
    ("convolutions (cuDNN)", ("implicit_gemm", "implicit_convolve", "fprop",
                              "dgrad", "wgrad", "conv", "cudnn", "fft",
                              "cf32")),
    ("matmul (cuBLAS, CUTLASS)", ("gemm", "Kernel2", "cublas")),
    ("sort, scan, searchsorted", ("sort", "scan", "search", "Radix", "radix")),
    ("reductions", ("reduce",)),
    ("cat", ("CatArray",)),  # not "cat": it is in "scatter"
    ("index, gather, scatter (torch)", ("index", "gather", "scatter")),
    ("device-side asserts", ("assert",)),
    ("elementwise and copies", ("elementwise", "vectorized", "unrolled",
                                "copy", "fill", "Memcpy", "Memset")),
)


def families(rows):
    """Device ms by kernel family from profile rows (us, count, key)."""
    out = {}
    for us, _, key in rows:
        name = next((f for f, keys in FAMILIES if any(k in key for k in keys)),
                    "other")
        out[name] = out.get(name, 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def phase_train(kernels):
    """The SLIM train step at the JAX train benchmark's point."""
    import torch

    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.train.slim_train import SlimTrainer

    bev = BevSetup((T_RANGE, T_RANGE), (T_GRID, T_GRID))
    trainer = SlimTrainer(
        bev, num_iters=T_ITERS, predict_weight_for_static_aggregation="sigmoid",
        use_static_aggr_flow_for_aggr_flow=True, compute_dtype=torch.bfloat16,
        seed=0, device="cuda",
    )
    batch = bench_clouds(trainer)
    z_ok = int((batch.pcl_t0.pcl[..., 2].abs() < 5.0).sum())
    kres = phase_train_kernels(trainer, batch)
    for _ in range(T_WARMUP):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_ms, losses = [], []
    for _ in range(T_STEPS):
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches = dict(kernels.launches)
    per_step = {"grid_scatter_max_occ": 2, "corr_window_fwd": 2 * T_ITERS,
                "scatter_max_vjp": 2, "grid_reduce_add_c1": 1,
                "corr_window_bwd": 2 * T_ITERS, "knn_banded": 2}
    expect = {k: per_step.get(k, 0) * T_STEPS for k in launches}
    if launches != expect:
        fail(f"train step launches {launches}, expected {expect}")
    for k in ("grid_reduce_add_c1", "scatter_max_vjp", "corr_window_bwd",
              "knn_banded"):
        if launches[k] == 0:
            fail(f"the train step did not launch {k}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        fail(f"train losses not finite: {losses}")
    if not all(bool(torch.isfinite(p).all()) for p in trainer.params.values()):
        fail("parameters not finite after the train steps")

    snap = snapshot(trainer, ("nu", "step", "movavg"))
    # K3 on the step's own histogram at the timed state
    k3_step = check_histogram(*step_histogram(trainer, batch), "SLIM step")
    restore(trainer, snap)
    for r in kres:
        if r["name"] == "grid_reduce_add_c1":
            r["slim_step_layout"] = {
                k: v for k, v in k3_step.items()
                if k not in ("name", "route", "source", "replaces")}
    # two profiled steps, each in its own profiler session: one call's
    # profile once reported every kernel at half its duration, and a second
    # sample shows such a session up
    counts, dev_ms, rows, host_rows = confirm_launches(
        lambda: trainer.train_step(batch),
        {**{k: 0 for k in launches}, **per_step}, "a SLIM train step",
        host=True)
    second_dev_ms = profile_window(lambda: trainer.train_step(batch))[1]
    restore(trainer, snap)
    mk = trainer.train_step(batch)
    restore(trainer, snap)
    kernels.reset_launches()
    with kernels.plain_versions():
        mp = trainer.train_step(batch)
    torch.cuda.synchronize()
    if any(kernels.launches.values()):
        fail(f"the plain step launched kernels: {dict(kernels.launches)}")
    cmp = {k: (float(mk[k]), float(mp[k])) for k in ("loss", "grad_norm")}
    for k, rtol in (("loss", TRAIN_LOSS_RTOL), ("grad_norm", TRAIN_GRAD_NORM_RTOL)):
        a, b = cmp[k]
        if not (a == a and b == b) or abs(a - b) > rtol * abs(b):
            fail(f"train step {k}: kernel path {a} vs plain path {b} (rtol {rtol})")
    res = {
        "phase": "train",
        "grid": T_GRID, "range_m": T_RANGE, "points": T_PTS, "batch": 1,
        "iters": T_ITERS, "dtype": "bf16", "flags": "slim_liso",
        "points_in_pillar_z_window": z_ok,
        "warmup_steps": T_WARMUP, "steps": T_STEPS,
        "step_ms_mean": statistics.mean(step_ms),
        "step_ms_median": statistics.median(step_ms),
        "step_ms_max": max(step_ms),
        "steps_per_s": 1e3 / statistics.mean(step_ms),
        "losses": losses,
        "launches": launches,
        "peak_memory_gb": peak_gb,
        "profiled_step": {"launches": counts, "device_ms": dev_ms,
                          "device_ms_second_session": second_dev_ms,
                          "searchsorted": searchsorted_stats(rows),
                          "device_ms_by_family": families(rows)},
        "kernel_vs_plain": cmp,
        "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                      "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL},
    }
    return kres, res, (rows, host_rows)


def drive_scene():
    """Two frames (t = 0, 1) of the mining benchmark's synthetic drive
    (benchmarks/mining_bench.py:42-69, numpy RandomState(0)): background
    uniform within +-45 m (z in [-1, 1.5]), 6 objects of 256 points, each a
    gaussian blob (sigma 0.9 m) moving at a constant velocity, intensity 1.
    Each object is a valid target box: its center, 3.6 m (+-2 sigma) on
    every side, heading along its velocity; 64 slots, the rest empty.
    Returns (points [2, 32768, 4], valid, target Boxes [2, 64])."""
    import numpy as np
    import torch

    from liso_tpu_torch.ops.boxes import Boxes

    rng = np.random.RandomState(0)
    n_obj = D_OBJECTS
    bg = rng.uniform(-45, 45, (D_PTS - 256 * n_obj, 3)).astype(np.float32)
    bg[:, 2] = rng.uniform(-1.0, 1.5, len(bg))
    obj_pos = rng.uniform(-30, 30, (n_obj, 3)).astype(np.float32)
    obj_pos[:, 2] = 0.0
    obj_vel = rng.uniform(-1.2, 1.2, (n_obj, 3)).astype(np.float32)
    obj_vel[:, 2] = 0.0
    obj_pts = rng.normal(0, 0.9, (n_obj, 256, 3)).astype(np.float32)
    frames, centers = [], []
    for t in range(D_BATCH):
        c = obj_pos + obj_vel * (t * 0.1)
        pcl = np.concatenate([bg, *(obj_pts + c[:, None])]).astype(np.float32)
        frames.append(np.concatenate([pcl, np.ones((len(pcl), 1), np.float32)], 1))
        centers.append(c)
    target = Boxes.empty(D_SLOTS, batch=(D_BATCH,), device="cuda")
    target.pos[:, :n_obj] = torch.from_numpy(np.stack(centers)).cuda()
    target.dims[:, :n_obj] = 3.6
    target.rot[:, :n_obj, 0] = torch.from_numpy(
        np.arctan2(obj_vel[:, 1], obj_vel[:, 0])).cuda()
    target.probs[:, :n_obj] = 1.0
    target.valid[:, :n_obj] = True
    pts = torch.from_numpy(np.stack(frames)).cuda()
    return pts, torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda"), target


def phase_detect_train(kernels):
    """The CenterPoint detector's train and predict steps at full width."""
    import torch

    from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.train.detector_train import DetectorTrainer

    bev = BevSetup((D_RANGE, D_RANGE), (D_GRID, D_GRID))
    trainer = DetectorTrainer(bev, max_lr=D_MAX_LR, total_steps=D_TOTAL_STEPS,
                              seed=0, device="cuda")
    pts, valid, target = drive_scene()
    # K1, K4 and the fused VJP at this path's shapes, on the drive's real
    # cells: the pillar encoder's fp32 scatter of C = 64 features, the TPU
    # VJP's gather and the VJP the backward launches
    g = torch.Generator(device="cuda").manual_seed(4)
    cells = prepare_pillar_inputs(pts, valid, bev).cell
    kres = [check(g, cells, bev.num_cells, 64, torch.float32)
            for check in (check_scatter_max, check_gather,
                          check_scatter_max_vjp)]
    for _ in range(T_WARMUP):
        trainer.train_step(pts, valid, target)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_ms, losses = [], []
    for _ in range(T_STEPS):
        t0 = time.perf_counter()
        m = trainer.train_step(pts, valid, target)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss/total"]))
    launches = dict(kernels.launches)
    per_step = {"grid_scatter_max_occ": 1, "scatter_max_vjp": 1}
    expect = {k: per_step.get(k, 0) * T_STEPS for k in launches}
    if launches != expect:
        fail(f"detector train step launches {launches}, expected {expect}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        fail(f"detector train losses not finite: {losses}")
    if not all(bool(torch.isfinite(p).all()) for p in trainer.params.values()):
        fail("detector parameters not finite after the train steps")

    snap = snapshot(trainer, ("mu", "nu", "step", "count"))
    zero = {k: 0 for k in kernels.launches}
    counts, dev_ms, rows, host_rows = confirm_launches(
        lambda: trainer.train_step(pts, valid, target), {**zero, **per_step},
        "a detector train step", host=True)
    second_dev_ms = profile_window(
        lambda: trainer.train_step(pts, valid, target))[1]
    # kernel step against plain step under cuDNN's deterministic algorithms,
    # so that the two differ only where the kernels could
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        restore(trainer, snap)
        mk = trainer.train_step(pts, valid, target)
        restore(trainer, snap)
        kernels.reset_launches()
        with kernels.plain_versions():
            mp = trainer.train_step(pts, valid, target)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    if any(kernels.launches.values()):
        fail(f"the plain detector step launched kernels: {dict(kernels.launches)}")
    cmp = {k: (float(mk[k]), float(mp[k])) for k in ("loss/total", "grad_norm")}
    for k, rtol in (("loss/total", DET_LOSS_RTOL), ("grad_norm", DET_GRAD_NORM_RTOL)):
        a, b = cmp[k]
        if not (a == a and b == b) or abs(a - b) > rtol * abs(b):
            fail(f"detector train step {k}: kernel path {a} vs plain path {b} "
                 f"(rtol {rtol})")

    # predict_step from the state after the timed steps
    restore(trainer, snap)
    trainer.predict_step(pts, valid)  # warm-up
    kernels.reset_launches()
    pred_ms = []
    for _ in range(D_PREDICTS):
        t0 = time.perf_counter()
        boxes = trainer.predict_step(pts, valid)
        torch.cuda.synchronize()
        pred_ms.append((time.perf_counter() - t0) * 1e3)
    pred_launches = dict(kernels.launches)
    if pred_launches != {**zero, "grid_scatter_max_occ": D_PREDICTS,
                         "bn_relu_eval": eval_norms(trainer.model) * D_PREDICTS}:
        fail(f"predict_step launches {pred_launches}, expected one K1 and "
             f"one eval BN + ReLU per norm per call")
    kept = boxes.valid.sum(-1)
    if tuple(boxes.pos.shape) != (D_BATCH, trainer.post_max_boxes, 3) or bool(
            (kept > trainer.post_max_boxes).any()):
        fail(f"predict_step boxes: shape {tuple(boxes.pos.shape)}, kept {kept.tolist()}")
    for f in ("pos", "dims", "rot", "probs"):
        if not bool(torch.isfinite(getattr(boxes, f)).all()):
            fail(f"predict_step {f} not finite")
    with kernels.plain_versions():
        ref = trainer.predict_step(pts, valid)
    box_diff = max(float((getattr(boxes, f) - getattr(ref, f)).abs().max())
                   for f in ("pos", "dims", "rot", "probs"))
    if not torch.equal(boxes.valid, ref.valid) or box_diff > DET_BOX_ATOL:
        fail(f"predict_step kept boxes differ from the plain run's (max abs "
             f"diff {box_diff}, kept {kept.tolist()} vs "
             f"{ref.valid.sum(-1).tolist()})")
    pcounts, pdev_ms, prows, _ = profile_window(
        lambda: trainer.predict_step(pts, valid))
    res = {
        "phase": "detect_train",
        "grid": D_GRID, "range_m": D_RANGE, "points": D_PTS, "batch": D_BATCH,
        "target_slots": D_SLOTS, "objects": D_OBJECTS,
        "dtype": "fp32 (TF32 off by DetectorTrainer)",
        "max_lr": D_MAX_LR, "total_steps": D_TOTAL_STEPS,
        "points_in_pillar_z_window": int((pts[..., 2].abs() < 5.0).sum()),
        "warmup_steps": T_WARMUP, "steps": T_STEPS,
        "step_ms_mean": statistics.mean(step_ms),
        "step_ms_median": statistics.median(step_ms),
        "step_ms_max": max(step_ms),
        "steps_per_s": 1e3 / statistics.mean(step_ms),
        "losses": losses,
        "launches": launches,
        "peak_memory_gb": peak_gb,
        "profiled_step": {"launches": counts, "device_ms": dev_ms,
                          "device_ms_second_session": second_dev_ms,
                          "device_busy_share": dev_ms / statistics.median(step_ms),
                          "searchsorted": searchsorted_stats(rows),
                          "device_ms_by_family": families(rows)},
        "kernel_vs_plain": cmp,
        "tolerance": {"loss_rtol": DET_LOSS_RTOL,
                      "grad_norm_rtol": DET_GRAD_NORM_RTOL,
                      "predict_box_atol": DET_BOX_ATOL},
        "predict_ms_median": statistics.median(pred_ms),
        "predict_ms_max": max(pred_ms),
        "predict_launches_per_call": {k: v // D_PREDICTS
                                      for k, v in pred_launches.items()},
        "predict_kept": kept.tolist(),
        "predict_max_abs_diff_vs_plain": box_diff,
        "predict_profiled": {"launches": pcounts, "device_ms": pdev_ms,
                             "device_busy_share": pdev_ms / statistics.median(pred_ms),
                             "device_ms_by_family": families(prows)},
    }
    return kres, res, (rows, host_rows, prows)


def state_equal(a, b) -> list:
    """Keys where two SlimTrainer.state_dict() trees differ: tensors by
    bit pattern (dtype and shape too), everything else by ==."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"keys {sorted(set(a) ^ set(b))}"]
        return [f"{k}/{d}" for k in a for d in state_equal(a[k], b[k])]
    if isinstance(a, torch.Tensor):
        same = (a.dtype == b.dtype and a.shape == b.shape
                and bool((a.reshape(-1).view(torch.uint8)
                          == b.reshape(-1).view(torch.uint8)).all()))
        return [] if same else [""]
    return [] if a == b else [f"{a!r} != {b!r}"]


def eval_norms(model) -> int:
    """Launches of the eval BatchNorm + ReLU kernel in one eval forward of
    `model` without a gradient: one for each of its BatchNorms, which
    every model of the port runs once a forward through `forward_relu`
    (baseline CenterPoint: 21 and its pillar encoder's; a SLIM frame: its
    pillar encoder's); none inside `kernels.plain_versions()`."""
    from liso_tpu_torch.models.layers import BatchNorm

    return sum(isinstance(m, BatchNorm) for m in model.modules())


def confirm_launches(fn, expect, what, host=False):
    """profile_window(fn, host), whose launch counts must equal `expect`; a
    profiler session that drops launches is repeated, up to 3 in all."""
    seen = []
    for _ in range(3):
        prof = profile_window(fn, host)
        if prof[0] == expect:
            return prof
        seen.append(prof[0])
    fail(f"profiler saw launches {seen} in {what}, expected {expect}")


def phase_slim_experiment(kernels):
    """The SLIM experiment path (train/slim_experiment.py) at full width:
    slim_liso + slim_highest_resolution, fp32, batch SLIM.batch_size,
    DataCfg(n_max=65536, m_max=131072) as slim_cli builds it without
    --fast-test, on a SyntheticDataset of 65536 background points."""
    import tempfile

    import numpy as np
    import torch

    from liso_tpu_torch.cli.common import DEFAULT_CFG
    from liso_tpu_torch.data.dataset import DataCfg, collate
    from liso_tpu_torch.data.synthetic import SyntheticDataset
    from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.train.slim_experiment import (
        EXPORT_PAIRS,
        SlimExperiment,
        batch_to_flow_sample,
        export_sample,
    )
    from liso_tpu_torch.utils.checkpoint import (
        STATE_FILE,
        latest_step,
        save_checkpoint,
    )
    from liso_tpu_torch.utils.config import parse_config, save_config

    t_phase = time.perf_counter()
    cfg = parse_config(DEFAULT_CFG, ["slim_liso", "slim_highest_resolution"])
    bev = BevSetup(tuple(cfg.data.bev_range_m), tuple(cfg.data.img_grid_size))
    got_cfg = (bev.grid_size, bev.bev_range_m, int(cfg.SLIM.batch_size),
               int(cfg.SLIM.model.num_iters))
    if got_cfg != ((T_GRID, T_GRID), (T_RANGE, T_RANGE), 1, T_ITERS):
        fail(f"slim_liso + slim_highest_resolution gave {got_cfg}")
    dcfg = DataCfg(bev=bev, n_max=E_PTS, m_max=2 * E_PTS,
                   use_skip_frames=str(cfg.data.use_skip_frames),
                   flow_source=str(cfg.data.flow_source),
                   odom_source=str(cfg.data.odom_source))
    train_ds = SyntheticDataset(dcfg, n_frames=E_FRAMES, seed=0, n_points=E_PTS)
    val_ds = SyntheticDataset(dcfg, n_frames=2, seed=1, n_points=E_PTS)
    sample0 = train_ds[0]
    kept = int(sample0.frame_t0.valid.sum())
    tmp = tempfile.TemporaryDirectory(prefix="slim_experiment_", dir=OUT_DIR)
    try:
        log_dir = Path(tmp.name) / "run"
        save_config(cfg, log_dir / "config.yml")
        exp = SlimExperiment(cfg, bev, train_ds, val_ds, log_dir, device="cuda")
        if exp.trainer.model.compute_dtype is not None:
            fail("the experiment's trainer does not train in fp32")

        # K1 and the fused VJP at this path's shapes: fp32 C = 64 over the
        # 846400 cells, on the cells of a real frame (their own generators)
        fs0 = batch_to_flow_sample(collate([sample0]), "cuda")
        cells = prepare_pillar_inputs(fs0.pcl_t0.pcl, fs0.pcl_t0.valid,
                                      bev).cell
        kres = [check(torch.Generator(device="cuda").manual_seed(seed), cells,
                      bev.num_cells, 64, torch.float32)
                for check, seed in ((check_scatter_max, 9),
                                    (check_scatter_max_vjp, 10))]

        # 1. run: E_STEPS steps through the Prefetcher and its workers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        trainer = exp.run(max_steps=E_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_launches = dict(kernels.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        per_step = {"grid_scatter_max_occ": 2, "corr_window_fwd": 2 * T_ITERS,
                    "scatter_max_vjp": 2, "grid_reduce_add_c1": 1,
                    "corr_window_bwd": 2 * T_ITERS, "knn_banded": 2}
        expect = {k: per_step.get(k, 0) * E_STEPS for k in run_launches}
        if run_launches != expect:
            fail(f"experiment run launches {run_launches}, expected {expect}")
        if trainer.step != E_STEPS or latest_step(log_dir / "ckpts") != E_STEPS:
            fail(f"after run: step {trainer.step}, latest checkpoint "
                 f"{latest_step(log_dir / 'ckpts')}, expected {E_STEPS}")
        if not all(bool(torch.isfinite(p).all()) for p in trainer.params.values()):
            fail("experiment parameters not finite after the run")
        wait_ms = span_tail_ms(("slim.wait",), E_STEPS)
        step_ms = [s - w for s, w in
                   zip(span_tail_ms(("slim.step",), E_STEPS), wait_ms)]

        # 2. checkpoint: save and restore times and bytes; a fresh
        # experiment from another seed restores the run's state bitwise
        t0 = time.perf_counter()
        target = save_checkpoint(Path(tmp.name) / "timed_ckpts", E_STEPS, trainer)
        save_ms = (time.perf_counter() - t0) * 1e3
        ckpt_bytes = (target / STATE_FILE).stat().st_size
        cfg2 = parse_config(DEFAULT_CFG, ["slim_liso", "slim_highest_resolution"],
                            [["SLIM", "seed", "1"]])
        exp2 = SlimExperiment(cfg2, bev, train_ds, val_ds, log_dir, device="cuda")
        if not state_equal(exp2.trainer.state_dict()["model"],
                           trainer.state_dict()["model"]):
            fail("a fresh experiment from seed 1 starts with the run's weights")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp2.maybe_restore()
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        diff = state_equal(exp2.trainer.state_dict(), trainer.state_dict())
        if diff:
            fail(f"restored state differs from the saved one at {diff[:8]}")
        del exp2

        # 3. evaluate
        kernels.reset_launches()
        t0 = time.perf_counter()
        flow_metrics = exp.evaluate(E_STEPS, max_batches=2)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_launches = dict(kernels.launches)
        if not np.isfinite(flow_metrics.get("AEE_overall", np.nan)):
            fail(f"evaluate: AEE_overall not finite: {flow_metrics}")

        # 4. export_flow on 2 samples: the 6-pair schema
        preds = Path(tmp.name) / "preds"
        kernels.reset_launches()
        t0 = time.perf_counter()
        n = exp.export_flow(train_ds, preds, max_samples=E_EXPORTS)
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        export_launches = dict(kernels.launches)
        per_predict = {"grid_scatter_max_occ": 2, "corr_window_fwd": 2 * T_ITERS,
                       "bn_relu_eval": 2}
        n_predicts = E_EXPORTS * len(EXPORT_PAIRS)
        expect = {k: per_predict.get(k, 0) * n_predicts for k in export_launches}
        if n != E_EXPORTS or export_launches != expect:
            fail(f"export_flow wrote {n} samples with launches "
                 f"{export_launches}, expected {E_EXPORTS} and {expect}")
        files = sorted(preds.glob("*.npz"))
        h, w = bev.grid_size
        for f in files:
            d = np.load(f)
            want = {"bev_range_m": (2,), "static_threshold": ()}
            for a, b in EXPORT_PAIRS:
                for name in (f"{a}_{b}", f"{b}_{a}"):
                    want[f"bev_raw_flow_{name}"] = (h, w, 2)
                    want[f"bev_dynamicness_{name}"] = (h, w)
            shapes = {k: d[k].shape for k in d.files}
            if shapes != want or not all(np.isfinite(d[k]).all() for k in d.files):
                fail(f"{f.name}: keys and shapes {shapes} (want {want}) or "
                     "not finite")

        # 5. one sample's export with kernels against the plain versions
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = export_sample(trainer, train_ds, 0)
        sample_ms = (time.perf_counter() - t0) * 1e3
        with kernels.plain_versions():
            ref = export_sample(trainer, train_ds, 0)
        flow_diff = max(float(np.abs(got[k] - ref[k]).max())
                        for k in got if k.startswith("bev_raw_flow"))
        dyn_diff = max(float(np.abs(got[k] - ref[k]).max())
                       for k in got if k.startswith("bev_dynamicness"))
        if (flow_diff > FLOW_ATOL or dyn_diff > PROBS_ATOL
                or not np.array_equal(got["static_threshold"],
                                      ref["static_threshold"])):
            fail(f"export kernels vs plain: flow {flow_diff} m (limit "
                 f"{FLOW_ATOL}), dynamicness {dyn_diff} (limit {PROBS_ATOL}), "
                 f"threshold {got['static_threshold']} vs "
                 f"{ref['static_threshold']}")

        # 7. the profiler confirms one predict_step's and one train step's
        # launches (after every check: the step moves the state)
        zero = {k: 0 for k in kernels.launches}
        pcounts, pdev_ms, _, _ = confirm_launches(
            lambda: trainer.predict_step(fs0), {**zero, **per_predict},
            "an experiment predict_step")
        counts, dev_ms, rows, _ = confirm_launches(
            lambda: trainer.train_step(fs0), {**zero, **per_step},
            "an experiment train step")
    finally:
        tmp.cleanup()
    res = {
        "phase": "slim_experiment",
        "configs": "slim_liso + slim_highest_resolution",
        "grid": T_GRID, "range_m": T_RANGE, "points": E_PTS,
        "batch": int(cfg.SLIM.batch_size), "iters": T_ITERS, "dtype": "fp32",
        "optimizer": str(cfg.SLIM.optimizer),
        "detect_anomaly": bool(cfg.SLIM.set_detect_anomaly),
        "frames": E_FRAMES, "points_per_frame": len(train_ds.load_sample_dict(0)["pcl_t0"]),
        "points_kept_t0": kept,
        "workers": int(cfg.data.num_workers),
        "steps": E_STEPS, "run_s": run_s,
        "step_ms": step_ms,
        "step_ms_mean": statistics.mean(step_ms),
        "step_ms_median": statistics.median(step_ms),
        "step_ms_max": max(step_ms),
        "data_wait_ms": wait_ms,
        "data_wait_ms_mean": statistics.mean(wait_ms),
        "data_wait_ms_max": max(wait_ms),
        "peak_memory_gb": peak_gb,
        "launches": run_launches,
        "checkpoint_save_ms": save_ms, "checkpoint_restore_ms": restore_ms,
        "checkpoint_bytes": ckpt_bytes,
        "eval_s": eval_s, "eval_launches": eval_launches,
        "flow_metrics": flow_metrics,
        "export_samples": n, "export_ms_per_sample": export_s * 1e3 / n,
        "export_sample_ms_unwritten": sample_ms,
        "export_launches": export_launches,
        "export_max_abs_diff_vs_plain": {"flow_m": flow_diff,
                                         "dynamicness": dyn_diff},
        "tolerance": {"flow_m": FLOW_ATOL, "dynamicness": PROBS_ATOL},
        "profiled_step": {"launches": counts, "device_ms": dev_ms,
                          "device_busy_share": dev_ms / statistics.median(step_ms),
                          "device_ms_by_family": families(rows)},
        "profiled_predict": {"launches": pcounts, "device_ms": pdev_ms},
        "phase_s": time.perf_counter() - t_phase,
    }
    return kres, res


class MiningTimers:
    """Host-clock timings of the mining pass's stages, taken by wrapping
    the functions mine_sequence calls (each wrapper awaits the card before
    it reads the clock). Installed with `with`, restored on exit."""

    def __init__(self, loop):
        self.loop = loop
        self.clear()

    def clear(self):
        self.detect, self.program, self.copy = [], [], []
        self.tracker, self.refine, self.smooth = [], [], []

    def _timed(self, out, fn):
        import torch

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            return r
        return wrapped

    def __enter__(self):
        from liso_tpu_torch.tracker import mining

        loop = self.loop
        self._saved = [
            (mining, "_mine_frame_device"), (mining, "_frame_to_host"),
            (mining, "refine_track_boxes"), (mining, "smooth_track_jerk"),
            (mining.FlowBasedBoxTracker, "update"),
            (mining.FlowBasedBoxTracker, "run_tracker"),
        ]
        self._saved = [(o, n, getattr(o, n)) for o, n in self._saved]
        mining._mine_frame_device = self._timed(self.program, mining._mine_frame_device)
        mining._frame_to_host = self._timed(self.copy, mining._frame_to_host)
        mining.refine_track_boxes = self._timed(self.refine, mining.refine_track_boxes)
        mining.smooth_track_jerk = self._timed(self.smooth, mining.smooth_track_jerk)
        for name in ("update", "run_tracker"):
            setattr(mining.FlowBasedBoxTracker, name,
                    self._timed(self.tracker, getattr(mining.FlowBasedBoxTracker, name)))
        fc = loop._bootstrap_detect_fn()
        loop._fc_detect_cached = self._timed(self.detect, fc)
        batch = loop._detector_detect_batch_fn
        loop._detector_detect_batch_fn = lambda *a, **k: self._timed(
            self.detect, batch(*a, **k))
        self._loop_saved = (fc, batch)
        return self

    def __exit__(self, *exc):
        for o, n, f in self._saved:
            setattr(o, n, f)
        self.loop._fc_detect_cached, batch = self._loop_saved
        del self.loop._detector_detect_batch_fn
        return False

    def summary(self, n_frames, per_call_frames=1):
        mean = lambda x: statistics.mean(x) if x else None
        return {
            "detect_ms_per_frame": sum(self.detect) / n_frames,
            "detect_calls": len(self.detect),
            "detect_ms_per_call_median": statistics.median(self.detect)
            if self.detect else None,
            "frame_program_ms_per_frame": (sum(self.program) + sum(self.copy))
            / n_frames,
            "frame_program_device_ms_median": statistics.median(self.program),
            "frame_copy_ms_median": statistics.median(self.copy),
            "tracker_host_ms": sum(self.tracker),
            "refine_ms_per_track": mean(self.refine),
            "smooth_ms_per_track": mean(self.smooth),
            "tracks_refined": len(self.refine),
            "tracks_smoothed": len(self.smooth),
        }


def tree_equal(a, b) -> list:
    """Paths where two DB trees (dicts, lists, numpy arrays) differ: arrays
    by dtype, shape and bits."""
    import numpy as np

    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"keys {sorted(set(map(str, a)) ^ set(map(str, b)))}"]
        return [f"{k}/{d}" for k in a for d in tree_equal(a[k], b[k])]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"len {len(a)} != {len(b)}"]
        return [f"{i}/{d}" for i, (x, y) in enumerate(zip(a, b))
                for d in tree_equal(x, y)]
    a, b = np.asarray(a), np.asarray(b)
    same = (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())
    return [] if same else [""]


def db_stats(mined):
    """(tracks, boxes) of a mined DB."""
    ids = {int(t) for v in mined.values() for t in v["track_id"]}
    return len(ids), sum(len(v["track_id"]) for v in mined.values())


def db_diff(got, want):
    """Track ids per sample equal? And the largest box differences."""
    import numpy as np

    if set(got) != set(want):
        return False, {}
    same_ids = all(np.array_equal(got[k]["track_id"], want[k]["track_id"])
                   for k in want)
    diff = {"pos": 0.0, "rot": 0.0, "dims": 0.0}
    if same_ids:
        for k in want:
            g, w = got[k]["raw_box"], want[k]["raw_box"]
            if not len(w.get("pos", ())):
                continue
            diff["pos"] = max(diff["pos"], float(np.abs(g["pos"] - w["pos"]).max()))
            d = np.abs(np.angle(np.exp(1j * (g["rot"] - w["rot"]))))
            diff["rot"] = max(diff["rot"], float(d.max()))
            diff["dims"] = max(diff["dims"], float(np.abs(g["dims"] - w["dims"]).max()))
    return same_ids, diff


def smoothing_on_one_track():
    """smooth_track_jerk on one 64-frame track, 2000 iterations, eager
    against its CUDA graph (bitwise), and the bike model on one 16-frame
    track, 2000 iterations (its CUDA graph)."""
    import numpy as np
    import torch

    from liso_tpu_torch.tracker import smoothing

    rng = np.random.RandomState(0)
    t = np.arange(M_FRAMES)
    pos = np.stack([1.5 * t + 0.2 * np.sin(t), 0.4 * t, np.full(M_FRAMES, -0.8)],
                   -1) + 0.15 * rng.randn(M_FRAMES, 3)
    pos = torch.tensor(pos[None], dtype=torch.float32, device="cuda")
    yaw = torch.full((1, M_FRAMES, 1), 0.26, device="cuda")
    valid = torch.ones(1, M_FRAMES, dtype=torch.bool, device="cuda")
    out, ms = {}, {}
    for graph in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = smoothing.smooth_track_jerk(pos, valid, yaw, max_iters=M_SMOOTH_ITERS,
                                        graph=graph)
        torch.cuda.synchronize()
        ms.setdefault(graph, []).append((time.perf_counter() - t0) * 1e3)
        if graph in out and not all(torch.equal(a, b) for a, b in zip(r, out[graph])):
            fail(f"smooth_track_jerk (graph={graph}) differs between two calls")
        out[graph] = r
    if not all(torch.equal(a, b) for a, b in zip(out[False], out[True])):
        fail("smooth_track_jerk: the CUDA graph's result differs from the "
             "eager loop's")
    bpos, byaw, bvalid = pos[:, :16], yaw[:, :16], valid[:, :16]
    vlen = torch.tensor([4.0], device="cuda")
    bike_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = smoothing.smooth_track_bike_model(bpos, bvalid, byaw, vlen,
                                              max_iters=M_SMOOTH_ITERS)
        torch.cuda.synchronize()
        bike_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(bool(torch.isfinite(x).all()) for x in b):
        fail("smooth_track_bike_model: not finite")
    return {"jerk_track_frames": M_FRAMES, "iters": M_SMOOTH_ITERS,
            "jerk_eager_ms": ms[False], "jerk_graph_ms": ms[True],
            "graph_equals_eager": True,
            "bike_track_frames": 16, "bike_graph_ms": bike_ms}


def phase_mining(kernels):
    """LisoSelfTraining.mine at full width, rounds 0 and 1."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from liso_tpu_torch.cli.common import DEFAULT_CFG
    from liso_tpu_torch.cli.slim_cli import build_datasets
    from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
    from liso_tpu_torch.tracker.dbs import finalize_augm_db, load_mined_boxes_db
    from liso_tpu_torch.train import liso_loop
    from liso_tpu_torch.utils.config import parse_config

    t_phase = time.perf_counter()
    cfg = parse_config(DEFAULT_CFG, ["bev_100m_512", "centerpoint", "liso"])
    train_ds, _, bev = build_datasets(cfg, False, target="object")
    tc = cfg.data.tracking_cfg
    got_cfg = (bev.grid_size, bev.bev_range_m, train_ds.cfg.n_max, len(train_ds),
               int(tc.max_num_boxes_after_nms), int(tc.min_track_age))
    if got_cfg != ((D_GRID, D_GRID), (D_RANGE, D_RANGE), M_PTS, M_FRAMES, 100, 4):
        fail(f"bev_100m_512 centerpoint liso gave {got_cfg}")
    zero = {k: 0 for k in kernels.launches}
    tmp = tempfile.TemporaryDirectory(prefix="mining_", dir=OUT_DIR)
    try:
        run_dir = Path(tmp.name) / "run"
        loop = liso_loop.LisoSelfTraining(cfg, lambda db: train_ds, None, run_dir,
                                          data_cfg=train_ds.cfg, device="cuda")
        for mc in (loop.mining_cfg_bootstrap, loop.mining_cfg_detector):
            if mc.smoothing_iters != M_SMOOTH_ITERS:
                fail(f"mining smoothing_iters {mc.smoothing_iters}")
        frames = liso_loop.frames_from_dataset(train_ds, list(range(M_FRAMES)))
        res = {"phase": "mining",
               "configs": "bev_100m_512 centerpoint liso (mining_cli)",
               "grid": D_GRID, "range_m": D_RANGE, "n_max": M_PTS,
               "frames": M_FRAMES, "k_after_nms": 100, "min_track_age": 4,
               "smoothing_iters": M_SMOOTH_ITERS, "detector_chunk": M_CHUNK,
               "points_per_frame": [int(frames[0].valid.sum()),
                                    int(frames[-1].valid.sum())],
               "round1_detector": f"random weights (seed 0), dims head bias "
                                  f"+{M_DIMS_BIAS}"}

        # round 0: the flow-cluster bootstrap (no kernel on its path)
        with MiningTimers(loop) as tm:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            loop.mine(train_ds)
            torch.cuda.synchronize()
            r0_s = time.perf_counter() - t0
            r0_launches = dict(kernels.launches)
        if r0_launches != zero:
            fail(f"round 0 launched kernels: {r0_launches}")
        out0 = run_dir / "mined_round_0"
        mined0 = load_mined_boxes_db(out0 / "tracked.npz")
        augm0 = np.load(out0 / "augm_db.npy", allow_pickle=True).item()
        diff = (tree_equal(mined0, loop.mined_db)
                + tree_equal(augm0, finalize_augm_db(loop.augm_db)))
        if diff:
            fail(f"round 0 DBs loaded back differ at {diff[:8]}")
        n_tracks0, n_boxes0 = db_stats(loop.mined_db)
        if n_tracks0 < 1:
            fail("round 0 mined no track")
        r0 = {"seconds": r0_s, "launches": r0_launches, "tracks": n_tracks0,
              "boxes": n_boxes0, "snippets": len(loop.augm_db["boxes"]),
              "db_bytes": {"tracked.npz": (out0 / "tracked.npz").stat().st_size,
                           "augm_db.npy": (out0 / "augm_db.npy").stat().st_size},
              **tm.summary(M_FRAMES)}
        detect_host_ms = sum(tm.detect)
        fc = loop._bootstrap_detect_fn()
        _, dev_ms, rows, _ = profile_window(lambda: [fc(f) for f in frames])
        r0["detect_stage"] = {"host_ms": detect_host_ms, "device_ms": dev_ms,
                              "device_busy_share": dev_ms / detect_host_ms,
                              "device_ms_by_family": families(rows)}
        res["round0"] = r0

        # round 0 on the first frames: the card against the port on the CPU
        parts = {"round0": time.perf_counter() - t_phase}
        ds16 = copy.copy(train_ds)
        ds16.get_consecutive_sample_idxs_for_sequence = (
            lambda seq_of_idx=0: list(range(M_CPU_FRAMES)))
        dbs16 = {}
        for dev in ("cuda", "cpu"):
            lp = liso_loop.LisoSelfTraining(cfg, lambda db: ds16, None,
                                            Path(tmp.name) / dev,
                                            data_cfg=train_ds.cfg, device=dev)
            t0 = time.perf_counter()
            lp.mine(ds16)
            dbs16[dev] = (lp.mined_db, time.perf_counter() - t0)
        same_ids, d16 = db_diff(dbs16["cuda"][0], dbs16["cpu"][0])
        n16 = db_stats(dbs16["cpu"][0])
        res["round0_card_vs_cpu"] = {
            "frames": M_CPU_FRAMES, "same_track_ids": same_ids,
            "tracks_boxes": n16, "max_abs_diff": d16,
            "tolerance": {"pos_m": M_POS_ATOL, "rot_rad": M_ROT_ATOL,
                          "dims_m": M_DIMS_ATOL},
            "cuda_s": dbs16["cuda"][1], "cpu_s": dbs16["cpu"][1]}
        if (not same_ids or n16[0] < 1 or d16["pos"] > M_POS_ATOL
                or d16["rot"] > M_ROT_ATOL or d16["dims"] > M_DIMS_ATOL):
            fail(f"round 0 on the card vs the CPU: same ids {same_ids}, "
                 f"tracks/boxes {n16}, max diff {d16}")

        # round 1: the detector in chunks of 8 frames
        parts["round0_card_vs_cpu"] = time.perf_counter() - t_phase - sum(parts.values())
        det = loop.trainer
        with torch.no_grad():
            det.params["model.sep_head.dims_final.bias"] += M_DIMS_BIAS
        loop.state, loop.round_idx = det, 1
        padded = [liso_loop._pad_frame_points(f, M_PTS) for f in frames[:M_CHUNK]]
        pts = torch.as_tensor(np.stack([p for p, _ in padded]), device="cuda")
        valid = torch.as_tensor(np.stack([v for _, v in padded]), device="cuda")
        cells = prepare_pillar_inputs(pts, valid, bev).cell
        kres = [check_scatter_max(torch.Generator(device="cuda").manual_seed(11),
                                  cells, bev.num_cells, 64, torch.float32)]
        # kernels against plain under cuDNN's deterministic algorithms, so
        # that the two differ only where K1 could
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            with MiningTimers(loop) as tm:
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                loop.mine(train_ds)
                torch.cuda.synchronize()
                r1_s = time.perf_counter() - t0
                r1_launches = dict(kernels.launches)
            n_chunks = -(-M_FRAMES // M_CHUNK)
            if r1_launches != {**zero, "grid_scatter_max_occ": n_chunks,
                               "bn_relu_eval": eval_norms(det.model) * n_chunks}:
                fail(f"round 1 launches {r1_launches}, expected one K1 per "
                     f"chunk of {M_CHUNK} frames ({n_chunks})")
            mined1 = loop.mined_db
            out1 = run_dir / "mined_round_1"
            diff = (tree_equal(load_mined_boxes_db(out1 / "tracked.npz"), mined1)
                    + tree_equal(np.load(out1 / "augm_db.npy", allow_pickle=True).item(),
                                 finalize_augm_db(loop.augm_db)))
            if diff:
                fail(f"round 1 DBs loaded back differ at {diff[:8]}")
            n_tracks1, n_boxes1 = db_stats(mined1)
            r1 = {"seconds": r1_s, "launches": r1_launches, "tracks": n_tracks1,
                  "boxes": n_boxes1, "snippets": len(loop.augm_db["boxes"]),
                  "db_bytes": {"tracked.npz": (out1 / "tracked.npz").stat().st_size,
                               "augm_db.npy": (out1 / "augm_db.npy").stat().st_size},
                  **tm.summary(M_FRAMES)}
            detect_host_ms = sum(tm.detect)
            detect_many = loop._detector_detect_batch_fn()
            counts, dev_ms, rows, _ = profile_window(lambda: detect_many(frames))
            r1["detect_stage"] = {
                "host_ms": detect_host_ms, "device_ms": dev_ms,
                "device_busy_share": dev_ms / detect_host_ms,
                "launches_profiled": counts,
                "device_ms_by_family": families(rows)}
            confirm_launches(lambda: det.predict_step(pts, valid),
                             {**zero, "grid_scatter_max_occ": 1,
                              "bn_relu_eval": eval_norms(det.model)},
                             "a mining predict_step at batch 8")
            # the same round through the plain versions
            boxes_k = detect_many(frames)
            kernels.reset_launches()
            with kernels.plain_versions():
                boxes_p = loop._detector_detect_batch_fn()(frames)
                loop.mine(train_ds)
            torch.cuda.synchronize()
            if any(kernels.launches.values()):
                fail(f"the plain round 1 launched kernels: {dict(kernels.launches)}")
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        box_diff = max(float((getattr(a, f) - getattr(b, f)).abs().max())
                       for a, b in zip(boxes_k, boxes_p)
                       for f in ("pos", "dims", "rot", "probs"))
        same_valid = all(torch.equal(a.valid, b.valid)
                         for a, b in zip(boxes_k, boxes_p))
        same_ids, d1 = db_diff(mined1, loop.mined_db)
        r1["kernel_vs_plain"] = {"detections_same_valid": same_valid,
                                 "detections_max_abs_diff": box_diff,
                                 "same_track_ids": same_ids,
                                 "mined_max_abs_diff": d1,
                                 "tolerance": DET_BOX_ATOL,
                                 "kept_per_frame": [int(b.valid.sum())
                                                    for b in boxes_k[:M_CHUNK]]}
        if (not same_valid or box_diff > DET_BOX_ATOL or not same_ids
                or max(d1.values()) > DET_BOX_ATOL):
            fail(f"round 1, kernels vs plain: {r1['kernel_vs_plain']}")
        res["round1"] = r1
        parts["round1"] = time.perf_counter() - t_phase - sum(parts.values())
        res["smoothing_one_track"] = smoothing_on_one_track()
        parts["smoothing"] = time.perf_counter() - t_phase - sum(parts.values())
    finally:
        tmp.cleanup()
    res["phase_s"] = time.perf_counter() - t_phase
    res["parts_s"] = parts
    # the eval phase's inputs: round 0's mined DB and round 1's detector
    return kres, res, {"mined_db_round0": mined0, "detector": det}


class EvalRecorder:
    """Wraps run_val where the eval phase's entry points call it
    (liso_loop.run_val, eval_cli.run_val) and what it calls per batch: each
    call's batches and predictions (host numpy) and every IoU matrix, and
    the host ms of the predictor, of iou_matrix_host (its result is copied
    to the host, so the card's work is awaited), of MetricBanks.update and
    of FlowMetrics.update. Installed with `with`, restored on exit; call
    `run_val` itself for a direct run."""

    def __init__(self):
        self.calls = []

    def run_val(self, batches, predict, **kw):
        import numpy as np

        call = {"kw": kw, "batches": [], "preds": [], "predict_ms": [],
                "banks_ms": [], "flow_ms": [], "iou_ms": [], "iou": []}
        self.calls.append(call)

        def recorded(batch):
            t0 = time.perf_counter()
            out = predict(batch)
            call["predict_ms"].append((time.perf_counter() - t0) * 1e3)
            call["batches"].append(batch)
            call["preds"].append({k: np.asarray(v) for k, v in out.items()})
            return out

        t0 = time.perf_counter()
        out = self._inner(batches, recorded, **kw)
        call["seconds"] = time.perf_counter() - t0
        call["metrics"] = dict(out)  # validate adds to the dict it gets
        return out

    def _timed(self, key, fn, record=None):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            call = self.calls[-1]
            call[key].append((time.perf_counter() - t0) * 1e3)
            if record:
                record(call, a, r)
            return r
        return wrapped

    def __enter__(self):
        from liso_tpu_torch.cli import eval_cli
        from liso_tpu_torch.eval import flow_metrics
        from liso_tpu_torch.eval import run_val as rv
        from liso_tpu_torch.train import liso_loop

        def keep_iou(call, a, mat):
            gt, pred, mode = a[:3]
            call["iou"].append({"batch": len(call["preds"]) - 1, "mode": mode,
                                "gt": gt, "pred": pred, "mat": mat})

        self._inner = rv.run_val
        self._saved = [(o, n, getattr(o, n)) for o, n in (
            (liso_loop, "run_val"), (eval_cli, "run_val"),
            (rv, "iou_matrix_host"), (rv.MetricBanks, "update"),
            (flow_metrics.FlowMetrics, "update"))]
        liso_loop.run_val = eval_cli.run_val = self.run_val
        rv.iou_matrix_host = self._timed("iou_ms", rv.iou_matrix_host, keep_iou)
        rv.MetricBanks.update = self._timed("banks_ms", rv.MetricBanks.update)
        flow_metrics.FlowMetrics.update = self._timed(
            "flow_ms", flow_metrics.FlowMetrics.update)
        return self

    def __exit__(self, *exc):
        for o, n, f in self._saved:
            setattr(o, n, f)
        return False


def eval_call_summary(call):
    """Seconds of one run_val call and its host ms per batch by stage."""
    n = len(call["predict_ms"])
    return {"seconds": call["seconds"], "batches": n,
            "predict_ms_per_batch": sum(call["predict_ms"]) / n,
            "predict_ms_median": statistics.median(call["predict_ms"]),
            "iou_ms_per_batch": sum(call["iou_ms"]) / n,
            "iou_calls": len(call["iou_ms"]),
            "banks_host_ms_per_batch": (sum(call["banks_ms"])
                                        - sum(call["iou_ms"])) / n,
            "flow_metrics_ms_per_batch": sum(call["flow_ms"]) / n,
            "metric_keys": len(call["metrics"])}


def metrics_diff(got, want):
    """(same keys, largest |difference| over the shared keys, bitwise)."""
    import math

    diff = 0.0
    for k in set(got) & set(want):
        a, b = float(got[k]), float(want[k])
        if not (math.isnan(a) and math.isnan(b)):
            diff = max(diff, abs(a - b) if a == a and b == b else math.inf)
    bitwise = set(got) == set(want) and all(
        repr(float(got[k])) == repr(float(want[k])) for k in want)
    return set(got) == set(want), diff, bitwise


def near_threshold_pairs(call):
    """Every IoU of a call within EV_NEAR of a matching threshold."""
    import numpy as np

    out = []
    for rec in call["iou"]:
        for th in EV_THRESHOLDS:
            for g, p in zip(*np.nonzero(np.abs(rec["mat"] - th) <= EV_NEAR)):
                out.append({"batch": rec["batch"], "mode": rec["mode"],
                            "gt": int(g), "pred": int(p),
                            "iou": float(rec["mat"][g, p]), "threshold": th})
    return out


def phase_eval(kernels, handoff):
    """Evaluation at `eval_cli -c bev_100m_512 centerpoint liso`: run_val
    over the mining phase's round-0 DB (64 train frames), validate with its
    round-1 detector (16 val frames + the val-on-train pass), eval_cli on a
    checkpoint of that detector in a subprocess, and eval_cli's
    flow-cluster and echo_gt predictors in this process."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from liso_tpu_torch.cli import eval_cli
    from liso_tpu_torch.cli.common import DEFAULT_CFG
    from liso_tpu_torch.cli.slim_cli import build_datasets
    from liso_tpu_torch.data.pipeline import Prefetcher
    from liso_tpu_torch.eval import iou_oracle
    from liso_tpu_torch.eval import run_val as rv
    from liso_tpu_torch.eval.od_metrics import iou_matrix_host
    from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
    from liso_tpu_torch.train import liso_loop
    from liso_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from liso_tpu_torch.utils.config import parse_config

    t_phase = time.perf_counter()
    configs = ["bev_100m_512", "centerpoint", "liso"]
    cfg = parse_config(DEFAULT_CFG, configs)
    train_ds, val_ds, bev = build_datasets(cfg, False)
    got_cfg = (bev.grid_size, len(train_ds), len(val_ds), val_ds.cfg.n_max,
               int(cfg.validation.num_val_steps),
               int(cfg.validation.num_val_on_train_steps))
    if got_cfg != ((D_GRID, D_GRID), M_FRAMES, M_FRAMES // 4, M_PTS, 500, 125):
        fail(f"bev_100m_512 centerpoint liso gave {got_cfg}")
    det, mined0 = handoff["detector"], handoff["mined_db_round0"]
    zero = {k: 0 for k in kernels.launches}
    banks = rv.MetricBanks(device="cpu")
    res = {"phase": "eval", "configs": " ".join(configs) + " (eval_cli)",
           "train_frames": len(train_ds), "val_frames": len(val_ds),
           "n_max": M_PTS, "detector": f"mining round 1's: random weights "
                                       f"(seed 0), dims head bias +{M_DIMS_BIAS}",
           "banks": len(banks.range_banks) + len(banks.waymo_banks) + 3}

    # K1 at evaluation's shape: predict_step at batch 1
    s = val_ds[0]
    pts = torch.as_tensor(s.frame_t0.pcl[None], device="cuda")
    valid = torch.as_tensor(s.frame_t0.valid[None], device="cuda")
    cells = prepare_pillar_inputs(pts, valid, bev).cell
    kres = [check_scatter_max(torch.Generator(device="cuda").manual_seed(13),
                              cells, bev.num_cells, 64, torch.float32)]
    confirm_launches(lambda: det.predict_step(pts, valid),
                     {**zero, "grid_scatter_max_occ": 1,
                      "bn_relu_eval": eval_norms(det.model)},
                     "an eval predict_step at batch 1")

    tmp = tempfile.TemporaryDirectory(prefix="eval_", dir=OUT_DIR)
    launches = dict(zero)

    def count(fn, expect_k1):
        """fn() with the counts reset just before and read just after: K1
        `expect_k1` times and the eval BN + ReLU per norm of each of the
        detector's forwards, one per K1 (none inside
        `kernels.plain_versions()`)."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(kernels.launches)
        n_bn = eval_norms(det.model) * expect_k1
        if got != {**zero, "grid_scatter_max_occ": expect_k1,
                   "bn_relu_eval": n_bn}:
            fail(f"eval launches {got}, expected {expect_k1} of K1 and "
                 f"{n_bn} of the eval BN + ReLU")
        for k, v in got.items():
            launches[k] += v
        return out

    try:
        rec = EvalRecorder()
        with rec:
            # run 1: the round-0 DB as the predictor on the train frames, as
            # mining_cli evaluates it
            loader = Prefetcher(train_ds, batch_size=1, shuffle=False, num_workers=1)
            m1 = count(lambda: rec.run_val(iter(loader), rv.mined_db_predictor(mined0)),
                       0)
            # run 2: LisoSelfTraining.validate with round 1's detector
            loop = liso_loop.LisoSelfTraining(
                cfg, lambda db: train_ds, val_ds, Path(tmp.name) / "loop",
                data_cfg=train_ds.cfg, device="cuda")
            loop.state = det
            m2 = count(lambda: loop.validate(1), len(val_ds) + len(train_ds))
            run1, run2_val, run2_vot = rec.calls
            # run 4: eval_cli's flow-cluster and echo_gt predictors
            m4 = {}
            for name in ("flow_cluster_detector", "echo_gt"):
                with contextlib.redirect_stdout(io.StringIO()):
                    m4[name] = count(lambda: eval_cli.main(
                        ["-c", *configs, "--override_network", name,
                         "--summary_dir", str(Path(tmp.name) / name)]), 0)
            run4 = rec.calls[3:5]
            # run 2 again through the plain versions, under cuDNN's
            # deterministic algorithms
            saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
            try:
                with kernels.plain_versions():
                    m2_plain = count(lambda: loop.validate(1), 0)
            finally:
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
            plain_calls = rec.calls[5:7]
        res["launches"] = launches
        res["runs"] = {"mined_db_train": eval_call_summary(run1),
                       "validate_val": eval_call_summary(run2_val),
                       "validate_val_on_train": eval_call_summary(run2_vot),
                       "eval_cli_flow_cluster_detector": eval_call_summary(run4[0]),
                       "eval_cli_echo_gt": eval_call_summary(run4[1])}
        res["metric_keys"] = {"mined_db": len(m1), "validate": len(m2),
                              "eval_cli": len(m4["echo_gt"])}
        res["headline"] = {k: {m: v for m, v in d.items() if m.startswith("mAP")}
                           for k, d in (("mined_db", m1), ("validate", m2),
                                        ("flow_cluster_detector",
                                         m4["flow_cluster_detector"]))}
        for name, m in (("mined_db", m1), ("validate", m2), *m4.items()):
            bad = [k for k, v in m.items() if not np.isfinite(v)]
            if len(m) < 200 or bad:
                fail(f"{name}: {len(m)} metric keys, not finite: {bad[:8]}")
        echo = {k: v for k, v in m4["echo_gt"].items()
                if k.startswith("final_result/visible/detection_metrics/")
                and "/iou_bev/AP_overall_overall_" in k}
        if not echo or min(echo.values()) < 0.99:
            fail(f"echo_gt: visible iou_bev APs {echo}, expected 1")
        res["echo_gt_visible_iou_bev_ap_min"] = min(echo.values())

        # the predict stage of run 2 (val pass): device busy share
        batches = run2_val["batches"]
        _, dev_ms, rows, _ = profile_window(lambda: [det.predict_step(
            torch.as_tensor(b["pcl_t0"], device="cuda"),
            torch.as_tensor(b["valid_t0"], device="cuda")) for b in batches])
        res["validate_predict_stage"] = {
            "host_ms": sum(run2_val["predict_ms"]), "device_ms": dev_ms,
            "device_busy_share": dev_ms / sum(run2_val["predict_ms"]),
            "device_ms_by_family": families(rows)}

        # IoU on the card: run 2's first samples, both modes
        worst_oracle = worst_cpu = 0.0
        overlapping = 0
        for r in run2_val["iou"]:
            if r["batch"] >= EV_IOU_SAMPLES:
                break
            g, p = r["gt"], r["pred"]
            ref = getattr(iou_oracle, "iou_matrix_bev" if r["mode"] == "iou_bev"
                          else "iou_matrix_3d")(g["pos"], g["dims"], g["rot"],
                                                p["pos"], p["dims"], p["rot"])
            cpu = iou_matrix_host(g, p, r["mode"], device="cpu")
            if r["mat"].shape != ref.shape:
                fail(f"IoU {r['mode']} shape {r['mat'].shape} vs {ref.shape}")
            if r["mat"].size:
                worst_oracle = max(worst_oracle, float(np.abs(r["mat"] - ref).max()))
                worst_cpu = max(worst_cpu, float(np.abs(r["mat"] - cpu).max()))
            overlapping += int((ref > 0).sum())
        res["iou_on_card"] = {"samples": EV_IOU_SAMPLES, "overlapping_pairs": overlapping,
                              "max_abs_diff_vs_oracle": worst_oracle,
                              "max_abs_diff_vs_cpu": worst_cpu,
                              "tolerance": {"oracle": EV_IOU_ORACLE_ATOL,
                                            "cpu": EV_IOU_CPU_ATOL}}
        if (worst_oracle > EV_IOU_ORACLE_ATOL or worst_cpu > EV_IOU_CPU_ATOL
                or overlapping < 1):
            fail(f"IoU on the card: {res['iou_on_card']}")

        # kernels against plain: the same kept boxes, the same metrics
        box_diff, same_valid = 0.0, True
        for kc, pc in zip((run2_val, run2_vot), plain_calls):
            for a, b in zip(kc["preds"], pc["preds"]):
                same_valid &= bool(np.array_equal(a["valid"], b["valid"]))
                if same_valid:
                    box_diff = max(box_diff, *(float(np.abs(a[f] - b[f]).max())
                                               for f in ("pos", "dims", "rot", "probs")))
        same_keys, mdiff, bitwise = metrics_diff(m2, m2_plain)
        res["kernel_vs_plain"] = {"same_valid": same_valid,
                                  "boxes_max_abs_diff": box_diff,
                                  "metrics_same_keys": same_keys,
                                  "metrics_max_abs_diff": mdiff,
                                  "metrics_bitwise": bitwise,
                                  "tolerance": {"boxes": DET_BOX_ATOL,
                                                "metrics": EV_METRIC_ATOL}}
        if (not same_valid or box_diff > DET_BOX_ATOL or not same_keys
                or mdiff > EV_METRIC_ATOL):
            fail(f"validate, kernels vs plain: {res['kernel_vs_plain']}")

        # the card against the CPU: the card's predictions through run_val
        # on the CPU
        cvc = {}
        for name, call in (("mined_db_train", run1), ("validate_val", run2_val),
                           ("validate_val_on_train", run2_vot)):
            preds = iter(call["preds"])
            kw = {k: v for k, v in call["kw"].items() if k != "writer"}
            t0 = time.perf_counter()
            cpu = rv.run_val(iter(call["batches"]), lambda b: next(preds),
                             **{**kw, "device": "cpu"})
            same_keys, mdiff, bitwise = metrics_diff(call["metrics"], cpu)
            cvc[name] = {"same_keys": same_keys, "max_abs_diff": mdiff,
                         "bitwise": bitwise, "cpu_s": time.perf_counter() - t0,
                         "iou_within_near_of_a_threshold": near_threshold_pairs(call)}
        res["card_vs_cpu"] = {**cvc, "tolerance": EV_METRIC_ATOL, "near": EV_NEAR}
        if any(not c["same_keys"] or c["max_abs_diff"] > EV_METRIC_ATOL
               for c in cvc.values()):
            fail(f"run_val on the card vs the CPU: {res['card_vs_cpu']}")

        # the checkpoint round trip and eval_cli on it, in its own process
        ckpt = Path(tmp.name) / "ckpts"
        save_checkpoint(ckpt, det.step, det)
        restore_checkpoint(ckpt, det.step, loop.trainer)
        diff = state_equal(det.state_dict(), loop.trainer.state_dict())
        if diff:
            fail(f"the detector's checkpoint restores differently at {diff[:8]}")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "liso_tpu_torch.cli.eval_cli", "-c", *configs,
             "--load_checkpoint", str(ckpt), "--summary_dir",
             str(Path(tmp.name) / "cli")],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"eval_cli exited {out.returncode}: {out.stderr[-2000:]}")
        # eval_cli names the per-class bank after the data source, validate
        # after its default family
        family = str(cfg.data.source).upper()
        want = {k.replace("/KITTI/per_class/", f"/{family}/per_class/"): repr(float(v))
                for k, v in m2.items() if not k.startswith("val_on_train/")}
        printed = {}
        for line in out.stdout.splitlines():
            k, _, v = line.partition(": ")
            if k in want:
                printed[k] = v
        differ = sorted(k for k in want if printed.get(k) != want[k])
        res["eval_cli_checkpoint"] = {"wall_s": cli_s, "metrics": len(printed),
                                      "differ_from_validate": differ[:8],
                                      "checkpoint_restores_bitwise": True}
        if differ:
            fail(f"eval_cli on the checkpoint: {len(differ)} of {len(want)} "
                 f"metrics differ from validate's, e.g. "
                 f"{[(k, printed.get(k), want[k]) for k in differ[:4]]}")
    finally:
        tmp.cleanup()
    res["phase_s"] = time.perf_counter() - t_phase
    return kres, res


def span_tail_ms(names, n: int) -> list:
    """The last `n` untraced durations (ms) of the spans `names`
    (`liso_tpu_torch/utils/trace.py`'s rings), summed step by step. Each
    span is opened once a step, so the rings' tails are the same steps."""
    from liso_tpu_torch.utils import trace

    tails = []
    for name in names:
        st = trace.stats(name)
        ring = st["ring_ms"] if st else []
        if len(ring) < n:
            fail(f"span {name}: {len(ring)} untraced calls kept, expected {n}")
        tails.append(ring[-n:])
    return [sum(v) for v in zip(*tails)]


def loop_step_ms(n: int) -> list:
    """The rounds loop's last `n` steps from their spans: the loader's wait
    (`det.wait`), the paste and copy (`det.paste`, `det.h2d`), and the
    train step to its loss read back (`det.loss`, `det.backward`,
    `det.optimizer`, `det.readback`)."""
    wait = span_tail_ms(("det.wait",), n)
    prep = span_tail_ms(("det.paste", "det.h2d"), n)
    train = span_tail_ms(("det.loss", "det.backward", "det.optimizer",
                          "det.readback"), n)
    return [{"wait_ms": w, "prepare_ms": p, "train_step_ms": t}
            for w, p, t in zip(wait, prep, train)]


class RoundsRecorder:
    """Wraps what liso_cli's rounds loop calls (LisoSelfTraining.run, mine,
    _prepare_batch, _init_detector, validate, save; liso_loop.run_val;
    DetectorTrainer.train_step) at class level: the loop object, the first
    prepared batch (kept on the card), the model state right after each
    detector init (on the host), each step's metrics, each round's mining
    seconds and DB sizes, each run_val call's seconds, each validate's and
    save's time, and the state and DBs saved at step R_SNAP_STEP. Installed
    with `with`, restored on exit."""

    def __init__(self):
        self.loop = None
        self.batch = None
        self.inits, self.metrics, self.rounds = [], [], []
        self.run_vals, self.validates, self.saves = [], [], []
        self.snap = None
        self._in_validate = False

    def __enter__(self):
        import copy

        import torch

        from liso_tpu_torch.train import detector_train, liso_loop

        L, rec = liso_loop.LisoSelfTraining, self
        self._saved = [(o, n, getattr(o, n)) for o, n in (
            (L, "run"), (L, "mine"), (L, "_prepare_batch"), (L, "_init_detector"),
            (L, "validate"), (L, "save"), (liso_loop, "run_val"),
            (detector_train.DetectorTrainer, "train_step"))]
        f = {n: fn for _, n, fn in self._saved}

        def run(loop, *a, **k):
            rec.loop = loop
            return f["run"](loop, *a, **k)

        def mine(loop, dataset, *a, **k):
            step, r = len(rec.metrics), loop.round_idx
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f["mine"](loop, dataset, *a, **k)
            torch.cuda.synchronize()
            tracks, boxes = db_stats(loop.mined_db)
            rec.rounds.append({"step": step, "round": r,
                               "seconds": time.perf_counter() - t0,
                               "tracks": tracks, "boxes": boxes,
                               "snippets": len(loop.augm_db["boxes"])})

        def prepare(loop, batch):
            out = f["_prepare_batch"](loop, batch)
            if rec.batch is None:
                rec.batch = out
            return out

        def init(loop, seed):
            f["_init_detector"](loop, seed)
            rec.inits.append({"step": len(rec.metrics), "round": loop.round_idx,
                              "seed": seed,
                              "model": to_host(loop.trainer.model.state_dict())})

        def validate(loop, step, *a, **k):
            rec._in_validate = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return f["validate"](loop, step, *a, **k)
            finally:
                torch.cuda.synchronize()
                rec._in_validate = False
                rec.validates.append({"step": step,
                                      "seconds": time.perf_counter() - t0})

        def run_val(*a, **k):
            t0 = time.perf_counter()
            out = f["run_val"](*a, **k)
            rec.run_vals.append({"validate": rec._in_validate,
                                 "seconds": time.perf_counter() - t0})
            return out

        def save(loop, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f["save"](loop, step)
            rec.saves.append({"step": step,
                              "ms": (time.perf_counter() - t0) * 1e3})
            if step == R_SNAP_STEP:
                rec.snap = {"state": to_host(loop.trainer.state_dict()),
                            "mined_db": copy.deepcopy(loop.mined_db),
                            "augm_db": copy.deepcopy(loop.augm_db)}

        def train_step(trainer, *a, **k):
            m = f["train_step"](trainer, *a, **k)
            rec.metrics.append({n: float(v) for n, v in m.items()})
            return m

        L.run, L.mine, L._prepare_batch, L._init_detector = run, mine, prepare, init
        L.validate, L.save, liso_loop.run_val = validate, save, run_val
        detector_train.DetectorTrainer.train_step = train_step
        return self

    def __exit__(self, *exc):
        for o, n, fn in self._saved:
            setattr(o, n, fn)
        return False


def to_host(tree):
    """A copy of a state tree (nested dicts) with every tensor on the host."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().clone() if hasattr(tree, "detach") else tree


def run_lines(out):
    """(step, round) of each 'step N: mining round R' line, and the rounds
    reset ('round R: resetting ...'), from the rounds loop's stdout."""
    import re

    mined = [(int(a), int(b)) for a, b in
             re.findall(r"^step (\d+): mining round (\d+)$", out, re.M)]
    resets = [int(r) for r in re.findall(r"^round (\d+): resetting", out, re.M)]
    return mined, resets


def phase_rounds(kernels):
    """The rounds loop as `liso_cli -c bev_100m_512 centerpoint liso` runs
    it, cut only in its step counts (R_KV), on the 64-frame drive; then the
    same command resumed from the step-R_SPR checkpoint in its own
    process."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from liso_tpu_torch.cli import liso_cli
    from liso_tpu_torch.cli.common import DEFAULT_CFG
    from liso_tpu_torch.cli.slim_cli import build_datasets, make_train_dataset
    from liso_tpu_torch.data.pipeline import Prefetcher
    from liso_tpu_torch.models.layers import init_weights
    from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
    from liso_tpu_torch.tracker.dbs import finalize_augm_db, load_augm_db
    from liso_tpu_torch.train import liso_loop
    from liso_tpu_torch.utils.checkpoint import STATE_FILE, latest_step
    from liso_tpu_torch.utils.config import parse_config

    t_phase = time.perf_counter()
    configs = ["bev_100m_512", "centerpoint", "liso"]
    cfg = parse_config(DEFAULT_CFG, configs, R_KV)
    opt, rd = cfg.optimization, cfg.optimization.rounds
    got_cfg = (tuple(cfg.data.img_grid_size), int(cfg.data.batch_size),
               int(rd.steps_per_round), int(rd.drop_net_weights_every_nth_round),
               int(opt.num_training_steps), bool(cfg.data.augmentation.boxes.active),
               int(cfg.checkpoint.save_model_every),
               int(cfg.validation.val_every_n_steps), int(cfg.seed))
    if got_cfg != ((D_GRID, D_GRID), D_BATCH, R_SPR, 2, R_STEPS, True, R_SPR,
                   R_VAL, 0):
        fail(f"{' '.join(configs)} with {R_KV} gave {got_cfg}")
    ds_cfg = build_datasets(cfg, False, target="object")[0].cfg
    seed = int(cfg.seed)
    argv = ["-c", *configs]
    for kv in R_KV:
        argv += ["-kv", *kv]
    zero = {k: 0 for k in kernels.launches}
    loss_keys = ("loss/probs", "loss/rot", "loss/dims", "loss/pos", "loss/total")
    tmp = tempfile.TemporaryDirectory(prefix="rounds_", dir=OUT_DIR)
    try:
        # 1. before the run, so that every profiler session of the phase
        # comes before the run's fork workers start and stop (on an H100,
        # three kernel_only_ms sessions after them saw no launch of the
        # VJP): a batch of the drive as _prepare_batch gives it to the first
        # step, K1 and the fused VJP held and timed at its cells, the loop's
        # first detector (seed + 1) stepped with kernels and through the
        # plain versions (cuDNN deterministic), and a profiled step
        pre = liso_loop.LisoSelfTraining(
            cfg, lambda db: make_train_dataset(cfg, ds_cfg, False, db), None,
            Path(tmp.name) / "pre", data_cfg=ds_cfg, device="cuda")
        loader = Prefetcher(make_train_dataset(cfg, ds_cfg, False),
                            batch_size=D_BATCH, num_workers=1)
        it = iter(loader)
        pts, valid, target = pre._prepare_batch(next(it))
        it.close()
        loader.close()
        bev = pre.bev
        cells = prepare_pillar_inputs(pts, valid, bev).cell
        kres = [check(torch.Generator(device="cuda").manual_seed(s), cells,
                      bev.num_cells, 64, torch.float32)
                for check, s in ((check_scatter_max, 15), (check_scatter_max_vjp, 16))]
        pre._init_detector(seed + 1)
        trainer = pre.trainer
        snap = snapshot(trainer, ("mu", "nu", "step", "count"))
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            mk = trainer.train_step(pts, valid, target)
            restore(trainer, snap)
            kernels.reset_launches()
            with kernels.plain_versions():
                mp = trainer.train_step(pts, valid, target)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        if any(kernels.launches.values()):
            fail(f"the plain loop step launched kernels: {dict(kernels.launches)}")
        kvp = {k: (float(mk[k]), float(mp[k])) for k in loss_keys}
        if any(abs(a - b) > DET_LOSS_RTOL * abs(b) for a, b in kvp.values()):
            fail(f"a loop step, kernels vs plain: {kvp}")
        restore(trainer, snap)
        counts, dev_ms, rows, _ = confirm_launches(
            lambda: trainer.train_step(pts, valid, target),
            {**zero, "grid_scatter_max_occ": 1, "scatter_max_vjp": 1},
            "a rounds loop step")
        del pre, trainer, snap
        torch.cuda.empty_cache()

        # 2. the fresh run, in this process
        rec = RoundsRecorder()
        out = io.StringIO()
        with rec, contextlib.redirect_stdout(out):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            log_dir = liso_cli.main(argv + ["--summary_dir", str(Path(tmp.name) / "fresh")])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = dict(kernels.launches)
        loop = rec.loop
        n_val = len(loop.val_dataset)
        n_train = len(loop.train_dataset_factory(None))
        chunks = -(-n_train // M_CHUNK)
        # K1: each train step, each detector mining chunk (rounds 1, 2),
        # the final validate's predict_step (val + val-on-train); the fused
        # VJP: each train step; the eval BN + ReLU: each norm of each of
        # those detector forwards but the train steps'
        forwards = 2 * chunks + n_val + n_train
        expect = {**zero, "grid_scatter_max_occ": R_STEPS + forwards,
                  "scatter_max_vjp": R_STEPS,
                  "bn_relu_eval": eval_norms(loop.trainer.model) * forwards}
        if launches != expect:
            fail(f"rounds loop launches {launches}, expected {expect}")
        mined, resets = run_lines(out.getvalue())
        want_mined = [(s, s // R_SPR) for s in range(0, R_STEPS, R_SPR)]
        losses = [m["loss/total"] for m in rec.metrics]
        res = {"phase": "rounds", "configs": " ".join(configs) + " (liso_cli)",
               "cuts": {" ".join(kv[:-1]): kv[-1] for kv in R_KV},
               "grid": D_GRID, "n_max": M_PTS, "batch": D_BATCH,
               "train_frames": n_train, "val_frames": n_val,
               "points_in_grid": kres[0]["points_in_grid"],
               "kernel_vs_plain": {"losses": kvp, "rtol": DET_LOSS_RTOL},
               "run_s": run_s, "launches": launches,
               "mined_at": mined, "resets": resets,
               "inits": [{k: i[k] for k in ("step", "round", "seed")}
                         for i in rec.inits],
               "rounds": [{**r, "mined_db_run_val_s": v["seconds"]} for r, v in
                          zip(rec.rounds, [v for v in rec.run_vals
                                           if not v["validate"]])],
               "steps": [{"step": i, **row, "loss": loss} for i, (row, loss)
                         in enumerate(zip(loop_step_ms(R_STEPS), losses))],
               "validate_s": [v["seconds"] for v in rec.validates],
               "save_ms": [s["ms"] for s in rec.saves]}
        if mined != want_mined or resets != [2]:
            fail(f"mined at {mined} (want {want_mined}), resets {resets} (want [2])")
        if [(i["step"], i["seed"]) for i in rec.inits] != [(0, seed + 1),
                                                           (2 * R_SPR, seed + 3)]:
            fail(f"detector inits {res['inits']}, expected seeds {seed + 1} at "
                 f"step 0 and {seed + 3} at step {2 * R_SPR}")
        if len(losses) != R_STEPS or not all(np.isfinite(losses)):
            fail(f"rounds loop losses {losses}")
        if rec.rounds[0]["boxes"] < 1:
            fail("round 0 mined no box: the paste path would not run")
        if [v["step"] for v in rec.validates] != [R_STEPS]:
            fail(f"validates at {[v['step'] for v in rec.validates]}")
        ckpts = Path(log_dir) / "ckpts"
        steps = sorted(int(p.name) for p in ckpts.iterdir() if p.name.isdigit())
        if steps != [R_SPR, 2 * R_SPR, R_STEPS]:
            fail(f"checkpoints at {steps}")
        count16 = torch.load(ckpts / str(R_SNAP_STEP) / STATE_FILE,
                             weights_only=True)["optimizer"]["count"]
        if count16 != 1:
            fail(f"the step-{R_SNAP_STEP} checkpoint holds AdamW count {count16}, "
                 "expected 1 (reset at that step)")

        # 3. the reset's weights: init_weights(model, seed + 3) on the CPU
        cpu = liso_loop.LisoSelfTraining(cfg, lambda db: None, None,
                                         Path(tmp.name) / "cpu",
                                         data_cfg=loop.data_cfg, device="cpu")
        init_weights(cpu.trainer.model, seed + 3)
        diff = state_equal(rec.inits[1]["model"], cpu.trainer.model.state_dict())
        if diff:
            fail(f"the reset's weights differ from init_weights(seed + 3) on the "
                 f"CPU at {diff[:8]}")

        # 4. the run's first prepared batch: the card against the CPU from
        # the first init's weights; K1 and the fused VJP held bitwise at its
        # cells
        pts, valid, target = rec.batch
        cpu.trainer.model.load_state_dict(rec.inits[0]["model"])
        t0 = time.perf_counter()
        m_cpu = cpu.trainer.train_step(
            pts.cpu(), valid.cpu(),
            target.replace(**{f: getattr(target, f).cpu() for f in
                              ("pos", "dims", "rot", "probs", "velo", "valid",
                               "class_id", "difficulty")}))
        cpu_ms = (time.perf_counter() - t0) * 1e3
        card_cpu = {k: (rec.metrics[0][k], float(m_cpu[k])) for k in loss_keys}
        res["card_vs_cpu"] = {"losses": card_cpu, "rtol": R_CPU_RTOL,
                              "cpu_step_ms": cpu_ms}
        if any(abs(a - b) > R_CPU_RTOL * abs(b) for a, b in card_cpu.values()):
            fail(f"first step's losses, card vs CPU: {card_cpu}")
        del cpu
        cells = prepare_pillar_inputs(pts, valid, bev).cell
        for check, s in ((check_scatter_max, 17), (check_scatter_max_vjp, 18)):
            check(torch.Generator(device="cuda").manual_seed(s), cells,
                  bev.num_cells, 64, torch.float32, timed=False)
        step_ms = [r["train_step_ms"] for r in res["steps"]]
        res["run_batch_points_in_grid"] = int((cells < bev.num_cells).sum())
        res["profiled_step"] = {
            "launches": counts, "device_ms": dev_ms,
            "train_step_ms_median": statistics.median(step_ms),
            "device_busy_share": dev_ms / statistics.median(step_ms),
            "device_ms_by_family": families(rows)}

        # 5. save and restore: the step-R_SNAP_STEP checkpoint and the DBs
        # beside it
        # into a fresh loop, bitwise
        snap16 = rec.snap
        rdir = Path(tmp.name) / "restore"
        shutil.copytree(ckpts / str(R_SNAP_STEP), rdir / "ckpts" / str(R_SNAP_STEP))
        shutil.copy(ckpts / "format_version", rdir / "ckpts")
        shutil.copy(Path(log_dir) / "config.yml", rdir / "config.yml")
        for r in range(3):
            shutil.copytree(Path(log_dir) / f"mined_round_{r}",
                            rdir / f"mined_round_{r}")
        fresh = liso_loop.LisoSelfTraining(cfg, lambda db: None, None,
                                           Path(tmp.name) / "fresh_loop",
                                           data_cfg=loop.data_cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = fresh.restore(rdir / "ckpts")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        augm_file = rdir / f"mined_round_{2}" / "augm_db.npy"
        diff = (state_equal(to_host(fresh.trainer.state_dict()), snap16["state"])
                + tree_equal(fresh.mined_db, snap16["mined_db"])
                + tree_equal(np.load(augm_file, allow_pickle=True).item(),
                             finalize_augm_db(snap16["augm_db"]))
                + tree_equal(fresh._augm_db_final, load_augm_db(augm_file)))
        res["save_restore"] = {"step": step, "restore_ms": restore_ms,
                               "checkpoint_bytes": (ckpts / str(R_SNAP_STEP)
                                                    / STATE_FILE).stat().st_size,
                               "bitwise": not diff}
        if step != R_SNAP_STEP or diff:
            fail(f"restore of step {R_SNAP_STEP} gave step {step}, differs at "
                 f"{diff[:8]}")
        del fresh, loop
        torch.cuda.empty_cache()

        # 6. the resume, in its own process: step 8's checkpoint and rounds
        # 0-1's DBs; it continues at step 9 with round_idx 2, mines round 2
        # and resets at step 2 R_SPR, and saves 2 R_SPR and R_STEPS
        resume = Path(tmp.name) / "resume"
        shutil.copytree(ckpts / str(R_SPR), resume / "ckpts" / str(R_SPR))
        shutil.copy(ckpts / "format_version", resume / "ckpts")
        shutil.copy(Path(log_dir) / "config.yml", resume / "config.yml")
        for r in range(2):
            shutil.copytree(Path(log_dir) / f"mined_round_{r}",
                            resume / f"mined_round_{r}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "liso_tpu_torch.cli.liso_cli", *argv,
             "--load_checkpoint", str(resume / "ckpts"),
             "--summary_dir", str(Path(tmp.name) / "resumed")],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        resume_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"the resumed liso_cli exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        r_mined, r_resets = run_lines(proc.stdout)
        done = [ln for ln in proc.stdout.splitlines() if ln.startswith("done; logs in ")]
        r_steps = sorted(int(p.name) for p in
                         (Path(done[-1][len("done; logs in "):]) / "ckpts").iterdir()
                         if p.name.isdigit()) if done else []
        res["resume"] = {"wall_s": resume_s, "mined_at": r_mined,
                         "resets": r_resets, "checkpoints": r_steps}
        if (f"resuming after step {R_SPR}" not in proc.stdout
                or r_mined != [m for m in mined if m[0] > R_SPR]
                or r_resets != [2] or r_steps != [2 * R_SPR, R_STEPS]):
            fail(f"the resume: {res['resume']}, expected mining {mined[2:]}, "
                 f"reset [2], checkpoints [16, 17]")
    finally:
        tmp.cleanup()
    res["phase_s"] = time.perf_counter() - t_phase
    return kres, res


def phase_detectors(kernels):
    """The other detectors (TransFusion, PointPillars, PointRCNN, the
    non-baseline CenterPoint) at full width, each from its preset through
    LisoSelfTraining._make_trainer; then `liso_cli -c bev_100m_512
    transfusion liso` cut in step counts (DT_CLI_KV)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from liso_tpu_torch.cli import liso_cli
    from liso_tpu_torch.cli.common import DEFAULT_CFG
    from liso_tpu_torch.cli.slim_cli import build_datasets, make_train_dataset
    from liso_tpu_torch.data.pipeline import Prefetcher
    from liso_tpu_torch.losses import hungarian_loss
    from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
    from liso_tpu_torch.train import liso_loop
    from liso_tpu_torch.utils.config import parse_config

    t_phase = time.perf_counter()
    zero = {k: 0 for k in kernels.launches}
    per_step = {**zero, "grid_scatter_max_occ": 1, "scatter_max_vjp": 1}
    box_fields = ("pos", "dims", "rot", "probs")
    tmp = tempfile.TemporaryDirectory(prefix="detectors_", dir=OUT_DIR)
    host_ms_log = []
    assign = hungarian_loss.assign_host

    def timed_assign(cost):  # the Hungarian stage's scipy call, on the host
        t0 = time.perf_counter()
        out = assign(cost)
        host_ms_log.append((time.perf_counter() - t0) * 1e3)
        return out

    res = {"phase": "detectors", "grid": D_GRID, "n_max": M_PTS,
           "batch": D_BATCH, "dtype": "fp32 (TF32 off by the trainers)",
           "warmup_steps": DT_WARMUP, "steps": DT_STEPS,
           "predicts": DT_PREDICTS, "configs": {}}
    launches = dict(zero)
    try:
        hungarian_loss.assign_host = timed_assign
        # the phase's first batch, as _prepare_batch gives a loop's first
        # step (no DB yet): K1 and the fused VJP held bitwise and timed at
        # its cells, before any of the phase's fork workers run
        cfgs = {name: parse_config(DEFAULT_CFG, ["bev_100m_512", net, "liso"], kv)
                for name, net, kv in DT_CONFIGS}
        cfg0 = cfgs["transfusion"]
        ds_cfg = build_datasets(cfg0, False, target="object")[0].cfg
        seed = int(cfg0.seed)
        loops = {name: liso_loop.LisoSelfTraining(
            cfg, lambda db: None, None, Path(tmp.name) / name, data_cfg=ds_cfg,
            device="cuda") for name, cfg in cfgs.items()}
        loader = Prefetcher(make_train_dataset(cfg0, ds_cfg, False),
                            batch_size=D_BATCH, num_workers=1)
        it = iter(loader)
        pts, valid, target = loops["transfusion"]._prepare_batch(next(it))
        it.close()
        loader.close()
        bev = loops["transfusion"].bev
        cells = prepare_pillar_inputs(pts, valid, bev).cell
        kres = [check(torch.Generator(device="cuda").manual_seed(s), cells,
                      bev.num_cells, 64, torch.float32)
                for check, s in ((check_scatter_max, 21), (check_scatter_max_vjp, 22))]
        res["points_in_grid"] = kres[0]["points_in_grid"]
        res["target_boxes"] = int(target.valid.sum())

        for name, net, kv in DT_CONFIGS:
            loop = loops.pop(name)
            loop._init_detector(seed + 1)
            trainer = loop.trainer
            r = {"configs": f"bev_100m_512 {net} liso"
                 + "".join(f" -kv {' '.join(x)}" for x in kv),
                 "trainer": type(trainer).__name__}
            state0 = to_host(trainer.state_dict())
            snap = snapshot(trainer, ("mu", "nu", "step", "count"))
            # (b) one step with the kernels and through the plain versions,
            # cuDNN deterministic
            saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
            try:
                mk = trainer.train_step(pts, valid, target)
                restore(trainer, snap)
                kernels.reset_launches()
                with kernels.plain_versions():
                    mp = trainer.train_step(pts, valid, target)
                torch.cuda.synchronize()
            finally:
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
            if any(kernels.launches.values()):
                fail(f"{name}: the plain step launched kernels: "
                     f"{dict(kernels.launches)}")
            keys = sorted(k for k in mk if k.startswith("loss/"))
            kvp = {k: (float(mk[k]), float(mp[k])) for k in keys}
            r["kernel_vs_plain"] = {"losses": kvp, "rtol": DET_LOSS_RTOL}
            if set(mk) != set(mp) or any(
                    not abs(a - b) <= DET_LOSS_RTOL * abs(b) for a, b in kvp.values()):
                fail(f"{name}: a step, kernels vs plain: {kvp}")
            # (c) the first step on the CPU from the same state
            cpu = liso_loop.LisoSelfTraining(
                cfgs[name], lambda db: None, None, Path(tmp.name) / f"{name}_cpu",
                data_cfg=ds_cfg, device="cpu").trainer
            cpu.load_state_dict(state0)
            t0 = time.perf_counter()
            m_cpu = cpu.train_step(
                pts.cpu(), valid.cpu(),
                target.replace(**{f: getattr(target, f).cpu() for f in
                                  ("pos", "dims", "rot", "probs", "velo", "valid",
                                   "class_id", "difficulty")}))
            card_cpu = {k: (float(mk[k]), float(m_cpu[k])) for k in keys}
            r["card_vs_cpu"] = {"losses": card_cpu, "tol": DT_CPU_TOL,
                                "cpu_step_ms": (time.perf_counter() - t0) * 1e3}
            del cpu
            if any(not abs(a - b) <= DT_CPU_TOL * max(1.0, abs(b))
                   for a, b in card_cpu.values()):
                fail(f"{name}: first step, card vs CPU: {card_cpu}")

            # (d) timed steps from the initial state, the Hungarian host
            # stage timed inside them
            restore(trainer, snap)
            for _ in range(DT_WARMUP):
                trainer.train_step(pts, valid, target)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            host_ms_log.clear()
            step_ms, losses = [], []
            for _ in range(DT_STEPS):
                t0 = time.perf_counter()
                m = trainer.train_step(pts, valid, target)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss/total"]))
            step_launches = dict(kernels.launches)
            hung_ms = list(host_ms_log)
            if step_launches != {k: v * DT_STEPS for k, v in per_step.items()}:
                fail(f"{name}: train step launches {step_launches}")
            if not all(np.isfinite(losses)):
                fail(f"{name}: train losses {losses}")
            counts, dev_ms, rows, _ = confirm_launches(
                lambda: trainer.train_step(pts, valid, target), per_step,
                f"a {name} train step")
            med = statistics.median(step_ms)
            r.update({
                "step_ms_median": med, "step_ms_max": max(step_ms),
                "steps_ms": step_ms, "losses": losses,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
                "hungarian_host_ms_per_step": (sum(hung_ms) / DT_STEPS
                                               if hung_ms else None),
                "hungarian_calls_per_step": len(hung_ms) / DT_STEPS,
                "profiled_step": {"launches": counts, "device_ms": dev_ms,
                                  "device_busy_share": dev_ms / med,
                                  "device_ms_by_family": families(rows)}})

            # (e) predict_step: 10 timed calls; the kept boxes against the
            # plain run's
            trainer.predict_step(pts, valid)
            torch.cuda.synchronize()
            kernels.reset_launches()
            pred_ms = []
            for _ in range(DT_PREDICTS):
                t0 = time.perf_counter()
                boxes = trainer.predict_step(pts, valid)
                torch.cuda.synchronize()
                pred_ms.append((time.perf_counter() - t0) * 1e3)
            pred_launches = dict(kernels.launches)
            if pred_launches != {**zero, "grid_scatter_max_occ": DT_PREDICTS,
                                 "bn_relu_eval": (eval_norms(trainer.model)
                                                  * DT_PREDICTS)}:
                fail(f"{name}: predict_step launches {pred_launches}")
            with kernels.plain_versions():
                ref = trainer.predict_step(pts, valid)
            diff = max(float((getattr(boxes, f) - getattr(ref, f)).abs().max())
                       for f in box_fields)
            kept = boxes.valid.sum(-1).tolist()
            r.update({"predict_ms_median": statistics.median(pred_ms),
                      "predict_ms_max": max(pred_ms), "predict_kept": kept,
                      "predict_max_abs_diff_vs_plain": diff})
            if (not torch.equal(boxes.valid, ref.valid) or not diff <= DET_BOX_ATOL
                    or not all(bool(torch.isfinite(getattr(boxes, f)).all())
                               for f in box_fields)):
                fail(f"{name}: predict_step kept boxes differ from the plain "
                     f"run's (max abs diff {diff}, kept {kept} vs "
                     f"{ref.valid.sum(-1).tolist()})")
            for k in launches:
                launches[k] += step_launches[k] + pred_launches[k]
            res["configs"][name] = r
            emit({"phase": "detectors_config", "name": name,
                  **{k: v for k, v in r.items() if k not in ("steps_ms", "losses")}})
            del loop, trainer, snap, state0, boxes, ref
            torch.cuda.empty_cache()
        del loops

        # the end-to-end run: liso_cli -c bev_100m_512 transfusion liso
        argv = ["-c", "bev_100m_512", "transfusion", "liso"]
        for kv in DT_CLI_KV:
            argv += ["-kv", *kv]
        rec = RoundsRecorder()
        out = io.StringIO()
        with rec, contextlib.redirect_stdout(out):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            log_dir = liso_cli.main(argv + ["--summary_dir",
                                            str(Path(tmp.name) / "cli")])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            cli_launches = dict(kernels.launches)
        loop = rec.loop
        n_val = len(loop.val_dataset)
        n_train = len(loop.train_dataset_factory(None))
        chunks = -(-n_train // M_CHUNK)
        # K1: each step, each detector mining chunk (rounds 1 and 2), each
        # validate's predict_step (val + val-on-train); the VJP: each step;
        # the eval BN + ReLU: each norm of those forwards but the steps'
        forwards = 2 * chunks + 2 * (n_val + n_train)
        expect = {**zero, "grid_scatter_max_occ": DT_TOTAL + forwards,
                  "scatter_max_vjp": DT_TOTAL,
                  "bn_relu_eval": eval_norms(loop.trainer.model) * forwards}
        mined, resets = run_lines(out.getvalue())
        ckpts = sorted(int(p.name) for p in (Path(log_dir) / "ckpts").iterdir()
                       if p.name.isdigit())
        cli_losses = [m["loss/total"] for m in rec.metrics]
        res["liso_cli"] = {
            "configs": " ".join(argv[1:]), "run_s": run_s,
            "launches": cli_launches, "mined_at": mined, "resets": resets,
            "checkpoints": ckpts,
            "trainer": type(loop.trainer).__name__,
            "rounds": [{**r, "mined_db_run_val_s": v["seconds"]} for r, v in
                       zip(rec.rounds, [v for v in rec.run_vals
                                        if not v["validate"]])],
            "steps": [{"step": i, **row, "loss": loss} for i, (row, loss)
                      in enumerate(zip(loop_step_ms(DT_TOTAL), cli_losses))],
            "validate_s": [v["seconds"] for v in rec.validates],
            "save_ms": [x["ms"] for x in rec.saves]}
        stages = res["liso_cli"]
        stages["stage_s"] = {
            "mining": sum(x["seconds"] for x in rec.rounds),
            "mined_db_run_val": sum(x["mined_db_run_val_s"] for x in stages["rounds"]),
            "validate": sum(stages["validate_s"]),
            "train_steps": sum(r["train_step_ms"] for r in stages["steps"]) / 1e3,
            "prepare_batch": sum(r["prepare_ms"] for r in stages["steps"]) / 1e3,
            "loader_wait": sum(r["wait_ms"] for r in stages["steps"]) / 1e3,
            "save": sum(stages["save_ms"]) / 1e3}
        if cli_launches != expect:
            fail(f"liso_cli transfusion launches {cli_launches}, expected {expect}")
        if (stages["trainer"] != "DetectorTrainer"
                or loop.trainer.network != "transfusion"):
            fail(f"liso_cli transfusion built {stages['trainer']}")
        if mined != [(s, s // DT_SPR) for s in range(0, DT_TOTAL, DT_SPR)] or resets != [2]:
            fail(f"liso_cli transfusion mined at {mined}, resets {resets}")
        if [v["step"] for v in rec.validates] != [DT_VAL, DT_TOTAL]:
            fail(f"liso_cli transfusion validates at "
                 f"{[v['step'] for v in rec.validates]}")
        if ckpts != [DT_SPR, 2 * DT_SPR, DT_TOTAL]:
            fail(f"liso_cli transfusion checkpoints at {ckpts}")
        if len(cli_losses) != DT_TOTAL or not all(np.isfinite(cli_losses)):
            fail(f"liso_cli transfusion losses {cli_losses}")
        for k in launches:
            launches[k] += cli_launches[k]
        del loop, rec
    finally:
        hungarian_loss.assign_host = assign
        tmp.cleanup()
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    return kres, res


# ---------------------------------------------------------------------------
# The parallel phase: data parallel over a process group
# ---------------------------------------------------------------------------
def p_slim_trainer(group):
    """The train phase's SLIM trainer (slim_liso, bf16, RMSprop, seed 0),
    its batch split over `group` when one is given."""
    import torch

    from liso_tpu_torch.ops.bev import BevSetup
    from liso_tpu_torch.train.slim_train import SlimTrainer

    return SlimTrainer(
        BevSetup((T_RANGE, T_RANGE), (T_GRID, T_GRID)), num_iters=T_ITERS,
        predict_weight_for_static_aggregation="sigmoid",
        use_static_aggr_flow_for_aggr_flow=True, compute_dtype=torch.bfloat16,
        seed=0, group=group, device="cuda")


def p_slim_batch():
    """The JAX train benchmark's clouds (bench_clouds) at batch P_WORLD, on
    the host: numpy RandomState(0), 65536 points a frame uniform in a cube
    of +-58 m, all valid, identity odometry."""
    import numpy as np
    import torch

    from liso_tpu_torch.data.sample import FlowSample, PointCloud

    rng = np.random.RandomState(0)
    half = 0.5 * T_RANGE - 2.0
    pcs = [PointCloud(
        torch.from_numpy(rng.uniform(-half, half, (P_WORLD, T_PTS, 4))
                         .astype(np.float32)),
        torch.ones(P_WORLD, T_PTS, dtype=torch.bool)) for _ in range(2)]
    eye = torch.eye(4).expand(P_WORLD, 4, 4).contiguous()
    return FlowSample(pcs[0], pcs[1], eye, eye)


def p_step(trainer, batch, slim: bool) -> dict:
    """One train step: SLIM takes a FlowSample, the detector (points,
    valid, target boxes)."""
    return trainer.train_step(batch) if slim else trainer.train_step(*batch)


class UpdateGradNorm:
    """The global norm of the gradient a detector trainer's AdamW update
    takes (the sum over the ranks under a group), recorded by wrapping
    train.detector_train.adamw_update_: PointPillars' and PointRCNN's
    metrics carry no grad norm, as the JAX trainers' do not."""

    def __enter__(self):
        from liso_tpu_torch.train import detector_train

        self.module, self.orig, self.norms = detector_train, \
            detector_train.adamw_update_, []

        def update(params, grads, *args, **kw):
            self.norms.append(float(detector_train.global_norm(grads)))
            return self.orig(params, grads, *args, **kw)

        detector_train.adamw_update_ = update
        return self

    def __exit__(self, *exc):
        self.module.adamw_update_ = self.orig


def p_first_step(trainer, batch, slim: bool) -> dict:
    """One step from the trainer's initial state: its metrics, and the
    threshold state (SLIM) or the BN running statistics and the update's
    grad norm (detector)."""
    if slim:
        m = p_step(trainer, batch, slim)
    else:
        with UpdateGradNorm() as rec:
            m = p_step(trainer, batch, slim)
    out = {"metrics": {k: float(v) for k, v in m.items()}}
    if not slim:
        out["metrics"]["update_grad_norm"] = rec.norms[-1]
    if slim:
        out["bias_counter"] = float(trainer.movavg.bias_counter)
        out["importance_cumsum"] = trainer.movavg.importance.double().cumsum(0).cpu()
    else:
        out["buffers"] = {k: v.detach().cpu().clone()
                          for k, v in trainer.model.named_buffers()}
    return out


def p_timed_steps(trainer, batch, slim: bool, kernels, warmup=P_WARMUP,
                  steps=P_STEPS) -> dict:
    """warmup - 1 more warm-up steps (the first step was the first), then
    `steps` timed steps, each awaited, with the launch counts reset just
    before and read just after, and the collectives' host time (the
    `mesh.collective` span) read before and after."""
    import torch

    from liso_tpu_torch.utils import trace

    def collectives():
        st = trace.stats("mesh.collective")
        return (st["calls"], st["total_ms"]) if st else (0, 0.0)

    for _ in range(warmup - 1):
        p_step(trainer, batch, slim)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    calls0, ms0 = collectives()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        p_step(trainer, batch, slim)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    calls1, ms1 = collectives()
    return {"step_ms_median": statistics.median(ms), "step_ms_max": max(ms),
            "step_ms": ms, "launches": dict(kernels.launches),
            "collectives": {"calls": calls1 - calls0,
                            "seconds": (ms1 - ms0) / 1e3},
            "collective_ms_per_step": (ms1 - ms0) / steps,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}


def p_step_launches(kernels) -> dict:
    """Each kernel's launches in one SLIM train step and in one step of
    each detector (CenterPoint's "det" and the others')."""
    zero = {k: 0 for k in kernels.launches}
    det = {**zero, "grid_scatter_max_occ": 1, "scatter_max_vjp": 1}
    return {
        "slim": {**zero, "grid_scatter_max_occ": 2,
                 "corr_window_fwd": 2 * T_ITERS, "scatter_max_vjp": 2,
                 "grid_reduce_add_c1": 1, "corr_window_bwd": 2 * T_ITERS,
                 "knn_banded": 2},
        "det": det, **{net: det for net in P_OTHERS},
    }


def p_other_trainer(net, ds_cfg, group):
    """`bev_100m_512 <net> liso`'s trainer as the rounds loop builds it
    (liso_loop.make_trainer), its step sharded over `group` when one is
    given."""
    from liso_tpu_torch.cli.common import DEFAULT_CFG
    from liso_tpu_torch.train import liso_loop
    from liso_tpu_torch.utils.config import parse_config

    cfg = parse_config(DEFAULT_CFG, ["bev_100m_512", net, "liso"])
    return liso_loop.make_trainer(cfg, ds_cfg.bev, group=group, device="cuda")


def parallel_rank(group, slim_batch, det_batch, det_kwargs, ds_cfg):
    """One rank of the parallel phase (a spawned process): the SLIM, the
    CenterPoint and then each of P_OTHERS' steps on this rank's shard of
    the global batch: the first step (compared with the one-process step),
    the timed steps, and up to P_PROFILED steps on every rank, rank 0's
    under the profiler, until its profiler sees every launch of the step
    (rank 0 broadcasts whether it did, so that every rank runs the same
    steps: each step meets the others in its collectives)."""
    import torch

    from liso_tpu_torch import kernels
    from liso_tpu_torch.parallel import mesh
    from liso_tpu_torch.train.detector_train import DetectorTrainer
    from liso_tpu_torch.train.liso_loop import cudnn_deterministic

    rank = torch.distributed.get_rank(group)
    expect = p_step_launches(kernels)

    def on_card(tree):
        return mesh.shard_batch(group, mesh.map_tree(lambda t: t.cuda(), tree))

    out = {"rank": rank}
    t0 = time.perf_counter()
    runs = [("slim", lambda: p_slim_trainer(group), slim_batch, True),
            ("det", lambda: DetectorTrainer(**det_kwargs, group=group,
                                            device="cuda"), det_batch, False)]
    for net in P_OTHERS:
        runs.append((net, lambda net=net: p_other_trainer(net, ds_cfg, group),
                     det_batch, False))
    for name, make, batch, slim in runs:
        other = name in P_OTHERS
        with cudnn_deterministic(not slim):
            t1 = time.perf_counter()
            trainer, batch = make(), on_card(batch)
            t2 = time.perf_counter()
            r = p_first_step(trainer, batch, slim)
            t3 = time.perf_counter()
            r.update(p_timed_steps(trainer, batch, slim, kernels,
                                   *((1, P_O_STEPS) if other else ())))
            t4 = time.perf_counter()
            profiled = []
            for _ in range(P_PROFILED):
                if rank == 0:
                    counts, dev_ms, _, _ = profile_window(
                        lambda: p_step(trainer, batch, slim))
                    profiled.append({"launches": counts, "device_ms": dev_ms})
                    seen = [counts == expect[name]]
                else:
                    p_step(trainer, batch, slim)
                    seen = [None]
                torch.distributed.broadcast_object_list(seen, src=0,
                                                        group=group)
                if seen[0]:
                    break
            r["profiled"] = profiled
            r["parts_s"] = {"build": t2 - t1, "first_step": t3 - t2,
                            "timed_steps": t4 - t3,
                            "profiled_steps": time.perf_counter() - t4}
        out[name] = r
        del trainer
        torch.cuda.empty_cache()
    out["steps_s"] = time.perf_counter() - t0
    return out


def p_det_batch():
    """The rounds cell's first batch (`bev_100m_512 centerpoint liso`,
    batch 2, n_max 65536, 512^2 cells) as `_prepare_batch` gives it, on the
    host, the DetectorTrainer arguments of that preset and its DataCfg."""
    import tempfile

    from liso_tpu_torch.cli.common import DEFAULT_CFG
    from liso_tpu_torch.cli.slim_cli import build_datasets, make_train_dataset
    from liso_tpu_torch.data.pipeline import Prefetcher
    from liso_tpu_torch.parallel.mesh import map_tree
    from liso_tpu_torch.train import liso_loop
    from liso_tpu_torch.utils.config import parse_config

    cfg = parse_config(DEFAULT_CFG, ["bev_100m_512", "centerpoint", "liso"])
    ds_cfg = build_datasets(cfg, False, target="object")[0].cfg
    with tempfile.TemporaryDirectory(prefix="parallel_", dir=OUT_DIR) as tmp:
        loop = liso_loop.LisoSelfTraining(cfg, lambda db: None, None, tmp,
                                          data_cfg=ds_cfg, device="cuda")
        loader = Prefetcher(make_train_dataset(cfg, ds_cfg, False),
                            batch_size=P_WORLD, num_workers=1)
        it = iter(loader)
        try:
            batch = loop._prepare_batch(next(it))
        finally:
            it.close()
            loader.close()
    kw = {"bev": loop.bev, "box_cfg": loop.box_cfg,
          "max_lr": float(cfg.optimization.learning_rate),
          "total_steps": D_TOTAL_STEPS, "seed": int(cfg.seed) + 1}
    return map_tree(lambda t: t.cpu(), batch), kw, ds_cfg


def p_rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def p_liso_cli_workers(tmp: Path, meanwhile) -> tuple:
    """Two `liso_cli` processes on the card over one log dir
    (--world_size 2 --worker_id 0/1), cut in step counts only (P_CLI_KV):
    mining at 0 and P_CLI_SPR, the replica check at P_CLI_SPR and at the
    end. The mined shards must be disjoint, both workers' merged DBs equal
    (their printed digests), and the parameter digests equal at every
    boundary. The synthetic drive is one sequence, so worker 1's shard is
    empty; two non-empty shards are `meanwhile`'s (the dry run), which
    runs while the workers do. Returns the workers' record and what
    `meanwhile()` returned."""
    log_dir = tmp / "liso_shared"
    argv = ["-c", "bev_100m_512", "centerpoint", "liso", "--world_size", "2",
            "--log_dir", str(log_dir)]
    for kv in P_CLI_KV:
        argv += ["-kv", *kv]
    t0 = time.perf_counter()
    procs = []
    for w in range(2):
        f = open(tmp / f"worker{w}.log", "w")
        procs.append((f, subprocess.Popen(
            [sys.executable, "-m", "liso_tpu_torch.cli.liso_cli", *argv,
             "--worker_id", str(w)],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, text=True)))
    try:
        t1 = time.perf_counter()
        beside = meanwhile()
        beside_s = time.perf_counter() - t1
        codes = [p.wait(timeout=P_CLI_TIMEOUT_S) for _, p in procs]
    finally:
        for f, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    wall_s = time.perf_counter() - t0
    logs = [(tmp / f"worker{w}.log").read_text() for w in range(2)]
    if codes != [0, 0]:
        fail(f"liso_cli workers exited {codes}: "
             + " | ".join(lg[-1500:] for lg in logs))
    from liso_tpu_torch.tracker.dbs import load_mined_boxes_db

    merged = [[ln.split("DB digest ")[1] for ln in lg.splitlines()
               if "DB digest" in ln] for lg in logs]
    rounds = sorted(int(p.name.split("_")[-1])
                    for p in log_dir.glob("mined_round_*"))
    shards = {}
    for r in rounds:
        dbs = [load_mined_boxes_db(
            log_dir / f"mined_round_{r}" / f"tracked_worker{w}.npz")
            for w in range(2)]
        shards[r] = {"samples": [len(db) for db in dbs],
                     "boxes": [sum(len(v["track_id"]) for v in db.values())
                               for db in dbs],
                     "disjoint": not set(dbs[0]) & set(dbs[1])}
    syncs = {}
    for d in sorted(log_dir.glob("param_sync_step_*")):
        digests = [(d / f"digest_worker{w}").read_text() for w in range(2)]
        syncs[int(d.name.split("_")[-1])] = digests[0] == digests[1]
    res = {"argv": argv, "wall_s": wall_s, "meanwhile_s": beside_s,
           "merged_db_digests": merged,
           "mined_rounds": rounds, "shards": shards,
           "param_digests_equal_at": syncs}
    want_rounds = list(range(0, P_CLI_STEPS, P_CLI_SPR))
    want_syncs = [s for s in (*want_rounds, P_CLI_STEPS) if s > 0]
    if rounds != list(range(len(want_rounds))):
        fail(f"liso_cli workers mined rounds {rounds}, expected "
             f"{list(range(len(want_rounds)))}")
    if not all(s["disjoint"] for s in shards.values()):
        fail(f"the workers' mined shards overlap: {shards}")
    if len(merged[0]) != len(want_rounds) or merged[0] != merged[1]:
        fail(f"the workers' merged DB digests differ: {merged}")
    if sorted(syncs) != want_syncs or not all(syncs.values()):
        fail(f"parameter digests {syncs}, expected equal at {want_syncs}")
    return res, beside


def phase_parallel(kernels):
    """Data parallel on the one card: (a) the SLIM step, (b) the
    CenterPoint step and (b') the TransFusion, PointPillars and PointRCNN
    steps with the global batch of P_WORLD split over P_WORLD gloo ranks,
    against the one-process step on the full batch; (c) one step of
    CenterPoint and of P_O_NCCL over an nccl group of one rank, bitwise
    equal to the step without a group; (d) two liso_cli workers over one
    log dir and, while they run, `dryrun_multichip(2)` on the card (two
    ranks' SLIM and detector steps, and two rounds-loop workers that each
    mine one sequence of a two-sequence drive)."""
    import tempfile

    import torch

    from liso_tpu_torch.parallel import mesh
    from liso_tpu_torch.parallel.dryrun import dryrun_multichip
    from liso_tpu_torch.train.detector_train import DetectorTrainer
    from liso_tpu_torch.train.liso_loop import cudnn_deterministic

    t_phase = time.perf_counter()
    parts = {}
    per_step = p_step_launches(kernels)
    slim_batch = p_slim_batch()
    det_batch, det_kw, ds_cfg = p_det_batch()
    torch.cuda.empty_cache()
    parts["batches"] = time.perf_counter() - t_phase
    res = {"phase": "parallel", "world": P_WORLD, "backend": "gloo",
           "slim": {"grid": T_GRID, "range_m": T_RANGE, "points": T_PTS,
                    "global_batch": P_WORLD, "dtype": "bf16",
                    "flags": "slim_liso"},
           "det": {"configs": "bev_100m_512 centerpoint liso", "grid": D_GRID,
                   "n_max": M_PTS, "global_batch": P_WORLD, "dtype": "fp32",
                   "target_boxes": int(det_batch[2].valid.sum()),
                   "cudnn_deterministic": True},
           **{net: {"configs": f"bev_100m_512 {net} liso", "grid": D_GRID,
                    "n_max": M_PTS, "global_batch": P_WORLD, "dtype": "fp32",
                    "cudnn_deterministic": True, "warmup_steps": 1,
                    "steps": P_O_STEPS} for net in P_OTHERS},
           "warmup_steps": P_WARMUP, "steps": P_STEPS,
           "tolerance": {"slim_loss_rtol": TRAIN_LOSS_RTOL,
                         "other_detectors_loss_rtol": P_O_LOSS_RTOL,
                         "slim_grad_norm_rtol": TRAIN_GRAD_NORM_RTOL,
                         "slim_bias_counter_rtol": P_BIAS_RTOL,
                         "slim_importance_cumsum_rel": P_CUMSUM_REL,
                         "det_loss_rtol": DET_LOSS_RTOL,
                         "det_grad_norm_rtol": DET_GRAD_NORM_RTOL,
                         "det_stats_rtol": P_STATS_RTOL}}
    with tempfile.TemporaryDirectory(prefix="parallel_", dir=OUT_DIR) as tmp:
        tmp = Path(tmp)
        # (a), (b): the ranks, then the one-process steps on the free card
        t0 = time.perf_counter()
        names = ("slim", "det", *P_OTHERS)
        ranks = mesh.RankProcesses(parallel_rank, P_WORLD,
                                   (slim_batch, det_batch, det_kw, ds_cfg),
                                   backend="gloo", workdir=tmp / "ranks",
                                   timeout_s=P_RANKS_TIMEOUT_S).join()
        res["ranks_wall_s"] = parts["ranks"] = time.perf_counter() - t0
        res["ranks_steps_s"] = [rk["steps_s"] for rk in ranks]
        res["ranks_parts_s"] = [{n: rk[n]["parts_s"] for n in names}
                                for rk in ranks]
        t0 = time.perf_counter()
        one = {}
        for name in names:
            slim, other = name == "slim", name in P_OTHERS
            with cudnn_deterministic(not slim):
                if slim:
                    trainer = p_slim_trainer(None)
                elif other:
                    trainer = p_other_trainer(name, ds_cfg, None)
                else:
                    trainer = DetectorTrainer(**det_kw, device="cuda")
                batch = mesh.map_tree(lambda t: t.cuda(),
                                      slim_batch if slim else det_batch)
                one[name] = p_first_step(trainer, batch, slim)
                one[name].update(p_timed_steps(
                    trainer, batch, slim, kernels,
                    *((1, P_O_STEPS) if other else ())))
            del trainer, batch
            torch.cuda.empty_cache()
        parts["one_process"] = time.perf_counter() - t0

        for name in names:
            r = res[name]
            r["one_process"] = {k: one[name][k] for k in (
                "metrics", "step_ms_median", "step_ms_max", "peak_memory_gb")}
            r["ranks"] = [{k: rk[name][k] for k in (
                "metrics", "step_ms_median", "step_ms_max", "step_ms",
                "launches", "collectives", "collective_ms_per_step",
                "peak_memory_gb")} for rk in ranks]
            want = one[name]["metrics"]
            for rk in ranks:
                got = rk[name]
                if got["metrics"] != ranks[0][name]["metrics"]:
                    fail(f"{name}: ranks disagree on the step's metrics")
                n_steps = P_O_STEPS if name in P_OTHERS else P_STEPS
                expect = {k: v * n_steps for k, v in per_step[name].items()}
                if got["launches"] != expect:
                    fail(f"{name} rank {rk['rank']}: launches {got['launches']}, "
                         f"expected {expect}")
            prof = ranks[0][name]["profiled"]
            r["profiled"] = prof
            if not any(p["launches"] == per_step[name] for p in prof):
                fail(f"{name}: rank 0's profiler saw {[p['launches'] for p in prof]}"
                     f", expected {per_step[name]}")
            got = ranks[0][name]
            if name == "slim":
                limits = {k: (TRAIN_GRAD_NORM_RTOL if k == "grad_norm"
                              else TRAIN_LOSS_RTOL) for k in want if k != "lr"}
            else:
                loss_rtol = P_O_LOSS_RTOL if name in P_OTHERS else DET_LOSS_RTOL
                limits = {k: (DET_GRAD_NORM_RTOL
                              if k in ("grad_norm", "update_grad_norm")
                              else loss_rtol) for k in want if k != "lr"}
            r["rel_vs_one_process"] = {k: p_rel(got["metrics"][k], want[k])
                                       for k in limits}
            bad = {k: v for k, v in r["rel_vs_one_process"].items()
                   if not v <= limits[k]}
            if got["metrics"]["lr"] != want["lr"]:
                bad["lr"] = (got["metrics"]["lr"], want["lr"])
            if name == "slim":
                r["bias_counter"] = (got["bias_counter"], one[name]["bias_counter"])
                c1, c0 = got["importance_cumsum"], one[name]["importance_cumsum"]
                r["importance_cumsum_rel"] = float((c1 - c0).norm() / c0.norm())
                if not p_rel(*r["bias_counter"]) <= P_BIAS_RTOL:
                    bad["bias_counter"] = r["bias_counter"]
                if not r["importance_cumsum_rel"] <= P_CUMSUM_REL:
                    bad["importance_cumsum"] = r["importance_cumsum_rel"]
            else:
                stats = {k: float((got["buffers"][k].double() - w.double()).norm()
                                  / w.double().norm().clamp(min=1e-30))
                         for k, w in one[name]["buffers"].items()}
                r["stats_rel_max"] = max(stats.values())
                if not r["stats_rel_max"] <= P_STATS_RTOL:
                    bad["bn_stats"] = r["stats_rel_max"]
            if bad:
                fail(f"{name}: the {P_WORLD}-rank step against the one-process "
                     f"step: {bad}")
        res["launches"] = {k: sum(rk[n]["launches"][k] for rk in ranks
                                  for n in names)
                           for k in kernels.launches}

        # (c) nccl over one rank: the same bits as the step without a group
        t0 = time.perf_counter()
        det_gpu = mesh.map_tree(lambda t: t.cuda(), det_batch)
        makers = {"det": lambda g: DetectorTrainer(**det_kw, group=g,
                                                   device="cuda"),
                  P_O_NCCL: lambda g: p_other_trainer(P_O_NCCL, ds_cfg, g)}
        states = {name: {} for name in makers}
        with cudnn_deterministic():
            group = mesh.make_mesh(1, 0, "nccl", tmp / "nccl")
            try:
                for name, make in makers.items():
                    for key, g in (("nccl", group), ("none", None)):
                        trainer = make(g)
                        m = trainer.train_step(*det_gpu)
                        states[name][key] = (
                            to_host(trainer.state_dict()),
                            {k: float(v) for k, v in m.items()})
                        del trainer
            finally:
                mesh.destroy_mesh()
        res["nccl_world_1"] = {}
        for name, st in states.items():
            diff = state_equal(st["nccl"][0], st["none"][0])
            res["nccl_world_1"][name] = {
                "state_differs_at": diff,
                "metrics_equal": st["nccl"][1] == st["none"][1]}
            if diff or st["nccl"][1] != st["none"][1]:
                fail(f"{name}: the nccl step of one rank differs from the "
                     f"step without a group: {res['nccl_world_1'][name]}")
        torch.cuda.empty_cache()
        parts["nccl"] = time.perf_counter() - t0

        # (d) two liso_cli workers over one log dir, the dry run meanwhile
        t0 = time.perf_counter()
        res["liso_cli"], res["dryrun_multichip"] = p_liso_cli_workers(
            tmp, lambda: dryrun_multichip(P_WORLD, device="cuda",
                                          workdir=tmp))
        parts["liso_cli_and_dryrun"] = time.perf_counter() - t0
    res["parts_s"] = parts
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------------------
# The reference-checkpoint RAFT
# ---------------------------------------------------------------------------
def rr_images(grid, seed):
    """Two pillar images [1, grid, grid, 64] of the train cell's extent
    (T_RANGE): a seeded PillarEncoder (eval mode) over the JAX train
    benchmark's cloud and the same cloud moved by (0.6, -0.4) m."""
    import numpy as np
    import torch

    from liso_tpu_torch.models.layers import init_weights
    from liso_tpu_torch.models.pillar_encoder import PillarEncoder
    from liso_tpu_torch.ops.bev import BevSetup

    bev = BevSetup((T_RANGE, T_RANGE), (grid, grid))
    enc = init_weights(PillarEncoder(bev, num_channels=64, device="cuda"),
                       seed).eval()
    rng = np.random.RandomState(seed)
    half = 0.5 * T_RANGE - 2.0
    p0 = rng.uniform(-half, half, (1, T_PTS, 4)).astype(np.float32)
    p1 = p0 + np.array([0.6, -0.4, 0.0, 0.0], np.float32)
    valid = torch.ones(1, T_PTS, dtype=torch.bool, device="cuda")
    with torch.no_grad():
        return [enc(torch.from_numpy(p).cuda(), valid)[0] for p in (p0, p1)]


def phase_reference_raft(kernels):
    """The reference layout of RAFT at full width: a random state_dict in
    the reference's layout through models/torch_compat.load_reference_raft
    at the train cell's grid (fp32, batch 1): K2 held to its plain version
    on the forward's own lookups; RR_CALLS timed forwards with the launch
    counts reset just before and read just after, one under the profiler;
    the forward against itself through the plain versions; and the card
    against the port on the CPU at grid RR_CPU_GRID."""
    import numpy as np
    import torch

    from liso_tpu_torch.models.raft import corr_channels
    from liso_tpu_torch.models.torch_compat import (
        load_reference_raft,
        random_reference_state_dict,
    )
    from liso_tpu_torch.train.slim_train import fp32_precision

    t_phase = time.perf_counter()
    zero = {k: 0 for k in kernels.launches}
    per_call = {**zero, "corr_window_fwd": RR_ITERS}
    res_m = T_RANGE / T_GRID
    n_corr = corr_channels((T_GRID, T_GRID))
    if corr_channels((RR_CPU_GRID, RR_CPU_GRID)) != n_corr:
        fail("the CPU grid's corr pyramid has other levels than the card's")
    sd = random_reference_state_dict(0, n_corr)
    res = {"phase": "reference_raft", "grid": T_GRID, "range_m": T_RANGE,
           "batch": 1, "iters": RR_ITERS, "dtype": "fp32 (TF32 off)",
           "pillar_channels": 64, "state_dict_tensors": len(sd),
           "state_dict_values": int(sum(v.size for v in sd.values())),
           "warmup_calls": RR_WARMUP, "calls": RR_CALLS,
           "tolerance": {"flow_m": FLOW_ATOL, "logits": RR_LOGIT_ATOL,
                         "cpu_flow_m": RR_CPU_FLOW_ATOL,
                         "cpu_logits": RR_CPU_LOGIT_ATOL}}
    with fp32_precision(), torch.no_grad():
        t0 = time.perf_counter()
        net = load_reference_raft(sd, (T_GRID, T_GRID), num_iters=RR_ITERS,
                                  resolution_m=res_m, device="cuda")
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t0
        img0, img1 = rr_images(T_GRID, 0)
        for _ in range(RR_WARMUP):
            net(img0, img1)
        torch.cuda.synchronize()
        kernels.reset_launches()
        ms = []
        for _ in range(RR_CALLS):
            t0 = time.perf_counter()
            out = net(img0, img1)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels.launches)
        if launches != {k: v * RR_CALLS for k, v in per_call.items()}:
            fail(f"reference RAFT forward launches {launches}")
        if tuple(out.shape) != (RR_ITERS, 1, T_GRID, T_GRID, 9) or not bool(
                torch.isfinite(out).all()):
            fail(f"reference RAFT output {tuple(out.shape)} or not finite")
        counts, dev_ms, rows, _ = confirm_launches(
            lambda: net(img0, img1), per_call, "a reference RAFT forward")
        med = statistics.median(ms)
        res.update({"forward_ms_median": med, "forward_ms_max": max(ms),
                    "forward_ms": ms, "launches": launches,
                    "profiled": {"launches": counts, "device_ms": dev_ms,
                                 "device_busy_share": dev_ms / med,
                                 "device_ms_by_family": families(rows)},
                    "flow_abs_max_m": float(out[-1, ..., 4:6].abs().max())})
        # the forward through the plain versions
        with kernels.plain_versions():
            ref = net(img0, img1)
        diffs = {"flow_m": float((out[..., 4:8] - ref[..., 4:8]).abs().max()),
                 "logits": float((out[..., :4] - ref[..., :4]).abs().max()),
                 "weight_logit": float((out[..., 8:] - ref[..., 8:]).abs().max())}
        res["kernel_vs_plain"] = diffs
        if not (diffs["flow_m"] <= FLOW_ATOL
                and max(diffs["logits"], diffs["weight_logit"]) <= RR_LOGIT_ATOL):
            fail(f"reference RAFT, kernels vs plain: {diffs}")
        # K2 on this forward's own lookups
        k2 = k2_lookups_layout(corr_lookups(
            lambda: net(img0, img1), RR_ITERS, "a reference RAFT forward"),
            "the reference RAFT forward")
        del out, ref
        # the card against the port on the CPU at RR_CPU_GRID
        small = [im.cpu() for im in rr_images(RR_CPU_GRID, 1)]
        outs = {}
        for dev in ("cuda", "cpu"):
            n = load_reference_raft(sd, (RR_CPU_GRID, RR_CPU_GRID),
                                    num_iters=RR_ITERS, resolution_m=T_RANGE
                                    / RR_CPU_GRID, device=dev)
            t0 = time.perf_counter()
            outs[dev] = n(*(im.to(dev) for im in small)).cpu()
            res[f"grid_{RR_CPU_GRID}_{dev}_forward_ms"] = (
                time.perf_counter() - t0) * 1e3
        a, b = outs["cuda"], outs["cpu"]
        cpu_diffs = {"flow_m": float((a[..., 4:8] - b[..., 4:8]).abs().max()),
                     "logits": float((a[..., :4] - b[..., :4]).abs().max()),
                     "weight_logit": float((a[..., 8:] - b[..., 8:]).abs().max()),
                     "flow_abs_max_m": float(b[..., 4:6].abs().max())}
        res["card_vs_cpu"] = cpu_diffs
        if not (np.isfinite(list(cpu_diffs.values())).all()
                and cpu_diffs["flow_m"] <= RR_CPU_FLOW_ATOL
                and max(cpu_diffs["logits"], cpu_diffs["weight_logit"])
                <= RR_CPU_LOGIT_ATOL):
            fail(f"reference RAFT at grid {RR_CPU_GRID}, card vs CPU: "
                 f"{cpu_diffs}")
    del net
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    return k2, res


# ---------------------------------------------------------------------------
# The ETL
# ---------------------------------------------------------------------------
def etl_oxts_line(tx: float, lat0: float = 49.011) -> str:
    """One OXTS packet (30 fields) of a pose moved by `tx` m along x at
    constant latitude: the inverse of create_kitti.oxts_to_pose's
    mercator."""
    import numpy as np

    scale = np.cos(lat0 * np.pi / 180.0)
    lon = tx * 180.0 / (np.pi * 6378137.0 * scale)
    head = [lat0, lon, 112.8, 0.0, 0.0, 0.0]
    tail = [10.0 * ETL_EGO_M, 0.0, 0.0] + [0.0] * 17 + [4, 4, 6, 6]
    return " ".join(f"{v:.12f}" for v in head + tail)


def etl_static_scene(rng, n: int, extent: float = 45.0):
    """`n` static points [n, 4] (x, y, z, intensity) of a street scene in
    the world frame, the sensor 1.73 m above the ground: half on the ground
    plane, 35% on the walls of 16 buildings (rectangles of random size and
    heading beside the road), the rest on 120 poles of 0.15 m radius off
    the road; in random order."""
    import numpy as np

    n_ground, n_walls = n // 2, (7 * n) // 20
    n_poles = n - n_ground - n_walls
    ground = np.stack([rng.uniform(-extent, extent, n_ground),
                       rng.uniform(-extent, extent, n_ground),
                       rng.normal(-1.73, 0.02, n_ground)], -1)
    nb = 16
    cx = rng.uniform(-extent + 10, extent - 10, nb)
    cy = rng.choice([-1, 1], nb) * rng.uniform(10, extent - 10, nb)
    length, width = rng.uniform(6, 20, nb), rng.uniform(6, 14, nb)
    height, yaw = rng.uniform(3, 10, nb), rng.uniform(-np.pi, np.pi, nb)
    b, face = rng.integers(0, nb, n_walls), rng.integers(0, 4, n_walls)
    u = rng.uniform(-0.5, 0.5, n_walls)
    lx = np.where(face < 2, u * length[b],
                  np.where(face == 2, 0.5, -0.5) * length[b])
    ly = np.where(face < 2, np.where(face == 0, 0.5, -0.5) * width[b],
                  u * width[b])
    c, s = np.cos(yaw[b]), np.sin(yaw[b])
    walls = np.stack([cx[b] + c * lx - s * ly, cy[b] + s * lx + c * ly,
                      -1.73 + rng.uniform(0, 1, n_walls) * height[b]], -1)
    px, py = rng.uniform(-extent, extent, (2, 120))
    px, py = px[np.abs(py) > 4], py[np.abs(py) > 4]
    k, a = rng.integers(0, len(px), n_poles), rng.uniform(0, 2 * np.pi, n_poles)
    poles = np.stack([px[k] + 0.15 * np.cos(a), py[k] + 0.15 * np.sin(a),
                      -1.73 + rng.uniform(0, 4, n_poles)], -1)
    pts = np.concatenate([ground, walls, poles])[rng.permutation(n)]
    return np.concatenate([pts, rng.uniform(0, 1, (n, 1))], -1)


def etl_write_drive(root: Path) -> int:
    """A KITTI-raw drive under `root` (2011_09_26/2011_09_26_drive_0001_sync):
    each frame's points (etl_static_scene and data/synthetic.py's moving
    objects and ego poses) in the sensor frame as velodyne .bin (float32 x,
    y, z, intensity), its OXTS packet, and the identity IMU-to-velo
    calibration. Returns the points written per frame."""
    import numpy as np

    from liso_tpu_torch.data.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=ETL_FRAMES, n_bg=0,
                            ego_speed=ETL_EGO_M, seed=3)
    static = etl_static_scene(np.random.default_rng(3), ETL_BG)
    date = root / "2011_09_26"
    drive = date / "2011_09_26_drive_0001_sync"
    (drive / "velodyne_points" / "data").mkdir(parents=True)
    (drive / "oxts" / "data").mkdir(parents=True)
    (date / "calib_imu_to_velo.txt").write_text(
        "R: 1 0 0 0 1 0 0 0 1\nT: 0 0 0\n")
    for t in range(ETL_FRAMES):
        pts = np.concatenate([static, seq.frame_world(t)[0]])
        s_T_w = np.linalg.inv(seq.world_T_sensor(t))
        xyz = pts[:, :3] @ s_T_w[:3, :3].T + s_T_w[:3, 3]
        np.concatenate([xyz, pts[:, 3:]], -1).astype(np.float32).tofile(
            drive / "velodyne_points" / "data" / f"{t:010d}.bin")
        (drive / "oxts" / "data" / f"{t:010d}.txt").write_text(
            etl_oxts_line(seq.world_T_sensor(t)[0, 3]) + "\n")
    return len(pts)


def phase_etl(kernels):
    """The port's ETL on the host, then the card: a KITTI-raw drive
    written from the synthetic scene, converted by `python -m
    liso_tpu_torch.data.create_kitti --use_icp` (in this process), read by
    KittiRawDataset at the `bev_100m_512 centerpoint liso` DataCfg, and
    the detector's predict_step on the card over every frame read, K1 held
    bitwise and timed at their cells, the kept boxes against the plain
    run's."""
    import tempfile

    import numpy as np
    import torch

    from liso_tpu_torch.cli.common import DEFAULT_CFG
    from liso_tpu_torch.cli.slim_cli import build_datasets
    from liso_tpu_torch.data import create_kitti
    from liso_tpu_torch.data.kitti import KittiRawDataset
    from liso_tpu_torch.models.pillar_encoder import prepare_pillar_inputs
    from liso_tpu_torch.train import liso_loop
    from liso_tpu_torch.utils.config import parse_config

    t_phase = time.perf_counter()
    zero = {k: 0 for k in kernels.launches}
    res = {"phase": "etl", "frames": ETL_FRAMES,
           "configs": "bev_100m_512 centerpoint liso",
           "tolerance": {"odom_m": ETL_ODOM_ATOL, "icp_m": ETL_ICP_ATOL,
                         "boxes": DET_BOX_ATOL}}
    with tempfile.TemporaryDirectory(prefix="etl_", dir=OUT_DIR) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        res["points_per_frame"] = etl_write_drive(tmp / "raw")
        res["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        create_kitti.main(["--kitti_raw_root", str(tmp / "raw"),
                           "--target_dir", str(tmp / "out"), "--use_icp"])
        res["convert_s"] = time.perf_counter() - t0
        files = sorted((tmp / "out" / "kitti_raw").glob("*.npy"))
        res["samples_written"] = len(files)
        if len(files) != ETL_FRAMES - 2:
            fail(f"create_kitti wrote {len(files)} samples, expected "
                 f"{ETL_FRAMES - 2}")
        odom, icp = [], []
        for f in files:
            d = np.load(f, allow_pickle=True).item()
            odom.append(float(np.abs(d["odom_t0_t1"][:3, 3]
                                     - [ETL_EGO_M, 0, 0]).max()))
            icp.append(float(np.abs(d["kiss_odom_t0_t1"][:3, 3]
                                    - [ETL_EGO_M, 0, 0]).max()))
        res["odom_err_m"], res["icp_err_m"] = max(odom), max(icp)
        if not (max(odom) <= ETL_ODOM_ATOL and max(icp) <= ETL_ICP_ATOL):
            fail(f"ETL odometry off the planted motion: GPS {odom}, ICP {icp}")

        cfg = parse_config(DEFAULT_CFG, ["bev_100m_512", "centerpoint", "liso"])
        ds_cfg = build_datasets(cfg, False, target="object")[0].cfg
        t0 = time.perf_counter()
        ds = KittiRawDataset(ds_cfg, tmp / "out")
        samples = [ds[i] for i in range(len(ds))]
        res["read_s"] = time.perf_counter() - t0
        pts = torch.from_numpy(np.stack([s.frame_t0.pcl for s in samples])).cuda()
        valid = torch.from_numpy(np.stack([s.frame_t0.valid
                                           for s in samples])).cuda()
        res["valid_points"] = valid.sum(-1).tolist()
        loop = liso_loop.LisoSelfTraining(cfg, lambda db: None, None,
                                          tmp / "loop", data_cfg=ds_cfg,
                                          device="cuda")
        trainer, bev = loop.trainer, loop.bev
        cells = prepare_pillar_inputs(pts, valid, bev).cell
        k1 = check_scatter_max(torch.Generator(device="cuda").manual_seed(31),
                               cells, bev.num_cells, 64, torch.float32)
        trainer.predict_step(pts, valid)
        torch.cuda.synchronize()
        kernels.reset_launches()
        ms = []
        for _ in range(DT_PREDICTS):
            t0 = time.perf_counter()
            boxes = trainer.predict_step(pts, valid)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels.launches)
        n_bn = eval_norms(trainer.model)
        if launches != {**zero, "grid_scatter_max_occ": DT_PREDICTS,
                        "bn_relu_eval": n_bn * DT_PREDICTS}:
            fail(f"ETL predict_step launches {launches}")
        counts, dev_ms, _, _ = confirm_launches(
            lambda: trainer.predict_step(pts, valid),
            {**zero, "grid_scatter_max_occ": 1, "bn_relu_eval": n_bn},
            "an ETL predict_step")
        with kernels.plain_versions():
            ref = trainer.predict_step(pts, valid)
        fields = ("pos", "dims", "rot", "probs")
        diff = max(float((getattr(boxes, f) - getattr(ref, f)).abs().max())
                   for f in fields)
        if (not torch.equal(boxes.valid, ref.valid) or not diff <= DET_BOX_ATOL
                or not all(bool(torch.isfinite(getattr(boxes, f)).all())
                           for f in fields)):
            fail(f"ETL predict_step kept boxes differ from the plain run's "
                 f"(max abs diff {diff})")
        med = statistics.median(ms)
        res.update({"batch": len(samples), "predict_ms_median": med,
                    "predict_ms_max": max(ms), "launches": launches,
                    "predict_kept": boxes.valid.sum(-1).tolist(),
                    "predict_max_abs_diff_vs_plain": diff,
                    "profiled": {"launches": counts, "device_ms": dev_ms,
                                 "device_busy_share": dev_ms / med}})
        del loop, trainer, boxes, ref
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    return [k1], res


def run_path(serve, slim, det, frames, valid):
    """fused_forward, then encode + chained fused_streaming steps."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow_ff, pos_ff, probs_ff = serve.fused_forward(
        slim, det, frames[0], valid, frames[1], valid
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fmap, cn = serve.encode(slim, frames[0], valid)
    torch.cuda.synchronize()
    step_ms = []
    for pts in frames[1:]:  # each frame's result is awaited, as a server does
        t2 = time.perf_counter()
        fmap, cn, flow, pos, probs = serve.fused_streaming(
            slim, det, fmap, cn, pts, valid
        )
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t2) * 1e3)
    return {
        "fused_forward_ms": (t1 - t0) * 1e3,
        "streaming_ms_per_step": statistics.mean(step_ms),
        "streaming_step_ms_median": statistics.median(step_ms),
        "streaming_step_ms_max": max(step_ms),
        "outputs": (flow_ff, probs_ff, flow, pos, probs),
    }


def profile_window(fn, host=False):
    """Run `fn` once under torch.profiler. Returns the launches of each
    kernel seen by the profiler, the device time (sum over device kernels,
    ms), the device time by kernel name and, with `host`, the host time by
    operator (self CPU us, with the profiler's own cost in it; else an
    empty list). Without `host` the profiler records the device activity
    alone, which takes it less than half the time to process (a SLIM train
    step: 4.0-4.4 s against 10.7-11.6 s on an H100, the same launches and
    device time). Its wall time, the processing included, adds to
    PROFILER_S."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    from liso_tpu_torch import kernels

    counts = {k: 0 for k in kernels.launches}
    device_us = 0.0
    rows, host_rows = [], []
    for ev in prof.key_averages():
        if host and ev.self_cpu_time_total > 0:
            host_rows.append((ev.self_cpu_time_total, ev.count, ev.key))
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type.name == "CUDA" or (dev_us and ev.self_cpu_time_total == 0):
            device_us += dev_us
            rows.append((dev_us, ev.count, ev.key))
        for k in counts:
            if f"{k}_kernel" in ev.key:
                counts[k] += ev.count
    rows.sort(reverse=True)
    host_rows.sort(reverse=True)
    PROFILER_S["profile_window"] += time.perf_counter() - t0
    return counts, device_us / 1e3, rows, host_rows


def main() -> int:
    if not (ROOT / "liso_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the liso_tpu_torch package is not beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from liso_tpu_torch import kernels, serve

    torch.backends.cuda.matmul.allow_tf32 = False  # K2's plain version: fp32
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    t_start = time.perf_counter()
    smi = nvidia_smi()
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    emit({"phase": "device", **device, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    build_s = kernels.build()
    ptxas = {
        n: [ln.strip() for ln in kernels.ptxas_report(n).splitlines()
            if "registers" in ln or "spill" in ln]
        for n in kernels.SOURCES
    }
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    kres = phase_kernels()
    for r in kres:
        emit({"phase": "kernel", **r})

    bev, slim, det = serve.build_models(
        grid=GRID, num_iters=ITERS, compute_dtype=torch.bfloat16, seed=0,
        device="cuda",
    )
    frames, valid = clouds(2, STEPS + 1)
    run_path(serve, slim, det, frames[:3], valid)  # warm-up, not counted
    kernels.reset_launches()
    res = run_path(serve, slim, det, frames, valid)
    launches = dict(kernels.launches)
    n_det = eval_norms(det)
    expect = {
        **{k: 0 for k in launches},
        # fused_forward: 2 SLIM frames + 1 detector frame; encode: 1;
        # each streaming step: 1 fused scatter. K2: 6 per flow pass. Eval
        # BN + ReLU: a SLIM frame's 1, a detector frame's n_det.
        "grid_scatter_max_occ": 3 + 1 + STEPS,
        "corr_window_fwd": ITERS * (1 + STEPS),
        "bn_relu_eval": 2 + n_det + 1 + STEPS * (1 + n_det),
    }
    if launches != expect:
        fail(f"kernel launches on the main path {launches}, expected {expect}")
    flow_ff, probs_ff, flow, pos, probs = res.pop("outputs")
    shapes = {
        "flow": (flow, (BATCH, GRID, GRID, 2)),
        "pos": (pos, (BATCH, (GRID // 4) ** 2, 3)),
        "probs": (probs, (BATCH, (GRID // 4) ** 2, 1)),
        "fused_forward_flow": (flow_ff, (BATCH, GRID, GRID, 2)),
    }
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            fail(f"{name}: shape {tuple(x.shape)} (want {shape}) or not finite")

    fmap, cn = serve.encode(slim, frames[0], valid)
    zero = {k: 0 for k in kernels.launches}
    profiles = {
        "fused_forward": confirm_launches(
            lambda: serve.fused_forward(slim, det, frames[0], valid, frames[1],
                                        valid),
            {**zero, "grid_scatter_max_occ": 3, "corr_window_fwd": ITERS,
             "bn_relu_eval": 2 + n_det},
            "fused_forward"),
        "fused_streaming": confirm_launches(
            lambda: serve.fused_streaming(slim, det, fmap, cn, frames[1], valid),
            {**zero, "grid_scatter_max_occ": 1, "corr_window_fwd": ITERS,
             "bn_relu_eval": 1 + n_det},
            "fused_streaming"),
    }
    # busy share: the profiled call's device time over the host time of the
    # same call with the profiler off (the profiler's own host cost varies
    # from run to run)
    host_ms = {"fused_forward": res["fused_forward_ms"],
               "fused_streaming": res["streaming_step_ms_median"]}
    profiled = {
        name: {"launches": counts, "device_ms": dev_ms,
               "host_ms_unprofiled": host_ms[name],
               "device_busy_share": dev_ms / host_ms[name],
               "searchsorted": searchsorted_stats(rows)}
        for name, (counts, dev_ms, rows, _) in profiles.items()
    }

    fmap1, _ = serve.encode(slim, frames[1], valid)

    def flow_stage():  # eager: a replayed graph calls no wrapper
        with torch.inference_mode():
            slim.flow_from_features(fmap, cn, fmap1)

    k2_step = k2_lookups_layout(corr_lookups(
        flow_stage, ITERS, "a streaming step's flow stage"),
        "the streaming step")
    with kernels.plain_versions():
        ref = run_path(serve, slim, det, frames, valid)
    r_flow_ff, r_probs_ff, r_flow, _, r_probs = ref.pop("outputs")
    diffs = {
        "fused_forward_flow": float((flow_ff - r_flow_ff).abs().max()),
        "fused_forward_probs": float((probs_ff - r_probs_ff).abs().max()),
        "streaming_flow": float((flow - r_flow).abs().max()),
        "streaming_probs": float((probs - r_probs).abs().max()),
    }
    path = {
        "phase": "path",
        "grid": GRID, "points": N_PTS, "batch": BATCH, "iters": ITERS,
        "steps": STEPS, "dtype": "bf16",
        "launches": launches,
        "profiled": profiled,
        **res,
        "frames_per_s": BATCH / (res["streaming_ms_per_step"] / 1e3),
        "plain": ref,
        "max_abs_diff_vs_plain": diffs,
        "flow_abs_max": float(flow.abs().max()),
        "tolerance": {"flow_m": FLOW_ATOL, "probs": PROBS_ATOL},
    }
    emit(path)
    if max(diffs["fused_forward_flow"], diffs["streaming_flow"]) > FLOW_ATOL:
        fail(f"flow of the kernel path vs the plain path: {diffs}")
    if max(diffs["fused_forward_probs"], diffs["streaming_probs"]) > PROBS_ATOL:
        fail(f"box probs of the kernel path vs the plain path: {diffs}")

    del slim, det, frames, ref
    torch.cuda.empty_cache()
    tkres, train, (train_rows, train_host_rows) = phase_train(kernels)
    emit(train)
    for r in tkres:
        emit({"phase": "kernel", "path": "train", **r})
    by_name = {r["name"]: r for r in kres}
    by_name["corr_window_fwd"]["serving_step_layout"] = k2_step
    for r in tkres:  # K1 at the train step's shape goes beside its serving entry
        if r["name"] in by_name:
            by_name[r["name"]]["train_shape"] = shape_entry(r)
        else:
            kres.append(r)
    torch.cuda.empty_cache()
    # back to PyTorch's default (cuDNN may take TF32 for fp32 convolutions):
    # DetectorTrainer turns TF32 off itself while a step runs
    torch.backends.cudnn.allow_tf32 = True
    dkres, detect, (det_rows, det_host_rows, pred_rows) = phase_detect_train(kernels)
    emit(detect)
    for r in dkres:
        emit({"phase": "kernel", "path": "detect_train", **r})
    by_name = {r["name"]: r for r in kres}
    for r in dkres:
        by_name[r["name"]]["detect_train_shape"] = shape_entry(r)
    torch.cuda.empty_cache()
    ekres, experiment = phase_slim_experiment(kernels)
    emit({**experiment, "nvidia_smi": smi})
    for r in ekres:
        emit({"phase": "kernel", "path": "slim_experiment", **r})
        by_name[r["name"]]["slim_experiment_shape"] = shape_entry(r)
    torch.cuda.empty_cache()
    mkres, mining, handoff = phase_mining(kernels)
    emit({**mining, "nvidia_smi": smi})
    for r in mkres:
        emit({"phase": "kernel", "path": "mine", **r})
        by_name[r["name"]]["mine_shape"] = shape_entry(r)
    torch.cuda.empty_cache()
    vkres, evaluation = phase_eval(kernels, handoff)
    del handoff
    emit({**evaluation, "nvidia_smi": smi})
    for r in vkres:
        emit({"phase": "kernel", "path": "eval", **r})
        by_name[r["name"]]["eval_shape"] = shape_entry(r)
    torch.cuda.empty_cache()
    rkres, rounds = phase_rounds(kernels)
    emit({**rounds, "nvidia_smi": smi})
    for r in rkres:
        emit({"phase": "kernel", "path": "rounds", **r})
        by_name[r["name"]]["rounds_shape"] = shape_entry(r)
    torch.cuda.empty_cache()
    dtkres, detectors = phase_detectors(kernels)
    emit({**{k: v for k, v in detectors.items() if k != "configs"},
          "nvidia_smi": smi})
    for r in dtkres:
        emit({"phase": "kernel", "path": "detectors", **r})
        by_name[r["name"]]["detectors_shape"] = shape_entry(r)
    torch.cuda.empty_cache()
    rr_k2, reference_raft = phase_reference_raft(kernels)
    emit({**reference_raft, "nvidia_smi": smi})
    emit({"phase": "kernel", "path": "reference_raft", "name": "corr_window_fwd",
          **rr_k2})
    by_name["corr_window_fwd"]["reference_raft_shape"] = rr_k2
    etl_kres, etl = phase_etl(kernels)
    emit({**etl, "nvidia_smi": smi})
    for r in etl_kres:
        emit({"phase": "kernel", "path": "etl", **r})
        by_name[r["name"]]["etl_shape"] = shape_entry(r)
    torch.cuda.empty_cache()
    parallel = phase_parallel(kernels)
    emit({**parallel, "nvidia_smi": smi})
    for r in kres:
        name = r["name"]
        r["launches_by_path"] = {
            "serve": launches[name], "train": train["launches"][name],
            "detect_train": detect["launches"][name],
            "slim_experiment": (experiment["launches"][name]
                                + experiment["eval_launches"][name]
                                + experiment["export_launches"][name]),
            "mine": (mining["round0"]["launches"][name]
                     + mining["round1"]["launches"][name]),
            "eval": evaluation["launches"][name],
            "rounds": rounds["launches"][name],
            "detectors": detectors["launches"][name],
            "reference_raft": reference_raft["launches"][name],
            "etl": etl["launches"][name],
            "parallel": parallel["launches"][name]}
        r["launches"] = sum(r["launches_by_path"].values())
    with open(OUT_DIR / "chip_smoke.json", "w") as f:
        json.dump({"device": device, "nvidia_smi": smi, "kernels": kres,
                   "detect_train_kernels": dkres, "path": path,
                   "train": train, "detect_train": detect,
                   "slim_experiment_kernels": ekres,
                   "slim_experiment": experiment,
                   "mining_kernels": mkres, "mining": mining,
                   "eval_kernels": vkres, "eval": evaluation,
                   "rounds_kernels": rkres, "rounds": rounds,
                   "detectors_kernels": dtkres, "detectors": detectors,
                   "reference_raft_k2": rr_k2,
                   "reference_raft": reference_raft,
                   "etl_kernels": etl_kres, "etl": etl,
                   "parallel": parallel,
                   "ptxas": ptxas,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    with open(OUT_DIR / "chip_smoke_profile.txt", "w") as f:
        for name, (_, dev_ms, rows, _) in profiles.items():
            f.write(f"# {smi}; one {name} call: device {dev_ms:.3f} ms, "
                    f"host {host_ms[name]:.3f} ms (profiler off)\n")
            f.write("# device_us count kernel\n")
            for us, count, key in rows:
                f.write(f"{us:.1f}\t{count}\t{key}\n")
        f.write(f"# {smi}; one SLIM train step: device "
                f"{train['profiled_step']['device_ms']:.3f} ms, host "
                f"{train['step_ms_median']:.3f} ms (median, profiler off)\n")
        f.write("# device_us count kernel\n")
        for us, count, key in train_rows:
            f.write(f"{us:.1f}\t{count}\t{key}\n")
        f.write("# the same step on the host: self_cpu_us count operator "
                "(profiler on)\n")
        for us, count, key in train_host_rows[:40]:
            f.write(f"{us:.1f}\t{count}\t{key}\n")
        f.write(f"# {smi}; one detector train step: device "
                f"{detect['profiled_step']['device_ms']:.3f} ms, host "
                f"{detect['step_ms_median']:.3f} ms (median, profiler off)\n")
        f.write("# device_us count kernel\n")
        for us, count, key in det_rows:
            f.write(f"{us:.1f}\t{count}\t{key}\n")
        f.write("# the same step on the host: self_cpu_us count operator "
                "(profiler on)\n")
        for us, count, key in det_host_rows[:40]:
            f.write(f"{us:.1f}\t{count}\t{key}\n")
        f.write(f"# {smi}; one detector predict_step: device "
                f"{detect['predict_profiled']['device_ms']:.3f} ms, host "
                f"{detect['predict_ms_median']:.3f} ms (median, profiler off)\n")
        f.write("# device_us count kernel\n")
        for us, count, key in pred_rows:
            f.write(f"{us:.1f}\t{count}\t{key}\n")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "kernel_only_ms", "host_ms",
            "library_ms_prezeroed", "train_shape", "detect_train_shape",
            "slim_experiment_shape", "mine_shape", "eval_shape", "rounds_shape",
            "detectors_shape", "reference_raft_shape", "etl_shape",
            "second_shape", "decoder_shape", "host_steps_ms",
            "skewed_layout", "slim_step_layout", "serving_step_layout",
            "needed_pairs", "visited_pairs", "visited_over_needed",
            "band_bound_ms", "band_agreement", "nchw_shape", "pfn_shape")
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start,
          "slim_experiment_s": experiment["phase_s"],
          "mining_s": mining["phase_s"], "eval_s": evaluation["phase_s"],
          "rounds_s": rounds["phase_s"], "detectors_s": detectors["phase_s"],
          "reference_raft_s": reference_raft["phase_s"],
          "etl_s": etl["phase_s"],
          "parallel_s": parallel["phase_s"], "profiler_s": PROFILER_S,
          "nvidia_smi": smi})
    emit({"kernels": [{k: r[k] for k in keys if k in r} for r in kres]})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


def run() -> int:
    """main(), with any exception first named on stdout (the innermost
    frame of this script it passed through) and then raised as it was."""
    try:
        return main()
    except Exception as e:
        here = [f for f in traceback.extract_tb(e.__traceback__)
                if f.filename == __file__] or traceback.extract_tb(e.__traceback__)
        emit({"phase": "failed", "check": f"{here[-1].name}:{here[-1].lineno}",
              "message": f"{type(e).__name__}: {e}"})
        raise


if __name__ == "__main__":
    sys.exit(run())
