#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (fisher_nerf_customized_tpu_torch)
on one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, one line each, with its own seconds (phase_s, since the line
before it) and the seconds since the start (at_s):
  build            compile every CUDA kernel (csrc/*.cu, one nvcc per
                   source, all in parallel) and print ptxas' register use;
  episode          the main path, first in the process: the port's entry
                   point (cli.run_scene, as `python -m
                   fisher_nerf_customized_tpu_torch` runs it) drives one
                   FisherRF episode of ActiveMapper at the full width of
                   configs/mp3d_gaussian_FR_eccv.yaml on FakeSim
                   fake_apartment_0 (3x3 rooms, 256x256 RGB-D) for 100
                   steps: the 9-step init scan, mapping events every 10
                   steps (K1, K2), occupancy, and planning events (H_train
                   and 256 candidates by EIG with K3 11-wide, the sweep
                   field, the action compiler, path EIG over 20 paths with
                   K3 20-wide).  The launch counts are zeroed just before
                   and read just after: every kernel, K3's 20-wide variant
                   counted apart, must be launched, and at least 2
                   planning events must run.  After the loop the entry
                   point evaluates the map over 2000 held-out poses (K1 at
                   each), and the reconstruction metric runs at steps 0,
                   25, 50, 75 and the end against the scene's 1.2 M-point
                   ground-truth cloud.  Prints the wall time, steps per
                   second, the per-phase timer, coverage_2d_pct and
                   done_reason;
  pipelined_episode the same episode with tpu.pipeline_planning through
                   the entry point, 100 steps, no evaluation: stage-1
                   preparations at the queue's watermark and FakeSim's
                   prefetch.  Launch counts zeroed just before and read
                   just after: K1, K2, K3 (both widths) and the 1-NN must
                   run.  Prints the wall time and the planning,
                   plan.global, plan.global.wait, prefetch, sim_step and
                   tracking_mapping seconds beside the episode's (and its
                   wall less its eval), the preparations made, consumed
                   and dropped as stale, the prefetched frames taken and
                   the coverage; fails unless a preparation and a
                   prefetched frame were taken and a prefetched frame
                   equals a plain FakeSim's step at the same pose (four
                   actions, to the bit);
  eval             the episode's evaluation: PSNR, SSIM, lpips_proxy,
                   depth MAE (all poses and seen poses), the recon metrics
                   and AUC, the recon updates' seconds split into their
                   sub-phases (new points, upload, the 1-NN call, the row
                   download, the float64 recompute, the host surface
                   distances, the running minimum; the 1-NN call must have
                   run), the eval's wall time and K1 launches (>= 2000),
                   every metric finite, every pose's SSIM in [-1, 1.001],
                   the completeness ratio never falling between recon
                   points, the final recon equal to the one-shot metric on
                   the final cloud (rtol 1e-9);
  eval_check       the eval's first chunk of 32 poses again: its metrics
                   with K1 against those with K1's plain twin on the card
                   (rtol 1e-4), the batched ground-truth raycast against
                   per-pose raycasts (to the bit), lpips_proxy on the card
                   against the CPU (rtol 1e-5: its convolutions in f32);
  resume           a fresh ActiveMapper resumes the episode's checkpoint:
                   n_active, the keyframes, the occupancy map, the cloud's
                   size, the queue and the four generator states equal the
                   episode's; then 10 more steps with one mapping event,
                   its losses finite;
  tie_cut          on the episode's final map, at each keyframe pose, the
                   tile rows of the render's binning whose K cut falls
                   inside a depth tie, at the coarse and the fine level
                   (reported only);
  object_episode   the object branch's path through the entry point
                   (cli.run_scene, as `python -m
                   fisher_nerf_customized_tpu_torch --object_scene
                   --dynamic_scene` runs it) at the same width on FakeSim
                   fake_apartment_5, its object in view from step 0 and
                   random-walking, 40 steps, no evaluation: masked object
                   mapping events (K1, K2) and object planning events
                   (Hutchinson through the probe-batched K2, 256
                   candidates, criterion fisher).  Launch counts zeroed
                   just before and read just after: K1, K2 and the
                   probe-batched K2 must be launched.  It fails unless
                   the object was detected and mapped (>= 3 events), an
                   object planning event ran, the object map is not empty,
                   its Gaussians' median xz distance to the object is
                   under 1.2 m and the object curve is finite and never
                   falls; prints the wall time, the object_tracking,
                   obj_recon_metric and object planning times;
  object_check     on the object episode's final object map: the
                   Hutchinson diagonals of a pose chunk (8 keyframes, 8
                   probes) and one pose's 11 x 11 blocks through the
                   probe-batched K2 against K2's plain twin on the card
                   (rtol 1e-4), each probe's rows against a lone K2 launch
                   (to the bit), the probe-batched K2 against its twin and
                   timed at that chunk with its live-pair bound; the
                   object pose scores of 16 candidates under fisher, topt
                   and dopt and the last object planning event's path
                   scores on the card against the CPU's plain twins from
                   the same probes (same argmax, Spearman >= 0.99);
  recon_check      the reconstruction metric with its nearest neighbours
                   from the 1-NN kernel (engine/eval.py::_nn_dists, from
                   1e8 pairs up) against the host cKDTree's on the same
                   clouds, rtol 1e-9: the episode's and the object
                   episode's final scene clouds against their 1.2 M-point
                   ground truth (and each episode's running metric, built
                   on the card update by update, against cKDTree's
                   one-shot), and the object's own cloud at 1 cm; prints
                   the queries whose kernel row differs from cKDTree's
                   (argmin disagreements), both one-shot times and the
                   episode's recon_metric seconds per update;
  known_env        the known-environment mode through the entry point
                   (cli.run_scene, as `python -m
                   fisher_nerf_customized_tpu_torch --object_scene
                   --known_env` runs it) at the same width on
                   fake_apartment_5, 20 steps, no evaluation: the planner
                   seeded from the scene's 400 000-point cloud without the
                   object, coverage probes each step, the object found by
                   the novelty mask (the 1-NN kernel, 65 536 pixels
                   against the cloud, every step).  Launch counts zeroed
                   just before and read just after: the 1-NN kernel at
                   least once per step, K1 and K2.  It fails unless the
                   episode reaches its end, finds the object and runs an
                   object planning event; prints
                   the step it was found, and holds the novelty masks of
                   three of its frames on the card against a float64
                   cKDTree reference on the CPU (equal but within 1e-3 m
                   of the 5 cm cut, the 20-pixel gate the same);
  navigation       the frontier-only pipeline through its entry point
                   (cli.run_navigation, as `python -m
                   fisher_nerf_customized_tpu_torch.main_navigation` runs
                   it) on fake_apartment_0 for 100 steps: the spin,
                   occupancy, FBE goals, the sweep planner, and the recon
                   metric of the whole cloud every 25 steps (the 1-NN
                   kernel, launch count zeroed just before and read just
                   after); the final recon held to cKDTree's at rtol 1e-9;
  tracking         optimized tracking through the entry point
                   (cli.run_scene with --set tracking.use_gt_poses False)
                   on fake_apartment_0 at the same width, 30 steps, no
                   evaluation: every frame's pose tracked (40 Adam steps
                   of K1 + K2 on (q, t), doubled when the depth loss stays
                   at 20000 or above), 3 mapping events on the tracked
                   poses.  Launch counts zeroed just before and read just
                   after (K1 and K2 must run).  Prints the wall time, the
                   seconds in _track_pose (wrapped here with a CUDA sync),
                   ms per tracked frame, the phases and doubled phases,
                   K1 and K2 launches while tracking, and the ATE and the
                   largest position and rotation errors of the tracked
                   poses against the sim's; fails on a non-finite pose,
                   or when the first four tracked frames' position errors
                   (the scripted init scan) part by more than 1 cm from
                   the JAX package's on the same frames (with the shipped
                   settings both drift on its 10-degree turns);
  upen_episode     the UPEN baseline through the entry point
                   (cli.run_scene with configs/mp3d_gaussian_UPEN_fbe.yaml)
                   on fake_apartment_0 at full width (256x256, capacity
                   131072, a 5 cm map; UPEN's 192x192 grid at 10 cm, its
                   4-member ensemble on 64x64 crops), 100 steps, no
                   evaluation: UPEN.observe every step, FBE goals at each
                   replan, mapping events (K1, K2), the recon metric (the
                   1-NN).  Launch counts zeroed just before and read just
                   after: K1 and K2 must run, and UPEN must replan at
                   least twice.  UPEN.observe and predict_action are
                   wrapped (a CUDA sync on each side): prints the wall
                   time, the timer, ms per observe and per predict_action,
                   coverage_2d_pct and done_reason;
  upen_check       on its final UPEN state: the ensemble's forward on the
                   card (TF32 off) against the same weights on the CPU
                   (relative to the logits' largest, 1e-4), the last
                   frame's ego grid (to the bit) and register_ego on the
                   card against the CPU (max difference, cells whose
                   argmax differs), predict_action in RRT mode from one
                   generator state on both (the same goal cell reported);
                   times the 4-member forward and a batch-8 train_step;
                   runs tools/train_predictors.py at 1 scene x 20 steps,
                   1 epoch, 2 members (losses finite, its saved ensemble
                   loaded into a fresh UPEN predicting as the trained one,
                   1e-6);
  perceptual       LPIPS(alex) at AlexNet's widths (64/192/384/256/256)
                   and a ViT-S/14 at DINOv2's (D 384, 6 heads, 12 blocks, a
                   37 x 37 position grid), random weights from seeds saved
                   as checkpoints and loaded by the port's loaders: on 8
                   image pairs at 256x256 the card against the same modules
                   on the CPU (LPIPS rel 1e-4, the ViT's tokens within 1e-4
                   of their largest, ViTPatchExtractor's patches the same);
                   ms per LPIPS pair and per ViT call;
  dino_gate        the object episode with --dino_gate through the entry
                   point (fake_apartment_5, --object_scene --dynamic_scene),
                   20 steps, no evaluation: K1 and K2 must launch and the
                   bank hold at least the init frame; prints the frames
                   accepted and vetoed and the ms per gate decision; then
                   10 steps with --dino_weights (the ViT checkpoint of
                   `perceptual`, run on the card) and the same checks;
  nav_images       the FisherRF episode with policy.save_nav_images through
                   the entry point on fake_apartment_0, 30 steps, no
                   evaluation: at least one planning event with K3, a
                   planning_vis/plan_<t>.png per planning event and
                   nav_images/topdown_<t>.png at steps 0 and 20, each
                   PNG's IHDR the size of its map; one render_bev timed
                   and written as bev.png;
  habitat_episode  --sim habitat through the entry point, with a mock
                   habitat module whose Env raycasts fake_apartment_0 with
                   FakeSim on the card and hands back habitat's uint8 rgb
                   and float32 depth (BoxScene.is_navigable its
                   pathfinder): 30 steps of ActiveMapper at the full width
                   (HabitatSim's observations uploaded each step, mapping
                   and planning events), then the evaluation over 256
                   poses through HabitatSim.render_at with LPIPS(alex) set
                   (`perceptual`'s checkpoint).  Launch counts zeroed just
                   before and read just after: K1, K2 and K3 must run, a
                   planning event must run, every eval metric be finite;
                   prints the wall time, the timer's phases, the lpips
                   mean and the upload ms per frame;
  legacy_planning  the legacy in-SLAM planning API on the episode's final
                   map: get_top_down_map, uncertainty_scores (H_train
                   anew), a frontier round and a DBSCAN round of
                   global_planning (256 candidates, the planner's free
                   cells as navigability), DFS_acq_score_planning at depth
                   6, each timed with its K3 launches, with the frontier
                   points and the DBSCAN clusters; _pose_point_scores on 8
                   candidates against the CPU twin (same
                   argmax, Spearman >= 0.99, the per-point max off on at
                   most 1e-3 of the live Gaussians) and the DFS at depth 3
                   against the CPU twin (the same actions);
  ddppo            the DD-PPO network at habitat's width (256x256 depth,
                   GroupNorm ResNet50, hidden 512) on seeded parameters, 3
                   steps on the card against the CPU twin (logits, value,
                   hidden state within 1e-4 of max(its largest, 1), the
                   same argmax), ms per act with TF32 off, DdppoPolicy
                   without a checkpoint taking PathFollower's action;
  render_sh        render_sh at degree 3 over the episode's live Gaussians
                   at its latest keyframe (256x256): the image and the
                   L1 loss's gradient to the SH coefficients on the card
                   against the CPU twin, K1 and K2 launched once each, ms
                   of the forward and of the forward with the backward;
  occ_map          OccupancyMap at the planner's grid over the episode's
                   first 10 frames on the card and the CPU: labels equal
                   cell for cell, ms per update;
  slice            the map-query path at the same width: 60 scripted steps
                   through GaussianSLAM.track_rgbd (6 mapping events of
                   densify + 60 Adam steps of 2 frames), then renders at 8
                   keyframe poses, H_train over all keyframes and 256
                   candidate poses scored by EIG.  Launch counts as above.
                   Mapping losses must be finite and fall within an event
                   on average.  The first 32 candidates are scored again
                   on the CPU by the plain twins as the reference (same
                   argmax, Spearman >= 0.99);
  probe            the slice's map (60 frames, 6 mapping events with Adam;
                   with --kernels-only the same map is built here); the
                   kernel phases below run on it;
  tracking_check   on the probe map at its latest keyframe, from a pose
                   moved by (2, -1, 3) cm and 1 degree: the first tracking
                   step's loss and (q, t) gradient (to 1e-3 of its norm)
                   and one 8-step tracking phase (per-step losses rtol
                   1e-3, best pose within Adam's 2 lr x steps) on the card
                   against the CPU twin; times one tracking step (a
                   one-step phase: K1, K2, autograd, Adam) and one
                   40-step phase;
  slam_settings    on copies of the probe map, the card against the CPU
                   twin: gs_densify from one shared draw (n_active exact,
                   parameters rtol 1e-5), the seen-from-the-keyframes mask
                   of prune_invisible (slots that differ must sit at a
                   culling boundary) and its removed count;
  kernel_blend     K1 against its plain PyTorch twin on the card, at
                   T 256, K 256 and 512, C 4 and 5, with its rows walked
                   (the stop) against the twin's on every tile; counts the
                   walked pairs, those left by the per-warp box test and
                   the live ones (alpha > 0), which set the bound;
  kernel_blend_bwd K2 against its plain twin at T 256, K 256 and 512, C 4,
                   chunk 256, fed K1's outputs: gcol is the mapping loss's
                   cotangent at the latest keyframe, g_t a seeded random
                   one (the mapping loss gives final T none);
  kernel_fisher    K3 against its plain twin at B 32, T 16, K 512, P 1024,
                   NF 11 and 20, on 32 candidate poses; two launches must
                   give the same rows to the bit, and a row of NaN opacity
                   must give the twin's zeros; counts the walked pairs,
                   those left by the box test on K3's warp patches, those
                   of rows that blend in the warp's patch (its second walk)
                   and the live ones, which set the bound; the ptxas report
                   of each K3 instantiation must show no stack frame and no
                   spills;
  kernel_nn1       the culled 1-NN kernel against its plain twin on the
                   card, to the bit in distance and row, at the recon
                   metric's shape (the 1.2 M ground-truth points against
                   80 000 points of the episode's cloud) and the novelty
                   mask's (65 536 pixels of a known-env frame against the
                   400 000-point cloud), its count of evaluated pairs equal
                   to the plain emulation's (nn1_culled_plain); each shape
                   timed by CUDA events, the all-pairs pass and the culled
                   call (glue included) in turns, the culled kernels alone,
                   the twin and torch.cdist(...).min(1), beside the
                   all-pairs bound and the culled work's; then exact ties
                   across tiles and across the walk's splits over
                   gridDim.y (3000 queries), queries on tile box faces, a
                   coplanar cloud, NaN and inf in unmasked and in masked
                   refs, and an all-masked cloud;
  wrappers         what K1's and K2's wrappers cost the host per mapping
                   event: each kernel phase times its wrapper's host work
                   per call (checks, allocations, the ctypes launch; no
                   synchronize between calls);
  plan_check       one more planning event on the episode's final state
                   (ActiveMapper.plan_best_path), profiled: device time by
                   kernel and the device's idle share; then on its inputs
                   K3 20-wide at the path-EIG shape (B 20) against its
                   plain twin on the card (timed, with its bound), the
                   path-EIG scores of its first 4 paths against the plain
                   twins on the CPU (same argmax and ranking, for the
                   scores and for their point-EIG sums), and its sweep field against the CPU's
                   (parent exact, cost to 1e-3); times the sweep field and
                   one occupancy update on the card, and compares that
                   update with the CPU's on the same map and frame, cell
                   for cell (the count of differing cells is reported);
  device_split     the CPU test episode's settings (tests/test_engine.py
                   episode_cfg: 48x48, a 10 cm map, 24 steps, FakeSim seed
                   3, mapper seed 0) on the card and on the CPU: the first
                   step at which their actions part; a split before the
                   first planning event fails, a later one is reported with
                   the two best path scores of the event before it;
  profile          device time by kernel over one more mapping event of
                   the slice's map, over one planning query and over one
                   more object planning event on the object episode's
                   final state (its K2 launches are the probe-batched
                   ones);
  kernels          one line per kernel with its launches (the episode's;
                   the probe-batched K2's from the object episode, the
                   1-NN's from the known-env episode) and max error; K3's
                   20-wide variant and the probe-batched K2 have their own
                   lines.
Then one JSON line of per-kernel numbers, the card's name and power limit
(nvidia-smi), and the last line {"ok": true, "device": {...}}.  Any
failure raises: the exit code is then nonzero and no result line prints.
With `--json PATH` every measured number also goes to PATH;
`--kernels-only` skips the slice and stops after the kernel phases.
"""
import argparse
import functools
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12          # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
FP32_PEAK = 67e12         # H100 SXM FP32 flop/s outside the tensor cores
# Operations per (pixel, slot) pair, counted from csrc/blend_common.cuh,
# blend.cu and blend_bwd.cu.  Evaluating the Gaussian at the pixel
# (pair_alpha): 2 sub, 9 mul/add for the conic power, 1 exp, the opacity
# mul, the 0.99 clamp and the 1/255 test.
FLOPS_PER_PAIR = 14
# K1 on a live pair (alpha > 0), on top: w = alpha T (1), the C-wide
# blend acc += w color (2C), T (1 - alpha) (2), the median latch's two
# compares (2).
K1_FLOPS_PER_LIVE_PAIR = (FLOPS_PER_PAIR + 5, 2)       # 19 + 2C
# K2 on a live pair, on top: cg = color . gcol (2C), run += alpha T cg (3),
# T *= 1 - alpha (2), S_behind = gC - run (1), 1/max(1 - alpha, 1e-2) (3),
# dL/dalpha (4), t1 = opacity dL/dalpha G (2), the five conic and mean
# gradients (4 + 4 + 3 + 2 + 3), d opacity (1), w = alpha T (1), the C
# color gradients (C), and the 6+C adds into the sums over pixels.
K2_FLOPS_PER_LIVE_PAIR = (FLOPS_PER_PAIR + 39, 4)      # 53 + 4C
# K3 (csrc/fisher.cu) on a live pair: two evaluations (one per walk);
# per walk w = alpha T (1), the C or run fma (2), T (1 - alpha) (2); in
# walk 2, S_behind = C - run (1), 1/max(1 - alpha, 1e-2) (2), dL/dalpha
# (4), t1 = opacity dL/dalpha G (2), the two 2D-mean gradients (4 + 4),
# gx, gy, gz (1 + 1 + 3), d opacity (1), the four squares added (8).  The
# full chain adds the three conic cotangents (3 + 2 + 3) and their nine
# products with the Jacobian added into gx, gy, gz (18).
K3_FLOPS_PER_LIVE_PAIR = {11: 2 * FLOPS_PER_PAIR + 2 * 5 + 31,     # 69
                          20: 2 * FLOPS_PER_PAIR + 2 * 5 + 31 + 26}  # 95
# the slice's 60 scripted steps (the first 59 actions and the first frame)
ACTIONS = ([2] * 36 + [1] * 24 + [3] * 9 + [1] * 24 + [2] * 18 + [1] * 9)[:59]
EXTRA_ACTIONS = [2] * 10        # after the slice: one more mapping event
N_PROBE_FRAMES = 60
SCENE = "fake_apartment_0"
SCENE_SEED = zlib.crc32(SCENE.encode()) % (2 ** 31)
EPISODE_STEPS = 100
N_EVAL_POSES = 2000     # the entry point's default
RESUME_STEPS = 10       # after the resume: one mapping event
MIN_PLANNING_EVENTS = 2
# plan_check scores this many of the extra planning event's paths again on
# the CPU twins (each path's score depends on its own poses alone; all of
# its 10 paths before, ~85 s of CPU time)
PLAN_CHECK_CPU_PATHS = 4
# the object episode: the spawned object (2.2 m from the start, in the
# start room) is in view from step 0, and the episode runs two object
# planning events
OBJECT_SCENE = "fake_apartment_5"
OBJECT_STEPS = 40
MIN_OBJECT_MAPPING = 3
# the known-environment episode (--object_scene --known_env) on the object
# scene, and the frontier-only navigation on the episode's scene
KNOWN_ENV_STEPS = 20     # 40 before: the found object's first planning
NAV_STEPS = 100          # event comes in the first 20 steps
# the recon update's sub-phases in the episode's timer (engine/driver.py::
# ActiveMapper._recon_update, engine/eval.py::IncrementalReconMetric.update)
TRACK_STEPS = 30        # the tracked episode: 3 mapping events
# The JAX package's position errors (m) on the tracked episode's first four
# frames (the init frame again and three 10-degree turns of the scripted
# init scan: before any mapping or planning event, so the same frames on
# every device), from tests/test_torch_tracking.py's
# test_jax_tracking_drifts_on_the_init_scan, which holds the JAX package to
# them.  The card's must agree within SCAN_ATOL_M.
JAX_SCAN_ERRORS_M = (0.0315608, 0.182126, 0.460087, 0.728978)
SCAN_ATOL_M = 0.01
TRACK_CHECK_ITERS = 8   # the card-against-CPU tracking phase
TRACK_SHIFT = np.array([0.02, -0.01, 0.03], np.float32)
RECON_SUB_PHASES = ("new_points", "upload", "nn1", "download", "recompute",
                    "surface", "running_min", "ckdtree")
# the UPEN episode (configs/mp3d_gaussian_UPEN_fbe.yaml) on SCENE, the
# DINO-gated object episode on OBJECT_SCENE, and the FisherRF episode
# writing the navigation images on SCENE (topdown PNGs at steps 0 and 20)
UPEN_STEPS = 100
MIN_UPEN_REPLANS = 2
DINO_STEPS = 20
NAV_IMAGES_STEPS = 30
# the perceptual networks at their real widths (LPIPS(alex), a ViT-S/14),
# the DINO gate's run with the ViT, and the habitat episode (a mock
# habitat.Env over SCENE, its evaluation with LPIPS(alex))
PERCEPTUAL_PAIRS = 8
PERCEPTUAL_SIZE = 256
DINO_VIT_STEPS = 10
HABITAT_STEPS = 30
HABITAT_EVAL_POSES = 256
# the pipelined episode's timer phases, reported beside the synchronous
# episode's; the legacy planning API's DFS depths (timed, and held to the
# CPU twin); the DD-PPO steps; the OccupancyMap's frames
PIPE_PHASES = ("planning", "plan.global", "plan.global.wait", "prefetch",
               "sim_step", "tracking_mapping")
LEGACY_DFS_DEPTH = 6
LEGACY_DFS_CHECK_DEPTH = 3
LEGACY_CHECK_POSES = 8
DDPPO_STEPS = 3
OCC_MAP_FRAMES = 10


T_START = time.perf_counter()
_LAST_PHASE = [T_START]


def phase(tag, /, **fields):
    """One phase line, with its own seconds (since the line before it)
    and the seconds since the script started."""
    now = time.perf_counter()
    fields = dict(fields, phase_s=f"{now - _LAST_PHASE[0]:.1f}",
                  at_s=f"{now - T_START:.1f}")
    _LAST_PHASE[0] = now
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def fmt(row):
    return {k: (f"{v:.4g}" if isinstance(v, float) else v)
            for k, v in row.items()}


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(fn, reps):
    """Host time per call of fn over reps back-to-back calls with no
    synchronize between them: for a kernel wrapper, its checks,
    allocations and launch, not the kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def kernel_device_ms(fn, kernel_name, reps, tries=3):
    """Device time per launch of the CUDA kernel named kernel_name over
    reps calls of fn, from the profiler's CUDA kernel rows.  Unlike CUDA
    events around back-to-back calls, it excludes the host gaps between
    launches.  A session that records no row for the kernel is repeated,
    up to `tries` sessions in all; then it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if kernel_name in e.key and e.self_device_time_total > 0]
        if rows:
            return sum(e.self_device_time_total for e in rows) / 1e3 / sum(
                e.count for e in rows)
        print(f"  profiler session {attempt + 1} recorded no {kernel_name}")
    raise RuntimeError(f"the profiler recorded no device time for "
                       f"{kernel_name} in {tries} sessions")


def pair_counts(packed, pix_xy, nvalid, walked, warp_pixels):
    """Pairs of the rows a blend kernel walks (below min(walked, nvalid)):
    all of them, those left after the per-warp box test of warps of
    `warp_pixels` pixels, and the live ones (alpha > 0), from the plain
    twin's pair test on the card; and the rows a warp walks after the box
    test (mean and max over warps) and their largest sum over a tile."""
    import torch
    from fisher_nerf_customized_tpu_torch.ops import cuda_blend
    k = packed.shape[1]
    n_walk = torch.minimum(walked.long(), nvalid.long())
    rows = torch.arange(k, device=packed.device)[None, :] < n_walk[:, None]
    alpha, _g, _dx, _dy = cuda_blend._pair_alpha(
        packed, pix_xy[:, 0, None, :], pix_xy[:, 1, None, :])
    hits = cuda_blend.warp_hits(cuda_blend.row_boxes(packed), pix_xy,
                                warp_pixels)
    p = pix_xy.shape[-1]
    warp_rows = (hits & rows[..., None]).sum(dim=1)             # (T, W)
    return dict(
        pairs_walked=int(rows.sum()) * p,
        pairs_boxed=int(warp_rows.sum()) * warp_pixels,
        pairs_live=int(((alpha > 0) & rows[..., None]).sum()),
        warp_rows_mean=float(warp_rows.float().mean()),
        warp_rows_max=int(warp_rows.max()),
        tile_warp_rows_max=int(warp_rows.sum(dim=1).max()))


def fisher_pair_counts(packed, pix_xy, nvalid, k_eff, chunk):
    """Pairs of the rows K3 walks (below min(k_eff chunk, nvalid) per
    (pose, tile)): all of them, those left after the box test on K3's warp
    patches (its first walk), those of the rows that blend at some pixel
    of the warp's patch (its second walk), and the live ones (alpha > 0),
    from the twin's pair test on the card; the rows a warp walks after
    the box test (mean and max over warps); and, per (pose, tile) and
    averaged over them, the rows of each walk on its critical path: the
    sum over chunks of the busiest warp's rows (`*_chunk_max`, the walk
    waits at a barrier after each chunk), the busiest warp's rows over all
    chunks (`*_warp_max`) and the mean over warps (`*_warp_mean`)."""
    import torch
    from fisher_nerf_customized_tpu_torch.ops import cuda_fisher
    nb, n_tiles, k, nf = packed.shape
    p = pix_xy.shape[-1]
    rows = packed.reshape(-1, k, nf)
    n_walk = torch.minimum(k_eff * chunk, nvalid.reshape(-1).long())
    warp_px = cuda_fisher.fisher_warp_pixels(p).to(packed.device)
    per_warp = warp_px.shape[1]
    counts = dict(pairs_walked=0, pairs_boxed=0, pairs_warp_blend=0,
                  pairs_live=0)
    warp_rows = []
    crit = {f"{w}_{c}": [] for w in ("walk1", "walk2")
            for c in ("chunk_max", "warp_max", "warp_mean")}
    for r0 in range(0, rows.shape[0], 32):          # 32 (pose, tile)s at once
        blk = rows[r0:r0 + 32]
        pix = pix_xy[torch.arange(r0, r0 + blk.shape[0],
                                  device=packed.device) % n_tiles]
        walk = (torch.arange(k, device=packed.device)[None, :]
                < n_walk[r0:r0 + blk.shape[0], None])              # (S, K)
        alpha, _g, _dx, _dy = cuda_fisher._chunk_alpha(
            blk, pix[:, 0, None, :], pix[:, 1, None, :])          # (S, K, P)
        live = (alpha > 0) & walk[..., None]
        hits = cuda_fisher.fisher_warp_hits(
            cuda_fisher.fisher_row_boxes(blk), pix) & walk[..., None]
        blends = live[..., warp_px].any(dim=-1)                   # (S, K, W)
        counts["pairs_walked"] += int(walk.sum()) * p
        counts["pairs_boxed"] += int(hits.sum()) * per_warp
        counts["pairs_warp_blend"] += int(blends.sum()) * per_warp
        counts["pairs_live"] += int(live.sum())
        warp_rows.append(hits.sum(dim=1))
        for walk, m in (("walk1", hits), ("walk2", blends)):
            per_chunk = m.reshape(m.shape[0], k // chunk, chunk, -1).sum(2)
            crit[f"{walk}_chunk_max"].append(per_chunk.amax(-1).sum(-1))
            crit[f"{walk}_warp_max"].append(per_chunk.sum(1).amax(-1))
            crit[f"{walk}_warp_mean"].append(per_chunk.sum(1).float().mean(-1))
    warp_rows = torch.cat(warp_rows)
    return dict(counts, warp_rows_mean=float(warp_rows.float().mean()),
                warp_rows_max=int(warp_rows.max()),
                **{key: float(torch.cat(v).float().mean())
                   for key, v in crit.items()})


def write_json(path, report):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def eccv_config():
    """configs/mp3d_gaussian_FR_eccv.yaml over the port's defaults."""
    from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(HERE, "configs",
                                     "mp3d_gaussian_FR_eccv.yaml"))
    return cfg


def run_slam(cfg, dev, actions, events=None):
    """GaussianSLAM.track_rgbd over the first frame and one frame per
    action, as an episode run calls it (ground-truth poses), on FakeSim
    fake_apartment_0.  With `events`, every step that fires a mapping event
    is timed (host clock between synchronizes) and appended there with its
    first and last loss."""
    from fisher_nerf_customized_tpu_torch.envs.fake_sim import (BoxScene,
                                                                FakeSim)
    from fisher_nerf_customized_tpu_torch.models.slam import GaussianSLAM
    slam = GaussianSLAM(cfg, device=dev)
    sim = FakeSim(BoxScene.multi_room(seed=SCENE_SEED), slam.camera,
                  forward_step=float(cfg.forward_step_size),
                  turn_angle=float(cfg.turn_angle), device=dev)
    obs = sim.reset()
    slam.track_rgbd(obs["rgb"], obs["depth"], np.linalg.inv(obs["c2w"]))
    for a in actions:
        step(slam, sim.step(a), events)
    return slam, sim


def step(slam, obs, events):
    """One track_rgbd call; timed into `events` if it maps (see run_slam)."""
    import torch
    before = slam.last_losses
    if events is not None:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.track_rgbd(obs["rgb"], obs["depth"], np.linalg.inv(obs["c2w"]))
    if events is not None:
        torch.cuda.synchronize()
        if slam.last_losses is not before:
            losses = slam.last_losses.cpu().numpy()
            events.append(dict(
                t=slam.frame_idx, ms=(time.perf_counter() - t0) * 1e3,
                loss_first=float(losses[0]), loss_last=float(losses[-1]),
                losses_finite=bool(np.isfinite(losses).all()),
                n_active=slam.n_active))


def run_episode(log_dir):
    """The port's entry point on SCENE for EPISODE_STEPS steps, on the card:
    (args, cfg, result, mapper, wall seconds, launches by kernel, the
    evaluation's record: its wall seconds, K1 launches and rows)."""
    import torch
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.engine import driver
    from fisher_nerf_customized_tpu_torch.ops import (cuda_blend,
                                                      cuda_blend_bwd,
                                                      cuda_fisher, cuda_knn)
    args = cli.build_parser().parse_args([
        "--slam_config", os.path.join(HERE, "configs",
                                      "mp3d_gaussian_FR_eccv.yaml"),
        "--scenes_list", SCENE, "--max_steps", str(EPISODE_STEPS),
        "--log_dir", log_dir, "--name", "episode"])
    cfg = cli.load_config(args)
    eval_fn = driver.eval_navigation
    ev = {}

    def recording(*a, **kw):
        torch.cuda.synchronize()
        k1, t0 = cuda_blend.launches, time.perf_counter()
        out = eval_fn(*a, **kw)
        torch.cuda.synchronize()
        ev.update(wall_s=time.perf_counter() - t0,
                  k1_launches=cuda_blend.launches - k1,
                  per_pose=out["per_pose"])
        return out

    driver.eval_navigation = recording
    cuda_blend.launches = 0
    cuda_blend_bwd.launches = 0
    cuda_fisher.launches = 0
    cuda_fisher.launches_full = 0
    cuda_knn.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, mapper = cli.run_scene(args, cfg, SCENE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        driver.eval_navigation = eval_fn
    launches = dict(blend=cuda_blend.launches,
                    blend_bwd=cuda_blend_bwd.launches,
                    fisher=cuda_fisher.launches - cuda_fisher.launches_full,
                    fisher_nf20=cuda_fisher.launches_full,
                    nn1=cuda_knn.launches)
    return args, cfg, result, mapper, wall_s, launches, ev


def check_eval(result, mapper, ev):
    """The episode's evaluation and recon curve: (row, report)."""
    from fisher_nerf_customized_tpu_torch.cli import _sample_gt
    from fisher_nerf_customized_tpu_torch.engine.eval import (
        accuracy_comp_ratio_from_pcl)
    ev_res, recon = result["eval"], result["recon"]
    timing = result["timing"]
    row = dict(**{k: v for k, v in ev_res.items()},
               **{f"recon_{k}": v for k, v in recon.items()},
               auc=result["auc"], eval_wall_s=ev["wall_s"],
               eval_k1_launches=ev["k1_launches"],
               recon_metric_total_s=timing["recon_metric"]["total_s"],
               recon_metric_count=timing["recon_metric"]["count"],
               **{f"recon_{sub}_s": timing[f"recon_metric.{sub}"]["total_s"]
                  for sub in RECON_SUB_PHASES
                  if f"recon_metric.{sub}" in timing},
               pcl_total_s=timing["pcl"]["total_s"],
               n_points=mapper.global_pcl.n_points())
    if timing.get("recon_metric.nn1", {}).get("count", 0) < 1:
        raise AssertionError("the recon updates took no 1-NN kernel path")
    if ev["k1_launches"] < N_EVAL_POSES or ev_res["n_poses"] != N_EVAL_POSES:
        raise AssertionError(f"the eval launched K1 {ev['k1_launches']} "
                             f"times for {ev_res['n_poses']} poses")
    names = ["psnr", "ssim", "lpips_proxy", "depth_mae"]
    if ev_res["n_seen"] > 0:
        names += ["psnr_seen", "ssim_seen", "depth_mae_seen"]
    values = [ev_res[k] for k in names] + list(recon.values()) \
        + [result["auc"]]
    if not np.isfinite(values).all():
        raise AssertionError(f"non-finite eval or recon metric: {row}")
    ssims = np.asarray([r["ssim"] for r in ev["per_pose"]])
    if not (np.isfinite(ssims).all() and ssims.min() >= -1.0
            and ssims.max() <= 1.001):
        raise AssertionError(f"per-pose SSIM out of [-1, 1.001]: "
                             f"{ssims.min()} .. {ssims.max()}")
    curve = [s["completeness_ratio"] for s in mapper.metrics.steps
             if "completeness_ratio" in s]
    if len(curve) != EPISODE_STEPS // 25 or np.any(np.diff(curve) < 0):
        raise AssertionError(f"completeness curve {curve}")
    gt = _sample_gt(mapper.scene)
    one_shot = accuracy_comp_ratio_from_pcl(
        mapper.global_pcl.get(), gt, 0.05,
        surface_dist_fn=mapper.scene.surface_distance)
    rel = {k: abs(recon[k] - v) / max(abs(v), 1e-300)
           for k, v in one_shot.items()}
    if max(rel.values()) > 1e-9:
        raise AssertionError(f"running recon {recon} off the one-shot "
                             f"{one_shot}")
    report = dict(row, completeness_curve=curve,
                  curve_steps=[s["step"] for s in mapper.metrics.steps],
                  one_shot_rel_err=rel, n_gt=len(gt),
                  ssim_min=float(ssims.min()), ssim_max=float(ssims.max()))
    return row, report


def check_eval_chunk(mapper):
    """The eval's first chunk of 32 poses: metrics with K1 against those
    with K1's plain twin on the card, the batched raycast against per-pose
    raycasts, lpips_proxy on the card against the CPU."""
    import torch
    from fisher_nerf_customized_tpu_torch.engine import eval as teval
    from fisher_nerf_customized_tpu_torch.ops import cuda_blend, rasterize
    slam, sim = mapper.slam, mapper.sim
    poses = teval.uniform_eval_poses(mapper.scene, 32,
                                     float(sim.c2w[1, 3]))
    gt_rgb, gt_depth = sim.render_at_batch(poses)
    raycast_equal = 0
    for i, c2w in enumerate(poses):
        rgb, depth = sim.render_at(c2w)
        raycast_equal += int(torch.equal(rgb, gt_rgb[i])
                             and torch.equal(depth, gt_depth[i]))
    out = slam.render_at_poses(poses)
    k1 = torch.stack(teval._batch_render_metrics(
        out["render"], gt_rgb, out["depth"], gt_depth)).cpu().numpy()
    kernel = rasterize.cuda_blend
    rasterize.cuda_blend = cuda_blend._blend_walk      # the plain twin
    try:
        twin_out = slam.render_at_poses(poses)
    finally:
        rasterize.cuda_blend = kernel
    twin = torch.stack(teval._batch_render_metrics(
        twin_out["render"], gt_rgb, twin_out["depth"], gt_depth)).cpu().numpy()
    rel = np.abs(k1 - twin) / np.maximum(np.abs(twin), 1e-12)
    lp_card = teval.lpips_proxy_batch(out["render"][:4], gt_rgb[:4])
    lp_cpu = teval.lpips_proxy_batch(out["render"][:4].cpu(),
                                     gt_rgb[:4].cpu())
    lp_rel = float(((lp_card.cpu() - lp_cpu).abs() / lp_cpu.abs()).max())
    row = dict(poses=len(poses), raycast_equal=raycast_equal,
               k1_vs_twin_rel_max=float(rel.max()),
               k1_vs_twin_rel_by_metric=[float(r) for r in rel.max(axis=1)],
               lpips_card_vs_cpu_rel=lp_rel,
               psnr_mean=float(k1[0].mean()))
    if raycast_equal != len(poses):
        raise AssertionError(f"render_at_batch differs from render_at at "
                             f"{len(poses) - raycast_equal} poses")
    if not np.isfinite(k1).all() or float(rel.max()) > 1e-4:
        raise AssertionError(f"eval chunk with K1 off its plain twin: {row}")
    if lp_rel > 1e-5:
        raise AssertionError(f"lpips_proxy on the card off the CPU's by "
                             f"{lp_rel} (TF32?)")
    return row


def check_resume(args, cfg, result, mapper):
    """A fresh ActiveMapper on a copy of the episode's checkpoint: the
    restored state against the episode's, then RESUME_STEPS more steps."""
    import shutil
    import torch
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.engine.driver import ActiveMapper
    steps = result["steps"]
    eval_dir = mapper.eval_dir + "_resume"
    shutil.rmtree(eval_dir, ignore_errors=True)
    shutil.copytree(mapper.eval_dir, eval_dir)
    cfg = cfg.clone()
    cfg.num_frames = steps + RESUME_STEPS
    sim, scene = cli.make_sim(args, cfg, SCENE)
    fresh = ActiveMapper(cfg, sim, scene=scene, eval_dir=eval_dir,
                         seed=args.seed, scene_id=SCENE, device=args.device)
    fresh.resume(os.path.join(eval_dir, f"params{steps}.npz"))
    a, b = mapper, fresh
    same = dict(
        n_active=a.slam.n_active == b.slam.n_active,
        keyframes=(a.slam.keyframe_time_indices
                   == b.slam.keyframe_time_indices
                   and a.slam.keyframes.state_dict()["ids"]
                   == b.slam.keyframes.state_dict()["ids"]),
        occupancy=bool(torch.equal(a.planner.occ_map, b.planner.occ_map)),
        point_cloud=a.global_pcl.n_points() == b.global_pcl.n_points(),
        queue=list(a.queue) == list(b.queue),
        sim_pose=bool(np.array_equal(a.sim.c2w, b.sim.c2w)),
        rng=all(x.rng.bit_generator.state == y.rng.bit_generator.state
                for x, y in ((a, b), (a.slam, b.slam),
                             (a.planner, b.planner),
                             (a.global_pcl, b.global_pcl))))
    if not all(same.values()):
        raise AssertionError(f"resumed state differs: {same}")
    losses = b.slam.last_losses
    res = b.test_navigation(n_eval_poses=0)
    torch.cuda.synchronize()
    if res["steps"] != steps + RESUME_STEPS or b.slam.last_losses is losses:
        raise AssertionError(f"the resumed run ended at {res['steps']} "
                             f"without a mapping event")
    new_losses = b.slam.last_losses.cpu().numpy()
    if not np.isfinite(new_losses).all():
        raise AssertionError("non-finite losses after the resume")
    return dict(resumed_at=steps, steps=res["steps"],
                n_active=b.slam.n_active, loss_first=float(new_losses[0]),
                loss_last=float(new_losses[-1]),
                planning_events=res["planning_events"],
                **{f"same_{k}": v for k, v in same.items()})


def count_cut_ties(mapper):
    """At each keyframe pose of the map, the rows of the render's binning
    (coarse and fine; a grid too small for the coarse level has only the
    fine) whose K cut falls inside a depth tie: the k-th and (k+1)-th
    scores equal and finite."""
    import torch
    from fisher_nerf_customized_tpu_torch.ops import binning
    nearest = binning._nearest_k
    calls = []

    def counting(scores, k):
        if scores.shape[-1] > k:
            top = torch.topk(scores, k + 1, dim=-1).values
            tie = (top[..., k - 1] == top[..., k]) & torch.isfinite(
                top[..., k])
            calls.append((int(tie.sum()), tie.numel()))
        else:
            calls.append((0, scores[..., 0].numel()))
        return nearest(scores, k)

    slam = mapper.slam
    rows = dict(coarse_tied=0, coarse_rows=0, fine_tied=0, fine_rows=0,
                poses=0, poses_with_tie=0)
    binning._nearest_k = counting
    try:
        for w2c in slam.keyframes.stacked_w2cs():
            calls.clear()
            slam.render_at_pose(np.linalg.inv(w2c))
            if len(calls) not in (1, 2):
                raise AssertionError(f"{len(calls)} top-k levels per render")
            (ct, cr), (ft, fr) = ([(0, 0)] + calls)[-2:]   # coarse, fine
            rows["coarse_tied"] += ct
            rows["coarse_rows"] += cr
            rows["fine_tied"] += ft
            rows["fine_rows"] += fr
            rows["poses"] += 1
            rows["poses_with_tie"] += int(ct + ft > 0)
    finally:
        binning._nearest_k = nearest
    rows["max_per_tile"] = slam.settings.max_per_tile
    return rows


def small_episode(device):
    """ActiveMapper on tests/test_engine.py's episode_cfg (48x48 frames, a
    10 cm map, queue 8, 24 steps, FakeSim seed 3, mapper seed 0) on
    `device`: (actions, plan_log)."""
    from fisher_nerf_customized_tpu_torch.config import get_cfg_defaults
    from fisher_nerf_customized_tpu_torch.engine.driver import ActiveMapper
    from fisher_nerf_customized_tpu_torch.envs.fake_sim import (BoxScene,
                                                                FakeSim)
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera
    img = 48
    cfg = get_cfg_defaults()
    cfg.SLAM.Dataset.Calibration.merge_from_other(dict(
        fx=float(img), fy=float(img), cx=img / 2, cy=img / 2, width=img,
        height=img))
    cfg.merge_from_list([
        "policy.name", "gaussians_based", "policy.planning_queue_size", 8,
        "num_frames", 24, "map_every", 6, "keyframe_every", 4,
        "downsample_pcd", 2, "mapping.num_iters", 8,
        "forward_step_size", 0.15, "turn_angle", 30.0,
        "explore.cell_size", 0.1, "explore.sample_view_num", 16,
        "explore.frontier_select_method", "combined", "tpu.capacity", 8192,
        "tpu.tile_size", 8, "tpu.max_per_tile", 512, "tpu.pose_chunk", 4])
    cam = Camera(fx=float(img), fy=float(img), cx=img / 2, cy=img / 2,
                 width=img, height=img)
    scene = BoxScene(room_lo=(-3, 0, -3), room_hi=(3, 2.5, 3),
                     obstacles=[((1.0, 0.0, 1.0), (1.8, 1.8, 1.8))])
    sim = FakeSim(scene, cam, forward_step=0.15, turn_angle=30.0, seed=3,
                  device=device)
    actions = []
    sim_step = sim.step

    def step(a):
        actions.append(int(a))
        return sim_step(a)

    sim.step = step
    mapper = ActiveMapper(cfg, sim, scene=scene, seed=0, device=device,
                          eval_dir=os.path.join(HERE, "experiments",
                                                "chip_smoke", f"small_{device}"))
    mapper.test_navigation(n_eval_poses=0)
    return actions, mapper.plan_log


def check_device_split():
    """The small episode on the card and on the CPU: the first step at
    which the actions part, against the first planning event."""
    card, card_log = small_episode("cuda")
    cpu, cpu_log = small_episode("cpu")
    split = next((i for i, (a, b) in enumerate(zip(card, cpu)) if a != b),
                 None if len(card) == len(cpu) else min(len(card), len(cpu)))
    first_event = cpu_log[0]["t"] if cpu_log else None
    row = dict(steps=len(cpu), first_split=split, first_planning_event=first_event,
               planning_events_card=len(card_log),
               planning_events_cpu=len(cpu_log))
    if split is not None:
        if first_event is None or split < first_event:
            raise AssertionError(f"card and CPU actions part at step {split},"
                                 f" before the first planning event: {row}")
        event = max((e for e in cpu_log if e["t"] <= split),
                    key=lambda e: e["t"])
        card_event = next((e for e in card_log if e["t"] == event["t"]), None)
        top2 = np.sort(np.asarray(event["scores"])[
            np.isfinite(event["scores"])])[-2:]
        row.update(split_event_t=event["t"],
                   cpu_best_two=[float(x) for x in top2],
                   cpu_best=event["best"],
                   card_best=None if card_event is None else card_event["best"],
                   near_tie=bool(len(top2) == 2 and abs(top2[1] - top2[0])
                                 <= 1e-2 * abs(top2[1])))
    return row


def capture_planning_event(mapper):
    """One more planning event on the mapper's current state, with the
    arguments and scores of its path-EIG call: (actions, captured dict)."""
    from fisher_nerf_customized_tpu_torch.engine import driver
    captured = {}
    score_fn = driver.path_eig_scores

    def recording(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        captured["scores"] = score_fn(*args, **kwargs)
        return captured["scores"]

    driver.path_eig_scores = recording
    try:
        mapper.planner._search_key = None          # a fresh sweep field
        actions, _path = mapper.plan_best_path(
            np.asarray(mapper.sim.c2w, np.float64), 1,
            mapper.slam.frame_idx + 1)
    finally:
        driver.path_eig_scores = score_fn
    return actions, captured


def kernel_of(key):
    """The kernel a profiler row belongs to: blend, blend_bwd, fisher (K3
    11-wide), fisher_nf20 (K3 20-wide, the template's FULL = true), or
    None."""
    if "blend_bwd_kernel" in key:
        return "blend_bwd"
    if "blend_kernel" in key:
        return "blend"
    if "fisher_kernel" in key:
        full = "<true>" in key or "<(bool)1>" in key
        return "fisher_nf20" if full else "fisher"
    return None


def check_planning_event(mapper, cap, report):
    """On the captured planning event: K3 20-wide against its plain twin at
    the path-EIG shape (the first acc step's 20 path poses), timed, with
    its bound; the event's path-EIG scores against the plain twins on the
    CPU (same argmax and ranking); its sweep field against the CPU's."""
    import torch
    from fisher_nerf_customized_tpu_torch.engine.path_eval import (
        combine_path_scores, path_point_eig_totals)
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        GaussianState)
    from fisher_nerf_customized_tpu_torch.ops import cuda_fisher
    from fisher_nerf_customized_tpu_torch.ops.fisher import (
        fisher_kernel_inputs)
    from fisher_nerf_customized_tpu_torch.planning.astar import (
        _collision_cost)
    from fisher_nerf_customized_tpu_torch.planning.occupancy import (
        occ_update)
    from fisher_nerf_customized_tpu_torch.planning.sweep import sweep_field
    from fisher_nerf_customized_tpu_torch.utils.raster import distance_l1
    slam, planner = mapper.slam, mapper.planner
    (state, h_train, w2cs, valid, lengths, final, camera, settings, lam,
     pose_w, point_w, end_w, vol_w, cnt, grad_value) = cap["args"]
    out = {}

    # K3 20-wide on the first acc step's poses, as path EIG launches it
    params = state.params()
    active = state.active
    packed, pix_xy, nvalid, _bins, _prep = fisher_kernel_inputs(
        camera, w2cs[:, 0], params["means3D"], torch.exp(params["log_scales"]),
        params["unnorm_rotations"],
        torch.sigmoid(params["logit_opacities"][:, 0]), params["rgb_colors"],
        active=active, settings=settings, full_chain=True)
    args = (packed, pix_xy, nvalid, settings.chunk, grad_value, camera.fx,
            camera.fy)
    got = cuda_fisher.cuda_fisher_slots(*args)
    nb, n_tiles, k, nf = packed.shape
    ref, k_eff = cuda_fisher._fisher_walk(
        packed.reshape(nb * n_tiles, k, nf), pix_xy, nvalid.reshape(-1),
        settings.chunk, grad_value, camera.fx, camera.fy)
    ref = ref.reshape(got.shape)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    # tolerance as in the kernel phase: rtol 5e-3 plus 1e-6 of the largest
    bad = err > 5e-3 * ref.abs() + 1e-6 * scale
    if nf != cuda_fisher.NF_FULL or scale <= 0 or bool(bad.any()):
        raise AssertionError(f"K3 NF={nf} on the path-EIG poses: "
                             f"{int(bad.sum())} rows off, max err "
                             f"{float(err.max())} of {scale}")
    launch = functools.partial(cuda_fisher.cuda_fisher_slots, *args)
    p = pix_xy.shape[-1]
    rows = int(torch.minimum(k_eff * settings.chunk,
                             nvalid.reshape(-1).long()).sum())
    n_bytes = (rows * nf + n_tiles * 2 * p + nb * n_tiles
               + nb * n_tiles * k * 4) * 4
    pairs = fisher_pair_counts(packed, pix_xy, nvalid, k_eff, settings.chunk)
    bms, bby = bound_ms(n_bytes, pairs["pairs_live"]
                        * K3_FLOPS_PER_LIVE_PAIR[nf])
    out["k3_nf20"] = dict(
        B=nb, T=n_tiles, K=k, P=p, chunk=settings.chunk,
        max_abs_err=float(err.max()), max_value=scale,
        ms=kernel_device_ms(launch, "fisher_kernel", 20),
        ms_events=cuda_ms(launch, 20), host_ms=host_ms(launch, 100),
        plain_ms=cuda_ms(lambda: cuda_fisher.fisher_slots_plain(*args), 3),
        bound_ms=bms, bound_by=bby, rows_needed=rows, **pairs)
    del packed, got, ref, err

    # the event's path-EIG scores against the plain twins on the CPU.  At
    # the eccv config the final-EIG term (weight 30) dominates the scores,
    # so the point-EIG sums, the part the Fisher renders make, are also
    # compared on their own: by ranking and argmax, as EIG across devices
    # (ROADMAP.md, queue 3 item g)
    n_paths = int(np.isfinite(final.cpu().numpy()).sum())
    n_cpu = min(n_paths, PLAN_CHECK_CPU_PATHS)
    point_args = (lam, point_w, vol_w, cnt, grad_value)
    card_totals = path_point_eig_totals(state, h_train, w2cs, valid, camera,
                                        settings, *point_args)
    # (the CPU twins score the first n_cpu real paths only: each path's
    # rows depend on its own poses alone)
    cpu_totals = path_point_eig_totals(
        GaussianState(*(x.cpu() for x in state)), h_train.cpu(),
        w2cs[:n_cpu].cpu(), valid[:n_cpu].cpu(), camera, settings,
        *point_args)
    cpu_scores = combine_path_scores(cpu_totals, lengths[:n_cpu].cpu(),
                                     final[:n_cpu].cpu(), end_w).numpy()
    card = cap["scores"].cpu().numpy()[:n_cpu]
    card_totals = card_totals.cpu().numpy()[:n_cpu]
    cpu_totals = cpu_totals.numpy()

    def spearman(a, b):
        rank = lambda x: np.argsort(np.argsort(x))
        if len(a) > 2:
            return float(np.corrcoef(rank(a), rank(b))[0, 1])
        return float(np.array_equal(rank(a), rank(b)))

    out.update(n_paths=n_paths, n_paths_cpu=n_cpu,
               path_scores=card.tolist(),
               path_scores_cpu=cpu_scores.tolist(),
               path_rel_err_max=float(np.max(np.abs(card - cpu_scores)
                                             / np.abs(cpu_scores))),
               path_spearman=spearman(card, cpu_scores),
               path_argmax=int(card.argmax()),
               point_totals=card_totals.tolist(),
               point_totals_cpu=cpu_totals.tolist(),
               point_rel_err_max=float(np.max(
                   np.abs(card_totals - cpu_totals) / np.abs(cpu_totals))),
               point_spearman=spearman(card_totals, cpu_totals))
    for what, a, b in (("scores", card, cpu_scores),
                       ("point-EIG sums", card_totals, cpu_totals)):
        if int(a.argmax()) != int(b.argmax()) or spearman(a, b) < 0.99:
            raise AssertionError(f"path-EIG {what} off the CPU twins: card "
                                 f"{a}, CPU {b}")

    # the event's sweep field against the CPU's
    search = planner._search
    (y0, y1), (x0, x1) = search.window
    free = planner.free_space_np[y0:y1, x0:x1].astype(bool)
    tier = _collision_cost(distance_l1(planner.free_space_np.astype(
        np.uint8)))[y0:y1, x0:x1]
    start = (search.start[0] - y0, search.start[1] - x0)
    cpu_cost, cpu_parent, cpu_rounds = sweep_field(
        torch.from_numpy(free), torch.from_numpy(tier.astype(np.float32)),
        start)
    cost = search._cost_dev.cpu()
    parent = search._parent_dev.cpu()
    cost_err = float((cost - cpu_cost).abs().max())
    if (not torch.equal(parent, cpu_parent) or cost_err > 1e-3
            or search.rounds != cpu_rounds):
        raise AssertionError(f"sweep field off the CPU's: parent differs at "
                             f"{int((parent != cpu_parent).sum())} cells, "
                             f"cost by {cost_err}, rounds {search.rounds} "
                             f"vs {cpu_rounds}")
    # its time on the card: wall (host clock around a synchronized run)
    # and device time (the profiler's kernel rows of another run)
    dev = search._cost_dev.device
    free_d = torch.from_numpy(free).to(dev)
    tier_d = torch.from_numpy(tier.astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep_field(free_d, tier_d, start)
    torch.cuda.synchronize()
    sweep_wall_ms = (time.perf_counter() - t0) * 1e3
    sweep_ms, sweep_launches = device_ms_and_launches(
        lambda: sweep_field(free_d, tier_d, start))
    out.update(sweep_window=[y1 - y0, x1 - x0], sweep_rounds=search.rounds,
               sweep_cost_err=cost_err, sweep_parent_equal=True,
               sweep_wall_ms=sweep_wall_ms, sweep_device_ms=sweep_ms,
               sweep_kernel_launches=sweep_launches,
               sweep_reached=int((cost < 3e38).sum()))

    # one occupancy update (the episode's last frame) on the card
    obs = mapper.sim.get_observations()
    occ_args = (planner.occ_map, obs["depth"],
                torch.as_tensor(obs["c2w"], device=dev), planner.camera,
                planner.cell_size, planner._map_center_dev,
                planner.height_lower, planner.height_upper,
                planner.pcd_far_distance)
    occ_ms, occ_launches = device_ms_and_launches(
        lambda: occ_update(*occ_args))
    # the same update on the CPU, cell for cell
    card_occ, card_pos = occ_update(*occ_args)
    cpu_occ, cpu_pos = occ_update(*(
        x.cpu() if isinstance(x, torch.Tensor) else x for x in occ_args))
    off = (card_occ.cpu() != cpu_occ).any(dim=0)
    out.update(occupancy_device_ms=occ_ms, occupancy_launches=occ_launches,
               occupancy_events_ms=cuda_ms(lambda: occ_update(*occ_args), 20),
               occupancy_cells_off_cpu=int(off.sum()),
               occupancy_values_off_cpu=int((card_occ.cpu() != cpu_occ).sum()),
               occupancy_max_abs_off_cpu=float(
                   (card_occ.cpu() - cpu_occ).abs().max()),
               occupancy_cam_pos_equal=bool(torch.equal(card_pos.cpu(),
                                                        cpu_pos)))
    if int(off.sum()):
        cells = torch.nonzero(off)[:8].tolist()
        print(f"  occupancy: {int(off.sum())} cells differ from the CPU's, "
              f"e.g. {cells}")
    return out


def zero_launches():
    """Set every kernel wrapper's launch count to 0."""
    from fisher_nerf_customized_tpu_torch.ops import (cuda_blend,
                                                      cuda_blend_bwd,
                                                      cuda_fisher, cuda_knn)
    for mod, names in ((cuda_blend, ["launches"]),
                       (cuda_blend_bwd, ["launches", "launches_probes"]),
                       (cuda_fisher, ["launches", "launches_full"]),
                       (cuda_knn, ["launches"])):
        for name in names:
            setattr(mod, name, 0)


def read_launches():
    """The launches since zero_launches(), by kernel (K3's 20-wide
    variant and the probe-batched K2 apart)."""
    from fisher_nerf_customized_tpu_torch.ops import (cuda_blend,
                                                      cuda_blend_bwd,
                                                      cuda_fisher, cuda_knn)
    return dict(blend=cuda_blend.launches,
                blend_bwd=cuda_blend_bwd.launches,
                blend_bwd_probes=cuda_blend_bwd.launches_probes,
                fisher=cuda_fisher.launches - cuda_fisher.launches_full,
                fisher_nf20=cuda_fisher.launches_full,
                nn1=cuda_knn.launches)


def timed_entry_point(args, cfg, scene):
    """cli.run_scene on the card with the launch counts zeroed just
    before and read just after: (result, mapper, wall seconds,
    launches)."""
    import torch
    from fisher_nerf_customized_tpu_torch import cli
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, mapper = cli.run_scene(args, cfg, scene)
    torch.cuda.synchronize()
    return result, mapper, time.perf_counter() - t0, read_launches()


def run_object_episode(log_dir):
    """The port's entry point with --object_scene --dynamic_scene on
    OBJECT_SCENE for OBJECT_STEPS steps, on the card (no evaluation):
    (result, mapper, wall seconds, launches by kernel, record).  The
    record holds the object mapping events' count and the arguments and
    scores of the last object path-score call."""
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.models import object_slam
    args = cli.build_parser().parse_args([
        "--slam_config", os.path.join(HERE, "configs",
                                      "mp3d_gaussian_FR_eccv.yaml"),
        "--scenes_list", OBJECT_SCENE, "--max_steps", str(OBJECT_STEPS),
        "--object_scene", "--dynamic_scene", "--eval_poses", "0",
        "--log_dir", log_dir, "--name", "object"])
    cfg = cli.load_config(args)
    rec = dict(mapping_events=0)
    cls = object_slam.GaussianObjectSLAM
    event_fn, path_fn = cls._object_mapping_event, object_slam.object_path_scores

    def counting(self, *a, **kw):
        rec["mapping_events"] += 1
        return event_fn(self, *a, **kw)

    def recording(*a, **kw):
        out = path_fn(*a, **kw)
        rec.update(path_args=a, path_scores=out)
        return out

    cls._object_mapping_event = counting
    object_slam.object_path_scores = recording
    try:
        result, mapper, wall_s, launches = timed_entry_point(args, cfg,
                                                             OBJECT_SCENE)
    finally:
        cls._object_mapping_event = event_fn
        object_slam.object_path_scores = path_fn
    return result, mapper, wall_s, launches, rec


def check_object_episode(result, mapper, wall_s, launches, rec):
    """The object episode's checks: the object was detected and mapped
    (at least MIN_OBJECT_MAPPING events), at least one object planning
    event, n_active > 0, the object Gaussians' median xz distance to the
    object under 1.2 m (the JAX package's tests/test_object_episode.py),
    K1, K2 and the probe-batched K2 launched, the object curve finite and
    never falling.  Returns the phase's row."""
    obj_slam = mapper.obj_slam
    timing = result["timing"]
    events = [e for e in mapper.plan_log if e.get("object")]
    curve = [s["completeness_ratio"] for s in mapper.object_metrics.steps]
    row = dict(steps=result["steps"], wall_s=wall_s,
               steps_per_s=result["steps"] / wall_s,
               object_detected=obj_slam is not None,
               object_mapping_events=rec["mapping_events"],
               object_planning_events=len(events),
               planning_events=result["planning_events"],
               **{f"launches_{k}": v for k, v in launches.items()})
    if obj_slam is None:
        raise AssertionError("the object was not detected")
    pts = obj_slam.gaussian_points
    obj = mapper.sim.dynamic_object
    d = np.linalg.norm(pts[:, [0, 2]] - obj.translation[[0, 2]], axis=1)
    row.update(object_n_active=obj_slam.n_active,
               object_keyframes=len(obj_slam.keyframes),
               object_max_per_tile=obj_slam.settings.max_per_tile,
               object_median_xz_m=float(np.median(d)) if len(d) else None,
               object_curve=curve,
               object_cloud_points=len(mapper.global_obj_pcl))
    for name in ("object_tracking", "obj_recon_metric", "plan.object",
                 "planning", "tracking_mapping"):
        if name in timing:
            row[f"{name.replace('.', '_')}_s"] = timing[name]["total_s"]
    if "plan.object" in timing:
        row["object_planning_event_ms_mean"] = timing["plan.object"]["mean_ms"]
    if obj_slam.n_active <= 0:
        raise AssertionError("the object map is empty")
    if not np.median(d) < 1.2:
        raise AssertionError(f"object Gaussians {np.median(d)} m from the "
                             f"object (median xz)")
    if rec["mapping_events"] < MIN_OBJECT_MAPPING:
        raise AssertionError(f"{rec['mapping_events']} object mapping events")
    if not events or "path_args" not in rec:
        raise AssertionError("no object planning event")
    if min(launches[k] for k in ("blend", "blend_bwd",
                                 "blend_bwd_probes", "nn1")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if not curve or not np.isfinite(curve).all() or \
            any(b < a for a, b in zip(curve, curve[1:])):
        raise AssertionError(f"object curve {curve}")
    if not all(np.isfinite(e["scores"]).all() for e in events):
        raise AssertionError("non-finite object path scores")
    return row


def check_object(mapper, rec, report):
    """On the object episode's final object map: the Hutchinson
    estimates through the probe-batched K2 against K2's plain twin on the
    card, each probe's rows against a lone K2 launch, the pose scores
    under fisher, topt and dopt and the last object planning event's path
    scores against the CPU's plain twins from the same probes, and the
    probe-batched K2 timed at 8 poses x 8 probes with its bound."""
    import torch
    from fisher_nerf_customized_tpu_torch.models import object_slam
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        state_to_numpy)
    from fisher_nerf_customized_tpu_torch.ops import (cuda_blend,
                                                      cuda_blend_bwd)
    from fisher_nerf_customized_tpu_torch.ops import fisher as fisher_ops
    from fisher_nerf_customized_tpu_torch.planning.candidates import (
        generate_candidates_object)
    obj = mapper.obj_slam
    st, cam = obj.settings, obj.camera
    params = obj.state.params()
    out = {}

    # the Hutchinson diagonals at the last keyframes (one pose chunk), the
    # keyframes' own probes, through the kernel and through the twin
    ids = list(range(len(obj.keyframes)))[-obj.obj_pose_chunk:]
    w2cs = np.stack([obj.keyframes.w2cs[i] for i in ids])
    zs = obj._kf_probes(ids, obj.hutch_probes)
    got = obj._h11(w2cs, zs)
    kernel_fn = fisher_ops.cuda_blend_bwd_probes

    def twin(packed, pix_xy, gcol, g_t, nvalid, chunk, **_kw):
        return cuda_blend_bwd.blend_bwd_probes_plain(packed, pix_xy, gcol,
                                                     g_t, nvalid, chunk)
    fisher_ops.cuda_blend_bwd_probes = twin
    try:
        ref = obj._h11(w2cs, zs)
        w2c_t = obj._w2c(w2cs[-1])
        blk_args = (cam, params["means3D"] @ w2c_t[:3, :3].T + w2c_t[:3, 3],
                    torch.exp(params["log_scales"]), params["unnorm_rotations"],
                    torch.sigmoid(params["logit_opacities"][:, 0]),
                    params["rgb_colors"], zs[-1, :2])
        blocks_ref = fisher_ops.block_jtj(*blk_args, active=obj._active(),
                                          settings=st)["blocks"]
    finally:
        fisher_ops.cuda_blend_bwd_probes = kernel_fn
    blocks = fisher_ops.block_jtj(*blk_args, active=obj._active(),
                                  settings=st)["blocks"]
    torch.cuda.synchronize()
    # tolerance: rtol 1e-4 plus 1e-6 of the largest entry (the kernel's
    # fixed-order sums against torch's; entries at the f32 floor)
    for name, g, r in (("h11", got, ref), ("blocks", blocks, blocks_ref)):
        err = (g - r).abs()
        scale = float(r.abs().max())
        bad = err > 1e-4 * r.abs() + 1e-6 * scale
        out[f"{name}_max_abs_err"] = float(err.max())
        out[f"{name}_max_value"] = scale
        if scale <= 0 or bool(bad.any()):
            raise AssertionError(f"Hutchinson {name}: {int(bad.sum())} "
                                 f"entries off the twin's, max err "
                                 f"{float(err.max())} of {scale}")

    # the probe-batched K2 at this chunk: each probe's rows against a lone
    # launch on that probe, to the bit; its time, bound and live pairs
    means_cam = params["means3D"] @ obj._w2c(w2cs)[:, :3, :3].transpose(
        1, 2) + obj._w2c(w2cs)[:, None, :3, 3]
    x = fisher_ops.hutchinson_kernel_inputs(
        cam, means_cam, torch.exp(params["log_scales"]),
        params["unnorm_rotations"],
        torch.sigmoid(params["logit_opacities"][:, 0]), params["rgb_colors"],
        zs, active=obj._active(), settings=st)
    k1 = dict(color=x["color"], t_final=x["t_final"], walked=x["walked"])
    args = (x["packed"], x["pix_xy"], x["gcol"], x["g_t"], x["nvalid"],
            st.chunk)
    probes_out = cuda_blend_bwd.cuda_blend_bwd_probes(*args, **k1)
    for b in range(x["gcol"].shape[0]):
        lone = cuda_blend_bwd.cuda_blend_bwd(
            x["packed"], x["pix_xy"], x["gcol"][b], x["g_t"][b], x["nvalid"],
            st.chunk, **k1)
        if not torch.equal(probes_out[b], lone):
            raise AssertionError(f"probe {b}: rows differ from a lone K2 "
                                 f"launch by {float((probes_out[b] - lone).abs().max())}")
    plain = cuda_blend_bwd.blend_bwd_probes_plain(*args)
    torch.cuda.synchronize()
    err = (probes_out - plain).abs()
    col_max = plain.abs().reshape(-1, plain.shape[-1]).amax(dim=0)
    # tolerance as the kernel_blend_bwd phase's: rtol 1e-3 plus 1e-4 of the
    # column's largest value
    if bool((err > 1e-3 * plain.abs() + 1e-4 * col_max).any()):
        raise AssertionError(f"probe-batched K2 off its twin: max err "
                             f"{float(err.max())}")
    del plain
    launch = functools.partial(cuda_blend_bwd.cuda_blend_bwd_probes, *args,
                               **k1)
    n_probes = x["gcol"].shape[0]
    ms = kernel_device_ms(launch, "blend_bwd_kernel", 20)
    plain_ms = cuda_ms(lambda: cuda_blend_bwd.blend_bwd_probes_plain(*args), 1)
    lone_ms = kernel_device_ms(functools.partial(
        cuda_blend_bwd.cuda_blend_bwd, x["packed"], x["pix_xy"], x["gcol"][0],
        x["g_t"][0], x["nvalid"], st.chunk, **k1), "blend_bwd_kernel", 20)
    n_tiles, k, f = x["packed"].shape
    p = x["pix_xy"].shape[-1]
    n_ch = f - cuda_blend.BASE_F
    pairs = pair_counts(x["packed"], x["pix_xy"], x["nvalid"], x["walked"],
                        cuda_blend_bwd.PIXELS_PER_WARP)
    rows = int(torch.minimum(x["walked"].long(), x["nvalid"].long()).sum())
    n_bytes = (rows * f + n_tiles * 2 * p + n_tiles
               + n_probes * n_tiles * p * (n_ch + 1)        # gcol, g_t
               + n_tiles * p * (n_ch + 1) + n_tiles         # K1's outputs
               + n_probes * n_tiles * k * (6 + n_ch)) * 4
    ops = n_probes * pairs["pairs_live"] * (K2_FLOPS_PER_LIVE_PAIR[0]
                                            + K2_FLOPS_PER_LIVE_PAIR[1] * n_ch)
    bms, bby = bound_ms(n_bytes, ops)
    out.update(poses=len(ids), probes=n_probes, B=len(ids) * n_probes,
               T=n_tiles, K=k, P=p, C=n_ch, rows_needed=rows,
               max_abs_err=float(err.max()), max_value=float(col_max.max()),
               ms=ms, plain_ms=plain_ms, lone_probe_ms=lone_ms, bound_ms=bms,
               bound_by=bby, bitwise_per_probe=True, **pairs)
    del x, args, k1, probes_out, launch

    # pose scores: the card's against the CPU twins', the same probes (the
    # card's draws, copied) and the same H_train
    cpu = object_slam.GaussianObjectSLAM(obj.cfg, eval_dir=obj.eval_dir,
                                         start_frame_idx=obj.start_frame_idx,
                                         device="cpu")
    cpu.set_from_numpy(state_to_numpy(obj.state))
    cpu.settings = obj.settings
    draws = {}
    card_draw = obj.probe_draw

    def caching(seed, n):
        z = card_draw(seed, n)
        draws[(seed, n)] = z
        return z
    obj.probe_draw = caching
    cpu.probe_draw = lambda seed, n: draws[(seed, n)].cpu()
    h_train = {n: obj.compute_H_train_obj(n_probes=n) for n in (2, obj.hutch_probes)}
    cpu.compute_H_train_obj = lambda n_probes=None: h_train[
        int(n_probes or cpu.hutch_probes)].cpu()
    cpu.keyframes = obj.keyframes
    anchors = obj.gaussian_points[:, [0, 2]].mean(axis=0, keepdims=True)
    ex = obj.cfg.explore_object
    cands = generate_candidates_object(
        anchors, 16, float(ex.sample_range), float(ex.min_range),
        float(mapper.planner.cam_height), np.random.default_rng(0))

    def spearman(a, b):
        rank = lambda v: np.argsort(np.argsort(v))
        return float(np.corrcoef(rank(a), rank(b))[0, 1])
    try:
        for crit in ("fisher", "topt", "dopt"):
            cpu._draws = obj._draws
            if crit == "fisher":
                s_card = obj.pose_eval(cands)[0]
                s_cpu = cpu.pose_eval(cands)[0]
            else:
                s_card = obj.pose_eval_popgs(cands, criterion=crit, K=2)[0]
                s_cpu = cpu.pose_eval_popgs(cands, criterion=crit, K=2)[0]
            s_card, s_cpu = s_card.cpu().numpy(), s_cpu.numpy()
            rho = spearman(s_card, s_cpu)
            rel = np.abs(s_card - s_cpu) / np.abs(s_cpu)
            out[f"pose_{crit}_spearman"] = rho
            out[f"pose_{crit}_rel_err_max"] = float(rel.max())
            out[f"pose_{crit}_argmax"] = int(s_card.argmax())
            if rho < 0.99 or int(s_card.argmax()) != int(s_cpu.argmax()):
                raise AssertionError(f"object pose scores ({crit}) off the "
                                     f"CPU twins: spearman {rho}, argmax "
                                     f"{int(s_card.argmax())} vs "
                                     f"{int(s_cpu.argmax())}")
    finally:
        obj.probe_draw = card_draw

    # the last object planning event's path scores, on the CPU twins
    a = rec["path_args"]
    probes = a[7]
    to_cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v  # noqa
    cpu_args = ([{k: v.cpu() for k, v in a[0].items()}]
                + [to_cpu(v) for v in a[1:7]]
                + [lambda s: probes(s).cpu()] + list(a[8:]))
    path_cpu = object_slam.object_path_scores(*cpu_args).numpy()
    path_card = rec["path_scores"].cpu().numpy()
    valid = np.isfinite(path_cpu)
    out.update(path_n=int(valid.sum()),
               path_argmax=int(np.argmax(path_card)),
               path_argmax_cpu=int(np.argmax(path_cpu)),
               path_rel_err_max=float(np.max(np.abs(
                   path_card[valid] - path_cpu[valid])
                   / np.abs(path_cpu[valid]))))
    if int(np.argmax(path_card)) != int(np.argmax(path_cpu)):
        raise AssertionError(f"object path scores: argmax "
                             f"{np.argmax(path_card)} vs the CPU's "
                             f"{np.argmax(path_cpu)}")
    return out


def recon_card_check(est, gt, thresh, surface_fn=None):
    """The recon metric with its nearest neighbours on the card (the 1-NN
    kernel from 1e8 pairs up, engine/eval.py::_nn_dists) against the
    host cKDTree's on the same clouds: both metrics, each one's seconds,
    the relative differences (rtol 1e-9), and the gt -> est queries whose
    kernel row differs from cKDTree's (argmin disagreements) and whose
    recomputed distance differs from cKDTree's."""
    import torch
    from scipy.spatial import cKDTree
    from fisher_nerf_customized_tpu_torch.engine.eval import (
        _dists_to, accuracy_comp_ratio_from_pcl)
    from fisher_nerf_customized_tpu_torch.ops import cuda_knn
    from fisher_nerf_customized_tpu_torch.ops.knn import knn
    est = np.asarray(est, np.float32)
    gt = np.asarray(gt, np.float32)
    n0 = cuda_knn.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = accuracy_comp_ratio_from_pcl(est, gt, thresh,
                                        surface_dist_fn=surface_fn,
                                        device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    if cuda_knn.launches == n0:
        raise AssertionError("the card's recon metric launched no 1-NN "
                             "kernel")
    t0 = time.perf_counter()
    host = accuracy_comp_ratio_from_pcl(est, gt, thresh,
                                        surface_dist_fn=surface_fn)
    host_s = time.perf_counter() - t0
    rel = {k: abs(card[k] - v) / max(abs(v), 1e-300)
           for k, v in host.items()}
    ref_d, ref_i = cKDTree(est).query(gt, k=1, workers=-1)
    _d, idx = knn(torch.as_tensor(gt, device="cuda"),
                  torch.as_tensor(est, device="cuda"), k=1)
    idx = idx[:, 0].cpu().numpy()
    got_d = _dists_to(gt, est, idx)
    row = dict(n_gt=len(gt), n_est=len(est), card_s=card_s, host_s=host_s,
               rel_err_max=max(rel.values()),
               argmin_disagreements=int((idx != ref_i).sum()),
               dist_disagreements=int((got_d != ref_d).sum()),
               dist_max_abs_diff=float(np.abs(got_d - ref_d).max()),
               **{f"card_{k}": v for k, v in card.items()},
               **{f"host_{k}": v for k, v in host.items()})
    if max(rel.values()) > 1e-9:
        raise AssertionError(f"recon on the card {card} off cKDTree's "
                             f"{host}")
    return row


def cdist_min(q, r, block=8192):
    """The library's 1-NN: torch.cdist(q, r).min(1) over query blocks."""
    import torch
    out_d, out_i = [], []
    for q0 in range(0, q.shape[0], block):
        d, i = torch.cdist(q[q0:q0 + block], r).min(dim=1)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def check_nn1(recon_q, recon_r, novelty_q, novelty_r, object_gt,
              object_est):
    """The culled 1-NN kernel against its plain twin on the card, on inputs
    centred as ops/knn.py::knn centres them, at the shapes the paths give
    it: the recon metric's (recon_q: the 1.2 M ground-truth points,
    recon_r: 80 000 points of the episode's cloud), the novelty mask's
    (65 536 back-projected pixels against the 400 000-point known cloud),
    the object metric's both ways (object_gt: its 20 000 surface samples,
    object_est: the object's cloud), and, off the main path, few queries
    against many refs (3000 points of the cloud against the ground
    truth: the recon metric's accuracy without exact surface
    distances): distances and rows equal the twin's to the bit, and the
    kernel's count of evaluated pairs equals the plain emulation's
    (cuda_knn.nn1_culled_plain).  Each shape is timed by CUDA events
    around back-to-back calls, the all-pairs pass (cuda_nn1_brute) and
    the culled call (its glue included) in turns (brute, culled, culled,
    brute), the culled kernels alone on a prepared layout and, where the
    walk is split over gridDim.y, the same kernels with one split in
    turns (split, one, one, split), the twin and torch.cdist(...).min(1).
    Beside them three bounds: the function's (bound_ms: each input read
    once and each output written once, or 9 operations for each query's
    one nearest pair, whichever takes longer), the culled work's (the
    evaluated pairs, 9 operations each) and the all-pairs pass's (every
    pair).  Then the edge cases, each equal to the twin: exact ties
    across tiles and across the splits of the walk over gridDim.y with
    few queries (the lowest row), queries on tile box faces, a coplanar
    cloud, NaN and inf in unmasked and in masked refs, and an all-masked
    cloud."""
    import dataclasses
    import torch
    from fisher_nerf_customized_tpu_torch.ops import cuda_knn
    from fisher_nerf_customized_tpu_torch.ops.knn import center_inputs
    dev = recon_q.device

    def same(tag, args, pairs_too=False):
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        got = cuda_knn.cuda_nn1(*args, pair_count=count)
        ref = cuda_knn.nn1_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            bad = int(((got[0] != ref[0]) | (got[1] != ref[1])).sum())
            raise AssertionError(f"nn1 {tag}: {bad} queries differ from the "
                                 f"twin")
        pairs = int(count.item())
        if pairs_too:
            emu_d, emu_i, emu_pairs = cuda_knn.nn1_culled_plain(*args)
            if not (torch.equal(emu_d, ref[0]) and torch.equal(emu_i, ref[1])):
                raise AssertionError(f"nn1 {tag}: the emulation differs from "
                                     f"the twin")
            if emu_pairs != pairs:
                raise AssertionError(f"nn1 {tag}: the kernel evaluated {pairs}"
                                     f" pairs, the emulation {emu_pairs}")
        return got, pairs

    rows = []
    for tag, q, r in (("recon", recon_q, recon_r),
                      ("novelty", novelty_q, novelty_r),
                      ("object", object_gt, object_est),
                      ("object_acc", object_est, object_gt),
                      ("smallq", recon_r[:3000], recon_q)):
        qc, rc = center_inputs(q, r)
        n_q, n_r = qc.shape[0], rc.shape[0]
        (got_d, got_i), pairs = same(tag, (qc, rc), pairs_too=True)
        brute_d, brute_i = cuda_knn.cuda_nn1_brute(qc, rc)
        if not (torch.equal(brute_d, got_d) and torch.equal(brute_i, got_i)):
            raise AssertionError(f"nn1 {tag}: the all-pairs pass differs")
        lay = cuda_knn.culled_layout(qc, rc)
        out_d = torch.full((n_q,), float("inf"), device=dev)
        out_i = torch.zeros(n_q, dtype=torch.int32, device=dev)
        brute = functools.partial(cuda_knn.cuda_nn1_brute, qc, rc)
        culled = functools.partial(cuda_knn.cuda_nn1, qc, rc)
        turns = [cuda_ms(fn, 5) for fn in (brute, culled, culled, brute)]
        kernel = cuda_ms(lambda: cuda_knn.launch_culled(lay, out_d, out_i), 5)
        glue = cuda_ms(lambda: cuda_knn.culled_layout(qc, rc), 5)
        row = dict(shape=tag, Q=n_q, R=n_r, tiles=lay.n_tiles,
                   splits=lay.splits, pairs=pairs,
                   pair_share=pairs / max(n_q * n_r, 1))
        if lay.splits > 1:
            # the same kernels with the walk unsplit, on the same layout
            one = dataclasses.replace(lay, splits=1)
            one_d = torch.full_like(out_d, float("inf"))
            one_i = torch.zeros_like(out_i)
            cuda_knn.launch_culled(one, one_d, one_i)
            if not (torch.equal(one_d, got_d) and torch.equal(one_i, got_i)):
                raise AssertionError(f"nn1 {tag}: one split differs")
            split_turns = [cuda_ms(lambda x=x: cuda_knn.launch_culled(
                x, out_d, out_i), 5) for x in (lay, one, one, lay)]
            row.update(split_kernel_ms=(split_turns[0] + split_turns[3]) / 2,
                       one_split_kernel_ms=(split_turns[1]
                                            + split_turns[2]) / 2,
                       split_kernel_ms_turns=split_turns)
            del one, one_d, one_i
        plain = cuda_ms(lambda: cuda_knn.nn1_plain(qc, rc), 1)
        lib_d, _lib_i = cdist_min(qc, rc)
        library = cuda_ms(lambda: cdist_min(qc, rc), 1)
        n_bytes = (n_q + n_r) * 12 + n_q * 8
        bms, bby = bound_ms(n_bytes, 9 * n_q)
        work_bound, work_by = bound_ms(n_bytes, 9 * pairs)
        brute_bound, brute_by = bound_ms(n_bytes, 9 * n_q * n_r)
        row.update(max_abs_err=0.0, ms=(turns[1] + turns[2]) / 2,
                   culled_ms_turns=turns[1:3], kernel_ms=kernel,
                   glue_ms=glue, brute_ms=(turns[0] + turns[3]) / 2,
                   brute_ms_turns=[turns[0], turns[3]], plain_ms=plain,
                   library_ms=library,
                   library_max_abs_diff=float((lib_d - got_d).abs().max()),
                   bound_ms=bms, bound_by=bby, culled_work_bound_ms=work_bound,
                   culled_work_bound_by=work_by, brute_bound_ms=brute_bound,
                   brute_bound_by=brute_by)
        rows.append(row)
        phase("kernel_nn1", **fmt({k: v for k, v in row.items()
                                   if not isinstance(v, list)}))
        del qc, rc, lay, out_d, out_i, got_d, got_i, brute_d, brute_i
        del lib_d, _lib_i

    g = torch.Generator(device=dev).manual_seed(0)
    edge = {}
    # exact ties with few queries (the new -> ground-truth direction's
    # shape, the walk split over gridDim.y): 3 copies of each of 64 points
    # at scattered rows, and 300 copies of one point (more than a tile,
    # so its copies fill neighbouring tiles, which go to different
    # splits); each query next to a duplicated point
    r = recon_q[:600_000].clone()
    q = recon_r[:3000].clone()
    src = torch.arange(100, 100 + 64 * 37, 37, device=dev)
    r[src + 250_000] = r[src]
    r[src + 500_000] = r[src]
    many = torch.arange(300_000, 300_000 + 300 * 997, 997, device=dev)
    r[many] = r[7].clone()
    q[:len(src)] = r[src] + 1e-4
    q[len(src)] = r[7] + 1e-4
    qc, rc = center_inputs(q, r)
    lay = cuda_knn.culled_layout(qc, rc)
    if lay.splits < 2:
        raise AssertionError(f"the small-Q case did not split: {lay.splits}")
    (_d, got_i), edge["ties_pairs"] = same("ties", (qc, rc))
    if not (torch.equal(got_i[:len(src)].long(), src) and int(got_i[len(src)])
            == 7):
        raise AssertionError("nn1 ties: not the lowest row")
    edge.update(tie_queries=len(src) + 1, tie_splits=lay.splits,
                tie_tiles=lay.n_tiles)
    # queries on tile box faces: each on a face of a tile's box (one
    # coordinate the box's min or max, the others inside it)
    qc, rc = center_inputs(recon_q[:200_000], recon_r)
    lay = cuda_knn.culled_layout(qc, rc)
    tiles = torch.randint(0, lay.n_tiles, (20_000,), generator=g, device=dev)
    lo, hi = lay.boxes[tiles, :3], lay.boxes[tiles, 4:7]
    face = lo + (hi - lo) * torch.rand(lo.shape, generator=g, device=dev)
    axis = torch.randint(0, 3, (len(tiles),), generator=g, device=dev)
    side = torch.where(torch.rand(len(tiles), 1, generator=g, device=dev)
                       < 0.5, lo, hi)
    pick = torch.arange(len(tiles), device=dev)
    face[pick, axis] = side[pick, axis]
    _got, edge["face_pairs"] = same("faces", (face.contiguous(), rc), True)
    edge["face_queries"] = len(tiles)
    # a coplanar cloud: every point at z = 0.25, queries on the plane and
    # off it
    flat_r, flat_q = rc.clone(), qc[:50_000].clone()
    flat_r[:, 2] = 0.25
    flat_q[:25_000, 2] = 0.25
    _got, edge["coplanar_pairs"] = same("coplanar", (flat_q, flat_r), True)
    # NaN and inf in unmasked refs (no mask: they can never win), and in
    # masked ones
    bad = rc.clone()
    rows_bad = torch.randperm(bad.shape[0], generator=g, device=dev)[:600]
    bad[rows_bad[:200], 0] = float("nan")
    bad[rows_bad[200:400], 1] = float("inf")
    bad[rows_bad[400:], 2] = -float("inf")
    _got, edge["nonfinite_pairs"] = same("nonfinite", (qc, bad), True)
    mask = torch.rand(bad.shape[0], generator=g, device=dev) < 0.5
    mask[rows_bad] = False
    got_m, _pairs = same("mask", (qc, bad, mask), True)
    keep = torch.nonzero(mask).flatten()
    sub, _pairs = same("unmasked", (qc, rc[keep].contiguous()))
    if not (torch.equal(got_m[0], sub[0])
            and torch.equal(keep[sub[1].long()], got_m[1].long())):
        raise AssertionError("nn1 mask: not the 1-NN of the unmasked refs")
    (none_d, none_i), _pairs = same("all_masked",
                                   (qc, rc, torch.zeros_like(mask)))
    if not (bool(torch.isinf(none_d).all()) and not bool(none_i.any())):
        raise AssertionError("nn1 all masked: not (inf, 0)")
    edge.update(nonfinite_refs=len(rows_bad), masked_refs=int((~mask).sum()))
    phase("kernel_nn1", **edge)
    return rows, edge


def novelty_card_check(known, frame, inv_k):
    """The novelty mask of one frame on the card (the 1-NN kernel)
    against a float64 reference on the CPU: the back-projection and
    cKDTree's distances in float64.  Equal on every pixel but those within
    1e-3 m of the 5 cm cut; the min_pixels gate decided the same way."""
    import torch
    from scipy.spatial import cKDTree
    from fisher_nerf_customized_tpu_torch.ops.knn import (
        novelty_mask_from_pcd_nn)
    depth, c2w = frame
    mask, n_novel = novelty_mask_from_pcd_nn(
        torch.as_tensor(known, device="cuda"), depth.cuda(),
        torch.as_tensor(inv_k, device="cuda"),
        torch.as_tensor(c2w, device="cuda"))
    mask = mask.cpu().numpy()
    d_np = depth.cpu().numpy().astype(np.float64)
    h, w = d_np.shape
    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    cam = (pix @ np.asarray(inv_k, np.float64).T) * d_np[..., None]
    c2w64 = np.asarray(c2w, np.float64)
    pts = cam @ c2w64[:3, :3].T + c2w64[:3, 3]
    d, _ = cKDTree(np.asarray(known, np.float64)).query(
        pts.reshape(-1, 3), workers=-1)
    novel = ((d > 0.05) & (d_np.reshape(-1) > 0)).reshape(h, w)
    ref = novel & (novel.sum() >= 20)
    near = (np.abs(d - 0.05) < 1e-3).reshape(h, w)
    off = int((mask != ref)[~near].sum())
    row = dict(novel=int(n_novel), novel_ref=int(novel.sum()),
               near_cut=int(near.sum()), differ_off_cut=off,
               differ_near_cut=int((mask != ref)[near].sum()))
    if off or ((int(n_novel) >= 20) != (int(novel.sum()) >= 20)):
        raise AssertionError(f"novelty mask off the CPU's: {row}")
    return row


def run_known_env(log_dir):
    """The port's entry point with --object_scene --known_env on
    OBJECT_SCENE for KNOWN_ENV_STEPS steps, on the card (no evaluation):
    (result, mapper, wall seconds, launches by kernel, record).  The
    record holds the step of the first object detection and three frames
    (depth on the card, c2w) whose novelty masks are checked after."""
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.engine import driver
    args = cli.build_parser().parse_args([
        "--slam_config", os.path.join(HERE, "configs",
                                      "mp3d_gaussian_FR_eccv.yaml"),
        "--scenes_list", OBJECT_SCENE, "--max_steps", str(KNOWN_ENV_STEPS),
        "--object_scene", "--known_env", "--eval_poses", "0",
        "--log_dir", log_dir, "--name", "known_env"])
    cfg = cli.load_config(args)
    cls = driver.ActiveMapper
    mask_fn, step_fn = cls._object_mask, cls._object_step
    rec = dict(found=None, frames=[], calls=0)
    keep = {0, KNOWN_ENV_STEPS // 2, KNOWN_ENV_STEPS - 1}

    def masking(self, obs):
        if rec["calls"] in keep:
            rec["frames"].append((obs["depth"].clone(),
                                  np.asarray(obs["c2w"], np.float32)))
        rec["calls"] += 1
        return mask_fn(self, obs)

    def stepping(self, obs, mask, t):
        if rec["found"] is None:
            rec["found"] = int(t)
        return step_fn(self, obs, mask, t)

    cls._object_mask, cls._object_step = masking, stepping
    try:
        result, mapper, wall_s, launches = timed_entry_point(args, cfg,
                                                             OBJECT_SCENE)
    finally:
        cls._object_mask, cls._object_step = mask_fn, step_fn
    return result, mapper, wall_s, launches, rec


def check_known_env(result, mapper, wall_s, launches, rec):
    """The known-env episode reached its end, found the object by novelty
    and launched the 1-NN kernel every step; three of its frames' novelty
    masks on the card against the CPU.  Returns the phase's row."""
    timing = result["timing"]
    row = dict(steps=result["steps"], done_reason=result["done_reason"],
               wall_s=wall_s, steps_per_s=result["steps"] / wall_s,
               object_found_at=rec["found"],
               planning_events=result["planning_events"],
               object_planning_events=sum(1 for e in mapper.plan_log
                                          if e.get("object")),
               known_free_cells=int(mapper.planner._known_free.sum())
               if mapper.planner._known_free is not None else None,
               covered_cells=int(mapper.planner.covered.sum())
               if mapper.planner.covered is not None else None,
               **{f"launches_{k}": v for k, v in launches.items()})
    for name in ("object_tracking", "occupancy", "recon_metric",
                 "obj_recon_metric", "plan.object", "planning",
                 "tracking_mapping"):
        if name in timing:
            row[f"{name.replace('.', '_')}_s"] = timing[name]["total_s"]
    if result["steps"] != KNOWN_ENV_STEPS:
        raise AssertionError(f"the known-env episode ended at step "
                             f"{result['steps']} ({result['done_reason']})")
    if rec["found"] is None or mapper.obj_slam is None:
        raise AssertionError("the known-env episode found no object")
    if row["object_planning_events"] < 1:
        raise AssertionError("the known-env episode ran no object planning "
                             "event")
    if launches["nn1"] < KNOWN_ENV_STEPS:
        raise AssertionError(f"nn1 launched {launches['nn1']} times in "
                             f"{KNOWN_ENV_STEPS} steps")
    if min(launches[k] for k in ("blend", "blend_bwd")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    inv_k = np.linalg.inv(mapper.sim.intrinsics).astype(np.float32)
    known = np.asarray(mapper.known_env_points, np.float32)
    masks = [novelty_card_check(known, f, inv_k) for f in rec["frames"]]
    if len(masks) != 3:
        raise AssertionError(f"{len(masks)} novelty frames captured")
    row["novelty_frames"] = masks
    return row


def run_navigation(log_dir):
    """The port's navigation entry point (cli.run_navigation, as `python
    -m fisher_nerf_customized_tpu_torch.main_navigation` runs it) on SCENE
    for NAV_STEPS steps, on the card: its row, the navigator and the
    1-NN launches; the final recon is held to cKDTree's on the same
    cloud."""
    import torch
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.ops import cuda_knn
    args = cli.build_parser().parse_args([
        "--slam_config", os.path.join(HERE, "configs",
                                      "mp3d_gaussian_FR_eccv.yaml"),
        "--scenes_list", SCENE, "--max_steps", str(NAV_STEPS),
        "--log_dir", log_dir, "--name", "navigation"])
    cfg = cli.load_config(args)
    cuda_knn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, nav = cli.run_navigation(args, cfg, SCENE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = cuda_knn.launches
    recon = result["recon"]
    row = dict(steps=result["steps"], done_reason=result["done_reason"],
               wall_s=wall_s, steps_per_s=result["steps"] / wall_s,
               auc=result["auc"], launches_nn1=launches,
               n_points=nav.global_pcl.n_points(),
               **{f"recon_{k}": v for k, v in recon.items()})
    if result["steps"] != NAV_STEPS:
        raise AssertionError(f"the navigation ended at step "
                             f"{result['steps']} ({result['done_reason']})")
    if launches <= 0:
        raise AssertionError("the navigation launched no 1-NN kernel")
    curve = [s["completeness_ratio"] for s in nav.metrics.steps]
    if not np.isfinite(list(recon.values())).all() or \
            any(b < a for a, b in zip(curve, curve[1:])):
        raise AssertionError(f"navigation recon {recon}, curve {curve}")
    check = recon_card_check(nav.global_pcl.get(), cli._sample_gt(nav.scene),
                             0.05, nav.scene.surface_distance)
    for k, v in recon.items():
        if abs(v - check[f"card_{k}"]) > 1e-9 * max(abs(v), 1e-300):
            raise AssertionError(f"navigation recon {recon} off the "
                                 f"one-shot check {check}")
    row.update(completeness_curve=curve,
               **{f"check_{k}": v for k, v in check.items()
                  if not k.startswith("card_") or k == "card_s"})
    return row, nav


def run_tracking(log_dir):
    """The port's entry point with optimized tracking (`--set
    tracking.use_gt_poses False`) on SCENE for TRACK_STEPS steps, on the
    card (no evaluation): (result, mapper, row).  The launch counts are
    zeroed just before and read just after; GaussianSLAM._track_pose is
    wrapped here (a CUDA sync on each side) to time it and count its K1
    and K2 launches, and _tracking_phase to count the phases and the
    doubled ones.  Fails on a non-finite pose, or when the position errors
    of the first four tracked frames part from the JAX package's on the
    same frames (JAX_SCAN_ERRORS_M) by more than SCAN_ATOL_M.  With the
    shipped settings the reference's tracking drifts on the init scan's
    10-degree turns, and so does the port's: the drift is reported, not
    gated."""
    import torch
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.engine.eval import evaluate_ate
    from fisher_nerf_customized_tpu_torch.models import slam as tslam
    from fisher_nerf_customized_tpu_torch.ops import (cuda_blend,
                                                      cuda_blend_bwd)
    args = cli.build_parser().parse_args([
        "--slam_config", os.path.join(HERE, "configs",
                                      "mp3d_gaussian_FR_eccv.yaml"),
        "--scenes_list", SCENE, "--max_steps", str(TRACK_STEPS),
        "--eval_poses", "0", "--log_dir", log_dir, "--name", "tracking",
        "--set", "tracking.use_gt_poses", "False"])
    cfg = cli.load_config(args)
    base_iters = int(cfg.tracking.num_iters)
    cls = tslam.GaussianSLAM
    track_fn, rgbd_fn, phase_fn = (cls._track_pose, cls.track_rgbd,
                                   tslam._tracking_phase)
    rec = dict(seconds=0.0, frames=0, phases=0, doubled=0, k1=0, k2=0,
               gt_w2c=[])

    def tracking(self, color, depth):
        torch.cuda.synchronize()
        k1, k2 = cuda_blend.launches, cuda_blend_bwd.launches
        t0 = time.perf_counter()
        out = track_fn(self, color, depth)
        torch.cuda.synchronize()
        rec["seconds"] += time.perf_counter() - t0
        rec["frames"] += 1
        rec["k1"] += cuda_blend.launches - k1
        rec["k2"] += cuda_blend_bwd.launches - k2
        return out

    def phases(*a, **kw):
        rec["phases"] += 1
        rec["doubled"] += int(a[-1].num_iters != base_iters)
        return phase_fn(*a, **kw)

    def recording(self, color, depth, gt_w2c=None, action=None):
        if self.initialized:
            rec["gt_w2c"].append(np.asarray(gt_w2c, np.float32))
        return rgbd_fn(self, color, depth, gt_w2c, action)

    cls._track_pose, cls.track_rgbd = tracking, recording
    tslam._tracking_phase = phases
    try:
        result, mapper, wall_s, launches = timed_entry_point(args, cfg,
                                                             SCENE)
    finally:
        cls._track_pose, cls.track_rgbd = track_fn, rgbd_fn
        tslam._tracking_phase = phase_fn
    est = np.stack(mapper.slam.poses_w2c)
    gt = np.stack([est[0]] + rec["gt_w2c"])
    if est.shape != gt.shape or not np.isfinite(est).all():
        raise AssertionError(f"tracking: {est.shape} poses against "
                             f"{gt.shape}, finite: {np.isfinite(est).all()}")
    est_c2w, gt_c2w = np.linalg.inv(est), np.linalg.inv(gt)
    err = np.linalg.norm(est_c2w[:, :3, 3] - gt_c2w[:, :3, 3], axis=1)
    cos = (np.einsum("nij,nij->n", est_c2w[:, :3, :3], gt_c2w[:, :3, :3])
           - 1.0) / 2.0
    row = dict(steps=result["steps"], done_reason=result["done_reason"],
               wall_s=wall_s, track_s=rec["seconds"],
               tracked_frames=rec["frames"],
               ms_per_tracked_frame=rec["seconds"] * 1e3 / max(rec["frames"],
                                                              1),
               phases=rec["phases"], doubled_phases=rec["doubled"],
               k1_launches_tracking=rec["k1"],
               k2_launches_tracking=rec["k2"],
               ate_m=evaluate_ate(gt_c2w, est_c2w),
               max_trans_err_m=float(err.max()),
               mean_trans_err_m=float(err.mean()),
               max_rot_err_deg=float(np.degrees(np.arccos(
                   np.clip(cos, -1.0, 1.0))).max()),
               scan_errors_m=[float(e) for e in err[1:5]],
               scan_err_off_jax_m=float(np.abs(
                   err[1:5] - np.asarray(JAX_SCAN_ERRORS_M)).max()),
               planning_events=result["planning_events"],
               n_gaussians=result["n_gaussians"],
               **{f"launches_{k}": v for k, v in launches.items()})
    if result["steps"] != TRACK_STEPS or rec["frames"] != TRACK_STEPS:
        raise AssertionError(f"tracking: {result['steps']} steps, "
                             f"{rec['frames']} tracked frames")
    if min(launches["blend"], launches["blend_bwd"], rec["k1"],
           rec["k2"]) <= 0:
        raise AssertionError(f"tracking: K1 or K2 not launched: {row}")
    if not row["scan_err_off_jax_m"] <= SCAN_ATOL_M:
        raise AssertionError(f"tracking: the init scan's position errors "
                             f"{err[1:5]} part from the JAX package's "
                             f"{JAX_SCAN_ERRORS_M}")
    return result, mapper, row


def shifted_start(w2c, dev):
    """w2c moved by TRACK_SHIFT and turned about 1 degree about y, as a
    (q, t) pair on dev."""
    import torch
    from fisher_nerf_customized_tpu_torch.utils.geometry import (
        rotmat_to_quat)
    c, s = np.cos(0.017), np.sin(0.017)
    w2c = np.asarray(w2c, np.float32).copy()
    w2c[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                           np.float32) @ w2c[:3, :3]
    w2c[:3, 3] += TRACK_SHIFT
    return (rotmat_to_quat(torch.as_tensor(w2c[:3, :3], device=dev)),
            torch.as_tensor(w2c[:3, 3], device=dev))


def check_tracking(probe):
    """On the probe map at its latest keyframe, from a pose moved by
    TRACK_SHIFT: the first tracking step's loss and (q, t) gradient, and
    one _tracking_phase of TRACK_CHECK_ITERS steps, on the card and on the
    CPU (the plain twins, the state and frame moved there).  The
    per-step losses agree to rtol 1e-3, the best (q, t) within
    2 lr x steps per coordinate (Adam's sign-flip bound), the gradient
    to 1e-3 of its norm.  Times one tracking step (K1 + K2 + autograd +
    Adam: a one-step phase) and one phase of the config's steps, each the
    median of 5 calls between synchronizes."""
    import torch
    from fisher_nerf_customized_tpu_torch.models import slam as tslam
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        GaussianState)
    from fisher_nerf_customized_tpu_torch.ops import (cuda_blend,
                                                      cuda_blend_bwd)
    dev = probe.device
    i = len(probe.keyframes) - 1
    color = probe.keyframes.color_dev(i, dev)
    depth = probe.keyframes.depth_dev(i, dev)
    q0, t0 = shifted_start(probe.keyframes.w2cs[i], dev)
    tc = probe.tc._replace(num_iters=TRACK_CHECK_ITERS)
    cpu_state = GaussianState(*(x.cpu() for x in probe.state))
    runs = {}
    for name, state, d in (("card", probe.state, dev),
                           ("cpu", cpu_state, torch.device("cpu"))):
        q = q0.to(d).clone().requires_grad_()
        t = t0.to(d).clone().requires_grad_()
        loss, _dl = tslam._tracking_loss(q, t, state.params(), state.n_active,
                                         color.to(d), depth.to(d),
                                         probe.camera, probe.settings, tc)
        grad = torch.cat(torch.autograd.grad(loss, [q, t])).cpu().numpy()
        loss = loss.detach()
        best_q, best_t, best_loss, depth_l, losses = tslam._tracking_phase(
            state, q0.to(d), t0.to(d), color.to(d), depth.to(d),
            probe.camera, probe.settings, tc)
        runs[name] = dict(loss=float(loss), grad=grad,
                          best=np.concatenate([best_q.cpu().numpy(),
                                               best_t.cpu().numpy()]),
                          best_loss=float(best_loss),
                          losses=losses.cpu().numpy())
    card, cpu = runs["card"], runs["cpu"]
    loss_rel = np.abs(card["losses"] - cpu["losses"]) / np.abs(cpu["losses"])
    grad_rel = float(np.linalg.norm(card["grad"] - cpu["grad"])
                     / np.linalg.norm(cpu["grad"]))
    pose_err = np.abs(card["best"] - cpu["best"])
    bound = 2 * TRACK_CHECK_ITERS * np.array([tc.lr_rot] * 4
                                             + [tc.lr_trans] * 3)
    if not (loss_rel.max() <= 1e-3 and grad_rel <= 1e-3
            and (pose_err <= bound).all()
            and card["best_loss"] < card["losses"][0]):
        raise AssertionError(f"tracking on the card off the CPU's: loss rel "
                             f"{loss_rel.tolist()}, gradient rel {grad_rel}, "
                             f"pose err {pose_err.tolist()} of "
                             f"{bound.tolist()}, card {card}, cpu {cpu}")

    def timed(n_iters):
        tcn = probe.tc._replace(num_iters=n_iters)
        out = []
        for _ in range(6):
            torch.cuda.synchronize()
            a = time.perf_counter()
            tslam._tracking_phase(probe.state, q0, t0, color, depth,
                                  probe.camera, probe.settings, tcn)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - a) * 1e3)
        return float(np.median(out[1:]))

    k1, k2 = cuda_blend.launches, cuda_blend_bwd.launches
    step_ms = timed(1)
    step_k1 = (cuda_blend.launches - k1) // 6
    step_k2 = (cuda_blend_bwd.launches - k2) // 6
    return dict(iters=TRACK_CHECK_ITERS, n_active=probe.n_active,
                max_per_tile=probe.settings.max_per_tile,
                loss_first=float(card["losses"][0]),
                best_loss=card["best_loss"],
                loss_rel_err_max=float(loss_rel.max()),
                grad_rel_err=grad_rel,
                pose_err_q_max=float(pose_err[:4].max()),
                pose_err_t_max=float(pose_err[4:].max()),
                step_ms=step_ms, step_k1=step_k1, step_k2=step_k2,
                phase_iters=int(probe.tc.num_iters),
                phase_ms=timed(int(probe.tc.num_iters)))


def slam_copy(slam, device):
    """A shallow copy of a GaussianSLAM with its state on `device`: what a
    method replaces (the state, caches) stays the copy's."""
    import copy
    import torch
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        GaussianState)
    out = copy.copy(slam)
    out.device = torch.device(device)
    out.state = GaussianState(*(x.to(device) for x in slam.state))
    return out


def unexplained_seen(state, w2cs, camera, slots):
    """Of the slots whose seen flag differs between the card and the CPU,
    those that sit at no culling boundary at any pose (on the CPU: z
    within 1e-4 of the near plane, or one of the on-screen tests within 1
    pixel of its threshold, where a last-bit difference in the mean or the
    radius's ceil flips it)."""
    import torch
    from fisher_nerf_customized_tpu_torch.ops.projection import preprocess
    if len(slots) == 0:
        return []
    idx = torch.as_tensor(slots)
    w2cs = torch.as_tensor(w2cs)
    mc = state.means3D[idx] @ w2cs[:, :3, :3].transpose(-1, -2) \
        + w2cs[:, None, :3, 3]
    nb = mc.shape[0]
    prep = preprocess(mc, torch.exp(state.log_scales[idx]).expand(nb, -1, 3),
                      state.unnorm_rotations[idx].expand(nb, -1, 4), camera)
    mid = 0.5 * (prep.cov2d[..., 0] + prep.cov2d[..., 2])
    det = prep.cov2d[..., 0] * prep.cov2d[..., 2] - prep.cov2d[..., 1] ** 2
    r = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(
        mid * mid - det, min=0.1))))
    u, v = prep.mean2d.unbind(-1)
    edge = torch.stack([u + r, camera.width - (u - r), v + r,
                        camera.height - (v - r)], -1).abs().amin(-1) <= 1.0
    near = (prep.depth - camera.near).abs() <= 1e-4
    explained = (edge | near).any(dim=0)
    return [int(s) for s, ok in zip(slots, explained.tolist()) if not ok]


def check_slam_settings(probe):
    """gs_densify, _seen_from_poses and prune_invisible on copies of the
    probe map, on the card against the CPU twin (the probe itself is left
    as it is).  gs_densify gets one shared draw and seeded statistics
    (every live slot counted once, a gradient uniform in [0, 1.25] x
    grad_thresh): n_active exact, parameters rtol 1e-5 with atol 1e-5 of
    each field's largest value (the children's offsets are summed in
    another order on each device).  The keyframes' seen mask: the slots
    that differ are reported and each must sit at a culling boundary
    (unexplained_seen).  prune_invisible over the keyframes: the removed
    count on each."""
    import torch
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        PARAM_KEYS)
    dev = probe.device
    dd = probe.cfg.mapping.densify_dict
    thresh = float(dd.grad_thresh)
    gen = torch.Generator().manual_seed(0)
    cap, n = probe.state.capacity, probe.n_active
    ga = torch.rand(cap, generator=gen) * 1.25 * thresh
    dn = (torch.arange(cap) < n).float()
    shared = {}

    def draw(time_idx, n_children, shape, device):
        """The card's draw, made once and handed to both copies (which
        grow to the same capacity)."""
        if "noise" not in shared:
            shared["noise"] = probe.densify_draw(time_idx, n_children, shape)
        return shared["noise"].to(device)

    out = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        sl = slam_copy(probe, d)
        sl.densify_draw = functools.partial(draw, device=d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sl._gs_densify(ga.to(d), dn.to(d), probe.frame_idx)
        torch.cuda.synchronize()
        out[name] = dict(slam=sl, densify_ms=(time.perf_counter() - t0) * 1e3)
    card, cpu = out["card"]["slam"], out["cpu"]["slam"]
    nd = card.n_active
    if nd != cpu.n_active or nd == n:
        raise AssertionError(f"gs_densify: n_active {n} -> card {nd}, cpu "
                             f"{cpu.n_active}")
    for k in PARAM_KEYS + ("timestep",):
        got = getattr(card.state, k)[:nd].cpu()
        ref = getattr(cpu.state, k)[:nd]
        if not torch.allclose(got, ref, rtol=1e-5,
                              atol=1e-5 * float(ref.abs().max())):
            raise AssertionError(f"gs_densify {k}: max err "
                                 f"{float((got - ref).abs().max())}")

    kf = probe.keyframes.stacked_w2cs()
    seen = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        sl = slam_copy(probe, d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen[name] = sl._seen_mask(kf)[:n].cpu()
        torch.cuda.synchronize()
        seen[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        seen[f"{name}_removed"] = sl.prune_invisible()
        torch.cuda.synchronize()
        seen[f"{name}_prune_ms"] = (time.perf_counter() - t0) * 1e3
    differ = torch.nonzero(seen["card"] != seen["cpu"]).flatten().tolist()
    cpu_probe = slam_copy(probe, "cpu")
    bad = unexplained_seen(cpu_probe.state, kf, probe.camera, differ)
    if bad:
        raise AssertionError(f"seen from the keyframes: slots {bad} differ "
                             f"between the card and the CPU at no culling "
                             f"boundary")
    return dict(n_active=n, densified_n_active=nd,
                densify_ms=out["card"]["densify_ms"],
                densify_cpu_ms=out["cpu"]["densify_ms"],
                keyframes=len(kf), seen=int(seen["card"].sum()),
                seen_differ=len(differ), seen_ms=seen["card_ms"],
                removed=seen["card_removed"],
                removed_cpu=seen["cpu_removed"],
                prune_ms=seen["card_prune_ms"])


def run_upen_episode(log_dir):
    """The UPEN baseline through the entry point
    (configs/mp3d_gaussian_UPEN_fbe.yaml) on SCENE for UPEN_STEPS steps, on
    the card, no evaluation.  UPEN.observe and UPEN.predict_action are
    wrapped here (a CUDA sync on each side) to time them; the observe
    wrapper keeps the last frame and the grid before it.  Fails unless
    the episode reaches its end, K1 and K2 run and UPEN replans at least
    MIN_UPEN_REPLANS times.  Returns (result, mapper, row, record)."""
    import torch
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.models import upen as tupen
    args = cli.build_parser().parse_args([
        "--slam_config", os.path.join(HERE, "configs",
                                      "mp3d_gaussian_UPEN_fbe.yaml"),
        "--scenes_list", SCENE, "--max_steps", str(UPEN_STEPS),
        "--eval_poses", "0", "--log_dir", log_dir, "--name", "upen"])
    cfg = cli.load_config(args)
    cls = tupen.UPEN
    observe_fn, predict_fn = cls.observe, cls.predict_action
    rec = dict(observe_s=0.0, observes=0, predict_s=0.0, modes=[],
               last=None)

    def observe(self, depth, intrinsics, pose, cam_height=1.25):
        rec["last"] = dict(grid=self.sgrid.proj_grid.clone(),
                           depth=torch.as_tensor(depth).clone(),
                           intrinsics=np.asarray(intrinsics), pose=pose,
                           cam_height=cam_height)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = observe_fn(self, depth, intrinsics, pose, cam_height)
        torch.cuda.synchronize()
        rec["observe_s"] += time.perf_counter() - t0
        rec["observes"] += 1
        return out

    def predict(self, pose):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        goal, info = predict_fn(self, pose)
        torch.cuda.synchronize()
        rec["predict_s"] += time.perf_counter() - t0
        rec["modes"].append(info["mode"])
        return goal, info

    cls.observe, cls.predict_action = observe, predict
    try:
        result, mapper, wall_s, launches = timed_entry_point(args, cfg, SCENE)
    finally:
        cls.observe, cls.predict_action = observe_fn, predict_fn
    n_pred = len(rec["modes"])
    row = dict(steps=result["steps"], done_reason=result["done_reason"],
               wall_s=wall_s, steps_per_s=result["steps"] / wall_s,
               upen_replans=n_pred,
               upen_replans_with_path=result["planning_events"],
               ms_per_observe=rec["observe_s"] * 1e3 / max(rec["observes"], 1),
               ms_per_predict_action=rec["predict_s"] * 1e3 / max(n_pred, 1),
               modes=",".join(sorted(set(rec["modes"]))),
               coverage_2d_pct=result["coverage_2d_pct"],
               n_gaussians=result["n_gaussians"],
               **{f"launches_{k}": v for k, v in launches.items()})
    if result["steps"] != UPEN_STEPS or rec["observes"] != UPEN_STEPS:
        raise AssertionError(f"the UPEN episode ended at step "
                             f"{result['steps']} ({result['done_reason']}), "
                             f"{rec['observes']} observes")
    if n_pred < MIN_UPEN_REPLANS:
        raise AssertionError(f"{n_pred} UPEN replans, expected >= "
                             f"{MIN_UPEN_REPLANS}")
    if min(launches["blend"], launches["blend_bwd"]) <= 0:
        raise AssertionError(f"UPEN episode: K1 or K2 not launched: "
                             f"{launches}")
    if not 0.0 < result["coverage_2d_pct"] <= 100.0:
        raise AssertionError(f"coverage {result['coverage_2d_pct']}")
    if not bool(torch.isfinite(mapper.upen.sgrid.proj_grid).all()):
        raise AssertionError("non-finite UPEN grid")
    return result, mapper, row, rec


def cpu_upen(upen):
    """A copy of a UPEN on the CPU: its members' weights, its grid and its
    generator state."""
    from fisher_nerf_customized_tpu_torch.models.upen import UPEN
    out = UPEN(options=None, n_members=len(upen.ensemble.members),
               grid_dim=upen.sgrid.grid_dim, crop=upen.crop,
               cell_size=upen.cell_size, use_rrt=upen.use_rrt, device="cpu")
    for a, b in zip(out.ensemble.members, upen.ensemble.members):
        a.model.load_state_dict({k: v.cpu() for k, v in
                                 b.model.state_dict().items()})
    out.sgrid.origin_pose = upen.sgrid.origin_pose.copy()
    out.sgrid.proj_grid = upen.sgrid.proj_grid.cpu()
    out.step_count = upen.step_count
    out.rng.bit_generator.state = upen.rng.bit_generator.state
    return out


def check_upen(mapper, rec, log_dir):
    """On the UPEN episode's final state: the ensemble forward on the card
    (TF32 off) against the same weights on the CPU, the last frame's ego
    grid and register_ego on the card against the CPU, predict_action in
    RRT mode from one generator state on both, the 4-member forward and a
    batch-8 train_step timed, and tools/train_predictors.py at a small
    size (its losses finite, its saved ensemble loaded into a fresh UPEN
    predicting as the trained one).  Returns the phase's row."""
    import torch
    from fisher_nerf_customized_tpu_torch.models import predictors
    from fisher_nerf_customized_tpu_torch.models.semantic_grid import (
        SemanticGrid)
    from fisher_nerf_customized_tpu_torch.models.upen import (
        UPEN, ego_grid_from_depth)
    from fisher_nerf_customized_tpu_torch.tools import train_predictors
    upen, dev = mapper.upen, mapper.device
    host = cpu_upen(upen)
    pose = mapper._pose_xzyaw(np.asarray(mapper.sim.c2w, np.float64))
    x = upen.sgrid.crop_at(pose, upen.crop).permute(1, 2, 0)[None]
    with torch.no_grad():
        card = [m.logits(x).cpu() for m in upen.ensemble.members]
        ref = [m.logits(x.cpu()) for m in host.ensemble.members]
    fwd_err = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(card, ref))
    row = dict(forward_rel_err=fwd_err)

    last = rec["last"]
    grids = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        g = SemanticGrid(grid_dim=upen.sgrid.grid_dim,
                         cell_size=upen.cell_size, device=d)
        g.origin_pose = upen.sgrid.origin_pose
        g.proj_grid = last["grid"].to(d)
        ego = ego_grid_from_depth(last["depth"].to(d), last["intrinsics"],
                                  grid_dim=upen.crop,
                                  cell_size=upen.cell_size,
                                  cam_height=last["cam_height"])
        grids[tag] = (ego.cpu(), g.register_ego(ego, last["pose"]).cpu())
    (ego_c, grid_c), (ego_h, grid_h) = grids["card"], grids["cpu"]
    row.update(ego_equal=bool(torch.equal(ego_c, ego_h)),
               register_max_diff=float((grid_c - grid_h).abs().max()),
               register_argmax_cells_differ=int(
                   (grid_c.argmax(0) != grid_h.argmax(0)).sum()),
               register_equals_episode=bool(torch.equal(
                   grid_c, upen.sgrid.proj_grid.cpu())))

    use_rrt, state = upen.use_rrt, upen.rng.bit_generator.state
    goals = []
    for u in (upen, host):
        u.use_rrt = True
        u.rng.bit_generator.state = state
        goal, info = u.predict_action(pose)
        goals.append((np.asarray(goal).tolist(), info))
    upen.use_rrt, upen.rng.bit_generator.state = use_rrt, state
    row.update(rrt_goal_card=goals[0][0], rrt_goal_cpu=goals[1][0],
               rrt_same_goal=goals[0] == goals[1],
               rrt_paths=goals[0][1].get("n_paths"))

    row["ensemble4_forward_ms"] = cuda_ms(
        lambda: upen.ensemble.predict(x), 20)
    pred = predictors.OccupancyPredictor(predictors.member_generator(0, 0),
                                         device=dev)
    x8 = x.repeat(8, 1, 1, 1)
    y8 = x8.argmax(-1)

    def train_step():
        pred.train_step(x8, y8)                    # ends in a sync

    train_step()
    t0 = time.perf_counter()
    for _ in range(10):
        train_step()
    row["train_step_b8_ms"] = (time.perf_counter() - t0) * 1e2

    out_dir = os.path.join(log_dir, "upen_trainer")
    trained = {}
    save_fn = predictors.PredictorEnsemble.save

    def saving(self, dir_path):
        trained["ens"] = self
        return save_fn(self, dir_path)

    predictors.PredictorEnsemble.save = saving
    try:
        t0 = time.perf_counter()
        out = train_predictors.main([
            "--out_dir", out_dir, "--n_scenes", "1", "--steps_per_scene",
            "20", "--epochs", "1", "--ensemble_size", "2",
            "--device", str(dev)])
        row["trainer_s"] = time.perf_counter() - t0
    finally:
        predictors.PredictorEnsemble.save = save_fn
    fresh = UPEN(options=None, n_members=2, seed=9, ensemble_dir=out_dir,
                 device=dev)
    with torch.no_grad():
        a = fresh.ensemble.predict(x)
        b = trained["ens"].predict(x)
    row.update(trainer_losses=out["final_losses"],
               trainer_val_miou=out["val_miou"],
               trainer_n_train=out["n_train"],
               trainer_reload_max_diff=max(float((p - q).abs().max())
                                           for p, q in zip(a[:2], b[:2])))
    if not fwd_err <= 1e-4:
        raise AssertionError(f"ensemble forward on the card off the CPU by "
                             f"{fwd_err} (relative)")
    if not np.isfinite(out["final_losses"]).all():
        raise AssertionError(f"trainer losses {out['final_losses']}")
    if row["trainer_reload_max_diff"] > 1e-6:
        raise AssertionError(f"the saved ensemble predicts apart from the "
                             f"trained one: {row['trainer_reload_max_diff']}")
    return row


def run_dino_episode(log_dir, steps=DINO_STEPS, dino_weights=None):
    """The object branch with the DINO gate through the entry point
    (--object_scene --dynamic_scene --dino_gate, or --dino_weights with a
    ViT checkpoint) on OBJECT_SCENE for `steps` steps, on the card, no
    evaluation.  Fails unless K1 and K2 run and the bank holds at least
    the init frame.  Returns the phase's row."""
    from fisher_nerf_customized_tpu_torch import cli
    gate_args = (["--dino_weights", dino_weights] if dino_weights
                 else ["--dino_gate"])
    args = cli.build_parser().parse_args([
        "--slam_config", os.path.join(HERE, "configs",
                                      "mp3d_gaussian_FR_eccv.yaml"),
        "--scenes_list", OBJECT_SCENE, "--max_steps", str(steps),
        "--object_scene", "--dynamic_scene", *gate_args,
        "--eval_poses", "0", "--log_dir", log_dir,
        "--name", "dino_vit" if dino_weights else "dino"])
    cfg = cli.load_config(args)
    result, mapper, wall_s, launches = timed_entry_point(args, cfg,
                                                         OBJECT_SCENE)
    log = mapper.dino_log
    gate = result["timing"].get("dino_gate", {})
    row = dict(steps=result["steps"], wall_s=wall_s,
               decisions=len(log), accepted=sum(a for _t, a in log),
               vetoed=sum(not a for _t, a in log),
               bank_size=len(mapper.dino_bank) if mapper.dino_bank else 0,
               ms_per_gate_decision=gate.get("mean_ms"),
               object_n_active=(mapper.obj_slam.n_active
                                if mapper.obj_slam is not None else 0),
               **{f"launches_{k}": v for k, v in launches.items()})
    if dino_weights:
        from fisher_nerf_customized_tpu_torch.models.perceptual import (
            ViTPatchExtractor)
        if not isinstance(mapper._dino_extractor, ViTPatchExtractor):
            raise AssertionError("--dino_weights did not gate with the ViT")
        row["extractor_device"] = str(mapper._dino_extractor.device)
    if result["steps"] != steps:
        raise AssertionError(f"the DINO episode ended at step "
                             f"{result['steps']} ({result['done_reason']})")
    if min(launches["blend"], launches["blend_bwd"]) <= 0:
        raise AssertionError(f"DINO episode: K1 or K2 not launched: "
                             f"{launches}")
    if not log or not log[0][1] or row["bank_size"] < 1:
        raise AssertionError(f"DINO gate: decisions {log}, bank "
                             f"{row['bank_size']}")
    return row


def random_lpips_checkpoint(path, seed=0):
    """A full lpips.LPIPS state_dict at AlexNet's widths (net.sliceK.J.*,
    lin<i>.model.1.weight, scaling_layer.*) with random weights from
    `seed` (He-scaled convolutions, non-negative lins), torch.save'd."""
    import torch
    from fisher_nerf_customized_tpu_torch.models.perceptual import (
        _ALEX_CONVS, _SCALE, _SHIFT, ALEX_WIDTHS)
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    sd, cin = {}, 3
    for sl, ((idx, k, _s, _p), cout) in enumerate(zip(_ALEX_CONVS,
                                                      ALEX_WIDTHS), 1):
        sd[f"net.slice{sl}.{idx}.weight"] = t(
            rng.normal(size=(cout, cin, k, k)) * np.sqrt(2.0 / (cin * k * k)))
        sd[f"net.slice{sl}.{idx}.bias"] = t(rng.normal(size=cout) * 0.1)
        cin = cout
    for i, c in enumerate(ALEX_WIDTHS):
        sd[f"lin{i}.model.1.weight"] = t(np.abs(rng.normal(
            size=(1, c, 1, 1))) * 0.1)
    sd["scaling_layer.shift"] = t(_SHIFT[None, :, None, None])
    sd["scaling_layer.scale"] = t(_SCALE[None, :, None, None])
    torch.save(sd, path)


def random_vit_checkpoint(path, seed=1):
    """A ViT-S/14 at DINOv2's widths (D 384, 12 blocks, a 37 x 37
    position grid, LayerScale) with random weights from `seed`, saved as
    DINOv2 does ({"model": state_dict})."""
    import torch
    from fisher_nerf_customized_tpu_torch.models.perceptual import DinoViT
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in DinoViT().state_dict().items():
        if k.endswith("gamma"):
            x = rng.uniform(0.05, 0.3, v.shape)
        elif "norm" in k and k.endswith("weight"):
            x = 1.0 + 0.1 * rng.normal(size=v.shape)
        else:
            x = 0.02 * rng.normal(size=v.shape)
        sd[k] = torch.from_numpy(np.asarray(x, np.float32))
    torch.save({"model": sd}, path)


def check_perceptual(ckpt_dir):
    """LPIPS(alex) and the ViT-S/14 at their real widths, random weights
    written as checkpoints and loaded through the port's loaders: the
    card against the same modules on the CPU on PERCEPTUAL_PAIRS image
    pairs at PERCEPTUAL_SIZE² (LPIPS rel 1e-4; the ViT's tokens within
    1e-4 of their largest; ViTPatchExtractor's selection the same, its
    descriptors within 1e-4), timed (TF32 off inside the modules).
    Returns (row, LPIPS checkpoint, ViT checkpoint)."""
    import torch
    from fisher_nerf_customized_tpu_torch.models.perceptual import (
        DinoViT, LPIPSAlex, ViTPatchExtractor, load_torch_lpips,
        load_torch_vit)
    os.makedirs(ckpt_dir, exist_ok=True)
    lp_path = os.path.join(ckpt_dir, "lpips_alex.pth")
    vit_path = os.path.join(ckpt_dir, "dinov2_vits14.pth")
    random_lpips_checkpoint(lp_path)
    random_vit_checkpoint(vit_path)
    lp_params = load_torch_lpips(lp_path)
    vit_params, heads = load_torch_vit(vit_path)
    lp_cpu = LPIPSAlex.from_flat(lp_params)
    lp_card = LPIPSAlex.from_flat(lp_params).to("cuda")
    vit_cpu = DinoViT.from_flat(vit_params, heads)
    vit_card = DinoViT.from_flat(vit_params, heads).to("cuda")
    rng = np.random.default_rng(2)
    n, size = PERCEPTUAL_PAIRS, PERCEPTUAL_SIZE
    # smooth images (noise blurred along the rows) and their perturbations
    a = np.cumsum(rng.normal(size=(n, size, size, 3)), axis=2)
    a = (a - a.min()) / (a.max() - a.min())
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    a_d, b_d = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    got = lp_card(a_d, b_d).cpu().numpy()
    ref = lp_cpu(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    lp_rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
    tok = vit_card(a_d).cpu().numpy()
    tok_ref = vit_cpu(torch.from_numpy(a)).numpy()
    tok_err = float(np.abs(tok - tok_ref).max())
    tok_max = float(np.abs(tok_ref).max())
    mask = np.zeros((size, size), bool)
    mask[size // 4: 3 * size // 4, size // 3: 2 * size // 3] = True
    ex_card = ViTPatchExtractor(vit_params, heads, device="cuda")
    ex_cpu = ViTPatchExtractor(vit_params, heads, device="cpu")
    d_card, d_cpu = ex_card(a[0], mask), ex_cpu(a[0], mask)
    row = dict(
        lpips_pairs=n, size=size, lpips_mean=float(ref.mean()),
        lpips_rel_err_max=lp_rel,
        lpips_ms_per_pair=cuda_ms(lambda: lp_card(a_d, b_d), 10) / n,
        vit_heads=heads, vit_tokens=list(tok.shape[1:]),
        vit_pos_grid=int(round(float(np.sqrt(
            vit_params["pos_embed"].shape[1] - 1)))),
        vit_err_max=tok_err, vit_largest=tok_max,
        vit_ms_per_call=cuda_ms(lambda: vit_card(a_d[:1]), 10),
        vit_ms_batch8=cuda_ms(lambda: vit_card(a_d), 5),
        extractor_patches=int(d_card.shape[0]),
        extractor_err_max=float(np.abs(d_card - d_cpu).max())
        if d_card.shape == d_cpu.shape else None)
    if not (heads == 6 and row["vit_pos_grid"] == 37
            and tok.shape[1:] == ((size // 14) ** 2, 384)):
        raise AssertionError(f"ViT-S/14 widths: {row}")
    if not (np.isfinite(got).all() and lp_rel <= 1e-4):
        raise AssertionError(f"LPIPS off the CPU: {got} vs {ref}")
    if not (np.isfinite(tok).all() and tok_err <= 1e-4 * tok_max):
        raise AssertionError(f"ViT tokens off the CPU by {tok_err} of "
                             f"{tok_max}")
    if (d_card.shape != d_cpu.shape or len(d_card) == 0
            or row["extractor_err_max"] > 1e-4):
        raise AssertionError(f"ViTPatchExtractor: card {d_card.shape}, "
                             f"CPU {d_cpu.shape}")
    return row, lp_path, vit_path


class _Quat:
    def __init__(self, w, x, y, z):
        self.w, self.x, self.y, self.z = w, x, y, z


def _agent_state(x, z, yaw, height=1.25):
    """habitat's AgentState shape: position, rotation (wxyz, a yaw about
    +y) and the rgb and depth sensors' states, all at the agent."""
    import types

    def one():
        return types.SimpleNamespace(
            position=np.array([x, height, z]),
            rotation=_Quat(np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0))
    st = one()
    st.sensor_states = {"rgb": one(), "depth": one()}
    return st


class MockHabitatSim:
    """The part of habitat_sim.Simulator that envs/habitat_adapter.py
    uses, over a BoxScene: the agent's state, its sensors' observations
    (FakeSim's raycast on the card at the rgb sensor's CV-frame c2w,
    handed back as habitat does: uint8 rgb and float32 (H, W, 1) depth
    on the host), the pathfinder (BoxScene.is_navigable and its
    navigable samples) and no objects."""

    def __init__(self, scene, camera, seed=0):
        import types
        from fisher_nerf_customized_tpu_torch.envs.fake_sim import FakeSim
        self._fake = FakeSim(scene, camera, device="cuda")
        self._state = _agent_state(0.0, 0.0, 0.0)
        self.agents = [types.SimpleNamespace(set_state=self._set_state)]
        rng = np.random.default_rng(seed)

        def random_point():
            x, z = scene.sample_navigable(rng, 1)[0]
            return np.array([x, 0.0, z])
        self.pathfinder = types.SimpleNamespace(
            is_navigable=scene.is_navigable,
            get_random_navigable_point=random_point)
        self.scene = scene

    def _set_state(self, state):
        self._state = state

    def get_agent_state(self):
        return self._state

    def get_sensor_observations(self):
        import torch
        from fisher_nerf_customized_tpu_torch.envs.habitat_adapter import (
            sensor_c2w)
        s = self._state.sensor_states["rgb"]
        q = s.rotation
        rgb, depth = self._fake.render_at(
            sensor_c2w(s.position, (q.w, q.x, q.y, q.z)))
        rgb = torch.round(torch.clamp(rgb, 0, 1) * 255).to(torch.uint8)
        return dict(rgb=rgb.cpu().numpy(), depth=depth.cpu().numpy()[..., None])


class MockHabitatEnv:
    """habitat.Env's surface: reset, step by action name (move_forward
    along the agent's -z unless the pathfinder blocks it, turn_left and
    turn_right about +y by the config's angle), seed."""

    def __init__(self, config, scene, camera):
        self.config = config
        self.sim = MockHabitatSim(scene, camera)
        self.steps = []

    def seed(self, s):
        self.seeded = s

    def reset(self):
        return self.sim.get_sensor_observations()

    def step(self, action):
        self.steps.append(action)
        st = self.sim.get_agent_state()
        yaw = 2.0 * np.arctan2(st.rotation.y, st.rotation.w)
        sim_cfg = self.config.habitat.simulator
        targets = [st] + list(st.sensor_states.values())
        if action == "move_forward":
            d = sim_cfg.forward_step_size
            dx, dz = -d * np.sin(yaw), -d * np.cos(yaw)
            if self.sim.pathfinder.is_navigable(
                    (st.position[0] + dx, 0.0, st.position[2] + dz)):
                for tg in targets:
                    tg.position[0] += dx
                    tg.position[2] += dz
        elif action in ("turn_left", "turn_right"):
            yaw += np.deg2rad(sim_cfg.turn_angle) * (
                1.0 if action == "turn_left" else -1.0)
            for tg in targets:
                tg.rotation = _Quat(np.cos(yaw / 2), 0.0, np.sin(yaw / 2),
                                    0.0)
        return self.sim.get_sensor_observations()


def mock_habitat_config():
    """The attribute tree of habitat's Hydra config that the adapter
    sets (apply_sensor_overrides)."""
    import types

    def tree(d):
        return types.SimpleNamespace(**{k: tree(v) if isinstance(v, dict)
                                        else v for k, v in d.items()})
    sensor = dict(width=640, height=480)
    return tree(dict(habitat=dict(
        environment=dict(max_episode_steps=500),
        dataset=dict(type="PointNav-v1", split="train"),
        simulator=dict(turn_angle=30, forward_step_size=0.25, scene="",
                       scene_dataset="", agents=dict(main_agent=dict(
                           sim_sensors=dict(rgb_sensor=dict(sensor),
                                            depth_sensor=dict(sensor))))))))


def run_habitat_episode(log_dir, lpips_path):
    """The port's entry point with --sim habitat --dataset MP3D on SCENE
    for HABITAT_STEPS steps, on the card, with a mock habitat module (its
    Env a MockHabitatEnv over the scene's BoxScene) and --lpips_weights:
    HabitatSim's observations uploaded each step, mapping events (K1, K2),
    planning events (K3), then the evaluation over HABITAT_EVAL_POSES
    poses through HabitatSim.render_at with LPIPS(alex) on each chunk.
    The scene has no ground-truth cloud, so no recon.  HabitatSim._upload
    is wrapped (a CUDA sync on each side) to time the host-to-device
    upload per frame.  Returns the phase's row and the result."""
    import types
    import torch
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.engine import eval as teval
    from fisher_nerf_customized_tpu_torch.envs import habitat_adapter
    from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene
    from fisher_nerf_customized_tpu_torch.ops.camera import Camera
    args = cli.build_parser().parse_args([
        "--slam_config", os.path.join(HERE, "configs",
                                      "mp3d_gaussian_FR_eccv.yaml"),
        "--sim", "habitat", "--dataset", "MP3D", "--scenes_list", SCENE,
        "--max_steps", str(HABITAT_STEPS),
        "--eval_poses", str(HABITAT_EVAL_POSES),
        "--lpips_weights", lpips_path, "--log_dir", log_dir,
        "--name", "habitat"])
    cfg = cli.load_config(args)
    calib = cfg.SLAM.Dataset.Calibration
    cam = Camera(fx=float(calib.fx), fy=float(calib.fy), cx=float(calib.cx),
                 cy=float(calib.cy), width=int(calib.width),
                 height=int(calib.height))
    scene = BoxScene.multi_room(seed=SCENE_SEED)
    envs = []

    def make_env(config):
        envs.append(MockHabitatEnv(config, scene, cam))
        return envs[-1]

    mock = types.ModuleType("habitat")
    mock.Env = make_env
    mock.get_config = lambda _path: mock_habitat_config()
    rec = dict(uploads=0, upload_s=0.0)
    upload = habitat_adapter.HabitatSim._upload

    def timed_upload(self, rgb, depth):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = upload(self, rgb, depth)
        torch.cuda.synchronize()
        rec["upload_s"] += time.perf_counter() - t0
        rec["uploads"] += 1
        return out

    sys.modules["habitat"] = mock
    habitat_adapter.HabitatSim._upload = timed_upload
    teval.set_lpips_weights(args.lpips_weights)
    try:
        result, mapper, wall_s, launches = timed_entry_point(args, cfg, SCENE)
    finally:
        teval.set_lpips_weights(None)
        habitat_adapter.HabitatSim._upload = upload
        del sys.modules["habitat"]
    ev = result.get("eval", {})
    timing = result["timing"]
    row = dict(steps=result["steps"], done_reason=result["done_reason"],
               wall_s=wall_s, steps_per_s=result["steps"] / wall_s,
               planning_events=result["planning_events"],
               coverage_2d_pct=result.get("coverage_2d_pct"),
               n_gaussians=result["n_gaussians"],
               env_steps=len(envs[0].steps) if envs else 0,
               eval_poses=ev.get("n_poses"), psnr=ev.get("psnr"),
               ssim=ev.get("ssim"), lpips_proxy=ev.get("lpips_proxy"),
               lpips=ev.get("lpips"), depth_mae=ev.get("depth_mae"),
               uploads=rec["uploads"],
               upload_ms_per_frame=rec["upload_s"] * 1e3
               / max(rec["uploads"], 1),
               **{f"{name.replace('.', '_')}_s": timing[name]["total_s"]
                  for name in ("tracking_mapping", "planning", "occupancy",
                               "sim_step", "eval", "habvis", "pcl")
                  if name in timing},
               **{f"launches_{k}": v for k, v in launches.items()})
    if result["steps"] != HABITAT_STEPS or row["env_steps"] != HABITAT_STEPS:
        raise AssertionError(f"the habitat episode ended at step "
                             f"{result['steps']} ({result['done_reason']}), "
                             f"{row['env_steps']} env steps")
    if result["planning_events"] < 1:
        raise AssertionError("the habitat episode ran no planning event")
    if min(launches[k] for k in ("blend", "blend_bwd", "fisher")) <= 0:
        raise AssertionError(f"habitat episode: a kernel was not launched: "
                             f"{launches}")
    if ev.get("n_poses") != HABITAT_EVAL_POSES or not all(
            np.isfinite(ev.get(k, np.nan))
            for k in ("psnr", "ssim", "lpips", "lpips_proxy", "depth_mae")):
        raise AssertionError(f"habitat episode eval: {ev}")
    if "recon" in result:
        raise AssertionError("a recon metric without a ground-truth cloud")
    return row, result


def png_size(path):
    """(width, height) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big"))


def run_nav_images(log_dir):
    """The FisherRF episode with policy.save_nav_images through the entry
    point on SCENE for NAV_IMAGES_STEPS steps, on the card, no evaluation:
    at least one planning event, K3 launched, planning_vis/plan_<t>.png
    for each planning event's step t and nav_images/topdown_<t>.png for
    t = 0 and 20, each PNG's IHDR the size of its map; then one
    render_bev timed and written as bev.png.  Returns the phase's row."""
    import torch
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.utils.raster import write_png
    args = cli.build_parser().parse_args([
        "--slam_config", os.path.join(HERE, "configs",
                                      "mp3d_gaussian_FR_eccv.yaml"),
        "--scenes_list", SCENE, "--max_steps", str(NAV_IMAGES_STEPS),
        "--eval_poses", "0", "--log_dir", log_dir, "--name", "nav_images",
        "--set", "policy.save_nav_images", "True"])
    cfg = cli.load_config(args)
    result, mapper, wall_s, launches = timed_entry_point(args, cfg, SCENE)
    planner, d = mapper.planner, mapper.eval_dir
    plan_size = (int(planner.grid_dim[0]), int(planner.grid_dim[1]))
    top_size = mapper.habvis.gt_free.shape[::-1]
    want = [(os.path.join(d, "planning_vis", f"plan_{e['t']:05d}.png"),
             plan_size) for e in mapper.plan_log]
    want += [(os.path.join(d, "nav_images", f"topdown_{t:05d}.png"),
              top_size) for t in (0, 20)]
    missing = [p for p, _s in want if not os.path.exists(p)]
    wrong = [(p, png_size(p), s) for p, s in want
             if os.path.exists(p) and png_size(p) != tuple(s)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bev = planner.render_bev(mapper.slam)["render"]
    torch.cuda.synchronize()
    bev_ms = (time.perf_counter() - t0) * 1e3
    img = (bev.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    write_png(os.path.join(d, "bev.png"), img)
    row = dict(steps=result["steps"], wall_s=wall_s,
               planning_events=result["planning_events"],
               plan_pngs=len(os.listdir(os.path.join(d, "planning_vis")))
               if os.path.isdir(os.path.join(d, "planning_vis")) else 0,
               topdown_pngs=len(os.listdir(os.path.join(d, "nav_images")))
               if os.path.isdir(os.path.join(d, "nav_images")) else 0,
               plan_png_size=plan_size, render_bev_ms=bev_ms,
               bev_mean=float(bev.mean()),
               **{f"launches_{k}": v for k, v in launches.items()})
    if result["steps"] != NAV_IMAGES_STEPS or result["planning_events"] < 1:
        raise AssertionError(f"nav_images: {result['steps']} steps, "
                             f"{result['planning_events']} planning events")
    if launches["fisher"] <= 0:
        raise AssertionError(f"nav_images: K3 not launched: {launches}")
    if missing or wrong:
        raise AssertionError(f"nav_images: missing {missing}, sizes {wrong}")
    if not bool(torch.isfinite(bev).all()):
        raise AssertionError("non-finite render_bev")
    return row


def run_pipelined_episode(log_dir, sync_timing, sync_wall_s):
    """The FisherRF episode with tpu.pipeline_planning through the entry
    point on SCENE for EPISODE_STEPS steps, on the card, no evaluation;
    then a prefetched frame against a plain FakeSim's step at the same
    pose, for four actions (to the bit).  Fails unless the episode reaches
    its end, a stage-1 preparation and a prefetched frame were taken, K1,
    K2, K3 (both widths) and the 1-NN ran, and the frames are equal.
    Returns (result, mapper, row): the row has the synchronous episode's
    PIPE_PHASES (`sync_timing`) and its wall time less its evaluation
    beside the pipelined one's."""
    import torch
    from fisher_nerf_customized_tpu_torch import cli
    args = cli.build_parser().parse_args([
        "--slam_config", os.path.join(HERE, "configs",
                                      "mp3d_gaussian_FR_eccv.yaml"),
        "--scenes_list", SCENE, "--max_steps", str(EPISODE_STEPS),
        "--eval_poses", "0", "--log_dir", log_dir, "--name", "pipelined",
        "--set", "tpu.pipeline_planning", "True"])
    cfg = cli.load_config(args)
    result, mapper, wall_s, launches = timed_entry_point(args, cfg, SCENE)
    sim, timing = mapper.sim, result["timing"]
    hits = sim.prefetch_hits
    plain, _scene = cli.make_sim(args, cfg, SCENE)
    frames_equal = []
    for a in (1, 2, 1, 3):
        plain.set_pose(sim.c2w)
        sim.prefetch(a)
        got, ref = sim.step(a), plain.step(a)
        frames_equal.append(bool(
            torch.equal(got["rgb"], ref["rgb"])
            and torch.equal(got["depth"], ref["depth"])
            and np.array_equal(got["c2w"], ref["c2w"])))
    if sim.prefetch_hits != hits + 4:
        raise AssertionError("the check's prefetched frames were not taken")

    def total(tm, name):
        return tm[name]["total_s"] if name in tm else 0.0

    row = dict(steps=result["steps"], done_reason=result["done_reason"],
               wall_s=wall_s,
               sync_wall_less_eval_s=sync_wall_s - total(sync_timing,
                                                         "eval"),
               planning_events=result["planning_events"],
               preps_made=mapper.plan_preps["made"],
               preps_consumed=mapper.plan_preps["consumed"],
               preps_dropped=mapper.plan_preps["dropped"],
               prefetched_frames_taken=hits,
               prefetch_frames_equal=all(frames_equal),
               coverage_2d_pct=result["coverage_2d_pct"],
               n_gaussians=result["n_gaussians"],
               **{f"{name}_s": total(timing, name) for name in PIPE_PHASES},
               **{f"sync_{name}_s": total(sync_timing, name)
                  for name in PIPE_PHASES},
               **{f"launches_{k}": v for k, v in launches.items()})
    if result["steps"] != EPISODE_STEPS:
        raise AssertionError(f"the pipelined episode ended at step "
                             f"{result['steps']} ({result['done_reason']})")
    if mapper.plan_preps["consumed"] < 1 or hits < 1:
        raise AssertionError(f"pipelined episode: preparations "
                             f"{mapper.plan_preps}, prefetched frames taken "
                             f"{hits}")
    if not all(frames_equal):
        raise AssertionError(f"a prefetched frame differs from a plain "
                             f"step's: {frames_equal}")
    if min(launches[k] for k in ("blend", "blend_bwd", "fisher",
                                 "fisher_nf20", "nn1")) <= 0:
        raise AssertionError(f"pipelined episode: a kernel was not "
                             f"launched: {launches}")
    if not 0.0 < result["coverage_2d_pct"] <= 100.0:
        raise AssertionError(f"coverage {result['coverage_2d_pct']}")
    return result, mapper, row


def timed_k3(fn):
    """(fn's output, its wall ms between synchronizes, K3 launches of
    either width while it ran)."""
    import torch
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = read_launches()
    return out, ms, got["fisher"] + got["fisher_nf20"]


def frac_off(got, ref, rtol, atol):
    """The share of entries with |got - ref| > rtol |ref| + atol, and the
    largest difference."""
    err = (got - ref).abs()
    return (float((err > rtol * ref.abs() + atol).float().mean()),
            float(err.max()))


def check_legacy_planning(mapper):
    """The legacy in-SLAM planning API on the main episode's final map and
    occupancy: get_top_down_map, uncertainty_scores (H_train anew), a
    frontier round and a DBSCAN round of global_planning with the
    planner's navigability (a candidate's cell free in the label map),
    DFS_acq_score_planning at LEGACY_DFS_DEPTH from the agent's pose, each
    timed with its K3 launches; then _pose_point_scores on
    LEGACY_CHECK_POSES of the rounds' candidates on the card against the
    CPU twin (the same
    argmax, Spearman >= 0.99; the per-point max with at most 1e-3 of the
    live Gaussians off by more than rtol 1e-3 plus 1e-6 of the largest),
    and the DFS at LEGACY_DFS_CHECK_DEPTH on the card against the CPU twin
    (the same actions; the CPU copy takes the card's H_train).  The map,
    the SLAM's random stream and round counter are left as they were."""
    import torch
    from fisher_nerf_customized_tpu_torch.models import slam as tslam
    from fisher_nerf_customized_tpu_torch.utils import clustering
    slam, planner = mapper.slam, mapper.planner
    rng_state, selection = slam.rng.bit_generator.state, slam.selection
    n_before = slam.n_active
    labels = planner._occ_index_np()

    def navigable(p):
        cx, cz = planner.convert_to_map((p[0], p[2]))
        return (0 <= cz < labels.shape[0] and 0 <= cx < labels.shape[1]
                and labels[cz, cx] == 2)

    c2w = np.asarray(mapper.sim.c2w, np.float64)
    row = {}
    occ, row["top_down_ms"], _k = timed_k3(slam.get_top_down_map)
    slam._h_train_cache = None
    unc, row["uncertainty_ms"], row["uncertainty_k3"] = timed_k3(
        slam.uncertainty_scores)
    frontier, _free = planner.build_frontiers(slam.gaussian_points)
    calls = []
    dbscan = clustering.dbscan

    def recording(points, eps=0.1, min_samples=5):
        lab = dbscan(points, eps, min_samples)
        calls.append(dict(points=len(points), clusters=int(lab.max()) + 1,
                          clustered=int((lab >= 0).sum())))
        return lab

    clustering.dbscan = recording
    rounds = []
    try:
        slam.selection = 0
        for tag, kw in (("frontier", dict(frontier=frontier)),
                        ("dbscan", {})):
            (scores, c2ws), ms, k3 = timed_k3(lambda: slam.global_planning(
                navigable, agent_pose=c2w, **kw))
            n = 0 if scores is None else len(scores)
            row.update({f"{tag}_ms": ms, f"{tag}_k3": k3,
                        f"{tag}_candidates": n})
            if n and not bool(torch.isfinite(scores).all()):
                raise AssertionError(f"legacy {tag} round: non-finite scores")
            rounds.append(c2ws)
    finally:
        clustering.dbscan = dbscan
    row.update(frontier_points=0 if frontier is None else len(frontier),
               dbscan_calls=len(calls),
               dbscan_points=sum(c["points"] for c in calls),
               dbscan_clusters=sum(c["clusters"] for c in calls),
               dbscan_clustered=sum(c["clustered"] for c in calls),
               n_active_before=n_before, n_active_after=slam.n_active,
               uncertainty_max=float(unc[:slam.n_active].max()),
               top_down_occupied_cells=int((occ[1] > 0).sum()))
    if frontier is None or rounds[0] is None:
        raise AssertionError("legacy planning: the frontier round found no "
                             "navigable candidate")
    actions, row["dfs_ms"], row["dfs_k3"] = timed_k3(
        lambda: slam.DFS_acq_score_planning(
            [c2w], navigable, max_depth=LEGACY_DFS_DEPTH,
            forward_step=mapper.forward_step, turn_angle=mapper.turn_angle))
    row["dfs_actions"] = "".join(map(str, actions))
    if len(actions) != LEGACY_DFS_DEPTH:
        raise AssertionError(f"DFS actions {actions}")

    # _pose_point_scores: the card against the CPU twin on one pose chunk
    cands = np.concatenate([r.cpu().numpy() for r in rounds if r is not None])
    ck = LEGACY_CHECK_POSES
    w2cs = tslam._pad_poses(np.linalg.inv(cands[:ck]).astype(np.float32), ck)
    n_real = min(len(cands), ck)
    h_inv = 1.0 / (slam.compute_H_train() + 0.1)
    args = (slam.fisher_camera, slam.fisher_settings, slam.fisher_full_chain,
            slam.fisher_grad_value)
    cpu_state = tslam.GaussianState(*(x.cpu() for x in slam.state))
    vs, pm = tslam._pose_point_scores(slam.state, slam._w2c(w2cs), n_real,
                                      h_inv, *args)
    t0 = time.perf_counter()
    vs_cpu, pm_cpu = tslam._pose_point_scores(
        cpu_state, torch.from_numpy(w2cs), n_real, h_inv.cpu(), *args)
    row["point_scores_cpu_s"] = time.perf_counter() - t0
    got, ref = vs[:n_real].cpu().numpy(), vs_cpu[:n_real].numpy()
    rank = lambda x: np.argsort(np.argsort(x))          # noqa: E731
    spearman = float(np.corrcoef(rank(got), rank(ref))[0, 1]) \
        if n_real > 1 else 1.0
    live = slice(0, slam.n_active)
    pm, pm_cpu = pm[live].cpu(), pm_cpu[live]
    off, err = frac_off(pm, pm_cpu, 1e-3, 1e-6 * float(pm_cpu.abs().max()))
    row.update(point_scores_poses=n_real, view_spearman=spearman,
               view_rel_err_max=float(np.max(np.abs(got - ref)
                                             / np.abs(ref))),
               same_argmax=int(got.argmax()) == int(ref.argmax()),
               point_max_off_frac=off, point_max_err=err,
               point_max_largest=float(pm_cpu.abs().max()))
    if spearman < 0.99 or not row["same_argmax"] or off > 1e-3:
        raise AssertionError(f"_pose_point_scores off the CPU twin: {row}")

    # the DFS on the card against the CPU twin
    cpu = slam_copy(slam, "cpu")
    cpu._h_train_cache = (cpu._h_train_key(), slam.compute_H_train().cpu())
    kw = dict(max_depth=LEGACY_DFS_CHECK_DEPTH,
              forward_step=mapper.forward_step, turn_angle=mapper.turn_angle)
    card_actions = slam.DFS_acq_score_planning([c2w], navigable, **kw)
    t0 = time.perf_counter()
    cpu_actions = cpu.DFS_acq_score_planning([c2w], navigable, **kw)
    row["dfs_cpu_s"] = time.perf_counter() - t0
    row["dfs_check_actions"] = "".join(map(str, card_actions))
    if card_actions != cpu_actions:
        raise AssertionError(f"DFS at depth {LEGACY_DFS_CHECK_DEPTH}: card "
                             f"{card_actions}, CPU {cpu_actions}")
    slam.rng.bit_generator.state, slam.selection = rng_state, selection
    if slam.n_active != n_before:
        raise AssertionError("legacy planning changed the episode's map")
    return row


def check_ddppo():
    """The DD-PPO network at habitat's width (256x256 depth, GN-ResNet50,
    hidden 512, 2 LSTM layers) on seeded parameters: DDPPO_STEPS steps of
    one episode on the card against the CPU twin (logits, value and the
    hidden state (h and c) each within 1e-4 of the larger of its largest
    magnitude and 1: relative where the LSTM's cell state grows past 1,
    absolute on the small values; the same argmax); ms per
    act on the card (TF32 off); DdppoPolicy without a checkpoint taking
    PathFollower's action."""
    import torch
    from fisher_nerf_customized_tpu_torch.planning import (ddppo_net,
                                                           local_policy)
    params = ddppo_net.init_params(0)
    nets = dict(card=ddppo_net.from_params(params, 512, 256, device="cuda"),
                cpu=ddppo_net.from_params(params, 512, 256, device="cpu"))
    state = {k: (ddppo_net.zero_state(512, device=n.critic.fc.weight.device),
                 torch.zeros(1, dtype=torch.int32,
                             device=n.critic.fc.weight.device))
             for k, n in nets.items()}
    rng = np.random.default_rng(0)
    errs = dict(logits=0.0, value=0.0, hidden=0.0)
    largest = dict(errs)
    same_argmax = True
    for step in range(DDPPO_STEPS):
        depth = rng.uniform(0, 1, (1, 256, 256, 1)).astype(np.float32)
        goal = np.asarray([[3.0 - step, 0.5 - 0.4 * step]], np.float32)
        mask = np.asarray([0.0 if step == 0 else 1.0], np.float32)
        outs = {}
        for k, net in nets.items():
            dev = net.critic.fc.weight.device
            hidden, prev = state[k]
            logits, value, hidden = net(
                torch.from_numpy(depth).to(dev),
                torch.from_numpy(goal).to(dev), hidden, prev,
                torch.from_numpy(mask).to(dev))
            prev = logits.argmax(-1).to(torch.int32)
            state[k] = (hidden, prev)
            outs[k] = (logits.cpu(), value.cpu(), hidden.cpu())
        for name, got, ref in zip(errs, outs["card"], outs["cpu"]):
            errs[name] = max(errs[name], float((got - ref).abs().max()))
            largest[name] = max(largest[name], float(ref.abs().max()))
        same_argmax &= bool(torch.equal(outs["card"][0].argmax(-1),
                                        outs["cpu"][0].argmax(-1)))
    net = nets["card"]
    d = torch.from_numpy(depth).cuda()
    g = torch.from_numpy(goal).cuda()
    m = torch.ones(1, device="cuda")
    hidden, prev = state["card"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    act_ms = cuda_ms(lambda: ddppo_net.act(net, d, g, hidden, prev, m,
                                           generator=gen), 20)
    pol = local_policy.DdppoPolicy(device="cuda")
    follower = local_policy.PathFollower()
    prng = np.random.default_rng(1)
    follows = []
    for _ in range(8):
        c2w = np.eye(4)
        yaw = prng.uniform(-np.pi, np.pi)
        c2w[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]]
        goal_xz = tuple(prng.uniform(-3, 3, 2))
        follows.append(pol.plan(depth[0], goal_xz, c2w=c2w)
                       == follower.next_action(c2w, goal_xz))
    row = dict(steps=DDPPO_STEPS,
               **{f"{k}_max_err": v for k, v in errs.items()},
               **{f"{k}_largest": v for k, v in largest.items()},
               same_argmax=same_argmax, act_ms=act_ms,
               policy_learned=pol.learned,
               policy_takes_follower_action=all(follows))
    if any(errs[k] > 1e-4 * max(largest[k], 1.0) for k in errs) \
            or not same_argmax:
        raise AssertionError(f"DD-PPO card off the CPU twin: {row}")
    if pol.learned or not all(follows):
        raise AssertionError(f"DdppoPolicy without a checkpoint: {row}")
    return row


def check_render_sh(mapper):
    """render_sh at degree 3 over the main episode's live Gaussians at the
    latest keyframe (256x256): SH coefficients with the map's colours as
    the DC term and seeded N(0, 0.05) higher orders; the image and the
    gradient of the L1 loss to the keyframe's colours with respect to
    the coefficients, on the card against the CPU twin (at most 1e-3 of
    the pixels off by more than 3e-4; at most 1e-3 of the gradient entries
    off by more than rtol 1e-3 plus 1e-4 of the largest); K1 and K2
    launches of one forward and backward; ms of the forward and of the
    forward with the backward."""
    import torch
    from fisher_nerf_customized_tpu_torch.ops import sh as tsh
    from fisher_nerf_customized_tpu_torch.ops.rasterize import render_sh
    slam = mapper.slam
    n, st = slam.n_active, slam.state
    gen = torch.Generator().manual_seed(0)
    sh = torch.randn(n, 16, 3, generator=gen) * 0.05
    sh[:, 0] = (st.rgb_colors[:n].detach().cpu() - 0.5) / tsh.SH_C0
    kf = len(slam.keyframes) - 1
    w2c = torch.as_tensor(np.asarray(slam.keyframes.w2cs[kf], np.float32))
    gt = slam.keyframes.color_dev(kf, "cpu")
    leaves = [x.detach().cpu() for x in (
        st.means3D[:n], torch.exp(st.log_scales[:n]), st.unnorm_rotations[:n],
        torch.sigmoid(st.logit_opacities[:n, 0]))]
    inputs = {dev: [x.to(dev) for x in (*leaves, w2c, sh, gt)]
              for dev in ("cuda", "cpu")}

    def run(dev, backward=True):
        means, scales, quats, opac, pose, coeffs, target = inputs[dev]
        coeffs = coeffs.detach().requires_grad_(backward)
        out = render_sh(slam.camera, means, pose, scales, quats, opac,
                        coeffs, deg=3, settings=slam.settings)
        if backward:
            torch.abs(out["color"] - target).mean().backward()
        return out["color"].detach(), coeffs.grad

    zero_launches()
    img, grad = run("cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    img_cpu, grad_cpu = run("cpu")
    img_off, img_err = frac_off(img.cpu(), img_cpu, 0.0, 3e-4)
    g_off, g_err = frac_off(grad.cpu(), grad_cpu, 1e-3,
                            1e-4 * float(grad_cpu.abs().max()))
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: run("cuda", backward=False), 10)
    fwd_bwd_ms = cuda_ms(lambda: run("cuda"), 10)
    row = dict(n_gaussians=n, H=slam.camera.height, W=slam.camera.width,
               max_per_tile=slam.settings.max_per_tile,
               image_off_frac=img_off, image_max_err=img_err,
               grad_off_frac=g_off, grad_max_err=g_err,
               grad_largest=float(grad_cpu.abs().max()),
               image_mean=float(img.mean()), forward_ms=fwd_ms,
               forward_backward_ms=fwd_bwd_ms,
               launches_blend=launches["blend"],
               launches_blend_bwd=launches["blend_bwd"])
    if not (bool(torch.isfinite(img).all()) and bool(
            torch.isfinite(grad).all())):
        raise AssertionError("render_sh: non-finite image or gradient")
    if img_off > 1e-3 or g_off > 1e-3 or float(grad_cpu.abs().max()) <= 0:
        raise AssertionError(f"render_sh off the CPU twin: {row}")
    if launches["blend"] != 1 or launches["blend_bwd"] != 1:
        raise AssertionError(f"render_sh launches: {launches}")
    return row


def check_occ_map(args, cfg, mapper):
    """OccupancyMap at the planner's grid, cell and centre over the
    episode's first OCC_MAP_FRAMES frames (the start and the init scan's
    left turns, from a fresh sim), on the card and on the CPU: the labels
    equal cell for cell, the vote maps' largest difference reported; ms
    per update on the card."""
    import torch
    from fisher_nerf_customized_tpu_torch import cli
    from fisher_nerf_customized_tpu_torch.planning.occ_map import OccupancyMap
    planner = mapper.planner
    sim, _scene = cli.make_sim(args, cfg, SCENE)
    frames = [sim.get_observations()] + [sim.step(2) for _ in
                                         range(OCC_MAP_FRAMES - 1)]
    kw = dict(grid_dim=tuple(int(g) for g in planner.grid_dim),
              cell_size=planner.cell_size, map_center=planner.map_center,
              height_lower=planner.height_lower,
              height_upper=planner.height_upper,
              pcd_far=planner.pcd_far_distance)
    maps = {dev: OccupancyMap(mapper.slam.camera, device=dev, **kw)
            for dev in ("cuda", "cpu")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for obs in frames:
        maps["cuda"].update(obs["depth"], obs["c2w"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    for obs in frames:
        maps["cpu"].update(obs["depth"].cpu(), obs["c2w"])
    lab, lab_cpu = maps["cuda"].labels(), maps["cpu"].labels()
    row = dict(frames=len(frames), grid=kw["grid_dim"],
               cells_differ=int((lab != lab_cpu).sum()),
               votes_max_diff=float((maps["cuda"].occ_map.cpu()
                                     - maps["cpu"].occ_map).abs().max()),
               explored_ratio=maps["cuda"].explored_ratio(),
               ms_per_update=ms)
    if row["cells_differ"] or row["explored_ratio"] <= 0:
        raise AssertionError(f"OccupancyMap on the card off the CPU: {row}")
    return row


def device_ms_and_launches(fn):
    """Device time (ms, the profiler's kernel rows) and kernel launches of
    one call of fn, after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if not rows:
        return None, 0
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / MEM_BW * 1e3, n_ops / FP32_PEAK * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", default=None,
                        help="also write every measured number to this file")
    parser.add_argument("--kernels-only", action="store_true",
                        help="skip the slice and stop after the kernel "
                        "phases (a quick check of a kernel change; prints "
                        "no result line)")
    opts = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fisher_nerf_customized_tpu_torch.models import slam as tslam
    from fisher_nerf_customized_tpu_torch.models.gaussian_state import (
        GaussianState)
    from fisher_nerf_customized_tpu_torch.ops import (cuda_blend,
                                                      cuda_blend_bwd,
                                                      cuda_build, cuda_fisher)
    from fisher_nerf_customized_tpu_torch.ops.binning import tile_bin
    from fisher_nerf_customized_tpu_torch.ops.fisher import (
        fisher_kernel_inputs)
    from fisher_nerf_customized_tpu_torch.ops.image import calc_psnr
    from fisher_nerf_customized_tpu_torch.ops.projection import preprocess
    from fisher_nerf_customized_tpu_torch.ops.rasterize import (
        _tiles_to_image, blend_kernel_inputs)
    from fisher_nerf_customized_tpu_torch.planning.candidates import (
        generate_candidates)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    report = dict(device=torch.cuda.get_device_name(0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    report["nvidia_smi"] = smi

    # ---- build --------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in b["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, b in built.items()}
    report["build"] = dict(seconds=build_s, ptxas=ptxas)
    phase("build", seconds=f"{build_s:.2f}",
          sources=",".join(sorted(built)))
    for name, lines in ptxas.items():
        for ln in lines:
            print(f"  ptxas {name}: {ln}")
    # K3 keeps every per-pixel array in registers: a stack frame or a spill
    # is a regression (a 64-byte frame once cost K2 3x, PERF.md)
    bad = [ln for ln in ptxas.get("fisher", []) if "spill" in ln and
           not ln.startswith("0 bytes stack frame, 0 bytes spill stores, "
                             "0 bytes spill loads")]
    if bad:
        raise AssertionError(f"K3 uses local memory: {bad}")

    cfg = eccv_config()

    def candidates(sim, k, seed):
        agent = sim.c2w[[0, 2], 3][None].astype(np.float32)
        ex = cfg.explore
        return generate_candidates(agent, k, float(ex.sample_range),
                                   float(ex.min_range), sim.cam_height,
                                   np.random.default_rng(seed))

    # ---- episode (the main path), first, in a process that has not yet run
    # anything else: run after the probe and the kernel phases, host-bound
    # mapping events read 1.7x slower (PERF.md)
    if not opts.kernels_only:
        ep_args, ep_cfg, result, mapper, ep_wall_s, ep_launches, ev = \
            run_episode(os.path.join(HERE, "experiments", "chip_smoke"))
        timing = result["timing"]
        ep_row = dict(
            steps=result["steps"], done_reason=result["done_reason"],
            wall_s=ep_wall_s, steps_per_s=result["steps"] / ep_wall_s,
            planning_events=result["planning_events"],
            coverage_2d_pct=result["coverage_2d_pct"],
            n_gaussians=result["n_gaussians"],
            n_keyframes=result["n_keyframes"],
            stuck_total=result["stuck_total"],
            **{f"launches_{k}": v for k, v in ep_launches.items()})
        report["episode"] = dict(ep_row, timing=timing,
                                 plan_log=[dict(t=e["t"], best=e["best"],
                                                n_paths=len(e["scores"]))
                                           for e in mapper.plan_log])
        phase("episode", **fmt(ep_row))
        for name in ("tracking_mapping", "occupancy", "pcl", "recon_metric",
                     *(f"recon_metric.{sub}" for sub in RECON_SUB_PHASES),
                     "eval", "planning", "plan.global", "plan.sweep",
                     "plan.global.wait", "plan.actions", "plan.h_train",
                     "plan.rollout", "plan.path_eig", "prewarm", "sim_step",
                     "habvis"):
            if name in timing:
                print(f"  timer {name}: {timing[name]}")
        if result["steps"] != EPISODE_STEPS:
            raise AssertionError(f"the episode ended at step {result['steps']}"
                                 f" ({result['done_reason']})")
        if result["planning_events"] < MIN_PLANNING_EVENTS:
            raise AssertionError(f"{result['planning_events']} planning "
                                 f"events, expected >= {MIN_PLANNING_EVENTS}")
        if min(ep_launches.values()) <= 0:
            raise AssertionError(f"a kernel was not launched in the episode: "
                                 f"{ep_launches}")
        if not all(np.isfinite(e["scores"]).all() for e in mapper.plan_log):
            raise AssertionError("non-finite path-EIG scores")
        if not 0.0 < result["coverage_2d_pct"] <= 100.0:
            raise AssertionError(f"coverage {result['coverage_2d_pct']}")

        # ---- the same episode with pipelined planning (no evaluation),
        # second, so that its host-bound phases read as the episode's do
        p_result, _p_mapper, p_row = run_pipelined_episode(
            os.path.join(HERE, "experiments", "chip_smoke"), timing,
            ep_wall_s)
        report["pipelined_episode"] = dict(p_row, timing=p_result["timing"])
        phase("pipelined_episode", **fmt(p_row))
        for name in PIPE_PHASES:
            if name in p_result["timing"]:
                print(f"  timer {name}: {p_result['timing'][name]}")
        del _p_mapper

        # ---- the episode's evaluation and recon curve, its eval chunk
        # against K1's twin, the resume, the ties at the K cut
        ev_row, report["eval"] = check_eval(result, mapper, ev)
        phase("eval", **fmt(ev_row))
        report["eval_check"] = check_eval_chunk(mapper)
        phase("eval_check", **fmt({k: v for k, v in
                                   report["eval_check"].items()
                                   if not isinstance(v, list)}))
        report["resume"] = check_resume(ep_args, ep_cfg, result, mapper)
        phase("resume", **fmt(report["resume"]))
        report["tie_cut"] = count_cut_ties(mapper)
        phase("tie_cut", **fmt(report["tie_cut"]))

        # ---- the object branch: its episode through the entry point, then
        # the checks on its final object map
        o_result, o_mapper, o_wall, o_launches, o_rec = run_object_episode(
            os.path.join(HERE, "experiments", "chip_smoke"))
        o_row = check_object_episode(o_result, o_mapper, o_wall, o_launches,
                                     o_rec)
        report["object_episode"] = dict(o_row, timing=o_result["timing"])
        phase("object_episode", **fmt({k: v for k, v in o_row.items()
                                       if not isinstance(v, list)}))
        print(f"  object curve: {o_row['object_curve']}")
        report["object_check"] = check_object(o_mapper, o_rec, report)
        phase("object_check", **fmt(report["object_check"]))
        del o_rec

        # ---- the recon metric on the card (the 1-NN kernel) against the
        # host cKDTree on the same clouds: the episode's and the object
        # episode's scene clouds, and the object's own cloud (1 cm)
        rc = report["recon_check"] = {}
        for tag, res, m in (("episode", result, mapper),
                            ("object_episode", o_result, o_mapper)):
            row = recon_card_check(m.global_pcl.get(), m._inc_recon.gt, 0.05,
                                   m.scene.surface_distance)
            tm = res["timing"]["recon_metric"]
            row.update(recon_metric_updates=tm["count"],
                       recon_metric_s_per_update=tm["total_s"] / tm["count"])
            # the running metric of the episode (the card's nearest
            # neighbours, update by update) against the host's one-shot
            for k, v in res["recon"].items():
                ref = row[f"host_{k}"]
                if abs(v - ref) > 1e-9 * max(abs(ref), 1e-300):
                    raise AssertionError(f"{tag}: running recon "
                                         f"{res['recon']} off cKDTree's")
            rc[tag] = row
            phase("recon_check", path=tag, **fmt(row))
        obj = o_mapper.sim.dynamic_object
        rc["object"] = recon_card_check(
            o_mapper.global_obj_pcl,
            obj.sample_surface_points(20000, frame="object"), 0.01)
        phase("recon_check", path="object", **fmt(rc["object"]))

        # ---- the known-environment episode and the frontier-only
        # navigation, each through its entry point
        k_result, k_mapper, k_wall, k_launches, k_rec = run_known_env(
            os.path.join(HERE, "experiments", "chip_smoke"))
        k_row = check_known_env(k_result, k_mapper, k_wall, k_launches, k_rec)
        report["known_env"] = dict(k_row, timing=k_result["timing"])
        phase("known_env", **fmt({k: v for k, v in k_row.items()
                                  if not isinstance(v, list)}))
        for m in k_row["novelty_frames"]:
            phase("novelty", **fmt(m))
        for name in ("tracking_mapping", "object_tracking", "occupancy",
                     "recon_metric", "obj_recon_metric", "plan.object",
                     "planning", "pcl"):
            if name in k_result["timing"]:
                print(f"  timer {name}: {k_result['timing'][name]}")
        nav_row, _nav = run_navigation(
            os.path.join(HERE, "experiments", "chip_smoke"))
        report["navigation"] = nav_row
        phase("navigation", **fmt({k: v for k, v in nav_row.items()
                                   if not isinstance(v, list)}))
        print(f"  navigation curve: {nav_row['completeness_curve']}")
        del _nav

        # ---- optimized tracking through the entry point
        t_result, _t_mapper, t_row = run_tracking(
            os.path.join(HERE, "experiments", "chip_smoke"))
        report["tracking"] = dict(t_row, timing=t_result["timing"])
        phase("tracking", **fmt(t_row))
        for name in ("tracking_mapping", "planning", "recon_metric",
                     "occupancy"):
            if name in t_result["timing"]:
                print(f"  timer {name}: {t_result['timing'][name]}")
        del _t_mapper

        # ---- the UPEN baseline and its checks, the DINO-gated object
        # episode and the navigation images, each through the entry point
        log_dir = os.path.join(HERE, "experiments", "chip_smoke")
        u_result, u_mapper, u_row, u_rec = run_upen_episode(log_dir)
        report["upen_episode"] = dict(u_row, timing=u_result["timing"])
        phase("upen_episode", **fmt(u_row))
        for name in ("tracking_mapping", "upen_observe", "planning",
                     "occupancy", "recon_metric", "pcl", "sim_step"):
            if name in u_result["timing"]:
                print(f"  timer {name}: {u_result['timing'][name]}")
        report["upen_check"] = check_upen(u_mapper, u_rec, log_dir)
        phase("upen_check", **fmt({k: v for k, v in
                                   report["upen_check"].items()
                                   if not isinstance(v, list)}))
        del u_mapper, u_rec
        # ---- the perceptual networks at their real widths (random
        # checkpoints, the port's loaders), the DINO gate with histograms
        # and with the ViT, the navigation images, then the habitat
        # episode with LPIPS(alex) in its evaluation
        report["perceptual"], lp_path, vit_path = check_perceptual(
            os.path.join(log_dir, "perceptual"))
        phase("perceptual", **fmt(report["perceptual"]))
        report["dino_gate"] = run_dino_episode(log_dir)
        phase("dino_gate", **fmt(report["dino_gate"]))
        report["dino_gate_vit"] = run_dino_episode(log_dir, DINO_VIT_STEPS,
                                                   vit_path)
        phase("dino_gate", run="vit", **fmt(report["dino_gate_vit"]))
        report["nav_images"] = run_nav_images(log_dir)
        phase("nav_images", **fmt(report["nav_images"]))
        h_row, h_result = run_habitat_episode(log_dir, lp_path)
        report["habitat_episode"] = dict(h_row, timing=h_result["timing"])
        phase("habitat_episode", **fmt(h_row))

        # ---- the legacy planning API, render_sh and the OccupancyMap on
        # the main episode's map, and the DD-PPO network
        report["legacy_planning"] = check_legacy_planning(mapper)
        phase("legacy_planning", **fmt(report["legacy_planning"]))
        report["ddppo"] = check_ddppo()
        phase("ddppo", **fmt(report["ddppo"]))
        report["render_sh"] = check_render_sh(mapper)
        phase("render_sh", **fmt(report["render_sh"]))
        report["occ_map"] = check_occ_map(ep_args, ep_cfg, mapper)
        phase("occ_map", **fmt(report["occ_map"]))

    # ---- slice (the map-query path)
    if not opts.kernels_only:
        cuda_blend.launches = 0
        cuda_blend_bwd.launches = 0
        cuda_fisher.launches = 0
        events = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam, sim = run_slam(cfg, dev, ACTIONS, events)
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        for ev in events:
            phase("mapping_event", **fmt(ev))
        n_kf = len(slam.keyframes)
        kf_ids = np.linspace(0, n_kf - 1, 8).round().astype(int)
        psnrs, depth_l1s = [], []
        t0 = time.perf_counter()
        for i in kf_ids:
            out = slam.render_at_pose(np.linalg.inv(slam.keyframes.w2cs[i]))
            gt_rgb = slam.keyframes.color_dev(i, dev)
            gt_depth = slam.keyframes.depth_dev(i, dev)
            if not bool(torch.isfinite(out["render"]).all()):
                raise AssertionError("non-finite render")
            psnrs.append(float(calc_psnr(out["render"], gt_rgb)))
            m = gt_depth > 0
            depth_l1s.append(float((out["depth"] - gt_depth).abs()[m].mean()))
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h_train = slam.compute_H_train()
        torch.cuda.synchronize()
        h_train_ms = (time.perf_counter() - t0) * 1e3
        cands = candidates(sim, int(cfg.explore.sample_view_num), seed=0)
        t0 = time.perf_counter()
        scores, _poses = slam.pose_eval(cands)
        torch.cuda.synchronize()
        pose_eval_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(blend=cuda_blend.launches,
                        blend_bwd=cuda_blend_bwd.launches,
                        fisher=cuda_fisher.launches)
        # the same query again, warm (the first pays one-time allocations)
        slam._h_train_cache = None
        t0 = time.perf_counter()
        slam.compute_H_train()
        torch.cuda.synchronize()
        h_train_warm_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        slam.pose_eval(cands)
        torch.cuda.synchronize()
        pose_eval_warm_ms = (time.perf_counter() - t0) * 1e3

        n_active = slam.n_active
        if not (scores.shape == (len(cands),)
                and bool(torch.isfinite(scores).all())
                and bool(torch.isfinite(h_train).all())
                and float(h_train.min()) >= 0 and float(h_train.max()) > 0):
            raise AssertionError("H_train or EIG scores malformed")
        if not 0 < n_active < slam.state.capacity:
            raise AssertionError(f"n_active {n_active}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel was not launched: {launches}")
        n_events = (len(ACTIONS) + 1) // int(cfg.map_every)
        if len(events) != n_events:
            raise AssertionError(f"{len(events)} mapping events, expected "
                                 f"{n_events}")
        if not all(ev["losses_finite"] for ev in events):
            raise AssertionError("non-finite mapping loss")
        loss_first = float(np.mean([ev["loss_first"] for ev in events]))
        loss_last = float(np.mean([ev["loss_last"] for ev in events]))
        if not loss_last < loss_first:
            raise AssertionError(f"mapping losses do not fall: first "
                                 f"{loss_first}, last {loss_last} (means)")
        # reference: the plain twins on the CPU score the first pose chunk
        # from the same map and H_train.  Scores agree by ranking, as the JAX
        # package's EIG tests hold them: the Fisher rows are discontinuous in
        # the inputs (the 1/255 alpha cut, the T < 1e-4 tile stop, the K cap),
        # so last-bit differences between the CPU's and the card's
        # preprocessing move single Gaussian-pixel pairs across a cut.
        n_ref = slam.pose_chunk
        cpu_state = GaussianState(*(x.cpu() for x in slam.state))
        ref_w2cs = torch.from_numpy(
            np.linalg.inv(cands[:n_ref]).astype(np.float32))
        ref_scores = tslam._pose_scores(
            cpu_state, ref_w2cs, (1.0 / (h_train + 0.1)).cpu(),
            slam.fisher_camera, slam.fisher_settings, slam.fisher_full_chain,
            slam.fisher_grad_value).numpy()
        got_ref = scores[:n_ref].cpu().numpy()
        rel = np.abs(got_ref - ref_scores) / np.abs(ref_scores)
        rank = lambda x: np.argsort(np.argsort(x))
        spearman = float(np.corrcoef(rank(got_ref), rank(ref_scores))[0, 1])
        report["cpu_reference"] = dict(n=n_ref, rel_err=rel.tolist(),
                                       spearman=spearman)
        if spearman < 0.99 or int(got_ref.argmax()) != int(ref_scores.argmax()):
            raise AssertionError(f"EIG ranking off the CPU reference: spearman "
                                 f"{spearman}, rel err {rel.max()}")
        best = int(scores.argmax())
        event_ms = [ev["ms"] for ev in events]
        slice_row = dict(
            n_active=n_active, keyframes=n_kf,
            max_per_tile=slam.settings.max_per_tile, map_s=map_s,
            mapping_events=len(events), event_ms_mean=float(np.mean(event_ms)),
            event_ms_max=float(np.max(event_ms)), loss_first_mean=loss_first,
            loss_last_mean=loss_last, render_s_8=render_s,
            psnr_mean=float(np.mean(psnrs)), psnr_min=float(np.min(psnrs)),
            depth_l1_mean=float(np.mean(depth_l1s)), h_train_ms=h_train_ms,
            pose_eval_ms=pose_eval_ms, h_train_warm_ms=h_train_warm_ms,
            pose_eval_warm_ms=pose_eval_warm_ms, argmax=best,
            argmax_xz=[float(cands[best, 0, 3]), float(cands[best, 2, 3])],
            ref_spearman=spearman, ref_rel_err_max=float(rel.max()),
            ref_rel_err_median=float(np.median(rel)),
            launches_blend=launches["blend"],
            launches_blend_bwd=launches["blend_bwd"],
            launches_fisher=launches["fisher"])
        report["slice"] = slice_row
        report["mapping_events"] = events
        phase("slice", **fmt(slice_row))

    t0 = time.perf_counter()
    if opts.kernels_only:
        probe, probe_sim = run_slam(cfg, dev, ACTIONS[:N_PROBE_FRAMES - 1])
    else:               # the slice's map: the same 60 frames
        probe, probe_sim = slam, sim
    torch.cuda.synchronize()
    phase("probe", frames=N_PROBE_FRAMES, n_active=probe.n_active,
          keyframes=len(probe.keyframes),
          seconds=f"{time.perf_counter() - t0:.2f}")
    entries = {}
    if not opts.kernels_only:
        # ---- tracking and the SLAM settings on the probe map, the card
        # against the CPU twin
        report["tracking_check"] = check_tracking(probe)
        phase("tracking_check", **fmt(report["tracking_check"]))
        report["slam_settings"] = check_slam_settings(probe)
        phase("slam_settings", **fmt(report["slam_settings"]))

    # ---- kernel_blend -----------------------------------------------------
    params = probe.state.params()
    w2c = probe._w2c(probe.keyframes.w2cs[-1])
    means_cam, scales, quats, opac = tslam._gaussian_rendervars(params, w2c)
    z = means_cam[:, 2:3]
    active = probe.state.active
    prep = preprocess(means_cam, scales, quats, probe.camera, active=active)
    blend_rows = []
    bwd_inputs = {}
    for k in (256, 512):
        st = probe.settings._replace(max_per_tile=k, chunk=min(256, k))
        bins = tile_bin(prep.mean2d, prep.radius, prep.depth, prep.valid,
                        probe.camera.width, probe.camera.height,
                        st.tile_size, k)
        for n_ch in (4, 5):
            cols = torch.cat([params["rgb_colors"], z] + ([z * z] if n_ch == 5
                                                          else []), dim=-1)
            packed, pix_xy, nvalid = blend_kernel_inputs(st, prep, bins, opac,
                                                         cols)
            got, got_walked = cuda_blend.cuda_blend(
                packed, pix_xy, nvalid, st.chunk, st.max_depth)
            ref, walked = cuda_blend._blend_walk(packed, pix_xy, nvalid,
                                                 st.chunk, st.max_depth)
            torch.cuda.synchronize()
            # the stop: the kernel's rows walked against the twin's, tile by
            # tile; a tile may differ only where its max T after the chunk
            # lies within float rounding of the 1e-4 threshold
            off_tiles = torch.nonzero(got_walked.long() != walked).flatten()
            for t in off_tiles.tolist():
                cut = min(int(got_walked[t]), int(walked[t]))
                (_c, t_cut, _m), _w = cuda_blend._blend_walk(
                    packed[t:t + 1], pix_xy[t:t + 1],
                    torch.minimum(nvalid[t:t + 1], torch.tensor(
                        cut, dtype=nvalid.dtype, device=dev)),
                    st.chunk, st.max_depth)
                t_max = float(t_cut.max())
                print(f"  K1 K={k} C={n_ch} tile {t}: walked "
                      f"{int(got_walked[t])} vs twin {int(walked[t])}, max T "
                      f"after row {cut} = {t_max!r}")
                if abs(t_max / cuda_blend.SATURATED_T - 1.0) > 1e-4:
                    raise AssertionError(f"K1 K={k} C={n_ch}: stop differs "
                                         f"on tile {t}")
            err_c = float((got[0] - ref[0]).abs().max())
            err_t = float((got[1] - ref[1]).abs().max())
            dz = (got[2] - ref[2]).abs()
            err_z = float(dz.max())
            z_off = float((dz > 1e-2).float().mean())
            # tolerance: color and final T atol 3e-4 everywhere; median
            # depth atol 1e-2 on all but 0.1 % of pixels (T = 0.5 ties)
            if not (err_c <= 3e-4 and err_t <= 3e-4 and z_off <= 1e-3):
                raise AssertionError(
                    f"K1 K={k} C={n_ch}: color {err_c} T {err_t} "
                    f"depth off {z_off}")
            launch = functools.partial(cuda_blend.cuda_blend, packed, pix_xy,
                                       nvalid, st.chunk, st.max_depth)
            ms_events = cuda_ms(launch, 20)
            ms = kernel_device_ms(launch, "blend_kernel", 20)
            wrapper_ms = host_ms(launch, 200)
            plain = cuda_ms(lambda: cuda_blend.blend_plain(
                packed, pix_xy, nvalid, st.chunk, st.max_depth), 3)
            n_tiles, _k, f = packed.shape
            p = pix_xy.shape[-1]
            # rows the walk needs: up to the stop, and none past nvalid
            need = torch.minimum(walked, nvalid.long())
            rows = int(need.sum())
            pairs = pair_counts(packed, pix_xy, nvalid, walked,
                                cuda_blend.WARP)
            n_bytes = (rows * f + n_tiles * 2 * p + n_tiles
                       + n_tiles * p * (n_ch + 2) + n_tiles) * 4
            ops = pairs["pairs_live"] * (K1_FLOPS_PER_LIVE_PAIR[0]
                                         + K1_FLOPS_PER_LIVE_PAIR[1] * n_ch)
            bms, bby = bound_ms(n_bytes, ops)
            bwalked, _ = bound_ms(n_bytes, rows * p * FLOPS_PER_PAIR)
            row = dict(K=k, C=n_ch, T=n_tiles, P=p, chunk=st.chunk,
                       rows_needed=rows, rows_valid=int(nvalid.sum()),
                       nvalid_mean=float(nvalid.float().mean()),
                       nvalid_max=int(nvalid.max()),
                       rows_needed_max=int(need.max()), **pairs,
                       stop_off_tiles=len(off_tiles),
                       err_color=err_c, err_t=err_t, err_depth=err_z,
                       depth_off_frac=z_off, ms=ms, ms_events=ms_events,
                       host_ms=wrapper_ms, plain_ms=plain, bound_ms=bms,
                       bound_by=bby,
                       bound_walked_ms=bwalked)
            blend_rows.append(row)
            phase("kernel_blend", **fmt(row))
            if n_ch == 4:
                bwd_inputs[k] = (st, bins, packed, pix_xy, nvalid, got,
                                 got_walked, walked)
    main_blend = blend_rows[0]          # K 256, C 4: the mapping render
    entries["blend"] = dict(
        name="blend", route="cuda",
        source="fisher_nerf_customized_tpu_torch/csrc/blend.cu",
        replaces="fisher_nerf_customized_tpu/ops/pallas_blend.py:47",
        max_abs_err=max(max(r["err_color"], r["err_t"]) for r in blend_rows),
        ms=main_blend["ms"], plain_ms=main_blend["plain_ms"],
        bound_ms=main_blend["bound_ms"], bound_by=main_blend["bound_by"],
        library_ms=None)
    report["kernel_blend"] = blend_rows

    # ---- kernel_blend_bwd -------------------------------------------------
    gt_color = probe.keyframes.color_dev(len(probe.keyframes) - 1, dev)
    gt_depth = probe.keyframes.depth_dev(len(probe.keyframes) - 1, dev)
    gen = torch.Generator().manual_seed(0)
    bwd_rows = []
    for k, (st, bins, packed, pix_xy, nvalid, fwd, fwd_walked,
            walked) in bwd_inputs.items():
        # gcol: the mapping loss's cotangent of the blended [r, g, b, z]
        color = fwd[0].detach().requires_grad_()
        img = _tiles_to_image(color, bins.n_tiles_y, bins.n_tiles_x,
                              st.tile_size, probe.camera.height,
                              probe.camera.width)
        loss = tslam._rgbd_loss(img[..., :3], img[..., 3], gt_color,
                                gt_depth, probe.mc)
        gcol, = torch.autograd.grad(loss, [color])
        g_t = (torch.randn(fwd[1].shape, generator=gen)
               * float(gcol.std())).to(dev)
        args = (packed, pix_xy, gcol.contiguous(), g_t, nvalid, st.chunk)
        fwd_out = dict(color=fwd[0], t_final=fwd[1], walked=fwd_walked)
        ref = cuda_blend_bwd.blend_bwd_plain(*args)
        col_max = ref.abs().reshape(-1, ref.shape[-1]).amax(dim=0)
        n_tiles, _k, f = packed.shape
        p = pix_xy.shape[-1]
        n_ch = f - cuda_blend.BASE_F
        rows = int(torch.minimum(walked, nvalid.long()).sum())
        n_bytes = (rows * f + n_tiles * 2 * p + n_tiles
                   + n_tiles * p * (n_ch + 1)            # gcol, g_t
                   + n_tiles * p * (n_ch + 1) + n_tiles  # K1's outputs
                   + n_tiles * k * (6 + n_ch)) * 4
        bwalked, _ = bound_ms(n_bytes, rows * p * FLOPS_PER_PAIR)
        got = cuda_blend_bwd.cuda_blend_bwd(*args, **fwd_out)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        # tolerance: rtol 1e-3 plus 1e-4 of the output column's largest
        # value.  The kernel sums each slot's P pixels by warp shuffles and
        # fixed-order shared-memory adds and forms the suffix sums as
        # gcol . C_final minus the running prefix; the twin uses torch's
        # sum, cumprod and cumsum, so the two round differently, most where
        # a suffix cancels (dL/dalpha near 0)
        bad = err > 1e-3 * ref.abs() + 1e-4 * col_max
        if float(col_max.max()) <= 0 or bool(bad.any()):
            raise AssertionError(
                f"K2 K={k}: {int(bad.sum())} entries off, max err per "
                f"column {err.reshape(-1, err.shape[-1]).amax(0).tolist()} "
                f"of {col_max.tolist()}")
        launch = functools.partial(cuda_blend_bwd.cuda_blend_bwd, *args,
                                   **fwd_out)
        ms_events = cuda_ms(launch, 20)
        ms = kernel_device_ms(launch, "blend_bwd_kernel", 20)
        wrapper_ms = host_ms(launch, 200)
        plain = cuda_ms(lambda: cuda_blend_bwd.blend_bwd_plain(*args), 3)
        pairs = pair_counts(packed, pix_xy, nvalid, walked,
                            cuda_blend_bwd.PIXELS_PER_WARP)
        ops = pairs["pairs_live"] * (K2_FLOPS_PER_LIVE_PAIR[0]
                                     + K2_FLOPS_PER_LIVE_PAIR[1] * n_ch)
        bms, bby = bound_ms(n_bytes, ops)
        row = dict(K=k, C=n_ch, T=n_tiles, P=p, chunk=st.chunk,
                   rows_needed=rows, rows_valid=int(nvalid.sum()),
                   max_value=float(col_max.max()),
                   max_abs_err=float(err.max()), ms=ms, ms_events=ms_events,
                   host_ms=wrapper_ms, plain_ms=plain, bound_ms=bms,
                   bound_by=bby, bound_walked_ms=bwalked, **pairs)
        bwd_rows.append(row)
        phase("kernel_blend_bwd", **fmt(row))
    main_bwd = bwd_rows[0]              # K 256: the mapping backward
    entries["blend_bwd"] = dict(
        name="blend_bwd", route="cuda",
        source="fisher_nerf_customized_tpu_torch/csrc/blend_bwd.cu",
        replaces="fisher_nerf_customized_tpu/ops/pallas_blend_bwd.py:63",
        max_abs_err=max(r["max_abs_err"] for r in bwd_rows),
        ms=main_bwd["ms"], plain_ms=main_bwd["plain_ms"],
        bound_ms=main_bwd["bound_ms"], bound_by=main_bwd["bound_by"],
        library_ms=None)
    report["kernel_blend_bwd"] = bwd_rows
    del bwd_inputs, fwd, fwd_out, color, gcol, g_t, args, got, ref

    # ---- kernel_fisher ----------------------------------------------------
    cams = candidates(probe_sim, 32, seed=1)
    w2cs = probe._w2c(np.linalg.inv(cams))
    fisher_rows = []
    for full in (False, True):
        packed, pix_xy, nvalid, _bins, _prep = fisher_kernel_inputs(
            probe.fisher_camera, w2cs, params["means3D"],
            torch.exp(params["log_scales"]), params["unnorm_rotations"],
            torch.sigmoid(params["logit_opacities"][:, 0]),
            params["rgb_colors"], active=active,
            settings=probe.fisher_settings, full_chain=full)
        st, cam, gv = probe.fisher_settings, probe.fisher_camera, \
            probe.fisher_grad_value
        args = (packed, pix_xy, nvalid, st.chunk, gv, cam.fx, cam.fy)
        got = cuda_fisher.cuda_fisher_slots(*args)
        nb, n_tiles, k, nf = packed.shape
        ref, k_eff = cuda_fisher._fisher_walk(
            packed.reshape(nb * n_tiles, k, nf), pix_xy, nvalid.reshape(-1),
            st.chunk, gv, cam.fx, cam.fy)
        ref = ref.reshape(got.shape)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        scale = float(ref.abs().max())
        # tolerance: rtol 5e-3 with atol 1e-6 of the largest row (slots far
        # behind a surface hold values at the f32 rounding floor of the
        # suffix sums)
        bad = err > 5e-3 * ref.abs() + 1e-6 * scale
        if scale <= 0 or bool(bad.any()):
            raise AssertionError(f"K3 NF={nf}: {int(bad.sum())} rows off, "
                                 f"max err {float(err.max())} of {scale}")
        # two launches on the same inputs: the same rows to the bit (fixed
        # order of summation, no atomics)
        again = cuda_fisher.cuda_fisher_slots(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K3 NF={nf}: two launches differ by up to "
                                 f"{float((got - again).abs().max())}")
        # a NaN opacity fails the 1/255 test: the row blends nowhere, gives
        # the twin's zeros, and the other rows are as the twin's
        bt = int(nvalid.reshape(-1).argmax())
        nan_packed = packed.clone()
        nan_packed[bt // n_tiles, bt % n_tiles, 0, 5] = float("nan")
        nan_args = (nan_packed,) + args[1:]
        got_nan = cuda_fisher.cuda_fisher_slots(*nan_args)
        ref_nan = cuda_fisher.fisher_slots_plain(*nan_args)
        torch.cuda.synchronize()
        nan_row = got_nan[bt // n_tiles, bt % n_tiles, 0]
        if not (bool((nan_row == 0).all()) and bool(
                (ref_nan[bt // n_tiles, bt % n_tiles, 0] == 0).all())
                and not bool(((got_nan - ref_nan).abs() > 5e-3 * ref_nan.abs()
                              + 1e-6 * scale).any())):
            raise AssertionError(f"K3 NF={nf}: the NaN-opacity row "
                                 f"{nan_row.tolist()} or the rows beside it "
                                 f"differ from the twin's")
        del nan_packed, got_nan, ref_nan, again
        launch = functools.partial(cuda_fisher.cuda_fisher_slots, *args)
        ms_events = cuda_ms(launch, 20)
        ms = kernel_device_ms(launch, "fisher_kernel", 20)
        wrapper_ms = host_ms(launch, 200)
        plain = cuda_ms(lambda: cuda_fisher.fisher_slots_plain(*args), 3)
        p = pix_xy.shape[-1]
        rows = int(torch.minimum(k_eff * st.chunk,
                                 nvalid.reshape(-1).long()).sum())
        n_bytes = (rows * nf + n_tiles * 2 * p + nb * n_tiles
                   + nb * n_tiles * k * 4) * 4
        pairs = fisher_pair_counts(packed, pix_xy, nvalid, k_eff, st.chunk)
        bms, bby = bound_ms(n_bytes,
                            pairs["pairs_live"] * K3_FLOPS_PER_LIVE_PAIR[nf])
        bwalked, _ = bound_ms(n_bytes, rows * p * FLOPS_PER_PAIR)
        row = dict(NF=nf, B=nb, T=n_tiles, K=k, P=p, chunk=st.chunk,
                   rows_needed=rows, rows_valid=int(nvalid.sum()),
                   max_abs_err=float(err.max()), max_value=scale,
                   ms=ms, ms_events=ms_events, host_ms=wrapper_ms,
                   plain_ms=plain, bound_ms=bms, bound_by=bby,
                   bound_walked_ms=bwalked, bitwise_repeat=True,
                   nan_row_zero=True, **pairs)
        fisher_rows.append(row)
        phase("kernel_fisher", **fmt(row))
    main_fisher = fisher_rows[0]        # NF 11: H_train and pose_eval
    entries["fisher"] = dict(
        name="fisher", route="cuda",
        source="fisher_nerf_customized_tpu_torch/csrc/fisher.cu",
        replaces="fisher_nerf_customized_tpu/ops/pallas_fisher.py:90",
        max_abs_err=max(r["max_abs_err"] for r in fisher_rows),
        ms=main_fisher["ms"], plain_ms=main_fisher["plain_ms"],
        bound_ms=main_fisher["bound_ms"], bound_by=main_fisher["bound_by"],
        library_ms=None)
    report["kernel_fisher"] = fisher_rows

    # ---- kernel_nn1: on the episode's ground truth and cloud and on a
    # known-env frame (with --kernels-only, the same shapes from the
    # scene's ground truth, a noisy sample of it and the probe's frame)
    from fisher_nerf_customized_tpu_torch import cli as tcli
    from fisher_nerf_customized_tpu_torch.ops.knn import backproject_world
    if opts.kernels_only:
        from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene
        scene = BoxScene.multi_room(seed=SCENE_SEED)
        gt_np = tcli._sample_gt(scene)
        rng = np.random.default_rng(1)
        est_np = (scene.sample_surface_points(80000, rng=rng)
                  + rng.normal(0, 0.02, (80000, 3))).astype(np.float32)
        known_np = tcli.known_env_points(scene)
        obs = probe_sim.get_observations()
        frame = (obs["depth"], np.asarray(obs["c2w"], np.float32))
        inv_k = np.linalg.inv(probe_sim.intrinsics).astype(np.float32)
        from fisher_nerf_customized_tpu_torch.envs.fake_sim import SimObject
        obj = SimObject(scene, size=(0.5, 1.2, 0.5))
        obj_est_np = (obj.sample_surface_points(64000, rng=rng,
                                                frame="object")
                      + rng.normal(0, 0.003, (64000, 3)))
    else:
        gt_np = mapper._inc_recon.gt
        est_np = mapper.global_pcl.get()[:80000]
        known_np = np.asarray(k_mapper.known_env_points, np.float32)
        frame = k_rec["frames"][0]
        inv_k = np.linalg.inv(k_mapper.sim.intrinsics).astype(np.float32)
        obj = o_mapper.sim.dynamic_object
        obj_est_np = o_mapper.global_obj_pcl
    nov_q = backproject_world(frame[0].to(dev), torch.as_tensor(inv_k),
                              torch.as_tensor(frame[1]))
    nn1_rows, nn1_edge = check_nn1(
        torch.as_tensor(gt_np, device=dev),
        torch.as_tensor(np.asarray(est_np, np.float32), device=dev),
        nov_q, torch.as_tensor(known_np, device=dev),
        torch.as_tensor(obj.sample_surface_points(20000, frame="object"),
                        device=dev),
        torch.as_tensor(np.asarray(obj_est_np, np.float32), device=dev))
    report["kernel_nn1"] = dict(rows=nn1_rows, edge=nn1_edge)
    main_nn1 = nn1_rows[0]          # the recon metric's shape
    entries["nn1"] = dict(
        name="nn1", route="cuda",
        source="fisher_nerf_customized_tpu_torch/csrc/nn1.cu",
        replaces="fisher_nerf_customized_tpu/ops/knn.py:21",
        max_abs_err=0.0, ms=main_nn1["ms"], plain_ms=main_nn1["plain_ms"],
        bound_ms=main_nn1["bound_ms"], bound_by=main_nn1["bound_by"],
        library_ms=main_nn1["library_ms"])
    del probe, probe_sim, packed, got, ref, params, prep, means_cam, nov_q
    if opts.kernels_only:
        if opts.json:
            write_json(opts.json, report)
        return 0
    # host time of K1's and K2's wrappers per mapping event, from their host
    # ms per call at K 256 and the slice's launches
    wrappers_ms = (main_blend["host_ms"] * launches["blend"]
                   + main_bwd["host_ms"] * launches["blend_bwd"]) / len(events)
    report["slice"]["blend_wrappers_host_ms_per_event"] = wrappers_ms
    phase("wrappers", blend_wrappers_host_ms_per_event=f"{wrappers_ms:.4g}")


    # ---- profile: device time by kernel -----------------------------------
    from torch.profiler import ProfilerActivity, profile

    def profiled(tag, fn):
        # the device's activity only: with the host's too, the profiler
        # recorded every aten call of a mapping event (~100 000) and took
        # ~90 s to summarise one
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in
                prof.key_averages() if e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        total = sum(ms for _k, ms, _n in rows)
        names = ("blend", "blend_bwd", "fisher", "fisher_nf20")
        by_kernel = {name: sum(ms for key, ms, _n in rows
                               if kernel_of(key) == name) for name in names}
        launches_by_kernel = {name: sum(n for key, _ms, n in rows
                                        if kernel_of(key) == name)
                              for name in names}
        idle = 1.0 - total / wall_ms if rows else None
        report[f"profile_{tag}"] = dict(device_ms=total, wall_ms=wall_ms,
                                        idle_share=idle, kernel_ms=by_kernel,
                                        kernel_launches=launches_by_kernel,
                                        top=rows[:16])
        phase("profile", query=tag, wall_ms=f"{wall_ms:.4g}",
              device_ms=f"{total:.4g}" if rows else "not measured",
              idle_share=f"{idle:.4g}" if rows else "not measured",
              **{f"{name}_ms": f"{ms:.4g}" for name, ms in by_kernel.items()})
        for key, ms, n in rows[:10]:
            print(f"  {ms:9.3f} ms  x{n:<6d} {key[:80]}")
        return rows

    # ---- plan_check: one more planning event on the episode's state --------
    plan_rows = []
    profiled("planning_event", lambda: plan_rows.append(
        capture_planning_event(mapper)))
    actions, cap = plan_rows[0]
    if not actions or "args" not in cap:
        raise AssertionError("the extra planning event found no path")
    report["plan_check"] = check_planning_event(mapper, cap, report)
    phase("plan_check", **fmt({k: v for k, v in report["plan_check"].items()
                               if not isinstance(v, (list, dict))}))
    report["device_split"] = check_device_split()
    phase("device_split", **fmt({k: v for k, v in
                                 report["device_split"].items()
                                 if not isinstance(v, list)}))
    nf20 = report["plan_check"]["k3_nf20"]
    entries["fisher_nf20"] = dict(
        name="fisher_nf20", route="cuda",
        source="fisher_nerf_customized_tpu_torch/csrc/fisher.cu",
        replaces="fisher_nerf_customized_tpu/ops/pallas_fisher.py:90",
        max_abs_err=nf20["max_abs_err"], ms=nf20["ms"],
        plain_ms=nf20["plain_ms"], bound_ms=nf20["bound_ms"],
        bound_by=nf20["bound_by"], library_ms=None)

    # one more mapping event on the mapped map (the next map_every steps)
    profiled("mapping_event", lambda: [
        step(slam, sim.step(a), None)
        for a in EXTRA_ACTIONS[:int(cfg.map_every)]])
    slam._h_train_cache = None
    profiled("pose_eval", lambda: slam.pose_eval(cands))
    # one more object planning event on the object episode's final state
    from fisher_nerf_customized_tpu_torch.engine.object_planning import (
        plan_best_object_path)
    om = o_mapper
    om.planner._search_key = None                  # a fresh sweep field
    profiled("object_planning_event", lambda: plan_best_object_path(
        om.obj_slam, om.slam, om.planner, np.asarray(om.sim.c2w, np.float64),
        1, om.slam.frame_idx + 1, om.cfg, om.forward_step, om.turn_angle,
        om.queue_size, criterion=om.criterion))

    oc = report["object_check"]
    entries["blend_bwd_probes"] = dict(
        name="blend_bwd_probes", route="cuda",
        source="fisher_nerf_customized_tpu_torch/csrc/blend_bwd.cu",
        replaces="fisher_nerf_customized_tpu/ops/pallas_blend_bwd.py:63",
        max_abs_err=oc["max_abs_err"], ms=oc["ms"], plain_ms=oc["plain_ms"],
        bound_ms=oc["bound_ms"], bound_by=oc["bound_by"], library_ms=None)

    # ---- kernels ----------------------------------------------------------
    launches_of = dict(ep_launches,
                       blend_bwd_probes=o_launches["blend_bwd_probes"],
                       nn1=k_launches["nn1"])
    report["nn1_launches"] = dict(episode=ep_launches["nn1"],
                                  object_episode=o_launches["nn1"],
                                  known_env=k_launches["nn1"],
                                  navigation=nav_row["launches_nn1"])
    for name, e in entries.items():
        e["launches"] = launches_of[name]
        phase("kernels", name=name, launches=e["launches"],
              max_abs_err=f"{e['max_abs_err']:.3g}", ms=f"{e['ms']:.4g}")
    report["kernels"] = list(entries.values())
    if opts.json:
        write_json(opts.json, report)
    print(json.dumps({"kernels": report["kernels"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
