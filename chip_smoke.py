"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root

Drives the port (``d2slam_tpu_torch``) only, with SuperPoint in bf16 so
the hand-written stem kernel is on the path:

  (a) builds every kernel from ``d2slam_tpu_torch/csrc`` (one compiler
      per source, all started together) and holds each against its plain
      PyTorch version on the card, at the shapes the main paths give it
      and at ragged ones (sides that are no multiple of a kernel's tile,
      narrower than a tile, a single image; the stem twice back to back
      on different data); times kernel, plain version and, where one
      PyTorch call computes the same function, that call, computes the
      bound from the shapes, and reports each kernel's registers and
      stack from cuobjdump;
  (b) the golden stereo VIO scenario (CircleSim seed 7, 240x320, the
      trained weights in weights/superpoint_synth.npz, 16 frames), with
      the bf16 backbone (stem kernel) and the f32 backbone: asserts the
      keyframe count, ATE < 0.03 m and the median track length;
  (c) the main path at full width: 480x640, the default estimator and
      SuperPoint configurations, 10 frames; (c.2) the device pyramidal
      LK (``frontend.lk.lk_track_pyramidal``, 3 levels, win 21, iters
      10) at 480x640 over the ~200 points the stereo tracker keeps in
      the textured room of (j), against the same call on the CPU (the
      ``ok`` masks equal, points within 0.01 px) and the tracker's native
      host LK (95 % of the points agree within 0.05 px), with ms and
      launches per call;
  (d) quadcam depth at full width: 4 Kannala-Brandt fisheyes 480x640
      around a textured cylinder wall -> 4 virtual stereo pairs 240x320
      -> block-matching kernel (max_disp 64, block 9) -> coloured point
      clouds, 6 frames; asserts the wall's depth, the disparity RMS
      against the analytic wall at the JAX package's golden set-up, and
      two kernel launches per frame; one frame through the HitNet option;
  (e) quadcam VIO: 4 outward 240x320 views per frame through the
      multi-view tracker (one stem launch for the 4 views) into the
      estimator, 16 frames: asserts >= 10 keyframes and ATE < 0.25 m;
  (f) the single-robot ``D2SLAMSystem`` at full width: the scene of (c)
      through ``input_stereo`` with NetVLAD (weights/netvlad_synth.npz)
      fused into the extraction, loop detection with PnP verification,
      PCM and the dense pose-graph solve every 5 keyframes, one lap of
      the circle and 17 frames more (the places of the lap's start
      again): asserts one stem launch and one NetVLAD pass per
      frame, >= 2 PGO solves, >= 1 loop kept by PCM, and a PGO
      trajectory no worse than the VIO one by more than 0.02 m;
  (g) the pose-graph solvers alone: dense LM at the system's default
      layout (256 poses, 1024 edges; 6-DoF and 4-DoF) and PCG on the
      10,000-pose spiral of examples/bench_pgo_scale.py, each against
      its own CPU result (relative final cost within 1e-3), with ms and
      kernel launches per solve; and the batched PnP against the host
      path on the correspondences of one of (f)'s loop queries;
  (h) dataset replay at EuRoC's format: the scene of (c) at 480x752
      (camera 20 Hz, IMU 200 Hz, 24 frames from rest) written once as an
      EuRoC-ASL directory and once as a ROS1 bag; (A) its uint8 frames
      fed serially to ``D2SLAMSystem.input_stereo``, (B)
      ``run_dataset_vio`` on the directory (native PNG prefetch, the
      two-thread ``PipelinedSystem`` with the extraction lookahead on a
      CUDA stream), (C) the bag's event stream against the directory's;
      asserts (B)'s keyframes, positions and loop-database descriptors
      against (A)'s, (B)'s ATE against the dataset's ground truth, one
      stem launch per frame in (A) and in (B), and (C) bit for bit;
  (i) the dynamic start: tests/test_estimator.py::
      test_dynamic_start_sfm_init's scenario on the card (mono, moving at
      the start, SFM initialization), with that test's pins; and the
      essential-matrix RANSAC on the card against the host path;
  (j) the textured room (``utils.render.TexturedRoom``): the JAX
      package's golden textured scenarios at 240x320
      (tests/test_golden_textured.py: stereo ``D2SLAMSystem`` over 26
      frames, pin 0.18 m; the 4-view ring over 16 frames, pin 0.2 m)
      with the tests' float32 backbone; then ``D2SLAMSystem.input_stereo``
      at 480x640, bf16, with NetVLAD fused, loop detection and PGO over one lap
      and the revisit of its start; prints retrieval queries, loops
      verified and kept by PCM, the NetVLAD similarity of true revisits
      against other places, VIO and PGO ATE; asserts >= 1 loop kept and
      one stem launch per frame (PGO against VIO ATE is printed: there
      the loops' relative poses err as much as the odometry, so phase f
      keeps that gate);
  (k) the estimator's options at full width, 12 frames each of (c)'s
      scene through ``D2SLAMSystem``: ``landmark_param="pos3d"`` and
      ``solver_method="dogleg"`` beside the default run
      (tests/test_pos3d.py's pins) and RGB-D through ``input_rgbd`` with
      a depth image rendered from the scene (tests/test_tracker.py's
      RGB-D pins); the default run's estimator saved and loaded back on
      the card; and the two recovery tests of tests/test_online_calib.py
      (``estimate_extrinsic`` from perturbed extrinsics, ``estimate_td``
      with the camera 8 ms late) on their own oracle inputs, with their
      pins (from the blob scene's image features they miss those pins:
      PERF.md);
  (l) the threaded quadcam depth replay (``runtime.depth_replay``) on
      (d)'s rig with uint8 frames: serial against threaded ms per frame,
      the uint8 upload against the float32 one; asserts the threaded
      clouds equal the serial ones bit for bit, and two block-matching
      launches per frame;
  (m) the two-robot swarm: SuperGlue alone at 300 x 300 keypoints, 256-d
      (the shipped compact weights in weights/superglue_synth.npz and the
      9-layer default from a scaled random init), the card's
      log-assignment against the same module on the CPU within 1e-5 of its
      scale and their matches, ms and kernel launches per call beside the
      kNN ratio matcher; the JAX package's golden textured swarm
      (tests/test_golden_textured.py::test_golden_textured_swarm: two
      robots at 240x320 on a ``LocalBus``, NetVLAD, SuperGlue remote, 26
      frames each) with the test's float32 backbone, held to its pins (>= 3
      inter-robot loops, best >= 50 PnP inliers, joint RMSE < 0.35 m) on
      the graph the JAX package's run reads (robot 1's; robot 0's is
      printed); then two robots at 480x640
      in that room, bf16 stem, NetVLAD fused, SuperGlue local and remote,
      greedy broadcast, 20 frames each: asserts an inter-robot loop, an
      alignment, robot 1 merged into robot 0's reference frame, the joint
      PGO solved and one stem launch per frame per robot; prints SuperGlue
      ms per local match and per loop candidate and each robot's
      estimator, PGO, loop and per-frame ms;
  (n) multi-robot estimation: (n.1) consensus ADMM with the robots as a
      batch dimension, 4 robots at the default window (the circle scene of
      ``make_circle_scene``, each robot perturbed by its own seeded draw),
      4 rounds, and distributed PGO with rotation initialization on a
      4-robot ring of 64 poses each, 8 rounds, each against the same calls
      on the CPU and the PGO against the card's centralized dense solve,
      with ms and launches per round; (n.2) the JAX package's slow
      feature-level system scenarios (tests/test_system.py: server mode,
      transport DPGO, distributed camera consensus with one thread per
      robot) with their pins; (n.3) two robots at 480x640 in m.3's room,
      bf16 stem, NetVLAD fused, SuperGlue on the loop candidates,
      ``estimation_mode="distributed"`` with ``enable_dpgo``, 20 frames
      each, one thread per robot, and a server node ingesting both robots'
      packets: asserts the merge into robot 0's frame, both drones in each
      window, shared consensus keys, duals both ways, the server returning
      both drones, finite results and one stem launch per frame per robot;
      prints ms per frame per robot, consensus ms per solve, DPGO ms and
      launches per round and each robot's VIO error after alignment.

  (o) the tools: (o.1) the MSCKF at its default size (10 clones, 32
      landmarks, a 75x75 P, float64) over 40 keyframes of
      tests/test_msckf.py's circle with pixel noise, against the same
      flight on the CPU and the JAX test's position pin, with ms and
      launches per propagate (50 IMU samples), augment and update; (o.2)
      SuperPoint (weights/superpoint_synth.npz) written as an ONNX graph
      with the port's writer at 1x1x480x640, read back and lowered on the
      card, against the native float32 model (logits, descriptors,
      keypoints), with ms per extraction for the ONNX, native float32
      and native bf16 (stem kernel) routes; NetVLAD
      (weights/netvlad_synth.npz) the same way with its PCA, against the
      native module; (o.3) the SuperPoint graph quantized to int8 with
      tests/test_quantize.py's pins, its activations calibrated over 4
      frames; (o.4) pinhole, Kannala-Brandt and stereo-extrinsic
      calibration from 30 checkerboard views at 640x480 and the vignette
      of a 480x640 mean image, card against CPU, with
      tests/test_calibration.py's pins and ms per LM iteration; (o.5)
      ``train_superpoint``, ``train_netvlad`` and ``train_superglue`` at
      their default widths for 24 steps each: the first step's loss
      against the CPU's and the loss falling, ms per step with the host
      batch apart.
  (p) the host tools and the command-line entry points: (p.1) a ROS1 bag
      of 12 composite frames (phase d's four 480x640 fisheye views side by
      side) and 200 Hz IMU through ``tools.bag_tools`` ``split``, ``sync``
      (against a copy shifted by 150.5 s), ``filter`` and ``info``, and
      ``generate_stereo_bag`` on the card against the same call on the
      CPU, with the rig's extrinsics and without (the same pairs, images
      within 1 grey level, ms per pair); (p.2) one LoopNet keyframe
      broadcast with two views over UDP multicast on the card's host,
      counted by ``tools.spy.SpyStats`` (packets and bytes per channel
      equal to what was sent); (p.3) every CLI of
      ``d2slam_tpu_torch.examples`` through its ``main(argv)`` on the card
      at its default arguments (``train_frontend`` cut to 24 / 24 / 8
      steps), each held to its JAX test's pins or its own printed gates,
      with its wall seconds and summary; ``evaluate_trajectories`` reads
      the CSV ``run_synthetic_vio`` wrote; the weights ``train_frontend``
      wrote go through 4 bf16 extractions at 480x640 (stem launches); the
      two multi-process CLIs run in the background from the start of p.1.

Phases a and c.2 run first, alone on the host and the card. Then nine
long runs go to a pool of ``SIDE_WORKERS`` spawned processes, one
process a run, longest first (``SIDE_JOBS``): j's system, f, n.3, n.2's
three scenarios, m.2, k and m.3. Meanwhile the main process runs b, c,
d, e, j's golden scenarios, g, h, i, l, m.1 and o, and takes each side
run's result where its phase is gated; n.1 and p follow, p after the
pool has closed. Each run is launch-bound on one host core and leaves
the card idle most of the time, so running them side by side shortens
the script by most of their length; the times printed from b to o carry
each other's load on the host and the card (a and c.2 are timed alone).

The native pipeline library and LK are built with the kernels in (a).
The launch counts of (c), (d), (e), (f), (h), (j), (k), (l), (m), (n), (o)
and (p) go into the ``kernels`` line: each count is set to 0 just before its
path runs and read just after.

Every phase prints one line; any failure exits non-zero. The last three
lines are the ``kernels`` JSON, the card's name and power limit from
nvidia-smi, and the device JSON.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this script "
          "needs an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from d2slam_tpu_torch.comm import codec  # noqa: E402
from d2slam_tpu_torch.comm.loopnet import LoopNet  # noqa: E402
from d2slam_tpu_torch.comm.transport import LocalBus, UDPMulticastTransport  # noqa: E402
from d2slam_tpu_torch.config import D2Config  # noqa: E402
from d2slam_tpu_torch.datasets import EuRoCDataset, RosbagReader, RosbagWriter  # noqa: E402
from d2slam_tpu_torch.frontend import lk  # noqa: E402
from d2slam_tpu_torch.frontend import loop_detector  # noqa: E402
from d2slam_tpu_torch.frontend.loop_detector import LoopDetectorConfig  # noqa: E402
from d2slam_tpu_torch.frontend import superglue as sg  # noqa: E402
from d2slam_tpu_torch.frontend.matching import match_descriptors_radius  # noqa: E402
from d2slam_tpu_torch.frontend.pnp import ransac_pnp_body  # noqa: E402
from d2slam_tpu_torch.frontend.netvlad import (  # noqa: E402
    NetVLAD,
    NetVLADConfig,
    netvlad_from_onnx,
    netvlad_init,
)
from d2slam_tpu_torch.frontend.superpoint import (  # noqa: E402
    OnnxSuperPoint,
    SuperPoint,
    SuperPointConfig,
    load_params,
    random_params,
    superpoint_extract,
    superpoint_from_onnx,
)
from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig  # noqa: E402
from d2slam_tpu_torch.frontend.train_frontend import (  # noqa: E402
    load_weights,
    netvlad_batch,
    netvlad_loss,
    superglue_bank,
    superglue_loss,
    superpoint_batch,
    superpoint_loss,
    train_netvlad,
    train_superglue,
    train_superpoint,
)
from d2slam_tpu_torch.geometry.cameras import (  # noqa: E402
    KBParams,
    PinholeParams,
    kb_project,
    pinhole_project,
)
from d2slam_tpu_torch.depth.fisheye_undist import remap_bilinear  # noqa: E402
from d2slam_tpu_torch.depth.hitnet import HitNetConfig, hitnet_apply, hitnet_init  # noqa: E402
from d2slam_tpu_torch.depth.quadcam import (  # noqa: E402
    QuadcamConfig,
    build_virtual_stereo,
    cloud_in_body,
    quadcam_depth,
)
from d2slam_tpu_torch.depth.stereo import (  # noqa: E402
    block_match_disparity,
    disparity,
    points_from_disparity,
)
from d2slam_tpu_torch.ops import stereo_bm as bm  # noqa: E402
from d2slam_tpu_torch.geometry.lie import pose_boxplus, so3_exp_quat  # noqa: E402
from d2slam_tpu_torch.parallel import ConsensusCarry, admm_vio_round  # noqa: E402
from d2slam_tpu_torch.pgo import PGOEdges, PGOLayout, PGOState, solve_pgo, solve_pgo_pcg  # noqa: E402
from d2slam_tpu_torch.pgo.distributed import (  # noqa: E402
    ARockPGOCarry,
    arock_pgo_round,
    distributed_pgo_solve,
)
from d2slam_tpu_torch.runtime import pipeline  # noqa: E402
from d2slam_tpu_torch.runtime.dataset_vio import run_dataset_vio  # noqa: E402
from d2slam_tpu_torch.runtime.depth_replay import (  # noqa: E402
    DepthReplay,
    clouds_equal,
    serial_depth,
)
from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig  # noqa: E402
from d2slam_tpu_torch.ops import superpoint_stem as stem  # noqa: E402
from d2slam_tpu_torch.examples import (  # noqa: E402
    evaluate_trajectories,
    run_quadcam_depth,
    run_server_mode,
    run_swarm_pgo,
    run_swarm_processes,
    run_synthetic_vio,
    simulate_dpgo,
    train_frontend,
)
from d2slam_tpu_torch.tools import bag_tools, calibration, spy  # noqa: E402
from d2slam_tpu_torch.tools.calibration import (  # noqa: E402
    calibrate_kb,
    calibrate_pinhole,
    calibrate_stereo_extrinsic,
    calibrate_vignette,
)
from d2slam_tpu_torch.tools.onnx_io import OnnxAttr, OnnxGraph, OnnxNode, save_onnx  # noqa: E402
from d2slam_tpu_torch.tools.quantize import (  # noqa: E402
    calibrate_activations,
    quantization_report,
    quantize_module,
    save_calibration_table,
)
from d2slam_tpu_torch.utils import np_lie  # noqa: E402
from d2slam_tpu_torch.utils.native import nvcc  # noqa: E402
from d2slam_tpu_torch.utils.render import (  # noqa: E402
    TexturedRoom,
    cylinder_wall_disparity,
    make_signatures,
    render_blobs,
    render_cylinder_wall,
)
from d2slam_tpu_torch.utils.sim import (  # noqa: E402
    CircleSim,
    fisheye_ring_extrinsics,
    quadcam_extrinsics,
)
from d2slam_tpu_torch.utils.checkpoint import load_estimator, save_estimator  # noqa: E402
from d2slam_tpu_torch.utils.euroc_writer import write_euroc_dataset  # noqa: E402
from d2slam_tpu_torch.utils.evaluation import (  # noqa: E402
    ate_rmse,
    read_trajectory_csv,
    write_trajectory_csv,
)
from d2slam_tpu_torch.utils.synthetic import (  # noqa: E402
    default_col_free,
    make_circle_scene,
    replay_events,
    spiral_pose_graph,
    stereo_replay_sequence,
)
from d2slam_tpu_torch.solver.layout import VIOLayout  # noqa: E402
from d2slam_tpu_torch.solver.marginalization import make_pose_prior  # noqa: E402
from d2slam_tpu_torch.solver.state import tree_map  # noqa: E402
from d2slam_tpu_torch.vins.types import global_frame_id  # noqa: E402
from d2slam_tpu_torch.vins.estimator import D2Estimator  # noqa: E402
from d2slam_tpu_torch.vins.initialization import solve_relative_pose  # noqa: E402
from d2slam_tpu_torch.vins.msckf import (  # noqa: E402
    GRAVITY_Z,
    MSCKFConfig,
    MSCKFState,
    msckf_augment,
    msckf_init,
    msckf_propagate,
    msckf_update,
)
from d2slam_tpu_torch.utils.perf import PerfTracker  # noqa: E402

WEIGHTS = os.path.join(REPO, "weights", "superpoint_synth.npz")
NETVLAD_WEIGHTS = os.path.join(REPO, "weights", "netvlad_synth.npz")
PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
# non-fused f32 instructions/s: half the data sheet's 67 TFLOP/s, which
# counts a fused multiply-add as two
PEAK_F32_OPS = 33.5e12
# block matcher, kernel vs plain version (same order of summation, so a
# cost differs by rounding of the compiler's choices at most): integer
# winners equal on 99.9 % of the pixels; where equal, costs and
# sub-pixel disparity within these
BM_AGREE, BM_COST_ATOL, BM_DISP_ATOL = 0.999, 1e-5, 1e-3
# kernel vs plain version: bf16 output, so two bf16 ulps relative plus
# a small absolute floor (the conv1a activation may round across one
# bf16 boundary where the two sum in a different order)
STEM_ATOL, STEM_RTOL = 0.02, 0.016
# golden-scenario ATE pin, both backbones: the JAX package's 0.03 m
# (tests/test_golden_image_vio.py)
GOLDEN_ATE = 0.03
# quadcam pins of the JAX package: image-level quadcam VIO ATE
# (tests/test_golden_quadcam_image.py), disparity RMS against the
# analytic wall (tests/test_golden_ate.py), wall depth (tests/test_quadcam.py)
GOLDEN_QUADCAM_IMAGE_ATE = 0.25
GOLDEN_QUADCAM_DISP_RMS = 0.35
WALL_RADIUS, WALL_DEPTH_RANGE = 5.0, (3.0, 7.5)
# phase f: the PGO trajectory may be worse than the VIO one by this much
# at most (m); phase g: card and CPU solves agree on the final cost
PGO_ATE_SLACK = 0.02
PGO_COST_RTOL = 1e-3
# phase c: frames at full width
FULL_WIDTH_FRAMES = 10
# c.2: the device LK against the same call on the CPU (px; the ``ok``
# masks must be equal) and against the native host LK (the share of
# points both keep that agree within LK_NATIVE_TOL px)
LK_CPU_TOL = 1e-2
LK_NATIVE_TOL = 0.05
LK_NATIVE_AGREE = 0.95
# phase f: one lap of the circle and the first 17 places again. After
# CircleSim's 1 s speed ramp a lap takes 108.6 frames (omega 0.5 rad/s at
# 8 Hz); frames 109-125 revisit the places of frames 3-24 within
# 0.06-1.4 degrees of heading
SYSTEM_FRAMES = 126
# phase f's loop gates, below the defaults' 15 matches and 25 inliers: a
# view of this scene holds ~53 SuperPoint keypoints, and its blobs look
# alike to the matcher, so the ratio test keeps ~12-23 matches between
# two views of one place, about half of them right (a CPU count against
# the rendered ground truth, at 0.1-1.2 degrees apart)
LOOP_CFG = dict(min_match_per_dir=8, min_inliers=8)
# phase h: EuRoC's image size, camera and IMU rates; 24 frames from rest.
# Gates fixed before the first run: (B) against (A) on the keyframes'
# positions (m) and their loop-database descriptors, (B)'s ATE (m)
EUROC_H, EUROC_W, EUROC_FX = 480, 752, 440.0
DATASET_FRAMES, DATASET_CAM_HZ, DATASET_IMU_HZ = 24, 20.0, 200
DATASET_POS_ATOL, DATASET_GDESC_ATOL, DATASET_ATE = 1e-3, 1e-5, 0.05
# phase i: tests/test_estimator.py::test_dynamic_start_sfm_init's pins
DYN_FRAMES, DYN_MIN_OUT, DYN_SPEED, DYN_SPEED_TOL, DYN_ATE = 16, 8, 2.5, 0.3, 0.25
# the essential-matrix RANSAC, card against host: rotation within (rad)
REL_POSE_ROT_TOL = 1e-3
# phase j: tests/test_golden_textured.py's pins (m); the full-width run
# goes round the lap of phase f in the textured room of the golden test
TEXTURED_VIO_ATE, TEXTURED_QUADCAM_ATE = 0.18, 0.2
TEXTURED_FRAMES = SYSTEM_FRAMES
# phase k: 12 frames per option; pins of tests/test_pos3d.py (ATE and
# its distance to the default run's, m), tests/test_online_calib.py
# (rotation and translation error left of the perturbation, td error
# as a share of the delay) and tests/test_tracker.py's RGB-D test
# (depth-carrying keypoints, a depth equal to a landmark's z within)
OPTION_FRAMES = 12
OPTION_ATE, OPTION_ATE_GAP = 0.03, 0.03
CALIB_ROT_SHARE, CALIB_TRANS_SHARE, CALIB_TD, CALIB_TD_SHARE = 0.35, 0.6, 0.008, 0.35
RGBD_MIN_DEPTHS, RGBD_DEPTH_TOL = 20, 1e-6
# phase l: frames of the threaded depth replay
REPLAY_FRAMES = 12
# phase m: tests/test_golden_textured.py::test_golden_textured_swarm's
# frames and pins (inter-robot loops, the best loop's PnP inliers, the
# joint RMSE in m); the full-width run's frames per robot (robot 0 at
# phase 0 passes robot 1's starting places within them: 12 inter-robot
# loops in 26 frames on an H100);
# SuperGlue on the card against the CPU, as a share of the log-assignment
# matrix's largest magnitude (float32, sums in another order): the
# trained compact net differed by 7.3e-7 of it on an H100 (8.8e-5 at
# |logP| 121), so 1e-5 holds it with a margin of ~14x and fails a TF32
# or partly wrong product (~1e-3); the same limit holds the 9-layer net;
# at least 98 % of the CPU's matches are equal on the card (a match at
# the threshold may flip)
SUPERGLUE_WEIGHTS = os.path.join(REPO, "weights", "superglue_synth.npz")
SWARM_GOLDEN_FRAMES, SWARM_FULL_FRAMES = 26, 20
SWARM_MIN_INTER_LOOPS, SWARM_MIN_BEST_INLIERS, SWARM_JOINT_RMSE = 3, 50, 0.35
SG_LOGP_TOL, SG_MIN_EQUAL_MATCHES = 1e-5, 0.98
# phase n: consensus ADMM over 4 robots at the default window (4 rounds)
# and distributed PGO on the 4-robot ring of 64 poses each (8 rounds),
# card against CPU (float64 both, the same LM decisions) within
# N_CARD_CPU_TOL (m / rad / quaternion units); the distributed PGO
# within N_DPGO_CENTRAL_TOL of the card's centralized dense solve
# (tests/test_pcm_distributed.py's pin); the feature-level system
# scenarios' pins (tests/test_system.py): server against each drone's
# own VIO and its ATE, DPGO shared poses and median disagreement,
# distributed drone 1's error; the full-width run's frames per robot
N_ROBOTS, N_ADMM_ROUNDS, N_DPGO_PER, N_DPGO_ROUNDS = 4, 4, 64, 8
N_CARD_CPU_TOL, N_DPGO_CENTRAL_TOL = 1e-6, 0.15
N_SERVER_VS_OWN, N_SERVER_ATE = 0.5, 0.25
N_DPGO_MIN_SHARED, N_DPGO_MEDIAN = 10, 0.25
N_DIST_ERR_B = 0.6
N_FULL_FRAMES = 20
# phase o: MSCKF over 40 keyframes of tests/test_msckf.py's circle with its
# pixel noise, the card's state and P within MSCKF_CARD_CPU_REL of the
# CPU's (float64, relative to each tensor's largest entry; the nullspace
# bases differ between cuSOLVER and LAPACK, the update does not) and the
# JAX test's position pin (m); the ONNX SuperPoint's logits and
# descriptors within ONNX_REL of the native float32 model's (both f32,
# TF32 off; two cuDNN algorithm choices), and its keypoints: at least
# ONNX_KPT_AGREE of the native ones within 0.1 px; the ONNX NetVLAD's
# cosine to the native module's; tests/test_quantize.py's pins for the
# int8 graph; calibration from CALIB_VIEWS views, card against CPU
# (absolute, px and coefficients); TRAIN_STEPS per trainer, the first
# step's loss against the CPU's (relative, float32)
MSCKF_KEYFRAMES, MSCKF_NOISE, MSCKF_POS_PIN, MSCKF_CARD_CPU_REL = 40, 1.5e-3, 0.15, 1e-9
ONNX_REL, ONNX_KPT_AGREE, NETVLAD_COS = 1e-4, 0.99, 1 - 1e-4
QUANT_COMPRESSION, QUANT_REL_ERR = 3.0, 0.05
CALIB_VIEWS, CALIB_CARD_CPU = 30, 1e-6
TRAIN_STEPS, TRAIN_FIRST_REL = 24, 1e-4
# phase p: the composite quadcam bag (frames at 10 Hz, IMU at 200 Hz,
# phase d's rig side by side), the shift of its second copy (s), the
# virtual-stereo images card against CPU (grey levels), the UDP port of
# the spy; the CLIs' pins: tests/test_estimator.py's noise-free run
# (ATE, solves, marginalizations over 20 frames), tests/test_quadcam.py's
# wall, tests/test_dpgo_transport.py::test_multi_process_swarm's
# disagreement; P_STEM_FRAMES bf16 extractions on the trained weights
P_BAG_FRAMES, P_BAG_HZ, P_IMU_HZ, P_SHIFT, P_GREY_TOL = 12, 10.0, 200, 150.5, 1
P_SPY_PORT = 17801
P_VIO_ATE, P_VIO_SOLVES, P_VIO_MARGINS = 0.02, 15, 10
P_DPGO_DISAGREEMENT = 0.15
P_STEM_FRAMES = 4


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events).
    The launches queue up behind a spin of ~10 ms on the card, so that a
    kernel shorter than the host's time to launch it is still timed at the
    card's pace, not the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stem_library(img, k1, b1, k2, b2):
    """Yardstick only (never called by the port): cuDNN bf16
    conv+ReLU x2 and max-pool, NCHW."""
    x = torch.relu(torch.nn.functional.conv2d(img[:, None].to(torch.bfloat16), k1, b1, padding=1))
    x = torch.relu(torch.nn.functional.conv2d(x, k2, b2, padding=1))
    return torch.nn.functional.max_pool2d(x, 2)


def kernel_resources(lib):
    """Registers, stack (spills) and static shared memory of each kernel
    in a built library, as ``cuobjdump --dump-resource-usage`` gives
    them. A toolkit without cuobjdump, or output without a kernel's
    line, fails the run: the no-spill claim must not vanish unseen."""
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        fail(f"no cuobjdump beside nvcc ({tool}): cannot read the kernels' registers and stack")
    text = subprocess.run([tool, "--dump-resource-usage", lib._name],
                          capture_output=True, text=True, check=True).stdout
    lines = [" ".join(f for f in line.split() if f.split(":")[0] in
                      ("REG", "STACK", "SHARED", "LOCAL"))
             for line in text.splitlines() if line.lstrip().startswith("REG:")]
    if not lines:
        fail(f"cuobjdump gave no resource line for {lib._name}")
    return lines


def phase_kernels(params, dev):
    """(a) build both kernels, then check and time the stem kernel."""
    t0 = time.perf_counter()
    # one compiler per source, all together: the two kernels (nvcc), the
    # native frame pipeline and LK (g++)
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(f) for f in (stem.build, bm.build, pipeline.build, lk.build)]
        libs = [job.result() for job in jobs][:2]
    build_s = time.perf_counter() - t0
    resources = dict(zip(("superpoint_stem", "stereo_bm"), map(kernel_resources, libs)))
    wts = stem.pack_stem_weights(params["conv1a"]["w"], params["conv1a"]["b"],
                                 params["conv1b"]["w"], params["conv1b"]["b"], device=dev)
    k1 = torch.as_tensor(params["conv1a"]["w"]).permute(3, 2, 0, 1).to(dev, torch.bfloat16)
    k2 = torch.as_tensor(params["conv1b"]["w"]).permute(3, 2, 0, 1).to(dev, torch.bfloat16)
    b1 = wts.b1
    b2 = wts.b2
    rng = np.random.default_rng(0)
    rows = {}
    # ragged shapes: sides that are no multiple of the kernel's 16x16
    # tile, one narrower than a tile, a single image, fewer tiles than SMs
    for (B, H, W) in [(2, 34, 50), (1, 38, 10), (3, 50, 70), (1, 240, 320), (2, 240, 320),
                      (4, 240, 320), (2, 480, 640), (2, EUROC_H, EUROC_W)]:
        # two launches back to back on different data: a persistent kernel
        # must leave nothing behind
        imgs = [torch.as_tensor(rng.uniform(0, 1, (B, H, W)).astype(np.float32), device=dev)
                for _ in range(2)]
        outs = [stem.superpoint_stem(im, wts) for im in imgs]
        refs = [stem.stem_plain(im, *wts) for im in imgs]
        torch.cuda.synchronize()
        max_err = 0.0
        for call, (out, ref) in enumerate(zip(outs, refs)):
            o, r = out.float(), ref.float()
            if not torch.isfinite(o).all():
                fail(f"stem kernel output not finite at {B}x{H}x{W}, call {call}")
            err = (o - r).abs()
            bad = int((err > STEM_ATOL + STEM_RTOL * r.abs()).sum())
            max_err = max(max_err, float(err.max()))
            if bad:
                fail(f"stem kernel disagrees with stem_plain at {B}x{H}x{W}, call {call}: "
                     f"{bad} elements out of tolerance, max |err| {max_err}")
        img = imgs[0]
        row = dict(shape=[B, H, W], max_abs_err=max_err)
        if H >= 240:
            flops = stem.stem_flops(B, H, W)
            nbytes = stem.stem_bytes(B, H, W)
            t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
            row.update(
                ms=time_ms(lambda: stem.superpoint_stem(img, wts)),
                plain_ms=time_ms(lambda: stem.stem_plain(img, *wts), iters=20),
                library_ms=time_ms(lambda: stem_library(img, k1, b1, k2, b2)),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6,
            )
        rows[f"{B}x{H}x{W}"] = row
    print("phase a (kernel check): " + json.dumps(
        {"build_s": build_s, "resources": resources,
         "tolerance": f"|k-p| <= {STEM_ATOL} + {STEM_RTOL}*|p|",
         "stem": rows}), flush=True)
    return rows


def textured_pairs(N, H, W, shift, dev, seed):
    """N rectified pairs [N, H, W] on the card: a smoothed random
    texture, the right view shifted by ``shift`` px, plus noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.rand((N, 1, H, W + 64), generator=g, device=dev)
    for _ in range(2):
        base = torch.nn.functional.avg_pool2d(base, 3, stride=1, padding=1)
    base = base[:, 0]
    left = base[..., 16:16 + W].contiguous()
    right = base[..., 16 + shift:16 + shift + W]
    right = right + 0.01 * torch.randn(right.shape, generator=g, device=dev)
    return left, right.contiguous()


def bm_compare(out, ref, region, what):
    """Kernel outputs against the plain version's on one region: the
    fraction of equal winners and the largest error where they agree."""
    (kd, kb, kc, ks), (pd, pb, pc, ps) = ([x[region] for x in o] for o in (out, ref))
    same = kb == pb
    agree = int(same.sum()) / same.numel()   # exact: 1.0 only if all are equal
    errs = {n: float((a - b).abs()[same].max()) if bool(same.any()) else 0.0
            for n, a, b in (("cost", kc, pc), ("second", ks, ps), ("disp", kd, pd))}
    if not all(bool(torch.isfinite(x).all()) for x in (kd, kc, ks)):
        fail(f"stereo_bm output not finite ({what})")
    if (agree < BM_AGREE or errs["cost"] > BM_COST_ATOL
            or errs["second"] > BM_COST_ATOL or errs["disp"] > BM_DISP_ATOL):
        fail(f"stereo_bm disagrees with bm_plain ({what}): winners agree on "
             f"{agree:.6f}, max errors {errs}")
    return agree, max(errs.values())


def phase_bm_kernel(dev):
    """(a, block matcher) check the kernel against ``bm_plain`` at every
    listed shape, forward and reverse, the border columns on their own;
    time it at the frame's shapes."""
    rows = {}
    # 2x102x250: neither side a multiple of the kernel's tile (4 rows x 88
    # columns there); the small ones run the other block sizes' halos
    cases = [(1, 37, 70, 24, 7, 5), (2, 102, 250, 32, 9, 6), (1, 20, 64, 8, 1, 2),
             (1, 26, 90, 16, 5, 3), (1, 30, 130, 17, 15, 4),
             (4, 240, 320, 64, 9, 10), (8, 240, 320, 64, 9, 10),
             (1, 480, 640, 64, 9, 10), (1, 800, 1280, 64, 9, 10)]
    for seed, (N, H, W, D, block, shift) in enumerate(cases):
        left, right = textured_pairs(N, H, W, shift, dev, seed)
        r = block // 2
        row = dict(shape=[N, H, W], max_disp=D, block=block, agree=1.0, max_abs_err=0.0)
        for reverse in (False, True):
            a, b = (right, left) if reverse else (left, right)
            out = bm.stereo_bm(a, b, D, block, reverse)
            ref = bm.bm_plain(a, b, D, block, reverse)
            torch.cuda.synchronize()
            for name, region in (("all", np.s_[...]), ("right r columns", np.s_[..., -r:]),
                                 ("left max_disp columns", np.s_[..., :D])):
                agree, err = bm_compare(out, ref, region,
                                        f"{N}x{H}x{W} reverse={reverse} {name}")
                row["agree"] = min(row["agree"], agree)
                row["max_abs_err"] = max(row["max_abs_err"], err)
        if (H, W) == (240, 320):
            t_ops = bm.bm_ops(N, H, W, D, block) / PEAK_F32_OPS * 1e3
            t_bytes = bm.bm_bytes(N, H, W) / PEAK_BYTES * 1e3
            row.update(
                ms=time_ms(lambda: bm.stereo_bm(left, right, D, block)),
                plain_ms=time_ms(lambda: bm.bm_plain(left, right, D, block), iters=3, warmup=1),
                # no single PyTorch call computes this function; the two
                # whole matchers (both passes and the checks) side by side
                # are the honest comparison
                fused_ms=time_ms(lambda: bm.block_match_disparity_fused(left, right, D, block)),
                cost_volume_ms=time_ms(lambda: block_match_disparity(left, right, D, block),
                                       iters=10, warmup=2),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gop=bm.bm_ops(N, H, W, D, block) / 1e9,
                mbytes=bm.bm_bytes(N, H, W) / 1e6,
            )
        rows[f"{N}x{H}x{W}"] = row
    print("phase a (stereo_bm kernel check): " + json.dumps(
        {"tolerance": f"winners equal on >= {BM_AGREE:.1%} of the pixels; where equal, "
                      f"|cost|, |second| <= {BM_COST_ATOL}, |disp| <= {BM_DISP_ATOL}",
         "stereo_bm": rows}), flush=True)
    return rows


def run_sequence(params, dev, H, W, fx, n_frames, cfg, sp_cfg, tr_cfg, n_landmarks,
                 quadcam=False):
    """VIO over the CircleSim scenario, with the stereo rig or (``quadcam``)
    the ring of 4 outward views; returns the metrics."""
    if quadcam:
        sim = CircleSim(seed=7, n_landmarks=n_landmarks, extrinsics=quadcam_extrinsics(),
                        fov_cos=0.5)
    else:
        sim = CircleSim(seed=7, baseline=0.2, n_landmarks=n_landmarks)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    # distinctive appearance per landmark, for the cross-view association
    sigs = make_signatures(len(sim.lms), seed=9) if quadcam else None
    n_cams = len(sim.ext)
    cams = [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(n_cams)]
    model = SuperPoint(params, sp_cfg, device=dev)
    tracker = FeatureTracker(model, sp_cfg, cams, tr_cfg, frame_rate=sim.frame_hz,
                             extrinsics=sim.ext)
    est = D2Estimator(cfg, sim.ext, device=dev)
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    # warm the extraction once (cuDNN plans, the kernel's first load) and
    # build the native LK, so per-frame times are steady-state; the warm
    # launch is not counted
    tracker.extract(np.zeros((n_cams, H, W), np.float32))
    lk.build()
    torch.cuda.synchronize()
    stem.launches = 0

    errs, align, t_prev, n_kf, est_ms, poses, prof = [], None, 0.0, 0, [], [], None
    t_run = time.perf_counter()
    for k in range(n_frames):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        pose_gt, _ = sim.gt_pose(t)
        imgs = [render_blobs(sim.lms, np_lie.pose_compose(pose_gt, sim.ext[c]),
                             fx, fx, W / 2, H / 2, H, W, intensities=inten, signatures=sigs)
                for c in range(n_cams)]
        ff = (tracker.process_quadcam(t, k, imgs) if quadcam
              else tracker.process_stereo(t, k, imgs[0], imgs[1]))
        if ff is None:
            continue
        if k == n_frames - 1 and est.solve_count:
            # the last keyframe runs under the profiler (kept out of
            # the per-keyframe times): where the estimator's time goes
            od, prof = profile_estimator(est, ff)
        else:
            t0 = time.perf_counter()
            od = est.input_frame(ff)
            torch.cuda.synchronize()
            est_ms.append((time.perf_counter() - t0) * 1e3)
        if od is None:
            continue
        n_kf += 1
        poses.append(od.pose)
        if align is None:
            align = np_lie.pose_compose(od.pose.astype(np.float64),
                                        np_lie.pose_inverse(pose_gt))
        errs.append(np.linalg.norm(od.pose[:3] - np_lie.pose_compose(align, pose_gt)[:3]))
    wall = time.perf_counter() - t_run
    launches = stem.launches
    rep = tracker.perf.report()
    tl = [lm.track_length() for lm in est.lmanager.db.values()]
    return dict(
        frames=n_frames, keyframes=n_kf, solves=est.solve_count,
        ate_m=float(np.sqrt(np.mean(np.square(errs)))) if errs else float("nan"),
        median_track=float(np.median(tl)) if tl else 0.0,
        finite=bool(poses) and bool(np.all(np.isfinite(np.asarray(poses)))),
        stem_launches=launches,
        extract_ms_per_frame=rep["extract"]["mean_ms"],
        extract_ms_max=rep["extract"]["max_ms"],
        tracker_host_ms_per_frame=rep["host"]["mean_ms"],
        tracker_host_ms_max=rep["host"]["max_ms"],
        estimator_ms_per_keyframe=float(np.mean(est_ms)) if est_ms else 0.0,
        estimator_ms_median=float(np.median(est_ms)) if est_ms else 0.0,
        estimator_ms_per_frame=float(np.sum(est_ms)) / n_frames,
        wall_s=wall,
        estimator_stages={k: v["mean_ms"] for k, v in est.perf.report().items()},
        estimator_profile=prof,
    )


def phase_device_lk(params, dev, H=480, W=640, fx=440.0):
    """(c.2) ``lk_track_pyramidal`` on the card at (c)'s width, 3 levels,
    win 21, iters 10, over the points the stereo tracker keeps after its
    first frame of (j)'s textured room (the blob scene's first frame
    holds too few keypoints), into the next frame's left view: against
    the same call on the CPU (``ok`` masks equal, points within
    ``LK_CPU_TOL`` px) and against the tracker's native host LK
    (``LK_NATIVE_AGREE`` of the points either keeps kept by both within
    ``LK_NATIVE_TOL`` px); ms and launches per call, the pyramids' build
    apart."""
    sim = CircleSim(seed=11, baseline=0.2, n_landmarks=10)
    views = room_views(TexturedRoom(half=14.0, height=7.0, seed=3), sim.ext, H, W, fx)

    def render(t):
        return views(sim.gt_pose(t)[0], t)

    sp_cfg = SuperPointConfig(compute_dtype="bfloat16")
    tracker = FeatureTracker(SuperPoint(params, sp_cfg, device=dev), sp_cfg,
                             [PinholeParams.make(fx, fx, W / 2, H / 2)] * 2, TrackerConfig(),
                             frame_rate=sim.frame_hz, extrinsics=sim.ext)
    tracker.process_stereo(0.0, 0, *render(0.0))
    prev = tracker.prev
    img0 = np.asarray(prev["img"], np.float32)
    img1 = np.asarray(render(1.0 / sim.frame_hz)[0], np.float32)
    pts = np.asarray(prev["pts"], np.float32)
    valid = np.asarray(prev["valid"], bool)
    kw = dict(win=21, iters=10, fb_thresh=0.5)

    def device_call(d):
        pa, pb = lk.build_pyramid(img0, 3, device=d), lk.build_pyramid(img1, 3, device=d)
        p, ok = lk.lk_track_pyramidal(pa, pb, pts, valid, **kw)
        return p.cpu().numpy(), ok.cpu().numpy(), (pa, pb)

    p_gpu, ok_gpu, (pa, pb) = device_call(dev)
    p_cpu, ok_cpu, _ = device_call(torch.device("cpu"))
    p_nat, ok_nat = lk.lk_track_images(img0, img1, pts, valid, levels=3, **kw)
    t0 = time.perf_counter()
    for _ in range(5):
        lk.lk_track_images(img0, img1, pts, valid, levels=3, **kw)
    native_ms = (time.perf_counter() - t0) * 1e3 / 5
    pts_t = torch.as_tensor(pts, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    ms = time_ms(lambda: lk.lk_track_pyramidal(pa, pb, pts_t, valid_t, **kw), iters=20, warmup=3)
    pyr_ms = time_ms(lambda: (lk.build_pyramid(pa[0], 3), lk.build_pyramid(pb[0], 3)),
                     iters=20, warmup=3)
    launches = count_launches(lambda: lk.lk_track_pyramidal(pa, pb, pts_t, valid_t, **kw))
    both = ok_gpu & ok_cpu
    cpu_err = float(np.abs(p_gpu[both] - p_cpu[both]).max()) if both.any() else 0.0
    either = ok_gpu | ok_nat
    agree = ok_gpu & ok_nat & (np.linalg.norm(p_gpu - p_nat, axis=1) < LK_NATIVE_TOL)
    res = dict(shape=f"{H}x{W}", levels=3, win=21, iters=10, points=int(valid.sum()),
               ok_card=int(ok_gpu.sum()), ok_cpu=int(ok_cpu.sum()), ok_native=int(ok_nat.sum()),
               masks_equal_cpu=bool((ok_gpu == ok_cpu).all()), max_abs_err_cpu_px=cpu_err,
               native_agree_share=float(agree.sum() / max(either.sum(), 1)),
               ms_per_call=ms, pyramids_ms=pyr_ms, launches_per_call=launches,
               native_host_ms_per_call=native_ms, card=nvidia_smi_line())
    print("phase c.2 (device pyramidal LK 480x640 against the CPU and the native LK): "
          + json.dumps(res), flush=True)
    if valid.sum() < 100 or ok_gpu.sum() < 0.5 * valid.sum():
        fail(f"device LK kept too few of the tracker's points: {res}")
    if not res["masks_equal_cpu"] or not cpu_err <= LK_CPU_TOL:
        fail(f"device LK on the card disagrees with the CPU: {res}")
    if not res["native_agree_share"] >= LK_NATIVE_AGREE:
        fail(f"device LK disagrees with the native LK: {res}")
    return res


def profile_estimator(est, ff):
    """One ``input_frame`` under torch.profiler: host time, summed
    device kernel time, kernel launches and the busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        od = est.input_frame(ff)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    ka = p.key_averages()
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in ka
                  if e.self_device_time_total > 0), reverse=True)
    return od, dict(
        host_ms_profiled=host_ms,
        device_ms=sum(d for d, _, _ in dev) / 1e3,
        launches=sum(e.count for e in ka if e.key.startswith("cudaLaunch")),
        top_kernels=[[k[:60], c, d / 1e3] for d, c, k in dev[:6]],
    )


def count_launches(fn):
    """Kernel launches of one ``fn()`` under torch.profiler, counted on
    the profiler's raw events (``key_averages`` would first build an event
    tree, seconds for a call of tens of thousands of launches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    raw = getattr(p.profiler, "kineto_results", None)
    if raw is None:
        return sum(e.count for e in p.key_averages()
                   if e.key.startswith(("cudaLaunch", "cuLaunch")))
    return sum(1 for e in raw.events() if e.name().startswith(("cudaLaunch", "cuLaunch")))


def trajectory_ate(stamps, poses, sim):
    """ATE (RMSE, m) of keyframe positions against ground truth, aligned
    on the first keyframe (the pose graph's gauge)."""
    gts = [sim.gt_pose(t)[0] for t in stamps]
    align = np_lie.pose_compose(np.asarray(poses[0], np.float64), np_lie.pose_inverse(gts[0]))
    errs = [np.linalg.norm(p[:3] - np_lie.pose_compose(align, g)[:3])
            for p, g in zip(poses, gts)]
    return float(np.sqrt(np.mean(np.square(errs))))


def render_ahead(jobs):
    """Run zero-argument render jobs on a thread pool (numpy frees the
    interpreter lock in its array work) before a timed loop; returns
    their results in order."""
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        return list(pool.map(lambda job: job(), jobs))


def blob_pairs(sim, H, W, fx):
    """The stereo blob renders of (c)'s scene, one pair per call."""
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))

    def render(t):
        pose_gt, _ = sim.gt_pose(t)
        return [render_blobs(sim.lms, np_lie.pose_compose(pose_gt, sim.ext[c]),
                             fx, fx, W / 2, H / 2, H, W, intensities=inten)
                for c in range(2)]
    return render


def room_views(room, ext, H, W, fx):
    """Views of a ``TexturedRoom`` through the cameras ``ext`` at a body
    pose, with tests/test_golden_textured.py's lighting: a gain that
    varies with time and vignetting."""
    def render(pose, t):
        gain = 1.0 + 0.1 * np.sin(2.1 * t)
        return [room.render(np_lie.pose_compose(pose, e), fx, fx, W / 2, H / 2, H, W,
                            gain=gain, vignette=0.25) for e in ext]
    return render


def netvlad_separation(system, sim, near_m=1.0, far_m=3.0, min_gap=20):
    """Does NetVLAD separate places? For each database keyframe, the best
    similarity to an earlier keyframe within ``near_m`` of its true
    position and ``min_gap`` keyframes back (a revisit), and the best to
    one farther than ``far_m`` (another place); medians and counts."""
    det = system.detector
    n = len(det.entries)
    if n < 2:
        return None
    G = np.asarray(det.gdesc[:n], np.float64)
    pos = np.stack([sim.gt_pose(e.stamp)[0][:3] for e in det.entries[:n]])
    sims = G @ G.T
    dist = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    idx = np.arange(n)
    revisit, other = [], []
    for i in range(n):
        back = idx < i - min_gap
        near, far = back & (dist[i] < near_m), (idx < i) & (dist[i] > far_m)
        if near.any():
            revisit.append(float(sims[i][near].max()))
            if far.any():
                other.append(float(sims[i][far].max()))
    if not revisit:
        return dict(revisit_queries=0)
    return dict(revisit_queries=len(revisit), revisit_sim_median=float(np.median(revisit)),
                other_place_sim_median=float(np.median(other)) if other else None,
                revisit_above_other=int(sum(r > o for r, o in zip(revisit, other))),
                all_pairs_sim_percentiles=[float(np.percentile(sims[np.triu_indices(n, 1)], q))
                                           for q in (5, 50, 95)])


def run_system(params, dev, H, W, fx, n_frames, n_landmarks=300, sim=None, render=None):
    """(f, j) ``D2SLAMSystem.input_stereo`` over a CircleSim stereo run:
    by default the blob scene of (c); ``render(pose, t)`` gives the
    stereo pair of another scene (rendered ahead of the timed loop).
    Returns the metrics and the PnP correspondences of the last loop
    query whose PnP found a pose."""
    if sim is None:
        sim = CircleSim(seed=7, baseline=0.2, n_landmarks=n_landmarks)
    stamps_in = [k / sim.frame_hz for k in range(n_frames)]
    if render is None:
        blobs = blob_pairs(sim, H, W, fx)
        frames = [blobs(t) for t in stamps_in]
    else:
        frames = render_ahead([lambda t=t: render(sim.gt_pose(t)[0], t) for t in stamps_in])
    cfg = D2Config()
    cfg.estimator.focal_length = fx
    cams = [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(2)]
    system = D2SLAMSystem(cfg, SystemConfig(netvlad_weights=NETVLAD_WEIGHTS), sim.ext, cams,
                          sp_params=params, sp_cfg=SuperPointConfig(compute_dtype="bfloat16"),
                          loop_cfg=LoopDetectorConfig(**LOOP_CFG), frame_rate=sim.frame_hz,
                          device=dev)
    nv = system.netvlad
    # warm the fused extraction once and build LK; not counted
    system.tracker.extract(np.zeros((2, H, W), np.float32))
    lk.build()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    pnp_args = {}

    def recording_pnp(*a, **k):
        T, inl = ransac_pnp_body(*a, **k)
        if T is not None:
            pnp_args["args"], pnp_args["kw"] = a, k
        return T, inl

    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        system.input_imu(t, a, g)
    loop_detector.ransac_pnp_body = recording_pnp
    stem.launches = 0
    nv.calls = 0
    t_prev, n_kf, t_run = 0.0, 0, time.perf_counter()
    try:
        for k in range(n_frames):
            t = k / sim.frame_hz
            if k:
                for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                    system.input_imu(ts, a, g)
            t_prev = t
            n_kf += system.input_stereo(t, *frames[k]) is not None
        system.solve_pgo()   # the last keyframes join the graph
    finally:
        loop_detector.ransac_pnp_body = ransac_pnp_body
    wall = time.perf_counter() - t_run
    launches, nv_calls = stem.launches, nv.calls
    stamps, opt = system.trajectory()
    _, ego = system.trajectory(optimized=False)
    perf = system.perf.report()
    u8 = torch.zeros((1, H, W), dtype=torch.uint8, device=dev)
    res = dict(
        frames=n_frames, keyframes=n_kf, stem_launches=launches, netvlad_runs=nv_calls,
        gdesc_dim=system.sys.gdesc_dim,
        retrieval_queries=perf.get("loop_detect", {}).get("count", 0),
        loops_verified=len(system.loop_edges), loops_kept_by_pcm=system.loops_kept,
        loop_pairs=[[e.frame_id_a, e.frame_id_b, e.inliers] for e in system.loop_edges],
        pgo_solves=system.pgo_solve_count,
        pgo_ms_per_solve=system.pgo_perf.report().get("solve", {}).get("mean_ms", float("nan")),
        pgo_report=system.last_pgo_report._asdict() if system.last_pgo_report else None,
        loop_verification_ms_per_query=perf.get("loop_detect", {}).get("mean_ms", float("nan")),
        netvlad_ms_per_frame=(time_ms(lambda: nv(u8.float() / 255.0), iters=20)
                              if dev.type == "cuda" else float("nan")),
        ate_ego_m=trajectory_ate(stamps, ego, sim), ate_pgo_m=trajectory_ate(stamps, opt, sim),
        netvlad_separation=netvlad_separation(system, sim),
        finite=bool(np.isfinite(opt).all() and np.isfinite(ego).all()),
        extract_ms_per_frame=system.tracker.perf.report()["extract"]["mean_ms"],
        tracker_host_ms_per_frame=system.tracker.perf.report()["host"]["mean_ms"],
        estimator_stages={k: v["mean_ms"] for k, v in system.estimator.perf.report().items()},
        ms_per_frame=wall * 1e3 / n_frames, wall_s=wall,
    )
    return res, pnp_args


def pgo_graph(n, E, dof, seed):
    """The spiral graph of ``spiral_pose_graph`` with 0.05 m of noise on
    its relative translations (so the optimum keeps a cost) and initial
    positions perturbed by 0.2 m (pose 0 exact and fixed), padded to
    ``E`` edges."""
    gt, edges = spiral_pose_graph(n, seed=seed, pos_noise=0.05)
    m = len(edges.i)
    E = E or m
    pad = E - m
    edges = PGOEdges(
        i=np.concatenate([edges.i, np.zeros(pad, np.int32)]),
        j=np.concatenate([edges.j, np.zeros(pad, np.int32)]),
        rel=np.concatenate([edges.rel, np.tile(np.eye(1, 7, 6, dtype=np.float32), (pad, 1))]),
        sqrt_info=np.concatenate([edges.sqrt_info, np.tile(np.eye(6, dtype=np.float32), (pad, 1, 1))]),
        valid=np.concatenate([edges.valid, np.zeros(pad, bool)]))
    init = gt.copy()
    init[1:, :3] += np.random.default_rng(seed).normal(0, 0.2, (n - 1, 3))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return (PGOLayout(n, E, dof), PGOState(poses=init.astype(np.float32), valid=np.ones(n, bool)),
            edges, fixed)


def phase_pgo(dev, pnp_args):
    """(g) the pose-graph solvers on the card against their CPU result,
    and the batched PnP against the host path."""
    rows = {}
    for name, n, E, dof, solver, kw in (
            ("dense_6dof_N256_E1024", 256, 1024, 6, solve_pgo, dict(max_iters=10)),
            ("dense_4dof_N256_E1024", 256, 1024, 4, solve_pgo, dict(max_iters=10)),
            ("pcg_6dof_N10000", 10000, None, 6, solve_pgo_pcg, dict(max_iters=8, cg_iters=100))):
        layout, state, edges, fixed = pgo_graph(n, E, dof, seed=1)

        def run(d):
            return solver(layout, state, edges, fixed, device=d, **kw)

        out, rep = run(dev)
        t0 = time.perf_counter()
        cpu_out, cpu_rep = run("cpu")
        cpu_s = time.perf_counter() - t0
        card, ref = out.poses.cpu().double().numpy(), cpu_out.poses.double().numpy()
        cost, cpu_cost = float(rep.final_cost), float(cpu_rep.final_cost)
        row = dict(poses=n, edges=layout.E, valid_edges=int(edges.valid.sum()),
                   initial_cost=float(rep.initial_cost), final_cost=cost, cpu_final_cost=cpu_cost,
                   cost_rel_diff=abs(cost - cpu_cost) / max(abs(cpu_cost), 1e-30),
                   accepted=int(rep.accepted), cpu_accepted=int(cpu_rep.accepted),
                   max_pos_diff_m=float(np.abs(card[:, :3] - ref[:, :3]).max()),
                   ms=time_ms(lambda: run(dev), iters=3, warmup=1),
                   launches=count_launches(lambda: run(dev)), cpu_s=cpu_s, **kw)
        rows[name] = row
        if not (np.isfinite(card).all() and row["cost_rel_diff"] <= PGO_COST_RTOL
                and cost < float(rep.initial_cost)):
            fail(f"PGO {name} on the card disagrees with its CPU result: {row}")
    pnp = None
    if "args" in pnp_args:
        a, k = pnp_args["args"], dict(pnp_args["kw"])
        k.pop("device", None)
        ransac_pnp_body(*a, device=dev, **k)   # warm: solver handles, first launches
        times = {}
        for path, dk in (("host", False), ("device", dev), ("device_2", dev), ("host_2", False)):
            t0 = time.perf_counter()
            T, inl = ransac_pnp_body(*a, device=dk, **k)
            times[path + "_ms"] = (time.perf_counter() - t0) * 1e3
            times[path + "_inliers"] = int(inl.sum())
        pnp = dict(correspondences=len(a[0]), iters=k.get("iters"), **times)
    res = dict(solvers=rows, pnp=pnp)
    print("phase g (PGO solvers and batched PnP): " + json.dumps(res), flush=True)
    return res


def dataset_config(fx):
    """Phase h's settings: ``D2Config()`` at focal ``fx``, the bf16
    SuperPoint, NetVLAD fused, loops and PGO on with phase f's gates."""
    cfg = D2Config()
    cfg.estimator.focal_length = fx
    return cfg, SystemConfig(netvlad_weights=NETVLAD_WEIGHTS), dict(
        sp_cfg=SuperPointConfig(compute_dtype="bfloat16"), loop_cfg=LoopDetectorConfig(**LOOP_CFG))


def write_bag(path, imu, frames):
    """The sequence as a ROS1 bag, messages in the order of the EuRoC
    stream (IMU up to a frame's stamp, then its two images)."""
    with RosbagWriter(path) as w:
        for ev in replay_events(imu, frames):
            if ev[0] == "imu":
                w.write_imu("/imu0", *ev[1:])
            else:
                for c, img in enumerate(ev[2]):
                    w.write_image(f"/cam{c}/image_raw", ev[1], img)


def compare_streams(euroc_events, bag_events):
    """(C): the same kinds of events in the same order, IMU values equal,
    stamps within 1 ns (the bag keeps seconds and nanoseconds apart),
    images equal bit for bit. Returns counts."""
    n_imu = n_frames = 0
    for a, b in zip(euroc_events, bag_events, strict=True):
        if a[0] != b[0] or abs(a[1] - b[1]) > 1e-9:
            fail(f"bag event {b[:2]} != EuRoC event {a[:2]}")
        if a[0] == "imu":
            n_imu += 1
            if not (np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])):
                fail(f"IMU sample at {a[1]} differs between the bag and the EuRoC files")
        else:
            n_frames += 1
            if not all(x.dtype == y.dtype == np.uint8 and np.array_equal(x, y)
                       for x, y in zip(a[2], b[2], strict=True)):
                fail(f"frame at {a[1]} differs between the bag and the EuRoC files")
    return dict(imu=n_imu, frames=n_frames)


def keyframe_table(system):
    """Keyframe ids, VIO poses [N, 7] and stamps, and the loop database's
    global descriptor of each keyframe id."""
    stamps, poses = system.trajectory(optimized=False)
    det = system.detector
    n = len(det.entries)
    gdesc = {int(f): det.gdesc[i] for i, f in enumerate(det._db_frame[:n])}
    return [m[1] for m in system._pgo_meta], poses, stamps, gdesc


def frame_times(system, wall, n_frames):
    """Host-clock times of one run: per frame, and the stages apart."""
    tr = system.tracker.perf.report()
    est = system.estimator.perf.report()
    sp = system.perf.report()
    return dict(
        ms_per_frame=wall * 1e3 / n_frames,
        submit_ms_per_frame=tr.get("submit", {}).get("mean_ms"),
        extract_ms_per_frame=tr["extract"]["mean_ms"],
        tracker_host_ms_per_frame=tr["host"]["mean_ms"],
        estimator_ms_per_keyframe=est.get("input_frame", {}).get("mean_ms"),
        estimator_stages={k: v["mean_ms"] for k, v in est.items()},
        loop_detect_ms_per_query=sp.get("loop_detect", {}).get("mean_ms"),
        pgo_ms_per_solve=system.pgo_perf.report().get("solve", {}).get("mean_ms"),
        pgo_solves=system.pgo_solve_count)


def stem_beside_pgo(dev, system, wts):
    """The stem kernel's time at 2x480x752 on a stream of its own while
    another thread runs the system's pose-graph solve again and again
    (CUDA events, as ``time_ms``)."""
    img = torch.rand((2, EUROC_H, EUROC_W), generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev)
    stop = threading.Event()

    def load():
        while not stop.is_set():
            system.solve_pgo()

    th = threading.Thread(target=load)
    th.start()
    try:
        time.sleep(0.5)   # the solve is issuing kernels
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            ms = time_ms(lambda: stem.superpoint_stem(img, wts))
    finally:
        stop.set()
        th.join()
    return ms


def phase_dataset(params, dev):
    """(h) the dataset replay at EuRoC's format, serial against pipelined,
    and the bag's stream against the directory's."""
    H, W, fx = EUROC_H, EUROC_W, EUROC_FX
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=300, frame_hz=DATASET_CAM_HZ,
                    imu_hz=DATASET_IMU_HZ)
    imu, frames, gt = stereo_replay_sequence(sim, DATASET_FRAMES, H, W, fx)
    cams = [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(2)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        euroc, bag = os.path.join(tmp, "euroc"), os.path.join(tmp, "seq.bag")
        write_euroc_dataset(euroc, imu, frames, gt)
        write_bag(bag, imu, frames)
        streams = compare_streams(
            EuRoCDataset(euroc).play(as_uint8=True),
            RosbagReader(bag).play_vio("/imu0", ["/cam0/image_raw", "/cam1/image_raw"]))

        # (A) the uint8 frames straight into the system, serially
        cfg, sys_cfg, setup = dataset_config(fx)
        system = D2SLAMSystem(cfg, sys_cfg, sim.ext, cams, sp_params=params,
                              frame_rate=sim.frame_hz, device=dev, **setup)
        system.tracker.extract(np.zeros((2, H, W), np.float32))   # warm; not counted
        torch.cuda.synchronize()
        stem.launches = 0
        t0 = time.perf_counter()
        for ev in replay_events(imu, frames):
            if ev[0] == "imu":
                system.input_imu(*ev[1:])
            else:
                system.input_stereo(ev[1], *ev[2])
        system.solve_pgo()   # the last keyframes join the graph, as in (B)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launches_a = stem.launches

        # (B) the directory through run_dataset_vio, pipelined
        cfg, sys_cfg, setup = dataset_config(fx)
        stem.launches = 0
        res = run_dataset_vio(euroc, fx=fx, baseline=0.2, sp_weights=WEIGHTS, cfg=cfg,
                              sys_cfg=sys_cfg, device=dev, pipelined=True, **setup)
        torch.cuda.synchronize()
        launches_b = stem.launches

    ids_a, poses_a, stamps_a, gd_a = keyframe_table(system)
    ids_b, poses_b, _, gd_b = keyframe_table(res["system"])
    gt_t = np.array([t for t, _ in gt])
    gt_p = np.stack([p for _, p in gt])
    ate_a, _ = ate_rmse(stamps_a, poses_a, gt_t, gt_p)
    same_ids = ids_a == ids_b
    pos_diff = float(np.abs(poses_a[:, :3] - poses_b[:, :3]).max()) if same_ids else float("inf")
    gdesc_diff = (max(float(np.abs(gd_a[f] - gd_b[f]).max()) for f in ids_a)
                  if same_ids and set(gd_a) == set(gd_b) == set(ids_a) else float("inf"))
    out = dict(
        frames=DATASET_FRAMES, shape=[2, H, W], streams=streams, keyframes=len(ids_a),
        same_keyframe_ids=same_ids, max_pos_diff_m=pos_diff, max_gdesc_diff=gdesc_diff,
        ate_serial_m=float(ate_a), ate_pipelined_m=res["ate_m"],
        loops=[len(system.loop_edges), len(res["system"].loop_edges)],
        stem_launches=[launches_a, launches_b],
        serial=frame_times(system, wall_a, DATASET_FRAMES),
        pipelined=frame_times(res["system"], res["wall_s"], DATASET_FRAMES),
        stem_ms_beside_pgo=stem_beside_pgo(dev, system, system.tracker.model.stem),
    )
    print("phase h (dataset replay 2x480x752, EuRoC dir and bag, serial vs pipelined): "
          + json.dumps(out), flush=True)
    if not same_ids or pos_diff > DATASET_POS_ATOL or gdesc_diff > DATASET_GDESC_ATOL:
        fail(f"pipelined replay differs from the serial run: ids {ids_a} / {ids_b}, "
             f"positions {pos_diff} m, descriptors {gdesc_diff}")
    if not (res["ate_m"] is not None and res["ate_m"] < DATASET_ATE):
        fail(f"pipelined replay ATE {res['ate_m']} m (pin {DATASET_ATE} m)")
    if launches_a != DATASET_FRAMES or launches_b != DATASET_FRAMES:
        fail(f"stem launches {launches_a} (serial) / {launches_b} (pipelined) "
             f"!= {DATASET_FRAMES} frames")
    if streams["frames"] != DATASET_FRAMES:
        fail(f"bag replay gave {streams['frames']} frames")
    return out


def essential_data():
    """tests/test_init_eval.py::test_essential_relative_pose's data: 60
    correspondences of a known relative pose, 6 of them outliers."""
    rng = np.random.default_rng(0)
    w = np.array([0.05, -0.1, 0.2])
    th = np.linalg.norm(w)
    R12 = np_lie.quat_to_rotmat(np.concatenate([np.sin(th / 2) * w / th, [np.cos(th / 2)]]))
    t12 = np.array([0.4, 0.1, -0.2])
    pts1 = np.concatenate([rng.uniform(-2, 2, (60, 2)), rng.uniform(4, 10, (60, 1))], axis=1)
    r1 = pts1 / np.linalg.norm(pts1, axis=1, keepdims=True)
    pts2 = (R12 @ pts1.T).T + t12
    r2 = pts2 / np.linalg.norm(pts2, axis=1, keepdims=True)
    r2[:6] = rng.normal(0, 1, (6, 3))
    r2[:6] /= np.linalg.norm(r2[:6], axis=1, keepdims=True)
    return r1, r2, R12


def phase_dynamic_start(dev):
    """(i) the SFM initialization of a drone moving at the start, and the
    essential-matrix RANSAC on the card against the host."""
    cfg = D2Config()   # the port's default dtype (float64)
    cfg.num_cams = 1
    e = cfg.estimator
    e.max_sld_win_size, e.min_solve_frames, e.max_lm_slots = 8, 4, 128
    e.max_solve_measurements, e.max_imu_samples, e.max_solver_iters = 512, 128, 5
    sim = CircleSim(dynamic_start=True)
    est = D2Estimator(cfg, sim.ext[:1], device=dev)
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    outs, first, t_prev, ms = [], None, 0.0, []
    for k in range(DYN_FRAMES):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        ff = sim.frame(k)
        ff.observations = ff.observations[:1]
        t0 = time.perf_counter()
        od = est.input_frame(ff)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if od is not None:
            first = k if first is None else first
            outs.append((np.asarray(od.pose, np.float64), sim.gt_pose(t)[0], od))
    ate = float("nan")
    if outs:
        align = np_lie.pose_compose(outs[0][1], np_lie.pose_inverse(outs[0][0]))
        ate = float(np.sqrt(np.mean([np.sum((np_lie.pose_compose(align, p)[:3] - g[:3]) ** 2)
                                     for p, g, _ in outs])))
    speed = float(np.linalg.norm(outs[-1][2].vel)) if outs else float("nan")

    r1, r2, R12 = essential_data()
    solve_relative_pose(r1, r2, thresh=1e-4, device=dev)   # warm: solver handles
    rel = {}
    for path, d in (("host", False), ("device", dev), ("device_2", dev), ("host_2", False)):
        t0 = time.perf_counter()
        R, _, inl = solve_relative_pose(r1, r2, thresh=1e-4, device=d)
        rel[path + "_ms"] = (time.perf_counter() - t0) * 1e3
        rel[path + "_inliers"] = int(inl.sum())
        rel.setdefault("R_" + path.split("_")[0], R)
    Rh, Rd = rel.pop("R_host"), rel.pop("R_device")
    rot = (float(np.arccos(np.clip((np.trace(Rh.T @ Rd) - 1) / 2, -1, 1)))
           if Rh is not None and Rd is not None else float("inf"))
    res = dict(initialized=est.initialized, first_initialized_frame=first, outputs=len(outs),
               speed_mps=speed, ate_m=ate, ms_per_frame=float(np.mean(ms)),
               relative_pose=dict(rotation_diff_rad=rot, **rel))
    print("phase i (dynamic start, SFM initialization, essential RANSAC): " + json.dumps(res),
          flush=True)
    if not (est.initialized and len(outs) >= DYN_MIN_OUT
            and abs(speed - DYN_SPEED) < DYN_SPEED_TOL and ate < DYN_ATE):
        fail(f"dynamic start out of its pins: {res}")
    if rel["host_inliers"] != rel["device_inliers"] or not rot < REL_POSE_ROT_TOL:
        fail(f"essential RANSAC on the card differs from the host: {res['relative_pose']}")
    return res


def golden_config(num_cams=2, lm_slots=128, measurements=512):
    """Estimator config of the JAX package's golden image tests
    (tests/test_golden_image_vio.py; with 4 cameras, 160 slots and 640
    measurements, tests/test_golden_quadcam_image.py)."""
    cfg = D2Config()
    cfg.num_cams = num_cams
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = lm_slots
    e.max_solve_measurements = measurements
    e.max_imu_samples = 128
    e.max_solver_iters = 5
    e.focal_length = 220.0
    return cfg


def golden_disparity_rms(dev):
    """Pair 0's disparity RMS against the analytic wall at the set-up
    and on the selection of the JAX package's golden test: fisheyes
    240x320 with f = 95, virtual views 120x160, max_disp 32, block 7."""
    ext = fisheye_ring_extrinsics(0.3)
    fish = [KBParams.make(95.0, 95.0, 160.0, 120.0, k2=0.005) for _ in range(4)]
    cfg = QuadcamConfig(out_hw=(120, 160), min_z=1.0, max_z=20.0, max_disp=32, block=7)
    pairs = build_virtual_stereo(fish, ext, cfg, device=dev)
    imgs = [render_cylinder_wall(fish[i], ext[i], (240, 320), WALL_RADIUS, seed=7)
            for i in range(4)]
    pts, ok = quadcam_depth(imgs, pairs, cfg, device=dev)[0]
    ok = ok.cpu().numpy()
    z = pts[..., 2].cpu().numpy()
    disp = np.where(ok, pairs[0].focal * pairs[0].baseline / np.maximum(z, 1e-6), 0.0)
    disp_gt = cylinder_wall_disparity(pairs[0].focal, pairs[0].baseline, ext[0], (120, 160),
                                      WALL_RADIUS)
    sel = ok & (disp > 0.5) & (disp_gt < cfg.max_disp - 1)
    sel[:, :8] = False  # left occlusion band
    rms = float(np.sqrt(np.mean((disp[sel] - disp_gt[sel]) ** 2))) if sel.any() else float("nan")
    return rms, float(sel.mean())


def phase_quadcam_depth(dev, n_frames=6):
    """(d) the quadcam depth path at full width."""
    rms, sel = golden_disparity_rms(dev)
    if not (sel > 0.3 and rms < GOLDEN_QUADCAM_DISP_RMS):
        fail(f"quadcam disparity RMS {rms} px on {sel:.2f} of the pixels "
             f"(pin {GOLDEN_QUADCAM_DISP_RMS} px on > 0.3)")

    HF, WF = 480, 640
    ext = fisheye_ring_extrinsics(0.3)
    fish = [KBParams.make(190.0, 190.0, WF / 2, HF / 2, k2=0.005) for _ in range(4)]
    cfg = QuadcamConfig(out_hw=(240, 320), min_z=1.0, max_z=20.0)
    pairs = build_virtual_stereo(fish, ext, cfg, device=dev)
    tints = np.array([[1.0, 0.6, 0.6], [0.6, 1.0, 0.6], [0.6, 0.6, 1.0], [1.0, 1.0, 0.6]],
                     np.float32)
    # a new wall texture every frame, rendered before the timed loop
    frames = []
    for k in range(n_frames):
        imgs = np.stack([render_cylinder_wall(fish[i], ext[i], (HF, WF), WALL_RADIUS, seed=k)
                         for i in range(4)])
        frames.append((imgs, imgs[..., None] * tints[:, None, None, :]))
    quadcam_depth(frames[0][0], pairs, cfg, color_images=frames[0][1], device=dev)  # warm
    torch.cuda.synchronize()

    bm.launches = 0
    medians, valid_share, n_points, frame_ms = [], [], 0, []
    for imgs, colors in frames:
        t0 = time.perf_counter()
        out = quadcam_depth(imgs, pairs, cfg, color_images=colors, device=dev)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        qualified = 0
        for k, (pts, ok, tex) in enumerate(out):
            share = float(ok.float().mean())
            valid_share.append(share)
            if (pts.shape != (240, 320, 3) or tex.shape != (240, 320, 3)
                    or not bool(torch.isfinite(pts[ok]).all())
                    or cloud_in_body(pairs[k], pts).shape != pts.shape):
                fail(f"quadcam pair {k}: bad cloud")
            if share < 0.05:
                continue
            med = float(pts[..., 2][ok].median())
            medians.append(med)
            if not WALL_DEPTH_RANGE[0] < med < WALL_DEPTH_RANGE[1]:
                fail(f"quadcam pair {k}: median depth {med} m outside {WALL_DEPTH_RANGE}")
            qualified += 1
            n_points += int(ok.sum())
        if not qualified:
            fail("no quadcam pair produced valid depth")
    launches = bm.launches
    if launches != 2 * n_frames:
        fail(f"stereo_bm launches {launches} != 2 x {n_frames} frames")

    # the frame's stages, timed apart on the last frame's tensors
    t0 = time.perf_counter()
    imgs, colors = (torch.as_tensor(x, device=dev) for x in frames[-1])
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    li, ri = [p.cam_left for p in pairs], [p.cam_right for p in pairs]
    maps_l = torch.stack([p.map_left for p in pairs])
    src = torch.cat([imgs[li], imgs[ri]] + [colors[li][..., c] for c in range(3)])
    maps = torch.cat([maps_l, torch.stack([p.map_right for p in pairs])] + [maps_l] * 3)
    views = remap_bilinear(src, maps)
    left, right = views[:4].contiguous(), views[4:8].contiguous()
    disp, valid = disparity(left, right, cfg.max_disp, cfg.block)
    stage_ms = dict(
        upload_ms=upload_ms, upload_mbytes=(imgs.nbytes + colors.nbytes) / 1e6,
        remap_ms=time_ms(lambda: remap_bilinear(src, maps), iters=20),
        disparity_ms=time_ms(lambda: disparity(left, right, cfg.max_disp, cfg.block), iters=20),
        points_ms=time_ms(lambda: points_from_disparity(
            disp, valid, pairs[0].focal, pairs[0].baseline, 160.0, 120.0, 1.0, 20.0), iters=20),
    )

    # one frame through the HitNet option (configuration network, seeded)
    hcfg = HitNetConfig()
    hparams = hitnet_init(torch.Generator().manual_seed(0), hcfg, device=dev)
    seen = {}

    def apply(p, lft, rgt):
        seen["disp"] = hitnet_apply(p, lft[..., None], rgt[..., None], hcfg)
        return seen["disp"]

    quadcam_depth(frames[0][0], pairs, cfg, hitnet=(apply, hparams), device=dev)
    hd = seen["disp"]
    if (hd.shape != (4, 240, 320) or not bool(torch.isfinite(hd).all())
            or float(hd.min()) < 0.0):
        fail(f"HitNet disparity: shape {tuple(hd.shape)}, min {float(hd.min())}")

    res = dict(frames=n_frames, bm_launches=launches, golden_disp_rms_px=rms,
               golden_selected=sel, median_depth_m=[min(medians), max(medians)],
               valid_share=[min(valid_share), max(valid_share)],
               points_per_frame=n_points / n_frames,
               frame_ms_mean=float(np.mean(frame_ms)), frame_ms_median=float(np.median(frame_ms)),
               hitnet_disp_max=float(hd.max()), **stage_ms)
    print("phase d (quadcam depth, 4 fisheyes 480x640 -> 4 pairs 240x320): "
          + json.dumps(res), flush=True)
    return res


def pose_ate(poses, gts):
    """ATE (RMSE, m) of estimated poses against ground-truth poses,
    aligned on the first (the estimator's gauge)."""
    T = np_lie.pose_compose(gts[0], np_lie.pose_inverse(np.asarray(poses[0], np.float64)))
    return float(np.sqrt(np.mean([np.sum((np_lie.pose_compose(T, p)[:3] - g[:3]) ** 2)
                                  for p, g in zip(poses, gts)])))


def textured_golden_vio(params, dev, compute_dtype="float32"):
    """tests/test_golden_textured.py::test_golden_textured_vio on the card,
    with the test's float32 backbone or the bf16 one (the stem kernel)."""
    H, W, fx = 240, 320, 220.0
    room = TexturedRoom(half=14.0, height=7.0, seed=3)
    sim = CircleSim(seed=11, baseline=0.2, n_landmarks=10)
    system = D2SLAMSystem(
        golden_config(), SystemConfig(enable_loop_detection=False, enable_pgo=False), sim.ext,
        [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(2)], sp_params=params,
        sp_cfg=SuperPointConfig(max_keypoints=200, threshold=0.008, compute_dtype=compute_dtype),
        tracker_cfg=TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
        frame_rate=sim.frame_hz, device=dev)
    render = room_views(room, sim.ext, H, W, fx)
    stamps = [k / sim.frame_hz for k in range(26)]
    frames = render_ahead([lambda t=t: render(sim.gt_pose(t)[0], t) for t in stamps])
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        system.input_imu(t, a, g)
    stem.launches = 0
    t_prev, poses, gts, t0 = 0.0, [], [], time.perf_counter()
    for k, t in enumerate(stamps):
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                system.input_imu(ts, a, g)
        t_prev = t
        od = system.input_stereo(t, *frames[k])
        if od is not None:
            poses.append(od.pose)
            gts.append(sim.gt_pose(t)[0])
    torch.cuda.synchronize()
    return dict(frames=len(stamps), keyframes=len(poses), ate_m=pose_ate(poses, gts),
                stem_launches=stem.launches, ms_per_frame=(time.perf_counter() - t0) * 1e3 / 26,
                poses=np.asarray(poses, np.float64))


def textured_golden_quadcam(params, dev):
    """tests/test_golden_textured.py::test_golden_textured_quadcam on the
    card, with the test's float32 backbone."""
    H, W, fx = 240, 320, 220.0
    ext = quadcam_extrinsics()
    sim = CircleSim(seed=7, n_landmarks=10, extrinsics=ext, fov_cos=0.5)
    room = TexturedRoom(half=14.0, height=7.0, seed=5)
    sp_cfg = SuperPointConfig(max_keypoints=150, threshold=0.010, nms_radius=4,
                              compute_dtype="float32")
    tracker = FeatureTracker(SuperPoint(params, sp_cfg, device=dev), sp_cfg,
                             [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(4)],
                             TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
                             frame_rate=sim.frame_hz, extrinsics=ext)
    est = D2Estimator(golden_config(4, 160, 640), ext, device=dev)
    render = room_views(room, ext, H, W, fx)
    stamps = [k / sim.frame_hz for k in range(16)]
    frames = render_ahead([lambda t=t: render(sim.gt_pose(t)[0], t) for t in stamps])
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    stem.launches = 0
    t_prev, poses, gts = 0.0, [], []
    for k, t in enumerate(stamps):
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        ff = tracker.process_quadcam(t, k, frames[k])
        od = est.input_frame(ff) if ff is not None else None
        if od is not None:
            poses.append(od.pose)
            gts.append(sim.gt_pose(t)[0])
    return dict(frames=len(stamps), keyframes=len(poses), ate_m=pose_ate(poses, gts),
                stem_launches=stem.launches)


def textured_system(params, dev):
    """(j)'s system with loops at full width in the textured room (bf16,
    the stem kernel's path): ``run_system``'s (result, PnP arguments)."""
    sim = CircleSim(seed=11, baseline=0.2, n_landmarks=10)
    room = TexturedRoom(half=14.0, height=7.0, seed=3)
    return run_system(params, dev, 480, 640, 440.0, TEXTURED_FRAMES, sim=sim,
                      render=room_views(room, sim.ext, 480, 640, 440.0))


def phase_textured(params, dev, system=None):
    """(j) the golden textured scenarios with the JAX tests' float32
    backbone (held to their pins); then the system with loops at full
    width in the textured room (``system``, ``textured_system``'s result,
    run here when it is None)."""
    vio = textured_golden_vio(params, dev)
    quad = textured_golden_quadcam(params, dev)
    full, pnp_args = system if system is not None else textured_system(params, dev)
    vio.pop("poses")
    res = dict(golden_vio=vio, golden_quadcam=quad, system_480x640=full)
    print("phase j (textured room: golden 240x320 stereo and quadcam, stereo with the bf16 "
          "stem, system 480x640 with loops): " + json.dumps(res), flush=True)
    if (vio["keyframes"] < 15 or not vio["ate_m"] < TEXTURED_VIO_ATE
            or quad["keyframes"] < 10 or not quad["ate_m"] < TEXTURED_QUADCAM_ATE):
        fail(f"textured golden scenarios out of their pins: {vio} / {quad}")
    # PGO against VIO is printed here, not gated. In this room the JAX
    # package, run on the same frames at this width (float32 on the CPU,
    # tests/test_torch_image_witness.py), verifies the one loop this
    # system verifies and PGO moves the trajectory by what that loop's
    # error and the odometry's drift make it; the port equals it there.
    # Phase f holds the gate on its blob lap.
    if not full["finite"] or full["pgo_solves"] < 2 or full["loops_kept_by_pcm"] < 1:
        fail(f"textured-room system out of its pins: {full}")
    if full["stem_launches"] != full["frames"]:
        fail(f"phase j: stem launches {full['stem_launches']} != frames {full['frames']}")
    return res, pnp_args


def perturbed_extrinsics(ext):
    """tests/test_online_calib.py's perturbation: 3 degrees of rotation
    about a random axis and 2 cm of translation on each camera."""
    rng = np.random.default_rng(7)
    pert = ext.copy()
    for c in range(len(pert)):
        axis = rng.normal(0, 1, 3)
        axis /= np.linalg.norm(axis)
        ang = np.radians(3.0)
        pert[c, 3:] = np_lie.quat_mul(pert[c, 3:], np.concatenate(
            [np.sin(ang / 2) * axis, [np.cos(ang / 2)]]))
        pert[c, :3] += rng.normal(0, 0.02, 3)
    return pert


def rot_err_deg(q_est, q_true):
    dq = np_lie.quat_mul(np_lie.quat_conj(np.asarray(q_true, np.float64)),
                         np.asarray(q_est, np.float64))
    return float(np.degrees(2 * np.arcsin(min(1.0, np.linalg.norm(dq[:3])))))


def splat_depth(pts_w, T_cam, fx, H, W):
    """The scene's depth image: each landmark's camera-frame z on a 7x7
    disk around its projection, 0 (no measurement) elsewhere."""
    pc = (pts_w - T_cam[:3]) @ np_lie.quat_to_rotmat(T_cam[3:])
    d = np.zeros((H, W))
    for p in pc[pc[:, 2] > 0.5]:
        u, v = int(round(fx * p[0] / p[2] + W / 2)), int(round(fx * p[1] / p[2] + H / 2))
        if 3 <= u < W - 3 and 3 <= v < H - 3:
            d[v - 3: v + 4, u - 3: u + 4] = p[2]
    return d


def run_option(params, dev, option, H=480, W=640, fx=440.0, n_frames=OPTION_FRAMES):
    """(k) ``D2SLAMSystem`` over (c)'s scene with one estimator option:
    "default", "pos3d", "dogleg" or "rgbd" (camera 0 and a depth image
    through ``input_rgbd``)."""
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=300)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    cfg = D2Config()
    e = cfg.estimator
    e.focal_length = fx
    ext, tr_kw = sim.ext, {}
    if option == "pos3d":
        e.landmark_param = "pos3d"
    elif option == "dogleg":
        e.solver_method = "dogleg"
    elif option == "rgbd":
        cfg.num_cams = 1
        ext = sim.ext[:1]
        tr_kw = dict(depth_min=0.3, depth_max=20.0)
    system = D2SLAMSystem(
        cfg, SystemConfig(enable_loop_detection=False, enable_pgo=False), ext,
        [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in ext], sp_params=params,
        sp_cfg=SuperPointConfig(compute_dtype="bfloat16"), tracker_cfg=TrackerConfig(**tr_kw),
        frame_rate=sim.frame_hz, device=dev)
    stamps = [k / sim.frame_hz for k in range(n_frames)]

    def render(t):
        pose_gt, _ = sim.gt_pose(t)
        T = [np_lie.pose_compose(pose_gt, sim.ext[c]) for c in range(len(ext))]
        imgs = [render_blobs(sim.lms, Tc, fx, fx, W / 2, H / 2, H, W, intensities=inten)
                for Tc in T]
        return imgs + ([splat_depth(sim.lms, T[0], fx, H, W), T[0]] if option == "rgbd" else [])

    frames = render_ahead([lambda t=t: render(t) for t in stamps])
    attached = []
    if option == "rgbd":
        track = system.tracker.process_rgbd

        def recording(t, k, img, depth):
            ff = track(t, k, img, depth)
            if ff is not None:
                o = ff.observations[0]
                attached.append((k, o.depths * o.rays[:, 2]))   # the measured z back
            return ff
        system.tracker.process_rgbd = recording
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        system.input_imu(t, a, g)
    system.tracker.extract(np.zeros((len(ext), H, W), np.float32))   # warm; not counted
    torch.cuda.synchronize()
    stem.launches = 0
    t_prev, poses, gts, t0 = 0.0, [], [], time.perf_counter()
    for k, t in enumerate(stamps):
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                system.input_imu(ts, a, g)
        t_prev = t
        f = frames[k]
        od = (system.input_rgbd(t, f[0], f[1]) if option == "rgbd"
              else system.input_stereo(t, f[0], f[1]))
        if od is not None:
            poses.append(od.pose)
            gts.append(sim.gt_pose(t)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    est = system.estimator
    res = dict(option=option, frames=n_frames, keyframes=len(poses), solves=est.solve_count,
               ate_m=pose_ate(poses, gts) if poses else float("nan"),
               finite=bool(poses) and bool(np.isfinite(np.asarray(poses)).all()),
               stem_launches=stem.launches, ms_per_frame=wall * 1e3 / n_frames,
               estimator_ms_per_keyframe=est.perf.report().get("input_frame", {}).get("mean_ms"),
               estimator_stages={k: v["mean_ms"] for k, v in est.perf.report().items()})
    if option == "default":
        res.update(checkpoint=checkpoint_roundtrip(system, stamps[-1] + 0.05))
    if option == "rgbd":
        n_dep, worst = 0, 0.0
        for k, dep in attached:
            T = frames[k][2]
            z = ((sim.lms - T[:3]) @ np_lie.quat_to_rotmat(T[3:]))[:, 2]
            pos = dep[dep > 0]
            n_dep += len(pos)
            if len(pos):
                worst = max(worst, float(np.abs(z[None] - pos[:, None]).min(1).max()))
        res.update(depth_keypoints=n_dep, depth_max_err_m=worst)
    return res


def calibration_tests(dev):
    """tests/test_online_calib.py's two recovery tests on the card, on
    their own inputs (CircleSim's oracle features, 24 frames, window 8):
    the extrinsics from the perturbation, td from an 8 ms delay."""
    def run(sim, ext, **flags):
        cfg = golden_config(measurements=512)
        cfg.estimator.max_solver_iters = 8
        cfg.estimator.focal_length = D2Config().estimator.focal_length
        for k, v in flags.items():
            setattr(cfg.estimator, k, v)
        est = D2Estimator(cfg, ext, device=dev)
        for (t, a, g) in sim.imu_samples(-0.3, 0.0):
            est.input_imu(t, a, g)
        t_prev, t0 = 0.0, time.perf_counter()
        for k in range(24):
            t = k / sim.frame_hz
            if k:
                for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                    est.input_imu(ts, a, g)
            t_prev = t
            est.input_frame(sim.frame(k))
        torch.cuda.synchronize()
        return est, (time.perf_counter() - t0) * 1e3 / est.solve_count

    sim = CircleSim(n_landmarks=300, seed=3, baseline=0.2, wobble=0.18)
    pert = perturbed_extrinsics(sim.ext)
    est, ms = run(sim, pert, estimate_extrinsic=True)
    got = est.state.ext.cpu().double().numpy()
    ext = dict(rot_err_deg=[[rot_err_deg(pert[c, 3:], sim.ext[c, 3:]),
                             rot_err_deg(got[c, 3:], sim.ext[c, 3:])] for c in range(2)],
               trans_err_m=[[float(np.linalg.norm(pert[c, :3] - sim.ext[c, :3])),
                             float(np.linalg.norm(got[c, :3] - sim.ext[c, :3]))]
                            for c in range(2)], ms_per_solve=ms)
    sim = CircleSim(n_landmarks=300, seed=5, baseline=0.2, cam_td=CALIB_TD)
    est, ms = run(sim, sim.ext, estimate_td=True)
    td = dict(td_s=float(est.state.td), ms_per_solve=ms,
              finite=bool(np.isfinite(est.latest_odometry().pose).all()))
    return dict(extrinsic=ext, td=td)


def calibration_from_images(params, dev, mode, H=480, W=640, fx=440.0, n_frames=12):
    """(k) tests/test_online_calib.py's recovery runs from rendered blob
    images through ``D2SLAMSystem`` (bf16 stem): ``mode`` "extrinsic"
    (the perturbed extrinsics given to the system) or "td" (the images
    rendered 8 ms after their stamps). Printed beside the oracle runs,
    not gated: from images neither package holds those pins (PERF.md)."""
    if mode == "extrinsic":
        sim = CircleSim(n_landmarks=300, seed=3, baseline=0.2, wobble=0.18)
        ext = perturbed_extrinsics(sim.ext)
    else:
        sim = CircleSim(n_landmarks=300, seed=5, baseline=0.2, cam_td=CALIB_TD)
        ext = sim.ext
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    cfg = golden_config()
    cfg.estimator.max_solver_iters = 8
    cfg.estimator.focal_length = fx
    setattr(cfg.estimator, "estimate_extrinsic" if mode == "extrinsic" else "estimate_td", True)
    system = D2SLAMSystem(
        cfg, SystemConfig(enable_loop_detection=False, enable_pgo=False), ext,
        [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(2)], sp_params=params,
        sp_cfg=SuperPointConfig(compute_dtype="bfloat16"), frame_rate=sim.frame_hz, device=dev)
    stamps = [k / sim.frame_hz for k in range(n_frames)]

    def render(t):
        pose_c = sim.gt_pose(t + sim.cam_td)[0]   # the capture instant
        return [render_blobs(sim.lms, np_lie.pose_compose(pose_c, sim.ext[c]), fx, fx,
                             W / 2, H / 2, H, W, intensities=inten) for c in range(2)]

    frames = render_ahead([lambda t=t: render(t) for t in stamps])
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        system.input_imu(t, a, g)
    stem.launches = 0
    t_prev, poses, gts, t0 = 0.0, [], [], time.perf_counter()
    for k, t in enumerate(stamps):
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                system.input_imu(ts, a, g)
        t_prev = t
        od = system.input_stereo(t, *frames[k])
        if od is not None:
            poses.append(od.pose)
            gts.append(sim.gt_pose(t)[0])
    torch.cuda.synchronize()
    est = system.estimator
    res = dict(frames=n_frames, keyframes=len(poses), ate_m=pose_ate(poses, gts),
               stem_launches=stem.launches,
               ms_per_keyframe=(time.perf_counter() - t0) * 1e3 / max(est.solve_count, 1))
    if mode == "extrinsic":
        got = est.state.ext.cpu().double().numpy()
        res.update(rot_err_deg=[[rot_err_deg(ext[c, 3:], sim.ext[c, 3:]),
                                 rot_err_deg(got[c, 3:], sim.ext[c, 3:])] for c in range(2)],
                   trans_err_m=[[float(np.linalg.norm(ext[c, :3] - sim.ext[c, :3])),
                                 float(np.linalg.norm(got[c, :3] - sim.ext[c, :3]))]
                                for c in range(2)])
    else:
        res.update(td_s=float(est.state.td))
    return res


def checkpoint_roundtrip(system, t_ahead):
    """Save the system's estimator, load it into a fresh one on the card:
    the state and prior come back equal; and the IMU-rate odometry a
    little past the last frame."""
    est = system.estimator
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "est.npz")
        save_estimator(path, est)
        est2 = D2Estimator(est.cfg, system.ext, device=est.device)
        load_estimator(path, est2)
    same = (all(torch.equal(a, b) for a, b in zip(est.state, est2.state))
            and torch.equal(est.prior.J, est2.prior.J) and est2.frames[-1].frame_id
            == est.frames[-1].frame_id)
    od = est.imu_propagated_odometry(t_ahead)
    return dict(equal=bool(same), imu_odometry_finite=bool(np.isfinite(od.pose).all()))


def phase_options(params, dev):
    """(k) the estimator's options at full width against the default, the
    calibration tests on their own inputs, and calibration from images."""
    runs = {opt: run_option(params, dev, opt)
            for opt in ("default", "pos3d", "dogleg", "rgbd")}
    runs["calibration_tests"] = calib = calibration_tests(dev)
    runs["calibration_from_images"] = {m: calibration_from_images(params, dev, m)
                                       for m in ("extrinsic", "td")}
    print(f"phase k (estimator options at 480x640, {OPTION_FRAMES} frames each; the calibration tests "
          "on their oracle inputs, gated, and from images at 480x640, printed): "
          + json.dumps(runs), flush=True)
    base = runs["default"]["ate_m"]
    for opt in ("pos3d", "dogleg"):
        r = runs[opt]
        if not (r["finite"] and r["ate_m"] < OPTION_ATE and abs(r["ate_m"] - base) < OPTION_ATE_GAP):
            fail(f"{opt} run out of its pins (ATE < {OPTION_ATE} m, within {OPTION_ATE_GAP} m "
                 f"of the default run's {base}): {r}")
    c, d = calib["extrinsic"], calib["td"]
    if not (all(r1 < CALIB_ROT_SHARE * r0 for r0, r1 in c["rot_err_deg"])
            and all(t1 < CALIB_TRANS_SHARE * t0 for t0, t1 in c["trans_err_m"])):
        fail(f"extrinsic calibration out of tests/test_online_calib.py's pins: {c}")
    if not (d["finite"] and abs(d["td_s"] - CALIB_TD) < CALIB_TD_SHARE * CALIB_TD):
        fail(f"td calibration out of tests/test_online_calib.py's pin: {d}")
    if not all(runs["default"]["checkpoint"].values()):
        fail(f"estimator checkpoint on the card: {runs['default']['checkpoint']}")
    r = runs["rgbd"]
    if not (r["finite"] and r["depth_keypoints"] >= RGBD_MIN_DEPTHS
            and r["depth_max_err_m"] < RGBD_DEPTH_TOL):
        fail(f"RGB-D run out of its pins: {r}")
    for opt, r in list(runs.items()) + list(runs["calibration_from_images"].items()):
        if not opt.startswith("calibration") and r["stem_launches"] != r["frames"]:
            fail(f"phase k {opt}: stem launches {r['stem_launches']} != frames {r['frames']}")
    return runs


def phase_depth_replay(dev, n_frames=REPLAY_FRAMES):
    """(l) the threaded depth replay on (d)'s rig with uint8 frames."""
    from d2slam_tpu_torch.depth.quadcam import _stack

    HF, WF = 480, 640
    ext = fisheye_ring_extrinsics(0.3)
    fish = [KBParams.make(190.0, 190.0, WF / 2, HF / 2, k2=0.005) for _ in range(4)]
    cfg = QuadcamConfig(out_hw=(240, 320), min_z=1.0, max_z=20.0)
    pairs = build_virtual_stereo(fish, ext, cfg, device=dev)
    tints = np.array([[1.0, 0.6, 0.6], [0.6, 1.0, 0.6], [0.6, 0.6, 1.0], [1.0, 1.0, 0.6]])

    def frame(k):
        imgs = np.stack([render_cylinder_wall(fish[i], ext[i], (HF, WF), WALL_RADIUS, seed=k)
                         for i in range(4)])
        return (np.round(imgs * 255).astype(np.uint8),
                np.round(imgs[..., None] * tints[:, None, None, :] * 255).astype(np.uint8))

    frames = render_ahead([lambda k=k: frame(k) for k in range(n_frames)])
    serial_depth(frames[:1], pairs, cfg, device=dev)   # warm
    torch.cuda.synchronize()
    bm.launches = 0
    t0 = time.perf_counter()
    serial = serial_depth(frames, pairs, cfg, device=dev)
    serial_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    launches_serial, bm.launches = bm.launches, 0
    replay = DepthReplay(pairs, cfg, device=dev)
    t0 = time.perf_counter()
    threaded = replay.run(frames)
    threaded_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    launches_threaded = bm.launches
    equal = clouds_equal(threaded, serial)

    # the upload of one frame's images and textures: uint8 from pinned
    # staging, converted on the card, against float32 of the same values
    def upload(pair):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = [_stack(x, dev) for x in pair]
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    f32 = [tuple(x.astype(np.float32) for x in f) for f in frames]
    upload(frames[0])
    upload(f32[0])   # warm both routes
    u8_ms, f32_ms, same = [], [], True
    for fu, ff in zip(frames, f32):
        tu, a = upload(fu)
        tf, b = upload(ff)
        u8_ms.append(tu)
        f32_ms.append(tf)
        same &= all(torch.equal(x, y) for x, y in zip(a, b))
    res = dict(frames=n_frames, clouds_equal=equal, uploads_equal=bool(same),
               serial_ms_per_frame=serial_ms, threaded_ms_per_frame=threaded_ms,
               stage_ms={k: v.mean_ms for k, v in replay.stats.items()},
               bm_launches=[launches_serial, launches_threaded],
               upload_u8_ms=float(np.mean(u8_ms)), upload_f32_ms=float(np.mean(f32_ms)),
               upload_u8_mbytes=sum(x.nbytes for x in frames[0]) / 1e6,
               upload_f32_mbytes=sum(x.nbytes for x in f32[0]) / 1e6)
    print("phase l (threaded quadcam depth replay, uint8 frames): " + json.dumps(res),
          flush=True)
    if not (equal and same):
        fail(f"threaded replay or uint8 upload differ from the serial / float32 route: {res}")
    if launches_threaded != 2 * n_frames or launches_serial != 2 * n_frames:
        fail(f"stereo_bm launches {res['bm_launches']} != 2 x {n_frames} frames")
    return res


def superglue_sets(n, D, seed):
    """Two sets of ``n`` keypoints in a 480x640 image whose first 60 %
    correspond (shifted 3 px, descriptor noise), from a numpy seed."""
    rng = np.random.default_rng(seed)
    k = int(0.6 * n)
    ka = rng.uniform(0, [640, 480], (n, 2)).astype(np.float32)
    kb = rng.uniform(0, [640, 480], (n, 2)).astype(np.float32)
    da = rng.normal(size=(n, D)).astype(np.float32)
    db = rng.normal(size=(n, D)).astype(np.float32)
    kb[:k], db[:k] = ka[:k] + 3.0, da[:k] + 0.3 * rng.normal(size=(k, D)).astype(np.float32)
    da /= np.linalg.norm(da, axis=1, keepdims=True)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    return (ka, da, rng.uniform(0.1, 1, n).astype(np.float32), np.ones(n, bool),
            kb, db, rng.uniform(0.1, 1, n).astype(np.float32), np.ones(n, bool))


def superglue_9layer_random():
    """The default 9-layer net from a seeded random init, scaled so that it
    is well conditioned: He-normal weights alone grow the features ~1e11-fold
    through 18 residual attention blocks and match nothing. The residual
    branches' last layers and the keypoint encoder's output are scaled by
    0.1 and the final projection by 8, so the features stay near the
    descriptors and the corresponding points of ``superglue_sets`` match
    (184 matches, 180 of them right, on the CPU)."""
    params = sg.superglue_init(torch.Generator().manual_seed(0))
    params["kenc2"]["w"] *= 0.1
    params["final"]["w"] *= 8.0
    for name, node in params.items():
        if name.startswith(("self", "cross")):
            node["mlp2"]["w"] *= 0.1
    return params


def superglue_alone(dev):
    """(m.1) SuperGlue at 300 x 300 keypoints, 256-d: the shipped compact
    weights and the default 9-layer config from a scaled random init. The
    card's log-assignment against the same module on the CPU (within
    ``SG_LOGP_TOL`` of the matrix's largest magnitude) and their matches;
    ms and kernel launches per call; the kNN ratio matcher on the same
    sets."""
    out = {}
    for name, params, cfg in (
            ("compact_3layer_shipped", load_weights(SUPERGLUE_WEIGHTS), sg.COMPACT),
            ("default_9layer_random_scaled", superglue_9layer_random(), sg.SuperGlueConfig())):
        sets = superglue_sets(300, 256, seed=5)
        hw = (480, 640)
        gpu = sg.SuperGlue(params, cfg, device=dev)
        cpu = sg.SuperGlue(params, cfg, device="cpu")
        Lg = gpu.logP(*sets, hw).cpu().numpy()
        Lc = cpu.logP(*sets, hw).numpy()
        scale = max(1.0, float(np.abs(Lc).max()))
        err = float(np.abs(Lg - Lc).max())
        ig, og = gpu.match(*sets, hw)
        ic, oc = cpu.match(*sets, hw)
        t = [torch.as_tensor(x, device=dev) for x in sets]
        ka, da, _, va, kb, db, _, vb = t
        out[name] = dict(
            layers=cfg.num_layers, sinkhorn_iters=cfg.sinkhorn_iters,
            logP_max_abs_err=err, logP_scale=scale, tol=SG_LOGP_TOL * scale,
            matches_card=int(og.sum()), matches_cpu=int(oc.sum()),
            equal_matches=int(np.sum(og & oc & (ig == ic))),
            ms_per_call=time_ms(lambda: gpu.logP(*t, hw), iters=20, warmup=3),
            launches_per_call=count_launches(lambda: gpu.logP(*t, hw)),
            knn_ms=time_ms(lambda: match_descriptors_radius(da, db, ka, kb, va, vb,
                                                            radius=1e9), iters=20, warmup=3))
        r = out[name]
        if not (np.isfinite(Lg).all() and err <= SG_LOGP_TOL * scale and r["matches_cpu"] > 0
                and r["equal_matches"] >= SG_MIN_EQUAL_MATCHES * r["matches_cpu"]):
            fail(f"SuperGlue on the card differs from its CPU result: {r}")
    return out


def swarm_run(params, dev, H, W, fx, n_frames, compute_dtype, superglue_local=False):
    """Two ``D2SLAMSystem``s in the golden textured room
    (tests/test_golden_textured.py::test_golden_textured_swarm: CircleSim
    seed 7 at phases 0 and 0.3, 300 keypoints, threshold 0.008, NetVLAD,
    SuperGlue remote with the shipped weights, its loop gates) on a
    ``LocalBus``, greedy broadcast, each polling after every frame; then
    each robot solves its joint pose graph. The test's pins read robot 1's
    graph (robot 1 merges into robot 0's reference frame, so its peer
    never changes world): the graph the JAX package's run of the test
    reads, where robot 0 verifies no inter-robot loop itself. Robot 0's
    graph chains robot 1's keyframes across that merge with an ego edge
    holding the jump, in both packages (ROADMAP Queue 3): printed."""
    room = TexturedRoom(half=14.0, height=7.0, seed=3)
    sims = [CircleSim(seed=7, baseline=0.2, n_landmarks=10, phase=ph) for ph in (0.0, 0.3)]
    stamps = [k / sims[0].frame_hz for k in range(n_frames)]
    renders = [room_views(room, sim.ext, H, W, fx) for sim in sims]
    frames = render_ahead([lambda t=t, i=i: renders[i](sims[i].gt_pose(t)[0], t)
                           for t in stamps for i in range(2)])
    bus = LocalBus()
    systems, sg_ms = [], {"local": [], "remote": []}

    def timed(fn, key):
        def run(*a):
            t0 = time.perf_counter()
            r = fn(*a)
            sg_ms[key].append((time.perf_counter() - t0) * 1e3)   # returns host arrays
            return r
        return run

    for i, sim in enumerate(sims):
        cfg = golden_config()
        cfg.estimator.focal_length = fx
        s = D2SLAMSystem(
            cfg, SystemConfig(drone_id=i, pgo_every_n_kf=100, netvlad_weights=NETVLAD_WEIGHTS,
                              enable_superglue_remote=True, enable_superglue_local=superglue_local,
                              superglue_img_hw=(H, W), superglue_weights=SUPERGLUE_WEIGHTS),
            sim.ext, [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(2)],
            sp_params=params, sp_cfg=SuperPointConfig(max_keypoints=300, threshold=0.008,
                                                      compute_dtype=compute_dtype),
            transport=bus.endpoint(i),
            tracker_cfg=TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
            loop_cfg=LoopDetectorConfig(gdesc_dim=1024, min_gap_frames=2, min_inliers=20,
                                        min_match_per_dir=8, pnp_thresh=16.0 / 460.0),
            frame_rate=sim.frame_hz, device=dev)
        s.detector.matcher_fn = timed(s.detector.matcher_fn, "remote")
        if superglue_local:
            s.tracker.matcher_fn = timed(s.tracker.matcher_fn, "local")
        s.tracker.extract(np.zeros((2, H, W), np.float32))   # warm, not counted
        systems.append(s)
    for s, sim in zip(systems, sims):
        for (t, a, g) in sim.imu_samples(-0.3, 0.0):
            s.input_imu(t, a, g)
    torch.cuda.synchronize()
    stem.launches = 0
    for s in systems:
        s.superglue.calls = 0
    t_prev, t_run = 0.0, time.perf_counter()
    for k, t in enumerate(stamps):
        for i, (s, sim) in enumerate(zip(systems, sims)):
            if k:
                for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                    s.input_imu(ts, a, g)
            s.input_stereo(t, *frames[2 * k + i])
        t_prev = t
        for s in systems:
            s.poll_network(now=t)
    for _ in range(3):
        for s in systems:
            s.poll_network(now=t_prev)
    res = dict(frames_per_robot=n_frames, hw=[H, W], compute_dtype=compute_dtype,
               superglue_local=superglue_local, stem_launches=stem.launches,
               aligned=bool(systems[1].swarm.alignments),
               merged_drones=[s.drone_id for s in systems if s.ref_frame_id != s.drone_id])
    for s in systems:
        s.solve_pgo()
    wall = time.perf_counter() - t_run
    res["ms_per_frame_per_robot"] = wall * 1e3 / (2 * n_frames)
    robots = []
    for s in systems:
        perf, est = s.perf.report(), s.estimator.perf.report()
        inter = [e for e in s.loop_edges if e.drone_id_a != e.drone_id_b]
        peer = 1 - s.drone_id
        st_s, ego_s = s.trajectory(drone_id=s.drone_id, optimized=False)
        T = np_lie.pose_compose(sims[s.drone_id].gt_pose(st_s[0])[0],
                                np_lie.pose_inverse(ego_s[0]))
        st_o, opt_o = s.trajectory(drone_id=peer)
        errs = [np.linalg.norm(np_lie.pose_compose(T, p)[:3] - sims[peer].gt_pose(t)[0][:3])
                for t, p in zip(st_o, opt_o)]
        robots.append(dict(
            peer_keyframes_in_graph=len(st_o),
            peer_rmse_m=float(np.sqrt(np.mean(np.square(errs)))) if errs else None,
            finite=bool(np.isfinite(opt_o).all()),
            longest_ego_edge_m=max((float(d) for (_, _, _, d) in s._ego_edges), default=0.0),
            drone_id=s.drone_id, ref_frame_id=s.ref_frame_id, alignments=sorted(s.swarm.alignments),
            inter_loops=len(inter), inter_inliers=[e.inliers for e in inter],
            superglue_calls=s.superglue.calls, pgo_solves=s.pgo_solve_count,
            remote_nodes=sum(d != s.drone_id for (d, _, _, _) in s._pgo_meta),
            estimator_ms={k: v["mean_ms"] for k, v in est.items()},
            stage_ms={k: v["mean_ms"] for k, v in perf.items()},
            extract_ms_per_frame=s.tracker.perf.report()["extract"]["mean_ms"],
            tracker_host_ms_per_frame=s.tracker.perf.report()["host"]["mean_ms"]))
    res["robots"] = robots
    res["superglue_ms_per_local_match"] = float(np.mean(sg_ms["local"])) if sg_ms["local"] else None
    res["superglue_ms_per_loop_candidate"] = (float(np.mean(sg_ms["remote"]))
                                              if sg_ms["remote"] else None)
    host = robots[1]
    res.update(host=1, ref_frame_ids=[s.ref_frame_id for s in systems],
               inter_loops=host["inter_loops"],
               best_inliers=max(host["inter_inliers"], default=0),
               other_keyframes_in_host_graph=host["peer_keyframes_in_graph"],
               joint_rmse_m=host["peer_rmse_m"],
               finite=all(r["finite"] for r in robots))
    return res, systems


def swarm_golden(params, dev):
    """(m.2) the JAX golden textured swarm at 240x320 with the test's
    float32 backbone."""
    return swarm_run(params, dev, 240, 320, 220.0, SWARM_GOLDEN_FRAMES, "float32")[0]


def swarm_full(params, dev):
    """(m.3) two robots at 480x640 with the bf16 stem, SuperGlue local and
    remote."""
    return swarm_run(params, dev, 480, 640, 440.0, SWARM_FULL_FRAMES, "bfloat16",
                     superglue_local=True)[0]


def phase_swarm(params, dev, alone, golden=None, full=None):
    """(m) the swarm on the card: ``alone``, SuperGlue alone (m.1,
    ``superglue_alone``); ``golden`` (m.2, ``swarm_golden``), gated by the
    JAX test's pins; ``full`` (m.3, ``swarm_full``); each run here when it
    is None."""
    golden = swarm_golden(params, dev) if golden is None else golden
    full = swarm_full(params, dev) if full is None else full
    res = dict(superglue=alone, golden_textured_swarm_f32=golden, swarm_480x640=full)
    print("phase m (swarm: SuperGlue alone, golden textured swarm 240x320, two robots "
          "480x640 with SuperGlue local and remote): " + json.dumps(res), flush=True)
    if not (golden["aligned"] and golden["inter_loops"] >= SWARM_MIN_INTER_LOOPS
            and golden["best_inliers"] >= SWARM_MIN_BEST_INLIERS
            and golden["other_keyframes_in_host_graph"] >= 8 and golden["finite"]
            and golden["ref_frame_ids"] == [0, 0]
            and golden["joint_rmse_m"] < SWARM_JOINT_RMSE):
        fail(f"golden textured swarm out of its pins: {golden}")
    if not (full["aligned"] and full["inter_loops"] >= 1 and full["finite"]
            and any(r["pgo_solves"] >= 1 for r in full["robots"])
            and full["merged_drones"] == [1]):
        fail(f"480x640 swarm did not align, merge and solve: {full}")
    if full["stem_launches"] != 2 * full["frames_per_robot"]:
        fail(f"phase m: stem launches {full['stem_launches']} != 2 robots x "
             f"{full['frames_per_robot']} frames")
    return res


# ---------------------------------------------------------------------------
# phase n: multi-robot estimation and distributed PGO
# ---------------------------------------------------------------------------


def robot_spread(poses):
    """Largest deviation of [R, ..., 7] pose copies from their mean, the
    quaternions first put on robot 0's hemisphere (q and -q are one
    rotation)."""
    p = np.array(poses, np.float64)
    flip = np.sum(p[..., 3:] * p[:1, ..., 3:], axis=-1, keepdims=True) < 0
    p[..., 3:] = np.where(flip, -p[..., 3:], p[..., 3:])
    return float(np.abs(p - p.mean(axis=0, keepdims=True)).max())


def quat_aligned_diff(a, b):
    """max |a - b| over [..., 7] poses, a's quaternions on b's hemisphere."""
    a, b = np.array(a, np.float64), np.asarray(b, np.float64)
    flip = np.sum(a[..., 3:] * b[..., 3:], axis=-1, keepdims=True) < 0
    a[..., 3:] = np.where(flip, -a[..., 3:], a[..., 3:])
    return float(np.abs(a - b).max())


def admm_setup(dev):
    """__graft_entry__.py's consensus set-up at the default ``D2Config``
    window (11 frames, 256 landmark slots, 1000 measurements): the circle
    scene of ``make_circle_scene`` (200 landmarks, 8 Hz keyframes, 0.5 px
    noise), float64, each robot's poses perturbed by its own seeded draw
    (0.01 per tangent component), the first frame's stiff prior."""
    e = D2Config().estimator
    layout = VIOLayout(W=e.max_sld_win_size, C=2, L=e.max_lm_slots, M=e.max_solve_measurements,
                       N_IMU_SAMPLES=e.max_imu_samples)
    scene = make_circle_scene(layout, n_frames=layout.W, n_landmarks=200, dt_frame=0.125,
                              pix_noise_rad=0.5 / 460.0, device=dev)
    gt = scene["gt_state"]
    rng = np.random.default_rng(0)
    d = torch.as_tensor(rng.normal(0, 0.01, (N_ROBOTS, layout.W, 6)), device=dev)
    state = tree_map(lambda x: torch.stack([x] * N_ROBOTS), gt)
    state = state._replace(poses=pose_boxplus(state.poses, d))
    kw = dict(est_mask=torch.ones((N_ROBOTS, layout.W), dtype=torch.bool, device=dev),
              gravity=scene["gravity"], col_free=default_col_free(layout, gt, fix_first_pose=False),
              proj_sqrt_info=460.0 / 1.5, rho_T=1e3, rho_theta=1e3, max_iters=2)
    carry = ConsensusCarry(state=state, tilde=torch.zeros((N_ROBOTS, layout.W, 6),
                                                          dtype=torch.float64, device=dev))
    return layout, scene, make_pose_prior(layout, gt, frame=0), carry, kw


def admm_rounds(dev, timed):
    t0 = time.perf_counter()
    layout, scene, prior, carry, kw = admm_setup(dev)
    setup_s = time.perf_counter() - t0
    spreads, poses, ms = [robot_spread(carry.state.poses.cpu().numpy())], [], []
    for _ in range(N_ADMM_ROUNDS):
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _ = admm_vio_round(layout, carry, scene["imu"], scene["proj"], prior, **kw)
        p = carry.state.poses.cpu().numpy()
        ms.append((time.perf_counter() - t0) * 1e3)
        poses.append(p)
        spreads.append(robot_spread(p))
    t0 = time.perf_counter()
    launches = (count_launches(lambda: admm_vio_round(layout, carry, scene["imu"], scene["proj"],
                                                      prior, **kw)) if timed else None)
    return dict(spreads=spreads, ms_per_round=ms, launches_per_round=launches, setup_s=setup_s,
                count_s=time.perf_counter() - t0), poses


def ring_setup(dev, n_per=N_DPGO_PER):
    """__graft_entry__.py:139's partitioned ring for 4 robots: robot r owns
    poses [r*n_per, (r+1)*n_per), the odometry ring's edges are owned by
    their first pose's robot, every robot estimates the whole graph from
    its own drifted guess (0.3 m per position), float64."""
    R, n = N_ROBOTS, N_ROBOTS * n_per
    N_pad = max(16, 1 << (n - 1).bit_length())
    th = 2 * np.pi * np.arange(n) / n
    gt = np.zeros((n, 7))
    gt[:, 0], gt[:, 1] = 10 * np.cos(th), 10 * np.sin(th)
    gt[:, 5], gt[:, 6] = np.sin(th / 2 + np.pi / 4), np.cos(th / 2 + np.pi / 4)
    ei = np.arange(n)
    ej = (ei + 1) % n
    rel = np.stack([np_lie.pose_compose(np_lie.pose_inverse(gt[a]), gt[b]) for a, b in zip(ei, ej)])
    E_pad = max(16, 1 << (n - 1).bit_length())
    pad = np.tile([0, 0, 0, 0, 0, 0, 1.0], (E_pad, 1))
    pad[:n] = rel
    t = lambda x, dt=None: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    edges = PGOEdges(i=t(np.pad(ei, (0, E_pad - n))), j=t(np.pad(ej, (0, E_pad - n))),
                     rel=t(pad), sqrt_info=t(np.tile(np.eye(6), (E_pad, 1, 1))),
                     valid=t(np.arange(E_pad) < n))
    edge_mask = np.zeros((R, E_pad), bool)
    edge_mask[ei // n_per, np.arange(n)] = True
    rng = np.random.default_rng(1)
    poses = np.tile([0, 0, 0, 0, 0, 0, 1.0], (R, N_pad, 1))
    for r in range(R):
        poses[r, :n] = gt
        poses[r, 1:n, :3] += rng.normal(0, 0.3, (n - 1, 3))
    est = np.zeros((R, N_pad), bool)
    est[:, :n] = True
    own = np.zeros((R, N_pad), bool)
    for r in range(R):
        own[r, r * n_per:(r + 1) * n_per] = True
    fixed = np.zeros(N_pad, bool)
    fixed[0] = True
    return (PGOLayout(N_pad, E_pad, 6), PGOState(t(poses), t(np.arange(N_pad) < n)), edges,
            dict(est_mask=t(est), own_mask=t(own), fixed_mask=t(fixed), edge_mask=t(edge_mask)),
            own, n)


def dpgo_rounds(dev, timed):
    layout, state, edges, masks, own, n = ring_setup(dev)
    kw = dict(eta=0.9, rho=1.0, max_iters=3)
    if timed:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = distributed_pgo_solve(layout, state, edges, rounds=0, **masks)
    init_ms = (time.perf_counter() - t0) * 1e3
    carry = ARockPGOCarry(state, torch.zeros((N_ROBOTS, layout.N, 6), dtype=torch.float64,
                                             device=dev))
    spreads, ms = [robot_spread(state.poses[:, :n].cpu().numpy())], []
    for _ in range(N_DPGO_ROUNDS):
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _ = arock_pgo_round(layout, carry, edges, **masks, **kw)
        p = carry.state.poses[:, :n].cpu().numpy()
        ms.append((time.perf_counter() - t0) * 1e3)
        spreads.append(robot_spread(p))
    launches = (count_launches(lambda: arock_pgo_round(layout, carry, edges, **masks, **kw))
                if timed else None)
    out = dict(rot_init_ms=init_ms, ms_per_round=ms, launches_per_round=launches,
               spreads=spreads, poses=int(layout.N))
    return out, carry.state.poses.cpu().numpy(), (layout, state, edges, masks, own, n)


def phase_multirobot_batched(dev):
    """(n.1) consensus ADMM and distributed PGO with the robots batched on
    the card, each against the same calls on the CPU."""
    t0 = time.perf_counter()
    admm, admm_poses = admm_rounds(dev, timed=True)
    t1 = time.perf_counter()
    _, cpu_poses = admm_rounds(torch.device("cpu"), timed=False)
    admm.update(card_wall_s=t1 - t0, cpu_wall_s=time.perf_counter() - t1)
    admm["card_vs_cpu"] = max(quat_aligned_diff(a, b) for a, b in zip(admm_poses, cpu_poses))
    t0 = time.perf_counter()
    dpgo, card, (layout, init, edges, masks, own, n) = dpgo_rounds(dev, timed=True)
    t1 = time.perf_counter()
    _, cpu, _ = dpgo_rounds(torch.device("cpu"), timed=False)
    dpgo.update(card_wall_s=t1 - t0, cpu_wall_s=time.perf_counter() - t1)
    dpgo["card_vs_cpu"] = quat_aligned_diff(card[:, :n], cpu[:, :n])
    central, _ = solve_pgo(layout, PGOState(init.poses[0], init.valid), edges,
                           masks["fixed_mask"], max_iters=12, device=dev)
    cen = central.poses.cpu().numpy()
    dev_c = [np.abs(np_lie_boxminus(card[r, k], cen[k])).max()
             for r in range(N_ROBOTS) for k in np.flatnonzero(own[r])]
    dpgo["max_dev_from_centralized"] = float(max(dev_c))
    res = dict(admm_vio=admm, dpgo=dpgo)
    print("phase n.1 (consensus ADMM, 4 robots at the default window; distributed PGO, "
          f"4 x {N_DPGO_PER} poses): " + json.dumps(res), flush=True)
    # the rotation initialization's average leaves the DPGO copies equal;
    # its first ARock round parts them by the robots' edge splits, and
    # every round after must bring them closer
    for what, sp in (("consensus", admm["spreads"]), ("DPGO", dpgo["spreads"][1:])):
        if not all(b < a for a, b in zip(sp, sp[1:])):
            fail(f"{what} spread did not decrease every round: {sp}")
    if not (admm["card_vs_cpu"] <= N_CARD_CPU_TOL and dpgo["card_vs_cpu"] <= N_CARD_CPU_TOL):
        fail(f"card and CPU disagree: {admm['card_vs_cpu']}, {dpgo['card_vs_cpu']}")
    if not dpgo["max_dev_from_centralized"] < N_DPGO_CENTRAL_TOL:
        fail(f"distributed PGO off the centralized solve: {dpgo['max_dev_from_centralized']}")
    return res


def np_lie_boxminus(a, b):
    """Tangent difference [dp, dtheta] of two poses (host)."""
    dq = np_lie.quat_mul(np_lie.quat_conj(b[3:] / np.linalg.norm(b[3:])),
                         a[3:] / np.linalg.norm(a[3:]))
    return np.concatenate([a[:3] - b[:3], np_lie.quat_log(dq)])


# tests/test_system.py's feature-level oracle: seeded descriptor and
# bag-of-landmark global descriptor tables
FEAT_DESC_DIM, FEAT_GDESC_DIM, FEAT_N_LM = 64, 256, 300
_feat_rng = np.random.default_rng(7)
FEAT_DESC = _feat_rng.normal(0, 1, (FEAT_N_LM, FEAT_DESC_DIM)).astype(np.float32)
FEAT_DESC /= np.linalg.norm(FEAT_DESC, axis=1, keepdims=True)
FEAT_GVEC = _feat_rng.normal(0, 1, (FEAT_N_LM, FEAT_GDESC_DIM)).astype(np.float32)


def feature_system(dev, drone_id, sim, transport, **sys_kw):
    """tests/test_system.py::make_system on the card (feature-level)."""
    cfg = golden_config()
    cfg.estimator.focal_length = 460.0
    kw = dict(pgo_every_n_kf=6, pgo_max_poses=64, pgo_max_edges=128, pgo_iters=6)
    kw.update(sys_kw)
    return D2SLAMSystem(
        cfg, SystemConfig(drone_id=drone_id, **kw), sim.ext, cameras=None,
        extract_fn=lambda img, cam: None, transport=transport,
        loop_cfg=LoopDetectorConfig(desc_dim=FEAT_DESC_DIM, gdesc_dim=FEAT_GDESC_DIM,
                                    netvlad_thres=0.5, min_match_per_dir=10, min_inliers=12,
                                    min_gap_frames=6),
        device=dev)


def feature_frame(s, sim, k, t_prev):
    """IMU since ``t_prev`` and CircleSim frame ``k`` with its cam0 entry
    and bag-of-landmark descriptor; returns the frame's stamp."""
    t = k / sim.frame_hz
    span = (-0.3, 0.0) if k == 0 else (t_prev + 1e-6, t + 1e-6)
    for (ts, a, g) in sim.imu_samples(*span):
        s.input_imu(ts, a, g)
    ff = sim.frame(k)
    ids = np.asarray(ff.observations[0].landmark_ids, int)
    g = FEAT_GVEC[ids].sum(axis=0)
    pose = s.odometry.pose if s.odometry is not None else np.eye(1, 7, 6)[0]
    entry = loop_detector.KeyframeEntry(
        frame_id=ff.frame_id, drone_id=s.drone_id, stamp=ff.stamp,
        pose=np.asarray(pose, np.float64), kpt_rays=np.asarray(ff.observations[0].rays, np.float64),
        kpt_cam=np.zeros(len(ids), np.int32), kpt_desc=FEAT_DESC[ids],
        kpt_valid=np.ones(len(ids), bool), lm_positions=np.full((len(ids), 3), np.nan))
    s.input_frame(ff, gdesc=(g / max(np.linalg.norm(g), 1e-12)).astype(np.float32),
                  kf_entry=entry)
    return t


def feature_sims():
    return (CircleSim(n_landmarks=FEAT_N_LM, seed=3, phase=0.0),
            CircleSim(n_landmarks=FEAT_N_LM, seed=3, phase=0.25))


def feature_server(dev):
    """tests/test_system.py::test_server_estimation_mode on the card."""
    bus = LocalBus()
    sim_a, sim_b = feature_sims()
    robots = [feature_system(dev, i, sim, bus.endpoint(i), assume_common_world=True)
              for i, sim in enumerate((sim_a, sim_b))]
    server = feature_system(dev, 9, sim_a, bus.endpoint(9), estimation_mode="server",
                            max_drones=2, assume_common_world=True, broadcast=False)
    t0, t_prev, solve_ms = time.perf_counter(), 0.0, []
    for k in range(14):
        for s, sim in zip(robots, (sim_a, sim_b)):
            t = feature_frame(s, sim, k, t_prev)
        t_prev = t
        server.poll_network(now=t)
        if k >= 4 and k % 2 == 0:
            ts = time.perf_counter()
            if not all(np.isfinite(od.pose).all() for od in server.solve_server().values()):
                fail("server: a non-finite fused pose")
            solve_ms.append((time.perf_counter() - ts) * 1e3)
    fused = server.solve_server()
    res = dict(drones=sorted(fused), wall_s=time.perf_counter() - t0,
               server_solve_ms=float(np.mean(solve_ms)), vs_own_vio_m={}, ate_m={})
    for did, (s, sim) in enumerate(zip(robots, (sim_a, sim_b))):
        res["vs_own_vio_m"][did] = float(np.linalg.norm(s.odometry.pose[:3] - fused[did].pose[:3]))
        traj = server.estimator.drone_trajectory(did)
        stamps = [server.estimator.frames[w].stamp for w in server.estimator._drone_slots(did)]
        res["ate_m"][did] = trajectory_ate(stamps, traj, sim)
    if not (res["drones"] == [0, 1] and max(res["vs_own_vio_m"].values()) < N_SERVER_VS_OWN
            and max(res["ate_m"].values()) < N_SERVER_ATE):
        fail(f"server scenario out of its pins: {res}")
    return res


def feature_dpgo(dev):
    """tests/test_system.py::test_two_robot_transport_dpgo on the card."""
    bus = LocalBus()
    sims = feature_sims()
    robots = [feature_system(dev, i, sim, bus.endpoint(i), enable_dpgo=True, pgo_every_n_kf=4)
              for i, sim in enumerate(sims)]
    t0, t_prev = time.perf_counter(), 0.0
    for k in range(18):
        for s, sim in zip(robots, sims):
            t = feature_frame(s, sim, k, t_prev)
        t_prev = t
        for s in robots:
            s.poll_network(now=t)
    round_ms = []
    for _ in range(8):
        for s in robots:
            s.poll_network(now=t_prev)
            ts = time.perf_counter()
            s.solve_pgo()
            round_ms.append((time.perf_counter() - ts) * 1e3)
    a, b = (s.dpgo for s in robots)
    dis = [float(np.linalg.norm(a.optimized_pose(global_frame_id(d, f))[:3]
                                - b.optimized_pose(global_frame_id(d, f))[:3]))
           for (d, f, _, _) in robots[0]._pgo_meta
           if a.optimized_pose(global_frame_id(d, f)) is not None
           and b.optimized_pose(global_frame_id(d, f)) is not None]
    res = dict(inter_loops=[sum(e.drone_id_a != e.drone_id_b for e in s.loop_edges)
                            for s in robots],
               ref_frame_ids=[s.ref_frame_id for s in robots],
               duals=[len(s.dpgo.dual_remote) for s in robots], shared_poses=len(dis),
               median_disagreement_m=float(np.median(dis)) if dis else None,
               arock_round_ms=float(np.mean(round_ms)), wall_s=time.perf_counter() - t0)
    if not (min(res["inter_loops"]) >= 1 and res["ref_frame_ids"][1] == 0
            and min(res["duals"]) >= 1 and len(dis) >= N_DPGO_MIN_SHARED
            and res["median_disagreement_m"] < N_DPGO_MEDIAN):
        fail(f"DPGO scenario out of its pins: {res}")
    return res


def lockstep(systems, step, n_frames):
    """Run ``step(system, k, t_prev) -> t`` for every frame, one thread
    per system behind a barrier at the top of each frame (the consensus
    handshake steps the robots together). Raises what a thread raised."""
    barrier = threading.Barrier(len(systems), timeout=600)
    errors = []

    def run(s):
        try:
            t_prev = 0.0
            for k in range(n_frames):
                barrier.wait()
                t_prev = step(s, k, t_prev)
        except BaseException as e:
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(s,)) for s in systems]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]


def feature_distributed(dev):
    """tests/test_system.py::test_two_robot_distributed_camera_consensus
    on the card: one thread per robot."""
    bus = LocalBus()
    sims = feature_sims()
    robots = [feature_system(dev, i, sim, bus.endpoint(i), estimation_mode="distributed",
                             max_drones=2, consensus_timeout_ms=2000)
              for i, sim in enumerate(sims)]

    def step(s, k, t_prev):
        s.poll_network(now=k / sims[s.drone_id].frame_hz)
        return feature_frame(s, sims[s.drone_id], k, t_prev)

    t0 = time.perf_counter()
    lockstep(robots, step, 18)
    a, b = robots
    T = np_lie.pose_compose(np.asarray(a.odometry.pose, np.float64),
                            np_lie.pose_inverse(sims[0].gt_pose(a.odometry.stamp)[0]))
    gt_b = np_lie.pose_compose(T, sims[1].gt_pose(b.odometry.stamp)[0])
    keys = [{s.estimator.consensus_key(f) for f in s.estimator.frames} for s in robots]
    res = dict(ref_frame_ids=[s.ref_frame_id for s in robots],
               drones_in_windows=[s.estimator.drone_ids() for s in robots],
               shared_keys=len(keys[0] & keys[1]),
               err_b_m=float(np.linalg.norm(b.odometry.pose[:3] - gt_b[:3])),
               consensus_ms={s.drone_id: s.estimator.perf.report().get(
                   "consensus_exchange", {}).get("mean_ms") for s in robots},
               wall_s=time.perf_counter() - t0)
    if not (res["ref_frame_ids"] == [0, 0] and res["drones_in_windows"] == [[0, 1], [0, 1]]
            and res["shared_keys"] >= 1
            and res["err_b_m"] < N_DIST_ERR_B):
        fail(f"distributed scenario out of its pins: {res}")
    return res


def distributed_full_run(params, dev, H=480, W=640, fx=440.0, n_frames=N_FULL_FRAMES):
    """(n.3) two robots in phase m's textured room at full width, bf16 stem,
    NetVLAD fused, SuperGlue on the loop candidates, ``estimation_mode=
    "distributed"`` with ``enable_dpgo``, one thread per robot; a server
    node (in robot 0's world) ingests both robots' packets and solves."""
    room = TexturedRoom(half=14.0, height=7.0, seed=3)
    sims = [CircleSim(seed=7, baseline=0.2, n_landmarks=10, phase=ph) for ph in (0.0, 0.3)]
    stamps = [k / sims[0].frame_hz for k in range(n_frames)]
    renders = [room_views(room, sim.ext, H, W, fx) for sim in sims]
    frames = render_ahead([lambda t=t, i=i: renders[i](sims[i].gt_pose(t)[0], t)
                           for t in stamps for i in range(2)])
    bus = LocalBus()

    def node(i, **kw):
        cfg = golden_config()
        cfg.estimator.focal_length = fx
        return D2SLAMSystem(
            cfg, SystemConfig(drone_id=i, pgo_every_n_kf=5, netvlad_weights=NETVLAD_WEIGHTS,
                              enable_superglue_remote=True, superglue_weights=SUPERGLUE_WEIGHTS,
                              max_drones=2, **kw),
            sims[0].ext, [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(2)],
            sp_params=params, sp_cfg=SuperPointConfig(max_keypoints=300, threshold=0.008,
                                                      compute_dtype="bfloat16"),
            transport=bus.endpoint(i),
            tracker_cfg=TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
            loop_cfg=LoopDetectorConfig(gdesc_dim=1024, min_gap_frames=2, min_inliers=20,
                                        min_match_per_dir=8, pnp_thresh=16.0 / 460.0),
            frame_rate=sims[0].frame_hz, device=dev)

    robots = [node(i, estimation_mode="distributed", enable_dpgo=True,
                   consensus_timeout_ms=300) for i in range(2)]
    server = node(9, estimation_mode="server", assume_common_world=True, broadcast=False,
                  enable_loop_detection=False)
    for s in robots:
        s.tracker.extract(np.zeros((2, H, W), np.float32))   # warm, not counted
    torch.cuda.synchronize()
    stem.launches = 0

    def step(s, k, t_prev):
        sim = sims[s.drone_id]
        t = stamps[k]
        span = (-0.3, 0.0) if k == 0 else (t_prev + 1e-6, t + 1e-6)
        for (ts, a, g) in sim.imu_samples(*span):
            s.input_imu(ts, a, g)
        s.poll_network(now=t)
        s.input_stereo(t, *frames[2 * k + s.drone_id])
        return t

    t_run = time.perf_counter()
    lockstep(robots, step, n_frames)
    wall = time.perf_counter() - t_run
    stem_launches = stem.launches
    round_ms = []
    for _ in range(4):          # the timer-driven ARock rounds between keyframes
        for s in robots:
            s.poll_network(now=stamps[-1])
            torch.cuda.synchronize()
            ts = time.perf_counter()
            s.solve_pgo()
            round_ms.append((time.perf_counter() - ts) * 1e3)
    dpgo_launches = count_launches(robots[0].solve_pgo)
    ts = time.perf_counter()
    server.poll_network(now=stamps[-1])
    ingest_s = time.perf_counter() - ts
    ts = time.perf_counter()
    fused = server.solve_server()
    server_ms = (time.perf_counter() - ts) * 1e3
    keys = [{s.estimator.consensus_key(f) for f in s.estimator.frames} for s in robots]
    res = dict(frames_per_robot=n_frames, hw=[H, W], stem_launches=stem_launches,
               ms_per_frame_per_robot=wall * 1e3 / (2 * n_frames),
               ref_frame_ids=[s.ref_frame_id for s in robots],
               drones_in_windows=[s.estimator.drone_ids() for s in robots],
               shared_keys=len(keys[0] & keys[1]),
               duals=[len(s.dpgo.dual_remote) for s in robots],
               dpgo_ms_per_round=float(np.mean(round_ms)), dpgo_launches_per_round=dpgo_launches,
               server_drones=sorted(fused), server_solve_ms=server_ms,
               server_ingest_s=ingest_s, wall_s=time.perf_counter() - t_run,
               inter_loops=[sum(e.drone_id_a != e.drone_id_b for e in s.loop_edges)
                            for s in robots])
    robots_out = []
    for s in robots:
        est = s.estimator.perf.report()
        st, ego = s.trajectory(drone_id=s.drone_id, optimized=False)
        robots_out.append(dict(
            drone_id=s.drone_id,
            consensus_ms_per_solve=est.get("consensus_exchange", {}).get("mean_ms"),
            lm_solve_ms=est.get("lm_solve", {}).get("mean_ms"),
            remote_frame_ms=s.perf.report().get("remote_frame", {}).get("mean_ms"),
            vio_ate_m=trajectory_ate(st, ego, sims[s.drone_id]),
            finite=bool(np.isfinite(s.estimator.state.poses.cpu().numpy()).all()
                        and np.isfinite(s.trajectory()[1]).all())))
    res["robots"] = robots_out
    res["finite"] = all(r["finite"] for r in robots_out) and all(
        np.isfinite(od.pose).all() for od in fused.values())
    return res


def _child_setup():
    """A spawned child's card settings (the parent's of main())."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _side_job(name):
    """One of ``SIDE_JOBS`` in a spawned process of its own (the card needs
    a fresh CUDA context): its result, as the phase's own function gives
    it."""
    dev = _child_setup()
    if name in FEATURE_SCENARIOS:
        return {"server": feature_server, "dpgo": feature_dpgo,
                "distributed": feature_distributed}[name](dev)
    params = load_params(WEIGHTS)
    if name == "f":
        return run_system(params, dev, 480, 640, 440.0, SYSTEM_FRAMES)
    return {"j": textured_system, "k": phase_options, "m.2": swarm_golden,
            "m.3": swarm_full, "n.3": distributed_full_run}[name](params, dev)


FEATURE_SCENARIOS = ("server", "dpgo", "distributed")
# main()'s side jobs, longest first (the pool starts them in this order):
# each is launch-bound on one host core and leaves the card idle most of
# the time, so SIDE_WORKERS of them run beside main()'s own line
SIDE_JOBS = ("j", "f", "n.3", "distributed", "m.2", "k", "dpgo", "m.3", "server")
SIDE_WORKERS = 3


def feature_scenarios(pool):
    """(n.2) start the three feature-level scenarios on ``pool``, each in
    a process of its own, side by side. Returns a function that waits for
    them and gives their results; a scenario's failure fails the run."""
    futures = {n: pool.submit(_side_job, n) for n in FEATURE_SCENARIOS}
    return lambda: {n: f.result() for n, f in futures.items()}


# ---------------------------------------------------------------------------
# (o) the tools: MSCKF, the ONNX runtime, quantization, calibration, training
# ---------------------------------------------------------------------------

# o.1: tests/test_msckf.py's circle (radius 3 m, 0.5 rad/s, 200 Hz IMU,
# a keyframe every 0.25 s)
MSCKF_IMU_HZ, MSCKF_KF_DT, MSCKF_RADIUS, MSCKF_OMEGA = 200.0, 0.25, 3.0, 0.5


def _circle_truth(t):
    c, s = np.cos(MSCKF_OMEGA * t), np.sin(MSCKF_OMEGA * t)
    p = np.array([MSCKF_RADIUS * c, MSCKF_RADIUS * s, 1.5])
    v = np.array([-MSCKF_RADIUS * MSCKF_OMEGA * s, MSCKF_RADIUS * MSCKF_OMEGA * c, 0.0])
    a = np.array([-MSCKF_RADIUS * MSCKF_OMEGA**2 * c, -MSCKF_RADIUS * MSCKF_OMEGA**2 * s, 0.0])
    yaw = MSCKF_OMEGA * t + np.pi / 2
    return p, v, a, np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])


def _circle_imu(t0, t1, n):
    """Perfect body-frame IMU samples over [t0, t1] (tests/test_msckf.py)."""
    ts = np.linspace(t0, t1, n, endpoint=False) + (t1 - t0) / n / 2
    g = np.array([0.0, 0.0, GRAVITY_Z])
    accs = [np_lie.quat_to_rotmat(q).T @ (a - g)
            for _, _, a, q in (_circle_truth(t) for t in ts)]
    return (np.full(n, (t1 - t0) / n), np.tile([0.0, 0.0, MSCKF_OMEGA], (n, 1)),
            np.stack(accs))


def _msckf_flight(dev, cfg, n_kf, noise, seed=3, timing=None):
    """The noisy circular flight through the filter on ``dev``: propagate
    over each keyframe interval, clone, and update from keyframe 3 on.
    ``timing``: lists of host ms per call (each call synchronized)."""
    p0, v0, _, q0 = _circle_truth(0.0)
    st = msckf_init(cfg, q0=q0, p0=p0, v0=v0, device=dev)
    n = cfg.max_landmarks
    rng = np.random.RandomState(seed)      # tests/test_msckf.py::make_landmarks
    ang, r, z = rng.uniform(0, 2 * np.pi, n), rng.uniform(6.0, 9.0, n), rng.uniform(0.0, 3.0, n)
    lms = np.stack([r * np.cos(ang), r * np.sin(ang), z], axis=1)
    rng = np.random.RandomState(seed + 1)
    obs_uv = np.zeros((n, cfg.num_clones, 2))
    obs_mask = np.zeros((n, cfg.num_clones), bool)

    def timed(key, fn):
        if timing is None:
            return fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        timing[key].append((time.perf_counter() - t0) * 1000.0)
        return out

    n_imu = int(MSCKF_IMU_HZ * MSCKF_KF_DT)
    for k in range(n_kf):
        t0, t1 = k * MSCKF_KF_DT, (k + 1) * MSCKF_KF_DT
        imu = [torch.as_tensor(x).to(dev) for x in _circle_imu(t0, t1, n_imu)]
        st = timed("propagate", lambda: msckf_propagate(st, cfg, *imu))
        st, _ = timed("augment", lambda: msckf_augment(st, cfg, t1))
        slot = k % cfg.num_clones          # the FIFO cursor, known on the host
        p_t, _, _, q_t = _circle_truth(t1)
        pc = (lms - p_t) @ np_lie.quat_to_rotmat(q_t)
        obs_uv[:, slot] = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-9) + rng.randn(n, 2) * noise
        obs_mask[:, slot] = pc[:, 2] > 0.3
        if k >= 3:
            uv, m = torch.as_tensor(obs_uv).to(dev), torch.as_tensor(obs_mask).to(dev)
            st = timed("update", lambda: msckf_update(st, cfg, uv, m))
    return st, _circle_truth(n_kf * MSCKF_KF_DT)


def tools_msckf(dev):
    """o.1: the filter at its default size on the card against the same
    flight on the CPU; ms and launches per step."""
    cfg = MSCKFConfig()
    timing = {"propagate": [], "augment": [], "update": []}
    st, (p_t, _, _, _) = _msckf_flight(dev, cfg, MSCKF_KEYFRAMES, MSCKF_NOISE, timing=timing)
    st_cpu, _ = _msckf_flight(torch.device("cpu"), cfg, MSCKF_KEYFRAMES, MSCKF_NOISE)
    rel = max(float((getattr(st, f).cpu().double() - getattr(st_cpu, f).double()).abs().max()
                    / max(float(getattr(st_cpu, f).double().abs().max()), 1e-300))
              for f in MSCKFState._fields if f not in ("clone_valid", "next_slot"))
    same_slots = (torch.equal(st.clone_valid.cpu(), st_cpu.clone_valid)
                  and int(st.next_slot) == int(st_cpu.next_slot))
    pos_err = float(np.linalg.norm(st.p.cpu().numpy() - p_t))
    imu = [torch.as_tensor(x).to(dev) for x in _circle_imu(0.0, MSCKF_KF_DT, 50)]
    uv = torch.zeros((cfg.max_landmarks, cfg.num_clones, 2), dtype=torch.float64, device=dev)
    m = torch.zeros((cfg.max_landmarks, cfg.num_clones), dtype=torch.bool, device=dev)
    out = dict(
        clones=cfg.num_clones, landmarks=cfg.max_landmarks, P=list(st.P.shape),
        keyframes=MSCKF_KEYFRAMES, card_vs_cpu_rel=rel, pos_err_m=pos_err,
        trace_P_pos=float(torch.trace(st.P[3:6, 3:6])),
        same_clones=same_slots,
        **{f"{k}_ms": float(np.mean(v)) for k, v in timing.items()},
        propagate_launches=count_launches(lambda: msckf_propagate(st, cfg, *imu)),
        augment_launches=count_launches(lambda: msckf_augment(st, cfg, 1.0)),
        update_launches=count_launches(lambda: msckf_update(st, cfg, uv, m)))
    if not (rel <= MSCKF_CARD_CPU_REL and same_slots):
        fail(f"MSCKF card against CPU: {out}")
    if not pos_err < MSCKF_POS_PIN:
        fail(f"MSCKF position error out of tests/test_msckf.py's pin: {out}")
    return out


def superpoint_onnx_graph(params, H, W):
    """SuperPoint of ``params`` (the JAX layout) as an ONNX graph: the VGG
    trunk (3x3 convs, ReLU, 2x2 max-pools), the 65-logit head ("semi")
    and the 256-d descriptor head ("desc", not normalized: the loader
    normalizes), input 1x1xHxW."""
    nodes, init = [], {}

    def conv(x, name):
        w = np.asarray(params[name]["w"], np.float32)          # HWIO
        init[f"{name}_w"] = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
        init[f"{name}_b"] = np.asarray(params[name]["b"], np.float32)
        k = w.shape[0] // 2
        nodes.append(OnnxNode("Conv", [x, f"{name}_w", f"{name}_b"], [name],
                              attrs={"pads": OnnxAttr("pads", ints=(k, k, k, k))}))
        return name

    def relu(x):
        nodes.append(OnnxNode("Relu", [x], [x + "_r"]))
        return x + "_r"

    def pool(x):
        nodes.append(OnnxNode("MaxPool", [x], [x + "_p"], attrs={
            "kernel_shape": OnnxAttr("kernel_shape", ints=(2, 2)),
            "strides": OnnxAttr("strides", ints=(2, 2))}))
        return x + "_p"

    x = "image"
    for name in ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b"):
        x = relu(conv(x, name))
        if name in ("conv1b", "conv2b", "conv3b"):
            x = pool(x)
    semi = conv(relu(conv(x, "convPa")), "convPb")
    desc = conv(relu(conv(x, "convDa")), "convDb")
    nodes.append(OnnxNode("Identity", [semi], ["semi"]))
    nodes.append(OnnxNode("Identity", [desc], ["desc"]))
    return OnnxGraph(nodes=nodes, initializers=init, inputs=[("image", (1, 1, H, W))],
                     outputs=["semi", "desc"])


def netvlad_onnx_graph(params, H, W):
    """NetVLAD of ``params`` (weights/netvlad_synth.npz's layout) as the
    reference's MobileNetVLAD export: NHWC "image:0" [1, H, W, 1] ->
    "descriptor:0" [1, K * D] (the backbone with XLA ``SAME`` padding and
    ReLU6, the soft-assignment VLAD layer, intra- and L2 normalization;
    the PCA is the loader's ``pca=``)."""
    nodes, init = [], {}
    nodes.append(OnnxNode("Transpose", ["image:0"], ["x0"],
                          attrs={"perm": OnnxAttr("perm", ints=(0, 3, 1, 2))}))

    def conv(x, out, p, stride, group):
        w = np.asarray(p["w"], np.float32)
        init[out + "_w"] = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
        init[out + "_b"] = np.asarray(p["b"], np.float32)
        nodes.append(OnnxNode("Conv", [x, out + "_w", out + "_b"], [out], attrs={
            "strides": OnnxAttr("strides", ints=(stride, stride)),
            "auto_pad": OnnxAttr("auto_pad", s=b"SAME_UPPER"),
            "group": OnnxAttr("group", i=group)}))
        nodes.append(OnnxNode("Clip", [out, "zero", "six"], [out + "_r"]))
        return out + "_r"

    init["zero"], init["six"] = np.array(0.0, np.float32), np.array(6.0, np.float32)
    x = "x0"
    for name, stride in (("stem", 2), ("ds1", 2), ("ds2", 2), ("ds3", 2), ("ds4", 1)):
        p = params[name]
        if "dw" in p:
            x = conv(x, name + "_dw", p["dw"], stride, np.asarray(p["dw"]["w"]).shape[-1])
            x = conv(x, name + "_pw", p["pw"], 1, 1)
        else:
            x = conv(x, name, p, stride, 1)
    K, D = np.asarray(params["vlad_centers"]).shape
    init["assign_w"] = np.ascontiguousarray(
        np.asarray(params["vlad_assign"]["w"], np.float32).transpose(3, 2, 0, 1))
    init["assign_b"] = np.asarray(params["vlad_assign"]["b"], np.float32)
    init["centers"] = np.asarray(params["vlad_centers"], np.float32)[None]
    init["shape_k"] = np.array([1, K, -1], np.int64)
    init["shape_d"] = np.array([1, D, -1], np.int64)
    init["shape_flat"] = np.array([1, K * D], np.int64)
    init["eps"] = np.array(1e-12, np.float32)
    for n in (
            OnnxNode("Conv", [x, "assign_w", "assign_b"], ["logits"]),
            OnnxNode("Reshape", ["logits", "shape_k"], ["logits_f"]),
            OnnxNode("Softmax", ["logits_f"], ["assign"], attrs={"axis": OnnxAttr("axis", i=1)}),
            OnnxNode("Reshape", [x, "shape_d"], ["feat_f"]),
            OnnxNode("Transpose", ["feat_f"], ["feat_t"], attrs={"perm": OnnxAttr("perm", ints=(0, 2, 1))}),
            OnnxNode("MatMul", ["assign", "feat_t"], ["agg"]),
            OnnxNode("ReduceSum", ["assign"], ["asum"], attrs={
                "axes": OnnxAttr("axes", ints=(2,)), "keepdims": OnnxAttr("keepdims", i=1)}),
            OnnxNode("Mul", ["asum", "centers"], ["shift"]),
            OnnxNode("Sub", ["agg", "shift"], ["V"]),
            OnnxNode("ReduceL2", ["V"], ["Vn"], attrs={
                "axes": OnnxAttr("axes", ints=(2,)), "keepdims": OnnxAttr("keepdims", i=1)}),
            OnnxNode("Max", ["Vn", "eps"], ["Vn_c"]),
            OnnxNode("Div", ["V", "Vn_c"], ["Vu"]),
            OnnxNode("Reshape", ["Vu", "shape_flat"], ["flat"]),
            OnnxNode("ReduceL2", ["flat"], ["fn"], attrs={
                "axes": OnnxAttr("axes", ints=(1,)), "keepdims": OnnxAttr("keepdims", i=1)}),
            OnnxNode("Max", ["fn", "eps"], ["fn_c"]),
            OnnxNode("Div", ["flat", "fn_c"], ["descriptor:0"])):
        nodes.append(n)
    return OnnxGraph(nodes=nodes, initializers=init, inputs=[("image:0", (1, H, W, 1))],
                     outputs=["descriptor:0"])


def _keypoint_agreement(ref, got, tol=0.1):
    """Share of ``ref``'s valid keypoints (a SuperPointOutput of one
    image) that ``got`` has within ``tol`` px."""
    a = ref.kpts[0][ref.valid[0]]
    b = got.kpts[0][got.valid[0]]
    if len(a) == 0 or len(b) == 0:
        return 0.0
    return float((torch.cdist(a.double(), b.double()).min(dim=1).values <= tol).float().mean())


def tools_onnx(params, dev, tmp):
    """o.2 and o.3: SuperPoint and NetVLAD as ONNX graphs written with the
    port's writer, read back and lowered on the card, against the native
    modules; SuperPoint's graph quantized to int8."""
    H, W = 480, 640
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=300)
    render = blob_pairs(sim, H, W, 440.0)
    frames = [torch.as_tensor(render(0.4 * i)[0], dtype=torch.float32).to(dev)[None]
              for i in range(5)]
    img = frames[0]
    sp_path = os.path.join(tmp, "superpoint.onnx")
    save_onnx(superpoint_onnx_graph(params, H, W), sp_path)
    cfg32 = SuperPointConfig()
    onnx_sp = superpoint_from_onnx(sp_path, cfg32, device=dev)
    native32 = SuperPoint(params, cfg32, device=dev)
    native16 = SuperPoint(params, SuperPointConfig(compute_dtype="bfloat16"), device=dev)
    with torch.no_grad():
        (so, do), (sn, dn) = onnx_sp(img), native32(img)
        rel_semi = float((so - sn).abs().max() / sn.abs().max())
        rel_desc = float((do - dn).abs().max() / dn.abs().max())
        ko, kn = superpoint_extract(onnx_sp, img), superpoint_extract(native32, img)
        stem.launches = 0
        kb = superpoint_extract(native16, img)
        bf16_stem_launches = stem.launches
    agree = _keypoint_agreement(kn, ko)
    sp = dict(rel_semi=rel_semi, rel_desc=rel_desc, keypoints_native=int(kn.valid.sum()),
              keypoint_agreement=agree, bf16_agreement=_keypoint_agreement(kn, kb),
              onnx_ms=time_ms(lambda: superpoint_extract(onnx_sp, img), iters=20),
              native_f32_ms=time_ms(lambda: superpoint_extract(native32, img), iters=20),
              native_bf16_ms=time_ms(lambda: superpoint_extract(native16, img), iters=20),
              bf16_stem_launches=bf16_stem_launches,
              onnx_launches=count_launches(lambda: superpoint_extract(onnx_sp, img)))
    if not (rel_semi <= ONNX_REL and rel_desc <= ONNX_REL and agree >= ONNX_KPT_AGREE):
        fail(f"ONNX SuperPoint against the native float32 model: {sp}")
    if bf16_stem_launches != 1:
        fail(f"bf16 extraction launched the stem {bf16_stem_launches} times, not once")

    nv_params = load_weights(NETVLAD_WEIGHTS)
    nv_path = os.path.join(tmp, "netvlad.onnx")
    save_onnx(netvlad_onnx_graph(nv_params, H, W), nv_path)
    pca = (nv_params["pca"]["mean"], nv_params["pca"]["proj"])
    onnx_nv = netvlad_from_onnx(nv_path, pca=pca, device=dev)
    native_nv = NetVLAD(nv_params, device=dev)
    with torch.no_grad():
        vo = onnx_nv(img)[0].double()
        vn = native_nv(img)[0, :vo.shape[0]].double()   # the gate's constant last
    cos = float(vo @ vn / (vo.norm() * vn.norm()))
    nv = dict(dim=int(vo.shape[0]), cosine=cos,
              onnx_ms=time_ms(lambda: onnx_nv(img), iters=20),
              native_ms=time_ms(lambda: native_nv(img), iters=20))
    if not cos >= NETVLAD_COS:
        fail(f"ONNX NetVLAD against the native module: {nv}")

    module = onnx_sp.module
    qmod = quantize_module(module)
    x = img[None]
    rep = quantization_report(module, qmod, (x,))
    table = calibrate_activations(module, [(f[None],) for f in frames[1:]])
    save_calibration_table(table, os.path.join(tmp, "calib.json"))
    quant_sp = OnnxSuperPoint(qmod, cfg32)
    with torch.no_grad():
        kq = superpoint_extract(quant_sp, img)
    q = dict(report=rep, calibrated_tensors=len(table),
             calibration_ranges={k: table[k] for k in ("image", "semi", "desc")},
             keypoint_agreement=_keypoint_agreement(ko, kq),
             quantized_ms=time_ms(lambda: superpoint_extract(quant_sp, img), iters=20))
    if not (rep["compression"] > QUANT_COMPRESSION and rep["max_rel_err"] < QUANT_REL_ERR):
        fail(f"int8 SuperPoint out of tests/test_quantize.py's pins: {q}")
    return sp, nv, q, bf16_stem_launches


def _calib_board(nx=8, ny=6, square=0.04):
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny))
    pts = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1, 3) * square
    return pts - pts.mean(axis=0)


def _calib_views(project, params, board, n_views, seed, noise=0.1):
    """tests/test_calibration.py::render_views: the board ~0.5 m in front
    of the camera with a random tilt and offset, in the 640x480 image."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_views:
        q = so3_exp_quat(torch.as_tensor(rng.normal(0, 0.25, 3))).numpy()
        t = np.array([rng.normal(0, 0.08), rng.normal(0, 0.06), rng.uniform(0.4, 0.7)])
        pc = (np_lie.quat_to_rotmat(q) @ board.T).T + t
        uv, valid = project(torch.as_tensor(pc), params)
        uv = uv.numpy()
        if not bool(valid.all()) or uv.min() < 10 or uv[:, 0].max() > 630 or uv[:, 1].max() > 470:
            continue
        out.append(uv + rng.normal(0, noise, uv.shape))
    return out


def _stereo_views(p0, p1, rel_gt, board, n_views, seed=5):
    """tests/test_calibration.py::test_calibrate_stereo_extrinsic's views."""
    rng = np.random.default_rng(seed)
    img0, img1 = [], []
    while len(img0) < n_views:
        q = so3_exp_quat(torch.as_tensor(rng.normal(0, 0.2, 3))).numpy()
        t = np.array([rng.normal(0, 0.06), rng.normal(0, 0.05), rng.uniform(0.45, 0.7)])
        pc0 = (np_lie.quat_to_rotmat(q) @ board.T).T + t
        pc1 = (np_lie.quat_to_rotmat(rel_gt[3:]) @ pc0.T).T + rel_gt[:3]
        (uv0, v0), (uv1, v1) = (pinhole_project(torch.as_tensor(pc0), p0),
                                pinhole_project(torch.as_tensor(pc1), p1))
        uv0, uv1 = uv0.numpy(), uv1.numpy()
        if not (bool(v0.all()) and bool(v1.all())):
            continue
        if min(uv0.min(), uv1.min()) < 10 or max(uv0[:, 0].max(), uv1[:, 0].max()) > 630 \
                or max(uv0[:, 1].max(), uv1[:, 1].max()) > 470:
            continue
        img0.append(uv0 + rng.normal(0, 0.1, uv0.shape))
        img1.append(uv1 + rng.normal(0, 0.1, uv1.shape))
    return img0, img1


def tools_calibration(dev):
    """o.4: pinhole, Kannala-Brandt and the stereo extrinsic from 30
    checkerboard views at 640x480, and the vignette of a 480x640 mean
    image, each on the card against the CPU with the JAX tests' pins; ms
    and launches per LM iteration."""
    cpu = torch.device("cpu")
    lm_ms = []
    real_lm = calibration._lm_calibrate

    def timed_lm(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_lm(*a, **k)
        torch.cuda.synchronize()
        lm_ms.append((time.perf_counter() - t0) * 1000.0 / k.get("n_iters", 30))
        return out

    board = _calib_board()
    pin_gt = PinholeParams.make(420.0, 418.0, 325.0, 245.0, k1=-0.25, k2=0.06)
    pin_obs = _calib_views(pinhole_project, pin_gt, board, CALIB_VIEWS, 0)
    kb_gt = KBParams.make(200.0, 199.0, 322.0, 242.0, k2=0.02, k3=-0.004)
    kb_board = _calib_board(square=0.08)
    kb_obs = _calib_views(kb_project, kb_gt, kb_board, CALIB_VIEWS, 2)
    p0 = PinholeParams(460.0, 458.0, 320.0, 240.0)
    p1 = PinholeParams(455.0, 456.0, 318.0, 242.0)
    q_gt = so3_exp_quat(torch.tensor([0.0, 0.02, 0.005], dtype=torch.float64)).numpy()
    rel_gt = np.concatenate([[-0.12, 0.001, 0.002], q_gt])
    st0, st1 = _stereo_views(p0, p1, rel_gt, board, CALIB_VIEWS)

    def stereo(device):
        return calibrate_stereo_extrinsic(
            board, st0, st1, lambda pc: pinhole_project(pc, p0),
            lambda pc: pinhole_project(pc, p1), 460.0, (320.0, 240.0), 455.0, (318.0, 242.0),
            device=device)

    H, W = 480, 640
    ys, xs = np.mgrid[0:H, 0:W]
    r2 = ((xs - W / 2) ** 2 + (ys - H / 2) ** 2) / (W / 2) ** 2
    mean_img = 0.8 * (1.0 - 0.4 * r2 + 0.05 * r2**2)
    calibration._lm_calibrate = timed_lm
    try:
        pin, pin_rms = calibrate_pinhole(board, pin_obs, (640, 480), device=dev)
        kb, kb_rms = calibrate_kb(kb_board, kb_obs, (640, 480), f_guess=210.0, device=dev)
        rel, st_rms = stereo(dev)
    finally:
        calibration._lm_calibrate = real_lm
    coeffs, corr = calibrate_vignette(mean_img, device=dev)
    launches = count_launches(lambda: calibrate_pinhole(board, pin_obs, (640, 480), device=dev))
    pin_c, _ = calibrate_pinhole(board, pin_obs, (640, 480), device=cpu)
    kb_c, _ = calibrate_kb(kb_board, kb_obs, (640, 480), f_guess=210.0, device=cpu)
    rel_c, _ = stereo(cpu)
    coeffs_c, _ = calibrate_vignette(mean_img, device=cpu)
    flat = mean_img * corr.cpu().numpy()
    gaps = dict(pinhole=float(np.abs(np.subtract(pin, pin_c)).max()),
                kb=float(np.abs(np.subtract(kb, kb_c)).max()),
                stereo=float(np.abs(rel - rel_c).max()),
                vignette=float(np.abs(coeffs - coeffs_c).max()))
    out = dict(views=CALIB_VIEWS, pinhole=[float(v) for v in pin], pinhole_rms=pin_rms,
               kb=[float(v) for v in kb], kb_rms=kb_rms, stereo_rel=rel.tolist(),
               stereo_rms=st_rms, vignette=coeffs.tolist(),
               vignette_flatness=float(flat.std() / flat.mean()), card_vs_cpu=gaps,
               lm_ms_per_iter=dict(zip(("pinhole", "kb", "stereo"), lm_ms)),
               pinhole_launches_per_iter=launches / 30)
    if max(gaps.values()) > CALIB_CARD_CPU:
        fail(f"calibration card against CPU: {out}")
    pins_ok = (pin_rms < 0.3 and abs(pin.fx - 420.0) < 4.0 and abs(pin.fy - 418.0) < 4.0
               and abs(pin.cx - 325.0) < 4.0 and abs(pin.k1 + 0.25) < 0.03
               and kb_rms < 0.3 and abs(kb.fx - 200.0) < 4.0 and abs(kb.cx - 322.0) < 4.0
               and st_rms < 0.3 and np.abs(rel[:3] - rel_gt[:3]).max() < 1e-3
               and abs(np.dot(rel[3:], rel_gt[3:])) > 1 - 1e-5
               and out["vignette_flatness"] < 0.02)
    if not pins_ok:
        fail(f"calibration out of tests/test_calibration.py's pins: {out}")
    return out


def _train_row(name, losses, first_cpu, wall_s, perf, steps):
    batch_ms = perf.report()["batch"]["mean_ms"]
    step_ms = wall_s * 1000.0 / steps
    row = dict(steps=steps, first_loss=losses[0], first_loss_cpu=first_cpu,
               first_rel=abs(losses[0] - first_cpu) / abs(first_cpu),
               first10=float(np.mean(losses[:10])), last10=float(np.mean(losses[-10:])),
               ms_per_step=step_ms, host_batch_ms=batch_ms, device_ms=step_ms - batch_ms)
    if not row["first_rel"] <= TRAIN_FIRST_REL:
        fail(f"{name}: the first step's loss on the card against the CPU: {row}")
    if not row["last10"] < row["first10"]:
        fail(f"{name}: the loss did not fall over {steps} steps: {row}")
    return row


def tools_training(params, dev):
    """o.5: the three trainers at their default widths on the card, a few
    dozen steps each; the first step's loss against the same step on the
    CPU, and the loss falling."""
    cpu = torch.device("cpu")
    out = {}

    def run(fn, **kw):
        perf = PerfTracker()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained, losses = fn(steps=TRAIN_STEPS, log_every=0, device=dev, perf=perf, **kw)
        return trained, losses, time.perf_counter() - t0, perf

    sp_cfg = SuperPointConfig()
    _, losses, wall, perf = run(train_superpoint, seed=0)
    batch = superpoint_batch(np.random.default_rng(0), 16, 120, 160)
    with torch.no_grad():
        first = float(superpoint_loss(random_params(0, sp_cfg), *(torch.as_tensor(x) for x in batch),
                                      sp_cfg)[0])
    out["superpoint"] = _train_row("train_superpoint", losses, first, wall, perf, TRAIN_STEPS)

    _, losses, wall, perf = run(train_netvlad, seed=1)
    nv0 = netvlad_init(torch.Generator().manual_seed(1), NetVLADConfig())
    with torch.no_grad():
        first = float(netvlad_loss(nv0, *(torch.as_tensor(x) for x in
                                          netvlad_batch(np.random.default_rng(1), 16, 120, 160))))
    out["netvlad"] = _train_row("train_netvlad", losses, first, wall, perf, TRAIN_STEPS)

    _, losses, wall, perf = run(train_superglue, seed=2, sp_params=params)
    sg_cfg = sg.SuperGlueConfig(num_layers=3, num_heads=4, sinkhorn_iters=20)
    rng = np.random.default_rng(2)
    bank = superglue_bank(SuperPoint(params, SuperPointConfig(max_keypoints=96, threshold=0.010,
                                                              nms_radius=4), device=dev),
                          rng, 256, (120, 160))
    sel = rng.integers(0, 256, 8)
    bank_cpu = tuple(type(b)(*(f.cpu() for f in b)) for b in bank[:2]) + (bank[2].cpu(),)
    with torch.no_grad():
        first = float(superglue_loss(sg.superglue_init(torch.Generator().manual_seed(2), sg_cfg),
                                     bank_cpu, sel, (120, 160), sg_cfg))
    out["superglue"] = _train_row("train_superglue", losses, first, wall, perf, TRAIN_STEPS)
    return out


def phase_tools(params, dev):
    """(o) the tools: MSCKF, the ONNX runtime with SuperPoint and NetVLAD,
    int8 quantization, calibration and training, each on the card."""
    t0 = time.perf_counter()
    msckf = tools_msckf(dev)
    print("phase o.1 (MSCKF, default size, 40 keyframes, card against CPU): "
          + json.dumps(msckf), flush=True)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        sp, nv, q, stem_launches = tools_onnx(params, dev, tmp)
    print("phase o.2 (ONNX SuperPoint 480x640 against the native models): " + json.dumps(sp),
          flush=True)
    print("phase o.2 (ONNX NetVLAD 480x640 with PCA against the native module): "
          + json.dumps(nv), flush=True)
    print("phase o.3 (int8 SuperPoint graph): " + json.dumps(q), flush=True)
    t2 = time.perf_counter()
    calib = tools_calibration(dev)
    print("phase o.4 (calibration, 30 views 640x480, vignette 480x640): " + json.dumps(calib),
          flush=True)
    t3 = time.perf_counter()
    train = tools_training(params, dev)
    print("phase o.5 (training at the default widths): " + json.dumps(train), flush=True)
    t4 = time.perf_counter()
    print("phase o seconds: " + json.dumps(dict(
        msckf=t1 - t0, onnx_quant=t2 - t1, calibration=t3 - t2, training=t4 - t3)), flush=True)
    return dict(stem_launches=stem_launches)


def phase_multirobot(params, dev, scen, full=None):
    """(n) multi-robot estimation and distributed PGO: n.1 batched over 4
    robots; ``scen``, the results of n.2 (``feature_scenarios``), the JAX
    package's feature-level system scenarios with their pins; ``full``
    (n.3, ``distributed_full_run``, run here when it is None), two robots
    at full width in distributed mode with DPGO and a server."""
    batched = phase_multirobot_batched(dev)
    print("phase n.2 (feature-level system scenarios: server, DPGO, distributed): "
          + json.dumps(scen), flush=True)
    full = distributed_full_run(params, dev) if full is None else full
    print("phase n.3 (two robots 480x640, distributed with DPGO, a server): "
          + json.dumps(full), flush=True)
    if not (full["ref_frame_ids"] == [0, 0] and full["finite"]
            and all(d == [0, 1] for d in full["drones_in_windows"])
            and full["shared_keys"] >= 1 and min(full["duals"]) >= 1
            and full["server_drones"] == [0, 1]):
        fail(f"full-width distributed run out of its gates: {full}")
    if full["stem_launches"] != 2 * full["frames_per_robot"]:
        fail(f"phase n: stem launches {full['stem_launches']} != 2 robots x "
             f"{full['frames_per_robot']} frames")
    return dict(batched=batched, scenarios=scen, full=full)


class _ThreadStdout:
    """``sys.stdout`` for phase p: a thread that set ``local.buf`` writes
    there, every other thread to the real stdout (``redirect_stdout``
    swaps one stream for the whole process)."""

    def __init__(self, real):
        self.real, self.local = real, threading.local()

    def _target(self):
        buf = getattr(self.local, "buf", None)
        return self.real if buf is None else buf

    def write(self, text):
        return self._target().write(text)

    def flush(self):
        self._target().flush()


def _cli(mod, argv):
    """``mod.main(argv)`` with its output kept (``sys.stdout`` must be a
    ``_ThreadStdout``): (exit code, summary, wall seconds, output)."""
    import io

    buf = sys.stdout.local.buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rc = mod.main(argv)
    finally:
        sys.stdout.local.buf = None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return rc, json.loads(lines[-1]) if lines else None, wall, out


def tools_bags(dev, tmp):
    """p.1: the bag tools on a composite quadcam bag of phase d's rig."""
    HF, WF = 480, 640
    ext = fisheye_ring_extrinsics(0.3)
    fish = [KBParams.make(190.0, 190.0, WF / 2, HF / 2, k2=0.005) for _ in range(4)]
    # three wall textures, cycled over the frames
    views = [np.stack([(render_cylinder_wall(fish[i], ext[i], (HF, WF), WALL_RADIUS, seed=k)
                        * 255).astype(np.uint8) for i in range(4)]) for k in range(3)]
    comps = [np.concatenate(list(views[k % 3]), axis=1) for k in range(P_BAG_FRAMES)]
    src = os.path.join(tmp, "quad.bag")
    t0, n_imu = 100.0, int(P_BAG_FRAMES / P_BAG_HZ * P_IMU_HZ)
    with RosbagWriter(src) as w:
        for i in range(n_imu):
            w.write_imu("/imu", t0 + i / P_IMU_HZ, acc=[0, 0, 9.8], gyr=[0, 0, 0.1])
        for k, c in enumerate(comps):
            w.write_image("/oak_ffc_4p/assemble_image", t0 + k / P_BAG_HZ, c)
    res = dict(composite_hw=list(comps[0].shape), frames=P_BAG_FRAMES, imu=n_imu)

    ts = time.perf_counter()
    split = bag_tools.split_quadcam_bag(src, keep_topics=["/imu"])
    r = RosbagReader(split)
    for i in range(4):
        got = [m["image"] for _, _, m in r.read_messages([f"/cam_{i}/image"])]
        if len(got) != P_BAG_FRAMES or any(
                not np.array_equal(g, c[:, i * WF:(i + 1) * WF]) for g, c in zip(got, comps)):
            fail(f"split: view {i} differs from the composite's quarter")
    if len(list(r.read_messages(["/imu"], raw=True))) != n_imu:
        fail("split: IMU not passed through")
    res["split_s"] = time.perf_counter() - ts

    ts = time.perf_counter()
    second = os.path.join(tmp, "second.bag")
    bag_tools.shift_bag(src, second, P_SHIFT)
    synced = bag_tools.sync_bags([src, second], out_dir=tmp, t_start=1.0)
    shifts = [dt for _, dt in synced]
    if (abs(shifts[0] - (1.0 - t0)) > 1e-9 or abs(shifts[1] - (1.0 - t0 - P_SHIFT)) > 1e-9
            or any(abs(bag_tools.find_time0(o) - 1.0) > 1e-6 for o, _ in synced)):
        fail(f"sync: shifts {shifts}")
    res.update(sync_shifts_s=shifts, sync_s=time.perf_counter() - ts)

    ts = time.perf_counter()
    cut = os.path.join(tmp, "cut.bag")
    n_cut = bag_tools.filter_bag(src, cut, topics=["/imu"], t_start=t0 + 0.1, t_end=t0 + 0.6)
    n_step = bag_tools.filter_bag(src, os.path.join(tmp, "step.bag"),
                                  topics=["/oak_ffc_4p/assemble_image"], step=2)
    info = bag_tools.bag_info(src)
    if (n_cut != int(0.5 * P_IMU_HZ) + 1 or n_step != P_BAG_FRAMES // 2
            or info["/imu"]["count"] != n_imu
            or info["/oak_ffc_4p/assemble_image"]["count"] != P_BAG_FRAMES
            or bag_tools.bag_info(cut)["/imu"]["count"] != n_cut):
        fail(f"filter / info: {n_cut}, {n_step}, {info}")
    res.update(filtered_imu=n_cut, filtered_images=n_step, filter_info_s=time.perf_counter() - ts)

    calib = dict(cams=[dict(fx=190.0, fy=190.0, cx=WF / 2, cy=HF / 2, k2=0.005)] * 4,
                 baseline=0.3, out_hw=[240, 320])
    for name, c in (("square_rig", calib), ("extrinsics", dict(calib, extrinsics=ext.tolist()))):
        out = {}
        for where in ("cpu", "cuda"):
            path = os.path.join(tmp, f"stereo_{name}_{where}.bag")
            torch.cuda.synchronize()
            ts = time.perf_counter()
            n = bag_tools.generate_stereo_bag(src, path, c, device=where)
            out[where] = (n, path, (time.perf_counter() - ts) * 1e3 / max(n, 1))
        (n_cpu, p_cpu, ms_cpu), (n_card, p_card, ms_card) = out["cpu"], out["cuda"]
        worst = 0
        for topic in RosbagReader(p_cpu).topics:
            a = [m["image"] for _, _, m in RosbagReader(p_card).read_messages([topic])]
            b = [m["image"] for _, _, m in RosbagReader(p_cpu).read_messages([topic])]
            if len(a) != len(b):
                fail(f"stereo-gen ({name}) {topic}: {len(a)} images on the card, {len(b)} on "
                     "the CPU")
            worst = max([worst] + [int(np.abs(x.astype(int) - y.astype(int)).max())
                                   for x, y in zip(a, b)])
        if n_card != n_cpu or n_card != 4 * P_BAG_FRAMES or worst > P_GREY_TOL:
            fail(f"stereo-gen ({name}): {n_card} / {n_cpu} pairs, worst {worst} grey levels")
        res[f"stereo_{name}"] = dict(pairs=n_card, max_grey_diff=worst, ms_per_pair=ms_card,
                                     ms_per_pair_cpu=ms_cpu)
    return res


def tools_spy():
    """p.2: one LoopNet keyframe broadcast (the keyframe and its two
    views) over UDP multicast on this host, counted by ``SpyStats``."""
    sender = UDPMulticastTransport(1, port=P_SPY_PORT)
    listener = UDPMulticastTransport(9999, port=P_SPY_PORT)
    try:
        sent = {}
        send = sender.send

        def send_and_count(ch, data):
            c = sent.setdefault(ch, [0, 0])
            c[0] += 1
            c[1] += len(data)
            send(ch, data)

        sender.send = send_and_count
        net = LoopNet(sender, 1, send_img=True)
        rng = np.random.default_rng(0)
        n = 200
        desc = rng.normal(0, 1, (n, 256)).astype(np.float32)
        rays = rng.normal(0, 1, (n, 3)).astype(np.float32)
        pkt = codec.RemoteKeyframePacket(
            drone_id=1, frame_id=42, stamp=5.25, is_keyframe=True,
            pose=np.array([1, 2, 3, 0, 0, 0, 1], np.float32),
            gdesc=rng.normal(0, 1, 1025).astype(np.float32), lm_ids=np.arange(n),
            lm_cam=np.zeros(n, np.uint8), lm_rays=rays / np.linalg.norm(rays, axis=1)[:, None],
            lm_vels=np.zeros((n, 3), np.float32),
            lm_desc=desc / np.linalg.norm(desc, axis=1)[:, None])
        views = [(render_cylinder_wall(KBParams.make(190.0, 190.0, 320.0, 240.0, k2=0.005),
                                       fisheye_ring_extrinsics(0.3)[v], (480, 640),
                                       WALL_RADIUS) * 255).astype(np.uint8) for v in range(2)]
        stats = spy.SpyStats()
        th = threading.Thread(target=lambda: (time.sleep(0.2),
                                              net.broadcast_keyframe(pkt, images=views)))
        th.start()
        seen = stats.pump(listener, seconds=1.5)
        th.join(timeout=10)
    finally:
        sender.close()
        listener.close()
    got = {c: [v.packets, v.bytes] for c, v in stats.by_channel.items()}
    if got != sent or seen != sum(p for p, _ in sent.values()) or stats.keyframes != [(1, 42, n)]:
        fail(f"spy over UDP multicast: counted {got}, sent {sent}, keyframes {stats.keyframes}")
    return dict(sent={spy.CHANNEL_NAMES[c]: v for c, v in sent.items()},
                counted={spy.CHANNEL_NAMES[c]: v for c, v in got.items()},
                loopnet_sent_bytes=net.sent_bytes, keyframes=stats.keyframes)


def _run_cli(res, name, mod, argv, check):
    """One CLI through ``_cli``, its result into ``res[name]``, printed,
    and held to ``check(summary)``."""
    rc, summary, wall, out = _cli(mod, argv)
    res[name] = dict(rc=rc, wall_s=wall, summary=summary)
    print(f"phase p.3 {name} ({wall:.1f} s): " + json.dumps(summary), flush=True)
    if rc != 0 or summary is None or not check(summary):
        fail(f"CLI {name}: exit code {rc}, summary {summary}; output:\n{out[-3000:]}")
    return summary


def start_process_clis(pool, res):
    """p.3's two multi-process CLIs (one spawned process per robot, and a
    server), started on ``pool`` to run beside p.1-p.3's other work."""
    return [
        pool.submit(_run_cli, res, "run_swarm_processes", run_swarm_processes, [],
                    lambda s: (s["devices"] == ["cuda"]
                               and s["max_disagreement_m"] < P_DPGO_DISAGREEMENT
                               and s["ate_optimized_m"] < s["ate_odometry_m"])),
        pool.submit(_run_cli, res, "run_server_mode", run_server_mode, [],
                    lambda s: (s["ok"] and s["server_drones"] == ["0", "1"]
                               and s["devices"] == ["cuda"]))]


def tools_clis(dev, tmp, res):
    """p.3: the in-process CLIs of ``d2slam_tpu_torch.examples`` through
    their ``main(argv)`` on the card, at their defaults (training cut in
    length only), into ``res``; returns the kernel launches of the run."""
    import functools

    run = functools.partial(_run_cli, res)
    csv = os.path.join(tmp, "vio.csv")
    run("run_synthetic_vio", run_synthetic_vio, ["--out", csv],
        lambda s: (s["device"] == "cuda" and s["ate_m"] < P_VIO_ATE
                   and s["solves"] >= P_VIO_SOLVES and s["margins"] >= P_VIO_MARGINS))
    stamps, _ = read_trajectory_csv(csv)
    sim = CircleSim()
    gt_csv = os.path.join(tmp, "gt.csv")
    write_trajectory_csv(gt_csv, stamps, [sim.gt_pose(t)[0] for t in stamps])
    vio_ate = res["run_synthetic_vio"]["summary"]["ate_m"]
    run("evaluate_trajectories", evaluate_trajectories,
        ["--est", f"0={csv}", "--gt", f"0={gt_csv}"],
        lambda s: abs(s["drones"]["0"]["ate_m"] - vio_ate) < 1e-4)

    bm.launches = 0
    run("run_quadcam_depth", run_quadcam_depth, ["--save-viz", os.path.join(tmp, "viz")],
        lambda s: (s["bm_launches"] == 2 * s["frames"] and len(s["pairs"]) == 4
                   and all(WALL_DEPTH_RANGE[0] < p["median_depth_m"] < WALL_DEPTH_RANGE[1]
                           for p in s["pairs"])))
    bm_launches = bm.launches
    if bm_launches != 2 * res["run_quadcam_depth"]["summary"]["frames"]:
        fail(f"run_quadcam_depth: {bm_launches} block-matcher launches")

    wdir = os.path.join(tmp, "weights")
    run("train_frontend", train_frontend,
        ["--steps", str(TRAIN_STEPS), "--nv-steps", str(TRAIN_STEPS), "--sg-steps", "8",
         "--out", wdir],
        lambda s: all(np.isfinite(s[k]["first_loss"]) for k in ("superpoint", "netvlad",
                                                                   "superglue")))
    # the stem kernel on the weights the trainer wrote, bf16 at 480x640
    model = SuperPoint(load_params(os.path.join(wdir, "superpoint_synth.npz")),
                       SuperPointConfig(compute_dtype="bfloat16"), device=dev)
    frames = torch.rand((P_STEM_FRAMES, 1, 480, 640), generator=torch.Generator().manual_seed(0))
    stem.launches = 0
    with torch.no_grad():
        outs = [superpoint_extract(model, f.to(dev)) for f in frames]
    torch.cuda.synchronize()
    stem_launches = stem.launches
    if stem_launches != P_STEM_FRAMES or not all(
            bool(torch.isfinite(o.scores).all() and torch.isfinite(o.desc).all()) for o in outs):
        fail(f"trained-weights extraction: {stem_launches} stem launches, finite "
             f"{[bool(torch.isfinite(o.scores).all()) for o in outs]}")
    print("phase p.3 trained-weights extraction (bf16, 480x640): " + json.dumps(dict(
        frames=P_STEM_FRAMES, stem_launches=stem_launches,
        keypoints=[int(o.valid.sum()) for o in outs])), flush=True)

    run("simulate_dpgo", simulate_dpgo, [], lambda s: s["ok"])
    run("run_swarm_pgo", run_swarm_pgo, [],
        lambda s: (s["inliers"] >= 20 and s["position_err_m"] < run_swarm_pgo.POSITION_GATE
                   and np.allclose(s["alignment_t"], s["true_t"], atol=1e-2)))
    return dict(bm_launches=bm_launches, stem_launches=stem_launches)


def phase_cli(dev):
    """(p) the host tools and the command-line entry points on the card.
    The two multi-process CLIs run in the background from the start of
    p.1 until the others are done, so the times of p.1-p.3 carry their
    load on the host and the card."""
    t0 = time.perf_counter()
    clis = {}
    real_stdout, sys.stdout = sys.stdout, _ThreadStdout(sys.stdout)
    try:
        with tempfile.TemporaryDirectory(dir=REPO) as tmp, ThreadPoolExecutor(2) as pool:
            background = start_process_clis(pool, clis)
            bags = tools_bags(dev, tmp)
            print("phase p.1 (bag tools on a 4x480x640 quadcam bag, stereo-gen card against "
                  "CPU): " + json.dumps(bags), flush=True)
            t1 = time.perf_counter()
            sp = tools_spy()
            print("phase p.2 (spy over UDP multicast, one LoopNet keyframe broadcast): "
                  + json.dumps(sp), flush=True)
            t2 = time.perf_counter()
            launches = tools_clis(dev, tmp, clis)
            t3 = time.perf_counter()
            for f in background:
                f.result()
    finally:
        sys.stdout = real_stdout
    t4 = time.perf_counter()
    print("phase p seconds: " + json.dumps(dict(
        bags=t1 - t0, spy=t2 - t1, clis_in_process=t3 - t2, waiting_for_background=t4 - t3,
        per_cli={k: v["wall_s"] for k, v in clis.items() if "wall_s" in v})), flush=True)
    return launches


def main_line(params, dev, mark):
    """Phases b, c, d and e: the golden stereo scenario (both backbones),
    the main path at full width, quadcam depth and quadcam VIO. Returns
    (c's result, e's result, d's result)."""
    res = {}
    for cdt in ("bfloat16", "float32"):
        sp_cfg = SuperPointConfig(max_keypoints=150, threshold=0.010, nms_radius=4,
                                  compute_dtype=cdt)
        res[cdt] = run_sequence(
            params, dev, 240, 320, 220.0, 16, golden_config(), sp_cfg,
            TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
            n_landmarks=150)
    print("phase b (golden 240x320, bf16 stem and f32 backbone): "
          + json.dumps(res), flush=True)
    for cdt, r in res.items():
        if (r["keyframes"] < 12 or not r["ate_m"] < GOLDEN_ATE or r["median_track"] < 6
                or not r["finite"]):
            fail(f"golden scenario ({cdt}) out of its pins: {r}")
    r = res["bfloat16"]
    if r["stem_launches"] != r["frames"]:
        fail(f"stem launches {r['stem_launches']} != frames {r['frames']}")

    sp_cfg = SuperPointConfig(compute_dtype="bfloat16")
    cfg = D2Config()
    cfg.estimator.focal_length = 440.0
    res = run_sequence(params, dev, 480, 640, 440.0, FULL_WIDTH_FRAMES, cfg, sp_cfg,
                       TrackerConfig(), n_landmarks=300)
    print("phase c (full width 480x640, default configs): " + json.dumps(res), flush=True)
    if not res["finite"] or res["solves"] < 1:
        fail(f"full-width run: finite={res['finite']} solves={res['solves']}")
    if res["stem_launches"] != res["frames"]:
        fail(f"stem launches {res['stem_launches']} != frames {res['frames']}")
    mark("b-c")
    depth = phase_quadcam_depth(dev)
    mark("d")

    sp_cfg = SuperPointConfig(max_keypoints=150, threshold=0.010, nms_radius=4,
                              compute_dtype="bfloat16")
    quad = run_sequence(
        params, dev, 240, 320, 220.0, 16, golden_config(4, 160, 640), sp_cfg,
        TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
        n_landmarks=220, quadcam=True)
    print("phase e (quadcam VIO, 4 views 240x320, bf16 stem): " + json.dumps(quad), flush=True)
    if (quad["keyframes"] < 10 or not quad["ate_m"] < GOLDEN_QUADCAM_IMAGE_ATE
            or not quad["finite"]):
        fail(f"quadcam VIO out of its pins: {quad}")
    if quad["stem_launches"] != quad["frames"]:
        fail(f"stem launches {quad['stem_launches']} != frames {quad['frames']}")
    mark("e")
    return res, quad, depth


def main():
    t_start = time.perf_counter()

    def mark(phases):
        print(f"chip_smoke: phases {phases} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    params = load_params(WEIGHTS)
    kernel_rows = phase_kernels(params, dev)
    bm_rows = phase_bm_kernel(dev)
    phase_device_lk(params, dev)
    mark("a, c.2")

    # the side jobs run in processes of their own beside this line
    # (module docstring); a failure here cancels those not yet started
    spawn = multiprocessing.get_context("spawn")
    pool = ProcessPoolExecutor(SIDE_WORKERS, mp_context=spawn, max_tasks_per_child=1)
    try:
        side = {name: pool.submit(_side_job, name) for name in SIDE_JOBS}
        res, quad, depth = main_line(params, dev, mark)
        textured, room_pnp = phase_textured(params, dev, side["j"].result())
        mark("j")
        sysres, pnp_args = side["f"].result()
        print("phase f (D2SLAMSystem 480x640, NetVLAD fused, loops, PCM, PGO): "
              + json.dumps(sysres), flush=True)
        if (not sysres["finite"] or sysres["pgo_solves"] < 2 or sysres["loops_kept_by_pcm"] < 1
                or not sysres["ate_pgo_m"] <= sysres["ate_ego_m"] + PGO_ATE_SLACK):
            fail(f"single-robot system out of its pins: {sysres}")
        if (sysres["stem_launches"] != sysres["frames"]
                or sysres["netvlad_runs"] != sysres["frames"]):
            fail(f"stem launches {sysres['stem_launches']} / NetVLAD runs "
                 f"{sysres['netvlad_runs']} != frames {sysres['frames']}")
        mark("f")
        # PnP on the correspondences of a loop query: the textured room's
        # where it had one
        phase_pgo(dev, room_pnp if "args" in room_pnp else pnp_args)
        mark("g")
        dataset = phase_dataset(params, dev)
        mark("h")
        phase_dynamic_start(dev)
        mark("i")
        replay = phase_depth_replay(dev)
        mark("l")
        alone = superglue_alone(dev)
        tools = phase_tools(params, dev)
        mark("m.1, o")
        swarm = phase_swarm(params, dev, alone, side["m.2"].result(), side["m.3"].result())
        mark("m")
        options = side["k"].result()     # gated in its process (phase_options)
        mark("k")
        scen = {n: side[n].result() for n in FEATURE_SCENARIOS}
        multi = phase_multirobot(params, dev, scen, side["n.3"].result())
        mark("n")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    cli = phase_cli(dev)
    mark("p")

    big = kernel_rows["2x480x640"]
    euroc = kernel_rows[f"2x{EUROC_H}x{EUROC_W}"]
    frame = bm_rows["4x240x320"]   # the four pairs of a quadcam frame
    kernels = [{
        "name": "superpoint_stem",
        "route": "cuda",
        "source": "d2slam_tpu_torch/csrc/superpoint_stem.cu",
        "replaces": "d2slam_tpu/ops/superpoint_stem_pallas.py:51",
        "launches": (res["stem_launches"] + quad["stem_launches"] + sysres["stem_launches"]
                     + sum(dataset["stem_launches"])
                     + textured["system_480x640"]["stem_launches"]
                     + sum(r["stem_launches"] for k, r in options.items()
                           if not k.startswith("calibration"))
                     + sum(r["stem_launches"] for r in options["calibration_from_images"].values())
                     + swarm["swarm_480x640"]["stem_launches"]
                     + multi["full"]["stem_launches"] + tools["stem_launches"]
                     + cli["stem_launches"]),
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows.values()),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        # the dataset replay's shape (phase h)
        f"at_2x{EUROC_H}x{EUROC_W}": {k: euroc[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")},
    }, {
        "name": "stereo_bm",
        "route": "cuda",
        "source": "d2slam_tpu_torch/csrc/stereo_bm.cu",
        "replaces": "d2slam_tpu/ops/stereo_bm_pallas.py:35",
        "launches": depth["bm_launches"] + sum(replay["bm_launches"]) + cli["bm_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in bm_rows.values()),
        "ms": frame["ms"],
        "plain_ms": frame["plain_ms"],
        "bound_ms": frame["bound_ms"],
        "bound_by": frame["bound_by"],
        "library_ms": None,   # no single PyTorch call computes it
    }]
    smi = nvidia_smi_line()
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
