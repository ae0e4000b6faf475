"""d2slam_tpu_torch — the PyTorch/CUDA port of d2slam_tpu.

Same sub-package layout and module names as ``d2slam_tpu``; each module
here is the counterpart of the module of the same name there. The port
imports ``torch`` and numpy only. Its entry points (``D2SLAMSystem``,
``FeatureTracker``, ``D2Estimator``, ``SuperPoint``, ``NetVLAD``,
``LoopDetector``, the PGO solvers) run on the CUDA card unless the
caller passes ``device="cpu"``.

Slice 1 covers the single-robot stereo VIO keyframe path: SuperPoint
(with the hand-written Hopper stem kernel in ``csrc/``), LK, matching,
the tracker, IMU preintegration, the sliding-window LM solver with
marginalization, and the estimator.

The quadcam configuration is covered as well: the seven camera models and
kalibr camchains, fisheye-to-virtual-pinhole remap tables, stereo
disparity with the hand-written Hopper block-matching kernel, the
configuration HitNet, the quadcam depth pipeline (``depth/``), and the
tracker's multi-view path.

The single-robot system is covered too (``runtime/system.py``): NetVLAD
retrieval fused into the extraction, loop detection with PnP
verification, PCM outlier rejection and pose-graph optimisation (dense
LM or matrix-free PCG, ``pgo/``), with RGB-D input, dataset replay
(``runtime/dataset_vio.py``), the two-thread runtime and the threaded
quadcam depth replay (``runtime/depth_replay.py``). The estimator takes
inverse-depth or world-position (``pos3d``) landmarks, LM or dogleg
steps, and estimates extrinsics and the camera time offset online.

The two-robot swarm runs in the single estimation mode: ``comm/`` (the
wire codec, the UDP multicast transport, an in-memory bus, LoopNet),
SuperGlue as the tracker's and the loop detector's matcher, inter-robot
loops, map alignment and merge (``vins/swarm.py``,
``D2Estimator.move_all_poses``) and one pose graph over both robots.

The tools: the MSCKF filter (``vins/msckf.py``), the ONNX reader and its
lowering to torch ops (``tools/onnx_io.py``, ``tools/onnx_torch.py``)
behind the SuperPoint, NetVLAD and trained-HitNet loaders, int8 weight
quantization, descriptor PCA, camera calibration (``tools/``) and the
frontend trainers (``frontend/train_frontend.py``).
"""
