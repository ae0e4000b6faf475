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
LM or matrix-free PCG, ``pgo/``).
"""
