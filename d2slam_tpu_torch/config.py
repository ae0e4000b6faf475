"""Typed configuration tree for the whole framework.

One dataclass tree, YAML-loadable, replacing the reference's three-layer
roslaunch/ROS-param/cv::FileStorage config stack
(reference: d2vins/src/d2vins_params.hpp:17-141, d2frontend_params.h,
README.md documents ~90 keys). Defaults follow the reference's
recommended dataset configs.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class IMUConfig:
    acc_n: float = 0.1        # accelerometer noise density
    gyr_n: float = 0.05       # gyro noise density
    acc_w: float = 0.002      # accelerometer random walk
    gyr_w: float = 0.0004     # gyro random walk
    g_norm: float = 9.805
    imu_freq: float = 400.0


@dataclasses.dataclass
class EstimatorConfig:
    """VIO backend tunables (reference d2vins_params.hpp)."""

    max_sld_win_size: int = 11      # window keyframes
    min_solve_frames: int = 6       # start solving at this many frames
    max_solve_cnt: int = 200        # tau_l: landmarks per solve
    max_solve_measurements: int = 1000  # tau_m
    landmark_estimate_tracks: int = 4   # min tracks to use a landmark
    max_lm_slots: int = 256         # padded landmark slots
    max_imu_samples: int = 64       # per frame interval
    focal_length: float = 460.0     # for sqrt_info & px thresholds
    min_depth: float = 0.3
    max_depth: float = 150.0
    max_solver_iters: int = 8
    estimate_td: bool = False
    estimate_extrinsic: bool = False
    enable_fej: bool = True
    depth_sqrt_inf: float = 20.0
    huber_delta: float = 1.0
    triangulate_max_err: float = 0.5       # unit-sphere reproj gate (rad*f?)
    outlier_reproject_px: float = 10.0     # post-solve rejection gate
    min_triangulate_baseline: float = 0.02
    estimation_mode: str = "single"        # single | distributed | server
    #   (read by the system, SystemConfig.estimation_mode; kept here as in
    #   the JAX package's tree so one YAML file loads into both)
    landmark_param: str = "inv_dep"        # inv_dep | pos3d (reference
    #                                        landmark_param, d2vins_params.hpp:70-73)
    remove_base_when_margin_remote: int = 2  # 0: drop observer-removed rows of
    #   kept-anchor landmarks; 2 (reference default, d2vins_params.hpp:108):
    #   include those rows and Schur-eliminate the landmark into the prior
    #   (ParamResidualInfo.hpp:27, marginalization.cpp:106)
    solver_method: str = "lm"              # lm | dogleg (Ceres trust-region strategies)
    cholesky_refine_steps: int = 0         # iterative refinement (use 1 with float32)
    consensus_max_steps: int = 1           # multi-robot consensus (not ported yet)
    rho_frame_T: float = 100.0
    rho_frame_theta: float = 100.0


@dataclasses.dataclass
class D2Config:
    self_id: int = 0
    imu: IMUConfig = dataclasses.field(default_factory=IMUConfig)
    estimator: EstimatorConfig = dataclasses.field(default_factory=EstimatorConfig)
    num_cams: int = 2
    dtype: str = "float64"  # solver dtype; float64 on the card too
    # kalibr camchain YAML with the cameras + imu-cam extrinsics
    # (reference keys calib_file_path / extrinsic_parameter_type,
    # d2frontend_params.cpp:333-337)
    calib_file: Optional[str] = None
    extrinsic_parameter_type: int = 1

    @staticmethod
    def from_yaml(path: str) -> "D2Config":
        """Load a preset (``config/*.yaml``): the ``imu`` and ``estimator``
        sections set the fields they name, the top level sets
        ``self_id``, ``num_cams``, ``dtype``, ``calib_file`` (relative to
        the YAML's directory) and ``extrinsic_parameter_type``; unknown
        keys are ignored, as in the JAX package. Needs PyYAML."""
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        cfg = D2Config()
        for section, field in (("imu", cfg.imu), ("estimator", cfg.estimator)):
            for k, v in (raw.get(section) or {}).items():
                if hasattr(field, k):
                    setattr(field, k, v)
        for k in ("self_id", "num_cams", "dtype", "calib_file", "extrinsic_parameter_type"):
            if k in raw:
                setattr(cfg, k, raw[k])
        if cfg.calib_file and not os.path.isabs(cfg.calib_file):
            cfg.calib_file = os.path.join(os.path.dirname(os.path.abspath(path)),
                                          cfg.calib_file)
        return cfg

    def load_cameras(self):
        """The kalibr camchain named by ``calib_file``, as a list of
        :class:`d2slam_tpu_torch.geometry.kalibr.KalibrCamera`."""
        if not self.calib_file:
            raise ValueError("config has no calib_file")
        from d2slam_tpu_torch.geometry.kalibr import load_camchain

        return load_camchain(self.calib_file, self.extrinsic_parameter_type)
