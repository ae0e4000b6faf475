"""Kalibr camera-chain YAML loader.

Counterpart of ``d2slam_tpu/geometry/kalibr.py``. The reference
configures its cameras from kalibr-style ``camchain`` YAML files (one
block per ``camN``: ``camera_model`` / ``distortion_model`` /
``intrinsics`` / ``distortion_coeffs`` / ``T_cam_imu`` / ``resolution``
/ ``rostopic`` / ``cam_overlaps``), parsed by
``D2FrontendParams::readCameraCalibrationfromFile`` (reference:
d2frontend/src/d2frontend_params.cpp:376-462). Each camera block maps
onto the matching parameter struct of
:mod:`d2slam_tpu_torch.geometry.cameras`, and ``T_cam_imu`` becomes a
body->camera extrinsic pose.

==============  ================  ==========================
camera_model    distortion_model  parameter struct
==============  ================  ==========================
omni            radtan / none     :class:`MEIParams`
pinhole         radtan / none     :class:`PinholeParams`
pinhole         equidistant       :class:`KBParams`
==============  ================  ==========================

Extrinsic conventions mirror the reference's
``extrinsic_parameter_type`` (d2frontend_params.cpp:450-457):

* type 0 (OmniNxt): ``T_cam_imu`` stores the body(imu)->cam transform
  of *points*; the extrinsic pose is its inverse.
* type 1: ``T_cam_imu`` already is the camera pose in the body frame.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from d2slam_tpu_torch.geometry import cameras as cam
from d2slam_tpu_torch.utils import np_lie


def _pose_from_matrix_np(T: np.ndarray) -> np.ndarray:
    """4x4 homogeneous matrix -> pose [p(3), q_xyzw(4)]."""
    return np.concatenate([T[:3, 3], np_lie.rotmat_to_quat(T[:3, :3])])


_MODELS = {
    "omni": (cam.mei_project, cam.mei_lift),
    "pinhole": (cam.pinhole_project, cam.pinhole_lift),
    "kb": (cam.kb_project, cam.kb_lift),
}


@dataclasses.dataclass
class KalibrCamera:
    """One camera of a kalibr chain."""

    name: str                      # "cam0", "cam1", ...
    model: str                     # "omni" | "pinhole" | "kb"
    params: object                 # MEIParams | PinholeParams | KBParams
    resolution: Tuple[int, int]    # (width, height)
    extrinsic: np.ndarray          # body->cam pose [p(3), q_xyzw(4)]
    T_cam_imu: Optional[np.ndarray] = None   # raw 4x4 from the file
    T_cn_cnm1: Optional[np.ndarray] = None   # raw 4x4 chain transform
    rostopic: Optional[str] = None
    overlaps: Tuple[int, ...] = ()

    def project(self, pts3):
        """Camera-frame 3D points -> ``(pixels, valid)`` (reference
        spaceToPlane)."""
        return _MODELS[self.model][0](pts3, self.params)

    def lift(self, uv):
        """Pixels -> unit rays (reference liftProjective)."""
        return _MODELS[self.model][1](uv, self.params)


def _parse_camera(name: str, node: dict,
                  extrinsic_parameter_type: int) -> KalibrCamera:
    model = str(node.get("camera_model", "pinhole"))
    dist_model = str(node.get("distortion_model", "none"))
    intr = [float(v) for v in node.get("intrinsics", [])]
    dist = [float(v) for v in node.get("distortion_coeffs", [])] + [0.0] * 4
    res = node.get("resolution", [0, 0])

    if model == "omni":
        # intrinsics = [xi, gamma1, gamma2, u0, v0]
        # (reference d2frontend_params.cpp:398-415)
        if dist_model not in ("radtan", "none"):
            raise ValueError(f"{name}: omni supports radtan/none, "
                             f"got {dist_model}")
        params = cam.MEIParams.make(*intr[:5], *dist[:4])
        model_out = "omni"
    elif model == "pinhole" and dist_model in ("radtan", "none"):
        params = cam.PinholeParams.make(*intr[:4], *dist[:4])
        model_out = "pinhole"
    elif model == "pinhole" and dist_model == "equidistant":
        # kalibr equidistant [k1..k4] == camodocal KB k2..k5
        params = cam.KBParams.make(*intr[:4], *dist[:4])
        model_out = "kb"
    else:
        raise ValueError(
            f"{name}: unsupported camera_model/distortion_model "
            f"{model}/{dist_model}")

    T_cam_imu = None
    extrinsic = np.array([0, 0, 0, 0, 0, 0, 1.0])
    if "T_cam_imu" in node:
        T_cam_imu = np.asarray(node["T_cam_imu"], np.float64)
        if extrinsic_parameter_type == 0:
            # the file stores the points-map imu->cam; the camera pose in
            # the body frame is its inverse (d2frontend_params.cpp:450-452)
            Tb = np.eye(4)
            R = T_cam_imu[:3, :3].T
            Tb[:3, :3] = R
            Tb[:3, 3] = -R @ T_cam_imu[:3, 3]
            extrinsic = _pose_from_matrix_np(Tb)
        else:
            extrinsic = _pose_from_matrix_np(T_cam_imu)

    T_cn_cnm1 = None
    if "T_cn_cnm1" in node:
        T_cn_cnm1 = np.asarray(node["T_cn_cnm1"], np.float64)

    return KalibrCamera(
        name=name,
        model=model_out,
        params=params,
        resolution=(int(res[0]), int(res[1])),
        extrinsic=extrinsic,
        T_cam_imu=T_cam_imu,
        T_cn_cnm1=T_cn_cnm1,
        rostopic=node.get("rostopic"),
        overlaps=tuple(node.get("cam_overlaps", []) or ()),
    )


def load_camchain(path: str,
                  extrinsic_parameter_type: int = 0) -> List[KalibrCamera]:
    """Load a kalibr camchain YAML into a list of :class:`KalibrCamera`,
    ordered ``cam0, cam1, ...`` (reference
    readCameraCalibrationfromFile, d2frontend_params.cpp:376-386).
    Needs PyYAML."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    names = sorted((k for k in raw if k.startswith("cam")),
                   key=lambda s: int(s[3:]))
    return [_parse_camera(n, raw[n], extrinsic_parameter_type) for n in names]


def chain_consistency_errors(chain: Sequence[KalibrCamera]) -> List[float]:
    """Max |T_cn_cnm1 @ T_{n-1}_imu - T_n_imu| per camera with a chain
    transform: a check that the file's two extrinsic encodings agree."""
    errs = []
    for prev, cur in zip(chain[:-1], chain[1:]):
        if cur.T_cn_cnm1 is None or prev.T_cam_imu is None \
                or cur.T_cam_imu is None:
            continue
        errs.append(float(np.max(np.abs(
            cur.T_cn_cnm1 @ prev.T_cam_imu - cur.T_cam_imu))))
    return errs
