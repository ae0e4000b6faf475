"""The numbers that decide ``correct``: each is a gap between what the
timed path produced and the plain reference, where 0 is agreement and a
run is correct when every number is at most its limit."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.superpoint import sample_descriptors
from portbench.yardstick.geometry import pose_compose, quat_to_rotmat

KEYPOINT_PX = 1.0        # a keypoint is found again within this distance
DEPTH_REL = 1e-3         # depths agree within this share of the reference's


def keypoint_gaps(kpts, valid, desc, ref_kpts, ref_valid, ref_desc_map):
    """One image. ``kp_miss``: the larger of the share of the reference's
    keypoints with no keypoint of the program within ``KEYPOINT_PX`` and
    the share of the program's with none of the reference's. ``desc_gap``:
    the widest 1 - cosine between a descriptor of the program and the
    reference's descriptor at the same keypoint."""
    P = torch.as_tensor(np.asarray(kpts)[np.asarray(valid)], dtype=torch.float32)
    R = ref_kpts[ref_valid].float().cpu()
    if len(P) == 0 or len(R) == 0:
        return dict(kp_miss=1.0, desc_gap=2.0)
    d = torch.cdist(P, R)
    miss = max(float((d.min(0).values > KEYPOINT_PX).float().mean()),
               float((d.min(1).values > KEYPOINT_PX).float().mean()))
    dev = ref_desc_map.device
    at = sample_descriptors(ref_desc_map[None], P[None].to(dev))[0]
    D = torch.as_tensor(np.asarray(desc)[np.asarray(valid)], dtype=torch.float32, device=dev)
    gap = float((1.0 - (D * at).sum(-1)).max())
    return dict(kp_miss=miss, desc_gap=gap)


def depth_gaps(z, valid, ref_z, ref_valid):
    """One frame, all pairs. ``valid_mismatch``: the share of pixels whose
    validity differs. ``depth_off``: of the pixels valid on both sides,
    the share whose depth differs by more than ``DEPTH_REL``."""
    z, valid = torch.as_tensor(z), torch.as_tensor(valid)
    ref_z, ref_valid = ref_z.cpu(), ref_valid.cpu()
    both = valid & ref_valid
    off = (z - ref_z).abs() > DEPTH_REL * ref_z.abs()
    return dict(valid_mismatch=float((valid != ref_valid).float().mean()),
                depth_off=float((off & both).sum()) / max(int(both.sum()), 1))


def ate(stamps, poses, truth, anchor_stamp, anchor_pose) -> float:
    """RMSE of keyframe positions against the flight ``truth(t) -> [7]``,
    the estimate's frame tied to the flight's by the pose at
    ``anchor_stamp`` (the run's first keyframe)."""
    g0 = truth(anchor_stamp)
    R0 = quat_to_rotmat(g0[3:])
    inv = np.concatenate([-R0.T @ g0[:3], [-g0[3], -g0[4], -g0[5], g0[6]]])
    align = pose_compose(np.asarray(anchor_pose, np.float64), inv)
    errs = [np.linalg.norm(np.asarray(p[:3]) - pose_compose(align, truth(t))[:3])
            for t, p in zip(stamps, poses)]
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else float("inf")
