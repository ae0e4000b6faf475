"""Write a synthetic scene out in EuRoC-ASL layout.

Counterpart of ``d2slam_tpu/utils/euroc_writer.py``: datasets the
reader and the pipelined runtime replay end to end without external
data. The PNGs are written by the port's own encoder
(:mod:`d2slam_tpu_torch.utils.pngio`), not Pillow; they decode to the
same ``uint8`` pixels as the JAX writer's files. ``uint8`` images are
written as they are.
"""
from __future__ import annotations

import os

import numpy as np

from d2slam_tpu_torch.utils.pngio import png_encode_gray


def write_euroc_dataset(
    root: str,
    imu_samples,          # iterable of (t, acc, gyr)
    frames,               # sequence of (t, [img arrays in [0,1], or uint8])
    gt_poses=None,        # iterable of (t, pose7 xyzw)
) -> None:
    mav = os.path.join(root, "mav0")
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,"
                "a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for (t, acc, gyr) in imu_samples:
            f.write(f"{int(round(t * 1e9))},{gyr[0]},{gyr[1]},{gyr[2]},"
                    f"{acc[0]},{acc[1]},{acc[2]}\n")

    n_cams = len(frames[0][1]) if frames else 0
    for c in range(n_cams):
        cdir = os.path.join(mav, f"cam{c}")
        os.makedirs(os.path.join(cdir, "data"), exist_ok=True)
        with open(os.path.join(cdir, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for (t, imgs) in frames:
                ns = int(round(t * 1e9))
                name = f"{ns}.png"
                f.write(f"{ns},{name}\n")
                arr = np.asarray(imgs[c])
                if arr.dtype != np.uint8:
                    # truncation, as the JAX writer quantizes for PIL
                    arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
                with open(os.path.join(cdir, "data", name), "wb") as img_f:
                    img_f.write(png_encode_gray(arr))

    if gt_poses:
        gdir = os.path.join(mav, "state_groundtruth_estimate0")
        os.makedirs(gdir, exist_ok=True)
        with open(os.path.join(gdir, "data.csv"), "w") as f:
            f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
            for (t, p) in gt_poses:
                f.write(f"{int(round(t * 1e9))},{p[0]},{p[1]},{p[2]},"
                        f"{p[6]},{p[3]},{p[4]},{p[5]}\n")
