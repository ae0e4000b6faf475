"""Tiny versions of the cells, for runs on the CPU with the kernels'
plain versions."""
from portbench import harness

OVERRIDES = {
    "euroc_stereo.explore": {
        "config": {"image_hw": [120, 160], "fx": 110.0, "camera_hz": 10},
        "traffic": {"warmup_max_frames": 16, "warmup_solves": 1, "warmup_pgo_solves": 0,
                    "pool_frames_per_s": 3, "trace_seconds": 1, "n_landmarks": 200,
                    "flight": {"radius_m": 5.0, "omega_rad_s": 1.2, "height_m": 2.0}},
    },
    "quadcam_single.depth_replay": {
        "config": {"fisheye_hw": [96, 128],
                   "fisheye": {"fx": 38.0, "fy": 38.0, "cx": 64.0, "cy": 48.0, "k2": 0.005},
                   "depth": {"out_hw": [48, 64], "virtual_fov_deg": 90.0, "max_disp": 16,
                             "block": 9, "min_z": 0.3, "max_z": 30.0}},
        "traffic": {"pool_frames": 4, "bag_frames": 8, "warmup_frames": 8,
                    "trace_seconds": 1},
    },
}
SECONDS = {"euroc_stereo.explore": 8.0, "quadcam_single.depth_replay": 2.0}


def run(cell, seed=2**31 + 5, trace=False, seconds=None, **kw):
    return harness.run_cell(cell, seed, seconds or SECONDS[cell], trace, "cpu", harness.boottime(),
                            overrides=OVERRIDES[cell], log=lambda s: None, **kw)
