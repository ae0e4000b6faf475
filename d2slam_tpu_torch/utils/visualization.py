"""Headless visualization suite.

Counterpart of ``d2slam_tpu/utils/visualization.py``: the reference's
D2Visualization publishers — odometry, per-drone paths, landmark point
clouds, camera poses, sliding-window markers
(d2vins/src/visualization/visualization.cpp:39-194) — and the frontend
draw overlays (feature tracks, stereo and loop matches,
d2frontend/src/d2featuretracker.cpp:843-1000). Host code only.

The figures render with matplotlib's Agg backend to PNG files. matplotlib
is imported by the figure functions only, so the module imports where it
is not installed; the figure functions then raise ``ImportError``. The
image overlays are numpy alone (``disparity_to_rgb`` carries matplotlib's
"turbo" table) and give the same arrays as the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from d2slam_tpu_torch.utils import np_lie

_DRONE_COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:red",
                 "tab:purple", "tab:brown", "tab:pink", "tab:gray"]

# matplotlib's "turbo" colormap (256 RGB entries, in units of 1e-5; the
# quotient is the float of matplotlib's 5-decimal literal exactly)
_TURBO = np.array("""
    18995 07176 23217 19483 08339 26149 19956 09498 29024 20415 10652 31844 20860 11802 34607
    21291 12947 37314 21708 14087 39964 22111 15223 42558 22500 16354 45096 22875 17481 47578
    23236 18603 50004 23582 19720 52373 23915 20833 54686 24234 21941 56942 24539 23044 59142
    24830 24143 61286 25107 25237 63374 25369 26327 65406 25618 27412 67381 25853 28492 69300
    26074 29568 71162 26280 30639 72968 26473 31706 74718 26652 32768 76412 26816 33825 78050
    26967 34878 79631 27103 35926 81156 27226 36970 82624 27334 38008 84037 27429 39043 85393
    27509 40072 86692 27576 41097 87936 27628 42118 89123 27667 43134 90254 27691 44145 91328
    27701 45152 92347 27698 46153 93309 27680 47151 94214 27648 48144 95064 27603 49132 95857
    27543 50115 96594 27469 51094 97275 27381 52069 97899 27273 53040 98461 27106 54015 98930
    26878 54995 99303 26592 55979 99583 26252 56967 99773 25862 57958 99876 25425 58950 99896
    24946 59943 99835 24427 60937 99697 23874 61931 99485 23288 62923 99202 22676 63913 98851
    22039 64901 98436 21382 65886 97959 20708 66866 97423 20021 67842 96833 19326 68812 96190
    18625 69775 95498 17923 70732 94761 17223 71680 93981 16529 72620 93161 15844 73551 92305
    15173 74472 91416 14519 75381 90496 13886 76279 89550 13278 77165 88580 12698 78037 87590
    12151 78896 86581 11639 79740 85559 11167 80569 84525 10738 81381 83484 10357 82177 82437
    10026 82955 81389 09750 83714 80342 09532 84455 79299 09377 85175 78264 09287 85875 77240
    09267 86554 76230 09320 87211 75237 09451 87844 74265 09662 88454 73316 09958 89040 72393
    10342 89600 71500 10815 90142 70599 11374 90673 69651 12014 91193 68660 12733 91701 67627
    13526 92197 66556 14391 92680 65448 15323 93151 64308 16319 93609 63137 17377 94053 61938
    18491 94484 60713 19659 94901 59466 20877 95304 58199 22142 95692 56914 23449 96065 55614
    24797 96423 54303 26180 96765 52981 27597 97092 51653 29042 97403 50321 30513 97697 48987
    32006 97974 47654 33517 98234 46325 35043 98477 45002 36581 98702 43688 38127 98909 42386
    39678 99098 41098 41229 99268 39826 42778 99419 38575 44321 99551 37345 45854 99663 36140
    47375 99755 34963 48879 99828 33816 50362 99879 32701 51822 99910 31622 53255 99919 30581
    54658 99907 29581 56026 99873 28623 57357 99817 27712 58646 99739 26849 59891 99638 26038
    61088 99514 25280 62233 99366 24579 63323 99195 23937 64362 98999 23356 65394 98775 22835
    66428 98524 22370 67462 98246 21960 68494 97941 21602 69525 97610 21294 70553 97255 21032
    71577 96875 20815 72596 96470 20640 73610 96043 20504 74617 95593 20406 75617 95121 20343
    76608 94627 20311 77591 94113 20310 78563 93579 20336 79524 93025 20386 80473 92452 20459
    81410 91861 20552 82333 91253 20663 83241 90627 20788 84133 89986 20926 85010 89328 21074
    85868 88655 21230 86709 87968 21391 87530 87267 21555 88331 86553 21719 89112 85826 21880
    89870 85087 22038 90605 84337 22188 91317 83576 22328 92004 82806 22456 92666 82025 22570
    93301 81236 22667 93909 80439 22744 94489 79634 22800 95039 78823 22831 95560 78005 22836
    96049 77181 22811 96507 76352 22754 96931 75519 22663 97323 74682 22536 97679 73842 22369
    98000 73000 22161 98289 72140 21918 98549 71250 21650 98781 70330 21358 98986 69382 21043
    99163 68408 20706 99314 67408 20348 99438 66386 19971 99535 65341 19577 99607 64277 19165
    99654 63193 18738 99675 62093 18297 99672 60977 17842 99644 59846 17376 99593 58703 16899
    99517 57549 16412 99419 56386 15918 99297 55214 15417 99153 54036 14910 98987 52854 14398
    98799 51667 13883 98590 50479 13367 98360 49291 12849 98108 48104 12332 97837 46920 11817
    97545 45740 11305 97234 44565 10797 96904 43399 10294 96555 42241 09798 96187 41093 09310
    95801 39958 08831 95398 38836 08362 94977 37729 07905 94538 36638 07461 94084 35566 07031
    93612 34513 06616 93125 33482 06218 92623 32473 05837 92105 31489 05475 91572 30530 05134
    91024 29599 04814 90463 28696 04516 89888 27824 04243 89298 26981 03993 88691 26152 03753
    88066 25334 03521 87422 24526 03297 86760 23730 03082 86079 22945 02875 85380 22170 02677
    84662 21407 02487 83926 20654 02305 83172 19912 02131 82399 19182 01966 81608 18462 01809
    80799 17753 01660 79971 17055 01520 79125 16368 01387 78260 15693 01264 77377 15028 01148
    76476 14374 01041 75556 13731 00942 74617 13098 00851 73661 12477 00769 72686 11867 00695
    71692 11268 00629 70680 10680 00571 69650 10102 00522 68602 09536 00481 67535 08980 00449
    66449 08436 00424 65345 07902 00408 64223 07380 00401 63082 06868 00401 61923 06367 00410
    60746 05878 00427 59550 05399 00453 58336 04931 00486 57103 04474 00529 55852 04028 00579
    54583 03593 00638 53295 03169 00705 51989 02756 00780 50664 02354 00863 49321 01963 00955
    47960 01583 01055
""".split(), np.float64).reshape(256, 3) / 1e5


def _pyplot():
    """matplotlib.pyplot on the Agg backend; ImportError without it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the figures of d2slam_tpu_torch.utils.visualization need "
                          "matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, ax, title, path):
    plt = _pyplot()
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_trajectories(
    trajs: Dict[int, np.ndarray],
    gt: Optional[Dict[int, np.ndarray]] = None,
    path: Optional[str] = None,
    title: str = "trajectories",
    loops: Optional[Sequence] = None,
):
    """Top-down + height profile of per-drone trajectories.

    trajs: {drone_id: [N, 3] or [N, 7] positions(+quat)}; gt optional
    with the same layout; loops: optional [(drone_a, idx_a, drone_b,
    idx_b)] inter-drone loop edges drawn as dashed segments.
    Returns the matplotlib figure (saved to ``path`` when given).
    """
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5), gridspec_kw={"width_ratios": [2, 1]})
    for i, (did, arr) in enumerate(sorted(trajs.items())):
        p = np.asarray(arr)[:, :3]
        c = _DRONE_COLORS[i % len(_DRONE_COLORS)]
        ax1.plot(p[:, 0], p[:, 1], color=c, label=f"drone {did}")
        ax1.scatter(p[0, 0], p[0, 1], color=c, marker="^", s=40)
        ax2.plot(p[:, 2], color=c)
    if gt:
        for i, (did, arr) in enumerate(sorted(gt.items())):
            p = np.asarray(arr)[:, :3]
            ax1.plot(p[:, 0], p[:, 1], "k--", alpha=0.4, label="gt" if i == 0 else None)
            ax2.plot(p[:, 2], "k--", alpha=0.4)
    for (da, ia, db, ib) in loops or ():
        pa = np.asarray(trajs[da])[ia, :3]
        pb = np.asarray(trajs[db])[ib, :3]
        ax1.plot([pa[0], pb[0]], [pa[1], pb[1]], "r:", alpha=0.7, lw=0.8)
    ax1.set_xlabel("x [m]")
    ax1.set_ylabel("y [m]")
    ax2.set_xlabel("keyframe")
    ax2.set_ylabel("z [m]")
    return _finish(fig, ax1, title, path)


def plot_sliding_window(
    poses: np.ndarray,           # [W, 7]
    landmarks: Optional[np.ndarray] = None,   # [L, 3]
    landmark_valid: Optional[np.ndarray] = None,
    path: Optional[str] = None,
    title: str = "sliding window",
):
    """Sliding-window state: keyframe poses (with heading tick) and the
    triangulated landmark cloud (reference sliding-window markers +
    landmark point cloud publishers)."""
    plt = _pyplot()
    poses = np.asarray(poses)
    fig, ax = plt.subplots(figsize=(6, 6))
    p = poses[:, :3]
    ax.plot(p[:, 0], p[:, 1], "o-", color="tab:blue", ms=4, label="window")
    for i in range(len(poses)):
        fwd = np_lie.quat_to_rotmat(poses[i, 3:]) @ np.array([1.0, 0, 0]) * 0.3
        ax.arrow(p[i, 0], p[i, 1], fwd[0], fwd[1], head_width=0.05, color="tab:blue", alpha=0.6)
    if landmarks is not None:
        lm = np.asarray(landmarks)
        m = (np.asarray(landmark_valid).astype(bool) if landmark_valid is not None
             else np.ones(len(lm), bool))
        ax.scatter(lm[m, 0], lm[m, 1], s=4, c="tab:green", alpha=0.5,
                   label=f"landmarks ({int(m.sum())})")
    return _finish(fig, ax, title, path)


def plot_pose_graph(
    poses: Dict[int, np.ndarray],       # {drone: [N, >=3]}
    odometry_edges: bool = True,
    loop_edges: Optional[Sequence] = None,  # [(da, ia, db, ib)]
    path: Optional[str] = None,
    title: str = "pose graph",
):
    """Pose-graph structure view (reference d2pgo path publishers + g2o
    snapshots)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 6))
    for i, (did, arr) in enumerate(sorted(poses.items())):
        p = np.asarray(arr)[:, :3]
        c = _DRONE_COLORS[i % len(_DRONE_COLORS)]
        if odometry_edges:
            ax.plot(p[:, 0], p[:, 1], "-", color=c, lw=0.8, alpha=0.8)
        ax.scatter(p[:, 0], p[:, 1], s=6, color=c, label=f"drone {did}")
    for (da, ia, db, ib) in loop_edges or ():
        pa = np.asarray(poses[da])[ia, :3]
        pb = np.asarray(poses[db])[ib, :3]
        ax.plot([pa[0], pb[0]], [pa[1], pb[1]], "r--", lw=0.7, alpha=0.8)
    return _finish(fig, ax, title, path)


# ---------------------------------------------------------------------------
# image overlays (numpy -> RGB uint8 arrays)
# ---------------------------------------------------------------------------


def _to_rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 if img.max() <= 1.5 else img, 0, 255)
        img = img.astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img.copy()


def _draw_disc(rgb, x, y, color, r=2):
    H, W, _ = rgb.shape
    xi, yi = int(round(x)), int(round(y))
    y0, y1 = max(0, yi - r), min(H, yi + r + 1)
    x0, x1 = max(0, xi - r), min(W, xi + r + 1)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m = (yy - yi) ** 2 + (xx - xi) ** 2 <= r * r
    rgb[y0:y1, x0:x1][m] = color


def _draw_line(rgb, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    H, W, _ = rgb.shape
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    rgb[ys[ok], xs[ok]] = color


def _mask(mask, n):
    return np.asarray(mask).astype(bool) if mask is not None else np.ones(n, bool)


def draw_feature_tracks(
    img: np.ndarray,
    kpts_prev: np.ndarray,   # [N, 2]
    kpts_cur: np.ndarray,    # [N, 2]
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Track overlay: current keypoints (green) with motion trails to
    the previous frame (the reference's cv::line/cv::circle track
    drawing, d2featuretracker.cpp:843-1000). Returns RGB uint8."""
    rgb = _to_rgb(img)
    kp, kc = np.asarray(kpts_prev), np.asarray(kpts_cur)
    m = _mask(mask, len(kc))
    for i in np.flatnonzero(m):
        _draw_line(rgb, kp[i, 0], kp[i, 1], kc[i, 0], kc[i, 1], (255, 160, 0))
        _draw_disc(rgb, kc[i, 0], kc[i, 1], (0, 220, 0))
    return rgb


def draw_matches(
    img_a: np.ndarray,
    img_b: np.ndarray,
    kpts_a: np.ndarray,
    kpts_b: np.ndarray,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Side-by-side match visualization (the reference's loop/stereo
    match debug images). Returns RGB uint8 [H, Wa+Wb, 3]."""
    ra, rb = _to_rgb(img_a), _to_rgb(img_b)
    H = max(ra.shape[0], rb.shape[0])
    canvas = np.zeros((H, ra.shape[1] + rb.shape[1], 3), np.uint8)
    canvas[: ra.shape[0], : ra.shape[1]] = ra
    canvas[: rb.shape[0], ra.shape[1]:] = rb
    ka, kb = np.asarray(kpts_a), np.asarray(kpts_b)
    off = ra.shape[1]
    for i in np.flatnonzero(_mask(mask, len(ka))):
        _draw_disc(canvas, ka[i, 0], ka[i, 1], (0, 220, 0))
        _draw_disc(canvas, kb[i, 0] + off, kb[i, 1], (0, 220, 0))
        _draw_line(canvas, ka[i, 0], ka[i, 1], kb[i, 0] + off, kb[i, 1], (60, 160, 255))
    return canvas


def disparity_to_rgb(disp: np.ndarray, max_disp: float = 32.0) -> np.ndarray:
    """Colormapped disparity (the reference's disp_show conversion,
    virtual_stereo.cpp:170): matplotlib's "turbo" lookup (256 bins, the
    top edge in the last bin, NaN black)."""
    d = np.clip(np.asarray(disp, np.float64) / max_disp, 0.0, 1.0)
    idx = d * len(_TURBO)
    idx[idx == len(_TURBO)] = len(_TURBO) - 1
    bad = np.isnan(idx)
    with np.errstate(invalid="ignore"):
        idx = idx.astype(int)
    idx[bad] = 0
    rgb = _TURBO[idx]
    rgb[bad] = 0.0
    return (rgb * 255).astype(np.uint8)
