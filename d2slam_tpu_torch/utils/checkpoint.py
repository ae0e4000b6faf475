"""Estimator checkpoint / resume.

Counterpart of ``d2slam_tpu/utils/checkpoint.py``: the window state, the
prior (pending window shifts applied), the FEJ snapshots, the window
bookkeeping and the landmark database go to one ``.npz`` with the same
keys as the JAX package writes: ``state_<field>``, ``prior_J``,
``prior_r``, ``prior_row_valid``, ``prior_lin_<field>``, ``fej_poses``,
``fej_sb``, ``meta_json`` and ``landmarks_pickle``. The landmarks are
pickled as the port's own classes, and the loader unpickles only those
(and numpy): a file written by the JAX package holds its classes, so
the port refuses it rather than import that package.
"""
from __future__ import annotations

import io
import json
import pickle
from typing import Dict

import numpy as np
import torch

from d2slam_tpu_torch.solver.state import PriorBlock, VIOState


class _PortUnpickler(pickle.Unpickler):
    """Unpickles the port's landmark classes and numpy arrays only."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in ("d2slam_tpu_torch", "numpy", "copyreg"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint holds {module}.{name}: not a file written by d2slam_tpu_torch")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_estimator(path: str, est) -> None:
    arrays: Dict[str, np.ndarray] = {}
    for name, val in est.state._asdict().items():
        arrays[f"state_{name}"] = _host(val)
    prior = est.prior
    if prior is not None:
        arrays["prior_J"] = _host(prior.J)
        arrays["prior_r"] = _host(prior.r)
        arrays["prior_row_valid"] = _host(prior.row_valid)
        for name, val in prior.lin._asdict().items():
            arrays[f"prior_lin_{name}"] = _host(val)
    arrays["fej_poses"] = est.fej_poses
    arrays["fej_sb"] = est.fej_sb
    meta = {
        "frames": [(f.frame_id, f.stamp, f.is_keyframe) for f in est.frames],
        "initialized": est.initialized,
        "solve_count": est.solve_count,
        "margin_count": est.margin_count,
    }
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    arrays["landmarks_pickle"] = np.frombuffer(
        pickle.dumps(est.lmanager.db), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_estimator(path: str, est) -> None:
    """Restore a file written by :func:`save_estimator` into ``est``
    (constructed with the same config), on ``est``'s device."""
    from d2slam_tpu_torch.vins.estimator import WindowFrame

    raw = np.load(path, allow_pickle=False)

    def tensor(arr):
        return torch.as_tensor(arr, dtype=est.dtype if arr.dtype.kind == "f" else None,
                               device=est.device)

    est.lmanager.db = _PortUnpickler(io.BytesIO(bytes(raw["landmarks_pickle"]))).load()
    est.state = VIOState(**{n: tensor(raw[f"state_{n}"]) for n in VIOState._fields})
    est._prior = None
    if "prior_J" in raw:
        est._prior = PriorBlock(
            J=tensor(raw["prior_J"]), r=tensor(raw["prior_r"]),
            lin=VIOState(**{n: tensor(raw[f"prior_lin_{n}"]) for n in VIOState._fields}),
            row_valid=tensor(raw["prior_row_valid"]),
        )
    est._pending_perm = None
    est.fej_poses = raw["fej_poses"].copy()
    est.fej_sb = raw["fej_sb"].copy()
    meta = json.loads(bytes(raw["meta_json"]).decode())
    est.frames = [WindowFrame(fid, stamp, kf) for (fid, stamp, kf) in meta["frames"]]
    est.initialized = meta["initialized"]
    est.solve_count = meta["solve_count"]
    est.margin_count = meta["margin_count"]
