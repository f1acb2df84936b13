"""Trajectory I/O in the formats the reference exports.

- TUM 8-column ``time tx ty tz qx qy qz qw`` (reference: System.cc:333-388,
  SaveTrajectoryTUM), consumed unchanged by Evaluation/evaluate.py and
  tartanair_tools.
- KITTI 12-column row-major 3x4 pose (reference: System.cc:425-478).
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from scipy.spatial.transform import Rotation as _R


def write_trajectory_tum(path: str | Path,
                         timestamps: Sequence[float],
                         Rwc: np.ndarray,
                         twc: np.ndarray) -> None:
    """Write camera-to-world poses in TUM format.

    Rwc: [N, 3, 3] rotation camera->world; twc: [N, 3] camera centre in world.
    Quaternion written (qx, qy, qz, qw) like the reference (System.cc:383-384).
    """
    Rwc = np.asarray(Rwc, np.float64)
    twc = np.asarray(twc, np.float64)
    q = _R.from_matrix(Rwc).as_quat()  # (x, y, z, w)
    with open(path, "w") as f:
        for i, ts in enumerate(timestamps):
            f.write(f"{ts:.6f} "
                    f"{twc[i, 0]:.7f} {twc[i, 1]:.7f} {twc[i, 2]:.7f} "
                    f"{q[i, 0]:.7f} {q[i, 1]:.7f} {q[i, 2]:.7f} {q[i, 3]:.7f}\n")


def read_trajectory_tum(path: str | Path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a TUM trajectory -> (timestamps [N], Rwc [N,3,3], twc [N,3])."""
    data = np.loadtxt(path, comments="#", ndmin=2)
    ts = data[:, 0]
    twc = data[:, 1:4]
    quat = data[:, 4:8]  # (qx, qy, qz, qw)
    Rwc = _R.from_quat(quat).as_matrix()
    return ts, Rwc, twc


def write_trajectory_kitti(path: str | Path, Rwc: np.ndarray, twc: np.ndarray) -> None:
    """Write poses as KITTI 12-column rows (row-major [R | t])."""
    Rwc = np.asarray(Rwc, np.float64)
    twc = np.asarray(twc, np.float64)
    with open(path, "w") as f:
        for i in range(len(twc)):
            P = np.hstack([Rwc[i], twc[i][:, None]]).reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in P) + "\n")


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after optional SE(3) Umeyama alignment
    (scale fixed to 1, matching evo's ``align=True, correct_scale=False``)."""
    est = np.asarray(est_t, np.float64)
    gt = np.asarray(gt_t, np.float64)
    assert est.shape == gt.shape
    if align and len(est) >= 3:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        E, G = est - mu_e, gt - mu_g
        U, _, Vt = np.linalg.svd(E.T @ G)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        Ralign = (U @ S @ Vt).T
        est = (Ralign @ E.T).T + mu_g
        gt = G + mu_g
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe(ts: np.ndarray, Rwc: np.ndarray, twc: np.ndarray,
        gt_Rwc: np.ndarray, gt_twc: np.ndarray, delta: int = 1):
    """Relative pose error (translation RMSE [m], rotation RMSE [deg]) over
    all pairs (i, i+delta) — evo's ``rpe --delta 1 --all_pairs`` semantics."""
    n = len(twc) - delta
    dt_err, dr_err = [], []
    for i in range(n):
        # estimated relative motion
        dR_e = Rwc[i].T @ Rwc[i + delta]
        dt_e = Rwc[i].T @ (twc[i + delta] - twc[i])
        dR_g = gt_Rwc[i].T @ gt_Rwc[i + delta]
        dt_g = gt_Rwc[i].T @ (gt_twc[i + delta] - gt_twc[i])
        E_R = dR_g.T @ dR_e
        dt_err.append(np.linalg.norm(dt_e - dt_g))
        angle = np.degrees(np.arccos(np.clip((np.trace(E_R) - 1) / 2, -1, 1)))
        dr_err.append(angle)
    return (float(np.sqrt(np.mean(np.square(dt_err)))),
            float(np.sqrt(np.mean(np.square(dr_err)))))
