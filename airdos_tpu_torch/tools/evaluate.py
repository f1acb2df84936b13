"""Trajectory evaluation (reference: Evaluation/evaluate.py).

Computes ATE RMSE, RPE translation, RPE rotation between an estimated TUM
trajectory and ground truth, with SE(3) Umeyama alignment (scale fixed),
the same metrics evo reports with ``--align``.  Uses evo when installed,
otherwise the built-in implementation.

Usage:
    python -m airdos_tpu_torch.tools.evaluate --estimate est.txt \
        --gt gt.txt [--plot out.png]
"""
import argparse

import numpy as np


def evo_metrics(est_path: str, gt_path: str):
    """(ate, rpe_trans, rpe_rot_deg) computed by evo, mirroring the
    reference's Evaluation/evaluate.py:31-39 (main_ape aligned scale-fixed;
    main_rpe delta=1 frame, all pairs).  Raises ImportError when evo is
    not installed; the caller then uses the builtin implementation."""
    import copy

    from evo.core import metrics, sync
    from evo.tools import file_interface

    ref = file_interface.read_tum_trajectory_file(gt_path)
    est = file_interface.read_tum_trajectory_file(est_path)
    ref_s, est_s = sync.associate_trajectories(ref, est, max_diff=0.02)
    est_al = copy.deepcopy(est_s)
    est_al.align(ref_s, correct_scale=False)

    ape = metrics.APE(metrics.PoseRelation.translation_part)
    ape.process_data((ref_s, est_al))
    ate = float(ape.get_statistic(metrics.StatisticsType.rmse))

    rpe_t = metrics.RPE(metrics.PoseRelation.translation_part,
                        delta=1, delta_unit=metrics.Unit.frames,
                        all_pairs=True)
    rpe_t.process_data((ref_s, est_al))
    rpe_r = metrics.RPE(metrics.PoseRelation.rotation_angle_deg,
                        delta=1, delta_unit=metrics.Unit.frames,
                        all_pairs=True)
    rpe_r.process_data((ref_s, est_al))
    return (ate, float(rpe_t.get_statistic(metrics.StatisticsType.rmse)),
            float(rpe_r.get_statistic(metrics.StatisticsType.rmse)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--estimate", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--plot", default=None)
    args = ap.parse_args(argv)

    from airdos_tpu_torch.io.tum import ate_rmse, read_trajectory_tum, rpe

    ts_e, R_e, t_e = read_trajectory_tum(args.estimate)
    ts_g, R_g, t_g = read_trajectory_tum(args.gt)

    # associate by nearest timestamp (0.02 s window like evo's default)
    idx_g = np.searchsorted(ts_g, ts_e)
    idx_g = np.clip(idx_g, 0, len(ts_g) - 1)
    keep = np.abs(ts_g[idx_g] - ts_e) < 0.02
    if keep.sum() < 3:
        # fall back to index alignment
        n = min(len(ts_e), len(ts_g))
        R_e, t_e, R_g2, t_g2 = R_e[:n], t_e[:n], R_g[:n], t_g[:n]
    else:
        R_e, t_e = R_e[keep], t_e[keep]
        R_g2, t_g2 = R_g[idx_g[keep]], t_g[idx_g[keep]]

    try:
        ate, rpe_t, rpe_r = evo_metrics(args.estimate, args.gt)
        backend = "evo"
    except ImportError:
        ate = ate_rmse(t_e, t_g2)
        rpe_t, rpe_r = rpe(ts_e, R_e, t_e, R_g2, t_g2, delta=1)
        backend = "builtin"
    print(f"ATE RMSE [m]:        {ate:.6f}")
    print(f"RPE trans RMSE [m]:  {rpe_t:.6f}")
    print(f"RPE rot RMSE [deg]:  {rpe_r:.6f}")
    print(f"(backend: {backend})")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 7))
        ax.plot(t_g2[:, 0], t_g2[:, 2], "-", c="#888", label="ground truth")
        ax.plot(t_e[:, 0], t_e[:, 2], "-", c="#1565c0", label="estimate")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.set_aspect("equal")
        ax.legend()
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"plot saved to {args.plot}")
    return 0


if __name__ == "__main__":
    main()
