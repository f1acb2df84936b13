"""KITTI odometry stereo driver (reference: Examples/Stereo/stereo_kitti.cc).

Usage:
    python -m airdos_tpu_torch.examples.stereo_kitti <settings.yaml> \
        <sequence_dir> <traj_out> [--device cpu]
"""
import sys
import time

from airdos_tpu_torch.examples import split_device


def main(argv=None, device="cuda"):
    args, device = split_device(argv, device, sys.argv[1:])
    if len(args) < 3:
        print(__doc__)
        return 1
    settings, seq_dir, traj_out = args[:3]
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.datasets import KittiStereoSequence
    from airdos_tpu_torch.slam.system import System

    cfg = SlamConfig.from_yaml(settings)
    cfg.human.ok = False
    seq = KittiStereoSequence(seq_dir, start=cfg.scheduler.n_start_image,
                              end=cfg.scheduler.n_end_image)
    slam = System(cfg, device=device)
    times = []
    for data in seq:
        t0 = time.perf_counter()
        slam.track_stereo(data)
        times.append(time.perf_counter() - t0)
    slam.shutdown()
    slam.save_trajectory_kitti(traj_out)
    times.sort()
    print(f"median tracking time: {times[len(times) // 2]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
