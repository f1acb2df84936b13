"""EuRoC MAV stereo driver (reference: Examples/Stereo/stereo_euroc.cc).

Raw cam0/cam1 images are undistorted + rectified from the LEFT.*/RIGHT.*
calibration blocks in the settings YAML before tracking.

Usage:
    python -m airdos_tpu_torch.examples.stereo_euroc <settings.yaml> \
        <dataset_dir> <timestamps.txt> <traj_out> [--device cpu]
"""
import sys
import time

from airdos_tpu_torch.examples import split_device


def main(argv=None, device="cuda"):
    args, device = split_device(argv, device, sys.argv[1:])
    if len(args) < 4:
        print(__doc__)
        return 1
    settings, data_dir, ts_file, traj_out = args[:4]
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.datasets import EurocStereoSequence
    from airdos_tpu_torch.slam.system import System

    cfg = SlamConfig.from_yaml(settings)
    cfg.human.ok = False
    seq = EurocStereoSequence(data_dir, ts_file, settings_yaml=settings,
                              start=cfg.scheduler.n_start_image,
                              end=cfg.scheduler.n_end_image)
    slam = System(cfg, device=device)
    times = []
    for data in seq:
        if data.image_left is None or data.image_right is None:
            continue
        t0 = time.perf_counter()
        slam.track_stereo(data)
        times.append(time.perf_counter() - t0)
    slam.shutdown()
    slam.save_trajectory_tum(traj_out)
    times.sort()
    if times:
        print(f"median tracking time: {times[len(times) // 2]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
