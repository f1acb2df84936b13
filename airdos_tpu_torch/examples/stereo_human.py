"""TartanAir-Shibuya stereo+human driver.

Equivalent of the reference's Examples/Stereo/stereo_human.cc: consumes the
same sequence layout (image_0/, image_1/, rcnnseg_image_0/, alphapose_0/,
track_id_alpha/, times.txt), the same YAML settings files
(Examples/Stereo/config/tartanair.yaml works unchanged), and writes the same
TUM 8-column trajectory.

Usage:
    python -m airdos_tpu_torch.examples.stereo_human <settings.yaml> \
        <sequence_dir> <trajectory_out.txt> [map_dump_dir] [--device cpu]
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
    dump_dir = args[3] if len(args) > 3 else None

    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.datasets import TartanAirStereoSequence
    from airdos_tpu_torch.slam.system import System

    cfg = SlamConfig.from_yaml(settings)
    seq = TartanAirStereoSequence(
        seq_dir, with_masks=cfg.system.is_mask, with_humans=cfg.human.ok,
        start=cfg.scheduler.n_start_image, end=cfg.scheduler.n_end_image,
        use_tracked_id=cfg.human.use_tracked_id > 0)
    slam = System(cfg, device=device)

    times = []
    # one-frame lookahead: the next frame's image upload is issued before
    # tracking the current one, so the copy overlaps the current frame's
    # device work (the reference's LoadImages pre-reads all paths up
    # front, stereo_human.cc:55-74)
    it = iter(seq)
    nxt = next(it, None)
    while nxt is not None:
        data, nxt = nxt, next(it, None)
        t0 = time.perf_counter()
        if nxt is not None:
            slam.prefetch(nxt)
        slam.track_stereo_human(data)
        times.append(time.perf_counter() - t0)

    if dump_dir:
        slam.before_end(dump_dir)
    slam.shutdown()
    slam.save_trajectory_tum(traj_out)

    times.sort()
    n = len(times)
    print("-------")
    print(f"median tracking time: {times[n // 2]:.4f}")
    print(f"mean tracking time: {sum(times) / max(n, 1):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
