from airdos_tpu_torch.io.tum import (  # noqa: F401
    write_trajectory_tum, read_trajectory_tum, write_trajectory_kitti,
)
from airdos_tpu_torch.io.datasets import (  # noqa: F401
    TartanAirStereoSequence, read_alphapose_file, read_track_ids,
    read_ground_truth_poses, read_number_txt,
)
