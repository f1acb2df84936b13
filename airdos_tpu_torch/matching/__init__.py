from airdos_tpu_torch.matching.stereo import stereo_match, stack_pyramid  # noqa: F401
