"""Command-line tools of the port: ``python -m airdos_tpu_torch.tools.evaluate``."""
