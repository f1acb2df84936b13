"""The dataset drivers, run as ``python -m airdos_tpu_torch.examples.<name>``
(stereo_kitti, stereo_human, stereo_euroc, synthetic_demo).  Each takes
airdos_tpu's examples/<name>.py arguments, and ``--device cpu`` to run
without a card; ``main(argv, device)`` is the same from Python."""
from __future__ import annotations

from typing import List, Optional, Tuple


def split_device(argv: Optional[List[str]], device: str,
                 argv0: List[str]) -> Tuple[List[str], str]:
    """(positional arguments, device): argv (sys.argv[1:] when None) with
    a ``--device <name>`` pair taken out, which overrides device."""
    args = list(argv0 if argv is None else argv)
    if "--device" in args:
        i = args.index("--device")
        if i + 1 >= len(args):
            raise SystemExit("--device needs a value (cuda or cpu)")
        device = args[i + 1]
        del args[i:i + 2]
    return args, device
