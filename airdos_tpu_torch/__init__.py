"""airdos_tpu_torch — the stereo SLAM system in PyTorch, for NVIDIA Hopper.

A port of ``airdos_tpu`` (the JAX package beside this one, which stays the
reference).  The layout mirrors it module for module:
``airdos_tpu/matching/stereo.py`` <-> ``airdos_tpu_torch/matching/stereo.py``.

- Host Python owns the tracking state machine and the map bookkeeping, as
  numpy arrays (the same code as the JAX package).
- Dense per-frame work (pyramid, FAST, rBRIEF, Hamming matching, stereo
  SAD, pose LM) and the mapping pass are eager PyTorch on the card
  (``System(config)``; ``device="cpu"`` runs the plain versions on the
  CPU); the all-pairs Hamming matrix and the local BA's segment sums are
  CUDA C++ kernels written for sm_90a (``csrc/``).

This package imports torch and never jax.
"""

__version__ = "0.1.0"

import torch as _torch

# The pose LM's normal equations (solvers/pose_opt.py) and the IC-angle
# patch contraction (ops/orientation.py) need full float32 products, as
# airdos_tpu sets jax_default_matmul_precision="highest".  TF32 keeps ~3
# decimal digits: it would move BRIEF sample points and destabilise the
# closed-form 6x6 solve.  cuDNN's TF32 switch defaults to True.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from airdos_tpu_torch.config import SlamConfig  # noqa: E402,F401
