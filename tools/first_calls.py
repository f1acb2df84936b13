"""The first calls of relocalization's and the loop's kernels in a fresh
process, on the card.

    python3 tools/first_calls.py

Builds csrc/ransac.cu, csrc/sim3_opt.cu and csrc/voc_transform.cu, then
times with a synchronize on both sides each library's load (ctypes) and
each kernel's first and second launch on tests/torch_ransac_cases.py's
inputs, with the device memory in use before and after (a launch that
needs more local memory a thread than the context holds makes the driver
reserve it for every thread the card can run).  Prints one line a step
and the card's name and power limit; checks nothing.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> None:
    import torch

    import torch_ransac_cases as trc
    from airdos_tpu_torch.bow.vocabulary import Vocabulary
    from airdos_tpu_torch.ops import cuda_build
    from airdos_tpu_torch.ops import ransac_kernels as rk
    from airdos_tpu_torch.ops import sim3_opt_kernels as so
    from airdos_tpu_torch.ops import voc_kernels as vk

    if not torch.cuda.is_available():
        sys.exit("tools/first_calls.py needs a CUDA device")
    for module in (rk, so, vk):
        module.build()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()

    def in_use() -> float:
        free, total = torch.cuda.mem_get_info()
        return (total - free) / 2 ** 20

    def timed(name, fn) -> None:
        torch.cuda.synchronize()
        m0, t0 = in_use(), time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"[first] {name}: {(time.perf_counter() - t0) * 1e3:.2f} ms, "
              f"device memory in use {in_use() - m0:+.1f} MiB", flush=True)

    cam = (trc.FX, trc.FY, trc.CX, trc.CY)

    def on(arrays):
        return [torch.from_numpy(np.array(a)).cuda() for a in arrays]

    pnp = on(trc.pnp_case(1, n=400, n_out=80, H=256))
    sim = on(trc.sim3_case(1, n=120, n_out=20, H=256))
    opt = on(trc.opt_case(1, n=150))
    children, desc, word_id = trc.full_tree(1, 8, 3)
    n_words = int((word_id >= 0).sum())
    voc = Vocabulary(k=8, depth=3, node_desc32=desc, children=children,
                     word_id=word_id, weights=np.ones(n_words, np.float32),
                     n_words=n_words, feature_level=1, device="cuda")
    tables = voc._device_tables()
    words = torch.from_numpy(trc.words(1, 1500).view(np.int32)).cuda()
    for module in (rk, so, vk):
        timed(f"load {module._SOURCE.name}",
              lambda m=module: cuda_build.library(m._SOURCE, m._SIGNATURES))
    for when in ("first", "second"):
        timed(f"voc_transform {when}",
              lambda: vk.voc_transform_cuda(*tables, words, 3))
        timed(f"horn_hypotheses {when}",
              lambda: rk.horn_hypotheses_cuda(*sim, *cam, True))
        timed(f"sim3_opt {when}", lambda: so.sim3_opt_cuda(*opt, *cam))
    for when in ("first", "second"):
        timed(f"epnp_hypotheses {when}",
              lambda: rk.epnp_hypotheses_cuda(*pnp, *cam))
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[first] on {smi}", flush=True)


if __name__ == "__main__":
    main()
