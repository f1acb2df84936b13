"""The landmark half of the BAs' Schur complement: CUDA kernel + plain
twin.

Every landmark's 3x3 block is marginalised in airdos_tpu's local BA
(solvers/local_ba.py:130-143 and the back-substitution :164-167), which
the human BA's static half shares.  Given the step's segment sums, the
point blocks pt_sums [P, 12] (Hpp 9 | bp 3) and the camera-point coupling
Wagg [P, C, 6, 3]:

- ``landmark_reduce`` damps each Hpp (diagonal + lam max(trace / 3, 1e-3)
  + 1e-6, in float32), inverts it in closed form (solvers/smallmat.inv3x3's
  adjugate over determinant, zero for an invalid point) and forms Aagg =
  Wagg Hpp^-1 [P, C, 6, 3], the inverse and the products in float64,
  each output rounded to float32 once: a point that one mono edge
  observes has a rank-2 Hpp, and at small damping the float32 adjugate
  cancels to a determinant of 0 or of the wrong sign, whose inverse
  spoils the whole step;
- ``landmark_backsub`` takes the reduced camera step dx_c [C, 6] to the
  points: dx_p = Hpp^-1 (bp - sum_c Wagg_pc^T dx_c), zero for an invalid
  point.  It is computed in float64 from the float32 inputs (each product
  of two of them exact) and rounded to float32 once: at convergence bp
  and the sum cancel, and Hpp^-1 multiplies what is left by up to the
  inverse of its damping along the ray of a point that one edge observes,
  so float32 rounding there moves such a point centimetres along its ray
  from step to step.  The
  sum over cameras runs in a fixed order: each of 32 lanes sums the
  cameras c = lane, lane + 32, ... in sequence, then the lanes are added
  in a halving tree (16, 8, 4, 2, 1).

S_corr = sum_p Aagg Wagg^T and b_corr = sum_p Aagg bp stay torch products
(plain contractions that airdos_tpu also leaves to XLA).

On CUDA tensors each launches its entry point of ``csrc/ba_points.cu`` on
the calling thread's current stream (built with nvcc at first use into
``airdos_tpu_torch/_build/``, bound through ctypes) or raises, and counts
the launch, by thread and stream priority too; on CPU tensors it runs its
plain version (``landmark_reduce_ref``, ``landmark_backsub_ref``), which
spells out each product and sum in the kernel's order, so the two are
bit-equal.  The kernels' division of work is kept below as data (the
launch plan), which the CPU tests emulate.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.cuda_build import check_tensor
from airdos_tpu_torch.solvers.smallmat import inv3x3

# ------------------------------------------------------------ launch plan
# csrc/ba_points.cu's constants (tests/test_torch_kernel_plans.py holds
# them equal).  Reduce: a block takes ROWS_A_BLOCK consecutive rows of
# Wagg's P 6 C rows (3 floats each), a thread ROWS_A_THREAD of them; the
# block's first threads invert, once each, the points its rows touch (at
# most MAX_BLOCK_POINTS, at C = 1).  Back-substitution: a block takes
# BACKSUB_WARPS points, a warp a point, in passes of LANES cameras, lane j
# camera LANES i + j of pass i.
REDUCE_THREADS = 256
ROWS_A_THREAD = 4
ROWS_A_BLOCK = REDUCE_THREADS * ROWS_A_THREAD
MAX_BLOCK_POINTS = (ROWS_A_BLOCK - 1) // 6 + 2
BACKSUB_WARPS = 8
LANES = 32                       # the back-substitution's camera lanes


def reduce_blocks(P: int, C: int) -> int:
    """The reduce launch's grid."""
    return -(-P * 6 * C // ROWS_A_BLOCK)


def reduce_thread_rows(block, thread, P: int, C: int):
    """(first row, rows) of reduce thread `thread` of block `block`: up to
    ROWS_A_THREAD rows from the first, none past the last (numpy arrays
    broadcast)."""
    first = block * ROWS_A_BLOCK + thread * ROWS_A_THREAD
    return first, np.clip(P * 6 * C - first, 0, ROWS_A_THREAD)


def reduce_row_points(first, C: int):
    """The points of rows first, first + 1, ... first + ROWS_A_THREAD - 1
    as a thread finds them: one division, then a step to the next point
    where a row passes its point's 6 C rows (at most once, 6 C >= 6 >
    ROWS_A_THREAD - 1)."""
    p0 = first // (6 * C)
    k0 = first - p0 * 6 * C
    return [p0 + (k0 + i >= 6 * C) for i in range(ROWS_A_THREAD)]


def reduce_block_points(block, P: int, C: int):
    """(first point, points) whose inverses block `block` computes: those
    of its rows."""
    lo = block * ROWS_A_BLOCK
    hi = np.minimum(P * 6 * C, lo + ROWS_A_BLOCK)
    first = lo // (6 * C)
    return first, (hi - 1) // (6 * C) - first + 1


def hinv_block(p, C: int):
    """The block that writes point p's Hpp^-1: the one that holds its
    first row (a block writes a point of its range whose first row is not
    before its own first row)."""
    return p * 6 * C // ROWS_A_BLOCK


def backsub_blocks(P: int) -> int:
    """The back-substitution launch's grid."""
    return -(-P // BACKSUB_WARPS)


def backsub_lane_cameras(C: int, lane: int):
    """The cameras lane `lane` of a point's warp sums, pass by pass, in
    order."""
    return [c0 + lane for c0 in range(0, C, LANES) if c0 + lane < C]


# ------------------------------------------------------------ plain version

def landmark_reduce_ref(pt_sums, wagg, point_valid, lam):
    """Plain torch version.  pt_sums [P, 12], wagg [P, C * 18] float32,
    point_valid [P] bool, lam a float32 0-dim tensor -> (Hpp^-1 [P, 3, 3],
    Aagg [P, C, 6, 3])."""
    P = pt_sums.shape[0]
    H = pt_sums[:, :9].reshape(P, 3, 3)
    tr = (H[:, 0, 0] + H[:, 1, 1]) + H[:, 2, 2]
    three = torch.tensor(3.0, dtype=torch.float32, device=H.device)
    damp = lam * torch.clamp(tr / three, min=1e-3)
    eye = torch.eye(3, dtype=torch.bool, device=H.device)
    H = torch.where(eye, (H + damp[:, None, None]) + 1e-6, H)
    f64 = torch.float64
    Hinv = torch.where(point_valid[:, None, None], inv3x3(H.to(f64)),
                       torch.zeros((), dtype=f64, device=H.device))
    W = wagg.to(f64).reshape(P, -1, 6, 3)
    A = (W[..., 0:1] * Hinv[:, None, None, 0, :]
         + W[..., 1:2] * Hinv[:, None, None, 1, :]) \
        + W[..., 2:3] * Hinv[:, None, None, 2, :]
    return Hinv.to(torch.float32), A.to(torch.float32)


def landmark_backsub_ref(hinv, pt_sums, wagg, dx_c, point_valid):
    """Plain torch version.  hinv [P, 3, 3], pt_sums [P, 12], wagg [P, C *
    18], dx_c [C, 6] float32, point_valid [P] bool -> dx_p [P, 3] float32,
    computed in float64 and rounded once."""
    P, C = hinv.shape[0], dx_c.shape[0]
    f64 = torch.float64
    terms = wagg.to(f64).reshape(P, C, 6, 3) * dx_c.to(f64)[None, :, :, None]
    tc = terms[:, :, 0]
    for k in range(1, 6):
        tc = tc + terms[:, :, k]                          # [P, C, 3]
    m = -(-C // LANES)
    tc = torch.cat([tc, tc.new_zeros((P, m * LANES - C, 3))], dim=1)
    tc = tc.reshape(P, m, LANES, 3)
    acc = tc.new_zeros((P, LANES, 3))
    for i in range(m):
        acc = acc + tc[:, i]
    off = LANES // 2
    while off:
        acc = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    r = pt_sums[:, 9:].to(f64) - acc[:, 0]
    hinv = hinv.to(f64)
    dx = (hinv[:, :, 0] * r[:, 0:1] + hinv[:, :, 1] * r[:, 1:2]) \
        + hinv[:, :, 2] * r[:, 2:3]
    return dx.to(torch.float32) * point_valid[:, None].to(torch.float32)


# ------------------------------------------------------------------ kernel

_SOURCE = cuda_build.CSRC / "ba_points.cu"
_SIGNATURES = {
    "airdos_landmark_reduce": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 3,
    "airdos_landmark_backsub": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2,
}
_lib = None                      # the loaded library, once built

_reduce_counter = cuda_build.LaunchCounter()
_backsub_counter = cuda_build.LaunchCounter()


def reduce_launches() -> int:
    """landmark_reduce launches since the last reset_launches()."""
    return _reduce_counter.total


def backsub_launches() -> int:
    """landmark_backsub launches since the last reset_launches()."""
    return _backsub_counter.total


def launch_tally() -> dict:
    """{(entry point, thread name, stream priority): launches} since the
    last reset_launches()."""
    return {**{("landmark_reduce",) + key: n
               for key, n in _reduce_counter.tally().items()},
            **{("landmark_backsub",) + key: n
               for key, n in _backsub_counter.tally().items()}}


def reset_launches() -> None:
    _reduce_counter.reset()
    _backsub_counter.reset()


def build():
    """Compile csrc/ba_points.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = cuda_build.library(_SOURCE, _SIGNATURES)
    return _lib


def _check_common(pt_sums, wagg, point_valid):
    dev = pt_sums.device
    if not pt_sums.is_cuda:
        raise ValueError(f"pt_sums must be a CUDA tensor, got {dev}")
    P = pt_sums.shape[0]
    check_tensor("pt_sums", pt_sums, torch.float32, (P, 12), dev)
    check_tensor("wagg", wagg, torch.float32, (P, None), dev)
    check_tensor("point_valid", point_valid, torch.bool, (P,), dev)
    if wagg.shape[1] % 18 or P * wagg.shape[1] >= 2 ** 31:
        raise ValueError(f"wagg [{P}, {wagg.shape[1]}] is not [P, C * 18] "
                         f"within the kernel's indexing")
    return dev, P, wagg.shape[1] // 18


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x (contiguous), or a copy of it where it does not start on 16
    bytes: the kernels read Wagg 16 bytes (reduce) and 8 bytes (a
    back-substitution camera) at a time."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def landmark_reduce_cuda(pt_sums, wagg, point_valid, lam):
    """Launch the reduce entry point on the current stream:
    landmark_reduce_ref's (Hpp^-1, Aagg)."""
    dev, P, C = _check_common(pt_sums, wagg, point_valid)
    check_tensor("lam", lam, torch.float32, (), dev)
    wagg = aligned(wagg)
    hinv = torch.empty((P, 3, 3), dtype=torch.float32, device=dev)
    aagg = torch.empty((P, C, 6, 3), dtype=torch.float32, device=dev)
    with cuda_build.on_device(dev):
        err = _library().airdos_landmark_reduce(
            pt_sums.data_ptr(), wagg.data_ptr(), point_valid.data_ptr(),
            lam.data_ptr(), P, C, hinv.data_ptr(), aagg.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"landmark_reduce kernel launch failed: "
                           f"cudaError {err}")
    _reduce_counter.count(cuda_build.stream_priority(dev))
    return hinv, aagg


def landmark_backsub_cuda(hinv, pt_sums, wagg, dx_c, point_valid):
    """Launch the back-substitution entry point on the current stream:
    landmark_backsub_ref's dx_p."""
    dev, P, C = _check_common(pt_sums, wagg, point_valid)
    check_tensor("hinv", hinv, torch.float32, (P, 3, 3), dev)
    check_tensor("dx_c", dx_c, torch.float32, (C, 6), dev)
    wagg = aligned(wagg)
    dx_p = torch.empty((P, 3), dtype=torch.float32, device=dev)
    with cuda_build.on_device(dev):
        err = _library().airdos_landmark_backsub(
            hinv.data_ptr(), pt_sums.data_ptr(), wagg.data_ptr(),
            dx_c.data_ptr(), point_valid.data_ptr(), P, C, dx_p.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"landmark_backsub kernel launch failed: "
                           f"cudaError {err}")
    _backsub_counter.count(cuda_build.stream_priority(dev))
    return dx_p


def landmark_reduce(pt_sums, wagg, point_valid, lam):
    """(Hpp^-1 [P, 3, 3], Aagg [P, C, 6, 3]) of the point sums pt_sums [P,
    12] and the coupling sums wagg [P, C * 18] at damping lam (a float32
    0-dim tensor).  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    if pt_sums.is_cuda:
        return landmark_reduce_cuda(pt_sums, wagg, point_valid, lam)
    return landmark_reduce_ref(pt_sums, wagg, point_valid, lam)


def landmark_backsub(hinv, pt_sums, wagg, dx_c, point_valid):
    """The points' step dx_p [P, 3] for the cameras' step dx_c [C, 6]."""
    if pt_sums.is_cuda:
        return landmark_backsub_cuda(hinv, pt_sums, wagg, dx_c, point_valid)
    return landmark_backsub_ref(hinv, pt_sums, wagg, dx_c, point_valid)
