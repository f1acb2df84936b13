"""Two-view triangulation of matched rows: a CUDA kernel + its plain twin.

After triangulation's epipolar search (match_rows in epipolar mode,
ops/match_kernels.py), each row of the new keyframe (KF1) has a matched
feature ``best`` and its Hamming distance ``dist`` in each of B
neighbour keyframes (KF2).  ``triangulate_rows`` turns them into new map
points, as airdos_tpu/matching/epipolar.py:86-178 does after its argmin:
the rays' parallax, the stereo parallax of either view, the linear
triangulation (the 3x3 normal equations of the DLT rows and their
closed-form inverse), a stereo point where the parallax is too low,
positive depth and reprojection chi-square in both views, and the scale
consistency of the two distances.

- ``triangulate_rows_ref`` is the plain version, written in the order
  the kernel computes it: every sum of three or four terms and every norm
  spelled out left to right (no matmul, einsum or linalg.norm, which
  reorder and fuse), the divisors by fx and fy as tensors (torch divides
  by a CUDA tensor, where it multiplies by the reciprocal of a Python
  scalar).
- ``triangulate_rows`` on CUDA tensors launches ``csrc/triangulate.cu``
  (a thread a row of a target) on the calling thread's current stream
  (built with nvcc at first use into ``airdos_tpu_torch/_build/``, bound
  through ctypes) or raises, and counts the launch, by thread and stream
  priority too; on CPU tensors it runs the plain version.

The kernel's outputs equal the plain version's on the card bit for bit
where the card's atan2f, cosf and expf are torch's (the CUDA source says
why).
"""
from __future__ import annotations

import ctypes
import struct
import threading
from typing import NamedTuple

import numpy as np
import torch

from airdos_tpu_torch.ops import cuda_build

TH_LOW = 50                  # a match's Hamming distance is below this
CHI2_STEREO, CHI2_MONO = 7.8, 5.991
MAX_COS_PARALLAX = 0.9998


class TriangulationResult(NamedTuple):
    idx2: torch.Tensor          # [B, N1] matched feature in KF2 (-1 none)
    points: torch.Tensor        # [B, N1, 3] triangulated world points
    valid: torch.Tensor         # [B, N1] bool — passed every check
    from_stereo1: torch.Tensor  # [B, N1] bool — use KF1 stereo depth instead
    from_stereo2: torch.Tensor  # [B, N1] bool


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def triangulate_rows_ref(best, dist, xy1, oct1, ur1, depth1, R1, t1,
                         xy2, oct2, ur2, depth2, R2, t2, C1w, C2w,
                         fx, fy, cx, cy, bf, scale_factors, sigma2,
                         log_scale) -> TriangulationResult:
    """Plain version.  best, dist [B, N1]: each KF1 row's matched KF2
    feature and its distance (match_rows' epipolar mode); KF1's xy1 [N1,
    2], oct1, ur1, depth1 [N1] and pose R1 [3, 3], t1 [3] (Tcw); the B
    neighbours' xy2 [B, N2, 2], oct2, ur2, depth2 [B, N2], R2 [B, 3, 3],
    t2 [B, 3]; the camera centres C1w = -R1^T t1 [3] and C2w [B, 3]; the
    ORB scale tables [levels].  A row is valid where dist < TH_LOW and
    every check holds; idx2 is best there, else -1."""
    dt, dev = xy1.dtype, xy1.device
    fx_t = torch.tensor(fx, dtype=dt, device=dev)
    fy_t = torch.tensor(fy, dtype=dt, device=dev)

    def r1(i, j):                   # KF1's pose entries: 0-dim
        return R1[i, j]

    def r2(i, j):                   # the neighbours': [B, 1]
        return R2[:, i, j][:, None]

    def t2e(i):
        return t2[:, i][:, None]

    u2 = torch.gather(xy2[..., 0], 1, best)
    v2 = torch.gather(xy2[..., 1], 1, best)
    oct2_i = torch.gather(oct2, 1, best)
    ur2_i = torch.gather(ur2, 1, best)
    depth2_i = torch.gather(depth2, 1, best)
    # normalized rays (the third coordinate 1)
    u1n, v1n = (xy1[:, 0] - cx) / fx_t, (xy1[:, 1] - cy) / fy_t   # [N1]
    u2n, v2n = (u2 - cx) / fx_t, (v2 - cy) / fy_t                 # [B, N1]

    # parallax between the rays in the world frame, R^T xn
    ray1 = [u1n * r1(0, j) + v1n * r1(1, j) + r1(2, j) for j in range(3)]
    ray2 = [u2n * r2(0, j) + v2n * r2(1, j) + r2(2, j) for j in range(3)]
    norm1 = torch.sqrt(_dot3(ray1, ray1))
    norm2 = torch.sqrt(_dot3(ray2, ray2))
    cos_par = _dot3(ray1, ray2) / torch.clamp(norm1 * norm2, min=1e-12)

    # stereo parallax (reference: 2 atan2(b/2, z))
    def cos_stereo_of(depth):
        c = torch.cos(2.0 * torch.atan2(torch.full_like(depth, bf / fx / 2.0),
                                        depth))
        return torch.where(depth > 0, c, torch.full_like(depth, 2.0))

    cos_s1 = cos_stereo_of(depth1)                               # [N1]
    cos_s2 = cos_stereo_of(depth2_i)                             # [B, N1]
    cos_stereo = torch.minimum(cos_s1, cos_s2)

    # the DLT rows x P[2] - P[0], y P[2] - P[1] of P = [R | t], A = [Bm | c]
    p1 = [[r1(i, k) for k in range(3)] + [t1[i]] for i in range(3)]
    p2 = [[r2(i, k) for k in range(3)] + [t2e(i)] for i in range(3)]
    A = [[u1n * p1[2][k] - p1[0][k] for k in range(4)],
         [v1n * p1[2][k] - p1[1][k] for k in range(4)],
         [u2n * p2[2][k] - p2[0][k] for k in range(4)],
         [v2n * p2[2][k] - p2[1][k] for k in range(4)]]

    def col_sum(i, j):              # sum over the rows r of A_ri A_rj
        return A[0][i] * A[0][j] + A[1][i] * A[1][j] + \
            A[2][i] * A[2][j] + A[3][i] * A[3][j]

    # the normal equations (Bm^T Bm) X = -Bm^T c, damped on the diagonal
    # (airdos_tpu epipolar.py:109-129); M symmetric, so M[j][i] = M[i][j]
    M = [[col_sum(i, j) for j in range(3)] for i in range(3)]
    rhs = [-col_sum(i, 3) for i in range(3)]
    damp = 1e-7 * (M[0][0] + M[1][1] + M[2][2]) + 1e-12
    a, b, c = M[0][0] + damp, M[0][1], M[0][2]
    d, e, f = M[1][0], M[1][1] + damp, M[1][2]
    g, h, i = M[2][0], M[2][1], M[2][2] + damp
    # the closed-form inverse of solvers/smallmat.py inv3x3
    cA = e * i - f * h
    cB = -(d * i - f * g)
    cC = d * h - e * g
    cD = -(b * i - c * h)
    cE = a * i - c * g
    cF = -(a * h - b * g)
    cG = b * f - c * e
    cH = -(a * f - c * d)
    cI = a * e - b * d
    inv_det = 1.0 / (a * cA + b * cB + c * cC)
    adj = [[cA, cD, cG], [cB, cE, cH], [cC, cF, cI]]
    Xtri = [(adj[r][0] * inv_det) * rhs[0] + (adj[r][1] * inv_det) * rhs[1]
            + (adj[r][2] * inv_det) * rhs[2] for r in range(3)]

    good_tri = (cos_par > 0) & (cos_par < MAX_COS_PARALLAX) & \
        (cos_par < cos_stereo)
    use_s1 = (~good_tri) & (cos_s1 < cos_s2) & (depth1 > 0)
    use_s2 = (~good_tri) & (~use_s1) & (depth2_i > 0)
    # stereo unprojections R^T (xn depth) + C
    X1s = [(u1n * depth1) * r1(0, j) + (v1n * depth1) * r1(1, j)
           + depth1 * r1(2, j) + C1w[j] for j in range(3)]
    X2s = [(u2n * depth2_i) * r2(0, j) + (v2n * depth2_i) * r2(1, j)
           + depth2_i * r2(2, j) + C2w[:, j][:, None] for j in range(3)]
    X = [torch.where(use_s1, X1s[j], torch.where(use_s2, X2s[j], Xtri[j]))
         for j in range(3)]
    usable = good_tri | use_s1 | use_s2

    # ---- validity checks ----------------------------------------------
    def check_view(R, t, u_obs, v_obs, octv, ur):
        xc = [X[0] * R(k, 0) + X[1] * R(k, 1) + X[2] * R(k, 2) + t(k)
              for k in range(3)]
        z = xc[2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-9,
                               torch.full_like(z, 1e-9), z)
        u = fx * xc[0] * iz + cx
        v = fy * xc[1] * iz + cy
        urp = u - bf * iz
        s2 = sigma2[octv]
        eu, ev = u - u_obs, v - v_obs
        err2 = eu * eu + ev * ev
        has_r = ur >= 0
        er = urp - ur
        chi = torch.where(has_r, (err2 + er * er) / s2, err2 / s2)
        return (z > 0) & (chi < torch.where(has_r, CHI2_STEREO, CHI2_MONO))

    ok1 = check_view(r1, lambda k: t1[k], xy1[:, 0], xy1[:, 1], oct1, ur1)
    ok2 = check_view(r2, t2e, u2, v2, oct2_i, ur2_i)

    # scale consistency
    e1 = [X[j] - C1w[j] for j in range(3)]
    e2 = [X[j] - C2w[:, j][:, None] for j in range(3)]
    d1, d2 = torch.sqrt(_dot3(e1, e1)), torch.sqrt(_dot3(e2, e2))
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_oct = scale_factors[oct1][None, :] / scale_factors[oct2_i]
    ratio_factor = 1.5 * torch.exp(torch.tensor(log_scale, dtype=dt,
                                                device=dev))
    scale_ok = (ratio_dist * ratio_factor > ratio_oct) & \
        (ratio_dist < ratio_oct * ratio_factor) & (d1 > 1e-6) & (d2 > 1e-6)

    valid = (dist < TH_LOW) & usable & ok1 & ok2 & scale_ok
    return TriangulationResult(
        idx2=torch.where(valid, best, torch.full_like(best, -1)),
        points=torch.stack(X, dim=-1), valid=valid,
        from_stereo1=use_s1 & valid, from_stereo2=use_s2 & valid)


# ------------------------------------------------------------------ kernel

# csrc/triangulate.cu TriParams: 28 int64 words (counts, pointers) and 8
# float32
_PARAMS = struct.Struct("<28q8f")
_SOURCE = cuda_build.CSRC / "triangulate.cu"
_SIGNATURES = {"airdos_triangulate": [ctypes.c_void_p, ctypes.c_void_p]}
_lib = None                     # the loaded library, once built
_local = threading.local()      # each thread's parameter block

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """triangulate launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("triangulate", thread name, stream priority): launches} since the
    last reset_launches()."""
    return {("triangulate",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/triangulate.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def _check(best, dist, xy1, oct1, ur1, depth1, R1, t1, xy2, oct2, ur2,
           depth2, R2, t2, C1w, C2w, scale_factors, sigma2):
    """Raise unless every input is a contiguous tensor of its dtype and
    shape on best's CUDA device."""
    dev = best.device
    if not best.is_cuda:
        raise ValueError(f"best must be a CUDA tensor, got {dev}")
    if best.dim() != 2 or xy2.dim() != 3:
        raise ValueError(f"best must be [B, N1] and xy2 [B, N2, 2], got "
                         f"{tuple(best.shape)} and {tuple(xy2.shape)}")
    B, N1 = best.shape
    N2 = xy2.shape[1]
    f32, i64 = torch.float32, torch.int64
    L = scale_factors.shape[0] if scale_factors.dim() == 1 else None
    for name, x, dtype, shape in (
            ("best", best, i64, (B, N1)), ("dist", dist, torch.int32, (B, N1)),
            ("xy1", xy1, f32, (N1, 2)), ("oct1", oct1, i64, (N1,)),
            ("ur1", ur1, f32, (N1,)), ("depth1", depth1, f32, (N1,)),
            ("R1", R1, f32, (3, 3)), ("t1", t1, f32, (3,)),
            ("xy2", xy2, f32, (B, N2, 2)), ("oct2", oct2, i64, (B, N2)),
            ("ur2", ur2, f32, (B, N2)), ("depth2", depth2, f32, (B, N2)),
            ("R2", R2, f32, (B, 3, 3)), ("t2", t2, f32, (B, 3)),
            ("C1w", C1w, f32, (3,)), ("C2w", C2w, f32, (B, 3)),
            ("scale_factors", scale_factors, f32, (L,)),
            ("sigma2", sigma2, f32, (L,))):
        cuda_build.check_tensor(name, x, dtype, shape, dev)
    if N2 == 0 or not L:
        raise ValueError(f"{N2} neighbour features, {L} levels: the kernel "
                         f"gathers at best")


def triangulate_rows_cuda(best, dist, xy1, oct1, ur1, depth1, R1, t1,
                          xy2, oct2, ur2, depth2, R2, t2, C1w, C2w,
                          fx, fy, cx, cy, bf, scale_factors, sigma2,
                          log_scale) -> TriangulationResult:
    """Launch the kernel on the current stream: one launch."""
    global _lib
    _check(best, dist, xy1, oct1, ur1, depth1, R1, t1, xy2, oct2, ur2,
           depth2, R2, t2, C1w, C2w, scale_factors, sigma2)
    dev = best.device
    B, N1 = best.shape
    BN = B * N1
    # one allocation: int64 idx2 [BN], float32 points [BN, 3], bool
    # valid, from_stereo1, from_stereo2 [BN] each
    buf = torch.empty(8 * BN + 12 * BN + 3 * BN, dtype=torch.uint8,
                      device=dev)
    b64, b32, b8 = buf.split((8 * BN, 12 * BN, 3 * BN))
    idx2, points = b64.view(torch.int64), b32.view(torch.float32)
    flags = b8.view(torch.bool)
    base = buf.data_ptr()
    words = _local.__dict__.get("params")
    if words is None:
        block = ctypes.create_string_buffer(_PARAMS.size)
        words = _local.params = (block, ctypes.addressof(block))
    _PARAMS.pack_into(
        words[0], 0, B, N1, xy2.shape[1], scale_factors.shape[0], TH_LOW,
        best.data_ptr(), dist.data_ptr(), xy1.data_ptr(), oct1.data_ptr(),
        ur1.data_ptr(), depth1.data_ptr(), xy2.data_ptr(), oct2.data_ptr(),
        ur2.data_ptr(), depth2.data_ptr(), R1.data_ptr(), t1.data_ptr(),
        R2.data_ptr(), t2.data_ptr(), C1w.data_ptr(), C2w.data_ptr(),
        scale_factors.data_ptr(), sigma2.data_ptr(),
        base, base + 8 * BN, base + 20 * BN, base + 21 * BN, base + 22 * BN,
        fx, fy, cx, cy, bf, float(np.float32(bf / fx / 2.0)), log_scale, 0.0)
    if BN:
        if _lib is None:
            _lib = cuda_build.library(_SOURCE, _SIGNATURES)
        stream = torch.cuda.current_stream(dev)
        with cuda_build.on_device(dev):
            err = _lib.airdos_triangulate(words[1], stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"triangulate kernel launch failed: "
                               f"cudaError {err}")
        _counter.count(stream.priority)
    valid, s1, s2 = flags.view(3, B, N1)
    return TriangulationResult(idx2=idx2.view(B, N1),
                               points=points.view(B, N1, 3), valid=valid,
                               from_stereo1=s1, from_stereo2=s2)


def triangulate_rows(best, dist, xy1, oct1, ur1, depth1, R1, t1,
                     xy2, oct2, ur2, depth2, R2, t2, C1w, C2w,
                     fx, fy, cx, cy, bf, scale_factors, sigma2,
                     log_scale) -> TriangulationResult:
    """Triangulate each KF1 row with its match in each neighbour: CUDA
    tensors go to the kernel, CPU tensors to the plain version."""
    args = (best, dist, xy1, oct1, ur1, depth1, R1, t1, xy2, oct2, ur2,
            depth2, R2, t2, C1w, C2w, fx, fy, cx, cy, bf, scale_factors,
            sigma2, log_scale)
    if best.is_cuda:
        return triangulate_rows_cuda(*args)
    return triangulate_rows_ref(*args)
