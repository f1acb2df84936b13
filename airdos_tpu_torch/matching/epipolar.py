"""Epipolar-constrained matching + two-view triangulation of new map points.

Rebuild of LocalMapping::CreateNewMapPoints (reference
src/LocalMapping.cc:221-466) and ORBmatcher::SearchForTriangulation
(src/ORBmatcher.cc:657-823) as airdos_tpu/matching/epipolar.py computes
it, written for a batch of neighbours: the new keyframe (KF1) against B
neighbour keyframes (KF2) at once, where airdos_tpu vmaps the pair
function.  For each pair, features without a map point are matched under
the epipolar constraint (distance to the epipolar line < 3.84 sigma^2) with
Hamming < TH_LOW over the dense masked N1 x N2 matrix (one batched kernel
launch for all B pairs), then triangulated linearly and validated
(parallax, positive depth in both views, reprojection chi2, scale
consistency).  Stereo depth wins over triangulation at low parallax.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.geometry.se3 import so3_hat
from airdos_tpu_torch.ops.hamming_kernels import hamming_matrix_batched
from airdos_tpu_torch.solvers.smallmat import inv3x3

TH_LOW = 50
BIG = 1 << 10


class TriangulationResult(NamedTuple):
    idx2: torch.Tensor          # [B, N1] matched feature in KF2 (-1 none)
    points: torch.Tensor        # [B, N1, 3] triangulated world points
    valid: torch.Tensor         # [B, N1] bool — passed every check
    from_stereo1: torch.Tensor  # [B, N1] bool — use KF1 stereo depth instead
    from_stereo2: torch.Tensor  # [B, N1] bool


def _gather_rows(x, idx):
    """x [B, N2, ...] gathered at idx [B, N1] along dim 1."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def triangulate_pair(
        # KF1 (the new keyframe), shared by the batch
        xy1, oct1, ur1, depth1, desc1, free1,
        R1, t1,
        # KF2 (the neighbours), each with a leading batch axis [B, ...]
        xy2, oct2, ur2, depth2, desc2, free2,
        R2, t2,
        fx, fy, cx, cy, bf,
        scale_factors, sigma2, log_scale, n_levels) -> TriangulationResult:
    """free*: feature has no associated map point.  Poses are Tcw.
    Octaves are int64 index tensors; n_levels is unused (kept for the
    signature of airdos_tpu)."""
    N1 = xy1.shape[0]
    dt, dev = xy1.dtype, xy1.device

    # ---- epipolar geometry (F12 from relative pose) -------------------
    R12 = R1 @ R2.transpose(-1, -2)                              # [B, 3, 3]
    t12 = t1 - torch.einsum("bij,bj->bi", R12, t2)
    tx = so3_hat(t12)
    Kinv = torch.tensor([[1 / fx, 0, -cx / fx],
                         [0, 1 / fy, -cy / fy],
                         [0, 0, 1]], dtype=dt, device=dev)
    F12 = Kinv.T @ tx @ R12 @ Kinv                               # [B, 3, 3]

    ones1 = torch.ones((N1, 1), dtype=dt, device=dev)
    p1h = torch.cat([xy1, ones1], dim=1)                         # [N1, 3]
    lines = p1h @ F12                                            # [B, N1, 3]
    l0, l1, l2 = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    dist_num = l0 * xy2[:, None, :, 0] + l1 * xy2[:, None, :, 1] + l2
    dist2 = dist_num * dist_num / torch.clamp(l0 ** 2 + l1 ** 2, min=1e-12)
    epi_ok = dist2 < 3.84 * sigma2[oct2][:, None, :]

    # epipole in image 2: project camera-1 centre
    C1 = -R1.T @ t1
    e2c = torch.einsum("bij,j->bi", R2, C1) + t2
    e2z = torch.where(torch.abs(e2c[:, 2]) < 1e-9,
                      torch.full_like(e2c[:, 2], 1e-9), e2c[:, 2])
    ex = fx * e2c[:, 0] / e2z + cx
    ey = fy * e2c[:, 1] / e2z + cy
    # reject matches too close to the epipole (mono only in reference)
    de2 = (xy2[..., 0] - ex[:, None]) ** 2 + (xy2[..., 1] - ey[:, None]) ** 2
    epi_far = de2[:, None, :] > 100.0 * scale_factors[oct2][:, None, :]
    is_stereo2 = ur2 >= 0
    epipole_ok = is_stereo2[:, None, :] | epi_far

    ok = epi_ok & epipole_ok & free1[None, :, None] & free2[:, None, :]
    D = hamming_matrix_batched(desc1[None], desc2)
    D = torch.where(ok, D, torch.full_like(D, BIG))
    idx2 = torch.argmin(D, dim=2)                                # [B, N1]
    dist = torch.gather(D, 2, idx2[..., None])[..., 0]
    has = dist < TH_LOW

    # ---- triangulate ---------------------------------------------------
    x2 = _gather_rows(xy2, idx2)                                 # [B, N1, 2]
    xn1 = torch.stack([(xy1[:, 0] - cx) / fx, (xy1[:, 1] - cy) / fy,
                       torch.ones(N1, dtype=dt, device=dev)], dim=1)
    xn2 = torch.stack([(x2[..., 0] - cx) / fx, (x2[..., 1] - cy) / fy,
                       torch.ones_like(x2[..., 0])], dim=-1)    # [B, N1, 3]
    # parallax between rays (world frame)
    r1 = xn1 @ R1                                                # R1^T xn1
    r2 = xn2 @ R2
    cos_par = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-12)

    # stereo parallax (reference: 2 atan2(b/2, z))
    def cos_stereo_of(depth):
        c = torch.cos(2.0 * torch.atan2(torch.full_like(depth, bf / fx / 2.0),
                                        depth))
        return torch.where(depth > 0, c, torch.full_like(depth, 2.0))

    depth2_i = torch.gather(depth2, 1, idx2)
    cos_s1 = cos_stereo_of(depth1)                               # [N1]
    cos_s2 = cos_stereo_of(depth2_i)                             # [B, N1]
    cos_stereo = torch.minimum(cos_s1, cos_s2)

    # linear triangulation (DLT rows), the 3x3 normal-equation form
    P1 = torch.cat([R1, t1[:, None]], dim=1)                     # [3, 4]
    P2 = torch.cat([R2, t2[..., None]], dim=2)                   # [B, 3, 4]
    A0 = xn1[:, 0:1] * P1[2][None] - P1[0][None]                 # [N1, 4]
    A1 = xn1[:, 1:2] * P1[2][None] - P1[1][None]
    A2 = xn2[..., 0:1] * P2[:, None, 2] - P2[:, None, 0]         # [B, N1, 4]
    A3 = xn2[..., 1:2] * P2[:, None, 2] - P2[:, None, 1]
    A = torch.stack([A0.expand_as(A2), A1.expand_as(A2), A2, A3], dim=2)
    # inhomogeneous least squares with w = 1: (B^T B) X = -B^T c for
    # A = [B | c] (airdos_tpu epipolar.py:109-129: triangulated points are
    # finite by construction; near-zero-parallax systems are gated below)
    Bm = A[..., :3]
    c = A[..., 3]
    M = torch.einsum("bnri,bnrj->bnij", Bm, Bm)
    rhs = -torch.einsum("bnri,bnr->bni", Bm, c)
    tr = M.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Minv = inv3x3(M + (1e-7 * tr + 1e-12) * eye3)
    Xtri = torch.einsum("bnij,bnj->bni", Minv, rhs)

    good_tri = (cos_par > 0) & (cos_par < 0.9998) & (cos_par < cos_stereo)
    use_s1 = (~good_tri) & (cos_s1 < cos_s2) & (depth1 > 0)
    use_s2 = (~good_tri) & (~use_s1) & (depth2_i > 0)
    # stereo unprojections
    X1s = (xn1 * depth1[:, None]) @ R1 - (R1.T @ t1)[None, :]    # [N1, 3]
    X2s = (xn2 * depth2_i[..., None]) @ R2 - \
        torch.einsum("bji,bj->bi", R2, t2)[:, None, :]           # [B, N1, 3]
    X = torch.where(use_s1[..., None], X1s,
                    torch.where(use_s2[..., None], X2s, Xtri))
    usable = good_tri | use_s1 | use_s2

    # ---- validity checks ----------------------------------------------
    def check_view(R, t, xy, octv, ur, X):
        xc = X @ R.transpose(-1, -2) + t.unsqueeze(-2)
        z = xc[..., 2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = fx * xc[..., 0] * iz + cx
        v = fy * xc[..., 1] * iz + cy
        urp = u - bf * iz
        s2 = sigma2[octv]
        eu, ev = u - xy[..., 0], v - xy[..., 1]
        err2 = eu * eu + ev * ev
        has_r = ur >= 0
        er = urp - ur
        chi = torch.where(has_r, (err2 + er * er) / s2, err2 / s2)
        th = torch.where(has_r, 7.8, 5.991)
        return (z > 0) & (chi < th)

    oct2_i = torch.gather(oct2, 1, idx2)
    ok1 = check_view(R1, t1, xy1, oct1, ur1, X)
    ok2 = check_view(R2, t2, x2, oct2_i, torch.gather(ur2, 1, idx2), X)

    # scale consistency
    C1w = -R1.T @ t1
    C2w = -torch.einsum("bji,bj->bi", R2, t2)
    d1 = torch.linalg.norm(X - C1w, dim=-1)
    d2 = torch.linalg.norm(X - C2w[:, None, :], dim=-1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_oct = scale_factors[oct1][None, :] / scale_factors[oct2_i]
    ratio_factor = 1.5 * torch.exp(torch.tensor(log_scale, dtype=dt,
                                                device=dev))
    scale_ok = (ratio_dist * ratio_factor > ratio_oct) & \
        (ratio_dist < ratio_oct * ratio_factor) & (d1 > 1e-6) & (d2 > 1e-6)

    valid = has & usable & ok1 & ok2 & scale_ok
    idx2 = torch.where(valid, idx2, torch.full_like(idx2, -1))
    return TriangulationResult(idx2=idx2, points=X, valid=valid,
                               from_stereo1=use_s1 & valid,
                               from_stereo2=use_s2 & valid)
