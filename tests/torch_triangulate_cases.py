"""Seeded inputs of matching/epipolar.py triangulate_pair, shared by the
CPU tests (tests/test_torch_triangulate_kernels.py) and the card tests
(tests/test_torch_cuda.py); numpy and torch only, no JAX.

``scene(seed, B, N1, N2, same_pose)`` -> triangulate_pair's positional
arguments (CPU tensors): 3-D points in front of a keyframe and B
neighbours at 640 x 360 with 8 octaves, each camera's features the
points it sees plus random ones.  ``composition(*args)`` is
triangulate_pair as it was before its search and triangulation became
kernels (also timed on the card by chip_smoke.py).
"""
import numpy as np
import torch

import airdos_tpu_torch.ops.triangulate_kernels as tk
from airdos_tpu_torch.geometry.se3 import so3_hat
from airdos_tpu_torch.solvers.smallmat import inv3x3

W, H, LEVELS = 640.0, 360.0, 8
FX = FY = 400.0
CX, CY, BF = 320.0, 180.0, 40.0


def _rot(rng, deg):
    """A rotation of a few degrees about a random axis, float64."""
    w = rng.normal(size=3)
    w *= np.deg2rad(deg) / np.linalg.norm(w)
    return torch.linalg.matrix_exp(so3_hat(torch.from_numpy(w))).numpy()


def scene(seed: int, B: int = 3, N1: int = 400, N2: int = 380,
          same_pose: bool = False) -> list:
    """triangulate_pair's positional arguments for a seeded scene: 3-D
    points in front of a keyframe and B neighbours (0.1-0.6 m away, a few
    degrees turned; with same_pose the first neighbour at the keyframe's
    pose), each camera's features the points it sees, 0.5 px of noise,
    octaves mostly low, stereo depth on 70%, the point's descriptor with
    a few bits flipped, padded with random features."""
    rng = np.random.default_rng(seed)
    n_pts = 1500
    Xw = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-2.5, 2.5, n_pts),
                   rng.uniform(3, 20, n_pts)], 1)
    words = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint64)
    scales = (1.2 ** np.arange(LEVELS)).astype(np.float32)

    def camera(R, t, n):
        xc = Xw @ R.T + t
        z = xc[:, 2]
        u = FX * xc[:, 0] / z + CX
        v = FY * xc[:, 1] / z + CY
        seen = np.nonzero((z > 0.5) & (u >= 0) & (u < W) & (v >= 0)
                          & (v < H))[0]
        seen = rng.permutation(seen)[:int(0.8 * n)]
        k = len(seen)
        xy = np.concatenate([np.stack([u[seen], v[seen]], 1)
                             + rng.normal(0, 0.5, (k, 2)),
                             rng.uniform([0, 0], [W, H], (n - k, 2))])
        octave = np.minimum(rng.geometric(0.45, n) - 1, LEVELS - 1)
        stereo = rng.uniform(size=n) < 0.7
        depth = np.where(stereo, np.concatenate(
            [z[seen], rng.uniform(3, 20, n - k)]) * rng.normal(1, 0.01, n),
            -1.0)
        ur = np.where(stereo, xy[:, 0] - BF / np.abs(depth), -1.0)
        desc = np.concatenate([words[seen],
                               rng.integers(0, 2 ** 32, (n - k, 8),
                                            dtype=np.uint64)])
        flip = np.left_shift(np.uint64(1), rng.integers(0, 32, (n, 8))
                             .astype(np.uint64))
        desc = (desc ^ np.where(rng.uniform(size=(n, 8)) < 0.25, flip, 0)) \
            .astype(np.uint32)
        free = rng.uniform(size=n) < 0.85
        return (torch.from_numpy(xy.astype(np.float32)),
                torch.from_numpy(octave.astype(np.int64)),
                torch.from_numpy(ur.astype(np.float32)),
                torch.from_numpy(depth.astype(np.float32)),
                torch.from_numpy(desc.view(np.int32)), torch.from_numpy(free),
                torch.from_numpy(R.astype(np.float32)),
                torch.from_numpy(t.astype(np.float32)))

    R1 = _rot(rng, 3)
    t1 = rng.normal(0, 0.2, 3)
    kf1 = camera(R1, t1, N1)
    nbrs = []
    for b in range(B):
        if same_pose and b == 0:
            R, t = R1, t1
        else:
            R = _rot(rng, 4) @ R1
            C = -R1.T @ t1 + rng.uniform(0.1, 0.6) * \
                np.append(rng.normal(size=2), 0.3 * rng.normal())
            t = -R @ C
        nbrs.append(camera(R, t, N2))
    kf2 = [torch.stack([n[k] for n in nbrs]) for k in range(8)]
    return list(kf1) + kf2 + [FX, FY, CX, CY, BF, torch.from_numpy(scales),
                              torch.from_numpy(scales * scales),
                              float(np.log(1.2)), LEVELS]


def composition(xy1, oct1, ur1, depth1, desc1, free1, R1, t1,
                xy2, oct2, ur2, depth2, desc2, free2, R2, t2,
                fx, fy, cx, cy, bf, scale_factors, sigma2, log_scale,
                n_levels):
    """matching/epipolar.py's triangulate_pair as it was before its search
    became match_rows' epipolar mode and its triangulation a kernel: the
    eager composition around the batched Hamming matrix ->
    (TriangulationResult, the argmin idx2 before the validity mask, its
    distance)."""
    from airdos_tpu_torch.ops.hamming_kernels import hamming_matrix_batched
    N1 = xy1.shape[0]
    dt, dev = xy1.dtype, xy1.device
    R12 = R1 @ R2.transpose(-1, -2)
    t12 = t1 - torch.einsum("bij,bj->bi", R12, t2)
    tx = so3_hat(t12)
    Kinv = torch.tensor([[1 / fx, 0, -cx / fx], [0, 1 / fy, -cy / fy],
                         [0, 0, 1]], dtype=dt, device=dev)
    F12 = Kinv.T @ tx @ R12 @ Kinv
    p1h = torch.cat([xy1, torch.ones((N1, 1), dtype=dt, device=dev)], dim=1)
    lines = p1h @ F12
    l0, l1, l2 = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    dist_num = l0 * xy2[:, None, :, 0] + l1 * xy2[:, None, :, 1] + l2
    dist2 = dist_num * dist_num / torch.clamp(l0 ** 2 + l1 ** 2, min=1e-12)
    epi_ok = dist2 < 3.84 * sigma2[oct2][:, None, :]
    C1 = -R1.T @ t1
    e2c = torch.einsum("bij,j->bi", R2, C1) + t2
    e2z = torch.where(torch.abs(e2c[:, 2]) < 1e-9,
                      torch.full_like(e2c[:, 2], 1e-9), e2c[:, 2])
    ex = fx * e2c[:, 0] / e2z + cx
    ey = fy * e2c[:, 1] / e2z + cy
    de2 = (xy2[..., 0] - ex[:, None]) ** 2 + (xy2[..., 1] - ey[:, None]) ** 2
    epi_far = de2[:, None, :] > 100.0 * scale_factors[oct2][:, None, :]
    epipole_ok = (ur2 >= 0)[:, None, :] | epi_far
    ok = epi_ok & epipole_ok & free1[None, :, None] & free2[:, None, :]
    D = hamming_matrix_batched(desc1[None], desc2)
    D = torch.where(ok, D, torch.full_like(D, 1 << 10))
    idx2 = torch.argmin(D, dim=2)
    dist = torch.gather(D, 2, idx2[..., None])[..., 0]
    return _composition_rows(idx2, dist, xy1, oct1, ur1, depth1, R1, t1,
                             xy2, oct2, ur2, depth2, R2, t2, fx, fy, cx, cy,
                             bf, scale_factors, sigma2, log_scale), idx2, dist


def _gather_rows(x, idx):
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _composition_rows(idx2, dist, xy1, oct1, ur1, depth1, R1, t1, xy2, oct2,
                      ur2, depth2, R2, t2, fx, fy, cx, cy, bf, scale_factors,
                      sigma2, log_scale):
    """The composition's triangulation of the argmin idx2 (its rows after
    the search, as they were)."""
    N1 = xy1.shape[0]
    dt, dev = xy1.dtype, xy1.device
    has = dist < 50
    x2 = _gather_rows(xy2, idx2)
    xn1 = torch.stack([(xy1[:, 0] - cx) / fx, (xy1[:, 1] - cy) / fy,
                       torch.ones(N1, dtype=dt, device=dev)], dim=1)
    xn2 = torch.stack([(x2[..., 0] - cx) / fx, (x2[..., 1] - cy) / fy,
                       torch.ones_like(x2[..., 0])], dim=-1)
    r1 = xn1 @ R1
    r2 = xn2 @ R2
    cos_par = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-12)

    def cos_stereo_of(depth):
        c = torch.cos(2.0 * torch.atan2(torch.full_like(depth, bf / fx / 2.0),
                                        depth))
        return torch.where(depth > 0, c, torch.full_like(depth, 2.0))

    depth2_i = torch.gather(depth2, 1, idx2)
    cos_s1 = cos_stereo_of(depth1)
    cos_s2 = cos_stereo_of(depth2_i)
    cos_stereo = torch.minimum(cos_s1, cos_s2)
    P1 = torch.cat([R1, t1[:, None]], dim=1)
    P2 = torch.cat([R2, t2[..., None]], dim=2)
    A0 = xn1[:, 0:1] * P1[2][None] - P1[0][None]
    A1 = xn1[:, 1:2] * P1[2][None] - P1[1][None]
    A2 = xn2[..., 0:1] * P2[:, None, 2] - P2[:, None, 0]
    A3 = xn2[..., 1:2] * P2[:, None, 2] - P2[:, None, 1]
    A = torch.stack([A0.expand_as(A2), A1.expand_as(A2), A2, A3], dim=2)
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
    X1s = (xn1 * depth1[:, None]) @ R1 - (R1.T @ t1)[None, :]
    X2s = (xn2 * depth2_i[..., None]) @ R2 - \
        torch.einsum("bji,bj->bi", R2, t2)[:, None, :]
    X = torch.where(use_s1[..., None], X1s,
                    torch.where(use_s2[..., None], X2s, Xtri))
    usable = good_tri | use_s1 | use_s2

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
    return tk.TriangulationResult(idx2=idx2, points=X, valid=valid,
                                  from_stereo1=use_s1 & valid,
                                  from_stereo2=use_s2 & valid)
