"""Driver entry points: the single-device step and the multi-device dry run.

The counterpart of the repository's ``__graft_entry__.py`` for the port:

- ``entry(device)``: the stereo front end (pyramids, FAST, rBRIEF, stereo
  matching) followed by one pose-LM round, as one function, with example
  arguments on ``device``;
- ``dryrun_multichip(n_devices, device)``: the six sharded calls of
  ``parallel/sharded_ba.py`` on the seeded problems of
  ``__graft_entry__._dryrun_multichip_impl``, with its two checks, on
  ``make_mesh(n_devices, device)``.  airdos_tpu runs its dry run in a
  CPU-forced child process; here the mesh is in-process (cards, or
  virtual ranks where AIRDOS_TORCH_VIRTUAL_DEVICES asks for them; on the
  CPU always virtual).
"""
from __future__ import annotations

import numpy as np
import torch

from airdos_tpu_torch.convert import resolve_device


def entry(device="cuda"):
    """(fn, example_args): fn(imL, imR, maskL, maskR, R0, t0) runs the
    front end of one stereo frame and one pose optimization of the frame's
    stereo points from (R0, t0); it returns the left keypoints, their
    descriptors, the stereo depths, the pose and its inlier count."""
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.synthetic import default_camera
    from airdos_tpu_torch.slam.frame import FrontEnd
    from airdos_tpu_torch.solvers.pose_opt import pose_optimize

    dev = resolve_device(device)
    cfg = SlamConfig()
    cfg.camera = default_camera()
    cfg.orb.n_features = 1000
    cfg.orb.n_levels = 8
    fe = FrontEnd(cfg, dev)
    cam = cfg.camera
    inv_s2 = torch.as_tensor(1.0 / fe.extractor.sigma2, dtype=torch.float32,
                             device=dev)

    def fn(imL, imR, maskL, maskR, R0, t0):
        torso_px = torch.full((40, 2), -1.0, dtype=torch.float32, device=dev)
        fL, _, sm, _, _ = fe._build_impl(imL, imR, maskL, maskR, torso_px,
                                         with_disparity=False)
        has_depth = sm.depth > 0
        xw = torch.stack([(fL.xy[:, 0] - cam.cx) * sm.depth / cam.fx,
                          (fL.xy[:, 1] - cam.cy) * sm.depth / cam.fy,
                          sm.depth], dim=1)
        xw = torch.where(has_depth[:, None], xw, torch.zeros_like(xw))
        obs = torch.cat([fL.xy, sm.u_right[:, None]], dim=1)
        res = pose_optimize(R0, t0, xw, obs, inv_s2[fL.octave.long()],
                            fL.valid & has_depth,
                            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        return fL.xy, fL.desc32, sm.depth, res.R, res.t, res.n_inliers

    h, w = cam.height, cam.width
    rng = np.random.default_rng(0)
    imL = np.asarray(rng.uniform(0, 255, (h, w)), np.float32)
    imR = np.roll(imL, -7, axis=1)
    ones = np.ones((h, w), np.float32)
    example_args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in (imL, imR, ones, ones,
                                   np.eye(3, dtype=np.float32),
                                   np.zeros(3, np.float32)))
    return fn, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The full sharded protocol over an n_devices mesh: the pose step,
    local BA, EPnP RANSAC, global BA, Sim3 RANSAC and human BA with their
    edge tables or hypotheses sharded, the normal equations psum-reduced
    and the states updated replicated.  Raises on a failed check."""
    from airdos_tpu_torch.parallel.sharded_ba import (
        make_mesh, sharded_epnp_ransac, sharded_global_bundle_adjust,
        sharded_human_bundle_adjust, sharded_local_bundle_adjust,
        sharded_pose_optimize_step, sharded_sim3_ransac)

    dev = resolve_device(device)
    mesh = make_mesh(n_devices, dev)
    dev = mesh.devices[0]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(0)
    fx = fy = 320.0
    cx, cy = 160.0, 120.0
    bf = 80.0
    eye3 = torch.eye(3, device=dev)

    # ---- pose-only step, edges sharded -------------------------------
    E = 64 * n_devices
    xw = rng.uniform([-2, -2, 3], [2, 2, 12], (E, 3)).astype(np.float32)
    u = fx * xw[:, 0] / xw[:, 2] + cx
    v = fy * xw[:, 1] / xw[:, 2] + cy
    obs = np.stack([u, v, u - bf / xw[:, 2]], axis=1).astype(np.float32)
    w = np.ones(E, np.float32)
    R, tt = sharded_pose_optimize_step(mesh)(
        eye3, torch.zeros(3, device=dev), t(xw), t(obs), t(w),
        fx, fy, cx, cy, bf)
    R.cpu(), tt.cpu()

    # ---- the full local-BA LM protocol, edges sharded ----------------
    C = 4
    P_pts = 32
    pts = rng.uniform([-2, -2, 3], [2, 2, 12], (P_pts, 3)).astype(np.float32)
    e_cam = np.tile(np.arange(C, dtype=np.int32), E // C)[:E]
    e_pt = rng.integers(0, P_pts, E).astype(np.int32)
    cam_t = np.stack([np.array([0.1 * c, 0, 0], np.float32) for c in range(C)])
    xc = pts[e_pt] + cam_t[e_cam]
    u = fx * xc[:, 0] / xc[:, 2] + cx
    v = fy * xc[:, 1] / xc[:, 2] + cy
    e_obs = np.stack([u, v, u - bf / xc[:, 2]], axis=1).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    ba_args = (eye3.repeat(C, 1, 1), t(cam_t), t(fixed), t(pts),
               torch.ones(P_pts, dtype=torch.bool, device=dev),
               t(e_cam), t(e_pt), t(e_obs), t(w),
               torch.ones(E, dtype=torch.bool, device=dev), fx, fy, cx, cy,
               bf)
    res = sharded_local_bundle_adjust(mesh, iters1=2, iters2=2)(*ba_args)
    res.R.cpu(), res.t.cpu(), res.points.cpu()

    # ---- hypothesis-parallel EPnP RANSAC -----------------------------
    n_pts = 48
    pw = rng.uniform([-2, -2, 3], [2, 2, 12], (n_pts, 3)).astype(np.float32)
    uvp = np.stack([fx * pw[:, 0] / pw[:, 2] + cx,
                    fy * pw[:, 1] / pw[:, 2] + cy], axis=1).astype(np.float32)
    samples = rng.integers(0, n_pts, (16 * n_devices, 4)).astype(np.int32)
    pres = sharded_epnp_ransac(mesh)(
        t(pw), t(uvp), torch.ones(n_pts, dtype=torch.bool, device=dev),
        torch.full((n_pts,), 5.991, device=dev), t(samples), fx, fy, cx, cy)
    if int(pres.n_inliers) < n_pts - 2:
        raise RuntimeError(f"sharded EPnP: {int(pres.n_inliers)} inliers "
                           f"of {n_pts}")

    # ---- map-scale global BA (matrix-free Schur + PCG), edges sharded --
    gres = sharded_global_bundle_adjust(mesh, iters1=1, iters2=1,
                                        cg_iters=8)(*ba_args)
    gres.R.cpu(), gres.points.cpu()

    # ---- hypothesis-parallel Sim3 RANSAC (loop ComputeSim3) ----------
    n_s = 40
    x2s = rng.uniform([-3, -2, 4], [3, 2, 15], (n_s, 3)).astype(np.float32)
    x1s = (x2s + np.array([0.4, -0.1, 0.2], np.float32)).astype(np.float32)
    s_samples = rng.integers(0, n_s, (16 * n_devices, 3)).astype(np.int32)
    gate = torch.full((n_s,), 9.21 * 4, device=dev)
    sres = sharded_sim3_ransac(mesh)(
        t(x1s), t(x2s), torch.ones(n_s, dtype=torch.bool, device=dev),
        t(s_samples), gate, gate, fx, fy, cx, cy)
    if int(sres.n_inliers) < n_s - 2:
        raise RuntimeError(f"sharded Sim3: {int(sres.n_inliers)} inliers "
                           f"of {n_s}")

    # ---- dynamic human-trajectory BA, static edges sharded -----------
    T, L, NJ = 1, 4, 14
    ones = np.ones((T, L, NJ), bool)
    joints = np.tile(pts[:NJ][None, None], (T, L, 1, 1)).astype(np.float32)
    jo_cam = np.zeros((T, L), np.int32)
    xj = joints[0, 0] + cam_t[0]
    jo_obs = np.tile(np.stack(
        [fx * xj[:, 0] / xj[:, 2] + cx, fy * xj[:, 1] / xj[:, 2] + cy,
         fx * xj[:, 0] / xj[:, 2] + cx - bf / xj[:, 2]],
        axis=1)[None, None], (T, L, 1, 1)).astype(np.float32)
    hres = sharded_human_bundle_adjust(mesh, iters1=1, iters2=1)(
        *ba_args[:10], t(joints), t(ones), t(jo_cam), t(jo_obs), t(ones),
        torch.ones((T, NJ), device=dev),
        torch.ones((T, NJ), dtype=torch.bool, device=dev), t(ones),
        eye3.repeat(T, 1, 1), torch.zeros((T, 3), device=dev),
        torch.ones(T, dtype=torch.bool, device=dev),
        torch.ones((T, L), device=dev),
        torch.ones((T, L, 5), dtype=torch.bool, device=dev),
        1.0, 0.5, 20.0, 20.0, 1.0, 4.0, 1.0, fx, fy, cx, cy, bf)
    hres.joints.cpu(), hres.cam_t.cpu()
