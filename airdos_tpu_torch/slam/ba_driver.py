"""Host-side drivers: assemble device problems from the map and write back.

Rebuild of airdos_tpu/slam/ba_driver.py's static mapping drivers:

- StaticLocalBA: LocalBundleAdjustment protocol (reference
  Optimizer.cc:431-731) — local covisible KFs + their points + fixed
  observers, outlier-observation erasure on write-back.
- Triangulator: CreateNewMapPoints across the best covisible neighbours
  (LocalMapping.cc:221-466), all neighbours in one batched device call.
- Fuser: SearchInNeighbors both directions (LocalMapping.cc:468-548) in
  one batched device call.

Each driver assembles its problem on the host, runs it on the device with
no host read inside, and copies its result back once.  ``map_lock`` guards
assembly and write-back (None offline).  The human-trajectory BA and the
global BA are not ported yet (ROADMAP port queue: human layer;
relocalization and loop closing).

Problems keep airdos_tpu's padded sizes (the sticky power-of-two buckets
below).  Eager torch compiles nothing, so the buckets no longer save
compiles; they keep the port's padded shapes equal to airdos_tpu's, which
the parity tests compare shape for shape.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import List

import numpy as np
import torch

from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.convert import desc_to_tensor, to_device
from airdos_tpu_torch.matching.epipolar import triangulate_pair
from airdos_tpu_torch.matching.fuse import fuse_candidates
from airdos_tpu_torch.slam.map import KeyFrame, SlamMap
from airdos_tpu_torch.solvers.local_ba import local_bundle_adjust
from airdos_tpu_torch.utils.obs import span


def collect_window_points(m: SlamMap, local_ids, cap: int) -> np.ndarray:
    """Unique live map points observed by the given KFs — one vectorized
    pass over the KFs' feature->point tables (the reference walks
    mvpMapPoints per KF, Optimizer.cc:466-480)."""
    pt = m.points
    cols = [m.kfs[kid].mp_idx for kid in local_ids]
    if not cols:
        return np.empty(0, np.int64)
    pids = np.concatenate(cols)
    pids = np.unique(pids[pids >= 0])
    pids = pids[~pt.bad[pids]]
    return pids[:cap].astype(np.int64)


def point_slot_lookup(m: SlamMap, point_ids: np.ndarray) -> np.ndarray:
    """Dense point-id -> problem-slot table (-1 = not in the problem)."""
    sel = np.full(m.points.pos.shape[0], -1, np.int32)
    sel[point_ids] = np.arange(len(point_ids), dtype=np.int32)
    return sel


def find_fixed_observers(m: SlamMap, local_set, sel: np.ndarray,
                         max_fixed: int, tag: str) -> List[int]:
    """ALL keyframes outside the window that observe a window point anchor
    the problem (reference Optimizer.cc:506-527 lFixedCameras has no cap).
    Vectorized membership check per KF via the slot table."""
    fixed_ids: List[int] = []
    for kid in sorted(m.kfs):
        k = m.kfs[kid]
        if kid in local_set or k.bad:
            continue
        mp = k.mp_idx
        hit = mp[mp >= 0]
        if hit.size and (sel[hit] >= 0).any():
            fixed_ids.append(kid)
    if len(fixed_ids) > max_fixed:
        warnings.warn(f"{tag}: {len(fixed_ids)} fixed observers, "
                      f"keeping {max_fixed}")
        fixed_ids = fixed_ids[:max_fixed]
    return fixed_ids


def assemble_edges(m: SlamMap, cam_ids, sel: np.ndarray,
                   inv_sigma2: np.ndarray):
    """Stereo-projection edge table for (cam in cam_ids, point in slot
    table): one vectorized gather per camera over its feature->point
    table.  Returns unpadded columns plus the (point_id, kf_id, feat_id)
    reference columns used for outlier-observation write-back."""
    bc, bp, bo, bi = [], [], [], []
    rp, rk, rf = [], [], []
    for ci, kid in enumerate(cam_ids):
        k = m.kfs[kid]
        fid = np.nonzero(k.mp_idx >= 0)[0]
        pid = k.mp_idx[fid]
        li = sel[pid]
        keep = li >= 0
        fid, pid, li = fid[keep], pid[keep], li[keep]
        if not fid.size:
            continue
        bc.append(np.full(len(fid), ci, np.int32))
        bp.append(li.astype(np.int32))
        bo.append(np.stack([k.xy_un[fid, 0], k.xy_un[fid, 1],
                            k.u_right[fid]], axis=1).astype(np.float32))
        bi.append(inv_sigma2[k.octave[fid]])
        rp.append(pid.astype(np.int64))
        rk.append(np.full(len(fid), kid, np.int64))
        rf.append(fid.astype(np.int64))
    if not bc:
        z = np.empty(0, np.int64)
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty((0, 3), np.float32), np.empty(0, np.float32),
                z, z, z)
    return (np.concatenate(bc), np.concatenate(bp), np.concatenate(bo),
            np.concatenate(bi).astype(np.float32),
            np.concatenate(rp), np.concatenate(rk), np.concatenate(rf))


def pad_edge_table(e_cam, e_pt, e_obs, e_info, E: int):
    """Place the unpadded columns into fixed-capacity arrays (invalid rows
    flagged false)."""
    n_e = min(len(e_cam), E)
    c = np.zeros(E, np.int32)
    p = np.zeros(E, np.int32)
    o = np.full((E, 3), -1.0, np.float32)
    w = np.ones(E, np.float32)
    v = np.zeros(E, bool)
    c[:n_e] = e_cam[:n_e]
    p[:n_e] = e_pt[:n_e]
    o[:n_e] = e_obs[:n_e]
    w[:n_e] = e_info[:n_e]
    v[:n_e] = True
    return c, p, o, w, v, n_e


def _steady_start(n_features: int, mult: float, lo: int, cap: int) -> int:
    """Bucket starting size that reaches the steady-state shape of a
    full-budget scene on the first call (local-window populations scale
    with the ORB feature budget)."""
    n = max(lo, int(mult * n_features))
    p2 = 1 << (n - 1).bit_length()
    return int(min(cap, p2))


class _StickyBucket:
    """Grow-only power-of-two padding (see the module docstring)."""

    def __init__(self, lo: int, hi: int):
        self.cur = lo
        self.hi = hi

    def fit(self, n: int) -> int:
        while self.cur < n and self.cur < self.hi:
            self.cur *= 2
        return min(self.cur, self.hi)


def _locked(map_lock):
    return map_lock if map_lock is not None else contextlib.nullcontext()


class StaticLocalBA:
    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 device="cpu", map_lock=None):
        self.config = config
        self.map = slam_map
        self.device = torch.device(device)
        self.profiler = None
        self.map_lock = map_lock
        self.n_solves = 0              # device solves so far
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.inv_sigma2 = (1.0 / extractor.sigma2).astype(np.float32)
        dev = config.device
        self.max_cams = 128         # hard ceiling, reference has none
        self.P = dev.max_local_points
        self.E = dev.max_ba_edges
        # the camera bucket starts at 2x the configured window: mature
        # maps anchor the window with more fixed observers than
        # max_fixed_kfs (the reference takes ALL non-local observers)
        self._cb = _StickyBucket(
            min(2 * (dev.max_local_kfs + dev.max_fixed_kfs), self.max_cams),
            self.max_cams)
        nf = config.orb.n_features
        self._pb = _StickyBucket(_steady_start(nf, 1.5, 1024, self.P), self.P)
        self._eb = _StickyBucket(_steady_start(nf, 6.0, 4096, self.E), self.E)

    def __call__(self, kf: KeyFrame):
        with _locked(self.map_lock):
            problem = self._assemble(kf)
        if problem is None:
            return
        res = self._solve(problem)
        with _locked(self.map_lock):
            self._write_back(problem, res)

    def _assemble(self, kf: KeyFrame):
        m = self.map
        pt = m.points
        local_ids = [kf.id] + [k for k in kf.ordered_covis
                               if not m.kfs[k].bad][: self.config.device.max_local_kfs - 1]
        local_set = set(local_ids)

        point_ids = collect_window_points(m, local_ids, self.P)
        sel = point_slot_lookup(m, point_ids)
        fixed_ids = find_fixed_observers(
            m, local_set, sel, self.max_cams - len(local_ids),
            "StaticLocalBA")
        fset = set(fixed_ids)

        cam_ids = local_ids + fixed_ids
        cam_index = {kid: i for i, kid in enumerate(cam_ids)}
        n_cam = len(cam_ids)
        if n_cam < 2 or len(point_ids) < 10:
            return

        C = self._cb.fit(n_cam)
        P = self._pb.fit(len(point_ids))
        cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        cam_t = np.zeros((C, 3), np.float32)
        cam_fixed = np.ones(C, bool)
        for kid, i in cam_index.items():
            k = m.kfs[kid]
            cam_R[i] = k.Rcw
            cam_t[i] = k.tcw
            cam_fixed[i] = kid in fset or kid == 0   # KF0 always fixed
        pts = np.zeros((P, 3), np.float32)
        pvalid = np.zeros(P, bool)
        pts[:len(point_ids)] = pt.pos[point_ids]
        pvalid[:len(point_ids)] = True

        ec, ep, eo, ei, ref_p, ref_kf, ref_fid = assemble_edges(
            m, cam_ids, sel, self.inv_sigma2)
        E = self._eb.fit(len(ec))
        e_cam, e_pt, e_obs, e_info, e_valid, n_e = pad_edge_table(
            ec, ep, eo, ei, E)

        return dict(local_ids=local_ids, local_set=local_set,
                    cam_index=cam_index, cam_fixed=cam_fixed,
                    cam_t=cam_t, n_cam=n_cam, point_ids=point_ids,
                    n_e=n_e, ref_p=ref_p, ref_kf=ref_kf,
                    arrays=(cam_R, cam_t, cam_fixed, pts, pvalid,
                            e_cam, e_pt, e_obs, e_info, e_valid))

    def _solve(self, problem):
        """One device solve and ONE copy back to the host: R, t, points
        and the edge inlier flags packed into a single float tensor."""
        arrays = problem["arrays"]
        C, P, E = arrays[0].shape[0], arrays[3].shape[0], arrays[5].shape[0]
        with span(self.profiler, "ba.solve"):
            d = self.device
            res = local_bundle_adjust(
                *(to_device(a, d) for a in arrays),
                self.fx, self.fy, self.cx, self.cy, self.bf)
            flat = torch.cat([res.R.reshape(-1), res.t.reshape(-1),
                              res.points.reshape(-1),
                              res.edge_inlier.to(res.points.dtype)]).cpu()
            self.n_solves += 1
        flat = flat.numpy()
        o1, o2, o3 = 9 * C, 12 * C, 12 * C + 3 * P
        return (flat[:o1].reshape(C, 3, 3), flat[o1:o2].reshape(C, 3),
                flat[o2:o3].reshape(P, 3), flat[o3:o3 + E] > 0.5)

    def _write_back(self, problem, res):
        m = self.map
        pt = m.points
        R_out, t_out, pts_out, inlier = res
        cam_index = problem["cam_index"]
        cam_fixed = problem["cam_fixed"]
        point_ids = problem["point_ids"]
        n_e = problem["n_e"]
        ref_p, ref_kf = problem["ref_p"], problem["ref_kf"]

        with span(self.profiler, "ba.writeback"):
            for kid, i in cam_index.items():
                # a KF culled while the solve was in flight stays where
                # the culler left it (reference: pKF->isBad() recheck)
                k = m.kfs.get(kid)
                if k is not None and not k.bad and not cam_fixed[i]:
                    k.set_pose(R_out[i], t_out[i])
            alive = ~pt.bad[point_ids]
            pt.pos[point_ids[alive]] = pts_out[:len(point_ids)][alive]
            # erase outlier observations (usually a handful)
            for i in np.nonzero(~inlier[:n_e])[0]:
                if not pt.bad[int(ref_p[i])]:
                    m.erase_observation(int(ref_p[i]), int(ref_kf[i]))
            m.update_points_normal_depth(point_ids[alive])


class Triangulator:
    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 local_mapper, device="cpu", map_lock=None):
        self.config = config
        self.map = slam_map
        self.local_mapper = local_mapper
        self.device = torch.device(device)
        self.map_lock = map_lock
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.scale_factors = np.asarray(extractor.scales, np.float32)
        self.sigma2 = extractor.sigma2
        self.log_scale = float(np.log(config.orb.scale_factor))
        self.n_levels = config.orb.n_levels
        self.n_neighbors = 4     # batched in one device call
        self.n_created = 0       # map points created so far

    def baseline_ok(self, kf: KeyFrame, nkf: KeyFrame) -> bool:
        """Stereo short-baseline gate: reject neighbors closer than the
        stereo baseline bf/fx (reference LocalMapping.cc:259-266)."""
        return bool(np.linalg.norm(nkf.Ow - kf.Ow) >= self.bf / self.fx)

    def __call__(self, kf: KeyFrame, n_neighbors: int = None):
        with _locked(self.map_lock):
            problem = self._assemble(kf, n_neighbors)
        if problem is None:
            return 0
        neighbors, args = problem
        res = triangulate_pair(*args)
        # one copy back: valid, idx2 and the points per (neighbour, feature)
        flat = torch.cat([res.valid.to(res.points.dtype)[..., None],
                          res.idx2.to(res.points.dtype)[..., None],
                          res.points], dim=-1).cpu().numpy()
        got = (flat[..., 0] > 0.5, flat[..., 1].astype(np.int64),
               np.ascontiguousarray(flat[..., 2:]))
        with _locked(self.map_lock):
            return self._write_back(kf, neighbors, got)

    def _assemble(self, kf: KeyFrame, n_neighbors: int = None):
        m = self.map
        K = n_neighbors or self.n_neighbors
        neighbors = []
        for nid in kf.best_covisible(10):
            nkf = m.kfs.get(nid)
            if nkf is None or nkf.bad:
                continue
            if not self.baseline_ok(kf, nkf):
                continue
            neighbors.append(nkf)
            if len(neighbors) == K:
                break
        if not neighbors:
            return None
        # pad the batch by repeating the first neighbor (results discarded)
        batch = neighbors + [neighbors[0]] * (K - len(neighbors))
        d = self.device

        def stack(attr, dtype=None):
            return to_device(np.stack([getattr(n, attr) for n in batch]), d,
                             dtype)

        free1 = (kf.mp_idx < 0) & kf.valid
        free2 = np.stack([(n.mp_idx < 0) & n.valid for n in batch])
        args = (
            to_device(kf.xy_un, d), to_device(kf.octave, d, np.int64),
            to_device(kf.u_right, d), to_device(kf.depth, d),
            desc_to_tensor(kf.desc32, d), to_device(free1, d),
            to_device(kf.Rcw, d, np.float32), to_device(kf.tcw, d, np.float32),
            stack("xy_un"), stack("octave", np.int64), stack("u_right"),
            stack("depth"),
            desc_to_tensor(np.stack([n.desc32 for n in batch]), d),
            to_device(free2, d), stack("Rcw", np.float32),
            stack("tcw", np.float32),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            to_device(self.scale_factors, d), to_device(self.sigma2, d),
            self.log_scale, self.n_levels)
        return neighbors, args

    def _write_back(self, kf: KeyFrame, neighbors, got):
        m = self.map
        valid_b, idx2_b, X_b = got
        created_total = 0
        created_pids = []
        if kf.bad:     # culled while the solve was in flight
            return 0
        for b, nkf in enumerate(neighbors):
            if nkf.bad:
                continue
            valid = valid_b[b]
            idx2 = idx2_b[b]
            X = X_b[b]
            f1 = np.nonzero(valid & (kf.mp_idx < 0))[0]
            used2 = set()
            new_f1, new_f2 = [], []
            for fid in f1:
                f2 = int(idx2[fid])
                if f2 in used2 or nkf.mp_idx[f2] >= 0 or kf.mp_idx[fid] >= 0:
                    continue
                used2.add(f2)
                new_f1.append(int(fid))
                new_f2.append(f2)
            if not new_f1:
                continue
            fids = np.asarray(new_f1)
            pids = m.create_points(kf, fids, X[fids])   # one batched alloc
            for pid, f2 in zip(pids, new_f2):
                m.add_observation(int(pid), nkf, f2)
            created_pids.extend(int(p) for p in pids)
            self.local_mapper.recent_points.extend(int(p) for p in pids)
            created_total += len(new_f1)
        m.update_point_descriptors(created_pids)
        m.update_points_normal_depth(created_pids)
        self.n_created += created_total
        return created_total


class Fuser:
    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 device="cpu", map_lock=None):
        self.config = config
        self.map = slam_map
        self.device = torch.device(device)
        self.map_lock = map_lock
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.width, self.height = cam.width, cam.height
        self.scale_factors = np.asarray(extractor.scales, np.float32)
        self.sigma2 = extractor.sigma2
        self.log_scale = float(np.log(config.orb.scale_factor))
        self.n_levels = config.orb.n_levels
        self.P = config.device.max_local_points
        # both fuse directions in one device call: a batch of target
        # keyframes with a shared union candidate table and a per-target
        # valid mask (direction-1 rows see the current KF's points, the
        # direction-2 row sees the neighbours' points)
        self.max_targets = 8
        self._pb = _StickyBucket(
            _steady_start(config.orb.n_features, 1.5, 1024, self.P), self.P)

    def _assemble_neighborhood(self, kf: KeyFrame, targets: List[KeyFrame]):
        m = self.map
        pt = m.points
        kfp = kf.mp_idx[kf.mp_idx >= 0]
        kf_points = np.unique(kfp)
        if targets:
            allp = np.concatenate([t.mp_idx for t in targets])
            nb_points = np.unique(allp[allp >= 0])
        else:
            nb_points = np.empty(0, kf_points.dtype)
        union = np.union1d(kf_points, nb_points)
        union = union[~pt.bad[union]][: self.P]
        if union.size == 0 or not targets:
            return None
        n = len(union)
        P = self._pb.fit(n)
        ids = union
        xw = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        normal = np.zeros((P, 3), np.float32)
        mind = np.zeros(P, np.float32)
        maxd = np.zeros(P, np.float32)
        xw[:n] = pt.pos[ids]
        desc[:n] = pt.desc32[ids]
        normal[:n] = pt.normal[ids]
        mind[:n] = pt.min_dist[ids]
        maxd[:n] = pt.max_dist[ids]

        # pad the target batch to a fixed size; row B is the current KF
        # (direction 2); padded rows get valid=False candidates AND features
        B = self.max_targets
        n_t = len(targets)
        rows_kf = targets + [targets[0]] * (B - n_t) + [kf]
        in_kf = np.isin(union, kf_points, assume_unique=True)
        in_nb = np.isin(union, nb_points, assume_unique=True)
        valid = np.zeros((B + 1, P), bool)
        valid[:n_t, :n] = in_kf[None, :]
        valid[B, :n] = in_nb
        d = self.device

        def stack(fn, zero_pad=False, dtype=None):
            rows = [fn(t) for t in rows_kf]
            if zero_pad:
                for b in range(n_t, B):
                    rows[b] = np.zeros_like(rows[b])
            return to_device(np.stack(rows), d, dtype)

        args = (
            to_device(xw, d), desc_to_tensor(desc, d), to_device(valid, d),
            to_device(normal, d), to_device(maxd, d), to_device(mind, d),
            stack(lambda t: t.Rcw, dtype=np.float32),
            stack(lambda t: t.tcw, dtype=np.float32),
            stack(lambda t: t.Ow, dtype=np.float32),
            stack(lambda t: t.xy_un), stack(lambda t: t.u_right),
            stack(lambda t: t.octave, dtype=np.int64),
            desc_to_tensor(np.stack([t.desc32 for t in rows_kf]), d),
            stack(lambda t: t.valid, zero_pad=True),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            self.width, self.height,
            to_device(self.scale_factors, d), to_device(self.sigma2, d),
            self.log_scale, self.n_levels, 3.0)
        return ids, n, args

    def _write_back_neighborhood(self, kf: KeyFrame, targets, ids, n,
                                 feat_idx_b):
        m = self.map
        pt = m.points
        B = self.max_targets
        touched = []
        for b, target in list(enumerate(targets)) + [(B, kf)]:
            if target.bad:     # culled while the solve was in flight
                continue
            feat_idx = feat_idx_b[b]
            for i in np.nonzero(feat_idx[:n] >= 0)[0]:
                fid = int(feat_idx[i])
                pid = int(ids[i])
                if pt.bad[pid] or target.id in pt.obs[pid]:
                    continue
                existing = int(target.mp_idx[fid])
                if existing >= 0 and not pt.bad[existing]:
                    if pt.n_obs[existing] > pt.n_obs[pid]:
                        m.replace_point(pid, existing)
                        touched.append(existing)
                    else:
                        m.replace_point(existing, pid)
                        touched.append(pid)
                else:
                    m.add_observation(pid, target, fid)
                    touched.append(pid)
        m.update_point_descriptors(touched)
        m.update_points_normal_depth(touched)

    def __call__(self, kf: KeyFrame, n_neighbors: int = 10):
        m = self.map
        with _locked(self.map_lock):
            targets = []
            for nid in kf.best_covisible(n_neighbors):
                nkf = m.kfs.get(nid)
                if nkf is None or nkf.bad:
                    continue
                targets.append(nkf)
                for nid2 in nkf.best_covisible(5):
                    n2 = m.kfs.get(nid2)
                    if n2 is not None and not n2.bad and n2.id != kf.id \
                            and n2 not in targets:
                        targets.append(n2)
            targets = targets[: self.max_targets]
            # both directions (kf's points into neighbors + neighbors'
            # points into kf) in one device call
            problem = self._assemble_neighborhood(kf, targets)
        if problem is None:
            return
        ids, n, args = problem
        feat_idx_b = fuse_candidates(*args).feat_idx.cpu().numpy()
        with _locked(self.map_lock):
            self._write_back_neighborhood(kf, targets, ids, n, feat_idx_b)
            # refresh (batched: this touches every point of the KF)
            kf_pids = [int(p) for p in kf.mp_idx[kf.mp_idx >= 0]
                       if not m.points.bad[int(p)]]
            m.update_point_descriptors(kf_pids)
            m.update_points_normal_depth(kf_pids)
            m.update_connections(kf)
