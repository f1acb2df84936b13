"""Host-side drivers: assemble device problems from the map and write back.

Rebuild of airdos_tpu/slam/ba_driver.py's offline mapping drivers:

- StaticLocalBA: LocalBundleAdjustment protocol (reference
  Optimizer.cc:431-731) — local covisible KFs + their points + fixed
  observers, outlier-observation erasure on write-back.
- Triangulator: CreateNewMapPoints across the best covisible neighbours
  (LocalMapping.cc:221-466), all neighbours in one batched device call.
- Fuser: SearchInNeighbors both directions (LocalMapping.cc:468-548) in
  one batched device call.
- HumanLocalBA: LocalBundleAdjustmentHumanTrajactory (Optimizer.cc:1496-
  2224) — the static window plus the long human trajectories it sees,
  with the bIsLost / bIsBad / bOptimized flags written back.  Offline it
  runs synchronously; online ``launch`` runs it in a background thread
  (one solve in flight, a busy tick skipped, an error re-raised at
  ``join``) in airdos_tpu's online schedule of three solver calls
  (``_LM_CHUNKS``).
- GlobalBA: GlobalBundleAdjustemnt after a loop closure (Optimizer.cc:
  52-230, LoopClosing.cc:645-749): every keyframe and every live point,
  in airdos_tpu's schedule of four solver calls of five steps.  Offline
  the loop closer calls it inline; online ``launch`` runs it in a
  background thread that ``interrupt`` aborts between solver calls (the
  reference's mbStopGBA), and keyframes created during the solve get the
  correction through ``propagate_to_children``.

Each driver assembles its problem on the host, runs it on the device with
no host read inside, and copies its result back once.  ``map_lock`` guards
assembly and write-back (None offline).  Online, System installs a
``gate`` (utils/gate.py) that each driver waits on right before its
device work, and the background BAs launch on their own low-priority
CUDA stream (the mapping worker's drivers use the worker's stream).

With Device.NChips > 1 the three BAs run sharded over a mesh of that
many ranks (``parallel/``), as airdos_tpu's drivers do: each driver
builds its mesh once, rounds its edge capacity up to a multiple of the
mesh (padding rows invalid) and calls the ``sharded_*`` solver; the
human BA then solves in one call online too, as airdos_tpu's sharded
path does.  One rank never stands in for a mesh: a missing card raises.

Problems keep airdos_tpu's padded sizes (the sticky power-of-two buckets
below).  Eager torch compiles nothing, so the buckets no longer save
compiles; they keep the port's padded shapes equal to airdos_tpu's, which
the parity tests compare shape for shape.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import warnings
from typing import List

import numpy as np
import torch

from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.convert import desc_to_tensor, to_device
from airdos_tpu_torch.matching.epipolar import triangulate_pair
from airdos_tpu_torch.matching.fuse import fuse_candidates
from airdos_tpu_torch.parallel.sharded_ba import (
    make_mesh, sharded_global_bundle_adjust, sharded_human_bundle_adjust,
    sharded_local_bundle_adjust)
from airdos_tpu_torch.slam.map import (BODY1, BODY2, MAIN_SKELETON, N_PARTS,
                                       TH_LONG_TRAJECTORY, KeyFrame, SlamMap)
from airdos_tpu_torch.solvers.global_ba import global_bundle_adjust
from airdos_tpu_torch.solvers.human_ba import human_bundle_adjust
from airdos_tpu_torch.solvers.local_ba import local_bundle_adjust
from airdos_tpu_torch.utils.gate import (WORKER_PRIORITY, gap_waiter,
                                         gate_wait, new_stream, on_stream)
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


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mesh_of(config: SlamConfig, device):
    """The mesh of Device.NChips ranks the BAs shard over, None for one."""
    n = config.device.n_chips
    return make_mesh(n, device) if n > 1 else None


# Online-mode schedule of the background human BA: the reference protocol's
# 5 Huber + 10 plain iterations (Optimizer.cc:701-704) in three solver
# calls, as airdos_tpu runs it online (its slam/ba_driver.py:155-166).
# Each call re-classifies the inliers against the current state before its
# plain phase, so this is not the single-call protocol; offline keeps the
# single call.  airdos_tpu splits the solve to yield the TPU's one FIFO
# between calls; here the three calls keep its numbers, and the stream
# priorities keep tracking ahead.
_LM_CHUNKS = ((5, 0), (0, 5), (0, 5))


class StaticLocalBA:
    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 device, map_lock=None):
        self.config = config
        self.map = slam_map
        self.device = torch.device(device)
        self.profiler = None
        self.map_lock = map_lock
        self.gate = None               # online: utils/gate.TrackingGate
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
        self.mesh = _mesh_of(config, self.device)
        self._sharded = None if self.mesh is None else \
            sharded_local_bundle_adjust(self.mesh)

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
        if self.mesh is not None:
            E = _round_up(E, self.mesh.size)
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
            gate_wait(self.gate)           # tracking launches first
            res = (self._sharded or local_bundle_adjust)(
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
                 local_mapper, device, map_lock=None):
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
        self.gate = None         # online: utils/gate.TrackingGate

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
        gate_wait(self.gate)     # tracking launches first
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
                 device, map_lock=None):
        self.config = config
        self.map = slam_map
        self.device = torch.device(device)
        self.map_lock = map_lock
        self.profiler = None     # set by System: the write-back's refreshes
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
        self.gate = None         # online: utils/gate.TrackingGate

    # airdos_tpu's Fuser.warmup compiles the single-target program outside
    # the map lock before a loop correction; eager torch compiles nothing,
    # so the port has no warmup.

    def _fuse_into(self, point_ids: List[int], target: KeyFrame,
                   prefer_candidates: bool = False):
        """Fuse map points into one keyframe (the loop-closing path's
        SearchAndFuse, reference LoopClosing.cc:587): one launch of the
        batched fuse with a batch of one target.  prefer_candidates: a
        conflict keeps the candidate point instead of the more-observed
        one.  Online the candidate tables are read and the matches written
        under the map lock, and the device match runs with it released."""
        with _locked(self.map_lock):
            problem = self._fuse_into_tables(point_ids, target)
        if problem is None:
            return
        gate_wait(self.gate)     # tracking launches first
        feat_idx = self._fuse_into_match(target, *problem[1:])
        with _locked(self.map_lock):
            self._fuse_into_apply(target, problem[0], feat_idx,
                                  prefer_candidates)

    def _fuse_into_tables(self, point_ids: List[int], target: KeyFrame):
        """The candidate points not yet seen by target and their padded
        tables, or None."""
        pt = self.map.points
        point_ids = [p for p in point_ids if not pt.bad[p]
                     and target.id not in pt.obs[p]][: self.P]
        if not point_ids:
            return None
        n = len(point_ids)
        P = self._pb.fit(n)
        ids = np.asarray(point_ids)
        xw = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        normal = np.zeros((P, 3), np.float32)
        mind = np.zeros(P, np.float32)
        maxd = np.zeros(P, np.float32)
        valid = np.zeros((1, P), bool)
        xw[:n] = pt.pos[ids]
        desc[:n] = pt.desc32[ids]
        normal[:n] = pt.normal[ids]
        mind[:n] = pt.min_dist[ids]
        maxd[:n] = pt.max_dist[ids]
        valid[0, :n] = True
        pose = (target.Rcw.copy(), target.tcw.copy(), target.Ow.copy())
        return ids, xw, desc, valid, normal, maxd, mind, pose

    def _fuse_into_match(self, target, xw, desc, valid, normal, maxd, mind,
                         pose):
        """The device match of _fuse_into_tables' tables into target."""
        d = self.device

        def one(a, dtype=None):
            return to_device(np.asarray(a)[None], d, dtype)

        Rcw, tcw, Ow = pose
        return fuse_candidates(
            to_device(xw, d), desc_to_tensor(desc, d), to_device(valid, d),
            to_device(normal, d), to_device(maxd, d), to_device(mind, d),
            one(Rcw, np.float32), one(tcw, np.float32),
            one(Ow, np.float32), one(target.xy_un),
            one(target.u_right), one(target.octave, np.int64),
            desc_to_tensor(target.desc32[None], d), one(target.valid),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            self.width, self.height,
            to_device(self.scale_factors, d), to_device(self.sigma2, d),
            self.log_scale, self.n_levels).feat_idx[0].cpu().numpy()

    def _fuse_into_apply(self, target, ids, feat_idx, prefer_candidates):
        """Write the matches: add an observation, or merge with the point
        already there (the candidate, or the more-observed one)."""
        m = self.map
        pt = m.points
        n = len(ids)
        touched = []
        for i in np.nonzero(feat_idx[:n] >= 0)[0]:
            fid = int(feat_idx[i])
            pid = int(ids[i])
            if pt.bad[pid]:
                continue
            existing = int(target.mp_idx[fid])
            if existing >= 0 and not pt.bad[existing]:
                if existing == pid:
                    continue
                if prefer_candidates or pt.n_obs[pid] >= pt.n_obs[existing]:
                    m.replace_point(existing, pid)
                    touched.append(pid)
                else:
                    m.replace_point(pid, existing)
                    touched.append(existing)
            else:
                m.add_observation(pid, target, fid)
                touched.append(pid)
        m.update_point_descriptors(touched)
        m.update_points_normal_depth(touched)

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
        gate_wait(self.gate)     # tracking launches first
        feat_idx_b = fuse_candidates(*args).feat_idx.cpu().numpy()
        with _locked(self.map_lock):
            self._write_back_neighborhood(kf, targets, ids, n, feat_idx_b)
            # refresh (batched: this touches every point of the KF)
            kf_pids = [int(p) for p in kf.mp_idx[kf.mp_idx >= 0]
                       if not m.points.bad[int(p)]]
            with span(self.profiler, "map.descriptors"):
                m.update_point_descriptors(kf_pids)
            with span(self.profiler, "map.normals"):
                m.update_points_normal_depth(kf_pids)
            with span(self.profiler, "map.connections"):
                m.update_connections(kf)


def select_window_trajectories(trajectories, window_ids, max_trajectories):
    """Human trajectories observed in the local window, long enough for BA
    (> TH_LONG_TRAJECTORY poses), most recently observed first, so with
    more than max_trajectories humans the visible tracks win over stale
    ones (reference collects the local KFs' observed trajectories,
    Optimizer.cc:1500-1538)."""
    cands = []
    for traj in trajectories.values():
        if len(traj) <= TH_LONG_TRAJECTORY:
            continue
        window_poses = [hp.kf_id for hp in traj.poses
                        if hp.kf_id in window_ids]
        if window_poses:
            cands.append((max(window_poses), traj))
    cands.sort(key=lambda c: -c[0])
    return [traj for _, traj in cands[:max_trajectories]]


class HumanLocalBA:
    """Driver of the human-trajectory BA: selects the covisibility window
    and the long trajectories whose poses reference its keyframes, runs
    the device solver, and writes back keyframe poses, points, joints,
    limb lengths, motion models and the outlier flags."""

    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 device, map_lock=None):
        self.config = config
        self.map = slam_map
        self.device = torch.device(device)
        self.map_lock = map_lock
        self.profiler = None
        self.n_runs = 0            # completed BA passes (write-back done)
        self.gate = None           # online: utils/gate.TrackingGate
        self._chunked = not config.system.is_offline   # see _LM_CHUNKS
        self._thread = None        # the background solve (online)
        self._error = None         # the exception it raised, for join()
        self._stream = None        # its CUDA stream, made at first launch
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.inv_sigma2 = (1.0 / extractor.sigma2).astype(np.float32)
        dev = config.device
        self.max_cams = 128
        self._cb = _StickyBucket(
            min(2 * (dev.max_local_kfs + dev.max_fixed_kfs), self.max_cams),
            self.max_cams)
        self.P = dev.max_local_points
        self.E = dev.max_ba_edges
        self.T = dev.max_trajectories
        self.L = dev.max_trajectory_len
        # the dense reduced system is O((T L 42)^3) to solve: T and L pad to
        # the window's demand in grow-only buckets, starting at min(8, cap)
        self._tb = _StickyBucket(min(8, self.T), self.T)
        self._lb = _StickyBucket(min(8, self.L), self.L)
        self.mesh = _mesh_of(config, self.device)
        self._sharded = None
        if self.mesh is not None:
            # the static edge capacity pads up to a mesh multiple, and the
            # sharded solve is one call (airdos_tpu's sharded path)
            self.E = _round_up(self.E, self.mesh.size)
            self._sharded = sharded_human_bundle_adjust(self.mesh)
            self._chunked = False

    def __call__(self, slam_map: SlamMap, current_kf_id: int):
        with _locked(self.map_lock), span(self.profiler, "hba.assemble"):
            problem = self._assemble(current_kf_id)
        if problem is None:
            return
        with span(self.profiler, "hba.solve"):
            res = self._solve(problem)
        with _locked(self.map_lock), span(self.profiler, "hba.writeback"):
            self._write_back(problem, res)
        self.n_runs += 1

    def launch(self, current_kf_id: int) -> bool:
        """Run one human BA in a background thread (online mode), so that
        tracking never waits on the dense reduced solve; the thread
        launches on its own CUDA stream of priority 0.  At most one is in
        flight: while the previous one runs, this cadence tick is skipped
        (returns False).  An exception in the thread is kept and raised by
        the next join()."""
        if self._thread is not None and self._thread.is_alive():
            return False
        if self._stream is None:
            self._stream = new_stream(self.device, WORKER_PRIORITY)

        def run():
            try:
                with on_stream(self._stream):
                    self(self.map, current_kf_id)
            except Exception as e:          # raised again by join()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="human-ba")
        self._thread.start()
        return True

    def join(self):
        """Wait for the background solve; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _assemble(self, current_kf_id: int):
        m = self.map
        pt = m.points
        kf = m.kfs.get(current_kf_id)
        if kf is None:
            return None
        dev = self.config.device
        local_ids = [kf.id] + [k for k in kf.ordered_covis
                               if not m.kfs[k].bad][: dev.max_local_kfs - 1]
        local_set = set(local_ids)

        # local points + all outside observers anchoring the problem (see
        # StaticLocalBA)
        point_ids = collect_window_points(m, local_ids, self.P)
        sel = point_slot_lookup(m, point_ids)
        fixed_ids = find_fixed_observers(
            m, local_set, sel, self.max_cams - len(local_ids),
            "HumanLocalBA")
        fset = set(fixed_ids)
        cam_ids = local_ids + fixed_ids
        cam_index = {kid: i for i, kid in enumerate(cam_ids)}
        window_ids = local_set | fset

        trajs = select_window_trajectories(m.trajectories, window_ids,
                                           self.T)
        if not trajs:
            return None

        # pose windows first, so T and L pad to the actual problem
        windows = []
        for traj in trajs:
            if self.config.optimizer.use_fast_human_ba:
                # the whole trajectory enters the graph (Optimizer::
                # LocalBundleAdjustmentHumanTrajactoryFast, Optimizer.cc:
                # 736-1493), capped by the padded window
                win = list(range(len(traj.poses)))[-self.L:]
            else:
                # the last L poses whose reference KF is in the window
                # (Optimizer.cc:1496-2224)
                win = [i for i, hp in enumerate(traj.poses)
                       if hp.kf_id in window_ids][-self.L:]
            windows.append(win)

        C, P, E = self._cb.fit(len(cam_ids)), self.P, self.E
        T = self._tb.fit(len(trajs))
        L = self._lb.fit(max((len(w) for w in windows), default=2))
        cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        cam_t = np.zeros((C, 3), np.float32)
        cam_fixed = np.ones(C, bool)
        for kid, i in cam_index.items():
            k = m.kfs[kid]
            cam_R[i] = k.Rcw
            cam_t[i] = k.tcw
            cam_fixed[i] = (kid in fset) or kid == 0

        pts = np.zeros((P, 3), np.float32)
        pvalid = np.zeros(P, bool)
        pts[:len(point_ids)] = pt.pos[point_ids]
        pvalid[:len(point_ids)] = True

        ec, ep, eo, ei, ref_p, ref_kf, _ = assemble_edges(
            m, cam_ids, sel, self.inv_sigma2)
        es_cam, es_pt, es_obs, es_info, es_valid, n_e = pad_edge_table(
            ec, ep, eo, ei, E)

        joints = np.zeros((T, L, N_PARTS, 3), np.float32)
        joint_exists = np.zeros((T, L, N_PARTS), bool)
        jo_cam = np.full((T, L), -1, np.int32)
        jo_obs = np.full((T, L, N_PARTS, 3), -1.0, np.float32)
        jo_valid = np.zeros((T, L, N_PARTS), bool)
        seg_len = np.zeros((T, N_PARTS), np.float32)
        seg_free = np.zeros((T, N_PARTS), bool)
        seg_edge_valid = np.zeros((T, L, N_PARTS), bool)
        mot_R = np.tile(np.eye(3, dtype=np.float32), (T, 1, 1))
        mot_t = np.zeros((T, 3), np.float32)
        traj_valid = np.zeros(T, bool)
        pose_dt = np.full((T, L), 1.0, np.float32)
        motion_edge_valid = np.zeros((T, L, 5), bool)
        for t, traj in enumerate(trajs):
            win = windows[t]
            if len(win) < 2:
                continue
            traj_valid[t] = True
            mot_R[t] = traj.motion_R
            mot_t[t] = traj.motion_t
            seg_len[t] = traj.segment_len
            # bad and unoptimized segments stay fixed (Optimizer.cc:1744-1760)
            seg_free[t] = ~(traj.segment_bad & ~traj.segment_optimized)
            for li, pi in enumerate(win):
                hp = traj.poses[pi]
                joints[t, li] = hp.joints_w[:N_PARTS]
                joint_exists[t, li] = True
                ci = cam_index.get(hp.kf_id)
                if ci is not None and hp.in_keyframe and hp.obs_uvd is not None:
                    jo_cam[t, li] = ci
                    jo_obs[t, li] = hp.obs_uvd[:N_PARTS, :3]
                    jo_valid[t, li] = ~hp.bad[:N_PARTS]
                seg_edge_valid[t, li] = True
                if li + 1 < len(win):
                    dt = traj.poses[win[li + 1]].timestamp - hp.timestamp
                    pose_dt[t, li] = max(dt, 1e-3)
                    motion_edge_valid[t, li] = True
        if not traj_valid.any():
            return None

        return dict(
            cam_index=cam_index, cam_fixed=cam_fixed, point_ids=point_ids,
            n_e=n_e, ref_p=ref_p, ref_kf=ref_kf, trajs=trajs,
            traj_valid=traj_valid, pose_windows=windows,
            seg_edge_valid=seg_edge_valid, jo_valid=jo_valid,
            motion_edge_valid=motion_edge_valid,
            arrays=(cam_R, cam_t, cam_fixed, pts, pvalid,
                    es_cam, es_pt, es_obs, es_info, es_valid,
                    joints, joint_exists, jo_cam, jo_obs, jo_valid,
                    seg_len, seg_free, seg_edge_valid,
                    mot_R, mot_t, traj_valid, pose_dt, motion_edge_valid))

    def _solve(self, problem):
        """One device solve and one copy back: every result field packed
        into a single float tensor."""
        opt = self.config.optimizer
        arrays = problem["arrays"]
        C, P, E = arrays[0].shape[0], arrays[3].shape[0], arrays[5].shape[0]
        T, L = arrays[10].shape[:2]
        d = self.device
        args = [to_device(a, d) for a in arrays]

        def call(**iters):
            return (self._sharded or human_bundle_adjust)(
                *args, opt.sigma_static, opt.sigma_human, opt.sigma_rigidity,
                opt.sigma_motion, opt.th_huber_motion, opt.th_ransac_motion,
                opt.th_ransac_rigidity,
                self.fx, self.fy, self.cx, self.cy, self.bf,
                use_huber=bool(opt.is_huber), **iters)

        gate_wait(self.gate)       # tracking launches first
        if not self._chunked:
            res = call()
        else:
            res = None
            for i1, i2 in _LM_CHUNKS:
                if res is not None:
                    # the state moves on: cameras, points, joints, limb
                    # lengths and motions (the solver's argument slots)
                    for slot, x in zip((0, 1, 3, 10, 15, 18, 19),
                                       res[:7]):
                        args[slot] = x
                    gate_wait(self.gate)
                res = call(iters1=i1, iters2=i2)
        flat = torch.cat([x.reshape(-1).to(torch.float32) for x in res]) \
            .cpu().numpy()
        shapes = ((C, 3, 3), (C, 3), (P, 3), (T, L, N_PARTS, 3),
                  (T, N_PARTS), (T, 3, 3), (T, 3), (E,), (T, L, N_PARTS),
                  (T, L, N_PARTS), (T, L - 1, 5))
        out, o = [], 0
        for i, sh in enumerate(shapes):
            n = int(np.prod(sh))
            a = flat[o:o + n].reshape(sh)
            out.append(a > 0.5 if i >= 7 else a)   # the four inlier flags
            o += n
        return type(res)(*out)

    def _write_back(self, problem, res):
        m = self.map
        pt = m.points
        cam_index = problem["cam_index"]
        cam_fixed = problem["cam_fixed"]
        point_ids = problem["point_ids"]
        n_e = problem["n_e"]
        ref_p, ref_kf = problem["ref_p"], problem["ref_kf"]
        for kid, i in cam_index.items():
            # a KF culled while the solve was in flight stays where the
            # culler left it (reference: pKF->isBad() recheck)
            k = m.kfs.get(kid)
            if k is not None and not k.bad and not cam_fixed[i]:
                k.set_pose(res.cam_R[i], res.cam_t[i])
        alive = ~pt.bad[point_ids]
        pt.pos[point_ids[alive]] = res.points[:len(point_ids)][alive]
        for i in np.nonzero(~res.static_inlier[:n_e])[0]:
            if not pt.bad[int(ref_p[i])]:
                m.erase_observation(int(ref_p[i]), int(ref_kf[i]))
        m.update_points_normal_depth(point_ids[alive])

        seg_edge_valid = problem["seg_edge_valid"]
        rig_bad = seg_edge_valid & ~res.rigid_inlier         # [T, L, S]
        rig_ok = seg_edge_valid & res.rigid_inlier
        proj_bad = problem["jo_valid"] & ~res.key_inlier
        # motion edges connect pose l -> l+1: L-1 rows
        mot_in = res.motion_inlier
        mot_bad = problem["motion_edge_valid"][:, :mot_in.shape[1]] & ~mot_in
        for t, traj in enumerate(problem["trajs"]):
            if not problem["traj_valid"][t]:
                continue
            win = problem["pose_windows"][t]
            traj.motion_R = res.mot_R[t]
            traj.motion_t = res.mot_t[t]
            traj.segment_len = res.seg_len[t]
            traj.optimized = True
            m.optimized_track_ids.add(traj.track_id)
            # rigidity outliers: a segment is bIsBad whenever a window pose
            # broke it, bOptimized whenever one passed
            traj.segment_bad |= rig_bad[t, :len(win)].any(axis=0)
            traj.segment_optimized |= rig_ok[t, :len(win)].any(axis=0)
            for li, pi in enumerate(win):
                hp = traj.poses[pi]
                hp.joints_w[:N_PARTS] = res.joints[t, li]
                hp.optimized[:N_PARTS] = True
                # both-bad rigidity endpoints become bIsBad joints
                first_bad = np.zeros(18, bool)
                second_bad = np.zeros(18, bool)
                first_bad[BODY1[rig_bad[t, li]]] = True
                second_bad[BODY2[rig_bad[t, li]]] = True
                hp.bad[:18] |= first_bad & second_bad
                # projection outliers -> bIsBad
                hp.bad[:N_PARTS] |= proj_bad[t, li]
                # motion outliers -> bIsLost on the first pose's joint
                if li < mot_bad.shape[1]:
                    mb = mot_bad[t, li]
                    hp.lost[MAIN_SKELETON[mb]] = True
                    traj.bad_count += int(mb.sum())


def solve_global_ba(cam_R, cam_t, cam_fixed, pts, pvalid,
                    e_cam, e_pt, e_obs, e_info, e_valid, fx, fy, cx, cy, bf,
                    n_iters: int = 20, chunk: int = 5, cg_iters: int = 48,
                    abort=None, gate=None, mesh=None):
    """airdos_tpu's GlobalBA schedule (slam/ba_driver.py:1256-1274) on
    device tensors: solver calls of `chunk` steps, the first with
    chunk // 2 Huber steps then the rest plain, the later ones plain only.
    Each call is a fresh global_bundle_adjust (lambda restarts at 1e-6,
    the inlier set and the starting cost are recomputed), so the chunks
    are not one 20-step solve.  A step launches launches_per_step(
    cg_iters): 4 segment sums, and cg_iters schur_point and schur_camera
    (the CG).  Returns (R, t, points) on the device.  Before each call the
    abort flag (a threading.Event) is checked, as the reference polls
    mbStopGBA between iterations (Optimizer.cc:121-129): once it is set
    no further call starts, and the last finished call's result is
    returned, or None if none finished.  With a gate (online) each
    Gauss-Newton step first waits for a gap between tracking's frames,
    one step a gap (``gap_waiter``, at most BACKGROUND_WAIT_S): the solve
    runs in the background, and its launch loop would otherwise contend
    with tracking's for the host (utils/gate.py).  With a mesh each call is sharded over it (the edge
    arrays padded to a multiple of its size): every rank launches
    launches_per_step(cg_iters) a step (the CG's two kernels in their raw
    mode), and rank 0 waits on the gate for all."""
    out = None
    R, t, ps = cam_R, cam_t, pts
    hook = gap_waiter(gate)
    for ci in range(max(1, -(-n_iters // chunk))):
        if abort is not None and abort.is_set():
            break
        i1 = chunk // 2 if ci == 0 else 0          # Huber phase only first
        iters = dict(iters1=i1, iters2=chunk - i1, cg_iters=cg_iters)
        solve = functools.partial(global_bundle_adjust, **iters) \
            if mesh is None else sharded_global_bundle_adjust(mesh, **iters)
        res = solve(R, t, cam_fixed, ps, pvalid, e_cam, e_pt, e_obs, e_info,
                    e_valid, fx, fy, cx, cy, bf, step_hook=hook)
        R, t, ps = res.R, res.t, res.points
        out = (R, t, ps)
    return out


def propagate_to_children(m: SlamMap, old_pose, new_pose) -> None:
    """Give every live keyframe that a solve did not hold (a key of neither
    dict) its pose before (old_pose) and after (new_pose): it keeps its
    pose relative to its spanning-tree parent, or stays where it is when
    the parent was not moved.  Children have larger ids than parents, so
    increasing-id order corrects the parent first."""
    for k in sorted((k for k in m.kfs.values() if not k.bad),
                    key=lambda k: k.id):
        if k.id in new_pose:
            continue
        old_pose[k.id] = (k.Rcw.copy(), k.tcw.copy())
        par = k.parent
        if par is None or par not in new_pose:
            new_pose[k.id] = (k.Rcw.copy(), k.tcw.copy())
            continue
        Rp_o, tp_o = old_pose[par]
        Rp_n, tp_n = new_pose[par]
        Rcp = k.Rcw @ Rp_o.T
        tcp = k.tcw - Rcp @ tp_o
        new_pose[k.id] = (Rcp @ Rp_n, Rcp @ tp_n + tcp)


class GlobalBA:
    """Full-map bundle adjustment (reference Optimizer::GlobalBundleAdjustemnt
    + LoopClosing::RunGlobalBundleAdjustment, Optimizer.cc:52-230,
    LoopClosing.cc:645-749): EVERY keyframe (KF0 fixed) and EVERY live map
    point, sized to the map through grow-only buckets (matrix-free Schur
    + PCG, O(edges) memory), not truncated."""

    def __init__(self, config: SlamConfig, slam_map: SlamMap, extractor,
                 device, max_kfs: int = 4096, max_points: int = 1 << 20,
                 max_edges: int = 1 << 22):
        self.config = config
        self.map = slam_map
        self.device = torch.device(device)
        self.profiler = None
        self.n_runs = 0               # completed passes (write-back done)
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.inv_sigma2 = (1.0 / extractor.sigma2).astype(np.float32)
        self.max_kfs = max_kfs
        self.max_points = max_points
        self._cb = _StickyBucket(16, max_kfs)
        self._pb = _StickyBucket(1024, max_points)
        self._eb = _StickyBucket(4096, max_edges)
        self.gate = None              # online: utils/gate.TrackingGate
        self.n_aborted = 0            # background runs that an abort ended
        self._thread = None           # the background run (online)
        self._abort = None            # its abort flag (threading.Event)
        self._old_threads: list = []  # aborted runs not joined yet
        self._error = None            # the first exception of a run
        self._stream = None           # their CUDA stream, at first launch
        self.mesh = _mesh_of(config, self.device)

    def __call__(self, n_iters: int = 20):
        """assemble -> chunked solve -> write-back (with propagation to
        keyframes and points the problem did not hold)."""
        self._run(None, n_iters, None)

    # ------------------------------------------------------- async runner
    def launch(self, map_lock, n_iters: int = 20):
        """Run the global BA in a background thread, like the reference's
        RunGlobalBundleAdjustment thread (LoopClosing.cc:579, 645-749):
        assembly and write-back hold the map lock briefly, and the device
        solve runs unlocked on the thread's own CUDA stream (priority 0) in
        abortable solver calls.  A new launch aborts a running one first
        (LoopClosing.cc:435-446, mbStopGBA) without joining it: the caller
        usually holds map_lock (CorrectLoop), and the old thread may be
        waiting on it for its write-back.  An aborted thread re-checks its
        flag after every lock acquisition and leaves the map untouched.
        An exception in the thread is kept and raised by join()."""
        self.interrupt(wait=False)
        if self._stream is None:
            self._stream = new_stream(self.device, WORKER_PRIORITY)
        abort = threading.Event()
        self._abort = abort

        def body():
            try:
                with on_stream(self._stream):
                    self._run(map_lock, n_iters, abort)
            except Exception as e:             # raised again by join()
                if self._error is None:
                    self._error = e

        self._old_threads = [t for t in self._old_threads if t.is_alive()]
        self._thread = threading.Thread(target=body, daemon=True,
                                        name="global-ba")
        self._thread.start()

    def _run(self, map_lock, n_iters, abort):
        """The one runner: the synchronous call passes no lock and no flag;
        a background run holds map_lock around assembly and write-back and
        leaves the map untouched once `abort` is set."""
        aborted = (lambda: False) if abort is None else abort.is_set
        with _locked(map_lock), span(self.profiler, "gba.assemble"):
            if aborted():
                self.n_aborted += 1
                return
            problem = self._assemble()
        if problem is None:
            return
        with span(self.profiler, "gba.solve"):
            out = self._solve(problem, n_iters, abort)
        with _locked(map_lock):
            if out is None or aborted():
                self.n_aborted += 1
                return
            with span(self.profiler, "gba.writeback"):
                self._write_back(problem, out)
            self.n_runs += 1

    def interrupt(self, wait: bool = True):
        """Abort a running background global BA, and with `wait` wait for
        its thread (the caller must not hold the map lock then)."""
        th = self._thread
        if th is not None and th.is_alive():
            self._abort.set()
            if wait:
                th.join()
            else:
                self._old_threads.append(th)
        self._thread = None

    def join(self):
        """Wait for every background run, aborted ones too; raise the
        first exception one of them raised."""
        for th in self._old_threads + \
                ([self._thread] if self._thread is not None else []):
            th.join()
        self._thread = None
        self._old_threads = []
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _assemble(self):
        m = self.map
        pt = m.points
        kfs = sorted((k for k in m.kfs.values() if not k.bad),
                     key=lambda k: k.id)
        if len(kfs) < 2:
            return None
        if len(kfs) > self.max_kfs:
            warnings.warn(f"GlobalBA: map has {len(kfs)} keyframes, above "
                          f"the {self.max_kfs} budget; truncating")
            kfs = kfs[: self.max_kfs]
        cam_index = {k.id: i for i, k in enumerate(kfs)}
        point_ids = np.asarray(pt.live_ids(),
                               dtype=np.int64)[: self.max_points]
        if len(point_ids) < 10:
            return None
        C = self._cb.fit(len(kfs))
        P = self._pb.fit(len(point_ids))

        cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        cam_t = np.zeros((C, 3), np.float32)
        cam_fixed = np.ones(C, bool)
        for k in kfs:
            i = cam_index[k.id]
            cam_R[i] = k.Rcw
            cam_t[i] = k.tcw
            cam_fixed[i] = (k.id == 0)
        pts = np.zeros((P, 3), np.float32)
        pvalid = np.zeros(P, bool)
        pts[:len(point_ids)] = pt.pos[point_ids]
        pvalid[:len(point_ids)] = True

        sel = point_slot_lookup(m, point_ids)
        ec, ep, eo, ei, _, _, _ = assemble_edges(
            m, [k.id for k in kfs], sel, self.inv_sigma2)
        E = self._eb.fit(len(ec))
        if self.mesh is not None:
            E = _round_up(E, self.mesh.size)
        e_cam, e_pt, e_obs, e_info, e_valid, _ = pad_edge_table(
            ec, ep, eo, ei, E)
        return dict(cam_index=cam_index, point_ids=point_ids,
                    cam_R0=cam_R.copy(), cam_t0=cam_t.copy(),
                    arrays=(cam_R, cam_t, cam_fixed, pts, pvalid,
                            e_cam, e_pt, e_obs, e_info, e_valid))

    def _solve(self, problem, n_iters: int = 20, abort=None):
        """The chunked solve on the device and one copy back; None when an
        abort came before the first solver call finished."""
        d = self.device
        arrays = [to_device(a, d) for a in problem["arrays"]]
        out = solve_global_ba(*arrays, self.fx, self.fy, self.cx, self.cy,
                              self.bf, n_iters=n_iters, abort=abort,
                              gate=self.gate, mesh=self.mesh)
        if out is None:
            return None
        R, t, ps = out
        C, P = R.shape[0], ps.shape[0]
        flat = torch.cat([R.reshape(-1), t.reshape(-1),
                          ps.reshape(-1)]).cpu().numpy()
        return (flat[:9 * C].reshape(C, 3, 3),
                flat[9 * C:12 * C].reshape(C, 3), flat[12 * C:].reshape(P, 3))

    def _write_back(self, problem, res):
        """Write solved poses and points; keyframes and points the problem
        did not hold are moved with their parent / reference keyframe
        (reference LoopClosing.cc:682-743, the mTcwBefGBA walk)."""
        m = self.map
        pt = m.points
        cam_index = problem["cam_index"]
        point_ids = problem["point_ids"]
        R_out, t_out, pts_out = res
        R0, t0 = problem["cam_R0"], problem["cam_t0"]
        old_pose = {kid: (R0[i], t0[i]) for kid, i in cam_index.items()}
        new_pose = {kid: (R_out[i], t_out[i]) for kid, i in cam_index.items()}
        propagate_to_children(m, old_pose, new_pose)
        for k in m.kfs.values():
            if k.bad or k.id not in new_pose or k.id == 0:
                continue
            k.set_pose(*new_pose[k.id])
        pt.pos[point_ids] = pts_out[:len(point_ids)]
        solved = set(point_ids.tolist())
        for p in pt.live_ids():
            p = int(p)
            if p in solved:
                continue
            ref = int(pt.ref_kf[p])
            if ref not in old_pose:
                continue
            Ro, to = old_pose[ref]
            Rn, tn = new_pose[ref]
            pt.pos[p] = Rn.T @ (Ro @ pt.pos[p] + to - tn)
        m.update_points_normal_depth(point_ids)
