"""Loop detection and correction.

Rebuild of LoopClosing (reference src/LoopClosing.cc) as
airdos_tpu/slam/loop_closing.py runs it: BoW candidate detection
with 3-consecutive covisibility-group consistency (103-229); per
candidate, ComputeSim3 — SearchByBoW >= 20 matches -> Sim3 RANSAC ->
SearchBySim3 -> OptimizeSim3 >= 20 inliers -> loop-neighbourhood
projection >= 40 (231-400); then CorrectLoop — propagate the corrected
Sim3 through the covisible group, correct their points, merge and fuse
the loop points, optimize the essential graph, then the global bundle
adjustment (402-749): inline offline, in a background thread online.

The System calls ``process()`` at each keyframe after the mapping pass:
inline offline, on the mapping worker online, where the reference runs a
LoopClosing thread (System.cc:173-174).  Online the same non-blocking
property comes from lock granularity, as in airdos_tpu: detection and the
Sim3 computation take the shared map lock only around their host map
reads and release it across every device call (each of which first waits
on the tracking gate, utils/gate.py); ``correct()`` does the map surgery
under the lock, solves the essential graph unlocked on the snapshot it
assembled, writes back under the lock again, and launches the global BA
in its background thread (``GlobalBA.launch``), which a later loop
aborts.  airdos_tpu's ``Fuser.warmup`` compiles its fuse program before
the lock is taken; eager torch compiles nothing, so there is no warmup
here.  The matches run on
the card through the Hamming kernel (the BoW match, both directions of
SearchBySim3, the loop-point projection, SearchAndFuse); the essential
graph and the global BA sum through ``segment_sum``.  The host keeps
numpy Generators for the RANSAC samples, so the same match lists draw
the same samples as airdos_tpu, and the map surgery stays host numpy in
airdos_tpu's dtypes.  The essential graph is solved at the live keyframe
count, with no padding (airdos_tpu pads to sticky buckets to reuse its
compiled programs).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.convert import desc_to_tensor, to_device
from airdos_tpu_torch.matching.bow_match import match_by_bow
from airdos_tpu_torch.matching.projection import match_local_points
from airdos_tpu_torch.matching.sim3_match import match_by_sim3
from airdos_tpu_torch.slam.ba_driver import propagate_to_children
from airdos_tpu_torch.slam.keyframe_db import KeyFrameDatabase
from airdos_tpu_torch.slam.map import KeyFrame, SlamMap
from airdos_tpu_torch.solvers.pose_graph import optimize_essential_graph
from airdos_tpu_torch.solvers.sim3 import optimize_sim3, sim3_ransac
from airdos_tpu_torch.utils.gate import gate_wait
from airdos_tpu_torch.utils.obs import span


class LoopCloser:
    def __init__(self, config: SlamConfig, slam_map: SlamMap,
                 db: KeyFrameDatabase, extractor, device, fuser=None,
                 global_ba=None, map_lock=None):
        self.config = config
        self.map = slam_map
        self.db = db
        self.device = torch.device(device)
        self.fuser = fuser
        self.global_ba = global_ba
        # online: the global BA runs in its background thread like the
        # reference's GBA thread (LoopClosing.cc:579); offline it is inline
        self.async_gba = not config.system.is_offline
        self.map_lock = map_lock
        self.gate = None                # online: utils/gate.TrackingGate
        self.profiler = None
        self.events = None              # the System's EventLog
        cam = config.camera
        self.fx, self.fy, self.cx, self.cy, self.bf = \
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
        self.sigma2 = extractor.sigma2
        self.consistency_th = 3
        self._consistent_groups: List[Tuple[Set[int], int]] = []
        self._last_loop_kf = -1e9
        self.scale_factors = np.asarray(extractor.scales, np.float32)
        self.log_scale = float(np.log(config.orb.scale_factor))
        self.n_levels = config.orb.n_levels
        self.width, self.height = cam.width, cam.height
        self.rng = np.random.default_rng(0)
        self.n_loops_closed = 0
        # (kf id, candidate id, matches, loop points) of each closed loop
        self.closed: List[Tuple[int, int, int, int]] = []

    def _lockctx(self):
        return self.map_lock if self.map_lock is not None \
            else contextlib.nullcontext()

    # ------------------------------------------------------------ detect
    def detect(self, kf: KeyFrame) -> List[int]:
        if kf.id < self._last_loop_kf + 10 or self.map.n_keyframes() < 10:
            self.db.add(kf)
            return []
        self.db.ensure_bow(kf)
        # min score: lowest BoW similarity with covisible neighbours
        min_score = 1.0
        for nid in kf.ordered_covis:
            nkf = self.map.kfs.get(nid)
            if nkf is None or nkf.bad:
                continue
            self.db.ensure_bow(nkf)
            min_score = min(min_score, self.db.voc.score(kf.bow, nkf.bow))
        candidates = self.db.detect_loop_candidates(kf, min_score)
        self.db.add(kf)
        if not candidates:
            self._consistent_groups = []
            return []
        # consistency over consecutive detections
        enough: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        for cand in candidates:
            group = {cand} | set(self.map.kfs[cand].covis)
            best_consistency = 0
            for prev_group, count in self._consistent_groups:
                if group & prev_group:
                    best_consistency = max(best_consistency, count + 1)
            new_groups.append((group, best_consistency))
            if best_consistency >= self.consistency_th:
                enough.append(cand)
        self._consistent_groups = new_groups
        return enough

    # ------------------------------------------------------- compute sim3
    def _pair_arrays(self, kf, ckf, prs):
        """Camera-frame points and per-feature sigma2 for (f1, f2, p1, p2)
        pair rows."""
        pt = self.map.points
        x1 = np.asarray([kf.Rcw @ pt.pos[p1] + kf.tcw
                         for _, _, p1, _ in prs], np.float32)
        x2 = np.asarray([ckf.Rcw @ pt.pos[p2] + ckf.tcw
                         for _, _, _, p2 in prs], np.float32)
        f1 = [p[0] for p in prs]
        f2 = [p[1] for p in prs]
        return x1, x2, self.sigma2[kf.octave[f1]], self.sigma2[ckf.octave[f2]]

    def compute_sim3(self, kf: KeyFrame, cand_id: int):
        """Returns (R12, t12, s12, matches {fid_kf: pid}, cand_id,
        loop_points) or None.  Takes the map lock only around its host map
        reads; the device calls run unlocked."""
        lock = self._lockctx()
        with lock:
            ckf = self.map.kfs.get(cand_id)
            if ckf is None or ckf.bad:
                return None
            self.db.ensure_bow(kf)
            self.db.ensure_bow(ckf)
        d = self.device
        # a keyframe's descriptors, BoW nodes and angles do not change
        # after it is made: the match needs no lock
        gate_wait(self.gate)            # tracking launches first
        with span(self.profiler, "sim3.bow_match"):
            m = match_by_bow(
                desc_to_tensor(kf.desc32, d),
                to_device(kf.feat_nodes, d, np.int64),
                to_device(kf.valid, d), to_device(kf.angle, d, np.float32),
                desc_to_tensor(ckf.desc32, d),
                to_device(ckf.feat_nodes, d, np.int64),
                to_device(ckf.valid, d), to_device(ckf.angle, d, np.float32))
            idx2 = m.idx2.cpu().numpy()
        pt = self.map.points
        with lock:
            pairs = []
            for f1 in np.nonzero(idx2 >= 0)[0]:
                f2 = int(idx2[f1])
                p1 = int(kf.mp_idx[f1])
                p2 = int(ckf.mp_idx[f2])
                if p1 >= 0 and p2 >= 0 and not pt.bad[p1] \
                        and not pt.bad[p2]:
                    pairs.append((int(f1), f2, p1, p2))
            if len(pairs) < 20:
                return None
            n = len(pairs)
            x1, x2, s1, s2 = self._pair_arrays(kf, ckf, pairs)
        n_hyp = self.config.device.ransac_hypotheses
        samples = self.rng.integers(0, n, (n_hyp, 3)).astype(np.int32)
        with span(self.profiler, "sim3.ransac"):
            res = sim3_ransac(to_device(x1, d), to_device(x2, d),
                              torch.ones(n, dtype=torch.bool, device=d),
                              to_device(samples, d), to_device(9.21 * s1, d),
                              to_device(9.21 * s2, d), self.fx, self.fy,
                              self.cx, self.cy, fix_scale=True)
            flat = torch.cat([res.R.reshape(-1), res.t, res.s[None],
                              res.n_inliers.to(res.t.dtype)[None]]) \
                .cpu().numpy()
        if int(flat[13]) < 12:
            return None
        Rr, tr, sr = flat[:9].reshape(3, 3), flat[9:12], float(flat[12])

        # --- SearchBySim3: grow matches through the RANSAC Sim3 ----------
        with span(self.profiler, "sim3.search_by_sim3"):
            grown = self._search_by_sim3(kf, ckf, Rr, tr, sr,
                                         {p[0] for p in pairs},
                                         {p[3] for p in pairs})
        with lock:
            # a point culled while the lock was released drops its pair
            pairs = [p for p in pairs + grown
                     if not pt.bad[p[2]] and not pt.bad[p[3]]]
            if len(pairs) < 20:
                return None
            n = len(pairs)
            x1, x2, s1, s2 = self._pair_arrays(kf, ckf, pairs)
            obs1 = kf.xy_un[[p[0] for p in pairs]].astype(np.float32)
            obs2 = ckf.xy_un[[p[1] for p in pairs]].astype(np.float32)
        with span(self.profiler, "sim3.optimize"):
            R, t, s, inl, _ = optimize_sim3(
                res.R, res.t, res.s,
                to_device(x1, d), to_device(obs1, d), to_device(s1, d),
                to_device(x2, d), to_device(obs2, d), to_device(s2, d),
                torch.ones(n, dtype=torch.bool, device=d),
                self.fx, self.fy, self.cx, self.cy)
            flat = torch.cat([R.reshape(-1), t, s[None],
                              inl.to(t.dtype)]).cpu().numpy()
        inl = flat[13:] > 0.5
        if int(inl.sum()) < 20:
            return None
        R, t, s = flat[:9].reshape(3, 3), flat[9:12], float(flat[12])
        matches = {p[0]: p[3] for p, keep in zip(pairs, inl) if keep}

        # --- loop-neighbourhood projection gate --------------------------
        # the candidate group's points projected into the current KF
        # through the corrected Scw; >= 40 matches in all
        # (reference LoopClosing.cc:350-390)
        with span(self.profiler, "sim3.project_loop_points"):
            with lock:
                loop_points = self._gather_loop_points(ckf)
            n_total, proj_matches = self._project_loop_points(
                kf, loop_points, R, t, s, ckf, matches)
        if n_total < 40:
            return None
        matches.update(proj_matches)
        return (R, t, s, matches, cand_id, loop_points)

    def _search_by_sim3(self, kf: KeyFrame, ckf: KeyFrame, R12, t12, s12,
                        matched_f1: Set[int], matched_p2: Set[int]):
        """Grow (f1, f2, p1, p2) pairs by mutual Sim3 projection."""
        pt = self.map.points

        def point_tables(k, skip_pid):
            n = k.n_slots
            x = np.zeros((n, 3), np.float32)
            desc = np.zeros((n, 8), np.uint32)
            maxd = np.zeros(n, np.float32)
            val = np.zeros(n, bool)
            for fid in np.nonzero(k.mp_idx >= 0)[0]:
                pid = int(k.mp_idx[fid])
                if pt.bad[pid] or pid in skip_pid:
                    continue
                x[fid] = k.Rcw @ pt.pos[pid] + k.tcw    # own camera frame
                desc[fid] = pt.desc32[pid]
                maxd[fid] = pt.max_dist[pid]
                val[fid] = True
            return x, desc, maxd, val

        with self._lockctx():
            x1c, desc1, maxd1, val1 = point_tables(kf, set())
            x2c, desc2, maxd2, val2 = point_tables(ckf, matched_p2)
        val1 &= ~np.isin(np.arange(kf.n_slots), list(matched_f1))
        # KF2 points -> cam1 through S12; KF1 points -> cam2 through S21
        x2_in_c1 = s12 * (x2c @ R12.T) + t12
        x1_in_c2 = ((x1c - t12) @ R12) / s12
        d = self.device
        gate_wait(self.gate)            # tracking launches first
        m = match_by_sim3(
            to_device(x2_in_c1, d, np.float32), to_device(val2, d),
            desc_to_tensor(desc2, d), to_device(maxd2, d),
            to_device(x1_in_c2, d, np.float32), to_device(val1, d),
            desc_to_tensor(desc1, d), to_device(maxd1, d),
            to_device(kf.xy_un, d), to_device(kf.octave, d, np.int64),
            desc_to_tensor(kf.desc32, d), to_device(kf.valid, d),
            to_device(ckf.xy_un, d), to_device(ckf.octave, d, np.int64),
            desc_to_tensor(ckf.desc32, d), to_device(ckf.valid, d),
            self.fx, self.fy, self.cx, self.cy, self.width, self.height,
            to_device(self.scale_factors, d), self.log_scale, self.n_levels)
        idx2 = m.idx2_of_1.cpu().numpy()
        grown = []
        with self._lockctx():
            for f1 in np.nonzero(idx2 >= 0)[0]:
                f1 = int(f1)
                f2 = int(idx2[f1])
                p1 = int(kf.mp_idx[f1])
                p2 = int(ckf.mp_idx[f2])
                if p1 >= 0 and p2 >= 0 and not pt.bad[p1] \
                        and not pt.bad[p2] \
                        and f1 not in matched_f1 and p2 not in matched_p2:
                    grown.append((f1, f2, p1, p2))
        return grown

    def _gather_loop_points(self, ckf: KeyFrame) -> List[int]:
        """The candidate KF's and its covisible neighbours' map points
        (reference LoopClosing.cc:350-368 mvpLoopMapPoints)."""
        pt = self.map.points
        out, seen = [], set()
        for kid in [ckf.id] + list(ckf.ordered_covis):
            k = self.map.kfs.get(kid)
            if k is None or k.bad:
                continue
            for pid in k.mp_idx[k.mp_idx >= 0]:
                p = int(pid)
                if p not in seen and not pt.bad[p]:
                    seen.add(p)
                    out.append(p)
        return out

    def _project_loop_points(self, kf: KeyFrame, loop_points: List[int],
                             R12, t12, s12, ckf: KeyFrame,
                             matches: Dict[int, int]):
        """SearchByProjection of the loop points through the corrected Scw
        (th = 10); returns (total match count, {fid: pid} new
        projections)."""
        pt = self.map.points
        # corrected current-KF pose: Scw = S12 * T2w (scale folded into t)
        Rcw = (R12 @ ckf.Rcw).astype(np.float32)
        tcw = (s12 * (R12 @ ckf.tcw) + t12).astype(np.float32)
        ow = (-Rcw.T @ tcw / max(s12, 1e-9)).astype(np.float32)
        matched_pids = set(matches.values())
        with self._lockctx():
            cand = [p for p in loop_points if p not in matched_pids
                    and not pt.bad[p]]
            if not cand:
                return len(matches), {}
            n = len(cand)
            ids = np.asarray(cand)
            xw = pt.pos[ids].astype(np.float32)
            desc = pt.desc32[ids]
            normal = pt.normal[ids].astype(np.float32)
            maxd = pt.max_dist[ids].astype(np.float32)
            mind = pt.min_dist[ids].astype(np.float32)
        taken = np.zeros(kf.n_slots, bool)
        for fid in matches:
            taken[fid] = True
        d = self.device
        gate_wait(self.gate)            # tracking launches first
        out = match_local_points(
            to_device(xw, d), desc_to_tensor(desc, d),
            torch.ones(n, dtype=torch.bool, device=d),
            to_device(normal, d), to_device(maxd, d), to_device(mind, d),
            to_device(Rcw, d), to_device(tcw, d), to_device(ow, d),
            to_device(kf.xy_un, d), to_device(kf.u_right, d),
            to_device(kf.octave, d, np.int64), desc_to_tensor(kf.desc32, d),
            to_device(kf.valid, d), to_device(taken, d),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            self.width, self.height,
            to_device(self.scale_factors, d), self.log_scale,
            self.n_levels, 10.0)
        feat_idx = out.feat_idx.cpu().numpy()
        proj = {}
        for i in np.nonzero(feat_idx >= 0)[0]:
            fid = int(feat_idx[i])
            if fid not in matches and fid not in proj:
                proj[fid] = int(ids[i])
        return len(matches) + len(proj), proj

    # ------------------------------------------------------- correct loop
    def correct(self, kf: KeyFrame, sim3_result) -> bool:
        """CorrectLoop (reference LoopClosing.cc:402-749): the map surgery,
        the essential-graph solve, its write-back, then the global BA.

        Locking (the caller must not hold the map lock): a global BA still
        running is aborted first (LoopClosing.cc:435-446); the map surgery
        (pose propagation to the covisible group, loop-point merging,
        SearchAndFuse, the essential graph's assembly) runs under the lock,
        which SearchAndFuse releases across each device match; the
        essential graph is solved unlocked on the assembled snapshot; the
        write-back takes the lock again and corrects keyframes and points
        made meanwhile through their parents (the mTcwBefGBA walk of
        LoopClosing.cc:682-743), then launches the global BA (online) or
        runs it (offline)."""
        R12, t12, s12, matches, cand_id, loop_points = sim3_result
        lock = self._lockctx()
        if self.global_ba is not None and self.async_gba:
            self.global_ba.interrupt(wait=False)
        with span(self.profiler, "loop.correct_map"):
            problem = self._correct_map(kf, sim3_result)
        if problem is None:
            return False
        index, R0, t0, fixed, e_i, e_j, Rm, tm = problem
        d = self.device
        K, E = len(R0), len(e_i)
        # online, each Gauss-Newton step first waits while tracking is in
        # its frame: the solve's launch loop contends with tracking's for
        # the host (utils/gate.py)
        hook = None if self.gate is None else (lambda: gate_wait(self.gate))
        with span(self.profiler, "loop.essential_graph"):
            R_sol, t_sol, _ = optimize_essential_graph(
                to_device(R0, d), to_device(t0, d),
                torch.ones(K, dtype=torch.float32, device=d),
                to_device(fixed, d), to_device(e_i, d), to_device(e_j, d),
                to_device(np.stack(Rm), d, np.float32),
                to_device(np.stack(tm), d, np.float32),
                torch.ones(E, dtype=torch.float32, device=d),
                torch.ones(E, dtype=torch.bool, device=d), step_hook=hook)
            flat = torch.cat([R_sol.reshape(-1), t_sol.reshape(-1)]) \
                .cpu().numpy()
        R_out = flat[:9 * K].reshape(K, 3, 3)
        t_out = flat[9 * K:].reshape(K, 3)
        with lock:
            self._write_back_pose_graph(kf, cand_id, index, R0, t0, R_out,
                                        t_out)
            kf.loop_edges.add(cand_id)
            ckf = self.map.kfs.get(cand_id)
            if ckf is not None:        # culled while the solve ran
                ckf.loop_edges.add(kf.id)
            self._last_loop_kf = kf.id
            self.n_loops_closed += 1
            self.closed.append((kf.id, cand_id, len(matches),
                                len(loop_points)))
            if self.events is not None:
                self.events.emit("loop_closed", kf=kf.id, candidate=cand_id,
                                 n_matches=len(matches),
                                 n_loop_points=len(loop_points))
            if self.global_ba is not None:
                if self.async_gba:
                    # a new loop aborts a global BA still running
                    # (LoopClosing.cc:435-446), then starts a fresh one
                    self.global_ba.launch(self.map_lock)
                else:
                    with span(self.profiler, "loop.global_ba"):
                        self.global_ba()
        return True

    def _correct_map(self, kf: KeyFrame, sim3_result):
        """Propagate the corrected Sim3 to the covisible group and their
        points, merge and fuse the loop points, assemble the essential-graph
        problem.  Returns (index, R0, t0, fixed, e_i, e_j, Rm, tm) or
        None.  Takes the map lock (the caller must not hold it) and
        releases it across SearchAndFuse's device matches."""
        lock = self._lockctx()
        with lock:
            state = self._correct_group(kf, sim3_result)
        if state is None:
            return None
        live, nc_R, nc_t, group = state
        m = self.map
        # SearchAndFuse: the loop-neighbourhood points into every corrected
        # group KF, loop points winning conflicts (reference
        # LoopClosing::SearchAndFuse, ORBmatcher::Fuse(Scw)), one target at
        # a time as the reference fuses them
        if self.fuser is not None:
            for gid in group:
                gkf = m.kfs.get(gid)
                if gkf is not None and not gkf.bad:
                    self.fuser._fuse_into(sim3_result[5], gkf,
                                          prefer_candidates=True)
        with lock:
            if self.fuser is not None:
                m.update_connections(kf)
            return self._essential_graph_problem(kf, sim3_result[4], live,
                                                 nc_R, nc_t)

    def _correct_group(self, kf: KeyFrame, sim3_result):
        """The corrected Sim3 propagated to kf's covisible group and their
        points, and the matched loop points merged into kf.  Returns the
        live keyframes, their non-corrected poses and the group, or None
        when kf or the candidate is gone."""
        R12, t12, s12, matches, cand_id, loop_points = sim3_result
        ckf = self.map.kfs.get(cand_id)
        if kf.bad or ckf is None or ckf.bad:
            return None
        m = self.map
        pt = m.points

        # NON-corrected poses of every keyframe: the essential graph's
        # measurements come from the pre-correction geometry (reference
        # NonCorrectedSim3, LoopClosing.cc:438-567), or every residual
        # starts at zero and the pose graph does nothing
        live = sorted((k for k in m.kfs.values() if not k.bad),
                      key=lambda k: k.id)
        nc_R = {k.id: k.Rcw.copy() for k in live}
        nc_t = {k.id: k.tcw.copy() for k in live}

        # corrected pose of kf: T_kf<-world = S12 * T_cand<-world
        Rcw_new = R12 @ ckf.Rcw
        tcw_new = s12 * (R12 @ ckf.tcw) + t12

        # propagate the correction to kf's covisible group
        delta_R = Rcw_new @ kf.Rcw.T
        delta_t = tcw_new - delta_R @ kf.tcw
        group = [kf.id] + [k for k in kf.covis if not m.kfs[k].bad]
        corrected_pts: Set[int] = set()
        for gid in group:
            gkf = m.kfs[gid]
            R_old, t_old = gkf.Rcw.copy(), gkf.tcw.copy()
            R_new = delta_R @ R_old
            t_new = delta_R @ t_old + delta_t
            gkf.set_pose(R_new, t_new)
            # this KF's points: world' = Tnew^-1 Told world
            for fid in np.nonzero(gkf.mp_idx >= 0)[0]:
                pid = int(gkf.mp_idx[fid])
                if pid < 0 or pt.bad[pid] or pid in corrected_pts:
                    continue
                corrected_pts.add(pid)
                xc = R_old @ pt.pos[pid] + t_old
                pt.pos[pid] = R_new.T @ (xc - t_new)

        # merge matched loop points into the current KF
        for fid, pid_loop in matches.items():
            pid_cur = int(kf.mp_idx[fid])
            if pid_cur >= 0 and pid_cur != pid_loop and not pt.bad[pid_cur]:
                m.replace_point(pid_cur, pid_loop)
            elif pid_cur < 0 and not pt.bad[pid_loop]:
                m.add_observation(pid_loop, kf, fid)
        return live, nc_R, nc_t, group

    def _essential_graph_problem(self, kf: KeyFrame, cand_id: int, live,
                                 nc_R, nc_t):
        """The essential graph over the live keyframes of the correction's
        start (the new loop edge, spanning tree, strong covisibility, loop
        edges)."""
        m = self.map
        # the essential graph over all keyframes: vertices start at the
        # CURRENT (group-corrected) poses, measurements come from the
        # NON-corrected snapshot; only the new loop edge uses corrected ones
        index = {k.id: i for i, k in enumerate(live)}
        kf_R = np.stack([k.Rcw for k in live]).astype(np.float32)
        kf_t = np.stack([k.tcw for k in live]).astype(np.float32)
        fixed = np.zeros(len(live), bool)
        fixed[index[cand_id]] = True
        e_i, e_j, Rm, tm = [], [], [], []
        added = set()

        def add_edge(a, b, corrected=False):
            if a == b or (a, b) in added or (b, a) in added:
                return
            ia, ib = index.get(a), index.get(b)
            if ia is None or ib is None:
                return
            added.add((a, b))
            if corrected:
                Ra, ta, Rb, tb = kf_R[ia], kf_t[ia], kf_R[ib], kf_t[ib]
            else:
                Ra, ta, Rb, tb = nc_R[a], nc_t[a], nc_R[b], nc_t[b]
            Rrel = Rb @ Ra.T
            e_i.append(ia)
            e_j.append(ib)
            Rm.append(Rrel)
            tm.append(tb - Rrel @ ta)

        add_edge(kf.id, cand_id, corrected=True)   # the new loop edge
        for k in live:
            if k.parent is not None:
                add_edge(k.id, k.parent)
            for nid, wgt in k.covis.items():
                if wgt >= 100:
                    add_edge(k.id, nid)
            for lid in k.loop_edges:
                add_edge(k.id, lid)
        if len(e_i) < 2:
            return None
        return (index, kf_R, kf_t, fixed, np.asarray(e_i, np.int32),
                np.asarray(e_j, np.int32), Rm, tm)

    def _write_back_pose_graph(self, kf: KeyFrame, cand_id: int, index,
                               R0, t0, R_out, t_out):
        """Apply the essential-graph solution; keyframes the graph did not
        hold move with their parents, points with their reference
        keyframes."""
        m = self.map
        pt = m.points
        old_pose = {kid: (R0[i], t0[i]) for kid, i in index.items()}
        new_pose = {kid: (R_out[i], t_out[i]) for kid, i in index.items()}
        propagate_to_children(m, old_pose, new_pose)

        # points through their reference keyframes (batched)
        live = np.asarray(list(pt.live_ids()), np.int64)
        if live.size:
            ids_all = np.asarray(sorted(new_pose), np.int64)
            max_id = int(ids_all.max())
            lut = np.full(max_id + 2, -1, np.int64)
            lut[ids_all] = np.arange(len(ids_all))
            refs = pt.ref_kf[live].astype(np.int64)
            refs = np.where((refs >= 0) & (refs <= max_id), refs, max_id + 1)
            ki = lut[refs]
            sel = ki >= 0
            live, ki = live[sel], ki[sel]
            R_old = np.stack([old_pose[k][0] for k in ids_all])
            t_old = np.stack([old_pose[k][1] for k in ids_all])
            R_new = np.stack([new_pose[k][0] for k in ids_all])
            t_new = np.stack([new_pose[k][1] for k in ids_all])
            xc = np.einsum("nij,nj->ni", R_old[ki], pt.pos[live]) + t_old[ki]
            pt.pos[live] = np.einsum("nji,nj->ni", R_new[ki], xc - t_new[ki])
        for k in m.kfs.values():
            if not k.bad and k.id in new_pose:
                k.set_pose(*new_pose[k.id])

    # ---------------------------------------------------------------- run
    def process(self, kf: KeyFrame) -> bool:
        """DetectLoop -> ComputeSim3 -> CorrectLoop for one keyframe.  The
        caller must not hold the map lock: detection takes it, the Sim3
        computation and the correction take it around their host map
        sections."""
        with span(self.profiler, "loop.detect"), self._lockctx():
            cands = self.detect(kf)
        for cand in cands:
            with span(self.profiler, "loop.sim3"):
                res = self.compute_sim3(kf, cand)
            if res is not None:
                with span(self.profiler, "loop.correct"):
                    return self.correct(kf, res)
        return False
