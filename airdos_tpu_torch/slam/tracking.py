"""Tracking: the per-frame state machine, stereo.

Rebuild of the reference's Tracking (src/Tracking.cc) as airdos_tpu runs
it: init -> (fused motion-model | reference-KF) tracking ->
track-local-map -> keyframe decision -> close-point creation, handing each
new keyframe to the local mapper when there is one (``local_mapper=None``
is airdos_tpu's tracking-only configuration), then the human-pose
grabbing of the human layer.  Reference-KF tracking matches by BoW once
System has a keyframe database, else by a wide projection search.

Host Python owns the state machine and the integer bookkeeping; the dense
steps (front end, projection and BoW matching, EPnP RANSAC, pose LM) run
on the front end's torch device.  A LOST frame relocalizes: BoW
candidates -> SearchByBoW -> EPnP RANSAC -> pose LM -> projective
expansion, accepted at >= 50 inliers.  In localization-only mode
(``only_tracking``) no keyframe is inserted and the last frame's close
stereo features serve as temporary visual-odometry points (reference
Tracking::UpdateLastFrame).

Online, System wires ``mapping_idle_fn`` / ``mapping_queue_len_fn`` to the
mapping worker's queue (keyframe insertion waits on it) and installs a
``device_gate`` (utils/gate.py) held across the fused step's pack and
step; ``map_lock`` guards the host map sections: the fused path's prep
and associations, the keyframe decision and insertion, as in airdos_tpu,
and also the slow paths' local-map gathers and relocalization's candidate
query (airdos_tpu reads those unlocked; a worker inserting into a dict
or set they iterate would make the iteration raise).
"""
from __future__ import annotations

import contextlib
import enum
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.convert import desc_to_tensor, step_tables_to_device, \
    to_device
from airdos_tpu_torch.geometry.se3 import se3_exp_np, se3_log_np
from airdos_tpu_torch.matching.bow_match import match_by_bow
from airdos_tpu_torch.matching.projection import match_last_frame
from airdos_tpu_torch.parallel.sharded_ba import (make_mesh,
                                                  sharded_epnp_ransac)
from airdos_tpu_torch.slam.frame import Frame, FrontEnd
from airdos_tpu_torch.slam.fused import (local_map_step, make_full_track_step,
                                         motion_model_step)
from airdos_tpu_torch.slam.map import HumanPose, KeyFrame, SlamMap
from airdos_tpu_torch.solvers.epnp import epnp_ransac
from airdos_tpu_torch.solvers.pose_opt import pose_optimize
from airdos_tpu_torch.utils.obs import span


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class FrameRecord:
    """Per-frame trajectory bookkeeping (reference: mlRelativeFramePoses)."""
    __slots__ = ("Tcr_R", "Tcr_t", "ref_kf_id", "timestamp", "lost")

    def __init__(self, Tcr_R, Tcr_t, ref_kf_id, timestamp, lost):
        self.Tcr_R = Tcr_R
        self.Tcr_t = Tcr_t
        self.ref_kf_id = ref_kf_id
        self.timestamp = timestamp
        self.lost = lost


class Tracking:
    def __init__(self, config: SlamConfig, frontend: FrontEnd,
                 slam_map: SlamMap, local_mapper=None):
        self.config = config
        self.frontend = frontend
        self.device = frontend.device
        self.map = slam_map
        self.local_mapper = local_mapper
        self.state = TrackState.NO_IMAGES_YET

        cam = config.camera
        self.fx, self.fy = float(cam.fx), float(cam.fy)
        self.cx, self.cy = float(cam.cx), float(cam.cy)
        self.bf = float(cam.bf)
        self.baseline = cam.baseline
        self.width, self.height = cam.width, cam.height
        self.th_depth = config.th_depth_m
        self.min_frames = 0
        self.max_frames = max(1, int(round(cam.fps)))

        orb = config.orb
        self.scale_factors = np.asarray(
            [orb.scale_factor ** l for l in range(orb.n_levels)], np.float32)
        self.inv_sigma2 = (1.0 / (self.scale_factors ** 2)).astype(np.float32)
        self.log_scale = float(np.log(orb.scale_factor))
        self.n_levels = orb.n_levels
        opt = config.optimizer
        self.prior_w_rot = 1.0 / opt.motion_prior_sigma_rot ** 2 \
            if opt.motion_prior_sigma_rot > 0 else 0.0
        self.prior_w_trans = 1.0 / opt.motion_prior_sigma_t ** 2 \
            if opt.motion_prior_sigma_t > 0 else 0.0
        self._scale_factors_dev = to_device(self.scale_factors, self.device)
        # online mode wires these to the mapping worker's queue state
        # (reference LocalMapping::AcceptKeyFrames / KeyframesInQueue);
        # None = the synchronous offline pipeline, always idle
        self.mapping_idle_fn = None
        self.mapping_queue_len_fn = None
        self.map_lock = threading.Lock()  # tracking <-> worker threads
        self.device_gate = None          # online: utils/gate.TrackingGate
        # localization-only mode: track against the frozen map, never
        # insert keyframes (reference System::ActivateLocalizationMode,
        # System.cc:288-296; Tracking mbOnlyTracking)
        self.only_tracking = False
        # temporary VO points of the last frame: feature slot -> world pos
        self._vo_points: Dict[int, np.ndarray] = {}

        self.profiler = None             # set by System (per-stage spans)
        self.keyframe_db = None          # set by System once the vocab exists
        self._full_step = None           # built at the first fused frame
        self.last_frame: Optional[Frame] = None
        self.velocity: Optional[tuple] = None       # (R, t) of Tcl (cur<-last)
        self.last_branch = "none"                   # which track path ran
        self.last_kf_id = -1
        self.last_reloc_frame = -1e9
        self.reloc_tried = 0             # candidates the last attempt tried
        self._sharded_pnp = None         # n_chips > 1: built at first use
        self.reloc_inliers = 0           # its last EPnP RANSAC inlier count
        self.events = None               # set by System (its EventLog)
        self.records: List[FrameRecord] = []
        self.n_inliers = 0
        self.max_local_points = config.device.max_local_points

    # ================================================================ api
    def track(self, data) -> Frame:
        """Process one stereo frame (GrabImageStereo + OffLineTrack)."""
        frame = None
        fast_ok = None
        self._reanchor_last_frame()
        # the motion model is unusable right after relocalization (the
        # velocity spans a lost pose): reference-KF tracking for two frames
        # (reference Tracking.cc:587: mnId < mnLastRelocFrameId + 2)
        just_relocalized = data.index < self.last_reloc_frame + 2
        if self.state == TrackState.OK and self.velocity is not None \
                and not just_relocalized:
            frame, fast_ok = self._track_fast(data)
        if frame is None:
            frame = self.frontend.build_frame(data)

        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self.state = TrackState.NOT_INITIALIZED
            self._stereo_initialization(frame)
            self.last_branch = "init"
        else:
            if fast_ok is not None:
                ok = fast_ok
                self.last_branch = "fast"
                if not ok:
                    frame.mp_idx[:] = -1
                    ok = self._track_reference_keyframe(frame)
                    self.last_branch = "fast->ref"
                    if ok:
                        ok = self._track_local_map(frame)
            else:
                # the fused step ran no match (no velocity yet, or too few
                # live points in the last frame): the reference keyframe
                if self.state == TrackState.OK:
                    ok = self._track_reference_keyframe(frame)
                    self.last_branch = "ref"
                else:
                    ok = self._relocalization(frame)
                    self.last_branch = "reloc"
                if ok:
                    ok = self._track_local_map(frame)
            if ok:
                self.state = TrackState.OK
                self._update_velocity(frame)
                self._clean_vo_matches(frame)
                with span(self.profiler, "track.kf"), self.map_lock:
                    if not self.only_tracking and \
                            self._need_new_keyframe(frame):
                        self._create_new_keyframe(frame)
                    elif self.config.human.ok and frame.humans and \
                            not self.only_tracking and \
                            not self.config.optimizer.is_keyframe_only:
                        # IsKeyFrameOnly=0: human poses enter on EVERY
                        # tracked frame (reference Tracking.cc:493)
                        self._grab_human_poses(frame, kf=None)
                # mark outliers as free slots (reference: Track() end)
                frame.mp_idx[frame.outlier] = -1
            else:
                self.state = TrackState.LOST
                if self.map.n_keyframes() <= 5:
                    # lost right after init -> reset (reference Tracking.cc:508)
                    self._reset()

        self._record_frame(frame)
        frame.lost = self.state != TrackState.OK
        # Tlr (pose relative to the reference KF) lets the next step
        # re-anchor this frame if KF poses move (Tracking::UpdateLastFrame)
        ref = self.map.kfs.get(frame.ref_kf_id) \
            if frame.ref_kf_id is not None else None
        if ref is not None and not frame.lost:
            frame.Tlr = ((frame.Rcw @ ref.Rwc).astype(np.float32),
                         (frame.Rcw @ ref.Ow + frame.tcw).astype(np.float32))
        else:
            frame.Tlr = None
        self.last_frame = frame
        return frame

    def _reanchor_last_frame(self):
        """Tlw = Tlr * Trw (reference Tracking::UpdateLastFrame)."""
        lf = self.last_frame
        if lf is None or getattr(lf, "Tlr", None) is None:
            return
        ref = self.map.kfs.get(lf.ref_kf_id)
        if ref is None:
            return
        Rlr, tlr = lf.Tlr
        lf.set_pose(Rlr @ ref.Rcw, Rlr @ ref.tcw + tlr)

    # ======================================================== init / reset
    def _stereo_initialization(self, frame: Frame):
        if int(frame.valid.sum()) < 500:
            return
        frame.set_pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        kf = KeyFrame(self.map.next_kf_id, frame)
        self.map.next_kf_id += 1
        self.map.add_keyframe(kf)

        good = np.nonzero((frame.depth > 0) & frame.valid)[0]
        if len(good) < 50:
            self.map.kfs.pop(kf.id)
            return
        pids = self.map.create_points(kf, good, frame.unproject_features(good))
        frame.mp_idx[good] = pids
        frame.ref_kf_id = kf.id
        self.last_kf_id = kf.id
        if self.local_mapper is not None:
            self.local_mapper.recent_points.extend(pids.tolist())
        if self.config.human.ok and frame.humans:
            self._grab_human_poses(frame, kf=kf)
        self.state = TrackState.OK

    def _reset(self):
        self.map.__init__()
        self.state = TrackState.NOT_INITIALIZED
        self.velocity = None
        self.last_kf_id = -1
        self._vo_points = {}
        self.records = []
        if self.local_mapper is not None:
            self.local_mapper.recent_points = []

    # ==================================================== fused fast path
    def _candidate_arrays(self, frame: Frame, local_kfs: List[int]):
        """Padded local-map candidate tables: the points of the local
        keyframes that the frame has not matched yet."""
        pt = self.map.points
        matched = set(int(p) for p in frame.mp_idx[frame.mp_idx >= 0])
        cand, seen = [], set()
        for kf_id in local_kfs:
            kf = self.map.kfs.get(kf_id)
            if kf is None:
                continue
            for pid in kf.mp_idx[kf.mp_idx >= 0]:
                p = int(pid)
                if p in seen or p in matched or pt.bad[p]:
                    continue
                seen.add(p)
                cand.append(p)
        P = self.max_local_points        # fixed table size
        cand = cand[-P:] if len(cand) > P else cand
        n_c = len(cand)
        ids = np.asarray(cand, np.int64) if n_c else np.zeros(0, np.int64)
        xw = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        normal = np.zeros((P, 3), np.float32)
        mind = np.zeros(P, np.float32)
        maxd = np.zeros(P, np.float32)
        valid = np.zeros(P, bool)
        if n_c:
            xw[:n_c] = pt.pos[ids]
            desc[:n_c] = pt.desc32[ids]
            normal[:n_c] = pt.normal[ids]
            mind[:n_c] = pt.min_dist[ids]
            maxd[:n_c] = pt.max_dist[ids]
            valid[:n_c] = True
        return ids, xw, desc, valid, normal, maxd, mind

    def _gather_last_frame_points(self, lf: Frame):
        """World positions and validity over the last frame's slots: its
        live map points (current optimized positions), then the temporary
        VO points on the slots left."""
        n = lf.n_slots
        xw = np.zeros((n, 3), np.float32)
        valid = np.zeros(n, bool)
        pt = self.map.points
        ids = np.nonzero(lf.mp_idx >= 0)[0]
        if len(ids):
            pids = lf.mp_idx[ids]
            live = ~pt.bad[pids]
            xw[ids[live]] = pt.pos[pids[live]]
            valid[ids[live]] = True
        for fid, pos in self._vo_points.items():
            if not valid[fid]:
                xw[fid] = pos
                valid[fid] = True
        return xw, valid

    def _last_frame_descriptors(self, lf: Frame, valid_p: np.ndarray):
        """Descriptors over the last frame's slots and which slots hold a
        real map point: a map point's own descriptor, a VO point's the
        frame's feature descriptor."""
        pt = self.map.points
        desc_p = np.zeros((lf.n_slots, 8), np.uint32)
        real_p = np.zeros(lf.n_slots, bool)
        has_mp = lf.mp_idx >= 0
        mp_rows = np.nonzero(has_mp & valid_p)[0]
        desc_p[mp_rows] = pt.desc32[lf.mp_idx[mp_rows]]
        real_p[mp_rows] = True
        vo_rows = [i for i in self._vo_points if not has_mp[i]]
        if vo_rows:
            desc_p[vo_rows] = lf.desc32[vo_rows]
        return desc_p, real_p

    def _update_last_frame_vo_points(self):
        """Temporary close-depth points of the last frame (reference
        Tracking::UpdateLastFrame's visual-odometry points), made only in
        localization-only mode: in mapping mode every association must be
        a real, BA-corrected map point (see airdos_tpu's Tracking for the
        drift this avoids)."""
        self._vo_points = {}
        lf = self.last_frame
        if not self.only_tracking:
            return
        if lf is None or lf.ref_kf_id is None:
            return
        if lf.index == self._kf_frame_index():
            return      # the last frame became a keyframe: its points are real
        depths = lf.depth
        cand = np.nonzero((depths > 0) & lf.valid & (lf.mp_idx < 0))[0]
        if len(cand) == 0:
            return
        order = cand[np.argsort(depths[cand])]
        n_close = 0
        for fid in order:
            if depths[fid] > self.th_depth and n_close >= 100:
                break
            self._vo_points[int(fid)] = lf.unproject_feature(int(fid))
            n_close += 1

    def _decode_vo(self, code: int) -> int:
        return -2 - code

    def _track_fast(self, data):
        """One fused device step for front-end + motion + local-map tracking."""
        lf = self.last_frame
        if lf is None:
            return None, None
        if self._full_step is None:
            self._full_step = make_full_track_step(self.frontend, self.config)

        # online, holding the gate across the prep, pack and step windows
        # keeps the workers' launch loops out of the tracking thread's
        # window (utils/gate.py): also while prep waits for the map lock,
        # so the lock's holder does not share the host with a background
        # solve meanwhile; the handoffs between the windows do not yield
        gate = self.device_gate if self.device_gate is not None \
            else contextlib.nullcontext()
        with gate, span(self.profiler, "track.prep"), self.map_lock:
            self._update_last_frame_vo_points()
            xw_p, valid_p = self._gather_last_frame_points(lf)
            if valid_p.sum() < 10:
                return None, None
            desc_p, real_p = self._last_frame_descriptors(lf, valid_p)
            pt = self.map.points
            saved_ref = lf.ref_kf_id
            local_kfs = self._local_keyframes(lf)
            lf.ref_kf_id = saved_ref
            ids, xw_c, desc_c, valid_c, normal_c, maxd_c, mind_c = \
                self._candidate_arrays(lf, local_kfs)

        with gate, span(self.profiler, "track.pack"):
            Rv, tv = self.velocity
            Rp = (Rv @ lf.Rcw).astype(np.float32)
            tp = (Rv @ lf.tcw + tv).astype(np.float32)
            ow_pred = -Rp.T @ tp
            t_lc = lf.Rcw @ (ow_pred - lf.Ow)
            forward = bool(t_lc[2] > self.baseline)
            backward = bool(-t_lc[2] > self.baseline)

            prior_pack = np.concatenate([Rp.reshape(-1), tp]).astype(np.float32)
            last_f32 = np.zeros((lf.n_slots, 8), np.float32)
            last_f32[:, 0:3] = xw_p
            last_f32[:, 3] = lf.angle
            last_f32[:, 4] = lf.octave
            last_f32[:, 5] = valid_p
            last_f32[:, 6] = real_p
            cand_f32 = np.zeros((xw_c.shape[0], 9), np.float32)
            cand_f32[:, 0:3] = xw_c
            cand_f32[:, 3:6] = normal_c
            cand_f32[:, 6] = maxd_c
            cand_f32[:, 7] = mind_c
            cand_f32[:, 8] = valid_c

        with gate, span(self.profiler, "track.step"):
            torso_px, want_disp = self.frontend.disparity_probes(data)
            tables = step_tables_to_device(last_f32, desc_p, cand_f32, desc_c,
                                           self.device)
            host = self._full_step(*self.frontend.uploads(data), torso_px,
                                   to_device(prior_pack, self.device),
                                   *tables, forward, backward, want_disp)
        frame = Frame.from_track_result(self.frontend, data, host)
        sc = host.scalars
        frame.set_pose(sc[:9].reshape(3, 3), sc[9:12])

        n_motion = int(sc[12])
        n_inliers = int(sc[13])
        if n_motion < 20:
            return frame, False

        with span(self.profiler, "track.assoc"), self.map_lock:
            # motion matches: last-frame slots -> map points or VO points
            mp_idx = frame.mp_idx
            mpof = host.feat_i32[:, 2]
            for fid in np.nonzero(mpof >= 0)[0]:
                src = mpof[fid]
                pid = lf.mp_idx[src]
                if pid >= 0 and not pt.bad[pid]:
                    mp_idx[fid] = pid
                elif src in self._vo_points:
                    mp_idx[fid] = -2 - src
            lpof = host.feat_i32[:, 3]
            new_rows = np.nonzero(lpof >= 0)[0]
            if len(new_rows) and len(ids):
                mp_idx[new_rows] = ids[lpof[new_rows]]
            drop = np.nonzero(lpof == -2)[0]
            frame.outlier = np.zeros(frame.n_slots, bool)
            frame.outlier[drop] = True
            mp_idx[drop] = -1

            if len(ids):
                pt.visible[ids] += 1
            found_rows = np.nonzero(mp_idx >= 0)[0]
            if len(found_rows):
                pt.found[mp_idx[found_rows]] += 1
            self.n_inliers = n_inliers
            self._local_keyframes(frame)     # sets frame.ref_kf_id
            ok = n_inliers >= 30 or (self.map.n_keyframes() <= 2
                                     and n_inliers >= 15)
        return frame, ok

    # =================================================== reference-KF track
    def _run_motion_step(self, frame, src_frame, xw, desc_p, real_p, valid_p,
                         th, forward, backward):
        d = self.device
        fd = frame.dev
        out = motion_model_step(
            to_device(xw, d), desc_to_tensor(desc_p, d),
            to_device(src_frame.octave, d, np.int64),
            to_device(src_frame.angle, d, np.float32),
            to_device(valid_p, d), to_device(real_p, d),
            to_device(frame.Rcw, d, np.float32), to_device(frame.tcw, d, np.float32),
            fd["xy_un"], fd["u_right"], fd["octave"], fd["angle"],
            fd["desc32"], fd["valid"],
            to_device(self.inv_sigma2[frame.octave], d),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            self.width, self.height,
            self._scale_factors_dev, th, forward, backward,
            self.prior_w_rot, self.prior_w_trans)
        return int(out.n_matches), (out.R.cpu().numpy(), out.t.cpu().numpy(),
                                    out.point_of_feat.cpu().numpy(),
                                    int(out.n_real_inliers))

    def _frame_nodes(self, frame: Frame) -> np.ndarray:
        """Per-feature vocabulary node ids at the grouping level (lazily
        computed and cached on the frame; Frame::ComputeBoW semantics)."""
        nodes = getattr(frame, "feat_nodes", None)
        if nodes is None:
            _, _, nodes = self.keyframe_db.voc.transform(frame.desc32,
                                                         frame.valid)
            frame.feat_nodes = nodes
        return nodes

    def _track_reference_keyframe(self, frame: Frame) -> bool:
        """SearchByBoW against the reference KF + motion-only pose opt
        (reference Tracking::TrackReferenceKeyFrame, Tracking.cc:827-869;
        ORBmatcher::SearchByBoW KF<->Frame, ORBmatcher.cc:159-288).  Without
        a vocabulary it is the wide projection search from the reference
        KF's points, as in airdos_tpu."""
        if frame.ref_kf_id is None:
            frame.ref_kf_id = self.last_kf_id
        kf = self.map.kfs.get(self.last_kf_id)
        if kf is None:
            return False
        if self.keyframe_db is not None:
            return self._track_ref_kf_bow(frame, kf)
        return self._track_ref_kf_projection(frame, kf)

    def _track_ref_kf_bow(self, frame: Frame, kf) -> bool:
        pt = self.map.points
        self.keyframe_db.ensure_bow(kf)
        fnodes = self._frame_nodes(frame)
        d = self.device
        fd = frame.dev
        m = match_by_bow(
            desc_to_tensor(kf.desc32, d), to_device(kf.feat_nodes, d, np.int64),
            to_device(kf.valid & (kf.mp_idx >= 0), d),
            to_device(kf.angle, d, np.float32),
            fd["desc32"], to_device(fnodes, d, np.int64), fd["valid"],
            fd["angle"])
        idx2 = m.idx2.cpu().numpy()
        n_matches = 0
        for f1 in np.nonzero(idx2 >= 0)[0]:
            pid = int(kf.mp_idx[f1])
            if pid >= 0 and not pt.bad[pid]:
                frame.mp_idx[int(idx2[f1])] = pid
                n_matches += 1
        if n_matches < 15:
            frame.mp_idx[:] = -1
            return False
        frame.set_pose(self.last_frame.Rcw, self.last_frame.tcw)
        n_real = self._opt_pose_with_assoc(frame)
        return n_real >= 10

    def _track_ref_kf_projection(self, frame: Frame, kf) -> bool:
        frame.set_pose(self.last_frame.Rcw, self.last_frame.tcw)
        xw = np.zeros((kf.n_slots, 3), np.float32)
        valid = np.zeros(kf.n_slots, bool)
        pt = self.map.points
        rows = np.nonzero(kf.mp_idx >= 0)[0]
        if len(rows) == 0:
            return False
        pids = kf.mp_idx[rows]
        live = ~pt.bad[pids]
        xw[rows[live]] = pt.pos[pids[live]]
        valid[rows[live]] = True
        desc_p = np.zeros((kf.n_slots, 8), np.uint32)
        desc_p[rows[live]] = pt.desc32[pids[live]]
        n, res = self._run_motion_step(frame, kf, xw, desc_p, valid.copy(),
                                       valid, 15.0, False, False)
        if n < 15:
            return False
        R, t, pof, n_real = res
        frame.set_pose(R, t)
        for fid in np.nonzero(pof >= 0)[0]:
            pid = kf.mp_idx[pof[fid]]
            if pid >= 0 and not pt.bad[pid]:
                frame.mp_idx[fid] = pid
        return n_real >= 10

    def _relocalization(self, frame: Frame) -> bool:
        """BoW candidate retrieval + EPnP-RANSAC + pose refinement
        (reference Tracking::Relocalization, Tracking.cc:1493-1654),
        falling back to reference-KF tracking when there is no database."""
        if self.keyframe_db is not None and self.map.kfs:
            if self._relocalize_bow(frame):
                self.last_reloc_frame = frame.index
                if self.events is not None:
                    self.events.emit("relocalized", frame=frame.index,
                                     ref_kf=frame.ref_kf_id)
                return True
        if self.last_frame is None:
            return False
        return self._track_reference_keyframe(frame)

    def _relocalize_bow(self, frame: Frame) -> bool:
        """The reference protocol: BoW candidates -> per candidate
        SearchByBoW >= 15 -> EPnP RANSAC -> pose opt -> projective
        expansion at 10 px / ORB distance 100 when < 50 inliers -> re-opt
        -> a narrow 3 px / 64 expansion when still 30..50 -> accepted only
        with >= 50 inliers.  The RANSAC samples come from
        np.random.default_rng(frame index), as in airdos_tpu.  With
        Device.NChips > 1 the hypotheses are sharded over a mesh of that
        many ranks (parallel/sharded_ba.sharded_epnp_ransac, built once;
        their count rounded up to a multiple of the mesh), as airdos_tpu
        shards them."""
        n_chips = self.config.device.n_chips
        if n_chips > 1 and self._sharded_pnp is None:
            self._sharded_pnp = sharded_epnp_ransac(
                make_mesh(n_chips, self.device))
        pnp = self._sharded_pnp or epnp_ransac
        n_hyp = self.config.device.ransac_hypotheses
        if n_chips > 1:
            n_hyp = -(-n_hyp // n_chips) * n_chips
        db = self.keyframe_db
        bow, _, fnodes = db.voc.transform(frame.desc32, frame.valid)
        frame.feat_nodes = fnodes
        with self.map_lock:
            cands = db.detect_reloc_candidates(bow)
        pt = self.map.points
        rng = np.random.default_rng(frame.index)
        d = self.device
        fd = frame.dev
        self.reloc_tried = 0
        self.reloc_inliers = 0
        # every candidate until one passes (Tracking.cc:1516-1654)
        for kid in cands:
            kf = self.map.kfs.get(kid)
            if kf is None or kf.bad:
                continue
            self.reloc_tried += 1
            db.ensure_bow(kf)
            m = match_by_bow(
                desc_to_tensor(kf.desc32, d),
                to_device(kf.feat_nodes, d, np.int64), to_device(kf.valid, d),
                to_device(kf.angle, d, np.float32),
                fd["desc32"], to_device(fnodes, d, np.int64), fd["valid"],
                fd["angle"])
            idx2 = m.idx2.cpu().numpy()
            rows = []
            for f1 in np.nonzero(idx2 >= 0)[0]:
                pid = int(kf.mp_idx[f1])
                if pid >= 0 and not pt.bad[pid]:
                    rows.append((pid, int(idx2[f1])))
            if len(rows) < 15:
                continue
            n = len(rows)
            pw = pt.pos[[r[0] for r in rows]].astype(np.float32)
            feat_ids = np.asarray([r[1] for r in rows])
            uv = frame.xy_un[feat_ids].astype(np.float32)
            max_err2 = (5.991 / self.inv_sigma2[frame.octave[feat_ids]]) \
                .astype(np.float32)
            samples = rng.integers(0, n, (n_hyp, 4)).astype(np.int32)
            res = pnp(to_device(pw, d), to_device(uv, d),
                      torch.ones(n, dtype=torch.bool, device=d),
                      to_device(max_err2, d), to_device(samples, d),
                      self.fx, self.fy, self.cx, self.cy)
            flat = torch.cat([res.R.reshape(-1), res.t,
                              res.inliers.to(res.t.dtype)]).cpu().numpy()
            inl = flat[12:] > 0.5
            self.reloc_inliers = int(inl.sum())
            if int(inl.sum()) < 10:
                continue
            frame.mp_idx[:] = -1
            frame.set_pose(flat[:9].reshape(3, 3), flat[9:12])
            for (pid, fid), keep in zip(rows, inl):
                if keep:
                    frame.mp_idx[fid] = pid
            n_good = self._opt_pose_with_assoc(frame)
            if n_good < 10:
                frame.mp_idx[:] = -1
                continue
            if n_good < 50:
                # first projective expansion: 10 px window, ORB dist 100
                added = self._reloc_expand(frame, kf, th=10.0, orb_dist=100)
                if n_good + added >= 50:
                    n_good = self._opt_pose_with_assoc(frame)
                    if 30 < n_good < 50:
                        # narrow second expansion: 3 px window, ORB dist 64
                        self._reloc_expand(frame, kf, th=3.0, orb_dist=64)
                        n_good = self._opt_pose_with_assoc(frame)
            if n_good >= 50:
                frame.ref_kf_id = kid
                return True
            frame.mp_idx[:] = -1
        return False

    def _reloc_expand(self, frame: Frame, kf, th: float, orb_dist: int) -> int:
        """Project the candidate KF's map points not yet matched into the
        frame and add matches within th px and Hamming <= orb_dist
        (ORBmatcher::SearchByProjection's relocalization variant,
        ORBmatcher.cc:1472-1599)."""
        pt = self.map.points
        already = set(int(p) for p in frame.mp_idx[frame.mp_idx >= 0])
        xw = np.zeros((kf.n_slots, 3), np.float32)
        valid = np.zeros(kf.n_slots, bool)
        desc_p = np.zeros((kf.n_slots, 8), np.uint32)
        for fid in np.nonzero(kf.mp_idx >= 0)[0]:
            pid = int(kf.mp_idx[fid])
            if pid in already or pt.bad[pid]:
                continue
            xw[fid] = pt.pos[pid]
            desc_p[fid] = pt.desc32[pid]
            valid[fid] = True
        if not valid.any():
            return 0
        d = self.device
        fd = frame.dev
        out = match_last_frame(
            to_device(xw, d), desc_to_tensor(desc_p, d),
            to_device(kf.octave, d, np.int64),
            to_device(kf.angle, d, np.float32), to_device(valid, d),
            to_device(frame.Rcw, d, np.float32),
            to_device(frame.tcw, d, np.float32),
            fd["xy_un"], fd["u_right"], fd["octave"], fd["angle"],
            fd["desc32"], to_device(frame.valid, d),
            to_device(frame.mp_idx >= 0, d),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            self.width, self.height,
            self._scale_factors_dev, th, False, False)
        both = torch.stack([out.feat_idx, out.dist.to(torch.int64)]) \
            .cpu().numpy()
        feat_idx, dist = both[0], both[1]
        added = 0
        for src in np.nonzero(feat_idx >= 0)[0]:
            if dist[src] > orb_dist:
                continue
            pid = int(kf.mp_idx[src])
            fid = int(feat_idx[src])
            if pid >= 0 and not pt.bad[pid] and frame.mp_idx[fid] < 0:
                frame.mp_idx[fid] = pid
                added += 1
        return added

    def _opt_pose_with_assoc(self, frame: Frame) -> int:
        """Motion-only BA over the frame's current associations; outliers
        lose their association.  Returns the inlier count."""
        pt = self.map.points
        n = frame.n_slots
        xw = np.zeros((n, 3), np.float32)
        valid = np.zeros(n, bool)
        rows = np.nonzero(frame.mp_idx >= 0)[0]
        if len(rows) < 6:
            return 0
        pids = frame.mp_idx[rows]
        live = ~pt.bad[pids]
        xw[rows[live]] = pt.pos[pids[live]]
        valid[rows[live]] = True
        obs = np.concatenate([frame.xy_un, frame.u_right[:, None]],
                             axis=1).astype(np.float32)
        d = self.device
        res = pose_optimize(
            to_device(frame.Rcw, d, np.float32),
            to_device(frame.tcw, d, np.float32), to_device(xw, d),
            to_device(obs, d), to_device(self.inv_sigma2[frame.octave], d),
            to_device(valid, d), self.fx, self.fy, self.cx, self.cy, self.bf)
        flat = torch.cat([res.R.reshape(-1), res.t,
                          res.inlier.to(res.t.dtype)]).cpu().numpy()
        inlier = flat[12:] > 0.5
        frame.set_pose(flat[:9].reshape(3, 3), flat[9:12])
        frame.mp_idx[valid & ~inlier] = -1
        return int(inlier.sum())

    # ======================================================= local map
    def _local_keyframes(self, frame: Frame) -> List[int]:
        votes: Dict[int, int] = {}
        pt = self.map.points
        for fid in np.nonzero(frame.mp_idx >= 0)[0]:
            pid = frame.mp_idx[fid]
            if pid < 0 or pt.bad[pid]:
                continue
            for kf_id in pt.obs[pid]:
                votes[kf_id] = votes.get(kf_id, 0) + 1
        if not votes:
            return []
        local = sorted(votes, key=lambda k: -votes[k])
        best = local[0]
        out = list(local[:80])
        seen = set(out)
        for kf_id in list(out):
            kf = self.map.kfs.get(kf_id)
            if kf is None:
                continue
            for nb in kf.best_covisible(10):
                if nb not in seen and not self.map.kfs[nb].bad:
                    out.append(nb)
                    seen.add(nb)
                    break
            for ch in kf.children:
                if ch not in seen:
                    out.append(ch)
                    seen.add(ch)
                    break
            if kf.parent is not None and kf.parent not in seen:
                out.append(kf.parent)
                seen.add(kf.parent)
            if len(out) >= 80:
                break
        frame.ref_kf_id = best
        return out[:80]

    def _track_local_map(self, frame: Frame) -> bool:
        with self.map_lock:
            local_kfs = self._local_keyframes(frame)
            if not local_kfs:
                return False
            pt = self.map.points
            ids, xw, desc, valid, normal, maxd, mind = \
                self._candidate_arrays(frame, local_kfs)
            n_c = len(ids)

            # existing associations (map and VO points) by feature slot
            n = frame.n_slots
            exist_xw = np.zeros((n, 3), np.float32)
            exist_valid = np.zeros(n, bool)
            exist_real = np.zeros(n, bool)
            mp_rows = np.nonzero(frame.mp_idx >= 0)[0]
            if len(mp_rows):
                pids = frame.mp_idx[mp_rows]
                live = ~pt.bad[pids]
                exist_xw[mp_rows[live]] = pt.pos[pids[live]]
                exist_valid[mp_rows[live]] = True
                exist_real[mp_rows[live]] = True
            for fid in np.nonzero(frame.mp_idx <= -2)[0]:
                src = self._decode_vo(frame.mp_idx[fid])
                if src in self._vo_points:
                    exist_xw[fid] = self._vo_points[src]
                    exist_valid[fid] = True

        d = self.device
        fd = frame.dev
        out = local_map_step(
            to_device(xw, d), desc_to_tensor(desc, d), to_device(valid, d),
            to_device(normal, d), to_device(maxd, d), to_device(mind, d),
            to_device(exist_xw, d), to_device(exist_valid, d),
            to_device(exist_real, d),
            to_device(frame.Rcw, d, np.float32), to_device(frame.tcw, d, np.float32),
            to_device(frame.Ow, d, np.float32),
            fd["xy_un"], fd["u_right"], fd["octave"], fd["desc32"], fd["valid"],
            to_device(self.inv_sigma2[frame.octave], d),
            self.fx, self.fy, self.cx, self.cy, self.bf,
            self.width, self.height,
            self._scale_factors_dev, self.log_scale, self.n_levels, 1.0,
            self.prior_w_rot, self.prior_w_trans)
        frame.set_pose(out.R.cpu().numpy(), out.t.cpu().numpy())
        pof = out.point_of_feat.cpu().numpy()
        n_inliers = int(out.n_real_inliers)
        new_rows = np.nonzero(pof >= 0)[0]
        if len(new_rows) and n_c:
            frame.mp_idx[new_rows] = ids[pof[new_rows]]
        drop = np.nonzero(pof == -2)[0]
        frame.outlier = np.zeros(n, bool)
        frame.outlier[drop] = True
        frame.mp_idx[drop] = -1
        with self.map_lock:
            if n_c:
                pt.visible[ids] += 1
            inl = np.nonzero(frame.mp_idx >= 0)[0]
            if len(inl):
                pt.found[frame.mp_idx[inl]] += 1
        self.n_inliers = n_inliers
        return n_inliers >= 30 or (self.map.n_keyframes() <= 2 and n_inliers >= 15)

    # ======================================================= keyframing
    def _clean_vo_matches(self, frame: Frame):
        frame.mp_idx[frame.mp_idx <= -2] = -1

    def _tracked_close(self, frame: Frame):
        close = (frame.depth > 0) & (frame.depth < self.th_depth) & frame.valid
        tracked = close & (frame.mp_idx >= 0) & ~frame.outlier
        untracked = close & (frame.mp_idx < 0)
        return int(tracked.sum()), int(untracked.sum())

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """NeedNewKeyFrame (reference Tracking.cc:1065-1125).  Offline the
        mapping pass runs inline, so local mapping is always idle; online
        ``mapping_idle_fn`` says whether the worker has drained its queue
        (reference LocalMapping::AcceptKeyFrames)."""
        n_kfs = self.map.n_keyframes()
        ref = self.map.kfs.get(frame.ref_kf_id if frame.ref_kf_id is not None
                               else self.last_kf_id)
        if ref is None:
            return False
        min_obs = 3 if n_kfs > 2 else 2
        pt = self.map.points
        rows = ref.mp_idx[ref.mp_idx >= 0]
        ref_matches = int(((pt.n_obs[rows] >= min_obs) & ~pt.bad[rows]).sum()) \
            if len(rows) else 0
        n_close, n_unclose = self._tracked_close(frame)
        need_close = (n_close < 100) and (n_unclose > 70)
        # "stereo_sharp" keeps thRefRatio 0.75 from the start; "reference"
        # follows Tracking.cc:1091 (see airdos_tpu's Tracking for why)
        if self.config.optimizer.kf_ref_schedule == "reference":
            th_ref = 0.4 if n_kfs < 2 else 0.75
        else:
            th_ref = 0.75
        frames_since = frame.index - self._kf_frame_index()
        idle = self.mapping_idle_fn() if self.mapping_idle_fn else True
        c1a = frames_since >= self.max_frames
        # c1b requires local mapping idle (Tracking.cc:1101)
        c1b = frames_since >= self.min_frames and idle
        c1c = self.n_inliers < ref_matches * 0.25 or need_close
        c2 = (self.n_inliers < ref_matches * th_ref or need_close) and \
            self.n_inliers > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        if idle:
            return True
        # mapping busy: stereo inserts only while the queue is short
        # (Tracking.cc:1112-1121, KeyframesInQueue() < 3)
        qlen = self.mapping_queue_len_fn() if self.mapping_queue_len_fn \
            else 0
        return qlen < 3

    def _kf_frame_index(self) -> int:
        kf = self.map.kfs.get(self.last_kf_id)
        return kf.frame_id if kf is not None else -10

    def _create_new_keyframe(self, frame: Frame):
        kf = KeyFrame(self.map.next_kf_id, frame)
        self.map.next_kf_id += 1
        self.map.add_keyframe(kf)
        frame.ref_kf_id = kf.id
        self.last_kf_id = kf.id

        pt = self.map.points
        for fid in np.nonzero(frame.mp_idx >= 0)[0]:
            pid = int(frame.mp_idx[fid])
            if pid >= 0 and not pt.bad[pid]:
                self.map.add_observation(pid, kf, int(fid))

        # create close-depth points (sorted by depth, >= 100)
        depths = frame.depth
        cand = np.nonzero((depths > 0) & frame.valid & (frame.mp_idx < 0))[0]
        if len(cand):
            order = cand[np.argsort(depths[cand])]
            created = []
            for fid in order:
                if depths[fid] > self.th_depth and len(created) >= 100:
                    break
                created.append(int(fid))
            if created:
                ids = np.asarray(created)
                pids = self.map.create_points(kf, ids,
                                              frame.unproject_features(ids))
                frame.mp_idx[ids] = pids
                if self.local_mapper is not None:
                    self.local_mapper.recent_points.extend(pids.tolist())

        if self.local_mapper is not None:
            self.local_mapper.process_new_keyframe(kf)
        else:
            self.map.update_connections(kf)

        if self.config.human.ok and frame.humans:
            self._grab_human_poses(frame, kf=kf)

    # ========================================================== humans
    def _grab_human_poses(self, frame: Frame, kf: Optional[KeyFrame]):
        """GrabHumanPoseKF / GrabHumanPose (Tracking.cc:1221-1293)."""
        vis = []
        ref_id = kf.id if kf is not None else \
            (frame.ref_kf_id if frame.ref_kf_id is not None else self.last_kf_id)
        for obs in frame.humans:
            hp = HumanPose(
                track_id=obs.track_id, timestamp=frame.timestamp,
                kf_id=ref_id,
                joints_w=frame.unproject_human(obs).astype(np.float32),
                bad=obs.bad.copy(), lost=np.zeros(18, bool),
                optimized=np.zeros(18, bool),
                obs_uvd=np.concatenate(
                    [obs.kp_left, obs.kp_right[:, :1], obs.depth[:, None]],
                    axis=1).astype(np.float32),
                confidence=obs.conf_left.copy(),
                in_keyframe=kf is not None)
            if obs.track_id >= 0:
                self.map.add_human_pose(hp)
                vis.append(obs.track_id)
        self.map.current_track_ids = vis

    # ========================================================== misc
    def _update_velocity(self, frame: Frame):
        lf = self.last_frame
        # a lost last frame carries a garbage pose: no usable velocity
        if lf is None or getattr(lf, "lost", False):
            self.velocity = None
            return
        R = frame.Rcw @ lf.Rwc
        t = frame.Rcw @ lf.Ow + frame.tcw
        # damped constant-velocity model (OptimizerConfig.velocity_damping;
        # see airdos_tpu's Tracking._update_velocity for the measurement)
        a = float(self.config.optimizer.velocity_damping)
        if a < 1.0:
            R, t = se3_exp_np(a * se3_log_np(R, t))
        self.velocity = (R.astype(np.float32), t.astype(np.float32))

    def _record_frame(self, frame: Frame):
        lost = self.state != TrackState.OK
        # while LOST, repeat the last relative pose (Tracking.cc:533-540)
        if lost or frame.ref_kf_id is None \
                or frame.ref_kf_id not in self.map.kfs:
            if self.records:
                prev = self.records[-1]
                self.records.append(FrameRecord(prev.Tcr_R, prev.Tcr_t,
                                                prev.ref_kf_id, frame.timestamp,
                                                True))
            return
        ref = self.map.kfs[frame.ref_kf_id]
        R = frame.Rcw @ ref.Rwc
        t = frame.Rcw @ ref.Ow + frame.tcw
        self.records.append(FrameRecord(R.copy(), t.copy(), ref.id,
                                        frame.timestamp, lost))

    # ------------------------------------------------------------ export
    def trajectory_tum(self):
        """Camera trajectory via relative-pose chaining over (possibly
        re-optimized) keyframe poses (System::SaveTrajectoryTUM semantics).
        A record whose reference keyframe was culled walks up the spanning
        tree through each culled keyframe's Tcp, accumulating
        T = Tcp_1 * Tcp_2 * ... on the right (reference System.cc:371:
        Trw = Trw * pKF->mTcp)."""
        ts, Rwcs, twcs = [], [], []
        for rec in self.records:
            kf = self.map.kfs.get(rec.ref_kf_id)
            if kf is None:
                continue
            Rrel = np.eye(3, dtype=np.float32)
            trel = np.zeros(3, np.float32)
            while kf.bad and kf.parent is not None and kf.Tcp is not None:
                Rt, tt = kf.Tcp
                Rrel, trel = Rrel @ Rt, Rrel @ tt + trel
                kf = self.map.kfs[kf.parent]
            # unchained, Rrel and trel are exact identities and this is
            # Tcr * Trw bit for bit.  (airdos_tpu drops trel where Rrel is
            # within 1e-8 of the identity; here it is always applied.)
            Rcw = rec.Tcr_R @ Rrel @ kf.Rcw
            tcw = rec.Tcr_R @ (Rrel @ kf.tcw + trel) + rec.Tcr_t
            ts.append(rec.timestamp)
            Rwcs.append(Rcw.T)
            twcs.append(-Rcw.T @ tcw)
        return np.asarray(ts), np.asarray(Rwcs), np.asarray(twcs)
