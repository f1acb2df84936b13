"""Local mapping steps, run synchronously per keyframe in offline mode
(reference: src/LocalMapping.cc driven inline by Tracking::OffLineTrack,
src/Tracking.cc:689-720).

- process_new_keyframe: observation fix-up, distinctive descriptors, normal
  updates, covisibility update (LocalMapping.cc:142-182)
- cull_map_points: found-ratio < 0.25 or too few observations after 2 KFs
  (LocalMapping.cc:184-219)
- cull_keyframes: 90%-redundancy rule (LocalMapping.cc:646-711)

Triangulation of new far points (CreateNewMapPoints) and duplicate fusion
(SearchInNeighbors) are device kernels in matching/epipolar.py and
matching/fuse.py wired in here.
"""
from __future__ import annotations

from typing import List

import numpy as np

from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.slam.map import KeyFrame, SlamMap


class LocalMapper:
    def __init__(self, config: SlamConfig, slam_map: SlamMap):
        self.config = config
        self.map = slam_map
        # recently created points pending culling checks: (pid, first_kf_id)
        self.recent_points: List[int] = []
        self.triangulator = None     # set by System once kernels exist
        self.fuser = None
        self.keyframe_db = None      # set by System with place recognition

    # ------------------------------------------------------------------
    def process_new_keyframe(self, kf: KeyFrame):
        pt = self.map.points
        for fid in np.nonzero(kf.mp_idx >= 0)[0]:
            pid = int(kf.mp_idx[fid])
            if pid < 0 or pt.bad[pid]:
                continue
            if kf.id not in pt.obs[pid]:
                self.map.add_observation(pid, kf, int(fid))
            self.map.update_point_descriptor(pid)
            self.map.update_point_normal_depth(pid)
        self.map.update_connections(kf)

    # ------------------------------------------------------------------
    def cull_map_points(self, current_kf_id: int):
        pt = self.map.points
        keep: List[int] = []
        for pid in self.recent_points:
            if pt.bad[pid]:
                continue
            found_ratio = pt.found[pid] / max(1, pt.visible[pid])
            age = current_kf_id - pt.first_kf[pid]
            if found_ratio < 0.25:
                self.map.set_point_bad(pid)
            elif age >= 2 and pt.n_obs[pid] <= 3:   # stereo: cnThObs = 3
                self.map.set_point_bad(pid)
            elif age >= 3:
                pass        # survived probation; drop from the watch list
            else:
                keep.append(pid)
        self.recent_points = keep

    # ------------------------------------------------------------------
    def create_new_points(self, kf: KeyFrame):
        if self.triangulator is not None:
            self.triangulator(kf)

    def fuse_neighbors(self, kf: KeyFrame):
        if self.fuser is not None:
            self.fuser(kf)

    # ------------------------------------------------------------------
    def cull_keyframes(self, kf: KeyFrame):
        """Erase local covisible KFs whose points are >= 90% seen by >= 3
        other KFs at the same or finer scale."""
        pt = self.map.points
        for kf_id in list(kf.ordered_covis):
            ckf = self.map.kfs.get(kf_id)
            if ckf is None or ckf.bad or ckf.id == 0:
                continue
            n_pts = 0
            n_redundant = 0
            for fid in np.nonzero(ckf.mp_idx >= 0)[0]:
                pid = int(ckf.mp_idx[fid])
                if pid < 0 or pt.bad[pid]:
                    continue
                if ckf.depth[fid] > self.config.th_depth_m or ckf.depth[fid] < 0:
                    continue
                n_pts += 1
                if pt.n_obs[pid] <= 3:
                    continue
                level = ckf.octave[fid]
                n_better = 0
                for okf_id, ofid in pt.obs[pid].items():
                    if okf_id == ckf.id:
                        continue
                    okf = self.map.kfs.get(okf_id)
                    if okf is None or okf.bad:
                        continue
                    if okf.octave[ofid] <= level + 1:
                        n_better += 1
                        if n_better >= 3:
                            break
                if n_better >= 3:
                    n_redundant += 1
            if n_pts > 0 and n_redundant > 0.9 * n_pts:
                self._erase_keyframe(ckf)

    def _erase_keyframe(self, kf: KeyFrame):
        """KeyFrame::SetBadFlag — detach observations, reparent children,
        record Tcp for trajectory reconstruction."""
        if kf.id == 0 or kf.not_erase:
            return
        pt = self.map.points
        for fid in np.nonzero(kf.mp_idx >= 0)[0]:
            pid = int(kf.mp_idx[fid])
            if pid >= 0 and not pt.bad[pid]:
                self.map.erase_observation(pid, kf.id)
        for other_id in list(kf.covis):
            other = self.map.kfs.get(other_id)
            if other is not None:
                other.covis.pop(kf.id, None)
                other.ordered_covis = [k for k, _ in
                                       sorted(other.covis.items(), key=lambda kv: -kv[1])]
        # reparent children to the parent (simplified spanning-tree repair)
        parent = self.map.kfs.get(kf.parent) if kf.parent is not None else None
        for ch_id in kf.children:
            ch = self.map.kfs.get(ch_id)
            if ch is not None:
                ch.parent = kf.parent
                if parent is not None:
                    parent.children.add(ch_id)
        if parent is not None:
            parent.children.discard(kf.id)
            # Tcp = Tcw_this * Twc_parent
            R = kf.Rcw @ parent.Rwc
            t = kf.Rcw @ parent.Ow + kf.tcw
            kf.Tcp = (R, t)
        kf.covis = {}
        kf.ordered_covis = []
        kf.bad = True
        if self.keyframe_db is not None:
            self.keyframe_db.erase(kf)
