"""Map data model: keyframes, map points, covisibility — host-side arrays.

Array-based rebuild of the reference's pointer-rich map (src/Map.cc,
src/KeyFrame.cc, src/MapPoint.cc): map points live in one growable
structure-of-arrays table indexed by integer id; keyframes hold per-feature
point indices; the covisibility graph and spanning tree are integer
dictionaries.  All device computations consume snapshots of these arrays.

Human structures (MapHumanPose / MapHumanTrajectory, reference
src/MapHumanPose.cc, src/MapHumanTrajectory.cc) are time-indexed arrays per
track id.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np

# skeleton topology (reference: Map.h:48-56)
BODY1 = np.array([1, 1, 2, 3, 1, 5, 6, 2, 8, 9, 5, 11, 12, 1], np.int32)
BODY2 = np.array([0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 1], np.int32)
MAIN_SKELETON = np.array([1, 2, 5, 11, 8], np.int32)
N_PARTS = 14
N_JOINTS = 18
TH_LONG_TRAJECTORY = 3      # min trajectory length for BA (Map.h:100)
MAX_SEGMENT_LEN = 1.0       # segments longer than 1 m are born bad


class PointTable:
    """Structure-of-arrays store for map points."""

    def __init__(self, cap: int = 1 << 14):
        self._grow_to(cap, init=True)
        self.n = 0                      # high-water mark (ids are dense)

    def _grow_to(self, cap: int, init: bool = False):
        def grow(name, shape, dtype, fill=0):
            new = np.full((cap, *shape), fill, dtype)
            if not init:
                old = getattr(self, name)
                new[:len(old)] = old
            setattr(self, name, new)
        grow("pos", (3,), np.float32)
        grow("desc32", (8,), np.uint32)
        grow("normal", (3,), np.float32)
        grow("min_dist", (), np.float32)
        grow("max_dist", (), np.float32)
        grow("n_obs", (), np.int32)
        grow("visible", (), np.int32)
        grow("found", (), np.int32)
        grow("bad", (), bool, True)
        grow("ref_kf", (), np.int32, -1)
        grow("first_kf", (), np.int32, -1)
        if init:
            self.obs: List[Dict[int, int]] = []
        self.cap = cap

    def alloc(self, k: int) -> np.ndarray:
        ids = np.arange(self.n, self.n + k, dtype=np.int32)
        self.n += k
        while self.n > self.cap:
            self._grow_to(self.cap * 2)
        while len(self.obs) < self.n:
            self.obs.append({})
        return ids

    def live_ids(self) -> np.ndarray:
        return np.nonzero(~self.bad[:self.n])[0].astype(np.int32)


@dataclasses.dataclass
class HumanPose:
    """One observed human at one time (MapHumanPose equivalent)."""
    track_id: int
    timestamp: float
    kf_id: int                      # observing (reference) keyframe
    joints_w: np.ndarray            # [18, 3] world positions
    bad: np.ndarray                 # [18] bool (bad initialization per joint)
    lost: np.ndarray                # [18] bool (motion-edge outlier, set by BA)
    optimized: np.ndarray           # [18] bool
    obs_uvd: Optional[np.ndarray] = None   # [18, 4] (uL, vL, uR, depth)
    confidence: Optional[np.ndarray] = None  # [18]
    in_keyframe: bool = True


class HumanTrajectory:
    """Per-track-id time series (MapHumanTrajectory equivalent)."""

    def __init__(self, track_id: int):
        self.track_id = track_id
        self.poses: List[HumanPose] = []
        self.segment_len = np.zeros(N_PARTS, np.float32)     # Rigidbody distances
        self.segment_bad = np.ones(N_PARTS, bool)
        self.segment_optimized = np.zeros(N_PARTS, bool)
        # constant-velocity SE(3) motion model (VertexSE3 mTMotion)
        self.motion_R = np.eye(3, dtype=np.float32)
        self.motion_t = np.zeros(3, np.float32)
        self.optimized = False
        self.bad_count = 0

    def add_pose(self, hp: HumanPose):
        if not self.poses:
            # initialize segment lengths from the first pose (reference:
            # MapHumanTrajectory.cc:30-67; >1 m -> stays bad/0)
            d = np.linalg.norm(hp.joints_w[BODY1] - hp.joints_w[BODY2], axis=1)
            joint_ok = ~(hp.bad[BODY1] | hp.bad[BODY2])
            ok = joint_ok & (d <= MAX_SEGMENT_LEN)
            self.segment_len = np.where(ok, d, 0.0).astype(np.float32)
            self.segment_bad = ~ok
        self.poses.append(hp)

    def __len__(self):
        return len(self.poses)


class KeyFrame:
    def __init__(self, kf_id: int, frame):
        """frame: slam.frame.Frame — measurement arrays are shared, not copied."""
        self.id = kf_id
        self.frame_id = frame.index
        self.timestamp = frame.timestamp
        self.Rcw = frame.Rcw.copy()
        self.tcw = frame.tcw.copy()
        self._ow = None
        f = frame
        self.xy = f.xy
        self.xy_un = f.xy_un
        self.octave = f.octave
        self.angle = f.angle
        self.response = f.response
        self.desc32 = f.desc32
        self.u_right = f.u_right
        self.depth = f.depth
        self.valid = f.valid
        self.n_slots = f.xy.shape[0]
        self.mp_idx = f.mp_idx.copy()
        # graph
        self.covis: Dict[int, int] = {}
        self.ordered_covis: List[int] = []
        self.parent: Optional[int] = None
        self.children: Set[int] = set()
        self.loop_edges: Set[int] = set()
        self.bad = False
        self.not_erase = False
        self.to_be_erased = False
        # relative pose to parent at culling time (mTcp)
        self.Tcp: Optional[tuple] = None
        # humans observed from this KF: list of (traj_track_id, pose_index)
        self.human_pose_ids: List[tuple] = []
        # BoW (filled lazily)
        self.bow: Optional[dict] = None
        self.feat_vec: Optional[dict] = None

    @property
    def Rwc(self):
        return self.Rcw.T

    @property
    def Ow(self):
        # cached: pose-dependent consumers (fuse/BA write-backs) read this
        # thousands of times between pose updates
        ow = self._ow
        if ow is None:
            ow = -self.Rcw.T @ self.tcw
            self._ow = ow
        return ow

    def set_pose(self, Rcw, tcw):
        from airdos_tpu_torch.geometry.se3 import project_so3_np
        self.Rcw = project_so3_np(Rcw).astype(np.float32)
        self.tcw = np.asarray(tcw, np.float32).copy()
        self._ow = None

    def best_covisible(self, k: int) -> List[int]:
        return self.ordered_covis[:k]


class SlamMap:
    """Global store (reference: src/Map.cc) + covisibility maintenance."""

    def __init__(self):
        self.kfs: Dict[int, KeyFrame] = {}
        self.points = PointTable()
        self.next_kf_id = 0
        self.trajectories: Dict[int, HumanTrajectory] = {}
        self.optimized_track_ids: Set[int] = set()
        self.current_track_ids: List[int] = []
        self.max_kf_id = 0

    # ----------------------------------------------------------- keyframes
    def add_keyframe(self, kf: KeyFrame):
        self.kfs[kf.id] = kf
        self.max_kf_id = max(self.max_kf_id, kf.id)

    def n_keyframes(self) -> int:
        """Live keyframe count (reference Map::KeyFramesInMap counts
        mspKeyFrames, which KeyFrame::SetBadFlag erases from; culled KFs
        stay in self.kfs only for trajectory reconstruction via Tcp)."""
        return sum(1 for k in self.kfs.values() if not k.bad)

    def n_points(self) -> int:
        return int((~self.points.bad[:self.points.n]).sum())

    # ----------------------------------------------------------- map points
    def create_points(self, kf: KeyFrame, feat_ids: np.ndarray,
                      pos_w: np.ndarray) -> np.ndarray:
        """Create map points observed by kf at the given feature slots."""
        pt = self.points
        ids = pt.alloc(len(feat_ids))
        pt.pos[ids] = pos_w
        pt.desc32[ids] = kf.desc32[feat_ids]
        pt.bad[ids] = False
        pt.ref_kf[ids] = kf.id
        pt.first_kf[ids] = kf.id
        # stereo observations count double (MapPoint::AddObservation)
        pt.n_obs[ids] = np.where(kf.u_right[feat_ids] >= 0, 2, 1)
        pt.visible[ids] = 1
        pt.found[ids] = 1
        for pid, fid in zip(ids, feat_ids):
            pt.obs[pid] = {kf.id: int(fid)}
        kf.mp_idx[feat_ids] = ids
        # normal + scale invariance
        ow = kf.Ow
        d = pos_w - ow[None, :]
        dist = np.linalg.norm(d, axis=1)
        pt.normal[ids] = d / np.maximum(dist[:, None], 1e-9)
        self._set_scale_invariance(ids, dist, kf.octave[feat_ids])
        return ids

    def _set_scale_invariance(self, ids, dist, octaves,
                              scale_factor: float = 1.2, n_levels: int = 8):
        level_factor = scale_factor ** octaves.astype(np.float32)
        max_d = dist * level_factor
        min_d = max_d / (scale_factor ** (n_levels - 1))
        self.points.max_dist[ids] = 1.2 * max_d
        self.points.min_dist[ids] = 0.8 * min_d

    def add_observation(self, pid: int, kf: KeyFrame, feat_idx: int):
        pt = self.points
        if kf.id in pt.obs[pid]:
            return
        pt.obs[pid][kf.id] = int(feat_idx)
        pt.n_obs[pid] += 1 + (1 if kf.u_right[feat_idx] >= 0 else 0)
        kf.mp_idx[feat_idx] = pid

    def erase_observation(self, pid: int, kf_id: int):
        pt = self.points
        fid = pt.obs[pid].pop(kf_id, None)
        if fid is None:
            return
        kf = self.kfs.get(kf_id)
        if kf is not None and kf.mp_idx[fid] == pid:
            kf.mp_idx[fid] = -1
        pt.n_obs[pid] -= 2 if (kf is not None and kf.u_right[fid] >= 0) else 1
        if pt.ref_kf[pid] == kf_id and pt.obs[pid]:
            pt.ref_kf[pid] = next(iter(pt.obs[pid]))
        if pt.n_obs[pid] <= 2:
            self.set_point_bad(pid)

    def set_point_bad(self, pid: int):
        pt = self.points
        if pt.bad[pid]:
            return
        pt.bad[pid] = True
        for kf_id, fid in list(pt.obs[pid].items()):
            kf = self.kfs.get(kf_id)
            if kf is not None and kf.mp_idx[fid] == pid:
                kf.mp_idx[fid] = -1
        pt.obs[pid] = {}

    def replace_point(self, old_pid: int, new_pid: int):
        """MapPoint::Replace — merge old into new."""
        if old_pid == new_pid:
            return
        pt = self.points
        obs_old = pt.obs[old_pid]
        pt.bad[old_pid] = True
        pt.obs[old_pid] = {}
        for kf_id, fid in obs_old.items():
            kf = self.kfs.get(kf_id)
            if kf is None:
                continue
            if kf_id not in pt.obs[new_pid]:
                pt.obs[new_pid][kf_id] = fid
                kf.mp_idx[fid] = new_pid
                pt.n_obs[new_pid] += 2 if kf.u_right[fid] >= 0 else 1
            else:
                if kf.mp_idx[fid] == old_pid:
                    kf.mp_idx[fid] = -1
        pt.found[new_pid] += pt.found[old_pid]
        pt.visible[new_pid] += pt.visible[old_pid]

    # -------------------------------------------------- descriptor / normal
    def update_point_descriptor(self, pid: int):
        """Min-median-Hamming distinctive descriptor
        (MapPoint::ComputeDistinctiveDescriptors)."""
        pt = self.points
        descs = []
        for kf_id, fid in pt.obs[pid].items():
            kf = self.kfs.get(kf_id)
            if kf is not None and not kf.bad:
                descs.append(kf.desc32[fid])
        if not descs:
            return
        D = np.asarray(descs)
        x = D[:, None, :] ^ D[None, :, :]
        dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
        med = np.sort(dist, axis=1)[:, (len(D) - 1) // 2]
        pt.desc32[pid] = D[int(np.argmin(med))]

    def update_point_descriptors(self, pids):
        """Batched ComputeDistinctiveDescriptors over many points."""
        for p in pids:
            self.update_point_descriptor(p)

    def update_points_normal_depth(self, pids):
        """Batched UpdateNormalAndDepth over many points: one pass collects
        (point, observer-centre) pairs, one vectorized pass reduces them.
        ~10x cheaper than per-point calls for BA/fuse write-backs."""
        pt = self.points
        pair_pid, pair_ow = [], []
        ref_rows = []            # (pid, dist, octave)
        ow_cache: Dict[int, np.ndarray] = {}
        for p in pids:
            p = int(p)
            if pt.bad[p] or not pt.obs[p]:
                continue
            for kf_id in pt.obs[p]:
                ow = ow_cache.get(kf_id)
                if ow is None:
                    kf = self.kfs.get(kf_id)
                    if kf is None:
                        continue
                    ow = kf.Ow
                    ow_cache[kf_id] = ow
                pair_pid.append(p)
                pair_ow.append(ow)
            ref_id = int(pt.ref_kf[p])
            ref = self.kfs.get(ref_id)
            if ref is not None and ref_id in pt.obs[p]:
                fid = pt.obs[p][ref_id]
                ref_ow = ow_cache.get(ref_id)
                if ref_ow is None:
                    ref_ow = ref.Ow
                d = float(np.linalg.norm(pt.pos[p] - ref_ow))
                ref_rows.append((p, d, int(ref.octave[fid])))
        if not pair_pid:
            return
        pair_pid = np.asarray(pair_pid)
        d = pt.pos[pair_pid] - np.asarray(pair_ow)
        n = np.linalg.norm(d, axis=1, keepdims=True)
        d = d / np.maximum(n, 1e-9)
        # segment-mean by pid
        uniq, inv = np.unique(pair_pid, return_inverse=True)
        sums = np.zeros((len(uniq), 3), np.float64)
        np.add.at(sums, inv, d)
        counts = np.bincount(inv)
        pt.normal[uniq] = (sums / counts[:, None]).astype(np.float32)
        if ref_rows:
            ids = np.asarray([r[0] for r in ref_rows])
            dists = np.asarray([r[1] for r in ref_rows])
            octs = np.asarray([r[2] for r in ref_rows])
            self._set_scale_invariance(ids, dists, octs)

    def update_point_normal_depth(self, pid: int):
        pt = self.points
        if not pt.obs[pid]:
            return
        normals = []
        for kf_id, fid in pt.obs[pid].items():
            kf = self.kfs.get(kf_id)
            if kf is None:
                continue
            d = pt.pos[pid] - kf.Ow
            n = np.linalg.norm(d)
            if n > 1e-9:
                normals.append(d / n)
        if not normals:
            return
        pt.normal[pid] = np.mean(normals, axis=0)
        ref_id = int(pt.ref_kf[pid])
        ref = self.kfs.get(ref_id)
        if ref is None or ref_id not in pt.obs[pid]:
            return
        fid = pt.obs[pid][ref_id]
        dist = np.linalg.norm(pt.pos[pid] - ref.Ow)
        self._set_scale_invariance(np.array([pid]), np.array([dist]),
                                   np.array([ref.octave[fid]]))

    # --------------------------------------------------------- covisibility
    def update_connections(self, kf: KeyFrame, min_weight: int = 15):
        """KeyFrame::UpdateConnections — recount shared observations."""
        counter: Dict[int, int] = {}
        pt = self.points
        for fid in np.nonzero(kf.mp_idx >= 0)[0]:
            pid = kf.mp_idx[fid]
            if pt.bad[pid]:
                continue
            for other_id in pt.obs[pid]:
                if other_id != kf.id:
                    counter[other_id] = counter.get(other_id, 0) + 1
        if not counter:
            return
        best_id, best_w = max(counter.items(), key=lambda kv: kv[1])
        conns = {k: w for k, w in counter.items() if w >= min_weight}
        if not conns:
            conns = {best_id: best_w}
        kf.covis = conns
        kf.ordered_covis = [k for k, _ in sorted(conns.items(), key=lambda kv: -kv[1])]
        for other_id, w in conns.items():
            other = self.kfs.get(other_id)
            if other is None:
                continue
            other.covis[kf.id] = w
            other.ordered_covis = [k for k, _ in sorted(other.covis.items(),
                                                        key=lambda kv: -kv[1])]
        # spanning tree: first connection becomes parent
        if kf.parent is None and kf.id != 0:
            kf.parent = best_id
            self.kfs[best_id].children.add(kf.id)

    # --------------------------------------------------------------- humans
    def add_human_pose(self, hp: HumanPose):
        traj = self.trajectories.get(hp.track_id)
        if traj is None:
            traj = HumanTrajectory(hp.track_id)
            self.trajectories[hp.track_id] = traj
        traj.add_pose(hp)
        kf = self.kfs.get(hp.kf_id)
        if kf is not None and hp.in_keyframe:
            kf.human_pose_ids.append((hp.track_id, len(traj.poses) - 1))

    def long_trajectories(self) -> List[HumanTrajectory]:
        return [t for t in self.trajectories.values()
                if len(t) >= TH_LONG_TRAJECTORY]


# ---------------------------------------------------------------------------
# Checkpoint / resume (the reference declares Save/LoadMap as TODO,
# System.h:125-127; array-based state makes it straightforward here).

def save_map(m: "SlamMap", path) -> None:
    """Serialize the full map (keyframes, points, humans) to one .npz."""
    import io
    import pickle
    pt = m.points
    n = pt.n
    kf_blobs = []
    for kf in m.kfs.values():
        kf_blobs.append(dict(
            id=kf.id, frame_id=kf.frame_id, timestamp=kf.timestamp,
            Rcw=kf.Rcw, tcw=kf.tcw, xy=kf.xy, xy_un=kf.xy_un,
            octave=kf.octave, angle=kf.angle, response=kf.response,
            desc32=kf.desc32, u_right=kf.u_right, depth=kf.depth,
            valid=kf.valid, mp_idx=kf.mp_idx, covis=kf.covis,
            ordered_covis=kf.ordered_covis, parent=kf.parent,
            children=list(kf.children), loop_edges=list(kf.loop_edges),
            bad=kf.bad, Tcp=kf.Tcp, human_pose_ids=kf.human_pose_ids))
    traj_blobs = []
    for tid, tr in m.trajectories.items():
        traj_blobs.append(dict(
            track_id=tid, segment_len=tr.segment_len,
            segment_bad=tr.segment_bad, segment_optimized=tr.segment_optimized,
            motion_R=tr.motion_R, motion_t=tr.motion_t,
            optimized=tr.optimized, bad_count=tr.bad_count,
            poses=[dict(track_id=hp.track_id, timestamp=hp.timestamp,
                        kf_id=hp.kf_id, joints_w=hp.joints_w, bad=hp.bad,
                        lost=hp.lost, optimized=hp.optimized,
                        obs_uvd=hp.obs_uvd, confidence=hp.confidence,
                        in_keyframe=hp.in_keyframe) for hp in tr.poses]))
    blob = pickle.dumps(dict(kfs=kf_blobs, trajs=traj_blobs,
                             obs=pt.obs[:n], next_kf_id=m.next_kf_id))
    np.savez_compressed(
        path, pos=pt.pos[:n], desc32=pt.desc32[:n], normal=pt.normal[:n],
        min_dist=pt.min_dist[:n], max_dist=pt.max_dist[:n],
        n_obs=pt.n_obs[:n], visible=pt.visible[:n], found=pt.found[:n],
        bad=pt.bad[:n], ref_kf=pt.ref_kf[:n], first_kf=pt.first_kf[:n],
        blob=np.frombuffer(blob, np.uint8))


def load_map(path) -> "SlamMap":
    import pickle
    z = np.load(path, allow_pickle=False)
    blob = pickle.loads(z["blob"].tobytes())
    m = SlamMap()
    n = len(z["pos"])
    pt = m.points
    pt.alloc(n)
    for name in ("pos", "desc32", "normal", "min_dist", "max_dist", "n_obs",
                 "visible", "found", "bad", "ref_kf", "first_kf"):
        getattr(pt, name)[:n] = z[name]
    pt.obs[:n] = blob["obs"]
    m.next_kf_id = blob["next_kf_id"]
    for kb in blob["kfs"]:
        kf = KeyFrame.__new__(KeyFrame)
        for k, v in kb.items():
            setattr(kf, k, v)
        kf.children = set(kb["children"])
        kf.loop_edges = set(kb["loop_edges"])
        kf.n_slots = kf.xy.shape[0]
        kf.not_erase = False
        kf.to_be_erased = False
        kf.bow = None
        kf.feat_vec = None
        m.add_keyframe(kf)
    for tb in blob["trajs"]:
        tr = HumanTrajectory(tb["track_id"])
        for k in ("segment_len", "segment_bad", "segment_optimized",
                  "motion_R", "motion_t", "optimized", "bad_count"):
            setattr(tr, k, tb[k])
        for pb in tb["poses"]:
            tr.poses.append(HumanPose(**pb))
        m.trajectories[tb["track_id"]] = tr
    return m
