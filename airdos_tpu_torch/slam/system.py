"""System facade — the public API (reference: src/System.cc, System.h:75-149).

    cfg = SlamConfig()                      # or SlamConfig.from_yaml(...)
    slam = System(cfg)                      # on the card; device="cpu"
    for data in sequence:                   # io.datasets.FrameData
        slam.track_stereo_human(data)       # or track_stereo(...)
    slam.before_end("map_dump_dir")         # optional SaveMap metadata dump
    slam.shutdown()
    slam.save_trajectory_tum("traj.txt")

This runs airdos_tpu's offline System: tracking (relocalizing when
LOST), and at each new keyframe, inline, the local-mapping pass (point
culling, triangulation, fusion, Schur local BA, keyframe culling, the
scene vocabulary trained at the first keyframes, or the one
``vocabulary_path`` names, and the keyframe database that BoW tracking
and relocalization read), then, with ``enable_loop_closing``, loop
closing (detection, Sim3, correction through the essential graph and the
global BA).  With Human.ok the human layer runs too: masked ORB
extraction (System.IsMask), stereo human association, human poses
entering the map, and the human-trajectory BA every Camera.fps frames.
``save_map`` / ``load_map`` checkpoint the map in airdos_tpu's format.
Online mode (``is_offline=False``) raises NotImplementedError naming the
ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.io.datasets import FrameData
from airdos_tpu_torch.io.tum import write_trajectory_kitti, write_trajectory_tum
from airdos_tpu_torch.slam.ba_driver import (Fuser, GlobalBA, HumanLocalBA,
                                             StaticLocalBA, Triangulator)
from airdos_tpu_torch.slam.frame import FrontEnd
from airdos_tpu_torch.slam.local_mapping import LocalMapper
from airdos_tpu_torch.slam.map import SlamMap
from airdos_tpu_torch.slam.tracking import Tracking, TrackState
from airdos_tpu_torch.utils.obs import EventLog, Profiler, span


def _check_scope(config: SlamConfig) -> None:
    if not config.system.is_offline:
        raise NotImplementedError("not ported yet: is_offline=False: online "
                                  "mode (ROADMAP port queue, online mode)")


class System:
    def __init__(self, config: SlamConfig, device="cuda"):
        _check_scope(config)
        self.config = config
        self.map = SlamMap()
        self.frontend = FrontEnd(config, device=device)
        self.device = self.frontend.device
        self.local_mapper = LocalMapper(config, self.map)
        self.tracking = Tracking(config, self.frontend, self.map,
                                 self.local_mapper)
        ext = self.frontend.extractor
        self.static_ba = StaticLocalBA(config, self.map, ext,
                                       device=self.device)
        self.global_ba = GlobalBA(config, self.map, ext, device=self.device)
        self.local_mapper.triangulator = Triangulator(
            config, self.map, ext, self.local_mapper, device=self.device)
        self.local_mapper.fuser = Fuser(config, self.map, ext,
                                        device=self.device)
        self.human_ba = HumanLocalBA(config, self.map, ext,
                                     device=self.device) \
            if config.human.ok else None
        self._frame_count = 0
        self._last_human_ba_frame = 0
        self.track_times: List[float] = []
        self.profiler = Profiler()
        self.events = EventLog()
        self.static_ba.profiler = self.profiler
        self.global_ba.profiler = self.profiler
        self.tracking.profiler = self.profiler
        self.tracking.events = self.events
        if self.human_ba is not None:
            self.human_ba.profiler = self.profiler
        # place recognition: the vocabulary vocabulary_path names (by
        # suffix, as the reference's System.cc:56-67), or a scene
        # vocabulary trained lazily from the first keyframes' descriptors;
        # then the keyframe database and the loop closer
        self.vocabulary = None
        self.keyframe_db = None
        self.loop_closer = None
        if config.vocabulary_path:
            from airdos_tpu_torch.bow.vocabulary import (Vocabulary,
                                                         load_dbow2_binary,
                                                         load_dbow2_text)
            p = str(config.vocabulary_path)
            load = (Vocabulary.load_npz if p.endswith(".npz")
                    else load_dbow2_binary if p.endswith(".bin")
                    else load_dbow2_text)
            self.vocabulary = load(p, device=self.device)
            self._init_place_recognition()

    # ----------------------------------------------------------------- api
    def track_stereo(self, data: FrameData):
        """TrackStereo — static-only stereo tracking."""
        return self._track(data)

    def track_stereo_human(self, data: FrameData):
        """TrackStereoHuman — stereo + dynamic-human pipeline."""
        return self._track(data)

    def _init_place_recognition(self):
        from airdos_tpu_torch.slam.keyframe_db import KeyFrameDatabase
        from airdos_tpu_torch.slam.loop_closing import LoopCloser
        self.keyframe_db = KeyFrameDatabase(self.vocabulary, self.map)
        self.tracking.keyframe_db = self.keyframe_db
        self.local_mapper.keyframe_db = self.keyframe_db
        self.loop_closer = LoopCloser(self.config, self.map, self.keyframe_db,
                                      self.frontend.extractor, self.device,
                                      fuser=self.local_mapper.fuser,
                                      global_ba=self.global_ba)
        self.loop_closer.profiler = self.profiler
        self.loop_closer.events = self.events
        for kf in self.map.kfs.values():
            if not kf.bad:
                self.keyframe_db.add(kf)

    def _maybe_train_vocabulary(self):
        """Train a small scene vocabulary from the first keyframes'
        descriptors (the reference instead loads the 145 MB ORBvoc.txt)."""
        if self.vocabulary is not None or self.map.n_keyframes() < 1:
            return
        from airdos_tpu_torch.bow.vocabulary import train_vocabulary
        descs = []
        for kf in self.map.kfs.values():
            d = kf.desc32[kf.valid]
            descs.append(d.view(np.uint8).reshape(len(d), 32))
        train = np.concatenate(descs, axis=0)
        if len(train) < 200:
            return
        self.vocabulary = train_vocabulary(train, k=8, depth=3,
                                           device=self.device)
        self._init_place_recognition()

    def _mapping_pipeline(self, prev_kf):
        """The per-keyframe local-mapping steps (reference: LocalMapping::Run
        body), inline as in airdos_tpu's offline mode."""
        lm = self.local_mapper
        with span(self.profiler, "map.cull_points"):
            lm.cull_map_points(prev_kf.id)
        with span(self.profiler, "map.triangulate"):
            lm.create_new_points(prev_kf)
        with span(self.profiler, "map.fuse"):
            lm.fuse_neighbors(prev_kf)
        # the static local BA at every keyframe once the map has three
        # (see airdos_tpu's System._mapping_pipeline for why per keyframe)
        if self.map.n_keyframes() > 2:
            with span(self.profiler, "map.static_ba"):
                self.static_ba(prev_kf)
        with span(self.profiler, "map.cull_kfs"):
            lm.cull_keyframes(prev_kf)
        with span(self.profiler, "map.vocab"):
            self._maybe_train_vocabulary()
        if self.keyframe_db is None or prev_kf.bad:
            return
        if self.config.loop_closing_active:
            with span(self.profiler, "map.loop_closing"):
                self.loop_closer.process(prev_kf)
        else:
            self.keyframe_db.add(prev_kf)

    def _to_gray(self, img: np.ndarray) -> np.ndarray:
        """Color -> grayscale honoring Camera.RGB channel order (reference
        Tracking.cc:247-272)."""
        if img.ndim == 2:
            return img
        w = np.asarray([0.299, 0.587, 0.114], np.float32)
        if not self.config.camera.rgb:      # BGR input
            w = w[::-1]
        return img[..., :3].astype(np.float32) @ w

    def _track(self, data: FrameData):
        if data.image_left.ndim == 3 or data.image_right.ndim == 3:
            data = dataclasses.replace(data,
                                       image_left=self._to_gray(data.image_left),
                                       image_right=self._to_gray(data.image_right))
        t0 = time.perf_counter()
        with span(self.profiler, "track"):
            frame = self.tracking.track(data)
        prev_kf = self.map.kfs.get(self.tracking.last_kf_id)
        if (self.tracking.state == TrackState.OK and prev_kf is not None
                and prev_kf.frame_id == frame.index):
            self._mapping_pipeline(prev_kf)

        # human-trajectory local BA every max_frames frames (OffLineTrack,
        # Tracking.cc:705-717): synchronous and deterministic offline
        if (self.human_ba is not None
                and not self.config.optimizer.is_static_only
                and self.tracking.state == TrackState.OK
                and self._frame_count - self._last_human_ba_frame >=
                self.tracking.max_frames
                and self.map.long_trajectories()):
            with span(self.profiler, "human_ba"):
                self.human_ba(self.map, self.tracking.last_kf_id)
            self._last_human_ba_frame = self._frame_count

        self._frame_count += 1
        dt = time.perf_counter() - t0
        self.track_times.append(dt)
        self.events.emit("frame", index=data.index,
                         state=self.tracking.state.name,
                         branch=self.tracking.last_branch,
                         n_inliers=int(self.tracking.n_inliers),
                         n_kfs=self.map.n_keyframes(),
                         n_points=self.map.n_points(),
                         track_s=round(dt, 4))
        return frame

    # ------------------------------------------------------------- export
    def save_trajectory_tum(self, path: str):
        ts, Rwc, twc = self.tracking.trajectory_tum()
        write_trajectory_tum(path, ts, Rwc, twc)

    def save_keyframe_trajectory_tum(self, path: str):
        kfs = sorted((kf for kf in self.map.kfs.values() if not kf.bad),
                     key=lambda k: k.id)
        ts = [kf.timestamp for kf in kfs]
        Rwc = np.asarray([kf.Rwc for kf in kfs])
        twc = np.asarray([kf.Ow for kf in kfs])
        write_trajectory_tum(path, ts, Rwc, twc)

    def save_trajectory_kitti(self, path: str):
        ts, Rwc, twc = self.tracking.trajectory_tum()
        write_trajectory_kitti(path, Rwc, twc)

    def before_end(self, out_dir: Optional[str] = None):
        """Tracking::SaveMap metadata dump (KF/MP/Match/HMTraj/Motion .txt,
        reference Tracking.cc:1745-1836), in airdos_tpu's format.  With no
        explicit directory the dump goes to Data.MetaDataPath."""
        if out_dir is None:
            out_dir = self.config.meta_data_path or None
        if out_dir is None:
            return
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        pt = self.map.points
        with open(out / "KF.txt", "w") as f:
            for kf in sorted(self.map.kfs.values(), key=lambda k: k.id):
                if kf.bad:
                    continue
                q = _rot_to_quat_wxyz(kf.Rwc)
                ow = kf.Ow
                f.write(f"{kf.id} {kf.timestamp:.6f} "
                        f"{ow[0]:.7f} {ow[1]:.7f} {ow[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")
        with open(out / "MP.txt", "w") as f:
            for pid in pt.live_ids():
                p = pt.pos[pid]
                f.write(f"{pid} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f}\n")
        with open(out / "Match.txt", "w") as f:
            for pid in pt.live_ids():
                for kf_id, fid in pt.obs[pid].items():
                    kf = self.map.kfs.get(kf_id)
                    if kf is None or kf.bad:
                        continue
                    u, v = kf.xy_un[fid]
                    ur = kf.u_right[fid]
                    isig = 1.0 / (self.frontend.extractor.sigma2[kf.octave[fid]])
                    f.write(f"{pid} {kf_id} {u:.3f} {v:.3f} {ur:.3f} {isig:.5f}\n")
        with open(out / "HMTraj.txt", "w") as f:
            for tid, traj in sorted(self.map.trajectories.items()):
                for i, hp in enumerate(traj.poses):
                    for j in range(hp.joints_w.shape[0]):
                        p = hp.joints_w[j]
                        f.write(f"{tid} {i} {j} {hp.timestamp:.6f} "
                                f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                                f"{int(hp.bad[j])} {int(hp.lost[j])} "
                                f"{int(hp.optimized[j])}\n")
        with open(out / "Motion.txt", "w") as f:
            for tid, traj in sorted(self.map.trajectories.items()):
                R, t = traj.motion_R, traj.motion_t
                row = " ".join(f"{v:.7f}" for v in
                               np.hstack([R, t[:, None]]).reshape(-1))
                f.write(f"{tid} {row}\n")

    def save_map(self, path: str):
        """Checkpoint the whole map (keyframes, points, humans) to one .npz
        in airdos_tpu's format."""
        from airdos_tpu_torch.slam.map import save_map
        save_map(self.map, path)

    def load_map(self, path: str):
        """Resume from a checkpoint (this package's or airdos_tpu's):
        tracking starts LOST and relocalizes against the loaded map.  The
        keyframe database is rebuilt from the loaded keyframes (a System
        without a vocabulary trains its scene vocabulary from them);
        airdos_tpu leaves its database as it was, so a fresh airdos_tpu
        System stays LOST after load_map."""
        from airdos_tpu_torch.slam.map import load_map
        self.map.__dict__.update(load_map(path).__dict__)
        self.tracking.state = TrackState.LOST
        self.tracking.last_kf_id = max(self.map.kfs) if self.map.kfs else -1
        if self.vocabulary is None:
            self._maybe_train_vocabulary()
        elif self.keyframe_db is not None:
            self.keyframe_db.clear()
            for kf in self.map.kfs.values():
                if not kf.bad:
                    self.keyframe_db.add(kf)

    def shutdown(self):
        """Offline mode runs no background work; waits for the device to
        finish what was queued."""
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- stats
    def timing_report(self):
        tt = sorted(self.track_times)
        n = len(tt)
        if n == 0:
            return {"median_s": 0.0, "mean_s": 0.0}
        return {"median_s": tt[n // 2], "mean_s": sum(tt) / n}


def _rot_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation as _R
    q = _R.from_matrix(R).as_quat()  # x, y, z, w
    return np.array([q[3], q[0], q[1], q[2]])
