"""System facade — the public API (reference: src/System.cc, System.h:75-149).

    cfg = SlamConfig()                      # or SlamConfig.from_yaml(...)
    slam = System(cfg, device="cuda")
    for data in sequence:                   # io.datasets.FrameData
        slam.track_stereo(data)
    slam.before_end("map_dump_dir")         # optional SaveMap metadata dump
    slam.shutdown()
    slam.save_trajectory_tum("traj.txt")

This runs airdos_tpu's offline static System: tracking, and at each new
keyframe, inline, the local-mapping pass (point culling, triangulation,
fusion, Schur local BA, keyframe culling, the scene vocabulary trained at
the first keyframes, and the keyframe database that BoW reference-KF
tracking reads).  The rest of airdos_tpu's System raises
NotImplementedError naming the ROADMAP item that brings it.
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
from airdos_tpu_torch.slam.ba_driver import Fuser, StaticLocalBA, Triangulator
from airdos_tpu_torch.slam.frame import FrontEnd
from airdos_tpu_torch.slam.local_mapping import LocalMapper
from airdos_tpu_torch.slam.map import SlamMap
from airdos_tpu_torch.slam.tracking import Tracking, TrackState
from airdos_tpu_torch.utils.obs import EventLog, Profiler, span


def _check_scope(config: SlamConfig) -> None:
    limits = (
        (config.human.ok, "human.ok: the human layer (ROADMAP port queue, "
                          "human layer)"),
        (config.system.is_mask, "system.is_mask: masked extraction belongs "
                                "to the human layer (ROADMAP port queue, "
                                "human layer)"),
        (not config.system.is_offline, "is_offline=False: online mode "
                                       "(ROADMAP port queue, online mode)"),
        (bool(config.vocabulary_path), "vocabulary_path: loading a DBoW2 "
                                       "vocabulary (ROADMAP port queue, "
                                       "relocalization and loop closing)"),
        (config.loop_closing_active, "loop closing (ROADMAP port queue, "
                                     "relocalization and loop closing)"),
    )
    for hit, what in limits:
        if hit:
            raise NotImplementedError(f"not ported yet: {what}")


class System:
    def __init__(self, config: SlamConfig, device="cpu"):
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
        self.local_mapper.triangulator = Triangulator(
            config, self.map, ext, self.local_mapper, device=self.device)
        self.local_mapper.fuser = Fuser(config, self.map, ext,
                                        device=self.device)
        # place recognition: a scene vocabulary trained lazily from the
        # first keyframes' descriptors, then the keyframe database
        self.vocabulary = None
        self.keyframe_db = None
        self.track_times: List[float] = []
        self.profiler = Profiler()
        self.events = EventLog()
        self.static_ba.profiler = self.profiler
        self.tracking.profiler = self.profiler

    # ----------------------------------------------------------------- api
    def track_stereo(self, data: FrameData):
        """TrackStereo — static-only stereo tracking."""
        return self._track(data)

    def _init_place_recognition(self):
        from airdos_tpu_torch.slam.keyframe_db import KeyFrameDatabase
        self.keyframe_db = KeyFrameDatabase(self.vocabulary, self.map)
        self.tracking.keyframe_db = self.keyframe_db
        self.local_mapper.keyframe_db = self.keyframe_db
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
        if self.keyframe_db is not None and not prev_kf.bad:
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
        # no human trajectories without the human layer: the files exist,
        # empty, as airdos_tpu writes them for a static run
        (out / "HMTraj.txt").write_text("")
        (out / "Motion.txt").write_text("")

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
