"""System facade — the public API (reference: src/System.cc, System.h:75-149).

    cfg = SlamConfig()                      # or SlamConfig.from_yaml(...)
    slam = System(cfg, device="cuda")
    for data in sequence:                   # io.datasets.FrameData
        slam.track_stereo(data)
    slam.shutdown()
    slam.save_trajectory_tum("traj.txt")

This slice runs offline static stereo tracking with no mapping pass, the
configuration of airdos_tpu's ``Tracking(..., local_mapper=None)``.  The
rest of airdos_tpu's System raises NotImplementedError naming the ROADMAP
item that brings it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.io.datasets import FrameData
from airdos_tpu_torch.io.tum import write_trajectory_tum
from airdos_tpu_torch.slam.frame import FrontEnd
from airdos_tpu_torch.slam.map import SlamMap
from airdos_tpu_torch.slam.tracking import Tracking
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
        (bool(config.vocabulary_path), "vocabulary_path: place recognition "
                                       "(ROADMAP port queue, relocalization "
                                       "and loop closing)"),
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
        self.tracking = Tracking(config, self.frontend, self.map)
        self.track_times: List[float] = []
        self.profiler = Profiler()
        self.events = EventLog()
        self.tracking.profiler = self.profiler

    # ----------------------------------------------------------------- api
    def track_stereo(self, data: FrameData):
        """TrackStereo — static-only stereo tracking."""
        return self._track(data)

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

    def shutdown(self):
        """Offline tracking runs no background work; waits for the device
        to finish what was queued."""
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
