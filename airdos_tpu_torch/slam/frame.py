"""Per-frame measurement construction.

Rebuild of the reference's Frame (src/Frame.cc) for static stereo: the
front end turns the raw stereo pair into padded measurement tensors (ORB
features of both views, stereo u_right/depth, undistorted keypoints), and
the host-side Frame wraps numpy copies of them plus the map bookkeeping
(per-feature map point ids, pose).  The human association of airdos_tpu's
Frame is not ported yet (ROADMAP port queue: human layer).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.convert import (desc_to_numpy, desc_to_tensor,
                                      resolve_device, to_device)
from airdos_tpu_torch.features.orb import OrbExtractor
from airdos_tpu_torch.geometry.camera import StereoCamera
from airdos_tpu_torch.geometry.se3 import project_so3_np
from airdos_tpu_torch.matching.stereo import stack_pyramid, stereo_match
from airdos_tpu_torch.ops.pyramid import build_pyramid, level_shapes


class FrontEnd:
    """Owns the per-frame device front end on one torch device."""

    def __init__(self, config: SlamConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.camera = StereoCamera.from_config(config.camera)
        orb = config.orb
        self.extractor = OrbExtractor(orb.n_features, orb.scale_factor,
                                      orb.n_levels, orb.ini_th_fast,
                                      orb.min_th_fast)
        cam = config.camera
        self._widths = torch.tensor(
            [s[1] for s in level_shapes(cam.height, cam.width, orb.n_levels,
                                        orb.scale_factor)],
            dtype=torch.int64, device=self.device)
        self._scales = torch.tensor(self.extractor.scales, dtype=torch.float32,
                                    device=self.device)

    def upload(self, data):
        """uint8 device images of one frame (the float cast happens on the
        device; uint8 is a quarter of the bytes)."""
        return (to_device(data.image_left, self.device, np.uint8),
                to_device(data.image_right, self.device, np.uint8))

    def _build_impl(self, imL_u8: torch.Tensor, imR_u8: torch.Tensor):
        orb = self.config.orb
        imL = imL_u8.to(torch.float32)
        imR = imR_u8.to(torch.float32)
        pyrL = build_pyramid(imL, None, orb.n_levels, orb.scale_factor)
        pyrR = build_pyramid(imR, None, orb.n_levels, orb.scale_factor)
        fL = self.extractor._extract_from_pyramid(pyrL)
        fR = self.extractor._extract_from_pyramid(pyrR)
        sm = stereo_match(fL.xy, fL.octave, fL.desc32, fL.valid,
                          fR.xy, fR.octave, fR.desc32, fR.valid,
                          stack_pyramid(pyrL.images), stack_pyramid(pyrR.images),
                          self._widths, self._scales,
                          self.config.camera.bf, self.config.camera.baseline)
        xy_un = self.camera.undistort_points(fL.xy)
        return fL, fR, sm, xy_un

    def build_frame(self, data) -> "Frame":
        """data: io.datasets.FrameData."""
        imL, imR = self.upload(data)
        fL, fR, sm, xy_un = self._build_impl(imL, imR)
        return Frame(self, data, fL, sm, xy_un)


class Frame:
    """Host-side frame: numpy measurement views + map bookkeeping."""

    def __init__(self, frontend: FrontEnd, data, fL, sm, xy_un_dev):
        dev = dict(xy=fL.xy, xy_un=xy_un_dev, octave=fL.octave,
                   angle=fL.angle, desc32=fL.desc32, valid=fL.valid,
                   u_right=sm.u_right, depth=sm.depth)
        f32 = torch.cat([fL.xy, xy_un_dev, fL.response[:, None],
                         fL.angle[:, None], sm.u_right[:, None],
                         sm.depth[:, None]], dim=1).cpu().numpy()
        host = (f32[:, 0:2], f32[:, 4], f32[:, 5], fL.octave.cpu().numpy(),
                desc_to_numpy(fL.desc32), fL.valid.cpu().numpy(),
                f32[:, 6], f32[:, 7], f32[:, 2:4])
        self._init_from_arrays(frontend, data, dev, host)

    @classmethod
    def from_track_result(cls, frontend: FrontEnd, data, host):
        """Build from the fused step's host FullTrackResult."""
        self = cls.__new__(cls)
        f32 = host.feat_f32
        i32 = host.feat_i32
        host_tuple = (f32[:, 0:2], f32[:, 4], f32[:, 5],
                      i32[:, 0], host.desc32, i32[:, 1] > 0,
                      f32[:, 6], f32[:, 7], f32[:, 2:4])
        # device handles are rebuilt lazily from the host copies (only the
        # non-fused fallback branches need them)
        self._init_from_arrays(frontend, data, None, host_tuple)
        return self

    @property
    def dev(self):
        if self._dev is None:
            d = self.frontend.device
            self._dev = dict(
                xy=to_device(self.xy, d), xy_un=to_device(self.xy_un, d),
                octave=to_device(self.octave, d, np.int64),
                angle=to_device(self.angle, d),
                desc32=desc_to_tensor(self.desc32, d),
                valid=to_device(self.valid, d),
                u_right=to_device(self.u_right, d),
                depth=to_device(self.depth, d))
        return self._dev

    def _init_from_arrays(self, frontend: FrontEnd, data, dev, host):
        self.frontend = frontend
        self.config = frontend.config
        self.camera = frontend.camera
        self.index = data.index
        self.timestamp = data.timestamp
        self._dev = dev
        (self.xy, self.response, self.angle, self.octave, self.desc32,
         self.valid, self.u_right, self.depth, self.xy_un) = host
        self.octave = np.ascontiguousarray(self.octave).astype(np.int32)
        self.desc32 = np.ascontiguousarray(self.desc32)
        self.xy = np.ascontiguousarray(self.xy)
        self.xy_un = np.ascontiguousarray(self.xy_un)
        self.n_slots = self.xy.shape[0]
        self.mp_idx = np.full(self.n_slots, -1, np.int64)
        self.outlier = np.zeros(self.n_slots, bool)
        self.Rcw = np.eye(3, dtype=np.float32)
        self.tcw = np.zeros(3, np.float32)
        self.ref_kf_id: Optional[int] = None

    # ------------------------------------------------------------- pose
    def set_pose(self, Rcw, tcw):
        # re-orthonormalize: solver output carries f32 drift that otherwise
        # compounds through the velocity composition (see project_so3_np)
        self.Rcw = project_so3_np(Rcw).astype(np.float32)
        self.tcw = np.asarray(tcw, np.float32)

    @property
    def Rwc(self):
        return self.Rcw.T

    @property
    def Ow(self):
        return -self.Rcw.T @ self.tcw

    def unproject_features(self, ids: np.ndarray) -> np.ndarray:
        cam = self.config.camera
        z = self.depth[ids]
        x = (self.xy_un[ids, 0] - cam.cx) * z / cam.fx
        y = (self.xy_un[ids, 1] - cam.cy) * z / cam.fy
        xc = np.stack([x, y, z], axis=1).astype(np.float32)
        return (self.Rwc @ xc.T).T + self.Ow[None, :]
