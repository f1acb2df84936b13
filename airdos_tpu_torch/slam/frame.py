"""Per-frame measurement construction.

Rebuild of the reference's Frame (src/Frame.cc): the front end turns the
raw stereo pair (+ the segmentation masks) into padded measurement tensors
(ORB features of both views, stereo u_right/depth, undistorted keypoints,
and the disparity at the detections' torso joints), and the host-side
Frame wraps numpy copies of them plus the map bookkeeping (per-feature map
point ids, pose, the associated humans).

Human-pose stereo association and triangulation stay host numpy, as in
airdos_tpu: Frame::MatchingHumanPoses (src/Frame.cc:212-247) and
Frame::ComputeHumanPoseTriangulation (src/Frame.cc:313-416), or the depth
image's reads (Frame::ComputeHumanPoseDepth, Frame.cc:249-311).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.convert import (desc_to_numpy, desc_to_tensor,
                                      resolve_device, to_device)
from airdos_tpu_torch.features.orb import OrbExtractor
from airdos_tpu_torch.geometry.camera import StereoCamera
from airdos_tpu_torch.geometry.se3 import project_so3_np
from airdos_tpu_torch.matching.stereo import stereo_match
from airdos_tpu_torch.ops.disparity import patch_disparity
from airdos_tpu_torch.ops.pyramid import build_pyramid, level_shapes
from airdos_tpu_torch.slam.map import MAIN_SKELETON, N_JOINTS

MAX_HUMAN_DEPTH = 20.0      # reference rejects joint depth > 20 m
HUMAN_MATCH_TH = 30.0       # max mean torso distance for L/R association
MAX_HUMANS = 8              # padded per-frame human budget (device arrays)
N_TORSO = len(MAIN_SKELETON)


def torso_pixels(humans_left) -> np.ndarray:
    """[MAX_HUMANS * N_TORSO, 2] torso-joint pixels of the left detections,
    padded with (-1, -1): the disparity probes of the frame step."""
    px = np.full((MAX_HUMANS * N_TORSO, 2), -1.0, np.float32)
    for li, L in enumerate(humans_left[:MAX_HUMANS]):
        for si, j in enumerate(MAIN_SKELETON):
            px[li * N_TORSO + si] = L[j, :2]
    return px


@dataclasses.dataclass
class HumanObservation:
    """One associated stereo human (reference: human_pose struct)."""
    track_id: int
    kp_left: np.ndarray      # [18, 2]
    kp_right: np.ndarray     # [18, 2]
    conf_left: np.ndarray    # [18]
    conf_right: np.ndarray   # [18]
    depth: np.ndarray        # [18]
    bad: np.ndarray          # [18] bool


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
        # frame index -> (uploads, the copy's CUDA event or None): only the
        # newest prefetch is kept
        self._prefetched: dict = {}
        self._copy_stream = None         # the card's side stream, lazily

    def _host_images(self, data):
        """The uint8 host arrays of one frame's uploads: both images and,
        with System.IsMask, the usable-pixel masks (segmentation == 0),
        else None."""
        imL = np.ascontiguousarray(data.image_left, np.uint8)
        imR = np.ascontiguousarray(data.image_right, np.uint8)
        if self.config.system.is_mask and data.seg_left is not None:
            return (imL, imR, (data.seg_left == 0).astype(np.uint8),
                    (data.seg_right == 0).astype(np.uint8))
        return imL, imR, None, None

    def upload(self, data):
        """uint8 device images of one frame (the float cast happens on the
        device; uint8 is a quarter of the bytes), and with System.IsMask
        the usable-pixel masks, else None."""
        return tuple(None if a is None else to_device(a, self.device)
                     for a in self._host_images(data))

    def prefetch(self, data):
        """Start a future frame's uploads now, so that the copy overlaps
        the current frame's work (airdos_tpu's FrontEnd.prefetch).  On the
        card: pinned host buffers, non_blocking copies on a side stream and
        an event that ``uploads`` makes the consuming stream wait on.  Only
        the newest prefetch is kept."""
        if data.index in self._prefetched:
            return
        if self.device.type != "cuda":
            self._prefetched = {data.index: (self.upload(data), None)}
            return
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        pinned = [None if a is None else torch.from_numpy(a).pin_memory()
                  for a in self._host_images(data)]
        with torch.cuda.stream(self._copy_stream):
            up = tuple(None if p is None
                       else p.to(self.device, non_blocking=True)
                       for p in pinned)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        self._prefetched = {data.index: (up, done)}

    def uploads(self, data):
        """This frame's device uploads: the prefetched ones if there are,
        else uploaded now.  A prefetched copy is ordered before the calling
        thread's current stream (wait_event), and each tensor is recorded
        on that stream, so the side stream's allocator does not reuse its
        memory while this stream may still read it."""
        entry = self._prefetched.pop(data.index, None)
        if entry is None:
            return self.upload(data)
        up, done = entry
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in up:
                if t is not None:
                    t.record_stream(cur)
        return up

    def disparity_probes(self, data):
        """(torso pixels [MAX_HUMANS * N_TORSO, 2] on the device, whether
        to probe them): the human layer probes the stereo disparity at the
        left detections' torso joints unless the depth image gives the
        joints' depth (System.IsGroundTruthDepth)."""
        cfg = self.config
        use_gt_depth = cfg.system.is_ground_truth_depth and \
            data.depth is not None
        want = bool(cfg.human.ok and data.humans_left is not None
                    and len(data.humans_left) > 0 and not use_gt_depth)
        px = torso_pixels(data.humans_left) if want else \
            np.full((MAX_HUMANS * N_TORSO, 2), -1.0, np.float32)
        return to_device(px, self.device), want

    def _build_impl(self, imL_u8: torch.Tensor, imR_u8: torch.Tensor,
                    maskL_u8: Optional[torch.Tensor],
                    maskR_u8: Optional[torch.Tensor],
                    torso_px: torch.Tensor, with_disparity: bool):
        """No mask (None) is build_pyramid's all-ones mask: what eroding
        airdos_tpu's all-ones upload gives."""
        orb = self.config.orb
        imL = imL_u8.to(torch.float32)
        imR = imR_u8.to(torch.float32)
        pyrL = build_pyramid(imL, maskL_u8, orb.n_levels, orb.scale_factor)
        pyrR = build_pyramid(imR, maskR_u8, orb.n_levels, orb.scale_factor)
        fL = self.extractor._extract_from_pyramid(pyrL)
        fR = self.extractor._extract_from_pyramid(pyrR)
        sm = stereo_match(fL.xy, fL.octave, fL.desc32, fL.valid,
                          fR.xy, fR.octave, fR.desc32, fR.valid,
                          pyrL.images, pyrR.images,
                          self._widths, self._scales,
                          self.config.camera.bf, self.config.camera.baseline)
        xy_un = self.camera.undistort_points(fL.xy)
        # disparity only at the torso-joint probes, never a dense map (see
        # ops/disparity.patch_disparity)
        disp = patch_disparity(imL, imR, torso_px) if with_disparity \
            else None
        return fL, fR, sm, xy_un, disp

    def build_frame(self, data) -> "Frame":
        """data: io.datasets.FrameData."""
        torso_px, want_disp = self.disparity_probes(data)
        fL, fR, sm, xy_un, disp = self._build_impl(
            *self.uploads(data), torso_px, want_disp)
        return Frame(self, data, fL, sm, xy_un, disp)


class Frame:
    """Host-side frame: numpy measurement views + map bookkeeping."""

    def __init__(self, frontend: FrontEnd, data, fL, sm, xy_un_dev,
                 disparity_dev):
        dev = dict(xy=fL.xy, xy_un=xy_un_dev, octave=fL.octave,
                   angle=fL.angle, desc32=fL.desc32, valid=fL.valid,
                   u_right=sm.u_right, depth=sm.depth)
        f32 = torch.cat([fL.xy, xy_un_dev, fL.response[:, None],
                         fL.angle[:, None], sm.u_right[:, None],
                         sm.depth[:, None]], dim=1).cpu().numpy()
        disp = disparity_dev.cpu().numpy() if disparity_dev is not None \
            else None
        host = (f32[:, 0:2], f32[:, 4], f32[:, 5], fL.octave.cpu().numpy(),
                desc_to_numpy(fL.desc32), fL.valid.cpu().numpy(),
                f32[:, 6], f32[:, 7], f32[:, 2:4], disp)
        self._init_from_arrays(frontend, data, dev, host)

    @classmethod
    def from_track_result(cls, frontend: FrontEnd, data, host):
        """Build from the fused step's host FullTrackResult."""
        self = cls.__new__(cls)
        f32 = host.feat_f32
        i32 = host.feat_i32
        host_tuple = (f32[:, 0:2], f32[:, 4], f32[:, 5],
                      i32[:, 0], host.desc32, i32[:, 1] > 0,
                      f32[:, 6], f32[:, 7], f32[:, 2:4], host.disparity)
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
         self.valid, self.u_right, self.depth, self.xy_un, disparity) = host
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

        self.humans: list[HumanObservation] = []
        if self.config.system.is_ground_truth_depth and \
                data.depth is not None and data.humans_left is not None:
            self._humans_from_depth(data)
        elif disparity is not None and data.humans_left is not None:
            self._associate_humans(data, disparity)

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

    # ------------------------------------------------------------ humans
    def _humans_from_depth(self, data):
        """RGB-D human joints: depth read straight off the registered depth
        image, pseudo right keypoint u - bf/d (System.IsGroundTruthDepth;
        reference Frame::ComputeHumanPoseDepth, Frame.cc:249-311)."""
        cfg = self.config
        bf = float(cfg.camera.bf)
        reject_th = cfg.human.reject_th
        depth_im = data.depth
        h, w = depth_im.shape[:2]
        tids = data.track_ids
        for li, L in enumerate(data.humans_left):
            tid = int(tids[li]) if tids is not None and li < len(tids) else -1
            if tids is not None and li < len(tids) and tid < 0:
                continue
            depth = np.zeros(N_JOINTS, np.float32)
            bad = np.zeros(N_JOINTS, bool)
            kp_r = np.zeros((N_JOINTS, 2), np.float32)
            for j in range(N_JOINTS):
                u, v = L[j, 0], L[j, 1]
                d = float(depth_im[int(np.clip(v, 0, h - 1)),
                                   int(np.clip(u, 0, w - 1))])
                b = False
                if d < 0.01:
                    b = True
                    d = 0.01
                if L[j, 2] < reject_th:
                    b = True
                depth[j] = d
                bad[j] = b
                kp_r[j] = (u - bf / d, v)
            self.humans.append(HumanObservation(
                track_id=tid, kp_left=L[:, :2].astype(np.float32),
                kp_right=kp_r, conf_left=L[:, 2].astype(np.float32),
                conf_right=np.ones(N_JOINTS, np.float32),
                depth=depth, bad=bad))

    def _associate_humans(self, data, joint_disp: np.ndarray):
        """Greedy left->right association by disparity-compensated torso
        distance, then per-joint triangulation (reference semantics).

        joint_disp: [MAX_HUMANS * N_TORSO] disparity probed at the left
        detections' torso joints (see torso_pixels)."""
        cfg = self.config
        bf = float(cfg.camera.bf)
        reject_th = cfg.human.reject_th
        h, w = data.image_left.shape[:2]
        left, right = data.humans_left, data.humans_right
        tids = data.track_ids
        n = min(len(left), len(right)) if len(right) else 0
        for li in range(min(len(left), n, MAX_HUMANS)):
            tid = int(tids[li]) if tids is not None and li < len(tids) else -1
            if tids is not None and li < len(tids) and tid < 0:
                continue  # untrackable pose
            L = left[li]
            best_rid, best_dist = -1, 50.0
            for ri in range(len(right)):
                dsum, cnt = 0.0, 0
                for si, j in enumerate(MAIN_SKELETON):
                    sl, sr = L[j, 2], right[ri][j, 2]
                    ul, vl = L[j, 0], L[j, 1]
                    if sl < reject_th and sr < reject_th:
                        continue
                    if not (0 <= ul < w and 0 <= vl < h):
                        continue
                    d = max(float(joint_disp[li * N_TORSO + si]), 0.0)
                    dsum += np.hypot(ul - d - right[ri][j, 0],
                                     vl - right[ri][j, 1])
                    cnt += 1
                if cnt == 0:
                    continue
                dsum /= cnt
                if dsum < best_dist:
                    best_dist, best_rid = dsum, ri
            if best_rid < 0 or best_dist >= HUMAN_MATCH_TH:
                continue
            R = right[best_rid]
            depth = np.zeros(N_JOINTS, np.float32)
            bad = np.zeros(N_JOINTS, bool)
            for j in range(N_JOINTS):
                b = L[j, 2] < reject_th and R[j, 2] < reject_th
                disp = L[j, 0] - R[j, 0]
                if disp <= 0:
                    disp = 0.01
                    b = True
                z = bf / disp
                if z > MAX_HUMAN_DEPTH:
                    b = True
                depth[j] = z
                bad[j] = b
            self.humans.append(HumanObservation(
                track_id=tid, kp_left=L[:, :2].astype(np.float32),
                kp_right=np.stack([R[:, 0], L[:, 1]], axis=1).astype(np.float32),
                conf_left=L[:, 2].astype(np.float32),
                conf_right=R[:, 2].astype(np.float32),
                depth=depth, bad=bad))

    def unproject_human(self, obs: HumanObservation) -> np.ndarray:
        """Joint world positions [18, 3] from left pixels + depth."""
        cam = self.config.camera
        x = (obs.kp_left[:, 0] - cam.cx) * obs.depth / cam.fx
        y = (obs.kp_left[:, 1] - cam.cy) * obs.depth / cam.fy
        xc = np.stack([x, y, obs.depth], axis=1)
        return (self.Rwc @ xc.T).T + self.Ow[None, :]

    def unproject_feature(self, i: int) -> np.ndarray:
        """One feature's world position from its stereo depth."""
        cam = self.config.camera
        z = self.depth[i]
        x = (self.xy_un[i, 0] - cam.cx) * z / cam.fx
        y = (self.xy_un[i, 1] - cam.cy) * z / cam.fy
        xc = np.array([x, y, z], np.float32)
        return self.Rwc @ xc + self.Ow

    def unproject_features(self, ids: np.ndarray) -> np.ndarray:
        cam = self.config.camera
        z = self.depth[ids]
        x = (self.xy_un[ids, 0] - cam.cx) * z / cam.fx
        y = (self.xy_un[ids, 1] - cam.cy) * z / cam.fy
        xc = np.stack([x, y, z], axis=1).astype(np.float32)
        return (self.Rwc @ xc.T).T + self.Ow[None, :]
