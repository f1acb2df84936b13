"""Configuration for the SLAM system.

Dataclass mirror of the reference's YAML settings schema so the exact
reference config files (e.g. Examples/Stereo/config/tartanair.yaml) can be
ingested unchanged.  Key schema documented from the reference's parser
(src/Tracking.cc:62-181, src/System.cc:47).  Missing keys default to the
same implicit values the reference's cv::FileStorage reads produce (zeros),
except where the reference hard-codes a different default.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Dict, Optional


@dataclasses.dataclass
class CameraConfig:
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 0
    height: int = 0
    fps: float = 30.0
    bf: float = 0.0          # stereo baseline (m) times fx (px)
    rgb: int = 1             # 0: BGR, 1: RGB

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.fx else 0.0

    @property
    def has_distortion(self) -> bool:
        return abs(self.k1) > 0 or abs(self.k2) > 0 or abs(self.p1) > 0 or abs(self.p2) > 0


@dataclasses.dataclass
class OrbConfig:
    n_features: int = 1500
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 12
    min_th_fast: int = 7


@dataclasses.dataclass
class HumanConfig:
    ok: bool = False          # Human.OK — enable the dynamic-human pipeline
    is_seg: bool = False      # Human.isSeg — mask dynamic regions from ORB
    # Human.UseTrackedId (the reference reads a float, Tracking.cc:116).
    # Truthy -> dataset loaders ingest track_id_alpha/ per-frame ids;
    # falsy -> every human observation gets track id -1 and never forms a
    # trajectory (the reference's no-trackid branch, Frame.cc:273-275).
    # Programmatic default is on; YAML ingestion follows cv::FileStorage
    # implicit-zero semantics (missing key -> 0 -> off).
    use_tracked_id: float = 1.0
    reject_th: float = 0.1    # Human.RejectTh — min joint confidence


@dataclasses.dataclass
class OptimizerConfig:
    # Information weights for the dynamic BA (reference: Tracking.cc:139-156).
    sigma_static: float = 1.0
    sigma_human: float = 0.5
    sigma_motion: float = 20.0
    sigma_rigidity: float = 20.0
    th_huber_motion: float = 1.0
    th_ransac_motion: float = 4.0
    th_ransac_rigidity: float = 1.0
    is_huber: bool = True
    # IsKeyFrameOnly: when False (the reference YAMLs' implicit default),
    # human poses are grabbed on EVERY tracked frame, not only keyframes
    # (Tracking.cc:493).
    is_keyframe_only: bool = False
    # IsAllKF is parsed by the reference (Tracking.cc:147) but never read
    # afterwards — kept for config compatibility only.
    is_all_kf: bool = False
    is_static_only: bool = False
    # Whole-trajectory inclusion: the human BA windows over ALL poses of
    # each observed trajectory instead of only poses anchored to window
    # keyframes — the reference's LocalBundleAdjustmentHumanTrajactoryFast
    # graph (Optimizer.cc:736-1493; never called there, selectable here).
    use_fast_human_ba: bool = False
    # Weak SE3 prior anchoring per-frame pose optimization to the motion-
    # model prediction (sigma in m / rad per frame; <=0 disables, the
    # default).  Measured on the synthetic corridor: because the anchor is
    # the constant-velocity prediction, which itself integrates any slip,
    # the prior removes the data's small corrective pull instead of
    # bounding the runaway — it is NOT a fix for depth-degenerate scenes
    # (richer close structure is).  Kept as an opt-in for sensor-fusion
    # setups where the prediction comes from an absolute-quality source
    # (IMU/odometry) rather than the vision loop itself.
    motion_prior_sigma_t: float = 0.0
    motion_prior_sigma_rot: float = 0.0
    # Constant-velocity extrapolation damping (1.0 = reference-exact raw
    # last step, Tracking.cc:466-469).  At the low frame rates this
    # framework targets (2-10 fps), raw extrapolation makes pose noise in
    # weakly-observed directions follow e_f = 2 e_{f-1} - e_{f-2} —
    # golden-ratio divergence; scaling the extrapolated twist by
    # alpha < 1 bounds it (see Tracking._update_velocity).
    velocity_damping: float = 0.7
    # Keyframe-decision thRefRatio schedule: "stereo_sharp" keeps 0.75
    # from the start (inserts KF1 while the pose is still sharp — see
    # Tracking._need_new_keyframe for the measured rationale);
    # "reference" follows Tracking.cc:1091 exactly (0.4 while the map has
    # <2 KFs, 0.75 after).
    kf_ref_schedule: str = "stereo_sharp"


@dataclasses.dataclass
class SystemFlags:
    is_offline: bool = True
    is_mask: bool = False
    is_ground_truth_depth: bool = False


@dataclasses.dataclass
class SchedulerConfig:
    n_start_image: int = 0
    n_end_image: int = 0      # 0 → whole sequence


@dataclasses.dataclass
class DeviceConfig:
    """TPU-side static-shape budgets (no analogue in the reference — these
    bound the padded array shapes every jitted program is compiled for)."""
    max_keypoints: int = 2048         # padded keypoint slots per image
    max_local_kfs: int = 32           # local-BA camera window
    max_fixed_kfs: int = 32
    max_local_points: int = 4096      # local-BA landmark budget
    max_ba_edges: int = 16384
    max_humans: int = 8               # humans per frame
    n_joints: int = 18                # AlphaPose joints observed
    n_skeleton_joints: int = 14       # optimized skeleton joints
    max_trajectory_len: int = 24      # human poses per trajectory in BA window
    max_trajectories: int = 8         # trajectories per BA window
    # vmapped RANSAC hypothesis batch for relocalization EPnP and loop
    # Sim3 (the reference's sequential maxIterations=300/5-per-round
    # loops, Tracking.cc:1538, LoopClosing.cc:278, become one batch)
    ransac_hypotheses: int = 256
    dtype: str = "float32"
    # Multi-chip: >1 runs the local/global BA solves with their edge tables
    # sharded over an ICI mesh of this many devices (parallel/sharded_ba).
    n_chips: int = 1


@dataclasses.dataclass
class SlamConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    human: HumanConfig = dataclasses.field(default_factory=HumanConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    system: SystemFlags = dataclasses.field(default_factory=SystemFlags)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    device: DeviceConfig = dataclasses.field(default_factory=DeviceConfig)
    th_depth: float = 35.0            # close/far point threshold, × baseline
    meta_data_path: str = ""
    vocabulary_path: str = ""         # .npz (ours) or ORBvoc .txt (DBoW2)
    # None = reference behavior: the LoopClosing thread runs in online mode
    # and is not started in offline/paper mode (System.cc:166-181)
    enable_loop_closing: Optional[bool] = None

    @property
    def loop_closing_active(self) -> bool:
        if self.enable_loop_closing is None:
            return not self.system.is_offline
        return bool(self.enable_loop_closing)

    @property
    def th_depth_m(self) -> float:
        """Depth threshold in metres (reference: Tracking.cc mThDepth = bf*ThDepth/fx)."""
        return self.camera.bf * self.th_depth / self.camera.fx if self.camera.fx else 0.0

    # ------------------------------------------------------------------
    def reference_exact(self) -> "SlamConfig":
        """A copy with every reasoned behavioral deviation switched back to
        the reference's exact behavior, for paper-parity runs: raw
        constant-velocity extrapolation (Tracking.cc:466-469) and the
        thRefRatio keyframe schedule of Tracking.cc:1091.  Ingesting a
        reference YAML and calling this gives a drop-in-exact config."""
        import copy
        cfg = copy.deepcopy(self)
        cfg.optimizer.velocity_damping = 1.0
        cfg.optimizer.kf_ref_schedule = "reference"
        return cfg

    @classmethod
    def from_yaml(cls, path: str | Path) -> "SlamConfig":
        """Ingest a reference-format YAML settings file verbatim."""
        raw = _load_opencv_yaml(path)

        def g(key: str, default: Any = 0) -> Any:
            return raw.get(key, default)

        cfg = cls()
        cam = cfg.camera
        cam.fx = float(g("Camera.fx"))
        cam.fy = float(g("Camera.fy"))
        cam.cx = float(g("Camera.cx"))
        cam.cy = float(g("Camera.cy"))
        cam.k1 = float(g("Camera.k1"))
        cam.k2 = float(g("Camera.k2"))
        cam.p1 = float(g("Camera.p1"))
        cam.p2 = float(g("Camera.p2"))
        cam.k3 = float(g("Camera.k3"))
        cam.width = int(g("Camera.width"))
        cam.height = int(g("Camera.height"))
        cam.fps = float(g("Camera.fps", 30.0)) or 30.0
        cam.bf = float(g("Camera.bf"))
        cam.rgb = int(g("Camera.RGB", 1))

        orb = cfg.orb
        orb.n_features = int(g("ORBextractor.nFeatures", 1500))
        orb.scale_factor = float(g("ORBextractor.scaleFactor", 1.2))
        orb.n_levels = int(g("ORBextractor.nLevels", 8))
        orb.ini_th_fast = int(g("ORBextractor.iniThFAST", 12))
        orb.min_th_fast = int(g("ORBextractor.minThFAST", 7))

        hum = cfg.human
        hum.ok = bool(g("Human.OK"))
        hum.is_seg = bool(g("Human.isSeg"))
        hum.use_tracked_id = float(g("Human.UseTrackedId"))
        hum.reject_th = float(g("Human.RejectTh", 0.1))

        opt = cfg.optimizer
        opt.sigma_static = float(g("Optimizer.SigmaStatic", 1.0))
        opt.sigma_human = float(g("Optimizer.SigmaHuman", 1.0))
        opt.sigma_motion = float(g("Optimizer.SigmaMotion", 1.0))
        opt.sigma_rigidity = float(g("Optimizer.SigmaRigidity", 1.0))
        opt.th_huber_motion = float(g("Optimizer.ThHuberMotion", 1.0))
        opt.th_ransac_motion = float(g("Optimizer.ThRanSacMotion", 4.0))
        opt.th_ransac_rigidity = float(g("Optimizer.ThRanSacRigidity", 1.0))
        opt.is_huber = bool(g("Optimizer.IsHuber"))
        opt.is_keyframe_only = bool(g("Optimizer.IsKeyFrameOnly"))
        opt.is_all_kf = bool(g("Optimizer.IsAllKF"))
        opt.is_static_only = bool(g("Optimizer.IsStaticOnly"))

        sysf = cfg.system
        sysf.is_offline = bool(g("System.IsOffline"))
        sysf.is_mask = bool(g("System.IsMask"))
        sysf.is_ground_truth_depth = bool(g("System.IsGroundTruthDepth"))

        sched = cfg.scheduler
        sched.n_start_image = int(g("Schedular.nStartImage"))
        sched.n_end_image = int(g("Schedular.nEndImage"))

        cfg.th_depth = float(g("ThDepth", 35.0))
        cfg.meta_data_path = str(g("Data.MetaDataPath", ""))

        # Rebuild extension keys (no reference analogue): Device.* bounds
        # the padded array shapes every jitted program compiles for, so a
        # dataset YAML can size compile budgets to its scene scale.
        dev = cfg.device
        for yk, attr in (("Device.MaxKeypoints", "max_keypoints"),
                         ("Device.MaxLocalKFs", "max_local_kfs"),
                         ("Device.MaxFixedKFs", "max_fixed_kfs"),
                         ("Device.MaxLocalPoints", "max_local_points"),
                         ("Device.MaxBAEdges", "max_ba_edges"),
                         ("Device.MaxTrajectories", "max_trajectories"),
                         ("Device.MaxTrajectoryLen", "max_trajectory_len"),
                         ("Device.NChips", "n_chips")):
            if yk in raw:
                setattr(dev, attr, int(raw[yk]))

        # Keep the padded keypoint budget comfortably above nFeatures.
        cfg.device.max_keypoints = max(cfg.device.max_keypoints,
                                       _next_pow2(int(orb.n_features * 1.3)))
        return cfg


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _load_opencv_yaml(path: str | Path) -> Dict[str, Any]:
    """Parse an OpenCV FileStorage YAML (the '%YAML:1.0' dialect).

    The reference reads configs with cv::FileStorage; its '%YAML:1.0' header
    is not valid YAML 1.1, so we parse the flat key: value schema directly.
    """
    out: Dict[str, Any] = {}
    text = Path(path).read_text()
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or line.startswith("%"):
            continue
        m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.+)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val.startswith('"') and val.endswith('"'):
            out[key] = val[1:-1]
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out
