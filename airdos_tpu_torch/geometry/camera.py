"""Pinhole stereo camera model (the part the tracking front end uses).

Rectified-stereo projection constants and radial-tangential keypoint
undistortion (reference src/Frame.cc:722-752, cv::undistortPoints
semantics).  Intrinsics stay Python floats: torch broadcasts them into
every kernel as scalars, so no device tensor is needed for them.
"""
from __future__ import annotations

import dataclasses

import torch

from airdos_tpu_torch.config import CameraConfig


@dataclasses.dataclass(frozen=True)
class StereoCamera:
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float                 # baseline * fx
    width: int = 640
    height: int = 360
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @classmethod
    def from_config(cls, cam: CameraConfig) -> "StereoCamera":
        return cls(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                   float(cam.bf), cam.width, cam.height,
                   cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    def distort(self, xn: torch.Tensor) -> torch.Tensor:
        """Normalized coords [..., 2] -> distorted normalized coords."""
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return torch.stack([xd, yd], dim=-1)

    def undistort_points(self, uv: torch.Tensor, iters: int = 5) -> torch.Tensor:
        """Iteratively invert the distortion model.  No-op when the model
        has no distortion."""
        if self.k1 == 0 and self.k2 == 0 and self.p1 == 0 and self.p2 == 0 \
                and self.k3 == 0:
            return uv
        xn = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                          (uv[..., 1] - self.cy) / self.fy], dim=-1)
        x = xn
        for _ in range(iters):
            x = xn - (self.distort(x) - x)
        return torch.stack([x[..., 0] * self.fx + self.cx,
                            x[..., 1] * self.fy + self.cy], dim=-1)
