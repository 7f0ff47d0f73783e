"""Pinhole camera model for the splatting pipeline.

Projection is direct with (fx, fy, cx, cy): u = fx*x/z + cx - 0.5 (the
-0.5 matches the reference rasterizer's half-pixel shift against integer
pixel indices).  Camera frame is +z forward, +x right, +y down.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    near: float = 0.2    # in_frustum's 0.2 near cull
    far: float = 100.0
    # EWA low-pass added to cov2d's diagonal (the reference's +0.3).  A
    # downsampled Fisher camera scales it by 1/s² so the pixel-space math
    # stays self-similar (cov2d, dx and the conic all scale together).
    dilation: float = 0.3

    @property
    def intrinsics(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]], dtype=np.float32)

    def downsampled(self, s: int) -> "Camera":
        """The camera at 1/s resolution, with dilation scaled by 1/s²."""
        if s == 1:
            return self
        return Camera(fx=self.fx / s, fy=self.fy / s, cx=self.cx / s,
                      cy=self.cy / s, width=self.width // s,
                      height=self.height // s, near=self.near, far=self.far,
                      dilation=self.dilation / (s * s))


def camera_from_intrinsics(K, width: int, height: int, near: float = 0.2,
                           far: float = 100.0) -> Camera:
    """The Camera of a 3x3 intrinsics matrix (array or tensor)."""
    if hasattr(K, "detach"):
        K = K.detach().cpu().numpy()
    K = np.asarray(K)
    return Camera(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                  cy=float(K[1, 2]), width=int(width), height=int(height),
                  near=near, far=far)
