"""Optional DROID-SLAM pose tracker (gated).

A copy of the JAX package's models/droid_wrapper.py: the learned pose
tracker behind `tracking.with_droid` (false in every shipped config).
Neither the droid_slam package nor its weights are in the repository, so
constructing the wrapper without them raises ImportError with guidance
instead of degrading silently.
"""
from __future__ import annotations

try:
    import droid_slam  # type: ignore
    DROID_AVAILABLE = True
except Exception:  # pragma: no cover - optional dependency
    droid_slam = None
    DROID_AVAILABLE = False


class DroidWrapper:
    def __init__(self, weights: str | None = None, image_size=(256, 256)):
        if not DROID_AVAILABLE:
            raise ImportError(
                "droid_slam is not installed; set tracking.with_droid: false "
                "(the reference ships with it disabled everywhere) or install "
                "DROID-SLAM and its pretrained weights")
        self.net = droid_slam.Droid(weights=weights, image_size=image_size)

    def track(self, t, image, depth=None, intrinsics=None):
        return self.net.track(t, image, depth=depth, intrinsics=intrinsics)

    def terminate(self):
        return self.net.terminate()
