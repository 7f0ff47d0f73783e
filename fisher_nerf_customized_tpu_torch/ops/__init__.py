from .camera import Camera, camera_from_intrinsics
from .rasterize import render, RenderSettings
from .fisher import fisher_diag

__all__ = ["Camera", "camera_from_intrinsics", "render", "RenderSettings",
           "fisher_diag"]
