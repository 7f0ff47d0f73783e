from .gaussian_state import GaussianState, AdamState
from .slam import GaussianSLAM

__all__ = ["GaussianState", "AdamState", "GaussianSLAM"]
