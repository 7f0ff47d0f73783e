from .fake_sim import FakeSim, BoxScene, ReplaySim, SimObject

__all__ = ["FakeSim", "BoxScene", "ReplaySim", "SimObject"]
