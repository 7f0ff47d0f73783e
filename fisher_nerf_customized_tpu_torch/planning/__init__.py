from .planner import AstarPlanner, LocalizationError, NoFrontierError

__all__ = ["AstarPlanner", "LocalizationError", "NoFrontierError"]
