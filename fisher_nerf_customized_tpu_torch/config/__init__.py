from .node import ConfigNode
from .defaults import get_cfg_defaults

__all__ = ["ConfigNode", "get_cfg_defaults"]
