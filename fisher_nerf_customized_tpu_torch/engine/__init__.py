from .driver import ActiveMapper
from .navigator import FrontierNavigator

__all__ = ["ActiveMapper", "FrontierNavigator"]
