from .bbox import Bbox

__all__ = ["Bbox"]
