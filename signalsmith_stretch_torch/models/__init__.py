from .stretch import StretchModel  # noqa: F401
