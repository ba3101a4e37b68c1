from .engine import DEFAULT_FEATURE, ConversionEngine  # noqa: F401
from .streaming import StreamingSession  # noqa: F401

__all__ = ["ConversionEngine", "DEFAULT_FEATURE", "StreamingSession"]
