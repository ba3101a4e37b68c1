from .engine import ConversionEngine  # noqa: F401
