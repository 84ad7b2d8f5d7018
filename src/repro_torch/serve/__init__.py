from .engine import Request, ServeConfig, ServeEngine

__all__ = ["Request", "ServeConfig", "ServeEngine"]
