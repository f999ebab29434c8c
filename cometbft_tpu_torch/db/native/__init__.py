from .wrapper import NativeDB

__all__ = ["NativeDB"]
