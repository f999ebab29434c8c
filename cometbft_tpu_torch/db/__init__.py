from .kv import KVStore, MemDB  # noqa: F401
