from .kv import KVStore, MemDB, FileDB, open_db  # noqa: F401
