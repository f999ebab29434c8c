"""Consensus (reference internal/consensus). Only the write-ahead log
(`wal.py`) is ported so far: the storage recovery doctor reads it.
The state machine comes with the consensus slice (ROADMAP.md Queue 1)."""
